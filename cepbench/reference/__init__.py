"""The plain reference the benchmark holds the program to: NumPy only,
nothing of the program."""
