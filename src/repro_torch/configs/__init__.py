"""Model configurations of the zoo (copies of ``repro.configs``'s
architecture modules) and their registry."""
