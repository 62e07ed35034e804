"""Port of the reference package's eval subpackage."""
