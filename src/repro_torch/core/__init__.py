"""Port of the reference package's core subpackage."""
