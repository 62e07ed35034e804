"""Port of the reference package's cep subpackage."""
