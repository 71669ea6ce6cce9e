"""nn modules of the port."""
