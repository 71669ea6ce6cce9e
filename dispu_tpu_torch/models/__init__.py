"""models modules of the port."""
