"""Model configurations known to the port."""
