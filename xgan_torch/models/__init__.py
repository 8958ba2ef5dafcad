"""Models of the port (role of xgan/models)."""
