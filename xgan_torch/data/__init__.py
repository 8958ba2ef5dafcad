"""Data path of the port (role of xgan/data)."""
