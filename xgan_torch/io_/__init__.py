"""Output writers of the port (role of xgan/io_)."""
