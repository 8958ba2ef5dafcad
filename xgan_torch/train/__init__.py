"""Training and sampling loops of the port (role of xgan/train)."""
