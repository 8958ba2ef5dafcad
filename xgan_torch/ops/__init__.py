"""Tensor ops of the port (role of xgan/ops)."""
