"""Host-side codecs of the port (role of xgan/native)."""
