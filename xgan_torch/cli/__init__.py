"""Command-line entry points of the port (role of src/)."""
