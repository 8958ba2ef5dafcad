"""Directory helpers (role of xgan/utils/dirs.py)."""
import os


def check_create_dir(directory):
    """mkdir -p; returns the path."""
    directory = str(directory)
    if not os.path.exists(directory):
        os.makedirs(directory, exist_ok=True)
        print(f"Created directory: {directory}")
    return directory
