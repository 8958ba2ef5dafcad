"""Hand-written CUDA kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on a CUDA
device (never the plain version's calls), so a run can show that its
main path went through the kernels: reset it, drive the path, read it.
"""
from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()
