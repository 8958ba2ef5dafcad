"""Run one cell of the port's benchmark once, on the card this process sees:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (see ``bench_port/harness.py``); exits 2 without a CUDA
card, and without ``xgan_torch`` beside this folder fails before any
result.
"""
import os
import sys
import time


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock, from its
    age in ``/proc`` (to a clock tick); now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = process_start()
# one host thread for PyTorch's CPU work, as torchrun gives each rank, and
# the process on two fixed cores of those it may use (the thread that
# launches the step, and autograd's device thread): with an 8-thread pool
# and the threads free to move, the host-paced DCGAN step's rate swung by
# a fifth to a quarter between runs on one machine
os.environ["OMP_NUM_THREADS"] = "1"
os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
# the checkout's root, in place of this folder: its module names (trace,
# check, ...) must not shadow the standard library's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    from bench_port import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
