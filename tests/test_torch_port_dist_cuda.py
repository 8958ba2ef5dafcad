"""The data-parallel pieces of xgan_torch on the card. Marked ``cuda``;
they skip on a host without a CUDA device. Run on the card with

    python -m pytest --noconftest tests/test_torch_port_dist_cuda.py -q -m cuda

- ``mixed_gather_ranks``: each of 2 and 4 ranks' rows of a batch through
  the kernel (one launch a rank, index slices read in place) bitwise equal
  to the plain version's and to those rows of the whole batch's gather;
  the same for a rank's share of every microbatch (``--grad-accum``);
- a world-1 NCCL group from a ``torchrun`` environment (a process of its
  own): joined on ``cuda:0``, an all-reduce and the differentiable one,
  then left; a ``LOCAL_RANK`` beyond the host's cards raises.
"""
import os
import subprocess
import sys

import pytest
import torch

from xgan_torch import kernels
from xgan_torch.kernels.gather import mixed_gather, mixed_gather_ranks, \
    mixed_gather_ref
from xgan_torch.parallel.mesh import MeshContext, init_from_env

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("world", [2, 4])
def test_mixed_gather_ranks_matches_plain(dev, world):
    g = torch.Generator(device=dev).manual_seed(world)
    real = torch.randint(0, 256, (40, 32, 32, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    synth = torch.randint(0, 256, (9, 32, 32, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    b = 8 * world
    ridx = torch.randint(0, 40, (b,), generator=g, device=dev)
    sidx = torch.randint(0, 9, (b,), generator=g, device=dev)
    use = torch.rand(b, generator=g, device=dev) < 0.5
    full = mixed_gather(real, synth, ridx, sidx, use)
    for rank in range(world):
        rows = MeshContext(dev, rank, world).local_rows(b)
        kernels.reset_launch_counts()
        got = mixed_gather_ranks(real, synth, ridx, sidx, use, rows)
        assert kernels.LAUNCHES["mixed_gather"] == 1
        want = mixed_gather_ref(real, synth, ridx[rows], sidx[rows],
                                use[rows])
        assert torch.equal(got, want) and torch.equal(got, full[rows])


@pytest.mark.parametrize("world", [2, 4])
def test_mixed_gather_ranks_of_every_microbatch_matches_plain(dev, world):
    """A rank's share of each of 2 microbatches (``--grad-accum 2``), an
    int64 index of strided rows: still one launch, its rows copied
    contiguous, bitwise the plain version's and those rows of the whole
    batch's gather; microbatches of 6 rows split unevenly over 4 ranks."""
    g = torch.Generator(device=dev).manual_seed(10 + world)
    real = torch.randint(0, 256, (40, 32, 32, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    synth = torch.randint(0, 256, (9, 32, 32, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    b = 12
    ridx = torch.randint(0, 40, (b,), generator=g, device=dev)
    sidx = torch.randint(0, 9, (b,), generator=g, device=dev)
    use = torch.rand(b, generator=g, device=dev) < 0.5
    full = mixed_gather(real, synth, ridx, sidx, use)
    seen = []
    for rank in range(world):
        rows = MeshContext(dev, rank, world).local_rows(b, 2)
        seen += rows.tolist()
        kernels.reset_launch_counts()
        got = mixed_gather_ranks(real, synth, ridx, sidx, use, rows)
        assert kernels.LAUNCHES["mixed_gather"] == (1 if len(rows) else 0)
        want = mixed_gather_ref(real, synth, ridx[rows], sidx[rows],
                                use[rows])
        assert torch.equal(got, want) and torch.equal(got, full[rows])
    assert sorted(seen) == list(range(b))


WORLD1 = """
import torch, torch.distributed as dist
from xgan_torch.parallel.mesh import all_reduce_sum, init_from_env, shutdown
mesh = init_from_env(cpu=False)
assert mesh.distributed and mesh.world == 1 and mesh.rank == 0
assert mesh.device == torch.device("cuda", 0)
assert dist.get_backend() == "nccl"
t = mesh.all_reduce_(torch.arange(4.0, device=mesh.device))
assert t.tolist() == [0.0, 1.0, 2.0, 3.0]
x = torch.ones(3, device=mesh.device, requires_grad=True)
(all_reduce_sum(x * 2, mesh) * torch.arange(3.0, device=x.device)).sum() \\
    .backward()
assert x.grad.tolist() == [0.0, 2.0, 4.0]
shutdown(mesh)
assert not dist.is_initialized()
print("ok")
"""


def _launch_env(local_rank):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {**os.environ, "RANK": "0", "WORLD_SIZE": "1",
            "LOCAL_RANK": str(local_rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def test_world1_nccl_group_joins_and_leaves(dev):
    p = subprocess.run([sys.executable, "-c", WORLD1], env=_launch_env(0),
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", \
        p.stdout + p.stderr


def test_local_rank_beyond_the_cards_raises(dev, monkeypatch):
    for k, v in _launch_env(torch.cuda.device_count()).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        init_from_env(cpu=False)
