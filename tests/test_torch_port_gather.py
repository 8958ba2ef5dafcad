"""xgan_torch's mixed_gather against the Pallas kernel it replaces.

The plain version (what the port runs on CPU tensors) must be bitwise
equal to ``xgan.ops.pallas.gather.mixed_gather(..., interpret=True)`` on
the cases of tests/test_pallas_gather.py, and reject bad indices. The
CUDA kernel is held against the plain version on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgan.ops.pallas.gather import mixed_gather as pallas_mixed_gather
from xgan_torch import kernels
from xgan_torch.kernels.gather import mixed_gather, mixed_gather_ref

torch.set_num_threads(1)


def _both(real, synth, ridx, sidx, mask):
    want = np.asarray(pallas_mixed_gather(
        jnp.asarray(real), jnp.asarray(synth), jnp.asarray(ridx, jnp.int32),
        jnp.asarray(sidx, jnp.int32), jnp.asarray(mask, jnp.int32),
        interpret=True))
    t = torch.from_numpy
    got = mixed_gather_ref(t(real), t(synth), t(ridx.astype(np.int64)),
                           t(sidx.astype(np.int64)), t(mask.astype(bool)))
    return got.numpy(), want


@pytest.mark.parametrize("seed,nr,ns,b", [(0, 10, 4, 8), (2, 20, 7, 16)])
def test_plain_matches_pallas_mixed(seed, nr, ns, b):
    rng = np.random.default_rng(seed)
    real = rng.integers(0, 255, (nr, 32, 32, 3), np.uint8)
    synth = rng.integers(0, 255, (ns, 32, 32, 3), np.uint8)
    ridx = rng.integers(0, nr, (b,)).astype(np.int32)
    sidx = rng.integers(0, ns, (b,)).astype(np.int32)
    mask = (rng.random(b) < 0.5).astype(np.int32)
    got, want = _both(real, synth, ridx, sidx, mask)
    assert got.dtype == np.uint8 and got.shape == (b, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_plain_matches_pallas_one_source():
    rng = np.random.default_rng(1)
    real = rng.integers(0, 255, (6, 32, 32, 3), np.uint8)
    synth = rng.integers(0, 255, (3, 32, 32, 3), np.uint8)
    idx = np.arange(6, dtype=np.int32)
    zeros = np.zeros(6, np.int32)
    got, want = _both(real, synth, idx, zeros, zeros)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, real)
    got, want = _both(real, synth, zeros, idx % 3, np.ones(6, np.int32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, synth[idx % 3])


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    real = torch.from_numpy(rng.integers(0, 255, (5, 7, 7, 3), np.uint8))
    synth = torch.from_numpy(rng.integers(0, 255, (2, 7, 7, 3), np.uint8))
    ridx, sidx = torch.tensor([4, 0, 2]), torch.tensor([1, 1, 0])
    mask = torch.tensor([True, False, True])
    kernels.reset_launch_counts()
    out = mixed_gather(real, synth, ridx, sidx, mask)
    assert kernels.LAUNCHES["mixed_gather"] == 0
    assert torch.equal(out, torch.stack([synth[1], real[0], synth[0]]))


@pytest.mark.parametrize("ridx,sidx", [([0, 5], [0, 0]), ([0, -1], [0, 0]),
                                       ([0, 1], [2, 0]), ([0, 1], [0, -3])])
def test_bad_index_raises(ridx, sidx):
    real = torch.zeros(5, 4, 4, 3, dtype=torch.uint8)
    synth = torch.ones(2, 4, 4, 3, dtype=torch.uint8)
    with pytest.raises(IndexError):
        mixed_gather(real, synth, torch.tensor(ridx), torch.tensor(sidx),
                     torch.tensor([False, True]))


def _fold_inputs(k, b, seed=4):
    rng = np.random.default_rng(seed)
    real = rng.integers(0, 255, (9, 32, 32, 3), np.uint8)
    synth = rng.integers(0, 255, (4, 32, 32, 3), np.uint8)
    t = torch.from_numpy
    return (t(real), t(synth), t(rng.integers(0, 9, (k, b))),
            t(rng.integers(0, 4, (k, b))), t(rng.random((k, b)) < 0.5))


@pytest.mark.parametrize("k,b", [(2, 8), (5, 3), (1, 4)])
def test_fold_batched_call_equals_single_calls(k, b):
    """(k, B) indices and mask (--parallel-folds): one call equals k single
    calls, and the Pallas kernel under the fold vmap xgan runs."""
    real, synth, ridx, sidx, mask = _fold_inputs(k, b)
    kernels.reset_launch_counts()
    out = mixed_gather(real, synth, ridx, sidx, mask)
    assert kernels.LAUNCHES["mixed_gather"] == 0
    assert out.shape == (k, b, 32, 32, 3) and out.dtype == torch.uint8
    singles = torch.stack([mixed_gather(real, synth, ridx[f], sidx[f],
                                        mask[f]) for f in range(k)])
    assert torch.equal(out, singles)
    import jax
    want = jax.vmap(lambda r, s, m: pallas_mixed_gather(
        jnp.asarray(real.numpy()), jnp.asarray(synth.numpy()), r, s, m,
        interpret=True))(jnp.asarray(ridx.numpy(), jnp.int32),
                         jnp.asarray(sidx.numpy(), jnp.int32),
                         jnp.asarray(mask.numpy(), jnp.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["real", "synth"])
def test_fold_batched_bad_index_in_one_fold_raises(which):
    real, synth, ridx, sidx, mask = _fold_inputs(3, 4)
    bad_r, bad_s = ridx.clone(), sidx.clone()
    if which == "real":
        bad_r[1, 2] = 9
    else:
        bad_s[1, 2] = -1
    with pytest.raises(IndexError):
        mixed_gather(real, synth, bad_r, bad_s, mask)
    with pytest.raises(IndexError):
        mixed_gather(real, synth, bad_r[1], bad_s[1], mask[1])
    for f in (0, 2):  # the other folds' single calls are fine
        mixed_gather(real, synth, bad_r[f], bad_s[f], mask[f])
    with pytest.raises(ValueError):
        mixed_gather(real, synth, ridx, sidx[:, :2], mask)
