"""xgan_torch's eval-mode DCGAN Generator against the JAX package's
flax Generator, with weights carried across by
generator_state_dict_from_jax and random BN running statistics.

Tolerance: atol 2e-4 in f32 on tanh outputs; the eval BN is folded into
the ConvT epilogue, which reorders the f32 arithmetic (~1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_generator
from xgan.models.pretrained import save_torch_gan_generator
from xgan_torch.models.convert import (generator_state_dict_from_jax,
                                       load_generator_pth)
from xgan_torch.models.dcgan import Generator

torch.set_num_threads(1)

LATENT = 16


@pytest.mark.parametrize("size,fg", [(32, 8), (64, 8), (224, 4)])
def test_eval_forward_matches_flax(size, fg):
    model, params, stats = jax_generator(LATENT, fg, size, seed=size)
    z = np.random.default_rng(size + 1).normal(
        size=(3, LATENT)).astype(np.float32)
    want = np.asarray(model.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(z), train=False))

    g = Generator(LATENT, 3, fg, size, device="cpu")
    g.load_state_dict(generator_state_dict_from_jax(params, stats),
                      strict=True)
    got = g(torch.from_numpy(z)).numpy()
    assert got.shape == (3, size, size, 3) and got.dtype == np.float32
    assert want.std() > 0.1  # the images are not a flat grey
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_reference_pth_loads_strictly_and_bitwise(tmp_path):
    _, params, stats = jax_generator(LATENT, 8, 64, seed=7)
    path = str(tmp_path / "generator_final.pth")
    save_torch_gan_generator(path, params, stats)
    sd = load_generator_pth(path)
    ours = generator_state_dict_from_jax(params, stats)
    assert sorted(sd) == sorted(ours)
    for k in sd:
        assert sd[k].dtype == ours[k].dtype, k
        assert torch.equal(sd[k], ours[k]), k

    g = Generator(LATENT, 3, 8, 64)
    result = g.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert sorted(g.state_dict()) == sorted(sd)


def test_bf16_forward_stays_close_to_f32():
    """bf16 rounds activations between layers (the JAX package rounds
    before BN too): the images agree to a few u8 levels, not bitwise."""
    _, params, stats = jax_generator(LATENT, 8, 32, seed=9)
    sd = generator_state_dict_from_jax(params, stats)
    z = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, LATENT)).astype(np.float32))
    g32 = Generator(LATENT, 3, 8, 32)
    g32.load_state_dict(sd)
    g16 = Generator(LATENT, 3, 8, 32, dtype=torch.bfloat16)
    g16.load_state_dict(sd)
    assert g16.wp0.dtype == torch.bfloat16
    d = (g16(z) - g32(z)).abs()
    assert d.max().item() < 0.1 and d.mean().item() < 0.01


def test_set_compute_dtype_repacks():
    g = Generator(LATENT, 3, 8, 32)
    assert g.wp0.dtype == torch.float32
    g.set_compute_dtype(torch.bfloat16)
    assert g.wp0.dtype == torch.bfloat16 and g.w0_mat.dtype == torch.bfloat16
    assert g.scale0.dtype == torch.float32


def test_train_mode_not_ported():
    g = Generator(LATENT, 3, 8, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        g(torch.zeros(2, LATENT), train=True)
