"""Shared inputs for the xgan_torch parity tests: random DCGAN generator
variables for the JAX package, made with numpy so both packages get the
same numbers."""
import jax
import jax.numpy as jnp
import numpy as np

from xgan.models import dcgan


def jax_generator(latent, fg, size, seed=0):
    """(flax Generator, params, batch_stats) with numpy leaves.

    Conv weights are N(0, 2/fan) so every layer keeps unit gain and the
    images span [-1, 1]; BN scale/bias and running statistics are random
    (a fresh init's mean 0 / var 1 would hide a wrong BN fold)."""
    model = dcgan.Generator(latent_dim=latent, feature_maps=fg,
                            image_size=size)
    like = model.init(jax.random.key(0), jnp.zeros((2, latent)),
                      train=False)
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, leaf in like["params"].items():
        if name.startswith("ConvTranspose"):
            cin = leaf["kernel"].shape[2]
            # products per output: Cin on the 1x1 input, 4*Cin for k4s2
            fan = cin if name == "ConvTranspose_0" else 4 * cin
            params[name] = {"kernel": (rng.normal(size=leaf["kernel"].shape)
                                       * np.sqrt(2.0 / fan))
                            .astype(np.float32)}
        else:
            c = leaf["scale"].shape[0]
            params[name] = {
                "scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
                "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}
            stats[name] = {
                "mean": (0.1 * rng.normal(size=c)).astype(np.float32),
                "var": (0.5 + rng.random(c)).astype(np.float32)}
    return model, params, stats
