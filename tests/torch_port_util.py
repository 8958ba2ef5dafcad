"""Shared inputs for the xgan_torch parity tests: random DCGAN, WGAN-GP
and CGAN generator and discriminator variables for the JAX package, made
with numpy so both packages get the same numbers."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from xgan.models import dcgan


def jax_generator(latent, fg, size, seed=0, family=dcgan):
    """(flax Generator of ``family``, the module ``xgan.models.dcgan`` or
    ``xgan.models.wgan``, params, batch_stats) with numpy leaves.

    Conv weights are N(0, 2/fan) so every layer keeps unit gain and the
    images span [-1, 1]; BN scale/bias and running statistics are random
    (a fresh init's mean 0 / var 1 would hide a wrong BN fold)."""
    model = family.Generator(latent_dim=latent, feature_maps=fg,
                             image_size=size)
    like = jax.eval_shape(partial(model.init, train=False),
                          jax.random.key(0), jnp.zeros((2, latent)))
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


def jax_discriminator(fd, size, seed=0, family=dcgan):
    """(flax Discriminator of ``family`` (the WGAN-GP critic for
    ``xgan.models.wgan``), params, batch_stats) with numpy leaves: conv
    weights N(0, 2/fan) (unit gain through the ladder), random BN
    scale/bias and running statistics."""
    model = family.Discriminator(feature_maps=fd, image_size=size)
    like = jax.eval_shape(partial(model.init, train=False),
                          jax.random.key(0), jnp.zeros((2, size, size, 3)))
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, leaf in like["params"].items():
        if name.startswith("Conv"):
            k = leaf["kernel"]
            fan = k.shape[0] * k.shape[1] * k.shape[2]
            params[name] = {"kernel": (rng.normal(size=k.shape)
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


def jax_cgan(latent, nf, size, seed=0, num_classes=2):
    """(flax CGAN Generator, Discriminator, their (params, batch_stats))
    with numpy leaves: conv and Dense kernels N(0, 2/fan) (N(0, 1/fan) for
    the Dense, whose input z + emb has variance 2), biases N(0, 0.1²),
    embeddings N(0, 1) for G and N(0, 1/width) for D's projection, random
    BN scale/bias and running statistics."""
    from xgan.models import cgan
    g = cgan.Generator(latent_dim=latent, num_classes=num_classes,
                       feature_maps=nf, image_size=size)
    d = cgan.Discriminator(num_classes=num_classes, feature_maps=nf,
                           image_size=size)
    labels = jnp.zeros((2,), jnp.int32)
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    out = []
    for model, x in ((g, jnp.zeros((2, latent))),
                     (d, jnp.zeros((2, size, size, 3)))):
        like = jax.eval_shape(partial(model.init, train=False),
                              jax.random.key(0), x, labels)
        params, stats = {}, {}
        for name, leaf in like["params"].items():
            if name == "label_emb":
                params[name] = normal(leaf.shape, 1.0 if model is g
                                      else leaf.shape[1] ** -0.5)
            elif name.startswith(("Conv", "Dense")):
                k = leaf["kernel"].shape
                fan = int(np.prod(k[:-1]))
                params[name] = {
                    "kernel": normal(k, np.sqrt((1.0 if name == "Dense_0"
                                                 else 2.0) / fan)),
                    "bias": normal(leaf["bias"].shape, 0.1)}
            else:
                c = leaf["scale"].shape[0]
                params[name] = {"scale": 1 + normal(c, 0.1),
                                "bias": normal(c, 0.1)}
                stats[name] = {"mean": normal(c, 0.1),
                               "var": (0.5 + rng.random(c))
                               .astype(np.float32)}
        out.append((params, stats))
    return g, d, out[0], out[1]


def bn_stats_from_torch(module, seq_bn):
    """{TorchBatchNorm_i: {mean, var}} of a port model's BNs at the
    reference indices ``seq_bn``: numpy copies (BN updates the buffers in
    place)."""
    return {f"TorchBatchNorm_{i}": {
        "mean": module.main[seq].running_mean.detach().cpu().numpy().copy(),
        "var": module.main[seq].running_var.detach().cpu().numpy().copy()}
        for i, seq in enumerate(seq_bn)}


def discriminator_vars_from_torch(d, seq_conv=None, seq_bn=None):
    """A port Discriminator's (params, batch_stats) in the flax layout;
    ``seq_conv``/``seq_bn``: the critic's indices in place of the DCGAN
    discriminator's."""
    from xgan_torch.models.dcgan import SEQ_D_BN, SEQ_D_CONV
    seq_conv = SEQ_D_CONV if seq_conv is None else seq_conv
    seq_bn = SEQ_D_BN if seq_bn is None else seq_bn
    params = {}
    for i, seq in enumerate(seq_conv):
        w = d.main[seq].weight.detach().cpu().numpy()
        params[f"Conv_{i}"] = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    for i, seq in enumerate(seq_bn):
        bn = d.main[seq]
        params[f"TorchBatchNorm_{i}"] = {
            "scale": bn.weight.detach().cpu().numpy(),
            "bias": bn.bias.detach().cpu().numpy()}
    return params, bn_stats_from_torch(d, seq_bn)
