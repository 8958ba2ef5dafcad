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


def jax_classifier(size, stage_sizes=(1, 1, 1, 1), seed=0):
    """(flax ResNet50, params, batch_stats) with numpy leaves: the flax
    init, with the BN running statistics moved off their 0/1 start (a
    fresh init's would hide a wrong BN)."""
    from xgan.models.resnet import ResNet50
    model = ResNet50(num_classes=2, stage_sizes=stage_sizes)
    v = model.init(jax.random.key(seed), jnp.zeros((1, size, size, 3)),
                   train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.random(x.shape))
        .astype(np.float32), v["batch_stats"])
    return model, jax.tree_util.tree_map(np.asarray, v["params"]), stats


# ---- serving artifacts (tests/test_torch_port_export*.py) ------------------

# fg 64: the weights outweigh the program, so the int8 file is small
EXPORT_LATENT, EXPORT_FG, EXPORT_SIZE = 16, 64, 32
EXPORT_STAGES = (1, 1, 1, 1)


def export_models(kind):
    """(JAX model, its variables, the port model in eval mode on the same
    weights) for ``kind`` in gan, wgan, cgan, classifier."""
    from xgan.models import wgan
    from xgan_torch.io_.checkpoint import state_dict_from_flax
    from xgan_torch.models import cgan as port_cgan
    from xgan_torch.models import dcgan as port_dcgan
    from xgan_torch.models import wgan as port_wgan
    from xgan_torch.models.resnet import ResNet50
    latent, fg, size = EXPORT_LATENT, EXPORT_FG, EXPORT_SIZE
    if kind == "classifier":
        jm, p, s = jax_classifier(size, EXPORT_STAGES, seed=1)
        port = ResNet50(2, stage_sizes=EXPORT_STAGES)
    elif kind == "cgan":
        jm, _, (p, s), _ = jax_cgan(latent, fg, size, seed=2)
        port = port_cgan.Generator(latent, feature_maps=fg, image_size=size)
    else:
        fam, pfam = ((wgan, port_wgan) if kind == "wgan"
                     else (dcgan, port_dcgan))
        jm, p, s = jax_generator(latent, fg, size, seed=3, family=fam)
        port = pfam.Generator(latent, 3, fg, size)
    v = {"params": p, "batch_stats": s}
    port.load_state_dict(state_dict_from_flax(port, v))
    return jm, v, port.eval()


def export_inputs(kind, b, seed=0):
    """A program's inputs for a batch of ``b``, from numpy."""
    import torch
    rng = np.random.default_rng(seed)
    size = EXPORT_SIZE
    if kind == "classifier":
        return (torch.from_numpy(rng.integers(0, 255, (b, size, size, 3),
                                              np.uint8)),)
    z = torch.from_numpy(rng.normal(size=(b, EXPORT_LATENT))
                         .astype(np.float32))
    if kind == "cgan":
        return z, torch.from_numpy(rng.integers(0, 2, (b,)).astype(np.int32))
    return (z,)


def build_artifacts(root, kinds):
    """{(kind, quantize): (the port program, its ``.pt2`` path, the JAX
    package's artifact of the same weights, the port model)} for each of
    ``kinds``, full precision and int8, written under ``root``."""
    from xgan.io_ import export as jax_export
    from xgan.io_.quant import quantize_params as jax_quantize
    from xgan_torch.io_ import export
    out = {}
    for kind in kinds:
        jm, v, port = export_models(kind)
        for q in ("none", "int8"):
            program = export.build_program(kind, port, quantize=q)
            ep = export.export_program(program, export.example_inputs(
                kind, image_size=EXPORT_SIZE, latent_dim=EXPORT_LATENT,
                device="cpu"))
            path = str(root / f"{kind}_{q}.pt2")
            export.save_exported(path, ep, {"kind": kind})
            jv = v if q == "none" else dict(v,
                                            params=jax_quantize(v["params"]))
            blob = (jax_export.export_classifier(jm, jv, EXPORT_SIZE)
                    if kind == "classifier" else jax_export.export_generator(
                        jm, jv, EXPORT_LATENT, conditional=kind == "cgan"))
            jpath = str(root / f"{kind}_{q}.stablehlo")
            jax_export.save_exported(jpath, blob)
            out[(kind, q)] = (program, path,
                              jax_export.load_exported(jpath), port)
    return out


def check_round_trip(built, kind, q):
    """The saved artifact, loaded, at b = 1, 3 and 8 against the live
    program (full precision: the model itself) at export_model's f32
    tolerances: probabilities 1e-5 (labels where they are not a near
    tie), images bitwise."""
    import torch

    from xgan_torch.data.pipeline import tanh_to_u8
    from xgan_torch.io_ import export
    program, path, _, port = built[(kind, q)]
    art, meta = export.load_exported_with_meta(path, "cpu")
    assert meta == {"kind": kind} and art.device.type == "cpu"
    for b in (1, 3, 8):
        inputs = export_inputs(kind, b, seed=b)
        got = art.call(*inputs)
        with torch.no_grad():
            want = program(*inputs)
            if q == "none":  # the model itself, outside any program
                want = (export.make_classifier_infer(port)(*inputs)
                        if kind == "classifier"
                        else tanh_to_u8(port(*inputs)))
        if kind == "classifier":
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
            sure = (want[1] - 0.5).abs() > 1e-5
            assert torch.equal(got[0][sure], want[0][sure])
            assert got[0].shape == got[1].shape == (b,)
        else:
            assert got.dtype == torch.uint8
            assert got.shape == (b, EXPORT_SIZE, EXPORT_SIZE, 3)
            assert torch.equal(got, want)


def check_against_jax(built, kind, q):
    """The port's artifact against the JAX package's of the same
    (quantized) weights: probabilities within 1e-4 (other f32 convolution
    orders), images within 1 u8 level with at most 0.1 % of pixels off
    (the BN fold reorders f32 arithmetic)."""
    from xgan_torch.io_ import export
    _, path, jart, _ = built[(kind, q)]
    inputs = export_inputs(kind, 3, seed=7)
    got = export.load_exported(path, "cpu").call(*inputs)
    want = jart.call(*(jnp.asarray(x.numpy()) for x in inputs))
    if kind == "classifier":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-4)
    else:
        d = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        assert np.asarray(want).std() > 20


def check_int8_small(built, kind):
    """int8 constants in the program and no f32 copy of them: the file
    at most 0.35 of the full-precision one."""
    import os

    import torch

    from xgan_torch.io_ import export
    path, full = built[(kind, "int8")][1], built[(kind, "none")][1]
    art = export.load_exported(path, "cpu")
    assert torch.int8 in {t.dtype for t in art.program.state_dict.values()}
    assert os.path.getsize(path) <= 0.35 * os.path.getsize(full)


def check_sampler_reads_pt2(built, kind, tmp_path, capsys):
    """The sampler CLI of ``kind`` on its ``.pt2`` writes the live model's
    images for its seeded draws (the latent size and classes from the
    artifact); the other sampler refuses it (its conditionality)."""
    import os

    import pytest
    import torch

    from xgan_torch.cli import generate_synthetic, generate_synthetic_cgan
    from xgan_torch.data.pipeline import tanh_to_u8
    from xgan_torch.native.png import decode_png
    _, path, _, port = built[(kind, "none")]
    cli, other = ((generate_synthetic, generate_synthetic_cgan)
                  if kind != "cgan"
                  else (generate_synthetic_cgan, generate_synthetic))
    cli.main(["--cpu", "--model-path", path, "--output-dir",
              str(tmp_path / "out"), "--num-images", "5", "--batch-size",
              "3", "--seed", "4"])
    got = np.stack([decode_png(str(tmp_path / "out" / n))
                    for n in sorted(os.listdir(tmp_path / "out"))])
    gen = torch.Generator().manual_seed(4)
    want = []
    for _ in range(2):
        z = torch.randn((3, EXPORT_LATENT), generator=gen)
        args = (z,) if kind != "cgan" else (
            z, torch.randint(0, 2, (3,), generator=gen))
        want.append(tanh_to_u8(port(*args)))
    np.testing.assert_array_equal(got, torch.cat(want)[:5].numpy())
    with pytest.raises(SystemExit) as e:
        other.main(["--cpu", "--model-path", path, "--output-dir",
                    str(tmp_path / "no")])
    assert e.value.code == 1
    assert "conditional generator artifact" in capsys.readouterr().out
