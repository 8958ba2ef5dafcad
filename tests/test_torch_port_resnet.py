"""xgan_torch's ResNet-50 against the flax ``ResNet50`` of the JAX
package, at stages (1,1,1,1) and 32 px, f32 on the CPU.

Weights move through ``resnet_state_dict_from_flax``; BN scales, biases
and running statistics are randomized so that a wrong mapping shows.
Logits agree within 1e-4 * (1 + max|ref|) (f32 convolutions summed in
another order by XLA and oneDNN), the updated running statistics within
1e-5. The ``.pth`` codecs of both packages read each other's files."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgan.models.pretrained import load_torch_resnet50, save_torch_resnet50
from xgan.models.resnet import ResNet50 as FlaxResNet50
from xgan_torch.models.convert import (load_resnet_pth,
                                       resnet_state_dict_from_flax)
from xgan_torch.models.resnet import ResNet50

torch.set_num_threads(1)

STAGES, SIZE, B = (1, 1, 1, 1), 32, 8


def jax_resnet(seed=0, stages=STAGES):
    """(flax model, params, batch_stats) with numpy leaves; BN affine and
    running statistics drawn at random."""
    model = FlaxResNet50(num_classes=2, stage_sizes=stages)
    # one compiled init: the eager one dispatches (and compiles) op by op
    v = jax.jit(lambda key: model.init(key, jnp.zeros((2, SIZE, SIZE, 3)),
                                       train=False))(jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def bn_params(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name == "bias" and path[-2].key == "bn":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return leaf

    def bn_stats(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "mean":
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.5 + rng.random(leaf.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(bn_params, v["params"])
    stats = jax.tree_util.tree_map_with_path(bn_stats, v["batch_stats"])
    return model, params, stats


def port_resnet(params, stats, stages=STAGES):
    model = ResNet50(2, stage_sizes=stages)
    model.load_state_dict(resnet_state_dict_from_flax(params, stats, stages))
    return model


def _images(seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, SIZE, SIZE, 3)).astype(np.float32)


def _running_stats(stats) -> dict:
    """flax batch_stats -> {torchvision key: running mean/var}."""
    out = {}

    def put(prefix, s):
        out[f"{prefix}.running_mean"] = np.asarray(s["bn"]["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["bn"]["var"])

    put("bn1", stats["stem"])
    for name, block in stats.items():
        if name == "stem":
            continue
        stage, b = name[len("layer"):].split("_")
        for i in (1, 2, 3):
            put(f"layer{stage}.{b}.bn{i}", block[f"conv{i}"])
        if "downsample" in block:
            put(f"layer{stage}.{b}.downsample.1", block["downsample"])
    return out


@pytest.mark.parametrize("train,masked", [(False, False), (True, False),
                                          (True, True)])
def test_forward_matches_flax(train, masked):
    fmodel, params, stats = jax_resnet()
    model = port_resnet(params, stats)
    x = _images()
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32) if masked \
        else None
    kw = {} if mask is None else {"mask": jnp.asarray(mask)}
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, upd = fmodel.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"], **kw)
    else:
        ref = fmodel.apply(variables, jnp.asarray(x), train=False)
    ref = np.asarray(ref)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train,
                    mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    rows = slice(None) if mask is None else mask > 0
    err = np.abs(got.numpy()[rows] - ref[rows]).max()
    assert err <= 1e-4 * (1 + np.abs(ref).max()), err
    if train:
        want = _running_stats(upd["batch_stats"])
        sd = model.state_dict()
        assert len(want) == 2 * 17
        for k, v in want.items():
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=k)


def test_bf16_forward_stays_near_f32():
    _, params, stats = jax_resnet()
    m32 = port_resnet(params, stats)
    m16 = ResNet50(2, stage_sizes=STAGES, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    x = torch.from_numpy(_images())
    with torch.no_grad():
        a, b = m32(x, train=False), m16(x, train=False)
    assert b.dtype == torch.float32  # mean-pool and fc in f32
    assert (a - b).abs().max() <= 0.1 * (1 + a.abs().max())


def test_init_and_keys():
    g = torch.Generator().manual_seed(0)
    model = ResNet50(2, generator=g)
    sd = model.state_dict()
    n_conv = 1 + 3 * 16 + 4
    assert sum(k.endswith("conv1.weight") or ".conv" in k or
               k.endswith("downsample.0.weight") for k in sd
               if k.endswith("weight") and sd[k].dim() == 4) == n_conv
    w = sd["layer1.0.conv2.weight"]
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() - (2 / fan_out) ** 0.5) < 0.05 * (2 / fan_out) \
        ** 0.5
    assert torch.equal(sd["layer3.2.bn3.weight"], torch.ones(1024))
    assert sd["fc.weight"].shape == (2, 2048)
    assert sd["fc.weight"].abs().max() <= 2048 ** -0.5


def test_jax_pth_export_loads_strictly(tmp_path):
    fmodel, params, stats = jax_resnet(seed=3)
    path = str(tmp_path / "fold_1_augmented_resnet50.pth")
    save_torch_resnet50(path, params, stats, stage_sizes=STAGES)
    model = ResNet50(2, stage_sizes=STAGES)
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    x = _images(4)
    ref = np.asarray(fmodel.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * (1 + np.abs(ref).max())
    other = ResNet50(2, stage_sizes=STAGES)
    load_resnet_pth(other, path)  # its 2-way fc is taken too
    assert torch.equal(other.fc.weight, model.fc.weight)


def test_port_pth_loads_in_jax(tmp_path):
    _, params, stats = jax_resnet(seed=5)
    model = port_resnet(params, stats)
    path = str(tmp_path / "curriculum_resnet50.pth")
    torch.save(model.state_dict(), path)
    p2, s2 = load_torch_resnet50(path, stage_sizes=STAGES)
    for a, b in zip(jax.tree_util.tree_leaves((params, stats)),
                    jax.tree_util.tree_leaves((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pth_loader_rules(tmp_path):
    sd = ResNet50(2, stage_sizes=STAGES).state_dict()
    imagenet = dict(sd, **{"fc.weight": torch.zeros(1000, 2048),
                           "fc.bias": torch.zeros(1000)})
    path = str(tmp_path / "r.pth")
    torch.save(imagenet, path)
    model = ResNet50(2, stage_sizes=STAGES)
    fc = model.fc.weight.clone()
    load_resnet_pth(model, path)  # 1000-way head dropped, fresh fc kept
    assert torch.equal(model.fc.weight, fc)
    assert torch.equal(model.conv1.weight, sd["conv1.weight"])
    deeper = dict(sd, **{"layer2.1.conv1.weight": torch.zeros(1)})
    torch.save(deeper, path)
    with pytest.raises(ValueError, match="deeper"):
        load_resnet_pth(model, path)
    del sd["layer3.0.bn2.running_var"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="missing"):
        load_resnet_pth(model, path)


@pytest.mark.parametrize("mask", [None, [1, 1, 0, 1, 0, 0], [0] * 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(mask, dtype):
    from xgan.ops.norm import batch_norm_train as jax_bn
    from xgan_torch.ops.norm import batch_norm_train
    rng = np.random.default_rng(8)
    x = rng.normal(1.0, 2.0, (6, 5, 4, 3)).astype(np.float32)
    scale, bias = rng.normal(size=3).astype(np.float32), \
        rng.normal(size=3).astype(np.float32)
    mean, var = rng.normal(size=3).astype(np.float32), \
        (0.5 + rng.random(3)).astype(np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    want = jax_bn(jnp.asarray(x, dtype), scale, bias, mean, var,
                  mask=None if m is None else jnp.asarray(m))
    tdt = getattr(torch, dtype)
    t = torch.from_numpy
    got = batch_norm_train(t(x).to(tdt), t(scale), t(bias), t(mean), t(var),
                           mask=None if m is None else t(m))
    assert got[0].dtype == tdt
    rows = slice(None) if m is None else m > 0
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * 8
    np.testing.assert_allclose(got[0].float().numpy()[rows],
                               np.asarray(want[0], np.float32)[rows],
                               rtol=0, atol=tol)
    for g, w in zip(got[1:], want[1:]):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("weights", [None, [1, 0, 1, 1], [0, 0, 0, 0]])
def test_weighted_mean_matches_jax(weights):
    from xgan.ops.reduce import weighted_mean as jax_weighted_mean
    from xgan_torch.ops.reduce import weighted_mean
    v = np.array([0.5, 3.0, -1.25, 2.0], np.float32)
    w = None if weights is None else np.asarray(weights, np.float32)
    want = float(jax_weighted_mean(jnp.asarray(v),
                                   None if w is None else jnp.asarray(w)))
    got = weighted_mean(torch.from_numpy(v),
                        None if w is None else torch.from_numpy(w)).item()
    assert got == pytest.approx(want, rel=1e-7, abs=0)
