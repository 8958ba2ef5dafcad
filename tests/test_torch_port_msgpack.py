"""xgan_torch's flax msgpack codec and checkpoint reader against flax and
the JAX package.

The reader must restore what ``flax.serialization`` restores, bitwise
(bfloat16 leaves as torch.bfloat16 tensors, compared by their bits); the
writer must give ``flax.serialization.to_bytes``'s bytes. Checkpoints the
JAX package's ``save_variables`` wrote load into the port's models and
give the JAX forward: generator images within 1 u8 level with at most
0.1 % of pixels off (the BN fold reorders f32 arithmetic), classifier
probabilities within 1e-4 at f32 (different f32 convolution orders)."""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_cgan, jax_classifier, jax_generator
from xgan.data.pipeline import normalize_images as jax_normalize
from xgan.data.pipeline import tanh_to_u8 as jax_tanh_to_u8
from xgan.io_ import checkpoint as jax_ckpt
from xgan.models import wgan as jax_wgan
from xgan.models.pretrained import save_torch_resnet50
from xgan.models.resnet import ResNet50 as JaxResNet50
from xgan_torch.data.pipeline import tanh_to_u8
from xgan_torch.io_ import checkpoint, msgpack
from xgan_torch.io_.export import make_classifier_infer
from xgan_torch.models import cgan, dcgan, wgan
from xgan_torch.models.resnet import ResNet50
from xgan_torch.train.sample import load_generator

torch.set_num_threads(1)

LATENT, FG, SIZE = 16, 8, 32
STAGES = (1, 1, 1, 1)


def _trees():
    rng = np.random.default_rng(0)
    return {
        "f32": {"a": rng.normal(size=(3, 4)).astype(np.float32)},
        "bf16": {"w": rng.normal(size=(5, 7)).astype(ml_dtypes.bfloat16),
                 "e": np.zeros((0, 2), ml_dtypes.bfloat16)},
        "ints": {"i8": rng.integers(-128, 127, (9,), dtype=np.int8),
                 "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 3),
                                     dtype=np.int32),
                 "u32": rng.integers(0, 2 ** 32 - 1, (4,), dtype=np.uint32)},
        "scalars": {"n": 3, "neg": -40, "big": 2 ** 40, "small": -2 ** 33,
                    "f": 2.5, "t": True, "none": None, "s": "héllo",
                    "np": np.float32(1.5), "np_i": np.int64(-7),
                    "raw": b"\x00\x01" * 200},
        "nested": {"params": {"b": {"kernel": np.ones((2, 2), np.float32)},
                              "a": {"bias": np.arange(3, dtype=np.float32)}},
                   "x" * 40: {str(i): i for i in range(20)},
                   "step": np.int32(7)},
        "lists": {"opt": [np.zeros(3, np.float32), (1, 2.0), [None, "x"]],
                  "empty": []},
    }


def _same(got, want):
    """Bitwise equality of restored trees; bfloat16 by its bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def _torch_leaves(tree):
    """The tree with bfloat16 leaves as the torch tensors the port
    writes."""
    if isinstance(tree, dict):
        return {k: _torch_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_leaves(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return tree


@pytest.mark.parametrize("name", list(_trees()))
def test_reader_matches_flax(name):
    data = flax.serialization.to_bytes(_trees()[name])
    _same(msgpack.msgpack_restore(data),
          flax.serialization.msgpack_restore(data))


@pytest.mark.parametrize("name", list(_trees()))
def test_writer_is_byte_equal_to_flax(name):
    tree = _trees()[name]
    assert msgpack.msgpack_serialize(_torch_leaves(tree)) == \
        flax.serialization.to_bytes(tree)


@pytest.mark.parametrize("name", ["f32", "bf16", "ints"])
def test_chunked_arrays(name, monkeypatch):
    """flax chunks a leaf above MAX_CHUNK_SIZE bytes: forced small here,
    both ways."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 8)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 8)
    tree = _trees()[name]
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack.msgpack_serialize(_torch_leaves(tree)) == data
    _same(msgpack.msgpack_restore(data),
          flax.serialization.msgpack_restore(data))


def test_from_bytes_restores_lists_and_checks_keys():
    tree = _trees()["lists"]
    data = flax.serialization.to_bytes(tree)
    got = msgpack.from_bytes(tree, data)
    want = flax.serialization.from_bytes(tree, data)
    assert isinstance(got["opt"], list) and isinstance(got["opt"][1], tuple)
    assert got["opt"][1] == want["opt"][1] and got["opt"][2] == [None, "x"]
    np.testing.assert_array_equal(got["opt"][0], want["opt"][0])
    with pytest.raises(ValueError, match="target dict contains keys"):
        msgpack.from_bytes({"params": 0, "missing": 0},
                           flax.serialization.to_bytes({"params": 1}))
    with pytest.raises(ValueError, match="size of the list"):
        msgpack.from_bytes({"opt": [0, 0]},
                           flax.serialization.to_bytes({"opt": [1]}))


def test_corrupt_data_raises_value_error():
    data = flax.serialization.to_bytes(_trees()["f32"])
    for bad in (data[:-3], data + b"\x00", b"not a checkpoint"):
        with pytest.raises(ValueError):
            msgpack.msgpack_restore(bad)


# ---- checkpoints the JAX package wrote --------------------------------------

def _save(path, params, stats):
    jax_ckpt.save_variables(str(path), {"params": params,
                                        "batch_stats": stats})
    return str(path)


@pytest.mark.parametrize("family", ["dcgan", "wgan"])
def test_jax_generator_msgpack_matches_jax(tmp_path, family):
    from xgan.models import dcgan as jax_dcgan
    jax_fam, port = ((jax_wgan, wgan) if family == "wgan"
                     else (jax_dcgan, dcgan))
    model, params, stats = jax_generator(LATENT, FG, SIZE, seed=3,
                                         family=jax_fam)
    path = _save(tmp_path / "generator_final.msgpack", params, stats)
    g = load_generator(port.Generator(LATENT, 3, FG, SIZE), path)
    z = np.random.default_rng(4).normal(size=(6, LATENT)).astype(np.float32)
    got = tanh_to_u8(g(torch.from_numpy(z))).numpy()
    want = np.asarray(jax_tanh_to_u8(model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z),
        train=False)))
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3 and want.std() > 20


def test_jax_cgan_generator_msgpack_matches_jax(tmp_path):
    g_model, _, (params, stats), _ = jax_cgan(LATENT, FG, SIZE, seed=5)
    path = _save(tmp_path / "generator_final.msgpack", params, stats)
    g = load_generator(cgan.Generator(LATENT, feature_maps=FG,
                                      image_size=SIZE), path)
    rng = np.random.default_rng(6)
    z = rng.normal(size=(6, LATENT)).astype(np.float32)
    y = rng.integers(0, 2, (6,)).astype(np.int32)
    got = tanh_to_u8(g(torch.from_numpy(z), torch.from_numpy(y))).numpy()
    want = np.asarray(jax_tanh_to_u8(g_model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z),
        jnp.asarray(y), train=False)))
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3 and want.std() > 20


def test_jax_classifier_msgpack_matches_jax(tmp_path):
    model, params, stats = jax_classifier(SIZE, STAGES, 1)
    path = _save(tmp_path / "baseline_resnet50.msgpack", params, stats)
    net = ResNet50(2, stage_sizes=STAGES)
    checkpoint.load_classifier_variables(path, net)
    imgs = np.random.default_rng(2).integers(0, 255, (4, SIZE, SIZE, 3),
                                             np.uint8)
    _, got = make_classifier_infer(net.eval())(torch.from_numpy(imgs))
    logits = model.apply({"params": params, "batch_stats": stats},
                         jax_normalize(jnp.asarray(imgs)), train=False)
    want = np.asarray(jax.nn.softmax(logits.astype(jnp.float32), -1)[:, 1])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    # its .pth twin (the JAX package's torchvision export) loads alike
    pth = str(tmp_path / "baseline_resnet50.pth")
    save_torch_resnet50(pth, params, stats, stage_sizes=STAGES)
    twin = ResNet50(2, stage_sizes=STAGES)
    checkpoint.load_classifier_variables(pth, twin)
    for k, v in net.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_shape_errors_name_the_jax_leaf(tmp_path):
    from xgan.models.dcgan import Generator as JaxGenerator
    _, params, stats = jax_generator(LATENT, FG, SIZE, seed=3)
    path = _save(tmp_path / "g.msgpack", params, stats)
    wide = JaxGenerator(latent_dim=LATENT, feature_maps=2 * FG,
                        image_size=SIZE)
    like = wide.init(jax.random.key(0), jnp.zeros((1, LATENT)), train=False)
    like = {"params": like["params"], "batch_stats": like["batch_stats"]}
    want = _jax_error(lambda: jax_ckpt.load_variables_checked(path, like))
    got = _jax_error(lambda: checkpoint.load_flax_checkpoint(
        dcgan.Generator(LATENT, 3, 2 * FG, SIZE), path,
        f"checkpoint {path} does not match the current model flags"))
    assert got == want and "['batch_stats']['TorchBatchNorm_0']" in got


def test_classifier_shape_error_names_the_jax_leaf(tmp_path):
    _, params, stats = jax_classifier(SIZE, STAGES, 0)
    path = _save(tmp_path / "c.msgpack", params, stats)
    like = JaxResNet50(num_classes=3, stage_sizes=STAGES).init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    like = {"params": like["params"], "batch_stats": like["batch_stats"]}
    want = _jax_error(lambda: jax_ckpt.load_classifier_variables(path, like))
    got = _jax_error(lambda: checkpoint.load_classifier_variables(
        path, ResNet50(3, stage_sizes=STAGES)))
    assert got == want and "['params']['fc']" in got


@pytest.mark.parametrize("case", ["backbone", "deeper", "missing"])
def test_classifier_pth_errors_match_jax(tmp_path, case):
    """A torchvision state dict without a 2-way head, of a deeper net, or
    missing a tensor: the JAX package's message for each."""
    _, params, stats = jax_classifier(SIZE, STAGES, 0)
    pth = str(tmp_path / "c.pth")
    save_torch_resnet50(pth, params, stats, stage_sizes=STAGES)
    sd = torch.load(pth, weights_only=True)
    if case == "backbone":
        sd["fc.weight"] = torch.zeros(1000, sd["fc.weight"].shape[1])
        sd["fc.bias"] = torch.zeros(1000)
    elif case == "deeper":
        sd["layer1.1.conv1.weight"] = sd["layer1.0.conv1.weight"]
    else:
        del sd["layer2.0.bn2.running_var"]
    torch.save(sd, pth)
    like = JaxResNet50(num_classes=2, stage_sizes=STAGES).init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    like = {"params": like["params"], "batch_stats": like["batch_stats"]}
    want = _jax_error(lambda: jax_ckpt.load_classifier_variables(pth, like))
    got = _jax_error(lambda: checkpoint.load_classifier_variables(
        pth, ResNet50(2, stage_sizes=STAGES)))
    assert got == want


def test_flax_templates_match_the_jax_trees():
    """flax_like of each port model has the JAX init tree's paths and
    shapes, in the JAX package's leaf order."""
    from xgan.models import cgan as jax_cgan_mod
    from xgan.models import dcgan as jax_dcgan
    cases = [
        (jax_dcgan.Generator(latent_dim=LATENT, feature_maps=FG,
                             image_size=SIZE), (jnp.zeros((1, LATENT)),),
         dcgan.Generator(LATENT, 3, FG, SIZE)),
        (jax_wgan.Generator(latent_dim=LATENT, feature_maps=FG,
                            image_size=SIZE), (jnp.zeros((1, LATENT)),),
         wgan.Generator(LATENT, 3, FG, SIZE)),
        (jax_cgan_mod.Generator(latent_dim=LATENT, feature_maps=FG,
                                image_size=SIZE),
         (jnp.zeros((1, LATENT)), jnp.zeros((1,), jnp.int32)),
         cgan.Generator(LATENT, feature_maps=FG, image_size=SIZE)),
        (JaxResNet50(num_classes=2, stage_sizes=STAGES),
         (jnp.zeros((1, SIZE, SIZE, 3)),),
         ResNet50(2, stage_sizes=STAGES))]
    for jax_model, args, port_model in cases:
        v = jax_model.init(jax.random.key(0), *args, train=False)
        want = [(jax.tree_util.keystr(p), np.shape(x)) for p, x in
                jax.tree_util.tree_flatten_with_path(
                    {"params": v["params"],
                     "batch_stats": v["batch_stats"]})[0]]
        got = [(p, tuple(x.shape)) for p, x in checkpoint._flatten_with_path(
            checkpoint.flax_like(port_model))]
        assert got == want


def test_written_checkpoint_loads_in_jax(tmp_path):
    """The port's writer makes a checkpoint the JAX sampler reads: the
    same images from both packages."""
    model, params, stats = jax_generator(LATENT, FG, SIZE, seed=8)
    path = str(tmp_path / "g.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.msgpack_serialize({"params": params,
                                           "batch_stats": stats}))
    like = {"params": params, "batch_stats": stats}
    loaded = jax_ckpt.load_variables_checked(path, like)
    z = jnp.asarray(np.random.default_rng(1).normal(
        size=(2, LATENT)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(model.apply(loaded, z, train=False)),
        np.asarray(model.apply(like, z, train=False)))
    assert os.path.getsize(path) == len(flax.serialization.to_bytes(like))
