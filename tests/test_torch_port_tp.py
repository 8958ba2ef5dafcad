"""xgan_torch's model-axis rule, ``--model-parallel`` and ``--shard-opt-
state`` without ranks to shard over, and the fold groups of
``--parallel-folds`` (``xgan_torch/parallel/tp.py``,
``xgan_torch/train/parallel_cv.py``) against the JAX package's
(``xgan/parallel/tp.py``, ``xgan/train/parallel_folds.py``).

- ``model_axis_spec`` equals the JAX one's sharded axis over a grid of
  shapes, sizes and widths; the torch-layout map (``shard_dims``) of
  ResNet-50's, the DCGAN's, WGAN-GP's and CGAN's parameters equals the
  JAX rule on the same leaves in the JAX layout, at 2 and 4 ranks, at the
  CLI's width (256) and tests/test_tp.py's (64).
- ``model_parallel_from_args`` prints the JAX note where the JAX package
  does, and returns what it returns for the same device count.
- Under a 2-rank launch environment ``--model-parallel 2`` lays the
  WGAN-GP and CGAN trainers' ranks out as the JAX ``(data, model)`` mesh
  and hands their loops the data group (every trainer takes it: the
  steps in ``tests/test_torch_port_dist_tp.py`` and
  ``tests/test_torch_port_dist_tp_gans.py``, the CLIs in
  ``tests/test_torch_port_dist_cli.py``).
- ``fold_groups`` equals ``fold_mesh``'s device rows for worlds 1, 2 and 8.
"""
import argparse

import jax
import pytest
import torch
from torch import nn

from xgan.parallel import tp as jax_tp
from xgan.train.parallel_folds import fold_mesh
from xgan_torch.cli import train_cgan, train_wggan
from xgan_torch.models import cgan, dcgan, wgan
from xgan_torch.models.resnet import ResNet50
from xgan_torch.parallel import tp
from xgan_torch.train.parallel_cv import fold_groups

LAUNCH = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
          "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}


def _jax_dim(shape, n, min_features):
    """The sharded axis of the JAX rule's PartitionSpec, or None."""
    spec = jax_tp.model_axis_spec(shape, n, min_features)
    axes = [i for i, a in enumerate(spec) if a is not None]
    return axes[0] if axes else None


@pytest.mark.parametrize("n,min_features", [(2, 256), (4, 64), (8, 256),
                                            (3, 64)])
def test_model_axis_spec_matches_jax(n, min_features):
    shapes = [(3, 3, 64, 512), (3, 3, 512, 6), (1, 1, 1024, 2048),
              (4, 4, 100, 300), (2048, 2), (2, 2048), (512, 1000),
              (512,), (48,), (300,), (), (7, 7, 3, 64), (256,), (64, 64)]
    for shape in shapes:
        assert tp.model_axis_spec(shape, n, min_features) == \
            _jax_dim(shape, n, min_features), shape


def _jax_layout(module, name, t):
    """The JAX layout of a torch leaf: HWIO conv and deconv kernels,
    (I, O) dense kernels, the rest as they are; and the map from the JAX
    layout's axes back to the torch ones."""
    shape = tuple(t.shape)
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return (shape[2], shape[3], shape[0], shape[1]), (2, 3, 0, 1)
    if name == "weight" and isinstance(module, nn.Conv2d):
        return (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0)
    if name == "weight" and isinstance(module, nn.Linear):
        return (shape[1], shape[0]), (1, 0)
    return shape, tuple(range(len(shape)))


def _models():
    return {"resnet50": ResNet50(2, device="meta"),
            "dcgan_g": dcgan.Generator(100, 3, 64, 224, device="meta"),
            "dcgan_d": dcgan.Discriminator(3, 64, 224, device="meta"),
            "wgan_g": wgan.Generator(100, 3, 64, 224, device="meta"),
            "wgan_c": wgan.Critic(3, 64, 224, device="meta"),
            "cgan_g": cgan.Generator(100, 2, 3, 32, 224, device="meta"),
            "cgan_d": cgan.Discriminator(2, 3, 32, 224, device="meta")}


@pytest.mark.parametrize("name", list(_models()))
def test_torch_layout_map_matches_the_jax_rule(name):
    model = _models()[name]
    sharded = 0
    for n, min_features in ((2, 256), (4, 256), (2, 64), (4, 64)):
        dims = tp.shard_dims([model], n, min_features)
        for module in model.modules():
            for leaf, p in module.named_parameters(recurse=False):
                shape, to_torch = _jax_layout(module, leaf, p)
                want = _jax_dim(shape, n, min_features)
                want = None if want is None else to_torch[want]
                assert dims[p] == want, (name, leaf, tuple(p.shape), n)
                sharded += want is not None
    assert sharded, name  # every model has wide leaves at width 64


@pytest.mark.parametrize("n,world,note", [(1, 1, False), (4, 1, True),
                                          (2, 1, True), (2, 2, False),
                                          (3, 2, True), (4, 8, False)])
def test_model_parallel_from_args_matches_jax(n, world, note, capsys,
                                              monkeypatch):
    args = argparse.Namespace(model_parallel=n)
    got = tp.model_parallel_from_args(args, world)
    ours = capsys.readouterr().out
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * world)
    want = jax_tp.model_parallel_from_args(args)
    assert got == want and ours == capsys.readouterr().out
    assert ("Note: --model-parallel" in ours) == note


@pytest.mark.parametrize("cli,loop", [(train_wggan, "wgan_loop.train_wgan"),
                                      (train_cgan, "cgan_loop.train_cgan")],
                         ids=["train_wggan", "train_cgan"])
def test_model_parallel_dividing_the_ranks_joins_the_layout(cli, loop,
                                                            monkeypatch,
                                                            capsys):
    """Under a 2-rank launch environment ``--model-parallel 2`` lays the
    ranks out as the JAX mesh {'data': 1, 'model': 2} and hands the
    trainer's loop rank 0's data group, carrying its model group (a
    group-free stand-in for the joined world: ``split_model`` then makes
    no process group)."""
    from xgan_torch.parallel import mesh as mesh_mod
    from xgan_torch.parallel.mesh import MeshContext
    for k, v in LAUNCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh_mod, "init_from_env", lambda cpu, backend=None:
                        MeshContext(torch.device("cpu"), 0, 2))
    seen = {}
    module, name = loop.split(".")
    monkeypatch.setattr(f"xgan_torch.train.{module}.{name}",
                        lambda args, device, dtype, mesh: seen.update(
                            mesh=mesh) or "trained")
    assert cli.main(["--cpu", "--model-parallel", "2"]) == "trained"
    out = capsys.readouterr().out
    assert "Tensor parallelism: mesh {'data': 1, 'model': 2}; rank 0 is " \
        "data rank 0, model rank 0" in out, out[-2000:]
    assert "Error:" not in out
    data = seen["mesh"]
    assert (data.rank, data.world, data.is_main) == (0, 1, True)
    assert (data.model.rank, data.model.world) == (0, 2)


@pytest.mark.parametrize("world", [1, 2, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_fold_groups_match_fold_mesh(world, k):
    devs = jax.devices()
    if len(devs) < world:
        pytest.skip(f"needs {world} emulated devices")
    mesh = fold_mesh(devs[:world], k)
    want = [[devs.index(d) for d in row] for row in mesh.devices]
    assert fold_groups(k, world) == want
    assert dict(mesh.shape) == {"fold": len(want), "data": len(want[0])}


def test_shard_opt_state_without_ranks_is_the_optimizer():
    """As the JAX package returns the state unchanged on one device."""
    model = nn.Linear(512, 512)
    opt = torch.optim.Adam(model.parameters())
    assert tp.shard_opt_state(opt, [model], None) is opt
