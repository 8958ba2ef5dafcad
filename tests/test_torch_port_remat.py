"""``--remat`` in xgan_torch's ResNet-50 (``remat``/``remat_scope`` of
``xgan_torch/models/resnet.py``, ``torch.utils.checkpoint`` per block, per
stage, or per stage with per-block checkpoints inside) against the same
model without remat and against xgan's ``ResNet50(remat=True)``
(tests/test_remat.py holds xgan's to the same contract).

For each scope: the state-dict keys and values are those without remat,
so checkpoints move between the two; forward logits, every parameter's
gradient and the BN running statistics equal those without remat within
1e-6, the statistics having advanced once (the recompute in the backward
leaves them); the masked train step of the classifier gives the same
losses and parameters; ``cam=True`` never remats. One scope against
xgan's remat'd model from the same weights: logits and the updated
running statistics within 1e-4, the gradient of ``fc`` (for the loss
``sum(logits)``, the sum of the 4 rows' pooled features) within
4e-4 * (1 + max|g|). f32, stages (1,1,1,1), 32 px, batch 4."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_resnet import (_running_stats, jax_resnet,
                                         port_resnet)
from xgan.models.resnet import ResNet50 as FlaxResNet50
from xgan_torch.data.pipeline import DeviceStore
from xgan_torch.data.store import ImageStore
from xgan_torch.models import resnet as port_resnet_module
from xgan_torch.models.resnet import REMAT_SCOPES, ResNet50
from xgan_torch.train.classifier import classifier_optimizer, train_step

torch.set_num_threads(1)

STAGES, SIZE = (1, 1, 1, 1), 32
SCOPES = pytest.mark.parametrize("scope", REMAT_SCOPES)


def _pair(scope, seed=0):
    plain = ResNet50(2, stage_sizes=STAGES,
                     generator=torch.Generator().manual_seed(seed))
    rem = copy.deepcopy(plain)
    rem.remat, rem.remat_scope = True, scope
    return plain, rem


def _x(seed=1, b=4):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(b, SIZE, SIZE, 3)).astype(np.float32))


def _close(a, b, what):
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=what)


@SCOPES
def test_state_dict_is_the_one_without_remat(scope):
    plain = ResNet50(2, stage_sizes=STAGES,
                     generator=torch.Generator().manual_seed(0))
    rem = ResNet50(2, stage_sizes=STAGES, remat=True, remat_scope=scope,
                   generator=torch.Generator().manual_seed(0))
    a, b = plain.state_dict(), rem.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    rem.load_state_dict(a)  # and a checkpoint loads strictly


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@SCOPES
def test_forward_grads_and_stats_equal_no_remat(scope, masked):
    plain, rem = _pair(scope)
    before = {k: v.clone() for k, v in plain.state_dict().items()
              if "running" in k}
    x = _x()
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0]) if masked else None
    out = {}
    for name, model in (("plain", plain), ("remat", rem)):
        logits = model(x, train=True, mask=mask)
        w = torch.ones(4) if mask is None else mask
        (logits.square().sum(1) * w).sum().backward()
        out[name] = logits
    _close(out["remat"], out["plain"], "logits")
    for (name, p), q in zip(plain.named_parameters(), rem.parameters()):
        _close(q.grad, p.grad, name)
    stats = rem.state_dict()
    for k, v in plain.state_dict().items():
        if "running" in k:
            _close(stats[k], v, k)
            assert not torch.equal(v, before[k]), k  # it advanced once


@SCOPES
def test_recompute_runs_bn_without_updating_the_statistics(scope,
                                                           monkeypatch):
    """Every BN in a checkpoint runs again in the backward's recompute and
    updates its running statistics only in the forward."""
    _, rem = _pair(scope)
    calls = []
    bn_fn = port_resnet_module.batch_norm

    def spy(bn, x, *, update_stats=True, **kw):
        calls.append((id(bn), update_stats))
        return bn_fn(bn, x, update_stats=update_stats, **kw)
    monkeypatch.setattr(port_resnet_module, "batch_norm", spy)
    rem(_x(), train=True).sum().backward()
    bns = [m for m in rem.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        seen = [u for i, u in calls if i == id(bn)]
        # the stem runs outside every checkpoint
        assert seen == [True] if bn is rem.bn1 else (
            len(seen) >= 2 and seen[0] and not any(seen[1:])), seen


def test_masked_train_step_equals_no_remat():
    """The classifier's step on a tail batch (6 of 8 rows valid),
    ``--unfreeze``, stage scope: the same losses and parameters."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 255, (8, SIZE, SIZE, 3), np.uint8)
    store = DeviceStore(ImageStore(images, (np.arange(8) % 2).astype(
        np.int32), SIZE), "cpu")
    mask = torch.tensor([1.0] * 6 + [0.0] * 2)
    out = []
    for model in _pair("stage", seed=4):
        opt = classifier_optimizer(model, 1e-3, freeze_base=False)
        losses, _, _ = train_step(model, opt, store, store, torch.arange(8),
                                  mode="real", mask=mask,
                                  flip=torch.zeros(8, dtype=torch.bool))
        out.append((losses, model.state_dict()))
    _close(out[1][0], out[0][0], "losses")
    for k, v in out[0][1].items():
        _close(out[1][1][k], v, k)


@SCOPES
def test_cam_never_remats(scope, monkeypatch):
    _, rem = _pair(scope)
    monkeypatch.setattr("xgan_torch.models.resnet.remat", None)
    logits, conv3, feats = rem(_x(b=2), train=True, cam=True)
    assert logits.shape == (2, 2) and conv3.shape[:2] == (2, 2048)
    with pytest.raises(ValueError):
        ResNet50(2, stage_sizes=STAGES, remat=True, remat_scope="layer")


def test_stage_scope_matches_xgan_remat():
    fmodel, params, stats = jax_resnet(seed=5)
    fremat = FlaxResNet50(num_classes=2, stage_sizes=STAGES, remat=True,
                          remat_scope="stage")
    assert type(fmodel) is type(fremat)
    x = _x(seed=6)

    def loss(p):
        logits, upd = fremat.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x.numpy()), train=True,
                                   mutable=["batch_stats"])
        return jnp.sum(logits), (logits, upd["batch_stats"])
    (_, (want, new_stats)), grads = jax.value_and_grad(
        loss, has_aux=True)(params)

    model = port_resnet(params, stats)
    model.remat, model.remat_scope = True, "stage"
    logits = model(x, train=True)
    logits.sum().backward()  # fc's gradient: the pooled features' sum
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    ours = {k: v.numpy() for k, v in model.state_dict().items()
            if "running" in k}
    for k, v in _running_stats(new_stats).items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-4, err_msg=k)
    # fc's gradient sums the 4 rows' pooled features, each held at 1e-4
    fc = grads["fc"]
    np.testing.assert_allclose(model.fc.weight.grad.numpy(),
                               np.asarray(fc["kernel"]).T, rtol=0,
                               atol=4e-4 * (1 + np.abs(fc["kernel"]).max()))
    np.testing.assert_allclose(model.fc.bias.grad.numpy(),
                               np.asarray(fc["bias"]), rtol=0, atol=1e-6)
