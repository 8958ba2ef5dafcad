"""The classifier's ``--grad-accum`` in xgan_torch against the JAX
package's (``xgan/train/classifier.py``: ``_microbatch_grads`` and
``make_train_step(grad_accum=A)``), from the same weights and draws (f32,
stages (1,1,1,1), 32 px, batch 16).

- ``microbatch_grads`` for A in {2, 4}, each with no mask, a tail mask
  that leaves every microbatch some valid rows, and one (7 valid rows)
  that leaves microbatches fully padded: the valid rows' losses and
  logits within 1e-4, BN running statistics within 1e-4 (per-microbatch
  statistics, frozen on a skipped microbatch), the gradient of ``fc``
  (what the default frozen base trains) within 1e-4 * (1 + max|g|). The
  base's gradients (what ``--unfreeze`` trains) are held against a
  float64 evaluation written out here (the same weights, each
  microbatch's forward with its own BN statistics, the valid-row loss
  sum over the batch's valid count), not against JAX's: at this size
  JAX's f32 gradient of the stem conv is 1.2e-2 off float64 already at
  A = 1. Their norm-wise error is held within 1e-2: one f32
  forward and backward of rows 8-15 alone is 3.6e-3 off float64 (BN over
  8 rows of a 1x1 map), while a wrong accumulation moves it by 1 or more
  (BN over the full batch, a dropped 1/W, a flipped sign).
- One train step in mix mode through ``train_step(grad_accum=A)``
  against ``make_train_step(grad_accum=A)``: the valid rows' loss within
  1e-4 relative, ``fc`` after the step and the BN statistics within
  1e-4, and one ``mixed_gather`` call for the whole batch (the batch is
  assembled once, before the microbatches).
- The CLI trains with ``--grad-accum``; an A that does not divide the
  batch prints the JAX note and trains as A = 1.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_port_classifier import (NS, SIZE, _device_store,
                                              _mix_draws, _run_cli, _stores)
from tests.test_torch_port_resnet import (_running_stats, jax_resnet,
                                         port_resnet)
from xgan.train.classifier import _microbatch_grads
from xgan.train.classifier import classifier_optimizer as jax_optimizer
from xgan.train.classifier import make_train_step
from xgan.train.common import ModelState
from xgan_torch.data import mixer
from xgan_torch.models.convert import resnet_state_dict_from_flax
from xgan_torch.models.resnet import conv_bn
from xgan_torch.train import classifier as port_classifier
from xgan_torch.train.classifier import (classifier_optimizer,
                                         microbatch_grads, train_step)

torch.set_num_threads(1)

B = 16
STAGES = (1, 1, 1, 1)
CASES = pytest.mark.parametrize("valid", [None, 13, 7],
                                ids=["full", "tail", "padded_micro"])


def _mask(valid):
    return None if valid is None else (np.arange(B) < valid).astype(
        np.float32)


def _running(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if "running" in k}


@CASES
@pytest.mark.parametrize("accum", [2, 4])
def test_microbatch_grads_match_jax(accum, valid):
    fmodel, params, stats = jax_resnet(seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    labels = (np.arange(B) % 2).astype(np.int32)
    mask = _mask(valid)
    losses, logits, new_stats, grads = _microbatch_grads(
        fmodel, ModelState(params=params, batch_stats=stats, opt_state=None),
        jnp.asarray(x), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), accum, None)

    model = port_resnet(params, stats)
    ref = _f64_grads(model, torch.from_numpy(x),
                     torch.from_numpy(labels).long(), mask, accum)
    got_losses, got_logits = microbatch_grads(
        model, torch.from_numpy(x), torch.from_numpy(labels).long(),
        None if mask is None else torch.from_numpy(mask), accum)
    rows = slice(None) if valid is None else slice(0, valid)
    np.testing.assert_allclose(got_losses.numpy()[rows],
                               np.asarray(losses)[rows], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_logits.numpy()[rows],
                               np.asarray(logits)[rows], rtol=0, atol=1e-4)
    want, ours = _running_stats(new_stats), _running(model)
    for k, v in want.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-4, err_msg=k)
    want_g = resnet_state_dict_from_flax(jax.device_get(grads), stats,
                                         STAGES)
    for name, p in model.fc.named_parameters(prefix="fc"):
        g = want_g[name].numpy()
        tol = 1e-4 * (1 + np.abs(g).max())
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= tol, f"{name}: {err:.3g} > {tol:.3g}"
    base = [(n, p.grad) for n, p in model.named_parameters()
            if not n.startswith("fc")]
    err = sum((g.double() - ref[n]).square().sum() for n, g in base).sqrt()
    norm = sum(ref[n].square().sum() for n, _ in base).sqrt()
    assert err <= 1e-2 * norm, f"base: {err / norm:.3g} of the norm"


def _f64_grads(model, x, labels, mask, accum):
    """The gradient of the valid-row mean loss as A microbatches define it
    (each with its own BN statistics; a microbatch without valid rows
    adds nothing), in float64 on a copy of ``model``."""
    model = copy.deepcopy(model).double()
    mb, total = B // accum, B if mask is None else float(mask.sum())
    for j in range(accum):
        rows = slice(j * mb, (j + 1) * mb)
        m = None if mask is None else torch.from_numpy(mask[rows]).double()
        if m is not None and not m.sum():
            continue
        h = x[rows].double().permute(0, 3, 1, 2)
        h = torch.relu(conv_bn(model.conv1, model.bn1, h, train=True,
                               mask=m))
        h = F.max_pool2d(h, 3, 2, 1)
        for block in model.blocks():
            h = block(h, train=True, mask=m)
        logits = F.linear(h.mean(dim=(2, 3)), model.fc.weight,
                          model.fc.bias)
        losses = F.cross_entropy(logits, labels[rows], reduction="none")
        (losses if m is None else losses * m).sum().div(total).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@CASES
@pytest.mark.parametrize("accum", [2, 4])
def test_train_step_matches_jax(accum, valid, monkeypatch):
    fmodel, params, stats = jax_resnet(seed=5)
    real, real_labels, synth, synth_labels = _stores(6)
    idx = np.random.default_rng(7).integers(0, len(real), B).astype(
        np.int32)
    mask = _mask(valid)
    ratio, lr = 0.5, 1e-3
    key = jax.random.key(8)
    tx = jax_optimizer(lr, freeze_base=True)
    state = ModelState(params=params, batch_stats=stats,
                       opt_state=tx.init(params))
    step = make_train_step(fmodel, tx, mode="mix", jit_compile=False,
                           grad_accum=accum)
    new_state, losses, _, _ = step(
        state, jnp.asarray(real), jnp.asarray(real_labels),
        jnp.asarray(synth), jnp.asarray(synth_labels), jnp.asarray(idx),
        jnp.float32(ratio), key,
        mask=None if mask is None else jnp.asarray(mask))
    k_mix, k_flip = jax.random.split(key)
    use_synth, pick = _mix_draws(k_mix, ratio, NS, b=B)
    flip = torch.from_numpy(np.array(
        jax.random.bernoulli(k_flip, 0.5, (B,))))

    calls = []
    gather = mixer.mixed_gather
    monkeypatch.setattr(mixer, "mixed_gather", lambda *a, **k: (
        calls.append(a[2].shape), gather(*a, **k))[1])
    model = port_resnet(params, stats)
    opt = classifier_optimizer(model, lr, freeze_base=True)
    got, _, _ = train_step(
        model, opt, _device_store(real, real_labels),
        _device_store(synth, synth_labels),
        torch.from_numpy(idx.astype(np.int64)), mode="mix", ratio=ratio,
        mask=None if mask is None else torch.from_numpy(mask), flip=flip,
        use_synth=use_synth, synth_pick=pick, grad_accum=accum)
    assert calls == [(B,)]  # one gather of the whole batch

    # the rows of a fully padded microbatch hold NaN on the JAX side
    rows = slice(None) if valid is None else slice(0, valid)
    ref_loss = float(np.mean(np.asarray(losses)[rows]))
    got_loss = float(got.numpy()[rows].mean())
    assert abs(got_loss - ref_loss) <= 1e-4 * abs(ref_loss), \
        (got_loss, ref_loss)
    fc = new_state.params["fc"]
    np.testing.assert_allclose(model.fc.weight.detach().numpy(),
                               np.asarray(fc["kernel"]).T, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(model.fc.bias.detach().numpy(),
                               np.asarray(fc["bias"]), rtol=0, atol=1e-4)
    want, ours = _running_stats(new_state.batch_stats), _running(model)
    for k, v in want.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-4, err_msg=k)


def test_accum_one_is_the_plain_step(monkeypatch):
    """``grad_accum=1`` never enters the microbatch path."""
    monkeypatch.setattr(port_classifier, "microbatch_grads", None)
    _, params, stats = jax_resnet(seed=9)
    real, real_labels, synth, synth_labels = _stores(10)
    model = port_resnet(params, stats)
    losses, _, _ = train_step(
        model, classifier_optimizer(model, 1e-3, freeze_base=True),
        _device_store(real, real_labels), _device_store(synth, synth_labels),
        torch.arange(8), mode="real", grad_accum=1,
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(losses).all()


def test_cli_trains_with_grad_accum(tmp_path, fake_dataset):
    """24 images, 2 folds at B = 8 and A = 4: each fold's tail batch holds
    4 valid rows, so its last microbatch is all padding."""
    summary, out = _run_cli(tmp_path, fake_dataset, "--k-folds", "2",
                            "--grad-accum", "4")
    assert np.isfinite(summary["average"]["loss"])
    ckpts = [p.name for p in (out / "models").iterdir()]
    assert ckpts and all(n.endswith("_baseline_resnet50.pth") for n in ckpts)


def test_cli_non_dividing_accum_prints_the_note(tmp_path, fake_dataset,
                                                capsys):
    plain, _ = _run_cli(tmp_path / "plain", fake_dataset, "--k-folds", "1")
    capsys.readouterr()
    noted, _ = _run_cli(tmp_path / "a3", fake_dataset, "--k-folds", "1",
                        "--grad-accum", "3")
    out = capsys.readouterr().out
    assert ("Note: --grad-accum 3 does not divide the (device-padded) "
            "batch size 8; running without accumulation.") in out
    assert noted == plain
