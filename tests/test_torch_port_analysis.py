"""xgan_torch's analyzer against the JAX package's ``xgan.analysis``, on the
CPU at small sizes.

- SSIM within 1e-5 of ``xgan.ops.ssim`` on the same float images (the
  port's chunking included); ``eigen_smooth_2d`` within 1e-5 of xgan's on
  the cases of tests/test_analysis.py; conv3 and stage_output Grad-CAM
  maps within 5e-3 of ``grad_cam_resnet`` with the same predicted label,
  from flax weights carried over by ``resnet_state_dict_from_flax``
  (stages (1,1,1,1), 64 px).
- ``load_metrics`` and ``comparison_report.txt`` equal, byte for byte,
  for the same metrics directories, and the SSIM and Grad-CAM sample
  picks equal xgan's (pandas and ``random.Random``) on the fixture.
- The grey loader within one u8 level of PIL (``convert("L")`` itself
  bit-exact), ``jet`` within 1/255 of matplotlib's table.
- ``python -m xgan_torch.cli.analyze_results --cpu`` writes the file
  names xgan's analysis functions write on the same inputs, each PNG
  decodes, and without a card and without ``--cpu`` it exits 1.
"""
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import xgan.analysis as jax_analysis
from tests.test_schema_compat import REF as REFERENCE_METRICS
from tests.test_torch_port_resnet import jax_resnet, port_resnet
from xgan.ops import ssim as jax_ssim
from xgan_torch import analysis
from xgan_torch.cli import analyze_results as cli
from xgan_torch.models.resnet import ResNet50
from xgan_torch.native.png import decode_png
from xgan_torch.ops import ssim

torch.set_num_threads(1)

STAGES = (1, 1, 1, 1)


@pytest.mark.parametrize("na,nb,size", [(7, 3, 32), (3, 600, 16),
                                        (2, 1, 7)])
def test_ssim_matches_jax(na, nb, size):
    """(3, 600): more real images than the chunk budget, one synthetic
    image per chunk; size 7: a single window."""
    rng = np.random.default_rng(size)
    a = rng.random((na, size, size)).astype(np.float32)
    b = np.clip(a[:1] + 0.3 * rng.random((nb, size, size)), 0, 1) \
        .astype(np.float32)
    want = np.asarray(jax_ssim.ssim_pair_matrix(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = ssim.ssim_pair_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = np.asarray(jax_ssim.mean_ssim_per_synthetic(jnp.asarray(a),
                                                       jnp.asarray(b)))
    got = ssim.mean_ssim_per_synthetic(torch.from_numpy(a),
                                       torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _weighted_maps():
    """The maps of tests/test_analysis.py's eigen_smooth cases."""
    rng = np.random.default_rng(7)
    golden = rng.normal(size=(7, 7, 64)).astype(np.float32) + 4.0 * (
        rng.normal(size=(7, 7, 1)) * rng.normal(size=(1, 1, 64))
    ).astype(np.float32)
    a = np.random.default_rng(3).normal(size=(7, 7, 1)).astype(np.float32)
    return {"rank1_golden": golden,
            "one_pixel": np.ones((1, 1, 16), np.float32),
            "all_zero": np.zeros((4, 4, 8), np.float32),
            "zero_row_sums": np.concatenate([a, -a], axis=-1)}


@pytest.mark.parametrize("case", sorted(_weighted_maps()))
def test_eigen_smooth_matches_jax(case):
    x = _weighted_maps()[case]
    want = np.asarray(jax_analysis.eigen_smooth_2d(jnp.asarray(x)))
    got = analysis.eigen_smooth_2d(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("target,eigen", [("conv3", True),
                                          ("stage_output", True),
                                          ("conv3", False)])
def test_grad_cam_matches_jax(target, eigen):
    model, params, stats = jax_resnet(seed=3)
    rng = np.random.default_rng(11)
    for i in range(2):
        x = rng.normal(size=(64, 64, 3)).astype(np.float32)
        want_pred, want = jax_analysis.grad_cam_resnet(
            model, {"params": params, "batch_stats": stats}, x,
            eigen_smooth=eigen, target=target)
        pred, cam = analysis.grad_cam_resnet(
            port_resnet(params, stats).eval(), torch.from_numpy(x),
            eigen_smooth=eigen, target=target)
        assert pred == want_pred
        assert cam.shape == want.shape == (2, 2)
        assert cam.min() >= 0 and cam.max() <= 1
        np.testing.assert_allclose(cam, want, rtol=0, atol=5e-3)


def test_cam_forward_taps_conv3_before_bn():
    """``cam=True`` leaves the logits as they are and returns conv3's
    pre-BN output (bn3 of it is the block's residual branch) and the
    layer4 output the mean-pool reads."""
    _, params, stats = jax_resnet(seed=1)
    model = port_resnet(params, stats).eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        logits, conv3, feats = model(x, train=False, cam=True)
        np.testing.assert_array_equal(logits.numpy(),
                                      model(x, train=False).numpy())
        block = model.layer4[-1]
        np.testing.assert_array_equal(
            torch.nn.functional.linear(feats.mean(dim=(2, 3)),
                                       model.fc.weight,
                                       model.fc.bias).numpy(),
            logits.numpy())
        bn = torch.nn.functional.batch_norm(
            conv3, block.bn3.running_mean, block.bn3.running_var,
            block.bn3.weight, block.bn3.bias, eps=block.bn3.eps)
    assert conv3.shape == (2, 2048, 2, 2) and conv3.requires_grad is False
    assert not torch.allclose(bn, conv3)  # the tap is before BN


# ---- the report and the metrics loader ------------------------------------

def _hist(n, ratio, shift=0.0):
    ep = np.arange(1, n + 1)
    return {"epoch": ep.tolist(),
            "train_loss": (0.7 / ep + shift).tolist(),
            "train_acc": (0.5 + 0.03 * ep + shift).tolist(),
            "val_loss": (0.8 / ep + shift).tolist(),
            "val_acc": (0.5 + 0.02 * ep).tolist(),
            "synthetic_ratio": [ratio] * n}


def _cv(rng, folds=2):
    keys = ["loss", "accuracy", "weighted_precision", "weighted_recall",
            "weighted_f1_score", "auroc"]
    fold_m = [{k: float(rng.random()) for k in keys} for _ in range(folds)]
    return {"folds": fold_m,
            "average": {k: float(np.mean([m[k] for m in fold_m]))
                        for k in keys},
            "std_dev": {k: float(np.std([m[k] for m in fold_m]))
                        for k in keys}}


def write_metrics(root: Path, case: str) -> Path:
    """A metrics directory in the reference's schema; ``case``:

    - "cv": baseline, augmented and curriculum with 2-fold CV (ragged
      fold histories);
    - "single": single runs with final metrics, where the baseline has a
      0 metric, an int and a missing key, as reference-produced files
      may;
    - "mixed": curriculum CV and augmented single, no baseline (the run
      set of chip_smoke.py's analyzer phase)."""
    rng = np.random.default_rng(len(case))
    d = root / f"metrics_{case}"
    d.mkdir(parents=True)

    def put(name, payload):
        (d / name).write_text(json.dumps(payload, indent=4))

    if case in ("cv", "mixed"):
        runs = ["baseline", "augmented", "curriculum"] if case == "cv" \
            else ["curriculum"]
        for run in runs:
            put(f"{run}_cv_summary.json", _cv(rng))
            ratio = {"baseline": 0.0, "augmented": 1.0,
                     "curriculum": 0.25}[run]
            put(f"fold_1_{run}_training_history.json", _hist(3, ratio))
            put(f"fold_2_{run}_training_history.json",
                _hist(2, ratio, 0.01))
    if case in ("single", "mixed"):
        runs = ["baseline", "augmented"] if case == "single" \
            else ["augmented"]
        for run in runs:
            m = {"loss": 0.5, "accuracy": float(rng.random()),
                 "weighted_precision": float(rng.random()),
                 "weighted_recall": float(rng.random()),
                 "weighted_f1_score": float(rng.random())}
            if run == "baseline":
                m.update(weighted_precision=0.0, weighted_recall=1)
                del m["weighted_f1_score"]
            put(f"{run}_training_history.json",
                _hist(2, 1.0 if run == "augmented" else 0.0))
            put(f"{run}_final_metrics.json", {"config": {}, "metrics": m})
    return d


def _load_all(mod, metrics_dir):
    out = {}
    for prefix in ("baseline_", "augmented_", "curriculum_"):
        loaded = mod.load_metrics(str(metrics_dir), prefix)
        if loaded:
            out[prefix[:-1]] = loaded
    return out


@pytest.mark.parametrize("case", ["cv", "single", "mixed", "reference"])
def test_report_matches_jax(tmp_path, case):
    if case == "reference":  # the reference's checked-in metrics, if any
        metrics_dir = REFERENCE_METRICS
        if not metrics_dir.exists():
            pytest.skip("reference artifacts not mounted")
    else:
        metrics_dir = write_metrics(tmp_path, case)
    ours, theirs = _load_all(analysis, metrics_dir), \
        _load_all(jax_analysis, metrics_dir)
    assert ours == theirs and ours
    for name, mod, data in (("port", analysis, ours),
                            ("jax", jax_analysis, theirs)):
        (tmp_path / name).mkdir()
        mod.generate_summary_report(data, str(tmp_path / name))
    got = (tmp_path / "port" / "comparison_report.txt").read_bytes()
    assert got == (tmp_path / "jax" / "comparison_report.txt").read_bytes()
    if case == "single":
        assert b"(Baseline: 0)" in got and b"N/A" in got


# ---- sample picks, the grey loader, jet -----------------------------------

@pytest.mark.parametrize("n_real,n_synth", [(3, 5), (100, 500)])
def test_ssim_picks_match_jax(fake_dataset, tmp_path, monkeypatch, n_real,
                              n_synth):
    seen = []

    def recording_loader(paths, size):
        seen.append([str(p) for p in paths])
        return np.zeros((len(paths), size, size), np.float32) + 0.5

    monkeypatch.setattr(jax_analysis, "_load_grayscale", recording_loader)
    monkeypatch.setattr(jax_analysis.plt, "savefig", lambda *a, **k: None)
    jax_analysis.calculate_ssim_distribution(
        fake_dataset["data_dir"], fake_dataset["synthetic_dir"],
        str(tmp_path), num_real_samples=n_real,
        num_synthetic_samples=n_synth, image_size=8)
    real, synth = analysis.ssim_picks(fake_dataset["data_dir"],
                                      fake_dataset["synthetic_dir"], n_real,
                                      n_synth)
    assert [real, synth] == seen
    assert len(real) == min(n_real, 8) and len(synth) == min(n_synth, 12)


def _stub_jax_cam(monkeypatch):
    """xgan's analyzer with the model parts and matplotlib's file writes
    stubbed out: its sample picks and file names without tracing a full
    ResNet-50 or rendering at 300 dpi."""
    import xgan.io_.checkpoint
    import xgan.models.resnet

    monkeypatch.setattr(jax_analysis.plt, "savefig",
                        lambda path, **_: Path(path).touch())

    class Model:
        def __init__(self, **_):
            pass

        def init(self, *_, **__):
            return {"params": {}, "batch_stats": {}}

    monkeypatch.setattr(xgan.models.resnet, "ResNet50", Model)
    monkeypatch.setattr(xgan.io_.checkpoint, "load_classifier_variables",
                        lambda path, like: {})
    monkeypatch.setattr(jax_analysis, "grad_cam_resnet",
                        lambda *a, **k: (0, np.zeros((1, 1), np.float32)))


@pytest.mark.parametrize("n", [1, 3, 20])
def test_gradcam_picks_match_jax(fake_dataset, tmp_path, monkeypatch, n):
    _stub_jax_cam(monkeypatch)
    models = tmp_path / "models"
    models.mkdir()
    torch.save({}, models / "baseline_resnet50.pth")
    out = tmp_path / "jax"
    out.mkdir()
    jax_analysis.generate_grad_cam_comparison(
        str(models), fake_dataset["data_dir"], fake_dataset["synthetic_dir"],
        str(out), num_samples=n, image_size=8)
    samples = analysis.gradcam_samples(fake_dataset["data_dir"],
                                       fake_dataset["synthetic_dir"], n)
    names = [f"gradcam_{s['type']}_{s['patientId']}.png" for s in samples]
    assert sorted(names) == sorted(os.listdir(out))
    assert len(names) == min(n, 8) + min(n, 16) + min(n, 12)


def _png_variants(tmp_path):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (48, 40, 3), np.uint8)
    paths = []
    for mode, size in (("RGB", 48), ("L", 48), ("RGBA", 48), ("P", 48),
                       ("RGB", 20)):
        img = Image.fromarray(rgb).resize((size, size))
        img = img.convert(mode) if mode != "P" else img.quantize(64)
        paths.append(str(tmp_path / f"{mode}_{size}.png"))
        img.save(paths[-1])
    return paths


def test_grey_loader_within_one_level_of_pil(tmp_path):
    rgb = np.random.default_rng(4).integers(0, 256, (64, 64, 3), np.uint8)
    np.testing.assert_array_equal(
        analysis.grey_u8(rgb), np.asarray(Image.fromarray(rgb).convert("L")))
    paths = _png_variants(tmp_path) + [str(tmp_path / "missing.png")]
    want = jax_analysis._load_grayscale(paths, 32)
    got = analysis._load_grayscale(paths, 32)
    assert got.shape == want.shape == (5, 32, 32) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1 / 255 + 1e-6


def test_jet_matches_matplotlib():
    import matplotlib
    cmap = matplotlib.colormaps["jet"]
    np.testing.assert_allclose(analysis.JET,
                               cmap(np.arange(256))[:, :3], rtol=0,
                               atol=1 / 255)
    v = np.concatenate([np.linspace(0, 1, 1001),
                        np.random.default_rng(0).random(1000)])
    np.testing.assert_allclose(analysis.jet(v), cmap(v)[:, :3], rtol=0,
                               atol=1 / 255)


# ---- the CLI ---------------------------------------------------------------

def _models_dir(root: Path) -> Path:
    """The port's checkpoints for two runs; a corrupt flax file for the
    third."""
    d = root / "models"
    d.mkdir()
    for i, run in enumerate(("baseline", "augmented")):
        model = ResNet50(2, stage_sizes=STAGES,
                         generator=torch.Generator().manual_seed(i))
        torch.save(model.state_dict(), d / f"{run}_resnet50.pth")
    (d / "curriculum_resnet50.msgpack").write_bytes(b"not read")
    return d


def test_cli_writes_the_jax_file_names(fake_dataset, tmp_path, monkeypatch,
                                       capsys):
    metrics = write_metrics(tmp_path, "cv")
    models = _models_dir(tmp_path)
    data, synth = fake_dataset["data_dir"], fake_dataset["synthetic_dir"]
    ours = tmp_path / "port"
    cli.main(["--cpu", "--metrics-dir", str(metrics), "--analysis-dir",
              str(ours), "--model-dir", str(models), "--data-dir", data,
              "--synthetic-dir", synth, "--image-size", "32",
              "--num-gradcam-samples", "2", "--resnet-stages", "1,1,1,1"])
    text = capsys.readouterr().out
    assert text.count("Loaded model:") == 2
    # a .msgpack that does not load is reported and skipped, as JAX does
    assert "Warning: failed to load" in text
    assert "curriculum_resnet50.msgpack" in text

    _stub_jax_cam(monkeypatch)
    theirs = tmp_path / "jax"
    theirs.mkdir()
    loaded = _load_all(jax_analysis, metrics)
    jax_analysis.plot_training_comparison(loaded, str(theirs))
    jax_analysis.plot_cv_comparison(loaded, str(theirs))
    jax_analysis.generate_summary_report(loaded, str(theirs))
    jax_analysis.calculate_ssim_distribution(data, synth, str(theirs),
                                             image_size=32)
    jax_analysis.generate_grad_cam_comparison(
        str(models), data, synth, str(theirs), num_samples=2, image_size=32)

    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert len(names) == 4 + 1 + 1 + 6
    assert (ours / "comparison_report.txt").read_bytes() == \
        (theirs / "comparison_report.txt").read_bytes()
    for name in names:
        if name.endswith(".png"):
            img = decode_png(str(ours / name))
            assert img.ndim == 3 and img.shape[2] == 3 and img.std() > 0
    panel = decode_png(str(ours / [n for n in names
                                   if n.startswith("gradcam_")][0]))
    assert panel.shape[1] > 3 * 224  # the original and two CAM panels


def test_cli_skip_flags_and_no_metrics(tmp_path, capsys):
    metrics = write_metrics(tmp_path, "mixed")
    out = tmp_path / "out"
    cli.main(["--cpu", "--metrics-dir", str(metrics), "--analysis-dir",
              str(out), "--skip-plots", "--skip-ssim", "--skip-gradcam"])
    assert os.listdir(out) == ["comparison_report.txt"]
    assert cli.main(["--cpu", "--metrics-dir", str(tmp_path / "none"),
                     "--analysis-dir", str(out)]) is None
    assert "Error: No valid metrics loaded" in capsys.readouterr().out


def test_cli_needs_a_card_without_cpu_flag(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    with pytest.raises(SystemExit) as e:
        cli.main(["--analysis-dir", str(tmp_path / "a")])
    assert e.value.code == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("Error:"), last
    assert not (tmp_path / "a").exists()


def test_flags_and_defaults_follow_the_jax_cli():
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "src" / \
        "analyze_results.py"
    spec = importlib.util.spec_from_file_location("jax_analyze", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ours = {a.dest: a.default for a in cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in mod.build_parser()._actions}
    assert set(ours) - set(theirs) == {"resnet_stages"}
    assert all(ours[k] == v for k, v in theirs.items())


def test_cam_models_prefer_the_jax_msgpack(tmp_path, capsys):
    """A run's ``{prefix}resnet50.msgpack`` (a JAX checkpoint) is loaded
    before its ``.pth`` twin, as the JAX analyzer does, and gives the
    JAX weights."""
    import jax
    import jax.numpy as jnp
    from xgan.io_.checkpoint import save_variables
    from xgan.models.resnet import ResNet50 as JaxResNet50
    from xgan_torch.io_.checkpoint import state_dict_from_flax
    v = JaxResNet50(num_classes=2, stage_sizes=STAGES).init(
        jax.random.key(4), jnp.zeros((1, 32, 32, 3)), train=False)
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    save_variables(str(tmp_path / "baseline_resnet50.msgpack"), v)
    torch.save(ResNet50(2, stage_sizes=STAGES).state_dict(),
               tmp_path / "baseline_resnet50.pth")
    models = analysis.load_cam_models(str(tmp_path), device=torch.device(
        "cpu"), stage_sizes=STAGES)
    assert list(models) == ["baseline"]
    assert "Loaded model: " + str(tmp_path / "baseline_resnet50.msgpack") \
        in capsys.readouterr().out
    want = state_dict_from_flax(models["baseline"], v)
    for k, t in models["baseline"].state_dict().items():
        assert torch.equal(t, want[k]), k
