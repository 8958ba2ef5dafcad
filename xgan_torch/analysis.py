"""Results analysis: run comparison, report, SSIM distribution, Grad-CAM
(role of xgan/analysis.py, function for function).

- ``load_metrics``, the comparison plots and ``comparison_report.txt``
  read the reference's metrics-JSON schemas, so they work on the port's
  outputs, the JAX package's and the reference's alike; the report is
  the JAX package's text, byte for byte.
- The SSIM distribution picks its images as the JAX package does (pandas'
  ``DataFrame.sample(n, random_state=s)`` is the rows at
  ``RandomState(s).permutation(len)[:n]``, in CSV order of the positives)
  and computes all pairs on the device (``xgan_torch.ops.ssim``).
- Grad-CAM reads ``{prefix}resnet50.msgpack`` (a JAX checkpoint) or,
  failing that, ``{prefix}resnet50.pth``, as the JAX analyzer does; its
  default target is the reference's, the pre-BN output of
  ``layer4[-1].conv3`` with GAP-of-gradient channel weights, and
  ``eigen_smooth_2d`` is the JAX package's power iteration, so the maps
  agree with the JAX ones and not only up to an SVD sign.

Figures are drawn by ``xgan_torch.io_.plots``: the GPU host has no
matplotlib, PIL, pandas or seaborn.
"""
from __future__ import annotations

import json
import os
import pickle
import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from xgan_torch.data import rsna
from xgan_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from xgan_torch.data.store import resize_u8
from xgan_torch.io_ import plots
from xgan_torch.native.png import decode_png

RUN_COLORS = {"baseline": "#1f77b4", "augmented": "#2ca02c",
              "curriculum": "#ff7f0e"}
METRIC_KEYS = [("accuracy", "Accuracy"),
               ("weighted_precision", "Precision (Weighted)"),
               ("weighted_recall", "Recall (Weighted)"),
               ("weighted_f1_score", "F1 Score (Weighted)")]
PREFIXES = ("baseline_", "augmented_", "curriculum_")


def _jet_table() -> np.ndarray:
    """matplotlib's ``jet`` as a (256, 3) float table: its segment data
    interpolated at 256 evenly spaced points, as
    ``LinearSegmentedColormap`` builds its lookup table."""
    segments = ([(0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0),
                 (1.0, 0.5)],
                [(0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
                 (0.91, 0.0), (1.0, 0.0)],
                [(0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0),
                 (1.0, 0.0)])
    x = np.linspace(0.0, 1.0, 256)
    return np.stack([np.interp(x, *zip(*seg)) for seg in segments], -1)


JET = _jet_table()


def jet(values: np.ndarray) -> np.ndarray:
    """Float values in [0, 1] -> (..., 3) RGB in [0, 1], indexed as
    matplotlib's colormaps index their table (floor(v * 256), 1.0 -> 255)."""
    idx = np.clip((np.asarray(values, float) * 256).astype(int), 0, 255)
    return JET[idx]


def load_metrics(metrics_dir: str, prefix: str,
                 max_folds: int = 5) -> Optional[Dict]:
    """Load one run's metrics set (reference load_metrics semantics,
    analyze_results.py:93-145)."""
    metrics_dir = Path(metrics_dir)
    metrics: Dict = {}
    cv_path = metrics_dir / f"{prefix}cv_summary.json"
    if cv_path.exists():
        metrics["cv"] = json.loads(cv_path.read_text())
        fold_histories = []
        for fold in range(1, max_folds + 1):
            p = metrics_dir / f"fold_{fold}_{prefix}training_history.json"
            if p.exists():
                h = json.loads(p.read_text())
                h["fold"] = fold
                fold_histories.append(h)
        if fold_histories:
            metrics["history"] = fold_histories[0]
            metrics["fold_histories"] = fold_histories
        return metrics

    hist_path = metrics_dir / f"{prefix}training_history.json"
    if hist_path.exists():
        metrics["history"] = json.loads(hist_path.read_text())
    else:
        # no CV summary and no history: the run is left out, as the
        # reference's essential_missing path (analyze_results.py:123-140)
        print(f"Warning: training history not found: {hist_path}")
        return None
    final_path = metrics_dir / f"{prefix}final_metrics.json"
    if final_path.exists():
        metrics["final"] = json.loads(final_path.read_text())
    return metrics or None


def plot_training_comparison(metrics_dict: Dict[str, Dict],
                             figures_dir: str) -> None:
    """Overlay train/val curves across runs: comparison_{acc,loss,
    synthetic_ratio}.png (analyze_results.py:147-213)."""
    valid = {k: v for k, v in metrics_dict.items() if v and "history" in v}
    if not valid:
        print("No valid training history found to plot comparisons.")
        return
    for metric, title in [("acc", "Accuracy"), ("loss", "Loss"),
                          ("synthetic_ratio", "Synthetic Ratio")]:
        lines = []
        for run, m in valid.items():
            h = m["history"]
            color = RUN_COLORS.get(run, "#808080")
            label = run.replace("_", " ").title()
            if metric == "synthetic_ratio":
                vals = h.get("synthetic_ratio", [])
                if vals and any(vals):
                    lines.append(plots.Line(range(1, len(vals) + 1), vals,
                                            color, style="-.",
                                            label=f"{label} Ratio"))
                    for fh in m.get("fold_histories", [])[1:]:
                        fv = fh.get("synthetic_ratio", [])
                        if fv:
                            lines.append(plots.Line(range(1, len(fv) + 1),
                                                    fv, color, style="-.",
                                                    alpha=0.3))
            else:
                tk, vk = f"train_{metric}", f"val_{metric}"
                if tk in h and vk in h:
                    ep = range(1, len(h[tk]) + 1)
                    lines.append(plots.Line(ep, h[tk], color,
                                            label=f"{label} Train"))
                    lines.append(plots.Line(ep, h[vk], color, style="--",
                                            label=f"{label} Val"))
                    for fh in m.get("fold_histories", [])[1:]:
                        if tk in fh and vk in fh:
                            fe = range(1, len(fh[tk]) + 1)
                            lines.append(plots.Line(fe, fh[tk], color,
                                                    alpha=0.3))
                            lines.append(plots.Line(fe, fh[vk], color,
                                                    style="--", alpha=0.3))
        if not lines:
            continue
        canvas, _ = plots.chart(lines, title=f"Training {title} Comparison",
                                xlabel="Epoch", ylabel=title,
                                size=(1200, 600))
        path = os.path.join(figures_dir, f"comparison_{metric}.png")
        plots.save_png(canvas, path)
        print(f"Saved {title} comparison plot to {path}")


def plot_cv_comparison(metrics_dict: Dict[str, Dict],
                       figures_dir: str) -> None:
    """Grouped bars with std error bars: cv_comparison.png
    (analyze_results.py:215-283)."""
    valid = {k: v for k, v in metrics_dict.items() if v and "cv" in v}
    if not valid:
        print("No valid cross-validation results found to plot comparison.")
        return
    names = [lbl for _, lbl in METRIC_KEYS]
    index = np.arange(len(names))
    n_runs = len(valid)
    bar_w = 0.8 / n_runs
    bars = []
    for i, (run, m) in enumerate(valid.items()):
        avg = m["cv"].get("average", {})
        std = m["cv"].get("std_dev", {})
        bars.append(plots.Bars(
            index - (n_runs / 2 - 0.5 - i) * bar_w,
            [avg.get(k, np.nan) for k, _ in METRIC_KEYS], bar_w,
            RUN_COLORS.get(run, plots.CYCLE[i % len(plots.CYCLE)]),
            alpha=0.8, yerr=[std.get(k, 0.0) for k, _ in METRIC_KEYS],
            label=run.replace("_", " ").title()))
    canvas, _ = plots.chart(
        bars, title="Cross-Validation Results Comparison (Mean ± Std Dev)",
        xlabel="Metrics", ylabel="Score", xticks=(index, names), grid="y",
        size=(max(1200, 80 * len(names) * n_runs + 200), 600))
    path = os.path.join(figures_dir, "cv_comparison.png")
    plots.save_png(canvas, path)
    print(f"Saved CV comparison plot to {path}")


def generate_summary_report(metrics_dict: Dict[str, Dict],
                            analysis_dir: str) -> str:
    """comparison_report.txt with delta-vs-baseline lines
    (analyze_results.py:285-355)."""
    lines = ["=== Model Performance Comparison Report ===\n"]
    valid = {k: v for k, v in metrics_dict.items() if v}

    finals = {n: r["final"]["metrics"] for n, r in valid.items()
              if "final" in r and "metrics" in r.get("final", {})}
    if finals:
        lines.append("\n--- Final Test Set Performance ---")
        base = finals.get("baseline")
        for name, m in finals.items():
            lines.append(f"\n* {name.replace('_', ' ').title()}:")
            for key, label in METRIC_KEYS:
                v = m.get(key, "N/A")
                line = (f"  - {label:<20}: {v:.4f}"
                        if isinstance(v, float) else
                        f"  - {label:<20}: {v}")
                if base and name != "baseline" and key in base:
                    bv = base[key]
                    if isinstance(v, float) and isinstance(bv, float) \
                            and bv != 0:
                        line += f" ({(v - bv) / bv * 100:+.1f}% vs Baseline)"
                    elif isinstance(v, float) and isinstance(bv, float):
                        line += " (Baseline: 0)"  # analyze_results.py:314
                lines.append(line)
        lines.append("")
    else:
        lines.append("\n--- Final Test Set Performance: No data found ---")

    cvs = {n: r["cv"] for n, r in valid.items()
           if "cv" in r and "average" in r["cv"] and "std_dev" in r["cv"]}
    if cvs:
        lines.append("\n--- Cross-Validation Performance "
                     "(Average ± Std Dev) ---")
        base = cvs.get("baseline", {}).get("average")
        for name, cv in cvs.items():
            lines.append(f"\n* {name.replace('_', ' ').title()}:")
            for key, label in METRIC_KEYS:
                av, sd = cv["average"].get(key, "N/A"), \
                    cv["std_dev"].get(key, "N/A")
                line = (f"  - {label:<20}: {av:.4f} ± {sd:.4f}"
                        if isinstance(av, float) and isinstance(sd, float)
                        else f"  - {label:<20}: {av} ± {sd}")
                if base and name != "baseline" and key in base:
                    bv = base[key]
                    if isinstance(av, float) and isinstance(bv, float) \
                            and bv != 0:
                        line += (f" ({(av - bv) * 100:+.1f} percentage "
                                 "points vs Baseline Avg)")
                    elif isinstance(av, float) and isinstance(bv, float):
                        line += " (Baseline Avg: 0)"  # :341
                lines.append(line)
        lines.append("")
    else:
        lines.append("\n--- Cross-Validation Performance: "
                     "No data found ---")

    report = "\n".join(lines)
    path = os.path.join(analysis_dir, "comparison_report.txt")
    with open(path, "w") as f:
        f.write(report)
    print(f"Saved comparison report to {path}")
    return report


def grey_u8(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 -> (H, W) u8 luma, as PIL's ``convert("L")``:
    (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    c = rgb_u8.astype(np.uint32)
    return ((19595 * c[..., 0] + 38470 * c[..., 1] + 7471 * c[..., 2]
             + 0x8000) >> 16).astype(np.uint8)


def load_rgb(path: str, *, compiled: bool = False) -> np.ndarray:
    """A PNG as PIL's ``Image.open(path).convert("RGB")`` gives it, which
    the JAX analyzer reads (16-bit grey clipped at 255, every other 16-bit
    sample's high byte); ``compiled``: the compiled PNG unfilter (a card
    run)."""
    return decode_png(path, grey16="clip", compiled=compiled)


def _load_grayscale(paths: List[str], size: int, *,
                    compiled: bool = False) -> np.ndarray:
    """Decode -> grey -> resize -> [0, 1] float stack (the reference's
    ssim_transform, analyze_results.py:362-366); the resize is the
    store's, within one u8 level of PIL's BILINEAR."""
    out = []
    for p in paths:
        try:
            img = grey_u8(load_rgb(str(p), compiled=compiled))
        except (OSError, ValueError) as e:
            print(f"Warning: could not load {p}: {e}")
            continue
        out.append(resize_u8(img[..., None], size)[..., 0]
                   .astype(np.float32) / 255.0)
    return np.stack(out) if out else np.zeros((0, size, size), np.float32)


def _train_rows(data_dir: str):
    """(positive ids, negative ids) of the train metadata, in CSV order."""
    ids, labels = rsna.load_train_metadata(
        os.path.join(data_dir, "stage2_train_metadata.csv"))
    return ([i for i, y in zip(ids, labels) if y == 1],
            [i for i, y in zip(ids, labels) if y == 0])


def _sample(rows: list, n: int, seed: int) -> list:
    """pandas' ``DataFrame.sample(n=min(n, len), random_state=seed)``."""
    order = np.random.RandomState(seed).permutation(len(rows))
    return [rows[i] for i in order[:min(n, len(rows))]]


def ssim_picks(data_dir: str, synthetic_dir: str, num_real: int,
               num_synth: int, seed: int = 42):
    """(real paths, synthetic paths) of the SSIM distribution, or None
    after a printed error."""
    if not os.path.exists(os.path.join(data_dir,
                                       "stage2_train_metadata.csv")):
        print("Error: real metadata not found at "
              f"{Path(data_dir) / 'stage2_train_metadata.csv'}")
        return None
    pos, _ = _train_rows(data_dir)
    if not pos:
        print("Error: no positive real images found in metadata.")
        return None
    real_paths = rsna.train_paths(data_dir, _sample(pos, num_real, seed))
    synth_files = sorted(Path(synthetic_dir).glob("*.png"))
    if not synth_files:
        print(f"Error: no synthetic images found in {synthetic_dir}")
        return None
    synth_files = random.Random(seed).sample(
        synth_files, min(num_synth, len(synth_files)))
    return real_paths, [str(p) for p in synth_files]


def calculate_ssim_distribution(data_dir: str, synthetic_dir: str,
                                analysis_dir: str, *,
                                device: torch.device,
                                num_real_samples: int = 100,
                                num_synthetic_samples: int = 500,
                                image_size: int = 224,
                                seed: int = 42) -> Optional[np.ndarray]:
    """All-pairs SSIM on ``device``; the histogram figure
    ssim_distribution.png (reference analyze_results.py:358-445)."""
    from xgan_torch.ops.ssim import mean_ssim_per_synthetic

    print("\n--- Calculating SSIM Distribution ---")
    picks = ssim_picks(data_dir, synthetic_dir, num_real_samples,
                       num_synthetic_samples, seed)
    if picks is None:
        return None
    compiled = device.type == "cuda"
    real = _load_grayscale(picks[0], image_size, compiled=compiled)
    synth = _load_grayscale(picks[1], image_size, compiled=compiled)
    if not len(real) or not len(synth):
        return None
    scores = mean_ssim_per_synthetic(
        torch.from_numpy(synth).to(device),
        torch.from_numpy(real).to(device)).cpu().numpy()

    canvas, _ = plots.chart(
        [plots.histogram(scores, bins=30)],
        title=f"Distribution of Average SSIM (Synthetic vs. {len(real)} "
              f"Real Positives)\nMean: {scores.mean():.3f}, "
              f"Median: {np.median(scores):.3f}",
        xlabel="Average SSIM Score", ylabel="Frequency", legend=False)
    path = os.path.join(analysis_dir, "ssim_distribution.png")
    plots.save_png(canvas, path)
    print(f"Saved SSIM distribution plot to {path}")
    return scores


def eigen_smooth_2d(weighted_hwc: torch.Tensor,
                    n_iter: int = 64) -> torch.Tensor:
    """First-principal-component projection of the weighted activation map
    (pytorch_grad_cam's ``eigen_smooth=True``, reference
    analyze_results.py:550-552), by the JAX package's power iteration:
    the (HW, HW) Gram matrix of the channel-centred (HW, C) map, seeded
    with the centred row sums plus 0.01 of a cosine wave, 64 iterations,
    and the sign that aligns the projection with the channel-sum map.

    weighted_hwc: (H, W, C) float. Returns (H, W) f32."""
    h, w, c = weighted_hwc.shape
    x = weighted_hwc.reshape(h * w, c).float()
    row_sums = x.sum(dim=1)                  # plain Grad-CAM map (flat)
    x = x - x.mean(dim=0, keepdim=True)
    gram = x @ x.T                           # (HW, HW), HW = 49 at 224 px
    # seed inside the column space: a constant vector is in the Gram
    # matrix's null space (x.T @ ones == 0 by the centring)
    seed = x @ torch.ones(c, device=x.device)
    wave = torch.cos(torch.arange(h * w, dtype=torch.float32,
                                  device=x.device))
    u = (seed / (torch.linalg.norm(seed) + 1e-12)
         + 0.01 * wave / (torch.linalg.norm(wave) + 1e-12))
    for _ in range(n_iter):
        v = gram @ u
        u = v / (torch.linalg.norm(v) + 1e-12)
    proj = u * torch.linalg.norm(x.T @ u)    # = x @ v_top, up to sign
    sign = torch.where(torch.dot(proj, row_sums) < 0, -1.0, 1.0)
    return (sign * proj).reshape(h, w)


def grad_cam_resnet(model, image_normed: torch.Tensor, *,
                    eigen_smooth: bool = True, target: str = "conv3"):
    """(pred_label, cam (H', W') in [0, 1] as numpy) for one normalized
    (H, W, 3) image on the model's device.

    ``target="conv3"`` (the reference's, analyze_results.py:466 hooks
    ``model.layer4[-1].conv3``): the activation is that conv's pre-BN
    output, the channel weights the spatial mean of
    d logits[0, pred] / d activation (pytorch_grad_cam's GradCAM).
    ``target="stage_output"``: the layer4 output, whose gradient is
    fc_w[pred] / (H' W') everywhere, so the weighted map is
    fc_w[pred, k] * A_k. ``eigen_smooth`` takes the first principal
    component of the weighted map (the reference's setting) in place of
    the channel sum. Then ReLU and a division by the max, without
    subtracting the min (the reference's normalization)."""
    x = image_normed[None]
    if target == "conv3":
        with torch.enable_grad():
            logits, act, _ = model(x, train=False, cam=True)
            pred = int(logits[0].argmax())
            (grad,) = torch.autograd.grad(logits[0, pred], act)
        act = act[0].detach().permute(1, 2, 0).float()   # (H', W', C)
        weights = grad[0].permute(1, 2, 0).float().mean(dim=(0, 1))
        weighted = act * weights
    elif target == "stage_output":
        with torch.no_grad():
            logits, _, feats = model(x, train=False, cam=True)
        pred = int(logits[0].argmax())
        weighted = feats[0].permute(1, 2, 0).float() \
            * model.fc.weight[pred].detach().float()
    else:
        raise ValueError(f"unknown Grad-CAM target {target!r}")
    with torch.no_grad():
        cam = eigen_smooth_2d(weighted) if eigen_smooth \
            else weighted.sum(dim=-1)
        cam = torch.relu(cam).cpu().numpy()
    if cam.max() > 0:
        cam = cam / cam.max()
    return pred, cam


def gradcam_samples(data_dir: str, synthetic_dir: str, n: int,
                    seed_pos: int = 43, seed_neg: int = 44) -> list:
    """The panels' samples: ``n`` real positives and ``n`` real negatives
    drawn as ``DataFrame.sample`` with seeds 43 and 44, then ``n``
    synthetic files by ``random.Random(43)`` over the sorted PNGs. Each
    is {patientId, path, label, type}."""
    pos, neg = _train_rows(data_dir)
    samples = []
    for rows, seed, label, kind in ((pos, seed_pos, 1, "real_positive"),
                                    (neg, seed_neg, 0, "real_negative")):
        for pid in _sample(rows, n, seed):
            samples.append({"patientId": pid, "label": label, "type": kind,
                            "path": rsna.train_paths(data_dir, [pid])[0]})
    synth_files = sorted(Path(synthetic_dir).glob("*.png"))
    if synth_files:
        for f in random.Random(seed_pos).sample(
                synth_files, min(n, len(synth_files))):
            samples.append({"patientId": f.stem, "path": str(f), "label": 1,
                            "type": "synthetic"})
    return samples


def load_cam_models(model_dir: str, *, device: torch.device,
                    stage_sizes=(3, 4, 6, 3)) -> dict:
    """{run: f32 ResNet50} for every run whose classifier loads, trying
    ``{prefix}resnet50.msgpack`` (a JAX checkpoint) first and then its
    ``.pth`` twin, as the JAX analyzer does: a file that fails to load is
    reported and the next one tried."""
    from xgan_torch.io_.checkpoint import load_classifier_variables
    from xgan_torch.models.resnet import ResNet50

    models = {}
    for prefix in PREFIXES:
        run = prefix[:-1]
        stem = Path(model_dir) / f"{prefix}resnet50"
        candidates = [p for p in (stem.with_suffix(".msgpack"),
                                  stem.with_suffix(".pth")) if p.exists()]
        for path in candidates:
            model = ResNet50(2, stage_sizes=stage_sizes, device=device)
            try:
                load_classifier_variables(str(path), model)
            except (OSError, RuntimeError, ValueError,
                    pickle.UnpicklingError) as e:
                print(f"Warning: failed to load {path}: {e}")
                continue
            models[run] = model.eval()
            print(f"Loaded model: {path}")
            break
        if not candidates:
            print(f"Info: model file not found, skipping Grad-CAM for "
                  f"{run}: {stem.with_suffix('.msgpack')}")
    return models


def generate_grad_cam_comparison(model_dir: str, data_dir: str,
                                 synthetic_dir: str, analysis_dir: str, *,
                                 device: torch.device,
                                 num_samples: int = 3,
                                 image_size: int = 224,
                                 stage_sizes=(3, 4, 6, 3),
                                 seed_pos: int = 43, seed_neg: int = 44):
    """Original and CAM-overlay panels per sample for every available
    ``{prefix}resnet50.pth`` (reference analyze_results.py:448-584):
    gradcam_{type}_{patientId}.png."""
    print("\n--- Generating Grad-CAM Comparison ---")
    models = load_cam_models(model_dir, device=device,
                             stage_sizes=stage_sizes)
    if not models:
        print("Error: no models loaded successfully for Grad-CAM.")
        return
    if not os.path.exists(os.path.join(data_dir,
                                       "stage2_train_metadata.csv")):
        return
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    for sample in gradcam_samples(data_dir, synthetic_dir, num_samples,
                                  seed_pos, seed_neg):
        pid, label, stype = sample["patientId"], sample["label"], \
            sample["type"]
        try:
            rgb_u8 = resize_u8(load_rgb(sample["path"],
                                        compiled=device.type == "cuda"),
                               image_size)
        except (OSError, ValueError) as e:
            print(f"Warning: failed Grad-CAM for {pid} ({stype}): {e}")
            continue
        rgb = rgb_u8.astype(np.float32) / 255.0
        normed = (torch.from_numpy(rgb).to(device) - mean) / std
        panels = [(rgb_u8, f"Original ({stype})\nID: {pid}, Label: {label}")]
        for run, model in models.items():
            pred, cam = grad_cam_resnet(model, normed)
            cam_u8 = resize_u8((cam * 255).astype(np.uint8)[..., None],
                               image_size)[..., 0]
            heat = jet(cam_u8.astype(np.float32) / 255.0)
            overlay = np.clip(0.5 * rgb + 0.5 * heat, 0, 1)
            panels.append((np.round(overlay * 255).astype(np.uint8),
                           f"{run.title()} CAM\nPred: {pred}, True: {label}"))
        plots.save_png(plots.image_row(panels), os.path.join(
            analysis_dir, f"gradcam_{stype}_{pid}.png"))
    print(f"Finished Grad-CAM generation. Images saved in {analysis_dir}")
