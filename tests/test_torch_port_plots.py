"""xgan_torch's matplotlib-free figures (``xgan_torch.io_.plots`` and the
writers on it) on the CPU.

- A known line series and a bar series put their pixels where the axis
  mapping says; the dash styles leave gaps where the solid style has
  none; every glyph of the bitmap font renders, each one differently.
- For the same histories and CV summaries, the port's GAN and classifier
  writers produce the same set of file names as
  ``xgan.io_.figures.plot_gan_losses`` and
  ``xgan.io_.figures_classifier.generate_plots`` (single run, CV, ragged
  folds, no ratios, no finite fold loss), and every figure decodes with
  the port's PNG decoder.
"""
import os

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from xgan.io_ import figures as jax_figures
from xgan.io_ import figures_classifier as jax_figures_classifier
from xgan_torch.io_ import figures, figures_classifier, plots
from xgan_torch.native.png import decode_png

torch.set_num_threads(1)

RED, BLUE = "#ff0000", "#0000ff"


def _at(canvas, frame, x, y):
    c, r = frame.px(x, y)
    return tuple(canvas[int(round(float(r))), int(round(float(c)))])


def test_line_pixels_follow_the_axis_mapping():
    x = np.arange(0, 11)
    canvas, frame = plots.chart([plots.Line(x, 0.5 * x, RED, width=3)],
                                grid="", legend=False, size=(600, 400))
    assert frame.xlim[0] < 0 < 10 < frame.xlim[1]
    assert frame.ylim[0] < 0 < 5 < frame.ylim[1]
    # every point of the series, and points between them, on the line
    for xv in np.linspace(0, 10, 41):
        assert _at(canvas, frame, xv, 0.5 * xv) == (255, 0, 0), xv
    # off the line: the white plot area
    assert _at(canvas, frame, 2, 4) == (255, 255, 255)
    assert _at(canvas, frame, 8, 1) == (255, 255, 255)
    # the mapping is linear and the y axis points up
    c0, r0 = frame.px(0, 0)
    c1, r1 = frame.px(10, 5)
    assert c1 - c0 > 0 and r1 - r0 < 0
    cm, rm = frame.px(5, 2.5)
    assert abs(cm - (c0 + c1) / 2) < 1e-9 and abs(rm - (r0 + r1) / 2) < 1e-9


def test_bar_pixels_follow_the_axis_mapping():
    bars = plots.Bars([0, 1, 2], [1.0, 2.0, np.nan], 0.5, BLUE,
                      yerr=[0.2, 0.0, 0.0])
    hline = plots.Line([-0.5, 2.5], [1.5, 1.5], RED)
    canvas, frame = plots.chart([bars, hline], grid="", legend=False,
                                xticks=([0, 1, 2], ["a", "b", "c"]),
                                ylim=(0, 3), size=(600, 400))
    assert frame.ylim == (0.0, 3.0)
    for x, h in ((0, 1.0), (1, 2.0)):
        for y in (0.1, h / 2, h - 0.1):  # beside the error bar
            assert _at(canvas, frame, x - 0.1, y) == (0, 0, 255), (x, y)
        assert _at(canvas, frame, x + 0.15, h + 0.1) == (255, 255, 255)
        assert _at(canvas, frame, x + 0.35, h / 2) == (255, 255, 255)
    assert _at(canvas, frame, 2, 0.5) == (255, 255, 255)  # NaN: no bar
    assert _at(canvas, frame, 0, 1.1) == (0, 0, 0)  # the error bar
    assert _at(canvas, frame, 0, 1.2) == (0, 0, 0)  # its cap
    assert _at(canvas, frame, 2, 1.5) == (255, 0, 0)  # the line
    assert _at(canvas, frame, 0.5, 1.5) == (255, 0, 0)


@pytest.mark.parametrize("style,gaps", [("-", False), ("--", True),
                                        ("-.", True)])
def test_line_styles_and_alpha(style, gaps):
    mask = plots.line_mask((20, 200), [0, 199], [10, 10], style=style,
                           width=2)
    row = mask[10]
    assert row[0] and (not row.all()) == gaps
    canvas = np.full((20, 200, 3), 255, np.uint8)
    plots._blend(canvas, mask, BLUE, 0.3)
    assert tuple(canvas[10, 0]) == (178, 178, 255)


def test_every_glyph_renders():
    chars = [chr(c) for c in range(32, 127)] + ["±"]
    bitmaps = [plots.glyph(ch) for ch in chars]
    assert all(b.shape == (7, 5) for b in bitmaps)
    assert not bitmaps[0].any()  # space
    assert all(b.any() for b in bitmaps[1:]), \
        [ch for ch, b in zip(chars, bitmaps) if not b.any()][1:]
    assert len({b.tobytes() for b in bitmaps}) == len(chars)
    mask = plots.text_mask("".join(chars[1:]), scale=2)
    assert mask.shape == (14, 2 * (95 * 6 - 1))
    canvas = np.full((40, 1200, 3), 255, np.uint8)
    plots.draw_text(canvas, "Fold 1\nAvg ± 0.5", 600, 5)
    assert (canvas == 0).any()


def test_nice_ticks_and_labels():
    t = plots.nice_ticks(-0.03, 1.08)
    np.testing.assert_allclose(t, [0, 0.2, 0.4, 0.6, 0.8, 1.0])
    assert [plots.tick_label(v, t) for v in t[:2]] == ["0.0", "0.2"]
    t = plots.nice_ticks(0.0, 10450.0)
    assert t[0] == 0 and t[-1] <= 10450 and len(t) in range(4, 9)
    assert plots.tick_label(2000.0, t) == "2000"
    t = plots.nice_ticks(0.9, 1.6)
    assert plots.tick_label(t[1], t).count(".") == 1


def _history(n, ratio=0.25, ratios=True):
    h = {"epoch": list(range(1, n + 1)),
         "train_loss": list(np.linspace(0.7, 0.3, n)),
         "train_acc": list(np.linspace(0.5, 0.8, n)),
         "val_loss": list(np.linspace(0.8, 0.4, n)),
         "val_acc": list(np.linspace(0.5, 0.7, n))}
    if ratios:
        h["synthetic_ratio"] = [ratio] * n
    return h


def _cv(folds, loss=True):
    keys = ["accuracy", "weighted_precision", "weighted_recall",
            "weighted_f1_score"] + (["loss"] if loss else [])
    rng = np.random.default_rng(folds)
    fold_m = [{k: float(rng.random()) for k in keys} for _ in range(folds)]
    if not loss:
        for m in fold_m:
            m["loss"] = float("nan")
    return {"folds": fold_m,
            "average": {k: float(np.mean([m[k] for m in fold_m]))
                        for k in keys},
            "std_dev": {k: 0.01 for k in keys}}


CASES = {
    "single": ([_history(3)], None),
    "single_one_epoch": ([_history(1, ratio=1.0)], None),
    "cv": ([_history(3), _history(3)], _cv(2)),
    "cv_ragged": ([_history(4), _history(2), _history(3)], _cv(3)),
    "cv_no_ratios": ([_history(2, ratios=False)] * 2, _cv(2)),
    "cv_no_finite_loss": ([_history(2)] * 2, _cv(2, loss=False)),
    "cv_no_folds": ([_history(2)], {"folds": [], "average": {}}),
    "empty_history": ([{}], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_classifier_figures_match_jax(case, tmp_path, monkeypatch):
    # matplotlib renders at 300 dpi; only its file names are compared
    monkeypatch.setattr(plt, "savefig", lambda path, **_: open(
        path, "wb").close())
    histories, cv = CASES[case]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    figures_classifier.generate_plots(histories, str(ours), "curriculum_",
                                      cv_results=cv)
    jax_figures_classifier.generate_plots(histories, str(theirs),
                                          "curriculum_", cv_results=cv)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    for name in names:
        img = decode_png(str(ours / name))
        assert img.shape[2] == 3 and img.std() > 0
    if case == "cv_ragged":
        assert len(names) == 5


@pytest.mark.parametrize("missing", [None, "D_losses_iter"])
def test_gan_figure_matches_jax(missing, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(plt, "savefig", lambda path, **_: open(
        path, "wb").close())
    rng = np.random.default_rng(0)
    history = {"G_losses_iter": list(rng.random(300) + 1),
               "D_losses_iter": list(rng.random(300))}
    if missing:
        history[missing] = []
    for name, mod in (("port", figures), ("jax", jax_figures)):
        (tmp_path / name).mkdir()
        mod.plot_gan_losses(history, str(tmp_path / name / "gan_loss_curve"
                                                           ".png"))
    ours = sorted(os.listdir(tmp_path / "port"))
    assert ours == sorted(os.listdir(tmp_path / "jax"))
    assert ours == ([] if missing else ["gan_loss_curve.png"])
    out = capsys.readouterr().out
    assert out.count("loss data missing") == (2 if missing else 0)
    if not missing:
        img = decode_png(str(tmp_path / "port" / "gan_loss_curve.png"))
        assert img.shape == (600, 1200, 3)
        # both series drawn: the two default colours, blended at alpha 0.8
        for color in plots.CYCLE[:2]:
            want = np.round(0.2 * 255 + 0.8 * plots.rgb(color))
            assert (np.abs(img.astype(int) - want).max(-1) <= 1).any()


def test_image_row_and_histogram():
    img = np.random.default_rng(1).integers(0, 255, (32, 32, 3), np.uint8)
    row = plots.image_row([(img, "Original (synthetic)\nID: x, Label: 1"),
                           (img, "A CAM")], min_side=64)
    assert row.shape[0] > 64 and row.shape[1] > 2 * 64
    # the images are scaled up by 2 and pasted whole
    up = np.repeat(np.repeat(img, 2, 0), 2, 1)
    hits = [(r, c) for r in range(row.shape[0] - 63)
            for c in range(row.shape[1] - 63)
            if (row[r, c] == up[0, 0]).all()
            and (row[r:r + 64, c:c + 64] == up).all()]
    assert len(hits) == 2
    bars = plots.histogram([0.1, 0.2, 0.2, 0.9], bins=4)
    assert list(bars.height) == [3.0, 0.0, 0.0, 1.0]
    assert bars.width == pytest.approx(0.2)
