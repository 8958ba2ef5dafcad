"""Figures without matplotlib: a small rasterizer on an RGB uint8 canvas
(role of the matplotlib calls in xgan/io_/figures.py,
xgan/io_/figures_classifier.py and xgan/analysis.py; the GPU host has no
matplotlib).

A figure writer describes a chart as data (:class:`Line`, :class:`Bars`;
a horizontal line is a two-point :class:`Line`) and :func:`chart` draws
it in one call: the axes with
linear ticks and tick labels, a grid, the series, a legend box, the title
and the axis labels. :func:`histogram` bins values into bars,
:func:`image_row` lays out image panels under their titles and
:func:`save_png` writes a canvas with the port's PNG encoder. Text is
drawn with the 5x7 bitmap font below (ASCII 32-126 and "±") at an integer
scale. The pixels are not matplotlib's; the series, the axis mapping and
the file names are the JAX package's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from xgan_torch.native.png import encode_png

# matplotlib's default colour cycle ("C0", "C1", ...)
CYCLE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd")
BLACK = (0, 0, 0)
GREY = (128, 128, 128)
WHITE = (255, 255, 255)

# The classic 5x7 font: five column bytes per glyph, bit 0 the top row,
# for the characters 32 (space) to 126 ("~") in order.
_FONT_ASCII = (
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 "
    "3649552250 0005030000 001c224100 0041221c00 082a1c2a08 08083e0808 "
    "0050300000 0808080808 0060600000 2010080402 3e5149453e 00427f4000 "
    "4261514946 2141454b31 1814127f10 2745454539 3c4a494930 0171090503 "
    "3649494936 064949291e 0036360000 0056360000 0814224100 1414141414 "
    "0041221408 0201510906 324979413e 7e1111117e 7f49494936 3e41414122 "
    "7f4141221c 7f49494941 7f09090101 3e41415132 7f0808087f 00417f4100 "
    "2040413f01 7f08142241 7f40404040 7f0204027f 7f0408107f 3e4141413e "
    "7f09090906 3e4151215e 7f09192946 4649494931 01017f0101 3f4040403f "
    "1f2040201f 7f2018207f 6314081463 0304780403 6151494543 007f414100 "
    "0204081020 0041417f00 0402010204 4040404040 0001020400 2054545478 "
    "7f48444438 3844444420 384444487f 3854545418 087e090102 081454543c "
    "7f08040478 00447d4000 2040443d00 007f102844 00417f4000 7c04180478 "
    "7c08040478 3844444438 7c14141408 081414187c 7c08040408 4854545420 "
    "043f444020 3c4040207c 1c2040201c 3c4030403c 4428102844 0c5050503c "
    "4464544c44 0008364100 00007f0000 0041360800 0804081008").split()
FONT = {chr(32 + i): bytes.fromhex(h) for i, h in enumerate(_FONT_ASCII)}
FONT["±"] = bytes.fromhex("44445f4444")
GLYPH_W, GLYPH_H = 5, 7
TEXT_SCALE = 2


@dataclass
class Line:
    """A polyline through (x, y); non-finite points break it. One finite
    point alone is drawn as a dot."""
    x: Sequence[float]
    y: Sequence[float]
    color: str
    style: str = "-"  # "-", "--" or "-."
    alpha: float = 1.0
    width: int = 2
    label: str | None = None


@dataclass
class Bars:
    """Bars of ``width`` (data units) centred at ``x``, from 0 to
    ``height``; a NaN height draws nothing. ``yerr``: error bars with
    caps."""
    x: Sequence[float]
    height: Sequence[float]
    width: float
    color: str
    alpha: float = 1.0
    yerr: Sequence[float] | None = None
    label: str | None = None


@dataclass
class Frame:
    """The plot box on the canvas (pixels, ``right`` and ``bottom``
    inclusive) and the data limits it shows."""
    left: int
    top: int
    right: int
    bottom: int
    xlim: tuple[float, float]
    ylim: tuple[float, float]

    def px(self, x, y):
        """Data (x, y) -> canvas (column, row), as floats."""
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        col = self.left + (np.asarray(x, float) - x0) / (x1 - x0) \
            * (self.right - self.left)
        row = self.bottom - (np.asarray(y, float) - y0) / (y1 - y0) \
            * (self.bottom - self.top)
        return col, row


def rgb(color) -> np.ndarray:
    """"#rrggbb" or an (r, g, b) u8 tuple -> float (3,)."""
    if isinstance(color, str):
        return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], float)
    return np.asarray(color, float)


def _blend(canvas: np.ndarray, mask: np.ndarray, color, alpha: float = 1.0):
    if mask.any():
        px = canvas[mask].astype(float)
        canvas[mask] = np.round((1 - alpha) * px + alpha * rgb(color)) \
            .astype(np.uint8)


# ---- text -----------------------------------------------------------------

def glyph(ch: str) -> np.ndarray:
    """(7, 5) bool bitmap of one character ("?" outside the font)."""
    cols = FONT.get(ch, FONT["?"])
    return np.array([[(c >> r) & 1 for c in cols] for r in range(GLYPH_H)],
                    bool)


def text_mask(line: str, scale: int = TEXT_SCALE) -> np.ndarray:
    """Bool bitmap of one line of text: glyphs one column apart."""
    out = np.zeros((GLYPH_H, max(1, len(line) * (GLYPH_W + 1) - 1)), bool)
    for i, ch in enumerate(line):
        out[:, i * (GLYPH_W + 1):i * (GLYPH_W + 1) + GLYPH_W] = glyph(ch)
    return np.kron(out, np.ones((scale, scale), bool))


def text_size(text: str, scale: int = TEXT_SCALE) -> tuple[int, int]:
    """(width, height) in pixels of possibly multi-line text."""
    lines = text.split("\n")
    return (max(text_mask(s, scale).shape[1] for s in lines),
            len(lines) * (GLYPH_H + 3) * scale - 3 * scale)


def draw_text(canvas: np.ndarray, text: str, x: float, y: float, *,
              ha: str = "center", va: str = "top", color=BLACK,
              scale: int = TEXT_SCALE, rotate: bool = False) -> None:
    """Draw ``text`` (lines split at "\\n", each aligned by ``ha``) with
    its box anchored at canvas (x, y): ``ha`` in left/center/right,
    ``va`` in top/center/bottom. ``rotate`` turns it a quarter left
    (a y-axis label). Clipped to the canvas."""
    lines = [text_mask(s, scale) for s in text.split("\n")]
    w = max(m.shape[1] for m in lines)
    block = np.zeros((len(lines) * (GLYPH_H + 3) * scale - 3 * scale, w),
                     bool)
    for i, m in enumerate(lines):
        off = {"left": 0, "center": (w - m.shape[1]) // 2,
               "right": w - m.shape[1]}[ha]
        r = i * (GLYPH_H + 3) * scale
        block[r:r + m.shape[0], off:off + m.shape[1]] = m
    if rotate:
        block = np.rot90(block)
    h, w = block.shape
    c0 = int(round(x - {"left": 0, "center": w / 2, "right": w}[ha]))
    r0 = int(round(y - {"top": 0, "center": h / 2, "bottom": h}[va]))
    H, W = canvas.shape[:2]
    rs, cs = max(0, -r0), max(0, -c0)
    re, ce = min(h, H - r0), min(w, W - c0)
    if re <= rs or ce <= cs:
        return
    mask = np.zeros((H, W), bool)
    mask[r0 + rs:r0 + re, c0 + cs:c0 + ce] = block[rs:re, cs:ce]
    _blend(canvas, mask, color)


# ---- lines and rectangles -------------------------------------------------

# (on, off, on, off, ...) lengths of each style, in units of line width
_DASHES = {"-": None, "--": (4, 2.5), "-.": (4, 1.5, 1, 1.5)}


def _dash_on(dist: np.ndarray, style: str, width: int) -> np.ndarray:
    pattern = _DASHES[style]
    if pattern is None:
        return np.ones(dist.shape, bool)
    edges = np.cumsum(pattern) * max(width, 2)
    phase = dist % edges[-1]
    return (np.searchsorted(edges, phase, side="right") % 2) == 0


def line_mask(shape, cols, rows, *, style: str = "-", width: int = 1,
              box: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """Bool mask of the polyline through the canvas points (cols, rows):
    each segment sampled once per pixel of its longer side, the dash
    pattern laid along the arc length, each sample a ``width``-pixel
    square. ``box`` (left, top, right, bottom) clips it."""
    pts = np.stack([np.asarray(cols, float), np.asarray(rows, float)], -1)
    pts = pts.reshape(-1, 2)
    mask = np.zeros(shape[:2], bool)
    finite = np.isfinite(pts).all(1)
    if finite.sum() == 1:  # a lone point: a dot
        xy, keep = pts[finite], np.ones(1, bool)
    elif len(pts) >= 2:
        p0, p1 = pts[:-1], pts[1:]
        ok = finite[:-1] & finite[1:]
        seg = np.where(ok[:, None], p1 - p0, 0.0)
        length = np.hypot(seg[:, 0], seg[:, 1])
        start = np.concatenate([[0.0], np.cumsum(length)[:-1]])
        n = np.where(ok, np.ceil(np.abs(seg).max(1)).astype(int) + 1, 0)
        sid = np.repeat(np.arange(len(n)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) \
            / np.maximum(np.repeat(n - 1, n), 1)
        xy = np.where(ok[:, None], p0, 0.0)[sid] + t[:, None] * seg[sid]
        keep = _dash_on(start[sid] + t * length[sid], style, width)
    else:
        return mask
    xy = np.round(xy[keep]).astype(int)
    left, top, right, bottom = box or (0, 0, shape[1] - 1, shape[0] - 1)
    for dy in range(-((width - 1) // 2), width // 2 + 1):
        for dx in range(-((width - 1) // 2), width // 2 + 1):
            c, r = xy[:, 0] + dx, xy[:, 1] + dy
            inside = (c >= left) & (c <= right) & (r >= top) & (r <= bottom)
            mask[r[inside], c[inside]] = True
    return mask


def rect_mask(shape, c0: float, r0: float, c1: float, r1: float,
              box: tuple[int, int, int, int]) -> np.ndarray:
    """Bool mask of the pixel rectangle between two canvas corners,
    clipped to ``box``."""
    left, top, right, bottom = box
    ca, cb = sorted((c0, c1))
    ra, rb = sorted((r0, r1))
    ca, ra = max(left, int(round(ca))), max(top, int(round(ra)))
    cb, rb = min(right, int(round(cb))), min(bottom, int(round(rb)))
    mask = np.zeros(shape[:2], bool)
    if cb >= ca and rb >= ra:
        mask[ra:rb + 1, ca:cb + 1] = True
    return mask


# ---- axes -----------------------------------------------------------------

def nice_ticks(lo: float, hi: float, target: int = 6) -> np.ndarray:
    """Ticks at a step of 1, 2, 2.5 or 5 times a power of ten, about
    ``target`` of them, inside [lo, hi]."""
    raw = (hi - lo) / target
    mag = 10.0 ** math.floor(math.log10(raw))
    step = mag * next(m for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    ticks = first + step * np.arange(int((hi - first) / step + 1e-9) + 1)
    return np.round(ticks, 12)


def tick_label(v: float, ticks: np.ndarray) -> str:
    """``v`` with as many decimals as the tick step needs."""
    step = float(np.min(np.diff(ticks))) if len(ticks) > 1 else 1.0
    decimals = 0
    while decimals < 8 and abs(round(step, decimals) - step) > 1e-9 * step:
        decimals += 1
    return f"{v:.{decimals}f}"


def _limits(series) -> tuple[tuple[float, float], tuple[float, float], bool]:
    xs, ys, bars = [], [], False
    for s in series:
        if isinstance(s, Line):
            x, y = np.asarray(s.x, float), np.asarray(s.y, float)
            ok = np.isfinite(x) & np.isfinite(y)
            xs += list(x[ok])
            ys += list(y[ok])
        else:
            bars = True
            h = np.asarray(s.height, float)
            e = np.zeros_like(h) if s.yerr is None else np.asarray(s.yerr,
                                                                  float)
            x = np.asarray(s.x, float)
            xs += list(x - s.width / 2) + list(x + s.width / 2)
            ok = np.isfinite(h)
            ys += [0.0] + list((h + e)[ok]) + list((h - e)[ok])
    xs =[v for v in xs if math.isfinite(v)] or [0.0, 1.0]
    ys = [v for v in ys if math.isfinite(v)] or [0.0, 1.0]
    return (min(xs), max(xs)), (min(ys), max(ys)), bars


def _pad(lo: float, hi: float) -> tuple[float, float]:
    """matplotlib's 5 % margins; a flat range gets a unit-sized one."""
    span = hi - lo
    if span <= 0:
        span = abs(lo) or 1.0
        return lo - 0.5 * span, hi + 0.5 * span
    return lo - 0.05 * span, hi + 0.05 * span


def _legend(canvas, frame: Frame, series) -> None:
    entries = [s for s in series if s.label]
    if not entries:
        return
    s = TEXT_SCALE
    row_h, sample_w = (GLYPH_H + 4) * s, 36
    w = max(text_size(e.label)[0] for e in entries) + sample_w + 30
    h = len(entries) * row_h + 10
    c1, r0 = frame.right - 10, frame.top + 10
    c0, r1 = c1 - w, r0 + h
    box = (0, 0, canvas.shape[1] - 1, canvas.shape[0] - 1)
    _blend(canvas, rect_mask(canvas.shape, c0, r0, c1, r1, box), WHITE, 0.8)
    _blend(canvas, line_mask(canvas.shape, [c0, c1, c1, c0, c0],
                             [r0, r0, r1, r1, r0]), (204, 204, 204))
    for i, e in enumerate(entries):
        mid = r0 + 5 + i * row_h + row_h / 2
        if isinstance(e, Bars):
            _blend(canvas, rect_mask(canvas.shape, c0 + 10, mid - 5 * s,
                                     c0 + 10 + sample_w, mid + 4 * s, box),
                   e.color, e.alpha)
        else:
            _blend(canvas, line_mask(canvas.shape,
                                     [c0 + 10, c0 + 10 + sample_w],
                                     [mid, mid], style=e.style,
                                     width=e.width),
                   e.color, e.alpha)
        draw_text(canvas, e.label, c0 + sample_w + 20, mid, ha="left",
                  va="center")


def chart(series, *, title: str = "", xlabel: str = "", ylabel: str = "",
          size: tuple[int, int] = (1000, 600), xticks=None, ylim=None,
          grid: str = "both", grid_style: str = "-", legend: bool = True):
    """Draw the series on white axes; returns (canvas, frame).

    ``xticks``: (positions, labels) in place of automatic ticks; ``ylim``
    fixes the y range; ``grid`` is "both", "y" or "" (none)."""
    W, H = size
    canvas = np.full((H, W, 3), 255, np.uint8)
    (x0, x1), (y0, y1), bars = _limits(series)
    xlim = _pad(x0, x1)
    if ylim is None:
        ylim = _pad(y0, y1)
        if bars and y0 >= 0:  # bars stand on the axis, as in matplotlib
            ylim = (0.0, ylim[1])
    ylim = tuple(float(v) for v in ylim)
    yt = nice_ticks(*ylim)
    ylabels = [tick_label(v, yt) for v in yt]
    if xticks is None:
        xt = nice_ticks(*xlim)
        xlabels = [tick_label(v, xt) for v in xt]
    else:
        xt, xlabels = np.asarray(xticks[0], float), list(xticks[1])

    s = TEXT_SCALE
    line_h = (GLYPH_H + 3) * s
    left = 20 + (line_h if ylabel else 0) \
        + max(text_size(t)[0] for t in ylabels) + 10
    top = 20 + (text_size(title)[1] + 10 if title else 0)
    bottom = H - (20 + line_h + (line_h + 6 if xlabel else 0))
    frame = Frame(left, top, W - 30, bottom, xlim, ylim)
    box = (frame.left, frame.top, frame.right, frame.bottom)

    if grid:
        for v in yt:
            _, r = frame.px(xlim[0], v)
            _blend(canvas, line_mask(canvas.shape, [frame.left, frame.right],
                                     [r, r], style=grid_style, box=box),
                   GREY, 0.3)
        if grid == "both":
            for v in xt:
                c, _ = frame.px(v, ylim[0])
                _blend(canvas, line_mask(canvas.shape, [c, c],
                                         [frame.top, frame.bottom],
                                         style=grid_style, box=box),
                       GREY, 0.3)

    for sr in series:
        if isinstance(sr, Line):
            c, r = frame.px(sr.x, sr.y)
            _blend(canvas, line_mask(canvas.shape, c, r, style=sr.style,
                                     width=sr.width, box=box),
                   sr.color, sr.alpha)
        else:
            errs = sr.yerr if sr.yerr is not None else [None] * len(sr.x)
            for x, h, e in zip(sr.x, sr.height, errs):
                if not math.isfinite(h):
                    continue
                ca, ra = frame.px(x - sr.width / 2, 0.0)
                cb, rb = frame.px(x + sr.width / 2, h)
                _blend(canvas, rect_mask(canvas.shape, ca, ra, cb - 1, rb,
                                         box), sr.color, sr.alpha)
                if e:
                    c, (rlo, rhi) = frame.px(x, [h - e, h + e])
                    c = float(c)
                    err = line_mask(canvas.shape, [c, c], [rlo, rhi],
                                    width=2, box=box)
                    for rr in (rlo, rhi):
                        err |= line_mask(canvas.shape, [c - 6, c + 6],
                                         [rr, rr], width=2, box=box)
                    _blend(canvas, err, BLACK)

    # frame, ticks and their labels
    _blend(canvas, line_mask(canvas.shape,
                             [frame.left, frame.right, frame.right,
                              frame.left, frame.left],
                             [frame.top, frame.top, frame.bottom,
                              frame.bottom, frame.top]), BLACK)
    for v, lab in zip(yt, ylabels):
        _, r = frame.px(xlim[0], v)
        _blend(canvas, line_mask(canvas.shape, [frame.left - 5, frame.left],
                                 [r, r]), BLACK)
        draw_text(canvas, lab, frame.left - 8, r, ha="right", va="center")
    for v, lab in zip(xt, xlabels):
        c, _ = frame.px(v, ylim[0])
        if frame.left - 0.5 <= c <= frame.right + 0.5:
            _blend(canvas, line_mask(canvas.shape, [c, c],
                                     [frame.bottom, frame.bottom + 5]),
                   BLACK)
            draw_text(canvas, lab, c, frame.bottom + 8)
    if title:
        draw_text(canvas, title, (frame.left + frame.right) / 2, 15)
    if xlabel:
        draw_text(canvas, xlabel, (frame.left + frame.right) / 2,
                  H - 15, va="bottom")
    if ylabel:
        draw_text(canvas, ylabel, 15, (frame.top + frame.bottom) / 2,
                  ha="left", va="center", rotate=True)
    if legend:
        _legend(canvas, frame, series)
    return canvas, frame


def histogram(values, bins: int = 30, color: str = CYCLE[0],
              alpha: float = 0.8) -> Bars:
    """``bins`` equal bins over the range of ``values`` (numpy's
    ``histogram``, as matplotlib's ``hist``), as bars of counts."""
    counts, edges = np.histogram(np.asarray(values, float), bins=bins)
    return Bars((edges[:-1] + edges[1:]) / 2, counts.astype(float),
                float(edges[1] - edges[0]), color, alpha)


def image_row(panels, *, min_side: int = 224, gap: int = 20) -> np.ndarray:
    """One row of (image (H, W, 3) u8, title) panels, each image scaled up
    by the integer factor that brings its shorter side to ``min_side``,
    its title centred above it; a panel is as wide as the wider of the
    two."""
    scaled = []
    for img, title in panels:
        f = max(1, math.ceil(min_side / min(img.shape[:2])))
        im = np.repeat(np.repeat(img, f, 0), f, 1)
        scaled.append((im, title, max(im.shape[1], text_size(title)[0])))
    title_h = max(text_size(t)[1] for _, t, _ in scaled)
    H = gap + title_h + 10 + max(im.shape[0] for im, _, _ in scaled) + gap
    W = gap + sum(w + gap for _, _, w in scaled)
    canvas = np.full((H, W, 3), 255, np.uint8)
    c = gap
    for im, title, w in scaled:
        draw_text(canvas, title, c + w / 2, gap)
        r, c0 = gap + title_h + 10, c + (w - im.shape[1]) // 2
        canvas[r:r + im.shape[0], c0:c0 + im.shape[1]] = im
        c += w + gap
    return canvas


def save_png(canvas: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(canvas))
