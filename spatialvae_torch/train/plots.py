"""Training-curve plots (ELBO, KL divergence, BCE loss; training against
validation), as SVG — counterpart of ``spatialvae_tpu/train/plots.py``.

The same three files (``ELBO.svg``, ``KL_Divergence.svg``,
``BCE_Loss.svg``) with the same series (each against its index, as
``plt.plot(series)`` draws it), title, axis labels ("Epoch" below), grid
and legend ("Training" blue, "Validation" green), written as SVG text by
this module alone, so the port needs no matplotlib.  The legend goes where
``legend_location`` (the JAX package's slope heuristic, copied exactly)
puts it.  Each curve carries its values in a ``data-values`` attribute
(``repr`` of each float), and the legend its quadrant in ``data-loc``, so
a reader can check the figure without rasterising it.
"""

from __future__ import annotations

import math
import os
from xml.sax.saxutils import escape, quoteattr

import numpy as np

# result-row column indices (epoch, ELBO, BCE, KL)
COL_EPOCH, COL_ELBO, COL_BCE, COL_KL = 0, 1, 2, 3

# the figure of matplotlib's defaults: 6.4 x 4.8 in at 72 pt, the axes
# between 12.5% and 90% of the width and 11% and 88% of the height
WIDTH, HEIGHT = 460.8, 345.6
AXES = (0.125 * WIDTH, (1 - 0.88) * HEIGHT, 0.9 * WIDTH, (1 - 0.11) * HEIGHT)
SERIES = (("Training", "#0000ff"), ("Validation", "#008000"))
MARGIN = 0.05            # data margins, a share of each axis's span
LEGEND_PAD = 8.0         # the legend box's distance from the axes' frame
FONT = 10.0


def legend_location(series: np.ndarray) -> str:
    series = np.asarray(series, dtype=float)[2:]
    half = math.ceil(len(series) / 2.0)
    if half <= 1:
        return "upper center"
    y1 = series[:half]
    y2 = series[-half:]
    x = np.arange(half, dtype=float)
    denom = len(x) * np.sum(x * x) - np.sum(x) ** 2
    m1 = (len(x) * np.sum(x * y1) - np.sum(x) * np.sum(y1)) / denom
    m2 = (len(x) * np.sum(x * y2) - np.sum(x) * np.sum(y2)) / denom
    vertical = "upper" if m1 < m2 else "lower"
    horizontal = "right" if abs(m1) > abs(m2) else "left"
    return f"{vertical} {horizontal}"


def _limits(values) -> tuple:
    """(lo, hi) of the finite values with MARGIN on each side; a single
    value (or none) gets a unit-wide window around it."""
    finite = [v for v in values if math.isfinite(v)]
    if not finite:
        return -1.0, 1.0
    lo, hi = min(finite), max(finite)
    if hi == lo:
        half = max(abs(lo) * MARGIN, 0.5)
        return lo - half, hi + half
    pad = (hi - lo) * MARGIN
    return lo - pad, hi + pad


def _ticks(lo: float, hi: float, target: int = 6) -> list:
    """Round tick values inside [lo, hi]: steps of 1, 2, 2.5 or 5 times a
    power of ten, about ``target`` of them."""
    raw = (hi - lo) / target
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(k * mag for k in (1, 2, 2.5, 5, 10) if k * mag >= raw)
    first = math.ceil(lo / step)
    digits = max(0, -math.floor(math.log10(step)) + 1)
    out = []
    k = first
    while k * step <= hi + 1e-9 * step:
        out.append(round(k * step, digits))
        k += 1
    return out


def _label(v: float) -> str:
    return f"{v:g}" if v != 0 else "0"


def _segments(ys) -> list:
    """The runs of consecutive finite points as [(x, y), ...] lists (a
    non-finite value breaks the line, as in matplotlib)."""
    runs, cur = [], []
    for i, y in enumerate(ys):
        if math.isfinite(y):
            cur.append((i, y))
        elif cur:
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    return runs


def _legend_box(loc: str, width: float, height: float) -> tuple:
    """(x, y) of the legend box's top-left corner for ``loc`` inside the
    axes."""
    x0, y0, x1, y1 = AXES
    vertical, horizontal = loc.split()
    x = {"left": x0 + LEGEND_PAD, "right": x1 - LEGEND_PAD - width,
         "center": (x0 + x1 - width) / 2}[horizontal]
    y = (y0 + LEGEND_PAD if vertical == "upper"
         else y1 - LEGEND_PAD - height)
    return x, y


def plot_svg(title: str, y_label: str, train_data, val_data) -> str:
    """The SVG text of one figure."""
    data = [[float(v) for v in np.asarray(s, dtype=float).ravel()]
            for s in (train_data, val_data)]
    x0, y0, x1, y1 = AXES
    n = max(len(d) for d in data)
    xlo, xhi = _limits(range(n))
    ylo, yhi = _limits(data[0] + data[1])

    def px(x):
        return x0 + (x - xlo) / (xhi - xlo) * (x1 - x0)

    def py(y):
        return y1 - (y - ylo) / (yhi - ylo) * (y1 - y0)

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}pt" '
           f'height="{HEIGHT}pt" viewBox="0 0 {WIDTH} {HEIGHT}" '
           f'font-family="sans-serif" font-size="{FONT}">',
           f'<title>{escape(title)}</title>',
           f'<rect width="{WIDTH}" height="{HEIGHT}" fill="#ffffff"/>',
           '<g id="grid" stroke="#b0b0b0" stroke-width="0.8">']
    xticks = [t for t in _ticks(xlo, xhi) if float(t).is_integer()] or [0]
    yticks = _ticks(ylo, yhi)
    out += [f'<line x1="{px(t):.3f}" y1="{y0:.3f}" x2="{px(t):.3f}" '
            f'y2="{y1:.3f}"/>' for t in xticks]
    out += [f'<line x1="{x0:.3f}" y1="{py(t):.3f}" x2="{x1:.3f}" '
            f'y2="{py(t):.3f}"/>' for t in yticks]
    out.append('</g>')
    out.append('<g id="tick-labels">')
    out += [f'<text x="{px(t):.3f}" y="{y1 + 14:.3f}" '
            f'text-anchor="middle">{_label(t)}</text>' for t in xticks]
    out += [f'<text x="{x0 - 4:.3f}" y="{py(t) + 3.5:.3f}" '
            f'text-anchor="end">{_label(t)}</text>' for t in yticks]
    out.append('</g>')
    for (label, color), ys in zip(SERIES, data):
        values = " ".join(repr(v) for v in ys)
        out.append(f'<g id="series-{label}" data-label={quoteattr(label)} '
                   f'data-values={quoteattr(values)}>')
        for run in _segments(ys):
            pts = " ".join(f"{px(x):.3f},{py(y):.3f}" for x, y in run)
            out.append(f'<polyline points="{pts}" fill="none" '
                       f'stroke="{color}" stroke-width="1.5"/>')
        out.append('</g>')
    out.append(f'<rect id="frame" x="{x0:.3f}" y="{y0:.3f}" '
               f'width="{x1 - x0:.3f}" height="{y1 - y0:.3f}" fill="none" '
               f'stroke="#000000" stroke-width="0.8"/>')
    out.append(f'<text id="title" x="{(x0 + x1) / 2:.3f}" y="{y0 - 6:.3f}" '
               f'text-anchor="middle" font-size="12">{escape(title)}</text>')
    out.append(f'<text id="xlabel" x="{(x0 + x1) / 2:.3f}" '
               f'y="{y1 + 30:.3f}" text-anchor="middle">Epoch</text>')
    out.append(f'<text id="ylabel" transform="translate({x0 - 44:.3f} '
               f'{(y0 + y1) / 2:.3f}) rotate(-90)" '
               f'text-anchor="middle">{escape(y_label)}</text>')
    loc = legend_location(data[0])
    lw, lh = 96.0, 8.0 + 16.0 * len(SERIES)
    lx, ly = _legend_box(loc, lw, lh)
    out.append(f'<g id="legend" data-loc="{loc}" '
               f'transform="translate({lx:.3f} {ly:.3f})">')
    out.append(f'<rect width="{lw}" height="{lh}" fill="#ffffff" '
               f'fill-opacity="0.8" stroke="#cccccc"/>')
    for i, (label, color) in enumerate(SERIES):
        yy = 12.0 + 16.0 * i
        out.append(f'<line x1="6" y1="{yy}" x2="34" y2="{yy}" '
                   f'stroke="{color}" stroke-width="1.5"/>')
        out.append(f'<text x="40" y="{yy + 3.5}">{escape(label)}</text>')
    out.append('</g>')
    out.append('</svg>')
    return "\n".join(out) + "\n"


def _plot_one(title: str, y_label: str, train_data, val_data,
              output_dir: str) -> None:
    path = os.path.join(output_dir, title.replace(" ", "_") + ".svg")
    with open(path, "w", encoding="utf-8") as f:
        f.write(plot_svg(title, y_label, train_data, val_data))


def basic_run_plot(train_results, val_results, output_dir: str) -> None:
    train = np.asarray(train_results, dtype=float)
    val = np.asarray(val_results, dtype=float)
    _plot_one("ELBO", "ELBO", train[:, COL_ELBO], val[:, COL_ELBO], output_dir)
    _plot_one("KL Divergence", "KL Divergence", train[:, COL_KL],
              val[:, COL_KL], output_dir)
    _plot_one("BCE Loss", "BCE Loss", train[:, COL_BCE], val[:, COL_BCE],
              output_dir)
