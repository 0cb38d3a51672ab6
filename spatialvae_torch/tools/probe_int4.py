"""Probe: the 4-bit GEMMs of the loss kernel's gradient on the card, and
what each contraction layout costs -- the port of ``tools/probe_int4.py``.

    python -m spatialvae_torch.tools.probe_int4 [pt=2048] [iters=30] [device=cpu]

Runs the TPU tool's fourteen runs at its sizes (B=2048, HW=4096, H=500):
one (pt, H) x (H, H) product per grid step, B * HW / pt steps, in each
contraction pattern (``gemm-*``, ``dw1T``/``da0T``/``fwdT`` feature-major,
``tdw1-pre`` from a pre-transposed operand, ``tdw1-tr`` with the transpose
in the kernel), the feature-major first layer (``buildT-vpu``) and the
transpose alone (``tr-only-i8``), through the hand-written kernels of
``spatialvae_torch/kernels/probes.py``.  A run the TPU tool casts to int4
runs the s8 arm (int8 mma.sync on its values in [-7, 7], the port of every
4-bit mode) and once more the s4 arm (the name with ``:s4``: the operands
packed two per byte, mma.sync m16n8k64 s4).  Each prints one line: its
ms per call (CUDA events over ``iters`` calls after a warm-up; the host
clock with ``device=cpu``), the TPU tool's images per second (B per call)
and its bound on the card.  Without a card and without ``device=cpu`` it
raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spatialvae_torch.kernels import probes
from spatialvae_torch.tools.common import (
    Run,
    backend,
    int_mm_call,
    parse_argv,
    time_ms,
)

B, HW, H = 2048, 4096, 500
USAGE = ("python -m spatialvae_torch.tools.probe_int4 [pt=2048] [iters=30] "
         "[device=cpu]")
D10, D11, D00 = ((1,), (0,)), ((1,), (1,)), ((0,), (0,))


def make_arrays(pt: int, device, seed: int = 0) -> dict:
    """The TPU tool's inputs from a numpy seed: int8 values
    clip(round(60 n), -127, 127) and clip(round(3 n), -7, 7) of normal n,
    normal float32 coordinates and folds."""
    rng = np.random.default_rng(seed)

    def q(shape, scale, lim):
        x = np.round(rng.standard_normal(shape) * scale)
        return np.clip(x, -lim, lim).astype(np.int8)

    arrays = dict(
        a8=q((pt, H), 60, 127), w8=q((H, H), 60, 127),
        a4in8=q((pt, H), 3, 7), w4in8=q((H, H), 3, 7),
        aT4=q((H, pt), 3, 7), gT4=q((H, pt), 3, 7), aT8=q((H, pt), 60, 127),
        xT=rng.standard_normal((4, HW)).astype(np.float32),
        foldT=rng.standard_normal((B, H, 4)).astype(np.float32),
        aT4p=q((H, pt), 3, 7))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def gemm_run(name, x, y, dims, elem, pt, shapes) -> Run:
    steps = B * HW // pt
    m, n, k = probes.gemm_shape(shapes[x], shapes[y], dims)

    def call(fn):
        return lambda arr: fn(arr[x], arr[y], dims, steps=steps, out_rows=8,
                              elem=elem)

    lib = None
    if elem == "s8":
        def lib(arr):
            return int_mm_call(arr[x], arr[y], dims)
    nbytes = (np.prod(shapes[x]) + np.prod(shapes[y]) + 8 * n * 4)
    return Run(name, (x, y), call(probes.gemm), call(probes.gemm_reference),
               steps, float(nbytes), int8_ops=2.0 * m * n * k * steps,
               gemm=(dims, elem, k, None), library=lib)


def runs(pt: int, s4: bool = True) -> list:
    """The TPU tool's runs in its order, each 4-bit run followed by its s4
    twin when ``s4``."""
    shapes = dict(a8=(pt, H), w8=(H, H), a4in8=(pt, H), w4in8=(H, H),
                  aT4=(H, pt), gT4=(H, pt), aT8=(H, pt), aT4p=(H, pt))
    steps = B * HW // pt
    out = []

    def gemm(name, x, y, dims, int4):
        out.append(gemm_run(name, x, y, dims, "s8", pt, shapes))
        if int4 and s4:
            out.append(gemm_run(name + ":s4", x, y, dims, "s4", pt, shapes))

    gemm("gemm-int8", "a8", "w8", D10, False)
    gemm("gemm-int4", "a4in8", "w4in8", D10, True)
    gemm("gemm-i4w", "a4in8", "w4in8", D10, False)
    gemm("dw1T-i4(1,1)", "aT4", "gT4", D11, True)
    gemm("da0T-i4(1,0)", "w4in8", "gT4", D10, True)
    gemm("fwdT-i8(1,0)", "w8", "aT8", D10, False)
    gemm("fwdT-i4(1,0)", "w4in8", "aT4", D10, True)
    out.append(Run(
        "buildT-vpu", ("xT", "foldT"),
        lambda arr: probes.build_t(arr["xT"], arr["foldT"], pt),
        lambda arr: probes.build_t_reference(arr["xT"], arr["foldT"], pt),
        B * HW // pt, float(4 * HW * 4 + B * H * 4 * 4 + pt * 4),
        # per element 2 products, 2 sums, the scale, the rounding's add to
        # the column sum, and tanh counted as one operation
        f32_ops=7.0 * B * HW * H))
    # the TPU casts only w to int4: the same int8 numbers
    gemm("gemm-i8xi4", "a8", "w4in8", D10, False)
    gemm("tdw1-pre-i4", "aT4p", "a4in8", D10, True)
    gemm("tdw1-pre-i8", "aT8", "a8", D10, False)
    gemm("tdw1-tr-i4", "a4in8", "a4in8", D00, True)
    gemm("tdw1-tr-i8", "a8", "a8", D00, False)
    out.append(Run(
        "tr-only-i8", ("a8",),
        lambda arr: probes.transpose_sum(arr["a8"], steps),
        lambda arr: probes.transpose_sum_reference(arr["a8"], steps),
        steps, float(pt * H + H * 4),
        # one integer add per element and step, at the CUDA cores' rate
        f32_ops=float(steps) * pt * H,
        library=lambda arr: (lambda: arr["a8"].sum(0, dtype=torch.int32))))
    return out


def main(argv=None) -> int:
    vals, dev = parse_argv(sys.argv[1:] if argv is None else argv,
                           {"pt": 2048, "iters": 30}, USAGE)
    pt, iters = vals["pt"], vals["iters"]
    arrays = make_arrays(pt, dev)
    print(f"# grid=({B}, {HW // pt}) pt={pt} H={H} iters={iters} "
          f"backend={backend(dev)}", flush=True)
    for run in runs(pt):
        ms = time_ms(run.fn, arrays, iters)
        print(f"{run.name:14s} {ms:7.2f} ms/iter ({B / ms * 1e3:9.0f} "
              f"img-equiv/s)  bound {run.bound_ms():.4g} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
