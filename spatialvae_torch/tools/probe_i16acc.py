"""Probe: what the width of a stored accumulator costs on the card -- the
port of ``tools/probe_i16acc.py``.

    python -m spatialvae_torch.tools.probe_i16acc [device=cpu]

The TPU tool's GEMM, a (1024, 512) x (512, 512) product of 4-bit values
in [-7, 7] repeated over a grid of 64 steps, with the accumulator stored as
int32, int16, bfloat16 or float32 and read back into a float32 output (the
loss kernel's forward accumulator is bounded by 7 * 7 * 512 = 25,088, exact
in int16).  Here each step writes its accumulator at that width to device
memory and reads it back (``probes.gemm`` with ``store``), through the s8
arm (int8 mma.sync, the port) and the s4 arm (``:s4``).  Each prints one
line: ms per call (CUDA events over 100 calls after a warm-up; the host
clock with ``device=cpu``) and the bound on the card.  Without a card and
without ``device=cpu`` it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spatialvae_torch.kernels import probes
from spatialvae_torch.tools.common import Run, backend, parse_argv, time_ms

PT, H = 1024, 512
GRID = 64
ITERS = 100
STORES = ("int32", "int16", "bfloat16", "float32")
USAGE = "python -m spatialvae_torch.tools.probe_i16acc [device=cpu]"
D10 = ((1,), (0,))


def make_arrays(device, seed: int = 0) -> dict:
    """aq (PT, H) and wq (H, H): int8 values uniform in [-7, 7] from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(
        rng.integers(-7, 8, shape, dtype=np.int8)).to(device)
        for k, shape in (("aq", (PT, H)), ("wq", (H, H)))}


def runs(s4: bool = True) -> list:
    out = []
    for store in STORES:
        for elem in ("s8", "s4") if s4 else ("s8",):
            def call(fn, elem=elem, store=store):
                return lambda arr: fn(arr["aq"], arr["wq"], D10, steps=GRID,
                                      out_rows=PT, elem=elem, store=store)

            lib = None
            if elem == "s8" and store == "int32":
                def lib(arr):
                    return lambda: torch._int_mm(arr["aq"],
                                                 arr["wq"].t().contiguous().t())
            out.append(Run(
                f"acc={store}" + (":s4" if elem == "s4" else ""),
                ("aq", "wq"), call(probes.gemm), call(probes.gemm_reference),
                GRID, float(PT * H + H * H + PT * H * 4),
                int8_ops=2.0 * PT * H * H * GRID,
                gemm=(D10, elem, H, store), library=lib))
    return out


def main(argv=None) -> int:
    _, dev = parse_argv(sys.argv[1:] if argv is None else argv, {}, USAGE)
    arrays = make_arrays(dev)
    print(f"# grid=({GRID},) PT={PT} H={H} iters={ITERS} "
          f"backend={backend(dev)}", flush=True)
    for run in runs():
        ms = time_ms(run.fn, arrays, ITERS)
        print(f"{run.name}: OK  {ms:.2f} ms/iter  bound "
              f"{run.bound_ms():.4g} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
