"""What the port's probe tools share: the run record, argv parsing, timing
on the card and each run's bound."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from spatialvae_torch.device import resolve_device

# the card's peaks (NVIDIA's H100 SXM data sheet, dense), as chip_smoke.py
# holds them: int8 tensor cores, float32 outside them, device memory
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Run:
    """One run of a probe tool.  ``fn`` and ``plain`` take the tool's
    arrays (a dict of tensors) and return ``(out, sums)`` through the
    wrapper (kernel on the card) and through the plain version; ``args``
    names the arrays in the TPU tool's argument order.  ``nbytes``,
    ``int8_ops`` and ``f32_ops`` are the run's least traffic (inputs read
    once, the output written once) and its operations; ``gemm`` the
    ``probes.gemm`` arguments (dims, elem, k, store) of a GEMM run, else
    None; ``library`` builds, from the arrays, one PyTorch call that
    computes one step's result (timed ``steps`` times), or is None."""

    name: str
    args: tuple
    fn: Callable
    plain: Callable
    steps: int
    nbytes: float
    int8_ops: float = 0.0
    f32_ops: float = 0.0
    gemm: Optional[tuple] = None
    library: Optional[Callable] = None

    def bound_ms(self) -> float:
        """The least time on the card: the larger of the bytes over the
        memory rate and the operations over their peaks."""
        ops = self.int8_ops / PEAK_INT8 + self.f32_ops / PEAK_FP32
        return max(ops, self.nbytes / HBM_BYTES_PER_S) * 1e3


def parse_argv(argv, ints: dict, usage: str) -> tuple:
    """``key=value`` arguments: ``ints`` (name -> default) are integers;
    ``device`` names the device (default: the card).  Returns (ints,
    device); raises SystemExit on anything else."""
    vals = dict(ints)
    device = None
    for a in argv:
        k, sep, v = a.partition("=")
        if not sep or (k not in vals and k != "device"):
            raise SystemExit(f"usage: {usage}")
        if k == "device":
            device = v
        else:
            vals[k] = int(v)
    return vals, resolve_device(device)


def time_ms(fn, arrays: dict, iters: int) -> float:
    """Milliseconds per call of ``fn(arrays)`` over ``iters`` calls after
    one warm-up: CUDA events on the card, the host clock on the CPU."""
    dev = next(iter(arrays.values())).device
    fn(arrays)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(arrays)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(arrays)
    return (time.perf_counter() - t0) * 1e3 / iters


def backend(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type
