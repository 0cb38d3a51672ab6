"""What the port's measurement tools share: the run record, argv parsing
(``only=`` selection), timing on the card and each run's bound, with the
operations of the int8 decoder's float work."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from spatialvae_torch.device import resolve_device
from spatialvae_torch.kernels import probes

# the card's peaks (NVIDIA's H100 SXM data sheet, dense), as chip_smoke.py
# holds them: int8 tensor cores, float32 outside them, device memory
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# f32 operations per (pixel, hidden unit) element of the int8 decoder's work
# on the CUDA cores, tanh counted as one operation
FLOAT_OPS = {
    # a0 = tanh((x0*f0 + x1*f1) + c), q = round(127 * a0): 2 products, 2
    # sums, tanh, the scale and the rounding
    "chain": 7,
    # a1 = tanh(acc * scale + b1): the conversion, product, sum, tanh
    "epilogue": 4,
    # dh1 = da1 * (1 - a1^2) (3), db1 (1), the scale's max (1), the
    # quantisation (product, rounding, clip: 3), dh0 = da0 * scale * (1 -
    # a0^2) (4), the three dfold sums (6)
    "grad": 18,
}


@dataclass(frozen=True)
class Run:
    """One run of a measurement tool.  ``fn`` and ``plain`` take the
    tool's arrays (a dict of tensors) and return ``(out, sums)`` through
    the wrapper (kernel on the card) and through the plain version (the
    kernel microbenchmark: tuples of outputs and of per-block sums); ``args``
    names the arrays in the TPU tool's argument order.  ``nbytes``,
    ``int8_ops`` and ``f32_ops`` are the run's least traffic (inputs read
    once, the output written once) and its operations; ``gemm`` the
    ``probes.gemm`` arguments (dims, elem, k, store) of a GEMM run, else
    None; ``library`` builds, from the arrays, one PyTorch call that
    computes one step's result (timed ``steps`` times), or is None;
    ``prepare`` adds the arrays only this run reads (its name -> tensor
    dict) before it runs, or is None."""

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
    prepare: Optional[Callable] = None

    def bound_ms(self) -> float:
        """The least time on the card: the larger of the bytes over the
        memory rate and the operations over their peaks."""
        ops = self.int8_ops / PEAK_INT8 + self.f32_ops / PEAK_FP32
        return max(ops, self.nbytes / HBM_BYTES_PER_S) * 1e3


def float_ops(elements: float, *work: str, head: int = 0) -> float:
    """f32 operations of ``elements`` (pixel, hidden unit) values through
    the ``FLOAT_OPS`` steps named in ``work``, plus ``head`` products of
    2 operations each per element (a head of No outputs forward: No; its
    backward, dWh^T and da1: 2 No)."""
    return elements * (sum(FLOAT_OPS[w] for w in work) + 2 * head)


def parse_argv(argv, ints: dict, usage: str, lists: tuple = ()) -> tuple:
    """``key=value`` arguments: ``ints`` (name -> default) are integers,
    ``lists`` names comma lists (default None); ``device`` names the device
    (default: the card).  Returns (values, device); raises SystemExit on
    anything else."""
    vals = dict(ints, **{k: None for k in lists})
    device = None
    for a in argv:
        k, sep, v = a.partition("=")
        if not sep or (k not in vals and k != "device"):
            raise SystemExit(f"usage: {usage}")
        if k == "device":
            device = v
        elif k in lists:
            vals[k] = v.split(",")
        else:
            vals[k] = int(v)
    return vals, resolve_device(device)


def wanted(name: str, only) -> bool:
    """Whether ``only=`` selects the run ``name``: every run without it,
    else a run whose name starts with one of the listed prefixes (the TPU
    tools' ``want``)."""
    return only is None or any(name.startswith(o) for o in only)


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


def int_mm_call(x, y, dims):
    """One ``torch._int_mm`` of the run's product, on operands zero-padded
    to multiples of 8 and laid out as cuBLASLt takes them (prepared here,
    outside the timed call)."""
    code = probes.DIMS[dims]
    a = x.t() if code == 2 else x
    bt = y if code == 1 else y.t()              # (N, K)
    m, k = a.shape
    n = bt.shape[0]
    mp, kp, np_ = max(24, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    a = F.pad(a, (0, kp - k, 0, mp - m)).contiguous()
    bt = F.pad(bt, (0, kp - k, 0, np_ - n)).contiguous()
    return lambda: torch._int_mm(a, bt.t())
