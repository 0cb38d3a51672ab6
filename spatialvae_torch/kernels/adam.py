"""Adam on the card: hand-written sm_90a CUDA kernels K6 and K7.

Counterpart of the Pallas kernels of ``spatialvae_tpu/train/optimizer_pallas.py``:
``_adam_kernel`` (K6, one leaf's m', v', p' and optional compute-dtype
shadow) and ``_adam_emit_kernel`` (K7, the same pass plus the leaf's int8
copy with the scale carried from the previous step and the abs-max for the
next).  Per element, in ``adam_leaf``'s op order
(``spatialvae_tpu/train/optimizer.py``), each operation rounded once to
float32:

    m' = b1*m + (1-b1)*g;   v' = b2*v + (1-b2)*(g*g)
    p' = p + (-lr)*(m'/c1) / (sqrt(v'/c2) + eps),  c_i = 1 - b_i**count

g is float32 or bf16, m and v float32 or bf16 (widened, updated in float32,
rounded once on store), p the float32 master; everything updates in place.
The wrappers move the version counter of every tensor a kernel wrote
(``mark_written``), as an in-place PyTorch op would, so caches keyed on
``_version`` see the step.
The shadow is bf16(p'); K7's copy is int8(clip(rint(p' * (1/s_in)), -127,
127)).

``adam_step`` runs one optimizer step over every leaf in one launch of the
step kernel (``csrc/adam_sm90.cu``): each leaf plain K6 (``PLAIN``), K6
with the abs-max and the fresh scale s = ns = max/127 + 1e-30 (``FRESH``,
the xla engine's quantised leaves) or K7 with its next scale ns
(``EMIT``); the scales are written in the same launch.  ``quantize_many``
then writes the fresh-scale copies clip(rint(p'/s)) of any number of leaves
in one launch, dividing as ``quantize_leaf`` does.  The training paths call
these two.  The per-leaf kernels of ``csrc/adam.cu`` (``adam_leaf``,
``adam_emit``) and the scale helper ``quant_scale`` stay: the first two as
the step kernel's yardstick, the helper for the seeded qshadow and the
per-dataset copy.

``adam_leaf_reference``, ``adam_emit_reference``, ``adam_step_reference``,
``quant_scale_reference`` and ``quantize_reference`` are the plain PyTorch
versions: every division there is by a tensor on the operand's device,
never by a Python number, because PyTorch's CUDA division by a CPU scalar
multiplies by its reciprocal and can miss the quotient by an ulp.  The
wrappers run the plain versions for CPU tensors and launch the kernels for
CUDA tensors, or raise.
"""

from __future__ import annotations

from dataclasses import astuple, dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from spatialvae_torch.kernels.fused_decoder import _call, _lib, _stream

GRAD_DTYPES = (torch.float32, torch.bfloat16)
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
SHADOW_DTYPE = torch.bfloat16

# Kernel launches on CUDA tensors: the per-leaf K6 and K7, the step kernel
# and the emission's two helpers.
LAUNCHES = {"adam": 0, "adam_emit": 0, "adam_step": 0, "quant_scale": 0,
            "quantize": 0}

# The step kernel's geometry (csrc/adam_sm90.cu: kChunk, kAlign,
# kMaxLeaves): a leaf's chunks hold STEP_CHUNK elements; its bulk part, the
# largest multiple of STEP_ALIGN elements, goes through the bulk-copy ring
# when every pointer of the leaf is 16-byte aligned, the rest through plain
# loads; a launch takes at most STEP_MAX_LEAVES leaves.
STEP_CHUNK = 4096
STEP_ALIGN = 16
STEP_MAX_LEAVES = 48
# the fresh-scale copies: at most this many leaves a launch
QUANT_MAX_LEAVES = 64
# what each leaf of a step emits
PLAIN, FRESH, EMIT = 0, 1, 2
# the step kernel's per-leaf flags: the abs-max, K7's copy, write s, ns
F_AMAX, F_QUANT, F_S, F_NS = 1, 2, 4, 8
MODE_FLAGS = {PLAIN: 0, FRESH: F_AMAX | F_S | F_NS,
              EMIT: F_AMAX | F_QUANT | F_NS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x: float) -> float:
    return float(np.float32(x))


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """(c1, c2) as the JAX update computes them: float32 powers of the
    float32 count."""
    one = np.float32(1.0)
    c1 = one - np.float32(b1) ** np.float32(count)
    c2 = one - np.float32(b2) ** np.float32(count)
    return float(c1), float(c2)


@dataclass(frozen=True)
class AdamConsts:
    """One step's float32 scalars, each rounded from its Python value as
    JAX rounds a weak-typed constant against a float32 array."""

    b1: float
    omb1: float          # 1 - b1
    b2: float
    omb2: float          # 1 - b2
    neg_lr: float        # -lr
    eps: float
    c1: float
    c2: float

    @classmethod
    def make(cls, learning_rate: float, b1: float, b2: float, eps: float,
             count: int) -> "AdamConsts":
        c1, c2 = bias_corrections(count, b1, b2)
        return cls(_f32(b1), _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2),
                   _f32(-learning_rate), _f32(eps), c1, c2)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's and the kernel's: the
    float64 root rounded once (PyTorch's CPU float32 sqrt misses by an ulp
    on about 0.6% of inputs)."""
    return torch.sqrt(x.double()).float()


@torch.no_grad()
def adam_leaf_reference(p, g, m, v, k: AdamConsts, shadow=None,
                        want_amax: bool = False) -> Optional[torch.Tensor]:
    """Plain version of K6, in place on p, m, v and ``shadow``; returns
    max|p'| as a float32 (1,) tensor with ``want_amax``."""
    g = g.float()
    m32 = m.float() * k.b1 + g * k.omb1
    v32 = v.float() * k.b2 + (g * g) * k.omb2
    update = (m32 / _scalar(k.c1, p)) * k.neg_lr
    update = update / (_sqrt(v32 / _scalar(k.c2, p)) + k.eps)
    p.add_(update)
    m.copy_(m32)
    v.copy_(v32)
    if shadow is not None:
        shadow.copy_(p)
    return p.abs().max().reshape(1) if want_amax else None


@torch.no_grad()
def quant_scale_reference(amax: torch.Tensor) -> torch.Tensor:
    """max/127 + 1e-30 as a float32 (1, 1) tensor."""
    return (amax.float().reshape(1, 1) / _scalar(127.0, amax)) + 1e-30


@torch.no_grad()
def quantize_reference(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8(clip(round(p/s), -127, 127)), s a float32 (1, 1) scale."""
    return torch.clamp(torch.round(p.float() / s.reshape(())), -127,
                       127).to(torch.int8)


@torch.no_grad()
def adam_emit_reference(p, g, m, v, k: AdamConsts, shadow, s_in
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: K6 with the shadow, then (q, max|p'|), q the
    int8 copy with the carried scale s_in (1, 1), multiplied by its
    reciprocal as the TPU kernel does."""
    amax = adam_leaf_reference(p, g, m, v, k, shadow, want_amax=True)
    inv = torch.reciprocal(s_in.float().reshape(()))
    q = torch.clamp(torch.round(p * inv), -127, 127).to(torch.int8)
    return q, amax


@torch.no_grad()
def adam_step_reference(p, g, m, v, k: AdamConsts, shadow=None, modes=None,
                        s_in=None) -> list:
    """Plain version of the step kernel: the leaves in order, each through
    the per-leaf plain versions.  Per leaf, by ``modes`` (all ``PLAIN``
    when None): ``PLAIN`` None; ``FRESH`` (max|p'|, s, ns), s = ns =
    max/127 + 1e-30 in two buffers; ``EMIT`` (q, max|p'|, ns), K7 with the
    carried scale ``s_in[i]`` and ns its next scale."""
    out = []
    for i, mode in enumerate(modes or [PLAIN] * len(p)):
        sh = None if shadow is None else shadow[i]
        if mode == EMIT:
            q, amax = adam_emit_reference(p[i], g[i], m[i], v[i], k, sh,
                                          s_in[i])
            out.append((q, amax, quant_scale_reference(amax)))
        elif mode == FRESH:
            amax = adam_leaf_reference(p[i], g[i], m[i], v[i], k, sh, True)
            s = quant_scale_reference(amax)
            out.append((amax, s, s.clone()))
        else:
            adam_leaf_reference(p[i], g[i], m[i], v[i], k, sh)
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------


def _check_leaf(p, g, m, v, shadow) -> None:
    """Raise on a leaf the kernels do not take, on every device."""
    if p.dtype != torch.float32:
        raise TypeError(f"the master must be float32, got {p.dtype}")
    if g.dtype not in GRAD_DTYPES:
        raise TypeError(f"gradients must be float32 or bfloat16, got "
                        f"{g.dtype}")
    if m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype:
        raise TypeError(f"moments must be both float32 or both bfloat16, "
                        f"got {m.dtype} and {v.dtype}")
    named = dict(g=g, m=m, v=v)
    if shadow is not None:
        if shadow.dtype != SHADOW_DTYPE:
            raise TypeError(f"the shadow must be bfloat16, got "
                            f"{shadow.dtype}")
        named["shadow"] = shadow
    for name, t in named.items():
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                             f"master {tuple(p.shape)}")
    named["p"] = p
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"the leaf lies on several devices: {devices}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p.device}")


def _check_scale(s: torch.Tensor, p: torch.Tensor) -> None:
    if (s.dtype != torch.float32 or s.numel() != 1 or s.device != p.device
            or not s.is_contiguous()):
        raise ValueError("a scale is one contiguous float32 element on the "
                         "leaf's device")


def _check_step(p, g, m, v, shadow, modes, s_in) -> None:
    """Raise on a step the kernel does not take, on every device: every
    leaf as ``_check_leaf`` does (with its errors), one gradient dtype and
    one moment dtype for the step, one device, a shadow for every leaf or
    for none (K7 needs it), a carried scale for every K7 leaf."""
    n = len(p)
    if not (len(g) == len(m) == len(v) == len(modes) == n) or any(
            x is not None and len(x) != n for x in (shadow, s_in)):
        raise ValueError("a step takes one g, m, v, mode (and shadow and "
                         "s_in) per master")
    if not set(modes) <= {PLAIN, FRESH, EMIT}:
        raise ValueError(f"modes are PLAIN, FRESH or EMIT, got {modes}")
    if EMIT in modes and shadow is None:
        raise ValueError("K7 writes the shadow: pass it")
    sh = [None] * n if shadow is None else shadow
    for pi, gi, mi, vi, si in zip(p, g, m, v, sh):
        _check_leaf(pi, gi, mi, vi, si)
        if gi.dtype != g[0].dtype or mi.dtype != m[0].dtype:
            raise TypeError(f"a step's gradients share one dtype and its "
                            f"moments one: got {g[0].dtype}/{gi.dtype} and "
                            f"{m[0].dtype}/{mi.dtype}")
        if pi.device != p[0].device:
            raise ValueError(f"the step's leaves lie on several devices: "
                             f"{p[0].device}, {pi.device}")
        if (si is None) != (shadow is None):
            raise ValueError("a step has a shadow for every leaf or for none")
    for i, mode in enumerate(modes):
        if mode == EMIT:
            if s_in is None or s_in[i] is None:
                raise ValueError("K7 takes the carried scale: pass s_in")
            _check_scale(s_in[i], p[i])


def step_table(p, g, m, v, shadow, q, s_in, modes) -> np.ndarray:
    """The step kernel's leaf table, (leaves, 10) int64, one row per leaf:
    the addresses of g, m, v, p, the shadow, q and s_in (0 where none), n,
    the bulk count n_bulk (the largest multiple of STEP_ALIGN when every
    pointer is 16-byte aligned, else 0) and begin | flags << 32 (the leaf's
    first chunk in the launch and its ``MODE_FLAGS``).  ``shadow``, ``q``
    and ``s_in`` are lists with None entries, or None."""
    rows = []
    begin = 0
    none = [None] * len(p)
    for pi, gi, mi, vi, si, qi, ci, mode in zip(
            p, g, m, v, shadow or none, q or none, s_in or none, modes):
        n = pi.numel()
        ptrs = [gi.data_ptr(), mi.data_ptr(), vi.data_ptr(), pi.data_ptr(),
                0 if si is None else si.data_ptr(),
                0 if qi is None else qi.data_ptr()]
        aligned = not any(a % 16 for a in ptrs)
        bulk = n - n % STEP_ALIGN if aligned else 0
        rows.append(ptrs + [0 if ci is None else ci.data_ptr(), n, bulk,
                            begin | (MODE_FLAGS[mode] << 32)])
        begin += -(-bulk // STEP_CHUNK) + -(-(n - bulk) // STEP_CHUNK)
    return np.array(rows, dtype=np.int64).reshape(-1, 10)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def mark_written(*tensors) -> None:
    """Move autograd's version counter of each tensor (None skipped) that a
    kernel wrote through its raw pointer: such a write bypasses the
    counter, so a cache keyed on ``_version`` (the float decoder's
    ``generator_tail_weights``) would go on serving the old values.  A
    detached view shares its base's counter, so marking the view marks the
    parameter.  The wrappers mark the leaves they update in place (p, m, v,
    the shadow), not the int8 copies they allocate on the same call: no
    cache has seen a fresh tensor."""
    ts = [t for t in tensors if t is not None]
    if ts:
        torch.autograd.graph.increment_version(ts)


def adam_leaf(p, g, m, v, k: AdamConsts, shadow=None,
              want_amax: bool = False) -> Optional[torch.Tensor]:
    """K6 on one leaf, in place on p (float32), m, v and the bf16
    ``shadow`` (or None); with ``want_amax`` returns max|p'| as a float32
    (1,) tensor.  CPU tensors take ``adam_leaf_reference``; CUDA tensors
    launch the kernel and count it in ``LAUNCHES["adam"]``."""
    _check_leaf(p, g, m, v, shadow)
    if p.device.type == "cpu":
        return adam_leaf_reference(p, g, m, v, k, shadow, want_amax)
    if p.numel() == 0:
        return torch.zeros(1, device=p.device) if want_amax else None
    amax = torch.zeros(1, device=p.device) if want_amax else None
    with torch.cuda.device(p.device):
        _call(_lib(), "svt_adam", g.data_ptr(), m.data_ptr(), v.data_ptr(),
              p.data_ptr(), _ptr(shadow), _ptr(amax), p.numel(),
              int(g.dtype == torch.bfloat16), int(m.dtype == torch.bfloat16),
              *astuple(k), _stream(p))
    LAUNCHES["adam"] += 1
    mark_written(p, m, v, shadow)
    return amax


def adam_emit(p, g, m, v, k: AdamConsts, shadow, s_in
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on one leaf: K6 in place with the bf16 ``shadow``, and returns
    (q, amax): the int8 copy of p' with the carried scale ``s_in`` (one
    float32) and max|p'| (float32 (1,)).  CPU tensors take
    ``adam_emit_reference``; CUDA tensors launch the kernel and count it in
    ``LAUNCHES["adam_emit"]``."""
    if shadow is None:
        raise ValueError("K7 writes the shadow: pass it")
    _check_leaf(p, g, m, v, shadow)
    _check_scale(s_in, p)
    if p.device.type == "cpu":
        return adam_emit_reference(p, g, m, v, k, shadow, s_in)
    q = torch.empty(p.shape, dtype=torch.int8, device=p.device)
    amax = torch.zeros(1, device=p.device)
    if p.numel():
        with torch.cuda.device(p.device):
            _call(_lib(), "svt_adam_emit", g.data_ptr(), m.data_ptr(),
                  v.data_ptr(), p.data_ptr(), shadow.data_ptr(), q.data_ptr(),
                  s_in.data_ptr(), amax.data_ptr(), p.numel(),
                  int(g.dtype == torch.bfloat16),
                  int(m.dtype == torch.bfloat16), *astuple(k), _stream(p))
        LAUNCHES["adam_emit"] += 1
        mark_written(p, m, v, shadow)
    return q, amax


def quant_scale(amax: torch.Tensor, twin: bool = False):
    """The scale max/127 + 1e-30 of a float32 abs-max, as a float32 (1, 1)
    tensor; with ``twin`` also a second buffer holding the same value (the
    entry's ``ns``).  CPU tensors take ``quant_scale_reference``."""
    _check_scale(amax, amax)
    if amax.device.type == "cpu":
        s = quant_scale_reference(amax)
        return (s, s.clone()) if twin else s
    s = torch.empty((1, 1), device=amax.device)
    ns = torch.empty((1, 1), device=amax.device) if twin else None
    with torch.cuda.device(amax.device):
        _call(_lib(), "svt_quant_scale", amax.data_ptr(), s.data_ptr(),
              _ptr(ns), _stream(amax))
    LAUNCHES["quant_scale"] += 1
    return (s, ns) if twin else s


def adam_step(p, g, m, v, k: AdamConsts, shadow=None, modes=None,
              s_in=None) -> list:
    """One optimizer step over every leaf, in place on the masters ``p``
    (float32), the moments and the bf16 ``shadow`` list (or None): lists
    with one entry per leaf, one gradient and one moment dtype.  Per leaf,
    by ``modes`` (all ``PLAIN`` when None): ``PLAIN`` K6, returns None;
    ``FRESH`` K6 with the abs-max and the fresh scale, returns (max|p'|
    (1,), s (1, 1), ns (1, 1)); ``EMIT`` K7 with the carried scale
    ``s_in[i]``, returns (q, max|p'|, ns).  CPU tensors take
    ``adam_step_reference``; CUDA tensors launch the step kernel once per
    STEP_MAX_LEAVES leaves, each counted in ``LAUNCHES["adam_step"]``,
    after zeroing one buffer of abs-maxes and scales when a leaf needs
    them."""
    modes = [PLAIN] * len(p) if modes is None else list(modes)
    _check_step(p, g, m, v, shadow, modes, s_in)
    if not p or p[0].device.type == "cpu":
        return adam_step_reference(p, g, m, v, k, shadow, modes, s_in)
    dev = p[0].device
    lib = _lib()
    flags = (int(g[0].dtype == torch.bfloat16),
             int(m[0].dtype == torch.bfloat16), int(shadow is not None))
    out = [None] * len(p)
    for a in range(0, len(p), STEP_MAX_LEAVES):
        idx = range(a, min(len(p), a + STEP_MAX_LEAVES))
        nl = len(idx)
        part = [modes[i] for i in idx]
        aux = (torch.zeros(3 * nl + 1, device=dev)
               if any(md != PLAIN for md in part) else None)
        q = [torch.empty(p[i].shape, dtype=torch.int8, device=dev)
             if modes[i] == EMIT else None for i in idx]
        table = step_table(
            [p[i] for i in idx], [g[i] for i in idx], [m[i] for i in idx],
            [v[i] for i in idx],
            None if shadow is None else [shadow[i] for i in idx], q,
            [s_in[i] if modes[i] == EMIT else None for i in idx], part)
        with torch.cuda.device(dev):
            _call(lib, "svt_adam_step", table.ctypes.data, nl, _ptr(aux),
                  *flags, *astuple(k), _stream(p[0]))
        LAUNCHES["adam_step"] += 1
        mark_written(*(t[i] for t in (p, m, v) for i in idx),
                     *(shadow[i] for i in idx if shadow is not None))
        for j, i in enumerate(idx):
            if modes[i] == PLAIN:
                continue
            amax = aux[j:j + 1]
            ns = aux[2 * nl + j:2 * nl + j + 1].view(1, 1)
            out[i] = ((q[j], amax, ns) if modes[i] == EMIT else
                      (amax, aux[nl + j:nl + j + 1].view(1, 1), ns))
    return out


def quantize_many(ps: list, ss: list) -> list:
    """int8(clip(rint(p/s), -127, 127)) of contiguous float32 tensors, each
    with its float32 scale (one element), in one launch per
    QUANT_MAX_LEAVES tensors (counted in ``LAUNCHES["quantize"]``).  CPU
    tensors take ``quantize_reference``."""
    if len(ps) != len(ss):
        raise ValueError("quantize takes one scale per tensor")
    for p, s in zip(ps, ss):
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("quantize takes a contiguous float32 tensor")
        if p.device != ps[0].device:
            raise ValueError("quantize takes tensors on one device")
        _check_scale(s, p)
    if not ps or ps[0].device.type == "cpu":
        return [quantize_reference(p, s) for p, s in zip(ps, ss)]
    dev = ps[0].device
    qs = [torch.empty(p.shape, dtype=torch.int8, device=dev) for p in ps]
    rows = [[p.data_ptr(), s.data_ptr(), q.data_ptr(), p.numel()]
            for p, s, q in zip(ps, ss, qs) if p.numel()]
    lib = _lib()
    for a in range(0, len(rows), QUANT_MAX_LEAVES):
        table = np.array(rows[a:a + QUANT_MAX_LEAVES], dtype=np.int64)
        with torch.cuda.device(dev):
            _call(lib, "svt_quantize", table.ctypes.data, len(table),
                  _stream(ps[0]))
        LAUNCHES["quantize"] += 1
    return qs


def quantize(p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8(clip(rint(p/s), -127, 127)) of a contiguous float32 tensor with
    the float32 scale ``s``: ``quantize_many`` of one tensor."""
    return quantize_many([p], [s])[0]
