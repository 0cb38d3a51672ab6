"""Adam with the shadow and int8 emission — counterpart of
``spatialvae_tpu/train/optimizer_pallas.py`` (``fused_adam_pallas``,
``quantize_leaf``, ``_emit_block_rows``) and of the JAX trainer's
``_quantize_dataset``.

``update_apply`` updates the float32 masters and the moments in place
(one launch of the step kernel, ``kernels/adam.py`` ``adam_step``) and, on
request, writes two copies the next step reads: the bf16 **shadow** of
every leaf (the tensors the loss differentiates, so no per-step cast of
the parameters remains) and the per-tensor int8 **qshadow** of every 2-D leaf with at least
``quant_min_elems`` elements ({"q", "s", "ns"} entries; empty ones
elsewhere, as in JAX).  The int8 copies take one of two engines,
``SPATIALVAE_ADAM_EMIT`` (``kernels/config.py``):

- ``xla`` (default): K6 with the abs-max of p' riding its pass and the
  scale s = max/127 + 1e-30 written in the same launch, then the
  fresh-scale copy q = clip(rint(p'/s)) of ``quantize_leaf`` (one launch
  over every such leaf), with ``ns`` = s;
- ``pallas``: K7 for each leaf that JAX's ``_emit_block_rows`` gate admits
  (evaluated on JAX's (fan_in, fan_out) orientation, which is the transpose
  of an ``nn.Linear`` weight): q with the scale carried in the previous
  entry's ``ns``, the entry {"q", "s": that scale, "ns": max|p'|/127 +
  1e-30}.  Other leaves take the fresh-scale path.

The int8 copies keep the port's layout (an ``nn.Linear`` weight's
(out, in)); the scale is per tensor, so the values are JAX's transposed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from spatialvae_torch.kernels import adam as k_adam
from spatialvae_torch.kernels.config import adam_emit
from spatialvae_torch.train.optimizer import FusedAdam, FusedAdamState


def empty_entry(device) -> dict:
    """The placeholder entry of a leaf without an int8 copy."""
    return {"q": torch.zeros((0, 0), dtype=torch.int8, device=device),
            "s": torch.zeros((1, 1), device=device),
            "ns": torch.zeros((1, 1), device=device)}


@torch.no_grad()
def quantize_leaf(p: torch.Tensor, on: bool) -> dict:
    """Per-tensor symmetric int8 copy of p, {"q", "s", "ns"} with
    s = ns = max|p|/127 + 1e-30 (two buffers) and q = clip(rint(p/s),
    -127, 127); or the empty entry."""
    if not on:
        return empty_entry(p.device)
    p = p.detach().float().contiguous()
    s, ns = k_adam.quant_scale(p.abs().amax().reshape(1), twin=True)
    return {"q": k_adam.quantize(p, s), "s": s, "ns": ns}


@torch.no_grad()
def quantize_dataset(y: torch.Tensor, rows: int = 4096):
    """(xq (N, n) int8, sx (1, 1) float32): the per-dataset int8 copy of
    the images y (N, ...), ``quantize_leaf`` of y.reshape(N, -1), written in
    one launch.  The abs-max is folded in chunks of ``rows`` images, so its
    transients stay a chunk in size (the galaxy bench's 65,536 images make
    an 805 MB copy)."""
    n = y.shape[0]
    flat = y.reshape(n, -1)
    amax = torch.zeros(1, device=y.device)
    for i in range(0, n, rows):
        amax = torch.maximum(amax, flat[i:i + rows].float().abs().amax()
                             .reshape(1))
    sx = k_adam.quant_scale(amax)
    return k_adam.quantize(flat.float().contiguous(), sx), sx


def emit_block_rows(r: int, c: int, g_dt: torch.dtype,
                    m_dt: torch.dtype) -> int:
    """JAX's ``_emit_block_rows``: the largest multiple of 8 that divides r
    and keeps a row block near 12 MB, or 0 (then the leaf takes the
    fresh-scale path).  r, c in JAX's (fan_in, fan_out) order."""
    gi = torch.finfo(g_dt).bits // 8
    mi = torch.finfo(m_dt).bits // 8
    bytes_per_row = c * (gi + 2 * mi + 4 + 2 * mi + 4 + 2 + 1)
    cap = max(8, (12 << 20) // max(1, bytes_per_row))
    best = 0
    for bs in range(8, min(r, cap) + 1, 8):
        if r % bs == 0:
            best = bs
    return best


def _k7_gate(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
             quant_min_elems: int) -> bool:
    """JAX's K7 condition (``optimizer_pallas.py:284-287``) on a port leaf:
    2-D float32 of at least ``quant_min_elems`` elements whose JAX
    orientation (the transpose) has a row block."""
    return (p.dim() == 2 and p.numel() >= quant_min_elems
            and p.dtype == torch.float32
            and emit_block_rows(p.shape[1], p.shape[0], g.dtype,
                                m.dtype) != 0)


def step_modes(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
               quant_min_elems: Optional[int], use_emit: bool) -> list:
    """Each leaf's part in a step, in ``params``' order: ``EMIT`` where K7
    takes it (``use_emit`` and ``_k7_gate``), ``FRESH`` where the
    fresh-scale path quantises it (2-D, at least ``quant_min_elems``
    elements), else ``PLAIN``."""
    modes = []
    for name, p in params.items():
        if use_emit and _k7_gate(p, grads[name], mu[name], quant_min_elems):
            modes.append(k_adam.EMIT)
        elif (quant_min_elems is not None and p.dim() == 2
              and p.numel() >= quant_min_elems):
            modes.append(k_adam.FRESH)
        else:
            modes.append(k_adam.PLAIN)
    return modes


class FusedAdamPallas(FusedAdam):
    """``fused_adam_pallas(lr)``: ``FusedAdam`` whose ``update_apply`` also
    emits the shadow and the int8 copies."""

    def update_apply(self, grads: Dict[str, torch.Tensor],
                     state: FusedAdamState, params: Dict[str, torch.Tensor],
                     shadow: Optional[Dict[str, torch.Tensor]] = None,
                     quant_min_elems: Optional[int] = None,
                     prev_quant: Optional[Dict[str, dict]] = None):
        """In place on params, the moments and ``shadow`` (a dict of bf16
        tensors shaped like params, written with bf16(p')), in one launch
        of the step kernel, which also writes the scales; then one launch
        of the fresh-scale copies, if any.  Returns the advanced state, or
        (state, qshadow) with ``quant_min_elems``: the new int8 entries,
        keyed like params.  ``prev_quant``, the previous qshadow, feeds
        K7's carried scales under ``SPATIALVAE_ADAM_EMIT=pallas`` (which
        needs ``shadow``)."""
        if quant_min_elems is None and shadow is None:
            return super().update_apply(grads, state, params)
        count = state.count + 1
        use_emit = (quant_min_elems is not None and shadow is not None
                    and prev_quant is not None and adam_emit() == "pallas")
        names = list(params)
        ps = [params[n].detach() for n in names]
        modes = step_modes(params, grads, state.mu, quant_min_elems,
                           use_emit)
        outs = k_adam.adam_step(
            ps, [grads[n] for n in names], [state.mu[n] for n in names],
            [state.nu[n] for n in names], self.consts(count),
            None if shadow is None else [shadow[n].detach() for n in names],
            modes, [prev_quant[n]["ns"] if md == k_adam.EMIT else None
                    for n, md in zip(names, modes)])
        st = FusedAdamState(count, state.mu, state.nu)
        if quant_min_elems is None:
            return st
        fresh = [i for i, md in enumerate(modes) if md == k_adam.FRESH]
        fresh_q = dict(zip(fresh, k_adam.quantize_many(
            [ps[i] for i in fresh], [outs[i][1] for i in fresh])))
        qshadow = {}
        for i, name in enumerate(names):
            prev = None if prev_quant is None else prev_quant.get(name)
            if modes[i] == k_adam.EMIT:
                qshadow[name] = {"q": outs[i][0], "s": prev["ns"],
                                 "ns": outs[i][2]}
            elif modes[i] == k_adam.FRESH:
                qshadow[name] = {"q": fresh_q[i], "s": outs[i][1],
                                 "ns": outs[i][2]}
            elif prev is not None and prev["q"].numel() == 0:
                qshadow[name] = prev        # placeholders carry over as is
            else:
                qshadow[name] = empty_entry(ps[i].device)
        return st, qshadow


def fused_adam_pallas(learning_rate: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8
                      ) -> FusedAdamPallas:
    return FusedAdamPallas(learning_rate, b1, b2, eps)
