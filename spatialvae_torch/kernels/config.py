"""The numerics knobs of the int8 kernels and of Adam.

The JAX package (``spatialvae_tpu/kernels/config.py``) reads four
environment variables that change what its fused int8 loss kernel (K3)
computes: ``SPATIALVAE_INT4_GRADS`` (gradient mode, default ``i4dw1``),
``SPATIALVAE_GSCALE`` (gradient scale, default ``bound``),
``SPATIALVAE_EPI`` (epilogue precision, default ``bf16``) and
``SPATIALVAE_SR`` (stochastic rounding when ``1``, default off).  The port
implements the defaults only: ``check_knobs`` refuses any other value, so
no wrapper ever runs other numerics than asked for.  The JAX package's
Mosaic/VMEM knobs shape the TPU schedule only and have no counterpart here.

Two knobs select Adam's numerics, and the port implements both values of
each:

- ``SPATIALVAE_ADAM_EMIT`` (``xla`` by default, or ``pallas``): how the
  int8 copies of the big encoder weights are emitted.  ``xla`` quantises
  p' with a fresh scale after K6; ``pallas`` takes K7, which quantises with
  the scale carried from the previous step.  As in the JAX package, a value
  off the default needs ``SPATIALVAE_ALLOW_KNOBS=1`` (the JAX
  ``check_numerics_default``).
- ``SPATIALVAE_ADAM_MOMENTS`` (``f32`` by default, or ``bf16``): the
  moments' storage dtype.  The JAX package reads any other value as
  ``f32``; the port refuses it.

``SPATIALVAE_PALLAS_ADAM`` only schedules the TPU's per-leaf kernel against
XLA's fusion there (same numbers either way); the port runs K6 on the card
whatever it says, and reads it nowhere.
"""

from __future__ import annotations

import os

import torch

# variable -> (default, the ROADMAP Queue 2 item that would port the others)
_KNOBS = {"SPATIALVAE_INT4_GRADS": ("i4dw1", "K3 (f)"),
          "SPATIALVAE_GSCALE": ("bound", "K3 (f)"),
          "SPATIALVAE_EPI": ("bf16", "K3 (f)"),
          "SPATIALVAE_SR": ("0", "K3 (e)")}

ADAM_EMITS = ("xla", "pallas")
_MOMENTS = {"f32": torch.float32, "bf16": torch.bfloat16}


def check_knobs() -> None:
    """Raise ``NotImplementedError`` when the environment sets a knob off its
    default (``SPATIALVAE_SR`` counts as set only at ``1``, as in JAX)."""
    for env, (default, item) in _KNOBS.items():
        v = os.environ.get(env, default)
        if env == "SPATIALVAE_SR":
            v = "1" if v == "1" else "0"
        if v != default:
            raise NotImplementedError(
                f"{env}={v!r} is not ported yet (ROADMAP Queue 2 {item}); "
                f"the port runs the int8 kernels at the defaults only")


def adam_emit() -> str:
    """``SPATIALVAE_ADAM_EMIT``: ``xla`` (default) or ``pallas``; raises
    ``ValueError`` on another value, and ``RuntimeError`` on ``pallas``
    unless ``SPATIALVAE_ALLOW_KNOBS=1``."""
    v = os.environ.get("SPATIALVAE_ADAM_EMIT", ADAM_EMITS[0])
    if v not in ADAM_EMITS:
        raise ValueError(f"SPATIALVAE_ADAM_EMIT must be one of "
                         f"{sorted(ADAM_EMITS)}, got {v!r}")
    if v != ADAM_EMITS[0] and os.environ.get("SPATIALVAE_ALLOW_KNOBS") != "1":
        raise RuntimeError(
            f"SPATIALVAE_ADAM_EMIT={v!r} changes the training numerics (a "
            f"one-step-stale quantisation scale); set "
            f"SPATIALVAE_ALLOW_KNOBS=1 to accept off-default numerics")
    return v


def moments_dtype() -> torch.dtype:
    """``SPATIALVAE_ADAM_MOMENTS``: float32 (``f32``, default) or bfloat16
    (``bf16``) Adam moments; raises ``ValueError`` on another value."""
    v = os.environ.get("SPATIALVAE_ADAM_MOMENTS", "f32")
    if v not in _MOMENTS:
        raise ValueError(f"SPATIALVAE_ADAM_MOMENTS must be one of "
                         f"{sorted(_MOMENTS)}, got {v!r}")
    return _MOMENTS[v]
