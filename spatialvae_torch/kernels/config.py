"""The numerics knobs of the int8 kernels.

The JAX package (``spatialvae_tpu/kernels/config.py``) reads four
environment variables that change what its fused int8 loss kernel (K3)
computes: ``SPATIALVAE_INT4_GRADS`` (gradient mode, default ``i4dw1``),
``SPATIALVAE_GSCALE`` (gradient scale, default ``bound``),
``SPATIALVAE_EPI`` (epilogue precision, default ``bf16``) and
``SPATIALVAE_SR`` (stochastic rounding when ``1``, default off).  The port
implements the defaults only: ``check_knobs`` refuses any other value, so
no wrapper ever runs other numerics than asked for.  The JAX package's
Mosaic/VMEM knobs shape the TPU schedule only and have no counterpart here.
"""

from __future__ import annotations

import os

# variable -> (default, the ROADMAP Queue 2 item that would port the others)
_KNOBS = {"SPATIALVAE_INT4_GRADS": ("i4dw1", "K3 (f)"),
          "SPATIALVAE_GSCALE": ("bound", "K3 (f)"),
          "SPATIALVAE_EPI": ("bf16", "K3 (f)"),
          "SPATIALVAE_SR": ("0", "K3 (e)")}


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
