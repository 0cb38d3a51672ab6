"""float32 precision pins for the port's parity paths.

A float32 matrix product may silently run in TF32 on the card
(``torch.backends.cuda.matmul.allow_tf32``, ``set_float32_matmul_precision``)
and a float32 convolution does by default (``torch.backends.cudnn.allow_tf32``
is True).  TF32 keeps about three decimal digits, far outside the tolerances
the port is held to against the JAX package, so every parity path runs
inside ``fp32_precision()``, which pins all three and gives the caller's
settings back when it returns.
"""

from __future__ import annotations

import contextlib

import torch


def pin_fp32_precision() -> None:
    """Full float32 for matmuls and convolutions (no TF32), process-wide:
    for entry points such as scripts and test sessions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp32_precision_pinned() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


@contextlib.contextmanager
def fp32_precision():
    """Pin full float32 inside the block (or the decorated function) and
    restore the caller's settings after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:      # the caller mixed torch's legacy and new API
        precision = None
    pin_fp32_precision()
    try:
        yield
    finally:
        # the precision setting also sets allow_tf32; setting both would
        # mix torch's two APIs
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        else:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
