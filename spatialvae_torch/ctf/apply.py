"""Per-image CTF on the device — counterpart of
``spatialvae_tpu/ctf/apply.py``.

The reference applies each particle's real-space CTF kernel with a grouped
``conv2d``: image i cross-correlated with kernel i, zero padding kn // 2.
``apply_ctf`` computes the same linear cross-correlation as the JAX package
does, through zero-padded FFTs (``torch.fft``, cuFFT on the card: a
library call that stands for XLA's FFT, not for a Pallas kernel): flip the
kernel, pad both to (n + kn - 1, m + km - 1), multiply the spectra, and
take the (n, m) window at offset (kn - 1 - kn // 2, km - 1 - km // 2).  The
spectra are computed on every call, as in JAX.  ``apply_ctf_spatial`` is
the reference's grouped ``conv2d`` itself, the parity path.

Like XLA's FFT, ``apply_ctf`` takes float32 or float64 only: bf16 inputs
raise ``ValueError`` (the JAX trainer refuses CTF with bf16 compute the
same way, at its first step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spatialvae_torch.precision import fp32_precision

FFT_DTYPES = (torch.float32, torch.float64)


def check_fft_dtype(*tensors) -> None:
    for t in tensors:
        if t.dtype not in FFT_DTYPES:
            raise ValueError(f"RFFT input must be float32 or float64, got "
                             f"{str(t.dtype).replace('torch.', '')}")


def apply_ctf(y: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """FFT path.  y: (B, n, m); kernels: (B, kn, km) -> (B, n, m), in y's
    dtype."""
    check_fft_dtype(y, kernels)
    n, m = y.shape[1], y.shape[2]
    kn, km = kernels.shape[1], kernels.shape[2]
    pn, pm = kn // 2, km // 2
    size = (n + kn - 1, m + km - 1)

    kf = torch.flip(kernels, dims=(1, 2))  # cross-correlation = conv(flip(k))
    fy = torch.fft.rfft2(y, s=size)
    fk = torch.fft.rfft2(kf, s=size)
    full = torch.fft.irfft2(fy * fk, s=size)
    oi, oj = kn - 1 - pn, km - 1 - pm
    return full[:, oi:oi + n, oj:oj + m]


@fp32_precision()
def apply_ctf_spatial(y: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Grouped-conv parity path: the batch as channels, one kernel per
    channel, padding kn // 2 (no TF32 on the card)."""
    b = y.shape[0]
    pn, pm = kernels.shape[1] // 2, kernels.shape[2] // 2
    out = F.conv2d(y[None], kernels[:, None], padding=(pn, pm), groups=b)
    return out[0]
