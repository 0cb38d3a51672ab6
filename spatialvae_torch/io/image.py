"""Host-side image operations — counterpart of ``spatialvae_tpu/io/image.py``.

- ``downsample``: rfft2, keep the low-frequency corners, scale by the area
  ratio, irfft2;
- ``crop``: centre crop;
- ``normalize``: per-image (x - mu) / sigma with the statistics of the
  background annulus (pixels at distance >= radius from the centre);
- ``normalize_whole``: per-image whole-image standardisation, the
  particles CLI's ``--normalize``.

Numpy only; ``normalize_whole`` follows the arithmetic of the JAX
package's C++ helper, which its checkout carries built.
"""

from __future__ import annotations

import numpy as np


def downsample(x: np.ndarray, factor: float = 1,
               shape: tuple | None = None) -> np.ndarray:
    """Fourier-crop a (..., n, m) stack to ``shape`` (or by ``factor``)."""
    if shape is None:
        m, n = x.shape[-2:]
        shape = (int(m / factor), int(n / factor))

    spectrum = np.fft.rfft2(x)
    m, n = shape
    top = spectrum[..., 0:m // 2, 0:n // 2 + 1]
    bottom = spectrum[..., -m // 2:, 0:n // 2 + 1]
    spectrum = np.concatenate([top, bottom], axis=-2)
    # energy rescaling so pixel values keep their magnitude
    spectrum *= (n * m) / (x.shape[-2] * x.shape[-1])
    out = np.fft.irfft2(spectrum, s=shape)
    return out.astype(x.dtype)


def crop(stack: np.ndarray, size: int) -> np.ndarray:
    """Centre-crop the trailing two dims to (size, size)."""
    n, m = stack.shape[-2:]
    si = (n - size) // 2
    sj = (m - size) // 2
    return stack[..., si:si + size, sj:sj + size]


def normalize(stack: np.ndarray, radius: float | None = None) -> np.ndarray:
    """Per-image standardisation with background-annulus statistics."""
    n, m = stack.shape[-2:]
    if radius is None:
        radius = min(n, m) / 2
    yy, xx = np.ogrid[:n, :m]
    dist = np.sqrt((n / 2 - yy) ** 2 + (m / 2 - xx) ** 2)
    annulus = dist >= radius

    out = np.zeros_like(stack)
    for i in range(stack.shape[0]):
        bg = stack[i][annulus]
        out[i] = (stack[i] - bg.mean()) / bg.std()
    return out


def normalize_whole(stack: np.ndarray) -> np.ndarray:
    """Per-image whole-image standardisation of an (N, ...) stack, as a
    float32 copy, in the arithmetic of the JAX package's C++ helper (which
    its ``normalize_whole`` takes): the mean and the mean square summed in
    float64, var = E[x^2] - mu^2 (at least 1e-30), then in float32
    (x - float32(mu)) * (1 / float32(sqrt(var)))."""
    out = np.ascontiguousarray(stack, dtype=np.float32).copy()
    flat = out.reshape(out.shape[0], -1)
    wide = flat.astype(np.float64)
    mu = wide.sum(axis=1) / flat.shape[1]
    var = (wide * wide).sum(axis=1) / flat.shape[1] - mu * mu
    inv = (np.float32(1.0)
           / np.sqrt(np.maximum(var, 1e-30)).astype(np.float32))
    flat -= mu.astype(np.float32)[:, None]
    flat *= inv[:, None]
    return out
