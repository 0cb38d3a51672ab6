"""Coordinate grid construction and pose transforms.

Counterpart of ``spatialvae_tpu/transforms/coords.py``: x runs -1 -> +1 left
to right, y runs +1 -> -1 top to bottom, stacked as (HW, 2) row-major in
image order; rotation right-multiplies row-vector coordinates by
R = [[cos, sin], [-sin, cos]]:

    out0 = x0*cos - x1*sin
    out1 = x0*sin + x1*cos
"""

from __future__ import annotations

import numpy as np
import torch


def coord_grid(n: int, m: int, *, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(HW, 2) coordinates for an n-row, m-column image.

    Built in float64 numpy and cast once, exactly as the JAX package does,
    so both packages decode over bit-identical grids."""
    xgrid = np.linspace(-1, 1, m)
    ygrid = np.linspace(1, -1, n)
    x0, x1 = np.meshgrid(xgrid, ygrid)
    grid = np.stack([x0.ravel(), x1.ravel()], axis=1).astype(np.float32)
    return torch.from_numpy(grid).to(device=device, dtype=dtype)


def rotate_coords(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """x: (..., HW, 2) or (HW, 2); theta: (B,) -> (B, HW, 2)."""
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)


def translate_coords(x: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """x: (B, HW, 2); dx: (B, 2) already scaled."""
    return x + dx[:, None, :]
