"""SpatialGenerator p(y|x,z) — the coordinate-conditioned MLP decoder.

Counterpart of ``spatialvae_tpu/models/spatial.py``:
``h = coord_linear(x) + latent_linear(z) [+ bilinear(x, z)]`` followed by
``act, [Linear(H,H)+act | ResidLinear]*(L-1), Linear(H, n_out), Sigmoid`` and
an optional softplus on the first output channel.  ``expand_coords`` appends
x^2, y^2, x*y to the 2-vector coordinate input.

The pose fold: for the plain in_dim=2 decoder, sample -> rotate -> translate
-> coord_linear folds algebraically into per-image first-layer weights,

    h[b,p] = x0[p]*W0'[b] + x1[p]*W1'[b] + c'[b]
    W0' = cos*W0 + sin*W1,  W1' = -sin*W0 + cos*W1,
    c'  = dx0*W0 + dx1*W1 + b + z @ Wz,

so no rotated (B, HW, 2) grid is ever built.  The identity is exact; the
generic path stays for ``expand_coords``/``bilinear`` and for parity tests.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spatialvae_tpu.core.config import SpatialGeneratorConfig
from spatialvae_torch.nn.layers import (
    bilinear,
    hidden_layer,
    linear,
    resolve_activation,
    stack_linears,
)


class SpatialGenerator(nn.Module):
    """Attribute and ``layers`` layout are the reference module's, so the
    state_dict keys match ``io/torch_import.build_generator_module``."""

    def __init__(self, cfg: SpatialGeneratorConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.cfg = cfg
        self.softplus = cfg.softplus
        self.expand_coords = cfg.expand_coords
        self.latent_dim = cfg.latent_dim
        self.coord_linear = linear(cfg.in_dim, cfg.hidden_dim, **kw)
        if cfg.latent_dim > 0:
            self.latent_linear = linear(cfg.latent_dim, cfg.hidden_dim,
                                        bias=False, **kw)
            if cfg.bilinear:
                self.bilinear = bilinear(cfg.in_dim, cfg.latent_dim,
                                         cfg.hidden_dim, **kw)
        mods: List[nn.Module] = [resolve_activation(cfg.activation)]
        for _ in range(cfg.num_layers - 1):
            mods += hidden_layer(cfg.hidden_dim, cfg.activation, cfg.resid,
                                 **kw)
        mods += [linear(cfg.hidden_dim, cfg.n_out, **kw), nn.Sigmoid()]
        self.layers = nn.Sequential(*mods)

    def linears(self) -> List[nn.Linear]:
        """Hidden (H, H) layers followed by the (H, n_out) head."""
        return stack_linears(self.layers)

    def tail(self, h: torch.Tensor) -> torch.Tensor:
        """act -> hidden stack -> head -> sigmoid -> optional softplus(ch 0)."""
        y = self.layers(h)
        if self.softplus:
            y = torch.cat([F.softplus(y[..., :1]), y[..., 1:]], dim=-1)
        return y

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """Generic path.  x: (B, HW, 2) or (HW, 2); z: (B, latent_dim) or
        None.  Returns (B, HW, n_out)."""
        if x.dim() < 3:
            x = x[None]
        if self.expand_coords:
            x = expand_coords(x)
        h = self.coord_linear(x)                           # (B, HW, H)
        if self.latent_dim > 0 and z is not None:
            if z.dim() < 2:
                z = z[None]
            h = h + self.latent_linear(z)[:, None, :]
            if self.cfg.bilinear:
                zb = z[:, None, :].expand(x.shape[:2] + (z.shape[-1],))
                h = h + self.bilinear(x, zb)
        return self.tail(h)


def expand_coords(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 5): [x, y, x^2, y^2, x*y]."""
    xy = (x[..., 0] * x[..., 1])[..., None]
    return torch.cat([x, x * x, xy], dim=-1)


def can_fold(cfg: SpatialGeneratorConfig) -> bool:
    return not cfg.expand_coords and not cfg.bilinear


def fold_pose_into_first_layer(gen: SpatialGenerator,
                               theta: Optional[torch.Tensor],
                               dx: Optional[torch.Tensor],
                               z: Optional[torch.Tensor]
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Fold per-image rotation/translation/latent into first-layer weights.

    theta: (B,) or None; dx: (B, 2) (already scaled) or None; z: (B, Z) or
    None.  Returns (w0, w1, c) each (B, H) such that
    ``h[b, p] = x0[p]*w0[b] + x1[p]*w1[b] + c[b]`` equals
    coord_linear(rotate(x)+dx) + latent_linear(z).
    """
    if not can_fold(gen.cfg):
        raise ValueError("expand_coords/bilinear decoders cannot be folded")
    if theta is None and dx is None and z is None:
        # nothing carries a batch dimension to fold over — a pose-free,
        # latent-free decode should pass z=(B, 0) to pick the batch size
        raise ValueError(
            "fold_pose_into_first_layer needs at least one of theta/dx/z "
            "to carry the batch dimension; pass z of shape (B, 0) for a "
            "pose-free latent_dim=0 decode")
    w = gen.coord_linear.weight                        # (H, 2), torch layout
    w0, w1 = w[:, 0], w[:, 1]
    if theta is not None:
        c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        ew0 = c * w0 + s * w1                          # (B, H)
        ew1 = -s * w0 + c * w1
    else:
        nb = dx.shape[0] if dx is not None else z.shape[0]
        one = torch.ones((nb, 1), dtype=w.dtype, device=w.device)
        ew0, ew1 = one * w0, one * w1
    bias = gen.coord_linear.bias
    if dx is not None:
        bias = bias + dx[:, :1] * w0 + dx[:, 1:2] * w1
    else:
        bias = bias.expand(ew0.shape)
    if gen.latent_dim > 0 and z is not None:
        bias = bias + gen.latent_linear(z)             # (B,Z)x(Z,H) GEMM
    return ew0, ew1, bias


def spatial_generator_apply_folded(gen: SpatialGenerator,
                                   coords: torch.Tensor,
                                   theta: Optional[torch.Tensor],
                                   dx: Optional[torch.Tensor],
                                   z: Optional[torch.Tensor]) -> torch.Tensor:
    """coords is the *untransformed* (HW, 2) grid.  Exactly equivalent to
    ``gen(rotate(coords) + dx, z)`` for in_dim=2 decoders."""
    w0, w1, c = fold_pose_into_first_layer(gen, theta, dx, z)
    x0 = coords[:, 0]                                  # (HW,)
    x1 = coords[:, 1]
    h = (x0[None, :, None] * w0[:, None, :]
         + x1[None, :, None] * w1[:, None, :]
         + c[:, None, :])                              # (B, HW, H)
    return gen.tail(h)
