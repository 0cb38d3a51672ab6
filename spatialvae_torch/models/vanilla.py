"""VanillaGenerator — the baseline MLP decoder z -> every pixel at once.

Counterpart of ``spatialvae_tpu/models/vanilla.py``: ``Linear(z, H), act,
[Linear(H, H), act | ResidLinear] * (L - 1), Linear(H, n * n_out),
Sigmoid`` and, with ``softplus``, an appended ``Softplus``.  The decoder
ignores the coordinates, so the ELBO infers no rotation or translation for
it.

The reference's quirk is kept: with ``softplus`` the appended layer applies
softplus to every output, and the forward applies it once more to channel
0, so channel 0 gets softplus twice and the others once.

Its products are plain MLP products, which the JAX package also leaves to
XLA; here they are ``nn.Linear`` (cuBLAS on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from spatialvae_torch.config import VanillaGeneratorConfig
from spatialvae_torch.nn.layers import mlp, stack_linears


class VanillaGenerator(nn.Module):
    """``layers`` is the reference's ``nn.Sequential`` (same state_dict
    keys); ``n_out`` and ``softplus`` are its attributes."""

    def __init__(self, cfg: VanillaGeneratorConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.n = cfg.n
        self.n_out = cfg.n_out
        self.softplus = cfg.softplus
        self.latent_dim = cfg.latent_dim
        dims = ([cfg.latent_dim] + [cfg.hidden_dim] * cfg.num_layers
                + [cfg.n * cfg.n_out])
        self.layers = mlp(dims, cfg.activation, cfg.resid,
                          generator=generator, device=device, dtype=dtype)
        self.layers.append(nn.Sigmoid())
        if cfg.softplus:
            self.layers.append(nn.Softplus())

    def linears(self):
        """The stack's ``nn.Linear``s in order, the head last."""
        return stack_linears(self.layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, latent_dim) -> (B, n, n_out).  A z wider than the weights
        (an f32 draw against bf16 weights) promotes them, as JAX's
        mixed-dtype products do."""
        w = self.linears()[0].weight
        if torch.promote_types(z.dtype, w.dtype) != w.dtype:
            y = functional_call(self.layers, {
                k: v.to(z.dtype) for k, v in self.layers.named_parameters()},
                (z,))
        else:
            y = self.layers(z)
        y = y.reshape(z.shape[0], -1, self.n_out)
        if self.softplus:                       # channel 0 a second time
            y = torch.cat([F.softplus(y[..., :1]), y[..., 1:]], dim=-1)
        return y
