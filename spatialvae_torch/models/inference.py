"""Inference (encoder) network q(z|y).

Counterpart of ``spatialvae_tpu/models/inference.py`` (its full-precision
branch): flat image (pixels*channels) -> [hidden, act] * num_layers
(hidden->hidden layers optionally residual) -> 2*latent_dim, split into
(z_mu, z_logstd).  The galaxy encoder's (B, 12288)x(12288, 5000) and
(5000, 5000) products are plain large GEMMs, which the JAX package leaves to
XLA and the port leaves to ``nn.Linear``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from spatialvae_torch.config import InferenceConfig
from spatialvae_torch.nn.layers import mlp


class InferenceNetwork(nn.Module):
    """``layers`` is the reference's ``nn.Sequential`` (same state_dict keys)."""

    def __init__(self, cfg: InferenceConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.n = cfg.n
        self.latent_dim = cfg.latent_dim
        dims = ([cfg.n] + [cfg.hidden_dim] * cfg.num_layers
                + [2 * cfg.latent_dim])
        self.layers = mlp(dims, cfg.activation, cfg.resid,
                          generator=generator, device=device, dtype=dtype)

    def forward(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """y: (B, n) -> (z_mu, z_logstd), each (B, latent_dim)."""
        z = self.layers(y)
        ld = self.latent_dim
        return z[:, :ld], z[:, ld:]
