"""Inference (encoder) network q(z|y).

Counterpart of ``spatialvae_tpu/models/inference.py``: flat image
(pixels*channels) -> [hidden, act] * num_layers (hidden->hidden layers
optionally residual) -> 2*latent_dim, split into (z_mu, z_logstd).

In full precision the galaxy encoder's (B, 12288)x(12288, 5000) and
(5000, 5000) products are plain large GEMMs, which the JAX package leaves
to XLA and the port to ``nn.Linear``.  With ``qw`` (the int8 weight copies
the Adam pass emits) the hidden layers run on int8 (``nn/qlinear.py``), as
``inference_apply``'s ``qw``/``y_q8`` branch does; ``inference_apply_q8``
quantises every hidden layer per call.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spatialvae_torch.config import InferenceConfig
from spatialvae_torch.nn.layers import mlp, resolve_activation, stack_linears
from spatialvae_torch.nn.qlinear import qlinear, qlinear_pre, qlinear_pre_xq


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

    def forward(self, y: torch.Tensor, qw: Optional[Sequence[dict]] = None,
                y_q8=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """y: (B, n) -> (z_mu, z_logstd), each (B, latent_dim).

        ``qw``: entries aligned with the hidden linears ({"q": int8 copy in
        the weight's (out, in) layout, "s": its scale}; an empty "q" keeps
        that layer in full precision).  ``y_q8``: (xq (B, n) int8, sx), the
        batch quantised once per dataset, which layer 0 then reads in place
        of y."""
        if qw is None or not any(e["q"].numel() for e in qw):
            z = self.layers(y)
        else:
            z = self._forward_q(y, qw, y_q8)
        ld = self.latent_dim
        return z[:, :ld], z[:, ld:]

    def _forward_q(self, y, qw, y_q8) -> torch.Tensor:
        cfg = self.cfg
        act = resolve_activation(cfg.activation)
        linears = stack_linears(self.layers)
        # tanh outputs lie in [-1, 1]: the hidden layers' inputs take the
        # static scale 1/127; sigmoid (and resid) keep the dynamic max
        bound = 1.0 if cfg.activation == "tanh" and not cfg.resid else None
        x = y
        for i, lin in enumerate(linears[:-1]):
            e = qw[i] if i < len(qw) else None
            quantised = e is not None and e["q"].numel() > 0
            if i == 0 and y_q8 is not None and quantised:
                h = qlinear_pre_xq(y_q8[0], y_q8[1], lin.weight, lin.bias,
                                   e["q"], e["s"])
            elif quantised:
                h = qlinear_pre(x, lin.weight, lin.bias, e["q"], e["s"],
                                None if i == 0 else bound)
            else:
                h = F.linear(x, lin.weight, lin.bias)
            if cfg.resid and i > 0:
                h = h + x
            x = act(h)
        return F.linear(x, linears[-1].weight, linears[-1].bias)


def inference_apply_q8(net: InferenceNetwork, y: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``inference_apply_q8``: every hidden layer through
    ``qlinear`` (weights and inputs quantised per call), the output head in
    full precision."""
    cfg = net.cfg
    act = resolve_activation(cfg.activation)
    linears = stack_linears(net.layers)
    x = y
    for i, lin in enumerate(linears[:-1]):
        h = qlinear(x, lin.weight, lin.bias)
        if cfg.resid and i > 0:
            h = h + x
        x = act(h)
    z = F.linear(x, linears[-1].weight, linears[-1].bias)
    ld = net.latent_dim
    return z[:, :ld], z[:, ld:]
