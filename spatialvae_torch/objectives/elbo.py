"""Unified ELBO, forward only — counterpart of ``spatialvae_tpu/objectives/elbo.py``.

This slice covers the Bernoulli likelihood (mnist/galaxy BCE x size) with
the optional pixel mask, the rotation KL with the optional mnist mean
penalty, ``dx_scale``, ``z_scale`` and the unit-normal KL over translation
and z.  The decode follows the JAX package's dispatch, decided from the
config before anything launches: the pose fold, then ``can_fuse_decoder``
and the fused kernel, otherwise the plain folded path or the generic path.

Not ported yet, and refused with ``NotImplementedError`` naming the ROADMAP
item: the gaussian/colored likelihoods and CTF (M7), rotation-augment
offsets (M8), the int8 data paths (M6) and the int8 decoder (Queue 2 K4;
``int8`` only matters with ``fused``, as in the JAX package), the vanilla
generator (M1) and pixel-axis sharding (M10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spatialvae_torch.kernels.fused_decoder import (
    can_fuse_decoder,
    fused_spatial_generator,
)
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    can_fold,
    spatial_generator_apply_folded,
)
from spatialvae_torch.precision import fp32_precision
from spatialvae_torch.transforms.coords import rotate_coords, translate_coords


@dataclass(frozen=True)
class ElboConfig:
    """Same fields and defaults as the JAX package's ElboConfig (which
    cannot be imported without JAX); checkpoints persist it by field name.
    ``fused`` selects the hand-written decoder kernel."""

    rotate: bool = True
    translate: bool = True
    dx_scale: float = 0.1
    theta_prior: float = 3.141592653589793
    theta_mean_penalty: bool = False
    likelihood: str = "bernoulli"          # bernoulli | gaussian | colored
    channels: int = 1
    vanilla: bool = False
    use_fold: bool = True
    fused: bool = False
    int8: bool = False
    fused_loss: bool = True
    fit_noise_interleaved: bool = True


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def decode_spatial(p_net: SpatialGenerator, ecfg: ElboConfig,
                   coords: torch.Tensor, theta: Optional[torch.Tensor],
                   dx: Optional[torch.Tensor],
                   z: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX ELBO's decode dispatch for the spatial generator.
    coords: untransformed (HW, 2) grid; z: (B, Z), possibly (B, 0), sets
    the batch.  Returns (B, HW, n_out)."""
    if ecfg.use_fold and can_fold(p_net.cfg):
        if ecfg.fused and ecfg.int8:
            raise _not_ported("the int8 decoder", "Queue 2 K4, M6")
        if ecfg.fused and can_fuse_decoder(p_net.cfg, coords.shape[0]):
            return fused_spatial_generator(p_net, coords, theta, dx, z)
        return spatial_generator_apply_folded(p_net, coords, theta, dx, z)
    x = coords[None].expand((z.shape[0],) + coords.shape)
    if theta is not None:
        x = rotate_coords(coords, theta)
    if dx is not None:
        x = translate_coords(x, dx)
    return p_net(x, z)


@torch.no_grad()
@fp32_precision()
def elbo_minibatch(
    q_net: InferenceNetwork,
    p_net: SpatialGenerator,
    ecfg: ElboConfig,
    coords: torch.Tensor,                 # (HW, 2) untransformed grid
    y: torch.Tensor,                      # (B, HW) or (B, HW, C)
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,  # (B, zdim) std-normal
    offsets: Optional[torch.Tensor] = None,
    z_scale: float = 1.0,
    ctf: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,   # (HW,) float {0,1} pixel mask
    y_t: Optional[torch.Tensor] = None,
    q_quant=None,
    y_q8=None,
    pixel_axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (elbo, log_p_x_g_z, kl_div, y_hat): 0-d tensors and the
    (B, HW, n_out) decode.  ``noise`` overrides drawing the reparameterised
    sample from ``generator``.  The remaining keywords of the JAX signature
    belong to paths not ported yet and raise."""
    if ecfg.likelihood != "bernoulli":
        raise _not_ported(f"the {ecfg.likelihood} likelihood", "M7")
    if ctf is not None:
        raise _not_ported("CTF", "M7")
    if offsets is not None:
        raise _not_ported("rotation-augment offsets", "M8")
    if y_t is not None or q_quant is not None or y_q8 is not None:
        raise _not_ported("the int8 data paths and encoder", "M6")
    if pixel_axis is not None:
        raise _not_ported("pixel-axis sharding", "M10")
    if ecfg.vanilla:
        raise _not_ported("the vanilla generator", "M1")
    b = y.shape[0]

    # ---- inference + reparameterised sample -------------------------------
    z_mu, z_logstd = q_net(y.reshape(b, -1))
    z_std = torch.exp(z_logstd)
    r = noise if noise is not None else torch.randn(
        z_mu.shape, generator=generator, dtype=z_mu.dtype,
        device=z_mu.device)
    z = z_std * r + z_mu

    kl_div = torch.zeros((b,), dtype=z_mu.dtype, device=z_mu.device)
    theta = dx = None
    if ecfg.rotate:
        theta_mu = z_mu[:, 0]
        theta_std = z_std[:, 0]
        theta_logstd = z_logstd[:, 0]
        theta = z[:, 0]
        z, z_mu, z_std, z_logstd = (z[:, 1:], z_mu[:, 1:], z_std[:, 1:],
                                    z_logstd[:, 1:])
        sigma = ecfg.theta_prior
        kl_rot = (-theta_logstd + math.log(sigma)
                  + theta_std ** 2 / (2.0 * sigma ** 2) - 0.5)
        if ecfg.theta_mean_penalty:
            kl_rot = kl_rot + theta_mu ** 2 / (2.0 * sigma ** 2)
        kl_div = kl_div + kl_rot
    if ecfg.translate:
        dx = z[:, :2] * ecfg.dx_scale
        z = z[:, 2:]
        # z_mu/z_std/z_logstd keep the dx columns: the unit-normal KL
        # below covers translation and z
    z = z * z_scale

    # ---- decode + Bernoulli log-likelihood --------------------------------
    y_hat = decode_spatial(p_net, ecfg, coords, theta, dx, z)
    # -BCE(mean over elements) * size == -(sum BCE)/B; torch's BCE clamps
    # each log term at -100, as the reference relies on
    target = y.reshape(b, -1)
    if mask is not None:
        c = target.shape[1] // mask.shape[0]
        mflat = mask.repeat_interleave(c) if c > 1 else mask
        per = F.binary_cross_entropy(y_hat.reshape(b, -1), target,
                                     reduction="none")
        log_p = -torch.sum(per * mflat[None, :]) / b
    else:
        log_p = -F.binary_cross_entropy(y_hat.reshape(b, -1), target,
                                        reduction="sum") / b

    # ---- unit normal KL over translation + z ------------------------------
    z_kl = -z_logstd + 0.5 * z_std ** 2 + 0.5 * z_mu ** 2 - 0.5
    kl_div = torch.mean(kl_div + torch.sum(z_kl, dim=1))
    return log_p - kl_div, log_p, kl_div, y_hat
