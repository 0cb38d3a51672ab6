"""Unified ELBO and the training loss — counterpart of
``spatialvae_tpu/objectives/elbo.py`` and of ``Trainer._loss`` with
``value_and_grad`` (``spatialvae_tpu/train/trainer.py``).

The port covers the three likelihoods (Bernoulli: mnist/galaxy BCE x size;
Gaussian: the particles' half sum of squares; colored: the fit-noise
``sq/var + logvar`` with the interleaved or the per-channel mean/logvar
split), each with the optional pixel mask, the rotation KL with the
optional mnist mean penalty, ``dx_scale``, ``z_scale`` and the unit-normal
KL over translation and z.  The decode follows the JAX package's dispatch,
decided from the config before anything launches: the pose fold, then with
``fused`` the int8 decoder (``int8``: K4, with K5 as its backward) or the
float kernel (K1/K2), otherwise the plain folded path or the generic path.
In int8 mode a training step whose batch is even takes the fused int8
loss-and-gradient kernel (K3, ``fused_loss_active``) instead of decode +
likelihood, in every family the JAX package sends there (Bernoulli and
Gaussian over an aligned or a padded pixel count, colored with the
interleaved split), with the targets in the kernel's layout (``y_t``: (B,
C, HW), int8 on the /255 grid; colored (B, 2, HW/2)), at the numerics of
``kernels/config.numerics``; under ``SPATIALVAE_LOSS_LAYOUT=t`` a
Bernoulli step without a mask and with float targets takes the
feature-major kernel K8 instead, as in JAX.

The encoder takes the int8 weight copies (``q_quant``) and the batch's
int8 data copy (``y_q8``) as the JAX ELBO does; an explicit encoder view
(``y_inf``, the rotation-augmented images) drops ``y_q8``, and the
augmentation's offsets are added to theta before the decode, so the
generator reconstructs the unrotated pose.  A per-image CTF (cryo-EM
particles) convolves the Gaussian likelihood's predicted mean and, with
the colored likelihood, its variance exp(logvar), while the ``+ logvar``
term keeps the value before the convolution (``ctf/apply.py``, as in JAX);
the Bernoulli likelihood ignores it, as in JAX.  A batch with CTF never
takes the loss kernel: it decodes (K1/K2, or K4/K5 in int8 mode) and the
likelihood runs in PyTorch.

The vanilla generator (``models/vanilla.py``) decodes z alone: the ELBO
infers no pose for it (rotate and translate forced off, as in JAX), never
takes the loss kernel or the int8 decoder, and its products run in
PyTorch, as JAX leaves them to XLA; the int8 encoder copies still apply.

Pixel-axis sharding (``pixel_axis``, the JAX hook of the same name): on a
mesh's model axis each rank passes its slice of the pixels (coords, ``y_t``
and mask) and the axis (``parallel/mesh.Axis``); the loss kernel runs on
the slice (its SR counters from the slice's first pixel on), the loss
value is summed over the axis, so the returned ELBO, log p and KL are the
whole image's on every rank, while the gradient stays the slice's partial
(``parallel/collectives.sum_value``); the KL, computed on every rank, has
its gradient scaled by 1/size with its value unchanged, so that the caller
completes the gradient by summing it over the axis.  It takes the loss
kernel's path alone, with ``y_t``, and raises ``ValueError`` otherwise, as
in JAX.

``elbo_minibatch`` is differentiable; its serving callers take
``torch.no_grad()`` themselves, so serving saves nothing for a backward and
the fused decoder writes no activations.  ``loss_and_grad`` is the one
training loss-and-gradient of the port (the JAX package has it in three
places, ROADMAP M2).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from spatialvae_torch.ctf.apply import apply_ctf
from spatialvae_torch.kernels.fused_decoder import (
    can_fuse_decoder,
    fused_spatial_generator,
)
from spatialvae_torch.kernels.fused_decoder_int8 import (
    can_fuse_int8,
    fused_spatial_generator_int8,
)
from spatialvae_torch.kernels.config import numerics
from spatialvae_torch.kernels.fused_loss_int8 import (
    can_fuse_loss_int8,
    fused_bce_spatial_int8,
)
from spatialvae_torch.kernels.fused_loss_int8_t import (
    fused_bce_spatial_int8_t,
)
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    can_fold,
    spatial_generator_apply_folded,
)
from spatialvae_torch.models.vanilla import VanillaGenerator
from spatialvae_torch.parallel.collectives import sum_value
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


def fused_loss_active(ecfg: ElboConfig, p_cfg, hw: int, batch: int) -> bool:
    """Whether ``elbo_minibatch`` takes the fused int8 loss kernel for this
    config (a training batch without CTF): the JAX package's decision,
    unchanged."""
    if ecfg.vanilla or not (ecfg.fused and ecfg.int8 and ecfg.fused_loss):
        return False
    if (ecfg.likelihood not in ("bernoulli", "gaussian", "colored")
            or not ecfg.use_fold or batch % 2):
        return False
    if ecfg.likelihood == "colored" and not ecfg.fit_noise_interleaved:
        return False
    if not can_fold(p_cfg):
        return False
    return can_fuse_loss_int8(p_cfg, hw, ecfg.likelihood)


def decode_spatial(p_net: SpatialGenerator, ecfg: ElboConfig,
                   coords: torch.Tensor, theta: Optional[torch.Tensor],
                   dx: Optional[torch.Tensor],
                   z: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX ELBO's decode dispatch for the spatial generator.
    coords: untransformed (HW, 2) grid; z: (B, Z), possibly (B, 0), sets
    the batch.  Returns (B, HW, n_out)."""
    if ecfg.use_fold and can_fold(p_net.cfg):
        if ecfg.fused and ecfg.int8 and can_fuse_int8(p_net.cfg,
                                                      coords.shape[0]):
            return fused_spatial_generator_int8(p_net, coords, theta, dx, z)
        if ecfg.fused and can_fuse_decoder(p_net.cfg, coords.shape[0]):
            return fused_spatial_generator(p_net, coords, theta, dx, z)
        return spatial_generator_apply_folded(p_net, coords, theta, dx, z)
    x = coords[None].expand((z.shape[0],) + coords.shape)
    if theta is not None:
        x = rotate_coords(coords, theta)
    if dx is not None:
        x = translate_coords(x, dx)
    return p_net(x, z)


def decode(p_net, ecfg: ElboConfig, coords: torch.Tensor,
           theta: Optional[torch.Tensor], dx: Optional[torch.Tensor],
           z: torch.Tensor) -> torch.Tensor:
    """``decode_spatial``, or z alone through a ``VanillaGenerator`` (which
    takes no pose).  Returns (B, HW, n_out), (B, n, n_out) for vanilla."""
    if isinstance(p_net, VanillaGenerator):
        return p_net(z)
    return decode_spatial(p_net, ecfg, coords, theta, dx, z)


def _channel_mask(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The (HW,) pixel mask over n = HW*C pixel-major elements."""
    c = n // mask.shape[0]
    return mask.repeat_interleave(c) if c > 1 else mask


def _bce_sum(p: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(weight * BCE(p, target)) through torch's ``binary_cross_entropy``
    (each log term clamped at -100, its backward), bit for bit, except
    where ``p`` or ``target`` lies outside [0, 1], as a NaN decode or a NaN
    image does: there the sum is NaN, with a NaN gradient at those
    elements, as the JAX package's BCE gives, where torch's refuses the
    input (an error on the CPU, a device-side assert on the card)."""
    bad = ~((p >= 0) & (p <= 1) & (target >= 0) & (target <= 1))
    safe, safe_t = torch.where(bad, 0.5, p), torch.where(bad, 0.5, target)
    if weight is None:
        s = F.binary_cross_entropy(safe, safe_t, reduction="sum")
    else:
        s = torch.sum(F.binary_cross_entropy(safe, safe_t, reduction="none")
                      * weight)
    nan = torch.where(bad, torch.where(bad, p, 0.5) * float("nan"), 0.0)
    return s + torch.sum(nan)


def _bernoulli_log_p(y_hat, y, mask) -> torch.Tensor:
    """-BCE(mean over elements) * size == -(sum BCE)/B; torch's BCE clamps
    each log term at -100, as the reference relies on (``_bce_sum``: a NaN
    decode gives a NaN loss).  Mixed dtypes promote as in JAX (bf16
    targets against the f32 output of the fused decoder)."""
    b = y.shape[0]
    dt = torch.promote_types(y_hat.dtype, y.dtype)
    y_hat, target = y_hat.to(dt), y.reshape(b, -1).to(dt)
    weight = (None if mask is None
              else _channel_mask(mask, target.shape[1])[None, :])
    return -_bce_sum(y_hat.reshape(b, -1), target, weight) / b


def _gaussian_log_p(y_hat, y, mask, interleaved: bool, ctf=None,
                    image_shape=None) -> tuple:
    """The Gaussian and colored log-likelihoods, (log_p, predicted mean
    (B, HW*C, 1)).  A decode wider than the data is the fit-noise head
    (n_out == 2): ``interleaved`` splits its flattened (B, 2*HW) output at
    HW into mean and log-variance (the reference's split), otherwise channel
    0 is the mean and channel 1 the log-variance.  log_p = -0.5 *
    mean_b(sum(mask * (sq / var + logvar))), without the variance terms for
    the plain Gaussian.  ``ctf`` (B, kn, km) convolves the mean and var =
    exp(logvar) over the (n, m) ``image_shape``; logvar keeps its value
    before the convolution (the reference's order).  Mixed dtypes promote
    as in JAX."""
    b = y.shape[0]
    y_flat = y.reshape(b, -1)
    hw = y_flat.shape[1]
    yp = y_hat.reshape(b, -1)
    y_logvar = None
    if yp.shape[1] > hw:
        if interleaved:
            y_mu, y_logvar = yp[:, :hw], yp[:, hw:]
        else:
            y_mu, y_logvar = y_hat[..., 0], y_hat[..., 1]
    else:
        y_mu = yp
    y_var = None if y_logvar is None else torch.exp(y_logvar)
    if ctf is not None:
        if image_shape is None:
            raise ValueError("CTF needs the image shape (n, m)")
        n, m = image_shape
        y_mu = apply_ctf(y_mu.reshape(b, n, m), ctf).reshape(b, hw)
        if y_var is not None:
            y_var = apply_ctf(y_var.reshape(b, n, m), ctf).reshape(b, hw)
    per = (y_mu - y_flat) ** 2
    if y_var is not None:
        per = per / y_var + y_logvar
    if mask is not None:
        per = per * _channel_mask(mask, per.shape[1])[None, :]
    log_p = -0.5 * torch.mean(torch.sum(per, dim=1))
    return log_p, y_mu.reshape(b, -1)[..., None]


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
    y_inf: Optional[torch.Tensor] = None,  # encoder view (default y)
    offsets: Optional[torch.Tensor] = None,  # (B,) augmentation angles
    z_scale: float = 1.0,
    ctf: Optional[torch.Tensor] = None,    # (B, kn, km) per-image kernels
    mask: Optional[torch.Tensor] = None,   # (HW,) float {0,1} pixel mask
    image_shape: Optional[Tuple[int, int]] = None,  # (n, m), for CTF
    want_y_hat: bool = False,             # display paths need the decode
    y_t: Optional[torch.Tensor] = None,   # (B, C, HW) targets for K3
    q_quant=None,                         # int8 encoder weight entries
    y_q8=None,                            # (xq (B, n) int8, sx) data batch
    pixel_axis=None,                      # parallel.mesh.Axis of a pixel shard
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (elbo, log_p_x_g_z, kl_div, y_hat): 0-d tensors and the
    (B, HW, n_out) decode (for the Gaussian and colored likelihoods the
    predicted mean, (B, HW*C, 1)), which is None on the fused int8 loss
    path (pass ``want_y_hat=True`` to force the decode).  ``noise``
    overrides drawing the reparameterised sample from ``generator``.
    ``q_quant`` and ``y_q8`` go to the encoder
    (``InferenceNetwork.forward``'s ``qw`` and ``y_q8``); ``y_inf`` is the
    encoder's view (the augmented images), ``offsets`` the augmentation's
    angles, added to theta; ``ctf`` the batch's CTF kernels, over the (n,
    m) ``image_shape``.  ``p_net`` may be a ``VanillaGenerator``, with
    ``ecfg.vanilla`` set.  ``pixel_axis``: coords, y_t and mask are this
    rank's pixel slice of the grid along that mesh axis (see the module
    docstring)."""
    if ecfg.vanilla != isinstance(p_net, VanillaGenerator):
        raise ValueError(f"ElboConfig(vanilla={ecfg.vanilla}) with a "
                         f"{type(p_net).__name__}")
    b = y.shape[0]
    if y_inf is None:
        y_inf = y
    else:
        y_q8 = None      # another encoder view: the data copy does not apply

    # ---- inference + reparameterised sample -------------------------------
    z_mu, z_logstd = q_net(y_inf.reshape(b, -1), qw=q_quant, y_q8=y_q8)
    z_std = torch.exp(z_logstd)
    r = noise if noise is not None else torch.randn(
        z_mu.shape, generator=generator, dtype=z_mu.dtype,
        device=z_mu.device)
    z = z_std * r + z_mu

    kl_div = torch.zeros((b,), dtype=z_mu.dtype, device=z_mu.device)
    theta = dx = None
    # the vanilla generator takes no pose: its latents are z alone
    rotate = ecfg.rotate and not ecfg.vanilla
    translate = ecfg.translate and not ecfg.vanilla
    if rotate:
        theta_mu = z_mu[:, 0]
        theta_std = z_std[:, 0]
        theta_logstd = z_logstd[:, 0]
        theta = z[:, 0]
        z, z_mu, z_std, z_logstd = (z[:, 1:], z_mu[:, 1:], z_std[:, 1:],
                                    z_logstd[:, 1:])
        if offsets is not None:
            # undo the augmentation's rotation, so that the generator
            # reconstructs the observed pose
            theta = theta + offsets
        sigma = ecfg.theta_prior
        kl_rot = (-theta_logstd + math.log(sigma)
                  + theta_std ** 2 / (2.0 * sigma ** 2) - 0.5)
        if ecfg.theta_mean_penalty:
            kl_rot = kl_rot + theta_mu ** 2 / (2.0 * sigma ** 2)
        kl_div = kl_div + kl_rot
    if translate:
        dx = z[:, :2] * ecfg.dx_scale
        z = z[:, 2:]
        # z_mu/z_std/z_logstd keep the dx columns: the unit-normal KL
        # below covers translation and z
    z = z * z_scale

    # ---- fused int8 loss-and-gradient path (K3, or K8) --------------------
    fused_path = not want_y_hat and ctf is None and fused_loss_active(
        ecfg, p_net.cfg, coords.shape[0], b)
    if pixel_axis is not None and (not fused_path or y_t is None):
        raise ValueError(
            "pixel_axis requires the fused int8 loss-kernel path with the "
            "targets' pixel slice y_t (the trainer takes the pixel step only "
            "where fused_loss_active holds for the slice's shapes; y is the "
            "whole image here, so the kernel must not build y_t from it)")
    if fused_path:
        if (numerics().layout == "t" and ecfg.likelihood == "bernoulli"
                and mask is None and pixel_axis is None
                and (y_t is None or y_t.dtype != torch.int8)):
            # the feature-major kernel, under the JAX package's conditions
            # (it predates int8 targets and the masked families)
            loss = fused_bce_spatial_int8_t(p_net, coords, theta, dx, z, y,
                                            y_t=y_t)
        else:
            p_base = (0 if pixel_axis is None
                      else pixel_axis.index * coords.shape[0])
            loss = fused_bce_spatial_int8(p_net, coords, theta, dx, z, y,
                                          y_t=y_t, mask=mask,
                                          family=ecfg.likelihood,
                                          p_base=p_base)
        if pixel_axis is not None:
            # the slices' partials sum to the whole loss: the value is the
            # whole image's, the gradient the slice's
            loss = sum_value(loss, pixel_axis)
        log_p = -loss / b
        z_kl = -z_logstd + 0.5 * z_std ** 2 + 0.5 * z_mu ** 2 - 0.5
        kl_div = torch.mean(kl_div + torch.sum(z_kl, dim=1))
        if pixel_axis is not None:
            # every rank computes the KL; the caller sums the gradients over
            # the axis, so its gradient is scaled to 1/size (value kept)
            inv = 1.0 / pixel_axis.size
            kl_obj = kl_div * inv + (kl_div * (1.0 - inv)).detach()
            return log_p - kl_obj, log_p, kl_div, None
        return log_p - kl_div, log_p, kl_div, None

    # ---- decode + reconstruction log-likelihood ---------------------------
    y_hat = decode(p_net, ecfg, coords, theta, dx, z)
    if ecfg.likelihood == "bernoulli":
        log_p = _bernoulli_log_p(y_hat, y, mask)
    else:
        log_p, y_hat = _gaussian_log_p(y_hat, y, mask,
                                       ecfg.fit_noise_interleaved, ctf,
                                       image_shape)

    # ---- unit normal KL over translation + z ------------------------------
    z_kl = -z_logstd + 0.5 * z_std ** 2 + 0.5 * z_mu ** 2 - 0.5
    kl_div = torch.mean(kl_div + torch.sum(z_kl, dim=1))
    return log_p - kl_div, log_p, kl_div, y_hat


class _Pair(torch.nn.Module):
    """q and p under one module, so ``functional_call`` can hand both the
    compute-dtype copies of their parameters."""

    def __init__(self, q_net, p_net):
        super().__init__()
        self.q, self.p = q_net, p_net

    def forward(self, *args, **kwargs):
        return elbo_minibatch(self.q, self.p, *args, **kwargs)


def loss_terms(q_net: InferenceNetwork, p_net: SpatialGenerator,
               ecfg: ElboConfig, coords: torch.Tensor, y: torch.Tensor, *,
               params: Optional[Dict[str, torch.Tensor]] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               z_scale: float = 1.0, mask: Optional[torch.Tensor] = None,
               y_t: Optional[torch.Tensor] = None, q_quant=None, y_q8=None,
               y_inf: Optional[torch.Tensor] = None,
               offsets: Optional[torch.Tensor] = None,
               ctf: Optional[torch.Tensor] = None,
               image_shape: Optional[Tuple[int, int]] = None,
               compute_dtype: torch.dtype = torch.float32,
               pixel_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training loss, ``Trainer._loss`` of the JAX package: params, y and
    coords in ``compute_dtype`` (so a bf16 run decodes over the bf16-rounded
    grid), then the ELBO.  ``params``: a dict of ``q.<name>``/``p.<name>``
    -> tensor that stands in for the modules' parameters (the trainer's
    bf16 shadow, already in the compute dtype); without it the modules'
    parameters are cast.  ``y_t`` (the batch's targets in the loss kernel's
    layout), ``q_quant``, ``y_q8``, the augmented encoder view ``y_inf``
    (in the compute dtype), its ``offsets`` and ``pixel_axis`` (with coords,
    mask and y_t a pixel slice) pass as they are; ``ctf`` is
    cast to the compute dtype, as in JAX (so bf16 compute raises at the
    FFT, as XLA's does).  Returns (loss = -elbo, aux = [elbo, -log_p,
    kl]), float32.  Differentiable; the evaluation runs it under
    no_grad."""
    y = y.to(compute_dtype)
    coords = coords.to(compute_dtype)
    pair = _Pair(q_net, p_net)
    if params is None and any(p.dtype != compute_dtype
                              for p in pair.parameters()):
        params = dict(pair.named_parameters())
    kw = dict(noise=noise, z_scale=z_scale, mask=mask, y_t=y_t,
              q_quant=q_quant, y_q8=y_q8, y_inf=y_inf, offsets=offsets,
              ctf=None if ctf is None else ctf.to(compute_dtype),
              image_shape=image_shape, pixel_axis=pixel_axis)
    args = (ecfg, coords, y, generator)
    if params is None:
        elbo, log_p, kl, _ = pair(*args, **kw)
    else:
        params = {k: v.to(compute_dtype) for k, v in params.items()}
        elbo, log_p, kl, _ = functional_call(pair, params, args, kw)
    aux = torch.stack([elbo.float(), -log_p.float(), kl.float()])
    return -elbo.float(), aux


def loss_and_grad(q_net: InferenceNetwork, p_net: SpatialGenerator,
                  ecfg: ElboConfig, coords: torch.Tensor, y: torch.Tensor,
                  *, params: Optional[Dict[str, torch.Tensor]] = None,
                  **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """``loss_terms`` (its keywords in ``kw``) and its gradient
    (``value_and_grad(Trainer._loss)``): returns (loss, aux) detached and
    leaves d loss / d param on the ``.grad`` of each tensor of ``params``
    (the shadow: bf16 gradients), or of each module parameter without it
    (earlier gradients are dropped, not summed).  ``noise`` injects the
    reparameterisation draw; without it the draw comes from
    ``generator``."""
    leaves = (params.values() if params is not None else
              [p for net in (q_net, p_net) for p in net.parameters()])
    for p in leaves:
        p.grad = None
    with torch.enable_grad():
        loss, aux = loss_terms(q_net, p_net, ecfg, coords, y, params=params,
                               **kw)
        loss.backward()
    return loss.detach(), aux.detach()
