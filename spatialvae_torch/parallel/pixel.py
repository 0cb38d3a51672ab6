"""Pixel-axis sharding of the fused int8 loss kernel — counterpart of
``spatialvae_tpu/parallel/pixel.py``.

Every output of K3 is a sum over pixel groups (the loss, dfold, dW1, db1,
dWh^T, dbh), and its quantisation scales are per group or computed on the
host from the weights, so running the unchanged kernel on a contiguous
slice of the pixels on each rank of the model axis and summing is the
whole call with the groups' partials added in another order: each rank's
slice holds whole groups (``can_pixel_shard``).  Under stochastic rounding
a slice draws the words the whole call draws for its pixels: the kernel
takes the slice's first pixel, ``p_base``, for its counters.

The colored family cannot shard its pixels: its chunk-permuted coords pair
each pixel with rows from the other half of its group, which a contiguous
slice does not hold.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialvae_torch.kernels.fused_loss_int8 import (
    fused_decoder_bce_int8,
    hw_tiles_ok,
)
from spatialvae_torch.models.spatial import fold_pose_into_first_layer
from spatialvae_torch.parallel.collectives import sum_grad, sum_value


def can_pixel_shard(hw: int, n_shards: int) -> bool:
    """Each shard must still meet the kernel's tiling (``hw_tiles_ok``)."""
    return hw % n_shards == 0 and hw_tiles_ok(hw // n_shards)


def config_refusal(ecfg) -> Optional[str]:
    """What keeps a configuration off the pixel step whatever its shapes
    (its flags alone, known before any data), or None.  The step runs K3,
    so it needs fused int8 mode with the loss kernel, the spatial
    generator and a Bernoulli or Gaussian likelihood."""
    for why, off in (("the vanilla generator", ecfg.vanilla),
                     ("the plain decoder", not ecfg.fused),
                     ("a float decoder", not ecfg.int8),
                     ("the loss kernel off", not ecfg.fused_loss),
                     ("the colored likelihood", ecfg.likelihood == "colored")):
        if off:
            return why
    return None


def pixel_step_refusal(ecfg, p_cfg, batch: int, hw: int,
                       mesh_shape: dict) -> Optional[str]:
    """Why a mesh of ``mesh_shape`` ({"data": d, "model": m}, m > 1)
    cannot take the pixel step, or None: the JAX ``_pixel_spmd_ok``, K3
    active for a rank's share (batch / d rows, hw / m pixels in
    tile-aligned slices), the configuration's reasons first
    (``config_refusal``)."""
    from spatialvae_torch.objectives.elbo import fused_loss_active

    why = config_refusal(ecfg)
    if why is not None:
        return why
    nd, nm = mesh_shape["data"], mesh_shape["model"]
    if batch % nd:
        return f"a minibatch of {batch} over {nd} data ranks"
    if not can_pixel_shard(hw, nm):
        return f"{hw} pixels in {nm} tile-aligned slices"
    if not fused_loss_active(ecfg, p_cfg, hw // nm, batch // nd):
        return (f"K3 off for a rank's {batch // nd} images of {hw // nm} "
                f"pixels")
    return None


def pixel_slice(hw: int, axis) -> slice:
    """The pixels of ``axis``' index among its ``size`` contiguous
    slices of ``hw``."""
    per = hw // axis.size
    return slice(axis.index * per, (axis.index + 1) * per)


def make_pixel_sharded_loss(p_cfg, mesh, *, axis: str = "model",
                            family: str = "bernoulli"):
    """loss(p_net, coords, theta, dx, z, y_t, mask=None): the fused int8
    kernel's summed reconstruction loss with the pixel axis sharded over
    ``axis``, on every rank of it.  coords (HW, 2), y_t (B, C, HW) and mask
    (HW,) are the whole grid's: each rank runs the kernel on its slice.
    Differentiable like the one-device op: the gradients of p_net's
    parameters and of theta, dx and z are the whole call's on every rank
    (the replicated operands' cotangents are summed over the axis, as
    ``shard_map`` sums them)."""
    if family not in ("bernoulli", "gaussian"):
        raise ValueError(f"family {family!r}: the colored family cannot "
                         f"shard its pixels")
    ax = mesh.axis(axis)

    def loss(p_net, coords: torch.Tensor, theta, dx, z, y_t: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hw = coords.shape[0]
        if not can_pixel_shard(hw, ax.size):
            raise ValueError(f"HW={hw} does not shard over {ax.size} ranks "
                             f"into tile-aligned slices")
        sl = pixel_slice(hw, ax)
        w0, w1f, c = fold_pose_into_first_layer(p_net, theta, dx, z)
        fold = torch.stack([w0, w1f, c, torch.zeros_like(c)], dim=1)
        fold = sum_grad(fold.float().contiguous(), ax)
        hidden, head = p_net.linears()
        w1, b1, wht, bht = (sum_grad(t, ax) for t in (
            hidden.weight.T.contiguous(), hidden.bias,
            head.weight.contiguous(), head.bias))
        part = fused_decoder_bce_int8(
            fold, coords[sl].float().contiguous(), w1, b1, wht, bht,
            y_t[..., sl].contiguous(),
            None if mask is None else mask[sl].float().contiguous(), family,
            p_base=sl.start)
        return sum_value(part, ax)

    return loss
