"""The feature-major int8 loss kernel (K8): the Bernoulli loss and every
decoder gradient in one call, as modes of K3's hand-written sm_90a kernels.

Counterpart of ``spatialvae_tpu/kernels/fused_loss_int8_t.py`` (Pallas
``_kernel_t`` through ``_lossgrad_pallas_t`` and the custom VJP
``fused_decoder_bce_int8_t``), which ``SPATIALVAE_LOSS_LAYOUT=t`` selects
for the Bernoulli steps without a pixel mask and with float targets.  Its
layout (activations (H, Pt) instead of (Pt, H), H padded to a multiple of
32) serves the TPU's int4 contraction patterns; its numbers are K3's at
``SPATIALVAE_INT4_GRADS_T`` ``i4`` (K3's ``da0_i4``) or ``i8``, the tile
gradient scale and the bf16 epilogue, with two differences:

- db1 is the sum of the ROUNDED gradient tile, sum_p qi * sg: the TPU kernel
  makes it row H of the dW1 product through a pad row of the fold whose
  activation quantises to the constant K (1 at 4 bits, 18 at 8), and
  undoes K after the call (JAX ``:375-378``).  The port keeps the number,
  (K * sum_p qi) * (sg/lv) summed over groups and times lv/K, without the
  pad row;
- in ``i4`` mode dW1 takes the 4-bit a0, clip(round(7*a0), -7, 7), with the
  dequant step sg/7; the forward and tanh' use the int8 a0 (round(127*a0),
  step 1/127).

Its groups are ``pick_tile`` of the unpadded pixel count: mnist's 784 pixels
are one group of 784 (K3 pads them to 1024).  On the card the image is
zero-padded to a multiple of 64 pixels with a mask that is 0 on the pad, so
the pad adds nothing and the group is the unpadded one.  The TPU kernel has
no stochastic rounding: with ``SPATIALVAE_SR=1`` its steps round to nearest,
as in JAX.

``loss_int8_t_reference`` is the plain version; ``run_loss_int8_t`` takes
it for CPU tensors and launches K3's kernels in K8's modes for CUDA
tensors, or raises.  Outputs are the JAX ``_lossgrad_pallas_t``'s: dfoldT
(B, H, 4) with the per-image loss at [:, 0, 3], dW1, db1 (H,), dWh^T, dbh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from spatialvae_torch.kernels.config import Numerics, numerics
from spatialvae_torch.kernels.fused_decoder_int8 import (
    BLOCK_PIXELS,
    MAX_OUT,
    WEIGHT_DTYPES,
)
from spatialvae_torch.kernels.fused_loss_int8 import (
    launch_loss,
    loss_reference,
    pick_tile,
)
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    fold_pose_into_first_layer,
)

MODES = ("i4", "i8")

# Launches on CUDA tensors, K3's passes in K8's modes: the forward, the
# gradient pass, the split-K dW1 and the fixed-order reductions.
LAUNCHES = {"fwd": 0, "grad": 0, "dw": 0, "sum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def t_numerics(mode: str) -> Numerics:
    """K3's numerics that K8's mode shares: the int8 forward with per-tensor
    int8 W1, the tile scale, the bf16 epilogue, round to nearest; the
    gradient tile at 4 bits (``i4``, da0 on per-row 4-bit W1) or 8."""
    return Numerics(grad_mode="da0_i4" if mode == "i4" else "i8",
                    gscale="tile")


def _mode(mode: Optional[str]) -> str:
    """The environment's ``SPATIALVAE_INT4_GRADS_T``, checked
    (``kernels/config.numerics``), or the caller's."""
    m = numerics().grad_mode_t if mode is None else mode
    if m not in MODES:
        raise ValueError(f"mode {m!r}; expected one of {MODES}")
    return m


def _check(fold_t, coords, w1, b1, wht, bht, y_t) -> None:
    if w1.dim() != 2 or w1.shape[0] != w1.shape[1]:
        raise ValueError(f"w1 must be (H, H), got {tuple(w1.shape)}")
    h = w1.shape[0]
    if wht.dim() != 2 or wht.shape[1] != h:
        raise ValueError(f"wht must be (No, H={h}), got {tuple(wht.shape)}")
    no = wht.shape[0]
    if not 1 <= no <= MAX_OUT or h < 1:
        raise ValueError(f"n_out={no}, H={h}; the kernels take 1 <= n_out "
                         f"<= {MAX_OUT} and H >= 1")
    if tuple(b1.shape) != (h,) or tuple(bht.shape) != (no,):
        raise ValueError("b1 must be (H,) and bht (No,)")
    if w1.dtype not in WEIGHT_DTYPES or any(
            t.dtype != w1.dtype for t in (b1, wht, bht)):
        raise TypeError("weights must be all float32 or all bfloat16")
    if fold_t.dim() != 3 or fold_t.shape[1:] != (h, 4) or fold_t.shape[0] < 1:
        raise ValueError(f"foldT must be (B, H={h}, 4), got "
                         f"{tuple(fold_t.shape)}")
    b, hw = fold_t.shape[0], coords.shape[0]
    if b % 2:
        raise ValueError(f"batch {b}: the loss kernel takes even batches")
    if coords.dim() != 2 or coords.shape[1] != 2 or hw % pick_tile(hw):
        raise ValueError(f"coords must be (HW, 2) with HW tiled, got "
                         f"{tuple(coords.shape)}")
    if (y_t.dim() != 3 or y_t.shape[:2] != (b, no) or y_t.shape[2] < hw
            or y_t.dtype == torch.int8):
        raise ValueError(f"y_t must be float (B, No, >= HW) = ({b}, {no}, "
                         f">= {hw}), got {y_t.dtype} {tuple(y_t.shape)}")
    devices = {t.device for t in (fold_t, coords, w1, b1, wht, bht, y_t)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if fold_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fold_t.device}")


def _row_outputs(out: tuple) -> tuple:
    """K3's (dfold (B, 4, H) with the loss at [:, 3, 0], ...) -> K8's
    (dfoldT (B, H, 4), the loss moving to [:, 0, 3], ...)."""
    return (out[0].transpose(1, 2).contiguous(),) + tuple(out[1:])


def loss_int8_t_reference(fold_t, coords, w1, b1, wht, bht, y_t,
                          mode: str = "i4") -> tuple:
    """Plain version of K8.  fold_t (B, H, 4) f32 columns [w0, w1, c, 0];
    coords (HW, 2); weights as K3's; y_t (B, No, HW or more) float targets
    (columns past HW are ignored).  Returns float32 (dfoldT (B, H, 4) with
    the per-image BCE at [:, 0, 3], dW1 (H, H), db1 (H,), dWh^T (No, H), dbh
    (No,))."""
    hw = coords.shape[0]
    fold = fold_t.transpose(1, 2).float().contiguous()
    return _row_outputs(loss_reference(
        fold, coords.float(), w1, b1, wht, bht, y_t[:, :, :hw].float(), None,
        "bernoulli", t_numerics(mode), pick_tile(hw), mode))


def run_loss_int8_t(fold_t, coords, w1, b1, wht, bht, y_t,
                    mode: Optional[str] = None,
                    workspace_bytes: Optional[int] = None) -> tuple:
    """K8's five outputs (see ``loss_int8_t_reference``) in ``mode``
    (default ``SPATIALVAE_INT4_GRADS_T``).  CPU tensors take the plain
    version; CUDA tensors launch K3's kernels in K8's modes, counting each
    launch in this module's ``LAUNCHES``, and raise if the build or a launch
    fails."""
    _check(fold_t, coords, w1, b1, wht, bht, y_t)
    mode = _mode(mode)
    if fold_t.device.type == "cpu":
        return loss_int8_t_reference(fold_t, coords, w1, b1, wht, bht, y_t,
                                     mode)
    hw = coords.shape[0]
    pad = -hw % BLOCK_PIXELS
    fold = fold_t.transpose(1, 2).float().contiguous()
    coords = coords.float()
    y = y_t[:, :, :hw].float()
    mask = None
    pt = pick_tile(hw)
    if pad:
        # one group of the whole image (pick_tile gave hw): its pad pixels
        # are masked out, so it holds the unpadded group's numbers
        coords = F.pad(coords, (0, 0, 0, pad))
        y = F.pad(y, (0, pad))
        mask = F.pad(torch.ones((hw,), device=coords.device), (0, pad))
        pt = hw + pad
    return _row_outputs(launch_loss(
        fold, coords.contiguous(), w1, b1, wht, bht, y.contiguous(), mask,
        "bernoulli", t_numerics(mode), pt, mode, workspace_bytes, False,
        LAUNCHES))


class _LossInt8T(torch.autograd.Function):
    """Counterpart of the JAX ``fused_decoder_bce_int8_t`` custom VJP: the
    forward returns the summed BCE and keeps the five gradients it computed;
    the backward scales them by the scalar cotangent."""

    @staticmethod
    def forward(ctx, fold_t, coords, w1, b1, wht, bht, y_t):
        grads = run_loss_int8_t(fold_t, coords, w1, b1, wht, bht, y_t)
        ctx.save_for_backward(*grads)
        ctx.dtypes = (fold_t.dtype, w1.dtype, b1.dtype, wht.dtype, bht.dtype)
        return grads[0][:, 0, 3].sum()

    @staticmethod
    def backward(ctx, g):
        grads = ctx.saved_tensors
        dfold, dw1, db1, dwht, dbht = (
            (g * t).to(dt) for t, dt in zip(grads, ctx.dtypes))
        return dfold, None, dw1, db1, dwht, dbht, None


def fused_decoder_bce_int8_t(fold_t, coords, w1, b1, wht, bht,
                             y_t) -> torch.Tensor:
    """The summed Bernoulli BCE of the int8 decoder, with its gradients
    computed in the same call (see ``_LossInt8T``)."""
    return _LossInt8T.apply(fold_t, coords, w1, b1, wht, bht, y_t)


def fused_bce_spatial_int8_t(gen: SpatialGenerator, coords: torch.Tensor,
                             theta, dx, z, y: torch.Tensor,
                             y_t: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The JAX ``fused_bce_spatial_int8_t``: the pose fold in PyTorch, then
    K8.  y: (B, HW[, C]); ``y_t`` float targets (B, C, HW or more), else
    built from y.  Returns the summed BCE (0-d)."""
    w0, w1f, c = fold_pose_into_first_layer(gen, theta, dx, z)
    fold_t = torch.stack([w0, w1f, c, torch.zeros_like(c)], dim=2)
    hidden, head = gen.linears()
    hw = coords.shape[0]
    if y_t is None:
        y_t = y.reshape(y.shape[0], hw, -1).transpose(1, 2)
    return fused_decoder_bce_int8_t(
        fold_t.float().contiguous(), coords.float().contiguous(),
        hidden.weight.T.contiguous(), hidden.bias, head.weight.contiguous(),
        head.bias, y_t)
