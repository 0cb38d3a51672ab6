"""Fused spatial-decoder tail, forward: a hand-written sm_90a CUDA kernel.

Counterpart of ``spatialvae_tpu/kernels/fused_decoder.py`` (the forward of
its custom-VJP op, Pallas ``_fwd_kernel``).  Per (image b, pixel p):

    h0  = x0[p]*w0[b] + x1[p]*w1[b] + c[b]       # pose-folded first layer
    a0  = tanh(h0)
    a_l = tanh(a_{l-1} @ W_l + b_l [+ a_{l-1}])  # Lh hidden (H, H) layers
    y   = sigmoid(a_Lh @ Wh + bh)                # (H, n_out) head

with the activation cast to the weight dtype before each product and f32
accumulation.  The kernel (``csrc/fused_decoder_fwd.cu``, design notes
there) keeps every (B, HW, H) intermediate on chip and writes only y.

``decoder_tail_reference`` is the same function in eager PyTorch.  The
wrappers ``fused_decoder_tail`` and ``run_decoder_tail`` run it for CPU
tensors only; for CUDA tensors they launch the kernel or raise.  Both
refuse, on every device, what the kernel cannot take, among it a hidden
width above ``MAX_HIDDEN``.  The backward (the TPU package's
``_bwd_kernel``) is not ported yet, so they also refuse inputs that
require grad.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from spatialvae_tpu.core.config import SpatialGeneratorConfig
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    fold_pose_into_first_layer,
)
from spatialvae_torch.precision import fp32_precision

MAX_HIDDEN_LAYERS = 4
MAX_OUT = 8
# = svt_fused_decoder_max_hidden() of the kernel: a block holds the (64, H)
# output of a layer in registers
MAX_HIDDEN = 512
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def can_fuse_decoder(cfg: SpatialGeneratorConfig, hw: int) -> bool:
    """The JAX package's gate (foldable, 2..5 layers, n_out <= 8,
    hw >= 256) plus tanh, which the kernel hard-codes and the JAX gate
    never checked (ROADMAP, Queue 3).  Configs outside it take the plain
    folded decoder.  Like the JAX gate it admits any hidden_dim; the
    wrapper raises above MAX_HIDDEN (ROADMAP, Queue 2 K1)."""
    return (not cfg.expand_coords and not cfg.bilinear
            and 2 <= cfg.num_layers <= 5 and cfg.n_out <= 8 and hw >= 256
            and cfg.activation == "tanh")


@fp32_precision()
def decoder_tail_reference(fold: torch.Tensor, coords: torch.Tensor,
                           whid: torch.Tensor, bhid: torch.Tensor,
                           wht: torch.Tensor, bht: torch.Tensor,
                           resid: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the kernel's casts.

    fold: (B, 4, H) rows [w0, w1, c, unused]; coords: (HW, 2);
    whid: (Lh, H, H) [in, out]; bhid: (Lh, H); wht: (No, H); bht: (No,).
    Returns the sigmoid head output (B, No, HW) float32."""
    wdt = whid.dtype
    x0 = coords[:, 0].float()[None, :, None]
    x1 = coords[:, 1].float()[None, :, None]
    fold = fold.float()
    h = (x0 * fold[:, 0][:, None, :] + x1 * fold[:, 1][:, None, :]
         + fold[:, 2][:, None, :])                     # (B, HW, H)
    a = torch.tanh(h)
    for l in range(whid.shape[0]):
        h = a.to(wdt).float() @ whid[l].float() + bhid[l].float()
        if resid:
            h = h + a
        a = torch.tanh(h)
    z = a.to(wdt).float() @ wht.float().T + bht.float()   # (B, HW, No)
    return torch.sigmoid(z).transpose(1, 2)


def _check_weights(whid, bhid, wht, bht) -> None:
    """Raise on weights the kernel does not take (on every device, so the
    CPU path refuses exactly what the card would)."""
    args = dict(whid=whid, bhid=bhid, wht=wht, bht=bht)
    if whid.dim() != 3 or whid.shape[1] != whid.shape[2]:
        raise ValueError(f"whid must be (Lh, H, H), got {tuple(whid.shape)}")
    lh, h = whid.shape[:2]
    no = wht.shape[0] if wht.dim() == 2 else -1
    want = dict(bhid=(lh, h), wht=(no, h), bht=(no,))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape or min(shape) < 1:
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape} (H={h})")
    if not 1 <= lh <= MAX_HIDDEN_LAYERS:
        raise ValueError(f"{lh} hidden layers; the kernel takes "
                         f"1..{MAX_HIDDEN_LAYERS} (num_layers 2..5)")
    if no > MAX_OUT:
        raise ValueError(f"n_out={no}; the kernel takes at most {MAX_OUT}")
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"hidden_dim={h}; the kernel holds a layer's "
                         f"output in registers up to {MAX_HIDDEN} "
                         f"(ROADMAP Queue 2 K1: H > {MAX_HIDDEN})")
    if whid.dtype not in WEIGHT_DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got "
                        f"{whid.dtype}")
    for name in ("bhid", "wht", "bht"):
        if args[name].dtype != whid.dtype:
            raise TypeError(f"{name} is {args[name].dtype}, the hidden "
                            f"weights {whid.dtype}: one weight dtype")
    for name, t in args.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in args.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if whid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {whid.device}")


class TailWeights:
    """The decoder tail's weights, checked once: whid (Lh, H_in, H_out),
    bhid (Lh, H), wht (No, H), bht (No,), all float32 or all bfloat16,
    contiguous, on one device.  ``sources`` are the tensors they were
    stacked from; the wrappers refuse them when they require grad.

    ``kernel_args()`` builds the launch's float32 copies on first use: the
    kernel reads f32 (widening bf16 is exact, and a flag keeps the bf16
    activation casts) and streams whid in 16-byte rows, zero-padded to
    (Lh, Hp, Hp) with Hp a multiple of 32."""

    def __init__(self, whid, bhid, wht, bht,
                 sources: Optional[Sequence[torch.Tensor]] = None):
        _check_weights(whid, bhid, wht, bht)
        self.whid, self.bhid, self.wht, self.bht = whid, bhid, wht, bht
        self.sources = tuple((whid, bhid, wht, bht) if sources is None
                             else sources)
        self._kernel_args = None

    def kernel_args(self) -> tuple:
        if self._kernel_args is None:
            h = self.whid.shape[1]
            hp = -(-h // 32) * 32
            self._kernel_args = (
                F.pad(self.whid.float(), (0, hp - h, 0, hp - h)).contiguous(),
                *(t.float() for t in (self.bhid, self.wht, self.bht)))
        return self._kernel_args


def generator_tail_weights(gen: SpatialGenerator) -> TailWeights:
    """gen's hidden layers and head as ``TailWeights``, cached on gen until
    one of those tensors changes: an in-place update (an optimizer step,
    ``load_state_dict``) bumps its version, and a replaced tensor (``.to``)
    has another address.  The cache holds the storages it was built from,
    so no other tensor can take their addresses meanwhile."""
    *hidden, head = gen.linears()
    params = [p for lin in (*hidden, head) for p in (lin.weight, lin.bias)]
    state = [(p.data_ptr(), p._version) for p in params]
    cached = gen.__dict__.get("_fused_tail")
    if cached is not None and cached[0] == state:
        return cached[2]
    with torch.no_grad():
        tw = TailWeights(
            torch.stack([lin.weight.T for lin in hidden]).contiguous(),
            torch.stack([lin.bias for lin in hidden]),
            head.weight.detach().contiguous(), head.bias.detach(),
            sources=params)
    gen.__dict__["_fused_tail"] = (state, [p.detach() for p in params], tw)
    return tw


def _check_inputs(fold, coords, w: TailWeights) -> None:
    h = w.whid.shape[1]
    if fold.dim() != 3 or fold.shape[1:] != (4, h):
        raise ValueError(f"fold must be (B, 4, H={h}), got "
                         f"{tuple(fold.shape)}")
    if fold.shape[0] < 1:
        raise ValueError("empty batch")
    if coords.dim() != 2 or coords.shape[1] != 2 or coords.shape[0] < 1:
        raise ValueError(f"coords must be (HW, 2), got "
                         f"{tuple(coords.shape)}")
    for name, t in (("fold", fold), ("coords", coords)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {fold.device, coords.device, w.whid.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (fold, coords, *w.sources)):
        raise RuntimeError("fused_decoder_tail is forward-only (its "
                           "backward, ROADMAP Queue 2 K2, is not ported); "
                           "call it under torch.no_grad()")


def run_decoder_tail(fold: torch.Tensor, coords: torch.Tensor,
                     weights: TailWeights, resid: bool = False
                     ) -> torch.Tensor:
    """fold: (B, 4, H) f32; coords: (HW, 2) f32.  Returns (B, No, HW)
    float32.

    CPU tensors take ``decoder_tail_reference``; CUDA tensors launch the
    kernel, count the launch in ``fused_decoder_tail.launches``, and raise
    if the build or the launch fails."""
    _check_inputs(fold, coords, weights)
    w = weights
    if fold.device.type == "cpu":
        return decoder_tail_reference(fold, coords, w.whid, w.bhid, w.wht,
                                      w.bht, resid)
    from spatialvae_torch.kernels._build import load_library

    lib = load_library()
    b, _, h = fold.shape
    hw, lh, no = coords.shape[0], w.whid.shape[0], w.wht.shape[0]
    bf16 = w.whid.dtype == torch.bfloat16
    y = torch.empty((b, no, hw), dtype=torch.float32, device=fold.device)
    with torch.cuda.device(fold.device):
        stream = torch.cuda.current_stream(fold.device).cuda_stream
        err = lib.svt_fused_decoder_fwd(
            fold.data_ptr(), coords.data_ptr(),
            *(t.data_ptr() for t in w.kernel_args()), y.data_ptr(),
            b, hw, h, lh, no, int(bool(resid)), int(bf16), stream)
    if err != 0:
        raise RuntimeError(
            f"fused decoder kernel failed to launch: CUDA error {err} "
            f"({lib.svt_cuda_error_string(err).decode()})")
    fused_decoder_tail.launches += 1
    return y


def fused_decoder_tail(fold: torch.Tensor, coords: torch.Tensor,
                       whid: torch.Tensor, bhid: torch.Tensor,
                       wht: torch.Tensor, bht: torch.Tensor,
                       resid: bool = False) -> torch.Tensor:
    """``run_decoder_tail`` on loose weights: whid (Lh, H, H); bhid
    (Lh, H); wht (No, H); bht (No,), all f32 or all bf16.  Packs them for
    the kernel on every call; ``fused_spatial_generator`` packs once per
    generator."""
    return run_decoder_tail(fold, coords, TailWeights(whid, bhid, wht, bht),
                            resid)


fused_decoder_tail.launches = 0


def fused_spatial_generator(gen: SpatialGenerator, coords: torch.Tensor,
                            theta: Optional[torch.Tensor],
                            dx: Optional[torch.Tensor],
                            z: Optional[torch.Tensor]) -> torch.Tensor:
    """Drop-in for ``spatial_generator_apply_folded`` through the kernel.
    The fold, the head transpose and the optional softplus stay in
    PyTorch; the stacked weights are cached on gen.  Returns
    (B, HW, n_out)."""
    if not can_fuse_decoder(gen.cfg, coords.shape[0]):
        raise ValueError(f"config not supported by the fused decoder: "
                         f"{gen.cfg}")
    w0, w1, c = fold_pose_into_first_layer(gen, theta, dx, z)
    fold = torch.stack([w0, w1, c, torch.zeros_like(c)], dim=1)  # (B, 4, H)
    yt = run_decoder_tail(fold.float().contiguous(),
                          coords.float().contiguous(),
                          generator_tail_weights(gen), gen.cfg.resid)
    y = yt.transpose(1, 2)                                # (B, HW, No)
    if gen.cfg.softplus:
        y = torch.cat([F.softplus(y[..., :1]), y[..., 1:]], dim=-1)
    return y
