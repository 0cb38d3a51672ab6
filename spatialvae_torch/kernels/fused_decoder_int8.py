"""The int8 decoder tail: hand-written sm_90a CUDA kernels, forward (K4) and
backward (K5), under one ``torch.autograd.Function``.

Counterpart of ``spatialvae_tpu/kernels/fused_decoder_int8.py`` (the
custom-VJP op ``fused_decoder_tail_int8``: Pallas ``_fwd_kernel`` and
``_bwd_kernel``), for the default decoder shape only (2 layers, no resid).
Per (image b, pixel p), with W1q, sw = ``quant_sym(w1)`` (per-tensor int8):

    a0  = tanh(x0[p]*w0[b] + x1[p]*w1[b] + c[b])
    a0q = round(127*a0)                                   (int8, no clip)
    h1  = (a0q @ W1q) * (sw/127) + b1                     (int32 sums)
    a1  = tanh(h1);  y = sigmoid(cast(a1) . wht^T + bht)  (f32 sums)

and the backward, per quantisation group (one image x one ``pick_tile``
pixel tile, 2048 pixels at the galaxy shape):

    dz2 = g*y*(1-y);   dh1 = (cast(dz2)^T . wht) * (1 - a1^2)
    sg  = max|dh1| over the group / 127 + 1e-30;  dh1q = clip(round(dh1/sg))
    dW1 += (a0q^T . dh1q) * sg/127;   db1 += sum dh1
    da0 = (dh1q . W1q^T) * sg*sw;     dh0 = da0 * (1 - a0^2)

cast() rounds to the weight dtype; the residual a1 is stored in bf16, and
without it the backward rebuilds a1 in f32 exactly as the forward did, so
the two variants differ as the JAX ones do.

``decoder_tail_int8_reference`` and ``decoder_tail_int8_backward_reference``
are the plain PyTorch versions, with the integer products done exactly
(integer-valued float32, every partial sum below 2**24).  The wrappers run
them for CPU tensors; CUDA tensors launch the kernels or raise, on the
passes ``int8_route`` names: over pixel counts that are multiples of 256
(every call of ``fused_spatial_generator_int8``, which pads), the cluster
passes (W1q multicast to clusters of four CTAs, int8 wgmma, K5's dW1 on
K3's cluster kernel ``svt_loss90_dw``): at H <= 512 those of
``csrc/fused_decoder_int8_sm90.cu``, past 512 those of
``csrc/fused_decoder_int8_sm90_wide.cu`` (output-column chunks of 512, a0q
built once a tile and read back from a slot of a global workspace, the
K-major dh1q copy, R = ``cluster_rows(H)`` rows a workspace block); but K4
without a1 on float32 weights at H <= 512 takes the block passes (measured
faster there); otherwise, or when the caller names them (``passes``), the
block passes of ``csrc/fused_decoder_int8.cu``, which above 512 keep each
block's int8 tiles in a workspace in global memory
(``csrc/int8_tile.cuh``).  The wrappers allocate every workspace within
``workspace_budget``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from spatialvae_torch.config import SpatialGeneratorConfig
from spatialvae_torch.kernels.fused_decoder import (
    _call,
    _first_layer,
    _lib,
    _stream,
    residual_budget,
    save_residual,
    wide_chunks,
    workspace_budget,
)
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    fold_pose_into_first_layer,
)
from spatialvae_torch.precision import fp32_precision

MAX_OUT = 8
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)
BLOCK_PIXELS = 64       # pixels per CUDA block (a group spans several)

# Kernel launches on CUDA tensors, by kernel: the forward without and with
# the a1 output, the backward's scale pass (each block's max |dh1|), its
# gradient pass (quantisation, da0, dfold and bias partials, workspaces),
# the split-K dW1 kernel and the fixed-order reductions.  The block passes'
# recompute variant rebuilds a1 inside the two backward passes; the cluster
# passes (``int8_route`` "sm90") count under their own keys, their
# recompute scale pass rebuilding a1 into a stash the gradient pass reads.
LAUNCHES = {"fwd": 0, "fwd_acts": 0, "bwd_scale": 0, "bwd_grad": 0,
            "dw": 0, "sum": 0, "fwd_sm90": 0, "fwd_acts_sm90": 0,
            "bwd_scale_sm90": 0, "bwd_grad_sm90": 0, "dw_sm90": 0}

# The cluster passes (csrc/fused_decoder_int8_sm90.cu): CLUSTER CTAs of one
# 64-pixel block each, four consecutive blocks of one quantisation group;
# every operand padded to CLUSTER_WIDTH hidden rows; W1q streamed in slabs
# of SLAB_K K-bytes (K4: half slabs of CLUSTER_WIDTH // 2 rows).
CLUSTER = 4
CLUSTER_WIDTH = 512
SLAB_K = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def can_fuse_int8(cfg: SpatialGeneratorConfig, hw: int) -> bool:
    """The JAX package's gate plus tanh, which the kernels hard-code and the
    JAX gate never checked (ROADMAP Queue 3): a relu, leakyrelu or sigmoid
    decoder takes the plain folded decoder."""
    return (not cfg.expand_coords and not cfg.bilinear and not cfg.resid
            and cfg.num_layers == 2 and cfg.n_out <= 8 and hw >= 256
            and cfg.activation == "tanh")


def int8_route(hw: int, h: int, passes: Optional[str] = None,
               k4_alone_f32: bool = False) -> str:
    """The passes a K4 or K5 call runs on the card.  The cluster passes
    ("sm90") take every width over pixel counts that are multiples of 256
    (so every quantisation group, ``pick_tile(hw)`` pixels, is too, and a
    cluster's four blocks lie in one): up to CLUSTER_WIDTH in one chunk,
    past it in output-column chunks of CLUSTER_WIDTH (the wide unit); the
    block passes ("block") every other shape.  Where both fit, the table
    follows the H100's A/B turns: the cluster passes for K4 with a1 and for
    K5 (either variant, as one call: the recompute scale pass leaves the a1
    stash its gradient pass reads), and for K4 without a1 on bf16 weights;
    the block passes for K4 without a1 on float32 weights
    (``k4_alone_f32``) up to CLUSTER_WIDTH, which they ran 4-8% faster on
    the H100 at every batch timed there (``PERF.md`` §6; the cluster pass's
    head takes three TF32 products for f32 weights, one for bf16); past
    512 the wide unit's head is the same FMA sums for both dtypes, and its
    f32 K4 without a1 ran 0.70-0.85 of the block passes' time at every
    width from 513 to 4,100 (``chip_smoke.py --sweep k45``: 3.94 against
    4.89 ms at H = 1,000, B=100), so it takes the cluster passes.
    ``passes`` ("sm90" or "block") names the passes instead (the A/B turns
    and the card tests); the cluster passes refuse a shape they do not
    fit, and so do their entry points."""
    fits = hw % (CLUSTER * BLOCK_PIXELS) == 0
    if passes not in (None, "sm90", "block"):
        raise ValueError(f"passes must be None, 'sm90' or 'block', got "
                         f"{passes!r}")
    if passes == "sm90" and not fits:
        raise ValueError(f"the cluster passes take HW a multiple of "
                         f"{CLUSTER * BLOCK_PIXELS}, got H={h}, HW={hw}")
    if passes is not None:
        return passes
    return ("sm90" if fits and not (k4_alone_f32 and h <= CLUSTER_WIDTH)
            else "block")


def pick_tile(hw: int) -> int:
    """Pixels per quantisation group (the JAX ``_pick_tile``): the largest
    of 2048, 1024, 512, 256 that divides hw, else hw.  The group sets the
    numbers, not only the speed."""
    for t in (2048, 1024, 512, 256):
        if hw % t == 0:
            return t
    return hw


def quant_sym(w: torch.Tensor):
    """Per-tensor symmetric int8 quantisation: (q int8, s f32 0-d) with
    s = max|w|/127 + 1e-12 and q = clip(round(w/s), -127, 127)."""
    s = w.abs().max().float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(w.float() / s), -127, 127).to(torch.int8)
    return q, s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _forward_chain(fold, coords, w1q, sw, b1):
    """(a0, a0q, a1) in float32: a0q integer-valued, a1 = tanh(h1)."""
    a0 = torch.tanh(_first_layer(fold, coords))              # (B, HW, H)
    a0q = torch.round(a0 * 127.0)
    acc = a0q @ w1q.float()                                   # exact ints
    h1 = acc * (sw.float() * (1.0 / 127.0)) + b1.float()
    return a0, a0q, torch.tanh(h1)


@fp32_precision()
def decoder_tail_int8_reference(fold, coords, w1q, sw, b1, wht, bht,
                                return_a1: bool = False):
    """Plain version of K4.  fold (B, 4, H) f32; coords (HW, 2) f32; w1q
    (H, H) int8 [in][out]; sw 0-d f32; b1 (H,); wht (No, H); bht (No,) in
    the weight dtype.  Returns y (B, No, HW) f32 and, with ``return_a1``,
    a1 (B, HW, H) in bf16 (the residual)."""
    wdt = wht.dtype
    _, _, a1 = _forward_chain(fold, coords, w1q, sw, b1)
    z = a1.to(wdt).float() @ wht.float().T + bht.float()     # (B, HW, No)
    y = torch.sigmoid(z).transpose(1, 2)
    return (y, a1.to(torch.bfloat16)) if return_a1 else y


def grouped_int_product(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        pt: int, chunk: int = 64) -> torch.Tensor:
    """sum over groups g of (a_g^T . q_g) * scale_g, (H, H) f32: a, q
    (B, HW, H) integer-valued, scale (B, HW // pt).  Each group's product is
    computed exactly (float64; a 2048-pixel int8 group can pass 2**24) and
    rounded to f32 as the kernels' int32 -> f32 conversion rounds it; the
    scaled values are summed in f32, in chunks of groups that bound the
    memory."""
    h = a.shape[-1]
    a = a.reshape(-1, pt, h)
    q = q.reshape(-1, pt, q.shape[-1])
    scale = scale.reshape(-1)
    out = torch.zeros((h, q.shape[-1]), dtype=torch.float32, device=a.device)
    for g0 in range(0, a.shape[0], chunk):
        prod = torch.bmm(a[g0:g0 + chunk].double().transpose(1, 2),
                         q[g0:g0 + chunk].double()).float()
        out += (prod * scale[g0:g0 + chunk, None, None]).sum(0)
    return out


def _dfold(coords, dh0):
    x0 = coords[:, 0].float()[None, :, None]
    x1 = coords[:, 1].float()[None, :, None]
    return torch.stack([(x0 * dh0).sum(1), (x1 * dh0).sum(1), dh0.sum(1),
                        torch.zeros_like(dh0[:, 0])], dim=1)


@fp32_precision()
def decoder_tail_int8_backward_reference(fold, coords, w1q, sw, b1, wht,
                                         a1: Optional[torch.Tensor], y, g):
    """Plain version of K5: the JAX ``_bwd_pallas`` inputs and outputs.
    a1: the bf16 residual, or None to rebuild a1 in f32; y: the forward's
    (B, No, HW) output; g its cotangent.  Returns float32 (dfold (B, 4, H)
    with row 3 zero, dW1 (H, H), db1 (H,), dWh^T (No, H), dbh (No,))."""
    wdt = wht.dtype
    cast = lambda t: t.to(wdt).float()
    hw = coords.shape[0]
    pt = pick_tile(hw)
    a0, a0q, a1f = _forward_chain(fold, coords, w1q, sw, b1)
    if a1 is not None:
        a1f = a1.float()
    s = y.float()
    dz2 = g.float() * s * (1.0 - s)                           # (B, No, HW)
    dz2c = cast(dz2)
    a1c = cast(a1f)
    dwht = torch.einsum("bop,bph->oh", dz2c, a1c)
    dbht = dz2.sum(dim=(0, 2))
    da1 = torch.einsum("bop,oh->bph", dz2c, wht.float())
    dh1 = da1 * (1.0 - a1f * a1f)                             # (B, HW, H)
    b, _, h = dh1.shape
    gmax = dh1.abs().reshape(b, hw // pt, -1).amax(dim=2)    # (B, T)
    sg = gmax * (1.0 / 127.0) + 1e-30
    sgp = sg.repeat_interleave(pt, dim=1)[..., None]          # per pixel
    dh1q = torch.clamp(torch.round(dh1 / sgp), -127, 127)
    dw1 = grouped_int_product(a0q, dh1q, sg * (1.0 / 127.0), pt)
    db1 = dh1.sum(dim=(0, 1))
    da0 = (dh1q @ w1q.float().T) * (sgp * sw.float())
    dh0 = da0 * (1.0 - a0 * a0)
    return _dfold(coords, dh0), dw1, db1, dwht, dbht


# ---------------------------------------------------------------------------
# checks and packed weights
# ---------------------------------------------------------------------------


def _check_weights(w1, b1, wht, bht) -> None:
    """Raise on weights the kernels do not take, on every device."""
    args = dict(w1=w1, b1=b1, wht=wht, bht=bht)
    if w1.dim() != 2 or w1.shape[0] != w1.shape[1]:
        raise ValueError(f"w1 must be (H, H), got {tuple(w1.shape)}")
    h = w1.shape[0]
    no = wht.shape[0] if wht.dim() == 2 else -1
    for name, shape in dict(b1=(h,), wht=(no, h), bht=(no,)).items():
        if tuple(args[name].shape) != shape or min(shape) < 1:
            raise ValueError(f"{name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape} (H={h})")
    if no > MAX_OUT:
        raise ValueError(f"n_out={no}; the kernels take at most {MAX_OUT}")
    if w1.dtype not in WEIGHT_DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got "
                        f"{w1.dtype}")
    for name in ("b1", "wht", "bht"):
        if args[name].dtype != w1.dtype:
            raise TypeError(f"{name} is {args[name].dtype}, w1 {w1.dtype}: "
                            f"one weight dtype")
    devices = {t.device for t in args.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if w1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w1.device}")


def padded_hidden(h: int) -> int:
    """The kernels' K and N padding: a multiple of 64 (one int8 slab)."""
    return -(-h // 64) * 64


def pad_square(q: torch.Tensor) -> torch.Tensor:
    """(H, H) int8 zero-padded to (Kp, Kp), contiguous."""
    kp = padded_hidden(q.shape[0])
    p = kp - q.shape[0]
    return F.pad(q, (0, p, 0, p)).contiguous()


class Int8Weights:
    """The int8 decoder's weights, checked and quantised once: w1 (H, H)
    [in][out], b1 (H,), wht (No, H), bht (No,), one float dtype, on one
    device.  ``w1q``, ``sw`` = ``quant_sym(w1)``.  The launch copies are
    built on first use, each route's own: ``operands()`` sw (1,) and b1,
    wht, bht in f32 (widening bf16 is exact), for both routes;
    ``kernel_args()`` adds the block passes' W1q^T and W1q zero-padded to
    (Kp, Kp) int8 (the forward reads rows of W1q^T, the backward rows of
    W1q); ``half_slabs90()`` and ``slabs90()`` the cluster passes' W1q
    streams at H <= 512, ``slabs90w_t()`` and ``slabs90w()`` past it."""

    def __init__(self, w1, b1, wht, bht):
        _check_weights(w1, b1, wht, bht)
        self.w1, self.b1, self.wht, self.bht = (
            t.detach() for t in (w1, b1, wht, bht))
        self.w1q, self.sw = quant_sym(self.w1)
        self._cache = {}

    @property
    def bf16(self) -> bool:
        return self.w1.dtype == torch.bfloat16

    def _once(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def operands(self) -> tuple:
        """(sw (1,), b1, wht, bht), f32, contiguous on the device."""
        return self._once("operands", lambda: (
            self.sw.reshape(1).contiguous(),
            *(t.float().contiguous() for t in (self.b1, self.wht,
                                               self.bht))))

    def kernel_args(self) -> tuple:
        """(w1qT, w1q, sw (1,), b1, wht, bht), contiguous on the device: the
        block passes' launch copies."""
        return self._once("block", lambda: (
            pad_square(self.w1q.T), pad_square(self.w1q), *self.operands()))

    def half_slabs90(self) -> torch.Tensor:
        """W1q^T's half slabs (``half_slabs90``): K4 and the recompute
        scale pass on the cluster passes."""
        return self._once("half", lambda: half_slabs90(self.w1q.T))

    def slabs90(self) -> torch.Tensor:
        """W1q's slabs in K3's layout (``fused_loss_int8.sm90_slabs``):
        K5's da0 on the cluster passes."""
        return self._once("full", lambda: _laid_out(self.w1q, "full"))

    def slabs90w_t(self) -> torch.Tensor:
        """W1q^T's chunked slab stream (``fused_loss_int8.sm90_slabs``): K4
        and the recompute scale pass past H = 512."""
        from spatialvae_torch.kernels.fused_loss_int8 import sm90_slabs

        return self._once("wide_t", lambda: sm90_slabs(self.w1q.T))

    def slabs90w(self) -> torch.Tensor:
        """W1q's chunked slab stream: K5's da0 past H = 512."""
        from spatialvae_torch.kernels.fused_loss_int8 import sm90_slabs

        return self._once("wide", lambda: sm90_slabs(self.w1q))


def _layout90(p: torch.Tensor, kind: str) -> torch.Tensor:
    """The cluster passes' slab streams of a (CLUSTER_WIDTH, Kp) matrix of
    rows [n][k]: "half", K4's half slabs (``half_slabs90``); "full", K3's
    whole slabs (``fused_loss_int8.sm90_slabs``)."""
    from spatialvae_torch.kernels.fused_decoder import _swizzle64

    kp = p.shape[1]
    if kind == "half":
        t = p.reshape(4, 2, 64, kp).transpose(0, 1).reshape(2, 256, kp)
        t = t.reshape(2, 256, kp // SLAB_K, 4, 16).permute(0, 2, 1, 3, 4)
    else:
        t = p.reshape(CLUSTER_WIDTH, kp // SLAB_K, 4, 16).transpose(0, 1)
    return _swizzle64(t.contiguous()).reshape(-1)


@functools.lru_cache(maxsize=16)
def _layout_index(kind: str, kp: int, device: torch.device) -> torch.Tensor:
    """``_layout90`` of the flat positions of a (CLUSTER_WIDTH, Kp)
    matrix: the stream as one gather, so that a weight laid out on every
    call (the evaluation decodes fresh bf16 copies of the masters) costs
    two small kernels, not a score of them."""
    pos = torch.arange(CLUSTER_WIDTH * kp, device=device)
    return _layout90(pos.reshape(CLUSTER_WIDTH, kp), kind)


def _laid_out(w: torch.Tensor, kind: str) -> torch.Tensor:
    """w (H, H) int8 rows [n][k], zero-padded to (CLUSTER_WIDTH, Kp) and
    laid out as ``_layout90`` lays it out, through the cached gather."""
    kp = padded_hidden(w.shape[1])
    p = F.pad(w, (0, kp - w.shape[1], 0, CLUSTER_WIDTH - w.shape[0]))
    return p.reshape(-1)[_layout_index(kind, kp, p.device)]


def half_slabs90(w: torch.Tensor) -> torch.Tensor:
    """An (H, H) int8 matrix given as rows [n][k] (K4 takes W1q^T) -> the
    forward cluster pass's stream of half slabs: zero-padded to
    (CLUSTER_WIDTH, Kp); half hf holds rows 128 wg + 64 hf + r (the columns
    of the m64n64 product of warpgroup wg), as row 64 wg + r; the stream is
    half 0's Kp/SLAB_K slabs, then half 1's, each (256, SLAB_K) in wgmma's
    64-byte swizzled K-major layout.  One contiguous (Kp * CLUSTER_WIDTH,)
    int8 tensor: a quarter of a half slab is one bulk copy."""
    return _laid_out(w, "half")


def workspace90_bytes(hw: int, recompute: bool,
                      h: int = CLUSTER_WIDTH) -> int:
    """Bytes of the cluster K5's workspaces per image at width ``h``: the
    dW1 operands a0q and dh1q (R, HW) int8 each in ``svt_loss90_dw``'s
    layout, R = ``cluster_rows(h)`` (CLUSTER_WIDTH up to 512), and with
    recompute the scale pass's f32 a1 stash, 64 pixels x R per block."""
    from spatialvae_torch.kernels.fused_loss_int8 import cluster_rows

    rows = cluster_rows(h)
    stash = hw * rows * 4 if recompute else 0
    return 2 * rows * hw + stash


def wide_slots(lib, h: int, dev) -> tuple:
    """(slots, count): the wide cluster passes' workspace of one slot a
    resident CTA (a0q, or the K-major dh1q copy; at most one CTA an SM),
    ``svt_int8_90w_slot_bytes(h)`` bytes each."""
    n = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty((n * lib.svt_int8_90w_slot_bytes(h),),
                       dtype=torch.int8, device=dev), n


def _check_inputs(fold, coords, w: Int8Weights) -> None:
    h = w.w1.shape[0]
    if fold.dim() != 3 or fold.shape[1:] != (4, h) or fold.shape[0] < 1:
        raise ValueError(f"fold must be (B, 4, H={h}), got "
                         f"{tuple(fold.shape)}")
    if coords.dim() != 2 or coords.shape[1] != 2 or coords.shape[0] < 1:
        raise ValueError(f"coords must be (HW, 2), got "
                         f"{tuple(coords.shape)}")
    for name, t in (("fold", fold), ("coords", coords)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {fold.device, coords.device, w.w1.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def run_int8_tail(fold, coords, w: Int8Weights, emit_a1: bool = False,
                  passes: Optional[str] = None):
    """K4: y (B, No, HW) f32, and with ``emit_a1`` the bf16 residual a1
    (B, HW, H).  CPU tensors take ``decoder_tail_int8_reference``; CUDA
    tensors launch the kernel on the passes ``int8_route`` names (or
    ``passes``) and count it in ``LAUNCHES["fwd"]`` or ``["fwd_acts"]``
    (``"_sm90"`` on the cluster passes)."""
    _check_inputs(fold, coords, w)
    if fold.device.type == "cpu":
        return decoder_tail_int8_reference(fold, coords, w.w1q, w.sw, w.b1,
                                           w.wht, w.bht, emit_a1)
    lib = _lib()
    dev = fold.device
    b, _, h = fold.shape
    hw, no = coords.shape[0], w.wht.shape[0]
    y = torch.empty((b, no, hw), dtype=torch.float32, device=dev)
    a1 = (torch.empty((b, hw, h), dtype=torch.bfloat16, device=dev)
          if emit_a1 else None)
    route = int8_route(hw, h, passes,
                       k4_alone_f32=not emit_a1 and not w.bf16)
    if route == "sm90":
        sw, b1, wht, bht = w.operands()
        with torch.cuda.device(dev):
            if h > CLUSTER_WIDTH:
                slots, n = wide_slots(lib, h, dev)
                _call(lib, "svt_int8_90w_fwd", fold.data_ptr(),
                      coords.data_ptr(), w.slabs90w_t().data_ptr(),
                      sw.data_ptr(), b1.data_ptr(), wht.data_ptr(),
                      bht.data_ptr(), y.data_ptr(), ptr(a1),
                      slots.data_ptr(), n, b, hw, h, no, int(w.bf16),
                      _stream(fold))
            else:
                _call(lib, "svt_int8_90_fwd", fold.data_ptr(),
                      coords.data_ptr(), w.half_slabs90().data_ptr(),
                      sw.data_ptr(), b1.data_ptr(), wht.data_ptr(),
                      bht.data_ptr(), y.data_ptr(), ptr(a1), b, hw, h, no,
                      int(w.bf16), _stream(fold))
            LAUNCHES["fwd_acts_sm90" if emit_a1 else "fwd_sm90"] += 1
        return (y, a1) if emit_a1 else y
    w1qt, _, sw, b1, wht, bht = w.kernel_args()
    blocks = -(-hw // BLOCK_PIXELS)
    ws, chunks = wide_workspace(lib, b, blocks, h, dev)
    with torch.cuda.device(dev):
        for b0, n in chunks:
            _call(lib, "svt_int8_decoder_fwd",
                  fold.data_ptr() + b0 * 4 * h * 4, coords.data_ptr(),
                  w1qt.data_ptr(), sw.data_ptr(), b1.data_ptr(),
                  wht.data_ptr(), bht.data_ptr(),
                  y.data_ptr() + b0 * no * hw * 4,
                  a1.data_ptr() + b0 * hw * h * 2 if emit_a1 else None,
                  ptr(ws), n, hw, h, no, int(w.bf16), _stream(fold))
            LAUNCHES["fwd_acts" if emit_a1 else "fwd"] += 1
    return (y, a1) if emit_a1 else y


def wide_workspace(lib, b: int, blocks: int, h: int, dev) -> tuple:
    """(workspace or None, [(first image, count)]): the uint8 workspace of
    the wide int8 kernels (H > 512) for launches of ``blocks`` blocks per
    image over ``b`` images, within ``workspace_budget``; no workspace and
    one launch at H <= 512."""
    block = lib.svt_int8_ws_block(h)
    if not block:
        return None, [(0, b)]
    chunks = wide_chunks(b, blocks, block, workspace_budget(dev))
    return torch.empty((chunks[0][1] * blocks * block,), dtype=torch.uint8,
                       device=dev), chunks


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """t's address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def image_chunks(b: int, per_image: int, budget: int) -> list:
    """[(first image, count)] with count * per_image <= budget (at least
    one image per chunk)."""
    bc = max(1, min(b, budget // per_image))
    return [(b0, min(bc, b - b0)) for b0 in range(0, b, bc)]


def dw_splits(groups: int) -> int:
    """Split-K partials of the dW1 kernel for ``groups`` quantisation
    groups: enough (128, 128) tiles x splits to fill the card twice, at
    most one split per group."""
    return max(1, min(groups, 16))


def run_grouped_dw(lib, aq_ws, q_ws, gscale, part_dw, nimg, hwp, h, pt_grp,
                   groups_per_image, stream) -> int:
    """dW1 partials of ``nimg`` images from the feature-major int8
    workspaces (nimg, Kp, HWp): each group's exact int32 product, times its
    scale, summed in f32 over the groups of a split; returns the number of
    partials written.  The caller counts the launch."""
    groups = nimg * groups_per_image
    splits = dw_splits(groups)
    _call(lib, "svt_int8_grouped_dw", aq_ws.data_ptr(), q_ws.data_ptr(),
          gscale.data_ptr(), part_dw.data_ptr(), nimg, hwp, h, pt_grp,
          groups_per_image, splits, stream)
    return splits


def run_int8_tail_backward(fold, coords, w: Int8Weights,
                           a1: Optional[torch.Tensor], y, g,
                           workspace_bytes: Optional[int] = None,
                           passes: Optional[str] = None, ints: bool = False):
    """K5, with the outputs of ``decoder_tail_int8_backward_reference``:
    that function for CPU tensors, the kernels for CUDA tensors, on the
    passes ``int8_route`` names (or ``passes``).  ``a1`` is the forward's bf16 residual or
    None (the kernels rebuild a1 in f32).

    On the card: a scale pass writes each 64-pixel block's max |dh1|; a
    gradient pass takes each group's scale from its blocks' maxima,
    quantises dh1, runs da0 on the int8 tensor cores, writes the per-block
    partials of dfold, db1, dWh^T and dbh and the int8 a0q and dh1q to
    workspaces; a split-K kernel computes dW1 group by group from them;
    fixed-order reductions add the partials.  Images go through the
    workspaces in chunks that fit ``workspace_bytes`` (default
    ``workspace_budget``).  On the cluster passes (``_backward90``) the
    recompute scale pass leaves a1 in a stash for the gradient pass, chunk
    by chunk.  ``ints`` (the cluster passes, one workspace chunk; the card
    tests) also returns the call's own dW1 operands and scales: (outputs,
    (a0q, dh1q (B, HW, H) int8, the groups' dW1 scales (B * HW/Pt,)))."""
    _check_inputs(fold, coords, w)
    if ints and (fold.device.type == "cpu" or int8_route(
            coords.shape[0], fold.shape[2], passes) != "sm90"):
        raise ValueError("ints reads the cluster passes' workspaces")
    if fold.device.type == "cpu":
        return decoder_tail_int8_backward_reference(
            fold, coords, w.w1q, w.sw, w.b1, w.wht, a1, y, g)
    lib = _lib()
    dev = fold.device
    b, _, h = fold.shape
    hw, no = coords.shape[0], w.wht.shape[0]
    pt = pick_tile(hw)
    gpi = hw // pt                                # groups per image
    blocks = -(-hw // BLOCK_PIXELS)               # blocks per image
    hwp = blocks * BLOCK_PIXELS
    kp = padded_hidden(h)
    if a1 is not None and (a1.dtype != torch.bfloat16
                           or a1.shape != (b, hw, h)
                           or not a1.is_contiguous()):
        raise ValueError("a1 must be the contiguous bf16 (B, HW, H) "
                         "residual")
    g = g.float().contiguous()
    y = y.contiguous()
    budget = workspace_budget(dev) if workspace_bytes is None \
        else workspace_bytes
    if int8_route(hw, h, passes) == "sm90":
        return _backward90(lib, fold, coords, w, a1, y, g, budget, ints)
    w1qt, w1q, sw, b1, wht, bht = w.kernel_args()
    f32 = dict(dtype=torch.float32, device=dev)
    mw = h + no * h + no                          # [db1 | dWh^T | dbh]
    part_max = torch.empty((b * blocks,), **f32)
    gscale = torch.empty((b * gpi,), **f32)
    part_fold = torch.empty((b * blocks, 3, h), **f32)
    part_w = torch.empty((b * blocks, mw), **f32)
    block = lib.svt_int8_ws_block(h)               # the wide tiles
    chunks = image_chunks(b, 2 * kp * hwp + blocks * block, budget)
    bc = chunks[0][1]
    aq_ws = torch.empty((bc, kp, hwp), dtype=torch.int8, device=dev)
    q_ws = torch.empty((bc, kp, hwp), dtype=torch.int8, device=dev)
    ws = (torch.empty((bc * blocks * block,), dtype=torch.uint8, device=dev)
          if block else None)
    part_dw = torch.empty((sum(dw_splits(n * gpi) for _, n in chunks), h, h),
                          **f32)
    with torch.cuda.device(dev):
        st = _stream(fold)

        def common(b0):
            return (fold.data_ptr() + b0 * 4 * h * 4, coords.data_ptr(),
                    w1qt.data_ptr(), sw.data_ptr(), b1.data_ptr(),
                    wht.data_ptr(),
                    None if a1 is None else a1.data_ptr() + b0 * hw * h * 2,
                    y.data_ptr() + b0 * no * hw * 4,
                    g.data_ptr() + b0 * no * hw * 4)

        # the scale pass takes no workspace at H <= 512: one launch
        for b0, n in (chunks if block else [(0, b)]):
            _call(lib, "svt_int8_decoder_bwd_scale", *common(b0),
                  part_max[b0 * blocks:].data_ptr(), ptr(ws), n, hw, h, no,
                  int(w.bf16), st)
            LAUNCHES["bwd_scale"] += 1
        split0 = 0
        for b0, n in chunks:
            _call(lib, "svt_int8_decoder_bwd_grad", *common(0),
                  w1q.data_ptr(), part_max.data_ptr(), gscale.data_ptr(),
                  aq_ws.data_ptr(), q_ws.data_ptr(), part_fold.data_ptr(),
                  part_w.data_ptr(), ptr(ws), b0, n, hw, h, no, pt,
                  int(w.bf16), st)
            LAUNCHES["bwd_grad"] += 1
            split0 += run_grouped_dw(lib, aq_ws, q_ws, gscale[b0 * gpi:],
                                     part_dw[split0:], n, hwp, h, pt, gpi, st)
            LAUNCHES["dw"] += 1
        return _sum_partials(lib, st, part_fold, part_dw, split0, part_w,
                             b, blocks, h, no)


def _sum_partials(lib, st, part_fold, part_dw, splits, part_w, b, blocks, h,
                  no) -> tuple:
    """K5's fixed-order reductions of its per-block partials (dfold, db1,
    dWh^T, dbh) and dW1's split partials: (dfold, dW1, db1, dWh^T, dbh)."""
    f32 = dict(dtype=torch.float32, device=part_w.device)
    mw = h + no * h + no
    dfold = torch.zeros((b, 4, h), **f32)
    dw1 = torch.empty((h, h), **f32)
    sums = torch.empty((mw,), **f32)
    stage = torch.empty((-(-b * blocks // 64), mw), **f32)
    for src, dst, rows, total, m, stride in (
            (part_fold, dfold, blocks, b * blocks, 3 * h, 4 * h),
            (part_dw, dw1, splits, splits, h * h, 0),
            (part_w, stage, 64, b * blocks, mw, mw),
            (stage, sums, stage.shape[0], stage.shape[0], mw, 0)):
        _call(lib, "svt_sum_rows", src.data_ptr(), dst.data_ptr(), rows,
              total, m, stride, st)
        LAUNCHES["sum"] += 1
    return (dfold, dw1, sums[:h], sums[h:h + no * h].view(no, h),
            sums[h + no * h:])


def workspace90_chunks(b: int, hw: int, recompute: bool, budget: int,
                       h: int = CLUSTER_WIDTH) -> list:
    """[(first image, images)] of the cluster K5's chunks at width ``h``:
    each chunk's workspaces (``workspace90_bytes`` per image) within
    ``budget``."""
    return image_chunks(b, workspace90_bytes(hw, recompute, h), budget)


def _backward90(lib, fold, coords, w: Int8Weights, a1, y, g,
                budget: int, ints: bool = False) -> tuple:
    """K5 on the cluster passes (``csrc/fused_decoder_int8_sm90.cu``, past
    H = 512 ``csrc/fused_decoder_int8_sm90_wide.cu``): the scale pass (from
    the residual, one launch over every image; with recompute, per chunk,
    on the forward's cluster machinery, leaving a1 in the chunk's stash),
    the gradient pass per chunk, and per chunk dW1 on K3's cluster kernel
    (``svt_loss90_dw``, groups of ``pick_tile(HW)`` pixels), then the
    fixed-order sums.  Every workspace and stash block has
    ``cluster_rows(h)`` rows."""
    from spatialvae_torch.kernels.fused_loss_int8 import (cluster_rows,
                                                          dw_splits90,
                                                          sm90_ws_tiles)

    dev = fold.device
    b, _, h = fold.shape
    hw, no = coords.shape[0], w.wht.shape[0]
    pt = pick_tile(hw)
    gpi = hw // pt
    blocks = hw // BLOCK_PIXELS
    wide = h > CLUSTER_WIDTH
    rows = cluster_rows(h)
    sw, b1, wht, _ = w.operands()
    recompute = a1 is None
    if wide:
        hslabs = w.slabs90w_t() if recompute else None
        slabs = w.slabs90w()
        slots, nslots = wide_slots(lib, h, dev)
        tail = (slots.data_ptr(), nslots)
    else:
        hslabs = w.half_slabs90() if recompute else None
        slabs = w.slabs90()
        tail = ()
    f32 = dict(dtype=torch.float32, device=dev)
    mw = h + no * h + no
    part_max = torch.empty((b * blocks,), **f32)
    gscale = torch.empty((b * gpi,), **f32)
    part_fold = torch.empty((b * blocks, 3, h), **f32)
    part_w = torch.empty((b * blocks, mw), **f32)
    chunks = workspace90_chunks(b, hw, recompute, budget, h)
    bc = chunks[0][1]
    aq_ws = torch.empty((bc * hw * rows,), dtype=torch.int8, device=dev)
    q_ws = torch.empty_like(aq_ws)
    stash = (torch.empty((bc * hw * rows,), **f32) if recompute
             else None)
    fn = "svt_int8_90w_" if wide else "svt_int8_90_"
    part_dw = torch.empty((sum(dw_splits90(n * gpi) for _, n in chunks), h,
                           h), **f32)
    bf16 = int(w.bf16)
    with torch.cuda.device(dev):
        st = _stream(fold)

        def scale(b0, n):
            _call(lib, fn + "scale", fold.data_ptr(),
                  coords.data_ptr(), ptr(hslabs), sw.data_ptr(),
                  b1.data_ptr(), wht.data_ptr(), ptr(a1), y.data_ptr(),
                  g.data_ptr(), part_max.data_ptr(), ptr(stash), *tail, b0,
                  n, hw, h, no, bf16, st)
            LAUNCHES["bwd_scale_sm90"] += 1

        if not recompute:
            scale(0, b)
        split0 = 0
        for b0, n in chunks:
            if recompute:
                scale(b0, n)
            _call(lib, fn + "grad", fold.data_ptr(),
                  coords.data_ptr(), slabs.data_ptr(), sw.data_ptr(),
                  wht.data_ptr(), ptr(a1), ptr(stash), y.data_ptr(),
                  g.data_ptr(), part_max.data_ptr(), gscale.data_ptr(),
                  aq_ws.data_ptr(), q_ws.data_ptr(), part_fold.data_ptr(),
                  part_w.data_ptr(), *tail, b0, n, hw, h, no, pt, bf16, st)
            LAUNCHES["bwd_grad_sm90"] += 1
            splits = dw_splits90(n * gpi)
            _call(lib, "svt_loss90_dw", aq_ws.data_ptr(), q_ws.data_ptr(),
                  gscale[b0 * gpi:].data_ptr(), part_dw[split0:].data_ptr(),
                  n, hw, h, pt, splits, st)
            LAUNCHES["dw_sm90"] += 1
            split0 += splits
        out = _sum_partials(lib, st, part_fold, part_dw, split0, part_w, b,
                            blocks, h, no)
    if not ints:
        return out
    if len(chunks) > 1:
        raise ValueError("ints takes one workspace chunk")
    tiles = [sm90_ws_tiles(t[:b * hw * rows], b, hw)[..., :h]
             for t in (aq_ws, q_ws)]
    return out, (*tiles, gscale)


def sm90_max_clusters(wide: bool = False) -> dict:
    """The clusters of CLUSTER CTAs the card holds at once for each of the
    cluster passes' kernels (cudaOccupancyMaxActiveClusters); ``wide``:
    the wide unit's."""
    lib = _lib()
    fn = lib.svt_int8_90w_max_clusters if wide else \
        lib.svt_int8_90_max_clusters
    names = ("fwd_bf16", "fwd_f32", "fwd_a1", "scale_recompute",
             "grad_residual", "grad_recompute")
    return {k: fn(i) for i, k in enumerate(names)}


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


class _Int8Tail(torch.autograd.Function):
    """Counterpart of the JAX ``fused_decoder_tail_int8`` custom VJP: fold
    and the float weights are differentiable inputs (W1q and sw are derived
    from w1 on every call); coords is not."""

    @staticmethod
    def forward(ctx, fold, coords, w1, b1, wht, bht):
        w = Int8Weights(w1, b1, wht, bht)
        _check_inputs(fold, coords, w)
        b, _, h = fold.shape
        hw = coords.shape[0]
        if save_residual(b, hw, h, 1, torch.bfloat16,
                         residual_budget(fold.device)):
            y, a1 = run_int8_tail(fold, coords, w, emit_a1=True)
        else:
            y, a1 = run_int8_tail(fold, coords, w), None
        ctx.save_for_backward(fold, coords, y, a1)
        ctx.weights = w
        ctx.dtypes = (fold.dtype, w1.dtype, b1.dtype, wht.dtype, bht.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        fold, coords, y, a1 = ctx.saved_tensors
        grads = run_int8_tail_backward(fold, coords, ctx.weights, a1, y, gy)
        dfold, dw1, db1, dwht, dbht = (
            t.to(dt) for t, dt in zip(grads, ctx.dtypes))
        return dfold, None, dw1, db1, dwht, dbht


def fused_decoder_tail_int8(fold: torch.Tensor, coords: torch.Tensor,
                            w1: torch.Tensor, b1: torch.Tensor,
                            wht: torch.Tensor, bht: torch.Tensor
                            ) -> torch.Tensor:
    """w1 (H, H) [in][out]; b1 (H,); wht (No, H); bht (No,), all f32 or all
    bf16; fold (B, 4, H) f32; coords (HW, 2) f32.  Returns (B, No, HW) f32.
    With grad enabled and an input that requires it, the differentiable op
    (it saves the bf16 a1 when ``save_residual`` allows, else the backward
    rebuilds it); otherwise K4 alone."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (fold, w1, b1, wht, bht)):
        return _Int8Tail.apply(fold, coords, w1, b1, wht, bht)
    return run_int8_tail(fold, coords, Int8Weights(w1, b1, wht, bht))


def fused_spatial_generator_int8(gen: SpatialGenerator, coords: torch.Tensor,
                                 theta: Optional[torch.Tensor],
                                 dx: Optional[torch.Tensor],
                                 z: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX ``fused_spatial_generator_int8``: the pose fold in PyTorch,
    coords zero-padded to a multiple of 256 pixels, the int8 tail, the
    padding sliced off.  Returns (B, HW, n_out)."""
    if not can_fuse_int8(gen.cfg, coords.shape[0]):
        raise ValueError(f"config not supported by the int8 decoder: "
                         f"{gen.cfg}")
    w0, w1f, c = fold_pose_into_first_layer(gen, theta, dx, z)
    fold = torch.stack([w0, w1f, c, torch.zeros_like(c)], dim=1)
    fold = fold.float().contiguous()
    hidden, head = gen.linears()
    hw = coords.shape[0]
    coords_p = F.pad(coords.float(), (0, 0, 0, (-hw) % 256)).contiguous()
    yt = fused_decoder_tail_int8(fold, coords_p, hidden.weight.T.contiguous(),
                                 hidden.bias, head.weight.contiguous(),
                                 head.bias)
    y = yt[..., :hw].transpose(1, 2)
    if gen.cfg.softplus:
        y = torch.cat([F.softplus(y[..., :1]), y[..., 1:]], dim=-1)
    return y
