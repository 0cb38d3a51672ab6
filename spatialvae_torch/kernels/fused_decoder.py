"""Fused spatial-decoder tail: hand-written sm_90a CUDA kernels, forward and
backward, under one ``torch.autograd.Function``.

Counterpart of ``spatialvae_tpu/kernels/fused_decoder.py`` (the custom-VJP
op ``fused_decoder_tail``: Pallas ``_fwd_kernel`` and ``_bwd_kernel``).  Per
(image b, pixel p):

    h0  = x0[p]*w0[b] + x1[p]*w1[b] + c[b]       # pose-folded first layer
    a0  = tanh(h0)
    a_l = tanh(a_{l-1} @ W_l + b_l [+ a_{l-1}])  # Lh hidden (H, H) layers
    y   = sigmoid(a_Lh @ Wh + bh)                # (H, n_out) head

with the activation cast to the weight dtype before each product and f32
accumulation.  Two designs run it on the card, and ``decoder_route`` alone
picks one per call:

- "sm90", every call but the narrow deep decoders (two hidden layers
  under 288 wide, three or four under 448: ``DEEP_MIN_WIDTH``): thread
  block clusters of four 64-pixel tiles that share one multicast stream of
  W's slabs (``decoder_slabs``, laid out once per weight version and cached
  on ``TailWeights``), TF32 (three products, f32 weights) or bf16 wgmma,
  the product's A operand built slab by slab, dW from K-major workspaces
  (64-pixel blocks of (rows, 64 pixels), swizzled as the slabs are) on a
  cluster kernel.  One hidden layer at most 512 wide (every CLI's default
  decoder) takes ``csrc/fused_decoder_sm90.cu``: one forward launch, one
  chain launch and one dW1 launch.  Every other width and depth takes
  ``csrc/fused_decoder_sm90_deep.cu``: one launch per layer and direction,
  each product in output column chunks of 512; the forward's layer passes
  hand a_l to the next through an f32 buffer (B, HW, H), the chain's
  passes (l = Lh .. 1) hand da_{l-1} down through two, and each chain pass
  is followed by its layer's dW launch;
- "tile" (``csrc/fused_decoder_fwd.cu``, ``csrc/fused_decoder_bwd.cu``),
  the narrow deep decoders, where it measured faster, and the A/B turns'
  and card tests' yardstick (``tile_kernels=True``): one block per
  64-pixel tile streaming W from L2, a split-K dW GEMM.

Both keep their per-block partials out of atomics and reduce them in a
fixed order.

``decoder_tail_reference`` and ``decoder_tail_backward_reference`` are the
two in eager PyTorch, with the kernels' casts.  The wrappers run them for CPU
tensors only; for CUDA tensors they launch the kernels or raise.  They refuse,
on every device, what the kernels cannot take.  Any hidden width runs; the
buffers and workspaces the launches need are allocated by the wrappers,
which launch the images in chunks that keep them within
``workspace_budget``.  Under no_grad (serving, evaluation) nothing is saved
and no activation is written; with grad the forward saves the (Lh, B, HW,
H) activations when they fit ``residual_budget`` and the backward
recomputes them otherwise, as the JAX VJP does with its own limit.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from spatialvae_torch.config import SpatialGeneratorConfig
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    fold_pose_into_first_layer,
)
from spatialvae_torch.precision import fp32_precision

MAX_HIDDEN_LAYERS = 4
MAX_OUT = 8
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches on CUDA tensors, by kernel: the forward without and with
# the activation output (``fwd``, ``fwd_acts``), the forward the backward
# reruns to recompute them (``fwd_recompute``), and the backward's chain,
# dW and reduction kernels; the "sm90" route's kernels count under the keys
# with "_sm90" (one per launch: a layer pass of the deep kernels counts
# once), the reductions (one kernel for both routes) under ``bwd_sum``.
# The CPU path launches nothing.
LAUNCHES = {"fwd": 0, "fwd_acts": 0, "fwd_recompute": 0, "bwd_chain": 0,
            "bwd_dw": 0, "bwd_sum": 0, "fwd_sm90": 0, "fwd_acts_sm90": 0,
            "fwd_recompute_sm90": 0, "bwd_chain_sm90": 0, "bwd_dw_sm90": 0}

# The "sm90" kernels (csrc/fused_decoder_sm90.cu and _deep.cu): CLUSTER
# CTAs of one 64-pixel tile each share W's slab stream; every product runs
# in output column chunks of SM90_WIDTH rows (zero past H); a slab is
# SLAB_BYTES K-bytes of each row; each split-K partial of the dW kernels
# sums DW_SPLIT_BLOCKS 64-pixel blocks (4,096 pixels, as the tile kernels'
# chunks: a longer f32 sum inside one accumulator read a mean error of
# 2.5e-5 of max|dW1| at B=100 against the limit 1e-5).
CLUSTER = 4
SM90_WIDTH = 512
# The narrowest hidden width at which the deep sm90 kernels take Lh >= 2
# hidden layers: the narrowest width at which they ran K1, K1 with
# activations and K2 no slower than the tile kernels in turns on the card
# in both weight dtypes (B=100, HW = 4,096; ``chip_smoke.py --sweep
# dec90``, PERF.md: 256 and 384 lost a call, 288 and 448 none), so the
# route keeps the tile kernels below it.
DEEP_MIN_WIDTH = {2: 288, 3: 448, 4: 448}
SLAB_BYTES = 64
BLOCK_PIXELS = 64
DW_SPLIT_BLOCKS = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def decoder_route(hw: int, h: int, lh: int, no: int,
                  tile_kernels: bool = False) -> str:
    """The kernels a call of hidden width ``h``, ``lh`` hidden layers and
    ``no`` outputs runs on the card, at any pixel count ``hw``: "sm90" for
    one hidden layer at any width and for Lh >= 2 hidden layers from
    DEEP_MIN_WIDTH[Lh] (f32 or bf16 weights, with or without the residual
    add, every emit mode and both backward variants); "tile" for the
    narrower deep decoders and for a call whose caller asks for the tile
    kernels (``tile_kernels``: the A/B turns and card tests).  Within
    "sm90", ``single_pass`` says which of its two sources takes the call.
    The route is chosen here alone, by shape; the launches pass it on, and
    the "sm90" entry points refuse a call this table does not send them."""
    if hw < 1 or h < 1 or not 1 <= lh <= MAX_HIDDEN_LAYERS \
            or not 1 <= no <= MAX_OUT:
        raise ValueError(f"no route for hw={hw}, h={h}, lh={lh}, no={no}")
    if tile_kernels or (lh > 1 and h < DEEP_MIN_WIDTH[lh]):
        return "tile"
    return "sm90"


def single_pass(h: int, lh: int) -> bool:
    """Whether an "sm90" call takes ``csrc/fused_decoder_sm90.cu`` (one
    hidden layer at most SM90_WIDTH wide: one launch a direction) rather
    than the layer passes of ``csrc/fused_decoder_sm90_deep.cu``."""
    return lh == 1 and h <= SM90_WIDTH


def sm90_rows(h: int) -> int:
    """Output rows of an sm90 product over ``h`` units: whole chunks of
    SM90_WIDTH (the slab streams' and dW workspaces' rows)."""
    return -(-h // SM90_WIDTH) * SM90_WIDTH


def _require_route(route: str, hw: int, h: int, lh: int, no: int) -> None:
    if route not in ("sm90", "tile"):
        raise ValueError(f"unknown route {route!r}")
    try:
        want = decoder_route(hw, h, lh, no)
    except ValueError:
        want = None
    if route == "sm90" and want != "sm90":
        raise ValueError(f"the sm90 kernels do not take hw={hw}, h={h}, "
                         f"lh={lh}, no={no}")


def can_fuse_decoder(cfg: SpatialGeneratorConfig, hw: int) -> bool:
    """The JAX package's gate (foldable, 2..5 layers, n_out <= 8,
    hw >= 256) plus tanh, which the kernel hard-codes and the JAX gate
    never checked (ROADMAP, Queue 3).  Configs outside it take the plain
    folded decoder.  Like the JAX gate it admits any hidden_dim, and so do
    the kernels."""
    return (not cfg.expand_coords and not cfg.bilinear
            and 2 <= cfg.num_layers <= 5 and cfg.n_out <= 8 and hw >= 256
            and cfg.activation == "tanh")


# ---------------------------------------------------------------------------
# the residual rule
# ---------------------------------------------------------------------------


@functools.cache
def _total_memory(device_type: str, index: Optional[int]) -> int:
    if device_type == "cuda":
        return torch.cuda.get_device_properties(index).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def residual_budget(device: torch.device) -> int:
    """Largest activation residual (bytes) the forward saves on ``device``:
    half its total memory, read once per device.  Never the free memory, so
    the path a shape takes does not depend on what else is allocated.  (The
    JAX package's 8.5 GiB was sized for a 15.75 GB TPU.)"""
    device = torch.device(device)
    index = device.index
    if device.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return _total_memory(device.type, index) // 2


def save_residual(b: int, hw: int, h: int, lh: int, dtype: torch.dtype,
                  budget: int) -> bool:
    """Whether the (Lh, B, HW, H) residual in ``dtype`` fits ``budget``."""
    return lh * b * hw * h * torch.finfo(dtype).bits // 8 <= budget


def workspace_budget(device: torch.device) -> int:
    """Bytes the CUDA backward's per-chunk workspaces may take (an eighth of
    the card's memory); it runs over chunks of images to stay within."""
    return residual_budget(device) // 4


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


@fp32_precision()
def decoder_tail_reference(fold: torch.Tensor, coords: torch.Tensor,
                           whid: torch.Tensor, bhid: torch.Tensor,
                           wht: torch.Tensor, bht: torch.Tensor,
                           resid: bool = False, return_acts: bool = False):
    """Plain PyTorch version of the forward kernel, with its casts.

    fold: (B, 4, H) rows [w0, w1, c, unused]; coords: (HW, 2);
    whid: (Lh, H, H) [in, out]; bhid: (Lh, H); wht: (No, H); bht: (No,).
    Returns the sigmoid head output (B, No, HW) float32, and with
    ``return_acts`` also a_1..a_Lh as (Lh, B, HW, H) in the weight dtype
    (the emitting kernel's residual)."""
    wdt = whid.dtype
    a = torch.tanh(_first_layer(fold, coords))        # (B, HW, H)
    acts = []
    for l in range(whid.shape[0]):
        h = a.to(wdt).float() @ whid[l].float() + bhid[l].float()
        if resid:
            h = h + a
        a = torch.tanh(h)
        if return_acts:
            acts.append(a.to(wdt))
    z = a.to(wdt).float() @ wht.float().T + bht.float()   # (B, HW, No)
    y = torch.sigmoid(z).transpose(1, 2)
    return (y, torch.stack(acts)) if return_acts else y


def _first_layer(fold, coords):
    x0 = coords[:, 0].float()[None, :, None]
    x1 = coords[:, 1].float()[None, :, None]
    fold = fold.float()
    return (x0 * fold[:, 0][:, None, :] + x1 * fold[:, 1][:, None, :]
            + fold[:, 2][:, None, :])                 # (B, HW, H)


@fp32_precision()
def decoder_tail_backward_reference(fold, coords, whid, bhid, wht,
                                    acts: Optional[torch.Tensor], y, g,
                                    resid: bool = False):
    """Plain PyTorch version of the backward kernels: the JAX
    ``_bwd_pallas`` inputs and outputs, with its casts.

    acts: the (Lh, B, HW, H) residual, or None to recompute the chain in
    f32; y: the forward's (B, No, HW) output; g: its cotangent.  dz2, dh,
    a_Lh and a_{l-1} are cast to the weight dtype before the products that
    take them, with f32 accumulation; the bias gradients sum the un-cast
    dz2 and dh.  Returns float32 (dfold (B, 4, H) with row 3 zero, dWhid
    (Lh, H, H), dbhid (Lh, H), dWh^T (No, H), dbh (No,)).  (Autograd through
    ``decoder_tail_reference`` rounds nothing in the backward, so it is not
    this function.)"""
    wdt = whid.dtype
    cast = lambda t: t.to(wdt).float()
    a0 = torch.tanh(_first_layer(fold, coords))      # (B, HW, H)
    if acts is not None:
        act = [acts[l].float() for l in range(acts.shape[0])]
    else:
        act, a = [], a0
        for l in range(whid.shape[0]):
            h = cast(a) @ whid[l].float() + bhid[l].float()
            if resid:
                h = h + a
            a = torch.tanh(h)
            act.append(a)
    s = y.float()
    dz2 = g.float() * s * (1.0 - s)                  # (B, No, HW)
    dz2c = cast(dz2)
    dwht = torch.einsum("bop,bph->oh", dz2c, cast(act[-1]))
    dbht = dz2.sum(dim=(0, 2))
    da = torch.einsum("bop,oh->bph", dz2c, wht.float())
    dwh, dbh = [None] * len(act), [None] * len(act)
    for l in range(len(act) - 1, -1, -1):
        a_in = act[l - 1] if l > 0 else a0
        dh = da * (1.0 - act[l] * act[l])
        dhc = cast(dh)
        dwh[l] = torch.einsum("bpi,bpj->ij", cast(a_in), dhc)
        dbh[l] = dh.sum(dim=(0, 1))
        da = dhc @ whid[l].float().T
        if resid:
            da = da + dh
    dh0 = da * (1.0 - a0 * a0)
    x0 = coords[:, 0].float()[None, :, None]
    x1 = coords[:, 1].float()[None, :, None]
    dfold = torch.stack([(x0 * dh0).sum(1), (x1 * dh0).sum(1), dh0.sum(1),
                         torch.zeros_like(dh0[:, 0])], dim=1)
    return dfold, torch.stack(dwh), torch.stack(dbh), dwht, dbht


# ---------------------------------------------------------------------------
# checks and packed weights
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the sm90 kernels' operand layouts
# ---------------------------------------------------------------------------


def padded_hidden(h: int) -> int:
    """The K extent of the kernels' padded operands: H up to a multiple of
    32."""
    return -(-h // 32) * 32


def slab_k(k: int) -> int:
    """The K extent of the sm90 slab streams: K up to a multiple of 64 (a
    whole number of the kernels' slabs in f32 and bf16)."""
    return -(-k // 64) * 64


def _swizzle64(t: torch.Tensor) -> torch.Tensor:
    """(..., R, 4, E) rows of 64 bytes in four 16-byte chunks -> wgmma's
    64-byte swizzle: chunk c of row r to chunk c ^ ((r >> 1) & 3)
    (``csrc/sm90.cuh`` ``offset_sw64``); its own inverse."""
    r = torch.arange(t.shape[-3], device=t.device)
    idx = torch.arange(4, device=t.device)[None, :] ^ ((r[:, None] >> 1) & 3)
    idx = idx[..., None].expand(t.shape[-3:])
    return torch.gather(t, -2, idx.expand(t.shape))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 values: round to 10 mantissa bits,
    ties away from zero, the low 13 bits zero (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple:
    """x = hi + lo with hi = rna(x) and lo = rna(x - hi), both TF32: the
    planes of the three-product split (hi.hi + hi.lo + lo.hi)."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(P, ...) operand planes: bf16 values as they are (P = 1), float32 as
    its TF32 head and tail (P = 2)."""
    if x.dtype == torch.bfloat16:
        return x[None]
    return torch.stack(tf32_split(x))


def _chunk_values(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in a 16-byte chunk of a 64-byte operand row."""
    return 128 // torch.finfo(dtype).bits


def decoder_slabs(w: torch.Tensor) -> torch.Tensor:
    """An (N, K) float32 or bfloat16 matrix given as rows [n][k] -> the sm90
    kernels' slab stream: zero-padded to (``sm90_rows(N)``, Kp), Kp =
    ``slab_k(K)``, and laid out chunk by chunk of SM90_WIDTH rows (the
    products' output column chunks, in order).  A chunk is cut into Kp/KS
    units of KS = SLAB_BYTES/element-size K values (16 f32, 32 bf16), each
    unit its planes (f32: the TF32 head, then the tail; bf16: the values)
    of (SM90_WIDTH, KS) in wgmma's 64-byte swizzled K-major layout (16-byte
    chunk c of row n at chunk c ^ ((n >> 1) & 3)).  One contiguous 1-D
    tensor of the weight dtype (float32 for f32): a kernel's slab is one
    unit or two consecutive ones, and every quarter of a slab is one bulk
    copy.  The grad path lays W out on every step, so this is a handful
    of ops: the padded planes, then one gather through a cached index."""
    n, k = w.shape
    kp = slab_k(k)
    rows = sm90_rows(n)
    planes = _planes(F.pad(w, (0, kp - k, 0, rows - n)))
    # (P, chunks * SM90_WIDTH, Kp) -> chunk-major (chunks, P, SM90_WIDTH, Kp)
    chunks = planes.reshape(planes.shape[0], rows // SM90_WIDTH, -1)
    chunks = chunks.transpose(0, 1).reshape(rows // SM90_WIDTH, -1)
    idx = _slab_index(planes.shape[0], kp, _chunk_values(w.dtype), w.device)
    return chunks[:, idx].reshape(-1)


@functools.cache
def _slab_index(n_planes: int, kp: int, e: int,
                device: torch.device) -> torch.Tensor:
    """Where each element of one chunk's slab stream comes from in its
    flattened (P, SM90_WIDTH, Kp) planes (``decoder_slabs``'
    permutation)."""
    src = torch.arange(n_planes * SM90_WIDTH * kp, device=device)
    t = src.reshape(n_planes, SM90_WIDTH, kp // (4 * e), 4, e)
    return _swizzle64(t.permute(2, 0, 1, 3, 4).contiguous()).reshape(-1)


def dw90_splits(nblocks: int) -> int:
    """Split-K partials of one launch of an sm90 dW kernel over ``nblocks``
    64-pixel blocks: one per DW_SPLIT_BLOCKS blocks."""
    return -(-nblocks // DW_SPLIT_BLOCKS)


def deep_ws_block(h: int, bf16: bool) -> int:
    """Bytes of one 64-pixel block of each dW operand workspace of the
    deep kernels (``svt_decoder90_deep_ws_block``): ``sm90_rows(h)`` rows
    x 64 pixels of the weight dtype."""
    return sm90_rows(h) * BLOCK_PIXELS * (2 if bf16 else 4)


class TailWeights:
    """The decoder tail's weights, checked once: whid (Lh, H_in, H_out),
    bhid (Lh, H), wht (No, H), bht (No,), all float32 or all bfloat16,
    contiguous, on one device, none of them tracked by autograd.

    The launches' operands are built on first use and kept: ``head_args()``
    the float32 copies of bhid, wht and bht (widening bf16 is exact, and a
    flag keeps the bf16 casts); for the tile kernels ``kernel_args()`` adds
    whid as f32 zero-padded to (Lh, Hp, Hp), Hp a multiple of 32, and
    ``whid_t()`` the padded W_l^T the backward streams; for the sm90
    kernels ``sm90_slabs(l)`` is W_l^T's slab stream (the forward's B
    operand: N = output unit) and ``sm90_slabs_t(l)`` W_l's (the chain's:
    N = input unit), in the weight dtype, layer l counted from 0."""

    def __init__(self, whid, bhid, wht, bht):
        _check_weights(whid, bhid, wht, bht)
        self.whid, self.bhid, self.wht, self.bht = (
            t.detach() for t in (whid, bhid, wht, bht))
        self._head_args = None
        self._kernel_args = None
        self._whid_t = None
        self._slabs = {}
        self._slabs_t = {}

    @property
    def bf16(self) -> bool:
        return self.whid.dtype == torch.bfloat16

    def _pad(self, w):
        h = w.shape[1]
        hp = padded_hidden(h)
        return F.pad(w.float(), (0, hp - h, 0, hp - h)).contiguous()

    def head_args(self) -> tuple:
        if self._head_args is None:
            self._head_args = tuple(t.float().contiguous()
                                    for t in (self.bhid, self.wht, self.bht))
        return self._head_args

    def kernel_args(self) -> tuple:
        if self._kernel_args is None:
            self._kernel_args = (self._pad(self.whid), *self.head_args())
        return self._kernel_args

    def sm90_slabs(self, layer: int = 0) -> torch.Tensor:
        if layer not in self._slabs:
            self._slabs[layer] = decoder_slabs(self.whid[layer].T)
        return self._slabs[layer]

    def sm90_slabs_t(self, layer: int = 0) -> torch.Tensor:
        if layer not in self._slabs_t:
            self._slabs_t[layer] = decoder_slabs(self.whid[layer])
        return self._slabs_t[layer]

    def whid_t(self) -> torch.Tensor:
        if self._whid_t is None:
            self._whid_t = self._pad(self.whid.transpose(1, 2))
        return self._whid_t


def generator_tail_weights(gen: SpatialGenerator) -> TailWeights:
    """gen's hidden layers and head as ``TailWeights`` for the no-grad path,
    cached on gen until one of those tensors changes: an in-place update
    (``load_state_dict``, an optimizer step: Adam's kernels write through
    raw pointers and then bump the versions themselves,
    ``kernels/adam.mark_written``) bumps its version, and a replaced tensor
    (``.to``) has another address.  A write that bypasses the counter
    (``.data``) must be followed by ``mark_written``.  The cache holds the
    storages it was built from, so no other tensor can take their addresses
    meanwhile.  (The grad path stacks the weights inside the graph on every
    call instead.)"""
    *hidden, head = gen.linears()
    params = [p for lin in (*hidden, head) for p in (lin.weight, lin.bias)]
    state = [(p.data_ptr(), p._version) for p in params]
    cached = gen.__dict__.get("_fused_tail")
    if cached is not None and cached[0] == state:
        return cached[2]
    with torch.no_grad():
        tw = TailWeights(*_stack_tail(hidden, head))
    gen.__dict__["_fused_tail"] = (state, [p.detach() for p in params], tw)
    return tw


def _stack_tail(hidden, head) -> tuple:
    """(whid, bhid, wht, bht) stacked from the layers; differentiable."""
    return (torch.stack([lin.weight.T for lin in hidden]).contiguous(),
            torch.stack([lin.bias for lin in hidden]),
            head.weight.contiguous(), head.bias)


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


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _lib():
    from spatialvae_torch.kernels._build import load_library

    return load_library()


def _call(lib, fn: str, *args) -> None:
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(
            f"{fn} failed to launch: CUDA error {err} "
            f"({lib.svt_cuda_error_string(err).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def wide_chunks(b: int, blocks: int, block_bytes: int, budget: int) -> list:
    """[(first image, count)] of the launches of a wide kernel whose
    ``blocks`` blocks per image take ``block_bytes`` of workspace each,
    each launch's workspace within ``budget`` (at least one image per
    launch)."""
    bc = max(1, min(b, budget // (blocks * block_bytes)))
    return [(b0, min(bc, b - b0)) for b0 in range(0, b, bc)]


def _launch_fwd(fold, coords, w: TailWeights, resid: bool, emit: int,
                key: str, y=None, acts=None, route: str = "tile") -> tuple:
    """The forward kernel on CUDA tensors, each launch counted in
    ``LAUNCHES[key]`` ("tile") or ``LAUNCHES[key + "_sm90"]`` ("sm90").
    emit 0: y only; 1: also f32 activations; 2: activations rounded to
    bf16.  Where the kernels need buffers (the tile kernels above H = 512,
    the deep passes' f32 layer outputs) the images go in launches whose
    buffers fit ``workspace_budget``.  Returns (y, acts)."""
    b, _, h = fold.shape
    hw, lh, no = coords.shape[0], w.whid.shape[0], w.wht.shape[0]
    _require_route(route, hw, h, lh, no)
    lib = _lib()
    dev = fold.device
    if y is None:
        y = torch.empty((b, no, hw), dtype=torch.float32, device=dev)
    if emit and acts is None:
        acts = torch.empty((lh, b, hw, h), device=dev,
                           dtype=torch.bfloat16 if emit == 2 else
                           torch.float32)
    if route == "sm90" and single_pass(h, lh):
        with torch.cuda.device(dev):
            _call(lib, "svt_decoder90_fwd", fold.data_ptr(),
                  coords.data_ptr(), w.sm90_slabs().data_ptr(),
                  *(t.data_ptr() for t in w.head_args()), y.data_ptr(),
                  acts.data_ptr() if emit else None, b, hw, h, lh, no,
                  int(bool(resid)), int(w.bf16), emit, _stream(fold))
        LAUNCHES[key + "_sm90"] += 1
        return y, acts
    if route == "sm90":
        _launch_fwd_layers(lib, fold, coords, w, resid, emit, key, y, acts)
        return y, acts
    tiles = -(-hw // 64)
    block = lib.svt_fused_decoder_ws_block(h) * 4
    chunks, ws = [(0, b)], None
    if block:
        chunks = wide_chunks(b, tiles, block, workspace_budget(dev))
        ws = torch.empty((chunks[0][1] * tiles * block,), dtype=torch.uint8,
                         device=dev)
    esz = acts.element_size() if emit else 0
    with torch.cuda.device(dev):
        for b0, n in chunks:
            _call(lib, "svt_fused_decoder_fwd",
                  fold.data_ptr() + b0 * 4 * h * 4, coords.data_ptr(),
                  *(t.data_ptr() for t in w.kernel_args()),
                  y.data_ptr() + b0 * no * hw * 4,
                  acts.data_ptr() + b0 * hw * h * esz if emit else None,
                  b * hw * h, ws.data_ptr() if block else None, n, hw, h, lh,
                  no, int(bool(resid)), int(w.bf16), emit, _stream(fold))
            LAUNCHES[key] += 1
    return y, acts


def _image_ptr(t: torch.Tensor, b0: int) -> int:
    """The address of image b0 of a (B, ...) tensor."""
    return t.data_ptr() + b0 * t.stride(0) * t.element_size()


def _launch_fwd_layers(lib, fold, coords, w: TailWeights, resid: bool,
                       emit: int, key: str, y, acts) -> None:
    """The deep kernels' forward: one pass per layer for each chunk of
    images, each pass counted in ``LAUNCHES[key + "_sm90"]``.  Layer l's
    pass reads the f32 a_{l-1} and writes the f32 a_l: with f32
    activations out (emit 1) those are ``acts`` itself, otherwise two
    buffers taken in turns (one for two layers), sized per chunk to
    ``workspace_budget``; with bf16 activations out (emit 2) each pass also
    writes a_l rounded to bf16."""
    b, _, h = fold.shape
    hw, lh, no = coords.shape[0], w.whid.shape[0], w.wht.shape[0]
    dev = fold.device
    nbuf = 0 if emit == 1 else min(lh - 1, 2)
    chunks = [(0, b)]
    if nbuf:
        chunks = wide_chunks(b, 1, nbuf * hw * h * 4, workspace_budget(dev))
    bufs = [torch.empty((chunks[0][1], hw, h), dtype=torch.float32,
                        device=dev) for _ in range(nbuf)]
    bhid, wht, bht = w.head_args()
    with torch.cuda.device(dev):
        st = _stream(fold)
        for b0, n in chunks:
            up = ([_image_ptr(acts[l], b0) for l in range(lh)] if emit == 1
                  else [bufs[l % 2].data_ptr() if l < lh - 1 else None
                        for l in range(lh)])
            for l in range(lh):
                _call(lib, "svt_decoder90_layer",
                      _image_ptr(fold, b0), coords.data_ptr(),
                      w.sm90_slabs(l).data_ptr(), bhid[l].data_ptr(),
                      wht.data_ptr(), bht.data_ptr(),
                      up[l - 1] if l else None, up[l],
                      _image_ptr(acts[l], b0) if emit == 2 else None,
                      _image_ptr(y, b0), n, hw, h, lh, no, l + 1,
                      int(bool(resid)), int(w.bf16), st)
                LAUNCHES[key + "_sm90"] += 1


def _route(fold, coords, w: TailWeights, tile_kernels: bool) -> str:
    return decoder_route(coords.shape[0], fold.shape[2], w.whid.shape[0],
                         w.wht.shape[0], tile_kernels)


def run_decoder_tail(fold: torch.Tensor, coords: torch.Tensor,
                     weights: TailWeights, resid: bool = False,
                     tile_kernels: bool = False) -> torch.Tensor:
    """The forward without activations (serving, evaluation).  fold:
    (B, 4, H) f32; coords: (HW, 2) f32.  Returns (B, No, HW) float32.

    CPU tensors take ``decoder_tail_reference``; CUDA tensors launch the
    kernel of ``decoder_route`` (``tile_kernels`` forces the tile kernel),
    count it in ``LAUNCHES["fwd"]`` or ``["fwd_sm90"]``, and raise if the
    build or the launch fails."""
    _check_inputs(fold, coords, weights)
    w = weights
    if fold.device.type == "cpu":
        return decoder_tail_reference(fold, coords, w.whid, w.bhid, w.wht,
                                      w.bht, resid)
    y, _ = _launch_fwd(fold, coords, w, resid, 0, "fwd",
                       route=_route(fold, coords, w, tile_kernels))
    return y


def run_decoder_tail_acts(fold: torch.Tensor, coords: torch.Tensor,
                          weights: TailWeights, resid: bool = False,
                          tile_kernels: bool = False) -> tuple:
    """The training forward: (y, acts), acts = a_1..a_Lh as (Lh, B, HW, H)
    in the weight dtype, the backward's residual.  CPU tensors take
    ``decoder_tail_reference``; CUDA tensors launch the emitting kernel of
    ``decoder_route`` and count it in ``LAUNCHES["fwd_acts"]`` or
    ``["fwd_acts_sm90"]``."""
    _check_inputs(fold, coords, weights)
    w = weights
    if fold.device.type == "cpu":
        return decoder_tail_reference(fold, coords, w.whid, w.bhid, w.wht,
                                      w.bht, resid, return_acts=True)
    return _launch_fwd(fold, coords, w, resid, 2 if w.bf16 else 1,
                       "fwd_acts",
                       route=_route(fold, coords, w, tile_kernels))


def run_decoder_tail_backward(fold, coords, w: TailWeights,
                              acts: Optional[torch.Tensor], y, g,
                              resid: bool = False,
                              workspace_bytes: Optional[int] = None,
                              tile_kernels: bool = False):
    """The backward, with the outputs of ``decoder_tail_backward_reference``:
    that function for CPU tensors, the kernels of ``decoder_route`` for CUDA
    tensors (a failed build or launch raises).  ``acts`` is the forward's
    residual or None (recompute: the forward kernel reruns with f32
    activations into a workspace).  On the card, images go through the
    chain and dW kernels in chunks whose workspaces fit ``workspace_bytes``
    (default ``workspace_budget``); the partials of all chunks are then
    reduced in a fixed order, so the result does not depend on the
    chunking's schedule."""
    if fold.device.type == "cpu":
        return decoder_tail_backward_reference(
            fold, coords, w.whid, w.bhid, w.wht, acts, y, g, resid)
    route = _route(fold, coords, w, tile_kernels)
    lib = _lib()
    dev = fold.device
    b, _, h = fold.shape
    hw, lh, no = coords.shape[0], w.whid.shape[0], w.wht.shape[0]
    wdt = w.whid.dtype
    recompute = acts is None
    act_bf16 = not recompute and acts.dtype == torch.bfloat16
    tiles = -(-hw // 64)
    sm90 = route == "sm90"
    deep = sm90 and not single_pass(h, lh)
    # the deep chain's da buffers: da_{l-1} handed down, two in turns
    nda = min(lh - 1, 2) if deep else 0
    if deep:
        block = 2 * deep_ws_block(h, w.bf16)    # the dW operand workspaces
        per_image = ((lh if recompute else 0) + nda) * hw * h * 4 \
            + tiles * block
    elif sm90:
        # the chain's two dW1 operand workspaces
        block = 2 * lib.svt_decoder90_ws_block(int(w.bf16))
        per_image = (hw * h * 4 if recompute else 0) + tiles * block
    else:
        block = lib.svt_fused_decoder_ws_block(h) * 4  # the wide chain's
        per_image = lh * hw * h * (torch.finfo(wdt).bits // 8
                                   + (4 if recompute else 0)) + tiles * block
    budget = workspace_budget(dev) if workspace_bytes is None \
        else workspace_bytes
    bc = max(1, min(b, budget // per_image))
    mw = (lh + no) * h + no
    chunks = [(b0, min(bc, b - b0)) for b0 in range(0, b, bc)]
    if sm90:
        splits = [dw90_splits(n * tiles) for _, n in chunks]
    else:
        kchunk = lib.svt_fused_decoder_bwd_kchunk()
        splits = [-(-n * hw // kchunk) for _, n in chunks]
    f32 = dict(dtype=torch.float32, device=dev)
    part_fold = torch.empty((b * tiles, 3, h), **f32)
    part_w = torch.empty((b * tiles, mw), **f32)
    part_dw = torch.empty((sum(splits), lh, h, h), **f32)
    if sm90:
        ws = torch.empty((bc * tiles * block,), dtype=torch.uint8, device=dev)
        ws_a0, ws_dh = ws[:ws.numel() // 2], ws[ws.numel() // 2:]
        da = [torch.empty((bc, hw, h), **f32) for _ in range(nda)]
    else:
        dh_ws = torch.empty((lh, bc, hw, h), dtype=wdt, device=dev)
        ws = (torch.empty((bc * tiles * block,), dtype=torch.uint8,
                          device=dev) if block else None)
        whid_t = w.whid_t()
    if recompute:
        acts_ws = torch.empty((lh, bc, hw, h), **f32)
        y_ws = torch.empty((bc, no, hw), **f32)
    wht = w.head_args()[1]
    g = g.float().contiguous()
    esz = 2 if act_bf16 else 4
    flags = (int(bool(resid)), int(w.bf16), int(act_bf16))
    with torch.cuda.device(dev):
        st = _stream(fold)
        split0 = 0
        for (b0, n), ns in zip(chunks, splits):
            fold_c = fold[b0:b0 + n]
            if recompute:
                _launch_fwd(fold_c, coords, w, resid, 1, "fwd_recompute",
                            y_ws[:n], acts_ws, route=route)
                act_ptr, act_ls = acts_ws.data_ptr(), n * hw * h
                layer_act = [_image_ptr(acts_ws[l], 0) for l in range(lh)]
            else:
                act_ptr = acts.data_ptr() + b0 * hw * h * esz
                act_ls = b * hw * h
                layer_act = [_image_ptr(acts[l], b0) for l in range(lh)]
            if deep:
                for l in range(lh - 1, -1, -1):
                    top = l == lh - 1
                    _call(lib, "svt_decoder90_chain_layer",
                          fold_c.data_ptr(), coords.data_ptr(),
                          w.sm90_slabs_t(l).data_ptr(), wht.data_ptr(),
                          layer_act[l], layer_act[l - 1] if l else None,
                          None if top else da[(lh - l) % 2].data_ptr(),
                          da[(lh - l - 1) % 2].data_ptr() if l else None,
                          y[b0:b0 + n].data_ptr(), g[b0:b0 + n].data_ptr(),
                          part_fold[b0 * tiles:].data_ptr(),
                          part_w[b0 * tiles:].data_ptr(), ws_a0.data_ptr(),
                          ws_dh.data_ptr(), n, hw, h, lh, no, l + 1, *flags,
                          st)
                    LAUNCHES["bwd_chain_sm90"] += 1
                    _call(lib, "svt_decoder90_dw_deep", ws_a0.data_ptr(),
                          ws_dh.data_ptr(), part_dw[split0, l].data_ptr(),
                          n * tiles, h, ns, lh * h * h, flags[1], st)
                    LAUNCHES["bwd_dw_sm90"] += 1
            elif sm90:
                _call(lib, "svt_decoder90_chain", fold_c.data_ptr(),
                      coords.data_ptr(), w.sm90_slabs_t().data_ptr(),
                      wht.data_ptr(), act_ptr, y[b0:b0 + n].data_ptr(),
                      g[b0:b0 + n].data_ptr(),
                      part_fold[b0 * tiles:].data_ptr(),
                      part_w[b0 * tiles:].data_ptr(), ws_a0.data_ptr(),
                      ws_dh.data_ptr(), n, hw, h, lh, no, *flags, st)
                LAUNCHES["bwd_chain_sm90"] += 1
                _call(lib, "svt_decoder90_dw", ws_a0.data_ptr(),
                      ws_dh.data_ptr(), part_dw[split0:].data_ptr(),
                      n * tiles, h, ns, flags[1], st)
                LAUNCHES["bwd_dw_sm90"] += 1
            else:
                _call(lib, "svt_fused_decoder_bwd_chain", fold_c.data_ptr(),
                      coords.data_ptr(), whid_t.data_ptr(), wht.data_ptr(),
                      act_ptr, act_ls, y[b0:b0 + n].data_ptr(),
                      g[b0:b0 + n].data_ptr(), dh_ws.data_ptr(),
                      part_fold[b0 * tiles:].data_ptr(),
                      part_w[b0 * tiles:].data_ptr(),
                      ws.data_ptr() if block else None, n, hw, h, lh, no,
                      *flags, st)
                LAUNCHES["bwd_chain"] += 1
                _call(lib, "svt_fused_decoder_bwd_dw", fold_c.data_ptr(),
                      coords.data_ptr(), act_ptr, act_ls, dh_ws.data_ptr(),
                      part_dw[split0:].data_ptr(), n, hw, h, lh, *flags[1:],
                      st)
                LAUNCHES["bwd_dw"] += 1
            split0 += ns
        dfold = torch.zeros((b, 4, h), **f32)
        dwh = torch.empty((lh, h, h), **f32)
        sums = torch.empty((mw,), **f32)
        stage = torch.empty((-(-b * tiles // 64), mw), **f32)
        for src, dst, rows, total, m, stride in (
                (part_fold, dfold, tiles, b * tiles, 3 * h, 4 * h),
                (part_dw, dwh, sum(splits), sum(splits), lh * h * h, 0),
                (part_w, stage, 64, b * tiles, mw, mw),
                (stage, sums, stage.shape[0], stage.shape[0], mw, 0)):
            _call(lib, "svt_sum_rows", src.data_ptr(), dst.data_ptr(), rows,
                  total, m, stride, st)
            LAUNCHES["bwd_sum"] += 1
    return (dfold, dwh, sums[:lh * h].view(lh, h),
            sums[lh * h:(lh + no) * h].view(no, h), sums[(lh + no) * h:])


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


class _FusedTail(torch.autograd.Function):
    """Counterpart of the JAX ``fused_decoder_tail`` custom VJP.  fold and
    the stacked tail weights are differentiable inputs; coords is not (the
    JAX VJP returns None for it)."""

    @staticmethod
    def forward(ctx, fold, coords, whid, bhid, wht, bht, resid, recompute):
        w = TailWeights(whid, bhid, wht, bht)
        _check_inputs(fold, coords, w)
        b, _, h = fold.shape
        hw, lh = coords.shape[0], whid.shape[0]
        save = not recompute and save_residual(
            b, hw, h, lh, whid.dtype, residual_budget(fold.device))
        if save:
            y, acts = run_decoder_tail_acts(fold, coords, w, resid)
        else:
            y, acts = run_decoder_tail(fold, coords, w, resid), None
        ctx.save_for_backward(fold, coords, y, acts)
        ctx.weights, ctx.resid = w, resid
        ctx.dtypes = (fold.dtype, whid.dtype, bhid.dtype, wht.dtype,
                      bht.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        fold, coords, y, acts = ctx.saved_tensors
        w = ctx.weights
        grads = run_decoder_tail_backward(fold, coords, w, acts, y, gy,
                                          ctx.resid)
        dfold, dwh, dbh, dwht, dbht = (
            t.to(dt) for t, dt in zip(grads, ctx.dtypes))
        return dfold, None, dwh, dbh, dwht, dbht, None, None


def fused_decoder_tail(fold: torch.Tensor, coords: torch.Tensor,
                       whid: torch.Tensor, bhid: torch.Tensor,
                       wht: torch.Tensor, bht: torch.Tensor,
                       resid: bool = False, *, recompute: bool = False
                       ) -> torch.Tensor:
    """whid (Lh, H, H); bhid (Lh, H); wht (No, H); bht (No,), all f32 or all
    bf16; fold (B, 4, H) f32; coords (HW, 2) f32.  Returns (B, No, HW) f32.

    With grad enabled and an input that requires it, this is the
    differentiable op (``recompute=True`` forces the backward to recompute
    the activations whatever their size); otherwise the forward alone, with
    the weights packed for the kernel on every call
    (``fused_spatial_generator`` packs once per generator)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (fold, whid, bhid, wht, bht)):
        return _FusedTail.apply(fold, coords, whid, bhid, wht, bht, resid,
                                recompute)
    return run_decoder_tail(fold, coords, TailWeights(whid, bhid, wht, bht),
                            resid)


def fused_spatial_generator(gen: SpatialGenerator, coords: torch.Tensor,
                            theta: Optional[torch.Tensor],
                            dx: Optional[torch.Tensor],
                            z: Optional[torch.Tensor]) -> torch.Tensor:
    """Drop-in for ``spatial_generator_apply_folded`` through the kernels.
    The fold, the head transpose and the optional softplus stay in
    PyTorch.  Under no_grad the stacked weights are cached on gen; with
    grad they are stacked in the graph, so gradients reach each
    ``nn.Linear``.  Returns (B, HW, n_out)."""
    if not can_fuse_decoder(gen.cfg, coords.shape[0]):
        raise ValueError(f"config not supported by the fused decoder: "
                         f"{gen.cfg}")
    w0, w1, c = fold_pose_into_first_layer(gen, theta, dx, z)
    fold = torch.stack([w0, w1, c, torch.zeros_like(c)], dim=1)  # (B, 4, H)
    fold = fold.float().contiguous()
    coords = coords.float().contiguous()
    *hidden, head = gen.linears()
    if torch.is_grad_enabled() and (fold.requires_grad or any(
            p.requires_grad for lin in gen.linears()
            for p in (lin.weight, lin.bias))):
        yt = fused_decoder_tail(fold, coords, *_stack_tail(hidden, head),
                                gen.cfg.resid)
    else:
        yt = run_decoder_tail(fold, coords, generator_tail_weights(gen),
                              gen.cfg.resid)
    y = yt.transpose(1, 2)                                # (B, HW, No)
    if gen.cfg.softplus:
        y = torch.cat([F.softplus(y[..., :1]), y[..., 1:]], dim=-1)
    return y
