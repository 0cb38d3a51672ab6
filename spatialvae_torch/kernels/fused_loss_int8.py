"""The fused int8 loss-and-gradient kernel (K3): hand-written sm_90a CUDA
kernels under one ``torch.autograd.Function``.

Counterpart of ``spatialvae_tpu/kernels/fused_loss_int8.py`` (Pallas
``_kernel`` through ``_lossgrad_pallas`` and the custom VJP
``fused_decoder_bce_int8``) in its three likelihood families, Bernoulli,
Gaussian (``n_out`` 1) and colored (``n_out`` 2, the fit-noise mean and
log-variance), each with or without a pixel mask, over a tile-aligned
pixel count (Bernoulli and Gaussian also over a padded one: 784 -> 1024,
4225 -> 4352), at every hidden width and every numerics setting of
``kernels/config.py``, its four measurement levers (``TANH``, ``A1Q``,
``DB1``, ``PHASE_CUT``) included.  One call
computes, for the foldable 2-layer decoder, the summed loss and every
decoder gradient; at the default numerics (grad_mode i4dw1, gscale bound,
bf16 epilogue, round to nearest even), for the Bernoulli family (the other
two change the loss and dz2 lines alone):

    host, once per call:
      W1f, sf = quant_sym4(w1^T)^T  (per-column 4-bit), h1s = sf/7
      W1r, s4 = quant_sym4(w1)      (per-row 4-bit, for da0)
      gb = max_j sum_i |wht[i, j]| + 1e-30
    per group (one image x one pick_tile pixel tile, 1024 at galaxy):
      a0 = tanh(x0*w0 + x1*w1 + c);  aq = clip(round(7*a0), -7, 7)
      h1 = (aq @ W1f) * h1s + b1;    a1c = cast(tanh(h1))
      s  = sigmoid(a1c . wht^T + bht); y = (yt + 128)/255 for int8 targets
      bce = -sum m*(y*max(log s, -100) + (1-y)*max(log1p(-s), -100))
      dz2 = m*(s - y), 0 where s*(1-s) == 0;  dWh^T += cast(dz2) a1c
      mdz = max|dz2| + 1e-30;  sg = gb*mdz/7
      q  = (cast(dz2)^T . wht) * (1 - a1c*a1c in the weight dtype) * 7/(gb*mdz)
      db1 += sum q * sg;  qi = clip(round(q), -7, 7)
      dW1 += (aq^T . qi) * sg/7;  da0 = qi . W1r^T
      dh0 = bf16(da0) * (1 - a0d*a0d), a0d = bf16(aq)*bf16(1/7), in bf16
      dfold[b] += (bf16(x3)^T . dh0) * sg*s4,  x3 = [x0, x1, 1, 0]
    the group's bce is added at dfold[b, 3, 0]; the loss is their sum.
    gaussian:  d = m*(s - y);  loss = 0.5 * sum m*(s - y)^2
               dz2 = d * (s*(1 - s))
    colored, over chunk-permuted coords (``colored_coords``): the group's
    first Pt/2 rows are its pixels' mean rows, the last Pt/2 their
    log-variance rows; targets and mask pre-paired as (2, Pt/2) tiles
               mu = sigmoid(z2[:, :Pt/2]);  lv = sigmoid(z2[:, Pt/2:])
               d = mu - y;  w = d * exp(-lv);  loss = 0.5 * sum m*(d*w + lv)
               dz2 = [m * w * (mu*(1 - mu)) |
                      m * 0.5*(1 - d*w) * (lv*(1 - lv))]
    padded pixel counts (``padded_hw``): coords and targets zero-padded and
    a mask forced whose pad entries are 0, so dz2 and the loss term vanish
    on the pad and the result is the unpadded one.

The other numerics (the JAX ``_Phases`` p5-p7 and ``_lossgrad_pallas``
:930-1034; ``Numerics``):

    grad_mode i8, da0_i4: the int8 forward, aq = round(127*a0) on W1 with one
      int8 scale sw (``quant_sym``), h1s = sw/127, dW1's step sg/127, tanh'
      from aq/127; i8 also takes the gradient tile at 127 levels with da0 on
      the int8 W1 (s4 = sw); both take the tile scale.  i4fwd is i4dw1.
    gscale tile: maxv = max|dh1| over the group + 1e-30, dh1 = bf16(da1) *
      tanh'(a1c) in the weight dtype; qs = bf16(lv/maxv), sg = 1/qs, q =
      dh1*qs (rounded to bf16 with bf16 weights); db1 = sum dh1.
    epi f32: a1 kept in f32 for the tanh' chain (tile: dh1 = da1*(1 - a1^2),
      qs = lv/maxv, sg = maxv/lv), dh0 = bf16(da0 * (1 - a0d^2)) in f32.
    sr: both quantisation sites round stochastically, clip(floor(x + u)),
      with Philox4x32-10 words keyed by b1[0]'s bits (``kernels/philox.py``).
      The JAX package cannot run SR off the TPU (its interpret mode rounds
      to nearest); the port draws the same words on the CPU and the card.

The measurement levers (the JAX ``_Phases`` and ``_tanh_pade``):

    tanh pade: a0 and a1 through ``tanh_pade`` (exact division).
    a1q (bound scale, bf16 epilogue only, as JAX gates it): a1c =
      clip(round(127*a1)); wht per tensor in int8 (whtq, swht); z2 =
      (a1c . whtq^T) * swht/127 + bht; dz2c = clip(round(dz2 * 127/mdz))
      per group, sdz = mdz/127; dWh^T += (dz2c . a1c) * sdz/127 per group;
      da1 = dz2c^T . whtq; gb over the dequantised int8 head;
      q = (da1 * (1 - (a1c/127)^2)) * (7/(gb*mdz)) * sdz*swht.
    db1 qi (bound scale only): db1 += sum qi * sg.
    phase_cut k (3..8): phases 1..k run; the cut phases' outputs are
      zero (dWh^T below 4, db1 and dbh below 5, dW1 below 6, dfold but
      the loss below 8), and on the card their work is not launched.

``loss_int8_reference`` is the plain PyTorch version, with the integer
products exact.  ``run_loss_int8`` takes it for CPU tensors and launches
the kernels (``csrc/fused_loss_int8.cu``) for CUDA tensors, or raises; it
never rounds to nearest where SR was asked for.  ``launch_loss`` also runs
the feature-major kernel K8's modes (``fused_loss_int8_t``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from spatialvae_torch.config import SpatialGeneratorConfig
from spatialvae_torch.kernels.config import Numerics, numerics
from spatialvae_torch.kernels.fused_decoder import (
    _call,
    _first_layer,
    _swizzle64,
    _lib,
    _stream,
    workspace_budget,
)
from spatialvae_torch.kernels.fused_decoder_int8 import (
    BLOCK_PIXELS,
    MAX_OUT,
    WEIGHT_DTYPES,
    dw_splits,
    grouped_int_product,
    image_chunks,
    pad_square,
    padded_hidden,
    ptr,
    quant_sym,
    run_grouped_dw,
)
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    fold_pose_into_first_layer,
)
from spatialvae_torch.kernels.philox import (
    SITE_FWD,
    SITE_GRAD,
    f32_bits,
    site_words,
    sr_round,
)
from spatialvae_torch.precision import fp32_precision

DEFAULTS = Numerics()
# the feature-major kernel's (K8) constant pad-row activation, quantised:
# round(7 * tanh(atanh(1/7))) = 1, round(127 * tanh(atanh(1/7))) = 18
PAD_K = {"i4": 1.0, "i8": 18.0}
FAMILIES = ("bernoulli", "gaussian", "colored")

# Kernel launches on CUDA tensors: the forward pass (loss, dz2 and each
# block's max |dz2|), the gradient pass (quantisation, da0, the per-block
# partials, the int8 workspaces), the split-K dW1 kernel (shared with K5,
# counted here for K3's calls) and the fixed-order reductions; the cluster
# passes (``k3_route`` "sm90") count under their own keys.
LAUNCHES = {"fwd": 0, "grad": 0, "dw": 0, "sum": 0, "fwd_sm90": 0,
            "grad_sm90": 0, "dw_sm90": 0}

# The cluster passes (csrc/fused_loss_int8_sm90.cu, past H = 512
# csrc/fused_loss_int8_sm90_wide.cu): CLUSTER CTAs, each a 64-pixel block,
# four consecutive blocks of one quantisation group; the products run in
# output-column chunks of CLUSTER_WIDTH, every operand padded to whole
# chunks (``cluster_rows``); W1 streamed chunk by chunk in slabs of SLAB_K
# K-bytes by CLUSTER_WIDTH rows.
CLUSTER = 4
CLUSTER_WIDTH = 512
SLAB_K = 64


def cluster_chunks(h: int) -> int:
    """The cluster passes' output-column chunks at width ``h``."""
    return -(-padded_hidden(h) // CLUSTER_WIDTH)


def cluster_rows(h: int) -> int:
    """Rows of the cluster passes' operands and dW1 workspace blocks:
    whole chunks (CLUSTER_WIDTH up to H = 512)."""
    return cluster_chunks(h) * CLUSTER_WIDTH


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def k3_mode(nm: Numerics, t_mode: Optional[str] = None) -> tuple:
    """(the kernels' Mode bits, DB1_QI's pad-row constant) of a K3 call at
    ``nm``, or of K8's ``t_mode`` ("i4"/"i8")."""
    mode = ((_TILE if nm.k3_gscale == "tile" else 0)
            | (_EPI_F32 if nm.epi == "f32" else 0) | (_SR if nm.sr else 0)
            | (_PADE if nm.tanh == "pade" else 0)
            | (_A1Q if nm.k3_a1q else 0) | (_CUT if nm.k3_cut < 8 else 0))
    dbk = 0.0
    if t_mode is not None:
        mode |= _TILE | _DB1_QI | (_AQ4_WS if t_mode == "i4" else 0)
        dbk = PAD_K[t_mode]
    elif nm.k3_db1_qi:                 # sum qi * sg: the pad-row constant 1
        mode |= _DB1_QI
        dbk = 1.0
    return mode, dbk


def k3_route(hw: int, h: int, pt: int, family: str, nm: Numerics,
             t_mode: Optional[str] = None, block_passes: bool = False) -> str:
    """The passes a K3 call runs on the card: "sm90", the cluster passes,
    for the default numerics (no mode bit, both levels 7) at every width
    (past H = 512 in output-column chunks of CLUSTER_WIDTH), or for
    stochastic rounding with nothing else off the defaults (the SR mode bit
    alone: ``--int8-sr``, ``SPATIALVAE_SR=1``) at H <= 512, over pixel
    counts and groups that are multiples of 256, in every family (the
    colored one pairs its mean and log-variance blocks across a cluster);
    else "block", the block passes (SR past H = 512, the knob modes, K8),
    which also take every call whose caller asks for them
    (``block_passes``).  The route is chosen here alone: ``launch_loss``
    passes it to both C entry points, which refuse the cluster route for a
    call the passes do not take."""
    mode, _ = k3_mode(nm, t_mode)
    quad = CLUSTER * BLOCK_PIXELS
    if (not block_passes
            and (mode == 0 or (mode == _SR and h <= CLUSTER_WIDTH))
            and nm.fwd_level == 7 and nm.grad_level == 7
            and hw % quad == 0 and pt % quad == 0):
        return "sm90"
    return "block"


def sm90_slabs(w: torch.Tensor) -> torch.Tensor:
    """An (H, H) int8 matrix given as rows [n][k] -> the cluster passes' slab
    stream: zero-padded to (``cluster_rows(H)``, Kp) and laid out chunk by
    chunk of CLUSTER_WIDTH rows (the products' output-column chunks, in
    order); a chunk is cut into Kp/SLAB_K slabs of K-bytes SLAB_K*s ..
    +SLAB_K-1, each slab (CLUSTER_WIDTH, SLAB_K) in wgmma's 64-byte
    swizzled K-major layout: (n, k) at n * 64 + ((k // 16) ^ ((n >> 1) & 3))
    * 16 + k % 16 of its slab.  One contiguous (Kp * cluster_rows(H),) int8
    tensor: every quarter of a slab is one bulk copy."""
    kp, rows = padded_hidden(w.shape[1]), cluster_rows(w.shape[0])
    p = F.pad(w, (0, kp - w.shape[1], 0, rows - w.shape[0]))
    t = p.reshape(rows // CLUSTER_WIDTH, CLUSTER_WIDTH, kp // SLAB_K, 4, 16)
    return _swizzle64(t.transpose(1, 2).contiguous()).reshape(-1)


def sm90_ws_layout(tiles: torch.Tensor) -> torch.Tensor:
    """(N, HW, R) int8 tiles (pixel rows; R = ``cluster_rows(H)``) -> the
    cluster passes' dW1 operand workspace: per (image, 64-pixel block) an
    (R, 64) block in wgmma's 64-byte swizzled layout, row n, pixel p =
    16 w + g + 8 h at position 16 w + 2 g + h of the row (the accumulator
    rows' order: dW1 sums over a group's pixels, so any order serves),
    i.e. at byte n * 64 + (w ^ ((n >> 1) & 3)) * 16 + 2 g + h."""
    n, hw, kw = tiles.shape
    t = tiles.reshape(n, hw // BLOCK_PIXELS, 4, 2, 8, kw)
    t = t.permute(0, 1, 5, 2, 4, 3).reshape(n, hw // BLOCK_PIXELS, kw, 4, 16)
    return _swizzle64(t.contiguous()).reshape(-1)


def sm90_ws_tiles(ws: torch.Tensor, n: int, hw: int) -> torch.Tensor:
    """``sm90_ws_layout``' inverse: (N, HW, R) int8, R the workspace's rows
    per block."""
    blocks = hw // BLOCK_PIXELS
    rows = ws.numel() // (n * hw)
    t = _swizzle64(ws.reshape(n, blocks, rows, 4, 16))
    t = t.reshape(n, blocks, rows, 4, 8, 2)
    return t.permute(0, 1, 3, 5, 4, 2).reshape(n, hw, rows)


def grouped_dw90_reference(aq_ws: torch.Tensor, q_ws: torch.Tensor,
                           gscale: torch.Tensor, nimg: int, hw: int, h: int,
                           pt: int, splits: int) -> torch.Tensor:
    """The plain version of the cluster passes' dW1 kernel
    (``svt_loss90_dw``): (splits, H, H) f32 partials from the workspaces of
    ``nimg`` images, groups of ``pt`` pixels spread over the splits as
    ``svt_int8_grouped_dw`` spreads them; each group's exact product
    (float64, rounded to f32 as the kernel's int32 is) times its scale,
    added in group order within its split, every op rounded to f32 as the
    kernel rounds it, so the kernel's partials are these bit for bit."""
    a = sm90_ws_tiles(aq_ws, nimg, hw)[..., :h].double()
    q = sm90_ws_tiles(q_ws, nimg, hw)[..., :h].double()
    groups = nimg * (hw // pt)
    per = -(-groups // splits)
    a, q = a.reshape(groups, pt, h), q.reshape(groups, pt, h)
    out = torch.zeros((splits, h, h), dtype=torch.float32, device=a.device)
    for gi in range(groups):
        s = gi // per
        out[s] = out[s] + (a[gi].T @ q[gi]).float() * gscale[gi]
    return out


def cluster_schedule(blocks_total: int, clusters: int,
                     colored_pt: int = 0) -> list:
    """The cluster passes' walk: for each CTA (cluster c, rank r, in launch
    order) the flattened (image, 64-pixel block) indices it runs, in turn:
    block CLUSTER * q + r of quads q = c, c + C, ... with C = min(quads,
    ``clusters``) clusters (the kernels' ``block_of``).  With
    ``colored_pt`` (the group's pixels) the colored forward's walk (the
    kernel's ``colored_block``): the quads of each group in turn, quad j of
    a group taking its mean blocks 2j, 2j + 1 on ranks 0 and 1 and their
    log-variance partners, colored_pt/128 blocks further, on ranks 2 and 3
    (rank r's partner is r ^ 2)."""
    quads = blocks_total // CLUSTER
    ncl = min(quads, clusters)

    def at(q, r):
        if not colored_pt:
            return q * CLUSTER + r
        qpg = colored_pt // (CLUSTER * BLOCK_PIXELS)
        return (q // qpg * (colored_pt // BLOCK_PIXELS) + 2 * (q % qpg)
                + (r & 1) + (r >> 1) * (colored_pt // (2 * BLOCK_PIXELS)))
    return [[at(q, r) for q in range(c, quads, ncl)]
            for c in range(ncl) for r in range(CLUSTER)]


def loss_workspace_bytes(hw: int, h: int, route: str, block: int = 0) -> int:
    """Bytes of K3's workspaces per image: the dW1 operands aq and qi,
    (Kp, HW) int8 each on the block route, (``cluster_rows(H)``, HW) on the
    cluster route, and ``block`` bytes per 64-pixel block (the block
    route's wide tiles, the cluster route's ``stash_block_bytes``).  The
    cluster route's stash of aq, which the forward leaves for the gradient
    pass under SR and past H = 512, is the aq operand's workspace itself: it
    adds nothing."""
    rows = cluster_rows(h) if route == "sm90" else padded_hidden(h)
    return 2 * rows * hw + hw // BLOCK_PIXELS * block


def stash_block_bytes(bf16: bool, h: int = CLUSTER_WIDTH) -> int:
    """Bytes per 64-pixel block of the cluster route's ``ws``
    (``svt_loss90_ws_block``): the a1c stash of 64 pixels x
    ``cluster_rows(h)`` columns, bf16 or f32 as the weights, and past
    H = 512 the gradient pass's K-major copy of qi, 64 x
    ``cluster_rows(h)`` int8."""
    rows = cluster_rows(h)
    qk = BLOCK_PIXELS * rows if h > CLUSTER_WIDTH else 0
    return BLOCK_PIXELS * rows * (2 if bf16 else 4) + qk


def sr90_counters(nimg: int, hw: int, h: int, clusters: int, b0: int = 0,
                  colored_pt: int = 0, ws_row: bool = False,
                  p_base: int = 0) -> dict:
    """The cluster passes' Philox counters under SR, element by element, as
    the kernels compute them (``csrc/fused_loss_int8_sm90.cuh``'s
    ``chain_part`` and ``sr_grad_words``) for a chunk of ``nimg`` images
    starting at image ``b0`` of the call, ``clusters`` resident: site ->
    (image, row, column, c0, c1, c2, word), int64 tensors with one entry per
    element of every (CTA, k-th tile, warp, lane) that rounds (column < H),
    where (image, row, column) is the element the kernel rounds and (c0, c1,
    c2, 0) the counter of the call whose ``word``-th word it takes.
    "fwd": the a0 chain over the forward's walk (``colored_pt``: the
    colored forward's, the colored pass's group), lane 4r + c of warp wi
    drawing columns 4c .. of its pixel's quad; "grad": the gradient pass's
    walk, lanes t and t ^ 1 each drawing the call of row g + 8 (t & 1) and
    trading words by shuffle.  ``ws_row`` mirrors the faulty copy
    SVT_SR90_WS_ROW, whose counters take the row from the dW1 workspace's
    order (16 w + 2 g + h).  ``p_base``: the chunk's pixels are rows p_base
    .. of a larger call (a pixel shard): the counters' rows start there,
    the elements' rows at 0."""
    blocks = hw // BLOCK_PIXELS

    def dims(n, *sizes):                  # aranges broadcast over n dims
        return [torch.arange(k).reshape([1] * d + [k] + [1] * (n - d - 1))
                for d, k in enumerate(sizes)]

    def crow(p):                          # the counter's row within a block
        return 16 * (p // 16) + 2 * (p % 8) + (p // 8) % 2 if ws_row else p

    def walk(col_pt, n):                  # each CTA's blocks, in turn
        tiles = [x for cta in cluster_schedule(nimg * blocks, clusters,
                                               col_pt) for x in cta]
        return torch.tensor(tiles, dtype=torch.int64).reshape(
            [-1] + [1] * (n - 1))

    def flat(fields, shape, keep):
        at = keep.expand(shape).reshape(-1).nonzero()[:, 0]
        return tuple(f.expand(shape).reshape(-1)[at] for f in fields)

    out = {}
    # the forward: (tile, slab, warp, lane, it, j)
    tb = walk(colored_pt, 6)
    _, s, wi, lane, it, j = dims(6, 1, padded_hidden(h) // SLAB_K, 16, 32,
                                 2, 4)
    k0 = s * SLAB_K + (wi % 4) * 16 + (lane % 4) * 4
    p = (wi // 4 + 4 * it) * 8 + lane // 4
    p0, img = (tb % blocks) * BLOCK_PIXELS, b0 + tb // blocks
    shape = torch.broadcast_shapes(tb.shape, k0.shape, p.shape, j.shape)
    out["fwd"] = flat((img, p0 + p, k0 + j, img, p_base + p0 + crow(p),
                       k0 // 4, j),
                      shape, k0 + j < h)
    # the gradient pass: (tile, warpgroup, warp, lane g, lane t, nt, h, e)
    tb = walk(0, 8)
    _, wg, w, g, t, nt, hh, e = dims(8, 1, 4, 4, 8, 4, 16, 2, 2)
    p0, img = (tb % blocks) * BLOCK_PIXELS, b0 + tb // blocks
    col = 128 * wg + 8 * nt + 2 * t + e
    # the lane whose call serves row g + 8 hh: the lane of the pair whose
    # t & 1 is hh, which sends the words its partner keeps, 2 (t & 1) + e
    src = (t // 2) * 2 + hh
    call_row = 16 * w + g + 8 * hh
    shape = torch.broadcast_shapes(tb.shape, col.shape, call_row.shape)
    out["grad"] = flat((img, p0 + 16 * w + g + 8 * hh, col, img,
                        p_base + p0 + crow(call_row),
                        32 * wg + 2 * nt + src // 2,
                        2 * (t % 2) + e), shape, col < h)
    return out


def dw_splits90(groups: int) -> int:
    """Split-K partials of the cluster route's dW1 kernel: 16 CTAs (four
    clusters) per split, 15 splits, two full waves of the 30 clusters of 4
    an H100 holds at once; at most one split per group."""
    return max(1, min(groups, 15))


def quant_sym4(w: torch.Tensor):
    """Per-row symmetric 4-bit quantisation held in int8: s = max_j |w[i]|/7
    + 1e-12 (f32, shape (H,)), q = clip(round(w/s), -7, 7)."""
    wf = w.float()
    s = wf.abs().amax(dim=1, keepdim=True) / 7.0 + 1e-12
    q = torch.clamp(torch.round(wf / s), -7, 7).to(torch.int8)
    return q, s.reshape(-1)


def pick_tile(hw: int) -> int:
    """Pixels per quantisation group (the JAX default ``_pick_tile``)."""
    for t in (1024, 512, 256):
        if hw % t == 0:
            return t
    return hw


def hw_tiles_ok(hw: int) -> bool:
    return hw >= 1024 and hw % pick_tile(hw) == 0


def padded_hw(hw: int) -> int:
    """Smallest tile-aligned pixel count >= hw and >= 1024."""
    return max(1024, -(-hw // 256) * 256)


def can_fuse_loss_int8(cfg: SpatialGeneratorConfig, hw: int,
                       likelihood: str) -> bool:
    """The JAX gate plus tanh, which the kernels hard-code and the JAX gate
    never checked (ROADMAP Queue 3): whether this config goes to the loss
    kernel.  Another activation takes the plain decoder and likelihood."""
    if likelihood == "gaussian":
        if cfg.n_out != 1:
            return False
    elif likelihood == "colored":
        if cfg.n_out != 2:
            return False
    elif likelihood != "bernoulli":
        return False
    if not (not cfg.expand_coords and not cfg.bilinear and not cfg.resid
            and not cfg.softplus and cfg.activation == "tanh"
            and cfg.num_layers == 2 and cfg.n_out <= 8):
        return False
    if likelihood == "colored":
        return hw % 256 == 0 and hw_tiles_ok(hw)
    return hw >= 768 and hw_tiles_ok(padded_hw(hw))


def check_ported(hw: int, likelihood: str) -> Numerics:
    """The numerics a config that the JAX loss kernel takes runs at, or
    raise for what the port has not ported.  Every likelihood family and
    pixel count of ``can_fuse_loss_int8`` is ported, at every numerics
    setting that ``kernels/config.numerics`` accepts."""
    return numerics()


def colored_coords(coords: torch.Tensor, pt: int) -> torch.Tensor:
    """Chunk-permute (HW, 2) coords for the colored family, so that every
    Pt-row group holds its pixels' mean rows (from the first half of the
    grid) and then their log-variance rows (from the second half): image
    pixels [s, s+Pt) need decoder rows [s/2, s/2+Pt/2) and [HW/2+s/2,
    HW/2+s/2+Pt/2).  The JAX ``_colored_coords``."""
    hw = coords.shape[0]
    t, half = hw // pt, pt // 2
    first = coords[:hw // 2].reshape(t, half, 2)
    second = coords[hw // 2:].reshape(t, half, 2)
    return torch.stack([first, second], dim=1).reshape(hw, 2)


def colored_targets(y: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, HW[, 1]) targets -> the pre-paired (B, 2, HW/2) layout: out[b, c,
    u] = y[b, 2u + c], the target of image pixel 2u+c at the place its head
    outputs take.  The JAX ``_colored_targets``."""
    return y.reshape(y.shape[0], hw // 2, 2).transpose(1, 2)


def colored_mask(mask: torch.Tensor) -> torch.Tensor:
    """The (HW,) pixel mask pre-paired like the targets: (2, HW/2) f32."""
    return mask.float().reshape(-1, 2).T.contiguous()


def loss_operands(w1: torch.Tensor, wht: torch.Tensor,
                  nm: Numerics = DEFAULTS) -> tuple:
    """The host-side operands of the JAX ``_lossgrad_pallas``: (W1f (H, H)
    int8 [in][out], the forward's weights; h1s (H,), its dequant row; gb 0-d,
    the analytic gradient bound; W1r (H, H) int8 [in][out], da0's weights;
    s4 (H,), da0's per-row scales).  The 4-bit forward (``i4dw1``,
    ``i4fwd``) takes W1 with per-column 4-bit scales, h1s = sf/7; the int8
    forward (``i8``, ``da0_i4``) W1 with one int8 scale sw, h1s = sw/127.
    da0 takes per-row 4-bit W1 (s4 its scales), or for ``i8`` the int8 W1
    with s4 = sw throughout."""
    h = w1.shape[0]
    if nm.fwd_level == 7:
        wf4t, sf4 = quant_sym4(w1.T)
        w1f, h1s = wf4t.T, sf4 * (1.0 / 7.0)
    else:
        w1f, sw = quant_sym(w1)
        h1s = (sw * (1.0 / 127.0)).expand(h)
    gb = wht.float().abs().sum(dim=0).max() + 1e-30
    if nm.grad_mode == "i8":
        w1r, s4 = w1f, sw.expand(h)
    else:
        w1r, s4 = quant_sym4(w1)
    return w1f, h1s, gb, w1r, s4


def targets_f32(y_t: torch.Tensor) -> torch.Tensor:
    """(B, No, HW) targets as f32: int8 /255-grid targets are stored as
    k-128 and decode to (k + 128) * (1/255)."""
    if y_t.dtype == torch.int8:
        return (y_t.float() + 128.0) * (1.0 / 255.0)
    return y_t.float()


_BF16 = torch.bfloat16


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(_BF16)


def _rb(t: torch.Tensor, wdt: torch.dtype) -> torch.Tensor:
    """t rounded to the weight dtype, as f32."""
    return t.to(wdt).float() if wdt == _BF16 else t


def tanh_prime(a1c: torch.Tensor, wdt: torch.dtype) -> torch.Tensor:
    """1 - a1c*a1c in the weight dtype, as f32: with bf16 weights each of
    the two ops rounds to bf16 (the JAX kernel's ``one - a1c * a1c``)."""
    if wdt == _BF16:
        a = _bf(a1c)
        return (1.0 - a * a).float()
    return 1.0 - a1c * a1c


def dh0_bf16(da0: torch.Tensor, aq: torch.Tensor,
             inv: float = 1.0 / 7.0) -> torch.Tensor:
    """The bf16 dh0 chain, as f32: bf16(da0) * (1 - a0d*a0d) with a0d =
    bf16(aq) * bf16(inv), every op rounding to bf16; ``inv`` is a0's
    dequant step (1/7, or 1/127 for the int8 forward)."""
    a0d = _bf(aq) * torch.tensor(inv, dtype=_BF16)
    return (_bf(da0) * (1.0 - a0d * a0d)).float()


def dh0_f32(da0: torch.Tensor, aq: torch.Tensor, inv: float) -> torch.Tensor:
    """The f32-epilogue dh0, as f32: bf16(da0 * (1 - a0d*a0d)) with a0d =
    aq * inv, the chain in f32."""
    a0d = aq * inv
    return _bf(da0 * (1.0 - a0d * a0d)).float()


def head_transpose(dz2c: torch.Tensor, wht: torch.Tensor) -> torch.Tensor:
    """da1 = dz2c^T . wht, (B, No, HW) x (No, H) -> (B, HW, H) f32, summed
    over the outputs in order with each product and sum rounded (the
    kernels' order), so that the gradient's pre-round q is the kernels'."""
    da1 = dz2c[:, 0, :, None] * wht[0]
    for o in range(1, wht.shape[0]):
        da1 = da1 + dz2c[:, o, :, None] * wht[o]
    return da1


def loss_epilogue(z2: torch.Tensor, y_t: torch.Tensor,
                  mask: Optional[torch.Tensor], family: str, pt: int
                  ) -> tuple:
    """The loss phase of one call: z2 (B, No, HW) head pre-activations, y_t
    and mask as ``loss_int8_reference`` takes them -> (loss (B, T) per group
    of ``pt`` pixels, dz2 (B, No, HW)), float32, op by op as the JAX kernel's
    ``p3_bce``."""
    b, no, hw = z2.shape
    t_ = hw // pt
    yt = targets_f32(y_t)
    if family == "colored":
        half = pt // 2
        z4 = z2.reshape(b, no, t_, pt)
        mu, lv = torch.sigmoid(z4[..., :half]), torch.sigmoid(z4[..., half:])
        d = mu - yt.reshape(b, no, t_, half)
        w = d * torch.exp(-lv)
        per = d * w + lv
        dmu = w * (mu * (1.0 - mu))
        dlv = 0.5 * (1.0 - d * w) * (lv * (1.0 - lv))
        if mask is not None:
            mc = colored_mask(mask).reshape(1, no, t_, half)
            per, dmu, dlv = per * mc, dmu * mc, dlv * mc
        loss = 0.5 * per.sum(dim=(1, 3))
        return loss, torch.cat([dmu, dlv], dim=3).reshape(b, no, hw)
    s = torch.sigmoid(z2)
    m = None if mask is None else mask.float().reshape(1, 1, hw)
    if family == "gaussian":
        d = s - yt
        sq = d * d
        if m is not None:
            sq, d = sq * m, d * m
        per, sign = sq, 0.5
        dz2 = d * (s * (1.0 - s))
    else:
        log_s = torch.clamp(torch.log(s), min=-100.0)
        log_1ms = torch.clamp(torch.log1p(-s), min=-100.0)
        per, sign = yt * log_s + (1.0 - yt) * log_1ms, -1.0
        dz2 = torch.where(s * (1.0 - s) == 0.0, torch.zeros_like(s), s - yt)
        if m is not None:
            per, dz2 = per * m, dz2 * m
    return sign * per.reshape(b, no, t_, pt).sum(dim=(1, 3)), dz2


def tanh_pade(x: torch.Tensor) -> torch.Tensor:
    """The JAX ``_tanh_pade`` (``SPATIALVAE_TANH=pade``): the Pade(5,4)
    rational x(945 + 105t + t^2) / (945 + 420t + 15t^2), t = x^2, clipped to
    [-1, 1], each op rounded in f32 in this order.  The TPU multiplies by an
    approximate reciprocal of the denominator; the port divides exactly
    (IEEE, as ``__fdiv_rn`` on the card), so that the kernels and this
    version agree."""
    t = x * x
    num = x * (945.0 + t * (105.0 + t))
    den = 945.0 + t * (420.0 + 15.0 * t)
    return torch.clamp(num / den, -1.0, 1.0)


def _group_max(t: torch.Tensor, b: int, pt: int) -> torch.Tensor:
    """max |t| over each group of ``pt`` pixels: (B, HW, ...) -> (B, T)."""
    return t.abs().reshape(b, -1, pt, *t.shape[2:]).flatten(2).amax(dim=2)


def _per_group(v: torch.Tensor, pt: int) -> torch.Tensor:
    """(B, T) -> (B, HW, 1): each group's value on its pixels."""
    return v.repeat_interleave(pt, dim=1)[..., None]


@fp32_precision()
def loss_reference(fold, coords, w1, b1, wht, bht, y_t,
                   mask: Optional[torch.Tensor], family: str, nm: Numerics,
                   pt: int, t_mode: Optional[str] = None,
                   ints: bool = False, image0: int = 0,
                  p_base: int = 0) -> tuple:
    """The plain version of K3 (``t_mode`` None) and of K8 (``t_mode``
    ``"i4"`` or ``"i8"``, the feature-major kernel's numbers: see
    ``fused_loss_int8_t``), over groups of ``pt`` pixels.  Returns the five
    outputs of ``loss_int8_reference``, and with ``ints`` also the integer
    tiles (the dW1 operand (B, HW, H), qi (B, HW, H)) as f32.  ``image0``
    and ``p_base``: the index in the kernel's call of the first image and of
    the first pixel (SR's counters)."""
    wdt = wht.dtype
    b, _, h = fold.shape
    hw = coords.shape[0]
    t_ = hw // pt
    dev = fold.device
    lf, lv = nm.fwd_level, nm.grad_level
    w1f, h1s, gb, w1r, s4 = loss_operands(w1, wht, nm)
    seed = f32_bits(b1[0]) if nm.sr else None
    # K3's measurement levers (K8 reads none of them: t_numerics)
    tanh = tanh_pade if nm.tanh == "pade" else torch.tanh
    a1q = nm.k3_a1q
    a0 = tanh(_first_layer(fold, coords))                    # (B, HW, H)
    if seed is not None:
        aq = sr_round(a0 * float(lf),
                      site_words(seed, SITE_FWD, b, hw, h, dev, image0,
                                 p_base),
                      -lf, lf)
    else:
        aq = torch.clamp(torch.round(a0 * float(lf)), -lf, lf)
    h1 = (aq @ w1f.float()) * h1s + b1.float()               # exact ints
    a1 = tanh(h1)
    if a1q:
        # int8 a1 at the static tanh scale and the head per tensor in int8:
        # the head's forward, dWh^T and da1 on exact integer sums
        whtq, swht = quant_sym(wht)
        a1c = torch.clamp(torch.round(a1 * 127.0), -127, 127)
        acc2 = (a1c.double() @ whtq.double().T).float()      # (B, HW, No)
        z2 = (acc2 * (swht * (1.0 / 127.0)) + bht.float()).transpose(1, 2)
    else:
        a1c = a1.to(wdt).float()
        z2 = (a1c @ wht.float().T + bht.float()).transpose(1, 2)
    bce, dz2 = loss_epilogue(z2, y_t, mask, family, pt)      # (B, T)
    mdz = _group_max(dz2.transpose(1, 2), b, pt) + 1e-30     # (B, T)
    if a1q:
        # dz2 per group on 127 levels; dWh^T group by group from the exact
        # int32 product, scaled by the group's sdz/127
        sdz = mdz * (1.0 / 127.0)
        dz2c = torch.clamp(torch.round(
            dz2 * _per_group(127.0 / mdz, pt).transpose(1, 2)), -127, 127)
        prod = torch.einsum(
            "btop,btph->btoh", dz2c.double().reshape(b, -1, t_, pt)
            .transpose(1, 2), a1c.double().reshape(b, t_, pt, h)).float()
        dwht = (prod * (sdz * (1.0 / 127.0))[..., None, None]).sum(
            dim=(0, 1))
        da1 = head_transpose(dz2c, whtq.float())            # exact ints
        gb = whtq.float().abs().sum(dim=0).max() * swht + 1e-30
    else:
        dz2c = dz2.to(wdt).float()
        dwht = torch.einsum("bop,bph->oh", dz2c, a1c)
        da1 = head_transpose(dz2c, wht.float())              # (B, HW, H)
    dbht = dz2.sum(dim=(0, 2))
    f32epi = nm.epi == "f32"
    if nm.k3_gscale == "bound":
        gm = gb * mdz                                        # (B, T)
        sg = gm * (1.0 / 7.0)
        if a1q:
            cfac = (7.0 / gm) * (sdz * swht)
            a1d = a1c * (1.0 / 127.0)
            q = (da1 * (1.0 - a1d * a1d)) * _per_group(cfac, pt)
        else:
            tf = 1.0 - a1 * a1 if f32epi else tanh_prime(a1c, wdt)
            q = (da1 * tf) * _per_group(7.0 / gm, pt)
        db1g = q.reshape(b, t_, pt, h).sum(dim=2) * sg[..., None]
    else:
        if f32epi:
            dh1 = da1 * (1.0 - a1 * a1)
            maxv = _group_max(dh1, b, pt) + 1e-30
            sg = maxv * (1.0 / lv)
            q = dh1 * _per_group(lv / maxv, pt)
        else:
            dh1 = _rb(_bf(da1).float() * tanh_prime(a1c, wdt), wdt)
            maxv = _group_max(dh1, b, pt) + 1e-30
            qs_b = _bf(lv / maxv).float()
            sg = 1.0 / qs_b
            q = _rb(dh1 * _per_group(qs_b, pt), wdt)
        db1g = dh1.reshape(b, t_, pt, h).sum(dim=2)
    if seed is not None:
        qi = sr_round(q, site_words(seed, SITE_GRAD, b, hw, h, dev, image0,
                                    p_base), -lv, lv)
    else:
        qi = torch.clamp(torch.round(q), -lv, lv)
    if nm.k3_db1_qi:
        db1g = qi.reshape(b, t_, pt, h).sum(dim=2) * sg[..., None]
    if t_mode is None:
        db1 = db1g.sum(dim=(0, 1))
        a_dw, ldw = aq, lf
    else:
        # K8: db1 = sum qi * sg through the constant pad row K of the dW1
        # product, undone by lv/K (the JAX _lossgrad_pallas_t :375-378)
        k = PAD_K[t_mode]
        rows = (k * qi.reshape(b, t_, pt, h).sum(dim=2)) * (sg * (1.0 / lv))[
            ..., None]
        db1 = rows.sum(dim=(0, 1)) * (lv / k)
        ldw = 7 if t_mode == "i4" else 127
        a_dw = aq if ldw == lf else torch.clamp(torch.round(a0 * 7.0), -7, 7)
    dw1 = grouped_int_product(a_dw, qi, sg * (1.0 / ldw), pt)
    da0 = qi @ w1r.float().T                                  # exact ints
    dh0 = (dh0_f32(da0, aq, 1.0 / lf) if f32epi
           else dh0_bf16(da0, aq, 1.0 / lf))
    xb = _bf(coords).float()
    x0 = xb[:, 0].reshape(1, t_, pt, 1)
    x1 = xb[:, 1].reshape(1, t_, pt, 1)
    dh0 = dh0.reshape(b, t_, pt, h)
    rows = torch.stack([(x0 * dh0).sum(2), (x1 * dh0).sum(2), dh0.sum(2)],
                       dim=2)                                 # (B, T, 3, H)
    rows = (rows * (sg[..., None, None] * s4)).sum(dim=1)
    dfold = torch.cat([rows, torch.zeros((b, 1, h), dtype=torch.float32,
                                         device=rows.device)], dim=1)
    cut = nm.k3_cut
    if cut < 8:                        # the phases past the cut write zeros
        dfold.zero_()
        if cut < 6:
            dw1 = torch.zeros_like(dw1)
        if cut < 5:
            db1, dbht = torch.zeros_like(db1), torch.zeros_like(dbht)
        if cut < 4:
            dwht = torch.zeros_like(dwht)
    dfold[:, 3, 0] = bce.sum(dim=1)
    out = (dfold, dw1, db1, dwht, dbht)
    return (out, (a_dw, qi)) if ints else out


def loss_int8_reference(fold, coords, w1, b1, wht, bht, y_t,
                        mask: Optional[torch.Tensor] = None,
                        family: str = "bernoulli",
                        numerics: Optional[Numerics] = None,
                        ints: bool = False, image0: int = 0,
                        p_base: int = 0) -> tuple:
    """Plain version of K3.  fold (B, 4, H) f32 rows [w0, w1, c, 0]; coords
    (HW, 2) f32, HW tile-aligned (colored: chunk-permuted); w1 (H, H)
    [in][out]; b1 (H,); wht (No, H); bht (No,), in one weight dtype; y_t (B,
    No, HW) int8 (k-128) or float, colored (B, 2, HW/2); mask (HW,) or None;
    ``numerics`` (default: the defaults).  Returns float32 (dfold (B, 4, H)
    with the per-image loss at [:, 3, 0], dW1 (H, H), db1 (H,), dWh^T (No,
    H), dbh (No,)); with ``ints`` also (aq, qi) (B, HW, H), the two
    quantised tiles.  ``image0`` and ``p_base``: these images' first index
    and these pixels' first row in a larger call (a pixel shard's slice of
    coords, y_t and mask), whose SR counters they take (the rest of the call
    does not change them)."""
    nm = DEFAULTS if numerics is None else numerics.check()
    return loss_reference(fold, coords, w1, b1, wht, bht, y_t, mask, family,
                          nm, pick_tile(coords.shape[0]), ints=ints,
                          image0=image0, p_base=p_base)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check(fold, coords, w1, b1, wht, bht, y_t, mask, family) -> None:
    """Raise on inputs the kernels do not take, on every device."""
    if family not in FAMILIES:
        raise ValueError(f"family {family!r}; expected one of {FAMILIES}")
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
    if fold.dim() != 3 or fold.shape[1:] != (4, h) or fold.shape[0] < 1:
        raise ValueError(f"fold must be (B, 4, H={h}), got "
                         f"{tuple(fold.shape)}")
    b, hw = fold.shape[0], coords.shape[0]
    if b % 2:
        raise ValueError(f"batch {b}: the loss kernel takes even batches "
                         f"(as the JAX kernel's image pairs do)")
    if coords.dim() != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (HW, 2), got "
                         f"{tuple(coords.shape)}")
    if not hw_tiles_ok(hw):
        raise ValueError(f"HW={hw} is not tile-aligned for the loss kernel")
    want = (b, no, hw)
    if family == "colored":
        if no != 2 or hw % 256:
            raise ValueError(f"the colored family takes n_out 2 and HW a "
                             f"multiple of 256, got n_out={no}, HW={hw}")
        want = (b, 2, hw // 2)
    if tuple(y_t.shape) != want:
        raise ValueError(f"y_t must be {want} for the {family} family, got "
                         f"{tuple(y_t.shape)}")
    if mask is not None and tuple(mask.shape) != (hw,):
        raise ValueError(f"mask must be (HW,) = ({hw},)")
    for name, t in (("fold", fold), ("coords", coords)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
    devices = {t.device for t in (fold, coords, w1, b1, wht, bht, y_t)
               + ((mask,) if mask is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if fold.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {fold.device}")


def _resolve(nm: Optional[Numerics]) -> Numerics:
    """The numerics a wrapper runs: the environment's, checked
    (``kernels/config.numerics``), or the caller's, checked for the levers
    not ported."""
    return numerics() if nm is None else nm.check()


def run_loss_int8(fold, coords, w1, b1, wht, bht, y_t,
                  mask: Optional[torch.Tensor] = None,
                  family: str = "bernoulli",
                  workspace_bytes: Optional[int] = None,
                  numerics: Optional[Numerics] = None,
                  ints: bool = False, block_passes: bool = False,
                  p_base: int = 0) -> tuple:
    """K3's five outputs (see ``loss_int8_reference``) at ``numerics``
    (default: the environment's).  CPU tensors take the plain version; CUDA
    tensors launch the kernels, counting each in ``LAUNCHES``, and raise if
    the build or a launch fails.  ``ints`` also returns the two quantised
    tiles, as the plain version does (on the card from the workspaces, so
    the images must fit one chunk).

    On the card: a forward pass over 64-pixel blocks writes dz2
    (B, No, HW), each block's loss and the largest value of its scale's
    source, max |dz2| for the bound and max |dh1| for the tile scale
    (colored: one block runs a 64-row mean tile and its log-variance partner
    half a group further, so the pair's loss and both dz2 entries form in
    registers; with the tile scale it runs the mean tile's forward once more
    for its |dh1|); a gradient pass takes each group's scale from its
    blocks' maxima, rebuilds the forward (one more int8 GEMM, cheaper than
    storing a1), runs da0 on the int8 tensor cores and writes the per-block
    partials of dfold, db1, dWh^T and dbh and the int8 aq and qi to
    feature-major workspaces; a split-K kernel computes dW1 group by group;
    fixed-order reductions add the partials, so two runs agree bit for bit.
    Images go through the workspaces in chunks that fit ``workspace_bytes``
    (default ``workspace_budget``).

    Calls that ``k3_route`` sends to "sm90" run the cluster passes instead
    (csrc/fused_loss_int8_sm90.cu: the same outputs, W1 streamed once per
    four blocks, int8 wgmma; colored: a mean block and its log-variance
    partner on two CTAs of one cluster, each reading the other's head
    outputs from its shared memory; under SR csrc/fused_loss_int8_sm90_sr.cu,
    the same Philox words, the forward leaving aq in the dW1 workspace for
    the gradient pass; past H = 512 csrc/fused_loss_int8_sm90_wide.cu, in
    512-column chunks, the forward leaving aq in the dW1 workspace too);
    ``block_passes`` sends them to the passes above, for a caller that
    compares the two designs on one card.

    ``p_base``: the first pixel's row in a larger call whose pixel slice
    this is (a pixel shard, ``parallel/pixel.py``): under SR the slice
    draws the words the whole call draws for its pixels; nothing else
    reads it."""
    _check(fold, coords, w1, b1, wht, bht, y_t, mask, family)
    if p_base < 0:
        raise ValueError(f"p_base {p_base} < 0")
    nm = _resolve(numerics)
    if fold.device.type == "cpu":
        return loss_int8_reference(fold, coords, w1, b1, wht, bht, y_t,
                                   mask, family, numerics=nm, ints=ints,
                                   p_base=p_base)
    return launch_loss(fold, coords, w1, b1, wht, bht, y_t, mask, family, nm,
                       pick_tile(coords.shape[0]), None, workspace_bytes,
                       ints, LAUNCHES, block_passes, p_base)


# the kernels' Mode bits (csrc/fused_loss_int8.cuh)
_TILE, _EPI_F32, _SR, _AQ4_WS, _DB1_QI = 1, 2, 4, 8, 16
_PADE, _A1Q, _CUT = 32, 64, 128


def launch_loss(fold, coords, w1, b1, wht, bht, y_t, mask, family,
                nm: Numerics, pt: int, t_mode: Optional[str],
                workspace_bytes: Optional[int], ints: bool,
                launches: dict, block_passes: bool = False,
                p_base: int = 0) -> tuple:
    """The K3 kernels on CUDA tensors at ``nm`` over groups of ``pt``
    pixels, or K8's modes of them (``t_mode`` "i4" or "i8": the tile scale,
    db1 from the rounded tile, and for "i4" the 4-bit a0 as dW1's operand),
    on the passes ``k3_route`` names, each launch counted in ``launches``
    (the cluster passes' under their "_sm90" keys); SR's counters start at
    row ``p_base``.  Returns what ``loss_reference`` returns."""
    lib = _lib()
    dev = fold.device
    b, _, h = fold.shape
    hw, no = coords.shape[0], wht.shape[0]
    gpi = hw // pt
    blocks = hw // BLOCK_PIXELS
    lf, lv = nm.fwd_level, nm.grad_level
    mode, dbk = k3_mode(nm, t_mode)
    cut = nm.k3_cut
    route = k3_route(hw, h, pt, family, nm, t_mode, block_passes)
    fam = FAMILIES.index(family)
    sm90 = int(route == "sm90")
    sfx = "_sm90" if sm90 else ""
    w1f, h1s, gb, w1r, s4 = loss_operands(w1.detach(), wht.detach(), nm)
    if route == "sm90":
        w1ft, w1r = sm90_slabs(w1f.T), sm90_slabs(w1r)
    else:
        w1ft, w1r = pad_square(w1f.T), pad_square(w1r)
    b1f, whtf, bhtf = (t.detach().float().contiguous() for t in (b1, wht, bht))
    swht = 1.0
    if nm.k3_a1q:
        # the int8 head: whtq rides wht's place, the bound is over it
        whtq, s_wht = quant_sym(wht.detach())
        whtf = whtq.float().contiguous()
        swht = float(s_wht)
        gb = whtf.abs().sum(dim=0).max() * s_wht + 1e-30
    h1s, s4, gb = h1s.contiguous(), s4.contiguous(), gb.reshape(1)
    yt_i8 = y_t.dtype == torch.int8
    yt = y_t.contiguous() if yt_i8 else y_t.float().contiguous()
    if mask is None:
        mk = None
    else:
        mk = (colored_mask(mask) if family == "colored"
              else mask.float().contiguous())
    f32 = dict(dtype=torch.float32, device=dev)
    mw = h + no * h + no                          # [db1 | dWh^T | dbh]
    dz2 = torch.empty((b, no, hw), **f32)
    part_max = torch.empty((b * blocks,), **f32)
    part_bce = torch.empty((b * blocks,), **f32)
    gscale = torch.empty((b * gpi,), **f32)
    part_fold = torch.empty((b * blocks, 3, h), **f32)
    part_w = torch.empty((b * blocks, mw), **f32)
    budget = workspace_budget(dev) if workspace_bytes is None \
        else workspace_bytes
    bf16 = int(w1.dtype == torch.bfloat16)
    if route == "sm90":                  # the a1c stash (and qi's copy)
        block = lib.svt_loss90_ws_block(bf16, h)
    else:                                          # the wide tiles
        block = lib.svt_int8_ws_block(h)
    chunks = image_chunks(b, loss_workspace_bytes(hw, h, route, block),
                          budget)
    if ints and len(chunks) > 1:
        raise ValueError("ints needs the images in one workspace chunk")
    bc = chunks[0][1]
    rows = cluster_rows(h) if route == "sm90" else padded_hidden(h)
    aq_ws = torch.empty((bc, rows, hw), dtype=torch.int8, device=dev)
    q_ws = torch.empty((bc, rows, hw), dtype=torch.int8, device=dev)
    ws = (torch.empty((bc * blocks * block,), dtype=torch.uint8, device=dev)
          if block else None)
    ysz = yt.element_size() * yt[0].numel()
    splits_of = dw_splits90 if route == "sm90" else dw_splits
    part_dw = torch.empty((sum(splits_of(n * gpi) for _, n in chunks), h, h),
                          **f32)
    split0 = 0

    def forward(b0, n, st):
        _call(lib, "svt_loss_int8_fwd", fold.data_ptr() + b0 * 4 * h * 4,
              coords.data_ptr(), w1ft.data_ptr(), h1s.data_ptr(),
              b1f.data_ptr(), whtf.data_ptr(), bhtf.data_ptr(),
              yt.data_ptr() + b0 * ysz, ptr(mk),
              dz2.data_ptr() + b0 * no * hw * 4,
              part_max.data_ptr() + b0 * blocks * 4,
              part_bce.data_ptr() + b0 * blocks * 4, ptr(ws),
              aq_ws.data_ptr(), b0, p_base, n, hw, h, no, pt, int(yt_i8),
              fam, bf16,
              float(lf), swht, mode, sm90, st)
        launches["fwd" + sfx] += 1

    def gradient(b0, n, st):
        nonlocal split0
        _call(lib, "svt_loss_int8_grad", fold.data_ptr(),
              coords.data_ptr(), w1ft.data_ptr(), w1r.data_ptr(),
              h1s.data_ptr(), s4.data_ptr(), gb.data_ptr(),
              b1f.data_ptr(), whtf.data_ptr(), dz2.data_ptr(),
              part_max.data_ptr(), gscale.data_ptr(), aq_ws.data_ptr(),
              q_ws.data_ptr(), part_fold.data_ptr(), part_w.data_ptr(),
              ptr(ws), b0, p_base, n, hw, h, no, pt, bf16, float(lf),
              float(lv), mode, dbk, swht, cut, sm90, st)
        launches["grad" + sfx] += 1
        if cut < 6:
            return
        if route == "sm90":
            splits = dw_splits90(n * gpi)
            _call(lib, "svt_loss90_dw", aq_ws.data_ptr(), q_ws.data_ptr(),
                  gscale[b0 * gpi:].data_ptr(), part_dw[split0:].data_ptr(),
                  n, hw, h, pt, splits, st)
            split0 += splits
        else:
            split0 += run_grouped_dw(lib, aq_ws, q_ws, gscale[b0 * gpi:],
                                     part_dw[split0:], n, hw, h, pt, gpi, st)
        launches["dw" + sfx] += 1

    with torch.cuda.device(dev):
        st = _stream(fold)
        if route == "sm90":
            # chunk by chunk: the forward leaves the chunk's a1c in the
            # stash for its gradient pass
            for b0, n in chunks:
                forward(b0, n, st)
                gradient(b0, n, st)
        else:
            # the forward pass's launches (one at H <= 512, where there are
            # no wide tiles), then the gradient's; a phase cut below 4 runs
            # no gradient pass, below 6 no dW1
            for b0, n in (chunks if block else [(0, b)]):
                forward(b0, n, st)
            for b0, n in (chunks if cut >= 4 else []):
                gradient(b0, n, st)
        dfold = torch.zeros((b, 4, h), **f32)
        dw1 = torch.zeros((h, h), **f32)
        sums = torch.zeros((mw,), **f32)
        stage = torch.empty((-(-b * blocks // 64), mw), **f32)
        # the reductions of what the phases that ran wrote
        skip = {id(part_fold): cut < 8, id(part_dw): cut < 6,
                id(part_w): cut < 4, id(stage): cut < 4}
        for src, dst, rows, total, m, stride in (
                (part_fold, dfold, blocks, b * blocks, 3 * h, 4 * h),
                (part_bce, dfold[:, 3], blocks, b * blocks, 1, 4 * h),
                (part_dw, dw1, split0, split0, h * h, 0),
                (part_w, stage, 64, b * blocks, mw, mw),
                (stage, sums, stage.shape[0], stage.shape[0], mw, 0)):
            if skip.get(id(src), False):
                continue
            _call(lib, "svt_sum_rows", src.data_ptr(), dst.data_ptr(), rows,
                  total, m, stride, st)
            launches["sum"] += 1
        if cut < 5:                    # db1 and dbh are phase 5's
            sums[:h].zero_()
            sums[h + no * h:].zero_()
    db1 = sums[:h] if t_mode is None else sums[:h] * (lv / dbk)
    out = (dfold, dw1, db1, sums[h:h + no * h].view(no, h),
           sums[h + no * h:])
    if not ints:
        return out
    if route == "sm90":
        return out, tuple(sm90_ws_tiles(ws, b, hw)[..., :h].float()
                          for ws in (aq_ws, q_ws))
    return out, tuple(ws[:, :h].transpose(1, 2).float() for ws in (aq_ws,
                                                                   q_ws))


def sm90_tile_product_reference(a: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """(N, 64, CLUSTER_WIDTH) int8 tiles times W^T, W (H, H) int8 rows
    [n][k] zero-padded to CLUSTER_WIDTH: (N, 64, CLUSTER_WIDTH) int32,
    exact."""
    wp = torch.zeros((CLUSTER_WIDTH, CLUSTER_WIDTH), dtype=torch.float64,
                     device=a.device)
    wp[:w.shape[0], :w.shape[1]] = w.double()
    return (a.double() @ wp.T).to(torch.int32)


def sm90_tile_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The cluster passes' product alone, on CUDA tensors: a (N, 64,
    CLUSTER_WIDTH) int8 (N a multiple of CLUSTER; columns from padded_hidden(H)
    on zero) times W^T through W's slab stream, the clusters' multicast ring
    and int8 wgmma, as ``sm90_tile_product_reference`` computes it."""
    n = a.shape[0]
    if (a.device.type != "cuda" or a.dtype != torch.int8 or n % CLUSTER
            or a.shape[1:] != (BLOCK_PIXELS, CLUSTER_WIDTH)):
        raise ValueError("a must be CUDA int8 (N, 64, 512), N a multiple "
                         "of 4")
    a = a.contiguous()
    slabs = sm90_slabs(w.to(torch.int8))
    out = torch.empty((n, BLOCK_PIXELS, CLUSTER_WIDTH), dtype=torch.int32,
                      device=a.device)
    with torch.cuda.device(a.device):
        _call(_lib(), "svt_sm90_tile_product", a.data_ptr(), slabs.data_ptr(),
              out.data_ptr(), n, padded_hidden(w.shape[0]), _stream(a))
    return out


def sm90_chain_check(device) -> int:
    """On the card: how many of the 2^32 float inputs x give the cluster
    passes' a0 chain (seven thresholds found by bisection on the card's
    tanhf) another level than clip(round(7 tanh(x)), -7, 7)."""
    n = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(n.device):
        _call(_lib(), "svt_loss90_chain_check", n.data_ptr(), _stream(n))
    return int(n.item())


def sm90_max_clusters() -> dict:
    """The clusters of CLUSTER CTAs the card holds at once for each of the
    cluster passes' kernels (cudaOccupancyMaxActiveClusters)."""
    lib = _lib()
    names = ("fwd_bf16", "fwd_f32", "grad_bf16", "grad_f32", "dw",
             "product", "fwd_colored_bf16", "fwd_colored_f32", "sr_fwd_bf16",
             "sr_fwd_f32", "sr_grad_bf16", "sr_grad_f32",
             "sr_fwd_colored_bf16", "sr_fwd_colored_f32", "wide_fwd_bf16",
             "wide_fwd_f32", "wide_grad_bf16", "wide_grad_f32",
             "wide_fwd_colored_bf16", "wide_fwd_colored_f32", "wide_dw")
    return {k: lib.svt_loss90_max_clusters(i) for i, k in enumerate(names)}


def philox_device(ctr: torch.Tensor, key: tuple) -> torch.Tensor:
    """The kernels' Philox4x32-10 on the card: ctr (n, 4) int64 uint32
    values on a CUDA device -> (n, 4) int64 words; held against
    ``philox.philox4x32_10``."""
    c32 = (((ctr & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(
        torch.int32).contiguous()               # the same 32 bits
    out = torch.empty_like(c32)
    with torch.cuda.device(ctr.device):
        _call(_lib(), "svt_philox4x32_10", c32.data_ptr(), out.data_ptr(),
              c32.shape[0], key[0], key[1], _stream(ctr))
    return out.to(torch.int64) & 0xFFFFFFFF


class _LossInt8(torch.autograd.Function):
    """Counterpart of the JAX ``fused_decoder_bce_int8`` custom VJP: the
    forward returns the summed loss and keeps the five gradients it
    computed; the backward scales them by the scalar cotangent.  coords, y_t
    and mask are data, ``family`` a name, ``p_base`` the slice's first
    pixel in the call it belongs to."""

    @staticmethod
    def forward(ctx, fold, coords, w1, b1, wht, bht, y_t, mask, family,
                p_base):
        grads = run_loss_int8(fold, coords, w1, b1, wht, bht, y_t, mask,
                              family, p_base=p_base)
        ctx.save_for_backward(*grads)
        ctx.dtypes = (fold.dtype, w1.dtype, b1.dtype, wht.dtype, bht.dtype)
        return grads[0][:, 3, 0].sum()

    @staticmethod
    def backward(ctx, g):
        grads = ctx.saved_tensors
        dfold, dw1, db1, dwht, dbht = (
            (g * t).to(dt) for t, dt in zip(grads, ctx.dtypes))
        return dfold, None, dw1, db1, dwht, dbht, None, None, None, None


def fused_decoder_bce_int8(fold, coords, w1, b1, wht, bht, y_t,
                           mask: Optional[torch.Tensor] = None,
                           family: str = "bernoulli",
                           p_base: int = 0) -> torch.Tensor:
    """The summed reconstruction loss of the int8 decoder against y_t, with
    its gradients computed in the same call (see ``_LossInt8``): the clamped
    BCE, 0.5 * sum(mask * (sigmoid(head) - y)^2) for ``gaussian``, 0.5 *
    sum(mask * (d^2 / var + logvar)) for ``colored`` (coords chunk-permuted,
    y_t pre-paired).  ``p_base``: coords, y_t and mask are the pixels
    p_base .. of a larger call (``run_loss_int8``)."""
    return _LossInt8.apply(fold, coords, w1, b1, wht, bht, y_t, mask, family,
                           p_base)


def fused_bce_spatial_int8(gen: SpatialGenerator, coords: torch.Tensor,
                           theta, dx, z, y: torch.Tensor,
                           y_t: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None,
                           family: str = "bernoulli",
                           p_base: int = 0) -> torch.Tensor:
    """The JAX ``fused_bce_spatial_int8``: the pose fold in PyTorch, then
    the loss kernel.  y: (B, HW[, C]); ``y_t`` the targets already in the
    kernel's layout ((B, C, padded HW), colored (B, 2, HW/2); int8 k-128 or
    float), else built from y.  The colored family runs over chunk-permuted
    coords; a pixel count off the tiling is zero-padded to ``padded_hw``
    with a forced mask whose pad entries are 0.  ``p_base``: coords (and
    y_t, mask) are the pixel slice p_base .. of a larger grid, a pixel
    shard's (tile-aligned: no pad).  Returns the summed loss (0-d)."""
    hw = coords.shape[0]
    check_ported(hw, family)
    w0, w1f, c = fold_pose_into_first_layer(gen, theta, dx, z)
    fold = torch.stack([w0, w1f, c, torch.zeros_like(c)], dim=1)
    fold = fold.float().contiguous()
    hidden, head = gen.linears()
    coords = coords.float()
    if family == "colored":
        coords = colored_coords(coords, pick_tile(hw))
    pad = 0 if family == "colored" else padded_hw(hw) - hw
    if pad:
        coords = F.pad(coords, (0, 0, 0, pad))
        base = (torch.ones((hw,), dtype=torch.float32, device=coords.device)
                if mask is None else mask.reshape(hw).float())
        mask = F.pad(base, (0, pad))
    if y_t is None:
        if family == "colored":
            y_t = colored_targets(y, hw)
        else:
            y_t = y.reshape(y.shape[0], hw, -1).transpose(1, 2)
            if pad:
                y_t = F.pad(y_t, (0, pad))
    return fused_decoder_bce_int8(
        fold, coords.contiguous(), hidden.weight.T.contiguous(), hidden.bias,
        head.weight.contiguous(), head.bias, y_t, mask, family, p_base)
