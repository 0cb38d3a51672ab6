"""The int8 kernel microbenchmark's kernels on the card: hand-written sm_90a
CUDA kernels (``csrc/kernel_bench.cu``, ``csrc/kernel_bench_gemm.cu``,
``csrc/kernel_bench_bwd.cu``) and their plain PyTorch versions.

Counterparts of the Pallas kernels of ``tools/kernel_bench.py`` (the port's
tool is ``spatialvae_torch/tools/kernel_bench.py``).  The TPU grid is (B,
HW // pt): step s = (image s // (HW/pt), pixels (s % (HW/pt)) * pt ..).
On the card a block takes a group of consecutive steps (``step_groups``,
as the probe GEMMs do), or, for the two backward kernels, K5's grid of
64-pixel blocks with per-block partials and fixed-order sums.

- ``gemm_multi``: ``gemm2_kernel`` / ``gemm3_kernel``: per step the products
  of ``PRODUCTS`` on the constant tiles a (pt, H), g (pt, H) and W (H, H)
  int8: ``h1`` = a . W, ``dw`` = a^T . g, ``da`` = g . W^T, exact in int32;
  out (8, H) f32 = the int32 sum of their first 8 rows (``gemm1_kernel``,
  one product, is ``probes.gemm``);
- ``chain``: the a0 chain q = round(127 * tanh((x0*f0 + x1*f1) + c)) over
  each step's (pt, H) values, in ``CHAIN_MODES``: ``dep`` (``gvpu_kernel``:
  acc = q . W1q, a1 = tanh(acc * (sw/127) + b1), out a1 rows 0..7),
  ``rows`` (``vpuonly_kernel``: q rows 0..31), ``ind_rows`` (``givpu_kernel``:
  the constant tile's acc rows 0..7 and q rows 0..31), ``ind_sums``
  (``givpu2_kernel``: acc rows and q's column sums), ``sums``
  (``vpu2_kernel``: q's column sums);
- ``fwd_pipe``: ``fwdpipe_kernel`` (K4's forward with the bf16 a1, each
  block's pixels in runs of S 64-pixel sub-tiles in the prototype's
  order): (y, a1);
- ``fused_plain``: ``fplain_kernel``, the loss and gradient with each step's
  own scale: (dfold, dW1, db1, dWh^T, dbh);
- ``bwd_fixscale``: ``bwdfix_kernel``, K5's gradient from the bf16 residual
  with the constant scale 0.01: (dfold, dW1).

Small outputs are the last step's, as the TPU's constant output block holds
them after its sequential grid.  ``gemm_multi`` and ``chain`` also return
per-block sums of every value every step computed (int32, wrapping; and
f64 for ``dep``'s a1), so the whole computation, not only the rows kept,
is held against the plain version.  The plain versions compute the same
values step by step in grid order (the backward sums too); the wrappers
take them for CPU tensors and launch the kernels for CUDA tensors, or
raise.  Launches are counted per kernel in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from spatialvae_torch.kernels import probes
from spatialvae_torch.kernels.fused_decoder import _call, _lib, _stream
from spatialvae_torch.kernels.fused_decoder import workspace_budget
from spatialvae_torch.kernels.fused_decoder_int8 import (
    decoder_tail_int8_reference,
    dw_splits,
    image_chunks,
    pad_square,
    padded_hidden,
    ptr,
    run_grouped_dw,
)
from spatialvae_torch.precision import fp32_precision

PT = 64                         # pixels per sub-tile and backward block
OUT_F_ROWS, OUT_Q_ROWS = 8, 32
PRODUCTS = {"gemm2": ("dw", "da"), "gemm3": ("h1", "dw", "da")}
# product -> (probe layout dims, code of svt_kb_gemm_multi)
_LAYOUTS = {"h1": (((1,), (0,)), 0), "da": (((1,), (1,)), 1),
            "dw": (((0,), (0,)), 2)}
CHAIN_MODES = ("dep", "rows", "ind_rows", "ind_sums", "sums")
PIPE_SUB_TILES = (2, 4)
FIX_SCALE = 0.01
MAX_OUT = 8

# Kernel launches on CUDA tensors, by kernel (and mode).
LAUNCHES: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _count(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


step_groups = probes.step_groups
_wrap32 = probes._wrap32


def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer-valued tensors, exactly (float64)."""
    return a.double() @ b.double()


def grid_steps(b: int, hw: int, pt: int) -> int:
    return b * (hw // pt)


def _check_grid(b: int, hw: int, pt: int) -> None:
    if b < 1 or pt < PT or pt % PT or hw % pt:
        raise ValueError(f"need B >= 1 and pt a multiple of {PT} dividing "
                         f"HW: B={b} HW={hw} pt={pt}")


def _check_device(*ts) -> torch.device:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_t(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# gemm2, gemm3: the products of one step, on constant tiles
# ---------------------------------------------------------------------------


def _product_operands(name, a, g, w):
    """(x, y) of ``dot_general(x, y, dims)`` for the product ``name``."""
    return {"h1": (a, w), "dw": (a, g), "da": (g, w)}[name]


@torch.no_grad()
def gemm_multi_reference(run: str, a, g, w, steps: int) -> tuple:
    """Plain version of ``gemm_multi``: each step's products exactly, each
    product's (padded) output tiles summed into its block's word per group
    of steps, the last step's first 8 rows added."""
    tiles, groups = _multi_tiles(run, a, w, steps)
    sums = torch.zeros((groups, sum(t for t, *_ in tiles)), dtype=torch.int64,
                       device=a.device)
    for gi in probes._step_groups_of(steps, groups):
        col, out = 0, 0
        for name, (nt, bm, bn, mp, np_) in zip(PRODUCTS[run], tiles):
            x, y = _product_operands(name, a, g, w)
            dims = _LAYOUTS[name][0]
            code = probes.DIMS[dims]
            xm = x.t() if code == 2 else x
            ym = y.t() if code == 1 else y
            c = _exact(xm, ym).long()
            out = out + c[:OUT_F_ROWS]
            cp = F.pad(c, (0, np_ - c.shape[1], 0, mp - c.shape[0]))
            sums[gi, col:col + nt] += cp.reshape(
                mp // bm, bm, np_ // bn, bn).sum(dim=(1, 3)).reshape(-1)
            col += nt
    return _wrap32(out).float(), _wrap32(sums)


def _multi_tiles(run, a, w, steps) -> tuple:
    """[(tiles, BM, BN, Mp, Np) per product], step groups."""
    pt, h = a.shape
    out = []
    for name in PRODUCTS[run]:
        m, n, k = {"h1": (pt, h, h), "dw": (h, h, pt), "da": (pt, h, h)}[name]
        bm, bn, _ = probes.gemm_tile(k, "s8")
        mp, np_, _, _ = probes.gemm_padded(m, n, k, "s8")
        out.append(((mp // bm) * (np_ // bn), bm, bn, mp, np_))
    return out, step_groups(steps, sum(t for t, *_ in out))


def gemm_multi(run: str, a, g, w, steps: int) -> tuple:
    """``(out (8, H) f32, sums (groups, tiles) int32)`` of ``steps`` steps of
    ``PRODUCTS[run]`` on a, g (pt, H) and w (H, H) int8; CPU tensors take
    the plain version, CUDA tensors launch ``kb_gemm_multi`` and
    ``kb_rows_sum``."""
    if run not in PRODUCTS:
        raise ValueError(f"unknown run {run!r}")
    for name, t in (("a", a), ("g", g), ("w", w)):
        if t.dtype != torch.int8 or t.dim() != 2:
            raise TypeError(f"{name} must be an int8 matrix")
    pt, h = a.shape
    if g.shape != a.shape or w.shape != (h, h) or pt < OUT_F_ROWS \
            or h < OUT_F_ROWS or steps < 1:
        raise ValueError("gemm_multi takes a, g (pt, H), w (H, H), pt and H "
                         f">= {OUT_F_ROWS}, steps >= 1")
    dev = _check_device(a, g, w)
    if dev.type == "cpu":
        return gemm_multi_reference(run, a, g, w, steps)
    tiles, groups = _multi_tiles(run, a, w, steps)
    ops = []
    for name, (_, _, _, mp, np_) in zip(PRODUCTS[run], tiles):
        x, y = _product_operands(name, a, g, w)
        dims, code = _LAYOUTS[name]
        m, n, k = probes.gemm_shape(x.shape, y.shape, dims)
        _, _, kp, kb = probes.gemm_padded(m, n, k, "s8")
        shapes = {0: ((mp, kp), (kp, np_)), 1: ((mp, kp), (np_, kp)),
                  2: ((kp, mp), (kp, np_))}[code]
        xp, yp = (F.pad(t, (0, c - t.shape[1], 0, r - t.shape[0])).contiguous()
                  for t, (r, c) in zip((x, y), shapes))
        ops.append((xp, yp, mp, np_, kb, code,
                    int(probes.gemm_tile(k, "s8") == probes.SMALL)))
    n = len(ops)
    npad = max(o[3] for o in ops)
    rows = torch.empty((n, OUT_F_ROWS, npad), dtype=torch.int32, device=dev)
    sums = torch.empty((groups, sum(t for t, *_ in tiles)), dtype=torch.int32,
                       device=dev)
    out = torch.empty((OUT_F_ROWS, h), dtype=torch.float32, device=dev)
    arr = lambda ct, vals: (ct * n)(*vals)  # noqa: E731
    with torch.cuda.device(dev):
        lib = _lib()
        _call(lib, "svt_kb_gemm_multi", n,
              arr(ctypes.c_void_p, [o[0].data_ptr() for o in ops]),
              arr(ctypes.c_void_p, [o[1].data_ptr() for o in ops]),
              arr(ctypes.c_int, [o[2] for o in ops]),
              arr(ctypes.c_int, [o[3] for o in ops]),
              arr(ctypes.c_int, [o[4] for o in ops]),
              arr(ctypes.c_int, [o[5] for o in ops]),
              arr(ctypes.c_int, [o[6] for o in ops]),
              rows.data_ptr(), npad, sums.data_ptr(), steps, groups,
              _stream(a))
        _count(f"gemm_multi:{run}")
        _call(lib, "svt_kb_rows_sum", rows.data_ptr(), out.data_ptr(), n,
              npad, h, _stream(a))
        _count(f"rows_sum:{run}")
    return out, sums


# ---------------------------------------------------------------------------
# the a0 chain, alone and beside a GEMM
# ---------------------------------------------------------------------------


def _first_layer_q(fold_b, coords, p0: int, n: int):
    """(a0, q) of one image's pixels p0 .. p0+n in the kernels' op order:
    a0 = tanh((x0*f0 + x1*f1) + c), q = round(127 * a0) (float-valued)."""
    x0 = coords[p0:p0 + n, 0:1]
    x1 = coords[p0:p0 + n, 1:2]
    h0 = (x0 * fold_b[0:1] + x1 * fold_b[1:2]) + fold_b[2:3]
    a0 = torch.tanh(h0)
    return a0, torch.round(a0 * 127.0)


def _check_chain(mode, fold, coords, pt, w1q, sw, b1, aq) -> torch.device:
    if mode not in CHAIN_MODES:
        raise ValueError(f"unknown chain mode {mode!r}")
    if fold.dim() != 3 or fold.shape[1] != 4 or coords.dim() != 2 \
            or coords.shape[1] != 2:
        raise ValueError("chain takes fold (B, 4, H) and coords (HW, 2)")
    b, _, h = fold.shape
    _check_grid(b, coords.shape[0], pt)
    _check_t("fold", fold, torch.float32, fold.shape)
    _check_t("coords", coords, torch.float32, coords.shape)
    if mode != "rows" and mode != "sums":
        _check_t("w1q", w1q, torch.int8, (h, h))
    if mode == "dep":
        _check_t("sw", sw, torch.float32, sw.shape)
        _check_t("b1", b1, torch.float32, (h,))
        if sw.numel() != 1:
            raise ValueError("sw must hold one value")
    if mode.startswith("ind"):
        _check_t("aq", aq, torch.int8, (pt, h))
    return _check_device(fold, coords, w1q, sw, b1, aq)


@fp32_precision()
@torch.no_grad()
def chain_reference(mode, fold, coords, pt, w1q=None, sw=None, b1=None,
                    aq=None) -> tuple:
    """Plain version of ``chain``: every step's chain (and GEMM) in grid
    order, each group's values summed as the kernels' blocks sum them."""
    b, _, h = fold.shape
    hw = coords.shape[0]
    steps = grid_steps(b, hw, pt)
    groups = step_groups(steps, 1)
    isums = torch.zeros(groups, dtype=torch.int64, device=fold.device)
    fsums = torch.zeros(groups, dtype=torch.float64, device=fold.device)
    tiles = hw // pt
    outs = ()
    for s, gi in enumerate(probes._step_groups_of(steps, groups)):
        _, q = _first_layer_q(fold[s // tiles], coords, (s % tiles) * pt, pt)
        isums[gi] += q.long().sum()
        if mode == "dep":
            acc = _exact(q, w1q).float()
            a1 = torch.tanh(acc * (sw.reshape(()).float() / 127.0) + b1)
            fsums[gi] += a1.double().sum()
            outs = (a1[:OUT_F_ROWS].contiguous(),)
        elif mode == "rows":
            outs = (q[:OUT_Q_ROWS].to(torch.int8),)
        elif mode == "sums":
            outs = (q.sum(0, keepdim=True).to(torch.int32),)
        else:
            acc = _exact(aq, w1q).long()
            isums[gi] += acc.sum()
            last = (q[:OUT_Q_ROWS].to(torch.int8) if mode == "ind_rows"
                    else q.sum(0, keepdim=True).to(torch.int32))
            outs = (acc[:OUT_F_ROWS].float(), last)
    return outs, (_wrap32(isums), fsums)


_CHAIN_CODES = {m: i for i, m in enumerate(CHAIN_MODES)}


def chain(mode, fold, coords, pt, w1q=None, sw=None, b1=None,
          aq=None) -> tuple:
    """``(outs, (isums (groups,) int32, fsums (groups,) f64))`` of the chain
    in ``mode`` (module docstring) over the grid (B, HW // pt); ``outs`` is
    (a1 rows,) for ``dep``, (q rows,) for ``rows``, (q column sums (1, H),)
    for ``sums``, (acc rows, q rows or column sums) for ``ind_*``.  CPU
    tensors take ``chain_reference``, CUDA tensors launch ``kb_chain``."""
    dev = _check_chain(mode, fold, coords, pt, w1q, sw, b1, aq)
    if dev.type == "cpu":
        return chain_reference(mode, fold, coords, pt, w1q, sw, b1, aq)
    b, _, h = fold.shape
    hw = coords.shape[0]
    steps = grid_steps(b, hw, pt)
    groups = step_groups(steps, 1)
    kp = padded_hidden(h)
    lib = _lib()
    w1qt = pad_square(w1q.T) if w1q is not None else None
    aqp = (F.pad(aq, (0, kp - h)).contiguous() if aq is not None
           and mode.startswith("ind") else None)
    i32 = dict(dtype=torch.int32, device=dev)
    out_f = (torch.empty((OUT_F_ROWS, h), dtype=torch.float32, device=dev)
             if mode in ("dep", "ind_rows", "ind_sums") else None)
    out_q = (torch.empty((OUT_Q_ROWS, h), dtype=torch.int8, device=dev)
             if mode in ("rows", "ind_rows") else None)
    out_s = (torch.empty((1, h), **i32) if mode in ("sums", "ind_sums")
             else None)
    isums = torch.empty(groups, **i32)
    fsums = torch.empty(groups, dtype=torch.float64, device=dev)
    block = lib.svt_int8_ws_block(h)
    ws = (torch.empty((groups * block,), dtype=torch.uint8, device=dev)
          if block else None)
    with torch.cuda.device(dev):
        _call(lib, "svt_kb_chain", _CHAIN_CODES[mode], fold.data_ptr(),
              coords.data_ptr(), ptr(w1qt),
              ptr(sw.reshape(1) if mode == "dep" else None),
              ptr(b1 if mode == "dep" else None), ptr(aqp), ptr(out_f),
              ptr(out_q), ptr(out_s), isums.data_ptr(), fsums.data_ptr(),
              ptr(ws), b, hw, h, pt, groups, _stream(fold))
        _count(f"chain:{mode}")
    outs = {"dep": (out_f,), "rows": (out_q,), "sums": (out_s,),
            "ind_rows": (out_f, out_q), "ind_sums": (out_f, out_s)}[mode]
    return outs, (isums, fsums)


# ---------------------------------------------------------------------------
# fwd-pipe: K4's forward with the a1 output, S sub-tiles per block
# ---------------------------------------------------------------------------


def _check_tail(fold, coords, w1q, sw, wht, pt, b1=None, bht=None) -> tuple:
    """(device, B, H, No) of a forward or backward run's inputs; b1 and
    bht are checked when given."""
    if fold.dim() != 3 or fold.shape[1] != 4 or coords.dim() != 2 \
            or coords.shape[1] != 2 or wht.dim() != 2:
        raise ValueError("need fold (B, 4, H), coords (HW, 2), wht (No, H)")
    b, _, h = fold.shape
    no = wht.shape[0]
    _check_grid(b, coords.shape[0], pt)
    if not 1 <= no <= MAX_OUT:
        raise ValueError(f"No={no}; the kernels take 1 to {MAX_OUT}")
    _check_t("fold", fold, torch.float32, fold.shape)
    _check_t("coords", coords, torch.float32, coords.shape)
    _check_t("w1q", w1q, torch.int8, (h, h))
    if b1 is not None:
        _check_t("b1", b1, torch.float32, (h,))
    if bht is not None:
        _check_t("bht", bht, torch.float32, (no,))
    if sw.numel() != 1 or sw.dtype != torch.float32:
        raise ValueError("sw must be one float32 value")
    return _check_device(fold, coords, w1q, sw, b1, wht, bht), b, h, no


def fwd_pipe_reference(fold, coords, w1q, sw, b1, wht, bht) -> tuple:
    """Plain version of ``fwd_pipe``: K4's forward with the bf16 a1 (the
    sub-tile order changes no value)."""
    return decoder_tail_int8_reference(fold, coords, w1q, sw.reshape(()),
                                       b1, wht, bht, return_a1=True)


def fwd_pipe(sub_tiles: int, fold, coords, w1q, sw, b1, wht, bht,
             pt: int) -> tuple:
    """(y (B, No, HW) f32, a1 (B, HW, H) bf16) of K4's forward with float32
    head weights; CUDA tensors launch ``kb_fwd_pipe<sub_tiles>``."""
    if sub_tiles not in PIPE_SUB_TILES:
        raise ValueError(f"sub_tiles must be one of {PIPE_SUB_TILES}")
    dev, b, h, no = _check_tail(fold, coords, w1q, sw, wht, pt, b1, bht)
    _check_t("wht", wht, torch.float32, (no, h))
    if dev.type == "cpu":
        return fwd_pipe_reference(fold, coords, w1q, sw, b1, wht, bht)
    hw = coords.shape[0]
    steps = grid_steps(b, hw, pt)
    groups = step_groups(steps, 1)
    lib = _lib()
    y = torch.empty((b, no, hw), dtype=torch.float32, device=dev)
    a1 = torch.empty((b, hw, h), dtype=torch.bfloat16, device=dev)
    w1qt = pad_square(w1q.T)
    block = lib.svt_int8_ws_block(h)
    ws = (torch.empty((groups * block,), dtype=torch.uint8, device=dev)
          if block else None)
    with torch.cuda.device(dev):
        _call(lib, "svt_kb_fwd_pipe", sub_tiles, fold.data_ptr(),
              coords.data_ptr(), w1qt.data_ptr(),
              sw.reshape(1).data_ptr(), b1.data_ptr(), wht.data_ptr(),
              bht.data_ptr(), y.data_ptr(), a1.data_ptr(), ptr(ws), b, hw, h,
              no, pt, groups, _stream(fold))
        _count(f"fwd_pipe{sub_tiles}")
    return y, a1


# ---------------------------------------------------------------------------
# fused-plain and bwd-fixscale: modes of K5's passes
# ---------------------------------------------------------------------------


def _steps(b, hw, pt):
    """(image, first pixel) of every step in grid order."""
    return [(i, j * pt) for i in range(b) for j in range(hw // pt)]


def _add(acc: Optional[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
    return v.clone() if acc is None else acc + v


@fp32_precision()
@torch.no_grad()
def fused_plain_reference(fold, coords, w1q, sw, b1, wht, bht, yt,
                          pt: int) -> tuple:
    """Plain version of ``fused_plain``, step by step in grid order (every
    sum too, first step assigned then added, as the TPU's output blocks
    accumulate).  wht holds bf16 values (float32 or bfloat16)."""
    b, _, h = fold.shape
    hw = coords.shape[0]
    sw = sw.reshape(()).float()
    whtb = wht.float()
    bf = lambda t: t.bfloat16().float()  # noqa: E731
    w1qf = w1q.float()
    dfold = torch.empty((b, 4, h), dtype=torch.float32, device=fold.device)
    dw1 = db1 = dwht = dbht = None
    for i, p0 in _steps(b, hw, pt):
        a0, aq = _first_layer_q(fold[i], coords, p0, pt)
        acc = _exact(aq, w1qf).float()
        a1 = torch.tanh(acc * (sw * (1.0 / 127.0)) + b1)
        a1c = bf(a1)
        sig = torch.sigmoid(a1c @ whtb.T + bht)             # (pt, No)
        y = yt[i, :, p0:p0 + pt].T
        log_s = torch.clamp(torch.log(sig), min=-100.0)
        log_1ms = torch.clamp(torch.log1p(-sig), min=-100.0)
        bce = -(y * log_s + (1.0 - y) * log_1ms).sum()
        dz2 = torch.where(sig * (1.0 - sig) == 0.0, torch.zeros_like(sig),
                          sig - y)
        dz2c = bf(dz2)
        da1 = dz2c @ whtb                                    # (pt, H)
        dh1 = da1 * (1.0 - a1 * a1)
        sg = dh1.abs().max() * (1.0 / 127.0) + 1e-30
        dh1q = torch.clamp(torch.round(dh1 * (1.0 / sg)), -127, 127)
        da0 = _exact(dh1q, w1qf.T).float() * (sg * sw)
        dh0 = bf(da0 * (1.0 - a0 * a0))
        x3 = torch.stack([bf(coords[p0:p0 + pt, 0]), bf(coords[p0:p0 + pt, 1]),
                          torch.ones_like(dh0[:, 0]),
                          torch.zeros_like(dh0[:, 0])], dim=1)
        step_fold = x3.T @ dh0
        step_fold[3, 0] += bce
        dfold[i] = step_fold if p0 == 0 else dfold[i] + step_fold
        dw1 = _add(dw1, _exact(aq.T, dh1q).float() * (sg * (1.0 / 127.0)))
        db1 = _add(db1, dh1.sum(0))
        dwht = _add(dwht, dz2c.T @ a1c)
        dbht = _add(dbht, dz2.sum(0))
    return dfold, dw1, db1, dwht, dbht


@fp32_precision()
@torch.no_grad()
def bwd_fixscale_reference(fold, coords, w1q, sw, wht, a1, y, g,
                           pt: int) -> tuple:
    """Plain version of ``bwd_fixscale``, step by step in grid order."""
    b, _, h = fold.shape
    hw = coords.shape[0]
    w1qf = w1q.float()
    dfold = torch.empty((b, 4, h), dtype=torch.float32, device=fold.device)
    dw1 = None
    for i, p0 in _steps(b, hw, pt):
        a0, a0q = _first_layer_q(fold[i], coords, p0, pt)
        a1s = a1[i, p0:p0 + pt].float()
        s = y[i, :, p0:p0 + pt]
        dz2t = g[i, :, p0:p0 + pt] * s * (1.0 - s)           # (No, pt)
        da1 = dz2t.T @ wht.float()
        dh1 = da1 * (1.0 - a1s * a1s)
        dh1q = torch.clamp(torch.round(dh1 * (1.0 / FIX_SCALE)), -127, 127)
        da0 = _exact(dh1q, w1qf.T).float()
        dh0 = da0 * (1.0 - a0 * a0)
        x0 = coords[p0:p0 + pt, 0:1]
        x1 = coords[p0:p0 + pt, 1:2]
        step_fold = torch.stack([(x0 * dh0).sum(0), (x1 * dh0).sum(0),
                                 dh0.sum(0), torch.zeros_like(dh0[0])])
        dfold[i] = step_fold if p0 == 0 else dfold[i] + step_fold
        dw1 = _add(dw1, _exact(a0q.T, dh1q).float())
    return dfold, dw1


def _grad_buffers(lib, b, hw, h, pt, dev, rows: int):
    """The per-block partials, workspaces and chunks of K5's wrapper."""
    f32 = dict(dtype=torch.float32, device=dev)
    blocks = hw // PT
    hwp, kp, gpi = blocks * PT, padded_hidden(h), hw // pt
    block = lib.svt_int8_ws_block(h)
    chunks = image_chunks(b, 2 * kp * hwp + blocks * block,
                          workspace_budget(dev))
    bc = chunks[0][1]
    return dict(
        blocks=blocks, hwp=hwp, gpi=gpi, chunks=chunks, block=block,
        gscale=torch.empty((b * gpi,), **f32),
        part_fold=torch.empty((b * blocks, rows, h), **f32),
        aq_ws=torch.empty((bc, kp, hwp), dtype=torch.int8, device=dev),
        q_ws=torch.empty((bc, kp, hwp), dtype=torch.int8, device=dev),
        ws=(torch.empty((bc * blocks * block,), dtype=torch.uint8,
                        device=dev) if block else None),
        part_dw=torch.empty((sum(dw_splits(n * gpi) for _, n in chunks), h,
                             h), **f32))


def _sum_partials(lib, st, bufs, b, h, rows, splits, tag) -> tuple:
    """dfold (B, 4, H) and dW1 (H, H) from the partials, in a fixed order."""
    f32 = dict(dtype=torch.float32, device=bufs["gscale"].device)
    dfold = torch.zeros((b, 4, h), **f32)
    dw1 = torch.empty((h, h), **f32)
    blocks = bufs["blocks"]
    for src, dst, n_rows, total, m, stride in (
            (bufs["part_fold"], dfold, blocks, b * blocks, rows * h, 4 * h),
            (bufs["part_dw"], dw1, splits, splits, h * h, 0)):
        _call(lib, "svt_sum_rows", src.data_ptr(), dst.data_ptr(), n_rows,
              total, m, stride, st)
        _count(f"{tag}_sum")
    return dfold, dw1


def fused_plain(fold, coords, w1q, sw, b1, wht, bht, yt, pt: int) -> tuple:
    """``(dfold (B, 4, H) with the loss at [:, 3, 0], dW1 (H, H), db1 (H,),
    dWh^T (No, H), dbh (No,))`` of the loss and gradient with each step's
    own scale; wht holds bf16 values, yt (B, No, HW) float32 targets.  CUDA
    tensors launch K5's passes in their T1_PLAIN mode, the grouped dW1
    kernel (each step a group) and the fixed-order sums."""
    dev, b, h, no = _check_tail(fold, coords, w1q, sw, wht, pt, b1, bht)
    hw = coords.shape[0]
    _check_t("yt", yt, torch.float32, (b, no, hw))
    if wht.dtype not in (torch.float32, torch.bfloat16) \
            or tuple(wht.shape) != (no, h):
        raise TypeError("wht must be (No, H) float32 or bfloat16")
    if dev.type == "cpu":
        return fused_plain_reference(fold, coords, w1q, sw, b1, wht, bht, yt,
                                     pt)
    lib = _lib()
    st = _stream(fold)
    f32 = dict(dtype=torch.float32, device=dev)
    bufs = _grad_buffers(lib, b, hw, h, pt, dev, 4)
    blocks, gpi, chunks = bufs["blocks"], bufs["gpi"], bufs["chunks"]
    w1qt, w1qp = pad_square(w1q.T), pad_square(w1q)
    swp = sw.reshape(1).contiguous()
    whtf = wht.float().contiguous()
    mw = h + no * h + no
    part_max = torch.empty((b * blocks,), **f32)
    part_w = torch.empty((b * blocks, mw), **f32)
    with torch.cuda.device(dev):
        for b0, n in (chunks if bufs["block"] else [(0, b)]):
            _call(lib, "svt_kb_plain_scale",
                  fold.data_ptr() + b0 * 4 * h * 4, coords.data_ptr(),
                  w1qt.data_ptr(), swp.data_ptr(), b1.data_ptr(),
                  whtf.data_ptr(), bht.data_ptr(),
                  yt.data_ptr() + b0 * no * hw * 4,
                  part_max[b0 * blocks:].data_ptr(), ptr(bufs["ws"]), n, hw,
                  h, no, st)
            _count("plain_scale")
        splits = 0
        for b0, n in chunks:
            _call(lib, "svt_kb_plain_grad", fold.data_ptr(), coords.data_ptr(),
                  w1qt.data_ptr(), swp.data_ptr(), b1.data_ptr(),
                  whtf.data_ptr(), bht.data_ptr(), yt.data_ptr(),
                  w1qp.data_ptr(), part_max.data_ptr(),
                  bufs["gscale"].data_ptr(), bufs["aq_ws"].data_ptr(),
                  bufs["q_ws"].data_ptr(), bufs["part_fold"].data_ptr(),
                  part_w.data_ptr(), ptr(bufs["ws"]), b0, n, hw, h, no, pt,
                  st)
            _count("plain_grad")
            splits += run_grouped_dw(lib, bufs["aq_ws"], bufs["q_ws"],
                                     bufs["gscale"][b0 * gpi:],
                                     bufs["part_dw"][splits:], n,
                                     bufs["hwp"], h, pt, gpi, st)
            _count("plain_dw")
        dfold, dw1 = _sum_partials(lib, st, bufs, b, h, 4, splits, "plain")
        sums = torch.empty((mw,), **f32)
        stage = torch.empty((-(-b * blocks // 64), mw), **f32)
        for src, dst, rows, total in ((part_w, stage, 64, b * blocks),
                                      (stage, sums, stage.shape[0],
                                       stage.shape[0])):
            _call(lib, "svt_sum_rows", src.data_ptr(), dst.data_ptr(), rows,
                  total, mw, mw, st)
            _count("plain_sum")
    return (dfold, dw1, sums[:h], sums[h:h + no * h].view(no, h),
            sums[h + no * h:])


def bwd_fixscale(fold, coords, w1q, sw, wht, a1, y, g, pt: int) -> tuple:
    """``(dfold (B, 4, H), dW1 (H, H))`` of K5's gradient from the bf16
    residual a1 (B, HW, H) with the constant scale 0.01; y, g (B, No, HW)
    and wht (No, H) float32.  CUDA tensors launch K5's gradient pass in its
    T1_FIX mode, the grouped dW1 kernel (every group's scale 1) and the
    fixed-order sums."""
    dev, b, h, no = _check_tail(fold, coords, w1q, sw, wht, pt)
    hw = coords.shape[0]
    _check_t("wht", wht, torch.float32, (no, h))
    _check_t("a1", a1, torch.bfloat16, (b, hw, h))
    _check_t("y", y, torch.float32, (b, no, hw))
    _check_t("g", g, torch.float32, (b, no, hw))
    if dev.type == "cpu":
        return bwd_fixscale_reference(fold, coords, w1q, sw, wht, a1, y, g,
                                      pt)
    lib = _lib()
    st = _stream(fold)
    bufs = _grad_buffers(lib, b, hw, h, pt, dev, 3)
    gpi = bufs["gpi"]
    w1qp = pad_square(w1q)
    swp = sw.reshape(1).contiguous()
    with torch.cuda.device(dev):
        splits = 0
        for b0, n in bufs["chunks"]:
            _call(lib, "svt_kb_fix_grad", fold.data_ptr(), coords.data_ptr(),
                  swp.data_ptr(), wht.data_ptr(), a1.data_ptr(), y.data_ptr(),
                  g.data_ptr(), w1qp.data_ptr(), bufs["gscale"].data_ptr(),
                  bufs["aq_ws"].data_ptr(), bufs["q_ws"].data_ptr(),
                  bufs["part_fold"].data_ptr(), ptr(bufs["ws"]), b0, n, hw, h,
                  no, pt, st)
            _count("fix_grad")
            splits += run_grouped_dw(lib, bufs["aq_ws"], bufs["q_ws"],
                                     bufs["gscale"][b0 * gpi:],
                                     bufs["part_dw"][splits:], n,
                                     bufs["hwp"], h, pt, gpi, st)
            _count("fix_dw")
        return _sum_partials(lib, st, bufs, b, h, 3, splits, "fix")
