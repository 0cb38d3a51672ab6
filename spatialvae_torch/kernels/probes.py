"""The int4 and narrow-accumulator probes on the card: hand-written sm_90a
CUDA kernels (``csrc/probes.cu``) and their plain PyTorch versions.

Counterparts of the Pallas kernels of the two measurement tools of the JAX
package (``tools/probe_int4.py``, ``tools/probe_i16acc.py``; the port's
tools are ``spatialvae_torch/tools/``):

- ``gemm``: ``dot_general(a, b, dims)`` of int8 values with an int32
  accumulator, repeated for ``steps`` grid steps, the first ``out_rows``
  rows of the last step's product as float32.  ``dims`` is the TPU's
  contraction: ((1,), (0,)) a (M, K) . b (K, N); ((1,), (1,)) a (M, K) .
  b (N, K)^T; ((0,), (0,)) a (K, M)^T . b (K, N), a transposed in the
  kernel at every step (the TPU tool's ``swapaxes``).  ``elem="s4"`` casts
  both operands to 4 bits (values wrap as an int4 cast does; [-7, 7] is
  unchanged) and runs the s4 tensor-core instruction on operands packed two
  values per byte (``pack_s4``); ``"s8"`` runs int8 (for [-7, 7] values
  the same numbers).  ``store`` (``"int32"``, ``"int16"``, ``"bfloat16"``,
  ``"float32"``) writes each step's accumulator at that width and reads it
  back before it becomes float32: int16 saturates, bf16 rounds the float32
  value to nearest even;
- ``build_t``: the feature-major first layer h0 = (f0*x0 + f1*x1) + c over
  (H, pixels), round(127 * tanh(h0)) and its column sums, for every image
  and pixel block, the last step's (1, pt) sums out;
- ``transpose_sum``: the transpose of a (pt, H) int8 tile consumed by its
  row sums (1, H) int32, repeated for ``steps`` steps.

Each returns ``(out, sums)``: ``out`` is the TPU kernel's output, ``sums``
one int32 per CUDA block of the launch, the wrapping 32-bit sum of every
value the block computed over its steps (every accumulator element of every
step, or every column sum), so the whole computation, not only the rows
kept, is held against the plain version.  The plain versions compute the
same values in the same blocks and steps, each step's product anew; the
wrappers take them for CPU tensors and launch the kernels for CUDA tensors,
or raise.  Launches are counted per kernel in ``LAUNCHES``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spatialvae_torch.kernels.fused_decoder import _call, _lib, _stream

# dims -> the kernel's layout code (d10, d11, d00)
DIMS = {((1,), (0,)): 0, ((1,), (1,)): 1, ((0,), (0,)): 2}
ELEMS = ("s8", "s4")
STORES = {None: 0, "int32": 1, "int16": 2, "bfloat16": 3, "float32": 4}
_STORE_DTYPES = {"int32": torch.int32, "int16": torch.int16,
                 "bfloat16": torch.bfloat16, "float32": torch.float32}
# a GEMM block's tile (rows, columns, ways the k range is split): the big
# tile while both operand tiles fit shared memory whole (k up to
# BIG_MAX_KB bytes), else the small one
BIG = (128, 128, 1)
SMALL = (64, 32, 4)
BIG_MAX_KB = 768
K_SLAB = 64                 # k bytes per iteration of the kernels' k loop
BUILD_PIX = 128             # pixels per probe_build_t block
TR_BH = 16                  # columns per probe_transpose_sum block
# the step groups of a launch: at most 8 blocks for each of an H100's 132
# SMs, each block at least 16 steps where the steps allow it
TARGET_BLOCKS = 8 * 132
MIN_GROUP_STEPS = 16

# Kernel launches on CUDA tensors, by kernel name.
LAUNCHES: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _count(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _up(x: int, q: int) -> int:
    return -(-x // q) * q


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 to int32, wrapping as the kernels' 32-bit sums do."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def step_groups(steps: int, blocks: int) -> int:
    """Groups of consecutive steps a launch of ``blocks`` blocks per step
    runs in (one block per group and tile): the largest divisor of
    ``steps`` within TARGET_BLOCKS blocks that leaves each block at least
    MIN_GROUP_STEPS steps, else 1."""
    best = 1
    for d in range(1, min(steps, TARGET_BLOCKS) + 1):
        if (steps % d == 0 and blocks * d <= TARGET_BLOCKS
                and steps // d >= MIN_GROUP_STEPS):
            best = d
    return best


def _step_groups_of(steps: int, groups: int) -> list:
    """The group of each step: the kernels' blocks of group g run steps
    g * steps // groups .. (g + 1) * steps // groups - 1."""
    return [g for g in range(groups)
            for _ in range(g * steps // groups, (g + 1) * steps // groups)]


def gemm_shape(a_shape, b_shape, dims) -> tuple:
    """(M, N, K) of ``dot_general(a, b, dims)``; raises on what the kernels
    do not take."""
    if dims not in DIMS:
        raise ValueError(f"unsupported dimension numbers {dims}")
    if len(a_shape) != 2 or len(b_shape) != 2:
        raise ValueError("the probes multiply matrices")
    code = DIMS[dims]
    m, ka = (a_shape[1], a_shape[0]) if code == 2 else a_shape
    n, kb = (b_shape[0], b_shape[1]) if code == 1 else (b_shape[1],
                                                         b_shape[0])
    if ka != kb:
        raise ValueError(f"contraction sizes differ: {ka} and {kb}")
    return m, n, ka


def gemm_tile(k: int, elem: str) -> tuple:
    """(rows, columns, k split) of the block tile for k values of
    ``elem``."""
    return BIG if (k if elem == "s8" else -(-k // 2)) <= BIG_MAX_KB else SMALL


def gemm_padded(m: int, n: int, k: int, elem: str) -> tuple:
    """(Mp, Np, Kp, kb): the sizes the kernel runs, Kp in values and kb in
    bytes, zero-padded to its tile and k slabs."""
    bm, bn, split = gemm_tile(k, elem)
    per_byte = 1 if elem == "s8" else 2
    kb = _up(-(-k // per_byte), K_SLAB * split)
    return _up(m, bm), _up(n, bn), kb * per_byte, kb


def int4_values(x: torch.Tensor) -> torch.Tensor:
    """int8 values cast to 4 bits and back: wrapped into [-8, 7]."""
    return ((x.to(torch.int16) + 8) % 16 - 8).to(torch.int8)


def _check_store(store, code: int, k: int, elem: str, out_rows: int,
                 m: int) -> None:
    if store not in STORES:
        raise ValueError(f"unsupported store {store!r}")
    if store is not None and (code != 0 or gemm_tile(k, elem) != BIG
                              or out_rows != m):
        raise ValueError("a store takes the ((1,), (0,)) layout, k up to "
                         f"{BIG_MAX_KB} bytes and every output row")


def _stored(c: torch.Tensor, store) -> tuple:
    """(values folded into the sums as int64, float32 output) of the
    int64 accumulator ``c`` stored at the width ``store``."""
    if store == "int16":
        c = c.clamp(-32768, 32767)
    if store in ("bfloat16", "float32"):
        f = c.to(torch.int32).float()
        if store == "bfloat16":
            f = f.bfloat16().float()
        return f.long(), f
    return c, c.to(torch.int32).float()


@torch.no_grad()
def gemm_reference(a, b, dims, *, steps: int, out_rows: int, elem="s8",
                   store=None) -> tuple:
    """Plain version of ``gemm``: each step's product exactly (in float64,
    integer-valued), stored, folded into its block's sum."""
    m, n, k = gemm_shape(a.shape, b.shape, dims)
    code = DIMS[dims]
    _check_store(store, code, k, elem, out_rows, m)
    if elem == "s4":
        a, b = int4_values(a), int4_values(b)
    x = (a.t() if code == 2 else a).double()
    y = (b.t() if code == 1 else b).double()
    bm, bn, _ = gemm_tile(k, elem)
    mp, np_, _, _ = gemm_padded(m, n, k, elem)
    tm, tn = mp // bm, np_ // bn
    groups = step_groups(steps, tm * tn)
    sums = torch.zeros((groups, tm, tn), dtype=torch.int64, device=a.device)
    for g in _step_groups_of(steps, groups):
        vals, out = _stored((x @ y).long(), store)
        vals = F.pad(vals, (0, np_ - n, 0, mp - m))
        sums[g] += vals.reshape(tm, bm, tn, bn).sum(dim=(1, 3))
    return out[:out_rows].contiguous(), _wrap32(sums)


@torch.no_grad()
def pack_s4_reference(x: torch.Tensor, kdim: int) -> torch.Tensor:
    """Two 4-bit values per byte along ``kdim`` (0 or 1), the lower index in
    the low nibble."""
    v = x.to(torch.int16) % 16
    lo, hi = (v[:, 0::2], v[:, 1::2]) if kdim == 1 else (v[0::2], v[1::2])
    return (lo + hi * 16).to(torch.uint8)


def pack_s4(x: torch.Tensor, kdim: int) -> torch.Tensor:
    """``pack_s4_reference`` of a contiguous int8 matrix whose size along
    ``kdim`` is even; CUDA tensors launch ``probe_pack_s4``."""
    if x.dtype != torch.int8 or x.dim() != 2 or kdim not in (0, 1) \
            or x.shape[kdim] % 2 or not x.is_contiguous():
        raise ValueError("pack_s4 takes a contiguous int8 matrix, even "
                         "along kdim")
    if x.device.type == "cpu":
        return pack_s4_reference(x, kdim)
    rows, cols = x.shape
    out = torch.empty((rows, cols // 2) if kdim == 1 else (rows // 2, cols),
                      dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        _call(_lib(), "svt_probe_pack_s4", x.data_ptr(), out.data_ptr(),
              rows, cols, kdim, _stream(x))
    _count("probe_pack_s4")
    return out


def gemm_kernel_name(dims, elem: str, k: int, store=None) -> str:
    """The CUDA kernel ``gemm`` launches for these arguments."""
    name = _lib().svt_probe_gemm_name(
        DIMS[dims], int(elem == "s4"), int(gemm_tile(k, elem) == SMALL),
        STORES[store])
    if name is None:
        raise ValueError("no probe GEMM kernel for these arguments")
    return name.decode()


def gemm(a, b, dims, *, steps: int, out_rows: int, elem="s8",
         store=None) -> tuple:
    """``(out, sums)`` of ``steps`` steps of ``dot_general(a, b, dims)``
    (module docstring); CPU tensors take ``gemm_reference``, CUDA tensors
    launch ``probe_gemm``."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("the probes multiply int8 tensors")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError("the operands must lie on one CPU or CUDA device")
    if elem not in ELEMS:
        raise ValueError(f"unsupported element {elem!r}")
    m, n, k = gemm_shape(a.shape, b.shape, dims)
    code = DIMS[dims]
    _check_store(store, code, k, elem, out_rows, m)
    if steps < 1 or not 1 <= out_rows <= m:
        raise ValueError("steps must be positive and out_rows in [1, M]")
    if a.device.type == "cpu":
        return gemm_reference(a, b, dims, steps=steps, out_rows=out_rows,
                              elem=elem, store=store)
    mp, np_, kp, kb = gemm_padded(m, n, k, elem)
    # each operand zero-padded in its own layout, then packed along k for s4
    shapes = {0: ((mp, kp), (kp, np_)), 1: ((mp, kp), (np_, kp)),
              2: ((kp, mp), (kp, np_))}[code]
    ops = [F.pad(t, (0, c - t.shape[1], 0, r - t.shape[0])).contiguous()
           for t, (r, c) in zip((a, b), shapes)]
    if elem == "s4":
        kdims = {0: (1, 0), 1: (1, 1), 2: (0, 0)}[code]
        ops = [pack_s4(t, kd) for t, kd in zip(ops, kdims)]
    tile = gemm_tile(k, elem)
    bm, bn, _ = tile
    groups = step_groups(steps, (mp // bm) * (np_ // bn))
    dev = a.device
    out = torch.empty((out_rows, np_), device=dev)
    sums = torch.empty((groups, mp // bm, np_ // bn), dtype=torch.int32,
                       device=dev)
    ws = (torch.empty((steps, mp, np_), dtype=_STORE_DTYPES[store],
                      device=dev) if store else None)
    name = gemm_kernel_name(dims, elem, k, store)
    with torch.cuda.device(dev):
        _call(_lib(), "svt_probe_gemm", ops[0].data_ptr(), ops[1].data_ptr(),
              out.data_ptr(), sums.data_ptr(),
              None if ws is None else ws.data_ptr(), mp, np_, kb, code,
              int(elem == "s4"), int(tile == SMALL), STORES[store], steps,
              groups, out_rows, _stream(a))
    _count(name)
    return out[:, :n], sums


@torch.no_grad()
def build_t_reference(xT, foldT, pt: int) -> tuple:
    """Plain version of ``build_t``: every image's and pixel's column sum
    in the kernel's op order (no contraction: each op rounds)."""
    b, h, _ = foldT.shape
    hw = xT.shape[1]
    x0, x1 = xT[0], xT[1]
    col = torch.empty((b, hw), dtype=torch.int64, device=xT.device)
    chunk = max(1, 2 ** 25 // (h * hw))
    for b0 in range(0, b, chunk):
        f = foldT[b0:b0 + chunk]
        h0 = (f[:, :, 0:1] * x0 + f[:, :, 1:2] * x1) + f[:, :, 2:3]
        q = torch.round(torch.tanh(h0) * 127.0)
        col[b0:b0 + chunk] = q.to(torch.int32).sum(dim=1)
    out = col[-1, hw - pt:].reshape(1, pt).to(torch.int32)
    return out, _wrap32(col.reshape(b, hw // BUILD_PIX, BUILD_PIX).sum(-1))


def _check_build_t(xT, foldT, pt: int) -> None:
    if xT.dtype != torch.float32 or foldT.dtype != torch.float32:
        raise TypeError("build_t takes float32 tensors")
    if xT.dim() != 2 or xT.shape[0] < 2 or foldT.dim() != 3 \
            or foldT.shape[2] != 4 or foldT.shape[0] < 1:
        raise ValueError("build_t takes xT (rows >= 2, HW) and foldT "
                         "(B, H, 4)")
    hw = xT.shape[1]
    if hw % BUILD_PIX or not 1 <= pt <= hw or hw % pt:
        raise ValueError(f"HW must be a multiple of {BUILD_PIX} and of pt")
    if xT.device != foldT.device or xT.device.type not in ("cpu", "cuda"):
        raise ValueError("the inputs must lie on one CPU or CUDA device")


def build_t(xT, foldT, pt: int) -> tuple:
    """``(out (1, pt) int32, sums (B, HW / BUILD_PIX) int32)``: CPU tensors
    take ``build_t_reference``, CUDA tensors launch ``probe_build_t``."""
    _check_build_t(xT, foldT, pt)
    if xT.device.type == "cpu":
        return build_t_reference(xT, foldT, pt)
    b, h, _ = foldT.shape
    hw = xT.shape[1]
    xT, foldT = xT.contiguous(), foldT.contiguous()
    out = torch.empty((1, pt), dtype=torch.int32, device=xT.device)
    sums = torch.empty((b, hw // BUILD_PIX), dtype=torch.int32,
                       device=xT.device)
    with torch.cuda.device(xT.device):
        _call(_lib(), "svt_probe_build_t", xT.data_ptr(), foldT.data_ptr(),
              out.data_ptr(), sums.data_ptr(), b, hw, h, pt, _stream(xT))
    _count("probe_build_t")
    return out, sums


@torch.no_grad()
def transpose_sum_reference(a, steps: int) -> tuple:
    """Plain version of ``transpose_sum``: at every step the transpose and
    its row sums."""
    h = a.shape[1]
    hp = _up(h, TR_BH)
    groups = step_groups(steps, hp // TR_BH)
    sums = torch.zeros((groups, hp // TR_BH), dtype=torch.int64,
                       device=a.device)
    for g in _step_groups_of(steps, groups):
        row = a.t().to(torch.int64).sum(dim=1)
        sums[g] += F.pad(row, (0, hp - h)).reshape(-1, TR_BH).sum(-1)
    return row.reshape(1, h).to(torch.int32), _wrap32(sums)


def transpose_sum(a, steps: int) -> tuple:
    """``(out (1, H) int32, sums (groups, ceil(H / TR_BH)) int32)`` of
    ``steps`` steps; CPU tensors take ``transpose_sum_reference``, CUDA
    tensors launch ``probe_transpose_sum``."""
    if a.dtype != torch.int8 or a.dim() != 2:
        raise TypeError("transpose_sum takes an int8 matrix")
    if steps < 1 or a.device.type not in ("cpu", "cuda"):
        raise ValueError("steps must be positive, on a CPU or CUDA tensor")
    if a.device.type == "cpu":
        return transpose_sum_reference(a, steps)
    pt, h = a.shape
    ptp, hp = _up(pt, 4), _up(h, TR_BH)
    a = F.pad(a, (0, hp - h, 0, ptp - pt)).contiguous()
    groups = step_groups(steps, hp // TR_BH)
    out = torch.empty(hp, dtype=torch.int32, device=a.device)
    sums = torch.empty((groups, hp // TR_BH), dtype=torch.int32,
                       device=a.device)
    with torch.cuda.device(a.device):
        _call(_lib(), "svt_probe_transpose_sum", a.data_ptr(), out.data_ptr(),
              sums.data_ptr(), ptp, hp, steps, groups, _stream(a))
    _count("probe_transpose_sum")
    return out[:h].reshape(1, h), sums
