"""int8 linear layers with an int8 backward — counterpart of
``spatialvae_tpu/nn/qlinear.py``.

Per-tensor symmetric scales, s = max|x|/127 + 1e-30 and
q = clip(rint(x/s), -127, 127).  The products run as exact int8 x int8 ->
int32 GEMMs (``torch._int_mm``, the library GEMM: the JAX package leaves
these products to XLA's ``dot_general``, outside any Pallas kernel), scaled
in float32.  The backward quantises the incoming cotangent dynamically and
runs dW (and dx where the input needs it) on int8 too.

Weights are in ``nn.Linear``'s (out, in) layout, the int8 copies too, so
``y = x @ w^T + b``; the JAX functions take the transpose, and the integer
values are JAX's transposed.

- ``qlinear(x, w, b)``: both operands quantised per call;
- ``qlinear_pre(x, w, b, wq, sw, sx_static=None)``: the weight's int8 copy
  (wq, sw) comes from the Adam pass; ``w`` only receives dW.  With
  ``sx_static`` (a known bound on |x|, 1.0 for tanh outputs) the input is
  quantised with the static scale sx_static/127;
- ``qlinear_pre_xq(xq, sx, w, b, wq, sw)``: the input is int8 data
  quantised once per dataset; no input cotangent.

``torch._int_mm`` on the card needs more than 16 rows and inner and outer
sizes that are multiples of 8, and cuBLASLt runs it in one operand layout
only, a row-major left operand times the transpose of a row-major right
one (on the H100 it refused (5000, 104) x (104, 5000) with both operands
row-major, and a column-major left operand of 37 rows).  ``int_mm`` pads
every size to a multiple of 8 and the rows to at least 24 with zeros
(exact in int32) and lays both operands out so, on every device, so the
CPU runs the same shapes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def quantize_sym(x: torch.Tensor):
    """JAX ``_q``: (q int8, s float32 0-d), the max taken in x's dtype.  The
    division is by a tensor, as XLA divides (PyTorch's CUDA division by a
    Python number multiplies by its reciprocal)."""
    s = x.abs().amax().float() / _scalar(127.0, x) + 1e-30
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def quantize_static(x: torch.Tensor, sx_static: float):
    """JAX ``_qx`` with a static bound: q = clip(rint(x * 127/bound)),
    s = float32(bound/127)."""
    inv = 127.0 / sx_static
    q = torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)
    return q, _scalar(sx_static / 127.0, x)


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """t zero-padded to (rows, cols), row-major (a copy only when t is not
    already so)."""
    r, c = t.shape
    if (r, c) != (rows, cols):
        t = F.pad(t, (0, cols - c, 0, rows - r))
    return t.contiguous()


# below this K an N of 8 mod 16 is padded even where b needs no copy
# (cuBLASLt's refusals lie below it; see ``int_mm``)
N16_BELOW_K = 512


def padded_sizes(m: int, k: int, n: int, b_copied: bool) -> tuple:
    """(M, K, N) of the GEMM ``int_mm`` runs for an (m, k) x (k, n)
    product: each a multiple of 8, M at least 24, and N a multiple of 16
    wherever b is copied anyway (``b_copied``: b is not the transpose of a
    row-major (n, k), or K or N is padded) or K is below N16_BELOW_K."""
    mp, kp, np_ = max(24, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    if np_ % 16 and (b_copied or (kp, np_) != (k, n) or kp < N16_BELOW_K):
        np_ += 8
    return mp, kp, np_


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x (K, N) -> int32 (M, N).  Zero rows and columns
    pad M, K and N to multiples of 8, and M to at least 24, where they fall
    short, and the call always takes the one operand layout the card's
    int8 GEMM runs: a row-major and b the transpose of a row-major (N, K)
    (a free view for ``w.t()`` of a contiguous weight, a copy otherwise).

    cuBLASLt on an H100 refuses (``CUBLAS_STATUS_NOT_SUPPORTED``) some
    GEMMs whose N is 8 mod 16: against a K that is a multiple of 16 below
    128 from N = 2,504 and M = 1,600 up (the encoder's dW at a batch of 64,
    where K is the batch; ``tests/test_torch_port_cuda.py``'s
    ``test_int_mm_refusals_are_padded`` maps them).  N is padded to a
    multiple of 16 wherever b is copied anyway, as in every dW and dx, and
    for a weight's free view below N16_BELOW_K (``padded_sizes``)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = padded_sizes(m, k, n, not b.t().is_contiguous())
    out = torch._int_mm(_padded(a, mp, kp), _padded(b.t(), np_, kp).t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """JAX ``_dot8``: the int32 product converted to float32."""
    return int_mm(a, b).float()


def _backward(g, xq, sx, wq, sw, need_dx: bool, x_dtype, w_dtype):
    """(dx or None, dW (out, in), db) in JAX's ``_bwd`` arithmetic."""
    gq, sg = quantize_sym(g)
    dx = (dot8(gq, wq) * (sg * sw)).to(x_dtype) if need_dx else None
    dw = (dot8(gq.t(), xq) * (sx * sg)).to(w_dtype)
    db = g.float().sum(dim=0).to(w_dtype)
    return dx, dw, db


class _QLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq, sx = quantize_sym(x)
        wq, sw = quantize_sym(w)
        out = dot8(xq, wq.t()) * (sx * sw)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.dtypes = (x.dtype, w.dtype)
        return (out + b).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        dx, dw, db = _backward(g, xq, sx, wq, sw, ctx.needs_input_grad[0],
                               *ctx.dtypes)
        return dx, dw, db


class _QLinearPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, wq, sw, sx_static):
        if sx_static is None:
            xq, sx = quantize_sym(x)
        else:
            xq, sx = quantize_static(x, sx_static)
        sw0 = sw.reshape(())
        out = dot8(xq, wq.t()) * (sx * sw0)
        ctx.save_for_backward(xq, sx, wq, sw0)
        ctx.dtypes = (x.dtype, w.dtype)
        return (out + b).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        dx, dw, db = _backward(g, xq, sx, wq, sw, ctx.needs_input_grad[0],
                               *ctx.dtypes)
        return dx, dw, db, None, None, None


class _QLinearPreXq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xq, sx, w, b, wq, sw):
        sx0 = sx.reshape(())
        out = dot8(xq, wq.t()) * (sx0 * sw.reshape(()))
        ctx.save_for_backward(xq, sx0)
        ctx.w_dtype = w.dtype
        return (out + b).to(b.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx = ctx.saved_tensors
        gq, sg = quantize_sym(g)
        dw = (dot8(gq.t(), xq) * (sx * sg)).to(ctx.w_dtype)
        db = g.float().sum(dim=0).to(ctx.w_dtype)
        return None, None, dw, db, None, None


def qlinear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """x (B, in) @ w^T + b on int8, w (out, in); the result in x's dtype."""
    return _QLinear.apply(x, w, b)


def qlinear_pre(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                wq: torch.Tensor, sw: torch.Tensor,
                sx_static: Optional[float] = None) -> torch.Tensor:
    """x @ w^T + b on int8 with the prequantised weight (wq (out, in) int8,
    sw one float32); ``w`` receives dW.  ``sx_static``: a bound on |x|
    that replaces the dynamic input scale."""
    return _QLinearPre.apply(x, w, b, wq, sw, sx_static)


def qlinear_pre_xq(xq: torch.Tensor, sx: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, wq: torch.Tensor,
                   sw: torch.Tensor) -> torch.Tensor:
    """(xq*sx) @ w^T + b on int8, both operands prequantised (xq (B, in)
    int8 data, sx and sw one float32 each); the result in b's dtype; ``w``
    receives dW, the data no cotangent."""
    return _QLinearPreXq.apply(xq, sx, w, b, wq, sw)
