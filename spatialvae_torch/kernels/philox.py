"""Philox4x32-10 and stochastic rounding, in plain PyTorch.

The fused int8 loss kernel (K3) rounds stochastically when
``SPATIALVAE_SR=1``: q -> floor(q + u) with u uniform on [0, 1), which is
unbiased (E[floor(q + u)] = q).  The JAX package draws u on the TPU with
its hardware generator (``pltpu.prng_random_bits``), which has no
counterpart off the TPU: its interpret mode rounds to nearest instead, so
the JAX package cannot run SR off the TPU at all.  The port draws every word
from Philox4x32-10 (Salmon et al., SC'11), counter-based: a word is a pure
function of (key, counter), so the CUDA kernels (``csrc/int8_tile.cuh``)
and this plain version draw the same words wherever they run, in any order.

A draw of the loss kernel is keyed by (the float32 bits of ``b1[0]`` as the
kernel receives it, the site), as the JAX kernel seeds from ``b1``'s bits:
the pattern changes every training step and a rerun of one step is
bit-identical.  Its counter is (image, decoder row in the kernel's coords
order, column // 4, 0): one call serves four columns.  The two quantisation
sites, the forward's a0 and the gradient's dh1, use different site words,
so their rounding errors are independent (JAX's ``rbits``/``rbits_g``).

``sr_round`` is the JAX ``_sr_int`` exactly: u is the float32 whose bits
are ``(word & 0x7FFFFF) | 0x3F800000``, minus 1; x + u is rounded once in
float32, then floored and clipped.

Words are uint32 values held in int64 tensors (PyTorch has no uint32
arithmetic on every device).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # the round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # the key schedule's increments
ROUNDS = 10

# the loss kernel's site words (key[1]); csrc/int8_tile.cuh has the same
SITE_FWD = 0x51A7E001
SITE_GRAD = 0x51A7E002


def _mulhilo(m: int, x: torch.Tensor) -> tuple:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, x < 2**32, in
    int64 without overflow: x is split into 16-bit halves."""
    xh, xl = x >> 16, x & 0xFFFF
    t1, t2 = m * xl, m * xh                    # each < 2**48
    low = t1 + ((t2 & 0xFFFF) << 16)           # < 2**49
    return (t2 >> 16) + (low >> 32), low & MASK32


def philox4x32_10(ctr: tuple, key: tuple) -> tuple:
    """Philox4x32-10 of counters (c0, c1, c2, c3) under keys (k0, k1): each
    an int64 tensor (or int) of uint32 values, broadcast together.  Returns
    the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def f32_bits(x: torch.Tensor) -> int:
    """The float32 bits of a one-element tensor, as an unsigned int."""
    return int(x.detach().reshape(1).float().cpu().view(torch.int32)) & MASK32


def site_words(seed_bits: int, site: int, b: int, rows: int, cols: int,
               device=None, image0: int = 0, p_base: int = 0) -> torch.Tensor:
    """The (b, rows, cols) words of one site of the loss kernel: element
    (i, p, k) is word k % 4 of Philox4x32-10 at counter (image0 + i, p_base
    + p, k // 4, 0) under key (seed_bits, site): the call's images image0
    .. and pixels p_base .. (a pixel shard's slice of a larger call)."""
    i = torch.arange(image0, image0 + b, dtype=torch.int64,
                     device=device)[:, None, None]
    p = torch.arange(p_base, p_base + rows, dtype=torch.int64,
                     device=device)[None, :, None]
    q = torch.arange(-(-cols // 4), dtype=torch.int64,
                     device=device)[None, None, :]
    words = philox4x32_10((i, p, q, 0), (seed_bits, site))
    out = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return out.reshape(b, rows, -1)[..., :cols]


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """u in [0, 1): the float32 with bits (bits & 0x7FFFFF) | 0x3F800000,
    minus 1 (exact)."""
    m = ((bits & 0x7FFFFF) | 0x3F800000).to(torch.int32)
    return m.view(torch.float32) - 1.0


def sr_round(x: torch.Tensor, bits: torch.Tensor, lo: float,
             hi: float) -> torch.Tensor:
    """The JAX ``_sr_int``: clip(floor(x + u), lo, hi), x float32, x + u
    rounded once in float32; returned as float32 integers."""
    return torch.clamp(torch.floor(x.float() + uniform(bits)), lo, hi)
