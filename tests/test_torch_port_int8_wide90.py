"""K4 and K5's cluster passes past H = 512
(``csrc/fused_decoder_int8_sm90_wide.cu``) on the CPU: what surrounds the
kernels, which only the card runs.

- the route table sends every width past 512 over pixel counts that are
  multiples of 256 to the cluster passes, K4 without a1 on f32 weights
  too (measured faster there), and the other pixel counts to the block
  passes;
- W1q^T's and W1q's chunked slab streams (``Int8Weights.slabs90w_t`` and
  ``slabs90w``: ``fused_loss_int8.sm90_slabs``) round-trip to the padded
  matrices, element (n, k) where wgmma's 64-byte swizzled layout puts it,
  chunk by chunk of 512 output rows, at H = 520, 1,000 and 1,030;
- the R-row dW1 workspaces (R = ``cluster_rows(H)``), the f32 a1 stash of
  R columns a pixel, and a CTA's slot (a0q, or the K-major dh1q copy, in
  the pieces' layout) round-trip, and the workspace chunks hold them;
- a host emulation of the passes (``_wide_forward``, ``_wide_backward``:
  the products chunk by chunk through the decoded slab streams, a0q built
  once into the slot and read back a piece a slab, the head's partials
  added in chunk order, the scale pass over the stash or the residual,
  the K-major dh1q copy written chunk by chunk and read back a piece a
  slab, dh0 from the f32 a0, dW1 through the R-row workspaces and the dW1
  kernel's plain version) matches the JAX ``_fwd_pallas`` and
  ``_bwd_pallas`` in interpret mode at H = 520 and 1,030, f32 and bf16
  weights, residual and recompute, No 1, 2 and 3: y and a1 within K4's
  limits, K5's outputs within its (2e-3, 5e-5).

The kernels themselves are held to the plain versions and to the block
passes on the card by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialvae_tpu.kernels import fused_decoder_int8 as jd8

from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels.fused_decoder import _first_layer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread  # noqa: F401

CW = d8.CLUSTER_WIDTH
PT = d8.BLOCK_PIXELS
PIECE = PT * d8.SLAB_K                   # a slab's K-range of an A operand
K4_Y_TOL = (1e-3, 1e-6)                  # absolute: max, mean
K4_A1_TOL = (1e-2, 1e-5)
K5_TOL = (2e-3, 5e-5)                    # relative to max|JAX|: max, mean
GRADS = ("dfold", "dw1", "db1", "dwht", "dbht")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def offset_sw64(r, k):
    """csrc/sm90.cuh ``offset_sw64``: byte of (row r, k < 64) in a swizzled
    K-major operand of 64-byte rows."""
    return r * 64 + ((((k >> 4) ^ (r >> 1)) & 3) << 4) + (k & 15)


def piece_offset(p, k):
    """Byte of a0q or dh1q (pixel p, column k) in a CTA's slot: piece k //
    64, 4 KiB each (``a0q_piece``'s copy, the K-major dh1q copy)."""
    return (k // 64) * PIECE + offset_sw64(p, k % 64)


def tile_offset(p, k):
    """Byte of (pixel p, chunk column k < 512) in a chunk's dh1q tile
    (the header's ``tile_off``)."""
    return (k // 64) * (PT * 64) + offset_sw64(p, k % 64)


def _unslab(stream, rows, kp):
    """``sm90_slabs``' inverse: the (R, Kp) matrix a slab stream holds."""
    t = stream.reshape(rows // CW, kp // l8.SLAB_K, CW, 4, 16)
    return fd._swizzle64(t).transpose(1, 2).reshape(rows, kp)


# (H, HW, the passes the caller names, K4 without a1 on f32 weights, route)
ROUTES = [(513, 4096, None, False, "sm90"), (1000, 4096, None, False, "sm90"),
          (1030, 1024, None, False, "sm90"), (4100, 256, None, False, "sm90"),
          (2048, 1792, None, False, "sm90"), (1000, 1280, None, False, "sm90"),
          (1000, 4096, "block", False, "block"),
          (1000, 4096, None, True, "sm90"), (513, 1024, None, True, "sm90"),
          (1000, 4096, "sm90", True, "sm90"),
          (1000, 784, None, False, "block"), (1000, 4160, None, False, "block")]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: f"H{c[0]}-HW{c[1]}-"
                         f"{c[2] or 'table'}-{'f32-alone' if c[3] else 'call'}"
                         f"-{c[4]}")
def test_route_table_past_512(case):
    h, hw, passes, alone, want = case
    assert d8.int8_route(hw, h, passes, k4_alone_f32=alone) == want
    if want == "sm90":
        pt = d8.pick_tile(hw)
        assert pt % (d8.CLUSTER * PT) == 0 and hw % pt == 0


# two chunks, the second ragged (520: one slab of its 512 rows used), two
# whole (1,000), three (1,030)
@pytest.mark.parametrize("h", [520, 1000, 1030])
def test_wide_slab_streams_round_trip(h):
    g = torch.Generator().manual_seed(h)
    w = d8.Int8Weights(torch.randn((h, h), generator=g) / h ** 0.5,
                       torch.zeros(h), torch.zeros((2, h)), torch.zeros(2))
    kp, rows = d8.padded_hidden(h), l8.cluster_rows(h)
    assert rows == CW * -(-kp // CW)
    for stream, mat in ((w.slabs90w_t(), w.w1q.T), (w.slabs90w(), w.w1q)):
        assert stream.dtype == torch.int8 and stream.numel() == rows * kp
        full = torch.zeros((rows, kp), dtype=torch.int8)
        full[:kp] = d8.pad_square(mat)
        idx = torch.arange(full.numel())
        n, k = idx // kp, idx % kp
        c, r = n // CW, n % CW
        off = (c * CW * kp + (k // l8.SLAB_K) * l8.SLAB_K * CW + r * 64
               + (((k % l8.SLAB_K) // 16) ^ ((r >> 1) & 3)) * 16 + k % 16)
        assert torch.equal(stream[off], full.reshape(-1))
        assert torch.equal(_unslab(stream, rows, kp), full)


@pytest.mark.parametrize("h", [520, 1000, 1030])
def test_wide_workspaces_round_trip(h):
    """The dW1 operands' R-row blocks (``sm90_ws_layout``), the stash's
    (tile, pixel, column) at (tile * 64 + pixel) * R + column, and a
    slot's pieces: every element once, the chunk tiles' K-major copy at the
    slot's pieces; ``workspace90_bytes`` counts them."""
    gen = torch.Generator().manual_seed(h)
    hw, b = 512, 2
    kp, rows = d8.padded_hidden(h), l8.cluster_rows(h)
    tiles = torch.randint(-127, 128, (b, hw, rows), generator=gen,
                          dtype=torch.int8)
    ws = l8.sm90_ws_layout(tiles)
    assert ws.numel() == b * hw * rows
    assert torch.equal(l8.sm90_ws_tiles(ws, b, hw), tiles)
    # the stash: tile tb = image * blocks + block of the launch
    tb, p, n = torch.meshgrid(torch.arange(b * hw // PT), torch.arange(PT),
                              torch.arange(rows), indexing="ij")
    at = ((tb * PT + p) * rows + n).reshape(-1)
    assert torch.equal(at.sort().values, torch.arange(b * hw * rows))
    assert d8.workspace90_bytes(hw, False, h) == 2 * rows * hw
    assert d8.workspace90_bytes(hw, True, h) == 6 * rows * hw
    # the K-major copy: chunk c's tile, its pieces below Kp, at byte c * 32
    # KiB of the slot, is piece s = 8 c + j at byte s * 4 KiB
    pp, kk = torch.meshgrid(torch.arange(PT), torch.arange(kp),
                            indexing="ij")
    via_tiles = ((kk // CW) * PT * CW + tile_offset(pp, kk % CW)).reshape(-1)
    direct = piece_offset(pp, kk).reshape(-1)
    assert torch.equal(via_tiles, direct)
    assert torch.equal(direct.sort().values, torch.arange(PT * kp))


def _forward_chain(fold, coords, w1q, sw, b1):
    """(a0 f32, a0q) as the passes build them: exact tanh, round(127 a0)."""
    a0 = torch.tanh(_first_layer(fold, coords))
    return a0, torch.clamp(torch.round(a0 * 127.0), -127, 127)


def _slot_pieces(a0q_block, kp):
    """A block's (64, Kp) a0q into a CTA's slot by ``piece_offset`` (the
    first chunk's copy), and read back a piece a slab: the (64, Kp) operand
    the later chunks multiply."""
    slot = torch.zeros(PT * kp, dtype=torch.int8)
    pp, kk = torch.meshgrid(torch.arange(PT), torch.arange(kp),
                            indexing="ij")
    slot[piece_offset(pp, kk).reshape(-1)] = a0q_block.reshape(-1).to(
        torch.int8)
    return slot[piece_offset(pp, kk)].double()


def _wide_forward(fold, coords, w: d8.Int8Weights, emit: bool):
    """K4 as the wide passes schedule it, on the host: per 64-pixel block
    a0q built once and read back from the slot for the later chunks; per
    512-column chunk the exact product through W1q^T's decoded slab stream,
    h1, a1 and the head's partial, added in chunk order.  Returns y and,
    with ``emit``, a1 in bf16; and the f32 a1 (the recompute stash)."""
    b, _, h = fold.shape
    hw, no = coords.shape[0], w.wht.shape[0]
    kp, rows = d8.padded_hidden(h), l8.cluster_rows(h)
    wt = _unslab(w.slabs90w_t(), rows, kp).double()
    _, a0q = _forward_chain(fold, coords, w.w1q, w.sw, w.b1)
    a0q = torch.nn.functional.pad(a0q, (0, kp - h))
    scale = w.sw.float() * (1.0 / 127.0)
    b1p = torch.nn.functional.pad(w.b1.float(), (0, rows - h))
    whp = torch.nn.functional.pad(w.wht.float(), (0, rows - h))
    z = torch.zeros((b, no, hw))
    stash = torch.zeros((b, hw, rows))
    for img in range(b):
        for p0 in range(0, hw, PT):
            blk = a0q[img, p0:p0 + PT]
            for c in range(rows // CW):
                cols = slice(c * CW, (c + 1) * CW)
                a = blk.double() if c == 0 else _slot_pieces(blk, kp)
                acc = (a @ wt[cols].T).float()
                a1 = torch.tanh(acc * scale + b1p[cols])
                a1[:, max(0, h - c * CW):] = 0.0
                stash[img, p0:p0 + PT, cols] = a1
                zc = (a1.to(w.wht.dtype).float() @ whp[:, cols].T).T
                z[img, :, p0:p0 + PT] += zc
    y = torch.sigmoid(z + w.bht.float()[:, None])
    a1 = stash[..., :h]
    return y, (a1.to(torch.bfloat16) if emit else None), stash


def _wide_backward(fold, coords, w: d8.Int8Weights, a1, stash, y, g):
    """K5 as the wide passes schedule it, on the host: the scale pass (each
    block's max |dh1| over every chunk, from the residual a1 or the
    stash), the group's scale; per chunk dh1, dh1q, db1 and dWh^T, the
    chunk's dh1q tile to the dW1 workspace and to the K-major copy; da0 per
    output chunk through W1q's decoded slab stream from the copy, read
    back a piece a slab; dh0 = da0 sg sw (1 - a0^2) with the f32 a0, the
    dfold partials; dW1 from the R-row workspaces through the dW1 kernel's
    plain version."""
    wdt = w.wht.dtype
    b, _, h = fold.shape
    hw, no = coords.shape[0], w.wht.shape[0]
    pt = d8.pick_tile(hw)
    t_ = hw // pt
    kp, rows = d8.padded_hidden(h), l8.cluster_rows(h)
    wr = _unslab(w.slabs90w(), rows, kp).double()
    whp = torch.nn.functional.pad(w.wht.float(), (0, rows - h))
    a1f = (torch.nn.functional.pad(a1.float(), (0, rows - h))
           if a1 is not None else stash)
    s = y.float()
    dz2 = g.float() * s * (1.0 - s)
    dz2c = dz2.to(wdt).float()
    dh1 = torch.einsum("bop,oh->bph", dz2c, whp) * (1.0 - a1f * a1f)
    dh1[..., h:] = 0.0
    bmax = dh1.abs().reshape(b, hw // PT, -1).amax(dim=2)
    sg = bmax.reshape(b, t_, -1).amax(dim=2) * (1.0 / 127.0) + 1e-30
    sgp = sg.repeat_interleave(pt, dim=1)[..., None]
    q_all = torch.zeros((b, hw, rows))
    db1, dwht = torch.zeros(rows), torch.zeros((no, rows))
    slots = torch.zeros((b, hw // PT, PT * kp), dtype=torch.int8)
    pp, kk = torch.meshgrid(torch.arange(PT), torch.arange(CW),
                            indexing="ij")
    for c in range(rows // CW):
        cols = slice(c * CW, (c + 1) * CW)
        q = torch.clamp(torch.round(dh1[..., cols] / sgp), -127, 127)
        q_all[..., cols] = q
        db1[cols] = dh1[..., cols].sum(dim=(0, 1))
        dwht[:, cols] = torch.einsum("bop,bph->oh", dz2c,
                                     a1f[..., cols].to(wdt).float())
        # the chunk's tile (its pieces below Kp) to the K-major copy
        live = (kk + c * CW) < kp
        at = (c * PT * CW + tile_offset(pp, kk))[live]
        for img in range(b):
            for blk in range(hw // PT):
                tile = q[img, blk * PT:(blk + 1) * PT].to(torch.int8)
                slots[img, blk, at] = tile[live]
    q_ws = l8.sm90_ws_layout(q_all.to(torch.int8))
    a0, a0q = _forward_chain(fold, coords, w.w1q, w.sw, w.b1)
    aq_ws = l8.sm90_ws_layout(torch.nn.functional.pad(
        a0q, (0, rows - h)).to(torch.int8))
    pq, kq = torch.meshgrid(torch.arange(PT), torch.arange(kp),
                            indexing="ij")
    qk = slots[..., piece_offset(pq, kq)].reshape(b, hw, kp).double()
    a0p = torch.nn.functional.pad(a0, (0, rows - h))
    x0 = coords[:, 0].float()[None, :, None]
    x1 = coords[:, 1].float()[None, :, None]
    dfold = torch.zeros((b, 4, rows))
    for c in range(rows // CW):
        cols = slice(c * CW, (c + 1) * CW)
        da0 = (qk @ wr[cols].T).float() * (sgp * w.sw.float())
        dh0 = da0 * (1.0 - a0p[..., cols] * a0p[..., cols])
        dfold[:, 0, cols] = (x0 * dh0).sum(1)
        dfold[:, 1, cols] = (x1 * dh0).sum(1)
        dfold[:, 2, cols] = dh0.sum(1)
    dw1 = l8.grouped_dw90_reference(aq_ws, q_ws, (sg / 127.0).reshape(-1),
                                    b, hw, h, pt,
                                    l8.dw_splits90(b * t_)).sum(0)
    return (dfold[..., :h].contiguous(), dw1, db1[:h], dwht[:, :h],
            dz2.sum(dim=(0, 2)))


# (H, weight dtype, No): two chunks (520: the second one slab of 64
# columns) and three (1,030), the galaxy's, the colored likelihood's and
# the Gaussian's head widths
WIDE_TAIL_CASES = [(h, wdt, no) for h in (520, 1030)
                   for wdt in (torch.float32, torch.bfloat16)
                   for no in (1, 2, 3)]


@pytest.mark.parametrize("case", WIDE_TAIL_CASES, ids=lambda c: "-".join(
    [f"H{c[0]}", str(c[1])[6:], f"No{c[2]}"]))
def test_wide_passes_match_jax(case):
    """The host emulation of the wide K4 and K5 (both variants) against
    ``_fwd_pallas``/``_bwd_pallas`` in interpret mode at 16x16 (one group
    of four blocks), two images; the route takes the cluster passes."""
    h, wdt, no = case
    rng = np.random.default_rng(h + no)
    b, hw = 2, 256
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bd = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bd, bd, s).astype(np.float32)).to(
        wdt).float().numpy() for s in ((h, h), (h,), (no, h), (no,))]
    coords = coord_grid(16, 16).numpy()
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    assert d8.int8_route(hw, h) == "sm90"
    jw = [jnp.asarray(x, jnp.bfloat16 if wdt == torch.bfloat16
                      else jnp.float32) for x in ws]
    w1q, sw = jd8._quant_sym(jw[0])
    jy, ja1 = jd8._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q,
                              sw, jw[1][None, :], jw[2], jw[3][:, None],
                              emit_acts=True)
    w = d8.Int8Weights(*[torch.from_numpy(x).to(wdt) for x in ws])
    tf, tc = torch.from_numpy(fold), torch.from_numpy(coords)
    y, a1, stash = _wide_forward(tf, tc, w, emit=True)
    for got, ref, tol in ((y, jy, K4_Y_TOL), (a1.float(), ja1, K4_A1_TOL)):
        d = np.abs(got.numpy() - np.asarray(ref, np.float32))
        assert d.max() <= tol[0] and d.mean() <= tol[1], (d.max(), d.mean())
    ty = torch.from_numpy(np.array(jy))
    ta1 = torch.from_numpy(np.array(ja1.astype(jnp.float32))).bfloat16()
    for saved in (True, False):
        want = jd8._bwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q,
                               sw, jw[1][None, :], jw[2],
                               ja1 if saved else None, jy, jnp.asarray(g))
        got = _wide_backward(tf, tc, w, ta1 if saved else None, stash, ty,
                             torch.from_numpy(g))
        for name, a, ref in zip(GRADS, got, want):
            r = np.asarray(ref, np.float32).reshape(a.shape)
            d = np.abs(a.numpy() - r)
            scale = float(np.abs(r).max()) or 1.0
            assert d.max() / scale <= K5_TOL[0], (saved, name,
                                                 d.max() / scale)
            assert d.mean() / scale <= K5_TOL[1], (saved, name,
                                                  d.mean() / scale)
