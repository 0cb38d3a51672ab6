"""K3's cluster passes (``csrc/fused_loss_int8_sm90.cu``) on the CPU: what
surrounds the kernels, which only the card runs.

- the walk of the clusters: every (image, 64-pixel block) exactly once, the
  four blocks of a cluster's step consecutive and in one quantisation group,
  the grid a multiple of the cluster at 64x64, 65x65 and 28x28 padded; the
  colored forward's walk pairs each mean block with its log-variance
  partner (the JAX ``_colored_coords``) in one cluster and group;
- the W1 slab stream round-trips to ``pad_square(w1f.T)`` and
  ``pad_square(w1r)``, element (n, k) where wgmma's 64-byte swizzled layout
  puts it, chunk by chunk of 512 output rows past H = 512;
- the dW1 workspace layout is a permutation of each block's pixels: it
  round-trips, at 512 rows and at the wide passes' whole chunks of rows, and
  dW1 from it (the dW1 kernel's plain version, split by split) is the plain
  version's, and within K3's limits of the JAX kernel's (interpret mode)
  when it replaces the plain version's product, below and past H = 512;
- a host emulation of the wide cluster passes' schedule (the products in
  512-column chunks through the slab streams, the head's partials carried
  in chunk order, the a1c stash per chunk, aq read back from the dW1
  workspace the forward leaves it in, qi's K-major copy, dW1 through the
  R-row workspaces) matches the JAX kernel in interpret mode at H = 520 and
  1,030 in three families, f32 and bf16 weights, within the wide widths'
  limits of ``test_torch_port_wide.py``;
- the route table sends each numerics setting, family, width and pixel
  count to the passes ``k3_route`` names (the wrapper passes that route to
  both C entry points, which refuse the cluster route for a call the
  cluster passes do not take);
- the workspace chunks of the bench step (B=4,096 at 64x64, H=500, the dW1
  operands and the a1c stash) fit the workspace budget of an 80 GB card:
  four chunks, under stochastic rounding too;
- stochastic rounding's counters on the cluster passes (``sr90_counters``,
  the kernels' index arithmetic): every (image, row, column) of both sites
  rounded exactly once, with the word of ``philox.site_words`` at it, in
  the galaxy, padded 28x28 and colored walks, in a chunk of the call and
  not; a mirror of the faulty copy that takes the row from the dW1
  workspace's order fails the same check.

The kernels themselves are held to the plain version on the card by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spatialvae_tpu.kernels import fused_loss_int8 as jl8

from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels.fused_decoder import _first_layer
from spatialvae_torch.kernels.config import Numerics
from spatialvae_torch.kernels.fused_decoder_int8 import (
    grouped_int_product,
    image_chunks,
    pad_square,
)
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread  # noqa: F401
from tests.test_torch_port_wide import LOSS_TOL, loss_inputs


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _grid(side):
    """(pixels as the kernels take them, pixels per group) of a side x side
    image: padded to ``padded_hw`` off the tiling."""
    hw = l8.padded_hw(side * side)
    return hw, l8.pick_tile(hw)


# (image side, images, resident clusters): the galaxy grid, the padded
# Gaussian and Bernoulli grids, more clusters than quads
@pytest.mark.parametrize("side,b,clusters", [(64, 3, 33), (64, 2, 7),
                                             (65, 2, 5), (28, 5, 3),
                                             (28, 1, 1000)])
def test_cluster_walk_covers_every_block_once(side, b, clusters):
    hw, pt = _grid(side)
    blocks = hw // l8.BLOCK_PIXELS
    assert (b * blocks) % l8.CLUSTER == 0
    walk = l8.cluster_schedule(b * blocks, clusters)
    assert len(walk) % l8.CLUSTER == 0
    assert sorted(x for cta in walk for x in cta) == list(range(b * blocks))
    bpg = pt // l8.BLOCK_PIXELS
    for c in range(0, len(walk), l8.CLUSTER):
        ctas = walk[c:c + l8.CLUSTER]
        assert len({len(cta) for cta in ctas}) == 1      # in lockstep
        for step in zip(*ctas):
            assert list(step) == list(range(step[0], step[0] + l8.CLUSTER))
            # one image, one quantisation group
            assert len({(x // blocks, (x % blocks) // bpg)
                        for x in step}) == 1


# (pixels, images, resident clusters): groups of 1,024 (the partner 8
# blocks away), of 256 (2 blocks) and two groups of 1,024 an image
@pytest.mark.parametrize("hw,b,clusters", [(4096, 2, 33), (4096, 3, 5),
                                           (1280, 2, 7), (1280, 5, 1000),
                                           (2048, 1, 3), (2048, 4, 2)])
def test_colored_walk_pairs_partners_in_one_cluster(hw, b, clusters):
    """The colored forward's walk (``colored_block``): every block exactly
    once; in each quad rank r's partner r ^ 2 runs the block whose rows
    hold, by the JAX ``_colored_coords``, the log-variance rows of r's mean
    rows (original row + HW/2); the four blocks in one image and group."""
    pt = l8.pick_tile(hw)
    blocks = hw // l8.BLOCK_PIXELS
    walk = l8.cluster_schedule(b * blocks, clusters, colored_pt=pt)
    assert sorted(x for cta in walk for x in cta) == list(range(b * blocks))
    # the original decoder row that each permuted row holds
    rows = np.arange(hw, dtype=np.float32)
    orig = np.asarray(jl8._colored_coords(
        jnp.asarray(np.stack([rows, rows], axis=1)), pt))[:, 0].astype(int)
    bpg = pt // l8.BLOCK_PIXELS
    px = np.arange(l8.BLOCK_PIXELS)
    for c in range(0, len(walk), l8.CLUSTER):
        ctas = walk[c:c + l8.CLUSTER]
        assert len({len(cta) for cta in ctas}) == 1      # in lockstep
        for step in zip(*ctas):
            assert len({(x // blocks, (x % blocks) // bpg)
                        for x in step}) == 1
            for r in (0, 1):
                mean, part = step[r], step[r ^ 2]
                m_rows = orig[(mean % blocks) * l8.BLOCK_PIXELS + px]
                p_rows = orig[(part % blocks) * l8.BLOCK_PIXELS + px]
                assert (m_rows < hw // 2).all()
                assert (p_rows == m_rows + hw // 2).all()


@pytest.mark.parametrize("side", [64, 65, 28])
def test_grid_is_a_multiple_of_the_cluster(side):
    hw, pt = _grid(side)
    quad = l8.CLUSTER * l8.BLOCK_PIXELS
    assert hw % quad == 0 and pt % quad == 0
    assert l8.k3_route(hw, 500, pt, "bernoulli", Numerics()) == "sm90"


# narrow widths (one chunk), and past 512: two chunks, the last ragged at
# 520 (one slab of its 512 rows used), whole at 1,000, and three at 1,030
@pytest.mark.parametrize("h", [500, 130, 40, 520, 1000, 1030])
def test_slab_stream_round_trips(h):
    g = torch.Generator().manual_seed(h)
    w1 = torch.randn((h, h), generator=g) / h ** 0.5
    wht = torch.randn((3, h), generator=g)
    w1f, _, _, w1r, _ = l8.loss_operands(w1, wht, Numerics())
    kp, rows = l8.padded_hidden(h), l8.cluster_rows(h)
    assert rows % l8.CLUSTER_WIDTH == 0 and kp <= rows < kp + 512
    assert rows == l8.CLUSTER_WIDTH * (1 if h <= 512 else -(-kp // 512))
    for w in (w1f.T.contiguous(), w1r):
        stream = l8.sm90_slabs(w)
        assert stream.dtype == torch.int8
        assert stream.numel() == rows * kp
        full = torch.zeros((rows, kp), dtype=torch.int8)
        full[:kp] = pad_square(w)
        # element (n, k) of pad_square(w) (zero past Kp rows): chunk n //
        # 512 (the output columns' chunks, in order), slab k // 64 of it,
        # row n % 512 of 64 bytes, its 16-byte chunks swizzled by
        # (n >> 1) & 3 (csrc/sm90.cuh offset_sw64)
        idx = torch.arange(full.numel())
        n, k = idx // kp, idx % kp
        c, r = n // l8.CLUSTER_WIDTH, n % l8.CLUSTER_WIDTH
        off = (c * l8.CLUSTER_WIDTH * kp
               + (k // l8.SLAB_K) * l8.SLAB_K * l8.CLUSTER_WIDTH + r * 64
               + (((k % l8.SLAB_K) // 16) ^ ((r >> 1) & 3)) * 16 + k % 16)
        assert torch.equal(stream[off], full.reshape(-1))


def test_workspace_layout_permutes_pixels_within_blocks():
    g = torch.Generator().manual_seed(3)
    hw = 1024
    tiles = torch.randint(-7, 8, (2, hw, l8.CLUSTER_WIDTH), generator=g,
                          dtype=torch.int8)
    ws = l8.sm90_ws_layout(tiles)
    assert torch.equal(l8.sm90_ws_tiles(ws, 2, hw), tiles)
    blk = l8.CLUSTER_WIDTH * l8.BLOCK_PIXELS
    # row n, pixel p = 16 w + g + 8 h of block 5 of image 1
    base = (hw // l8.BLOCK_PIXELS + 5) * blk
    for n, w, gg, h in ((0, 0, 0, 0), (511, 3, 7, 1), (77, 2, 5, 0)):
        p = 16 * w + gg + 8 * h
        assert ws[base + n * 64 + (w ^ ((n >> 1) & 3)) * 16 + 2 * gg
                  + h] == tiles[1, 5 * l8.BLOCK_PIXELS + p, n]
    # each block's bytes are its own pixels' bytes: a permutation
    blocks = ws.reshape(-1, blk).sort(dim=1).values
    want = tiles.reshape(-1, l8.BLOCK_PIXELS, l8.CLUSTER_WIDTH).reshape(
        -1, blk).sort(dim=1).values
    assert torch.equal(blocks, want)


# the wide passes' rows: two chunks (H = 520 .. 1,024), three (1,030)
@pytest.mark.parametrize("h", [520, 1030])
def test_wide_workspace_layout_round_trips(h):
    """The R-row dW1 workspace (R = ``cluster_rows(H)``): row n, pixel
    16 w + g + 8 h of a block at n * 64 + (w ^ ((n >> 1) & 3)) * 16 + 2 g + h
    of its (R, 64) block, rows past 512 included; a permutation of each
    block's pixels that ``sm90_ws_tiles`` undoes."""
    g = torch.Generator().manual_seed(h)
    hw, rows = 1024, l8.cluster_rows(h)
    tiles = torch.randint(-7, 8, (2, hw, rows), generator=g,
                          dtype=torch.int8)
    ws = l8.sm90_ws_layout(tiles)
    assert ws.numel() == 2 * hw * rows
    assert torch.equal(l8.sm90_ws_tiles(ws, 2, hw), tiles)
    blk = rows * l8.BLOCK_PIXELS
    base = (hw // l8.BLOCK_PIXELS + 3) * blk
    for n, w, gg, hh in ((0, 0, 0, 0), (rows - 1, 3, 7, 1), (515, 2, 5, 0),
                         (1029 % rows, 1, 3, 1)):
        p = 16 * w + gg + 8 * hh
        assert ws[base + n * 64 + (w ^ ((n >> 1) & 3)) * 16 + 2 * gg
                  + hh] == tiles[1, 3 * l8.BLOCK_PIXELS + p, n]
    blocks = ws.reshape(-1, blk).sort(dim=1).values
    want = tiles.reshape(-1, l8.BLOCK_PIXELS, rows).reshape(
        -1, blk).sort(dim=1).values
    assert torch.equal(blocks, want)


@pytest.mark.parametrize("splits", [1, 3, 16])
def test_dw1_from_the_workspaces_is_the_plain_product(splits):
    g = torch.Generator().manual_seed(splits)
    nimg, hw, h, pt = 3, 1024, 40, 256
    aq, qi = (torch.randint(-7, 8, (nimg, hw, l8.CLUSTER_WIDTH), generator=g,
                            dtype=torch.int8) for _ in range(2))
    aq[..., h:] = 0
    qi[..., h:] = 0
    scale = torch.rand((nimg * hw // pt,), generator=g) * 1e-3
    part = l8.grouped_dw90_reference(l8.sm90_ws_layout(aq),
                                     l8.sm90_ws_layout(qi), scale, nimg, hw,
                                     h, pt, splits)
    assert part.shape == (splits, h, h)
    want = grouped_int_product(aq[..., :h].float(), qi[..., :h].float(),
                               scale, pt)
    got = part.sum(0)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    # splits hold whole groups in order: one split is the f32 sum in order
    if splits == 1:
        acc = torch.zeros((h, h))
        for gi in range(nimg * hw // pt):
            a = aq.reshape(-1, pt, l8.CLUSTER_WIDTH)[gi, :, :h].double()
            q = qi.reshape(-1, pt, l8.CLUSTER_WIDTH)[gi, :, :h].double()
            acc = acc + (a.T @ q).float() * scale[gi]
        assert torch.equal(got, acc)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_cluster_dw1_matches_jax(wdt, monkeypatch):
    """The plain version with its dW1 product taken through the cluster
    passes' workspaces and split sums (fifteen splits, as the card runs a
    call of this size) against the JAX kernel in interpret mode, at the
    limits the plain version itself is held to there."""
    b, h, no, hw = 4, 64, 3, 1024
    rng = np.random.default_rng(11)
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bd = 1 / h ** 0.5
    ws = [rng.uniform(-bd, bd, s).astype(np.float32)
          for s in ((h, h), (h,), (no, h), (no,))]
    yt = (rng.integers(0, 256, (b, no, hw)) - 128).astype(np.int8)
    mask = (rng.uniform(size=hw) > 0.3).astype(np.float32)
    coords = coord_grid(32, 32).numpy()
    pt = l8.pick_tile(hw)
    assert l8.k3_route(hw, h, pt, "bernoulli", Numerics()) == "sm90"

    def cluster_product(a, q, scale, pt_):
        n = a.shape[0]
        pad = l8.CLUSTER_WIDTH - a.shape[-1]
        a8, q8 = (torch.nn.functional.pad(t, (0, pad)).to(torch.int8)
                  for t in (a, q))
        splits = l8.dw_splits90(n * (hw // pt_))
        return l8.grouped_dw90_reference(
            l8.sm90_ws_layout(a8), l8.sm90_ws_layout(q8), scale.reshape(-1),
            n, hw, a.shape[-1], pt_, splits).sum(0)

    monkeypatch.setattr(l8, "grouped_int_product", cluster_product)
    got = l8.loss_int8_reference(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        torch.from_numpy(mask))
    jw = [jnp.asarray(w, jnp.bfloat16 if wdt == torch.bfloat16
                      else jnp.float32) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt), jnp.asarray(mask), "bernoulli", True)
    # tests/test_torch_port_int8.py's K3 limits for dW1 (max, mean relative)
    lim = {torch.float32: (2e-3, 3e-5), torch.bfloat16: (2.5e-2, 4e-3)}[wdt]
    a = got[1].float().numpy()
    w = np.asarray(want[1], np.float32)
    scale = float(np.abs(w).max())
    d = np.abs(a - w)
    assert d.max() / scale <= lim[0] and d.mean() / scale <= lim[1]


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_cluster_dw1_matches_jax_past_512(wdt):
    """dW1 through the wide passes' R-row workspaces (H = 520: two chunks,
    the second ragged) and the dW1 kernel's split sums, as
    ``test_cluster_dw1_matches_jax`` takes it at H = 64: the plain
    version's product exactly in group order (one split), and in place of
    the plain version's product within K3's limits of the JAX kernel."""
    b, h, no, hw = 2, 520, 3, 1024
    pt = l8.pick_tile(hw)
    fold, coords, ws, yt, mask, fam = loss_inputs("bernoulli", wdt, True,
                                                  True, b=b, h=h)
    assert l8.k3_route(hw, h, pt, fam, Numerics()) == "sm90"
    rows = l8.cluster_rows(h)
    assert rows == 1024

    def cluster_product(a, q, scale, pt_, splits=None):
        n = a.shape[0]
        a8, q8 = (torch.nn.functional.pad(t, (0, rows - h)).to(torch.int8)
                  for t in (a, q))
        splits = splits or l8.dw_splits90(n * (hw // pt_))
        return l8.grouped_dw90_reference(
            l8.sm90_ws_layout(a8), l8.sm90_ws_layout(q8), scale.reshape(-1),
            n, hw, h, pt_, splits).sum(0)

    args = [torch.from_numpy(fold), torch.from_numpy(coords),
            *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
            torch.from_numpy(mask)]
    got, (aq, qi) = l8.loss_int8_reference(*args, ints=True)
    scale = torch.rand((b * hw // pt,), generator=torch.Generator()
                       .manual_seed(1)) * 1e-3
    acc = torch.zeros((h, h))
    for gi in range(b * hw // pt):
        a_g, q_g = (t.reshape(-1, pt, h)[gi].double() for t in (aq, qi))
        acc = acc + (a_g.T @ q_g).float() * scale[gi]
    assert torch.equal(cluster_product(aq, qi, scale, pt, splits=1), acc)
    jw = [jnp.asarray(w, jnp.bfloat16 if wdt == torch.bfloat16
                      else jnp.float32) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt), jnp.asarray(mask), "bernoulli", True)
    original = l8.grouped_int_product
    try:
        l8.grouped_int_product = cluster_product
        through = l8.loss_int8_reference(*args)
    finally:
        l8.grouped_int_product = original
    assert (through[1] - got[1]).abs().max() <= 1e-6 * got[1].abs().max()
    lim = {torch.float32: (2e-3, 3e-5), torch.bfloat16: (2.5e-2, 4e-3)}[wdt]
    a = through[1].float().numpy()
    w = np.asarray(want[1], np.float32)
    scl = float(np.abs(w).max())
    d = np.abs(a - w)
    assert d.max() / scl <= lim[0] and d.mean() / scl <= lim[1]


def _unslab(stream, rows, kp):
    """``sm90_slabs``' inverse: the (R, Kp) matrix a slab stream holds."""
    t = stream.reshape(rows // l8.CLUSTER_WIDTH, kp // l8.SLAB_K,
                       l8.CLUSTER_WIDTH, 4, 16)
    return fd._swizzle64(t).transpose(1, 2).reshape(rows, kp)


def _wide_schedule(fold, coords, w1, b1, wht, bht, y_t, mask, family):
    """K3's five outputs as the wide cluster passes schedule them, on the
    host: W1f^T and W1r read back from their slab streams chunk by chunk;
    aq built once and left in the R-row dW1 workspace; per 512-column
    chunk the exact product over K = Kp, a1c (the stash) and the head's
    partial, the partials added in chunk order; the loss epilogue after the
    last chunk; per chunk q, qi, db1's and dWh^T's sums; qi's K-major copy
    (all chunks) as da0's A operand, da0 and dh0 per output chunk with aq
    read back from the workspace; dW1 from the R-row workspaces through the
    dW1 kernel's plain version."""
    wdt = wht.dtype
    b, _, h = fold.shape
    hw, no = coords.shape[0], wht.shape[0]
    pt = l8.pick_tile(hw)
    t_ = hw // pt
    kp, rows = l8.padded_hidden(h), l8.cluster_rows(h)
    cw = l8.CLUSTER_WIDTH
    pad = rows - h
    w1f, h1s, gb, w1r, s4 = l8.loss_operands(w1, wht)
    w1ft = _unslab(l8.sm90_slabs(w1f.T.contiguous()), rows, kp).double()
    w1rm = _unslab(l8.sm90_slabs(w1r), rows, kp).double()
    h1s, b1p, s4 = (torch.nn.functional.pad(v.float(), (0, pad))
                    for v in (h1s, b1, s4))
    whp = torch.nn.functional.pad(wht.float(), (0, pad))
    # the forward
    aq = torch.clamp(torch.round(torch.tanh(_first_layer(fold, coords))
                                 * 7.0), -7, 7)
    aq_ws = l8.sm90_ws_layout(
        torch.nn.functional.pad(aq, (0, pad)).to(torch.int8))
    aqk = torch.nn.functional.pad(aq, (0, kp - h)).double()
    stash, z = [], None
    for c in range(rows // cw):
        cols = slice(c * cw, (c + 1) * cw)
        acc = (aqk @ w1ft[cols].T).float()
        a1c = torch.tanh(acc * h1s[cols] + b1p[cols]).to(wdt).float()
        stash.append(a1c)
        zc = (a1c @ whp[:, cols].T).transpose(1, 2)
        z = zc if z is None else z + zc
    bce, dz2 = l8.loss_epilogue(z + bht.float()[:, None], y_t, mask,
                                family, pt)
    # the gradient pass
    dz2c = dz2.to(wdt).float()
    mdz = l8._group_max(dz2.transpose(1, 2), b, pt) + 1e-30
    gm = gb * mdz
    sg = gm * (1.0 / 7.0)
    qi_all = torch.zeros((b, hw, rows))
    db1, dwht = torch.zeros(rows), torch.zeros((no, rows))
    for c, a1c in enumerate(stash):
        cols = slice(c * cw, (c + 1) * cw)
        da1 = l8.head_transpose(dz2c, whp[:, cols])
        q = (da1 * l8.tanh_prime(a1c, wdt)) * l8._per_group(7.0 / gm, pt)
        qi_all[..., cols] = torch.clamp(torch.round(q), -7, 7)
        db1[cols] = (q.reshape(b, t_, pt, cw).sum(dim=2)
                     * sg[..., None]).sum(dim=(0, 1))
        dwht[:, cols] = torch.einsum("bop,bph->oh", dz2c, a1c)
    q_ws = l8.sm90_ws_layout(qi_all.to(torch.int8))
    qk = qi_all[..., :kp].double()
    aq_back = l8.sm90_ws_tiles(aq_ws, b, hw).float()
    xb = coords.to(torch.bfloat16).float()
    x0 = xb[:, 0].reshape(1, t_, pt, 1)
    x1 = xb[:, 1].reshape(1, t_, pt, 1)
    dfold = torch.zeros((b, 4, rows))
    for c in range(rows // cw):
        cols = slice(c * cw, (c + 1) * cw)
        da0 = (qk @ w1rm[cols].T).float()
        dh0 = l8.dh0_bf16(da0, aq_back[..., cols]).reshape(b, t_, pt, cw)
        sums = torch.stack([(x0 * dh0).sum(2), (x1 * dh0).sum(2),
                            dh0.sum(2)], dim=2)
        dfold[:, :3, cols] = (sums * (sg[..., None, None] * s4[cols])).sum(1)
    dfold = dfold[..., :h].contiguous()
    dfold[:, 3, 0] = bce.sum(dim=1)
    dw1 = l8.grouped_dw90_reference(aq_ws, q_ws, (sg / 7.0).reshape(-1), b,
                                    hw, h, pt,
                                    l8.dw_splits90(b * t_)).sum(0)
    return dfold, dw1, db1[:h], dwht[:, :h], dz2.sum(dim=(0, 2))


# (H, family, weight dtype): one chunk crossing (520: the second chunk a
# single slab of 64 columns) and two (1,030), the Bernoulli family on int8
# targets, the Gaussian under a mask, the colored one under a mask
WIDE_SCHEDULE_CASES = [(h, fam, wdt) for h in (520, 1030)
                       for fam in ("bernoulli", "gaussian", "colored")
                       for wdt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("case", WIDE_SCHEDULE_CASES, ids=lambda c: "-".join(
    [f"H{c[0]}", c[1], str(c[2])[6:]]))
def test_wide_schedule_matches_jax(case):
    """The host emulation of the wide cluster passes (``_wide_schedule``)
    against ``_run`` in interpret mode: the five outputs within the wide
    widths' limits (``test_torch_port_wide.LOSS_TOL``), the per-image loss
    at dfold[:, 3, 0] within 2e-6; the route takes the cluster passes."""
    h, family, wdt = case
    fold, coords, ws, yt, mask, fam = loss_inputs(
        family, wdt, family == "bernoulli", family != "bernoulli", b=2, h=h)
    hw = coords.shape[0]
    assert l8.k3_route(hw, h, l8.pick_tile(hw), fam, Numerics()) == "sm90"
    jw = [jnp.asarray(w, jnp.bfloat16 if wdt == torch.bfloat16
                      else jnp.float32) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt),
                       None if mask is None else jnp.asarray(mask), fam,
                       True)
    got = _wide_schedule(torch.from_numpy(fold), torch.from_numpy(coords),
                         *[torch.from_numpy(w).to(wdt) for w in ws],
                         torch.from_numpy(yt),
                         None if mask is None else torch.from_numpy(mask),
                         fam)
    for name, a, w in zip(("dfold", "dw1", "db1", "dwht", "dbht"), got,
                          want):
        w = np.asarray(w, np.float32).reshape(a.shape)
        d = np.abs(a.numpy() - w)
        scale = float(np.abs(w).max()) or 1.0
        lim = LOSS_TOL[wdt][name]
        assert d.max() / scale <= lim[0] and d.mean() / scale <= lim[1], (
            name, d.max() / scale, d.mean() / scale, lim)
    np.testing.assert_allclose(got[0][:, 3, 0].numpy(),
                               np.asarray(want[0])[:, 3, 0], rtol=2e-6)


# (numerics, family, H, HW, K8 mode, caller asks for the block passes, route)
ROUTE_CASES = [
    (Numerics(), "bernoulli", 500, 4096, None, False, "sm90"),
    (Numerics(), "gaussian", 500, 4096, None, False, "sm90"),
    (Numerics(), "gaussian", 500, 4352, None, False, "sm90"),
    (Numerics(), "bernoulli", 500, 1024, None, False, "sm90"),
    (Numerics(), "bernoulli", 96, 1280, None, False, "sm90"),
    (Numerics(), "bernoulli", 512, 4096, None, False, "sm90"),
    (Numerics(grad_mode="i4fwd"), "bernoulli", 500, 4096, None, False,
     "sm90"),
    (Numerics(adam_emit="pallas"), "bernoulli", 500, 4096, None, False,
     "sm90"),
    (Numerics(layout="t"), "gaussian", 500, 4096, None, False, "sm90"),
    (Numerics(), "bernoulli", 500, 4096, None, True, "block"),
    (Numerics(), "colored", 500, 4096, None, False, "sm90"),
    (Numerics(), "colored", 500, 1280, None, False, "sm90"),
    (Numerics(), "colored", 500, 4096, None, True, "block"),
    (Numerics(sr=True), "colored", 500, 4096, None, False, "sm90"),
    (Numerics(), "colored", 1000, 4096, None, False, "sm90"),
    (Numerics(), "bernoulli", 513, 4096, None, False, "sm90"),
    (Numerics(), "bernoulli", 1000, 4096, None, False, "sm90"),
    (Numerics(), "gaussian", 513, 4352, None, False, "sm90"),
    (Numerics(), "colored", 513, 1280, None, False, "sm90"),
    (Numerics(), "gaussian", 1000, 4096, None, False, "sm90"),
    (Numerics(), "bernoulli", 1000, 1024, None, False, "sm90"),
    (Numerics(), "bernoulli", 2048, 4096, None, False, "sm90"),
    (Numerics(), "gaussian", 2048, 4352, None, False, "sm90"),
    (Numerics(), "colored", 2048, 4096, None, False, "sm90"),
    (Numerics(), "bernoulli", 4100, 1024, None, False, "sm90"),
    (Numerics(), "bernoulli", 1000, 4096, None, True, "block"),
    (Numerics(), "bernoulli", 1000, 1088, None, False, "block"),
    (Numerics(sr=True), "colored", 1000, 4096, None, False, "block"),
    (Numerics(sr=True), "gaussian", 513, 4096, None, False, "block"),
    (Numerics(), "bernoulli", 1000, 4096, "i4", False, "block"),
    (Numerics(), "colored", 1000, 4096, "i8", False, "block"),
    (Numerics(gscale="tile"), "bernoulli", 1000, 4096, None, False, "block"),
    (Numerics(epi="f32"), "gaussian", 1000, 4096, None, False, "block"),
    (Numerics(grad_mode="i8"), "bernoulli", 1000, 4096, None, False,
     "block"),
    (Numerics(tanh="pade"), "colored", 1000, 4096, None, False, "block"),
    (Numerics(a1q=True), "bernoulli", 1000, 4096, None, False, "block"),
    (Numerics(db1="qi"), "bernoulli", 1000, 4096, None, False, "block"),
    (Numerics(phase_cut=7), "bernoulli", 1000, 4096, None, False, "block"),
    (Numerics(), "bernoulli", 500, 1088, None, False, "block"),
    (Numerics(), "bernoulli", 500, 4096, "i4", False, "block"),
    (Numerics(), "bernoulli", 500, 4096, "i8", False, "block"),
    (Numerics(gscale="tile"), "bernoulli", 500, 4096, None, False, "block"),
    (Numerics(epi="f32"), "bernoulli", 500, 4096, None, False, "block"),
    (Numerics(sr=True), "gaussian", 500, 4096, None, False, "sm90"),
    (Numerics(sr=True), "bernoulli", 500, 1024, None, False, "sm90"),
    (Numerics(sr=True, gscale="tile"), "bernoulli", 500, 4096, None, False,
     "block"),
    (Numerics(sr=True), "bernoulli", 1000, 4096, None, False, "block"),
    (Numerics(sr=True), "bernoulli", 500, 1088, None, False, "block"),
    (Numerics(sr=True), "bernoulli", 500, 4096, None, True, "block"),
    (Numerics(sr=True, grad_mode="i8"), "colored", 500, 4096, None, False,
     "block"),
    (Numerics(sr=True, epi="f32"), "gaussian", 500, 4096, None, False,
     "block"),
    (Numerics(sr=True, a1q=True), "bernoulli", 500, 4096, None, False,
     "block"),
    (Numerics(sr=True), "bernoulli", 500, 4096, "i4", False, "block"),
    (Numerics(grad_mode="i8"), "bernoulli", 500, 4096, None, False, "block"),
    (Numerics(grad_mode="da0_i4"), "bernoulli", 500, 4096, None, False,
     "block"),
    (Numerics(tanh="pade"), "bernoulli", 500, 4096, None, False, "block"),
    (Numerics(a1q=True), "bernoulli", 500, 4096, None, False, "block"),
    (Numerics(db1="qi"), "bernoulli", 500, 4096, None, False, "block"),
    (Numerics(phase_cut=7), "bernoulli", 500, 4096, None, False, "block"),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(
    [",".join(c[0].drift()) or "default", c[1], f"H{c[2]}", f"HW{c[3]}",
     str(c[4]), "ask-block" if c[5] else "by-mode", c[6]]))
def test_route_table(case):
    nm, family, h, hw, t_mode, block_passes, want = case
    pt = l8.pick_tile(hw)
    assert l8.k3_route(hw, h, pt, family, nm, t_mode, block_passes) == want


def test_workspace_chunks_at_the_bench_step(monkeypatch):
    """B=4,096 at 64x64, H=500, bf16 weights: per image the aq and qi
    workspaces, (512, 4,096) int8 each, and the a1c stash, (4,096, 512)
    bf16, chunked within an 80 GB card's budget (an eighth of it): four
    chunks, each run forward, gradient and dW1 in turn."""
    monkeypatch.setattr(fd, "_total_memory", lambda kind, index: 80 * 10**9)
    budget = fd.workspace_budget(torch.device("cuda", 0))
    assert budget == 10**10
    per = l8.loss_workspace_bytes(4096, 500, "sm90",
                                  l8.stash_block_bytes(True))
    assert per == 2 * 512 * 4096 + 4096 * 512 * 2
    chunks = image_chunks(4096, per, budget)
    assert len(chunks) == 4
    assert sum(n for _, n in chunks) == 4096
    assert all(n * per <= budget for _, n in chunks)
    assert [b0 for b0, _ in chunks] == [0, 1192, 2384, 3576]
    # SR on the cluster route: the forward leaves aq in the dW1 workspace,
    # no stash of its own
    assert l8.k3_route(4096, 500, 1024, "bernoulli",
                       Numerics(sr=True)) == "sm90"
    # the block passes' (Kp, HW) workspaces alone: two chunks
    assert len(image_chunks(4096, l8.loss_workspace_bytes(4096, 500, "block"),
                            budget)) == 2


def _sr_check(counters, b0, nimg, hw, h, seed):
    """Whether every (image, row, column) of images b0 .. of both sites is
    rounded exactly once, with the counter (image, row, column // 4) and
    word column % 4, so that it takes the word ``site_words`` gives it (held
    on the cells of each image's first 64 rows); returns the first failure,
    or None."""
    from spatialvae_torch.kernels import philox as px

    for site, key in (("fwd", px.SITE_FWD), ("grad", px.SITE_GRAD)):
        img, row, col, c0, c1, c2, word = counters[site]
        cell = ((img - b0) * hw + row) * h + col
        if not bool((torch.bincount(cell, minlength=nimg * hw * h)
                     == 1).all()):
            return f"{site}: cells not covered exactly once"
        if not (torch.equal(c0, img) and torch.equal(c1, row)
                and torch.equal(c2, col // 4) and torch.equal(word, col % 4)):
            return f"{site}: counters differ from (image, row, column // 4)"
        pick = row < 64
        got = torch.stack(px.philox4x32_10(
            (c0[pick], c1[pick], c2[pick], 0), (seed, key)), dim=-1)
        got = got.gather(1, word[pick, None])[:, 0]
        want = px.site_words(seed, key, b0 + nimg, 64, h)[
            img[pick], row[pick], col[pick]]
        if not torch.equal(got, want):
            return f"{site}: words differ from site_words"
    return None


# (images of the chunk, first image, pixels, H, colored group or 0,
# resident clusters): the galaxy grid, 28x28 padded to 1,024, colored 64x64
# (its mask changes no counter), each whole and as a later chunk
SR90_WALKS = [(1, 0, 4096, 500, 0, 33), (1, 5, 4096, 500, 0, 7),
              (2, 0, 1024, 40, 0, 3), (4, 3, 1024, 40, 0, 1000),
              (1, 0, 4096, 500, 1024, 33), (1, 7, 4096, 500, 1024, 5)]


@pytest.mark.parametrize("walk", SR90_WALKS, ids=lambda w: "-".join(
    [f"N{w[0]}", f"b0_{w[1]}", f"HW{w[2]}", f"H{w[3]}",
     "colored" if w[4] else "plain"]))
def test_sr_counters_draw_site_words(walk):
    nimg, b0, hw, h, cpt, clusters = walk
    seed = 0x3C23D70A
    got = l8.sr90_counters(nimg, hw, h, clusters, b0, cpt)
    assert _sr_check(got, b0, nimg, hw, h, seed) is None
    del got
    # the faulty copy's counters, rows in the dW1 workspace's order
    bad = l8.sr90_counters(nimg, hw, h, clusters, b0, cpt, ws_row=True)
    assert _sr_check(bad, b0, nimg, hw, h, seed) is not None
