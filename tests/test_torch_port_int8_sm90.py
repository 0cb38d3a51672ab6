"""K4 and K5's cluster passes (``csrc/fused_decoder_int8_sm90.cu``) on the
CPU: what surrounds the kernels, which only the card runs.

- the route table sends each width (past 512 to the wide unit,
  ``tests/test_torch_port_int8_wide90.py``), pixel count, call and caller
  to the passes ``int8_route`` names (the wrappers pass nothing else to the C
  entry points, which refuse a call the table does not send them), and the
  no-grad decode quantises the generator's weights as they are at the call,
  however they were written;
- the walk of the clusters: every (image, 64-pixel block) exactly once, the
  four blocks of a cluster's step consecutive and in one quantisation group
  of ``pick_tile(HW)`` pixels, at 64x64, 28x28 padded and 65x65 padded,
  with odd batches;
- the W1q^T half-slab stream (K4) and the W1q slab stream (K5's da0)
  round-trip to ``pad_square``, element (n, k) where wgmma's 64-byte
  swizzled layout puts it;
- the packed a1: K4's stage of a block and its four bulk copies round-trip
  to the (B, HW, H) bf16 output, every run on 16-byte boundaries;
- dW1 from the gradient pass's workspaces (K3's cluster layout) at Pt =
  2,048, through ``grouped_dw90``'s plain version split by split, is the
  plain version's product, and within K5's limits of the JAX
  ``_bwd_kernel`` in interpret mode when it replaces the plain version's,
  at H = 64 and past 512 (the wide passes' R-row workspaces);
- the workspace chunks of the microbenchmark's B=2,048 (the dW1 operands,
  with recompute the f32 a1 stash) fit the budget of an 80 GB card.

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
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def half_slabs90_rows(slabs, kp):
    """``d8.half_slabs90``' inverse: the (CLUSTER_WIDTH, Kp) padded rows."""
    t = fd._swizzle64(slabs.reshape(2, kp // d8.SLAB_K, 256, 4, 16))
    t = t.permute(0, 2, 1, 3, 4).reshape(2, 4, 64, kp)
    return t.transpose(0, 1).reshape(d8.CLUSTER_WIDTH, kp)


def a1_stage_index(h):
    """Where K4's cluster pass stages a1 (pixel p, column n) of a 64-pixel
    block (``epi_part``, MODE_EMIT): element p * H + n of the block's packed
    (64, H) bf16 rows in shared memory, -1 for the padded columns n >= H.
    (64, CLUSTER_WIDTH) int64."""
    p = torch.arange(d8.BLOCK_PIXELS)[:, None]
    n = torch.arange(d8.CLUSTER_WIDTH)[None, :]
    return torch.where(n < h, p * h + n, torch.full_like(n, -1))


def a1_store_pieces(b, p0, hw, h):
    """K4's cluster pass's bulk copies of the staged a1 of image b's block
    at pixel p0 (``finish_tile``): [(first element of the (B, HW, H)
    output, first element of the stage, elements)], four runs of 16
    rows."""
    part = 16 * h
    base = (b * hw + p0) * h
    return [(base + i * part, i * part, part) for i in range(4)]


def _padded(side):
    """The pixels K4/K5 see for a side x side image
    (``fused_spatial_generator_int8`` pads to a multiple of 256) and the
    pixels of its quantisation groups."""
    hw = side * side + (-side * side) % 256
    return hw, d8.pick_tile(hw)


# (H, HW, the passes the caller names, K4 without a1 on f32 weights, route)
ROUTES = [(500, 4096, None, False, "sm90"), (512, 4096, None, False, "sm90"),
          (96, 1024, None, False, "sm90"), (500, 4352, None, False, "sm90"),
          (40, 256, None, False, "sm90"), (130, 1280, None, False, "sm90"),
          (513, 4096, None, False, "sm90"),
          (1000, 4096, None, False, "sm90"),
          (500, 784, None, False, "block"), (500, 4160, None, False, "block"),
          (500, 4096, "block", False, "block"),
          (96, 1024, "block", False, "block"),
          (500, 4096, None, True, "block"), (96, 1024, None, True, "block"),
          (500, 4096, "sm90", True, "sm90"),
          (1000, 4096, None, True, "sm90"),
          (500, 4096, "block", True, "block")]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: f"H{c[0]}-HW{c[1]}-"
                         f"{c[2] or 'table'}-{'f32-alone' if c[3] else 'call'}"
                         f"-{c[4]}")
def test_route_table(case):
    h, hw, passes, alone, want = case
    assert d8.int8_route(hw, h, passes, k4_alone_f32=alone) == want
    if want == "sm90":
        pt = d8.pick_tile(hw)
        quad = d8.CLUSTER * d8.BLOCK_PIXELS
        assert pt % quad == 0 and hw % pt == 0


@pytest.mark.parametrize("h,hw,passes", [(1000, 4160, "sm90"),
                                         (500, 4160, "sm90"),
                                         (500, 4096, "tile")])
def test_route_refuses_what_the_passes_do_not_take(h, hw, passes):
    with pytest.raises(ValueError):
        d8.int8_route(hw, h, passes)


def test_no_grad_decode_follows_in_place_weight_writes():
    """The no-grad decode (the evaluation's K4 alone) quantises the
    generator's weights as they are at each call: a write that bypasses
    autograd's version counter, as the step kernel's raw-pointer writes
    do, is seen by the next call."""
    import copy

    from spatialvae_torch.config import SpatialGeneratorConfig
    from spatialvae_torch.models import SpatialGenerator

    torch.manual_seed(3)
    gen = SpatialGenerator(SpatialGeneratorConfig(
        latent_dim=4, hidden_dim=64, n_out=3, num_layers=2))
    coords = coord_grid(16, 16)
    theta, dx, z = torch.randn(3), 0.1 * torch.randn(3, 2), torch.randn(3, 4)
    with torch.no_grad():
        before = d8.fused_spatial_generator_int8(gen, coords, theta, dx, z)
        hidden, head = gen.linears()
        version = hidden.weight._version
        hidden.weight.data.mul_(-1.5)
        head.bias.data.add_(0.25)
        assert hidden.weight._version == version
        after = d8.fused_spatial_generator_int8(gen, coords, theta, dx, z)
        fresh = d8.fused_spatial_generator_int8(copy.deepcopy(gen), coords,
                                                theta, dx, z)
    assert not torch.allclose(before, after)
    assert torch.equal(after, fresh)


@pytest.mark.parametrize("side", [64, 28, 65, 33])
def test_every_generator_call_takes_the_cluster_passes(side):
    """What ``fused_spatial_generator_int8`` hands the kernels at the
    default width: the padded grid, whose groups hold whole quads."""
    hw, pt = _padded(side)
    assert hw % 256 == 0 and pt % 256 == 0
    assert d8.int8_route(hw, 500) == "sm90"


# (image side, images, resident clusters): the galaxy grid with an odd
# tail, 28x28 and 65x65 padded, more clusters than quads
@pytest.mark.parametrize("side,b,clusters", [(64, 37, 30), (64, 3, 7),
                                             (28, 5, 3), (65, 3, 30),
                                             (65, 1, 1000), (28, 37, 30)])
def test_cluster_walk_covers_every_block_once(side, b, clusters):
    hw, pt = _padded(side)
    blocks = hw // d8.BLOCK_PIXELS
    assert (b * blocks) % d8.CLUSTER == 0
    walk = l8.cluster_schedule(b * blocks, clusters)
    assert len(walk) % d8.CLUSTER == 0
    assert sorted(x for cta in walk for x in cta) == list(range(b * blocks))
    bpg = pt // d8.BLOCK_PIXELS
    for c in range(0, len(walk), d8.CLUSTER):
        ctas = walk[c:c + d8.CLUSTER]
        assert len({len(cta) for cta in ctas}) == 1      # in lockstep
        for step in zip(*ctas):
            assert list(step) == list(range(step[0], step[0] + d8.CLUSTER))
            # one image, one quantisation group
            assert len({(x // blocks, (x % blocks) // bpg)
                        for x in step}) == 1


@pytest.mark.parametrize("h", [500, 130, 40])
def test_slab_streams_round_trip(h):
    g = torch.Generator().manual_seed(h)
    w1 = torch.randn((h, h), generator=g)
    w = d8.Int8Weights(w1, torch.zeros(h), torch.zeros((3, h)),
                       torch.zeros(3))
    kw = d8.CLUSTER_WIDTH
    kp = d8.padded_hidden(h)
    hs, slabs = w.half_slabs90(), w.slabs90()
    assert hs.dtype == slabs.dtype == torch.int8
    assert hs.numel() == slabs.numel() == kw * kp
    full = torch.zeros((kw, kp), dtype=torch.int8)
    full[:kp] = d8.pad_square(w.w1q.T)
    assert torch.equal(half_slabs90_rows(hs, kp), full)
    # element (n, k) of W1q^T: half hf = (n // 64) % 2 of warpgroup n // 128
    # at row 64 (n // 128) + n % 64 of the half's slab k // 64, its 16-byte
    # chunks swizzled by (row >> 1) & 3 (csrc/sm90.cuh offset_sw64)
    idx = torch.arange(full.numel())
    n, k = idx // kp, idx % kp
    hf, row = (n // 64) % 2, 64 * (n // 128) + n % 64
    nslab = kp // d8.SLAB_K
    off = ((hf * nslab + k // d8.SLAB_K) * 256 * d8.SLAB_K + row * 64
           + (((k % d8.SLAB_K) // 16) ^ ((row >> 1) & 3)) * 16 + k % 16)
    assert torch.equal(hs[off], full.reshape(-1))
    # K5's stream is K3's layout of W1q's rows
    full[:kp] = d8.pad_square(w.w1q)
    off = ((k // d8.SLAB_K) * d8.SLAB_K * d8.CLUSTER_WIDTH + n * 64
           + (((k % d8.SLAB_K) // 16) ^ ((n >> 1) & 3)) * 16 + k % 16)
    assert torch.equal(slabs[off], full.reshape(-1))


@pytest.mark.parametrize("h", [500, 97, 512])
def test_packed_a1_round_trips(h):
    """K4 stages each block's a1 from the accumulator's (pixel, column)
    at ``a1_stage_index`` and writes the stage in ``a1_store_pieces``: every
    element of the (B, HW, H) bf16 output exactly once."""
    b, hw = 3, 512
    g = torch.Generator().manual_seed(h)
    a1 = torch.randn((b, hw, h), generator=g).bfloat16()
    idx = a1_stage_index(h)
    live = idx >= 0
    assert live.sum().item() == 64 * h
    assert sorted(idx[live].tolist()) == list(range(64 * h))
    out = torch.zeros(b * hw * h, dtype=torch.bfloat16)
    for img in range(b):
        for p0 in range(0, hw, d8.BLOCK_PIXELS):
            stage = torch.zeros(64 * h, dtype=torch.bfloat16)
            block = torch.zeros((64, d8.CLUSTER_WIDTH), dtype=torch.bfloat16)
            block[:, :h] = a1[img, p0:p0 + 64]
            stage[idx[live]] = block[live]
            for dst, src, cnt in a1_store_pieces(img, p0, hw, h):
                assert (2 * dst) % 16 == 0 and (2 * cnt) % 16 == 0
                assert (2 * src) % 16 == 0
                out[dst:dst + cnt] = stage[src:src + cnt]
    assert torch.equal(out.view(b, hw, h), a1)


def _chain(fold, coords, w1q, sw, b1, wht, y, g):
    """The plain backward's int8 operands: a0q and dh1q (B, HW, H) and the
    groups' dW1 scales sg/127 (B, HW/Pt), as
    ``decoder_tail_int8_backward_reference`` forms them."""
    hw = coords.shape[0]
    pt = d8.pick_tile(hw)
    _, a0q, a1 = d8._forward_chain(fold, coords, w1q, sw, b1)
    s = y.float()
    dz2c = (g * s * (1 - s)).to(wht.dtype).float()
    dh1 = torch.einsum("bop,oh->bph", dz2c, wht.float()) * (1 - a1 * a1)
    b = dh1.shape[0]
    sg = dh1.abs().reshape(b, hw // pt, -1).amax(dim=2) / 127.0 + 1e-30
    dh1q = torch.clamp(torch.round(
        dh1 / sg.repeat_interleave(pt, dim=1)[..., None]), -127, 127)
    return a0q, dh1q, sg / 127.0


@pytest.mark.parametrize("splits", [1, 2, 15])
def test_dw1_from_the_workspaces_is_the_plain_product(splits):
    """At 64x64 (Pt = 2,048): the gradient pass's a0q and dh1q in K3's
    cluster workspace layout, padded to 512 rows, through the cluster dW1
    kernel's plain version split by split, equal the plain version's
    grouped product; one split is its f32 sum in group order bit for bit."""
    b, h, no, hw = 3, 40, 3, 4096
    pt = d8.pick_tile(hw)
    assert pt == 2048
    gen = torch.Generator().manual_seed(splits)
    fold = torch.zeros((b, 4, h))
    fold[:, :2] = torch.rand((b, 2, h), generator=gen) * 1.4 - 0.7
    fold[:, 2] = torch.rand((b, h), generator=gen) * 3 - 1.5
    coords = coord_grid(64, 64)
    w = d8.Int8Weights(torch.randn((h, h), generator=gen) / h ** 0.5,
                       torch.randn(h, generator=gen) * 0.1,
                       torch.randn((no, h), generator=gen) / h ** 0.5,
                       torch.zeros(no))
    y = torch.rand((b, no, hw), generator=gen)
    g = torch.randn((b, no, hw), generator=gen)
    a0q, dh1q, scale = _chain(fold, coords, w.w1q, w.sw, w.b1, w.wht, y, g)
    pad = d8.CLUSTER_WIDTH - h
    ws = [l8.sm90_ws_layout(torch.nn.functional.pad(t, (0, pad)).to(
        torch.int8)) for t in (a0q, dh1q)]
    part = l8.grouped_dw90_reference(*ws, scale.reshape(-1), b, hw, h, pt,
                                     splits)
    assert part.shape == (splits, h, h)
    want = d8.grouped_int_product(a0q, dh1q, scale, pt)
    got = part.sum(0)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    if splits == 1:
        assert torch.equal(got, want)


@pytest.mark.parametrize("saved", [True, False], ids=["residual", "recompute"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cluster_dw1_matches_jax(wdt, saved, monkeypatch):
    """The plain backward with its dW1 product taken through the cluster
    workspaces and the split sums (as many splits as the card runs for the
    call) against the JAX ``_bwd_kernel`` in interpret mode, at 64x64
    (groups of 2,048 pixels), within K5's limits
    (``tests/test_torch_port_int8.py``)."""
    _dw1_through_workspaces(wdt, saved, 64, 4096, monkeypatch)


@pytest.mark.parametrize("saved", [True, False], ids=["residual", "recompute"])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cluster_dw1_matches_jax_past_512(wdt, saved, monkeypatch):
    """As ``test_cluster_dw1_matches_jax`` at H = 520 over 32x32 (one group
    of 1,024 pixels an image): the wide passes' workspaces of
    ``cluster_rows(520)`` = 1,024 rows a block, the second chunk ragged."""
    _dw1_through_workspaces(wdt, saved, 520, 1024, monkeypatch)


def _dw1_through_workspaces(wdt, saved, h, hw, monkeypatch):
    b, no = 2, 3
    side = int(hw ** 0.5)
    rng = np.random.default_rng(7)
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bd = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bd, bd, s).astype(np.float32)).to(
        wdt).float().numpy() for s in ((h, h), (h,), (no, h), (no,))]
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    coords = coord_grid(side, side).numpy()
    assert d8.int8_route(hw, h) == "sm90"
    rows = l8.cluster_rows(h)

    def cluster_product(a, q, scale, pt_):
        n = a.shape[0]
        pad = rows - a.shape[-1]
        a8, q8 = (torch.nn.functional.pad(t, (0, pad)).to(torch.int8)
                  for t in (a, q))
        splits = l8.dw_splits90(n * (hw // pt_))
        return l8.grouped_dw90_reference(
            l8.sm90_ws_layout(a8), l8.sm90_ws_layout(q8), scale.reshape(-1),
            n, hw, a.shape[-1], pt_, splits).sum(0)

    monkeypatch.setattr(d8, "grouped_int_product", cluster_product)
    jnpt = jnp.bfloat16 if wdt == torch.bfloat16 else jnp.float32
    jw = [jnp.asarray(x, jnpt) for x in ws]
    w1q, sw = jd8._quant_sym(jw[0])
    y, a1 = jd8._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q, sw,
                            jw[1][None, :], jw[2], jw[3][:, None],
                            emit_acts=True)
    want = jd8._bwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q, sw,
                           jw[1][None, :], jw[2], a1 if saved else None, y,
                           jnp.asarray(g))
    w = d8.Int8Weights(*[torch.from_numpy(x).to(wdt) for x in ws])
    ta1 = torch.from_numpy(np.array(a1.astype(jnp.float32))).bfloat16()
    got = d8.decoder_tail_int8_backward_reference(
        torch.from_numpy(fold), torch.from_numpy(coords), w.w1q, w.sw, w.b1,
        w.wht, ta1 if saved else None, torch.from_numpy(np.array(y)),
        torch.from_numpy(g))
    k5_tol = (2e-3, 5e-5)             # relative to max|JAX|: max, mean
    for name, a, ref in zip(("dfold", "dw1", "db1", "dwht", "dbht"), got,
                            want):
        r = np.asarray(ref, np.float32).reshape(a.shape)
        d = np.abs(a.numpy() - r)
        scale = float(np.abs(r).max()) or 1.0
        assert d.max() / scale <= k5_tol[0], (name, d.max() / scale)
        assert d.mean() / scale <= k5_tol[1], (name, d.mean() / scale)


def test_workspace_chunks_of_the_microbenchmark(monkeypatch):
    """B=2,048 at 64x64 (the microbenchmark's ``bwd``), within an 80 GB
    card's budget (an eighth of it): per image the two dW1 operands (512,
    4,096) int8, and with recompute the f32 a1 stash (4,096, 512): three
    chunks, each run scale, gradient and dW1 in turn; from the residual,
    one."""
    monkeypatch.setattr(fd, "_total_memory", lambda kind, index: 80 * 10**9)
    budget = fd.workspace_budget(torch.device("cuda", 0))
    assert budget == 10**10
    for recompute, per, n_chunks in ((True, 12 * 2**20, 3),
                                     (False, 4 * 2**20, 1)):
        assert d8.workspace90_bytes(4096, recompute) == per
        chunks = d8.workspace90_chunks(2048, 4096, recompute, budget)
        assert len(chunks) == n_chunks
        assert sum(n for _, n in chunks) == 2048
        assert all(n * per <= budget for _, n in chunks)
        assert [b0 for b0, _ in chunks] == list(
            range(0, 2048, chunks[0][1]))
