"""K1 and K2 on clusters (``csrc/fused_decoder_sm90.cu``) on the CPU: what
surrounds the kernels, which only the card runs.

- W's slab stream round-trips: element (n, k) of each plane lies where
  wgmma's 64-byte swizzled K-major layout puts it, chunk after chunk of
  512 rows, the f32 planes are the TF32 head and tail, bf16 stays bf16
  (H = 40, 500, 512, and 520 and 1,030 for the deep kernels' chunks);
- the TF32 split (``tf32_round`` is ``cvt.rna.tf32.f32``): three products
  hold the galaxy tile's (64 x 500 x 500) product to the f64 one within
  1e-6 of its largest value, one product reads above 1e-4 (where the
  kernels' f32 limits sit between the two);
- the dW workspace layout round-trips (512 rows a block, and 1,024 for
  the deep kernels at H = 1,030), each pixel at the position the chain
  writes it, and dW1 through it (the dW1 kernel's plain version,
  split by split) is the JAX ``_bwd_kernel``'s (interpret mode) within
  rtol 1e-5 in f32 (sums over the pixels in another order) and 1e-2 of the
  largest value with bf16 weights (the packages round a tanh to bf16 from
  values an ulp apart);
- the forward built slab by slab (cast(a0) per K slab, split for f32, the
  product over W's slabs in the kernel's order) is the JAX ``_fwd_kernel``'s
  y within rtol 1e-5 (f32; bf16 1e-2 as above);
- ``decoder_route``'s table, and the launches refusing the sm90 route for
  a call it does not take before any library is loaded.

The deep kernels' schedules are held to the JAX package by
``test_torch_port_decoder_deep.py``.

The kernels themselves, their walk over the tiles included, are held to the
plain versions and to the tile kernels on the card by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.kernels import fused_decoder as jax_fd

from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.transforms.coords import coord_grid
from tests import dec90_layouts as dl
from tests.port_configs import one_torch_thread  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
W = fd.SM90_WIDTH


def _values_per_slab(dt):
    return fd.SLAB_BYTES // (torch.finfo(dt).bits // 8)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [40, 500, 512, 520, 1030])
def test_slab_stream_round_trips(h, dt):
    gen = torch.Generator().manual_seed(h)
    w = (torch.rand((h, h), generator=gen) * 2 - 1).to(dt)
    slabs = fd.decoder_slabs(w)
    kp = fd.slab_k(h)
    rows = fd.sm90_rows(h)
    planes = dl.decoder_slab_planes(slabs, h, h)
    full = torch.zeros((rows, kp), dtype=dt)
    full[:h, :h] = w
    if dt == torch.bfloat16:
        assert slabs.dtype == torch.bfloat16 and planes.shape == (1, rows, kp)
        assert torch.equal(planes[0], full)
    else:
        hi, lo = fd.tf32_split(full)
        assert planes.shape == (2, rows, kp)
        assert torch.equal(planes[0], hi) and torch.equal(planes[1], lo)
    # element (n, k) where the swizzled layout puts it: chunk n // 512, its
    # row n % 512, then the slab's unit and plane
    ks = _values_per_slab(dt)
    e = ks // 4
    units = kp // ks
    for n, k in ((0, 0), (1, 5), (3, ks + 1), (h - 1, h - 1), (7, kp - 1),
                 (rows - 1, 0)):
        c, r = divmod(n, W)
        s, kk = divmod(k, ks)
        chunk = (kk // e) ^ ((r >> 1) & 3)
        at = (((c * units + s) * planes.shape[0]) * W + r) * ks \
            + chunk * e + kk % e
        assert slabs[at] == planes[0, n, k]


def test_tf32_round_is_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -12, 3.14159265, -2.71828183e-20],
                     dtype=torch.float32)
    r = fd.tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    # ties away from zero, else nearest at 10 mantissa bits
    assert r[1] == 1.0 + 2 ** -10 and r[2] == -(1.0 + 2 ** -10)
    assert r[3] == 1.0 + 2 ** -10
    ulp = 2.0 ** (torch.floor(torch.log2(x.abs().double())) - 10)
    assert ((r.double() - x.double()).abs() <= ulp / 2).all()


def test_three_tf32_products_hold_the_galaxy_tile():
    """cast(a0) (64, 500) . W1 (500, 500) as the kernels compute it."""
    rng = np.random.default_rng(0)
    h = 500
    h0 = (rng.uniform(-1, 1, (64, 1)) * rng.uniform(-0.7, 0.7, (1, h))
          + rng.uniform(-1.5, 1.5, (1, h)))
    a = torch.tanh(torch.from_numpy(h0).float())
    w = torch.from_numpy(rng.uniform(-1, 1, (h, h)) / np.sqrt(h)).float()
    exact = a.double() @ w.double()
    (ah, al), (wh, wl) = fd.tf32_split(a), fd.tf32_split(w)
    d = lambda t: t.double()
    three = d(al) @ d(wh) + d(ah) @ d(wl) + d(ah) @ d(wh)
    one = d(ah) @ d(wh)
    scale = exact.abs().max()
    assert (three - exact).abs().max() / scale <= 1e-6
    assert (one - exact).abs().max() / scale > 1e-4


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_workspace_layout_round_trips(dt):
    _workspace_round_trip(dt, W)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_deep_workspace_layout_round_trips(dt):
    """The deep kernels' workspaces at H = 1,030: 1,024 rows a block."""
    _workspace_round_trip(dt, fd.sm90_rows(1030))


def _workspace_round_trip(dt, rows):
    gen = torch.Generator().manual_seed(1)
    nb = 3
    tiles = (torch.rand((nb, fd.BLOCK_PIXELS, rows), generator=gen) * 2
             - 1).to(dt)
    ws = dl.dec90_ws_layout(tiles)
    assert ws.dtype == dt and ws.numel() == nb * rows * 64
    assert torch.equal(dl.dec90_ws_tiles(ws, nb, rows), tiles)
    assert ws.numel() * ws.element_size() == nb * fd.deep_ws_block(
        rows, dt == torch.bfloat16)
    # pixel 16 w + g + 8 h of block b, row r: position 16 w + 2 g + h, in
    # 64-byte chunks of `rows` swizzled rows
    e = _values_per_slab(dt) // 4
    per = 4 * e
    for b, pw, g, hh, r in ((0, 0, 0, 0, 0), (1, 3, 7, 1, 77),
                            (2, 2, 5, 0, rows - 1), (2, 1, 2, 1, 6)):
        pos = 16 * pw + 2 * g + hh
        c, kk = divmod(pos, per)
        chunk = (kk // e) ^ ((r >> 1) & 3)
        at = ((b * (64 // per) + c) * rows + r) * per + chunk * e + kk % e
        assert ws[at] == tiles[b, 16 * pw + g + 8 * hh, r]


def _inputs(no, hw, wdt, b=2, h=24, seed=0):
    """numpy fold, coords, weights (Lh = 1, on the weight dtype's grid) and
    a cotangent of y."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(hw))
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [rng.uniform(-bound, bound, s).astype(np.float32)
          for s in ((1, h, h), (1, h), (no, h), (no,))]
    ws = [torch.from_numpy(w).to(wdt).float().numpy() for w in ws]
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    return fold, coord_grid(side, side).numpy(), ws, g


def _close(got, want, wdt, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) or 1.0
    if wdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale,
                                   err_msg=what)


@pytest.mark.parametrize("hw", [256, 400])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dw1_through_the_workspaces_matches_jax(wdt, hw):
    no = 3
    fold, coords, ws, g = _inputs(no, hw, wdt)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    with pltpu.force_tpu_interpret_mode():
        y, acts = jax_fd._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords),
                                     *jw[:3], jw[3][:, None], False,
                                     emit_acts=True)
        want = jax_fd._bwd_pallas(jnp.asarray(fold), jnp.asarray(coords),
                                  *jw[:3], acts, y, jnp.asarray(g), False)
    # the chain's operands from the JAX forward's y and residual, with the
    # kernels' casts
    cast = lambda t: t.to(wdt)
    tf, tc = torch.from_numpy(fold), torch.from_numpy(coords)
    a0 = torch.tanh(fd._first_layer(tf, tc))
    a1 = torch.from_numpy(np.array(acts.astype(jnp.float32)))[0]
    s = torch.from_numpy(np.array(y))
    dz2 = torch.from_numpy(g) * s * (1.0 - s)
    da1 = torch.einsum("bop,oh->bph", cast(dz2).float(),
                       torch.from_numpy(ws[2]))
    dh1 = da1 * (1.0 - a1 * a1)
    nb = fold.shape[0] * -(-hw // fd.BLOCK_PIXELS)
    ws_a0 = dl.dec90_ws_layout(dl.ws_blocks(cast(a0), hw))
    ws_dh = dl.dec90_ws_layout(dl.ws_blocks(cast(dh1), hw))
    h = fold.shape[2]
    parts = dl.dec90_dw_reference(ws_a0, ws_dh, nb, h, splits=3)
    assert parts.shape == (3, h, h)
    _close(parts.sum(0).numpy(), np.asarray(want[1])[0], wdt, "dW1")


def _forward_by_slabs(fold, coords, ws, wdt, resid):
    """The sm90 forward's arithmetic on the CPU: cast(a0) built K slab by K
    slab, each slab split into TF32 planes for f32 weights, the product
    over W1^T's slabs as the kernel issues it (lo.hi + hi.lo + hi.hi per
    slab; bf16 values in bf16), summed in f64; then bias, the residual add,
    tanh and the head."""
    whid, bhid, wht, bht = (torch.from_numpy(w).to(wdt) for w in ws)
    h = whid.shape[1]
    kp = fd.slab_k(h)
    ks = _values_per_slab(wdt)
    wpl = dl.decoder_slab_planes(fd.decoder_slabs(whid[0].T), h).double()
    a0 = torch.tanh(fd._first_layer(torch.from_numpy(fold),
                                    torch.from_numpy(coords)))
    b, hw, _ = a0.shape
    a0p = torch.zeros((b, hw, kp))
    a0p[..., :h] = a0
    acc = torch.zeros((b, hw, W), dtype=torch.float64)
    for s in range(kp // ks):
        cols = slice(s * ks, (s + 1) * ks)
        a = a0p[..., cols].to(wdt)
        if wdt == torch.bfloat16:
            acc += a.double() @ wpl[0, :, cols].T
        else:
            ah, al = (p.double() for p in fd.tf32_split(a))
            wh, wl = wpl[0, :, cols].T, wpl[1, :, cols].T
            acc += al @ wh + ah @ wl + ah @ wh
    x = acc[..., :h].float() + bhid[0].float()
    if resid:
        x = x + a0
    a1 = torch.tanh(x)
    z = a1.to(wdt).float() @ wht.float().T + bht.float()
    return torch.sigmoid(z).transpose(1, 2), a1


@pytest.mark.parametrize("resid", [False, True], ids=["plain", "resid"])
@pytest.mark.parametrize("hw", [256, 400])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_by_slabs_matches_jax(wdt, hw, resid):
    fold, coords, ws, _ = _inputs(3, hw, wdt, seed=hw)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    with pltpu.force_tpu_interpret_mode():
        y, acts = jax_fd._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords),
                                     *jw[:3], jw[3][:, None], resid,
                                     emit_acts=True)
    got_y, got_a1 = _forward_by_slabs(fold, coords, ws, wdt, resid)
    _close(got_y.numpy(), np.asarray(y), wdt, "y")
    _close(got_a1.numpy(), np.asarray(acts.astype(jnp.float32))[0], wdt,
           "a1")


ROUTE_CASES = [
    # hw, h, lh, no, tile_kernels, route, single pass
    (4096, 500, 1, 3, False, "sm90", True),     # galaxy, every CLI's default
    (784, 500, 1, 1, False, "sm90", True),      # mnist: ragged last tile
    (4096, 512, 1, 8, False, "sm90", True),
    (256, 40, 1, 2, False, "sm90", True),
    (4096, 513, 1, 3, False, "sm90", False),    # past one column chunk
    (4096, 1000, 1, 3, False, "sm90", False),
    (4096, 500, 2, 3, False, "sm90", False),    # two hidden layers
    (4096, 500, 4, 3, False, "sm90", False),
    (4096, 1000, 3, 8, False, "sm90", False),
    (4096, 288, 2, 3, False, "sm90", False),    # DEEP_MIN_WIDTH
    (4096, 448, 3, 3, False, "sm90", False),
    (4096, 287, 2, 3, False, "tile", False),    # narrower: the tile kernels
    (4096, 447, 4, 3, False, "tile", False),
    (256, 40, 4, 2, False, "tile", False),
    (4096, 500, 1, 3, True, "tile", True),      # the A/B's yardstick
    (4096, 1000, 3, 3, True, "tile", False),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(
    str(x) for x in c[:6]))
def test_route_table(case):
    *args, want, single = case
    assert fd.decoder_route(*args) == want
    assert fd.single_pass(args[1], args[2]) == single


@pytest.mark.parametrize("no", [0, 9])
def test_route_refuses_outputs_the_kernels_do_not_take(no):
    with pytest.raises(ValueError):
        fd.decoder_route(4096, 500, 1, no)


@pytest.mark.parametrize("lh,h", [(2, 24), (4, 447)])
def test_launch_refuses_a_mismatched_route(lh, h, monkeypatch):
    """Deep decoders the route table keeps on the tile kernels: the sm90
    launch refuses them before loading the library."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(fd, "_lib", no_library)
    fold, coords, ws, _ = _inputs(3, 256, torch.float32, h=h)
    whid = np.repeat(ws[0], lh, axis=0)
    bhid = np.repeat(ws[1], lh, axis=0)
    tw = fd.TailWeights(*(torch.from_numpy(w) for w in (whid, bhid, *ws[2:])))
    with pytest.raises(ValueError, match="sm90"):
        fd._launch_fwd(torch.from_numpy(fold), torch.from_numpy(coords), tw,
                       False, 0, "fwd", route="sm90")


@pytest.mark.parametrize("lh,no", [(5, 3), (1, 9)])
def test_launch_refuses_shapes_no_route_takes(lh, no, monkeypatch):
    """Weights the route table sends nowhere (five hidden layers, nine
    outputs; ``TailWeights`` refuses them too, so they are set on it
    directly): the sm90 launch refuses them before loading the library."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(fd, "_lib", no_library)
    fold, coords, ws, _ = _inputs(3, 256, torch.float32)
    tw = fd.TailWeights.__new__(fd.TailWeights)
    tw.whid = torch.from_numpy(np.repeat(ws[0], lh, axis=0))
    tw.bhid = torch.from_numpy(np.repeat(ws[1], lh, axis=0))
    tw.wht = torch.zeros((no, 24))
    tw.bht = torch.zeros((no,))
    with pytest.raises(ValueError, match="sm90"):
        fd._launch_fwd(torch.from_numpy(fold), torch.from_numpy(coords), tw,
                       False, 0, "fwd", route="sm90")


def test_slabs_are_built_once_per_weights():
    _slabs_once(1, 24)


def test_deep_slabs_are_built_once_per_layer():
    _slabs_once(3, 520)


def _slabs_once(lh, h):
    rng = np.random.default_rng(lh)
    ws = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
          .to(torch.bfloat16) for s in ((lh, h, h), (lh, h), (3, h), (3,))]
    tw = fd.TailWeights(*ws)
    kp = fd.slab_k(h)
    for l in range(lh):
        assert tw.sm90_slabs(l) is tw.sm90_slabs(l)
        assert tw.sm90_slabs_t(l) is tw.sm90_slabs_t(l)
        assert tw.sm90_slabs(l).numel() == fd.sm90_rows(h) * kp
        planes = dl.decoder_slab_planes(tw.sm90_slabs_t(l), h, h)
        assert torch.equal(planes[0, :h, :h], tw.whid[l])
        planes = dl.decoder_slab_planes(tw.sm90_slabs(l), h, h)
        assert torch.equal(planes[0, :h, :h], tw.whid[l].T)
