"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the decoder forward with and without its activation output, the backward
with the residual and with recompute, the differentiable op and a training
step; the int8 decoder forward and backward (K4, K5), the fused int8 loss
and gradient (K3) in its Bernoulli, Gaussian, colored and padded families
and its numerics modes (stochastic rounding with the device Philox against
the plain one, the other gradient modes, scales and epilogue), its cluster
passes at the default numerics and under stochastic rounding against the
plain version and the block passes (and their a0 chain and product
alone), the
feature-major kernel's modes (K8), and int8 training steps of the galaxy,
particles, fit-noise and mnist models; Adam (K6, K7 and the
emission helpers), the int8 encoder's GEMM, and steps of the int8 stack;
the probe kernels of the port's measurement tools (every GEMM layout, tile,
arm and accumulator store, the feature-major first layer, the transpose,
the s4 pack); the int8 kernel microbenchmark's kernels (every run of
``spatialvae_torch/tools/kernel_bench.py`` at H = 40, 500 and 513, odd and
even batches, grids in one and in several step groups, and its
multi-product GEMMs at k = 2,048).

Every test here needs a CUDA device (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips without one.  The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit, without the JAX
test configuration:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

The JAX parity of the plain versions is in ``test_torch_port_decoder.py``.
"""

import dataclasses
import math
import os

import pytest
import torch

from spatialvae_torch.config import SpatialGeneratorConfig

from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.models import SpatialGenerator
from spatialvae_torch.transforms.coords import coord_grid
from tests import dec90_layouts as dl

pytestmark = pytest.mark.cuda

# limits as in chip_smoke.py: the largest and the mean absolute error of
# y (TOL) and of the activations (ACTS_TOL); the backward's outputs by their
# error relative to their largest value (BWD_TOL, by weight dtype and
# variant)
TOL = {torch.float32: (5e-6, 1e-6), torch.bfloat16: (5e-4, 1e-5)}
ACTS_TOL = {torch.float32: (5e-5, 5e-6), torch.bfloat16: (1e-2, 1e-5)}
# the activations above H = 2048 (chip_smoke.ACTS_TOL_WIDE: a sound
# kernel's longer sums read up to 5.15e-5 / 6.95e-6 at 4100 in f32, the
# one-TF32-pass copy at least 6.36e-4 / 1.63e-4; bf16 means up to 1.11e-5)
ACTS_TOL_WIDE = {torch.float32: (2e-4, 3e-5), torch.bfloat16: (1e-2, 5e-5)}
# y above H = 2048 (chip_smoke.TOL_WIDE: bf16 means read up to 1.43e-5)
TOL_WIDE = {torch.float32: (5e-6, 1e-6), torch.bfloat16: (5e-4, 5e-5)}
BWD_TOL = {(torch.float32, "residual"): (2e-4, 1e-5),
           (torch.float32, "recompute"): (2e-4, 1e-5),
           (torch.bfloat16, "residual"): (1e-3, 8e-5),
           (torch.bfloat16, "recompute"): (1.5e-3, 3e-4)}

# (Lh, resid, No, weight dtype, HW)
CASES = [
    (1, False, 3, torch.float32, 4096),
    (1, False, 3, torch.bfloat16, 4096),
    (1, True, 1, torch.float32, 784),
    (2, False, 8, torch.float32, 1600),
    (2, True, 3, torch.bfloat16, 784),
    (3, True, 8, torch.float32, 4096),
    (4, False, 1, torch.bfloat16, 256),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(lh, no, hw, wdt, device, b=5, h=500, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, bound):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound

    side = math.isqrt(hw)
    fold = torch.zeros((b, 4, h), device=device)
    fold[:, :2] = u(b, 2, h, bound=0.7)
    fold[:, 2] = u(b, h, bound=1.5)
    bound = 1 / math.sqrt(h)
    return [fold, coord_grid(side, side, device=device)] + [
        u(*s, bound=bound).to(wdt)
        for s in ((lh, h, h), (lh, h), (no, h), (no,))]


def _key(base, lh, no, hw, h=500, tile_kernels=False):
    """The LAUNCHES key a call on ``decoder_route``'s route counts under."""
    route = fd.decoder_route(hw, h, lh, no, tile_kernels)
    return base + ("_sm90" if route == "sm90" else "")


def _passes(lh, h=500, tile_kernels=False):
    """Launches of one forward call (one chunk of images): the deep sm90
    kernels run a pass per layer, the others one launch."""
    if tile_kernels or fd.single_pass(h, lh):
        return 1
    return lh


def _assert_close(got, want, wdt, tol=TOL):
    d = (got.float() - want.float()).abs()
    assert d.max().item() <= tol[wdt][0]
    assert d.mean().item() <= tol[wdt][1]


def _assert_rel(got, want, tol):
    d = (got.float() - want.float()).abs()
    scale = want.abs().max().item() or 1.0
    assert d.max().item() / scale <= tol[0]
    assert d.mean().item() / scale <= tol[1]


def _case_id(c):
    lh, resid, no, wdt, hw = c
    return (f"Lh{lh}-{'resid' if resid else 'plain'}-No{no}-"
            f"{str(wdt)[6:]}-HW{hw}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_plain_version(case, cuda_device):
    lh, resid, no, wdt, hw = case
    args = _inputs(lh, no, hw, wdt, cuda_device)
    key = _key("fwd", lh, no, hw)
    before = fd.LAUNCHES[key]
    with torch.no_grad():
        got = fd.fused_decoder_tail(*args, resid)
        torch.cuda.synchronize()
        want = fd.decoder_tail_reference(*args, resid)
    assert fd.LAUNCHES[key] == before + _passes(lh)
    assert got.shape == (5, no, hw)
    _assert_close(got, want, wdt)


# hidden widths on both sides of the kernels' one design threshold (512:
# shared memory and one 512-column chunk; 513 and up: the per-block
# workspace in global memory and 512-column chunks), the galaxy wide
# configuration (1000), whole and ragged chunks, and a ragged width above
# every chunk count the other widths reach (4100, at a small batch)
WIDTHS = [512, 513, 768, 1000, 1024, 2048, 4100]


def _wide_b(h):
    return 2 if h > 2048 else 3


@pytest.mark.parametrize("h", WIDTHS)
def test_kernel_at_max_hidden(h, cuda_device):
    """K1 at and past the 512 threshold, on the route (the deep kernels'
    column chunks above 512, a pass per layer) and on the tile kernels:
    with and without the activation output, f32 and bf16, against the
    plain version; no width raises."""
    for wdt, resid in ((torch.float32, True), (torch.bfloat16, False)):
        fold, coords, *ws = _inputs(2, 3, 784, wdt, cuda_device,
                                    b=_wide_b(h), h=h)
        with torch.no_grad():
            want, acts_ref = fd.decoder_tail_reference(
                fold, coords, *ws, resid, return_acts=True)
        wide = h > 2048
        for tile in (False, True):
            fd.reset_launches()
            with torch.no_grad():
                got = fd.run_decoder_tail(fold, coords, fd.TailWeights(*ws),
                                          resid, tile_kernels=tile)
                y, acts = fd.run_decoder_tail_acts(
                    fold, coords, fd.TailWeights(*ws), resid,
                    tile_kernels=tile)
                torch.cuda.synchronize()
            k = "" if tile else "_sm90"
            n = _passes(2, h, tile)
            assert fd.LAUNCHES["fwd" + k] == fd.LAUNCHES["fwd_acts" + k] == n
            _assert_close(got, want, wdt, TOL_WIDE if wide else TOL)
            _assert_close(y, want, wdt, TOL_WIDE if wide else TOL)
            _assert_close(acts, acts_ref, wdt,
                          ACTS_TOL_WIDE if wide else ACTS_TOL)


@pytest.mark.parametrize("variant", ["residual", "recompute"])
@pytest.mark.parametrize("h", WIDTHS)
def test_backward_at_any_width(h, variant, cuda_device):
    """K2 at every width of WIDTHS, both variants, f32 and bf16."""
    for wdt, resid, lh in ((torch.float32, False, 2),
                           (torch.bfloat16, True, 1)):
        b = _wide_b(h)
        fold, coords, *ws = _inputs(lh, 3, 784, wdt, cuda_device, b=b, h=h)
        g = torch.randn((b, 3, 784), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
        tw = fd.TailWeights(*ws)
        with torch.no_grad():
            y, acts = fd.run_decoder_tail_acts(fold, coords, tw, resid)
            a = acts if variant == "residual" else None
            got = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g,
                                               resid)
            want = fd.decoder_tail_backward_reference(fold, coords, *ws[:3],
                                                      a, y, g, resid)
        for u, w in zip(got, want):
            _assert_rel(u, w, BWD_TOL[wdt, variant])


def test_fused_generator_runs_kernel(cuda_device):
    cfg = SpatialGeneratorConfig(latent_dim=4, hidden_dim=500, n_out=3,
                                 num_layers=2, softplus=True)
    gen = SpatialGenerator(cfg, generator=torch.Generator().manual_seed(1))
    gen_cuda = SpatialGenerator(cfg, device=cuda_device)
    gen_cuda.load_state_dict(gen.state_dict())
    z = torch.randn((4, 4), generator=torch.Generator().manual_seed(2))
    before = fd.LAUNCHES["fwd_sm90"]
    with torch.no_grad():
        got = fd.fused_spatial_generator(
            gen_cuda, coord_grid(64, 64, device=cuda_device), None, None,
            z.to(cuda_device))
        want = fd.fused_spatial_generator(gen, coord_grid(64, 64), None,
                                          None, z)
    assert fd.LAUNCHES["fwd_sm90"] == before + 1
    _assert_close(got.cpu(), want, torch.float32)


def test_wrapper_raises_instead_of_falling_back(cuda_device):
    args = _inputs(1, 3, 256, torch.float32, cuda_device)
    args[2] = args[2].half()
    with pytest.raises(TypeError):
        fd.fused_decoder_tail(*args)
    args = _inputs(1, 3, 256, torch.float32, cuda_device)
    args[0] = args[0].cpu()
    with pytest.raises(ValueError, match="several devices"):
        fd.fused_decoder_tail(*args)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_with_activations_matches_plain_version(case, cuda_device):
    lh, resid, no, wdt, hw = case
    fold, coords, *ws = _inputs(lh, no, hw, wdt, cuda_device)
    key = _key("fwd_acts", lh, no, hw)
    before = fd.LAUNCHES[key]
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, fd.TailWeights(*ws),
                                           resid)
        torch.cuda.synchronize()
        y_ref, acts_ref = fd.decoder_tail_reference(fold, coords, *ws, resid,
                                                    return_acts=True)
    assert fd.LAUNCHES[key] == before + _passes(lh)
    assert acts.dtype == wdt and acts.shape == (lh, 5, hw, 500)
    _assert_close(y, y_ref, wdt)
    _assert_close(acts, acts_ref, wdt, ACTS_TOL)


@pytest.mark.parametrize("variant", ["residual", "recompute"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_backward_matches_plain_version(case, variant, cuda_device):
    """Both variants against ``decoder_tail_backward_reference`` on the same
    inputs and cotangent; two runs agree bit for bit (no atomics)."""
    lh, resid, no, wdt, hw = case
    fold, coords, *ws = _inputs(lh, no, hw, wdt, cuda_device)
    g = torch.randn((5, no, hw), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    tw = fd.TailWeights(*ws)
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, resid)
        a = acts if variant == "residual" else None
        got = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid)
        again = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid)
        want = fd.decoder_tail_backward_reference(fold, coords, *ws[:3], a,
                                                  y, g, resid)
    for u, v, w in zip(got, again, want):
        assert torch.equal(u, v)
        _assert_rel(u, w, BWD_TOL[wdt, variant])


def test_backward_in_image_chunks(cuda_device):
    """A workspace bound that forces three chunks of images gives the
    one-chunk result up to the split-K chunks' summation order (the tile
    kernels; the deep kernels' in ``test_deep_backward_in_image_chunks``)."""
    fold, coords, *ws = _inputs(2, 3, 784, torch.float32, cuda_device, b=7)
    g = torch.randn((7, 3, 784), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    tw = fd.TailWeights(*ws)
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, True,
                                           tile_kernels=True)
        for a in (acts, None):
            before = fd.LAUNCHES["bwd_chain"]
            one = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, True,
                                               tile_kernels=True)
            per_image = 2 * 784 * 500 * (4 if a is not None else 8)
            three = fd.run_decoder_tail_backward(
                fold, coords, tw, a, y, g, True,
                workspace_bytes=3 * per_image, tile_kernels=True)
            assert fd.LAUNCHES["bwd_chain"] == before + 1 + 3
            for u, v in zip(three, one):
                _assert_rel(u, v, BWD_TOL[torch.float32, "residual"])


def test_autograd_op_runs_the_kernels(cuda_device):
    """Gradients of the fused generator on the card come from the kernels
    (one emitting forward, one chain, one dW and four reductions) and
    agree with the op's CPU path."""
    cfg = SpatialGeneratorConfig(latent_dim=4, hidden_dim=500, n_out=3,
                                 num_layers=2)
    gen = SpatialGenerator(cfg, generator=torch.Generator().manual_seed(3))
    gen_cuda = SpatialGenerator(cfg, device=cuda_device)
    gen_cuda.load_state_dict(gen.state_dict())
    z = torch.randn((4, 4), generator=torch.Generator().manual_seed(4))
    fd.reset_launches()
    for g_, dev in ((gen_cuda, cuda_device), (gen, torch.device("cpu"))):
        y = fd.fused_spatial_generator(g_, coord_grid(64, 64, device=dev),
                                       None, None, z.to(dev))
        torch.sin(3.0 * y).sum().backward()
    assert fd.LAUNCHES == {"fwd": 0, "fwd_acts": 0, "fwd_recompute": 0,
                           "bwd_chain": 0, "bwd_dw": 0, "bwd_sum": 4,
                           "fwd_sm90": 0, "fwd_acts_sm90": 1,
                           "fwd_recompute_sm90": 0, "bwd_chain_sm90": 1,
                           "bwd_dw_sm90": 1}
    for p, q in zip(gen_cuda.parameters(), gen.parameters()):
        if q.grad is not None:
            _assert_rel(p.grad.cpu(), q.grad,
                        BWD_TOL[torch.float32, "residual"])


def test_training_step_on_the_card(cuda_device):
    from spatialvae_torch.config import InferenceConfig

    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=2)
    tr = Trainer(q_cfg, p_cfg, ElboConfig(fused=True, channels=3),
                 TrainConfig(minibatch_size=8), coord_grid(64, 64,
                                                           device=cuda_device))
    y = torch.rand((8, 4096, 3), device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(5))
    fd.reset_launches()
    aux = tr.train_step(y)
    assert torch.isfinite(aux).all()
    assert fd.LAUNCHES["fwd_acts_sm90"] == fd.LAUNCHES["bwd_chain_sm90"] == 1
    assert fd.LAUNCHES["fwd_sm90"] == 0 and tr.opt_state.count == 1


def test_eval_after_a_step_matches_a_fresh_copy(cuda_device):
    """The float decoder's no-grad path caches the tail weights; Adam's
    kernels write the weights through raw pointers and then move their
    version counters, so an evaluation after a training step decodes with
    the new weights: it equals that of a fresh trainer holding the same
    weights (whose cache is empty)."""
    from spatialvae_torch.config import InferenceConfig

    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=40 * 40, latent_dim=5, hidden_dim=500,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=500, n_out=1,
                                   num_layers=2)

    def trainer():
        return Trainer(q_cfg, p_cfg, ElboConfig(fused=True,
                                                likelihood="gaussian"),
                       TrainConfig(minibatch_size=16),
                       coord_grid(40, 40, device=cuda_device),
                       device=cuda_device)

    g = torch.Generator(cuda_device).manual_seed(6)
    y = torch.randn((16, 1600), device=cuda_device, generator=g)
    data = y[:10]
    tr = trainer()
    before = tr.eval_epoch(data, 0)          # fills the tail-weight cache
    tr.train_step(y)
    after = tr.eval_epoch(data, 0)
    fresh = trainer()
    fresh.q_net.load_state_dict(tr.q_net.state_dict())
    fresh.p_net.load_state_dict(tr.p_net.state_dict())
    assert after != before
    assert after == fresh.eval_epoch(data, 0)


# ---------------------------------------------------------------------------
# K1 and K2 on clusters (decoder_route "sm90") against the plain versions
# and the tile kernels (tile_kernels=True)
# ---------------------------------------------------------------------------

# (No, HW): one output at mnist's ragged 784, the galaxy's, eight outputs
SM90_SHAPES = [(1, 784), (3, 4096), (8, 784)]
SM90_DTYPES = [torch.float32, torch.bfloat16]


def _sm90_id(v):
    if isinstance(v, tuple):
        return f"No{v[0]}-HW{v[1]}"
    if isinstance(v, torch.dtype):
        return str(v)[6:]
    return "resid" if v else "plain"


@pytest.mark.parametrize("resid", [False, True], ids=_sm90_id)
@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
@pytest.mark.parametrize("shape", SM90_SHAPES, ids=_sm90_id)
def test_sm90_forward_against_plain_and_tile(shape, wdt, resid,
                                             cuda_device):
    """Both emit modes on the route and on the tile kernels: each within
    TOL / ACTS_TOL of the plain version and of the other; reruns bit for
    bit; each launch under its route's key."""
    no, hw = shape
    fold, coords, *ws = _inputs(1, no, hw, wdt, cuda_device)
    tw = fd.TailWeights(*ws)
    fd.reset_launches()
    with torch.no_grad():
        y = fd.run_decoder_tail(fold, coords, tw, resid)
        y2, acts = fd.run_decoder_tail_acts(fold, coords, tw, resid)
        y_again = fd.run_decoder_tail(fold, coords, tw, resid)
        _, acts_again = fd.run_decoder_tail_acts(fold, coords, tw, resid)
        y_t = fd.run_decoder_tail(fold, coords, tw, resid, tile_kernels=True)
        _, acts_t = fd.run_decoder_tail_acts(fold, coords, tw, resid,
                                             tile_kernels=True)
        torch.cuda.synchronize()
        want, acts_ref = fd.decoder_tail_reference(fold, coords, *ws, resid,
                                                   return_acts=True)
    assert fd.LAUNCHES["fwd_sm90"] == fd.LAUNCHES["fwd_acts_sm90"] == 2
    assert fd.LAUNCHES["fwd"] == fd.LAUNCHES["fwd_acts"] == 1
    assert acts.dtype == wdt and acts.shape == (1, 5, hw, 500)
    assert torch.equal(y, y_again) and torch.equal(acts, acts_again)
    assert torch.equal(y, y2)
    for got in (y, y_t):
        _assert_close(got, want, wdt)
    _assert_close(y, y_t, wdt)
    for got in (acts, acts_t):
        _assert_close(got, acts_ref, wdt, ACTS_TOL)
    _assert_close(acts, acts_t, wdt, ACTS_TOL)


@pytest.mark.parametrize("variant", ["residual", "recompute"])
@pytest.mark.parametrize("resid", [False, True], ids=_sm90_id)
@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
@pytest.mark.parametrize("shape", SM90_SHAPES, ids=_sm90_id)
def test_sm90_backward_against_plain_and_tile(shape, wdt, resid, variant,
                                              cuda_device):
    """The chain and dW1 on clusters against the plain version and the tile
    kernels within BWD_TOL; two runs bit for bit; the route's keys."""
    no, hw = shape
    fold, coords, *ws = _inputs(1, no, hw, wdt, cuda_device)
    g = torch.randn((5, no, hw), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    tw = fd.TailWeights(*ws)
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, resid)
        a = acts if variant == "residual" else None
        fd.reset_launches()
        got = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid)
        again = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid)
        tile = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid,
                                            tile_kernels=True)
        want = fd.decoder_tail_backward_reference(fold, coords, *ws[:3], a,
                                                  y, g, resid)
    rec = int(a is None)
    assert fd.LAUNCHES == {"fwd": 0, "fwd_acts": 0, "fwd_recompute": rec,
                           "bwd_chain": 1, "bwd_dw": 1, "bwd_sum": 12,
                           "fwd_sm90": 0, "fwd_acts_sm90": 0,
                           "fwd_recompute_sm90": 2 * rec,
                           "bwd_chain_sm90": 2, "bwd_dw_sm90": 2}
    for u, v, t, w in zip(got, again, tile, want):
        assert torch.equal(u, v)
        _assert_rel(u, w, BWD_TOL[wdt, variant])
        _assert_rel(u, t, BWD_TOL[wdt, variant])


@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
def test_sm90_walk_writes_every_tile(wdt, cuda_device):
    """The clusters' walk over the (image, 64-pixel tile) blocks, through
    the kernel: at mnist's ragged 784 pixels (13 tiles an image), with more
    quads of tiles than twice the resident clusters (every CTA runs two
    tiles or more, some three) and a padded last quad, the emitting
    forward writes
    every element of y and of the activations (both filled with NaN
    first), each within TOL / ACTS_TOL of the plain version."""
    ncl = fd._lib().svt_decoder90_max_clusters(int(wdt == torch.bfloat16))
    b = 1
    while -(-13 * b // 4) <= 2 * ncl or 13 * b % 4 == 0:
        b += 1
    fold, coords, *ws = _inputs(1, 3, 784, wdt, cuda_device, b=b)
    tw = fd.TailWeights(*ws)
    y = torch.full((b, 3, 784), math.nan, device=cuda_device)
    acts = torch.full((1, b, 784, 500), math.nan, device=cuda_device,
                      dtype=wdt)
    with torch.no_grad():
        fd._launch_fwd(fold, coords, tw, False, 2 if wdt == torch.bfloat16
                       else 1, "fwd_acts", y, acts, route="sm90")
        torch.cuda.synchronize()
        want, acts_ref = fd.decoder_tail_reference(fold, coords, *ws,
                                                   return_acts=True)
    assert torch.isfinite(y).all() and torch.isfinite(acts).all()
    _assert_close(y, want, wdt)
    _assert_close(acts, acts_ref, wdt, ACTS_TOL)


def test_sm90_backward_in_image_chunks(cuda_device):
    """A workspace bound that forces three chunks of images on the route
    gives the one-chunk result up to the split-K partials' order."""
    fold, coords, *ws = _inputs(1, 3, 784, torch.float32, cuda_device, b=7)
    g = torch.randn((7, 3, 784), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    tw = fd.TailWeights(*ws)
    lib = fd._lib()
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, True)
        for a in (acts, None):
            before = fd.LAUNCHES["bwd_chain_sm90"]
            one = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, True)
            per_image = 13 * 2 * lib.svt_decoder90_ws_block(0) + (
                0 if a is not None else 784 * 500 * 4)
            three = fd.run_decoder_tail_backward(
                fold, coords, tw, a, y, g, True,
                workspace_bytes=3 * per_image)
            assert fd.LAUNCHES["bwd_chain_sm90"] == before + 1 + 3
            for u, v in zip(three, one):
                _assert_rel(u, v, BWD_TOL[torch.float32, "residual"])


@pytest.mark.parametrize("splits", [5, 12])
@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
def test_sm90_dw_matches_its_plain_version(wdt, splits, cuda_device):
    """The dW1 kernel alone on workspaces laid out by ``dec90_ws_layout``:
    its split-K partials against ``dec90_dw_reference`` (f64), within 1e-5
    of each partial's largest value (f32 accumulation over 64 pixels a
    block); 12 splits of 37 blocks leave the last two partials empty (zero)."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    nb, h = 37, 500
    a0 = torch.rand((nb, 64, fd.SM90_WIDTH), generator=gen,
                    device=cuda_device) * 2 - 1
    dh = torch.randn((nb, 64, fd.SM90_WIDTH), generator=gen,
                     device=cuda_device)
    ws_a0 = dl.dec90_ws_layout(a0.to(wdt))
    ws_dh = dl.dec90_ws_layout(dh.to(wdt))
    part = torch.empty((splits, h, h), device=cuda_device)
    lib = fd._lib()
    with torch.cuda.device(cuda_device):
        fd._call(lib, "svt_decoder90_dw", ws_a0.data_ptr(), ws_dh.data_ptr(),
                 part.data_ptr(), nb, h, splits, int(wdt == torch.bfloat16),
                 fd._stream(part))
    want = dl.dec90_dw_reference(ws_a0, ws_dh, nb, h, splits)
    for s in range(splits):
        if not want[s].any():
            assert not part[s].any()
            continue
        _assert_rel(part[s], want[s], (1e-5, 1e-6))


def test_sm90_entry_points_refuse_other_calls(cuda_device):
    """The C entry points refuse what ``decoder_route`` and
    ``single_pass`` do not send them: the default-shape kernels two hidden
    layers, H > 512, nine outputs; the deep kernels one hidden layer at
    most 512 wide, five layers, nine outputs, a layer's missing buffers
    (the narrow deep decoders the route keeps on the tile kernels are
    ``_require_route``'s to refuse: ``test_torch_port_decoder_sm90.py``)."""
    lib = fd._lib()
    buf = torch.zeros(1 << 20, device=cuda_device)
    p = buf.data_ptr()
    st = fd._stream(buf)
    for h, lh, no in ((500, 2, 3), (600, 1, 3), (500, 1, 9)):
        assert lib.svt_decoder90_fwd(p, p, p, p, p, p, p, None, 1, 256, h, lh,
                                     no, 0, 0, 0, st) != 0
        assert lib.svt_decoder90_chain(p, p, p, p, p, p, p, p, p, p, p, 1,
                                       256, h, lh, no, 0, 0, 0, st) != 0
    assert lib.svt_decoder90_dw(p, p, p, 4, 600, 1, 0, st) != 0
    for h, lh, no in ((500, 1, 3), (500, 5, 3), (600, 1, 9)):
        assert lib.svt_decoder90_layer(p, p, p, p, p, p, None, p, None, p, 1,
                                       256, h, lh, no, 1, 0, 0, st) != 0
        assert lib.svt_decoder90_chain_layer(
            p, p, p, p, p, None, None, None, p, p, p, p, p, p, 1, 256, h, lh,
            no, 1, 0, 0, 0, st) != 0
    # layer 2 of 3 without its input buffer, or without its output; the
    # chain's middle layer without its da buffers
    assert lib.svt_decoder90_layer(p, p, p, p, p, p, None, p, None, p, 1, 256,
                                   500, 3, 3, 2, 0, 0, st) != 0
    assert lib.svt_decoder90_layer(p, p, p, p, p, p, p, None, p, p, 1, 256,
                                   500, 3, 3, 2, 0, 1, st) != 0
    assert lib.svt_decoder90_chain_layer(
        p, p, p, p, p, p, None, None, p, p, p, p, p, p, 1, 256, 500, 3, 3, 2,
        0, 0, 0, st) != 0
    assert lib.svt_decoder90_dw_deep(p, p, p, 4, 600, 5, 600 * 600, 0,
                                     st) != 0
    torch.cuda.synchronize()


def test_sm90_training_step_matches_plain(cuda_device):
    """One float step's gradients through the route (K1 emitting, K2 on
    clusters) against the same step through the plain folded decoder,
    every leaf within chip_smoke.STEP_TOL of its largest value."""
    from spatialvae_torch.config import InferenceConfig

    from spatialvae_torch.objectives import ElboConfig, loss_and_grad
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=2)
    ecfg = ElboConfig(fused=True, channels=3)
    tr = Trainer(q_cfg, p_cfg, ecfg, TrainConfig(minibatch_size=8),
                 coord_grid(64, 64, device=cuda_device))
    gen = torch.Generator(cuda_device).manual_seed(6)
    y = torch.rand((8, 4096, 3), device=cuda_device, generator=gen)
    noise = torch.randn((8, 23), device=cuda_device, generator=gen)
    grads = {}
    for fused in (True, False):
        fd.reset_launches()
        loss_and_grad(tr.q_net, tr.p_net,
                      dataclasses.replace(ecfg, fused=fused), tr.coords, y,
                      noise=noise, mask=tr.mask)
        grads[fused] = {k: p.grad.clone()
                        for k, p in tr.named_params().items()}
        if fused:
            assert fd.LAUNCHES["fwd_acts_sm90"] == 1
            assert fd.LAUNCHES["bwd_chain_sm90"] == 1
            assert fd.LAUNCHES["bwd_dw_sm90"] == 1
    for k, g in grads[True].items():
        _assert_rel(g, grads[False][k], (2e-4, 3e-5))


# ---------------------------------------------------------------------------
# K1 and K2's deep kernels (csrc/fused_decoder_sm90_deep.cu: H > 512, Lh =
# 2..4) against the plain versions and the tile kernels
# ---------------------------------------------------------------------------

# (Lh, H): the column chunks at every width of WIDTHS past 512 (whole and
# ragged chunks), the layer passes at Lh = 2..4 from the narrowest width
# the route sends them (fused_decoder.DEEP_MIN_WIDTH), and both at once
DEEP_SHAPES = [(1, h) for h in WIDTHS if h > 512] + [
    (2, 290), (2, 500), (3, 450), (3, 500), (4, 500), (2, 1000), (3, 1000)]


def _deep_b(h):
    return 2 if h > 2048 else 3


def _deep_tols(h):
    wide = h > 2048
    return (TOL_WIDE if wide else TOL), (ACTS_TOL_WIDE if wide else ACTS_TOL)


@pytest.mark.parametrize("resid", [False, True], ids=_sm90_id)
@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
@pytest.mark.parametrize("shape", DEEP_SHAPES,
                         ids=lambda s: f"Lh{s[0]}-H{s[1]}")
def test_deep_forward_against_plain_and_tile(shape, wdt, resid,
                                             cuda_device):
    """Both emit modes on the deep kernels and on the tile kernels at 784
    pixels (a ragged last tile): y and the activations (both filled with
    NaN first, so every element must be written) within TOL / ACTS_TOL of
    the plain version and of the other design; reruns bit for bit; a pass
    per layer under the route's keys."""
    lh, h = shape
    b, hw, no = _deep_b(h), 784, 3
    fold, coords, *ws = _inputs(lh, no, hw, wdt, cuda_device, b=b, h=h)
    tw = fd.TailWeights(*ws)
    tol, acts_tol = _deep_tols(h)
    fd.reset_launches()
    y = torch.full((b, no, hw), math.nan, device=cuda_device)
    acts = torch.full((lh, b, hw, h), math.nan, device=cuda_device,
                      dtype=wdt)
    with torch.no_grad():
        got = fd.run_decoder_tail(fold, coords, tw, resid)
        again = fd.run_decoder_tail(fold, coords, tw, resid)
        fd._launch_fwd(fold, coords, tw, resid, 2 if wdt == torch.bfloat16
                       else 1, "fwd_acts", y, acts, route="sm90")
        y_t = fd.run_decoder_tail(fold, coords, tw, resid, tile_kernels=True)
        _, acts_t = fd.run_decoder_tail_acts(fold, coords, tw, resid,
                                             tile_kernels=True)
        torch.cuda.synchronize()
        want, acts_ref = fd.decoder_tail_reference(fold, coords, *ws, resid,
                                                   return_acts=True)
    assert fd.LAUNCHES["fwd_sm90"] == 2 * lh
    assert fd.LAUNCHES["fwd_acts_sm90"] == lh
    assert fd.LAUNCHES["fwd"] == fd.LAUNCHES["fwd_acts"] == 1
    assert torch.isfinite(y).all() and torch.isfinite(acts).all()
    assert torch.equal(got, again) and torch.equal(got, y)
    for u in (got, y_t):
        _assert_close(u, want, wdt, tol)
    _assert_close(got, y_t, wdt, tol)
    for u in (acts, acts_t):
        _assert_close(u, acts_ref, wdt, acts_tol)
    _assert_close(acts, acts_t, wdt, acts_tol)


@pytest.mark.parametrize("variant", ["residual", "recompute"])
@pytest.mark.parametrize("resid", [False, True], ids=_sm90_id)
@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
@pytest.mark.parametrize("shape", DEEP_SHAPES,
                         ids=lambda s: f"Lh{s[0]}-H{s[1]}")
def test_deep_backward_against_plain_and_tile(shape, wdt, resid, variant,
                                              cuda_device):
    """The chain passes and each layer's dW against the plain version and
    the tile kernels within BWD_TOL; two runs bit for bit; a chain and a
    dW launch per layer."""
    lh, h = shape
    b, hw, no = _deep_b(h), 784, 3
    fold, coords, *ws = _inputs(lh, no, hw, wdt, cuda_device, b=b, h=h)
    g = torch.randn((b, no, hw), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    tw = fd.TailWeights(*ws)
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, resid)
        a = acts if variant == "residual" else None
        fd.reset_launches()
        got = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid)
        again = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid)
        tile = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, resid,
                                            tile_kernels=True)
        want = fd.decoder_tail_backward_reference(fold, coords, *ws[:3], a,
                                                  y, g, resid)
    rec = int(a is None)
    assert fd.LAUNCHES["fwd_recompute_sm90"] == 2 * rec * lh
    assert fd.LAUNCHES["bwd_chain_sm90"] == fd.LAUNCHES["bwd_dw_sm90"] \
        == 2 * lh
    assert fd.LAUNCHES["bwd_chain"] == fd.LAUNCHES["bwd_dw"] == 1
    for u, v, t, w in zip(got, again, tile, want):
        assert torch.equal(u, v)
        _assert_rel(u, w, BWD_TOL[wdt, variant])
        _assert_rel(u, t, BWD_TOL[wdt, variant])


def test_deep_backward_in_image_chunks(cuda_device):
    """A workspace bound that forces three chunks of images on the deep
    kernels gives the one-chunk result up to the split-K partials' order."""
    lh, h, b = 3, 600, 7
    fold, coords, *ws = _inputs(lh, 3, 784, torch.float32, cuda_device, b=b,
                                h=h)
    g = torch.randn((b, 3, 784), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    tw = fd.TailWeights(*ws)
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, True)
        for a in (acts, None):
            before = fd.LAUNCHES["bwd_chain_sm90"]
            one = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g, True)
            per_image = 13 * 2 * fd.deep_ws_block(h, False) + (
                (2 if a is not None else 2 + lh) * 784 * h * 4)
            three = fd.run_decoder_tail_backward(
                fold, coords, tw, a, y, g, True,
                workspace_bytes=3 * per_image)
            assert fd.LAUNCHES["bwd_chain_sm90"] == before + lh * (1 + 3)
            for u, v in zip(three, one):
                _assert_rel(u, v, BWD_TOL[torch.float32, "residual"])


@pytest.mark.parametrize("h", [600, 1030])
@pytest.mark.parametrize("wdt", SM90_DTYPES, ids=_sm90_id)
def test_deep_dw_matches_its_plain_version(wdt, h, cuda_device):
    """The deep dW kernel alone on workspaces of ``sm90_rows(h)`` rows laid
    out by ``dec90_ws_layout``: its split-K partials, written at a stride
    of two (H, H) matrices, against ``dec90_dw_reference`` (f64) within
    1e-5 of each partial's largest value."""
    gen = torch.Generator(cuda_device).manual_seed(3)
    nb, splits, rows = 37, 5, fd.sm90_rows(h)
    a0 = torch.rand((nb, 64, rows), generator=gen, device=cuda_device) * 2 - 1
    dh = torch.randn((nb, 64, rows), generator=gen, device=cuda_device)
    ws_a = dl.dec90_ws_layout(a0.to(wdt))
    ws_dh = dl.dec90_ws_layout(dh.to(wdt))
    part = torch.zeros((splits, 2, h, h), device=cuda_device)
    lib = fd._lib()
    assert lib.svt_decoder90_deep_ws_block(h, int(wdt == torch.bfloat16)) \
        == fd.deep_ws_block(h, wdt == torch.bfloat16)
    with torch.cuda.device(cuda_device):
        fd._call(lib, "svt_decoder90_dw_deep", ws_a.data_ptr(),
                 ws_dh.data_ptr(), part[:, 1].data_ptr(), nb, h, splits,
                 2 * h * h, int(wdt == torch.bfloat16), fd._stream(part))
    want = dl.dec90_dw_reference(ws_a.cpu(), ws_dh.cpu(), nb, h, splits,
                                 rows)
    assert not part[:, 0].any()
    for s in range(splits):
        _assert_rel(part[s, 1].cpu(), want[s], (1e-5, 1e-6))


def test_deep_training_step_matches_plain(cuda_device):
    """One float step of a decoder with four layers (Lh = 3) through the
    deep kernels against the same step through the plain folded decoder,
    every leaf within chip_smoke.STEP_TOL of its largest value."""
    from spatialvae_torch.config import InferenceConfig

    from spatialvae_torch.objectives import ElboConfig, loss_and_grad
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=4)
    ecfg = ElboConfig(fused=True, channels=3)
    tr = Trainer(q_cfg, p_cfg, ecfg, TrainConfig(minibatch_size=8),
                 coord_grid(64, 64, device=cuda_device))
    gen = torch.Generator(cuda_device).manual_seed(6)
    y = torch.rand((8, 4096, 3), device=cuda_device, generator=gen)
    noise = torch.randn((8, 23), device=cuda_device, generator=gen)
    grads = {}
    for fused in (True, False):
        fd.reset_launches()
        loss_and_grad(tr.q_net, tr.p_net,
                      dataclasses.replace(ecfg, fused=fused), tr.coords, y,
                      noise=noise, mask=tr.mask)
        grads[fused] = {k: p.grad.clone()
                        for k, p in tr.named_params().items()}
        if fused:
            assert fd.LAUNCHES["fwd_acts_sm90"] == 3
            assert fd.LAUNCHES["bwd_chain_sm90"] == 3
            assert fd.LAUNCHES["bwd_dw_sm90"] == 3
    for k, g in grads[True].items():
        _assert_rel(g, grads[False][k], (2e-4, 3e-5))


# ---------------------------------------------------------------------------
# the int8 kernels: K3, K4, K5 (limits as in chip_smoke.py)
# ---------------------------------------------------------------------------

INT8_TOL = (1e-3, 2e-5)       # relative to max|plain|: max, mean
INT8_Y_TOL = (1e-5, 1e-6)     # absolute
INT8_A1_TOL = (1e-2, 1e-6)


def _int8_inputs(b, hw, h, no, wdt, device, seed=0):
    fold, coords, whid, bhid, wht, bht = _inputs(1, no, hw, wdt, device, b=b,
                                                 h=h, seed=seed)
    return fold, coords, (whid[0].contiguous(), bhid[0].contiguous(), wht,
                          bht)


# (B, HW, H, No, weight dtype): galaxy, a ragged HW and H, one output
INT8_CASES = [(6, 4096, 500, 3, torch.bfloat16), (5, 4096, 500, 3,
                                                  torch.float32),
              (4, 1024, 96, 1, torch.bfloat16), (3, 784, 130, 8,
                                                 torch.float32)]


@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: "-".join(
    map(str, c[:4])) + f"-{str(c[4])[6:]}")
def test_int8_tail_matches_plain_version(case, cuda_device):
    """K4 with and without a1, K5 with the residual and with recompute,
    against the plain versions; two backward runs agree bit for bit."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    b, hw, h, no, wdt = case
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    g = torch.randn((b, no, hw), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    w = d8.Int8Weights(*ws)
    ref = (w.w1q, w.sw, w.b1, w.wht)
    d8.reset_launches()
    with torch.no_grad():
        y, a1 = d8.run_int8_tail(fold, coords, w, emit_a1=True)
        y0 = d8.run_int8_tail(fold, coords, w)
        y_ref, a1_ref = d8.decoder_tail_int8_reference(
            fold, coords, *ref, w.bht, return_a1=True)
        for got, want, tol in ((y, y_ref, INT8_Y_TOL), (y0, y_ref, INT8_Y_TOL),
                               (a1, a1_ref, INT8_A1_TOL)):
            d = (got.float() - want.float()).abs()
            assert d.max().item() <= tol[0] and d.mean().item() <= tol[1]
        for a in (a1, None):
            got = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            again = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            want = d8.decoder_tail_int8_backward_reference(
                fold, coords, *ref, a, y, g)
            for u, v, x in zip(got, again, want):
                assert torch.equal(u, v)
                _assert_rel(u, x, INT8_TOL)
    sfx = "_sm90" if d8.int8_route(hw, h) == "sm90" else ""
    alone = d8.int8_route(hw, h, k4_alone_f32=wdt == torch.float32)
    assert d8.LAUNCHES["fwd" + ("_sm90" if alone == "sm90" else "")] == 1
    assert d8.LAUNCHES["fwd_acts" + sfx] == 1
    assert (d8.LAUNCHES["bwd_scale" + sfx] == d8.LAUNCHES["bwd_grad" + sfx]
            == 4)


@pytest.mark.parametrize("case", [(6, 4096, 500, 3, torch.bfloat16, True),
                                  (4, 4096, 500, 3, torch.float32, False),
                                  (2, 1024, 96, 1, torch.bfloat16, False),
                                  (4, 1024, 130, 8, torch.float32, True)],
                         ids=lambda c: f"B{c[0]}-HW{c[1]}-H{c[2]}-No{c[3]}"
                         f"-{str(c[4])[6:]}-{'i8' if c[5] else 'f32t'}")
def test_loss_kernel_matches_plain_version(case, cuda_device):
    """K3 against its plain version, with int8 or float targets and a
    mask; two runs agree bit for bit; image chunks give the same result."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    b, hw, h, no, wdt, i8 = case
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    k = torch.randint(0, 256, (b, no, hw), generator=gen, device=cuda_device)
    yt = (k - 128).to(torch.int8) if i8 else k.float() / 255
    mask = (torch.rand(hw, generator=gen, device=cuda_device) > 0.3).float()
    l8.reset_launches()
    with torch.no_grad():
        got = l8.run_loss_int8(fold, coords, *ws, yt, mask)
        again = l8.run_loss_int8(fold, coords, *ws, yt, mask)
        chunked = l8.run_loss_int8(fold, coords, *ws, yt, mask,
                                   workspace_bytes=2 * 64 * hw * 2)
        want = l8.loss_int8_reference(fold, coords, *ws, yt, mask)
    for u, v, c, x in zip(got, again, chunked, want):
        assert torch.equal(u, v)
        _assert_rel(c, u, (1e-6, 1e-7))
        _assert_rel(u, x, INT8_TOL)
    # the default numerics take the cluster passes: the chunked call runs
    # forward, gradient and dW1 per image
    assert l8.LAUNCHES["fwd_sm90"] == l8.LAUNCHES["grad_sm90"] == 2 + b
    assert l8.LAUNCHES["dw_sm90"] == 2 + b
    assert l8.LAUNCHES["fwd"] == l8.LAUNCHES["grad"] == l8.LAUNCHES["dw"] == 0


# (family, image side, H, weight dtype, int8 targets, mask): the Gaussian
# family aligned and over the padded 65x65 and 33x33 grids (17 and 5 groups
# of 256), the padded 28x28 Bernoulli, the colored family at one and at four
# groups per image and at the narrowest tiling (48x48: 9 groups of 256)
FAMILY_CASES = [
    ("gaussian", 64, 500, torch.bfloat16, False, True),
    ("gaussian", 65, 500, torch.float32, False, True),
    ("gaussian", 33, 96, torch.bfloat16, True, False),
    ("bernoulli", 28, 500, torch.bfloat16, True, False),
    ("bernoulli", 28, 130, torch.float32, False, True),
    ("colored", 64, 500, torch.bfloat16, False, True),
    ("colored", 64, 500, torch.float32, True, False),
    ("colored", 32, 96, torch.float32, False, True),
    ("colored", 48, 130, torch.bfloat16, False, False),
]


@pytest.mark.parametrize("case", FAMILY_CASES, ids=lambda c: "-".join(
    [c[0], f"{c[1]}px", f"H{c[2]}", str(c[3])[6:], "i8" if c[4] else "bf16t",
     "mask" if c[5] else "nomask"]))
def test_loss_kernel_families_match_plain_version(case, cuda_device):
    """K3's Gaussian, colored and padded families against the plain version
    through ``fused_bce_spatial_int8``'s layouts (chunk-permuted coords and
    pre-paired targets; zero pad under a forced mask); two runs agree bit
    for bit; image chunks give the same result."""
    import torch.nn.functional as F
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.train.trainer import build_yt_i8, yt_layout

    family, side, h, wdt, i8, masked = case
    colored = family == "colored"
    hw, no, b = side * side, 2 if colored else 1, 4
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    if i8:
        y = torch.randint(0, 256, (b, hw), generator=gen,
                          device=cuda_device).float() / 255
        yt = build_yt_i8(y, hw, colored)
    else:
        y = 0.5 + 0.4 * torch.randn((b, hw), generator=gen,
                                    device=cuda_device)
        yt = yt_layout(y.to(torch.bfloat16), hw, colored)
    mask = ((coords.pow(2).sum(dim=1) <= 1.0).float() if masked else None)
    pad = 0 if colored else l8.padded_hw(hw) - hw
    if colored:
        coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
    elif pad:
        coords = F.pad(coords, (0, 0, 0, pad))
        yt = F.pad(yt, (0, pad), value=-128 if i8 else 0)
        mask = F.pad(torch.ones(hw, device=cuda_device) if mask is None
                     else mask, (0, pad))
    args = (fold, coords, *ws, yt, mask, family)
    l8.reset_launches()
    with torch.no_grad():
        got = l8.run_loss_int8(*args)
        again = l8.run_loss_int8(*args)
        chunked = l8.run_loss_int8(*args, workspace_bytes=1)
        want = l8.loss_int8_reference(*args)
    for u, v, c, x in zip(got, again, chunked, want):
        assert torch.equal(u, v)
        _assert_rel(c, u, (1e-6, 1e-7))
        _assert_rel(u, x, INT8_TOL)
    assert not got[0][:, 3, 1:].any()
    # every family takes the cluster passes (forward, gradient, dW1 per
    # chunk)
    assert l8.LAUNCHES["fwd_sm90"] == l8.LAUNCHES["grad_sm90"] == 2 + b
    assert l8.LAUNCHES["fwd"] == l8.LAUNCHES["grad"] == 0


@pytest.mark.parametrize("name", ["particles", "colored", "mnist"])
def test_family_training_step_on_the_card(name, cuda_device):
    """One even step through K3 in the model's family and one odd step
    through K4/K5 at a narrow encoder: finite metrics, the launches."""
    from spatialvae_torch.config import InferenceConfig
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    side, z, n_out, lik = {"particles": (64, 20, 1, "gaussian"),
                           "colored": (64, 20, 2, "colored"),
                           "mnist": (28, 2, 1, "bernoulli")}[name]
    q_cfg = InferenceConfig(n=side * side, latent_dim=z + 3, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=z, hidden_dim=500, n_out=n_out,
                                   num_layers=2)
    grid = coord_grid(side, side, device=cuda_device)
    tr = Trainer(q_cfg, p_cfg,
                 ElboConfig(fused=True, int8=True, likelihood=lik),
                 TrainConfig(minibatch_size=8, compute_dtype="bfloat16"),
                 grid, mask=None if name == "mnist"
                 else (grid.pow(2).sum(dim=1) <= 1.0).float(),
                 device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(5)
    if name == "mnist":
        y = torch.randint(0, 256, (8, side * side, 1), device=cuda_device,
                          generator=gen).float() / 255
    else:
        y = torch.randn((8, side * side, 1), device=cuda_device,
                        generator=gen)
    y_t = tr._dataset_yt(y)
    assert y_t.dtype == (torch.int8 if name == "mnist" else torch.bfloat16)
    l8.reset_launches()
    d8.reset_launches()
    assert torch.isfinite(tr.train_step(y, y_t=y_t)).all()
    assert torch.isfinite(tr.train_step(y[:5])).all()
    assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0), "fwd_sm90": 1,
                           "grad_sm90": 1, "dw_sm90": 1, "sum": 5}
    assert d8.LAUNCHES == {**dict.fromkeys(d8.LAUNCHES, 0),
                           "fwd_acts_sm90": 1, "bwd_scale_sm90": 1,
                           "bwd_grad_sm90": 1, "dw_sm90": 1, "sum": 4}
    assert tr.opt_state.count == 2


def test_int8_training_step_on_the_card(cuda_device):
    """One even step through K3 and one odd step through K4/K5 in a galaxy
    trainer with int8 targets."""
    from spatialvae_torch.config import InferenceConfig
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=2)
    tr = Trainer(q_cfg, p_cfg, ElboConfig(fused=True, int8=True, channels=3),
                 TrainConfig(minibatch_size=8, compute_dtype="bfloat16"),
                 coord_grid(64, 64, device=cuda_device), device=cuda_device)
    y = torch.randint(0, 256, (8, 4096, 3), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(5)
                      ).float() / 255
    y_t = tr._dataset_yt(y)
    assert y_t.dtype == torch.int8
    l8.reset_launches()
    d8.reset_launches()
    assert torch.isfinite(tr.train_step(y, y_t=y_t)).all()
    assert torch.isfinite(tr.train_step(y[:5])).all()
    assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0), "fwd_sm90": 1,
                           "grad_sm90": 1, "dw_sm90": 1, "sum": 5}
    assert d8.LAUNCHES == {**dict.fromkeys(d8.LAUNCHES, 0),
                           "fwd_acts_sm90": 1, "bwd_scale_sm90": 1,
                           "bwd_grad_sm90": 1, "dw_sm90": 1, "sum": 4}
    assert tr.opt_state.count == 2


# ---------------------------------------------------------------------------
# Adam: K6, K7 and the emission helpers; the int8 encoder's products
# ---------------------------------------------------------------------------


def _adam_leaf(shape, gdt, mdt, device, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    p = torch.randn(shape, generator=g, device=device) * 0.02
    grad = (torch.randn(shape, generator=g, device=device) * 1e-3).to(gdt)
    m = (torch.randn(shape, generator=g, device=device) * 1e-4).to(mdt)
    v = (torch.rand(shape, generator=g, device=device) * 1e-6).to(mdt)
    return p, grad, m, v


ADAM_CASES = [(torch.float32, torch.float32, False),
              (torch.bfloat16, torch.float32, True),
              (torch.bfloat16, torch.bfloat16, True)]


@pytest.mark.parametrize("shape", [(500, 1228), (46, 500), (13, 16), (7,)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("gdt,mdt,shadow", ADAM_CASES,
                         ids=["f32", "bf16g-shadow", "bf16-all"])
def test_adam_kernels_match_plain_versions(shape, gdt, mdt, shadow,
                                           cuda_device):
    """K6 (with the abs-max), K7 and the two helpers bit for bit against
    their plain versions, which divide by device tensors and round every
    step as the kernels do."""
    from spatialvae_torch.kernels import adam as ka

    k = ka.AdamConsts.make(1e-4, 0.9, 0.999, 1e-8, 7)
    p, g, m, v = _adam_leaf(shape, gdt, mdt, cuda_device)
    sh = torch.empty(shape, dtype=torch.bfloat16, device=cuda_device) \
        if shadow else None
    ref = [t.clone() for t in (p, g, m, v)] + [
        None if sh is None else sh.clone()]
    ka.reset_launches()
    amax = ka.adam_leaf(p, g, m, v, k, sh, want_amax=True)
    want = ka.adam_leaf_reference(ref[0], ref[1], ref[2], ref[3], k, ref[4],
                                  True)
    for got, exp in ((p, ref[0]), (m, ref[2]), (v, ref[3]), (amax, want)):
        assert torch.equal(got, exp)
    if shadow:
        assert torch.equal(sh, ref[4])
    s, ns = ka.quant_scale(amax, twin=True)
    assert torch.equal(s, ka.quant_scale_reference(want))
    assert torch.equal(ns, s) and ns.data_ptr() != s.data_ptr()
    assert torch.equal(ka.quantize(p, s), ka.quantize_reference(p, s))
    p, g, m, v = _adam_leaf(shape, gdt, mdt, cuda_device, seed=1)
    sh = torch.empty(shape, dtype=torch.bfloat16, device=cuda_device)
    ref = [t.clone() for t in (p, g, m, v, sh)]
    s_in = torch.full((1, 1), 0.08 / 127, device=cuda_device)
    q, amax = ka.adam_emit(p, g, m, v, k, sh, s_in)
    q_ref, amax_ref = ka.adam_emit_reference(*ref[:4], k, ref[4], s_in)
    for got, exp in ((p, ref[0]), (m, ref[2]), (v, ref[3]), (sh, ref[4]),
                     (q, q_ref), (amax, amax_ref)):
        assert torch.equal(got, exp)
    assert ka.LAUNCHES == {"adam": 1, "adam_emit": 1, "adam_step": 0,
                           "quant_scale": 1, "quantize": 1}


# the galaxy model's 13 leaves (chip_smoke.galaxy_leaves)
GALAXY_LEAVES = [(5000, 12288), (5000,), (5000, 5000), (5000,), (46, 5000),
                 (46,), (500, 2), (500,), (500, 20), (500, 500), (500,),
                 (3, 500), (3,)]
# ragged leaves: 1, 3, 46 and 8k + 5 elements, and a quantised 2-D one
RAGGED_LEAVES = [(1,), (3,), (46,), (8 * 1024 + 5,), (37, 41)]


def _step_leaves(shapes, gdt, mdt, shadow, device, seed, odd=()):
    """[p, g, m, v, shadow or None] per shape; the leaves at the indices in
    ``odd`` are views one element into a larger buffer (not 16-byte
    aligned), every tensor of them."""
    out = []
    for i, shape in enumerate(shapes):
        p, g, m, v = _adam_leaf(shape, gdt, mdt, device, seed=seed + i)
        sh = (torch.empty(shape, dtype=torch.bfloat16, device=device)
              if shadow else None)
        leaf = [p, g, m, v, sh]
        if i in odd:
            n = p.numel()
            leaf = [None if t is None else
                    torch.empty(n + 1, dtype=t.dtype, device=device)[1:]
                    .view(shape).copy_(t) for t in leaf]
        out.append(leaf)
    return out


def _run_step(leaves, k, modes, s_in, step):
    """``step`` (adam_step or its plain version) over the leaves."""
    shadow = None if leaves[0][4] is None else [x[4] for x in leaves]
    return step([x[0] for x in leaves], [x[1] for x in leaves],
                [x[2] for x in leaves], [x[3] for x in leaves], k, shadow,
                modes, s_in)


def _assert_step_equal(leaves, refs, got, want):
    for x, r in zip(leaves, refs):
        for i in (0, 2, 3, 4):
            if x[i] is not None:
                assert torch.equal(x[i], r[i])
    for u, w in zip(got, want):
        assert (u is None) == (w is None)
        for a, b in zip(u or (), w or ()):
            assert torch.equal(a.reshape(-1), b.reshape(-1))


@pytest.mark.parametrize("engine", ["plain", "xla", "pallas"])
@pytest.mark.parametrize("gdt,mdt,shadow", ADAM_CASES,
                         ids=["f32", "bf16g-shadow", "bf16-all"])
def test_adam_step_matches_plain_versions(gdt, mdt, shadow, engine,
                                          cuda_device):
    """The step kernel on the galaxy leaves and the ragged ones, two of them
    views at an odd offset, bit for bit against its plain version in p',
    m', v', the shadow and, for the quantised leaves, q, max|p'|, s and ns;
    one launch, no per-leaf kernel."""
    from spatialvae_torch.kernels import adam as ka

    if engine == "pallas" and not shadow:
        pytest.skip("K7 writes the shadow")
    k = ka.AdamConsts.make(1e-4, 0.9, 0.999, 1e-8, 7)
    shapes = GALAXY_LEAVES + RAGGED_LEAVES
    leaves = _step_leaves(shapes, gdt, mdt, shadow, cuda_device, 0,
                          odd=(len(GALAXY_LEAVES) + 3, len(shapes) - 1))
    # zero columns (zero gradients with zero moments, as a pixel that is 0
    # in every image makes), which the kernel keeps off the divisions' slow
    # path
    for x in leaves[:3]:
        cols = torch.arange(x[0].shape[-1], device=cuda_device) % 5 < 2
        for t in x[1:4]:
            t[..., cols] = 0
    quantised = {0, 2, len(shapes) - 1, len(GALAXY_LEAVES) + 3}
    mode = {"plain": ka.PLAIN, "xla": ka.FRESH, "pallas": ka.EMIT}[engine]
    modes = [mode if i in quantised else ka.PLAIN
             for i in range(len(shapes))]
    s_in = [torch.full((1, 1), 0.06 / 127, device=cuda_device)
            if md == ka.EMIT else None for md in modes]
    refs = [[None if t is None else t.clone() for t in x] for x in leaves]
    ka.reset_launches()
    got = _run_step(leaves, k, modes, s_in, ka.adam_step)
    assert ka.LAUNCHES == {"adam": 0, "adam_emit": 0, "adam_step": 1,
                           "quant_scale": 0, "quantize": 0}
    want = _run_step(refs, k, modes, s_in, ka.adam_step_reference)
    torch.cuda.synchronize()
    _assert_step_equal(leaves, refs, got, want)


def test_adam_step_takes_more_launches_past_the_cap(cuda_device):
    """More leaves than a launch takes: one launch per STEP_MAX_LEAVES, each
    with its own scales, still bit for bit."""
    from spatialvae_torch.kernels import adam as ka

    k = ka.AdamConsts.make(1e-3, 0.9, 0.999, 1e-8, 3)
    shapes = [(17 + 300 * i,) for i in range(ka.STEP_MAX_LEAVES + 5)]
    leaves = _step_leaves(shapes, torch.bfloat16, torch.float32, True,
                          cuda_device, 3)
    modes = [ka.FRESH if i % 7 == 0 else ka.PLAIN for i in range(len(shapes))]
    refs = [[t.clone() for t in x] for x in leaves]
    ka.reset_launches()
    got = _run_step(leaves, k, modes, None, ka.adam_step)
    assert ka.LAUNCHES["adam_step"] == 2
    want = _run_step(refs, k, modes, None, ka.adam_step_reference)
    _assert_step_equal(leaves, refs, got, want)


def test_quantize_many_matches_plain_version(cuda_device):
    """The fresh-scale copies of several leaves, ragged and one at an odd
    offset, in one launch, bit for bit."""
    from spatialvae_torch.kernels import adam as ka

    g = torch.Generator(cuda_device).manual_seed(4)
    ps = [torch.randn(shape, generator=g, device=cuda_device)
          for shape in ((5000, 5000), (3,), (8 * 1024 + 5,), (37, 41))]
    ps.append(torch.empty(20001, device=cuda_device)[1:].copy_(
        torch.randn(20000, generator=g, device=cuda_device)))
    ss = [ka.quant_scale_reference(p.abs().max().reshape(1)) for p in ps]
    ka.reset_launches()
    qs = ka.quantize_many(ps, ss)
    assert ka.LAUNCHES["quantize"] == 1
    for p, s, q in zip(ps, ss, qs):
        assert torch.equal(q, ka.quantize_reference(p, s))


@pytest.mark.parametrize("m,k,n", [(100, 12288, 5000), (37, 5000, 5000),
                                   (5000, 100, 12288), (5000, 37, 5000),
                                   (3, 50, 36), (5000, 64, 5000),
                                   (5000, 64, 12288), (5000, 112, 2504),
                                   (1600, 16, 5000), (4096, 32, 4999)])
def test_int_mm_on_the_card_is_exact(m, k, n, cuda_device):
    """The padded int8 GEMM at the galaxy encoder's forward and dW shapes
    in every operand layout the encoder uses (row-major input, a
    transposed weight copy, a transposed cotangent) against float64
    products; among them the dW of a batch of 64 and the other shapes
    cuBLASLt refuses unpadded (N of 8 mod 16 against K a multiple of 16
    below 128)."""
    from spatialvae_torch.nn.qlinear import int_mm

    g = torch.Generator(cuda_device).manual_seed(3)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=cuda_device,
                      dtype=torch.int8)
    want = a.double() @ b.double()
    for aa, bb in ((a, b), (a, b.t().contiguous().t()),
                   (a.t().contiguous().t(), b)):
        got = int_mm(aa, bb)
        assert got.dtype == torch.int32 and torch.equal(got.double(), want)


# M and N over the widths and batches of the encoder's products, K over
# every multiple of 8 up to 512 (the batch, in dW) and the encoder's input
# widths (784, 1,600, 2,500, 12,288 pixels, 5,000 hidden)
INT_MM_DIMS = (24, 32, 40, 64, 104, 504, 784, 1600, 2504, 4096, 5000, 5008,
               12288)
INT_MM_KS = tuple(range(8, 520, 8)) + (784, 1600, 2504, 5000, 12288)


def test_int_mm_refusals_are_padded(cuda_device):
    """``torch._int_mm`` unpadded over the grid in the layout ``int_mm``
    hands it (a row-major, b the transpose of a row-major (N, K)): every
    shape cuBLASLt refuses is one ``int_mm`` pads N for, even where b
    needs no copy (the map is printed: ``pytest -s``); and ``int_mm`` is
    exact on every shape with K up to 256 in the three operand layouts
    the encoder uses."""
    from spatialvae_torch.nn.qlinear import int_mm, padded_sizes

    g = torch.Generator(cuda_device).manual_seed(5)
    kmax = INT_MM_KS[-1]
    refused = {}
    for m in INT_MM_DIMS:
        for n in INT_MM_DIMS:
            a_full = torch.randint(-127, 128, (m, kmax), generator=g,
                                   device=cuda_device, dtype=torch.int8)
            b_full = torch.randint(-127, 128, (n, kmax), generator=g,
                                   device=cuda_device, dtype=torch.int8)
            for k in INT_MM_KS:
                a = a_full[:, :k].contiguous()
                bt = b_full[:, :k].contiguous()
                try:
                    torch._int_mm(a, bt.t())
                    torch.cuda.synchronize()
                except RuntimeError:
                    refused.setdefault((m, n), []).append(k)
                    assert padded_sizes(m, k, n, False)[2] != n, (m, k, n)
                if k > 256:
                    continue
                want = a.double() @ bt.double().t()
                for aa, bb in ((a, bt.t()), (a, bt.t().contiguous()),
                               (a.t().contiguous().t(), bt.t())):
                    got = int_mm(aa, bb)
                    assert got.dtype == torch.int32 and \
                        torch.equal(got.double(), want), (m, k, n)
                del want
    print("int_mm_refusals", {f"{m}x{n}": ks for (m, n), ks in
                              sorted(refused.items())})


def test_int8_stack_step_on_the_card(cuda_device, monkeypatch):
    """Steps of the TPU's int8 stack in a galaxy-shaped trainer (encoder
    narrowed to 256): the bf16 shadow, the int8 encoder reading the int8
    data copy, Adam through the step kernel with the fresh-scale emission,
    then under SPATIALVAE_ADAM_EMIT=pallas with K7 on the encoder
    weights."""
    from spatialvae_torch.config import InferenceConfig
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train import trainer as port_trainer
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(port_trainer, "_QENC_MIN_ELEMS", 1 << 16)
    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=2)
    tr = Trainer(q_cfg, p_cfg, ElboConfig(fused=True, int8=True, channels=3),
                 TrainConfig(minibatch_size=8, compute_dtype="bfloat16"),
                 coord_grid(64, 64, device=cuda_device), device=cuda_device)
    y = torch.randint(0, 256, (8, 4096, 3), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(5)
                      ).float() / 255
    y_t = tr._dataset_yt(y)
    xq, sx = tr._dataset_yq8(y)
    ka.reset_launches()
    assert torch.isfinite(tr.train_step(y, y_t=y_t, y_q8=(xq, sx))).all()
    assert torch.isfinite(tr.train_step(y[:5])).all()
    # three 2-D leaves reach 64 Ki elements: the two encoder hidden weights
    # and the decoder's hidden weight; each is quantised when the first
    # step seeds the qshadow, then after each step
    big = [k for k, e in tr.qshadow.items() if e["q"].numel()]
    assert len(big) == 3
    # two steps: one launch of the step kernel each (it writes the scales)
    # and one of the fresh-scale copies of the three
    assert ka.LAUNCHES == {"adam": 0, "adam_emit": 0, "adam_step": 2,
                           "quant_scale": 3, "quantize": 3 + 2}
    monkeypatch.setenv("SPATIALVAE_ADAM_EMIT", "pallas")
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    ka.reset_launches()
    prev = {k: tr.qshadow[k]["ns"] for k in big}
    assert torch.isfinite(tr.train_step(y, y_t=y_t, y_q8=(xq, sx))).all()
    # K7 takes the encoder weights; the decoder's (500, 500) has 500 rows
    # in JAX's orientation, no block of 8, and keeps the fresh scale
    carried = [k for k in big if k.startswith("q.")]
    assert len(carried) == 2
    assert ka.LAUNCHES == {"adam": 0, "adam_emit": 0, "adam_step": 1,
                           "quant_scale": 0, "quantize": 1}
    assert all(tr.qshadow[k]["s"] is prev[k] for k in carried)
    assert tr.qshadow["p.layers.1.weight"]["s"] is not \
        prev["p.layers.1.weight"]
    for k, p in tr.named_params().items():
        assert torch.equal(tr.shadow[k], p.detach().to(torch.bfloat16))


# K3 at the numerics off the defaults (ROADMAP Queue 2 K3 (e), (f)): (B, HW,
# H, No, weight dtype, grad_mode, gscale, epi, sr)
NUMERICS_CASES = [
    (4, 4096, 500, 3, torch.bfloat16, "i8", "tile", "bf16", False),
    (4, 4096, 500, 3, torch.float32, "da0_i4", "tile", "f32", True),
    (2, 1024, 96, 1, torch.bfloat16, "i4dw1", "tile", "bf16", True),
    (4, 1024, 130, 8, torch.float32, "i4dw1", "bound", "f32", False),
    (6, 4096, 500, 3, torch.bfloat16, "i4dw1", "bound", "bf16", True),
    (2, 1024, 64, 3, torch.float32, "i8", "tile", "f32", True),
]
# the gradient site's integers may differ from the plain version's where a
# head sum in another order moves q by an ulp across a rounding boundary:
# at most this share of them (the forward site's agree exactly)
INT_MISMATCH = 1e-5


@pytest.mark.parametrize("case", NUMERICS_CASES, ids=lambda c: "-".join(
    [f"B{c[0]}-HW{c[1]}-H{c[2]}-No{c[3]}", str(c[4])[6:], *c[5:8],
     "sr" if c[8] else "rtn"]))
def test_loss_kernel_numerics_match_plain_version(case, cuda_device):
    """Each numerics mode of K3 against its plain version: the outputs within
    the K3 limits, the quantised tiles (SR's drawn from the same words) equal
    at the forward site and all but a few at the gradient site, two runs bit
    for bit."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics

    b, hw, h, no, wdt, gm, gs, epi, sr = case
    nm = Numerics(grad_mode=gm, gscale=gs, epi=epi, sr=sr)
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    k = torch.randint(0, 256, (b, no, hw), generator=gen, device=cuda_device)
    yt = (k - 128).to(torch.int8)
    mask = (torch.rand(hw, generator=gen, device=cuda_device) > 0.3).float()
    with torch.no_grad():
        got, (aq, qi) = l8.run_loss_int8(fold, coords, *ws, yt, mask,
                                         numerics=nm, ints=True)
        again = l8.run_loss_int8(fold, coords, *ws, yt, mask, numerics=nm)
        want, (aq_p, qi_p) = l8.loss_int8_reference(
            fold, coords, *ws, yt, mask, numerics=nm, ints=True)
    for u, v, x in zip(got, again, want):
        assert torch.equal(u, v)
        _assert_rel(u, x, INT8_TOL)
    _assert_rel(got[0][:, :3], want[0][:, :3], DH0_TOL)
    assert torch.equal(aq, aq_p)
    assert (qi != qi_p).float().mean().item() <= INT_MISMATCH


# K3's cluster passes (csrc/fused_loss_int8_sm90.cu) at the default
# numerics: (B, HW, H, No, weight dtype, int8 targets, mask); batches of 2
# to 6 (K3 takes image pairs; odd tails go to K4/K5), groups of 1,024 and
# of 256 pixels (48x48: nine groups), narrow widths, one and eight outputs
# (the padded families are in FAMILY_CASES)
SM90_CASES = [(6, 4096, 500, 3, torch.bfloat16, True, True),
              (4, 4096, 500, 3, torch.float32, False, False),
              (4, 2304, 500, 1, torch.bfloat16, True, True),
              (2, 1024, 96, 1, torch.float32, True, False),
              (4, 2304, 130, 8, torch.bfloat16, False, True)]


@pytest.mark.parametrize("case", SM90_CASES, ids=lambda c: "-".join(
    [f"B{c[0]}-HW{c[1]}-H{c[2]}-No{c[3]}", str(c[4])[6:],
     "i8" if c[5] else "f32t", "mask" if c[6] else "nomask"]))
def test_k3_cluster_passes_match_plain_and_block(case, cuda_device):
    """The cluster passes against the plain version within K3's limits and
    against the block passes: aq word for word with both, qi within
    INT_MISMATCH of both (a head sum in another order may move an ulp across
    a rounding), two runs bit for bit, several workspace chunks within
    1e-6; each design counted under its own keys."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    b, hw, h, no, wdt, i8, masked = case
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(3)
    k = torch.randint(0, 256, (b, no, hw), generator=gen, device=cuda_device)
    yt = (k - 128).to(torch.int8) if i8 else k.float() / 255
    mask = ((torch.rand(hw, generator=gen, device=cuda_device) > 0.3).float()
            if masked else None)
    args = (fold, coords, *ws, yt, mask)
    assert l8.k3_route(hw, h, l8.pick_tile(hw), "bernoulli",
                       l8.DEFAULTS) == "sm90"
    l8.reset_launches()
    with torch.no_grad():
        got, (aq, qi) = l8.run_loss_int8(*args, ints=True)
        assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0),
                               "fwd_sm90": 1, "grad_sm90": 1, "dw_sm90": 1,
                               "sum": 5}
        again = l8.run_loss_int8(*args)
        chunked = l8.run_loss_int8(*args, workspace_bytes=1)
        l8.reset_launches()
        old, (aq7, qi7) = l8.run_loss_int8(*args, ints=True, block_passes=True)
        assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0), "fwd": 1,
                               "grad": 1, "dw": 1, "sum": 5}
        want, (aq_p, qi_p) = l8.loss_int8_reference(*args, ints=True)
    for u, v, c, o, x in zip(got, again, chunked, old, want):
        assert torch.equal(u, v)
        _assert_rel(c, u, (1e-6, 1e-7))
        _assert_rel(u, x, INT8_TOL)
        _assert_rel(u, o, INT8_TOL)
    _assert_rel(got[0][:, :3], want[0][:, :3], DH0_TOL)
    _assert_rel(got[0][:, :3], old[0][:, :3], DH0_TOL)
    assert torch.equal(aq, aq_p) and torch.equal(aq, aq7)
    assert (qi != qi_p).float().mean().item() <= INT_MISMATCH
    assert (qi != qi7).float().mean().item() <= INT_MISMATCH


# the colored family on the cluster passes, each mean block paired with its
# log-variance partner across a cluster: (B, (image rows, columns), weight
# dtype, mask); 64x64 (groups of 1,024: the partner 8 blocks away) and
# 32x40 (groups of 256: 2 blocks), the galaxy batch and two images
COLORED90_CASES = [(b, shape, wdt, masked)
                   for b in (2, 100) for shape in ((64, 64), (32, 40))
                   for wdt in (torch.bfloat16, torch.float32)
                   for masked in (True, False)]


@pytest.mark.parametrize("case", COLORED90_CASES, ids=lambda c: "-".join(
    [f"B{c[0]}-HW{c[1][0] * c[1][1]}", str(c[2])[6:],
     "mask" if c[3] else "nomask"]))
def test_k3_colored_cluster_passes_match_plain_and_block(case, cuda_device):
    """The colored family on the cluster passes against the plain version
    within K3's limits and against the block passes: aq word for word with
    both, qi within INT_MISMATCH of both, two runs bit for bit, counted
    under the cluster passes' keys (int8 targets with bf16 weights, bf16
    targets with f32 weights)."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.train.trainer import build_yt_i8, yt_layout

    b, (rows, cols), wdt, masked = case
    hw, h = rows * cols, 500
    fold, _, ws = _int8_inputs(b, 4096, h, 2, wdt, cuda_device)
    grid = coord_grid(rows, cols, device=cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(6)
    y = torch.rand((b, hw), generator=gen, device=cuda_device)
    yt = (build_yt_i8(torch.round(y * 255) / 255, hw, True)
          if wdt == torch.bfloat16 else yt_layout(y.to(torch.bfloat16), hw,
                                                  True))
    mask = (grid.pow(2).sum(dim=1) <= 1.0).float() if masked else None
    pt = l8.pick_tile(hw)
    coords = l8.colored_coords(grid, pt).contiguous()
    args = (fold, coords, *ws, yt, mask, "colored")
    assert l8.k3_route(hw, h, pt, "colored", l8.DEFAULTS) == "sm90"
    l8.reset_launches()
    with torch.no_grad():
        got, (aq, qi) = l8.run_loss_int8(*args, ints=True)
        assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0),
                               "fwd_sm90": 1, "grad_sm90": 1, "dw_sm90": 1,
                               "sum": 5}
        again = l8.run_loss_int8(*args)
        old, (aq7, qi7) = l8.run_loss_int8(*args, ints=True,
                                           block_passes=True)
        want, (aq_p, qi_p) = l8.loss_int8_reference(*args, ints=True)
    for u, v, o, x in zip(got, again, old, want):
        assert torch.isfinite(u).all()
        assert torch.equal(u, v)
        _assert_rel(u, x, INT8_TOL)
        _assert_rel(u, o, INT8_TOL)
    _assert_rel(got[0][:, 3, 0], want[0][:, 3, 0], INT8_TOL)
    _assert_rel(got[0][:, :3], want[0][:, :3], DH0_TOL)
    _assert_rel(got[0][:, :3], old[0][:, :3], DH0_TOL)
    assert torch.equal(aq, aq_p) and torch.equal(aq, aq7)
    assert (qi != qi_p).float().mean().item() <= INT_MISMATCH
    assert (qi != qi7).float().mean().item() <= INT_MISMATCH


# K3's stochastic rounding on the cluster passes
# (csrc/fused_loss_int8_sm90_sr.cu): (family, image side, B, H, weight
# dtype, mask): the galaxy shape, the Gaussian family under a mask, 28x28
# padded to 1,024 (a forced mask), the colored family at one and at four
# groups an image, narrow widths
SR90_CASES = [("bernoulli", 64, 6, 500, torch.bfloat16, False),
              ("bernoulli", 64, 4, 500, torch.float32, True),
              ("gaussian", 64, 4, 500, torch.bfloat16, True),
              ("bernoulli", 28, 6, 96, torch.bfloat16, False),
              ("colored", 64, 2, 500, torch.bfloat16, True),
              ("colored", 64, 4, 500, torch.float32, False),
              ("colored", 32, 4, 130, torch.bfloat16, True)]


@pytest.mark.parametrize("case", SR90_CASES, ids=lambda c: "-".join(
    [c[0], f"{c[1]}px", f"B{c[2]}", f"H{c[3]}", str(c[4])[6:],
     "mask" if c[5] else "nomask"]))
def test_k3_sr_cluster_passes_match_plain_and_block(case, cuda_device):
    """SR on the cluster passes against the plain version (the same Philox
    words) within K3's limits and against the block passes: aq word for word
    with both, qi within INT_MISMATCH of both, two runs bit for bit, one
    image per workspace chunk within 1e-6 (the counters take the absolute
    image), counted under the cluster keys; b1 one ulp away draws other
    words for more than 5% of aq."""
    import torch.nn.functional as F
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics
    from spatialvae_torch.train.trainer import yt_layout

    family, side, b, h, wdt, masked = case
    colored = family == "colored"
    hw, no = side * side, (2 if colored else 3 if family == "bernoulli"
                           else 1)
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(7)
    mask = (coords.pow(2).sum(dim=1) <= 1.0).float() if masked else None
    if colored:
        y = 0.5 + 0.4 * torch.randn((b, hw), generator=gen, device=cuda_device)
        yt = yt_layout(y.to(torch.bfloat16), hw, True)
        coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
    else:
        k = torch.randint(0, 256, (b, no, hw), generator=gen,
                          device=cuda_device)
        yt = (k - 128).to(torch.int8)
        pad = l8.padded_hw(hw) - hw
        if pad:
            coords = F.pad(coords, (0, 0, 0, pad))
            yt = F.pad(yt, (0, pad), value=-128)
            mask = F.pad(torch.ones(hw, device=cuda_device) if mask is None
                         else mask, (0, pad))
    nm = Numerics(sr=True)
    args = (fold, coords, *ws, yt, mask, family)
    assert l8.k3_route(coords.shape[0], h, l8.pick_tile(coords.shape[0]),
                       family, nm) == "sm90"
    l8.reset_launches()
    with torch.no_grad():
        got, (aq, qi) = l8.run_loss_int8(*args, numerics=nm, ints=True)
        assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0),
                               "fwd_sm90": 1, "grad_sm90": 1, "dw_sm90": 1,
                               "sum": 5}
        again = l8.run_loss_int8(*args, numerics=nm)
        chunked = l8.run_loss_int8(*args, numerics=nm, workspace_bytes=1)
        old, (aq7, qi7) = l8.run_loss_int8(*args, numerics=nm, ints=True,
                                           block_passes=True)
        want, (aq_p, qi_p) = l8.loss_int8_reference(*args, numerics=nm,
                                                    ints=True)
        b1 = ws[1].clone()
        b1[0] = torch.nextafter(b1[0], torch.ones_like(b1[0]))
        _, (aq2, _) = l8.run_loss_int8(fold, coords, ws[0], b1, *ws[2:], yt,
                                       mask, family, numerics=nm, ints=True)
    for u, v, c, o, x in zip(got, again, chunked, old, want):
        assert torch.isfinite(u).all()
        assert torch.equal(u, v)
        _assert_rel(c, u, (1e-6, 1e-7))
        _assert_rel(u, x, INT8_TOL)
        _assert_rel(u, o, INT8_TOL)
    _assert_rel(got[0][:, :3], want[0][:, :3], DH0_TOL)
    _assert_rel(got[0][:, :3], old[0][:, :3], DH0_TOL)
    assert torch.equal(aq, aq_p) and torch.equal(aq, aq7)
    assert (qi != qi_p).float().mean().item() <= INT_MISMATCH
    assert (qi != qi7).float().mean().item() <= INT_MISMATCH
    assert (aq != aq2).float().mean().item() > 0.05


@pytest.mark.parametrize("family", ["bernoulli", "colored"])
def test_k3_sr_wide_chunks_match_plain(family, cuda_device):
    """SR at H = 1,000 (the block passes' wide kernels) with one image per
    workspace chunk: within K3's limits of the plain version and within 1e-6
    of the call in one chunk, so the forward's words take the call's image
    index, as the gradient pass's do."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics
    from spatialvae_torch.train.trainer import yt_layout

    colored = family == "colored"
    b, hw, h, no = 4, 4096, 1000, 2 if colored else 3
    fold, coords, ws = _int8_inputs(b, hw, h, no, torch.bfloat16, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(11)
    if colored:
        y = 0.5 + 0.4 * torch.randn((b, hw), generator=gen, device=cuda_device)
        yt = yt_layout(y.to(torch.bfloat16), hw, True)
        coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
    else:
        k = torch.randint(0, 256, (b, no, hw), generator=gen,
                          device=cuda_device)
        yt = (k - 128).to(torch.int8)
    nm = Numerics(sr=True)
    args = (fold, coords, *ws, yt, None, family)
    assert l8.k3_route(hw, h, l8.pick_tile(hw), family, nm) == "block"
    l8.reset_launches()
    with torch.no_grad():
        whole = l8.run_loss_int8(*args, numerics=nm)
        assert l8.LAUNCHES["fwd"] == 1
        chunked = l8.run_loss_int8(*args, numerics=nm, workspace_bytes=1)
        assert l8.LAUNCHES["fwd"] == 1 + b
        want = l8.loss_int8_reference(*args, numerics=nm)
    for u, c, x in zip(whole, chunked, want):
        assert torch.isfinite(c).all()
        _assert_rel(c, u, (1e-6, 1e-7))
        _assert_rel(c, x, INT8_TOL)


# K3's dh0 (dfold's three gradient rows on their own scale: beside the loss
# at dfold[:, 3, 0] their errors are too small to see) on every route, and
# K8's: chip_smoke.DH0_TOL, placed between the sound passes and each route's
# copy that moves dh0 alone (PERF.md's limits; past 512 sound at most
# 1.12e-4 / 1.78e-5 here, the copy that reads aq for dh0 one workspace
# block off at least 1.86e-2 / 6.89e-4)
DH0_TOL = (1e-3, 1e-4)
# where both designs quantise qi alike (every case but the 64x64 ones),
# they differ only in the order of their f32 sums: every output and dh0
# within 5.6e-7 of max|block| (max) and 3.8e-7 (mean) here
K3W_BLOCK_TOL = (1e-6, 5e-7)
# K5's wide cluster passes against the block passes past H = 512: they
# differ only in the order of their f32 sums (chip_smoke.K45W_BLOCK_TOL,
# relative to max|block|, placed between the sound passes and the wide
# copies that move K5: PERF.md's limits)
K45W_BLOCK_TOL = (1e-5, 2e-6)
# K3's cluster passes past H = 512 (csrc/fused_loss_int8_sm90_wide.cu, the
# default numerics): (H, family, image side, B, weight dtype, mask) at the
# widths of WIDTHS past 512 (513 and 4,100 end on a ragged chunk), in every
# family (the padded one at 28x28, a forced mask), and the galaxy shape at
# H = 1,000
K3W_CASES = [(h, fam, side, 2 if h > 2048 else 4, wdt, masked)
             for h in WIDTHS if h > 512
             for fam, side, wdt, masked in (
                 ("bernoulli", 32, torch.bfloat16, False),
                 ("gaussian", 32, torch.float32, True),
                 ("colored", 32, torch.bfloat16, True),
                 ("padded", 28, torch.float32, False))] + [
    (1000, "bernoulli", 64, 6, torch.bfloat16, True),
    (1000, "colored", 64, 4, torch.float32, False)]


@pytest.mark.parametrize("case", K3W_CASES, ids=lambda c: "-".join(
    [f"H{c[0]}", c[1], f"{c[2]}px", f"B{c[3]}", str(c[4])[6:],
     "mask" if c[5] else "nomask"]))
def test_k3_wide_cluster_passes_match_plain_and_block(case, cuda_device,
                                                      monkeypatch):
    """The cluster passes past H = 512 against the plain version within
    K3's limits and against the block passes: aq word for word with both
    (the forward leaves it in the dW1 workspace, where ``ints`` reads it),
    qi within INT_MISMATCH of both, two runs bit for bit, one image per
    workspace chunk within 1e-6 of one chunk, each design counted under its
    own keys, never the other's; dh0 within DH0_TOL of the plain version.
    At the 32x32 and 28x28 shapes qi equals the block passes' and every
    output and dh0 is within K3W_BLOCK_TOL of theirs (at 64x64 within
    K3's limits and DH0_TOL).  dW1 is held to the exact grouped product
    of the call's own quantised tiles (the plain version's group scales)
    within 1e-6 at every width, and to the plain version within K3's limits
    up to H = 1,024: past it a qi that the head's summation order moves
    across a rounding boundary moves dW1 by up to 2.2e-3 of its largest
    value (H = 4,100, padded), on both designs alike, which the block
    passes' check above holds."""
    import torch.nn.functional as F
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.train.trainer import yt_layout

    h, family, side, b, wdt, masked = case
    colored = family == "colored"
    hw = side * side
    no = {"gaussian": 1, "colored": 2}.get(family, 3)
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(h)
    mask = (coords.pow(2).sum(dim=1) <= 1.0).float() if masked else None
    fam = "bernoulli" if family == "padded" else family
    if colored:
        y = 0.5 + 0.4 * torch.randn((b, hw), generator=gen, device=cuda_device)
        yt = yt_layout(y.to(torch.bfloat16), hw, True)
        coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
    else:
        k = torch.randint(0, 256, (b, no, hw), generator=gen,
                          device=cuda_device)
        yt = (k - 128).to(torch.int8)
        pad = l8.padded_hw(hw) - hw
        if pad:
            coords = F.pad(coords, (0, 0, 0, pad))
            yt = F.pad(yt, (0, pad), value=-128)
            mask = F.pad(torch.ones(hw, device=cuda_device) if mask is None
                         else mask, (0, pad))
    args = (fold, coords, *ws, yt, mask, fam)
    hwp = coords.shape[0]
    assert l8.k3_route(hwp, h, l8.pick_tile(hwp), fam, l8.DEFAULTS) == "sm90"
    l8.reset_launches()
    with torch.no_grad():
        got, (aq, qi) = l8.run_loss_int8(*args, ints=True)
        assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0),
                               "fwd_sm90": 1, "grad_sm90": 1, "dw_sm90": 1,
                               "sum": 5}
        again = l8.run_loss_int8(*args)
        l8.reset_launches()
        chunked = l8.run_loss_int8(*args, workspace_bytes=1)
        assert l8.LAUNCHES == {**dict.fromkeys(l8.LAUNCHES, 0),
                               "fwd_sm90": b, "grad_sm90": b, "dw_sm90": b,
                               "sum": 5}
        l8.reset_launches()
        old, (aq7, qi7) = l8.run_loss_int8(*args, ints=True, block_passes=True)
        assert l8.LAUNCHES["fwd_sm90"] == l8.LAUNCHES["grad_sm90"] == 0
        seen = {}

        def epilogue(*a):                # the plain version's dz2
            out = epilogue.orig(*a)
            seen["dz2"] = out[1]
            return out
        epilogue.orig = l8.loss_epilogue
        monkeypatch.setattr(l8, "loss_epilogue", epilogue)
        want, (aq_p, qi_p) = l8.loss_int8_reference(*args, ints=True)
        pt = l8.pick_tile(hwp)
        gb = l8.loss_operands(ws[0], ws[2])[2]
        mdz = l8._group_max(seen["dz2"].transpose(1, 2), b, pt) + 1e-30
        own = d8.grouped_int_product(aq, qi, gb * mdz * (1.0 / 7.0)
                                     * (1.0 / 7.0), pt)
    tiles_alike = side < 64
    for i, (u, v, c, o, x) in enumerate(zip(got, again, chunked, old,
                                            want)):
        assert torch.isfinite(u).all()
        assert torch.equal(u, v)
        _assert_rel(c, u, (1e-6, 1e-7))
        if i != 1 or h <= 1024:
            _assert_rel(u, x, INT8_TOL)
        _assert_rel(u, o, K3W_BLOCK_TOL if tiles_alike else INT8_TOL)
    _assert_rel(got[1], own, (1e-6, 1e-7))
    _assert_rel(got[0][:, 3, 0], want[0][:, 3, 0], INT8_TOL)
    _assert_rel(got[0][:, :3], want[0][:, :3], DH0_TOL)
    _assert_rel(got[0][:, :3], old[0][:, :3],
                K3W_BLOCK_TOL if tiles_alike else DH0_TOL)
    assert torch.equal(aq, aq_p) and torch.equal(aq, aq7)
    assert (qi != qi_p).float().mean().item() <= INT_MISMATCH
    if tiles_alike:
        assert torch.equal(qi, qi7)
    assert (qi != qi7).float().mean().item() <= INT_MISMATCH


# K4 and K5's cluster passes (csrc/fused_decoder_int8_sm90.cu): (B, HW, H,
# No, weight dtype): the galaxy batch, three images (fewer quads than
# resident clusters) and the odd tail, f32 weights, 28x28
# and 65x65 padded (groups of 1,024 and 256 pixels), narrow widths, eight
# outputs
INT8_90_CASES = [(6, 4096, 500, 3, torch.bfloat16),
                 (3, 4096, 500, 3, torch.bfloat16),
                 (37, 4096, 500, 3, torch.bfloat16),
                 (5, 4096, 500, 3, torch.float32),
                 (3, 1024, 96, 1, torch.bfloat16),
                 (3, 4352, 130, 8, torch.float32),
                 (2, 4096, 512, 2, torch.bfloat16)]


@pytest.mark.parametrize("case", INT8_90_CASES, ids=lambda c: "-".join(
    map(str, c[:4])) + f"-{str(c[4])[6:]}")
def test_int8_cluster_passes_match_plain_and_block(case, cuda_device):
    """K4 (y, and a1 emitted packed) and K5 with the residual and with
    recompute on the cluster passes against the plain versions and the
    block passes within the int8 limits; two runs bit for bit, the
    chunked backward (one image per chunk) within 1e-6; each design counted
    under its own keys."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    b, hw, h, no, wdt = case
    assert d8.int8_route(hw, h) == "sm90"
    assert d8.int8_route(hw, h, k4_alone_f32=wdt == torch.float32) == (
        "block" if wdt == torch.float32 else "sm90")
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    # 65x65 zero-padded to 4,352 pixels, as fused_spatial_generator_int8
    # pads it
    coords = torch.nn.functional.pad(
        coords, (0, 0, 0, hw - coords.shape[0])).contiguous()
    g = torch.randn((b, no, hw), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    w = d8.Int8Weights(*ws)
    ref = (w.w1q, w.sw, w.b1, w.wht)
    d8.reset_launches()
    with torch.no_grad():
        y, a1 = d8.run_int8_tail(fold, coords, w, emit_a1=True)
        y0 = d8.run_int8_tail(fold, coords, w, passes="sm90")
        y_ref, a1_ref = d8.decoder_tail_int8_reference(
            fold, coords, *ref, w.bht, return_a1=True)
        yb, a1b = d8.run_int8_tail(fold, coords, w, emit_a1=True,
                                   passes="block")
        for got, want, tol in ((y, y_ref, INT8_Y_TOL), (y0, y_ref, INT8_Y_TOL),
                               (a1, a1_ref, INT8_A1_TOL), (y, yb, INT8_Y_TOL),
                               (a1, a1b, INT8_A1_TOL)):
            d = (got.float() - want.float()).abs()
            assert d.max().item() <= tol[0] and d.mean().item() <= tol[1]
        assert torch.equal(y, y0)
        for a in (a1, None):
            got = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            again = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            chunked = d8.run_int8_tail_backward(fold, coords, w, a, y, g,
                                                workspace_bytes=1)
            old = d8.run_int8_tail_backward(fold, coords, w, a, y, g,
                                            passes="block")
            want = d8.decoder_tail_int8_backward_reference(
                fold, coords, *ref, a, y, g)
            for u, v, c, o, x in zip(got, again, chunked, old, want):
                assert torch.equal(u, v)
                _assert_rel(c, u, (1e-6, 1e-7))
                _assert_rel(u, x, INT8_TOL)
                _assert_rel(u, o, INT8_TOL)
            assert not got[0][:, 3].any()
    # per variant two calls and the chunked one (b chunks) on the cluster
    # passes: the residual's scale pass one launch a call, recompute's one
    # a chunk; one call on the block passes
    assert d8.LAUNCHES == {
        **dict.fromkeys(d8.LAUNCHES, 0), "fwd_sm90": 1, "fwd_acts_sm90": 1,
        "fwd_acts": 1, "bwd_scale": 2, "bwd_grad": 2, "dw": 2,
        "bwd_scale_sm90": 3 + (2 + b), "bwd_grad_sm90": 2 * (2 + b),
        "dw_sm90": 2 * (2 + b), "sum": 4 * 8}


# K4 and K5's cluster passes past H = 512
# (csrc/fused_decoder_int8_sm90_wide.cu): (H, B, HW, No, weight dtype):
# every width of WIDTHS past 512 at 64x64 (groups of 2,048), bf16 and f32
# weights, three images (two past 2,048); 65x65 padded (groups of 256)
# with eight outputs; the CTF step's 40x40 padded to 1,792 with two
# outputs, bf16 and f32 weights (the step's own)
INT8_90W_CASES = [(h, 2 if h > 2048 else 3, 4096, 3, wdt)
                  for h in WIDTHS if h > 512
                  for wdt in (torch.bfloat16, torch.float32)] + [
    (1000, 3, 4352, 8, torch.float32), (1000, 4, 1792, 2, torch.bfloat16),
    (1000, 4, 1792, 2, torch.float32)]


@pytest.mark.parametrize("case", INT8_90W_CASES, ids=lambda c: "-".join(
    map(str, c[:4])) + f"-{str(c[4])[6:]}")
def test_int8_wide_cluster_passes_match_plain_and_block(case, cuda_device):
    """K4 (y, and a1) and K5 with the residual and with recompute on the
    wide cluster passes against the plain versions within the int8 limits,
    and against the block passes (y and a1 within the same limits, K5
    within K45W_BLOCK_TOL); two runs bit for bit, the chunked backward (one
    image per chunk) within 1e-6; dW1 equal (within 1e-6) to the exact
    grouped product of the call's own quantised tiles and scales (``ints``);
    each design counted under its own keys."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    h, b, hw, no, wdt = case
    assert d8.int8_route(hw, h) == "sm90"
    assert d8.int8_route(hw, h, k4_alone_f32=wdt == torch.float32) == "sm90"
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    coords = torch.nn.functional.pad(
        coords, (0, 0, 0, hw - coords.shape[0])).contiguous()
    g = torch.randn((b, no, hw), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(h))
    w = d8.Int8Weights(*ws)
    ref = (w.w1q, w.sw, w.b1, w.wht)
    pt = d8.pick_tile(hw)
    d8.reset_launches()
    with torch.no_grad():
        y, a1 = d8.run_int8_tail(fold, coords, w, emit_a1=True)
        y0 = d8.run_int8_tail(fold, coords, w, passes="sm90")
        y_ref, a1_ref = d8.decoder_tail_int8_reference(
            fold, coords, *ref, w.bht, return_a1=True)
        yb, a1b = d8.run_int8_tail(fold, coords, w, emit_a1=True,
                                   passes="block")
        for got, want, tol in ((y, y_ref, INT8_Y_TOL), (y0, y_ref, INT8_Y_TOL),
                               (a1, a1_ref, INT8_A1_TOL), (y, yb, INT8_Y_TOL),
                               (a1, a1b, INT8_A1_TOL)):
            d = (got.float() - want.float()).abs()
            assert d.max().item() <= tol[0] and d.mean().item() <= tol[1]
        assert torch.equal(y, y0)
        del y_ref, a1_ref, yb, a1b
        for a in (a1, None):
            got, (aq, qq, gscale) = d8.run_int8_tail_backward(
                fold, coords, w, a, y, g, ints=True)
            again = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            chunked = d8.run_int8_tail_backward(fold, coords, w, a, y, g,
                                                workspace_bytes=1)
            old = d8.run_int8_tail_backward(fold, coords, w, a, y, g,
                                            passes="block")
            want = d8.decoder_tail_int8_backward_reference(
                fold, coords, *ref, a, y, g)
            for u, v, c, o, x in zip(got, again, chunked, old, want):
                assert torch.isfinite(u).all()
                assert torch.equal(u, v)
                _assert_rel(c, u, (1e-6, 1e-7))
                _assert_rel(u, x, INT8_TOL)
                _assert_rel(u, o, K45W_BLOCK_TOL)
            assert not got[0][:, 3].any()
            own = d8.grouped_int_product(aq.float(), qq.float(),
                                         gscale.reshape(b, hw // pt), pt)
            _assert_rel(got[1], own, (1e-6, 1e-7))
            del got, again, chunked, old, want, aq, qq, own
    assert d8.LAUNCHES == {
        **dict.fromkeys(d8.LAUNCHES, 0), "fwd_sm90": 1, "fwd_acts_sm90": 1,
        "fwd_acts": 1, "bwd_scale": 2, "bwd_grad": 2, "dw": 2,
        "bwd_scale_sm90": 3 + (2 + b), "bwd_grad_sm90": 2 * (2 + b),
        "dw_sm90": 2 * (2 + b), "sum": 4 * 8}


def test_int8_wide_entry_points_refuse_other_calls(cuda_device):
    """The wide passes' entry points refuse H <= 512, a pixel count that is
    not a multiple of 256 and a workspace of fewer slots than one cluster;
    a failed launch raises, with no fallback."""
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    lib = fd._lib()
    assert min(d8.sm90_max_clusters(wide=True).values()) >= 1
    for h, hw, nslots in ((512, 4096, 132), (1000, 4160, 132),
                          (1000, 4096, 3)):
        fold, coords, ws = _int8_inputs(2, hw, h, 3, torch.bfloat16,
                                        cuda_device)
        w = d8.Int8Weights(*ws)
        sw, b1, wht, bht = w.operands()
        y = torch.empty((2, 3, hw), device=cuda_device)
        slots = torch.empty((132 * 64 * 1024,), dtype=torch.int8,
                            device=cuda_device)
        err = lib.svt_int8_90w_fwd(
            fold.data_ptr(), coords.data_ptr(), w.slabs90w_t().data_ptr(),
            sw.data_ptr(), b1.data_ptr(), wht.data_ptr(), bht.data_ptr(),
            y.data_ptr(), None, slots.data_ptr(), nslots, 2, hw, h, 3, 1,
            None)
        assert err != 0
    with pytest.raises(ValueError):
        d8.int8_route(4160, 1000, "sm90")


def test_int8_cluster_kernels_are_resident(cuda_device):
    """The card holds resident clusters of every cluster kernel of K4 and
    K5, and the entry points refuse a call the route table would not send
    them."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    assert min(d8.sm90_max_clusters().values()) >= 1
    fold, coords, ws = _int8_inputs(2, 4096, 500, 3, torch.bfloat16,
                                    cuda_device)
    # 4,160 pixels: not a multiple of 256
    coords = torch.nn.functional.pad(coords, (0, 0, 0, 64)).contiguous()
    assert d8.int8_route(coords.shape[0], 500) == "block"
    with pytest.raises(ValueError):
        d8.run_int8_tail(fold, coords, d8.Int8Weights(*ws), passes="sm90")


@pytest.mark.parametrize("passes", [None, "sm90", "block"])
def test_int8_evaluation_follows_the_step(passes, cuda_device, monkeypatch):
    """An int8 trainer with float32 compute (the default) evaluates its own
    parameters through K4 alone, and its step kernel writes them in place
    through raw pointers: after a step the evaluation's decode is the plain
    version's on the updated weights (on the card, from the same pose
    fold), on the table's passes and on each design."""
    import functools

    from spatialvae_torch.config import InferenceConfig
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=2)
    tr = Trainer(q_cfg, p_cfg, ElboConfig(fused=True, int8=True, channels=3),
                 TrainConfig(minibatch_size=8, learning_rate=1e-2),
                 coord_grid(64, 64, device=cuda_device), device=cuda_device)
    if passes is not None:
        monkeypatch.setattr(d8, "run_int8_tail", functools.partial(
            d8.run_int8_tail, passes=passes))
    gen = torch.Generator(cuda_device).manual_seed(5)
    y = torch.rand((8, 4096, 3), device=cuda_device, generator=gen)
    theta = torch.randn((8,), device=cuda_device, generator=gen)
    dx = 0.1 * torch.randn((8, 2), device=cuda_device, generator=gen)
    z = torch.randn((8, 20), device=cuda_device, generator=gen)

    def decode(net):
        with torch.no_grad():
            return d8.fused_spatial_generator_int8(net, tr.coords, theta, dx,
                                                   z)

    def plain(fold, coords, w, emit_a1=False, passes=None):
        return d8.decoder_tail_int8_reference(fold, coords, w.w1q, w.sw,
                                              w.b1, w.wht, w.bht, emit_a1)

    before = decode(tr.p_net)
    assert torch.isfinite(tr.train_step(y)).all()
    after = decode(tr.p_net)
    monkeypatch.setattr(d8, "run_int8_tail", plain)
    want = decode(tr.p_net)
    assert (before - want).abs().max().item() > 10 * INT8_Y_TOL[0]
    d = (after - want).abs()
    assert d.max().item() <= INT8_Y_TOL[0]
    assert d.mean().item() <= INT8_Y_TOL[1]


def test_k3_cluster_pieces_are_exact(cuda_device):
    """The cluster passes' a0 chain (seven thresholds) equals clip(round(7
    tanh(x)), -7, 7) at all 2^32 float inputs; the product on the cluster
    ring (W1's slabs multicast, int8 wgmma) equals the exact product word
    for word at K = 512 and 128; the card holds clusters of every kernel."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    assert min(l8.sm90_max_clusters().values()) >= 1
    assert l8.sm90_chain_check(cuda_device) == 0
    gen = torch.Generator(cuda_device).manual_seed(4)
    for h in (500, 96):
        a = torch.randint(-7, 8, (12, 64, 512), generator=gen,
                          device=cuda_device, dtype=torch.int8)
        a[..., l8.padded_hidden(h):] = 0
        w = torch.randint(-7, 8, (h, h), generator=gen, device=cuda_device,
                          dtype=torch.int8)
        assert torch.equal(l8.sm90_tile_product(a, w),
                           l8.sm90_tile_product_reference(a, w))
    with pytest.raises(ValueError):
        l8.sm90_tile_product(a[:3], w)


def test_device_philox_is_the_plain_one(cuda_device):
    """The kernels' Philox4x32-10 against the plain version on random
    counters and both sites' keys, and the Random123 known answer."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import philox as px

    gen = torch.Generator(cuda_device).manual_seed(0)
    ctr = torch.randint(0, 2 ** 32, (10000, 4), generator=gen,
                        device=cuda_device, dtype=torch.int64)
    for key in ((0x3F800000, px.SITE_FWD), (0xBF123456, px.SITE_GRAD)):
        got = l8.philox_device(ctr, key)
        want = torch.stack(px.philox4x32_10(
            tuple(ctr[:, i] for i in range(4)), key), dim=1)
        assert torch.equal(got, want)
    kat = torch.tensor([[0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344]],
                       device=cuda_device)
    assert l8.philox_device(kat, (0xA4093822, 0x299F31D0)).tolist() == [
        [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]


@pytest.mark.parametrize("mode", ["i4", "i8"])
@pytest.mark.parametrize("side", [64, 28])
def test_k8_matches_plain_version(mode, side, cuda_device):
    """K8 (K3's kernels in the feature-major kernel's modes) against its
    plain version, at 64x64 (groups of 1024) and at 28x28 (one unpadded
    group of 784, padded to 832 on the card with a zero mask); its launches
    count in its own LAUNCHES and not in K3's."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import fused_loss_int8_t as lt

    b, h, no = 4, 500, 3
    fold, coords, ws = _int8_inputs(b, side * side, h, no, torch.bfloat16,
                                    cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(3)
    yt = torch.rand((b, no, side * side), generator=gen, device=cuda_device)
    fold_t = fold.transpose(1, 2).contiguous()
    l8.reset_launches()
    lt.reset_launches()
    with torch.no_grad():
        got = lt.run_loss_int8_t(fold_t, coords, *ws, yt, mode)
        again = lt.run_loss_int8_t(fold_t, coords, *ws, yt, mode)
        want = lt.loss_int8_t_reference(fold_t, coords, *ws, yt, mode)
    for u, v, x in zip(got, again, want):
        assert torch.equal(u, v)
        _assert_rel(u, x, INT8_TOL)
    # dfoldT's three gradient columns on their own scale
    _assert_rel(got[0][..., :3], want[0][..., :3], DH0_TOL)
    assert lt.LAUNCHES["fwd"] == lt.LAUNCHES["grad"] == 2
    assert not any(l8.LAUNCHES.values())


@pytest.mark.parametrize("h", WIDTHS)
def test_int8_kernels_at_any_width(h, cuda_device):
    """K4, K5 (residual and recompute), K3 in its four families and K8 at
    every width of WIDTHS against their plain versions, bf16 weights (f32
    for K4/K5 at the odd widths); the quantisation groups are the default
    width's."""
    import torch.nn.functional as F
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import fused_loss_int8_t as lt

    b = _wide_b(h) if h <= 2048 else 2
    b += b % 2                                    # K3 takes even batches
    wdt = torch.float32 if h % 2 else torch.bfloat16
    fold, coords, ws = _int8_inputs(b, 1024, h, 3, wdt, cuda_device)
    g = torch.randn((b, 3, 1024), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    w = d8.Int8Weights(*ws)
    ref = (w.w1q, w.sw, w.b1, w.wht)
    with torch.no_grad():
        y, a1 = d8.run_int8_tail(fold, coords, w, emit_a1=True)
        y_ref, a1_ref = d8.decoder_tail_int8_reference(
            fold, coords, *ref, w.bht, return_a1=True)
        for got, want, tol in ((y, y_ref, INT8_Y_TOL),
                               (a1, a1_ref, INT8_A1_TOL)):
            d = (got.float() - want.float()).abs()
            assert d.max().item() <= tol[0] and d.mean().item() <= tol[1]
        for a in (a1, None):
            got = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            want = d8.decoder_tail_int8_backward_reference(
                fold, coords, *ref, a, y, g)
            for u, x in zip(got, want):
                _assert_rel(u, x, INT8_TOL)
    gen = torch.Generator(cuda_device).manual_seed(2)
    for family in ("bernoulli", "gaussian", "colored", "padded"):
        no = {"gaussian": 1, "colored": 2}.get(family, 3)
        side = 28 if family == "padded" else 32
        hw = side * side
        fold, coords, ws = _int8_inputs(b, hw, h, no, torch.bfloat16,
                                        cuda_device)
        k = torch.randint(0, 256, (b, no, hw // no if no == 2 else hw),
                          generator=gen, device=cuda_device)
        yt = (k - 128).to(torch.int8)
        mask = None
        fam = "bernoulli" if family == "padded" else family
        if family == "colored":
            coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
        elif family == "padded":
            pad = l8.padded_hw(hw) - hw
            coords = F.pad(coords, (0, 0, 0, pad))
            yt = F.pad(yt, (0, pad), value=-128)
            mask = F.pad(torch.ones(hw, device=cuda_device), (0, pad))
        with torch.no_grad():
            got = l8.run_loss_int8(fold, coords, *ws, yt, mask, fam)
            want = l8.loss_int8_reference(fold, coords, *ws, yt, mask, fam)
        for u, x in zip(got, want):
            _assert_rel(u, x, INT8_TOL)
    fold, coords, ws = _int8_inputs(b, 1024, h, 3, torch.bfloat16,
                                    cuda_device)
    yt = torch.rand((b, 3, 1024), generator=gen, device=cuda_device)
    fold_t = fold.transpose(1, 2).contiguous()
    for mode in ("i4", "i8"):
        with torch.no_grad():
            got = lt.run_loss_int8_t(fold_t, coords, *ws, yt, mode)
            want = lt.loss_int8_t_reference(fold_t, coords, *ws, yt, mode)
        for u, x in zip(got, want):
            _assert_rel(u, x, INT8_TOL)


# K3's measurement levers (K3 (g)): (B, HW, H, No, weight dtype, Numerics
# fields); the widths below and above 512, the galaxy shape, a colored case
LEVER_CASES = [
    (4, 4096, 500, 3, torch.bfloat16, dict(db1="qi")),
    (4, 4096, 500, 3, torch.bfloat16, dict(a1q=True)),
    (4, 4096, 500, 3, torch.float32, dict(tanh="pade")),
    (4, 4096, 500, 3, torch.bfloat16, dict(a1q=True, db1="qi", sr=True)),
    (2, 1024, 768, 3, torch.bfloat16, dict(a1q=True, tanh="pade")),
    (2, 1024, 130, 1, torch.float32, dict(tanh="pade", gscale="tile",
                                          grad_mode="i8")),
]


@pytest.mark.parametrize("case", LEVER_CASES, ids=lambda c: "-".join(
    [f"B{c[0]}-HW{c[1]}-H{c[2]}-No{c[3]}", str(c[4])[6:],
     *(f"{k}={v}" for k, v in c[5].items())]))
def test_loss_kernel_levers_match_plain_version(case, cuda_device):
    """Each measurement lever of K3 against its plain version within the K3
    limits; two runs agree bit for bit."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics

    b, hw, h, no, wdt, kw = case
    nm = Numerics(**kw)
    fold, coords, ws = _int8_inputs(b, hw, h, no, wdt, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    k = torch.randint(0, 256, (b, no, hw), generator=gen, device=cuda_device)
    yt = (k - 128).to(torch.int8)
    mask = (torch.rand(hw, generator=gen, device=cuda_device) > 0.3).float()
    with torch.no_grad():
        got = l8.run_loss_int8(fold, coords, *ws, yt, mask, numerics=nm)
        again = l8.run_loss_int8(fold, coords, *ws, yt, mask, numerics=nm)
        want = l8.loss_int8_reference(fold, coords, *ws, yt, mask,
                                      numerics=nm)
    for u, v, x in zip(got, again, want):
        assert torch.equal(u, v)
        _assert_rel(u, x, INT8_TOL)


@pytest.mark.parametrize("cut", [3, 4, 5, 6, 7, 8])
def test_loss_kernel_phase_cut(cut, cuda_device):
    """``PHASE_CUT=k`` on the card: the cut phases' outputs are zero, the
    rest match the plain version, and the cut removes launches (no gradient
    pass below 4, no dW1 below 6)."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics

    nm = Numerics(phase_cut=cut)
    fold, coords, ws = _int8_inputs(4, 4096, 500, 3, torch.bfloat16,
                                    cuda_device)
    k = torch.randint(0, 256, (4, 3, 4096), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(2))
    yt = (k - 128).to(torch.int8)
    l8.reset_launches()
    with torch.no_grad():
        got = l8.run_loss_int8(fold, coords, *ws, yt, numerics=nm)
        want = l8.loss_int8_reference(fold, coords, *ws, yt, numerics=nm)
    for u, x in zip(got, want):
        _assert_rel(u, x, INT8_TOL)
    sfx = "_sm90" if cut == 8 else ""        # no cut: the default numerics
    assert l8.LAUNCHES["grad" + sfx] == (cut >= 4)
    assert l8.LAUNCHES["dw" + sfx] == (cut >= 6)
    assert not got[0][:, :3].any() if cut < 8 else got[0][:, :3].any()


# the probe kernels (kernels/probes.py): (dims, M, N, K) of each layout at
# both block tiles, ragged against every tile and k slab
PROBE_GEMMS = [
    (((1,), (0,)), 200, 70, 500), (((1,), (1,)), 130, 40, 900),
    (((0,), (0,)), 100, 96, 500), (((0,), (0,)), 64, 33, 1300),
    (((1,), (0,)), 500, 300, 2048), (((1,), (1,)), 70, 200, 260)]


@pytest.mark.parametrize("elem", ["s8", "s4"])
@pytest.mark.parametrize("dims,m,n,k", PROBE_GEMMS)
def test_probe_gemm_matches_plain_version(dims, m, n, k, elem, cuda_device):
    """Every layout, tile and arm of the probe GEMM: the output rows and
    every block's sum over its steps equal the plain version's, on full-range
    int8 values (s8) and on values the 4-bit cast wraps (s4)."""
    from spatialvae_torch.kernels import probes

    g = torch.Generator(cuda_device).manual_seed(m + n + k)
    lim = 128 if elem == "s8" else 9
    code = probes.DIMS[dims]
    a = torch.randint(-lim + 1, lim, (k, m) if code == 2 else (m, k),
                      generator=g, device=cuda_device, dtype=torch.int8)
    b = torch.randint(-lim + 1, lim, (n, k) if code == 1 else (k, n),
                      generator=g, device=cuda_device, dtype=torch.int8)
    for steps, rows in ((1, m), (37, 8)):
        got = probes.gemm(a, b, dims, steps=steps, out_rows=rows, elem=elem)
        want = probes.gemm_reference(a, b, dims, steps=steps, out_rows=rows,
                                     elem=elem)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("store", ["int32", "int16", "bfloat16", "float32"])
def test_probe_gemm_stores_match_plain_version(store, cuda_device):
    """The accumulator stores on values in [-7, 7] and on full-range int8
    values (int16 saturates there, bf16 rounds)."""
    from spatialvae_torch.kernels import probes

    g = torch.Generator(cuda_device).manual_seed(5)
    for lim, elem in ((8, "s8"), (8, "s4"), (128, "s8")):
        a = torch.randint(-lim + 1, lim, (300, 512), generator=g,
                          device=cuda_device, dtype=torch.int8)
        w = torch.randint(-lim + 1, lim, (512, 200), generator=g,
                          device=cuda_device, dtype=torch.int8)
        kw = dict(steps=5, out_rows=300, elem=elem, store=store)
        got = probes.gemm(a, w, ((1,), (0,)), **kw)
        want = probes.gemm_reference(a, w, ((1,), (0,)), **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_probe_build_t_transpose_sum_and_pack(cuda_device):
    """probe_build_t, probe_transpose_sum and probe_pack_s4 equal to their
    plain versions."""
    from spatialvae_torch.kernels import probes

    g = torch.Generator(cuda_device).manual_seed(6)
    xT = torch.randn((4, 1024), generator=g, device=cuda_device)
    foldT = torch.randn((3, 500, 4), generator=g, device=cuda_device)
    got, want = probes.build_t(xT, foldT, 256), probes.build_t_reference(
        xT, foldT, 256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a = torch.randint(-127, 128, (2048, 500), generator=g,
                      device=cuda_device, dtype=torch.int8)
    for steps in (1, 40):
        got = probes.transpose_sum(a, steps)
        want = probes.transpose_sum_reference(a, steps)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for kdim, x in ((1, a), (0, a)):
        assert torch.equal(probes.pack_s4(x, kdim),
                           probes.pack_s4_reference(x, kdim))


# the int8 kernel microbenchmark's kernels (kernels/kernel_bench.py), each
# against its plain version at H = 40, 500 (one 512-column chunk) and 513
# (the wide path), with odd and even image counts; chip_smoke.kb_check
# holds the limits (integer outputs and per-block sums in every word)
KB_CASES = [(b, h) for h in (40, 500, 513) for b in (3, 2)]


def _kb_arrays(b, h, device, hw=1024, pt=256, monkeypatch=None):
    from spatialvae_torch.tools import kernel_bench as tool

    monkeypatch.setattr(tool, "H", h)
    return tool, tool.make_arrays(b, hw, pt, device, seed=b + h), hw, pt


@pytest.mark.parametrize("b,h", KB_CASES)
def test_kernel_bench_runs_match_plain_versions(b, h, cuda_device,
                                                monkeypatch):
    """Every run of the port's tool (the T1 kernels and the K3, K4, K5, K8
    runs) at HW = 1,024 (the loss kernels' least) and pt = 256 against its
    plain version, twice bit for bit, and every T1 kernel's launch counter
    moves."""
    tool, arrays, hw, pt = _kb_arrays(b, h, cuda_device,
                                      monkeypatch=monkeypatch)
    _kb_runs_match(tool, arrays, b, hw, pt)


def _kb_runs_match(tool, arrays, b, hw, pt) -> dict:
    """Every run against its plain version and twice bit for bit, every
    T1 kernel's counter moved; returns each run's number of step groups
    (the first dimension of its per-block sums; 0 for a run without)."""
    import chip_smoke
    from spatialvae_torch.kernels import kernel_bench as kb

    kb.reset_launches()
    groups = {}
    for run in tool.runs(b, hw, pt):
        if b % 2 and run.name in ("fused-loss", "fused-t"):
            continue                  # K3 and K8 take image pairs
        if run.prepare:
            arrays.update(run.prepare(arrays))
        got = run.fn(arrays)
        want = run.plain(arrays)
        torch.cuda.synchronize()
        chip_smoke.kb_check(torch, run.name, got, want)
        again = run.fn(arrays)
        for x, y in zip(list(got[0]) + list(got[1]),
                        list(again[0]) + list(again[1])):
            assert torch.equal(x, y), run.name
        groups[run.name] = got[1][0].shape[0] if got[1] else 0
    for key in ("gemm_multi:gemm2", "gemm_multi:gemm3", "rows_sum:gemm2",
                "chain:dep", "chain:rows", "chain:ind_rows", "chain:ind_sums",
                "chain:sums", "fwd_pipe2", "fwd_pipe4", "plain_scale",
                "plain_grad", "plain_dw", "plain_sum", "fix_grad", "fix_dw",
                "fix_sum"):
        assert kb.LAUNCHES.get(key, 0) >= 2, (key, kb.LAUNCHES)
    return groups


# at least 32 steps, so the chain, fwd-pipe and GEMM kernels split the grid
# into 2, 3 or 4 groups of consecutive steps (a group boundary inside an
# image at b = 9)
KB_GROUP_CASES = [(9, 40, 2), (12, 513, 3), (16, 500, 4)]


@pytest.mark.parametrize("b,h,groups", KB_GROUP_CASES)
def test_kernel_bench_step_groups_match_plain_versions(b, h, groups,
                                                       cuda_device,
                                                       monkeypatch):
    """As above with the grid in several step groups: each group's sums,
    the group that keeps the last step's rows and column sums."""
    from spatialvae_torch.kernels import kernel_bench as kb

    tool, arrays, hw, pt = _kb_arrays(b, h, cuda_device,
                                      monkeypatch=monkeypatch)
    assert kb.step_groups(kb.grid_steps(b, hw, pt), 1) == groups
    got = _kb_runs_match(tool, arrays, b, hw, pt)
    for name in ("gemm1", "gemm2", "gemm3", "gemm1+vpu", "vpu-only",
                 "gemm1+ivpu", "gemm1+ivpu2", "vpu-full"):
        assert got[name] > 1, (name, got[name])


def test_kernel_bench_gemms_at_pt_2048(cuda_device):
    """gemm2 and gemm3 with k = pt = 2,048 (dW on the 64 x 32 split-k
    tiles, as at the tool's defaults), ragged H."""
    from spatialvae_torch.kernels import kernel_bench as kb

    g = torch.Generator(cuda_device).manual_seed(9)
    a = torch.randint(-127, 128, (2048, 300), generator=g, device=cuda_device,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (300, 300), generator=g, device=cuda_device,
                      dtype=torch.int8)
    for run in ("gemm2", "gemm3"):
        for steps, groups in ((37, 1), (48, 3)):
            got = kb.gemm_multi(run, a, a, w, steps)
            want = kb.gemm_multi_reference(run, a, a, w, steps)
            assert got[1].shape[0] == groups
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def test_kernel_bench_wrappers_raise_on_the_card(cuda_device):
    from spatialvae_torch.kernels import kernel_bench as kb

    f = torch.zeros((2, 4, 40), device=cuda_device)
    c = torch.zeros((256, 2), device=cuda_device)
    with pytest.raises(ValueError, match="several devices"):
        kb.chain("sums", f, c.cpu(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        kb.chain("sums", f.transpose(0, 2).contiguous().transpose(0, 2), c,
                 64)


# ---------------------------------------------------------------------------
# the vanilla generator, the PNG writer and the galaxy CLI on the card
# ---------------------------------------------------------------------------

def _vanilla_trainer(device):
    from spatialvae_torch.config import InferenceConfig, VanillaGeneratorConfig
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=16 * 16 * 3, latent_dim=4, hidden_dim=64,
                            num_layers=2)
    p_cfg = VanillaGeneratorConfig(n=16 * 16 * 3, latent_dim=4,
                                   hidden_dim=64, num_layers=2)
    return Trainer(q_cfg, p_cfg,
                   ElboConfig(vanilla=True, rotate=False, translate=False,
                              channels=3, fused=True),
                   TrainConfig(minibatch_size=8), coord_grid(16, 16),
                   device=device)


def test_vanilla_step_on_the_card_matches_the_cpu(cuda_device):
    """One vanilla training step from the same weights, batch and noise:
    the card (cuBLAS products, Adam's step kernel) against the CPU (plain
    versions); aux rtol 1e-5, every weight rtol 1e-5 with a floor of 1e-5
    of its leaf's largest value (the CPU parity tests' limits).  On the
    card the step launches Adam's step kernel once and no decoder or loss
    kernel."""
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    cpu, card = _vanilla_trainer("cpu"), _vanilla_trainer(cuda_device)
    card.q_net.load_state_dict(cpu.q_net.state_dict())
    card.p_net.load_state_dict(cpu.p_net.state_dict())
    g = torch.Generator().manual_seed(11)
    y = torch.randint(0, 256, (8, 256, 3), generator=g).float() / 255
    noise = torch.randn((8, 4), generator=g)
    for m in (fd, d8, l8, ka):
        m.reset_launches()
    want = cpu.train_step(y, noise=noise)
    got = card.train_step(y.to(cuda_device), noise=noise.to(cuda_device))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    for name, p in cpu.named_params().items():
        q = card.named_params()[name].detach().cpu()
        floor = 1e-5 * (p.detach().abs().max().item() or 1.0)
        torch.testing.assert_close(q, p.detach(), rtol=1e-5, atol=floor)
    assert ka.LAUNCHES["adam_step"] == 1
    assert not any(fd.LAUNCHES.values()) and not any(d8.LAUNCHES.values())
    assert not any(l8.LAUNCHES.values())


def test_png_writer_takes_card_tensors(cuda_device, tmp_path):
    from spatialvae_torch.io.png import read_png, save_image_grid

    g = torch.Generator(cuda_device).manual_seed(12)
    x = torch.rand((37, 9 * 7, 3), generator=g, device=cuda_device)
    save_image_grid(x, str(tmp_path / "card.png"), (9, 7))
    save_image_grid(x.cpu().numpy(), str(tmp_path / "host.png"), (9, 7))
    assert (tmp_path / "card.png").read_bytes() == \
        (tmp_path / "host.png").read_bytes()
    assert read_png(str(tmp_path / "card.png")).shape == (87, 63, 3)


# arm -> (extra argv, kernels that must launch, that must not, K1 launches
# a dump): chip_smoke.py's [cli_images] arms (a) and (b) at a small width
GALAXY_CLI_ARMS = {
    "float": ([], ("k1", "k2", "adam"), ("k3", "k45", "k8"), None),
    "int8": (["--int8-decoder", "--compute-dtype", "bfloat16"],
             ("k1", "k3", "k45", "adam"), ("k2", "k8"), 2),
}


@pytest.mark.parametrize("arm", list(GALAXY_CLI_ARMS))
def test_galaxy_cli_epoch_on_the_card(cuda_device, tmp_path, monkeypatch,
                                      arm):
    """One galaxy CLI epoch with ``-d -2`` (32x32x3 images, 64 and 32
    wide, rotation augmentation, B=16 with a tail of 8): the kernels it
    launches are those of the smoke's arm, Adam's step kernel once a step,
    and the tree holds its grids and checkpoints."""
    import logging

    import numpy as np

    from spatialvae_torch.cli import train_galaxy
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import fused_loss_int8_t as lt

    extra, must, must_not, k1_dump = GALAXY_CLI_ARMS[arm]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SPATIALVAE_ASSUME_YES", "1")
    rng = np.random.RandomState(13)
    np.save("gt.npy", (rng.rand(56, 32, 32, 3) * 255).astype(np.uint8))
    np.save("gv.npy", (rng.rand(20, 32, 32, 3) * 255).astype(np.uint8))
    for m in (fd, d8, l8, lt, ka):
        m.reset_launches()
    handlers = logging.root.handlers[:]
    try:
        train_galaxy.main(["gt.npy", "gv.npy", "-d", "-2", "--num_epochs",
                           "1", "--minibatch_size", "16", "--p_hidden_dim",
                           "64", "--q_hidden_dim", "32", "--save_prefix",
                           "g", "--save_interval", "1",
                           "--augment_rotation"] + extra)
        torch.cuda.synchronize()
    finally:
        for h in logging.root.handlers[:]:
            if h not in handlers:
                logging.root.removeHandler(h)
    k1 = sum(v for k, v in fd.LAUNCHES.items()
             if k.startswith("fwd") and "recompute" not in k)
    counts = {"k1": k1, "k2": sum(fd.LAUNCHES.values()) - k1,
              "k3": sum(l8.LAUNCHES.values()),
              "k45": sum(d8.LAUNCHES.values()),
              "k8": sum(lt.LAUNCHES.values()),
              "adam": ka.LAUNCHES["adam_step"]}
    for k in must:
        assert counts[k] > 0, counts
    for k in must_not:
        assert counts[k] == 0, counts
    assert counts["adam"] == 4, counts                # 3 steps of 16 + 8
    if k1_dump is not None:
        assert counts["k1"] == k1_dump, counts
    images = sorted(os.listdir(tmp_path / "outputs_g" / "images"))
    assert [f for f in images if f.startswith("1_")] == [
        "1_dis_g_z2pnl2qnl2ep1.png", "1_g_z2pnl2qnl2ep1.png",
        "1_rnd_g_z2pnl2qnl2ep1.png"]
    assert sorted(os.listdir(tmp_path / "outputs_g" / "trained")) == [
        "g_generator_epoch1.sav", "g_inference_epoch1.sav"]


# --------------------------------------------------------------------------
# long runs: host-resident streaming, bf16 Adam checkpoints, the trace


def _long_run_trainer(int8: bool, dtype="bfloat16", seed=0):
    from spatialvae_torch.config import InferenceConfig
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer

    q_cfg = InferenceConfig(n=64 * 64 * 3, latent_dim=23, hidden_dim=256,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=500, n_out=3,
                                   num_layers=2)
    return Trainer(q_cfg, p_cfg,
                   ElboConfig(fused=True, int8=int8, channels=3),
                   TrainConfig(minibatch_size=64, compute_dtype=dtype,
                               seed=seed, image_shape=(64, 64), channels=3),
                   coord_grid(64, 64), device="cuda")


def _long_run_images(n=2048):
    import numpy as np

    rng = np.random.default_rng(17)
    return (rng.integers(0, 256, (n, 64 * 64, 3)) / 255.0).astype(np.float32)


def test_streamed_epoch_keeps_no_device_copy(cuda_device):
    """The int8 trainer (bf16 compute) on 2,048 64x64x3 images at B=64: the
    streamed epoch's peak device memory lies below the preloaded epoch's
    (whose dataset, target copy and encoder-input copy sit on the card) by
    at least the dataset's bytes, and it trains to finite metrics; a
    streamed float epoch equals the preloaded one."""
    import numpy as np

    from spatialvae_torch.data.dataset import ArrayDataset

    y = _long_run_images()
    peaks, rows = {}, {}
    for preload in (True, False):
        torch.cuda.empty_cache()
        tr = _long_run_trainer(True)
        data = ArrayDataset.from_numpy(y, preload=preload)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows[preload] = tr.train_epoch(data, 0, progress=False)
        torch.cuda.synchronize()
        peaks[preload] = torch.cuda.max_memory_allocated()
        assert tr._yt_cache == {} if not preload else tr._yt_cache
        del tr, data
    assert np.isfinite(rows[False]).all()
    assert peaks[True] - peaks[False] >= y.nbytes, (peaks, y.nbytes)
    got = []
    for preload in (True, False):
        tr = _long_run_trainer(False, "float32")
        data = ArrayDataset.from_numpy(y[:640], preload=preload)
        got.append([tr.train_epoch(data, 0, progress=False),
                    tr.eval_epoch(data, 0)])
        del tr, data
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)


def test_bf16_optimizer_checkpoint_round_trip_on_the_card(cuda_device,
                                                          tmp_path,
                                                          monkeypatch):
    """bf16 moments trained on the card, through a file and back onto the
    card, bit for bit; the next epoch from the loaded state equals the
    next epoch of the run that never stopped."""
    import numpy as np

    from spatialvae_torch import checkpoint
    from spatialvae_torch.data.dataset import ArrayDataset

    monkeypatch.setenv("SPATIALVAE_ADAM_MOMENTS", "bf16")
    y = _long_run_images(256)
    tr = _long_run_trainer(True)
    data = ArrayDataset.from_numpy(y)
    tr.train_epoch(data, 0, progress=False)
    path = str(tmp_path / "o.sav")
    checkpoint.save_optimizer(path, tr.opt_state, 0, tr.q_net, tr.p_net)
    gp, ip = str(tmp_path / "g.sav"), str(tmp_path / "i.sav")
    checkpoint.save_model(gp, "generator", tr.p_net)
    checkpoint.save_model(ip, "inference", tr.q_net)
    state, epoch = checkpoint.load_optimizer(path, tr.q_net, tr.p_net,
                                             device="cuda")
    assert epoch == 0 and state.count == tr.opt_state.count
    for m in ("mu", "nu"):
        for k, t in getattr(tr.opt_state, m).items():
            u = getattr(state, m)[k]
            assert u.dtype == torch.bfloat16 and u.device.type == "cuda"
            assert torch.equal(u.view(torch.int16), t.view(torch.int16))
    straight = tr.train_epoch(data, 1, progress=False)
    again = _long_run_trainer(True)
    from spatialvae_torch.io.jax_params import (
        generator_from_jax,
        inference_from_jax,
    )

    for path_, net, build in ((gp, again.p_net, generator_from_jax),
                              (ip, again.q_net, inference_from_jax)):
        params, cfg, _, _ = checkpoint.load_model_meta(path_)
        net.load_state_dict(build(params, cfg, device="cpu").state_dict())
    again.opt_state = state
    resumed = again.train_epoch(data, 1, progress=False)
    np.testing.assert_allclose(resumed, straight, rtol=1e-6)


def test_profiler_trace_names_the_port_kernels(cuda_device, tmp_path):
    """``--profile-dir``'s span (``cli/common.chunked_epochs``) on the card:
    the Chrome trace holds the kernels of the float step (K1/K2 on the
    cluster kernels, Adam's step kernel) by their own names."""
    import json

    from spatialvae_torch.cli import common
    from spatialvae_torch.data.dataset import ArrayDataset

    tr = _long_run_trainer(False, "float32")
    data = ArrayDataset.from_numpy(_long_run_images(192))
    out = str(tmp_path / "prof")
    for _ in common.chunked_epochs(tr, data, 0, 3, 1, None, out):
        pass
    with open(common.trace_path(out)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    for name in ("dec_fwd90", "dec_chain90", "dec_dw90",
                 "adam_step_kernel"):
        assert any(name in k for k in kernels), (name, sorted(kernels)[:40])


def test_debug_nans_on_a_nan_image_on_the_card(cuda_device):
    """A float Bernoulli trainer on the card (K1/K2) with ``debug_nans``:
    an image holding a NaN raises ``FloatingPointError`` naming its step,
    where torch's BCE would have hit a device-side assert; the parameters
    are the step before's and the card goes on working."""
    import numpy as np

    from spatialvae_torch.data.dataset import ArrayDataset

    tr = _long_run_trainer(False, "float32")
    tr.debug_nans = True
    y = _long_run_images(192)
    perm = torch.randperm(192, generator=tr._gen(0), device="cuda").cpu()
    bad = int(torch.sort(perm[64:128]).values[5])       # in step 2
    y[bad, 7, 1] = np.nan
    before = []
    step = tr.train_step

    def recording(yb, **kw):
        before.append({k: v.detach().clone()
                       for k, v in tr.named_params().items()})
        return step(yb, **kw)

    tr.train_step = recording
    with pytest.raises(FloatingPointError, match="at epoch 1, step 2 "):
        tr.train_epoch(ArrayDataset.from_numpy(y), 0, progress=False)
    assert len(before) == 2
    for k, v in tr.named_params().items():
        assert torch.equal(v, before[1][k]), k
    assert float(torch.ones(4, device="cuda").sum()) == 4.0


@pytest.mark.parametrize("route,h", [("sm90", 500), ("block", 500),
                                     ("block", 1000)],
                         ids=["cluster", "block", "wide"])
def test_k3_sr_pixel_slices_draw_the_whole_calls_words(route, h,
                                                       cuda_device):
    """Under SR the two 2,048-pixel halves of a 4,096-pixel call, each
    launched with its first pixel (``p_base``), quantise as the whole call
    does: aq word for word, qi within INT_MISMATCH, their sums within K3's
    limits of the whole call's; each half within K3's limits of the plain
    version at the same p_base, aq word for word with it.  Without p_base
    the second half draws other words."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics

    b, hw, no = 4, 4096, 3
    fold, coords, ws = _int8_inputs(b, hw, h, no, torch.bfloat16, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(5)
    yt = (torch.randint(0, 256, (b, no, hw), generator=gen,
                        device=cuda_device) - 128).to(torch.int8)
    nm = Numerics(sr=True)
    block = route == "block" and h <= 512
    assert l8.k3_route(2048, h, 1024, "bernoulli", nm,
                       block_passes=block) == route
    kw = dict(numerics=nm, ints=True, block_passes=block)
    with torch.no_grad():
        whole, (aq, qi) = l8.run_loss_int8(fold, coords, *ws, yt, None,
                                           "bernoulli", **kw)
        halves = []
        for p0 in (0, 2048):
            sl = slice(p0, p0 + 2048)
            args = (fold, coords[sl].contiguous(), *ws,
                    yt[..., sl].contiguous(), None, "bernoulli")
            got = l8.run_loss_int8(*args, p_base=p0, **kw)
            plain = l8.loss_int8_reference(*args, numerics=nm, ints=True,
                                           p_base=p0)
            for u, x in zip(got[0], plain[0]):
                _assert_rel(u, x, INT8_TOL)
            assert torch.equal(got[1][0], plain[1][0])
            halves.append(got)
        _, (aq0, _) = l8.run_loss_int8(
            fold, coords[2048:].contiguous(), *ws,
            yt[..., 2048:].contiguous(), None, "bernoulli", **kw)
    assert torch.equal(torch.cat([t[1][0] for t in halves], dim=1), aq)
    qs = torch.cat([t[1][1] for t in halves], dim=1)
    assert (qs != qi).float().mean().item() <= INT_MISMATCH
    for u, v, w in zip(halves[0][0], halves[1][0], whole):
        _assert_rel(u + v, w, INT8_TOL)
    assert (aq0 != halves[1][1][0]).float().mean().item() > 0.05


def test_dp_step_on_two_ranks_sharing_the_card(cuda_device):
    """Two ranks on the one card, joined over gloo (NCCL refuses two ranks
    on one device): two data-parallel int8 steps of bf16 compute (K3 on
    each rank's two images, Adam's step kernel); every master and shadow
    leaf bit for bit on both ranks."""
    from tests import torch_ranks

    spec = {"q_cfg": {"__class__": "InferenceConfig", "n": 64 * 64 * 3,
                      "latent_dim": 8, "hidden_dim": 256, "num_layers": 2},
            "p_cfg": {"__class__": "SpatialGeneratorConfig",
                      "latent_dim": 5, "hidden_dim": 128, "n_out": 3,
                      "num_layers": 2},
            "ecfg": dict(fused=True, int8=True, channels=3),
            "tcfg": dict(minibatch_size=4, compute_dtype="bfloat16"),
            "shape": (64, 64)}
    import numpy as np

    rng = np.random.default_rng(0)
    y = (rng.integers(0, 256, (8, 64 * 64, 3)) / 255.0).astype(np.float32)
    batches = [np.array([0, 2, 5, 7]), np.array([1, 3, 4, 6])]
    noises = [rng.normal(size=(4, 8)).astype(np.float32) for _ in batches]
    ranks = torch_ranks.spawn(torch_ranks.dp_card, 2, spec, y, batches,
                              noises, device="cuda")
    assert ranks[0].keys() == ranks[1].keys()
    assert any(k.startswith("shadow.") for k in ranks[0])
    for k, v in ranks[0].items():
        assert torch.equal(v, ranks[1][k]), k
