"""The port's fused-decoder forward against the JAX package's Pallas kernel.

On the CPU, ``decoder_tail_reference`` and the wrapper (which takes the
plain version for CPU tensors) are held to JAX's ``fused_decoder_tail`` run
in Pallas interpret mode, at 1e-5 in float32 and 1e-2 in bfloat16 (bf16
operand rounding: a tanh ulp can move an operand across a bf16 rounding
boundary).  The CUDA kernel itself is held to the plain version on the card
by ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.core.config import SpatialGeneratorConfig
from spatialvae_tpu.kernels import fused_decoder as jax_fd
from spatialvae_tpu.models import spatial_generator_init

from spatialvae_torch.io.jax_params import generator_from_jax
from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.models.spatial import (
    SpatialGenerator,
    spatial_generator_apply_folded,
)
from spatialvae_torch.objectives.elbo import ElboConfig, decode_spatial
from spatialvae_torch.precision import fp32_precision_pinned
from spatialvae_torch.transforms.coords import coord_grid

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (Lh, resid, No, weight dtype, HW): every value of each axis appears
CASES = [
    (1, False, 3, torch.float32, 256),
    (1, False, 3, torch.bfloat16, 256),
    (1, True, 1, torch.float32, 784),
    (2, False, 8, torch.float32, 256),
    (2, True, 3, torch.bfloat16, 784),
    (3, True, 8, torch.float32, 784),
    (3, False, 1, torch.bfloat16, 256),
    (4, True, 3, torch.float32, 256),
    (4, False, 8, torch.bfloat16, 784),
]


def _case_id(c):
    lh, resid, no, wdt, hw = c
    return (f"Lh{lh}-{'resid' if resid else 'plain'}-No{no}-"
            f"{str(wdt)[6:]}-HW{hw}")


def _inputs(lh, no, hw, wdt, b=3, h=40, seed=0):
    """numpy f32 inputs (weights already on the weight dtype's grid)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(hw))
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [rng.uniform(-bound, bound, s).astype(np.float32)
          for s in ((lh, h, h), (lh, h), (no, h), (no,))]
    ws = [torch.from_numpy(w).to(wdt).float().numpy() for w in ws]
    return [fold, coord_grid(side, side).numpy()] + ws


def _torch_args(arrs, wdt, device="cpu"):
    fold, coords, *ws = arrs
    return ([torch.from_numpy(fold).to(device),
             torch.from_numpy(coords).to(device)]
            + [torch.from_numpy(w).to(device=device, dtype=wdt) for w in ws])


def _jax_tail(arrs, wdt, resid):
    fold, coords, *ws = arrs
    with pltpu.force_tpu_interpret_mode():
        y = jax_fd.fused_decoder_tail(
            jnp.asarray(fold), jnp.asarray(coords),
            *[jnp.asarray(w, JNP[wdt]) for w in ws], resid)
    return np.asarray(y)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tail_matches_jax_kernel(case):
    lh, resid, no, wdt, hw = case
    arrs = _inputs(lh, no, hw, wdt)
    want = _jax_tail(arrs, wdt, resid)
    args = _torch_args(arrs, wdt)
    with torch.no_grad():
        ref = fd.decoder_tail_reference(*args, resid)
        got = fd.fused_decoder_tail(*args, resid)
    assert got.shape == want.shape == (3, no, hw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=TOL[wdt])
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("n,m,num_layers,resid,softplus,pose", [
    (16, 16, 2, False, False, True),
    (28, 28, 3, True, True, True),
    (16, 16, 2, False, True, False),
])
def test_fused_spatial_generator_matches_jax(n, m, num_layers, resid,
                                             softplus, pose):
    cfg = SpatialGeneratorConfig(latent_dim=4, hidden_dim=48, n_out=3,
                                 num_layers=num_layers, resid=resid,
                                 softplus=softplus)
    params = jax.tree_util.tree_map(
        np.asarray, spatial_generator_init(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(2)
    theta = rng.normal(size=5).astype(np.float32) if pose else None
    dx = (0.1 * rng.normal(size=(5, 2))).astype(np.float32) if pose else None
    z = rng.normal(size=(5, 4)).astype(np.float32)
    grid = coord_grid(n, m)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fd.fused_spatial_generator(params, cfg,
                                              jnp.asarray(grid.numpy()),
                                              theta, dx, z)
    gen = generator_from_jax(params, cfg)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    with torch.no_grad():
        got = fd.fused_spatial_generator(gen, grid, t(theta), t(dx), t(z))
    assert got.shape == (5, n * m, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_can_fuse_decoder_matches_jax_for_tanh():
    for kw in (dict(num_layers=2), dict(num_layers=5), dict(num_layers=6),
               dict(num_layers=1), dict(num_layers=3, resid=True),
               dict(num_layers=2, n_out=8), dict(num_layers=2, n_out=9),
               dict(num_layers=2, expand_coords=True),
               dict(num_layers=2, bilinear=True)):
        cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=500, **kw)
        for hw in (100, 255, 256, 784, 4096):
            assert fd.can_fuse_decoder(cfg, hw) == \
                jax_fd.can_fuse_decoder(cfg, hw), (kw, hw)


def test_can_fuse_decoder_refuses_what_the_kernel_cannot_run():
    """The kernel computes tanh (the JAX gate never checked the activation,
    ROADMAP Queue 3): the port's gate sends other activations to the plain
    folded decoder.  It admits any width, as JAX's does, so a decoder wider
    than MAX_HIDDEN reaches the wrapper, which raises instead of changing
    path."""
    cfg = SpatialGeneratorConfig(latent_dim=2, num_layers=2, activation="relu")
    assert jax_fd.can_fuse_decoder(cfg, 4096)
    assert not fd.can_fuse_decoder(cfg, 4096)
    gen = generator_from_jax(jax.tree_util.tree_map(
        np.asarray, spatial_generator_init(jax.random.PRNGKey(0), cfg)), cfg)
    with pytest.raises(ValueError, match="not supported"):
        fd.fused_spatial_generator(gen, coord_grid(64, 64), None, None,
                                   torch.zeros((2, 2)))
    wide = SpatialGeneratorConfig(latent_dim=2, num_layers=2,
                                  hidden_dim=fd.MAX_HIDDEN + 1)
    assert jax_fd.can_fuse_decoder(wide, 4096)
    assert fd.can_fuse_decoder(wide, 4096)
    gen = SpatialGenerator(wide, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), pytest.raises(ValueError, match="hidden_dim"):
        decode_spatial(gen, ElboConfig(fused=True), coord_grid(16, 16),
                       None, None, torch.zeros((2, 2)))


def _bad_inputs(kind):
    args = _torch_args(_inputs(1, 3, 256, torch.float32), torch.float32)
    fold, coords, whid, bhid, wht, bht = args
    if kind == "no_hidden_layer":
        whid, bhid = whid[:0], bhid[:0]
    elif kind == "five_hidden_layers":
        whid, bhid = whid.repeat(5, 1, 1), bhid.repeat(5, 1)
    elif kind == "nine_outputs":
        wht, bht = wht.repeat(3, 1), bht.repeat(3)
    elif kind == "too_wide":
        h = fd.MAX_HIDDEN + 1
        fold = torch.zeros((3, 4, h))
        whid, bhid = torch.zeros((1, h, h)), torch.zeros((1, h))
        wht, bht = torch.zeros((3, h)), torch.zeros((3,))
    elif kind == "float16_weights":
        whid, bhid, wht, bht = (t.half() for t in (whid, bhid, wht, bht))
    elif kind == "mixed_weight_dtypes":
        wht = wht.bfloat16()
    elif kind == "float64_fold":
        fold = fold.double()
    elif kind == "non_contiguous":
        whid = whid.transpose(1, 2)
    elif kind == "shape_mismatch":
        bhid = bhid[:, :-1]
    elif kind == "fold_rows":
        fold = fold[:, :3].contiguous()
    elif kind == "requires_grad":
        fold = fold.requires_grad_()
    return fold, coords, whid, bhid, wht, bht


@pytest.mark.parametrize("kind", [
    "no_hidden_layer", "five_hidden_layers", "nine_outputs", "too_wide",
    "float16_weights", "mixed_weight_dtypes", "float64_fold",
    "non_contiguous", "shape_mismatch", "fold_rows", "requires_grad"])
def test_wrapper_raises_on_unsupported(kind):
    """Refused on the CPU exactly as on the card: no silent change of
    path."""
    args = _bad_inputs(kind)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        fd.fused_decoder_tail(*args)


def test_cpu_path_counts_no_launch_and_pins_precision(monkeypatch):
    """The plain version runs with full f32 pinned and gives the caller's
    TF32 settings back."""
    args = _torch_args(_inputs(1, 3, 256, torch.float32), torch.float32)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    seen = []
    tanh = torch.tanh

    def spy(x):
        seen.append(fp32_precision_pinned())
        return tanh(x)

    monkeypatch.setattr(torch, "tanh", spy)
    before = fd.fused_decoder_tail.launches
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        assert not fp32_precision_pinned()
        with torch.no_grad():
            fd.fused_decoder_tail(*args)
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev[2])
        torch.backends.cudnn.allow_tf32 = prev[1]
    assert torch.backends.cuda.matmul.allow_tf32 == prev[0]
    assert seen and all(seen)
    assert fd.fused_decoder_tail.launches == before


def test_generator_tail_weights_pack_once_per_weight_version():
    """The stacked weights are cached on the generator and rebuilt when a
    weight changes in place or is replaced."""
    cfg = SpatialGeneratorConfig(latent_dim=3, hidden_dim=24, n_out=3,
                                 num_layers=3)
    gen = SpatialGenerator(cfg, generator=torch.Generator().manual_seed(0))
    grid = coord_grid(16, 16)
    z = torch.randn((2, 3), generator=torch.Generator().manual_seed(1))
    tw = fd.generator_tail_weights(gen)
    assert fd.generator_tail_weights(gen) is tw
    with torch.no_grad():
        y0 = fd.fused_spatial_generator(gen, grid, None, None, z)
        gen.linears()[0].weight.mul_(0.5)              # in place
        tw1 = fd.generator_tail_weights(gen)
        assert tw1 is not tw
        assert torch.equal(tw1.whid[0], gen.linears()[0].weight.T)
        y1 = fd.fused_spatial_generator(gen, grid, None, None, z)
        head = gen.linears()[-1]
        head.bias = torch.nn.Parameter(head.bias + 1)  # replaced
        tw2 = fd.generator_tail_weights(gen)
        assert tw2 is not tw1
        assert torch.equal(tw2.bht, head.bias)
        y2 = fd.fused_spatial_generator(gen, grid, None, None, z)
        want = spatial_generator_apply_folded(gen, grid, None, None, z)
    assert not torch.equal(y0, y1) and not torch.equal(y1, y2)
    torch.testing.assert_close(y2, want, rtol=0, atol=1e-6)
