"""The port's fused-decoder backward and its autograd op against the JAX
package's custom VJP (Pallas ``_fwd_kernel`` with ``emit_acts`` and
``_bwd_kernel``, run in interpret mode), on the CPU.

Tolerances: float32 rtol 1e-5 with an absolute floor of 1e-6 of the
output's largest value (sums over B*HW pixels in another order).  With bf16
weights the operands are rounded to bf16 where the TPU kernel rounds them,
and a tanh ulp between the two packages can move a value across a bf16
rounding boundary (2**-8 relative): the bf16 residual is held at one bf16
ulp (atol 1e-2 on values in [-1, 1]), the gradients at 1e-2 of each
output's largest value.  The CUDA kernels are held to these plain versions
on the card by ``test_torch_port_cuda.py``.
"""

import subprocess
import sys

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
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (Lh, resid, No, weight dtype, HW): every value of each axis appears
CASES = [
    (1, False, 3, torch.float32, 256),
    (1, False, 3, torch.bfloat16, 256),
    (2, True, 1, torch.float32, 400),
    (3, True, 8, torch.float32, 256),
    (2, False, 8, torch.bfloat16, 400),
    (3, True, 1, torch.bfloat16, 256),
]


def _case_id(c):
    lh, resid, no, wdt, hw = c
    return (f"Lh{lh}-{'resid' if resid else 'plain'}-No{no}-"
            f"{str(wdt)[6:]}-HW{hw}")


def _inputs(lh, no, hw, wdt, b=3, h=24, seed=0):
    """numpy f32 fold, coords, weights (on the weight dtype's grid) and a
    cotangent of y."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(hw))
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [rng.uniform(-bound, bound, s).astype(np.float32)
          for s in ((lh, h, h), (lh, h), (no, h), (no,))]
    ws = [torch.from_numpy(w).to(wdt).float().numpy() for w in ws]
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    return [fold, coord_grid(side, side).numpy()] + ws, g


def _close(got, want, wdt, what, floor=1e-6):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) or 1.0
    if wdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale,
                                   err_msg=what)


@pytest.mark.parametrize("saved", [True, False], ids=["residual", "recompute"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_backward_reference_matches_jax_kernel(case, saved):
    lh, resid, no, wdt, hw = case
    arrs, g = _inputs(lh, no, hw, wdt)
    fold, coords, whid, bhid, wht, bht = arrs
    jw = [jnp.asarray(w, JNP[wdt]) for w in (whid, bhid, wht, bht)]
    with pltpu.force_tpu_interpret_mode():
        y, acts = jax_fd._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords),
                                     *jw[:3], jw[3][:, None], resid,
                                     emit_acts=True)
        want = jax_fd._bwd_pallas(jnp.asarray(fold), jnp.asarray(coords),
                                  *jw[:3], acts if saved else None, y,
                                  jnp.asarray(g), resid)
    tw = [torch.from_numpy(w).to(wdt) for w in (whid, bhid, wht, bht)]
    tf, tc = torch.from_numpy(fold), torch.from_numpy(coords)
    ty, tacts = fd.decoder_tail_reference(tf, tc, *tw, resid,
                                          return_acts=True)
    assert tacts.dtype == wdt and tacts.shape == (lh, 3, hw, 24)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=0,
                               atol=1e-5 if wdt == torch.float32 else 1e-2)
    np.testing.assert_allclose(tacts.float().numpy(),
                               np.asarray(acts.astype(jnp.float32)), rtol=0,
                               atol=1e-5 if wdt == torch.float32 else 1e-2)
    # both packages' backward from the JAX forward's y and residual
    got = fd.decoder_tail_backward_reference(
        tf, tc, tw[0], tw[1], tw[2],
        torch.from_numpy(np.array(acts.astype(jnp.float32))).to(wdt)
        if saved else None,
        torch.from_numpy(np.asarray(y)), torch.from_numpy(g), resid)
    names = ("dfold", "dwhid", "dbhid", "dwht", "dbht")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float32
        b = np.asarray(b)
        _close(a.numpy(), b.reshape(a.shape), wdt, name)
    assert not got[0][:, 3].any()


def _generator(num_layers, resid, seed=1, h=32):
    cfg = SpatialGeneratorConfig(latent_dim=4, hidden_dim=h, n_out=3,
                                 num_layers=num_layers, resid=resid)
    params = jax.tree_util.tree_map(
        np.asarray, spatial_generator_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    pose = (rng.normal(size=5).astype(np.float32),
            (0.1 * rng.normal(size=(5, 2))).astype(np.float32),
            rng.normal(size=(5, 4)).astype(np.float32))
    return cfg, params, pose


@pytest.mark.parametrize("n,num_layers,resid", [(16, 2, False),
                                                (20, 4, True)])
def test_autograd_op_matches_jax_grad(n, num_layers, resid):
    """d sum(sin(3y)) / d (params, theta, dx, z) through the port's op
    against jax.grad through the JAX custom VJP.  The pose and first-layer
    gradients sum dfold * w over H with cancellation, hence an absolute
    floor of 1e-5 of each gradient's largest value."""
    cfg, params, pose = _generator(num_layers, resid)
    grid = coord_grid(n, n)

    def loss(params, theta, dx, z):
        y = jax_fd.fused_spatial_generator(params, cfg,
                                           jnp.asarray(grid.numpy()),
                                           theta, dx, z)
        return jnp.sum(jnp.sin(3.0 * y))

    with pltpu.force_tpu_interpret_mode():
        gp, *gpose = jax.grad(loss, argnums=(0, 1, 2, 3))(params, *pose)
    gen = generator_from_jax(params, to_port(cfg))
    tpose = [torch.from_numpy(a).requires_grad_() for a in pose]
    y = fd.fused_spatial_generator(gen, grid, *tpose)
    torch.sin(3.0 * y).sum().backward()
    for t, w in zip(tpose, gpose):
        _close(t.grad.numpy(), w, torch.float32, "pose", 1e-5)
    _close(gen.coord_linear.weight.grad.numpy().T, gp["coord"]["w"],
           torch.float32, "coord.w", 1e-5)
    _close(gen.coord_linear.bias.grad.numpy(), gp["coord"]["b"],
           torch.float32, "coord.b", 1e-5)
    _close(gen.latent_linear.weight.grad.numpy().T, gp["latent"]["w"],
           torch.float32, "latent.w", 1e-5)
    for lin, p in zip(gen.linears(), gp["layers"]):
        _close(lin.weight.grad.numpy().T, p["w"], torch.float32, "w", 1e-5)
        _close(lin.bias.grad.numpy(), p["b"], torch.float32, "b", 1e-5)


def _tail(wdt=torch.float32, lh=2, hw=256):
    arrs, g = _inputs(lh, 3, hw, wdt)
    fold, coords, *ws = arrs
    tw = [torch.from_numpy(w).to(wdt).requires_grad_() for w in ws]
    return (torch.from_numpy(fold).requires_grad_(), torch.from_numpy(coords),
            *tw), torch.from_numpy(g)


def _saved(fn):
    """Tensors that autograd saves while fn runs."""
    packed = []

    def pack(t):
        packed.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, packed


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_forced_recompute_saves_no_residual_and_agrees(wdt):
    """``recompute=True`` saves no activations; both variants give the same
    gradients up to the tanh' factors' precision (the recompute keeps f32
    activations, the bf16 residual does not)."""
    args, g = _tail(wdt)
    grads = []
    for recompute in (False, True):
        y, saved = _saved(lambda: fd.fused_decoder_tail(
            *args, False, recompute=recompute))
        big = [t for t in saved if t is not None and t.dim() == 4]
        assert len(big) == (0 if recompute else 1)
        grads.append(torch.autograd.grad(y, [args[0], *args[2:]], g))
    for a, b in zip(*grads):
        _close(a.float().numpy(), b.float().numpy(), wdt, "variant")


def test_residual_rule_boundary():
    """The residual is saved iff Lh*B*HW*H*itemsize <= the budget; the
    budget is half the device's total memory."""
    lh, b, hw, h = 2, 3, 256, 24
    nbytes = lh * b * hw * h * 4
    assert fd.save_residual(b, hw, h, lh, torch.float32, nbytes)
    assert not fd.save_residual(b, hw, h, lh, torch.float32, nbytes - 1)
    assert fd.save_residual(b, hw, h, lh, torch.bfloat16, nbytes // 2)
    assert not fd.save_residual(b, hw, h, lh, torch.bfloat16,
                                nbytes // 2 - 1)
    import os

    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert fd.residual_budget(torch.device("cpu")) == total // 2
    # galaxy: 819 MB in f32 at B=100 saves on an 80 GB card; B=4096 f32
    # (33.6 GB) saves too, B=5000 (41 GB) recomputes
    card = 80 * 10 ** 9 // 2
    assert fd.save_residual(100, 4096, 500, 1, torch.float32, card)
    assert fd.save_residual(4096, 4096, 500, 1, torch.float32, card)
    assert not fd.save_residual(5000, 4096, 500, 1, torch.float32, card)
    assert fd.save_residual(9000, 4096, 500, 1, torch.bfloat16, card)


def test_rule_decides_the_variant(monkeypatch):
    """At the budget's boundary the op saves the residual; one byte below it
    recomputes."""
    args, g = _tail()
    nbytes = 2 * 3 * 256 * 24 * 4
    for budget, want in ((nbytes, 1), (nbytes - 1, 0)):
        monkeypatch.setattr(fd, "residual_budget", lambda dev, b=budget: b)
        _, saved = _saved(lambda: fd.fused_decoder_tail(*args, False))
        assert len([t for t in saved if t is not None and t.dim() == 4]) \
            == want


def test_serving_under_no_grad_saves_nothing(monkeypatch):
    """A decode under no_grad takes the forward alone: no activations are
    computed for a backward and nothing is saved."""
    cfg, params, pose = _generator(2, False)
    gen = generator_from_jax(params, to_port(cfg))
    calls = []
    ref = fd.decoder_tail_reference

    def spy(*a, **kw):
        calls.append(kw.get("return_acts", False))
        return ref(*a, **kw)

    monkeypatch.setattr(fd, "decoder_tail_reference", spy)
    with torch.no_grad():
        y, saved = _saved(lambda: fd.fused_spatial_generator(
            gen, coord_grid(16, 16), *map(torch.from_numpy, pose)))
    assert calls == [False] and saved == [] and not y.requires_grad
    y, saved = _saved(lambda: fd.fused_spatial_generator(
        gen, coord_grid(16, 16), *map(torch.from_numpy, pose)))
    assert calls == [False, True] and saved and y.requires_grad


def test_port_training_modules_import_no_jax():
    code = ("import sys; import spatialvae_torch.train.trainer, "
            "spatialvae_torch.checkpoint; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
