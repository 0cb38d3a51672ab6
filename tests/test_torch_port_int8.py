"""The port's int8 kernels' plain versions against the JAX package's Pallas
kernels, on the CPU: the int8 decoder forward (K4) and backward (K5), the
fused int8 loss and gradient (K3), their autograd ops, and the decisions
that route a config to them.

The JAX kernels run as the JAX package's own tests run them
(``SPATIALVAE_INTERPRET=1``, default knobs); inputs come from a numpy seed.
Tolerances, each measured on these inputs with a margin of 2-5x:

- Integer tiles (a0q, aq, qi, dh1q) match JAX except where a tanh ulp
  (XLA's CPU tanh against torch's) moves a value across a rounding
  boundary; at HW=1024 that happens to a handful of a0q.  One flip moves
  y by about 1e-4 and a1 by up to one int8 step times |W1q|*sw/127
  (measured 4.3e-3), hence the absolute limits on y and a1.
- Gradients are held by their error relative to each output's largest
  value, max and mean: float sums run in another order (about 1e-6), and
  the flips above move dW1 and dfold by up to 4e-4 (K5) relative.
- K3 with bf16 weights: XLA on the CPU drops two bf16 roundings that the
  kernel as written, JAX evaluated op by op, and the port keep.  In the
  tanh' chain ``one - a1c*a1c`` it subtracts in f32 from the bf16-rounded
  product; in the dh0 chain it multiplies the f32 da0 by the bf16 factor.
  The tanh' factor then differs by up to one bf16 ulp; q moves across a
  half-integer more often, and dW1 differs by up to 1.05e-2 relative (mean
  1.4e-3), db1 by 5.5e-3 (mean 3.3e-4) on these inputs: the wide limits of
  ``test_loss_kernel_matches_jax``.  ``test_bf16_chains_round_op_by_op_as_
  jax`` pins the port's chains to JAX's op-by-op semantics bit for bit, and
  ``test_loss_bf16_matches_jax_with_xla_chains`` gives the port XLA's two
  chains and holds every output to the JAX run at 1e-6 to 1.5e-5.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.kernels import config as jax_kcfg
from spatialvae_tpu.kernels import fused_decoder_int8 as jd8
from spatialvae_tpu.kernels import fused_loss_int8 as jl8
from spatialvae_tpu.models import spatial_generator_init
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives.elbo import fused_loss_active as jax_active
from spatialvae_tpu.train import trainer as jax_trainer

from spatialvae_torch.io.jax_params import generator_from_jax
from spatialvae_torch.kernels import config as kcfg
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.objectives import ElboConfig, fused_loss_active
from spatialvae_torch.train import trainer as port_trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    d = np.abs(got - want)
    scale = float(np.abs(want).max()) or 1.0
    return d.max() / scale, d.mean() / scale


def _assert_rel(got, want, lim, what):
    mx, mean = _rel(got, want)
    assert mx <= lim[0] and mean <= lim[1], (what, mx, mean, lim)


def _inputs(b, h, no, hw, wdt, seed=0):
    """numpy fold, weights on the weight dtype's grid, and a cotangent."""
    rng = np.random.default_rng(seed)
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [rng.uniform(-bound, bound, s).astype(np.float32)
          for s in ((h, h), (h,), (no, h), (no,))]
    ws = [torch.from_numpy(w).to(wdt).float().numpy() for w in ws]
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    return fold, ws, g


def _grid(side, hw):
    """coords of a side x side image zero-padded to hw pixels (784 -> 1024
    as ``fused_spatial_generator_int8`` pads), and the pad's mask."""
    c = coord_grid(side, side).numpy()
    pad = hw - c.shape[0]
    return (np.concatenate([c, np.zeros((pad, 2), np.float32)]),
            np.arange(hw) < side * side)


# ---------------------------------------------------------------------------
# K4 / K5
# ---------------------------------------------------------------------------

# (weight dtype, image side, pixels the kernel sees): 256 is one group;
# 28x28 = 784 pads to 1024
TAIL_CASES = [(torch.float32, 16, 256), (torch.bfloat16, 16, 256),
              (torch.float32, 28, 1024), (torch.bfloat16, 28, 1024)]
Y_TOL = (1e-3, 1e-6)          # absolute: max, mean
A1_TOL = (1e-2, 1e-5)
K5_TOL = (2e-3, 5e-5)         # relative to max|JAX|: max, mean


@pytest.mark.parametrize("saved", [True, False], ids=["residual", "recompute"])
@pytest.mark.parametrize("case", TAIL_CASES,
                         ids=lambda c: f"{str(c[0])[6:]}-{c[1]}px")
def test_int8_tail_matches_jax_kernels(case, saved):
    wdt, side, hw = case
    fold, ws, g = _inputs(4, 64, 3, hw, wdt)
    coords, live = _grid(side, hw)
    g = g * live                                  # no cotangent on the pad
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    w1q, sw = jd8._quant_sym(jw[0])
    y, a1 = jd8._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q, sw,
                            jw[1][None, :], jw[2], jw[3][:, None],
                            emit_acts=True)
    want = jd8._bwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q, sw,
                           jw[1][None, :], jw[2], a1 if saved else None, y,
                           jnp.asarray(g))
    tw = [torch.from_numpy(w).to(wdt) for w in ws]
    w = d8.Int8Weights(*tw)
    assert np.array_equal(w.w1q.numpy(), np.asarray(w1q))
    assert float(w.sw) == float(sw[0, 0])
    tf, tc = torch.from_numpy(fold), torch.from_numpy(coords)
    ty, ta1 = d8.run_int8_tail(tf, tc, w, emit_a1=True)
    assert ta1.dtype == torch.bfloat16 and ta1.shape == (4, hw, 64)
    for got, ref, tol in ((ty, y, Y_TOL), (ta1.float(), a1, A1_TOL)):
        d = np.abs(got.numpy() - np.asarray(ref, np.float32))
        assert d.max() <= tol[0] and d.mean() <= tol[1], (d.max(), d.mean())
    # both packages' backward from the JAX forward's y and residual
    ja1 = torch.from_numpy(np.array(a1.astype(jnp.float32)))
    got = d8.run_int8_tail_backward(
        tf, tc, w, ja1.to(torch.bfloat16) if saved else None,
        torch.from_numpy(np.asarray(y)), torch.from_numpy(g))
    names = ("dfold", "dw1", "db1", "dwht", "dbht")
    for name, a, b in zip(names, got, want):
        assert a.dtype == torch.float32
        _assert_rel(a.numpy(), np.asarray(b), K5_TOL, name)
    assert not got[0][:, 3].any()


def _generator(latent=4, h=48, seed=1):
    cfg = SpatialGeneratorConfig(latent_dim=latent, hidden_dim=h,
                                 n_out=3, num_layers=2)
    params = jax.tree_util.tree_map(
        np.asarray, spatial_generator_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    pose = (rng.normal(size=5).astype(np.float32),
            (0.1 * rng.normal(size=(5, 2))).astype(np.float32),
            rng.normal(size=(5, latent)).astype(np.float32))
    return cfg, params, pose


@pytest.mark.parametrize("side", [16, 28])
def test_int8_generator_gradients_match_jax(side):
    """d sum(sin(3y)) / d (params, theta, dx, z) through the port's int8
    generator (the 784-pixel grid pads to 1024 and slices) against jax.grad
    through the JAX custom VJP; the pose and first-layer gradients sum
    dfold*w over H with cancellation, hence an absolute floor."""
    cfg, params, pose = _generator()
    grid = coord_grid(side, side)

    def loss(params, theta, dx, z):
        y = jd8.fused_spatial_generator_int8(params, cfg,
                                             jnp.asarray(grid.numpy()),
                                             theta, dx, z)
        return jnp.sum(jnp.sin(3.0 * y))

    gp, *gpose = jax.grad(loss, argnums=(0, 1, 2, 3))(params, *pose)
    gen = generator_from_jax(params, to_port(cfg))
    tpose = [torch.from_numpy(a).requires_grad_() for a in pose]
    y = d8.fused_spatial_generator_int8(gen, grid, *tpose)
    assert y.shape == (5, side * side, 3)
    torch.sin(3.0 * y).sum().backward()
    lim = (3e-3, 2e-4)
    for t, w in zip(tpose, gpose):
        _assert_rel(t.grad.numpy(), w, lim, "pose")
    _assert_rel(gen.coord_linear.weight.grad.numpy().T, gp["coord"]["w"],
                lim, "coord.w")
    _assert_rel(gen.latent_linear.weight.grad.numpy().T, gp["latent"]["w"],
                lim, "latent.w")
    for lin, p in zip(gen.linears(), gp["layers"]):
        _assert_rel(lin.weight.grad.numpy().T, p["w"], lim, "w")
        _assert_rel(lin.bias.grad.numpy(), p["b"], lim, "b")


def test_int8_residual_rule_and_recompute(monkeypatch):
    """The op saves the bf16 a1 when (1, B, HW, H) bf16 fits the residual
    budget and rebuilds it otherwise."""
    fold, ws, g = _inputs(2, 32, 3, 256, torch.float32)
    args = [torch.from_numpy(fold).requires_grad_(), coord_grid(16, 16)] + [
        torch.from_numpy(w).requires_grad_() for w in ws]
    nbytes = 2 * 256 * 32 * 2
    for budget, want in ((nbytes, 1), (nbytes - 1, 0)):
        monkeypatch.setattr(d8, "residual_budget", lambda dev, b=budget: b)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            y = d8.fused_decoder_tail_int8(*args)
        assert len([t for t in saved if t is not None
                    and t.dtype == torch.bfloat16]) == want
        y.backward(torch.from_numpy(g))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

# (weight dtype, No, int8 targets, mask): every value of each axis appears
LOSS_CASES = [(torch.float32, 3, True, False), (torch.float32, 1, False, True),
              (torch.float32, 3, False, True), (torch.bfloat16, 3, True, True),
              (torch.bfloat16, 1, True, False),
              (torch.bfloat16, 3, False, False)]
# relative to max|JAX| (max, mean).  f32: dW1 takes a qi flip (measured
# 7.3e-4 / 6.5e-6); bf16: the XLA fusion above (dW1 1.05e-2 / 1.4e-3, db1
# 5.5e-3 / 3.3e-4 measured), and the weight gradients come back in bf16,
# so one bf16 ulp of the largest value (3.9e-3) is within the limit
K3_TOL = {torch.float32: {"dfold": (2e-5, 2e-6), "dw1": (2e-3, 3e-5),
                          "db1": (5e-6, 1e-6), "dwht": (1e-5, 2e-6),
                          "dbht": (1e-5, 2e-6)},
          torch.bfloat16: {"dfold": (1e-4, 1e-5), "dw1": (2.5e-2, 4e-3),
                           "db1": (1.5e-2, 1e-3), "dwht": (4e-3, 2e-5),
                           "dbht": (4e-3, 4e-3)}}
COT = 0.37                    # the cotangent of the summed loss


def _loss_inputs(wdt, no, i8, masked, b=4, h=64, hw=1024, seed=0):
    fold, ws, _ = _inputs(b, h, no, hw, wdt, seed)
    rng = np.random.default_rng(seed + 7)
    k = rng.integers(0, 256, (b, no, hw))
    yt = (k - 128).astype(np.int8) if i8 else (k / 255.0).astype(np.float32)
    mask = (rng.uniform(size=hw) > 0.3).astype(np.float32) if masked \
        else None
    return fold, coord_grid(32, 32).numpy(), ws, yt, mask


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "-".join(
    [str(c[0])[6:], f"No{c[1]}", "i8" if c[2] else "f32t",
     "mask" if c[3] else "nomask"]))
def test_loss_kernel_matches_jax(case):
    """The loss and its five gradients through the port's autograd op,
    scaled by a cotangent other than 1, against jax.grad through the JAX
    custom VJP."""
    wdt, no, i8, masked = case
    fold, coords, ws, yt, mask = _loss_inputs(wdt, no, i8, masked)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    jm = None if mask is None else jnp.asarray(mask)

    def f(fold, w1, b1, wht, bht):
        return COT * jl8.fused_decoder_bce_int8(
            fold, jnp.asarray(coords), w1, b1, wht, bht, jnp.asarray(yt), jm)

    loss, want = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(fold), *jw)
    tf = torch.from_numpy(fold).requires_grad_()
    tw = [torch.from_numpy(w).to(wdt).requires_grad_() for w in ws]
    got = l8.fused_decoder_bce_int8(
        tf, torch.from_numpy(coords), *tw, torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask))
    (COT * got).backward()
    np.testing.assert_allclose(COT * float(got.detach()), float(loss),
                               rtol=2e-6)
    grads = [tf.grad] + [t.grad for t in tw]
    for name, a, b in zip(("dfold", "dw1", "db1", "dwht", "dbht"), grads,
                          want):
        assert a.dtype == (torch.float32 if name == "dfold" else wdt)
        _assert_rel(a.float().numpy(), np.asarray(b, np.float32),
                    K3_TOL[wdt][name], name)
    # the loss rides row 3 of dfold; rows 0-2 are the fold's gradient
    assert float(tf.grad[:, 3, 1:].abs().max()) == 0.0


def _xla_tanh_prime(a1c, wdt):
    """XLA's CPU form of the kernel's bf16 ``one - a1c*a1c``: the product
    rounds to bf16, the difference stays f32."""
    assert wdt == torch.bfloat16
    a = a1c.to(torch.bfloat16)
    return 1.0 - (a * a).float()


def _xla_dh0(da0, aq, inv=1.0 / 7.0):
    """XLA's CPU form of the bf16 dh0 chain: the factor 1 - a0d*a0d in bf16,
    da0 left in f32."""
    a0d = aq.to(torch.bfloat16) * torch.tensor(inv, dtype=torch.bfloat16)
    return da0 * (1.0 - a0d * a0d).float()


# measured on LOSS_CASES' bf16 cases (max, mean relative): dfold 8.1e-7 /
# 4.4e-9, dW1 1.8e-7 / 2.3e-8, db1 5.0e-6 / 2.3e-6, dWh^T 5.4e-6 / 6.0e-7,
# dbh 3.5e-7 / 3.5e-7 (f32 sums in another order, the masked case the
# largest).  With the port's own dh0 chain dfold reads 2.5e-6 / 1.9e-7; with
# the dh0 chain kept in f32, 1.5e-5 / 1.1e-6.
XLA_CHAIN_TOL = {"dfold": (1.6e-6, 2e-8), "dw1": (1e-6, 1e-7),
                 "db1": (1.5e-5, 5e-6), "dwht": (1.5e-5, 2e-6),
                 "dbht": (1e-6, 1e-6)}


@pytest.mark.parametrize("case", [c for c in LOSS_CASES
                                  if c[0] == torch.bfloat16],
                         ids=lambda c: "-".join(
                             [f"No{c[1]}", "i8" if c[2] else "f32t",
                              "mask" if c[3] else "nomask"]))
def test_loss_bf16_matches_jax_with_xla_chains(case, monkeypatch):
    """With XLA's CPU forms of the two bf16 chains swapped into the plain
    version, its five raw outputs agree with the JAX kernel's to f32
    summation order: the wide bf16 limits above excuse those two roundings
    and nothing else."""
    monkeypatch.setattr(l8, "tanh_prime", _xla_tanh_prime)
    monkeypatch.setattr(l8, "dh0_bf16", _xla_dh0)
    wdt, no, i8, masked = case
    fold, coords, ws, yt, mask = _loss_inputs(wdt, no, i8, masked)
    jw = [jnp.asarray(w, jnp.bfloat16) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt),
                       None if mask is None else jnp.asarray(mask),
                       "bernoulli", True)
    got = l8.loss_int8_reference(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask))
    for name, a, b in zip(("dfold", "dw1", "db1", "dwht", "dbht"), got,
                          want):
        _assert_rel(a.float().numpy(), np.asarray(b, np.float32),
                    XLA_CHAIN_TOL[name], name)


def test_loss_reference_outputs_match_jax_kernel_outputs():
    """The plain version's five raw outputs (the per-image BCE at
    dfold[:, 3, 0]) against the JAX kernel's, f32 weights, masked."""
    fold, coords, ws, yt, mask = _loss_inputs(torch.float32, 3, True, True)
    jw = [jnp.asarray(w) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt), jnp.asarray(mask), "bernoulli", True)
    got = l8.loss_int8_reference(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *map(torch.from_numpy, ws), torch.from_numpy(yt),
        torch.from_numpy(mask))
    for name, a, b in zip(("dfold", "dw1", "db1", "dwht", "dbht"), got,
                          want):
        _assert_rel(a.numpy(), np.asarray(b), (2e-5, 2e-6), name)
    np.testing.assert_allclose(got[0][:, 3, 0].numpy(),
                               np.asarray(want[0])[:, 3, 0], rtol=2e-6)


def test_host_operands_match_jax():
    """quant_sym, quant_sym4 and the loss kernel's host-side operands are
    bit-identical to JAX's, in f32 and bf16."""
    for wdt in (torch.float32, torch.bfloat16):
        _, ws, _ = _inputs(2, 48, 3, 256, wdt, seed=4)
        jw1, jwht = (jnp.asarray(ws[0], JNP[wdt]),
                     jnp.asarray(ws[2], JNP[wdt]))
        tw1, twht = (torch.from_numpy(ws[0]).to(wdt),
                     torch.from_numpy(ws[2]).to(wdt))
        q, s = d8.quant_sym(tw1)
        jq, js = jd8._quant_sym(jw1)
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js[0, 0])
        q4, s4 = l8.quant_sym4(tw1)
        jq4, js4 = jl8._quant_sym4(jw1)
        assert np.array_equal(q4.numpy(), np.asarray(jq4))
        assert np.array_equal(s4.numpy(), np.asarray(js4)[0])
        w1f, h1s, gb, w1r, s4r = l8.loss_operands(tw1, twht)
        wf4t, sf4 = jl8._quant_sym4(jw1.T)
        assert np.array_equal(w1f.numpy(), np.asarray(wf4t.T))
        assert np.array_equal(h1s.numpy(), np.asarray(sf4 * (1.0 / 7.0))[0])
        jgb = jnp.max(jnp.sum(jnp.abs(jwht.astype(jnp.float32)), axis=0)) \
            + 1e-30
        assert float(gb) == float(jgb)
        assert np.array_equal(w1r.numpy(), np.asarray(jq4))


def test_bf16_chains_round_op_by_op_as_jax():
    """The port's bf16 tanh' factor and dh0 chain equal JAX's op-by-op
    (eager) evaluation of the kernel's expressions, bit for bit."""
    rng = np.random.default_rng(11)
    a1 = np.tanh(2 * rng.normal(size=(512, 32))).astype(np.float32)
    a1c = jnp.asarray(a1).astype(jnp.bfloat16)
    want_t = np.asarray((jnp.bfloat16(1.0) - a1c * a1c).astype(jnp.float32))
    got_t = l8.tanh_prime(torch.from_numpy(a1).to(torch.bfloat16).float(),
                          torch.bfloat16)
    assert np.array_equal(got_t.numpy(), want_t)
    aq = rng.integers(-7, 8, size=(512, 32)).astype(np.float32)
    da0 = rng.integers(-20000, 20000, size=(512, 32)).astype(np.float32)
    a0d = jnp.asarray(aq).astype(jnp.bfloat16) * jnp.bfloat16(1.0 / 7.0)
    want = (jnp.asarray(da0).astype(jnp.bfloat16)
            * (jnp.bfloat16(1.0) - a0d * a0d))
    got = l8.dh0_bf16(torch.from_numpy(da0), torch.from_numpy(aq))
    assert np.array_equal(got.numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

GEN_KW = [dict(num_layers=2), dict(num_layers=3), dict(num_layers=1),
          dict(num_layers=2, resid=True), dict(num_layers=2, softplus=True),
          dict(num_layers=2, n_out=1), dict(num_layers=2, n_out=2),
          dict(num_layers=2, n_out=8), dict(num_layers=2, n_out=9),
          dict(num_layers=2, expand_coords=True),
          dict(num_layers=2, bilinear=True)]
HWS = (100, 256, 700, 768, 784, 1000, 1024, 1600, 4096, 4225, 4226, 5000)


def test_gates_match_jax():
    """can_fuse_int8 and can_fuse_loss_int8 decide as JAX's over a table of
    configs, pixel counts and likelihoods."""
    for kw in GEN_KW:
        cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=500, **kw)
        pcfg = to_port(cfg)
        for hw in HWS:
            assert d8.can_fuse_int8(pcfg, hw) == jd8.can_fuse_int8(cfg, hw)
            for lik in ("bernoulli", "gaussian", "colored", "other"):
                assert (l8.can_fuse_loss_int8(pcfg, hw, lik)
                        == jl8.can_fuse_loss_int8(cfg, hw, lik)), (kw, hw,
                                                                   lik)
        assert l8.pick_tile(4096) == jl8._pick_tile(4096) == 1024
        assert d8.pick_tile(4096) == jd8._pick_tile(4096, True) == 2048
    for hw in HWS:
        assert l8.padded_hw(hw) == jl8.padded_hw(hw)
        assert l8.hw_tiles_ok(hw) == jl8.hw_tiles_ok(hw)


def test_fused_loss_active_matches_jax_and_unported_configs_raise(
        monkeypatch):
    """fused_loss_active decides as JAX's; every config it sends to the loss
    kernel is ported (the three families, aligned and padded pixel counts)
    at every numerics setting the JAX trainer accepts, its four measurement
    levers included, and refused off them: RuntimeError without
    SPATIALVAE_ALLOW_KNOBS=1, ValueError on a phase cut below 3 (where the
    JAX kernel fails at trace time)."""
    routed = set()
    for kw in GEN_KW[:8]:
        cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=64, **kw)
        for lik in ("bernoulli", "gaussian", "colored"):
            for ekw in (dict(fused=True, int8=True), dict(fused=True),
                        dict(fused=True, int8=True, fused_loss=False),
                        dict(fused=True, int8=True, vanilla=True),
                        dict(fused=True, int8=True,
                             fit_noise_interleaved=False)):
                jecfg = JaxElboConfig(likelihood=lik, **ekw)
                ecfg = ElboConfig(likelihood=lik, **ekw)
                for hw in (784, 1024, 4096, 4225):
                    for b in (4, 5):
                        want = jax_active(jecfg, cfg, hw, b)
                        assert fused_loss_active(ecfg, to_port(cfg), hw,
                                                 b) == want
                        if want:
                            assert l8.check_ported(hw, lik) == l8.DEFAULTS
                            routed.add((lik, l8.padded_hw(hw) == hw))
    assert routed == {("bernoulli", True), ("bernoulli", False),
                      ("gaussian", True), ("gaussian", False),
                      ("colored", True)}
    monkeypatch.setenv("SPATIALVAE_SR", "1")
    for lik, aligned in sorted(routed):
        with pytest.raises(RuntimeError, match="ALLOW_KNOBS"):
            l8.check_ported(4096 if aligned else 784, lik)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    for lik, aligned in sorted(routed):
        assert l8.check_ported(4096 if aligned else 784, lik).sr
    monkeypatch.setenv("SPATIALVAE_TANH", "pade")
    for lik, aligned in sorted(routed):
        assert l8.check_ported(4096 if aligned else 784, lik).tanh == "pade"
    monkeypatch.setenv("SPATIALVAE_PHASE_CUT", "2")
    for lik, aligned in sorted(routed):
        with pytest.raises(ValueError, match="PHASE_CUT"):
            l8.check_ported(4096 if aligned else 784, lik)


@pytest.mark.parametrize("env,value,ported", [
    ("SPATIALVAE_TANH", "pade", True),
    ("SPATIALVAE_A1Q", "1", True),
    ("SPATIALVAE_DB1", "qi", True),
    ("SPATIALVAE_PHASE_CUT", "6", True),
    ("SPATIALVAE_INT4_GRADS", "i8", True),
    ("SPATIALVAE_SR", "1", True)])
def test_knobs_off_default_raise(monkeypatch, env, value, ported):
    """The port reads every numerics variable of the JAX KernelConfig with
    the same defaults, and refuses in the wrapper and in the trainer (int8
    and float) any value off a default without SPATIALVAE_ALLOW_KNOBS=1
    (RuntimeError, as the JAX trainer).  With it every one runs, the four
    measurement levers (K3 (g)) among them: the wrapper and both trainers
    accept it."""
    want = jax_kcfg.KernelConfig()
    names = {f: getattr(want, f) for f in jax_kcfg.NUMERICS_FIELDS}
    assert {f.name: f.default for f in dataclasses.fields(kcfg.Numerics)} \
        == names
    # every variable unset, or SR at a value JAX reads as off
    for f in jax_kcfg.NUMERICS_FIELDS:
        monkeypatch.delenv(f"SPATIALVAE_{f.upper()}", raising=False)
    monkeypatch.setenv("SPATIALVAE_SR", "")
    assert kcfg.numerics() == kcfg.Numerics()
    monkeypatch.setenv(env, value)
    fold, coords, ws, yt, _ = _loss_inputs(torch.float32, 1, True, False,
                                           b=2, h=16)
    q_cfg = InferenceConfig(n=1024, latent_dim=5, hidden_dim=8, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=16, n_out=1,
                                   num_layers=2)
    calls = (
        kcfg.check_knobs,
        lambda: l8.run_loss_int8(
            torch.from_numpy(fold), torch.from_numpy(coords),
            *map(torch.from_numpy, ws), torch.from_numpy(yt)),
        lambda: port_trainer.Trainer(
            to_port(q_cfg), to_port(p_cfg), ElboConfig(fused=True, int8=True),
            port_trainer.TrainConfig(minibatch_size=2), coord_grid(32, 32),
            device="cpu"),
        lambda: port_trainer.Trainer(
            to_port(q_cfg), to_port(p_cfg), ElboConfig(),
            port_trainer.TrainConfig(minibatch_size=2), coord_grid(32, 32),
            device="cpu"))
    for call in calls:
        with pytest.raises(RuntimeError, match="ALLOW_KNOBS"):
            call()
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    assert ported
    assert kcfg.numerics() != kcfg.Numerics()
    for call in calls:
        call()


def test_target_copy_matches_jax():
    """probe_255_grid and build_yt_i8 against the JAX trainer's passes: the
    same decision and the same int8 (N, C, HW) copy (k/255 as k - 128)."""
    rng = np.random.default_rng(3)
    on = (rng.integers(0, 256, (5, 64, 3)) / 255.0).astype(np.float32)
    off = rng.uniform(size=(5, 64, 3)).astype(np.float32)
    for a in (on, off, on * 2.0):
        je, jlo, jhi = (float(v) for v in jax_trainer._probe_255_grid(
            jnp.asarray(a)))
        e, lo, hi = port_trainer.probe_255_grid(torch.from_numpy(a), rows=2)
        assert (lo, hi) == (jlo, jhi)
        np.testing.assert_allclose(e, je, rtol=0, atol=1e-6)
    got = port_trainer.build_yt_i8(torch.from_numpy(on), 64)
    want = jax_trainer._build_yt_i8(jnp.asarray(on), 64)
    assert got.dtype == torch.int8 and got.shape == (5, 3, 64)
    assert np.array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(l8.targets_f32(got).numpy(),
                                  np.asarray((jnp.asarray(want, jnp.float32)
                                              + 128.0) * (1.0 / 255.0)))
