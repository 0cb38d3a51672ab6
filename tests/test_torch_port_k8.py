"""The feature-major int8 loss kernel (K8) of the port against the JAX
package's, on the CPU.

``loss_int8_t_reference`` against JAX ``_lossgrad_pallas_t(...,
interpret=True)`` in both modes (``i4``, ``i8``) at 32x32 (HW 1,024 in one
group, 3 outputs) and at 28x28 unpadded (one group of 784 pixels, where K3
pads to 1,024); gradients through the autograd op against ``jax.grad``
through the JAX custom VJP; the ELBO's route under
``SPATIALVAE_LOSS_LAYOUT=t`` against the JAX package's conditions (a mask,
int8 targets or another likelihood take K3).

Tolerances, relative to each output's largest value (max, mean), measured
with a margin of 3-10x: float32 weights agree to f32 summation order (dWh^T
2.9e-6 / 7.5e-7 at 784 pixels), but for an int8 value that a tanh ulp moves
across a rounding boundary (dW1 1.8e-5 / 1.0e-7); bf16 weights carry the
bf16-chain difference of ``test_torch_port_int8`` (XLA on the CPU drops two
bf16 roundings that the kernel as written keeps): dW1 and db1 up to 1.1e-2
/ 3.2e-3.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.kernels import fused_loss_int8_t as jt

from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels import fused_loss_int8_t as lt
from spatialvae_torch.models import SpatialGenerator
from spatialvae_torch.objectives import ElboConfig, elbo_minibatch
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRADS = ("dfoldT", "dw1", "db1", "dwht", "dbht")
TOL = {torch.float32: {"dfoldT": (5e-6, 5e-7), "dw1": (1e-4, 1e-6),
                       "db1": (1e-4, 1e-6), "dwht": (1e-5, 2e-6),
                       "dbht": (5e-6, 5e-6)},
       torch.bfloat16: {"dfoldT": (2e-4, 2e-5), "dw1": (3e-2, 6e-3),
                        "db1": (3e-2, 1e-2), "dwht": (1e-4, 1e-5),
                        "dbht": (1e-5, 1e-5)}}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    d = np.abs(got - want)
    scale = float(np.abs(want).max()) or 1.0
    return d.max() / scale, d.mean() / scale


def _inputs(side, wdt, no=3, b=4, h=64, seed=0):
    rng = np.random.default_rng(seed)
    fold_t = np.zeros((b, h, 4), np.float32)
    fold_t[:, :, :2] = rng.uniform(-0.7, 0.7, (b, h, 2))
    fold_t[:, :, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
          .to(wdt).float().numpy() for s in ((h, h), (h,), (no, h), (no,))]
    yt = rng.uniform(size=(b, no, side * side)).astype(np.float32)
    return fold_t, coord_grid(side, side).numpy(), ws, yt


CASES = [(32, torch.float32, "i4"), (32, torch.float32, "i8"),
         (28, torch.float32, "i4"), (28, torch.bfloat16, "i8"),
         (32, torch.bfloat16, "i4"), (28, torch.float32, "i8")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}px-"
                         f"{str(c[1])[6:]}-{c[2]}")
def test_k8_plain_version_matches_jax(case, monkeypatch):
    """The five raw outputs, the per-image BCE at dfoldT[:, 0, 3]."""
    side, wdt, mode = case
    monkeypatch.setenv("SPATIALVAE_INT4_GRADS_T", mode)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    fold_t, coords, ws, yt = _inputs(side, wdt)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    want = jt._lossgrad_pallas_t(jnp.asarray(fold_t), jnp.asarray(coords),
                                 jw[0], jw[1], jw[2], jw[3][:, None],
                                 jnp.asarray(yt), interpret=True)
    got = lt.loss_int8_t_reference(
        torch.from_numpy(fold_t), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        mode)
    for name, a, b in zip(GRADS, got, want):
        mx, mean = _rel(a.numpy(), b)
        lim = TOL[wdt][name]
        assert mx <= lim[0] and mean <= lim[1], (name, mx, mean, lim)
    np.testing.assert_allclose(got[0][:, 0, 3].numpy(),
                               np.asarray(want[0])[:, 0, 3], rtol=2e-6)
    # the wrapper takes the plain version on the CPU, reading the mode from
    # the environment; K8's 784 is one group, unlike K3's padded 1024
    again = lt.run_loss_int8_t(
        torch.from_numpy(fold_t), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt))
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert l8.pick_tile(side * side) == (784 if side == 28 else 1024)


@pytest.mark.parametrize("mode", ["i4", "i8"])
def test_k8_gradients_through_the_op_match_jax(mode, monkeypatch):
    """fused_decoder_bce_int8_t's loss and gradients, scaled by a cotangent
    other than 1, against jax.grad through the JAX custom VJP."""
    monkeypatch.setenv("SPATIALVAE_INT4_GRADS_T", mode)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    fold_t, coords, ws, yt = _inputs(32, torch.float32, seed=2)
    cot = 0.37

    def f(fold_t, w1, b1, wht, bht):
        return cot * jt.fused_decoder_bce_int8_t(
            fold_t, jnp.asarray(coords), w1, b1, wht, bht, jnp.asarray(yt),
            True)

    loss, want = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(fold_t), *map(jnp.asarray, ws))
    tf = torch.from_numpy(fold_t).requires_grad_()
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    got = lt.fused_decoder_bce_int8_t(tf, torch.from_numpy(coords), *tw,
                                      torch.from_numpy(yt))
    (cot * got).backward()
    np.testing.assert_allclose(cot * float(got.detach()), float(loss),
                               rtol=2e-6)
    for name, a, b in zip(GRADS, [tf.grad] + [t.grad for t in tw], want):
        mx, mean = _rel(a.numpy(), b)
        assert mx <= 5e-6 and mean <= 5e-7, (name, mx, mean)


def test_elbo_routes_k8_under_the_jax_conditions(monkeypatch):
    """Under SPATIALVAE_LOSS_LAYOUT=t (with SPATIALVAE_ALLOW_KNOBS=1) an
    even Bernoulli step without a mask and with float targets takes K8; a
    mask, int8 targets or the Gaussian likelihood take K3, as in JAX
    (spatialvae_tpu/objectives/elbo.py:241-257); without the variable every
    step takes K3."""
    calls = []
    for mod, name, tag in ((l8, "run_loss_int8", "K3"),
                           (lt, "run_loss_int8_t", "K8")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _t=tag, **kw:
                            calls.append(_t) or _f(*a, **kw))
    side, b = 32, 4
    q = InferenceNetwork(to_port(InferenceConfig(
        n=side * side, latent_dim=5, hidden_dim=16, num_layers=2)),
        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.uniform(size=(b, side * side))
                         .astype(np.float32))
    y8 = (torch.round(y * 255) - 128).to(torch.int8)[:, None]
    mask = torch.ones(side * side)
    coords = coord_grid(side, side)

    def run(lik, **kw):
        p = SpatialGenerator(to_port(SpatialGeneratorConfig(
            latent_dim=2, hidden_dim=32, n_out=1, num_layers=2)),
            generator=torch.Generator().manual_seed(1))
        calls.clear()
        with torch.no_grad():
            elbo_minibatch(q, p, ElboConfig(fused=True, int8=True,
                                            likelihood=lik), coords, y,
                           noise=torch.zeros((b, 5)), **kw)
        return calls[0]

    assert run("bernoulli") == "K3"
    monkeypatch.setenv("SPATIALVAE_LOSS_LAYOUT", "t")
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    assert run("bernoulli") == "K8"
    assert run("bernoulli", y_t=y[:, None]) == "K8"
    assert run("bernoulli", mask=mask) == "K3"
    assert run("bernoulli", y_t=y8) == "K3"
    assert run("gaussian") == "K3"
    monkeypatch.delenv("SPATIALVAE_ALLOW_KNOBS")
    with pytest.raises(RuntimeError, match="ALLOW_KNOBS"):
        run("bernoulli")


def test_k8_refuses_what_it_does_not_take():
    fold_t, coords, ws, yt = _inputs(32, torch.float32)
    args = [torch.from_numpy(a) for a in (fold_t, coords, *ws)]
    with pytest.raises(ValueError, match="y_t"):
        lt.run_loss_int8_t(*args, torch.zeros((4, 3, 1024), dtype=torch.int8),
                           "i4")
    with pytest.raises(ValueError, match="mode"):
        lt.run_loss_int8_t(*args, torch.from_numpy(yt), "i2")
    with pytest.raises(ValueError, match="even"):
        lt.run_loss_int8_t(args[0][:3], *args[1:], torch.from_numpy(yt[:3]),
                           "i4")
