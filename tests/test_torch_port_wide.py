"""Decoders wider than 512 through the port's fused paths, against the JAX
package, on the CPU.

The JAX kernels take any hidden width; the port's kernels do too (above 512
they keep each block's activations in a workspace in global memory and run
in 512-column chunks), so its wrappers refuse no width.  On the CPU the
wrappers run the plain versions, held here to the JAX functions in Pallas
interpret mode at H = 768 (K1 and K2 with 1 and 2 hidden layers in f32 and
bf16; K3 in its four families; K4 and K5; K8), to the JAX trainer for one
float and one int8 step at H = 640, and to the JAX API serving a
JAX-written H = 1,000 galaxy-shaped checkpoint.  The CUDA kernels at these
and wider widths are held to the plain versions on the card by
``test_torch_port_cuda.py`` and ``chip_smoke.py``.

Tolerances are the narrow widths' (``test_torch_port_decoder*.py``,
``test_torch_port_int8.py``, ``test_torch_port_families.py``,
``test_torch_port_k8.py``, the trainer tests), which these widths meet but
for two: a wider layer sums more terms, in another order in each package,
and has more activations that a tanh ulp moves across a bf16 rounding
boundary.  K3's dWh^T with bf16 weights reads 2.79e-5 / 3.21e-6 (max / mean
relative, Bernoulli, H = 768) against the narrow widths' 1e-5 / 2e-6, so it
is held at 1e-4 / 1e-5 here, and K8's dW1 and db1 (see ``K8_TOL``) at
1e-2 / 1e-5; every other output stays inside the narrow limit (K3 at
H = 768: bf16 dW1 1.2e-2 / 1.5e-3, db1 5.3e-4 / 1.1e-4; f32 below 5.1e-6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.api import SpatialVae as JaxVae
from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.kernels import fused_decoder as jax_fd
from spatialvae_tpu.kernels import fused_decoder_int8 as jd8
from spatialvae_tpu.kernels import fused_loss_int8 as jl8
from spatialvae_tpu.kernels import fused_loss_int8_t as jlt
from spatialvae_tpu.models import inference_init, spatial_generator_init
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.api import SpatialVae
from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels import fused_loss_int8_t as lt
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

H = 768
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRADS = ("dfold", "dw1", "db1", "dwht", "dbht")


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


def _fold(rng, b, h):
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    return fold


def _weights(rng, shapes, h, wdt):
    bound = 1 / np.sqrt(h)
    return [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
            .to(wdt).float().numpy() for s in shapes]


# ---------------------------------------------------------------------------
# K1 and K2
# ---------------------------------------------------------------------------

# (Lh, resid, weight dtype)
TAIL_CASES = [(1, False, torch.float32), (1, True, torch.bfloat16),
              (2, True, torch.float32), (2, False, torch.bfloat16)]


@pytest.mark.parametrize("case", TAIL_CASES, ids=lambda c: (
    f"Lh{c[0]}-{'resid' if c[1] else 'plain'}-{str(c[2])[6:]}"))
def test_decoder_tail_at_wide_width(case):
    """K1 through the wrapper and K2 through the autograd op, against the
    JAX custom VJP's forward and ``jax.vjp``: the forward at 1e-5 (f32) and
    1e-2 (bf16: a tanh ulp can move an operand across a bf16 rounding
    boundary), each gradient at 1e-5 relative with a floor of 1e-5 of its
    largest value (f32) or 1e-2 of it (bf16)."""
    lh, resid, wdt = case
    rng = np.random.default_rng(0)
    b, hw, no = 2, 256, 3
    fold = _fold(rng, b, H)
    ws = _weights(rng, ((lh, H, H), (lh, H), (no, H), (no,)), H, wdt)
    coords = coord_grid(16, 16).numpy()
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda f, *w: jax_fd.fused_decoder_tail(
            f, jnp.asarray(coords), *w, resid), jnp.asarray(fold), *jw)
        want = vjp(jnp.asarray(g))
    tf = torch.from_numpy(fold).requires_grad_()
    tw = [torch.from_numpy(w).to(wdt).requires_grad_() for w in ws]
    tc = torch.from_numpy(coords)
    with torch.no_grad():
        served = fd.fused_decoder_tail(tf, tc, *tw, resid)
    got = fd.fused_decoder_tail(tf, tc, *tw, resid)
    got.backward(torch.from_numpy(g))
    atol = 1e-5 if wdt == torch.float32 else 1e-2
    for out in (served, got):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                                   rtol=0, atol=atol)
    for name, a, w in zip(("dfold", "dwhid", "dbhid", "dwht", "dbht"),
                          [tf.grad] + [t.grad for t in tw], want):
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(
            a.float().numpy(), w, rtol=1e-5 if wdt == torch.float32 else 0,
            atol=(1e-5 if wdt == torch.float32 else 1e-2) * scale,
            err_msg=name)


# ---------------------------------------------------------------------------
# K3 in its four families, K4 / K5, K8
# ---------------------------------------------------------------------------

LOSS_TOL = {
    torch.float32: {"dfold": (5e-5, 3e-6), "dw1": (2e-3, 3e-5),
                    "db1": (5e-6, 1e-6), "dwht": (1e-5, 2e-6),
                    "dbht": (1e-5, 2e-6)},
    torch.bfloat16: {"dfold": (3e-4, 4e-5), "dw1": (2.5e-2, 4e-3),
                     "db1": (1.5e-2, 1e-3), "dwht": (1e-4, 1e-5),
                     "dbht": (1e-5, 5e-6)},
}
# (family, weight dtype, int8 targets, mask)
LOSS_CASES = [("bernoulli", torch.bfloat16, True, False),
              ("gaussian", torch.float32, False, True),
              ("colored", torch.bfloat16, False, True),
              ("padded", torch.float32, True, True)]


def loss_inputs(family, wdt, i8, masked, b=2, h=H, seed=0):
    """numpy (fold, coords, weights, y_t, mask, kernel family) in the loss
    kernel's layout: 32x32 (colored chunk-permuted, targets pre-paired), or
    28x28 zero-padded to 1024 under the forced mask."""
    rng = np.random.default_rng(seed)
    no = {"gaussian": 1, "colored": 2}.get(family, 3)
    fold = _fold(rng, b, h)
    ws = _weights(rng, ((h, h), (h,), (no, h), (no,)), h, wdt)
    side = 28 if family == "padded" else 32
    hw = side * side
    coords = coord_grid(side, side).numpy()
    k = rng.integers(0, 256, (b, hw, no))
    y = (k / 255.0).astype(np.float32)
    mask = (rng.uniform(size=hw) > 0.3).astype(np.float32) if masked \
        else None
    if family == "colored":
        coords = l8.colored_coords(torch.from_numpy(coords), 1024).numpy()
        yt = y[..., 0].reshape(b, hw // 2, 2).transpose(0, 2, 1)
    else:
        yt = y.transpose(0, 2, 1)
    if i8:
        yt = (np.round(yt * 255) - 128).astype(np.int8)
    if family == "padded":
        pad = 1024 - hw
        coords = np.concatenate([coords, np.zeros((pad, 2), np.float32)])
        yt = np.concatenate([yt, np.full((b, no, pad), -128 if i8 else 0,
                                         yt.dtype)], 2)
        base = np.ones(hw, np.float32) if mask is None else mask
        mask = np.concatenate([base, np.zeros(pad, np.float32)])
    kfam = "bernoulli" if family == "padded" else family
    return fold, coords, ws, np.ascontiguousarray(yt), mask, kfam


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "-".join(
    [c[0], str(c[1])[6:], "i8" if c[2] else "float",
     "mask" if c[3] else "nomask"]))
def test_loss_kernel_at_wide_width(case):
    """K3's five raw outputs through the wrapper, the per-image loss at
    dfold[:, 3, 0] among them, against the JAX kernel's."""
    family, wdt, i8, masked = case
    fold, coords, ws, yt, mask, kfam = loss_inputs(family, wdt, i8, masked)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt),
                       None if mask is None else jnp.asarray(mask), kfam,
                       True)
    got = l8.run_loss_int8(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask), kfam)
    for name, a, w in zip(GRADS, got, want):
        _assert_rel(a.numpy(), np.asarray(w, np.float32),
                    LOSS_TOL[wdt][name], name)
    np.testing.assert_allclose(got[0][:, 3, 0].numpy(),
                               np.asarray(want[0])[:, 3, 0], rtol=2e-6)


@pytest.mark.parametrize("saved", [True, False], ids=["residual", "recompute"])
def test_int8_tail_at_wide_width(saved):
    """K4 (y and the bf16 a1) and K5 through the wrappers against the JAX
    kernels, at the narrow widths' limits (``test_torch_port_int8``)."""
    rng = np.random.default_rng(0)
    b, hw, no, wdt = 3, 256, 3, torch.bfloat16
    fold = _fold(rng, b, H)
    ws = _weights(rng, ((H, H), (H,), (no, H), (no,)), H, wdt)
    coords = coord_grid(16, 16).numpy()
    g = rng.normal(size=(b, no, hw)).astype(np.float32)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    w1q, sw = jd8._quant_sym(jw[0])
    y, a1 = jd8._fwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q, sw,
                            jw[1][None, :], jw[2], jw[3][:, None],
                            emit_acts=True)
    want = jd8._bwd_pallas(jnp.asarray(fold), jnp.asarray(coords), w1q, sw,
                           jw[1][None, :], jw[2], a1 if saved else None, y,
                           jnp.asarray(g))
    w = d8.Int8Weights(*[torch.from_numpy(v).to(wdt) for v in ws])
    tf, tc = torch.from_numpy(fold), torch.from_numpy(coords)
    ty, ta1 = d8.run_int8_tail(tf, tc, w, emit_a1=True)
    for got, ref, tol in ((ty, y, (1e-3, 1e-6)), (ta1.float(), a1,
                                                   (1e-2, 1e-5))):
        d = np.abs(got.numpy() - np.asarray(ref, np.float32))
        assert d.max() <= tol[0] and d.mean() <= tol[1], (d.max(), d.mean())
    ja1 = torch.from_numpy(np.array(a1.astype(jnp.float32)))
    got = d8.run_int8_tail_backward(
        tf, tc, w, ja1.to(torch.bfloat16) if saved else None,
        torch.from_numpy(np.asarray(y)), torch.from_numpy(g))
    for name, a, v in zip(GRADS, got, want):
        _assert_rel(a.numpy(), np.asarray(v), (2e-3, 5e-5), name)


# K8's dW1 and db1: a gradient-tile value that a tanh ulp moves across a
# rounding boundary moves them by 1/7 of one product in i4 (H = 768, f32:
# 2.18e-3 / 1.6e-6 and 2.0e-3 / 2.6e-6; i8 1.44e-4 / 1.7e-6), above the
# narrow widths' 1e-4 / 1e-6; the other outputs keep those limits
K8_TOL = {"dfoldT": (5e-6, 5e-7), "dw1": (1e-2, 1e-5), "db1": (1e-2, 1e-5),
          "dwht": (1e-5, 2e-6), "dbht": (5e-6, 5e-6)}


@pytest.mark.parametrize("mode", ["i4", "i8"])
def test_k8_at_wide_width(mode, monkeypatch):
    """K8 through the wrapper against ``_lossgrad_pallas_t(interpret=True)``
    (which pads H to a multiple of 32; 768 is one), float32 weights."""
    monkeypatch.setenv("SPATIALVAE_INT4_GRADS_T", mode)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    rng = np.random.default_rng(0)
    b, no = 2, 3
    fold_t = _fold(rng, b, H).transpose(0, 2, 1).copy()
    ws = _weights(rng, ((H, H), (H,), (no, H), (no,)), H, torch.float32)
    coords = coord_grid(32, 32).numpy()
    yt = rng.uniform(size=(b, no, 1024)).astype(np.float32)
    jw = [jnp.asarray(w) for w in ws]
    want = jlt._lossgrad_pallas_t(jnp.asarray(fold_t), jnp.asarray(coords),
                                  jw[0], jw[1], jw[2], jw[3][:, None],
                                  jnp.asarray(yt), interpret=True)
    got = lt.run_loss_int8_t(torch.from_numpy(fold_t),
                             torch.from_numpy(coords),
                             *[torch.from_numpy(w) for w in ws],
                             torch.from_numpy(yt))
    for name, a, w in zip(K8_TOL, got, want):
        _assert_rel(a.numpy(), np.asarray(w), K8_TOL[name], name)


# ---------------------------------------------------------------------------
# training steps at H = 640, serving at H = 1,000
# ---------------------------------------------------------------------------


def _trainers(side, int8, hidden=640):
    q_cfg = InferenceConfig(n=side * side * 3, latent_dim=6, hidden_dim=64,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=3, hidden_dim=hidden, n_out=3,
                                   num_layers=2)
    ekw = dict(fused=True, int8=int8, channels=3)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw),
                             jax_trainer.TrainConfig(minibatch_size=4),
                             jnp.asarray(jax_grid(side, side)))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(minibatch_size=4), coord_grid(side, side),
                 device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    return jt, tr


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_trainer_step_at_wide_width(int8, monkeypatch):
    """One step of a decoder 640 wide from one init, same batch and noise:
    the float step through K1/K2's plain versions (16x16), the int8 step
    through K3's (32x32, int8 targets from the per-dataset copy).  The
    step's metrics at the narrow tests' 1e-5 / 1e-3 relative, every weight
    at 2*lr (Adam's first step moves a weight by about lr times the sign
    of its gradient; a near-zero gradient element can flip) with a mean
    below 1e-6."""
    side = 32 if int8 else 16
    jt, tr = _trainers(side, int8)
    seen = []
    for mod, name in ((fd, "decoder_tail_backward_reference"),
                      (l8, "loss_int8_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.append(_n) or _f(*a, **kw))
    rng = np.random.default_rng(3)
    y = (rng.integers(0, 256, (4, side * side, 3)) / 255.0).astype(np.float32)
    noise = rng.normal(size=(4, 6)).astype(np.float32)
    y_t = None
    if int8:
        y_t = np.asarray(jt._dataset_yt(type("D", (), dict(
            y=jnp.asarray(y), ctf=None, __len__=lambda s: 4))()))
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    with pltpu.force_tpu_interpret_mode():
        (_, aux), grads = grad_fn(
            jt.state.params, jnp.asarray(y), None, None, jnp.float32(1.0),
            y_t=None if y_t is None else jnp.asarray(y_t),
            noise=jnp.asarray(noise))
    state = jax_trainer.apply_update(jt.optimizer, jt.state, grads,
                                     jnp.float32)
    got = tr.train_step(torch.from_numpy(y),
                        y_t=None if y_t is None else torch.from_numpy(y_t),
                        noise=torch.from_numpy(noise))
    assert seen == ["loss_int8_reference" if int8
                    else "decoder_tail_backward_reference"]
    np.testing.assert_allclose(got.numpy(), np.asarray(aux),
                               rtol=1e-3 if int8 else 1e-5)
    lr = TrainConfig().learning_rate
    g, gdef = jax.tree_util.tree_flatten(
        named_to_jax(tr.q_net, tr.p_net, tr.named_params()))
    w, wdef = jax.tree_util.tree_flatten(state.params)
    assert gdef == wdef
    for a, b in zip(g, w):
        d = np.abs(a - np.asarray(b, np.float32))
        assert d.max() <= 2 * lr and d.mean() <= 1e-6, (a.shape, d.max(),
                                                        d.mean())


def test_serving_a_jax_checkpoint_at_h1000(tmp_path):
    """A galaxy-shaped model with a decoder 1,000 wide (twice the default),
    initialised and written by the JAX package, loaded through
    ``SpatialVae.load``: the weights cross as numpy arrays unchanged, and
    the fused decode (K1's plain version on the CPU) reconstructs as the JAX
    API does, at the serving tests' 1e-5."""
    n = m = 16
    q_cfg = InferenceConfig(n=n * m * 3, latent_dim=23, hidden_dim=64,
                            num_layers=3)
    p_cfg = SpatialGeneratorConfig(latent_dim=20, hidden_dim=1000, n_out=3,
                                   num_layers=2)
    kq, kp = jax.random.split(jax.random.PRNGKey(0))
    qp = jax.tree_util.tree_map(np.asarray, inference_init(kq, q_cfg))
    pp = jax.tree_util.tree_map(np.asarray, spatial_generator_init(kp, p_cfg))
    ecfg = JaxElboConfig(theta_prior=np.pi, likelihood="bernoulli",
                         channels=3, dx_scale=0.2, fused=True)
    gen = str(tmp_path / "wide_generator_epoch1.sav")
    inf = str(tmp_path / "wide_inference_epoch1.sav")
    jax_ckpt.save_model(gen, "generator", pp, p_cfg, elbo=ecfg,
                        image_shape=(n, m))
    jax_ckpt.save_model(inf, "inference", qp, q_cfg, elbo=ecfg,
                        image_shape=(n, m))
    jm = JaxVae.load(gen, inf)
    pm = SpatialVae.load(gen, inf, device="cpu")
    assert pm.serving_ecfg.fused
    assert pm.p_net.cfg.hidden_dim == 1000
    for a, b in zip(jax.tree_util.tree_leaves(named_to_jax(
            pm.q_net, pm.p_net, dict(
                [(f"q.{k}", v) for k, v in pm.q_net.named_parameters()]
                + [(f"p.{k}", v) for k, v in pm.p_net.named_parameters()]))),
                    jax.tree_util.tree_leaves({"q": qp, "p": pp})):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(1)
    y = (rng.integers(0, 256, (3, n * m, 3)) / 255.0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    mu, _ = jm.encode(jnp.asarray(y))
    r = np.asarray(jax.random.normal(key, mu.shape, mu.dtype))
    before = dict(fd.LAUNCHES)
    got = pm.reconstruct(y, noise=r)
    assert fd.LAUNCHES == before             # the CPU runs the plain version
    want = np.asarray(jm.reconstruct(jnp.asarray(y), key))
    assert got.shape == (3, n * m, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
