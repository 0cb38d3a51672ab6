"""The port's CTF against the JAX package, on the CPU: the table parser and
the per-particle kernels (1e-6 relative), ``apply_ctf`` against the JAX
FFT path and the port's grouped conv2d (1e-5 of max|out| in float32), the
ELBO with CTF in the Gaussian and colored likelihoods, float and int8
decodes, and three trainer steps with CTF against the JAX trainer; the
bf16 refusal in both packages.

Tolerances: the float ELBO's metrics at the float step parity's rtol 1e-5
(``test_torch_port_train.py``), its CTF-corrected mean at 1e-5 of max;
after three float steps each leaf at rtol 1e-5 with a floor of 1e-5 of its
largest value (as there).  int8 decodes go through K4/K5 (Pallas interpret
mode on the JAX side): the step metrics at 1e-4 relative and the leaves
within 6 lr, mean 1e-6, as ``test_torch_port_families_train.py`` holds
them.  The colored likelihood with CTF divides by a convolved variance that
crosses zero, which amplifies the two FFT libraries' rounding differences:
its ELBO is held at 1e-5 in float64, and in float32 to the float64 value
no worse than JAX's own; its step metrics at 1e-3 (stated at the tests).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.ctf import apply as jax_apply
from spatialvae_tpu.ctf import physics as jax_physics
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives import elbo_minibatch as jax_elbo
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.ctf import (
    apply_ctf,
    apply_ctf_spatial,
    ctf_filter,
    parse_ctf,
)
from spatialvae_torch.ctf.physics import COLUMNS
from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.objectives import ElboConfig, elbo_minibatch
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

LR = TrainConfig().learning_rate


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _table(path, n, seed=0):
    """A CTF table of n rows: the eight columns, integral and fractional
    values, written as the reference's tables are."""
    rng = np.random.default_rng(seed)
    rows = [f"{rng.uniform(1, 3):.4f} 2.7 300 {rng.uniform(1, 1.5):.3f} "
            f"{rng.uniform(0, 100):.2f} 10 {rng.uniform(-.1, .1):.3f} "
            f"{int(rng.integers(0, 360))}" for _ in range(n)]
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_parse_ctf_matches_jax(tmp_path):
    path = _table(tmp_path / "ctf.txt", 7)
    got, want = parse_ctf(path), jax_physics.parse_ctf(path)
    assert len(got) == len(want) == 7
    assert got.columns == list(want.columns) == list(COLUMNS)
    for c in COLUMNS:
        np.testing.assert_allclose(getattr(got, c), want[c].to_numpy(),
                                   rtol=1e-6)
    one = _table(tmp_path / "one.txt", 1)
    assert len(parse_ctf(one)) == 1
    (tmp_path / "bad.txt").write_text("1 2 3\n")
    with pytest.raises(ValueError, match="columns"):
        parse_ctf(str(tmp_path / "bad.txt"))


@pytest.mark.parametrize("n,m,scale", [(11, 11, 1.0), (9, 13, 1.5),
                                       (39, 39, 1.0)])
def test_ctf_filter_matches_jax(tmp_path, n, m, scale):
    path = _table(tmp_path / "ctf.txt", 5, seed=n)
    got = ctf_filter(parse_ctf(path), n, m, scale=scale)
    want = jax_physics.ctf_filter(jax_physics.parse_ctf(path), n, m,
                                  scale=scale)
    assert got.shape == want.shape == (5, n, m) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape,k", [((5, 12, 12), (11, 11)),
                                     ((3, 9, 14), (9, 13)),
                                     ((2, 16, 16), (15, 15))])
def test_apply_ctf_matches_jax_and_the_grouped_conv(shape, k):
    rng = np.random.default_rng(sum(shape))
    y = rng.normal(size=shape).astype(np.float32)
    kern = rng.normal(size=(shape[0],) + k).astype(np.float32)
    got = apply_ctf(torch.from_numpy(y), torch.from_numpy(kern)).numpy()
    want = np.asarray(jax_apply.apply_ctf(jnp.asarray(y), jnp.asarray(kern)))
    conv = apply_ctf_spatial(torch.from_numpy(y),
                             torch.from_numpy(kern)).numpy()
    jconv = np.asarray(jax_apply.apply_ctf_spatial(jnp.asarray(y),
                                                   jnp.asarray(kern)))
    scale = np.abs(conv).max()
    assert got.shape == want.shape == conv.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, conv, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(conv, jconv, rtol=0, atol=1e-5 * scale)
    got64 = apply_ctf(torch.from_numpy(y).double(),
                      torch.from_numpy(kern).double())
    conv64 = apply_ctf_spatial(torch.from_numpy(y).double(),
                               torch.from_numpy(kern).double())
    assert got64.dtype == torch.float64
    torch.testing.assert_close(got64, conv64, rtol=0, atol=1e-12 * scale)


def test_bf16_fft_is_refused_in_both_packages():
    y = np.ones((2, 8, 8), np.float32)
    k = np.ones((2, 7, 7), np.float32)
    with pytest.raises(ValueError, match="float32 or float64"):
        jax_apply.apply_ctf(jnp.asarray(y), jnp.asarray(k, jnp.bfloat16))
    with pytest.raises(ValueError, match="float32 or float64, got bfloat16"):
        apply_ctf(torch.from_numpy(y),
                  torch.from_numpy(k).to(torch.bfloat16))


SIDE, Z, B = 12, 2, 4


def _cfgs(n_out, side=SIDE, hidden=32):
    return (InferenceConfig(n=side * side, latent_dim=Z + 3, hidden_dim=48,
                            num_layers=2),
            SpatialGeneratorConfig(latent_dim=Z, hidden_dim=hidden,
                                   n_out=n_out, num_layers=2))


def _mask(side=SIDE):
    g = coord_grid(side, side).numpy()
    return (np.sum(g ** 2, axis=1) <= 1.0).astype(np.float32)


def _kernels(tmp_path, n, side=SIDE, seed=0):
    """The CLI's CTF kernels: odd dims, from a table."""
    k = side - 1 if side % 2 == 0 else side
    path = _table(tmp_path / f"ctf{seed}.txt", n, seed=seed)
    return ctf_filter(parse_ctf(path), k, k)


def _batch(seed, n=B, side=SIDE):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, side * side)).astype(np.float32)
    noise = rng.normal(size=(n, Z + 3)).astype(np.float32)
    return y, noise


def _models(n_out, side=SIDE, hidden=32, seed=0):
    q_cfg, p_cfg = _cfgs(n_out, side, hidden)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(),
                             jax_trainer.TrainConfig(seed=seed),
                             jnp.asarray(jax_grid(side, side)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    return q_cfg, p_cfg, params


def _jax_elbo(params, q_cfg, p_cfg, ekw, side, y, noise, ctf, mask,
              dtype=np.float32):
    cast = lambda a: None if a is None else jnp.asarray(a, dtype)  # noqa
    return jax_elbo(
        jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), params["q"]),
        jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), params["p"]),
        q_cfg, p_cfg, JaxElboConfig(**ekw), cast(jax_grid(side, side)),
        cast(y), None, noise=cast(noise), ctf=cast(ctf), mask=cast(mask),
        image_shape=(side, side))


def _port_elbo(params, q_cfg, p_cfg, ekw, side, y, noise, ctf, mask,
               dtype=torch.float32):
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg), dtype=dtype)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dtype)  # noqa
    return elbo_minibatch(q_net, p_net, ElboConfig(**ekw),
                          coord_grid(side, side).to(dtype), t(y),
                          noise=t(noise), ctf=t(ctf), mask=t(mask),
                          image_shape=(side, side))


# (likelihood, mask, int8)
ELBO_CASES = [("gaussian", False, False), ("gaussian", True, False),
              ("colored", False, False), ("colored", True, False),
              ("gaussian", True, True), ("colored", True, True)]


@pytest.mark.parametrize("case", ELBO_CASES, ids=lambda c: "-".join(
    [c[0], "mask" if c[1] else "nomask", "int8" if c[2] else "float"]))
def test_elbo_with_ctf_matches_jax(tmp_path, case):
    """int8 cases at 16x16 (K4's pixel count), where the JAX decode runs
    its int8 kernel in interpret mode; the port's CPU path is K4's plain
    version, and no loss kernel runs (a CTF batch never takes it).

    The colored likelihood divides by the CTF-convolved variance, which
    crosses zero (the reference's order; a real CTF kernel sums to the
    amplitude contrast, 0.1 here): in the nomask case 195 of its 576
    values are negative, the smallest 1e-3 of the largest.  The two
    packages' float32 FFTs differ by up to 2.4e-7 of max|out|
    (``test_apply_ctf_matches_jax_and_the_grouped_conv``), and the
    division amplifies that: in float32 both packages' ELBOs sit up to
    6e-5 from the float64 value, and from each other.  So the float
    colored cases are held at rtol 1e-5 in float64 (both packages, the
    same function), and in float32 the port's distance from the float64
    value must stay within 3x JAX's own (or 1e-5 relative)."""
    likelihood, masked, int8 = case
    side = 16 if int8 else SIDE
    n_out = 2 if likelihood == "colored" else 1
    q_cfg, p_cfg, params = _models(n_out, side)
    y, noise = _batch(3, side=side)
    ctf = _kernels(tmp_path, B, side)
    mask = _mask(side) if masked else None
    ekw = dict(likelihood=likelihood, fused=int8, int8=int8)
    args = (params, q_cfg, p_cfg, ekw, side, y, noise, ctf, mask)
    want = _jax_elbo(*args)
    before = dict(l8.LAUNCHES), dict(d8.LAUNCHES)
    got = _port_elbo(*args)
    assert (dict(l8.LAUNCHES), dict(d8.LAUNCHES)) == before   # CPU
    got = [t.detach() for t in got]
    yh, wyh = got[3].numpy(), np.asarray(want[3])
    assert yh.shape == wyh.shape == (B, side * side, 1)
    np.testing.assert_allclose(yh, wyh, rtol=0,
                               atol=(1e-3 if int8 else 1e-5)
                               * np.abs(wyh).max())
    if likelihood == "gaussian" or int8:
        rtol = 1e-4 if int8 else 1e-5
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(float(g), float(w), rtol=rtol)
        return
    with jax.enable_x64(True):
        want64 = [float(v) for v in _jax_elbo(*args, dtype=np.float64)[:3]]
    got64 = _port_elbo(*args, dtype=torch.float64)
    for g64, w64, g32, w32 in zip(got64[:3], want64, got[:3], want[:3]):
        np.testing.assert_allclose(float(g64.detach()), w64, rtol=1e-5)
        jax_err = abs(float(w32) - w64)
        assert abs(float(g32) - w64) <= max(3 * jax_err, 1e-5 * abs(w64))


def test_ctf_never_takes_the_loss_kernel(tmp_path, monkeypatch):
    """In int8 mode an even batch takes K3 without CTF; with CTF it decodes
    through K4 (forward with a1) and K5 instead."""
    from spatialvae_torch.objectives import loss_and_grad

    side = 32
    q_cfg, p_cfg, params = _models(1, side)
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg))
    calls = []
    monkeypatch.setattr(l8, "fused_bce_spatial_int8",
                        lambda *a, **k: calls.append("k3"))
    import spatialvae_torch.objectives.elbo as elbo_mod
    monkeypatch.setattr(elbo_mod, "fused_bce_spatial_int8",
                        lambda *a, **k: calls.append("k3") or torch.zeros(
                            (), requires_grad=True))
    real = elbo_mod.fused_spatial_generator_int8
    monkeypatch.setattr(elbo_mod, "fused_spatial_generator_int8",
                        lambda *a: calls.append("k4") or real(*a))
    y, noise = _batch(5, side=side)
    ecfg = ElboConfig(likelihood="gaussian", fused=True, int8=True)
    for ctf in (None, torch.from_numpy(_kernels(tmp_path, B, side))):
        calls.clear()
        loss_and_grad(q_net, p_net, ecfg, coord_grid(side, side),
                      torch.from_numpy(y), noise=torch.from_numpy(noise),
                      ctf=ctf, image_shape=(side, side))
        assert calls == (["k3"] if ctf is None else ["k4"])


class _Data:
    def __init__(self, y, ctf):
        self.y, self.ctf = y, ctf

    def __len__(self):
        return self.y.shape[0]


def _trainers(likelihood, int8, dtype="float32"):
    """A JAX trainer (fused only in int8 mode, its kernels in interpret
    mode) and a port trainer (fused) on the same weights, with the mask."""
    side = 16 if int8 else SIDE
    n_out = 2 if likelihood == "colored" else 1
    q_cfg, p_cfg = _cfgs(n_out, side)
    ekw = dict(likelihood=likelihood, int8=int8)
    mask = _mask(side)
    tkw = dict(minibatch_size=B, compute_dtype=dtype,
               image_shape=(side, side))
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(fused=int8, **ekw),
                             jax_trainer.TrainConfig(**tkw),
                             jnp.asarray(jax_grid(side, side)),
                             mask=jnp.asarray(mask))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg),
                 ElboConfig(fused=True, **ekw), TrainConfig(**tkw),
                 coord_grid(side, side), mask=mask, device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    return jt, tr, side


def _leaves(tr):
    return named_to_jax(tr.q_net, tr.p_net, tr.named_params())


@pytest.mark.parametrize("likelihood,int8", [("gaussian", False),
                                             ("colored", False),
                                             ("colored", True)],
                         ids=["gaussian", "colored", "colored-int8"])
def test_trainer_steps_with_ctf_match_jax(tmp_path, likelihood, int8):
    """Three steps on fixed batches, CTF kernels and noise: the JAX step is
    ``grad_fn`` then ``apply_update``; the port's ``train_step(ctf=...)``.
    The colored steps' metrics divide by the convolved variance, which
    crosses zero (see ``test_elbo_with_ctf_matches_jax``): they differ by up
    to 1.8e-5 (float) and 4.3e-4 (int8) relative, measured, and are held
    at 1e-3; their leaves stay within the float and int8 limits."""
    jt, tr, side = _trainers(likelihood, int8)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state = jt.state
    for step in range(3):
        y, noise = _batch(20 + step, side=side)
        ctf = _kernels(tmp_path, B, side, seed=step)
        (_, aux), grads = grad_fn(state.params, jnp.asarray(y),
                                  jnp.asarray(ctf), None, jnp.float32(1.0),
                                  noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jnp.float32)
        got = tr.train_step(torch.from_numpy(y), ctf=torch.from_numpy(ctf),
                            noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=(
            1e-3 if likelihood == "colored" else 1e-4 if int8 else 1e-5))
    assert tr.opt_state.count == int(state.opt_state.count) == 3
    g, gdef = jax.tree_util.tree_flatten(_leaves(tr))
    w, wdef = jax.tree_util.tree_flatten(state.params)
    assert gdef == wdef
    for a, b in zip(g, w):
        b = np.asarray(b, np.float32)
        if int8:
            d = np.abs(a - b)
            assert d.max() <= 6 * LR and d.mean() <= 1e-6
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * (np.abs(b).max() or 1))


def test_epochs_gather_the_ctf_rows_of_their_batches(tmp_path, monkeypatch):
    """Each step gets the CTF kernels of its own images (the tail too), the
    evaluation too; in int8 mode no target copy is built for the loss
    kernel, which a CTF batch never takes."""
    n = 2 * B + 3
    _, tr, side = _trainers("gaussian", True)
    y, _ = _batch(30, n, side)
    ctf = np.zeros((n, side - 1, side - 1), np.float32)
    ctf[:, 7, 7] = 1.0                              # the identity kernel
    ctf[:, 0, 0] = np.arange(n)                     # the image's index
    y[:, 0] = np.arange(n)
    seen = []
    step = tr.train_step

    def spy(batch, **kw):
        seen.append((batch[:, 0].numpy(), kw["ctf"][:, 0, 0].numpy()))
        return step(batch, **kw)

    monkeypatch.setattr(tr, "train_step", spy)
    m = tr.train_epoch(_Data(torch.from_numpy(y), torch.from_numpy(ctf)), 0,
                       progress=False)
    assert np.isfinite(m).all()
    assert [len(s[0]) for s in seen] == [B, B, 3]
    for images, kernels in seen:
        np.testing.assert_array_equal(images, kernels)
    assert tr._yt_cache == {} and not tr._wants_yt(torch.from_numpy(ctf))
    assert np.isfinite(tr.eval_epoch(_Data(torch.from_numpy(y),
                                           torch.from_numpy(ctf)), 0)).all()


def test_bf16_compute_with_ctf_is_refused_in_both_trainers(tmp_path):
    """The JAX trainer raises at its first step (XLA's FFT takes no bf16);
    the port raises ``ValueError`` naming the cause before any step."""
    jt, tr, side = _trainers("gaussian", False, dtype="bfloat16")
    y, noise = _batch(40, side=side)
    ctf = _kernels(tmp_path, B, side)
    with pytest.raises(ValueError, match="float32 or float64"):
        jt._train_step(jt.state, jnp.asarray(y), jnp.asarray(ctf),
                       jax.random.PRNGKey(0), jnp.float32(1.0))
    with pytest.raises(ValueError, match="compute_dtype='float32'"):
        tr.train_epoch(_Data(torch.from_numpy(y), torch.from_numpy(ctf)), 0)
    with pytest.raises(ValueError, match="compute_dtype='float32'"):
        tr.train_step(torch.from_numpy(y), ctf=torch.from_numpy(ctf))
    assert tr.opt_state.count == 0
