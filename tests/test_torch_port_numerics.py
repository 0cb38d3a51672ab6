"""The int8 path's numerics settings in the port against the JAX package, on
the CPU: the three repairs of its silent divergences (ROADMAP Queue 3
faults 1, 3, 4), the fused int8 loss kernel's plain version at every
numerics setting the JAX kernel takes (ROADMAP Queue 2 K3 (f)), and
training steps and epochs under those settings and the feature-major
layout (K8) through the ``Trainer``.

The JAX kernels run in Pallas interpret mode, the knobs set in the
environment as the JAX package's measurement entry points set them.

Tolerances of the K3 plain version against the JAX kernel, relative to each
output's largest value (max, mean), measured over the 28 cases with a
margin of about 3x: with float32 weights, or bf16 weights and the f32
epilogue, f32 summation order and an int8 value that a tanh ulp moves
across a rounding boundary (worst dW1 5.9e-5 / 5.2e-7, with the int8
forward, whose 127 levels have more boundaries; db1 5.6e-5 / 1.3e-6; dfold
1.3e-5 / 8.3e-7); with bf16 weights and the bf16 epilogue, the bf16-chain
difference of ``test_torch_port_int8`` (XLA on the CPU drops two bf16
roundings that the kernel as written keeps): dW1 7.4e-3 / 1.4e-3, db1
2.1e-3 / 5.2e-4, dfold 1.5e-4 / 1.3e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.kernels import fused_decoder_int8 as jd8
from spatialvae_tpu.kernels import fused_loss_int8 as jl8
from spatialvae_tpu.kernels import fused_loss_int8_t as jt8
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels import fused_loss_int8_t as lt
from spatialvae_torch.kernels.config import Numerics
from spatialvae_torch.objectives import ElboConfig, fused_loss_active
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

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


# ---------------------------------------------------------------------------
# K3 (f): the plain version at every numerics setting
# ---------------------------------------------------------------------------

# (grad_mode, gscale, epi): the JAX kernel takes the tile scale for i8 and
# da0_i4 whatever GSCALE says; i4fwd is i4dw1's alias (tested below)
MODES = [("i8", "tile", "bf16"), ("i8", "tile", "f32"),
         ("da0_i4", "tile", "bf16"), ("da0_i4", "tile", "f32"),
         ("i4dw1", "tile", "bf16"), ("i4dw1", "tile", "f32"),
         ("i4dw1", "bound", "f32")]
FAMILIES = ["bernoulli", "gaussian", "padded", "colored"]
# pairwise: every mode with every family; masks and weight dtypes alternate
# so that each meets every mode, family and each other
CASES = [(m, fam, bool((i + j) % 2),
          (torch.float32, torch.bfloat16)[(i + j // 2) % 2])
         for i, m in enumerate(MODES) for j, fam in enumerate(FAMILIES)]
WIDE = {"dfold": (5e-4, 4e-5), "dw1": (2.5e-2, 4e-3), "db1": (1e-2, 2e-3),
        "dwht": (2e-5, 2e-6), "dbht": (4e-5, 4e-5)}
TIGHT = {"dfold": (5e-5, 3e-6), "dw1": (2e-4, 2e-6), "db1": (2e-4, 5e-6),
         "dwht": (3e-5, 4e-6), "dbht": (4e-5, 4e-5)}


def _family_inputs(family, wdt, masked, b=4, h=64, seed=0):
    """numpy (fold, coords, weights, y_t, mask, kernel family) in the
    kernel's layout: 32x32 (colored chunk-permuted, targets pre-paired), or
    28x28 padded to 1024 with the forced mask."""
    rng = np.random.default_rng(seed)
    no = {"bernoulli": 3, "gaussian": 1, "padded": 1, "colored": 2}[family]
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
          .to(wdt).float().numpy() for s in ((h, h), (h,), (no, h), (no,))]
    side = 28 if family == "padded" else 32
    hw = side * side
    coords = coord_grid(side, side).numpy()
    y = rng.uniform(size=(b, hw, no)).astype(np.float32)
    mask = (rng.uniform(size=hw) > 0.3).astype(np.float32) if masked \
        else None
    if family == "bernoulli":
        yt = (np.round(y * 255) - 128).astype(np.int8).transpose(0, 2, 1)
    elif family == "colored":
        coords = l8.colored_coords(torch.from_numpy(coords), 1024).numpy()
        yt = y[..., 0].reshape(b, hw // 2, 2).transpose(0, 2, 1)
    else:
        yt = y.transpose(0, 2, 1)
    if family == "padded":
        pad = 1024 - hw
        coords = np.concatenate([coords, np.zeros((pad, 2), np.float32)])
        yt = np.concatenate([yt, np.zeros((b, no, pad), np.float32)], 2)
        base = np.ones(hw, np.float32) if mask is None else mask
        mask = np.concatenate([base, np.zeros(pad, np.float32)])
    kfam = "bernoulli" if family == "padded" else family
    return fold, coords, ws, np.ascontiguousarray(yt), mask, kfam


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    [*c[0], c[1], "mask" if c[2] else "nomask", str(c[3])[6:]]))
def test_loss_numerics_match_jax(case, monkeypatch):
    """loss_int8_reference at the JAX kernel's numerics (set through the
    environment for JAX, passed as ``Numerics`` to the port): the five raw
    outputs and the per-image loss."""
    (gm, gs, epi), family, masked, wdt = case
    for k, v in (("INT4_GRADS", gm), ("GSCALE", gs), ("EPI", epi)):
        monkeypatch.setenv(f"SPATIALVAE_{k}", v)
    fold, coords, ws, yt, mask, kfam = _family_inputs(family, wdt, masked)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt),
                       None if mask is None else jnp.asarray(mask), kfam,
                       True)
    got = l8.loss_int8_reference(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask), kfam,
        Numerics(grad_mode=gm, gscale=gs, epi=epi))
    tol = WIDE if wdt == torch.bfloat16 and epi == "bf16" else TIGHT
    for name, a, b in zip(GRADS, got, want):
        mx, mean = _rel(a.numpy(), b)
        assert mx <= tol[name][0] and mean <= tol[name][1], (name, mx, mean)
    np.testing.assert_allclose(got[0][:, 3, 0].numpy(),
                               np.asarray(want[0])[:, 3, 0], rtol=3e-6)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_i4fwd_is_i4dw1(wdt):
    """The JAX kernel's i4fwd and i4dw1 compute the same integers (its
    `_Phases.p6_gemms`: "values are identical"): the port's plain version
    gives the same outputs bit for bit, under both scales and epilogues."""
    fold, coords, ws, yt, mask, kfam = _family_inputs("bernoulli", wdt, True)
    args = [torch.from_numpy(a) for a in (fold, coords)] + [
        torch.from_numpy(w).to(wdt) for w in ws] + [
        torch.from_numpy(yt), torch.from_numpy(mask), kfam]
    for gs in ("tile", "bound"):
        for epi in ("bf16", "f32"):
            a = l8.loss_int8_reference(*args, Numerics(
                grad_mode="i4fwd", gscale=gs, epi=epi))
            b = l8.loss_int8_reference(*args, Numerics(
                grad_mode="i4dw1", gscale=gs, epi=epi))
            assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_host_operands_at_every_mode_match_jax():
    """loss_operands per grad_mode against the JAX _lossgrad_pallas host
    side, bit for bit: the forward's weights and dequant row, and da0's
    weights and scales."""
    rng = np.random.default_rng(3)
    w1 = rng.uniform(-0.1, 0.1, (48, 48)).astype(np.float32)
    wht = rng.uniform(-0.1, 0.1, (3, 48)).astype(np.float32)
    for gm in ("i8", "da0_i4", "i4fwd", "i4dw1"):
        w1f, h1s, _, w1r, s4 = l8.loss_operands(
            torch.from_numpy(w1), torch.from_numpy(wht), Numerics(
                grad_mode=gm))
        if gm in ("i8", "da0_i4"):
            q, s = jd8._quant_sym(jnp.asarray(w1))
            assert np.array_equal(w1f.numpy(), np.asarray(q))
            np.testing.assert_array_equal(
                h1s.numpy(), np.full(48, np.asarray(s * (1.0 / 127.0))[0, 0]))
        else:
            q, s = jl8._quant_sym4(jnp.asarray(w1).T)
            assert np.array_equal(w1f.numpy(), np.asarray(q).T)
        if gm == "i8":
            assert np.array_equal(w1r.numpy(), w1f.numpy())
            assert float(s4.max()) == float(s4.min()) == float(
                jd8._quant_sym(jnp.asarray(w1))[1][0, 0])
        else:
            q4, s4j = jl8._quant_sym4(jnp.asarray(w1))
            assert np.array_equal(w1r.numpy(), np.asarray(q4))
            assert np.array_equal(s4.numpy(), np.asarray(s4j)[0])


# ---------------------------------------------------------------------------
# repairs: the activation gates, the display decodes
# ---------------------------------------------------------------------------

ACTIVATIONS = ("relu", "leakyrelu", "sigmoid")


def test_int8_gates_refuse_other_activations():
    """The int8 kernels compute tanh (the JAX gates never checked the
    activation, ROADMAP Queue 3): the port's int8 decoder and loss-kernel
    gates send other activations to the plain folded decoder and the plain
    likelihood."""
    for act in ACTIVATIONS:
        cfg = SpatialGeneratorConfig(latent_dim=2, num_layers=2,
                                     activation=act)
        assert jd8.can_fuse_int8(cfg, 4096)
        assert jl8.can_fuse_loss_int8(cfg, 4096, "bernoulli")
        assert not d8.can_fuse_int8(to_port(cfg), 4096)
        for lik in ("bernoulli", "gaussian", "colored"):
            pc = to_port(dataclasses.replace(
                cfg, n_out={"bernoulli": 3, "gaussian": 1,
                            "colored": 2}[lik]))
            assert not l8.can_fuse_loss_int8(pc, 4096, lik)
            assert not fused_loss_active(ElboConfig(
                fused=True, int8=True, likelihood=lik), pc, 4096, 4)
    tanh = to_port(SpatialGeneratorConfig(latent_dim=2, num_layers=2))
    assert d8.can_fuse_int8(tanh, 4096)
    assert l8.can_fuse_loss_int8(tanh, 4096, "bernoulli")


N = M = 32
C, Z, B = 3, 3, 4


def _cfgs(**pkw):
    q_cfg = InferenceConfig(n=N * M * C, latent_dim=Z + 3, hidden_dim=64,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=48, n_out=C,
                                   num_layers=2, **pkw)
    return q_cfg, p_cfg


def _trainers(jekw=None, ekw=None, **pkw):
    q_cfg, p_cfg = _cfgs(**pkw)
    ekw = dict(fused=True, int8=True, channels=C) if ekw is None else ekw
    jt = jax_trainer.Trainer(
        q_cfg, p_cfg, JaxElboConfig(**(ekw if jekw is None else jekw)),
        jax_trainer.TrainConfig(minibatch_size=B),
        jnp.asarray(jax_grid(N, M)))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(minibatch_size=B), coord_grid(N, M),
                 device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    return jt, tr


def _images(n, on_grid=True, seed=4):
    rng = np.random.default_rng(seed)
    if on_grid:
        return (rng.integers(0, 256, (n, N * M, C)) / 255.0).astype(
            np.float32)
    return rng.uniform(size=(n, N * M, C)).astype(np.float32)


LR = TrainConfig().learning_rate


def _step_matches(jt, tr, y, y_t_jax, y_t, rng):
    """One step of each trainer on the same batch and noise: the step's
    metrics within 1e-3 relative, every leaf after Adam within 6 lr (max)
    and 1e-6 (mean) of JAX's (``test_torch_port_int8_train``'s limits)."""
    noise = rng.normal(size=(y.shape[0], Z + 3)).astype(np.float32)
    (_, aux), grads = jax.value_and_grad(jt._loss, has_aux=True)(
        jt.state.params, jnp.asarray(y), None, None, jnp.float32(1.0),
        y_t=y_t_jax, noise=jnp.asarray(noise))
    state = jax_trainer.apply_update(jt.optimizer, jt.state, grads,
                                     jt._compute_dtype)
    got = tr.train_step(torch.from_numpy(y), y_t=y_t,
                        noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=1e-3)
    g, gdef = jax.tree_util.tree_flatten(named_to_jax(
        tr.q_net, tr.p_net, tr.named_params()))
    w, wdef = jax.tree_util.tree_flatten(state.params)
    assert gdef == wdef
    for a, b in zip(g, w):
        d = np.abs(a - np.asarray(b, np.float32))
        assert d.max() <= 6 * LR and d.mean() <= 1e-6, (a.shape, d.max())


def test_relu_int8_step_matches_the_plain_jax_step():
    """A relu decoder in int8 mode takes the plain folded decoder and the
    plain likelihood: one step matches the JAX package run with
    fused=False (whose int8 gates would send it to the tanh kernels)."""
    jt, tr = _trainers(jekw=dict(fused=False, int8=True, channels=C),
                       activation="relu")
    assert not tr._wants_yt()
    y = _images(B)
    _step_matches(jt, tr, y, None, None, np.random.default_rng(5))


def test_display_decodes_are_float_in_int8_mode():
    """reconstruct_canonical and sample_prior of an int8 trainer decode in
    float, as the JAX trainer's do (its plain spatial_generator_apply on
    the f32 masters), within 1e-6."""
    jt, tr = _trainers()
    y = _images(B)
    key = jax.random.PRNGKey(11)
    want = jt.reconstruct_canonical(jnp.asarray(y.reshape(B, -1)), key)
    z_mu, _ = tr.q_net(torch.from_numpy(y.reshape(B, -1)))
    noise = np.asarray(jax.random.normal(key, tuple(z_mu.shape)))
    got = tr.reconstruct_canonical(torch.from_numpy(y),
                                   noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    want = jt.sample_prior(B, Z, key)
    noise = np.asarray(jax.random.normal(key, (B, Z)))
    got = tr.sample_prior(B, Z, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# paths B and C through the trainer
# ---------------------------------------------------------------------------

class _Data:
    def __init__(self, y):
        self.y = y
        self.ctf = None

    def __len__(self):
        return self.y.shape[0]


# (environment, the kernel the even steps take): path B, K3 at off-default
# numerics on /255-grid data (int8 targets); path C, K8 on data off the grid
PATHS = [({"SPATIALVAE_INT4_GRADS": "i8"}, "K3"),
         ({"SPATIALVAE_GSCALE": "tile", "SPATIALVAE_INT4_GRADS": "da0_i4"},
          "K3"),
         ({"SPATIALVAE_EPI": "f32"}, "K3"),
         ({"SPATIALVAE_LOSS_LAYOUT": "t"}, "K8"),
         ({"SPATIALVAE_LOSS_LAYOUT": "t", "SPATIALVAE_INT4_GRADS_T": "i8"},
          "K8")]


@pytest.mark.parametrize("env,kernel", PATHS, ids=lambda p: "-".join(
    f"{k[11:]}={v}" for k, v in p.items()) if isinstance(p, dict) else p)
def test_off_default_numerics_train_as_jax(env, kernel, monkeypatch):
    """Under the knobs (with SPATIALVAE_ALLOW_KNOBS=1; without it both
    trainers refuse them): one even step against the JAX trainer's, then an
    epoch of 7 images at B=4 whose full batch takes the knobs' kernel (K3
    with int8 targets from the dataset copy, or K8 with float ones) and
    whose tail of 3 takes the int8 decoder (K4, K5)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # the JAX K8 reads no interpret variable: its elbo route gets the call
    # with interpret=True, as the JAX package's own K8 tests make it
    monkeypatch.setattr(jt8, "fused_bce_spatial_int8_t", functools.partial(
        jt8.fused_bce_spatial_int8_t, interpret=True))
    with pytest.raises(RuntimeError, match="ALLOW_KNOBS"):
        _trainers()
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    jt, tr = _trainers()
    y = _images(7, on_grid=kernel == "K3")
    data_t = tr._dataset_yt(torch.from_numpy(y))
    jdata_t = np.asarray(jt._dataset_yt(_Data(jnp.asarray(y))))
    assert np.array_equal(data_t.float().numpy(),
                          jdata_t.astype(np.float32))
    assert (data_t.dtype == torch.int8) == (kernel == "K3")
    idx = np.array([0, 2, 3, 6])
    _step_matches(jt, tr, y[idx], jnp.asarray(jdata_t[idx]),
                  data_t[idx], np.random.default_rng(5))
    calls = []
    for mod, name, tag in ((l8, "loss_int8_reference", "K3"),
                           (lt, "loss_int8_t_reference", "K8"),
                           (d8, "decoder_tail_int8_reference", "K4"),
                           (d8, "decoder_tail_int8_backward_reference",
                            "K5")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _t=tag, **kw:
                            calls.append(_t) or _f(*a, **kw))
    elbo, gen_loss, kl = tr.train_epoch(_Data(y), 0, progress=False)
    assert np.isfinite([elbo, gen_loss, kl]).all()
    assert calls == [kernel, "K4", "K5"]
