"""The port's vanilla generator against the JAX package's, on the CPU: the
module (softplus quirk on and off, residual hidden layers, one to three
outputs a pixel), the weight bridge both ways, the ELBO's terms and
gradients (Bernoulli over RGB, Gaussian and colored with the fit-noise
head), trainer steps with their Adam state, the serving API, and model and
optimizer checkpoints written by either package and read by the other.

Tolerances are the spatial generator's (``test_torch_port_models.py``,
``test_torch_port_train.py``): outputs rtol 1e-5 with an absolute 1e-5;
float32 losses rtol 1e-5; gradients rtol 1e-5 with a floor of 1e-5 of each
leaf's largest value; weights after Adam steps the same.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.api import SpatialVae as JaxVae
from spatialvae_tpu.core.config import InferenceConfig, VanillaGeneratorConfig
from spatialvae_tpu.models import (
    vanilla_generator_apply,
    vanilla_generator_init,
)
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch import checkpoint
from spatialvae_torch.api import SpatialVae
from spatialvae_torch.io.jax_params import (
    from_jax_params,
    generator_from_jax,
    generator_to_jax,
    leaf_paths,
    named_from_jax,
    named_to_jax,
    state_from_jax,
)
from spatialvae_torch.models import VanillaGenerator
from spatialvae_torch.objectives import ElboConfig, loss_and_grad
from spatialvae_torch.objectives.elbo import fused_loss_active
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
N, M, Z, B = 8, 8, 3, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _assert_trees(got, want, rtol=1e-5, floor=1e-5):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(_np_tree(want))
    assert gdef == wdef
    for a, b in zip(g, w):
        scale = float(np.abs(b).max()) or 1.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale)


# (n_out, softplus, resid, num_layers, activation)
MODULE_CASES = [(1, False, False, 2, "tanh"), (1, True, False, 1, "tanh"),
                (2, True, True, 3, "leakyrelu"), (3, False, True, 2, "relu"),
                (3, True, False, 2, "sigmoid")]


@pytest.mark.parametrize("case", MODULE_CASES, ids=lambda c: (
    f"out{c[0]}-{'sp' if c[1] else 'nosp'}-{'resid' if c[2] else 'plain'}"
    f"-l{c[3]}-{c[4]}"))
def test_module_matches_jax(case):
    """The decode of the same weights and z, and the module's layout: the
    reference's ``layers`` stack, Sigmoid then Softplus last."""
    n_out, softplus, resid, layers, act = case
    cfg = VanillaGeneratorConfig(n=N * M, latent_dim=Z, hidden_dim=24,
                                 n_out=n_out, num_layers=layers,
                                 activation=act, softplus=softplus,
                                 resid=resid)
    params = _np_tree(vanilla_generator_init(jax.random.PRNGKey(1), cfg))
    # move the head off its init so the sigmoid is not near 0.5 everywhere
    params["layers"][-1]["b"] = np.linspace(
        -3, 3, N * M * n_out).astype(np.float32)
    z = np.random.default_rng(2).normal(size=(5, Z)).astype(np.float32)
    want = np.asarray(vanilla_generator_apply(params, cfg, None,
                                              jnp.asarray(z)))
    gen = generator_from_jax(params, to_port(cfg))
    assert isinstance(gen, VanillaGenerator)
    with torch.no_grad():
        got = gen(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (5, N * M, n_out)
    np.testing.assert_allclose(got, want, **TOL)
    kinds = [type(m).__name__ for m in gen.layers]
    assert kinds[-2:] == (["Sigmoid", "Softplus"] if softplus
                          else ["Linear", "Sigmoid"])
    if softplus:
        # channel 0 twice: it never falls below softplus(softplus(0))
        assert got[..., 0].min() >= np.log1p(np.exp(np.log(2.0))) - 1e-6
    if resid:
        assert "ResidLinear" in kinds


def test_bridge_both_ways_and_leaf_paths():
    cfg = VanillaGeneratorConfig(n=N * M, latent_dim=Z, hidden_dim=16,
                                 n_out=2, num_layers=3, resid=True)
    q_cfg = InferenceConfig(n=N * M, latent_dim=Z, hidden_dim=16,
                            num_layers=2)
    params = _np_tree(vanilla_generator_init(jax.random.PRNGKey(3), cfg))
    gen = generator_from_jax(params, to_port(cfg))
    back = generator_to_jax(gen)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    q_net, p_net = from_jax_params(
        _np_tree(jax_trainer.inference_init(jax.random.PRNGKey(4), q_cfg)),
        params, to_port(q_cfg), to_port(cfg))
    paths = leaf_paths(q_net, p_net)
    named = {f"{k}.{n}" for k, net in (("q", q_net), ("p", p_net))
             for n, _ in net.named_parameters()}
    assert set(paths) == named
    assert {p for (p, _) in paths.values() if p[0] == "p"} == {
        ("p", "layers", i, k) for i in range(4) for k in ("w", "b")}
    tensors = {k: torch.randn(t.shape) for k, t in
               [(f"{k}.{n}", p) for k, net in (("q", q_net), ("p", p_net))
                for n, p in net.named_parameters()]}
    tree = named_to_jax(q_net, p_net, tensors)
    again = named_from_jax(tree, q_net, p_net)
    for k, t in tensors.items():
        torch.testing.assert_close(again[k], t, rtol=0, atol=0)
        path, perm = paths[k]
        leaf = tree
        for key in path:
            leaf = leaf[key]
        want = t.numpy() if perm is None else t.numpy().transpose(perm)
        np.testing.assert_array_equal(leaf, want)


# name -> (likelihood, channels, n_out, softplus, z_scale)
ELBO_CASES = {
    "galaxy_rgb": ("bernoulli", 3, 1, False, 1.0),
    "mnist": ("bernoulli", 1, 1, False, 0.0),
    "gaussian_softplus": ("gaussian", 1, 1, True, 1.0),
    "colored_fit_noise": ("colored", 1, 2, True, 1.0),
}


def _elbo_setup(name):
    likelihood, ch, n_out, softplus, z_scale = ELBO_CASES[name]
    q_cfg = InferenceConfig(n=N * M * ch, latent_dim=Z, hidden_dim=32,
                            num_layers=2)
    p_cfg = VanillaGeneratorConfig(n=N * M * ch, latent_dim=Z,
                                   hidden_dim=32, n_out=n_out, num_layers=2,
                                   softplus=softplus)
    if n_out > 1:           # the particles' fit-noise head: n pixels, 2 out
        p_cfg = dataclasses.replace(p_cfg, n=N * M)
    jecfg = JaxElboConfig(rotate=False, translate=False, vanilla=True,
                          likelihood=likelihood, channels=ch)
    return q_cfg, p_cfg, jecfg, z_scale


def _batch(likelihood, ch, seed, b=B):
    rng = np.random.default_rng(seed)
    if likelihood == "bernoulli":
        y = rng.integers(0, 256, size=(b, N * M, ch)) / 255.0
    else:
        y = rng.normal(size=(b, N * M, ch))
    noise = rng.normal(size=(b, Z)).astype(np.float32)
    return y.astype(np.float32).reshape(b, N * M, ch), noise


@pytest.mark.parametrize("name", list(ELBO_CASES))
def test_loss_and_grad_matches_jax(name):
    """The ELBO's terms and every gradient leaf, pose forced off by
    ``vanilla`` though the config asks for it (as in JAX)."""
    q_cfg, p_cfg, jecfg, z_scale = _elbo_setup(name)
    jecfg = dataclasses.replace(jecfg, rotate=True, translate=True)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, jecfg,
                             jax_trainer.TrainConfig(minibatch_size=B),
                             jnp.asarray(jax_grid(N, M)))
    y, noise = _batch(jecfg.likelihood, jecfg.channels, 1)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    (loss, aux), grads = grad_fn(jt.state.params, jnp.asarray(y), None, None,
                                 jnp.float32(z_scale),
                                 noise=jnp.asarray(noise))
    params = _np_tree(jt.state.params)
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg))
    ecfg = ElboConfig(**{f.name: getattr(jecfg, f.name)
                         for f in dataclasses.fields(ElboConfig)})
    got_loss, got_aux = loss_and_grad(
        q_net, p_net, ecfg, coord_grid(N, M), torch.from_numpy(y),
        noise=torch.from_numpy(noise), z_scale=z_scale)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(aux), rtol=1e-5)
    got = named_to_jax(q_net, p_net, {
        f"{k}.{n}": p.grad for k, net in (("q", q_net), ("p", p_net))
        for n, p in net.named_parameters()})
    _assert_trees(got, grads)


def test_elbo_refuses_a_config_that_disagrees_with_the_module():
    q_cfg, p_cfg, jecfg, _ = _elbo_setup("mnist")
    params = _np_tree(jax_trainer.Trainer(
        q_cfg, p_cfg, jecfg, jax_trainer.TrainConfig(),
        jnp.asarray(jax_grid(N, M))).state.params)
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg))
    y, noise = _batch("bernoulli", 1, 0)
    with pytest.raises(ValueError, match="VanillaGenerator"):
        loss_and_grad(q_net, p_net, ElboConfig(rotate=False, translate=False),
                      coord_grid(N, M), torch.from_numpy(y),
                      noise=torch.from_numpy(noise))


def test_int8_gates_follow_jax():
    """``--int8-decoder`` with ``--vanilla``: no loss kernel, no target
    copy, and with bf16 compute the int8 encoder copies, whose JAX gate
    (``_use_qenc = _use_shadow and ecfg.int8``) has no vanilla term; an
    epoch of int8 vanilla steps (tail included) runs."""
    q_cfg, p_cfg, jecfg, _ = _elbo_setup("galaxy_rgb")
    ecfg = ElboConfig(vanilla=True, rotate=False, translate=False,
                      channels=3, fused=True, int8=True)
    assert not fused_loss_active(ecfg, to_port(p_cfg), N * M, B)
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ecfg,
                 TrainConfig(minibatch_size=B, compute_dtype="bfloat16"),
                 coord_grid(N, M), device="cpu")
    assert not tr._wants_yt() and tr._use_qenc and tr._wants_yq8()
    y, _ = _batch("bernoulli", 3, 5, b=2 * B + 1)
    m = tr.train_epoch(torch.from_numpy(y), 0, progress=False)
    assert np.isfinite(m).all()


@pytest.mark.parametrize("name", ["galaxy_rgb", "colored_fit_noise"])
def test_trainer_steps_and_adam_state_match_jax(name):
    """Three steps on fixed batches and noise, then the weights and Adam's
    moments; the trainer's augmentation is off for vanilla, as in JAX."""
    q_cfg, p_cfg, jecfg, _ = _elbo_setup(name)
    tkw = dict(minibatch_size=B, augment_rotation=True, image_shape=(N, M),
               channels=jecfg.channels)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, jecfg,
                             jax_trainer.TrainConfig(**tkw),
                             jnp.asarray(jax_grid(N, M)))
    ecfg = ElboConfig(**{f.name: getattr(jecfg, f.name)
                         for f in dataclasses.fields(ElboConfig)})
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ecfg, TrainConfig(**tkw),
                 coord_grid(N, M), device="cpu")
    params = _np_tree(jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], tr.q_cfg, tr.p_cfg)
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state = jt.state
    for step in range(3):
        y, noise = _batch(jecfg.likelihood, jecfg.channels, 10 + step)
        (_, aux), grads = grad_fn(state.params, jnp.asarray(y), None, None,
                                  jnp.float32(1.0), noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jnp.float32)
        got = tr.train_step(torch.from_numpy(y),
                            noise=torch.from_numpy(noise),
                            generator=torch.Generator().manual_seed(step))
        np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=1e-5)
    assert tr.opt_state.count == int(state.opt_state.count) == 3
    _assert_trees(named_to_jax(tr.q_net, tr.p_net, tr.named_params()),
                  state.params)
    for got, want in ((tr.opt_state.mu, state.opt_state.mu),
                      (tr.opt_state.nu, state.opt_state.nu)):
        _assert_trees(named_to_jax(tr.q_net, tr.p_net, got), want, 1e-4,
                      1e-4)
    # the JAX state carried across whole: masters and moments, exactly
    port = state_from_jax(state, tr.q_net, tr.p_net)
    assert port["opt_state"].count == 3 and port["shadow"] is None
    for tree, named in ((state.params, port["params"]),
                        (state.opt_state.mu, port["opt_state"].mu),
                        (state.opt_state.nu, port["opt_state"].nu)):
        _assert_trees(named_to_jax(tr.q_net, tr.p_net, named), tree, 0, 0)


def test_display_paths_decode_z_alone():
    q_cfg, p_cfg, jecfg, _ = _elbo_setup("galaxy_rgb")
    tr = Trainer(to_port(q_cfg), to_port(p_cfg),
                 ElboConfig(vanilla=True, rotate=False, translate=False,
                            channels=3),
                 TrainConfig(minibatch_size=B), coord_grid(N, M),
                 device="cpu")
    y, noise = _batch("bernoulli", 3, 3)
    y = torch.from_numpy(y)
    noise = torch.from_numpy(noise)
    want = tr.p_net(torch.exp(tr.q_net(y.reshape(B, -1))[1]) * noise
                    + tr.q_net(y.reshape(B, -1))[0])
    torch.testing.assert_close(tr.reconstruct_canonical(y, noise=noise), want)
    torch.testing.assert_close(tr.reconstruct(y, noise=noise), want)
    torch.testing.assert_close(tr.sample_prior(B, Z, noise=noise),
                               tr.p_net(noise))
    assert want.shape == (B, N * M * 3, 1)


def _jax_pair(tmp_path, name="galaxy_rgb", elbo=True):
    q_cfg, p_cfg, jecfg, _ = _elbo_setup(name)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, jecfg, jax_trainer.TrainConfig(),
                             jnp.asarray(jax_grid(N, M)))
    gp, ip = str(tmp_path / "g.sav"), str(tmp_path / "i.sav")
    kw = dict(elbo=jecfg, image_shape=(N, M)) if elbo else {}
    jax_ckpt.save_model(gp, "generator", jt.state.params["p"], p_cfg, **kw)
    jax_ckpt.save_model(ip, "inference", jt.state.params["q"], q_cfg, **kw)
    return jt, gp, ip


@pytest.mark.parametrize("elbo", [True, False], ids=["persisted", "pre_r2"])
def test_api_matches_jax(tmp_path, elbo):
    """encode, decode, sample, reconstruct and reconstruct_canonical on one
    JAX-written vanilla pair, each package's draws shared through
    ``noise=``; a pair without the persisted ELBO config falls back to the
    latent layout (no pose slots)."""
    _, gp, ip = _jax_pair(tmp_path, elbo=elbo)
    jv = JaxVae.load(gp, ip, image_shape=(N, M))
    pv = SpatialVae.load(gp, ip, image_shape=(N, M), device="cpu")
    assert jv.vanilla and pv.vanilla and jv.pose_dims == pv.pose_dims == 0
    y, _ = _batch("bernoulli", 3, 4)
    for a, b in zip(pv.encode(y), jv.encode(jnp.asarray(y))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, (B, Z)))
    np.testing.assert_allclose(pv.decode(z).numpy(),
                               np.asarray(jv.decode(jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(pv.sample(B, noise=z).numpy(),
                               np.asarray(jv.sample(B, key)), **TOL)
    np.testing.assert_allclose(pv.reconstruct(y, noise=z).numpy(),
                               np.asarray(jv.reconstruct(jnp.asarray(y),
                                                         key)), **TOL)
    np.testing.assert_allclose(
        pv.reconstruct_canonical(y, noise=z).numpy(),
        np.asarray(jv.reconstruct_canonical(jnp.asarray(y), key)), **TOL)


def test_checkpoints_cross_packages(tmp_path):
    """A JAX-written vanilla pair and Adam state load in the port; the
    port's, written from a trained port model, load in JAX with the same
    arrays."""
    jt, gp, ip = _jax_pair(tmp_path, "colored_fit_noise")
    op = str(tmp_path / "o.sav")
    jax_ckpt.save_optimizer(op, jt.state.opt_state, 4)
    params, cfg, kind, meta = checkpoint.load_model_meta(gp)
    assert kind == "generator" and cfg == to_port(jt.p_cfg)
    assert meta["elbo"].vanilla and meta["image_shape"] == (N, M)
    q_cfg, p_cfg, jecfg, _ = _elbo_setup("colored_fit_noise")
    ecfg = ElboConfig(**{f.name: getattr(jecfg, f.name)
                         for f in dataclasses.fields(ElboConfig)})
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ecfg,
                 TrainConfig(minibatch_size=B), coord_grid(N, M),
                 device="cpu")
    state, epoch = checkpoint.load_optimizer(op, tr.q_net, tr.p_net)
    assert epoch == 4 and state.count == int(jt.state.opt_state.count)
    _assert_trees(named_to_jax(tr.q_net, tr.p_net, state.mu),
                  jt.state.opt_state.mu, 0, 0)
    y, _ = _batch("colored", 1, 6, b=2 * B)
    tr.train_epoch(torch.from_numpy(y), 0, progress=False)
    pg, pi, po = (str(tmp_path / f"p{s}.sav") for s in "gio")
    checkpoint.save_model(pg, "generator", tr.p_net, elbo=ecfg,
                          image_shape=(N, M))
    checkpoint.save_model(pi, "inference", tr.q_net, elbo=ecfg,
                          image_shape=(N, M))
    checkpoint.save_optimizer(po, tr.opt_state, 0, tr.q_net, tr.p_net)
    jp, jcfg, jkind = jax_ckpt.load_model(pg)
    assert jkind == "generator" and jcfg == p_cfg
    _assert_trees(generator_to_jax(tr.p_net), jp, 0, 0)
    jstate, jepoch = jax_ckpt.load_optimizer(po)
    assert jepoch == 0 and int(jstate.count) == tr.opt_state.count == 2
    _assert_trees(named_to_jax(tr.q_net, tr.p_net, tr.opt_state.nu),
                  jstate.nu, 0, 0)
    jv = JaxVae.load(pg, pi)
    assert jv.vanilla and jv.ecfg.likelihood == "colored"
