"""PyTorch port vs the JAX package: coords, layers, models, the pose fold and
the weight bridge, on the CPU at small sizes.  Inputs and weights come from
a numpy seed and pass between the packages as numpy arrays; tolerances are
float32 (1e-5) unless stated."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.io.torch_import import (
    build_generator_module,
    build_inference_module,
)
from spatialvae_tpu.models import (
    inference_apply,
    inference_init,
    spatial_generator_apply,
    spatial_generator_init,
)
from spatialvae_tpu.models.spatial import (
    spatial_generator_apply_folded as jax_apply_folded,
)
from spatialvae_tpu.nn.layers import ACTIVATIONS as JAX_ACTIVATIONS
from spatialvae_tpu.transforms import coords as jax_coords

from spatialvae_torch.io.jax_params import (
    from_jax_params,
    generator_from_jax,
    inference_from_jax,
    to_jax_params,
)
from spatialvae_torch.models import (
    InferenceNetwork,
    SpatialGenerator,
    fold_pose_into_first_layer,
    spatial_generator_apply_folded,
)
from spatialvae_torch.nn.layers import resolve_activation
from spatialvae_torch.transforms import coords as port_coords

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _pose(rng, b, z_dim):
    theta = rng.normal(size=b).astype(np.float32)
    dx = (0.1 * rng.normal(size=(b, 2))).astype(np.float32)
    z = rng.normal(size=(b, z_dim)).astype(np.float32)
    return theta, dx, z


def test_coords_match_jax():
    rng = np.random.default_rng(0)
    for n, m in ((16, 16), (28, 28), (5, 7)):
        np.testing.assert_array_equal(port_coords.coord_grid(n, m).numpy(),
                                      jax_coords.coord_grid(n, m))
    grid = jax_coords.coord_grid(16, 16)
    theta, dx, _ = _pose(rng, 4, 1)
    want = jax_coords.translate_coords(
        jax_coords.rotate_coords(jnp.asarray(grid), theta), dx)
    got = port_coords.translate_coords(
        port_coords.rotate_coords(_t(grid), _t(theta)), _t(dx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(JAX_ACTIVATIONS))
def test_activation_table_matches_jax(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(resolve_activation(name)(_t(x)).numpy(),
                               np.asarray(JAX_ACTIVATIONS[name](x)), **TOL)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        resolve_activation("gelu")


@pytest.mark.parametrize("num_layers,resid,act", [
    (1, False, "tanh"), (3, True, "tanh"), (2, False, "relu"),
    (2, True, "leakyrelu")])
def test_inference_network_matches_jax(num_layers, resid, act):
    """Also pins the MLP resid rule: the first layer is never residual."""
    cfg = InferenceConfig(n=48, latent_dim=5, hidden_dim=24,
                          num_layers=num_layers, activation=act, resid=resid)
    params = _np_tree(inference_init(jax.random.PRNGKey(num_layers), cfg))
    y = np.random.default_rng(1).uniform(size=(6, 48)).astype(np.float32)
    mu, logstd = inference_apply(params, cfg, jnp.asarray(y))
    net = inference_from_jax(params, cfg)
    with torch.no_grad():
        pmu, plogstd = net(_t(y))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(plogstd.numpy(), np.asarray(logstd), **TOL)


GEN_CASES = {
    "plain": dict(),
    "resid_softplus": dict(resid=True, softplus=True, num_layers=3),
    "expand_coords": dict(expand_coords=True),
    "bilinear": dict(bilinear=True),
    "relu_n_out2": dict(activation="relu", n_out=2),
    "no_latent": dict(latent_dim=0),
}


def _gen(case, seed=0):
    kw = dict(latent_dim=3, hidden_dim=20, n_out=3, num_layers=2)
    kw.update(GEN_CASES[case])
    cfg = SpatialGeneratorConfig(**kw)
    params = _np_tree(spatial_generator_init(jax.random.PRNGKey(seed), cfg))
    return cfg, params


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_spatial_generator_generic_matches_jax(case):
    cfg, params = _gen(case)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(4, 64, 2)).astype(np.float32)
    z = rng.normal(size=(4, cfg.latent_dim)).astype(np.float32)
    want = spatial_generator_apply(params, cfg, jnp.asarray(x),
                                   jnp.asarray(z))
    gen = generator_from_jax(params, cfg)
    with torch.no_grad():
        got = gen(_t(x), _t(z))
    assert got.shape == (4, 64, cfg.n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["plain", "resid_softplus", "relu_n_out2",
                                  "no_latent"])
@pytest.mark.parametrize("pose", ["full", "none"])
def test_spatial_generator_folded_matches_jax(case, pose):
    cfg, params = _gen(case)
    rng = np.random.default_rng(3)
    theta, dx, z = _pose(rng, 4, cfg.latent_dim)
    if pose == "none":
        theta = dx = None
    grid = jax_coords.coord_grid(8, 8)
    want = jax_apply_folded(params, cfg, jnp.asarray(grid), theta, dx, z)
    gen = generator_from_jax(params, cfg)
    with torch.no_grad():
        got = spatial_generator_apply_folded(
            gen, _t(grid), None if theta is None else _t(theta),
            None if dx is None else _t(dx), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fold_identity():
    """Folded decode == generic decode over the rotated+translated grid."""
    cfg, params = _gen("resid_softplus")
    theta, dx, z = _pose(np.random.default_rng(4), 5, cfg.latent_dim)
    gen = generator_from_jax(params, cfg)
    grid = port_coords.coord_grid(12, 12)
    with torch.no_grad():
        folded = spatial_generator_apply_folded(gen, grid, _t(theta),
                                                _t(dx), _t(z))
        x = port_coords.translate_coords(
            port_coords.rotate_coords(grid, _t(theta)), _t(dx))
        generic = gen(x, _t(z))
    np.testing.assert_allclose(folded.numpy(), generic.numpy(), **TOL)


def test_fold_needs_a_batch_carrier():
    cfg, params = _gen("no_latent")
    gen = generator_from_jax(params, cfg)
    with pytest.raises(ValueError, match=r"\(B, 0\)"):
        fold_pose_into_first_layer(gen, None, None, None)
    w0, w1, c = fold_pose_into_first_layer(gen, None, None,
                                           torch.zeros((3, 0)))
    assert w0.shape == w1.shape == c.shape == (3, cfg.hidden_dim)


@pytest.mark.parametrize("case", ["plain", "resid_softplus", "bilinear",
                                  "no_latent"])
def test_weight_bridge_round_trip(case):
    cfg, params = _gen(case)
    q_cfg = InferenceConfig(n=30, latent_dim=6, hidden_dim=12, num_layers=2,
                            resid=True)
    q_params = _np_tree(inference_init(jax.random.PRNGKey(9), q_cfg))
    q_net, p_net = from_jax_params(q_params, params, q_cfg, cfg,
                                   device="cpu", dtype=torch.float32)
    q_back, p_back = to_jax_params(q_net, p_net)
    for want, got in ((params, p_back), (q_params, q_back)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, b)


def test_weight_bridge_raises_on_mismatch():
    cfg, params = _gen("plain")
    bad = dict(params, coord={"w": params["coord"]["w"][:, :5],
                              "b": params["coord"]["b"]})
    with pytest.raises(ValueError, match="coord.w"):
        generator_from_jax(bad, cfg)
    with pytest.raises(ValueError, match="layers"):
        generator_from_jax(dict(params, layers=params["layers"][:1]), cfg)
    q_cfg = InferenceConfig(n=30, latent_dim=6, hidden_dim=12, num_layers=2)
    q_params = _np_tree(inference_init(jax.random.PRNGKey(9), q_cfg))
    with pytest.raises(ValueError, match=r"layers\[0\].w"):
        inference_from_jax(q_params,
                           InferenceConfig(n=31, latent_dim=6, hidden_dim=12,
                                           num_layers=2))


@pytest.mark.parametrize("case", ["plain", "resid_softplus", "bilinear"])
def test_modules_match_torch_import_layout(case):
    """The port's modules are the reference layout that
    io/torch_import.build_*_module describes: same state_dict, same
    forward."""
    cfg, params = _gen(case)
    ref = build_generator_module(params, cfg)
    gen = generator_from_jax(params, cfg)
    assert list(ref.state_dict()) == list(gen.state_dict())
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(gen.state_dict()[k], v, rtol=0, atol=0)

    # (forward on non-resid stacks: the stand-in ResidLinear class that
    # torch_import registers without the reference package has no forward)
    q_cfg = InferenceConfig(n=30, latent_dim=6, hidden_dim=12, num_layers=3)
    q_params = _np_tree(inference_init(jax.random.PRNGKey(9), q_cfg))
    qref = build_inference_module(q_params, q_cfg)
    qnet = inference_from_jax(q_params, q_cfg)
    assert list(qref.state_dict()) == list(qnet.state_dict())
    y = _t(np.random.default_rng(5).uniform(size=(3, 30)))
    with torch.no_grad():
        mu, logstd = qnet(y)
        torch.testing.assert_close(torch.cat([mu, logstd], 1), qref.layers(y),
                                   rtol=0, atol=0)


def test_seeded_init_is_torch_default_and_reproducible():
    cfg = SpatialGeneratorConfig(latent_dim=3, hidden_dim=40, n_out=3,
                                 num_layers=2)
    a = SpatialGenerator(cfg, generator=torch.Generator().manual_seed(7))
    b = SpatialGenerator(cfg, generator=torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    w = a.layers[1].weight
    assert float(w.abs().max()) <= 1 / np.sqrt(40)
    q = InferenceNetwork(InferenceConfig(n=30, latent_dim=6, hidden_dim=12),
                         generator=torch.Generator().manual_seed(7))
    assert float(q.layers[0].weight.abs().max()) <= 1 / np.sqrt(30)


def test_port_imports_no_jax():
    code = ("import sys, spatialvae_torch, spatialvae_torch.api, "
            "spatialvae_torch.kernels.fused_decoder, "
            "spatialvae_torch.evaluate, spatialvae_torch.checkpoint; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
