"""The port's serving slice against the JAX package, on the CPU: the ELBO
with injected noise (fused decoder in Pallas interpret mode and the plain
decoder), the SpatialVae API on checkpoints written by the JAX package, the
evaluation loop, and the guards on what the slice refuses."""

import dataclasses
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.api import SpatialVae as JaxVae
from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.io.torch_import import export_generator, export_inference
from spatialvae_tpu.models import inference_init, spatial_generator_init
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives import elbo_minibatch as jax_elbo
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch import checkpoint
from spatialvae_torch.api import SpatialVae
from spatialvae_torch.evaluate import eval_batches
from spatialvae_torch.io.jax_params import from_jax_params
from spatialvae_torch.kernels.fused_decoder import fused_decoder_tail
from spatialvae_torch.objectives import ElboConfig, elbo_minibatch
from spatialvae_torch.precision import fp32_precision_pinned
from spatialvae_torch.transforms.coords import coord_grid

RTOL = 1e-5


def _model(n=16, m=16, channels=3, z_dim=3, seed=0):
    q_cfg = InferenceConfig(n=n * m * channels, latent_dim=z_dim + 3,
                            hidden_dim=32, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=z_dim, hidden_dim=32,
                                   n_out=channels, num_layers=2)
    kq, kp = jax.random.split(jax.random.PRNGKey(seed))
    qp = jax.tree_util.tree_map(np.asarray, inference_init(kq, q_cfg))
    pp = jax.tree_util.tree_map(np.asarray, spatial_generator_init(kp, p_cfg))
    return q_cfg, p_cfg, qp, pp


def _images(b, n, m, channels, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, size=(b, n * m, channels)) / 255.0
    return y.astype(np.float32).reshape((b, n * m) if channels == 1
                                        else (b, n * m, channels))


def _mask(n, m):
    yg, xg = np.ogrid[:n, :m]
    dist = np.sqrt((n / 2 - yg) ** 2 + (m / 2 - xg) ** 2)
    return (dist < min(n, m) / 2).ravel().astype(np.float32)


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


ELBO_CASES = {
    # name: (image (n, m, channels), fused, mask, theta_mean_penalty,
    #        z_scale, use_fold)
    "plain": ((16, 16, 3), False, False, False, 1.0, True),
    "fused": ((16, 16, 3), True, False, False, 1.0, True),
    "fused_mask": ((16, 16, 3), True, True, False, 1.0, True),
    "plain_mask_penalty": ((16, 16, 3), False, True, True, 1.0, True),
    "fused_penalty_zscale0": ((16, 16, 3), True, False, True, 0.0, True),
    "fused_mnist_shape": ((28, 28, 1), True, True, True, 1.0, True),
    "generic_unfolded": ((16, 16, 3), True, False, False, 1.0, False),
}


@pytest.mark.parametrize("name", sorted(ELBO_CASES))
def test_elbo_matches_jax(name):
    (n, m, ch), fused, use_mask, penalty, z_scale, use_fold = \
        ELBO_CASES[name]
    q_cfg, p_cfg, qp, pp = _model(n, m, ch)
    y = _images(5, n, m, ch)
    noise = np.random.default_rng(2).normal(
        size=(5, q_cfg.latent_dim)).astype(np.float32)
    mask = _mask(n, m) if use_mask else None
    kw = dict(rotate=True, translate=True, dx_scale=0.1,
              theta_prior=np.pi / 4 if penalty else np.pi,
              theta_mean_penalty=penalty, likelihood="bernoulli",
              channels=ch, fused=fused, use_fold=use_fold)
    with pltpu.force_tpu_interpret_mode():
        want = jax_elbo(qp, pp, q_cfg, p_cfg, JaxElboConfig(**kw),
                        jnp.asarray(jax_grid(n, m)), jnp.asarray(y), None,
                        noise=jnp.asarray(noise), z_scale=z_scale,
                        mask=None if mask is None else jnp.asarray(mask),
                        want_y_hat=True)
    q_net, p_net = from_jax_params(qp, pp, q_cfg, p_cfg)
    pinned = []                     # f32 pinned inside, restored after
    q_net.register_forward_hook(
        lambda *_: pinned.append(fp32_precision_pinned()))
    flags = _tf32_flags()
    before = fused_decoder_tail.launches
    got = elbo_minibatch(q_net, p_net, ElboConfig(**kw), coord_grid(n, m),
                         torch.from_numpy(y), noise=torch.from_numpy(noise),
                         z_scale=z_scale,
                         mask=None if mask is None else torch.from_numpy(mask))
    assert fused_decoder_tail.launches == before   # CPU: plain version
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=0, atol=1e-5)
    assert pinned == [True] and _tf32_flags() == flags


@pytest.mark.parametrize("what", [
    "gaussian", "colored", "ctf", "offsets", "y_t", "int8", "pixel_axis",
    "vanilla"])
def test_elbo_refuses_what_is_not_ported(what):
    q_cfg, p_cfg, qp, pp = _model()
    q_net, p_net = from_jax_params(qp, pp, q_cfg, p_cfg)
    y = torch.from_numpy(_images(2, 16, 16, 3))
    ecfg = ElboConfig(channels=3)
    kw = {}
    if what in ("gaussian", "colored"):
        ecfg = ElboConfig(likelihood=what)
    elif what == "int8":
        ecfg = ElboConfig(channels=3, fused=True, int8=True)
    elif what == "vanilla":
        ecfg = ElboConfig(vanilla=True)
    else:
        kw[what] = {"ctf": torch.zeros((2, 3, 3)), "offsets": torch.zeros(2),
                    "y_t": torch.zeros((2, 3, 256)),
                    "pixel_axis": "model"}[what]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        elbo_minibatch(q_net, p_net, ecfg, coord_grid(16, 16), y,
                       torch.Generator().manual_seed(0), **kw)


def test_elbo_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxElboConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(ElboConfig)]
    assert pf == jf


def test_checkpoint_format_is_jax_format():
    assert checkpoint.FORMAT == jax_ckpt.FORMAT


def _jax_checkpoints(tmp_path, n=16, m=16, ch=3, elbo=True):
    q_cfg, p_cfg, qp, pp = _model(n, m, ch)
    ecfg = JaxElboConfig(theta_prior=np.pi, likelihood="bernoulli",
                         channels=ch, dx_scale=0.2, fused=True)
    gen = str(tmp_path / "run_generator_epoch1.sav")
    inf = str(tmp_path / "run_inference_epoch1.sav")
    extra = dict(elbo=ecfg, image_shape=(n, m)) if elbo else {}
    jax_ckpt.save_model(gen, "generator", pp, p_cfg, **extra)
    jax_ckpt.save_model(inf, "inference", qp, q_cfg, **extra)
    return gen, inf


def test_api_matches_jax_api(tmp_path):
    n = m = 16
    gen, inf = _jax_checkpoints(tmp_path, n, m)
    jm = JaxVae.load(gen, inf)
    pm = SpatialVae.load(gen, inf)
    assert pm.image_shape == (n, m) and pm.pose_dims == jm.pose_dims == 3
    assert pm.ecfg.dx_scale == 0.2 and pm.serving_ecfg.fused
    y = _images(4, n, m, 3)

    mu, logstd = jm.encode(jnp.asarray(y))
    pmu, plogstd = pm.encode(y)
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(plogstd.numpy(), np.asarray(logstd),
                               rtol=RTOL, atol=1e-6)

    z = np.asarray(mu)[:, 3:]
    np.testing.assert_allclose(pm.decode(z).numpy(),
                               np.asarray(jm.decode(jnp.asarray(z))),
                               rtol=0, atol=1e-5)

    # same standard-normal draw: JAX draws it from the key, the port takes
    # it as noise
    key = jax.random.PRNGKey(3)
    r = np.asarray(jax.random.normal(key, mu.shape, mu.dtype))
    want = np.asarray(jm.reconstruct(jnp.asarray(y), key))
    got = pm.reconstruct(y, noise=r)
    assert got.shape == (4, n * m, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)

    np.testing.assert_allclose(
        pm.reconstruct_canonical(y, noise=r).numpy(),
        np.asarray(jm.reconstruct_canonical(jnp.asarray(y), key)),
        rtol=0, atol=1e-5)
    zs = np.asarray(jax.random.normal(key, (6, 3)))
    np.testing.assert_allclose(pm.sample(6, noise=zs).numpy(),
                               np.asarray(jm.sample(6, key)), rtol=0,
                               atol=1e-5)
    g = torch.Generator().manual_seed(0)
    assert pm.sample(6, g).shape == (6, n * m, 3)


def test_api_pre_r2_checkpoint_and_reference_sav(tmp_path):
    """Checkpoints without persisted semantics take the latent-layout
    heuristic and need image_shape; reference torch .sav files load through
    io/torch_import."""
    gen, inf = _jax_checkpoints(tmp_path, elbo=False)
    with pytest.raises(ValueError, match="image_shape"):
        SpatialVae.load(gen, inf)
    pm = SpatialVae.load(gen, inf, image_shape=(16, 16))
    assert pm.ecfg is None and pm.pose_dims == 3
    assert pm.serving_ecfg == ElboConfig(rotate=True, translate=True,
                                         fused=True)

    q_cfg, p_cfg, qp, pp = _model()
    export_generator(pp, p_cfg, str(tmp_path / "ref_gen.sav"))
    export_inference(qp, q_cfg, str(tmp_path / "ref_inf.sav"))
    ref = SpatialVae.load(str(tmp_path / "ref_gen.sav"),
                          str(tmp_path / "ref_inf.sav"), image_shape=(16, 16))
    y = _images(3, 16, 16, 3)
    torch.testing.assert_close(ref.encode(y), pm.encode(y), rtol=0, atol=0)


def test_port_checkpoint_reads_in_jax(tmp_path):
    q_cfg, p_cfg, qp, pp = _model()
    q_net, p_net = from_jax_params(qp, pp, q_cfg, p_cfg)
    ecfg = ElboConfig(channels=3, dx_scale=0.3)
    path = str(tmp_path / "g.sav")
    checkpoint.save_model(path, "generator", p_net, elbo=ecfg,
                          image_shape=(16, 16))
    params, cfg, kind, meta = jax_ckpt.load_model_meta(path)
    assert kind == "generator" and cfg == p_cfg
    assert meta["image_shape"] == (16, 16)
    assert dataclasses.asdict(meta["elbo"]) == dataclasses.asdict(ecfg)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(pp)):
        np.testing.assert_array_equal(a, b)
    with open(path, "rb") as f:
        assert pickle.load(f)["format"] == jax_ckpt.FORMAT
    with pytest.raises(ValueError, match="kind"):
        checkpoint.save_model(path, "inference", p_net)


def test_eval_batches_matches_jax_loop(tmp_path):
    """Full batches plus a tail, averaged per image, against a loop over the
    JAX ELBO fed the same noise the port draws from its generator."""
    n = m = 16
    gen, inf = _jax_checkpoints(tmp_path, n, m)
    pm = SpatialVae.load(gen, inf)
    jm = JaxVae.load(gen, inf)
    images = _images(11, n, m, 3)
    got = eval_batches(pm, images, 4, torch.Generator().manual_seed(5))

    g = torch.Generator().manual_seed(5)
    acc, count = np.zeros(3), 0
    ecfg = dataclasses.replace(jm.ecfg, fused=False)
    for i in range(0, 11, 4):
        y = images[i:i + 4]
        noise = torch.randn((len(y), 6), generator=g).numpy()
        e, lp, kl, _ = jax_elbo(jm.q_params, jm.p_params, jm.q_cfg,
                                jm.p_cfg, ecfg, jm.coords, jnp.asarray(y),
                                None, noise=jnp.asarray(noise))
        count += len(y)
        acc += len(y) * (np.array([float(e), float(lp), float(kl)]) - acc) \
            / count
    np.testing.assert_allclose(np.array(got), acc, rtol=RTOL)
