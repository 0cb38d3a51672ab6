"""The port's rotation augmentation against the JAX package, on the CPU:
``rotate_images_bicubic`` against the JAX version (1e-5 absolute) and
against PIL (``tests/test_augment.py``'s limit, away from the border), the
ELBO with an augmented encoder view and its offsets, and three trainer
steps with augmentation (the angles JAX drew injected into the port's
steps) in float and int8 mode; evaluation never augments.

Tolerances as in ``test_torch_port_train.py`` (float: metrics rtol 1e-5,
leaves rtol 1e-5 with a floor of 1e-5 of the leaf's largest value) and
``test_torch_port_families_train.py`` (int8, K3 in Pallas interpret mode on
the JAX side: metrics 1e-4 relative, leaves within 6 lr, mean 1e-6).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives import elbo_minibatch as jax_elbo
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.augment import (
    rotate_images_bicubic as jax_rotate,
)
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.objectives import ElboConfig, elbo_minibatch
from spatialvae_torch.train.trainer import (
    TrainConfig,
    Trainer,
    seeded_generator,
)
from spatialvae_torch.transforms.augment import rotate_images_bicubic
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

LR = TrainConfig().learning_rate


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


@pytest.mark.parametrize("shape", [(5, 17, 19), (3, 12, 12, 3), (2, 40, 40),
                                   (4, 9, 8)], ids=str)
def test_rotation_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.random(shape).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, shape[0]).astype(np.float32)
    got = rotate_images_bicubic(torch.from_numpy(x), torch.from_numpy(theta))
    want = np.asarray(jax_rotate(jnp.asarray(x), jnp.asarray(theta)))
    assert got.shape == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("theta", [0.3, 1.2, np.pi / 2, 4.0])
def test_rotation_matches_pil_bicubic(theta):
    """PIL's float-mode BICUBIC rotate, away from the border (PIL's edge
    handling differs), at ``tests/test_augment.py``'s limit."""
    from PIL import Image

    img = np.random.RandomState(1).rand(17, 17).astype(np.float32)
    ref = np.array(Image.fromarray(img).rotate(
        360 * theta / (2 * np.pi), resample=Image.BICUBIC))
    out = rotate_images_bicubic(torch.from_numpy(img[None]),
                                torch.tensor([theta]))[0].numpy()
    inner = (slice(3, -3), slice(3, -3))
    np.testing.assert_allclose(out[inner], ref[inner], atol=2e-2)


def test_rotation_identity_and_quarter_turn():
    img = np.zeros((15, 15), np.float32)
    img[7, 11] = 1.0                                   # right of centre
    x = torch.from_numpy(np.stack([img, img]))
    out = rotate_images_bicubic(x, torch.tensor([0.0, math.pi / 2]))
    torch.testing.assert_close(out[0], x[0], rtol=0, atol=1e-6)
    assert out[1, 3, 7] > 0.5 and out[1, 7, 11] < 0.1  # now above centre


SIDE, Z, B = 12, 2, 4


def _cfgs(channels, side=SIDE):
    return (InferenceConfig(n=side * side * channels, latent_dim=Z + 3,
                            hidden_dim=48, num_layers=2),
            SpatialGeneratorConfig(latent_dim=Z, hidden_dim=32,
                                   n_out=channels, num_layers=2))


def _mask(side):
    g = coord_grid(side, side).numpy()
    return (np.sum(g ** 2, axis=1) <= 1.0).astype(np.float32)


def _batch(seed, channels, side=SIDE, on_grid=False):
    rng = np.random.default_rng(seed)
    shape = (B, side * side) + ((channels,) if channels > 1 else ())
    y = (np.round(rng.random(shape) * 255) / 255 if on_grid
         else rng.normal(size=shape)).astype(np.float32)
    noise = rng.normal(size=(B, Z + 3)).astype(np.float32)
    return y, noise


@pytest.mark.parametrize("likelihood", ["bernoulli", "gaussian"])
def test_elbo_with_offsets_and_an_encoder_view_matches_jax(likelihood):
    channels = 3 if likelihood == "bernoulli" else 1
    q_cfg, p_cfg = _cfgs(channels)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(),
                             jax_trainer.TrainConfig(),
                             jnp.asarray(jax_grid(SIDE, SIDE)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    y, noise = _batch(2, channels, on_grid=likelihood == "bernoulli")
    rng = np.random.default_rng(3)
    offsets = rng.uniform(0, 2 * np.pi, B).astype(np.float32)
    imgs = y.reshape((B, SIDE, SIDE) + ((3,) if channels > 1 else ()))
    y_inf = np.asarray(jax_rotate(jnp.asarray(imgs), jnp.asarray(offsets))
                       ).reshape(y.shape)
    mask = _mask(SIDE)
    ekw = dict(likelihood=likelihood, channels=channels)
    want = jax_elbo(params["q"], params["p"], q_cfg, p_cfg,
                    JaxElboConfig(**ekw), jnp.asarray(jax_grid(SIDE, SIDE)),
                    jnp.asarray(y), None, noise=jnp.asarray(noise),
                    y_inf=jnp.asarray(y_inf), offsets=jnp.asarray(offsets),
                    mask=jnp.asarray(mask))
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg))
    got = elbo_minibatch(q_net, p_net, ElboConfig(**ekw),
                         coord_grid(SIDE, SIDE), torch.from_numpy(y),
                         noise=torch.from_numpy(noise),
                         y_inf=torch.from_numpy(y_inf),
                         offsets=torch.from_numpy(offsets),
                         mask=torch.from_numpy(mask))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
    np.testing.assert_allclose(got[3].detach().numpy(), np.asarray(want[3]),
                               rtol=0, atol=1e-5)


# name: (channels, likelihood, int8, augment_uint8, image side)
STEP_CASES = {
    "particles": (1, "gaussian", False, False, SIDE),
    "galaxy_uint8": (3, "bernoulli", False, True, SIDE),
    "particles_int8": (1, "gaussian", True, False, 32),
}


def _trainers(name):
    channels, likelihood, int8, uint8, side = STEP_CASES[name]
    q_cfg, p_cfg = _cfgs(channels, side)
    mask = _mask(side)
    ekw = dict(likelihood=likelihood, channels=channels, int8=int8)
    tkw = dict(minibatch_size=B, augment_rotation=True, augment_uint8=uint8,
               image_shape=(side, side), channels=channels)
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
    return jt, tr


def _jax_offsets(key, dtype=jnp.float32):
    """The angles the JAX ``Trainer._loss`` draws from its step key."""
    _, k_off = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_off, (B,), dtype, 0.0,
                                         2.0 * np.pi))


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_trainer_steps_with_augmentation_match_jax(name):
    """Three steps on fixed batches and noise; JAX draws its angles from
    the step key, which the port's steps get as ``offsets=``.  The int8
    case takes the loss kernel (K3) with the offsets added to theta."""
    channels, _, int8, uint8, side = STEP_CASES[name]
    jt, tr = _trainers(name)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state = jt.state
    before = dict(l8.LAUNCHES)
    for step in range(3):
        y, noise = _batch(10 + step, channels, side, on_grid=uint8)
        key = jax.random.PRNGKey(step)
        (_, aux), grads = grad_fn(state.params, jnp.asarray(y), None, key,
                                  jnp.float32(1.0), noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jnp.float32)
        got = tr.train_step(torch.from_numpy(y),
                            noise=torch.from_numpy(noise),
                            offsets=torch.from_numpy(_jax_offsets(key)))
        np.testing.assert_allclose(got.numpy(), np.asarray(aux),
                                   rtol=1e-4 if int8 else 1e-5)
    assert dict(l8.LAUNCHES) == before                  # CPU: plain version
    assert tr.opt_state.count == int(state.opt_state.count) == 3
    g, gdef = jax.tree_util.tree_flatten(
        named_to_jax(tr.q_net, tr.p_net, tr.named_params()))
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


def test_steps_draw_the_angles_before_the_noise_and_eval_never_augments():
    """A step's angles come from its generator, before the
    reparameterisation noise; the same draws injected give the same step.
    The evaluation of an augmenting trainer equals a non-augmenting one's."""
    _, tr = _trainers("particles")
    _, twin = _trainers("particles")
    y, _ = _batch(20, 1)
    g = seeded_generator(0, 5, "cpu")
    got = tr.train_step(torch.from_numpy(y), generator=g)
    g = seeded_generator(0, 5, "cpu")
    offsets = torch.rand(B, generator=g) * (2.0 * math.pi)
    noise = torch.randn((B, Z + 3), generator=g)
    want = twin.train_step(torch.from_numpy(y), offsets=offsets, noise=noise)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = Trainer(tr.q_cfg, tr.p_cfg, tr.ecfg,
                    TrainConfig(minibatch_size=B, image_shape=(SIDE, SIDE)),
                    tr.coords, mask=tr.mask, device="cpu")
    plain.q_net.load_state_dict(tr.q_net.state_dict())
    plain.p_net.load_state_dict(tr.p_net.state_dict())
    data = torch.from_numpy(np.concatenate([y, _batch(21, 1)[0][:3]]))
    assert tr.eval_epoch(data, 0) == plain.eval_epoch(data, 0)


def test_augmented_epochs_skip_the_int8_data_copy():
    """With augmentation the encoder sees rotated images, so the int8 copy
    of the data does not apply (the JAX ``_wants_yq8``); the loss kernel's
    target copy (the unrotated images) still does."""
    _, tr = _trainers("particles_int8")
    assert not tr._wants_yq8()
    assert tr._wants_yt()
    y, _ = _batch(30, 1, 32)
    m = tr.train_epoch(torch.from_numpy(np.concatenate([y, y])), 0,
                       progress=False)
    assert np.isfinite(m).all() and tr._yq8_cache == {}
    assert len(tr._yt_cache) == 1
