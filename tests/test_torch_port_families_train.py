"""int8 training of the particles, fit-noise and mnist models against the JAX
package, on the CPU: one port ``Trainer`` and one JAX ``Trainer`` per
configuration (``ElboConfig(fused=True, int8=True)``), the same weights
through the bridge, the same batches and noise.

The three configurations are ``bench.py``'s, narrowed (encoder hidden 64,
decoder 32 wide, z = 3 or 2): **particles** 32x32 grayscale, Gaussian
likelihood, the unit-disc pixel mask, whitened (off-grid) images;
**colored** the same with ``n_out=2``; **mnist** 28x28 on the /255 grid,
Bernoulli, theta prior pi/4 with the mean penalty, 784 pixels padded to
1,024.  Batch 4 over 11 images: two full steps through the fused loss
kernel (K3) in the configuration's family with targets gathered from the
per-dataset copy, and a tail of 3 through the int8 decoder (K4 with a1, K5)
at ``n_out`` 1 and 2 with the likelihood in PyTorch.  The JAX kernels run in
Pallas interpret mode at the default knobs.

Tolerances (float32 / bfloat16 compute), measured on these inputs with a
margin of 2x or more.  The step metrics [elbo, -log_p, kl]: the first two
agree to 4.7e-6 / 7.1e-5 relative, held at 1e-4 / 1e-3.  In bf16 the KL is
a sum of bf16 addends of order 1 that nearly cancel (it reads 0.06 to
0.65), so it differs by up to two bf16 ulps of its addends, 7.8e-3
absolute (f32: 2.0e-6): an absolute floor of 1.6e-2 / 1e-5.  The leaves
after the three steps, as ``tests/test_torch_port_int8_train.py`` explains
(Adam's first steps move a weight by lr times the sign of its gradient, so
a gradient element near zero can land a leaf 2*lr per step apart): within
6*lr (measured 2.0e-4 / 2.7e-4), with a mean of 1e-6 / 1e-5 (5.0e-8 /
1.3e-6).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.api import SpatialVae as JaxVae
from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives import elbo_minibatch as jax_elbo
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch import checkpoint
from spatialvae_torch.api import SpatialVae
from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

B, IMAGES = 4, 11
# name: (image side, z, n_out, ElboConfig fields, mask, /255-grid data)
CONFIGS = {
    "particles": (32, 3, 1, dict(likelihood="gaussian"), True, False),
    "colored": (32, 3, 2, dict(likelihood="colored"), True, False),
    "mnist": (28, 2, 1, dict(likelihood="bernoulli", theta_prior=np.pi / 4,
                             theta_mean_penalty=True), False, True),
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


class _Data:
    def __init__(self, y):
        self.y = y
        self.ctf = None

    def __len__(self):
        return self.y.shape[0]


def _images(name, seed=4):
    """One blob per image at a random place: on the /255 grid, or whitened
    (signed, off the grid) with noise on top."""
    side, *_, on_grid = CONFIGS[name]
    rng = np.random.default_rng(seed)
    g = coord_grid(side, side).numpy()
    c = rng.uniform(-0.3, 0.3, (IMAGES, 1, 2))
    blob = np.exp(-np.sum((g[None] - c) ** 2, axis=2) / 0.08)[..., None]
    if on_grid:
        return (np.round(blob * 255.0) / 255.0).astype(np.float32)
    noise = rng.normal(size=blob.shape)
    return (blob - blob.mean() + 0.3 * noise).astype(np.float32)


def _mask(side):
    g = coord_grid(side, side).numpy()
    return (np.sum(g ** 2, axis=1) <= 1.0).astype(np.float32)


def _trainers(name, dtype):
    side, z, n_out, ekw, masked, _ = CONFIGS[name]
    q_cfg = InferenceConfig(n=side * side, latent_dim=z + 3, hidden_dim=64,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=z, hidden_dim=32, n_out=n_out,
                                   num_layers=2)
    ekw = dict(ekw, fused=True, int8=True, channels=1)
    mask = _mask(side) if masked else None
    jt = jax_trainer.Trainer(
        q_cfg, p_cfg, JaxElboConfig(**ekw),
        jax_trainer.TrainConfig(minibatch_size=B, compute_dtype=dtype),
        jnp.asarray(jax_grid(side, side)),
        mask=None if mask is None else jnp.asarray(mask))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(minibatch_size=B, compute_dtype=dtype),
                 coord_grid(side, side), mask=mask, device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    return jt, tr


LR = TrainConfig().learning_rate
# compute dtype -> (step rtol, step atol, leaf max, leaf mean), see the
# module docstring
TOL = {"float32": (1e-4, 1e-5, 6 * LR, 1e-6),
       "bfloat16": (1e-3, 1.6e-2, 6 * LR, 1e-5)}


def _worst_leaf_errors(tr, params) -> tuple:
    """(max, mean) absolute difference of the port's parameters from the
    JAX tree ``params``, the worst over the leaves."""
    g, gdef = jax.tree_util.tree_flatten(
        named_to_jax(tr.q_net, tr.p_net, tr.named_params()))
    w, wdef = jax.tree_util.tree_flatten(params)
    assert gdef == wdef
    ds = [np.abs(a - np.asarray(b, np.float32)) for a, b in zip(g, w)]
    return max(d.max() for d in ds), max(d.mean() for d in ds)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dataset_target_copy_matches_jax(name):
    """``_dataset_yt``: the same array as the JAX trainer builds, in shape,
    dtype and pad fill: int8 (N, 1, 1024) filled with -128 past pixel 784
    for mnist-shaped grid data, compute-dtype (N, 2, HW/2) for colored."""
    side, *_ = CONFIGS[name]
    hw = side * side
    jt, tr = _trainers(name, "bfloat16")
    y = _images(name)
    want = jt._dataset_yt(_Data(jnp.asarray(y)))
    got = tr._dataset_yt(torch.from_numpy(y))
    shape, dtype = {
        "particles": ((IMAGES, 1, hw), torch.bfloat16),
        "colored": ((IMAGES, 2, hw // 2), torch.bfloat16),
        "mnist": ((IMAGES, 1, 1024), torch.int8)}[name]
    assert got.shape == shape == want.shape and got.dtype == dtype
    assert got.is_contiguous()
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    if name == "mnist":
        assert (got[:, :, hw:] == -128).all()
        # off-grid data of the same shape pads with 0.0 in the compute dtype
        off = (y * 0.999).astype(np.float32)
        want = jt._dataset_yt(_Data(jnp.asarray(off)))
        got = tr._dataset_yt(torch.from_numpy(off))
        assert got.dtype == torch.bfloat16 and got.shape == (IMAGES, 1, 1024)
        assert not got[:, :, hw:].any()
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_training_matches_jax(name, dtype, monkeypatch):
    side, z, n_out, *_ = CONFIGS[name]
    jt, tr = _trainers(name, dtype)
    rtol, atol, leaf_max, leaf_mean = TOL[dtype]
    y = _images(name)
    jdata_t = np.asarray(jt._dataset_yt(_Data(jnp.asarray(y))))
    data_t = tr._dataset_yt(torch.from_numpy(y))
    seen = []
    for mod, fname in ((l8, "loss_int8_reference"),
                       (d8, "decoder_tail_int8_reference"),
                       (d8, "decoder_tail_int8_backward_reference")):
        fn = getattr(mod, fname)
        monkeypatch.setattr(mod, fname, lambda *a, _f=fn, _n=fname, **kw:
                            seen.append((_n, a[-1] if _n.startswith("loss")
                                         else a[5].shape[0])) or _f(*a, **kw))
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state = jt.state
    rng = np.random.default_rng(5)
    batches = [np.array([0, 3, 5, 9]), np.array([1, 2, 7, 10]),
               np.array([4, 6, 8])]
    for idx in batches:
        noise = rng.normal(size=(len(idx), z + 3)).astype(np.float32)
        y_t = jdata_t[idx] if len(idx) == B else None
        (_, aux), grads = grad_fn(
            state.params, jnp.asarray(y[idx]), None, None, jnp.float32(1.0),
            y_t=None if y_t is None else jnp.asarray(y_t),
            noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jt._compute_dtype)
        got = tr.train_step(torch.from_numpy(y[idx]),
                            y_t=None if y_t is None else data_t[idx],
                            noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=rtol,
                                   atol=atol)
    family = tr.ecfg.likelihood
    assert seen == [("loss_int8_reference", family)] * 2 + [
        ("decoder_tail_int8_reference", n_out),
        ("decoder_tail_int8_backward_reference", n_out)]
    worst_max, worst_mean = _worst_leaf_errors(tr, state.params)
    assert worst_max <= leaf_max and worst_mean <= leaf_mean, (worst_max,
                                                               worst_mean)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_epoch_takes_the_kernels_in_order(name, monkeypatch):
    """An epoch of 11 images at B=4 through ``train_epoch``: the two full
    batches take the loss kernel in the configuration's family with the
    trainer's mask and targets gathered from the cached copy, the tail of 3
    the int8 decoder and its backward; the evaluation the int8 forward only;
    the evaluation's ELBO is finite and rises over three epochs."""
    side, _, n_out, _, masked, on_grid = CONFIGS[name]
    _, tr = _trainers(name, "bfloat16")
    data = _Data(torch.from_numpy(_images(name)))
    calls = []
    run_loss = l8.run_loss_int8
    monkeypatch.setattr(l8, "run_loss_int8", lambda *a, **kw: calls.append(
        ("K3", a[6].dtype, tuple(a[6].shape[1:]), a[7] is not None, a[8]))
        or run_loss(*a, **kw))
    for fname, tag in (("run_int8_tail", "K4"),
                       ("run_int8_tail_backward", "K5")):
        fn = getattr(d8, fname)
        monkeypatch.setattr(d8, fname, lambda *a, _f=fn, _t=tag, **kw:
                            calls.append((_t, a[0].shape[0])) or _f(*a, **kw))
    before = tr.eval_epoch(data, 0)
    calls.clear()
    elbo, gen_loss, kl = tr.train_epoch(data, 0, progress=False)
    assert np.isfinite([elbo, gen_loss, kl]).all()
    hw = side * side
    yt_shape = (2, hw // 2) if name == "colored" else (1, l8.padded_hw(hw))
    # the padded family always runs under its forced mask
    k3 = ("K3", torch.int8 if on_grid else torch.bfloat16, yt_shape,
          masked or l8.padded_hw(hw) != hw, tr.ecfg.likelihood)
    assert calls == [k3] * 2 + [("K4", 3), ("K5", 3)]
    tr.train_epoch(data, 1, progress=False)
    tr.train_epoch(data, 2, progress=False)
    assert len(tr._yt_cache) == 1
    calls.clear()
    after = tr.eval_epoch(data, 3)
    assert calls == [("K4", B)] * 2 + [("K4", 3)]
    assert np.isfinite(before + after).all() and after[0] > before[0]


def test_trainer_takes_a_numpy_mask():
    _, tr = _trainers("particles", "float32")
    assert isinstance(tr.mask, torch.Tensor) and tr.mask.shape == (1024,)
    assert tr.mask.dtype == torch.float32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_colored_checkpoint_crosses_packages(writer, tmp_path):
    """A colored (fit-noise) model written by one package loads in the
    other; ``reconstruct`` returns the predicted mean (B, HW, 1), not the
    two-channel head, and both packages agree on it (float32, the plain and
    the float fused decoder: 1e-5 absolute)."""
    side, z, n_out, ekw, *_ = CONFIGS["colored"]
    jt, tr = _trainers("colored", "float32")
    ekw = dict(ekw, fused=True, int8=True, channels=1)
    gen, inf = (str(tmp_path / f"c_{k}_epoch1.sav")
                for k in ("generator", "inference"))
    if writer == "jax":
        for path, kind, key, cfg in ((gen, "generator", "p", jt.p_cfg),
                                     (inf, "inference", "q", jt.q_cfg)):
            jax_ckpt.save_model(path, kind, jt.state.params[key], cfg,
                                elbo=JaxElboConfig(**ekw),
                                image_shape=(side, side))
    else:
        for path, kind, net in ((gen, "generator", tr.p_net),
                                (inf, "inference", tr.q_net)):
            checkpoint.save_model(path, kind, net, elbo=ElboConfig(**ekw),
                                  image_shape=(side, side))
    port = SpatialVae.load(gen, inf, device="cpu")
    jmodel = JaxVae.load(gen, inf)
    assert port.ecfg.likelihood == jmodel.ecfg.likelihood == "colored"
    assert port.p_cfg.n_out == jmodel.p_cfg.n_out == 2
    y = _images("colored")[:B]
    noise = np.random.default_rng(8).normal(size=(B, z + 3)).astype(
        np.float32)
    got = port.reconstruct(y, noise=noise)
    assert got.shape == (B, side * side, 1)
    _, _, _, want = jax_elbo(
        jmodel.q_params, jmodel.p_params, jmodel.q_cfg, jmodel.p_cfg,
        dataclasses.replace(jmodel.ecfg, fused=False, int8=False),
        jmodel.coords, jnp.asarray(y), None, noise=jnp.asarray(noise),
        want_y_hat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # the canonical decode and the prior samples keep the two-channel head
    assert port.sample(3, noise=noise[:3, :z]).shape == (3, side * side, 2)
