"""The port's int8 training slice against the JAX package, on the CPU: one
port ``Trainer`` and one JAX ``Trainer`` in int8 mode (``ElboConfig(
fused=True, int8=True)``), the same weights through the bridge, the same
batches and noise.  32x32 RGB images on the /255 grid, encoder hidden 128,
decoder 64 wide, batch 4 over 11 images: two full steps through the fused
loss kernel (K3) with int8 targets from the per-dataset copy, and a tail of
3 through the int8 decoder (K4 with its a1 output, K5).  Then the
evaluation metrics (K4 without a1, no loss kernel) and one reconstruction.
The JAX kernels run in Pallas interpret mode.

Tolerances, measured with a margin of 3-5x (float32 / bfloat16 compute):
the first step's metrics agree to 0 / 1.3e-5 relative.  Later steps see
weights that Adam moved: its first steps move a weight by about lr times
the sign of its gradient, so where a gradient element is near zero, a
difference in its last bits (summation order, an int8 tile flipped by a
tanh ulp, bf16 rounding points) flips the sign and the weight lands up to
2*lr per step away.  After three steps each leaf differs by at most 6*lr
= 6e-4 (measured 2.0e-4 / 4.0e-4) and by 1e-6 / 1e-5 on average (measured
1.8e-7 / 2.0e-6); the step metrics by 1e-3 / 2e-2 relative (measured
2.2e-4 / 5.3e-3), the evaluation's by 2e-3 / 3e-2 (3.7e-4 / 8.1e-3), the
reconstruction by 3e-3 / 1e-2 absolute at most and 3e-4 / 1e-3 on average
(6.6e-4 / 1.4e-3 and 5.4e-5 / 2.3e-4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives import elbo_minibatch as jax_elbo
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.objectives import ElboConfig, loss_terms
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

N = M = 32
C, Z, B, IMAGES = 3, 3, 4, 11


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _cfgs():
    q_cfg = InferenceConfig(n=N * M * C, latent_dim=Z + 3, hidden_dim=128,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=64, n_out=C,
                                   num_layers=2)
    return q_cfg, p_cfg


class _Data:
    def __init__(self, y):
        self.y = y
        self.ctf = None

    def __len__(self):
        return self.y.shape[0]


def _images(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (IMAGES, N * M, C)) / 255.0
            ).astype(np.float32)


def _trainers(dtype):
    q_cfg, p_cfg = _cfgs()
    ekw = dict(fused=True, int8=True, channels=C)
    jt = jax_trainer.Trainer(
        q_cfg, p_cfg, JaxElboConfig(**ekw),
        jax_trainer.TrainConfig(minibatch_size=B, compute_dtype=dtype),
        jnp.asarray(jax_grid(N, M)))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(minibatch_size=B, compute_dtype=dtype),
                 coord_grid(N, M), device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    return jt, tr


LR = TrainConfig().learning_rate
# compute dtype -> (step rtol, leaf max, leaf mean, eval rtol, reconstruction
# max, reconstruction mean), see the module docstring
TOL = {"float32": (1e-3, 6 * LR, 1e-6, 2e-3, 3e-3, 3e-4),
       "bfloat16": (2e-2, 6 * LR, 1e-5, 3e-2, 1e-2, 1e-3)}


def _assert_trees(got, want, max_abs, mean_abs):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(g, w):
        d = np.abs(a - np.asarray(b, np.float32))
        assert d.max() <= max_abs and d.mean() <= mean_abs, (
            a.shape, d.max(), d.mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_training_matches_jax(dtype, monkeypatch):
    jt, tr = _trainers(dtype)
    rtol, leaf_max, leaf_mean, eval_rtol, rec_max, rec_mean = TOL[dtype]
    y = _images()
    jdata_t = np.asarray(jt._dataset_yt(_Data(jnp.asarray(y))))
    data_t = tr._dataset_yt(torch.from_numpy(y))
    assert data_t.dtype == torch.int8 and np.array_equal(data_t.numpy(),
                                                         jdata_t)
    # the steps' paths, seen from the plain versions the CPU runs
    seen = []
    for mod, name in ((l8, "loss_int8_reference"),
                      (d8, "decoder_tail_int8_reference"),
                      (d8, "decoder_tail_int8_backward_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.append(_n) or _f(*a, **kw))
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state = jt.state
    rng = np.random.default_rng(5)
    batches = [np.array([0, 3, 5, 9]), np.array([1, 2, 7, 10]),
               np.array([4, 6, 8])]
    for idx in batches:
        noise = rng.normal(size=(len(idx), Z + 3)).astype(np.float32)
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
        np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=rtol)
    assert seen == ["loss_int8_reference"] * 2 + [
        "decoder_tail_int8_reference", "decoder_tail_int8_backward_reference"]
    got = named_to_jax(tr.q_net, tr.p_net, tr.named_params())
    _assert_trees(got, state.params, leaf_max, leaf_mean)

    # evaluation and one reconstruction with the trained weights: the int8
    # decoder forward without the loss kernel, same noise
    jt.state = state
    noise = rng.normal(size=(B, Z + 3)).astype(np.float32)
    ybatch = y[:B]
    seen.clear()
    _, jaux = jt._loss(state.params, jnp.asarray(ybatch), None, None,
                       jnp.float32(1.0), ecfg=jt._nonstep_ecfg,
                       noise=jnp.asarray(noise), augment=False)
    with torch.no_grad():
        _, aux = loss_terms(tr.q_net, tr.p_net, tr._nonstep_ecfg, tr.coords,
                            torch.from_numpy(ybatch),
                            noise=torch.from_numpy(noise),
                            compute_dtype=tr.compute_dtype)
    assert seen == ["decoder_tail_int8_reference"]
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=eval_rtol)
    _, _, _, want = jax_elbo(state.params["q"], state.params["p"],
                             jt.q_cfg, jt.p_cfg, jt._nonstep_ecfg,
                             jt.coords, jnp.asarray(ybatch), None,
                             noise=jnp.asarray(noise), want_y_hat=True)
    recon = tr.reconstruct(torch.from_numpy(ybatch),
                           noise=torch.from_numpy(noise))
    assert recon.shape == (B, N * M, C)
    d = np.abs(recon.numpy() - np.asarray(want, np.float32))
    assert d.max() <= rec_max and d.mean() <= rec_mean, (d.max(), d.mean())


def test_int8_epoch_takes_the_kernels_in_order(monkeypatch):
    """An epoch of 11 images at B=4: the two full batches take the loss
    kernel with int8 targets gathered from the cached copy, the tail of 3
    the int8 decoder with its backward; the evaluation takes the int8
    decoder forward only, once per batch; the ELBO stays finite."""
    _, tr = _trainers("float32")
    data = _Data(torch.from_numpy(_images()))
    calls = []
    run_loss = l8.run_loss_int8
    monkeypatch.setattr(l8, "run_loss_int8", lambda *a, **kw: calls.append(
        ("K3", a[6].dtype, a[0].shape[0])) or run_loss(*a, **kw))
    for name, tag in (("run_int8_tail", "K4"),
                      ("run_int8_tail_backward", "K5")):
        fn = getattr(d8, name)
        monkeypatch.setattr(d8, name, lambda *a, _f=fn, _t=tag, **kw:
                            calls.append((_t, kw.get("emit_a1", False),
                                          a[0].shape[0])) or _f(*a, **kw))
    elbo, gen_loss, kl = tr.train_epoch(data, 0, progress=False)
    assert np.isfinite([elbo, gen_loss, kl]).all()
    assert calls == [("K3", torch.int8, B)] * 2 + [("K4", True, 3),
                                                  ("K5", False, 3)]
    assert len(tr._yt_cache) == 1
    tr.train_epoch(data, 1, progress=False)
    assert len(tr._yt_cache) == 1              # the copy is reused
    calls.clear()
    tr.eval_epoch(data, 2)
    assert calls == [("K4", False, B)] * 2 + [("K4", False, 3)]


def test_target_copy_is_built_once_per_caller_array(monkeypatch):
    """The target copy is keyed by the caller's array, as in JAX: a numpy
    dataset, which each epoch copies to the device anew, gets one entry over
    ``train_epoch`` and ``train_epochs`` calls, built once."""
    from spatialvae_torch.train import trainer as port_trainer
    _, tr = _trainers("float32")
    y = _images()
    builds = []
    build = port_trainer.build_yt_i8
    monkeypatch.setattr(port_trainer, "build_yt_i8", lambda *a: builds.append(
        1) or build(*a))
    for dataset in (y, _Data(y)):
        tr._yt_cache.clear()
        builds.clear()
        tr.train_epoch(dataset, 0, progress=False)
        tr.train_epoch(dataset, 1, progress=False)
        tr.train_epochs(dataset, 2, 2)
        assert len(builds) == 1 and len(tr._yt_cache) == 1
        (src, _), = tr._yt_cache.values()
        assert src is y
