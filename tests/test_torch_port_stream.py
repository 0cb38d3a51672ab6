"""Host-resident streaming (``--no-preload``) in the port, on the CPU.

A streamed epoch (``ArrayDataset.from_numpy(..., preload=False)``) draws
the preloaded epoch's permutation, feeds its within-batch-sorted index
batches (checked with a recording array, as the JAX package's
``tests/test_trainer.py::test_no_preload_streaming_feeds_same_sorted_batches``
does) and runs the same steps, so a streamed float epoch and a streamed
evaluation equal the preloaded ones bit for bit (float32 and bf16 compute,
CTF, rotation augmentation).  In int8 mode the streamed epoch builds no
per-dataset target or encoder-input copy, and its steps (K3 reading float
targets, the int8 tail) are held to the JAX package's streamed steps on the
same batches and noise under the limits of ``test_torch_port_int8_train.py``
(float32 compute: step metrics rtol 1e-3, leaves 6 lr at most and 1e-6 on
average).  The per-step progress line lags one step.  The particles CLI
runs with ``--no-preload`` and prints the preloaded run's lines.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.cli import train_particles as cli
from spatialvae_torch.data.dataset import ArrayDataset
from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

N = M = 16
C, Z, B, IMAGES = 3, 3, 4, 11


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _cfgs(n=N, c=C):
    return (InferenceConfig(n=n * n * c, latent_dim=Z + 3, hidden_dim=32,
                            num_layers=2),
            SpatialGeneratorConfig(latent_dim=Z, hidden_dim=32, n_out=c,
                                   num_layers=2))


def _images(n=N, c=C, count=IMAGES, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (count, n * n, c)) / 255.0
            ).astype(np.float32)


def _trainer(dtype="float32", int8=False, augment=False, n=N, c=C,
             likelihood="bernoulli"):
    q_cfg, p_cfg = map(to_port, _cfgs(n, c))
    return Trainer(q_cfg, p_cfg,
                   ElboConfig(fused=True, int8=int8, channels=c,
                              likelihood=likelihood),
                   TrainConfig(minibatch_size=B, compute_dtype=dtype,
                               augment_rotation=augment, image_shape=(n, n),
                               channels=c),
                   coord_grid(n, n), device="cpu")


class RecordingArray:
    """A host array that records every index it is read at."""

    def __init__(self, a):
        self.a = a
        self.calls = []

    def __getitem__(self, idx):
        self.calls.append(np.asarray(idx))
        return self.a[idx]

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype


def _metrics(tr, data, epochs=2):
    rows = [tr.train_epoch(data, e, progress=False) for e in range(epochs)]
    rows.append(tr.eval_epoch(data, epochs))
    return rows, {k: v.detach().clone() for k, v in tr.named_params().items()}


@pytest.mark.parametrize("case", ["float32", "bfloat16", "ctf", "augment"])
def test_streamed_epochs_equal_preloaded_ones(case):
    """Two training epochs and an evaluation, streamed and preloaded, from
    one seed: every metric and every parameter bit for bit."""
    y = _images()
    ctf = None
    kw = dict(dtype="bfloat16" if case == "bfloat16" else "float32",
              augment=case == "augment")
    if case == "ctf":
        kw.update(c=1, likelihood="gaussian")
        y = _images(c=1)
        ctf = np.random.default_rng(6).normal(
            size=(IMAGES, 5, 5)).astype(np.float32)
    got = _metrics(_trainer(**kw), ArrayDataset.from_numpy(
        y, ctf, preload=False))
    want = _metrics(_trainer(**kw), ArrayDataset.from_numpy(
        y, ctf, device="cpu"))
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_streamed_path_feeds_the_same_sorted_batches():
    """The rows the streamed epoch reads are the preloaded epoch's index
    batches (each sorted), then its tail."""
    tr = _trainer()
    host = ArrayDataset.from_numpy(_images(), preload=False)
    rec = RecordingArray(host.y)
    host.y = rec
    tr.train_epoch(host, 3, progress=False)
    perm = torch.randperm(IMAGES, generator=tr._gen(2 * 3))
    full = torch.sort(perm[:8].reshape(2, B), dim=1).values.numpy()
    assert len(rec.calls) == 3
    for got, want in zip(rec.calls, full):
        assert (np.diff(got) >= 0).all()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rec.calls[2], perm[8:].numpy())
    # the evaluation streams its batches in order
    rec.calls.clear()
    tr.eval_epoch(host, 0)
    assert [c.tolist() for c in rec.calls] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]


def test_progress_line_lags_one_step():
    """Each step prints the running means up to the step before it; the
    epoch's summary line ends the epoch."""
    tr = _trainer()
    out = io.StringIO()
    tr.train_epoch(ArrayDataset.from_numpy(_images(count=16),
                                           preload=False), 0,
                   progress_stream=out)
    lines = out.getvalue().split("\r")
    # 4 full steps: lines after steps 2, 3 and 4 (steps 1, 1-2, 1-3), then
    # the summary
    assert len(lines) == 4
    assert "training 25.0%" in lines[0] and "training 75.0%" in lines[2]
    assert lines[3].startswith("# [1/100] training 100.0%")


def test_streamed_int8_builds_no_target_copy(monkeypatch):
    """int8 mode: the streamed steps take the loss kernel with float
    targets and the encoder input quantised in the step; the preloaded
    epoch's per-dataset copies are never built."""
    tr = _trainer("bfloat16", int8=True, n=32)
    seen = []
    step = tr.train_step
    monkeypatch.setattr(tr, "train_step", lambda y, **kw: seen.append(
        (kw.get("y_t"), kw.get("y_q8"), y.dtype)) or step(y, **kw))
    elbo = tr.train_epoch(ArrayDataset.from_numpy(
        _images(n=32), preload=False), 0, progress=False)
    assert np.isfinite(elbo).all()
    assert seen == [(None, None, torch.float32)] * 3
    assert tr._yt_cache == {} and tr._yq8_cache == {}


def test_streamed_int8_steps_match_the_jax_streamed_steps(monkeypatch):
    """The port's streamed int8 epoch (11 images at B=4: two K3 steps on
    float targets, a tail of 3 on K4/K5), its noise injected, against the
    JAX trainer's streamed step (``y_t`` None) on the same batches and
    noise, from one init."""
    n = 32
    q_cfg, p_cfg = _cfgs(n)
    ekw = dict(fused=True, int8=True, channels=C)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw),
                             jax_trainer.TrainConfig(minibatch_size=B),
                             jnp.asarray(jax_grid(n, n)))
    tr = _trainer(int8=True, n=n)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], tr.q_cfg, tr.p_cfg)
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    rng = np.random.default_rng(5)
    batches = []
    step = tr.train_step

    got = []

    def injected(y, **kw):
        assert kw.get("y_t") is None and kw.get("y_q8") is None
        noise = rng.normal(size=(y.shape[0], Z + 3)).astype(np.float32)
        batches.append((y.numpy().copy(), noise))
        got.append(step(y, noise=torch.from_numpy(noise), **kw))
        return got[-1]

    monkeypatch.setattr(tr, "train_step", injected)
    tr.train_epoch(ArrayDataset.from_numpy(_images(n=n), preload=False), 0,
                   progress=False)
    assert [len(y) for y, _ in batches] == [B, B, 3]
    grad_fn = jax.jit(jax.value_and_grad(jt._loss, has_aux=True),
                      static_argnums=(2, 3))
    state = jt.state
    for (y, noise), aux in zip(batches, got):
        (_, jaux), grads = grad_fn(state.params, jnp.asarray(y), None, None,
                                   jnp.float32(1.0), y_t=None,
                                   noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jt._compute_dtype)
        np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-3)
    lr = TrainConfig().learning_rate
    g, gdef = jax.tree_util.tree_flatten(
        named_to_jax(tr.q_net, tr.p_net, tr.named_params()))
    w, wdef = jax.tree_util.tree_flatten(state.params)
    assert gdef == wdef
    for a, b in zip(g, w):
        d = np.abs(a - np.asarray(b, np.float32))
        assert d.max() <= 6 * lr and d.mean() <= 1e-6, (a.shape, d.max())


def test_particles_cli_runs_with_no_preload(tmp_path, monkeypatch, capsys):
    """``--no-preload`` streams both sets and prints the preloaded run's
    lines, bit for bit."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    np.save("tr.npy", rng.randn(40, 8, 8).astype(np.float32))
    np.save("te.npy", rng.randn(20, 8, 8).astype(np.float32))
    base = ["tr.npy", "te.npy", "--minibatch-size", "16", "--p-hidden-dim",
            "8", "--q-hidden-dim", "8", "-d", "-1", "--num-epochs", "2",
            "--mask"]
    cli.main(base)
    want = capsys.readouterr().out
    cli.main(base + ["--no-preload"])
    got = capsys.readouterr().out
    assert got == want and got.count("\ttest\t") == 2
