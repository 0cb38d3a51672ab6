"""The run diagnostics of the port, on the CPU: ``--debug-nans``,
``--profile-dir`` and ``tools/profile_step.py``.

- ``Trainer(..., debug_nans=True)``: a NaN in the data raises
  ``FloatingPointError`` naming the epoch and step, after the step's loss
  and gradient and before Adam writes, so the parameters are the step
  before's bit for bit; the JAX trainer under ``jax_debug_nans`` raises
  ``FloatingPointError`` on the same data, for the Bernoulli and the
  Gaussian likelihood.  A NaN decode gives a NaN Bernoulli loss and
  gradient in both packages (torch's ``binary_cross_entropy`` refuses
  inputs outside [0, 1]; the port's ``_bce_sum`` keeps its bits on the
  others; ROADMAP Queue 3 item 16).  A sound run trains to the same
  parameters bit for bit with and without the check (float and int8).
- ``chunk_len`` with a pending trace is the JAX CLI's; ``chunked_epochs``
  traces the one chunk that holds epoch index 1, its evaluation included,
  into ``trace_path``, and nothing when the run starts after it.
- ``python -m spatialvae_torch.tools.profile_step device=cpu`` prints its
  table at a toy size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatialvae_tpu.cli import common as jax_common
from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.data import ArrayDataset as JaxArrayDataset
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.cli import common
from spatialvae_torch.data.dataset import ArrayDataset
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C, Z, B = 16, 3, 3, 4


def _cfgs(n=N):
    return (InferenceConfig(n=n * n * C, latent_dim=Z + 3, hidden_dim=32,
                            num_layers=2),
            SpatialGeneratorConfig(latent_dim=Z, hidden_dim=32, n_out=C,
                                   num_layers=2))


def _images(count=12, n=N, nan_at=None):
    rng = np.random.default_rng(2)
    y = (rng.integers(0, 256, (count, n * n, C)) / 255.0).astype(np.float32)
    if nan_at is not None:
        y[nan_at, 5, 1] = np.nan
    return y


def _trainer(debug_nans, int8=False, n=N, likelihood="bernoulli"):
    q_cfg, p_cfg = map(to_port, _cfgs(n))
    return Trainer(q_cfg, p_cfg, ElboConfig(fused=True, int8=int8,
                                            channels=C,
                                            likelihood=likelihood),
                   TrainConfig(minibatch_size=B,
                               compute_dtype="bfloat16" if int8
                               else "float32", image_shape=(n, n)),
                   coord_grid(n, n), device="cpu", debug_nans=debug_nans)


def _params(tr):
    return {k: v.detach().clone() for k, v in tr.named_params().items()}


@pytest.mark.parametrize("likelihood", ["bernoulli", "gaussian"])
@pytest.mark.parametrize("stream", [False, True])
def test_debug_nans_stops_before_adam_writes(stream, likelihood,
                                             monkeypatch):
    """A NaN in one image: the step whose batch holds it raises, naming
    epoch 1 and that step; the parameters are those the step before left."""
    tr = _trainer(True, likelihood=likelihood)
    perm = torch.randperm(12, generator=tr._gen(0))
    batches = torch.sort(perm.reshape(3, B), dim=1).values
    bad = int(batches[1, 2])                      # in the second step
    data = ArrayDataset.from_numpy(_images(nan_at=bad), device="cpu",
                                   preload=not stream)
    before = []
    step = tr.train_step
    monkeypatch.setattr(tr, "train_step", lambda y, **kw: before.append(
        _params(tr)) or step(y, **kw))
    with pytest.raises(FloatingPointError,
                       match=r"loss terms.*at epoch 1, step 2 "):
        tr.train_epoch(data, 0, progress=False)
    assert len(before) == 2
    now = _params(tr)
    assert all(torch.equal(now[k], before[1][k]) for k in now)
    assert not all(torch.equal(now[k], before[0][k]) for k in now)


def test_jax_debug_nans_raises_on_the_same_data():
    q_cfg, p_cfg = _cfgs()
    jt = jax_trainer.Trainer(q_cfg, p_cfg,
                             JaxElboConfig(channels=C,
                                           likelihood="gaussian"),
                             jax_trainer.TrainConfig(minibatch_size=B,
                                                     image_shape=(N, N)),
                             jnp.asarray(jax_grid(N, N)))
    data = JaxArrayDataset(jnp.asarray(_images(nan_at=3)))
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        jt.train_epoch(data, 0, progress=False)


def test_a_nan_decode_gives_a_nan_loss_as_in_jax():
    """The Bernoulli ELBO of a batch whose image holds a NaN: NaN in both
    packages (from one init and one noise), with a NaN gradient; torch's
    own BCE would raise on the NaN decode instead."""
    from spatialvae_tpu.objectives import elbo_minibatch as jax_elbo

    from spatialvae_torch.io.jax_params import from_jax_params
    from spatialvae_torch.objectives import elbo_minibatch

    q_cfg, p_cfg = _cfgs()
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(channels=C),
                             jax_trainer.TrainConfig(minibatch_size=B),
                             jnp.asarray(jax_grid(N, N)))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], *map(to_port,
                                                          (q_cfg, p_cfg)))
    y = _images(count=B, nan_at=2)
    noise = np.random.default_rng(3).normal(size=(B, Z + 3)).astype(
        np.float32)
    want = jax_elbo(params["q"], params["p"], q_cfg, p_cfg,
                    JaxElboConfig(channels=C), jnp.asarray(jax_grid(N, N)),
                    jnp.asarray(y), None, noise=jnp.asarray(noise))
    elbo = elbo_minibatch(q, p, ElboConfig(channels=C), coord_grid(N, N),
                          torch.from_numpy(y), noise=torch.from_numpy(noise))
    assert np.isnan(float(want[0])) and torch.isnan(elbo[0])
    elbo[0].backward()
    assert torch.isnan(next(p.parameters()).grad).any()


@pytest.mark.parametrize("int8", [False, True])
def test_a_sound_run_is_the_same_with_the_check(int8):
    n = 32 if int8 else N
    got = []
    for flag in (False, True):
        tr = _trainer(flag, int8=int8, n=n)
        y = torch.from_numpy(_images(count=10, n=n))
        rows = [tr.train_epoch(y, e, progress=False) for e in range(2)]
        got.append((rows, _params(tr)))
    assert got[0][0] == got[1][0]
    assert all(torch.equal(got[0][1][k], got[1][1][k]) for k in got[0][1])


def test_chunk_len_matches_the_jax_cli():
    for epoch in range(6):
        for num in range(epoch + 1, 8):
            for ev in (1, 2, 3):
                for save in (None, 1, 2, 4):
                    for pe in (None, 1):
                        assert common.chunk_len(epoch, num, ev, save, pe) \
                            == jax_common.chunk_len(epoch, num, ev, save,
                                                    pe)


class _Rec:
    """A trainer stand-in that records its epochs."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def train_epoch(self, dataset, epoch):
        self.calls.append(("train_epoch", epoch))
        torch.zeros(3).add_(1)
        return (0.0, 0.0, 0.0)

    def train_epochs(self, dataset, epoch, n):
        self.calls.append(("train_epochs", epoch, n))
        return np.zeros((n, 3))


@pytest.mark.parametrize("start", [0, 2])
def test_chunked_epochs_traces_the_chunk_with_epoch_index_1(tmp_path,
                                                            start):
    rec = _Rec()
    out = str(tmp_path / "prof")
    for rows, epoch in common.chunked_epochs(rec, None, start, 6, 3, None,
                                             out):
        traced = os.path.exists(common.trace_path(out))
        # the trace is written when the caller comes back for the next
        # chunk: never while its own chunk's evaluation runs
        assert not traced or epoch > 2
        rec.calls.append(("eval", epoch))
    if start == 0:
        assert rec.calls == [("train_epoch", 0), ("eval", 1),
                             ("train_epoch", 1), ("eval", 2),
                             ("train_epochs", 2, 3), ("eval", 5),
                             ("train_epoch", 5), ("eval", 6)]
        with open(common.trace_path(out)) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::add_" for e in events)
    else:
        assert rec.calls[0] == ("train_epochs", 2, 3)
        assert not os.path.exists(out)


def test_profile_step_prints_its_table(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "spatialvae_torch.tools.profile_step",
         "device=cpu", "batch=4", "steps=2", "side=32", "q_hidden=64",
         "p_hidden=32"], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert lines[0].startswith("# total CPU (operator self) time ")
    assert "over 2 steps" in lines[0] and "batch 4" in lines[0]
    rows = lines[1:]
    assert 10 <= len(rows) <= 25
    ms = [float(r.split()[0]) for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    assert any("_LossInt8" in r for r in rows)       # K3's op on the CPU
