"""The port's training slice against the JAX package, on the CPU: the loss
and its gradient (``loss_and_grad`` against ``value_and_grad`` of the JAX
``Trainer._loss``), Adam, whole training steps, the epoch loop's properties
and the optimizer checkpoint in both directions.  The fused decoder runs in
Pallas interpret mode on the JAX side and as its plain version here.

Tolerances: float32 losses rtol 1e-5; float32 gradients rtol 1e-5 with an
absolute floor of 1e-5 of each leaf's largest value (sums over the batch
and the pixels in another order, with cancellation); bf16 compute as stated
at its test.  Adam matches to one float32 ulp.
"""

import dataclasses

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.train import optimizer as jax_opt
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch import checkpoint
from spatialvae_torch.io.jax_params import (
    from_jax_params,
    named_from_jax,
    named_to_jax,
)
from spatialvae_torch.objectives import ElboConfig, loss_and_grad
from spatialvae_torch.train.optimizer import fused_adam
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

N, M, C, Z, B = 16, 16, 3, 3, 4


def _cfgs():
    q_cfg = InferenceConfig(n=N * M * C, latent_dim=Z + 3, hidden_dim=32,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=32, n_out=C,
                                   num_layers=2)
    return q_cfg, p_cfg


def _mask():
    yg, xg = np.ogrid[:N, :M]
    dist = np.sqrt((N / 2 - yg) ** 2 + (M / 2 - xg) ** 2)
    return (dist < N / 2).ravel().astype(np.float32)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 256, size=(b, N * M, C)) / 255.0).astype(np.float32)
    noise = rng.normal(size=(b, Z + 3)).astype(np.float32)
    return y, noise


def _jax_trainer(fused, mask, dtype="float32", seed=0):
    q_cfg, p_cfg = _cfgs()
    return jax_trainer.Trainer(
        q_cfg, p_cfg, JaxElboConfig(fused=fused, channels=C),
        jax_trainer.TrainConfig(minibatch_size=B, compute_dtype=dtype,
                                seed=seed),
        jnp.asarray(jax_grid(N, M)),
        mask=None if mask is None else jnp.asarray(mask))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _assert_trees(got, want, rtol, floor):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(_np_tree(want))
    assert gdef == wdef
    for a, b in zip(g, w):
        scale = float(np.abs(b).max()) or 1.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale)


def _grads(q_net, p_net):
    return named_to_jax(q_net, p_net, {
        f"{k}.{n}": p.grad for k, net in (("q", q_net), ("p", p_net))
        for n, p in net.named_parameters()})


# (fused, mask, z_scale, compute dtype): every value of each axis appears
LOSS_CASES = [
    (True, False, 1.0, "float32"),
    (True, True, 0.0, "float32"),
    (False, True, 1.0, "float32"),
    (False, False, 0.0, "bfloat16"),
    (True, True, 1.0, "bfloat16"),
]


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "-".join(
    [("fused" if c[0] else "plain"), ("mask" if c[1] else "nomask"),
     f"z{c[2]:g}", c[3]]))
def test_loss_and_grad_matches_jax(case):
    """bf16 compute: both packages round params, batch and grid to bf16 and
    compute in bf16 with their own rounding points (torch rounds each
    Linear's output, XLA each fused op's), so the loss is held at 1e-2
    relative and each gradient leaf at 5e-2 of its largest value."""
    fused, use_mask, z_scale, dtype = case
    mask = _mask() if use_mask else None
    jt = _jax_trainer(fused, mask, dtype)
    y, noise = _batch(1)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    with pltpu.force_tpu_interpret_mode():
        (loss, aux), grads = grad_fn(jt.state.params, jnp.asarray(y), None,
                                     None, jnp.float32(z_scale),
                                     noise=jnp.asarray(noise))
    params = _np_tree(jt.state.params)
    q_net, p_net = from_jax_params(params["q"], params["p"],
                                   *map(to_port, _cfgs()))
    got_loss, got_aux = loss_and_grad(
        q_net, p_net, ElboConfig(fused=fused, channels=C), coord_grid(N, M),
        torch.from_numpy(y), noise=torch.from_numpy(noise), z_scale=z_scale,
        mask=None if mask is None else torch.from_numpy(mask),
        compute_dtype=getattr(torch, dtype))
    assert got_loss.dtype == got_aux.dtype == torch.float32
    rtol, floor = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 5e-2)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=rtol)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(aux), rtol=rtol)
    got = _grads(q_net, p_net)
    _assert_trees(got, grads, 0 if dtype == "bfloat16" else rtol, floor)
    if z_scale == 0.0:                  # z reaches no decoder weight
        assert not np.asarray(grads["p"]["latent"]["w"]).any()
        assert not got["p"]["latent"]["w"].any()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_saturated_sigmoid_gives_finite_gradients(fused):
    """A head bias of +/-60 saturates the sigmoid to exactly 1.0 or 0.0 in
    f32; BCE clamps its logs at -100 and its backward (torch's, which the
    JAX custom VJP copies) stays finite."""
    q_cfg, p_cfg = _cfgs()
    params = _np_tree(_jax_trainer(fused, None).state.params)
    params["p"]["layers"][-1]["b"] = np.array([60.0, -60.0, 60.0],
                                              np.float32)
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg))
    y, noise = _batch(2)
    loss, aux = loss_and_grad(q_net, p_net,
                              ElboConfig(fused=fused, channels=C),
                              coord_grid(N, M), torch.from_numpy(y),
                              noise=torch.from_numpy(noise))
    assert torch.isfinite(loss) and torch.isfinite(aux).all()
    assert float(aux[1]) > 1e4                  # the clamped log terms
    for net in (q_net, p_net):
        for p in net.parameters():
            assert torch.isfinite(p.grad).all()


def test_fused_adam_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    opt = jax_opt.fused_adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = fused_adam(1e-3)
    ts = topt.init(tp)
    for step in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, js = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update_apply({k: torch.from_numpy(v)
                                for k, v in grads.items()}, ts, tp)
        assert ts.count == int(js.count) == step + 1
        for k in shapes:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                np.testing.assert_array_max_ulp(got.numpy(),
                                                np.asarray(want), maxulp=1)


def _port_trainer(jt=None, **tkw):
    q_cfg, p_cfg = map(to_port, _cfgs())
    tr = Trainer(q_cfg, p_cfg, ElboConfig(fused=True, channels=C),
                 TrainConfig(minibatch_size=B, **tkw), coord_grid(N, M),
                 device="cpu")
    if jt is not None:
        params = _np_tree(jt.state.params)
        q, p = from_jax_params(params["q"], params["p"], q_cfg, p_cfg)
        tr.q_net.load_state_dict(q.state_dict())
        tr.p_net.load_state_dict(p.state_dict())
    return tr


def test_train_steps_match_jax():
    """Three steps on fixed batches and noise: the JAX step is
    ``grad_fn`` then ``apply_update`` (trainer.py:508-519)."""
    jt = _jax_trainer(True, None)
    tr = _port_trainer(jt)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state = jt.state
    for step in range(3):
        y, noise = _batch(10 + step)
        with pltpu.force_tpu_interpret_mode():
            (_, aux), grads = grad_fn(state.params, jnp.asarray(y), None,
                                      None, jnp.float32(1.0),
                                      noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jnp.float32)
        got = tr.train_step(torch.from_numpy(y),
                            noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=1e-5)
    assert tr.opt_state.count == int(state.opt_state.count) == 3
    got = named_to_jax(tr.q_net, tr.p_net, tr.named_params())
    # Adam divides by sqrt(v): a gradient that differs in its last bits
    # moves a weight by up to lr per step, so the floor is 1e-5 of the leaf
    _assert_trees(got, state.params, 1e-5, 1e-5)


class _Data:
    def __init__(self, y):
        self.y = y

    def __len__(self):
        return self.y.shape[0]


def test_epoch_loop_properties(monkeypatch):
    """Each image trains once per epoch, batches are sorted within, the
    tail trains as its own step and the z-delay zeroes z_scale before its
    epoch."""
    n = 2 * B + 3
    y, _ = _batch(4, n)
    y[:, 0, 0] = np.arange(n) / 255.0           # the image's index
    tr = _port_trainer(z_delay=1, num_epochs=2)
    seen = []
    step = tr.train_step

    def spy(batch, **kw):
        seen.append((np.rint(batch[:, 0, 0].numpy() * 255).astype(int),
                     kw["z_scale"]))
        return step(batch, **kw)

    monkeypatch.setattr(tr, "train_step", spy)
    for epoch in range(2):
        seen.clear()
        tr.train_epoch(_Data(torch.from_numpy(y)), epoch, progress=False)
        idx = [s[0] for s in seen]
        assert [len(i) for i in idx] == [B, B, 3]
        assert sorted(np.concatenate(idx)) == list(range(n))
        for i in idx[:-1]:
            assert list(i) == sorted(i)
        assert {s[1] for s in seen} == {0.0 if epoch < 1 else 1.0}
    assert tr.opt_state.count == 6


def test_train_epochs_matches_sequential_epochs_bit_for_bit():
    y, _ = _batch(5, 2 * B + 1)
    data = _Data(torch.from_numpy(y))
    a, b = _port_trainer(z_delay=1), _port_trainer(z_delay=1)
    rows = a.train_epochs(data, 0, 2)
    want = [b.train_epoch(data, e, progress=False) for e in range(2)]
    np.testing.assert_array_equal(rows, np.asarray(want))
    for p, q in zip(a.named_params().values(), b.named_params().values()):
        assert torch.equal(p, q)
    assert a.eval_epoch(data, 2) == b.eval_epoch(data, 2)


def test_eval_and_display_paths_save_nothing():
    y, _ = _batch(6, 5)
    tr = _port_trainer()
    data = _Data(torch.from_numpy(y))
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        elbo, gen_loss, kl = tr.eval_epoch(data, 0)
        out = [tr.reconstruct(torch.from_numpy(y)),
               tr.reconstruct_canonical(torch.from_numpy(y)),
               tr.sample_prior(3, Z)]
    assert packed == []
    assert np.isfinite([elbo, gen_loss, kl]).all() and gen_loss > 0
    assert [tuple(t.shape) for t in out] == [(5, N * M, C)] * 2 + [
        (3, N * M, C)]


def test_optimizer_checkpoint_round_trips_through_jax(tmp_path):
    """A port checkpoint loads in JAX's load_optimizer, and a JAX one in the
    port's, with the moments in each package's layout."""
    tr = _port_trainer()
    y, noise = _batch(7)
    tr.train_step(torch.from_numpy(y), noise=torch.from_numpy(noise))
    path = str(tmp_path / "port_optimizer.sav")
    checkpoint.save_optimizer(path, tr.opt_state, 3, tr.q_net, tr.p_net)
    js, epoch = jax_ckpt.load_optimizer(path)
    assert epoch == 3 and int(js.count) == 1
    _assert_trees(named_to_jax(tr.q_net, tr.p_net, tr.opt_state.mu), js.mu,
                  0, 0)
    _assert_trees(named_to_jax(tr.q_net, tr.p_net, tr.opt_state.nu), js.nu,
                  0, 0)
    back = str(tmp_path / "jax_optimizer.sav")
    jax_ckpt.save_optimizer(back, js, 4)
    state, epoch = checkpoint.load_optimizer(back, tr.q_net, tr.p_net)
    assert epoch == 4 and state.count == 1
    for k, v in tr.opt_state.mu.items():
        assert torch.equal(state.mu[k], v)
        assert torch.equal(state.nu[k], tr.opt_state.nu[k])
    mu = named_from_jax(_np_tree(js.mu), tr.q_net, tr.p_net)
    assert mu.keys() == tr.opt_state.mu.keys()


def test_train_config_matches_jax():
    want = {f.name: f.default for f in
            dataclasses.fields(jax_trainer.TrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got == want


@pytest.mark.parametrize("what", ["host", "augment"])
def test_trainer_streams_host_resident_data(what):
    """Host-resident data (``--no-preload``), with or without rotation
    augmentation, trains: the streamed epoch and evaluation equal the
    preloaded ones bit for bit (more cases in
    ``test_torch_port_stream.py``)."""
    from spatialvae_torch.data.dataset import ArrayDataset

    q_cfg, p_cfg = map(to_port, _cfgs())
    ecfg = ElboConfig(fused=True, channels=C)
    tcfg = TrainConfig(minibatch_size=B, augment_rotation=what == "augment",
                       image_shape=(N, M), channels=C)
    y = np.concatenate([_batch(s)[0] for s in range(3)])[:10]
    rows = []
    for preload in (True, False):
        tr = Trainer(q_cfg, p_cfg, ecfg, tcfg, coord_grid(N, M),
                     device="cpu")
        data = ArrayDataset.from_numpy(y, device="cpu", preload=preload)
        assert data.host_resident is not preload
        rows.append([tr.train_epoch(data, 0, progress=False),
                     tr.eval_epoch(data, 0)])
    assert rows[0] == rows[1] and np.isfinite(rows[0]).all()


@pytest.mark.parametrize("what", ["int8", "mesh", "gaussian"])
def test_trainer_refuses_what_is_not_ported(what, monkeypatch):
    """What the trainer still refuses: a mesh's model axis on a float
    decoder, JAX's GSPMD tensor-parallel path (M10b; the meshes of M10, the
    data-parallel and the pixel steps, are held to JAX in
    ``test_torch_port_spmd.py``); CTF (M7, now ported)
    with bf16 compute raises ``ValueError`` before any work, as the JAX
    trainer does at its first step, here in int8 mode with a measurement
    lever (K3 (g)) over MNIST's padded 28x28; gaussian: CTF without the
    image shape."""
    q_cfg, p_cfg = map(to_port, _cfgs())
    ecfg = ElboConfig(fused=True, channels=C, int8=what == "int8",
                      likelihood="gaussian" if what == "gaussian"
                      else "bernoulli")
    tcfg = TrainConfig(minibatch_size=B, augment_rotation=what == "augment",
                       image_shape=(N, M),
                       compute_dtype="bfloat16" if what == "int8"
                       else "float32")
    grid = coord_grid(N, M)
    if what == "int8":
        monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
        monkeypatch.setenv("SPATIALVAE_A1Q", "1")
        q_cfg = dataclasses.replace(q_cfg, n=28 * 28 * C)
        grid = coord_grid(28, 28)
    if what == "gaussian":
        tcfg = dataclasses.replace(tcfg, image_shape=None)
    expect = {"int8": (ValueError, "compute_dtype='float32'"),
              "gaussian": (ValueError, "image shape")}.get(
        what, (NotImplementedError, "ROADMAP M10b"))
    with pytest.raises(expect[0], match=expect[1]):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, rank=0,
                                     device=torch.device("cpu"))
        tr = Trainer(q_cfg, p_cfg, ecfg, tcfg, grid, device="cpu",
                     mesh=mesh if what == "mesh" else None)
        data = _Data(torch.zeros((B, grid.shape[0], C)))
        if what in ("gaussian", "int8"):
            data.ctf = torch.zeros((B, 3, 3))
        tr.train_epoch(data, 0)
