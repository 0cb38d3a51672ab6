"""The port's mesh steps (``spatialvae_torch/parallel/spmd.py`` through
``Trainer(mesh=...)``) against the JAX package and the port's one-device
trainer, on the CPU: ranks joined over gloo (``tests/torch_ranks.py``, two
worlds of 2 and 4 ranks, one torch thread each; the ranks run the kernels'
plain versions), JAX on the suite's eight fake CPU devices with its
kernels in Pallas interpret mode.

- the data-parallel int8 step on a (2, 1) mesh, 32x32 RGB, B=4 (two
  images a rank through K3) and a replicated tail of 3 (K4/K5), the same
  weights and noise as the JAX single-device trainer: the metrics and the
  weights within the limits of ``test_torch_port_int8_train.py`` (Adam's
  first steps move a weight by about lr times the sign of its gradient, so
  a last-bit difference flips a near-zero gradient's step: 6 lr after
  three steps; measured 2.2e-4 relative on the metrics, 2.0e-4 / 1.8e-7
  on a leaf at most / on average); against the port's one-device steps
  (the two ranks' halves of each gradient averaged in float32): float32
  within 1e-6 relative on the metrics and 1e-7 / 1e-9 on a leaf (measured
  1.1e-7, 7.5e-9, 1.9e-11), bfloat16 within the JAX limits (its
  gradients round to bf16 before the average: measured 4.6e-3, 1.9e-4,
  4.3e-7); the ranks' masters, shadows and int8 copies bit for bit; the
  mesh's evaluation (noise drawn for the whole batch, sliced) against one
  device's on the same weights within 1e-6 relative (measured 0 / 4.2e-8);
- the pixel step on (1, 2) and (2, 2) meshes against the JAX
  ``make_spmd_pixel_step`` (``tests/test_spmd.py``'s setup: 64x32
  Bernoulli, two images replicated on every data index, the shard key
  held): the metrics within 1e-5 relative, the decoder's leaves within
  1e-5 relative / 1e-6 absolute, the encoder's first layer within 2 lr
  with fewer than 3% of its elements past 1e-6 (the JAX test's limits);
  every rank equal;
- epochs on a (2, 1) mesh: the int8 epoch's kernels (K3 on each rank's two
  rows, the tail of 3 whole through K4/K5 on every rank; the evaluation's
  K4 on two rows a rank and its odd tail whole), ``train_epochs`` equal to
  ``train_epoch`` calls, a streamed float epoch equal to the preloaded one,
  rank 0 alone writing checkpoints, every rank resuming from them to the
  uninterrupted run's numbers; a pixel mesh's streamed epoch running every
  batch whole on every rank (no K3); every state equal across ranks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core import config as jax_config
from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.parallel import MeshConfig as JaxMeshConfig
from spatialvae_tpu.parallel import create_mesh as jax_create_mesh
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from tests import torch_ranks
from tests.port_configs import one_torch_thread  # noqa: F401

N = M = 32
C, Z, B, IMAGES = 3, 3, 4, 11
LR = 1e-4
# compute dtype -> (step rtol, leaf max, leaf mean), as
# test_torch_port_int8_train.py holds one device to JAX
TOL = {"float32": (1e-3, 6 * LR, 1e-6), "bfloat16": (2e-2, 6 * LR, 1e-5)}
# the mesh against the port's one device, same limits' order
ONE_TOL = {"float32": (1e-6, 1e-7, 1e-9), "bfloat16": TOL["bfloat16"]}
PX_N, PX_M = 64, 32


@pytest.fixture(scope="module", autouse=True)
def _interpret():
    mp = pytest.MonkeyPatch()
    mp.setenv("SPATIALVAE_INTERPRET", "1")
    yield
    mp.undo()


def _spec(q_cfg, p_cfg, ecfg: dict, tcfg: dict, shape, params=None,
          mask=None) -> dict:
    return {"q_cfg": jax_config.config_to_dict(q_cfg),
            "p_cfg": jax_config.config_to_dict(p_cfg), "ecfg": ecfg,
            "tcfg": tcfg, "shape": shape, "params": params, "mask": mask}


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _int8_case():
    """The JAX trainer, the port spec with its weights, images, batches and
    noise (test_torch_port_int8_train's); the JAX trainer and its weights
    are float32's for both compute dtypes (the init does not depend on
    it)."""
    q_cfg = InferenceConfig(n=N * M * C, latent_dim=Z + 3, hidden_dim=128,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=64, n_out=C,
                                   num_layers=2)
    ekw = dict(fused=True, int8=True, channels=C)
    jt = jax_trainer.Trainer(
        q_cfg, p_cfg, JaxElboConfig(**ekw),
        jax_trainer.TrainConfig(minibatch_size=B),
        jnp.asarray(jax_grid(N, M)))
    spec = _spec(q_cfg, p_cfg, ekw, dict(minibatch_size=B), (N, M),
                 _numpy(jt.state.params))
    rng = np.random.default_rng(4)
    y = (rng.integers(0, 256, (IMAGES, N * M, C)) / 255.0).astype(np.float32)
    batches = [np.array([0, 3, 5, 9]), np.array([1, 2, 7, 10]),
               np.array([4, 6, 8])]
    rng = np.random.default_rng(5)
    noises = [rng.normal(size=(len(i), Z + 3)).astype(np.float32)
              for i in batches]
    return jt, spec, y, batches, noises


def _jax_steps(jt, y, batches, noises):
    class _Data:
        def __init__(self, y):
            self.y, self.ctf = y, None

        def __len__(self):
            return self.y.shape[0]

    data_t = np.asarray(jt._dataset_yt(_Data(jnp.asarray(y))))
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    state, auxes = jt.state, []
    for idx, noise in zip(batches, noises):
        y_t = data_t[idx] if len(idx) == B else None
        (_, aux), grads = grad_fn(
            state.params, jnp.asarray(y[idx]), None, None, jnp.float32(1.0),
            y_t=None if y_t is None else jnp.asarray(y_t),
            noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jt._compute_dtype)
        auxes.append(np.asarray(aux))
    return auxes, _numpy(state.params)


def _pixel_spec(data_ax: int, batch: int):
    q_cfg = InferenceConfig(n=PX_N * PX_M, latent_dim=5, hidden_dim=16,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=16, num_layers=2)
    ekw = dict(likelihood="bernoulli", theta_prior=float(np.pi), fused=True,
               int8=True)
    tkw = dict(minibatch_size=batch, num_epochs=1, seed=0,
               image_shape=(PX_N, PX_M))
    return q_cfg, p_cfg, ekw, tkw


def _jax_pixel(data_ax: int):
    """The JAX pixel step on a (data_ax, 2) mesh of fake CPU devices, two
    images replicated on every data index, the shard key held; returns the
    port spec, the images, the noise, JAX's metrics and parameters."""
    from spatialvae_tpu.parallel.spmd import make_spmd_pixel_step
    from spatialvae_tpu.train import TrainConfig, Trainer

    q_cfg, p_cfg, ekw, tkw = _pixel_spec(data_ax, 2 * data_ax)
    mesh = jax_create_mesh(JaxMeshConfig(data=data_ax, model=2))
    t = Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw), TrainConfig(**tkw),
                jax_grid(PX_N, PX_M), mesh=mesh)
    assert t._spmd_pixel
    hw = PX_N * PX_M
    y = jax.random.uniform(jax.random.PRNGKey(11), (2, hw))
    y_t = y.reshape(2, hw, 1).swapaxes(1, 2)
    key = jax.random.PRNGKey(4)
    params = _numpy(t.state.params)
    step = jax.jit(make_spmd_pixel_step(t, mesh,
                                        fold_shard_key=lambda k, i: k))
    state, m = step(t.state, jnp.tile(y, (data_ax, 1)), None, key,
                    jnp.asarray(1.0, jnp.float32),
                    jnp.tile(y_t, (data_ax, 1, 1)))
    noise = np.asarray(jax.random.normal(key, (2, 5), jnp.float32))
    spec = _spec(q_cfg, p_cfg, ekw, tkw, (PX_N, PX_M), params)
    return spec, np.asarray(y), noise, np.asarray(m), _numpy(state.params)


def _jax_dp_stack(batches, noises):
    """The JAX ``make_spmd_step`` on a (2, 1) mesh of fake CPU devices,
    forced onto its TPU stack as ``tests/test_spmd.py`` forces it (bf16
    shadow, the int8 encoder copies with ``_QENC_MIN_ELEMS`` at 1, the
    fused Adam in interpret mode), each device's noise its rows of the
    batch's; the full batches of ``batches`` alone (a tail takes the
    one-device step).  One channel: XLA's CPU backend refuses a bf16 x
    bf16 -> f32 product of the three-channel model's jitted step.  Returns
    the port spec with the same weights, the images, JAX's metrics and its
    state's masters and shadow (JAX layout)."""
    from spatialvae_tpu.parallel.spmd import make_spmd_step
    from spatialvae_tpu.train.optimizer_pallas import fused_adam_pallas

    q_cfg = InferenceConfig(n=N * M, latent_dim=Z + 3, hidden_dim=128,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=64,
                                   num_layers=2)
    ekw = dict(fused=True, int8=True)
    tkw = dict(minibatch_size=B, compute_dtype="bfloat16")
    y = (np.random.default_rng(6).integers(0, 256, (IMAGES, N * M)) / 255.0
         ).astype(np.float32)
    mesh = jax_create_mesh(JaxMeshConfig(data=2, model=1))
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw),
                             jax_trainer.TrainConfig(**tkw),
                             jnp.asarray(jax_grid(N, M)), mesh=mesh)
    jt.optimizer = fused_adam_pallas(LR, interpret=True)
    jt.state = jax_trainer.TrainState(jt.state.params,
                                      jt.optimizer.init(jt.state.params))
    jt._build_steps()
    assert jt._spmd and jt._use_shadow and jt._use_qenc
    spec = _spec(q_cfg, p_cfg, ekw, tkw, (N, M), _numpy(jt.state.params))

    class _Data:
        def __init__(self, y):
            self.y, self.ctf = y, None

        def __len__(self):
            return self.y.shape[0]

    def grads_only(optimizer, state, grads, compute_dtype):
        return state._replace(params=jax.tree_util.tree_map(
            lambda g: g.astype(jnp.float32), grads))

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_trainer, "_QENC_MIN_ELEMS", 1)
    try:
        state = jt._seeded_state()
        assert state.qshadow["q"]["layers"][0]["w"]["q"].size > 0
        data_t = np.asarray(jt._dataset_yt(_Data(jnp.asarray(y))))
        xq, sx = jax_trainer._quantize_dataset(jnp.asarray(y))
        loss, auxes = jt._loss, []
        # the first batch's gradients at the seeded state: the DP step's
        # (its update swapped for one that returns them) and one device's
        # on the whole batch
        idx, noise = batches[0], jnp.asarray(noises[0])
        mp.setattr(jax_trainer, "apply_update", grads_only)
        jt._loss = lambda *a, **kw: loss(*a, noise=jax.lax.dynamic_slice_in_dim(
            noise, jax.lax.axis_index("data") * (B // 2), B // 2), **kw)
        got = jax.jit(make_spmd_step(jt, mesh))(
            state, jnp.asarray(y[idx]), None, jax.random.PRNGKey(0),
            jnp.float32(1.0), y_t=jnp.asarray(data_t[idx]),
            y_q8=(xq[idx], sx))[0]
        mp.undo()
        mp.setattr(jax_trainer, "_QENC_MIN_ELEMS", 1)
        target, qq = jax_trainer.grad_target(state)

        def one_device(rows):
            i = idx[rows]
            return _numpy(jax.jit(jax.grad(lambda t: loss(
                t, jnp.asarray(y[i]), None, None, jnp.float32(1.0),
                y_t=jnp.asarray(data_t[i]), q_quant=qq, y_q8=(xq[i], sx),
                noise=noise[rows])[0]))(target))

        halves = [one_device(slice(k * B // 2, (k + 1) * B // 2))
                  for k in (0, 1)]
        grads = {"dp": _numpy(got.params), "whole": one_device(slice(None)),
                 "halves": jax.tree_util.tree_map(
                     lambda a, b: (a + b) / 2, *halves)}
        for idx, noise in zip(batches, noises):
            noise = jnp.asarray(noise)

            def noisy(*a, _noise=noise, **kw):
                i = jax.lax.axis_index("data")
                return loss(*a, noise=jax.lax.dynamic_slice_in_dim(
                    _noise, i * (B // 2), B // 2), **kw)

            jt._loss = noisy
            step = jax.jit(make_spmd_step(jt, mesh))
            state, aux = step(state, jnp.asarray(y[idx]), None,
                              jax.random.PRNGKey(0), jnp.float32(1.0),
                              y_t=jnp.asarray(data_t[idx]),
                              y_q8=(xq[idx], sx))
            auxes.append(np.asarray(aux))
    finally:
        jt._loss = loss
        mp.undo()
    return spec, y, auxes, {"params": _numpy(state.params),
                            "shadow": _numpy(state.shadow), **grads}


@pytest.fixture(scope="module")
def worlds():
    """Both worlds' results, and what the test process computed beside
    them (JAX's and the port's one-device numbers)."""
    jt, spec, y, batches, noises = _int8_case()
    bf16 = dict(spec, tcfg=dict(spec["tcfg"], compute_dtype="bfloat16"))
    cases = {"float32": (jt, spec, y, batches, noises),
             "bfloat16": (jt, bf16, y, batches, noises),
             "jax": _jax_steps(jt, y, batches, noises)}
    px = {d: _jax_pixel(d) for d in (1, 2)}
    full = ([batches[i] for i in range(len(batches)) if len(batches[i]) == B],
            [noises[i] for i in range(len(batches)) if len(batches[i]) == B])
    stack = _jax_dp_stack(*full)
    q_cfg, p_cfg, ekw, tkw = _pixel_spec(1, 2)
    pixel_stream = _spec(q_cfg, p_cfg, ekw, dict(tkw, minibatch_size=4),
                         (PX_N, PX_M))
    float_spec = dict(cases["float32"][1],
                      ecfg=dict(fused=True, int8=False, channels=C))
    y_px = np.random.default_rng(2).random((10, PX_N * PX_M, 1),
                                           np.float32)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        two = torch_ranks.spawn(torch_ranks.many, 2, [
            *[("dp_int8", cases[d][1:]) for d in ("float32", "bfloat16")],
            ("pixel_step", (px[1][0], 2, px[1][1], px[1][2])),
            ("epochs", (cases["float32"][1], float_spec, pixel_stream,
                        cases["float32"][2], y_px, tmp)),
            ("dp_int8_stack", (*stack[:2], *full))])
    four = torch_ranks.spawn(torch_ranks.many, 4, [
        ("pixel_step", (px[2][0], 2, px[2][1], px[2][2]))])
    return {"cases": cases, "px": px, "stack": stack, "stack_batches": full,
            "two": two, "four": four}


def _assert_trees(got, want, max_abs, mean_abs):
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(g, w):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert d.max() <= max_abs and d.mean() <= mean_abs, (
            a.shape, d.max(), d.mean())


def _assert_ranks_equal(results):
    for r in results[1:]:
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(a, b), r, results[0])


def test_dp_step_matches_jax_single_device(worlds):
    """Two ranks, each on its two rows of every batch, against the JAX
    single-device step on the whole batch with the same noise (float32
    compute; bf16 compute is held to the port's one device, which
    test_torch_port_int8_train.py holds to JAX)."""
    mesh = worlds["two"][0][0]
    auxes, params = worlds["cases"]["jax"]
    rtol, leaf_max, leaf_mean = TOL["float32"]
    for got, want in zip(mesh["aux"], auxes):
        np.testing.assert_allclose(got, want, rtol=rtol)
    _assert_trees(mesh["params"], params, leaf_max, leaf_mean)


def _leaf_gaps(got, want) -> dict:
    """leaf path -> (max, mean) |got - want| over the leaf's largest |want|."""
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        d = np.abs(np.asarray(a) - np.asarray(b)) / (np.abs(b).max() or 1.0)
        out[jax.tree_util.keystr(path)] = (d.max(), d.mean())
    return out


def test_dp_int8_stack_matches_jax_spmd_step(worlds, monkeypatch):
    """Two ranks in bf16 compute with the bf16 shadow and the int8 encoder
    copies against the JAX ``make_spmd_step`` on a (2, 1) mesh with the same
    stack, weights and noise.

    Both packages quantise the encoder's cotangent over a device's own
    rows, so a DP gradient is the mean of the two halves' one-device
    gradients, not the whole batch's: the port's bit for bit; JAX's, for
    the encoder's two weights, within 5e-4 of the leaf's largest value on
    average (measured 2.0e-4 and 2.1e-4; its jitted halves round bf16 in
    another order) and more than 1e-3 from the whole batch's (measured
    2.1e-3 and 1.4e-3).  Two steps: the metrics and the masters within the bf16
    limits of ``test_torch_port_qenc.py``, the shadow within them plus a
    bf16 ulp of the leaf; the ranks bit for bit."""
    from spatialvae_torch.io.jax_params import named_to_jax
    from spatialvae_torch.train import trainer as port_trainer

    spec, y, auxes, want = worlds["stack"]
    ranks = [w[4] for w in worlds["two"]]
    assert any("q" in e for e in ranks[0]["qshadow"].values())
    _assert_ranks_equal(ranks)

    # the semantics: JAX's DP gradient of the encoder's weights is its
    # halves' mean, not the whole batch's
    dp = _leaf_gaps(want["dp"], want["halves"])
    whole = _leaf_gaps(want["whole"], want["halves"])
    for leaf in ("['q']['layers'][0]['w']", "['q']['layers'][1]['w']"):
        assert dp[leaf][1] <= 5e-4 < 1e-3 < whole[leaf][1], (dp, whole)
    # and the port's, bit for bit
    monkeypatch.setattr(port_trainer, "_QENC_MIN_ELEMS", 1)
    one = torch_ranks.trainer(spec)
    batches, noises = worlds["stack_batches"]
    yt = torch.from_numpy(y)
    data_t, (xq, sx) = one._dataset_yt(yt), one._dataset_yq8(yt)
    halves = []
    for k in (0, 1):
        rows = slice(k * B // 2, (k + 1) * B // 2)
        i = torch.as_tensor(batches[0])[rows]
        halves.append(one.local_gradients(
            yt[i], y_t=data_t[i], y_q8=(xq[i], sx),
            noise=torch.from_numpy(noises[0][rows]))[1])
    mean = {k: ((halves[0][k].float() + halves[1][k].float()) / 2).to(
        halves[0][k].dtype) for k in halves[0]}
    jax.tree_util.tree_map(np.testing.assert_array_equal, ranks[0]["grads"],
                           named_to_jax(one.q_net, one.p_net, mean))

    rtol, leaf_max, leaf_mean = TOL["bfloat16"]
    assert len(ranks[0]["aux"]) == len(auxes) == 2
    for got, w in zip(ranks[0]["aux"], auxes):
        np.testing.assert_allclose(got, w, rtol=rtol)
    _assert_trees(ranks[0]["params"], want["params"], leaf_max, leaf_mean)
    got, gdef = jax.tree_util.tree_flatten(ranks[0]["shadow_jax"])
    shadow, wdef = jax.tree_util.tree_flatten(want["shadow"])
    assert gdef == wdef
    for a, w in zip(got, shadow):
        assert np.abs(a - w).max() <= leaf_max + 2.0 ** -8 * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_step_matches_the_ports_one_device_step(worlds, dtype):
    _, spec, y, batches, noises = worlds["cases"][dtype]
    mesh = worlds["two"][0][0 if dtype == "float32" else 1]
    one = torch_ranks.trainer(spec)
    auxes = torch_ranks.steps(one, y, batches, noises)
    rtol, leaf_max, leaf_mean = ONE_TOL[dtype]
    for got, want in zip(mesh["aux"], auxes):
        np.testing.assert_allclose(got, want, rtol=rtol)
    _assert_trees(mesh["params"], torch_ranks.state(one)["params"],
                  leaf_max, leaf_mean)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_ranks_hold_the_same_state(worlds, dtype):
    """Masters, bf16 shadow and int8 copies (bf16 compute), metrics and
    evaluation: bit for bit on both ranks."""
    at = 0 if dtype == "float32" else 1
    ranks = [w[at] for w in worlds["two"]]
    if dtype == "bfloat16":
        assert ranks[0]["shadow"] and ranks[0]["qshadow"]
    _assert_ranks_equal(ranks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_evaluation_matches_one_device(worlds, dtype):
    """The mesh's evaluation (each batch's noise drawn whole and sliced;
    the odd tail whole on each rank) against one device's, on the weights
    the mesh trained."""
    _, spec, y, _, _ = worlds["cases"][dtype]
    mesh = worlds["two"][0][0 if dtype == "float32" else 1]
    one = torch_ranks.trainer(dict(spec, params=mesh["params"]))
    want = one.eval_epoch(torch.from_numpy(y), 0)
    np.testing.assert_allclose(mesh["eval"], want, rtol=1e-6)


@pytest.mark.parametrize("data_ax", [1, 2])
def test_pixel_step_matches_jax(worlds, data_ax):
    spec, y, noise, m, params = worlds["px"][data_ax]
    ranks = ([w[2] for w in worlds["two"]] if data_ax == 1
             else [w[0] for w in worlds["four"]])
    _assert_ranks_equal(ranks)
    got = ranks[0]
    np.testing.assert_allclose(got["aux"], m, rtol=1e-5, atol=1e-6)
    for path in (("p", "coord", "w"), ("p", "latent", "w"),
                 ("p", "layers", 0, "w"), ("p", "layers", 1, "w")):
        a, r = got["params"], params
        for k in path:
            a, r = a[k], r[k]
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6)
    d = np.abs(got["params"]["q"]["layers"][0]["w"]
               - params["q"]["layers"][0]["w"])
    assert d.max() <= 2.0 * LR + 1e-6
    assert (d > 1e-6).mean() < 0.03


def test_dp_epoch_routes_rows_and_the_tail(worlds):
    """An int8 epoch of 11 images at B=4 on two ranks: K3 on each rank's
    two rows of both full batches, the tail of 3 whole through K4 and K5
    on every rank; the evaluation's K4 on two rows a rank, its tail of 3
    whole; the ranks' states and metrics equal."""
    ranks = [w[3] for w in worlds["two"]]
    for r in ranks:
        assert r["int8_calls"] == [("K3", 2), ("K3", 2), ("K4", 3),
                                   ("K5", 3)]
        assert r["eval_calls"] == [("K4", 2), ("K4", 2), ("K4", 3)]
        assert np.isfinite(r["int8_epoch"]).all()
    _assert_ranks_equal([r["int8_state"] for r in ranks])
    assert ranks[0]["int8_eval"] == ranks[1]["int8_eval"]


def test_train_epochs_is_train_epoch_in_turn(worlds):
    r = worlds["two"][0][3]
    np.testing.assert_array_equal(np.asarray(r["multi"]),
                                  np.asarray(r["seq"]))


def test_streamed_dp_epochs_are_the_preloaded_ones(worlds):
    """A host-resident dataset stages each rank's rows alone; the float
    epochs are the preloaded ones bit for bit."""
    for w in worlds["two"]:
        assert w[3]["streamed"] == w[3]["preloaded"]


def test_rank_zero_writes_and_every_rank_resumes(worlds):
    """Both ranks called the checkpoint writers; rank 0's files alone
    exist.  Both ranks resumed from them at epoch 2 and trained it to the
    uninterrupted run's numbers, bit for bit, and to the same state."""
    ranks = [w[3] for w in worlds["two"]]
    for r in ranks:
        assert r["files"] == ["r0_generator.sav", "r0_inference.sav",
                              "r0_optimizer.sav"]
        assert r["resume_start"] == 2
        assert r["resumed"] == r["continued"]
    _assert_ranks_equal([r["float_state"] for r in ranks])


def test_pixel_mesh_streams_batches_whole(worlds):
    """Under the pixel step a streamed batch has no target copy: every
    batch (two of 4, and the tail of 2) trains whole on every rank through
    the int8 decoder (K4/K5), never K3; the ranks stay equal."""
    ranks = [w[3] for w in worlds["two"]]
    for r in ranks:
        assert r["pixel_streamed_calls"] == [("K4", 4), ("K5", 4)] * 2 + [
            ("K4", 2), ("K5", 2)]
        assert np.isfinite(r["pixel_streamed"]).all()
    _assert_ranks_equal([r["pixel_state"] for r in ranks])
