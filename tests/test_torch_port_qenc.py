"""The port's int8 encoder against the JAX package, on the CPU: the int8
linear layers (``qlinear``, ``qlinear_pre`` with a dynamic and a static
input scale, ``qlinear_pre_xq``) forward and backward, the encoder with its
Adam-emitted weight copies (``qw``) with and without the int8 data copy
(``y_q8``), ``inference_apply_q8``, and whole training steps of the TPU's
int8 stack (bf16 shadow + int8 encoder + the int8 data copy), plus the
wiring of an epoch.

Limits:

- int8 operands (xq, wq, gq), their scales and every int32 product are
  bit-equal to JAX's; the layers' outputs and gradients are within one
  ulp of their dtype, except the bias gradient, a float32 sum over the
  batch in another order than XLA's, held to that sum's rounding bound
  (2 b 2**-24 sum|g|) or one ulp;
- the encoder's first int8 layer output is bit-equal; z within 1e-6 of
  its largest value in float32 (measured 2.8e-7) and 2e-2 in bf16
  (measured 4.6e-3, 4.3e-3 and 9.3e-3 for tanh, tanh with resid and
  sigmoid): a full-precision bf16 layer rounds once in torch (the bias
  added inside the GEMM) where XLA rounds the product and the sum apart,
  and a bf16 ulp of a hidden activation can move its int8 value by one;
- whole steps: the limits of ``test_int8_training_matches_jax[bfloat16]``
  (step metrics 2e-2 relative; each master leaf 6 lr at most and 1e-5 on
  average; measured 1.7e-4 relative, 3.5e-4 and 1.8e-6), the shadow the
  same plus one bf16 ulp of the leaf (measured 4.9e-4); the moments on
  average within 1e-2 of each leaf's largest moment (measured 2.7e-3: the
  int8 gradients of the quantised layers flip where an upstream bf16 ulp
  crosses a rounding boundary, and every leaf's gradient follows); the
  int8 copies' scales within rtol 1e-3 (measured 6.2e-6) and q within
  max|p' - p'_JAX| / s + 1 (the masters' difference, in quantisation
  steps, and the rounding; measured 3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.models import inference_init
from spatialvae_tpu.models.inference import inference_apply as jax_inf
from spatialvae_tpu.models.inference import inference_apply_q8 as jax_inf_q8
from spatialvae_tpu.nn import qlinear as jql
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import optimizer_pallas as jax_pal
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import (
    inference_from_jax,
    load_named,
    state_from_jax,
)
from spatialvae_torch.kernels import adam as ka
from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.models import inference as inf
from spatialvae_torch.models.inference import inference_apply_q8
from spatialvae_torch.nn import qlinear as ql
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train import optimizer_fused as of
from spatialvae_torch.train import trainer as port_trainer
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

IN, OUT = 50, 36          # neither a multiple of 8: int_mm pads both
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


def _grid(a, dtype):
    """f32 numpy values on the dtype's grid."""
    return _t(a, dtype).float().numpy()


def _ulps(got, want, dtype):
    if dtype == "bfloat16":
        g = got.to(torch.bfloat16).view(torch.int16).long()
        w = want.to(torch.bfloat16).view(torch.int16).long()
    else:
        g = got.float().contiguous().view(torch.int32).long()
        w = want.float().contiguous().view(torch.int32).long()
    return int((g - w).abs().max())


def _layer_inputs(b, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _grid(np.tanh(rng.normal(size=(b, IN))), dtype)
    w = _grid(0.2 * rng.normal(size=(IN, OUT)), dtype)        # JAX layout
    bias = _grid(0.1 * rng.normal(size=OUT), dtype)
    g = _grid(rng.normal(size=(b, OUT)), dtype)
    return x, w, bias, g


def test_int8_operands_and_products_match_jax():
    rng = np.random.default_rng(0)
    for dtype in ("float32", "bfloat16"):
        x = _grid(rng.normal(size=(37, IN)), dtype)
        jq, js = jql._q(jnp.asarray(x, JDT[dtype]))
        q, s = ql.quantize_sym(_t(x, dtype))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        jq, js = jql._qx(jnp.asarray(np.tanh(x), JDT[dtype]), 1.0)
        q, s = ql.quantize_static(_t(np.tanh(x), dtype), 1.0)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
    a = rng.integers(-127, 128, (37, IN)).astype(np.int8)
    b = rng.integers(-127, 128, (IN, OUT)).astype(np.int8)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    for got in (ql.int_mm(torch.from_numpy(a), torch.from_numpy(b)),
                ql.int_mm(torch.from_numpy(a),
                          torch.from_numpy(b.T.copy()).t()),
                ql.int_mm(torch.from_numpy(a.T.copy()).t(),
                          torch.from_numpy(b))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n,layout,padded_n", [
    (5000, 64, 5000, "copy", 5008), (40, 112, 2504, "copy", 2512),
    (24, 16, 40, "copy", 48), (5000, 100, 5000, "copy", 5008),
    (5000, 128, 5000, "copy", 5008), (64, 64, 4096, "copy", 4096),
    (37, 40, 5000, "copy", 5008), (40, 112, 2504, "view", 2512),
    (24, 504, 40, "view", 48), (24, 512, 40, "view", 40),
    (24, 1024, 5000, "view", 5000), (24, 1024, 4096, "view", 4096)])
def test_int_mm_pads_n_where_the_card_refuses_it(m, k, n, layout, padded_n,
                                                 monkeypatch):
    """N of 8 mod 16 is padded to a multiple of 16 before the GEMM wherever
    b is copied anyway (``layout`` "copy": a row-major (K, N), as in every
    dW and dx) and, for a weight's free view ("view": the transpose of a
    row-major (N, K)), below N16_BELOW_K: the card's cuBLASLt refuses such
    an N against K a multiple of 16 below 128 (a batch of 64's dW); every
    other shape keeps its padding to 8; the product stays exact."""
    seen = []
    real = torch._int_mm

    def spy(x, y):
        seen.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)

    monkeypatch.setattr(torch, "_int_mm", spy)
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    tb = (torch.from_numpy(b) if layout == "copy"
          else torch.from_numpy(b.T.copy()).t())
    got = ql.int_mm(torch.from_numpy(a), tb)
    assert seen[0][1][1] == padded_n and seen[0][0][1] == seen[0][1][0]
    assert ql.padded_sizes(m, k, n, layout == "copy")[2] == padded_n
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64)
                                  @ b.astype(np.int64))


def _check_grads(got, want, dtype, what, g):
    """Every output within one ulp of its dtype; db, a float32 sum over
    the batch in another order, within that sum's rounding bound
    2 b 2**-24 sum|g| (then one bf16 ulp)."""
    for name, u, v in zip(("y", "dx", "dw", "db"), got, want):
        if u is None:
            continue
        v = _t(np.asarray(v, np.float32), dtype)
        assert u.dtype == TDT[dtype], (what, name, u.dtype)
        if name == "db":
            bound = 2 * g.shape[0] * 2.0 ** -24 * np.abs(g).sum(0)
            near = (u.float() - v.float()).abs().numpy() <= bound
            one = [_ulps(a, c, dtype) <= 1 for a, c in zip(u, v)]
            assert (near | np.array(one)).all(), (what, name)
            continue
        assert _ulps(u, v, dtype) <= 1, (what, name, _ulps(u, v, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [8, 37, 100])
def test_qlinear_family_matches_jax(b, dtype):
    x, w, bias, g = _layer_inputs(b, dtype, seed=b)
    jx, jw, jb, jg = (jnp.asarray(a, JDT[dtype]) for a in (x, w, bias, g))
    e = jax_pal.quantize_leaf(jnp.asarray(w), True)      # the f32 master's
    xe = jax_pal.quantize_leaf(jnp.asarray(x), True)     # the data copy

    def port(fn, *args, need_x=True):
        tx = _t(x, dtype).requires_grad_(need_x)
        tw = _t(w.T, dtype).requires_grad_()
        tb = _t(bias, dtype).requires_grad_()
        y = fn(tx, tw, tb, *args)
        y.backward(_t(g, dtype))
        return (y.detach(), tx.grad, None if tw.grad is None else tw.grad.T,
                tb.grad)

    y, vjp = jax.vjp(jql.qlinear, jx, jw, jb)
    _check_grads(port(ql.qlinear), (y,) + vjp(jg), dtype, "qlinear", g)
    wq = torch.from_numpy(np.asarray(e["q"]).T.copy())
    sw = torch.from_numpy(np.asarray(e["s"]))
    for bound in (None, 1.0):
        y, vjp = jax.vjp(lambda a, c, d: jql.qlinear_pre(
            a, c, d, e["q"], e["s"], bound), jx, jw, jb)
        _check_grads(port(ql.qlinear_pre, wq, sw, bound), (y,) + vjp(jg),
                     dtype, f"qlinear_pre bound={bound}", g)
    y, vjp = jax.vjp(lambda c, d: jql.qlinear_pre_xq(
        xe["q"], xe["s"], c, d, e["q"], e["s"]), jw, jb)
    xq = torch.from_numpy(np.asarray(xe["q"]))
    sx = torch.from_numpy(np.asarray(xe["s"]))
    tw = _t(w.T, dtype).requires_grad_()
    tb = _t(bias, dtype).requires_grad_()
    ty = ql.qlinear_pre_xq(xq, sx, tw, tb, wq, sw)
    ty.backward(_t(g, dtype))
    _check_grads((ty.detach(), None, tw.grad.T, tb.grad), (y, None) + vjp(jg),
                 dtype, "qlinear_pre_xq", g)


ENC_CASES = [("tanh", False), ("tanh", True), ("sigmoid", False)]


def _encoder(activation, resid, dtype, seed=0):
    cfg = InferenceConfig(n=IN * 2, latent_dim=5, hidden_dim=48,
                          num_layers=3, activation=activation, resid=resid)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        inference_init(jax.random.PRNGKey(seed), cfg))
    # the weights the loss differentiates: the compute-dtype shadow
    params = jax.tree_util.tree_map(lambda a: _grid(a, dtype), params)
    net = inference_from_jax(params, to_port(cfg)).to(TDT[dtype])
    return cfg, params, net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation,resid", ENC_CASES)
def test_encoder_with_int8_copies_matches_jax(activation, resid, dtype):
    """``InferenceNetwork.forward(y, qw, y_q8)`` against ``inference_apply``:
    the hidden layers on int8 with copies of every hidden weight but the
    last (which stays in full precision), with and without the data copy;
    its first layer's output is bit-equal."""
    cfg, params, net = _encoder(activation, resid, dtype)
    rng = np.random.default_rng(1)
    y = (rng.integers(0, 256, (12, cfg.n)) / 255.0).astype(np.float32)
    layers = params["layers"]
    jqw = [jax_pal.quantize_leaf(jnp.asarray(p["w"]), i < len(layers) - 2)
           for i, p in enumerate(layers[:-1])]
    qw = [{"q": torch.from_numpy(np.asarray(e["q"]).T.copy()),
           "s": torch.from_numpy(np.asarray(e["s"]))} for e in jqw]
    jx = jax_trainer._quantize_dataset(jnp.asarray(y))
    xq, sx = of.quantize_dataset(torch.from_numpy(y))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jx[0]))
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JDT[dtype]),
                                     params)
    for y_q8, jy_q8 in ((None, None), ((xq, sx), jx)):
        want = jax_inf(jparams, cfg, jnp.asarray(y, JDT[dtype]), qw=jqw,
                       y_q8=jy_q8)
        with torch.no_grad():
            got = net(_t(y, dtype), qw=qw, y_q8=y_q8)
        z_want = np.concatenate([np.asarray(w, np.float32) for w in want], 1)
        z_got = torch.cat(got, 1).float().numpy()
        d = np.abs(z_got - z_want).max() / np.abs(z_want).max()
        assert d <= (2e-2 if dtype == "bfloat16" else 1e-6), d
    # layer 0 on int8 alone: bit-equal
    w0 = jnp.asarray(layers[0]["w"], JDT[dtype])
    b0 = jnp.asarray(layers[0]["b"], JDT[dtype])
    lin = net.layers[0]
    with torch.no_grad():
        for got, want in (
                (ql.qlinear_pre_xq(xq, sx, lin.weight, lin.bias, qw[0]["q"],
                                   qw[0]["s"]),
                 jql.qlinear_pre_xq(jx[0], jx[1], w0, b0, jqw[0]["q"],
                                    jqw[0]["s"])),
                (ql.qlinear_pre(_t(y, dtype), lin.weight, lin.bias,
                                qw[0]["q"], qw[0]["s"]),
                 jql.qlinear_pre(jnp.asarray(y, JDT[dtype]), w0, b0,
                                 jqw[0]["q"], jqw[0]["s"]))):
            assert torch.equal(got, _t(np.asarray(want, np.float32), dtype))


def test_inference_apply_q8_matches_jax():
    cfg, params, net = _encoder("tanh", False, "float32")
    y = np.random.default_rng(2).uniform(0, 1, (8, cfg.n)).astype(np.float32)
    want = jax_inf_q8(jax.tree_util.tree_map(jnp.asarray, params), cfg,
                      jnp.asarray(y))
    with torch.no_grad():
        got = inference_apply_q8(net, torch.from_numpy(y))
    for u, v in zip(got, want):
        d = np.abs(u.numpy() - np.asarray(v)).max()
        assert d <= 1e-6 * np.abs(np.asarray(v)).max(), d


# ---------------------------------------------------------------------------
# whole steps of the TPU's int8 stack
# ---------------------------------------------------------------------------

N = M = 32
C, Z, B, IMAGES = 3, 3, 4, 11
LR = TrainConfig().learning_rate


def _step_cfgs():
    q_cfg = InferenceConfig(n=N * M * C, latent_dim=Z + 3, hidden_dim=128,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=64, n_out=C,
                                   num_layers=2)
    return q_cfg, p_cfg


def _stack_trainers():
    """A JAX trainer forced onto its TPU stack (bf16 shadow, int8 encoder,
    as ``tests/test_kernels_int8.py`` forces it) and a port trainer
    starting from the same seeded state through the bridge."""
    q_cfg, p_cfg = _step_cfgs()
    ekw = dict(fused=True, int8=True, channels=C)
    tkw = dict(minibatch_size=B, compute_dtype="bfloat16")
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw),
                             jax_trainer.TrainConfig(**tkw),
                             jnp.asarray(jax_grid(N, M)))
    jt.optimizer = jax_pal.fused_adam_pallas(LR, interpret=True)
    jt.state = jax_trainer.TrainState(jt.state.params,
                                      jt.optimizer.init(jt.state.params))
    jt._build_steps()
    jt._use_shadow = True
    jt._use_qenc = True
    state = jt._seeded_state()
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(**tkw), coord_grid(N, M), device="cpu")
    assert tr._use_shadow and tr._use_qenc
    port = state_from_jax(state, tr.q_net, tr.p_net)
    load_named(tr.q_net, tr.p_net, port["params"])
    tr.opt_state, tr.shadow, tr.qshadow = (port["opt_state"], port["shadow"],
                                           port["qshadow"])
    return jt, state, tr


def _images(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (IMAGES, N * M, C)) / 255.0
            ).astype(np.float32)


def _assert_state(tr, state):
    """The port's state against the JAX TrainState (see the module's
    limits)."""
    want = state_from_jax(state, tr.q_net, tr.p_net)
    got_p = tr.named_params()
    for k, w in want["params"].items():
        d = (got_p[k].detach() - w).abs()
        assert d.max() <= 6 * LR and d.mean() <= 1e-5, (k, d.max(), d.mean())
        sd = (tr.shadow[k].detach().float() - want["shadow"][k].float()).abs()
        assert tr.shadow[k].dtype == torch.bfloat16
        assert sd.max() <= 6 * LR + 2.0 ** -8 * w.abs().max(), k
        for got_m, want_m in ((tr.opt_state.mu[k], want["opt_state"].mu[k]),
                              (tr.opt_state.nu[k], want["opt_state"].nu[k])):
            dm = (got_m - want_m).abs()
            scale = float(want_m.abs().max()) or 1.0
            assert dm.mean() <= 1e-2 * scale, (k, dm.mean(), scale)
        e, we = tr.qshadow[k], want["qshadow"][k]
        assert e["q"].shape == we["q"].shape and e["q"].dtype == torch.int8
        if e["q"].numel():
            dq = (e["q"].int() - we["q"].int()).abs().max()
            assert dq <= d.max() / we["s"].reshape(()) + 1, (k, dq)
            for f in ("s", "ns"):
                np.testing.assert_allclose(e[f].numpy(), we[f].numpy(),
                                           rtol=1e-3)
    assert tr.opt_state.count == int(state.opt_state.count)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_int8_stack_steps_match_jax(engine, monkeypatch):
    """One even step (K3 + the int8 encoder reading the int8 data copy)
    and one odd tail step (K4/K5 + layer 0 through ``qlinear_pre`` with a
    dynamic scale), ``_QENC_MIN_ELEMS`` at 1 in both packages so every 2-D
    leaf gets its int8 copy; the state compared after each step."""
    monkeypatch.setenv("SPATIALVAE_ADAM_EMIT", engine)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    monkeypatch.setattr(jax_trainer, "_QENC_MIN_ELEMS", 1)
    monkeypatch.setattr(port_trainer, "_QENC_MIN_ELEMS", 1)
    jt, state, tr = _stack_trainers()
    y = _images()
    jdata_t = np.asarray(jt._dataset_yt(_Data(jnp.asarray(y))))
    jxq, jsx = jax_trainer._quantize_dataset(jnp.asarray(y))
    data_t = tr._dataset_yt(torch.from_numpy(y))
    xq, sx = tr._dataset_yq8(torch.from_numpy(y))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    rng = np.random.default_rng(5)
    for idx in (np.array([0, 3, 5, 9]), np.array([1, 2, 7])):
        noise = rng.normal(size=(len(idx), Z + 3)).astype(np.float32)
        even = len(idx) == B
        target, qq = jax_trainer.grad_target(state)
        (_, aux), grads = grad_fn(
            target, jnp.asarray(y[idx]), None, None, jnp.float32(1.0),
            y_t=jnp.asarray(jdata_t[idx]) if even else None, q_quant=qq,
            y_q8=(jxq[idx], jsx) if even else None, noise=jnp.asarray(noise))
        state = jax_trainer.apply_update(jt.optimizer, state, grads,
                                         jnp.bfloat16)
        ti = torch.from_numpy(idx)
        got = tr.train_step(torch.from_numpy(y[idx]),
                            y_t=data_t[ti] if even else None,
                            y_q8=(xq[ti], sx) if even else None,
                            noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=2e-2)
        _assert_state(tr, state)


def test_explicit_encoder_view_drops_the_data_copy():
    """As in the JAX ELBO, an encoder view other than y (``y_inf``, the
    augmented images) makes the int8 data copy of y not apply: the
    encoder quantises the view itself."""
    from spatialvae_torch.models import SpatialGenerator
    from spatialvae_torch.objectives import elbo_minibatch

    q_cfg, p_cfg = map(to_port, _step_cfgs())
    g = torch.Generator().manual_seed(0)
    q_net = inf.InferenceNetwork(q_cfg, generator=g)
    p_net = SpatialGenerator(p_cfg, generator=g)
    qw = [of.quantize_leaf(lin.weight, True) for lin in
          (q_net.layers[0], q_net.layers[2])]
    y = torch.from_numpy(_images()[:B])
    view = torch.flip(y, dims=(1,))
    xq, sx = of.quantize_dataset(y)
    noise = torch.randn((B, Z + 3), generator=g)
    ecfg = ElboConfig(channels=C)
    with torch.no_grad():
        def elbo(**kw):
            return elbo_minibatch(q_net, p_net, ecfg, coord_grid(N, M), y,
                                  noise=noise, q_quant=qw, **kw)[0]
        dropped = elbo(y_inf=view, y_q8=(xq, sx))
        assert torch.equal(dropped, elbo(y_inf=view))
        assert not torch.equal(dropped, elbo(y_q8=(xq, sx)))


class _Data:
    def __init__(self, y):
        self.y = y
        self.ctf = None

    def __len__(self):
        return self.y.shape[0]


def test_int8_stack_epoch_takes_the_int8_encoder(monkeypatch):
    """An epoch of 11 images at B=4 under bf16 compute and int8 mode, every
    2-D leaf above the (patched) threshold: the full batches run layer 0
    on the int8 data copy and layer 1 with the static tanh scale, then K3;
    the tail runs layer 0 with a dynamic scale, then K4/K5; each step ends
    in Adam with the fresh-scale emission of every 2-D leaf, and the
    evaluation reads the float32 masters without the int8 encoder."""
    monkeypatch.setattr(port_trainer, "_QENC_MIN_ELEMS", 1)
    q_cfg, p_cfg = map(to_port, _step_cfgs())
    tr = Trainer(q_cfg, p_cfg, ElboConfig(fused=True, int8=True, channels=C),
                 TrainConfig(minibatch_size=B, compute_dtype="bfloat16"),
                 coord_grid(N, M), device="cpu")
    calls = []
    for mod, name, tag in (
            (inf, "qlinear_pre_xq", "xq"), (inf, "qlinear_pre", "pre"),
            (l8, "loss_int8_reference", "K3"),
            (d8, "decoder_tail_int8_reference", "K4"),
            (d8, "decoder_tail_int8_backward_reference", "K5"),
            (ka, "adam_leaf_reference", "K6"),
            (ka, "quantize_reference", "quantize")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _t=tag, **kw:
                            calls.append((_t, a[-1] if _t == "pre" else None))
                            or _f(*a, **kw))
    data = _Data(torch.from_numpy(_images()))
    elbo, gen_loss, kl = tr.train_epoch(data, 0, progress=False)
    assert np.isfinite([elbo, gen_loss, kl]).all()
    leaves = tr.named_params().values()
    # the data copy, then the seeded int8 copy of each 2-D leaf
    seeding = [("quantize", None)] * (1 + sum(p.dim() == 2 for p in leaves))
    # the step: K6 on every leaf, then the fresh-scale copies of the 2-D
    # leaves (one pass over them)
    adam = [("K6", None)] * len(leaves) + [("quantize", None)] * sum(
        p.dim() == 2 for p in leaves)
    full = [("xq", None), ("pre", 1.0), ("K3", None)] + adam
    tail = [("pre", None), ("pre", 1.0), ("K4", None), ("K5", None)] + adam
    want = seeding + full + full + tail
    assert calls == want
    assert all(t.dtype == torch.bfloat16 and t.requires_grad
               for t in tr.shadow.values())
    assert tr.qshadow["q.layers.0.weight"]["q"].shape == (128, N * M * C)
    assert len(tr._yq8_cache) == 1
    calls.clear()
    tr.eval_epoch(data, 1)
    assert [c for c in calls if c[0] in ("xq", "pre", "K6")] == []
