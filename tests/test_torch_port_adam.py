"""The port's Adam with its shadow and int8 emission against the JAX package's
``fused_adam_pallas(lr, interpret=True)``, on the CPU (the port runs the
plain versions of K6, K7 and the emission helpers here; the kernels are
held to them on the card by ``test_torch_port_cuda.py``).

JAX runs as its own tests run it: ``SPATIALVAE_PALLAS_ADAM=1``, so its K6
runs in Pallas interpret mode on the leaf of at least 1 Mi elements, and
its K7 under ``SPATIALVAE_ADAM_EMIT=pallas``.  Leaves are JAX-shaped
(fan_in, fan_out); the port gets each 2-D one transposed, as an
``nn.Linear`` weight holds it, so the K7 gate must read the transpose: the
(13, 16) leaf's 13 rows have no block of 8 and send it to the fresh-scale
path under both engines, the (1024, 1024) and (64, 300) leaves to K7.

JAX's Pallas kernels, run in interpret mode, execute their body as one XLA
CPU fusion, and XLA contracts b1*m + (1-b1)*g there into fused
multiply-adds; its op-by-op path (``adam_leaf``, eager) rounds every
operation, as the CUDA kernels do (``__fmul_rn``/``__fadd_rn``) and the
port's plain versions do.  Measured over three steps on the (1024, 1024)
leaf: JAX's kernel against its own op-by-op path differs by up to 1.6e5
ulps in m' where m' nearly cancels, 2 in v', 256 in p', while the port
matches the op-by-op path bit for bit.  So:

- on leaves that JAX's kernels take, outputs are held at the limits JAX's
  own test puts between its kernel and its op-by-op path
  (``test_optimizer_pallas``: rtol 1e-6, atol 1e-7 for p' and m', 1e-8
  for v'); bf16 moments within (step + 1) * 2**-8 of the leaf's largest
  moment after step ``step`` (a contracted m' can round to the other bf16
  neighbour, and the flip carries on, undamped where later steps cancel),
  and p' within
  (step + 1) * lr * 2**-7 (a bf16 ulp of m' moves a step's update, at most
  about lr, by 2**-8 of itself; measured 4.3e-6 after three steps at lr
  1e-3, against 2.3e-5); every output
  of the other leaves at 1 ulp of its dtype (measured: bit-equal);
- the shadow, q, s and ns are bit-equal wherever p' is; where p' is not,
  the shadow is bf16 of the port's p', q moves by at most 1, and 127 s
  (127 ns) by no more than the largest difference in p';
- ``test_update_apply_is_jax_op_by_op`` runs JAX without its kernels and
  holds every output of every leaf bit-equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.train import optimizer as jax_opt
from spatialvae_tpu.train import optimizer_pallas as jax_pal

from spatialvae_torch import checkpoint
from spatialvae_torch.kernels import adam as ka
from spatialvae_torch.kernels import config as kcfg
from spatialvae_torch.train import optimizer_fused as of
from spatialvae_torch.train.optimizer import fused_adam
from tests.port_configs import one_torch_thread  # noqa: F401

LR = 1e-3
SHAPES = {"big": (1024, 1024), "w64": (64, 300), "w13": (13, 16),
          "b": (16,)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _port(a, dtype=torch.float32):
    """A JAX leaf as the port holds it: 2-D transposed."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return (t.T.contiguous() if t.dim() == 2 else t).to(dtype)


def _ulps(got, want, dtype):
    """|got - want| in ulps of dtype (float32 or bfloat16), elementwise."""
    if dtype == torch.bfloat16:
        g = got.to(torch.bfloat16).view(torch.int16).long()
        w = want.to(torch.bfloat16).view(torch.int16).long()
    else:
        g = got.float().view(torch.int32).long()
        w = want.float().view(torch.int32).long()
    return (g - w).abs()


def _params(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()}


CASES = [
    # engine, moments, shadow (with the int8 emission at quant_min_elems=1)
    ("xla", "f32", False),
    ("xla", "bf16", False),
    ("xla", "f32", True),
    ("xla", "bf16", True),
    ("pallas", "f32", True),
    ("pallas", "bf16", True),
]
# JAX's limits between its kernels and its op-by-op path (p', m', v')
KERNEL_TOL = {"p": (1e-6, 1e-7), "m": (1e-6, 1e-7), "v": (1e-6, 1e-8)}


def _jax_kernel_leaves(engine, moments, shadow):
    """The leaves JAX sends to a Pallas kernel under PALLAS_ADAM=1."""
    if engine == "pallas" and shadow:
        return {"big", "w64"}                                   # K7
    return {"big"} if moments == "f32" else set()               # K6


def _run(engine, moments, shadow, monkeypatch, pallas_adam):
    monkeypatch.setenv("SPATIALVAE_PALLAS_ADAM", pallas_adam)
    monkeypatch.setenv("SPATIALVAE_ADAM_MOMENTS", moments)
    monkeypatch.setenv("SPATIALVAE_ADAM_EMIT", engine)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    mdt = torch.bfloat16 if moments == "bf16" else torch.float32
    gdt = torch.bfloat16 if shadow else torch.float32
    np_params = _params(0)
    pal = jax_pal.fused_adam_pallas(LR, interpret=True)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    js = pal.init(jp)
    jq = (jax.tree_util.tree_map(
        lambda p: jax_pal.quantize_leaf(p, p.ndim == 2), jp)
        if shadow else None)
    opt = of.fused_adam_pallas(LR)
    tp = {k: _port(v) for k, v in np_params.items()}
    ts = opt.init(tp)
    assert all(m.dtype == mdt for m in ts.mu.values())
    tsh = {k: v.to(torch.bfloat16) for k, v in tp.items()} if shadow else None
    tq = ({k: of.quantize_leaf(v, v.dim() == 2) for k, v in tp.items()}
          if shadow else None)
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jg = {k: jnp.asarray(v, JDT[gdt]) for k, v in grads.items()}
        tg = {k: _port(v, gdt) for k, v in grads.items()}
        jsh = None
        if shadow:
            jp, js, jsh, jq = pal.update_apply(
                jg, js, jp, shadow_dtype=jnp.bfloat16, quant_min_elems=1,
                prev_quant=jq)
            ts, tq = opt.update_apply(tg, ts, tp, shadow=tsh,
                                      quant_min_elems=1, prev_quant=tq)
        else:
            jp, js = pal.update_apply(jg, js, jp)
            ts = opt.update_apply(tg, ts, tp)
        assert ts.count == int(js.count) == step + 1
        yield step, mdt, (tp, ts, tsh, tq), (jp, js, jsh, jq)


@pytest.mark.parametrize("engine,moments,shadow", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_update_apply_matches_jax(engine, moments, shadow, monkeypatch):
    kernel_leaves = _jax_kernel_leaves(engine, moments, shadow)
    for step, mdt, port, jax_ in _run(engine, moments, shadow, monkeypatch,
                                      "1"):
        tp, ts, tsh, tq = port
        jp, js, jsh, jq = jax_
        for k in SHAPES:
            p_equal = True
            for what, got, want, dt in (("p", tp[k], jp[k], torch.float32),
                                        ("m", ts.mu[k], js.mu[k], mdt),
                                        ("v", ts.nu[k], js.nu[k], mdt)):
                assert got.dtype == dt
                want = _port(want, dt)
                if k in kernel_leaves and dt == torch.bfloat16:
                    d = (got.float() - want.float()).abs().max()
                    lim = (step + 1) * 2.0 ** -8 * want.float().abs().max()
                    assert d <= lim, (k, what, step, float(d), float(lim))
                elif k in kernel_leaves:
                    rtol, atol = KERNEL_TOL[what]
                    if mdt == torch.bfloat16:
                        atol = (step + 1) * LR * 2.0 ** -7
                    np.testing.assert_allclose(got.numpy(), want.numpy(),
                                               rtol=rtol, atol=atol)
                else:
                    u = _ulps(got, want, dt)
                    assert u.max() <= 1, (k, what, step, int(u.max()))
                p_equal = p_equal and torch.equal(got, want)
            if not shadow:
                continue
            q_want = _port(jq[k]["q"]).to(torch.int8)
            sh_want = _port(jsh[k], torch.bfloat16)
            assert tsh[k].dtype == torch.bfloat16
            assert tq[k]["q"].shape == q_want.shape
            if p_equal:
                assert torch.equal(tsh[k], sh_want), (k, step)
                assert torch.equal(tq[k]["q"], q_want), (k, step)
                for f in ("s", "ns"):
                    assert torch.equal(tq[k][f], _port(jq[k][f])), (k, f)
            else:
                # the copies are the port's own p' rounded; against JAX's
                # they move with p' (the scales by its largest element)
                assert torch.equal(tsh[k], tp[k].to(torch.bfloat16))
                assert (tq[k]["q"].int() - q_want.int()).abs().max() <= 1
                d_p = (tp[k] - _port(jp[k])).abs().max()
                for f in ("s", "ns"):
                    d = (tq[k][f] - _port(jq[k][f])).abs().max() * 127
                    assert d <= d_p * 1.001, (k, f, float(d), float(d_p))


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_update_apply_is_jax_op_by_op(moments, monkeypatch):
    """Without JAX's Pallas kernels (its op-by-op path), every output of
    every leaf is bit-equal over three steps: m', v', p', the shadow and
    the fresh-scale q, s, ns."""
    for step, mdt, port, jax_ in _run("xla", moments, True, monkeypatch,
                                      "0"):
        tp, ts, tsh, tq = port
        jp, js, jsh, jq = jax_
        for k in SHAPES:
            for got, want, dt in ((tp[k], jp[k], torch.float32),
                                  (ts.mu[k], js.mu[k], mdt),
                                  (ts.nu[k], js.nu[k], mdt),
                                  (tsh[k], jsh[k], torch.bfloat16)):
                assert torch.equal(got, _port(want, dt)), (k, step)
            assert torch.equal(tq[k]["q"], _port(jq[k]["q"]).to(torch.int8))
            for f in ("s", "ns"):
                assert torch.equal(tq[k][f], _port(jq[k][f]))


def test_emit_engine_takes_k7_where_jax_does(monkeypatch):
    """Under ``pallas`` the (1024, 1024) and (64, 300) leaves take K7 (the
    carried scale: their entry's s is the previous ns object) and the
    (13, 16) leaf, read in JAX's orientation, the fresh-scale path."""
    monkeypatch.setenv("SPATIALVAE_ADAM_EMIT", "pallas")
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    seen = []
    for name in ("adam_emit_reference", "adam_leaf_reference"):
        fn = getattr(ka, name)
        monkeypatch.setattr(ka, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.append((_n, tuple(a[0].shape)))
                            or _f(*a, **kw))
    opt = of.fused_adam_pallas(LR)
    tp = {k: _port(v) for k, v in _params(2).items()}
    ts = opt.init(tp)
    tsh = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    prev = {k: of.quantize_leaf(v, v.dim() == 2) for k, v in tp.items()}
    grads = {k: torch.full_like(v, 0.01) for k, v in tp.items()}
    _, q = opt.update_apply(grads, ts, tp, shadow=tsh, quant_min_elems=1,
                            prev_quant=prev)
    # K7's plain version runs K6's inside it
    assert seen == [("adam_emit_reference", (1024, 1024)),
                    ("adam_leaf_reference", (1024, 1024)),
                    ("adam_emit_reference", (300, 64)),
                    ("adam_leaf_reference", (300, 64)),
                    ("adam_leaf_reference", (16, 13)),
                    ("adam_leaf_reference", (16,))]
    assert q["big"]["s"] is prev["big"]["ns"]
    assert q["w13"]["s"] is not prev["w13"]["ns"]
    assert q["b"]["q"].shape == (0, 0)


@pytest.mark.parametrize("on", [True, False])
def test_quantize_leaf_matches_jax(on):
    rng = np.random.default_rng(3)
    p = rng.normal(size=(70, 33)).astype(np.float32)
    want = jax_pal.quantize_leaf(jnp.asarray(p), on)
    got = of.quantize_leaf(torch.from_numpy(p), on)
    assert got["q"].dtype == torch.int8 and got["s"].shape == (1, 1)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    for f in ("s", "ns"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))
    assert got["s"] is not got["ns"]


@pytest.mark.parametrize("rows", [4, 11, 64])
def test_quantize_dataset_matches_jax(rows):
    """The per-dataset copy (its abs-max folded in chunks of ``rows``
    images) is JAX's one-pass ``_quantize_dataset`` bit for bit, whatever
    the chunk."""
    from spatialvae_tpu.train.trainer import _quantize_dataset

    rng = np.random.default_rng(4)
    y = (rng.integers(0, 256, (29, 64, 3)) / 255.0).astype(np.float32)
    wq, ws = _quantize_dataset(jnp.asarray(y))
    xq, sx = of.quantize_dataset(torch.from_numpy(y), rows=rows)
    assert xq.shape == (29, 192) and xq.dtype == torch.int8
    np.testing.assert_array_equal(xq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(ws))


@pytest.mark.parametrize("r,c", [(12288, 5000), (5000, 5000), (13, 16),
                                 (64, 300), (1024, 1024), (8, 9), (7, 7),
                                 (4096, 1)])
@pytest.mark.parametrize("g,m", [(torch.float32, torch.float32),
                                 (torch.bfloat16, torch.float32),
                                 (torch.bfloat16, torch.bfloat16)])
def test_emit_block_rows_matches_jax(r, c, g, m):
    assert of.emit_block_rows(r, c, g, m) == jax_pal._emit_block_rows(
        r, c, jnp.dtype(JDT[g]), jnp.dtype(JDT[m]))


def test_galaxy_weights_pass_the_k7_gate():
    """Both big galaxy encoder weights, (5000, 12288) and (5000, 5000) as
    nn.Linear holds them, qualify for K7 at the production threshold."""
    from spatialvae_torch.train.trainer import _QENC_MIN_ELEMS

    for shape in ((5000, 12288), (5000, 5000)):
        p = torch.empty(shape, device="meta")
        for g, m in ((torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
            assert of._k7_gate(p, p.to(g), p.to(m), _QENC_MIN_ELEMS)
    assert not of._k7_gate(torch.empty((500, 500), device="meta"),
                           torch.empty((500, 500), device="meta"),
                           torch.empty((500, 500), device="meta"),
                           _QENC_MIN_ELEMS)


def test_fused_adam_bf16_grads_match_jax():
    """K6's plain version widens bf16 gradients as JAX's ``adam_leaf``."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(40, 24)).astype(np.float32)
    g = (0.01 * rng.normal(size=(40, 24))).astype(np.float32)
    base = jax_opt.fused_adam(1e-4)
    js = base.init({"w": jnp.asarray(p)})
    upd, js = base.update({"w": jnp.asarray(g, jnp.bfloat16)}, js)
    want = np.asarray(jnp.asarray(p) + upd["w"])
    opt = fused_adam(1e-4)
    tp = {"w": torch.from_numpy(p.copy())}
    ts = opt.init(tp)
    opt.update_apply({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp)
    np.testing.assert_array_max_ulp(tp["w"].numpy(), want, maxulp=1)


def test_knobs(monkeypatch):
    """ADAM_EMIT: xla or pallas, pallas only with ALLOW_KNOBS; MOMENTS: f32
    or bf16, which sets the moments' dtype."""
    for v in ("xla", "pallas", "fused"):
        monkeypatch.setenv("SPATIALVAE_ADAM_EMIT", v)
        monkeypatch.delenv("SPATIALVAE_ALLOW_KNOBS", raising=False)
        if v == "xla":
            assert kcfg.adam_emit() == "xla"
        else:
            with pytest.raises(ValueError if v == "fused" else RuntimeError):
                kcfg.adam_emit()
        monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
        if v == "fused":
            with pytest.raises(ValueError):
                kcfg.adam_emit()
        else:
            assert kcfg.adam_emit() == v
    for v, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                  ("fp16", None)):
        monkeypatch.setenv("SPATIALVAE_ADAM_MOMENTS", v)
        if dt is None:
            with pytest.raises(ValueError):
                fused_adam(1e-3).init({"w": torch.zeros(3)})
        else:
            assert fused_adam(1e-3).init({"w": torch.zeros(3)}).mu["w"] \
                .dtype == dt


def test_bf16_moment_checkpoints_cross_packages(tmp_path, monkeypatch):
    """M9c-2: a port state with bf16 moments is written in the JAX
    package's form and read by the JAX ``load_optimizer`` as bf16 arrays of
    the same bits; a JAX-written bf16 file reads back in the port to the
    same bits (once more without ``jax`` or ``ml_dtypes`` in
    ``test_torch_port_ckpt_bf16.py``)."""
    import ml_dtypes

    from spatialvae_tpu.core.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_tpu.train import checkpoint as jax_ckpt

    from spatialvae_torch.io.jax_params import leaf_paths
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
    from tests.port_configs import to_port

    monkeypatch.setenv("SPATIALVAE_ADAM_MOMENTS", "bf16")
    q_cfg = InferenceConfig(n=16, latent_dim=3, hidden_dim=8, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=1, hidden_dim=8, n_out=1,
                                   num_layers=2)
    g = torch.Generator().manual_seed(0)
    q_net = InferenceNetwork(to_port(q_cfg), generator=g)
    p_net = SpatialGenerator(to_port(p_cfg), generator=g)
    params = {f"{k}.{n}": t for k, net in (("q", q_net), ("p", p_net))
              for n, t in net.named_parameters()}
    state = fused_adam(1e-3).init(params)
    state.mu = {k: torch.randn(v.shape, generator=g).to(torch.bfloat16)
                for k, v in state.mu.items()}
    state.nu = {k: torch.rand(v.shape, generator=g).to(torch.bfloat16)
                for k, v in state.nu.items()}
    state.count = 3
    path = str(tmp_path / "port.sav")
    checkpoint.save_optimizer(path, state, 1, q_net, p_net)
    js, epoch = jax_ckpt.load_optimizer(path)
    assert epoch == 1 and int(js.count) == 3
    paths = leaf_paths(q_net, p_net)

    def leaf(tree, path, perm):
        for k in path:
            tree = tree[k]
        a = np.asarray(tree)
        assert a.dtype == ml_dtypes.bfloat16
        a = a.view(np.uint16)
        return a if perm is None else a.transpose(perm)

    def bits(t):
        return t.view(torch.int16).numpy().view(np.uint16)

    for m in ("mu", "nu"):
        for name, (path_, perm) in paths.items():
            assert np.array_equal(leaf(getattr(js, m), path_, perm),
                                  bits(getattr(state, m)[name])), name
    # and back: the JAX package writes the state it read, the port reads it
    back = str(tmp_path / "jax.sav")
    jax_ckpt.save_optimizer(back, js, 2)
    got, epoch = checkpoint.load_optimizer(back, q_net, p_net)
    assert epoch == 2 and got.count == 3
    for m in ("mu", "nu"):
        for name in paths:
            t = getattr(got, m)[name]
            assert t.dtype == torch.bfloat16
            assert np.array_equal(bits(t), bits(getattr(state, m)[name]))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p = torch.zeros(8)
    for kw in (dict(g=torch.zeros(8, dtype=torch.float16)),
               dict(m=torch.zeros(8, dtype=torch.bfloat16)),
               dict(g=torch.zeros(9)),
               dict(shadow=torch.zeros(8)),
               dict(p=torch.zeros(8, dtype=torch.float64))):
        args = dict(p=p, g=torch.zeros(8), m=torch.zeros(8),
                    v=torch.zeros(8), shadow=None)
        args.update(kw)
        with pytest.raises((TypeError, ValueError)):
            ka.adam_leaf(args["p"], args["g"], args["m"], args["v"],
                         ka.AdamConsts.make(LR, 0.9, 0.999, 1e-8, 1),
                         args["shadow"])
    with pytest.raises(ValueError):
        ka.adam_emit(p, torch.zeros(8), torch.zeros(8), torch.zeros(8),
                     ka.AdamConsts.make(LR, 0.9, 0.999, 1e-8, 1),
                     torch.zeros(8, dtype=torch.bfloat16), torch.zeros(2))
    # the step wrapper checks the whole list once, with the same errors,
    # and what a step shares: one gradient and one moment dtype, a shadow
    # for every leaf or none, a carried scale for every K7 leaf
    k = ka.AdamConsts.make(LR, 0.9, 0.999, 1e-8, 1)
    bf = torch.bfloat16

    def leaf(n=8, g=torch.float32, m=torch.float32):
        return [torch.zeros(n), torch.zeros(n, dtype=g),
                torch.zeros(n, dtype=m), torch.zeros(n, dtype=m)]

    def step(leaves, shadow=None, modes=None, s_in=None):
        ka.adam_step(*[[x[i] for x in leaves] for i in range(4)], k, shadow,
                     modes, s_in)

    a, b = leaf(), leaf(5)
    for call, err in (
            (lambda: step([a, leaf(g=torch.float16)]), TypeError),
            (lambda: step([a, [b[0], torch.zeros(9), b[2], b[3]]]),
             ValueError),
            (lambda: step([a, [torch.zeros(5, dtype=torch.float64)]
                           + b[1:]]), TypeError),
            (lambda: step([a, leaf(5, g=bf)]), TypeError),
            (lambda: step([a, leaf(5, m=bf)]), TypeError),
            (lambda: step([a, b], shadow=[torch.zeros(8, dtype=bf), None]),
             ValueError),
            (lambda: step([a], shadow=[torch.zeros(8)]), TypeError),
            (lambda: step([a], modes=[ka.EMIT], s_in=[torch.zeros(1, 1)]),
             ValueError),
            (lambda: step([a], shadow=[torch.zeros(8, dtype=bf)],
                          modes=[ka.EMIT], s_in=[torch.zeros(2)]),
             ValueError),
            (lambda: step([a], shadow=[torch.zeros(8, dtype=bf)],
                          modes=[ka.EMIT]), ValueError),
            (lambda: step([a], modes=[ka.PLAIN, ka.PLAIN]), ValueError),
            (lambda: step([a], modes=[3]), ValueError)):
        with pytest.raises(err):
            call()


def test_placeholder_entries_carry_over():
    """Leaves under ``quant_min_elems`` keep the previous step's empty
    entry (no new tensors per step); the quantised leaf gets a new one."""
    opt = of.fused_adam_pallas(LR)
    tp = {k: _port(v) for k, v in _params(6).items()}
    ts = opt.init(tp)
    sh = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    prev = {k: of.quantize_leaf(v, k == "big") for k, v in tp.items()}
    grads = {k: torch.full_like(v, 0.01) for k, v in tp.items()}
    _, q = opt.update_apply(grads, ts, tp, shadow=sh,
                            quant_min_elems=1 << 20, prev_quant=prev)
    assert q["big"] is not prev["big"] and q["big"]["q"].numel()
    for k in ("w64", "w13", "b"):
        assert q[k] is prev[k] and q[k]["q"].shape == (0, 0)


def test_cpu_path_launches_nothing():
    before = dict(ka.LAUNCHES)
    opt = of.fused_adam_pallas(LR)
    tp = {"w": torch.ones((16, 8))}
    ts = opt.init(tp)
    sh = {"w": torch.ones((16, 8), dtype=torch.bfloat16)}
    opt.update_apply({"w": torch.ones((16, 8))}, ts, tp, shadow=sh,
                     quant_min_elems=1, prev_quant=None)
    assert ka.LAUNCHES == before
