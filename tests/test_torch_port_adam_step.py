"""The step-level Adam of the port (``kernels/adam.py`` ``adam_step``, one
launch of ``csrc/adam_sm90.cu`` a step on the card) on the CPU, where it
runs its plain version:

- (a) ``update_apply`` through ``adam_step`` against the per-leaf path (the
  per-leaf wrappers ``adam_leaf``, ``adam_emit``, ``quant_scale`` and
  ``quantize``, as a step called them before) bit for bit, and against
  JAX's ``fused_adam_pallas(interpret=True)`` at the limits
  ``test_torch_port_adam.py`` states, on ragged leaves of 1, 3, 46 and
  8 Ki + 5 elements beside 2-D ones, both engines, both moment dtypes,
  shadow on and off;
- (b) the host's chunk plan (``step_table``, walked as the kernel walks
  it): every element of every leaf exactly once, bulk parts 16-byte
  aligned multiples, tails and unaligned leaves on the plain-load path,
  each leaf's flags from
  ``step_modes`` (K7 where ``_k7_gate`` admits it, the fresh scale where
  the xla engine quantises), the table within the kernel's cap, and the
  geometry the kernel's source states;
- (c) the finisher's scale arithmetic (float32 max/127 + 1e-30, each
  operation rounded once) against ``quant_scale_reference``.

The kernel is held to these plain versions on the card by
``test_torch_port_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.train import optimizer_pallas as jax_pal

from spatialvae_torch.kernels import adam as ka
from spatialvae_torch.train import optimizer_fused as of
from tests.port_configs import one_torch_thread  # noqa: F401
# JAX's limits between its kernels and its op-by-op path, and the leaf and
# ulp helpers, as test_torch_port_adam.py states them
from tests.test_torch_port_adam import JDT, KERNEL_TOL, _port, _ulps

LR = 1e-3
# JAX (fan_in, fan_out) shapes: a K7 leaf under ``pallas`` (64 rows, a
# block of 8), a 2-D leaf without a block (13 rows: the fresh scale under
# both engines) and the ragged 1-D leaves
SHAPES = {"w64": (64, 300), "w13": (13, 16), "r1": (1,), "r3": (3,),
          "r46": (46,), "r8k5": (8 * 1024 + 5,)}
CASES = [("xla", "f32", False), ("xla", "bf16", False), ("xla", "f32", True),
         ("xla", "bf16", True), ("pallas", "f32", True),
         ("pallas", "bf16", True)]


def _env(monkeypatch, engine, moments):
    monkeypatch.setenv("SPATIALVAE_PALLAS_ADAM", "1")
    monkeypatch.setenv("SPATIALVAE_ADAM_MOMENTS", moments)
    monkeypatch.setenv("SPATIALVAE_ADAM_EMIT", engine)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")


def _grads(rng):
    return {k: (0.1 * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _per_leaf_step(opt, grads, state, params, shadow, qme, prev):
    """One step the way ``update_apply`` ran it leaf by leaf: K6 or K7 per
    leaf through the per-leaf wrappers, then each scale and copy."""
    k = opt.consts(state.count + 1)
    use_emit = (qme is not None and shadow is not None and prev is not None
                and of.adam_emit() == "pallas")
    qshadow = {}
    for name, p in params.items():
        g, m, v = grads[name], state.mu[name], state.nu[name]
        sh = None if shadow is None else shadow[name]
        if use_emit and of._k7_gate(p, g, m, qme):
            q, amax = ka.adam_emit(p, g, m, v, k, sh, prev[name]["ns"])
            qshadow[name] = {"q": q, "s": prev[name]["ns"],
                             "ns": ka.quant_scale(amax)}
            continue
        on = qme is not None and p.dim() == 2 and p.numel() >= qme
        amax = ka.adam_leaf(p, g, m, v, k, sh, want_amax=on)
        if on:
            s, ns = ka.quant_scale(amax, twin=True)
            qshadow[name] = {"q": ka.quantize(p, s), "s": s, "ns": ns}
        elif qme is not None:
            qshadow[name] = (prev[name] if prev is not None
                             and prev[name]["q"].numel() == 0
                             else of.empty_entry(p.device))
    return of.FusedAdamState(state.count + 1, state.mu, state.nu), qshadow


def _init(opt, shadow):
    rng = np.random.default_rng(0)
    np_params = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in SHAPES.items()}
    tp = {k: _port(v) for k, v in np_params.items()}
    ts = opt.init(tp)
    tsh = {k: v.to(torch.bfloat16) for k, v in tp.items()} if shadow else None
    tq = ({k: of.quantize_leaf(v, v.dim() == 2) for k, v in tp.items()}
          if shadow else None)
    return np_params, tp, ts, tsh, tq


def _clone(d):
    if d is None:
        return None
    return {k: ({f: t.clone() for f, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in d.items()}


@pytest.mark.parametrize("engine,moments,shadow", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_step_equals_the_per_leaf_path(engine, moments, shadow,
                                       monkeypatch):
    """Three steps of ``update_apply`` (one ``adam_step`` and one
    ``quantize_many`` a step) and of the per-leaf path from the same state:
    every output bit for bit, the carried scale the same object."""
    _env(monkeypatch, engine, moments)
    gdt = torch.bfloat16 if shadow else torch.float32
    opt = of.fused_adam_pallas(LR)
    _, tp, ts, tsh, tq = _init(opt, shadow)
    lp, lsh, lq = _clone(tp), _clone(tsh), _clone(tq)
    ls = of.FusedAdamState(ts.count, _clone(ts.mu), _clone(ts.nu))
    rng = np.random.default_rng(1)
    qme = 1 if shadow else None
    for _ in range(3):
        grads = {k: _port(v, gdt) for k, v in _grads(rng).items()}
        if shadow:
            ts, new_q = opt.update_apply(grads, ts, tp, shadow=tsh,
                                         quant_min_elems=qme, prev_quant=tq)
        else:
            ts = opt.update_apply(grads, ts, tp)
        ls, lq_new = _per_leaf_step(opt, grads, ls, lp, lsh, qme, lq)
        for k in SHAPES:
            for got, want in ((tp[k], lp[k]), (ts.mu[k], ls.mu[k]),
                              (ts.nu[k], ls.nu[k])):
                assert torch.equal(got, want), k
            if shadow:
                assert torch.equal(tsh[k], lsh[k]), k
                for f in ("q", "s", "ns"):
                    assert torch.equal(new_q[k][f], lq_new[k][f]), (k, f)
                carried = new_q[k]["s"] is tq[k]["ns"]
                assert carried == (lq_new[k]["s"] is lq[k]["ns"]), k
        if shadow:
            tq, lq = new_q, lq_new
        assert ts.count == ls.count


@pytest.mark.parametrize("engine,moments,shadow", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_step_matches_jax_on_ragged_leaves(engine, moments, shadow,
                                           monkeypatch):
    """Three steps against JAX's ``fused_adam_pallas(interpret=True)``: the
    K7 leaf under ``pallas`` (JAX's kernel, which contracts into FMAs) at
    JAX's own kernel limits, every other leaf within 1 ulp of its dtype,
    its copies bit for bit where p' is."""
    _env(monkeypatch, engine, moments)
    mdt = torch.bfloat16 if moments == "bf16" else torch.float32
    gdt = torch.bfloat16 if shadow else torch.float32
    opt = of.fused_adam_pallas(LR)
    np_params, tp, ts, tsh, tq = _init(opt, shadow)
    pal = jax_pal.fused_adam_pallas(LR, interpret=True)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    js = pal.init(jp)
    jq = (jax.tree_util.tree_map(
        lambda p: jax_pal.quantize_leaf(p, p.ndim == 2), jp)
        if shadow else None)
    kernel_leaves = {"w64"} if engine == "pallas" else set()
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = _grads(rng)
        jg = {k: jnp.asarray(v, JDT[gdt]) for k, v in grads.items()}
        tg = {k: _port(v, gdt) for k, v in grads.items()}
        if shadow:
            jp, js, jsh, jq = pal.update_apply(
                jg, js, jp, shadow_dtype=jnp.bfloat16, quant_min_elems=1,
                prev_quant=jq)
            ts, tq = opt.update_apply(tg, ts, tp, shadow=tsh,
                                      quant_min_elems=1, prev_quant=tq)
        else:
            jp, js = pal.update_apply(jg, js, jp)
            ts = opt.update_apply(tg, ts, tp)
        for k in SHAPES:
            p_equal = True
            for what, got, want, dt in (("p", tp[k], jp[k], torch.float32),
                                        ("m", ts.mu[k], js.mu[k], mdt),
                                        ("v", ts.nu[k], js.nu[k], mdt)):
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
            assert torch.equal(tsh[k], tp[k].to(torch.bfloat16))
            q_want = _port(jq[k]["q"]).to(torch.int8)
            assert tq[k]["q"].shape == q_want.shape
            if p_equal:
                assert torch.equal(tsh[k], _port(jsh[k], torch.bfloat16))
                assert torch.equal(tq[k]["q"], q_want), (k, step)
                for f in ("s", "ns"):
                    assert torch.equal(tq[k][f], _port(jq[k][f])), (k, f)
            else:
                assert (tq[k]["q"].int() - q_want.int()).abs().max() <= 1
                d_p = (tp[k] - _port(jp[k])).abs().max()
                for f in ("s", "ns"):
                    d = (tq[k][f] - _port(jq[k][f])).abs().max() * 127
                    assert d <= d_p * 1.001, (k, f, float(d), float(d_p))


# ---------------------------------------------------------------------------
# (b) the host's chunk plan
# ---------------------------------------------------------------------------


def _leaf(n, gdt, mdt, shadow, q, offset=0):
    """[p, g, m, v, shadow, q] of n elements; ``offset`` > 0 makes every
    tensor a view that many elements into a larger buffer."""
    def t(dtype):
        return torch.zeros(n + offset, dtype=dtype)[offset:]

    return [t(torch.float32), t(gdt), t(mdt), t(mdt),
            t(torch.bfloat16) if shadow else None,
            t(torch.int8) if q else None]


def chunk_plan(table: np.ndarray) -> list:
    """The chunks the step kernel walks for ``table`` (csrc/adam_sm90.cu
    ``locate``), in order: (leaf, first element, elements, bulk)."""
    out = []
    for i, row in enumerate(table):
        n, bulk = int(row[7]), int(row[8])
        for start in range(0, bulk, ka.STEP_CHUNK):
            out.append((i, start, min(ka.STEP_CHUNK, bulk - start), True))
        for start in range(bulk, n, ka.STEP_CHUNK):
            out.append((i, start, min(ka.STEP_CHUNK, n - start), False))
    return out


PLAN_SIZES = [1, 3, 15, 16, 17, 46, 2048, 2049, 4096, 8 * 1024 + 5,
              3 * 2048 + 16, 100003]


@pytest.mark.parametrize("gdt,mdt,shadow", [
    (torch.float32, torch.float32, False),
    (torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, True)],
    ids=["f32", "bf16g-shadow", "bf16-all"])
@pytest.mark.parametrize("offset", [0, 1, 8])
def test_chunk_plan_covers_every_element_once(gdt, mdt, shadow, offset):
    leaves = [_leaf(n, gdt, mdt, shadow, q=shadow and i % 3 == 0,
                    offset=offset if i % 2 else 0)
              for i, n in enumerate(PLAN_SIZES)]
    modes = [ka.EMIT if x[5] is not None else
             (ka.FRESH if i % 4 == 1 else ka.PLAIN)
             for i, x in enumerate(leaves)]
    table = ka.step_table(
        [x[0] for x in leaves], [x[1] for x in leaves],
        [x[2] for x in leaves], [x[3] for x in leaves],
        [x[4] for x in leaves] if shadow else None,
        [x[5] for x in leaves], [x[0][:1] if x[5] is not None else None
                                 for x in leaves], modes)
    assert table.shape == (len(leaves), 10) and len(leaves) <= \
        ka.STEP_MAX_LEAVES
    plan = chunk_plan(table)
    begin = 0
    for i, (x, mode) in enumerate(zip(leaves, modes)):
        n = x[0].numel()
        row = table[i]
        assert [int(w) for w in row[:7]] == [
            t.data_ptr() if t is not None else 0
            for t in (x[1], x[2], x[3], x[0], x[4], x[5],
                      x[0][:1] if x[5] is not None else None)]
        assert int(row[7]) == n and int(row[9]) & 0xffffffff == begin
        assert int(row[9]) >> 32 == ka.MODE_FLAGS[mode]
        chunks = [c for c in plan if c[0] == i]
        assert plan.index(chunks[0]) == begin
        begin += len(chunks)
        covered = np.zeros(n, np.int64)
        aligned = all(t.data_ptr() % 16 == 0 for t in x if t is not None)
        n_bulk = int(row[8])
        assert n_bulk == (n - n % ka.STEP_ALIGN if aligned else 0)
        for _, start, count, bulk in chunks:
            assert 0 < count <= ka.STEP_CHUNK
            covered[start:start + count] += 1
            if bulk:
                assert start + count <= n_bulk
                assert count % ka.STEP_ALIGN == 0
                for t in x:
                    if t is not None:
                        assert (t.data_ptr() + start * t.element_size()) \
                            % 16 == 0
                        assert count * t.element_size() % 16 == 0
            else:
                assert start >= n_bulk
        assert (covered == 1).all(), i
        if aligned:
            assert n - n_bulk < ka.STEP_ALIGN
    assert begin == len(plan)


def test_step_modes_follow_the_gates(monkeypatch):
    """Each leaf's mode, hence its flags: K7 exactly where ``_k7_gate``
    admits it under ``pallas``, the fresh scale where the xla engine's
    test (2-D, at least ``quant_min_elems``) holds, else plain; every
    mode's flags as the kernel reads them."""
    shapes = {"a": (300, 64), "b": (16, 13), "c": (64, 300), "d": (46,),
              "e": (500, 500), "f": (8, 9)}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    for gdt, mdt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        grads = {k: p.to(gdt) for k, p in params.items()}
        mu = {k: p.to(mdt) for k, p in params.items()}
        for qme in (None, 1, 200, 1 << 20):
            for use_emit in ((False, True) if qme else (False,)):
                modes = of.step_modes(params, grads, mu, qme, use_emit)
                for (k, p), md in zip(params.items(), modes):
                    k7 = use_emit and of._k7_gate(p, grads[k], mu[k], qme)
                    on = qme is not None and p.dim() == 2 and \
                        p.numel() >= qme
                    want = ka.EMIT if k7 else ka.FRESH if on else ka.PLAIN
                    assert md == want, (k, qme, use_emit)
    assert ka.MODE_FLAGS == {
        ka.PLAIN: 0, ka.FRESH: ka.F_AMAX | ka.F_S | ka.F_NS,
        ka.EMIT: ka.F_AMAX | ka.F_QUANT | ka.F_NS}


def test_geometry_is_the_kernels():
    """The host's chunk, alignment, leaf cap and flags are the constants
    of csrc/adam_sm90.cu, and the cap keeps the table within the 4 KiB a
    kernel parameter may hold (10 eight-byte words a leaf)."""
    src = (Path(ka.__file__).parent / "csrc" / "adam_sm90.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    chunk = const("kChunk").split(" * ")
    assert int(const(chunk[0])) * int(const(chunk[1])) == ka.STEP_CHUNK
    assert int(const("kAlign")) == ka.STEP_ALIGN
    assert int(const("kMaxLeaves")) == ka.STEP_MAX_LEAVES
    for name, flag in (("kAmax", ka.F_AMAX), ("kQuant", ka.F_QUANT),
                       ("kWriteS", ka.F_S), ("kWriteNS", ka.F_NS)):
        assert int(const(name)) == flag
    assert ka.STEP_MAX_LEAVES * 80 + 64 <= 4096
    adam_src = (Path(ka.__file__).parent / "csrc" / "adam.cu").read_text()
    assert int(re.search(r"constexpr int kQuantLeaves = (\d+);",
                         adam_src).group(1)) == ka.QUANT_MAX_LEAVES


def test_galaxy_step_fits_one_launch():
    """The galaxy model's 13 leaves (and those of every bench
    configuration, at most 13) take one launch."""
    from spatialvae_torch.config import InferenceConfig, \
        SpatialGeneratorConfig
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator

    q = InferenceNetwork(InferenceConfig(n=64 * 64 * 3, latent_dim=23,
                                         hidden_dim=5000, num_layers=2),
                         device="meta")
    p = SpatialGenerator(SpatialGeneratorConfig(latent_dim=20,
                                                hidden_dim=500, n_out=3,
                                                num_layers=2), device="meta")
    n = len(list(q.parameters())) + len(list(p.parameters()))
    assert n == 13 <= ka.STEP_MAX_LEAVES


# ---------------------------------------------------------------------------
# (c) the finisher's scale
# ---------------------------------------------------------------------------


def test_finisher_scale_is_quant_scale_reference():
    """The last CTA writes max/127 + 1e-30 with the division and the add
    each rounded once to float32 (``adam.cuh`` ``scale_of``): numpy's
    float32 operations round the same way, and equal the plain version's
    scale on every abs-max, zero, subnormal, huge, inf and NaN included;
    the step's plain version gives s and ns that value, in two buffers."""
    rng = np.random.default_rng(7)
    amax = np.concatenate([
        np.abs(rng.normal(size=4000)).astype(np.float32),
        (rng.random(2000) * 1e-38).astype(np.float32),
        np.float32(2.0) ** rng.integers(-149, 128, 2000).astype(np.float32),
        np.array([0.0, 1e-45, 127.0, 3.4e38, np.inf, np.nan],
                 np.float32)]).astype(np.float32)
    with np.errstate(over="ignore"):
        finisher = (amax / np.float32(127.0)) + np.float32(1e-30)
    for a, f in zip(amax, finisher):
        want = ka.quant_scale_reference(torch.tensor([a]))
        assert want.dtype == torch.float32
        np.testing.assert_array_equal(want.numpy().reshape(()), f)
    p = torch.tensor([[0.5, -2.0], [1.25, 0.0]])
    g = torch.full_like(p, 0.01)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    k = ka.AdamConsts.make(LR, 0.9, 0.999, 1e-8, 1)
    (out,) = ka.adam_step([p], [g], [m], [v], k, None, [ka.FRESH])
    amax_, s, ns = out
    assert torch.equal(amax_, p.abs().max().reshape(1))
    assert torch.equal(s, ka.quant_scale_reference(amax_))
    assert torch.equal(ns, s) and ns.data_ptr() != s.data_ptr()
