"""The port's int8 kernel microbenchmark (``spatialvae_torch/tools/
kernel_bench.py``) and the plain versions of its kernels
(``spatialvae_torch/kernels/kernel_bench.py``) against the JAX package's
tool ``tools/kernel_bench.py``.

A subprocess imports the JAX tool with ``pl.pallas_call`` patched to
``interpret=True`` (each call's outputs kept), its module globals set small
(B=2, HW=1,024, H=40; pt=512: a grid of (2, 2), four steps; the port's K3
takes HW of at least 1,024) and the compilation cache off, and replaces
``scan_time`` with a recorder: each run's arguments and outputs (the last
``pallas_call``'s in full), the arrays the runs' closures hold (from
``main``'s frame), and the two runs the JAX tool's guards never let run,
``gemm1(a0q_tile, w1q)`` and ``bwd_full(fold, coords)``, called from those
locals.  It writes everything to an ``.npz``; the tool file is untouched.
It runs in a process of its own because importing the JAX tool sets
``SPATIALVAE_ALLOW_KNOBS=1`` for the whole process.

The same arrays then go through each run's plain version and through the
port tool's ``device=cpu`` path (the wrappers on CPU tensors).  Limits:
integer outputs (the GEMM rows, a0q rows and column sums) exactly; float32
elementwise outputs (a1 rows, y) within 2e-6; fwd-pipe's bf16 a1 within
one bf16 ulp; fused-plain's and bwd-fixscale's sums within 1e-5 of
max|JAX| (the plain versions sum in the JAX grid's order); the K3, K4, K5
and K8 runs within the limits of their own parity tests.  No test here
needs a card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import kernel_bench as kb
from spatialvae_torch.kernels.config import numerics
from spatialvae_torch.tools import common
from spatialvae_torch.tools import kernel_bench as t1
from tests.port_configs import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(B=2, HW=1024, H=40)
PT = 512
LOCALS = ("fold", "coords", "w1", "b1", "wht", "bht", "g", "a0q_tile", "w1q",
          "sw", "y_tp", "x3p", "w1qp", "swp", "y_t", "y_tt", "foldT", "y_",
          "a1_")
# the limits of the K3, K4, K5, K8 parity tests (tests/test_torch_port_int8
# .py, _k8.py) for float32 weights: relative to max|JAX| (max, mean); K4's
# y absolute
K3_TOL = {"dfold": (2e-5, 2e-6), "dw1": (2e-3, 3e-5), "db1": (5e-6, 1e-6),
          "dwht": (1e-5, 2e-6), "dbht": (1e-5, 2e-6)}
K8_TOL = {"dfoldT": (5e-6, 5e-7), "dw1": (1e-4, 1e-6), "db1": (1e-4, 1e-6),
          "dwht": (1e-5, 2e-6), "dbht": (5e-6, 5e-6)}
K5_TOL = (2e-3, 5e-5)
K4_Y_TOL = (1e-3, 1e-6)
ELEMWISE_TOL = 2e-6
SUM_TOL = 1e-5

RECORD = r"""
import io, os, sys, contextlib
import numpy as np
repo, dest = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tools"))
import jax
jax.config.update("jax_platforms", "cpu")
from jax.experimental import pallas as pl
import spatialvae_tpu.core.cache as cache
cache.enable_compilation_cache = lambda *a, **k: None
last = []
_pallas_call = pl.pallas_call
def pallas_call(*a, **k):
    k["interpret"] = True
    f = _pallas_call(*a, **k)
    def call(*args):
        out = f(*args)
        last.append(out)
        return out
    return call
pl.pallas_call = pallas_call
arrays, order = {}, []
def save(key, out):
    for i, x in enumerate(jax.tree_util.tree_leaves(out)):
        arrays[f"{key}/{i}"] = np.asarray(x.astype(np.float32)
                                          if x.dtype == jax.numpy.bfloat16
                                          else x)
def record(name, fn, args):
    order.append(name)
    for i, x in enumerate(args):
        arrays[f"{name}/arg{i}"] = np.asarray(x)
    last.clear()
    save(f"{name}/out", fn(*args))
    save(f"{name}/full", last[-1])
def keep(name, fn, args, iters):
    frame = sys._getframe(1).f_locals
    for k in LOCALS:
        if k in frame and f"local/{k}" not in arrays:
            v = frame[k]
            arrays[f"local/{k}"] = np.asarray(
                v.astype(np.float32) if v.dtype == jax.numpy.bfloat16 else v)
    if not order:        # the run the guard at :152 never lets run
        record("gemm1", frame["gemm1"], (frame["a0q_tile"], frame["w1q"]))
    if name == "bwd-fixscale":   # and the one at :710
        record("bwd", frame["bwd_full"], (frame["fold"], frame["coords"]))
    if name == "fused-loss":
        record(name, lambda f, x: frame["_lossgrad_pallas"](
            f, x, frame["w1"], frame["b1"][None, :], frame["wht"],
            frame["bht"][:, None], frame["y_t"]), args)
    elif name == "fused-t":
        record(name, lambda f, x: frame["_lossgrad_pallas_t"](
            f, x, frame["w1"], frame["b1"], frame["wht"], frame["bht"],
            frame["y_tt"]), args)
    else:
        record(name, fn, args)
import kernel_bench as t1
t1.B, t1.HW, t1.H = SIZES
t1.scan_time = keep
sys.argv = ["kernel_bench.py", "pt=PT", "iters=1"]
with contextlib.redirect_stdout(io.StringIO()):
    t1.main()
np.savez(os.path.join(dest, "runs.npz"), **arrays)
with open(os.path.join(dest, "runs.json"), "w") as fh:
    json.dump({"order": order}, fh)
""".replace("import io, os", "import io, json, os")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    dest = tmp_path_factory.mktemp("jax_kernel_bench")
    script = (RECORD.replace("SIZES", repr(tuple(SIZES.values())))
              .replace("LOCALS", repr(LOCALS)).replace("pt=PT", f"pt={PT}"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, REPO, str(dest)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(dest / "runs.json") as fh:
        meta = json.load(fh)
    data = np.load(dest / "runs.npz")
    return meta, {k: data[k] for k in data.files}


@pytest.fixture
def small_tool(monkeypatch):
    monkeypatch.setattr(t1, "H", SIZES["H"])


def _arrays(data) -> dict:
    """The port's array dict from the JAX tool's own arrays."""
    loc = {k[len("local/"):]: v for k, v in data.items()
           if k.startswith("local/")}
    t = {k: torch.from_numpy(np.ascontiguousarray(loc[k])) for k in (
        "fold", "coords", "w1", "b1", "wht", "bht", "g", "a0q_tile", "w1q",
        "foldT")}
    t["sw"] = torch.from_numpy(loc["sw"]).reshape(1)
    t["yt"] = torch.from_numpy(loc["y_t"])
    t["y"] = torch.from_numpy(loc["y_"])
    t["a1"] = torch.from_numpy(loc["a1_"]).to(torch.bfloat16)
    t["wht_bf16"] = t["wht"].bfloat16()
    t["k4"] = d8.Int8Weights(t["w1"], t["b1"], t["wht"], t["bht"])
    return t


def _full(data, name, key="full") -> list:
    """A run's recorded outputs: the last ``pallas_call``'s (``full``) or
    the run's function's (``out``)."""
    out, i = [], 0
    while f"{name}/{key}/{i}" in data:
        out.append(data[f"{name}/{key}/{i}"])
        i += 1
    return out


def _rel(got, want) -> tuple:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    d = np.abs(got - want)
    scale = float(np.abs(want).max()) or 1.0
    return d.max() / scale, d.mean() / scale


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> int:
    """The largest distance in bf16 units in the last place."""
    a = got.view(torch.int16).numpy().astype(np.int64)
    b = torch.from_numpy(want).bfloat16().view(torch.int16).numpy() \
        .astype(np.int64)
    key = lambda v: np.where(v < 0, -(v & 0x7FFF), v)  # noqa: E731
    return int(np.abs(key(a) - key(b)).max())


def _ways(name):
    run = {r.name: r for r in t1.runs(SIZES["B"], SIZES["HW"], PT)}[name]
    return run, (run.fn, run.plain)


def test_jax_tool_records_every_run(jax_runs):
    meta, data = jax_runs
    # the two runs the JAX guards skip are recorded from main's locals
    assert meta["order"] == ["gemm1"] + list(t1.RUNS[1:15]) + [
        "bwd", "bwd-fixscale"]
    assert sorted(meta["order"]) == sorted(t1.RUNS)
    assert all(f"local/{k}" in data for k in LOCALS)


EXACT = {"gemm1": 1, "gemm2": 1, "gemm3": 1, "vpu-only": 1,
         "gemm1+ivpu": 2, "gemm1+ivpu2": 2, "vpu-full": 1}


@pytest.mark.parametrize("name", list(EXACT))
def test_integer_runs_match_jax_exactly(jax_runs, small_tool, name):
    _, data = jax_runs
    arrays = _arrays(data)
    want = _full(data, name)
    assert len(want) == EXACT[name]
    _, ways = _ways(name)
    for way in ways:
        outs, sums = way(arrays)
        assert len(outs) == len(want)
        for got, ref in zip(outs, want):
            assert got.dtype == torch.from_numpy(ref).dtype, (got.dtype,
                                                             ref.dtype)
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ["gemm1+vpu", "fwd-nores"])
def test_float_rows_and_y_match_jax(jax_runs, small_tool, name):
    _, data = jax_runs
    arrays = _arrays(data)
    (want,) = _full(data, name)
    _, ways = _ways(name)
    for way in ways:
        (got,), _ = way(arrays)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=ELEMWISE_TOL)


@pytest.mark.parametrize("name", ["fwd-pipe2", "fwd-pipe4"])
def test_fwd_pipe_matches_jax(jax_runs, small_tool, name):
    _, data = jax_runs
    arrays = _arrays(data)
    y, a1 = _full(data, name)
    _, ways = _ways(name)
    for way in ways:
        (gy, ga1), _ = way(arrays)
        np.testing.assert_allclose(gy.numpy(), y, rtol=0, atol=ELEMWISE_TOL)
        assert ga1.dtype == torch.bfloat16
        assert _bf16_ulps(ga1, a1) <= 1


def test_fwd_is_k4_and_matches_jax(jax_runs, small_tool):
    """The shipping forward run: K4 (its plain version) against the JAX
    ``_fwd_pallas``, at K4's parity limits; fwd-nores computes the same
    function (the TPU kernel divides sw by 127 where K4 multiplies by
    1/127)."""
    _, data = jax_runs
    arrays = _arrays(data)
    (want,) = _full(data, "fwd")
    _, ways = _ways("fwd")
    for way in ways:
        (got,), _ = way(arrays)
        d = np.abs(got.numpy() - want)
        assert d.max() <= K4_Y_TOL[0] and d.mean() <= K4_Y_TOL[1]
    np.testing.assert_allclose(_full(data, "fwd-nores")[0], want, rtol=0,
                               atol=ELEMWISE_TOL)


SUM_NAMES = {"fused-plain": ("dfold", "dw1", "db1", "dwht", "dbht"),
             "bwd-fixscale": ("dfold", "dw1")}


@pytest.mark.parametrize("name", list(SUM_NAMES))
def test_backward_sums_match_jax(jax_runs, small_tool, name):
    """fused-plain's and bwd-fixscale's outputs, every one a sum over the
    grid's steps, within 1e-5 of max|JAX|; the loss at dfold[:, 3, 0]."""
    _, data = jax_runs
    arrays = _arrays(data)
    want = _full(data, name)
    _, ways = _ways(name)
    for way in ways:
        got, _ = way(arrays)
        for g_name, a, b in zip(SUM_NAMES[name], got, want):
            mx, _ = _rel(a.numpy(), b)
            assert mx <= SUM_TOL, (g_name, mx)
        assert not got[0][:, 3, 1:].any()
    if name == "fused-plain":
        assert (np.asarray(want[0])[:, 3, 0] > 0).all()


@pytest.mark.parametrize("name,tol", [("fused-loss", K3_TOL),
                                      ("fused-t", K8_TOL)])
def test_loss_kernel_runs_match_jax(jax_runs, small_tool, name, tol):
    _, data = jax_runs
    arrays = _arrays(data)
    want = _full(data, name, "out")
    assert len(want) == 5
    _, ways = _ways(name)
    for way in ways:
        got, _ = way(arrays)
        for (g_name, lim), a, b in zip(tol.items(), got, want):
            mx, mean = _rel(a.numpy(), b)
            assert mx <= lim[0] and mean <= lim[1], (g_name, mx, mean)


def test_bwd_matches_jax(jax_runs, small_tool):
    """The run the JAX tool never runs: K5 with a1 rebuilt, against
    ``bwd_full``'s ``_bwd_pallas`` outputs at K5's parity limits."""
    _, data = jax_runs
    arrays = _arrays(data)
    want = _full(data, "bwd")
    assert len(want) == 5
    _, ways = _ways("bwd")
    for way in ways:
        got, _ = way(arrays)
        for a, b in zip(got, want):
            mx, mean = _rel(a.numpy(), b)
            assert mx <= K5_TOL[0] and mean <= K5_TOL[1]


def test_only_selects_by_prefix_and_runs_gemm1_and_bwd(small_tool, capsys):
    argv = ["b=2", f"hw={SIZES['HW']}", f"pt={PT}", "iters=1", "device=cpu"]
    assert t1.main(argv + ["only=gemm1,bwd"]) == 0
    names = [x.split()[0] for x in capsys.readouterr().out.splitlines()[1:]]
    assert names == ["gemm1", "gemm1+vpu", "gemm1+ivpu", "gemm1+ivpu2",
                     "bwd", "bwd-fixscale"]
    # "fwd" selects the runs it prefixes, and itself only by its name
    assert t1.main(argv + ["only=fwd"]) == 0
    names = [x.split()[0] for x in capsys.readouterr().out.splitlines()[1:]]
    assert names == ["fwd-nores", "fwd-pipe2", "fwd-pipe4", "fwd"]
    assert t1.main(argv + ["only=bwd-fix,fwd-"]) == 0
    names = [x.split()[0] for x in capsys.readouterr().out.splitlines()[1:]]
    assert names == ["fwd-nores", "fwd-pipe2", "fwd-pipe4", "bwd-fixscale"]
    assert common.wanted("gemm1+", ["gemm1"]) and not common.wanted(
        "gemm1", ["gemm1+"])


def test_every_run_prints_one_line_with_its_bound(small_tool, capsys):
    assert t1.main(["b=2", f"hw={SIZES['HW']}", f"pt={PT}", "iters=1",
                    "device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"# B=2 HW={SIZES['HW']} H=40 pt={PT} "
                               "grid=(2, 2) (4 steps/iter)")
    assert [x.split()[0] for x in lines[1:]] == list(t1.RUNS)
    for x in lines[1:]:
        assert "ms/iter" in x and float(x.split("bound ")[1].split()[0]) > 0


def test_bounds_at_the_defaults():
    runs = {r.name: r for r in t1.runs(2048, 4096, 2048)}
    # one int8 GEMM per step: 4.19e12 operations, 2.12 ms at 1,979 TOP/s
    assert runs["gemm1"].int8_ops == 2.0 * 2048 * 4096 * 500 ** 2
    assert 2.11 < runs["gemm1"].bound_ms() < 2.13
    assert 4.23 < runs["gemm2"].bound_ms() < 4.25
    assert 6.35 < runs["gemm3"].bound_ms() < 6.37
    # the a0 chain, 7 f32 operations per element at 67 TFLOP/s
    assert 0.43 < runs["vpu-full"].bound_ms() < 0.45
    # fwd-pipe and bwd-fixscale move the 8.39 GB bf16 a1
    for name in ("fwd-pipe2", "fwd-pipe4", "bwd-fixscale"):
        assert runs[name].bound_ms() >= 8.39e9 / common.HBM_BYTES_PER_S * 1e3


def test_tool_goes_to_the_card_unless_asked_for_the_cpu(small_tool,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t1.main(["b=2", f"hw={SIZES['HW']}", f"pt={PT}"])
    with pytest.raises(SystemExit):
        t1.main(["tile=64", "device=cpu"])


def test_importing_the_tool_leaves_the_environment_alone():
    code = ("import os; before = dict(os.environ); "
            "import spatialvae_torch.tools.kernel_bench; "
            "assert dict(os.environ) == before, 'environment changed'")
    env = {k: v for k, v in os.environ.items()
           if k != "SPATIALVAE_ALLOW_KNOBS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("caller", [None, "0"])
def test_main_allows_knobs_only_while_it_runs(small_tool, monkeypatch,
                                              caller):
    """Off-default knobs are allowed inside ``main`` and refused again after
    it: the caller's ``SPATIALVAE_ALLOW_KNOBS`` (unset, or "0") comes back."""
    if caller is None:
        monkeypatch.delenv("SPATIALVAE_ALLOW_KNOBS", raising=False)
    else:
        monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", caller)
    before = dict(os.environ)
    seen = []

    def timed(fn, arrays, iters):
        seen.append(os.environ.get("SPATIALVAE_ALLOW_KNOBS"))
        return 1.0
    monkeypatch.setattr(t1, "time_ms", timed)
    assert t1.main(["b=2", f"hw={SIZES['HW']}", f"pt={PT}", "iters=1",
                    "device=cpu", "only=gemm1"]) == 0
    assert seen == ["1"] * 4
    assert dict(os.environ) == before
    monkeypatch.setenv("SPATIALVAE_SR", "1")
    with pytest.raises(RuntimeError, match="ALLOW_KNOBS"):
        numerics()


def test_plain_sums_fold_every_step_of_every_group():
    """The chain's and the GEMMs' per-block words against an independent
    count: every q (and acc) of every step, grouped as the kernels'
    blocks are."""
    rng = np.random.default_rng(5)
    b, hw, h, pt = 3, 128, 24, 64
    fold = torch.from_numpy(rng.standard_normal((b, 4, h)).astype(np.float32))
    coords = torch.from_numpy(rng.standard_normal((hw, 2)).astype(np.float32))
    outs, (isums, fsums) = kb.chain("sums", fold, coords, pt)
    x0, x1 = coords[:, 0:1], coords[:, 1:2]
    q = torch.round(torch.tanh((x0 * fold[:, 0:1] + x1 * fold[:, 1:2])
                               + fold[:, 2:3]) * 127)        # (B, HW, H)
    assert isums.tolist() == [int(q.sum())] and fsums.tolist() == [0.0]
    assert torch.equal(outs[0], q[-1, -pt:].sum(0, keepdim=True).int())
    a = torch.from_numpy(rng.integers(-127, 128, (pt, h), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (h, h), dtype=np.int8))
    out, sums = kb.gemm_multi("gemm3", a, a, w, 20)
    an, wn = a.numpy().astype(np.int64), w.numpy().astype(np.int64)
    prods = (an @ wn, an.T @ an, an @ wn.T)
    np.testing.assert_array_equal(out.numpy(),
                                  sum(p[:8] for p in prods).astype(np.float32))
    groups = kb.step_groups(20, sums.shape[1])
    assert sums.shape[0] == groups
    total = sum(int(p.sum()) for p in prods) * 20
    assert int(sums.long().sum()) % 2 ** 32 == total % 2 ** 32


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    f = torch.zeros((2, 4, 40))
    c = torch.zeros((256, 2))
    with pytest.raises(ValueError, match="chain mode"):
        kb.chain("both", f, c, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        kb.chain("sums", f, c, 96)
    with pytest.raises(TypeError):
        kb.chain("sums", f.double(), c, 64)
    with pytest.raises(ValueError, match="unknown run"):
        kb.gemm_multi("gemm4", *(torch.zeros((64, 40), dtype=torch.int8),) * 2,
                      torch.zeros((40, 40), dtype=torch.int8), 1)
    w1q = torch.zeros((40, 40), dtype=torch.int8)
    with pytest.raises(ValueError, match="sub_tiles"):
        kb.fwd_pipe(3, f, c, w1q, torch.ones(1), torch.zeros(40),
                    torch.zeros((3, 40)), torch.zeros(3), 64)
    with pytest.raises(ValueError, match="a1"):
        kb.bwd_fixscale(f, c, w1q, torch.ones(1), torch.zeros((3, 40)),
                        torch.zeros((2, 128, 40), dtype=torch.bfloat16),
                        torch.zeros((2, 3, 256)), torch.zeros((2, 3, 256)),
                        64)
