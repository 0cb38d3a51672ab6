"""The port's probe tools (``spatialvae_torch/tools/probe_int4.py``,
``probe_i16acc.py``) and the plain versions of their kernels
(``spatialvae_torch/kernels/probes.py``) against the JAX package's tools.

A subprocess imports each JAX tool (``tools/probe_int4.py``,
``tools/probe_i16acc.py``) with ``pl.pallas_call`` patched to
``interpret=True``, the tool's timing patched to record each run's
arguments, small sizes (B=2, HW=256, H=40, pt=128: four grid steps; PT=48,
H=40 for the accumulator probe's 64 steps) and the compilation cache off,
and writes every run's arguments and output to an ``.npz``; the tool files
are untouched.  It runs in a process of its own because importing either
tool sets ``SPATIALVAE_ALLOW_KNOBS=1`` for the whole process.

The same arrays then go through each run's plain version and through the
port tool's ``device=cpu`` path (the wrapper on CPU tensors): the integer
runs and ``buildT-vpu``'s column sums of round(127 tanh) must match
exactly (XLA's and PyTorch's CPU tanh could round apart and flip a value
at .5; at these sizes none does).  XLA's CPU backend cannot lower the
int4 cast (``JAX_REFUSES``: every int4 x int4 run and all four
accumulator types); those runs are held to the exact int64 product in
numpy, stored at the accumulator's width, and the test names the list so
that a change in JAX shows.  The s4 arm's plain version is held to the same
numbers.  No test here needs a card.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from spatialvae_torch.kernels import probes
from spatialvae_torch.tools import common
from spatialvae_torch.tools import probe_i16acc as t3
from spatialvae_torch.tools import probe_int4 as t2
from tests.port_configs import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2_SIZES = dict(B=2, HW=256, H=40)
T2_PT = 128
T3_SIZES = dict(PT=48, H=40)
T3_STORES = ("int32", "int16", "bfloat16", "float32")
JAX_REFUSES = {"gemm-int4", "dw1T-i4(1,1)", "da0T-i4(1,0)", "fwdT-i4(1,0)",
               "tdw1-pre-i4", "tdw1-tr-i4", "acc=int32", "acc=int16",
               "acc=bfloat16", "acc=float32"}

RECORD = r"""
import io, json, os, sys, contextlib
import numpy as np
repo, dest = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tools"))
import jax
jax.config.update("jax_platforms", "cpu")
from jax.experimental import pallas as pl
import spatialvae_tpu.core.cache as cache
cache.enable_compilation_cache = lambda *a, **k: None
made = []
_pallas_call = pl.pallas_call
def pallas_call(*a, **k):
    k["interpret"] = True
    f = _pallas_call(*a, **k)
    made.append(f)
    return f
pl.pallas_call = pallas_call
arrays, order, refused = {}, [], {}
def keep(name, fn, args):
    order.append(name)
    for i, x in enumerate(args):
        arrays[f"{name}/arg{i}"] = np.asarray(x)
    try:
        arrays[f"{name}/out"] = np.asarray(fn(*args))
    except Exception as e:  # the XLA CPU backend's refusal is a result here
        refused[name] = f"{type(e).__name__}: {str(e)[:200]}"
import probe_int4 as t2
t2.B, t2.HW, t2.H = SIZES_T2
t2.scan_time = lambda name, fn, args, iters: keep(name, fn, args)
sys.argv = ["probe_int4.py", "pt=PT", "iters=1"]
with contextlib.redirect_stdout(io.StringIO()):
    t2.main()
import probe_i16acc as t3
t3.PT, t3.H = SIZES_T3
made.clear()
draws = []
_randint = jax.random.randint
def randint(*a, **k):
    x = _randint(*a, **k)
    draws.append(x)
    return x
jax.random.randint = randint
with contextlib.redirect_stdout(io.StringIO()):
    t3.main()
for dt, f in zip(("int32", "int16", "bfloat16", "float32"), made):
    keep(f"acc={dt}", f, draws)
np.savez(os.path.join(dest, "runs.npz"), **arrays)
with open(os.path.join(dest, "runs.json"), "w") as fh:
    json.dump({"order": order, "refused": refused}, fh)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    dest = tmp_path_factory.mktemp("jax_probes")
    script = (RECORD.replace("SIZES_T2", repr(tuple(T2_SIZES.values())))
              .replace("SIZES_T3", repr(tuple(T3_SIZES.values())))
              .replace("pt=PT", f"pt={T2_PT}"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, REPO, str(dest)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(dest / "runs.json") as fh:
        meta = json.load(fh)
    data = np.load(dest / "runs.npz")
    return meta, {k: data[k] for k in data.files}


@pytest.fixture
def small_tools(monkeypatch):
    for k, v in T2_SIZES.items():
        monkeypatch.setattr(t2, k, v)
    for k, v in T3_SIZES.items():
        monkeypatch.setattr(t3, k, v)
    monkeypatch.setattr(t3, "ITERS", 1)


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (nearest, ties to even) and back."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# the int64 product each refused int4 run computes (its arguments in the
# JAX tool's order), and the stored value of each accumulator type
ORACLE = {
    "gemm-int4": lambda a, b: a @ b,
    "dw1T-i4(1,1)": lambda a, b: a @ b.T,
    "da0T-i4(1,0)": lambda a, b: a @ b,
    "fwdT-i4(1,0)": lambda a, b: a @ b,
    "tdw1-pre-i4": lambda a, b: a @ b,
    "tdw1-tr-i4": lambda a, b: a.T @ b,
}
STORED = {
    "int32": lambda c: c.astype(np.float32),
    "int16": lambda c: np.clip(c, -32768, 32767).astype(np.float32),
    "bfloat16": lambda c: _bf16_rne(c.astype(np.float32)),
    "float32": lambda c: c.astype(np.float32),
}


def _want(name, data, refused, rows):
    if name not in refused:
        return data[f"{name}/out"]
    args = [data[f"{name}/arg{i}"] for i in range(2)]
    assert all(np.abs(a).max() <= 7 for a in args), name
    c = ORACLE[name](*(a.astype(np.int64) for a in args))
    return c[:rows].astype(np.float32)


def test_jax_refuses_the_named_runs(jax_runs, small_tools):
    meta, _ = jax_runs
    assert meta["order"] == [r.name for r in t2.runs(T2_PT, s4=False)] + [
        r.name for r in t3.runs(s4=False)]
    assert set(meta["refused"]) == JAX_REFUSES, meta["refused"]
    assert all("custom element sizes" in m for m in meta["refused"].values())


@pytest.mark.parametrize("name", [
    "gemm-int8", "gemm-int4", "gemm-i4w", "dw1T-i4(1,1)", "da0T-i4(1,0)",
    "fwdT-i8(1,0)", "fwdT-i4(1,0)", "buildT-vpu", "gemm-i8xi4", "tdw1-pre-i4",
    "tdw1-pre-i8", "tdw1-tr-i4", "tdw1-tr-i8", "tr-only-i8"])
def test_int4_probe_runs_match_jax(jax_runs, small_tools, name):
    meta, data = jax_runs
    runs = {r.name: r for r in t2.runs(T2_PT)}
    run = runs[name]
    arrays = {k: torch.from_numpy(data[f"{name}/arg{i}"])
              for i, k in enumerate(run.args)}
    ways = [run.fn, run.plain]
    if name + ":s4" in runs:
        ways += [runs[name + ":s4"].fn, runs[name + ":s4"].plain]
    want = _want(name, data, meta["refused"], 8)
    for way in ways:
        got = way(arrays)[0].numpy()
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("store", T3_STORES)
def test_i16acc_types_match_jax_or_the_oracle(jax_runs, small_tools, store):
    meta, data = jax_runs
    name = f"acc={store}"
    aq, wq = (data[f"{name}/arg{i}"] for i in range(2))
    arrays = {"aq": torch.from_numpy(aq), "wq": torch.from_numpy(wq)}
    if name in meta["refused"]:
        want = STORED[store](aq.astype(np.int64) @ wq.astype(np.int64))
    else:
        want = data[f"{name}/out"]
    runs = {r.name: r for r in t3.runs()}
    for r in (runs[name], runs[name + ":s4"]):
        for way in (r.fn, r.plain):
            np.testing.assert_array_equal(way(arrays)[0].numpy(), want)


LINE_T2 = re.compile(r"^(\S+)\s+(\d+\.\d\d) ms/iter \(\s*\d+ img-equiv/s\)  "
                     r"bound (\S+) ms$")
LINE_T3 = re.compile(r"^(acc=\S+): OK  (\d+\.\d\d) ms/iter  bound (\S+) ms$")


def test_tools_print_one_parsable_line_per_run(small_tools, capsys):
    assert t2.main([f"pt={T2_PT}", "iters=1", "device=cpu"]) == 0
    assert t3.main(["device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# grid=(2, 2) pt=128 H=40 iters=1 "
                               "backend=cpu")
    t2_lines, t3_lines = lines[1:21], lines[22:]
    assert lines[21].startswith("# grid=(64,) PT=48 H=40")
    names = [LINE_T2.match(x).group(1) for x in t2_lines]
    assert names == [r.name for r in t2.runs(T2_PT)]
    assert len(names) == 14 + 6
    assert [LINE_T3.match(x).group(1) for x in t3_lines] == [
        r.name for r in t3.runs()]
    assert len(t3_lines) == 8
    for x in t2_lines:
        float(LINE_T2.match(x).group(3))


def test_tools_go_to_the_card_unless_asked_for_the_cpu(small_tools,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t2.main([f"pt={T2_PT}", "iters=1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t3.main([])
    with pytest.raises(SystemExit):
        t2.main(["tile=64", "device=cpu"])


def test_bounds_use_chip_smokes_peaks():
    assert common.PEAK_INT8 == chip_smoke.PEAK_INT8
    assert common.PEAK_FP32 == chip_smoke.PEAK_FP32
    assert common.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    run = t2.runs(2048)[0]
    # every GEMM run: 2 B HW H^2 int8 operations, about 2.12 ms
    assert run.int8_ops == 2.0 * 2048 * 4096 * 500 ** 2
    assert run.bound_ms() == pytest.approx(
        chip_smoke.bound(run.nbytes, (run.int8_ops, chip_smoke.PEAK_INT8))[0])
    assert 2.11 < run.bound_ms() < 2.13


@pytest.mark.parametrize("kdim", [0, 1])
def test_pack_s4_puts_the_lower_index_in_the_low_nibble(kdim):
    x = torch.tensor([[-7, 7, -1, 0], [3, -8, 5, -2]], dtype=torch.int8)
    if kdim == 0:
        x = x.t().contiguous()
    p = probes.pack_s4(x, kdim).to(torch.int64)
    lo, hi = p % 16, p // 16
    nib = lambda v: (v.to(torch.int64) + 16) % 16  # noqa: E731
    want_lo, want_hi = ((x[:, 0::2], x[:, 1::2]) if kdim == 1
                        else (x[0::2], x[1::2]))
    assert torch.equal(lo, nib(want_lo)) and torch.equal(hi, nib(want_hi))
    assert torch.equal(probes.int4_values(torch.tensor([7, 8, -9, -8],
                                                       dtype=torch.int8)),
                       torch.tensor([7, -8, 7, -8], dtype=torch.int8))


def _tile_sums(c, bm, bn, groups, steps):
    """Independent numpy form of the kernel's per-block sums: each group's
    step count times its tile's sum, wrapped to 32 bits."""
    m, n = c.shape
    mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
    cp = np.zeros((mp, np_), np.int64)
    cp[:m, :n] = c
    tiles = cp.reshape(mp // bm, bm, np_ // bn, bn).sum(axis=(1, 3))
    counts = np.diff([g * steps // groups for g in range(groups + 1)])
    s = counts[:, None, None] * tiles[None]
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.mark.parametrize("dims,k,steps", [
    (((1,), (0,)), 200, 40), (((1,), (1,)), 900, 5), (((0,), (0,)), 1000, 33)])
def test_gemm_sums_fold_every_step_of_every_block(dims, k, steps):
    rng = np.random.default_rng(1)
    m, n = 130, 70
    code = probes.DIMS[dims]
    a = rng.integers(-127, 128, (k, m) if code == 2 else (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (n, k) if code == 1 else (k, n), dtype=np.int8)
    out, sums = probes.gemm(torch.from_numpy(a), torch.from_numpy(b), dims,
                            steps=steps, out_rows=8)
    x = (a.T if code == 2 else a).astype(np.int64)
    y = (b.T if code == 1 else b).astype(np.int64)
    c = x @ y
    np.testing.assert_array_equal(out.numpy(), c[:8].astype(np.float32))
    bm, bn, _ = probes.gemm_tile(k, "s8")
    assert (bm, bn) == ((64, 32) if k > probes.BIG_MAX_KB else (128, 128))
    groups = probes.step_groups(steps, -(-m // bm) * -(-n // bn))
    np.testing.assert_array_equal(sums.numpy(),
                                  _tile_sums(c, bm, bn, groups, steps))


def test_stores_saturate_int16_and_round_bf16_to_nearest_even():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (128, 512), dtype=np.int8)
    w = rng.integers(-127, 128, (512, 96), dtype=np.int8)
    c = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(c).max() > 32767      # the int16 store must saturate
    for store, f in STORED.items():
        out, sums = probes.gemm(torch.from_numpy(a), torch.from_numpy(w),
                                ((1,), (0,)), steps=3, out_rows=128,
                                store=store)
        np.testing.assert_array_equal(out.numpy(), f(c), err_msg=store)
        np.testing.assert_array_equal(
            sums.numpy(), _tile_sums(f(c).astype(np.int64), 128, 128,
                                     probes.step_groups(3, 1), 3))


def test_build_t_and_transpose_sum_fold_every_block():
    rng = np.random.default_rng(3)
    xT = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    foldT = torch.from_numpy(rng.standard_normal((3, 20, 4))
                             .astype(np.float32))
    out, sums = probes.build_t(xT, foldT, 64)
    h0 = ((foldT[:, :, 0:1].double() * xT[0]).float()
          + (foldT[:, :, 1:2].double() * xT[1]).float()) + foldT[:, :, 2:3]
    col = torch.round(torch.tanh(h0) * 127).sum(1).long()
    assert torch.equal(out, col[-1, -64:].reshape(1, 64).int())
    assert torch.equal(sums, col.reshape(3, 2, 128).sum(-1).int())
    a = torch.from_numpy(rng.integers(-127, 128, (36, 50), dtype=np.int8))
    out, sums = probes.transpose_sum(a, 40)
    col = a.long().sum(0)
    assert torch.equal(out, col.reshape(1, 50).int())
    groups = probes.step_groups(40, 4)
    assert torch.from_numpy(_tile_sums(col.numpy()[None], 1, 16, groups, 40)
                            ).reshape(groups, 4).equal(sums)


def test_step_groups_fill_the_card_and_divide_the_steps():
    assert probes.step_groups(4096, 64) == 16       # T2's 128 x 128 tiles
    assert probes.step_groups(4096, 128) == 8       # its 64 x 32 tiles
    assert probes.step_groups(64, 32) == 4          # T3
    assert probes.step_groups(4, 1) == 1
    for steps, blocks in ((4096, 32), (100, 3), (7, 2)):
        g = probes.step_groups(steps, blocks)
        assert steps % g == 0 and g * blocks <= probes.TARGET_BLOCKS


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    a = torch.zeros((16, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="dimension numbers"):
        probes.gemm(a, a, ((0,), (1,)), steps=1, out_rows=8)
    with pytest.raises(ValueError, match="contraction sizes"):
        probes.gemm(a, a, ((1,), (0,)), steps=1, out_rows=8)
    with pytest.raises(TypeError):
        probes.gemm(a.float(), a.t(), ((1,), (0,)), steps=1, out_rows=8)
    with pytest.raises(ValueError, match="a store takes"):
        probes.gemm(a, a.t(), ((1,), (0,)), steps=1, out_rows=8,
                    store="int16")
    with pytest.raises(ValueError, match="out_rows"):
        probes.gemm(a, a.t(), ((1,), (0,)), steps=1, out_rows=17)
    with pytest.raises(ValueError, match="multiple of 128"):
        probes.build_t(torch.zeros((4, 100)), torch.zeros((1, 5, 4)), 50)
    with pytest.raises(ValueError, match="even"):
        probes.pack_s4(torch.zeros((3, 3), dtype=torch.int8), 1)
