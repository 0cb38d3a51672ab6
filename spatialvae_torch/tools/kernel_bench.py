"""The int8 decoder's and loss kernel's parts, each timed alone on the card
-- the port of ``tools/kernel_bench.py``.

    python -m spatialvae_torch.tools.kernel_bench [pt=2048] [iters=30]
        [b=2048] [hw=4096] [only=name,...] [device=cpu]

Runs the TPU tool's seventeen runs at its defaults, the galaxy decoder at
full width (B=2048, HW=4096, H=500, No=3, pt=2048: a grid of (2048, 2),
4,096 steps per call), in its order:

  gemm1         one int8 (pt, H) x (H, H) product per step: the GEMM floor
  gemm2         the backward's two products per step (dW, da0)
  gemm1+vpu     the product fed by the a0 chain (build, quantise), then a1
  vpu-only      the chain alone, rows kept
  gemm1+ivpu    a product beside a chain it does not depend on
  gemm1+ivpu2   the same, every chain value consumed by column sums
  vpu-full      the chain alone, column sums
  fwd-nores     the whole int8 forward without the a1 output (K4)
  fwd-pipe2/4   the forward with the bf16 a1 written, 2 or 4 sub-tiles per
                block in the pipelined prototype's order
  fwd           the int8 forward (K4)
  gemm3         the fused loss kernel's three products per step
  fused-plain   the loss and gradient with each step's own scale
  fused-loss    the fused loss kernel (K3, at the numerics the environment
                sets)
  fused-t       the feature-major loss kernel (K8)
  bwd           the int8 backward, a1 rebuilt (K5)
  bwd-fixscale  the backward from a bf16 a1 with a constant scale

Every run goes through the hand-written kernels of
``spatialvae_torch/kernels/kernel_bench.py`` (or ``probes.gemm`` and the
K3, K4, K5, K8 wrappers).  ``only=`` selects runs by name prefix, as the
TPU tool's ``want`` does, ``fwd`` only by its exact name; ``gemm1`` and
``bwd`` run here, which the TPU tool's guards never let run.  Each prints
one line: its ms per call (CUDA events over ``iters`` calls after a
warm-up; the host clock with ``device=cpu``), the TPU tool's images per
second (B per call) and its bound on the card.  Without a card and without
``device=cpu`` it raises.  The inputs follow the TPU tool's recipe, drawn
from numpy seed 0 (the bf16 a1 that bwd-fixscale reads from a CUDA or CPU
generator seeded 0).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spatialvae_torch.kernels import fused_decoder_int8 as d8
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels import fused_loss_int8_t as lt
from spatialvae_torch.kernels import kernel_bench as kb
from spatialvae_torch.kernels import probes
from spatialvae_torch.kernels.config import knobs_allowed
from spatialvae_torch.tools.common import (
    Run,
    backend,
    float_ops,
    int_mm_call,
    parse_argv,
    time_ms,
    wanted,
)

B, HW, H, NO = 2048, 4096, 500, 3
SEED = 0
USAGE = ("python -m spatialvae_torch.tools.kernel_bench [pt=2048] "
         "[iters=30] [b=2048] [hw=4096] [only=name,...] [device=cpu]")
D10 = ((1,), (0,))
RUNS = ("gemm1", "gemm2", "gemm1+vpu", "vpu-only", "gemm1+ivpu",
        "gemm1+ivpu2", "vpu-full", "fwd-nores", "fwd-pipe2", "fwd-pipe4",
        "fwd", "gemm3", "fused-plain", "fused-loss", "fused-t", "bwd",
        "bwd-fixscale")
# images of the bf16 a1 drawn at a time (bounds the f32 draw's memory)
A1_CHUNK = 64


def selected(name: str, only) -> bool:
    """The TPU tool's selection: by prefix, ``fwd`` by its exact name."""
    if name == "fwd":
        return only is None or "fwd" in only
    return wanted(name, only)


def make_arrays(b: int, hw: int, pt: int, device, seed: int = SEED) -> dict:
    """The TPU tool's inputs from a numpy seed: normal fold (B, 4, H),
    coords (HW, 2), w1 * 0.05, b1 * 0.1, wht * 0.1, bht * 0.1, g (B, No,
    HW); a0q_tile = clip(round(60 n), -127, 127) (pt, H) int8; targets yt
    uniform on [0, 1) (B, No, HW).  Derived: W1q, sw (K4's quant_sym), wht
    in bf16, the feature-major fold (B, H, 4) and K4's weights."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    arrays = dict(
        fold=f32(rng.standard_normal((b, 4, H))),
        coords=f32(rng.standard_normal((hw, 2))),
        w1=f32(rng.standard_normal((H, H)) * 0.05),
        b1=f32(rng.standard_normal(H) * 0.1),
        wht=f32(rng.standard_normal((NO, H)) * 0.1),
        bht=f32(rng.standard_normal(NO) * 0.1),
        g=f32(rng.standard_normal((b, NO, hw))),
        a0q_tile=np.clip(np.round(rng.standard_normal((pt, H)) * 60), -127,
                         127).astype(np.int8),
        yt=f32(rng.random((b, NO, hw))))
    out = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return with_derived(out)


def with_derived(arrays: dict) -> dict:
    """``arrays`` with w1q, sw (1,), the bf16 head weights, foldT and K4's
    weight record added."""
    w1q, sw = d8.quant_sym(arrays["w1"])
    arrays.update(w1q=w1q, sw=sw.reshape(1),
                  wht_bf16=arrays["wht"].bfloat16(),
                  foldT=arrays["fold"].transpose(1, 2)[:, :, :4].contiguous(),
                  k4=d8.Int8Weights(arrays["w1"], arrays["b1"], arrays["wht"],
                                    arrays["bht"]))
    return arrays


def make_a1(b: int, hw: int, h: int, device, seed: int = SEED):
    """bwd-fixscale's residual: bf16(tanh(n)) of normal n (B, HW, H), drawn
    on ``device`` from a generator seeded ``seed``, A1_CHUNK images at a
    time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a1 = torch.empty((b, hw, h), dtype=torch.bfloat16, device=device)
    for b0 in range(0, b, A1_CHUNK):
        n = min(A1_CHUNK, b - b0)
        a1[b0:b0 + n] = torch.tanh(torch.randn(
            (n, hw, h), generator=gen, device=device)).bfloat16()
    return a1


def _y(arr) -> dict:
    """The bwd runs' y: K4's forward of the tool's inputs (K4 on the
    card)."""
    return {"y": d8.run_int8_tail(arr["fold"], arr["coords"],
                                  arr["k4"]).contiguous()}


def runs(b: int, hw: int, pt: int) -> list:
    """The TPU tool's seventeen runs in its order (module docstring); each
    ``fn`` and ``plain`` returns (outputs, per-block sums)."""
    steps = kb.grid_steps(b, hw, pt)
    n = b * hw                                  # pixels per call
    e = float(n) * H                            # (pixel, hidden) elements
    gemm_ops = 2.0 * e * H                      # one int8 product per step
    # device-memory bytes of the inputs and outputs (each moved once)
    first = hw * 2 * 4 + b * 4 * H * 4          # coords, fold
    w1q = H * H
    head_in = H * 4 + 4 + NO * H * 4 + NO * 4   # b1, sw, wht, bht
    y_bytes = n * NO * 4
    grads = b * 4 * H * 4 + H * H * 4 + H * 4 + NO * H * 4 + NO * 4
    a1_bytes = e * 2
    out_rows = 8 * H * 4

    def no_sums(fn):        # a run whose outputs are whole
        return lambda arr: (fn(arr), ())

    def one(fn):
        return lambda arr: ((fn(arr),), ())

    def gemm1(fn):
        return lambda arr: tuple(
            (x,) for x in fn(arr["a0q_tile"], arr["w1q"], D10, steps=steps,
                             out_rows=8))

    def multi(fn, run):
        return lambda arr: tuple((x,) for x in fn(
            run, arr["a0q_tile"], arr["a0q_tile"], arr["w1q"], steps))

    def chain(fn, mode, gemm=False, dep=False):
        def call(arr):
            return fn(mode, arr["fold"], arr["coords"], pt,
                      w1q=arr["w1q"] if gemm else None,
                      sw=arr["sw"] if dep else None,
                      b1=arr["b1"] if dep else None,
                      aq=arr["a0q_tile"] if gemm and not dep else None)
        return call

    def int_mm_library(names):
        def lib(arr):
            a, w_ = arr["a0q_tile"], arr["w1q"]
            operands = {"h1": (a, w_), "dw": (a, a), "da": (a, w_)}
            calls = [int_mm_call(*operands[p], kb._LAYOUTS[p][0])
                     for p in names]
            return lambda: [c() for c in calls]
        return lib

    def k4(arr):
        return d8.run_int8_tail(arr["fold"], arr["coords"], arr["k4"])

    def k4_plain(arr):
        return d8.decoder_tail_int8_reference(
            arr["fold"], arr["coords"], arr["w1q"], arr["sw"].reshape(()),
            arr["b1"], arr["wht"], arr["bht"])

    def pipe(s):
        return lambda arr: kb.fwd_pipe(
            s, arr["fold"], arr["coords"], arr["w1q"], arr["sw"], arr["b1"],
            arr["wht"], arr["bht"], pt)

    def pipe_plain(arr):
        return kb.fwd_pipe_reference(
            arr["fold"], arr["coords"], arr["w1q"], arr["sw"], arr["b1"],
            arr["wht"], arr["bht"])

    def plain_loss(fn):
        return lambda arr: fn(arr["fold"], arr["coords"], arr["w1q"],
                              arr["sw"], arr["b1"], arr["wht_bf16"],
                              arr["bht"], arr["yt"], pt)

    def k3(fn):
        return lambda arr: fn(arr["fold"], arr["coords"], arr["w1"],
                              arr["b1"], arr["wht"], arr["bht"], arr["yt"])

    def k8(fn):
        return lambda arr: fn(arr["foldT"], arr["coords"], arr["w1"],
                              arr["b1"], arr["wht"], arr["bht"], arr["yt"])

    def k5(fn):
        return lambda arr: fn(arr["fold"], arr["coords"], arr["k4"], None,
                              arr["y"], arr["g"])

    def k5_plain(arr):
        return d8.decoder_tail_int8_backward_reference(
            arr["fold"], arr["coords"], arr["w1q"], arr["sw"].reshape(()),
            arr["b1"], arr["wht"], None, arr["y"], arr["g"])

    def fix(fn):
        return lambda arr: fn(arr["fold"], arr["coords"], arr["w1q"],
                              arr["sw"], arr["wht"], arr["a1"], arr["y"],
                              arr["g"], pt)

    def fix_prepare(arr):
        out = _y(arr)
        out["a1"] = make_a1(b, hw, H, arr["fold"].device)
        return out

    chain_bytes = first + 32 * H
    loss_bytes = first + w1q + head_in + y_bytes + hw * 4 * 2 + grads
    out = [
        Run("gemm1", ("a0q_tile", "w1q"), gemm1(probes.gemm),
            gemm1(probes.gemm_reference), steps,
            float(pt * H + w1q + out_rows), int8_ops=gemm_ops,
            gemm=(D10, "s8", H, None), library=int_mm_library(("h1",))),
        Run("gemm2", ("a0q_tile", "a0q_tile", "w1q"),
            multi(kb.gemm_multi, "gemm2"),
            multi(kb.gemm_multi_reference, "gemm2"), steps,
            float(2 * pt * H + w1q + out_rows), int8_ops=2 * gemm_ops,
            library=int_mm_library(kb.PRODUCTS["gemm2"])),
        Run("gemm1+vpu", ("coords", "fold", "w1q", "sw", "b1"),
            chain(kb.chain, "dep", True, True),
            chain(kb.chain_reference, "dep", True, True), steps,
            float(chain_bytes + w1q + head_in + out_rows),
            int8_ops=gemm_ops, f32_ops=float_ops(e, "chain", "epilogue")),
        Run("vpu-only", ("coords", "fold"), chain(kb.chain, "rows"),
            chain(kb.chain_reference, "rows"), steps, float(chain_bytes),
            f32_ops=float_ops(e, "chain")),
        Run("gemm1+ivpu", ("coords", "fold"),
            chain(kb.chain, "ind_rows", True),
            chain(kb.chain_reference, "ind_rows", True), steps,
            float(chain_bytes + pt * H + w1q + out_rows), int8_ops=gemm_ops,
            f32_ops=float_ops(e, "chain")),
        Run("gemm1+ivpu2", ("coords", "fold"),
            chain(kb.chain, "ind_sums", True),
            chain(kb.chain_reference, "ind_sums", True), steps,
            float(first + H * 4 + pt * H + w1q + out_rows),
            int8_ops=gemm_ops, f32_ops=float_ops(e, "chain")),
        Run("vpu-full", ("coords", "fold"), chain(kb.chain, "sums"),
            chain(kb.chain_reference, "sums"), steps,
            float(first + H * 4), f32_ops=float_ops(e, "chain")),
        Run("fwd-nores", ("coords", "fold", "w1q", "sw", "b1", "wht", "bht"),
            one(k4), one(k4_plain), steps,
            float(first + w1q + head_in + y_bytes), int8_ops=gemm_ops,
            f32_ops=float_ops(e, "chain", "epilogue", head=NO)),
    ]
    for s in kb.PIPE_SUB_TILES:
        out.append(Run(
            f"fwd-pipe{s}", ("coords", "fold"), no_sums(pipe(s)),
            no_sums(pipe_plain), steps,
            float(first + w1q + head_in + y_bytes + a1_bytes),
            int8_ops=gemm_ops,
            f32_ops=float_ops(e, "chain", "epilogue", head=NO)))
    loss_ops = dict(int8_ops=3 * gemm_ops, f32_ops=float_ops(
        e, "chain", "epilogue", "grad", head=3 * NO))
    out += [
        Run("fwd", ("fold", "coords"), one(k4), one(k4_plain), steps,
            float(first + w1q + head_in + y_bytes), int8_ops=gemm_ops,
            f32_ops=float_ops(e, "chain", "epilogue", head=NO)),
        Run("gemm3", ("a0q_tile", "a0q_tile", "w1q"),
            multi(kb.gemm_multi, "gemm3"),
            multi(kb.gemm_multi_reference, "gemm3"), steps,
            float(2 * pt * H + w1q + out_rows), int8_ops=3 * gemm_ops,
            library=int_mm_library(kb.PRODUCTS["gemm3"])),
        Run("fused-plain", ("fold", "coords"),
            no_sums(plain_loss(kb.fused_plain)),
            no_sums(plain_loss(kb.fused_plain_reference)), steps,
            float(loss_bytes), **loss_ops),
        Run("fused-loss", ("fold", "coords"), no_sums(k3(l8.run_loss_int8)),
            no_sums(k3(l8.loss_int8_reference)), steps, float(loss_bytes),
            **loss_ops),
        Run("fused-t", ("foldT", "coords"), no_sums(k8(lt.run_loss_int8_t)),
            no_sums(k8(lt.loss_int8_t_reference)), steps, float(loss_bytes),
            **loss_ops),
        Run("bwd", ("fold", "coords"),
            no_sums(k5(d8.run_int8_tail_backward)), no_sums(k5_plain), steps,
            float(first + w1q + head_in + 2 * y_bytes + grads),
            int8_ops=3 * gemm_ops,
            f32_ops=float_ops(e, "chain", "epilogue", "grad", head=2 * NO),
            prepare=_y),
        Run("bwd-fixscale", ("fold", "coords"),
            no_sums(fix(kb.bwd_fixscale)),
            no_sums(fix(kb.bwd_fixscale_reference)), steps,
            float(first + w1q + NO * H * 4 + 4 + a1_bytes + 2 * y_bytes
                  + b * 4 * H * 4 + H * H * 4),
            int8_ops=2 * gemm_ops,
            f32_ops=float_ops(e, "chain", "grad", head=NO),
            prepare=fix_prepare),
    ]
    assert tuple(r.name for r in out) == RUNS
    return out


def main(argv=None) -> int:
    vals, dev = parse_argv(sys.argv[1:] if argv is None else argv,
                           {"pt": 2048, "iters": 30, "b": B, "hw": HW},
                           USAGE, lists=("only",))
    # a measurement entry point: off-default kernel knobs are allowed while
    # it runs
    with knobs_allowed():
        _run(dev, **vals)
    return 0


def _run(dev, pt, iters, b, hw, only) -> None:
    arrays = make_arrays(b, hw, pt, dev)
    steps = kb.grid_steps(b, hw, pt)
    print(f"# B={b} HW={hw} H={H} pt={pt} grid=({b}, {hw // pt}) "
          f"({steps} steps/iter), iters={iters} backend={backend(dev)}",
          flush=True)
    for run in runs(b, hw, pt):
        if not selected(run.name, only):
            continue
        extra = run.prepare(arrays) if run.prepare else {}
        arrays.update(extra)
        ms = time_ms(run.fn, arrays, iters)
        print(f"{run.name:14s} {ms:7.2f} ms/iter ({b / ms * 1e3:9.0f} "
              f"img-equiv/s)  bound {run.bound_ms():.4g} ms", flush=True)
        for k in extra:
            del arrays[k]
        if dev.type == "cuda":
            torch.cuda.empty_cache()

if __name__ == "__main__":
    sys.exit(main())
