#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --limits   # the int8 kernels' limit readings
    python3 chip_smoke.py --limits numerics   # those of K3 (e)-(g), K8
    python3 chip_smoke.py --limits k3         # K3's, both designs
    python3 chip_smoke.py --limits wide       # those of the wide path
    python3 chip_smoke.py --limits probes     # those of the probe kernels
    python3 chip_smoke.py --limits kernel_bench   # those of T1's kernels
    python3 chip_smoke.py --limits dec90      # K1/K2's cluster kernels'
                                              # (both sources)
    python3 chip_smoke.py --limits adam       # Adam's step kernel
    python3 chip_smoke.py --split dec90       # their product/epilogue split
    python3 chip_smoke.py --sweep dec90       # both designs over H and Lh
    python3 chip_smoke.py --sweep k3          # K3's designs past H = 512
    python3 chip_smoke.py --default-width PARENT_DIR   # K1-K5 A/B
    python3 chip_smoke.py --sass PARENT_DIR   # untouched kernels' SASS
    python3 chip_smoke.py --phase cli_particles   # the particles CLI alone
    python3 chip_smoke.py --phase cli_images   # the galaxy and mnist CLIs
    python3 chip_smoke.py --phase horizon   # the int8 horizon gate, 3 epochs
    python3 chip_smoke.py --phase parallel  # the mesh's arms alone

Builds the port's CUDA kernels from ``spatialvae_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card (the float
decoder forward with and without its activation output and its backward
with the residual and with recompute; the fused int8 loss and gradient in
each of its families, Bernoulli, Gaussian, colored and over padded pixel
counts; the int8 decoder forward and backward; Adam, the step kernel and
the per-leaf K6 on every galaxy leaf in the three training configurations
and K7 with the emission helpers on the two big encoder weights, bit for
bit, timed in turns), then drives the galaxy model (64x64
RGB, z=20, encoder 12288->5000->5000->46, spatial decoder 500 wide, 2
layers, 3 outputs, Bernoulli; random weights from a seed) through its
paths:

- serving (float32), through ``spatialvae_torch.api.SpatialVae``:
  checkpoint write and load, encode, reconstruct, reconstruct_canonical,
  sample and a 437-image evaluation, with every output checked, and one
  more pass of the requests under ``torch.profiler`` for the card's busy
  time and idle share;
- float training, through ``spatialvae_torch.train.trainer.Trainer`` (Adam
  at lr 1e-4, batch 100) on 1,037 synthetic images made on the card from
  the seed: an evaluation, two epochs (22 steps), another evaluation that
  must score higher, the optimizer checkpoint's round trip, one step
  through the kernels against the same step through the plain decoder, and
  one profiled step;
- int8 training with bf16 compute (``bench.py``'s default galaxy step, the
  TPU's whole stack: the bf16 shadow weights that Adam writes, the int8
  encoder with the int8 copies Adam emits and the int8 data copy): the
  same two epochs, where the 20 full batches take the fused int8 loss
  kernel and the two tails of 37 the int8 decoder and its backward, every
  step ends in one launch of Adam's step kernel (K6 on every leaf), the
  evaluations take the int8 forward; a step of each kind against the plain
  versions, profiled steps, an epoch of 16 steps at B=4096 with bf16 Adam
  moments, and an epoch under
  ``SPATIALVAE_ADAM_EMIT=pallas``, where the big weights take K7;
- int8 training with bf16 compute of the three other models ``bench.py``
  builds, each at full width on 1,037 synthetic images: **particles**
  (64x64 grayscale, z=20, encoder 4096->5000->5000->46, Gaussian
  likelihood, unit-disc pixel mask, whitened images), **colored** (the same
  with the fit-noise head, ``n_out=2``) and **mnist** (28x28 on the /255
  grid, z=2, encoder 784->500->500->10, Bernoulli, theta prior pi/4 with
  the mean penalty, 784 pixels padded to 1,024).  The 20 full batches take
  the fused int8 loss kernel in the model's family (Gaussian, colored,
  padded Bernoulli), the tails K4 and K5 at ``n_out`` 1 and 2 with the
  likelihood in PyTorch; a K3 step and a tail step against the plain
  versions, a profiled K3 step, for particles and colored one float step
  through K1/K2 against the plain decoder, and for colored a checkpoint
  round trip and a ``SpatialVae`` reconstruct of the predicted mean;
- the int8 galaxy trainer (bf16 compute, the same seed and images) under
  the numerics knobs of the JAX package's measurement entry points, with
  ``SPATIALVAE_ALLOW_KNOBS=1``: stochastic rounding (``SPATIALVAE_SR=1``,
  ``[train_int8_sr]``), the int8 gradient tiles with the f32 epilogue
  (``[train_int8_numerics]``), and the feature-major kernel K8
  (``SPATIALVAE_LOSS_LAYOUT=t`` on images off the /255 grid,
  ``[train_int8_t]``): two epochs each, launch counts, ELBO rise, a step
  against its plain-version step.  Before the paths, K3's stochastic
  rounding (``[kernel_loss_sr]``: on the cluster passes, in turns with the
  block passes, at the galaxy shape, in the Gaussian, padded and colored
  families and at B=4,096; the quantised tiles against the plain
  version's, which draws the same Philox words), its other numerics
  (``[kernel_loss_numerics]``) and K8 (``[kernel_loss_t]``, at the galaxy
  shape and at mnist's 784 pixels) are held against their plain versions.

- decoders of any width and depth: every kernel at H = 512, 513, 768,
  1,000, 1,024, 2,048 and 4,100 against its plain version
  (``[kernel_wide]``: K1 with and without activations and K2 both
  variants in f32 and bf16, above 512 on the deep sm90 kernels
  (``csrc/fused_decoder_sm90_deep.cu``) and on the tile kernels, K3 in its
  four families, K4, K5, K8; timed at H = 1,000, B = 100, K1/K2's two
  designs in turns), the galaxy model with a decoder 1,000 wide trained
  two float and two int8 epochs (``[train_wide]``) and served from its
  checkpoints (``[slice_wide]``, a profiled pass), and with a decoder of
  four layers (``--p_num_layers 4``: three hidden layers, K1/K2's deep
  kernels a pass per layer; ``[kernel]`` and ``[kernel_bwd]`` time them at
  B = 100 in turns with the tile kernels) trained two epochs in f32, with
  bf16 compute and in int8 mode, whose decoder then runs K1/K2
  (``[train_deep]``), and served (``[slice_deep]``);
- K3's measurement levers (``SPATIALVAE_DB1=qi``, ``SPATIALVAE_A1Q``,
  ``SPATIALVAE_TANH=pade`` and a pair; ``[kernel_loss_levers]``), the
  ``SPATIALVAE_PHASE_CUT`` ladder 3..8 (``[kernel_loss_ladder]``: the cut
  phases launch nothing) and two epochs of the int8 galaxy trainer under
  ``DB1=qi`` with ``A1Q=1`` (``[train_int8_levers]``); ``[default_width]``
  sums up K1-K5 at H = 500;
- the port's probe tools at their defaults (``[probe_int4]``: the int4
  GEMMs in every contraction layout, 2,048 x 4,096 / 2,048 steps of a
  (2,048, 500) x (500, 500) product, through the s8 and the s4 arm, the
  feature-major first layer and the transpose; ``[probe_i16acc]``: the
  accumulator stored as int32, int16, bf16 or f32), each through
  ``python -m spatialvae_torch.tools.<tool>``'s ``main`` (the launches),
  then every run against its plain version (0 words may differ), with its
  bound, the library call's time and each GEMM kernel's IMMA count in the
  library's SASS;
- the particles CLI (``[cli_particles]``), ``python -m
  spatialvae_torch.cli.train_particles``'s ``main`` in process at its
  full-width defaults (z=2, p and q 500 wide, 2 layers, B=100) on 8,192
  training and 1,024 test 40x40 particles written from the seed to
  ``.mrc`` files with CTF tables, two epochs in each of four arms (float
  with mask and normalisation; CTF with the colored likelihood; the same
  in int8 mode, on K4/K5 and never K3; rotation augmentation in int8
  mode, on K3, and with ``--int8-sr``, on K3's SR kernels) and a resume
  of the first for a third epoch: each arm's
  launches counted from 0, its TSV, seconds per epoch and the checkpoints
  of every interval read back by ``SpatialVae.load``; before the arms,
  ``[cli_kernels]`` holds every kernel they launch to its plain version
  at their own shapes (K1/K2 at B=100 and the tail of 92, K1 alone at the
  evaluation's 100 and 24, K3's Gaussian family over 1,600 pixels padded
  to 1,792 under the CLI's circular mask, K4/K5 over coords padded to
  1,792, one and two outputs, float32 weights); ``[cli_ctf]`` holds
  ``apply_ctf`` to the grouped conv2d in float64 at B=100 with the run's
  39x39 kernels and the bicubic rotation to its CPU result, and
  ``[tail_cache]`` times the float decoder's no-grad K1 after an Adam
  step's version bump; a sixth arm trains the vanilla generator with the
  fit-noise head and channel 0's double softplus (Adam's step kernel
  alone); the long runs' arms: (a) and (d) streamed from the host
  (``--no-preload``), (c) with bf16 Adam moments saved every epoch and
  resumed from its epoch-1 files, (a) under ``--profile-dir`` (the trace
  must name K1/K2's and Adam's kernels) and under ``--debug-nans``; each
  arm's peak device memory, and ``[cli_same]`` holds the streamed float,
  resumed, traced and checked arms to their model arm's rows;
- the galaxy and mnist CLIs (``[cli_images]``), ``python -m
  spatialvae_torch.cli.train_galaxy`` / ``train_mnist``'s ``main`` in
  process at full width from files the phase writes from the seed (4,000
  + 1,000 galaxy blob images at 64x64x3; 60,000 + 10,000 digit-like
  glyphs at 50x50 rotated and translated, at 28x28 rotated, and at 28x28
  in MNIST's idx files), every arm with ``--save_interval 1``: (a) galaxy
  z=20 with rotation augmentation, B=64, four epochs (K1/K2); (b) the
  same in int8 mode with bf16 compute (K3, K4, K1 for the display decodes
  alone); (c) the galaxy vanilla generator (Adam alone); (d) the
  rotated-and-translated digits at the CLI's defaults (K1/K2); (e) the
  vanilla generator on the idx files, z=100, B=64 (Adam alone); (f) the
  rotated digits in int8 mode (K3 over 784 pixels padded to 1,024, K4):
  each arm's launches from 0 against its set, its TSV and validation
  ELBOs, seconds per epoch, the time of the run's end and of its archive,
  and the ``outputs_{prefix}`` tree checked file by file (each PNG's
  signature, chunk CRCs and grid size, the SVGs as XML, the checkpoint
  pair through ``SpatialVae.load``, the zip's members);
- the int8 horizon gate (``[horizon]``): ``python -m
  spatialvae_torch.tools.int8_horizon``'s ``main`` at full width and its
  defaults (B=1,024, 8 steps an epoch) for three epochs of each arm, the
  launches from 0 (K1/K2 in the bf16 arm, K3's cluster passes in the int8
  arm, Adam's step kernel once a step), the gaps, Adam's step kernel on
  each arm's leaves; before it ``[horizon_kernels]`` holds K1/K2 and K3
  (bf16 and int8 targets, the colored family under the mask) at B=1,024
  to their plain versions run in 128-image chunks;
- the mesh (``[parallel]``, ``spatialvae_torch/parallel/``): ranks that
  share the card, joined over gloo, train the galaxy model in int8 (bf16
  compute) at B=1,024: (a) data parallelism on 2 ranks, the ranks' state
  bit for bit, the gradients against one device's on the same rows, the
  step metrics against one device's within a limit that refuses the same
  steps' unreduced metrics; (b) K3 on each rank's 2,048-pixel slice
  summed against the whole call (default and SR, the SR words equal) and
  the pixel step on 2 x 2 ranks; (c) the mesh evaluation (K4, K1)
  against one device's; (d) colored data parallelism; (e) a one-rank NCCL
  world's step bit for bit against one device's.  Every rank counts its
  launches from 0 around the mesh's own run (K3 on the cluster keys) and
  every rank of a mesh must count the same;
- the port's int8 kernel microbenchmark (``[kernel_bench]``: the TPU tool
  ``tools/kernel_bench.py``'s seventeen runs at its defaults, B=2,048,
  HW=4,096, H=500, pt=2,048, through
  ``python -m spatialvae_torch.tools.kernel_bench``'s ``main``: the GEMM
  floors, the a0 chain alone and beside a GEMM, the forwards with and
  without the a1 output, the loss and backward runs), then every run
  against its plain version at 32 images, the grid in several step
  groups (integer outputs and per-block sums in every word, float ones
  within limits), its ms at the defaults, bound and library ms, and the
  backward and loss runs' passes from one traced call each.

K3's default-mode calls (the bench configuration and the Gaussian, colored
and padded families at the default numerics, H <= 512) run the cluster
passes of ``csrc/fused_loss_int8_sm90.cu``, and its calls under stochastic
rounding alone their SR instantiations (``csrc/fused_loss_int8_sm90_sr.cu``);
``[k3_sm90]`` holds their
pieces alone (the a0 chain's thresholds at all 2^32 inputs, the product on
the cluster ring word for word, the resident clusters), and
``[kernel_loss_int8]``, ``[kernel_loss_families]``, ``[kernel_bench]``
(T1's fused-loss at B=2,048 and its traced passes), ``[train_int8_bench]``
and ``[train_colored_int8_bench]`` (B=4,096: bench.py's galaxy and colored
steps) time them in turns with the block passes (``run_loss_int8(...,
block_passes=True)``: block, cluster, cluster, block).

Each phase prints its lines; the last three lines are the per-kernel JSON
record (launches on the main path, times, plain-version time, bound,
library-call time), the card's name and power limit, and
``{"ok": true, ...}``.  ``--limits`` prints the kernels' readings for the
sound build and for copies built with one step removed; ``--limits
numerics`` only those of K3's modes, levers and K8 (SR's three copies,
db1 from the pre-round q, the Pade lever on the exact tanh, A1Q at a
per-block scale);
``--limits k3`` only K3's readings on the cluster passes and on the block
passes (rounding toward zero, a scale per 64-pixel block, the cluster
passes' colored pairs formed with the wrong partner, and SR's copies: the
gradient site on the forward site's words, u = 0, the cluster passes'
counters in the dW1 workspace's row order, each of which SR's cluster
readings must refuse); ``--limits wide`` those of the wide path (its
ragged last chunk skipped, one TF32 pass); ``--limits dec90`` K1/K2's
sm90 kernels at the default shape and the deep kernels' wide and deep
cases in the sound build and five faulty copies (one TF32 product, no
bf16 casts, the head's partials of a tile's last column chunk dropped,
layers above the first reading a stale A buffer, one TF32 product in the
deep kernels alone), which the limits must refuse; ``--limits probes``
those of the probe kernels (the last k slab dropped, the int16 store
wrapping, a 4 x 4 byte transpose with two rows swapped); ``--limits
kernel_bench`` those of T1's kernels (the a1 scale without /127,
fused-plain's scale per 64-pixel block,
bwd-fixscale's dh1 without (1 - a1^2)); ``--limits adam`` Adam's step
kernel against its plain version, bit for bit, in the sound build and in
two faulty copies (b1*m contracted into an FMA, the plain-load tails
dropped), which the compare must refuse.  ``python3 chip_smoke.py
--default-width PARENT`` times K1-K5 at the default width in turns in this
checkout and in the parent's (a directory holding it), each turn a process
of its own tree; ``--sass PARENT`` compares the SASS of the translation
units this checkout left as they were (SASS_UNITS) with the parent's;
``--sweep dec90`` times K1/K2's two designs in turns over widths and
depths, the measurement ``fused_decoder.DEEP_MIN_WIDTH`` comes from;
``--sweep k3`` times K3's two designs in turns over widths past 512, the
measurement behind ``fused_loss_int8.k3_route``'s cluster route there.

Needs a CUDA device and ``nvcc``; imports no JAX.  Exits non-zero, without
the final line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
DEVICE = "cuda"
# Kernel vs plain version: limits on the largest and on the mean absolute
# error, by weight dtype.  On the card (PERF.md, Findings) the sound kernel
# read max <= 9.6e-7 and mean <= 1.9e-7 in f32, max <= 2.5e-4 and mean
# <= 1.9e-6 with bf16 weights; copies of it with one TF32 pass or unsplit
# activations read max >= 3.3e-5 and mean >= 6.4e-6, and copies without
# the bf16 activation casts mean >= 2.5e-5.
TOL = {"float32": (5e-6, 1e-6), "bfloat16": (5e-4, 1e-5)}
# The emitting forward's activations a_l = tanh(h_l): absolute limits (max,
# mean) by weight dtype; tanh passes h's error on undamped where the
# sigmoid head quarters it, so they are wider than TOL.
ACTS_TOL = {"float32": (5e-5, 5e-6), "bfloat16": (1e-2, 1e-5)}
# The backward's outputs differ in scale, so each is held
# by its error relative to its largest value: limits on the largest and on
# the mean of that, by weight dtype and variant, placed between the sound
# kernels' readings and those of copies with a precision step removed
# (PERF.md, Findings, PR 2).
BWD_TOL = {("float32", "residual"): (2e-4, 1e-5),
           ("float32", "recompute"): (2e-4, 1e-5),
           ("bfloat16", "residual"): (1e-3, 8e-5),
           ("bfloat16", "recompute"): (1.5e-3, 3e-4)}
# One training step through the kernels against the plain decoder: every
# gradient leaf, relative to its largest value (same placement).
STEP_TOL = (2e-4, 3e-5)
N_TIMED = 10
N_PASSES = 5        # timed passes of the slice's requests
FWD_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_fwd.cu"
BWD_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_bwd.cu"
# K1 and K2 on clusters (fused_decoder.decoder_route "sm90": one hidden
# layer at most 512 wide in DEC90_SOURCE, every other width and depth in
# DEC90_DEEP_SOURCE's layer passes); the tile kernels ("tile") are their
# yardstick, run with tile_kernels=True in turns: tile, sm90, sm90, tile
DEC90_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_sm90.cu"
DEC90_DEEP_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_sm90_deep.cu"
AB_DEC = ("tile", "sm90", "sm90", "tile")
FWD_REPLACES = "spatialvae_tpu/kernels/fused_decoder.py:105"
BWD_REPLACES = "spatialvae_tpu/kernels/fused_decoder.py:196"

# galaxy: README `train_galaxy.py ... -z 20`, bench.py's default config
IMAGE = (64, 64)
CHANNELS = 3
Z_DIM = 20
Q_HIDDEN = 5000
P_HIDDEN = 500
P_LAYERS = 2        # the decoder's layers: the fold's and Lh = 1 hidden
BATCH = 100
N_EVAL = 437        # 4 full batches of 100 and a tail of 37
N_TRAIN = 1037      # 10 full batches of 100 and a tail of 37
TRAIN_EPOCHS = 2


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, torch) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def check_close(name, got, want, wdt) -> tuple:
    """(max, mean) absolute error of got against want; raises past TOL."""
    d = (got - want).abs()
    err, mean_err = d.max().item(), d.mean().item()
    tol = TOL[str(wdt).replace("torch.", "")]
    if not (err <= tol[0] and mean_err <= tol[1]):
        raise AssertionError(f"{name}: kernel vs plain max abs err {err}, "
                             f"mean {mean_err}; limits {tol}")
    return err, mean_err


def phase_device(torch) -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        nvidia_smi=repr(card))
    return name, card


def phase_build() -> None:
    from spatialvae_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.load_library()
    seconds = time.perf_counter() - t0
    # the wide kernels' workspaces: none up to 512, some past it
    if lib.svt_fused_decoder_ws_block(512) or lib.svt_int8_ws_block(512) \
            or not (lib.svt_fused_decoder_ws_block(513)
                    and lib.svt_int8_ws_block(513)):
        raise RuntimeError("the library's width threshold is not 512")
    log("build", seconds=f"{seconds:.2f}", library=path.name,
        sources=len(_build.sources()))


def start_ptxas_report(source: str, defines: tuple = ()):
    """``nvcc -Xptxas -v`` on ``source`` (the library's flags and
    ``defines``, the object thrown away), started in the background:
    ptxas's registers, stack, spills and shared memory per kernel, read by
    ``ptxas_report``."""
    from spatialvae_torch.kernels import _build

    out = os.path.join(tempfile.gettempdir(), f"ptxas_{os.getpid()}_"
                       f"{len(defines)}_{os.path.basename(source)}.o")
    return out, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-c",
         "-o", out, source], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def ptxas_report(started, serialized=None) -> list:
    """[(kernel, registers, stack bytes, spill stores, spill loads)] from
    ``start_ptxas_report``'s compile; raises if it failed.  ``serialized``
    (a dict), if given, gets kernel -> the codes of ptxas's "wgmma ...
    serialized" notes on it."""
    import re

    out, proc = started
    text, _ = proc.communicate()
    if os.path.exists(out):
        os.remove(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{text[-3000:]}")
    rows, name, spill = [], None, None
    for line in text.splitlines():
        m = re.search(r"\((C\d+)\) Potential Performance Loss: wgmma.*"
                      r"in the function '(\S+)'", line)
        if m and serialized is not None:
            k = re.search(r"(int8_fwd90|int8_grad90)_kernelI(\w*?)EEv",
                          m.group(2))
            key = (k.group(1) + "<" + ",".join(v for _, v in re.findall(
                r"L([bi])(\d+)E", k.group(2) + "E")) + ">") if k \
                else m.group(2)
            serialized.setdefault(key, []).append(m.group(1))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # K3's (the wide passes' names end in w): <bf16 or f32[,
            # colored]>
            name = re.sub(r".*(loss_fwd90_sr|loss_grad90_sr|loss_fwd90w|"
                          r"loss_grad90w|grouped_dw90w|loss_fwd90|"
                          r"loss_grad90|grouped_dw90|"
                          r"tile_product90|chain_check90)_kernel"
                          r"(IL(b[01])E(Lb([01])E)?)?.*",
                          lambda k: k.group(1) + (
                              "" if k.group(3) is None else
                              "<" + ("bf16" if k.group(3) == "b1" else "f32")
                              + (",colored" if k.group(5) == "1" else "")
                              + ">"), m.group(1))
            # K1/K2's cluster kernels: <BF16, RESID, EMIT or ACT_BF16>
            k = re.search(r"(dec_fwd90|dec_chain90|dec_dw90|dec_layer90|"
                          r"dec_chainl90|dec_dww90|int8_fwd90|"
                          r"int8_grad90|int8_scale90)"
                          r"_kernelI(\w*?)EEv", m.group(1))
            if k:
                name = k.group(1) + "<" + ",".join(
                    v for _, v in re.findall(r"L([bi])(\d+)E",
                                             k.group(2) + "E")) + ">"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))) + (spill or (0, 0, 0)))
            name, spill = None, None
    return rows


def phase_dec90(torch, ptxas, ptxas_deep) -> dict:
    """``[dec90]``: K1/K2's cluster kernels alone: ptxas's report of each
    instantiation of both sources (registers, stack, spills; ``ptxas``,
    ``ptxas_deep``: the background compiles of DEC90_SOURCE and
    DEC90_DEEP_SOURCE), the clusters of 4 the card holds at once for each
    kernel, and the deep kernels' workspace block against the wrapper's."""
    from spatialvae_torch.kernels import fused_decoder as fd

    for started in (ptxas, ptxas_deep):
        for name, regs, stack, stores, loads in ptxas_report(started):
            log("dec90_ptxas", kernel=name, registers=regs,
                stack_bytes=stack, spill_store_bytes=stores,
                spill_load_bytes=loads)
    lib = fd._lib()
    names = ("fwd_f32", "fwd_bf16", "chain_f32", "chain_bf16", "dw_f32",
             "dw_bf16")
    clusters = {k: lib.svt_decoder90_max_clusters(i)
                for i, k in enumerate(names)}
    clusters.update({f"deep_{k}": lib.svt_decoder90_deep_max_clusters(i)
                     for i, k in enumerate(names)})
    if min(clusters.values()) < 1:
        raise AssertionError(f"K1/K2 cluster kernels resident: {clusters}")
    for h in (500, 513, 1000, 4100):
        for bf16 in (0, 1):
            if lib.svt_decoder90_deep_ws_block(h, bf16) != fd.deep_ws_block(
                    h, bool(bf16)):
                raise AssertionError(f"deep workspace block at H={h}")
    log("dec90", **{f"clusters_{k}": v for k, v in clusters.items()})
    return clusters


def kernel_device_ms(torch, fn, keys, calls: int = 3) -> dict:
    """key -> device ms a call of the kernels whose name holds ``key``:
    ``calls`` traced calls of ``fn`` (after a warm-up call), each key's mean
    time a launch times its launches a call.  The session opens with
    KB_WARMUP small kernels and takes several calls because the card's
    profiler may drop a session's first kernels (a dropped launch moves
    neither factor)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad = torch.zeros(1, device=DEVICE)
        for _ in range(KB_WARMUP):
            pad.add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(keys, 0.0)
    count = dict.fromkeys(keys, 0)
    for e in prof.key_averages():
        for k in keys:
            if k in e.key and e.device_time_total > 0:
                total[k] += e.device_time_total / 1e3
                count[k] += e.count
    return {k: total[k] / count[k] * max(1, round(count[k] / calls))
            if count[k] else 0.0 for k in keys}


# kernel-name substrings of K1/K2's kernels on both routes (the forwards
# first)
DEC_KERNELS = ("fused_decoder_fwd", "dec_fwd90", "dec_layer90", "bwd_chain",
               "bwd_dw", "dec_chain90", "dec_dw90", "dec_chainl90",
               "dec_dww90", "sum_rows")
N_DEC_FWD = 3
# the slice's wide and deep calls at the main path's batch: H = 1,000 (two
# column chunks) and Lh = 3 (`--p_num_layers 4`), f32 and bf16 weights
DEEP_CASES = [
    # name, B, HW, H, Lh, No, resid, weight dtype
    ("h1000_f32", BATCH, 4096, 1000, 1, 3, False, "float32"),
    ("h1000_bf16", BATCH, 4096, 1000, 1, 3, False, "bfloat16"),
    ("lh3_f32", BATCH, 4096, P_HIDDEN, 3, 3, False, "float32"),
    ("lh3_bf16", BATCH, 4096, P_HIDDEN, 3, 3, False, "bfloat16"),
]


def dec_passes(h: int, lh: int, tile_kernels: bool = False) -> int:
    """Launches of one K1 call (one chunk of images) on its route: a pass
    per layer on the deep kernels, else one."""
    from spatialvae_torch.kernels import fused_decoder as fd

    return 1 if tile_kernels or fd.single_pass(h, lh) else lh


def _tail_inputs(torch, b, hw, h, lh, no, wdt, gen):
    from spatialvae_torch.transforms.coords import coord_grid

    side = int(math.isqrt(hw))
    if side * side != hw:
        raise ValueError(f"case needs a square image, got HW={hw}")
    dev = DEVICE

    def u(*shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    fold = torch.zeros((b, 4, h), device=dev)
    fold[:, :2] = u(b, 2, h, bound=1.0 / math.sqrt(2))
    fold[:, 2] = u(b, h, bound=1.5)
    bound = 1.0 / math.sqrt(h)
    return (fold, coord_grid(side, side, device=dev),
            u(lh, h, h, bound=bound).to(wdt), u(lh, h, bound=bound).to(wdt),
            u(no, h, bound=bound).to(wdt), u(no, bound=bound).to(wdt))


def phase_kernels(torch) -> dict:
    """Kernel vs plain version on the card at the main path's shapes.  The
    kernel's time is its launch through ``run_decoder_tail`` with the
    weights packed once, as the slice runs it.  A call that
    ``decoder_route`` sends to the sm90 kernels also runs the tile kernels
    (``tile_kernels=True``), held to the same plain version and to the
    sm90 result, and times both in turns (AB_DEC)."""
    from spatialvae_torch.kernels import fused_decoder as fd

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [
        # name, B, HW, H, Lh, No, resid, weight dtype
        ("galaxy_f32", BATCH, 4096, P_HIDDEN, 1, 3, False, torch.float32),
        ("galaxy_bf16", BATCH, 4096, P_HIDDEN, 1, 3, False, torch.bfloat16),
        ("lh3_resid", 16, 4096, P_HIDDEN, 3, 3, True, torch.float32),
        ("hw784_no1", 32, 784, P_HIDDEN, 1, 1, False, torch.float32),
        ("no8", 16, 4096, P_HIDDEN, 1, 8, False, torch.float32),
        ("resid_bf16", 16, 4096, P_HIDDEN, 1, 3, True, torch.bfloat16),
    ] + [c[:-1] + (getattr(torch, c[-1]),) for c in DEEP_CASES]
    results = {}
    with torch.no_grad():
        for name, b, hw, h, lh, no, resid, wdt in cases:
            args = _tail_inputs(torch, b, hw, h, lh, no, wdt, gen)
            fold, coords, *weights = args
            route = fd.decoder_route(hw, h, lh, no)
            key = "fwd" + ("_sm90" if route == "sm90" else "")
            before = fd.LAUNCHES[key]
            got = fd.fused_decoder_tail(*args, resid)
            torch.cuda.synchronize()
            if fd.LAUNCHES[key] != before + dec_passes(h, lh):
                raise AssertionError(f"{name}: not launched on {route}")
            want = fd.decoder_tail_reference(*args, resid)
            dtype = str(wdt).replace("torch.", "")
            if got.shape != (b, no, hw):
                raise AssertionError(f"{name}: shape {tuple(got.shape)}")
            err, mean_err = check_close(name, got, want, wdt)
            packed = fd.TailWeights(*weights)
            fns = {r: functools.partial(fd.run_decoder_tail, fold, coords,
                                        packed, resid,
                                        tile_kernels=r == "tile")
                   for r in ("tile", route)}
            r = dict(err=err, route=route)
            if route == "sm90":
                again = fns["sm90"]()
                tile = fns["tile"]()
                if not torch.equal(again, got):
                    raise AssertionError(f"{name}: two runs differ")
                r["tile_err"] = check_close(name + " tile", tile, want, wdt)
                r["vs_tile"] = check_close(name + " vs tile", got, tile,
                                           wdt)
                ab = in_turns(torch, fns, N_TIMED, AB_DEC)
                r.update(ms=ab["sm90"][0], ms_tile=ab["tile"][0],
                         turns={k: v[1] for k, v in ab.items()})
            else:
                fns[route]()
                r["ms"] = statistics.median(
                    cuda_ms(fns[route], torch) for _ in range(N_TIMED))
            plain = functools.partial(fd.decoder_tail_reference, *args, resid)
            plain()
            r["plain_ms"] = statistics.median(cuda_ms(plain, torch)
                                              for _ in range(3))
            r["bound"] = dec_bounds(b, hw, h, no, wdt.itemsize, 0, lh)["fwd"]
            results[name] = r
            log("kernel", case=name, B=b, HW=hw, H=h, Lh=lh, No=no,
                resid=resid, dtype=dtype, route=route,
                max_abs_err=f"{err:.3e}", mean_abs_err=f"{mean_err:.3e}",
                max_tol=TOL[dtype][0], mean_tol=TOL[dtype][1],
                kernel_ms=f"{r['ms']:.4f}", **_dec_ab(r),
                plain_ms=f"{r['plain_ms']:.4f}",
                bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
            del args, fold, coords, weights, packed, got, want
    return results


def _dec_ab(r) -> dict:
    """The A/B fields of a K1/K2 reading on the sm90 route: the tile
    kernels' ms, every turn's ms and the route's error against them."""
    if r.get("route") != "sm90":
        return {}
    out = {"tile_ms": f"{r['ms_tile']:.4f}",
           "turns": " ".join(f"{k}:{t:.4f}" for k in ("tile", "sm90")
                             for t in r["turns"][k])}
    if "vs_tile" in r:
        out["tile_max_abs_err"] = f"{r['tile_err'][0]:.3e}"
        out["tile_mean_abs_err"] = f"{r['tile_err'][1]:.3e}"
        out["vs_tile_max_abs"] = f"{r['vs_tile'][0]:.3e}"
    return out


def rel_errors(got, want) -> tuple:
    """(max, mean) absolute error and both relative to max|want|."""
    d = (got.float() - want.float()).abs()
    scale = want.abs().max().item() or 1.0
    return (d.max().item(), d.mean().item(), d.max().item() / scale,
            d.mean().item() / scale)


BWD_CASES = [
    # name, B, HW, H, Lh, No, resid, weight dtype
    ("galaxy_f32", BATCH, 4096, P_HIDDEN, 1, 3, False, "float32"),
    ("galaxy_bf16", BATCH, 4096, P_HIDDEN, 1, 3, False, "bfloat16"),
    ("lh3_resid", 16, 4096, P_HIDDEN, 3, 3, True, "float32"),
    ("hw784_no1", 32, 784, P_HIDDEN, 1, 1, False, "float32"),
    ("no8", 16, 4096, P_HIDDEN, 1, 8, False, "float32"),
    ("resid_f32", BATCH, 4096, P_HIDDEN, 1, 3, True, "float32"),
] + [c for c in DEEP_CASES if c[4] > 1]
GRADS = ("dfold", "dwhid", "dbhid", "dwht", "dbht")


def backward_case(torch, case, seed: int, timed: bool,
                  rerun: bool = True, tile_kernels: bool = False) -> dict:
    """The emitting forward and both backward variants of one case against
    their plain versions on the same inputs and cotangent; with ``rerun``
    (not for a faulty copy, which may leave memory unwritten) two runs must
    agree bit for bit.  On the sm90 route (unless ``tile_kernels``) the
    tile kernels run too: their outputs against the same plain versions
    (the "tile" keys) and the route's against theirs ("vs_tile"); with
    ``timed`` both designs are timed in turns (AB_DEC).  Returns {"acts":
    errors, "y": errors, (variant, grad): errors, ("tile", "y" | "acts")
    and (variant, "tile", grad): the tile kernels' errors, and with
    ``timed`` the "*_ms" medians}."""
    from spatialvae_torch.kernels import fused_decoder as fd

    name, b, hw, h, lh, no, resid, dtype = case
    wdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fold, coords, *ws = _tail_inputs(torch, b, hw, h, lh, no, wdt, gen)
    g = torch.randn((b, no, hw), generator=gen, device=DEVICE)
    tw = fd.TailWeights(*ws)
    route = fd.decoder_route(hw, h, lh, no, tile_kernels)
    out = {"route": route}
    ab = route == "sm90" and timed

    def turns(what, fns):
        fns["plain"]()
        out[f"{what}_plain_ms"] = statistics.median(
            cuda_ms(fns["plain"], torch) for _ in range(3))
        if ab:
            t = in_turns(torch, fns, N_TIMED, AB_DEC)
            out[f"{what}_ms"], out[f"{what}_ms_tile"] = (t["sm90"][0],
                                                        t["tile"][0])
            out[f"{what}_turns"] = {k: v[1] for k, v in t.items()}
        else:
            fns[route]()
            out[f"{what}_ms"] = statistics.median(
                cuda_ms(fns[route], torch) for _ in range(N_TIMED))

    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, resid,
                                           tile_kernels)
        torch.cuda.synchronize()
        y_ref, acts_ref = fd.decoder_tail_reference(fold, coords, *ws, resid,
                                                    return_acts=True)
        if acts.dtype != wdt or acts.shape != (lh, b, hw, h):
            raise AssertionError(f"{name}: residual {acts.dtype} "
                                 f"{tuple(acts.shape)}")
        out["y"] = rel_errors(y, y_ref)
        out["acts"] = rel_errors(acts, acts_ref)
        if route == "sm90":
            y_t, acts_t = fd.run_decoder_tail_acts(fold, coords, tw, resid,
                                                   tile_kernels=True)
            out["tile", "y"] = rel_errors(y_t, y_ref)
            out["tile", "acts"] = rel_errors(acts_t, acts_ref)
            out["acts_vs_tile"] = rel_errors(acts, acts_t)
            del y_t, acts_t
        del y_ref, acts_ref
        for variant in ("residual", "recompute"):
            a = acts if variant == "residual" else None
            got = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g,
                                               resid,
                                               tile_kernels=tile_kernels)
            again = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g,
                                                 resid,
                                                 tile_kernels=tile_kernels)
            torch.cuda.synchronize()
            if rerun and not all(torch.equal(u, v)
                                 for u, v in zip(got, again)):
                raise AssertionError(f"{name} {variant}: two runs differ")
            want = fd.decoder_tail_backward_reference(
                fold, coords, ws[0], ws[1], ws[2], a, y, g, resid)
            for gname, u, v in zip(GRADS, got, want):
                if u.shape != v.shape:
                    raise AssertionError(f"{name} {gname}: shape")
                out[variant, gname] = rel_errors(u, v)
            if route == "sm90":
                tile = fd.run_decoder_tail_backward(
                    fold, coords, tw, a, y, g, resid, tile_kernels=True)
                for gname, u, v in zip(GRADS, tile, want):
                    out[variant, "tile", gname] = rel_errors(u, v)
                out[variant, "vs_tile"] = max(
                    rel_errors(u, v)[2] for u, v in zip(got, tile))
                del tile
            del got, again, want
            if timed and variant == "residual":
                out["residual_parts"] = {
                    r: kernel_device_ms(torch, functools.partial(
                        fd.run_decoder_tail_backward, fold, coords, tw, a, y,
                        g, resid, tile_kernels=r == "tile"), DEC_KERNELS)
                    for r in {"tile", route}}
            if timed:
                turns(variant, {
                    r: functools.partial(fd.run_decoder_tail_backward, fold,
                                         coords, tw, a, y, g, resid,
                                         tile_kernels=r == "tile")
                    for r in {"tile", route}} | {
                    "plain": functools.partial(
                        fd.decoder_tail_backward_reference, fold, coords,
                        ws[0], ws[1], ws[2], a, y, g, resid)})
        if timed:
            turns("fwd_acts", {
                r: functools.partial(fd.run_decoder_tail_acts, fold, coords,
                                     tw, resid, tile_kernels=r == "tile")
                for r in {"tile", route}} | {
                "plain": functools.partial(fd.decoder_tail_reference, fold,
                                           coords, *ws, resid,
                                           return_acts=True)})
    return out


def check_backward(name, dtype, r) -> dict:
    """Raise unless ``backward_case``'s readings ``r`` hold every limit:
    y and the activations by absolute error (and against the tile kernels
    on the sm90 route), each gradient of both variants by error relative to
    max|plain|.  Returns, by variant, the gradients' error fields and the
    route's largest error against the tile kernels (None off sm90)."""
    checks = [("y", TOL, r["y"]), ("acts", ACTS_TOL, r["acts"])]
    if "acts_vs_tile" in r:
        checks += [("tile y", TOL, r["tile", "y"]),
                   ("tile acts", ACTS_TOL, r["tile", "acts"]),
                   ("acts vs tile", ACTS_TOL, r["acts_vs_tile"])]
    for what, tols, (err, mean_err, *_) in checks:
        tol = tols[dtype]
        if not (err <= tol[0] and mean_err <= tol[1]):
            raise AssertionError(f"{name} {what}: kernel vs plain max "
                                 f"abs err {err}, mean {mean_err}; "
                                 f"limits {tol}")
    out = {}
    for variant in ("residual", "recompute"):
        tol = BWD_TOL[dtype, variant]
        fields = {}
        for design in ((), ("tile",)):
            if design and (variant, "tile", GRADS[0]) not in r:
                continue
            for gname in GRADS:
                err, mean_err, rel, mean_rel = r[(variant, *design, gname)]
                if not (rel <= tol[0] and mean_rel <= tol[1]):
                    raise AssertionError(
                        f"{name} {variant} {' '.join(design)} {gname}: "
                        f"kernel vs plain error relative to max|plain| "
                        f"{rel}, mean {mean_rel}; limits {tol}")
                fields["_".join((*design, gname))] = (
                    f"{err:.3e}/{mean_err:.3e}/{rel:.2e}/{mean_rel:.2e}")
        vt = r.get((variant, "vs_tile"))
        if vt is not None and not vt <= tol[0]:
            raise AssertionError(f"{name} {variant}: sm90 vs tile "
                                 f"{vt}; limit {tol[0]}")
        out[variant] = (fields, vt)
    return out


def phase_backward(torch) -> dict:
    """K1 with its activation output and K2 (residual and recompute)
    against their plain versions at the training path's shapes; on the
    sm90 route also against the tile kernels, timed in turns with them.
    Returns the readings by case."""
    results = {}
    for case in BWD_CASES:
        name, b, hw, h, lh, no, resid, dtype = case
        r = backward_case(torch, case, SEED, timed=True)
        checked = check_backward(name, dtype, r)
        bd = dec_bounds(b, hw, h, no, 2 if dtype == "bfloat16" else 4,
                        2 if dtype == "bfloat16" else 4, lh)
        ab = lambda what: _dec_ab({
            "route": r["route"], "ms_tile": r.get(what + "_ms_tile", 0.0),
            "turns": r.get(what + "_turns", {"tile": [], "sm90": []})})
        log("kernel_fwd_acts", case=name, B=b, HW=hw, H=h, Lh=lh, No=no,
            resid=resid, dtype=dtype, route=r["route"],
            y_max_abs_err=f"{r['y'][0]:.3e}",
            acts_max_abs_err=f"{r['acts'][0]:.3e}",
            acts_mean_abs_err=f"{r['acts'][1]:.3e}",
            acts_max_tol=ACTS_TOL[dtype][0],
            acts_mean_tol=ACTS_TOL[dtype][1],
            tile_y_max_abs_err=(f"{r['tile', 'y'][0]:.3e}"
                                if ("tile", "y") in r else "-"),
            tile_acts_max_abs_err=(f"{r['tile', 'acts'][0]:.3e}"
                                   if ("tile", "acts") in r else "-"),
            tile_acts_mean_abs_err=(f"{r['tile', 'acts'][1]:.3e}"
                                    if ("tile", "acts") in r else "-"),
            acts_vs_tile=(f"{r['acts_vs_tile'][0]:.3e}"
                          if "acts_vs_tile" in r else "-"),
            kernel_ms=f"{r['fwd_acts_ms']:.4f}", **ab("fwd_acts"),
            plain_ms=f"{r['fwd_acts_plain_ms']:.4f}",
            bound_ms=f"{bd['fwd_acts'][0]:.4f}")
        for variant in ("residual", "recompute"):
            tol = BWD_TOL[dtype, variant]
            fields, vt = checked[variant]
            log("kernel_bwd", case=name, variant=variant, dtype=dtype,
                route=r["route"],
                errors="max_abs/mean_abs/max_rel/mean_rel", **fields,
                max_rel_tol=tol[0], mean_rel_tol=tol[1],
                vs_tile_max_rel=f"{vt:.3e}" if vt is not None else "-",
                kernel_ms=f"{r[variant + '_ms']:.4f}", **ab(variant),
                plain_ms=f"{r[variant + '_plain_ms']:.4f}",
                bound_ms=f"{bd['chain'][0] + bd['dw'][0] + bd['sums'][0]:.4f}")
        results[name] = r
        torch.cuda.empty_cache()
    return results


def galaxy_configs():
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_torch.objectives import ElboConfig

    hw = IMAGE[0] * IMAGE[1]
    q_cfg = InferenceConfig(n=hw * CHANNELS, latent_dim=Z_DIM + 3,
                            hidden_dim=Q_HIDDEN, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z_DIM, hidden_dim=P_HIDDEN,
                                   n_out=CHANNELS, num_layers=P_LAYERS)
    ecfg = ElboConfig(rotate=True, translate=True, theta_prior=math.pi,
                      likelihood="bernoulli", channels=CHANNELS, fused=True)
    return q_cfg, p_cfg, ecfg


def blob_images(torch, n: int, gen, image=None, channels=None,
                on_grid: bool = True):
    """(n, HW, C) structured images: one Gaussian blob per image with a
    random centre, orientation, size and colour, on the /255 grid, or
    (``on_grid=False``) with noise on top and whitened over the dataset, so
    signed and off the grid, as cryo-EM particles are."""
    rows, cols = image or IMAGE
    channels = channels or CHANNELS
    yy, xx = torch.meshgrid(torch.linspace(1, -1, rows, device=DEVICE),
                            torch.linspace(-1, 1, cols, device=DEVICE),
                            indexing="ij")

    def u(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    cx, cy = 0.4 * u(n, 1, 1) - 0.2, 0.4 * u(n, 1, 1) - 0.2
    th = 2 * math.pi * u(n, 1, 1)
    sa, sb = 0.15 + 0.2 * u(n, 1, 1), 0.06 + 0.1 * u(n, 1, 1)
    dx, dy = xx - cx, yy - cy
    r0 = torch.cos(th) * dx + torch.sin(th) * dy
    r1 = -torch.sin(th) * dx + torch.cos(th) * dy
    blob = torch.exp(-(r0 ** 2 / (2 * sa ** 2) + r1 ** 2 / (2 * sb ** 2)))
    img = blob[..., None] * (0.3 + 0.7 * u(n, 1, 1, channels))
    if on_grid:
        img = torch.round(img.clamp(0, 1) * 255) / 255
    else:
        img = img + 0.1 * torch.randn(img.shape, generator=gen,
                                      device=DEVICE)
        img = (img - img.mean()) / img.std()
    return img.reshape(n, rows * cols, channels)


def step_grads(torch, trainer, y, noise, fused: bool, ecfg=None) -> dict:
    """d loss / d param of one float32 step at the trainer's weights,
    through the kernels (fused) or the plain folded decoder under autograd;
    ``ecfg`` stands in for the trainer's."""
    from spatialvae_torch.objectives import loss_and_grad

    loss_and_grad(trainer.q_net, trainer.p_net,
                  dataclasses.replace(ecfg or trainer.ecfg, fused=fused),
                  trainer.coords, y, noise=noise, mask=trainer.mask)
    return {k: p.grad.clone() for k, p in trainer.named_params().items()}


def phase_train(torch, tmpdir: str) -> tuple:
    """Train the galaxy model for two epochs through the kernels; returns
    the launch counts of the epochs' 22 steps and, from one profiled step,
    each backward kernel's device ms."""
    from spatialvae_torch import checkpoint
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels.fused_decoder import LAUNCHES, reset_launches
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    q_cfg, p_cfg, ecfg = galaxy_configs()
    tcfg = TrainConfig(minibatch_size=BATCH, learning_rate=1e-4,
                       num_epochs=TRAIN_EPOCHS, z_delay=1, seed=SEED,
                       image_shape=IMAGE, channels=CHANNELS)
    t0 = time.perf_counter()
    trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg,
                      coord_grid(*IMAGE, device=DEVICE), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    data = blob_images(torch, N_TRAIN, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = trainer.eval_epoch(data, 0)
    reset_launches()
    ka.reset_launches()
    t0 = time.perf_counter()
    rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    adam = dict(ka.LAUNCHES)
    steps = TRAIN_EPOCHS * math.ceil(N_TRAIN / BATCH)
    want = {"fwd": 0, "fwd_acts": 0, "fwd_recompute": 0, "bwd_chain": 0,
            "bwd_dw": 0, "bwd_sum": 4 * steps, "fwd_sm90": 0,
            "fwd_acts_sm90": steps, "fwd_recompute_sm90": 0,
            "bwd_chain_sm90": steps, "bwd_dw_sm90": steps}
    want_adam = {"adam": 0, "adam_emit": 0,
                 "adam_step": steps * adam_step_launches(trainer),
                 "quant_scale": 0, "quantize": 0}
    if counts != want or adam != want_adam:
        raise AssertionError(f"launches over {steps} steps: {counts}, "
                             f"Adam {adam}; expected {want}, {want_adam}")
    counts["adam"] = adam["adam_step"]
    counts["adam_leaf"] = adam["adam"] + adam["adam_emit"]
    after = trainer.eval_epoch(data, TRAIN_EPOCHS)
    if not (np.isfinite(rows).all() and np.isfinite(before + after).all()):
        raise AssertionError(f"non-finite metrics: {before} {rows} {after}")
    if not after[0] > before[0]:
        raise AssertionError(f"ELBO did not rise: {before[0]} -> {after[0]}")

    path = os.path.join(tmpdir, "galaxy_optimizer_epoch2.sav")
    checkpoint.save_optimizer(path, trainer.opt_state, TRAIN_EPOCHS - 1,
                              trainer.q_net, trainer.p_net)
    state, epoch = checkpoint.load_optimizer(path, trainer.q_net,
                                             trainer.p_net, device=DEVICE)
    if state.count != steps or epoch != TRAIN_EPOCHS - 1 or not all(
            torch.equal(state.mu[k], trainer.opt_state.mu[k])
            and torch.equal(state.nu[k], trainer.opt_state.nu[k])
            for k in trainer.opt_state.mu):
        raise AssertionError("optimizer checkpoint did not round-trip")
    del state

    y = data[:BATCH]
    noise = torch.randn((BATCH, Z_DIM + 3), generator=gen, device=DEVICE)
    kern = step_grads(torch, trainer, y, noise, True)
    plain = step_grads(torch, trainer, y, noise, False)
    worst = (0.0, 0.0, "")
    for k in kern:
        _, _, rel, mean_rel = rel_errors(kern[k], plain[k])
        if not (rel <= STEP_TOL[0] and mean_rel <= STEP_TOL[1]):
            raise AssertionError(f"step gradient {k}: kernel vs plain "
                                 f"{rel}, mean {mean_rel}; limits "
                                 f"{STEP_TOL}")
        worst = max(worst, (rel, mean_rel, k))
    del kern, plain
    log("train", setup_s=f"{setup_s:.2f}", epochs=TRAIN_EPOCHS, steps=steps,
        images=N_TRAIN, seconds=f"{seconds:.4f}",
        steps_per_s=f"{steps / seconds:.3f}",
        images_per_s=f"{TRAIN_EPOCHS * N_TRAIN / seconds:.1f}",
        elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
        epoch_elbo="/".join(f"{r[0]:.3f}" for r in rows),
        launches=json.dumps(counts, separators=(",", ":")),
        adam_launches_per_step=adam_step_launches(trainer),
        optimizer_roundtrip="bitwise",
        step_vs_plain_max_rel=f"{worst[0]:.3e}",
        step_vs_plain_worst_leaf=worst[2])
    return counts, phase_profile_step(torch, trainer, y, tmpdir)


def _trace_events(prof, tmpdir: str, name: str) -> list:
    path = os.path.join(tmpdir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def phase_profile_step(torch, trainer, y, tmpdir: str) -> dict:
    """One training step under torch.profiler: the card's busy time (union
    of the trace's kernel, memcpy and memset intervals) against the step's
    host-clock time, and the shares of busy time of K1, K2, cuBLAS GEMMs
    (the encoder's, nearly all) and Adam (kernels launched inside the
    trainer's "adam" label, matched by correlation id)."""
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(y)                      # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _trace_events(prof, tmpdir, "train_trace.json")
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("the profiler saw no kernel")
    busy = _busy_us(device)
    adam_ids = _label_ids(events, "adam")

    def share(pred) -> tuple:
        ks = [e for e in kernels if pred(e)]
        return sum(e["dur"] for e in ks) / 1e3, len(ks)

    k1 = share(lambda e: any(s in e["name"]
                             for s in DEC_KERNELS[:N_DEC_FWD]))
    k2 = share(lambda e: any(s in e["name"]
                             for s in DEC_KERNELS[N_DEC_FWD:]))
    gemm = share(lambda e: "gemm" in e["name"].lower()
                 or "xmma" in e["name"].lower())
    adam_k = share(lambda e: e["args"].get("correlation") in adam_ids)
    fields = {}
    for label, (ms, n) in (("k1", k1), ("k2", k2), ("gemm", gemm),
                           ("adam", adam_k)):
        fields[f"{label}_ms"] = f"{ms:.3f}"
        fields[f"{label}_launches"] = n
        fields[f"{label}_share_of_busy"] = f"{ms * 1e3 / busy:.4f}"
    per_kernel = {k: share(lambda e, k=k: k in e["name"])[0]
                  for k in DEC_KERNELS}
    # the host's share: the sm90 slab streams, built per step on the grad
    # path (``_FusedTail`` packs the weights per call)
    from spatialvae_torch.kernels import fused_decoder as fd

    *hidden, head = trainer.p_net.linears()

    def pack():
        tw = fd.TailWeights(*(t.detach() for t in fd._stack_tail(hidden,
                                                                 head)))
        for l in range(len(hidden)):
            tw.sm90_slabs(l)
            tw.sm90_slabs_t(l)
        tw.head_args()
    per_kernel["slabs_host_ms"] = _step_host_ms(torch, pack, 10)
    phase_adam_path_ab(torch, "float", lambda: trainer.train_step(y))
    log("profile_step", wall_ms=f"{wall_us / 1e3:.3f}",
        device_busy_ms=f"{busy / 1e3:.3f}",
        idle_share=f"{1 - busy / wall_us:.4f}", **fields,
        **{(k if k.endswith("_ms") else f"{k}_ms"): f"{v:.3f}"
           for k, v in per_kernel.items()},
        kernels=len(kernels))
    return per_kernel


def _check_images(name, t, shape, torch) -> None:
    if tuple(t.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name}: non-finite values")
    if t.min().item() < 0.0 or t.max().item() > 1.0:
        raise AssertionError(f"{name}: values outside [0, 1]")


def phase_slice(torch, tmpdir: str, paths=None, tag="slice") -> int:
    """Serve the galaxy model through the API (random weights, or the
    checkpoints at ``paths``); returns the kernel launches counted over the
    timed passes of the requests.  The default slice also profiles a
    pass."""
    from spatialvae_torch import checkpoint
    from spatialvae_torch.api import SpatialVae
    from spatialvae_torch.evaluate import eval_batches
    from spatialvae_torch.kernels.fused_decoder import (
        LAUNCHES,
        decoder_route,
        reset_launches,
    )
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
    from spatialvae_torch.objectives import elbo_minibatch

    hw = IMAGE[0] * IMAGE[1]
    q_cfg, p_cfg, ecfg = galaxy_configs()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    if paths is None:
        q_net = InferenceNetwork(q_cfg, generator=gen, device=DEVICE)
        p_net = SpatialGenerator(p_cfg, generator=gen, device=DEVICE)
        paths = (os.path.join(tmpdir, "galaxy_generator_epoch1.sav"),
                 os.path.join(tmpdir, "galaxy_inference_epoch1.sav"))
        checkpoint.save_model(paths[0], "generator", p_net, elbo=ecfg,
                              image_shape=IMAGE)
        checkpoint.save_model(paths[1], "inference", q_net, elbo=ecfg,
                              image_shape=IMAGE)
        del q_net, p_net
    gpath, ipath = paths
    model = SpatialVae.load(gpath, ipath, device=DEVICE)
    if model.p_net.cfg.hidden_dim != P_HIDDEN or \
            model.p_net.cfg.num_layers != P_LAYERS:
        raise AssertionError(f"served a decoder "
                             f"{model.p_net.cfg.hidden_dim} wide, "
                             f"{model.p_net.cfg.num_layers} layers")
    log("checkpoint", tag=tag, hidden=P_HIDDEN,
        seconds=f"{time.perf_counter() - t0:.2f}",
        bytes=os.path.getsize(gpath) + os.path.getsize(ipath))

    images = torch.randint(0, 256, (N_EVAL, hw, CHANNELS), generator=gen,
                           device=DEVICE).float() / 255.0
    y = images[:BATCH]

    def requests():
        out = {
            "encode": model.encode(y),
            "reconstruct": model.reconstruct(y, gen),
            "reconstruct_canonical": model.reconstruct_canonical(y, gen),
            "sample": model.sample(BATCH, gen),
            "eval_batches": eval_batches(model, images, BATCH, gen),
        }
        torch.cuda.synchronize()
        return out

    requests()                                  # warm-up (cuBLAS, caches)
    reset_launches()
    seconds = []
    for _ in range(N_PASSES):
        t0 = time.perf_counter()
        out = requests()
        seconds.append(time.perf_counter() - t0)
    lh = P_LAYERS - 1
    key = "fwd" + ("_sm90" if decoder_route(
        hw, P_HIDDEN, lh, CHANNELS) == "sm90" else "")
    launches = LAUNCHES[key]
    decodes = 3 + math.ceil(N_EVAL / BATCH)
    passes = dec_passes(P_HIDDEN, lh)
    if launches != N_PASSES * decodes * passes or \
            sum(LAUNCHES.values()) != launches:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{N_PASSES} x {decodes} decodes of {passes} "
                             f"launches")

    z_mu, z_logstd = out["encode"]
    for name, t in (("z_mu", z_mu), ("z_logstd", z_logstd)):
        if tuple(t.shape) != (BATCH, Z_DIM + 3) or \
                not bool(torch.isfinite(t).all()):
            raise AssertionError(f"encode {name}: bad shape or values")
    for name in ("reconstruct", "reconstruct_canonical", "sample"):
        _check_images(name, out[name], (BATCH, hw, CHANNELS), torch)
    elbo, log_p, kl = out["eval_batches"]
    if not all(map(math.isfinite, (elbo, log_p, kl))) or log_p > 0 \
            or kl < 0 or abs(elbo - (log_p - kl)) > 1e-3 * abs(elbo):
        raise AssertionError(f"eval_batches: elbo={elbo} log_p={log_p} "
                             f"kl={kl}")

    # one reconstruct through the kernel against the plain folded decoder,
    # same weights and noise (not counted above)
    noise = torch.randn((BATCH, Z_DIM + 3), generator=gen, device=DEVICE)
    got = model.reconstruct(y, noise=noise)
    _, _, _, want = elbo_minibatch(
        model.q_net, model.p_net,
        dataclasses.replace(model.serving_ecfg, fused=False), model.coords,
        y, noise=noise)
    err, _ = check_close("reconstruct", got, want, torch.float32)

    # a smoke reading over a few passes, not a serving benchmark
    n_req = len(out)
    n_img = 4 * BATCH + N_EVAL
    med = statistics.median(seconds)
    log(tag, hidden=P_HIDDEN, layers=P_LAYERS, passes=N_PASSES,
        requests_per_pass=n_req,
        images_per_pass=n_img, pass_ms_median=f"{med * 1e3:.4f}",
        pass_ms_min=f"{min(seconds) * 1e3:.4f}",
        pass_ms_max=f"{max(seconds) * 1e3:.4f}",
        requests_per_s=f"{n_req / med:.3f}",
        images_per_s=f"{n_img / med:.1f}", decodes_per_pass=decodes,
        launches=launches, elbo=f"{elbo:.3f}", log_p=f"{log_p:.3f}",
        kl=f"{kl:.3f}", reconstruct_vs_plain=f"{err:.3e}")
    phase_profile(torch, requests, tmpdir, tag)
    return launches


def phase_profile(torch, requests, tmpdir: str, tag: str = "slice") -> None:
    """One pass of the requests under torch.profiler.  The card is busy
    where a kernel, memcpy or memset of the trace runs (the union of their
    intervals); the idle share is the rest of the pass's host-clock time,
    which the profiler itself lengthens."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        requests()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in _trace_events(prof, tmpdir, "trace.json")
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("the profiler saw no device activity")
    busy = _busy_us(events)
    k1 = [e["dur"] for e in events
          if any(s in e["name"] for s in DEC_KERNELS[:N_DEC_FWD])]
    log("profile", tag=tag, wall_ms=f"{wall_us / 1e3:.3f}",
        device_busy_ms=f"{busy / 1e3:.3f}",
        idle_share=f"{1 - busy / wall_us:.4f}",
        k1_ms=f"{sum(k1) / 1e3:.3f}", k1_launches=len(k1),
        k1_share_of_busy=f"{sum(k1) / busy:.4f}",
        device_events=len(events))


# ---------------------------------------------------------------------------
# the int8 slice: K3 (fused loss and gradient), K4 (int8 forward), K5 (its
# backward)
# ---------------------------------------------------------------------------

INT8_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_int8.cu"
INT8_90_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_int8_sm90.cu"
INT8_90_WIDE_SOURCE = (
    "spatialvae_torch/kernels/csrc/fused_decoder_int8_sm90_wide.cu")
# fused_decoder_int8.LAUNCHES: the block passes', the cluster passes'
K45_KEYS = ("fwd", "fwd_acts", "bwd_scale", "bwd_grad", "dw", "sum",
            "fwd_sm90", "fwd_acts_sm90", "bwd_scale_sm90", "bwd_grad_sm90",
            "dw_sm90")
# turns of an A/B of K4/K5's two designs on one card
AB_I8 = ("block", "sm90", "sm90", "block")
LOSS_SOURCE = "spatialvae_torch/kernels/csrc/fused_loss_int8.cu"
LOSS90_SOURCE = "spatialvae_torch/kernels/csrc/fused_loss_int8_sm90.cu"
LOSS90_SR_SOURCE = "spatialvae_torch/kernels/csrc/fused_loss_int8_sm90_sr.cu"
# the cluster passes past H = 512 (the default numerics)
LOSS90_WIDE_SOURCE = (
    "spatialvae_torch/kernels/csrc/fused_loss_int8_sm90_wide.cu")
# fused_loss_int8.LAUNCHES: the block passes', the cluster passes' ("_sm90")
K3_KEYS = ("fwd", "grad", "dw", "sum", "fwd_sm90", "grad_sm90", "dw_sm90")
# turns of an A/B of K3's two designs on one card
AB_K3 = ("block", "sm90", "sm90", "block")


def k3_launches(calls: int, route, chunks: int = 1) -> dict:
    """fused_loss_int8.LAUNCHES after ``calls`` K3 calls on ``route``
    ("sm90", "block", or None: no call), each over ``chunks`` workspace
    chunks (the cluster route runs forward, gradient and dW1 per chunk; the
    block route one forward at H <= 512)."""
    out = dict.fromkeys(K3_KEYS, 0)
    if route is None:
        return out
    sfx = "_sm90" if route == "sm90" else ""
    out["fwd" + sfx] = calls * (chunks if route == "sm90" else 1)
    out["grad" + sfx] = out["dw" + sfx] = calls * chunks
    out["sum"] = 5 * calls
    return out


def k45_launches(tails: int, evals: int = 0, route: str = "sm90") -> dict:
    """fused_decoder_int8.LAUNCHES after ``evals`` K4 calls without a1 and
    ``tails`` odd-tail training steps (K4 with a1, K5 from the residual in
    one workspace chunk) on ``route``."""
    out = dict.fromkeys(K45_KEYS, 0)
    sfx = "_sm90" if route == "sm90" else ""
    out["fwd" + sfx] = evals
    for k in ("fwd_acts", "bwd_scale", "bwd_grad", "dw"):
        out[k + sfx] = tails
    out["sum"] = 4 * tails
    return out


def k45_route(trainer, alone: bool = False) -> str:
    """The route of ``trainer``'s K4/K5 calls (``alone``: of its K4 calls
    without a1, the evaluation's, on weights of its compute dtype): its
    padded pixel count and decoder width through ``int8_route``."""
    import torch

    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    hw = trainer.coords.shape[0]
    return d8.int8_route(hw + (-hw) % 256, trainer.p_cfg.hidden_dim,
                         k4_alone_f32=alone and
                         trainer.compute_dtype == torch.float32)


class on_int8_passes:
    """Within the block every K4 and K5 call of the port runs ``passes``
    ("block", the yardstick of the cluster passes, or "sm90"), whatever
    ``int8_route``'s table says, for the trainer's and the tools' calls
    alike."""

    def __init__(self, passes: str = "block"):
        self.passes = passes

    def __enter__(self):
        from spatialvae_torch.kernels import fused_decoder_int8 as d8

        self.saved = (d8.run_int8_tail, d8.run_int8_tail_backward)
        d8.run_int8_tail = functools.partial(self.saved[0],
                                             passes=self.passes)
        d8.run_int8_tail_backward = functools.partial(self.saved[1],
                                                      passes=self.passes)
        return self

    def __exit__(self, *exc):
        from spatialvae_torch.kernels import fused_decoder_int8 as d8

        d8.run_int8_tail, d8.run_int8_tail_backward = self.saved
        return False


class on_block_passes:
    """Within the block every K3 call of the port runs the block passes
    (``run_loss_int8(..., block_passes=True)``): the yardstick of the cluster
    passes, for the trainer's and the tools' calls alike."""

    def __enter__(self):
        from spatialvae_torch.kernels import fused_loss_int8 as l8

        self.saved = l8.run_loss_int8
        l8.run_loss_int8 = functools.partial(self.saved, block_passes=True)
        return self

    def __exit__(self, *exc):
        from spatialvae_torch.kernels import fused_loss_int8 as l8

        l8.run_loss_int8 = self.saved
        return False


def in_turns(torch, route_fns, reps: int, order=AB_K3) -> dict:
    """route -> the median ms of ``route_fns[route]`` over its turns of
    ``order`` (AB_K3, or AB_DEC for K1/K2), each turn the median of
    ``reps`` CUDA-event runs, and the turns' list: one card, one call, in
    turns."""
    turns = {}
    for route in order:
        fn = route_fns[route]
        fn()
        turns.setdefault(route, []).append(statistics.median(
            cuda_ms(fn, torch) for _ in range(reps)))
    return {r: (statistics.median(t), t) for r, t in turns.items()}
K3_REPLACES = "spatialvae_tpu/kernels/fused_loss_int8.py:718"
K4_REPLACES = "spatialvae_tpu/kernels/fused_decoder_int8.py:60"
K5_REPLACES = "spatialvae_tpu/kernels/fused_decoder_int8.py:95"
# Kernel vs plain version, every output by its error relative to its
# largest value (max, mean), placed between the sound kernels' readings and
# those of copies built with -DSVT_INT8_RTZ=1 (quantisation rounds toward
# zero) or -DSVT_INT8_BLOCK_SCALE=1 (each gradient scale over a 64-pixel
# block, not its group): the PERF.md limits table; `--limits` reprints the
# readings.
INT8_TOL = (1e-3, 2e-5)
# K3's dh0 reading (dfold's three gradient rows on their own scale; beside
# the loss at dfold[:, 3, 0] their errors are too small to see) on every
# route, and K8's (dfoldT's three gradient columns): placed past H = 512
# between the sound wide cluster passes' readings (at most 1.13e-4 /
# 1.78e-5) and those of the copy that reads aq for dh0 from the workspace
# one block off (-DSVT_K3W_AQ_OFF=1, at least 1.86e-2 / 6.89e-4); at
# H <= 512 the sound routes read at most 1.182e-4 / 1.159e-6 (the cluster
# passes, SR, the knob modes, the levers, K8) and each route's dh0 copy
# (DH0_FAULTS) at least: the cluster passes 1.476e-2 / 7.515e-4, SR's
# 1.766e-2 / 1.107e-3, the block passes 1.405e-2 / 5.248e-4 (`--limits
# k3` and `--limits numerics` on an H100): the PERF.md limits table
DH0_TOL = (1e-3, 1e-4)
# K5 on the wide cluster passes against the block passes past H = 512,
# every output relative to the block passes' largest value (max, mean):
# the two differ only in the order of their f32 sums (the head's, the
# column sums'); placed between the sound passes' readings (at most
# 6.08e-7 / 1.15e-7, db1 in [kernel_wide] at H = 1,000, B = 100) and
# those of the wide copies of `--limits int8_90` that move K5 (at least
# 5.991e-3 / 2.980e-4, dh0 from a0q/127): the PERF.md limits table
K45W_BLOCK_TOL = (1e-5, 2e-6)
# K4's y and a1 by absolute error (max, mean)
INT8_Y_TOL = (1e-5, 1e-6)
INT8_A1_TOL = (1e-2, 1e-6)
# one int8 training step through the kernels against the plain versions,
# after the two training epochs, every gradient leaf relative to its largest
# value (bf16 compute: a leaf is a bf16 tensor, so one element one bf16 ulp
# away reads 3.9e-3); `--limits` reads it at the same state for the galaxy,
# particles, colored and mnist trainers: sound at most 7.0e-3 / 1.6e-4 (the
# particles K3 step: a last-bit difference in the encoder's cotangent flips
# an int8 value of its quantised copy and moves a row of dW), the copies
# with a step removed at least 1.1e-1 / 2.9e-2
INT8_STEP_TOL = (5e-2, 1e-3)
INT8_GRADS = ("dfold", "dw1", "db1", "dwht", "dbht")
BENCH_BATCH = 4096      # bench.py's batch
BENCH_STEPS = 16        # bench.py's steps per epoch
# the card's peaks (NVIDIA's H100 SXM data sheet, dense) for the bounds
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# K1 and K2 run each f32 product of their hidden GEMMs as three TF32
# products (hi*hi + hi*lo + lo*hi) on the tensor cores, and their head on
# the CUDA cores: the f32 rows are held to that method's rates
TF32_PASSES = 3


def bound(nbytes: float, *work, overlap: bool = False) -> tuple:
    """(ms, "operations" | "bytes"): the larger of the bytes moved over the
    memory rate and the time of the operations, each (ops, peak) pair of
    ``work`` at the peak for its type; the pairs' times add up, or with
    ``overlap`` (units that run at once) the longest stands for them."""
    times = [ops / peak for ops, peak in work]
    t_ops = (max(times, default=0.0) if overlap else sum(times)) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def f32_gemm(ops: float) -> tuple:
    """The (ops, peak) of an f32 GEMM run as TF32_PASSES TF32 products."""
    return TF32_PASSES * ops, PEAK_TF32


def bf16_gemm(ops: float) -> tuple:
    """The (ops, peak) of a GEMM of bf16 operands with f32 accumulation."""
    return ops, PEAK_BF16


def dec_bounds(b, hw, h, no, wdt_bytes, act_bytes, lh: int = 1) -> dict:
    """The bounds (ms, by) of K1 and K2's kernels at ``lh`` hidden layers
    (each layer's product and residual once more; the deep kernels' layer
    buffers are no input or output of the function):
    "fwd" (fold, coords, weights, y), "fwd_acts" (and the (B, HW, H)
    residual in ``act_bytes``), "chain" (reads the residual, writes the
    per-block partials; da0 and the head's two products), "dw" (reads the
    residual and the dh workspace in the weight dtype, writes the split-K
    partials) and "sums"; the hidden GEMMs at the weights' rate (f32:
    TF32_PASSES TF32 products; bf16: bf16), the heads on the CUDA cores.
    The f32 bounds add the heads' time to the products'; the bf16 bounds
    are the products or the bytes, whichever is longer (the heads'
    CUDA-core time overlaps the tensor cores')."""
    f4 = 4
    gemm = 2.0 * b * hw * h * h * lh
    g = f32_gemm(gemm) if wdt_bytes == 4 else bf16_gemm(gemm)
    bd = functools.partial(bound, overlap=wdt_bytes == 2)
    head = (2.0 * b * hw * h * no, PEAK_FP32)
    io = (b * 4 * h * f4 + hw * 2 * f4
          + (lh * (h * h + h) + no * h + no) * wdt_bytes + b * no * hw * f4)
    acts = b * hw * h * act_bytes * lh
    parts = (b * (hw // 64) * (3 * h + (lh + no) * h + no)
             + (b * hw // 4096) * h * h * lh) * f4
    return {"fwd": bd(io, g, head), "fwd_acts": bd(io + acts, g, head),
            "chain": bd(io + acts + lh * b * hw * h * wdt_bytes + parts, g,
                        (2 * head[0], PEAK_FP32)),
            "dw": bd(acts + lh * b * hw * h * wdt_bytes
                     + (b * hw // 4096) * h * h * lh * f4, g),
            "sums": bd(parts)}


def _int8_inputs(torch, b, dtype, gen, no=CHANNELS, h=None, hw=None):
    """fold, coords and (w1, b1, wht, bht) at the galaxy shape (a decoder
    P_HIDDEN wide unless ``h``, over IMAGE's pixels unless ``hw``)."""
    fold, coords, whid, bhid, wht, bht = _tail_inputs(
        torch, b, hw or IMAGE[0] * IMAGE[1], h or P_HIDDEN, 1, no,
        getattr(torch, dtype), gen)
    return fold, coords, (whid[0].contiguous(), bhid[0].contiguous(), wht,
                          bht)


def _timed(torch, kern, plain) -> tuple:
    kern()
    plain()
    ks = [cuda_ms(kern, torch) for _ in range(N_TIMED)]
    ps = [cuda_ms(plain, torch) for _ in range(3)]
    return statistics.median(ks), statistics.median(ps)


# K3's readings: the loss, dh0 (the three rows of dfold that carry the
# gradient, read on their own scale: beside the loss at dfold[:, 3, 0]
# an error there is too small to see) and the five outputs
K3_READINGS = ("loss", "dh0") + INT8_GRADS


def k3_views(out) -> tuple:
    """K3's outputs ``out`` in the order of K3_READINGS."""
    return (out[0][:, 3, 0], out[0][:, :3]) + tuple(out)


def _loss_readings(torch, args, mask, family, timed, nm=None,
                   block_passes=False) -> dict:
    """K3 on ``args`` (fold, coords, w1, b1, wht, bht, y_t) against its
    plain version, at numerics ``nm`` (default: the defaults), on the passes
    its route takes (``block_passes``: the block passes whatever the
    route): each output's errors, whether two runs agree bit for bit, the
    quantised tiles' disagreements (the forward site's count, the gradient
    site's share), and with ``timed`` the kernel's and the plain version's
    ms.  A call that the cluster passes take is also held to the block
    passes ("vs_block": each output's errors, the tiles' disagreements;
    "block": the block passes' own errors against the plain version) and,
    with ``timed``, timed in turns with them ("ms_block", "turns").  Under
    SR also "moved": the share of aq that a call with b1[0] one ulp away
    (the next step's words) rounds otherwise."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics

    nm = nm or Numerics()
    hw, h = args[1].shape[0], args[2].shape[0]
    route = l8.k3_route(hw, h, l8.pick_tile(hw), family, nm,
                        block_passes=block_passes)
    run = functools.partial(l8.run_loss_int8, *args, mask, family,
                            numerics=nm, block_passes=block_passes)
    with torch.no_grad():
        got = run()
        again = run()
        torch.cuda.synchronize()
        want = l8.loss_int8_reference(*args, mask, family, nm)
        out = {"same": all(torch.equal(u, v) for u, v in zip(got, again)),
               "loss": rel_errors(got[0][:, 3, 0], want[0][:, 3, 0]),
               "dh0": rel_errors(got[0][:, :3], want[0][:, :3])}
        for name, u, v in zip(INT8_GRADS, got, want):
            if u.shape != v.shape:
                raise AssertionError(f"K3 {name}: shape {tuple(u.shape)}")
            out[name] = rel_errors(u, v)
        del again
        (_, (aq, qi)) = run(ints=True)
        _, (aq_p, qi_p) = l8.loss_int8_reference(*args, mask, family, nm,
                                                 ints=True)
        out["ints"] = (int((aq != aq_p).sum()),
                       (qi != qi_p).float().mean().item())
        del aq_p, qi_p
        if nm.sr:
            b1 = args[3].clone()
            b1[0] = torch.nextafter(b1[0], torch.ones_like(b1[0]))
            _, (aq2, _) = run.func(*args[:3], b1, *args[4:], mask, family,
                                   numerics=nm, ints=True,
                                   block_passes=block_passes)
            out["moved"] = (aq != aq2).float().mean().item()
            del aq2
        out["route"] = route
        if route == "sm90":
            old, (aq7, qi7) = l8.run_loss_int8(*args, mask, family,
                                               numerics=nm, ints=True,
                                               block_passes=True)
            out["vs_block"] = {"ints": (int((aq != aq7).sum()),
                                      (qi != qi7).float().mean().item())}
            out["vs_block"].update({n: rel_errors(u, v) for n, u, v in zip(
                K3_READINGS, k3_views(got), k3_views(old))})
            out["block"] = {n: rel_errors(u, v) for n, u, v in zip(
                K3_READINGS, k3_views(old), k3_views(want))}
            del old, aq7, qi7
        del got, want, aq, qi
        if timed:
            out["ms"], out["plain_ms"] = _timed(
                torch, run,
                lambda: l8.loss_int8_reference(*args, mask, family, nm))
            if route == "sm90":
                ab = in_turns(torch, {"sm90": run, "block": functools.partial(
                    run.func, *run.args,
                    **{**run.keywords, "block_passes": True})},
                    N_TIMED // 2)
                out["ms"], out["turns"] = ab["sm90"][0], ab
                out["ms_block"] = ab["block"][0]
    return out


def loss_case(torch, b, dtype, seed, timed, i8=True, masked=False,
              nm=None, block_passes=False) -> dict:
    """K3's Bernoulli family against its plain version on one galaxy
    batch, at numerics ``nm`` (default: the defaults; ``block_passes``: on the
    block passes)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fold, coords, ws = _int8_inputs(torch, b, dtype, gen)
    hw = IMAGE[0] * IMAGE[1]
    k = torch.randint(0, 256, (b, CHANNELS, hw), generator=gen,
                      device=DEVICE)
    yt = (k - 128).to(torch.int8) if i8 else k.float() / 255.0
    mask = ((torch.rand(hw, generator=gen, device=DEVICE) > 0.2).float()
            if masked else None)
    return _loss_readings(torch, (fold, coords, *ws, yt), mask, "bernoulli",
                          timed, nm, block_passes)


def int8_tail_case(torch, b, dtype, seed, timed, hw=None,
                   no=CHANNELS) -> dict:
    """K4 with and without a1 and K5 with the residual and with recompute
    against their plain versions on one galaxy batch (or ``hw`` pixels and
    ``no`` outputs: the coords zero-padded to a multiple of 256 and the
    cotangent 0 on the pad, as ``fused_spatial_generator_int8`` calls
    them), on the passes the route takes ("route"; K4 without a1 on the
    cluster passes wherever they fit, though the table sends float32
    weights to the block passes: "route_alone", and where that differs
    "y_alone", K4 without a1 on it).  A call that the cluster passes
    take is also held to the block passes ("vs_block": y and a1 by
    absolute error, K5's outputs by relative error) and, with ``timed``,
    timed in turns with them (AB_I8; "<call>_ms" the cluster passes',
    "<call>_ms_block", "<call>_turns"; "<call>_ms_route" the table's)."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fold, coords, ws = _int8_inputs(torch, b, dtype, gen, no=no, hw=hw)
    real = coords.shape[0]
    coords = torch.nn.functional.pad(
        coords, (0, 0, 0, (-real) % 256)).contiguous()
    g = torch.randn((b, no, coords.shape[0]), generator=gen, device=DEVICE)
    g[..., real:] = 0.0
    w = d8.Int8Weights(*ws)
    ref = (w.w1q, w.sw, w.b1, w.wht)
    route = d8.int8_route(coords.shape[0], ws[0].shape[0])
    alone = d8.int8_route(coords.shape[0], ws[0].shape[0],
                          k4_alone_f32=dtype == "float32")
    out = {"route": route, "route_alone": alone, "vs_block": {}}
    with torch.no_grad():
        y, a1 = d8.run_int8_tail(fold, coords, w, emit_a1=True)
        y0 = d8.run_int8_tail(fold, coords, w, passes=route)
        torch.cuda.synchronize()
        y_ref, a1_ref = d8.decoder_tail_int8_reference(
            fold, coords, *ref, w.bht, return_a1=True)
        out["y"] = rel_errors(y, y_ref)
        out["y_no_a1"] = rel_errors(y0, y_ref)
        out["a1"] = rel_errors(a1, a1_ref)
        if alone != route:
            out["y_alone"] = rel_errors(d8.run_int8_tail(fold, coords, w),
                                        y_ref)
        if route == "sm90":
            yb, a1b = d8.run_int8_tail(fold, coords, w, emit_a1=True,
                                       passes="block")
            out["vs_block"].update(y=rel_errors(y, yb), a1=rel_errors(a1, a1b))
            out["block_y"] = rel_errors(yb, y_ref)
            del yb, a1b
        del y_ref, a1_ref, y0
        for variant in ("residual", "recompute"):
            a = a1 if variant == "residual" else None
            got = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            again = d8.run_int8_tail_backward(fold, coords, w, a, y, g)
            torch.cuda.synchronize()
            out[variant, "same"] = all(torch.equal(u, v)
                                       for u, v in zip(got, again))
            want = d8.decoder_tail_int8_backward_reference(
                fold, coords, *ref, a, y, g)
            for name, u, v in zip(INT8_GRADS, got, want):
                out[variant, name] = rel_errors(u, v)
            if route == "sm90":
                old = d8.run_int8_tail_backward(fold, coords, w, a, y, g,
                                                passes="block")
                for name, u, v, x in zip(INT8_GRADS, got, old, want):
                    out["vs_block"][variant, name] = rel_errors(u, v)
                    out["block", variant, name] = rel_errors(v, x)
                del old
            del got, again, want
            if timed:
                run = functools.partial(d8.run_int8_tail_backward, fold,
                                        coords, w, a, y, g)
                out[variant + "_ms"], out[variant + "_plain_ms"] = _timed(
                    torch, run,
                    lambda: d8.decoder_tail_int8_backward_reference(
                        fold, coords, *ref, a, y, g))
                if route == "sm90":
                    _turns(torch, out, variant, run)
                    if variant == "residual":
                        out["block_device"] = kernel_device_ms(
                            torch, functools.partial(run, passes="block"),
                            ("int8_bwd_scale", "int8_bwd_grad",
                             "grouped_dw_kernel"))
        if timed:
            for name, emit, rt in (("fwd", False, alone),
                                   ("fwd_a1", True, route)):
                run = functools.partial(d8.run_int8_tail, fold, coords, w,
                                        emit, passes=route)
                out[name + "_ms"], out[name + "_plain_ms"] = _timed(
                    torch, run,
                    lambda: d8.decoder_tail_int8_reference(
                        fold, coords, *ref, w.bht, return_a1=emit))
                if route == "sm90":
                    _turns(torch, out, name, run)
                out[name + "_ms_route"] = out[name + "_ms" + (
                    "_block" if rt == "block" and route == "sm90" else "")]
    return out


def _turns(torch, out, name, run) -> None:
    """``run`` (a K4/K5 wrapper call) on the cluster passes in turns with
    the same call on the block passes (AB_I8), each named by ``passes``:
    out[name + "_ms"] and ["_ms_block"] the medians, ["_turns"] every
    turn."""
    ab = in_turns(torch, {p: functools.partial(
        run.func, *run.args, **{**run.keywords, "passes": p})
        for p in ("sm90", "block")}, N_TIMED // 2, AB_I8)
    out[name + "_ms"], out[name + "_ms_block"] = ab["sm90"][0], ab["block"][0]
    out[name + "_turns"] = " ".join(f"{k}:{t:.4f}" for k in ("block", "sm90")
                                    for t in ab[k][1])


def _check_rel(what, errs, tol) -> str:
    err, mean_err, rel, mean_rel = errs
    if not (rel <= tol[0] and mean_rel <= tol[1]):
        raise AssertionError(f"{what}: kernel vs plain error relative to "
                             f"max|plain| {rel}, mean {mean_rel}; limits "
                             f"{tol}")
    return f"{err:.3e}/{mean_err:.3e}/{rel:.2e}/{mean_rel:.2e}"


def _check_abs(what, errs, tol) -> None:
    if not (errs[0] <= tol[0] and errs[1] <= tol[1]):
        raise AssertionError(f"{what}: kernel vs plain max abs err "
                             f"{errs[0]}, mean {errs[1]}; limits {tol}")


def _check_dh0(what, r) -> str:
    """K3's (or K8's) dh0 reading of ``r`` (dfold's three gradient rows on
    their own scale) within DH0_TOL, and on the cluster passes the same
    against the block passes; returns its log field (max_rel/mean_rel)."""
    _check_rel(f"{what} dh0", r["dh0"], DH0_TOL)
    if r.get("route") == "sm90" and "vs_block" in r:
        _check_rel(f"{what} dh0, cluster vs block passes",
                   r["vs_block"]["dh0"], DH0_TOL)
    return f"{r['dh0'][2]:.2e}/{r['dh0'][3]:.2e}"


LOSS_CASES = [
    # B, weight dtype, int8 targets, mask
    (BATCH, "bfloat16", True, False),
    (BATCH, "float32", True, False),
    (BATCH, "bfloat16", False, True),
]
INT8_TAIL_CASES = [(BATCH, "bfloat16"), (N_TRAIN % BATCH, "bfloat16"),
                   (BATCH, "float32")]


def _k5_bound(b: int) -> tuple:
    """K5 with recompute at the galaxy shape, ``b`` images: the bound of
    T1's ``bwd`` run (tools/kernel_bench.py's counts: three int8 products,
    a1 rebuilt once, da0 and dW1, and the CUDA-core work of the chain, the
    epilogue, the gradient and the head) at that batch."""
    from spatialvae_torch.tools import kernel_bench as tool

    run = {r.name: r for r in tool.runs(b, tool.HW, KB_PT)}["bwd"]
    return bound(run.nbytes, (run.int8_ops, PEAK_INT8),
                 (run.f32_ops, PEAK_FP32))


def _log_ab(r) -> dict:
    """The A/B fields of a K3 reading on the cluster passes: the block
    passes' ms, every turn's ms, the largest cluster-vs-block error relative to
    max|block|, the tiles' disagreements (aq words, qi share) and the block
    passes' largest error relative to max|plain|."""
    if r["route"] != "sm90":
        return {}
    v = r["vs_block"]
    _check_ints("K3 cluster vs block passes", v)
    return {"block_ms": f"{r['ms_block']:.4f}" if "ms_block" in r else "-",
            "turns": " ".join(f"{k}:{t:.4f}" for k in ("block", "sm90")
                              for t in r["turns"][k][1]) if "turns" in r
            else "-",
            "vs_block_max_rel":
                f"{max(v[n][2] for n in ('loss',) + INT8_GRADS):.3e}",
            "vs_block_ints": f"{v['ints'][0]}/{v['ints'][1]:.2e}",
            "block_vs_plain_max_rel":
                f"{max(r['block'][n][2] for n in ('loss',) + INT8_GRADS):.3e}"}


def phase_int8_kernels(torch) -> dict:
    """K3, K4 and K5 against their plain versions at the galaxy shape; K3
    on the cluster passes, held to the block passes and timed in turns with
    them."""
    res = {}
    for b, dtype, i8, masked in LOSS_CASES:
        r = loss_case(torch, b, dtype, SEED, timed=True, i8=i8,
                      masked=masked)
        if not r["same"]:
            raise AssertionError(f"K3 B={b} {dtype}: two runs differ")
        if r["route"] != "sm90":
            raise AssertionError(f"K3 B={b} {dtype}: route {r['route']}")
        fields = {n: _check_rel(f"K3 B={b} {dtype} {n}", r[n], INT8_TOL)
                  for n in ("loss",) + INT8_GRADS}
        fields["dh0"] = _check_dh0(f"K3 B={b} {dtype}", r)
        log("kernel_loss_int8", B=b, HW=IMAGE[0] * IMAGE[1], H=P_HIDDEN, No=CHANNELS,
            dtype=dtype, targets="int8" if i8 else "float",
            mask=masked, route=r["route"],
            errors="max_abs/mean_abs/max_rel/mean_rel (dh0: max_rel/mean_rel)",
            **fields, max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
            dh0_tol=DH0_TOL,
            ints_vs_plain=_check_ints(f"K3 B={b} {dtype}", r),
            kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            **_log_ab(r))
        res["loss", b, dtype, i8, masked] = r
        torch.cuda.empty_cache()
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    d8.reset_launches()
    for b, dtype in INT8_TAIL_CASES:
        r = int8_tail_case(torch, b, dtype, SEED, timed=True)
        if r["route"] != "sm90":
            raise AssertionError(f"K4/K5 B={b} {dtype}: route {r['route']}")
        _check_abs(f"K4 B={b} {dtype} y", r["y"], INT8_Y_TOL)
        _check_abs(f"K4 B={b} {dtype} y without a1", r["y_no_a1"],
                   INT8_Y_TOL)
        _check_abs(f"K4 B={b} {dtype} a1", r["a1"], INT8_A1_TOL)
        v = r["vs_block"]
        _check_abs(f"K4 B={b} {dtype} y, cluster vs block passes", v["y"],
                   INT8_Y_TOL)
        _check_abs(f"K4 B={b} {dtype} a1, cluster vs block passes", v["a1"],
                   INT8_A1_TOL)
        log("kernel_int8_fwd", B=b, HW=IMAGE[0] * IMAGE[1], H=P_HIDDEN, No=CHANNELS,
            dtype=dtype, route=r["route"], route_alone=r["route_alone"],
            y_max_abs_err=f"{r['y'][0]:.3e}",
            y_mean_abs_err=f"{r['y'][1]:.3e}",
            a1_max_abs_err=f"{r['a1'][0]:.3e}",
            a1_mean_abs_err=f"{r['a1'][1]:.3e}", y_tol=INT8_Y_TOL,
            a1_tol=INT8_A1_TOL, kernel_ms=f"{r['fwd_ms']:.4f}",
            plain_ms=f"{r['fwd_plain_ms']:.4f}",
            kernel_a1_ms=f"{r['fwd_a1_ms']:.4f}",
            plain_a1_ms=f"{r['fwd_a1_plain_ms']:.4f}",
            block_ms=f"{r['fwd_ms_block']:.4f}",
            block_a1_ms=f"{r['fwd_a1_ms_block']:.4f}",
            route_ms=f"{r['fwd_ms_route']:.4f}",
            turns=r["fwd_turns"], turns_a1=r["fwd_a1_turns"],
            y_vs_block_max_abs=f"{v['y'][0]:.3e}",
            a1_vs_block_max_abs=f"{v['a1'][0]:.3e}")
        for variant in ("residual", "recompute"):
            if not r[variant, "same"]:
                raise AssertionError(f"K5 B={b} {variant}: two runs differ")
            fields = {n: _check_rel(f"K5 B={b} {dtype} {variant} {n}",
                                    r[variant, n], INT8_TOL)
                      for n in INT8_GRADS}
            for n in INT8_GRADS:
                _check_rel(f"K5 B={b} {dtype} {variant} {n}, cluster vs "
                           f"block passes", v[variant, n], INT8_TOL)
            bd = _k5_bound(b) if variant == "recompute" else None
            log("kernel_int8_bwd", B=b, dtype=dtype, variant=variant,
                route=r["route"],
                bound_ms="-" if bd is None else f"{bd[0]:.4f}",
                bound_by="-" if bd is None else bd[1],
                errors="max_abs/mean_abs/max_rel/mean_rel", **fields,
                max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
                kernel_ms=f"{r[variant + '_ms']:.4f}",
                plain_ms=f"{r[variant + '_plain_ms']:.4f}",
                block_ms=f"{r[variant + '_ms_block']:.4f}",
                turns=r[variant + "_turns"],
                vs_block_max_rel=f"{max(v[variant, n][2] for n in INT8_GRADS):.3e}")
        res["tail", b, dtype] = r
        torch.cuda.empty_cache()
    # the block passes' launches here: the yardstick's checks and turns
    res["ab_k45"] = dict(d8.LAUNCHES)
    return res


# the product alone on the cluster ring: tiles (K3's 64-pixel blocks) of
# 128 images at 64x64; its ms includes writing the int32 output, four times
# the input's bytes
PRODUCT_TILES = 8192


def phase_k3_sm90(torch, ptxas, ptxas_sr, ptxas_wide) -> dict:
    """``[k3_sm90]``: the cluster passes' pieces alone.  ptxas's report of
    each of their kernels (``ptxas``, ``ptxas_sr``, ``ptxas_wide``:
    ``start_ptxas_report``'s compiles of their source, of their SR
    instantiations' source and of the wide passes' source); the
    clusters of 4 the card holds at once for each kernel (SR's too); the a0
    chain's thresholds
    against clip(round(7 tanh(x)), -7, 7) at every one of the 2^32 float
    inputs (0 may differ); the product on the cluster ring (the W1 slabs
    multicast, int8 wgmma) against an exact product, word for word, at
    K = 512 and K = 128, and its ms and TOP/s at PRODUCT_TILES tiles."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    serialized = {}
    for started in (ptxas, ptxas_sr, ptxas_wide):
        for name, regs, stack, stores, loads in ptxas_report(started,
                                                             serialized):
            log("k3_sm90_ptxas", kernel=name, registers=regs,
                stack_bytes=stack, spill_store_bytes=stores,
                spill_load_bytes=loads)
    log("k3_sm90_ptxas", wgmma_serialized_notes=json.dumps(
        serialized, separators=(",", ":")))
    clusters = l8.sm90_max_clusters()
    if min(clusters.values()) < 1:
        raise AssertionError(f"K3 cluster kernels resident: {clusters}")
    t0 = time.perf_counter()
    differ = l8.sm90_chain_check(DEVICE)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    if differ:
        raise AssertionError(f"the a0 chain's thresholds differ from "
                             f"round(7 tanh) at {differ} inputs")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {"clusters": clusters}
    for h, n in ((P_HIDDEN, PRODUCT_TILES), (96, 64)):
        kp = -(-h // 64) * 64
        a = torch.randint(-7, 8, (n, 64, 512), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        a[..., kp:] = 0
        w = torch.randint(-7, 8, (h, h), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        got = l8.sm90_tile_product(a, w)
        words = 0
        for i in range(0, n, 1024):          # the exact product in pieces
            words += int((got[i:i + 1024] != l8.sm90_tile_product_reference(
                a[i:i + 1024], w)).sum())
        if words:
            raise AssertionError(f"the cluster product differs in {words} "
                                 f"words at H={h}")
        ms = statistics.median(
            cuda_ms(lambda: l8.sm90_tile_product(a, w), torch)
            for _ in range(5))
        out["product", h] = ms
        log("k3_sm90", H=h, Kp=kp, tiles=n, product_words_differ=words,
            product_ms=f"{ms:.4f}",
            product_top_s=f"{2.0 * n * 64 * 512 * kp / ms / 1e9:.1f}",
            chain_inputs_differ=differ, chain_check_s=f"{chain_s:.2f}",
            **{f"clusters_{k}": v for k, v in clusters.items()})
        del a, got
        torch.cuda.empty_cache()
    return out


# the timing copies of the int8 cluster passes: libraries of the one source
# csrc/fused_decoder_int8_sm90.cu, each built with one switch of its header,
# whose svt_int8_90_* entry points stand in for the wrappers' library's
I8_90_TIMING = {"pingpong": ("-DSVT_I8_90_PINGPONG=1",),
                "product": ("-DSVT_I8_90_CUT=1",),
                "epilogue": ("-DSVT_I8_90_CUT=2",)}
I8_90_UNITS = ("fused_decoder_int8_sm90.cu",)
# the cluster passes' kernels by name
I8_90_KERNELS = ("int8_fwd90", "int8_scale90", "int8_grad90",
                 "grouped_dw90")
# T1's batch (tools/kernel_bench.py): the split at its size too
KB_BATCH = 2048


def start_int8_timing_builds() -> dict:
    """The I8_90_TIMING libraries, built in the background from the start
    (one thread and one nvcc each): name -> future of the library's
    path."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build

    ex = ThreadPoolExecutor(len(I8_90_TIMING))
    futures = {k: ex.submit(_build.build, d, I8_90_UNITS)
               for k, d in I8_90_TIMING.items()}
    ex.shutdown(wait=False)
    return futures


class _with_timing_copy:
    """The wrappers' library with the entry points named ``prefix``* (K4/K5's
    cluster passes' ``svt_int8_90_*``, or K3's ``svt_loss*``) taken from a
    copy's library: a timing copy of K4/K5's, or a faulty copy of K3's
    units."""

    def __init__(self, sound, timing, prefix="svt_int8_90_"):
        self.sound, self.timing, self.prefix = sound, timing, prefix

    def __getattr__(self, name):
        lib = self.timing if name.startswith(self.prefix) else self.sound
        return getattr(lib, name)


# K3's translation units: a faulty copy of K3 for the limits, built with a
# switch of its sources, is a library of these alone,
# whose svt_loss* entry points stand in for the library's
K3_UNITS = ("fused_loss_int8.cu", "fused_loss_int8_levers.cu",
            "fused_loss_int8_wide.cu", "fused_loss_int8_sm90.cu",
            "fused_loss_int8_sm90_sr.cu", "fused_loss_int8_sm90_wide.cu")


def build_k3_copies(copies) -> None:
    """Build the K3 copies of ``copies`` (tuples of -D switches) in
    parallel, one thread each."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build

    copies = [d for d in copies if d]
    if copies:
        with ThreadPoolExecutor(len(copies)) as ex:
            list(ex.map(lambda d: _build.build(d, K3_UNITS), copies))


def k3_library(defines: tuple):
    """The library with K3's entry points from the copy built with
    ``defines`` (the sound library itself for none)."""
    from spatialvae_torch.kernels import _build

    sound = _build.load_library()
    if not defines:
        return sound
    return _with_timing_copy(sound, _build.load_library(defines, K3_UNITS),
                             "svt_loss")


def _copy_turns(torch, libs: dict, fn, reps: int) -> dict:
    """copy -> [ms, ms]: ``fn`` (a K4/K5 wrapper call) with ``d8._lib``
    set to each library of ``libs`` in turn (the median of ``reps``
    CUDA-event runs), in their order and then in the reverse order."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    out = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            d8._lib = (lambda lib=libs[name]: lib)
            fn()
            out.setdefault(name, []).append(statistics.median(
                cuda_ms(fn, torch) for _ in range(reps)))
    return out


def phase_int8_sm90(torch, ptxas, ptxas_pingpong, timing_builds,
                    ptxas_wide) -> dict:
    """``[int8_sm90]``: K4 and K5's cluster passes alone.  ptxas's report
    of every kernel of the passes and of the ping-pong timing copy
    (compiled in the background from the start), with the wgmma
    serialization notes, and of the wide unit's (``ptxas_wide``, "wide");
    the clusters of 4 the card holds at once, the wide unit's too; the a0
    chain (exact tanhf, the formula itself).  ``[int8_sm90_split]``: the
    wrappers run with the cluster passes' entry points taken from each
    timing copy's library (I8_90_TIMING; "pass" is the wrappers' own): K4
    (bf16, B=100 and T1's B=2,048) as the pass, on the ping-pong schedule,
    as the product alone and as the epilogue alone, in turns (each copy
    timed in order, then again in the reverse order); K4 with a1 at the
    odd tail on both schedules; K5's gradient pass at the odd tail (the
    residual) as the pass, the product alone and the epilogue alone, each
    kernel's device ms from one traced call."""
    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    for copy, started in (("pass", ptxas), ("pingpong", ptxas_pingpong),
                          ("wide", ptxas_wide)):
        serialized = {}
        for name, regs, stack, stores, loads in ptxas_report(started,
                                                             serialized):
            log("int8_sm90_ptxas", build=copy, kernel=name, registers=regs,
                stack_bytes=stack, spill_store_bytes=stores,
                spill_load_bytes=loads,
                wgmma_serialized=",".join(serialized.get(name, [])) or "-")
    clusters = d8.sm90_max_clusters()
    wide = d8.sm90_max_clusters(wide=True)
    if min(clusters.values()) < 1 or min(wide.values()) < 1:
        raise AssertionError(f"int8 cluster kernels resident: {clusters}, "
                             f"wide {wide}")
    log("int8_sm90", chain="exact tanhf",
        **{f"clusters_{k}": v for k, v in clusters.items()},
        **{f"clusters_wide_{k}": v for k, v in wide.items()})
    sound = _build.load_library()
    libs = {"pass": sound}
    for name, future in timing_builds.items():
        future.result()
        libs[name] = _with_timing_copy(
            sound, _build.load_library(I8_90_TIMING[name], I8_90_UNITS))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {"clusters": clusters}
    tb = N_TRAIN % BATCH
    try:
        with torch.no_grad():
            for b in (BATCH, KB_BATCH):
                fold, coords, ws = _int8_inputs(torch, b, "bfloat16", gen)
                w = d8.Int8Weights(*ws)
                t = _copy_turns(torch, libs, functools.partial(
                    d8.run_int8_tail, fold, coords, w),
                    3 if b == BATCH else 1)
                out["k4", b] = {k: statistics.median(v) for k, v in t.items()}
                log("int8_sm90_split", call="K4", B=b, dtype="bfloat16",
                    **{f"{k}_ms": "/".join(f"{x:.4f}" for x in v)
                       for k, v in t.items()})
                if b == BATCH:
                    t = _copy_turns(
                        torch, {k: libs[k] for k in ("pass", "pingpong")},
                        functools.partial(d8.run_int8_tail, fold[:tb],
                                          coords, w, True), 3)
                    out["k4_a1", tb] = {k: statistics.median(v)
                                        for k, v in t.items()}
                    log("int8_sm90_split", call="K4 with a1", B=tb,
                        dtype="bfloat16", **{f"{k}_ms": "/".join(
                            f"{x:.4f}" for x in v) for k, v in t.items()})
                    d8._lib = (lambda: sound)
                    y, a1 = d8.run_int8_tail(fold[:tb], coords, w, True)
                    g = torch.randn(y.shape, generator=gen, device=DEVICE)
                    grad = {}
                    for name in ("pass", "product", "epilogue"):
                        d8._lib = (lambda lib=libs[name]: lib)
                        ms = kernel_device_ms(torch, functools.partial(
                            d8.run_int8_tail_backward, fold[:tb], coords, w,
                            a1, y, g), I8_90_KERNELS)
                        grad[name] = ms["int8_grad90"]
                    out["k5_grad", tb] = grad
                    log("int8_sm90_split", call="K5 gradient pass", B=tb,
                        dtype="bfloat16", variant="residual",
                        **{f"{k}_device_ms": f"{v:.4f}"
                           for k, v in grad.items()})
                    del y, a1, g
                del fold, coords, ws, w
                torch.cuda.empty_cache()
    finally:
        d8._lib = (lambda: _build.load_library())
    return out


def phase_eval_int8_ab(torch) -> dict:
    """``[eval_int8_ab]``: the galaxy int8 trainer's ``eval_epoch`` over the
    smoke's N_EVAL images (B=100: four batches and a tail of 37 through K4
    alone) and one odd-tail training step (B=37: K4 with a1, the likelihood,
    K5 from the residual, Adam), unprofiled, timed with CUDA events, in
    turns on the block and the cluster passes (AB_I8, each turn the median
    of 3 runs); each route's K4/K5 launches checked on one call of each.
    ``route`` is the one ``int8_route``'s table gives the call, which
    must be the cluster passes'."""
    trainer, data, _ = int8_galaxy_trainer(torch)
    tb = N_TRAIN % BATCH
    evals = math.ceil(N_EVAL / BATCH)
    calls = {"eval_epoch": lambda: trainer.eval_epoch(data[:N_EVAL], 0),
             "tail_step": lambda: trainer.train_step(data[:tb])}
    want = {"eval_epoch": lambda r: k45_launches(0, evals, r),
            "tail_step": lambda r: k45_launches(1, 0, r)}
    table = {"eval_epoch": k45_route(trainer, True),
             "tail_step": k45_route(trainer)}
    if set(table.values()) != {"sm90"}:
        raise AssertionError(f"the galaxy int8 path's routes: {table}")
    out = {}
    for kind, fn in calls.items():
        turns = {}
        for route in AB_I8:
            with on_int8_passes(route):
                _reset_all_launches()
                fn()
                torch.cuda.synchronize()
                got = _int8_launches()["k45"]
                if got != want[kind](route):
                    raise AssertionError(f"{kind} on {route}: K4/K5 "
                                         f"launches {got}")
                turns.setdefault(route, []).append(statistics.median(
                    cuda_ms(fn, torch) for _ in range(3)))
        med = {r: statistics.median(t) for r, t in turns.items()}
        out[kind] = med
        log("eval_int8_ab", call=kind, B=BATCH if kind == "eval_epoch"
            else tb, images=N_EVAL if kind == "eval_epoch" else tb,
            route=table[kind], ms=f"{med['sm90']:.4f}",
            ms_block=f"{med['block']:.4f}",
            turns=" ".join(f"{r}:{t:.4f}" for r in ("block", "sm90")
                           for t in turns[r]))
    del trainer, data
    torch.cuda.empty_cache()
    return out


class plain_int8:
    """Within the block the int8 wrappers run their plain versions on CUDA
    tensors too: the reference step that the kernels' step is held to."""

    def __enter__(self):
        from spatialvae_torch.kernels import fused_decoder_int8 as d8
        from spatialvae_torch.kernels import fused_loss_int8 as l8
        from spatialvae_torch.kernels import fused_loss_int8_t as lt
        from spatialvae_torch.kernels.config import numerics

        self.saved = (l8.run_loss_int8, d8.run_int8_tail,
                      d8.run_int8_tail_backward, lt.run_loss_int8_t)
        l8.run_loss_int8 = (lambda fold, coords, w1, b1, wht, bht, y_t,
                            mask=None, family="bernoulli", p_base=0:
                            l8.loss_int8_reference(fold, coords, w1, b1, wht,
                                                   bht, y_t, mask, family,
                                                   numerics(),
                                                   p_base=p_base))
        lt.run_loss_int8_t = (lambda fold_t, coords, w1, b1, wht, bht, y_t:
                              lt.loss_int8_t_reference(
                                  fold_t, coords, w1, b1, wht, bht, y_t,
                                  numerics().grad_mode_t))
        d8.run_int8_tail = (lambda fold, coords, w, emit_a1=False:
                            d8.decoder_tail_int8_reference(
                                fold, coords, w.w1q, w.sw, w.b1, w.wht,
                                w.bht, emit_a1))
        d8.run_int8_tail_backward = (
            lambda fold, coords, w, a1, y, g: d8
            .decoder_tail_int8_backward_reference(
                fold, coords, w.w1q, w.sw, w.b1, w.wht, a1, y, g))
        return self

    def __exit__(self, *exc):
        from spatialvae_torch.kernels import fused_decoder_int8 as d8
        from spatialvae_torch.kernels import fused_loss_int8 as l8
        from spatialvae_torch.kernels import fused_loss_int8_t as lt

        (l8.run_loss_int8, d8.run_int8_tail, d8.run_int8_tail_backward,
         lt.run_loss_int8_t) = self.saved
        return False


def int8_step_grads(torch, trainer, y, y_t, y_q8, noise, plain: bool
                    ) -> dict:
    """The trainer's step gradients (the bf16 shadow's, through the int8
    encoder with the Adam-emitted copies and ``y_q8``) at its state."""
    from spatialvae_torch.objectives import loss_and_grad

    target, qq = trainer.grad_target()

    def run():
        loss_and_grad(trainer.q_net, trainer.p_net, trainer.ecfg,
                      trainer.coords, y, params=target, noise=noise,
                      mask=trainer.mask, y_t=y_t, q_quant=qq, y_q8=y_q8,
                      compute_dtype=trainer.compute_dtype)
    if plain:
        with plain_int8():
            run()
    else:
        run()
    return {k: t.grad.clone() for k, t in target.items()}


def _int8_launches() -> dict:
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import fused_loss_int8_t as lt

    return {"k3": dict(l8.LAUNCHES), "k8": dict(lt.LAUNCHES),
            "k45": dict(d8.LAUNCHES), "k12": sum(fd.LAUNCHES.values()),
            "adam": dict(ka.LAUNCHES)}


def _reset_all_launches() -> None:
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import fused_loss_int8_t as lt

    for m in (fd, d8, l8, lt, ka):
        m.reset_launches()


def _qenc_min() -> int:
    """The int8 trainer's threshold for a leaf's int8 copy."""
    from spatialvae_torch.train import trainer as tmod

    return tmod._QENC_MIN_ELEMS


def _big_leaves(trainer) -> int:
    """The leaves that get int8 copies (the two encoder hidden weights at
    galaxy size)."""
    return sum(p.dim() == 2 and p.numel() >= _qenc_min()
               for p in trainer.named_params().values())


def adam_step_launches(trainer) -> int:
    """The step kernel's launches per step: one per STEP_MAX_LEAVES
    leaves."""
    from spatialvae_torch.kernels import adam as ka

    return -(-len(trainer.named_params()) // ka.STEP_MAX_LEAVES)


def int8_adam_launches(trainer, steps: int, *, seeded: bool,
                       engine: str = "xla") -> dict:
    """Adam's launches over ``steps`` int8 steps: the step kernel (which
    writes the scales), and under the fresh-scale engine one launch of the
    copies of the big leaves, if any (under ``pallas`` K7 takes them in the
    step kernel); no per-leaf kernel.  ``seeded``: the epoch also built the
    int8 data copy (one scale, one quantize: the images are float32) and
    seeded the qshadow (each big leaf quantised once)."""
    big = _big_leaves(trainer)
    seed = 1 + big if seeded else 0
    seed_q = 1 + big if seeded else 0
    fresh = steps if big and engine != "pallas" else 0
    return {"adam": 0, "adam_emit": 0,
            "adam_step": steps * adam_step_launches(trainer),
            "quant_scale": seed, "quantize": fresh + seed_q}


def int8_galaxy_trainer(torch):
    """The ``[train_int8]`` trainer (int8 mode, bf16 compute, seed SEED), its
    1,037 blob images and the generator that made them."""
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    q_cfg, p_cfg, ecfg = galaxy_configs()
    ecfg = dataclasses.replace(ecfg, int8=True)
    tcfg = TrainConfig(minibatch_size=BATCH, learning_rate=1e-4,
                       num_epochs=TRAIN_EPOCHS, seed=SEED,
                       compute_dtype="bfloat16", image_shape=IMAGE,
                       channels=CHANNELS)
    trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg,
                      coord_grid(*IMAGE, device=DEVICE), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    return trainer, blob_images(torch, N_TRAIN, gen), gen


def int8_step_readings(torch, trainer, data, gen) -> dict:
    """One K3 step (the first BATCH images) and one tail step (the first
    N_TRAIN % BATCH) through the kernels against the same steps through the
    plain versions, noise from ``gen``: kind -> (max rel, mean rel, the
    leaf of the max), each the worst over the gradient leaves."""
    data_t = trainer._dataset_yt(data)
    xq, sx = trainer._dataset_yq8(data)
    worst = {}
    for kind, n in (("k3", BATCH), ("k4k5", N_TRAIN % BATCH)):
        idx = torch.arange(n, device=DEVICE)
        y = data[idx]
        y_t, y_q8 = ((data_t[idx], (xq[idx], sx)) if kind == "k3"
                     else (None, None))
        noise = torch.randn((n, trainer.q_cfg.latent_dim), generator=gen,
                            device=DEVICE)
        kern = int8_step_grads(torch, trainer, y, y_t, y_q8, noise,
                               plain=False)
        plain = int8_step_grads(torch, trainer, y, y_t, y_q8, noise,
                                plain=True)
        rel, mean_rel, leaf = 0.0, 0.0, ""
        for k in kern:
            _, _, r, m = rel_errors(kern[k], plain[k])
            if r >= rel:
                rel, leaf = r, k
            mean_rel = max(mean_rel, m)
        worst[kind] = (rel, mean_rel, leaf)
        del kern, plain
    return worst


def _int8_evaluate(torch, trainer, data, epoch):
    """``eval_epoch`` through K4 alone (the float32 masters, no int8
    encoder, no Adam)."""
    evals = math.ceil(data.shape[0] / BATCH)
    _reset_all_launches()
    m = trainer.eval_epoch(data, epoch)
    torch.cuda.synchronize()
    got = _int8_launches()
    if got["k45"] != k45_launches(0, evals, k45_route(trainer, True)) or \
            any(got["k3"].values()) or any(got["k8"].values()) or \
            got["k12"] or \
            any(got["adam"].values()):
        raise AssertionError(f"evaluation launches {got}, expected "
                             f"K4 x {evals} only")
    return m


def phase_train_int8(torch, tmpdir: str) -> dict:
    """The galaxy trainer in int8 mode, bf16 compute (bench.py's default
    galaxy step, the TPU's whole stack: the loss differentiates the bf16
    shadow that Adam writes, the encoder's hidden GEMMs run on int8 with
    the int8 copies Adam emits, layer 0 reading the int8 data copy): two
    epochs of 1,037 blob images (20 K3 steps, 2 tail steps through K4 and
    K5, Adam's step kernel in every step), the evaluations before and after,
    one step of each kind through the kernels against the plain versions,
    profiled steps, an epoch of 16 steps at B=4096 with bf16 moments, and
    an epoch under SPATIALVAE_ADAM_EMIT=pallas (K7)."""
    trainer, data, gen = int8_galaxy_trainer(torch)
    evals = math.ceil(N_TRAIN / BATCH)
    before = _int8_evaluate(torch, trainer, data, 0)
    _reset_all_launches()
    t0 = time.perf_counter()
    rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _int8_launches()
    full = TRAIN_EPOCHS * (N_TRAIN // BATCH)
    tails = TRAIN_EPOCHS
    want_k3 = k3_launches(full, "sm90")
    want_k45 = k45_launches(tails)
    want_adam = int8_adam_launches(trainer, full + tails, seeded=True)
    if counts != {"k3": want_k3,
                  "k8": dict.fromkeys(("fwd", "grad", "dw", "sum"), 0),
                  "k45": want_k45, "k12": 0, "adam": want_adam}:
        raise AssertionError(f"launches over {full} + {tails} steps: "
                             f"{counts}, expected K3 {want_k3}, K4/K5 "
                             f"{want_k45}, Adam {want_adam}, no K1/K2")
    if _big_leaves(trainer) != 2 or not all(
            t.dtype == torch.bfloat16 for t in trainer.shadow.values()):
        raise AssertionError("the int8 step did not run the shadow and the "
                             "two int8 encoder copies")
    after = _int8_evaluate(torch, trainer, data, TRAIN_EPOCHS)
    if not (np.isfinite(rows).all() and np.isfinite(before + after).all()):
        raise AssertionError(f"non-finite metrics: {before} {rows} {after}")
    if not after[0] > before[0]:
        raise AssertionError(f"ELBO did not rise: {before[0]} -> {after[0]}")

    # one step of each kind through the kernels against the plain versions,
    # at the trained state that `--limits` reads too
    worst = int8_step_readings(torch, trainer, data, gen)
    for kind, (rel, mean_rel, leaf) in worst.items():
        if not (rel <= INT8_STEP_TOL[0] and mean_rel <= INT8_STEP_TOL[1]):
            raise AssertionError(f"int8 {kind} step gradients: kernel vs "
                                 f"plain {rel} ({leaf}), mean {mean_rel}; "
                                 f"limits {INT8_STEP_TOL}")
    data_t = trainer._dataset_yt(data)
    data_q8 = trainer._dataset_yq8(data)
    log("train_int8", epochs=TRAIN_EPOCHS, steps=full + tails,
        images=N_TRAIN, compute="bfloat16", stack="shadow+qshadow+int8enc",
        seconds=f"{seconds:.4f}",
        steps_per_s=f"{(full + tails) / seconds:.3f}",
        images_per_s=f"{TRAIN_EPOCHS * N_TRAIN / seconds:.1f}",
        elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
        epoch_elbo="/".join(f"{r[0]:.3f}" for r in rows),
        launches=json.dumps(counts, separators=(",", ":")),
        eval_k4_launches=evals,
        step_k3_vs_plain_max_rel=f"{worst['k3'][0]:.3e}",
        step_k3_vs_plain_mean_rel=f"{worst['k3'][1]:.3e}",
        step_k3_worst_leaf=worst["k3"][2],
        step_tail_vs_plain_max_rel=f"{worst['k4k5'][0]:.3e}",
        step_tail_vs_plain_mean_rel=f"{worst['k4k5'][1]:.3e}",
        step_tail_worst_leaf=worst["k4k5"][2])
    prof = phase_profile_int8(torch, trainer, data, data_t, data_q8, tmpdir)
    idx = torch.arange(BATCH, device=DEVICE)
    y_t, y_q8 = data_t[idx], (data_q8[0][idx], data_q8[1])
    phase_adam_path_ab(torch, "int8_k3", lambda: trainer.train_step(
        data[idx], y_t=y_t, y_q8=y_q8))
    cfgs = (trainer.q_cfg, trainer.p_cfg, trainer.ecfg, trainer.tcfg)
    del trainer, data, data_t, data_q8
    torch.cuda.empty_cache()
    (prof["bench_images_per_s"], prof["bench_adam"],
     prof["bench_step_ms"]) = phase_bench_int8(torch, *cfgs)
    prof["counts"] = counts
    prof["eval_k4"] = evals
    prof["emit_adam"] = phase_train_int8_emit(torch, before, rows[0])
    return prof


class env_set:
    """Within the block the environment holds ``values``; restored after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def phase_train_int8_emit(torch, before, default_epoch) -> dict:
    """One epoch of the ``[train_int8]`` trainer (same seed, images and
    noise) under SPATIALVAE_ADAM_EMIT=pallas: the two big encoder weights
    take K7 (their int8 copies quantised with the scale carried from the
    previous step), the other leaves K6, all in the step kernel's one
    launch; then an evaluation that must
    score above the untrained one.  Returns Adam's launches."""
    with env_set(SPATIALVAE_ADAM_EMIT="pallas", SPATIALVAE_ALLOW_KNOBS="1"):
        trainer, data, _ = int8_galaxy_trainer(torch)
        _reset_all_launches()
        t0 = time.perf_counter()
        m = trainer.train_epoch(data, 0, progress=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _int8_launches()
        steps = math.ceil(N_TRAIN / BATCH)
        want = int8_adam_launches(trainer, steps, seeded=True,
                                  engine="pallas")
        if counts["adam"] != want:
            raise AssertionError(f"Adam launches under pallas {counts['adam']}"
                                 f", expected {want}")
        carried = [e for e in trainer.qshadow.values() if e["q"].numel()]
        after = _int8_evaluate(torch, trainer, data, 1)
    if not (np.isfinite(m).all() and math.isfinite(after[0])):
        raise AssertionError(f"non-finite metrics under pallas: {m} {after}")
    if not after[0] > before[0]:
        raise AssertionError(f"ELBO did not rise under pallas: {before[0]} "
                             f"-> {after[0]}")
    log("train_int8_emit", engine="pallas", steps=steps, images=N_TRAIN,
        seconds=f"{seconds:.4f}", images_per_s=f"{N_TRAIN / seconds:.1f}",
        epoch_elbo=f"{m[0]:.3f}", default_engine_epoch_elbo=(
            f"{default_epoch[0]:.3f}"),
        elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
        carried_scales=len(carried),
        adam_launches=json.dumps(counts["adam"], separators=(",", ":")))
    del trainer, data
    torch.cuda.empty_cache()
    return counts["adam"]


def _label_ids(events, label: str) -> set:
    """Correlation ids of the runtime calls made inside the one
    ``record_function(label)`` span of a trace."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == label]
    if len(spans) != 1:
        raise AssertionError(f"{len(spans)} {label!r} labels in the trace")
    a0, a1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    return {e["args"].get("correlation") for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and a0 <= e["ts"] <= a1}


def _step_host_ms(torch, step, n: int) -> float:
    """Mean host-clock ms of ``n`` unprofiled steps, ending in a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_profile_int8(torch, trainer, data, data_t, data_q8, tmpdir: str,
                       model: str = "galaxy", runs=None) -> dict:
    """A K3 step (B=100, encoder input from the int8 data copy) and a tail
    step (B=37) under torch.profiler: each int8 kernel's device ms by name,
    Adam's kernels (inside the trainer's "adam" label), the step's device
    busy time and its idle share against the profiled step's host clock
    and against the mean of N_TIMED unprofiled steps.  The K3 step runs
    once more with the shadow and the int8 encoder off ("casts": the
    parameters cast to bf16 in every step and the encoder on bf16 GEMMs,
    Adam the plain K6 in the step kernel), to show what the two move.  ``runs`` picks among these
    three (stack, step kind, batch); ``model`` names the trainer's model in
    the lines."""
    from torch.profiler import ProfilerActivity, profile

    names = {"loss_fwd": "loss_fwd_kernel", "loss_grad": "loss_grad_kernel",
             "dw": "grouped_dw_kernel", "loss_fwd90": "loss_fwd90_kernel",
             "loss_grad90": "loss_grad90_kernel",
             "dw90": "grouped_dw90_kernel", "sum_rows": "sum_rows_kernel",
             "fwd_a1": "int8_fwd_kernel", "bwd_scale": "int8_bwd_scale",
             "bwd_grad": "int8_bwd_grad", "fwd90": "int8_fwd90_kernel",
             "scale90": "int8_scale90_kernel",
             "grad90": "int8_grad90_kernel", "adam_step": "adam_step_kernel",
             "k6": "adam_kernel", "quant_scale": "quant_scale_kernel",
             "quantize": "quantize_kernel"}
    out = {}
    for stack, kind, b in runs or (("full", "k3", BATCH),
                                   ("full", "tail", N_TRAIN % BATCH),
                                   ("casts", "k3", BATCH)):
        idx = torch.arange(b, device=DEVICE)
        y_t, y_q8 = ((data_t[idx], (data_q8[0][idx], data_q8[1]))
                     if kind == "k3" else (None, None))
        if stack == "casts":
            trainer._use_shadow = trainer._use_qenc = False
            trainer.shadow = trainer.qshadow = None
            y_q8 = None

        def step():
            trainer.train_step(data[idx], y_t=y_t, y_q8=y_q8)
        step()                                           # warm-up
        host_ms = _step_host_ms(torch, step, N_TIMED)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if stack == "casts":             # back to the stack, reseeded
            trainer._use_shadow = trainer._use_qenc = True
            trainer.shadow = trainer.qshadow = None
        events = _trace_events(prof, tmpdir,
                               f"train_int8_{model}_{stack}_{kind}.json")
        device = [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        kernels = [e for e in device if e.get("cat") == "kernel"]
        if not kernels:
            raise AssertionError("the profiler saw no kernel")
        busy = _busy_us(device)
        fields = {}
        for label, key in names.items():
            ms = sum(e["dur"] for e in kernels if key in e["name"]) / 1e3
            out[kind, label] = ms
            fields[f"{label}_ms"] = f"{ms:.3f}"
        gemm = sum(e["dur"] for e in kernels
                   if "gemm" in e["name"].lower()
                   or "xmma" in e["name"].lower()) / 1e3
        adam_ids = _label_ids(events, "adam")
        adam = [e for e in kernels
                if e["args"].get("correlation") in adam_ids]
        if stack == "full":
            out[kind, "idle_share"] = 1 - busy / wall_us
            out[kind, "adam_launches"] = len(adam)
        log("profile_int8_step", model=model, step=kind, B=b, stack=stack,
            wall_ms=f"{wall_us / 1e3:.3f}", device_busy_ms=f"{busy / 1e3:.3f}",
            idle_share=f"{1 - busy / wall_us:.4f}",
            unprofiled_step_ms=f"{host_ms:.3f}",
            unprofiled_idle_share=f"{1 - busy / 1e3 / host_ms:.4f}",
            **fields, gemm_ms=f"{gemm:.3f}",
            adam_ms=f"{sum(e['dur'] for e in adam) / 1e3:.3f}",
            adam_launches=len(adam), kernels=len(kernels))
    return out


def bench_k3_chunks(torch, route: str) -> list:
    """The workspace chunks, (first image, images), of a K3 call at the
    bench step (B=4,096, bf16 weights) on ``route``: the cluster route's dW1
    operands and a1c stash, the block route's dW1 operands, within this
    card's workspace budget."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.fused_decoder import workspace_budget
    from spatialvae_torch.kernels.fused_decoder_int8 import image_chunks

    block = l8.stash_block_bytes(True) if route == "sm90" else 0
    per = l8.loss_workspace_bytes(IMAGE[0] * IMAGE[1], P_HIDDEN, route, block)
    return image_chunks(BENCH_BATCH, per,
                        workspace_budget(torch.device(DEVICE)))


# images on each side of a workspace chunk's first image that the bench
# step's K3 call holds to the plain version
BENCH_EDGE = 3


def bench_k3_inputs(torch, model: str, gen) -> tuple:
    """K3's operands at bench.py's ``model`` step (B=4,096, 64x64, bf16
    weights; random from ``gen``): fold, coords, the weights (w1, b1, wht,
    bht) and the arguments of ``run_loss_int8`` after them, (y_t, mask,
    family).  Galaxy: int8 targets of three channels; colored: bf16
    targets pre-paired as (B, 2, HW/2), the unit-disc mask, coords
    chunk-permuted."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.train.trainer import yt_layout

    hw = IMAGE[0] * IMAGE[1]
    if model == "galaxy":
        fold, coords, ws = _int8_inputs(torch, BENCH_BATCH, "bfloat16", gen)
        k = torch.randint(0, 256, (BENCH_BATCH, CHANNELS, hw), generator=gen,
                          device=DEVICE)
        return fold, coords, ws, ((k - 128).to(torch.int8), None,
                                  "bernoulli")
    fold, coords, ws = _int8_inputs(torch, BENCH_BATCH, "bfloat16", gen,
                                    no=2)
    y = torch.rand((BENCH_BATCH, hw), generator=gen, device=DEVICE)
    coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
    return fold, coords, ws, (yt_layout(y.to(torch.bfloat16), hw, True),
                              disc_mask(torch, IMAGE), "colored")


def bench_k3_call(torch, model: str = "galaxy", nm=None) -> dict:
    """One K3 call at the shape of bench.py's ``model`` step (B=4,096
    galaxy or colored images, bf16 weights; random inputs from the seed,
    ``bench_k3_inputs``), at numerics ``nm`` (default: the defaults), on
    each design, in turns (AB_K3, the median of 3 each), with its bound.
    The cluster passes' outputs are held to the block passes' within
    INT8_TOL, and each design's loss and dfold of the first and last image
    and of BENCH_EDGE images on each side of every chunk boundary (the
    cluster route runs the call in several workspace chunks at this size)
    to the plain version run on those images alone, each run of them at its
    index in the call (SR's counters)."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fold, coords, ws, (yt, mask, family) = bench_k3_inputs(torch, model,
                                                            gen)
    hw, no, masked = IMAGE[0] * IMAGE[1], ws[2].shape[0], mask is not None
    nm = nm or Numerics()
    run = functools.partial(l8.run_loss_int8, fold, coords, *ws, yt, mask,
                            family, numerics=nm)
    chunks = {r: bench_k3_chunks(torch, r) for r in ("sm90", "block")}
    if len(chunks["sm90"]) < 2:
        raise AssertionError(f"B={BENCH_BATCH} K3 cluster route in "
                             f"{chunks['sm90']}: one workspace chunk")
    edges = sorted({0, BENCH_BATCH - 1} | {
        i for c in chunks.values() for b0, _ in c[1:]
        for i in range(b0 - BENCH_EDGE, b0 + BENCH_EDGE)})
    # the edge images in runs of consecutive indices
    runs = [[edges[0]]]
    for i in edges[1:]:
        if i == runs[-1][-1] + 1:
            runs[-1].append(i)
        else:
            runs.append([i])
    with torch.no_grad():
        got = {"sm90": run(), "block": run(block_passes=True)}
        # dfold of the edge images (the loss at [:, 3, 0])
        want = torch.cat([l8.loss_int8_reference(
            fold[r[0]:r[-1] + 1], coords, *ws, yt[r[0]:r[-1] + 1], mask,
            family, numerics=nm, image0=r[0])[0] for r in runs])
        vs_block = {n: _check_rel(f"K3 B={BENCH_BATCH} {model} cluster vs "
                                  f"block passes {n}", rel_errors(u, v),
                                  INT8_TOL)
                    for n, u, v in zip(
                        ("loss",) + INT8_GRADS,
                        (got["sm90"][0][:, 3, 0],) + tuple(got["sm90"]),
                        (got["block"][0][:, 3, 0],) + tuple(got["block"]))}
        vs_plain = {}
        for r, out in got.items():
            d = out[0][edges]
            for n, u, v in (("loss", d[:, 3, 0], want[:, 3, 0]),
                            ("dfold", d, want)):
                vs_plain[r, n] = _check_rel(
                    f"K3 B={BENCH_BATCH} {model} {r} passes at the chunk "
                    f"edges {n}", rel_errors(u, v), INT8_TOL)
        del got, want
        ab = in_turns(torch, {
            "sm90": run,
            "block": functools.partial(run, block_passes=True)}, 3)
    del fold, coords, ws, yt, mask
    torch.cuda.empty_cache()
    return {"sm90": ab["sm90"][0], "block": ab["block"][0],
            "turns": " ".join(f"{r}:{t:.3f}" for r in ("block", "sm90")
                              for t in ab[r][1]),
            # 1 target byte per (image, output, pixel): galaxy's int8, and
            # colored's bf16 over HW/2 pixels per output
            "bound": k3_bound(BENCH_BATCH, hw, P_HIDDEN, no, 2, 1, masked,
                              nm.sr),
            "chunks": {r: [b0 for b0, _ in c] for r, c in chunks.items()},
            "edges": len(edges), "vs_block": vs_block, "vs_plain": vs_plain}


def phase_bench_int8(torch, q_cfg, p_cfg, ecfg, tcfg, model="galaxy",
                     mask=None) -> tuple:
    """bench.py's ``model`` step (galaxy, or colored: particles
    --fit-noise under the unit-disc ``mask``): B=4096, 16 steps per epoch
    of images made on the card from the seed (galaxy on the /255 grid, as
    bench.py makes them for int8; colored uniform in [0, 1)), Adam's
    moments in bf16 (``SPATIALVAE_ADAM_MOMENTS=bf16``, as bench.py sets
    it); one warm-up epoch, then timed epochs on the host clock around work
    that ends in a synchronize, in turns (AB_K3) with K3 on the block passes
    and on the cluster passes.  The launches are the first cluster turn's:
    K3 on the cluster passes (every chunk's forward, gradient and dW1), none
    on the block passes.  A smoke reading of images/s, not a benchmark.
    Returns (images/s, Adam's launches in that epoch, route -> step ms)."""
    import contextlib

    from spatialvae_torch.train.trainer import Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    tcfg = dataclasses.replace(tcfg, minibatch_size=BENCH_BATCH)
    with env_set(SPATIALVAE_ADAM_MOMENTS="bf16"):
        trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg,
                          coord_grid(*IMAGE, device=DEVICE), mask=mask,
                          device=DEVICE)
    if not all(m.dtype == torch.bfloat16
               for m in trainer.opt_state.mu.values()):
        raise AssertionError("the bench trainer's moments are not bf16")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    n = BENCH_BATCH * BENCH_STEPS
    shape = (n, IMAGE[0] * IMAGE[1], tcfg.channels)
    if model == "galaxy":
        data = torch.randint(0, 256, shape, generator=gen, device=DEVICE,
                             dtype=torch.uint8).float() / 255.0
    else:
        data = torch.rand(shape, generator=gen, device=DEVICE)
    t0 = time.perf_counter()
    trainer.train_epoch(data, 0, progress=False)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    turns, counts, m = {}, None, None
    for i, route in enumerate(AB_K3):
        ctx = (on_block_passes() if route == "block"
               else contextlib.nullcontext())
        with ctx:
            _reset_all_launches()
            t0 = time.perf_counter()
            mi = trainer.train_epoch(data, 1 + i, progress=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        got = _int8_launches()
        want = k3_launches(BENCH_STEPS, route,
                          len(bench_k3_chunks(torch, route)))
        if got["k3"] != want:
            raise AssertionError(f"B={BENCH_BATCH} {model} {route} epoch K3 "
                                 f"launches {got['k3']}, expected {want}")
        turns.setdefault(route, []).append(seconds / BENCH_STEPS * 1e3)
        if route == "sm90" and counts is None:
            counts, m, secs = got, mi, seconds
    want_adam = int8_adam_launches(trainer, BENCH_STEPS, seeded=False)
    if any(counts["k45"].values()) or counts["adam"] != want_adam:
        raise AssertionError(f"B={BENCH_BATCH} {model} epoch launches "
                             f"{counts}, Adam expected {want_adam}")
    if not np.isfinite(m).all():
        raise AssertionError(f"B={BENCH_BATCH} {model} epoch metrics {m}")
    step_ms = {r: statistics.median(t) for r, t in turns.items()}
    del trainer, data
    torch.cuda.empty_cache()
    k3 = bench_k3_call(torch, model)
    log("train_int8_bench" if model == "galaxy"
        else f"train_{model}_int8_bench", model=model,
        family=ecfg.likelihood, mask=mask is not None,
        batch=BENCH_BATCH, steps=BENCH_STEPS, images=n,
        moments="bfloat16", warmup_s=f"{warm:.3f}", seconds=f"{secs:.4f}",
        step_ms=f"{step_ms['sm90']:.3f}",
        step_ms_block=f"{step_ms['block']:.3f}",
        turns=" ".join(f"{r}:{t:.3f}" for r in ("block", "sm90")
                       for t in turns[r]),
        images_per_s=f"{n / secs:.1f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        k3_ms=f"{k3['sm90']:.3f}", k3_ms_block=f"{k3['block']:.3f}",
        k3_bound_ms=f"{k3['bound'][0]:.3f}", k3_turns=k3["turns"],
        k3_chunks=json.dumps(k3["chunks"], separators=(",", ":")),
        k3_edge_images=k3["edges"],
        errors="max_abs/mean_abs/max_rel/mean_rel",
        **{f"k3_vs_block_{n}": e for n, e in k3["vs_block"].items()},
        **{f"k3_{r}_edges_vs_plain_{n}": e
           for (r, n), e in k3["vs_plain"].items()},
        max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
        launches=json.dumps(counts, separators=(",", ":")))
    step_ms["k3"] = k3
    return n / secs, counts["adam"], step_ms


def torch_sum_ms(torch, shapes) -> float:
    """The fixed-order reductions of a kernel's per-block partials as
    torch.sum calls (one per reduction, over dim 1 of each (groups, rows,
    m) array), timed together: the library yardstick of svt_sum_rows."""
    xs = [torch.randn(s, device=DEVICE) for s in shapes]

    def run():
        for x in xs:
            torch.sum(x, dim=1)
    run()
    return statistics.median(cuda_ms(run, torch) for _ in range(N_TIMED))


def _wmax(a, b) -> tuple:
    return tuple(max(x, y) for x, y in zip(a, b))


# K3's faulty copies for --limits k3: quantisation rounding toward zero, a
# gradient scale per 64-pixel block, the cluster passes' colored mean
# blocks paired with the block after them (ranks r and r ^ 1); and SR's
# (SR_FAULTS)
K3_FAULTS = (("-DSVT_INT8_RTZ=1",), ("-DSVT_INT8_BLOCK_SCALE=1",),
             ("-DSVT_COLORED90_PAIR_ADJACENT=1",))
# SR's faulty copies: the gradient site drawing the forward site's words,
# u = 0 (rounding down), the cluster passes' counters taking the row from
# the dW1 workspace's order; each must be refused by SR's cluster readings
SR_FAULTS = (("-DSVT_SR_SAME_SITE=1",), ("-DSVT_SR_FLOOR=1",),
             ("-DSVT_SR90_WS_ROW=1",))
# each K3 route's dh0 copy (it moves dh0 alone, every other output the
# sound passes'), the calls it serves and the limits run that builds it:
# the default cluster passes at H <= 512 ((1 - a0^2) from the pixel 8 rows
# on), SR's cluster passes (aq for dh0 read one dW1 workspace block off),
# the block passes of the knob modes, the levers and K8 ((1 - a0^2) from
# the pixel 8 rows on); dh0 must refuse each on its calls, and the loss,
# dW1, db1, dWh^T and dbh (dfold holds dh0's rows) must hold INT8_TOL
DH0_FAULTS = {("-DSVT_K3_90_DH0_ROW=1",): ("cluster", "k3"),
              ("-DSVT_SR90_AQ_OFF=1",): ("sr", "k3"),
              ("-DSVT_K3_DH0_ROW=1",): ("block", "numerics")}
# SR's readings in --limits k3 and --limits numerics: (FAMILY_CASES name or
# "galaxy", weight dtype), each on the cluster and on the block passes
SR_LIMIT_CASES = [("galaxy", "bfloat16"), ("galaxy", "float32"),
                  ("colored_mask", "bfloat16"), ("gaussian_mask", "float32")]


def k3w_limit_readings(torch, seed: int, worst: dict) -> None:
    """K3W_LIMIT_CASES' readings into ``worst``: per (route, case, dtype)
    the worst max and mean error relative to max|plain| over the loss and
    the five outputs ("K3_wide_<route>") and dh0's ("K3_wide_dh0_<route>",
    held at DH0_TOL)."""
    for name, dtype, h in K3W_LIMIT_CASES:
        with sized(h, K3W_LIMIT_B):
            for block_passes in (False, True):
                if name == "galaxy":
                    r = loss_case(torch, K3W_LIMIT_B, dtype, seed, False,
                                  block_passes=block_passes)
                else:
                    case = next(c for c in FAMILY_CASES if c[0] == name)
                    r = family_case(torch, case, dtype, seed, False,
                                    block_passes=block_passes)
                k = (f"K3_wide_{r['route']}", f"{name}_H{h}", dtype)
                for n in ("loss",) + INT8_GRADS:
                    worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
                kd = (f"K3_wide_dh0_{r['route']}", f"{name}_H{h}", dtype)
                worst[kd] = _wmax(worst.get(kd, (0, 0)), r["dh0"][2:])
        torch.cuda.empty_cache()


def sr_limit_readings(torch, seed: int, worst: dict) -> None:
    """SR_LIMIT_CASES' readings into ``worst``: per (route, case, dtype) the
    worst max and mean error relative to max|plain| over the loss and the
    five outputs ("K3_sr_<route>"), dh0's ("K3_dh0_sr_<route>"), and the
    quantised tiles' disagreements with the plain version's, the forward
    site's count and the gradient site's share ("K3_sr_ints_<route>")."""
    nm = _numerics(sr=True)
    for name, dtype in SR_LIMIT_CASES:
        for block_passes in (False, True):
            if name == "galaxy":
                r = loss_case(torch, BATCH, dtype, seed, False, nm=nm,
                              block_passes=block_passes)
            else:
                case = next(c for c in FAMILY_CASES if c[0] == name)
                r = family_case(torch, case, dtype, seed, False, nm=nm,
                                block_passes=block_passes)
            k = (f"K3_sr_{r['route']}", name, dtype)
            for n in ("loss",) + INT8_GRADS:
                worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
            kd = (f"K3_dh0_sr_{r['route']}", name, dtype)
            worst[kd] = _wmax(worst.get(kd, (0, 0)), r["dh0"][2:])
            ki = (f"K3_sr_ints_{r['route']}", name, dtype)
            worst[ki] = _wmax(worst.get(ki, (0, 0)), r["ints"])
        torch.cuda.empty_cache()


def sr_refusals(defines: tuple, worst: dict) -> None:
    """Raise unless the sound build holds every SR reading of ``worst``
    (INT8_TOL, the tiles as ``_check_ints`` holds them) and each copy of
    SR_FAULTS fails some SR reading on the cluster passes."""
    def holds(k, v):
        if k[0].startswith("K3_sr_ints"):
            return v[0] == 0 and v[1] <= SR_INT_SHARE
        return v[0] <= INT8_TOL[0] and v[1] <= INT8_TOL[1]

    sr = {k: holds(k, v) for k, v in worst.items()
          if k[0].startswith("K3_sr")}
    if not defines and not all(sr.values()):
        raise AssertionError(f"the sound build fails SR's limits: {worst}")
    if defines in SR_FAULTS and all(
            ok for k, ok in sr.items() if k[0].endswith("sm90")):
        raise AssertionError(f"the SR copy {defines} holds every cluster "
                             f"reading: {worst}")


def dh0_copy_readings(torch, kind: str, seed: int = 0) -> tuple:
    """The readings of DH0_FAULTS' calls of ``kind`` ("cluster": LOSS_CASES
    and FAMILY_CASES on the default cluster passes; "sr": SR_LIMIT_CASES on
    SR's cluster passes; "block": LOSS_CASES on the block passes, the knob
    modes, the levers and K8): (dh0's worst max/mean error relative to
    max|plain| per call, the worst over the loss, dW1, db1, dWh^T and dbh
    of every call)."""
    calls = []
    if kind == "cluster":
        calls += [functools.partial(loss_case, torch, b, dtype, seed, False,
                                    i8, masked)
                  for b, dtype, i8, masked in LOSS_CASES]
        calls += [functools.partial(family_case, torch, case, dtype, seed,
                                    False)
                  for case in FAMILY_CASES
                  for dtype in ("bfloat16", "float32")]
    elif kind == "sr":
        nm = _numerics(sr=True)
        for name, dtype in SR_LIMIT_CASES:
            calls.append(functools.partial(
                loss_case, torch, BATCH, dtype, seed, False, nm=nm)
                if name == "galaxy" else functools.partial(
                    family_case, torch,
                    next(c for c in FAMILY_CASES if c[0] == name), dtype,
                    seed, False, nm=nm))
    else:
        calls += [functools.partial(loss_case, torch, b, dtype, seed, False,
                                    i8, masked, block_passes=True)
                  for b, dtype, i8, masked in LOSS_CASES]
        calls += [functools.partial(loss_case, torch, BATCH, "bfloat16",
                                    seed, False, nm=_numerics(**kw))
                  for _, kw in NUMERICS_MODES + LEVER_MODES]
        calls += [functools.partial(k8_case, torch, mode, side, no,
                                    "bfloat16", seed, False)
                  for mode, side, no in K8_CASES]
    dh0, others = [], (0.0, 0.0)
    for call in calls:
        r = call()
        if kind != "block" and r.get("route") != "sm90":
            raise AssertionError(f"dh0 copy {kind}: route {r.get('route')}")
        dh0.append(tuple(r["dh0"][2:]))
        for n in ("loss", "dw1", "db1", "dwht", "dbht"):
            others = _wmax(others, r[n][2:])
        torch.cuda.empty_cache()
    return dh0, others


def dh0_refusals(torch, run: str) -> None:
    """The DH0_FAULTS copies of the limits run ``run`` ("k3" or
    "numerics"), each on its route's calls at one seed: raise unless dh0
    refuses every call (above DH0_TOL) while the loss, dW1, db1, dWh^T and
    dbh hold INT8_TOL; log each copy's readings."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    for defines, (kind, where) in DH0_FAULTS.items():
        if where != run:
            continue
        lib = k3_library(defines)
        d8._lib = l8._lib = (lambda lib=lib: lib)
        dh0, others = dh0_copy_readings(torch, kind)
        low = min(dh0, key=lambda e: e[0])
        refused = all(a > DH0_TOL[0] or m > DH0_TOL[1] for a, m in dh0)
        holds = others[0] <= INT8_TOL[0] and others[1] <= INT8_TOL[1]
        log("limits_dh0", build=" ".join(defines), calls=kind,
            dh0_lowest=f"{low[0]:.3e}/{low[1]:.3e}",
            dh0_highest=f"{max(a for a, _ in dh0):.3e}/"
                        f"{max(m for _, m in dh0):.3e}",
            others_worst=f"{others[0]:.3e}/{others[1]:.3e}",
            dh0_tol=DH0_TOL, int8_tol=INT8_TOL, refused_by_dh0=refused,
            others_hold=holds)
        if not (refused and holds):
            raise AssertionError(f"--limits {run}: the dh0 copy {defines} "
                                 f"is not refused by dh0 alone: dh0 {dh0}, "
                                 f"the other outputs {others}")
    d8._lib = l8._lib = (lambda: k3_library(()))


def phase_limits_k3(torch) -> None:
    """``--limits k3``: K3's readings against its plain version on the
    cluster passes and on the block passes (``block_passes``), for the
    sound library and for the copies of K3_FAULTS, SR_FAULTS and K3W_FAULTS
    (K3's units built in parallel, ``k3_library``), over three seeds
    (LOSS_CASES and FAMILY_CASES at the default numerics, SR_LIMIT_CASES
    under SR, K3W_LIMIT_CASES past H = 512; the K3W copies, which change
    nothing at H <= 512, the last alone): each build's worst max and mean
    error relative to max|plain| over the five outputs and the loss, by
    case kind and route, past 512 also dh0's, and SR's quantised tiles.
    The sound build must hold every reading within INT8_TOL (dh0 within
    DH0_TOL, SR's tiles as ``_check_ints``), the colored pairing's copy
    must not hold its colored cluster readings, each SR copy must fail
    SR's on the cluster passes, and each K3W copy the wide ones.  dh0 is
    read on every route (within DH0_TOL in the sound build), and the dh0
    copies of the cluster passes and SR (DH0_FAULTS) must be refused by it
    alone (``dh0_refusals``, one seed)."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    dh0_copies = tuple(d for d, (_, run) in DH0_FAULTS.items()
                       if run == "k3")
    build_k3_copies(K3_FAULTS + SR_FAULTS + K3W_FAULTS + dh0_copies)
    for defines in ((),) + K3_FAULTS + SR_FAULTS + K3W_FAULTS:
        lib = k3_library(defines)
        d8._lib = l8._lib = (lambda lib=lib: lib)
        worst = {}
        wide_only = defines in K3W_FAULTS
        for seed in range(3):
            if not defines or wide_only:
                k3w_limit_readings(torch, seed, worst)
            if wide_only:
                continue
            for b, dtype, i8, masked in LOSS_CASES:
                for block_passes in (False, True):
                    r = loss_case(torch, b, dtype, seed, False, i8, masked,
                                  block_passes=block_passes)
                    k = ("K3_" + r["route"], dtype)
                    for n in ("loss",) + INT8_GRADS:
                        worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
                    kd = ("K3_dh0_" + r["route"], dtype)
                    worst[kd] = _wmax(worst.get(kd, (0, 0)), r["dh0"][2:])
            for case in FAMILY_CASES:
                for dtype in ("bfloat16", "float32"):
                    for block_passes in (False, True):
                        r = family_case(torch, case, dtype, seed, False,
                                        block_passes=block_passes)
                        k = (f"K3_{case[1]}_{r['route']}", dtype)
                        for n in ("loss",) + INT8_GRADS:
                            worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
                        kd = (f"K3_dh0_{case[1]}_{r['route']}", dtype)
                        worst[kd] = _wmax(worst.get(kd, (0, 0)),
                                          r["dh0"][2:])
            sr_limit_readings(torch, seed, worst)
            torch.cuda.empty_cache()
        log("limits", build=" ".join(defines) or "sound",
            **{"/".join(k): f"{a:.3e}/{m:.3e}"
               for k, (a, m) in sorted(worst.items())})
        within = {k: a <= tol[0] and m <= tol[1]
                  for k, (a, m) in worst.items()
                  if not k[0].startswith("K3_sr")
                  for tol in [DH0_TOL if "dh0" in k[0] else INT8_TOL]}
        colored90 = [k for k in within if k[0] == "K3_colored_sm90"]
        if not defines and not all(within.values()):
            raise AssertionError(f"--limits k3: the sound build is outside "
                                 f"INT8_TOL or DH0_TOL: {worst}")
        if "COLORED90" in " ".join(defines) and any(within[k]
                                                    for k in colored90):
            raise AssertionError(f"--limits k3: the colored pairing's copy "
                                 f"is within INT8_TOL: {worst}")
        if wide_only and all(ok for k, ok in within.items()
                             if k[0] in ("K3_wide_sm90",
                                         "K3_wide_dh0_sm90")):
            raise AssertionError(f"--limits k3: the wide copy {defines} "
                                 f"holds every wide cluster reading: {worst}")
        sr_refusals(defines, worst)
    dh0_refusals(torch, "k3")


def phase_limits(torch) -> None:
    """``--limits``: the int8 kernels' readings against their plain versions
    for the sound library and for copies built with one step removed, over
    three seeds, and one training step of each kind at the state the smoke
    run checks (two epochs trained with the sound kernels, the same seed,
    images and noise), for the galaxy trainer and the three FAMILY_MODELS,
    to place INT8_TOL, INT8_Y_TOL, INT8_A1_TOL and INT8_STEP_TOL.  The
    copies: quantisation rounding toward zero; a gradient scale per 64-pixel
    block; the colored family pairing each 64-row mean tile with the tile
    after it instead of the one half a group further, on both designs; and,
    with the sound kernels, a padded call whose pad the mask does not
    cover."""
    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    trained = {"galaxy": int8_galaxy_trainer(torch)}
    trained.update({n: family_trainer(torch, n) for n in FAMILY_MODELS})
    for trainer, data, _ in trained.values():
        trainer.train_epochs(data, 0, TRAIN_EPOCHS)
    noise_state = {n: t[2].get_state() for n, t in trained.items()}
    label = {"gaussian": "K3_gaussian", "colored": "K3_colored",
             "bernoulli": "K3_padded"}

    def family_worst(worst, **kw):
        for seed in range(3):
            for case in FAMILY_CASES:
                if kw and l8.padded_hw(case[2] ** 2) == case[2] ** 2:
                    continue                       # no pad to leave open
                for dtype in ("bfloat16", "float32"):
                    r = family_case(torch, case, dtype, seed, False, **kw)
                    k = (label[case[1]], dtype)
                    for n in ("loss",) + INT8_GRADS:
                        worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
            torch.cuda.empty_cache()

    def show(build, worst):
        log("limits", build=build,
            **{"/".join(k).strip("/"): f"{a:.3e}/{m:.3e}"
               for k, (a, m) in sorted(worst.items())})

    for defines in ((), ("-DSVT_INT8_RTZ=1",), ("-DSVT_INT8_BLOCK_SCALE=1",),
                    ("-DSVT_COLORED_PAIR_ADJACENT=1",
                     "-DSVT_COLORED90_PAIR_ADJACENT=1")):
        lib = _build.load_library(defines)
        d8._lib = l8._lib = (lambda lib=lib: lib)
        worst = {}
        for seed in range(3):
            for b, dtype, i8, masked in LOSS_CASES:
                r = loss_case(torch, b, dtype, seed, False, i8, masked)
                for n in ("loss",) + INT8_GRADS:
                    k = ("K3", dtype)
                    worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
            for b, dtype in INT8_TAIL_CASES:
                r = int8_tail_case(torch, b, dtype, seed, False)
                for k in ("y", "y_no_a1", "a1"):
                    worst["K4", k] = _wmax(worst.get(("K4", k), (0, 0)),
                                           r[k][:2])
                for v in ("residual", "recompute"):
                    for n in INT8_GRADS:
                        worst["K5", v] = _wmax(worst.get(("K5", v), (0, 0)),
                                               r[v, n][2:])
            torch.cuda.empty_cache()
        family_worst(worst)
        for name, (trainer, data, gen) in trained.items():
            gen.set_state(noise_state[name])
            tag = "" if name == "galaxy" else name + "_"
            for kind, (rel, mean_rel, _) in int8_step_readings(
                    torch, trainer, data, gen).items():
                worst[f"step_{tag}{kind}", ""] = (rel, mean_rel)
        show(" ".join(defines) or "sound", worst)
        if not defines:
            worst = {}
            family_worst(worst, forced_mask=False)
            show("sound, pad left unmasked", worst)


# ---------------------------------------------------------------------------
# the families slice: K3's Gaussian, colored and padded families, and the
# three models of bench.py that train through them
# ---------------------------------------------------------------------------

# bench.py's configurations besides galaxy (bench.py:44-84)
FAMILY_MODELS = {
    "particles": dict(image=(64, 64), z=20, q_hidden=5000, n_out=1,
                      likelihood="gaussian", theta_prior=math.pi,
                      penalty=False, mask=True, on_grid=False),
    "colored": dict(image=(64, 64), z=20, q_hidden=5000, n_out=2,
                    likelihood="colored", theta_prior=math.pi,
                    penalty=False, mask=True, on_grid=False),
    "mnist": dict(image=(28, 28), z=2, q_hidden=500, n_out=1,
                  likelihood="bernoulli", theta_prior=math.pi / 4,
                  penalty=True, mask=False, on_grid=True),
}
# K3 against its plain version, at B=100 with f32 and bf16 weights: name,
# family, image side, unit-disc mask, int8 targets.  65x65 is the odd size a
# CTF forces on cryo-EM data (4,225 -> 4,352 pixels, 17 groups of 256); no
# model of the smoke run trains at it.
FAMILY_CASES = [
    ("gaussian_mask", "gaussian", 64, True, False),
    ("gaussian_mask_pad65", "gaussian", 65, True, False),
    ("bernoulli_pad28", "bernoulli", 28, False, True),
    ("colored_mask", "colored", 64, True, False),
    ("colored", "colored", 64, False, False),
]
# the case whose readings stand for a model's K3 call in the kernels record
FAMILY_ROWS = {"particles": ("int8_loss_gaussian", "gaussian_mask"),
               "colored": ("int8_loss_colored", "colored_mask"),
               "mnist": ("int8_loss_padded", "bernoulli_pad28")}


def disc_mask(torch, image):
    """The particles' pixel mask: 1 inside the unit disc of the grid."""
    from spatialvae_torch.transforms.coords import coord_grid

    grid = coord_grid(*image, device=DEVICE)
    return (grid.pow(2).sum(dim=1) <= 1.0).float()


def family_case(torch, case, dtype, seed, timed, forced_mask=True,
                nm=None, block_passes=False, b=None,
                target_dtype="bfloat16", mask_values=None) -> dict:
    """One of FAMILY_CASES against the plain version, the operands laid out
    as ``fused_bce_spatial_int8`` and the trainer's target copy lay them
    out: colored over chunk-permuted coords with pre-paired targets, a pixel
    count off the tiling zero-padded under a mask that is 0 on the pad.
    ``b`` images (default BATCH, read at the call: ``sized`` sets it);
    float targets arrive in ``target_dtype`` (bf16, the compute dtype of
    the training paths; the particles CLI's float32); ``mask_values`` the
    masked cases' pixel mask instead of the unit disc's.
    ``forced_mask=False`` leaves the pad unmasked in the kernel's call
    alone: the faulty copy that places the padded family's limits.  With
    ``timed`` also the call's bound, from the real (unpadded) pixels; ``nm``
    the numerics (default: the defaults); ``block_passes`` runs K3 on the
    block passes whatever its route."""
    import torch.nn.functional as F
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.train.trainer import build_yt_i8, yt_layout

    name, family, side, masked, i8 = case
    b = b or BATCH
    colored = family == "colored"
    hw, no = side * side, 2 if colored else 1
    wdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fold, coords, whid, bhid, wht, bht = _tail_inputs(
        torch, b, hw, P_HIDDEN, 1, no, wdt, gen)
    ws = (whid[0].contiguous(), bhid[0].contiguous(), wht, bht)
    if i8:
        y = torch.randint(0, 256, (b, hw), generator=gen,
                          device=DEVICE).float() / 255.0
        yt = build_yt_i8(y, hw, colored)
    else:
        y = 0.5 + 0.4 * torch.randn((b, hw), generator=gen,
                                    device=DEVICE)
        yt = yt_layout(y.to(getattr(torch, target_dtype)), hw, colored)
    mask = None
    if masked:
        mask = (disc_mask(torch, (side, side)) if mask_values is None
                else mask_values)
    pad = 0 if colored else l8.padded_hw(hw) - hw
    if colored:
        coords = l8.colored_coords(coords, l8.pick_tile(hw))
    elif pad:
        coords = F.pad(coords, (0, 0, 0, pad))
        yt = F.pad(yt, (0, pad), value=-128 if i8 else 0)
        base = torch.ones(hw, device=DEVICE) if mask is None else mask
        mask = F.pad(base, (0, pad))
    kernel_mask = mask if forced_mask or not pad else F.pad(
        base, (0, pad), value=1.0)
    args = (fold, coords.contiguous(), *ws, yt)
    if kernel_mask is mask:
        out = _loss_readings(torch, args, mask, family, timed, nm,
                             block_passes)
    else:
        with torch.no_grad():
            got = l8.run_loss_int8(*args, kernel_mask, family)
            want = l8.loss_int8_reference(*args, mask, family)
        out = {"loss": rel_errors(got[0][:, 3, 0], want[0][:, 3, 0])}
        out.update({n: rel_errors(u, v)
                    for n, u, v in zip(INT8_GRADS, got, want)})
    if timed:
        h = P_HIDDEN
        w_bytes = (h * h + h + no * h + no) * wdt.itemsize
        io = (b * 4 * h * 4 + hw * 2 * 4 + w_bytes
              + b * hw * yt.element_size()
              + (hw * 4 if masked else 0)
              + b * 4 * h * 4 + (h * h + h + no * h + no) * 4)
        out["bound"] = bound(io, (3 * 2.0 * b * hw * h * h, PEAK_INT8),
                             (3 * 2.0 * b * hw * h * no, PEAK_FP32))
        out["pixels"] = (hw, hw + pad)
    return out


def phase_loss_families(torch) -> dict:
    """K3's Gaussian, colored and padded families against the plain version
    at the shapes the three models give them, each on the cluster passes
    (every family's route at the default numerics), held to the block
    passes (every output within INT8_TOL, aq word for word, qi within
    SR_INT_SHARE) and timed in turns with them.  The bound counts the
    call's own inputs and outputs once and its three int8 GEMMs (forward,
    da0, dW1) plus the head's three products, over the real pixels."""
    res = {}
    for case in FAMILY_CASES:
        name, family, side, masked, i8 = case
        for dtype in ("bfloat16", "float32"):
            r = family_case(torch, case, dtype, SEED, timed=True)
            if not r["same"]:
                raise AssertionError(f"K3 {name} {dtype}: two runs differ")
            if r["route"] != "sm90":
                raise AssertionError(f"K3 {name} {dtype}: route "
                                     f"{r['route']}")
            fields = {n: _check_rel(f"K3 {name} {dtype} {n}", r[n], INT8_TOL)
                      for n in ("loss",) + INT8_GRADS}
            for n in ("loss",) + INT8_GRADS:
                _check_rel(f"K3 {name} {dtype} {n}, cluster vs block "
                           f"passes", r["vs_block"][n], INT8_TOL)
            fields["dh0"] = _check_dh0(f"K3 {name} {dtype}", r)
            log("kernel_loss_families", dh0_tol=DH0_TOL, case=name, family=family, B=BATCH,
                HW=r["pixels"][0], padded_HW=r["pixels"][1], H=P_HIDDEN,
                No=2 if family == "colored" else 1, dtype=dtype,
                targets="int8" if i8 else "bfloat16", mask=masked,
                route=r["route"], errors="max_abs/mean_abs/max_rel/mean_rel",
                **fields, max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
                ints_vs_plain=_check_ints(f"K3 {name} {dtype}", r),
                kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
                **_log_ab(r))
            res[name, dtype] = r
            torch.cuda.empty_cache()
    return res


def family_trainer(torch, name: str):
    """The int8 trainer of one of FAMILY_MODELS (bf16 compute, seed SEED),
    its 1,037 images and the generator that made them."""
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    m = FAMILY_MODELS[name]
    image = m["image"]
    q_cfg = InferenceConfig(n=image[0] * image[1], latent_dim=m["z"] + 3,
                            hidden_dim=m["q_hidden"], num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=m["z"], hidden_dim=P_HIDDEN,
                                   n_out=m["n_out"], num_layers=2)
    ecfg = ElboConfig(rotate=True, translate=True,
                      theta_prior=m["theta_prior"],
                      theta_mean_penalty=m["penalty"],
                      likelihood=m["likelihood"], channels=1, fused=True,
                      int8=True)
    tcfg = TrainConfig(minibatch_size=BATCH, learning_rate=1e-4,
                       num_epochs=TRAIN_EPOCHS, seed=SEED,
                       compute_dtype="bfloat16", image_shape=image,
                       channels=1)
    trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg,
                      coord_grid(*image, device=DEVICE),
                      mask=disc_mask(torch, image) if m["mask"] else None,
                      device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(
        SEED + 10 + sorted(FAMILY_MODELS).index(name))
    data = blob_images(torch, N_TRAIN, gen, image, 1, m["on_grid"])
    return trainer, data, gen


def float_family_step(torch, trainer, data, gen) -> tuple:
    """One float32 step of the model (its likelihood over the float decoder
    kernels K1 with activations and K2) against the same step over the
    plain decoder, at the trainer's weights: the worst gradient leaf's
    (max rel, mean rel, name)."""
    from spatialvae_torch.kernels import fused_decoder as fd

    ecfg = dataclasses.replace(trainer.ecfg, int8=False)
    y = data[:BATCH]
    noise = torch.randn((BATCH, trainer.q_cfg.latent_dim), generator=gen,
                        device=DEVICE)
    fd.reset_launches()
    kern = step_grads(torch, trainer, y, noise, True, ecfg)
    if fd.LAUNCHES["fwd_acts_sm90"] != 1 or \
            fd.LAUNCHES["bwd_chain_sm90"] != 1:
        raise AssertionError(f"the float step launched {dict(fd.LAUNCHES)}")
    plain = step_grads(torch, trainer, y, noise, False, ecfg)
    worst = (0.0, 0.0, "")
    for k in kern:
        _, _, rel, mean_rel = rel_errors(kern[k], plain[k])
        if not (rel <= STEP_TOL[0] and mean_rel <= STEP_TOL[1]):
            raise AssertionError(f"float step gradient {k}: kernel vs plain "
                                 f"{rel}, mean {mean_rel}; limits "
                                 f"{STEP_TOL}")
        worst = max(worst, (rel, mean_rel, k))
    return worst


def colored_serving(torch, trainer, data, gen, tmpdir: str) -> float:
    """The colored model's checkpoints written, loaded and served: one
    ``SpatialVae.reconstruct`` must return the predicted mean (B, HW, 1)
    and agree with the plain decoder on the same weights and noise."""
    from spatialvae_torch import checkpoint
    from spatialvae_torch.api import SpatialVae
    from spatialvae_torch.objectives import elbo_minibatch

    image = trainer.tcfg.image_shape
    gpath = os.path.join(tmpdir, "colored_generator_epoch2.sav")
    ipath = os.path.join(tmpdir, "colored_inference_epoch2.sav")
    checkpoint.save_model(gpath, "generator", trainer.p_net,
                          elbo=trainer.ecfg, image_shape=image)
    checkpoint.save_model(ipath, "inference", trainer.q_net,
                          elbo=trainer.ecfg, image_shape=image)
    model = SpatialVae.load(gpath, ipath, device=DEVICE)
    if model.ecfg != trainer.ecfg or model.p_cfg.n_out != 2 or not all(
            torch.equal(a, b) for a, b in zip(model.p_net.parameters(),
                                              trainer.p_net.parameters())):
        raise AssertionError("the colored checkpoint did not round-trip")
    y = data[:BATCH]
    noise = torch.randn((BATCH, trainer.q_cfg.latent_dim), generator=gen,
                        device=DEVICE)
    got = model.reconstruct(y, noise=noise)
    _check_images("colored reconstruct", got,
                  (BATCH, image[0] * image[1], 1), torch)
    _, _, _, want = elbo_minibatch(
        model.q_net, model.p_net,
        dataclasses.replace(model.serving_ecfg, fused=False), model.coords,
        y, noise=noise)
    return check_close("colored reconstruct", got, want, torch.float32)[0]


def phase_train_family(torch, name: str, tmpdir: str) -> dict:
    """One of FAMILY_MODELS through the trainer in int8 mode with bf16
    compute: an evaluation (K4), two epochs of 1,037 images (20 K3 steps in
    the model's family, 2 tails of 37 through K4 and K5, Adam's kernels on
    every step), an evaluation that must score higher, the launch counts,
    a K3 step and a tail step against the plain versions, a profiled K3
    step; then the float step and the serving checks that the model has.
    Colored also profiles its K3 step with K3 on the block passes (keys
    ("k3_block", kernel)) and runs bench.py's colored step
    (``phase_bench_int8``).  Returns the launch counts and the profiled
    steps' device ms."""
    from spatialvae_torch.kernels.fused_loss_int8 import padded_hw

    trainer, data, gen = family_trainer(torch, name)
    evals = math.ceil(N_TRAIN / BATCH)
    before = _int8_evaluate(torch, trainer, data, 0)
    _reset_all_launches()
    t0 = time.perf_counter()
    rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _int8_launches()
    full, tails = TRAIN_EPOCHS * (N_TRAIN // BATCH), TRAIN_EPOCHS
    # every family takes the cluster passes
    want = {"k3": k3_launches(full, "sm90"),
            "k8": {"fwd": 0, "grad": 0, "dw": 0, "sum": 0},
            "k45": k45_launches(tails),
            "k12": 0,
            "adam": int8_adam_launches(trainer, full + tails, seeded=True)}
    if counts != want:
        raise AssertionError(f"{name}: launches over {full} + {tails} "
                             f"steps {counts}, expected {want}")
    data_t = trainer._dataset_yt(data)
    hw = trainer.coords.shape[0]
    colored = name == "colored"
    yt_shape = (N_TRAIN, 2, hw // 2) if colored \
        else (N_TRAIN, 1, padded_hw(hw))
    yt_dtype = torch.int8 if FAMILY_MODELS[name]["on_grid"] \
        else torch.bfloat16
    if tuple(data_t.shape) != yt_shape or data_t.dtype != yt_dtype:
        raise AssertionError(f"{name}: target copy {tuple(data_t.shape)} "
                             f"{data_t.dtype}")
    after = _int8_evaluate(torch, trainer, data, TRAIN_EPOCHS)
    if not (np.isfinite(rows).all() and np.isfinite(before + after).all()):
        raise AssertionError(f"{name}: non-finite metrics {before} {rows} "
                             f"{after}")
    if not after[0] > before[0]:
        raise AssertionError(f"{name}: ELBO did not rise: {before[0]} -> "
                             f"{after[0]}")
    worst = int8_step_readings(torch, trainer, data, gen)
    for kind, (rel, mean_rel, leaf) in worst.items():
        if not (rel <= INT8_STEP_TOL[0] and mean_rel <= INT8_STEP_TOL[1]):
            raise AssertionError(f"{name} {kind} step gradients: kernel vs "
                                 f"plain {rel} ({leaf}), mean {mean_rel}; "
                                 f"limits {INT8_STEP_TOL}")
    extra = {}
    if name != "mnist":
        w = float_family_step(torch, trainer, data, gen)
        extra.update(float_step_vs_plain_max_rel=f"{w[0]:.3e}",
                     float_step_worst_leaf=w[2])
    if colored:
        err = colored_serving(torch, trainer, data, gen, tmpdir)
        extra.update(checkpoint_roundtrip="bitwise",
                     reconstruct_vs_plain=f"{err:.3e}")
    log(f"train_{name}_int8", epochs=TRAIN_EPOCHS, steps=full + tails,
        images=N_TRAIN, compute="bfloat16", family=trainer.ecfg.likelihood,
        pixels=hw, targets=f"{tuple(data_t.shape)}:{data_t.dtype}",
        int8_encoder_copies=_big_leaves(trainer), seconds=f"{seconds:.4f}",
        steps_per_s=f"{(full + tails) / seconds:.3f}",
        images_per_s=f"{TRAIN_EPOCHS * N_TRAIN / seconds:.1f}",
        elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
        epoch_elbo="/".join(f"{r[0]:.3f}" for r in rows),
        launches=json.dumps(counts, separators=(",", ":")),
        eval_k4_launches=evals,
        step_k3_vs_plain_max_rel=f"{worst['k3'][0]:.3e}",
        step_k3_vs_plain_mean_rel=f"{worst['k3'][1]:.3e}",
        step_k3_worst_leaf=worst["k3"][2],
        step_tail_vs_plain_max_rel=f"{worst['k4k5'][0]:.3e}",
        step_tail_vs_plain_mean_rel=f"{worst['k4k5'][1]:.3e}", **extra)
    prof = phase_profile_int8(torch, trainer, data, data_t,
                              trainer._dataset_yq8(data), tmpdir,
                              model=name, runs=(("full", "k3", BATCH),))
    if colored:
        # the block passes' device ms in the same step: the yardstick's
        # kernel records, and the step's A/B
        with on_block_passes():
            block = phase_profile_int8(torch, trainer, data, data_t,
                                       trainer._dataset_yq8(data), tmpdir,
                                       model="colored_block",
                                       runs=(("full", "k3", BATCH),))
        prof.update({("k3_block", k[1]): v for k, v in block.items()
                     if k[0] == "k3"})
    cfgs = (trainer.q_cfg, trainer.p_cfg, trainer.ecfg, trainer.tcfg)
    mask = trainer.mask
    del trainer, data, data_t
    torch.cuda.empty_cache()
    if colored:
        phase_bench_int8(torch, *cfgs, model="colored", mask=mask)
    return counts, prof


# ---------------------------------------------------------------------------
# the numerics slice: K3 (e), stochastic rounding; K3 (f), the other
# gradient modes, scales and epilogue; K8, the feature-major kernel's modes
# of K3's kernels
# ---------------------------------------------------------------------------

K8_REPLACES = "spatialvae_tpu/kernels/fused_loss_int8_t.py:184"
# SR's quantised tiles against the plain version's, which draws the same
# Philox words: the forward site's must agree exactly; at the gradient site
# a head sum in another order moves q by an ulp across a rounding boundary
# now and then, as it does for round-to-nearest, so at most this share may
# differ (placed by `--limits numerics` between the sound kernel and copies
# drawing the gradient site's words from the forward site's stream or
# taking u = 0)
SR_INT_SHARE = 1e-4
# Philox4x32-10: about 100 integer operations per call (10 rounds of two
# 32-bit multiplies, their high halves, four xors and the key's two adds)
PHILOX_OPS = 100
# the (f) modes at the galaxy shape: (name, environment); i4fwd is i4dw1's
# alias, i8 and da0_i4 take the tile scale
NUMERICS_MODES = [
    ("i8", dict(grad_mode="i8")),
    ("da0_i4", dict(grad_mode="da0_i4")),
    ("i4fwd_tile", dict(grad_mode="i4fwd", gscale="tile")),
    ("i4dw1_epi_f32", dict(epi="f32")),
    ("i8_epi_f32", dict(grad_mode="i8", epi="f32")),
]
# K3 (f) in the other families: (FAMILY_CASES name, numerics)
NUMERICS_FAMILY = [("bernoulli_pad28", dict(grad_mode="da0_i4", epi="f32")),
                   ("colored_mask", dict(grad_mode="i8", sr=True))]
# the trained paths: (tag, environment, targets on the /255 grid, kernel)
KNOB_PATHS = [
    ("train_int8_sr", {"SPATIALVAE_SR": "1"}, True, "k3"),
    ("train_int8_numerics", {"SPATIALVAE_INT4_GRADS": "i8",
                             "SPATIALVAE_EPI": "f32"}, True, "k3"),
    ("train_int8_t", {"SPATIALVAE_LOSS_LAYOUT": "t"}, False, "k8"),
    ("train_int8_levers", {"SPATIALVAE_DB1": "qi", "SPATIALVAE_A1Q": "1"},
     True, "k3"),
]


def _numerics(**kw):
    from spatialvae_torch.kernels.config import Numerics

    return Numerics(**kw)


def k3_bound(b, hw, h, no, wdt_bytes, yt_bytes, masked, sr) -> tuple:
    """K3's call: its own inputs and outputs once, its three int8 GEMMs
    (forward, da0, dW1) and the head's three products, and with ``sr`` the
    Philox calls of both sites (one per 4 columns of each (image, pixel),
    counted at the CUDA cores' 32-bit rate)."""
    w_bytes = (h * h + h + no * h + no) * wdt_bytes
    io = (b * 4 * h * 4 + hw * 2 * 4 + w_bytes + b * no * hw * yt_bytes
          + (hw * 4 if masked else 0) + b * 4 * h * 4
          + (h * h + h + no * h + no) * 4)
    work = [(3 * 2.0 * b * hw * h * h, PEAK_INT8),
            (3 * 2.0 * b * hw * h * no, PEAK_FP32)]
    if sr:
        work.append((2 * b * hw * (h / 4) * PHILOX_OPS, PEAK_FP32))
    return bound(io, *work)


def _check_ints(what, r) -> str:
    fwd, share = r["ints"]
    if fwd or share > SR_INT_SHARE:
        raise AssertionError(f"{what}: quantised tiles differ from the plain "
                             f"version's: forward {fwd} elements, gradient "
                             f"share {share}; limits 0, {SR_INT_SHARE}")
    return f"{fwd}/{share:.2e}"


# K3 (e) in the other families (FAMILY_CASES names), at B=100
SR_FAMILY_CASES = ("gaussian_mask", "bernoulli_pad28", "colored_mask",
                   "colored")
# SR's one-ulp check: a b1[0] one ulp away must round at least this share of
# aq otherwise
SR_MOVED = 0.05


def _sr_fields(what, r) -> dict:
    """The checks of one SR reading (``_loss_readings``): two runs bit for
    bit, the five outputs and the loss within INT8_TOL of the plain version,
    the quantised tiles against the plain version's (``_check_ints``), on
    the cluster route against the block passes too (``_log_ab``), and a b1
    one ulp away moving more than SR_MOVED of aq; returns the log fields."""
    if not r["same"]:
        raise AssertionError(f"{what}: two runs differ")
    if r["route"] != "sm90":
        raise AssertionError(f"{what}: route {r['route']}")
    fields = {n: _check_rel(f"{what} {n}", r[n], INT8_TOL)
              for n in ("loss",) + INT8_GRADS}
    for n in ("loss",) + INT8_GRADS:
        _check_rel(f"{what} {n}, cluster vs block passes", r["vs_block"][n],
                   INT8_TOL)
    fields["dh0"] = _check_dh0(what, r)
    if not r["moved"] > SR_MOVED:
        raise AssertionError(f"{what}: another b1 moved only {r['moved']} "
                             f"of the forward tile")
    return {"route": r["route"], "errors": "max_abs/mean_abs/max_rel/mean_rel",
            **fields, "max_rel_tol": INT8_TOL[0],
            "mean_rel_tol": INT8_TOL[1], "dh0_tol": DH0_TOL,
            "ints_fwd_differ_grad_share": _check_ints(what, r),
            "rerun": "bitwise", "next_step_fwd_share_moved":
                f"{r['moved']:.3f}", **_log_ab(r)}


def phase_loss_sr(torch) -> dict:
    """K3 (e), stochastic rounding, on the cluster passes (its route since
    this slice) at the galaxy shape (B=100) with bf16 and f32 weights and
    in SR_FAMILY_CASES (Gaussian 64x64 under the disc mask, 28x28 padded,
    colored with and without the mask): each call against its plain
    version, which draws the same Philox words (the quantised tiles, the
    five outputs within INT8_TOL), against the block passes (the same
    checks) and timed in turns with them, two runs bit for bit, and a call
    with b1 moved by one ulp (the next step's words) that must round
    differently; then SR at bench.py's B=4,096 (galaxy and colored + mask,
    bf16; ``bench_k3_call``) in turns with the block passes.  Returns the
    readings, and under "block_launches" the block passes' launches in the
    phase (their checks and turns: the yardstick's)."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    res = {}
    nm = _numerics(sr=True)
    hw = IMAGE[0] * IMAGE[1]
    block0 = l8.LAUNCHES["fwd"]
    for dtype in ("bfloat16", "float32"):
        r = loss_case(torch, BATCH, dtype, SEED, True, nm=nm)
        fields = _sr_fields(f"K3 SR {dtype}", r)
        r["bound"] = k3_bound(BATCH, hw, P_HIDDEN, CHANNELS,
                              getattr(torch, dtype).itemsize, 1, False, True)
        log("kernel_loss_sr", case="galaxy", B=BATCH, HW=hw, H=P_HIDDEN,
            No=CHANNELS, dtype=dtype, **fields,
            kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
        res[dtype] = r
        torch.cuda.empty_cache()
    for name in SR_FAMILY_CASES:
        case = next(c for c in FAMILY_CASES if c[0] == name)
        for dtype in ("bfloat16", "float32"):
            r = family_case(torch, case, dtype, SEED, True, nm=nm)
            fields = _sr_fields(f"K3 SR {name} {dtype}", r)
            log("kernel_loss_sr", case=name, family=case[1], B=BATCH,
                HW=r["pixels"][0], padded_HW=r["pixels"][1], H=P_HIDDEN,
                No=2 if case[1] == "colored" else 1, dtype=dtype, **fields,
                kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
            res[name, dtype] = r
            torch.cuda.empty_cache()
    for model in ("galaxy", "colored"):
        k3 = bench_k3_call(torch, model, nm)
        log("kernel_loss_sr_bench", model=model, B=BENCH_BATCH, HW=hw,
            H=P_HIDDEN, dtype="bfloat16", k3_ms=f"{k3['sm90']:.3f}",
            k3_ms_block=f"{k3['block']:.3f}", turns=k3["turns"],
            bound_ms=f"{k3['bound'][0]:.3f}", bound_by=k3["bound"][1],
            chunks=json.dumps(k3["chunks"], separators=(",", ":")),
            edge_images=k3["edges"],
            errors="max_abs/mean_abs/max_rel/mean_rel",
            **{f"vs_block_{n}": e for n, e in k3["vs_block"].items()},
            **{f"{r}_edges_vs_plain_{n}": e
               for (r, n), e in k3["vs_plain"].items()},
            max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1])
        res["bench", model] = k3
    res["block_launches"] = l8.LAUNCHES["fwd"] - block0
    return res


def phase_loss_numerics(torch) -> dict:
    """K3 (f) at the galaxy shape (B=100, bf16 weights) in each of
    NUMERICS_MODES, and in the padded and colored families
    (NUMERICS_FAMILY): kernel against plain version, the quantised tiles,
    two runs bit for bit, ms and bound."""
    res = {}
    hw = IMAGE[0] * IMAGE[1]
    for name, kw in NUMERICS_MODES:
        nm = _numerics(**kw)
        r = loss_case(torch, BATCH, "bfloat16", SEED, True, nm=nm)
        r["bound"] = k3_bound(BATCH, hw, P_HIDDEN, CHANNELS, 2, 1, False,
                              nm.sr)
        res[name] = r
        _log_numerics(name, "bernoulli", hw, CHANNELS, r)
        torch.cuda.empty_cache()
    for case_name, kw in NUMERICS_FAMILY:
        case = next(c for c in FAMILY_CASES if c[0] == case_name)
        nm = _numerics(**kw)
        r = family_case(torch, case, "bfloat16", SEED, True, nm=nm)
        name = f"{case_name}_{nm.grad_mode}_{nm.epi}" + ("_sr" if nm.sr
                                                        else "")
        res[name] = r
        _log_numerics(name, case[1], r["pixels"][0],
                      2 if case[1] == "colored" else 1, r)
        torch.cuda.empty_cache()
    return res


def _log_numerics(name, family, hw, no, r) -> None:
    if not r["same"]:
        raise AssertionError(f"K3 {name}: two runs differ")
    fields = {n: _check_rel(f"K3 {name} {n}", r[n], INT8_TOL)
              for n in ("loss",) + INT8_GRADS}
    fields["dh0"] = _check_dh0(f"K3 {name}", r)
    log("kernel_loss_numerics", mode=name, family=family, B=BATCH, HW=hw,
        H=P_HIDDEN, No=no, dtype="bfloat16",
        errors="max_abs/mean_abs/max_rel/mean_rel", **fields,
        max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1], dh0_tol=DH0_TOL,
        ints_fwd_differ_grad_share=_check_ints(f"K3 {name}", r),
        kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
        bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])


def k8_case(torch, mode, side, no, dtype, seed, timed) -> dict:
    """K8 against its plain version on one batch of float targets: each
    output's errors (db1 apart: the limit copy's target), two runs bit for
    bit, with ``timed`` ms and the bound (K3 (a)'s three int8 GEMMs at the
    same shapes, the head's products, its inputs and outputs once)."""
    from spatialvae_torch.kernels import fused_loss_int8_t as lt

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    hw = side * side
    fold, coords, whid, bhid, wht, bht = _tail_inputs(
        torch, BATCH, hw, P_HIDDEN, 1, no, getattr(torch, dtype), gen)
    ws = (whid[0].contiguous(), bhid[0].contiguous(), wht, bht)
    yt = torch.rand((BATCH, no, hw), generator=gen, device=DEVICE)
    fold_t = fold.transpose(1, 2).contiguous()
    args = (fold_t, coords, *ws, yt)
    out = {}
    with torch.no_grad():
        got = lt.run_loss_int8_t(*args, mode)
        again = lt.run_loss_int8_t(*args, mode)
        want = lt.loss_int8_t_reference(*args, mode)
        out["same"] = all(torch.equal(u, v) for u, v in zip(got, again))
        out["loss"] = rel_errors(got[0][:, 0, 3], want[0][:, 0, 3])
        # dfoldT's three gradient columns on their own scale
        out["dh0"] = rel_errors(got[0][..., :3], want[0][..., :3])
        for name, u, v in zip(INT8_GRADS, got, want):
            out[name] = rel_errors(u, v)
        del got, again, want
        if timed:
            out["ms"], out["plain_ms"] = _timed(
                torch, lambda: lt.run_loss_int8_t(*args, mode),
                lambda: lt.loss_int8_t_reference(*args, mode))
            out["bound"] = k3_bound(BATCH, hw, P_HIDDEN, no,
                                    getattr(torch, dtype).itemsize, 4,
                                    False, False)
    return out


# K8 at the galaxy shape and at mnist's 784 pixels (one group of 784)
K8_CASES = [("i4", 64, CHANNELS), ("i8", 64, CHANNELS), ("i4", 28, 1),
            ("i8", 28, 1)]


def phase_loss_t(torch) -> dict:
    """K8's two modes at the galaxy shape (B=100, 3 outputs) and at mnist's
    28x28 (B=100, one output, 784 pixels in one group), bf16 weights."""
    res = {}
    for mode, side, no in K8_CASES:
        r = k8_case(torch, mode, side, no, "bfloat16", SEED, True)
        if not r["same"]:
            raise AssertionError(f"K8 {mode} {side}: two runs differ")
        fields = {n: _check_rel(f"K8 {mode} {side}px {n}", r[n], INT8_TOL)
                  for n in ("loss",) + INT8_GRADS}
        fields["dh0"] = _check_dh0(f"K8 {mode} {side}px", r)
        log("kernel_loss_t", mode=mode, B=BATCH, HW=side * side,
            group=1024 if side == 64 else side * side, H=P_HIDDEN, No=no,
            dtype="bfloat16", targets="float32",
            errors="max_abs/mean_abs/max_rel/mean_rel", **fields,
            max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
            dh0_tol=DH0_TOL,
            kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
        res[mode, side] = r
        torch.cuda.empty_cache()
    return res


def k3_knob_route(torch) -> str:
    """The route of the galaxy trainer's K3 calls at the environment's
    numerics."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import numerics

    hw = IMAGE[0] * IMAGE[1]
    return l8.k3_route(hw, P_HIDDEN, l8.pick_tile(hw), "bernoulli",
                       numerics())


def off_grid(torch, data, gen):
    """The images moved off the /255 grid inside [0, 1] (path C's targets
    stay float, as the JAX trainer leaves off-grid data)."""
    u = torch.rand(data.shape, generator=gen, device=DEVICE)
    return (data + (0.2 + 0.2 * u) / 255.0).clamp(0.0, 1.0)


def phase_train_knobs(torch, tag, env, on_grid, kernel) -> dict:
    """The ``[train_int8]`` galaxy trainer (bf16 compute, the TPU's whole
    stack; same seed and images, moved off the /255 grid for K8) under the
    knobs ``env`` with SPATIALVAE_ALLOW_KNOBS=1: an evaluation, two epochs
    whose 20 full batches take ``kernel`` (K3 at the knobs' numerics, on the
    route ``k3_route`` gives them: the cluster passes' keys for SR, the block
    passes' for the others; or K8) and none of the other, the two tails K4
    and K5, an evaluation that
    must score higher, and one full step and one tail step through the
    kernels against the same steps through the plain versions.  Returns the
    launch counts and the step readings."""
    with env_set(SPATIALVAE_ALLOW_KNOBS="1", **env):
        trainer, data, gen = int8_galaxy_trainer(torch)
        if not on_grid:
            data = off_grid(torch, data, gen)
        before = _int8_evaluate(torch, trainer, data, 0)
        _reset_all_launches()
        t0 = time.perf_counter()
        rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _int8_launches()
        full = TRAIN_EPOCHS * (N_TRAIN // BATCH)
        tails = TRAIN_EPOCHS
        run = {"fwd": full, "grad": full, "dw": full, "sum": 5 * full}
        # K3 on the route of the knobs' numerics: the cluster passes for SR
        # alone, the block passes for the others
        route = k3_knob_route(torch) if kernel == "k3" else None
        want = {"k3": k3_launches(full, route),
                "k8": run if kernel == "k8" else dict.fromkeys(run, 0),
                "k45": k45_launches(tails),
                "k12": 0,
                "adam": int8_adam_launches(trainer, full + tails,
                                           seeded=True)}
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts}, expected "
                                 f"{want}")
        data_t = trainer._dataset_yt(data)
        if (data_t.dtype == torch.int8) != on_grid:
            raise AssertionError(f"{tag}: target copy {data_t.dtype}")
        after = _int8_evaluate(torch, trainer, data, TRAIN_EPOCHS)
        if not (np.isfinite(rows).all()
                and np.isfinite(before + after).all()):
            raise AssertionError(f"{tag}: non-finite metrics {before} {rows} "
                                 f"{after}")
        if not after[0] > before[0]:
            raise AssertionError(f"{tag}: ELBO did not rise: {before[0]} -> "
                                 f"{after[0]}")
        worst = int8_step_readings(torch, trainer, data, gen)
        for kind, (rel, mean_rel, leaf) in worst.items():
            if not (rel <= INT8_STEP_TOL[0] and mean_rel <= INT8_STEP_TOL[1]):
                raise AssertionError(f"{tag} {kind} step gradients: kernel "
                                     f"vs plain {rel} ({leaf}), mean "
                                     f"{mean_rel}; limits {INT8_STEP_TOL}")
        log(tag, env=json.dumps(env, separators=(",", ":")),
            k3_route=route or "-",
            epochs=TRAIN_EPOCHS, steps=full + tails, images=N_TRAIN,
            compute="bfloat16", stack="shadow+qshadow+int8enc",
            targets=f"{tuple(data_t.shape)}:{data_t.dtype}",
            seconds=f"{seconds:.4f}",
            steps_per_s=f"{(full + tails) / seconds:.3f}",
            images_per_s=f"{TRAIN_EPOCHS * N_TRAIN / seconds:.1f}",
            elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
            epoch_elbo="/".join(f"{r[0]:.3f}" for r in rows),
            launches=json.dumps(counts, separators=(",", ":")),
            step_vs_plain_max_rel=f"{worst['k3'][0]:.3e}",
            step_vs_plain_mean_rel=f"{worst['k3'][1]:.3e}",
            step_worst_leaf=worst["k3"][2],
            step_tail_vs_plain_max_rel=f"{worst['k4k5'][0]:.3e}",
            step_tail_vs_plain_mean_rel=f"{worst['k4k5'][1]:.3e}")
        del trainer, data, data_t
    torch.cuda.empty_cache()
    return {"counts": counts, "worst": worst}


def phase_limits_numerics(torch) -> None:
    """``--limits numerics``: K3 (e), (f), (g) and K8's readings for the
    sound library and for copies built with one step broken (K3's units in
    parallel, ``k3_library``), over three seeds: SR's copies (SR_FAULTS:
    the gradient site drawing the forward site's words, u = 0, i.e.
    rounding down, the cluster passes' counters taking the row from the dW1
    workspace's order), db1 from the pre-round q (-DSVT_T_DB1_PREROUND=1:
    K8's db1 and DB1=qi's), the Pade lever on the exact tanh
    (-DSVT_PADE_EXACT=1) and A1Q's a1 at each block's own scale
    (-DSVT_A1Q_TILE_SCALE=1); they place INT8_TOL and SR_INT_SHARE for K3's
    modes, its levers and K8.  SR's readings (SR_LIMIT_CASES, the cluster
    and the block passes): the sound build must hold them, and each SR copy
    must fail some on the cluster passes.  dh0 is read everywhere (within
    DH0_TOL in the sound build), and the block passes' dh0 copy
    (DH0_FAULTS) must be refused by it alone on the modes, levers and K8
    (``dh0_refusals``, one seed)."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    copies = SR_FAULTS + (("-DSVT_T_DB1_PREROUND=1",),
                          ("-DSVT_PADE_EXACT=1",),
                          ("-DSVT_A1Q_TILE_SCALE=1",))
    dh0_copies = tuple(d for d, (_, run) in DH0_FAULTS.items()
                       if run == "numerics")
    build_k3_copies(copies + dh0_copies)
    for defines in ((),) + copies:
        lib = k3_library(defines)
        d8._lib = l8._lib = (lambda lib=lib: lib)
        worst = {}
        for seed in range(3):
            sr_limit_readings(torch, seed, worst)
            for name, kw in NUMERICS_MODES:
                r = loss_case(torch, BATCH, "bfloat16", seed, False,
                              nm=_numerics(**kw))
                for n in ("loss",) + INT8_GRADS:
                    worst["K3_f", name] = _wmax(
                        worst.get(("K3_f", name), (0, 0)), r[n][2:])
                worst["K3_dh0_f", name] = _wmax(
                    worst.get(("K3_dh0_f", name), (0, 0)), r["dh0"][2:])
                worst["K3_f_ints", name] = _wmax(
                    worst.get(("K3_f_ints", name), (0, 0)), r["ints"])
            for name, kw in LEVER_MODES:
                r = loss_case(torch, BATCH, "bfloat16", seed, False,
                              nm=_numerics(**kw))
                for n in ("loss",) + INT8_GRADS:
                    worst["K3_g", name] = _wmax(
                        worst.get(("K3_g", name), (0, 0)), r[n][2:])
                worst["K3_dh0_g", name] = _wmax(
                    worst.get(("K3_dh0_g", name), (0, 0)), r["dh0"][2:])
                worst["K3_g_ints", name] = _wmax(
                    worst.get(("K3_g_ints", name), (0, 0)), r["ints"])
            for mode, side, no in K8_CASES:
                r = k8_case(torch, mode, side, no, "bfloat16", seed, False)
                k = ("K8", f"{mode}_{side}")
                for n in ("loss",) + INT8_GRADS:
                    worst[k] = _wmax(worst.get(k, (0, 0)), r[n][2:])
                worst[k + ("db1",)] = _wmax(worst.get(k + ("db1",), (0, 0)),
                                            r["db1"][2:])
                worst["K8_dh0", k[1]] = _wmax(
                    worst.get(("K8_dh0", k[1]), (0, 0)), r["dh0"][2:])
            torch.cuda.empty_cache()
        log("limits", build=" ".join(defines) or "sound",
            **{"/".join(map(str, k)): f"{a:.3e}/{m:.3e}"
               for k, (a, m) in sorted(worst.items())})
        sr_refusals(defines, worst)
        dh0 = {k: v for k, v in worst.items() if "dh0" in k[0]}
        if not defines and not all(a <= DH0_TOL[0] and m <= DH0_TOL[1]
                                   for a, m in dh0.values()):
            raise AssertionError(f"--limits numerics: the sound build's dh0 "
                                 f"is outside DH0_TOL: {dh0}")
    dh0_refusals(torch, "numerics")


# ---------------------------------------------------------------------------
# Adam: the step kernel (one launch a step over every leaf: K6, K7 and the
# emission's scales), its yardstick the per-leaf K6 (update, optional shadow
# and abs-max) and K7 (update + shadow + int8 copy with the carried scale),
# and the fresh-scale emission's two helpers
# ---------------------------------------------------------------------------

ADAM_SOURCE = "spatialvae_torch/kernels/csrc/adam.cu"
ADAM90_SOURCE = "spatialvae_torch/kernels/csrc/adam_sm90.cu"
K6_REPLACES = "spatialvae_tpu/train/optimizer_pallas.py:53"
K7_REPLACES = "spatialvae_tpu/train/optimizer_pallas.py:129"
# quantize_leaf, which XLA fuses on the TPU (no Pallas kernel)
QUANT_REPLACES = "spatialvae_tpu/train/optimizer_pallas.py:104"
ADAM_LR = 1e-4
ADAM_COUNT = 7          # a step whose bias corrections are far from 1
# every galaxy leaf: (name, gradient dtype, moment dtype, shadow), the
# float step, the int8 step ([train_int8], f32 moments) and the bench step
# ([train_int8_bench], SPATIALVAE_ADAM_MOMENTS=bf16)
ADAM_CASES = [("f32", "float32", "float32", False),
              ("bf16g_shadow", "bfloat16", "float32", True),
              ("bf16_shadow", "bfloat16", "bfloat16", True)]
# the int8 step's configuration again with ZERO_COLUMNS of every leaf's
# last dimension zero in g, m and v, as an input pixel that is 0 in every
# image of a batch zeroes a column of the first layer's gradient (and, step
# after step, its moments): the divisions' slow path for zero operands
ADAM_ZERO_CASE = ("bf16g_shadow_zeros", "bfloat16", "float32", True)
ZERO_COLUMNS = 0.4
# K7 on the two big encoder weights, f32 and bf16 moments
EMIT_CASES = [("f32m", "float32"), ("bf16m", "bfloat16")]
# the per-leaf kernels and the step kernel in turns
AB_ADAM = ("leaf", "step", "step", "leaf")
# calls per timed run of Adam, back to back between two CUDA events: the
# wrappers' host work (the step's table, the per-leaf checks) then overlaps
# the card's, as in a training step, instead of standing before one launch
ADAM_REPS = 10


def cuda_ms_back_to_back(fn, torch, n: int = ADAM_REPS) -> float:
    """ms per call over ``n`` calls of ``fn`` between two CUDA events."""
    return cuda_ms(lambda: [fn() for _ in range(n)], torch) / n


def adam_turns(torch, fns: dict) -> dict:
    """name -> (median ms, each turn's ms): the turns of AB_ADAM, each the
    median of 3 back-to-back runs."""
    turns = {}
    for name in AB_ADAM:
        fns[name]()
        turns.setdefault(name, []).append(statistics.median(
            cuda_ms_back_to_back(fns[name], torch) for _ in range(3)))
    return {n: (statistics.median(t), t) for n, t in turns.items()}


def adam_step_per_leaf(p, g, m, v, k, shadow=None, modes=None, s_in=None):
    """``adam_step`` through the per-leaf kernels, the training paths' Adam
    before the step kernel: K6 or K7 on each leaf, and a ``quant_scale``
    launch for each leaf's scales (the same outputs, bit for bit)."""
    from spatialvae_torch.kernels import adam as ka

    out = []
    for i, md in enumerate(modes or [ka.PLAIN] * len(p)):
        sh = None if shadow is None else shadow[i]
        if md == ka.EMIT:
            q, amax = ka.adam_emit(p[i], g[i], m[i], v[i], k, sh, s_in[i])
            out.append((q, amax, ka.quant_scale(amax)))
        elif md == ka.FRESH:
            amax = ka.adam_leaf(p[i], g[i], m[i], v[i], k, sh, True)
            out.append((amax, *ka.quant_scale(amax, twin=True)))
        else:
            ka.adam_leaf(p[i], g[i], m[i], v[i], k, sh)
            out.append(None)
    return out


class per_leaf_adam:
    """Within the block the training paths' Adam takes the per-leaf kernels
    (``adam_step_per_leaf``) in place of the step kernel; restored after."""

    def __enter__(self):
        from spatialvae_torch.kernels import adam as ka
        from spatialvae_torch.train import optimizer

        self.saved = ka.adam_step, optimizer.adam_step
        ka.adam_step = optimizer.adam_step = adam_step_per_leaf
        return self

    def __exit__(self, *exc):
        from spatialvae_torch.kernels import adam as ka
        from spatialvae_torch.train import optimizer

        ka.adam_step, optimizer.adam_step = self.saved
        return False


def phase_adam_path_ab(torch, path: str, step) -> dict:
    """``[adam_path_ab]``: the unprofiled ms of a training step (``step``)
    with Adam on the step kernel and on the per-leaf kernels, in turns
    (AB_ADAM), each the mean of N_TIMED steps after one warm-up step; each
    turn must launch its own Adam kernels and not the other's."""
    from spatialvae_torch.kernels import adam as ka

    turns = {}
    for name in AB_ADAM:
        with per_leaf_adam() if name == "leaf" else contextlib.nullcontext():
            step()
            before = dict(ka.LAUNCHES)
            turns.setdefault(name, []).append(
                _step_host_ms(torch, step, N_TIMED))
            ran = {n: ka.LAUNCHES[n] - before[n] for n in before}
        leaf = ran["adam"] + ran["adam_emit"]
        if (name == "leaf") != (leaf > 0) or \
                (name == "step") != (ran["adam_step"] > 0):
            raise AssertionError(f"{path} {name} turn launched {ran}")
    ab = {n: (statistics.median(t), t) for n, t in turns.items()}
    log("adam_path_ab", path=path, steps_per_turn=N_TIMED,
        step_ms=f"{ab['step'][0]:.4f}", leaf_ms=f"{ab['leaf'][0]:.4f}",
        step_vs_leaf=f"{ab['step'][0] / ab['leaf'][0]:.4f}",
        turns=turns_field(ab))
    return ab


def adam_host_us(torch, fn, n: int = 20) -> float:
    """The median host-clock µs of one call of ``fn`` (until it returns,
    not until its kernels end), each called on an idle card."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def turns_field(ab) -> str:
    return " ".join(f"{n}:{t:.4f}" for n in ("leaf", "step")
                    for t in ab[n][1])


def galaxy_leaves(torch) -> dict:
    """``q.<name>``/``p.<name>`` -> shape of every galaxy parameter leaf."""
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator

    q_cfg, p_cfg, _ = galaxy_configs()
    nets = (("q", InferenceNetwork(q_cfg, device="meta")),
            ("p", SpatialGenerator(p_cfg, device="meta")))
    return {f"{k}.{n}": tuple(t.shape) for k, net in nets
            for n, t in net.named_parameters()}


def _adam_leaf_inputs(torch, shape, gdt, mdt, shadow, gen) -> list:
    """[p, g, m, v, shadow or None] of one leaf, on the card."""
    def r(scale):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    return [r(0.02), r(1e-3).to(gdt), r(1e-4).to(mdt),
            (torch.rand(shape, generator=gen, device=DEVICE) * 1e-6).to(mdt),
            torch.empty(shape, dtype=torch.bfloat16, device=DEVICE)
            if shadow else None]


def _adam_inputs(torch, shapes, gdt, mdt, shadow, seed,
                 zeros: float = 0.0) -> list:
    """The leaves' inputs; ``zeros``: that share of each leaf's last-dim
    columns zero in g, m and v."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    leaves = [_adam_leaf_inputs(torch, s, getattr(torch, gdt),
                                getattr(torch, mdt), shadow, gen)
              for s in shapes]
    for x in leaves if zeros else ():
        cols = torch.rand(x[0].shape[-1], generator=gen,
                          device=DEVICE) < zeros
        for t in x[1:4]:
            t[..., cols] = 0
    return leaves


def _clone_leaves(leaves) -> list:
    return [[None if t is None else t.clone() for t in x] for x in leaves]


def _n_differ(got, want) -> int:
    """How many elements of got differ from want, bit for bit (-0.0 and
    0.0 differ; equal NaNs do not)."""
    import torch

    if got is None:
        return 0
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    return int((got.reshape(-1).view(bits) !=
                want.reshape(-1).view(bits)).sum().item())


def _leaf_differ(leaves, refs) -> dict:
    """Differing elements of p', m', v' and the shadow over the leaves."""
    return {what: sum(_n_differ(x[i], r[i]) for x, r in zip(leaves, refs))
            for what, i in (("p", 0), ("m", 2), ("v", 3), ("shadow", 4))}


def _max_abs(pairs) -> float:
    return max(((u.float() - v.float()).abs().max().item()
                for u, v in pairs if u is not None and u.numel()),
               default=0.0)


def adam_step_call(ka, leaves, k, modes, s_in=None, step=None):
    """``ka.adam_step`` (or ``step``, its plain version) over the leaves."""
    shadow = None if leaves[0][4] is None else [x[4] for x in leaves]
    return (step or ka.adam_step)(
        [x[0] for x in leaves], [x[1] for x in leaves],
        [x[2] for x in leaves], [x[3] for x in leaves], k, shadow, modes,
        s_in)


# the names of a step's per-leaf outputs, by mode (kernels/adam.py FRESH,
# EMIT)
STEP_OUTPUTS = {1: ("amax", "s", "ns"), 2: ("q", "amax", "ns")}


def adam_step_differ(leaves, refs, got, want, modes) -> tuple:
    """(differing elements of every output of a step against its plain
    version, the largest absolute difference)."""
    differ = _leaf_differ(leaves, refs)
    pairs = [(x[j], r[j]) for x, r in zip(leaves, refs) for j in (0, 2, 3, 4)]
    for u, w, md in zip(got, want, modes):
        for name, a, b in zip(STEP_OUTPUTS.get(md, ()), u or (), w or ()):
            differ[name] = differ.get(name, 0) + _n_differ(a, b)
            pairs.append((a, b))
    return differ, _max_abs(pairs)


def adam_check(name, differ) -> None:
    if any(differ.values()):
        raise AssertionError(f"{name}: elements that differ from the plain "
                             f"version {differ}")


def fused_adam_ms(torch, leaves) -> float:
    """``torch._fused_adam_`` over float32 copies of the leaves' p, g, m,
    v: the library's fused Adam (another op order, no shadow or int8
    copy)."""
    ps, gs, ms, vs = ([x[i].float().clone() for x in leaves]
                      for i in range(4))
    steps = [torch.full((), float(ADAM_COUNT), device=DEVICE)
             for _ in leaves]

    def run():
        torch._fused_adam_(ps, gs, ms, vs, [], steps, lr=ADAM_LR, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=1e-8,
                           amsgrad=False, maximize=False)
    run()
    out = statistics.median(cuda_ms_back_to_back(run, torch)
                            for _ in range(3))
    del ps, gs, ms, vs, steps
    return out


def tbps(nbytes: float, ms: float) -> str:
    return f"{nbytes / ms / 1e9:.3f}"


def phase_adam_kernels(torch) -> dict:
    """One step's Adam on every galaxy leaf (86.9 M parameters) in the
    three configurations of the training paths and the int8 step's with
    zero columns (ADAM_ZERO_CASE), the abs-max and the fresh
    scales on the two leaves the int8 paths quantise: the step kernel and
    the per-leaf K6 each against the plain version on the same inputs, bit
    for bit; the two timed in turns (``adam_turns``: whole steps, the step
    kernel with its zero-filled buffer, the per-leaf kernels with their 13
    launches), then the plain version and ``_fused_adam_``, with the
    achieved TB/s and the share of the bound."""
    from spatialvae_torch.kernels import adam as ka

    shapes = list(galaxy_leaves(torch).values())
    k = ka.AdamConsts.make(ADAM_LR, 0.9, 0.999, 1e-8, ADAM_COUNT)
    n_params = sum(math.prod(s) for s in shapes)
    out = {}
    for name, gdt, mdt, shadow in ADAM_CASES + [ADAM_ZERO_CASE]:
        base = _adam_inputs(torch, shapes, gdt, mdt, shadow, SEED,
                            ZERO_COLUMNS if name.endswith("zeros") else 0.0)
        amax_on = [shadow and len(s) == 2 and math.prod(s) >= _qenc_min()
                   for s in shapes]
        modes = [ka.FRESH if a else ka.PLAIN for a in amax_on]
        refs, step_in = _clone_leaves(base), _clone_leaves(base)
        want = adam_step_call(ka, refs, k, modes,
                              step=ka.adam_step_reference)
        got = adam_step_call(ka, step_in, k, modes)
        got_leaf = [ka.adam_leaf(*x[:4], k, x[4], a)
                    for x, a in zip(base, amax_on)]
        torch.cuda.synchronize()
        differ, err = adam_step_differ(step_in, refs, got, want, modes)
        leaf_differ = _leaf_differ(base, refs)
        leaf_differ["amax"] = sum(_n_differ(a, w[0]) for a, w in
                                  zip(got_leaf, want) if a is not None)
        leaf_err = _max_abs([(x[j], r[j]) for x, r in zip(base, refs)
                             for j in (0, 2, 3, 4)] + [
            (a, w[0]) for a, w in zip(got_leaf, want) if a is not None])
        adam_check(f"the step kernel, K6 {name}", differ)
        adam_check(f"the per-leaf K6 {name}", leaf_differ)
        del refs, want, got, got_leaf
        ab = adam_turns(torch, {
            "leaf": lambda: [ka.adam_leaf(*x[:4], k, x[4], a)
                             for x, a in zip(base, amax_on)],
            "step": lambda: adam_step_call(ka, step_in, k, modes)})
        plain_ms = statistics.median(cuda_ms(
            lambda: adam_step_call(ka, base, k, modes,
                                   step=ka.adam_step_reference), torch)
            for _ in range(N_TIMED))
        lib_ms = fused_adam_ms(torch, base)
        # the wrappers' host work a step, and the step wrapper's parts
        shadows = None if not shadow else [x[4] for x in step_in]
        cols = [[x[i] for x in step_in] for i in range(4)]
        host = {
            "step": lambda: adam_step_call(ka, step_in, k, modes),
            "step_check": lambda: ka._check_step(*cols, shadows, modes,
                                                 None),
            "step_table": lambda: ka.step_table(*cols, shadows, None, None,
                                                modes),
            "step_zero_fill": lambda: torch.zeros(3 * len(shapes) + 1,
                                                  device=DEVICE),
            "leaf": lambda: [ka.adam_leaf(*x[:4], k, x[4], a)
                             for x, a in zip(base, amax_on)]}
        host_us = {n: adam_host_us(torch, fn) for n, fn in host.items()}
        g_b, m_b = getattr(torch, gdt).itemsize, getattr(torch, mdt).itemsize
        per_param = g_b + 4 * m_b + 8 + (2 if shadow else 0)
        nbytes = n_params * per_param
        bd = bound(nbytes, (12.0 * n_params, PEAK_FP32))
        step_ms, leaf_ms = ab["step"][0], ab["leaf"][0]
        out[name] = dict(err=err, leaf_err=leaf_err, ms=step_ms,
                         leaf_ms=leaf_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                         bound=bd)
        log("kernel_adam", case=name, grads=gdt, moments=mdt, shadow=shadow,
            leaves=len(shapes), params=n_params, fresh_leaves=sum(amax_on),
            differ=json.dumps(differ, separators=(",", ":")),
            leaf_differ=json.dumps(leaf_differ, separators=(",", ":")),
            max_abs_err=f"{err:.3e}", step_ms=f"{step_ms:.4f}",
            leaf_ms=f"{leaf_ms:.4f}", turns=turns_field(ab),
            plain_ms=f"{plain_ms:.4f}", fused_adam_ms=f"{lib_ms:.4f}",
            bytes_per_param=per_param, bound_ms=f"{bd[0]:.4f}",
            bound_by=bd[1], step_tbps=tbps(nbytes, step_ms),
            leaf_tbps=tbps(nbytes, leaf_ms),
            fused_adam_tbps=tbps(n_params * 28, lib_ms),
            step_share_of_bound=f"{bd[0] / step_ms:.4f}",
            leaf_share_of_bound=f"{bd[0] / leaf_ms:.4f}",
            step_vs_fused_adam=f"{step_ms / lib_ms:.4f}",
            **{f"{n}_host_us": f"{u:.1f}" for n, u in host_us.items()})
        del base, step_in
        torch.cuda.empty_cache()
    return out


def phase_adam_emit_kernels(torch) -> dict:
    """The two big encoder weights (q L0 (5000, 12288), q L1 (5000, 5000)),
    both emission engines: under ``pallas`` the step kernel's K7 leaves and
    the per-leaf K7 with ``quant_scale`` each against the plain version, bit
    for bit in p', m', v', the shadow, q, max|p'| and the next scale ns;
    the fresh-scale engine (the step kernel's FRESH leaves with their s and
    ns, then ``quantize_many``, one launch over both) against its plain
    version; each engine's step kernel and per-leaf kernels timed in turns
    (AB_ADAM), then the plain versions, ``quantize_many`` and
    ``quant_scale`` against theirs, and ``_fused_adam_``."""
    from spatialvae_torch.kernels import adam as ka

    shapes = [s for s in galaxy_leaves(torch).values()
              if len(s) == 2 and math.prod(s) >= _qenc_min()]
    k = ka.AdamConsts.make(ADAM_LR, 0.9, 0.999, 1e-8, ADAM_COUNT)
    n = sum(math.prod(s) for s in shapes)
    emit, fresh = [ka.EMIT] * len(shapes), [ka.FRESH] * len(shapes)
    out = {}
    for name, mdt in EMIT_CASES:
        base = _adam_inputs(torch, shapes, "bfloat16", mdt, True, SEED + 3)
        # the carried scale: the abs-max of the leaf before the step
        s_in = [ka.quant_scale_reference(x[0].abs().max().reshape(1))
                for x in base]
        refs, step_in = _clone_leaves(base), _clone_leaves(base)
        want = adam_step_call(ka, refs, k, emit, s_in,
                              step=ka.adam_step_reference)
        got = adam_step_call(ka, step_in, k, emit, s_in)
        got_leaf = [ka.adam_emit(*x[:4], k, x[4], s)
                    for x, s in zip(base, s_in)]
        ns_leaf = [ka.quant_scale(a) for _, a in got_leaf]
        torch.cuda.synchronize()
        differ, err = adam_step_differ(step_in, refs, got, want, emit)
        leaf_differ = {**_leaf_differ(base, refs), **{
            f: sum(_n_differ(u, w[i]) for u, w in zip(us, want))
            for f, i, us in (("q", 0, [u[0] for u in got_leaf]),
                             ("amax", 1, [u[1] for u in got_leaf]),
                             ("ns", 2, ns_leaf))}}
        adam_check(f"the step kernel, K7 {name}", differ)
        adam_check(f"the per-leaf K7 {name}", leaf_differ)
        leaf_err = _max_abs(
            [(x[j], r[j]) for x, r in zip(base, refs) for j in (0, 2, 3, 4)]
            + [(u[i], w[i]) for u, w in zip(got_leaf, want) for i in (0, 1)]
            + [(u, w[2]) for u, w in zip(ns_leaf, want)])
        # the fresh-scale engine on the states the step left
        f_refs, f_in = _clone_leaves(refs), _clone_leaves(refs)
        f_want = adam_step_call(ka, f_refs, k, fresh,
                                step=ka.adam_step_reference)
        f_got = adam_step_call(ka, f_in, k, fresh)
        q_got = ka.quantize_many([x[0] for x in f_in],
                                 [u[1] for u in f_got])
        torch.cuda.synchronize()
        f_differ, f_err = adam_step_differ(f_in, f_refs, f_got, f_want,
                                           fresh)
        q_want = [ka.quantize_reference(x[0], w[1])
                  for x, w in zip(f_refs, f_want)]
        f_differ["q"] = sum(_n_differ(q, w) for q, w in zip(q_got, q_want))
        q_err = _max_abs(list(zip(q_got, q_want)))
        adam_check(f"the step kernel, fresh scales {name}", f_differ)
        del refs, want, got, got_leaf, ns_leaf, f_refs, f_want, f_got
        del q_got, q_want
        fresh_s = [ka.quant_scale_reference(x[0].abs().max().reshape(1))
                   for x in base]

        def k7_leaf():
            for x, s in zip(base, s_in):
                ka.quant_scale(ka.adam_emit(*x[:4], k, x[4], s)[1])

        def fresh_leaf():
            for x in base:
                a = ka.adam_leaf(*x[:4], k, x[4], True)
                s, _ = ka.quant_scale(a, twin=True)
                ka.quantize(x[0], s)

        def fresh_step():
            o = adam_step_call(ka, f_in, k, fresh)
            ka.quantize_many([x[0] for x in f_in], [u[1] for u in o])

        ab_k7 = adam_turns(torch, {
            "leaf": k7_leaf,
            "step": lambda: adam_step_call(ka, step_in, k, emit, s_in)})
        ab_fresh = adam_turns(torch, {"leaf": fresh_leaf,
                                      "step": fresh_step})
        times = {"k7_step": ab_k7["step"][0], "k7_leaf": ab_k7["leaf"][0],
                 "fresh_step": ab_fresh["step"][0],
                 "fresh_leaf": ab_fresh["leaf"][0]}
        times["k7_plain"] = statistics.median(cuda_ms(
            lambda: adam_step_call(ka, base, k, emit, s_in,
                                   step=ka.adam_step_reference), torch)
            for _ in range(N_TIMED))
        for label, fn in (
                ("quantize", lambda: ka.quantize_many(
                    [x[0] for x in base], fresh_s)),
                ("quantize_plain", lambda: [
                    ka.quantize_reference(x[0], s)
                    for x, s in zip(base, fresh_s)]),
                ("quant_scale", lambda: ka.quant_scale(
                    fresh_s[0].reshape(1))),
                ("quant_scale_plain", lambda: ka.quant_scale_reference(
                    fresh_s[0].reshape(1)))):
            fn()
            times[label] = statistics.median(cuda_ms_back_to_back(fn, torch)
                                             for _ in range(3))
        times["fused_adam"] = fused_adam_ms(torch, base)
        m_b = getattr(torch, mdt).itemsize
        per_param = 2 + 4 * m_b + 8 + 2 + 1
        bd = bound(n * per_param, (14.0 * n, PEAK_FP32))
        out[name] = dict(err=max(err, f_err), leaf_err=leaf_err,
                         q_err=q_err, times=times, bound=bd,
                         quantize_bound=bound(5.0 * n),
                         scale_bound=bound(12.0))
        log("kernel_adam_emit", case=name, grads="bfloat16", moments=mdt,
            leaves=len(shapes), params=n,
            differ=json.dumps(differ, separators=(",", ":")),
            leaf_differ=json.dumps(leaf_differ, separators=(",", ":")),
            fresh_differ=json.dumps(f_differ, separators=(",", ":")),
            max_abs_err=f"{max(err, f_err):.3e}",
            **{f"{a}_ms": f"{b:.4f}" for a, b in times.items()},
            k7_turns=turns_field(ab_k7), fresh_turns=turns_field(ab_fresh),
            bytes_per_param=per_param, bound_ms=f"{bd[0]:.4f}",
            k7_step_tbps=tbps(n * per_param, times["k7_step"]),
            k7_leaf_tbps=tbps(n * per_param, times["k7_leaf"]),
            fused_adam_tbps=tbps(n * 28, times["fused_adam"]),
            k7_step_share_of_bound=f"{bd[0] / times['k7_step']:.4f}",
            quantize_bound_ms=f"{out[name]['quantize_bound'][0]:.4f}",
            quantize_tbps=tbps(5.0 * n, times["quantize"]))
        del base, step_in, f_in, fresh_s
        torch.cuda.empty_cache()
    return out


def adam90_name(mangled: str) -> str:
    """adam_step_kernel<G, M, SHADOW> from its mangled name."""
    import re

    m = re.search(r"adam_step_kernelI(\w+?)EEv", mangled)
    if not m:
        return mangled
    args, bf = m.group(1), "13__nv_bfloat16"
    g = "bf16" if args.startswith(bf) else "f32"
    mom = "f32" if args[len(bf) if g == "bf16" else 1:][:1] == "f" else "bf16"
    sh = "shadow" if "Lb1E" in args + "E" else "none"
    return f"adam_step_kernel<{g},{mom},{sh}>"


def phase_adam90(torch, ptxas) -> dict:
    """``[adam90]``: the step kernel's ptxas report (registers, stack,
    spills; ``ptxas``: the background compile of its source) and, for each
    instantiation the training paths run, its ring's stages, its dynamic
    shared memory and the CTAs an SM holds."""
    import ctypes

    from spatialvae_torch.kernels import adam as ka

    for name, regs, stack, stores, loads in ptxas_report(ptxas):
        log("adam90_ptxas", kernel=adam90_name(name), registers=regs,
            stack_bytes=stack, spill_store_bytes=stores,
            spill_load_bytes=loads)
    lib = ka._lib()
    out = {}
    for g, m, sh in ((0, 0, 0), (1, 0, 1), (1, 1, 1)):
        info = (ctypes.c_int * 4)()
        if lib.svt_adam_step_info(g, m, sh, info) != 0 or info[3] < 1:
            raise AssertionError(f"the step kernel <{g},{m},{sh}> does not "
                                 f"fit an SM: {list(info)}")
        out[g, m, sh] = list(info)
        log("adam90", grads="bf16" if g else "f32",
            moments="bf16" if m else "f32", shadow=bool(sh),
            stages=info[0], smem_bytes=info[1], chunk=info[2],
            ctas_per_sm=info[3])
    return out


def phase_limits_adam(torch) -> None:
    """``--limits adam``: the step kernel against its plain version on the
    galaxy leaves in the three K6 configurations and both K7 ones, for the
    sound library and two faulty copies (-DSVT_ADAM_FMA=1: b1*m contracted
    into an FMA; -DSVT_ADAM_DROP_TAIL=1: every aligned leaf's plain-load
    tail skipped), built in parallel: differing elements per case.  The
    sound build must differ in none, each faulty copy must be refused by
    some case."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import adam as ka

    faulty = (("-DSVT_ADAM_FMA=1",), ("-DSVT_ADAM_DROP_TAIL=1",))
    with ThreadPoolExecutor(len(faulty)) as pool:
        list(pool.map(_build.build, faulty))
    shapes = list(galaxy_leaves(torch).values())
    big = [s for s in shapes if len(s) == 2 and math.prod(s) >= _qenc_min()]
    k = ka.AdamConsts.make(ADAM_LR, 0.9, 0.999, 1e-8, ADAM_COUNT)
    cases = [(name, shapes, gdt, mdt, shadow,
              [ka.FRESH if shadow and s in big else ka.PLAIN
               for s in shapes])
             for name, gdt, mdt, shadow in ADAM_CASES + [ADAM_ZERO_CASE]]
    cases += [(f"k7_{name}", big, "bfloat16", mdt, True,
               [ka.EMIT] * len(big))
              for name, mdt in EMIT_CASES]
    sound_lib = ka._lib
    totals = {}
    try:
        for defines in ((),) + faulty:
            lib = _build.load_library(defines)
            ka._lib = (lambda lib=lib: lib)
            build = " ".join(defines) or "sound"
            totals[build] = 0
            for name, sh, gdt, mdt, shadow, modes in cases:
                base = _adam_inputs(torch, sh, gdt, mdt, shadow, SEED,
                                    ZERO_COLUMNS if name.endswith("zeros")
                                    else 0.0)
                s_in = [ka.quant_scale_reference(x[0].abs().max()
                                                 .reshape(1))
                        if md == ka.EMIT else None
                        for x, md in zip(base, modes)]
                refs = _clone_leaves(base)
                want = adam_step_call(ka, refs, k, modes, s_in,
                                      step=ka.adam_step_reference)
                got = adam_step_call(ka, base, k, modes, s_in)
                torch.cuda.synchronize()
                differ, err = adam_step_differ(base, refs, got, want, modes)
                totals[build] += sum(differ.values())
                log("limits_adam", build=build, case=name,
                    params=sum(math.prod(s) for s in sh),
                    differ=json.dumps(differ, separators=(",", ":")),
                    max_abs_err=f"{err:.3e}")
                del base, refs, want, got
                torch.cuda.empty_cache()
    finally:
        ka._lib = sound_lib
    log("limits_adam_verdict", **{
        b if b == "sound" else b[2:].split("=")[0].lower(): v
        for b, v in totals.items()})
    if totals["sound"] or not all(totals[" ".join(d)] for d in faulty):
        raise AssertionError(f"--limits adam: the sound build must differ "
                             f"in 0 elements, each faulty copy in some: "
                             f"{totals}")


# ---------------------------------------------------------------------------
# decoders of any width (K1-K5, K3's families, K8 past H = 512) and K3's
# measurement levers (K3 (g))
# ---------------------------------------------------------------------------

WIDE_H = 1000           # the slice's full-width path: twice the default 500
# both sides of the kernels' one design threshold (512: shared memory and
# one register chunk; 513 and up: the per-block workspace and 512-column
# chunks), whole and ragged chunks, and a ragged width above every chunk
# count of the others (4100, at B=2 like every width but WIDE_H)
WIDE_WIDTHS = [512, 513, 768, 1000, 1024, 2048, 4100]
N_WIDE = 237            # [train_wide]'s images: 2 batches and a tail of 37
# the wide cluster passes' faulty copies (fused_loss_int8_sm90_wide.cu): the
# last chunk's head partial dropped, aq for dh0 read from the workspace one
# block off (the next 64-pixel block, the image's next row: it quantises so
# nearly alike that only the dh0 reading, at DH0_TOL, refuses it), the last
# chunk's column sums written as 0; each must fail some wide reading on the
# cluster passes
K3W_FAULTS = (("-DSVT_K3W_DROP_HEAD=1",), ("-DSVT_K3W_AQ_OFF=1",),
              ("-DSVT_K3W_SKIP_SUMS=1",))
# the wide readings of --limits k3: (FAMILY_CASES name or "galaxy", weight
# dtype, H) at B = K3W_LIMIT_B, each on the cluster and the block passes:
# two chunks (1,000), three with the last ragged (1,030), the colored
# pairing, a padded Gaussian grid of 256-pixel groups
K3W_LIMIT_CASES = [("galaxy", "bfloat16", WIDE_H), ("galaxy", "float32", 1030),
                   ("colored_mask", "bfloat16", WIDE_H),
                   ("gaussian_mask_pad65", "float32", WIDE_H)]
K3W_LIMIT_B = 8
LOSS_WIDE_SOURCE = "spatialvae_torch/kernels/csrc/fused_loss_int8_wide.cu"
LEVERS_SOURCE = "spatialvae_torch/kernels/csrc/fused_loss_int8_levers.cu"
# K1's f32 activations at H = 4100 read up to 5.15e-5 max and 6.95e-6 mean
# against ACTS_TOL's 5e-5 / 5e-6, placed at H <= 512: a sound kernel's
# longer sums.  Above 2048 they are held at ACTS_TOL_WIDE, below the copies
# with a step removed (`--limits wide`: one TF32 pass >= 6.36e-4 / 1.63e-4,
# the ragged last chunk skipped 7.6e-1 / 3.2e-4; the wide limits in PERF.md)
ACTS_TOL_WIDE = {"float32": (2e-4, 3e-5), "bfloat16": (1e-2, 5e-5)}
# bf16 y and activations above 2048 with two hidden layers: a sound
# kernel's means read up to 1.43e-5 and 1.11e-5 at 4100 (a tanh ulp moves
# more operands across a bf16 rounding boundary in the longer sums) against
# TOL's and ACTS_TOL's 1e-5, so their means are held at 5e-5 there, below
# the copy without bf16 operand casts (`--limits wide`: 5.92e-5, 3.65e-4)
TOL_WIDE = {"float32": TOL["float32"], "bfloat16": (5e-4, 5e-5)}
# K3's levers at the galaxy shape: (name, Numerics fields)
LEVER_MODES = [("db1_qi", dict(db1="qi")), ("a1q", dict(a1q=True)),
               ("pade", dict(tanh="pade")),
               ("a1q_db1_qi", dict(a1q=True, db1="qi"))]
CUT_LADDER = [3, 4, 5, 6, 7, 8]


class sized:
    """Within the block the galaxy helpers build a decoder ``h`` wide with
    ``layers`` layers and batches of ``b`` (the module's P_HIDDEN,
    P_LAYERS and BATCH)."""

    def __init__(self, h: int, b: int = None, layers: int = None):
        self.h, self.b, self.layers = h, b, layers

    def __enter__(self):
        global P_HIDDEN, BATCH, P_LAYERS
        self.saved = (P_HIDDEN, BATCH, P_LAYERS)
        P_HIDDEN = self.h
        BATCH = self.b or BATCH
        P_LAYERS = self.layers or P_LAYERS
        return self

    def __exit__(self, *exc):
        global P_HIDDEN, BATCH, P_LAYERS
        P_HIDDEN, BATCH, P_LAYERS = self.saved
        return False


def acts_tol(h: int, dtype: str) -> tuple:
    return ACTS_TOL_WIDE[dtype] if h > 2048 else ACTS_TOL[dtype]


def y_tol(h: int, dtype: str) -> tuple:
    return TOL_WIDE[dtype] if h > 2048 else TOL[dtype]


def fwd_case(torch, b, h, dtype, seed, timed, hw=None, no=CHANNELS) -> dict:
    """K1 without its activation output (serving) at width ``h`` (over
    IMAGE's pixels unless ``hw``, ``no`` outputs): errors (absolute), with
    ``timed`` the kernel's and the plain version's ms (on the sm90 route
    the tile kernels too, in turns: "ms_tile", "turns", their errors
    "tile_y"); "route" the route ``decoder_route`` gives it."""
    from spatialvae_torch.kernels.fused_decoder import (
        TailWeights,
        decoder_route,
        decoder_tail_reference,
        run_decoder_tail,
    )

    hw = hw or IMAGE[0] * IMAGE[1]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fold, coords, *ws = _tail_inputs(torch, b, hw, h, 1, no,
                                     getattr(torch, dtype), gen)
    tw = TailWeights(*ws)
    out = {"route": decoder_route(hw, h, 1, no)}
    with torch.no_grad():
        got = run_decoder_tail(fold, coords, tw)
        torch.cuda.synchronize()
        want = decoder_tail_reference(fold, coords, *ws)
        out["y"] = check_close(f"K1 H={h} {dtype}", got, want,
                               getattr(torch, dtype))
        if timed:
            out["ms"], out["plain_ms"] = _timed(
                torch, lambda: run_decoder_tail(fold, coords, tw),
                lambda: decoder_tail_reference(fold, coords, *ws))
        if timed and out["route"] == "sm90":
            tile = run_decoder_tail(fold, coords, tw, tile_kernels=True)
            out["tile_y"] = check_close(f"K1 H={h} {dtype} tile", tile, want,
                                        getattr(torch, dtype))
            ab = in_turns(torch, {r: functools.partial(
                run_decoder_tail, fold, coords, tw, tile_kernels=r == "tile")
                for r in ("tile", "sm90")}, N_TIMED, AB_DEC)
            out.update(ms=ab["sm90"][0], ms_tile=ab["tile"][0],
                       turns={k: v[1] for k, v in ab.items()})
    return out


def _check_k12(h, dtype, r) -> dict:
    _check_abs(f"K1 H={h} {dtype} y", r["y"], y_tol(h, dtype))
    _check_abs(f"K1 H={h} {dtype} acts", r["acts"], acts_tol(h, dtype))
    fields = {"acts": f"{r['acts'][0]:.3e}/{r['acts'][1]:.3e}"}
    for variant in ("residual", "recompute"):
        worst = (0.0, 0.0)
        for g in GRADS:
            _check_rel(f"K2 H={h} {dtype} {variant} {g}", r[variant, g],
                       BWD_TOL[dtype, variant])
            worst = _wmax(worst, r[variant, g][2:])
        fields[variant] = f"{worst[0]:.2e}/{worst[1]:.2e}"
    return fields


def _check_int8_all(what, r, names) -> str:
    worst = (0.0, 0.0)
    for n in names:
        _check_rel(f"{what} {n}", r[n], INT8_TOL)
        worst = _wmax(worst, r[n][2:])
    return f"{worst[0]:.2e}/{worst[1]:.2e}"


def _check_k3_wide(what, r) -> str:
    """A K3 reading of ``[kernel_wide]``: the loss and the five outputs
    within INT8_TOL, dh0 within DH0_TOL; on the cluster passes the same
    against the block passes."""
    _check_rel(f"{what} dh0", r["dh0"], DH0_TOL)
    if r["route"] == "sm90":
        _check_int8_all(f"{what} vs block passes", r["vs_block"],
                        ("loss",) + INT8_GRADS)
        _check_rel(f"{what} dh0 vs block passes", r["vs_block"]["dh0"],
                   DH0_TOL)
    return (_check_int8_all(what, r, ("loss",) + INT8_GRADS)
            + f" dh0={r['dh0'][2]:.2e}/{r['dh0'][3]:.2e}")


def _check_k45_wide(h: int, t) -> dict:
    """A K4/K5 reading at width ``h`` past 512 (``int8_tail_case``): the
    cluster passes' route, y, y without a1 and a1 within INT8_Y_TOL and
    INT8_A1_TOL, both K5 variants within INT8_TOL, two runs of each bit
    for bit; against the block passes, which differ from them only in the
    order of the f32 sums (the head's, the column sums'), y and a1 within
    the same limits and K5 within K45W_BLOCK_TOL.  Returns the log fields
    of each K5 variant (max_rel/mean_rel) and "vs_block", the worst
    against the block passes."""
    if t["route"] != "sm90" or t["route_alone"] != "sm90":
        raise AssertionError(f"K4/K5 H={h}: route {t['route']}, K4 alone "
                             f"{t['route_alone']}")
    _check_abs(f"K4 H={h} y", t["y"], INT8_Y_TOL)
    _check_abs(f"K4 H={h} y without a1", t["y_no_a1"], INT8_Y_TOL)
    _check_abs(f"K4 H={h} a1", t["a1"], INT8_A1_TOL)
    v = t["vs_block"]
    _check_abs(f"K4 H={h} y, cluster vs block passes", v["y"], INT8_Y_TOL)
    _check_abs(f"K4 H={h} a1, cluster vs block passes", v["a1"],
               INT8_A1_TOL)
    out = {}
    worst = (0.0, 0.0)
    for variant in ("residual", "recompute"):
        if not t[variant, "same"]:
            raise AssertionError(f"K5 H={h} {variant}: two runs differ")
        out[variant] = _check_int8_all(
            f"K5 H={h} {variant}", {n: t[variant, n] for n in INT8_GRADS},
            INT8_GRADS)
        for n in INT8_GRADS:
            _check_rel(f"K5 H={h} {variant} {n}, cluster vs block passes",
                       v[variant, n], K45W_BLOCK_TOL)
            worst = _wmax(worst, v[variant, n][2:])
    out["vs_block"] = (f"y {v['y'][0]:.3e} a1 {v['a1'][0]:.3e} "
                       f"k5 {worst[0]:.2e}/{worst[1]:.2e}")
    return out


def _turns_field(turns: dict) -> str:
    return " ".join(f"{k}:{t:.4f}" for k in ("tile", "sm90")
                    for t in turns[k])


def k12_wide_case(torch, h: int, b: int, dtype: str, timed: bool) -> dict:
    """``[kernel_wide]``'s K1/K2 line at width ``h``, batch ``b``: K1 with
    and without its activation output and K2 both variants against their
    plain versions (and, on the sm90 route, the tile kernels); with
    ``timed`` every call of both designs in turns (AB_DEC) beside its
    bound.  Returns ``backward_case``'s readings with "fwd" the
    ``fwd_case``."""
    case = (f"H{h}_{dtype}", b, IMAGE[0] * IMAGE[1], h, 1, CHANNELS, False,
            dtype)
    r = backward_case(torch, case, SEED, timed)
    fields = _check_k12(h, dtype, r)
    r["fwd"] = fwd_case(torch, b, h, dtype, SEED, timed)
    times = {}
    if timed:
        wb = 2 if dtype == "bfloat16" else 4
        bd = dec_bounds(b, IMAGE[0] * IMAGE[1], h, CHANNELS, wb, wb)
        bd0 = dec_bounds(b, IMAGE[0] * IMAGE[1], h, CHANNELS, wb, 0)
        bwd_bd = bd["chain"][0] + bd["dw"][0] + bd["sums"][0]
        times = dict(
            route=r["route"],
            fwd_ms=f"{r['fwd']['ms']:.4f}",
            fwd_tile_ms=f"{r['fwd']['ms_tile']:.4f}",
            fwd_turns=_turns_field(r["fwd"]["turns"]),
            fwd_plain_ms=f"{r['fwd']['plain_ms']:.4f}",
            fwd_bound_ms=f"{bd0['fwd'][0]:.4f}",
            fwd_acts_ms=f"{r['fwd_acts_ms']:.4f}",
            fwd_acts_tile_ms=f"{r['fwd_acts_ms_tile']:.4f}",
            fwd_acts_turns=_turns_field(r["fwd_acts_turns"]),
            fwd_acts_plain_ms=f"{r['fwd_acts_plain_ms']:.4f}",
            fwd_acts_bound_ms=f"{bd['fwd_acts'][0]:.4f}",
            residual_ms=f"{r['residual_ms']:.4f}",
            residual_tile_ms=f"{r['residual_ms_tile']:.4f}",
            residual_turns=_turns_field(r["residual_turns"]),
            residual_plain_ms=f"{r['residual_plain_ms']:.4f}",
            recompute_ms=f"{r['recompute_ms']:.4f}",
            recompute_tile_ms=f"{r['recompute_ms_tile']:.4f}",
            recompute_turns=_turns_field(r["recompute_turns"]),
            recompute_plain_ms=f"{r['recompute_plain_ms']:.4f}",
            bwd_bound_ms=f"{bwd_bd:.4f}")
    log("kernel_wide", kernel="K1/K2", H=h, B=b, dtype=dtype,
        y_abs=f"{r['fwd']['y'][0]:.3e}/{r['fwd']['y'][1]:.3e}",
        errors="acts_abs,residual_rel,recompute_rel", **fields,
        acts_tol=acts_tol(h, dtype), **times)
    return r


def phase_kernel_wide(torch) -> dict:
    """Every kernel at every width of WIDE_WIDTHS against its plain version,
    at B=2 (every kernel's whole calls timed at WIDE_H, B=100, the slice's
    shapes): K1 without and with its activation output and K2 with the
    residual and with recompute, f32 and bf16 weights; K3 in the Bernoulli,
    Gaussian, colored and padded families, K4 with and without a1, K5 both
    variants, K8, bf16 weights.  Limits: the default width's (K1's f32
    activations above 2048 at ACTS_TOL_WIDE; K3's dh0 at DH0_TOL, and on
    the cluster passes K3 against the block passes too)."""
    res = {}
    families = [c for c in FAMILY_CASES if c[0] in (
        "gaussian_mask", "colored_mask", "bernoulli_pad28")]
    for h in WIDE_WIDTHS:
        timed = h == WIDE_H
        b = BATCH if timed else 2
        with sized(h, b):
            for dtype in ("float32", "bfloat16"):
                res["k12", h, dtype] = k12_wide_case(torch, h, b, dtype,
                                                     timed)
                torch.cuda.empty_cache()
            lc = loss_case(torch, b, "bfloat16", SEED, timed)
            if not lc["same"]:
                raise AssertionError(f"K3 H={h}: two runs differ")
            fam = {"bernoulli": _check_k3_wide(f"K3 H={h}", lc)}
            # every family on the route the table gives it (past 512 the
            # cluster passes, held to the block passes and, at WIDE_H,
            # timed in turns with them)
            ab = {"bernoulli": _log_ab(lc)}
            for case in families:
                r = family_case(torch, case, "bfloat16", SEED, timed)
                fam[case[0]] = _check_k3_wide(f"K3 H={h} {case[0]}", r)
                ab[case[0]] = _log_ab(r)
                if timed:
                    res["k3_family", h, case[0]] = {
                        k: r[k] for k in ("ms", "ms_block", "route", "bound")
                        if k in r}
            t = int8_tail_case(torch, b, "bfloat16", SEED, timed)
            k45 = _check_k45_wide(h, t)
            k5 = {v: k45[v] for v in ("residual", "recompute")}
            k8 = k8_case(torch, "i4", IMAGE[0], CHANNELS, "bfloat16", SEED,
                         timed)
            k8e = _check_int8_all(f"K8 H={h}", k8, ("loss",) + INT8_GRADS)
            times = {}
            if timed:
                hw = IMAGE[0] * IMAGE[1]
                lc["bound"] = k3_bound(b, hw, h, CHANNELS, 2, 1, False,
                                       False)
                fam_ms = {f"k3_{k}_{f}": v.get(f, "-")
                          for k, v in ab.items() if k != "bernoulli"
                          for f in ("block_ms", "turns")}
                fam_ms.update({f"k3_{k[2]}_ms": f"{v['ms']:.4f}"
                               for k, v in res.items()
                               if k[0] == "k3_family" and k[1] == h})
                times = dict(k3_route=lc["route"], k3_ms=f"{lc['ms']:.4f}",
                             k3_block_ms=ab["bernoulli"].get("block_ms", "-"),
                             k3_turns=ab["bernoulli"].get("turns", "-"),
                             k3_vs_block_max_rel=ab["bernoulli"].get(
                                 "vs_block_max_rel", "-"),
                             k3_plain_ms=f"{lc['plain_ms']:.4f}",
                             k3_bound_ms=f"{lc['bound'][0]:.4f}",
                             k3_share=f"{lc['bound'][0] / lc['ms']:.3f}",
                             **fam_ms,
                             k45_route=t["route"],
                             k4_ms=f"{t['fwd_ms']:.4f}",
                             k4_block_ms=f"{t['fwd_ms_block']:.4f}",
                             k4_turns=t["fwd_turns"],
                             k4_plain_ms=f"{t['fwd_plain_ms']:.4f}",
                             k4_a1_ms=f"{t['fwd_a1_ms']:.4f}",
                             k4_a1_block_ms=f"{t['fwd_a1_ms_block']:.4f}",
                             k4_a1_turns=t["fwd_a1_turns"],
                             k5_ms=f"{t['residual_ms']:.4f}",
                             k5_block_ms=f"{t['residual_ms_block']:.4f}",
                             k5_turns=t["residual_turns"],
                             k5_plain_ms=f"{t['residual_plain_ms']:.4f}",
                             k5_recompute_ms=f"{t['recompute_ms']:.4f}",
                             k5_recompute_block_ms=(
                                 f"{t['recompute_ms_block']:.4f}"),
                             k5_recompute_turns=t["recompute_turns"],
                             k8_ms=f"{k8['ms']:.4f}",
                             k8_plain_ms=f"{k8['plain_ms']:.4f}")
            log("kernel_wide", kernel="K3/K4/K5/K8", H=h, B=b,
                dtype="bfloat16", errors="max_rel/mean_rel",
                **{f"k3_{k}": v for k, v in fam.items()},
                k4_y_abs=f"{t['y'][0]:.3e}", k4_a1_abs=f"{t['a1'][0]:.3e}",
                k45_vs_block=k45["vs_block"],
                k5_residual=k5["residual"], k5_recompute=k5["recompute"],
                k8_i4=k8e, **times)
            res["k3", h], res["k45", h], res["k8", h] = lc, t, k8
            torch.cuda.empty_cache()
    return res


# [k3_wide_turns]: K3's whole call at WIDE_H on the cluster passes against
# the block passes, at the slice's batch with f32 weights and at B = 1,024
# (several workspace chunks), bf16 and f32 weights ([kernel_wide] times the
# slice's batch with bf16 weights in turns)
K3_WIDE_TURNS = ((BATCH, "float32"), (1024, "bfloat16"), (1024, "float32"))


def phase_k3_wide_turns(torch) -> dict:
    """``[k3_wide_turns]``: K3 at WIDE_H on the galaxy shape (int8 targets,
    no mask) at each (B, weight dtype) of K3_WIDE_TURNS: the route's call
    (the cluster passes) against the block passes' (every output and the
    loss within INT8_TOL, dh0 within DH0_TOL, relative to the block passes'
    largest value), the two timed in turns (AB_K3; N_TIMED // 2 runs a turn, 2 at
    B = 1,024), each beside ``k3_bound`` and its share of it; the cluster
    route's workspace chunks."""
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    out = {}
    hw = IMAGE[0] * IMAGE[1]
    budget = fd.workspace_budget(torch.device(DEVICE))
    names = ("loss",) + INT8_GRADS
    for b, dtype in K3_WIDE_TURNS:
        with sized(WIDE_H, b):
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            fold, coords, ws = _int8_inputs(torch, b, dtype, gen)
            k = torch.randint(0, 256, (b, CHANNELS, hw), generator=gen,
                              device=DEVICE)
            args = (fold, coords, *ws, (k - 128).to(torch.int8), None,
                    "bernoulli")
            route = l8.k3_route(hw, WIDE_H, l8.pick_tile(hw), "bernoulli",
                                l8.DEFAULTS)
            bf16 = dtype == "bfloat16"
            chunks = len(l8.image_chunks(b, l8.loss_workspace_bytes(
                hw, WIDE_H, "sm90", l8.stash_block_bytes(bf16, WIDE_H)),
                budget))
            run = functools.partial(l8.run_loss_int8, *args)
            with torch.no_grad():
                got, old = run(), run(block_passes=True)
                errs = {n: rel_errors(u, v) for n, u, v in zip(
                    K3_READINGS, k3_views(got), k3_views(old))}
                del got, old
                vs_block = _check_int8_all(
                    f"K3 H={WIDE_H} B={b} {dtype} cluster vs block", errs,
                    names)
                _check_rel(f"K3 H={WIDE_H} B={b} {dtype} cluster vs block "
                           f"dh0", errs["dh0"], DH0_TOL)
                ab = in_turns(torch, {"sm90": run, "block": functools.partial(
                    run, block_passes=True)},
                    N_TIMED // 2 if b <= BATCH else 2)
            bd = k3_bound(b, hw, WIDE_H, CHANNELS, 2 if bf16 else 4, 1,
                          False, False)
            out[b, dtype] = dict(ms=ab["sm90"][0], ms_block=ab["block"][0],
                                 bound=bd, route=route)
            log("k3_wide_turns", H=WIDE_H, B=b, dtype=dtype, route=route,
                sm90_chunks=chunks, ms=f"{ab['sm90'][0]:.4f}",
                block_ms=f"{ab['block'][0]:.4f}",
                turns=" ".join(f"{r}:{t:.4f}" for r in ("block", "sm90")
                               for t in ab[r][1]),
                bound_ms=f"{bd[0]:.4f}", bound_by=bd[1],
                share=f"{bd[0] / ab['sm90'][0]:.3f}",
                block_share=f"{bd[0] / ab['block'][0]:.3f}",
                vs_block=vs_block,
                vs_block_dh0=f"{errs['dh0'][2]:.2e}/{errs['dh0'][3]:.2e}",
                errors="max_rel/mean_rel")
            del fold, coords, ws, args, run
            torch.cuda.empty_cache()
    return out


def phase_train_wide(torch) -> dict:
    """The galaxy model with a decoder WIDE_H wide (twice the default) at
    B=100 on N_WIDE blob images: two float epochs (K1 with activations and
    K2 in every step, Adam's step kernel) and two int8 epochs with bf16
    compute (K3 in the full steps, K4/K5 in the tails, K4 in the
    evaluations, all on the wide cluster passes), each with its launch
    counts, an ELBO that rises, and one step through the kernels against
    the plain versions; then one int8 epoch a turn (AB_K3) with K3 on each
    design: the mean step's ms ("step_ms", "step_ms_block"); then the int8
    CTF step (``phase_train_wide_ctf``, "ctf")."""
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    out = {}
    steps = TRAIN_EPOCHS * math.ceil(N_WIDE / BATCH)
    full, tails = TRAIN_EPOCHS * (N_WIDE // BATCH), TRAIN_EPOCHS
    with sized(WIDE_H):
        q_cfg, p_cfg, ecfg = galaxy_configs()
        tcfg = TrainConfig(minibatch_size=BATCH, learning_rate=1e-4,
                           num_epochs=TRAIN_EPOCHS, z_delay=1, seed=SEED,
                           image_shape=IMAGE, channels=CHANNELS)
        trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg,
                          coord_grid(*IMAGE, device=DEVICE), device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        data = blob_images(torch, N_WIDE, gen)
        before = trainer.eval_epoch(data, 0)
        _reset_all_launches()
        t0 = time.perf_counter()
        rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, adam = dict(fd.LAUNCHES), dict(ka.LAUNCHES)
        # H = WIDE_H takes the deep sm90 kernels (one hidden layer: one
        # pass a direction, in two column chunks); the tile keys stay 0
        want = dict.fromkeys(fd.LAUNCHES, 0) | {
            "fwd_acts_sm90": steps, "bwd_chain_sm90": steps,
            "bwd_dw_sm90": steps, "bwd_sum": 4 * steps}
        want_adam = dict.fromkeys(adam, 0) | {
            "adam_step": steps * adam_step_launches(trainer)}
        if counts != want or adam != want_adam:
            raise AssertionError(f"train_wide float launches {counts}, Adam "
                                 f"{adam}; expected {want}, {want_adam}")
        after = trainer.eval_epoch(data, TRAIN_EPOCHS)
        if not (np.isfinite(rows).all() and after[0] > before[0]):
            raise AssertionError(f"train_wide float: ELBO {before[0]} -> "
                                 f"{after[0]}, epochs {rows}")
        y = data[:BATCH]
        noise = torch.randn((BATCH, Z_DIM + 3), generator=gen, device=DEVICE)
        kern = step_grads(torch, trainer, y, noise, True)
        plain = step_grads(torch, trainer, y, noise, False)
        worst = (0.0, 0.0)
        for k in kern:
            _, _, rel, mean_rel = rel_errors(kern[k], plain[k])
            if not (rel <= STEP_TOL[0] and mean_rel <= STEP_TOL[1]):
                raise AssertionError(f"train_wide float step {k}: {rel}, "
                                     f"mean {mean_rel}; limits {STEP_TOL}")
            worst = _wmax(worst, (rel, mean_rel))
        log("train_wide", path="float", H=WIDE_H, B=BATCH, epochs=TRAIN_EPOCHS,
            steps=steps, images=N_WIDE, seconds=f"{seconds:.4f}",
            step_ms=f"{seconds * 1e3 / steps:.3f}",
            images_per_s=f"{TRAIN_EPOCHS * N_WIDE / seconds:.1f}",
            elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
            launches=json.dumps(counts, separators=(",", ":")),
            adam_launches=adam["adam_step"],
            step_vs_plain=f"{worst[0]:.3e}/{worst[1]:.3e}")
        out["float"] = counts
        out["trained_p"] = {k: v.detach().clone() for k, v in
                            trainer.p_net.state_dict().items()}
        out["trained_q"] = {k: v.detach().clone() for k, v in
                            trainer.q_net.state_dict().items()}
        del trainer, kern, plain
        torch.cuda.empty_cache()

        trainer, _, gen = int8_galaxy_trainer(torch)
        evals = math.ceil(N_WIDE / BATCH)
        before = _int8_evaluate(torch, trainer, data, 0)
        _reset_all_launches()
        t0 = time.perf_counter()
        rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _int8_launches()
        # K3, K4 and K5 on the cluster passes past H = 512 (the wide
        # units, one workspace chunk a step)
        want = {"k3": k3_launches(full, "sm90"),
                "k8": dict.fromkeys(("fwd", "grad", "dw", "sum"), 0),
                "k45": k45_launches(tails, route="sm90"),
                "k12": 0,
                "adam": int8_adam_launches(trainer, full + tails,
                                           seeded=True)}
        if counts != want:
            raise AssertionError(f"train_wide int8 launches {counts}, "
                                 f"expected {want}")
        after = _int8_evaluate(torch, trainer, data, TRAIN_EPOCHS)
        if not (np.isfinite(rows).all() and after[0] > before[0]):
            raise AssertionError(f"train_wide int8: ELBO {before[0]} -> "
                                 f"{after[0]}, epochs {rows}")
        worst = int8_step_readings(torch, trainer, data, gen)
        for kind, (rel, mean_rel, leaf) in worst.items():
            if not (rel <= INT8_STEP_TOL[0] and
                    mean_rel <= INT8_STEP_TOL[1]):
                raise AssertionError(f"train_wide int8 {kind} step: {rel} "
                                     f"({leaf}), mean {mean_rel}; limits "
                                     f"{INT8_STEP_TOL}")
        # one more epoch a turn (AB_K3), K3 on the block passes in the
        # block turns: the mean step's ms on each design
        turns = {}
        per_epoch = math.ceil(N_WIDE / BATCH)
        for i, route in enumerate(AB_K3):
            with (on_block_passes() if route == "block"
                  else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_epoch(data, TRAIN_EPOCHS + i, progress=False)
                torch.cuda.synchronize()
            turns.setdefault(route, []).append(
                (time.perf_counter() - t0) * 1e3 / per_epoch)
        step_ms = {r: statistics.median(t) for r, t in turns.items()}
        log("train_wide", path="int8", H=WIDE_H, B=BATCH, compute="bfloat16",
            epochs=TRAIN_EPOCHS, steps=full + tails, images=N_WIDE,
            seconds=f"{seconds:.4f}",
            step_ms=f"{step_ms['sm90']:.3f}",
            step_ms_block=f"{step_ms['block']:.3f}",
            step_turns=" ".join(f"{r}:{t:.3f}" for r in ("block", "sm90")
                                for t in turns[r]),
            images_per_s=f"{TRAIN_EPOCHS * N_WIDE / seconds:.1f}",
            elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
            launches=json.dumps(counts, separators=(",", ":")),
            eval_k4_launches=evals,
            step_k3_vs_plain=f"{worst['k3'][0]:.3e}/{worst['k3'][1]:.3e}",
            step_tail_vs_plain=(f"{worst['k4k5'][0]:.3e}/"
                                f"{worst['k4k5'][1]:.3e}"))
        out["int8"] = counts
        out["eval_k4"] = evals
        del trainer, data
        torch.cuda.empty_cache()
        out["ctf"] = phase_train_wide_ctf(torch)
    torch.cuda.empty_cache()
    return out


# [train_wide]'s int8 CTF step: the particles CLI's model (40x40, z=2, a
# 500-wide encoder, colored noise: `--ctf-train ... --fit-noise --mask
# --int8-decoder`) with a WIDE_H-wide decoder, three full batches an epoch,
# timed over three epochs a turn; its K4/K5 kernels on each design
# (kernel-name substrings)
CTF_WIDE_N = 3 * BATCH
CTF_WIDE_TURN_EPOCHS = 3
CTF_K45_KERNELS = {"sm90": ("int8_fwd90w", "int8_scale90w", "int8_grad90w",
                            "grouped_dw90w"),
                   "block": ("int8_fwd_kernel", "int8_bwd_scale",
                             "int8_bwd_grad", "grouped_dw_kernel")}


def ctf_wide_trainer(torch):
    """The particles CLI's int8 model at WIDE_H with a per-image CTF
    (``ctf_table``'s microscope, the disc mask, the colored likelihood), in
    float32 compute (a CTF refuses bf16: its FFT takes float32, and the JAX
    trainer refuses the same), and its CTF_WIDE_N particles with their CTF
    kernels."""
    import io

    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_torch.ctf import ctf_filter, parse_ctf
    from spatialvae_torch.data.dataset import ArrayDataset
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    side = CLI_SIDE
    rng = np.random.default_rng(SEED + 60)
    y = particle_stack(CTF_WIDE_N, rng).reshape(CTF_WIDE_N, side * side)
    ctf = ctf_filter(parse_ctf(io.StringIO(ctf_table(CTF_WIDE_N, rng))),
                     side - 1, side - 1)
    q_cfg = InferenceConfig(n=side * side, latent_dim=2 + 3,
                            hidden_dim=CLI_HIDDEN, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=WIDE_H, n_out=2,
                                   num_layers=2)
    ecfg = ElboConfig(rotate=True, translate=True, theta_prior=math.pi,
                      likelihood="colored", channels=1, fused=True,
                      int8=True)
    tcfg = TrainConfig(minibatch_size=BATCH, learning_rate=1e-4,
                       num_epochs=1, seed=SEED, compute_dtype="float32",
                       image_shape=(side, side), channels=1)
    trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg,
                      coord_grid(side, side, device=DEVICE),
                      mask=disc_mask(torch, (side, side)), device=DEVICE)
    return trainer, ArrayDataset.from_numpy(y, ctf, device=DEVICE)


def phase_train_wide_ctf(torch) -> dict:
    """``[train_wide]``'s int8 CTF step (``ctf_wide_trainer``): K4 with a1
    and K5 from the residual in every step, no K3 (a batch with CTF never
    takes the loss kernel), all on the wide cluster passes (1,600 pixels
    padded to 1,792, groups of 256); one epoch with its launch counts and a
    finite ELBO, then CTF_WIDE_TURN_EPOCHS epochs a turn (AB_I8) with K4/K5
    on each design: the mean step's ms ("step_ms_ctf", "step_ms_ctf_block");
    and each design's K4/K5 device ms a step from traced epochs, beside
    the step's host-clock ms (the step is host-bound where they differ).
    First the step's own K4/K5 calls (f32 weights, No = 2, the 1,600
    pixels padded to 1,792) against their plain versions and the block
    passes (``_check_k45_wide``)."""
    with sized(WIDE_H, BATCH):
        t = int8_tail_case(torch, BATCH, "float32", SEED, False,
                           hw=CLI_SIDE * CLI_SIDE, no=2)
    k45 = _check_k45_wide(WIDE_H, t)
    torch.cuda.empty_cache()
    trainer, data = ctf_wide_trainer(torch)
    steps = CTF_WIDE_N // BATCH
    _reset_all_launches()
    row = trainer.train_epoch(data, 0, progress=False)
    torch.cuda.synchronize()
    got = _int8_launches()
    want = {"k3": k3_launches(0, None),
            "k8": dict.fromkeys(("fwd", "grad", "dw", "sum"), 0),
            "k45": k45_launches(steps, route="sm90"), "k12": 0}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"train_wide CTF launches {got}, expected "
                             f"{want}")
    if not np.isfinite(row).all():
        raise AssertionError(f"train_wide CTF: epoch {row}")
    turns = {}
    for i, passes in enumerate(AB_I8):
        with on_int8_passes(passes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in range(CTF_WIDE_TURN_EPOCHS):
                trainer.train_epoch(data, 1 + e, progress=False)
            torch.cuda.synchronize()
        turns.setdefault(passes, []).append(
            (time.perf_counter() - t0) * 1e3
            / (CTF_WIDE_TURN_EPOCHS * steps))
    step_ms = {p: statistics.median(t) for p, t in turns.items()}
    device = {}
    for passes, keys in (("sm90", CTF_K45_KERNELS["sm90"]),
                         ("block", CTF_K45_KERNELS["block"])):
        with on_int8_passes(passes):
            ms = kernel_device_ms(torch, functools.partial(
                trainer.train_epoch, data, 1, progress=False), keys)
        device[passes] = sum(ms.values()) / steps
    log("train_wide", path="int8_ctf", H=WIDE_H, B=BATCH, image="40x40",
        pixels="1600->1792", likelihood="colored", ctf="per image",
        mask=True, compute="float32", steps=steps,
        elbo=f"{row[0]:.3f}", launches=json.dumps(got["k45"],
                                                   separators=(",", ":")),
        k4_y_abs=f"{t['y'][0]:.3e}", k4_a1_abs=f"{t['a1'][0]:.3e}",
        k5_residual=k45["residual"], k5_recompute=k45["recompute"],
        k45_vs_block=k45["vs_block"], step_ms_ctf=f"{step_ms['sm90']:.3f}",
        step_ms_ctf_block=f"{step_ms['block']:.3f}",
        k45_device_ms_ctf=f"{device['sm90']:.3f}",
        k45_device_ms_ctf_block=f"{device['block']:.3f}",
        step_turns=" ".join(f"{p}:{t:.3f}" for p in ("block", "sm90")
                            for t in turns[p]))
    out = {"k45": got["k45"], "steps": steps, "step_ms": step_ms,
           "device_ms": device}
    del trainer, data
    return out


def phase_slice_wide(torch, tmpdir: str, trained: dict) -> int:
    """Serving at WIDE_H: ``[train_wide]``'s trained float weights written as
    checkpoints and served through ``SpatialVae.load`` (the slice's
    requests, timed passes, a reconstruct against the plain decoder)."""
    from spatialvae_torch import checkpoint
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator

    with sized(WIDE_H):
        q_cfg, p_cfg, ecfg = galaxy_configs()
        q_net = InferenceNetwork(q_cfg, device=DEVICE)
        p_net = SpatialGenerator(p_cfg, device=DEVICE)
        q_net.load_state_dict(trained["trained_q"])
        p_net.load_state_dict(trained["trained_p"])
        paths = (os.path.join(tmpdir, "wide_generator_epoch2.sav"),
                 os.path.join(tmpdir, "wide_inference_epoch2.sav"))
        checkpoint.save_model(paths[0], "generator", p_net, elbo=ecfg,
                              image_shape=IMAGE)
        checkpoint.save_model(paths[1], "inference", q_net, elbo=ecfg,
                              image_shape=IMAGE)
        del q_net, p_net
        launches = phase_slice(torch, tmpdir, paths=paths, tag="slice_wide")
    torch.cuda.empty_cache()
    return launches


DEEP_LAYERS = 4     # [train_deep] / [slice_deep]: `--p_num_layers 4`, Lh = 3
# [train_deep]'s arms: name, compute dtype, int8 mode (`--int8-decoder`:
# the int8 gates take two decoder layers only, so its decoder runs K1/K2 on
# the bf16 shadow beside the int8 encoder)
DEEP_ARMS = (("float", "float32", False), ("bf16", "bfloat16", False),
             ("int8", "bfloat16", True))


def phase_train_deep(torch) -> dict:
    """The galaxy model with a decoder of DEEP_LAYERS layers (three hidden
    layers P_HIDDEN wide) at B=100 on N_WIDE blob images, two epochs in each
    of DEEP_ARMS: each arm's launches (an evaluation: a K1 pass per layer
    per batch; a step: a K1 pass, a K2 chain pass and a dW launch per
    layer and four reductions, all on the sm90 keys; no K3, K4, K5 or K8;
    Adam's step kernel), an ELBO that rises, the mean step ms (host
    clock); the f32 arm also one step through the kernels against the
    plain versions.  Returns the launch counts by arm and the f32 arm's
    trained weights."""
    from spatialvae_torch.kernels import adam as ka
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    out = {}
    steps = TRAIN_EPOCHS * math.ceil(N_WIDE / BATCH)
    evals = math.ceil(N_WIDE / BATCH)
    lh = DEEP_LAYERS - 1
    with sized(P_HIDDEN, layers=DEEP_LAYERS):
        q_cfg, p_cfg, ecfg = galaxy_configs()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        data = blob_images(torch, N_WIDE, gen)
        for arm, compute, int8 in DEEP_ARMS:
            tcfg = TrainConfig(minibatch_size=BATCH, learning_rate=1e-4,
                               num_epochs=TRAIN_EPOCHS, z_delay=1, seed=SEED,
                               compute_dtype=compute, image_shape=IMAGE,
                               channels=CHANNELS)
            trainer = Trainer(q_cfg, p_cfg,
                              dataclasses.replace(ecfg, int8=int8), tcfg,
                              coord_grid(*IMAGE, device=DEVICE),
                              device=DEVICE)
            _reset_all_launches()
            before = trainer.eval_epoch(data, 0)
            torch.cuda.synchronize()
            ev = dict(fd.LAUNCHES)
            if ev != dict.fromkeys(fd.LAUNCHES, 0) | {
                    "fwd_sm90": lh * evals}:
                raise AssertionError(f"train_deep {arm} evaluation "
                                     f"launches {ev}")
            _reset_all_launches()
            t0 = time.perf_counter()
            rows = trainer.train_epochs(data, 0, TRAIN_EPOCHS)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts, other = dict(fd.LAUNCHES), _int8_launches()
            want = dict.fromkeys(fd.LAUNCHES, 0) | {
                "fwd_acts_sm90": lh * steps, "bwd_chain_sm90": lh * steps,
                "bwd_dw_sm90": lh * steps, "bwd_sum": 4 * steps}
            if counts != want or any(
                    any(other[k].values()) for k in ("k3", "k8", "k45")) or \
                    other["adam"]["adam_step"] != steps * \
                    adam_step_launches(trainer) or \
                    other["adam"]["adam"] or other["adam"]["adam_emit"]:
                raise AssertionError(f"train_deep {arm} launches {counts}, "
                                     f"{other}; expected {want}")
            after = trainer.eval_epoch(data, TRAIN_EPOCHS)
            if not (np.isfinite(rows).all() and after[0] > before[0]):
                raise AssertionError(f"train_deep {arm}: ELBO {before[0]} "
                                     f"-> {after[0]}, epochs {rows}")
            fields = {}
            if arm == "float":
                y = data[:BATCH]
                noise = torch.randn((BATCH, Z_DIM + 3), generator=gen,
                                    device=DEVICE)
                kern = step_grads(torch, trainer, y, noise, True)
                plain = step_grads(torch, trainer, y, noise, False)
                worst = (0.0, 0.0)
                for k in kern:
                    _, _, rel, mean_rel = rel_errors(kern[k], plain[k])
                    if not (rel <= STEP_TOL[0] and mean_rel <= STEP_TOL[1]):
                        raise AssertionError(
                            f"train_deep float step {k}: {rel}, mean "
                            f"{mean_rel}; limits {STEP_TOL}")
                    worst = _wmax(worst, (rel, mean_rel))
                fields["step_vs_plain"] = f"{worst[0]:.3e}/{worst[1]:.3e}"
                out["trained_p"] = {k: v.detach().clone() for k, v in
                                    trainer.p_net.state_dict().items()}
                out["trained_q"] = {k: v.detach().clone() for k, v in
                                    trainer.q_net.state_dict().items()}
                del kern, plain
            log("train_deep", arm=arm, compute=compute, int8=int8,
                layers=DEEP_LAYERS, H=P_HIDDEN, B=BATCH,
                epochs=TRAIN_EPOCHS, steps=steps, images=N_WIDE,
                seconds=f"{seconds:.4f}",
                step_ms=f"{seconds * 1e3 / steps:.3f}",
                images_per_s=f"{TRAIN_EPOCHS * N_WIDE / seconds:.1f}",
                elbo_before=f"{before[0]:.3f}", elbo_after=f"{after[0]:.3f}",
                launches=json.dumps(counts, separators=(",", ":")),
                eval_k1_launches=ev["fwd_sm90"],
                adam_launches=other["adam"]["adam_step"], **fields)
            out[arm] = counts
            del trainer
            torch.cuda.empty_cache()
        del data
    ka.reset_launches()
    torch.cuda.empty_cache()
    return out


def phase_slice_deep(torch, tmpdir: str, trained: dict) -> int:
    """Serving with a decoder of DEEP_LAYERS layers: ``[train_deep]``'s
    trained f32 weights written as checkpoints and served through
    ``SpatialVae.load`` (the slice's requests, timed passes, a profiled
    pass, a reconstruct against the plain decoder).  Returns the K1
    launches of the timed passes (a pass per layer per decode)."""
    from spatialvae_torch import checkpoint
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator

    with sized(P_HIDDEN, layers=DEEP_LAYERS):
        q_cfg, p_cfg, ecfg = galaxy_configs()
        q_net = InferenceNetwork(q_cfg, device=DEVICE)
        p_net = SpatialGenerator(p_cfg, device=DEVICE)
        q_net.load_state_dict(trained["trained_q"])
        p_net.load_state_dict(trained["trained_p"])
        paths = (os.path.join(tmpdir, "deep_generator_epoch2.sav"),
                 os.path.join(tmpdir, "deep_inference_epoch2.sav"))
        checkpoint.save_model(paths[0], "generator", p_net, elbo=ecfg,
                              image_shape=IMAGE)
        checkpoint.save_model(paths[1], "inference", q_net, elbo=ecfg,
                              image_shape=IMAGE)
        del q_net, p_net
        launches = phase_slice(torch, tmpdir, paths=paths, tag="slice_deep")
    torch.cuda.empty_cache()
    return launches


def phase_loss_levers(torch) -> dict:
    """K3's measurement levers at the galaxy shape (B=100, bf16 weights):
    each of LEVER_MODES against its plain version (the quantised tiles
    too), two runs bit for bit, ms and bound; then the phase-cut ladder,
    whose cut phases launch nothing: the whole call's ms at each cut."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    res = {}
    hw = IMAGE[0] * IMAGE[1]
    for name, kw in LEVER_MODES:
        nm = _numerics(**kw)
        r = loss_case(torch, BATCH, "bfloat16", SEED, True, nm=nm)
        if not r["same"]:
            raise AssertionError(f"K3 {name}: two runs differ")
        fields = {n: _check_rel(f"K3 {name} {n}", r[n], INT8_TOL)
                  for n in ("loss",) + INT8_GRADS}
        fields["dh0"] = _check_dh0(f"K3 {name}", r)
        r["bound"] = k3_bound(BATCH, hw, P_HIDDEN, CHANNELS, 2, 1, False,
                              False)
        log("kernel_loss_levers", lever=name, B=BATCH, HW=hw, H=P_HIDDEN,
            No=CHANNELS, dtype="bfloat16",
            errors="max_abs/mean_abs/max_rel/mean_rel", **fields,
            max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
            dh0_tol=DH0_TOL,
            ints_fwd_differ_grad_share=_check_ints(f"K3 {name}", r),
            kernel_ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1])
        res[name] = r
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fold, coords, ws = _int8_inputs(torch, BATCH, "bfloat16", gen)
    k = torch.randint(0, 256, (BATCH, CHANNELS, hw), generator=gen,
                      device=DEVICE)
    yt = (k - 128).to(torch.int8)
    ladder = {}
    with torch.no_grad():
        for cut in CUT_LADDER:
            nm = _numerics(phase_cut=cut)
            l8.reset_launches()
            # the ladder reads the block passes' phases: the cut at 8 is
            # the default numerics, which the cluster passes would take
            got = l8.run_loss_int8(fold, coords, *ws, yt, numerics=nm,
                                   block_passes=True)
            torch.cuda.synchronize()
            launched = dict(l8.LAUNCHES)
            want = l8.loss_int8_reference(fold, coords, *ws, yt, numerics=nm)
            r = {"loss": rel_errors(got[0][:, 3, 0], want[0][:, 3, 0])}
            r.update({n: rel_errors(u, v)
                      for n, u, v in zip(INT8_GRADS, got, want)})
            err = _check_int8_all(f"K3 cut {cut}", r, ("loss",) + INT8_GRADS)
            if (launched["grad"] != (cut >= 4) or launched["dw"] != (cut >= 6)
                    or launched["fwd"] != 1):
                raise AssertionError(f"K3 cut {cut}: launches {launched}")
            run = lambda: l8.run_loss_int8(fold, coords, *ws, yt,
                                           numerics=nm, block_passes=True)
            run()
            ladder[cut] = statistics.median(
                [cuda_ms(run, torch) for _ in range(N_TIMED)])
            log("kernel_loss_cut", cut=cut, ms=f"{ladder[cut]:.4f}",
                launches=json.dumps(launched, separators=(",", ":")),
                errors=err)
            del got, want
    log("kernel_loss_ladder", B=BATCH, HW=hw, H=P_HIDDEN, dtype="bfloat16",
        ms=" ".join(f"{c}:{ladder[c]:.4f}" for c in CUT_LADDER),
        phase_ms=" ".join(f"{c}:{ladder[c] - ladder[p]:.4f}"
                          for p, c in zip(CUT_LADDER, CUT_LADDER[1:])))
    res["ladder"] = ladder
    del fold, coords, ws, yt
    torch.cuda.empty_cache()
    return res


def phase_limits_wide(torch) -> None:
    """``--limits wide``: the wide path's readings at the ragged and whole
    widths for the sound library and three copies with one step removed:
    the last ragged 512-column chunk skipped (-DSVT_WIDE_DROP_LAST=1), one
    TF32 pass for f32 weights (-DSVT_TF32_SPLIT=0) and no bf16 operand
    casts (-DSVT_BF16_CASTS=0); they place the wide limits (ACTS_TOL_WIDE,
    TOL_WIDE; the default width's elsewhere)."""
    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    for defines in ((), ("-DSVT_WIDE_DROP_LAST=1",),
                    ("-DSVT_TF32_SPLIT=0",), ("-DSVT_BF16_CASTS=0",)):
        lib = _build.load_library(defines)
        fd._lib = d8._lib = l8._lib = (lambda lib=lib: lib)
        readings = {}
        for h in (768, 1000, 4100):
            with sized(h, 2):
                case = (f"H{h}", 2, IMAGE[0] * IMAGE[1], h, 1, CHANNELS,
                        False, "float32")
                r = backward_case(torch, case, SEED, False, rerun=False)
                readings[f"K1_acts_f32_H{h}"] = r["acts"][:2]
                readings[f"K1_y_f32_H{h}"] = r["y"][:2]
                worst = (0.0, 0.0)
                for g in GRADS:
                    worst = _wmax(worst, r["residual", g][2:])
                readings[f"K2_f32_H{h}"] = worst
                for hw in (784, IMAGE[0] * IMAGE[1]):
                    case = (f"H{h}", 2, hw, h, 2, CHANNELS, False,
                            "bfloat16")
                    r = backward_case(torch, case, SEED, False, rerun=False)
                    readings[f"K1_y_bf16_{hw}px_H{h}"] = r["y"][:2]
                    readings[f"K1_acts_bf16_{hw}px_H{h}"] = r["acts"][:2]
                lc = loss_case(torch, 2, "bfloat16", SEED, False)
                worst = (0.0, 0.0)
                for n in ("loss",) + INT8_GRADS:
                    worst = _wmax(worst, lc[n][2:])
                readings[f"K3_H{h}"] = worst
                t = int8_tail_case(torch, 2, "bfloat16", SEED, False)
                readings[f"K4_y_H{h}"] = t["y"][:2]
                worst = (0.0, 0.0)
                for n in INT8_GRADS:
                    worst = _wmax(worst, t["residual", n][2:])
                readings[f"K5_H{h}"] = worst
            torch.cuda.empty_cache()
        log("limits_wide", build=" ".join(defines) or "sound",
            **{k: f"{a:.3e}/{m:.3e}" for k, (a, m) in readings.items()})
    fd._lib = d8._lib = l8._lib = (lambda: _build.load_library())


def wide_rows(wide, tw, slice_launches, levers, lever_counts,
              wide_ab, wide_ab_k3, wide_ab_k45) -> list:
    """The JSON records of the wide path: K1 (without and with
    activations) and K2's whole backward at WIDE_H on the deep sm90
    kernels (B=100; launches: [train_wide] and [slice_wide]), the tile
    kernels at the same calls as their yardstick (launches: their turns in
    ``[kernel_wide]``, ``wide_ab``), K3 on the wide cluster passes
    (launches: [train_wide]) and its block passes as their yardstick
    (launches: their checks and turns in ``[kernel_wide]`` and
    ``[k3_wide_turns]``, ``wide_ab_k3``), K4 (launches: its evaluation
    batches, the odd tails' and the CTF steps' K4 with a1) and K5's whole
    backward (the tails and CTF steps) at WIDE_H on the wide cluster
    passes, and their block passes as the yardstick (launches: their
    checks and turns in ``[kernel_wide]``, ``wide_ab_k45``), and K3 under
    the levers (the a1q_db1_qi call; launches: [train_int8_levers])."""
    b, hw, h, no = BATCH, IMAGE[0] * IMAGE[1], WIDE_H, CHANNELS
    kp = -(-h // 64) * 64
    f4 = 4
    k12 = wide["k12", h, "float32"]
    bd, bd0 = dec_bounds(b, hw, h, no, 4, 4), dec_bounds(b, hw, h, no, 4, 0)
    gemm = 2.0 * b * hw * h * h
    head = (2.0 * b * hw * h * no, PEAK_FP32)
    lc, t = wide["k3", h], wide["k45", h]
    i8_w = h * h + (h + no * h + no) * f4
    fold_io = b * 4 * h * f4 + hw * 2 * f4
    ws = 2.0 * b * kp * hw
    parts = (b * hw // 64) * (3 * h + h + no * h + no) * f4
    worst = lambda r, names: max(r[n][0] for n in names)
    lv = levers["a1q_db1_qi"]
    bwd_bound = (bd["chain"][0] + bd["dw"][0] + bd["sums"][0], "operations")
    k4_bound = bound(fold_io + i8_w + b * no * hw * f4, (gemm, PEAK_INT8),
                     head)
    k5_bound = bound(fold_io + i8_w + b * hw * h * 2 + 2 * b * no * hw * f4
                     + ws + parts, (2 * gemm, PEAK_INT8),
                     (2 * head[0], PEAK_FP32))
    i8w, ctf = tw["int8"]["k45"], tw["ctf"]["k45"]
    return [
        ("fused_decoder_fwd_wide_sm90", DEC90_DEEP_SOURCE, FWD_REPLACES,
         slice_launches, k12["fwd"]["y"][0], k12["fwd"]["ms"],
         k12["fwd"]["plain_ms"], bd0["fwd"], None),
        ("fused_decoder_fwd_acts_wide_sm90", DEC90_DEEP_SOURCE, FWD_REPLACES,
         tw["float"]["fwd_acts_sm90"], k12["acts"][0], k12["fwd_acts_ms"],
         k12["fwd_acts_plain_ms"], bd["fwd_acts"], None),
        ("fused_decoder_bwd_wide_sm90", DEC90_DEEP_SOURCE, BWD_REPLACES,
         tw["float"]["bwd_chain_sm90"],
         max(k12["residual", n][0] for n in GRADS), k12["residual_ms"],
         k12["residual_plain_ms"], bwd_bound, None),
        ("fused_decoder_fwd_wide_tile", FWD_SOURCE, FWD_REPLACES, 0,
         k12["fwd"]["tile_y"][0], k12["fwd"]["ms_tile"],
         k12["fwd"]["plain_ms"], bd0["fwd"], None, wide_ab["fwd"]),
        ("fused_decoder_fwd_acts_wide_tile", FWD_SOURCE, FWD_REPLACES, 0,
         k12["tile", "acts"][0], k12["fwd_acts_ms_tile"],
         k12["fwd_acts_plain_ms"], bd["fwd_acts"], None,
         wide_ab["fwd_acts"]),
        ("fused_decoder_bwd_wide_tile", BWD_SOURCE, BWD_REPLACES, 0,
         max(k12["residual", "tile", n][0] for n in GRADS),
         k12["residual_ms_tile"], k12["residual_plain_ms"], bwd_bound, None,
         wide_ab["bwd_chain"]),
        ("int8_loss_wide_sm90", LOSS90_WIDE_SOURCE, K3_REPLACES,
         tw["int8"]["k3"]["fwd_sm90"], worst(lc, ("loss",) + INT8_GRADS),
         lc["ms"], lc["plain_ms"], lc["bound"], None),
        ("int8_loss_wide", LOSS_WIDE_SOURCE, K3_REPLACES, 0,
         worst(lc["block"], ("loss",) + INT8_GRADS), lc["ms_block"],
         lc["plain_ms"], lc["bound"], None, wide_ab_k3["fwd"]),
        ("int8_fwd_wide_sm90", INT8_90_WIDE_SOURCE, K4_REPLACES,
         tw["eval_k4"] + i8w["fwd_acts_sm90"] + ctf["fwd_acts_sm90"],
         t["y_no_a1"][0], t["fwd_ms"], t["fwd_plain_ms"], k4_bound, None),
        ("int8_bwd_wide_sm90", INT8_90_WIDE_SOURCE, K5_REPLACES,
         i8w["bwd_grad_sm90"] + ctf["bwd_grad_sm90"],
         max(t["residual", n][0] for n in INT8_GRADS), t["residual_ms"],
         t["residual_plain_ms"], k5_bound, None),
        ("int8_fwd_wide", INT8_SOURCE, K4_REPLACES, 0, t["block_y"][0],
         t["fwd_ms_block"], t["fwd_plain_ms"], k4_bound, None,
         wide_ab_k45["fwd"] + wide_ab_k45["fwd_acts"]),
        ("int8_bwd_wide", INT8_SOURCE, K5_REPLACES, 0,
         max(t["block", "residual", n][0] for n in INT8_GRADS),
         t["residual_ms_block"], t["residual_plain_ms"], k5_bound, None,
         wide_ab_k45["bwd_grad"]),
        ("int8_loss_levers", LEVERS_SOURCE, K3_REPLACES,
         lever_counts["counts"]["k3"]["fwd"],
         max(lv[n][0] for n in INT8_GRADS), lv["ms"], lv["plain_ms"],
         lv["bound"], None),
    ]


def deep_rows(res, bwd, td, slice_launches) -> list:
    """The JSON records of the deep path (DEEP_LAYERS decoder layers, Lh =
    3, H = P_HIDDEN, f32, B=100): K1 without activations (launches:
    [slice_deep]), with them and K2's whole backward (launches:
    [train_deep]'s arms) on the deep sm90 kernels, and the tile kernels
    at the same calls as their yardstick (launches: the tile keys of the
    ``[kernel]`` / ``[kernel_bwd]`` turns, ``res["ab_counts"]``)."""
    b, hw, h, no = BATCH, IMAGE[0] * IMAGE[1], P_HIDDEN, CHANNELS
    lh = DEEP_LAYERS - 1
    k1, k2 = res["lh3_f32"], bwd["lh3_f32"]
    bd = dec_bounds(b, hw, h, no, 4, 4, lh)
    ab = res["ab_counts"]
    acts = sum(c["fwd_acts_sm90"] for c in td.values()
               if isinstance(c, dict) and "fwd_acts_sm90" in c)
    chain = sum(c["bwd_chain_sm90"] for c in td.values()
                if isinstance(c, dict) and "bwd_chain_sm90" in c)
    bwd_bound = (bd["chain"][0] + bd["dw"][0] + bd["sums"][0], "operations")
    grads = lambda *design: max(k2[("residual", *design, n)][0]
                                for n in GRADS)
    return [
        ("fused_decoder_fwd_deep_sm90", DEC90_DEEP_SOURCE, FWD_REPLACES,
         slice_launches, k1["err"], k1["ms"], k1["plain_ms"], k1["bound"],
         None),
        ("fused_decoder_fwd_acts_deep_sm90", DEC90_DEEP_SOURCE, FWD_REPLACES,
         acts, k2["acts"][0], k2["fwd_acts_ms"], k2["fwd_acts_plain_ms"],
         bd["fwd_acts"], None),
        ("fused_decoder_bwd_deep_sm90", DEC90_DEEP_SOURCE, BWD_REPLACES,
         chain, grads(), k2["residual_ms"], k2["residual_plain_ms"],
         bwd_bound, None),
        ("fused_decoder_fwd_deep_tile", FWD_SOURCE, FWD_REPLACES, 0,
         k1["tile_err"][0], k1["ms_tile"], k1["plain_ms"], k1["bound"],
         None, ab["fwd"]),
        ("fused_decoder_fwd_acts_deep_tile", FWD_SOURCE, FWD_REPLACES, 0,
         k2["tile", "acts"][0], k2["fwd_acts_ms_tile"],
         k2["fwd_acts_plain_ms"], bd["fwd_acts"], None, ab["fwd_acts"]),
        ("fused_decoder_bwd_deep_tile", BWD_SOURCE, BWD_REPLACES, 0,
         grads("tile"), k2["residual_ms_tile"], k2["residual_plain_ms"],
         bwd_bound, None, ab["bwd_chain"]),
    ]


def log_default_width(res, bwd) -> None:
    """``[default_width]``: K1-K5's device times at the default width (H =
    500) from this run's kernel phases, beside PERF.md's rows of the parent
    (the A/B against a checkout of the parent in one call is
    ``_default_width_ab``'s work, not this line's)."""
    i8 = res["int8"]
    log("default_width", H=P_HIDDEN, B=BATCH,
        k1_f32_ms=f"{res['galaxy_f32']['ms']:.4f}",
        k1_bf16_ms=f"{res['galaxy_bf16']['ms']:.4f}",
        k1_acts_f32_ms=f"{bwd['galaxy_f32']['fwd_acts_ms']:.4f}",
        k2_residual_f32_ms=f"{bwd['galaxy_f32']['residual_ms']:.4f}",
        k3_bf16_ms=f"{i8['loss', BATCH, 'bfloat16', True, False]['ms']:.4f}",
        k4_bf16_ms=f"{i8['tail', BATCH, 'bfloat16']['fwd_ms']:.4f}",
        k5_bf16_b37_ms=(
            f"{i8['tail', N_TRAIN % BATCH, 'bfloat16']['residual_ms']:.4f}"))


def dec_rows(torch, res, bwd, launches, counts, step_ms) -> list:
    """The JSON records of K1 and K2 at the float path's galaxy f32 shapes
    (B=100): the sm90 kernels the serving pass and the float step run
    (launches from those paths, the chain's and dW's ms from the profiled
    step), then the tile kernels as their yardstick (launches: the A/B
    turns and the tile-route cases of ``[kernel]`` and ``[kernel_bwd]``,
    ``res["ab_counts"]``; ms from those turns and one traced call), and
    the reductions both share.  One bound per function, whichever design
    computes it (``dec_bounds``: the f32 GEMMs at TF32_PASSES TF32
    products)."""
    b, hw, h, no = BATCH, IMAGE[0] * IMAGE[1], P_HIDDEN, CHANNELS
    g, k2 = res["galaxy_f32"], bwd["galaxy_f32"]
    bd = dec_bounds(b, hw, h, no, 4, 4)
    ab = res["ab_counts"]
    tparts = k2["residual_parts"]["tile"]
    tiles = hw // 64

    def worst(variant, *grads, design=()):
        return max(k2[(variant, *design, n)][0] for n in grads)

    return [
        ("fused_decoder_fwd_sm90", DEC90_SOURCE, FWD_REPLACES, launches,
         g["err"], g["ms"], g["plain_ms"], bd["fwd"], None),
        ("fused_decoder_fwd_acts_sm90", DEC90_SOURCE, FWD_REPLACES,
         counts["fwd_acts_sm90"], k2["acts"][0], k2["fwd_acts_ms"],
         k2["fwd_acts_plain_ms"], bd["fwd_acts"], None),
        ("fused_decoder_bwd_chain_sm90", DEC90_SOURCE, BWD_REPLACES,
         counts["bwd_chain_sm90"], worst("residual", "dfold", "dbhid", "dwht",
                                         "dbht"),
         step_ms["dec_chain90"], k2["residual_plain_ms"], bd["chain"], None),
        ("fused_decoder_bwd_dw_sm90", DEC90_SOURCE, BWD_REPLACES,
         counts["bwd_dw_sm90"], worst("residual", "dwhid"),
         step_ms["dec_dw90"], k2["residual_plain_ms"], bd["dw"], None),
        ("fused_decoder_fwd_tile", FWD_SOURCE, FWD_REPLACES, ab["fwd"],
         g["tile_err"][0], g["ms_tile"], g["plain_ms"], bd["fwd"], None),
        ("fused_decoder_fwd_acts_tile", FWD_SOURCE, FWD_REPLACES,
         ab["fwd_acts"], k2["tile", "acts"][0], k2["fwd_acts_ms_tile"],
         k2["fwd_acts_plain_ms"], bd["fwd_acts"], None),
        ("fused_decoder_bwd_chain_tile", BWD_SOURCE, BWD_REPLACES,
         ab["bwd_chain"], worst("residual", "dfold", "dbhid", "dwht", "dbht",
                                design=("tile",)),
         tparts["bwd_chain"], k2["residual_plain_ms"], bd["chain"], None),
        ("fused_decoder_bwd_dw_tile", BWD_SOURCE, BWD_REPLACES,
         ab["bwd_dw"], worst("residual", "dwhid", design=("tile",)),
         tparts["bwd_dw"], k2["residual_plain_ms"], bd["dw"], None),
        ("fused_decoder_bwd_sum_rows", BWD_SOURCE, BWD_REPLACES,
         counts["bwd_sum"], worst("residual", *GRADS), step_ms["sum_rows"],
         k2["residual_plain_ms"], bd["sums"],
         torch_sum_ms(torch, [(b, tiles, 3 * h), (1, b * hw // 4096, h * h),
                              (1, b * tiles, (1 + no) * h + no)])),
    ]


def kernel_rows(torch, res, bwd, launches, counts, step_ms, i8,
                fam_counts, knobs) -> list:
    """The per-kernel JSON records: K1 and K2 (``dec_rows``), K3 at the int8
    training step's (bf16 weights, B=100: the cluster passes it runs, and
    the block passes in the colored step's profile on them, launched on the
    knob paths), K4 without a1 at the evaluation's (B=100) and with a1, K5 at the
    tail step's (B=37), and K3's whole call in the Gaussian, colored and
    padded families at the particles, colored and mnist steps' (bf16
    weights, B=100; launches: that model's K3 calls).  Bounds from the
    shapes (PEAK_* above)."""
    b, hw, h, no = BATCH, IMAGE[0] * IMAGE[1], P_HIDDEN, CHANNELS
    kp = -(-h // 64) * 64
    f4 = 4                                      # f32 bytes
    gemm = 2.0 * b * hw * h * h
    head = (2.0 * b * hw * h * no, PEAK_FP32)   # on the CUDA cores
    rows = dec_rows(torch, res, bwd, launches, counts, step_ms)
    # the int8 path
    lc = res["int8"]["loss", BATCH, "bfloat16", True, False]
    tb = N_TRAIN % BATCH                        # the tail step's batch
    tail = res["int8"]["tail", tb, "bfloat16"]
    ev = res["int8"]["tail", BATCH, "bfloat16"]
    c3, c45 = i8["counts"]["k3"], i8["counts"]["k45"]
    i8_w = h * h + (h + no * h + no) * f4       # int8 W1 copy + f32 rest
    fold_io = b * 4 * h * f4 + hw * 2 * f4
    yt_b = b * no * hw                          # int8 targets
    dz2_b = b * no * hw * f4
    ws = 2.0 * b * kp * hw                      # the two int8 workspaces
    blocks = b * hw // 64
    mw = h + no * h + no
    parts = blocks * (3 * h + mw + 2) * f4
    splits = 16
    k3_abs = lambda *ns: max(lc[n][0] for n in ns)
    a1c = b * hw * h * 2                        # a bf16 a1c, H columns
    # the cluster passes: launches and device ms from the galaxy int8 path;
    # the block passes: launches from the knob paths that run K3 off the
    # default numerics (every family takes the cluster passes there), device
    # ms from the colored step profiled with K3 on the block passes
    col = {k: sum(knobs[tag]["counts"]["k3"][k]
                  for tag, _, _, kernel in KNOB_PATHS if kernel == "k3")
           for k in ("fwd", "grad", "dw")}
    t7 = {k[1]: v for k, v in res["fam_prof"]["colored"].items()
          if k[0] == "k3_block"}
    col_err = max(res["families"]["colored_mask", "bfloat16"]["block"][n][0]
                  for n in INT8_GRADS)
    rows += [
        # the bounds count the work each pass's function needs, not the
        # design's a1c stash: the forward without its write, the gradient
        # with the cheaper of reading a1c and rebuilding it (W1f^T and one
        # more product); dWh^T and da1 are its two head products
        ("int8_loss_fwd_sm90", LOSS90_SOURCE, K3_REPLACES, c3["fwd_sm90"],
         lc["loss"][0], i8["k3", "loss_fwd90"], lc["plain_ms"],
         bound(fold_io + i8_w + yt_b + dz2_b + 2 * blocks * f4,
               (gemm, PEAK_INT8), head), None),
        ("int8_loss_grad_sm90", LOSS90_SOURCE, K3_REPLACES, c3["grad_sm90"],
         k3_abs("dfold", "db1", "dwht", "dbht"), i8["k3", "loss_grad90"],
         lc["plain_ms"],
         min(bound(fold_io + i8_w + dz2_b + ws + parts + a1c,
                   (gemm, PEAK_INT8), (2 * head[0], PEAK_FP32)),
             bound(fold_io + 2 * i8_w + dz2_b + ws + parts,
                   (2 * gemm, PEAK_INT8), (2 * head[0], PEAK_FP32))), None),
        ("int8_grouped_dw_sm90", LOSS90_SOURCE, K3_REPLACES, c3["dw_sm90"],
         k3_abs("dw1"), i8["k3", "dw90"], lc["plain_ms"],
         bound(ws + 15 * h * h * f4, (gemm, PEAK_INT8)), None),
        ("int8_loss_fwd", LOSS_SOURCE, K3_REPLACES, col["fwd"],
         col_err, t7["loss_fwd"], lc["plain_ms"],
         bound(fold_io + i8_w + yt_b + dz2_b + 2 * blocks * f4,
               (gemm, PEAK_INT8), head), None),
        ("int8_loss_grad", LOSS_SOURCE, K3_REPLACES, col["grad"],
         col_err, t7["loss_grad"], lc["plain_ms"],
         bound(fold_io + 2 * i8_w + dz2_b + ws + parts,
               (2 * gemm, PEAK_INT8), (3 * head[0], PEAK_FP32)), None),
        ("int8_grouped_dw_k3", INT8_SOURCE, K3_REPLACES, col["dw"],
         col_err, t7["dw"], lc["plain_ms"],
         bound(ws + splits * h * h * f4, (gemm, PEAK_INT8)), None),
        ("int8_loss_sum_rows", BWD_SOURCE, K3_REPLACES, c3["sum"],
         k3_abs(*INT8_GRADS), i8["k3", "sum_rows"], lc["plain_ms"],
         bound(parts + splits * h * h * f4),
         torch_sum_ms(torch, [(b, hw // 64, 3 * h), (b, hw // 64, 1),
                              (1, splits, h * h), (1, blocks, mw)])),
    ]
    for model, (row, case) in FAMILY_ROWS.items():
        r = res["families"][case, "bfloat16"]
        rows.append((row, LOSS90_SOURCE, K3_REPLACES,
                     fam_counts[model]["k3"]["fwd"]
                     + fam_counts[model]["k3"]["fwd_sm90"],
                     max(r[n][0] for n in INT8_GRADS), r["ms"],
                     r["plain_ms"], r["bound"], None))
    t_gemm = 2.0 * tb * hw * h * h
    t_head = (2.0 * tb * hw * h * no, PEAK_FP32)
    t_io = tb * 4 * h * f4 + hw * 2 * f4 + i8_w + tb * no * hw * f4
    t_a1 = tb * hw * h * 2                       # bf16 residual
    t_ws = 2.0 * tb * kp * hw
    t_blocks = tb * hw // 64
    t_parts = t_blocks * (3 * h + mw + 1) * f4
    k5_abs = lambda *ns: max(tail["residual", n][0] for n in ns)
    ab45 = res["int8"]["ab_k45"]
    bounds = {
        "fwd": bound(fold_io + i8_w + b * no * hw * f4, (gemm, PEAK_INT8),
                     head),
        "fwd_a1": bound(t_io + t_a1, (t_gemm, PEAK_INT8), t_head),
        "scale": bound(t_io + t_a1 + tb * no * hw * f4 + t_blocks * f4,
                       t_head),
        "grad": bound(t_io + i8_w + t_a1 + tb * no * hw * f4 + t_ws
                      + t_parts, (t_gemm, PEAK_INT8),
                      (2 * t_head[0], PEAK_FP32)),
        "dw": bound(t_ws + splits * h * h * f4, (t_gemm, PEAK_INT8)),
        "dw90": bound(t_ws + 15 * h * h * f4, (t_gemm, PEAK_INT8))}
    # the cluster passes: launches from the int8 path (K4 per evaluation
    # batch, K4 with a1 and K5 per odd tail), ms from the calls' turns (K4)
    # and the profiled tail step (K5's passes); the block passes: no launch
    # on any path at H <= 512, their checks' and turns' launches
    # (ab_launches), ms from their turns and one traced tail call
    blk = tail["block_device"]
    rows += [
        ("int8_fwd90", INT8_90_SOURCE, K4_REPLACES, i8["eval_k4"],
         ev["y_no_a1"][0], ev["fwd_ms"], ev["fwd_plain_ms"], bounds["fwd"],
         None),
        ("int8_fwd90_a1", INT8_90_SOURCE, K4_REPLACES, c45["fwd_acts_sm90"],
         max(tail["y"][0], tail["a1"][0]), i8["tail", "fwd90"],
         tail["fwd_a1_plain_ms"], bounds["fwd_a1"], None),
        ("int8_bwd_scale90", INT8_90_SOURCE, K5_REPLACES,
         c45["bwd_scale_sm90"], k5_abs("dw1", "dfold"),
         i8["tail", "scale90"], tail["residual_plain_ms"], bounds["scale"],
         None),
        ("int8_bwd_grad90", INT8_90_SOURCE, K5_REPLACES, c45["bwd_grad_sm90"],
         k5_abs("dfold", "db1", "dwht", "dbht"), i8["tail", "grad90"],
         tail["residual_plain_ms"], bounds["grad"], None),
        ("int8_grouped_dw90_k5", LOSS90_SOURCE, K5_REPLACES, c45["dw_sm90"],
         k5_abs("dw1"), i8["tail", "dw90"], tail["residual_plain_ms"],
         bounds["dw90"], None),
        ("int8_fwd", INT8_SOURCE, K4_REPLACES, 0, ev["vs_block"]["y"][0],
         ev["fwd_ms_block"], ev["fwd_plain_ms"], bounds["fwd"], None,
         ab45["fwd"]),
        ("int8_fwd_a1", INT8_SOURCE, K4_REPLACES, 0,
         tail["vs_block"]["a1"][0], tail["fwd_a1_ms_block"],
         tail["fwd_a1_plain_ms"], bounds["fwd_a1"], None, ab45["fwd_acts"]),
        ("int8_bwd_scale", INT8_SOURCE, K5_REPLACES, 0,
         k5_abs("dw1", "dfold"), blk["int8_bwd_scale"],
         tail["residual_plain_ms"], bounds["scale"], None,
         ab45["bwd_scale"]),
        ("int8_bwd_grad", INT8_SOURCE, K5_REPLACES, 0,
         k5_abs("dfold", "db1", "dwht", "dbht"), blk["int8_bwd_grad"],
         tail["residual_plain_ms"], bounds["grad"], None, ab45["bwd_grad"]),
        ("int8_grouped_dw_k5", INT8_SOURCE, K5_REPLACES, 0, k5_abs("dw1"),
         blk["grouped_dw_kernel"], tail["residual_plain_ms"], bounds["dw"],
         None, ab45["dw"]),
        ("int8_bwd_sum_rows", BWD_SOURCE, K5_REPLACES, c45["sum"],
         k5_abs(*INT8_GRADS), i8["tail", "sum_rows"],
         tail["residual_plain_ms"],
         bound(t_parts + splits * h * h * f4),
         torch_sum_ms(torch, [(tb, hw // 64, 3 * h), (1, splits, h * h),
                              (1, t_blocks, mw)])),
    ]
    # K3 (e) and (f) and K8, each whole call at the galaxy shape (bf16
    # weights, B=100; K3 (f) in the mode its epoch trains); launches: its
    # trained path's calls.  SR runs the cluster passes (its SR kernels,
    # counted under the cluster keys); its block passes are the yardstick,
    # launched on no path: ab_launches, their checks' and turns'
    sr = res["sr"]["bfloat16"]
    sr_path = knobs["train_int8_sr"]["counts"]["k3"]
    for row, src, rep_, r, nl in (
            ("int8_loss_sr", LOSS90_SR_SOURCE, K3_REPLACES, sr,
             sr_path["fwd_sm90"]),
            ("int8_loss_numerics", LOSS_SOURCE, K3_REPLACES,
             res["numerics"]["i8_epi_f32"],
             knobs["train_int8_numerics"]["counts"]["k3"]["fwd"]),
            ("int8_loss_t", LOSS_SOURCE, K8_REPLACES, res["t"]["i4", 64],
             knobs["train_int8_t"]["counts"]["k8"]["fwd"])):
        rows.append((row, src, rep_, nl,
                     max(r[n][0] for n in INT8_GRADS), r["ms"],
                     r["plain_ms"], r["bound"], None))
    rows.append(("int8_loss_sr_block", LOSS_SOURCE, K3_REPLACES,
                 sr_path["fwd"], max(sr["block"][n][0] for n in INT8_GRADS),
                 sr["ms_block"], sr["plain_ms"], sr["bound"], None,
                 res["sr"]["block_launches"]))
    # Adam: the step kernel's rows time one step's Adam over the 13 galaxy
    # leaves (one launch; launches: the training paths'), the per-leaf K6
    # rows the same step in 13 launches (launches: the training paths', 0;
    # a tenth field, ab_launches: their launches in [kernel_adam] and
    # [kernel_adam_emit], checks and A/B turns); K7 and the helpers the two
    # big encoder weights; library: torch._fused_adam_ on float32 copies of
    # the same leaves
    a, e = res["adam"], res["adam_emit"]["f32m"]
    ab = res["adam_ab"]
    i8_adam = i8["counts"]["adam"]
    trained = (i8_adam, i8["bench_adam"], i8["emit_adam"])
    leaf_main = {n: sum(c[n] for c in trained) for n in ("adam", "adam_emit")}
    leaf_main["adam"] += counts["adam_leaf"]
    for name, nl in (("f32", counts["adam"]),
                     ("bf16g_shadow", i8_adam["adam_step"]),
                     ("bf16_shadow", i8["bench_adam"]["adam_step"])):
        r = a[name]
        rows += [(f"adam_step_{name}", ADAM90_SOURCE, K6_REPLACES, nl,
                  r["err"], r["ms"], r["plain_ms"], r["bound"], r["lib_ms"]),
                 (f"adam_{name}", ADAM_SOURCE, K6_REPLACES, leaf_main["adam"],
                  r["leaf_err"], r["leaf_ms"], r["plain_ms"], r["bound"],
                  r["lib_ms"], ab["adam"])]
    t = e["times"]
    rows += [
        ("adam_step_emit", ADAM90_SOURCE, K7_REPLACES,
         i8["emit_adam"]["adam_step"], e["err"], t["k7_step"],
         t["k7_plain"], e["bound"], t["fused_adam"]),
        ("adam_emit", ADAM_SOURCE, K7_REPLACES, leaf_main["adam_emit"],
         e["leaf_err"], t["k7_leaf"], t["k7_plain"], e["bound"],
         t["fused_adam"], ab["adam_emit"]),
        ("quant_scale", ADAM_SOURCE, QUANT_REPLACES, i8_adam["quant_scale"],
         e["err"], t["quant_scale"], t["quant_scale_plain"],
         e["scale_bound"], None),
        ("quantize", ADAM_SOURCE, QUANT_REPLACES, i8_adam["quantize"],
         e["q_err"], t["quantize"], t["quantize_plain"], e["quantize_bound"],
         None),
    ]
    return rows


# ---- this slice: the int4 and narrow-accumulator probes (the port of the
# TPU tools tools/probe_int4.py and tools/probe_i16acc.py), every run at the
# tools' defaults
PROBE_SOURCE = "spatialvae_torch/kernels/csrc/probes.cu"
# the TPU kernel each run replaces (its pallas_call)
PROBE_REPLACES = {
    name: f"tools/probe_int4.py:{line}" for line, names in (
        (101, ("gemm-int8", "gemm-int4", "gemm-i4w")),
        (144, ("dw1T-i4(1,1)", "da0T-i4(1,0)", "fwdT-i8(1,0)",
               "fwdT-i4(1,0)")),
        (183, ("buildT-vpu",)), (205, ("gemm-i8xi4",)),
        (242, ("tdw1-pre-i4", "tdw1-pre-i8", "tdw1-tr-i4", "tdw1-tr-i8")),
        (271, ("tr-only-i8",))) for name in names}
I16ACC_REPLACES = "tools/probe_i16acc.py:47"
# the IMMA instructions each s8 GEMM kernel's tiles imply: per 64-byte k
# slab (two m16n8k32 steps) a warp runs its (32 x 64) tile as 2 x 8 m16n8
# tiles in the 128 x 128 block, its (32 x 32) tile as 2 x 4 in the 64 x 32
# block; the k loop is not unrolled.  An s4 kernel must hold some: ptxas
# compiles every s4 mma.sync site to a call of one routine with two s8
# IMMAs
PROBE_IMMA_S8 = {"big": 2 * 8 * 2, "small": 2 * 4 * 2}
PROBE_TIMED = 5
# the tools' timing repeats on the smoke's main path (sizes stay the tools'
# defaults): the s4 arm's products take ~90 ms a call
PROBE_MAIN_ARGV = ["iters=2"]


def sass_imma(path) -> dict:
    """{kernel: (IMMA count, sorted IMMA opcodes)} of the library's SASS
    (``cuobjdump -sass``)."""
    from spatialvae_torch.kernels._build import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=600).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            found[fn] = []
        elif fn is not None:
            found[fn] += [w.rstrip(";") for w in line.split()
                          if w.startswith("IMMA")]
    return {f: (len(ops), sorted(set(ops))) for f, ops in found.items()}


def graph_ms(torch, call, reps: int) -> float:
    """Device ms of ``reps`` calls of ``call`` captured in one CUDA graph
    (the library yardstick: back to back, without the host's launches)."""
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    g.replay()
    torch.cuda.synchronize()
    ms = statistics.median([cuda_ms(g.replay, torch) for _ in range(3)])
    del g
    return ms


def _words_differ(got, want) -> tuple:
    """(elements of out and sums that differ, max |out - plain out|)."""
    (o, s), (po, ps) = got, want
    n = int((o != po).sum().item()) + int((s != ps).sum().item())
    return n, (o.double() - po.double()).abs().max().item()


def probe_reading(torch, run, arrays, imma, timed=True) -> dict:
    """One run's kernel against its plain version on the same arrays:
    words that differ (out and every block's sum), the kernel's kernel
    name and IMMA count (GEMM runs), and with ``timed`` its ms, the plain
    version's ms, its bound and the library call's ms (``steps`` calls from
    a CUDA graph)."""
    from spatialvae_torch.kernels import probes

    got = run.fn(arrays)
    torch.cuda.synchronize()
    want = [None]
    plain_ms = cuda_ms(lambda: want.__setitem__(0, run.plain(arrays)), torch)
    differ, err = _words_differ(got, want[0])
    r = {"differ": differ, "err": err, "plain_ms": plain_ms,
         "bound": bound(run.nbytes, (run.int8_ops, PEAK_INT8),
                        (run.f32_ops, PEAK_FP32))}
    if differ:
        raise AssertionError(f"{run.name}: {differ} words differ from the "
                             f"plain version")
    if run.gemm is not None:
        dims, elem, k, store = run.gemm
        r["kernel"] = probes.gemm_kernel_name(dims, elem, k, store)
        r["imma"], r["opcodes"] = imma[r["kernel"]]
        want_imma = PROBE_IMMA_S8["small" if r["kernel"].endswith(
            "_small") else "big"] if elem == "s8" else None
        if r["imma"] == 0 or (want_imma and r["imma"] != want_imma):
            raise AssertionError(f"{r['kernel']}: {r['imma']} IMMA, its "
                                 f"tiles imply {want_imma or '> 0'}")
    else:
        r["kernel"] = ("probe_build_t" if run.name == "buildT-vpu"
                       else "probe_transpose_sum")
    if timed:
        run.fn(arrays)
        r["ms"] = statistics.median([cuda_ms(lambda: run.fn(arrays), torch)
                                     for _ in range(PROBE_TIMED)])
        r["lib_ms"] = (graph_ms(torch, run.library(arrays), run.steps)
                       if run.library else None)
    return r


def phase_probes(torch) -> list:
    """``[probe_int4]`` and ``[probe_i16acc]``: each tool's entry point at
    its default sizes (the main path: launches counted from 0 around it),
    then every run's kernel against its plain version on the tool's arrays
    (0 words may differ), with its ms, bound, library ms and each GEMM
    kernel's IMMA count
    in the library's SASS; the int16 store once more on full-range int8
    values, where it must saturate, and the s4 pack kernel.  Returns the
    JSON records, one per run and one for the pack."""
    from spatialvae_torch.kernels import _build, probes
    from spatialvae_torch.tools import probe_i16acc, probe_int4

    imma = sass_imma(_build.library_path())
    rows = []
    t0 = time.perf_counter()
    for tag, tool, argv, arrays, runs, replaces in (
            ("probe_int4", probe_int4, PROBE_MAIN_ARGV,
             probe_int4.make_arrays(2048, DEVICE), probe_int4.runs(2048),
             PROBE_REPLACES),
            ("probe_i16acc", probe_i16acc, [], probe_i16acc.make_arrays(
                DEVICE), probe_i16acc.runs(), None)):
        probes.reset_launches()
        rc = tool.main(argv)
        torch.cuda.synchronize()
        launches = dict(probes.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"{tag}: exit {rc}")
        for run in runs:
            r = probe_reading(torch, run, arrays, imma)
            nl = launches.get(r["kernel"], 0)
            log(tag, run=run.name, kernel=r["kernel"], launches=nl,
                words_differ=r["differ"],
                imma=r.get("imma", "-"),
                opcodes=",".join(r.get("opcodes", [])) or "-",
                ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
                bound_ms=f"{r['bound'][0]:.4f}", bound_by=r["bound"][1],
                library_ms=("-" if r["lib_ms"] is None
                            else f"{r['lib_ms']:.4f}"))
            rep = replaces[run.name.split(":")[0]] if replaces else \
                I16ACC_REPLACES
            rows.append((f"probe:{run.name}", PROBE_SOURCE, rep, nl, r["err"],
                         r["ms"], r["plain_ms"], r["bound"], r["lib_ms"]))
        if tag == "probe_int4":
            x = arrays["a4in8"]
            pk = lambda: probes.pack_s4(x, 1)
            differ = int((pk() != probes.pack_s4_reference(x, 1)).sum())
            if differ:
                raise AssertionError(f"pack_s4: {differ} bytes differ")
            pk()
            ms = statistics.median([cuda_ms(pk, torch)
                                    for _ in range(PROBE_TIMED)])
            pms = cuda_ms(lambda: probes.pack_s4_reference(x, 1), torch)
            bd = bound(1.5 * x.numel())
            nl = launches.get("probe_pack_s4", 0)
            log(tag, run="pack_s4", launches=nl, words_differ=differ,
                ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
                bound_ms=f"{bd[0]:.4f}", bound_by=bd[1])
            rows.append(("probe:pack_s4", PROBE_SOURCE,
                         PROBE_REPLACES["gemm-int4"], nl, 0.0, ms, pms, bd,
                         None))
        else:
            full = _full_range_i16acc(torch)
            r = probe_reading(torch, full, probe_i16acc_full_arrays(torch),
                              imma, timed=False)
            log(tag, run=full.name, words_differ=r["differ"])
        del arrays
        torch.cuda.empty_cache()
    log("probes", seconds=f"{time.perf_counter() - t0:.1f}")
    return rows


def probe_i16acc_full_arrays(torch) -> dict:
    """T3's shapes with int8 values over [-127, 127]: sums up to 8.3e6,
    beyond int16."""
    from spatialvae_torch.tools import probe_i16acc

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return {k: torch.randint(-127, 128, shape, generator=gen, device=DEVICE,
                             dtype=torch.int8)
            for k, shape in (("aq", (probe_i16acc.PT, probe_i16acc.H)),
                             ("wq", (probe_i16acc.H, probe_i16acc.H)))}


def _full_range_i16acc(torch):
    from spatialvae_torch.tools import probe_i16acc

    run = next(r for r in probe_i16acc.runs(s4=False)
               if r.name == "acc=int16")
    return dataclasses.replace(run, name="acc=int16 full-range")


PROBE_FAULTS = (
    ("sound", ()),
    ("drops the last k slab", ("-DSVT_PROBE_DROP_LAST_K=1",)),
    ("int16 store wraps", ("-DSVT_PROBE_I16_WRAP=1",)),
    ("transpose swaps two rows", ("-DSVT_PROBE_TR_SWAP=1",)))


def phase_limits_probes(torch) -> None:
    """``--limits probes``: every probe run (both tools, both arms, the
    int16 store on full-range values) through the sound library and three
    faulty copies, built together: the last k slab of every product
    dropped, the int16 store wrapping, two rows of every 4 x 4 byte
    transpose swapped.  Prints each build's words that differ per run; the
    sound build must read 0 and each copy must be refused by some run."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build, probes
    from spatialvae_torch.tools import probe_i16acc, probe_int4

    with ThreadPoolExecutor(len(PROBE_FAULTS)) as ex:
        list(ex.map(_build.build, [d for _, d in PROBE_FAULTS]))
    cases = [(r, "t2") for r in probe_int4.runs(2048)] + [
        (r, "t3") for r in probe_i16acc.runs()] + [
        (_full_range_i16acc(torch), "full")]
    arrays = {"t2": probe_int4.make_arrays(2048, DEVICE),
              "t3": probe_i16acc.make_arrays(DEVICE),
              "full": probe_i16acc_full_arrays(torch)}
    want = {r.name: r.plain(arrays[a]) for r, a in cases}
    for label, defines in PROBE_FAULTS:
        lib = _build.load_library(defines)
        probes._lib = (lambda lib=lib: lib)
        readings = {}
        for r, a in cases:
            got = r.fn(arrays[a])
            torch.cuda.synchronize()
            readings[r.name] = _words_differ(got, want[r.name])[0]
        refused = [n for n, v in readings.items() if v]
        log("limits_probes", build=label, refused=len(refused),
            of=len(readings), **{n: v for n, v in readings.items()})
        if label == "sound" and refused:
            raise AssertionError(f"the sound build differs: {readings}")
        if label != "sound" and not refused:
            raise AssertionError(f"the copy that {label} passes every run")
    probes._lib = (lambda: _build.load_library())


# ---- this slice: the int8 kernel microbenchmark (the port of the TPU tool
# tools/kernel_bench.py), its seventeen runs at the tool's defaults
KB_SOURCES = {
    "gemm1": PROBE_SOURCE,
    "gemm2": "spatialvae_torch/kernels/csrc/kernel_bench_gemm.cu",
    "gemm3": "spatialvae_torch/kernels/csrc/kernel_bench_gemm.cu",
    "fused-plain": "spatialvae_torch/kernels/csrc/kernel_bench_bwd.cu",
    "bwd-fixscale": "spatialvae_torch/kernels/csrc/kernel_bench_bwd.cu",
    "fwd-nores": INT8_SOURCE,
}
KB_CHAIN_SOURCE = "spatialvae_torch/kernels/csrc/kernel_bench.cu"
# T1's rows of the kernels line: (row, run, the TPU kernel's pallas_call,
# the LAUNCHES entry (module, key) counted on the main path)
KB_ROWS = [
    ("T1.1", "gemm1", 141, ("probes", "probe_gemm_s8_d10_big")),
    ("T1.2", "gemm2", 166, ("kb", "gemm_multi:gemm2")),
    ("T1.3", "gemm1+vpu", 197, ("kb", "chain:dep")),
    ("T1.4", "vpu-only", 227, ("kb", "chain:rows")),
    ("T1.5", "gemm1+ivpu", 260, ("kb", "chain:ind_rows")),
    ("T1.6", "gemm1+ivpu2", 300, ("kb", "chain:ind_sums")),
    ("T1.7", "vpu-full", 335, ("kb", "chain:sums")),
    ("T1.8", "fwd-nores", 371, ("d8", "fwd")),
    ("T1.9", "fwd-pipe2", 445, ("kb", "fwd_pipe2")),
    ("T1.9", "fwd-pipe4", 445, ("kb", "fwd_pipe4")),
    ("T1.10", "gemm3", 510, ("kb", "gemm_multi:gemm3")),
    ("T1.11", "fused-plain", 619, ("kb", "plain_grad")),
    ("T1.12", "bwd-fixscale", 766, ("kb", "fix_grad")),
]
# the four runs that reach the package's kernels (K4, K3, K8, K5): held
# against their plain versions here, their rows are K3's, K4's, K5's, K8's
KB_PACKAGE_RUNS = ("fwd", "fused-loss", "fused-t", "bwd")
# images of the kernel-vs-plain comparisons (the same HW, H and pt as the
# tool's defaults; the plain versions cannot hold B=2,048's (B, HW, H)
# intermediates): even, as K3 and K8 take image pairs (odd counts are in
# tests/test_torch_port_cuda.py), and 64 steps, so the chain, fwd-pipe and
# GEMM kernels split the grid into 4 step groups (256, 256 and 4-16 at the
# defaults) and each group's sums and rows are held
KB_B = 32
# the runs whose kernels take step groups; each must run in more than one
KB_GROUPED = ("gemm1", "gemm2", "gemm1+vpu", "vpu-only", "gemm1+ivpu",
              "gemm1+ivpu2", "vpu-full", "fwd-pipe2", "fwd-pipe4", "gemm3")
# runs traced once at the defaults: each kernel's device ms (the backward's
# and the loss kernel's passes apart)
KB_PROFILED = ("fused-plain", "fused-loss", "bwd", "bwd-fixscale")
# the runs that reach K4 and K5 (their cluster passes at the tool's
# defaults): timed in turns with the block passes
KB_I8_RUNS = ("fwd-nores", "fwd", "bwd")


def _kb_route(k4_alone: bool):
    """The route ``int8_route``'s table gives a T1 run's K4/K5 calls (T1's
    weights are float32), at the tool's shape."""
    def route():
        from spatialvae_torch.kernels import fused_decoder_int8 as d8
        from spatialvae_torch.tools import kernel_bench as tool

        return d8.int8_route(tool.HW, tool.H, k4_alone_f32=k4_alone)
    return route


KB_I8_ROUTE = {"fwd-nores": _kb_route(True), "fwd": _kb_route(True),
               "bwd": _kb_route(False)}
# T1's K4 calls (f32 weights, no a1) on the table's route: the block pass
KB_K4_KEY = "fwd"
KB_PASSES = {"scale": "int8_bwd_scale", "grad": "int8_bwd_grad",
             "fwd90": "int8_fwd90", "scale90": "int8_scale90",
             "grad90": "int8_grad90",
             "loss_fwd": "loss_fwd_kernel", "loss_grad": "loss_grad_kernel",
             "loss_fwd90": "loss_fwd90_kernel",
             "loss_grad90": "loss_grad90_kernel",
             "dw90": "grouped_dw90_kernel",
             "fwd": "int8_fwd_kernel", "dw": "grouped_dw_kernel",
             "sum_rows": "sum_rows_kernel"}
KB_PT = 2048            # the tool's default pixels per step
KB_TIMED = 5
KB_MAIN_ARGV = ["iters=2"]
# kernel vs plain limits of the float outputs (the integer ones, and the
# per-block sums of integers, must agree in every word): gemm1+vpu's a1
# rows by absolute error (max, mean) and its per-block f64 sums of a1 by
# error relative to |plain|; the forwards' y and a1 as K4's (INT8_Y_TOL,
# INT8_A1_TOL); the backward and loss runs as K3's and K5's (INT8_TOL).
# `--limits kernel_bench` reads them for the sound build and for copies
# with the a1 scale missing its /127, fused-plain's scale taken per
# 64-pixel block, bwd-fixscale's dh1 without its (1 - a1^2) factor
KB_A1_ROWS_TOL = (2e-6, 2e-7)
KB_FSUM_TOL = 1e-6
KB_CHECKS = {
    "gemm1+vpu": ((("abs", KB_A1_ROWS_TOL),), ("int", ("f64", KB_FSUM_TOL))),
    "fwd-nores": ((("abs", INT8_Y_TOL),), ()),
    "fwd": ((("abs", INT8_Y_TOL),), ()),
    "fwd-pipe2": ((("abs", INT8_Y_TOL), ("abs", INT8_A1_TOL)), ()),
    "fwd-pipe4": ((("abs", INT8_Y_TOL), ("abs", INT8_A1_TOL)), ()),
}
# the runs whose outputs are sums over the grid (backward and loss): every
# output by its error relative to max|plain|
KB_SUM_RUNS = ("fused-plain", "bwd-fixscale", "fused-loss", "fused-t", "bwd")
KB_FAULTS = (
    ("sound", ()),
    ("a1 scale without /127", ("-DSVT_KB_A1_NO_127=1",)),
    ("fused-plain scale per 64-pixel block", ("-DSVT_INT8_BLOCK_SCALE=1",)),
    ("bwd-fixscale without (1 - a1^2)", ("-DSVT_KB_FIX_NO_TANH_PRIME=1",)),
)


def kb_check(torch, name, got, want) -> dict:
    """One T1 run's outputs and per-block sums, kernel against plain: the
    integer ones by the words that differ, the float ones by their errors
    (KB_CHECKS; the backward and loss runs' five or two outputs relative to
    max|plain|).  Returns {"differ", "err" (the largest abs error of a
    float output, 0 for integers), "fields"}; raises past a limit."""
    outs, sums = got
    pouts, psums = want
    checks = KB_CHECKS.get(name)
    if checks is None:
        kind = ("rel", INT8_TOL) if name in KB_SUM_RUNS else "int"
        checks = ((kind,) * len(outs), ("int",) * len(sums))
    r = {"differ": 0, "err": 0.0, "fields": {}}
    for what, kinds, gs, ws in (("out", checks[0], outs, pouts),
                                ("sum", checks[1], sums, psums)):
        for i, (kind, g, w) in enumerate(zip(kinds, gs, ws)):
            key = f"{what}{i}"
            if kind == "int":
                n = int((g != w).sum().item())
                r["differ"] += n
                r["fields"][key] = n
                continue
            kind, tol = kind
            d = (g.double() - w.double()).abs()
            if kind == "f64":
                e = (d / w.double().abs().clamp(min=1.0)).max().item()
                r["fields"][key] = f"{e:.3e}"
                if e > tol:
                    raise AssertionError(f"{name} {key}: {e} > {tol}")
                continue
            r["err"] = max(r["err"], d.max().item())
            if kind == "abs":
                errs = (d.max().item(), d.mean().item())
                r["fields"][key] = f"{errs[0]:.3e}/{errs[1]:.3e}"
                _check_abs(f"{name} {key}", errs, tol)
            else:
                r["fields"][key] = _check_rel(f"{name} {key}",
                                              rel_errors(g, w), tol)
    if r["differ"]:
        raise AssertionError(f"{name}: {r['differ']} words differ from the "
                             f"plain version: {r['fields']}")
    return r


def _kb_modules():
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels import fused_loss_int8_t as lt
    from spatialvae_torch.kernels import kernel_bench as kb
    from spatialvae_torch.kernels import probes

    return {"probes": probes, "kb": kb, "d8": d8, "l8": l8, "lt": lt}


def _kb_reset() -> None:
    for m in _kb_modules().values():
        m.reset_launches()


def _kb_launches() -> dict:
    return {(name, k): v for name, m in _kb_modules().items()
            for k, v in m.LAUNCHES.items()}


def kb_readings(torch, b: int, timed: bool) -> dict:
    """Every T1 run, kernel against plain version, on the tool's arrays at
    ``b`` images (the tool's HW, H and pt), each run's prepared arrays
    dropped after it: kb_check's readings, with ``timed`` the plain
    version's ms."""
    from spatialvae_torch.tools import kernel_bench as tool

    from spatialvae_torch.kernels import kernel_bench as kb

    arrays = tool.make_arrays(b, tool.HW, KB_PT, DEVICE)
    steps = kb.grid_steps(b, tool.HW, KB_PT)
    out = {}
    for run in tool.runs(b, tool.HW, KB_PT):
        extra = run.prepare(arrays) if run.prepare else {}
        arrays.update(extra)
        got = run.fn(arrays)
        groups = 0
        if run.name in KB_GROUPED:
            groups = (got[1][0].shape[0] if got[1]
                      else kb.step_groups(steps, 1))
        if run.name in KB_GROUPED and groups < 2:
            raise AssertionError(f"{run.name}: {groups} step group at "
                                 f"b={b}")
        run.plain(arrays)                  # warm-up: library handles
        torch.cuda.synchronize()
        want = [None]
        pms = cuda_ms(lambda: want.__setitem__(0, run.plain(arrays)), torch)
        r = kb_check(torch, run.name, got, want[0])
        r["groups"] = groups
        if timed:
            r["plain_ms"] = pms
        again = run.fn(arrays)
        r["rerun_equal"] = all(torch.equal(x, y) for x, y in zip(
            list(got[0]) + list(got[1]), list(again[0]) + list(again[1])))
        out[run.name] = r
        for k in extra:
            del arrays[k]
        del got, want, again
        torch.cuda.empty_cache()
    return out


# small kernels that open each traced session of kb_profile
KB_WARMUP = 32


def kb_profile(torch, run, arrays, tries: int = 10, name=None) -> None:
    """One call of ``run`` at the tool's defaults under torch.profiler: the
    device ms and kernel count of each of KB_PASSES, and the busy ms.  The
    profiler may drop a session's first kernels, so each session opens
    with KB_WARMUP small kernels of its own and counts only what the call
    launched (its ``kb_run`` label); a trace with fewer of those kernels
    than launches is taken again, up to ``tries`` times; the line says
    whether the last one was complete."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmpdir:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pad = torch.zeros(1, device=DEVICE)
                for _ in range(KB_WARMUP):
                    pad.add_(1)
                torch.cuda.synchronize()
                with record_function("kb_run"):
                    run.fn(arrays)
                torch.cuda.synchronize()
            events = _trace_events(prof, tmpdir, "kernel_bench.json")
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "kb_run"]
        ids = _label_ids(events, "kb_run") if len(spans) == 1 else set()
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and e["args"].get("correlation") in ids]
        launched = sum(1 for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and e.get("name", "").startswith(
                           ("cudaLaunchKernel", "cuLaunchKernel"))
                       and e["args"].get("correlation") in ids)
        if kernels and len(kernels) >= launched:
            break
    if not kernels:
        raise AssertionError("the profiler saw no kernel")
    fields = {}
    for label, key in KB_PASSES.items():
        ks = [e["dur"] for e in kernels if key in e["name"]]
        if ks:
            fields[f"{label}_ms"] = f"{sum(ks) / 1e3:.3f}"
            fields[f"{label}_n"] = len(ks)
    log("kernel_bench_profile", run=name or run.name,
        busy_ms=f"{_busy_us(kernels) / 1e3:.3f}", kernels=len(kernels),
        launches=launched, complete=len(kernels) >= launched, tries=attempt,
        **fields)


class _int8_run_on:
    """A T1 run built and called under ``on_int8_passes(passes)``, so that
    its K4/K5 calls take those passes whatever the table says (the tool
    binds some wrappers when it builds its runs, looks others up when it
    calls them): each side of the A/B of the two designs."""

    def __init__(self, run, passes):
        self.run, self.name, self.passes = run, run.name, passes

    def fn(self, arrays):
        with on_int8_passes(self.passes):
            return self.run.fn(arrays)


def phase_kernel_bench(torch) -> list:
    """``[kernel_bench]``: the tool's entry point at its defaults (B=2,048,
    HW=4,096, H=500, pt=2,048; the main path, launches counted from 0
    around it), every run against its plain version at KB_B images (0 words
    may differ in the integer outputs and sums; the float ones within
    KB_CHECKS' limits; two calls bit for bit), then every run's kernel ms at
    the defaults (median of KB_TIMED), bound and, for the GEMM runs, the
    library's ms (``torch._int_mm`` per step from a CUDA graph); the
    KB_PROFILED runs' passes from one traced call each.  The T1 rows'
    plain ms are the plain versions' at KB_B images (the main path's
    B=2,048 does not fit them).  Returns the kernels line's T1 rows."""
    from spatialvae_torch.tools import kernel_bench as tool

    if KB_I8_ROUTE["fwd"]() != "block":
        raise AssertionError("T1's K4 calls left the block passes: "
                             "KB_K4_KEY and T1.8's row count them there")
    t0 = time.perf_counter()
    _kb_reset()
    rc = tool.main(KB_MAIN_ARGV)
    torch.cuda.synchronize()
    launches = _kb_launches()
    if rc != 0:
        raise AssertionError(f"kernel_bench: exit {rc}")
    t_main = time.perf_counter() - t0
    readings = kb_readings(torch, KB_B, timed=True)
    arrays = tool.make_arrays(tool.B, tool.HW, KB_PT, DEVICE)
    rows, by_run = [], {}
    with on_block_passes():                  # fused-loss on the block passes
        loss7 = {r.name: r for r in tool.runs(tool.B, tool.HW,
                                              KB_PT)}["fused-loss"]
    i8_on = {}                               # K4/K5 on each design
    for passes in ("block", "sm90"):
        with on_int8_passes(passes):
            i8_on[passes] = {r.name: _int8_run_on(r, passes)
                             for r in tool.runs(tool.B, tool.HW, KB_PT)
                             if r.name in KB_I8_RUNS}
    for run in tool.runs(tool.B, tool.HW, KB_PT):
        extra = run.prepare(arrays) if run.prepare else {}
        arrays.update(extra)
        run.fn(arrays)
        ab, blk_ms = {}, None
        if run.name in KB_I8_RUNS:
            # K4/K5 on the cluster passes in turns with the block passes;
            # the run's ms is the table's route's (T1's weights are f32: K4
            # alone takes the block passes)
            on = {p: i8_on[p][run.name] for p in ("block", "sm90")}
            ab = in_turns(torch, {p: functools.partial(r.fn, arrays)
                                  for p, r in on.items()}, KB_TIMED, AB_I8)
            route = KB_I8_ROUTE[run.name]()
            ms, blk_ms = ab[route][0], ab["block"][0]
            if run.name in KB_PROFILED:
                kb_profile(torch, on["block"], arrays,
                           name=run.name + "_block")
            ab = {"route": route, "sm90_ms": f"{ab['sm90'][0]:.4f}",
                  "block_ms": f"{ab['block'][0]:.4f}",
                  "turns": " ".join(f"{k}:{t:.4f}" for k in ("block", "sm90")
                                    for t in ab[k][1])}
        elif run.name == "fused-loss":
            # the cluster passes in turns with the block passes
            ab = in_turns(torch, {"sm90": lambda: run.fn(arrays),
                                  "block": lambda: loss7.fn(arrays)}, KB_TIMED)
            ms = ab["sm90"][0]
            kb_profile(torch, loss7, arrays, name="fused-loss_block")
            ab = {"block_ms": f"{ab['block'][0]:.4f}",
                  "turns": " ".join(f"{k}:{t:.4f}" for k in ("block", "sm90")
                                    for t in ab[k][1])}
        else:
            ms = statistics.median([cuda_ms(lambda: run.fn(arrays), torch)
                                    for _ in range(KB_TIMED)])
        lib = (graph_ms(torch, run.library(arrays), run.steps)
               if run.library else None)
        bd = bound(run.nbytes, (run.int8_ops, PEAK_INT8),
                   (run.f32_ops, PEAK_FP32))
        r = readings[run.name]
        if not r["rerun_equal"]:
            raise AssertionError(f"{run.name}: two calls differ")
        by_run[run.name] = (ms, bd, lib, r, blk_ms)
        if run.name in KB_PROFILED:
            kb_profile(torch, i8_on["sm90"][run.name]
                       if run.name in KB_I8_RUNS else run, arrays)
        log("kernel_bench", run=run.name, ms=f"{ms:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}", plain_b=KB_B,
            plain_groups=r["groups"],
            bound_ms=f"{bd[0]:.4f}", bound_by=bd[1],
            library_ms="-" if lib is None else f"{lib:.4f}",
            words_differ=r["differ"], max_abs_err=f"{r['err']:.3e}",
            **r["fields"], **ab)
        for k in extra:
            del arrays[k]
        torch.cuda.empty_cache()
    del arrays
    torch.cuda.empty_cache()
    for row, name, line, key in KB_ROWS:
        ms, bd, lib, r, _ = by_run[name]
        nl = launches.get(key, 0)
        log("kernel_bench_row", row=row, run=name, launches=nl)
        src = KB_SOURCES.get(name, KB_CHAIN_SOURCE)
        rows.append((f"kernel_bench:{row} {name}", src,
                     f"tools/kernel_bench.py:{line}", nl, r["err"], ms,
                     r["plain_ms"], bd, lib))
    log("kernel_bench", package_runs=",".join(KB_PACKAGE_RUNS),
        k4_launches=launches.get(("d8", KB_K4_KEY), 0),
        k5_launches=launches.get(("d8", "bwd_grad_sm90"), 0),
        k3_launches=launches.get(("l8", "grad_sm90"), 0),
        k8_launches=launches.get(("lt", "grad"), 0),
        main_seconds=f"{t_main:.1f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    for key in (("d8", KB_K4_KEY), ("d8", "bwd_grad_sm90"),
                ("l8", "grad_sm90"), ("lt", "grad")):
        if launches.get(key, 0) < 1:
            raise AssertionError(f"kernel_bench: {key} not launched")
    return rows


def phase_limits_kernel_bench(torch) -> None:
    """``--limits kernel_bench``: every T1 run at KB_B images through the
    sound library and three faulty copies, built together: the a1 scale
    without its /127 (gemm1+vpu, fwd-pipe), fused-plain's scale per 64-pixel
    block instead of per step, bwd-fixscale's dh1 without (1 - a1^2).
    Prints each build's readings per run (errors past a limit printed, not
    raised); the sound build must pass every run and each copy must fail
    one."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import kernel_bench as kb

    with ThreadPoolExecutor(len(KB_FAULTS)) as ex:
        list(ex.map(_build.build, [d for _, d in KB_FAULTS]))
    from spatialvae_torch.tools import kernel_bench as tool

    arrays = tool.make_arrays(KB_B, tool.HW, KB_PT, DEVICE)
    runs = tool.runs(KB_B, tool.HW, KB_PT)
    for run in runs:
        if run.prepare:
            arrays.update(run.prepare(arrays))
    want = {r.name: r.plain(arrays) for r in runs}
    for label, defines in KB_FAULTS:
        lib = _build.load_library(defines)
        kb._lib = (lambda lib=lib: lib)
        failed = []
        for run in runs:
            got = run.fn(arrays)
            torch.cuda.synchronize()
            try:
                r = kb_check(torch, run.name, got, want[run.name])
                fields = r["fields"]
            except AssertionError as e:
                failed.append(run.name)
                fields = {"refused": str(e)[:300].replace(" ", "_")}
            log("limits_kernel_bench", build=label, run=run.name, **fields)
        log("limits_kernel_bench", build=label, refused=len(failed),
            runs=",".join(failed) or "-")
        if label == "sound" and failed:
            raise AssertionError(f"the sound build fails {failed}")
        if label != "sound" and not failed:
            raise AssertionError(f"the copy with {label} passes every run")
    kb._lib = (lambda: _build.load_library())


# K1-K5 at the default width, timed in turns in two checkouts (this one
# and the parent's), each through its own build: (name, one call)
AB_TURNS = ("parent", "this", "this", "parent", "parent", "this")


def default_width_times() -> dict:
    """K1-K5's device ms at the galaxy shape (H = 500, B = 100; K5 at the
    tail's B = 37) through the wrappers of the checkout in the working
    directory: the calls both the parent's and this tree's port take."""
    import torch

    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels import fused_decoder_int8 as d8
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.precision import pin_fp32_precision

    pin_fp32_precision()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    hw = IMAGE[0] * IMAGE[1]
    out = {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            fold, coords, *ws = _tail_inputs(torch, BATCH, hw, 500, 1,
                                             CHANNELS, getattr(torch, dtype),
                                             gen)
            tw = fd.TailWeights(*ws)
            g = torch.randn((BATCH, CHANNELS, hw), generator=gen,
                            device=DEVICE)
            y, acts = fd.run_decoder_tail_acts(fold, coords, tw)
            calls = {
                f"k1_{dtype}": lambda: fd.run_decoder_tail(fold, coords, tw),
                f"k1_acts_{dtype}": lambda: fd.run_decoder_tail_acts(
                    fold, coords, tw),
                f"k2_{dtype}": lambda: fd.run_decoder_tail_backward(
                    fold, coords, tw, acts, y, g)}
            for name, fn in calls.items():
                fn()
                out[name] = statistics.median(
                    [cuda_ms(fn, torch) for _ in range(N_TIMED)])
        fold, coords, ws = _int8_inputs(torch, BATCH, "bfloat16", gen, h=500)
        k = torch.randint(0, 256, (BATCH, CHANNELS, hw), generator=gen,
                          device=DEVICE)
        yt = (k - 128).to(torch.int8)
        w = d8.Int8Weights(*ws)
        tb = N_TRAIN % BATCH
        y37, a1 = d8.run_int8_tail(fold[:tb], coords, w, emit_a1=True)
        g37 = torch.randn((tb, CHANNELS, hw), generator=gen, device=DEVICE)
        calls = {
            "k3_bf16": lambda: l8.run_loss_int8(fold, coords, *ws, yt),
            "k4_bf16": lambda: d8.run_int8_tail(fold, coords, w),
            "k5_bf16_b37": lambda: d8.run_int8_tail_backward(
                fold[:tb], coords, w, a1, y37, g37)}
        for name, fn in calls.items():
            fn()
            out[name] = statistics.median(
                [cuda_ms(fn, torch) for _ in range(N_TIMED)])
    return out


# the translation units whose code stays as it was with every test-build
# switch at 0: K1/K2's tile kernels and their default-shape cluster kernels
# (the deep kernels have a unit of their own), K4/K5's block passes (and
# T1's K5 modes) and their H <= 512 cluster passes (the wide ones have a
# unit of their own, fused_decoder_int8_sm90_wide.cu), K3's block, lever
# and wide instantiations and its cluster passes, default, SR and wide
# (whose headers carry the dh0 copies' switches)
SASS_UNITS = ("fused_decoder_fwd.cu", "fused_decoder_bwd.cu",
              "fused_decoder_sm90.cu",
              "fused_decoder_int8.cu", "kernel_bench_bwd.cu",
              "fused_loss_int8.cu", "fused_loss_int8_levers.cu",
              "fused_loss_int8_wide.cu", "fused_loss_int8_sm90.cu",
              "fused_loss_int8_sm90_sr.cu", "fused_loss_int8_sm90_wide.cu",
              "fused_decoder_int8_sm90.cu")


# the cases of ``--limits dec90``: galaxy f32 and bf16, a residual add, at
# a batch that keeps the plain versions quick; then the deep kernels: two
# column chunks (H = 1,000, and a ragged 1,030) and three hidden layers
DEC90_LIMIT_CASES = [
    ("galaxy_f32", 8, 4096, 500, 1, 3, False, "float32"),
    ("galaxy_bf16", 8, 4096, 500, 1, 3, False, "bfloat16"),
    ("resid_f32", 8, 4096, 500, 1, 3, True, "float32"),
    ("hw784_no8_bf16", 8, 784, 500, 1, 8, True, "bfloat16"),
    ("h1000_f32", 4, 4096, 1000, 1, 3, False, "float32"),
    ("h1030_bf16_resid", 4, 784, 1030, 1, 3, True, "bfloat16"),
    ("lh3_f32_resid", 4, 4096, 500, 3, 3, True, "float32"),
    ("lh3_h600_no8_bf16", 4, 784, 600, 3, 8, False, "bfloat16"),
]
# the sound build and copies with one step removed, each built from the
# decoder's sources alone (DEC90_UNITS); the limits must hold the first and
# refuse every other
DEC90_FAULTS = (
    ("sound", ()),
    ("one TF32 product", ("-DSVT_TF32_SPLIT=0",)),
    ("no bf16 casts outside the products", ("-DSVT_BF16_CASTS=0",)),
    ("the head's partials of a tile's last chunk dropped",
     ("-DSVT_DEEP_DROP_HEAD=1",)),
    ("layers above the first read a stale A buffer",
     ("-DSVT_DEEP_STALE_A=1",)),
    ("one TF32 product in the deep passes", ("-DSVT_DEEP_ONE_PASS=1",)),
)
DEC90_UNITS = ("fused_decoder_fwd.cu", "fused_decoder_bwd.cu",
               "fused_decoder_sm90.cu", "fused_decoder_sm90_deep.cu")


def phase_limits_dec90(torch) -> None:
    """``--limits dec90``: K1/K2's sm90 kernels (both sources) against their
    plain versions for the sound library and each faulty copy of
    DEC90_FAULTS, over three seeds at DEC90_LIMIT_CASES: y and the
    activations (max/mean absolute), each backward variant's worst
    gradient (max/mean relative to max|plain|), and whether every reading
    stays within TOL, ACTS_TOL and BWD_TOL.  The sound build must, and
    every faulty copy must not."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import fused_decoder as fd

    with ThreadPoolExecutor(len(DEC90_FAULTS)) as ex:
        list(ex.map(lambda f: _build.build(f[1], DEC90_UNITS), DEC90_FAULTS))
    for build, defines in DEC90_FAULTS:
        lib = _build.load_library(defines, DEC90_UNITS)
        fd._lib = (lambda lib=lib: lib)
        worst, within = {}, True
        for seed in range(3):
            for case in DEC90_LIMIT_CASES:
                r = backward_case(torch, case, seed, False, rerun=False)
                if r["route"] != "sm90":
                    raise AssertionError(f"{case[0]} took {r['route']}")
                name, dtype = case[0], case[-1]
                for k, tol in (("y", TOL), ("acts", ACTS_TOL)):
                    worst[name, k] = _wmax(worst.get((name, k), (0, 0)),
                                           r[k][:2])
                    within &= r[k][0] <= tol[dtype][0] and \
                        r[k][1] <= tol[dtype][1]
                for v in ("residual", "recompute"):
                    tol = BWD_TOL[dtype, v]
                    for gname in GRADS:
                        worst[name, v] = _wmax(worst.get((name, v), (0, 0)),
                                               r[v, gname][2:])
                        within &= r[v, gname][2] <= tol[0] and \
                            r[v, gname][3] <= tol[1]
            torch.cuda.empty_cache()
        log("limits_dec90", build=build, defines=" ".join(defines) or "-",
            **{"/".join(k): f"{a:.3e}/{m:.3e}"
               for k, (a, m) in sorted(worst.items())},
            within_limits=within)
        if within != (build == "sound"):
            raise AssertionError(f"--limits dec90: the {build} build "
                                 f"{'is' if within else 'is not'} within "
                                 f"the limits")
    fd._lib = (lambda: _build.load_library())


# `--limits int8_90`: the sound build and copies with one step of the
# cluster passes broken, built together: (name, switches, units) - a whole
# library, or (past 512) the wide unit alone, whose svt_int8_90w_* entry
# points stand in for the library's
I8_90_WIDE_UNITS = ("fused_decoder_int8_sm90_wide.cu",)
I8_90_FAULTS = (
    ("sound", (), None),
    ("K5 scale per 64-pixel block", ("-DSVT_INT8_BLOCK_SCALE=1",), None),
    ("one multicast quarter from the wrong slab",
     ("-DSVT_I8_90_WRONG_QUARTER=1",), None),
    ("a1 emitted without its bf16 rounding", ("-DSVT_I8_90_A1_RTZ=1",),
     None),
    ("the last chunk's head partial dropped", ("-DSVT_I8W_DROP_HEAD=1",),
     I8_90_WIDE_UNITS),
    ("the K-major dh1q copy read one block off", ("-DSVT_I8W_QK_OFF=1",),
     I8_90_WIDE_UNITS),
    ("dh0 from a0q/127, not the f32 a0", ("-DSVT_I8W_DH0_AQ=1",),
     I8_90_WIDE_UNITS),
)
# its wide readings: (H, weight dtype, B) on the wide cluster passes, two
# whole chunks and three with the last ragged
I8_90_WIDE_CASES = [(WIDE_H, "bfloat16", 8), (1030, "float32", 8)]


def phase_limits_int8_90(torch) -> None:
    """``--limits int8_90``: K4 and K5 on the cluster passes against their
    plain versions, at INT8_TAIL_CASES (B=100 and the odd tail, f32 and
    bf16, both K5 variants) and past 512 at I8_90_WIDE_CASES (the wide
    unit, "wide_*"), for the sound library and for each copy of
    I8_90_FAULTS: y and a1 by absolute error (max/mean), each K5 variant's
    worst output by error relative to max|plain| (max/mean), past 512 also
    K5's worst against the block passes ("wide_vs_block", relative to
    max|block|), and whether they stay within INT8_Y_TOL, INT8_A1_TOL,
    INT8_TOL and K45W_BLOCK_TOL.  The sound build must, and every faulty
    copy must not."""
    from concurrent.futures import ThreadPoolExecutor

    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    with ThreadPoolExecutor(len(I8_90_FAULTS)) as ex:
        list(ex.map(lambda f: _build.build(f[1], f[2]), I8_90_FAULTS))
    sound = _build.load_library()
    for build, defines, units in I8_90_FAULTS:
        lib = (_build.load_library(defines) if units is None else
               _with_timing_copy(sound, _build.load_library(defines, units),
                                 "svt_int8_90w_"))
        d8._lib = (lambda lib=lib: lib)
        worst = {}
        cases = [(b, dtype, P_HIDDEN, "") for b, dtype in INT8_TAIL_CASES]
        cases += [(b, dtype, h, "wide_") for h, dtype, b in I8_90_WIDE_CASES]
        for b, dtype, h, kind in cases:
            with sized(h, b):
                r = int8_tail_case(torch, b, dtype, SEED, timed=False)
            for k in ("y", "y_no_a1", "a1"):
                worst[kind + k] = _wmax(worst.get(kind + k, (0, 0)),
                                        r[k][:2])
            for v in ("residual", "recompute"):
                for n in INT8_GRADS:
                    worst[kind + v] = _wmax(worst.get(kind + v, (0, 0)),
                                            r[v, n][2:])
                    if kind:
                        worst["wide_vs_block"] = _wmax(
                            worst.get("wide_vs_block", (0, 0)),
                            r["vs_block"][v, n][2:])
            torch.cuda.empty_cache()
        within = all(worst[kind + k][0] <= tol[0]
                     and worst[kind + k][1] <= tol[1]
                     for k, tol in (("y", INT8_Y_TOL), ("y_no_a1", INT8_Y_TOL),
                                    ("a1", INT8_A1_TOL),
                                    ("residual", INT8_TOL),
                                    ("recompute", INT8_TOL))
                     for kind in ("", "wide_"))
        within &= all(a <= t for a, t in zip(worst["wide_vs_block"],
                                             K45W_BLOCK_TOL))
        log("limits_int8_90", build=build, defines=" ".join(defines) or "-",
            **{k: f"{a:.3e}/{m:.3e}" for k, (a, m) in worst.items()},
            within_limits=within)
        if within != (build == "sound"):
            raise AssertionError(f"--limits int8_90: the {build} build "
                                 f"{'is' if within else 'is not'} within "
                                 f"the limits: {worst}")
    d8._lib = (lambda: _build.load_library())


def phase_split_dec90(torch) -> None:
    """``--split dec90``: each sm90 kernel's device ms (one traced call) in
    the sound build and in a copy whose tiles end after the product
    (-DSVT_DEC90_CUT=1: the product with the A slabs built beside it, no
    epilogue), in turns (sound, cut, cut, sound), at B=100 and three
    shapes, galaxy (H = 500, one hidden layer), H = WIDE_H (the deep
    kernels' two column chunks) and DEEP_LAYERS - 1 hidden layers (their
    layer passes): the forward (f32 and bf16, without and with
    activations), the chain and dW of the residual backward.  The
    epilogue's share is the difference."""
    from spatialvae_torch.kernels import _build
    from spatialvae_torch.kernels import fused_decoder as fd

    libs = {"sound": _build.load_library(),
            "cut": _build.load_library(("-DSVT_DEC90_CUT=1",))}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    hw = IMAGE[0] * IMAGE[1]
    for (h, lh), dtype in itertools.product(
            ((P_HIDDEN, 1), (WIDE_H, 1), (P_HIDDEN, DEEP_LAYERS - 1)),
            (torch.float32, torch.bfloat16)):
        fold, coords, *ws = _tail_inputs(torch, BATCH, hw, h, lh,
                                         CHANNELS, dtype, gen)
        tw = fd.TailWeights(*ws)
        g = torch.randn((BATCH, CHANNELS, hw), generator=gen, device=DEVICE)
        with torch.no_grad():
            fd._lib = (lambda: libs["sound"])
            y, acts = fd.run_decoder_tail_acts(fold, coords, tw)
            calls = {
                "fwd": lambda: fd.run_decoder_tail(fold, coords, tw),
                "fwd_acts": lambda: fd.run_decoder_tail_acts(fold, coords,
                                                             tw),
                "bwd": lambda: fd.run_decoder_tail_backward(
                    fold, coords, tw, acts, y, g)}
            ms = {}
            for build in ("sound", "cut", "cut", "sound"):
                fd._lib = (lambda lib=libs[build]: lib)
                for what, fn in calls.items():
                    for k, v in kernel_device_ms(
                            torch, fn, ("dec_fwd90", "dec_chain90",
                                        "dec_dw90", "dec_layer90",
                                        "dec_chainl90",
                                        "dec_dww90")).items():
                        if v:
                            ms.setdefault((what, k, build), []).append(v)
        fd._lib = (lambda: libs["sound"])
        for (what, k, build), v in sorted(ms.items()):
            if build != "sound":
                continue
            cut = ms[what, k, "cut"]
            epi = statistics.median(v) - statistics.median(cut)
            log("split_dec90", H=h, Lh=lh, dtype=str(dtype)[6:], call=what,
                kernel=k,
                sound_ms="/".join(f"{x:.4f}" for x in v),
                cut_ms="/".join(f"{x:.4f}" for x in cut),
                epilogue_ms=f"{epi:.4f}")
        del fold, coords, ws, tw, g, y, acts
        torch.cuda.empty_cache()
    fd._lib = (lambda: _build.load_library())


# `--sweep dec90`: the widths at which K1/K2's two designs are timed in
# turns to place fused_decoder.DEEP_MIN_WIDTH
SWEEP_WIDTHS = (32, 128, 256, 288, 320, 384, 448, 500, 513, 768, 1024, 2048)


def phase_sweep_dec90(torch) -> None:
    """``--sweep dec90``: K1, K1 with activations and K2 (with the
    residual) on the sm90 kernels and on the tile kernels in turns (AB_DEC,
    5 runs a turn) at every width of SWEEP_WIDTHS with Lh = 1..4 hidden
    layers but the single-pass shapes, f32 and bf16 weights, B=100 (25
    above 1,024), HW = 4,096: each call's sm90 and tile ms and their
    ratio.  The route table's DEEP_MIN_WIDTH is lifted while it runs, so
    the deep kernels are timed below it too: its thresholds are the first
    widths at which every call's ratio is below 1."""
    from spatialvae_torch.kernels import fused_decoder as fd

    saved = dict(fd.DEEP_MIN_WIDTH)
    fd.DEEP_MIN_WIDTH.update(dict.fromkeys(saved, 1))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    hw = IMAGE[0] * IMAGE[1]
    try:
        for h, lh in itertools.product(
                SWEEP_WIDTHS, range(1, fd.MAX_HIDDEN_LAYERS + 1)):
            if fd.single_pass(h, lh):
                continue
            b = 25 if h > 1024 else BATCH
            for dtype in (torch.float32, torch.bfloat16):
                fold, coords, *ws = _tail_inputs(torch, b, hw, h, lh,
                                                 CHANNELS, dtype, gen)
                tw = fd.TailWeights(*ws)
                g = torch.randn((b, CHANNELS, hw), generator=gen,
                                device=DEVICE)
                fields = {}
                with torch.no_grad():
                    y, acts = fd.run_decoder_tail_acts(fold, coords, tw)
                    calls = {
                        "k1": functools.partial(fd.run_decoder_tail, fold,
                                                coords, tw),
                        "k1_acts": functools.partial(fd.run_decoder_tail_acts,
                                                     fold, coords, tw),
                        "k2": functools.partial(fd.run_decoder_tail_backward,
                                                fold, coords, tw, acts, y,
                                                g)}
                    for name, fn in calls.items():
                        t = in_turns(torch, {
                            r: functools.partial(fn, tile_kernels=r == "tile")
                            for r in ("tile", "sm90")}, 5, AB_DEC)
                        fields[f"{name}_ms"] = (f"{t['sm90'][0]:.4f}/"
                                                f"{t['tile'][0]:.4f}")
                        fields[f"{name}_ratio"] = (
                            f"{t['sm90'][0] / t['tile'][0]:.3f}")
                log("sweep_dec90", H=h, Lh=lh, B=b, dtype=str(dtype)[6:],
                    times="sm90/tile", **fields)
                del fold, coords, ws, tw, g, y, acts
                torch.cuda.empty_cache()
    finally:
        fd.DEEP_MIN_WIDTH.update(saved)


# --sweep k3's widths: both sides of a chunk boundary (513 and 1,030 end on
# a ragged 64-column chunk, computed whole), the slice's 1,000, and wider
K3_SWEEP_WIDTHS = (513, 640, 768, 1000, 1030, 1536, 2048, 4100)


def phase_sweep_k3(torch) -> None:
    """``--sweep k3``: K3 at the default numerics on the cluster passes and
    on the block passes in turns (AB_K3, 3 runs a turn) at every width of
    K3_SWEEP_WIDTHS past 512, the galaxy shape (int8 targets, no mask),
    bf16 and f32 weights, B=100 (24 above 2,048): each call's cluster and
    block ms, their ratio and the bound; ``k3_route`` sends every one of
    these calls to the cluster passes, so a ratio above 1 is a width the
    table should keep on the block passes."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    hw = IMAGE[0] * IMAGE[1]
    for h in K3_SWEEP_WIDTHS:
        b = 24 if h > 2048 else BATCH     # K3 takes image pairs
        for dtype in ("bfloat16", "float32"):
            with sized(h, b):
                gen = torch.Generator(device=DEVICE).manual_seed(SEED)
                fold, coords, ws = _int8_inputs(torch, b, dtype, gen)
                k = torch.randint(0, 256, (b, CHANNELS, hw), generator=gen,
                                  device=DEVICE)
                run = functools.partial(
                    l8.run_loss_int8, fold, coords, *ws,
                    (k - 128).to(torch.int8), None, "bernoulli")
                route = l8.k3_route(hw, h, l8.pick_tile(hw), "bernoulli",
                                    l8.DEFAULTS)
                with torch.no_grad():
                    t = in_turns(torch, {"sm90": run, "block":
                                         functools.partial(
                                             run, block_passes=True)}, 3)
                bd = k3_bound(b, hw, h, CHANNELS,
                              2 if dtype == "bfloat16" else 4, 1, False,
                              False)
                log("sweep_k3", H=h, B=b, dtype=dtype, route=route,
                    times="sm90/block",
                    ms=f"{t['sm90'][0]:.4f}/{t['block'][0]:.4f}",
                    ratio=f"{t['sm90'][0] / t['block'][0]:.3f}",
                    bound_ms=f"{bd[0]:.4f}",
                    share=f"{bd[0] / t['sm90'][0]:.3f}")
                del fold, coords, ws, k, run
                torch.cuda.empty_cache()


# --sweep k45's widths: K3's sweep's
K45_SWEEP_WIDTHS = K3_SWEEP_WIDTHS


def phase_sweep_k45(torch) -> None:
    """``--sweep k45``: K4 (without and with a1) and K5 (both variants) on
    the wide cluster passes and on the block passes in turns (AB_I8, 3 runs
    a turn) at every width of K45_SWEEP_WIDTHS, the galaxy shape, bf16 and
    f32 weights, B=100 (24 above 2,048): each call's cluster and block ms
    and their ratio; ``int8_route`` sends every one of these calls to the
    cluster passes, so a ratio above 1 is a width the table should keep on
    the block passes."""
    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    hw = IMAGE[0] * IMAGE[1]
    for h in K45_SWEEP_WIDTHS:
        b = 24 if h > 2048 else BATCH
        for dtype in ("bfloat16", "float32"):
            with sized(h, b):
                gen = torch.Generator(device=DEVICE).manual_seed(SEED)
                fold, coords, ws = _int8_inputs(torch, b, dtype, gen)
                w = d8.Int8Weights(*ws)
                g = torch.randn((b, CHANNELS, hw), generator=gen,
                                device=DEVICE)
                with torch.no_grad():
                    y, a1 = d8.run_int8_tail(fold, coords, w, True)
                    calls = {
                        "k4": functools.partial(d8.run_int8_tail, fold,
                                                coords, w),
                        "k4_a1": functools.partial(d8.run_int8_tail, fold,
                                                   coords, w, True),
                        "k5_residual": functools.partial(
                            d8.run_int8_tail_backward, fold, coords, w, a1,
                            y, g),
                        "k5_recompute": functools.partial(
                            d8.run_int8_tail_backward, fold, coords, w,
                            None, y, g)}
                    fields = {}
                    for name, run in calls.items():
                        t = in_turns(torch, {p: functools.partial(
                            run, passes=p) for p in ("sm90", "block")}, 3,
                            AB_I8)
                        fields[name] = (f"{t['sm90'][0]:.4f}/"
                                        f"{t['block'][0]:.4f}")
                        fields[name + "_ratio"] = (
                            f"{t['sm90'][0] / t['block'][0]:.3f}")
                route = {"k4": d8.int8_route(hw, h, k4_alone_f32=(
                    dtype == "float32")), "k4_a1/k5": d8.int8_route(hw, h)}
                log("sweep_k45", H=h, B=b, dtype=dtype,
                    route=json.dumps(route, separators=(",", ":")),
                    times="sm90/block", **fields)
                del fold, coords, ws, w, g, y, a1, calls
                torch.cuda.empty_cache()


def phase_sass(args) -> int:
    """``--sass PARENT``: SASS_UNITS compiled from this checkout and from
    the parent's (a directory holding its files) with the library's flags,
    compared function by function (the anonymous namespace's mangled name,
    which carries a hash of the file's path, set aside): ``equal`` by name
    and code, ``same_code`` the parent's functions whose code this unit
    holds under any name (a parameter added renames a kernel)."""
    import re

    from spatialvae_torch.kernels import _build

    if len(args) != 1 or not os.path.isdir(args[0]):
        print("usage: chip_smoke.py --sass PARENT_DIR", file=sys.stderr)
        return 2
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    anon = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
    trees = {"parent": os.path.join(os.path.abspath(args[0]),
                                    "spatialvae_torch", "kernels", "csrc"),
             "this": str(_build.CSRC)}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for tree, d in trees.items():
            for unit in SASS_UNITS:
                o = os.path.join(tmp, f"{tree}_{unit}.o")
                procs.append((o, subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-c", "-o", o,
                     os.path.join(d, unit)], stderr=subprocess.PIPE,
                    text=True)))
        for o, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {o}:\n{err[-3000:]}")

        def functions(o):
            text = anon.sub("ANON", subprocess.run(
                [cuobjdump, "-sass", o], capture_output=True,
                text=True).stdout)
            funcs = {}
            for part in text.split("Function : ")[1:]:
                name, _, body = part.partition("\n")
                funcs[name.strip()] = body
            return funcs

        differ = 0
        for unit in SASS_UNITS:
            a = functions(os.path.join(tmp, f"parent_{unit}.o"))
            b = functions(os.path.join(tmp, f"this_{unit}.o"))
            equal = sum(1 for k in a if b.get(k) == a[k])
            differ += len(a) + len(b) - 2 * equal
            # a changed signature renames a function whose code stayed
            bodies = set(b.values())
            log("sass", unit=unit, parent_functions=len(a),
                this_functions=len(b), equal=equal,
                same_code=sum(1 for v in a.values() if v in bodies))
    return 1 if differ else 0


def phase_default_width_ab(args) -> int:
    """``--default-width PARENT``: K1-K5 at the default width in this
    checkout and in the parent's (a directory holding its files), in the
    turns of AB_TURNS, each turn a fresh process that builds (or loads) its
    own tree's kernels: every time of each turn, and the medians."""
    if len(args) != 1 or not os.path.isdir(args[0]):
        print("usage: chip_smoke.py --default-width PARENT_DIR",
              file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(args[0]),
             "this": os.path.dirname(os.path.abspath(__file__))}
    runs = {"parent": [], "this": []}
    for turn in AB_TURNS:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--default-width-times"], cwd=trees[turn], text=True,
            capture_output=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[turn].append(times)
        log("default_width_turn", tree=turn,
            **{k: f"{v:.4f}" for k, v in times.items()})
    for turn, rs in runs.items():
        log("default_width_ab", tree=turn, runs=len(rs),
            **{k: f"{statistics.median(r[k] for r in rs):.4f}"
               for k in rs[0]})
    return 0


# ---------------------------------------------------------------------------
# the particles CLI end to end: MRC stacks, CTF, augmentation, checkpoints
# and resume, through ``python -m spatialvae_torch.cli.train_particles``'s
# ``main`` at its full-width defaults
# ---------------------------------------------------------------------------

CLI_SIDE = 40           # BASELINE.json #3's 5HDB particles, 40x40
CLI_TRAIN = 8192
CLI_TEST = 1024
CLI_EPOCHS = 2
# the CLI's defaults: z=2, p and q 500 wide with 2 layers, B=100
CLI_BATCH = 100
CLI_HIDDEN = 500
# apply_ctf (FFT) against the grouped conv2d, both float64, relative to
# max|out|; the FFT's rounding sits near 1e-15
CTF_F64_TOL = 1e-9
# apply_ctf in float32 on the card against the float64 conv2d: the CPU
# test's limit against the JAX package
CTF_F32_TOL = 1e-5
ROTATE_TOL = 1e-5       # the card's bicubic rotation against its CPU result
CLI_HEADER = "Epoch\tSplit\tELBO\tError\tKL"


def particle_stack(n: int, rng) -> np.ndarray:
    """(n, 40, 40) float32 particles made with numpy: an anisotropic
    Gaussian blob of random centre, orientation, size and contrast, plus
    noise."""
    ax = np.linspace(-1, 1, CLI_SIDE, dtype=np.float32)
    yy, xx = np.meshgrid(-ax, ax, indexing="ij")

    def u():
        return rng.random((n, 1, 1), dtype=np.float32)

    cx, cy = 0.4 * u() - 0.2, 0.4 * u() - 0.2
    th = 2 * np.float32(math.pi) * u()
    sa, sb = 0.15 + 0.2 * u(), 0.06 + 0.1 * u()
    dx, dy = xx - cx, yy - cy
    r0 = np.cos(th) * dx + np.sin(th) * dy
    r1 = -np.sin(th) * dx + np.cos(th) * dy
    img = np.exp(-(r0 ** 2 / (2 * sa ** 2) + r1 ** 2 / (2 * sb ** 2)))
    img = img * (0.3 + 0.7 * u())
    img += 0.3 * rng.standard_normal(img.shape, dtype=np.float32)
    return img.astype(np.float32)


def ctf_table(n: int, rng) -> str:
    """A CTF table of n rows: defocus 1-3 um, Cs 2.7 mm, 300 kV, 4.2-4.4
    A/pixel (a 40x40 box of binned micrographs), B-factor 0-100, 10%
    amplitude contrast, a small dfdiff (read, not used) and the
    astigmatism angle."""
    cols = [rng.uniform(1.0, 3.0, n), np.full(n, 2.7), np.full(n, 300.0),
            rng.uniform(4.2, 4.4, n), rng.uniform(0.0, 100.0, n),
            np.full(n, 10.0), rng.uniform(-0.05, 0.05, n),
            rng.uniform(0.0, 360.0, n)]
    return "\n".join(" ".join(f"{v:.6f}" for v in row)
                     for row in zip(*cols)) + "\n"


class _StampedOut:
    """stdout of an in-process CLI run: the text and, per line, the time
    it was written."""

    def __init__(self):
        self.lines = []
        self._part = ""

    def write(self, text):
        self._part += text
        *done, self._part = self._part.split("\n")
        now = time.perf_counter()
        self.lines += [(now, ln) for ln in done]
        return len(text)

    def flush(self):
        pass


def cli_particles_data(tmpdir: str) -> dict:
    """The stacks and CTF tables of the phase, written from SEED."""
    from spatialvae_torch.io.mrc import write_mrc

    rng = np.random.default_rng(SEED + 40)
    paths = {}
    for split, n in (("train", CLI_TRAIN), ("test", CLI_TEST)):
        paths[split] = os.path.join(tmpdir, f"particles_{split}.mrc")
        with open(paths[split], "wb") as f:
            write_mrc(f, particle_stack(n, rng))
        paths[f"ctf_{split}"] = os.path.join(tmpdir, f"ctf_{split}.txt")
        with open(paths[f"ctf_{split}"], "w") as f:
            f.write(ctf_table(n, rng))
    return paths


def _launch_groups() -> dict:
    """The launches of the CLI's kernels, by kernel."""
    c = _int8_launches()
    return {"k1k2": c["k12"], "k3": sum(c["k3"].values()),
            "k4k5": sum(c["k45"].values()),
            "adam_step": c["adam"]["adam_step"], "k8": sum(c["k8"].values()),
            "detail": c}


# arm -> (extra argv, epochs, kernels that must launch, that must not)
CLI_ARMS = {
    "a_float": (["--mask", "--normalize", "--save-optimizer"], CLI_EPOCHS,
                ("k1k2", "adam_step"), ("k3", "k4k5", "k8")),
    "b_ctf_fit_noise": (["CTF", "--fit-noise", "--mask"], CLI_EPOCHS,
                        ("k1k2", "adam_step"), ("k3", "k4k5", "k8")),
    "c_ctf_int8": (["CTF", "--fit-noise", "--mask", "--int8-decoder"],
                   CLI_EPOCHS, ("k4k5", "adam_step"), ("k3", "k1k2", "k8")),
    "d_augment_int8": (["--augment-rotation", "--int8-decoder", "--mask"],
                       CLI_EPOCHS, ("k3", "k4k5", "adam_step"),
                       ("k1k2", "k8")),
    "e_resume": (["RESUME", "--mask", "--normalize"], 1,
                 ("k1k2", "adam_step"), ("k3", "k4k5", "k8")),
    # the vanilla generator with the fit-noise head: channel 0's double
    # softplus on the card; its products are cuBLAS's, Adam the step kernel
    "f_vanilla": (["--vanilla", "--fit-noise", "--softplus", "--mask"],
                  CLI_EPOCHS, ("adam_step",), ("k1k2", "k3", "k4k5", "k8")),
    # long runs: (a) and (d) streamed from the host (--no-preload); (c) with
    # bf16 Adam moments saved every epoch, and resumed from its epoch-1
    # files for epoch 2; (a) traced (--profile-dir) and checked
    # (--debug-nans)
    "g_stream": (["--mask", "--normalize", "--no-preload"], CLI_EPOCHS,
                 ("k1k2", "adam_step"), ("k3", "k4k5", "k8")),
    "h_stream_int8": (["--augment-rotation", "--int8-decoder", "--mask",
                       "--no-preload"], CLI_EPOCHS,
                      ("k3", "k4k5", "adam_step"), ("k1k2", "k8")),
    "i_bf16_moments": (["CTF", "--fit-noise", "--mask", "--int8-decoder",
                        "--adam-moments", "bf16", "--save-optimizer"],
                       CLI_EPOCHS, ("k4k5", "adam_step"),
                       ("k3", "k1k2", "k8")),
    "j_bf16_resume": (["RESUME:i_bf16_moments:1", "CTF", "--fit-noise",
                       "--mask", "--int8-decoder", "--adam-moments", "bf16"],
                      1, ("k4k5", "adam_step"), ("k3", "k1k2", "k8")),
    "k_profile": (["--mask", "--normalize", "PROFILE"], CLI_EPOCHS,
                  ("k1k2", "adam_step"), ("k3", "k4k5", "k8")),
    "l_debug_nans": (["--mask", "--normalize", "--debug-nans"], CLI_EPOCHS,
                     ("k1k2", "adam_step"), ("k3", "k4k5", "k8")),
    # (d) with stochastic rounding: K3's SR kernels on the cluster passes
    # (the padded Gaussian family, 1,600 pixels padded to 1,792)
    "m_int8_sr": (["--augment-rotation", "--int8-decoder", "--mask",
                   "--int8-sr"], CLI_EPOCHS, ("k3", "k4k5", "adam_step"),
                  ("k1k2", "k8")),
}
# arm -> (the arm it is set beside, whether it must repeat that arm's TSV
# rows in their epochs in common, relative to max|value|: the kernels run
# the same launches on the same data, and CLI_SAME_TOL only allows for a
# kernel that is not deterministic).  The streamed int8 arm is logged
# beside (d) alone: its steps quantise the encoder's input in the step
CLI_SAME = {"g_stream": ("a_float", True),
            "h_stream_int8": ("d_augment_int8", False),
            "j_bf16_resume": ("i_bf16_moments", True),
            "k_profile": ("a_float", True), "l_debug_nans": ("a_float", True)}
CLI_SAME_TOL = 1e-6
# kernels the traced arm's Chrome trace must name
CLI_TRACE_KERNELS = ("dec_fwd90", "dec_chain90", "dec_dw90",
                     "adam_step_kernel")


def cli_arm(torch, name: str, paths: dict, tmpdir: str, card: str) -> dict:
    """One CLI run: the launch counts from 0 just before it, the TSV, the
    checkpoints of every interval read back by ``SpatialVae.load``."""
    import contextlib
    import io

    from spatialvae_torch.api import SpatialVae
    from spatialvae_torch.cli import train_particles as tp

    extra, epochs, must, must_not = CLI_ARMS[name]
    prefix = os.path.join(tmpdir, f"cli_{name}")
    argv = [paths["train"], paths["test"], "--save-prefix", prefix,
            "--save-interval", "1", "--seed", str(SEED)]
    first = 1
    for a in extra:
        if a == "CTF":
            argv += ["--ctf-train", paths["ctf_train"], "--ctf-test",
                     paths["ctf_test"]]
        elif a.startswith("RESUME"):
            # RESUME: (a)'s last epoch; RESUME:arm:epoch that arm's files
            _, src, e = (a.split(":") if ":" in a
                         else (a, "a_float", CLI_EPOCHS))
            base = os.path.join(tmpdir, f"cli_{src}")
            argv += ["--resume-generator", f"{base}_generator_epoch{e}.sav",
                     "--resume-inference", f"{base}_inference_epoch{e}.sav",
                     "--resume-optimizer", f"{base}_optimizer_epoch{e}.sav"]
            first = int(e) + 1
        elif a == "PROFILE":
            argv += ["--profile-dir", os.path.join(tmpdir, "cli_profile")]
        else:
            argv.append(a)
    last = first + epochs - 1
    argv += ["--num-epochs", str(last)]
    out, err = _StampedOut(), io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), \
                recorded_adam_leaves() as adam:
            tp.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(err.getvalue(), file=sys.stderr)
        raise
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _launch_groups()
    adam_leaves_check(torch, "cli_kernels", name, adam.leaves)
    rows = [(t, ln) for t, ln in out.lines if "\t" in ln]
    if not rows or rows[0][1] != CLI_HEADER:
        raise AssertionError(f"{name}: TSV header {rows[:1]}")
    body = [ln.split("\t") for _, ln in rows[1:]]
    want = [[str(e), s] for e in range(first, last + 1)
            for s in ("train", "test")]
    if [r[:2] for r in body] != want or any(len(r) != 5 for r in body):
        raise AssertionError(f"{name}: TSV rows {body}, expected {want}")
    vals = np.array([[float(v) for v in r[2:]] for r in body])
    if not np.isfinite(vals).all():
        raise AssertionError(f"{name}: non-finite metrics {vals}")
    # an epoch's seconds: its training and evaluation, from the header (the
    # stacks loaded, the CTF kernels built, the data on the card) to its
    # test row
    stamps = [rows[0][0]] + [t for t, ln in rows[1:] if "\ttest\t" in ln]
    per_epoch = [b - a for a, b in zip(stamps, stamps[1:])]
    for k in must:
        if counts[k] < 1:
            raise AssertionError(f"{name}: {k} was not launched: {counts}")
    for k in must_not:
        if counts[k]:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times: "
                                 f"{counts}")
    # K3 runs the cluster passes in every arm, SR's included
    block = {k: v for k, v in counts["detail"]["k3"].items()
             if k in ("fwd", "grad", "dw") and v}
    if block:
        raise AssertionError(f"{name}: K3 on the block passes: {block}")
    likelihood = "colored" if "--fit-noise" in extra else "gaussian"
    for e in range(first, last + 1):
        gp, ip = f"{prefix}_generator_epoch{e}.sav", \
            f"{prefix}_inference_epoch{e}.sav"
        model = SpatialVae.load(gp, ip, device=DEVICE)
        if model.ecfg.likelihood != likelihood or \
                tuple(model.image_shape) != (CLI_SIDE, CLI_SIDE):
            raise AssertionError(f"{name}: checkpoint {gp}: {model.ecfg}")
        z_mu, _ = model.encode(torch.zeros((4, CLI_SIDE * CLI_SIDE),
                                           device=DEVICE))
        if not torch.isfinite(z_mu).all():
            raise AssertionError(f"{name}: {gp} encodes non-finite")
        if "--save-optimizer" in extra and not os.path.exists(
                f"{prefix}_optimizer_epoch{e}.sav"):
            raise AssertionError(f"{name}: no optimizer checkpoint {e}")
    extra_fields = {}
    if "PROFILE" in extra:
        extra_fields["trace_kernels"] = cli_trace_kernels(
            os.path.join(tmpdir, "cli_profile"))
    steps = epochs * math.ceil(CLI_TRAIN / CLI_BATCH)
    evals = epochs * math.ceil(CLI_TEST / CLI_BATCH)
    log("cli_particles", arm=name, card=repr(card), epochs=f"{first}-{last}",
        seconds=f"{seconds:.3f}", peak_mib=f"{peak / 2 ** 20:.1f}",
        s_per_epoch="/".join(f"{v:.3f}" for v in per_epoch), **extra_fields,
        train_steps=steps, eval_batches=evals,
        test_elbo="/".join(r[2] for r in body if r[1] == "test"),
        launches=json.dumps({k: v for k, v in counts.items()
                             if k != "detail"}, separators=(",", ":")),
        per_step=json.dumps({k: round(counts[k] / steps, 3)
                             for k in ("k1k2", "k3", "k4k5", "adam_step")},
                            separators=(",", ":")),
        detail=json.dumps(counts["detail"], separators=(",", ":")))
    return {"seconds": seconds, "per_epoch": per_epoch, "counts": counts,
            "peak": peak, "rows": {(r[0], r[1]): [float(v) for v in r[2:]]
                                   for r in body}}


def cli_trace_kernels(profile_dir: str) -> str:
    """The kernels of ``--profile-dir``'s Chrome trace: raise unless it
    names each of CLI_TRACE_KERNELS; returns each one's launches and device
    ms in the trace."""
    from spatialvae_torch.cli.common import trace_path

    with open(trace_path(profile_dir)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = {}
    for k in CLI_TRACE_KERNELS:
        ks = [e["dur"] for e in kernels if k in e["name"]]
        if not ks:
            raise AssertionError(f"--profile-dir: no {k} in the trace's "
                                 f"{len(kernels)} kernels")
        found[k] = f"{len(ks)}:{sum(ks) / 1e3:.3f}ms"
    return json.dumps(found, separators=(",", ":"))


def cli_same_rows(arms: dict) -> None:
    """Each CLI_SAME arm's TSV rows against its model arm's, in the epochs
    both ran, within CLI_SAME_TOL of max|value| where it must match; logs
    the largest difference, whether every row is equal bit for bit, and the
    peak device memory and seconds per epoch of both."""
    for name, (model, must) in CLI_SAME.items():
        got, want = arms[name]["rows"], arms[model]["rows"]
        keys = sorted(set(got) & set(want))
        if not keys:
            raise AssertionError(f"{name}: no epoch in common with {model}")
        g = np.array([got[k] for k in keys])
        w = np.array([want[k] for k in keys])
        rel = float(np.abs(g - w).max() / np.abs(w).max())
        if must and not rel <= CLI_SAME_TOL:
            raise AssertionError(f"{name}: rows {g} against {model}'s {w}: "
                                 f"{rel:.3e} of max; limit {CLI_SAME_TOL}")
        log("cli_same", arm=name, against=model, must_match=must,
            epochs="/".join(f"{e}{s[:2]}" for e, s in keys),
            max_rel_diff=f"{rel:.3e}", bitwise=bool((g == w).all()),
            peak_mib=f"{arms[name]['peak'] / 2 ** 20:.1f}",
            against_peak_mib=f"{arms[model]['peak'] / 2 ** 20:.1f}",
            s_per_epoch="/".join(f"{v:.3f}" for v in arms[name]["per_epoch"]),
            against_s_per_epoch="/".join(
                f"{v:.3f}" for v in arms[model]["per_epoch"]))


def cli_ctf_checks(torch, paths: dict) -> None:
    """apply_ctf on the card against the grouped conv2d at B=100 with the
    run's own 39x39 kernels (float64, and float32 against float64), with
    both timed; the bicubic rotation on the card against its CPU result."""
    from spatialvae_torch.ctf import apply_ctf, apply_ctf_spatial
    from spatialvae_torch.ctf import ctf_filter, parse_ctf
    from spatialvae_torch.transforms.augment import rotate_images_bicubic

    k = CLI_SIDE - 1
    kernels = ctf_filter(parse_ctf(paths["ctf_train"]), k, k)[:CLI_BATCH]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    y64 = torch.randn((CLI_BATCH, CLI_SIDE, CLI_SIDE), generator=gen,
                      device=DEVICE, dtype=torch.float64)
    k64 = torch.from_numpy(kernels).to(DEVICE, torch.float64)
    spatial = apply_ctf_spatial(y64, k64)
    scale = spatial.abs().max().item()
    err64 = (apply_ctf(y64, k64) - spatial).abs().max().item() / scale
    y32, k32 = y64.float(), k64.float()
    err32 = (apply_ctf(y32, k32).double() - spatial).abs().max().item() \
        / scale
    if not (err64 <= CTF_F64_TOL and err32 <= CTF_F32_TOL):
        raise AssertionError(f"apply_ctf vs the grouped conv2d: float64 "
                             f"{err64}, float32 {err32}; limits "
                             f"{CTF_F64_TOL}, {CTF_F32_TOL}")
    fft_ms = statistics.median(cuda_ms(lambda: apply_ctf(y32, k32), torch)
                               for _ in range(N_TIMED))
    conv_ms = statistics.median(
        cuda_ms(lambda: apply_ctf_spatial(y32, k32), torch)
        for _ in range(N_TIMED))
    imgs = torch.rand((CLI_BATCH, CLI_SIDE, CLI_SIDE), generator=gen,
                      device=DEVICE)
    theta = 2 * math.pi * torch.rand(CLI_BATCH, generator=gen, device=DEVICE)
    got = rotate_images_bicubic(imgs, theta)
    want = rotate_images_bicubic(imgs.cpu(), theta.cpu())
    rot_err = (got.cpu() - want).abs().max().item()
    if not rot_err <= ROTATE_TOL:
        raise AssertionError(f"rotation on the card vs the CPU: {rot_err}; "
                             f"limit {ROTATE_TOL}")
    rot_ms = statistics.median(
        cuda_ms(lambda: rotate_images_bicubic(imgs, theta), torch)
        for _ in range(N_TIMED))
    log("cli_ctf", batch=CLI_BATCH, kernel=f"{k}x{k}",
        f64_fft_vs_conv_max_rel=f"{err64:.3e}",
        f32_fft_vs_f64_conv_max_rel=f"{err32:.3e}",
        f32_fft_ms=f"{fft_ms:.4f}", f32_conv2d_ms=f"{conv_ms:.4f}",
        rotate_vs_cpu_max_abs=f"{rot_err:.3e}", rotate_ms=f"{rot_ms:.4f}")


# K1/K2 at the CLI's shapes: name, B, HW, H, Lh, No, resid, weight dtype
# (the float arms' training batches and their tail, 8,192 % 100 = 92;
# Gaussian one output, colored two)
CLI_BWD_CASES = [
    (f"cli_{fam}{tail}", b, CLI_SIDE ** 2, CLI_HIDDEN, 1, no, False,
     "float32")
    for fam, no in (("gaussian", 1), ("colored", 2))
    for tail, b in (("", CLI_BATCH), ("_tail", CLI_TRAIN % CLI_BATCH))]
# the evaluation's batches (1,024 % 100 = 24): K1 without its activations
# in the float arms, K4 without a1 in the int8 arms
CLI_EVAL_BATCHES = (CLI_BATCH, CLI_TEST % CLI_BATCH)


def k12_checks(torch, tag: str, cases, evals) -> None:
    """K1 with its activations and K2 (both variants) on ``cases`` (rows
    in BWD_CASES' layout), then K1 alone at each (B, HW, No) of ``evals``
    (float32 weights, H=P_HIDDEN), against their plain versions at the
    limits of ``[kernel_bwd]`` and ``[kernel]``; logged under ``tag``."""
    for case in cases:
        name, b, hw, h, _, no, _, dtype = case
        r = backward_case(torch, case, SEED, timed=False)
        checked = check_backward(name, dtype, r)
        log(tag, kernel="K1/K2", case=name, B=b, HW=hw, H=h, No=no,
            dtype=dtype, route=r["route"],
            y_max_abs_err=f"{r['y'][0]:.3e}",
            acts_max_abs_err=f"{r['acts'][0]:.3e}",
            errors="max_abs/mean_abs/max_rel/mean_rel",
            **{f"{v}_{k}": e for v, (f, _) in checked.items()
               for k, e in f.items() if k in GRADS})
        torch.cuda.empty_cache()
    for b, hw, no in evals:
        r = fwd_case(torch, b, P_HIDDEN, "float32", SEED, False, hw=hw, no=no)
        log(tag, kernel="K1", case="eval", B=b, HW=hw, H=P_HIDDEN, No=no,
            dtype="float32", route=r["route"],
            y_max_abs_err=f"{r['y'][0]:.3e}",
            y_mean_abs_err=f"{r['y'][1]:.3e}",
            max_tol=TOL["float32"][0], mean_tol=TOL["float32"][1])


def k3_check(torch, tag: str, what: str, r, **fields) -> None:
    """Raise unless a K3 reading (``family_case``, ``loss_case``) holds
    INT8_TOL against the plain version, and on the cluster passes against
    the block passes, with two runs equal bit for bit; log it under
    ``tag`` with ``fields``."""
    if not r["same"]:
        raise AssertionError(f"{what}: two runs differ")
    errs = {n: _check_rel(f"{what} {n}", r[n], INT8_TOL)
            for n in ("loss",) + INT8_GRADS}
    if r["route"] == "sm90":
        for n in ("loss",) + INT8_GRADS:
            _check_rel(f"{what} {n}, cluster vs block passes",
                       r["vs_block"][n], INT8_TOL)
    log(tag, kernel="K3", **fields, route=r["route"],
        errors="max_abs/mean_abs/max_rel/mean_rel", **errs,
        max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
        ints_vs_plain=_check_ints(what, r), **_log_ab(r))
    torch.cuda.empty_cache()


def k45_check(torch, tag: str, b: int, dtype: str, hw: int, no: int) -> None:
    """K4 with and without a1 (and on the route the table gives K4 alone)
    and K5 with the residual and with recompute against their plain
    versions at B=b over ``hw`` pixels (coords padded to a multiple of
    256), ``no`` outputs and ``dtype`` weights, and on the cluster passes
    against the block passes; logged under ``tag``."""
    what = f"K4/K5 HW={hw} No={no} {dtype} B={b}"
    r = int8_tail_case(torch, b, dtype, SEED, False, hw=hw, no=no)
    _check_abs(f"{what} y", r["y"], INT8_Y_TOL)
    _check_abs(f"{what} y without a1", r["y_no_a1"], INT8_Y_TOL)
    _check_abs(f"{what} a1", r["a1"], INT8_A1_TOL)
    if "y_alone" in r:
        _check_abs(f"{what} y without a1 on {r['route_alone']}",
                   r["y_alone"], INT8_Y_TOL)
    v = r["vs_block"]
    if r["route"] == "sm90":
        _check_abs(f"{what} y, cluster vs block passes", v["y"], INT8_Y_TOL)
        _check_abs(f"{what} a1, cluster vs block passes", v["a1"],
                   INT8_A1_TOL)
    worst = {}
    for variant in ("residual", "recompute"):
        if not r[variant, "same"]:
            raise AssertionError(f"{what} {variant}: two runs differ")
        worst[variant] = _check_int8_all(
            f"{what} {variant}", {n: r[variant, n] for n in INT8_GRADS},
            INT8_GRADS)
        if r["route"] == "sm90":
            _check_int8_all(f"{what} {variant}, cluster vs block passes",
                            {n: v[variant, n] for n in INT8_GRADS},
                            INT8_GRADS)
    log(tag, kernel="K4/K5", B=b, HW=hw, padded_HW=-(-hw // 256) * 256,
        H=P_HIDDEN, No=no, dtype=dtype, route=r["route"],
        route_alone=r["route_alone"], y_max_abs_err=f"{r['y'][0]:.3e}",
        a1_max_abs_err=f"{r['a1'][0]:.3e}",
        y_alone_max_abs_err=(f"{r['y_alone'][0]:.3e}" if "y_alone" in r
                             else "-"),
        y_tol=INT8_Y_TOL, a1_tol=INT8_A1_TOL,
        k5_max_rel="/".join(worst[k] for k in worst),
        max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1])
    torch.cuda.empty_cache()


class recorded_adam_leaves:
    """Within the block the training paths' Adam records the leaves of its
    first step (shapes, gradient and moment dtypes, shadow, modes) in
    ``self.leaves``, every distinct such set in ``self.distinct``, and runs
    on as it would."""

    def __enter__(self):
        from spatialvae_torch.kernels import adam as ka
        from spatialvae_torch.train import optimizer

        self.leaves, self.saved = None, (ka.adam_step, optimizer.adam_step)
        self.distinct = []
        step = ka.adam_step

        def recording(p, g, m, v, k, shadow=None, modes=None, s_in=None):
            rec = dict(shapes=[tuple(t.shape) for t in p],
                       gdt=str(g[0].dtype).replace("torch.", ""),
                       mdt=str(m[0].dtype).replace("torch.", ""),
                       shadow=shadow is not None,
                       modes=None if modes is None else list(modes))
            if rec not in self.distinct:
                self.distinct.append(rec)
            if self.leaves is None:
                self.leaves = rec
            return step(p, g, m, v, k, shadow, modes, s_in)

        ka.adam_step = optimizer.adam_step = recording
        return self

    def __exit__(self, *exc):
        from spatialvae_torch.kernels import adam as ka
        from spatialvae_torch.train import optimizer

        ka.adam_step, optimizer.adam_step = self.saved
        return False


def adam_leaves_check(torch, tag: str, arm: str, leaves) -> None:
    """The step kernel against its plain version on one arm's own leaves
    (``recorded_adam_leaves``: its shapes, dtypes, shadow and modes) on
    random inputs from SEED, bit for bit, as ``[kernel_adam]`` holds it;
    logged under ``tag``."""
    from spatialvae_torch.kernels import adam as ka

    if leaves is None:
        raise AssertionError(f"{arm}: Adam took no step")
    modes = leaves["modes"] or [ka.PLAIN] * len(leaves["shapes"])
    k = ka.AdamConsts.make(ADAM_LR, 0.9, 0.999, 1e-8, ADAM_COUNT)
    base = _adam_inputs(torch, leaves["shapes"], leaves["gdt"],
                        leaves["mdt"], leaves["shadow"], SEED)
    refs = _clone_leaves(base)
    want = adam_step_call(ka, refs, k, modes, step=ka.adam_step_reference)
    got = adam_step_call(ka, base, k, modes)
    torch.cuda.synchronize()
    differ, err = adam_step_differ(base, refs, got, want, modes)
    adam_check(f"{arm}: the step kernel on the arm's leaves", differ)
    log(tag, kernel="K6", arm=arm, leaves=len(modes),
        params=sum(math.prod(s) for s in leaves["shapes"]),
        largest=json.dumps(max(leaves["shapes"], key=math.prod)),
        grads=leaves["gdt"], moments=leaves["mdt"], shadow=leaves["shadow"],
        fresh_leaves=sum(md == ka.FRESH for md in modes),
        differ=json.dumps(differ, separators=(",", ":")),
        max_abs_err=f"{err:.3e}")
    del base, refs, want, got
    torch.cuda.empty_cache()


def cli_kernel_checks(torch) -> None:
    """``[cli_kernels]``: every kernel the CLI's arms launch, against its
    plain version at the arms' own shapes (40x40, H=500, float32 weights),
    through the helpers and limits of the earlier phases: K1 with its
    activations and K2 (both variants) at the training batches and K1
    alone at the evaluation's, one and two outputs; K3's Gaussian family
    at 1,600 pixels padded to 1,792 under the CLI's circular mask with
    float32 targets (arm d; with stochastic rounding, arm m); K4 with a1
    and K5 on the cluster passes over
    coords padded to 1,792 (arm c's training, two outputs) and K4 without
    a1 on the route the table gives float32 weights (the int8 arms'
    evaluation, both output counts).  Adam's step kernel is held to its
    plain version on each arm's own leaves after the arm
    (``adam_leaves_check``)."""
    from spatialvae_torch.cli.train_particles import circular_mask

    hw = CLI_SIDE ** 2
    k12_checks(torch, "cli_kernels", CLI_BWD_CASES,
               [(b, hw, no) for no in (1, 2) for b in CLI_EVAL_BATCHES])
    mask = torch.from_numpy(circular_mask(CLI_SIDE, CLI_SIDE)).to(DEVICE)
    case = ("cli_gaussian_pad40", "gaussian", CLI_SIDE, True, False)
    for b in (CLI_BATCH, CLI_TRAIN % CLI_BATCH):
        for sr in (False, True):
            r = family_case(torch, case, "float32", SEED, False, b=b,
                            target_dtype="float32", mask_values=mask,
                            nm=_numerics(sr=sr))
            if sr:
                _sr_fields(f"K3 SR {case[0]} B={b}", r)
            k3_check(torch, "cli_kernels", f"K3 {case[0]} B={b}", r,
                     case=case[0], B=b, HW=hw,
                     padded_HW=-(-hw // 256) * 256, H=CLI_HIDDEN, No=1,
                     dtype="float32", targets="float32", mask="circular",
                     numerics="sr" if sr else "default")
    for no, batches in ((2, (CLI_BATCH, CLI_TRAIN % CLI_BATCH,
                             CLI_TEST % CLI_BATCH)),
                        (1, CLI_EVAL_BATCHES)):
        for b in batches:
            k45_check(torch, "cli_kernels", b, "float32", hw, no)


def tail_cache_cost(torch) -> None:
    """The float decoder's no-grad path after an Adam step: the tail
    weights are rebuilt (stacked, padded, laid out in slabs) once, on the
    first serving decode after the step.  K1 at B=100 on the CLI's default
    decoder (40x40, 500 wide, one hidden layer) with the cache warm, and
    with ``mark_written`` (what the Adam wrappers call) before each call."""
    from spatialvae_torch.config import SpatialGeneratorConfig
    from spatialvae_torch.kernels import fused_decoder as fd
    from spatialvae_torch.kernels.adam import mark_written
    from spatialvae_torch.models import SpatialGenerator
    from spatialvae_torch.transforms.coords import coord_grid

    gen = SpatialGenerator(SpatialGeneratorConfig(latent_dim=2,
                                                  hidden_dim=CLI_HIDDEN,
                                                  num_layers=2),
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(SEED), device=DEVICE)
    grid = coord_grid(CLI_SIDE, CLI_SIDE, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 42)
    theta = torch.rand(CLI_BATCH, generator=g, device=DEVICE)
    dx = 0.1 * torch.rand((CLI_BATCH, 2), generator=g, device=DEVICE)
    z = torch.rand((CLI_BATCH, 2), generator=g, device=DEVICE)
    params = [p.detach() for p in gen.parameters()]

    def warm():
        fd.fused_spatial_generator(gen, grid, theta, dx, z)

    def stepped():
        mark_written(*params)
        fd.fused_spatial_generator(gen, grid, theta, dx, z)

    with torch.no_grad():
        warm()
        hit = statistics.median(cuda_ms(warm, torch) for _ in range(N_TIMED))
        miss = statistics.median(cuda_ms(stepped, torch)
                                 for _ in range(N_TIMED))
    log("tail_cache", batch=CLI_BATCH, hidden=CLI_HIDDEN, pixels=CLI_SIDE ** 2,
        k1_cached_ms=f"{hit:.4f}", k1_after_step_ms=f"{miss:.4f}",
        rebuild_ms=f"{miss - hit:.4f}")


def phase_cli_particles(torch, tmpdir: str, card: str) -> dict:
    """``[cli_particles]``: the particles CLI in process on 8,192 + 1,024
    synthetic 40x40 particles in MRC files with CTF tables, at its
    full-width defaults, in the arms of CLI_ARMS (float with mask and
    normalisation; CTF with the colored likelihood; the same in int8 mode,
    on K4/K5; the rotation augmentation in int8 mode, on K3, and with
    ``--int8-sr``, on K3's SR kernels; a resume of the first from its
    epoch-2 checkpoints and Adam state for one more epoch; the vanilla and
    long-run arms), after ``[cli_kernels]``, ``[cli_ctf]`` and
    ``[tail_cache]``; ``[cli_sr]`` sets (m)'s seconds per epoch beside
    (d)'s."""
    paths = cli_particles_data(tmpdir)
    cli_kernel_checks(torch)
    cli_ctf_checks(torch, paths)
    tail_cache_cost(torch)
    arms = {name: cli_arm(torch, name, paths, tmpdir, card)
            for name in CLI_ARMS}
    cli_same_rows(arms)
    d, m = arms["d_augment_int8"], arms["m_int8_sr"]
    log("cli_sr", arm="m_int8_sr", beside="d_augment_int8",
        s_per_epoch="/".join(f"{v:.3f}" for v in m["per_epoch"]),
        s_per_epoch_beside="/".join(f"{v:.3f}" for v in d["per_epoch"]),
        k3_launches=json.dumps(m["counts"]["detail"]["k3"],
                               separators=(",", ":")))
    return arms


# ---------------------------------------------------------------------------
# the galaxy and mnist CLIs end to end: the run-output tree (PNG grids, SVG
# curves, models.txt, checkpoints, the archive) and the vanilla generator,
# through ``python -m spatialvae_torch.cli.train_galaxy`` / ``train_mnist``'s
# ``main`` at full width
# ---------------------------------------------------------------------------

IMG_GALAXY = (64, 64)            # BASELINE.md's galaxy run: 4,000 images
IMG_GALAXY_TRAIN = 4000
IMG_GALAXY_TEST = 1000
IMG_MNIST_TRAIN = 60000          # MNIST's split
IMG_MNIST_TEST = 10000
IMG_RT_SIDE = 50                 # the paper's rotated-and-translated digits
IMG_SIDE = 28
IMG_GALAXY_ARGS = ["-z", "20", "--augment_rotation", "--minibatch_size",
                   "64", "--num_epochs", "4"]
# arm -> (CLI, argv, epochs, training images, batch, kernels that must
# launch, that must not, K1 launches per dump (display decodes) or None)
IMG_ARMS = {
    "a_galaxy": ("galaxy", ["GALAXY"] + IMG_GALAXY_ARGS, 4,
                 IMG_GALAXY_TRAIN, 64, ("k1", "k2", "adam_step"),
                 ("k3", "k4k5", "k8"), None),
    "b_galaxy_int8": ("galaxy", ["GALAXY"] + IMG_GALAXY_ARGS + [
        "--int8-decoder", "--compute-dtype", "bfloat16"], 4,
        IMG_GALAXY_TRAIN, 64, ("k1", "k3", "k4k5", "adam_step"),
        ("k2", "k8"), 2),
    "c_galaxy_vanilla": ("galaxy", ["GALAXY", "--vanilla", "-z", "20",
                                    "--minibatch_size", "64",
                                    "--num_epochs", "2"], 2,
                         IMG_GALAXY_TRAIN, 64, ("adam_step",),
                         ("k1", "k2", "k3", "k4k5", "k8"), None),
    "d_mnist_rt": ("mnist", ["--dataset", "mnist-rotated-translated",
                             "--num_epochs", "2"], 2, IMG_MNIST_TRAIN, 100,
                   ("k1", "k2", "adam_step"), ("k3", "k4k5", "k8"), None),
    "e_mnist_vanilla": ("mnist", ["--dataset", "mnist", "--vanilla", "-z",
                                  "100", "--minibatch_size", "64",
                                  "--num_epochs", "2"], 2, IMG_MNIST_TRAIN,
                        64, ("adam_step",), ("k1", "k2", "k3", "k4k5", "k8"),
                        None),
    "f_mnist_int8": ("mnist", ["--dataset", "mnist-rotated",
                               "--int8-decoder", "--num_epochs", "2"], 2,
                     IMG_MNIST_TRAIN, 100, ("k1", "k3", "k4k5", "adam_step"),
                     ("k2", "k8"), 1),
}
IMG_HEADER = "Epoch\tELBO\tBCE loss\tKL"


def digit_images(torch, n: int, side: int, gen, translate: bool):
    """(n, side, side) uint8 digit-like glyphs made on the card: a stem and
    a bar of random lengths and widths, the pair rotated by a random angle
    and, with ``translate``, shifted by up to a fifth of the image."""
    ax = torch.linspace(-1, 1, side, device=DEVICE)
    yy, xx = torch.meshgrid(-ax, ax, indexing="ij")

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 1, 1), generator=gen,
                                           device=DEVICE)

    th = u(-math.pi, math.pi)
    dx = u(-0.2, 0.2) if translate else 0.0
    dy = u(-0.2, 0.2) if translate else 0.0
    x, y = xx - dx, yy - dy
    r0 = torch.cos(th) * x + torch.sin(th) * y
    r1 = -torch.sin(th) * x + torch.cos(th) * y
    w = u(0.06, 0.12)
    stem = torch.exp(-(r0 - u(-0.2, 0.2)) ** 2 / (2 * w ** 2)) \
        * torch.sigmoid((u(0.3, 0.5) - r1.abs()) * 30)
    bar = torch.exp(-(r1 - u(0.2, 0.4)) ** 2 / (2 * w ** 2)) \
        * torch.sigmoid((u(0.15, 0.35) - r0.abs()) * 30)
    img = torch.clamp(stem + bar * (u(0, 1) > 0.3), 0, 1)
    return torch.round(img * 255).to(torch.uint8).cpu().numpy()


def write_idx(path: str, images: np.ndarray) -> None:
    """MNIST's idx3-ubyte image file."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape))
        f.write(images.tobytes())


def cli_images_data(torch, workdir: str) -> None:
    """The arms' files in ``workdir``, from SEED: the galaxy stacks
    (4,000 + 1,000 blob images, 64x64x3 uint8) and, under ``data/``, the
    rotated-and-translated digits at 50x50, the rotated digits at 28x28 and
    MNIST's idx files at 28x28 (60,000 + 10,000 each)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 50)
    for split, n in (("train", IMG_GALAXY_TRAIN), ("test", IMG_GALAXY_TEST)):
        imgs = blob_images(torch, n, gen, image=IMG_GALAXY, channels=3)
        np.save(os.path.join(workdir, f"galaxy_{split}.npy"),
                torch.round(imgs * 255).to(torch.uint8)
                .reshape(n, *IMG_GALAXY, 3).cpu().numpy())
    for sub, side, translate in (("mnist_rotated_translated", IMG_RT_SIDE,
                                  True),
                                 ("mnist_rotated", IMG_SIDE, False)):
        os.makedirs(os.path.join(workdir, "data", sub))
        for split, n in (("train", IMG_MNIST_TRAIN), ("test", IMG_MNIST_TEST)):
            np.save(os.path.join(workdir, "data", sub, f"images_{split}.npy"),
                    digit_images(torch, n, side, gen, translate))
    os.makedirs(os.path.join(workdir, "data", "mnist"))
    for name, n in (("train-images-idx3-ubyte", IMG_MNIST_TRAIN),
                    ("t10k-images-idx3-ubyte", IMG_MNIST_TEST)):
        write_idx(os.path.join(workdir, "data", "mnist", name),
                  digit_images(torch, n, IMG_SIDE, gen, False))


def _image_groups() -> dict:
    """The launches of the image CLIs' kernels: K1 (the float decoder's
    forward, with or without its activations) apart from K2 (its backward),
    since the int8 arms' display decodes launch K1 alone."""
    from spatialvae_torch.kernels import fused_decoder as fd

    c = _launch_groups()
    k1 = sum(v for k, v in fd.LAUNCHES.items()
             if k.startswith("fwd") and "recompute" not in k)
    return {"k1": k1, "k2": c["k1k2"] - k1, "k3": c["k3"],
            "k4k5": c["k4k5"], "adam_step": c["adam_step"], "k8": c["k8"],
            "detail": c["detail"]}


def grid_shape(b: int, dims, channels: int) -> tuple:
    """(height, width, channels) of ``io/png.save_image_grid``'s grid of b
    images."""
    n, m = dims
    xmaps = min(int(b ** 0.5), b)
    ymaps = -(-b // xmaps)
    return ((n + 3) * ymaps + 3, (m + 3) * xmaps + 3, channels)


def check_image_tree(torch, name: str, workdir: str, prefix: str,
                     label: str, dims, channels: int, batch: int,
                     epochs: int, cli: str, vanilla: bool) -> dict:
    """The arm's ``outputs_{prefix}`` tree, file by file: every PNG's
    signature, chunk CRCs and IHDR size (the grid of the first validation
    batch), the SVGs parsed as XML with one value an epoch, the end-of-run
    checkpoint pair through ``SpatialVae.load``, the zip's members."""
    import xml.etree.ElementTree as ET
    import zipfile

    from spatialvae_torch.api import SpatialVae
    from spatialvae_torch.io.png import read_png

    root = os.path.join(workdir, f"outputs_{prefix}")
    digits = int(math.log10(epochs)) + 1
    grids = ["", "dis_"] + (["rnd_"] if cli == "galaxy" else [])
    want = {"command.txt", "models.txt", "train.txt", "val.txt",
            f"images/_sample_{label}.png",
            f"trained/{prefix}_generator_epoch{epochs}.sav",
            f"trained/{prefix}_inference_epoch{epochs}.sav"}
    want |= {f"images/{t}.svg" for t in ("ELBO", "KL_Divergence",
                                           "BCE_Loss")}
    want |= {f"images/{str(e).zfill(digits)}_{g}{label}.png"
             for e in range(1, epochs + 1) for g in grids}
    if cli == "galaxy":
        want.add("run.log")
    got = {os.path.relpath(os.path.join(d, f), root)
           for d, _, files in os.walk(root) for f in files}
    if got != want:
        raise AssertionError(f"{name}: tree {sorted(got ^ want)} differs")
    shape = grid_shape(batch, dims, channels)
    for f in sorted(want):
        if f.endswith(".png"):
            px = read_png(os.path.join(root, f))
            if px.shape != shape:
                raise AssertionError(f"{name}: {f} is {px.shape}, the grid "
                                     f"of {batch} images is {shape}")
        elif f.endswith(".svg"):
            svg = ET.parse(os.path.join(root, f)).getroot()
            for g in svg.iter("{http://www.w3.org/2000/svg}g"):
                if g.get("id", "").startswith("series-") and \
                        len(g.get("data-values").split()) != epochs:
                    raise AssertionError(f"{name}: {f} {g.get('id')}")
    gp = os.path.join(root, f"trained/{prefix}_generator_epoch{epochs}.sav")
    model = SpatialVae.load(gp, gp.replace("generator", "inference"),
                            device=DEVICE)
    if model.vanilla != vanilla or tuple(model.image_shape) != tuple(dims):
        raise AssertionError(f"{name}: checkpoint {model.p_cfg}")
    z_mu, _ = model.encode(torch.zeros((4, dims[0] * dims[1] * channels),
                                       device=DEVICE))
    if not torch.isfinite(z_mu).all():
        raise AssertionError(f"{name}: {gp} encodes non-finite")
    zips = [f for f in os.listdir(workdir)
            if f.endswith(f"_outputs_{prefix}.zip")]
    if len(zips) != 1:
        raise AssertionError(f"{name}: archives {zips}")
    with zipfile.ZipFile(os.path.join(workdir, zips[0])) as zf:
        members = {m for m in zf.namelist() if not m.endswith("/")}
    if members != {f"outputs_{prefix}/{f}" for f in want}:
        raise AssertionError(f"{name}: zip members {sorted(members)}")
    return {"files": len(want), "grid": "x".join(map(str, shape)),
            "zip_mb": os.path.getsize(os.path.join(workdir, zips[0])) / 2**20}


@contextlib.contextmanager
def in_process_cli(workdir: str):
    """The working directory, the root logger's handlers and level, and the
    environment as they were, after the block; inside it the working
    directory is ``workdir`` and the outputs prompt is answered."""
    import logging

    cwd, env = os.getcwd(), dict(os.environ)
    handlers, level = logging.root.handlers[:], logging.root.level
    os.environ["SPATIALVAE_ASSUME_YES"] = "1"
    os.chdir(workdir)
    try:
        yield
    finally:
        os.chdir(cwd)
        for h in logging.root.handlers[:]:
            if h not in handlers:
                logging.root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in logging.root.handlers:
                logging.root.addHandler(h)
        logging.root.setLevel(level)
        os.environ.clear()
        os.environ.update(env)


def image_arm(torch, name: str, workdir: str, card: str) -> dict:
    """One galaxy or mnist CLI run in process: the launch counts from 0
    just before it, the TSV (every validation ELBO finite), seconds per
    epoch, launches per step, the artifact tree."""
    import io
    import shutil

    from spatialvae_torch.cli import train_galaxy, train_mnist

    cli, extra, epochs, n_train, batch, must, must_not, k1_dump = \
        IMG_ARMS[name]
    argv = []
    for a in extra:
        argv += (["galaxy_train.npy", "galaxy_test.npy"] if a == "GALAXY"
                 else [a])
    prefix = name
    argv += ["--save_prefix", prefix, "--save_interval", "1", "--seed",
             str(SEED)]
    main = (train_galaxy if cli == "galaxy" else train_mnist).main
    out, err = _StampedOut(), io.StringIO()
    with in_process_cli(workdir):
        torch.cuda.synchronize()
        _reset_all_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err), \
                    recorded_adam_leaves() as adam:
                main(argv)
            torch.cuda.synchronize()
        except BaseException:
            print(err.getvalue(), file=sys.stderr)
            raise
        seconds = time.perf_counter() - t0
    counts = _image_groups()
    adam_leaves_check(torch, "img_kernels", name, adam.leaves)
    rows = [(t, ln) for t, ln in out.lines if "\t" in ln]
    if not rows or rows[0][1] != IMG_HEADER:
        raise AssertionError(f"{name}: TSV header {rows[:1]}")
    body = [ln.split("\t") for _, ln in rows[1:]]
    want = [str(e) for e in range(epochs) for _ in ("train", "val")]
    if [r[0] for r in body] != want or any(len(r) != 4 for r in body):
        raise AssertionError(f"{name}: TSV rows {body}")
    val_elbo = [float(r[1]) for r in body[1::2]]
    if not np.isfinite([[float(v) for v in r] for r in body]).all():
        raise AssertionError(f"{name}: non-finite metrics {body}")
    # an epoch's seconds: its training, evaluation and image dump, from the
    # header (the data loaded and on the card) to its validation row
    stamps = [rows[0][0]] + [t for t, _ in rows[2::2]]
    per_epoch = [b - a for a, b in zip(stamps, stamps[1:])]
    # the run's end: checkpoints, plots and results up to the archive's
    # first line, then the archive (deflating the checkpoints)
    arch = [t for t, ln in out.lines if ln.startswith(("Archiving files",
                                                       "Images saved at"))]
    if len(arch) != 2:
        raise AssertionError(f"{name}: archive lines {arch}")
    steps = epochs * math.ceil(n_train / batch)
    for k in must:
        if counts[k] < 1:
            raise AssertionError(f"{name}: {k} was not launched: {counts}")
    for k in must_not:
        if counts[k]:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times: "
                                 f"{counts}")
    if k1_dump is not None and counts["k1"] != k1_dump * epochs:
        raise AssertionError(f"{name}: K1 launched {counts['k1']} times, "
                             f"{k1_dump} a dump expected (the display "
                             f"decodes alone)")
    if counts["adam_step"] != steps:
        raise AssertionError(f"{name}: {counts['adam_step']} Adam launches "
                             f"for {steps} steps")
    dims = IMG_GALAXY if cli == "galaxy" else (
        (IMG_RT_SIDE,) * 2 if "mnist-rotated-translated" in extra else
        (IMG_SIDE,) * 2)
    channels = 3 if cli == "galaxy" else 1
    n_test = IMG_GALAXY_TEST if cli == "galaxy" else IMG_MNIST_TEST
    label = prefix + "_" + "".join(
        (f"z{argv[argv.index('-z') + 1] if '-z' in argv else 2}",
         "pnl2qnl2" if cli == "galaxy" else "nl2", f"ep{epochs}"))
    tree = check_image_tree(torch, name, workdir, prefix, label, dims,
                            channels, min(batch, n_test), epochs, cli,
                            "--vanilla" in extra)
    # the arm's checkpoints and archive hold up to 0.7 GB: not kept
    shutil.rmtree(os.path.join(workdir, f"outputs_{prefix}"))
    for f in os.listdir(workdir):
        if f.endswith(f"_outputs_{prefix}.zip"):
            os.remove(os.path.join(workdir, f))
    log("cli_images", arm=name, card=repr(card), epochs=epochs,
        seconds=f"{seconds:.3f}",
        s_per_epoch="/".join(f"{v:.3f}" for v in per_epoch),
        start_s=f"{rows[0][0] - t0:.3f}", save_s=f"{arch[0] - stamps[-1]:.3f}",
        archive_s=f"{arch[1] - arch[0]:.3f}", train_steps=steps,
        val_elbo="/".join(f"{v:.4f}" for v in val_elbo),
        launches=json.dumps({k: v for k, v in counts.items()
                             if k != "detail"}, separators=(",", ":")),
        per_step=json.dumps({k: round(counts[k] / steps, 4)
                             for k in ("k1", "k2", "k3", "k4k5",
                                       "adam_step")}, separators=(",", ":")),
        files=tree["files"], grid=tree["grid"],
        zip_mb=f"{tree['zip_mb']:.1f}",
        detail=json.dumps(counts["detail"], separators=(",", ":")))
    return {"seconds": seconds, "per_epoch": per_epoch, "counts": counts}


# K1/K2 at the image arms' training batches (float32 weights): galaxy
# 64x64x3 at B=64 and its tail, 4,000 % 64 = 32 (arm a); the rotated and
# translated digits at 50x50, B=100, no tail (arm d)
IMG_BWD_CASES = [
    ("img_galaxy", 64, IMG_GALAXY[0] * IMG_GALAXY[1], P_HIDDEN, 1, 3, False,
     "float32"),
    ("img_galaxy_tail", IMG_GALAXY_TRAIN % 64, IMG_GALAXY[0] * IMG_GALAXY[1],
     P_HIDDEN, 1, 3, False, "float32"),
    ("img_mnist_rt", 100, IMG_RT_SIDE ** 2, P_HIDDEN, 1, 1, False,
     "float32"),
]
# K1 alone, float32 weights (B, HW, No): the galaxy evaluation's batches
# (1,000 % 64 = 40) and the display decodes of arms a and b (B=64); arm d's
# evaluation and display decodes; arm f's display decodes at 28x28
IMG_K1_EVALS = [(64, IMG_GALAXY[0] * IMG_GALAXY[1], 3),
                (IMG_GALAXY_TEST % 64, IMG_GALAXY[0] * IMG_GALAXY[1], 3),
                (100, IMG_RT_SIDE ** 2, 1), (100, IMG_SIDE ** 2, 1)]


def img_kernel_checks(torch) -> None:
    """``[img_kernels]``: every kernel the image CLIs' arms launch, against
    its plain version at the arms' own shapes (H=500), through the helpers
    and limits of the earlier phases: K1 with its activations and K2 (both
    variants) and K1 alone (IMG_BWD_CASES, IMG_K1_EVALS); K3's Bernoulli
    family on three channels with bf16 weights and int8 targets at B=64
    and the tail of 32 (arm b) and its padded family at 28x28 (784 pixels
    padded to 1,024) with float32 weights at B=100 (arm f); K4 with and
    without a1 and K5 at arm b's evaluation batches (64, 40; bf16) and at
    arm f's (B=100, 784 pixels, float32 weights: K4 alone on the block
    passes).  Adam's step kernel is held to its plain version on each
    arm's own leaves after the arm (``adam_leaves_check``)."""
    k12_checks(torch, "img_kernels", IMG_BWD_CASES, IMG_K1_EVALS)
    hw = IMG_GALAXY[0] * IMG_GALAXY[1]
    for b in (64, IMG_GALAXY_TRAIN % 64):
        r = loss_case(torch, b, "bfloat16", SEED, False)
        k3_check(torch, "img_kernels", f"K3 galaxy bf16 B={b}", r,
                 case="img_galaxy", B=b, HW=hw, padded_HW=hw, H=P_HIDDEN,
                 No=3, dtype="bfloat16", targets="int8", mask="-")
    case = ("img_bernoulli_pad28", "bernoulli", IMG_SIDE, False, True)
    r = family_case(torch, case, "float32", SEED, False, b=100)
    k3_check(torch, "img_kernels", f"K3 {case[0]} B=100", r, case=case[0],
             B=100, HW=IMG_SIDE ** 2, padded_HW=1024, H=P_HIDDEN, No=1,
             dtype="float32", targets="int8", mask="-")
    for b in (64, IMG_GALAXY_TEST % 64):
        k45_check(torch, "img_kernels", b, "bfloat16", hw, 3)
    k45_check(torch, "img_kernels", 100, "float32", IMG_SIDE ** 2, 1)


def phase_cli_images(torch, tmpdir: str, card: str) -> dict:
    """``[cli_images]``: the galaxy and mnist CLIs in process at full width
    in six arms ((a) galaxy z=20 with rotation augmentation, B=64, four
    epochs, BASELINE #5 at BASELINE.md's size; (b) the same in int8 mode
    with bf16 compute; (c) the galaxy vanilla generator; (d) mnist's
    rotated-and-translated digits at their defaults, BASELINE #2; (e) the
    vanilla generator on MNIST idx files, z=100, B=64; (f) the rotated
    digits in int8 mode), each from its files in one working directory;
    first ``[img_kernels]``, the arms' kernels at their shapes."""
    workdir = os.path.join(tmpdir, "cli_images")
    os.makedirs(workdir)
    t0 = time.perf_counter()
    img_kernel_checks(torch)
    checks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_images_data(torch, workdir)
    data_s = time.perf_counter() - t0
    res = {name: image_arm(torch, name, workdir, card) for name in IMG_ARMS}
    log("cli_images", arms=len(res), checks_s=f"{checks_s:.3f}",
        data_s=f"{data_s:.3f}",
        phase_s=f"{time.perf_counter() - t0:.3f}")
    return res


# ---------------------------------------------------------------------------
# long runs: the int8 horizon gate at full width (``python -m
# spatialvae_torch.tools.int8_horizon``) and the kernels at its shapes
# ---------------------------------------------------------------------------

HORIZON_B = 1024            # the horizon tool's batch
HORIZON_EPOCHS = 3          # of each arm in the smoke (the gate runs 30)
HORIZON_STEPS = 8           # the tool's steps per epoch
# images per call of a plain version at B=1,024: its (B, HW, H) float32
# intermediates of the whole batch (8.4 GB each) are run in these chunks,
# the per-image outputs concatenated and the weight gradients summed
HORIZON_CHUNK = 128
# K3 at the horizon's shapes: (name, family, targets, masked)
HORIZON_K3 = [("fields", "bernoulli", "bfloat16", False),
              ("galaxy", "bernoulli", "int8", False),
              ("colored_mask", "colored", "bfloat16", True)]


class _ErrAcc:
    """``rel_errors`` of a tensor compared chunk by chunk."""

    def __init__(self):
        self.max, self.sum, self.n, self.scale = 0.0, 0.0, 0, 0.0

    def add(self, got, want) -> None:
        d = (got.float() - want.float()).abs()
        self.max = max(self.max, d.max().item())
        self.sum += d.sum().item()
        self.n += d.numel()
        self.scale = max(self.scale, want.abs().max().item())

    def errors(self) -> tuple:
        mean, scale = self.sum / self.n, self.scale or 1.0
        return self.max, mean, self.max / scale, mean / scale


def _chunks(b: int):
    return [(i, min(i + HORIZON_CHUNK, b)) for i in range(0, b, HORIZON_CHUNK)]


def horizon_k12_case(torch, b: int = HORIZON_B, dtype="bfloat16") -> dict:
    """K1 with its activations and K2 (residual and recompute) at the
    horizon's bf16 arm shape (B=1,024 over 4,096 pixels, H=500, one hidden
    layer, three outputs) against their plain versions run in
    HORIZON_CHUNK-image chunks: ``backward_case``'s readings, every output
    compared (the per-image ones chunk by chunk, the weight gradients as
    the sum over the chunks)."""
    from spatialvae_torch.kernels import fused_decoder as fd

    hw, h, no = IMAGE[0] * IMAGE[1], P_HIDDEN, CHANNELS
    wdt = getattr(torch, dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 60)
    fold, coords, *ws = _tail_inputs(torch, b, hw, h, 1, no, wdt, gen)
    g = torch.randn((b, no, hw), generator=gen, device=DEVICE)
    tw = fd.TailWeights(*ws)
    out = {"route": fd.decoder_route(hw, h, 1, no, False)}
    with torch.no_grad():
        y, acts = fd.run_decoder_tail_acts(fold, coords, tw, False)
        acc_y, acc_a = _ErrAcc(), _ErrAcc()
        for i0, i1 in _chunks(b):
            y_ref, a_ref = fd.decoder_tail_reference(
                fold[i0:i1], coords, *ws, False, return_acts=True)
            acc_y.add(y[i0:i1], y_ref)
            acc_a.add(acts[:, i0:i1], a_ref)
            del y_ref, a_ref
        out["y"], out["acts"] = acc_y.errors(), acc_a.errors()
        for variant in ("residual", "recompute"):
            a = acts if variant == "residual" else None
            got = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g,
                                               False)
            again = fd.run_decoder_tail_backward(fold, coords, tw, a, y, g,
                                                 False)
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"K1/K2 B={b} {variant}: two runs "
                                     f"differ")
            del again
            parts = [fd.decoder_tail_backward_reference(
                fold[i0:i1], coords, ws[0], ws[1], ws[2],
                None if a is None else a[:, i0:i1], y[i0:i1], g[i0:i1],
                False) for i0, i1 in _chunks(b)]
            want = [torch.cat([p[0] for p in parts])] + [
                sum(p[k].float() for p in parts) for k in range(1, 5)]
            for gname, u, v in zip(GRADS, got, want):
                if u.shape != v.shape:
                    raise AssertionError(f"K2 B={b} {gname}: shape")
                out[variant, gname] = rel_errors(u, v)
            del got, want, parts
    del fold, coords, ws, g, tw, y, acts
    torch.cuda.empty_cache()
    return out


def horizon_k3_case(torch, case, b: int = HORIZON_B) -> dict:
    """K3 at the horizon's int8 arm shape (B=1,024 over 4,096 pixels, bf16
    weights): the fields data's bf16 targets, the galaxy proxy's int8 ones
    (three channels), or the colored family under the disc mask (its
    chunk-permuted coords, bf16 targets pre-paired), on the passes its
    route takes against the block passes and against the plain version run
    in HORIZON_CHUNK-image chunks (dfold and the loss per image, the
    weight gradients summed); two runs bit for bit."""
    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics
    from spatialvae_torch.train.trainer import build_yt_i8, yt_layout

    name, family, targets, masked = case
    hw = IMAGE[0] * IMAGE[1]
    colored = family == "colored"
    no = 2 if colored else CHANNELS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 61)
    fold, coords, ws = _int8_inputs(torch, b, "bfloat16", gen, no=no)
    if targets == "int8":
        y = torch.randint(0, 256, (b, hw, no), generator=gen,
                          device=DEVICE).float() / 255.0
        yt = build_yt_i8(y, hw, colored)
    else:
        y = torch.rand((b, hw) if colored else (b, hw, no), generator=gen,
                       device=DEVICE)
        yt = yt_layout(y.to(torch.bfloat16), hw, colored)
    del y
    mask = disc_mask(torch, IMAGE) if masked else None
    if colored:
        coords = l8.colored_coords(coords, l8.pick_tile(hw)).contiguous()
    nm = Numerics()
    route = l8.k3_route(hw, P_HIDDEN, l8.pick_tile(hw), family, nm)
    run = functools.partial(l8.run_loss_int8, fold, coords, *ws, yt, mask,
                            family, numerics=nm)
    out = {"route": route}
    with torch.no_grad():
        got, again = run(), run()
        torch.cuda.synchronize()
        out["same"] = all(torch.equal(u, v) for u, v in zip(got, again))
        del again
        block = run(block_passes=True)
        parts = [l8.loss_int8_reference(fold[i0:i1], coords, *ws,
                                        yt[i0:i1], mask, family, nm)
                 for i0, i1 in _chunks(b)]
        want = [torch.cat([p[0] for p in parts])] + [
            sum(p[k] for p in parts) for k in range(1, 5)]
        pairs = list(zip(("loss",) + INT8_GRADS,
                         (got[0][:, 3, 0],) + tuple(got),
                         (block[0][:, 3, 0],) + tuple(block),
                         (want[0][:, 3, 0],) + tuple(want)))
        out["plain"] = {n: rel_errors(u, w) for n, u, _, w in pairs}
        out["vs_block"] = {n: rel_errors(u, v) for n, u, v, _ in pairs}
        out["block"] = {n: rel_errors(v, w) for n, _, v, w in pairs}
        del got, block, want, parts
    del fold, coords, ws, yt
    torch.cuda.empty_cache()
    return out


def phase_horizon_kernels(torch) -> None:
    """``[horizon_kernels]``: the kernels of the horizon tool's arms at
    shapes no other case runs, against their plain versions under the
    existing limits: K1/K2 bf16 at B=1,024 over 4,096 pixels
    (``horizon_k12_case``), K3 bf16 at B=1,024 with bf16 and int8 targets
    and its colored family under the mask (``horizon_k3_case``).  The
    plain versions run in HORIZON_CHUNK-image chunks: their whole-batch
    (B, HW, H) intermediates do not fit.  Adam's step kernel is held to
    its plain version on each arm's own leaves after ``[horizon]``."""
    t0 = time.perf_counter()
    r = horizon_k12_case(torch)
    checked = check_backward(f"horizon K1/K2 B={HORIZON_B}", "bfloat16", r)
    log("horizon_kernels", kernel="K1/K2", B=HORIZON_B,
        HW=IMAGE[0] * IMAGE[1], H=P_HIDDEN, No=CHANNELS, dtype="bfloat16",
        route=r["route"], plain_chunk=HORIZON_CHUNK,
        y_max_abs_err=f"{r['y'][0]:.3e}",
        acts_max_abs_err=f"{r['acts'][0]:.3e}",
        errors="max_abs/mean_abs/max_rel/mean_rel",
        **{f"{v}_{k}": e for v, (f, _) in checked.items()
           for k, e in f.items() if k in GRADS})
    for case in HORIZON_K3:
        r = horizon_k3_case(torch, case)
        what = f"horizon K3 {case[0]} B={HORIZON_B}"
        if not r["same"]:
            raise AssertionError(f"{what}: two runs differ")
        errs = {n: _check_rel(f"{what} {n}", e, INT8_TOL)
                for n, e in r["plain"].items()}
        for n, e in r["vs_block"].items():
            _check_rel(f"{what} {n}, cluster vs block passes", e, INT8_TOL)
        for n, e in r["block"].items():
            _check_rel(f"{what} {n}, block passes", e, INT8_TOL)
        log("horizon_kernels", kernel="K3", case=case[0], family=case[1],
            targets=case[2], mask=case[3], B=HORIZON_B,
            HW=IMAGE[0] * IMAGE[1], H=P_HIDDEN, dtype="bfloat16",
            route=r["route"], plain_chunk=HORIZON_CHUNK,
            errors="max_abs/mean_abs/max_rel/mean_rel", **errs,
            max_rel_tol=INT8_TOL[0], mean_rel_tol=INT8_TOL[1],
            vs_block_max_rel=f"{max(e[2] for e in r['vs_block'].values()):.2e}")
    log("horizon_kernels", phase_s=f"{time.perf_counter() - t0:.3f}")


def phase_horizon(torch, card: str) -> dict:
    """``[horizon]``: ``python -m spatialvae_torch.tools.int8_horizon``'s
    ``main`` in process at its full width and defaults (B=1,024, 8 steps
    an epoch, fields data) for HORIZON_EPOCHS epochs of each arm, the
    launches counted from 0: the bf16 arm on K1/K2, the int8 arm on K3's
    cluster passes (every batch even: no K4/K5), Adam's step kernel once a
    step; the per-epoch ELBOs finite, the gaps and seconds logged; then
    Adam's step kernel against its plain version on each arm's leaves."""
    import io

    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.tools import int8_horizon

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), recorded_adam_leaves() as adam:
        int8_horizon.main([f"epochs={HORIZON_EPOCHS}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    summary = json.loads(lines[-1])
    epochs = {arm: [ln for ln in lines if ln.startswith(f"# {arm} epoch")]
              for arm in ("bf16", "int8")}
    elbo = {arm: [float(ln.split("ELBO=")[1].split()[0]) for ln in ls]
            for arm, ls in epochs.items()}
    secs = {arm: [float(ln.rsplit("(", 1)[1].rstrip("s)")) for ln in ls]
            for arm, ls in epochs.items()}
    if any(len(v) != HORIZON_EPOCHS or not np.isfinite(v).all()
           for v in elbo.values()):
        raise AssertionError(f"[horizon]: per-epoch ELBOs {elbo}")
    c = _int8_launches()
    steps = HORIZON_EPOCHS * HORIZON_STEPS
    k3 = c["k3"]
    if (c["adam"]["adam_step"] != 2 * steps or c["k12"] < steps
            or k3.get("fwd_sm90", 0) < steps or k3.get("fwd", 0)
            or sum(c["k45"].values()) or sum(c["k8"].values())):
        raise AssertionError(f"[horizon]: launches {c} for {steps} steps "
                             f"an arm")
    log("horizon", card=repr(card), epochs=HORIZON_EPOCHS, batch=HORIZON_B,
        steps_per_epoch=HORIZON_STEPS, seconds=f"{seconds:.3f}",
        peak_mib=f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f}",
        bf16_elbo="/".join(f"{v:.4f}" for v in elbo["bf16"]),
        int8_elbo="/".join(f"{v:.4f}" for v in elbo["int8"]),
        bf16_s_per_epoch="/".join(f"{v:.1f}" for v in secs["bf16"]),
        int8_s_per_epoch="/".join(f"{v:.1f}" for v in secs["int8"]),
        max_rel_gap=f"{summary['max_rel_gap']:.3e}",
        final_rel_gap=f"{summary['final_rel_gap']:.3e}",
        inside_1pct=summary["inside_1pct"],
        launches=json.dumps({"k12": c["k12"], "k3": sum(k3.values()),
                             "k3_fwd_sm90": k3.get("fwd_sm90", 0),
                             "adam_step": c["adam"]["adam_step"]},
                            separators=(",", ":")))
    # the bf16 arm's leaves, then the int8 arm's where they differ (its
    # int8 encoder weights take the fresh-scale mode at full width)
    for i, leaves in enumerate(adam.distinct):
        adam_leaves_check(torch, "horizon_kernels", f"horizon_leaves{i}",
                          leaves)
    return {"summary": summary, "launches": c}


# ---------------------------------------------------------------- [parallel]
# The mesh of ranks (spatialvae_torch/parallel/): ranks that share the one
# card, joined over gloo (NCCL refuses two ranks on one device), at the
# galaxy model's full width; PAR_STEPS steps of PAR_B images and a tail.
PAR_B = 1024
PAR_STEPS = 2
PAR_TAIL = 37
PAR_EVAL = 2 * PAR_B + 2         # two batches a rank halves, a tail of 2
PAR_K3_B = 16                    # the slices' K3 calls: images in one chunk
# the mesh's evaluation against one device's, relative: float32 compute
# adds the two halves' means in another order; bf16 compute (the int8 arm)
# rounds the encoder's bf16 products of 1,024 rows and of 512 differently
PAR_EVAL_TOL = {"eval_f32": 1e-5, "eval_int8": 5e-3}
# arm (a)'s step metrics against one device's, relative: the first step's
# (the same weights on both; 1.2e-6 on the H100) and the later steps' and
# the tail's (the weights part after the first step, the encoder's
# cotangent being quantised over a rank's rows; 2.7e-3).  The limits must
# also refuse the planted control, the same steps' metrics before the mesh
# averages them (a step that forgot the reduction; 3.0e-3 at the first)
PAR_METRIC_TOL = (1e-4, 5e-3)


def _par_world(rank: int, n: int, store: str) -> None:
    from spatialvae_torch.parallel import init_world
    from spatialvae_torch.precision import pin_fp32_precision

    pin_fp32_precision()
    init_world(rank, n, f"file://{store}", DEVICE, "gloo")


def _par_trainer(torch, mesh, int8: bool = True, family: str = None):
    """The galaxy trainer (int8 with bf16 compute, or float32 K1/K2), or a
    FAMILY_MODELS one's at its width, on ``mesh`` (None: one device), seed
    SEED, batch PAR_B."""
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    if family is None:
        q_cfg, p_cfg, ecfg = galaxy_configs()
        ecfg = dataclasses.replace(ecfg, int8=int8)
        image, channels, mask = IMAGE, CHANNELS, None
    else:                       # family_trainer's configs
        m = FAMILY_MODELS[family]
        image, channels = m["image"], 1
        q_cfg = InferenceConfig(n=image[0] * image[1],
                                latent_dim=m["z"] + 3,
                                hidden_dim=m["q_hidden"], num_layers=2)
        p_cfg = SpatialGeneratorConfig(latent_dim=m["z"],
                                       hidden_dim=P_HIDDEN,
                                       n_out=m["n_out"], num_layers=2)
        ecfg = ElboConfig(rotate=True, translate=True,
                          theta_prior=m["theta_prior"],
                          theta_mean_penalty=m["penalty"],
                          likelihood=m["likelihood"], channels=1,
                          fused=True, int8=True)
        mask = disc_mask(torch, image) if m["mask"] else None
    tcfg = TrainConfig(minibatch_size=PAR_B, learning_rate=1e-4,
                       num_epochs=1, seed=SEED,
                       compute_dtype="bfloat16" if int8 else "float32",
                       image_shape=image, channels=channels)
    return Trainer(q_cfg, p_cfg, ecfg, tcfg,
                   coord_grid(*image, device=DEVICE), mask=mask,
                   device=DEVICE, mesh=mesh)


def _par_state(trainer) -> list:
    """(name, tensor) of the masters, the shadow and the int8 copies."""
    out = list(trainer.named_params().items())
    out += [("shadow." + k, v) for k, v in (trainer.shadow or {}).items()]
    for k, e in (trainer.qshadow or {}).items():
        out += [(f"qshadow.{k}.{f}", t) for f, t in e.items()
                if t is not None and t.numel()]
    return out


def _par_differ(torch, trainer) -> list:
    """The state's tensors in which this rank differs from rank 0, bit for
    bit (every rank gets the list)."""
    import torch.distributed as dist

    names, flags = [], []
    for name, t in _par_state(trainer):
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        names.append(name)
        flags.append(float(not torch.equal(ref.view(torch.uint8),
                                           t.detach().view(torch.uint8))))
    bad = torch.tensor(flags, device=DEVICE)
    dist.all_reduce(bad)
    return [n for n, f in zip(names, bad.tolist()) if f]


def _par_counts() -> dict:
    got = _int8_launches()
    from spatialvae_torch.kernels import fused_decoder as fd

    got["k12_keys"] = dict(fd.LAUNCHES)
    return got


def _par_steps(torch, trainer, data, noises, rows) -> list:
    """PAR_STEPS steps of the first PAR_STEPS * PAR_B images and the tail
    (the rest) with the given noise: on a mesh each rank's ``rows`` of
    each full batch, the tail whole (the replicated step)."""
    data_t = trainer._dataset_yt(data)
    xq, sx = trainer._dataset_yq8(data)
    out = []
    for k, noise in enumerate(noises):
        idx = torch.arange(k * PAR_B, min((k + 1) * PAR_B, data.shape[0]),
                           device=DEVICE)
        if len(idx) == PAR_B:
            idx, noise = idx[rows], noise[rows]
            out.append(trainer.train_step(data[idx], y_t=data_t[idx],
                                          y_q8=(xq[idx], sx), noise=noise))
        else:
            out.append(trainer.train_step(
                data[idx], noise=noise,
                replicated=trainer.mesh is not None))
    return [a.float().cpu() for a in out]


def _par_grads(torch, trainer, data, noise, rows) -> dict:
    """A full batch's gradients (the first PAR_B images) at the trainer's
    state, reduced over the mesh (``spmd``'s average) when it has one."""
    from spatialvae_torch.parallel import spmd

    data_t = trainer._dataset_yt(data)
    xq, sx = trainer._dataset_yq8(data)
    idx = torch.arange(PAR_B, device=DEVICE)[rows]
    aux, grads = trainer.local_gradients(
        data[idx], y_t=data_t[idx], y_q8=(xq[idx], sx), noise=noise[rows])
    if trainer.mesh is not None:
        aux, grads = spmd._reduced(aux, grads, trainer.mesh.axis("data"))
    return {k: g.detach().clone() for k, g in grads.items()}


def _par_dp_rank(rank: int, store: str, out: str) -> None:
    """Arms (a), (c) and (d) on a (2, 1) mesh; rank 0 also runs the one
    device trainers they are held to."""
    import torch

    from spatialvae_torch.parallel import MeshConfig, create_mesh
    from spatialvae_torch.parallel.sharding import batch_sharding

    _par_world(rank, 2, store)
    res = {}
    mesh = create_mesh(MeshConfig(2, 1), torch.device(DEVICE))
    rows = batch_sharding(mesh).rows(PAR_B)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    n = PAR_STEPS * PAR_B + PAR_TAIL
    data = blob_images(torch, n, gen)
    zdim = Z_DIM + 3
    cpu = torch.Generator().manual_seed(SEED + 2)
    noises = [torch.randn((PAR_B, zdim), generator=cpu).to(DEVICE)
              for _ in range(PAR_STEPS)]
    noises.append(torch.randn((PAR_TAIL, zdim), generator=cpu).to(DEVICE))

    # (c) the evaluation before any step: K4 (int8) / K1 (float) per rank
    for tag, int8 in (("eval_int8", True), ("eval_f32", False)):
        tr = _par_trainer(torch, mesh, int8)
        _reset_all_launches()
        got = tr.eval_epoch(data[:PAR_EVAL], 0)
        torch.cuda.synchronize()
        res[tag] = {"metrics": got, "counts": _par_counts()}
        if rank == 0:
            one = _par_trainer(torch, None, int8)
            res[tag]["one"] = one.eval_epoch(data[:PAR_EVAL], 0)
            del one
        del tr
        torch.cuda.empty_cache()

    # (a) DP: a batch's gradients on the mesh and on one device at the
    # same weights and noise, then the same steps and noise on both; an
    # epoch for the launch counts
    tr = _par_trainer(torch, mesh)
    one = _par_trainer(torch, None) if rank == 0 else None
    res["dp_grads"], res["dp_grads_halves"] = _par_grad_readings(
        torch, tr, one, data, noises[0], rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _local_metrics() as local:
        res["dp_aux"] = _par_steps(torch, tr, data, noises, rows)
    torch.cuda.synchronize()
    res["dp_s_per_step"] = (time.perf_counter() - t0) / len(noises)
    res["dp_aux_local"] = local
    if rank == 0:
        res["one_aux"] = _par_steps(torch, one, data, noises,
                                    slice(0, PAR_B))
        del one
    torch.cuda.empty_cache()
    _reset_all_launches()
    res["dp_epoch"] = tr.train_epoch(data, 0, progress=False)
    torch.cuda.synchronize()
    res["dp_counts"] = _par_counts()
    res["dp_differ"] = _par_differ(torch, tr)
    res["dp_big_leaves"] = _big_leaves(tr)
    res["dp_shadow"] = tr.shadow is not None and tr.qshadow is not None
    del tr
    torch.cuda.empty_cache()

    # (d) colored DP (the fit-noise head, K3's colored cluster passes)
    tr = _par_trainer(torch, mesh, family="colored")
    cgen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    cdata = blob_images(torch, PAR_B, cgen, tr.tcfg.image_shape, 1, False)
    one = _par_trainer(torch, None, family="colored") if rank == 0 else None
    res["colored_grads"], res["colored_grads_halves"] = _par_grad_readings(
        torch, tr, one, cdata, noises[0], rows)
    torch.cuda.synchronize()
    _reset_all_launches()
    aux = _par_steps(torch, tr, cdata, noises[:1], rows)
    torch.cuda.synchronize()
    res["colored_counts"] = _par_counts()
    if rank == 0:
        res["colored_aux"] = (aux, _par_steps(torch, one, cdata, noises[:1],
                                              slice(0, PAR_B)))
    res["colored_differ"] = _par_differ(torch, tr)
    torch.save(res, os.path.join(out, f"dp{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@contextlib.contextmanager
def _local_metrics():
    """A list that gets each data-parallel step's metrics before the mesh
    averages them (rank's rows alone): what a step that forgot the
    reduction would return, the control of arm (a)'s metric limit."""
    from spatialvae_torch.parallel import spmd

    reduced, local = spmd._reduced, []

    def recording(aux, grads, axis):
        local.append(aux.detach().float().cpu())
        return reduced(aux, grads, axis)

    spmd._reduced = recording
    try:
        yield local
    finally:
        spmd._reduced = reduced


def _par_grad_readings(torch, tr, one, data, noise, rows) -> tuple:
    """The mesh trainer's gradients of the first full batch (reduced over
    'data') against the one-device trainer ``one``'s (rank 0; None
    elsewhere) at the same weights and noise, ``_grad_readings`` each:
    against the whole batch's, and against the average of its two halves'
    (the mesh's split run on one device: the int8 encoder's backward
    quantises its cotangent with a scale over the call's rows, the rank's
    half on the mesh)."""
    grads = _par_grads(torch, tr, data, noise, rows)
    if one is None:
        return None, None
    whole = _grad_readings(grads, _par_grads(torch, one, data, noise,
                                             slice(0, PAR_B)))
    halves = [_par_grads(torch, one, data, noise,
                         slice(k * PAR_B // 2, (k + 1) * PAR_B // 2))
              for k in (0, 1)]
    want = {k: ((halves[0][k].float() + halves[1][k].float()) / 2).to(
        halves[0][k].dtype) for k in halves[0]}
    return whole, _grad_readings(grads, want)


def _grad_readings(got: dict, want: dict) -> tuple:
    """(worst max rel, worst mean rel, its leaf) over the leaves."""
    rel, mean_rel, leaf = 0.0, 0.0, ""
    for k in want:
        _, _, r, m = rel_errors(got[k], want[k])
        if r >= rel:
            rel, leaf = r, k
        mean_rel = max(mean_rel, m)
    return rel, mean_rel, leaf


def _par_pixel_rank(rank: int, store: str, out: str) -> None:
    """Arm (b) on a (2, 2) mesh: K3 on each rank's pixel slice against the
    whole call (default numerics and SR), then the pixel step."""
    import torch
    import torch.distributed as dist

    from spatialvae_torch.kernels import fused_loss_int8 as l8
    from spatialvae_torch.kernels.config import Numerics
    from spatialvae_torch.parallel import MeshConfig, create_mesh
    from spatialvae_torch.parallel.pixel import pixel_slice

    _par_world(rank, 4, store)
    res = {}
    mesh = create_mesh(MeshConfig(2, 2), torch.device(DEVICE))
    model = mesh.axis("model")
    hw = IMAGE[0] * IMAGE[1]
    sl = pixel_slice(hw, model)
    fold, coords, ws, yt = _k3_inputs(torch, PAR_K3_B, hw, P_HIDDEN, 3,
                                      torch.bfloat16, SEED + 4)
    part_args = (fold, coords[sl].contiguous(), *ws,
                 yt[..., sl].contiguous(), None, "bernoulli")
    whole_args = (fold, coords, *ws, yt, None, "bernoulli")
    for tag, nm in (("k3", Numerics()), ("k3_sr", Numerics(sr=True))):
        l8.reset_launches()
        with torch.no_grad():
            part, (aq, _) = l8.run_loss_int8(*part_args, numerics=nm,
                                             ints=True, p_base=sl.start)
            torch.cuda.synchronize()
            counts = dict(l8.LAUNCHES)
            summed = [t.clone() for t in part]
            for t in summed:
                dist.all_reduce(t, group=model.group)
            whole, (aq_w, _) = l8.run_loss_int8(*whole_args, numerics=nm,
                                                ints=True)
        names = ("loss", "dfold", "dw1", "db1", "dwht", "dbht")
        outs = [(summed[0][:, 3, 0], whole[0][:, 3, 0])] + list(
            zip(summed, whole))
        res[tag] = {"counts": counts,
                    "aq_differ": int((aq != aq_w[:, sl]).sum()),
                    "rel": {nme: rel_errors(g, w)[2:]
                            for nme, (g, w) in zip(names, outs)}}
    torch.cuda.empty_cache()

    tr = _par_trainer(torch, mesh)
    res["pixel_step"] = tr._spmd_pixel
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    data = blob_images(torch, PAR_STEPS * PAR_B + PAR_TAIL, gen)
    _reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["epoch"] = tr.train_epoch(data, 0, progress=False)
    torch.cuda.synchronize()
    res["s_per_step"] = (time.perf_counter() - t0) / (PAR_STEPS + 1)
    res["counts"] = _par_counts()
    res["differ"] = _par_differ(torch, tr)
    torch.save(res, os.path.join(out, f"px{rank}.pt"))
    dist.destroy_process_group()


def _k3_inputs(torch, b, hw, h, no, wdt, seed):
    """K3's operands at the galaxy shape: a fold, the grid, weights in
    ``wdt``, int8 targets."""
    from spatialvae_torch.transforms.coords import coord_grid

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def r(*shape, s=1.0):
        return s * torch.randn(shape, generator=g, device=DEVICE)

    fold = torch.zeros((b, 4, h), device=DEVICE)
    fold[:, :2] = r(b, 2, h, s=0.5)
    fold[:, 2] = r(b, h, s=0.8)
    ws = (r(h, h, s=h ** -0.5).to(wdt), r(h, s=0.1).to(wdt),
          r(no, h, s=h ** -0.5).to(wdt), r(no, s=0.1).to(wdt))
    yt = (torch.randint(0, 256, (b, no, hw), generator=g, device=DEVICE)
          - 128).to(torch.int8)
    return fold, coord_grid(*IMAGE, device=DEVICE), ws, yt


def _par_nccl_arm(torch) -> dict:
    """Arm (e): a one-rank NCCL world in this process: a collective through
    NCCL, and the DP step against the one-device step, bit for bit."""
    import socket

    import torch.distributed as dist

    from spatialvae_torch.parallel import (
        MeshConfig,
        create_mesh,
        init_world,
    )

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    backend = init_world(0, 1, f"tcp://localhost:{port}",
                         torch.device(DEVICE), "nccl")
    try:
        mesh = create_mesh(MeshConfig(1, 1), torch.device(DEVICE))
        x = torch.arange(4.0, device=DEVICE)
        dist.all_reduce(x, group=mesh.axis("data").group)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        data = blob_images(torch, PAR_B + PAR_TAIL, gen)
        cpu = torch.Generator().manual_seed(SEED + 2)
        noises = [torch.randn((k, Z_DIM + 3), generator=cpu).to(DEVICE)
                  for k in (PAR_B, PAR_TAIL)]
        tr = _par_trainer(torch, mesh)
        got = _par_steps(torch, tr, data, noises, slice(0, PAR_B))
        state = {k: v.detach().clone() for k, v in _par_state(tr)}
        del tr
        one = _par_trainer(torch, None)
        want = _par_steps(torch, one, data, noises, slice(0, PAR_B))
        differ = [k for k, v in _par_state(one)
                  if not torch.equal(v.view(torch.uint8),
                                     state[k].view(torch.uint8))]
        same_aux = all(torch.equal(a, b) for a, b in zip(got, want))
        return {"backend": backend, "all_reduce": x.tolist(),
                "differ": differ, "same_aux": same_aux,
                "leaves": len(state)}
    finally:
        dist.destroy_process_group()


def _k3_on_cluster(k3: dict, where: str) -> None:
    if not all(k3[k] >= 1 for k in ("fwd_sm90", "grad_sm90", "dw_sm90")) \
            or any(k3[k] for k in ("fwd", "grad", "dw")):
        raise AssertionError(f"{where}: K3 not on the cluster passes alone: "
                             f"{k3}")


def _par_check_launches(dp: list, px: list) -> None:
    """Each rank's launches, counted from 0 before each path and read after
    it (the mesh's own run: the one-device references run outside the
    window): K3 on the cluster keys alone in the DP, colored DP, slice and
    pixel steps; the DP tail's K4/K5; Adam's step kernel every step; the
    evaluations' K4 (int8) or K1 (float), never K3; every rank of a mesh
    the same counts."""
    for tag in ("dp_counts", "colored_counts", "eval_int8", "eval_f32"):
        got = [d[tag] if tag.endswith("counts") else d[tag]["counts"]
               for d in dp]
        if any(c != got[0] for c in got[1:]):
            raise AssertionError(f"{tag}: the ranks' launches differ: {got}")
    for tag in ("k3", "k3_sr"):
        if any(d[tag]["counts"] != px[0][tag]["counts"] for d in px):
            raise AssertionError(f"{tag}: the ranks' launches differ")
    if any(d["counts"] != px[0]["counts"] for d in px):
        raise AssertionError("pixel step: the ranks' launches differ")
    for r, d in enumerate(dp):
        for tag in ("dp_counts", "colored_counts"):
            _k3_on_cluster(d[tag]["k3"], f"{tag} rank {r}")
        k45 = d["dp_counts"]["k45"]
        if not (k45["fwd_acts_sm90"] >= 1 and k45["bwd_grad_sm90"] >= 1):
            raise AssertionError(f"DP rank {r}: the tail ran no K4/K5: {k45}")
        if not d["dp_counts"]["adam"]["adam_step"] >= PAR_STEPS + 1:
            raise AssertionError(f"DP rank {r}: Adam {d['dp_counts']}")
        for tag in ("eval_int8", "eval_f32"):
            c = d[tag]["counts"]
            ran = (c["k45"]["fwd_sm90"] + c["k45"]["fwd"]
                   if tag == "eval_int8" else c["k12"])
            if ran < 3 or any(c["k3"].values()):
                raise AssertionError(f"{tag} rank {r}: launches {c}")
    for r, d in enumerate(px):
        for tag in ("k3", "k3_sr"):
            _k3_on_cluster(d[tag]["counts"], f"{tag} rank {r}")
        _k3_on_cluster(d["counts"]["k3"], f"pixel step rank {r}")


def phase_parallel(torch, card: str) -> dict:
    """[parallel]: the port's mesh on the one card (module docstring)."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_par_dp_rank, args=(os.path.join(tmp, "dp_store"), tmp),
                 nprocs=2)
        dp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mp.spawn(_par_pixel_rank, args=(os.path.join(tmp, "px_store"), tmp),
                 nprocs=4)
        px_s = time.perf_counter() - t0
        dp = [torch.load(os.path.join(tmp, f"dp{r}.pt"), weights_only=False)
              for r in range(2)]
        px = [torch.load(os.path.join(tmp, f"px{r}.pt"), weights_only=False)
              for r in range(4)]
    cluster = ("fwd_sm90", "grad_sm90", "dw_sm90")
    _par_check_launches(dp, px)

    # (a) DP
    for r, d in enumerate(dp):
        if d["dp_differ"]:
            raise AssertionError(f"DP rank {r} differs from rank 0 in "
                                 f"{d['dp_differ'][:5]}")
        if not (d["dp_shadow"] and d["dp_big_leaves"] == 2):
            raise AssertionError("the DP step did not run the shadow and "
                                 "the int8 encoder copies")
        if not np.isfinite(d["dp_epoch"]).all():
            raise AssertionError(f"DP epoch not finite: {d['dp_epoch']}")
    rel, mean_rel, leaf = dp[0]["dp_grads_halves"]
    if not (rel <= INT8_STEP_TOL[0] and mean_rel <= INT8_STEP_TOL[1]):
        raise AssertionError(f"DP gradients vs one device's halves: {rel} "
                             f"({leaf}), mean {mean_rel}; limits "
                             f"{INT8_STEP_TOL}")
    w_rel, w_mean, w_leaf = dp[0]["dp_grads"]

    def metric_rel(got, want):
        return [float(((a - b).abs() / b.abs()).max())
                for a, b in zip(got, want)]

    def within(readings):
        return all(v <= PAR_METRIC_TOL[min(k, 1)]
                   for k, v in enumerate(readings))

    aux_steps = metric_rel(dp[0]["dp_aux"], dp[0]["one_aux"])
    control = metric_rel(dp[0]["dp_aux_local"], dp[0]["one_aux"])
    aux_rel = max(aux_steps)
    if len(control) != PAR_STEPS or not within(aux_steps) or within(control):
        raise AssertionError(
            f"DP step metrics vs one device {aux_steps}, unreduced control "
            f"{control}: the limits {PAR_METRIC_TOL} (first step, later "
            f"ones) must pass the first and refuse the second")
    log("parallel", arm="a_dp", mesh="2x1", backend="gloo",
        ranks_bit_identical=True, k3_cluster=json.dumps(
            {k: dp[0]["dp_counts"]["k3"][k] for k in cluster}),
        k45_tail=dp[0]["dp_counts"]["k45"]["fwd_acts_sm90"],
        grads_vs_halves_max_rel=f"{rel:.3e}", grads_vs_halves_mean_rel=
        f"{mean_rel:.3e}", worst_leaf=leaf, limits=INT8_STEP_TOL,
        grads_vs_whole_max_rel=f"{w_rel:.3e}",
        grads_vs_whole_mean_rel=f"{w_mean:.3e}", whole_worst_leaf=w_leaf,
        metrics_vs_one_max_rel=f"{aux_rel:.3e}",
        metrics_per_step="/".join(f"{v:.3e}" for v in aux_steps),
        unreduced_control="/".join(f"{v:.3e}" for v in control),
        metrics_limit=PAR_METRIC_TOL, launches_every_rank_equal=True,
        epoch_elbo=f"{dp[0]['dp_epoch'][0]:.4f}",
        s_per_step=f"{dp[0]['dp_s_per_step']:.4f}",
        note="ranks share one card: not a speed figure", card=repr(card))

    # (c) mesh evaluation
    for tag, key in (("eval_int8", "k45"), ("eval_f32", "k12_keys")):
        got, want = dp[0][tag]["metrics"], dp[0][tag]["one"]
        erel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if not erel <= PAR_EVAL_TOL[tag]:
            raise AssertionError(f"{tag}: mesh {got} vs one device {want}")
        log("parallel", arm=f"c_{tag}", metrics=json.dumps(got),
            one_device=json.dumps(want), max_rel=f"{erel:.3e}",
            limit=PAR_EVAL_TOL[tag],
            launches_rank0=json.dumps(dp[0][tag]["counts"]["k45"]
                                      if key == "k45" else
                                      dp[0][tag]["counts"]["k12_keys"]))

    # (d) colored DP
    rel, mean_rel, leaf = dp[0]["colored_grads_halves"]
    if not (rel <= INT8_STEP_TOL[0] and mean_rel <= INT8_STEP_TOL[1]):
        raise AssertionError(f"colored DP gradients vs one device's halves: "
                             f"{rel} ({leaf}), mean {mean_rel}")
    w_rel, w_mean, w_leaf = dp[0]["colored_grads"]
    for r, d in enumerate(dp):
        if d["colored_differ"]:
            raise AssertionError(f"colored rank {r} differs: "
                                 f"{d['colored_differ'][:5]}")
    log("parallel", arm="d_colored_dp", mesh="2x1",
        grads_vs_halves_max_rel=f"{rel:.3e}",
        grads_vs_halves_mean_rel=f"{mean_rel:.3e}", worst_leaf=leaf,
        grads_vs_whole_max_rel=f"{w_rel:.3e}",
        grads_vs_whole_mean_rel=f"{w_mean:.3e}", whole_worst_leaf=w_leaf,
        k3_cluster=json.dumps({k: dp[0]["colored_counts"]["k3"][k]
                               for k in cluster}), ranks_bit_identical=True,
        launches_every_rank_equal=True)

    # (b) pixel slices and the pixel step
    for r, d in enumerate(px):
        for tag in ("k3", "k3_sr"):
            for nme, (mx, mean) in d[tag]["rel"].items():
                if not (mx <= INT8_TOL[0] and mean <= INT8_TOL[1]):
                    raise AssertionError(f"{tag} rank {r} {nme}: slices "
                                         f"summed vs whole {mx}, {mean}")
            if d[tag]["aq_differ"]:
                raise AssertionError(f"{tag} rank {r}: {d[tag]['aq_differ']}"
                                     f" aq words differ from the whole "
                                     f"call's")
        if not d["pixel_step"] or d["differ"]:
            raise AssertionError(f"pixel rank {r}: step {d['pixel_step']}, "
                                 f"differs in {d['differ'][:5]}")
        if not np.isfinite(d["epoch"]).all():
            raise AssertionError(f"pixel epoch not finite: {d['epoch']}")
    for tag in ("k3", "k3_sr"):
        log("parallel", arm=f"b_{tag}_slices", mesh="2x2",
            pixels_per_rank=IMAGE[0] * IMAGE[1] // 2, images=PAR_K3_B,
            aq_words_differ=sum(d[tag]["aq_differ"] for d in px),
            **{f"{n}_max_rel": f"{max(d[tag]['rel'][n][0] for d in px):.3e}"
               for n in px[0][tag]["rel"]}, limits=INT8_TOL)
    log("parallel", arm="b_pixel_step", mesh="2x2", ranks_bit_identical=True,
        k3_cluster=json.dumps({k: px[0]["counts"]["k3"][k]
                               for k in cluster}),
        epoch_elbo=f"{px[0]['epoch'][0]:.4f}",
        s_per_step=f"{px[0]['s_per_step']:.4f}",
        note="four ranks share one card: not a speed figure")

    # (e) one-rank NCCL world
    e = _par_nccl_arm(torch)
    if not (e["backend"] == "nccl" and e["all_reduce"] == [0.0, 1.0, 2.0,
                                                           3.0]
            and not e["differ"] and e["same_aux"]):
        raise AssertionError(f"NCCL arm: {e}")
    log("parallel", arm="e_nccl_one_rank", backend=e["backend"],
        dp_step_vs_one_device="bit_identical", leaves=e["leaves"])
    log("parallel", seconds=f"{time.perf_counter() - t_phase:.3f}",
        dp_world_s=f"{dp_s:.3f}", pixel_world_s=f"{px_s:.3f}")
    return {"dp": dp, "px": px}


def main() -> int:
    if sys.argv[1:] == ["--default-width-times"]:
        # a turn of the A/B: the port of the checkout in the working
        # directory, whichever tree this file lies in
        sys.path.insert(0, os.getcwd())
        print(json.dumps(default_width_times()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 2
    from spatialvae_torch.precision import pin_fp32_precision

    pin_fp32_precision()
    kind, card = phase_device(torch)
    if sys.argv[1:2] == ["--default-width"]:
        return phase_default_width_ab(sys.argv[2:])
    if sys.argv[1:2] == ["--sass"]:
        return phase_sass(sys.argv[2:])
    phase_build()
    if sys.argv[1:] == ["--limits"]:
        phase_limits(torch)
        phase_limits_numerics(torch)
        phase_limits_wide(torch)
        phase_limits_dec90(torch)
        return 0
    if sys.argv[1:] == ["--limits", "k3"]:
        phase_limits_k3(torch)
        return 0
    if sys.argv[1:] == ["--limits", "numerics"]:
        phase_limits_numerics(torch)
        return 0
    if sys.argv[1:] == ["--limits", "wide"]:
        phase_limits_wide(torch)
        return 0
    if sys.argv[1:] == ["--limits", "probes"]:
        phase_limits_probes(torch)
        return 0
    if sys.argv[1:] == ["--limits", "kernel_bench"]:
        phase_limits_kernel_bench(torch)
        return 0
    if sys.argv[1:] == ["--limits", "dec90"]:
        phase_limits_dec90(torch)
        return 0
    if sys.argv[1:] == ["--limits", "adam"]:
        phase_limits_adam(torch)
        return 0
    if sys.argv[1:] == ["--limits", "int8_90"]:
        phase_limits_int8_90(torch)
        return 0
    if sys.argv[1:] == ["--split", "dec90"]:
        phase_split_dec90(torch)
        return 0
    if sys.argv[1:] == ["--sweep", "dec90"]:
        phase_sweep_dec90(torch)
        return 0
    if sys.argv[1:] == ["--sweep", "k3"]:
        phase_sweep_k3(torch)
        return 0
    if sys.argv[1:] == ["--sweep", "k45"]:
        phase_sweep_k45(torch)
        return 0
    if sys.argv[1:] == ["--phase", "cli_particles"]:
        with tempfile.TemporaryDirectory() as tmpdir:
            phase_cli_particles(torch, tmpdir, card)
        return 0
    if sys.argv[1:] == ["--phase", "cli_images"]:
        with tempfile.TemporaryDirectory() as tmpdir:
            phase_cli_images(torch, tmpdir, card)
        return 0
    if sys.argv[1:] == ["--phase", "horizon"]:
        phase_horizon_kernels(torch)
        phase_horizon(torch, card)
        return 0
    if sys.argv[1:] == ["--phase", "parallel"]:
        phase_parallel(torch, card)
        return 0
    ptxas = start_ptxas_report(LOSS90_SOURCE)
    ptxas_sr = start_ptxas_report(LOSS90_SR_SOURCE)
    ptxas_wide = start_ptxas_report(LOSS90_WIDE_SOURCE)
    ptxas_dec = start_ptxas_report(DEC90_SOURCE)
    ptxas_deep = start_ptxas_report(DEC90_DEEP_SOURCE)
    ptxas_adam = start_ptxas_report(ADAM90_SOURCE)
    ptxas_i8 = start_ptxas_report(INT8_90_SOURCE)
    ptxas_i8p = start_ptxas_report(INT8_90_SOURCE,
                                   I8_90_TIMING["pingpong"])
    ptxas_i8w = start_ptxas_report(INT8_90_WIDE_SOURCE)
    i8_timing = start_int8_timing_builds()
    from spatialvae_torch.kernels import fused_decoder as fd

    res = phase_kernels(torch)
    bwd = phase_backward(torch)
    res["ab_counts"] = dict(fd.LAUNCHES)
    res["dec90"] = phase_dec90(torch, ptxas_dec, ptxas_deep)
    res["k3_sm90"] = phase_k3_sm90(torch, ptxas, ptxas_sr, ptxas_wide)
    res["int8"] = phase_int8_kernels(torch)
    res["int8_sm90"] = phase_int8_sm90(torch, ptxas_i8, ptxas_i8p,
                                       i8_timing, ptxas_i8w)
    res["eval_ab"] = phase_eval_int8_ab(torch)
    res["families"] = phase_loss_families(torch)
    res["sr"] = phase_loss_sr(torch)
    res["numerics"] = phase_loss_numerics(torch)
    res["t"] = phase_loss_t(torch)
    from spatialvae_torch.kernels import adam as ka

    res["adam90"] = phase_adam90(torch, ptxas_adam)
    ka.reset_launches()
    res["adam"] = phase_adam_kernels(torch)
    res["adam_emit"] = phase_adam_emit_kernels(torch)
    res["adam_ab"] = dict(ka.LAUNCHES)
    from spatialvae_torch.kernels import fused_loss_int8 as l8

    from spatialvae_torch.kernels import fused_decoder_int8 as d8

    fd.reset_launches()
    l8.reset_launches()
    d8.reset_launches()
    res["wide"] = phase_kernel_wide(torch)
    res["wide_ab"] = dict(fd.LAUNCHES)
    # the block passes' K4/K5 launches past 512: their checks and turns
    res["wide_ab_k45"] = dict(d8.LAUNCHES)
    res["k3_wide_turns"] = phase_k3_wide_turns(torch)
    # the block passes' K3 launches past 512: their checks and turns alone
    res["wide_ab_k3"] = dict(l8.LAUNCHES)
    res["levers"] = phase_loss_levers(torch)
    res["probes"] = phase_probes(torch)
    res["kernel_bench"] = phase_kernel_bench(torch)
    log_default_width(res, bwd)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches = phase_slice(torch, tmpdir)
        counts, step_ms = phase_train(torch, tmpdir)
        i8 = phase_train_int8(torch, tmpdir)
        fam = {name: phase_train_family(torch, name, tmpdir)
               for name in FAMILY_MODELS}
        fam_counts = {name: r[0] for name, r in fam.items()}
        res["fam_prof"] = {name: r[1] for name, r in fam.items()}
        knobs = {tag: phase_train_knobs(torch, tag, env, on_grid, kernel)
                 for tag, env, on_grid, kernel in KNOB_PATHS}
        tw = phase_train_wide(torch)
        wide_launches = phase_slice_wide(torch, tmpdir, tw)
        td = phase_train_deep(torch)
        deep_launches = phase_slice_deep(torch, tmpdir, td)
        phase_cli_particles(torch, tmpdir, card)
        phase_cli_images(torch, tmpdir, card)
    phase_horizon_kernels(torch)
    phase_horizon(torch, card)
    phase_parallel(torch, card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    rows = kernel_rows(torch, res, bwd, launches, counts, step_ms, i8,
                       fam_counts, knobs)
    rows += wide_rows(res["wide"], tw, wide_launches, res["levers"],
                      knobs["train_int8_levers"], res["wide_ab"],
                      res["wide_ab_k3"], res["wide_ab_k45"])
    rows += deep_rows(res, bwd, td, deep_launches)
    rows += res["probes"]
    rows += res["kernel_bench"]
    for r in rows:
        if len(r) > 9:      # a yardstick: off every path, run by its A/B
            if r[3] or r[9] < 1:
                raise AssertionError(f"{r[0]}: {r[3]} launches on the "
                                     f"paths, {r[9]} in its A/B")
        elif r[3] < 1:
            raise AssertionError(f"{r[0]} was not launched on its path")
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": nl, "max_abs_err": err, "ms": ms, "plain_ms": pms,
         "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib,
         **({"ab_launches": ab[0]} if ab else {})}
        for n, src, rep, nl, err, ms, pms, bd, lib, *ab in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
