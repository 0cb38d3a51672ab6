#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``spatialvae_torch/kernels/csrc``,
holds each kernel against its plain PyTorch version on the card, then serves
the galaxy model (64x64 RGB, z=20, encoder 12288->5000->5000->46, spatial
decoder 500 wide, 2 layers, 3 outputs, Bernoulli; float32; random weights
from a seed) through ``spatialvae_torch.api.SpatialVae``: checkpoint write
and load, encode, reconstruct, reconstruct_canonical, sample and a 437-image
evaluation, with every output checked.  Each phase prints one line; the last
three lines are the per-kernel JSON record, the card's name and power limit,
and ``{"ok": true, ...}``.  A last pass of the requests runs under
``torch.profiler`` for the card's busy time and idle share in it.

Needs a CUDA device and ``nvcc``; imports no JAX.  Exits non-zero, without
the final line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
# Kernel vs plain version: limits on the largest and on the mean absolute
# error, by weight dtype.  On the card (PERF.md, Findings) the sound kernel
# read max <= 9.6e-7 and mean <= 1.9e-7 in f32, max <= 2.5e-4 and mean
# <= 1.9e-6 with bf16 weights; copies of it with one TF32 pass or unsplit
# activations read max >= 3.3e-5 and mean >= 6.4e-6, and copies without
# the bf16 activation casts mean >= 2.5e-5.
TOL = {"float32": (5e-6, 1e-6), "bfloat16": (5e-4, 1e-5)}
N_TIMED = 10
N_PASSES = 5        # timed passes of the slice's requests
KERNEL_SOURCE = "spatialvae_torch/kernels/csrc/fused_decoder_fwd.cu"
KERNEL_REPLACES = "spatialvae_tpu/kernels/fused_decoder.py:105"

# galaxy: README `train_galaxy.py ... -z 20`, bench.py's default config
IMAGE = (64, 64)
CHANNELS = 3
Z_DIM = 20
Q_HIDDEN = 5000
P_HIDDEN = 500
BATCH = 100
N_EVAL = 437        # 4 full batches of 100 and a tail of 37


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
    from spatialvae_torch.kernels.fused_decoder import MAX_HIDDEN

    t0 = time.perf_counter()
    path = _build.build()
    lib = _build.load_library()
    seconds = time.perf_counter() - t0
    if lib.svt_fused_decoder_max_hidden() != MAX_HIDDEN:
        raise RuntimeError("kernel and wrapper disagree on MAX_HIDDEN")
    log("build", seconds=f"{seconds:.2f}", library=path.name)


def _tail_inputs(torch, b, hw, h, lh, no, wdt, gen):
    from spatialvae_torch.transforms.coords import coord_grid

    side = int(math.isqrt(hw))
    if side * side != hw:
        raise ValueError(f"case needs a square image, got HW={hw}")
    dev = "cuda"

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
    weights packed once, as the slice runs it."""
    from spatialvae_torch.kernels.fused_decoder import (
        TailWeights,
        decoder_tail_reference,
        fused_decoder_tail,
        run_decoder_tail,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        # name, B, HW, H, Lh, No, resid, weight dtype
        ("galaxy_f32", BATCH, 4096, P_HIDDEN, 1, 3, False, torch.float32),
        ("galaxy_bf16", BATCH, 4096, P_HIDDEN, 1, 3, False, torch.bfloat16),
        ("lh3_resid", 16, 4096, P_HIDDEN, 3, 3, True, torch.float32),
        ("hw784_no1", 32, 784, P_HIDDEN, 1, 1, False, torch.float32),
        ("no8", 16, 4096, P_HIDDEN, 1, 8, False, torch.float32),
    ]
    results = {}
    with torch.no_grad():
        for name, b, hw, h, lh, no, resid, wdt in cases:
            args = _tail_inputs(torch, b, hw, h, lh, no, wdt, gen)
            got = fused_decoder_tail(*args, resid)
            torch.cuda.synchronize()
            want = decoder_tail_reference(*args, resid)
            dtype = str(wdt).replace("torch.", "")
            if got.shape != (b, no, hw):
                raise AssertionError(f"{name}: shape {tuple(got.shape)}")
            err, mean_err = check_close(name, got, want, wdt)
            # warm-up, then alternate the two versions
            fold, coords, *weights = args
            packed = TailWeights(*weights)
            run_decoder_tail(fold, coords, packed, resid)
            decoder_tail_reference(*args, resid)
            ks, ps = [], []
            for _ in range(N_TIMED):
                ks.append(cuda_ms(
                    lambda: run_decoder_tail(fold, coords, packed, resid),
                    torch))
                ps.append(cuda_ms(
                    lambda: decoder_tail_reference(*args, resid), torch))
            results[name] = dict(err=err, ms=statistics.median(ks),
                                 plain_ms=statistics.median(ps))
            log("kernel", case=name, B=b, HW=hw, H=h, Lh=lh, No=no,
                resid=resid, dtype=dtype,
                max_abs_err=f"{err:.3e}", mean_abs_err=f"{mean_err:.3e}",
                max_tol=TOL[dtype][0], mean_tol=TOL[dtype][1],
                kernel_ms=f"{results[name]['ms']:.4f}",
                plain_ms=f"{results[name]['plain_ms']:.4f}")
            del args, fold, coords, weights, packed, got, want
    return results


def _check_images(name, t, shape, torch) -> None:
    if tuple(t.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{name}: non-finite values")
    if t.min().item() < 0.0 or t.max().item() > 1.0:
        raise AssertionError(f"{name}: values outside [0, 1]")


def phase_slice(torch, tmpdir: str) -> int:
    """Serve the galaxy model through the API; returns the kernel launches
    counted over the timed passes of the requests."""
    from spatialvae_tpu.core.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_torch import checkpoint
    from spatialvae_torch.api import SpatialVae
    from spatialvae_torch.evaluate import eval_batches
    from spatialvae_torch.kernels.fused_decoder import fused_decoder_tail
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
    from spatialvae_torch.objectives import ElboConfig, elbo_minibatch

    n, m = IMAGE
    hw = n * m
    q_cfg = InferenceConfig(n=hw * CHANNELS, latent_dim=Z_DIM + 3,
                            hidden_dim=Q_HIDDEN, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z_DIM, hidden_dim=P_HIDDEN,
                                   n_out=CHANNELS, num_layers=2)
    ecfg = ElboConfig(rotate=True, translate=True, theta_prior=math.pi,
                      likelihood="bernoulli", channels=CHANNELS, fused=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    q_net = InferenceNetwork(q_cfg, generator=gen, device="cuda")
    p_net = SpatialGenerator(p_cfg, generator=gen, device="cuda")
    gpath = os.path.join(tmpdir, "galaxy_generator_epoch1.sav")
    ipath = os.path.join(tmpdir, "galaxy_inference_epoch1.sav")
    checkpoint.save_model(gpath, "generator", p_net, elbo=ecfg,
                          image_shape=IMAGE)
    checkpoint.save_model(ipath, "inference", q_net, elbo=ecfg,
                          image_shape=IMAGE)
    del q_net, p_net
    model = SpatialVae.load(gpath, ipath, device="cuda")
    log("checkpoint", seconds=f"{time.perf_counter() - t0:.2f}",
        bytes=os.path.getsize(gpath) + os.path.getsize(ipath))

    images = torch.randint(0, 256, (N_EVAL, hw, CHANNELS), generator=gen,
                           device="cuda").float() / 255.0
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
    fused_decoder_tail.launches = 0
    seconds = []
    for _ in range(N_PASSES):
        t0 = time.perf_counter()
        out = requests()
        seconds.append(time.perf_counter() - t0)
    launches = fused_decoder_tail.launches
    decodes = 3 + math.ceil(N_EVAL / BATCH)
    if launches != N_PASSES * decodes:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{N_PASSES} x {decodes} decodes")

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
    noise = torch.randn((BATCH, Z_DIM + 3), generator=gen, device="cuda")
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
    log("slice", passes=N_PASSES, requests_per_pass=n_req,
        images_per_pass=n_img, pass_ms_median=f"{med * 1e3:.4f}",
        pass_ms_min=f"{min(seconds) * 1e3:.4f}",
        pass_ms_max=f"{max(seconds) * 1e3:.4f}",
        requests_per_s=f"{n_req / med:.3f}",
        images_per_s=f"{n_img / med:.1f}", decodes_per_pass=decodes,
        launches=launches, elbo=f"{elbo:.3f}", log_p=f"{log_p:.3f}",
        kl=f"{kl:.3f}", reconstruct_vs_plain=f"{err:.3e}")
    phase_profile(torch, requests, tmpdir)
    return launches


def phase_profile(torch, requests, tmpdir: str) -> None:
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
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("the profiler saw no device activity")
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    k1 = [e["dur"] for e in events if "fused_decoder_fwd" in e["name"]]
    log("profile", wall_ms=f"{wall_us / 1e3:.3f}",
        device_busy_ms=f"{busy / 1e3:.3f}",
        idle_share=f"{1 - busy / wall_us:.4f}",
        k1_ms=f"{sum(k1) / 1e3:.3f}", k1_launches=len(k1),
        k1_share_of_busy=f"{sum(k1) / busy:.4f}",
        device_events=len(events))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 2
    from spatialvae_torch.precision import pin_fp32_precision

    pin_fp32_precision()
    kind, card = phase_device(torch)
    phase_build()
    res = phase_kernels(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches = phase_slice(torch, tmpdir)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    g = res["galaxy_f32"]
    print(json.dumps({"kernels": [{
        "name": "fused_decoder_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": g["err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
