"""The bench's training step under the profiler, its device time split by
kernel -- the port of ``tools/profile_step.py``:

    python -m spatialvae_torch.tools.profile_step [batch=2048] [steps=8]
        [device=cpu]

Builds the bench's galaxy int8 step (64x64x3, z=20, encoder 5,000 wide
with 2 layers, decoder 500 wide with 2 layers, bf16 compute, int8 mode,
Adam at lr 1e-4) on ``batch * steps`` uniform random images made from seed
0, trains one warm-up epoch, then traces one epoch with ``torch.profiler``
and sums the device time of every kernel (and copy) by name: the port's
kernels by their own names (``loss_fwd90``, ``loss_grad90``,
``grouped_dw90``, ``adam_step_kernel``, ...), cuBLAS's GEMMs, PyTorch's
elementwise kernels.  Prints the total and the top 25 in ms per step with
their launches per step.  The card's profiler may drop a session's first
kernels, so the trace opens with a few small kernels of its own and counts
only what the epoch launched (its ``profile_step`` label); the header says
whether every launch was seen.

With ``device=cpu`` it runs the plain versions and splits the CPU time
by operator (self time) instead; ``side=``, ``q_hidden=`` and
``p_hidden=`` narrow the model for a toy run there.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
from collections import defaultdict

import torch

from spatialvae_torch.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_torch.data.dataset import ArrayDataset
from spatialvae_torch.kernels.config import knobs_allowed
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.tools.common import parse_argv
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid

USAGE = ("python -m spatialvae_torch.tools.profile_step [batch=2048] "
         "[steps=8] [device=cpu] [side=64] [q_hidden=5000] [p_hidden=500]")
LABEL = "profile_step"
WARMUP_KERNELS = 32
TOP = 25
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def build(batch: int, steps: int, device, side: int = 64,
          q_hidden: int = 5000, p_hidden: int = 500):
    """(trainer, dataset): the bench's galaxy int8 step on ``batch *
    steps`` images uniform on [0, 1) from seed 0, on ``device``."""
    n = m = side
    channels, z_dim = 3, 20
    q_cfg = InferenceConfig(n=n * m * channels, latent_dim=z_dim + 3,
                            hidden_dim=q_hidden, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=z_dim, hidden_dim=p_hidden,
                                   n_out=channels, num_layers=2)
    ecfg = ElboConfig(rotate=True, translate=True, theta_prior=math.pi,
                      likelihood="bernoulli", channels=channels, fused=True,
                      int8=True)
    tcfg = TrainConfig(minibatch_size=batch, learning_rate=1e-4,
                       num_epochs=3, seed=0, compute_dtype="bfloat16",
                       image_shape=(n, m), channels=channels)
    trainer = Trainer(q_cfg, p_cfg, ecfg, tcfg, coord_grid(n, m),
                      device=device)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    y = torch.rand((batch * steps, n * m, channels), generator=gen,
                   device=trainer.device)
    return trainer, ArrayDataset(y)


def _label_ids(events) -> set:
    """Correlation ids of the runtime calls inside the ``LABEL`` span."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == LABEL]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} {LABEL!r} spans in the trace")
    a0, a1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    return {e["args"].get("correlation") for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and a0 <= e["ts"] <= a1}


def traced_epoch(trainer, dataset, epoch: int) -> dict:
    """One epoch under ``torch.profiler``: {"by_name": name -> (us,
    launches), "total_us", "complete"} over the card's kernels and copies
    of the epoch, or over the CPU operators' self time off the card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = trainer.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            pad = torch.zeros(1, device=trainer.device)
            for _ in range(WARMUP_KERNELS):
                pad.add_(1)
            torch.cuda.synchronize(trainer.device)
        with record_function(LABEL):
            trainer.train_epoch(dataset, epoch, progress=False)
        if cuda:
            torch.cuda.synchronize(trainer.device)
    by_name = defaultdict(lambda: [0.0, 0])
    if not cuda:
        for ev in prof.key_averages():
            if ev.key != LABEL and ev.self_cpu_time_total > 0:
                by_name[ev.key][0] += ev.self_cpu_time_total
                by_name[ev.key][1] += ev.count
        return {"by_name": dict(by_name), "complete": True,
                "total_us": sum(v[0] for v in by_name.values())}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ids = _label_ids(events)
    launched = sum(1 for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("name", "").startswith(("cudaLaunchKernel",
                                                     "cuLaunchKernel"))
                   and e["args"].get("correlation") in ids)
    kernels = 0
    for e in events:
        if e.get("cat") in DEVICE_EVENTS and \
                e["args"].get("correlation") in ids:
            by_name[e["name"]][0] += float(e["dur"])
            by_name[e["name"]][1] += 1
            kernels += e.get("cat") == "kernel"
    return {"by_name": dict(by_name), "complete": kernels >= launched,
            "total_us": sum(v[0] for v in by_name.values())}


def main(argv=None) -> int:
    vals, dev = parse_argv(sys.argv[1:] if argv is None else argv,
                           {"batch": 2048, "steps": 8, "side": 64,
                            "q_hidden": 5000, "p_hidden": 500}, USAGE)
    steps = vals["steps"]
    # a measurement entry point: off-default kernel knobs are allowed while
    # it runs
    with knobs_allowed():
        trainer, dataset = build(vals["batch"], steps, dev, vals["side"],
                                 vals["q_hidden"], vals["p_hidden"])
        trainer.train_epoch(dataset, 0, progress=False)      # warm-up
        got = traced_epoch(trainer, dataset, 1)
    what = "device" if dev.type == "cuda" else "CPU (operator self)"
    total = got["total_us"] / 1e3
    print(f"# total {what} time {total:.1f} ms over {steps} steps "
          f"({total / steps:.2f} ms/step), batch {vals['batch']}, every "
          f"launch traced: {got['complete']}")
    rows = sorted(got["by_name"].items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (us, n) in rows:
        print(f"{us / 1e3 / steps:8.3f} ms/step {n / steps:7.2f}/step  "
              f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
