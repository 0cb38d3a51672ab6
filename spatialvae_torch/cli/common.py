"""Shared CLI plumbing — counterpart of ``spatialvae_tpu/cli/common.py``,
and the epoch loop and end-of-run save that the galaxy and mnist CLIs share
(``image_epochs``, ``save_image_run``; the JAX package writes them out in
each CLI).

Flag spellings: the reference's mnist/galaxy CLIs use underscores
(``--z_dim``) and its particles CLI dashes (``--z-dim``); every long flag
here registers both (``add_arg``), so either works on any CLI.

Device flag (``-d``): -1 runs on the CPU, -2 (the default) on the CUDA
card, N >= 0 on card N.  Without a card, -2 and N raise: nothing falls
back to the CPU.

The JAX package's additive flags are all accepted.  Those whose module the
port does not have yet raise ``NotImplementedError`` naming the ROADMAP
item before any work (``refuse_unported``): ``--mesh-model`` above 1 and
the three multi-host flags (M10), and ``--matmul-precision`` other than
``highest`` (the port computes float32 products in full float32 only).
``--tp-mode`` is accepted only so that command lines written for the JAX
CLI keep working: it lays out a mesh the port does not build, and is read
nowhere.

The run diagnostics: ``--debug-nans`` makes every training step check its
loss terms and gradients before Adam writes and raise
``FloatingPointError`` at the first non-finite one (``Trainer(...,
debug_nans=True)``; the JAX CLI turns on ``jax_debug_nans``);
``--profile-dir DIR`` traces the training chunk that holds epoch index 1,
with the evaluation and dumps that follow it, under ``torch.profiler``
(CPU, and on the card CUDA activities) into a Chrome trace in DIR, as the
JAX CLI traces the same span (``chunked_epochs``).
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import torch


def add_arg(parser: argparse.ArgumentParser, name: str, *aliases, **kwargs):
    """Register a long flag under both dash and underscore spellings."""
    names = [name, *aliases]
    spellings = []
    for n in names:
        spellings.append(n)
        if n.startswith("--"):
            alt = ("--" + n[2:].replace("_", "-") if "_" in n
                   else "--" + n[2:].replace("-", "_"))
            if alt != n and alt not in spellings:
                spellings.append(alt)
    return parser.add_argument(*spellings, **kwargs)


def add_common_extras(parser: argparse.ArgumentParser):
    """The JAX package's additive flags, beyond the reference surface."""
    add_arg(parser, "--seed", type=int, default=0,
            help="seed of the weights and of every random draw")
    add_arg(parser, "--compute-dtype", choices=["float32", "bfloat16"],
            default="float32",
            help="forward/backward compute precision")
    add_arg(parser, "--matmul-precision",
            choices=["default", "high", "highest"], default="highest",
            help="float32 product precision; the port runs 'highest' only")
    add_arg(parser, "--profile-dir", default=None,
            help="trace the training of epoch index 1 (with the evaluation "
                 "after it) into a Chrome trace in this directory")
    add_arg(parser, "--mesh-model", type=int, default=1,
            help="model/pixel mesh axis size (above 1 not ported yet, "
                 "ROADMAP M10)")
    add_arg(parser, "--coordinator", default=None,
            help="multi-host coordinator host:port (not ported yet, "
                 "ROADMAP M10)")
    add_arg(parser, "--num-processes", type=int, default=None,
            help="multi-host process count (not ported yet, ROADMAP M10)")
    add_arg(parser, "--process-id", type=int, default=None,
            help="multi-host process index (not ported yet, ROADMAP M10)")
    add_arg(parser, "--tp-mode", choices=["column", "row"],
            default="column",
            help="accepted so that command lines written for the JAX "
                 "CLI keep working; the port builds no mesh (M10) and "
                 "reads it nowhere")
    add_arg(parser, "--eval-interval", type=int, default=1,
            help="evaluate every N epochs instead of every epoch; the "
                 "training trajectory is the same")
    add_arg(parser, "--no-fused", action="store_true",
            help="decode with the plain decoder, not the hand-written "
                 "kernels")
    add_arg(parser, "--int8-decoder", action="store_true",
            help="int8 training stack: the fused int8 loss kernel and the "
                 "int8 decoder")
    add_arg(parser, "--int8-sr", action="store_true",
            help="with --int8-decoder: stochastic rounding at the loss "
                 "kernel's quantisation sites")
    add_arg(parser, "--adam-moments", choices=["f32", "bf16"],
            default="f32",
            help="Adam moment (mu/nu) storage dtype")
    add_arg(parser, "--debug-nans", action="store_true",
            help="stop at the first non-finite loss term or gradient of a "
                 "training step, before Adam writes (FloatingPointError)")
    add_arg(parser, "--resume-generator", default=None,
            help="resume: load generator params from this checkpoint")
    add_arg(parser, "--resume-inference", default=None,
            help="resume: load inference-net params from this checkpoint")
    add_arg(parser, "--save-optimizer", action="store_true",
            help="also checkpoint the Adam state beside the model "
                 "checkpoints, for a faithful resume")
    add_arg(parser, "--resume-optimizer", default=None,
            help="resume: restore the Adam state and epoch index from this "
                 "optimizer checkpoint")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def refuse_unported(args) -> None:
    """Raise on a flag whose module the port does not have yet."""
    if (getattr(args, "mesh_model", 1) or 1) > 1:
        raise _not_ported("--mesh-model above 1 (model parallelism)", "M10")
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag, None) is not None:
            raise _not_ported(f"--{flag.replace('_', '-')} (multi-host)",
                              "M10")
    if getattr(args, "matmul_precision", "highest") != "highest":
        raise NotImplementedError(
            f"--matmul-precision {args.matmul_precision}: the port computes "
            f"float32 products in full float32 ('highest') only")


def resolve_cli_device(flag: int) -> torch.device:
    """The reference's ``-d``: -1 the CPU, -2 the CUDA card, N >= 0 card N.
    Raises without a card unless -1."""
    if flag == -1:
        return torch.device("cpu")
    if flag < -2:
        raise ValueError(f"-d {flag}: expected -1 (CPU), -2 (the card) or "
                         f"a card index")
    if not torch.cuda.is_available():
        raise RuntimeError(f"-d {flag} asks for a CUDA device and none is "
                           f"available; pass -d -1 to run on the CPU")
    if flag == -2:
        return torch.device("cuda")
    if flag >= torch.cuda.device_count():
        raise ValueError(f"-d {flag}: only {torch.cuda.device_count()} "
                         f"CUDA device(s)")
    return torch.device("cuda", flag)


def use_fused(args) -> bool:
    """The hand-written kernels on the card unless --no-fused; -d -1 runs
    the plain decoder, as the JAX CLI does (its kernels are the TPU's)."""
    return not getattr(args, "no_fused", False) and \
        getattr(args, "device", -2) != -1


@contextlib.contextmanager
def env_scope(adam_moments: str = "f32", int8_sr: bool = False):
    """``SPATIALVAE_ADAM_MOMENTS`` set to the run's choice (f32 included),
    and with ``int8_sr`` ``SPATIALVAE_SR=1`` with the knobs allowed, inside
    the block; the caller's settings come back after it, so a run's choice
    never leaks into the next in-process run (the JAX
    ``device_context``)."""
    names = ("SPATIALVAE_ADAM_MOMENTS", "SPATIALVAE_SR",
             "SPATIALVAE_ALLOW_KNOBS")
    saved = {n: os.environ.get(n) for n in names}
    os.environ["SPATIALVAE_ADAM_MOMENTS"] = adam_moments or "f32"
    if int8_sr:
        os.environ["SPATIALVAE_SR"] = "1"
        os.environ["SPATIALVAE_ALLOW_KNOBS"] = "1"
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def make_dataset(y, ctf=None, device=None, preload=True):
    """``ArrayDataset`` on ``device`` (one device; the JAX package's mesh
    sharding is M10), or host-resident with per-step streaming when
    ``preload`` is False (``--no-preload``)."""
    from spatialvae_torch.data.dataset import ArrayDataset

    return ArrayDataset.from_numpy(y, ctf, device=device, preload=preload)


def maybe_resume(trainer, args) -> int:
    """Load generator and inference params (and optionally the Adam state)
    from checkpoints into the trainer; returns the epoch to start from (0
    unless --resume-optimizer carries a later epoch index), so the epoch
    loop and its per-epoch random streams continue the uninterrupted
    trajectory.  Without --resume-optimizer the Adam state starts anew, as
    in JAX."""
    from spatialvae_torch.checkpoint import load_model_meta, load_optimizer
    from spatialvae_torch.io.jax_params import (
        generator_from_jax,
        inference_from_jax,
    )
    from spatialvae_torch.kernels.config import moments_dtype

    # Adam moments belong to the parameters they were optimizing: fresh
    # random parameters with epoch-N moments would be a corrupt resume
    if getattr(args, "resume_optimizer", None) and not (
            getattr(args, "resume_generator", None)
            and getattr(args, "resume_inference", None)):
        raise SystemExit(
            "--resume-optimizer requires BOTH --resume-generator and "
            "--resume-inference (optimizer moments belong to specific "
            "parameters)")
    for flag, kind, net, build in (
            ("resume_generator", "generator", trainer.p_net,
             generator_from_jax),
            ("resume_inference", "inference", trainer.q_net,
             inference_from_jax)):
        path = getattr(args, flag, None)
        if not path:
            continue
        params, _, got, _ = load_model_meta(path)
        if got != kind:
            raise ValueError(f"{path} holds a {got}, not a {kind}")
        cfg = trainer.p_cfg if kind == "generator" else trainer.q_cfg
        net.load_state_dict(build(params, cfg, device="cpu").state_dict())
        print(f"# resumed {'generator' if kind == 'generator' else 'inference net'} "
              f"from {path}")
    # the shadow and qshadow are copies of the old masters: seed anew
    trainer.shadow = trainer.qshadow = None
    start_epoch = 0
    if getattr(args, "resume_optimizer", None):
        state, epoch = load_optimizer(args.resume_optimizer, trainer.q_net,
                                      trainer.p_net, device=trainer.device)
        # the file keeps the saving run's moment dtype; this run's
        # --adam-moments decides (bf16 -> float32 widens exactly)
        mdt = moments_dtype()
        old = {t.dtype for t in (*state.mu.values(), *state.nu.values())}
        if old - {mdt}:
            name = lambda d: str(d).replace("torch.", "")  # noqa: E731
            print(f"# resumed Adam moments cast "
                  f"{'/'.join(sorted(map(name, old)))} -> {name(mdt)} "
                  f"(--adam-moments)")
            state.mu = {k: t.to(mdt) for k, t in state.mu.items()}
            state.nu = {k: t.to(mdt) for k, t in state.nu.items()}
        trainer.opt_state = state
        start_epoch = epoch + 1
        print(f"# resumed optimizer state from {args.resume_optimizer} "
              f"(continuing at epoch {start_epoch + 1})")
    else:
        trainer.opt_state = trainer.optimizer.init(trainer.named_params())
    return start_epoch


def chunk_len(epoch: int, num_epochs: int, eval_interval: int,
              save_interval=None, profile_epoch=None) -> int:
    """Epochs to train before the next evaluation: capped by the run's end
    and by the next save-interval boundary, so --eval-interval N never
    skips a checkpoint epoch.  While a --profile-dir trace is pending
    (``profile_epoch``), epochs up to and including it run one at a time,
    so the trace holds that one epoch."""
    chunk = max(1, min(eval_interval, num_epochs - epoch))
    if save_interval:
        chunk = min(chunk, save_interval - (epoch % save_interval))
    if profile_epoch is not None and epoch <= profile_epoch:
        chunk = 1
    return chunk


def train_chunk(trainer, dataset, epoch: int, num_epochs: int,
                eval_interval: int, save_interval=None,
                profile_epoch=None) -> list:
    """Train up to the next evaluation point; returns [(epoch_index, (elbo,
    gen_loss, kl)), ...] for epochs [epoch, epoch + chunk).  One epoch runs
    ``train_epoch`` (with its progress line, the reference's behaviour);
    more run ``train_epochs`` (the same trajectory)."""
    chunk = chunk_len(epoch, num_epochs, eval_interval, save_interval,
                      profile_epoch)
    if chunk == 1:
        return [(epoch, trainer.train_epoch(dataset, epoch))]
    rows = trainer.train_epochs(dataset, epoch, chunk)
    return [(epoch + i, tuple(float(v) for v in row))
            for i, row in enumerate(rows)]


PROFILE_EPOCH = 1       # the epoch index --profile-dir traces (JAX's)


def trace_path(profile_dir: str) -> str:
    """The Chrome trace --profile-dir writes."""
    return os.path.join(profile_dir,
                        f"epoch{PROFILE_EPOCH + 1}.pt.trace.json")


def chunked_epochs(trainer, dataset, start_epoch: int, num_epochs: int,
                   eval_interval, save_interval=None, profile_dir=None):
    """Drive a training run in ``train_chunk`` pieces, yielding (rows,
    next_epoch) per chunk, rows = [(epoch, (elbo, gen, kl)), ...].  With
    ``profile_dir`` the chunk holding epoch index 1 (a single epoch, see
    ``chunk_len``) runs under ``torch.profiler``; the trace stops when the
    caller resumes the generator, so the caller's evaluation and dumps
    after that chunk are in it, and is written to ``trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    eval_interval = max(1, eval_interval or 1)
    profile_epoch = PROFILE_EPOCH if profile_dir is not None else None
    cuda = trainer.device.type == "cuda"
    epoch = start_epoch
    while epoch < num_epochs:
        prof = None
        if profile_dir is not None and epoch <= profile_epoch < \
                epoch + chunk_len(epoch, num_epochs, eval_interval,
                                  save_interval, profile_epoch):
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
        try:
            rows = train_chunk(trainer, dataset, epoch, num_epochs,
                               eval_interval, save_interval, profile_epoch)
            epoch = rows[-1][0] + 1
            yield rows, epoch
        finally:
            if prof is not None:
                if cuda:
                    torch.cuda.synchronize(trainer.device)
                prof.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                t0 = time.perf_counter()
                prof.export_chrome_trace(trace_path(profile_dir))
                print(f"# wrote the trace of epoch {PROFILE_EPOCH + 1} to "
                      f"{trace_path(profile_dir)} "
                      f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr)


def resolve_activation_name(cli_choice: str, trainer: str) -> str:
    """Per-CLI activation dispatch of the reference.  mnist/particles:
    'tanh' -> tanh, 'relu' -> leakyrelu (torch LeakyReLU).  galaxy: 'tanh'
    -> tanh, 'relu' -> relu, 'sigmoid' -> sigmoid, and 'leakyrelu' falls
    through to tanh (the reference's dispatch tests the misspelling
    'leakrelu'; kept, as in the JAX package)."""
    if trainer in ("mnist", "particles"):
        return {"tanh": "tanh", "relu": "leakyrelu"}[cli_choice]
    if trainer == "galaxy":
        return {"tanh": "tanh", "relu": "relu", "sigmoid": "sigmoid",
                "leakyrelu": "tanh"}.get(cli_choice, "tanh")
    raise ValueError(trainer)


RESULTS_HEADER = "\t".join(["Epoch", "ELBO", "BCE loss", "KL"])


def image_epochs(trainer, data_train, data_val, args, start_epoch: int,
                 dump) -> tuple:
    """The galaxy and mnist CLIs' epoch loop: train in ``chunked_epochs``
    pieces, print each training row, evaluate after each chunk (z scaled
    to 0 during ``--z_delay``; mnist has no such flag), call ``dump(
    epoch_str, z_scale)`` every ``--save_interval`` epochs and print the
    validation row.  Rows are ``epoch - 1`` (0-based) then (ELBO, BCE, KL).
    Returns (train rows, validation rows, train lines, validation lines),
    each list of lines headed by ``RESULTS_HEADER``."""
    num_epochs = args.num_epochs
    digits = int(math.log10(num_epochs)) + 1
    print(RESULTS_HEADER)
    train_results, val_results = [], []
    train_lines, val_lines = [RESULTS_HEADER], [RESULTS_HEADER]
    for rows, epoch in chunked_epochs(
            trainer, data_train, start_epoch, num_epochs,
            args.eval_interval, args.save_interval, args.profile_dir):
        for e, tr in rows:
            row = [e, *tr]
            train_results.append(row)
            line = "\t".join(map(str, row))
            train_lines.append(line)
            print(line, flush=True)
        z_scale = 0.0 if (epoch - 1) < getattr(args, "z_delay", 0) else 1.0
        va = trainer.eval_epoch(data_val, epoch - 1, z_scale=z_scale)
        if epoch % args.save_interval == 0:
            dump(str(epoch).zfill(digits), z_scale)
        row = [epoch - 1, *va]
        val_results.append(row)
        line = "\t".join(map(str, row))
        val_lines.append(line)
        print(line, flush=True)
    return train_results, val_results, train_lines, val_lines


def save_image_run(trainer, args, outputs, results: tuple) -> None:
    """The end of a galaxy or mnist run: both networks into
    ``outputs.trained_dir`` (blocking: the archive must hold them), the Adam
    state with ``--save-optimizer`` (only with a prefix: without one there
    are no model checkpoints to pair it with), the three plots and the
    results files.  ``results`` is ``image_epochs``' return."""
    from spatialvae_torch.train.checkpoint import (
        optimizer_path,
        save_optimizer,
        save_trained_models,
    )
    from spatialvae_torch.train.plots import basic_run_plot

    train_results, val_results, train_lines, val_lines = results
    last = args.num_epochs - 1
    digits = int(math.log10(args.num_epochs)) + 1
    save_trained_models(args.save_prefix, last, digits, 1,
                        outputs.trained_dir, trainer.p_net, trainer.q_net,
                        async_write=False, elbo=trainer.ecfg,
                        image_shape=trainer.tcfg.image_shape)
    if args.save_optimizer and not args.save_prefix:
        print("# WARNING: --save-optimizer ignored: no --save_prefix, so "
              "there are no model checkpoints for the optimizer state to "
              "pair with", file=sys.stderr)
    if args.save_optimizer and args.save_prefix:
        save_optimizer(optimizer_path(args.save_prefix, last, digits,
                                      outputs.trained_dir),
                       trainer.opt_state, last, trainer.q_net, trainer.p_net)
    basic_run_plot(train_results, val_results, output_dir=outputs.images_dir)
    outputs.write_results(train_lines, val_lines)
