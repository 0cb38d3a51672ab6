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
port does not have yet raise before any work (``refuse_unported``):
``--mesh-model`` above 1 on a configuration that the pixel step cannot take
(float, colored, vanilla, ``--no-fused`` or ``-d -1``, by the CLI's
``elbo_config`` and ``parallel/pixel.config_refusal``: the JAX CLI sends
those to its GSPMD tensor-parallel path, ROADMAP M10b) raises
``NotImplementedError`` naming M10b (a model axis that the image size or
the batch keeps off the pixel step raises the same from the trainer, once
the images are read), and ``--matmul-precision`` other than
``highest`` (the port computes float32 products in full float32 only)
raises too.  ``--tp-mode`` is accepted so that command lines written for
the JAX CLI keep working; it names a layout of M10b, and is read
nowhere.

Meshes (``parallel/``): the run's world comes from a launcher's environment
(torchrun: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), from the multi-host flags (``--coordinator host:port
--num-processes N --process-id i``, all three: host i starts one rank per
local card, rank i * cards + local rank), or, on the card without either
and with more than one card visible, from the visible cards (one rank
each, started here; JAX's single controller sees them all).  One card and
no launcher runs no mesh, as JAX's one device does.  Each rank joins the
world (NCCL on cards, gloo on the CPU), the mesh is (ranks / model, model)
with ``--mesh-model``, and rank 0 alone prints the TSV and the ``#`` lines
and writes the outputs, the checkpoints and the archive; the others train
silently.  Every rank holds the whole data set (``make_dataset``).

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

from spatialvae_torch.parallel.mesh import primary


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
            help="model (pixel) mesh axis size: the fused int8 loss "
                 "kernel's pixels split over this many ranks (the "
                 "tensor-parallel layouts are ROADMAP M10b)")
    add_arg(parser, "--coordinator", default=None,
            help="multi-host: host 0's host:port (with --num-processes "
                 "and --process-id)")
    add_arg(parser, "--num-processes", type=int, default=None,
            help="multi-host: the number of hosts of the run")
    add_arg(parser, "--process-id", type=int, default=None,
            help="multi-host: this host's index in [0, num-processes)")
    add_arg(parser, "--tp-mode", choices=["column", "row"],
            default="column",
            help="the JAX CLI's tensor-parallel layout, accepted so that "
                 "its command lines keep working (ROADMAP M10b)")
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


MULTIHOST_FLAGS = ("coordinator", "num_processes", "process_id")


def refuse_unported(args, ecfg) -> None:
    """Raise, before any work, on a flag whose path the port does not have
    yet: a model axis on a configuration (``ecfg``, the CLI's
    ``elbo_config``) that the pixel step cannot take whatever its shapes
    (``parallel/pixel.config_refusal``; JAX's GSPMD tensor-parallel path,
    M10b), and on multi-host flags given in part.  The shapes' part of
    the same decision (``pixel_step_refusal``) is the trainer's, once the
    images are read and before anything runs on the device."""
    from spatialvae_torch.parallel.pixel import config_refusal
    from spatialvae_torch.parallel.sharding import tensor_parallel_refusal

    model = getattr(args, "mesh_model", 1) or 1
    why = config_refusal(ecfg) if model > 1 else None
    if why is not None:
        raise tensor_parallel_refusal(f"--mesh-model {model} with {why}")
    given = [f for f in MULTIHOST_FLAGS if getattr(args, f, None) is not None]
    if given and len(given) != len(MULTIHOST_FLAGS):
        raise ValueError(
            "--coordinator, --num-processes and --process-id go together "
            "(nothing here detects them): got "
            + ", ".join("--" + f.replace("_", "-") for f in given))
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


def _rank_entry(local_rank: int, run, args, env: dict) -> None:
    """A spawned rank: the world's variables for ``local_rank``, then the
    CLI's ``run``."""
    os.environ.update({k: str(v(local_rank) if callable(v) else v)
                       for k, v in env.items()})
    run(args)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_local_ranks(args, device: torch.device, run) -> bool:
    """Start this host's ranks when the run needs more than this process:
    one per visible card, for the multi-host flags (host i's ranks i *
    cards ..) or, without a launcher, when more than one card is visible
    and ``-d`` names none.  Each runs ``run(args)`` in a process of its own
    with the world in its environment; returns True once all have ended (a
    failed rank raises here).  False: this process is the run's only
    process, or one rank of a launcher's world."""
    from spatialvae_torch.parallel.mesh import env_world, multihost_rank

    if env_world() is not None or device.type != "cuda":
        return False
    cards = torch.cuda.device_count()
    if getattr(args, "coordinator", None) is not None:
        if cards <= 1:
            return False
        host, port = args.coordinator.rsplit(":", 1)
        env = {"MASTER_ADDR": host, "MASTER_PORT": port,
               "WORLD_SIZE": args.num_processes * cards,
               "RANK": lambda r: multihost_rank(args.num_processes,
                                                args.process_id, cards, r),
               "LOCAL_RANK": lambda r: r}
    elif getattr(args, "device", -2) == -2 and cards > 1:
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": _free_port(),
               "WORLD_SIZE": cards, "RANK": lambda r: r,
               "LOCAL_RANK": lambda r: r}
    else:
        return False
    import torch.multiprocessing as mp

    mp.spawn(_rank_entry, args=(run, args, env), nprocs=cards)
    return True


def maybe_mesh(args, device: torch.device):
    """This process's rank of the run's mesh, the world joined, or None for
    a run of one device: the world from the launcher's environment, or the
    multi-host flags with one card (or the CPU) here; the mesh (ranks /
    --mesh-model, --mesh-model).  A rank's device is its local card
    (``LOCAL_RANK``), or the CPU under -d -1; the backend NCCL on cards,
    gloo on the CPU.  Prints the ``# mesh:`` line."""
    import torch.distributed as dist

    from spatialvae_torch.parallel.mesh import (
        MeshConfig,
        create_mesh,
        env_world,
        init_world,
        initialize_multihost,
    )

    world = env_world()
    model = getattr(args, "mesh_model", 1) or 1
    if world is not None:
        if device.type == "cuda":
            device = torch.device("cuda", world["local_rank"])
        init_world(world["rank"], world["world_size"], world["init_method"],
                   device)
    elif getattr(args, "coordinator", None) is not None:
        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id, device=device)
    elif model > 1:
        raise ValueError(
            f"--mesh-model {model} needs a world of ranks: start the run "
            f"under torchrun (or with the multi-host flags)")
    else:
        return None
    mesh = create_mesh(MeshConfig.auto(dist.get_world_size(), model),
                       device)
    if mesh.rank == 0:
        print(mesh.describe(), file=sys.stderr)
    return mesh


@contextlib.contextmanager
def rank_scope(mesh):
    """The body of a run on ``mesh``'s rank: silent (stdout and stderr to
    the null device) on every rank but 0; the world left at the end."""
    if mesh is None:
        yield
        return
    import torch.distributed as dist

    try:
        if mesh.rank == 0:
            yield
        else:
            with open(os.devnull, "w") as null, \
                    contextlib.redirect_stdout(null), \
                    contextlib.redirect_stderr(null):
                yield
    finally:
        dist.destroy_process_group()


def make_dataset(y, ctf=None, device=None, preload=True):
    """``ArrayDataset`` on ``device``, or host-resident with per-step
    streaming when ``preload`` is False (``--no-preload``).  Under a mesh
    every rank holds the whole data set and takes its rows of each batch
    (the JAX CLI shards it over 'data'; the results are the same, the
    memory is not: ROADMAP M10's decision)."""
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
    epoch_str, z_scale)`` every ``--save_interval`` epochs (rank 0 alone
    under a mesh) and print the validation row.  Rows are ``epoch - 1`` (0-based) then (ELBO, BCE, KL).
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
        if epoch % args.save_interval == 0 and primary():
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
    results files.  ``results`` is ``image_epochs``' return.  Nothing on a
    rank that does not write (``RunOutputs.write``)."""
    from spatialvae_torch.train.checkpoint import (
        optimizer_path,
        save_optimizer,
        save_trained_models,
    )
    from spatialvae_torch.train.plots import basic_run_plot

    if not outputs.write:
        return
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
