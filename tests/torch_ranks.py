"""Rank bodies of the port's multi-process tests, in a module that imports
no JAX, so that the processes ``torch.multiprocessing.spawn`` starts never
import it (they unpickle these functions by this module's name).

``spawn(fn, n, *args)`` starts n ranks joined over gloo on the CPU (a file
store in a temporary directory), each with one torch thread, runs
``fn(rank, *args)`` on each and returns the n results (``torch.save``'d by
each rank, loaded here); a rank that raises fails the call.  The scenarios
take their inputs as numpy arrays and config dicts and return numpy
results, which the test files hold against the JAX package and the port's
one-device trainer.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spatialvae_torch.config import config_from_dict


def _entry(rank, fn, n, tmp, backend, device, args):
    from spatialvae_torch.parallel import init_world

    torch.set_num_threads(1)
    init_world(rank, n, f"file://{tmp}/store", device, backend)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("a rank imported jax")
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))


def spawn(fn, n: int, *args, backend: str = "gloo", device: str = "cpu"):
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(fn, n, tmp, backend, device, args), nprocs=n)
        return [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(n)]


def many(rank: int, jobs: list) -> list:
    """Several scenarios in one world: jobs = [(name of a function here,
    its arguments after the rank), ...]; their results in order."""
    return [globals()[name](rank, *args) for name, args in jobs]


# ------------------------------------------------------------ the trainers


def trainer(spec: dict, mesh=None, device="cpu"):
    """A port ``Trainer`` from ``spec``: "q_cfg"/"p_cfg" (config dicts),
    "ecfg"/"tcfg" (keyword dicts), "shape" (n, m), the JAX "params" to
    load (optional), "mask" (optional numpy)."""
    from spatialvae_torch.io.jax_params import from_jax_params
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    q_cfg = config_from_dict(spec["q_cfg"])
    p_cfg = config_from_dict(spec["p_cfg"])
    mask = spec.get("mask")
    tr = Trainer(q_cfg, p_cfg, ElboConfig(**spec["ecfg"]),
                 TrainConfig(**spec["tcfg"]), coord_grid(*spec["shape"]),
                 None if mask is None else torch.from_numpy(mask),
                 device=device, mesh=mesh)
    if spec.get("params") is not None:
        q, p = from_jax_params(spec["params"]["q"], spec["params"]["p"],
                               q_cfg, p_cfg)
        tr.q_net.load_state_dict(q.state_dict())
        tr.p_net.load_state_dict(p.state_dict())
    return tr


def state(tr) -> dict:
    """The trainer's masters (JAX layout), and its shadow and qshadow as
    numpy, for the ranks-equal checks."""
    from spatialvae_torch.io.jax_params import named_to_jax

    out = {"params": named_to_jax(tr.q_net, tr.p_net, tr.named_params())}
    if tr.shadow is not None:
        out["shadow"] = {k: v.detach().float().numpy().copy()
                         for k, v in tr.shadow.items()}
    if tr.qshadow is not None:
        out["qshadow"] = {k: {f: t.numpy().copy() for f, t in e.items()
                              if t is not None and t.numel()}
                          for k, e in tr.qshadow.items()}
    return out


def steps(tr, y: np.ndarray, batches: list, noises: list) -> list:
    """The given batches as train steps on ``tr`` (a mesh's or one
    device's): full batches (the trainer's minibatch) through the loss
    kernel's target copy, on the rank's rows under a mesh; others whole
    (the replicated step under a mesh).  Returns each step's aux."""
    from spatialvae_torch.parallel.sharding import batch_sharding

    yt = torch.from_numpy(y)
    data_t = tr._dataset_yt(yt) if tr._wants_yt() else None
    b = tr.tcfg.minibatch_size
    out = []
    for idx, noise in zip(batches, noises):
        idx, noise = torch.as_tensor(idx), torch.from_numpy(noise)
        if len(idx) == b:
            if tr.mesh is not None:
                rows = batch_sharding(tr.mesh).rows(b)
                idx, noise = idx[rows], noise[rows]
            aux = tr.train_step(yt[idx], noise=noise,
                                y_t=None if data_t is None else data_t[idx])
        else:
            aux = tr.train_step(yt[idx], noise=noise,
                                replicated=tr.mesh is not None)
        out.append(aux.numpy().copy())
    return out


# ------------------------------------------------------------ scenarios


def collectives(rank: int) -> dict:
    """On a (2, 2) mesh's model axis: sum_value and sum_grad of rank + 1,
    times 3, with their gradients."""
    from spatialvae_torch.parallel import MeshConfig, create_mesh
    from spatialvae_torch.parallel.collectives import sum_grad, sum_value

    ax = create_mesh(MeshConfig(2, 2), "cpu").axis("model")
    x = torch.tensor(float(rank + 1), requires_grad=True)
    v = sum_value(x, ax) * 3.0
    v.backward()
    x2 = torch.tensor(float(rank + 1), requires_grad=True)
    (sum_grad(x2, ax) * 3.0 * (rank + 1)).backward()
    return {"value": float(v) / 3.0, "value_grad": float(x.grad),
            "grad": float(x2.grad)}


def mesh_layout(rank: int, shapes: list) -> list:
    """Each (data, model) mesh's view from this rank: (data index, model
    index, the ranks of its two axis groups)."""
    from spatialvae_torch.parallel import MeshConfig, create_mesh

    out = []
    for d, m in shapes:
        mesh = create_mesh(MeshConfig(d, m), "cpu")
        groups = []
        for name in ("data", "model"):
            ax = mesh.axis(name)
            mine = torch.tensor([rank])
            got = [torch.zeros(1, dtype=torch.int64) for _ in range(ax.size)]
            dist.all_gather(got, mine, group=ax.group)
            groups.append([int(t) for t in got])
        out.append((mesh.data_index, mesh.model_index, *groups))
    return out


def dp_int8(rank: int, spec: dict, y, batches, noises) -> dict:
    """The int8 trainer's steps on a (2, 1) mesh, then an evaluation."""
    from spatialvae_torch.parallel import MeshConfig, create_mesh

    tr = trainer(spec, create_mesh(MeshConfig(dist.get_world_size(), 1),
                                     "cpu"))
    aux = steps(tr, y, batches, noises)
    return {"aux": aux, **state(tr),
            "eval": tr.eval_epoch(torch.from_numpy(y), 0)}


def dp_int8_stack(rank: int, spec: dict, y, batches, noises) -> dict:
    """The bf16 int8 trainer's data-parallel steps with the int8 encoder
    copies on every 2-D leaf (``_QENC_MIN_ELEMS`` at 1 while it runs), each
    full batch with its target and int8 data copies, on a (2, 1) mesh."""
    from spatialvae_torch.parallel import MeshConfig, create_mesh, spmd
    from spatialvae_torch.parallel.sharding import batch_sharding
    from spatialvae_torch.train import trainer as port_trainer

    saved = port_trainer._QENC_MIN_ELEMS
    port_trainer._QENC_MIN_ELEMS = 1
    try:
        tr = trainer(spec, create_mesh(
            MeshConfig(dist.get_world_size(), 1), "cpu"))
        assert tr._use_shadow and tr._use_qenc
        yt = torch.from_numpy(y)
        data_t = tr._dataset_yt(yt)
        xq, sx = tr._dataset_yq8(yt)
        rows = batch_sharding(tr.mesh).rows(tr.tcfg.minibatch_size)
        # the first batch's gradients at the start, averaged over 'data'
        idx, noise = torch.as_tensor(batches[0])[rows], noises[0][rows]
        first, grads = tr.local_gradients(
            yt[idx], y_t=data_t[idx], y_q8=(xq[idx], sx),
            noise=torch.from_numpy(noise))
        grads = spmd._reduced(first, grads, tr.mesh.axis("data"))[1]
        aux = []
        for idx, noise in zip(batches, noises):
            idx = torch.as_tensor(idx)[rows]
            aux.append(tr.train_step(
                yt[idx], y_t=data_t[idx], y_q8=(xq[idx], sx),
                noise=torch.from_numpy(noise)[rows]).numpy().copy())
        from spatialvae_torch.io.jax_params import named_to_jax

        return {"aux": aux, **state(tr),
                "shadow_jax": named_to_jax(tr.q_net, tr.p_net, tr.shadow),
                "grads": named_to_jax(tr.q_net, tr.p_net, grads)}
    finally:
        port_trainer._QENC_MIN_ELEMS = saved


def pixel_loss(rank: int, cases: list) -> list:
    """``make_pixel_sharded_loss`` over a (1, world) mesh: per case its
    value and the gradients of theta, dx, z and the generator (JAX
    layout)."""
    from spatialvae_torch.io.jax_params import (
        generator_from_jax,
        generator_to_jax,
    )
    from spatialvae_torch.parallel import (
        MeshConfig,
        create_mesh,
        make_pixel_sharded_loss,
    )

    mesh = create_mesh(MeshConfig(1, dist.get_world_size()), "cpu")
    out = []
    for case in cases:
        cfg = config_from_dict(case["cfg"])
        gen = generator_from_jax(case["params"], cfg)
        t = {k: torch.from_numpy(case[k]).requires_grad_()
             for k in ("theta", "dx", "z")}
        mask = case.get("mask")
        loss = make_pixel_sharded_loss(cfg, mesh, family=case["family"])(
            gen, torch.from_numpy(case["coords"]), t["theta"], t["dx"],
            t["z"], torch.from_numpy(case["y_t"]),
            None if mask is None else torch.from_numpy(mask))
        loss.backward()
        for p in gen.parameters():
            p.data = p.grad
        out.append({"value": float(loss.detach()),
                    "p": generator_to_jax(gen),
                    **{k: v.grad.numpy().copy() for k, v in t.items()}})
    return out


def pixel_step(rank: int, spec: dict, model: int, y, noise) -> dict:
    """One pixel step on a (world / model, model) mesh, every data rank
    given the same images ``y`` and ``noise`` (the JAX test's replicated
    batch)."""
    from spatialvae_torch.parallel import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(dist.get_world_size() // model, model),
                       "cpu")
    tr = trainer(spec, mesh)
    assert tr._spmd_pixel and not tr._spmd
    yt = torch.from_numpy(y)
    aux = tr.train_step(yt, y_t=yt.reshape(yt.shape[0], -1, 1)
                        .transpose(1, 2).contiguous(),
                        noise=torch.from_numpy(noise))
    return {"aux": aux.numpy().copy(), **state(tr)}


class _Counting:
    """Counts the plain versions' calls (batch size per call) in a rank."""

    def __init__(self):
        from spatialvae_torch.kernels import fused_decoder_int8 as d8
        from spatialvae_torch.kernels import fused_loss_int8 as l8

        self.calls = []
        for mod, name, tag in ((l8, "loss_int8_reference", "K3"),
                               (d8, "decoder_tail_int8_reference", "K4"),
                               (d8, "decoder_tail_int8_backward_reference",
                                "K5")):
            fn = getattr(mod, name)

            def wrapped(*a, _f=fn, _t=tag, **kw):
                self.calls.append((_t, int(a[0].shape[0])))
                return _f(*a, **kw)

            setattr(mod, name, wrapped)


def epochs(rank: int, spec: dict, float_spec: dict, pixel_spec: dict,
           y, y_px, tmp: str) -> dict:
    """On a (2, 1) mesh: an int8 epoch with its tail (the plain versions'
    calls counted), two epochs by ``train_epoch`` against ``train_epochs``,
    a float trainer's preloaded against its streamed epochs, rank 0's
    checkpoints and a resume of every rank from them; on a (1, 2) mesh the
    pixel step's streamed epoch (every batch whole on every rank)."""
    from types import SimpleNamespace

    from spatialvae_torch.cli.common import maybe_resume
    from spatialvae_torch.data.dataset import ArrayDataset
    from spatialvae_torch.parallel import MeshConfig, create_mesh
    from spatialvae_torch.train.checkpoint import (
        save_model,
        save_optimizer,
        wait_for_checkpoints,
    )

    world = dist.get_world_size()
    dp = create_mesh(MeshConfig(world, 1), "cpu")
    yt = torch.from_numpy(y)
    out = {}
    count = _Counting()
    tr = trainer(spec, dp)
    out["int8_epoch"] = tr.train_epoch(yt, 0, progress=False)
    out["int8_calls"] = list(count.calls)
    out["int8_state"] = state(tr)
    count.calls.clear()
    out["int8_eval"] = tr.eval_epoch(yt, 0)
    out["eval_calls"] = list(count.calls)

    seq = trainer(spec, dp)
    out["seq"] = [seq.train_epoch(yt, e, progress=False) for e in range(2)]
    one = trainer(spec, dp)
    out["multi"] = one.train_epochs(yt, 0, 2).tolist()

    pre = trainer(float_spec, dp)
    out["preloaded"] = [pre.train_epoch(yt, e, progress=False)
                        for e in range(2)]
    streamed = trainer(float_spec, dp)
    host = ArrayDataset.from_numpy(y, preload=False)
    out["streamed"] = [streamed.train_epoch(host, e, progress=False)
                       for e in range(2)]

    # rank 0 writes; every rank resumes from rank 0's files
    prefix = os.path.join(tmp, f"r{rank}")
    save_model(prefix + "_generator.sav", "generator", pre.p_net,
               elbo=pre.ecfg)
    save_model(prefix + "_inference.sav", "inference", pre.q_net,
               elbo=pre.ecfg)
    save_optimizer(prefix + "_optimizer.sav", pre.opt_state, 1, pre.q_net,
                   pre.p_net)
    wait_for_checkpoints()
    dist.barrier()
    out["files"] = sorted(os.listdir(tmp))
    res = trainer(float_spec, dp)
    r0 = os.path.join(tmp, "r0")
    start = maybe_resume(res, SimpleNamespace(
        resume_generator=r0 + "_generator.sav",
        resume_inference=r0 + "_inference.sav",
        resume_optimizer=r0 + "_optimizer.sav"))
    out["resumed"] = res.train_epoch(yt, start, progress=False)
    out["continued"] = pre.train_epoch(yt, 2, progress=False)
    out["resume_start"] = start
    out["float_state"] = state(res)

    px = create_mesh(MeshConfig(1, world), "cpu")
    count.calls.clear()
    stream_px = trainer(pixel_spec, px)
    out["pixel_streamed"] = stream_px.train_epoch(
        ArrayDataset.from_numpy(y_px, preload=False), 0, progress=False)
    out["pixel_streamed_calls"] = list(count.calls)
    out["pixel_state"] = state(stream_px)
    return out


def cli(rank: int, module: str, argv: list, dirs: list) -> str:
    """A CLI's ``main(argv)`` as rank ``rank`` of a torchrun-style world
    (the environment's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), from ``dirs[rank]``; returns its standard output."""
    import importlib

    os.chdir(dirs[rank])
    main = importlib.import_module(module).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _cli_entry(rank, module, argv, dirs, port, n, tmp, multihost):
    torch.set_num_threads(1)
    if multihost:
        argv = argv + ["--coordinator", f"localhost:{port}",
                       "--num-processes", str(n), "--process-id", str(rank)]
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
    torch.save(cli(rank, module, argv, dirs),
               os.path.join(tmp, f"out{rank}.pt"))


def spawn_cli(module: str, argv: list, dirs: list, port: int,
              multihost: bool = False) -> list:
    """``cli`` on len(dirs) ranks; the world comes from the environment, as
    torchrun gives it, or with ``multihost`` from the multi-host flags (a
    host a rank, host 0 the coordinator); the CLI joins it."""
    n = len(dirs)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_cli_entry, args=(module, argv, dirs, port, n, tmp,
                                   multihost), nprocs=n)
        return [torch.load(os.path.join(tmp, f"out{r}.pt"))
                for r in range(n)]


def dp_card(rank: int, spec: dict, y, batches, noises) -> dict:
    """The DP int8 steps on one card shared by the ranks (gloo)."""
    from spatialvae_torch.parallel import MeshConfig, create_mesh

    mesh = create_mesh(MeshConfig(dist.get_world_size(), 1),
                       torch.device("cuda"))
    tr = trainer(spec, mesh, device="cuda")
    yt = torch.from_numpy(y).cuda()
    data_t = tr._dataset_yt(yt)
    rows = slice(rank * 2, rank * 2 + 2)
    for idx, noise in zip(batches, noises):
        idx = torch.as_tensor(idx, device="cuda")
        noise = torch.from_numpy(noise).cuda()
        tr.train_step(yt[idx[rows]], y_t=data_t[idx[rows]],
                      noise=noise[rows])
    torch.cuda.synchronize()
    return {k: v.detach().cpu().clone() for k, v in
            {**tr.named_params(), **{"shadow." + k: v for k, v in
                                     (tr.shadow or {}).items()}}.items()}
