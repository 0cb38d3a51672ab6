"""The mesh paths on n CPU ranks at tiny shapes — counterpart of the JAX
package's ``dryrun_multichip(n)`` (``__graft_entry__.py``):

    python -m spatialvae_torch.parallel.dryrun [n]      # n = 4 by default

Starts n processes joined over gloo (a file store in a temporary
directory) and runs, each with the plain versions of the kernels:

- the data-parallel step on an (n, 1) mesh in int8 mode, K3 per rank on its
  rows (two images each), then ``train_epochs`` over two epochs and a mesh
  evaluation;
- the same step with the colored (fit-noise) likelihood;
- the pixel-sharded loss (``make_pixel_sharded_loss``) over a (1, n) mesh,
  against the whole call on one rank;
- the pixel step on an (n/2, 2) mesh (n even), one training step.

After each, every rank's parameters must equal rank 0's bit for bit.  Rank
0 prints an ``ok`` line per path; a failed rank fails the run.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _trainer(mesh, n: int, m: int, channels: int, batch: int,
             likelihood: str = "bernoulli"):
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig,
    )
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    n_out = 2 if likelihood == "colored" else channels
    q_cfg = InferenceConfig(n=n * m * channels, latent_dim=5, hidden_dim=32,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=16, n_out=n_out,
                                   num_layers=2)
    ecfg = ElboConfig(channels=channels, likelihood=likelihood, fused=True,
                      int8=True)
    tcfg = TrainConfig(minibatch_size=batch, image_shape=(n, m),
                       channels=channels)
    return Trainer(q_cfg, p_cfg, ecfg, tcfg, coord_grid(n, m), device="cpu",
                   mesh=mesh)


def _images(count: int, hw: int, channels: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (count, hw, channels), generator=g) / 255.0


def _same_on_every_rank(trainer) -> None:
    """Every rank's parameters equal rank 0's, bit for bit."""
    for name, p in trainer.named_params().items():
        ref = p.detach().clone()
        dist.broadcast(ref, src=0)
        flag = torch.tensor([int(torch.equal(ref, p.detach()))])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not flag.item():
            raise AssertionError(f"{name} differs between ranks")


def _rank(rank: int, n: int, store: str) -> None:
    torch.set_num_threads(1)
    from spatialvae_torch.objectives.elbo import fused_loss_active
    from spatialvae_torch.parallel import (
        MeshConfig,
        create_mesh,
        init_world,
        make_pixel_sharded_loss,
    )
    from spatialvae_torch.parallel.sharding import batch_sharding

    init_world(rank, n, f"file://{store}", "cpu", "gloo")
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        dp = create_mesh(MeshConfig(n, 1), "cpu")
        for likelihood, channels in (("bernoulli", 3), ("colored", 1)):
            tr = _trainer(dp, 32, 32, channels, 2 * n, likelihood)
            if not fused_loss_active(tr.ecfg, tr.p_cfg, 32 * 32, 2):
                raise AssertionError("the rank's two images do not take K3")
            y = _images(2 * n, 32 * 32, channels, 0)
            aux = tr.train_step(batch_sharding(dp)(y),
                                generator=tr._step_gen(0))
            elbo = float(aux[0])
            if elbo != elbo:
                raise AssertionError(f"{likelihood} DP ELBO is NaN")
            _same_on_every_rank(tr)
            say(f"dryrun_multichip({n}): DP mesh={dp.shape} {likelihood} "
                f"K3 per rank, ELBO={elbo:.4f} ok")
            if likelihood == "bernoulli":
                data = _images(4 * n + 1, 32 * 32, channels, 1)
                rows = tr.train_epochs(data, 0, 2)
                ev = tr.eval_epoch(data, 0)
                if not (torch.isfinite(torch.as_tensor(rows)).all()
                        and ev[0] == ev[0]):
                    raise AssertionError("DP epochs or evaluation not finite")
                _same_on_every_rank(tr)
                say(f"dryrun_multichip({n}): train_epochs(2) and the mesh "
                    f"evaluation ok (epoch ELBOs "
                    f"{[round(float(r[0]), 2) for r in rows]}, eval "
                    f"{ev[0]:.4f})")

        sp = create_mesh(MeshConfig(1, n), "cpu")
        hw = 1024 * n
        tr = _trainer(None, 32, 32 * n, 1, 2)
        g = torch.Generator().manual_seed(5)
        coords = torch.rand((hw, 2), generator=g) * 2 - 1
        theta = torch.randn(2, generator=g) * 0.5
        dx = torch.randn((2, 2), generator=g) * 0.1
        z = torch.randn((2, 2), generator=g)
        y_t = torch.rand((2, 1, hw), generator=g)
        got = make_pixel_sharded_loss(tr.p_cfg, sp)(tr.p_net, coords, theta,
                                                    dx, z, y_t)
        from spatialvae_torch.kernels.fused_loss_int8 import (
            fused_bce_spatial_int8,
        )
        want = fused_bce_spatial_int8(tr.p_net, coords, theta, dx, z, None,
                                      y_t=y_t)
        got, want = got.detach(), want.detach()
        if not torch.allclose(got, want, rtol=1e-5):
            raise AssertionError(f"pixel-sharded loss {float(got)} vs the "
                                 f"whole call {float(want)}")
        say(f"dryrun_multichip({n}): pixel-sharded loss mesh={sp.shape} "
            f"{float(got):.4f} = whole call {float(want):.4f} ok")

        if n % 2 == 0:
            px = create_mesh(MeshConfig(n // 2, 2), "cpu")
            tr = _trainer(px, 32, 64, 3, n)
            if not tr._spmd_pixel:
                raise AssertionError("the (n/2, 2) mesh did not take the "
                                     "pixel step")
            data = _images(n, 32 * 64, 3, 2)
            rows = tr.train_epoch(data, 0, progress=False)
            _same_on_every_rank(tr)
            say(f"dryrun_multichip({n}): pixel step mesh={px.shape}, K3 on "
                f"{32 * 64 // 2} pixels per rank, ELBO={rows[0]:.4f} ok")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int = 4) -> None:
    """Run the paths above on ``n`` CPU ranks; raises if a rank fails."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n, os.path.join(tmp, "store")), nprocs=n)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
