"""The port stands alone and runs on the card unless asked for the CPU.

- No module of ``spatialvae_torch`` and not ``chip_smoke.py`` imports
  ``spatialvae_tpu`` or ``jax``, nor ``pandas``, ``PIL``, ``matplotlib``,
  ``torchvision`` or ``ml_dtypes``, which the card's machine lacks (an AST
  walk of every import statement, the run-output modules, the galaxy and
  mnist CLIs and the tools among them).
- With both packages (and pandas, PIL and ml_dtypes) made unimportable, a
  tiny CPU training run (float and int8 steps, a streamed epoch), a
  checkpoint round trip through the serving API, a bf16 Adam state through
  a file, both horizon arms and a particles CLI run with CTF and
  augmentation work; with
  matplotlib and torchvision unimportable too, the galaxy and mnist CLIs
  write their whole tree.
- ``Trainer``, ``SpatialVae.load``, ``create_mesh`` and
  ``initialize_multihost`` without ``device=`` go to the CUDA card, and
  raise where there is none; ``device="cpu"`` runs on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spatialvae_torch import checkpoint
from spatialvae_torch.api import SpatialVae
from spatialvae_torch.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.parallel import (
    MeshConfig,
    create_mesh,
    initialize_multihost,
)
from spatialvae_torch.parallel.mesh import rank_device
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid

REPO = Path(__file__).resolve().parents[1]
# the JAX package and JAX; pandas, PIL, matplotlib, torchvision and
# ml_dtypes, which the card's machine lacks
FORBIDDEN = ("spatialvae_tpu", "jax", "pandas", "PIL", "matplotlib",
             "torchvision", "ml_dtypes")
# the port's tools, the checkpoint and streaming modules of the long runs
TOOL_MODULES = ("tools/int8_horizon.py", "tools/profile_step.py",
                "tools/export_torch_checkpoint.py", "tools/kernel_bench.py",
                "tools/probe_int4.py", "tools/probe_i16acc.py",
                "data/stream.py", "checkpoint.py", "io/reference_sav.py")
# the port's modules that stand in for the JAX package's PIL, matplotlib
# and torchvision paths
HOST_MODULES = ("models/vanilla.py", "models/reprs.py", "io/png.py",
                "train/plots.py", "train/artifacts.py", "cli/train_galaxy.py",
                "cli/train_mnist.py")


def _port_sources():
    return sorted((REPO / "spatialvae_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_module_imports_the_jax_package_or_jax():
    sources = _port_sources()
    assert len(sources) > 20
    walked = {str(p.relative_to(REPO / "spatialvae_torch"))
              for p in sources[:-1]}
    assert set(HOST_MODULES) <= walked and set(TOOL_MODULES) <= walked
    bad = []
    for path in sources:
        for name in _imported(ast.parse(path.read_text(), str(path))):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad


RUN = r"""
import sys
sys.modules["spatialvae_tpu"] = None
sys.modules["jax"] = None
sys.modules["pandas"] = None
sys.modules["PIL"] = None
sys.modules["ml_dtypes"] = None
import os, tempfile
import torch
from spatialvae_torch import checkpoint
from spatialvae_torch.api import SpatialVae
from spatialvae_torch.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid

q_cfg = InferenceConfig(n=32 * 32 * 3, latent_dim=5, hidden_dim=16,
                        num_layers=2)
p_cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=16, n_out=3,
                               num_layers=2)
g = torch.Generator().manual_seed(0)
y = torch.randint(0, 256, (5, 32 * 32, 3), generator=g).float() / 255
for int8 in (False, True):
    ecfg = ElboConfig(fused=True, int8=int8, channels=3)
    tr = Trainer(q_cfg, p_cfg, ecfg, TrainConfig(minibatch_size=2),
                 coord_grid(32, 32), device="cpu")
    m = tr.train_epoch(y, 0, progress=False)
    assert all(v == v for v in m), m
with tempfile.TemporaryDirectory() as d:
    gp, ip = os.path.join(d, "g.sav"), os.path.join(d, "i.sav")
    checkpoint.save_model(gp, "generator", tr.p_net, elbo=ecfg,
                          image_shape=(32, 32))
    checkpoint.save_model(ip, "inference", tr.q_net, elbo=ecfg,
                          image_shape=(32, 32))
    model = SpatialVae.load(gp, ip, device="cpu")
    with torch.no_grad():
        want = tr.q_net(y.reshape(5, -1))
    got = model.encode(y)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
with tempfile.TemporaryDirectory() as d:
    import contextlib, io
    import numpy as np
    from spatialvae_torch.cli import train_particles
    from spatialvae_torch.io.mrc import write_mrc
    rng = np.random.RandomState(0)
    with open(os.path.join(d, "tr.mrc"), "wb") as f:
        write_mrc(f, rng.randn(8, 9, 9).astype(np.float32))
    with open(os.path.join(d, "ctf.txt"), "w") as f:
        f.write("1.5 2.0 300 1.2 50 10 0 0\n" * 8)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        train_particles.main([
            os.path.join(d, "tr.mrc"), os.path.join(d, "tr.mrc"),
            "--ctf-train", os.path.join(d, "ctf.txt"), "--ctf-test",
            os.path.join(d, "ctf.txt"), "--fit-noise", "--augment-rotation",
            "--num-epochs", "1", "--minibatch-size", "4", "-d", "-1",
            "--p-hidden-dim", "8", "--q-hidden-dim", "8"])
    assert out.getvalue().count("\t") == 12, out.getvalue()
# a streamed epoch, a bf16 Adam state through a file, both horizon arms
from spatialvae_torch.data.dataset import ArrayDataset
from spatialvae_torch.tools import int8_horizon
m = tr.train_epoch(ArrayDataset.from_numpy(y.numpy(), preload=False), 1,
                   progress=False)
assert all(v == v for v in m), m
tr.opt_state.mu = {k: v.to(torch.bfloat16) for k, v in tr.opt_state.mu.items()}
tr.opt_state.nu = {k: v.to(torch.bfloat16) for k, v in tr.opt_state.nu.items()}
with tempfile.TemporaryDirectory() as d:
    op = os.path.join(d, "o.sav")
    checkpoint.save_optimizer(op, tr.opt_state, 1, tr.q_net, tr.p_net)
    state, _ = checkpoint.load_optimizer(op, tr.q_net, tr.p_net)
    assert all(torch.equal(state.mu[k], v)
               for k, v in tr.opt_state.mu.items())
for int8 in (False, True):
    with contextlib.redirect_stdout(io.StringIO()):
        e = int8_horizon.run(1, 2, 1, int8, device="cpu", side=32,
                             q_hidden=16, p_hidden=16)
    assert e[0] == e[0], e
assert all(sys.modules.get(n) is None for n in ("jax", "ml_dtypes"))
print("ok")
"""


def test_port_runs_with_jax_and_the_jax_package_unimportable():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)


RUN_IMAGE_CLIS = r"""
import sys
for name in ("spatialvae_tpu", "jax", "PIL", "matplotlib", "pandas",
             "torchvision"):
    sys.modules[name] = None
import contextlib, io, os, xml.etree.ElementTree as ET
import numpy as np
os.environ["SPATIALVAE_ASSUME_YES"] = "1"
from spatialvae_torch.cli import train_galaxy, train_mnist
from spatialvae_torch.io.png import read_png
rng = np.random.RandomState(0)
np.save("gt.npy", (rng.rand(20, 8, 8, 3) * 255).astype(np.uint8))
np.save("gv.npy", (rng.rand(8, 8, 8, 3) * 255).astype(np.uint8))
os.makedirs("data/mnist_rotated_translated")
for split, n in (("train", 20), ("test", 8)):
    np.save(f"data/mnist_rotated_translated/images_{split}.npy",
            (rng.rand(n, 10, 10) * 255).astype(np.uint8))
small = ["--num_epochs", "1", "--minibatch_size", "8", "--p_hidden_dim",
         "8", "--q_hidden_dim", "8", "--save_interval", "1", "-d", "-1"]
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    train_galaxy.main(["gt.npy", "gv.npy", "--save_prefix", "g",
                       "--augment_rotation"] + small)
    train_mnist.main(["--save_prefix", "m", "--vanilla"] + small)
for prefix, grids in (("g", 4), ("m", 3)):
    images = os.path.join(f"outputs_{prefix}", "images")
    pngs = [f for f in os.listdir(images) if f.endswith(".png")]
    assert len(pngs) == grids, pngs
    for f in pngs:
        read_png(os.path.join(images, f))
    for f in ("ELBO.svg", "KL_Divergence.svg", "BCE_Loss.svg"):
        ET.parse(os.path.join(images, f))
assert all(sys.modules.get(n) is None for n in ("jax", "PIL", "matplotlib"))
print("ok")
"""


def test_both_clis_run_without_jax_pil_or_matplotlib(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", RUN_IMAGE_CLIS],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)


def _cfgs():
    return (InferenceConfig(n=16 * 16, latent_dim=5, hidden_dim=8),
            SpatialGeneratorConfig(latent_dim=2, hidden_dim=8, num_layers=2))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    q_cfg, p_cfg = _cfgs()
    gp, ip = str(tmp_path / "g.sav"), str(tmp_path / "i.sav")
    checkpoint.save_model(gp, "generator", SpatialGenerator(p_cfg),
                          image_shape=(16, 16))
    checkpoint.save_model(ip, "inference", InferenceNetwork(q_cfg),
                          image_shape=(16, 16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(q_cfg, p_cfg, ElboConfig(), TrainConfig(), coord_grid(16, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpatialVae.load(gp, ip)
    # a mesh's rank: no world is joined before the device is settled
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_mesh(MeshConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_multihost("localhost:1", 1, 0, backend="gloo")
    assert rank_device("cpu") == torch.device("cpu")
    tr = Trainer(q_cfg, p_cfg, ElboConfig(), TrainConfig(),
                 coord_grid(16, 16), device="cpu")
    assert tr.device == torch.device("cpu")
    assert SpatialVae.load(gp, ip, device="cpu").device == torch.device("cpu")


def test_trainer_moves_coords_and_mask_to_its_device():
    q_cfg, p_cfg = _cfgs()
    tr = Trainer(q_cfg, p_cfg, ElboConfig(), TrainConfig(),
                 coord_grid(16, 16).double(),
                 mask=torch.ones(256, dtype=torch.float64), device="cpu")
    assert tr.coords.device == tr.mask.device == torch.device("cpu")
    assert tr.coords.dtype == torch.float32
