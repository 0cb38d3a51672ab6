"""bf16-moment optimizer checkpoints and the export to the reference's
layout, against the JAX package, on the CPU.  Every comparison is exact:
bits of the moments, parameters, TSV lines.

- A port file with bf16 moments survives a port -> port round trip bit for
  bit; a JAX-written bf16 file loads in a process where ``jax``,
  ``ml_dtypes`` and ``spatialvae_tpu`` are unimportable, to the JAX
  arrays' bits (the port -> JAX direction and the JAX -> port one in the
  same process are ``test_torch_port_adam.py``'s cross-package test).
- The particles CLI with ``--adam-moments bf16``: two epochs straight
  equal one epoch, a save of the bf16 Adam state, a resume and one epoch.
- The resume casts the file's moments to the run's ``--adam-moments``,
  both ways, and says which dtypes.
- ``export_generator`` / ``export_inference`` of the port and of the JAX
  package write modules with the same classes, attributes and state dicts;
  both files read back through the port's ``reference_sav`` and the JAX
  importer to the exported parameters; the port's
  ``tools/export_torch_checkpoint`` converts a port checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from spatialvae_tpu.core.config import (
    InferenceConfig,
    SpatialGeneratorConfig,
    VanillaGeneratorConfig,
)
from spatialvae_tpu.io import torch_import as jax_ti
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.train import optimizer as jax_opt

from spatialvae_torch import checkpoint
from spatialvae_torch.cli import train_particles as cli
from spatialvae_torch.io import reference_sav
from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
from spatialvae_torch.tools import export_torch_checkpoint as export_tool
from spatialvae_torch.train.optimizer import FusedAdamState
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q_CFG = InferenceConfig(n=16, latent_dim=3, hidden_dim=8, num_layers=2)
P_CFG = SpatialGeneratorConfig(latent_dim=1, hidden_dim=8, n_out=1,
                               num_layers=2, bilinear=True)


def _nets(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (InferenceNetwork(to_port(Q_CFG), generator=g),
            SpatialGenerator(to_port(P_CFG), generator=g))


def _bf16_state(q_net, p_net, seed=1) -> FusedAdamState:
    g = torch.Generator().manual_seed(seed)
    named = {f"{k}.{n}": t for k, net in (("q", q_net), ("p", p_net))
             for n, t in net.named_parameters()}

    def draw():
        return {k: torch.randn(t.shape, generator=g).to(torch.bfloat16)
                for k, t in named.items()}

    return FusedAdamState(count=7, mu=draw(), nu={
        k: v.abs() for k, v in draw().items()})


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_port_file_round_trips_bit_for_bit(tmp_path):
    q_net, p_net = _nets()
    state = _bf16_state(q_net, p_net)
    path = str(tmp_path / "o.sav")
    checkpoint.save_optimizer(path, state, 4, q_net, p_net)
    got, epoch = checkpoint.load_optimizer(path, q_net, p_net)
    assert epoch == 4 and got.count == 7
    for k in state.mu:
        for a, b in ((got.mu[k], state.mu[k]), (got.nu[k], state.nu[k])):
            assert a.dtype == torch.bfloat16
            assert np.array_equal(_bits(a), _bits(b)), k


LOAD = r"""
import sys
for name in ("jax", "ml_dtypes", "spatialvae_tpu"):
    sys.modules[name] = None
import numpy as np, torch
from spatialvae_torch import checkpoint
from spatialvae_torch.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
q = InferenceNetwork(InferenceConfig(n=16, latent_dim=3, hidden_dim=8,
                                     num_layers=2))
p = SpatialGenerator(SpatialGeneratorConfig(latent_dim=1, hidden_dim=8,
                                            n_out=1, num_layers=2,
                                            bilinear=True))
state, epoch = checkpoint.load_optimizer(sys.argv[1], q, p)
assert all(t.dtype == torch.bfloat16 for t in state.mu.values())
np.savez(sys.argv[2], epoch=epoch, count=state.count, **{
    f"{m}:{k}": t.view(torch.int16).numpy()
    for m, d in (("mu", state.mu), ("nu", state.nu)) for k, t in d.items()})
assert all(sys.modules.get(n) is None
           for n in ("jax", "ml_dtypes", "spatialvae_tpu"))
print("ok")
"""


def _jax_bf16_state():
    """A JAX ``FusedAdamState`` with random bf16 moments in the JAX tree
    layout of Q_CFG/P_CFG (the shapes from the bridge, the values from
    numpy: ``ml_dtypes`` bf16 arrays, as the JAX optimizer holds them)."""
    from spatialvae_torch.io.jax_params import to_jax_params

    q, p = to_jax_params(*_nets())
    rng = np.random.default_rng(3)

    def draw():
        return jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32).astype(
                ml_dtypes.bfloat16), {"q": q, "p": p})

    return jax_opt.FusedAdamState(count=jnp.asarray(5, jnp.int32),
                                  mu=draw(), nu=draw())


def test_jax_written_file_loads_without_jax_or_ml_dtypes(tmp_path):
    state = _jax_bf16_state()
    path = str(tmp_path / "jax_opt.sav")
    jax_ckpt.save_optimizer(path, state, 2)
    out = str(tmp_path / "bits.npz")
    proc = subprocess.run([sys.executable, "-c", LOAD, path, out],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)
    got = np.load(out)
    assert int(got["epoch"]) == 2 and int(got["count"]) == 5
    q_net, p_net = _nets()
    paths = _leaf_paths(q_net, p_net)
    for m in ("mu", "nu"):
        tree = getattr(state, m)
        for name, (path_, perm) in paths.items():
            want = np.asarray(_get(tree, path_))
            assert want.dtype == ml_dtypes.bfloat16
            want = want.view(np.uint16)
            if perm is not None:
                want = want.transpose(perm)
            assert np.array_equal(got[f"{m}:{name}"].view(np.uint16), want)


def _leaf_paths(q_net, p_net):
    from spatialvae_torch.io.jax_params import leaf_paths

    return leaf_paths(q_net, p_net)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    np.save(tmp_path / "tr.npy", rng.randn(40, 8, 8).astype(np.float32))
    np.save(tmp_path / "te.npy", rng.randn(20, 8, 8).astype(np.float32))
    return tmp_path


BASE = ["tr.npy", "te.npy", "--minibatch-size", "16", "--p-hidden-dim", "8",
        "--q-hidden-dim", "8", "-d", "-1", "--save-interval", "1",
        "--adam-moments", "bf16"]


def _rows(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if "\t" in ln]


def test_bf16_resume_continues_the_uninterrupted_run(workdir, capsys):
    cli.main(BASE + ["--num-epochs", "2", "--save-prefix", "full"])
    full = _rows(capsys)
    cli.main(BASE + ["--num-epochs", "1", "--save-prefix", "a",
                     "--save-optimizer"])
    capsys.readouterr()
    payload, bf16 = checkpoint.read_payload("a_optimizer_epoch1.sav")
    assert bf16 and payload["mu"]["q"]["layers"][0]["w"].dtype == np.uint16
    cli.main(BASE + ["--num-epochs", "2",
                     "--resume-generator", "a_generator_epoch1.sav",
                     "--resume-inference", "a_inference_epoch1.sav",
                     "--resume-optimizer", "a_optimizer_epoch1.sav"])
    resumed = _rows(capsys)
    assert resumed[1:] == full[-2:]


@pytest.mark.parametrize("saved,run", [("f32", "bf16"), ("bf16", "f32")])
def test_resume_casts_to_the_runs_moments(workdir, capsys, monkeypatch,
                                          saved, run):
    cli.main(BASE[:-2] + ["--adam-moments", saved, "--num-epochs", "1",
                          "--save-prefix", "a", "--save-optimizer"])
    capsys.readouterr()
    trainers = []
    resume = cli.maybe_resume
    monkeypatch.setattr(cli, "maybe_resume", lambda tr, args: trainers.append(
        tr) or resume(tr, args))
    cli.main(BASE[:-2] + ["--adam-moments", run, "--num-epochs", "2",
                          "--resume-generator", "a_generator_epoch1.sav",
                          "--resume-inference", "a_inference_epoch1.sav",
                          "--resume-optimizer", "a_optimizer_epoch1.sav"])
    out = capsys.readouterr().out
    names = {"f32": "float32", "bf16": "bfloat16"}
    assert f"cast {names[saved]} -> {names[run]} (--adam-moments)" in out
    assert out.count("\t2\t") == 0 and out.count("2\ttest") == 1
    want = torch.float32 if run == "f32" else torch.bfloat16
    state = trainers[0].opt_state
    assert all(t.dtype == want for t in (*state.mu.values(),
                                         *state.nu.values()))


# --------------------------------------------------------------- the export


def _models(kind):
    """(params in the JAX layout, the JAX config) of a randomly initialised
    network of ``kind``, through the port's modules and the bridge."""
    from spatialvae_torch.io.jax_params import (
        generator_to_jax,
        inference_to_jax,
    )
    from spatialvae_torch.models import VanillaGenerator

    g = torch.Generator().manual_seed(9)
    if kind == "inference":
        cfg = InferenceConfig(n=20, latent_dim=4, hidden_dim=12,
                              num_layers=3, resid=True, activation="relu")
        return inference_to_jax(InferenceNetwork(to_port(cfg),
                                                 generator=g)), cfg
    if kind == "vanilla":
        cfg = VanillaGeneratorConfig(n=16, latent_dim=3, hidden_dim=10,
                                     n_out=2, num_layers=2, softplus=True,
                                     resid=True)
        return generator_to_jax(VanillaGenerator(to_port(cfg),
                                                 generator=g)), cfg
    cfg = SpatialGeneratorConfig(latent_dim=3, hidden_dim=10, n_out=2,
                                 num_layers=3, bilinear=True,
                                 expand_coords=True, softplus=True,
                                 activation="leakyrelu")
    return generator_to_jax(SpatialGenerator(to_port(cfg), generator=g)), cfg


def _structure(module):
    """Class names, attributes (not the torch plumbing) and the state dict
    of a loaded module, recursively."""
    out = {"class": type(module).__name__,
           "attrs": {k: v for k, v in vars(module).items()
                     if not k.startswith("_") and k != "training"}}
    out["children"] = {k: _structure(m) for k, m in
                       module.named_children()}
    return out


def _trees_equal(a, b):
    fa, da = jax.tree_util.tree_flatten(a)
    fb, db = jax.tree_util.tree_flatten(b)
    return da == db and all(np.array_equal(np.asarray(x, np.float32),
                                           np.asarray(y, np.float32))
                            for x, y in zip(fa, fb))


@pytest.mark.parametrize("kind", ["spatial", "vanilla", "inference"])
def test_export_matches_the_jax_export(tmp_path, kind):
    params, cfg = _models(kind)
    jp, pp = str(tmp_path / "jax.sav"), str(tmp_path / "port.sav")
    port_cfg = to_port(cfg)
    if kind == "inference":
        jax_ti.export_inference(params, cfg, jp)
        reference_sav.export_inference(params, port_cfg, pp)
    else:
        jax_ti.export_generator(params, cfg, jp)
        reference_sav.export_generator(params, port_cfg, pp)
    got, want = (reference_sav.load_torch_module(p) for p in (pp, jp))
    assert _structure(got) == _structure(want)
    sg, sw = got.state_dict(), want.state_dict()
    assert sg.keys() == sw.keys()
    assert all(torch.equal(sg[k], sw[k]) for k in sw)
    # each file reads back, through either package, to the parameters
    for path in (pp, jp):
        p1, c1, k1 = reference_sav.import_module(
            reference_sav.load_torch_module(path))
        p2, c2, k2 = jax_ti.import_module(jax_ti.load_torch_module(path))
        assert k1 == k2 == ("inference" if kind == "inference"
                            else "generator")
        assert _trees_equal(p1, params) and _trees_equal(p2, params)
        assert c1 == port_cfg and c2 == cfg


def test_export_tool_converts_a_port_checkpoint(tmp_path, capsys):
    q_net, p_net = _nets()
    for kind, net in (("generator", p_net), ("inference", q_net)):
        src, dst = str(tmp_path / f"{kind}.sav"), str(tmp_path / "out.sav")
        checkpoint.save_model(src, kind, net)
        assert export_tool.main([src, dst]) == 0
        assert f"# wrote {kind} torch module to {dst}" in \
            capsys.readouterr().out
        params, cfg, got_kind = jax_ti.import_module(
            jax_ti.load_torch_module(dst))
        want, want_cfg, _, _ = checkpoint.load_model_meta(src)
        assert got_kind == kind and _trees_equal(params, want)
        assert to_port(cfg) == want_cfg
    assert export_tool.main([src]) == 2
