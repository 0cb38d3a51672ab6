"""The port's particles CLI (``python -m spatialvae_torch.cli.train_particles``)
against the JAX package's, on the CPU (``-d -1``): the cases of
``tests/test_cli.py`` (the contract with CTF, the colored likelihood, the
mask and normalisation; the underscore spellings) and the spatial
generator's options give the same TSV lines and the same file names; from
one init (both CLIs resumed from one JAX-written pair of checkpoints) three
epochs give per-epoch test ELBOs within 1% relative, ``BASELINE.json``'s
band (the noise and batch order of the two are independent); resume with
the Adam state continues the uninterrupted trajectory; ``--no-preload``,
``--profile-dir`` and ``--debug-nans`` leave a sound run's lines as they
are; JAX-written bf16 Adam states resume; the flags whose module is not
ported raise before any work; the checkpoint cadence and its background
writes.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatialvae_tpu.cli import train_particles as jax_cli
from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import checkpoint as jax_ckpt
from spatialvae_tpu.train import optimizer as jax_opt
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.api import SpatialVae
from spatialvae_torch.cli import common
from spatialvae_torch.cli import train_particles as cli
from spatialvae_torch.io.mrc import write_mrc
from spatialvae_torch.train import checkpoint as ckpt
from tests.port_configs import one_torch_thread  # noqa: F401

HEADER = "Epoch\tSplit\tELBO\tError\tKL"


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _tsv(out: str) -> list:
    return [ln.split("\t") for ln in out.splitlines() if "\t" in ln]


def _run(main, argv, capsys) -> list:
    main(argv)
    return _tsv(capsys.readouterr().out)


def _contract_data(d):
    """``tests/test_cli.py``'s particles data and CTF tables."""
    rng = np.random.RandomState(1)
    np.save(d / "tr.npy", rng.randn(64, 9, 9).astype(np.float32))
    np.save(d / "te.npy", rng.randn(32, 9, 9).astype(np.float32))
    rows = [f"1.5 2.0 300.0 1.2 50.0 10.0 0.0 {i}" for i in range(64)]
    (d / "ctf.txt").write_text("\n".join(rows))
    (d / "ctf_te.txt").write_text("\n".join(rows[:32]))


CASES = {
    "contract": (["tr.npy", "te.npy", "--num-epochs", "2",
                  "--minibatch-size", "32", "--p-hidden-dim", "12",
                  "--q-hidden-dim", "12", "--ctf-train", "ctf.txt",
                  "--ctf-test", "ctf_te.txt", "--fit-noise", "--mask",
                  "--normalize", "--save-interval", "1"], 2),
    "underscore": (["tr8.npy", "te8.npy", "--num_epochs", "1",
                    "--minibatch_size", "16", "--p_hidden_dim", "8",
                    "--q_hidden_dim", "8", "--save_interval", "1"], 1),
    "generator_options": (["tr.mrc", "te.mrc", "--num-epochs", "2",
                           "--minibatch-size", "16", "--p-hidden-dim", "12",
                           "--q-hidden-dim", "12", "--expand-coords",
                           "--bilinear", "--resid", "-c", "7",
                           "--save-interval", "2"], 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_cli(workdir, capsys, case):
    """Both CLIs on the same files with -d -1: the same TSV header, row
    labels and column count, finite values, the same checkpoint names (at
    the bare prefix, every interval), and the port's checkpoints load."""
    _contract_data(workdir)
    rng = np.random.RandomState(2)
    np.save(workdir / "tr8.npy", rng.randn(32, 8, 8).astype(np.float32))
    np.save(workdir / "te8.npy", rng.randn(16, 8, 8).astype(np.float32))
    for split, n in (("tr", 48), ("te", 16)):
        with open(workdir / f"{split}.mrc", "wb") as f:
            write_mrc(f, rng.randn(n, 9, 9).astype(np.float32))
    argv, epochs = CASES[case]
    got = _run(cli.main, argv + ["-d", "-1", "--save-prefix", "port/p"],
               capsys)
    want = _run(jax_cli.main, argv + ["-d", "-1", "--save-prefix", "jax/p"],
                capsys)
    assert got[0] == want[0] == HEADER.split("\t")
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[:2] for r in got[1:]] == [[str(e), s] for e in
                                        range(1, epochs + 1)
                                        for s in ("train", "test")]
    assert all(len(r) == 5 for r in got)
    assert np.isfinite([[float(v) for v in r[2:]] for r in got[1:]]).all()
    names = sorted(os.listdir(workdir / "port"))
    assert names == sorted(os.listdir(workdir / "jax")) and names
    gp = str(workdir / "port" / names[0])
    model = SpatialVae.load(gp, gp.replace("generator", "inference"),
                            device="cpu")
    assert model.ecfg.likelihood == (
        "colored" if "--fit-noise" in argv else "gaussian")


def _particles(n, side, rng):
    """Particle-like images: an anisotropic Gaussian blob of random centre,
    orientation and contrast, plus noise."""
    ax = np.linspace(-1, 1, side)
    yy, xx = np.meshgrid(-ax, ax, indexing="ij")
    cx, cy, th = (rng.uniform(-.2, .2, (n, 1, 1)),
                  rng.uniform(-.2, .2, (n, 1, 1)),
                  rng.uniform(0, 2 * np.pi, (n, 1, 1)))
    r0 = np.cos(th) * (xx - cx) + np.sin(th) * (yy - cy)
    r1 = -np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy)
    img = np.exp(-(r0 ** 2 / 0.08 + r1 ** 2 / 0.02))
    img = img * rng.uniform(.3, 1, (n, 1, 1))
    return (img + 0.3 * rng.standard_normal(img.shape)).astype(np.float32)


def test_one_init_three_epochs_within_one_percent(workdir, capsys):
    """Both CLIs resume one JAX-written pair of checkpoints and train three
    epochs on the same 16x16 particles (lr 1e-3, so the ELBO moves by
    several percent); the test ELBOs of each epoch agree within 1%
    relative (measured: 0.02-0.18%), though each CLI draws its own noise
    and batch order."""
    side, z = 16, 2
    rng = np.random.default_rng(7)
    np.save(workdir / "tr.npy", _particles(1024, side, rng))
    np.save(workdir / "te.npy", _particles(512, side, rng))
    q_cfg = InferenceConfig(n=side * side, latent_dim=z + 3, hidden_dim=32,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=z, hidden_dim=32,
                                   num_layers=2)
    jt = jax_trainer.Trainer(q_cfg, p_cfg,
                             JaxElboConfig(likelihood="gaussian"),
                             jax_trainer.TrainConfig(seed=3),
                             jnp.asarray(jax_grid(side, side)))
    jax_ckpt.save_model("init_generator.sav", "generator",
                        jt.state.params["p"], p_cfg)
    jax_ckpt.save_model("init_inference.sav", "inference",
                        jt.state.params["q"], q_cfg)
    argv = ["tr.npy", "te.npy", "--num-epochs", "3", "--minibatch-size",
            "64", "--p-hidden-dim", "32", "--q-hidden-dim", "32", "--mask",
            "--normalize", "--resume-generator", "init_generator.sav",
            "--resume-inference", "init_inference.sav", "-d", "-1",
            "--learning-rate", "1e-3"]
    got = _run(cli.main, argv, capsys)
    want = _run(jax_cli.main, argv, capsys)
    tests = [(float(a[2]), float(b[2])) for a, b in zip(got, want)
             if a[1] == "test"]
    assert len(tests) == 3
    for g, w in tests:
        assert abs(g - w) <= 0.01 * abs(w), tests
    # the run trains: the test ELBO rises by several percent meanwhile
    assert tests[-1][1] > tests[0][1] + 0.02 * abs(tests[0][1])


def test_resume_continues_the_uninterrupted_run(workdir, capsys):
    """Two epochs with --save-optimizer, then a third resumed from their
    checkpoints, give the third epoch of a three-epoch run bit for bit; a
    JAX-written pair and Adam state resume too."""
    rng = np.random.RandomState(5)
    np.save(workdir / "tr.npy", rng.randn(40, 8, 8).astype(np.float32))
    np.save(workdir / "te.npy", rng.randn(20, 8, 8).astype(np.float32))
    base = ["tr.npy", "te.npy", "--minibatch-size", "16", "--p-hidden-dim",
            "8", "--q-hidden-dim", "8", "-d", "-1", "--z-delay", "1",
            "--save-interval", "1"]
    full = _run(cli.main, base + ["--num-epochs", "3", "--save-prefix",
                                  "full"], capsys)
    _run(cli.main, base + ["--num-epochs", "2", "--save-prefix", "a",
                           "--save-optimizer"], capsys)
    assert os.path.exists("a_optimizer_epoch2.sav")
    resumed = _run(cli.main, base + [
        "--num-epochs", "3", "--resume-generator", "a_generator_epoch2.sav",
        "--resume-inference", "a_inference_epoch2.sav",
        "--resume-optimizer", "a_optimizer_epoch2.sav"], capsys)
    assert resumed[0] == HEADER.split("\t")
    assert resumed[1:] == full[-2:]
    with pytest.raises(SystemExit, match="BOTH"):
        cli.main(base + ["--num-epochs", "3", "--resume-optimizer",
                         "a_optimizer_epoch2.sav"])
    # the JAX CLI's files resume in the port
    _run(jax_cli.main, base + ["--num-epochs", "2", "--save-prefix", "j",
                               "--save-optimizer"], capsys)
    rows = _run(cli.main, base + [
        "--num-epochs", "3", "--resume-generator", "j_generator_epoch2.sav",
        "--resume-inference", "j_inference_epoch2.sav",
        "--resume-optimizer", "j_optimizer_epoch2.sav"], capsys)
    assert [r[:2] for r in rows[1:]] == [["3", "train"], ["3", "test"]]


def test_eval_interval_keeps_the_trajectory(workdir, capsys):
    rng = np.random.RandomState(6)
    np.save(workdir / "tr.npy", rng.randn(40, 8, 8).astype(np.float32))
    np.save(workdir / "te.npy", rng.randn(20, 8, 8).astype(np.float32))
    base = ["tr.npy", "te.npy", "--minibatch-size", "16", "--p-hidden-dim",
            "8", "--q-hidden-dim", "8", "-d", "-1", "--num-epochs", "4"]
    one = _run(cli.main, base, capsys)
    two = _run(cli.main, base + ["--eval-interval", "2"], capsys)
    assert [r for r in two if r[1] == "train"] == \
        [r for r in one if r[1] == "train"]
    assert [r for r in two if r[1] == "test"] == \
        [r for r in one if r[1] == "test" and r[0] in ("2", "4")]


@pytest.mark.parametrize("flag,item", [
    (["--mesh-model", "2"], (NotImplementedError, "M10b")),
    (["--coordinator", "h:1"], (ValueError, "go together")),
    (["--num-processes", "2"], (ValueError, "go together")),
    (["--process-id", "0"], (ValueError, "go together")),
    (["--matmul-precision", "high"], (NotImplementedError, "'highest'"))],
    ids=lambda v: v[0] if isinstance(v, list) else v[1])
def test_unported_flags_raise_before_any_work(workdir, flag, item):
    """The data files do not exist: a flag that got past the check would
    fail on them instead.  A model axis on a float decoder is the JAX CLI's
    GSPMD tensor-parallel path (M10b); a multi-host flag needs the other
    two."""
    with pytest.raises(item[0], match=item[1]):
        cli.main(["missing.npy", "missing.npy", "-d", "-1"] + flag)


@pytest.mark.parametrize("flag", [["--no-preload"],
                                  ["--profile-dir", "trace"],
                                  ["--debug-nans"]], ids=lambda v: v[0])
def test_streaming_and_diagnostic_flags_run(workdir, capsys, flag):
    """Each flag's run prints the plain run's TSV lines bit for bit;
    ``--profile-dir`` leaves the trace of epoch 2 (index 1) with the step's
    labels in it."""
    rng = np.random.RandomState(5)
    np.save(workdir / "tr.npy", rng.randn(40, 8, 8).astype(np.float32))
    np.save(workdir / "te.npy", rng.randn(20, 8, 8).astype(np.float32))
    base = ["tr.npy", "te.npy", "--minibatch-size", "16", "--p-hidden-dim",
            "8", "--q-hidden-dim", "8", "-d", "-1", "--num-epochs", "3"]
    want = _run(cli.main, base, capsys)
    assert _run(cli.main, base + flag, capsys) == want
    if flag[0] == "--profile-dir":
        with open(common.trace_path("trace")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"loss_and_grad", "adam"} <= names


def test_bf16_moment_optimizer_checkpoints_resume(workdir, capsys):
    """A JAX-written pair and bf16 Adam state (``--adam-moments bf16
    --save-optimizer`` in the JAX CLI) resume in the port, in bf16."""
    rng = np.random.RandomState(0)
    np.save(workdir / "tr.npy", rng.randn(40, 8, 8).astype(np.float32))
    base = ["tr.npy", "tr.npy", "-d", "-1", "--p-hidden-dim", "8",
            "--q-hidden-dim", "8", "--minibatch-size", "16",
            "--adam-moments", "bf16"]
    _run(jax_cli.main, base + ["--num-epochs", "1", "--save-prefix", "j",
                               "--save-optimizer", "--save-interval", "1"],
         capsys)
    rows = _run(cli.main, base + [
        "--num-epochs", "2", "--resume-generator", "j_generator_epoch1.sav",
        "--resume-inference", "j_inference_epoch1.sav",
        "--resume-optimizer", "j_optimizer_epoch1.sav"], capsys)
    assert [r[:2] for r in rows[1:]] == [["2", "train"], ["2", "test"]]
    assert np.isfinite([float(v) for r in rows[1:] for v in r[2:]]).all()


def test_the_card_is_the_default_and_nothing_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["-d", "0"]):
        with pytest.raises(RuntimeError, match="-d -1"):
            cli.main(["missing.npy", "missing.npy"] + argv)
    assert common.resolve_cli_device(-1) == torch.device("cpu")
    with pytest.raises(ValueError):
        common.resolve_cli_device(-3)


def test_ctf_with_bf16_compute_raises(workdir):
    _contract_data(workdir)
    with pytest.raises(ValueError, match="float32"):
        cli.main(["tr.npy", "te.npy", "-d", "-1", "--ctf-train", "ctf.txt",
                  "--compute-dtype", "bfloat16"])


def test_env_knobs_are_scoped_to_the_run(workdir, capsys, monkeypatch):
    """--int8-sr sets SPATIALVAE_SR=1 with the knobs allowed and
    --adam-moments the moments' dtype, for the run only."""
    from spatialvae_torch.train.trainer import Trainer

    rng = np.random.RandomState(8)
    np.save(workdir / "tr.npy", rng.randn(16, 8, 8).astype(np.float32))
    monkeypatch.delenv("SPATIALVAE_SR", raising=False)
    monkeypatch.delenv("SPATIALVAE_ALLOW_KNOBS", raising=False)
    monkeypatch.setenv("SPATIALVAE_ADAM_MOMENTS", "f32")
    seen = []
    real = Trainer.train_epoch

    def spy(self, *a, **k):
        seen.append({n: os.environ.get(n) for n in (
            "SPATIALVAE_SR", "SPATIALVAE_ALLOW_KNOBS",
            "SPATIALVAE_ADAM_MOMENTS")})
        seen.append(next(iter(self.opt_state.mu.values())).dtype)
        return real(self, *a, **k)

    monkeypatch.setattr(Trainer, "train_epoch", spy)
    _run(cli.main, ["tr.npy", "tr.npy", "-d", "-1", "--num-epochs", "1",
                    "--minibatch-size", "8", "--p-hidden-dim", "8",
                    "--q-hidden-dim", "8", "--int8-sr", "--adam-moments",
                    "bf16"], capsys)
    assert seen == [{"SPATIALVAE_SR": "1", "SPATIALVAE_ALLOW_KNOBS": "1",
                     "SPATIALVAE_ADAM_MOMENTS": "bf16"}, torch.bfloat16]
    assert "SPATIALVAE_SR" not in os.environ
    assert "SPATIALVAE_ALLOW_KNOBS" not in os.environ
    assert os.environ["SPATIALVAE_ADAM_MOMENTS"] == "f32"


def test_checkpoint_cadence_names_and_background_writes(workdir):
    """Every save_interval epochs, zero-padded to the run's digits; a write
    is queued with a host copy, so an in-place update after it does not
    reach the file; wait_for_checkpoints raises a write's error."""
    from spatialvae_torch.checkpoint import load_model_meta
    from spatialvae_torch.config import SpatialGeneratorConfig as Cfg
    from spatialvae_torch.models import InferenceNetwork, SpatialGenerator
    from spatialvae_torch.config import InferenceConfig as QCfg

    g = torch.Generator().manual_seed(0)
    p_net = SpatialGenerator(Cfg(latent_dim=2, hidden_dim=8, num_layers=2),
                             generator=g)
    q_net = InferenceNetwork(QCfg(n=16, latent_dim=5, hidden_dim=8),
                             generator=g)
    assert ckpt.checkpoint_paths("run", 4, 3) == (
        "run_generator_epoch005.sav", "run_inference_epoch005.sav")
    assert ckpt.optimizer_path("run", 9, 2, "out") == os.path.join(
        "out", "run_optimizer_epoch10.sav")
    saved = [e for e in range(6) if ckpt.save_trained_models(
        "run", e, 1, 2, "trained", p_net, q_net)]
    assert saved == [1, 3, 5]
    assert not ckpt.save_trained_models(None, 1, 1, 2, None, p_net, q_net)
    bias = p_net.linears()[-1].bias
    before = bias.detach().clone()
    ckpt.save_model("snap.sav", "generator", p_net, async_write=True)
    with torch.no_grad():
        bias.add_(1.0)
    ckpt.wait_for_checkpoints()
    params, _, kind, _ = load_model_meta("snap.sav")
    assert kind == "generator"
    np.testing.assert_array_equal(params["layers"][-1]["b"], before.numpy())
    assert sorted(os.listdir("trained")) == sorted(
        n for e in (2, 4, 6) for n in (f"run_generator_epoch{e}.sav",
                                       f"run_inference_epoch{e}.sav"))
    with open("x.sav", "w"):                 # a file where a folder goes
        pass
    ckpt.save_model(os.path.join("x.sav", "y.sav"), "generator", p_net,
                    async_write=True)
    with pytest.raises(OSError):
        ckpt.wait_for_checkpoints()
    ckpt.wait_for_checkpoints()                       # the queue is empty
