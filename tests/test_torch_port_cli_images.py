"""The port's galaxy and mnist CLIs (``python -m
spatialvae_torch.cli.train_galaxy`` / ``train_mnist``) against the JAX
package's, on the CPU (``-d -1``), on the cases of ``tests/test_cli.py``
(the contracts, ``--make_mono --invert_colours``, ``--vanilla``, the
evaluation interval, no pose, ``--dataset galaxy`` and the raw idx files):
each pair of runs, from its own copy of the same files, gives the same TSV
format, the same ``outputs_{prefix}`` file names and archive members,
``models.txt`` byte for byte, ``command.txt`` rows after the invocation
line, the input-sample grid pixel for pixel (the other grids in the same
geometry), and SVGs that hold the run's own rows.  From one init (both
CLIs resumed from one JAX-written pair of checkpoints) three epochs give
per-epoch validation ELBOs within 1% relative, for the spatial and the
vanilla generator.  ``--profile-dir`` and ``--debug-nans`` leave a sound
run's lines as they are.  The flags whose module is not ported raise
before any work.  (Both CLIs with JAX, PIL, matplotlib, pandas and torchvision
unimportable: ``test_torch_port_isolation.py``.)
"""

import gzip
import json
import os
import re
import struct
import xml.etree.ElementTree as ET
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from spatialvae_tpu.cli import train_galaxy as jax_galaxy
from spatialvae_tpu.cli import train_mnist as jax_mnist

from spatialvae_torch.api import SpatialVae
from spatialvae_torch.cli import train_galaxy, train_mnist
from spatialvae_torch.io.png import read_png
from tests.port_configs import one_torch_thread  # noqa: F401

HEADER = ["Epoch", "ELBO", "BCE loss", "KL"]
SVG = "{http://www.w3.org/2000/svg}"


@pytest.fixture(autouse=True)
def _noninteractive(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_ASSUME_YES", "1")


def _u8(rng, shape):
    return (rng.rand(*shape) * 255).astype(np.uint8)


def _mnist_rotated(d):
    rng = np.random.RandomState(0)
    (d / "data" / "mnist_rotated").mkdir(parents=True)
    np.save(d / "data" / "mnist_rotated" / "images_train.npy",
            _u8(rng, (96, 10, 10)))
    np.save(d / "data" / "mnist_rotated" / "images_test.npy",
            _u8(rng, (40, 10, 10)))


def _galaxy_zoo(d):
    rng = np.random.RandomState(9)
    (d / "data" / "galaxy_zoo").mkdir(parents=True)
    np.save(d / "data" / "galaxy_zoo" / "galaxy_zoo_train.npy",
            _u8(rng, (32, 8, 8, 3)))
    np.save(d / "data" / "galaxy_zoo" / "galaxy_zoo_test.npy",
            _u8(rng, (16, 8, 8, 3)))


def _write_idx(path, imgs, gz=False):
    payload = struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


def _mnist_idx(d):
    rng = np.random.RandomState(0)
    (d / "data" / "mnist").mkdir(parents=True)
    _write_idx(d / "data" / "mnist" / "train-images-idx3-ubyte",
               rng.randint(0, 255, size=(10, 6, 6), dtype=np.uint8))
    _write_idx(d / "data" / "mnist" / "t10k-images-idx3-ubyte.gz",
               rng.randint(0, 255, size=(4, 6, 6), dtype=np.uint8), gz=True)


def _galaxy_files(seed, n_train, n_test):
    def make(d):
        rng = np.random.RandomState(seed)
        np.save(d / "gt.npy", _u8(rng, (n_train, 8, 8, 3)))
        np.save(d / "gv.npy", _u8(rng, (n_test, 8, 8, 3)))
    return make


P = ["--p_hidden_dim", "16", "--q_hidden_dim", "16"]
P8 = ["--p_hidden_dim", "8", "--q_hidden_dim", "8"]
# name -> (CLI, data writer, argv, prefix, train rows, validation rows)
CASES = {
    "mnist_contract": ("mnist", _mnist_rotated, [
        "--dataset", "mnist-rotated", "--num_epochs", "2",
        "--minibatch_size", "36", "--save_interval", "2"] + P, "t", 2, 2),
    "mnist_eval_interval": ("mnist", _mnist_rotated, [
        "--dataset", "mnist-rotated", "--num_epochs", "4",
        "--minibatch_size", "32", "--save_interval", "4",
        "--eval-interval", "2"] + P, "ei", 4, 2),
    "mnist_vanilla": ("mnist", _mnist_rotated, [
        "--dataset", "mnist-rotated", "--num_epochs", "1",
        "--minibatch_size", "32", "--vanilla", "--save_interval", "1",
        "--save-optimizer"] + P, "v", 1, 1),
    "mnist_no_pose": ("mnist", _mnist_rotated, [
        "--dataset", "mnist-rotated", "--num_epochs", "1",
        "--minibatch_size", "32", "--no_rotate", "--no_translate", "-z",
        "4", "--save_interval", "1"] + P8, "nr", 1, 1),
    "mnist_galaxy_dataset": ("mnist", _galaxy_zoo, [
        "--dataset", "galaxy", "--num_epochs", "1", "--minibatch_size",
        "16", "--save_interval", "1"] + P8, "gx", 1, 1),
    "mnist_idx": ("mnist", _mnist_idx, [
        "--dataset", "mnist", "--num_epochs", "2", "--minibatch_size", "4",
        "--save_interval", "1"] + P8, "ix", 2, 2),
    "galaxy_contract": ("galaxy", _galaxy_files(3, 48, 16), [
        "gt.npy", "gv.npy", "--num_epochs", "2", "--minibatch_size", "16",
        "--p_hidden_dim", "12", "--q_hidden_dim", "16", "-z", "3",
        "--save_interval", "2", "--num_train_images", "32", "--z_delay",
        "1"], "g", 2, 2),
    "galaxy_mono_invert_augment": ("galaxy", _galaxy_files(4, 32, 16), [
        "gt.npy", "gv.npy", "--num_epochs", "1", "--minibatch_size", "16",
        "--make_mono", "--invert_colours", "--augment_rotation",
        "--save_interval", "1"] + P8, "m", 1, 1),
    "galaxy_vanilla": ("galaxy", _galaxy_files(6, 32, 16), [
        "gt.npy", "gv.npy", "--num_epochs", "1", "--minibatch_size", "16",
        "--vanilla", "--save_interval", "1", "--save-optimizer"] + P8,
        "vg", 1, 1),
}
MAINS = {"galaxy": (train_galaxy.main, jax_galaxy.main),
         "mnist": (train_mnist.main, jax_mnist.main)}


def _tsv(out):
    return [ln.split("\t") for ln in out.splitlines() if "\t" in ln]


def _tree(d, prefix):
    """File names under outputs_{prefix}, and the archive's members, with
    the date stamp taken out."""
    root = d / f"outputs_{prefix}"
    files = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
    zips = [f for f in os.listdir(d) if f.endswith(f"_outputs_{prefix}.zip")]
    assert len(zips) == 1 and re.fullmatch(r"\d{6}_\d{4}_outputs_.*", zips[0])
    with zipfile.ZipFile(d / zips[0]) as zf:
        members = sorted(zf.namelist())
    return files, members


def _svg_series(path):
    root = ET.parse(path).getroot()
    return {g.get("data-label"): [float(v) for v in
                                  g.get("data-values").split()]
            for g in root.iter(SVG + "g")
            if g.get("id", "").startswith("series-")}


def _results(path):
    return np.array([[float(v) for v in ln.split("\t")]
                     for ln in path.read_text().splitlines()[1:]])


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_cli(tmp_path, capsys, monkeypatch, case):
    cli, make, argv, prefix, n_train, n_val = CASES[case]
    runs = {}
    for side, main in zip(("port", "jax"), MAINS[cli]):
        d = tmp_path / side
        d.mkdir()
        make(d)
        monkeypatch.chdir(d)
        main(argv + ["-d", "-1", "--save_prefix", prefix])
        runs[side] = (d, _tsv(capsys.readouterr().out))
    (pd, got), (jd, want) = runs["port"], runs["jax"]
    # the TSV: the header, then each chunk's training rows and its
    # validation row, epochs 0-based
    assert got[0] == want[0] == HEADER
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == 1 + n_train + n_val and all(len(r) == 4 for r in got)
    assert np.isfinite([[float(v) for v in r] for r in got[1:]]).all()
    # the tree and the archive
    assert _tree(pd, prefix) == _tree(jd, prefix)
    po, jo = pd / f"outputs_{prefix}", jd / f"outputs_{prefix}"
    assert (po / "models.txt").read_bytes() == (jo / "models.txt").read_bytes()
    assert (po / "command.txt").read_text().splitlines()[1:] == \
        (jo / "command.txt").read_text().splitlines()[1:]
    for f in sorted((jo / "images").glob("*.png")):
        mine = po / "images" / f.name
        if f.name.startswith("_sample_"):
            np.testing.assert_array_equal(np.asarray(Image.open(mine)),
                                          np.asarray(Image.open(f)))
        assert read_png(str(mine)).shape[:2] == \
            np.asarray(Image.open(f)).shape[:2]
    # the results files hold the printed rows: training, then validation
    lines = {f: [ln.split("\t") for ln in
                 (po / f).read_text().splitlines()]
             for f in ("train.txt", "val.txt")}
    assert lines["train.txt"][0] == lines["val.txt"][0] == HEADER
    assert len(lines["train.txt"]) == 1 + n_train
    assert sorted(lines["train.txt"][1:] + lines["val.txt"][1:]) == \
        sorted(got[1:])
    train, val = _results(po / "train.txt"), _results(po / "val.txt")
    for fname, col in (("ELBO.svg", 1), ("BCE_Loss.svg", 2),
                       ("KL_Divergence.svg", 3)):
        series = _svg_series(po / "images" / fname)
        assert series == {"Training": list(train[:, col]),
                          "Validation": list(val[:, col])}
    if cli == "galaxy":
        log = (po / "run.log").read_text()
        assert "Started" in log and "Finished" in log
    gens = sorted((po / "trained").glob("*_generator_*.sav"))
    assert len(gens) == 1
    model = SpatialVae.load(str(gens[0]), str(gens[0]).replace(
        "generator", "inference"), device="cpu")
    assert model.vanilla == ("--vanilla" in argv)
    assert (model.pose_dims == 0) == ("--vanilla" in argv
                                      or "--no_rotate" in argv)


def test_load_mnist_arrays_matches_jax(tmp_path, monkeypatch, capsys):
    """The idx reader (plain, .gz, MNIST/raw), the npy files first, and a
    missing set raising with where to put it."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="data/mnist/.*M9d"):
        train_mnist.load_mnist_arrays("mnist")
    raw = tmp_path / "data" / "mnist" / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(1)
    tr = rng.randint(0, 255, size=(7, 5, 6), dtype=np.uint8)
    te = rng.randint(0, 255, size=(3, 5, 6), dtype=np.uint8)
    _write_idx(raw / "train-images-idx3-ubyte.gz", tr, gz=True)
    _write_idx(raw / "t10k-images-idx3-ubyte", te)
    for got, want in zip(train_mnist.load_mnist_arrays("mnist"), (tr, te)):
        np.testing.assert_array_equal(got, want)
    np.save(tmp_path / "data" / "mnist" / "images_train.npy", tr[:2])
    np.save(tmp_path / "data" / "mnist" / "images_test.npy", te[:1])
    got = train_mnist.load_mnist_arrays("mnist")
    for a, b in zip(got, jax_mnist.load_mnist_arrays("mnist")):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (2, 5, 6)


def _blobs(n, side, channels, rng):
    """Smooth uint8 blob images of random centre, size and colour."""
    ax = np.linspace(-1, 1, side)
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    cx, cy = rng.uniform(-.4, .4, (2, n, 1, 1))
    s = rng.uniform(.15, .4, (n, 1, 1))
    img = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s ** 2))
    col = rng.uniform(.4, 1.0, (n, 1, 1, channels))
    return np.clip(img[..., None] * col * 255, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("which", ["galaxy_spatial", "mnist_vanilla"])
def test_one_init_three_epochs_within_one_percent(tmp_path, capsys,
                                                  monkeypatch, which):
    """Both CLIs resume one JAX-written pair of checkpoints (the JAX CLI's
    model after one epoch at lr 1e-3, past the first epoch's steep fall,
    where two runs of one package with different seeds sit 0.7-0.9% apart)
    and train three epochs (lr 5e-4, the vanilla generator 2e-3) on the
    same 4,096 blob images; each epoch's validation ELBO (2,048 images)
    agrees within 1% relative, though each CLI draws its own noise and
    batch order (measured, seeds 0 and 1: galaxy 0.01-0.2% apart, vanilla
    mnist 0.01-0.32%)."""
    side, z = 12, 2
    rng = np.random.RandomState(7)
    monkeypatch.chdir(tmp_path)
    if which == "galaxy_spatial":
        cli = "galaxy"
        np.save("gt.npy", _blobs(4096, side, 3, rng))
        np.save("gv.npy", _blobs(2048, side, 3, rng))
        argv = ["gt.npy", "gv.npy", "--p_num_layers", "2", "--q_num_layers",
                "2"]
        tag, lr = "pnl2qnl2", "5e-4"
    else:
        cli = "mnist"
        os.makedirs("data/mnist")
        np.save("data/mnist/images_train.npy",
                _blobs(4096, side, 1, rng)[..., 0])
        np.save("data/mnist/images_test.npy",
                _blobs(2048, side, 1, rng)[..., 0])
        argv = ["--dataset", "mnist", "--vanilla", "--num_layers", "2"]
        tag, lr = "nl2", "2e-3"
    argv += ["--minibatch_size", "32", "-z", str(z), "--p_hidden_dim", "32",
             "--q_hidden_dim", "32", "-d", "-1"]
    port_main, jax_main = MAINS[cli]
    jax_main(argv + ["--num_epochs", "1", "--learning_rate", "1e-3",
                     "--save_interval", "1", "--save_prefix", "init"])
    trained = tmp_path / "outputs_init" / "trained"
    argv += ["--num_epochs", "3", "--learning_rate", lr,
             "--save_interval", "3", "--resume-generator",
             str(trained / "init_generator_epoch1.sav"),
             "--resume-inference", str(trained / "init_inference_epoch1.sav")]
    elbos = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        main(argv + ["--save_prefix", name])
        elbos[name] = _results(tmp_path / f"outputs_{name}" / "val.txt")[:, 1]
    capsys.readouterr()
    pairs = list(zip(elbos["port"], elbos["jax"]))
    assert len(pairs) == 3
    for g, w in pairs:
        assert abs(g - w) <= 0.01 * abs(w), pairs
    # the run trains: the validation ELBO rises by more than the band
    # (measured: galaxy 3.2%, vanilla mnist 1.5-1.6%)
    assert pairs[-1][1] > pairs[0][1] + 0.01 * abs(pairs[0][1]), pairs
    np.testing.assert_array_equal(
        *(np.asarray(Image.open(f"outputs_{name}/images/_sample_{name}_z{z}"
                                f"{tag}ep3.png")) for name in ("port", "jax")))


@pytest.mark.parametrize("flag", [["--profile-dir", "trace"],
                                  ["--debug-nans"]], ids=lambda v: v[0])
@pytest.mark.parametrize("cli", ["galaxy", "mnist"])
def test_diagnostic_flags_run(tmp_path, monkeypatch, capsys, cli, flag):
    """A sound run prints the same TSV lines with the flag; ``--profile-dir``
    leaves the trace of epoch 2 (index 1), the step's labels in it."""
    monkeypatch.chdir(tmp_path)
    if cli == "galaxy":
        _galaxy_files(3, 32, 16)(tmp_path)
        argv = ["gt.npy", "gv.npy", "--minibatch_size", "16"]
    else:
        _mnist_rotated(tmp_path)
        argv = ["--dataset", "mnist-rotated", "--minibatch_size", "32"]
    argv += ["-d", "-1", "--num_epochs", "2", "--save_interval", "2"] + P8
    main = MAINS[cli][0]
    main(argv + ["--save_prefix", "a"])
    want = _tsv(capsys.readouterr().out)
    main(argv + ["--save_prefix", "b"] + flag)
    assert _tsv(capsys.readouterr().out) == want
    if flag[0] == "--profile-dir":
        with open(os.path.join("trace", "epoch2.pt.trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"loss_and_grad", "adam"} <= names


@pytest.mark.parametrize("flag,item", [
    (["--mesh-model", "2"], (NotImplementedError, "M10b")),
    (["--coordinator", "h:1"], (ValueError, "go together")),
    (["--num-processes", "2"], (ValueError, "go together")),
    (["--process-id", "0"], (ValueError, "go together")),
    (["--matmul-precision", "high"], (NotImplementedError, "'highest'"))],
    ids=lambda v: v[0] if isinstance(v, list) else v[1])
@pytest.mark.parametrize("cli", ["galaxy", "mnist"])
def test_unported_flags_raise_before_any_work(tmp_path, monkeypatch, cli,
                                              flag, item):
    """Before the outputs tree is made or any file read: a model axis on a
    float decoder (the JAX CLI's GSPMD tensor-parallel path, ROADMAP M10b)
    raises ``NotImplementedError`` naming M10b; a multi-host flag without
    the other two raises ``ValueError`` (nothing detects them); the
    non-default matmul precision is refused."""
    monkeypatch.chdir(tmp_path)
    argv = ["missing.npy", "missing.npy"] if cli == "galaxy" else []
    with pytest.raises(item[0], match=item[1]):
        MAINS[cli][0](argv + ["-d", "-1", "--save_prefix", "x"] + flag)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("cli", ["galaxy", "mnist"])
def test_the_card_is_the_default_and_nothing_falls_back(tmp_path,
                                                        monkeypatch, cli):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["missing.npy", "missing.npy"] if cli == "galaxy" else []
    for extra in ([], ["-d", "0"]):
        with pytest.raises(RuntimeError, match="-d -1"):
            MAINS[cli][0](argv + extra)
    assert os.listdir(tmp_path) == []
