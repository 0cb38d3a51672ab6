"""The port's run-output tree against the JAX package's, on the CPU:
``models.txt`` reprs byte for byte for every config kind; PNG grids
decoded (with PIL here, and with the port's own reader) equal to the JAX
writer's pixel for pixel; the SVG curves' series, their drawn points and
the legend's quadrant against matplotlib's figure of the same rows and
against ``legend_location``; ``command.txt``, the results files, the
archive's name and members, ``save_label`` and the prompt rule.
"""

import os
import re
import sys
import xml.etree.ElementTree as ET
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from spatialvae_tpu.core import config as jcfg
from spatialvae_tpu.io.png import save_image_grid as jax_save_grid
from spatialvae_tpu.models import torch_style_repr as jax_repr
from spatialvae_tpu.train import artifacts as jax_art
from spatialvae_tpu.train.plots import basic_run_plot as jax_plot
from spatialvae_tpu.train.plots import legend_location as jax_legend

from spatialvae_torch.io import png
from spatialvae_torch.models.reprs import torch_style_repr
from spatialvae_torch.train import artifacts as art
from spatialvae_torch.train import plots
from tests.port_configs import to_port

SVG = "{http://www.w3.org/2000/svg}"


@pytest.fixture(autouse=True)
def _noninteractive(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_ASSUME_YES", "1")


REPR_CONFIGS = [
    jcfg.InferenceConfig(n=784, latent_dim=5),
    jcfg.InferenceConfig(n=12288, latent_dim=23, hidden_dim=5000,
                         num_layers=2, activation="relu"),
    jcfg.InferenceConfig(n=1600, latent_dim=5, num_layers=3, resid=True,
                         activation="leakyrelu"),
    jcfg.SpatialGeneratorConfig(latent_dim=2),
    jcfg.SpatialGeneratorConfig(latent_dim=20, n_out=3, num_layers=2,
                                activation="sigmoid"),
    jcfg.SpatialGeneratorConfig(latent_dim=0, num_layers=2),
    jcfg.SpatialGeneratorConfig(latent_dim=2, n_out=2, num_layers=3,
                                softplus=True, resid=True,
                                expand_coords=True, bilinear=True),
    jcfg.VanillaGeneratorConfig(n=784, latent_dim=100, num_layers=2),
    jcfg.VanillaGeneratorConfig(n=12288, latent_dim=20, num_layers=1,
                                activation="relu"),
    jcfg.VanillaGeneratorConfig(n=1600, latent_dim=2, n_out=2, num_layers=3,
                                softplus=True, resid=True),
]


def test_models_txt_is_byte_identical(tmp_path, monkeypatch):
    for cfg in REPR_CONFIGS:
        assert torch_style_repr(to_port(cfg)) == jax_repr(cfg), cfg
    with pytest.raises(TypeError):
        torch_style_repr(object())
    monkeypatch.chdir(tmp_path)
    a, b = art.RunOutputs("p"), jax_art.RunOutputs("j")
    a.write_model_specs([torch_style_repr(to_port(c)) for c in REPR_CONFIGS])
    b.write_model_specs([jax_repr(c) for c in REPR_CONFIGS])
    assert (tmp_path / "outputs_p" / "models.txt").read_bytes() == \
        (tmp_path / "outputs_j" / "models.txt").read_bytes()


@pytest.mark.parametrize("b", [1, 37, 100])
@pytest.mark.parametrize("c", [1, 3])
def test_png_grid_pixels_match_jax(tmp_path, b, c):
    """Values below 0, above 1 and on the rounding edges included; a tensor
    input writes the same file as its numpy copy."""
    rng = np.random.default_rng(b * 10 + c)
    n, m = 9, 7
    x = rng.uniform(-0.2, 1.2, (b, n * m, c)).astype(np.float32)
    x[0, :4, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255, 0.5]
    jp, pp, tp = (str(tmp_path / f"{s}.png") for s in "jpt")
    jax_save_grid(x, jp, (n, m))
    png.save_image_grid(x, pp, (n, m))
    png.save_image_grid(torch.from_numpy(x.reshape(b, -1)), tp, (n, m))
    want = np.asarray(Image.open(jp))
    got = np.asarray(Image.open(pp))
    assert Image.open(pp).mode == ("L" if c == 1 else "RGB")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read_png(pp).reshape(want.shape), want)
    assert open(tp, "rb").read() == open(pp, "rb").read()
    xmaps = min(int(b ** 0.5), b)
    ymaps = -(-b // xmaps)
    assert want.shape[:2] == ((n + 3) * ymaps + 3, (m + 3) * xmaps + 3)


def test_png_reader_refuses_a_bad_crc(tmp_path):
    p = str(tmp_path / "x.png")
    png.save_image_grid(np.zeros((4, 16), np.float32), p, (4, 4))
    blob = bytearray(open(p, "rb").read())
    blob[20] ^= 1                             # a byte of IHDR's body
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(p)


def _rows(series):
    """Result rows (epoch, elbo, bce, kl) whose ELBO column is ``series``."""
    e = np.arange(len(series), dtype=float)
    s = np.asarray(series, dtype=float)
    return np.stack([e, s, -s * 0.97, 0.5 + 0.1 * np.sin(e)], axis=1)


CURVES = {
    "rising_flat": np.concatenate([np.linspace(-300, -150, 10),
                                   np.full(10, -150.0)]),
    "falling": -np.linspace(100.0, 300.0, 12) ** 0.5,
    "rising": np.linspace(-500.0, -100.0, 9) ** 1,
    "noisy": -200 + np.random.default_rng(0).normal(0, 5, 15).cumsum(),
    "short": np.array([-10.0, -9.0, -8.5]),
}


def _matplotlib_lines(path):
    """{color: [(x, y), ...]} of the clipped data lines in a matplotlib
    SVG, and the legend frame's centre."""
    root = ET.parse(path).getroot()
    lines = {}
    legend = None
    for g in root.iter(SVG + "g"):
        gid = g.get("id", "")
        if gid.startswith("line2d_"):
            for p in g.findall(SVG + "path"):
                style = p.get("style", "")
                color = re.search(r"stroke: (#[0-9a-f]{6})", style)
                if p.get("clip-path") and color:
                    nums = [float(v) for v in
                            re.findall(r"-?\d+\.?\d*", p.get("d"))]
                    lines[color.group(1)] = list(zip(nums[::2], nums[1::2]))
        if gid == "legend_1" and legend is None:
            frame = g.find(f"{SVG}g/{SVG}path")
            nums = [float(v) for v in re.findall(r"-?\d+\.?\d*",
                                                 frame.get("d"))]
            xs, ys = nums[::2], nums[1::2]
            legend = ((min(xs) + max(xs)) / 2, (min(ys) + max(ys)) / 2)
    return lines, legend


def _port_svg(path):
    root = ET.parse(path).getroot()
    series, points = {}, {}
    for g in root.iter(SVG + "g"):
        if g.get("id", "").startswith("series-"):
            label = g.get("data-label")
            series[label] = [float(v) for v in g.get("data-values").split()]
            points[label] = [tuple(float(v) for v in pt.split(","))
                             for poly in g.findall(SVG + "polyline")
                             for pt in poly.get("points").split()]
    legend = root.find(f".//{SVG}g[@id='legend']")
    texts = {t.get("id"): t.text for t in root.iter(SVG + "text")
             if t.get("id")}
    return series, points, legend, texts


@pytest.mark.parametrize("name", list(CURVES))
def test_svg_series_and_legend_match_matplotlib(tmp_path, name):
    """The same rows through both writers: each file's series hold the
    rows' values (matplotlib's drawn points equal the port's to 2e-3 pt),
    the titles and labels are the same, and the legend sits in
    ``legend_location``'s quadrant in both figures."""
    train = _rows(CURVES[name])
    val = _rows(CURVES[name][::2] + 3.0)
    jd, pd = tmp_path / "j", tmp_path / "p"
    jd.mkdir()
    pd.mkdir()
    jax_plot(train, val, str(jd))
    plots.basic_run_plot(train, val, str(pd))
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)) == [
        "BCE_Loss.svg", "ELBO.svg", "KL_Divergence.svg"]
    x0, y0, x1, y1 = plots.AXES
    for fname, col, title in (("ELBO.svg", 1, "ELBO"),
                              ("KL_Divergence.svg", 3, "KL Divergence"),
                              ("BCE_Loss.svg", 2, "BCE Loss")):
        series, points, legend, texts = _port_svg(pd / fname)
        assert series["Training"] == list(train[:, col])
        assert series["Validation"] == list(val[:, col])
        assert texts["title"] == texts["ylabel"] == title
        assert texts["xlabel"] == "Epoch"
        mpl, mpl_legend = _matplotlib_lines(jd / fname)
        for label, color in plots.SERIES:
            np.testing.assert_allclose(points[label], mpl[color], atol=2e-3)
        jtext = (jd / fname).read_text()
        for word in (title, "Epoch", "Training", "Validation"):
            assert f"<!-- {word} -->" in jtext
        loc = legend.get("data-loc")
        assert loc == plots.legend_location(train[:, col]) == \
            jax_legend(train[:, col])
        lx, ly = (float(v) for v in re.findall(
            r"-?\d+\.?\d*", legend.get("transform")))
        box = legend.find(SVG + "rect")
        cx = lx + float(box.get("width")) / 2
        cy = ly + float(box.get("height")) / 2
        for centre in ((cx, cy), mpl_legend):
            vertical, horizontal = loc.split()
            assert (centre[1] < (y0 + y1) / 2) == (vertical == "upper")
            if horizontal == "center":
                assert abs(centre[0] - (x0 + x1) / 2) < 1.0
            else:
                assert (centre[0] > (x0 + x1) / 2) == (horizontal == "right")


def test_svg_breaks_at_non_finite_values(tmp_path):
    train = _rows([-5.0, -4.0, float("nan"), -3.0, -2.5])
    plots.basic_run_plot(train, train, str(tmp_path))
    root = ET.parse(tmp_path / "ELBO.svg").getroot()
    g = root.find(f".//{SVG}g[@id='series-Training']")
    assert len(g.findall(SVG + "polyline")) == 2


def test_command_results_archive_and_label_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["train_galaxy.py", "a.npy", "b.npy",
                                      "-z", "20", "--augment_rotation"])
    args = {"train_path": "a.npy", "z_dim": 20, "p_num_layers": 2,
            "q_num_layers": 2, "save_prefix": None, "augment_rotation": True,
            "no_rotate": False, "num_epochs": 4, "learning_rate": 1e-4}
    outs = {}
    for key, mod in (("p", art), ("j", jax_art)):
        out = mod.RunOutputs(key)
        out.write_command(args)
        out.write_results(["Epoch\tELBO", "0\t-1.5"], ["Epoch\tELBO",
                                                       "0\t-1.25"])
        for sub in ("trained", "images"):
            (tmp_path / out.output_dir / sub / "f.bin").write_bytes(b"1")
        outs[key] = out.archive()
        out.finish()
    for f in ("command.txt", "train.txt", "val.txt"):
        assert (tmp_path / "outputs_p" / f).read_bytes() == \
            (tmp_path / "outputs_j" / f).read_bytes()
    assert (tmp_path / "outputs_p" / "command.txt").read_text() \
        .splitlines()[0] == "python train_galaxy.py a.npy b.npy -z 20 " \
                            "--augment_rotation"
    stamp = re.compile(r"\d{6}_\d{4}_outputs_([pj])\.zip$")
    for key, path in outs.items():
        assert path == os.path.abspath(os.path.basename(path))
        assert stamp.search(path).group(1) == key
    with zipfile.ZipFile(outs["p"]) as zp, zipfile.ZipFile(outs["j"]) as zj:
        assert sorted(n.replace("outputs_p", "outputs_j")
                      for n in zp.namelist()) == sorted(zj.namelist())
    for d in ({"z_dim": 2, "num_layers": 2, "num_epochs": 100},
              {"num_epochs": 3, "z_dim": 20, "p_num_layers": 2,
               "q_num_layers": 1, "seed": 4},
              {"z_dim": 5}):
        for prefix in ("run", None):
            assert art.save_label(d, prefix) == jax_art.save_label(d, prefix)
    assert art.save_label({"z_dim": 2, "num_layers": 2, "num_epochs": 100},
                          "t") == "t_z2nl2ep100"


def test_run_outputs_empty_the_tree_and_the_prompt_rule(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    art.RunOutputs("u")
    (tmp_path / "outputs_u" / "images" / "stale.png").write_bytes(b"x")
    art.RunOutputs("u")
    assert os.listdir(tmp_path / "outputs_u" / "images") == []
    monkeypatch.delenv("SPATIALVAE_ASSUME_YES")
    asked = []
    monkeypatch.setattr("builtins.input",
                        lambda msg: asked.append(msg) or "n")
    monkeypatch.setattr(sys.stdin, "isatty", lambda: False, raising=False)
    art.confirm_or_exit("go?")               # not a tty: no prompt
    monkeypatch.setattr(sys.stdin, "isatty", lambda: True, raising=False)
    with pytest.raises(SystemExit):
        art.confirm_or_exit("go?")
    monkeypatch.setenv("SPATIALVAE_ASSUME_YES", "1")
    art.confirm_or_exit("go?")
    assert asked == ["go?"]
