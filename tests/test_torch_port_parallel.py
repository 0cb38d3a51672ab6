"""The port's mesh layer (``spatialvae_torch/parallel/``) against the JAX
package's ``spatialvae_tpu/parallel/`` on the CPU, and the CLIs on a mesh:
ranks joined over gloo (``tests/torch_ranks.py``, one torch thread each;
they import no JAX), JAX on the suite's eight fake CPU devices.

- the mesh: rank r at (r // model, r % model), where
  ``np.asarray(devices).reshape(data, model)`` puts JAX's device r, its
  data and model groups the ranks of its column and of its row;
  ``MeshConfig.auto``, ``batch_sharding``'s rows (``P("data")``'s blocks),
  ``can_pixel_shard`` (JAX's answers);
- the collectives: ``sum_value``'s value summed over the axis with the
  local gradient, ``sum_grad``'s gradient summed;
- the pixel-sharded loss over a (1, 2) mesh against the JAX
  ``make_pixel_sharded_loss`` on two fake devices (Pallas interpret mode),
  Bernoulli with two outputs and Gaussian under a mask, at HW = 2,048: the
  value within 1e-5 relative, the gradients of the generator, theta, dx
  and z each within PIXEL_TOL of its largest value: the port's K3 plain
  version against JAX's kernel, a difference the sharding does not add to
  (each side's sharded call is its whole call to 1e-4), largest on theta's
  two elements, whose gradient is a difference of rotated dfold sums
  (measured 5.7e-3 / 3.0e-3 at most; 4.1e-4 / 1.1e-4 on the generator's
  leaves); and against the port's own whole call on one device as
  ``tests/test_parallel.py`` holds JAX's: 1e-5 relative on the value, 1e-4
  relative / 1e-5 absolute on every gradient element;
- K3's plain version with ``p_base``: under stochastic rounding two pixel
  slices draw the whole call's words (the quantised tiles equal, the sums
  within 1e-5 of the largest value, float32 reassociation), and
  ``sr90_counters``' rows start at ``p_base``;
- the dry run at n = 4 (``parallel/dryrun.py``: its five ``ok`` lines);
- the galaxy and particles CLIs under a torchrun-style environment on two
  CPU ranks, and the galaxy CLI with the multi-host flags (two hosts of
  one rank), each in a directory of its own holding the inputs: rank 0
  prints the TSV a one-process run prints, every number within 1% of its
  row's ELBO (the ranks' noise comes from a generator per data rank, so
  the numbers are another draw's), rank 1 prints nothing and writes
  nothing;
- what a mesh still refuses: a model axis that the pixel step cannot take
  raises ``NotImplementedError`` naming M10b, in the trainer and in the
  tensor-parallel layout; ``pixel_axis`` off the loss kernel's path raises
  ``ValueError``, as in JAX.
"""

import os
import re
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core import config as jax_config
from spatialvae_tpu.core.config import SpatialGeneratorConfig
from spatialvae_tpu.models import spatial_generator_init
from spatialvae_tpu.parallel import MeshConfig as JaxMeshConfig
from spatialvae_tpu.parallel import can_pixel_shard as jax_can_pixel_shard
from spatialvae_tpu.parallel import create_mesh as jax_create_mesh
from spatialvae_tpu.parallel import make_pixel_sharded_loss as jax_sharded

from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels.config import Numerics
from spatialvae_torch.parallel import MeshConfig, can_pixel_shard
from spatialvae_torch.parallel.sharding import (
    BatchSharding,
    param_shardings,
)
from tests import torch_ranks
from tests.port_configs import one_torch_thread  # noqa: F401

SHAPES = [(4, 1), (1, 4), (2, 2)]
# a gradient leaf against JAX's, relative to its largest value (max, mean)
PIXEL_TOL = (1e-2, 5e-3)
CLI_TOL = 1e-2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four():
    return torch_ranks.spawn(torch_ranks.many, 4, [
        ("mesh_layout", (SHAPES,)), ("collectives", ())])


def test_mesh_places_ranks_as_jax_places_devices(four):
    for k, (d, m) in enumerate(SHAPES):
        jmesh = jax_create_mesh(JaxMeshConfig(data=d, model=m),
                                devices=jax.devices()[:4])
        ids = np.vectorize(lambda dev: dev.id)(jmesh.devices)
        for r, got in enumerate(w[0][k] for w in four):
            di, mi, data_group, model_group = got
            assert ids[di, mi] == r
            assert data_group == list(ids[:, mi])
            assert model_group == list(ids[di, :])


def test_collectives_sum_values_and_gradients(four):
    """On the (2, 2) mesh's model axis: sum_value's value is the two ranks'
    sum and its gradient the local one; sum_grad's value is the local one
    and its gradient the sum."""
    for r, w in enumerate(four):
        got = w[1]
        partner = r ^ 1
        assert got["value"] == float((r + 1) + (partner + 1))
        assert got["value_grad"] == 3.0
        assert got["grad"] == float(3 * (r + 1) + 3 * (partner + 1))


def test_mesh_config_and_batch_rows_match_jax():
    assert MeshConfig.auto(8, model=2) == MeshConfig(4, 2)
    with pytest.raises(ValueError):
        MeshConfig.auto(6, model=4)
    rows = np.arange(12)
    jmesh = jax_create_mesh(JaxMeshConfig(data=4, model=2))
    from spatialvae_tpu.parallel import batch_sharding as jax_batch
    placed = jax.device_put(jnp.asarray(rows), jax_batch(jmesh))
    for shard in placed.addressable_shards:
        d = int(np.argwhere(np.vectorize(lambda dev: dev.id)(
            jmesh.devices) == shard.device.id)[0][0])
        np.testing.assert_array_equal(
            rows[BatchSharding(d, 4).rows(12)], np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not divide"):
        BatchSharding(0, 4).rows(10)
    for hw in (1024, 2048, 4096, 4100, 8192, 3072):
        for n in (1, 2, 4, 8):
            assert can_pixel_shard(hw, n) == jax_can_pixel_shard(hw, n)


def _pixel_cases():
    hw, b = 2048, 2
    cases = []
    for family, masked in (("bernoulli", False), ("gaussian", True)):
        n_out = 1 if family == "gaussian" else 2
        cfg = SpatialGeneratorConfig(latent_dim=4, hidden_dim=16,
                                     n_out=n_out, num_layers=2)
        params = spatial_generator_init(jax.random.PRNGKey(0), cfg)
        ks = jax.random.split(jax.random.PRNGKey(1), 6)
        y = jax.random.uniform(ks[4], (b, hw, n_out))
        mask = (jax.random.bernoulli(ks[5], 0.7, (hw,)).astype(jnp.float32)
                if masked else None)
        cases.append({
            "family": family, "cfg": jax_config.config_to_dict(cfg),
            "params": jax.tree_util.tree_map(np.asarray, params),
            "coords": np.asarray(jax.random.uniform(ks[0], (hw, 2),
                                                    minval=-1, maxval=1)),
            "theta": np.asarray(jax.random.normal(ks[1], (b,)) * 0.5),
            "dx": np.asarray(jax.random.normal(ks[2], (b, 2)) * 0.1),
            "z": np.asarray(jax.random.normal(ks[3], (b, 4))),
            "y_t": np.asarray(y.swapaxes(1, 2)),
            "mask": None if mask is None else np.asarray(mask),
            "jax_cfg": cfg})
    return cases


@pytest.fixture(scope="module")
def pixel():
    cases = _pixel_cases()
    send = [{k: v for k, v in c.items() if k != "jax_cfg"} for c in cases]
    return cases, torch_ranks.spawn(torch_ranks.pixel_loss, 2, send)


@pytest.mark.parametrize("at", [0, 1], ids=["bernoulli", "gaussian_mask"])
def test_pixel_sharded_loss_matches_jax(pixel, at, monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")
    cases, ranks = pixel
    c = cases[at]
    mesh = jax_create_mesh(JaxMeshConfig(data=1, model=2))
    sharded = jax_sharded(c["jax_cfg"], mesh, family=c["family"])
    mask = None if c["mask"] is None else jnp.asarray(c["mask"])

    def loss(p, th, d, zz):
        return sharded(p, jnp.asarray(c["coords"]), th, d, zz,
                       jnp.asarray(c["y_t"]), mask)

    v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        jax.tree_util.tree_map(jnp.asarray, c["params"]),
        *(jnp.asarray(c[k]) for k in ("theta", "dx", "z")))
    one = _port_whole_call(c)
    for got in (r[at] for r in ranks):
        np.testing.assert_allclose(got["value"], float(v), rtol=1e-5)
        np.testing.assert_allclose(got["value"], one["value"], rtol=1e-5)
        want = jax.tree_util.tree_leaves(g)
        mine = jax.tree_util.tree_leaves(
            (got["p"], got["theta"], got["dx"], got["z"]))
        whole = jax.tree_util.tree_leaves(
            (one["p"], one["theta"], one["dx"], one["z"]))
        assert len(mine) == len(want) == len(whole)
        for a, r, w in zip(mine, want, whole):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)
            r = np.asarray(r)
            d = np.abs(a - r) / (np.abs(r).max() or 1.0)
            assert d.max() <= PIXEL_TOL[0] and d.mean() <= PIXEL_TOL[1], (
                a.shape, d.max(), d.mean())


def _port_whole_call(c) -> dict:
    """The port's K3 op on the whole grid on one device (its plain
    version), with the gradients the sharded loss returns."""
    from spatialvae_torch.config import config_from_dict
    from spatialvae_torch.io.jax_params import (
        generator_from_jax,
        generator_to_jax,
    )

    gen = generator_from_jax(c["params"], config_from_dict(c["cfg"]))
    t = {k: torch.from_numpy(c[k]).requires_grad_()
         for k in ("theta", "dx", "z")}
    y_t = torch.from_numpy(c["y_t"])
    loss = l8.fused_bce_spatial_int8(
        gen, torch.from_numpy(c["coords"]), t["theta"], t["dx"], t["z"],
        y_t.transpose(1, 2), y_t=y_t,
        mask=None if c["mask"] is None else torch.from_numpy(c["mask"]),
        family=c["family"])
    loss.backward()
    for p in gen.parameters():
        p.data = p.grad
    return {"value": float(loss.detach()), "p": generator_to_jax(gen),
            **{k: v.grad.numpy() for k, v in t.items()}}


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_sr_slices_draw_the_whole_calls_words(wdt):
    """K3's plain version under SR: the pixels 0..1023 and 1024..2047 of a
    2,048-pixel call, each with its p_base, give the whole call's
    quantised tiles exactly and its sums within 1e-5 of their largest
    value; without p_base the second slice draws other words."""
    g = torch.Generator().manual_seed(3)
    b, hw, h, no = 2, 2048, 40, 3
    fold = torch.randn((b, 4, h), generator=g) * 0.5
    fold[:, 3] = 0
    coords = torch.rand((hw, 2), generator=g) * 2 - 1
    w1 = (torch.randn((h, h), generator=g) * 0.2).to(wdt)
    b1 = (torch.randn(h, generator=g) * 0.1).to(wdt)
    wht = (torch.randn((no, h), generator=g) * 0.2).to(wdt)
    bht = (torch.randn(no, generator=g) * 0.1).to(wdt)
    y_t = (torch.randint(0, 256, (b, no, hw), generator=g) - 128).to(
        torch.int8)
    nm = Numerics(sr=True)
    args = (w1, b1, wht, bht)
    whole, (aq, qi) = l8.loss_int8_reference(fold, coords, *args, y_t,
                                             numerics=nm, ints=True)
    parts, tiles = [], []
    for p0 in (0, 1024):
        sl = slice(p0, p0 + 1024)
        out, t = l8.loss_int8_reference(
            fold, coords[sl].contiguous(), *args, y_t[..., sl].contiguous(),
            numerics=nm, ints=True, p_base=p0)
        parts.append(out)
        tiles.append(t)
    assert torch.equal(torch.cat([t[0] for t in tiles], dim=1), aq)
    assert torch.equal(torch.cat([t[1] for t in tiles], dim=1), qi)
    for a, c, w in zip(*parts, whole):
        d = (a + c - w).abs().max().item()
        assert d <= 1e-5 * max(w.abs().max().item(), 1.0)
    _, t0 = l8.loss_int8_reference(
        fold, coords[1024:].contiguous(), *args,
        y_t[..., 1024:].contiguous(), numerics=nm, ints=True)
    assert not torch.equal(t0[0], tiles[1][0])


def test_sr90_counters_start_at_p_base():
    a = l8.sr90_counters(2, 1024, 40, 2)
    b = l8.sr90_counters(2, 1024, 40, 2, p_base=3072)
    for site in ("fwd", "grad"):
        for k in (0, 1, 2, 3, 5, 6):
            assert torch.equal(a[site][k], b[site][k])
        assert torch.equal(b[site][4], a[site][4] + 3072)


def test_dryrun_on_four_ranks(capfd):
    from spatialvae_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip(4)")]
    assert len(lines) == 5 and all(ln.endswith("ok") or " ok " in ln
                                   for ln in lines), lines


def _tsv(text: str) -> list:
    return [ln.split("\t") for ln in text.splitlines() if "\t" in ln]


@pytest.mark.parametrize("cli", ["galaxy", "particles", "galaxy_multihost"])
def test_cli_on_two_ranks(cli, tmp_path):
    """Rank 0 prints the one-process run's TSV within CLI_TOL of its row's
    ELBO; rank 1 prints and writes nothing.  The world from torchrun's
    environment, or (``galaxy_multihost``) from the multi-host flags, two
    hosts of one rank each."""
    multihost = cli.endswith("_multihost")
    cli = cli.split("_")[0]
    import shutil

    rng = np.random.default_rng(0)
    src = tmp_path / "inputs"
    src.mkdir()
    if cli == "galaxy":
        np.save(src / "tr.npy", rng.integers(0, 256, (48, 16, 16, 3),
                                             dtype=np.uint8))
        np.save(src / "te.npy", rng.integers(0, 256, (20, 16, 16, 3),
                                             dtype=np.uint8))
        module = "spatialvae_torch.cli.train_galaxy"
        argv = ["tr.npy", "te.npy", "--minibatch_size", "16",
                "--p_hidden_dim", "12", "--q_hidden_dim", "16",
                "--save_interval", "1", "--save_prefix", "g"]
    else:
        np.save(src / "tr.npy", rng.standard_normal((48, 8, 8),
                                                    dtype=np.float32))
        np.save(src / "te.npy", rng.standard_normal((20, 8, 8),
                                                    dtype=np.float32))
        module = "spatialvae_torch.cli.train_particles"
        argv = ["tr.npy", "te.npy", "--minibatch-size", "16",
                "--p-hidden-dim", "8", "--q-hidden-dim", "8",
                "--save-prefix", "p", "--save-interval", "1"]
    argv += ["-d", "-1", "--num-epochs", "2"]
    dirs = []
    for name in ("one", "rank0", "rank1"):
        d = tmp_path / name
        shutil.copytree(src, d)
        dirs.append(str(d))
    inputs = sorted(os.listdir(src))
    one = torch_ranks.cli(0, module, argv, dirs[:1])
    out = torch_ranks.spawn_cli(module, argv, dirs[1:], _free_port(),
                                multihost)
    want, got = _tsv(one), _tsv(out[0])
    assert len(got) == len(want) > 2 and got[0] == want[0]
    at = want[0].index("ELBO")
    for g, w in zip(got[1:], want[1:]):
        assert [x for x in g if not _num(x)] == [x for x in w
                                                 if not _num(x)]
        scale = abs(float(w[at]))
        for a, b in zip(map(float, filter(_num, g)),
                        map(float, filter(_num, w))):
            assert abs(a - b) <= CLI_TOL * scale, (g, w)
    assert out[1] == ""
    assert sorted(os.listdir(dirs[2])) == inputs

    def tree(d):        # the archive's name holds the minute it was made
        return sorted(re.sub(r"^\d{6}_\d{4}_", "", n)
                      for n in os.listdir(d))

    assert tree(dirs[1]) == tree(dirs[0])


def _num(x: str) -> bool:
    try:
        float(x)
        return True
    except ValueError:
        return False


PIXEL_DECISIONS = [
    # ElboConfig keywords, batch, (n, m), (data, model)
    (dict(int8=True), 4, (64, 32), (1, 2)),
    (dict(int8=True), 4, (64, 32), (2, 2)),
    (dict(int8=True), 3, (64, 32), (2, 2)),
    (dict(int8=True), 2, (64, 32), (2, 2)),
    (dict(int8=True), 4, (48, 32), (1, 2)),
    (dict(int8=True), 4, (64, 64), (1, 4)),
    (dict(int8=True, likelihood="gaussian"), 4, (64, 32), (1, 2)),
    (dict(int8=True, likelihood="colored"), 4, (64, 32), (1, 2)),
    (dict(int8=True, fused_loss=False), 4, (64, 32), (1, 2)),
    (dict(), 4, (64, 32), (1, 2)),
    (dict(int8=True, fused=False), 4, (64, 32), (1, 2)),
]


@pytest.mark.parametrize("ekw,batch,image,shape", PIXEL_DECISIONS)
def test_pixel_step_decision_matches_jax(ekw, batch, image, shape):
    """``pixel_step_refusal`` is None exactly where the JAX
    ``_pixel_spmd_ok`` takes the pixel step; where the configuration's own
    flags refuse it, ``config_refusal`` (the CLIs' check before any work)
    gives the same reason."""
    from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
    from spatialvae_tpu.train.trainer import _pixel_spmd_ok

    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.parallel.pixel import (
        config_refusal,
        pixel_step_refusal,
    )
    from tests.port_configs import to_port

    ekw = {"fused": True, **ekw}
    p_cfg = SpatialGeneratorConfig(
        latent_dim=2, hidden_dim=16, num_layers=2,
        n_out=2 if ekw.get("likelihood") == "colored" else 1)
    mesh_shape = {"data": shape[0], "model": shape[1]}
    hw = image[0] * image[1]
    want = _pixel_spmd_ok(
        types.SimpleNamespace(shape=mesh_shape), JaxElboConfig(**ekw), p_cfg,
        types.SimpleNamespace(minibatch_size=batch), hw)
    ecfg = ElboConfig(**ekw)
    why = pixel_step_refusal(ecfg, to_port(p_cfg), batch, hw, mesh_shape)
    assert (why is None) == want, why
    if config_refusal(ecfg) is not None:
        assert why == config_refusal(ecfg)


def test_model_axis_off_the_pixel_step_names_m10b():
    """A float trainer, a colored one and an int8 Bernoulli one whose
    pixels do not slice into tile-aligned pieces, on a mesh with a model
    axis: JAX's GSPMD tensor-parallel path, refused before any work, with
    the reason; so is the tensor-parallel layout of the parameters."""
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig as PortGen,
    )
    from spatialvae_torch.objectives import ElboConfig
    from spatialvae_torch.train.trainer import TrainConfig, Trainer
    from spatialvae_torch.transforms.coords import coord_grid

    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, rank=0,
                                 device=torch.device("cpu"))
    for ecfg, n, why in (
            (ElboConfig(fused=True), 64, "a float decoder"),
            (ElboConfig(fused=True, int8=True, likelihood="colored"), 64,
             "the colored likelihood"),
            (ElboConfig(fused=True, int8=True), 48,
             "1536 pixels in 2 tile-aligned slices")):
        with pytest.raises(NotImplementedError, match="M10b") as err:
            Trainer(InferenceConfig(n=n * 32, latent_dim=5, hidden_dim=8),
                    PortGen(latent_dim=2, hidden_dim=8,
                            n_out=2 if ecfg.likelihood == "colored" else 1),
                    ecfg, TrainConfig(minibatch_size=2),
                    coord_grid(n, 32), device="cpu", mesh=mesh)
        assert why in str(err.value)
    with pytest.raises(NotImplementedError, match="M10b"):
        param_shardings({"q.w": None}, mesh)
    assert param_shardings({"q.w": None}, mesh, pixel_step=True) == {
        "q.w": "replicated"}


def test_pixel_axis_needs_the_loss_kernel_path():
    """As JAX: ``pixel_axis`` with the plain decoder, or without y_t,
    raises ``ValueError``."""
    from spatialvae_torch.config import (
        InferenceConfig,
        SpatialGeneratorConfig as PortGen,
    )
    from spatialvae_torch.models import SpatialGenerator
    from spatialvae_torch.models.inference import InferenceNetwork
    from spatialvae_torch.objectives import ElboConfig, elbo_minibatch
    from spatialvae_torch.parallel.mesh import Axis
    from spatialvae_torch.transforms.coords import coord_grid

    q = InferenceNetwork(InferenceConfig(n=2048, latent_dim=5,
                                         hidden_dim=8), device="cpu")
    p = SpatialGenerator(PortGen(latent_dim=2, hidden_dim=8), device="cpu")
    axis = Axis("model", None, 2, 0)
    y = torch.rand((2, 2048))
    for ecfg in (ElboConfig(), ElboConfig(fused=True, int8=True)):
        with pytest.raises(ValueError, match="pixel_axis requires"):
            elbo_minibatch(q, p, ecfg, coord_grid(32, 32), y,
                           torch.Generator().manual_seed(0),
                           pixel_axis=axis)
