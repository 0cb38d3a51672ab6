"""K3's four measurement levers (``SPATIALVAE_TANH``, ``SPATIALVAE_A1Q``,
``SPATIALVAE_DB1``, ``SPATIALVAE_PHASE_CUT``) in the port, on the CPU.

``loss_int8_reference`` and ``run_loss_int8`` (which takes the plain
version for CPU tensors) take them through ``Numerics``; the JAX kernel
reads them from the environment.  ``DB1=qi``, ``A1Q=1`` and
``PHASE_CUT=3..9`` are held to ``_lossgrad_pallas(interpret=True)`` at the
``TIGHT`` limits of ``test_torch_port_numerics.py``, with bf16 weights
after swapping XLA's CPU forms of the two bf16 chains into the plain version
(``test_torch_port_int8.test_loss_bf16_matches_jax_with_xla_chains``), or
at its ``WIDE`` limits for the tile scale's bf16 chains; under ``A1Q`` an
int8 a1 value that a tanh ulp moves across a rounding boundary moves
dWh^T by one step of dz2 (4.6e-5 / 5.1e-7 measured), held at 2e-4 / 4e-6.  ``TANH=pade`` is not run by
JAX's interpret mode (it keeps the exact tanh there), so the formula in
float64 numpy is the oracle: the plain version's Pade tanh is held to it,
and K3's plain version is shown to take it at both activation sites.
Stochastic rounding is not run by JAX off the TPU either; its pairs with
the levers are held to the port's own SR run without the lever, on the
outputs the lever leaves alone.  Below a cut of 3 the JAX kernel fails at
trace time and the port raises ``ValueError``.  ``A1Q`` is silently off
where JAX turns it off (tile scale, f32 epilogue), and the feature-major
kernel K8 reads none of the four.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from spatialvae_tpu.kernels import fused_loss_int8 as jl8

from spatialvae_torch.kernels import config as kcfg
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels import fused_loss_int8_t as lt
from spatialvae_torch.kernels.config import Numerics
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRADS = ("dfold", "dw1", "db1", "dwht", "dbht")
TIGHT = {"dfold": (5e-5, 3e-6), "dw1": (2e-4, 2e-6), "db1": (2e-4, 5e-6),
         "dwht": (3e-5, 4e-6), "dbht": (4e-5, 4e-5)}
WIDE = {"dfold": (5e-4, 4e-5), "dw1": (2.5e-2, 4e-3), "db1": (1e-2, 2e-3),
        "dwht": (2e-5, 2e-6), "dbht": (4e-5, 4e-5)}
LEVER_ENV = ("SPATIALVAE_TANH", "SPATIALVAE_A1Q", "SPATIALVAE_DB1",
             "SPATIALVAE_PHASE_CUT", "SPATIALVAE_INT4_GRADS",
             "SPATIALVAE_GSCALE", "SPATIALVAE_EPI", "SPATIALVAE_SR")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")
    for name in LEVER_ENV:
        monkeypatch.delenv(name, raising=False)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    d = np.abs(got - want)
    scale = float(np.abs(want).max()) or 1.0
    return d.max() / scale, d.mean() / scale


def _inputs(family, wdt, masked=True, b=4, h=64, seed=0):
    """numpy (fold, coords, weights, y_t, mask, kernel family) in the loss
    kernel's layout at 32x32 (colored chunk-permuted, targets pre-paired)."""
    rng = np.random.default_rng(seed)
    no = {"gaussian": 1, "colored": 2}.get(family, 3)
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
          .to(wdt).float().numpy() for s in ((h, h), (h,), (no, h), (no,))]
    coords = coord_grid(32, 32).numpy()
    y = rng.uniform(size=(b, 1024, no)).astype(np.float32)
    mask = (rng.uniform(size=1024) > 0.3).astype(np.float32) if masked \
        else None
    if family == "colored":
        coords = l8.colored_coords(torch.from_numpy(coords), 1024).numpy()
        yt = y[..., 0].reshape(b, 512, 2).transpose(0, 2, 1)
    else:
        yt = (np.round(y * 255) - 128).astype(np.int8).transpose(0, 2, 1)
    return fold, coords, ws, np.ascontiguousarray(yt), mask, family


def _port(args, wdt, nm, ints=False):
    fold, coords, ws, yt, mask, family = args
    return l8.loss_int8_reference(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask), family,
        numerics=nm, ints=ints)


def _jax(args, wdt, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fold, coords, ws, yt, mask, family = args
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    try:
        _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                           jnp.asarray(yt),
                           None if mask is None else jnp.asarray(mask),
                           family, True)
    finally:
        for k in env:
            monkeypatch.delenv(k)
    return want


def _xla_tanh_prime(a1c, wdt):
    """XLA's CPU form of the kernel's bf16 ``one - a1c*a1c``: the product
    rounds to bf16, the difference stays f32."""
    a = a1c.to(torch.bfloat16)
    return 1.0 - (a * a).float()


def _xla_dh0(da0, aq, inv=1.0 / 7.0):
    """XLA's CPU form of the bf16 dh0 chain: the factor 1 - a0d*a0d in bf16,
    da0 left in f32."""
    a0d = aq.to(torch.bfloat16) * torch.tensor(inv, dtype=torch.bfloat16)
    return da0 * (1.0 - a0d * a0d).float()


def _assert_outputs(got, want, tol):
    for name, a, w in zip(GRADS, got, want):
        mx, mean = _rel(a.numpy(), w)
        assert mx <= tol[name][0] and mean <= tol[name][1], (name, mx, mean)
    np.testing.assert_allclose(got[0][:, 3, 0].numpy(),
                               np.asarray(want[0])[:, 3, 0], rtol=3e-6)


# (environment, family, weight dtype): each lever, and its pairs with the
# int8 gradient mode and the tile scale, where JAX's kernel reads it (A1Q
# and DB1=qi in the bound scale's chain) or ignores it (the others)
CASES = [
    ({"SPATIALVAE_DB1": "qi"}, "bernoulli", torch.float32),
    ({"SPATIALVAE_DB1": "qi"}, "gaussian", torch.bfloat16),
    ({"SPATIALVAE_A1Q": "1"}, "bernoulli", torch.float32),
    ({"SPATIALVAE_A1Q": "1"}, "bernoulli", torch.bfloat16),
    ({"SPATIALVAE_A1Q": "1"}, "colored", torch.float32),
    ({"SPATIALVAE_A1Q": "1", "SPATIALVAE_DB1": "qi"}, "gaussian",
     torch.float32),
    ({"SPATIALVAE_A1Q": "1", "SPATIALVAE_INT4_GRADS": "i8"}, "bernoulli",
     torch.float32),
    ({"SPATIALVAE_A1Q": "1", "SPATIALVAE_GSCALE": "tile"}, "bernoulli",
     torch.bfloat16),
    ({"SPATIALVAE_DB1": "qi", "SPATIALVAE_GSCALE": "tile"}, "bernoulli",
     torch.float32),
    ({"SPATIALVAE_DB1": "qi", "SPATIALVAE_INT4_GRADS": "i8"}, "colored",
     torch.float32),
    ({"SPATIALVAE_A1Q": "1", "SPATIALVAE_PHASE_CUT": "5"}, "bernoulli",
     torch.float32),
]


def _numerics(env):
    keys = {"SPATIALVAE_DB1": "db1", "SPATIALVAE_INT4_GRADS": "grad_mode",
            "SPATIALVAE_GSCALE": "gscale", "SPATIALVAE_EPI": "epi",
            "SPATIALVAE_TANH": "tanh"}
    kw = {keys[k]: v for k, v in env.items() if k in keys}
    if "SPATIALVAE_A1Q" in env:
        kw["a1q"] = env["SPATIALVAE_A1Q"] == "1"
    if "SPATIALVAE_PHASE_CUT" in env:
        kw["phase_cut"] = int(env["SPATIALVAE_PHASE_CUT"])
    return Numerics(**kw)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    [*(f"{k[11:]}={v}" for k, v in c[0].items()), c[1], str(c[2])[6:]]))
def test_lever_matches_jax(case, monkeypatch):
    """The plain version under the lever(s) against the JAX kernel run in
    interpret mode under the same environment: the five raw outputs and
    the per-image loss."""
    env, family, wdt = case
    args = _inputs(family, wdt)
    want = _jax(args, wdt, monkeypatch, env)
    nm = _numerics(env)
    if wdt == torch.bfloat16:
        # XLA's CPU forms of the two bf16 chains (test_torch_port_int8): the
        # rounded gradient tile, which DB1=qi sums, then moves with them
        monkeypatch.setattr(l8, "tanh_prime", _xla_tanh_prime)
        monkeypatch.setattr(l8, "dh0_bf16", _xla_dh0)
    got = _port(args, wdt, nm)
    base = _port(args, wdt, Numerics(grad_mode=nm.grad_mode,
                                     gscale=nm.gscale))
    tol = dict(TIGHT)
    if wdt == torch.bfloat16 and nm.k3_gscale == "tile":
        tol = WIDE                 # the tile scale's bf16 chains
    if nm.k3_a1q:
        # an int8 a1 value that a tanh ulp moves across a rounding boundary
        # moves dWh^T by one dz2 step (measured 4.6e-5 / 5.1e-7, bf16)
        tol["dwht"] = (2e-4, 4e-6)
    _assert_outputs(got, want, tol)
    # the lever changes the result where JAX's kernel reads it
    read = nm.k3_a1q or nm.k3_db1_qi or nm.k3_cut < 8
    assert read == any(not torch.equal(u, v) for u, v in zip(got, base))


@pytest.mark.parametrize("cut", [3, 4, 5, 6, 7, 8, 9])
def test_phase_cut_matches_jax(cut, monkeypatch):
    """``PHASE_CUT=k`` keeps phases 1..k: the outputs of the cut phases are
    zero (dWh^T below 4, db1 and dbh below 5, dW1 below 6, dfold but the
    loss stash below 8) and the loss is the whole kernel's for every k >= 3;
    the wrapper reads the environment (with ``ALLOW_KNOBS``)."""
    args = _inputs("bernoulli", torch.float32)
    want = _jax(args, torch.float32, monkeypatch,
                {"SPATIALVAE_PHASE_CUT": str(cut)})
    monkeypatch.setenv("SPATIALVAE_PHASE_CUT", str(cut))
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    assert kcfg.numerics().k3_cut == min(cut, 8)
    fold, coords, ws, yt, mask, family = args
    got = l8.run_loss_int8(torch.from_numpy(fold), torch.from_numpy(coords),
                           *map(torch.from_numpy, ws), torch.from_numpy(yt),
                           torch.from_numpy(mask), family)
    _assert_outputs(got, want, TIGHT)
    full = _port(args, torch.float32, Numerics())
    zero = {"dwht": cut < 4, "db1": cut < 5, "dbht": cut < 5, "dw1": cut < 6,
            "dfold": cut < 8}
    for name, a, f in zip(GRADS, got, full):
        if name == "dfold":
            assert torch.equal(a[:, 3, 0], f[:, 3, 0])
            a, f = a[:, :3], f[:, :3]
        assert (not a.any()) if zero[name] else torch.equal(a, f), name


@pytest.mark.parametrize("cut", [2, 0])
def test_phase_cut_below_3_raises_where_jax_fails(cut, monkeypatch):
    """JAX's kernel sets the loss in phase 3: below it the trace fails; the
    port refuses the setting with ValueError, at resolution and in the
    wrapper, and gives no value."""
    args = _inputs("bernoulli", torch.float32, masked=False)
    with pytest.raises(AttributeError, match="bce"):
        _jax(args, torch.float32, monkeypatch,
             {"SPATIALVAE_PHASE_CUT": str(cut)})
    monkeypatch.setenv("SPATIALVAE_PHASE_CUT", str(cut))
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    with pytest.raises(ValueError, match="PHASE_CUT"):
        kcfg.numerics()
    fold, coords, ws, yt, _, family = args
    with pytest.raises(ValueError, match="PHASE_CUT"):
        l8.run_loss_int8(torch.from_numpy(fold), torch.from_numpy(coords),
                         *map(torch.from_numpy, ws), torch.from_numpy(yt))
    with pytest.raises(ValueError, match="PHASE_CUT"):
        l8.loss_int8_reference(
            torch.from_numpy(fold), torch.from_numpy(coords),
            *map(torch.from_numpy, ws), torch.from_numpy(yt),
            numerics=Numerics(phase_cut=cut))


@pytest.mark.parametrize("env", [
    {"SPATIALVAE_A1Q": "1", "SPATIALVAE_EPI": "f32"},
    {"SPATIALVAE_A1Q": "1", "SPATIALVAE_GSCALE": "tile"},
    {"SPATIALVAE_A1Q": "1", "SPATIALVAE_INT4_GRADS": "da0_i4"}],
    ids=["epi_f32", "tile", "da0_i4"])
def test_a1q_is_off_where_jax_turns_it_off(env, monkeypatch):
    """JAX wires the int8 a1 for the bound scale with the bf16 epilogue only
    and drops the flag silently elsewhere: the port computes bit for bit
    what it computes without the flag, and JAX's kernel with the flag
    computes what it computes without it."""
    args = _inputs("bernoulli", torch.float32)
    nm = _numerics(env)
    assert nm.a1q and not nm.k3_a1q
    off = {k: v for k, v in env.items() if k != "SPATIALVAE_A1Q"}
    got = _port(args, torch.float32, nm)
    base = _port(args, torch.float32, _numerics(off))
    assert all(torch.equal(u, v) for u, v in zip(got, base))
    want = _jax(args, torch.float32, monkeypatch, env)
    jbase = _jax(args, torch.float32, monkeypatch, off)
    for w, v in zip(want, jbase):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(v))


def test_tanh_pade_is_the_formula():
    """The Pade tanh against x(945 + 105x^2 + x^4) / (945 + 420x^2 + 15x^4)
    clipped to [-1, 1] in float64 numpy, over the first layer's and the
    hidden layer's range and past the clip: within 3e-7 (a few f32 ulps
    of values in [-1, 1]), and within JAX's stated 1.36e-3 of the exact
    tanh where the rational is fitted."""
    x = np.concatenate([np.linspace(-12, 12, 200001),
                        np.random.default_rng(0).normal(0, 3, 100000)]
                       ).astype(np.float32)
    xd = x.astype(np.float64)
    t = xd * xd
    want = np.clip(xd * (945 + t * (105 + t)) / (945 + t * (420 + 15 * t)),
                   -1, 1)
    got = l8.tanh_pade(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 3e-7
    fit = np.abs(x) <= 3.0
    assert np.abs(got[fit] - np.tanh(xd[fit])).max() <= 1.4e-3


def test_k3_takes_pade_at_both_activation_sites(monkeypatch):
    """Under ``TANH=pade`` the plain version evaluates a0 and a1 with the
    Pade tanh (and no exact tanh), and the wrapper, reading the
    environment, computes the same as the plain version given the
    numerics."""
    args = _inputs("bernoulli", torch.bfloat16)
    calls = []
    pade = l8.tanh_pade
    monkeypatch.setattr(l8, "tanh_pade", lambda x: calls.append(
        tuple(x.shape)) or pade(x))
    exact = torch.tanh
    monkeypatch.setattr(torch, "tanh", lambda x: calls.append("exact")
                        or exact(x))
    nm = Numerics(tanh="pade")
    got = _port(args, torch.bfloat16, nm)
    assert calls == [(4, 1024, 64), (4, 1024, 64)]
    monkeypatch.setenv("SPATIALVAE_TANH", "pade")
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    fold, coords, ws, yt, mask, family = args
    again = l8.run_loss_int8(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(torch.bfloat16) for w in ws],
        torch.from_numpy(yt), torch.from_numpy(mask), family)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    monkeypatch.setattr(torch, "tanh", exact)
    base = _port(args, torch.bfloat16, Numerics())
    assert any(not torch.equal(u, v) for u, v in zip(got, base))


@pytest.mark.parametrize("lever", [
    dict(db1="qi"), dict(a1q=True), dict(phase_cut=6), dict(tanh="pade")],
    ids=["db1", "a1q", "cut6", "pade"])
def test_levers_with_stochastic_rounding(lever):
    """SR with each lever (JAX rounds to nearest off the TPU, so the port's
    SR run without the lever is the reference): the forward site's words,
    and so aq, are the lever's business only under pade; DB1=qi changes db1
    alone, to sum(qi) * sg over the same qi; A1Q keeps aq; a cut zeroes
    its phases' outputs and keeps the rest."""
    args = _inputs("bernoulli", torch.float32)
    nm = Numerics(sr=True, **lever)
    (got, (aq, qi)) = _port(args, torch.float32, nm, ints=True)
    (base, (aq0, qi0)) = _port(args, torch.float32, Numerics(sr=True),
                               ints=True)
    assert torch.equal(aq, aq0) != ("tanh" in lever)
    if "db1" in lever:
        assert torch.equal(qi, qi0)
        for i in (0, 1, 3, 4):
            assert torch.equal(got[i], base[i])
        assert not torch.equal(got[2], base[2])
    elif "phase_cut" in lever:
        assert torch.equal(got[1], base[1]) and torch.equal(got[3], base[3])
        assert not got[0][:, :3].any()
    else:
        assert not torch.equal(got[1], base[1])


def test_k8_reads_none_of_the_levers(monkeypatch):
    """JAX's feature-major kernel uses the exact tanh and no cut, int8 a1
    or db1 mode: with all four levers set (and resolved for K3), the port's
    K8 gives bit for bit the same outputs as without them."""
    rng = np.random.default_rng(0)
    b, h, no = 2, 64, 3
    fold_t = np.zeros((b, h, 4), np.float32)
    fold_t[:, :, :2] = rng.uniform(-0.7, 0.7, (b, h, 2))
    fold_t[:, :, 2] = rng.uniform(-1.5, 1.5, (b, h))
    ws = [torch.from_numpy(rng.uniform(-0.1, 0.1, s).astype(np.float32))
          for s in ((h, h), (h,), (no, h), (no,))]
    coords = coord_grid(32, 32)
    yt = torch.from_numpy(rng.uniform(size=(b, no, 1024)).astype(np.float32))
    args = (torch.from_numpy(fold_t), coords, *ws, yt)
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    for mode in ("i4", "i8"):
        base = lt.run_loss_int8_t(*args, mode)
        for k, v in (("SPATIALVAE_TANH", "pade"), ("SPATIALVAE_A1Q", "1"),
                     ("SPATIALVAE_DB1", "qi"), ("SPATIALVAE_PHASE_CUT", "4")):
            monkeypatch.setenv(k, v)
        nm = kcfg.numerics()               # the levers resolve for K3
        assert (nm.tanh, nm.a1q, nm.db1, nm.k3_cut) == ("pade", True, "qi", 4)
        got = lt.run_loss_int8_t(*args, mode)
        assert all(torch.equal(u, v) for u, v in zip(got, base))
        for k in ("SPATIALVAE_TANH", "SPATIALVAE_A1Q", "SPATIALVAE_DB1",
                  "SPATIALVAE_PHASE_CUT"):
            monkeypatch.delenv(k)
