"""The Gaussian and colored likelihoods and the loss kernel's families
(Gaussian, colored, padded pixel counts) against the JAX package, on the
CPU: the plain ELBO with its gradients, the plain version of the fused int8
loss kernel (K3) against the JAX Pallas kernel in interpret mode at the
default knobs, the padded path, the colored layout helpers and the gates.

Inputs come from a numpy seed.  Tolerances, each measured on these inputs
(the measured value beside it) with a margin of 2-5x:

- The plain ELBO in f32: value and auxiliaries rtol 1e-5, gradient leaves
  rtol 1e-5 with a floor of 1e-5 of the leaf's largest value (sums in
  another order).  bf16 compute: both packages round at their own places
  (torch each Linear's output, XLA each fused op's), value 1e-2, leaves 5e-2
  of their largest value, as ``tests/test_torch_port_train.py`` holds the
  Bernoulli ELBO.
- K3's plain version, relative to max|JAX| (max, mean), starts from the
  Bernoulli limits of ``tests/test_torch_port_int8.py``.  f32 weights: one
  qi that a tanh ulp flips moves dW1 by up to 2e-3 (none flips on these
  inputs: 1.4e-7); dfold read up to 1.43e-5 / 7.6e-7 (colored, int8
  targets), above the Bernoulli cases' 2e-5 margin, hence 5e-5 / 3e-6.
  bf16 weights: XLA on the CPU drops two bf16 roundings that the kernel as
  written and the port keep (that file's docstring), so dW1 and db1 get the
  same wide limits (measured 6.6e-3 / 8.7e-4 and 2.2e-3 / 4.5e-4), and
  dfold, whose addends the port rounds to bf16 (one ulp, 3.9e-3, each) and
  XLA does not, read 1.06e-4 / 1.29e-5 in the Gaussian family (its dz2
  carries the factor s(1-s) <= 1/4, so fewer qi saturate and more of them
  sit where that rounding shows): 3e-4 / 4e-5.
- The padded path against the same computation without the pad: bit for
  bit when the whole image is one quantisation group both ways (28x28);
  against the float decoder only to the int4 quantisation's error (stated
  at the test).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.kernels import fused_loss_int8 as jl8
from spatialvae_tpu.models import spatial_generator_init
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.objectives.elbo import fused_loss_active as jax_active
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import (
    from_jax_params,
    generator_from_jax,
    named_to_jax,
)
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.models.spatial import spatial_generator_apply_folded
from spatialvae_torch.objectives import (
    ElboConfig,
    fused_loss_active,
    loss_and_grad,
)
from spatialvae_torch.train import trainer as port_trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRADS = ("dfold", "dw1", "db1", "dwht", "dbht")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    d = np.abs(got - want)
    scale = float(np.abs(want).max()) or 1.0
    return d.max() / scale, d.mean() / scale


def _assert_rel(got, want, lim, what):
    mx, mean = _rel(got, want)
    assert mx <= lim[0] and mean <= lim[1], (what, mx, mean, lim)


def _circle(n, m):
    """The particles' mask: pixels of the unit disc of the coordinate grid."""
    g = coord_grid(n, m).numpy()
    return (np.sum(g ** 2, axis=1) <= 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the plain ELBO: Gaussian and colored likelihoods
# ---------------------------------------------------------------------------

N = M = 16
Z, B = 3, 4

# name: (likelihood, data channels, n_out, mask, compute dtype, fused float
# decoder, fit_noise_interleaved)
ELBO_CASES = {
    "gaussian": ("gaussian", 1, 1, False, "float32", False, True),
    "gaussian_mask": ("gaussian", 1, 1, True, "float32", False, True),
    "gaussian_mask_bf16": ("gaussian", 1, 1, True, "bfloat16", False, True),
    "gaussian_rgb_mask": ("gaussian", 3, 3, True, "float32", False, True),
    "gaussian_mask_fused": ("gaussian", 1, 1, True, "float32", True, True),
    "colored_mask": ("colored", 1, 2, True, "float32", False, True),
    "colored_bf16": ("colored", 1, 2, False, "bfloat16", False, True),
    "colored_mask_fused": ("colored", 1, 2, True, "float32", True, True),
    "colored_per_channel": ("colored", 1, 2, False, "float32", False, False),
    "colored_per_channel_mask": ("colored", 1, 2, True, "float32", False,
                                 False),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("name", sorted(ELBO_CASES))
def test_gaussian_and_colored_elbo_match_jax(name):
    """``loss_and_grad`` against ``value_and_grad`` of the JAX trainer's
    loss: whitened (off-grid, signed) targets, the same noise."""
    lik, ch, n_out, use_mask, dtype, fused, inter = ELBO_CASES[name]
    q_cfg = InferenceConfig(n=N * M * ch, latent_dim=Z + 3, hidden_dim=32,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=32, n_out=n_out,
                                   num_layers=2)
    ekw = dict(likelihood=lik, channels=ch, fused=fused,
               fit_noise_interleaved=inter)
    mask = _circle(N, M) if use_mask else None
    jt = jax_trainer.Trainer(
        q_cfg, p_cfg, JaxElboConfig(**ekw),
        jax_trainer.TrainConfig(minibatch_size=B, compute_dtype=dtype),
        jnp.asarray(jax_grid(N, M)),
        mask=None if mask is None else jnp.asarray(mask))
    rng = np.random.default_rng(3)
    y = (0.5 + 0.4 * rng.normal(size=(B, N * M, ch))).astype(np.float32)
    noise = rng.normal(size=(B, Z + 3)).astype(np.float32)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    with pltpu.force_tpu_interpret_mode():
        (loss, aux), grads = grad_fn(jt.state.params, jnp.asarray(y), None,
                                     None, jnp.float32(1.0),
                                     noise=jnp.asarray(noise))
    params = _np_tree(jt.state.params)
    q_net, p_net = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                                   to_port(p_cfg))
    got_loss, got_aux = loss_and_grad(
        q_net, p_net, ElboConfig(**ekw), coord_grid(N, M),
        torch.from_numpy(y), noise=torch.from_numpy(noise),
        mask=None if mask is None else torch.from_numpy(mask),
        compute_dtype=getattr(torch, dtype))
    rtol, floor = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 5e-2)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=rtol)
    np.testing.assert_allclose(got_aux.numpy(), np.asarray(aux), rtol=rtol)
    got = named_to_jax(q_net, p_net, {
        f"{k}.{n}": p.grad for k, net in (("q", q_net), ("p", p_net))
        for n, p in net.named_parameters()})
    g, gdef = jax.tree_util.tree_flatten(got)
    w, wdef = jax.tree_util.tree_flatten(_np_tree(grads))
    assert gdef == wdef
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, b, rtol=0 if dtype == "bfloat16" else rtol,
            atol=floor * (float(np.abs(b).max()) or 1.0))


# ---------------------------------------------------------------------------
# K3's plain version, Gaussian and colored families
# ---------------------------------------------------------------------------

# (weight dtype, family, int8 targets, mask): every value of each axis
# appears with each family
FAMILY_CASES = [
    (torch.float32, "gaussian", False, True),
    (torch.float32, "gaussian", True, False),
    (torch.bfloat16, "gaussian", False, False),
    (torch.bfloat16, "gaussian", True, True),
    (torch.float32, "colored", False, True),
    (torch.float32, "colored", True, False),
    (torch.bfloat16, "colored", False, False),
    (torch.bfloat16, "colored", True, True),
]
# relative to max|JAX| (max, mean) by weight dtype, see the module docstring
FAMILY_TOL = {
    torch.float32: {"dfold": (5e-5, 3e-6), "dw1": (2e-3, 3e-5),
                    "db1": (5e-6, 1e-6), "dwht": (1e-5, 2e-6),
                    "dbht": (1e-5, 2e-6)},
    torch.bfloat16: {"dfold": (3e-4, 4e-5), "dw1": (2.5e-2, 4e-3),
                     "db1": (1.5e-2, 1e-3), "dwht": (1e-5, 2e-6),
                     "dbht": (1e-5, 5e-6)},
}
COT = 0.37


def _weights(b, h, no, wdt, seed=0):
    rng = np.random.default_rng(seed)
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [rng.uniform(-bound, bound, s).astype(np.float32)
          for s in ((h, h), (h,), (no, h), (no,))]
    return fold, [torch.from_numpy(w).to(wdt).float().numpy() for w in ws]


def _family_inputs(wdt, family, i8, masked, b=4, h=64, side=32, seed=0):
    """fold, coords in the family's order, weights, targets in the family's
    layout and the (HW,) mask."""
    hw = side * side
    no = 2 if family == "colored" else 1
    fold, ws = _weights(b, h, no, wdt, seed)
    rng = np.random.default_rng(seed + 7)
    if i8:
        y = rng.integers(0, 256, (b, hw)) / 255.0
    else:
        y = 0.5 + 0.4 * rng.normal(size=(b, hw))
    y = torch.from_numpy(y.astype(np.float32))
    coords = coord_grid(side, side)
    if family == "colored":
        coords = l8.colored_coords(coords, l8.pick_tile(hw))
    yt = (port_trainer.build_yt_i8(y, hw, family == "colored") if i8
          else port_trainer.yt_layout(y, hw, family == "colored"))
    mask = (rng.uniform(size=hw) > 0.3).astype(np.float32) if masked \
        else None
    return fold, coords.numpy(), ws, yt.numpy(), mask


def _ids(c):
    return "-".join([str(c[0])[6:], c[1], "i8" if c[2] else "float",
                     "mask" if c[3] else "nomask"])


@pytest.mark.parametrize("case", FAMILY_CASES, ids=_ids)
def test_family_reference_outputs_match_jax_kernel(case):
    """The plain version's five raw outputs, the per-image loss at
    dfold[:, 3, 0] among them, against the JAX kernel's."""
    wdt, family, i8, masked = case
    fold, coords, ws, yt, mask = _family_inputs(wdt, family, i8, masked)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    _, want = jl8._run(jnp.asarray(fold), jnp.asarray(coords), *jw,
                       jnp.asarray(yt),
                       None if mask is None else jnp.asarray(mask), family,
                       True)
    got = l8.loss_int8_reference(
        torch.from_numpy(fold), torch.from_numpy(coords),
        *[torch.from_numpy(w).to(wdt) for w in ws], torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask), family)
    for name, a, b in zip(GRADS, got, want):
        assert a.dtype == torch.float32
        _assert_rel(a.numpy(), np.asarray(b, np.float32),
                    FAMILY_TOL[wdt][name], name)
    np.testing.assert_allclose(got[0][:, 3, 0].numpy(),
                               np.asarray(want[0])[:, 3, 0], rtol=2e-6)
    assert float(got[0][:, 3, 1:].abs().max()) == 0.0


@pytest.mark.parametrize("case", [FAMILY_CASES[0], FAMILY_CASES[7]], ids=_ids)
def test_family_autograd_op_matches_jax(case):
    """The loss and its five gradients through the port's autograd op with
    the family as its non-differentiable argument, scaled by a cotangent
    other than 1, against jax.grad through the JAX custom VJP."""
    wdt, family, i8, masked = case
    fold, coords, ws, yt, mask = _family_inputs(wdt, family, i8, masked)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    jm = None if mask is None else jnp.asarray(mask)

    def f(fold, w1, b1, wht, bht):
        return COT * jl8.fused_decoder_bce_int8(
            fold, jnp.asarray(coords), w1, b1, wht, bht, jnp.asarray(yt), jm,
            family)

    loss, want = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(fold), *jw)
    tf = torch.from_numpy(fold).requires_grad_()
    tw = [torch.from_numpy(w).to(wdt).requires_grad_() for w in ws]
    got = l8.fused_decoder_bce_int8(
        tf, torch.from_numpy(coords), *tw, torch.from_numpy(yt),
        None if mask is None else torch.from_numpy(mask), family)
    (COT * got).backward()
    np.testing.assert_allclose(COT * float(got.detach()), float(loss),
                               rtol=2e-6)
    tol = dict(FAMILY_TOL[wdt])
    if wdt == torch.bfloat16:
        # the weight gradients come back in bf16: one ulp of the largest
        # value (3.9e-3) is within the limit
        tol.update(dwht=(4e-3, 1e-3), dbht=(4e-3, 4e-3))
    for name, a, b in zip(GRADS, [tf.grad] + [t.grad for t in tw], want):
        assert a.dtype == (torch.float32 if name == "dfold" else wdt)
        _assert_rel(a.float().numpy(), np.asarray(b, np.float32), tol[name],
                    name)


def test_wrapper_checks_family_inputs():
    fold, coords, ws, yt, mask = _family_inputs(torch.float32, "colored",
                                                False, True, b=2, h=16)
    args = [torch.from_numpy(fold), torch.from_numpy(coords),
            *map(torch.from_numpy, ws)]
    with pytest.raises(ValueError, match="family"):
        l8.run_loss_int8(*args, torch.from_numpy(yt), None, "poisson")
    with pytest.raises(ValueError, match="colored family"):
        l8.run_loss_int8(*args, torch.zeros((2, 2, 1024)), None, "colored")
    with pytest.raises(ValueError, match="n_out 2"):
        l8.run_loss_int8(*args[:4], args[4][:1], args[5][:1],
                         torch.zeros((2, 1, 512)), None, "colored")


# ---------------------------------------------------------------------------
# padded pixel counts through fused_bce_spatial_int8
# ---------------------------------------------------------------------------


def _generator(n_out, latent=4, h=32, seed=1, b=4):
    cfg = SpatialGeneratorConfig(latent_dim=latent, hidden_dim=h,
                                 n_out=n_out, num_layers=2)
    params = jax.tree_util.tree_map(
        np.asarray, spatial_generator_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    pose = (rng.normal(size=b).astype(np.float32),
            (0.1 * rng.normal(size=(b, 2))).astype(np.float32),
            rng.normal(size=(b, latent)).astype(np.float32))
    return cfg, params, pose


def _port_grads(gen, tpose):
    out = {"pose": [t.grad.numpy() for t in tpose],
           "coord.w": gen.coord_linear.weight.grad.numpy().T,
           "latent.w": gen.latent_linear.weight.grad.numpy().T}
    for i, lin in enumerate(gen.linears()):
        out[f"w{i}"] = lin.weight.grad.numpy().T
        out[f"b{i}"] = lin.bias.grad.numpy()
    return out


def _jax_grads(gp, gpose):
    out = {"pose": [np.asarray(g) for g in gpose],
           "coord.w": np.asarray(gp["coord"]["w"]),
           "latent.w": np.asarray(gp["latent"]["w"])}
    for i, p in enumerate(gp["layers"]):
        out[f"w{i}"], out[f"b{i}"] = np.asarray(p["w"]), np.asarray(p["b"])
    return out


# (family, image side, int8-grid data, mask): MNIST's 784 -> 1024 (one
# group) and an odd cryo-EM side, 33x33 = 1089 -> 1280 (five groups of 256)
PAD_CASES = [("bernoulli", 28, True, False), ("gaussian", 33, False, True),
             ("gaussian", 28, False, True)]
# against JAX, relative to each leaf's largest value (max, mean).  The
# decoder's own leaves (dW1, db1, dWh, dbh) read at most 1.24e-6 / 3.5e-7.
# The leaves behind the fold (pose, coordinate and latent weights) sum
# dfold * d fold over H with cancellation, which amplifies dfold's 1e-5 (the
# bf16 dh0 chain that XLA fuses otherwise, tests/test_torch_port_int8.py):
# measured at most 2.33e-3 / 1.57e-3 (theta, four values)
PAD_TOL = {"fold": (6e-3, 4e-3), "decoder": (1e-5, 2e-6)}
FOLD_LEAVES = ("pose", "coord.w", "latent.w")


@pytest.mark.parametrize("case", PAD_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}px")
def test_padded_loss_matches_jax(case):
    """``fused_bce_spatial_int8`` builds the pad (coords, forced mask,
    targets) itself; value and every gradient against the JAX helper in
    interpret mode."""
    family, side, grid_data, masked = case
    hw = side * side
    assert l8.padded_hw(hw) != hw
    cfg, params, pose = _generator(1)
    rng = np.random.default_rng(5)
    y = (rng.integers(0, 256, (4, hw)) / 255.0 if grid_data
         else 0.5 + 0.4 * rng.normal(size=(4, hw))).astype(np.float32)
    mask = _circle(side, side) if masked else None
    jm = None if mask is None else jnp.asarray(mask)

    def loss(params, theta, dx, z):
        return jl8.fused_bce_spatial_int8(
            params, cfg, jnp.asarray(jax_grid(side, side)), theta, dx, z,
            jnp.asarray(y), mask=jm, family=family, interpret=True)

    want, (gp, *gpose) = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        params, *pose)
    gen = generator_from_jax(params, to_port(cfg))
    tpose = [torch.from_numpy(a).requires_grad_() for a in pose]
    got = l8.fused_bce_spatial_int8(
        gen, coord_grid(side, side), *tpose, torch.from_numpy(y),
        mask=None if mask is None else torch.from_numpy(mask), family=family)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-6)
    g, w = _port_grads(gen, tpose), _jax_grads(gp, gpose)
    for k in w:
        tol = PAD_TOL["fold" if k in FOLD_LEAVES else "decoder"]
        for a, b in zip(*([g[k], w[k]] if k == "pose" else [[g[k]], [w[k]]])):
            _assert_rel(a, b, tol, k)


@pytest.mark.parametrize("case", PAD_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}px")
def test_pad_changes_nothing_beyond_quantisation(case):
    """The padded call against the same likelihood over the unpadded float
    decode under autograd: the pad rows (real activations at coords (0, 0))
    must add nothing, so what is left is the decoder's 4-bit quantisation.
    Measured: the loss within 8.3e-4 relative (a pad that leaked, 240 of
    1,024 rows, would move it by a fifth), the decoder's gradient leaves
    within 0.13 of their largest value (max) and 0.035 (mean); behind the
    fold the quantisation error is of the order of the cancelled sums (up to
    1.3 on theta), so those leaves are not held.  At 28x28 the whole image
    is one quantisation group padded or not, and there the plain version
    over the unpadded 784 pixels agrees bit for bit (measured 0)."""
    family, side, grid_data, masked = case
    hw = side * side
    cfg, params, pose = _generator(1)
    rng = np.random.default_rng(5)
    y = (rng.integers(0, 256, (4, hw)) / 255.0 if grid_data
         else 0.5 + 0.4 * rng.normal(size=(4, hw))).astype(np.float32)
    mask = None if not masked else torch.from_numpy(_circle(side, side))
    grid = coord_grid(side, side)

    def run(fn):
        gen = generator_from_jax(params, to_port(cfg))
        tpose = [torch.from_numpy(a).requires_grad_() for a in pose]
        out = fn(gen, tpose)
        out.backward()
        return float(out.detach()), _port_grads(gen, tpose)

    def float_loss(gen, tpose):
        s = spatial_generator_apply_folded(gen, grid, *tpose)[..., 0]
        t = torch.from_numpy(y)
        m = 1.0 if mask is None else mask[None, :]
        if family == "gaussian":
            return 0.5 * torch.sum(m * (s - t) ** 2)
        per = F.binary_cross_entropy(s, t, reduction="none")
        return torch.sum(m * per)

    got, g = run(lambda gen, tpose: l8.fused_bce_spatial_int8(
        gen, grid, *tpose, torch.from_numpy(y), mask=mask, family=family))
    want, w = run(float_loss)
    np.testing.assert_allclose(got, want, rtol=4e-3)
    for k in w:
        if k not in FOLD_LEAVES:
            _assert_rel(g[k], w[k], (0.3, 0.08), k)

    if l8.pick_tile(hw) != hw or l8.pick_tile(l8.padded_hw(hw)) != \
            l8.padded_hw(hw):
        return
    # one group either way: the unpadded plain version is the same sum
    from spatialvae_torch.models.spatial import fold_pose_into_first_layer
    gen = generator_from_jax(params, to_port(cfg))
    with torch.no_grad():
        w0, w1f, c = fold_pose_into_first_layer(gen, *map(torch.from_numpy,
                                                          pose))
        fold = torch.stack([w0, w1f, c, torch.zeros_like(c)], dim=1)
        hidden, head = gen.linears()
        ws = (hidden.weight.T, hidden.bias, head.weight, head.bias)
        yt = torch.from_numpy(y)[:, None, :]
        ref = l8.loss_int8_reference(fold, grid, *ws, yt, mask, family)
        pad = l8.padded_hw(hw) - hw
        forced = F.pad(torch.ones(hw) if mask is None else mask, (0, pad))
        padded = l8.loss_int8_reference(
            fold, F.pad(grid, (0, 0, 0, pad)), *ws, F.pad(yt, (0, pad)),
            forced, family)
    for name, a, b in zip(GRADS, padded, ref):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the colored layout and the gates
# ---------------------------------------------------------------------------


def test_colored_layout_helpers_match_jax_exactly():
    rng = np.random.default_rng(9)
    for side, pt in ((32, 1024), (64, 1024), (48, 256)):
        hw = side * side
        c = coord_grid(side, side)
        assert l8.pick_tile(hw) == jl8._pick_tile(hw) == pt
        want = np.asarray(jl8._colored_coords(jnp.asarray(c.numpy()), pt))
        assert np.array_equal(l8.colored_coords(c, pt).numpy(), want)
        y = rng.normal(size=(3, hw, 1)).astype(np.float32)
        want = np.asarray(jl8._colored_targets(jnp.asarray(y), hw))
        got = l8.colored_targets(torch.from_numpy(y), hw)
        assert got.shape == (3, 2, hw // 2)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(
            port_trainer.yt_layout(torch.from_numpy(y), hw, True).numpy(),
            want)
        m = (rng.uniform(size=hw) > 0.5).astype(np.float32)
        assert np.array_equal(l8.colored_mask(torch.from_numpy(m)).numpy(),
                              m.reshape(hw // 2, 2).T)
        on = (rng.integers(0, 256, (3, hw)) / 255.0).astype(np.float32)
        want = np.asarray(jax_trainer._build_yt_i8(jnp.asarray(on), hw,
                                                   colored=True))
        got = port_trainer.build_yt_i8(torch.from_numpy(on), hw, True)
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)


def test_family_gates_match_jax_over_a_grid():
    """fused_loss_active and can_fuse_loss_int8 over (family, n_out, pixel
    count, batch parity, fit_noise_interleaved), and each family reaches the
    kernel somewhere on the grid."""
    reached = set()
    for n_out in (1, 2, 3):
        cfg = SpatialGeneratorConfig(latent_dim=2, hidden_dim=32,
                                     n_out=n_out, num_layers=2)
        pcfg = to_port(cfg)
        for lik in ("bernoulli", "gaussian", "colored"):
            for hw in (512, 767, 768, 784, 1024, 1089, 1280, 4096, 4225,
                       4226, 4352):
                assert (l8.can_fuse_loss_int8(pcfg, hw, lik)
                        == jl8.can_fuse_loss_int8(cfg, hw, lik))
                for inter in (True, False):
                    for b in (4, 5):
                        kw = dict(likelihood=lik, fused=True, int8=True,
                                  fit_noise_interleaved=inter)
                        want = jax_active(JaxElboConfig(**kw), cfg, hw, b)
                        assert fused_loss_active(ElboConfig(**kw), pcfg, hw,
                                                 b) == want
                        if want:
                            assert b == 4
                            reached.add((lik, n_out,
                                         l8.padded_hw(hw) == hw))
    assert reached == {("bernoulli", 1, True), ("bernoulli", 1, False),
                       ("bernoulli", 2, True), ("bernoulli", 2, False),
                       ("bernoulli", 3, True), ("bernoulli", 3, False),
                       ("gaussian", 1, True), ("gaussian", 1, False),
                       ("colored", 2, True)}
