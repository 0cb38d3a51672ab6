"""Stochastic rounding (ROADMAP Queue 2 K3 (e)) in the port, on the CPU.

The JAX package cannot be the oracle here: its kernel draws its words from
the TPU's hardware generator and turns stochastic rounding off under
interpret mode (``use_sr = kcfg.sr and use_i4``), and its ``_sr_int`` does
not evaluate off a kernel.  So the port's SR is held to specifications:

- ``philox4x32_10`` against the Random123 known-answer vectors;
- ``sr_round`` against a jnp restatement of ``_sr_int``'s formula on the same
  words, bit for bit, the range ends and zeros included;
- unbiasedness: over many keys the mean of ``sr_round(x)`` is within 4
  sigma of x, where plain rounding is off by its bias;
- the two quantisation sites' words are independent;
- a call is a pure function of its inputs (same b1, same words);
- where the forward site's values are integers, SR leaves them and every
  output that depends only on them exactly as round-to-nearest does;
- an SR step through the ``Trainer`` stays within the int8-step band of the
  JAX trainer's round-to-nearest step, and differs from the port's own
  round-to-nearest step, in the Bernoulli family and in the colored one
  (fit-noise) under a pixel mask.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import from_jax_params
from spatialvae_torch.kernels import fused_loss_int8 as l8
from spatialvae_torch.kernels import philox as px
from spatialvae_torch.kernels.config import Numerics
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


# Random123's kat_vectors for philox4x32_10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    got = px.philox4x32_10(ctr, key)
    assert tuple(int(w) for w in got) == want
    # the same call, broadcast over a batch of counters
    batch = px.philox4x32_10((torch.tensor([ctr[0], 0]), ctr[1], ctr[2],
                              ctr[3]), key)
    assert tuple(int(w[0]) for w in batch) == want


def _jax_sr_int(x, bits, lo, hi):
    """``_sr_int`` (spatialvae_tpu/kernels/fused_loss_int8.py:188-196) with
    ``jax.lax.bitcast_convert_type`` for the kernel-only ``pltpu.bitcast``."""
    u = jax.lax.bitcast_convert_type(
        (bits & jnp.uint32(0x7FFFFF)) | jnp.uint32(0x3F800000),
        jnp.float32) - 1.0
    return jnp.clip(jnp.floor(x + u), lo, hi).astype(jnp.int8)


@pytest.mark.parametrize("lv", [7, 127])
def test_sr_round_is_the_jax_formula(lv):
    """Bit for bit on shared words: random values, the range ends +-lv and
    past them, values one ulp under an integer, and zeros (pad pixels)."""
    rng = np.random.default_rng(lv)
    x = rng.uniform(-lv - 1, lv + 1, 20000).astype(np.float32)
    edge = np.array([lv, -lv, lv + 0.5, -lv - 0.5, 0.0, -0.0,
                     np.nextafter(np.float32(3), np.float32(0)),
                     np.nextafter(np.float32(-3), np.float32(0))],
                    np.float32)
    x = np.concatenate([x, np.repeat(edge, 500)])
    bits = px.site_words(0x3F000000, px.SITE_GRAD, 1, 1, x.size)[0, 0]
    bits[-8:] = torch.tensor([0, M32, 0x7FFFFF, 0x3F800000, 1, 2, 3, 4])
    got = px.sr_round(torch.from_numpy(x), bits, -lv, lv)
    want = _jax_sr_int(jnp.asarray(x), jnp.asarray(bits.numpy(), jnp.uint32),
                       -lv, lv)
    assert np.array_equal(got.numpy(), np.asarray(want, np.float32))
    assert float(got.abs().max()) <= lv
    assert not got[x == 0].any()


def test_sr_round_is_unbiased():
    """Over 4096 keys the mean of sr_round(x) is within 4 sigma of x for
    values across a step; round-to-nearest is off by up to half a step."""
    x = torch.tensor([0.1, 0.5, -0.3, 2.75, -6.9, 6.5], dtype=torch.float32)
    n = 4096
    bits = px.site_words(12345, px.SITE_FWD, n, 1, x.numel())[:, 0]
    got = px.sr_round(x.expand(n, -1), bits, -7, 7).mean(dim=0)
    frac = x - torch.floor(x)
    sigma = torch.sqrt(frac * (1 - frac) / n)
    assert bool(((got - x).abs() <= 4 * sigma + 1e-7).all()), (got, x)
    assert float((torch.round(x) - x).abs().max()) >= 0.4


def test_sites_draw_independent_words():
    """The forward and gradient sites' uniforms at the same (image, row,
    column) are uncorrelated (|r| within 4/sqrt(n)); each site's are
    uniform with mean 1/2."""
    b, rows, cols = 4, 64, 64
    u_f = px.uniform(px.site_words(0x3DCCCCCD, px.SITE_FWD, b, rows, cols))
    u_g = px.uniform(px.site_words(0x3DCCCCCD, px.SITE_GRAD, b, rows, cols))
    n = u_f.numel()
    r = np.corrcoef(u_f.flatten().double().numpy(),
                    u_g.flatten().double().numpy())[0, 1]
    assert abs(r) < 4 / np.sqrt(n), r
    for u in (u_f, u_g):
        assert abs(float(u.double().mean()) - 0.5) < 4 * np.sqrt(1 / 12 / n)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # another step (another b1) draws another pattern
    u_f2 = px.uniform(px.site_words(0x3DCCCCCE, px.SITE_FWD, b, rows, cols))
    assert float((u_f == u_f2).double().mean()) < 1e-3


def _loss_inputs(no=3, b=4, h=32, seed=0, zero_fold=False):
    rng = np.random.default_rng(seed)
    fold = np.zeros((b, 4, h), np.float32)
    if not zero_fold:
        fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
        fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
          for s in ((h, h), (h,), (no, h), (no,))]
    yt = torch.from_numpy((rng.integers(0, 256, (b, no, 1024)) - 128)
                          .astype(np.int8))
    return torch.from_numpy(fold), coord_grid(32, 32), ws, yt


@pytest.mark.parametrize("nm", [Numerics(sr=True),
                                Numerics(sr=True, grad_mode="i8"),
                                Numerics(sr=True, gscale="tile", epi="f32")],
                         ids=["default", "i8", "tile-f32"])
def test_sr_call_is_reproducible_and_rounds_stochastically(nm):
    """Two calls with the same inputs agree bit for bit (the words are a
    function of b1 and the element); the quantised tiles are the SR of
    their pre-round values; another b1 draws other words, and RTN gives
    other tiles."""
    fold, coords, ws, yt = _loss_inputs()
    out, (aq, qi) = l8.loss_int8_reference(fold, coords, *ws, yt,
                                           numerics=nm, ints=True)
    again, (aq2, qi2) = l8.loss_int8_reference(fold, coords, *ws, yt,
                                               numerics=nm, ints=True)
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    assert torch.equal(aq, aq2) and torch.equal(qi, qi2)
    rtn, (aq_r, qi_r) = l8.loss_int8_reference(
        fold, coords, *ws, yt, numerics=Numerics(
            grad_mode=nm.grad_mode, gscale=nm.gscale, epi=nm.epi), ints=True)
    lf = nm.fwd_level
    # SR moves an element by at most one step from RTN, and moves many
    assert float((aq - aq_r).abs().max()) <= 1.0
    assert 0.05 < float((aq != aq_r).double().mean()) < 0.6
    assert float((qi != qi_r).double().mean()) > 0.01
    a0 = torch.tanh(l8._first_layer(fold, coords))
    want = px.sr_round(a0 * float(lf), px.site_words(
        px.f32_bits(ws[1][0]), px.SITE_FWD, *a0.shape), -lf, lf)
    assert torch.equal(aq, want)
    b1 = ws[1].clone()
    b1[0] = torch.nextafter(b1[0], torch.tensor(1.0))
    _, (aq3, _) = l8.loss_int8_reference(fold, coords, ws[0], b1, *ws[2:],
                                         yt, numerics=nm, ints=True)
    assert not torch.equal(aq, aq3)


def test_sr_equals_rtn_where_values_are_integers():
    """A zero fold makes a0 = 0, an integer at the forward site: SR rounds
    it as RTN does (floor(0 + u) = 0), so the loss, dWh^T and dbh, which
    depend on the forward alone, are bit for bit RTN's; integers in [-1, 1]
    are unchanged by sr_round for every word."""
    fold, coords, ws, yt = _loss_inputs(zero_fold=True)
    sr, (aq, _) = l8.loss_int8_reference(fold, coords, *ws, yt,
                                         numerics=Numerics(sr=True),
                                         ints=True)
    rtn = l8.loss_int8_reference(fold, coords, *ws, yt)
    assert not aq.any()
    assert torch.equal(sr[0][:, 3, 0], rtn[0][:, 3, 0])
    assert torch.equal(sr[3], rtn[3]) and torch.equal(sr[4], rtn[4])
    x = torch.tensor([-1.0, 0.0, 1.0]).repeat(4000)
    bits = px.site_words(7, px.SITE_GRAD, 1, 1, x.numel())[0, 0]
    assert torch.equal(px.sr_round(x, bits, -7, 7), x)


def test_sr_counters_take_the_image_index_of_the_call():
    """Images 2 and 3 of a call run alone with ``image0=2`` draw the words
    they draw in the whole call (the kernels' chunks do that: the counters
    take the absolute image): the same tiles as the whole call's rows; run
    at index 0 they draw others."""
    fold, coords, ws, yt = _loss_inputs(b=6)
    nm = Numerics(sr=True)
    _, (aq, qi) = l8.loss_int8_reference(fold, coords, *ws, yt, numerics=nm,
                                         ints=True)
    _, (aq2, qi2) = l8.loss_int8_reference(fold[2:4], coords, *ws, yt[2:4],
                                           numerics=nm, ints=True, image0=2)
    assert torch.equal(aq2, aq[2:4]) and torch.equal(qi2, qi[2:4])
    _, (aq0, _) = l8.loss_int8_reference(fold[2:4], coords, *ws, yt[2:4],
                                         numerics=nm, ints=True)
    assert not torch.equal(aq0, aq[2:4])


# ---------------------------------------------------------------------------
# an SR step through the trainer
# ---------------------------------------------------------------------------

N = M = 32
Z, B = 3, 4
# family -> (channels, n_out, ElboConfig fields, unit-disc mask)
SR_FAMILIES = {"bernoulli": (3, 3, {}, False),
               "colored_mask": (1, 2, dict(likelihood="colored"), True)}


def _disc():
    g = coord_grid(N, M).numpy()
    return (np.sum(g ** 2, axis=1) <= 1.0).astype(np.float32)


def _trainers(family="bernoulli"):
    c, n_out, ekw, masked = SR_FAMILIES[family]
    q_cfg = InferenceConfig(n=N * M * c, latent_dim=Z + 3, hidden_dim=64,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z, hidden_dim=48, n_out=n_out,
                                   num_layers=2)
    ekw = dict(ekw, fused=True, int8=True, channels=c)
    mask = _disc() if masked else None
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw),
                             jax_trainer.TrainConfig(minibatch_size=B),
                             jnp.asarray(jax_grid(N, M)),
                             mask=None if mask is None else jnp.asarray(mask))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(minibatch_size=B), coord_grid(N, M), mask=mask,
                 device="cpu")
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    return jt, tr


SR_DW1 = (0.25, 0.03)


@pytest.mark.parametrize("family", sorted(SR_FAMILIES))
def test_sr_step_stays_in_the_int8_band(family, monkeypatch):
    """One even SR step against the JAX trainer's round-to-nearest step (JAX
    has no SR off the TPU) on the same weights, batch and noise: the step's
    metrics within the int8-step limit of ``test_torch_port_int8_train``
    (1e-3 relative), the decoder gradients within their int8 noise (1e-1 of
    the largest), and not equal to the port's own RTN step.  Bernoulli on
    the /255 grid; colored (the fit-noise head) under the unit-disc mask on
    whitened, off-grid images, as the particles CLI's ``--fit-noise``
    trains it (on pure noise images the RTN oracle's own error is larger
    than the band: ``test_sr_gap_on_noise_images_is_round_to_nearest_own``)."""
    c = SR_FAMILIES[family][0]
    rng = np.random.default_rng(4)
    if family == "bernoulli":
        y = (rng.integers(0, 256, (B, N * M, c)) / 255.0).astype(np.float32)
    else:
        # a blob per image, whitened, with noise on top (the families'
        # images, tests/test_torch_port_families_train.py)
        g = coord_grid(N, M).numpy()
        at = rng.uniform(-0.3, 0.3, (B, 1, 2))
        blob = np.exp(-np.sum((g[None] - at) ** 2, axis=2) / 0.08)[..., None]
        y = (blob - blob.mean()
             + 0.3 * rng.normal(size=blob.shape)).astype(np.float32)
    noise = rng.normal(size=(B, Z + 3)).astype(np.float32)
    jt, tr = _trainers(family)
    y_t = tr._dataset_yt(torch.from_numpy(y))
    (_, jaux), jgrads = jax.value_and_grad(jt._loss, has_aux=True)(
        jt.state.params, jnp.asarray(y), None, None, jnp.float32(1.0),
        y_t=jnp.asarray(y_t.numpy()), noise=jnp.asarray(noise))

    from spatialvae_torch.objectives import loss_and_grad

    def step():
        _, aux = loss_and_grad(tr.q_net, tr.p_net, tr.ecfg, tr.coords,
                               torch.from_numpy(y), y_t=y_t,
                               noise=torch.from_numpy(noise), mask=tr.mask)
        return aux, {k: p.grad.clone()
                     for k, p in tr.named_params().items()}

    rtn_aux, rtn = step()
    monkeypatch.setenv("SPATIALVAE_SR", "1")
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    sr_aux, sr = step()
    np.testing.assert_allclose(sr_aux.numpy(), np.asarray(jaux), rtol=1e-3)
    jw1 = np.asarray(jgrads["p"]["layers"][0]["w"])
    hidden = tr.p_net.linears()[0].weight
    name = next(k for k, p in tr.named_params().items() if p is hidden)
    scale = np.abs(jw1).max()
    d_sr = np.abs(sr[name].T.numpy() - jw1) / scale
    d_rtn = np.abs(rtn[name].T.numpy() - jw1) / scale
    print("SR", d_sr.max(), d_sr.mean(), "RTN", d_rtn.max(), d_rtn.mean())
    assert d_sr.max() <= SR_DW1[0] and d_sr.mean() <= SR_DW1[1]
    assert d_rtn.max() <= 1e-5 and d_sr.mean() > 10 * d_rtn.mean()
    assert not torch.equal(sr[name], rtn[name])
    np.testing.assert_allclose(rtn_aux.numpy(), np.asarray(jaux), rtol=1e-3)


def test_sr_gap_on_noise_images_is_round_to_nearest_own(monkeypatch):
    """On N(0,1) noise images, with no signal to fit (the colored family
    under its mask), the SR step's dW1 is farther from the round-to-nearest
    step than the band test allows, and that gap is round-to-nearest's own
    error: measured against the float step (the same step without int8),
    SR stays within a third of RTN's distance, and SR's distance to RTN is
    RTN's distance to the float step.  This is why the band test, whose
    oracle is JAX's RTN step, holds the colored step on images with a
    signal."""
    import dataclasses

    from spatialvae_torch.objectives import loss_and_grad

    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.normal(size=(B, N * M, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(B, Z + 3)).astype(np.float32))
    _, tr = _trainers("colored_mask")
    y_t = tr._dataset_yt(y)
    w1 = tr.p_net.linears()[0].weight

    def dw1(ecfg):
        tr.q_net.zero_grad()
        tr.p_net.zero_grad()
        loss_and_grad(tr.q_net, tr.p_net, ecfg, tr.coords, y, y_t=y_t,
                      noise=noise, mask=tr.mask)
        return w1.grad.clone()

    flt = dw1(dataclasses.replace(tr.ecfg, int8=False))
    rtn = dw1(tr.ecfg)
    monkeypatch.setenv("SPATIALVAE_SR", "1")
    monkeypatch.setenv("SPATIALVAE_ALLOW_KNOBS", "1")
    sr = dw1(tr.ecfg)
    scale = rtn.abs().max()

    def gap(a, b):
        d = (a - b).abs() / scale
        return d.max().item(), d.mean().item()

    sr_rtn, sr_flt, rtn_flt = gap(sr, rtn), gap(sr, flt), gap(rtn, flt)
    print("SR-RTN", sr_rtn, "SR-float", sr_flt, "RTN-float", rtn_flt)
    assert sr_rtn[0] > SR_DW1[0]
    for i in (0, 1):
        assert sr_flt[i] < rtn_flt[i] / 3
        assert 0.5 <= sr_rtn[i] / rtn_flt[i] <= 2.0
