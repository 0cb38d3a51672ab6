"""K1 and K2's deep kernels (``csrc/fused_decoder_sm90_deep.cu``: a hidden
width above 512 and two to four hidden layers) on the CPU: their schedules
emulated on the host (``tests/dec90_layouts.py``: ``deep_forward`` and
``deep_backward``, every product through the chunked slab streams and
every dW through the workspaces the chain writes) against the JAX
package's ``fused_decoder_tail`` and its VJP in Pallas interpret mode; one
Trainer step with four decoder layers against the JAX trainer's.

- the forward's column chunks, with the head's partial sums carried across
  them, at H = 520 and 1,030 (one and two chunk crossings), and its layer
  passes through the f32 activation buffer at Lh = 2 and 4;
- the chain's column chunks and its passes l = Lh .. 1 through the f32 da
  buffers, each layer's dW from workspaces of ``sm90_rows(H)`` rows;
- f32 and bf16 weights, with and without the residual add.

Tolerances: y and the activations within rtol 1e-5 and 1e-6 of the largest
value (f32: the products' sums run in another order) or 1e-2 of it (bf16:
the packages round a tanh to bf16 from values an ulp apart); each gradient
within rtol 1e-5 and 1e-5 of its largest value (f32) or 1e-2 of it (bf16),
the limits of ``test_torch_port_wide.py``.  The step: the narrow trainer
tests' 1e-5 on the metrics, every weight within 2*lr with a mean below
1e-6.  The kernels themselves are held to the plain versions and the tile
kernels on the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from spatialvae_tpu.core.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_tpu.kernels import fused_decoder as jax_fd
from spatialvae_tpu.objectives import ElboConfig as JaxElboConfig
from spatialvae_tpu.train import trainer as jax_trainer
from spatialvae_tpu.transforms.coords import coord_grid as jax_grid

from spatialvae_torch.io.jax_params import from_jax_params, named_to_jax
from spatialvae_torch.kernels import fused_decoder as fd
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid
from tests import dec90_layouts as dl
from tests.port_configs import one_torch_thread, to_port  # noqa: F401

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
GRADS = ("dfold", "dwhid", "dbhid", "dwht", "dbht")

# (Lh, H, resid, weight dtype)
CASES = [
    (1, 520, False, torch.float32), (1, 520, True, torch.bfloat16),
    (1, 1030, True, torch.float32), (1, 1030, False, torch.bfloat16),
    (2, 40, True, torch.float32), (2, 40, False, torch.bfloat16),
    (4, 40, False, torch.float32), (4, 40, True, torch.bfloat16),
    (2, 520, True, torch.float32),
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SPATIALVAE_INTERPRET", "1")


def _inputs(lh, h, no, wdt, b=2, side=16, seed=0):
    rng = np.random.default_rng(seed)
    fold = np.zeros((b, 4, h), np.float32)
    fold[:, :2] = rng.uniform(-0.7, 0.7, (b, 2, h))
    fold[:, 2] = rng.uniform(-1.5, 1.5, (b, h))
    bound = 1 / np.sqrt(h)
    ws = [torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32))
          .to(wdt).float().numpy()
          for s in ((lh, h, h), (lh, h), (no, h), (no,))]
    g = rng.normal(size=(b, no, side * side)).astype(np.float32)
    return fold, jax_grid(side, side), ws, g


def _close(got, want, wdt, what, grad=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32).reshape(got.shape)
    scale = float(np.abs(want).max()) or 1.0
    if wdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=(1e-5 if grad else 1e-6) * scale,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale,
                                   err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"Lh{c[0]}-H{c[1]}-{'resid' if c[2] else 'plain'}-{str(c[3])[6:]}"))
def test_deep_schedules_match_jax(case):
    lh, h, resid, wdt = case
    no = 3
    fold, coords, ws, g = _inputs(lh, h, no, wdt)
    jw = [jnp.asarray(w, JNP[wdt]) for w in ws]
    jf, jc = jnp.asarray(fold), jnp.asarray(coords)
    with pltpu.force_tpu_interpret_mode():
        y, acts = jax_fd._fwd_pallas(jf, jc, *jw[:3], jw[3][:, None], resid,
                                     emit_acts=True)
        _, vjp = jax.vjp(lambda f, *w: jax_fd.fused_decoder_tail(
            f, jc, *w, resid), jf, *jw)
        want = vjp(jnp.asarray(g))
    tf, tc = torch.from_numpy(fold), torch.from_numpy(np.asarray(coords))
    tw = [torch.from_numpy(w).to(wdt) for w in ws]
    got_y, got_acts = dl.deep_forward(tf, tc, *tw, resid)
    _close(got_y.numpy(), np.asarray(y), wdt, "y")
    _close(got_acts.numpy(), np.asarray(acts.astype(jnp.float32)), wdt,
           "acts")
    grads = dl.deep_backward(tf, tc, tw[0], tw[2], got_acts.to(wdt), got_y,
                             torch.from_numpy(g), resid)
    for name, a, w in zip(GRADS, grads, want):
        _close(a.numpy(), np.asarray(w, np.float32), wdt, name, grad=True)


def test_trainer_step_with_four_decoder_layers():
    """One float step of a galaxy-shaped model whose decoder has four
    layers (Lh = 3) from one init, same batch and noise: the port's step
    (its fused decoder's plain versions on the CPU) against the JAX
    trainer's."""
    side = 16
    q_cfg = InferenceConfig(n=side * side * 3, latent_dim=6, hidden_dim=64,
                            num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=3, hidden_dim=48, n_out=3,
                                   num_layers=4)
    ekw = dict(fused=True, channels=3)
    jt = jax_trainer.Trainer(q_cfg, p_cfg, JaxElboConfig(**ekw),
                             jax_trainer.TrainConfig(minibatch_size=4),
                             jnp.asarray(jax_grid(side, side)))
    tr = Trainer(to_port(q_cfg), to_port(p_cfg), ElboConfig(**ekw),
                 TrainConfig(minibatch_size=4), coord_grid(side, side),
                 device="cpu")
    assert fd.can_fuse_decoder(tr.p_net.cfg, side * side)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jt.state.params)
    q, p = from_jax_params(params["q"], params["p"], to_port(q_cfg),
                           to_port(p_cfg))
    tr.q_net.load_state_dict(q.state_dict())
    tr.p_net.load_state_dict(p.state_dict())
    rng = np.random.default_rng(5)
    y = (rng.integers(0, 256, (4, side * side, 3)) / 255.0).astype(np.float32)
    noise = rng.normal(size=(4, 6)).astype(np.float32)
    grad_fn = jax.value_and_grad(jt._loss, has_aux=True)
    with pltpu.force_tpu_interpret_mode():
        (_, aux), grads = grad_fn(jt.state.params, jnp.asarray(y), None, None,
                                  jnp.float32(1.0), y_t=None,
                                  noise=jnp.asarray(noise))
    state = jax_trainer.apply_update(jt.optimizer, jt.state, grads,
                                     jnp.float32)
    got = tr.train_step(torch.from_numpy(y), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(aux), rtol=1e-5)
    lr = TrainConfig().learning_rate
    g, gdef = jax.tree_util.tree_flatten(
        named_to_jax(tr.q_net, tr.p_net, tr.named_params()))
    w, wdef = jax.tree_util.tree_flatten(state.params)
    assert gdef == wdef
    for a, b in zip(g, w):
        d = np.abs(a - np.asarray(b, np.float32))
        assert d.max() <= 2 * lr and d.mean() <= 1e-6, (a.shape, d.max(),
                                                        d.mean())
