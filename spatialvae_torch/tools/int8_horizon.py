"""Long-horizon bf16-vs-int8 ELBO gap on the card -- the port of
``tools/int8_horizon.py``, the quality gate of the int8 speed mode:

    python -m spatialvae_torch.tools.int8_horizon [epochs=30] [batch=1024]
        [steps=8] [data=fields|galaxy] [likelihood=bernoulli|gaussian|
        colored] [mask=1] [moments=bf16] [calib_seed=N] [device=cpu]

Trains the galaxy-scale workload twice from the same seed, once with the
bf16 decoder kernels (K1/K2) and once in int8 mode (K3 on even batches),
and prints each epoch's ELBO of both, then the relative gap per epoch and a
JSON summary (``max_rel_gap``, ``final_rel_gap``, ``inside_1pct``, ...).
The int8 default is only honest if the gap stays inside the 1% band over a
real training horizon.

The configuration is the TPU tool's: 64x64 images, z=20, encoder 5,000
wide with 2 layers, decoder 500 wide with 2 layers, bf16 compute, Adam at
lr 1e-4 (``run``'s keywords narrow the widths and the side for tests).
``data=fields`` (default) trains on smooth rotated fields, ``galaxy`` on a
synthetic galaxy proxy on the /255 grid (``make_galaxy_proxy``); both are
numpy arrays from fixed seeds, the TPU tool's bit for bit.  ``likelihood=
gaussian|colored`` trains grayscale particles-style data (colored: two
outputs, ``--fit-noise``), ``mask=1`` under the circular mask.
``moments=bf16`` stores Adam's moments in bf16 in the int8 arm only;
``calib_seed=N`` makes the second arm another bf16 run at seed N, the
seed-to-seed yardstick the int8 gap is read against.

Off-default numerics knobs in the environment (``SPATIALVAE_SR=1``,
``SPATIALVAE_INT4_GRADS``, ``SPATIALVAE_LOSS_LAYOUT=t``) are allowed while
the tool runs (``knobs_allowed``), and ``SPATIALVAE_ADAM_MOMENTS`` is set
for the int8 arm alone; the caller's environment comes back afterwards.
It runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from spatialvae_torch.config import InferenceConfig, SpatialGeneratorConfig
from spatialvae_torch.data.dataset import ArrayDataset
from spatialvae_torch.device import resolve_device
from spatialvae_torch.kernels.config import knobs_allowed
from spatialvae_torch.objectives import ElboConfig
from spatialvae_torch.train.trainer import TrainConfig, Trainer
from spatialvae_torch.transforms.coords import coord_grid

USAGE = ("python -m spatialvae_torch.tools.int8_horizon [epochs=30] "
         "[batch=1024] [steps=8] [data=fields|galaxy] [likelihood=...] "
         "[mask=1] [moments=bf16] [calib_seed=N] [device=cpu]")
SIDE, Z_DIM, Q_HIDDEN, P_HIDDEN = 64, 20, 5000, 500


def make_galaxy_proxy(n_images, n, m, channels, seed=3):
    """A galaxy_zoo proxy: per-image Sersic-like galaxies (exponential disk
    and bulge, random ellipticity, position angle and radius, the bulge
    redder than the disk) on dark noisy skies, occasional neighbour point
    sources, rounded through uint8 as the real PNG pipeline is.  The TPU
    tool's numpy recipe, unchanged."""
    rng = np.random.default_rng(seed)
    xg = np.linspace(-1, 1, m, dtype=np.float32)
    yg = np.linspace(1, -1, n, dtype=np.float32)
    x0, x1 = np.meshgrid(xg, yg)
    imgs = np.zeros((n_images, n, m, channels), np.float32)
    for i in range(n_images):
        theta = rng.uniform(0, 2 * np.pi)
        ell = rng.uniform(0.0, 0.7)
        r_d = rng.uniform(0.12, 0.35)          # disk scale length
        r_b = r_d * rng.uniform(0.15, 0.4)     # bulge
        dx, dy = rng.uniform(-0.15, 0.15, size=2)
        c, s = np.cos(theta), np.sin(theta)
        u = (c * (x0 - dx) - s * (x1 - dy))
        v = (s * (x0 - dx) + c * (x1 - dy)) / (1.0 - ell)
        r = np.sqrt(u * u + v * v)
        disk = np.exp(-r / r_d)
        bulge = np.exp(-(r / r_b) ** 0.5)
        amp_d = rng.uniform(0.5, 0.9)
        amp_b = rng.uniform(0.3, 0.8)
        sky = rng.uniform(0.02, 0.06)
        # channel weights: bulge red-heavy, disk blue-heavy
        disk_w = np.linspace(1.0, 0.7, channels)
        bulge_w = np.linspace(0.7, 1.0, channels)
        img = (amp_d * disk[..., None] * disk_w
               + amp_b * bulge[..., None] * bulge_w)
        for _ in range(rng.poisson(0.7)):
            px, py = rng.uniform(-0.9, 0.9, size=2)
            pr2 = (x0 - px) ** 2 + (x1 - py) ** 2
            img += rng.uniform(0.2, 0.9) * np.exp(
                -pr2 / (2 * 0.03 ** 2))[..., None]
        img = img + sky + rng.normal(0, 0.015, size=img.shape)
        imgs[i] = np.round(np.clip(img, 0, 1) * 255.0) / 255.0
    return imgs


FIELD_CHUNK = 256           # images per worker task of make_fields


def make_fields(n_images, n, m, channels):
    """Smooth rotated fields (a sum of 8 plane waves per channel through a
    sigmoid, each image rotated at random): structured data the model
    learns, so the ELBO moves over the horizon.  The TPU tool's numpy
    recipe, element for element; its float64 waves are computed in chunks
    of images on the host's cores (numpy releases the GIL), which leaves
    every element's arithmetic as it was."""
    rng = np.random.default_rng(3)
    k = 8
    amp = rng.normal(size=(channels, k)) * 1.2
    kx = rng.uniform(1.0, 5.0, size=k)
    ky = rng.uniform(1.0, 5.0, size=k)
    ph = rng.uniform(0, 2 * np.pi, size=k)
    xg = np.linspace(-1, 1, m, dtype=np.float32)
    yg = np.linspace(1, -1, n, dtype=np.float32)
    x0, x1 = np.meshgrid(xg, yg)
    thetas = rng.uniform(0, 2 * np.pi, size=n_images).astype(np.float32)
    imgs = np.zeros((n_images, n, m, channels), np.float32)

    def fill(lo: int) -> None:
        hi = min(lo + FIELD_CHUNK, n_images)
        c, s = np.cos(thetas[lo:hi]), np.sin(thetas[lo:hi])
        u = c[:, None, None] * x0[None] - s[:, None, None] * x1[None]
        v = s[:, None, None] * x0[None] + c[:, None, None] * x1[None]
        for ch in range(channels):
            acc = np.zeros_like(u)
            for i in range(k):
                acc += amp[ch, i] * np.sin(kx[i] * u * np.pi
                                           + ky[i] * v * np.pi + ph[i])
            imgs[lo:hi, ..., ch] = 1.0 / (1.0 + np.exp(-acc))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(fill, range(0, n_images, FIELD_CHUNK)))
    return imgs


def build_trainer(epochs: int, batch: int, int8: bool,
                  likelihood: str = "bernoulli", masked: bool = False,
                  seed: int = 0, *, device=None, side: int = SIDE,
                  q_hidden: int = Q_HIDDEN, p_hidden: int = P_HIDDEN
                  ) -> Trainer:
    """The TPU tool's trainer: grayscale for the particles likelihoods
    (``colored`` with two outputs), the circular mask under ``masked``."""
    n = m = side
    channels = 1 if likelihood in ("gaussian", "colored") else 3
    q_cfg = InferenceConfig(n=n * m * channels, latent_dim=Z_DIM + 3,
                            hidden_dim=q_hidden, num_layers=2)
    p_cfg = SpatialGeneratorConfig(latent_dim=Z_DIM, hidden_dim=p_hidden,
                                   n_out=2 if likelihood == "colored"
                                   else channels, num_layers=2)
    ecfg = ElboConfig(rotate=True, translate=True, theta_prior=np.pi,
                      likelihood=likelihood, channels=channels, fused=True,
                      int8=int8)
    tcfg = TrainConfig(minibatch_size=batch, learning_rate=1e-4,
                       num_epochs=epochs, seed=seed,
                       compute_dtype="bfloat16", image_shape=(n, m),
                       channels=channels)
    grid = coord_grid(n, m)
    mask = None
    if masked:
        # the particles CLI's circular mask
        mask = torch.from_numpy(
            (np.sum(grid.numpy() ** 2, axis=1) <= 1.0).astype(np.float32))
    return Trainer(q_cfg, p_cfg, ecfg, tcfg, grid, mask=mask, device=device)


def make_data(data: str, n_images: int, side: int, channels: int
              ) -> np.ndarray:
    """(n_images, side * side, channels) float32 images of ``data``."""
    if data == "galaxy":
        imgs = make_galaxy_proxy(n_images, side, side, channels)
    elif data == "fields":
        imgs = make_fields(n_images, side, side, channels)
    else:
        raise ValueError(f"data={data!r}; expected fields or galaxy")
    return imgs.reshape(n_images, side * side, channels)


def run(epochs: int, batch: int, steps: int, int8: bool,
        data: str = "fields", likelihood: str = "bernoulli",
        masked: bool = False, seed: int = 0, *, device=None,
        side: int = SIDE, q_hidden: int = Q_HIDDEN,
        p_hidden: int = P_HIDDEN, imgs=None) -> list:
    """One arm: ``epochs`` epochs of ``steps`` batches; returns the
    per-epoch training ELBOs.  ``imgs``: the arm's ``make_data`` images
    when the caller has made them already."""
    trainer = build_trainer(epochs, batch, int8, likelihood, masked, seed,
                            device=device, side=side, q_hidden=q_hidden,
                            p_hidden=p_hidden)
    if imgs is None:
        imgs = make_data(data, batch * steps, side, trainer.tcfg.channels)
    ds = ArrayDataset.from_numpy(imgs, device=trainer.device)
    return _train(trainer, ds, epochs, int8)


def _train(trainer, ds, epochs: int, int8: bool) -> list:
    """``epochs`` epochs of ``trainer`` on ``ds``, one line each; returns
    the per-epoch training ELBOs."""
    elbos = []
    for e in range(epochs):
        t0 = time.perf_counter()
        elbo, _, _ = trainer.train_epoch(ds, e, progress=False)
        elbos.append(elbo)
        print(f"# {'int8' if int8 else 'bf16'} epoch {e + 1}: ELBO={elbo:.4f}"
              f" ({time.perf_counter() - t0:.1f}s)", flush=True)
    return elbos


def summary(bf16: list, arm: list, arm_name: str, **meta) -> dict:
    """Print each epoch's two ELBOs and their relative gap; return the
    JSON summary (``meta`` first, then the arm and the gaps)."""
    rel = [abs((a - b) / b) for a, b in zip(arm, bf16)]
    for e, (b, a, r) in enumerate(zip(bf16, arm, rel)):
        print(f"epoch {e + 1:3d}  bf16={b:.4f}  {arm_name}={a:.4f}  "
              f"rel={r:.2e}")
    return {**meta, "arm": arm_name, "max_rel_gap": max(rel),
            "final_rel_gap": rel[-1], "inside_1pct": max(rel) < 0.01}


@contextlib.contextmanager
def _env(name: str, value):
    """``name`` set to ``value`` (None: unset) inside the block; the
    caller's value after it."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def parse_argv(argv) -> dict:
    """The TPU tool's ``k=v`` arguments, and ``device``."""
    out = dict(epochs=30, batch=1024, steps=8, data="fields",
               likelihood="bernoulli", masked=False, moments=None,
               calib_seed=None, device=None)
    for a in argv:
        k, sep, v = a.partition("=")
        if not sep:
            raise SystemExit(f"usage: {USAGE}")
        if k in ("epochs", "batch", "steps", "calib_seed"):
            out[k] = int(v)
        elif k in ("data", "likelihood", "moments", "device"):
            out[k] = v
        elif k == "mask":
            out["masked"] = v == "1"
        else:
            raise SystemExit(f"usage: {USAGE}")
    return out


def main(argv=None) -> int:
    a = parse_argv(sys.argv[1:] if argv is None else argv)
    device = resolve_device(a["device"])
    epochs, batch, steps = a["epochs"], a["batch"], a["steps"]
    # both arms train on the same arrays: made once (the TPU tool makes
    # them per arm, from the same seeds)
    channels = 1 if a["likelihood"] in ("gaussian", "colored") else 3
    imgs = make_data(a["data"], batch * steps, SIDE, channels)
    kw = dict(data=a["data"], likelihood=a["likelihood"],
              masked=a["masked"], device=device, imgs=imgs)
    # a measurement entry point: the knobs the caller set are allowed while
    # it runs, and the moments dtype is the int8 arm's alone
    with knobs_allowed():
        with _env("SPATIALVAE_ADAM_MOMENTS", None):
            bf16 = run(epochs, batch, steps, False, **kw)
            if a["calib_seed"] is not None:
                arm = run(epochs, batch, steps, False, seed=a["calib_seed"],
                          **kw)
                arm_name = f"bf16(seed={a['calib_seed']})"
        if a["calib_seed"] is None:
            with _env("SPATIALVAE_ADAM_MOMENTS", a["moments"]):
                arm = run(epochs, batch, steps, True, **kw)
            arm_name = "int8"
    print(json.dumps(summary(
        bf16, arm, arm_name, epochs=epochs, batch=batch,
        steps_per_epoch=steps, data=a["data"], likelihood=a["likelihood"],
        mask=a["masked"], moments=a["moments"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
