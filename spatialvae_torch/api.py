"""Serving API for trained spatial-VAE models — counterpart of
``spatialvae_tpu/api.py``.

    model = SpatialVae.load("run_generator_epoch100.sav",
                            "run_inference_epoch100.sav")   # on the card
    z_mu, z_logstd = model.encode(images)
    recon = model.reconstruct(images, generator=g)          # posterior sample
    canon = model.reconstruct_canonical(images, generator=g)  # pose-stripped
    samples = model.sample(16, generator=g)                 # prior samples

A vanilla generator's checkpoint serves too: it decodes z alone, with no
pose slots.  Every spatial decode goes through the ELBO's decode dispatch
with the fused decoder selected, so on a CUDA device the foldable tanh
configs (galaxy among them) run the hand-written kernel at any hidden
width.  (The JAX API pins the XLA decoder because a pallas_call could not
be partitioned under GSPMD; the port has no such limit, and kernel and
plain decoder compute the same function.)
Random draws come from an explicit ``torch.Generator``; ``noise=`` injects
a given standard-normal draw instead.  ``load`` puts the model on the CUDA
card unless it is given ``device="cpu"`` (or another device), and raises
when there is no card and no device was named.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from spatialvae_torch.config import InferenceConfig, VanillaGeneratorConfig
from spatialvae_torch.checkpoint import load_model_meta
from spatialvae_torch.device import resolve_device
from spatialvae_torch.io.jax_params import (
    generator_from_jax,
    inference_from_jax,
)
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.objectives.elbo import (
    ElboConfig,
    decode,
    elbo_minibatch,
)
from spatialvae_torch.precision import fp32_precision
from spatialvae_torch.transforms.coords import coord_grid


@dataclass
class SpatialVae:
    q_net: InferenceNetwork
    p_net: torch.nn.Module               # SpatialGenerator or VanillaGenerator
    q_cfg: InferenceConfig
    p_cfg: object
    coords: torch.Tensor
    image_shape: Tuple[int, int]
    ecfg: Optional[ElboConfig] = None     # ElboConfig persisted at training

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def vanilla(self) -> bool:
        return isinstance(self.p_cfg, VanillaGeneratorConfig)

    @property
    def pose_dims(self) -> int:
        """Latent slots used by rotation (1) + translation (2)."""
        if self.ecfg is not None and not self.vanilla:
            return int(self.ecfg.rotate) + 2 * int(self.ecfg.translate)
        return self.q_cfg.latent_dim - self.p_cfg.latent_dim

    @property
    def serving_ecfg(self) -> ElboConfig:
        """The persisted ELBO/pose config with the fused decoder selected;
        pre-r2 checkpoints fall back to the latent-layout heuristic."""
        if self.ecfg is not None:
            return dataclasses.replace(self.ecfg, fused=True, int8=False)
        pose = self.pose_dims
        return ElboConfig(rotate=pose >= 1, translate=pose >= 2, fused=True,
                          vanilla=self.vanilla)

    @staticmethod
    def load(generator_path: str, inference_path: str,
             image_shape: Optional[Tuple[int, int]] = None, *,
             device=None, dtype: torch.dtype = torch.float32
             ) -> "SpatialVae":
        """image_shape may be omitted when the checkpoint persisted it.
        Reference torch .sav files load too (pass image_shape).  ``device``
        None means the CUDA card (``device.resolve_device``)."""
        device = resolve_device(device)
        p_params, p_cfg, kind, meta = load_model_meta(generator_path)
        if kind != "generator":
            raise ValueError(f"{generator_path} holds a {kind} network")
        q_params, q_cfg, kind, _ = load_model_meta(inference_path)
        if kind != "inference":
            raise ValueError(f"{inference_path} holds a {kind} network")
        if image_shape is None:
            image_shape = meta.get("image_shape")
            if image_shape is None:
                raise ValueError(
                    f"{generator_path} predates image-shape persistence; "
                    "pass image_shape=(n, m) explicitly")
        n, m = image_shape
        return SpatialVae(
            q_net=inference_from_jax(q_params, q_cfg, device=device,
                                     dtype=dtype).eval(),
            p_net=generator_from_jax(p_params, p_cfg, device=device,
                                     dtype=dtype).eval(),
            q_cfg=q_cfg, p_cfg=p_cfg,
            coords=coord_grid(n, m, device=device),
            image_shape=(int(n), int(m)), ecfg=meta.get("elbo"))

    def as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.array(a))
        return a.to(device=self.device, dtype=torch.float32)

    def _normal(self, shape, generator, noise) -> torch.Tensor:
        if noise is not None:
            return self.as_tensor(noise)
        return torch.randn(shape, generator=generator, device=self.device)

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    @fp32_precision()
    def encode(self, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """y: (B, HW[, C]) in [0,1] -> (z_mu, z_logstd) incl. pose slots."""
        y = self.as_tensor(y)
        return self.q_net(y.reshape(y.shape[0], -1))

    @torch.no_grad()
    @fp32_precision()
    def decode(self, z) -> torch.Tensor:
        """z: (B, z_dim) content latents -> (B, HW, n_out), canonical pose
        (a vanilla generator: (B, n, n_out))."""
        return decode(self.p_net, self.serving_ecfg, self.coords, None, None,
                      self.as_tensor(z))

    def sample(self, num: int, generator: Optional[torch.Generator] = None,
               *, noise=None) -> torch.Tensor:
        """Prior samples z ~ N(0, I) decoded over the canonical grid."""
        return self.decode(self._normal((num, self.p_cfg.latent_dim),
                                        generator, noise))

    @torch.no_grad()
    def reconstruct(self, y, generator: Optional[torch.Generator] = None,
                    *, noise=None) -> torch.Tensor:
        """Posterior-sample reconstruction including the inferred pose,
        with the ELBO/pose config persisted in the checkpoint."""
        y = self.as_tensor(y)
        _, _, _, y_hat = elbo_minibatch(
            self.q_net, self.p_net, self.serving_ecfg, self.coords, y,
            generator, noise=None if noise is None else self.as_tensor(noise))
        return y_hat

    def reconstruct_canonical(self, y,
                              generator: Optional[torch.Generator] = None,
                              *, noise=None) -> torch.Tensor:
        """Pose-stripped reconstruction (rotation/translation removed)."""
        z_mu, z_logstd = self.encode(y)
        r = self._normal(z_mu.shape, generator, noise)
        z = torch.exp(z_logstd) * r + z_mu
        return self.decode(z[:, self.pose_dims:])
