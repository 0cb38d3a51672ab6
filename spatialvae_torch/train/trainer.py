"""Single-device trainer — counterpart of ``spatialvae_tpu/train/trainer.py``.

One driver for the spatial-VAE workloads, configured by ``ElboConfig`` and
``TrainConfig``: seeded init, the dataset held on the device, epochs of
shuffled minibatches (each batch's indices sorted, the tail batch trained as
its own step), the z-delay curriculum, ``loss_and_grad`` then Adam per step,
one device-to-host copy of an epoch's metrics, evaluation and the display
decodes.  It runs on the CUDA card unless it is given ``device="cpu"``.

Every step ends in Adam, one launch of K6 per parameter leaf
(``train/optimizer_fused.py``).  With bf16 compute the step runs the JAX
package's TPU stack (``trainer.py:431-437`` there): the loss differentiates
the bf16 **shadow** of the parameters, which Adam writes beside the float32
masters (no per-step cast of the 86.9 M galaxy parameters), and in int8
mode the encoder's hidden GEMMs run on int8 with the int8 **qshadow**
copies that Adam emits for the 2-D leaves of at least ``_QENC_MIN_ELEMS``
elements, the full batches reading layer 0's input from a per-dataset int8
copy of the images (``_dataset_yq8``).  Evaluation and display read the
float32 masters.

Float mode: the training steps run the fused decoder's forward and backward
kernels (K1, K2).  int8 mode (``ElboConfig(fused=True, int8=True)``): every
step whose batch is even runs the fused int8 loss-and-gradient kernel (K3)
in the likelihood's family (Bernoulli, Gaussian, colored), with the
trainer's pixel mask, on targets gathered from a per-dataset copy in the
kernel's layout (``_dataset_yt``: int8 k-128 when the data sits on the /255
grid, else the compute dtype; (N, C, HW) padded once to the kernel's pixel
count, 784 -> 1024, or the colored family's pre-paired (N, 2, HW/2)), at
the numerics the environment selects (``kernels/config.numerics``: the
trainer refuses any knob off its default at construction unless
``SPATIALVAE_ALLOW_KNOBS=1``, as the JAX trainer does; under
``SPATIALVAE_LOSS_LAYOUT=t`` the Bernoulli steps with float targets take the
feature-major kernel K8); an odd tail runs the int8 decoder (K4 with its a1
output, K5 backward) and the likelihood in PyTorch.  Evaluation runs the
forward alone (K1, or K4 in int8 mode) under no_grad, without the loss
kernel; the display decodes (``reconstruct_canonical``, ``sample_prior``)
decode in float on the float32 masters (K1), as the JAX trainer's do.

Random draws come from ``torch.Generator``s seeded from (seed, stream), as
the JAX trainer folds an epoch index into its key: the seed alone draws the
weights, stream 2e shuffles epoch e, 2e+1 draws its steps' noise,
1_000_000_007 + e the evaluation's, 7/8/9 the display paths'.  The bits
differ from JAX's; the parity tests inject the same batches and noise into
both.

Rotation augmentation (``TrainConfig.augment_rotation``) runs in the
training steps only, never in ``eval_epoch``, as in JAX: each step draws
one angle per image in [0, 2 pi) from its generator (before the
reparameterisation noise), rotates the batch on the device
(``transforms/augment.py``) as the encoder's view, rounds that view onto
the /255 grid under ``augment_uint8``, and hands the angles to the ELBO,
which adds them to theta.  The targets stay the unrotated images, so the
loss kernel's target copy still serves; the int8 data copy of the encoder
input does not.  A dataset with per-image CTF kernels (``.ctf``, (N, kn,
km)) has them gathered per batch beside the images and cast to the compute
dtype; such steps never take the loss kernel.  CTF with bf16 compute
raises ``ValueError`` before any work, as the JAX trainer does at its first
step (XLA's FFT takes float32 or float64 only).

The vanilla generator (``VanillaGeneratorConfig``, with
``ElboConfig(vanilla=True)``) trains through the same loop: no pose, no
augmentation (as in JAX), no loss kernel or int8 decoder; every step still
ends in Adam's step kernel, and the display decodes decode z alone.

A host-resident dataset (``ArrayDataset(..., host_resident=True)``, the
CLI's ``--no-preload``) is streamed one minibatch per step
(``data/stream.BatchStager``: two pinned staging slots, the copies on a
side stream), through the same permutation, sorted index batches, step
generator and tail as a preloaded epoch, so a streamed float epoch is the
preloaded one.  It builds no per-dataset copy: in int8 mode its steps
transpose and quantise their batch in the step (K3 reads float targets),
as the JAX trainer's streamed steps do.  The per-step progress line is
printed one step behind, so reading the metrics never waits on the step
just launched.

With ``debug_nans`` (the CLI's ``--debug-nans``) every training step checks
its loss terms and gradients with ``torch.isfinite`` after the loss and
gradient launches and before Adam's step kernel writes, and raises
``FloatingPointError`` naming the epoch and step: the parameters stay those
of the step before.  Without it a step makes no check and no extra
synchronisation.

Meshes (``mesh=``, ``parallel/mesh.py``: one process a device over
``torch.distributed``), routed as the JAX trainer routes them
(``trainer.py:294-300``, ``:413-497``):

- a mesh without a model axis takes the data-parallel step
  (``parallel/spmd.make_spmd_step``): each rank runs the one-device step on
  its rows of every global batch, the gradients and metrics are averaged
  over 'data', and every rank's Adam applies the same update, so the
  masters, the shadow and the int8 copies stay equal on every rank;
- a model axis whose pixel slices the fused int8 loss kernel takes
  (``parallel/pixel.pixel_step_refusal``, the JAX ``_pixel_spmd_ok``:
  fused int8 mode, not colored, the rows and pixels dividing evenly, K3
  active for the slice's shapes) takes the pixel step
  (``make_spmd_pixel_step``): the encoder and the pose fold on the rank's
  rows, K3 on its pixel slice, the gradients summed over 'model' and
  averaged over 'data';
- any other model axis (JAX's GSPMD tensor-parallel path) raises
  ``NotImplementedError`` naming ROADMAP M10b.

Every rank draws the same permutation and sorted batches and takes its own
rows; the steps' noise comes from a generator per data index (the JAX
``fold_in`` of the shard index: the pixel ranks of one data index share
it).  The tail, and under the pixel step every batch without the target
copy (streamed) or with CTF, runs on every rank whole (the replicated
step: the non-step config, a generator shared by all ranks, no
reduction), except that a data-parallel tail that divides over 'data'
takes the data-parallel step, as in JAX.  The evaluation draws each
batch's noise once for the whole batch and gives each data rank its rows
(``make_spmd_eval_step``); a batch that does not divide runs whole on
every rank.  Rank 0 alone prints the progress lines.  Rank 0's weights are
broadcast to every rank at construction.

``train_epochs`` runs the epochs one by one; its single-dispatch form (CUDA
graphs) is a later speed choice.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from spatialvae_torch.config import InferenceConfig, VanillaGeneratorConfig
from spatialvae_torch.data.stream import BatchStager
from spatialvae_torch.device import resolve_device
from spatialvae_torch.kernels.config import check_knobs
from spatialvae_torch.kernels.fused_loss_int8 import (
    colored_targets,
    padded_hw,
)
from spatialvae_torch.models.inference import InferenceNetwork
from spatialvae_torch.models.spatial import SpatialGenerator
from spatialvae_torch.models.vanilla import VanillaGenerator
from spatialvae_torch.nn.layers import stack_linears
from spatialvae_torch.objectives.elbo import (
    ElboConfig,
    decode,
    elbo_minibatch,
    fused_loss_active,
    loss_and_grad,
    loss_terms,
)
from spatialvae_torch.parallel.pixel import pixel_step_refusal
from spatialvae_torch.parallel.sharding import (
    batch_sharding,
    shard_params,
    tensor_parallel_refusal,
)
from spatialvae_torch.train.metrics import StreamingMeans
from spatialvae_torch.train.optimizer_fused import (
    fused_adam_pallas,
    quantize_dataset,
    quantize_leaf,
)
from spatialvae_torch.transforms.augment import rotate_images_bicubic

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# parameter leaves at least this large get int8 copies from the Adam pass
# (at galaxy size the two big encoder hidden weights; the decoder and the
# heads stay bf16).  Read at each use, so a test may patch it.
_QENC_MIN_ELEMS = 8 << 20


@dataclass(frozen=True)
class TrainConfig:
    """The JAX TrainConfig's fields and defaults."""

    minibatch_size: int = 100
    learning_rate: float = 1e-4
    num_epochs: int = 100
    z_delay: int = 0
    augment_rotation: bool = False
    augment_uint8: bool = False
    seed: int = 0
    compute_dtype: str = "float32"          # 'float32' | 'bfloat16'
    image_shape: Optional[Tuple[int, int]] = None   # (n, m)
    channels: int = 1


def _warn_nonfinite(m: np.ndarray, epoch_base: int,
                    step_base: int = 0) -> None:
    """Divergence warning for a (..., num_batches, 3) metric array; the
    leading axis (if any) indexes epochs starting at ``epoch_base``;
    ``step_base`` offsets the reported step (the tail batch's)."""
    if np.all(np.isfinite(m)):
        return
    idx = np.argwhere(~np.isfinite(m))[0]
    epoch = epoch_base + (int(idx[0]) if m.ndim == 3 else 0)
    step = step_base + int(idx[1] if m.ndim == 3 else idx[0])
    print(f"# WARNING: non-finite training metrics at epoch {epoch + 1}, "
          f"step {step + 1} — loss diverged", file=sys.stderr)


def check_finite(aux: torch.Tensor, grads: dict,
                 at: Optional[Tuple[int, int]] = None) -> None:
    """``--debug-nans``: raise ``FloatingPointError`` unless the step's loss
    terms ``aux`` and every gradient of ``grads`` (name -> tensor or None)
    are finite; ``at`` is the (0-based epoch, step) the message names.  One
    synchronisation: a flag per tensor, read once."""
    named = [("loss terms", aux)] + [(k, g) for k, g in grads.items()
                                     if g is not None]
    flags = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if bool(flags.all()):
        return
    bad = [k for (k, _), ok in zip(named, flags.tolist()) if not ok]
    where = "" if at is None else f" at epoch {at[0] + 1}, step {at[1] + 1}"
    raise FloatingPointError(
        f"non-finite {', '.join(bad)}{where} (--debug-nans): the step "
        f"stopped before Adam wrote the parameters")


def seeded_generator(seed: int, stream: Optional[int], device,
                     shard: Optional[int] = None) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream); stream None is
    the weight init's; ``shard`` folds a data rank's index in."""
    entropy = [seed] if stream is None else [seed, stream]
    if shard is not None:
        entropy.append(shard)
    state = np.random.SeedSequence(entropy).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


@torch.no_grad()
def probe_255_grid(a: torch.Tensor, rows: int = 4096) -> tuple:
    """(max |255a - round(255a)|, min and max of round(255a)) over the
    images of ``a``: whether the data sits exactly on the uint8/255 grid.
    Computed in f32 over chunks of ``rows`` images, so the transient stays
    a chunk's size."""
    err, lo, hi = 0.0, float("inf"), float("-inf")
    for i in range(0, a.shape[0], rows):
        scaled = a[i:i + rows].float() * 255.0
        q = torch.round(scaled)
        err = max(err, (scaled - q).abs().max().item())
        lo, hi = min(lo, q.min().item()), max(hi, q.max().item())
    return err, lo, hi


@torch.no_grad()
def build_yt_i8(a: torch.Tensor, hw: int,
                colored: bool = False) -> torch.Tensor:
    """(N, C, HW) int8 target copy of /255-grid data (N, HW[, C]), the value
    k/255 stored as k - 128; the loss kernel decodes it exactly.
    ``colored``: the fit-noise family's pre-paired (N, 2, HW/2) layout,
    out[n, c, u] = a[n, 2u + c]."""
    q = (torch.round(a.float() * 255.0) - 128.0).to(torch.int8)
    return yt_layout(q, hw, colored)


def yt_layout(a: torch.Tensor, hw: int, colored: bool) -> torch.Tensor:
    """(N, HW[, C]) images in the loss kernel's target layout: (N, C, HW),
    or the colored family's pre-paired (N, 2, HW/2) (``colored_targets``)."""
    t = (colored_targets(a, hw) if colored
         else a.reshape(a.shape[0], hw, -1).transpose(1, 2))
    return t.contiguous()


def index_batches(perm: torch.Tensor, b: int):
    """(full (num_full, b) with each row sorted, tail or None): shuffling
    needs only a random partition into batches, and sorted rows make the
    per-step gathers semi-sequential (the JAX ``_index_batches``)."""
    n = perm.shape[0]
    num_full = n // b
    full = torch.sort(perm[:num_full * b].reshape(num_full, b), dim=1).values
    tail = perm[num_full * b:] if n > num_full * b else None
    return full, tail


class Trainer:
    """Owns the modules, the Adam state and the epoch loop on one device,
    or on this rank of a mesh."""

    def __init__(self, q_cfg: InferenceConfig, p_cfg, ecfg: ElboConfig,
                 tcfg: TrainConfig, coords: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, *, device=None,
                 mesh=None, debug_nans: bool = False):
        if tcfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {tcfg.compute_dtype!r}; "
                             f"expected one of {sorted(_DTYPES)}")
        # the mesh's step, decided before any work (the JAX spmd_dp and
        # spmd_pixel)
        self.mesh = mesh
        self._spmd = mesh is not None and mesh.shape["model"] == 1
        self._spmd_pixel = False
        if mesh is not None and not self._spmd:
            why = pixel_step_refusal(ecfg, p_cfg, tcfg.minibatch_size,
                                     coords.shape[0], mesh.shape)
            if why is not None:
                raise tensor_parallel_refusal(
                    f"a model axis of {mesh.shape['model']} with {why} (the "
                    f"pixel step runs K3 on each rank's share)")
            self._spmd_pixel = True
        if self._spmd and tcfg.minibatch_size % mesh.shape["data"]:
            raise ValueError(f"minibatch {tcfg.minibatch_size} does not "
                             f"divide over {mesh.shape['data']} data ranks")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self._primary = mesh is None or mesh.rank == 0
        self.debug_nans = debug_nans
        self.q_cfg, self.p_cfg, self.ecfg, self.tcfg = q_cfg, p_cfg, ecfg, tcfg
        self.coords = coords.to(self.device, torch.float32)
        self.mask = (None if mask is None
                     else torch.as_tensor(mask).to(self.device))
        self.compute_dtype = _DTYPES[tcfg.compute_dtype]
        # a stray SPATIALVAE_* variable must not silently alter training
        # numerics: checked at every construction, as the JAX trainer does
        check_knobs()
        # evaluation keeps the fused forward decoder and drops the loss
        # kernel (its forward computes all five gradients); the display
        # decodes run in float on the float32 masters (K1 on the card), as
        # the JAX trainer's plain spatial_generator_apply does
        self._nonstep_ecfg = dataclasses.replace(ecfg, fused_loss=False)
        self._display_ecfg = dataclasses.replace(ecfg, int8=False)
        self._yt_cache = {}
        init = seeded_generator(tcfg.seed, None, self.device)
        self.q_net = InferenceNetwork(q_cfg, generator=init,
                                      device=self.device)
        gen_cls = (VanillaGenerator
                   if isinstance(p_cfg, VanillaGeneratorConfig)
                   else SpatialGenerator)
        self.p_net = gen_cls(p_cfg, generator=init, device=self.device)
        if mesh is not None:
            # every rank starts from rank 0's weights
            shard_params(self.named_params(), mesh, self._spmd_pixel)
        self.optimizer = fused_adam_pallas(tcfg.learning_rate)
        self.opt_state = self.optimizer.init(self.named_params())
        # one device: bf16 compute differentiates the shadow, and int8 mode
        # adds the int8 encoder (the JAX trainer's _use_shadow/_use_qenc)
        self._use_shadow = self.compute_dtype == torch.bfloat16
        self._use_qenc = self._use_shadow and bool(ecfg.int8)
        # the copies the Adam pass writes, seeded at the first step
        # (_seeded_state): shadow, name -> bf16 leaf requiring grad;
        # qshadow, name -> {"q", "s", "ns"} (empty "q" below the threshold)
        self.shadow: Optional[dict] = None
        self.qshadow: Optional[dict] = None
        ids = {id(p): f"q.{n}" for n, p in self.q_net.named_parameters()}
        self._qenc_names = [ids[id(lin.weight)] for lin in
                            stack_linears(self.q_net.layers)[:-1]]
        self._yq8_cache = {}
        self.last_images_per_sec = 0.0
        # this rank's share of a step: its rows and, under the pixel step,
        # its pixel slice
        self._rows = None if mesh is None else batch_sharding(mesh)
        self._local_batch = tcfg.minibatch_size // (
            1 if mesh is None else mesh.shape["data"])
        self._local_hw = coords.shape[0] // (
            mesh.shape["model"] if self._spmd_pixel else 1)
        self._mesh_step = self._mesh_eval = None
        if mesh is not None:
            from spatialvae_torch.parallel import spmd

            self._mesh_step = (spmd.make_spmd_step(self, mesh) if self._spmd
                               else spmd.make_spmd_pixel_step(self, mesh))
            self._mesh_eval = spmd.make_spmd_eval_step(self, mesh)

    # ---------------------------------------------------------------- state
    def named_params(self) -> dict:
        """``q.<name>`` and ``p.<name>`` -> parameter (the Adam leaves)."""
        return {f"{k}.{n}": p for k, net in (("q", self.q_net),
                                             ("p", self.p_net))
                for n, p in net.named_parameters()}

    def _gen(self, stream: int, shard: Optional[int] = None
             ) -> torch.Generator:
        return seeded_generator(self.tcfg.seed, stream, self.device, shard)

    def _step_gen(self, epoch: int) -> torch.Generator:
        """The generator of an epoch's steps: stream 2*epoch + 1, with the
        data rank's index folded in under a mesh."""
        return self._gen(2 * epoch + 1,
                         None if self.mesh is None else self.mesh.data_index)

    def _seeded_state(self) -> None:
        """Seed the shadow (bf16 casts of the masters) and the qshadow
        (``quantize_leaf`` of each leaf) when the step needs them and they
        are missing; later steps carry them out of the Adam pass.  After
        replacing the masters, set both to None to seed them anew."""
        if self._use_shadow and self.shadow is None:
            self.shadow = {k: p.detach().to(self.compute_dtype)
                           .requires_grad_()
                           for k, p in self.named_params().items()}
        if self._use_qenc and self.qshadow is None:
            self.qshadow = {k: quantize_leaf(p, p.dim() == 2 and p.numel()
                                             >= _QENC_MIN_ELEMS)
                            for k, p in self.named_params().items()}

    def grad_target(self):
        """(the dict the loss differentiates, or None for the masters;
        the encoder's int8 entries, or None): the JAX ``grad_target``."""
        if self.shadow is None:
            return None, None
        qq = None
        if self.qshadow is not None:
            qq = [self.qshadow[n] for n in self._qenc_names]
        return self.shadow, qq

    def apply_update(self, grads: dict) -> None:
        """Adam, and the shadow and qshadow emission the state carries:
        the JAX ``apply_update`` on one device."""
        params = self.named_params()
        if self.shadow is None:
            self.opt_state = self.optimizer.update_apply(
                grads, self.opt_state, params)
        elif self.qshadow is None:
            self.opt_state = self.optimizer.update_apply(
                grads, self.opt_state, params, shadow=self.shadow)
        else:
            self.opt_state, self.qshadow = self.optimizer.update_apply(
                grads, self.opt_state, params, shadow=self.shadow,
                quant_min_elems=_QENC_MIN_ELEMS, prev_quant=self.qshadow)

    # per-dataset copies hold dataset-sized tensors: at most two each
    _DATASET_CACHE_MAX = 2

    def _cache_put(self, cache: dict, src, value) -> None:
        """Keyed by the caller's array, which the entry keeps alive; the
        oldest entry is evicted."""
        while len(cache) >= self._DATASET_CACHE_MAX:
            cache.pop(next(iter(cache)))
        cache[id(src)] = (src, value)

    def _dataset_yt(self, dataset,
                    data: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, C, HW) target copy of the dataset's images for the loss
        kernel, built once per dataset and cached.  The key is the caller's
        array (``dataset.y``, or the dataset itself), as in JAX, which the
        entry keeps alive; the oldest of two entries is evicted.  ``data``
        is its device copy when the caller has one.  On the /255 grid the
        copy is int8 (k/255 stored as k - 128): half the gather bytes of
        bf16 and exact; off the grid (whitened particles) it keeps the
        compute dtype.  The colored family gets its pre-paired (N, 2, HW/2)
        layout; the others are padded once to the kernel's pixel count
        (``padded_hw``) with the grid's zero (-128) or 0.0, which the
        kernel's forced mask drops either way."""
        src = getattr(dataset, "y", dataset)
        hit = self._yt_cache.get(id(src))
        if hit is not None and hit[0] is src:
            return hit[1]
        if data is None:
            data = self._data(dataset)
        hw = self.coords.shape[0]
        err, qmin, qmax = probe_255_grid(data)
        colored = self.ecfg.likelihood == "colored"
        if err < 1e-3 and qmin >= 0.0 and qmax <= 255.0:
            yt = build_yt_i8(data, hw, colored)
        else:
            yt = yt_layout(data.to(self.compute_dtype), hw, colored)
        pad = 0 if colored else padded_hw(hw) - hw
        if pad:
            yt = torch.nn.functional.pad(
                yt, (0, pad), value=-128 if yt.dtype == torch.int8 else 0)
        self._cache_put(self._yt_cache, src, yt)
        return yt

    def _dataset_yq8(self, dataset,
                     data: Optional[torch.Tensor] = None) -> tuple:
        """(xq (N, n) int8, sx (1, 1)): the encoder's input copy of the
        images, quantised once per dataset (``quantize_dataset``) and cached
        like ``_dataset_yt``."""
        src = getattr(dataset, "y", dataset)
        hit = self._yq8_cache.get(id(src))
        if hit is not None and hit[0] is src:
            return hit[1]
        if data is None:
            data = self._data(dataset)
        entry = quantize_dataset(data)
        self._cache_put(self._yq8_cache, src, entry)
        return entry

    def _wants_yt(self, ctf: Optional[torch.Tensor] = None) -> bool:
        """Whether the full-batch steps take the loss kernel, so that a
        target copy in its layout pays off: never with CTF; a rank's rows
        and pixels under a mesh."""
        return ctf is None and fused_loss_active(
            self.ecfg, self.p_cfg, self._local_hw, self._local_batch)

    def _wants_yq8(self, ctf: Optional[torch.Tensor] = None) -> bool:
        """Whether the full batches read the int8 data copy: with the int8
        encoder, unless the encoder sees augmented images or the data has
        CTF (the JAX ``_wants_yq8``)."""
        return (self._use_qenc and not self.tcfg.augment_rotation
                and ctf is None)

    def _data(self, dataset) -> torch.Tensor:
        """The dataset's images on the device: a tensor, or an object with
        ``.y`` (and optionally ``.ctf``)."""
        y = getattr(dataset, "y", dataset)
        if isinstance(y, np.ndarray):
            y = torch.from_numpy(y)
        return y.to(self.device, torch.float32)

    def _ctf(self, dataset) -> Optional[torch.Tensor]:
        """The dataset's per-image CTF kernels on the device, or None."""
        ctf = getattr(dataset, "ctf", None)
        if ctf is None:
            return None
        self._check_ctf(ctf)
        if isinstance(ctf, np.ndarray):
            ctf = torch.from_numpy(ctf)
        return ctf.to(self.device, torch.float32)

    def _check_ctf(self, ctf) -> None:
        if ctf is not None and self.compute_dtype != torch.float32:
            raise ValueError(
                "CTF needs compute_dtype='float32': the CTF's FFT takes "
                "float32 or float64, and the JAX trainer refuses the same "
                "combination at its first step (RFFT input must be float32 "
                "or float64, got bfloat16)")

    def _augment(self, y: torch.Tensor, offsets: torch.Tensor
                 ) -> torch.Tensor:
        """The encoder's view of the batch y (B, HW[, C]): each image
        rotated by its offset in the compute dtype, rounded onto the /255
        grid (clipped to [0, 1], in float32) under ``augment_uint8``."""
        if self.tcfg.image_shape is None:
            raise ValueError("rotation augmentation needs "
                             "TrainConfig.image_shape")
        n, m = self.tcfg.image_shape
        c = self.tcfg.channels
        yc = y.to(self.compute_dtype)
        imgs = yc.reshape((y.shape[0], n, m) + ((c,) if c > 1 else ()))
        view = rotate_images_bicubic(imgs, offsets).reshape(yc.shape)
        if self.tcfg.augment_uint8:
            view = (torch.round(torch.clamp(view.float(), 0.0, 1.0) * 255.0)
                    / 255.0).to(self.compute_dtype)
        return view

    # ---------------------------------------------------------------- steps
    def train_step(self, y: torch.Tensor, *,
                   y_t: Optional[torch.Tensor] = None,
                   y_q8: Optional[tuple] = None,
                   ctf: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   offsets: Optional[torch.Tensor] = None,
                   z_scale: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   at: Optional[Tuple[int, int]] = None,
                   replicated: bool = False) -> torch.Tensor:
        """One step: ``loss_and_grad`` then Adam.  y: (B, HW[, C]) on the
        device; ``y_t`` its targets in the loss kernel's layout, when the
        step takes that kernel; ``y_q8`` (xq (B, n) int8, sx) its rows of
        the int8 data copy, read by the int8 encoder; ``ctf`` its CTF
        kernels (B, kn, km).  With rotation augmentation the angles come
        from ``generator`` before the noise, or from ``offsets`` (B,) when
        given.  ``at`` (0-based epoch, step) names the step in the
        ``debug_nans`` error.  Returns aux = [elbo, -log_p, kl] (on the
        device).

        Under a mesh every argument is this rank's rows of the global batch
        (``y_t`` the whole grid's pixels or, under the pixel step, the
        rank's slice), and the returned aux is the global batch's, on every
        rank; ``replicated``: y is the whole batch, which every rank trains
        alike with the non-step config (the tail)."""
        if self.mesh is not None and not replicated:
            return self._mesh_step(y, y_t=y_t, y_q8=y_q8, ctf=ctf,
                                   noise=noise, offsets=offsets,
                                   z_scale=z_scale, generator=generator,
                                   at=at)
        aux, grads = self.local_gradients(
            y, y_t=y_t, y_q8=y_q8, ctf=ctf, noise=noise, offsets=offsets,
            z_scale=z_scale, generator=generator,
            ecfg=self._nonstep_ecfg if replicated else None)
        self.update(aux, grads, at)
        return aux

    def local_gradients(self, y: torch.Tensor, *,
                        y_t: Optional[torch.Tensor] = None,
                        y_q8: Optional[tuple] = None,
                        ctf: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        offsets: Optional[torch.Tensor] = None,
                        z_scale: float = 1.0,
                        generator: Optional[torch.Generator] = None,
                        ecfg: Optional[ElboConfig] = None,
                        coords: Optional[torch.Tensor] = None,
                        mask=None, pixel_axis=None) -> tuple:
        """The first half of a step on this device's batch: (aux, grads),
        grads name -> the gradient of the tensor the loss differentiates
        (the shadow's with bf16 compute, else the masters').  ``coords``,
        ``mask`` and ``pixel_axis`` default to the trainer's whole grid; the
        pixel step passes its slice (JAX ``Trainer._loss``)."""
        self._check_ctf(ctf)
        y_inf = None
        if (self.tcfg.augment_rotation and self.ecfg.rotate
                and not self.ecfg.vanilla):
            if offsets is None:
                offsets = torch.rand(y.shape[0], generator=generator,
                                     device=self.device) * (2.0 * math.pi)
            offsets = offsets.to(self.device, self.compute_dtype)
            y_inf = self._augment(y, offsets)
        else:
            offsets = None
        self._seeded_state()
        target, qq = self.grad_target()
        # the two labels let a profiler trace attribute the step's kernels
        with torch.profiler.record_function("loss_and_grad"):
            _, aux = loss_and_grad(
                self.q_net, self.p_net, ecfg or self.ecfg,
                self.coords if coords is None else coords, y,
                params=target, noise=noise, generator=generator,
                z_scale=z_scale, mask=self.mask if coords is None else mask,
                y_t=y_t, q_quant=qq, y_q8=y_q8, y_inf=y_inf,
                offsets=offsets, ctf=ctf,
                image_shape=self.tcfg.image_shape,
                compute_dtype=self.compute_dtype, pixel_axis=pixel_axis)
        leaves = target if target is not None else self.named_params()
        return aux, {k: t.grad for k, t in leaves.items()}

    def update(self, aux: torch.Tensor, grads: dict,
               at: Optional[Tuple[int, int]] = None) -> None:
        """The second half of a step: the ``debug_nans`` check, then Adam
        with the shadow and qshadow it emits."""
        if self.debug_nans:
            check_finite(aux, grads, at)
        with torch.profiler.record_function("adam"):
            self.apply_update(grads)

    def train_epoch(self, dataset, epoch: int, *, progress: bool = True,
                    progress_stream=None) -> Tuple[float, float, float]:
        """One training epoch; returns the (elbo, gen_loss, kl) streaming
        means.  The permutation comes from stream 2*epoch, the steps' noise
        (and augmentation angles) from stream 2*epoch + 1.  In int8 mode
        the full batches gather their targets from ``_dataset_yt`` and,
        with the int8 encoder, their encoder input from ``_dataset_yq8``;
        the tail builds its own targets and quantises its input per step,
        as in JAX.  CTF kernels are gathered per batch.  A host-resident
        dataset is streamed (``_stream_epoch``)."""
        if getattr(dataset, "host_resident", False):
            return self._stream_epoch(dataset, epoch, progress,
                                      progress_stream)
        ctf = self._ctf(dataset)
        return self._run_epoch(dataset, self._data(dataset), ctf, epoch,
                               progress, progress_stream)

    def _run_epoch(self, dataset, data: torch.Tensor,
                   ctf: Optional[torch.Tensor], epoch: int, progress: bool,
                   progress_stream) -> Tuple[float, float, float]:
        """``train_epoch`` on ``data`` and ``ctf``, the device copies of
        ``dataset``; under a mesh each rank takes its rows of each batch."""
        t_start = time.perf_counter()
        n, b = data.shape[0], self.tcfg.minibatch_size
        z_scale = 0.0 if epoch < self.tcfg.z_delay else 1.0
        perm = torch.randperm(n, generator=self._gen(2 * epoch),
                              device=self.device)
        full, tail = index_batches(perm, b)
        step_gen = self._step_gen(epoch)
        data_t = (self._dataset_yt(dataset, data)
                  if self._wants_yt(ctf) and len(full) else None)
        data_q8 = (self._dataset_yq8(dataset, data)
                   if self._wants_yq8(ctf) and len(full) else None)
        # the pixel step takes no batch with CTF: those run whole
        whole = self._spmd_pixel and ctf is not None
        shared = self._gen(2 * epoch + 1)
        rows = []
        for i, idx in enumerate(full):
            if whole:
                rows.append(self.train_step(
                    data[idx], ctf=ctf[idx], z_scale=z_scale,
                    generator=shared, at=(epoch, i), replicated=True))
                continue
            if self._rows is not None:
                idx = self._rows(idx)
            rows.append(self.train_step(
                data[idx], y_t=None if data_t is None else data_t[idx],
                y_q8=(None if data_q8 is None
                      else (data_q8[0][idx], data_q8[1])),
                ctf=None if ctf is None else ctf[idx], z_scale=z_scale,
                generator=step_gen, at=(epoch, i)))
        tail_row = None
        if tail is not None:
            tail_row = self._tail_step(data[tail],
                                       None if ctf is None else ctf[tail],
                                       z_scale, step_gen, shared,
                                       (epoch, len(full)))
        return self._epoch_means(rows, tail_row, tail, epoch, n, progress,
                                 progress_stream, t_start)

    def _tail_step(self, y: torch.Tensor, ctf: Optional[torch.Tensor],
                   z_scale: float, step_gen: torch.Generator,
                   shared: torch.Generator, at: tuple) -> torch.Tensor:
        """An epoch's tail batch (the JAX routing, ``trainer.py:837-851``):
        one device's step; under a mesh the data-parallel step when it
        divides over 'data', else the replicated step on every rank with
        the generator all ranks share."""
        if self.mesh is None or (self._spmd and
                                 y.shape[0] % self.mesh.shape["data"] == 0):
            if self._rows is not None:
                y = self._rows(y)
                ctf = None if ctf is None else self._rows(ctf)
            return self.train_step(y, ctf=ctf, z_scale=z_scale,
                                   generator=step_gen, at=at)
        return self.train_step(y, ctf=ctf, z_scale=z_scale,
                               generator=shared, at=at, replicated=True)

    def _stream_epoch(self, dataset, epoch: int, progress: bool,
                      progress_stream) -> Tuple[float, float, float]:
        """``train_epoch`` of a host-resident dataset (JAX
        ``trainer.py:767-827``): the preloaded epoch's permutation (drawn
        on the device from stream 2*epoch, then brought to the host), its
        sorted index batches, step generator and tail, each batch staged
        to the device by ``BatchStager``; no per-dataset copy.  With
        ``progress`` each step prints the running means up to the step
        before it (a line ended by a carriage return).  Under a mesh the
        data-parallel step stages the rank's rows alone; the pixel step,
        which takes no batch without the target copy, trains each batch
        whole on every rank (the replicated step)."""
        t_start = time.perf_counter()
        self._check_ctf(dataset.ctf)
        n, b = len(dataset), self.tcfg.minibatch_size
        z_scale = 0.0 if epoch < self.tcfg.z_delay else 1.0
        perm = torch.randperm(n, generator=self._gen(2 * epoch),
                              device=self.device).cpu()
        full, tail = index_batches(perm, b)
        step_gen = self._step_gen(epoch)
        shared = self._gen(2 * epoch + 1)
        whole = self._spmd_pixel
        if self._spmd:
            full = full[:, self._rows.rows(b)]
        stager = BatchStager((dataset.y, dataset.ctf), b, self.device)
        stream = progress_stream or sys.stderr
        live, prev, rows = StreamingMeans(), None, []
        for i, (y, ctf) in enumerate(stager.batches(full.numpy())):
            aux = self.train_step(y, ctf=ctf, z_scale=z_scale,
                                  generator=shared if whole else step_gen,
                                  at=(epoch, i), replicated=whole)
            rows.append(aux)
            if progress and self._primary and prev is not None:
                live.update(b, *[float(v) for v in prev.cpu()])
                print(live.progress_line(epoch, self.tcfg.num_epochs, n),
                      end="\r", file=stream)
            prev = aux
        tail_row = None
        if tail is not None:
            for y, ctf in stager.batches([tail.numpy()]):
                tail_row = self._tail_step(y, ctf, z_scale, step_gen,
                                           shared, (epoch, len(rows)))
        return self._epoch_means(rows, tail_row, tail, epoch, n, progress,
                                 progress_stream, t_start)

    def _epoch_means(self, rows: list, tail_row, tail, epoch: int, n: int,
                     progress: bool, progress_stream,
                     t_start: float) -> Tuple[float, float, float]:
        """An epoch's (elbo, gen_loss, kl) streaming means from its full
        batches' metrics ``rows`` and the tail's, in one device-to-host
        copy each; the divergence warning, the progress line and the
        epoch's images per second."""
        b = self.tcfg.minibatch_size
        acc = StreamingMeans()
        if rows:
            m = torch.stack(rows).cpu().numpy()
            _warn_nonfinite(m, epoch)
            acc.update_array(m, b)
        if tail_row is not None:
            tm = tail_row.cpu().numpy()
            _warn_nonfinite(tm.reshape(1, -1), epoch, step_base=len(rows))
            acc.update(tail.shape[0], *[float(v) for v in tm])
        if progress and self._primary:
            print(acc.progress_line(epoch, self.tcfg.num_epochs, n),
                  file=progress_stream or sys.stderr)
        dt = time.perf_counter() - t_start
        self.last_images_per_sec = n / dt if dt > 0 else 0.0
        return acc.elbo, acc.gen_loss, acc.kl

    def train_epochs(self, dataset, first_epoch: int,
                     num_epochs: int) -> np.ndarray:
        """``num_epochs`` consecutive epochs from ``first_epoch``, the same
        trajectory as calling ``train_epoch`` for each; returns the
        (num_epochs, 3) per-epoch means.  A host-resident dataset goes
        through ``train_epoch`` one epoch at a time, as in JAX."""
        if num_epochs <= 0:
            return np.zeros((0, 3), np.float64)
        if getattr(dataset, "host_resident", False):
            rows = [self.train_epoch(dataset, e, progress=False)
                    for e in range(first_epoch, first_epoch + num_epochs)]
            return np.asarray(rows, np.float64)
        t_start = time.perf_counter()
        ctf = self._ctf(dataset)
        data = self._data(dataset)
        rows = [self._run_epoch(dataset, data, ctf, e, False, None)
                for e in range(first_epoch, first_epoch + num_epochs)]
        dt = time.perf_counter() - t_start
        self.last_images_per_sec = (num_epochs * data.shape[0] / dt
                                    if dt > 0 else 0.0)
        return np.asarray(rows, np.float64)

    # ----------------------------------------------------------- evaluation
    @torch.no_grad()
    def eval_epoch(self, dataset, epoch: int, *, z_scale: float = 1.0
                   ) -> Tuple[float, float, float]:
        """Batches in order and the tail through the training loss (its
        casts included) without augmentation, under no_grad; the noise from
        stream 1_000_000_007 + epoch.  A host-resident dataset's batches
        are streamed in order (``BatchStager``).  Under a mesh each batch
        runs through ``make_spmd_eval_step`` (its noise drawn for the whole
        batch, each data rank on its rows)."""
        b = self.tcfg.minibatch_size
        if getattr(dataset, "host_resident", False):
            self._check_ctf(dataset.ctf)
            n = len(dataset)
            stager = BatchStager((dataset.y, dataset.ctf), b, self.device)
            batches = stager.batches(np.arange(i, min(i + b, n))
                                     for i in range(0, n, b))
        else:
            ctf = self._ctf(dataset)
            data = self._data(dataset)
            batches = ((data[i:i + b], None if ctf is None else ctf[i:i + b])
                       for i in range(0, data.shape[0], b))
        gen = self._gen(1_000_000_007 + epoch)
        acc = StreamingMeans()
        for y, ctf_b in batches:
            if self._mesh_eval is not None:
                aux = self._mesh_eval(y, ctf_b, gen, z_scale)
                acc.update(y.shape[0], *[float(v) for v in aux.cpu()])
                continue
            _, aux = loss_terms(self.q_net, self.p_net, self._nonstep_ecfg,
                                self.coords, y, generator=gen,
                                z_scale=z_scale, mask=self.mask, ctf=ctf_b,
                                image_shape=self.tcfg.image_shape,
                                compute_dtype=self.compute_dtype)
            acc.update(y.shape[0], *[float(v) for v in aux.cpu()])
        return acc.elbo, acc.gen_loss, acc.kl

    # -------------------------------------------------------- display paths
    @torch.no_grad()
    def reconstruct(self, y: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    z_scale: float = 1.0, *, noise=None) -> torch.Tensor:
        """Posterior-sample reconstruction (B, HW, n_out)."""
        gen = generator if generator is not None else self._gen(7)
        _, _, _, y_hat = elbo_minibatch(
            self.q_net, self.p_net, self._nonstep_ecfg, self.coords,
            y.to(self.device), gen, noise=noise, z_scale=z_scale,
            want_y_hat=True)
        return y_hat

    @torch.no_grad()
    def reconstruct_canonical(self, y: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              z_scale: float = 1.0, *,
                              noise=None) -> torch.Tensor:
        """Pose-stripped reconstruction: the rotation and translation
        latents are dropped before decoding over the untransformed grid (a
        vanilla generator has none)."""
        y = y.to(self.device)
        z_mu, z_logstd = self.q_net(y.reshape(y.shape[0], -1))
        if noise is None:
            gen = generator if generator is not None else self._gen(8)
            noise = torch.randn(z_mu.shape, generator=gen,
                                device=self.device)
        z = torch.exp(z_logstd) * noise + z_mu
        if not self.ecfg.vanilla:
            z = z[:, int(self.ecfg.rotate) + 2 * int(self.ecfg.translate):]
        return decode(self.p_net, self._display_ecfg, self.coords, None,
                      None, z * z_scale)

    @torch.no_grad()
    def sample_prior(self, batch_size: int, z_dim: int,
                     generator: Optional[torch.Generator] = None,
                     z_scale: float = 1.0, *, noise=None) -> torch.Tensor:
        """Decode z ~ N(0, 1) over the canonical grid."""
        if noise is None:
            gen = generator if generator is not None else self._gen(9)
            noise = torch.randn((batch_size, z_dim), generator=gen,
                                device=self.device)
        return decode(self.p_net, self._display_ecfg, self.coords, None,
                      None, noise * z_scale)
