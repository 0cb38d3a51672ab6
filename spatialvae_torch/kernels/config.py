"""The numerics knobs of the int8 kernels and of Adam: one resolved config.

The JAX package (``spatialvae_tpu/kernels/config.py``) reads eleven
environment variables that change what its kernels compute (its
``NUMERICS_FIELDS``), each with a validated default, into one frozen
``KernelConfig``; its trainer refuses any value off a default unless
``SPATIALVAE_ALLOW_KNOBS=1``.  The port reads the same eleven variables
into one frozen ``Numerics`` (``Numerics.from_env``), which every call site
reads through ``numerics()``:

- ``SPATIALVAE_INT4_GRADS`` (``grad_mode``: ``i4dw1`` by default, ``i4fwd``,
  ``da0_i4``, ``i8``), ``SPATIALVAE_GSCALE`` (``bound`` or ``tile``; the
  loss kernel takes ``tile`` for ``i8`` and ``da0_i4`` whatever it says),
  ``SPATIALVAE_EPI`` (``bf16`` or ``f32``) and ``SPATIALVAE_SR`` (stochastic
  rounding when ``1``): the fused int8 loss kernel K3, implemented at every
  value (ROADMAP Queue 2 K3 (e), (f));
- ``SPATIALVAE_LOSS_LAYOUT`` (``row`` or ``t``) and
  ``SPATIALVAE_INT4_GRADS_T`` (``i4`` or ``i8``): ``t`` routes the Bernoulli
  steps without a mask and with float targets to the feature-major loss
  kernel K8 (``kernels/fused_loss_int8_t.py``), as in JAX;
- ``SPATIALVAE_ADAM_EMIT`` (``xla`` or ``pallas``): how Adam emits the int8
  copies of the big encoder weights (``pallas`` is K7);
- ``SPATIALVAE_TANH`` (``exact`` or ``pade``), ``SPATIALVAE_A1Q``,
  ``SPATIALVAE_DB1`` (``chain`` or ``qi``) and ``SPATIALVAE_PHASE_CUT``
  (8): the JAX package's measurement levers of K3 (its K3 (g)), run as
  modes of K3's two passes (``k3_a1q`` and ``k3_db1_qi`` say where JAX's
  kernel reads the last two; the feature-major kernel K8 reads none).

``numerics()`` raises ``ValueError`` on a value JAX would reject or on a
phase cut below 3, where the JAX kernel fails at trace time (phase 3 sets
the loss), and ``RuntimeError`` on any value off its default unless
``SPATIALVAE_ALLOW_KNOBS=1`` (JAX's ``check_numerics_default``).
``Trainer`` checks at every construction, as the JAX trainer does, and the
kernel wrappers resolve their numerics through it at every call, so no
wrapper ever runs other numerics than asked for.  The JAX package's
Mosaic/VMEM knobs shape the TPU schedule only and have no counterpart here.

``SPATIALVAE_ADAM_MOMENTS`` (``f32`` by default, or ``bf16``) sets the Adam
moments' storage dtype; the JAX package reads any other value as ``f32``,
the port refuses it.  ``SPATIALVAE_PALLAS_ADAM`` only schedules the TPU's
per-leaf kernel against XLA's fusion there (same numbers either way); the
port runs K6 on the card whatever it says, and reads it nowhere.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, fields

import torch

GRAD_MODES = ("i8", "da0_i4", "i4fwd", "i4dw1")
ADAM_EMITS = ("xla", "pallas")
_MOMENTS = {"f32": torch.float32, "bf16": torch.bfloat16}
# phases of the JAX kernel (`_Phases` p1..p8); a cut keeps 1..phase_cut
PHASES = 8


def _choice(name: str, default: str, choices) -> str:
    v = os.environ.get(name, default)
    if v not in choices:
        raise ValueError(f"{name} must be one of {sorted(choices)}, got {v!r}")
    return v


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") == "1"


def _int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}")


@dataclass(frozen=True)
class Numerics:
    """The JAX ``KernelConfig``'s numerics fields; defaults are its."""

    grad_mode: str = "i4dw1"
    gscale: str = "bound"
    epi: str = "bf16"
    tanh: str = "exact"
    sr: bool = False
    a1q: bool = False
    db1: str = "chain"
    phase_cut: int = 8
    layout: str = "row"
    grad_mode_t: str = "i4"
    adam_emit: str = "xla"

    @classmethod
    def from_env(cls) -> "Numerics":
        """Every field from its variable, as the JAX ``from_env`` reads it;
        ``ValueError`` on a value it would reject."""
        return cls(
            grad_mode=_choice("SPATIALVAE_INT4_GRADS", cls.grad_mode,
                              GRAD_MODES),
            gscale=_choice("SPATIALVAE_GSCALE", cls.gscale, ("tile", "bound")),
            epi=_choice("SPATIALVAE_EPI", cls.epi, ("bf16", "f32")),
            tanh=_choice("SPATIALVAE_TANH", cls.tanh, ("exact", "pade")),
            sr=_flag("SPATIALVAE_SR"),
            a1q=_flag("SPATIALVAE_A1Q"),
            db1=_choice("SPATIALVAE_DB1", cls.db1, ("chain", "qi")),
            phase_cut=_int("SPATIALVAE_PHASE_CUT", cls.phase_cut),
            layout=_choice("SPATIALVAE_LOSS_LAYOUT", cls.layout, ("row", "t")),
            grad_mode_t=_choice("SPATIALVAE_INT4_GRADS_T", cls.grad_mode_t,
                                ("i8", "i4")),
            adam_emit=_choice("SPATIALVAE_ADAM_EMIT", cls.adam_emit,
                              ADAM_EMITS))

    def drift(self) -> list:
        """The fields off their defaults."""
        return [f.name for f in fields(self)
                if getattr(self, f.name) != f.default]

    def check(self) -> "Numerics":
        """Raise ``ValueError`` on a phase cut below 3: the JAX kernel fails
        at trace time there (the loss is set by phase 3), so the port gives
        no value either; returns self."""
        if self.phase_cut < 3:
            raise ValueError(
                f"SPATIALVAE_PHASE_CUT={self.phase_cut}: the loss kernel "
                f"needs phases 1..3 for its loss (the JAX kernel fails at "
                f"trace time below 3)")
        return self

    # ---- what K3 computes under these numerics (the JAX _lossgrad_pallas)
    @property
    def k3_gscale(self) -> str:
        """The gradient scale K3 takes: ``bound`` needs the 4-bit forward,
        so ``i8`` and ``da0_i4`` take ``tile``."""
        return self.gscale if self.grad_mode in ("i4fwd", "i4dw1") else "tile"

    @property
    def fwd_level(self) -> int:
        """a0's quantisation level: 7 (4-bit forward, per-column 4-bit W1)
        or 127 (int8 forward, per-tensor int8 W1)."""
        return 7 if self.grad_mode in ("i4fwd", "i4dw1") else 127

    @property
    def grad_level(self) -> int:
        """The gradient tile's level: 127 for ``i8``, else 7."""
        return 127 if self.grad_mode == "i8" else 7

    @property
    def k3_a1q(self) -> bool:
        """Whether K3 runs the int8 a1 (``SPATIALVAE_A1Q``): JAX wires it for
        the bound scale and the bf16 epilogue only, and turns it off
        silently elsewhere."""
        return self.a1q and self.k3_gscale == "bound" and self.epi != "f32"

    @property
    def k3_db1_qi(self) -> bool:
        """Whether K3's db1 sums the rounded gradient tile
        (``SPATIALVAE_DB1=qi``): read by the bound scale's chain alone."""
        return self.db1 == "qi" and self.k3_gscale == "bound"

    @property
    def k3_cut(self) -> int:
        """The last phase K3 runs (``SPATIALVAE_PHASE_CUT``, 3..8)."""
        return min(self.phase_cut, PHASES)


def numerics() -> Numerics:
    """The environment's numerics, checked: ``ValueError`` on a value JAX
    would reject or a phase cut below 3, ``RuntimeError`` on a value off
    its default unless ``SPATIALVAE_ALLOW_KNOBS=1``."""
    n = Numerics.from_env()
    drift = n.drift()
    if drift and os.environ.get("SPATIALVAE_ALLOW_KNOBS") != "1":
        raise RuntimeError(
            f"numerics-changing kernel knob(s) off their validated default: "
            f"{drift}; unset them, or set SPATIALVAE_ALLOW_KNOBS=1 to accept "
            f"off-default numerics")
    return n.check()


def check_knobs() -> None:
    """``numerics()`` for its checks alone (``Trainer`` at construction)."""
    numerics()


@contextlib.contextmanager
def knobs_allowed():
    """Within the block off-default numerics knobs are allowed (the JAX
    package's ``allow_knobs``, which sets it for the whole process): for
    measurement entry points while they run; the caller's setting is
    restored after."""
    saved = os.environ.get("SPATIALVAE_ALLOW_KNOBS")
    os.environ["SPATIALVAE_ALLOW_KNOBS"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["SPATIALVAE_ALLOW_KNOBS"]
        else:
            os.environ["SPATIALVAE_ALLOW_KNOBS"] = saved


def adam_emit() -> str:
    """``SPATIALVAE_ADAM_EMIT``: ``xla`` (default) or ``pallas``; raises
    ``ValueError`` on another value, and ``RuntimeError`` on ``pallas``
    unless ``SPATIALVAE_ALLOW_KNOBS=1``."""
    v = Numerics.from_env().adam_emit
    if v != ADAM_EMITS[0] and os.environ.get("SPATIALVAE_ALLOW_KNOBS") != "1":
        raise RuntimeError(
            f"SPATIALVAE_ADAM_EMIT={v!r} changes the training numerics (a "
            f"one-step-stale quantisation scale); set "
            f"SPATIALVAE_ALLOW_KNOBS=1 to accept off-default numerics")
    return v


def moments_dtype() -> torch.dtype:
    """``SPATIALVAE_ADAM_MOMENTS``: float32 (``f32``, default) or bfloat16
    (``bf16``) Adam moments; raises ``ValueError`` on another value."""
    v = os.environ.get("SPATIALVAE_ADAM_MOMENTS", "f32")
    if v not in _MOMENTS:
        raise ValueError(f"SPATIALVAE_ADAM_MOMENTS must be one of "
                         f"{sorted(_MOMENTS)}, got {v!r}")
    return _MOMENTS[v]
