"""Contrast transfer function physics for cryo-EM particles — counterpart
of ``spatialvae_tpu/ctf/physics.py``, in numpy on the host.

The weak-phase CTF model: the electron wavelength from the accelerating
voltage (relativistically corrected), astigmatic defocus, spherical
aberration and amplitude contrast, with an optional B-factor envelope.  The
per-particle real-space kernels are built once on the host and go to the
device with the dataset; ``ctf/apply.py`` applies them per batch.

Kept as the JAX package has them, since they set the ELBO:
- the table's ``dfdiff`` column is read but not used: defocus * 10,000 is
  both defocus axes;
- the caller makes the kernel's dims odd (the particles CLI);
  ``ctf_filter`` takes n, m as given.

``parse_ctf`` reads the table with ``np.loadtxt`` (the JAX package uses
pandas, which the card's machine lacks) into ``CtfParams``: the eight
columns by name, in the JAX package's order, as float64 arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

COLUMNS = ("defocus", "cs", "voltage", "apix", "bfactor", "ampcont",
           "dfdiff", "dfang")


def compute_2d_ctf(freqs: np.ndarray, dfu: float, dfv: float, dfang: float,
                   volt: float, cs: float, w: float,
                   bfactor: float | None = None) -> np.ndarray:
    """CTF value at each spatial frequency.

    freqs: (K, 2) cycles/Angstrom; dfu/dfv: defocus (Angstrom) along the
    major/minor axes; dfang: astigmatism angle (radians); volt: kV; cs:
    spherical aberration (mm); w: amplitude contrast fraction.
    """
    volt = volt * 1000.0                       # kV -> V
    cs = cs * 1e7                              # mm -> Angstrom
    # relativistic electron wavelength (Angstrom)
    lam = 12.2639 / np.sqrt(volt + 0.97845e-6 * volt ** 2)

    fx, fy = freqs[:, 0], freqs[:, 1]
    ang = np.arctan2(fy, fx)
    s2 = fx ** 2 + fy ** 2
    df = 0.5 * (dfu + dfv + (dfu - dfv) * np.cos(2.0 * (ang - dfang)))
    gamma = 2.0 * np.pi * (-0.5 * df * lam * s2
                           + 0.25 * cs * lam ** 3 * s2 ** 2)
    ctf = np.sqrt(1.0 - w ** 2) * np.sin(gamma) - w * np.cos(gamma)
    if bfactor is not None:
        ctf = ctf * np.exp(-bfactor / 4.0 * s2)
    return ctf.astype(freqs.dtype)


@dataclass
class CtfParams:
    """The CTF table, one float64 array per column, one row per particle."""

    defocus: np.ndarray
    cs: np.ndarray
    voltage: np.ndarray
    apix: np.ndarray
    bfactor: np.ndarray
    ampcont: np.ndarray
    dfdiff: np.ndarray
    dfang: np.ndarray

    def __len__(self) -> int:
        return len(self.defocus)

    @property
    def columns(self) -> list:
        return [f.name for f in fields(self)]


def parse_ctf(path) -> CtfParams:
    """Parse a whitespace-separated CTF table without a header, columns
    defocus cs voltage apix bfactor ampcont dfdiff dfang."""
    table = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if table.shape[1] != len(COLUMNS):
        raise ValueError(f"{path}: {table.shape[1]} columns, expected "
                         f"{len(COLUMNS)} ({' '.join(COLUMNS)})")
    return CtfParams(*(table[:, i].copy() for i in range(len(COLUMNS))))


def ctf_filter(ctf_params, n: int, m: int, scale: float = 1.0) -> np.ndarray:
    """Per-particle real-space CTF kernels, shape (N, n, m) float32:
    kernel_i = -fftshift(ifft2(CTF_i)).real over the fftfreq grid scaled by
    each particle's pixel size."""
    fi = np.fft.fftfreq(n)
    fj = np.fft.fftfreq(m)
    fi, fj = np.meshgrid(fi, fj, indexing="ij")
    freqs = np.stack([fi.ravel(), fj.ravel()], axis=1)

    out = np.zeros((len(ctf_params), n, m), dtype=np.float32)
    for i in range(len(ctf_params)):
        apix = ctf_params.apix[i] * scale
        c = compute_2d_ctf(
            freqs / apix,
            ctf_params.defocus[i] * 10000.0,   # dfu
            ctf_params.defocus[i] * 10000.0,   # dfv: dfdiff not used
            2.0 * np.pi * ctf_params.dfang[i] / 360.0,
            ctf_params.voltage[i],
            ctf_params.cs[i],
            ctf_params.ampcont[i] / 100.0,
            ctf_params.bfactor[i],
        ).reshape(n, m)
        out[i] = -np.fft.fftshift(np.fft.ifft2(c)).real
    return out
