"""MRC2000 codec — counterpart of ``spatialvae_tpu/io/mrc.py``.

Parses the 1,024-byte MRC2000 header (with the IMOD extensions) and its
extended header, decodes the data modes of cryo-EM stacks (0 int8, 1
int16, 2 float32, 3 complex int16, 4 complex64, 6 uint16, 16 RGB) and
writes arrays back out, byte for byte as the JAX package writes them.
Numpy only: the JAX package's optional C++ decoder is not ported (numpy
serves).  ``mode_for_dtype`` raises ``ValueError`` on a dtype MRC cannot
hold, and an unknown mode raises ``ValueError``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, fields
from typing import Optional, Tuple

import numpy as np

# (word) name : struct-format — MRC2000 + IMOD extensions, 1024 bytes total
_FIELDS = [
    ("nx", "i"), ("ny", "i"), ("nz", "i"),
    ("mode", "i"),
    ("nxstart", "i"), ("nystart", "i"), ("nzstart", "i"),
    ("mx", "i"), ("my", "i"), ("mz", "i"),
    ("xlen", "f"), ("ylen", "f"), ("zlen", "f"),
    ("alpha", "f"), ("beta", "f"), ("gamma", "f"),
    ("mapc", "i"), ("mapr", "i"), ("maps", "i"),
    ("amin", "f"), ("amax", "f"), ("amean", "f"),
    ("ispg", "i"), ("next", "i"), ("creatid", "h"),
    ("_pad1", "30x"),
    ("nint", "h"), ("nreal", "h"),
    ("_pad2", "20x"),
    ("imodStamp", "i"), ("imodFlags", "i"),
    ("idtype", "h"), ("lens", "h"),
    ("nd1", "h"), ("nd2", "h"), ("vd1", "h"), ("vd2", "h"),
    ("tilt_ox", "f"), ("tilt_oy", "f"), ("tilt_oz", "f"),
    ("tilt_cx", "f"), ("tilt_cy", "f"), ("tilt_cz", "f"),
    ("xorg", "f"), ("yorg", "f"), ("zorg", "f"),
    ("cmap", "4s"), ("stamp", "4s"),
    ("rms", "f"),
    ("nlabl", "i"), ("labels", "800s"),
]

_STRUCT = struct.Struct("".join(code for _, code in _FIELDS))
_NAMES = [name for name, code in _FIELDS if "x" not in code or code[-1] != "x"]

# data modes: MRC mode id -> numpy dtype
_MODE_DTYPES = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    3: np.dtype("2h"),          # complex as 2 shorts
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    16: np.dtype("3B"),         # RGB
}


@dataclass
class MrcHeader:
    nx: int = 0
    ny: int = 0
    nz: int = 0
    mode: int = 2
    nxstart: int = 0
    nystart: int = 0
    nzstart: int = 0
    mx: int = 1
    my: int = 1
    mz: int = 1
    xlen: float = 0.0
    ylen: float = 0.0
    zlen: float = 0.0
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0
    mapc: int = 1
    mapr: int = 2
    maps: int = 3
    amin: float = 0.0
    amax: float = 0.0
    amean: float = 0.0
    ispg: int = 0
    next: int = 0
    creatid: int = 0
    nint: int = 0
    nreal: int = 0
    imodStamp: int = 0
    imodFlags: int = 0
    idtype: int = 0
    lens: int = 0
    nd1: int = 0
    nd2: int = 0
    vd1: int = 0
    vd2: int = 0
    tilt_ox: float = 0.0
    tilt_oy: float = 0.0
    tilt_oz: float = 0.0
    tilt_cx: float = 0.0
    tilt_cy: float = 0.0
    tilt_cz: float = 0.0
    xorg: float = 0.0
    yorg: float = 0.0
    zorg: float = 0.0
    cmap: bytes = b"\x00" * 4
    stamp: bytes = b"\x00" * 4
    rms: float = 0.0
    nlabl: int = 0
    labels: bytes = field(default=b"\x00" * 800, repr=False)

    def pack(self) -> bytes:
        return _STRUCT.pack(*(getattr(self, f.name) for f in fields(self)))

    @classmethod
    def unpack(cls, buf: bytes) -> "MrcHeader":
        values = _STRUCT.unpack(buf[:1024])
        return cls(**dict(zip([f.name for f in fields(cls)], values)))


def mode_for_dtype(dtype) -> int:
    dtype = np.dtype(dtype)
    for mode, dt in _MODE_DTYPES.items():
        if dt == dtype:
            return mode
    raise ValueError(f"MRC incompatible dtype: {dtype}")


def parse_mrc(content: bytes) -> Tuple[np.ndarray, MrcHeader, bytes]:
    """Decode an in-memory MRC file.

    Returns (array, header, extended_header); nz==1 stacks are squeezed to
    2-D, matching the reference loader's expectations (mrc.py:136-138).
    """
    header = MrcHeader.unpack(content)
    start = 1024 + header.next
    extended = content[1024:start]
    try:
        dtype = _MODE_DTYPES[header.mode]
    except KeyError:
        raise ValueError(f"unsupported MRC mode {header.mode}") from None
    count = header.nz * header.ny * header.nx
    array = np.frombuffer(content, dtype=dtype, count=count, offset=start)
    array = array.reshape(header.nz, header.ny, header.nx)
    if header.nz == 1:
        array = array[0]
    return array, header, extended


def read_mrc(path: str) -> Tuple[np.ndarray, MrcHeader, bytes]:
    with open(path, "rb") as f:
        return parse_mrc(f.read())


def make_header(shape, cella=(1.0, 1.0, 1.0), cellb=(0.0, 0.0, 0.0),
                mz: int = 1, dtype=np.float32, dmin=0.0, dmax=-1.0,
                dmean=-2.0, rms=-1.0, exthd_size: int = 0, ispg: int = 0
                ) -> MrcHeader:
    return MrcHeader(
        nx=shape[2], ny=shape[1], nz=shape[0],
        mode=mode_for_dtype(dtype),
        mx=1, my=1, mz=mz,
        xlen=cella[0], ylen=cella[1], zlen=cella[2],
        alpha=cellb[0], beta=cellb[1], gamma=cellb[2],
        amin=dmin, amax=dmax, amean=dmean,
        ispg=ispg, next=exthd_size, rms=rms,
    )


def write_mrc(f, array: np.ndarray, header: Optional[MrcHeader] = None,
              extended_header: bytes = b"", ax=1.0, ay=1.0, az=1.0,
              alpha=0.0, beta=0.0, gamma=0.0) -> None:
    """Write an (nz, ny, nx) array; a default float32 header is synthesised
    with data statistics when none is given (mrc.py:188-218 behaviour)."""
    if header is None:
        header = MrcHeader(
            nx=array.shape[2], ny=array.shape[1], nz=array.shape[0],
            mode=2,
            xlen=ax, ylen=ay, zlen=az,
            alpha=alpha, beta=beta, gamma=gamma,
            amin=float(array.min()), amax=float(array.max()),
            amean=float(array.mean()),
            next=len(extended_header),
            rms=float(array.std()),
        )
    f.write(header.pack())
    f.write(extended_header)
    f.write(array.tobytes())
