"""PNG image-grid writer — counterpart of ``spatialvae_tpu/io/png.py``.

The grid geometry of the reference's image dumps
(``torchvision.utils.save_image(images, nrow=floor(sqrt(B)), padding=3,
pad_value=0.5)``), so a grid written by either package decodes to the same
pixels:

- cells row-major, ``xmaps = min(nrow, B)`` columns, ``ymaps = ceil(B /
  xmaps)`` rows, unused cells left at the pad value;
- a ``padding``-pixel border around every cell, filled with ``pad_value``;
- quantisation ``uint8 = clip(x * 255 + 0.5, 0, 255)``, truncated, in
  float32.

The file is written with ``zlib`` and ``struct`` alone (8-bit grayscale for
one channel, 8-bit RGB for three; filter 0 on every row), so the port needs
no PIL.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}          # channels -> grayscale, RGB


def grid_uint8(data, image_dims, nrow: int | None = None, padding: int = 3,
               pad_value: float = 0.5) -> np.ndarray:
    """data: (B, HW*C) or (B, HW, C), a numpy array or a tensor on any
    device; image_dims: (n, m).  Returns the (H, W, C) uint8 grid."""
    if isinstance(data, torch.Tensor):
        data = data.detach().to("cpu", torch.float32).numpy()
    data = np.asarray(data, dtype=np.float32)
    b = data.shape[0]
    n, m = image_dims
    imgs = data.reshape(b, n, m, -1)                  # (B, n, m, C)
    c = imgs.shape[-1]
    if nrow is None:
        nrow = int(b ** 0.5)
    xmaps = min(nrow, b)
    ymaps = int(math.ceil(b / xmaps))
    cell_h, cell_w = n + padding, m + padding
    cells = np.full((ymaps * xmaps, cell_h, cell_w, c), pad_value,
                    dtype=np.float32)
    cells[:b, padding:, padding:] = imgs
    grid = np.full((cell_h * ymaps + padding, cell_w * xmaps + padding, c),
                   pad_value, dtype=np.float32)
    grid[:cell_h * ymaps, :cell_w * xmaps] = (
        cells.reshape(ymaps, xmaps, cell_h, cell_w, c)
        .transpose(0, 2, 1, 3, 4).reshape(ymaps * cell_h, xmaps * cell_w, c))
    return np.clip(grid * np.float32(255.0) + np.float32(0.5), 0,
                   255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray) -> bytes:
    """(H, W, C) uint8, C 1 or 3, as a PNG file's bytes."""
    h, w, c = pixels.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"a PNG grid takes 1 or 3 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(pixels).reshape(h, w * c)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def save_image_grid(data, output: str, image_dims, nrow: int | None = None,
                    padding: int = 3, pad_value: float = 0.5) -> None:
    """Write ``grid_uint8(data, ...)`` as a PNG at ``output``."""
    pixels = grid_uint8(data, image_dims, nrow, padding, pad_value)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    with open(output, "wb") as f:
        f.write(png_bytes(pixels))


def read_png(path: str) -> np.ndarray:
    """The (H, W, C) uint8 pixels of a PNG that ``png_bytes`` wrote (8-bit
    grayscale or RGB, not interlaced, every row filter 0); raises on a bad
    signature, a chunk whose CRC does not match, or another layout."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG signature")
    pos, header, idat = 8, None, b""
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", blob[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    c = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or c is None or interlace:
        raise ValueError(f"{path}: IHDR {header} is not an 8-bit gray/RGB "
                         f"grid")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, c)
