"""Image stack loading — counterpart of ``spatialvae_tpu/io/loaders.py``:
``.mrc``/``.mrcs`` through the MRC codec, ``.npy`` through numpy.

The JAX package decodes the real-valued MRC modes (0 int8, 1 int16, 2
float32, 6 uint16) to float32 with its C++ helper, which its checkout
carries built; the port decodes them with numpy to the same float32 values
(the integers are exact in float32).  Other modes keep their own dtype, as
the JAX codec returns them; a single image is squeezed to 2-D.
"""

from __future__ import annotations

import numpy as np

from spatialvae_torch.io.mrc import read_mrc

# the modes the JAX package's helper decodes to float32
FLOAT_MODES = (0, 1, 2, 6)


def load_images(path: str) -> np.ndarray:
    if path.endswith(("mrc", "mrcs")):
        array, header, _ = read_mrc(path)
        if header.mode in FLOAT_MODES:
            return array.astype(np.float32)
        return array
    if path.endswith("npy"):
        return np.load(path)
    raise ValueError(f"unsupported image stack format: {path}")
