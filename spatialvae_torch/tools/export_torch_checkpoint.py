"""Convert a checkpoint of the trainers to a reference-format torch
``.sav`` -- the port of ``tools/export_torch_checkpoint.py``:

    python -m spatialvae_torch.tools.export_torch_checkpoint IN.sav OUT.sav

IN.sav is a generator or inference checkpoint written by the port's (or
the JAX package's) trainers; the kind is read from the file.  OUT.sav is a
torch whole-module pickle in the reference's module layout
(``spatial_vae/models.py``), for torch-based analysis kept from the
reference.  The conversion runs on the host and needs no reference
package; loading OUT.sav with ``torch.load`` elsewhere needs it, since the
pickle names its classes, as the reference's own saves do.
"""

from __future__ import annotations

import sys

from spatialvae_torch.checkpoint import load_model_meta
from spatialvae_torch.config import InferenceConfig
from spatialvae_torch.io.reference_sav import (
    export_generator,
    export_inference,
)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    src, dst = argv
    params, cfg, kind, _ = load_model_meta(src)
    if kind == "inference":
        if not isinstance(cfg, InferenceConfig):
            raise ValueError(f"{src}: an inference checkpoint with a "
                             f"{type(cfg).__name__}")
        export_inference(params, cfg, dst)
    else:
        export_generator(params, cfg, dst)
    print(f"# wrote {kind} torch module to {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
