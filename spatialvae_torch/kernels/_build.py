"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``
(a measurement copy may be built from a few of the sources, with ``-D``
switches of their own).  The build runs at first use (never at import: the CPU tests import every module
on a machine without ``nvcc``).  The library lands in ``kernels/_build/``
keyed by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one loads the cached file.  A failed build raises
with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name -> (argtypes, restype) of every C entry point the wrappers call
_SIGNATURES = {
    "svt_adam": ([_P] * 6 + [_L] + [_I] * 2 + [_F] * 8 + [_P], _I),
    "svt_adam_emit": ([_P] * 8 + [_L] + [_I] * 2 + [_F] * 8 + [_P], _I),
    "svt_quant_scale": ([_P] * 4, _I),
    "svt_quantize": ([_P, _I, _P], _I),
    "svt_adam_step": ([_P, _I, _P] + [_I] * 3 + [_F] * 8 + [_P], _I),
    "svt_adam_step_info": ([_I] * 3 + [_P], _I),
    "svt_fused_decoder_fwd": ([_P] * 8 + [_L, _P] + [_I] * 8 + [_P], _I),
    "svt_fused_decoder_ws_block": ([_I], _L),
    "svt_cuda_error_string": ([_I], ctypes.c_char_p),
    "svt_fused_decoder_bwd_chain": (
        [_P] * 5 + [_L] + [_P] * 6 + [_I] * 8 + [_P], _I),
    "svt_fused_decoder_bwd_dw": ([_P] * 3 + [_L] + [_P] * 2 + [_I] * 6
                                 + [_P], _I),
    "svt_fused_decoder_bwd_kchunk": ([], _I),
    "svt_sum_rows": ([_P, _P, _I, _L, _I, _L, _P], _I),
    "svt_decoder90_fwd": ([_P] * 8 + [_I] * 8 + [_P], _I),
    "svt_decoder90_chain": ([_P] * 11 + [_I] * 8 + [_P], _I),
    "svt_decoder90_dw": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "svt_decoder90_ws_block": ([_I], _L),
    "svt_decoder90_max_clusters": ([_I], _I),
    "svt_decoder90_layer": ([_P] * 10 + [_I] * 8 + [_P], _I),
    "svt_decoder90_chain_layer": ([_P] * 14 + [_I] * 9 + [_P], _I),
    "svt_decoder90_dw_deep": ([_P] * 3 + [_I] * 3 + [_L, _I, _P], _I),
    "svt_decoder90_deep_ws_block": ([_I, _I], _L),
    "svt_decoder90_deep_max_clusters": ([_I], _I),
    "svt_int8_ws_block": ([_I], _L),
    "svt_int8_decoder_fwd": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "svt_int8_decoder_bwd_scale": ([_P] * 11 + [_I] * 5 + [_P], _I),
    "svt_int8_decoder_bwd_grad": ([_P] * 17 + [_I] * 7 + [_P], _I),
    "svt_int8_grouped_dw": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "svt_int8_90_fwd": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "svt_int8_90_scale": ([_P] * 11 + [_I] * 6 + [_P], _I),
    "svt_int8_90_grad": ([_P] * 15 + [_I] * 7 + [_P], _I),
    "svt_int8_90_stash_block": ([], _L),
    "svt_int8_90_max_clusters": ([_I], _I),
    "svt_int8_90w_fwd": ([_P] * 10 + [_I] * 6 + [_P], _I),
    "svt_int8_90w_scale": ([_P] * 12 + [_I] * 7 + [_P], _I),
    "svt_int8_90w_grad": ([_P] * 16 + [_I] * 8 + [_P], _I),
    "svt_int8_90w_rows": ([_I], _I),
    "svt_int8_90w_slot_bytes": ([_I], _L),
    "svt_int8_90w_max_clusters": ([_I], _I),
    "svt_loss_int8_fwd": ([_P] * 14 + [_I] * 10 + [_F, _F, _I, _I, _P],
                          _I),
    "svt_loss_int8_grad": ([_P] * 17 + [_I] * 8 + [_F, _F, _I, _F, _F, _I,
                                                    _I, _P], _I),
    "svt_loss90_dw": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "svt_loss90_max_clusters": ([_I], _I),
    "svt_sm90_tile_product": ([_P] * 3 + [_I] * 2 + [_P], _I),
    "svt_loss90_chain_check": ([_P, _P], _I),
    "svt_loss90_ws_block": ([_I, _I], _L),
    "svt_philox4x32_10": ([_P, _P, _I, ctypes.c_uint, ctypes.c_uint, _P],
                          _I),
    "svt_probe_gemm": ([_P] * 5 + [_I] * 10 + [_P], _I),
    "svt_probe_gemm_name": ([_I] * 4, ctypes.c_char_p),
    "svt_probe_pack_s4": ([_P, _P] + [_I] * 3 + [_P], _I),
    "svt_probe_build_t": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "svt_probe_transpose_sum": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "svt_kb_chain": ([_I] + [_P] * 12 + [_I] * 5 + [_P], _I),
    "svt_kb_fwd_pipe": ([_I] + [_P] * 10 + [_I] * 6 + [_P], _I),
    "svt_kb_gemm_multi": ([_I] + [_P] * 8 + [_I, _P] + [_I] * 2 + [_P], _I),
    "svt_kb_rows_sum": ([_P] * 2 + [_I] * 3 + [_P], _I),
    "svt_kb_plain_scale": ([_P] * 10 + [_I] * 4 + [_P], _I),
    "svt_kb_plain_grad": ([_P] * 16 + [_I] * 6 + [_P], _I),
    "svt_kb_fix_grad": ([_P] * 13 + [_I] * 6 + [_P], _I),
}


def sources(units: Optional[tuple] = None) -> list:
    """The library's ``.cu`` files: every one, or those named in
    ``units``."""
    if units is None:
        return sorted(CSRC.glob("*.cu"))
    return sorted(CSRC / u for u in units)


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(defines: tuple = (), units: Optional[tuple] = None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in sources(units) + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"svt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with the first failure's stderr."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed is not None:
        cmd, rc, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")


def build(defines: tuple = (), units: Optional[tuple] = None) -> Path:
    """Compile the sources unless the library for their hash exists.
    ``defines`` are extra ``-D`` flags: a copy with a precision step
    removed, for placing the kernels' error limits (``csrc/decoder_tile.cuh``,
    ``csrc/int8_tile.cuh`` and ``csrc/probes.cu`` list them), or a timing
    copy (``csrc/fused_decoder_int8_sm90.cuh``,
    ``csrc/fused_loss_int8_sm90.cuh``); ``units`` the sources of a partial
    library (default: all)."""
    out = library_path(defines, units)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to private names, then the library is
    # renamed: concurrent builds never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources(units):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        _run(procs)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)
    return out


@functools.cache
def load_library(defines: tuple = (), units: Optional[tuple] = None
                 ) -> ctypes.CDLL:
    """The built kernel library with every entry point's C signature set (a
    partial library's own entry points only)."""
    lib = ctypes.CDLL(str(build(defines, units)))
    for name, (argtypes, restype) in _SIGNATURES.items():
        if units is not None and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
