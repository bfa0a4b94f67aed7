"""Native (C++) runtime components, loaded via ctypes.

Build with `make -C moptimizer_jax/native` (or the repo Makefile). If the
shared library is absent, importers fall back to pure-Python paths
(utils.pointcloud falls back to numpy).
"""

import ctypes
import pathlib

import numpy as np

_HERE = pathlib.Path(__file__).parent
_LIB_PATH = _HERE / "libmoptimizer_native.so"

_lib = None
if _LIB_PATH.exists():
    _lib = ctypes.CDLL(str(_LIB_PATH))
    _lib.moptimizer_load_txt_cloud.restype = ctypes.POINTER(ctypes.c_double)
    _lib.moptimizer_load_txt_cloud.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib.moptimizer_free.restype = None
    _lib.moptimizer_free.argtypes = [ctypes.POINTER(ctypes.c_double)]


def available():
    return _lib is not None


def load_txt_cloud_native(path):
    """(N, 3) float64 array parsed by the native loader."""
    if _lib is None:
        raise RuntimeError(
            "native library not built; run `make -C moptimizer_jax/native`"
        )
    n = ctypes.c_int64(0)
    ptr = _lib.moptimizer_load_txt_cloud(str(path).encode(), ctypes.byref(n))
    if not ptr:
        raise IOError(f"native loader failed for {path}")
    try:
        out = np.ctypeslib.as_array(ptr, shape=(n.value, 3)).copy()
    finally:
        _lib.moptimizer_free(ptr)
    return out
