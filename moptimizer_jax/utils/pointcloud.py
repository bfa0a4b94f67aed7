"""Point-cloud IO.

Reads the whitespace `x y z r g b` text format of the reference's LiDAR
fixture (loader at reference tst/point2point.cpp:125-138). Uses the native
C++ fast parser (moptimizer_jax.native) when built, falling back to numpy.
"""

import numpy as np


def load_txt_cloud(path, dtype=np.float64):
    """Load an `x y z [extra...]` text cloud → (N, 3) array."""
    try:
        from moptimizer_jax.native import load_txt_cloud_native

        pts = np.asarray(load_txt_cloud_native(str(path)), dtype=dtype)
    except Exception:
        data = np.loadtxt(str(path), dtype=dtype)
        pts = np.ascontiguousarray(np.atleast_2d(data)[:, :3])
    if pts.shape[0] == 0:
        raise ValueError(f"no points parsed from {path} — not a point-cloud file?")
    return pts
