"""Native C++ loader: parity with numpy parsing."""

import pathlib
import subprocess

import numpy as np
import pytest

import moptimizer_jax.native as native

DATA = pathlib.Path(__file__).parent / "data" / "fachada.txt"
NATIVE_DIR = pathlib.Path(native.__file__).parent


def _ensure_built():
    if not native.available():
        subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True)
        import importlib

        importlib.reload(native)
    return native.available()


def test_native_loader_matches_numpy(tmp_path):
    if not _ensure_built():
        pytest.skip("no C++ toolchain available")
    a = native.load_txt_cloud_native(DATA)
    b = np.loadtxt(DATA)[:, :3]
    assert a.shape == b.shape == (29310, 3)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_native_loader_scientific_notation(tmp_path):
    if not _ensure_built():
        pytest.skip("no C++ toolchain available")
    f = tmp_path / "cloud.txt"
    f.write_text("1.5e2 -2.25E-1 +3.0 99 99 99\n-1e-3 0.0 4.75\n")
    a = native.load_txt_cloud_native(f)
    np.testing.assert_allclose(
        a, [[150.0, -0.225, 3.0], [-0.001, 0.0, 4.75]], rtol=1e-12
    )


def test_native_loader_missing_file():
    if not _ensure_built():
        pytest.skip("no C++ toolchain available")
    with pytest.raises(IOError):
        native.load_txt_cloud_native("/nonexistent/file.txt")
