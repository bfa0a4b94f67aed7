"""Cross-check our LM solver against SciPy's independent implementation.

The reference keeps Ceres comparison programs in experimental/
(ceres_helloworld.cpp, ceres_camera_calibration.cpp — run by hand on the
same datasets as the tests) and pins a ceres_solution vector inside the
camera-calibration test (tst/camera_calibration.cpp:97-98). This script is
the same idea with SciPy as the external oracle: run
scipy.optimize.least_squares (its own trust-region LM, 'lm' → MINPACK) on
the reference workloads and diff the minima against ours.

Run: python examples/cross_check_scipy.py   (CPU, f64, a few seconds)
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import scipy.optimize

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from moptimizer_jax import LMConfig, levenberg_marquardt  # noqa: E402
from moptimizer_jax.core.residual import make_block, problem  # noqa: E402
from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA  # noqa: E402
from moptimizer_jax.models.powell import powell_block  # noqa: E402


def check(name, ours, scipys, tol):
    diff = float(np.max(np.abs(np.asarray(ours) - np.asarray(scipys))))
    flag = "OK " if diff < tol else "FAIL"
    print(f"[{flag}] {name}: ours={np.asarray(ours)} scipy={np.asarray(scipys)} "
          f"max|Δ|={diff:.2e} (tol {tol:g})")
    return diff < tol


def curve_fitting():
    """Exponential fit on the 67-observation Ceres dataset
    (reference tst/curve_fitting.cpp:9-79)."""
    data = np.asarray(CERES_CURVE_DATA, dtype=np.float64)

    blk = make_block(
        lambda x, d: jnp.array([d[1] - jnp.exp(x[0] * d[0] + x[1])]),
        data=jnp.asarray(data),
    )
    res = levenberg_marquardt(problem(blk), jnp.zeros(2), LMConfig())

    sp = scipy.optimize.least_squares(
        lambda x: data[:, 1] - np.exp(x[0] * data[:, 0] + x[1]),
        np.zeros(2),
        method="lm",
    )
    return check("curve fitting", res.x, sp.x, 1e-6)


def powell():
    """Powell's singular function (reference tst/powell.cpp:21-82: x0 =
    (3, −1, 0, 4), 25 iterations, minimum 0 ± 5e-5)."""
    res = levenberg_marquardt(
        problem(powell_block()),
        jnp.asarray([3.0, -1.0, 0.0, 4.0]),
        LMConfig(max_iterations=25),
    )

    def f(x):
        return np.array(
            [
                x[0] + 10.0 * x[1],
                np.sqrt(5.0) * (x[2] - x[3]),
                (x[1] - 2.0 * x[2]) ** 2,
                np.sqrt(10.0) * (x[0] - x[3]) ** 2,
            ]
        )

    sp = scipy.optimize.least_squares(
        f, np.array([3.0, -1.0, 0.0, 4.0]), method="lm", xtol=1e-15, ftol=1e-15
    )
    # both converge toward the singular minimum at 0 — compare to 0, the
    # known analytic answer, at each solver's own achievable tolerance
    ok1 = check("powell (ours vs 0)", res.x, np.zeros(4), 5e-5)
    ok2 = check("powell (scipy vs 0)", sp.x, np.zeros(4), 5e-3)
    return ok1 and ok2


def rational():
    """The rational model on the 7-point dataset of reference
    tst/simple_model.cpp:24-25 (minimum ≈ (0.362, 0.556))."""
    from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block

    x_data = np.asarray(SIMPLE_X)
    y_data = np.asarray(SIMPLE_Y)

    res = levenberg_marquardt(
        problem(rational_block(SIMPLE_X, SIMPLE_Y)),
        jnp.asarray([0.9, 0.8]),
        LMConfig(max_iterations=25),
    )

    sp = scipy.optimize.least_squares(
        lambda x: y_data - x[0] * x_data / (x[1] + x_data),
        np.array([0.9, 0.8]),
        method="lm",
    )
    return check("rational model", res.x, sp.x, 1e-5)


def main():
    ok = all([curve_fitting(), powell(), rational()])
    print("cross-check:", "ALL OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
