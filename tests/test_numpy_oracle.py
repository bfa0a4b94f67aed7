"""Cross-validation of the JAX solver against the standalone numpy oracle.

The golden trace fixtures (tests/data/traces) are
generated by the JAX solver itself, so trace REGRESSIONS were pinned but
reference PARITY rested on the solver validating itself. numpy_lm_oracle
is a second, independent implementation of the reference LM (written from
/root/reference/src/levenberg_marquadt_dyn.cpp — solver arithmetic, FD
scheme, and all nine model residuals re-derived in pure numpy). Here both
implementations run every fixture problem TO CONVERGENCE in fd mode and
the full traces must agree: same status, same executed-iteration count,
same accept/reject schedule, per-trial λ/ν/ρ/cost equal to tight
tolerances (reduction order differs — jnp matmul vs numpy J.T@J — so
bitwise equality is not expected; values are pinned on decrement-informed windows, the accept/reject schedule exactly).
"""

import numpy as np
import pytest

from numpy_lm_oracle import numpy_lm, oracle_problems
from trace_problems import PROBLEMS, result_to_arrays, run_trace

TRACE_KEYS = [
    "trace_cost",
    "trace_cost_new",
    "trace_rho",
    "trace_lam",
    "trace_nu",
    "trace_inner_cost_new",
    "trace_inner_rho",
    "trace_inner_lam",
    "trace_inner_nu",
]

# Default 1e-7: the two implementations' fd Jacobians/H,b differ at the
# summation-reorder level (~1e-15 per op) and the λ/ρ recursion amplifies
# that over tens of iterations to ~1e-8. point2point sums 29,310×3
# residual terms: reduction-order noise is larger still.
_RTOL = {"point2point": 1e-5, "camera_calibration": 5e-6, "camera_calibration_bad": 5e-6}
# the accelerometer's rotation-about-gravity direction is exactly
# unobservable (rank-deficient H, SURVEY trace_problems note): the solved x
# is only defined up to that null direction, so its x tolerance is loose
_X_ATOL = {"accelerometer": 5e-3}
# ρ denominators δ·(λδ−b) pass through catastrophic cancellation near
# convergence, so ρ gets a looser relative tolerance than costs/λ
_RHO_RTOL_FACTOR = 100.0


def _lockstep(got, ref, rtol, scale):
    """Outer iterations until the two implementations genuinely part.

    Different summation orders (jnp matmul vs numpy J.T@J) make the two
    runs diverge at a ρ accept/reject knife edge once (y0−yi) reaches the
    f64 noise floor; before that every trace field must agree to rtol."""
    n = min(int(got["iterations"]), int(ref["iterations"])) + 1
    for i in range(n):
        if not np.array_equal(
            got["trace_inner_accepted"][i], ref["trace_inner_accepted"][i]
        ):
            return i
        a, b = got["trace_cost"][i], ref["trace_cost"][i]
        if not np.isclose(a, b, rtol=rtol, atol=rtol * scale):
            return i
    return n


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_jax_trace_matches_numpy_oracle(name):
    got = result_to_arrays(run_trace(name, mode="fd"))
    residual, x0, kwargs = oracle_problems()[name]
    ref = numpy_lm(residual, x0, **kwargs)

    rtol = _RTOL.get(name, 1e-6)
    scale = abs(float(ref["trace_cost"][0]))
    n_lock = _lockstep(got, ref, 1e-6, scale)
    n_full = max(int(got["iterations"]), int(ref["iterations"])) + 1

    if n_lock < n_full:
        # divergence is only admissible AT THE NOISE FLOOR: some lockstep
        # iterations executed first, contraction already established at the
        # parting point (≥ 10⁴× cost drop), and both runs settle on the
        # same final cost (absolute floor term covers problems whose true
        # minimum is 0 and whose floors are O(ε²) noise, e.g. state_model
        # at 1e-10 vs 1e-24). Iteration counts may then legitimately differ
        # (one run's ρ knife-edge rejects and stops, the other polishes).
        assert n_lock >= 1, "diverged before any common iteration"
        f_got, f_ref = float(got["cost"]), float(ref["cost"])
        # contraction measured against the FINAL cost, not zero: problems
        # with a data-noise cost floor (curve fit ≈ 2.11, rational ≈ 0.008)
        # diverge once the remaining decrease is fd-noise-sized, and
        # quadratically-converging ones (state_model) reach that floor in
        # 2 iterations
        f_min = min(f_got, f_ref)
        i_at = min(n_lock, int(ref["iterations"]), int(got["iterations"]))
        c_at = max(
            float(ref["trace_cost"][i_at]), float(got["trace_cost"][i_at])
        )
        drop = max(scale - f_min, 1e-300)
        assert (c_at - f_min) <= 1e-2 * drop, (
            f"diverged at iteration {n_lock} with cost {c_at} while "
            f"{(c_at - f_min) / drop:.2e} of the total decrease remained — "
            "schedule drift, not floor noise"
        )
        assert np.isclose(f_got, f_ref, rtol=1e-6, atol=1e-8 * scale), (
            f"diverged at {n_lock} with different final costs "
            f"{f_got} vs {f_ref}"
        )
        x_tol = dict(rtol=1e-4, atol=max(1e-4, _X_ATOL.get(name, 0.0)))
    else:
        assert int(got["status"]) == int(ref["status"])
        assert int(got["iterations"]) == int(ref["iterations"])
        x_tol = dict(
            rtol=1e-5,
            atol=max(1e-10 * max(scale, 1.0), _X_ATOL.get(name, 0.0)),
        )

    np.testing.assert_allclose(got["x"], ref["x"], **x_tol)

    # VALUE comparisons stop once the cost decrement drops below a noise
    # threshold: λ/ν/ρ are recursively built from ρ = (y0−yi)/δ·(λδ−b),
    # which passes through catastrophic cancellation as the decrement
    # shrinks — the two implementations' fd-noise then dominates the value
    # while the accept/reject SCHEDULE (pinned exactly for the whole
    # lockstep window below) still agrees. ρ amplifies the noise by
    # 1/decrement, so it gets an earlier cutoff and a looser rtol.
    y0 = np.abs(ref["trace_cost"][:n_lock])
    dec = ref["trace_cost"][:n_lock] - ref["trace_cost_new"][:n_lock]
    with np.errstate(invalid="ignore"):
        inf_val = dec > 1e-6 * np.maximum(y0, 1e-300)
        # ρ additionally needs the LANDED cost above the fd-noise floor: a
        # quadratic step that lands AT the floor (state_model iteration 1:
        # yi = 3e-11 vs 4e-4 across implementations) makes ρ = 1 − yi/pred
        # depend on the noise realization while the decrement is still huge
        inf_rho = (dec > 1e-2 * np.maximum(y0, 1e-300)) & (
            np.abs(ref["trace_cost_new"][:n_lock]) > 1e-4 * scale
        )
    n_val = n_lock if inf_val.all() else int(np.argmin(inf_val))
    n_rho = n_lock if inf_rho.all() else int(np.argmin(inf_rho))

    for key in TRACE_KEYS:
        # cost values get an absolute floor at 1e-4·initial (a floor-noise
        # LANDING value, e.g. state_model's 3.7e-4 vs 3e-11 after one
        # quadratic step, is not comparable; real schedule drift shows at
        # O(scale)); λ/ν/ρ are built from ρ and compared on the shorter
        # strongly-decreasing window with the amplified tolerance
        if "rho" in key or "lam" in key or "nu" in key:
            n, r, a = n_rho, rtol * _RHO_RTOL_FACTOR, 1e-3 if "rho" in key else 0.0
        else:
            n, r, a = n_val, rtol, 1e-4 * scale
        np.testing.assert_allclose(
            got[key][:n],
            ref[key][:n],
            rtol=r,
            atol=a,
            equal_nan=True,
            err_msg=f"{key} (window {n} of lockstep {n_lock})",
        )
    np.testing.assert_array_equal(
        got["trace_inner_accepted"][:n_lock],
        ref["trace_inner_accepted"][:n_lock],
        err_msg="inner accepted",
    )


def test_oracle_is_independent():
    """The oracle module must not import solver code from the package —
    only embedded public datasets are shared (checked by source scan)."""
    import pathlib

    src = (pathlib.Path(__file__).parent / "numpy_lm_oracle.py").read_text()
    for line in src.splitlines():
        line = line.strip()
        if line.startswith("from moptimizer_jax") or line.startswith(
            "import moptimizer_jax"
        ):
            assert (
                "CERES_CURVE_DATA" in line or "SIMPLE_X" in line
            ), f"oracle imports non-dataset package code: {line}"
    body = src.split('"""', 2)[2].replace("moptimizer_jax", "")  # the dataset imports
    assert "jax" not in body.replace("jnp", "")  # numpy only
