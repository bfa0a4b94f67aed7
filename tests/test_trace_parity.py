"""Golden LM trajectory-trace parity.

The BASELINE north star requires matching the LM ITERATE SEQUENCE, not only
the converged minima. The reference defines the per-iteration record in its
inner-loop trace (src/levenberg_marquadt_dyn.cpp:72-75,94-95:
`it | max | prev_cost | new_cost | rho | lambda | nu`). The C++ reference
cannot be built in this image (no Eigen), so the strongest available proxy
is a three-way pin:

(a) committed golden fixtures: the full f64 `fd`-mode trace of every
    reference oracle, asserted to 1e-12 relative — any schedule drift fails;
(b) derivative-mode cross-check: fd / auto / analytic traces must agree
    while the trajectories are in lockstep (the reference's own
    differentiation.cpp strategy lifted from H,b to the iterate sequence);
(c) a hand-computed first-two-outer-iterations check on curve fitting with
    an INDEPENDENT numpy implementation of the λ/ν/ρ arithmetic
    (src:67-114), validating the schedule against the written spec rather
    than against the solver itself.
"""

import numpy as np
import pytest

from trace_problems import FIXTURE_DIR, PROBLEMS, result_to_arrays, run_trace

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


# point2point sums 29,310×3 residual terms: XLA's host thread partitioning
# sets the reduction order, so its trace is only reproducible to ~1e-7
# across machines with different core counts (everything else is 1e-12).
_TRACE_RTOL = {"point2point": 1e-6}
_X_ATOL = {"point2point": 1e-9}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_golden_trace_regression(name):
    """(a) full fd-mode trace ≡ committed fixture to 1e-12 relative."""
    fixture = np.load(FIXTURE_DIR / f"{name}.npz")
    got = result_to_arrays(run_trace(name, mode="fd"))
    rtol = _TRACE_RTOL.get(name, 1e-12)

    assert int(got["status"]) == int(fixture["status"])
    assert int(got["iterations"]) == int(fixture["iterations"])
    np.testing.assert_allclose(
        got["x"], fixture["x"], rtol=rtol, atol=_X_ATOL.get(name, 0)
    )
    for key in TRACE_KEYS:
        # atol floor: converged costs fall to O(ε²)·scale where the
        # reduction-order noise dominates any relative measure
        scale = abs(float(fixture["trace_cost"][0]))
        np.testing.assert_allclose(
            got[key], fixture[key], rtol=rtol, atol=rtol * 1e-12 * scale,
            equal_nan=True, err_msg=key,
        )
    for key in ("trace_accepted", "trace_inner_accepted"):
        np.testing.assert_array_equal(got[key], fixture[key], err_msg=key)


def _lockstep_length(ref, got, scale):
    """(window, benign): outer iterations until the traces genuinely part.

    Finite-difference Jacobians carry O(√ε) relative error, so fd and AD
    trajectories eventually separate — either at an accept/reject knife
    edge, or (on quadratically-converging problems) because AD reaches the
    true minimum while fd stalls at its h²-error cost floor. The window
    ends at the first divergent accept decision OR the first
    beyond-tolerance cost mismatch; the divergence is `benign` when it
    happens after both trajectories have effectively converged (both costs
    < 1e-4 of the initial cost — the fd floor regime, not schedule drift).
    Adaptive window instead of a fixed 3."""
    acc_ref = ref["trace_inner_accepted"]
    acc_got = got["trace_inner_accepted"]
    c_ref = ref["trace_cost"]
    c_got = got["trace_cost"]
    ci_ref = ref["trace_inner_cost_new"]
    ci_got = got["trace_inner_cost_new"]
    n = min(int(ref["iterations"]), int(got["iterations"]))
    for i in range(n):
        if not np.array_equal(acc_ref[i], acc_got[i]):
            return i, False
        # outer cost at i AND the inner trial costs produced during i (the
        # latter contain iterate i+1's cost, so divergence appears here one
        # iteration earlier than in trace_cost)
        outer_ok = bool(np.isclose(c_got[i], c_ref[i], rtol=1e-5, atol=1e-9 * scale))
        inner_ok = bool(
            np.all(
                np.isclose(
                    ci_got[i], ci_ref[i], rtol=1e-4, atol=1e-8 * scale, equal_nan=True
                )
            )
        )
        if not (outer_ok and inner_ok):
            # the values that actually disagree (outer pair and/or inner row)
            bad = [] if outer_ok else [c_ref[i], c_got[i]]
            if not inner_ok:
                bad += list(ci_ref[i][~np.isnan(ci_ref[i])])
                bad += list(ci_got[i][~np.isnan(ci_got[i])])
            # Value divergence with the accept/reject schedule still in
            # lockstep. On near-quadratically-converging problems this is
            # the expected fd-vs-AD step-quality gap (one AD step lands
            # orders of magnitude lower than one fd step), not schedule
            # drift — benign iff (a) the accept/reject pattern stays
            # IDENTICAL for the whole shared run, (b) contraction was
            # already established when the values parted (≥100× cost drop),
            # and (c) both modes still reach the same minimum value.
            same_schedule = all(
                np.array_equal(acc_ref[k], acc_got[k]) for k in range(n)
            )
            contracted = max(bad) < 1e-2 * scale
            both_at_min = (
                float(ref["cost"]) <= 1e-8 * scale
                and float(got["cost"]) <= 1e-8 * scale
            )
            return i, bool(same_schedule and contracted and both_at_min)
    return n, True


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_cross_mode_traces_agree(name):
    """(b) fd / auto / analytic iterate sequences agree while in lockstep.

    The window is adaptive: all trace state is compared up to the first
    genuinely divergent accept/reject decision, which must not arrive
    before 3 outer iterations (the previous fixed window is now the floor).
    """
    _, modes = PROBLEMS[name]
    results = {m: result_to_arrays(run_trace(name, mode=m)) for m in modes}
    ref = results["fd"]
    scale = abs(float(ref["trace_cost"][0]))  # initial cost sets the scale

    for m, got in results.items():
        if m == "fd":
            continue
        n_check, benign = _lockstep_length(ref, got, scale)
        assert n_check >= 3 or benign, (
            f"{m} vs fd diverged after {n_check} outer iterations with the "
            "trajectories NOT yet converged — schedule drift, not fd noise"
        )
        np.testing.assert_allclose(
            got["trace_cost"][:n_check],
            ref["trace_cost"][:n_check],
            rtol=1e-5,
            atol=1e-9 * scale,
            err_msg=f"{m} vs fd outer cost (lockstep {n_check})",
        )
        np.testing.assert_allclose(
            got["trace_inner_cost_new"][:n_check],
            ref["trace_inner_cost_new"][:n_check],
            rtol=1e-4,
            atol=1e-8 * scale,
            equal_nan=True,
            err_msg=f"{m} vs fd inner trial costs (lockstep {n_check})",
        )
        np.testing.assert_array_equal(
            got["trace_inner_accepted"][:n_check],
            ref["trace_inner_accepted"][:n_check],
            err_msg=f"{m} vs fd accept/reject decisions",
        )


def _numpy_fd_jacobian(residual, x):
    """Independent replica of the reference FD scheme (linearization.h:78-106)."""
    eps = np.finfo(np.float64).eps
    min_step = np.sqrt(eps)
    r0 = residual(x)
    J = np.zeros((r0.size, x.size))
    for j in range(x.size):
        h = min_step * abs(x[j])
        if h == 0.0:
            h = min_step
        xp = x.copy()
        xp[j] += h
        J[:, j] = (residual(xp) - r0) / h
    return r0, J


def test_hand_computed_curve_fitting_schedule():
    """(c) first two outer iterations of curve fitting, re-derived in numpy.

    Implements the reference λ/ν/ρ arithmetic directly from the spec
    (src/levenberg_marquadt_dyn.cpp:67-114): λ0 = 1e-9·max|diag H|,
    δ = (H+λ·diagH)⁻¹(−b), ρ = (y0−yi)/δ·(λδ−b), reject → λ←νλ, ν←2ν,
    accept → λ←λ·max(1/3, 1−(2ρ−1)³) — and checks every recorded trial of
    the solver's first two outer iterations against it.
    """
    from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA

    data = np.asarray(CERES_CURVE_DATA, dtype=np.float64)

    def residual(x):
        return data[:, 1] - np.exp(x[0] * data[:, 0] + x[1])

    got = result_to_arrays(run_trace("curve_near", mode="fd"))

    x = np.zeros(2)
    lam = None
    n_inner = got["trace_inner_lam"].shape[1]
    for outer in range(2):
        r0, J = _numpy_fd_jacobian(residual, x)
        y0 = float(r0 @ r0)
        H = J.T @ J
        b = J.T @ r0
        diag_H = np.diag(H)
        if lam is None:
            lam = 1e-9 * float(np.max(np.abs(diag_H)))
        nu = 2.0

        np.testing.assert_allclose(got["trace_cost"][outer], y0, rtol=1e-9)

        for k in range(n_inner):
            if np.isnan(got["trace_inner_lam"][outer, k]):
                break  # inner loop exited early (accepted)
            delta = np.linalg.solve(H + lam * np.diag(diag_H), -b)
            yi = float(residual(x + delta) @ residual(x + delta))
            rho = (y0 - yi) / float(delta @ (lam * delta - b))

            np.testing.assert_allclose(
                got["trace_inner_lam"][outer, k], lam, rtol=1e-9,
                err_msg=f"lambda at outer {outer} trial {k}",
            )
            np.testing.assert_allclose(
                got["trace_inner_nu"][outer, k], nu, rtol=1e-12,
                err_msg=f"nu at outer {outer} trial {k}",
            )
            np.testing.assert_allclose(
                got["trace_inner_cost_new"][outer, k], yi, rtol=1e-9,
                err_msg=f"trial cost at outer {outer} trial {k}",
            )
            np.testing.assert_allclose(
                got["trace_inner_rho"][outer, k], rho, rtol=1e-6,
                err_msg=f"rho at outer {outer} trial {k}",
            )

            if rho >= 0:  # accept (NaN-free here)
                assert bool(got["trace_inner_accepted"][outer, k])
                x = x + delta
                lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                break
            assert not bool(got["trace_inner_accepted"][outer, k])
            lam = nu * lam
            nu = 2.0 * nu
