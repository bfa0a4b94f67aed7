"""Utilities: covariance recovery, trace formatting, verbose logging, IO."""

import io

import jax
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.covariance import estimate_covariance
from moptimizer_jax.core.residual import problem
from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_jax.utils.logging import Logger, L_DEBUG, L_ERROR, format_trace
from moptimizer_jax.utils.pointcloud import load_txt_cloud
from moptimizer_jax.utils.stopwatch import Stopwatch, time_jitted


def test_covariance_recovery_matches_manual():
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    res = levenberg_marquardt(problem(blk), jnp.array([0.9, 0.2]), LMConfig())
    cov = estimate_covariance(problem(blk), res.x)
    from moptimizer_jax.core.linearize import linearize

    _, H, _ = linearize(problem(blk), res.x)
    np.testing.assert_allclose(cov, np.linalg.inv(np.asarray(H)), rtol=1e-10)
    # scaled version is PSD and smaller for a good fit
    cov_s = estimate_covariance(problem(blk), res.x, scale_by_residual=True)
    assert np.all(np.linalg.eigvalsh(np.asarray(cov_s)) > 0)


def test_format_trace_renders():
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    res = levenberg_marquardt(problem(blk), jnp.array([0.9, 0.2]), LMConfig())
    text = format_trace(res)
    assert "prev_cost" in text and "|" in text
    assert len(text.splitlines()) >= 2


def test_logger_levels_and_sinks():
    buf = io.StringIO()
    log = Logger(sink=buf, level=L_ERROR, name="Optimizer")
    log.log(L_DEBUG, "hidden")
    log.log(L_ERROR, "shown", 42)
    out = buf.getvalue()
    assert "hidden" not in out
    assert "[ERROR] moptimizer::Optimizer:: shown 42" in out
    buf2 = io.StringIO()
    log.add_sink(buf2)
    log.log(L_ERROR, "both")
    assert "both" in buf.getvalue() and "both" in buf2.getvalue()


def test_verbose_solver_runs():
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    res = levenberg_marquardt(
        problem(blk), jnp.array([0.9, 0.2]), LMConfig(verbose=True)
    )
    assert np.isfinite(float(res.cost))


def test_stopwatch():
    sw = Stopwatch()
    sw.tick()
    assert sw.tock() >= 0.0
    t = time_jitted(lambda x: x * 2, jnp.ones(8), iters=3, warmup=1)
    assert t >= 0.0


def test_cloud_loader():
    data = pathlib.Path(__file__).parent / "data" / "fachada.txt"
    pts = load_txt_cloud(data)
    assert pts.shape == (29310, 3)
    assert np.isfinite(pts).all()


def test_checkpoint_roundtrip(tmp_path):
    from moptimizer_jax.utils import checkpoint

    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    res = levenberg_marquardt(problem(blk), jnp.array([0.9, 0.2]), LMConfig())
    path = tmp_path / "state.npz"
    checkpoint.save(path, res)
    template = jax.tree_util.tree_map(jnp.zeros_like, res)
    restored = checkpoint.load(path, template)
    np.testing.assert_array_equal(restored.x, res.x)
    np.testing.assert_array_equal(restored.trace["cost"], res.trace["cost"])
    # mismatched template rejected
    import pytest as _pytest

    with _pytest.raises(ValueError):
        checkpoint.load(path, {"wrong": jnp.zeros(2)})


def test_unrolled_cholesky_matches_lapack():
    from moptimizer_jax.ops.small_solve import cholesky_solve_unrolled

    rng = np.random.default_rng(33)
    for P in (2, 4, 6, 15):
        M = rng.normal(size=(P, P))
        A = jnp.asarray(M @ M.T + P * np.eye(P))
        b = jnp.asarray(rng.normal(size=P))
        x = cholesky_solve_unrolled(A, b)
        np.testing.assert_allclose(x, np.linalg.solve(np.asarray(A), np.asarray(b)), rtol=1e-9)


def test_unrolled_solver_in_lm():
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    res = levenberg_marquardt(
        problem(blk), jnp.array([0.9, 0.2]), LMConfig(linear_solver="unrolled")
    )
    np.testing.assert_allclose(res.x[0], 0.362, atol=0.01)
    np.testing.assert_allclose(res.x[1], 0.556, atol=0.01)


def test_checked_linearize_finite_passes():
    """checkify layer: finite problems pass through unchanged."""
    from moptimizer_jax.core.linearize import linearize
    from moptimizer_jax.utils.checks import checked_linearize

    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    x = jnp.array([0.9, 0.2])
    c, H, b = checked_linearize(problem(blk), x)
    c0, H0, b0 = linearize(problem(blk), x)
    np.testing.assert_allclose(np.asarray(c), np.asarray(c0))
    np.testing.assert_allclose(np.asarray(H), np.asarray(H0))
    np.testing.assert_allclose(np.asarray(b), np.asarray(b0))


def test_checked_linearize_raises_on_nan():
    """A model that produces NaN raises a named error instead of silently
    propagating (the debug layer over the solver's NUMERIC_ERROR status,
    reference src/levenberg_marquadt_dyn.cpp:88-91)."""
    import pytest

    from moptimizer_jax.core.residual import make_block
    from moptimizer_jax.utils.checks import checked_linearize

    bad = make_block(
        lambda x, d: jnp.array([jnp.log(x[0] * d[0] - 10.0)]),
        data=jnp.asarray(np.random.default_rng(0).random((5, 2))),
    )
    with pytest.raises(Exception, match="non-finite"):
        checked_linearize(problem(bad), jnp.ones(2))


def test_cache_honours_env_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, where set, is the one cache directory."""
    from moptimizer_jax.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    try:
        assert cache.enable_persistent_cache() == str(tmp_path / "jc")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")
        assert (tmp_path / "jc").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_default_dir_inside_checkout(monkeypatch):
    """Without the variable the cache sits at one fixed path in the checkout."""
    from moptimizer_jax.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert cache.cache_dir() == str(repo / ".jax_cache")


def test_roofline_known_device_kind():
    from moptimizer_jax.utils.profiling import roofline

    r = roofline(1e-3, flops=67e9, bytes_accessed=3.35e6, device_kind="NVIDIA H100 80GB HBM3")
    assert r["frac_of_peak_flops"] == pytest.approx(1.0)
    assert r["frac_of_peak_bw"] == pytest.approx(1e-3)
    assert r["bound"] == "compute"


def test_roofline_unknown_device_kind_raises():
    from moptimizer_jax.utils.profiling import roofline

    with pytest.raises(ValueError, match="no published peaks"):
        roofline(1.0, flops=1.0, device_kind="some other accelerator")
