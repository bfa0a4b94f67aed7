"""Multi-host path, actually exercised: 2 CPU processes over a local gloo
coordinator drive distributed_levenberg_marquardt end-to-end
(SURVEY §2.3 "multi-host init over DCN").

The subprocess pair is the CPU stand-in for a 2-host DCN job: a real
jax.distributed coordinator handshake, a global 4-device mesh spanning both
processes, per-process local data shards, and cross-process collectives in
the Gauss-Newton reduction."""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # heavy module: excluded from the default run


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_lm():
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    # both processes computed the same converged parameters, and they match
    # the reference curve-fitting minimum (tst/curve_fitting.cpp:116-117)
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, m, c = line.split()
                results[int(pid)] = (float(m), float(c))
    assert set(results) == {0, 1}, outs
    assert results[0] == results[1]
    m, c = results[0]
    # 64-row (shard-exact) slice of the Ceres dataset; SciPy MINPACK-LM
    # oracle for the same slice gives (0.29284892, 0.12883951)
    assert abs(m - 0.29284892) < 5e-5
    assert abs(c - 0.12883951) < 5e-5


def test_two_process_dense_schur_ba():
    """Landmark-sharded dense-Schur BA across 2 real jax.distributed
    processes ≡ single-device solve (previously only curve-fitting
    LM crossed processes before). Includes the make_global_array L-shard
    round-trip inside the worker."""
    worker = os.path.join(os.path.dirname(__file__), "_multihost_ba_worker.py")
    port = _free_port()
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, cost, cam, cam_cg = line.split()
                results[int(pid)] = (cost, cam, cam_cg)
    assert set(results) == {0, 1}, outs
    # both processes agree bitwise on the replicated camera state + cost
    # (dense engine) and on the GSPMD Schur-CG cameras
    assert results[0] == results[1]


def test_initialize_failure_is_loud():
    """A broken explicit coordinator config must fail loudly, not pass
    silently (the r1 swallow-all bug). The coordination-service client
    LOG(FATAL)s on a handshake deadline, so the observable contract is a
    nonzero process exit with the error on stderr — pinned via subprocess."""
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import sys; sys.path.insert(0, %r)\n"
        "from moptimizer_jax.parallel import multihost\n"
        "multihost.initialize(coordinator_address='localhost:1',\n"
        "                     num_processes=2, process_id=1,\n"
        "                     initialization_timeout=2)\n"
        "print('UNREACHABLE-OK')\n"
    ) % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    p = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=120,
        env=env,
    )
    assert p.returncode != 0
    assert "UNREACHABLE-OK" not in p.stdout
    assert "DEADLINE_EXCEEDED" in p.stderr or "Deadline Exceeded" in p.stderr
