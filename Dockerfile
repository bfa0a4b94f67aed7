# CI-parity container: CPU-backend JAX, full test suite.
# Mirrors the reference's Dockerfile role (/root/reference/Dockerfile:1-13 —
# build + ctest), swapping cmake/ctest for pip/pytest.
FROM python:3.12-slim

WORKDIR /work
COPY pyproject.toml ./
COPY moptimizer_jax ./moptimizer_jax
COPY tests ./tests
COPY bench.py __graft_entry__.py ./

RUN pip install --no-cache-dir -e . pytest chex

# The suite forces the CPU platform with 8 faked devices (tests/conftest.py);
# deterministic — no retry hack needed (contrast reference CI's
# `ctest --repeat until-pass:3`).
CMD ["python", "-m", "pytest", "tests/", "-q"]
