"""Test configuration: CPU backend with 8 virtual devices + x64 parity mode.

The reference's parity oracles are float64 CPU results
(/root/reference/tst/*.cpp); the suite runs on the CPU backend with 8
faked devices so multi-device sharding tests (shard-invariance, the analogue
of reference tst/multiple_objectives.cpp) run without a GPU. Tests marked
``gpu`` need the card and skip elsewhere; ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/`` runs them on one.
"""

import os

# Must run before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

from moptimizer_jax.utils.cache import enable_persistent_cache

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-dominated (every jitted
# LM variant recompiles per process otherwise).
enable_persistent_cache(min_compile_seconds=0.5)
