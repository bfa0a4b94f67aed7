"""Example: exponential curve fitting (the Ceres benchmark problem).

Equivalent user code to reference tst/curve_fitting.cpp — a user-defined
residual model driven through the LM solver.

    python examples/curve_fitting.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from moptimizer_jax import LMConfig, Status, levenberg_marquardt
from moptimizer_jax.core.residual import make_block, problem
from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA
from moptimizer_jax.utils.logging import format_trace


def residual(x, d):
    # one observation d = (x_i, y_i); model y = exp(m·x + c)
    return jnp.array([d[1] - jnp.exp(x[0] * d[0] + x[1])])


def main():
    blk = make_block(residual, data=jnp.asarray(CERES_CURVE_DATA))
    res = levenberg_marquardt(problem(blk), jnp.zeros(2), LMConfig())
    print(f"x = {res.x}  status = {Status(int(res.status)).name}  "
          f"iterations = {int(res.iterations)}  cost = {float(res.cost):.6f}")
    print(format_trace(res))


if __name__ == "__main__":
    main()
