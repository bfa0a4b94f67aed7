"""moptimizer_jax — a nonlinear least-squares optimization engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++ library (Ceres-style Levenberg-Marquardt over user residual models,
/root/reference/include/moptimizer/optimizer.h), built for the accelerator:

* residual blocks are pure functions vmapped over the residual index
  (replacing virtual-dispatch models, reference model.h:12-47),
* linearization is AD (jacfwd) / analytic / finite-difference + one fused
  matmul for the Gauss-Newton system H = JᵀΣJ, b = JᵀΣr
  (replacing the serial loops of reference linearization.h:65-158),
* the LM loop is a jitted lax.while_loop with the reference's exact
  λ/ν/ρ schedule (reference src/levenberg_marquadt_dyn.cpp:34-119),
* parallelism is a jax.sharding mesh axis with psum-reduced H,b
  (replacing TBB parallel_reduce, reference linearization.h:49-63).
"""

import jax as _jax

# At the default precision a GPU may run f32 matmuls in TF32, which keeps
# about 10 mantissa bits — too coarse for geometric residuals, where ICP
# would stall far above its f32 convergence floor. The matmuls in this
# domain are mostly tiny-K (3/6-dim contractions) where full f32 precision
# costs little, so make it the library default. The dense BA engine opts
# its large Schur-build matmuls back into "default" (DenseBAConfig).
_jax.config.update("jax_default_matmul_precision", "highest")

from moptimizer_jax.core.loss import (
    Cauchy,
    GemanMcClure,
    Huber,
    TrivialLoss,
)
from moptimizer_jax.core.residual import ResidualBlock, Problem
from moptimizer_jax.core.linearize import linearize, compute_cost
from moptimizer_jax.core.solver import (
    LMConfig,
    LMResult,
    Status,
    levenberg_marquardt,
    levenberg_marquardt_batched,
    lm_step,
    solve_multistart,
)
from moptimizer_jax.core import manifold
from moptimizer_jax import lie

__version__ = "0.3.0"
