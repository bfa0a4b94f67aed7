"""Built-in residual models (the reference's test workloads, as blocks)."""

from moptimizer_jax.models.curve_fitting import exponential_curve_block, CERES_CURVE_DATA
from moptimizer_jax.models.rational import rational_block
from moptimizer_jax.models.powell import powell_block
from moptimizer_jax.models.point2point import point2point_block
from moptimizer_jax.models.camera import camera_reprojection_block
from moptimizer_jax.models.accelerometer import accelerometer_block
from moptimizer_jax.models.state import product_state_block
