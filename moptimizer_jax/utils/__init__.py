from moptimizer_jax.utils.stopwatch import Stopwatch, time_jitted
from moptimizer_jax.utils.logging import Logger, format_trace
from moptimizer_jax.utils.pointcloud import load_txt_cloud
