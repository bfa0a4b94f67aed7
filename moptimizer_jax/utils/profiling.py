"""Profiling helpers: jax.profiler trace context + throughput reporting.

SURVEY.md §5 aux-subsystem requirement: "jax.profiler trace contexts + a
benchmark harness timing jitted steps after warm-up, reporting iterations/sec
and achieved FLOPs". The reference has only an ad-hoc Stopwatch
(stopwatch.hpp).
"""

import contextlib
import time

import jax

# Published single-card peaks, keyed by jax's device_kind (NVIDIA H100 SXM
# data sheet, dense rates without sparsity, at the 700 W power limit).
# "f32" is float32 outside the tensor cores — what a float32 matmul at
# precision="highest" runs at; "tf32" is what precision="default" may use.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(f32=67e12, tf32=495e12, bf16=989e12, hbm_bytes=3.35e12),
}


def device_peaks(device_kind=None):
    """The PEAKS entry of `device_kind` (default: the first device's).
    A device the table does not know is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; known: {sorted(PEAKS)}"
        ) from None


def roofline(seconds, *, flops=0.0, bytes_accessed=0.0, precision="f32", device_kind=None):
    """Fraction of speed-of-light achieved by a measured kernel.

    Peaks come from PEAKS for `device_kind` (default: the first device);
    `precision` picks the FLOP peak ("f32", "tf32" or "bf16"). Returns a
    dict with achieved GFLOP/s / GB/s, the fraction of each peak, the bound
    ("compute" or "memory" — whichever peak predicts the longer time), and
    `frac_of_light`: achieved fraction of the roofline time
    max(flops/peak_flops, bytes/peak_bw) — 1.0 means the kernel runs as
    fast as this hardware can run it.
    """
    peaks = device_peaks(device_kind)
    peak_flops, peak_bw = peaks[precision], peaks["hbm_bytes"]
    t_compute = flops / peak_flops if flops else 0.0
    t_memory = bytes_accessed / peak_bw if bytes_accessed else 0.0
    t_light = max(t_compute, t_memory)
    out = dict(
        seconds=seconds,
        gflops_per_sec=flops / seconds / 1e9 if flops else 0.0,
        gbytes_per_sec=bytes_accessed / seconds / 1e9 if bytes_accessed else 0.0,
        bound="compute" if t_compute >= t_memory else "memory",
        frac_of_light=(t_light / seconds) if t_light else 0.0,
    )
    if flops:
        out["frac_of_peak_flops"] = flops / seconds / peak_flops
    if bytes_accessed:
        out["frac_of_peak_bw"] = bytes_accessed / seconds / peak_bw
    return out


@contextlib.contextmanager
def trace(log_dir):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, iters=20, warmup=2, flops=None, bytes_accessed=None):
    """Median-time a jitted callable with device sync.

    Returns a dict: seconds, iters_per_sec, and (when the caller supplies
    cost models) achieved GFLOP/s and GB/s.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    out = dict(seconds=dt, iters_per_sec=1.0 / dt)
    if flops is not None:
        out["gflops_per_sec"] = flops / dt / 1e9
    if bytes_accessed is not None:
        out["gbytes_per_sec"] = bytes_accessed / dt / 1e9
    return out
