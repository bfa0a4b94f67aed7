"""Segment-op A/B: scatter/gather vs one-hot matmuls at BA scale.

The benchmark behind the `ops/segmented.py` design: measures MARGINAL
device time per op via a two-point fit (K1, K2 loop lengths), canceling the
fixed dispatch cost. All candidates are perturbed with a non-separable data
dependency so nothing hoists.

Run on a GPU: python -m benchmarks.segment_ops_ab
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

K1, K2 = 4, 44


def marginal(opbody, args):
    def make(K):
        @jax.jit
        def loop(*a):
            def body(_, s):
                return opbody(s, *a)

            return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

        return loop

    ts = []
    for K in (K1, K2):
        f = make(K)
        jax.block_until_ready(f(*args))
        best = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*args))
            best = min(best, time.perf_counter() - t0)
        ts.append(best)
    return (ts[1] - ts[0]) / (K2 - K1)


def main():
    O, C, L = 500_000, 200, 50_000
    rng = np.random.default_rng(0)
    cam_np = rng.integers(0, C, size=O)
    pt_np = np.sort(rng.integers(0, L, size=O))
    cam_idx = jnp.asarray(cam_np)
    pt_idx = jnp.asarray(pt_np)
    v36 = jnp.asarray(rng.normal(size=(O, 36)), jnp.float32)
    v3 = jnp.asarray(rng.normal(size=(O, 3)), jnp.float32)
    tab_c = jnp.asarray(rng.normal(size=(C, 6)), jnp.float32)
    tab_l = jnp.asarray(rng.normal(size=(L, 3)), jnp.float32)
    oh_c_bf16 = jax.block_until_ready(
        (cam_idx[:, None] == jnp.arange(C)[None, :]).astype(jnp.bfloat16)
    )

    from moptimizer_jax.ops.segmented import required_span, segment_sum_sorted

    span = required_span(pt_np, tile=4096)
    print(f"# span={span}")

    def seg_oh_fused(s, v, i):
        oh = (i[:, None] == jnp.arange(C, dtype=i.dtype)[None, :]).astype(v.dtype)
        return (
            jax.lax.dot_general(
                oh, jnp.abs(v + s), (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).sum()
            * 1e-9
        )

    def seg_oh_stored(s, oh, v):
        return (
            jax.lax.dot_general(
                oh, jnp.abs(v + s).astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).sum()
            * 1e-9
        )

    cases = {
        "dense_read (O,36)": (
            lambda s, v: jnp.sum(jnp.abs(v + s)) * 1e-9,
            (v36,),
        ),
        "seg_C scatter (O,36)": (
            lambda s, v, i: jax.ops.segment_sum(
                jnp.abs(v + s), i, num_segments=C
            ).sum() * 1e-9,
            (v36, cam_idx),
        ),
        "seg_C onehot fused f32": (seg_oh_fused, (v36, cam_idx)),
        "seg_C onehot stored bf16": (seg_oh_stored, (oh_c_bf16, v36)),
        "seg_L scatter (O,3)": (
            lambda s, v, i: jax.ops.segment_sum(
                jnp.abs(v + s), i, num_segments=L
            ).sum() * 1e-9,
            (v3, pt_idx),
        ),
        "seg_L sorted-tiled (O,3)": (
            lambda s, v, i: segment_sum_sorted(
                jnp.abs(v + s), i, n_segments=L, tile=4096, span=span
            ).sum() * 1e-9,
            (v3, pt_idx),
        ),
        "gather_C rows (O,6)": (
            lambda s, t, i: jnp.sum(jnp.abs((t + s)[i])) * 1e-9,
            (tab_c, cam_idx),
        ),
        "gather_C onehot bf16": (
            lambda s, oh, t: jnp.sum(
                jnp.abs(
                    jnp.matmul(
                        oh, (t + s).astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32,
                    )
                )
            ) * 1e-9,
            (oh_c_bf16, tab_c),
        ),
        "gather_L rows (O,3)": (
            lambda s, t, i: jnp.sum(jnp.abs((t + s)[i])) * 1e-9,
            (tab_l, pt_idx),
        ),
    }
    for name, (op, args) in cases.items():
        t = marginal(op, args)
        print(f"{name:<28}{t*1e6:10.1f}us")


if __name__ == "__main__":
    main()
