"""Benchmark CLI: LOS sampling + trace throughput on a synthetic cube.

Capability-parity with the reference bench harness (bench_raytrace.py:16-101)
plus the tracer and transfer stages. Reports samples/s and ray-steps/s.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_case(n_pix, n_steps, grid_n, seed=0):
    """Synthetic Gaussian-density cube + jittered vertical rays
    (workload of bench_raytrace.py:16-41)."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-2.0, 2.0, grid_n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    ne = (1.0e8 + 2.0e8 * np.exp(-(x * x + y * y + z * z))).astype(np.float32)
    te = (1.0e6 + 2.0e6 * (x + 2 * y - z)).astype(np.float32)
    b = (2.0 + x - y + 0.5 * z).astype(np.float32)

    n_rays = n_pix * n_pix
    origin_xy = rng.uniform(-1.2, 1.2, size=(n_rays, 2)).astype(np.float32)
    origin = np.column_stack([origin_xy,
                              np.full(n_rays, 2.5, dtype=np.float32)])
    dirs = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_rays, 1))
    dirs[:, 0:2] += rng.normal(scale=0.02, size=(n_rays, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    s = (np.arange(n_steps, dtype=np.float32) * 0.02)[:, None]
    r_record = origin[None, :, :] + s[:, :, None] * dirs[None, :, :]
    s_arr = np.ones((n_steps, n_rays), dtype=np.float32)
    return g, ne, te, b, r_record, s_arr, origin, dirs


def main(argv=None):
    p = argparse.ArgumentParser(description="Benchmark LOS sampling and "
                                            "ray tracing on JAX's default device")
    p.add_argument("--n-pix", type=int, default=256)
    p.add_argument("--n-steps", type=int, default=256)
    p.add_argument("--grid-n", type=int, default=128)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--trace-steps", type=int, default=1000,
                   help="RK4 steps for the tracer benchmark")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from raytracinggrff_jax.grids import UniformGrid
    from raytracinggrff_jax.sampler import (pack_model_table,
                                            sample_model_with_rays)
    from raytracinggrff_jax.tracer import pack_trace_table, trace_rays

    g, ne, te, b, r_record, s_arr, origin, dirs = make_case(
        args.n_pix, args.n_steps, args.grid_n)
    grid = UniformGrid.from_arrays(g, g, g)
    n_samples = args.n_pix * args.n_pix * args.n_steps

    table = pack_model_table(jnp.asarray(ne), jnp.asarray(te),
                             jnp.asarray(b))
    pos = jnp.asarray(r_record)
    s = jnp.asarray(s_arr)
    start = jnp.asarray(origin)

    def run_sample():
        out = sample_model_with_rays(table, grid, pos, s, start)
        jax.block_until_ready(out.ne)
        return out

    run_sample()
    best = min(_time(run_sample) for _ in range(args.repeat))
    print(f"LOS sampling best: {best:.4f} s "
          f"({n_samples / best:,.0f} samples/s)")

    omega_pe = 8.93e3 * np.sqrt(np.maximum(ne, 0)) * 2 * np.pi
    ttable = pack_trace_table(jnp.asarray(omega_pe.astype(np.float32)), grid)

    def run_trace():
        res = trace_rays(ttable, grid, 150e6, start, jnp.asarray(dirs),
                         5e-3, args.trace_steps, 10,
                         trace_crosssections=True)
        jax.block_until_ready(res.r_record)
        return res

    run_trace()
    best_t = min(_time(run_trace) for _ in range(args.repeat))
    ray_steps = args.n_pix * args.n_pix * args.trace_steps
    print(f"Trace best: {best_t:.4f} s "
          f"({ray_steps / best_t:,.0f} ray-steps/s, cross-sections on)")


def _time(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
