"""Refractive ray tracing through a plasma-frequency cube.

Physics (ref: raytracingGRFF/build_rays.py:128-248, ray_tracing_demo.ipynb):
    dr/dt = C_R * k / omega
    dk/dt = -(omega_pe / omega) * grad(omega_pe) * C_R
    omega^2 = omega_pe^2 + |k|^2        (k in angular-frequency units)
with positions in R_sun, time in seconds, integrated with RK4. Rays whose
position leaves the cube (or samples NaN) get zero derivatives ("frozen",
ref: build_rays.py:169-175, gpu_raytrace.py:176-189).

Cross-section tracking (ref: build_rays.py:186-244, gpu_raytrace.py:275-314):
per step, two rays perturbed transversely by eps = perturb_ratio*|dr| are
advanced one step from the central ray's previous state; the area
magnification ratio S = |cross(d1, d2) . t_hat| / eps^2 is accumulated.

Design vs the reference:
  * The reference CUDA path launches one kernel per step and syncs the S
    ratio to host every step (gpu_raytrace.py:383-398). Here the entire
    n_steps loop runs on-device inside one jitted lax.scan; records are
    written to preallocated scan outputs every `record_stride` steps.
  * State is laid out as (3, n_rays) so each component is one contiguous
    vector over rays.
  * omega_pe and its three gradient cubes are packed into one (N, 4) table
    so each trilinear sample costs 8 shared gathers instead of 32.
  * Steps after the last record are skipped entirely — they cannot affect
    any output (the reference runs them anyway).

S-record semantics: the GPU reference records the *cumulative product* of
per-step ratios (gpu_raytrace.py:398-408) while the CPU reference records the
instantaneous per-step ratio (build_rays.py:241-244). Production pipelines use
the GPU path, so `s_mode='cumulative'` is the default; `'per_step'` reproduces
the CPU semantics.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .constants import C_R
from .grids import UniformGrid
from .ops.trilinear import pack_fields, trilinear_packed


class TraceResult(NamedTuple):
    r_record: jax.Array      # (n_records, n_rays, 3) recorded positions
    s_record: jax.Array      # (n_records, n_rays) cross-section ratios
    final_state: jax.Array   # (n_rays, 6) final [r, k] (for diagnostics)
    k_record: jax.Array | None = None  # (n_records, n_rays, 3) wave vectors
    # (record_k=True): the INSTANTANEOUS k at each record step —
    # theta_mode='los' uses it for cos(theta(B, k)); a position finite
    # difference lags it by O(curvature over a record stride)


def gradient_cubes(cube, grid: UniformGrid):
    """np.gradient-compatible central differences (one-sided at edges).

    Matches the reference's precomputed gradients (build_rays.py:136-138,
    gpu_raytrace.py:355-357).
    """
    def grad_axis(f, h, axis):
        f = jnp.asarray(f, jnp.float32)
        central = (jnp.roll(f, -1, axis) - jnp.roll(f, 1, axis)) / (2.0 * h)
        # one-sided at the two boundary slices
        first = (jnp.take(f, 1, axis) - jnp.take(f, 0, axis)) / h
        last = (jnp.take(f, f.shape[axis] - 1, axis)
                - jnp.take(f, f.shape[axis] - 2, axis)) / h
        idx = jnp.arange(f.shape[axis])
        shape = [1, 1, 1]
        shape[axis] = f.shape[axis]
        idx = idx.reshape(shape)
        central = jnp.where(idx == 0, jnp.expand_dims(first, axis), central)
        central = jnp.where(idx == f.shape[axis] - 1,
                            jnp.expand_dims(last, axis), central)
        return central

    gx = grad_axis(cube, grid.dx, 0)
    gy = grad_axis(cube, grid.dy, 1)
    gz = grad_axis(cube, grid.dz, 2)
    return gx, gy, gz


def pack_trace_table(omega_pe_cube, grid: UniformGrid):
    """Pack omega_pe + its three gradients into one (N, 4) gather table."""
    gx, gy, gz = gradient_cubes(omega_pe_cube, grid)
    return pack_fields(omega_pe_cube, gx, gy, gz)


def _rhs(table, grid, r, k):
    """ODE right-hand side. r, k: (3, n_rays). Returns (dr, dk).

    Mirrors rhs_eval (gpu_raytrace.py:160-198): invalid samples (OOB omega_pe
    or non-finite gradient) give zero derivatives.
    """
    v, _ = trilinear_packed(table, grid, r[0], r[1], r[2])  # (n_rays, 4)
    wpe = v[:, 0]
    g = v[:, 1:4].T  # (3, n_rays)
    k_sq = jnp.sum(k * k, axis=0)
    om = jnp.sqrt(jnp.maximum(wpe * wpe + k_sq, 0.0))
    valid = (jnp.isfinite(wpe) & jnp.isfinite(om) & (om > 0.0)
             & jnp.all(jnp.isfinite(g), axis=0))
    inv_om = jnp.where(valid, 1.0 / jnp.where(om > 0, om, 1.0), 0.0)
    dr = (C_R * inv_om)[None, :] * k
    dk = (-wpe * inv_om * C_R)[None, :] * jnp.where(valid[None, :], g, 0.0)
    dr = jnp.where(valid[None, :], dr, 0.0)
    return dr, dk


def _rk4_step(table, grid, r, k, dt):
    k1r, k1k = _rhs(table, grid, r, k)
    k2r, k2k = _rhs(table, grid, r + 0.5 * dt * k1r, k + 0.5 * dt * k1k)
    k3r, k3k = _rhs(table, grid, r + 0.5 * dt * k2r, k + 0.5 * dt * k2k)
    k4r, k4k = _rhs(table, grid, r + dt * k3r, k + dt * k3k)
    c = dt / 6.0
    r_new = r + c * (k1r + 2.0 * k2r + 2.0 * k3r + k4r)
    k_new = k + c * (k1k + 2.0 * k2k + 2.0 * k3k + k4k)
    return r_new, k_new


def _transverse_basis(t_hat):
    """Stable transverse unit vectors e1, e2 for step directions t_hat (3, n).

    Matches make_e1e2_from_t / the CUDA inline version (build_rays.py:188-201,
    gpu_raytrace.py:284-295): reference axis = z where |t_z| < 0.9 else y.
    """
    use_z = jnp.abs(t_hat[2]) < 0.9
    ax = jnp.zeros_like(t_hat[0])
    ay = jnp.where(use_z, 0.0, 1.0)
    az = jnp.where(use_z, 1.0, 0.0)
    # e1 = cross(a, t)
    e1 = jnp.stack([
        ay * t_hat[2] - az * t_hat[1],
        az * t_hat[0] - ax * t_hat[2],
        ax * t_hat[1] - ay * t_hat[0],
    ])
    e1 = e1 / (jnp.sqrt(jnp.sum(e1 * e1, axis=0)) + 1e-30)[None, :]
    # e2 = cross(t, e1)
    e2 = jnp.stack([
        t_hat[1] * e1[2] - t_hat[2] * e1[1],
        t_hat[2] * e1[0] - t_hat[0] * e1[2],
        t_hat[0] * e1[1] - t_hat[1] * e1[0],
    ])
    e2 = e2 / (jnp.sqrt(jnp.sum(e2 * e2, axis=0)) + 1e-30)[None, :]
    return e1, e2


def _step_with_crosssection(table, grid, r, k, dt, perturb_ratio):
    """One RK4 step + per-step cross-section ratio (3 ray advances)."""
    r_new, k_new = _rk4_step(table, grid, r, k, dt)
    r_diff = r_new - r
    dnorm = jnp.sqrt(jnp.sum(r_diff * r_diff, axis=0)) + 1e-32
    t_hat = r_diff / dnorm[None, :]
    e1, e2 = _transverse_basis(t_hat)
    eps = perturb_ratio * dnorm

    r1, _ = _rk4_step(table, grid, r + eps[None, :] * e1, k, dt)
    r2, _ = _rk4_step(table, grid, r + eps[None, :] * e2, k, dt)

    d1 = r1 - r_new
    d2 = r2 - r_new
    cx = d1[1] * d2[2] - d1[2] * d2[1]
    cy = d1[2] * d2[0] - d1[0] * d2[2]
    cz = d1[0] * d2[1] - d1[1] * d2[0]
    num = jnp.abs(cx * t_hat[0] + cy * t_hat[1] + cz * t_hat[2])
    s_ratio = num / (eps * eps + 1e-30)
    return r_new, k_new, s_ratio


def init_k_vectors(table, grid: UniformGrid, freq_hz, start, kdir):
    """Initial wave vectors: kc0 = sqrt(max(omega0^2 - omega_pe(start)^2, 0)).

    start, kdir: (n_rays, 3). Out-of-bounds / NaN omega_pe at the start is
    treated as 0 so the ray is not stuck (ref: gpu_raytrace.py:362-370).
    """
    start = jnp.asarray(start, jnp.float32)
    kdir = jnp.asarray(kdir, jnp.float32)
    v, _ = trilinear_packed(table, grid, start[:, 0], start[:, 1], start[:, 2])
    wpe0 = jnp.nan_to_num(v[:, 0], nan=0.0, posinf=0.0, neginf=0.0)
    omega0 = jnp.float32(2.0 * jnp.pi * freq_hz)
    kc0 = jnp.sqrt(jnp.maximum(omega0 * omega0 - wpe0 * wpe0, 0.0))
    return kdir * kc0[:, None]


@functools.partial(
    jax.jit,
    static_argnames=("grid", "n_steps", "record_stride", "trace_crosssections",
                     "s_mode", "record_k"),
)
def trace_rays(
    table,
    grid: UniformGrid,
    freq_hz,
    start,                       # (n_rays, 3) in R_sun
    kdir,                        # (n_rays, 3) unit direction
    dt: float,
    n_steps: int,
    record_stride: int = 10,
    trace_crosssections: bool = False,
    perturb_ratio: float = 2.0,
    s_mode: str = "cumulative",
    record_k: bool = False,
) -> TraceResult:
    """Trace all rays for n_steps; record every record_stride steps.

    `table` is pack_trace_table(omega_pe_cube, grid). Equivalent of the
    reference trace_ray dispatcher (gpu_raytrace.py:414-470) with the full
    loop fused on-device. Record i is taken after step 1 + i*record_stride
    (the reference's i % stride == 0 schedule, build_rays.py:204,241).
    """
    if s_mode not in ("cumulative", "per_step"):
        raise ValueError(f"unknown s_mode {s_mode!r}")
    n_records = -(-n_steps // record_stride)  # records at i % stride == 0

    k0 = init_k_vectors(table, grid, freq_hz, start, kdir)
    r = jnp.asarray(start, jnp.float32).T  # (3, n_rays)
    k = k0.T

    pr = jnp.float32(perturb_ratio)
    dt32 = jnp.float32(dt)

    def do_steps(carry, n):
        """Advance n steps, accumulating the segment S product."""
        def body(_, c):
            r, k, acc, last = c
            if trace_crosssections:
                r, k, s = _step_with_crosssection(table, grid, r, k, dt32, pr)
                acc = acc * s
                last = s
            else:
                r, k = _rk4_step(table, grid, r, k, dt32)
            return (r, k, acc, last)

        r, k, _, _ = carry
        ones = jnp.ones(r.shape[1], jnp.float32)
        out = jax.lax.fori_loop(0, n, body, (r, k, ones, ones))
        return out

    # Record 0 happens after a single step (loop index i=0 at
    # build_rays.py:204,241).
    r, k, seg_acc, seg_last = do_steps((r, k, None, None), 1)
    cum_s = seg_acc  # record-0 cumulative S (previous_cs = 1.0)
    rec0_s = cum_s if s_mode == "cumulative" else seg_last
    rec0_r = r.T
    rec0_k = k.T

    def scan_body(carry, _):
        r, k, cum_s = carry
        r, k, seg_acc, seg_last = do_steps((r, k, None, None), record_stride)
        cum_s = cum_s * seg_acc
        rec_s = cum_s if s_mode == "cumulative" else seg_last
        out = (r.T, rec_s) + ((k.T,) if record_k else ())
        return (r, k, cum_s), out

    k_record = None
    if n_records > 1:
        (r, k, _), outs = jax.lax.scan(
            scan_body, (r, k, cum_s), None, length=n_records - 1)
        rs, ss = outs[0], outs[1]
        r_record = jnp.concatenate([rec0_r[None], rs], axis=0)
        s_record = jnp.concatenate([rec0_s[None], ss], axis=0)
        if record_k:
            k_record = jnp.concatenate([rec0_k[None], outs[2]], axis=0)
    else:
        r_record = rec0_r[None]
        s_record = rec0_s[None]
        if record_k:
            k_record = rec0_k[None]

    if not trace_crosssections:
        s_record = jnp.ones_like(s_record)

    final_state = jnp.concatenate([r.T, k.T], axis=1)
    return TraceResult(r_record, s_record, final_state, k_record)


def trace_rays_from_cube(omega_pe_cube, x_grid, y_grid, z_grid, freq_hz,
                         x_start, y_start, z_start, kvec_in_norm, dt, n_steps,
                         record_stride=10, trace_crosssections=False,
                         perturb_ratio=2.0, s_mode="cumulative"):
    """Reference-signature convenience wrapper (ref: trace_ray,
    gpu_raytrace.py:414-470). Returns (r_record, s_record) as numpy-compatible
    jax arrays shaped like the reference ((n_records, n_rays, 3), list-like S).
    """
    import numpy as np

    grid = UniformGrid.from_arrays(x_grid, y_grid, z_grid)
    cube = jnp.asarray(np.nan_to_num(np.asarray(omega_pe_cube, np.float32)))
    table = pack_trace_table(cube, grid)
    start = jnp.stack([
        jnp.asarray(x_start, jnp.float32),
        jnp.asarray(y_start, jnp.float32),
        jnp.asarray(z_start, jnp.float32),
    ], axis=1)
    res = trace_rays(table, grid, float(freq_hz), start,
                     jnp.asarray(kvec_in_norm, jnp.float32), float(dt),
                     int(n_steps), int(record_stride),
                     bool(trace_crosssections), float(perturb_ratio), s_mode)
    return res.r_record, res.s_record
