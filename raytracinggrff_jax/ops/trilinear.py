"""Trilinear cube sampling on uniform grids as batched gathers.

Layout decisions:
  * All C fields that are sampled at the same positions are packed into one
    (nx*ny*nz, C) array so the 8 corner gathers are shared across fields
    (the reference does 8 gathers *per field*: gpu_raytrace.py:102-158 for the
    trace cube + 3 gradient cubes, and again per Ne/Te/B field at sampling).
  * Positions are component arrays (px, py, pz) of identical shape; inside the
    tracer these are contiguous (n_rays,) vectors.

Semantics exactly mirror the CUDA kernels (gpu_raytrace.py:102-158, 538-629):
  * out-of-bounds (fx < 0 or fx > n-1 in any axis) -> NaN (caller chooses fill)
  * corner index clamped to n-2, fractional weight clamped to [0, 1]
  * float32 arithmetic
"""

from __future__ import annotations

import jax.numpy as jnp

from ..grids import UniformGrid


def pack_fields(*cubes, dtype=jnp.float32):
    """Stack C cubes of identical (nx, ny, nz) shape into (nx*ny*nz, C)."""
    flat = [jnp.asarray(c, dtype).reshape(-1) for c in cubes]
    return jnp.stack(flat, axis=-1)


def _corner_weights(grid: UniformGrid, px, py, pz):
    """Compute base corner flat index, trilinear weights, and in-bounds mask."""
    inv_dx, inv_dy, inv_dz = grid.inv_steps
    fx = (px - grid.x0) * inv_dx
    fy = (py - grid.y0) * inv_dy
    fz = (pz - grid.z0) * inv_dz

    nx, ny, nz = grid.shape
    inb = (
        (fx >= 0.0) & (fy >= 0.0) & (fz >= 0.0)
        & (fx <= nx - 1) & (fy <= ny - 1) & (fz <= nz - 1)
    )

    i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
    j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
    k0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 2)

    tx = jnp.clip(fx - i0.astype(fx.dtype), 0.0, 1.0)
    ty = jnp.clip(fy - j0.astype(fy.dtype), 0.0, 1.0)
    tz = jnp.clip(fz - k0.astype(fz.dtype), 0.0, 1.0)

    base = (i0 * ny + j0) * nz + k0
    return base, tx, ty, tz, inb


def trilinear_packed(packed, grid: UniformGrid, px, py, pz):
    """Sample a packed (N, C) field table at positions (px, py, pz).

    Returns (values, inbounds) with values shape (*pos_shape, C); out-of-bounds
    positions get NaN values (matching the CUDA trace kernel's nanf return,
    gpu_raytrace.py:113-114). NaN positions propagate to NaN values.
    """
    # no flattening: a reshape of (records, rays) positions would merge a
    # sharded ray axis into a dimension that can only be replicated
    base, tx, ty, tz, inb = _corner_weights(grid, px, py, pz)
    # NaN positions produce garbage indices after astype; force a safe index.
    base = jnp.where(inb, base, 0)

    sx = grid.ny * grid.nz
    sy = grid.nz

    def take(off):
        return jnp.take(packed, base + off, axis=0)

    c000 = take(0)
    c100 = take(sx)
    c010 = take(sy)
    c110 = take(sx + sy)
    c001 = take(1)
    c101 = take(sx + 1)
    c011 = take(sy + 1)
    c111 = take(sx + sy + 1)

    tx = tx[..., None]
    ty = ty[..., None]
    tz = tz[..., None]

    c00 = c000 * (1.0 - tx) + c100 * tx
    c10 = c010 * (1.0 - tx) + c110 * tx
    c01 = c001 * (1.0 - tx) + c101 * tx
    c11 = c011 * (1.0 - tx) + c111 * tx
    c0 = c00 * (1.0 - ty) + c10 * ty
    c1 = c01 * (1.0 - ty) + c11 * ty
    v = c0 * (1.0 - tz) + c1 * tz

    v = jnp.where(inb[..., None], v, jnp.nan)
    return v, inb


def trilinear_sample(cube, grid: UniformGrid, px, py, pz, fill_value=jnp.nan):
    """Sample one cube; non-finite results (OOB or NaN field) -> fill_value.

    Matches the LOS sample kernel contract (gpu_raytrace.py:581-627).
    """
    packed = cube.reshape(-1, 1) if cube.ndim == 3 else cube
    v, inb = trilinear_packed(packed, grid, px, py, pz)
    v = v[..., 0]
    v = jnp.where(jnp.isfinite(v), v, fill_value)
    return v, inb
