"""Sample model fields (Ne, Te, |B|) along traced rays + segment lengths.

Equivalent of sample_model_with_rays (ref: gpu_raytrace.py:632-759) as one
jitted graph: trilinear gathers for the three fields share corner indices via
field packing, and the per-ray ds computation (distance between consecutive
*valid* samples, anchored at the ray start; ref: _compute_ds_from_valid,
gpu_raytrace.py:473-486) is a lax.scan carrying the last valid position.

Contract (ref: gpu_raytrace.py:644, 569-571):
    valid_mask = all(isfinite(pos)) & isfinite(s) & (s > 0)
    ne/te/b fills: out-of-bounds or non-finite field value -> fill_ne/te/b
    ds[t] = |p[t] - prev_valid| * r_sun_cm at valid t, else 0
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .constants import FILL_B, FILL_NE, FILL_TE, R_SUN_CM
from .grids import UniformGrid
from .ops.trilinear import pack_fields, trilinear_packed


class LosSamples(NamedTuple):
    ne: jax.Array          # (n_steps, n_rays)
    te: jax.Array
    b: jax.Array
    ds: jax.Array          # cm
    valid_mask: jax.Array  # bool
    s: jax.Array           # cross-section ratio as passed in
    cos_theta: jax.Array | None = None  # signed cos(B, k̂); None w/o bvec


def pack_model_table(ne_cube, te_cube, b_cube, bvec=None):
    """Pack the field cubes into one (N, C) gather table. With `bvec`
    (3 image-frame Cartesian B-component cubes) the table carries 6
    channels and the sampler also returns cos(theta) between B and the
    local propagation direction (theta_mode='los')."""
    if bvec is None:
        return pack_fields(ne_cube, te_cube, b_cube)
    return pack_fields(ne_cube, te_cube, b_cube, *bvec)


@functools.partial(jax.jit, static_argnames=("grid",))
def sample_model_with_rays(
    model_table,
    grid: UniformGrid,
    r_record,                  # (n_steps, n_rays, 3)
    s_arr,                     # (n_steps, n_rays)
    ray_start,                 # (n_rays, 3)
    r_sun_cm: float = R_SUN_CM,
    fill_ne: float = FILL_NE,
    fill_te: float = FILL_TE,
    fill_b: float = FILL_B,
    k_record=None,             # (n_steps, n_rays, 3) wave vectors at records
) -> LosSamples:
    pos = jnp.asarray(r_record, jnp.float32)
    s = jnp.asarray(s_arr, jnp.float32)
    ray_start = jnp.asarray(ray_start, jnp.float32)

    valid = (jnp.all(jnp.isfinite(pos), axis=-1)
             & jnp.isfinite(s) & (s > 0.0))

    v, _ = trilinear_packed(model_table, grid,
                            pos[..., 0], pos[..., 1], pos[..., 2])
    nch = v.shape[-1]
    fills = jnp.array([fill_ne, fill_te, fill_b] + [0.0] * (nch - 3),
                      jnp.float32)
    v = jnp.where(jnp.isfinite(v), v, fills)
    ne, te, b = v[..., 0], v[..., 1], v[..., 2]

    scale = jnp.float32(r_sun_cm)

    def ds_body(prev, step):
        p, ok = step            # p: (n_rays, 3), ok: (n_rays,)
        p_safe = jnp.where(ok[:, None], p, prev)
        d = jnp.sqrt(jnp.sum((p_safe - prev) ** 2, axis=-1)) * scale
        ds = jnp.where(ok, d, 0.0)
        return p_safe, ds

    _, ds = jax.lax.scan(ds_body, ray_start, (pos, valid))

    cos_t = None
    if nch >= 6:
        if k_record is not None:
            cos_t = cos_theta_signed(jnp.asarray(k_record, jnp.float32),
                                     v[..., 3:6])
        else:
            cos_t = _cos_theta_from_records(pos, v[..., 3:6])
    return LosSamples(ne=ne, te=te, b=b, ds=ds, valid_mask=valid, s=s,
                      cos_theta=cos_t)


def cos_theta_signed(kvec, bv):
    """Signed cos(theta) between the sampled B vector and the INSTANTANEOUS
    wave vector at the record step (trace_rays(record_k=True)). Zero B or
    zero k give cos = 0 -> the theta = 90 fallback (Parms[4], ref
    resample_with_ray_tracing.py:489-501)."""
    num = jnp.sum(bv * kvec, axis=-1)
    den = (jnp.sqrt(jnp.sum(bv * bv, axis=-1))
           * jnp.sqrt(jnp.sum(kvec * kvec, axis=-1)))
    return jnp.clip(num / jnp.maximum(den, 1e-30), -1.0, 1.0)


def _cos_theta_from_records(pos, bv):
    """Finite-difference fallback when no wave vectors exist: signed
    cos(theta) between the sampled B vector and the record-to-record
    direction (the last record reuses the previous direction). Only used
    for reference-style position-only records (sample_model_with_rays
    without k_record); the pipelines pass true wave vectors, which differ
    by O(curvature over a record stride) near turning points — enough to
    matter under gyroresonance. Zero-length segments or zero B give
    cos = 0 -> the theta = 90 fallback of the Parms[4] contract."""
    if pos.shape[0] > 1:
        d = pos[1:] - pos[:-1]
        dirs = jnp.concatenate([d, d[-1:]], axis=0)
    else:
        dirs = jnp.zeros_like(pos)
    num = jnp.sum(bv * dirs, axis=-1)
    den = (jnp.sqrt(jnp.sum(bv * bv, axis=-1))
           * jnp.sqrt(jnp.sum(dirs * dirs, axis=-1)))
    return jnp.clip(num / jnp.maximum(den, 1e-30), -1.0, 1.0)


def sample_model_with_rays_arrays(
    x_grid, y_grid, z_grid, ne_xyz, te_xyz, b_xyz,
    r_record, s_arr, ray_start, r_sun_cm=R_SUN_CM,
    fill_ne=FILL_NE, fill_te=FILL_TE, fill_b=FILL_B,
):
    """Reference-signature wrapper returning a dict like the reference
    dispatcher (gpu_raytrace.py:712-759)."""
    grid = UniformGrid.from_arrays(x_grid, y_grid, z_grid)
    table = pack_model_table(ne_xyz, te_xyz, b_xyz)
    out = sample_model_with_rays(table, grid, r_record, s_arr, ray_start,
                                 float(r_sun_cm), float(fill_ne),
                                 float(fill_te), float(fill_b))
    return {"ne": out.ne, "te": out.te, "b": out.b, "ds": out.ds,
            "valid_mask": out.valid_mask, "s": out.s}
