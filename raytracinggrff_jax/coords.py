"""Coordinate conversions with the reference's exact orientation conventions.

The pipeline maps image-cube Cartesian (x, y, z) to MAS spherical coordinates
via the axis swap cart_to_sph(x, -z, y, phi0) — i.e. the MAS polar axis is the
image's +y axis and the observer looks down -z (ref: build_rays.py:93,
script/resample_with_ray_tracing.py:122, script/resampling_MAS_LOS.py:233).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def cart_to_sph(x, y, z, phi0_offset_deg=0.0, xp=jnp):
    """Cartesian -> spherical (r, colatitude [0, pi], longitude [0, 2pi)).

    Matches reference cart_to_sph (build_rays.py:35-45): lon gets a degree
    offset added, then is wrapped into [0, 2pi). Pass xp=numpy for host-side
    use (eager device dispatch costs a launch per array operation).
    """
    r = xp.sqrt(x ** 2 + y ** 2 + z ** 2)
    colat = xp.arccos(xp.clip(z / r, -1.0, 1.0))
    lon = xp.arctan2(y, x)
    lon = lon + phi0_offset_deg * np.pi / 180.0
    lon = xp.where(lon < 0, lon + 2.0 * np.pi, lon)
    return r, colat, lon


def sph_to_cart(r, colat, lon, xp=jnp):
    """Spherical -> Cartesian (ref: script/resampling_MAS_LOS.py:70-77)."""
    x = r * xp.sin(colat) * xp.cos(lon)
    y = r * xp.sin(colat) * xp.sin(lon)
    z = r * xp.cos(colat)
    return x, y, z


def image_xyz_to_mas_sph(x, y, z, phi0_offset_deg=0.0, xp=jnp):
    """Image-frame Cartesian -> MAS (r, colat, lon) with the (x, -z, y) swap.

    This is THE convention every resampler in the reference uses
    (build_rays.py:93). Returns (r, colat, lon) in radians.
    """
    return cart_to_sph(x, -z, y, phi0_offset_deg, xp=xp)
