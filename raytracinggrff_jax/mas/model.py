"""MAS coronal model loading, unit conversion, and spherical sampling.

Replaces the psipy stack (MASOutput / Variable.sample_at_coords,
ref: script/resampling_MAS_LOS.py:21-24, 254-263) with a self-contained
reader (mas/hdf4.py or h5py) and a jit-compatible nonuniform trilinear
interpolator in MAS spherical coordinates (phi periodic, theta clamped to the
half-mesh edges, r out-of-range -> NaN).

File discovery matches load_mas_var_filtered: only names matching
{var}\\d{3}.hdf (or .h5) are used (ref: build_rays.py:48-66).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from ..constants import MAS_UNITS, R_MIN
from ..coords import image_xyz_to_mas_sph
from ..grids import UniformGrid
from .hdf4 import read_hdf4_sds, write_hdf4_sds


def _identify_axes(shape, scales):
    """Map the 3 dimension scales to (phi, theta, r) axis indices.

    MAS stores fields on a (phi, theta, r) mesh; identify axes by value
    ranges: r >= ~0.9 R_sun ascending past 1; theta within [0, pi];
    phi within [0, 2pi] with max > pi.
    """
    cand = {"r": None, "theta": None, "phi": None}
    for i, s in enumerate(scales):
        if s is None:
            raise ValueError("MAS dataset missing a dimension scale")
        s = np.asarray(s, np.float64)
        smin, smax = float(s.min()), float(s.max())
        if smin >= 0.8 and smax > 1.001 and smax < 100.0:
            cand["r"] = i
        elif smax <= np.pi + 1e-6:
            cand["theta"] = i
        elif smax <= 2 * np.pi + 1e-6:
            cand["phi"] = i
    if None in cand.values():
        raise ValueError(
            f"could not identify (phi, theta, r) axes from scales "
            f"(shape={shape}, ranges="
            f"{[(float(np.min(s)), float(np.max(s))) for s in scales]})")
    return cand["phi"], cand["theta"], cand["r"]


class MASVariable:
    """One MAS field in physical units on its native spherical mesh."""

    def __init__(self, name, data, phi, theta, r, unit_factor=None):
        if unit_factor is None:
            unit_factor = MAS_UNITS.get(name, 1.0)
        self.name = name
        # store as (nphi+1, ntheta, nr) with the phi axis padded periodically
        data = np.asarray(data, np.float64) * unit_factor
        phi = np.asarray(phi, np.float64)
        self.phi = np.concatenate([phi, [phi[0] + 2 * np.pi]])
        self.theta = np.asarray(theta, np.float64)
        self.r = np.asarray(r, np.float64)
        self.data = np.concatenate([data, data[:1]], axis=0)
        self._dev = None

    @classmethod
    def from_file(cls, path, name):
        path = Path(path)
        if path.suffix in (".h5", ".hdf5"):
            import h5py
            with h5py.File(path, "r") as f:
                key = "Data" if "Data" in f else list(f.keys())[0]
                data = np.asarray(f[key])
                scales = []
                for i in range(3):
                    dn = f"dim{i+1}"
                    scales.append(np.asarray(f[dn]) if dn in f else None)
                if any(s is None for s in scales):
                    # try attached dimension scales
                    scales = [np.asarray(f[key].dims[i][0])
                              if f[key].dims[i] else None for i in range(3)]
        else:
            sds = read_hdf4_sds(path)[0]
            data, scales = sds.data, sds.scales
        ip, it, ir = _identify_axes(data.shape, scales)
        data = np.transpose(data, (ip, it, ir))
        return cls(name, data, scales[ip], scales[it], scales[ir])

    def device_arrays(self, dtype=jnp.float32):
        if self._dev is None:
            self._dev = (
                jnp.asarray(self.data, dtype),
                jnp.asarray(self.phi, dtype),
                jnp.asarray(self.theta, dtype),
                jnp.asarray(self.r, dtype),
            )
        return self._dev

    def sample_at_coords(self, lon_deg, lat_deg, r_rsun):
        """psipy-compatible signature: longitude/latitude in degrees,
        radius in R_sun (ref usage: script/resampling_MAS_LOS.py:254-263).
        Returns values in physical units (the unit conversion the reference
        applies via astropy .to() is already baked into self.data)."""
        import numpy as _np
        lon = _np.deg2rad(_np.asarray(lon_deg))
        colat = _np.pi / 2 - _np.deg2rad(_np.asarray(lat_deg))
        return self.sample_sph(jnp.asarray(r_rsun, jnp.float32),
                               jnp.asarray(colat, jnp.float32),
                               jnp.asarray(lon, jnp.float32))

    def sample_sph(self, r_q, colat_q, phi_q):
        """Trilinear sample at spherical coords (jax arrays, any shape).

        phi periodic; theta clamped to mesh edges; r outside [r0, r1] -> NaN
        (the reference masks r < R_MIN before sampling anyway,
        build_rays.py:96).
        """
        data, phi, theta, r = self.device_arrays()
        import jax.numpy as _jnp
        return _interp_sph_jit(data, phi, theta, r,
                               _jnp.asarray(r_q, _jnp.float32),
                               _jnp.asarray(colat_q, _jnp.float32),
                               _jnp.asarray(phi_q, _jnp.float32))


import jax as _jax


@_jax.jit
def _interp_sph_jit(data, phi, theta, r, r_q, colat_q, phi_q):
    return _interp_sph(data, phi, theta, r, r_q, colat_q, phi_q)


def _axis_locate(ax, q, clamp):
    """Cell index + fraction on a 1D ascending nonuniform axis."""
    n = ax.shape[0]
    i = jnp.clip(jnp.searchsorted(ax, q, side="right") - 1, 0, n - 2)
    t = (q - ax[i]) / (ax[i + 1] - ax[i])
    if clamp:
        t = jnp.clip(t, 0.0, 1.0)
    return i, t


def _interp_sph(data, phi, theta, r, r_q, colat_q, phi_q):
    phi_q = jnp.mod(phi_q, 2 * jnp.pi)
    shape = jnp.shape(r_q)
    r_q = jnp.ravel(r_q)
    colat_q = jnp.ravel(colat_q)
    phi_q = jnp.ravel(phi_q)

    ip, tp = _axis_locate(phi, phi_q, clamp=True)
    it, tt = _axis_locate(theta, colat_q, clamp=True)
    ir, tr = _axis_locate(r, r_q, clamp=True)

    oob = (r_q < r[0] - 1e-9) | (r_q > r[-1] + 1e-9) | ~jnp.isfinite(r_q)

    ntheta, nr = data.shape[1], data.shape[2]
    flat = data.reshape(-1)
    base = (ip * ntheta + it) * nr + ir

    def take(off):
        return jnp.take(flat, base + off)

    sp = ntheta * nr
    st = nr
    c000 = take(0)
    c100 = take(sp)
    c010 = take(st)
    c110 = take(sp + st)
    c001 = take(1)
    c101 = take(sp + 1)
    c011 = take(st + 1)
    c111 = take(sp + st + 1)

    c00 = c000 * (1 - tp) + c100 * tp
    c10 = c010 * (1 - tp) + c110 * tp
    c01 = c001 * (1 - tp) + c101 * tp
    c11 = c011 * (1 - tp) + c111 * tp
    c0 = c00 * (1 - tt) + c10 * tt
    c1 = c01 * (1 - tt) + c11 * tt
    v = c0 * (1 - tr) + c1 * tr
    v = jnp.where(oob, jnp.nan, v)
    return v.reshape(shape)


class MASModel:
    """MAS model directory: lazy per-variable loading with file filtering.

    Equivalent of psipy MASOutput + load_mas_var_filtered
    (ref: build_rays.py:48-66). The reference concatenates multi-timestep
    directories along a time axis and then samples one step; here time is
    an explicit index instead of a hidden array axis: `timestep` selects
    which {var}NNN file each variable loads (default: first), `n_timesteps`
    reports how many exist, and `at_time(i)` gives a same-directory view at
    another step for iterating a time series.
    """

    def __init__(self, path, timestep=0):
        self.path = Path(path)
        if not self.path.is_dir():
            raise FileNotFoundError(f"MAS model directory not found: {path}")
        self.timestep = int(timestep)
        self._cache = {}

    @property
    def variables(self):
        names = set()
        for f in self.path.iterdir():
            m = re.match(r"^([a-z]+)\d{3}\.(hdf|h5|hdf5)$", f.name)
            if m:
                names.add(m.group(1))
        return sorted(names)

    def files_for(self, var_name):
        pattern = re.compile(rf"^{var_name}\d{{3}}\.(hdf|h5|hdf5)$")
        return sorted(f for f in self.path.iterdir() if pattern.match(f.name))

    def n_timesteps(self, var_name) -> int:
        return len(self.files_for(var_name))

    def at_time(self, timestep) -> "MASModel":
        """View of the same directory at another timestep (lazy, own cache)."""
        return MASModel(self.path, timestep=timestep)

    def __getitem__(self, var_name) -> MASVariable:
        key = (var_name, self.timestep)
        if key not in self._cache:
            files = self.files_for(var_name)
            if not files:
                raise KeyError(f"MAS variable {var_name!r} not found "
                               f"in {self.path}")
            if not 0 <= self.timestep < len(files):
                raise IndexError(
                    f"timestep {self.timestep} out of range: {var_name} "
                    f"has {len(files)} timestep file(s)")
            self._cache[key] = MASVariable.from_file(
                files[self.timestep], var_name)
        return self._cache[key]

    def temperature_variable(self):
        """'te' preferred over 't' (ref: resample_with_ray_tracing.py:254-259)."""
        for v in ("te", "t"):
            if v in self.variables:
                return v
        raise ValueError("No electron temperature variable (te or t) found.")


def load_mas_var(model: MASModel, var_name: str) -> MASVariable:
    return model[var_name]


import functools as _functools


@_functools.partial(_jax.jit, static_argnames=("grid", "fill", "chunk"))
def _resample_cube_jit(data, phi, theta, r_ax, grid: UniformGrid,
                       phi0_offset_deg, fill, chunk=16):
    """Resample one MAS variable onto the cube, streamed in x-slabs.

    The one-shot version materialized ~20 cube-sized intermediates at once
    (meshgrid + spherical coords + axis indices/fractions + 8 corner
    gathers + lerp chain), i.e. ~15 GB at 576^3 per variable, and a
    sweep keeps up to three result cubes resident beside it. The
    fori_loop bounds transients to ~20 slab-sized buffers (~0.4 GB at
    chunk=16 and 576^2) and XLA updates the carried output in place; when
    nx % chunk != 0 the last slab's start is clamped and the overlap rows
    are rewritten with identical values."""
    nx, ny, nz = grid.shape
    xs_h, ys_h, zs_h = grid.axes()
    xs = jnp.asarray(xs_h, jnp.float32)
    ys = jnp.asarray(ys_h, jnp.float32)
    zs = jnp.asarray(zs_h, jnp.float32)
    ck = min(chunk, nx)
    n_chunks = -(-nx // ck)
    out = jnp.zeros((nx, ny, nz), jnp.float32)

    def body(i, out):
        x0 = jnp.minimum(i * ck, nx - ck)
        xsl = _jax.lax.dynamic_slice(xs, (x0,), (ck,))
        shape = (ck, ny, nz)
        x = jnp.broadcast_to(xsl[:, None, None], shape)
        y = jnp.broadcast_to(ys[None, :, None], shape)
        z = jnp.broadcast_to(zs[None, None, :], shape)
        r, colat, lon = image_xyz_to_mas_sph(x, y, z, phi0_offset_deg)
        vals = _interp_sph(data, phi, theta, r_ax,
                           jnp.broadcast_to(r, shape),
                           jnp.broadcast_to(colat, shape),
                           jnp.broadcast_to(lon, shape))
        vals = jnp.where(r >= R_MIN, vals, jnp.nan)
        if fill:
            vals = jnp.where(jnp.isfinite(vals), vals,
                             jnp.float32(fill[0]))
        return _jax.lax.dynamic_update_slice(
            out, vals.astype(jnp.float32), (x0, 0, 0))

    return _jax.lax.fori_loop(0, n_chunks, body, out)


def resample_var_to_cube(var: MASVariable, grid: UniformGrid,
                         phi0_offset_deg=0.0, fill_nan=0.0):
    """Resample a MAS variable onto a regular xyz cube with the reference's
    orientation convention cart_to_sph(x, -z, y, phi0) and r >= R_MIN mask
    (ref: resample_to_xyz_cube build_rays.py:69-125 /
    resample_var_to_cube script/resample_with_ray_tracing.py:110-151).

    Runs as one jitted device computation instead of the reference's
    per-x-slice psipy loop. fill_nan=None keeps NaN.
    """
    data, phi, theta, r_ax = var.device_arrays()
    fill = None if fill_nan is None else (float(fill_nan),)
    return _resample_cube_jit(data, phi, theta, r_ax, grid,
                              jnp.float32(phi0_offset_deg), fill)


def synthetic_mas_model(path, nphi=64, ntheta=55, nr=60, r_max=6.0,
                        b0_gauss=2.5, modulated=True, timestep=2):
    """Write a synthetic MAS model (rho/t/br/bt/bp HDF4 files) for tests and
    demos: Newkirk-like density, ~1.4 MK corona, dipole field.

    Density: n_e(r) = 4.2e4 * 10^(4.32/r) cm^-3, optionally modulated by
    (1 + 0.3 cos(2 phi) sin^2 theta) to make longitude/latitude structure
    visible in images.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    phi = np.linspace(0, 2 * np.pi, nphi, endpoint=False)
    # half-mesh-like theta avoiding exact poles
    theta = np.linspace(0.02, np.pi - 0.02, ntheta)
    r = 1.0 + (r_max - 1.0) * (np.linspace(0, 1, nr) ** 1.5)

    P, T, R = np.meshgrid(phi, theta, r, indexing="ij")
    ne = 4.2e4 * 10 ** (4.32 / R)
    if modulated:
        ne = ne * (1.0 + 0.3 * np.cos(2 * P) * np.sin(T) ** 2)
    te = 1.4e6 * (1.0 - 0.25 * np.exp(-(R - 1.0) / 0.3)) * np.ones_like(ne)
    br = 2 * b0_gauss * np.cos(T) / R ** 3
    bt = b0_gauss * np.sin(T) / R ** 3
    bp = 0.1 * b0_gauss * np.sin(T) / R ** 3

    fields = {
        "rho": ne / MAS_UNITS["rho"],
        "t": te / MAS_UNITS["t"],
        "br": br / MAS_UNITS["br"],
        "bt": bt / MAS_UNITS["bt"],
        "bp": bp / MAS_UNITS["bp"],
    }
    for name, cube in fields.items():
        write_hdf4_sds(path / f"{name}{timestep:03d}.hdf",
                       cube.astype(np.float32), scales=[phi, theta, r],
                       label=name)
    return path
