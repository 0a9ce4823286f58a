"""End-to-end imaging pipelines.

Three workflows mirroring the reference's capability surface:

  * run_ray_tracing_emission — the primary entry: resample the MAS model to
    device-resident cubes, trace N_pix^2 refractive rays, sample Ne/Te/|B| along
    them, run the GRFF transfer, convert to brightness temperature.
    (ref: script/resample_with_ray_tracing.py:154-549)
  * resample_mas_los — straight-LOS sampling baseline producing LOS_data
    arrays. (ref: script/resampling_MAS_LOS.py:100-309)
  * synthetic_ff — GRFF imaging from LOS data. (ref:
    script/synthetic_FF_map_single_thread.py:108-312)

Design: each heavy stage is one jitted device computation; nothing loops over
pixels on the host and there is no FFI. The reference's ProcessPoolExecutor
ray chunking (resample_with_ray_tracing.py:333-352) is replaced by sharding
the ray axis over the device mesh (see parallel/mesh.py) — XLA partitions the
same jitted graph over devices.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from .constants import (FPE_COEF, R_SUN_CM, R_SUN_M)
from .grids import UniformGrid, linear_z_grid, variable_z_grid
from .coords import image_xyz_to_mas_sph
from .mas.model import MASModel, resample_var_to_cube
from .sampler import pack_model_table, sample_model_with_rays
from .tracer import pack_trace_table, trace_rays
from .grff.transfer import get_mw_slice, log_spaced_freqs, tb_from_sfu


# ---------------------------------------------------------------------------
# Scene preparation
# ---------------------------------------------------------------------------

@jax.jit
def _finalize_cubes(ne_raw, te_raw, br, bt, bp):
    """Post-resampling cube transforms as one device computation
    (ref: resample_with_ray_tracing.py:269-293)."""
    ne_raw = jnp.nan_to_num(ne_raw, nan=0.0)
    br = jnp.nan_to_num(br, nan=0.0)
    bt = jnp.nan_to_num(bt, nan=0.0)
    bp = jnp.nan_to_num(bp, nan=0.0)
    ne = jnp.maximum(ne_raw, 0.0)
    omega_pe = FPE_COEF * jnp.sqrt(ne) * (2.0 * jnp.pi)
    omega_pe = jnp.nan_to_num(omega_pe, nan=0.0, posinf=0.0, neginf=0.0)
    te = jnp.where(jnp.isfinite(te_raw), te_raw, 1e4)
    b = jnp.sqrt(br * br + bt * bt + bp * bp)
    f32 = jnp.float32
    return (omega_pe.astype(f32), ne.astype(f32), te.astype(f32),
            b.astype(f32))


@functools.partial(jax.jit, static_argnames=("grid",))
def _bvec_image_cubes(br, bt, bp, grid: UniformGrid):
    """Rotate the resampled spherical B components into IMAGE-frame
    Cartesian cubes (bx, by, bz) on the uniform grid nodes.

    The MAS polar axis is the image +y axis and MAS Cartesian is
    (x, -z, y) of the image frame (coords.image_xyz_to_mas_sph,
    ref convention build_rays.py:93), so the spherical unit vectors at a
    node (x, y, z) expressed in the image frame are
        r̂ = (x, y, z)/r
        θ̂ = (x·y, -ρ², z·y) / (r·ρ),   ρ = sqrt(x² + z²)
        φ̂ = (z, 0, -x) / ρ
    and B_img = br·r̂ + bt·θ̂ + bp·φ̂. The longitude offset only selects
    WHICH MAS values were sampled; it does not enter the basis. Nodes on
    the polar axis (ρ = 0) get the (measure-zero) ρ -> eps limit."""
    xs, ys, zs = (np.asarray(a, np.float32) for a in grid.axes())
    x = jnp.asarray(xs)[:, None, None]
    y = jnp.asarray(ys)[None, :, None]
    z = jnp.asarray(zs)[None, None, :]
    r = jnp.sqrt(x * x + y * y + z * z)
    rho = jnp.sqrt(x * x + z * z)
    r_s = jnp.maximum(r, 1e-12)
    rho_s = jnp.maximum(rho, 1e-12)
    br = jnp.nan_to_num(br, nan=0.0)
    bt = jnp.nan_to_num(bt, nan=0.0)
    bp = jnp.nan_to_num(bp, nan=0.0)
    bx = br * (x / r_s) + bt * (x * y / (r_s * rho_s)) + bp * (z / rho_s)
    by = br * (y / r_s) + bt * (-rho / r_s)
    bz = br * (z / r_s) + bt * (z * y / (r_s * rho_s)) + bp * (-x / rho_s)
    f32 = jnp.float32
    return bx.astype(f32), by.astype(f32), bz.astype(f32)


def prepare_cubes(model: MASModel, grid: UniformGrid, phi0_offset_deg=0.0,
                  verbose=True, keep_bvec=False):
    """Resample the five MAS variables into the four pipeline cubes.

    Returns dict with omega_pe (rad/s), ne (cm^-3), te (K), b (G) as jnp
    float32 cubes (ref: resample_with_ray_tracing.py:267-293). With
    keep_bvec, also "bvec": image-frame Cartesian (bx, by, bz) component
    cubes for theta_mode='los' (the reference discards the B direction and
    hardwires theta = 90, resample_with_ray_tracing.py:489-501).
    """
    temp_var = model.temperature_variable()
    for v in ("br", "bt", "bp"):
        if v not in model.variables:
            raise ValueError(
                "Magnetic field components (br, bt, bp) not all found.")

    def log(msg):
        if verbose:
            print(msg)

    log(f"Resampling rho/{temp_var}/br/bt/bp -> cubes "
        f"({grid.nx}^3, phi0={phi0_offset_deg})...")
    # block after every stage: JAX dispatch is async and the runtime
    # reserves a program's output + temp buffers at enqueue time, so
    # without a sync the host runs ahead and the five resample programs'
    # multi-GB transients (meshgrid + spherical coords + corner gathers at
    # 576^3) overlap each other and the finalize/pack programs, multiplying
    # peak device memory. Serialized, each stage fits on its own. Cost: one
    # host sync per cube, once per scene.
    raw = []
    for v in ("rho", temp_var, "br", "bt", "bp"):
        c = resample_var_to_cube(model[v], grid, phi0_offset_deg,
                                 fill_nan=None)
        raw.append(jax.block_until_ready(c))
    omega_pe, ne, te, b = jax.block_until_ready(_finalize_cubes(*raw))
    cubes = {"omega_pe": omega_pe, "ne": ne, "te": te, "b": b}
    if keep_bvec:
        cubes["bvec"] = jax.block_until_ready(
            _bvec_image_cubes(raw[2], raw[3], raw[4], grid))
    return cubes


def image_ray_starts(n_pix, x_fov, z_observer):
    """Image-plane ray launch points and directions.

    z_start = sqrt(|(2 z_obs)^2 - x^2 - y^2|)/2, k = -z
    (ref: resample_with_ray_tracing.py:296-303). Pixel p = i*N + j maps to
    (y_i, x_j) — row-major over meshgrid(x, y) with 'xy' indexing.
    """
    xs = np.linspace(-x_fov, x_fov, n_pix)
    ys = np.linspace(-x_fov, x_fov, n_pix)
    X, Y = np.meshgrid(xs, ys)
    x_flat = X.ravel()
    y_flat = Y.ravel()
    z_start = np.sqrt(np.abs((z_observer * 2.0) ** 2
                             - x_flat ** 2 - y_flat ** 2)) / 2.0
    start = np.column_stack([x_flat, y_flat, z_start]).astype(np.float32)
    kdir = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_pix ** 2, 1))
    return xs, ys, start, kdir


# ---------------------------------------------------------------------------
# Primary pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RayEmissionConfig:
    """Flags of run_ray_tracing_emission (ref CLI table README.md:91-114)."""
    n_pix: int = 64
    x_fov: float = 1.44
    freq_hz: float = 75e6
    grid_n: int = 128
    grid_extent: float = 3.0
    z_observer: float = 3.0
    dt: float = 6e-3
    n_steps: int = 5000
    record_stride: int = 10
    s_input_on: bool = False
    nfreq: int = 1
    freq0: float | None = None
    freq_log_step: float = 0.0
    perturb_ratio: float = 2.0     # reference: 2 on CPU path, 5 on CUDA path
    phi0_offset: float = 0.0
    mechanism: int = 1 + 4         # free-free + neutral-H (Parms[6] contract)
    theta_deg: float = 90.0        # Parms[4] contract
    theta_mode: str = "fixed"      # 'fixed': theta_deg everywhere;
    # 'los': per-voxel theta(B, k̂) sampled along rays -> signed Stokes V
    gaunt: str = "dulk"            # free-free Gaunt: 'dulk' (reference
    # parity, default) | 'exact' (classical/Born, grff/physics.py)
    s_mode: str = "cumulative"     # GPU-reference S semantics;
    # 'per_step' reproduces the CPU reference (build_rays.py:241-244)


def run_ray_tracing_emission(model_path=None, config: RayEmissionConfig = None,
                             cubes=None, out_path=None, save_plots=False,
                             verbose=True, mesh=None, consider_beam=False,
                             beam_fwhm=0.2, patch_nan=False, timestep=0,
                             **overrides):
    """Full trace -> sample -> transfer pipeline.

    Either model_path (a MAS directory) or precomputed `cubes`
    (dict from prepare_cubes) must be given. Returns the reference's result
    dict: emission_cube (N,N,Nf) T_b in K, emission_polVI_cube,
    frequencies_Hz, x_coords/y_coords in meters — plus the sampled LOS
    diagnostics (ref result contract: resample_with_ray_tracing.py:533-541).

    consider_beam/beam_fwhm convolve the saved plot with a Gaussian beam
    (ref: resample_with_ray_tracing.py:618-639). patch_nan fills NaN pixels
    with nearest-finite-neighbor means before saving (the reference exports
    patch_nan_emission_map for exactly this but leaves calling it to the
    user, raytracingGRFF/util.py:6-77).
    """
    cfg = config or RayEmissionConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    def log(msg):
        if verbose:
            print(msg)

    if cfg.theta_mode not in ("fixed", "los"):
        raise ValueError(f"theta_mode must be 'fixed' or 'los', "
                         f"got {cfg.theta_mode!r}")
    need_bvec = cfg.theta_mode == "los"
    grid = UniformGrid.cube(cfg.grid_extent, cfg.grid_n)
    if cubes is None:
        model = MASModel(model_path, timestep=timestep)
        cubes = prepare_cubes(model, grid, cfg.phi0_offset, verbose=verbose,
                              keep_bvec=need_bvec)
    if need_bvec and "bvec" not in cubes:
        raise ValueError(
            "theta_mode='los' needs B-vector cubes: pass cubes from "
            "prepare_cubes(..., keep_bvec=True) or a model_path")

    xs, ys, start, kdir = image_ray_starts(cfg.n_pix, cfg.x_fov,
                                           cfg.z_observer)
    n_rays = start.shape[0]

    log(f"Ray tracing {n_rays} rays "
        f"({cfg.n_steps} steps, stride {cfg.record_stride})...")
    freq0 = cfg.freq0 if cfg.freq0 is not None else cfg.freq_hz
    frequencies_hz = log_spaced_freqs(freq0, cfg.nfreq, cfg.freq_log_step)
    pixel_size_cm = (2 * cfg.x_fov) / cfg.n_pix * R_SUN_CM
    pixel_area_cm2 = pixel_size_cm * pixel_size_cm

    trace_table = pack_trace_table(cubes["omega_pe"], grid)
    model_table = pack_model_table(cubes["ne"], cubes["te"], cubes["b"],
                                   bvec=cubes.get("bvec")
                                   if need_bvec else None)
    if mesh is not None:
        # rays shard over 'rays'; every device holds both gather tables
        from .parallel.mesh import replicate, shard_rays
        trace_table = replicate(trace_table, mesh)
        model_table = replicate(model_table, mesh)
        start = shard_rays(start, mesh)
        kdir = shard_rays(kdir, mesh)
    trace = trace_rays(trace_table, grid, cfg.freq_hz, start, kdir,
                       cfg.dt, cfg.n_steps, cfg.record_stride,
                       trace_crosssections=True,
                       perturb_ratio=cfg.perturb_ratio,
                       s_mode=cfg.s_mode, record_k=need_bvec)
    log("Sampling Ne/Te/B along rays...")
    sampled = sample_model_with_rays(model_table, grid, trace.r_record,
                                     trace.s_record, start,
                                     k_record=trace.k_record)
    log(f"GRFF transfer ({cfg.nfreq} freqs, "
        f"{'S on' if cfg.s_input_on else 'S off'})...")
    s_area = (sampled.s * jnp.float32(pixel_area_cm2)
              if cfg.s_input_on else None)
    theta = cfg.theta_deg
    if need_bvec:
        theta = jnp.degrees(jnp.arccos(sampled.cos_theta))
    res = get_mw_slice(sampled.ds, sampled.te, sampled.ne, sampled.b,
                       sampled.valid_mask, freq0, cfg.nfreq,
                       cfg.freq_log_step, pixel_area_cm2,
                       s_area_cm2=s_area, theta_deg=theta,
                       mechanism=cfg.mechanism, gaunt=cfg.gaunt)
    flux_o, flux_x = res.flux_o, res.flux_x

    intensity = flux_o + flux_x                              # (n_rays, Nf)
    pol_vi = (flux_o - flux_x) / (intensity + 1e-30)
    tb = tb_from_sfu(intensity, jnp.asarray(frequencies_hz, jnp.float32),
                     pixel_area_cm2)
    failed_px = ~np.isfinite(np.asarray(tb))   # pre-sanitization failures
    tb = jnp.nan_to_num(tb, nan=0.0, posinf=0.0, neginf=0.0)

    tb_h = np.asarray(tb, np.float64)
    pol_h = np.asarray(pol_vi, np.float64)
    emission_cube = tb_h.reshape(cfg.n_pix, cfg.n_pix, cfg.nfreq)
    pol_cube = pol_h.reshape(cfg.n_pix, cfg.n_pix, cfg.nfreq)
    if patch_nan:
        # patch only non-finite pixels (the reference's
        # patch_nan_emission_map contract): exact zeros can be legitimate
        # far-off-limb LOS that never intersect the cube
        from .utils.nanpatch import patch_nan_emission_map
        failed = failed_px.reshape(emission_cube.shape)
        emission_cube[failed] = np.nan
        emission_cube = patch_nan_emission_map(emission_cube)
        pol_cube[failed] = np.nan
        pol_cube = patch_nan_emission_map(pol_cube)

    result = {
        "emission_cube": emission_cube,
        "emission_polVI_cube": pol_cube,
        "frequencies_Hz": np.asarray(frequencies_hz),
        "x_coords": xs * R_SUN_M,
        "y_coords": ys * R_SUN_M,
    }
    if out_path:
        np.savez_compressed(out_path, **result)
        log(f"Saved {out_path}")

    result["_sampled"] = sampled
    if save_plots and out_path:
        from .utils.plotting import save_emission_plot, save_center_pixel_plot
        save_emission_plot(result, cfg.n_pix, cfg.x_fov, out_path,
                           consider_beam=consider_beam, beam_fwhm=beam_fwhm)
        save_center_pixel_plot(sampled, cfg.n_pix, out_path)
    return result


# ---------------------------------------------------------------------------
# Straight-LOS baseline pipeline
# ---------------------------------------------------------------------------

def resample_mas_los(model_path, n_pix=128, x_range=(-1.44, 1.44),
                     y_range=(-1.44, 1.44), n_z=400, dz0=3e-4,
                     variable_spacing_z=True, z_range=None,
                     phi0_offset=24.0, out_path=None, verbose=True,
                     timestep=0):
    """Straight-LOS resampling of the MAS model (no refraction).

    Geometry (ref: script/resampling_MAS_LOS.py:216-271): each pixel's LOS
    starts at the sphere surface (on-disk) or just behind the limb plane
    (off-disk) and marches toward the observer along +z with the irregular
    z grid; coordinates use cart_to_sph(x, -z, y, phi0).

    Returns the LOS_data dict: Ne_LOS/Te_LOS/B_LOS (NaN where invalid),
    ds_LOS in cm, x/y/z_coords in meters.
    """
    if variable_spacing_z:
        z_rsun, dz = variable_z_grid(n_z, dz0)
    else:
        z_rsun, dz = linear_z_grid(n_z, z_range or (0.0, 4.0))

    model = MASModel(model_path, timestep=timestep)
    temp_var = model.temperature_variable()

    xs = np.linspace(x_range[0], x_range[1], n_pix)
    ys = np.linspace(y_range[0], y_range[1], n_pix)
    X, Y = np.meshgrid(xs, ys)                       # X[i,j]=xs[j], Y[i,j]=ys[i]

    rho_sq = X ** 2 + Y ** 2
    z_start = np.where(
        rho_sq < 1.0,
        np.sqrt(np.maximum(1.0 - rho_sq, 0.0)) - 1e-6 / R_SUN_M,
        -np.sqrt(np.maximum(rho_sq - 1.0, 0.0)) - 1e-6 / R_SUN_M,
    )

    # full (n_pix, n_pix, n_z) coordinate block — host-side numpy (one
    # transfer, then the jitted sampling call below; eager per-op device
    # dispatch would cost a launch per array operation)
    Z = z_start[:, :, None] + z_rsun[None, None, :]
    Xb = np.broadcast_to(X[:, :, None], Z.shape).astype(np.float32)
    Yb = np.broadcast_to(Y[:, :, None], Z.shape).astype(np.float32)

    r, colat, lon = image_xyz_to_mas_sph(Xb, Yb, Z.astype(np.float32),
                                         phi0_offset, xp=np)
    valid = r >= 0.9999999
    r = jnp.asarray(r, jnp.float32)
    colat = jnp.asarray(colat, jnp.float32)
    lon = jnp.asarray(lon, jnp.float32)

    def sample(var):
        v = np.asarray(var.sample_sph(r, colat, lon), np.float64)
        v[~valid] = np.nan
        return v

    if verbose:
        print(f"Sampling LOS grid {n_pix}x{n_pix}x{n_z}...")
    ne = sample(model["rho"])
    te = sample(model[temp_var])
    b_sq = sum(sample(model[v]) ** 2 for v in ("br", "bt", "bp"))
    b = np.sqrt(b_sq)

    ds = np.broadcast_to(dz[None, None, :] * R_SUN_CM,
                         ne.shape).copy()

    if (np.isfinite(ne).sum() == 0 and np.isfinite(te).sum() == 0
            and np.isfinite(b).sum() == 0):
        raise RuntimeError(
            "All sampled LOS values are NaN. Check --dz0 units (R_sun); "
            "common mistake is 7e4 vs 7e-4.")

    result = {
        "Ne_LOS": ne, "Te_LOS": te, "B_LOS": b, "ds_LOS": ds,
        "x_coords": xs * R_SUN_M, "y_coords": ys * R_SUN_M,
        "z_coords": z_rsun * R_SUN_M,
    }
    if out_path:
        np.savez_compressed(out_path, **result)
        if verbose:
            print(f"LOS data saved to {out_path}")
    return result


def synthetic_ff(los_data, freq0, nfreq, freq_log_step, out_path=None,
                 mechanism=1 + 4, verbose=True):
    """GRFF imaging from LOS data (straight-LOS baseline).

    los_data: dict or path to LOS npz (resample_mas_los output). Returns the
    emission dict (ref contract: synthetic_FF_map_single_thread.py:108-312).
    """
    if isinstance(los_data, (str, Path)):
        los_data = dict(np.load(los_data))
    ne = los_data["Ne_LOS"]
    te = los_data["Te_LOS"]
    b = los_data["B_LOS"]
    ds = los_data["ds_LOS"]
    x_coords = los_data["x_coords"]
    y_coords = los_data["y_coords"]

    n_pix = ne.shape[0]
    n_z = ne.shape[2]
    valid = ~(np.isnan(ne) | np.isnan(te) | np.isnan(b))

    pixel_size_cm = (x_coords[1] - x_coords[0]) / R_SUN_M * R_SUN_CM
    pixel_area_cm2 = pixel_size_cm * pixel_size_cm
    frequencies_hz = log_spaced_freqs(freq0, nfreq, freq_log_step)

    def to_zpix(a):
        return np.ascontiguousarray(
            a.reshape(n_pix * n_pix, n_z).T)

    if verbose:
        print(f"GRFF transfer: {n_pix}x{n_pix} pixels, {n_z} voxels, "
              f"{nfreq} freqs...")
    res = get_mw_slice(
        to_zpix(np.nan_to_num(ds)), to_zpix(np.nan_to_num(te, nan=1e4)),
        to_zpix(np.nan_to_num(ne)), to_zpix(np.nan_to_num(b)),
        to_zpix(valid.astype(np.float32)) > 0.5,
        freq0, nfreq, freq_log_step, pixel_area_cm2, mechanism=mechanism)

    intensity = np.asarray(res.flux_o + res.flux_x, np.float64)
    pol = np.asarray((res.flux_o - res.flux_x), np.float64) / (intensity + 1e-30)
    tb = np.asarray(tb_from_sfu(intensity,
                                np.asarray(frequencies_hz)[None, :],
                                pixel_area_cm2))
    result = {
        "emission_cube": tb.reshape(n_pix, n_pix, nfreq),
        "emission_polVI_cube": pol.reshape(n_pix, n_pix, nfreq),
        "frequencies_Hz": np.asarray(frequencies_hz),
        "x_coords": x_coords, "y_coords": y_coords,
    }
    if out_path:
        np.savez_compressed(str(out_path) + ".npz"
                            if not str(out_path).endswith(".npz")
                            else out_path, **result)
        if verbose:
            print(f"Saved {out_path}")
    return result
