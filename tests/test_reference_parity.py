"""Independent parity against the ACTUAL reference implementation.

Every other parity test in this repo compares the JAX stack to oracles built
from the same formulas by the same author (grff/reference.py, float64 numpy),
which cannot catch a shared semantic error. This suite instead imports the
real CPU reference from /root/reference — `ray_trace`
(raytracingGRFF/build_rays.py:128-248), `sample_model_with_rays`
(raytracingGRFF/gpu_raytrace.py:632-651,712-759) and
`patch_nan_emission_map` (raytracingGRFF/util.py:6-77) — runs both stacks on
the same synthetic cubes, and asserts:

  * r_record trajectory parity (refracting, escaping, and frozen rays)
  * per-step cross-section S parity (s_mode='per_step' vs
    build_rays.py:241-244)
  * LOS sampler parity: ne/te/b/ds/valid_mask including injected s=0,
    s=NaN, NaN-position and out-of-bounds records
  * end-to-end T_b parity of the trace+sample stages: the same GRFF
    transfer fed by reference-produced vs JAX-produced LOS data
  * NaN patcher exact equality (sequential in-pass propagation order)

plus a canary proving the trajectory test has teeth: a deliberately injected
gradient sign flip (the _rhs dk/dt term) must blow past the tolerance.

Skipped wholesale when /root/reference is not checked out.
"""

import pathlib
import sys

import numpy as np
import pytest

REF_ROOT = pathlib.Path("/root/reference")
if not (REF_ROOT / "raytracingGRFF" / "build_rays.py").exists():
    pytest.skip("reference checkout /root/reference not present",
                allow_module_level=True)

if str(REF_ROOT) not in sys.path:
    sys.path.insert(0, str(REF_ROOT))

from raytracingGRFF import build_rays as ref_build_rays  # noqa: E402
from raytracingGRFF import gpu_raytrace as ref_gpu  # noqa: E402
from raytracingGRFF import util as ref_util  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from raytracinggrff_jax.grff.transfer import get_mw_slice, tb_from_sfu  # noqa: E402
from raytracinggrff_jax.grids import UniformGrid  # noqa: E402
from raytracinggrff_jax.sampler import sample_model_with_rays_arrays  # noqa: E402
from raytracinggrff_jax.tracer import (  # noqa: E402
    pack_trace_table, trace_rays, trace_rays_from_cube)
from raytracinggrff_jax.utils.nanpatch import patch_nan_emission_map  # noqa: E402


# ---------------------------------------------------------------------------
# Shared synthetic scene: exponential omega_pe sphere (the reference's own
# notebook fixture family, script/pub/cross_section_plots.ipynb cell 3:
# omega_pe = 2*pi * 82 MHz * exp(-0.6 (r - 1))), smooth Ne/Te/B fields.
# ---------------------------------------------------------------------------

GRID_N = 49
EXTENT = 2.0
FREQ_HZ = 60e6          # reflects where omega_pe = omega0 -> r ~ 1.5
DT = 1.0e-2
N_STEPS = 600
STRIDE = 10
R_SUN_CM = 6.957e10


def _scene():
    g = np.linspace(-EXTENT, EXTENT, GRID_N)
    xg, yg, zg = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(xg**2 + yg**2 + zg**2)
    omega_pe = 2 * np.pi * 82e6 * np.exp(-0.6 * (r - 1.0))
    ne = 1.0e8 * np.exp(-2.0 * (r - 1.0))
    te = 1.0e6 * (1.0 + 0.1 * xg / EXTENT + 0.05 * yg / EXTENT)
    b = 2.0 + zg / EXTENT
    return g, omega_pe, ne, te, b


def _rays():
    """Mixed bag: on-disk (reflect), limb (graze), off-limb (straight
    through), plus one ray aimed out of the cube (freezes quickly)."""
    x0 = np.array([0.0, 0.3, 0.8, 1.2, 1.6, -0.5, -1.1, 0.05])
    y0 = np.array([0.0, -0.2, 0.4, 0.9, -1.3, 0.6, -0.8, 1.5])
    z0 = np.full_like(x0, 1.9)
    kdir = np.tile(np.array([[0.0, 0.0, -1.0]]), (x0.size, 1))
    # the escape ray: starts near the +x face moving +x, leaves the cube
    x0 = np.append(x0, 1.95)
    y0 = np.append(y0, 0.0)
    z0 = np.append(z0, 0.0)
    kdir = np.vstack([kdir, np.array([[1.0, 0.0, 0.0]])])
    return x0, y0, z0, kdir


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def ref_trace(scene):
    g, omega_pe, _, _, _ = scene
    x0, y0, z0, kdir = _rays()
    r_rec, s_rec = ref_build_rays.ray_trace(
        omega_pe, g, g, g, FREQ_HZ, x0, y0, z0, kdir,
        dt=DT, n_steps=N_STEPS, record_stride=STRIDE,
        trace_crosssections=True, perturb_ratio=2)
    return np.asarray(r_rec), np.asarray(s_rec)


@pytest.fixture(scope="module")
def jax_trace(scene):
    g, omega_pe, _, _, _ = scene
    x0, y0, z0, kdir = _rays()
    r_rec, s_rec = trace_rays_from_cube(
        omega_pe, g, g, g, FREQ_HZ, x0, y0, z0, kdir,
        dt=DT, n_steps=N_STEPS, record_stride=STRIDE,
        trace_crosssections=True, perturb_ratio=2.0, s_mode="per_step")
    return np.asarray(r_rec), np.asarray(s_rec)


def test_trajectory_parity_vs_reference(ref_trace, jax_trace):
    """r_record of the float32 JAX tracer vs the float64 scipy reference.

    Frozen entries are NaN in the reference (RegularGridInterpolator OOB)
    but hold the last in-bounds position here; compare where the reference
    is finite."""
    r_ref, _ = ref_trace
    r_jax, _ = jax_trace
    assert r_ref.shape == r_jax.shape == (N_STEPS // STRIDE, 9, 3)

    finite = np.isfinite(r_ref).all(axis=2)
    assert finite.any(axis=0).all(), "every ray must have finite records"
    err = np.linalg.norm(r_jax - r_ref, axis=2)
    max_err = np.nanmax(np.where(finite, err, 0.0))
    # float32 vs float64 over 600 RK4 steps through a refracting sphere
    assert max_err < 2e-3, f"trajectory diverged: max |dr| = {max_err}"

    # escape ray semantics: reference rhs freezes the state (zero derivs)
    # once the interpolator returns NaN -> its recorded positions stop
    # moving; ours must stop at the same place
    moved_ref = np.linalg.norm(np.diff(np.nan_to_num(r_ref[:, -1]), axis=0),
                               axis=1)
    moved_jax = np.linalg.norm(np.diff(r_jax[:, -1], axis=0), axis=1)
    frozen_from_ref = np.argmax(moved_ref < 1e-9)
    frozen_from_jax = np.argmax(moved_jax < 1e-9)
    assert abs(int(frozen_from_ref) - int(frozen_from_jax)) <= 1


def test_trajectory_parity_has_teeth(scene, ref_trace):
    """Canary: flipping the sign of the dk/dt gradient term (the _rhs
    contract) must blow the tolerance of the trajectory test by orders of
    magnitude — otherwise the parity test proves nothing."""
    g, omega_pe, _, _, _ = scene
    x0, y0, z0, kdir = _rays()
    grid = UniformGrid.from_arrays(g, g, g)
    table = pack_trace_table(jnp.asarray(omega_pe, jnp.float32), grid)
    # negate the three gradient channels == sign-flip dk/dt in _rhs
    flipped = jnp.concatenate([table[:, :1], -table[:, 1:4]], axis=1)
    start = jnp.asarray(np.stack([x0, y0, z0], axis=1), jnp.float32)
    res = trace_rays(flipped, grid, FREQ_HZ, start,
                     jnp.asarray(kdir, jnp.float32), DT, N_STEPS, STRIDE,
                     trace_crosssections=False)
    r_ref, _ = ref_trace
    finite = np.isfinite(r_ref).all(axis=2)
    err = np.linalg.norm(np.asarray(res.r_record) - r_ref, axis=2)
    max_err = np.nanmax(np.where(finite, err, 0.0))
    assert max_err > 0.05, (
        "sign-flipped gradient stayed within tolerance -> the parity test "
        f"has no teeth (max err {max_err})")


def test_per_step_s_parity(ref_trace, jax_trace):
    """Cross-section S, per-step semantics (build_rays.py:241-244).

    S is a second-derivative quantity of a chaotic map, so compare in
    relative terms where the reference is finite and the ray is still
    inside the cube."""
    _, s_ref = ref_trace
    r_ref, _ = ref_trace
    _, s_jax = jax_trace
    assert s_ref.shape == s_jax.shape

    finite = np.isfinite(s_ref) & np.isfinite(r_ref).all(axis=2)
    assert finite.sum() > 0.5 * s_ref.size
    rel = np.abs(s_jax - s_ref) / np.maximum(np.abs(s_ref), 1e-6)
    # early/mid records must agree tightly; allow the worst late-time
    # chaotic tail more slack but keep the bulk pinned
    assert np.median(rel[finite]) < 1e-3
    assert np.quantile(rel[finite], 0.95) < 3e-2


@pytest.fixture(scope="module")
def los_inputs(scene, ref_trace):
    """One shared (records, s) pair — the reference's own trajectories with
    injected invalid entries — fed to BOTH samplers so the sampler is
    tested in isolation from trajectory drift."""
    r_ref, s_ref = ref_trace
    pos = np.array(r_ref, dtype=np.float64)
    s = np.nan_to_num(np.array(s_ref, dtype=np.float64), nan=1.0)
    rng = np.random.default_rng(7)
    n_rec, n_rays, _ = pos.shape
    # injected invalids, reference-test style (tests/test_gpu_raytrace.py)
    s[rng.integers(0, n_rec, 5), rng.integers(0, n_rays, 5)] = 0.0
    s[rng.integers(0, n_rec, 5), rng.integers(0, n_rays, 5)] = np.nan
    pos[rng.integers(0, n_rec, 4), rng.integers(0, n_rays, 4), 1] = np.nan
    pos[rng.integers(0, n_rec, 4), rng.integers(0, n_rays, 4), 0] = 1e6
    x0, y0, z0, _ = _rays()
    start = np.stack([x0, y0, z0], axis=1)
    return pos, s, start


def test_sampler_parity_vs_reference(scene, los_inputs):
    g, _, ne, te, b = scene
    pos, s, start = los_inputs
    ref = ref_gpu.sample_model_with_rays(
        "cpu", g, g, g, ne, te, b, pos, s, start, R_SUN_CM)
    got = sample_model_with_rays_arrays(
        g, g, g, ne, te, b, pos, s, start, r_sun_cm=R_SUN_CM)

    np.testing.assert_array_equal(np.asarray(got["valid_mask"]),
                                  ref["valid_mask"])
    for key, rtol in (("ne", 2e-5), ("te", 2e-5), ("b", 2e-5)):
        np.testing.assert_allclose(np.asarray(got[key]), ref[key],
                                   rtol=rtol, atol=1e-6 * ref[key].max(),
                                   err_msg=key)
    # ds: first-valid anchored consecutive distances, cm
    np.testing.assert_allclose(np.asarray(got["ds"]), ref["ds"],
                               rtol=2e-4, atol=1.0)


def test_tb_parity_end_to_end(scene, ref_trace, jax_trace):
    """<=1% T_b parity of the trace+sample stages against the actual CPU
    reference: the SAME GRFF transfer consumes (a) reference-traced and
    reference-sampled LOS data and (b) JAX-traced and JAX-sampled LOS data;
    the resulting brightness-temperature maps must agree to 1%."""
    g, _, ne, te, b = scene
    x0, y0, z0, _ = _rays()
    start = np.stack([x0, y0, z0], axis=1)
    pixel_area = (4.0 / 8 * R_SUN_CM) ** 2

    def tb_map(r_rec, s_rec, sampler):
        pos = np.nan_to_num(np.array(r_rec, np.float64), nan=np.nan)
        s = np.array(s_rec, np.float64)
        if sampler == "ref":
            los = ref_gpu.sample_model_with_rays(
                "cpu", g, g, g, ne, te, b, pos, s, start, R_SUN_CM)
        else:
            los = sample_model_with_rays_arrays(
                g, g, g, ne, te, b, pos, s, start, r_sun_cm=R_SUN_CM)
        res = get_mw_slice(
            np.asarray(los["ds"], np.float32),
            np.asarray(los["te"], np.float32),
            np.asarray(los["ne"], np.float32),
            np.asarray(los["b"], np.float32),
            np.asarray(los["valid_mask"]),
            freq0_hz=FREQ_HZ, nfreq=2, freq_log_step=0.1,
            pixel_area_cm2=pixel_area)
        tb = tb_from_sfu(res.flux_o + res.flux_x,
                         jnp.asarray([FREQ_HZ, FREQ_HZ * 10**0.1],
                                     jnp.float32)[None, :], pixel_area)
        return np.asarray(tb)

    r_ref, s_ref = ref_trace
    r_jax, s_jax = jax_trace
    tb_ref = tb_map(r_ref, s_ref, "ref")
    tb_jax = tb_map(r_jax, s_jax, "jax")

    assert np.all(tb_ref[:-1] > 1e4), "scene must produce real emission"
    rel = np.abs(tb_jax - tb_ref) / np.maximum(tb_ref, 1.0)
    assert np.max(rel[:-1]) < 0.01, (
        f"T_b parity vs CPU reference broken: max rel diff {np.max(rel[:-1])}")


# ---------------------------------------------------------------------------
# NaN patcher A/B vs the actual reference implementation
# ---------------------------------------------------------------------------

def _nan_cases():
    rng = np.random.default_rng(11)
    cases = []
    a = rng.uniform(1, 2, (16, 16))
    a[5:9, 4:11] = np.nan           # wide interior blob
    cases.append(a)
    b = rng.uniform(1, 2, (12, 20))
    b[0, :7] = np.nan               # edge run
    b[-1, -1] = np.nan              # corner
    b[6, :] = np.nan                # full row
    cases.append(b)
    c = rng.uniform(1, 2, (15, 15))
    c[rng.random((15, 15)) < 0.35] = np.nan   # heavy sprinkle
    cases.append(c)
    d = np.full((6, 6), np.nan)
    d[0, 0] = 3.0                   # single seed, everything else NaN
    cases.append(d)
    return cases


@pytest.mark.parametrize("idx", range(4))
def test_nanpatch_exact_vs_reference(idx):
    a = _nan_cases()[idx]
    ref = ref_util.patch_nan_emission_map(a)
    got = patch_nan_emission_map(a)
    np.testing.assert_array_equal(got, ref)


def test_nanpatch_3d_exact_vs_reference():
    rng = np.random.default_rng(13)
    a = rng.uniform(1, 2, (10, 10, 3))
    a[4:7, 4:8, 0] = np.nan
    a[0, :, 1] = np.nan
    a[:, 5, 2] = np.nan
    ref = ref_util.patch_nan_emission_map(a)
    got = patch_nan_emission_map(a)
    np.testing.assert_array_equal(got, ref)
