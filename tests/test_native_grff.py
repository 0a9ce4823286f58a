"""Native C++ GRFF library vs the float64 NumPy reference and the JAX path.

The .so exposes the reference's exact PyGET_MW ctypes ABI
(script/synthetic_FF_map_single_thread.py:27-35), making it a drop-in
replacement for the missing external GRFF_DEM_Transfer.so binary."""

import shutil

import numpy as np
import pytest

from raytracinggrff_jax.grff.reference import grff_transfer_reference
from raytracinggrff_jax.grff.transfer import get_mw

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ not available")

AREA = (0.045 * 6.957e10) ** 2


def _pack(ds, te, ne, b, s_area=None, theta=90.0, mech=5):
    nz = len(ds)
    parms = np.zeros((15, nz), order="F")
    parms[0], parms[1], parms[2], parms[3] = ds, te, ne, b
    parms[4] = theta
    parms[6] = mech
    parms[7] = 30
    if s_area is not None:
        parms[14] = s_area
    return parms


def test_native_matches_numpy_reference():
    from raytracinggrff_jax.grff.native import get_mw_native
    rng = np.random.default_rng(0)
    nz, nf = 60, 4
    ds = rng.uniform(5e8, 5e9, nz)
    te = 10 ** rng.uniform(4.2, 6.5, nz)
    ne = 10 ** rng.uniform(6.0, 9.0, nz)
    b = rng.uniform(0.0, 5.0, nz)
    s_area = np.where(rng.uniform(size=nz) > 0.5,
                      AREA * rng.uniform(0.5, 2.0, nz), 0.0)
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 400e6, 0.15])

    rl = get_mw_native(lparms, rparms, _pack(ds, te, ne, b, s_area))

    ref = grff_transfer_reference(
        ds[:, None], te[:, None], ne[:, None], b[:, None],
        np.ones((nz, 1), bool),
        400e6 * 10 ** (0.15 * np.arange(nf)), AREA,
        s_area_cm2=s_area[:, None])
    np.testing.assert_allclose(rl[5], ref["flux_o"][0], rtol=1e-10)
    np.testing.assert_allclose(rl[6], ref["flux_x"][0], rtol=1e-10)
    np.testing.assert_allclose(rl[0],
                               400e-3 * 10 ** (0.15 * np.arange(nf)),
                               rtol=1e-12)


def test_native_matches_jax_get_mw():
    from raytracinggrff_jax.grff.native import get_mw_native
    nz, nf = 30, 3
    parms = _pack(np.full(nz, 2e9), np.full(nz, 1e6), np.full(nz, 3e8),
                  np.full(nz, 2.0))
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 300e6, 0.1])
    rl_native = get_mw_native(lparms, rparms, parms)
    rl_jax = get_mw(lparms, rparms, parms)
    np.testing.assert_allclose(rl_native[5], rl_jax[5], rtol=2e-3)
    np.testing.assert_allclose(rl_native[6], rl_jax[6], rtol=2e-3)


def test_native_reference_script_style_call():
    """Exercise the exact reference calling convention (ctypes, F-order
    arrays, dummy T/DEM/DDM scalars; synthetic_FF_map_single_thread.py
    :189-219)."""
    from raytracinggrff_jax.grff.native import init_get_mw
    import numpy as np
    GET_MW = init_get_mw()
    nz, nf = 20, 2
    parms = np.asfortranarray(_pack(np.full(nz, 1e9), np.full(nz, 1.5e6),
                                    np.full(nz, 5e8), np.full(nz, 1.0)))
    lparms = np.asfortranarray(np.array([nz, nf, 0, 0, 0], np.int32))
    rparms = np.asfortranarray(np.array([AREA, 400e6, 0.1]))
    dummy = np.asfortranarray(np.zeros(1))
    rl = np.zeros((7, nf), order="F")
    res = GET_MW(lparms, rparms, parms, dummy, dummy, dummy, rl)
    assert res == 0
    assert np.all(rl[5] > 0) and np.all(rl[6] > 0)

def test_native_gyroresonance_matches_jax():
    """mech flag 2 (gyroresonance) must be honored by the .so, not silently
    dropped — harmonic layers near s*nu_B change both mode fluxes."""
    from raytracinggrff_jax.grff.native import get_mw_native
    nz, nf = 5, 3
    parms = _pack(np.full(nz, 1e8), np.full(nz, 2e6), np.full(nz, 1e9),
                  np.full(nz, 200.0), theta=60.0, mech=1 + 2 + 4)
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([1e18, 1.0e9, 0.05])
    rl_native = get_mw_native(lparms, rparms, parms)
    rl_jax = get_mw(lparms, rparms, parms)
    np.testing.assert_allclose(rl_native[5], rl_jax[5], rtol=2e-2)
    np.testing.assert_allclose(rl_native[6], rl_jax[6], rtol=2e-2)

    parms_ff = _pack(np.full(nz, 1e8), np.full(nz, 2e6), np.full(nz, 1e9),
                     np.full(nz, 200.0), theta=60.0, mech=1 + 4)
    rl_ff = get_mw_native(lparms, rparms, parms_ff)
    assert np.max(np.abs(rl_native[5] - rl_ff[5])) > 0


def test_get_mw_per_voxel_theta():
    """Parms[4] may vary along the LOS (real GET_MW ABI); voxel-0-only
    shortcuts would silently ignore the variation."""
    nz, nf = 12, 2
    parms = _pack(np.full(nz, 2e9), np.full(nz, 1.2e6), np.full(nz, 4e8),
                  np.full(nz, 3.0), theta=90.0, mech=1 + 4)
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 200e6, 0.1])
    rl_uniform = get_mw(lparms, rparms, parms)
    parms_var = parms.copy()
    parms_var[4] = np.linspace(20.0, 90.0, nz)
    rl_var = get_mw(lparms, rparms, parms_var)
    assert np.max(np.abs(rl_var[5] - rl_uniform[5])) > 0
    # per-voxel uniform column equals the scalar path exactly
    parms_same = parms.copy()
    parms_same[4, :] = 47.5
    rl_a = get_mw(lparms, rparms, parms_same)
    parms_scalar = _pack(np.full(nz, 2e9), np.full(nz, 1.2e6),
                         np.full(nz, 4e8), np.full(nz, 3.0),
                         theta=47.5, mech=1 + 4)
    rl_b = get_mw(lparms, rparms, parms_scalar)
    np.testing.assert_allclose(rl_a[5], rl_b[5], rtol=1e-6)


def test_ddm_inputs_rejected_and_dem_validated():
    """DDM mode stays NotImplementedError on both paths; malformed DEM
    inputs are loud errors, and the reference's dummy-scalar convention
    (synthetic_FF_map_single_thread.py:203-208) still selects the
    uniform-T path."""
    from raytracinggrff_jax.grff.native import get_mw_native
    nz, nf = 6, 2
    parms = _pack(np.full(nz, 1e9), np.full(nz, 1e6), np.full(nz, 1e8),
                  np.full(nz, 1.0))
    rparms = np.array([AREA, 100e6, 0.1])
    lp_ok = np.array([nz, nf, 0, 0, 0], np.int32)

    # DDM on-key -> rejected by both paths
    lp_ddm = np.array([nz, nf, 0, 0, 1], np.int32)
    with pytest.raises(NotImplementedError, match="DDM"):
        get_mw(lp_ddm, rparms, parms)
    with pytest.raises(NotImplementedError, match="status 2"):
        get_mw_native(lp_ddm, rparms, parms)
    # non-dummy DDM array alone also rejected
    with pytest.raises(NotImplementedError, match="DDM"):
        get_mw(lp_ok, rparms, parms, ddm=np.ones(4))

    # real T/DEM without NT -> loud error, not silent ignore
    with pytest.raises(ValueError, match="Lparms"):
        get_mw(lp_ok, rparms, parms, t=np.array(1e6))
    # NT set but dummy arrays -> loud error on both paths
    lp_dem = np.array([nz, nf, 5, 1, 0], np.int32)
    with pytest.raises(ValueError, match="dummy"):
        get_mw(lp_dem, rparms, parms)
    with pytest.raises(ValueError, match="DEM mode"):
        get_mw_native(lp_dem, rparms, parms)

    # the dummy-scalar convention still works on every path
    rl = get_mw(lp_ok, rparms, parms, t=np.array(0.0), dem=np.array(0.0),
                ddm=np.array(0.0))
    rl_n = get_mw_native(lp_ok, rparms, parms, t=0.0, dem=0.0, ddm=0.0)
    assert np.all(rl[5] > 0) and np.all(rl_n[5] > 0)


def _dem_case(nz=20, nt=40, nf=3):
    """Mixed LOS with a broad log-normal DEM per voxel."""
    rng = np.random.default_rng(5)
    t_grid = np.logspace(4.5, 6.8, nt)
    t_peak = 10 ** rng.uniform(5.2, 6.4, nz)
    em = 10 ** rng.uniform(24.0, 26.0, nz)          # cm^-5 per voxel
    lnw = 0.5
    prof = np.exp(-0.5 * (np.log(t_grid[:, None] / t_peak[None, :])
                          / lnw) ** 2)
    w = np.gradient(t_grid)
    dem = em[None, :] * prof / np.sum(w[:, None] * prof, axis=0)
    ds = rng.uniform(5e8, 5e9, nz)
    te = np.sum(w[:, None] * dem * t_grid[:, None], axis=0) / em  # mean T
    ne = np.sqrt(em / ds)
    b = rng.uniform(0.5, 4.0, nz)
    parms = _pack(ds, te, ne, b, theta=70.0, mech=1)
    lparms = np.array([nz, nf, nt, 1, 0], np.int32)
    rparms = np.array([AREA, 150e6, 0.2])
    return t_grid, dem, parms, lparms, rparms


def _dem_oracle(t_grid, dem, parms, lparms, rparms):
    """Independent float64 trapezoid quadrature of the DEM kernel moments +
    scalar RT recursion: {RL row: flux} for the O (5) and X (6) modes."""
    from raytracinggrff_jax.constants import (AU_CM, C_CGS, FB_COEF,
                                              FPE_COEF, KB_CGS, SFU2CGS)
    from raytracinggrff_jax.grff.physics import (KAPPA_FF_COEF, coulomb_log,
                                                 refractive_index_sq)
    nz, nf = int(lparms[0]), int(lparms[1])
    freqs = rparms[1] * 10 ** (rparms[2] * np.arange(nf))
    w = np.concatenate([[t_grid[1] - t_grid[0]],
                        t_grid[2:] - t_grid[:-2],
                        [t_grid[-1] - t_grid[-2]]]) / 2.0
    theta = np.deg2rad(parms[4, 0])
    out = {}
    for m_i, sigma in ((5, 1.0), (6, -1.0)):
        flux = np.zeros(nf)
        for k in range(nz):
            lnlam = coulomb_log(t_grid[:, None], freqs[None, :], xp=np)
            m_k = np.sum((w * dem[:, k] * t_grid ** -1.5)[:, None] * lnlam,
                         axis=0)
            m_j = np.sum((w * dem[:, k] * t_grid ** -0.5)[:, None] * lnlam,
                         axis=0)
            t_eff = m_j / m_k
            ne_k, b_k = parms[2, k], parms[3, k]
            X = FPE_COEF ** 2 * ne_k / freqs ** 2
            Y = FB_COEF * b_k / freqs
            n2 = refractive_index_sq(X, Y, theta, sigma, xp=np)
            n_sig = np.sqrt(np.maximum(n2, 1e-12))
            eff2 = (freqs + sigma * FB_COEF * b_k * abs(np.cos(theta))) ** 2
            tau = KAPPA_FF_COEF * m_k / (n_sig * eff2)
            src = (KB_CGS * t_eff * freqs ** 2 / C_CGS ** 2 / SFU2CGS
                   * AREA / AU_CM ** 2)
            flux = flux * np.exp(-tau) + src * -np.expm1(-tau)
            flux = np.where(n2 <= 0, 0.0, flux)
        out[m_i] = flux
    return out


def test_dem_mode_matches_float64_quadrature_oracle():
    """JAX DEM transfer vs an independent float64 trapezoid quadrature of
    the same kernel-moment definition + scalar RT recursion."""
    t_grid, dem, parms, lparms, rparms = _dem_case()
    rl = get_mw(lparms, rparms, parms, t=t_grid, dem=dem)
    for m_i, flux in _dem_oracle(t_grid, dem, parms, lparms,
                                 rparms).items():
        np.testing.assert_allclose(rl[m_i], flux, rtol=2e-3,
                                   err_msg=f"mode RL[{m_i}]")
    assert np.all(rl[5] > 0)


def test_dem_moments_run_at_highest_precision():
    """The DEM moment products are the program's only matrix products; on
    a GPU they would run in TF32 (~3 digits) unless asked for HIGHEST."""
    import jax
    from raytracinggrff_jax.grff.physics import dem_freefree_moments
    t_grid, dem, _, _, rparms = _dem_case()
    nu = rparms[1] * 10 ** (rparms[2] * np.arange(3))
    jaxpr = jax.make_jaxpr(
        lambda d: dem_freefree_moments(t_grid, d, nu))(dem)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,
                                         jax.lax.Precision.HIGHEST)


def test_dem_delta_function_reduces_to_uniform_t():
    """A DEM concentrated at one temperature node with column EM = ne^2*ds
    must reproduce the uniform-T free-free path (mech=1) at that T — the
    strongest internal consistency anchor for the DEM integral."""
    nz, nf, nt = 10, 2, 201
    t0 = 1.2e6
    ds = np.full(nz, 2e9)
    ne = np.full(nz, 3e8)
    b = np.full(nz, 2.0)
    parms = _pack(ds, np.full(nz, t0), ne, b, theta=80.0, mech=1)
    rparms = np.array([AREA, 120e6, 0.15])
    lp_uni = np.array([nz, nf, 0, 0, 0], np.int32)
    rl_uni = get_mw(lp_uni, rparms, parms)

    # narrow Gaussian DEM around t0, normalized to EM = ne^2 ds per voxel
    t_grid = np.linspace(t0 * 0.97, t0 * 1.03, nt)
    sig = t0 * 0.004
    prof = np.exp(-0.5 * ((t_grid - t0) / sig) ** 2)
    w = np.gradient(t_grid)
    dem = np.tile((prof / np.sum(w * prof))[:, None], (1, nz)) \
        * (ne ** 2 * ds)[None, :]
    lp_dem = np.array([nz, nf, nt, 1, 0], np.int32)
    rl_dem = get_mw(lp_dem, rparms, parms, t=t_grid, dem=dem)
    np.testing.assert_allclose(rl_dem[5], rl_uni[5], rtol=2e-3)
    np.testing.assert_allclose(rl_dem[6], rl_uni[6], rtol=2e-3)

    # C++ shim: same DEM call, identical physics (float64 twin)
    from raytracinggrff_jax.grff.native import get_mw_native
    rl_native = get_mw_native(lp_dem, rparms, parms, t=t_grid, dem=dem)
    np.testing.assert_allclose(rl_native[5], rl_dem[5], rtol=2e-3)
    np.testing.assert_allclose(rl_native[6], rl_dem[6], rtol=2e-3)


def test_dem_mode_native_matches_jax_mixed_mech():
    """DEM free-free + per-voxel gyro/neutral bits through both the JAX
    path and the C++ shim."""
    from raytracinggrff_jax.grff.native import get_mw_native
    t_grid, dem, parms, lparms, rparms = _dem_case(nz=16, nt=30, nf=2)
    parms[6, :8] = 1 + 4
    parms[6, 8:12] = 1 + 2
    parms[3, 8:12] = 150.0   # strong B so gyro layers sit near s*nu_B
    rl_jax = get_mw(lparms, rparms, parms, t=t_grid, dem=dem)
    rl_nat = get_mw_native(lparms, rparms, parms, t=t_grid, dem=dem)
    np.testing.assert_allclose(rl_jax[5], rl_nat[5], rtol=2e-2)
    np.testing.assert_allclose(rl_jax[6], rl_nat[6], rtol=2e-2)
    assert np.all(rl_jax[5] > 0)


def test_get_mw_per_voxel_mechanism_mixed_los():
    """Parms[6] may vary along the LOS (real GET_MW ABI): a mixed
    chromosphere/corona LOS enabling different mechanism sets per segment
    must run through both the JAX path and the C++ shim with identical
    results (the shim already reads mech per column,
    native/grff_transfer.cpp)."""
    from raytracinggrff_jax.grff.native import get_mw_native
    nz, nf = 24, 3
    te = np.concatenate([np.full(8, 8e3), np.full(16, 1.4e6)])   # chromo+corona
    ne = np.concatenate([np.full(8, 2e10), np.full(16, 4e8)])
    parms = _pack(np.full(nz, 5e7), te, ne, np.full(nz, 3.0),
                  theta=75.0, mech=5)
    parms[6, :8] = 1 + 4     # chromosphere: free-free + neutrals
    parms[6, 8:] = 1         # corona: free-free only
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 200e6, 0.1])

    rl_jax = get_mw(lparms, rparms, parms)
    rl_native = get_mw_native(lparms, rparms, parms)
    np.testing.assert_allclose(rl_jax[5], rl_native[5], rtol=2e-3)
    np.testing.assert_allclose(rl_jax[6], rl_native[6], rtol=2e-3)

    # the variation must matter: stripping the chromospheric neutral bit
    # (cool dense voxels, where Saha neutrals dominate) changes the answer
    parms_all = parms.copy()
    parms_all[6, :] = 1           # free-free only everywhere
    rl_all = get_mw(lparms, rparms, parms_all)
    assert np.max(np.abs(rl_all[5] - rl_jax[5])) > 0

    # a uniform per-voxel mech array equals the scalar fast path exactly
    from raytracinggrff_jax.grff.transfer import grff_transfer
    freqs = 200e6 * 10 ** (0.1 * np.arange(nf))
    common = dict(ds=parms[0, :, None], te=parms[1, :, None],
                  ne=parms[2, :, None], b=parms[3, :, None],
                  valid=np.ones((nz, 1), bool), freqs_hz=freqs,
                  pixel_area_cm2=AREA, theta_deg=75.0)
    res_scalar = grff_transfer(mechanism=5, **common)
    res_arr = grff_transfer(mechanism=np.full(nz, 5, np.int32), **common)
    np.testing.assert_allclose(np.asarray(res_arr.flux_o),
                               np.asarray(res_scalar.flux_o), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res_arr.flux_x),
                               np.asarray(res_scalar.flux_x), rtol=1e-6)

    # gyroresonance bit per voxel: only the voxels with bit 2 add opacity
    parms_gr = _pack(np.full(nz, 1e8), np.full(nz, 2e6), np.full(nz, 1e9),
                     np.full(nz, 200.0), theta=60.0, mech=1 + 4)
    parms_gr[6, 10:14] = 1 + 2 + 4
    rp_gr = np.array([1e18, 1.0e9, 0.05])
    rl_gr_jax = get_mw(lparms, rp_gr, parms_gr)
    rl_gr_native = get_mw_native(lparms, rp_gr, parms_gr)
    np.testing.assert_allclose(rl_gr_jax[5], rl_gr_native[5], rtol=2e-2)
    np.testing.assert_allclose(rl_gr_jax[6], rl_gr_native[6], rtol=2e-2)
