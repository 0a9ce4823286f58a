"""GRFF transfer physics contracts.

Analytic anchors:
  * optically thick isothermal slab -> T_b == T (per mode, and after the
    reference's SFU->T_b conversion the total I maps back to T)
  * optically thin slab -> T_b ~= tau * T with the Dulk kappa
  * evanescent voxel blocks a mode
  * invalid voxels contribute nothing (compaction equivalence)
  * float32 JAX path vs float64 NumPy reference within 1% (parity target)
"""

import numpy as np

from raytracinggrff_jax.constants import AU_CM, C_CGS, KB_CGS, SFU2CGS
from raytracinggrff_jax.grff.physics import (
    coulomb_log, freefree_kappa, refractive_index_sq, KAPPA_FF_COEF)
from raytracinggrff_jax.grff.reference import grff_transfer_reference
from raytracinggrff_jax.grff.transfer import (
    get_mw, get_mw_slice, grff_transfer, log_spaced_freqs, tb_from_sfu)

AREA = (0.045 * 6.957e10) ** 2  # ~64-pix over 2.88 Rsun pixel area, cm^2


def _slab(nz=50, n_pix=4, ne=2e8, te=1.2e6, b=1.0, ds=1e9):
    ds_a = np.full((nz, n_pix), ds)
    te_a = np.full((nz, n_pix), te)
    ne_a = np.full((nz, n_pix), ne)
    b_a = np.full((nz, n_pix), b)
    valid = np.ones((nz, n_pix), bool)
    return ds_a, te_a, ne_a, b_a, valid


def test_optically_thick_gives_source_temperature():
    te = 1.5e6
    ds_a, te_a, ne_a, b_a, valid = _slab(nz=40, ne=8e8, te=te, ds=2e11)
    freqs = np.array([500e6])  # above nu_p ~ 253 MHz
    res = grff_transfer(ds_a, te_a, ne_a, b_a, valid, freqs, AREA)
    assert float(res.tau_o[0, 0]) > 20.0
    tb = tb_from_sfu(np.asarray(res.flux_o) + np.asarray(res.flux_x),
                     freqs[0], AREA)
    np.testing.assert_allclose(tb, te, rtol=2e-2)


def test_optically_thin_scaling():
    """tau << 1: T_b ~= tau * T with tau from the Dulk kappa formula."""
    ne, te, nu, ds = 1e6, 2e6, 5e8, 1e8
    ds_a, te_a, ne_a, b_a, valid = _slab(nz=1, n_pix=1, ne=ne, te=te,
                                         b=0.0, ds=ds)
    res = grff_transfer(ds_a, te_a, ne_a, b_a, valid, np.array([nu]), AREA,
                        mechanism=1)  # pure free-free
    lnlam = float(coulomb_log(np.array(te), np.array(nu), xp=np))
    n_refr = np.sqrt(1.0 - (8.93e3 ** 2) * ne / nu ** 2)
    tau = KAPPA_FF_COEF * ne * ne * lnlam / (n_refr * nu ** 2 * te ** 1.5) * ds
    assert tau < 1e-3
    tb = tb_from_sfu(float(res.flux_o[0, 0] + res.flux_x[0, 0]), nu, AREA)
    np.testing.assert_allclose(tb, 2 * tau * te / 2, rtol=2e-2)


def test_evanescent_blocks_mode():
    """A voxel with nu < nu_p zeroes both modes' history."""
    nz, n_pix = 10, 1
    ds_a, te_a, ne_a, b_a, valid = _slab(nz=nz, n_pix=n_pix,
                                         ne=5e8, te=1e6, ds=1e8)
    freqs = np.array([300e6])  # above base nu_p ~ 200 MHz; tau/voxel << 1
    # make middle voxel overdense for 300 MHz: nu_p = 8.93e3*sqrt(ne)
    ne_a[5, :] = (350e6 / 8.93e3) ** 2
    res = grff_transfer(ds_a, te_a, ne_a, b_a, valid, freqs, AREA)
    res_clear = grff_transfer(ds_a, te_a, ne_a * 0 + 5e8, b_a, valid,
                              freqs, AREA)
    # emission only accumulates after the barrier -> strictly less flux
    assert float(res.flux_o[0, 0]) < float(res_clear.flux_o[0, 0])
    assert np.isinf(float(res.tau_o[0, 0]))


def test_invalid_voxels_equal_compaction():
    rng = np.random.default_rng(0)
    nz, n_pix = 40, 3
    ds_a, te_a, ne_a, b_a, valid = _slab(nz=nz, n_pix=n_pix)
    ne_a *= rng.uniform(0.5, 2.0, size=ne_a.shape)
    te_a *= rng.uniform(0.5, 2.0, size=te_a.shape)
    valid[::4] = False
    ne_a[valid == False] = np.nan  # noqa: E712 — garbage in invalid voxels
    freqs = log_spaced_freqs(80e6, 3, 0.2)
    res = grff_transfer(ds_a, te_a, ne_a, b_a, valid, freqs, AREA)

    # compacted: keep only valid voxels per pixel (same for all pixels here)
    keep = valid[:, 0]
    res_c = grff_transfer(ds_a[keep], te_a[keep], ne_a[keep], b_a[keep],
                          valid[keep], freqs, AREA)
    np.testing.assert_allclose(np.asarray(res.flux_o),
                               np.asarray(res_c.flux_o), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.flux_x),
                               np.asarray(res_c.flux_x), rtol=1e-6)


def test_parity_vs_float64_reference():
    """JAX float32 path within 1% of the float64 CPU reference (the
    BASELINE.md parity target)."""
    rng = np.random.default_rng(7)
    nz, n_pix = 80, 16
    ds_a = rng.uniform(5e8, 5e9, (nz, n_pix))
    te_a = 10 ** rng.uniform(4.2, 6.5, (nz, n_pix))
    ne_a = 10 ** rng.uniform(6.0, 9.0, (nz, n_pix))  # nu_p <= 282 MHz
    b_a = rng.uniform(0.0, 5.0, (nz, n_pix))
    valid = rng.uniform(size=(nz, n_pix)) > 0.2
    s_area = np.where(rng.uniform(size=(nz, n_pix)) > 0.5,
                      AREA * rng.uniform(0.5, 2.0, (nz, n_pix)), 0.0)
    freqs = log_spaced_freqs(400e6, 4, 0.15)  # all above cutoff

    jit_res = grff_transfer(ds_a, te_a, ne_a, b_a, valid, freqs, AREA,
                            s_area_cm2=s_area)
    ref = grff_transfer_reference(ds_a, te_a, ne_a, b_a, valid, freqs, AREA,
                                  s_area_cm2=s_area)
    for a, b_ in ((jit_res.flux_o, ref["flux_o"]),
                  (jit_res.flux_x, ref["flux_x"])):
        a = np.asarray(a, np.float64)
        scale = np.maximum(np.abs(b_), np.abs(b_).max() * 1e-6)
        assert np.max(np.abs(a - b_) / scale) < 0.01


def test_get_mw_contract():
    """GET_MW-style (15, Nz) Parms packing produces the RL layout."""
    nz, nf = 30, 4
    parms = np.zeros((15, nz))
    parms[0] = 2e9          # ds
    parms[1] = 1e6          # Te
    parms[2] = 3e8          # Ne
    parms[3] = 2.0          # B
    parms[4] = 90.0
    parms[6] = 1 + 4
    parms[7] = 30
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 300e6, 0.1])
    rl = get_mw(lparms, rparms, parms)
    assert rl.shape == (7, nf)
    np.testing.assert_allclose(rl[0], 300e-3 * 10 ** (0.1 * np.arange(nf)),
                               rtol=1e-6)
    assert np.all(rl[5] > 0) and np.all(rl[6] > 0)
    # V/I small but nonzero at theta=90 (mode refractive indices differ)
    vi = (rl[5] - rl[6]) / (rl[5] + rl[6])
    assert np.all(np.abs(vi) < 0.5)


def test_get_mw_slice_matches_get_mw():
    nz, nf, n_pix = 25, 2, 5
    rng = np.random.default_rng(1)
    ds_a = rng.uniform(1e9, 3e9, (nz, n_pix))
    te_a = 10 ** rng.uniform(5, 6.5, (nz, n_pix))
    ne_a = 10 ** rng.uniform(7, 8.7, (nz, n_pix))
    b_a = rng.uniform(0, 3, (nz, n_pix))
    valid = np.ones((nz, n_pix), bool)
    res = get_mw_slice(ds_a, te_a, ne_a, b_a, valid, 300e6, nf, 0.15, AREA)
    for p in range(n_pix):
        parms = np.zeros((15, nz))
        parms[0], parms[1] = ds_a[:, p], te_a[:, p]
        parms[2], parms[3] = ne_a[:, p], b_a[:, p]
        parms[4], parms[6] = 90.0, 5
        rl = get_mw(np.array([nz, nf], np.int32),
                    np.array([AREA, 300e6, 0.15]), parms)
        np.testing.assert_allclose(np.asarray(res.flux_o[p]), rl[5],
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(res.flux_x[p]), rl[6],
                                   rtol=1e-5)


def test_refractive_index_limits():
    """Appleton-Hartree sanity: B->0 gives n^2 = 1 - X for both modes;
    theta=90 O-mode is 1 - X."""
    X = np.array(0.3)
    for sigma in (1.0, -1.0):
        n2 = refractive_index_sq(X, np.array(0.0), np.pi / 2, sigma, xp=np)
        np.testing.assert_allclose(n2, 0.7, rtol=1e-12)
    n2_o = refractive_index_sq(X, np.array(0.2), np.pi / 2, 1.0, xp=np)
    np.testing.assert_allclose(n2_o, 0.7, rtol=1e-9)
    # X-mode at theta=90: 1 - X(1-X)/(1-X-Y^2)
    n2_x = refractive_index_sq(X, np.array(0.2), np.pi / 2, -1.0, xp=np)
    np.testing.assert_allclose(n2_x, 1 - 0.3 * 0.7 / (0.7 - 0.04),
                               rtol=1e-9)


def test_full_mechanism_sweep_matches_float64_reference():
    """mechanism=1+2+4 + gaunt='exact' + per-voxel theta (the full Parms
    contract in one call) against the float64 per-voxel-loop oracle on a
    B-strong scene where gyroresonance layers dominate entire columns.

    nu is held a few layer-widths off exact resonance centers: the
    Gaussian layer width is s*nu_B*beta*|cos| (~0.5% of nu), so float32
    evaluation of the line profile is exact to ~1e-3 there, while the
    layers still raise tau by orders of magnitude over free-free."""
    rng = np.random.default_rng(7)
    nz, n_pix = 40, 8
    ds = rng.uniform(1e8, 1e9, (nz, n_pix))
    te = 10 ** rng.uniform(5.8, 6.6, (nz, n_pix))
    ne = 10 ** rng.uniform(7.5, 9.0, (nz, n_pix))
    # fields spanning the s=2..4 layers of a 1 GHz wave (B_res=179/119/89 G)
    b = rng.uniform(60.0, 220.0, (nz, n_pix))
    theta = rng.uniform(20.0, 160.0, (nz, n_pix))
    valid = rng.uniform(size=(nz, n_pix)) > 0.15
    freqs = log_spaced_freqs(1.0e9, 3, 0.05)

    jit_res = grff_transfer(ds, te, ne, b, valid, freqs, AREA,
                            theta_deg=theta, mechanism=1 + 2 + 4,
                            gaunt="exact")
    ref = grff_transfer_reference(ds, te, ne, b, valid, freqs, AREA,
                                  theta_deg=theta, mechanism=1 + 2 + 4,
                                  gaunt="exact")
    # GR must actually matter on this scene (vs free-free-only tau)
    ref_ff = grff_transfer_reference(ds, te, ne, b, valid, freqs, AREA,
                                     theta_deg=theta, mechanism=1 + 4,
                                     gaunt="exact")
    assert np.nanmedian(np.where(np.isinf(ref["tau_x"]), np.nan,
                                 ref["tau_x"])) > 3 * np.nanmedian(
        np.where(np.isinf(ref_ff["tau_x"]), np.nan, ref_ff["tau_x"]))
    for a, b_ in ((jit_res.flux_o, ref["flux_o"]),
                  (jit_res.flux_x, ref["flux_x"])):
        a = np.asarray(a, np.float64)
        scale = np.maximum(np.abs(b_), np.abs(b_).max() * 1e-6)
        assert np.max(np.abs(a - b_) / scale) < 0.02
