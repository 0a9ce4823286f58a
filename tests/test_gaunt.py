"""Free-free Gaunt-factor error budget (gaunt='dulk' vs 'exact').

Protects the quantitative claims documented in grff/physics.py: the default
Dulk 1985 piecewise lnLambda runs 1-13% BELOW the exact classical/Born
Gaunt opacity over the production band (30-800 MHz, 1e4-2e6 K), and the
resulting brightness-temperature drift on an optically-mixed LOS stays
under 2% (optically-thick pixels saturate to T_e regardless of kappa).
"""

import numpy as np

from raytracinggrff_jax.grff.physics import (KAPPA_FF_COEF,
                                             KAPPA_FF_EXACT_COEF,
                                             coulomb_log, exact_gaunt,
                                             freefree_kappa)
from raytracinggrff_jax.grff.transfer import grff_transfer

AREA = (0.045 * 6.957e10) ** 2


def _ratio_grid():
    nus = np.logspace(np.log10(30e6), np.log10(800e6), 25)
    tes = np.logspace(4.0, np.log10(2e6), 40)
    nu, te = np.meshgrid(nus, tes)
    kap_dulk = KAPPA_FF_COEF * coulomb_log(te, nu, xp=np)
    kap_ex = KAPPA_FF_EXACT_COEF * exact_gaunt(te, nu, xp=np)
    return kap_dulk / kap_ex, nu, te


def test_dulk_vs_exact_bounds():
    """Dulk is low by 1-13% across the band — never high, never worse."""
    ratio, nu, te = _ratio_grid()
    assert ratio.min() > 0.86          # worst: 13% low (1e4 K, 800 MHz)
    assert ratio.max() < 1.00          # Dulk never exceeds exact
    # coronal plasma (1-2 MK): 4-7% low
    coronal = (te >= 1e6)
    assert 0.93 < ratio[coronal].min() and ratio[coronal].max() < 0.97
    # best agreement near the 2e5 K branch switch (< 1% off)
    switch = (te > 1.8e5) & (te < 2.3e5)
    assert ratio[switch].max() > 0.985


def test_exact_prefactor_first_principles():
    """KAPPA_FF_EXACT_COEF must equal the CGS first-principles value
    (4 e^6/(3 m c k)) sqrt(2 pi/(3 k m)) ~ 0.01772."""
    np.testing.assert_allclose(KAPPA_FF_EXACT_COEF, 1.772e-2, rtol=1e-3)


def test_exact_gaunt_blackbody_saturation():
    """An optically thick isothermal slab must radiate T_b = T_e with the
    exact Gaunt factor too (source function is Gaunt-independent)."""
    from raytracinggrff_jax.grff.transfer import tb_from_sfu
    nz = 30
    te0 = 1.2e6
    ds = np.full((nz, 1), 1e11)
    te = np.full((nz, 1), te0)
    ne = np.full((nz, 1), 1e7)     # nu_p ~ 28 MHz < 50 MHz: propagating
    b = np.zeros((nz, 1))
    valid = np.ones((nz, 1), bool)
    freqs = np.array([50e6])
    res = grff_transfer(ds, te, ne, b, valid, freqs, AREA, gaunt="exact")
    assert float(res.tau_o[0, 0]) > 5.0
    tb = float(tb_from_sfu(res.flux_o + res.flux_x, freqs, AREA)[0, 0])
    np.testing.assert_allclose(tb, te0, rtol=0.01)


def test_tb_drift_dulk_vs_exact_under_2pct():
    """Quiet-Sun-like LOS (tau ~ 1 transition): T_b drift between the two
    Gaunt treatments stays below 2% even where kappa differs by ~5%."""
    from raytracinggrff_jax.grff.transfer import tb_from_sfu
    nz = 80
    # hydrostatic-ish falloff crossing tau ~ 1 inside the slab
    h = np.arange(nz)
    ne = (2e8 * np.exp(-h / 25.0))[::-1][:, None]     # deep end first
    te = np.full((nz, 1), 1.4e6)
    ds = np.full((nz, 1), 2e9)
    b = np.zeros((nz, 1))
    valid = np.ones((nz, 1), bool)
    freqs = np.array([200e6])      # above the peak nu_p ~ 126 MHz
    tbs = {}
    for g in ("dulk", "exact"):
        res = grff_transfer(ds, te, ne, b, valid, freqs, AREA, gaunt=g)
        tbs[g] = float(tb_from_sfu(res.flux_o + res.flux_x, freqs,
                                   AREA)[0, 0])
        # the scene straddles the thick/thin transition
        assert 0.2 < float(res.tau_o[0, 0]) < 50.0
    drift = abs(tbs["exact"] - tbs["dulk"]) / tbs["exact"]
    assert drift < 0.02, (tbs, drift)
    # and the exact treatment absorbs more (Dulk kappa is low)
    assert tbs["exact"] >= tbs["dulk"]
