"""External physics anchors for the native GRFF transfer.

Every other GRFF test compares three in-repo implementations of the same
derivation (JAX float32, NumPy float64 oracle, C++ shim) — circular. These
tests pin the transfer to physics facts that do not depend on the
implementation:

  * thermodynamic limit: an optically thick isothermal slab must radiate
    T_b = T_e (Rayleigh-Jeans blackbody), to better than 1%;
  * quiet-Sun brightness: a Newkirk (1961) corona at T_e = 1.4 MK must give
    disk-center T_b in the observed low-frequency band — literature points
    run 0.3-0.8 MK over 20-90 MHz (BASELINE.md anchor; the scattering-free
    model tracks the band's lower edge at 20-30 MHz and exceeds it toward
    90 MHz exactly as the reference model does, because real coronal
    scattering suppresses the observed T_b at higher frequencies);
  * monotonicity + saturation: T_b grows with frequency toward T_e as the
    emitting layer deepens, reaching (1 - e^-tau) T_e when tau is finite.

If the free-free opacity, the evanescent-layer blocking, or the SFU<->T_b
conversion drift, these fail. (ref anchor usage:
script/pub/compare_ovro_Tb_spec.py:192, plot_Tb_spec.ipynb cell 1.)
"""

import numpy as np
import pytest

from raytracinggrff_jax.constants import R_SUN_CM
from raytracinggrff_jax.grff.transfer import grff_transfer, tb_from_sfu

AREA = (0.1 * R_SUN_CM) ** 2


def _tb(ds, te, ne, b, freqs):
    res = grff_transfer(ds, te, ne, b, np.ones(ds.shape, bool), freqs, AREA)
    tb = tb_from_sfu(np.asarray(res.flux_o + res.flux_x), freqs[None, :],
                     AREA)
    return np.asarray(tb)[0], np.asarray(res.tau_o)[0]


def test_optically_thick_slab_radiates_te():
    """tau >> 1 => T_b = T_e (blackbody limit), independent of density."""
    n_vox = 50
    te_k = 8.5e5
    ds = np.full((n_vox, 1), 1e10)
    te = np.full((n_vox, 1), te_k)
    ne = np.full((n_vox, 1), 2e9)       # f_pe ~ 400 MHz < 600 MHz: propagates
    b = np.zeros((n_vox, 1))
    tb, tau = _tb(ds, te, ne, b, np.array([600e6]))
    assert tau[0] > 20.0
    np.testing.assert_allclose(tb[0], te_k, rtol=1e-2)


@pytest.fixture(scope="module")
def newkirk_los():
    """Disk-center LOS through a Newkirk quiet-Sun corona, surface -> 4 Rs."""
    r = 1.0 + np.geomspace(1e-4, 3.0, 2000)
    ne = 4.2e4 * 10 ** (4.32 / r)
    te = np.full_like(r, 1.4e6)
    b = np.zeros_like(r)
    ds = np.gradient(r) * R_SUN_CM
    return ds[:, None], te[:, None], ne[:, None], b[:, None]


def test_quiet_sun_low_band_in_literature_range(newkirk_los):
    ds, te, ne, b = newkirk_los
    freqs = np.array([20e6, 30e6])
    tb, _ = _tb(ds, te, ne, b, freqs)
    # literature quiet-Sun T_b band over 20-90 MHz: 0.3-0.8 MK
    assert 0.3e6 < tb[0] < 0.8e6, tb
    assert 0.3e6 < tb[1] < 0.8e6, tb


def test_quiet_sun_tb_rises_to_te(newkirk_los):
    ds, te, ne, b = newkirk_los
    freqs = np.array([20e6, 45e6, 90e6, 150e6, 300e6])
    tb, tau = _tb(ds, te, ne, b, freqs)
    assert np.all(np.diff(tb) > 0), tb           # deeper layers are hotter
    # at 300 MHz the LOS is optically thick-ish: T_b = (1 - e^-tau) T_e
    expected = (1.0 - np.exp(-tau[-1])) * 1.4e6
    np.testing.assert_allclose(tb[-1], expected, rtol=2e-2)
    assert tb[-1] < 1.4e6                         # never exceeds T_e
