"""Gyroresonance opacity (mechanism flag 2): resonance-layer behavior and
the exact magnetoionic polarization coupling."""

import numpy as np

from raytracinggrff_jax.grff.physics import (gyro_polarization_coupling,
                                             gyroresonance_kappa,
                                             refractive_index_sq)
from raytracinggrff_jax.grff.transfer import grff_transfer

AREA = (0.045 * 6.957e10) ** 2


def _svd_coupling(X, Y, theta, sigma):
    """Independent oracle for F_sigma: build the cold-plasma wave operator
    in the Stix frame (B || z, k in the x-z plane), extract the mode's
    polarization as the SVD null vector, and project onto the
    electron-sense rotation about B, |e_x - i e_y|^2 / ||e||^2. Shares no
    algebra with the closed form in gyro_polarization_coupling beyond the
    Appleton-Hartree n^2 root used to select the branch."""
    n2 = refractive_index_sq(X, Y, theta, sigma, xp=np)
    s = 1 - X / (1 - Y * Y)
    d = -X * Y / (1 - Y * Y)
    p = 1 - X
    st, ct = np.sin(theta), np.cos(theta)
    m = np.array([[s - n2 * ct * ct, -1j * d, n2 * ct * st],
                  [1j * d, s - n2, 0.0],
                  [n2 * ct * st, 0.0, p - n2 * st * st]])
    _, _, vh = np.linalg.svd(m)
    e = vh[-1].conj()
    return float(abs(e[0] - 1j * e[1]) ** 2 / np.sum(abs(e) ** 2))


def test_exact_coupling_matches_svd_nullspace():
    """Closed-form F_sigma == SVD null-space projection at all angles,
    including exactly perpendicular, for both modes and several (X, Y)."""
    for X in (1e-3, 0.02, 0.1):
        for Y in (0.5, 1 / 3, 0.2):
            for deg in (0.5, 15, 45, 70, 80, 85, 89, 89.9, 90.0):
                th = np.deg2rad(deg)
                for sigma in (1.0, -1.0):
                    got = float(gyro_polarization_coupling(
                        X, Y, th, sigma, xp=np))
                    ref = _svd_coupling(X, Y, th, sigma)
                    assert abs(got - ref) <= 1e-6 + 1e-4 * abs(ref), (
                        X, Y, deg, sigma, got, ref)


def test_exact_coupling_limits_and_ql_regime():
    X, Y = 0.02, 1 / 3
    # theta -> 0: X couples fully (F -> 2), O not at all
    assert abs(float(gyro_polarization_coupling(
        X, Y, 1e-4, -1.0, xp=np)) - 2.0) < 1e-3
    assert float(gyro_polarization_coupling(X, Y, 1e-4, 1.0, xp=np)) < 1e-6
    # QL regime (theta <= 45 deg): matches (1 - sigma|cos|)^2/2 to a few %
    for deg in (10, 25, 45):
        th = np.deg2rad(deg)
        for sigma in (1.0, -1.0):
            exact = float(gyro_polarization_coupling(X, Y, th, sigma,
                                                     xp=np))
            ql = (1 - sigma * abs(np.cos(th))) ** 2 / 2
            assert abs(exact - ql) < 0.04 + 0.03 * ql, (deg, sigma)
    # even in cos(theta): rotation sense is about B, not k
    # (the observed-handedness swap lives in the transfer layer)
    f1 = float(gyro_polarization_coupling(X, Y, np.deg2rad(60), -1.0,
                                          xp=np))
    f2 = float(gyro_polarization_coupling(X, Y, np.deg2rad(120), -1.0,
                                          xp=np))
    assert abs(f1 - f2) < 1e-12


def test_perpendicular_xo_asymmetry_anchor():
    """The exact X/O opacity ratio at theta = 80-89 deg — the regime where
    the QL factor is wrong by orders of magnitude (it tends to X/O -> 1 at
    90 deg; the exact O coupling vanishes like cos^2 theta while X stays
    O(1)). Ratios pinned from the closed form, cross-checked by the SVD
    oracle above; gyroresonance_kappa must inherit them."""
    b, ne, te = 100.0, 1e9, 2e6
    nu = 3 * 2.7992e6 * b
    X = (8.93e3) ** 2 * ne / nu ** 2
    Y = 1 / 3
    for deg, min_ratio in ((80, 10.0), (85, 30.0), (89, 500.0)):
        th = np.deg2rad(deg)
        fx = float(gyro_polarization_coupling(X, Y, th, -1.0, xp=np))
        fo = float(gyro_polarization_coupling(X, Y, th, 1.0, xp=np))
        assert 0.9 < fx < 1.2, (deg, fx)          # X stays O(1)
        assert fx / fo > min_ratio, (deg, fx / fo)
        ql_ratio = ((1 + abs(np.cos(th))) / (1 - abs(np.cos(th)))) ** 2
        assert fx / fo > 5 * ql_ratio, (deg, fx / fo, ql_ratio)
        # the full opacity inherits the exact ratio at the layer center
        kx = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                       np.float64(b), nu, th, -1.0, xp=np))
        ko = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                       np.float64(b), nu, th, 1.0, xp=np))
        np.testing.assert_allclose(kx / ko, fx / fo, rtol=1e-6)
    # O-mode coupling -> 0 like cos^2 theta at exactly perpendicular
    assert float(gyro_polarization_coupling(X, Y, np.pi / 2, 1.0,
                                            xp=np)) == 0.0
    assert float(gyro_polarization_coupling(X, Y, np.pi / 2, -1.0,
                                            xp=np)) > 0.5


def test_resonance_layers():
    """Opacity peaks where nu = s * nu_B and is negligible off-resonance."""
    b = 100.0                     # G -> nu_B ~ 280 MHz
    nu_b = 2.7992e6 * b
    ne, te = 1e9, 2e6
    theta = np.deg2rad(45.0)
    for s in (2, 3):
        on = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                       np.float64(b), s * nu_b, theta,
                                       -1.0, xp=np))
        off = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                        np.float64(b), (s + 0.5) * nu_b,
                                        theta, -1.0, xp=np))
        assert on > 1e3 * max(off, 1e-30)
    # low harmonics are far more opaque than high ones
    k2 = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                   np.float64(b), 2 * nu_b, theta, -1.0,
                                   xp=np))
    k5 = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                   np.float64(b), 5 * nu_b, theta, -1.0,
                                   xp=np))
    assert k2 > 1e3 * k5


def test_x_mode_more_opaque_than_o():
    b, ne, te = 100.0, 1e9, 2e6
    nu = 3 * 2.7992e6 * b
    theta = np.deg2rad(45.0)
    kx = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                   np.float64(b), nu, theta, -1.0, xp=np))
    ko = float(gyroresonance_kappa(np.float64(ne), np.float64(te),
                                   np.float64(b), nu, theta, 1.0, xp=np))
    assert kx > ko > 0


def test_layer_depth_matches_closed_form():
    """Quantitative check: integrating gyroresonance_kappa through a
    linear-B resonance layer must reproduce the standard closed-form
    layer depth (Zheleznyakov / Dulk 1985 eq. 45 / White & Kundu 1997)

        tau(s, sigma, theta) = (pi^2 / 2c) (nu_p^2 / nu) L_B (s^2 / s!)
                               (s^2 beta^2 sin^2(theta) / 2)^(s-1)
                               F_sigma(theta)

    with the exact F_sigma obtained HERE from the independent SVD
    null-space polarization solve (not the closed form the implementation
    uses). The X-mode tau(s=2, 3) must sit in the literature's 'strongly
    optically thick' regime for active-region parameters (tau >> 1;
    White & Kundu 1997 quote tau ~ 1e2-1e6)."""
    from math import factorial

    c_cgs = 2.998e10
    ne, te = 1e10, 3e6             # active-region base values
    theta = np.deg2rad(50.0)
    l_b = 1e9                                  # B scale length, cm
    nu = 3e9                                   # 3 GHz observation
    for s, sigma in ((2, -1.0), (2, 1.0), (3, -1.0), (3, 1.0)):
        b_res = nu / (s * 2.7992e6)            # field at the resonance
        # numeric layer integral of kappa over B(x) linear in x
        xs = np.linspace(-0.35 * l_b, 0.35 * l_b, 6001)
        b_x = b_res * (1.0 + xs / l_b)
        kap = gyroresonance_kappa(np.float64(ne), np.float64(te), b_x, nu,
                                  theta, sigma, xp=np)
        tau_num = np.trapezoid(kap, xs)
        # closed form, constants written out independently; F from the
        # SVD oracle at the layer center (X, Y = 1/s)
        nu_p_sq = (8.93e3) ** 2 * ne
        beta2 = 1.38065e-16 * te / (9.1094e-28 * c_cgs ** 2)
        f_sig = _svd_coupling(nu_p_sq / nu ** 2, 1.0 / s, theta, sigma)
        tau_ref = (np.pi ** 2 / (2 * c_cgs)) * (nu_p_sq / nu) * l_b \
            * (s ** 2 / factorial(s)) \
            * (s ** 2 * beta2 * np.sin(theta) ** 2 / 2.0) ** (s - 1) * f_sig
        np.testing.assert_allclose(tau_num, tau_ref, rtol=0.03,
                                   err_msg=f"s={s} sigma={sigma}")
        if sigma < 0:                          # X mode: optically thick
            assert 1e2 < tau_num < 1e8, (s, tau_num)


def test_harmonic_visibility_pattern_anchor():
    """Independent literature anchor: the canonical harmonic-visibility
    pattern of thermal gyroresonance over active regions (White & Kundu
    1997; White 2004 review) — at typical AR parameters the X-mode corona
    is optically thick through harmonic s = 3 and the O-mode through
    s = 2, while s = 4 is thin for both modes at ~3 MK; successive
    harmonics drop by orders of magnitude.

    Unlike test_layer_depth_matches_closed_form (which checks the
    implementation against ITS OWN formula family), the expectation here
    is the published observational/theoretical pattern itself, typed in
    as optical-depth bounds; the layer depths are obtained by numerically
    integrating gyroresonance_kappa through a linear-B layer. Canonical
    parameters: nu = 5 GHz, theta = 45 deg, n_e = 1e9 cm^-3, T_e = 3 MK,
    L_B = 1e9 cm (harmonic layers then sit at B = 595/446/357 G for
    s = 3/4/5 — sunspot-strength fields, the GR regime)."""
    ne, te, l_b, nu = 1e9, 3e6, 1e9, 5e9
    theta = np.deg2rad(45.0)

    def layer_tau(s, sigma):
        b_res = nu / (s * 2.7992e6)
        # +-0.1 L_B: ~6 Gaussian layer widths (beta |cos| ~ 0.016 L_B),
        # yet narrow enough to exclude the ADJACENT harmonic's layer
        # (s -> s+1 sits at a 1/(s+1)-fractional lower field, e.g. -25%
        # for s=3 -> 4; a wider window double-counts neighboring layers)
        xs = np.linspace(-0.1 * l_b, 0.1 * l_b, 6001)
        b_x = b_res * (1.0 + xs / l_b)
        kap = gyroresonance_kappa(np.float64(ne), np.float64(te), b_x, nu,
                                  theta, sigma, xp=np)
        return float(np.trapezoid(kap, xs))

    tau_x = {s: layer_tau(s, -1.0) for s in (2, 3, 4)}
    tau_o = {s: layer_tau(s, 1.0) for s in (2, 3, 4)}
    # X mode: deeply thick at s=2, thick at s=3, thin at s=4 (at 3 MK)
    assert tau_x[2] > 1e2, tau_x
    assert 1.0 < tau_x[3] < 1e3, tau_x
    assert tau_x[4] < 1.0, tau_x
    # O mode: thick at s=2, thin at s=3 — one harmonic below X
    assert tau_o[2] > 10.0, tau_o
    assert tau_o[3] < 1.0, tau_o
    # mode ratio: X over O by >= an order of magnitude at the same harmonic
    assert tau_x[3] > 10.0 * tau_o[3], (tau_x, tau_o)
    # successive harmonics drop steeply (thermal (s^2 beta^2)^(s-1) scaling)
    assert tau_x[2] > 30.0 * tau_x[3] and tau_x[3] > 30.0 * tau_x[4]


def test_transfer_with_gr_flag():
    """mechanism=1+2+4 adds gyroresonance absorption to the transfer; an
    optically thin free-free slab becomes optically thick at a resonance."""
    nz, n_pix = 10, 1
    b = 100.0
    nu = np.array([3 * 2.7992e6 * b])   # third harmonic
    ds = np.full((nz, n_pix), 1e8)
    te = np.full((nz, n_pix), 2e6)
    ne = np.full((nz, n_pix), 1e9)
    bb = np.full((nz, n_pix), b)
    valid = np.ones((nz, n_pix), bool)
    ff = grff_transfer(ds, te, ne, bb, valid, nu, AREA, theta_deg=45.0,
                       mechanism=1)
    gr = grff_transfer(ds, te, ne, bb, valid, nu, AREA, theta_deg=45.0,
                       mechanism=1 + 2 + 4)
    assert float(gr.tau_x[0, 0]) > 10 * float(ff.tau_x[0, 0])
    assert float(gr.flux_x[0, 0]) > float(ff.flux_x[0, 0])
