"""Free-free / magnetoionic plasma emission physics (CGS).

Native reimplementation of the physics inside the external GRFF library
(`GRFF_DEM_Transfer.so`, Fleishman, Kuznetsov & Landi 2021 algorithm family).
The reference calls it as an opaque C++ binary via ctypes
(script/synthetic_FF_map_single_thread.py:27-35); here the coefficients are
ordinary jax-traceable functions so the whole transfer runs in one XLA graph.

Written to be dtype-polymorphic: works with jax.numpy arrays (float32 on device)
and with plain numpy float64 (the parity reference in grff/reference.py calls
these same formulas through numpy via the `xp` argument).

Physics summary
---------------
Magnetoionic modes sigma = +1 (ordinary, O) and sigma = -1 (extraordinary, X).

Appleton-Hartree (collisionless) refractive index with
X = (nu_p/nu)^2, Y = nu_B/nu, Y_T = Y sin(theta), Y_L = Y cos(theta):

    n_sigma^2 = 1 - X(1-X) / (1 - X - Y_T^2/2
                              + sigma*sqrt(Y_T^4/4 + (1-X)^2 Y_L^2))

Free-free absorption per mode (Dulk 1985 eq. 20 generalized to the
magnetoionic denominator; thermal bremsstrahlung, Rayleigh-Jeans limit):

    kappa_sigma = 9.786e-3 * n_e * Sum(Z^2 n_i) * lnLambda
                  / ( n_sigma * (nu + sigma*nu_B*|cos theta|)^2 * T^{3/2} )

with the Coulomb logarithm
    lnLambda = 18.2 + 1.5 ln T - ln nu   (T < 2e5 K)
    lnLambda = 24.5 + ln T - ln nu       (T >= 2e5 K)

Electron-neutral-hydrogen collisions (mechanism flag bit 2, value 4): the
neutral fraction follows the hydrogen Saha equation, and the extra opacity is
expressed through the electron-neutral collision frequency
nu_en = n_H * sigma_eH * sqrt(8 kT / pi m_e), added in the high-frequency
collisional-absorption form kappa = (nu_p^2 / nu_eff_denom^2) * nu_en / (c n_sigma).
This is negligible for coronal temperatures but reproduces the reference's
"+4" behavior for cool chromospheric voxels.
"""

from __future__ import annotations

import numpy as _np
import jax
import jax.numpy as jnp

from ..constants import C_CGS, FPE_COEF, FB_COEF, KB_CGS, M_E_G

# kappa_ff prefactor, cm^-1 when nu in Hz, T in K, n in cm^-3 (Dulk 1985)
KAPPA_FF_COEF = 9.786e-3

# --- exact (classical/Born) free-free Gaunt factor, flag gaunt='exact' ---
# First-principles bremsstrahlung opacity in the Rayleigh-Jeans limit:
#   kappa = KAPPA_FF_EXACT_COEF * n_e n_i g(T, nu) / (T^{3/2} nu_eff^2 n_sigma)
#   KAPPA_FF_EXACT_COEF = (4 e^6 / (3 m c k_B)) sqrt(2 pi / (3 k_B m))
# with the frequency-averaged Gaunt factor (the same formulas the GRFF
# binary's Fleishman & Kuznetsov 2021 code family uses):
#   classical (low T):  g_cl = (sqrt3/pi) ln[(2 k T)^{3/2}/(pi e^2 m^{1/2}
#                              e^gamma nu)]  (Scheuer 1960)
#   Born (high T):      g_B  = (sqrt3/pi) ln[4 k T/(e^gamma h nu)] (Elwert)
# joined by g = max(g_cl, g_B) (the crossover sits near T ~ 2-6e5 K for
# 30-800 MHz). MEASURED DRIFT of the Dulk 1985 piecewise lnLambda used by
# default (tests/test_gaunt.py keeps these numbers honest): Dulk kappa is
# LOW by 1-13% over nu in [30, 800] MHz, T in [1e4, 2e6] K — worst 13% at
# (1e4 K, 800 MHz), 0.8% at the 2e5 K branch switch, 4-7% for coronal
# 1-2 MK plasma. Optically-thick brightness temperatures saturate to T_e,
# so the T_b impact is well below the kappa drift; quiet-Sun map tests
# measure < 2% T_b shift between the two. Default stays 'dulk' for strict
# behavioral parity with the reference pipelines.
_GAMMA_EULER = 0.5772156649015329
SQRT3_OVER_PI = float(_np.sqrt(3.0) / _np.pi)


def _exact_gaunt_constants():
    from ..constants import C_CGS, E_ESU, H_ERG_S, KB_CGS, M_E_G
    e, m, c, k, h = E_ESU, M_E_G, C_CGS, KB_CGS, H_ERG_S
    coef = (4.0 * e ** 6 / (3.0 * m * c * k)) * _np.sqrt(
        2.0 * _np.pi / (3.0 * k * m))
    g_cl = _np.log((2.0 * k) ** 1.5
                   / (_np.pi * e * e * _np.sqrt(m) * _np.exp(_GAMMA_EULER)))
    g_born = _np.log(4.0 * k / (_np.exp(_GAMMA_EULER) * h))
    return float(coef), float(g_cl), float(g_born)


KAPPA_FF_EXACT_COEF, GAUNT_CL_CONST, GAUNT_BORN_CONST = \
    _exact_gaunt_constants()
# hydrogen Saha prefactor: n_e n_p / n_H = SAHA_COEF * T^1.5 * exp(-CHI_H/T)
SAHA_COEF = 2.4147e15
CHI_H_OVER_K = 1.5789e5       # 13.6 eV / k_B, K
SIGMA_EH_CM2 = 3.5e-15        # low-energy elastic e-H cross-section, cm^2

O_MODE = 1.0
X_MODE = -1.0


def coulomb_log(te, nu, xp=jnp):
    """Piecewise Coulomb logarithm (Dulk 1985 Section 2)."""
    ln_t = xp.log(te)
    ln_nu = xp.log(nu)
    low = 18.2 + 1.5 * ln_t - ln_nu
    high = 24.5 + ln_t - ln_nu
    lam = xp.where(te < 2e5, low, high)
    return xp.maximum(lam, 0.0)


def refractive_index_sq(X, Y, theta_rad, sigma, xp=jnp):
    """Appleton-Hartree n^2 for mode sigma (+1 O, -1 X). May be <= 0
    (evanescent)."""
    st = xp.sin(theta_rad)
    ct = xp.cos(theta_rad)
    yt2 = (Y * st) ** 2
    yl2 = (Y * ct) ** 2
    one_m_x = 1.0 - X
    root = xp.sqrt(yt2 * yt2 / 4.0 + one_m_x * one_m_x * yl2)
    denom = one_m_x - yt2 / 2.0 + sigma * root
    # guard exact-zero denominators; evanescence is detected by n2 <= 0
    safe = xp.where(xp.abs(denom) > 1e-30, denom, 1e-30)
    return 1.0 - X * one_m_x / safe


def saha_neutral_hydrogen(ne, te, xp=jnp):
    """Neutral-hydrogen density from the Saha equation, n_p ~= n_e."""
    te = xp.maximum(te, 500.0)
    rhs = SAHA_COEF * te ** 1.5 * xp.exp(-CHI_H_OVER_K / te)
    return ne * ne / xp.maximum(rhs, 1e-30)


def gyro_polarization_coupling(X, Y, theta_rad, sigma, xp=jnp):
    """Exact magnetoionic polarization coupling F_sigma(theta) for thermal
    gyroresonance (Zheleznyakov 1970 / Zlotnik 1968 family), replacing the
    quasi-longitudinal (1 - sigma|cos|)^2 / 2.

    Derivation (cold-plasma Stix frame: B along z, k in the x-z plane at
    angle theta): the s-th-harmonic resonant current couples, at leading
    order in the thermal Larmor parameter, to the wave field component
    rotating about B in the electron gyration sense, so

        F_sigma = |e_x - i e_y|^2 / ||e||^2

    with e the exact polarization (null vector of the cold wave operator)
    of the Appleton-Hartree mode sigma. Using the Stix components
    S = 1 - X/(1-Y^2), D = -XY/(1-Y^2), P = 1 - X and the null vector from
    rows 2 x 3 of the operator,
        e = ((S-n^2)(P-n^2 sin^2),  -iD (P-n^2 sin^2),
             -(S-n^2) n^2 cos sin),
    this closes to (A = n^2_sigma - S, d = P - n^2 sin^2 theta):

        F_sigma = (A + D)^2 d^2
                  / (A^2 d^2 + D^2 d^2 + A^2 n^4 cos^2 sin^2)

    Limits (all verified by tests/test_gyroresonance.py against an
    independent SVD null-space solve):
      * QL regime (Y_L^2 >> Y_T^4/4, X << 1): modes are circular about
        k-hat; projecting onto rotation about B gives exactly
        (1 - sigma|cos theta|)^2 / 2 — the classical QL factor.
      * theta -> 0: F_X -> 2 (sigma = -1 couples fully), F_O -> 0.
      * theta -> 90 deg: the O mode becomes E || B (e -> z-hat) and its
        coupling vanishes like cos^2 theta, while the X mode stays
        elliptical in the transverse plane with F_X = (A+D)^2/(A^2+D^2)
        ~ O(1) — the exact X/O asymmetry the QL form misses by orders of
        magnitude.
    Known caveat: inside the quasi-transverse mode-coupling sliver
    |90 deg - theta| ~ sqrt(X) rad the 'O'-labelled branch exchanges
    character with the plasma oscillation and this closed form
    underestimates its coupling; geometric-optics mode labels are
    themselves ambiguous there.
    """
    n2 = refractive_index_sq(X, Y, theta_rad, sigma, xp=xp)
    one_m_y2 = 1.0 - Y * Y
    safe = xp.where(xp.abs(one_m_y2) > 1e-12,
                    one_m_y2, xp.where(one_m_y2 >= 0, 1e-12, -1e-12))
    s_stix = 1.0 - X / safe
    d_stix = -X * Y / safe
    p_stix = 1.0 - X
    st = xp.sin(theta_rad)
    ct = xp.cos(theta_rad)
    a = n2 - s_stix
    d_l = p_stix - n2 * st * st
    num = (a + d_stix) ** 2 * d_l * d_l
    den = (a * a + d_stix * d_stix) * d_l * d_l \
        + a * a * (n2 * n2) * (ct * st) ** 2
    return num / xp.maximum(den, 1e-38)


def gyroresonance_kappa(ne, te, b, nu, theta_rad, sigma, s_max=30, xp=jnp):
    """Thermal gyroresonance opacity summed over harmonics s=2..s_max
    [cm^-1] (mechanism flag 2; Parms[7] harmonic cap contract).

    Normalized so the layer-integrated depth reproduces the standard
    thermal gyroresonance result (Zheleznyakov 1970 / Dulk 1985 /
    White & Kundu 1997 form)
        tau(s, sigma, theta) = (pi^2/(2c)) (nu_p^2/nu) L_B (s^2/s!)
                               (s^2 beta^2 sin^2/2)^(s-1) F_sigma(theta),
    i.e. per unit length
        kappa_s(nu) = tau(s)/L_B * s*nu_B
                      * Gauss(nu - s nu_B; sigma_nu = s nu_B beta |cos|)
    with beta^2 = kT/(m c^2) and F_sigma the EXACT magnetoionic
    polarization coupling (gyro_polarization_coupling: the projection of
    the mode's cold-plasma polarization vector onto the electron-sense
    rotation about B). sigma = -1 is the more opaque X mode. In the
    quasi-longitudinal regime F reduces to the classical
    (1 - sigma|cos|)^2 / 2; toward theta -> 90 deg it captures the exact
    X/O asymmetry (O-mode coupling vanishes like cos^2 theta, X stays
    O(1)) that the QL form misses by orders of magnitude
    (tests/test_gyroresonance.py pins both regimes against an independent
    SVD null-space polarization solve).
    |cos theta| is floored at 0.01 in the LINE WIDTH only: the Doppler
    Gaussian degenerates at exactly perpendicular propagation (the
    physical line shape there is set by finite-Larmor effects outside
    this model; the reference pipelines pass theta=90 with gyroresonance
    disabled, Parms[6]=1+4).

    Harmonic terms are evaluated in log space ((s-1) log(...) - lgamma(s+1))
    so s! up to 30 stays inside float32 range.
    """
    from math import lgamma

    nu_p_sq = (FPE_COEF ** 2) * ne
    nu_b = xp.maximum(FB_COEF * b, 1.0)
    beta2 = KB_CGS * te / (M_E_G * C_CGS * C_CGS)
    beta = xp.sqrt(beta2)
    st2 = xp.sin(theta_rad) ** 2
    act = xp.maximum(xp.abs(xp.cos(theta_rad)), 0.01)
    f_sigma = gyro_polarization_coupling(nu_p_sq / (nu * nu), nu_b / nu,
                                         theta_rad, sigma, xp=xp)

    pref = (_np.pi ** 2 / (2.0 * C_CGS)) * nu_p_sq / nu * f_sigma
    log_arg = xp.log(xp.maximum(beta2 * st2 / 2.0, 1e-38))

    total = 0.0
    for s in range(2, int(s_max) + 1):
        width = s * nu_b * beta * act
        log_term = (2.0 * _np.log(float(s))
                    + (s - 1) * (log_arg + 2.0 * _np.log(float(s)))
                    - lgamma(s + 1))
        gauss = (xp.exp(-((nu - s * nu_b) ** 2) / (2.0 * width * width))
                 / (_np.sqrt(2.0 * _np.pi) * width))
        total = total + (s * nu_b) * xp.exp(log_term) * gauss
    return pref * total


def trapezoid_weights(t_grid, xp=_np):
    """Trapezoid quadrature weights for a (possibly nonuniform) ascending
    1-D grid: w_0=(T1-T0)/2, w_j=(T_{j+1}-T_{j-1})/2, w_last symmetric."""
    dt = t_grid[1:] - t_grid[:-1]
    w = xp.concatenate([dt[:1] / 2.0,
                        (dt[1:] + dt[:-1]) / 2.0,
                        dt[-1:] / 2.0])
    return w


def dem_freefree_moments(t_grid, dem, nu, xp=jnp, gaunt="dulk"):
    """Free-free kernel moments of a per-voxel DEM(T) distribution.

    The single-temperature opacity kappa = coef * ne*ni * g(T,nu)
    / (n_sigma eff_nu^2 T^{3/2}) generalizes under a differential emission
    measure DEM(T) = d(ne^2 dl)/dT [cm^-5 K^-1] per voxel (the DEM-mode
    contract of the real GRFF_DEM_Transfer ABI, Fleishman, Kuznetsov &
    Landi 2021: the voxel's path length lives inside the DEM column, so
    kappa*ds is replaced by the T-integral) to

        tau_sigma = coef / (n_sigma eff_nu^2) * M_k(nu)
        M_k(nu)   = int DEM(T) g(T, nu) T^{-3/2} dT          (trapezoid)

    and the emission integral has one extra power of T, giving a
    mode-independent effective source temperature

        T_eff(nu) = int DEM g T^{-1/2} dT / M_k(nu).

    t_grid: (NT,) K ascending; dem: (NT, Nz) cm^-5 K^-1; nu: (Nf,) Hz.
    Returns (m_k, t_eff), each (Nz, Nf). g is the Dulk lnLambda (pair with
    KAPPA_FF_COEF) or the classical/Born Gaunt factor (pair with
    KAPPA_FF_EXACT_COEF) per the `gaunt` flag, matching freefree_kappa.
    """
    t = xp.asarray(t_grid)[:, None]            # (NT, 1)
    nu2 = xp.asarray(nu)[None, :]              # (1, Nf)
    if gaunt == "exact":
        g = exact_gaunt(t, nu2, xp=xp)         # (NT, Nf)
    else:
        g = coulomb_log(t, nu2, xp=xp)
    w = trapezoid_weights(xp.asarray(t_grid), xp=xp)[:, None]   # (NT, 1)
    dem = xp.asarray(dem)                      # (NT, Nz)
    a_k = (dem * (w * t ** -1.5)).T            # (Nz, NT)
    a_j = (dem * (w * t ** -0.5)).T
    if xp is _np:
        m_k = a_k @ g                          # (Nz, Nf)
        m_j = a_j @ g
    else:
        # full f32: a GPU would otherwise run these products in TF32
        # (~3 decimal digits), far outside the DEM parity tolerance
        hi = jax.lax.Precision.HIGHEST
        m_k = jnp.matmul(a_k, g, precision=hi)
        m_j = jnp.matmul(a_j, g, precision=hi)
    t_eff = m_j / xp.maximum(m_k, 1e-300 if xp is _np else 1e-38)
    return m_k, t_eff


def exact_gaunt(te, nu, xp=jnp):
    """Frequency-averaged free-free Gaunt factor, max(classical, Born)
    (see the derivation block above KAPPA_FF_EXACT_COEF)."""
    ln_t = xp.log(te)
    ln_nu = xp.log(nu)
    g_cl = GAUNT_CL_CONST + 1.5 * ln_t - ln_nu
    g_born = GAUNT_BORN_CONST + ln_t - ln_nu
    return SQRT3_OVER_PI * xp.maximum(xp.maximum(g_cl, g_born), 0.0)


def neutral_hydrogen_kappa(ne, te, b, nu, theta_rad, sigma, xp=jnp):
    """Electron-neutral-hydrogen collisional opacity [cm^-1] alone
    (mechanism flag 4; Saha neutral fraction). Split out of freefree_kappa
    so per-voxel mechanism masks (the real GET_MW ABI lets Parms[6] vary
    along the LOS) can gate it independently of the bremsstrahlung term."""
    nu_p_sq = (FPE_COEF ** 2) * ne
    nu_b = FB_COEF * b
    X = nu_p_sq / (nu * nu)
    Y = nu_b / nu
    n2 = refractive_index_sq(X, Y, theta_rad, sigma, xp=xp)
    n_sigma = xp.sqrt(xp.maximum(n2, 1e-12))
    eff_nu = nu + sigma * nu_b * xp.abs(xp.cos(theta_rad))
    eff_nu_sq = xp.maximum(eff_nu * eff_nu, 1e-30)
    n_h = saha_neutral_hydrogen(ne, te, xp=xp)
    v_mean = xp.sqrt(8.0 * KB_CGS * te / (_np.pi * M_E_G))
    nu_en = n_h * SIGMA_EH_CM2 * v_mean
    return nu_p_sq / eff_nu_sq * nu_en / (C_CGS * n_sigma)


def freefree_kappa(ne, te, b, nu, theta_rad, sigma,
                   include_neutrals=True, zion_factor=1.0, xp=jnp,
                   gaunt="dulk"):
    """Free-free absorption coefficient [cm^-1] for one magnetoionic mode.

    Returns (kappa, n_sigma_sq). Evanescent voxels (n^2 <= 0) return
    kappa = inf sentinel is NOT used; the caller must test n_sigma_sq <= 0.
    gaunt: 'dulk' (reference-parity Dulk 1985 lnLambda, default) or
    'exact' (classical/Born Gaunt factor, see module constants).
    """
    nu_p_sq = (FPE_COEF ** 2) * ne            # nu_p^2, Hz^2
    nu_b = FB_COEF * b
    X = nu_p_sq / (nu * nu)
    Y = nu_b / nu
    n2 = refractive_index_sq(X, Y, theta_rad, sigma, xp=xp)
    n_sigma = xp.sqrt(xp.maximum(n2, 1e-12))

    eff_nu = nu + sigma * nu_b * xp.abs(xp.cos(theta_rad))
    eff_nu_sq = xp.maximum(eff_nu * eff_nu, 1e-30)

    if gaunt == "exact":
        coef = KAPPA_FF_EXACT_COEF
        lnlam = exact_gaunt(te, nu, xp=xp)
    else:
        coef = KAPPA_FF_COEF
        lnlam = coulomb_log(te, nu, xp=xp)
    t32 = te * xp.sqrt(te)
    kappa = (coef * ne * (zion_factor * ne) * lnlam
             / (n_sigma * eff_nu_sq * t32))

    if include_neutrals:
        n_h = saha_neutral_hydrogen(ne, te, xp=xp)
        v_mean = xp.sqrt(8.0 * KB_CGS * te / (_np.pi * M_E_G))
        nu_en = n_h * SIGMA_EH_CM2 * v_mean
        kappa = kappa + nu_p_sq / eff_nu_sq * nu_en / (C_CGS * n_sigma)

    return kappa, n2
