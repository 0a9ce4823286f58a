"""Float64 NumPy reference implementation of the GRFF transfer.

This is the framework's "CPU reference" for brightness-temperature parity
(BASELINE.md target: the JAX float32 path within <= 1% of it). It evaluates
the identical physics (grff/physics.py with xp=numpy) in float64 with an
explicit per-voxel loop — the same role the external GRFF_DEM_Transfer.so
plays for the reference repo. Covers the full Parms contract: mechanism
flags 1/2/4 (free-free, gyroresonance, neutrals), per-voxel theta with the
handedness swap (Parms[4]), per-voxel source areas (Parms[14]), harmonic
cap (Parms[7]), and both Gaunt options.
"""

from __future__ import annotations

import numpy as np

from ..constants import AU_CM, C_CGS, KB_CGS, SFU2CGS
from .physics import (O_MODE, X_MODE, freefree_kappa, gyroresonance_kappa)


def grff_transfer_reference(ds, te, ne, b, valid, freqs_hz, pixel_area_cm2,
                            s_area_cm2=None, theta_deg=90.0,
                            include_neutrals=True, mechanism=None,
                            s_max=30, gaunt="dulk"):
    """Same contract as transfer.grff_transfer, computed in float64.

    mechanism: bit flags (1 free-free, 2 gyroresonance, 4 neutral-H); the
    legacy include_neutrals bool is honored when mechanism is None.
    theta_deg: scalar, (Nz,), or (Nz, n_pix) degrees; per-voxel values
    swap the two output slots where cos(theta) < 0 (handedness, mirroring
    transfer.make_voxel_update).
    Returns dict with flux_o, flux_x (n_pix, Nf) in SFU and tau_o, tau_x.
    """
    ds = np.asarray(ds, np.float64)
    te = np.asarray(te, np.float64)
    ne = np.asarray(ne, np.float64)
    b = np.asarray(b, np.float64)
    valid = np.asarray(valid, bool)
    freqs = np.asarray(freqs_hz, np.float64)
    nz, n_pix = ds.shape
    nf = freqs.shape[0]
    if mechanism is None:
        mechanism = 1 | (4 if include_neutrals else 0)
    include_ff = bool(mechanism & 1)
    include_gr = bool(mechanism & 2)
    include_n = bool(mechanism & 4)
    theta_arr = np.broadcast_to(
        np.deg2rad(np.asarray(theta_deg, np.float64)).reshape(
            (-1, 1) if np.ndim(theta_deg) == 1 else np.shape(theta_deg)
            or (1, 1)),
        (nz, n_pix))
    per_voxel_theta = np.ndim(theta_deg) > 0
    if s_area_cm2 is None:
        s_area_cm2 = np.zeros_like(ds)
    else:
        s_area_cm2 = np.asarray(s_area_cm2, np.float64)

    src_coef = (KB_CGS / C_CGS ** 2 * freqs ** 2 / AU_CM ** 2 / SFU2CGS)

    flux = {O_MODE: np.zeros((n_pix, nf)), X_MODE: np.zeros((n_pix, nf))}
    tau_tot = {O_MODE: np.zeros((n_pix, nf)), X_MODE: np.zeros((n_pix, nf))}

    for k in range(nz):
        mask = (valid[k] & np.isfinite(ne[k]) & np.isfinite(te[k])
                & np.isfinite(b[k]) & np.isfinite(ds[k]) & (ds[k] > 0))
        if not np.any(mask):
            continue
        area = np.where(s_area_cm2[k] > 0, s_area_cm2[k], pixel_area_cm2)
        theta_k = theta_arr[k][:, None]
        ne_s = np.where(mask, ne[k], 1.0)[:, None]
        te_s = np.where(mask, te[k], 1e6)[:, None]
        b_s = np.where(mask, b[k], 0.0)[:, None]

        taus, evans = {}, {}
        for sigma in (O_MODE, X_MODE):
            kappa, n2 = freefree_kappa(
                ne_s, te_s, b_s, freqs[None, :], theta_k, sigma,
                include_neutrals=include_n, xp=np, gaunt=gaunt)
            if not include_ff:
                kappa = np.zeros_like(kappa)
            if include_gr:
                kappa = kappa + gyroresonance_kappa(
                    ne_s, te_s, b_s, freqs[None, :], theta_k, sigma,
                    s_max=s_max, xp=np)
            tau = np.where(mask[:, None], kappa * ds[k][:, None], 0.0)
            taus[sigma] = np.where(np.isfinite(tau), tau, 0.0)
            evans[sigma] = mask[:, None] & (n2 <= 0.0)

        if per_voxel_theta:
            # handedness: B against k swaps the two output slots
            # (transfer.make_voxel_update, same -1e-6 dead zone)
            swap = np.cos(theta_k) < -1e-6
            tau_o = np.where(swap, taus[X_MODE], taus[O_MODE])
            tau_x = np.where(swap, taus[O_MODE], taus[X_MODE])
            evan_o = np.where(swap, evans[X_MODE], evans[O_MODE])
            evan_x = np.where(swap, evans[O_MODE], evans[X_MODE])
            slot = {O_MODE: (tau_o, evan_o), X_MODE: (tau_x, evan_x)}
        else:
            slot = {s: (taus[s], evans[s]) for s in (O_MODE, X_MODE)}

        for sigma in (O_MODE, X_MODE):
            tau, evan = slot[sigma]
            att = np.exp(-tau)
            src = (np.where(mask, te[k], 0.0)[:, None]
                   * src_coef[None, :] * area[:, None])
            f = flux[sigma] * att + src * (1.0 - att)
            flux[sigma] = np.where(evan, 0.0, f)
            tau_tot[sigma] = np.where(evan, np.inf, tau_tot[sigma] + tau)

    return {
        "freqs_ghz": freqs / 1e9,
        "flux_o": flux[O_MODE], "flux_x": flux[X_MODE],
        "tau_o": tau_tot[O_MODE], "tau_x": tau_tot[X_MODE],
    }
