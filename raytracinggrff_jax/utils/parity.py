"""Brightness-temperature comparison across backends, with stated limits.

Two backends (the GPU and the host CPU, or one GPU at two array shapes) run
the same float32 program but sum in other orders and fuse multiply-adds
differently, so their maps agree to rounding, not bit for bit. Where the
physics amplifies rounding, the tolerance follows it:

* Free-free opacity is smooth in n_e, T_e and B, so a pixel dominated by
  free-free emission holds a tight relative T_b tolerance (`tight`).
* A gyroresonance layer amplifies a relative jitter dB/B by
  d(ln kappa)/d(ln B) ~ 2 x^2 ~ s/beta_th = O(10^2) at the voxels on the
  layer's edge, so a pixel whose ray grazes a layer can move by ~10 %.
  These GR-sensitive pixels are held by their median (`gr_median`) and max
  (`gr_max`) instead, and every pixel off by more than `outlier` must be
  GR-sensitive.

A pixel is GR-sensitive when switching gyroresonance off (the same scene
with the mechanism's bit 2 cleared) changes its T_b by more than
`gr_threshold`; `gr_effect` is that relative change per pixel.
"""

from __future__ import annotations

import numpy as np


def compare_tb(got, want, gr_effect=None, lit_min=1e4, tight=5e-3,
               gr_median=2e-2, gr_max=0.25, outlier=2e-2,
               gr_threshold=1e-3):
    """Compare two T_b maps. Returns a dict: the statistics, `checks`
    as (name, value, limit, passed) rows, and `ok`.

    A pixel takes part when either map is above `lit_min` K; a pixel that
    is non-finite in either map fails the comparison.
    """
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    finite = np.isfinite(got) & np.isfinite(want)
    lit = finite & ((want > lit_min) | (got > lit_min))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    if gr_effect is None:
        gr = np.zeros(got.shape, bool)
    else:
        gr = np.asarray(gr_effect, np.float64) > gr_threshold
    ff = lit & ~gr
    grl = lit & gr

    def stat(fn, mask):
        return float(fn(rel[mask])) if mask.any() else 0.0

    stats = {
        "n_lit": int(lit.sum()), "n_ff": int(ff.sum()),
        "n_gr": int(grl.sum()), "n_nonfinite": int((~finite).sum()),
        "ff_max_rel": stat(np.max, ff), "ff_median_rel": stat(np.median, ff),
        "gr_max_rel": stat(np.max, grl),
        "gr_median_rel": stat(np.median, grl),
        "n_outliers_not_gr": int((lit & (rel > outlier) & ~gr).sum()),
    }

    def upper(name, key, limit):
        return (name, stats[key], limit, stats[key] <= limit)

    stats["checks"] = [
        upper("non-finite pixels", "n_nonfinite", 0),
        ("lit pixels", stats["n_lit"], 1, stats["n_lit"] >= 1),
        upper("free-free max rel", "ff_max_rel", tight),
        upper("GR-sensitive median rel", "gr_median_rel", gr_median),
        upper("GR-sensitive max rel", "gr_max_rel", gr_max),
        upper(f"outliers > {outlier:g} not GR-sensitive",
              "n_outliers_not_gr", 0),
    ]
    stats["ok"] = all(ok for *_, ok in stats["checks"])
    return stats


def format_checks(stats, label):
    """One line per check: value beside its limit."""
    return "\n".join(
        f"  {label}: {name} = {value:.4g} (limit "
        f"{'>=' if name == 'lit pixels' else '<='} {limit:g}) "
        f"{'ok' if ok else 'FAIL'}"
        for name, value, limit, ok in stats["checks"])
