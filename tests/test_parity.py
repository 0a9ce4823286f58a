"""The cross-backend T_b comparison (utils/parity.compare_tb) on synthetic
maps: free-free pixels tight, gyroresonance-sensitive pixels by median and
max, and no outlier outside the GR-sensitive set."""

import numpy as np
import pytest

from raytracinggrff_jax.utils.parity import compare_tb, format_checks

rng = np.random.default_rng(0)
WANT = rng.uniform(2e4, 2e6, 400)
GR = np.where(np.arange(400) < 200, 0.0, 0.1)   # second half GR-sensitive


def _got(ff_rel, gr_rel):
    got = WANT.copy()
    got[:200] *= 1 + ff_rel
    got[200:] *= 1 + gr_rel
    return got


@pytest.mark.parametrize("ff_rel,gr_rel,ok", [
    (1e-3, 1e-2, True),             # inside every limit
    (1e-2, 0.0, False),             # a free-free pixel off by 1 %
    (0.0, 3e-2, False),             # GR median above 2 %
    (0.0, np.r_[np.zeros(199), 0.2], True),  # one GR pixel off by 20 %
])
def test_compare_tb_classes(ff_rel, gr_rel, ok):
    st = compare_tb(_got(ff_rel, gr_rel), WANT, gr_effect=GR)
    assert st["ok"] is ok, format_checks(st, "case")
    assert st["n_ff"] == 200 and st["n_gr"] == 200


def test_compare_tb_outliers_and_nonfinite():
    got = _got(0.0, 0.0)
    got[5] = np.nan
    st = compare_tb(got, WANT)
    assert not st["ok"] and st["n_nonfinite"] == 1
    # without GR information every pixel is free-free
    st = compare_tb(_got(0.0, 0.1), WANT)
    assert not st["ok"] and st["n_outliers_not_gr"] == 200
    # dark pixels (both maps below lit_min) take no part
    st = compare_tb(np.full(10, 10.0), np.full(10, 20.0))
    assert st["n_lit"] == 0 and not st["ok"]
