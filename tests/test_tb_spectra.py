"""The sweep's shared-compilation lattice (cli/tb_spectra.quantize_params)."""

import numpy as np

from raytracinggrff_jax.cli.tb_spectra import quantize_params, select_params


def test_quantize_params_lattice():
    seen_grids, seen_cubes, seen_variants = set(), set(), set()
    for f in np.logspace(np.log10(30.0), np.log10(800.0), 30) * 1e6:
        p = select_params(float(f))
        q = quantize_params(p)
        # only ever grants MORE resolution / steps / records
        assert q["grid_n"] >= p["grid_n"]
        assert q["n_steps"] >= p["n_steps"]
        assert q["grid_extent"] >= p["grid_extent"]
        # cell size never coarser than the preset's
        assert (2 * q["grid_extent"] / q["grid_n"]
                <= 2 * p["grid_extent"] / p["grid_n"] + 1e-12)
        assert q["grid_n"] % 64 == 0
        assert (q["grid_extent"] / 0.25) % 1.0 == 0.0
        # stride rounds DOWN onto powers of two: denser records, never
        # sparser
        s = q["record_stride"]
        assert s <= p["record_stride"] and (s & (s - 1)) == 0
        # a whole number of 25-record quanta
        assert q["n_steps"] % (s * 25) == 0
        seen_grids.add(q["grid_n"])
        seen_cubes.add((q["grid_n"], q["grid_extent"]))
        seen_variants.add((q["grid_n"], s))
    # the lattice actually shares shapes/compiles across the production
    # sweep (the raw presets need 15 cubes and 19 compiled variants)
    assert len(seen_grids) <= 5
    assert len(seen_cubes) <= 10
    assert len(seen_variants) <= 8
