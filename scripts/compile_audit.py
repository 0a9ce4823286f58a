#!/usr/bin/env python
"""Per-program compile-cost audit for the canonical imaging pipeline.

Measures where cold-start wall time goes before the first pixel: every XLA
compilation triggered by one canonical map (256^2 rays x 5000 steps x
128^3 cube, trace + LOS sample + GRFF transfer over --nfreq frequencies,
bench.py's Newkirk cube) is captured from JAX's compile logs with its
duration.

Usage:
    python scripts/compile_audit.py --cache fresh   # cold: empty the cache
    python scripts/compile_audit.py --cache warm    # reuse the cache

`fresh` empties <checkout>/.jax_cache, the cache used when
JAX_COMPILATION_CACHE_DIR is unset, and refuses to run while that variable
names another directory (it will not empty a cache it does not own).

Prints one JSON line: {"mode", "device", "warmup_s", "compiles":
[{name, s}...], "total_compile_s", "n_compiles"} and a table on stderr.
"""

import argparse
import json
import logging
import os
import re
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class CompileLogCapture(logging.Handler):
    """Collect 'Finished XLA compilation of <name> in <t> sec' records."""

    PAT = re.compile(r"Finished (?:XLA compilation|jaxpr to MLIR module "
                     r"conversion|tracing) of ([^ ]+).* in ([0-9.e+-]+) sec")

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.entries = []

    def emit(self, record):
        m = self.PAT.search(record.getMessage())
        if m:
            kind = ("xla" if "XLA compilation" in record.getMessage()
                    else "mlir" if "MLIR" in record.getMessage()
                    else "trace")
            self.entries.append((kind, m.group(1), float(m.group(2))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cache", choices=["fresh", "warm"], default="fresh")
    p.add_argument("--n-pix", type=int, default=256)
    p.add_argument("--n-steps", type=int, default=5000)
    p.add_argument("--grid-n", type=int, default=128)
    p.add_argument("--nfreq", type=int, default=3)
    args = p.parse_args()

    sys.path.insert(0, str(ROOT))
    if args.cache == "fresh":
        own = str(ROOT / ".jax_cache")
        given = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        if given and os.path.abspath(given) != own:
            p.error(f"--cache fresh empties {own}; unset "
                    f"JAX_COMPILATION_CACHE_DIR (now {given!r}) first")
        shutil.rmtree(own, ignore_errors=True)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench import make_cube
    from raytracinggrff_jax.pipeline import (RayEmissionConfig,
                                             run_ray_tracing_emission)
    from raytracinggrff_jax.utils.device import device_record
    jax.config.update("jax_explain_cache_misses", True)

    cap = CompileLogCapture()
    # handler on the "jax" parent ONLY: attaching to child loggers too
    # double-counts every record (children propagate to the parent)
    for name in ("jax._src.interpreters.pxla", "jax._src.compiler",
                 "jax._src.dispatch"):
        logging.getLogger(name).setLevel(logging.DEBUG)
    root = logging.getLogger("jax")
    root.setLevel(logging.DEBUG)
    root.addHandler(cap)

    grid, omega_pe, ne = make_cube(args.grid_n, 75e6)
    cubes = {"omega_pe": jnp.asarray(omega_pe), "ne": jnp.asarray(ne),
             "te": jnp.asarray(np.full_like(ne, 1.4e6)),
             "b": jnp.asarray(np.ones_like(ne))}
    cfg = RayEmissionConfig(n_pix=args.n_pix, freq_hz=75e6,
                            grid_n=args.grid_n, grid_extent=3.0,
                            z_observer=3.0, n_steps=args.n_steps,
                            nfreq=args.nfreq, freq_log_step=0.05,
                            s_input_on=True)
    t0 = time.perf_counter()
    run_ray_tracing_emission(config=cfg, cubes=cubes, verbose=False)
    warmup_s = time.perf_counter() - t0

    xla = [(n, s) for k, n, s in cap.entries if k == "xla"]
    xla.sort(key=lambda e: -e[1])
    total = sum(s for _, s in xla)
    print(f"-- {args.cache} cache, warmup {warmup_s:.1f}s, "
          f"{len(xla)} XLA compiles totalling {total:.1f}s --",
          file=sys.stderr)
    for n, s in xla:
        print(f"  {s:8.2f}s  {n}", file=sys.stderr)
    print(json.dumps({
        "mode": args.cache,
        "device": device_record(),
        "warmup_s": warmup_s,
        "n_compiles": len(xla),
        "total_compile_s": total,
        "compiles": [{"name": n, "s": s} for n, s in xla],
    }))


if __name__ == "__main__":
    main()
