#!/usr/bin/env python
"""Benchmark harness: ray-steps/sec/chip on the canonical workload.

Primary metric (BASELINE.md): ray-steps/sec/chip at 256^2 rays x 5000 RK4
steps through a 128^3 cube at 75 MHz with cross-section tracking on (the
production configuration of script/resample_with_ray_tracing.py:154-158).
`--pipeline --nfreq N` instead times the full map (trace, LOS sample and
GRFF transfer over N frequencies) and reports seconds per frequency.

Needs a GPU and refuses to run without one: a number from another platform
is not a number for the card. Every timed call ends in
jax.block_until_ready (or a host array) before the clock stops.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "times_s",
"warmup_s", "workload", "device"}; the headline is the MEDIAN of the
repeats. "device" carries JAX's platform/kind/count and the card's name and
power limit from nvidia-smi. `--profile DIR` adds one traced repeat and a
"profile" entry: device kernels per RK4 step and the device idle share of
the traced window (reduced by `device_activity`). Per-repeat timings go to
stderr.

Workload construction mirrors the reference bench (bench_raytrace.py:16-41):
synthetic Newkirk-density cube, image-plane rays.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

WINDOW = "rtgrff_bench_window"


def make_cube(grid_n, freq_hz):
    from raytracinggrff_jax.grids import UniformGrid
    grid = UniformGrid.cube(3.0, grid_n)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    # Newkirk-like density -> omega_pe; overdense below r=1 so low-frequency
    # rays refract/reflect like the production scene.
    ne = 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.5))
    omega_pe = 8.93e3 * np.sqrt(ne) * 2 * np.pi
    return grid, omega_pe.astype(np.float32), ne.astype(np.float32)


def make_rays(n_pix, x_fov=1.44, z_obs=3.0):
    from raytracinggrff_jax.pipeline import image_ray_starts
    _, _, start, kdir = image_ray_starts(n_pix, x_fov, z_obs)
    return start, kdir


def busy_union_ns(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_lo, cur_hi = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def device_activity(xplane_path, window_name=WINDOW):
    """Reduce a jax.profiler trace to device kernel count and busy share.

    The window is the host span named `window_name` (a TraceAnnotation
    around the timed call). Kernels are the events on the GPU planes'
    stream lines ("Stream #..."); busy time is the union of their
    intervals inside the window, so overlapping streams count once.
    `top_kernels_ns` sums device time by kernel name.
    """
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    window = None
    kernels = []
    lines_seen = {}
    for plane in pd.planes:
        is_gpu = plane.name.startswith("/device:GPU")
        for line in plane.lines:
            events = list(line.events)
            if is_gpu:
                lines_seen[f"{plane.name}|{line.name}"] = len(events)
            for ev in events:
                if ev.name == window_name and not is_gpu:
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
                elif is_gpu and line.name.startswith("Stream"):
                    kernels.append((ev.start_ns,
                                    ev.start_ns + ev.duration_ns, ev.name))
    if window is None:
        raise RuntimeError(f"no host span named {window_name!r} in trace")
    lo, hi = window
    inside = [(s, e, n) for s, e, n in kernels if e > lo and s < hi]
    busy = busy_union_ns([(s, e) for s, e, _ in inside], lo, hi)
    by_name = {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ns": hi - lo, "busy_ns": busy,
            "idle_share": 1.0 - busy / (hi - lo),
            "n_kernels": len(inside), "gpu_lines": lines_seen,
            "top_kernels_ns": top}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-pix", type=int, default=256)
    p.add_argument("--n-steps", type=int, default=5000)
    p.add_argument("--grid-n", type=int, default=128)
    p.add_argument("--record-stride", type=int, default=10)
    p.add_argument("--freq", type=float, default=75e6)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--no-crosssections", action="store_true")
    p.add_argument("--pipeline", action="store_true",
                   help="bench the FULL emission pipeline (trace + sample + "
                        "GRFF transfer) and report s/frequency")
    p.add_argument("--nfreq", type=int, default=3,
                   help="--pipeline: transfer frequencies per trace")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace one extra repeat with jax.profiler into DIR "
                        "and report kernels per step and device idle share")
    args = p.parse_args(argv)
    workload = {"n_pix": args.n_pix, "n_steps": args.n_steps,
                "grid_n": args.grid_n, "record_stride": args.record_stride,
                "freq_hz": args.freq, "tracer": "xla",
                "crosssections": not args.no_crosssections}

    import jax
    import jax.numpy as jnp
    from raytracinggrff_jax.utils.device import (device_record,
                                                 nvidia_smi_name_power,
                                                 require_gpu)
    require_gpu("bench.py")
    device = dict(device_record(), nvidia_smi=nvidia_smi_name_power())

    grid, omega_pe, ne = make_cube(args.grid_n, args.freq)
    te = np.full_like(ne, 1.4e6)
    b = np.ones_like(ne)
    start, kdir = make_rays(args.n_pix)

    def note(msg):
        print(msg, file=sys.stderr, flush=True)

    if args.pipeline:
        if args.no_crosssections:
            p.error("--pipeline always traces cross-sections")
        # One trace at --freq plus the GRFF transfer over --nfreq
        # frequencies (TbSpectra sweeps re-trace per frequency, so
        # s/frequency here is trace + transfer/nfreq — the reference's
        # per-frequency unit, script/pub/TbSpectra_gen.py:115-117).
        from raytracinggrff_jax.pipeline import (RayEmissionConfig,
                                                 run_ray_tracing_emission)
        cubes = {"omega_pe": jnp.asarray(omega_pe), "ne": jnp.asarray(ne),
                 "te": jnp.asarray(te), "b": jnp.asarray(b)}
        cfg = RayEmissionConfig(
            n_pix=args.n_pix, freq_hz=args.freq, grid_n=args.grid_n,
            grid_extent=3.0, z_observer=3.0, dt=6e-3, n_steps=args.n_steps,
            record_stride=args.record_stride, nfreq=args.nfreq,
            freq0=args.freq, freq_log_step=0.05, s_input_on=True)

        def run():
            # the result is a host array: the device work has finished
            res = run_ray_tracing_emission(config=cfg, cubes=cubes,
                                           verbose=False)
            assert np.isfinite(res["emission_cube"]).all()
        metric, unit, per = ("pipeline-s-per-frequency", "s/freq/chip",
                             args.nfreq)
        workload["nfreq"] = args.nfreq
    else:
        from raytracinggrff_jax.tracer import pack_trace_table, trace_rays
        table = pack_trace_table(jnp.asarray(omega_pe), grid)
        start_j = jnp.asarray(start)
        kdir_j = jnp.asarray(kdir)

        def run():
            res = trace_rays(table, grid, args.freq, start_j, kdir_j, 6e-3,
                             args.n_steps, args.record_stride,
                             trace_crosssections=not args.no_crosssections,
                             perturb_ratio=2.0)
            jax.block_until_ready(res)
        metric, unit, per = "ray-steps/sec/chip", "ray-steps/s", None

    t0 = time.perf_counter()
    run()  # compile + warmup
    warmup_s = time.perf_counter() - t0
    note(f"warmup (incl. compile): {warmup_s:.1f}s")
    times = []
    for i in range(args.repeat):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
        note(f"repeat {i}: {times[-1]:.3f}s")
    median = float(np.median(times))
    if per is None:
        value = args.n_pix * args.n_pix * args.n_steps / median
    else:
        value = median / per

    out = {"metric": metric, "value": value, "unit": unit,
           "times_s": times, "warmup_s": warmup_s, "workload": workload,
           "device": device}
    if args.profile:
        with jax.profiler.trace(args.profile):
            with jax.profiler.TraceAnnotation(WINDOW):
                run()
        paths = sorted(glob.glob(os.path.join(
            args.profile, "plugins", "profile", "*", "*.xplane.pb")))
        act = device_activity(paths[-1])
        act["kernels_per_step"] = act["n_kernels"] / args.n_steps
        out["profile"] = act
        note(f"profile: {act['n_kernels']} kernels "
             f"({act['kernels_per_step']:.2f}/RK4 step), idle share "
             f"{act['idle_share']:.4f} of {act['window_ns'] / 1e9:.3f}s")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
