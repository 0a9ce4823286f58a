#!/usr/bin/env python
"""Smoke test of the imaging pipeline on the GPU, from the user's entry points.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --devices 4  # phases 1 and 6 on four GPUs

One process, the only one on the card(s). Phases, in order; the first
failure ends the run with a non-zero exit:

1. device     — refuse anything but a GPU; print versions, device, XLA_FLAGS,
                the compile cache, and the card's name and power limit.
2. main path  — the canonical production map (256^2 rays x 5000 RK4 steps x
                128^3 cube, 75 MHz, dt 6e-3, stride 10, cross-sections and
                --s-input-on, 3 frequencies) through the rgrff-ray-emission
                CLI on a synthetic MAS corona, cold then warm.
3. parity     — 1,024 rays (strided, limb rows included) traced, sampled and
                transferred on the GPU and on the host CPU with the same
                jitted code; the GPU subset against the phase-2 map; the GPU
                LOS columns through the float64 transfer oracle (<= 1 %).
4. LOS chain  — rgrff-resample-los then rgrff-synthetic-ff with the README's
                arguments, and a strided block checked against the CPU.
5. GPU tests  — pytest -m gpu, in this process.
6. mesh       — (--devices 4 only) phase 2's configuration over
                make_mesh(4, 1) and make_mesh(2, 2) against one card.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = "raytracinggrff_jax"
RUN_DIR = ROOT / ".smoke_run"

# The canonical production configuration (BASELINE.md; reference
# script/resample_with_ray_tracing.py:154-158 with 256^2 pixels).
CANONICAL = dict(n_pix=256, x_fov=1.44, freq_hz=75e6, grid_n=128,
                 grid_extent=3.0, z_observer=3.0, dt=6e-3, n_steps=5000,
                 record_stride=10, s_input_on=True, nfreq=3,
                 freq_log_step=0.05)

# Limits of the record comparison between two backends (phase 3). Both run
# the same float32 program; they differ by rounding until a comparison
# (leaving the cube freezes a ray) falls one RK4 step apart, and one step
# moves a ray at most C_R * dt (2.6e-3 R_sun here).
R_MEDIAN_LIMIT = 1e-4          # R_sun: rounding-level drift
R_MAX_STEPS = 2.0              # max |dr| in RK4 step lengths
S_MEDIAN_LIMIT = 1e-3          # relative, cumulative cross-section ratio
ORACLE_LIMIT = 1e-2            # T_b vs the float64 oracle (BASELINE.md)


def final_line(rec):
    """The contract's last line: exactly these keys."""
    return json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"],
        "count": rec["count"]}})


def canonical_argv(model, out, c=CANONICAL):
    """rgrff-ray-emission arguments for configuration `c`."""
    argv = ["-m", str(model), "-o", str(out), "-n", str(c["n_pix"]),
            "-f", str(c["x_fov"]), "--freq", str(c["freq_hz"]),
            "--grid-n", str(c["grid_n"]),
            "--grid-extent", str(c["grid_extent"]),
            "--z-observer", str(c["z_observer"]), "--dt", str(c["dt"]),
            "--n-steps", str(c["n_steps"]),
            "--record-stride", str(c["record_stride"]),
            "--nfreq", str(c["nfreq"]),
            "--freq-log-step", str(c["freq_log_step"]), "--no-plots"]
    return argv + (["--s-input-on"] if c["s_input_on"] else [])


def subset_indices(n_pix, x_fov, n_side=32):
    """Flat pixel indices of an n_side x n_side strided sample of the image
    whose rows include the two limb rows (|y| nearest 1 R_sun)."""
    ys = np.linspace(-x_fov, x_fov, n_pix)
    rows = np.round(np.linspace(0, n_pix - 1, n_side)).astype(int)
    for limb in (int(np.argmin(np.abs(ys + 1.0))),
                 int(np.argmin(np.abs(ys - 1.0)))):
        rows[np.argmin(np.abs(rows - limb))] = limb
    cols = np.round(np.linspace(0, n_pix - 1, n_side)).astype(int)
    if len(set(rows.tolist())) != n_side or len(set(cols.tolist())) != n_side:
        raise ValueError(f"n_pix={n_pix} too small for a {n_side}^2 subset")
    return (rows[:, None] * n_pix + cols[None, :]).reshape(-1)


def subset_map(cubes, grid, cfg, start, kdir, device):
    """Trace -> sample -> transfer for the given rays on `device`, with the
    pipeline's own jitted functions. Returns host arrays."""
    import jax
    import jax.numpy as jnp
    from raytracinggrff_jax.constants import R_SUN_CM
    from raytracinggrff_jax.grff.transfer import (get_mw_slice,
                                                  log_spaced_freqs,
                                                  tb_from_sfu)
    from raytracinggrff_jax.sampler import (pack_model_table,
                                            sample_model_with_rays)
    from raytracinggrff_jax.tracer import pack_trace_table, trace_rays
    area = ((2 * cfg.x_fov) / cfg.n_pix * R_SUN_CM) ** 2
    freqs = log_spaced_freqs(cfg.freq_hz, cfg.nfreq, cfg.freq_log_step)
    with jax.default_device(device):
        c = {k: jax.device_put(v, device) for k, v in cubes.items()}
        table = pack_trace_table(c["omega_pe"], grid)
        mtable = pack_model_table(c["ne"], c["te"], c["b"])
        start = jax.device_put(start, device)
        trace = trace_rays(table, grid, cfg.freq_hz, start,
                           jax.device_put(kdir, device), cfg.dt,
                           cfg.n_steps, cfg.record_stride,
                           trace_crosssections=True,
                           perturb_ratio=cfg.perturb_ratio)
        los = sample_model_with_rays(mtable, grid, trace.r_record,
                                     trace.s_record, start)
        s_area = los.s * jnp.float32(area) if cfg.s_input_on else None
        res = get_mw_slice(los.ds, los.te, los.ne, los.b, los.valid_mask,
                           cfg.freq_hz, cfg.nfreq, cfg.freq_log_step, area,
                           s_area_cm2=s_area, mechanism=cfg.mechanism)
        tb = tb_from_sfu(res.flux_o + res.flux_x,
                         jnp.asarray(freqs, jnp.float32), area)
        out = {"r_record": trace.r_record, "s_record": trace.s_record,
               "tb": tb, "ds": los.ds, "te": los.te, "ne": los.ne,
               "b": los.b, "valid": los.valid_mask, "s_area": s_area}
        host = {k: (None if v is None else np.asarray(v))
                for k, v in out.items()}
    host["freqs"] = freqs
    host["area"] = area
    return host


def record_checks(got, want, step_len):
    """r_record and s_record of two backends, as compare_tb-style stats
    (`checks` rows of (name, value, limit, ok), and `ok`)."""
    dr = np.linalg.norm(got["r_record"].astype(np.float64)
                        - want["r_record"], axis=-1)
    s_g = got["s_record"].astype(np.float64)
    s_w = want["s_record"].astype(np.float64)
    alive = (s_w > 0) | (s_g > 0)
    s_rel = np.abs(s_g - s_w) / np.maximum(np.abs(s_w), 1e-30)
    s_med = float(np.median(s_rel[alive])) if alive.any() else 0.0
    rows = [("r_record median |dr| [R_sun]", float(np.median(dr)),
             R_MEDIAN_LIMIT),
            ("r_record max |dr| [RK4 steps]", float(dr.max()) / step_len,
             R_MAX_STEPS),
            ("s_record median rel (live records)", s_med, S_MEDIAN_LIMIT)]
    if alive.any():
        print("  s_record rel quantiles (live): " + " ".join(
            f"q{q}={np.quantile(s_rel[alive], q / 100):.3g}"
            for q in (50, 90, 99, 100)))
    checks = [(n, v, lim, v <= lim) for n, v, lim in rows]
    return {"checks": checks, "ok": all(ok for *_, ok in checks)}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(n_devices):
    import jax
    import jaxlib
    from raytracinggrff_jax.utils.device import (nvidia_smi_name_power,
                                                 require_gpu)
    rec = require_gpu("chip_smoke.py")
    if rec["count"] < n_devices:
        raise SystemExit(f"chip_smoke.py: --devices {n_devices} but JAX "
                         f"found {rec['count']} GPU(s)")
    print(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"  device: {rec['platform']} / {rec['kind']} x {rec['count']}")
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {jax.config.jax_compilation_cache_dir}")
    smi = nvidia_smi_name_power()
    if not smi:
        raise RuntimeError("nvidia-smi did not report the card")
    print("  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi)
    return rec


def phase_main_path(run_dir):
    import jax
    from raytracinggrff_jax import synthetic_mas_model
    from raytracinggrff_jax.cli import ray_tracing_emission
    from raytracinggrff_jax.constants import R_SUN_M
    c = CANONICAL
    corona = synthetic_mas_model(run_dir / "corona")
    out = run_dir / "ray_tracing_emission.npz"
    walls = {}
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        ray_tracing_emission.main(canonical_argv(corona, out))
        walls[label] = time.perf_counter() - t0
    ray_steps = c["n_pix"] ** 2 * c["n_steps"]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"  wall cold {walls['cold']:.3f} s, warm {walls['warm']:.3f} s, "
          f"compile {walls['cold'] - walls['warm']:.3f} s")
    print(f"  warm end-to-end rate {ray_steps / walls['warm']:.6g} "
          f"ray-steps/s ({c['n_pix']}^2 x {c['n_steps']} steps, incl. "
          f"resample, sample, {c['nfreq']}-frequency transfer and npz)")
    print(f"  peak_bytes_in_use {peak}")
    data = np.load(out)
    for key in ("emission_cube", "emission_polVI_cube", "frequencies_Hz",
                "x_coords", "y_coords"):
        if key not in data:
            raise AssertionError(f"npz lacks {key!r}")
    tb = data["emission_cube"]
    want = (c["n_pix"], c["n_pix"], c["nfreq"])
    if tb.shape != want or not np.isfinite(tb).all():
        raise AssertionError(f"T_b shape {tb.shape} (want {want}) or "
                             f"non-finite values")
    x = data["x_coords"] / R_SUN_M
    y = data["y_coords"] / R_SUN_M
    disk = np.hypot(x[None, :], y[:, None]) < 1.0
    tb_disk = tb[disk]
    print(f"  on-disk T_b [K]: min {tb_disk.min():.4g} median "
          f"{np.median(tb_disk):.4g} max {tb_disk.max():.4g} "
          f"(expected 1e4..3e6)")
    if not (1e4 <= np.median(tb_disk) <= 3e6 and tb_disk.max() <= 3e6):
        raise AssertionError("on-disk T_b outside 1e4..3e6 K")
    return corona, tb


def phase_parity(corona, tb_map):
    import jax
    from raytracinggrff_jax.constants import C_R
    from raytracinggrff_jax.grff.reference import grff_transfer_reference
    from raytracinggrff_jax.grids import UniformGrid
    from raytracinggrff_jax.mas.model import MASModel
    from raytracinggrff_jax.pipeline import (RayEmissionConfig,
                                             image_ray_starts, prepare_cubes)
    from raytracinggrff_jax.grff.transfer import tb_from_sfu
    from raytracinggrff_jax.utils.parity import compare_tb, format_checks
    cpu = jax.devices("cpu")[0]          # absent CPU backend: RuntimeError
    cfg = RayEmissionConfig(**CANONICAL)
    grid = UniformGrid.cube(cfg.grid_extent, cfg.grid_n)
    cubes = {k: np.asarray(v) for k, v in prepare_cubes(
        MASModel(corona), grid, cfg.phi0_offset, verbose=False).items()}
    _, _, start, kdir = image_ray_starts(cfg.n_pix, cfg.x_fov,
                                         cfg.z_observer)
    idx = subset_indices(cfg.n_pix, cfg.x_fov)
    print(f"  subset: {idx.size} rays")
    gpu = subset_map(cubes, grid, cfg, start[idx], kdir[idx],
                     jax.devices()[0])
    ref = subset_map(cubes, grid, cfg, start[idx], kdir[idx], cpu)
    orc = grff_transfer_reference(
        gpu["ds"], gpu["te"], gpu["ne"], gpu["b"], gpu["valid"],
        gpu["freqs"], gpu["area"], s_area_cm2=gpu["s_area"],
        mechanism=cfg.mechanism)
    tb_orc = tb_from_sfu(orc["flux_o"] + orc["flux_x"],
                         np.asarray(gpu["freqs"])[None, :], gpu["area"])
    ok = True
    for label, st in (
            ("GPU vs CPU", record_checks(gpu, ref, C_R * cfg.dt)),
            ("T_b GPU vs CPU", compare_tb(gpu["tb"], ref["tb"])),
            ("T_b GPU subset vs phase-2 map",
             compare_tb(gpu["tb"], tb_map.reshape(-1, cfg.nfreq)[idx])),
            ("T_b GPU vs float64 oracle",
             compare_tb(gpu["tb"], tb_orc, tight=ORACLE_LIMIT))):
        print(format_checks(st, label))
        ok &= st["ok"]
    if not ok:
        raise AssertionError("parity outside its limits (see above)")


def phase_los_chain(corona, run_dir):
    import jax
    from raytracinggrff_jax.cli import resample_los, synthetic_ff
    from raytracinggrff_jax.pipeline import synthetic_ff as synth
    from raytracinggrff_jax.utils.parity import compare_tb, format_checks
    cpu = jax.devices("cpu")[0]
    los_path = run_dir / "LOS_data_75MHz.npz"
    em_path = run_dir / "emission_map"
    t0 = time.perf_counter()
    resample_los.main(["-m", str(corona), "-o", str(los_path),
                       "--dz0", "7e-4", "-f", "2.2", "--no-plots"])
    synthetic_ff.main(["-i", str(los_path), "-o", str(em_path),
                       "--no-plots"])
    print(f"  LOS chain wall {time.perf_counter() - t0:.3f} s")
    em = np.load(str(em_path) + ".npz")
    tb = em["emission_cube"]
    if not np.isfinite(tb).all():
        raise AssertionError("straight-LOS T_b not finite")
    # strided square block (rows and columns every 4th pixel), recomputed
    # with synthetic_ff on the CPU; x/y spacing keeps the pixel area
    los = dict(np.load(los_path))
    block = {k: los[k][::4, ::4] for k in ("Ne_LOS", "Te_LOS", "B_LOS",
                                            "ds_LOS")}
    block.update(x_coords=los["x_coords"], y_coords=los["y_coords"])
    freqs = em["frequencies_Hz"]
    step = float(np.log10(freqs[1] / freqs[0])) if freqs.size > 1 else 0.0
    with jax.default_device(cpu):
        ref = synth(block, float(freqs[0]), freqs.size, step, verbose=False)
    st = compare_tb(tb[::4, ::4], ref["emission_cube"])
    print(format_checks(st, "straight-LOS T_b GPU vs CPU"))
    if not st["ok"]:
        raise AssertionError("straight-LOS T_b differs from the CPU")


def phase_gpu_tests():
    import pytest

    class Tally:
        def __init__(self):
            self.passed, self.failed = [], []

        def pytest_runtest_logreport(self, report):
            if report.failed:
                self.failed.append(report.nodeid)
            elif report.passed and report.when == "call":
                self.passed.append(report.nodeid)

    os.environ["RTGRFF_GPU_TESTS"] = "1"
    tally = Tally()
    rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                      str(ROOT / "tests")], plugins=[tally])
    print(f"  gpu tests: rc {rc}, passed {len(tally.passed)}, failed "
          f"{len(tally.failed)}")
    if rc != 0 or tally.failed or len(tally.passed) < 3:
        raise AssertionError(f"gpu-marked tests did not pass: rc {rc}, "
                             f"failed {tally.failed}")


def mesh_phase(cubes, config, devices, shapes=((4, 1), (2, 2))):
    """Run `config` on devices[0] alone and over each (rays, freq) mesh of
    `devices`, each twice (cold, then warm); compare each map with the
    single-device one and check that every ray-axis array is split over
    the mesh. Returns a list of (shape, compare_tb stats, warm seconds)."""
    import jax
    from raytracinggrff_jax.parallel.mesh import make_mesh
    from raytracinggrff_jax.pipeline import run_ray_tracing_emission
    from raytracinggrff_jax.utils.parity import compare_tb, format_checks

    def run(label, mesh=None):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = run_ray_tracing_emission(cubes=cubes, config=config,
                                           verbose=False, mesh=mesh)
            walls.append(time.perf_counter() - t0)
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in devices]
        print(f"  {label}: wall cold {walls[0]:.3f} s, warm {walls[1]:.3f} "
              f"s; process peak bytes per device {peaks}")
        return res, walls[1]

    with jax.default_device(devices[0]):
        one, _ = run("1 device")
    n_rays = config.n_pix ** 2
    out = []
    for shape in shapes:
        res, warm = run(f"mesh {shape}", make_mesh(*shape, devices=devices))
        for name, arr in res["_sampled"]._asdict().items():
            if arr is None:
                continue
            per = arr.sharding.shard_shape(arr.shape)[1]
            if (len(arr.sharding.device_set) != len(devices)
                    or per != n_rays // shape[0]):
                raise AssertionError(
                    f"mesh {shape}: {name} holds {per} of {n_rays} rays "
                    f"per shard on {len(arr.sharding.device_set)} devices")
        st = compare_tb(res["emission_cube"], one["emission_cube"])
        print(format_checks(st, f"T_b mesh {shape} vs 1 device"))
        out.append((shape, st, warm))
    return out


def phase_mesh(run_dir):
    import jax
    from raytracinggrff_jax import synthetic_mas_model
    from raytracinggrff_jax.grids import UniformGrid
    from raytracinggrff_jax.mas.model import MASModel
    from raytracinggrff_jax.pipeline import RayEmissionConfig, prepare_cubes
    cfg = RayEmissionConfig(**CANONICAL)
    corona = synthetic_mas_model(run_dir / "corona")
    cubes = prepare_cubes(MASModel(corona),
                          UniformGrid.cube(cfg.grid_extent, cfg.grid_n),
                          cfg.phi0_offset, verbose=False)
    results = mesh_phase(cubes, cfg, jax.devices()[:4])
    if not all(st["ok"] for _, st, _ in results):
        raise AssertionError("a mesh map differs from the one-card map")


# ---------------------------------------------------------------------------

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, choices=(1, 4), default=1,
                   help="4: run only the four-card mesh phase")
    args = p.parse_args(argv)

    if not (ROOT / PACKAGE / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke.py: {PACKAGE}/ not found beside "
                         f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT))
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        # the parity phases compare with the host CPU backend
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    print("== phase 1: device ==", flush=True)
    rec = phase_device(args.devices)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    RUN_DIR.mkdir(parents=True)
    state = {}

    def main_path():
        state["corona"], state["tb"] = phase_main_path(RUN_DIR)

    if args.devices == 4:
        phases = [("mesh over 4 devices", lambda: phase_mesh(RUN_DIR))]
    else:
        phases = [
            ("main path at full width", main_path),
            ("parity against the plain reference",
             lambda: phase_parity(state["corona"], state["tb"])),
            ("straight-LOS chain",
             lambda: phase_los_chain(state["corona"], RUN_DIR)),
            ("gpu-marked tests", phase_gpu_tests),
        ]
    for i, (name, fn) in enumerate(phases, start=2):
        print(f"== phase {i if args.devices == 1 else 6}: {name} ==",
              flush=True)
        t0 = time.perf_counter()
        fn()
        print(f"-- {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(final_line(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
