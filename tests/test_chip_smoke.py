"""chip_smoke.py and bench.py off the card: they refuse to run without a
GPU, the smoke test's last line and subset are what the contract says, and
its mesh phase runs on four virtual CPU devices at toy size."""

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_on_cpu(script):
    out = _run([script], ROOT)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr and "'cpu'" in out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert "raytracinggrff_jax/ not found" in out.stderr
    assert '"ok"' not in out.stdout


def test_final_line_contract():
    cs = _load("chip_smoke")
    line = cs.final_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                          "count": 4, "extra": 1})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_subset_has_limb_rows():
    cs = _load("chip_smoke")
    idx = cs.subset_indices(256, 1.44)
    assert idx.size == 1024 and np.unique(idx).size == 1024
    ys = np.linspace(-1.44, 1.44, 256)
    rows = np.unique(idx // 256)
    for limb in (-1.0, 1.0):
        assert np.argmin(np.abs(ys - limb)) in rows


def test_mesh_phase_on_four_cpu_devices():
    import jax
    import jax.numpy as jnp
    from raytracinggrff_jax.grids import UniformGrid
    from raytracinggrff_jax.pipeline import RayEmissionConfig
    cs = _load("chip_smoke")
    grid = UniformGrid.cube(2.5, 32)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.9)),
                  0.0).astype(np.float32)
    cubes = {"omega_pe": jnp.asarray(8.93e3 * np.sqrt(ne) * 2 * np.pi),
             "ne": jnp.asarray(ne),
             "te": jnp.asarray(np.full_like(ne, 1.4e6)),
             "b": jnp.asarray(np.ones_like(ne))}
    cfg = RayEmissionConfig(n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=32,
                            grid_extent=2.5, z_observer=2.5, dt=1e-2,
                            n_steps=210, record_stride=10, nfreq=2,
                            freq_log_step=0.2, s_input_on=True)
    results = cs.mesh_phase(cubes, cfg, jax.devices()[:4])
    assert [shape for shape, _, _ in results] == [(4, 1), (2, 2)]
    for _, stats, _ in results:
        assert stats["ok"] and stats["n_lit"] > 20


def test_busy_union():
    bench = _load("bench")
    # overlapping, nested, disjoint and out-of-window intervals
    iv = [(0, 10), (5, 15), (6, 7), (20, 30), (40, 50), (-5, 2)]
    assert bench.busy_union_ns(iv, 0, 45) == 15 + 10 + 5
    assert bench.busy_union_ns([], 0, 10) == 0
