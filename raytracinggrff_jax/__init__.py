"""raytracinggrff_jax — solar radio imaging framework in JAX.

Capabilities of peijin94/raytracingGRFF rebuilt JAX/XLA-first: refractive ray
tracing through MAS coronal models, LOS sampling, and native GRFF
gyroresonance/free-free radiative transfer, fused into jitted device graphs
and sharded over device meshes.

Public API mirrors the reference package exports
(raytracingGRFF/__init__.py:1-15) plus the framework-native entry points.
"""

import os as _os
import sys as _sys

def _default_compile_cache():
    """Point JAX's persistent compilation cache at one fixed directory.

    A 30-frequency sweep compiles one trace/transfer variant per
    (cube shape, stride) pair; without the on-disk cache every run re-pays
    those compiles. If JAX_COMPILATION_CACHE_DIR is set, JAX reads it
    itself and nothing here changes it. Otherwise the cache lives at
    <checkout>/.jax_cache: a fixed path, because the path is part of the
    cache key. Runs before the jax-importing submodule imports below; if
    jax was imported first, the config route is used.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")
    try:
        _os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only checkout: run without the cache
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    _os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                           "1.0")
    if "jax" in _sys.modules:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          float(_os.environ[
                              "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]))


_default_compile_cache()

from .constants import C_R, R_SUN_CM, R_SUN_M
from .coords import cart_to_sph, sph_to_cart, image_xyz_to_mas_sph
from .grids import UniformGrid, variable_z_grid, linear_z_grid
from .tracer import (TraceResult, trace_rays, trace_rays_from_cube,
                     pack_trace_table)
from .sampler import (LosSamples, sample_model_with_rays,
                      sample_model_with_rays_arrays, pack_model_table)
from .grff import get_mw, get_mw_slice, grff_transfer, tb_from_sfu
from .mas import MASModel, MASVariable, synthetic_mas_model
from .mas.model import load_mas_var, resample_var_to_cube
from .pipeline import (RayEmissionConfig, run_ray_tracing_emission,
                       resample_mas_los, synthetic_ff, prepare_cubes)
from .utils import patch_nan_emission_map

# Reference-compatible aliases (raytracingGRFF/__init__.py exports and the
# legacy names kept at gpu_raytrace.py:762-780)
ray_trace = trace_rays_from_cube
trace_ray = trace_rays_from_cube
load_mas_var_filtered = load_mas_var
resample_to_xyz_cube = resample_var_to_cube
trace_los_cpu = sample_model_with_rays_arrays
trace_los_gpu = sample_model_with_rays_arrays
trace_los_gpu_cupy = sample_model_with_rays_arrays
trace_los_dispatch = sample_model_with_rays_arrays
ray_trace_gpu = trace_rays_from_cube

__all__ = [
    "C_R", "R_SUN_CM", "R_SUN_M",
    "cart_to_sph", "sph_to_cart", "image_xyz_to_mas_sph",
    "UniformGrid", "variable_z_grid", "linear_z_grid",
    "TraceResult", "trace_rays", "trace_rays_from_cube", "pack_trace_table",
    "LosSamples", "sample_model_with_rays", "sample_model_with_rays_arrays",
    "pack_model_table",
    "get_mw", "get_mw_slice", "grff_transfer", "tb_from_sfu",
    "MASModel", "MASVariable", "synthetic_mas_model", "load_mas_var",
    "resample_var_to_cube",
    "RayEmissionConfig", "run_ray_tracing_emission", "resample_mas_los",
    "synthetic_ff", "prepare_cubes",
    "patch_nan_emission_map",
    "ray_trace", "trace_ray", "load_mas_var_filtered", "resample_to_xyz_cube",
]

__version__ = "0.1.0"
