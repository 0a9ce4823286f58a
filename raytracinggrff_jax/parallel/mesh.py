"""Device-mesh sharding for the imaging pipeline.

Parallelism model (SURVEY.md §2.4): every (pixel, frequency) is independent —
the reference exploits this with CUDA thread-per-ray kernels and a
ProcessPoolExecutor over pickled ray chunks
(script/resample_with_ray_tracing.py:42-61, 333-352). Here the ray axis is
sharded over a jax.sharding.Mesh; the jitted trace/sample/transfer graphs are
partitioned by XLA with zero collectives in the hot loop (the gather tables
are replicated, results are gathered once at the end). The devices are
assumed to be joined all to all, so the mesh follows the algorithm alone.

Mesh axes:
  'rays'  — data-parallel over pixels/rays (trace, sample, transfer)
  'freq'  — frequency channels. run_ray_tracing_emission shards rays
            only, so devices along 'freq' repeat the same work.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_ray_shards=None, n_freq_shards=1, devices=None) -> Mesh:
    """Build a ('rays', 'freq') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_ray_shards is None:
        n_ray_shards = n_dev // n_freq_shards
    if n_ray_shards * n_freq_shards != n_dev:
        raise ValueError(
            f"mesh {n_ray_shards}x{n_freq_shards} != {n_dev} devices")
    dev_array = np.asarray(devices).reshape(n_ray_shards, n_freq_shards)
    return Mesh(dev_array, axis_names=("rays", "freq"))


def shard_rays(arr, mesh: Mesh):
    """Shard the leading (ray) axis of an array over the 'rays' mesh axis."""
    spec = P("rays", *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def shard_freqs(arr, mesh: Mesh, axis=0):
    spec_list = [None] * arr.ndim
    spec_list[axis] = "freq"
    return jax.device_put(arr, NamedSharding(mesh, P(*spec_list)))


def replicate(arr, mesh: Mesh):
    return jax.device_put(arr, NamedSharding(mesh, P()))
