"""Device-mesh construction.

Replaces the reference's multi-GPU handle setup (per-GPU streams, rocblas
handles, and rcclCommInitRank communicators,
test_hipStateVec_multi_gpu.cpp:13-25, MULTI_GPU_GUIDE.md:15-27) with
jax.sharding.Mesh: XLA owns the collectives over NVLink; there are no
communicators to manage.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


SV_AXIS = "sv"      # amplitude (state-vector) sharding axis — the TP analog
BATCH_AXIS = "dp"   # batched-simulation axis — the DP analog
DCN_AXIS = "dcn"    # cross-slice axis — amplitude sharding spans (dcn, sv)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SV_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} exist")
        devices = devices[:n_devices]
    n = len(devices)
    if n & (n - 1):
        raise ValueError(f"number of devices must be a power of two, got {n} "
                         "(reference constraint: bit-sliced state, "
                         "MULTI_GPU_GUIDE.md:19)")
    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(dp: int, sv: int, devices: Optional[Sequence] = None) -> Mesh:
    """(batch, amplitude) mesh for batched sharded simulation."""
    if devices is None:
        devices = jax.devices()
    if dp * sv > len(devices):
        raise ValueError(f"mesh {dp}x{sv} needs {dp*sv} devices, "
                         f"have {len(devices)}")
    arr = np.array(devices[:dp * sv]).reshape(dp, sv)
    return Mesh(arr, (BATCH_AXIS, SV_AXIS))


def make_mesh_multislice(dcn: int, sv: int,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(slice, amplitude) mesh for multi-slice deployments: the amplitude
    axis spans BOTH the cross-host DCN axis and the intra-host NVLink axis
    (top log2(dcn) index bits select the slice; the reference's roadmap-only
    MPI cluster scaling, ROADMAP.md:28). On a single slice this is exercised
    with virtual devices; the sharding design is mesh-shape agnostic."""
    if devices is None:
        devices = jax.devices()
    if dcn * sv > len(devices):
        raise ValueError(f"mesh {dcn}x{sv} needs {dcn*sv} devices, "
                         f"have {len(devices)}")
    for size, name in ((dcn, "dcn"), (sv, "sv")):
        if size & (size - 1):
            raise ValueError(f"{name} size must be a power of two: {size}")
    arr = np.array(devices[:dcn * sv]).reshape(dcn, sv)
    return Mesh(arr, (DCN_AXIS, SV_AXIS))


def default_mesh() -> Mesh:
    return make_mesh()
