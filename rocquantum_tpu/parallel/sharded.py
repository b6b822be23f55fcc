"""Sharded state-vector simulation over a device mesh.

JAX replacement for the reference's multi-GPU distribution
(reference: rocquantum/src/hipStateVec/MULTI_GPU_GUIDE.md — bit-sliced state
where the top M = log2(P) index bits select the device :19-24;
rocsvSwapIndexBits localizing global qubits via count/pack kernels +
rcclAlltoallv :44-51, swap_kernels.hip:46-114; distributed reductions via
rcclAllReduce :64-78; rocsvAllocateDistributedState/
rocsvInitializeDistributedState decls hipStateVec.h:92-137).

Here the 2^n amplitude array is ONE ``jax.Array`` sharded over the mesh's
``sv`` axis — the leading (most-significant) index bits select the device,
exactly the reference's layout. Everything else follows from XLA's SPMD
partitioner:

* gates on LOCAL (low) qubits partition trivially — zero communication;
* gates on GLOBAL (high) qubits: the same einsum, with a sharding
  constraint pinning the output layout, makes XLA emit the collective
  (the all-to-all the reference hand-rolled with count/pack/Alltoallv);
* probability/expectation reductions partition into local reductions +
  psum (the rcclAllReduce analog);
* the gate-on-nonlocal-qubit "NOT_IMPLEMENTED + caller orchestrates swaps"
  limitation of the reference (GUIDE:58-59) does not exist — any gate works
  on any qubit.

``swap_index_bits_sharded`` is retained for API parity and for explicit
qubit-remap scheduling (it lowers to one all-to-all on the sharded axis).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import config
from ..ops import statevec as sv
from .mesh import DCN_AXIS, SV_AXIS


def _amp_axes(mesh: Mesh, axis_name: str = SV_AXIS):
    """Mesh axes the amplitude dimension spans: (dcn, sv) on multi-slice
    meshes, just sv otherwise."""
    if DCN_AXIS in mesh.axis_names and axis_name == SV_AXIS:
        return (DCN_AXIS, axis_name)
    return axis_name


def num_global_qubits(mesh: Mesh, axis_name: str = SV_AXIS) -> int:
    """M = log2(P): number of device-selecting (global) qubits
    (MULTI_GPU_GUIDE.md:21). Spans DCN x NVLink on multi-slice meshes."""
    axes = _amp_axes(mesh, axis_name)
    axes = (axes,) if isinstance(axes, str) else axes
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return (size - 1).bit_length()


def state_sharding(mesh: Mesh, axis_name: str = SV_AXIS,
                   batch: bool = False) -> NamedSharding:
    """Sharding for a flat (2^n,) state: leading index bits -> device
    (slice-selecting bits above chip-selecting bits on multi-slice
    meshes — cross-slice traffic rides DCN only when a gate touches the
    very top qubits)."""
    amp = _amp_axes(mesh, axis_name)
    if batch:
        from .mesh import BATCH_AXIS
        return NamedSharding(mesh, P(BATCH_AXIS, amp))
    return NamedSharding(mesh, P(amp))


def shard_state(state: jax.Array, mesh: Mesh,
                axis_name: str = SV_AXIS) -> jax.Array:
    """Place an existing state onto the mesh (rocsvAllocateDistributedState
    + scatter analog)."""
    return jax.device_put(state, state_sharding(mesh, axis_name))


def sharded_zero_state(num_qubits: int, sharding: NamedSharding,
                       dtype=None) -> jax.Array:
    """|0...0> made shard by shard under a flat ``sharding``: every device
    writes its own slice and only the first holds the 1. No op sees a
    global index: XLA's partitioner computes shard offsets of a global pad
    or scatter in int32, which overflows on states of 2^31 amplitudes or
    more (a 32-qubit state over four H100s read norms of 0 and 3 that
    way). Traceable inside jit."""
    dtype = dtype or config.complex_dtype()
    axes = sharding.spec[0]
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    shards = 1
    for a in names:
        shards *= sharding.mesh.shape[a]

    def init():
        first = (jax.lax.axis_index(names) == 0).astype(dtype)
        return sv.one_hot((1 << num_qubits) // shards, 0, dtype) * first

    return jax.shard_map(init, mesh=sharding.mesh, in_specs=(),
                         out_specs=sharding.spec)()


def sharded_init_state(num_qubits: int, mesh: Mesh,
                       axis_name: str = SV_AXIS) -> jax.Array:
    """|0...0> born sharded (rocsvInitializeDistributedState analog,
    hipStateVec.h:105): each device fills its slice, no host round-trip."""
    sharding = state_sharding(mesh, axis_name)
    return jax.jit(lambda: sharded_zero_state(num_qubits, sharding))()


def swap_index_bits_sharded(state: jax.Array, q1: int, q2: int,
                            mesh: Mesh, axis_name: str = SV_AXIS) -> jax.Array:
    """Exchange index bits q1 and q2 on a sharded state.

    The local<->global case is the reference's rcclAlltoallv path
    (GUIDE:44-51) — XLA lowers the constrained transpose to an
    all-to-all. local<->local is a pure local permutation
    (local_bit_swap_permutation_kernel analog); global<->global (the case
    the reference left NOT_IMPLEMENTED, GUIDE:50) also just works.
    """
    sharding = state_sharding(mesh, axis_name)

    @jax.jit
    def do(s):
        out = sv.swap_index_bits(s, q1, q2, use_transpose=True)
        return jax.lax.with_sharding_constraint(out, sharding)

    return do(state)


def count_collectives(hlo_text: str) -> dict:
    """Count collective ops in compiled-HLO text — the sharded scheduler's
    communication budget, made assertable.

    A scheduler regression that doubles communication changes these counts
    without failing any numeric test; dryrun_multichip and
    tests/test_sharded.py pin EXACT counts for canonical workloads
    (VERDICT r4 #7; the reference's swap cost model: MULTI_GPU_GUIDE.md:
    44-78). Counts instruction DEFINITIONS (``= <shape> <op>(``), so each
    collective is counted once regardless of how often its name is
    referenced."""
    counts = {}
    for op in ("all-to-all", "all-gather", "all-reduce",
               "collective-permute", "reduce-scatter"):
        # an instruction DEFINITION is the only place the bare op name is
        # followed by '(' (references carry a %name.N suffix); async pairs
        # (<op>-start / <op>-done) count once, via -start
        counts[op] = (hlo_text.count(f" {op}(")
                      + hlo_text.count(f" {op}-start("))
    return counts


def compile_sharded(fn, mesh: Mesh, axis_name: str = SV_AXIS,
                    donate: bool = True):
    """jit ``fn(state, params) -> state`` with the sharded-state layout
    pinned on input and output."""
    sharding = state_sharding(mesh, axis_name)

    def wrapped(state, params):
        out = fn(state, params)
        return jax.lax.with_sharding_constraint(out, sharding)

    return jax.jit(wrapped,
                   in_shardings=(sharding, None),
                   out_shardings=sharding,
                   donate_argnums=(0,) if donate else ())
