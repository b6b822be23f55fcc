"""State checkpoint / resume.

The reference had none (SURVEY §5: "Checkpoint/resume: none"); its only
primitive was full state readback (rocsvGetStateVectorFull,
hipStateVec.cpp:691). Here: save/restore of statevector and density-matrix
states, including sharded states (saved per-shard-compatible as a single
host array, restored onto any mesh). Files hold (real, imag) float
pairs.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import config


def _to_parts(device_array: jax.Array):
    re, im = jax.jit(lambda s: (jnp.real(s), jnp.imag(s)))(device_array)
    return np.asarray(re), np.asarray(im)


def save_state(path: str, state, metadata: Optional[dict] = None):
    """Write a (possibly sharded) complex device array — or an fp64
    ``(re, im)`` float-pair state (Circuit pair mode) — to ``path`` (.npz).
    Both forms produce the same on-disk pair format."""
    if isinstance(state, tuple):
        re, im = np.asarray(state[0]), np.asarray(state[1])
    else:
        re, im = _to_parts(state)
    meta = dict(metadata or {})
    meta["shape"] = list(re.shape)
    np.savez(path, re=re, im=im, meta=json.dumps(meta))


def load_state(path: str, mesh=None, axis_name: str = "sv") -> jax.Array:
    """Load a state saved by save_state; optionally place it sharded over
    ``mesh`` (the amplitude axis split across devices)."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    re = jnp.asarray(data["re"], dtype=config.real_dtype())
    im = jnp.asarray(data["im"], dtype=config.real_dtype())

    if mesh is not None:
        from ..parallel.sharded import state_sharding
        sharding = state_sharding(mesh, axis_name)

        @jax.jit
        def combine(r, i):
            return jax.lax.with_sharding_constraint(
                (r + 1j * i).astype(config.complex_dtype()), sharding)
    else:
        @jax.jit
        def combine(r, i):
            return (r + 1j * i).astype(config.complex_dtype())

    return combine(re, im)


def load_metadata(path: str) -> dict:
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    return json.loads(str(data["meta"]))


def save_circuit_checkpoint(path: str, circuit) -> None:
    """Checkpoint a Circuit's device state + qubit count."""
    circuit.flush()
    save_state(path, circuit.state,
               {"num_qubits": circuit.num_qubits,
                "batch_size": circuit.batch_size})


def restore_circuit_checkpoint(path: str, circuit) -> None:
    """Resume a Circuit from a checkpoint (qubit counts must match)."""
    meta = load_metadata(path)
    if meta["num_qubits"] != circuit.num_qubits:
        raise ValueError(
            f"checkpoint has {meta['num_qubits']} qubits, circuit has "
            f"{circuit.num_qubits}")
    circuit._gate_queue.clear()
    circuit._is_dirty = False
    circuit._state = None
    if circuit._use_pair():
        data = np.load(path if path.endswith(".npz") or os.path.exists(path)
                       else path + ".npz", allow_pickle=False)
        rdt = config.real_dtype()
        re = jnp.asarray(data["re"], dtype=rdt)
        im = jnp.asarray(data["im"], dtype=rdt)
        if circuit.mesh is not None:
            # place both parts sharded, like the complex branch does
            from ..parallel.sharded import state_sharding
            sh = state_sharding(circuit.mesh)
            re = jax.device_put(re, sh)
            im = jax.device_put(im, sh)
        circuit._state = (re, im)
    else:
        circuit._state = load_state(path, mesh=circuit.mesh)
