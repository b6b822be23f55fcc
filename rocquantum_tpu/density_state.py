"""Stateful DensityMatrixState handle (the B3 binding surface).

API-parity rebuild of the reference's ``rocq_hip`` pybind module
(reference: rocquantum/src/python/py_hip_density_mat.cpp — DensityMatrixState
with apply_gate(matrix, qubit, adjoint) :44-64, apply_cnot :65,
apply_controlled_gate :68, compute_expectation :82,
_compute_z_product_expectation :87, bit-flip/depolarizing channels :92-97;
Pauli enum :99-103). Operations queue and execute as jitted segments.
"""

from __future__ import annotations

import enum
from typing import List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from . import config
from .ops import density as dmops
from .utils.cache import BoundedCache

# flush programs keyed on queue STRUCTURE (angles are runtime inputs)
_DMS_RUN_CACHE = BoundedCache()


def _item_params(item, params):
    """Resolve a queue item's gate params: slot indices -> the runtime
    parameter vector, concrete values pass through."""
    vals = item[4]
    if vals and vals[0] == "slots":
        return tuple(params[i] for i in vals[1:])
    return tuple(vals)


class Pauli(enum.Enum):
    I = "I"
    X = "X"
    Y = "Y"
    Z = "Z"


class DensityMatrixState:
    """n-qubit density matrix with an eager-looking, jit-batched API."""

    def __init__(self, num_qubits: int):
        if num_qubits <= 0:
            raise ValueError("num_qubits must be positive")
        self.num_qubits = num_qubits
        self._rho = None
        self._queue: List[tuple] = []

    def _use_pair(self) -> bool:
        """fp64 density states run the float-pair engine (ops/pairdm.py).
        Sticky once the state exists."""
        if self._rho is not None:
            return isinstance(self._rho, tuple)
        return config.get_precision() == "double"

    def _flush(self):
        if self._rho is None:
            n = self.num_qubits
            if self._use_pair():
                from .ops import pairdm
                self._rho = jax.jit(lambda: pairdm.init_density_pair(n))()
            else:
                self._rho = jax.jit(lambda: dmops.init_density(n))()
        if not self._queue:
            return
        # split gate angles into a runtime vector so the compiled program
        # is keyed on STRUCTURE only (never bake angles into compiled
        # programs on a hot path — a VQE loop would otherwise trigger one
        # remote compile per flush)
        key_items, values = [], []
        for item in self._queue:
            if item[0] == "gate" and item[4]:
                slots = tuple(range(len(values), len(values) + len(item[4])))
                values.extend(item[4])
                key_items.append(item[:4] + (("slots",) + slots,))
            else:
                key_items.append(item)
        key_items = tuple(key_items)
        pair = self._use_pair()
        cache_key = (self.num_qubits, key_items, pair,
                     config.get_precision())
        fn = _DMS_RUN_CACHE.get(cache_key)
        if fn is None:
            fn = (self._build_pair_run(key_items) if pair
                  else self._build_run(key_items))
            _DMS_RUN_CACHE[cache_key] = fn
        params = jnp.asarray(values, dtype=config.real_dtype())
        self._rho = fn(*self._rho, params) if pair \
            else fn(self._rho, params)
        self._queue.clear()

    def _build_run(self, key_items):
        """Jitted complex-engine run loop (structure-cached)."""
        def run(rho, params):
            for item in key_items:
                kind = item[0]
                if kind == "matrix":
                    _, mat_bytes, shape, targets, adjoint = item
                    mat = np.frombuffer(mat_bytes, np.complex128).reshape(shape)
                    m = jnp.asarray(mat, config.complex_dtype())
                    if adjoint:
                        m = jnp.conj(m).T
                    rho = dmops.apply_matrix_dm(rho, m, list(targets))
                elif kind == "cmatrix":
                    _, mat_bytes, shape, controls, targets = item
                    mat = np.frombuffer(mat_bytes, np.complex128).reshape(shape)
                    m = jnp.asarray(mat, config.complex_dtype())
                    rho = dmops.apply_controlled_matrix_dm(
                        rho, m, list(controls), list(targets))
                elif kind == "gate":
                    _, name, targets, controls, _ = item
                    rho = dmops.apply_gate_dm(
                        rho, name, list(targets), list(controls),
                        list(_item_params(item, params)))
                else:  # channel
                    _, channel, prob, targets = item
                    rho = dmops.apply_channel(rho, channel, prob,
                                              list(targets))
            return rho

        return jax.jit(run, donate_argnums=(0,))

    def _build_pair_run(self, key_items):
        """Jitted fp64 pair-engine twin of the run loop."""
        from .compiler.ir import GateOp
        from .ops import pairdm
        n = self.num_qubits

        def run(re, im, params):
            for item in key_items:
                kind = item[0]
                if kind == "matrix":
                    _, mat_bytes, shape, targets, adjoint = item
                    mat = np.frombuffer(mat_bytes,
                                        np.complex128).reshape(shape)
                    re, im = pairdm.apply_op_pair_dm(
                        re, im, GateOp("UNITARY", tuple(targets), (), (),
                                       mat, bool(adjoint)), n)
                elif kind == "cmatrix":
                    _, mat_bytes, shape, controls, targets = item
                    mat = np.frombuffer(mat_bytes,
                                        np.complex128).reshape(shape)
                    re, im = pairdm.apply_op_pair_dm(
                        re, im, GateOp("UNITARY", tuple(targets),
                                       tuple(controls), (), mat), n)
                elif kind == "gate":
                    _, name, targets, controls, _ = item
                    re, im = pairdm.apply_op_pair_dm(
                        re, im, GateOp(name.upper(), tuple(targets),
                                       tuple(controls), ()), n,
                        params_resolved=_item_params(item, params))
                else:  # channel
                    _, channel, prob, targets = item
                    re, im = pairdm.apply_channel_pair_dm(
                        re, im, channel, prob, list(targets), n)
            return re, im

        return jax.jit(run, donate_argnums=(0, 1))

    # -- binding-parity API --------------------------------------------------

    def apply_gate(self, matrix: np.ndarray, qubit: int,
                   adjoint: bool = False):
        matrix = np.ascontiguousarray(np.asarray(matrix), np.complex128)
        self._queue.append(("matrix", matrix.tobytes(), matrix.shape,
                            (qubit,), bool(adjoint)))

    def apply_matrix(self, matrix: np.ndarray, qubits: Sequence[int]):
        matrix = np.ascontiguousarray(np.asarray(matrix), np.complex128)
        self._queue.append(("matrix", matrix.tobytes(), matrix.shape,
                            tuple(qubits), False))

    def apply_cnot(self, control: int, target: int):
        self._queue.append(("gate", "CNOT", (target,), (control,), ()))

    def apply_controlled_gate(self, matrix: np.ndarray, control: int,
                              target: int):
        matrix = np.ascontiguousarray(np.asarray(matrix), np.complex128)
        self._queue.append(("cmatrix", matrix.tobytes(), matrix.shape,
                            (control,), (target,)))

    def apply_h(self, qubit: int):
        self._queue.append(("gate", "H", (qubit,), (), ()))

    def apply_x(self, qubit: int):
        self._queue.append(("gate", "X", (qubit,), (), ()))

    def apply_y(self, qubit: int):
        self._queue.append(("gate", "Y", (qubit,), (), ()))

    def apply_z(self, qubit: int):
        self._queue.append(("gate", "Z", (qubit,), (), ()))

    def apply_ry(self, theta: float, qubit: int):
        self._queue.append(("gate", "RY", (qubit,), (), (float(theta),)))

    def apply_rz(self, phi: float, qubit: int):
        self._queue.append(("gate", "RZ", (qubit,), (), (float(phi),)))

    def apply_bit_flip_channel(self, qubits, prob: float):
        qubits = [qubits] if isinstance(qubits, int) else list(qubits)
        self._queue.append(("channel", "bit_flip", float(prob), tuple(qubits)))

    def apply_phase_flip_channel(self, qubits, prob: float):
        qubits = [qubits] if isinstance(qubits, int) else list(qubits)
        self._queue.append(("channel", "phase_flip", float(prob),
                            tuple(qubits)))

    def apply_depolarizing_channel(self, qubits, prob: float):
        qubits = [qubits] if isinstance(qubits, int) else list(qubits)
        self._queue.append(("channel", "depolarizing", float(prob),
                            tuple(qubits)))

    def apply_amplitude_damping_channel(self, qubits, gamma: float):
        qubits = [qubits] if isinstance(qubits, int) else list(qubits)
        self._queue.append(("channel", "amplitude_damping", float(gamma),
                            tuple(qubits)))

    def compute_expectation(self, pauli: "Pauli | str", qubit: int) -> float:
        """<P_q> = Tr(P_q rho) (py_hip_density_mat.cpp:82)."""
        self._flush()
        p = pauli.value if isinstance(pauli, Pauli) else str(pauli).upper()
        if self._use_pair():
            from .ops import pairdm
            n = self.num_qubits
            if p == "I":
                return float(pairdm.trace_pair_dm_jit(self._rho[0], n))
            if p == "Z":
                return float(pairdm.expval_z_pair_dm_jit(
                    self._rho[0], qubit, n))
            return float(pairdm.expval_pauli_string_pair_dm_jit(
                *self._rho, ops=((p, qubit),), n=n))
        if p == "I":
            return float(dmops.trace_dm(self._rho))
        if p == "Z":
            return float(dmops.expval_z_dm_jit(self._rho, qubit))
        return float(dmops.expval_pauli_string_dm_jit(
            self._rho, ops=((p, qubit),)))

    def _compute_z_product_expectation(self, z_indices: Sequence[int]) -> float:
        """(py_hip_density_mat.cpp:87)"""
        self._flush()
        if self._use_pair():
            from .ops import pairdm
            return float(pairdm.expval_pauli_product_z_pair_dm_jit(
                self._rho[0], qubits=tuple(z_indices), n=self.num_qubits))
        return float(dmops.expval_pauli_product_z_dm_jit(
            self._rho, qubits=tuple(z_indices)))

    def compute_pauli_string_expectation(self, ops: Sequence[tuple]) -> float:
        self._flush()
        if self._use_pair():
            from .ops import pairdm
            return float(pairdm.expval_pauli_string_pair_dm_jit(
                *self._rho, ops=tuple(ops), n=self.num_qubits))
        return float(dmops.expval_pauli_string_dm_jit(
            self._rho, ops=tuple(ops)))

    def get_density_matrix(self) -> np.ndarray:
        self._flush()
        dim = 1 << self.num_qubits
        if self._use_pair():
            re, im = self._rho
            return (np.asarray(re).reshape(dim, dim).astype(np.complex128)
                    + 1j * np.asarray(im).reshape(dim, dim))
        mat = dmops.to_matrix(self._rho)
        re, im = jax.jit(lambda r: (jnp.real(r), jnp.imag(r)))(mat)
        return np.asarray(re).astype(np.complex128) + 1j * np.asarray(im)
