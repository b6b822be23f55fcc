"""PennyLane device plugin.

API-parity rebuild of the reference pennylane-rocq integration
(reference: integrations/pennylane-rocq/pennylane_rocq/rocq_device.py —
QubitDevice 'rocquantum.qpu', named-gate map + qml.matrix fallback,
analytic_probability + multinomial generate_samples). Requires pennylane at
import time.
"""

from __future__ import annotations

import numpy as np

import pennylane as qml
from pennylane.devices import QubitDevice

from ..simulator import QuantumSimulator

PENNYLANE_TO_ROCQ_GATES = {
    "PauliX": "X", "PauliY": "Y", "PauliZ": "Z",
    "Hadamard": "H", "S": "S", "T": "T",
    "CNOT": "CNOT", "CZ": "CZ",
}


class RocQDevice(QubitDevice):
    """PennyLane device running on the JAX statevector engine."""

    name = "rocQuantum Simulator Device"
    short_name = "rocquantum.qpu"
    pennylane_requires = ">=0.30"
    version = "0.1.0"
    author = "rocquantum_tpu developers"

    operations = set(PENNYLANE_TO_ROCQ_GATES) | {"QubitUnitary", "RX", "RY",
                                                 "RZ"}
    observables = {"PauliX", "PauliY", "PauliZ", "Identity", "Hadamard",
                   "Prod"}

    def __init__(self, wires, shots=None, **kwargs):
        super().__init__(wires=wires, shots=shots)
        self.sim = None
        self._state = None
        self.reset()

    def reset(self):
        self.sim = QuantumSimulator(num_qubits=len(self.wires))
        self._state = None

    def apply(self, operations, **kwargs):
        for op in operations:
            gate_name = op.name
            wire_indices = [self.wire_map[w] for w in op.wires]
            if gate_name in PENNYLANE_TO_ROCQ_GATES:
                self.sim.apply_gate(PENNYLANE_TO_ROCQ_GATES[gate_name],
                                    wire_indices)
            elif gate_name in ("RX", "RY", "RZ"):
                self.sim.apply_gate(gate_name, wire_indices,
                                    [float(p) for p in op.parameters])
            elif gate_name == "QubitUnitary":
                self.sim.apply_matrix(qml.matrix(op), wire_indices)
            else:
                raise NotImplementedError(
                    f"Operation {gate_name} not supported.")
        self._state = self.sim.get_statevector()

    @property
    def state(self):
        return self._state

    def analytic_probability(self, wires=None):
        if self._state is None:
            return None
        all_probs = np.abs(self._state) ** 2
        if wires is None:
            return all_probs
        wires_to_trace = [i for i, w in enumerate(self.wires)
                          if w not in wires]
        return self.marginal_prob(all_probs, wires_to_trace)

    def generate_samples(self):
        probs = np.asarray(self.analytic_probability(), dtype=np.float64)
        probs = np.maximum(probs, 0.0)
        probs /= probs.sum()  # float32 statevector norms are only ~1e-7 exact
        n = len(self.wires)
        rng = np.random.default_rng()
        outcomes = rng.choice(len(probs), size=self.shots, p=probs)
        return self.states_to_binary(outcomes, n)
