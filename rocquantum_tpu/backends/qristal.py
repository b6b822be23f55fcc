"""Qristal backend (Type B: direct, provider-managed local execution).

API-parity rebuild of reference rocquantum/backends/qristal.py —
synchronous local execution taking a QuantumCircuit object (not QASM), with
the same job-id/status/result lifecycle. The reference shelled out to a
``qristal`` CLI and then **mocked the stdout histogram** (qristal.py:75-84);
here, if the ``qristal`` CLI exists it is used for real, and otherwise the
circuit runs on the local simulator, producing a true histogram.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import tempfile
import uuid
from typing import Any, Dict

from .base import RocqBackend, JobSubmissionError, ResultRetrievalError
from ..qcircuit import QuantumCircuit


class QuantumBrillianceBackend(RocqBackend):
    """Local synchronous execution via the Qristal SDK CLI (if present) or
    the built-in simulator."""

    def __init__(self, backend_name: str = "qristal",
                 api_endpoint: str = "local"):
        super().__init__(backend_name=backend_name, api_endpoint=api_endpoint)
        self._local_results: Dict[str, Dict] = {}

    def authenticate(self) -> None:
        """Authentication is not required for a local SDK."""

    def _get_auth_headers(self) -> Dict[str, str]:
        return {}

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        raise NotImplementedError(
            "Payload building is not used for Type B backends.")

    def _run_cli(self, circuit: QuantumCircuit, shots: int) -> Dict[str, int]:
        qasm_string = circuit.to_qasm()
        with tempfile.NamedTemporaryFile(mode="w", suffix=".qasm",
                                         delete=False) as tmp:
            tmp.write(qasm_string)
            path = tmp.name
        command = ["qristal", "--run", path, "--shots", str(shots)]
        try:
            result = subprocess.run(command, capture_output=True, text=True,
                                    check=True)
        except subprocess.CalledProcessError as e:
            raise JobSubmissionError(
                f"Job execution failed with error: {e.stderr}")
        for line in result.stdout.splitlines():
            if "Histogram:" in line:
                return json.loads(line.split("Histogram:")[1].strip())
        raise ResultRetrievalError(
            f"Failed to parse histogram from Qristal output:\n{result.stdout}")

    def _run_local_simulator(self, circuit: QuantumCircuit,
                             shots: int) -> Dict[str, int]:
        from collections import Counter
        from ..simulator import QuantumSimulator

        sim = QuantumSimulator(circuit.num_qubits)
        ir = circuit.to_ir()
        for op in ir.ops:
            sim._queue.append(op)
        samples = sim.measure(list(range(circuit.num_qubits)), shots)
        n = circuit.num_qubits
        return {format(k, f"0{n}b"): v for k, v in Counter(samples).items()}

    def submit_job(self, circuit: QuantumCircuit, shots: int) -> str:
        """Execute synchronously; returns a local job id."""
        if not isinstance(circuit, QuantumCircuit):
            raise JobSubmissionError(
                "Qristal backend requires a QuantumCircuit object, not a "
                "QASM string.")
        if shutil.which("qristal"):
            histogram = self._run_cli(circuit, shots)
        else:
            histogram = self._run_local_simulator(circuit, shots)
        job_id = f"local-run-{uuid.uuid4()}"
        self._local_results[job_id] = {"histogram": histogram}
        return job_id

    def get_job_status(self, job_id: str) -> str:
        if job_id in self._local_results:
            return "completed"
        raise ResultRetrievalError(f"Local job ID '{job_id}' not found.")

    def get_job_result(self, job_id: str) -> Dict[str, int]:
        if job_id not in self._local_results:
            raise ResultRetrievalError(f"Local job ID '{job_id}' not found.")
        return self._local_results[job_id]["histogram"]
