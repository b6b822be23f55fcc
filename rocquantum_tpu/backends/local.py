"""Local simulator backend.

Not in the reference's registry (its only local path was the mocked Qristal
CLI): executes submitted circuits on the in-process JAX statevector engine
with the standard Type A-style job lifecycle, so the whole
set_target/submit/poll flow works offline and the CLI is end-to-end testable.
"""

from __future__ import annotations

import uuid
from collections import Counter
from typing import Any, Dict, Union

from .base import RocqBackend, JobSubmissionError, ResultRetrievalError
from ..qcircuit import QuantumCircuit


class LocalTPUBackend(RocqBackend):
    """Runs jobs on the local JAX statevector simulator."""

    def __init__(self, backend_name: str = "local", shots_seed: int = 0):
        super().__init__(backend_name=backend_name, api_endpoint="local")
        self._results: Dict[str, Dict[str, int]] = {}
        self._seed = shots_seed

    def authenticate(self) -> None:
        pass

    def _get_auth_headers(self) -> Dict[str, str]:
        return {}

    def _build_payload(self, circuit_representation: str,
                       shots: int) -> Dict[str, Any]:
        raise NotImplementedError("Local backend executes directly.")

    def submit_job(self, circuit: Union[QuantumCircuit, str],
                   shots: int) -> str:
        from ..simulator import QuantumSimulator

        if isinstance(circuit, str):
            from ..compiler.qasm_parser import parse_qasm3_program
            program = parse_qasm3_program(circuit)
            if not program.is_static:
                # dynamic circuit (mid-circuit measurement / classical
                # control): shot-batched execution
                from ..compiler.dynamic import run_dynamic
                histogram = run_dynamic(program, shots, seed=self._seed)
                job_id = f"local-{uuid.uuid4()}"
                self._results[job_id] = histogram
                return job_id
            ir = program.to_ir()
        elif isinstance(circuit, QuantumCircuit):
            ir = circuit.to_ir()
        else:
            raise JobSubmissionError(
                "Local backend accepts a QuantumCircuit or an OpenQASM "
                "string.")
        sim = QuantumSimulator(max(ir.num_qubits, 1), seed=self._seed)
        for op in ir.ops:
            sim._queue.append(op)
        samples = sim.measure(list(range(sim.num_qubits)), shots)
        n = sim.num_qubits
        histogram = {format(k, f"0{n}b"): v
                     for k, v in sorted(Counter(samples).items())}
        job_id = f"local-{uuid.uuid4()}"
        self._results[job_id] = histogram
        return job_id

    def get_job_status(self, job_id: str) -> str:
        if job_id in self._results:
            return "completed"
        raise ResultRetrievalError(f"Job '{job_id}' not found.")

    def get_job_result(self, job_id: str) -> Dict[str, int]:
        if job_id not in self._results:
            raise ResultRetrievalError(f"Job '{job_id}' not found.")
        return self._results[job_id]
