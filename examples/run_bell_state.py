"""Bell state on multiple backend architectures (reference
examples/run_bell_state.py). Builds the circuit once and runs it on the
local simulator, the Qristal Type B backend, and — when credentials are
present — the IonQ Type A API."""

import os
import time

from rocquantum_tpu.qcircuit import QuantumCircuit
from rocquantum_tpu.core import set_target, get_active_backend


def main():
    print("--> Building Bell circuit...")
    bell_circuit = QuantumCircuit(num_qubits=2)
    bell_circuit.h(0)
    bell_circuit.cx(0, 1)
    print(bell_circuit.to_qasm())

    # --- Local simulator (always available) ---
    print("\n--- Local simulator backend ---")
    set_target("local")
    backend = get_active_backend()
    job_id = backend.submit_job(bell_circuit.to_qasm(), shots=200)
    assert backend.get_job_status(job_id) == "completed"
    results = backend.get_job_result(job_id)
    print(f"--> Results: {results}")
    assert set(results) <= {"00", "11"}, "Bell state must only give 00/11"

    # --- Type B (Qristal-style local SDK) ---
    print("\n--- Type B backend (Qristal) ---")
    set_target("qristal")
    backend = get_active_backend()
    job_id = backend.submit_job(bell_circuit, shots=100)
    print(f"--> Results: {backend.get_job_result(job_id)}")

    # --- Type A (IonQ) — requires IONQ_API_KEY ---
    if os.getenv("IONQ_API_KEY"):
        print("\n--- Type A backend (IonQ) ---")
        set_target("ionq", backend_name="simulator")
        backend = get_active_backend()
        job_id = backend.submit_job(bell_circuit.to_qasm(), shots=100)
        while True:
            status = backend.get_job_status(job_id)
            print(f"    Job status: {status}")
            if status in ("completed", "failed", "cancelled"):
                break
            time.sleep(2)
    else:
        print("\n(IONQ_API_KEY not set; skipping IonQ execution.)")
    print("\nSUCCESS")


if __name__ == "__main__":
    main()
