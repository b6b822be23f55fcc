"""rocq command-line interface.

API-parity rebuild of the reference rocq_cli.py: ``run --backend X --shots
N`` submits a Bell circuit to the chosen backend (QASM string for Type A/C
backends, circuit object for Type B), polls the job, prints the histogram.
Credential env-var preflight matches rocq_cli.py:29-37.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .core import available_backends, get_active_backend, set_target
from .qcircuit import QuantumCircuit

# backend -> required environment variable (rocq_cli.py:29-37)
_CREDENTIAL_ENV = {
    "ionq": "IONQ_API_KEY",
    "quantinuum": "CUDAQ_QUANTINUUM_CREDENTIALS",
    "pasqal": "PASQAL_API_KEY",
    "infleqtion": "SUPERSTAQ_API_KEY",
    "rigetti": "AWS_ACCESS_KEY_ID",
}

# backends submitting the circuit OBJECT rather than QASM (Type B)
_OBJECT_BACKENDS = {"qristal"}


def _build_bell() -> QuantumCircuit:
    circuit = QuantumCircuit(num_qubits=2)
    circuit.h(0)
    circuit.cx(0, 1)
    return circuit


def run_command(args) -> int:
    backend_name = args.backend
    env_var = _CREDENTIAL_ENV.get(backend_name)
    if env_var and not os.getenv(env_var):
        print(f"[ERROR] Backend '{backend_name}' requires the {env_var} "
              "environment variable to be set.")
        return 1

    print(f"--> Building Bell circuit; targeting '{backend_name}'...")
    circuit = _build_bell()
    try:
        set_target(backend_name)
        backend = get_active_backend()
    except Exception as e:
        print(f"[ERROR] Could not activate backend: {e}")
        return 1

    payload = circuit if backend_name in _OBJECT_BACKENDS else circuit.to_qasm()
    try:
        job_id = backend.submit_job(payload, shots=args.shots)
    except Exception as e:
        print(f"[ERROR] Job submission failed: {e}")
        return 1
    print(f"--> Job submitted. ID: {job_id}")

    deadline = time.time() + args.timeout
    while True:
        try:
            status = backend.get_job_status(job_id)
        except Exception as e:
            print(f"[ERROR] Polling failed: {e}")
            return 1
        print(f"    Job status: {status}")
        if status == "completed":
            results = backend.get_job_result(job_id)
            print(f"--> Results: {results}")
            return 0
        if status in ("failed", "cancelled"):
            print("--> Job did not complete successfully.")
            return 1
        if time.time() > deadline:
            print("[ERROR] Timed out waiting for job completion.")
            return 1
        time.sleep(args.poll_interval)


def list_command(_args) -> int:
    print("Available backends:")
    for name in available_backends():
        print(f"  {name}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rocq", description="rocQuantum command line interface")
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run a Bell circuit on a backend")
    run_p.add_argument("--backend", default="local",
                       help="target backend name (see 'list')")
    run_p.add_argument("--shots", type=int, default=100)
    run_p.add_argument("--timeout", type=float, default=120.0)
    run_p.add_argument("--poll-interval", type=float, default=2.0)
    run_p.set_defaults(func=run_command)

    list_p = sub.add_parser("list", help="list available backends")
    list_p.set_defaults(func=list_command)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
