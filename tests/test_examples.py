"""Run every example script as an acceptance test (the reference's examples
double as its acceptance suite — SURVEY §4; each embeds its own asserts)."""

import os
import subprocess
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")

EXAMPLES = [
    "run_simple_circuit.py",
    "sampling_example.py",
    "dynamic_circuit_example.py",
    "expectation_example.py",
    "multi_control_gate_example.py",
    "adjoint_example.py",
    "gradient_example.py",
    "bell_state_density_matrix.py",
    "tensornet_example.py",
    "slicing_example.py",
    "advanced_path_example.py",
    "multi_gpu_swap_example.py",
    "run_simple_vqe.py",
    "vqe_h2.py",
    "vqe_h2_noisy.py",
    "vqe_lih.py",
    "qec_repetition_example.py",
    "run_bell_state.py",
    "compiler_qir_example.py",
    "vqe_h2_reference_style.py",
    "teleportation_qasm.py",
    "batched_sharded_vqe.py",
    "qaoa_maxcut.py",
    "phase_estimation_grover.py",
    "fp64_chemistry.py",
    "compiled_program_serving.py",
]


@pytest.mark.parametrize("script", EXAMPLES)
def test_example(script):
    env = dict(os.environ)
    repo_root = os.path.dirname(EXAMPLES_DIR)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    result = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, script)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(EXAMPLES_DIR))
    assert result.returncode == 0, (
        f"{script} failed:\nSTDOUT:\n{result.stdout[-3000:]}\n"
        f"STDERR:\n{result.stderr[-3000:]}")
