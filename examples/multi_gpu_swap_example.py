"""Sharded-statevector index-bit swap over a device mesh (reference
examples/multi_gpu_swap_example.py + MULTI_GPU_GUIDE.md). On a CPU host run
with XLA_FLAGS=--xla_force_host_platform_device_count=8 this exercises the
real all-to-all collective; across GPUs of one host it rides NVLink."""

import numpy as np
import jax

import rocquantum_tpu as rocq
from rocquantum_tpu.parallel import (make_mesh, sharded_init_state,
                                     swap_index_bits_sharded,
                                     num_global_qubits)


def main():
    n_dev = len(jax.devices())
    if n_dev & (n_dev - 1):
        n_dev = 1 << (n_dev.bit_length() - 1)
    mesh = make_mesh(n_dev)
    n = max(6, num_global_qubits(mesh) + 3)
    print(f"mesh: {n_dev} devices; {num_global_qubits(mesh)} global qubits; "
          f"{n}-qubit state")

    sim = rocq.Simulator()
    c = rocq.Circuit(n, sim, mesh=mesh)
    c.h(0)
    c.cx(0, n - 1)  # entangle a local qubit with a device-selecting qubit
    psi = c.get_statevector()
    expected = np.zeros(1 << n, complex)
    expected[0] = expected[1 | (1 << (n - 1))] = 2**-0.5
    assert np.allclose(psi, expected, atol=1e-6)
    print("gate across the device boundary OK")

    state = sharded_init_state(n, mesh)
    swapped = swap_index_bits_sharded(state, 0, n - 1, mesh)
    print("index-bit swap (local<->global, the rcclAlltoallv analog) OK")
    print("SUCCESS")


if __name__ == "__main__":
    main()
