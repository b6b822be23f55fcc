"""VQE-H2 written exactly in the reference's examples/vqe_h2.py style —
``import rocquantum as rocq``, a params-list kernel, positional Pauli
strings, get_expval/grad free functions — running unchanged on this
framework through the compatibility shim."""

import numpy as np
from scipy.optimize import minimize

import rocquantum as rocq

# positional-string Hamiltonian (char i acts on qubit i), reference format
h2_hamiltonian = {
    "II": -0.4804 + 0.7137,
    "ZI": 0.3435,
    "IZ": -0.4347,
    "ZZ": 0.5716,
    "XX": 0.0910,
    "YY": 0.0910,
}

THEORETICAL = -1.13728


@rocq.kernel
def ansatz(params):
    rocq.ry(params[0], 0)
    rocq.ry(params[1], 1)
    rocq.cnot(0, 1)
    rocq.ry(params[2], 0)
    rocq.ry(params[3], 1)


def calculate_energy(params):
    total = 0.0
    for pauli_string, coefficient in h2_hamiltonian.items():
        if set(pauli_string) == {"I"}:
            total += coefficient
            continue
        total += coefficient * rocq.get_expval(ansatz, pauli_string, params)
    return total


def calculate_gradient(params):
    total = np.zeros_like(np.asarray(params, dtype=float))
    for pauli_string, coefficient in h2_hamiltonian.items():
        if set(pauli_string) == {"I"}:
            continue
        total += coefficient * np.asarray(
            rocq.grad(ansatz, pauli_string, params))
    return total


def run_vqe():
    rng = np.random.default_rng(1)
    initial = rng.uniform(0, 2 * np.pi, 4)
    result = minimize(fun=calculate_energy, x0=initial, method="L-BFGS-B",
                      jac=calculate_gradient, options={"maxiter": 200})
    err = abs(result.fun - THEORETICAL)
    print(f"Final energy: {result.fun:.5f} Ha (theory {THEORETICAL:.5f}, "
          f"err {err:.5f})")
    assert err < 2e-3
    print("SUCCESS")


if __name__ == "__main__":
    run_vqe()
