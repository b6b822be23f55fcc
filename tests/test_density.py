"""Density-matrix engine tests.

Mirrors the reference's GTest suite
(rocquantum/tests/hipDensityMat/test_hipDensityMat.cpp: CNOT control cases,
CZ on |++>) plus analytic channel checks for the four noise channels
(hipDensityMat.cpp:254-713).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rocquantum_tpu.ops import density as dm
from rocquantum_tpu.ops import statevec as sv
from rocquantum_tpu.ops import gates as g


def mat(rho):
    return np.asarray(dm.to_matrix(rho))


class TestUnitaryEvolution:
    def test_cnot_flips_target_when_control_is_one(self):
        # test_hipDensityMat.cpp:23
        rho = dm.init_density(2)
        rho = dm.apply_gate_dm(rho, "X", [0])           # control q0 -> 1
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 1])     # flips q1
        m = mat(rho)
        expected = np.zeros((4, 4), complex)
        expected[3, 3] = 1.0  # |11><11|
        np.testing.assert_allclose(m, expected, atol=1e-6)

    def test_cnot_does_nothing_when_control_is_zero(self):
        # test_hipDensityMat.cpp:62
        rho = dm.init_density(2)
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 1])
        m = mat(rho)
        expected = np.zeros((4, 4), complex)
        expected[0, 0] = 1.0
        np.testing.assert_allclose(m, expected, atol=1e-6)

    def test_cz_on_plus_plus(self):
        # test_hipDensityMat.cpp:100: CZ|++> = (|00>+|01>+|10>-|11>)/2
        rho = dm.init_density(2)
        rho = dm.apply_gate_dm(rho, "H", [0])
        rho = dm.apply_gate_dm(rho, "H", [1])
        rho = dm.apply_gate_dm(rho, "CZ", [0, 1])
        psi = np.array([1, 1, 1, -1], complex) / 2.0
        np.testing.assert_allclose(mat(rho), np.outer(psi, psi.conj()),
                                   atol=1e-6)

    def test_matches_statevector_for_pure_states(self):
        rng = np.random.default_rng(3)
        n = 3
        state = sv.init_state(n)
        rho = dm.init_density(n)
        for _ in range(10):
            q = int(rng.integers(0, n))
            q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
            th = float(rng.normal())
            state = sv.apply_gate(state, "RY", [q], params=[th])
            state = sv.apply_gate(state, "CNOT", [q, q2])
            rho = dm.apply_gate_dm(rho, "RY", [q], params=[th])
            rho = dm.apply_gate_dm(rho, "CNOT", [q, q2])
        expected = np.outer(np.asarray(state), np.asarray(state).conj())
        np.testing.assert_allclose(mat(rho), expected, atol=1e-5)

    def test_adjoint_flag(self):
        rho = dm.init_density(1)
        rho = dm.apply_gate_dm(rho, "S", [0])
        rho = dm.apply_gate_dm(rho, "S", [0], adjoint=True)
        np.testing.assert_allclose(mat(rho), np.diag([1, 0]), atol=1e-6)

    def test_controlled_gate(self):
        rho = dm.init_density(2)
        rho = dm.apply_gate_dm(rho, "X", [0])
        rho = dm.apply_controlled_matrix_dm(
            rho, jnp.asarray(g.X, jnp.complex64), [0], [1])
        m = mat(rho)
        assert abs(m[3, 3] - 1.0) < 1e-6


class TestChannels:
    def test_bit_flip_on_zero(self):
        p = 0.2
        rho = dm.init_density(1)
        rho = dm.apply_channel(rho, "bit_flip", p, [0])
        np.testing.assert_allclose(mat(rho), np.diag([1 - p, p]), atol=1e-6)
        assert abs(float(dm.expval_z_dm(rho, 0)) - (1 - 2 * p)) < 1e-6

    def test_phase_flip_on_plus(self):
        p = 0.3
        rho = dm.init_density(1)
        rho = dm.apply_gate_dm(rho, "H", [0])
        rho = dm.apply_channel(rho, "phase_flip", p, [0])
        # off-diagonals shrink by (1-2p)
        m = mat(rho)
        assert abs(m[0, 1] - 0.5 * (1 - 2 * p)) < 1e-6
        assert abs(m[0, 0] - 0.5) < 1e-6

    def test_depolarizing_on_zero(self):
        p = 0.15
        rho = dm.init_density(1)
        rho = dm.apply_channel(rho, "depolarizing", p, [0])
        np.testing.assert_allclose(
            mat(rho), np.diag([1 - 2 * p / 3, 2 * p / 3]), atol=1e-6)
        assert abs(float(dm.expval_z_dm(rho, 0)) - (1 - 4 * p / 3)) < 1e-6

    def test_amplitude_damping_on_one(self):
        gamma = 0.25
        rho = dm.init_density(1)
        rho = dm.apply_gate_dm(rho, "X", [0])
        rho = dm.apply_channel(rho, "amplitude_damping", gamma, [0])
        np.testing.assert_allclose(mat(rho), np.diag([gamma, 1 - gamma]),
                                   atol=1e-6)

    def test_trace_preserved(self):
        rho = dm.init_density(2)
        rho = dm.apply_gate_dm(rho, "H", [0])
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 1])
        for ch, p in [("bit_flip", 0.1), ("phase_flip", 0.2),
                      ("depolarizing", 0.3), ("amplitude_damping", 0.15)]:
            rho = dm.apply_channel(rho, ch, p, [0, 1])
        assert abs(float(dm.trace_dm(rho)) - 1.0) < 1e-5

    def test_purity_decreases(self):
        rho = dm.init_density(1)
        rho = dm.apply_gate_dm(rho, "H", [0])
        assert abs(float(dm.purity(rho)) - 1.0) < 1e-6
        rho = dm.apply_channel(rho, "depolarizing", 0.5, [0])
        assert float(dm.purity(rho)) < 0.99

    def test_unknown_channel(self):
        rho = dm.init_density(1)
        with pytest.raises(ValueError):
            dm.apply_channel(rho, "thermal_noise", 0.1, [0])

    def test_generic_kraus(self):
        # custom Kraus set equal to bit flip
        p = 0.2
        rho = dm.init_density(1)
        ks = [np.sqrt(1 - p) * np.eye(2), np.sqrt(p) * np.asarray(g.X)]
        rho = dm.apply_kraus(rho, [jnp.asarray(k, jnp.complex64) for k in ks], [0])
        np.testing.assert_allclose(mat(rho), np.diag([1 - p, p]), atol=1e-6)


class TestMeasurement:
    def test_sampling_bell_dm(self):
        rho = dm.init_density(2)
        rho = dm.apply_gate_dm(rho, "H", [0])
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 1])
        out = np.asarray(dm.sample_dm(rho, [0, 1], 2000, jax.random.PRNGKey(0)))
        counts = np.bincount(out, minlength=4)
        assert counts[1] == 0 and counts[2] == 0
        assert abs(counts[0] / 2000 - 0.5) < 0.05

    def test_collapse(self):
        rho = dm.init_density(1)
        rho = dm.apply_gate_dm(rho, "H", [0])
        c = dm.collapse_dm(rho, 0, 1)
        np.testing.assert_allclose(mat(c), np.diag([0, 1]), atol=1e-6)

    def test_expval_pauli_string_dm(self):
        # GHZ via density matrix: <X0 X1 X2> = 1
        rho = dm.init_density(3)
        rho = dm.apply_gate_dm(rho, "H", [0])
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 1])
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 2])
        v = float(dm.expval_pauli_string_dm(
            rho, [("X", 0), ("X", 1), ("X", 2)]))
        assert abs(v - 1.0) < 1e-6
        v = float(dm.expval_pauli_product_z_dm(rho, [0, 1]))
        assert abs(v - 1.0) < 1e-6

    def test_noisy_expectation(self):
        # depolarizing shrinks <Z> by (1 - 4p/3)
        p = 0.1
        theta = 0.9
        rho = dm.init_density(1)
        rho = dm.apply_gate_dm(rho, "RY", [0], params=[theta])
        rho = dm.apply_channel(rho, "depolarizing", p, [0])
        expected = np.cos(theta) * (1 - 4 * p / 3)
        assert abs(float(dm.expval_z_dm(rho, 0)) - expected) < 1e-6


def test_wide_kraus_uses_per_term_accumulate():
    """A 4-target Kraus channel takes the per-term path (the dense superop
    would need a rank-17 view) and must
    equal the dense-matrix math."""
    import jax
    n = 4
    rng = np.random.default_rng(21)
    a = rng.normal(size=(32, 16)) + 1j * rng.normal(size=(32, 16))
    q, _ = np.linalg.qr(a)
    ks = [np.asarray(q[:16]), np.asarray(q[16:])]  # 4q CPTP pair

    @jax.jit
    def run():
        rho = dm.init_density(n)
        rho = dm.apply_gate_dm(rho, "H", [0])
        rho = dm.apply_gate_dm(rho, "CNOT", [0, 3])
        rho = dm.apply_kraus(rho, [jnp.asarray(k) for k in ks],
                             [0, 1, 2, 3])
        return dm.to_matrix(rho)

    got = np.asarray(run())
    # dense reference: K rho K^dagger summed, on the full 16x16 matrix
    psi = np.zeros(16, complex)
    psi[0] = 1.0
    h = np.kron(np.eye(8), np.array([[1, 1], [1, -1]]) / np.sqrt(2))
    cx = np.eye(16)[:, [0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12, 5,
                        14, 7]]
    psi = cx @ (h @ psi)
    rho_ref = np.outer(psi, psi.conj())
    want = sum(k @ rho_ref @ k.conj().T for k in ks)
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert abs(np.trace(got).real - 1.0) < 1e-6
