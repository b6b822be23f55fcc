"""DensityCircuit (main-API noise-capable circuit handle) tests."""

import numpy as np
import pytest

import rocquantum_tpu as rocq
from rocquantum_tpu.density_circuit import DensityCircuit
from rocquantum_tpu.dsl import NoiseModel


class TestDensityCircuit:
    def test_bell(self):
        c = DensityCircuit(2, rocq.Simulator())
        c.h(0)
        c.cx(0, 1)
        rho = c.get_density_matrix()
        psi = np.zeros(4, complex)
        psi[0] = psi[3] = 2**-0.5
        np.testing.assert_allclose(rho, np.outer(psi, psi.conj()), atol=1e-6)
        assert abs(c.purity() - 1.0) < 1e-5

    def test_noise_model_attachment(self):
        noise = NoiseModel()
        noise.add_channel("depolarizing", 0.1)
        c = DensityCircuit(1, rocq.Simulator(), noise_model=noise)
        c.ry(0.9, 0)
        expected = np.cos(0.9) * (1 - 4 * 0.1 / 3)
        assert abs(c.expval(rocq.PauliOperator("Z0")) - expected) < 1e-6
        assert c.purity() < 1.0

    def test_explicit_channel_and_kraus(self):
        c = DensityCircuit(1, rocq.Simulator())
        c.x(0)
        c.apply_channel("amplitude_damping", 0.25, [0])
        rho = c.get_density_matrix()
        np.testing.assert_allclose(rho, np.diag([0.25, 0.75]), atol=1e-6)

        c2 = DensityCircuit(1, rocq.Simulator())
        p = 0.2
        c2.apply_kraus([np.sqrt(1 - p) * np.eye(2),
                        np.sqrt(p) * np.array([[0, 1], [1, 0]])], [0])
        np.testing.assert_allclose(c2.get_density_matrix(),
                                   np.diag([1 - p, p]), atol=1e-6)

    def test_measure_and_collapse(self):
        sim = rocq.Simulator(seed=4)
        c = DensityCircuit(2, sim)
        c.h(0)
        c.cx(0, 1)
        outcome, prob = c.measure(0)
        assert abs(prob - 0.5) < 1e-6
        # post-collapse the two qubits are perfectly correlated
        out = c.sample([0, 1], 200)
        assert set(np.unique(out)) == {0 if outcome == 0 else 3}

    def test_sampling_noisy(self):
        c = DensityCircuit(1, rocq.Simulator(seed=1))
        c.x(0)
        c.apply_channel("bit_flip", 0.3, [0])
        out = c.sample([0], 4000)
        frac1 = np.mean(out)
        assert abs(frac1 - 0.7) < 0.05

    def test_parameter_cache_structure(self):
        # two circuits differing only in angles share a compiled program
        from rocquantum_tpu.density_circuit import _DM_RUN_CACHE
        before = len(_DM_RUN_CACHE)
        for theta in (0.1, 0.2, 0.3):
            c = DensityCircuit(1, rocq.Simulator())
            c.ry(theta, 0)
            c.flush()
        assert len(_DM_RUN_CACHE) == before + 1

    def test_unitary_matrix_op(self):
        c = DensityCircuit(1, rocq.Simulator())
        c.apply_unitary([0], np.array([[0, 1], [1, 0]]))
        np.testing.assert_allclose(c.get_density_matrix(),
                                   np.diag([0, 1]), atol=1e-6)


def _np_unitary(n, name, targets, controls=(), params=()):
    import _np_ref
    eye = np.eye(1 << n, dtype=np.complex128)
    return np.stack([_np_ref.apply_op(eye[:, k], name, targets, controls,
                                      params) for k in range(1 << n)], axis=1)


def _np_depolarize(rho, n, p, q):
    import _np_ref
    out = (1 - p) * rho
    for pauli in ("X", "Y", "Z"):
        u = _np_unitary(n, pauli, [q])
        out = out + (p / 3) * u @ rho @ u.conj().T
    return out


def _np_dm_run(n, items):
    """Dense numpy rho for ("gate", name, targets, controls, params),
    ("matrix", u, targets) and ("depolarizing"|"phase_flip", p, q) items."""
    import _np_ref
    rho = np.zeros((1 << n, 1 << n), np.complex128)
    rho[0, 0] = 1.0
    eye = np.eye(1 << n, dtype=np.complex128)
    for item in items:
        if item[0] in ("gate", "matrix"):
            u = (_np_unitary(n, *item[1:]) if item[0] == "gate" else
                 np.stack([_np_ref.apply(eye[:, k], item[1], item[2])
                           for k in range(1 << n)], axis=1))
            rho = u @ rho @ u.conj().T
        elif item[0] == "depolarizing":
            rho = _np_depolarize(rho, n, item[1], item[2])
        else:
            z = _np_unitary(n, "Z", [item[2]])
            rho = (1 - item[1]) * rho + item[1] * z @ rho @ z
    return rho


class TestFusedGateRuns:
    def test_gate_runs_match_dense_path_with_pallas(self):
        """Unitary runs route through the fused interpreter on the 2n-qubit
        view: rho must equal a dense numpy reference, mid-run channels
        included."""
        import rocquantum_tpu as rocq
        from rocquantum_tpu.density_circuit import DensityCircuit

        n = 6
        c = DensityCircuit(n, rocq.Simulator())
        items = []
        for q in range(n):
            c.ry(0.1 * (q + 1), q)
            items.append(("gate", "RY", [q], [], [0.1 * (q + 1)]))
        c.s(1)
        c.t(2)
        c.y(3)
        items += [("gate", "S", [1], [], []), ("gate", "T", [2], [], []),
                  ("gate", "Y", [3], [], [])]
        for q in range(n - 1):
            c.cx(q, q + 1)
            items.append(("gate", "CNOT", [q + 1], [q], []))
        c.apply_channel("depolarizing", 0.02, [0])
        items.append(("depolarizing", 0.02, 0))
        c.rz(0.7, 4)
        c.rx(-0.3, 5)
        c.crz(0.4, 0, 4)
        items += [("gate", "RZ", [4], [], [0.7]),
                  ("gate", "RX", [5], [], [-0.3]),
                  ("gate", "CRZ", [4], [0], [0.4])]
        c.flush()
        rho = c.get_density_matrix()
        np.testing.assert_allclose(rho, _np_dm_run(n, items), atol=1e-5)
        # physicality: trace 1, hermitian
        assert abs(np.trace(rho) - 1.0) < 1e-5
        np.testing.assert_allclose(rho, rho.conj().T, atol=1e-5)


def test_long_queue_flush_segments_into_chained_programs():
    """A queue past the per-program op budget flushes as a CHAIN of jitted
    programs and matches the reference computed directly on rho."""
    import jax
    import rocquantum_tpu as rocq
    from rocquantum_tpu.density_circuit import DensityCircuit
    from rocquantum_tpu.ops import density as dmops

    n = 3
    dc = DensityCircuit(n, rocq.Simulator())
    rho = jax.jit(lambda: dmops.init_density(n))()
    rng = np.random.default_rng(0)
    for i in range(120):  # gates cost 2, channels 4: ~10 segments
        q = int(rng.integers(0, n))
        th = float(rng.normal())
        dc.ry(th, q)
        rho = dmops.apply_gate_dm(rho, "RY", [q], [], [th])
        if i % 5 == 0:
            dc.apply_channel("depolarizing", 0.02, [q])
            rho = dmops.apply_channel(rho, "depolarizing", 0.02, [q])
    dc.flush()
    got = np.asarray(dmops.to_matrix(dc.state))
    want = np.asarray(dmops.to_matrix(rho))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fused_pair_split_chain():
    """The conjugate-side sign handling of the 2n-qubit view (RZ negate, U3
    mixed, S->SDG) is right across two flushes, the second entering with
    an existing rho: matches a dense numpy reference."""
    import rocquantum_tpu as rocq
    from rocquantum_tpu import density_circuit as dcm

    n = 5
    items = []
    dc = dcm.DensityCircuit(n, rocq.Simulator())
    for q in range(n):
        dc.h(q)
        items.append(("gate", "H", [q], [], []))
    for q in range(n):
        dc.rz(0.2 + 0.03 * q, q)
        items.append(("gate", "RZ", [q], [], [0.2 + 0.03 * q]))
    dc._enqueue("U3", (1,), (), (0.4, 0.5, 0.6))
    t, ph, lam = 0.4, 0.5, 0.6
    u3 = np.array([[np.cos(t / 2), -np.exp(1j * lam) * np.sin(t / 2)],
                   [np.exp(1j * ph) * np.sin(t / 2),
                    np.exp(1j * (ph + lam)) * np.cos(t / 2)]])
    dc.s(2)
    for q in range(0, n - 1, 2):
        dc.cx(q, q + 1)
    for q in range(n):
        dc.apply_channel("phase_flip", 0.05, [q])
    dc.flush()
    dc.ry(0.7, 0)
    dc.rz(-0.1, 3)
    dc.apply_channel("depolarizing", 0.02, [0])
    rho = dc.get_density_matrix()

    items += ([("matrix", u3, [1]), ("gate", "S", [2], [], [])]
              + [("gate", "CNOT", [q + 1], [q], [])
                 for q in range(0, n - 1, 2)]
              + [("phase_flip", 0.05, q) for q in range(n)]
              + [("gate", "RY", [0], [], [0.7]),
                 ("gate", "RZ", [3], [], [-0.1]),
                 ("depolarizing", 0.02, 0)])
    want = _np_dm_run(n, items)
    np.testing.assert_allclose(rho, want, atol=1e-5)
    assert abs(np.trace(rho) - 1.0) < 1e-5


def test_density_df64_plan():
    """Density circuits in ``set_precision("df64")`` mode carry rho as the
    exact-f64 pair and match the exact pairdm engine."""
    import jax.numpy as jnp
    import rocquantum_tpu as rocq
    from rocquantum_tpu import config
    from rocquantum_tpu import density_circuit as dcm

    n = 3
    old = config.get_precision()
    config.set_precision("df64")
    try:
        def load(dc):
            dc.h(0)
            dc.ry(0.3, 1)
            dc.cx(0, 2)
            dc.rz(0.4, 2)
            dc.apply_channel("depolarizing", 0.05, [1])

        dc = dcm.DensityCircuit(n, rocq.Simulator(seed=1))
        load(dc)
        dc.flush()
        assert isinstance(dc._rho, tuple)
        assert dc._rho[0].dtype == jnp.float64
        z = dc.expval(rocq.PauliOperator("Z0"))

        # exact pairdm reference (same precision contract, no df64 engine)
        config.set_precision("double")
        dc2 = dcm.DensityCircuit(n, rocq.Simulator(seed=1))
        load(dc2)
        dc2.flush()
        z2 = dc2.expval(rocq.PauliOperator("Z0"))
        assert abs(z - z2) < 1e-10, (z, z2)
        np.testing.assert_allclose(dc.get_density_matrix(),
                                   dc2.get_density_matrix(), atol=1e-10)
    finally:
        config.set_precision(old)
