"""Batched (DP) simulation: batched+sharded circuits and per-batch-element
measurement/readback — the reference threads ``batchSize`` through every
kernel including the distributed decls (hipStateVec.h:61,
single_qubit_kernels.hip:35-51, rocsvAllocateDistributedState
hipStateVec.h:92). VERDICT r1 items 2+3.

Runs on the 8-virtual-device CPU mesh from conftest.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import rocquantum_tpu as rocq
from rocquantum_tpu.parallel.mesh import make_mesh, make_mesh_2d


def _bell_plus_ry(circ, theta):
    circ.h(0)
    circ.cx(0, 1)
    circ.ry(theta, 2)


class TestBatchedSharded:
    def _reference_states(self, n, batch, theta):
        sim = rocq.Simulator()
        states = []
        for _ in range(batch):
            c = rocq.Circuit(n, sim)
            _bell_plus_ry(c, theta)
            states.append(c.get_statevector())
        return np.stack(states)

    @pytest.mark.parametrize("mesh_shape", [("1d", 4), ("2d", (2, 4))])
    def test_batched_sharded_matches_single_device(self, mesh_shape):
        n, batch, theta = 5, 4, 0.37
        kind, shape = mesh_shape
        mesh = make_mesh(shape) if kind == "1d" else make_mesh_2d(*shape)
        sim = rocq.Simulator()
        c = rocq.Circuit(n, sim, batch_size=batch, mesh=mesh)
        _bell_plus_ry(c, theta)
        got = c.get_statevector()
        assert got.shape == (batch, 1 << n)
        expected = self._reference_states(n, batch, theta)
        np.testing.assert_allclose(got, expected, atol=1e-6)

    def test_batched_sharded_gate_on_global_qubit(self):
        # gates on device-selecting (top) qubits must still be exact
        n, batch = 5, 2
        mesh = make_mesh_2d(2, 4)
        sim = rocq.Simulator()
        c = rocq.Circuit(n, sim, batch_size=batch, mesh=mesh)
        c.h(n - 1)
        c.cx(n - 1, 0)
        got = c.get_statevector()
        ref = rocq.Circuit(n, rocq.Simulator())
        ref.h(n - 1)
        ref.cx(n - 1, 0)
        expected = ref.get_statevector()
        for b in range(batch):
            np.testing.assert_allclose(got[b], expected, atol=1e-6)

    def test_batched_sharded_expval_and_sample(self):
        n, batch = 4, 4
        mesh = make_mesh_2d(2, 4)
        sim = rocq.Simulator(seed=3)
        c = rocq.Circuit(n, sim, batch_size=batch, mesh=mesh)
        c.h(0)
        c.cx(0, 1)
        ev = c.expval(rocq.PauliOperator({"Z0 Z1": 1.0}))
        np.testing.assert_allclose(np.asarray(ev), np.ones(batch), atol=1e-6)
        samples = c.sample([0, 1], 200)
        assert samples.shape == (batch, 200)
        assert set(np.unique(samples)) <= {0, 3}


class TestBatchedMeasurement:
    def test_batched_measure_collapses_each_element(self):
        batch = 6
        sim = rocq.Simulator(seed=11)
        c = rocq.Circuit(1, sim, batch_size=batch)
        for _ in range(1):
            c.h(0)
        outcomes, probs = c.measure(0)
        assert outcomes.shape == (batch,)
        np.testing.assert_allclose(probs, 0.5 * np.ones(batch), atol=1e-6)
        # each element collapsed to its own outcome
        states = c.get_statevector()
        for b in range(batch):
            expected = np.zeros(2, complex)
            expected[outcomes[b]] = 1.0
            np.testing.assert_allclose(np.abs(states[b]), np.abs(expected),
                                       atol=1e-6)

    def test_batched_statevector_slice(self):
        batch = 3
        sim = rocq.Simulator()
        c = rocq.Circuit(2, sim, batch_size=batch)
        c.h(0)
        sl = c.get_statevector_slice(0, 2)
        assert sl.shape == (batch, 2)
        np.testing.assert_allclose(np.abs(sl), 2**-0.5 * np.ones((batch, 2)),
                                   atol=1e-6)

    def test_batched_probabilities(self):
        batch = 2
        sim = rocq.Simulator()
        c = rocq.Circuit(2, sim, batch_size=batch)
        c.h(0)
        c.cx(0, 1)
        probs = c.get_probabilities()
        assert probs.shape == (batch, 4)
        np.testing.assert_allclose(probs[:, 0], 0.5, atol=1e-6)
        np.testing.assert_allclose(probs[:, 3], 0.5, atol=1e-6)

    def test_batched_mid_circuit_conditional_stats(self):
        # measure then continue: collapse must feed the next segment
        batch = 8
        sim = rocq.Simulator(seed=5)
        c = rocq.Circuit(2, sim, batch_size=batch)
        c.h(0)
        outcomes, _ = c.measure(0)
        c.cx(0, 1)
        states = c.get_statevector()
        for b in range(batch):
            idx = int(outcomes[b]) * 3  # |00> or |11>
            assert abs(abs(states[b][idx]) - 1.0) < 1e-6


class TestBatchedShardedPallas:
    def test_batched_sharded_with_pallas_engaged(self):
        """The full composition: a batched, (dp, sv)-sharded circuit
        matches a dense numpy reference in every batch element."""
        import _np_ref
        import rocquantum_tpu as rocq
        from rocquantum_tpu.parallel.mesh import make_mesh_2d

        n = 14
        mesh = make_mesh_2d(2, 4)
        sim = rocq.Simulator()
        c = rocq.Circuit(n, sim, batch_size=2, mesh=mesh)
        for q in range(8):
            c.ry(0.1 * (q + 1), q)
        for q in range(7):
            c.cx(q, q + 1)
        got = c.get_statevector()
        exp = _np_ref.run(n, [("RY", [q], [], [0.1 * (q + 1)])
                              for q in range(8)]
                          + [("CNOT", [q + 1], [q], []) for q in range(7)])
        for b in range(2):
            np.testing.assert_allclose(got[b], exp, atol=1e-5)


class TestBatchedPair:
    """Batched fp64: batchSize as extra TOP index bits of ONE flat
    float-PAIR state (the reference threads batchSize through every kernel
    including the fp64 builds, hipStateVec.h:7-15,61)."""

    @pytest.fixture
    def double_precision(self):
        from rocquantum_tpu import config
        old = config.get_precision()
        config.set_precision("double")
        yield
        config.set_precision(old)

    def test_batched_pair_statevector_matches_single(self, double_precision):
        n, batch, theta = 5, 3, 0.41
        sim = rocq.Simulator()
        c = rocq.Circuit(n, sim, batch_size=batch)
        assert c._use_pair()
        _bell_plus_ry(c, theta)
        got = c.get_statevector()
        assert got.shape == (batch, 1 << n)
        assert isinstance(c._state, tuple)
        assert c._state[0].dtype == jnp.float64
        ref = rocq.Circuit(n, rocq.Simulator())
        _bell_plus_ry(ref, theta)
        exp = ref.get_statevector()
        for b in range(batch):
            np.testing.assert_allclose(got[b], exp, atol=1e-12, rtol=0)

    def test_batched_pair_expval_probabilities_slice(self, double_precision):
        n, batch = 4, 2
        sim = rocq.Simulator()
        c = rocq.Circuit(n, sim, batch_size=batch)
        c.ry(0.3, 0)
        c.cx(0, 1)
        op = rocq.PauliOperator({"Z0 Z1": 1.0, "X0": 0.5})
        ev = c.expval(op)
        assert ev.shape == (batch,)
        ref = rocq.Circuit(n, rocq.Simulator())
        ref.ry(0.3, 0)
        ref.cx(0, 1)
        ev_ref = ref.expval(op)
        np.testing.assert_allclose(ev, ev_ref, atol=1e-12, rtol=0)
        probs = c.get_probabilities([0, 1])
        assert probs.shape == (batch, 4)
        np.testing.assert_allclose(probs[0],
                                   ref.get_probabilities([0, 1]), atol=1e-12, rtol=0)
        sl = c.get_statevector_slice(0, 4)
        assert sl.shape == (batch, 4)
        np.testing.assert_allclose(sl[1], ref.get_statevector_slice(0, 4),
                                   atol=1e-12, rtol=0)

    def test_batched_pair_measure_collapses_each_element(self,
                                                         double_precision):
        n, batch = 3, 8
        sim = rocq.Simulator(seed=7)
        c = rocq.Circuit(n, sim, batch_size=batch)
        for _ in range(1):
            c.h(0)
            c.cx(0, 1)
        outcomes, probs = c.measure(0)
        assert outcomes.shape == (batch,)
        np.testing.assert_allclose(probs, 0.5, atol=1e-9)
        # Bell pair: qubit 1 collapses WITH qubit 0 per element
        state = c.get_statevector()
        for b in range(batch):
            idx = int(np.argmax(np.abs(state[b])))
            assert ((idx >> 0) & 1) == ((idx >> 1) & 1) == outcomes[b]

    def test_batched_pair_sampling(self, double_precision):
        n, batch, shots = 3, 2, 4000
        sim = rocq.Simulator(seed=3)
        c = rocq.Circuit(n, sim, batch_size=batch)
        c.ry(np.pi / 2, 0)
        out = c.sample([0], shots)
        assert out.shape == (batch, shots)
        for b in range(batch):
            frac = float(np.mean(out[b]))
            assert 0.42 < frac < 0.58
        counts = c.sample_counts([0], shots)
        assert set(counts) <= {"0", "1"}

    def test_batched_sharded_double_stays_complex_path(self,
                                                       double_precision):
        # batched+sharded fp64 has no pair twin: it must take the complex
        # engine (CPU-executable) rather than crash
        if len(jax.devices()) < 4:
            pytest.skip("needs 4 virtual devices")
        mesh = make_mesh(4)
        sim = rocq.Simulator()
        c = rocq.Circuit(4, sim, batch_size=2, mesh=mesh)
        assert not c._use_pair()
        c.h(0)
        got = c.get_statevector()
        assert got.shape == (2, 16)
