"""Sharded (multi-device) state-vector tests on a virtual 8-device CPU mesh.

Ports the reference multi-GPU test assertions
(test_hipStateVec_multi_gpu.cpp: distributed alloc/init :83, gate on local
qubit :165, local CNOT :228, index-bit swap paths) to jax.sharding — plus
the cases the reference left NOT_IMPLEMENTED (gates on global qubits,
global<->global swaps, distributed sampling/expectations), which must also
pass here.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import rocquantum_tpu as rocq
from rocquantum_tpu.ops import statevec as sv
from rocquantum_tpu.parallel import (
    make_mesh, sharded_init_state, shard_state, state_sharding,
    swap_index_bits_sharded, num_global_qubits)
from rocquantum_tpu.compiler import CircuitIR, compile_ir, parametrize


requires_multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def host(state):
    re, im = jax.jit(lambda s: (jnp.real(s), jnp.imag(s)))(state)
    return np.asarray(re) + 1j * np.asarray(im)


@requires_multi
class TestDistributedState:
    def test_alloc_and_init(self):
        # test_hipStateVec_multi_gpu.cpp:83 — distributed |0...0>
        mesh = make_mesh(8)
        assert num_global_qubits(mesh) == 3
        state = sharded_init_state(6, mesh)
        assert len(state.sharding.device_set) == 8
        psi = host(state)
        np.testing.assert_allclose(psi, np.eye(64)[0], atol=1e-7)

    def test_each_device_owns_a_slice(self):
        mesh = make_mesh(8)
        state = sharded_init_state(6, mesh)
        shard_sizes = {s.data.shape[0] for s in state.addressable_shards}
        assert shard_sizes == {64 // 8}

    def test_gate_on_local_qubit(self):
        # :165 — X on a low (local) qubit, no comm required
        mesh = make_mesh(8)
        state = sharded_init_state(6, mesh)
        fn = compile_ir(CircuitIR(6, []), sharding=state_sharding(mesh))
        ir = CircuitIR(6)
        ir.add("X", [0])
        fn = compile_ir(ir, sharding=state_sharding(mesh))
        out = fn(state, jnp.zeros((0,), jnp.float32))
        np.testing.assert_allclose(host(out), np.eye(64)[1], atol=1e-7)

    def test_gate_on_global_qubit(self):
        # the case the reference returned NOT_IMPLEMENTED for (GUIDE:58)
        mesh = make_mesh(8)
        state = sharded_init_state(6, mesh)
        ir = CircuitIR(6)
        ir.add("X", [5])  # qubit 5 = device-selecting bit
        fn = compile_ir(ir, sharding=state_sharding(mesh))
        out = fn(state, jnp.zeros((0,), jnp.float32))
        np.testing.assert_allclose(host(out), np.eye(64)[32], atol=1e-7)

    def test_cnot_local_and_global(self):
        # :228 — CNOT with control/target in both local and global regions
        mesh = make_mesh(8)
        for (c, t) in [(0, 1), (0, 5), (5, 0), (4, 5)]:
            state = sharded_init_state(6, mesh)
            ir = CircuitIR(6)
            ir.add("X", [c])
            ir.add("CNOT", [t], controls=[c])
            fn = compile_ir(ir, sharding=state_sharding(mesh))
            out = fn(state, jnp.zeros((0,), jnp.float32))
            np.testing.assert_allclose(
                host(out), np.eye(64)[(1 << c) | (1 << t)], atol=1e-7,
                err_msg=f"c={c} t={t}")

    def test_swap_index_bits_all_cases(self):
        mesh = make_mesh(8)
        rng = np.random.default_rng(0)
        v = rng.normal(size=64) + 1j * rng.normal(size=64)
        v = (v / np.linalg.norm(v)).astype(np.complex64)
        # local-local (0,1), local-global (1,5: Alltoallv analog),
        # global-global (4,5: the reference's NOT_IMPLEMENTED case)
        for (q1, q2) in [(0, 1), (1, 5), (4, 5)]:
            state = shard_state(jnp.asarray(v), mesh)
            out = host(swap_index_bits_sharded(state, q1, q2, mesh))
            expected = np.zeros_like(v)
            for i in range(64):
                b1, b2 = (i >> q1) & 1, (i >> q2) & 1
                j = i & ~((1 << q1) | (1 << q2))
                j |= (b1 << q2) | (b2 << q1)
                expected[j] = v[i]
            np.testing.assert_allclose(out, expected, atol=1e-6,
                                       err_msg=f"q1={q1} q2={q2}")

    def test_sharded_matches_single_device(self):
        """Full random circuit: sharded result == single-device result."""
        mesh = make_mesh(8)
        n = 7
        ops = CircuitIR(n)
        rng = np.random.default_rng(42)
        for _ in range(25):
            kind = rng.integers(0, 4)
            q = int(rng.integers(0, n))
            q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
            if kind == 0:
                ops.add("H", [q])
            elif kind == 1:
                ops.add("RY", [q], params=[float(rng.normal())])
            elif kind == 2:
                ops.add("CNOT", [q2], controls=[q])
            else:
                ops.add("CRZ", [q2], params=[float(rng.normal())], controls=[q])
        zero = jnp.zeros((0,), jnp.float32)
        single = compile_ir(ops, donate=False)(sv.init_state(n), zero)
        sharded = compile_ir(ops, sharding=state_sharding(mesh), donate=False)(
            sharded_init_state(n, mesh), zero)
        np.testing.assert_allclose(host(sharded), host(single), atol=1e-6)

    def test_distributed_reductions(self):
        """Expectation + sampling on sharded states (rcclAllReduce analog,
        GUIDE:64-78)."""
        mesh = make_mesh(8)
        ir = CircuitIR(6)
        ir.add("H", [0])
        for t in range(1, 6):
            ir.add("CNOT", [t], controls=[0])  # 6-qubit GHZ
        state = sharded_init_state(6, mesh)
        state = compile_ir(ir, sharding=state_sharding(mesh))(
            state, jnp.zeros((0,), jnp.float32))
        assert abs(float(sv.expval_pauli_product_z_jit(
            state, qubits=(0, 5))) - 1.0) < 1e-6
        assert abs(float(sv.expval_pauli_string_jit(
            state, ops=tuple(("X", q) for q in range(6)))) - 1.0) < 1e-6
        shots = np.asarray(sv.sample_jit(state, qubits=tuple(range(6)),
                                         shots=500, key=jax.random.PRNGKey(0)))
        assert set(np.unique(shots)) <= {0, 63}


@requires_multi
class TestShardedCircuitAPI:
    def test_multi_gpu_circuit_flag(self):
        sim = rocq.Simulator()
        c = rocq.Circuit(6, sim, multi_gpu=True)
        c.h(0)
        for t in range(1, 6):
            c.cx(0, t)
        psi = c.get_statevector()
        expected = np.zeros(64, complex)
        expected[0] = expected[63] = 2**-0.5
        np.testing.assert_allclose(psi, expected, atol=1e-6)
        counts = np.bincount(c.sample([0, 1, 2, 3, 4, 5], 400), minlength=64)
        assert counts[0] + counts[63] == 400

    def test_explicit_mesh(self):
        mesh = make_mesh(4)
        sim = rocq.Simulator()
        c = rocq.Circuit(5, sim, mesh=mesh)
        c.h(4)   # global qubit
        c.cx(4, 0)
        psi = c.get_statevector()
        expected = np.zeros(32, complex)
        expected[0] = expected[17] = 2**-0.5
        np.testing.assert_allclose(psi, expected, atol=1e-6)

    def test_mesh_validation(self):
        with pytest.raises(ValueError):
            make_mesh(3)
        with pytest.raises(ValueError):
            make_mesh(100)


@requires_multi
class TestShardedScheduling:
    def test_no_all_gather_in_scheduled_program(self):
        """Gates on device-selecting qubits must lower to all-to-all
        relabels, never all-gathers."""
        import re
        from rocquantum_tpu.compiler.sharded_schedule import (
            schedule_for_sharding)
        from rocquantum_tpu.parallel import num_global_qubits

        mesh = make_mesh(8)
        n = 12
        ir = CircuitIR(n)
        ir.add("H", [n - 1])
        ir.add("CNOT", [0], controls=[n - 1])
        ir.add("RY", [n - 2], params=[0.3])
        ops, layout = schedule_for_sharding(ir.ops, n,
                                            num_global_qubits(mesh))
        sched = CircuitIR(n, ops)
        fn = compile_ir(sched, sharding=state_sharding(mesh), donate=False)
        lowered = jax.jit(lambda s, p: fn(s, p)).lower(
            jax.ShapeDtypeStruct((1 << n,), jnp.complex64,
                                 sharding=state_sharding(mesh)),
            jax.ShapeDtypeStruct((1,), jnp.float32))
        txt = lowered.compile().as_text()
        assert len(re.findall("all-gather", txt)) == 0, "all-gather leaked in"
        assert len(re.findall("all-to-all", txt)) > 0

    def test_scheduled_circuit_matches_unscheduled(self):
        """Sharded Circuit with layout scheduling == plain single-device
        run, across gates on global qubits, measurement, and readback."""
        mesh = make_mesh(8)
        n = 7

        def build(mesh_arg):
            sim = rocq.Simulator(seed=3)
            c = rocq.Circuit(n, sim, mesh=mesh_arg)
            c.h(n - 1)
            c.cx(n - 1, 0)
            c.ry(0.7, n - 2)
            c.cz(n - 2, 1)
            c.swap(0, n - 1)
            return c

        ref = build(None)
        shd = build(mesh)
        np.testing.assert_allclose(shd.get_statevector(),
                                   ref.get_statevector(), atol=1e-6)
        # expectations through the (possibly permuted) layout
        for term in ("Z0", "Z5 Z6", "X0 X6"):
            assert abs(shd.expval(rocq.PauliOperator(term))
                       - ref.expval(rocq.PauliOperator(term))) < 1e-6
        # sampling addresses logical qubits
        counts = np.bincount(shd.sample(list(range(n)), 300),
                             minlength=1 << n)
        ref_probs = np.abs(ref.get_statevector()) ** 2
        assert set(np.nonzero(counts)[0]) <= set(
            np.nonzero(ref_probs > 1e-9)[0])

    def test_mid_circuit_measure_sharded(self):
        mesh = make_mesh(8)
        sim = rocq.Simulator(seed=1)
        c = rocq.Circuit(6, sim, mesh=mesh)
        c.h(5)
        c.cx(5, 0)
        m, p = c.measure(5)   # global qubit measurement
        assert abs(p - 0.5) < 1e-6
        out = c.sample([0, 5], 100)
        assert set(np.unique(out)) == ({0} if m == 0 else {3})

    def test_get_expval_through_layout(self):
        """rocq.get_expval on a sharded program must respect the physical
        qubit layout left by scheduling."""
        mesh = make_mesh(8)
        sim = rocq.Simulator(seed=2)

        @rocq.kernel
        def k(q):
            q.h(6)          # global qubit -> forces a relabel
            q.cx(6, 0)

        prog = rocq.build(k, 7, sim)
        prog.circuit_ref.mesh = None  # plain reference run
        ref = rocq.Circuit(7, rocq.Simulator())
        kf = getattr(k, "__wrapped__", k)
        kf(ref)
        c = rocq.Circuit(7, sim, mesh=mesh)
        kf(c)
        c.flush()
        prog2 = rocq.QuantumProgram("t", 7)
        prog2.circuit_ref = c
        for term in ("Z0 Z6", "X0 X6", "Z6"):
            assert abs(rocq.get_expval(prog2, rocq.PauliOperator(term))
                       - ref.expval(rocq.PauliOperator(term))) < 1e-6


class TestShardedPallas:
    def test_sharded_pallas_block_matches_dense(self):
        """Local-qubit RY column + CNOT chain on a state sharded over the
        8-device mesh matches a dense numpy reference."""
        import _np_ref
        import jax
        import jax.numpy as jnp
        from rocquantum_tpu.compiler.interpreter import execute
        from rocquantum_tpu.compiler.ir import CircuitIR, ParamRef
        from rocquantum_tpu.parallel.mesh import make_mesh
        from rocquantum_tpu.parallel.sharded import (sharded_init_state,
                                                     state_sharding)

        n = 18
        mesh = make_mesh(8)
        sharding = state_sharding(mesh)
        ir = CircuitIR(n)
        for q in range(12):
            ir.add("RY", [q], params=[ParamRef(q)])
        for q in range(11):
            ir.add("CNOT", [q + 1], controls=[q])
        params = jnp.linspace(0.1, 1.2, 12).astype(jnp.float32)

        state = sharded_init_state(n, mesh)
        out = jax.jit(
            lambda s, p: execute(s, ir.ops, p, sharding=sharding),
            donate_argnums=(0,))(state, params)

        ref = _np_ref.run(n, [("RY", [q], [], [float(params[q])])
                              for q in range(12)]
                          + [("CNOT", [q + 1], [q], []) for q in range(11)])
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)

    def test_sharded_pallas_lowers_without_collectives_for_local_gates(
            self):
        import jax
        import jax.numpy as jnp
        from rocquantum_tpu.compiler.interpreter import execute
        from rocquantum_tpu.compiler.ir import CircuitIR, ParamRef
        from rocquantum_tpu.parallel.mesh import make_mesh
        from rocquantum_tpu.parallel.sharded import (sharded_init_state,
                                                     state_sharding)

        n = 18
        mesh = make_mesh(8)
        sharding = state_sharding(mesh)
        ir = CircuitIR(n)
        for q in range(10):
            ir.add("RY", [q], params=[ParamRef(q)])
        params = jnp.linspace(0.1, 1.0, 10).astype(jnp.float32)
        state = sharded_init_state(n, mesh)
        lowered = jax.jit(
            lambda s, p: execute(s, ir.ops, p, sharding=sharding)).lower(
                state, params)
        hlo = lowered.compile().as_text()
        assert "all-gather" not in hlo and "all-to-all" not in hlo


class TestMultiSliceMesh:
    """Multi-slice (DCN x NVLink) deployment shape: the amplitude axis spans
    both mesh axes; the sharded scheduler treats all device-selecting bits
    uniformly (the reference left cluster scaling as roadmap,
    ROADMAP.md:28)."""

    def test_multislice_circuit_matches_single_device(self):
        import rocquantum_tpu as rocq
        from rocquantum_tpu.parallel.mesh import make_mesh_multislice
        from rocquantum_tpu.parallel.sharded import num_global_qubits

        mesh = make_mesh_multislice(2, 4)
        assert num_global_qubits(mesh) == 3
        n = 6
        sim = rocq.Simulator()
        c = rocq.Circuit(n, sim, mesh=mesh)
        c.h(0)
        for q in range(n - 1):
            c.cx(q, q + 1)
        c.ry(0.7, n - 1)       # gate on a slice-selecting qubit
        c.h(n - 2)
        got = c.get_statevector()
        ref = rocq.Circuit(n, rocq.Simulator())
        ref.h(0)
        for q in range(n - 1):
            ref.cx(q, q + 1)
        ref.ry(0.7, n - 1)
        ref.h(n - 2)
        np.testing.assert_allclose(got, ref.get_statevector(), atol=1e-6)

    def test_multislice_state_is_sharded_over_both_axes(self):
        import jax
        from rocquantum_tpu.parallel.mesh import make_mesh_multislice
        from rocquantum_tpu.parallel.sharded import sharded_init_state

        mesh = make_mesh_multislice(2, 4)
        state = sharded_init_state(8, mesh)
        shard_sizes = {s.data.shape for s in state.addressable_shards}
        assert shard_sizes == {(256 // 8,)}


class TestDiagonalGatesCommFree:
    """Diagonal gates (CZ/CRZ/RZZ/phases) on device-selecting qubits apply
    elementwise in place — the scheduler emits NO relabels for them and the
    compiled program contains NO collectives (the reference required an
    index-bit swap for every non-local gate, MULTI_GPU_GUIDE.md:58-59)."""

    def test_global_diagonals_lower_with_no_collectives(self):
        import re
        from rocquantum_tpu.compiler.sharded_schedule import (
            SWAP_BITS, schedule_for_sharding)
        from rocquantum_tpu.parallel import num_global_qubits

        mesh = make_mesh(8)
        n = 12
        ir = CircuitIR(n)
        ir.add("CZ", [0], controls=[n - 1])         # global control
        ir.add("RZZ", [n - 1, n - 2], params=[0.7])  # both global
        ir.add("RZ", [n - 3], params=[0.4])          # global 1q diag
        ir.add("CRZ", [n - 2], controls=[2], params=[0.3])
        ops, layout = schedule_for_sharding(ir.ops, n,
                                            num_global_qubits(mesh))
        assert not any(op.name == SWAP_BITS for op in ops)
        assert layout == list(range(n))
        sched = CircuitIR(n, ops)
        fn = compile_ir(sched, sharding=state_sharding(mesh), donate=False)
        lowered = jax.jit(lambda s, p: fn(s, p)).lower(
            jax.ShapeDtypeStruct((1 << n,), jnp.complex64,
                                 sharding=state_sharding(mesh)),
            jax.ShapeDtypeStruct((1,), jnp.float32))
        txt = lowered.compile().as_text()
        assert len(re.findall("all-gather", txt)) == 0
        assert len(re.findall("all-to-all", txt)) == 0

    def test_global_diagonal_circuit_matches_single_device(self):
        mesh = make_mesh(8)
        n = 7

        def build(mesh_arg):
            sim = rocq.Simulator(seed=5)
            c = rocq.Circuit(n, sim, mesh=mesh_arg)
            for q in range(n):
                c.h(q)
            c.cz(n - 1, 0)
            c.rzz(0.9, n - 1, n - 2)
            c.rz(0.4, n - 3)
            c.crz(0.3, 2, n - 2)
            c.ry(0.5, 1)
            return c

        ref = build(None)
        shd = build(mesh)
        np.testing.assert_allclose(shd.get_statevector(),
                                   ref.get_statevector(), atol=1e-6)


@requires_multi
class TestShardedCircuitFuzz:
    """Randomized equivalence across flush boundaries: the sharded Circuit
    (scheduler, relabels, layout-aware measurement/expectation/readback)
    must track the single-device run gate-for-gate, with interleaved
    flushes, measurements, and probability reads."""

    GATES_1Q = ["H", "X", "Y", "Z", "S", "T"]

    def _drive(self, c, rng, n, depth):
        """Apply a seeded random program; deterministic across the sharded
        and unsharded builds (same rng seed, same Simulator seed — measure
        draws use the same host RNG stream)."""
        readouts = []
        for step in range(depth):
            kind = rng.integers(0, 8)
            q = int(rng.integers(0, n))
            q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
            if kind == 0:
                getattr(c, str(rng.choice(self.GATES_1Q)).lower())(q)
            elif kind == 1:
                c.ry(float(rng.normal()), q)
            elif kind == 2:
                c.cx(q, q2)
            elif kind == 3:
                c.cz(q, q2)
            elif kind == 4:
                c.swap(q, q2)
            elif kind == 5:
                c.rzz(float(rng.normal()), q, q2)
            elif kind == 6:
                c.flush()
            else:
                # mid-circuit measurement: same host RNG stream on both
                # builds -> identical outcomes, so states stay comparable
                out, p = c.measure(q)
                readouts.append((step, out, round(p, 9)))
        return readouts

    @pytest.mark.parametrize("seed", range(4))
    def test_random_circuits_match_single_device(self, seed):
        mesh = make_mesh(8)
        n = 8
        rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
        ca = rocq.Circuit(n, rocq.Simulator(seed=seed), mesh=mesh)
        cb = rocq.Circuit(n, rocq.Simulator(seed=seed))
        ra = self._drive(ca, rng_a, n, depth=25)
        rb = self._drive(cb, rng_b, n, depth=25)
        assert [x[:2] for x in ra] == [x[:2] for x in rb]
        for (_, _, pa), (_, _, pb) in zip(ra, rb):
            assert abs(pa - pb) < 1e-5
        np.testing.assert_allclose(ca.get_statevector(),
                                   cb.get_statevector(), atol=2e-5,
                                   err_msg=f"seed={seed}")
        np.testing.assert_allclose(ca.get_probabilities([0, n - 1]),
                                   cb.get_probabilities([0, n - 1]),
                                   atol=2e-5)

    def test_sharded_df64_matches_unsharded(self, monkeypatch):
        """Sharded df64: the double-float engine covers sharded circuits
        too — the engine-global precision-switch parity of the reference
        (hipStateVec.h:7-15). The sharded flush tracks the unsharded df64
        run to df64 accuracy, state stays the exact-f64 pair over the
        mesh."""
        from rocquantum_tpu import config
        old = config.get_precision()
        config.set_precision("df64")
        try:
            mesh = make_mesh(8)
            n = 8

            def drive(c):
                c.h(n - 1)              # global qubit -> relabel
                c.cx(n - 1, 0)          # global control
                c.rz(0.4, n - 1)        # global diagonal: comm-free
                c.ry(0.7, n - 2)
                c.cz(n - 2, 1)
                c.flush()
                return c

            ca = drive(rocq.Circuit(n, rocq.Simulator(seed=3), mesh=mesh))
            cb = drive(rocq.Circuit(n, rocq.Simulator(seed=3)))
            assert ca._use_df64() and cb._use_df64()
            assert isinstance(ca._state, tuple)
            assert ca._state[0].dtype == jnp.float64
            assert len(ca._state[0].sharding.device_set) == 8
            np.testing.assert_allclose(ca.get_statevector(),
                                       cb.get_statevector(), atol=1e-12)
        finally:
            config.set_precision(old)

    def test_sharded_df64_pallas_blocks(self):
        """Sharded df64 on an RY column + CNOT layer whose gates are all
        local: the result matches a dense numpy reference to df64
        accuracy."""
        import _np_ref
        from rocquantum_tpu import config
        old = config.get_precision()
        config.set_precision("df64")
        try:
            mesh = make_mesh(8)
            n = 10

            def drive(c):
                for q in range(n):
                    c.ry(0.1 + 0.03 * q, q)
                for q in range(0, n - 1, 2):
                    c.cx(q, q + 1)
                c.rz(0.21, n - 1)
                c.flush()
                return c

            ca = drive(rocq.Circuit(n, rocq.Simulator(seed=4), mesh=mesh))
            assert ca._use_df64()
            assert len(ca._state[0].sharding.device_set) == 8
            ref = _np_ref.run(n, [("RY", [q], [], [0.1 + 0.03 * q])
                                  for q in range(n)]
                              + [("CNOT", [q + 1], [q], [])
                                 for q in range(0, n - 1, 2)]
                              + [("RZ", [n - 1], [], [0.21])])
            np.testing.assert_allclose(ca.get_statevector(), ref,
                                       atol=1e-11)
        finally:
            config.set_precision(old)

    @pytest.mark.parametrize("seed", [10, 11])
    def test_random_circuits_match_fp64_pair(self, seed):
        """Same fuzz at double precision: the sharded PAIR engine tracks
        the unsharded pair run to f64 tolerance."""
        from rocquantum_tpu import config
        old = config.get_precision()
        config.set_precision("double")
        try:
            mesh = make_mesh(8)
            n = 8
            rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
            ca = rocq.Circuit(n, rocq.Simulator(seed=seed), mesh=mesh)
            cb = rocq.Circuit(n, rocq.Simulator(seed=seed))
            ra = self._drive(ca, rng_a, n, depth=20)
            rb = self._drive(cb, rng_b, n, depth=20)
            assert isinstance(ca._state, tuple) and isinstance(cb._state,
                                                               tuple)
            assert [x[:2] for x in ra] == [x[:2] for x in rb]
            np.testing.assert_allclose(ca.get_statevector(),
                                       cb.get_statevector(), atol=1e-12,
                                       err_msg=f"seed={seed}")
        finally:
            config.set_precision(old)


@requires_multi
def test_collective_counts_pinned():
    """EXACT communication budget for canonical sharded workloads: a
    scheduler regression that doubles collectives
    changes these counts without failing any numeric test — so the counts
    themselves are the test. Budgets (measured from compiled HLO, also
    asserted by __graft_entry__.dryrun_multichip; the r5 prefetch-batching
    scheduler localizes ALL soon-needed global qubits in one PERMUTE_BITS
    transpose — the per-qubit SWAP_BITS schedule cost one transpose per
    demand):
      * H(global)+CNOT(global->0)+RY: both demanded globals batch into
        ONE relabel = 1 all-to-all, nothing else;
      * global diagonals (CZ, RZ): ZERO collectives;
      * one RY-column+CNOT-ring ansatz layer: 3 global qubits = one
        batched relabel = 2 all-to-alls + 1 collective-permute (was 6
        all-to-alls / 3 full-state transposes before batching)."""
    import re  # noqa: F401
    from rocquantum_tpu.compiler.sharded_schedule import schedule_for_sharding
    from rocquantum_tpu.parallel import count_collectives

    n = 12
    mesh = make_mesh(8)

    def counts_of(ir):
        ops, _ = schedule_for_sharding(ir.ops, n, num_global_qubits(mesh))
        fn = compile_ir(CircuitIR(n, ops), sharding=state_sharding(mesh),
                        donate=False)
        n_params = sum(len(op.params) for op in ir.ops)
        txt = jax.jit(lambda s, p: fn(s, p)).lower(
            jax.ShapeDtypeStruct((1 << n,), jnp.complex64,
                                 sharding=state_sharding(mesh)),
            jax.ShapeDtypeStruct((max(n_params, 1),), jnp.float32)
        ).compile().as_text()
        return count_collectives(txt)

    canonical = CircuitIR(n)
    canonical.add("H", [n - 1])
    canonical.add("CNOT", [0], controls=[n - 1])
    canonical.add("RY", [n - 2], params=[0.3])
    assert counts_of(canonical) == {
        "all-to-all": 1, "all-gather": 0, "all-reduce": 0,
        "collective-permute": 0, "reduce-scatter": 0}

    diag = CircuitIR(n)
    diag.add("CZ", [0, n - 1])
    diag.add("RZ", [n - 1], params=[0.4])
    assert all(v == 0 for v in counts_of(diag).values())

    ansatz = CircuitIR(n)
    for q in range(n):
        ansatz.add("RY", [q], params=[0.1 * (q + 1)])
    for q in range(n):
        ansatz.add("CNOT", [(q + 1) % n], controls=[q])
    acc = counts_of(ansatz)
    assert acc == {
        "all-to-all": 2, "all-gather": 0, "all-reduce": 0,
        "collective-permute": 1, "reduce-scatter": 0}, acc


@requires_multi
@pytest.mark.parametrize("targets,controls", [
    ([0], []), ([6], []), ([0, 8], []), ([3], [8]), ([1, 5], [])])
def test_flip_select_stays_shard_local(targets, controls):
    """A low-qubit gate on a sharded state takes the flip-select path with
    no collective at all (a flat roll there wraps across shard edges and
    becomes a collective-permute) and matches the dense reference."""
    import _np_ref
    from rocquantum_tpu.parallel import count_collectives

    n = 12
    sharding = state_sharding(make_mesh(8))
    rng = np.random.default_rng(len(targets) * 10 + targets[0])
    m = len(targets)
    u, _ = np.linalg.qr(rng.normal(size=(1 << m, 1 << m))
                        + 1j * rng.normal(size=(1 << m, 1 << m)))
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v = (v / np.linalg.norm(v)).astype(np.complex64)
    fn = jax.jit(lambda s: sv.apply_controlled_matrix(
        s, jnp.asarray(u, jnp.complex64), controls, targets),
        in_shardings=sharding, out_shardings=sharding)
    state = shard_state(jnp.asarray(v), make_mesh(8))
    txt = fn.lower(state).compile().as_text()
    assert all(c == 0 for c in count_collectives(txt).values())
    ref = _np_ref.apply(v.astype(complex), u, targets, controls)
    np.testing.assert_allclose(host(fn(state)), ref, atol=1e-5)


def test_north_star_n32_sharded_compiles():
    """The 32-qubit statevector sharded over an 8-device mesh. What IS
    checkable on the CPU is the full contract: the scheduled flush program at n=32 compiles
    over the mesh with per-shard 2^29 buffers, relabels lowered to
    all-to-all and ZERO all-gathers."""
    import re
    import jax
    import jax.numpy as jnp
    from rocquantum_tpu.compiler.ir import CircuitIR
    from rocquantum_tpu.compiler.interpreter import compile_ir
    from rocquantum_tpu.compiler.sharded_schedule import schedule_for_sharding
    from rocquantum_tpu.parallel import (make_mesh, num_global_qubits,
                                         state_sharding)

    n = 32
    mesh = make_mesh(8)
    ir = CircuitIR(n)
    ir.add("H", [n - 1])                  # global qubit -> relabel
    ir.add("CNOT", [0], controls=[n - 1])
    ir.add("RZ", [n - 1], params=[0.4])   # global diagonal: comm-free
    ir.add("RY", [5], params=[0.3])
    ops, _ = schedule_for_sharding(ir.ops, n, num_global_qubits(mesh))
    fn = compile_ir(CircuitIR(n, ops), sharding=state_sharding(mesh),
                    donate=False)
    txt = jax.jit(lambda s, p: fn(s, p)).lower(
        jax.ShapeDtypeStruct((1 << n,), jnp.complex64,
                             sharding=state_sharding(mesh)),
        jax.ShapeDtypeStruct((1,), jnp.float32)).compile().as_text()
    assert re.findall("all-to-all", txt)
    assert not re.findall("all-gather", txt)
    assert "536870912" in txt  # 2^29 per-shard amplitudes


def test_permute_index_bits_matches_swap_chain():
    """sv.permute_index_bits == the equivalent SWAP_BITS chain, including
    non-involution permutations (3-cycles) and the adjoint convention."""
    rng = np.random.default_rng(0)
    n = 6
    v = rng.normal(size=(1 << n,)).astype(np.complex64)
    v = v / np.linalg.norm(v)
    s = jnp.asarray(v.real) + 0j  # complex on CPU is fine

    def via_swaps(state, swaps):
        for a, b in swaps:
            state = sv.swap_index_bits(state, a, b, use_transpose=True)
        return state

    # compose swaps (1,4), (4,5): a 3-cycle
    swaps = [(1, 4), (4, 5)]
    cur = {b: b for b in range(n)}
    for a, b in swaps:
        cur[a], cur[b] = cur[b], cur[a]
    dsts = tuple(p for p in range(n) if cur[p] != p)
    srcs = tuple(cur[p] for p in dsts)
    st = jnp.asarray(v)
    ref = np.asarray(via_swaps(st, swaps))
    out = np.asarray(sv.permute_index_bits(st, dsts, srcs))
    np.testing.assert_allclose(out, ref, atol=0)
    # inverse permutation restores
    back = np.asarray(sv.permute_index_bits(jnp.asarray(out), srcs, dsts))
    np.testing.assert_allclose(back, v, atol=0)


@requires_multi
def test_scheduler_prefetch_batches_relabels():
    """The prefetch-batching scheduler emits ONE PERMUTE_BITS for a
    column of gates over the global region (was one SWAP_BITS each), and
    the scheduled stream still matches the unscheduled circuit."""
    from rocquantum_tpu.compiler.sharded_schedule import (
        schedule_for_sharding)

    n = 12
    mesh = make_mesh(8)
    ir = CircuitIR(n)
    for q in range(n):
        ir.add("RY", [q], params=[0.05 * (q + 1)])
    ops, _ = schedule_for_sharding(ir.ops, n, num_global_qubits(mesh))
    names = [op.name for op in ops]
    assert names.count("PERMUTE_BITS") == 1, names
    assert names.count("SWAP_BITS") == 0, names
    perm = next(op for op in ops if op.name == "PERMUTE_BITS")
    assert len(perm.targets) == 6  # 3 swap pairs batched

    # numeric equivalence through the sharded Circuit
    ca = rocq.Circuit(n, rocq.Simulator(seed=1), mesh=mesh)
    cb = rocq.Circuit(n, rocq.Simulator(seed=1))
    for c in (ca, cb):
        for q in range(n):
            c.ry(0.05 * (q + 1), q)
        c.cx(n - 1, 0)
        c.flush()
    np.testing.assert_allclose(ca.get_statevector(), cb.get_statevector(),
                               atol=2e-6)
