"""Float-pair (fp64-safe) simulation path: equivalence vs the complex
engine, and pair-mode adjoint gradients (the chemistry-accuracy path of
the double-precision engine — see ops/pairsim.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import rocquantum_tpu as rocq
from rocquantum_tpu import config
from rocquantum_tpu.compiler.ir import CircuitIR
from rocquantum_tpu.compiler.interpreter import execute
from rocquantum_tpu.ops import pairsim
from rocquantum_tpu.ops import statevec as sv


@pytest.fixture
def double_precision():
    old = config.get_precision()
    config.set_precision("double")
    yield
    config.set_precision(old)


def _random_ir(n, rng, depth=30):
    ir = CircuitIR(n)
    for _ in range(depth):
        kind = rng.integers(0, 6)
        q = int(rng.integers(0, n))
        q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
        if kind == 0:
            ir.add(str(rng.choice(["H", "X", "Y", "Z", "S", "T"])), [q])
        elif kind == 1:
            ir.add(str(rng.choice(["RX", "RY", "RZ", "P"])), [q],
                   params=[float(rng.normal())])
        elif kind == 2:
            ir.add("CNOT", [q2], controls=[q])
        elif kind == 3:
            ir.add("U3", [q], params=[float(rng.normal()),
                                      float(rng.normal()),
                                      float(rng.normal())])
        elif kind == 4:
            ir.add("RZZ", [q, q2], params=[float(rng.normal())])
        else:
            ir.add("RY", [q2], controls=[q], params=[float(rng.normal())])
    return ir


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_matches_complex_engine(seed, double_precision):
    n = 5
    rng = np.random.default_rng(seed)
    ir = _random_ir(n, rng)

    state = jax.jit(lambda: execute(sv.init_state(n), list(ir.ops), None))()
    re, im = pairsim.init_pair(n)

    def run_pair(re, im):
        for op in ir.ops:
            re, im = pairsim.apply_op_pair(re, im, op)
        return re, im

    re, im = jax.jit(run_pair)(re, im)
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(got, np.asarray(state), atol=1e-12)


def test_pair_adjoint_ops(double_precision):
    from rocquantum_tpu.compiler.ir import GateOp
    n = 3
    rng = np.random.default_rng(3)
    fwd = [GateOp("U3", (0,), (), (0.3, 0.7, 0.2)),
           GateOp("RZ", (1,), (2,), (0.5,)),
           GateOp("S", (2,))]
    re, im = pairsim.init_pair(n)
    re, im = jax.jit(lambda r, i: pairsim.apply_op_pair(
        *pairsim.apply_op_pair(r, i, fwd[0]), fwd[1]))(re, im)
    # apply op then its adjoint: identity
    for op in fwd:
        adj = GateOp(op.name, op.targets, op.controls, op.params,
                     op.matrix, is_adjoint=True)
        r2, i2 = jax.jit(lambda r, i: pairsim.apply_op_pair(
            *pairsim.apply_op_pair(r, i, op), adj))(re, im)
        np.testing.assert_allclose(np.asarray(r2), np.asarray(re),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(i2), np.asarray(im),
                                   atol=1e-12)


def test_pair_expectations_match(double_precision):
    n = 4
    rng = np.random.default_rng(7)
    ir = _random_ir(n, rng, depth=20)
    state = jax.jit(lambda: execute(sv.init_state(n), list(ir.ops), None))()

    def run_pair():
        re, im = pairsim.init_pair(n)
        for op in ir.ops:
            re, im = pairsim.apply_op_pair(re, im, op)
        return re, im

    re, im = jax.jit(run_pair)()
    for string in ([("Z", 0)], [("Z", 0), ("Z", 2)], [("X", 1)],
                   [("Y", 2)], [("X", 0), ("Y", 1), ("Z", 3)]):
        want = float(sv.expval_pauli_string(state, string))
        got = float(jax.jit(lambda r, i: pairsim.expval_pauli_string_pair(
            r, i, string))(re, im))
        assert abs(want - got) < 1e-12, (string, want, got)


class TestPairCircuit:
    """fp64 Circuits run the pair engine end to end (flush, measurement,
    sampling, readback) — the double-precision path (see
    ops/pairsim.py)."""

    def _make(self, seed=3):
        sim = rocq.Simulator(seed=seed)
        c = rocq.Circuit(3, sim)
        c.h(0)
        c.cx(0, 1)
        c.rz(0.3, 2)
        c.ry(1.1, 1)
        c.swap(1, 2)
        return c

    def test_flush_runs_pair_engine(self, double_precision):
        c = self._make()
        psi = c.get_statevector()
        assert isinstance(c._state, tuple)
        assert c._state[0].dtype == jnp.float64
        assert psi.dtype == np.complex128
        # reference: same ops through the complex engine (fine on CPU)
        ops = [("H", [0], [], []), ("CNOT", [1], [0], []),
               ("RZ", [2], [], [0.3]), ("RY", [1], [], [1.1]),
               ("SWAP", [1, 2], [], [])]
        ir = CircuitIR(3)
        for name, tg, ct, ps in ops:
            ir.add(name, tg, controls=ct, params=ps)
        want = jax.jit(lambda: execute(sv.init_state(3), list(ir.ops), None))()
        np.testing.assert_allclose(psi, np.asarray(want), atol=1e-12)

    def test_measure_collapse_and_sample(self, double_precision):
        sim = rocq.Simulator(seed=0)
        c = rocq.Circuit(2, sim)
        c.h(0)
        c.cx(0, 1)
        outcome, prob = c.measure(0)
        assert outcome in (0, 1)
        assert abs(prob - 0.5) < 1e-12
        # Bell state collapsed: qubit 1 must equal qubit 0 in every shot
        shots = c.sample([0, 1], 64)
        assert set(np.asarray(shots).tolist()) == {0 if outcome == 0 else 3}
        probs = c.get_probabilities()
        want = np.zeros(4)
        want[outcome * 3] = 1.0
        np.testing.assert_allclose(probs, want, atol=1e-12)

    def test_expval_and_slice(self, double_precision):
        c = self._make()
        h = rocq.PauliOperator({"Z0": 0.7, "X0 X1": 0.25, "Y1 Z2": -0.4,
                                "I": 0.1})
        ev = c.expval(h)
        psi = c.get_statevector()
        # dense reference on host
        import functools
        Ms = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
              "Y": np.array([[0, -1j], [1j, 0]]),
              "Z": np.diag([1.0, -1.0])}
        def dense(string):
            chars = ["I"] * 3
            for p, q in string:
                chars[q] = p
            # qubit 0 = LSB -> rightmost kron factor
            return functools.reduce(np.kron,
                                    [Ms[ch] for ch in reversed(chars)])
        want = 0.0
        for string, coeff in h.terms:
            want += coeff * np.real(psi.conj() @ dense(string) @ psi)
        assert abs(ev - want) < 1e-12
        sl = c.get_statevector_slice(2, 4)
        np.testing.assert_allclose(sl, psi[2:6], atol=1e-15)

    def test_checkpoint_roundtrip(self, double_precision, tmp_path):
        from rocquantum_tpu.utils.checkpoint import (
            restore_circuit_checkpoint, save_circuit_checkpoint)
        c = self._make()
        psi = c.get_statevector()
        path = str(tmp_path / "pair_ckpt.npz")
        save_circuit_checkpoint(path, c)
        c2 = rocq.Circuit(3, rocq.Simulator(seed=9))
        restore_circuit_checkpoint(path, c2)
        assert isinstance(c2._state, tuple)
        np.testing.assert_allclose(c2.get_statevector(), psi, atol=1e-15)

    def test_single_precision_unaffected(self):
        assert config.get_precision() == "single"
        sim = rocq.Simulator(seed=1)
        c = rocq.Circuit(2, sim)
        c.h(0)
        c.cx(0, 1)
        c.flush()
        assert not isinstance(c._state, tuple)
        psi = c.get_statevector()
        assert abs(abs(psi[0]) - 2 ** -0.5) < 1e-6


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_pair_full_alphabet_fuzz(seed, double_precision):
    """Wider-alphabet equivalence at n=7: SWAP/CSWAP/MCX/dense
    matrices/adjoints + interleaved collapse, pair engine vs complex
    engine at f64 tolerance."""
    from rocquantum_tpu.compiler.ir import GateOp
    n = 7
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(35):
        kind = rng.integers(0, 8)
        qs = rng.permutation(n)
        q, q2, q3 = int(qs[0]), int(qs[1]), int(qs[2])
        adj = bool(rng.integers(0, 2))
        if kind == 0:
            ops.append(GateOp(str(rng.choice(["H", "X", "Y", "Z", "S",
                                              "T", "SDG", "TDG"])), (q,),
                              (), (), None, adj))
        elif kind == 1:
            ops.append(GateOp(str(rng.choice(["RX", "RY", "RZ", "P"])),
                              (q,), (), (float(rng.normal()),), None, adj))
        elif kind == 2:
            ops.append(GateOp("SWAP", (q, q2)))
        elif kind == 3:
            ops.append(GateOp("CSWAP", (q2, q3), (q,)))
        elif kind == 4:
            ops.append(GateOp("X", (q,), (q2, q3)))  # toffoli-style MCX
        elif kind == 5:
            # random dense 1q unitary (QR of a complex gaussian)
            a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            u, _ = np.linalg.qr(a)
            ops.append(GateOp("UNITARY", (q,), (), (), u, adj))
        elif kind == 6:
            ops.append(GateOp("RZZ", (q, q2), (),
                              (float(rng.normal()),), None, adj))
        else:
            ops.append(GateOp("RY", (q2,), (q,),
                              (float(rng.normal()),), None, adj))

    def run_complex():
        s = sv.init_state(n)
        from rocquantum_tpu.compiler.interpreter import apply_op
        for op in ops:
            s = apply_op(s, op, None)
        return s

    def run_pair():
        re, im = pairsim.init_pair(n)
        for op in ops:
            re, im = pairsim.apply_op_pair(re, im, op)
        return re, im

    want = np.asarray(jax.jit(run_complex)())
    re, im = jax.jit(run_pair)()
    np.testing.assert_allclose(np.asarray(re) + 1j * np.asarray(im), want,
                               atol=1e-12, err_msg=f"seed={seed}")
    # collapse equivalence on a fixed outcome
    q = int(seed % n)
    want_c = np.asarray(jax.jit(
        lambda: sv.collapse(run_complex(), q, 1))())
    re2, im2 = jax.jit(
        lambda: pairsim.collapse_pair(*run_pair(), q, 1))()
    np.testing.assert_allclose(np.asarray(re2) + 1j * np.asarray(im2),
                               want_c, atol=1e-11)


requires_multi = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@requires_multi
class TestShardedPairCircuit:
    """fp64 pair circuits over a device mesh: both parts sharded over 'sv',
    relabels as all-to-all transposes, diagonals comm-free — the sharded
    statevector semantics (MULTI_GPU_GUIDE.md:44-78) at chemistry
    accuracy."""

    def _build(self, mesh, n=9):
        sim = rocq.Simulator(seed=0)
        c = rocq.Circuit(n, sim, mesh=mesh)
        c.h(n - 1)              # global qubit -> relabel
        c.cx(n - 1, 0)          # global control, local target
        c.ry(0.4, n - 2)        # global target
        c.rz(0.7, n - 1)        # diagonal on a global qubit: comm-free
        c.swap(1, n - 1)        # cross local<->global swap
        for q in range(n):
            c.ry(0.05 * (q + 1), q)
        return c

    def test_matches_unsharded_pair_run(self, double_precision):
        from rocquantum_tpu.parallel import make_mesh
        n = 9
        c_sh = self._build(make_mesh(8), n)
        c_un = self._build(None, n)
        psi_sh = c_sh.get_statevector()
        assert isinstance(c_sh._state, tuple)
        assert c_sh._state[0].dtype == jnp.float64
        assert len(c_sh._state[0].sharding.device_set) == 8
        np.testing.assert_allclose(psi_sh, c_un.get_statevector(),
                                   atol=1e-12)
        h = rocq.PauliOperator({"Z0": 0.5, f"Z{n-1}": -0.3,
                                "X1 X2": 0.25, "I": 0.1})
        assert abs(c_sh.expval(h) - c_un.expval(h)) < 1e-12

    def test_measure_and_sample_sharded(self, double_precision):
        from rocquantum_tpu.parallel import make_mesh
        mesh = make_mesh(8)
        n = 8
        sim = rocq.Simulator(seed=0)
        c = rocq.Circuit(n, sim, mesh=mesh)
        c.h(n - 1)
        c.cx(n - 1, 0)
        outcome, prob = c.measure(n - 1)   # global-qubit measurement
        assert abs(prob - 0.5) < 1e-12
        shots = c.sample([0, n - 1], 32)
        want = 0 if outcome == 0 else 3
        assert set(np.asarray(shots).tolist()) == {want}

    def test_pair_relabels_lower_to_all_to_all(self, double_precision):
        """The compiled sharded pair program must relabel via all-to-all,
        never all-gather (the partitioner's fallback)."""
        import re as _re
        from rocquantum_tpu.compiler.sharded_schedule import (
            schedule_for_sharding)
        from rocquantum_tpu.parallel import (make_mesh, num_global_qubits,
                                             state_sharding)
        mesh = make_mesh(8)
        n = 12
        ir = CircuitIR(n)
        ir.add("H", [n - 1])
        ir.add("CNOT", [0], controls=[n - 1])
        ir.add("RY", [n - 2], params=[0.3])
        ops, _ = schedule_for_sharding(ir.ops, n, num_global_qubits(mesh))
        sharding = state_sharding(mesh)
        fn = pairsim.compile_pair_ir(CircuitIR(n, ops), sharding=sharding)
        shape = jax.ShapeDtypeStruct((1 << n,), jnp.float64,
                                     sharding=sharding)
        lowered = jax.jit(lambda r, i, p: fn(r, i, p)).lower(
            shape, shape, jax.ShapeDtypeStruct((0,), jnp.float64))
        txt = lowered.compile().as_text()
        assert len(_re.findall("all-gather", txt)) == 0, "all-gather leaked"
        assert len(_re.findall("all-to-all", txt)) > 0

    def test_sharded_pair_checkpoint_roundtrip(self, double_precision,
                                               tmp_path):
        """Restoring an fp64 checkpoint onto a sharded circuit must place
        both parts on the mesh (regression: the pair branch ignored
        circuit.mesh and restored to one device)."""
        from rocquantum_tpu.parallel import make_mesh
        from rocquantum_tpu.utils.checkpoint import (
            restore_circuit_checkpoint, save_circuit_checkpoint)
        mesh = make_mesh(8)
        c = self._build(mesh)
        psi = c.get_statevector()
        path = str(tmp_path / "sharded_pair.npz")
        save_circuit_checkpoint(path, c)
        c2 = rocq.Circuit(9, rocq.Simulator(seed=1), mesh=mesh)
        restore_circuit_checkpoint(path, c2)
        assert isinstance(c2._state, tuple)
        assert len(c2._state[0].sharding.device_set) == 8
        np.testing.assert_allclose(c2.get_statevector(), psi, atol=1e-15)

    def test_global_diagonal_is_comm_free(self, double_precision):
        """An RZ on a device-selecting qubit is pure elementwise pair math:
        zero collectives in the compiled program."""
        from rocquantum_tpu.parallel import make_mesh, state_sharding
        mesh = make_mesh(8)
        n = 10
        ir = CircuitIR(n)
        ir.add("RZ", [n - 1], params=[0.7])
        ir.add("CZ", [n - 2], controls=[n - 1])
        sharding = state_sharding(mesh)
        fn = pairsim.compile_pair_ir(CircuitIR(n, ir.ops),
                                     sharding=sharding)
        shape = jax.ShapeDtypeStruct((1 << n,), jnp.float64,
                                     sharding=sharding)
        lowered = jax.jit(lambda r, i, p: fn(r, i, p)).lower(
            shape, shape, jax.ShapeDtypeStruct((0,), jnp.float64))
        txt = lowered.compile().as_text()
        for coll in ("all-gather", "all-to-all", "all-reduce",
                     "collective-permute"):
            assert coll not in txt, f"{coll} in a diagonal-only program"


def test_energy_fn_pair_mode_gradients(double_precision):
    """make_energy_fn under double precision: the pair program's jax.grad
    matches parameter-shift and the complex-path rocq.grad to 1e-9."""
    h2 = {"I": -0.4804, "Z0": 0.3435, "Z1": -0.4347,
          "Z0 Z1": 0.5716, "X0 X1": 0.0910, "Y0 Y1": 0.0910}

    @rocq.kernel
    def ansatz(q, t0, t1, t2, t3):
        q.ry(t0, 0)
        q.rx(t1, 1)
        q.cx(0, 1)
        q.ry(t2, 0)
        q.rz(t3, 1)

    H = rocq.PauliOperator(h2)
    from rocquantum_tpu.api import make_energy_fn
    energy = make_energy_fn(ansatz, 2, H, 4)
    fn = jax.jit(jax.value_and_grad(energy))
    p = jnp.asarray(np.random.default_rng(0).uniform(0, 6, 4), jnp.float64)
    v, g = fn(p)
    for i in range(4):
        ei = jnp.zeros(4, jnp.float64).at[i].set(np.pi / 2)
        ps = 0.5 * (float(energy(p + ei)) - float(energy(p - ei)))
        assert abs(float(g[i]) - ps) < 1e-9
    gps = rocq.grad(ansatz, 2, rocq.Simulator(), np.asarray(p), H)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gps), atol=1e-9)
