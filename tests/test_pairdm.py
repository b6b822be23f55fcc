"""fp64 float-pair density engine (ops/pairdm.py): equivalence vs the
complex density engine, and the pair-mode DensityMatrixState /
DensityCircuit surfaces (the fp64 open-system path)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import rocquantum_tpu as rocq
from rocquantum_tpu import config
from rocquantum_tpu.compiler.ir import GateOp
from rocquantum_tpu.ops import density as dmops
from rocquantum_tpu.ops import pairdm


@pytest.fixture
def double_precision():
    old = config.get_precision()
    config.set_precision("double")
    yield
    config.set_precision(old)


def _pair_to_mat(re, im, n):
    dim = 1 << n
    return (np.asarray(re).reshape(dim, dim)
            + 1j * np.asarray(im).reshape(dim, dim))


def _complex_rho(ops_and_channels, n):
    """Reference: same program through the complex density engine."""
    def run():
        rho = dmops.init_density(n)
        for item in ops_and_channels:
            if item[0] == "gate":
                _, op = item
                if op.matrix is not None:
                    m = jnp.asarray(op.matrix, rho.dtype)
                    if op.is_adjoint:
                        m = jnp.conj(m).T
                    rho = dmops.apply_matrix_dm(rho, m, list(op.targets))
                else:
                    rho = dmops.apply_gate_dm(
                        rho, op.name, list(op.targets), list(op.controls),
                        list(op.params), adjoint=op.is_adjoint)
            elif item[0] == "kraus":
                _, ks, tgt = item
                rho = dmops.apply_kraus(rho, ks, list(tgt))
            else:
                _, ch, p, tgt = item
                rho = dmops.apply_channel(rho, ch, p, list(tgt))
        return rho
    rho = jax.jit(run)()
    return np.asarray(dmops.to_matrix(rho))


def _pair_rho(ops_and_channels, n):
    def run():
        re, im = pairdm.init_density_pair(n)
        for item in ops_and_channels:
            if item[0] == "gate":
                _, op = item
                re, im = pairdm.apply_op_pair_dm(re, im, op, n)
            elif item[0] == "kraus":
                _, ks, tgt = item
                re, im = pairdm.apply_kraus_pair_dm(re, im, ks, list(tgt), n)
            else:
                _, ch, p, tgt = item
                re, im = pairdm.apply_channel_pair_dm(re, im, ch, p,
                                                      list(tgt), n)
        return re, im
    re, im = jax.jit(run)()
    return _pair_to_mat(re, im, n)


PROGRAM = [
    ("gate", GateOp("H", (0,))),
    ("gate", GateOp("CNOT", (1,), (0,))),
    ("gate", GateOp("RY", (2,), (), (0.7,))),
    ("gate", GateOp("RZ", (0,), (), (-0.4,))),
    ("gate", GateOp("U3", (1,), (), (0.3, 0.9, -0.2))),
    ("gate", GateOp("S", (2,), (), (), None, True)),  # adjoint
    ("channel", "depolarizing", 0.05, (0,)),
    ("channel", "amplitude_damping", 0.1, (1,)),
    ("channel", "phase_flip", 0.2, (2,)),
    ("gate", GateOp("RY", (2,), (1,), (0.25,))),  # controlled-RY
]


def test_pair_dm_matches_complex_engine(double_precision):
    n = 3
    want = _complex_rho(PROGRAM, n)
    got = _pair_rho(PROGRAM, n)
    np.testing.assert_allclose(got, want, atol=1e-12)
    # trace preserved exactly
    assert abs(np.trace(got).real - 1.0) < 1e-12


def test_pair_dm_two_qubit_kraus(double_precision):
    """A 2-qubit Kraus channel (16x16 superoperator rows, m=4)."""
    n = 2
    rng = np.random.default_rng(5)
    # random CPTP-ish pair: normalize sum K†K = I via QR trick
    a = rng.normal(size=(8, 4)) + 1j * rng.normal(size=(8, 4))
    q, _ = np.linalg.qr(a)
    ks = [q[:4], q[4:]]  # K0†K0 + K1†K1 = I
    prog = [("gate", GateOp("H", (0,))),
            ("gate", GateOp("RY", (1,), (), (0.6,))),
            ("kraus", ks, (0, 1))]
    want = _complex_rho(prog, n)
    got = _pair_rho(prog, n)
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert abs(np.trace(got).real - 1.0) < 1e-12


def test_pair_dm_expectations_and_trace(double_precision):
    n = 3
    def run():
        re, im = pairdm.init_density_pair(n)
        for item in PROGRAM:
            if item[0] == "gate":
                re, im = pairdm.apply_op_pair_dm(re, im, item[1], n)
            else:
                re, im = pairdm.apply_channel_pair_dm(re, im, item[1],
                                                      item[2], list(item[3]),
                                                      n)
        return re, im
    re, im = jax.jit(run)()
    rho = _pair_to_mat(re, im, n)

    import functools
    Ms = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
          "Y": np.array([[0, -1j], [1j, 0]]), "Z": np.diag([1.0, -1.0])}
    def dense(string):
        chars = ["I"] * n
        for p, q in string:
            chars[q] = p
        return functools.reduce(np.kron, [Ms[c] for c in reversed(chars)])

    assert abs(float(pairdm.trace_pair_dm_jit(re, n)) - 1.0) < 1e-12
    want_pur = np.real(np.trace(rho @ rho))
    assert abs(float(pairdm.purity_pair_dm_jit(re, im)) - want_pur) < 1e-12
    for string in ([("Z", 0)], [("Z", 0), ("Z", 2)], [("X", 1)],
                   [("Y", 2)], [("X", 0), ("Y", 1), ("Z", 2)]):
        want = np.real(np.trace(dense(string) @ rho))
        if all(p == "Z" for p, _ in string):
            got = float(pairdm.expval_pauli_product_z_pair_dm_jit(
                re, qubits=tuple(q for _, q in string), n=n))
        else:
            got = float(pairdm.expval_pauli_string_pair_dm_jit(
                re, im, ops=tuple(string), n=n))
        assert abs(got - want) < 1e-12, (string, got, want)

    # diagonal / marginals / prob_one agree with the dense diagonal
    diag = np.real(np.diag(rho))
    np.testing.assert_allclose(
        np.asarray(pairdm.marginal_probs_pair_dm_jit(
            re, qubits=tuple(range(n)), n=n)), diag, atol=1e-6)
    p1 = float(pairdm.prob_one_pair_dm_jit(re, 1, n))
    want_p1 = diag[[i for i in range(8) if (i >> 1) & 1]].sum()
    assert abs(p1 - want_p1) < 1e-12


def test_pair_dm_wide_kraus_per_term_path(double_precision):
    """>= 3-target channels accumulate per Kraus term (the superop's
    XOR-diagonal loop would cost 4^(2m) selects); must equal the complex
    engine bit-for-tolerance."""
    n = 3
    rng = np.random.default_rng(11)
    a = rng.normal(size=(16, 8)) + 1j * rng.normal(size=(16, 8))
    q, _ = np.linalg.qr(a)
    ks = [q[:8], q[8:]]  # 3-qubit CPTP pair
    prog = [("gate", GateOp("H", (0,))), ("gate", GateOp("RY", (1,), (),
                                                         (0.3,))),
            ("kraus", ks, (0, 1, 2))]
    want = _complex_rho(prog, n)
    got = _pair_rho(prog, n)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_small_imaginary_parts_are_kept(double_precision):
    """_rows_from_numpy must not drop ~1e-9 imaginary parts (exactness is
    the pair engine's whole contract)."""
    eps = 1e-9
    # unitary with a tiny RELATIVE phase: exp(i*eps*Z) — its ~1e-9
    # imaginary entries must survive (a global-phase construction would
    # cancel in rho)
    u = np.diag([np.exp(1j * eps), np.exp(-1j * eps)])
    prog = [("gate", GateOp("H", (0,))),
            ("gate", GateOp("UNITARY", (0,), (), (), u))]
    got = _pair_rho(prog, 1)
    want = _complex_rho(prog, 1)
    np.testing.assert_allclose(got, want, atol=1e-15)
    # rho01 = 0.5*exp(2i*eps): the eps-grade imaginary signal survives
    assert abs(got[0, 1].imag - 1e-9) < 1e-12


def test_density_state_flush_programs_are_structure_cached(
        double_precision):
    """Two flushes with the same queue STRUCTURE but different angles must
    reuse one compiled program (angles are runtime inputs, never baked)."""
    from rocquantum_tpu import density_state as ds
    ds._DMS_RUN_CACHE.clear()
    outs = []
    for theta in (0.4, 1.3):
        st = ds.DensityMatrixState(2)
        st.apply_ry(theta, 0)
        st.apply_cnot(0, 1)
        st._flush()
        outs.append(st.get_density_matrix())
        assert len(ds._DMS_RUN_CACHE) == 1
    for theta, rho in zip((0.4, 1.3), outs):
        assert abs(rho[0, 0].real - np.cos(theta / 2) ** 2) < 1e-12


def test_pair_density_state_surface(double_precision):
    """DensityMatrixState runs the pair engine under double precision."""
    from rocquantum_tpu.density_state import DensityMatrixState, Pauli
    st = DensityMatrixState(2)
    st.apply_h(0)
    st.apply_cnot(0, 1)
    st.apply_depolarizing_channel([0], 0.1)
    st._flush()
    assert isinstance(st._rho, tuple)
    assert st._rho[0].dtype == jnp.float64
    rho = st.get_density_matrix()
    assert rho.dtype == np.complex128
    assert abs(np.trace(rho).real - 1.0) < 1e-12
    # <Z0 Z1> of a depolarized Bell pair: (1-4p/3) * 1
    zz = st._compute_z_product_expectation([0, 1])
    assert abs(zz - (1 - 4 * 0.1 / 3)) < 1e-12
    assert abs(st.compute_expectation(Pauli.Z, 0)) < 1e-12
    xx = st.compute_pauli_string_expectation([("X", 0), ("X", 1)])
    assert abs(xx - (1 - 4 * 0.1 / 3)) < 1e-12


def test_pair_density_circuit_surface(double_precision):
    """DensityCircuit end-to-end under double precision: flush, expval,
    purity, measure, sample."""
    from rocquantum_tpu.density_circuit import DensityCircuit
    sim = rocq.Simulator(seed=0)
    dc = DensityCircuit(2, sim)
    dc.h(0)
    dc.cx(0, 1)
    dc.apply_channel("phase_flip", 0.25, [1])
    dc.ry(0.8, 0)
    dc.flush()
    assert isinstance(dc._rho, tuple)

    # complex reference (CPU c128)
    prog = [("gate", GateOp("H", (0,))), ("gate", GateOp("CNOT", (1,), (0,))),
            ("channel", "phase_flip", 0.25, (1,)),
            ("gate", GateOp("RY", (0,), (), (0.8,)))]
    want = _complex_rho(prog, 2)
    np.testing.assert_allclose(dc.get_density_matrix(), want, atol=1e-12)

    h = rocq.PauliOperator({"Z0 Z1": 1.0, "X0 X1": 0.5, "I": 0.1})
    import functools
    Ms = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]),
          "Z": np.diag([1.0, -1.0])}
    zz = functools.reduce(np.kron, [Ms["Z"], Ms["Z"]])
    xx = functools.reduce(np.kron, [Ms["X"], Ms["X"]])
    want_ev = (np.trace(zz @ want) + 0.5 * np.trace(xx @ want)).real + 0.1
    assert abs(dc.expval(h) - want_ev) < 1e-12
    assert abs(dc.purity() - np.trace(want @ want).real) < 1e-12

    outcome, prob = dc.measure(0)
    assert outcome in (0, 1)
    diag = np.real(np.diag(want))
    p1 = diag[1] + diag[3]
    assert abs(prob - (p1 if outcome == 1 else 1 - p1)) < 1e-12
    shots = dc.sample([0], 32)
    assert set(np.asarray(shots).tolist()) == {outcome}

    # reset under double precision stays on the pair engine
    dc.reset()
    assert isinstance(dc._rho, tuple)
    np.testing.assert_allclose(dc.get_density_matrix(),
                               np.diag([1.0, 0, 0, 0]), atol=0)


def test_pair_density_circuit_param_cache(double_precision):
    """Same structure, different angles: the cached pair program re-runs
    with new runtime params (no recompile, correct values)."""
    from rocquantum_tpu.density_circuit import DensityCircuit, _DM_RUN_CACHE
    for theta in (0.3, 1.1):
        dc = DensityCircuit(1, rocq.Simulator(seed=1))
        dc.ry(theta, 0)
        dc.flush()
        rho = dc.get_density_matrix()
        want00 = np.cos(theta / 2) ** 2
        assert abs(rho[0, 0].real - want00) < 1e-12


def test_dsl_backends_fp64_pair(double_precision):
    """The DSL front end rides the pair engines at double precision."""
    from rocquantum_tpu.dsl.backends import get_backend
    b = get_backend("state_vector", 2)
    b.apply_gate("h", [0])
    b.apply_gate("cnot", [0, 1])
    psi = b.get_state()
    assert abs(abs(psi[0]) - 2 ** -0.5) < 1e-12
    assert abs(b.expectation_pauli([("Z", 0), ("Z", 1)]) - 1.0) < 1e-12
    shots = b.sample([0, 1], 32, seed=1)
    assert set(np.asarray(shots).tolist()) <= {0, 3}

    d = get_backend("density_matrix", 2)
    d.apply_gate("h", [0])
    d.apply_gate("cnot", [0, 1])
    d.apply_noise("depolarizing", [0], 0.1)
    rho = d.get_state()
    assert abs(np.trace(rho).real - 1.0) < 1e-12
    zz = d.expectation_pauli([("Z", 0), ("Z", 1)])
    assert abs(zz - (1 - 4 * 0.1 / 3)) < 1e-12
