"""df64 flush path: ``set_precision("df64")`` routes fp64 Circuit flushes
through the double-float engine (per-op compensated arithmetic with f64
error terms) and matches the exact-f64 pair engine to the df64 accuracy
contract (~1e-13 end-to-end). Reference parity: the ROCQ_PRECISION_DOUBLE
regime (rocquantum/include/rocquantum/hipStateVec.h:7-15)."""

import numpy as np
import pytest
import jax.numpy as jnp

import rocquantum_tpu as rocq
from rocquantum_tpu import config
from rocquantum_tpu.compiler.ir import CircuitIR, GateOp
from rocquantum_tpu.compiler.interpreter import execute_df64
from rocquantum_tpu.ops import df64, pairsim


@pytest.fixture
def df64_mode():
    old = config.get_precision()
    config.set_precision("df64")
    yield
    config.set_precision(old)


def test_set_precision_df64_semantics():
    old = config.get_precision()
    try:
        config.set_precision("df64")
        assert config.get_precision() == "double"  # state/readback contract
        assert config.df64_enabled()
        config.set_precision("double")
        assert not config.df64_enabled()
    finally:
        config.set_precision(old)


def test_df64_flush_plan_replay(df64_mode):
    """Second structurally-identical circuit takes the cached flush plan
    (mode 'df64') and still lands on the right state."""
    def build(theta):
        c = rocq.Circuit(4, rocq.Simulator(seed=2))
        for q in range(4):
            c.ry(theta + 0.01 * q, q)
        c.cx(0, 3)
        c.flush()
        return c

    c1 = build(0.3)
    psi1 = c1.get_statevector()
    c2 = build(0.9)           # same structure, new params -> cached plan
    psi2 = c2.get_statevector()
    assert not np.allclose(psi1, psi2)

    config.set_precision("double")
    c3 = rocq.Circuit(4, rocq.Simulator(seed=2))
    for q in range(4):
        c3.ry(0.9 + 0.01 * q, q)
    c3.cx(0, 3)
    np.testing.assert_allclose(psi2, c3.get_statevector(), atol=5e-13)


def test_df64_measurement_and_expval(df64_mode):
    c = rocq.Circuit(4, rocq.Simulator(seed=0))
    c.h(0)
    c.cx(0, 1)
    for q in range(2, 4):
        c.ry(0.11 * q, q)
    h = rocq.PauliOperator({"Z0 Z1": 1.0, "X0 X1": 0.5, "I": 0.25})
    ev = c.expval(h)
    outcome, prob = c.measure(0)
    assert outcome in (0, 1)
    assert abs(prob - 0.5) < 1e-10
    assert abs(ev - (1.0 + 0.5 + 0.25)) < 1e-10  # Bell: ZZ=XX=1


def test_execute_df64_without_pallas_falls_back_exact(df64_mode):
    """execute_df64 applies ops via the per-gate df64 path and matches
    the exact pair engine."""
    n = 6
    ir = CircuitIR(n)
    ir.add("H", [0])
    ir.add("CNOT", [1], controls=[0])
    ir.add("RY", [3], params=[0.7])
    planes = df64.init_df64(n)
    planes = execute_df64(planes, list(ir.ops),
                          jnp.zeros((0,), jnp.float64))
    got_re = df64.promote_f64(planes[0], planes[1])

    re = jnp.zeros((1 << n,), jnp.float64).at[0].set(1.0)
    im = jnp.zeros_like(re)
    for op in ir.ops:
        re, im = pairsim.apply_op_pair(re, im, op)
    np.testing.assert_allclose(np.asarray(got_re), np.asarray(re),
                               atol=1e-14)
