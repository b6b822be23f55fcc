"""Unit tests for the compiler fusion/consolidation pass pipeline."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rocquantum_tpu.compiler.ir import CircuitIR, GateOp, ParamRef
from rocquantum_tpu.compiler.passes import (
    DiagBlock, FusedBlock, consolidate_high, consolidate_low,
    fuse_diagonals, is_diagonal, plan_fusion)
from rocquantum_tpu.compiler.interpreter import execute, parametrize
from rocquantum_tpu.ops import statevec as sv


def g(name, targets, controls=(), params=()):
    return GateOp(name, tuple(targets), tuple(controls), tuple(params))


class TestDiagonalFusion:
    def test_is_diagonal(self):
        assert is_diagonal(g("Z", [0]))
        assert is_diagonal(g("CRZ", [1], [0], [0.3]))
        assert is_diagonal(g("CZ", [1], [0]))
        assert not is_diagonal(g("X", [0]))
        assert not is_diagonal(g("CNOT", [1], [0]))

    def test_consecutive_diagonals_group(self):
        ops = [g("Z", [0]), g("S", [1]), g("CRZ", [2], [0], [0.1]),
               g("H", [0]), g("T", [1])]
        out = fuse_diagonals(ops)
        blocks = [o for o in out if isinstance(o, DiagBlock)]
        # first block holds the 3-gate cascade; H flushes it (shares qubit
        # 0); the trailing T stays a (singleton) DiagBlock — the elementwise
        # path is the fast path even for lone diagonals
        assert len(blocks) == 2
        assert len(blocks[0].ops) == 3
        assert len(blocks[1].ops) == 1 and blocks[1].ops[0].name == "T"
        names = [o.name for o in out if isinstance(o, GateOp)]
        assert "H" in names

    def test_disjoint_nondiagonal_passthrough(self):
        ops = [g("Z", [0]), g("H", [3]), g("S", [0])]
        out = fuse_diagonals(ops)
        blocks = [o for o in out if isinstance(o, DiagBlock)]
        assert len(blocks) == 1 and len(blocks[0].ops) == 2


class TestConsolidation:
    def test_low_high_regions(self):
        ops = [g("H", [0]), g("T", [1]), g("H", [7]), g("H", [6]),
               g("CNOT", [4], [3])]
        plan = plan_fusion(ops)
        plan = consolidate_low(plan, 2)
        plan = consolidate_high(plan, 2, 8)
        lows = [b for b in plan if isinstance(b, FusedBlock)
                and b.qubits == (0, 1)]
        highs = [b for b in plan if isinstance(b, FusedBlock)
                 and b.qubits == (6, 7)]
        assert lows and highs

    def test_swap_bits_never_fused(self):
        ops = [g("H", [0]), GateOp("SWAP_BITS", (0, 5)), g("H", [0])]
        plan = plan_fusion(ops)
        plan = consolidate_low(plan, 6)
        names = [o.name for o in plan if isinstance(o, GateOp)]
        assert "SWAP_BITS" in names


class TestPipelineEquivalence:
    @pytest.mark.parametrize("seed", range(3))
    def test_all_passes_preserve_semantics(self, seed):
        from rocquantum_tpu.models import random_circuit_ir
        n = 9
        ir = random_circuit_ir(n, 20, seed=seed)
        ops, values = parametrize(ir.ops)
        p = jnp.asarray(values, jnp.float32)
        base = execute(sv.init_state(n), ops, p, fuse=False)
        full = execute(sv.init_state(n), ops, p, low_width=4, high_width=4)
        np.testing.assert_allclose(np.asarray(jnp.abs(base - full)),
                                   0, atol=1e-5)


class TestLaneRegionLayoutHazard:
    def test_cross_lane_gate_avoids_exposed_views(self):
        """Regression: H(25) + CNOT(25->0) at n=26 must not lower to
        exposed-view einsums with size-1 trailing dims on qubit 0; the
        flip-select path keeps every view of rank <= 3."""
        import jax
        import jax.numpy as jnp
        from rocquantum_tpu.compiler.interpreter import compile_ir
        n = 26
        ir = CircuitIR(n)
        ir.add("H", [n - 1])
        ir.add("CNOT", [0], controls=[n - 1])
        fn = compile_ir(ir, donate=False, low_width=9, high_width=9)
        txt = jax.jit(lambda s, p: fn(s, p)).lower(
            jax.ShapeDtypeStruct((1 << n,), jnp.complex64),
            jax.ShapeDtypeStruct((0,), jnp.float32)).as_text()
        # the pathological signature: a rank>=5 view exposing qubit 0
        assert "16777216x2x1" not in txt
        assert "x2x1xcomplex" not in txt

    def test_roll_select_matches_reference(self):
        """flip-select path == dense reference for controlled/plain gates
        with lane-region targets at n just above the lane boundary."""
        import jax.numpy as jnp
        from rocquantum_tpu.ops import statevec as sv
        rng = np.random.default_rng(3)
        n = 9
        v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        v = (v / np.linalg.norm(v)).astype(np.complex64)
        u = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        state = jnp.asarray(v)
        got = sv._flip_select_apply(state, jnp.asarray(u, jnp.complex64),
                                    [2], [8, 5])
        # reference via dense controlled construction
        full = np.zeros((1 << n, 1 << n), complex)
        for col in range(1 << n):
            if ((col >> 8) & 1) and ((col >> 5) & 1):
                t = (col >> 2) & 1
                for tn_ in (0, 1):
                    row = (col & ~(1 << 2)) | (tn_ << 2)
                    full[row, col] += u[tn_, t]
            else:
                full[col, col] = 1.0
        expected = full @ v
        np.testing.assert_allclose(np.asarray(got), expected, atol=1e-5)
