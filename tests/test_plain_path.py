"""The plain XLA gate path against a dense numpy reference.

Every gate of the alphabet, at target positions below, inside and above
each consolidation width, with fusion on and off, through ``compile_ir``
and through ``Circuit.flush``; the width defaults at their boundaries;
buffer donation; the df64 error terms; the compile-cache directory.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import _np_ref
import rocquantum_tpu as rocq
from rocquantum_tpu.compiler import interpreter as interp
from rocquantum_tpu.compiler.ir import CircuitIR
from rocquantum_tpu.compiler.passes import (FusedBlock, consolidate_high,
                                            consolidate_low, fuse_diagonals,
                                            plan_fusion)
from rocquantum_tpu.ops import statevec as sv

N = 10
WIDTH = 3   # low region {0, 1, 2}, high region {7, 8, 9}

# below / at the edge of / just above the low region, the middle, and the
# edges of the high region
POSITIONS_1Q = [0, WIDTH - 1, WIDTH, N // 2, N - WIDTH - 1, N - 1]
PAIRS_2Q = [(0, 1), (WIDTH - 1, WIDTH), (WIDTH, N // 2),
            (N - WIDTH - 1, N - WIDTH), (N - 1, 0), (N - 2, N - 1)]
GATES_1Q = [("H", ()), ("Y", ()), ("S", ()), ("RX", (0.37,)),
            ("RY", (-1.1,)), ("RZ", (0.83,)), ("P", (0.61,))]
GATES_2Q = [("CNOT", ()), ("CZ", ()), ("CRY", (0.47,)), ("SWAP", ()),
            ("RZZ", (0.29,))]
MODES = [("compile_ir", True), ("compile_ir", False), ("flush", True)]


def _cases():
    for name, params in GATES_1Q:
        for q in POSITIONS_1Q:
            yield name, params, (q,), ()
    for name, params in GATES_2Q:
        for a, b in PAIRS_2Q:
            if name in ("SWAP", "RZZ"):
                yield name, params, (a, b), ()
            else:
                yield name, params, (b,), (a,)
    yield "CCX", (), (N // 2,), (0, N - 1)
    yield "CCX", (), (0,), (WIDTH, N - 1)


CASES = list(_cases())


def _preamble(n):
    """A generic entangled state: RY and RZ on every qubit, a CNOT chain."""
    ops = []
    for q in range(n):
        ops.append(("RY", [q], [], [0.3 + 0.17 * q]))
        ops.append(("RZ", [q], [], [0.5 - 0.11 * q]))
    for q in range(n - 1):
        ops.append(("CNOT", [q + 1], [q], []))
    return ops


def _ir(n, ops):
    ir = CircuitIR(n)
    for name, targets, controls, params in ops:
        ir.add(name, list(targets), controls=list(controls),
               params=list(params))
    return ir


@pytest.mark.parametrize("mode,fuse", MODES, ids=[f"{m}-fuse{f}"
                                                  for m, f in MODES])
@pytest.mark.parametrize("name,params,targets,controls", CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in CASES])
def test_gate_matches_numpy(name, params, targets, controls, mode, fuse):
    ops = _preamble(N) + [(name, targets, controls, params)]
    want = _np_ref.run(N, ops)
    ir = _ir(N, ops)
    if mode == "compile_ir":
        fn = interp.compile_ir(ir, fuse=fuse, donate=False,
                               low_width=WIDTH, high_width=WIDTH)
        got = np.asarray(fn(sv.init_state(N), jnp.zeros((0,), jnp.float32)))
    else:
        got = rocq.compile_program(ir, rocq.Simulator(seed=0),
                                   fuse=fuse).run().get_statevector()
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("n,sharded,expected", [
    (4, False, (4, 0)), (8, False, (8, 0)), (9, False, (8, 1)),
    (16, False, (8, 8)), (17, False, (8, 8)), (30, False, (8, 8)),
    (12, True, (8, 0)), (32, True, (8, 0)),
])
def test_default_width_boundaries(n, sharded, expected):
    assert interp.default_widths(n, sharded=sharded) == expected


@pytest.mark.parametrize("n", [12, 16, 17, 20])
def test_consolidation_regions_at_default_widths(n):
    """An RY column consolidates into one low block over qubits
    0..low-1 and one high block over the top high qubits; every other
    qubit keeps its own plan item."""
    low, high = interp.default_widths(n)
    ir = _ir(n, [("RY", [q], [], [0.1 * q]) for q in range(n)])
    plan = plan_fusion(fuse_diagonals(list(ir.ops)), max_fuse=2)
    plan = consolidate_high(consolidate_low(plan, low), high, n)
    blocks = [tuple(b.qubits) for b in plan if isinstance(b, FusedBlock)]
    assert tuple(range(low)) in blocks
    if high:
        assert tuple(range(n - high, n)) in blocks
    covered = {q for b in plan for q in
               (b.qubits if isinstance(b, FusedBlock) else b.targets)}
    assert covered == set(range(n))


@pytest.mark.parametrize("route", ["compile_ir", "flush", "double"])
def test_donation_consumes_input_buffer(route):
    """The flush programs donate the state: the input buffer is consumed
    and the state is updated in place."""
    n = 6
    if route == "compile_ir":
        ir = _ir(n, [("H", [0], [], []), ("CNOT", [1], [0], [])])
        state = sv.init_state(n)
        out = interp.compile_ir(ir)(state, jnp.zeros((0,), jnp.float32))
        assert state.is_deleted() and not out.is_deleted()
        return
    if route == "double":
        rocq.set_precision("double")
    try:
        c = rocq.Circuit(n, rocq.Simulator(seed=0))
        before = c.state
        c.h(0)
        c.cx(0, 1)
        c.flush()
        buffers = before if isinstance(before, tuple) else (before,)
        assert all(b.is_deleted() for b in buffers)
        assert abs(c.get_statevector()[3]) == pytest.approx(2 ** -0.5)
    finally:
        rocq.set_precision("single")


def test_df64_error_terms_exact():
    """df64's two-sum/two-prod error terms go through native f64, so a
    compiler that contracts f32 mul-adds into FMAs cannot drop the
    compensation; a jitted df64 product stays at df64 accuracy, and the
    hi/lo split keeps its lo part."""
    from rocquantum_tpu.ops import df64
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        rng = np.random.default_rng(7)
        a = rng.normal(size=4096)
        b = rng.normal(size=4096)
        x = df64.split_planes(jnp.asarray(a))
        y = df64.split_planes(jnp.asarray(b))
        p = jax.jit(df64.df_mul)(x, y)
        got = np.asarray(p[0], np.float64) + np.asarray(p[1], np.float64)
        assert np.max(np.abs(got - a * b) / np.abs(a * b)) < 1e-13
        s, e = jax.jit(df64.two_prod)(x[0], y[0])
        exact = np.asarray(x[0], np.float64) * np.asarray(y[0], np.float64)
        np.testing.assert_array_equal(
            np.asarray(s, np.float64) + np.asarray(e, np.float64), exact)
        lo = np.asarray(x[1])
        assert np.count_nonzero(lo) > 4000   # the split keeps a lo part
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as it is and nothing else is set;
    without it the cache goes to the fixed <repo>/.jax_cache."""
    from rocquantum_tpu.utils import cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(cache, "REPO_CACHE_DIR", str(tmp_path / "jc"))
        assert cache.enable_compilation_cache() == str(tmp_path / "jc")
        assert calls == [("jax_compilation_cache_dir", str(tmp_path / "jc"))]
        assert os.path.isdir(tmp_path / "jc")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
        assert cache.enable_compilation_cache() == str(tmp_path / env_dir)
        assert calls == []


def test_repo_cache_dir_is_fixed():
    from rocquantum_tpu.utils import cache
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.REPO_CACHE_DIR == os.path.join(repo, ".jax_cache")
