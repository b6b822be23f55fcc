"""Property-style fuzz tests: the engine must match a dense matrix-product
reference for random circuits over the full gate alphabet (the strongest
form of the reference's analytic-state comparisons)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rocquantum_tpu.compiler.ir import CircuitIR
from rocquantum_tpu.compiler.interpreter import compile_ir, parametrize
from rocquantum_tpu.ops import gates as g
from rocquantum_tpu.ops import statevec as sv
from rocquantum_tpu.ops import density as dmops


def dense_gate(name, params, targets, controls, n):
    """Build the full 2^n x 2^n matrix for one op (little-endian)."""
    base = {
        "H": g.H, "X": g.X, "Y": g.Y, "Z": g.Z, "S": g.S, "SDG": g.SDG,
        "T": g.T, "TDG": g.TDG, "SWAP": g.SWAP,
    }.get(name)
    if base is None:
        th = params[0]
        c, s_ = np.cos(th / 2), np.sin(th / 2)
        if name == "RX":
            base = np.array([[c, -1j * s_], [-1j * s_, c]])
        elif name == "RY":
            base = np.array([[c, -s_], [s_, c]])
        elif name == "RZ":
            base = np.diag([np.exp(-0.5j * th), np.exp(0.5j * th)])
        elif name == "P":
            base = np.diag([1, np.exp(1j * th)])
        else:
            raise ValueError(name)
    m = len(targets)
    dim = 1 << n
    full = np.zeros((dim, dim), complex)
    ctrl_mask = 0
    for cq in controls:
        ctrl_mask |= 1 << cq
    for col in range(dim):
        if (col & ctrl_mask) != ctrl_mask:
            full[col, col] = 1.0
            continue
        tbits = 0
        for k, t in enumerate(targets):
            tbits |= ((col >> t) & 1) << k
        base_col = col
        for t in targets:
            base_col &= ~(1 << t)
        for row_bits in range(1 << m):
            row = base_col
            for k, t in enumerate(targets):
                if (row_bits >> k) & 1:
                    row |= 1 << t
            full[row, col] += base[row_bits, tbits]
    return full


def random_ops(n, depth, rng):
    ops = []
    names_1q = ["H", "X", "Y", "Z", "S", "SDG", "T", "TDG", "RX", "RY",
                "RZ", "P"]
    for _ in range(depth):
        kind = rng.integers(0, 4)
        qs = rng.permutation(n)
        if kind == 0:
            name = str(rng.choice(names_1q))
            params = [float(rng.normal())] if name in ("RX", "RY", "RZ", "P") \
                else []
            ops.append((name, [int(qs[0])], [], params))
        elif kind == 1:
            ops.append(("SWAP", [int(qs[0]), int(qs[1])], [], []))
        elif kind == 2:
            name = str(rng.choice(["X", "Z", "RY"]))
            params = [float(rng.normal())] if name == "RY" else []
            ops.append((name, [int(qs[0])], [int(qs[1])], params))
        else:
            nc = int(rng.integers(1, min(3, n - 1) + 1))
            ops.append(("X", [int(qs[0])], [int(q) for q in qs[1:1 + nc]], []))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_statevector_matches_dense_reference(seed):
    n = 5
    rng = np.random.default_rng(seed)
    ops = random_ops(n, 15, rng)

    ir = CircuitIR(n)
    for name, targets, controls, params in ops:
        ir.add(name, targets, controls=controls, params=params)
    pops, values = parametrize(ir.ops)
    fn = compile_ir(CircuitIR(n, pops), donate=False)
    out = fn(jax.jit(lambda: sv.init_state(n))(),
             jnp.asarray(values, jnp.float32))
    got = np.asarray(jnp.real(out)) + 1j * np.asarray(jnp.imag(out))

    psi = np.zeros(1 << n, complex)
    psi[0] = 1.0
    for name, targets, controls, params in ops:
        psi = dense_gate(name, params, targets, controls, n) @ psi
    np.testing.assert_allclose(got, psi, atol=2e-5, err_msg=f"seed={seed}")


@pytest.mark.parametrize("seed", range(3))
def test_density_matches_statevector_fuzz(seed):
    """Pure-state evolution on the DM engine == |psi><psi| from the SV
    engine for random circuits."""
    n = 4
    rng = np.random.default_rng(100 + seed)
    ops = random_ops(n, 12, rng)

    @jax.jit
    def run_both():
        state = sv.init_state(n)
        rho = dmops.init_density(n)
        for name, targets, controls, params in ops:
            state = sv.apply_gate(state, name, targets, controls, params)
            rho = dmops.apply_gate_dm(rho, name, targets, controls, params)
        diff = dmops.to_matrix(rho) - jnp.outer(state, jnp.conj(state))
        return jnp.max(jnp.abs(diff))

    assert float(run_both()) < 2e-5


def test_sharded_density_matrix():
    """rho is a 2n-qubit state, so the sharded machinery applies unchanged:
    distributed density-matrix evolution over the 8-device mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from rocquantum_tpu.parallel import make_mesh, state_sharding
    mesh = make_mesh(8)
    sharding = state_sharding(mesh)
    n = 4

    @jax.jit
    def run():
        rho = dmops.init_density(n)
        rho = jax.lax.with_sharding_constraint(rho, sharding)
        rho = dmops.apply_gate_dm(rho, "H", [0])
        rho = dmops.apply_gate_dm(rho, "CNOT", [1], [0])
        rho = dmops.apply_channel(rho, "depolarizing", 0.05, [0, 1])
        rho = jax.lax.with_sharding_constraint(rho, sharding)
        return (dmops.expval_pauli_product_z_dm(rho, [0, 1]),
                dmops.trace_dm(rho))

    zz, tr = run()
    assert abs(float(tr) - 1.0) < 1e-5
    assert 0.5 < float(zz) < 1.0


@pytest.mark.parametrize("seed", range(6))
def test_pallas_paths_match_plain_engine_fuzz(seed):
    """Random circuits through the full plain pipeline (diagonal fusion,
    2-qubit fusion, low/high consolidation at the default widths, roll-
    select on low bits, controlled slice write-backs) match a dense numpy
    reference."""
    import _np_ref
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(10, 14))
    ir = CircuitIR(n)
    ref_ops = []
    for _ in range(40):
        kind = rng.integers(0, 5)
        q = int(rng.integers(0, n))
        q2 = int((q + 1 + rng.integers(0, n - 1)) % n)
        if kind == 0:
            name, th = str(rng.choice(["RY", "RX", "RZ"])), float(rng.normal())
            ir.add(name, [q], params=[th])
            ref_ops.append((name, [q], [], [th]))
        elif kind == 1:
            name = str(rng.choice(["H", "X", "S", "T", "Y"]))
            ir.add(name, [q])
            ref_ops.append((name, [q], [], []))
        elif kind == 2:
            ir.add("CNOT", [q2], controls=[q])
            ref_ops.append(("CNOT", [q2], [q], []))
        elif kind == 3:
            name, th = str(rng.choice(["CRY", "CRX"])), float(rng.normal())
            ir.add(name, [q2], controls=[q], params=[th])
            ref_ops.append((name, [q2], [q], [th]))
        else:
            name = str(rng.choice(["CZ", "CRZ", "P", "RZZ"]))
            th = float(rng.normal())
            if name == "RZZ":
                ir.add("RZZ", [q, q2], params=[th])
                ref_ops.append(("RZZ", [q, q2], [], [th]))
            else:
                params = [th] if name != "CZ" else []
                ir.add(name, [q2], controls=[q], params=params)
                ref_ops.append((name, [q2], [q], params))
    pops, values = parametrize(ir.ops)
    params = jnp.asarray(values, jnp.float32)

    from rocquantum_tpu.compiler.interpreter import default_widths, execute
    low, high = default_widths(n)
    got = jax.jit(lambda p: execute(sv.init_state(n), pops, p,
                                    low_width=low, high_width=high))(params)
    np.testing.assert_allclose(np.asarray(got), _np_ref.run(n, ref_ops),
                               atol=3e-5, err_msg=f"seed={seed} n={n}")


def test_fuzz_flush_plan_cache_hits(monkeypatch):
    """Plan-cache correctness insurance: structurally-identical circuits
    with DIFFERENT angles must produce correct states when the second one
    rides the cached plan — across swap-elision
    layout changes, multi-flush (measure boundaries skipped: collapse is
    stochastic), and both density conjugation sides (RZ/U3)."""
    import rocquantum_tpu as rocq
    from rocquantum_tpu import api as api_mod
    from rocquantum_tpu import density_circuit as dcm

    rng = np.random.default_rng(42)
    names1q = ["H", "X", "RY", "RZ", "RX", "S", "T"]
    n = 6

    def random_structure(n_ops):
        ops = []
        for _ in range(n_ops):
            kind = rng.integers(0, 4)
            if kind == 0:
                q = int(rng.integers(0, n))
                ops.append((str(rng.choice(names1q)), (q,), ()))
            elif kind == 1:
                a, b = rng.choice(n, size=2, replace=False)
                ops.append(("CNOT", (int(a),), (int(b),)))
            elif kind == 2:
                a, b = rng.choice(n, size=2, replace=False)
                ops.append(("SWAP", (int(a), int(b)), ()))
            else:
                q = int(rng.integers(0, n))
                ops.append(("U3", (q,), ()))
        return ops

    def run_sv(structure, angles):
        c = rocq.Circuit(n, rocq.Simulator(seed=1))
        it = iter(angles)
        for name, tgt, ctrl in structure:
            if name in ("RX", "RY", "RZ"):
                c._enqueue(name, tgt, ctrl, (next(it),))
            elif name == "U3":
                c._enqueue(name, tgt, ctrl,
                           (next(it), next(it), next(it)))
            else:
                c._enqueue(name, tgt, ctrl)
            # interleaved flushes exercise multi-flush plan reuse
        c.flush()
        return c.get_statevector()

    def run_dm(structure, angles):
        dc = dcm.DensityCircuit(n, rocq.Simulator(seed=1))
        it = iter(angles)
        for name, tgt, ctrl in structure:
            if name in ("RX", "RY", "RZ"):
                dc._enqueue(name, tgt, ctrl, (next(it),))
            elif name == "U3":
                dc._enqueue(name, tgt, ctrl,
                            (next(it), next(it), next(it)))
            else:
                dc._enqueue(name, tgt, ctrl)
        dc.apply_channel("depolarizing", 0.03, [0])
        return dc.get_density_matrix()

    for trial in range(4):
        structure = random_structure(12)
        n_angles = sum(3 if s[0] == "U3" else 1
                       for s in structure if s[0] in ("RX", "RY", "RZ",
                                                      "U3"))
        a1 = rng.uniform(-np.pi, np.pi, size=n_angles)
        a2 = rng.uniform(-np.pi, np.pi, size=n_angles)
        # first run populates the plan caches; second takes the hit path
        api_mod._FLUSH_PLAN_CACHE.clear()
        dcm._DM_RUN_CACHE.clear()
        sv1 = run_sv(structure, a1)
        sv2_cached = run_sv(structure, a2)
        # fresh-cache reference for the second angle set
        api_mod._FLUSH_PLAN_CACHE.clear()
        sv2_fresh = run_sv(structure, a2)
        np.testing.assert_allclose(sv2_cached, sv2_fresh, atol=1e-5,
                                   err_msg=f"sv plan-cache trial {trial}")
        assert not np.allclose(sv1, sv2_cached)  # angles actually differ

        rho1 = run_dm(structure, a1)
        rho2_cached = run_dm(structure, a2)
        dcm._DM_RUN_CACHE.clear()
        rho2_fresh = run_dm(structure, a2)
        np.testing.assert_allclose(rho2_cached, rho2_fresh, atol=1e-5,
                                   err_msg=f"dm plan-cache trial {trial}")
        # sanity: density state is physical
        assert abs(np.trace(rho2_cached) - 1) < 1e-5
