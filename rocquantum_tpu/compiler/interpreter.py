"""Circuit IR -> jitted XLA program.

This is the lowering path that replaces the reference's MLIR pipeline
(QuantumToSimulatorPass -> SimulatorToQIRPass -> LLVM,
rocqCompiler/MLIRCompiler.cpp:47-88) and its per-gate backend dispatch
(HipStateVecBackend.cpp): a CircuitIR traces into ONE jitted function
``f(state, params) -> state`` with the input buffer donated, so XLA fuses and
schedules the whole circuit — no per-gate launches or synchronizes (contrast
simulator.cpp:142's per-gate hipDeviceSynchronize).

Compiled executables are cached by the IR's structural key (gate structure
without parameter values), so re-running a circuit with new parameters — the
VQE inner loop — reuses the executable.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from ..ops import gates as _g
from ..ops import statevec as sv
from .ir import CircuitIR, GateOp, ParamRef
from .passes import DiagBlock, FusedBlock, fuse_diagonals, plan_fusion
from ..utils.cache import BoundedCache

# Named gates that carry implicit control structure when emitted via the
# convenience circuit methods.
_IMPLICIT_CTRL = {"CNOT": "X", "CX": "X", "CZ": "Z",
                  "CRX": "RX", "CRY": "RY", "CRZ": "RZ",
                  "MCX": "X", "CCX": "X", "TOFFOLI": "X", "CSWAP": "SWAP"}

_ADJOINT_NAME = {"S": "SDG", "SDG": "S", "T": "TDG", "TDG": "T"}


def _resolve_params(op: GateOp, params: Optional[jnp.ndarray]):
    vals = []
    for p in op.params:
        if isinstance(p, ParamRef):
            vals.append(params[p.index])
        else:
            vals.append(p)
    return tuple(vals)


def _split_op(op: GateOp):
    """Normalize an op to (base_name_or_matrix, controls, targets)."""
    name = op.name.upper()
    controls = list(op.controls)
    targets = list(op.targets)
    if name in _IMPLICIT_CTRL:
        base = _IMPLICIT_CTRL[name]
        if not controls:
            # CNOT/CZ/CRX emitted as targets=[control, target] without an
            # explicit control list (DSL style): peel controls off targets.
            n_tgt = 2 if base == "SWAP" else 1
            controls, targets = targets[:-n_tgt], targets[-n_tgt:]
        return base, controls, targets
    return name, controls, targets


def _base_matrix(op: GateOp, params: Optional[jnp.ndarray]) -> jnp.ndarray:
    """The (uncontrolled) unitary of ``op`` as a traced 2^m x 2^m array."""
    base, _, targets = _split_op(op)
    if base == "D2M":
        # matrix holds diagonal VALUES d[bit_t0, bit_t1], not a gate matrix
        m = jnp.asarray(op.matrix, config.complex_dtype())
        if op.is_adjoint:
            m = jnp.conj(m)
        return jnp.diag(jnp.stack([m[0, 0], m[1, 0], m[0, 1], m[1, 1]]))
    if op.matrix is not None:
        mat = jnp.asarray(op.matrix, dtype=config.complex_dtype())
    else:
        vals = _resolve_params(op, params)
        name = base
        if op.is_adjoint and name in _ADJOINT_NAME:
            return jnp.asarray(
                _g.gate_matrix(_ADJOINT_NAME[name]), config.complex_dtype())
        mat = _g.gate_matrix(name, vals)
    if op.is_adjoint:
        mat = jnp.conj(mat).T
    return mat


def _dense_with_controls(mat: jnp.ndarray, n_controls: int) -> jnp.ndarray:
    """Expand U on m targets to the dense controlled unitary on
    (targets..., controls...): identity except the all-controls-one block."""
    m = mat.shape[0]
    full = jnp.eye(m << n_controls, dtype=mat.dtype)
    return full.at[-m:, -m:].set(mat)


_DIAG_VECS = {"Z": np.array([1, -1]), "S": np.array([1, 1j]),
              "SDG": np.array([1, -1j]),
              "T": np.array([1, np.exp(1j * np.pi / 4)]),
              "TDG": np.array([1, np.exp(-1j * np.pi / 4)])}


def _diag_vector(op: GateOp, params) -> jnp.ndarray:
    """(2,) diagonal of the op's base gate (controls handled by caller)."""
    base, _, _ = _split_op(op)
    if base in _DIAG_VECS:
        d = jnp.asarray(_DIAG_VECS[base], config.complex_dtype())
    elif base == "RZ":
        (theta,) = _resolve_params(op, params)
        theta = jnp.asarray(theta, config.real_dtype())
        d = jnp.stack([jnp.exp(-0.5j * theta),
                       jnp.exp(0.5j * theta)]).astype(config.complex_dtype())
    elif base in ("P", "PHASE"):
        (lam,) = _resolve_params(op, params)
        lam = jnp.asarray(lam, config.real_dtype())
        d = jnp.stack([jnp.ones((), config.complex_dtype()),
                       jnp.exp(1j * lam).astype(config.complex_dtype())])
    else:
        raise ValueError(f"gate {op.name} is not diagonal")
    if op.is_adjoint:
        d = jnp.conj(d)
    return d


def _apply_diag_block(state: jnp.ndarray, block: DiagBlock,
                      params) -> jnp.ndarray:
    """Multiply all member phase factors in (what XLA fuses into) one
    elementwise pass over the amplitudes."""
    n = sv.num_qubits_of(state)
    for op in block.ops:
        base, controls, targets = _split_op(op)
        if base == "D2M":
            m = jnp.asarray(op.matrix, config.complex_dtype())
            if op.is_adjoint:
                m = jnp.conj(m)
            # d2 axes follow DESCENDING qubit order below
            d2 = m if targets[0] > targets[1] else m.T
            desc = sorted(targets, reverse=True)
            dims = sv._exposed_view_dims(n, desc)
            bshape = [1] * len(dims)
            bshape[1] = bshape[3] = 2
            state = (state.reshape(dims) * d2.reshape(bshape)).reshape(
                state.shape)
            continue
        if base == "RZZ":
            # two-target diagonal: factor d[b0, b1] over both target axes
            (theta,) = _resolve_params(op, params)
            theta = jnp.asarray(theta, config.real_dtype())
            if op.is_adjoint:
                theta = -theta
            em = jnp.exp(-0.5j * theta).astype(config.complex_dtype())
            ep = jnp.exp(0.5j * theta).astype(config.complex_dtype())
            d2 = jnp.stack([jnp.stack([em, ep]), jnp.stack([ep, em])])
            desc = sorted(targets, reverse=True)
            dims = sv._exposed_view_dims(n, desc)
            bshape = [1] * len(dims)
            bshape[1] = bshape[3] = 2
            state = (state.reshape(dims) * d2.reshape(bshape)).reshape(
                state.shape)
            continue
        d = _diag_vector(op, params)
        qubits = list(controls) + list(targets)
        desc = sorted(qubits, reverse=True)
        dims = sv._exposed_view_dims(n, desc)
        k = len(desc)
        # factor tensor over desc-ordered qubit axes: 1 everywhere except
        # the all-controls-one slice, which carries the target diagonal
        f = jnp.ones((2,) * k, config.complex_dtype())
        idx = tuple(1 if desc[j] in set(controls) else slice(None)
                    for j in range(k))
        f = f.at[idx].set(d)  # the remaining free axis is the target
        bshape = [1] * len(dims)
        for j in range(k):
            bshape[2 * j + 1] = 2
        state = (state.reshape(dims) * f.reshape(bshape)).reshape(state.shape)
    return state


# ---------------------------------------------------------------------------
# df64 (double-float): each f64 plane carried as a hi/lo f32 pair, every op
# applied per gate by ops/df64 with f64 error terms (~1e-14 per op).
# ---------------------------------------------------------------------------

def execute_df64(planes, ops: Sequence,
                 params: Optional[jnp.ndarray] = None, sharding=None):
    """``execute`` on a df64 (hi/lo f32) four-plane state
    ``(re_hi, re_lo, im_hi, im_lo)``: every op applies in order via
    ops/df64 (one pass per gate, ~1e-16-per-op accurate).

    ``sharding``: a NamedSharding over the flat amplitude axis — the
    caller (Circuit.flush) has already localized gates onto non-device-
    selecting bits via schedule_for_sharding; per-op applications partition
    under SPMD (SWAP_BITS relabels lower to all-to-all transposes, same
    contract as the complex and pair engines)."""
    from ..ops import df64 as dfm

    for op in ops:
        if op.name == "SWAP_BITS":
            planes = tuple(
                sv.swap_index_bits(p, op.targets[0], op.targets[1],
                                   use_transpose=True) for p in planes)
        elif op.name == "PERMUTE_BITS":
            d, s = ((op.controls, op.targets) if op.is_adjoint
                    else (op.targets, op.controls))
            planes = tuple(sv.permute_index_bits(p, d, s) for p in planes)
        else:
            planes = dfm.apply_op_df64(planes, op,
                                       _resolve_params(op, params))
        if sharding is not None:
            planes = tuple(jax.lax.with_sharding_constraint(p, sharding)
                           for p in planes)
    return planes


def apply_op(state: jnp.ndarray, op: GateOp,
             params: Optional[jnp.ndarray] = None,
             sharded: bool = False) -> jnp.ndarray:
    """Apply one GateOp (controlled slice-update fast path preserved)."""
    if op.name == "SWAP_BITS":
        # physical index-bit relabel: under sharding the transpose form is
        # required (it lowers to an all-to-all); on one device the
        # fused-einsum SWAP avoids a padded materialized transpose
        return sv.swap_index_bits(state, op.targets[0], op.targets[1],
                                  use_transpose=sharded)
    if op.name == "PERMUTE_BITS":
        # batched relabel (scheduler prefetch): one transpose for the
        # whole swap set — one all-to-all round under sharding.
        # Adjoint = the inverse permutation (swap dsts/srcs).
        d, s = ((op.controls, op.targets) if op.is_adjoint
                else (op.targets, op.controls))
        return sv.permute_index_bits(state, d, s)
    base, controls, targets = _split_op(op)
    mat = _base_matrix(op, params)
    return sv.apply_controlled_matrix(state, mat, controls, targets)


def _np_gate_matrix(name: str, params) -> np.ndarray:
    """Host (numpy) gate matrices for static-parameter fusion."""
    key = name.upper()
    if key in _g.FIXED:
        return np.asarray(_g.FIXED[key], np.complex128)
    if key == "RZZ":
        th = float(params[0])
        em, ep = np.exp(-0.5j * th), np.exp(0.5j * th)
        return np.diag([em, ep, ep, em])
    if key in ("RX", "RY", "RZ", "P", "PHASE", "U3"):
        theta = float(params[0])
        c, s = np.cos(theta / 2), np.sin(theta / 2)
        if key == "RX":
            return np.array([[c, -1j * s], [-1j * s, c]])
        if key == "RY":
            return np.array([[c, -s], [s, c]])
        if key == "RZ":
            return np.diag([np.exp(-0.5j * theta), np.exp(0.5j * theta)])
        if key in ("P", "PHASE"):
            return np.diag([1.0, np.exp(1j * theta)])
        t, phi, lam = (float(p) for p in params)
        ct, st = np.cos(t / 2), np.sin(t / 2)
        return np.array([[ct, -np.exp(1j * lam) * st],
                         [np.exp(1j * phi) * st,
                          np.exp(1j * (phi + lam)) * ct]])
    raise KeyError(key)


def _np_apply_rows(acc: np.ndarray, mat: np.ndarray, local, k: int) -> np.ndarray:
    """numpy: left-apply ``mat`` on the row-index bits ``local`` of acc."""
    m = len(local)
    tin = acc.reshape((2,) * k + (acc.shape[1],))
    mt = mat.reshape((2,) * (2 * m))
    row_axis = {k - 1 - q: i for i, q in enumerate(local)}
    labels = list(range(k + 1))
    row_label = [k + 1 + i for i in range(m)]
    mat_labels = ([row_label[m - 1 - j] for j in range(m)]
                  + [k - 1 - local[m - 1 - j] for j in range(m)])
    out_labels = [row_label[row_axis[a]] if a in row_axis else a
                  for a in range(k)] + [k]
    out = np.einsum(mt, mat_labels, tin, labels, out_labels)
    return out.reshape(acc.shape)


def _static_fused_matrix(block: FusedBlock) -> Optional[np.ndarray]:
    """Host-side product when every member has static params — the fused
    matrix bakes into the program as ONE constant (GateFusion.cpp's
    host-side products, generalized). Returns None when any member is
    parameterized or adjoint-of-parameterized."""
    bq = list(block.qubits)
    pos = {q: i for i, q in enumerate(bq)}
    k = len(bq)
    acc = np.eye(1 << k, dtype=np.complex128)
    for op in block.ops:
        # static means concrete host floats only — ParamRefs AND traced
        # values (the adjoint-grad path embeds tracers directly) disqualify
        if any(not isinstance(p, (int, float, np.integer, np.floating))
               for p in op.params):
            return None
        base, controls, targets = _split_op(op)
        if op.matrix is not None:
            mat = np.asarray(op.matrix, np.complex128)
        else:
            try:
                mat = _np_gate_matrix(base, op.params)
            except KeyError:
                return None
        if op.is_adjoint:
            mat = mat.conj().T
        if controls:
            m = mat.shape[0]
            full = np.eye(m << len(controls), dtype=np.complex128)
            full[-m:, -m:] = mat
            mat = full
            targets = targets + controls
        acc = _np_apply_rows(acc, mat, [pos[q] for q in targets], k)
    return acc


def _fused_matrix(block: FusedBlock, params: Optional[jnp.ndarray]) -> jnp.ndarray:
    """Multiply the block's member unitaries into one dense matrix over
    block.qubits (analog of GateFusion's host-side 4x4 products,
    GateFusion.cpp:89-156, generalized and qubit-order-correct). Static
    blocks are computed on host and baked as constants; parameterized
    blocks build the matrix in-program (traced)."""
    static = _static_fused_matrix(block)
    if static is not None:
        return jnp.asarray(static, config.complex_dtype())
    bq = list(block.qubits)
    pos = {q: i for i, q in enumerate(bq)}
    k = len(bq)
    acc = jnp.eye(1 << k, dtype=config.complex_dtype())
    for op in block.ops:
        base, controls, targets = _split_op(op)
        mat = _base_matrix(op, params)
        if controls:
            mat = _dense_with_controls(mat, len(controls))
            targets = targets + controls
        local = [pos[q] for q in targets]
        # Left-multiply the embedded unitary: treat acc's columns as a batch
        # of states and apply the member gate to the row index.
        acc = jax.vmap(lambda col: sv.apply_matrix(col, mat, local),
                       in_axes=1, out_axes=1)(acc)
    return acc


def execute(state: jnp.ndarray, ops: Sequence, params: Optional[jnp.ndarray] = None,
            fuse: bool = True, max_fuse: int = 2,
            low_width: int = 0, high_width: int = 0,
            sharding=None) -> jnp.ndarray:
    """Trace a list of GateOps into gate applications on ``state``.

    ``low_width``/``high_width`` > 0 additionally consolidate runs of gates
    supported on the bottom/top index bits into single matmul blocks (see
    passes.consolidate_low/high).
    """
    items = list(ops)
    if fuse:
        items = fuse_diagonals(items)
    plan = plan_fusion(items, max_fuse=max_fuse) if fuse else items
    if low_width:
        from .passes import consolidate_low
        plan = consolidate_low(plan, low_width)
    if high_width:
        from .passes import consolidate_high
        n = sv.num_qubits_of(state)
        plan = consolidate_high(plan, high_width, n)
    for item in plan:
        if isinstance(item, DiagBlock):
            state = _apply_diag_block(state, item, params)
        elif isinstance(item, FusedBlock):
            mat = _fused_matrix(item, params)
            state = sv.apply_matrix(state, mat, list(item.qubits))
        else:
            state = apply_op(state, item, params,
                             sharded=sharding is not None)
        if sharding is not None:
            # pin the layout after every op so the partitioner never falls
            # back to all-gathering the state
            state = jax.lax.with_sharding_constraint(state, sharding)
    return state


# Both Circuit.flush and compile_ir split a circuit into programs of at most
# this many post-fusion plan items (ROADMAP Speed 7 measures whether the
# split still pays on the GPU).
MAX_SEGMENT_ITEMS = 96


def segment_ops(ops: Sequence, max_items: int, fuse: bool = True) -> list:
    """Split an op list into segments of at most ``max_items`` POST-FUSION
    plan items. Segment boundaries follow plan-item order (a valid
    execution order), so member ops concatenate correctly."""
    ops = list(ops)
    if len(ops) <= max_items:
        return [ops]
    if not fuse:
        # unfused executions compile one op per gate: raw slicing
        return [ops[i:i + max_items] for i in range(0, len(ops), max_items)]
    items = plan_fusion(fuse_diagonals(ops), max_fuse=2)
    segments = []
    for i in range(0, len(items), max_items):
        segments.append([op for item in items[i:i + max_items]
                         for op in (item.ops if isinstance(
                             item, (DiagBlock, FusedBlock)) else [item])])
    return segments


# ---------------------------------------------------------------------------
# Executable cache
# ---------------------------------------------------------------------------

_EXEC_CACHE = BoundedCache()

# Matmul-consolidation width caps, from a sweep of widths 2-9 on an n=30 RY
# layer on one NVIDIA H100 80GB HBM3 at its 700 W power limit (device time
# per layer: w=8 339.8 ms, w=6 353.8 ms, w=9 418.7 ms, none 512.5 ms; the
# width-9 complex GEMMs at HIGHEST precision are compute-bound). PERF.md,
# Findings.
_MAX_LOW_WIDTH = 8
_MAX_HIGH_WIDTH = 8


def default_widths(n: int, sharded: bool = False):
    """(low_width, high_width) defaults for an n-qubit circuit. High-region
    consolidation is disabled when sharded: the top index bits select the
    device, and a dense matmul across them would force an all-gather."""
    low = min(_MAX_LOW_WIDTH, n)
    if sharded:
        return low, 0
    high = min(_MAX_HIGH_WIDTH, n - low)
    return low, high


def parametrize(ops: Sequence[GateOp]):
    """Rewrite concrete float params into ParamRef slots, returning
    (rewritten_ops, param_values). This is what lets eager reference-style
    circuits (concrete angles) share compiled executables across parameter
    updates (QuantumProgram.update_params semantics, api.py:391-417)."""
    import dataclasses as _dc
    new_ops, values = [], []
    for op in ops:
        new_params = []
        for p in op.params:
            if isinstance(p, ParamRef):
                new_params.append(p)
            else:
                new_params.append(ParamRef(len(values)))
                values.append(float(p))
        new_ops.append(_dc.replace(op, params=tuple(new_params)))
    return new_ops, values


def compile_ir(ir: CircuitIR, fuse: bool = True, max_fuse: int = 2,
               donate: bool = True, sharding=None, low_width: Optional[int] = None,
               high_width: Optional[int] = None, batched: bool = False,
               batch_sharding=None):
    """Return a jitted ``f(state, params) -> state`` for this IR, cached by
    structural key. With ``sharding`` (a NamedSharding over the amplitude
    axis), the program runs SPMD over the mesh: XLA inserts the
    collectives for gates touching device-selecting qubits (the reference's
    hand-rolled rcclAlltoallv path, MULTI_GPU_GUIDE.md:44-51).

    ``batched=True`` vmaps the circuit over a leading batch axis — the
    reference's ``batchSize`` threading (hipStateVec.h:61) — and composes
    with sharding: per-op constraints pin the amplitude axis inside the
    vmap while ``batch_sharding`` (e.g. P('dp', 'sv') over a 2-D mesh) pins
    the (batch, 2^n) array at the boundary."""
    if low_width is None or high_width is None:
        dlw, dhw = default_widths(ir.num_qubits, sharded=sharding is not None)
        low_width = dlw if low_width is None else low_width
        high_width = dhw if high_width is None else high_width
    # structural_key maps concrete params to ("dyn",) so STRUCTURE-keyed
    # consumers (the adjoint cache) stay stable across parameter values —
    # but the executable BAKES concrete params (_resolve_params reads
    # op.params), so the exec cache must also key on their VALUES or two
    # IRs differing only in angles would share one wrong program.
    baked = tuple(float(p) for op in ir.ops for p in op.params
                  if not isinstance(p, ParamRef))
    key = (ir.structural_key(), baked, fuse, max_fuse, donate, sharding,
           low_width, high_width, batched, batch_sharding,
           config.get_precision())
    cached = _EXEC_CACHE.get(key)
    if cached is not None:
        return cached

    # Long IRs split into chained per-segment executables by the same
    # post-fusion item rule Circuit.flush uses; the returned callable
    # dispatches each segment from the host.
    segments = segment_ops(list(ir.ops), MAX_SEGMENT_ITEMS, fuse=fuse)
    if len(segments) > 1:
        seg_fns = [
            compile_ir(CircuitIR(ir.num_qubits, seg,
                                 name=f"{ir.name}.seg{i}"),
                       fuse=fuse, max_fuse=max_fuse, donate=donate,
                       sharding=sharding, low_width=low_width,
                       high_width=high_width, batched=batched,
                       batch_sharding=batch_sharding)
            for i, seg in enumerate(segments)]

        def chained(state, params):
            for f in seg_fns:
                state = f(state, params)
            return state

        _EXEC_CACHE[key] = chained
        return chained
    ops = list(ir.ops)

    def run_one(state, params):
        out = execute(state, ops, params, fuse=fuse, max_fuse=max_fuse,
                      low_width=low_width, high_width=high_width,
                      sharding=sharding)
        if sharding is not None:
            out = jax.lax.with_sharding_constraint(out, sharding)
        return out

    if batched:
        def run(state, params):
            out = jax.vmap(lambda s: run_one(s, params))(state)
            if batch_sharding is not None:
                out = jax.lax.with_sharding_constraint(out, batch_sharding)
            return out
    else:
        run = run_one

    io_sharding = batch_sharding if batched else sharding
    if io_sharding is not None:
        fn = jax.jit(run, in_shardings=(io_sharding, None),
                     out_shardings=io_sharding,
                     donate_argnums=(0,) if donate else ())
    else:
        fn = jax.jit(run, donate_argnums=(0,) if donate else ())
    _EXEC_CACHE[key] = fn
    return fn


def compile_df64_pair_ir(ir: CircuitIR, sharding=None):
    """Return a jitted ``f((re, im), params) -> (re, im)`` over
    :func:`execute_df64` on an exact-f64 pair state — the double-float
    engine as a Circuit flush backend (``set_precision("df64")``).

    The program splits each f64 plane into a hi/lo f32 pair (exact to the
    df64 working precision, ~2^-49 relative), runs the circuit per op on
    those pairs, and promotes back to exact f64 at the boundary.

    ``sharding`` compiles the SHARDED df64 program: gates must already be
    localized (Circuit.flush runs schedule_for_sharding first) and the
    state planes stay pinned to the sharding throughout."""
    baked = tuple(float(p) for op in ir.ops for p in op.params
                  if not isinstance(p, ParamRef))
    key = (ir.structural_key(), baked, "df64", sharding)
    cached = _EXEC_CACHE.get(key)
    if cached is not None:
        return cached
    segments = segment_ops(list(ir.ops), MAX_SEGMENT_ITEMS, fuse=False)
    if len(segments) > 1:
        seg_fns = [compile_df64_pair_ir(CircuitIR(ir.num_qubits, seg,
                                             name=f"{ir.name}.seg{i}"),
                                   sharding=sharding)
                   for i, seg in enumerate(segments)]

        def chained(pair, params):
            for f in seg_fns:
                pair = f(pair, params)
            return pair

        _EXEC_CACHE[key] = chained
        return chained
    ops = list(ir.ops)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run(pair, params):
        from ..ops import df64 as dfm
        planes = dfm.split_planes(pair[0]) + dfm.split_planes(pair[1])
        if sharding is not None:
            planes = tuple(jax.lax.with_sharding_constraint(p, sharding)
                           for p in planes)
        planes = execute_df64(planes, ops, params, sharding=sharding)
        out = (dfm.promote_f64(planes[0], planes[1]),
               dfm.promote_f64(planes[2], planes[3]))
        if sharding is not None:
            out = tuple(jax.lax.with_sharding_constraint(p, sharding)
                        for p in out)
        return out

    _EXEC_CACHE[key] = run
    return run



def clear_cache():
    _EXEC_CACHE.clear()
