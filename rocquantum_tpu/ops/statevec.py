"""Core state-vector primitives (pure functions over a flat amplitude array).

JAX replacement for the reference's hipStateVec engine
(reference: rocquantum/src/hipStateVec/hipStateVec.cpp — rocsvAllocateState,
rocsvInitializeState, rocsvApply*, rocsvMeasure, rocsvSample,
rocsvGetExpectationValue*; kernels in single_qubit_kernels.hip,
multi_qubit_kernels.hip, measurement_kernels.hip). Instead of per-gate HIP
kernel launches, every primitive here is a pure JAX function designed to be
traced into one jitted XLA program per circuit segment, letting XLA fuse gate
applications into single HBM passes.

Conventions (identical to the reference's bit layout,
single_qubit_kernels.hip:47-55):
  * state index ``i`` encodes qubit ``q`` in bit ``q`` — qubit 0 is the
    least-significant / fastest-varying bit;
  * for multi-target matrices, ``targets[0]`` is the LSB of the matrix index
    (multi_qubit_kernels.hip:37-115).

Design rules:
  * every reshape exposes ONLY the axes a primitive operates on, keeping
    tensor rank <= 2m+1 for an m-qubit gate regardless of n;
  * callers wrap these primitives in jitted programs and read back
    real/imag pairs (see ``state_to_parts``).

All functions take the state as a flat ``(2**n,)`` complex array. Batched
("DP") simulation uses ``jax.vmap`` over a leading axis at the circuit layer,
the analog of the reference's ``batchSize`` threading (hipStateVec.h:61).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .. import config


def _abs2(z: jnp.ndarray) -> jnp.ndarray:
    """|z|^2 as re^2 + im^2 (no sqrt+square round trip)."""
    return jnp.real(z) ** 2 + jnp.imag(z) ** 2

from . import gates as _g


def num_qubits_of(state: jnp.ndarray) -> int:
    size = state.shape[-1]
    n = size.bit_length() - 1
    if (1 << n) != size:
        raise ValueError(f"state size {size} is not a power of two")
    return n


def one_hot(size: int, index: int, dtype) -> jnp.ndarray:
    """The flat array e_index of ``size`` elements, built by padding (no
    scatter: a scatter's index is int32 without x64, which cannot address
    the 2^31-plus amplitudes of a 31- or 32-qubit state)."""
    if not 0 <= index < size:
        raise ValueError(f"basis index {index} out of range for {size}")
    return jnp.pad(jnp.ones((1,), dtype), (index, size - 1 - index))


def init_state(num_qubits: int, dtype=None) -> jnp.ndarray:
    """|0...0> state. Analog of rocsvInitializeState (hipStateVec.cpp:253)."""
    return one_hot(1 << num_qubits, 0, dtype or config.complex_dtype())


def basis_state(num_qubits: int, index: int, dtype=None) -> jnp.ndarray:
    return one_hot(1 << num_qubits, index, dtype or config.complex_dtype())


def _exposed_view_dims(n: int, qubits_desc: Sequence[int]) -> list:
    """Shape exposing each qubit in ``qubits_desc`` (strictly descending) as
    its own size-2 axis, grouping everything between into flat axes.

    Returns dims [2^(n-1-q_a), 2, 2^(q_a-q_b-1), 2, ..., 2, 2^(q_last)];
    the size-2 axis for qubits_desc[i] is at position 2*i + 1.
    """
    dims = []
    prev = n
    for q in qubits_desc:
        dims.append(1 << (prev - 1 - q))
        dims.append(2)
        prev = q
    dims.append(1 << prev)
    return dims


# ---------------------------------------------------------------------------
# Gate application
# ---------------------------------------------------------------------------

def apply_matrix(state: jnp.ndarray, matrix: jnp.ndarray,
                 targets: Sequence[int]) -> jnp.ndarray:
    """Apply a dense ``2^m x 2^m`` unitary to ``targets``.

    Single integer-label einsum over a rank-(2m+1) view — XLA lowers this to
    one fused pass over the amplitudes (the analog of
    apply_multi_qubit_generic_matrix_kernel, multi_qubit_kernels.hip:37-115,
    without the m<=4 cap or the gather/scatter fallback).
    """
    targets = list(targets)
    n = num_qubits_of(state)
    m = len(targets)
    if len(set(targets)) != m:
        raise ValueError(f"duplicate target qubits: {targets}")
    if matrix.shape != (1 << m, 1 << m):
        raise ValueError(f"matrix shape {matrix.shape} != {(1 << m, 1 << m)}")

    mat2d = jnp.asarray(matrix, dtype=state.dtype)
    if _needs_flip_select(targets, n):
        return _flip_select_apply(state, mat2d, targets)
    # The contiguous matmul fast paths take matrices of 2^m >= 128 (the
    # consolidated low/high blocks); smaller gates take the einsum or the
    # flip-select path.
    use_matmul = (1 << m) >= 128
    if use_matmul and set(targets) == set(range(m)):
        # Low-contiguous fast path: the matrix applies to the low m index
        # bits, so the gate is literally (R, 2^m) @ M^T with fully
        # contiguous rows. Reorder matrix indices if targets are a
        # permutation of range(m).
        if targets != list(range(m)):
            perm = [0] * m
            for k, t in enumerate(targets):
                perm[t] = k
            mt = mat2d.reshape((2,) * (2 * m))
            axes = [m - 1 - perm[m - 1 - j] for j in range(m)]
            mt = jnp.transpose(mt, axes + [m + a for a in axes])
            mat2d = mt.reshape(1 << m, 1 << m)
        rows = state.reshape(-1, 1 << m)
        out = jnp.matmul(rows, mat2d.T,
                         precision=jax.lax.Precision.HIGHEST)
        return out.reshape(state.shape)

    if use_matmul and set(targets) == set(range(n - m, n)):
        # High-contiguous fast path: the matrix applies to the TOP m index
        # bits -> one left-matmul on the (2^m, R) view (row index bit j =
        # qubit n-m+j, matching the matrix convention when targets are
        # ascending).
        base = n - m
        if targets != list(range(base, n)):
            perm = [0] * m
            for k, t in enumerate(targets):
                perm[t - base] = k
            mt = mat2d.reshape((2,) * (2 * m))
            axes = [m - 1 - perm[m - 1 - j] for j in range(m)]
            mt = jnp.transpose(mt, axes + [m + a for a in axes])
            mat2d = mt.reshape(1 << m, 1 << m)
        cols = state.reshape(1 << m, -1)
        out = jnp.matmul(mat2d, cols, precision=jax.lax.Precision.HIGHEST)
        return out.reshape(state.shape)

    desc = sorted(targets, reverse=True)
    dims = _exposed_view_dims(n, desc)
    st = state.reshape(dims)
    rank = len(dims)

    mat = mat2d.reshape((2,) * (2 * m))

    # Matrix tensor axes: 0..m-1 are row bits MSB->LSB (axis j <-> row bit
    # m-1-j, i.e. targets[m-1-j]); m..2m-1 are column bits likewise. The
    # column bit of targets[k] contracts with the exposed state axis of
    # targets[k]; the row bit becomes the output axis there.
    axis_of = {q: 2 * i + 1 for i, q in enumerate(desc)}  # exposed axis pos
    col_label = {t: axis_of[t] for t in targets}          # reuse state labels
    row_label = {t: rank + k for k, t in enumerate(targets)}

    st_labels = list(range(rank))
    mat_labels = ([row_label[targets[m - 1 - j]] for j in range(m)]
                  + [col_label[targets[m - 1 - j]] for j in range(m)])
    target_axes = {axis_of[t]: t for t in targets}
    out_labels = [row_label[target_axes[a]] if a in target_axes else a
                  for a in range(rank)]

    # precision=HIGHEST: a lower default precision (TF32 or bfloat16
    # inputs) costs ~1e-3 per-gate error — fatal for chemistry-accuracy
    # VQE.
    out = jnp.einsum(mat, mat_labels, st, st_labels, out_labels,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(state.shape)


# Gates of <= 2 targets with a target below qubit 7 take the flip-select
# path: on the H100 it runs as one elementwise fusion at copy speed, where
# the einsum on those low bits lowers to transposes plus small GEMMs
# (the plain-path trace in PERF.md).
_LANE_QUBITS = 7
_FLIP_SELECT_MAX_TARGETS = 2


def _flip_bit(x: jnp.ndarray, q: int) -> jnp.ndarray:
    """x[i ^ 2^q]: the partner amplitudes across index bit ``q``. A reversal
    of the size-2 axis of a (R, 2, 2^q) view, so no element crosses a block
    of 2^(q+1) amplitudes and a sharded state stays shard-local."""
    view = (-1, 2, 1 << q) if q else (-1, 2)
    return jnp.flip(x.reshape(view), axis=1).reshape(x.shape)


def _flip_select_apply(state: jnp.ndarray, matrix: jnp.ndarray,
                       targets: Sequence[int],
                       controls: Sequence[int] = ()) -> jnp.ndarray:
    """m-qubit (optionally controlled) gate via partner-flips + selects.

    Each partner amplitude is the state with some target bits flipped, so
    the whole gate is one elementwise pass over the flat state. Used for
    m <= 2 (2^m partner configurations, each built with <= m flips) on low
    targets.
    """
    targets = list(targets)
    m = len(targets)
    mat = jnp.asarray(matrix, state.dtype)
    idx = jax.lax.iota(jnp.uint32, state.shape[0])
    bits = [((idx >> q) & 1) == 1 for q in targets]  # per-element own bits

    # row index of each element within the 2^m matrix block
    row = jnp.zeros_like(idx)
    for k in range(m):
        row = row | (bits[k].astype(jnp.uint32) << k)

    out = jnp.zeros_like(state)
    for j in range(1 << m):
        # partner amplitude with target bits set to configuration j
        x = state
        for k, q in enumerate(targets):
            jk = (j >> k) & 1
            x = jnp.where(bits[k] == bool(jk), x, _flip_bit(x, q))
        # coefficient M[row(i), j] per element (2^m-entry table select)
        col = mat[:, j]
        coef = col[0]
        for r in range(1, 1 << m):
            coef = jnp.where(row == r, col[r], coef)
        out = out + coef * x
    if controls:
        cmask = jnp.ones(state.shape, bool)
        for c in controls:
            cmask = cmask & (((idx >> c) & 1) == 1)
        out = jnp.where(cmask, out, state)
    return out


def _needs_flip_select(targets, n) -> bool:
    """Small gates touching the low index bits take the flip-select path
    on big states."""
    return (len(targets) <= _FLIP_SELECT_MAX_TARGETS
            and min(targets) < _LANE_QUBITS
            and n > _LANE_QUBITS)


def apply_controlled_matrix(state: jnp.ndarray, matrix: jnp.ndarray,
                            controls: Sequence[int],
                            targets: Sequence[int]) -> jnp.ndarray:
    """Apply ``matrix`` to ``targets`` conditioned on all ``controls`` = 1.

    Static-slice formulation: select the control-active sub-block, apply the
    matrix there, and write it back — touching only ``1/2^c`` of the
    amplitudes, like the reference's controlled kernels
    (single_qubit_kernels.hip:78-128; rocsvApplyControlledMatrix decl
    hipStateVec.h). Uncontrolled case falls through to apply_matrix.
    """
    controls = list(controls)
    targets = list(targets)
    if set(controls) & set(targets):
        raise ValueError("control and target qubits overlap")
    if _needs_flip_select(targets, num_qubits_of(state)):
        return _flip_select_apply(state, matrix, targets, controls)
    if not controls:
        return apply_matrix(state, matrix, targets)

    n = num_qubits_of(state)
    desc = sorted(controls, reverse=True)
    dims = _exposed_view_dims(n, desc)
    st = state.reshape(dims)
    idx = tuple(1 if i % 2 == 1 else slice(None) for i in range(len(dims)))
    sub = st[idx]  # rank n_groups; control axes removed

    # Remaining qubits keep their relative order; compute each target's index
    # within the flattened control-active sub-block.
    c = len(controls)
    remaining = [q for q in range(n) if q not in set(controls)]
    pos = {q: i for i, q in enumerate(remaining)}
    sub_targets = [pos[t] for t in targets]
    sub_flat = sub.reshape((1 << (n - c),))
    sub_flat = apply_matrix(sub_flat, matrix, sub_targets)
    st = st.at[idx].set(sub_flat.reshape(sub.shape))
    return st.reshape(state.shape)


def apply_gate(state: jnp.ndarray, name: str, targets: Sequence[int],
               controls: Sequence[int] = (), params: Sequence = ()) -> jnp.ndarray:
    """Apply a named gate (the rocsvApplyH/X/.../CRZ family, hipStateVec.cpp:276-648)."""
    name = name.upper()
    # Named aliases that bundle their own control structure.
    if name in ("CNOT", "CX"):
        (c, t) = (list(controls) + list(targets)) if controls else targets
        return apply_controlled_matrix(state, _mat("X", state.dtype), [c], [t])
    if name == "CZ":
        (c, t) = (list(controls) + list(targets)) if controls else targets
        return apply_controlled_matrix(state, _mat("Z", state.dtype), [c], [t])
    if name in ("MCX", "CCX", "TOFFOLI"):
        return apply_controlled_matrix(state, _mat("X", state.dtype),
                                       list(controls), list(targets))
    if name == "CSWAP":
        return apply_controlled_matrix(state, _mat("SWAP", state.dtype),
                                       list(controls), list(targets))
    if name in ("CRX", "CRY", "CRZ"):
        base = _g.gate_matrix(name[1:], params)
        return apply_controlled_matrix(state, base, list(controls), list(targets))
    base = _g.gate_matrix(name, params)
    return apply_controlled_matrix(state, base, list(controls), list(targets))


def _mat(name, dtype):
    return jnp.asarray(_g.FIXED[name], dtype=dtype)


def swap_index_bits(state: jnp.ndarray, q1: int, q2: int,
                    use_transpose: bool = False) -> jnp.ndarray:
    """Exchange the roles of index bits q1 and q2 (a qubit relabel).

    Single-device analog of rocsvSwapIndexBits (hipStateVec.h:135-137,
    swap_kernels.hip:95-114).

    ``use_transpose=True`` implements it as an explicit rank-5 transpose —
    required under sharding, where XLA lowers the constrained transpose to
    the all-to-all (see parallel/). On a single device the default path
    applies the SWAP matrix instead (identical result).
    """
    if q1 == q2:
        return state
    if not use_transpose:
        return apply_matrix(state, _mat("SWAP", state.dtype), [q1, q2])
    n = num_qubits_of(state)
    hi, lo = max(q1, q2), min(q1, q2)
    dims = _exposed_view_dims(n, [hi, lo])  # rank 5, qubit axes at 1 and 3
    st = state.reshape(dims)
    return st.transpose(0, 3, 2, 1, 4).reshape(state.shape)


def permute_index_bits(state: jnp.ndarray, dsts: Sequence[int],
                       srcs: Sequence[int]) -> jnp.ndarray:
    """Composed multi-bit relabel: new index bit ``dsts[i]`` takes the
    value of old index bit ``srcs[i]`` (``dsts`` and ``srcs`` are the same
    set). ONE rank-(2k+1) view transpose = one data movement — where the
    equivalent SWAP_BITS chain pays one full-state transpose (and, under
    sharding, one all-to-all round) PER swap. The sharded scheduler
    merges adjacent SWAP_BITS runs into this (PERMUTE_BITS pseudo-op)."""
    dsts = tuple(int(d) for d in dsts)
    srcs = tuple(int(s) for s in srcs)
    if dsts == srcs:
        return state
    if sorted(dsts) != sorted(srcs):
        raise ValueError(f"permutation mismatch: {dsts} vs {srcs}")
    n = num_qubits_of(state)
    touched = sorted(set(dsts), reverse=True)
    dims = _exposed_view_dims(n, touched)
    st = state.reshape(dims)
    axis_of = {b: 2 * j + 1 for j, b in enumerate(touched)}
    perm = list(range(len(dims)))
    for d, s in zip(dsts, srcs):
        perm[axis_of[d]] = axis_of[s]
    return st.transpose(perm).reshape(state.shape)


# ---------------------------------------------------------------------------
# Measurement / collapse / sampling
# ---------------------------------------------------------------------------

def prob_one(state: jnp.ndarray, qubit: int) -> jnp.ndarray:
    """P(qubit = 1). Analog of the two-stage probability reduction
    (measurement_kernels.hip:103-247), here a single XLA reduction."""
    n = num_qubits_of(state)
    st = state.reshape((1 << (n - 1 - qubit), 2, 1 << qubit))
    return jnp.sum(_abs2(st[:, 1, :])).astype(config.real_dtype())


def collapse(state: jnp.ndarray, qubit: int, outcome: int) -> jnp.ndarray:
    """Project onto ``qubit = outcome`` and renormalize
    (collapse_state_kernel + renormalize_state_kernel,
    measurement_kernels.hip:37-77)."""
    n = num_qubits_of(state)
    st = state.reshape((1 << (n - 1 - qubit), 2, 1 << qubit))
    keep = st[:, outcome, :]
    norm = jnp.sqrt(jnp.sum(_abs2(keep)))
    # real-scalar rescale via parts
    inv = 1.0 / jnp.maximum(norm, jnp.asarray(config.eps(), norm.dtype))
    keep = jax.lax.complex(jnp.real(keep) * inv, jnp.imag(keep) * inv)
    out = jnp.zeros_like(st).at[:, outcome, :].set(keep)
    return out.reshape(state.shape)


def collapse_dyn(state: jnp.ndarray, qubit: int,
                 outcome: jnp.ndarray) -> jnp.ndarray:
    """Collapse with a TRACED outcome (0/1) — the vmap-able form used for
    per-batch-element measurement (the reference threads batchSize through
    collapse_state_kernel, measurement_kernels.hip:37-61)."""
    n = num_qubits_of(state)
    st = state.reshape((1 << (n - 1 - qubit), 2, 1 << qubit))
    outcome = jnp.asarray(outcome, jnp.int32)
    keep = jax.lax.dynamic_index_in_dim(st, outcome, axis=1, keepdims=False)
    norm = jnp.sqrt(jnp.sum(_abs2(keep)))
    inv = 1.0 / jnp.maximum(norm, jnp.asarray(config.eps(), norm.dtype))
    keep = jax.lax.complex(jnp.real(keep) * inv, jnp.imag(keep) * inv)
    zero = jnp.zeros_like(st)
    out = jax.lax.dynamic_update_index_in_dim(zero, keep, outcome, axis=1)
    return out.reshape(state.shape)


def marginal_probs(state: jnp.ndarray, qubits: Sequence[int]) -> jnp.ndarray:
    """Marginal probability vector over ``qubits``; outcome integer packs
    ``qubits[0]`` into bit 0 (sampling convention of rocsvSample,
    examples/sampling_example.py comment block)."""
    qubits = list(qubits)
    n = num_qubits_of(state)
    k = len(qubits)
    desc = sorted(qubits, reverse=True)
    dims = _exposed_view_dims(n, desc)
    probs = _abs2(state).reshape(dims)
    # Sum out the grouping axes (even positions); keep the exposed qubit axes.
    marg = probs.sum(axis=tuple(range(0, len(dims), 2)))
    # marg axes now correspond to desc order; reorder so axis j is
    # qubits[k-1-j], making qubits[0] the LSB of the flattened index.
    cur_pos = {q: i for i, q in enumerate(desc)}
    perm = [cur_pos[qubits[k - 1 - j]] for j in range(k)]
    return marg.transpose(perm).reshape((-1,)).astype(config.real_dtype())


def sample(state: jnp.ndarray, qubits: Sequence[int], shots: int,
           key: jax.Array) -> jnp.ndarray:
    """Draw ``shots`` outcomes from the marginal over ``qubits``.

    Analog of rocsvSample (hipStateVec.h decl; QuantumSimulator::measure
    simulator.cpp:153-184), with the host discrete_distribution replaced by
    an on-device Gumbel categorical draw.
    """
    marg = marginal_probs(state, qubits)
    logits = jnp.log(jnp.maximum(marg, 1e-38))
    return jax.random.categorical(key, logits, shape=(shots,)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Expectation values
# ---------------------------------------------------------------------------

def expval_z(state: jnp.ndarray, qubit: int) -> jnp.ndarray:
    """<Z_q> = P(0) - P(1) (rocsvGetExpectationValueZ, hipStateVec.h:340)."""
    return 1.0 - 2.0 * prob_one(state, qubit)


def expval_pauli_product_z(state: jnp.ndarray, qubits: Sequence[int]) -> jnp.ndarray:
    """<Z_{q1} Z_{q2} ...> via parity-weighted probabilities
    (calculate_multi_z_probabilities_kernel, measurement_kernels.hip:283-354,
    without the k<=8 histogram cap)."""
    n = num_qubits_of(state)
    desc = sorted(set(qubits), reverse=True)
    dims = _exposed_view_dims(n, desc)
    probs = _abs2(state).reshape(dims)
    sign = jnp.asarray([1.0, -1.0], dtype=probs.dtype)
    for i in range(len(desc)):
        shape = [1] * len(dims)
        shape[2 * i + 1] = 2
        probs = probs * sign.reshape(shape)
    return jnp.sum(probs).astype(config.real_dtype())


def apply_pauli_string(state: jnp.ndarray, ops: Sequence[tuple]) -> jnp.ndarray:
    """Apply a product of single-qubit Paulis [(char, qubit), ...]."""
    for pauli_char, q in ops:
        if pauli_char == "I":
            continue
        state = apply_matrix(state, _mat(pauli_char, state.dtype), [q])
    return state


# (P psi)_i = c(i) psi_{i xor F} for the X/Y qubits F; c depends on the
# OUTPUT bit of each Y (Y|1> = -i|0>, Y|0> = i|1>) and Z qubit
_PAULI_OUT_PHASE = {"Y": (-1j, 1j), "Z": (1.0, -1.0)}


def expval_pauli_string(state: jnp.ndarray, ops: Sequence[tuple]) -> jnp.ndarray:
    """<psi| P |psi> for a general Pauli string (rocsvGetExpectationPauliString,
    hipStateVec.h decl) in ONE read of the state: the X/Y bit flips are
    reversals of exposed size-2 axes, which XLA fuses into the reduction,
    so no state-sized copy of P|psi> is made (a Hamiltonian's terms would
    otherwise each hold one). Strings naming a qubit twice take the
    apply-then-vdot form."""
    paulis = {q: p for p, q in ops if p != "I"}
    if len(paulis) != sum(1 for p, _ in ops if p != "I"):
        phi = apply_pauli_string(state, ops)
        return jnp.real(jnp.vdot(state, phi)).astype(config.real_dtype())
    n = num_qubits_of(state)
    desc = sorted(paulis, reverse=True)
    dims = _exposed_view_dims(n, desc)
    st = state.reshape(dims)
    flip = [2 * i + 1 for i, q in enumerate(desc) if paulis[q] in "XY"]
    moved = jnp.flip(st, axis=flip) if flip else st
    for i, q in enumerate(desc):
        if paulis[q] in _PAULI_OUT_PHASE:
            shape = [1] * len(dims)
            shape[2 * i + 1] = 2
            moved = moved * jnp.asarray(_PAULI_OUT_PHASE[paulis[q]],
                                        state.dtype).reshape(shape)
    return jnp.real(jnp.sum(jnp.conj(st) * moved)).astype(config.real_dtype())


def expval_x(state: jnp.ndarray, qubit: int) -> jnp.ndarray:
    return expval_pauli_string(state, [("X", qubit)])


def expval_y(state: jnp.ndarray, qubit: int) -> jnp.ndarray:
    return expval_pauli_string(state, [("Y", qubit)])


def apply_matrix_and_measure(state: jnp.ndarray, matrix: jnp.ndarray,
                             targets: Sequence[int], measure_qubit: int):
    """Apply a matrix then return (state, P(measure_qubit = 1)) in one
    program (rocsvApplyMatrixAndMeasure decl, hipStateVec.h)."""
    state = apply_matrix(state, matrix, targets)
    return state, prob_one(state, measure_qubit)


def state_slice_parts(state: jnp.ndarray, start: int, size: int):
    """(real, imag) of amplitudes [start, start+size) — the
    rocsvGetStateVectorSlice analog (hipStateVec.cpp:691-730) without
    pulling the full 2^n vector to host."""
    sl = jax.lax.dynamic_slice(state, (start,), (size,))
    return jnp.real(sl), jnp.imag(sl)


# ---------------------------------------------------------------------------
# Host boundary helpers
# ---------------------------------------------------------------------------

def state_to_parts(state: jnp.ndarray):
    """Split a complex state into a (real, imag) float pair for host readback
    (rocsvGetStateVectorFull analog, hipStateVec.cpp:691)."""
    return jnp.real(state), jnp.imag(state)


def parts_to_state(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    return config.complex_from_parts(re, im)


# ---------------------------------------------------------------------------
# Jitted host entry points (static circuit metadata, dynamic state)
# ---------------------------------------------------------------------------

prob_one_jit = jax.jit(prob_one, static_argnums=(1,))
collapse_jit = jax.jit(collapse, static_argnums=(1, 2))
expval_z_jit = jax.jit(expval_z, static_argnums=(1,))
marginal_probs_jit = jax.jit(marginal_probs, static_argnames=("qubits",))
sample_jit = jax.jit(sample, static_argnames=("qubits", "shots"))
expval_pauli_product_z_jit = jax.jit(expval_pauli_product_z, static_argnames=("qubits",))
expval_pauli_string_jit = jax.jit(expval_pauli_string, static_argnames=("ops",))
state_to_parts_jit = jax.jit(state_to_parts)
state_slice_parts_jit = jax.jit(state_slice_parts, static_argnums=(1, 2))
