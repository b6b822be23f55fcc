"""IR transformation passes.

- :func:`adjoint_ir` — the adjoint-generation transform: clone ops in reverse
  order toggling each gate's ``is_adjoint`` flag (the JAX equivalent of
  the reference AdjointGenerationPass,
  rocquantum/src/rocqCompiler/Transforms/AdjointGeneration.cpp:26-110).
- :func:`plan_fusion` — trace-time gate fusion: group adjacent gates whose
  combined qubit support fits in ``max_fuse`` qubits so they apply as one
  matrix in a single pass over the amplitudes (generalizes the reference's
  GateFusion absorb-1q-into-CNOT scheme, GateFusion.cpp:89-156 — and fixes
  its qubit-ordering bug, which SURVEY flags as not-spec). Grouping is
  static; the fused matrices are computed inside the traced program so
  parameterized gates fuse too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .ir import CircuitIR, GateOp


def adjoint_ir(ir: CircuitIR) -> CircuitIR:
    """Return the adjoint circuit: reversed op order, each op daggered."""
    out = CircuitIR(ir.num_qubits, name=f"{ir.name}.adj")
    for op in reversed(ir.ops):
        out.ops.append(dataclasses.replace(op, is_adjoint=not op.is_adjoint))
    return out


@dataclasses.dataclass
class FusedBlock:
    """A run of gates applied as one dense matrix over ``qubits``."""
    qubits: Tuple[int, ...]  # sorted ascending; bit k of the fused matrix
    ops: List[GateOp]


@dataclasses.dataclass
class DiagBlock:
    """A run of diagonal gates applied as ONE elementwise pass: each member
    contributes a broadcastable phase factor; XLA fuses the multiply chain.
    Any number of members on any qubits costs a single HBM pass — the QFT's
    controlled-phase cascade collapses to one pass per layer."""
    ops: List[GateOp]

    @property
    def qubits(self) -> Tuple[int, ...]:
        s = set()
        for op in self.ops:
            s |= set(op.targets) | set(op.controls)
        return tuple(sorted(s))


# Diagonal named gates (incl. implicitly-controlled forms: a controlled
# diagonal is diagonal).
_DIAGONAL_NAMES = {"Z", "S", "SDG", "T", "TDG", "RZ", "P", "PHASE",
                   "CZ", "CRZ", "RZZ"}


def is_diagonal(op: GateOp) -> bool:
    if op.name.upper() == "D2M":
        # generic 2q diagonal: op.matrix holds the 2x2 of diagonal VALUES
        # d[bit_t0, bit_t1] (diagonal channel superops lower to this)
        return True
    return (op.matrix is None and op.name.upper() in _DIAGONAL_NAMES)


def fuse_diagonals(ops: List[object]) -> List[object]:
    """Group consecutive diagonal gates into DiagBlocks; non-diagonal ops on
    disjoint qubits commute past an open block."""
    out: List[object] = []
    block: DiagBlock = None

    def flush():
        nonlocal block
        if block is not None:
            # singletons stay DiagBlocks: the elementwise phase multiply is
            # one pass, where a lone controlled phase would otherwise take
            # the dense controlled-slice path
            out.append(block)
            block = None

    for op in ops:
        if isinstance(op, GateOp) and is_diagonal(op):
            if block is None:
                block = DiagBlock(ops=[])
            block.ops.append(op)
        else:
            if isinstance(op, (FusedBlock, DiagBlock)):
                support = set(op.qubits)
            else:
                support = set(op.targets) | set(op.controls)
            if block is not None and support & set(block.qubits):
                flush()
            out.append(op)
    flush()
    return out


def _support(op: GateOp) -> Tuple[int, ...]:
    return tuple(sorted(set(op.targets) | set(op.controls)))


def plan_fusion(ops: List[GateOp], max_fuse: int = 2) -> List[object]:
    """Group ops into FusedBlocks / passthrough GateOps.

    Greedy single-pass scheme: maintain open blocks with pairwise-disjoint
    qubit supports (disjoint unitaries commute, so emission order among them
    is free). An op joins an open block when it intersects exactly that block
    and the union support fits in ``max_fuse`` qubits. Ops with larger
    support (e.g. MCX with many controls) pass through unfused, flushing the
    blocks they touch, preserving the controlled slice-update fast path.
    """
    if max_fuse < 1:
        return list(ops)

    emitted: List[object] = []
    open_blocks: List[FusedBlock] = []

    def flush(blocks):
        for b in blocks:
            open_blocks.remove(b)
            if len(b.ops) == 1:
                emitted.append(b.ops[0])  # keep original (controlled) form
            else:
                emitted.append(b)

    for op in ops:
        if isinstance(op, DiagBlock):
            flush([b for b in open_blocks if set(b.qubits) & set(op.qubits)])
            emitted.append(op)
            continue
        q = _support(op)
        if len(q) > max_fuse or op.name in ("SWAP_BITS",
                                            "PERMUTE_BITS"):
            # SWAP_BITS is a layout relabel, not a unitary to fuse — it must
            # stay a transpose so sharded states reshard via all-to-all
            flush([b for b in open_blocks if set(b.qubits) & set(q)])
            emitted.append(op)
            continue
        touching = [b for b in open_blocks if set(b.qubits) & set(q)]
        if len(touching) == 1:
            b = touching[0]
            union = tuple(sorted(set(b.qubits) | set(q)))
            if len(union) <= max_fuse:
                b.qubits = union
                b.ops.append(op)
                continue
        elif not touching:
            # Disjoint from every open block: blocks are pairwise disjoint
            # (they commute), so the op may join any block with room —
            # kron-fusing independent gates into one pass. Prefer the
            # fullest block that still fits.
            candidates = [b for b in open_blocks
                          if len(b.qubits) + len(q) <= max_fuse]
            if candidates:
                b = max(candidates, key=lambda b: len(b.qubits))
                b.qubits = tuple(sorted(set(b.qubits) | set(q)))
                b.ops.append(op)
                continue
            open_blocks.append(FusedBlock(qubits=q, ops=[op]))
            continue
        flush(touching)
        open_blocks.append(FusedBlock(qubits=q, ops=[op]))

    flush(list(open_blocks))
    return emitted


def _consolidate_region(items: List[object], region: set,
                        block_qubits: tuple) -> List[object]:
    """Merge consecutive items supported inside ``region`` into FusedBlocks
    over ``block_qubits``; region-disjoint items pass through (commute)."""
    out: List[object] = []
    open_block = None

    def support(item):
        if isinstance(item, (FusedBlock, DiagBlock)):
            return set(item.qubits)
        return set(item.targets) | set(item.controls)

    def members(item):
        return item.ops if isinstance(item, (FusedBlock, DiagBlock)) \
            else [item]

    def flush():
        nonlocal open_block
        if open_block is not None:
            out.append(open_block)
            open_block = None

    for item in items:
        s = support(item)
        is_relabel = (not isinstance(item, (FusedBlock, DiagBlock))
                      and item.name in ("SWAP_BITS", "PERMUTE_BITS"))
        if s <= region and not is_relabel:
            if open_block is None:
                open_block = FusedBlock(qubits=block_qubits, ops=[])
            open_block.ops.extend(members(item))
        elif s & region or is_relabel:
            flush()
            out.append(item)
        else:
            out.append(item)
    flush()
    return out


def consolidate_low(items: List[object], width: int) -> List[object]:
    """Second fusion stage: merge consecutive items whose qubit support lies
    entirely in {0..width-1} into one FusedBlock over all ``width`` low
    qubits. That block applies as a single (R, 2^width) @ W matmul with
    contiguous rows, where the per-qubit einsum on the lowest index bits
    reads strided. Items fully above the low region commute with the
    open block and pass through without flushing it.
    """
    if width < 1:
        return list(items)
    # single-member blocks are kept: widening a lone low-qubit gate to the
    # full 2^width matmul stays memory-bound and coalesced, while the
    # narrow form is the slow path
    return _consolidate_region(items, set(range(width)),
                               tuple(range(width)))


def consolidate_high(items: List[object], width: int, n: int) -> List[object]:
    """Mirror of consolidate_low for the TOP ``width`` qubits: merged runs
    apply as one (2^width, 2^width) @ (2^width, R) left-matmul."""
    if width < 1:
        return list(items)
    return _consolidate_region(items, set(range(n - width, n)),
                               tuple(range(n - width, n)))
