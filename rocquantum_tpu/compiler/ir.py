"""Circuit intermediate representation.

JAX replacement for the reference's MLIR compiler stack: the
``quantum`` dialect (rocqCompiler/QuantumOps.td,
rocquantum/include/rocquantum/Dialect/QuantumOps.td — GenericGateOp with
``gate_name`` and ``is_adjoint`` attrs, MeasureOp, IfOp) and the ``sim``
dialect (SimulatorOps.td — apply_gate / apply_param_gate). Here a circuit is
a flat list of :class:`GateOp` records; "lowering" is tracing the list into a
jitted XLA program (compiler/interpreter.py), which plays the role of the
QIR/LLVM emission path (MLIRCompiler.cpp:47-88).

Parameters may be concrete floats or :class:`ParamRef` slots; programs
compiled from an IR with ParamRefs take a parameter vector as a runtime
input, so re-running with new parameters (VQE inner loop) hits the
compilation cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class ParamRef:
    """A symbolic reference to entry ``index`` of the program's parameter
    vector (analog of the f64 param operand of sim.apply_param_gate,
    SimulatorOps.td:25-29)."""
    index: int

    def __repr__(self):
        return f"%p{self.index}"


ParamLike = Union[float, ParamRef]


@dataclasses.dataclass(frozen=True)
class GateOp:
    """One gate application (quantum.GenericGateOp analog,
    rocquantum/include/rocquantum/Dialect/QuantumOps.td:55-78)."""
    name: str
    targets: Tuple[int, ...]
    controls: Tuple[int, ...] = ()
    params: Tuple[ParamLike, ...] = ()
    # Dense unitary for generic apply_unitary ops; stored as a host numpy
    # array (hashable via tobytes for the compile cache).
    matrix: Optional[np.ndarray] = None
    is_adjoint: bool = False

    def structural_key(self):
        """Hashable key ignoring concrete parameter values (so programs that
        differ only in parameters share one compiled executable). Memoized
        per instance — flows that reuse op objects (IR replays, flush-plan
        keys, update_params loops) hash once; ``dataclasses.replace``
        creates fresh instances, so the cache cannot go stale."""
        cached = getattr(self, "_skey", None)
        if cached is not None:
            return cached
        mat_key = None
        if self.matrix is not None:
            mat_key = (self.matrix.shape, self.matrix.tobytes())
        param_key = tuple(
            p if isinstance(p, ParamRef) else ("dyn",) for p in self.params
        )
        key = (self.name, self.targets, self.controls, param_key, mat_key,
               self.is_adjoint)
        object.__setattr__(self, "_skey", key)
        return key

    def __repr__(self):
        parts = [f'gate_name = "{self.name}"']
        if self.is_adjoint:
            parts.append("is_adjoint")
        args = ", ".join(f"%q{t}" for t in self.targets)
        ctrl = (" ctrl(" + ", ".join(f"%q{c}" for c in self.controls) + ")"
                if self.controls else "")
        par = (" params = [" + ", ".join(map(str, self.params)) + "]"
               if self.params else "")
        return f'rocq.gate({args}){ctrl} {{ {", ".join(parts)}{par} }}'


@dataclasses.dataclass
class CircuitIR:
    """A traced circuit: the unit the compiler lowers to one XLA program."""
    num_qubits: int
    ops: list = dataclasses.field(default_factory=list)
    name: str = "circuit"

    def add(self, name: str, targets: Sequence[int],
            controls: Sequence[int] = (), params: Sequence[ParamLike] = (),
            matrix: Optional[np.ndarray] = None, is_adjoint: bool = False):
        self.ops.append(GateOp(name.upper(), tuple(targets), tuple(controls),
                               tuple(params), matrix, is_adjoint))

    def structural_key(self):
        return (self.num_qubits, tuple(op.structural_key() for op in self.ops))

    @property
    def num_params(self) -> int:
        mx = -1
        for op in self.ops:
            for p in op.params:
                if isinstance(p, ParamRef):
                    mx = max(mx, p.index)
        return mx + 1

    def dump(self) -> str:
        """Textual IR (the analog of MLIR module printing,
        MLIRCompiler.cpp getModuleString)."""
        lines = [f"rocq.func @{self.name}(%q0..%q{self.num_qubits - 1})" + " {"]
        for op in self.ops:
            lines.append(f"  {op!r}")
        lines.append("  rocq.return")
        lines.append("}")
        return "\n".join(lines)

    def __repr__(self):
        return self.dump()
