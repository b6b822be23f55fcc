"""QIR (LLVM IR) text emission over CircuitIR.

The reference's declared compiler output is LLVM IR whose quantum
operations are calls to QIR-mangled intrinsics
``__quantum__qis__<name>__body`` taking opaque ``%Qubit*`` arguments
(reference: rocqCompiler/passes/SimulatorToQIRPass.cpp:33-40; verified by
example.py:21-27, which greps the emitted text for
``call void @__quantum__qis__h__body``). This module is the JAX rebuild's
equivalent of that pass: a direct pretty-printer from :class:`CircuitIR`
to QIR base-profile-shaped LLVM IR text. It exists for interchange and
verification parity — execution lowers through XLA
(compiler/interpreter.py), never through this text.

Conventions (standard QIR static-qubit encoding):
  * qubit ``k`` prints as ``%Qubit* inttoptr (i64 k to %Qubit*)``
    (``null`` for qubit 0);
  * parametrized gates take leading ``double`` arguments; symbolic
    :class:`ParamRef` slots become function parameters ``double %p<i>``;
  * an adjoint gate calls ``__quantum__qis__<name>__adj``;
  * a controlled gate without a dedicated named form folds its controls
    into the argument list under the ``c``-prefixed mangled name (one
    ``c`` per control), matching the reference's name-string scheme where
    "cnot"/"cz" are themselves gate names.
"""

from __future__ import annotations

from typing import List

from .ir import CircuitIR, GateOp, ParamRef

# IR names that already encode their controls in the mangled name: the
# controls live in GateOp.controls but the QIR name needs no 'c' prefix.
_SELF_CONTROLLED = {
    "CNOT": "cnot", "CX": "cnot", "CZ": "cz", "CY": "cy", "CH": "ch",
    "CRX": "crx", "CRY": "cry", "CRZ": "crz", "CSWAP": "cswap",
    "CCX": "ccx", "TOFFOLI": "ccx", "MCX": None,  # name depends on arity
    "CPHASE": "cphase", "CP": "cphase",
}


def _qubit_arg(k: int) -> str:
    if k == 0:
        return "%Qubit* null"
    return f"%Qubit* inttoptr (i64 {k} to %Qubit*)"


def _double_lit(v: float) -> str:
    return f"double {float(v):e}"


def _mangle(op: GateOp) -> str:
    """QIR intrinsic base name for a gate op (no __quantum__qis__ wrap)."""
    name = op.name.upper()
    if name in _SELF_CONTROLLED:
        base = _SELF_CONTROLLED[name]
        if base is None:  # MCX: cnot / ccx / cccx ... by control count
            base = "c" * max(len(op.controls), 1) + "x"
            if base == "cx":
                base = "cnot"
        return base
    base = name.lower()
    if op.controls:
        base = "c" * len(op.controls) + base
    return base


def emit_qir_text(ir: CircuitIR) -> str:
    """Render the circuit as QIR-shaped LLVM IR text."""
    n_params = ir.num_params
    fn_args = ", ".join(f"double %p{i}" for i in range(n_params))
    body: List[str] = []
    decls = {}
    for op in ir.ops:
        base = _mangle(op)
        suffix = "adj" if op.is_adjoint else "body"
        fname = f"__quantum__qis__{base}__{suffix}"
        args = []
        for p in op.params:
            if isinstance(p, ParamRef):
                args.append(f"double %p{p.index}")
            else:
                args.append(_double_lit(p))
        qubits = tuple(op.controls) + tuple(op.targets)
        args.extend(_qubit_arg(q) for q in qubits)
        sig = ", ".join(
            ("double" if a.startswith("double") else "%Qubit*")
            for a in args)
        decls.setdefault(fname, sig)
        body.append(f"  call void @{fname}({', '.join(args)})")

    lines = [
        f"; ModuleID = '{ir.name}'",
        "%Qubit = type opaque",
        "%Result = type opaque",
        "",
        f"define void @{ir.name}({fn_args}) #0 {{",
        "entry:",
        *body,
        "  ret void",
        "}",
        "",
    ]
    for fname, sig in decls.items():
        lines.append(f"declare void @{fname}({sig})")
    lines += [
        "",
        'attributes #0 = { "entry_point" "qir_profiles"="base_profile" '
        f'"required_num_qubits"="{ir.num_qubits}" }}',
        "",
    ]
    return "\n".join(lines)
