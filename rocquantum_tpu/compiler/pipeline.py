"""Compiler pipeline facade.

API-parity rebuild of the reference's two MLIRCompiler classes
(reference: rocqCompiler/MLIRCompiler.cpp:47-88 — emit_qir running
QuantumToSimulator + SimulatorToQIR + LLVM lowering; and
rocquantum/src/rocqCompiler/MLIRCompiler.cpp:26-127 —
initializeModule/loadModuleFromString/getModuleString/dump; plus the
run_adjoint_generation_pass binding, python/rocq/bindings.cpp:701).

The JAX lowering pipeline is circuit-IR -> (fusion, adjoint) passes
-> jitted XLA program; "QIR emission" becomes StableHLO text (the portable
compiler-exchange format of the XLA stack), and the textual circuit IR
plays the MLIR-module role.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import config
from .ir import CircuitIR
from .passes import adjoint_ir, plan_fusion
from .interpreter import compile_ir


class Compiler:
    """Module-holder + pass-runner + lowering entry points."""

    def __init__(self, num_qubits: int = 0, backend_name: str = "statevec"):
        self.backend_name = backend_name
        self.module: Optional[CircuitIR] = None
        if num_qubits:
            self.initialize_module("module", num_qubits)

    # -- module management (C6 parity) --------------------------------------

    def initialize_module(self, name: str, num_qubits: int = 0) -> bool:
        self.module = CircuitIR(num_qubits, name=name)
        return True

    def load_module(self, ir: CircuitIR) -> bool:
        self.module = ir
        return True

    def load_module_from_string(self, text: str) -> bool:
        """Parse a textual module. OpenQASM 3 is the accepted exchange
        syntax (the reference parsed its conceptual-MLIR strings)."""
        try:
            from .qasm_parser import parse_qasm3
            self.module = parse_qasm3(text)
            return True
        except ValueError:
            return False

    def get_module_string(self) -> str:
        if self.module is None:
            return ""
        return self.module.dump()

    def dump_module(self):
        print(self.get_module_string())

    # -- passes (C3/C4/C7 parity) --------------------------------------------

    def run_adjoint_generation_pass(self) -> bool:
        """Append the adjoint of the current module (AdjointGeneration.cpp
        semantics: clone reversed with is_adjoint toggled)."""
        if self.module is None:
            return False
        self.adjoint_module = adjoint_ir(self.module)
        return True

    def run_fusion_pass(self, max_fuse: int = 2):
        """Return the fusion plan for inspection (GateFusion::processQueue
        analog)."""
        if self.module is None:
            return []
        return plan_fusion(list(self.module.ops), max_fuse=max_fuse)

    # -- lowering (C5 parity) --------------------------------------------------

    def emit_qir(self, text: Optional[str] = None) -> str:
        """Emit QIR-shaped LLVM IR text: ``call void
        @__quantum__qis__<name>__body(...)`` per gate — the reference's
        declared output contract (SimulatorToQIRPass.cpp:33-40, verified
        by example.py:21-27). For the XLA-stack portable IR of the
        EXECUTABLE program use :meth:`emit_stablehlo`."""
        if text is not None:
            if not self.load_module_from_string(text):
                raise ValueError("failed to parse module text")
        if self.module is None:
            raise RuntimeError("no module loaded")
        from .qir import emit_qir_text
        return emit_qir_text(self.module)

    def emit_stablehlo(self, text: Optional[str] = None) -> str:
        """Lower to StableHLO text — the XLA stack's portable IR of the
        jitted simulation program (the role LLVM played in the reference's
        emit_qir, rocqCompiler/MLIRCompiler.cpp:47-79)."""
        if text is not None:
            if not self.load_module_from_string(text):
                raise ValueError("failed to parse module text")
        if self.module is None:
            raise RuntimeError("no module loaded")
        import jax
        import jax.numpy as jnp
        from ..ops import statevec as sv

        ir = self.module
        n = max(ir.num_qubits, 1)
        n_params = ir.num_params

        def program(params):
            from .interpreter import execute
            state = sv.init_state(n)
            return execute(state, ir.ops, params)

        params = jnp.zeros((n_params,), config.real_dtype())
        return jax.jit(program).lower(params).as_text()

    def compile(self, fuse: bool = True, donate: bool = True):
        """Compile the module to an executable f(state, params) -> state."""
        if self.module is None:
            raise RuntimeError("no module loaded")
        return compile_ir(self.module, fuse=fuse, donate=donate)


# Reference-compat alias (bindings exposed the class as MLIRCompiler)
MLIRCompiler = Compiler
