"""Kernel recording and execution for the rocq DSL.

The reference's kernel.py was an unfinished fragment (referenced
``_KernelBuildContext`` never defined); the contract implemented here is the
one its tests pin down (reference tests/test_framework.py):

* ``@rocq.kernel`` produces a :class:`QuantumKernel` with ``.name`` and
  ``.gate_sequence`` populated at decoration time (parameters appear as
  symbolic placeholders);
* ``rocq.execute(kernel, backend=..., noise_model=..., **params)`` runs the
  kernel on the 'state_vector' or 'density_matrix' backend, applying the
  noise model's channels after matching gates.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional

from .qvec import qvec


class Param:
    """Symbolic kernel parameter, bound at execute() time by name."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Param({self.name!r})"

    # arithmetic on symbolic params is resolved lazily
    def _binop(self, other, op):
        return _Expr(self, other, op)

    def __mul__(self, other):
        return self._binop(other, "mul")

    __rmul__ = __mul__

    def __add__(self, other):
        return self._binop(other, "add")

    __radd__ = __add__

    def __neg__(self):
        return _Expr(self, -1.0, "mul")

    def __sub__(self, other):
        return _Expr(self, other, "sub")

    def __getitem__(self, idx):
        return _Index(self, idx)

    def resolve(self, bindings: Dict[str, float]):
        try:
            return bindings[self.name]
        except KeyError:
            raise ValueError(f"Kernel parameter '{self.name}' was not bound "
                             f"at execute() time.")


class _Expr:
    def __init__(self, a, b, op):
        self.a, self.b, self.op = a, b, op

    def resolve(self, bindings):
        a = self.a.resolve(bindings) if hasattr(self.a, "resolve") else self.a
        b = self.b.resolve(bindings) if hasattr(self.b, "resolve") else self.b
        if self.op == "mul":
            return a * b
        if self.op == "add":
            return a + b
        if self.op == "sub":
            return a - b
        raise ValueError(self.op)


class _Index:
    """Symbolic indexing into a sequence-valued parameter
    (``params[0]`` in a recorded kernel body)."""

    def __init__(self, base, idx):
        self.base, self.idx = base, idx

    def resolve(self, bindings):
        return self.base.resolve(bindings)[self.idx]


def _resolve(value, bindings):
    if hasattr(value, "resolve"):
        return value.resolve(bindings)
    return value


class _KernelBuildContext:
    """Active recording context; the free gate functions in gates.py append
    into it (reference rocq/gates.py:5 imports this symbol)."""

    _active: Optional["_KernelBuildContext"] = None

    def __init__(self):
        self.gate_sequence: List[dict] = []
        self.num_qubits = 0

    def register_qvec(self, qv: qvec):
        self.num_qubits += qv.size

    @classmethod
    def add_gate(cls, name: str, targets: List[int], params: Dict = None):
        ctx = cls._active
        if ctx is None:
            raise RuntimeError(
                "Gate functions may only be called inside a @rocq.kernel "
                "function while it is being recorded.")
        ctx.gate_sequence.append(
            {"op": name.lower(), "targets": list(targets),
             "params": dict(params) if params else {}})

    def __enter__(self):
        _KernelBuildContext._active = self
        qvec._current_kernel_context = self
        return self

    def __exit__(self, *exc):
        _KernelBuildContext._active = None
        qvec._current_kernel_context = None
        return False


class QuantumKernel:
    """A recorded kernel: name, qubit count, gate sequence with symbolic
    parameters (reference rocq/kernel.py QuantumKernel + test contract)."""

    def __init__(self, func):
        self._func = func
        self.name = func.__name__
        sig = inspect.signature(func)
        self.param_names = list(sig.parameters.keys())
        with _KernelBuildContext() as ctx:
            func(*[Param(p) for p in self.param_names])
        self.gate_sequence = ctx.gate_sequence
        # qvec-registered size, or inferred from raw gate targets (the
        # rocquantum-flavor kernels of examples/vqe_h2.py address qubits
        # directly without a qvec)
        max_target = max((t for g in self.gate_sequence
                          for t in g["targets"]
                          if isinstance(t, (int,))), default=-1)
        self.num_qubits = max(ctx.num_qubits, max_target + 1)

    def bound_sequence(self, bindings: Dict[str, float]) -> List[dict]:
        out = []
        for g in self.gate_sequence:
            out.append({
                "op": g["op"],
                "targets": g["targets"],
                "params": {k: _resolve(v, bindings)
                           for k, v in g["params"].items()},
            })
        return out

    def ir(self):
        """Lower to the shared CircuitIR (unbound params unsupported)."""
        from ..compiler.ir import CircuitIR
        ir = CircuitIR(self.num_qubits, name=self.name)
        for g in self.gate_sequence:
            params = list(g["params"].values())
            ir.add(g["op"], g["targets"], params=params)
        return ir

    def mlir(self, **kwargs) -> str:
        """Textual IR dump (the reference's conceptual-MLIR hook,
        rocq/kernel.py mlir())."""
        return self.ir().dump()

    def qir(self, **kwargs) -> str:
        """QIR (LLVM IR) text with __quantum__qis__<name>__body calls —
        the reference contract (rocq/kernel.py:6-17 via
        SimulatorToQIRPass.cpp:33-40, checked by example.py:21-27)."""
        from ..compiler.qir import emit_qir_text
        return emit_qir_text(self.ir())

    def stablehlo(self, **kwargs) -> str:
        """StableHLO text of the jitted simulation program (the JAX
        'compile to the execution format')."""
        import jax
        from ..ops import statevec as sv
        from ..compiler.interpreter import execute as _exec

        ir = self.ir()
        n = max(ir.num_qubits, 1)

        def program():
            state = sv.init_state(n)
            return _exec(state, ir.ops, None)

        return jax.jit(program).lower().as_text()

    def execute(self, backend="state_vector", **kwargs):
        return execute(self, backend=backend, **kwargs)

    def __repr__(self):
        return (f"<QuantumKernel name='{self.name}' qubits={self.num_qubits} "
                f"gates={len(self.gate_sequence)}>")


def kernel(func) -> QuantumKernel:
    """Decorator: record ``func`` into a QuantumKernel at decoration time."""
    return QuantumKernel(func)


def execute(kern: QuantumKernel, backend: str = "state_vector",
            noise_model=None, shots: Optional[int] = None, seed: int = 0,
            **param_bindings):
    """Execute a kernel on a simulation backend, applying ``noise_model``
    channels after matching gates; returns the backend's final state (or
    shot counts when ``shots`` is given)."""
    from .backends import get_backend

    if not isinstance(kern, QuantumKernel):
        raise TypeError("execute() expects a @rocq.kernel QuantumKernel.")
    be = get_backend(backend, max(kern.num_qubits, 1))
    if noise_model is not None and noise_model.get_channels():
        # hard constraint mirrored from the reference
        # (rocq/backends.py StateVectorBackend.apply_noise)
        be.validate_noise_support()

    for g in kern.bound_sequence(param_bindings):
        be.apply_gate(g["op"], g["targets"], g["params"])
        if noise_model is not None:
            for ch in noise_model.get_channels():
                if ch["op"] is not None and ch["op"] != g["op"]:
                    continue
                targets = ch["qubits"] if ch["qubits"] is not None else g["targets"]
                be.apply_noise(ch["type"], targets, ch["prob"])

    if shots is not None:
        return be.sample(list(range(kern.num_qubits)), shots, seed=seed)
    return be.get_state()
