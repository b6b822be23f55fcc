"""rocquantum_tpu — a JAX quantum computing framework.

A ground-up JAX/XLA rebuild with the capabilities of rocQuantum
(CUDA-Q-inspired ROCm/HIP simulator suite): state-vector, density-matrix and
tensor-network simulation engines, a circuit-trace compiler with adjoint
generation, VQE/QEC application layers, Qiskit/Cirq/PennyLane device plugins,
and a cloud-QPU backend abstraction.
"""

from . import config
from .config import set_precision, get_precision

from .api import (  # noqa: F401
    Simulator,
    Circuit,
    PauliOperator,
    QuantumProgram,
    CompiledProgram,
    compile_program,
    Kernel,
    kernel,
    build,
    get_expval,
    adjoint,
    grad,
    adjoint_grad,
    make_energy_fn,
    trace_kernel,
)

__version__ = "0.1.0"
