"""Backend registry: set_target / get_active_backend.

API-parity rebuild of reference rocquantum/core.py:13-56, plus a ``local``
target that runs on the in-process simulator.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Type

from .backends.base import RocqBackend

_AVAILABLE_BACKENDS: Dict[str, str] = {
    # --- Implemented Backends ---
    "ionq": "rocquantum_tpu.backends.ionq.IonQBackend",
    "infleqtion": "rocquantum_tpu.backends.infleqtion.InfleqtionBackend",
    "pasqal": "rocquantum_tpu.backends.pasqal.PasqalBackend",
    "quantinuum": "rocquantum_tpu.backends.quantinuum.QuantinuumBackend",
    "qristal": "rocquantum_tpu.backends.qristal.QuantumBrillianceBackend",
    "rigetti": "rocquantum_tpu.backends.rigetti.RigettiBackend",
    "local": "rocquantum_tpu.backends.local.LocalTPUBackend",
    # --- Promoted Type A clients (skeletons in the reference) ---
    "iqm": "rocquantum_tpu.backends.iqm.IQMBackend",
    "xanadu": "rocquantum_tpu.backends.xanadu.XanaduBackend",
    "quera": "rocquantum_tpu.backends.quera.QuEraBackend",
    "orca": "rocquantum_tpu.backends.orca.OrcaBackend",
    "seeqc": "rocquantum_tpu.backends.seeqc.SeeqcBackend",
    "quantum_machines":
        "rocquantum_tpu.backends.quantum_machines.QuantumMachinesBackend",
    "alice_bob": "rocquantum_tpu.backends.alice_bob.AliceBobBackend",
}

_ACTIVE_BACKEND: Optional[RocqBackend] = None


def set_target(name: str, **kwargs) -> None:
    """Select, instantiate, and authenticate a quantum backend."""
    global _ACTIVE_BACKEND
    if name not in _AVAILABLE_BACKENDS:
        raise ValueError(
            f"Backend '{name}' not recognized. Available: "
            f"{list(_AVAILABLE_BACKENDS.keys())}")
    import_path = _AVAILABLE_BACKENDS[name]
    try:
        module_path, class_name = import_path.rsplit(".", 1)
        module = importlib.import_module(module_path)
        backend_class: Type[RocqBackend] = getattr(module, class_name)
    except (ImportError, AttributeError) as e:
        raise ImportError(
            f"Could not import backend class '{import_path}': {e}")
    instance = backend_class(**kwargs)
    instance.authenticate()
    _ACTIVE_BACKEND = instance


def get_active_backend() -> RocqBackend:
    """Retrieve the currently active backend instance."""
    if _ACTIVE_BACKEND is None:
        raise RuntimeError("No active backend. Call set_target() first.")
    return _ACTIVE_BACKEND


def available_backends():
    return list(_AVAILABLE_BACKENDS)
