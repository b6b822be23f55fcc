"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Mirrors the reference's multi-GPU test strategy (test_hipStateVec_multi_gpu.cpp
runs on however many GPUs exist) without requiring hardware: XLA's host
platform is forced to expose 8 devices so sharded-statevector tests exercise
real collectives. The platform is switched through jax.config as well as
the environment, in case jax was imported before this file ran.

Tests marked ``chip`` need the GPU. They run only when the suite is started
with ``JAX_PLATFORMS=cuda`` (e.g. ``JAX_PLATFORMS=cuda python -m pytest -m
chip tests/``), and skip otherwise; the ``gpu_backend`` fixture decides.
"""

import os

_ON_CARD = os.environ.get("JAX_PLATFORMS", "cpu") in ("cuda", "gpu")

if not _ON_CARD:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (tests marked ``chip``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run with JAX_PLATFORMS=cuda on the card")

# Ecosystem-plugin testing: when qiskit/cirq/pennylane are absent, expose the
# minimal in-repo API stubs (tests/_stubs) so the integration translation
# layers EXECUTE instead of skipping (the reference's plugin tests skipped
# whenever the native module was missing; the rebuild does better).
import importlib.util  # noqa: E402

_STUBS = os.path.join(os.path.dirname(__file__), "_stubs")
if any(importlib.util.find_spec(m) is None
       for m in ("qiskit", "cirq", "pennylane")):
    import sys
    if _STUBS not in sys.path:
        sys.path.append(_STUBS)  # append: real installs always win
