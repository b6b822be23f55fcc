"""Global configuration for rocquantum_tpu.

Replaces the reference's compile-time ``ROCQ_PRECISION_DOUBLE`` switch
(reference: rocquantum/include/rocquantum/hipStateVec.h:7-15) with a runtime
precision toggle. Default is single precision (complex64, eps 1e-6), matching
the reference's fp32 default; double precision (complex128, eps 1e-12)
requires ``jax_enable_x64`` and is enabled via :func:`set_precision`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class _Config:
    precision: str = "single"  # "single" | "double"
    df64: bool = False  # double-float (hi/lo f32) engine for fp64 circuits

    @property
    def complex_dtype(self):
        return jnp.complex128 if self.precision == "double" else jnp.complex64

    @property
    def real_dtype(self):
        return jnp.float64 if self.precision == "double" else jnp.float32

    @property
    def eps(self) -> float:
        return 1e-12 if self.precision == "double" else 1e-6


_CONFIG = _Config()


def set_precision(precision: str) -> None:
    """Set global simulation precision: ``"single"``, ``"double"``, or
    ``"df64"``.

    Double precision enables ``jax_enable_x64``; this affects newly created
    states only. ``"df64"`` is double precision with the DOUBLE-FLOAT
    engine opted in: fp64 circuits carry each f64 plane as a hi/lo float32
    pair and run compensated arithmetic (ops/df64.py) — ~1e-14-per-op
    accuracy (49-bit effective mantissa) instead of exact f64
    (docs/FP64_GUIDE.md). ``get_precision()`` reports "double" in df64
    mode — the state dtype and every readback
    contract are unchanged; only the flush engine differs.
    """
    if precision not in ("single", "double", "df64"):
        raise ValueError("precision must be 'single', 'double' or 'df64', "
                         f"got {precision!r}")
    if precision in ("double", "df64"):
        jax.config.update("jax_enable_x64", True)
    _CONFIG.df64 = precision == "df64"
    _CONFIG.precision = "double" if precision == "df64" else precision


def get_precision() -> str:
    return _CONFIG.precision


def df64_enabled() -> bool:
    """True when fp64 circuits should run the double-float engine: opted in
    via ``set_precision("df64")`` or the ROCQ_DF64 env knob."""
    import os
    if _CONFIG.precision != "double":
        return False
    return _CONFIG.df64 or bool(os.environ.get("ROCQ_DF64"))


def complex_dtype():
    return _CONFIG.complex_dtype


def real_dtype():
    return _CONFIG.real_dtype


def eps() -> float:
    return _CONFIG.eps


def complex_from_parts(re, im, dtype=None):
    """Combine (real, imag) arrays into a complex array via ``lax.complex``.

    ``lax.complex`` builds the value without a complex multiply.
    """
    if dtype is None:
        dtype = _CONFIG.complex_dtype
    rdt = jnp.finfo(dtype).dtype
    return jax.lax.complex(jnp.asarray(re).astype(rdt),
                           jnp.asarray(im).astype(rdt))
