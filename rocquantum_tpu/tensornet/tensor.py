"""Labeled tensors.

JAX analog of the reference's ``rocTensor`` struct (device pointer,
dims, string labels, strides, ownership — rocTensorUtil.h:28-177) and its
utilities: N-D permutation (rocTensorPermute, rocTensorUtil.cpp:31-140 +
PermutationKernels.hip) and the einsum-spec parser
(parse_simple_einsum_spec, rocTensorUtil.cpp:271-478). Here a tensor is just
(jax array, label tuple) — XLA owns layout, strides and memory.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from .. import config


@dataclasses.dataclass
class Tensor:
    """A device array with one string label per axis."""
    data: jnp.ndarray
    labels: Tuple[str, ...]

    def __post_init__(self):
        self.labels = tuple(self.labels)
        if len(self.labels) != self.data.ndim:
            raise ValueError(
                f"{len(self.labels)} labels for a rank-{self.data.ndim} tensor")
        if len(set(self.labels)) != len(self.labels):
            raise ValueError(f"duplicate labels: {self.labels}")

    @classmethod
    def from_numpy(cls, array: np.ndarray, labels: Sequence[str],
                   dtype=None) -> "Tensor":
        """Upload a host array. Complex data is shipped as a (real, imag)
        float pair and combined on device."""
        import jax
        dtype = dtype or config.complex_dtype()
        array = np.asarray(array)
        rdt = config.real_dtype()
        re = jnp.asarray(np.ascontiguousarray(array.real), dtype=rdt)
        im = jnp.asarray(np.ascontiguousarray(array.imag), dtype=rdt)
        data = jax.jit(
            lambda r, i: config.complex_from_parts(r, i, dtype))(re, im)
        return cls(data, tuple(labels))

    @property
    def shape(self):
        return self.data.shape

    @property
    def size_bytes(self) -> int:
        return int(np.prod(self.data.shape, dtype=np.int64)) * self.data.dtype.itemsize

    def dim_of(self, label: str) -> int:
        return self.data.shape[self.labels.index(label)]

    def to_numpy(self) -> np.ndarray:
        import jax
        re, im = jax.jit(lambda d: (jnp.real(d), jnp.imag(d)))(self.data)
        return np.asarray(re).astype(np.complex128) + 1j * np.asarray(im)

    def __repr__(self):
        return f"Tensor(labels={self.labels}, shape={tuple(self.shape)})"


def permute(tensor: Tensor, new_labels: Sequence[str]) -> Tensor:
    """Reorder axes to ``new_labels`` (rocTensorPermute analog — a single
    XLA transpose instead of a hand-written coalesced-write kernel,
    PermutationKernels.hip:34-156)."""
    new_labels = tuple(new_labels)
    if set(new_labels) != set(tensor.labels):
        raise ValueError(f"permutation {new_labels} does not match labels "
                         f"{tensor.labels}")
    perm = [tensor.labels.index(l) for l in new_labels]
    return Tensor(jnp.transpose(tensor.data, perm), new_labels)


def parse_einsum_spec(spec: str):
    """Parse 'ab,bc->ac' into (input label tuples, output labels)
    (parse_simple_einsum_spec analog, rocTensorUtil.cpp:271-478)."""
    spec = spec.replace(" ", "")
    if "->" not in spec:
        raise ValueError("einsum spec must contain '->'")
    lhs, rhs = spec.split("->")
    inputs = tuple(tuple(part) for part in lhs.split(","))
    if not lhs or any(len(p) == 0 for p in inputs):
        raise ValueError(f"malformed einsum spec: {spec!r}")
    return inputs, tuple(rhs)
