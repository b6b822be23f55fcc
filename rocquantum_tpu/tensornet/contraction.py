"""Tensor-network contraction executor with memory-limited slicing and SVD.

JAX rebuild of the reference hipTensorNet engine
(reference: rocquantum/src/hipTensorNet/hipTensorNet.cpp —
rocTensorContractWithRocBLAS permute->GEMM :74-196, plan replay
TensorNetwork<T>::contract :234-313, slicing: findSlicingPoint :318-396,
selectSliceIndex (largest free index) :398-448, executeSlicedContraction
(sliced views + partial contractions + accumulate) :450-569; SVD
rocTensorSVD :628-680; WorkspaceManager rocWorkspaceManager.h:12-63).

Design differences:
  * each pairwise contraction is one jnp.einsum — XLA fuses the permute +
    GEMM the reference hand-rolled;
  * the whole plan traces into ONE jitted program per (network structure,
    config); no workspace bump allocator — XLA owns memory;
  * slicing runs as a lax.fori_loop whose body contracts ONE slab (inputs
    dynamically sliced along the sliced labels) and writes it at its offset
    in the preallocated output via dynamic_update_slice — the reference's
    accumulate-at-offset semantics (AccumulationKernels.hip.cpp:8-33) with
    peak temp memory bounded by one slab, and trace size independent of the
    slice count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from .pathfinder import (ContractionPlan, OptimizerConfig, Pathfinder,
                         PathfinderAlgorithm)
from .tensor import Tensor, parse_einsum_spec


def _einsum_pair(a_data, a_labels, b_data, b_labels, out_labels):
    """Contract two labeled tensors to ``out_labels`` via integer-label
    einsum at full precision."""
    ids: Dict[str, int] = {}
    for l in list(a_labels) + list(b_labels) + list(out_labels):
        if l not in ids:
            ids[l] = len(ids)
    return jnp.einsum(a_data, [ids[l] for l in a_labels],
                      b_data, [ids[l] for l in b_labels],
                      [ids[l] for l in out_labels],
                      precision=jax.lax.Precision.HIGHEST)


def contract_pair(a: Tensor, b: Tensor,
                  keep: Sequence[str] = ()) -> Tensor:
    """Contract two tensors over their shared labels (labels in ``keep``
    survive to the output — used when other network tensors still reference
    them)."""
    shared = [l for l in a.labels if l in set(b.labels)]
    contracted = [l for l in shared if l not in set(keep)]
    out = [l for l in a.labels if l not in contracted]
    out += [l for l in b.labels if l not in set(a.labels) and l not in contracted]
    return Tensor(_einsum_pair(a.data, a.labels, b.data, b.labels, out),
                  tuple(out))


def contract_einsum(spec: str, *tensors: Union[Tensor, jnp.ndarray]) -> Tensor:
    """Contract by einsum spec, e.g. 'ab,bc->ac'
    (rocTensorContractWithRocBLAS einsum entry, rocTensorUtil.cpp:479+)."""
    inputs, out = parse_einsum_spec(spec)
    if len(inputs) != len(tensors):
        raise ValueError(f"spec has {len(inputs)} operands, got {len(tensors)}")
    ids: Dict[str, int] = {}
    for ls in list(inputs) + [out]:
        for l in ls:
            if l not in ids:
                ids[l] = len(ids)
    args = []
    for t, ls in zip(tensors, inputs):
        data = t.data if isinstance(t, Tensor) else jnp.asarray(t)
        args.append(data)
        args.append([ids[l] for l in ls])
    result = jnp.einsum(*args, [ids[l] for l in out],
                        precision=jax.lax.Precision.HIGHEST)
    return Tensor(result, out)


class _SliceSpec:
    """One sliced step: slice ``label`` (dim ``dim``) in ``chunks`` chunks."""

    def __init__(self, label: str, dim: int, chunks: int):
        self.label = label
        self.dim = dim
        self.chunks = min(chunks, dim)


class TensorNetwork:
    """Label-matched pairwise contraction network
    (reference TensorNetwork<T>, hipTensorNet.h:42-95; Python-facing
    rocq.TensorNetwork of examples/tensornet_example.py)."""

    def __init__(self, simulator=None, memory_limit_bytes: Optional[int] = None):
        self.simulator = simulator  # accepted for API parity; unused
        self.tensors: List[Tensor] = []
        self.memory_limit_bytes = memory_limit_bytes
        self.last_plan: Optional[ContractionPlan] = None
        self.last_num_slices: int = 1

    def add_tensor(self, data, labels: Optional[Sequence[str]] = None) -> int:
        if isinstance(data, Tensor):
            t = data
        else:
            if labels is None:
                raise ValueError("labels required when adding a raw array")
            t = Tensor.from_numpy(np.asarray(data), labels)
        self.tensors.append(t)
        return len(self.tensors) - 1

    # -- planning ------------------------------------------------------------

    def _plan(self, cfg: OptimizerConfig) -> ContractionPlan:
        labels = [t.labels for t in self.tensors]
        shapes = [tuple(t.shape) for t in self.tensors]
        return Pathfinder(cfg).find_optimal_path(labels, shapes)

    # -- execution -----------------------------------------------------------

    def contract(self, optimizer_config: Union[OptimizerConfig, dict, None] = None,
                 mesh=None, axis_name: Optional[str] = None) -> Tensor:
        """Find a path and execute it, slicing any step whose output exceeds
        the memory limit (rocTensorNetworkContract, hipTensorNet.cpp:618-625
        + slicing path :450-569).

        With ``mesh`` (a jax.sharding.Mesh) and ``axis_name``, the slice
        loop of each sliced step DISTRIBUTES over that mesh axis: every
        device contracts its subset of slices and the partials combine with
        one psum — TN slicing as the cross-device scaling axis (SURVEY §2
        parallelism row 5; the reference looped slices serially on one GPU,
        hipTensorNet.cpp:503-530)."""
        if not self.tensors:
            raise ValueError("network has no tensors")
        if isinstance(optimizer_config, dict):
            cfg = OptimizerConfig.from_dict(optimizer_config)
        else:
            cfg = optimizer_config or OptimizerConfig()
        if cfg.memory_limit_bytes is None:
            cfg.memory_limit_bytes = self.memory_limit_bytes
        if (mesh is None) != (axis_name is None):
            raise ValueError("pass mesh and axis_name together")

        jit_body, datas, out_labels_box, plan = self._build_runner(
            cfg, mesh=mesh, axis_name=axis_name)
        result_data = jax.jit(jit_body)(*datas)
        return Tensor(result_data, out_labels_box[0] if out_labels_box
                      else self._traced_labels(plan))

    def compiled_memory_stats(self,
                              optimizer_config: Union[OptimizerConfig, dict,
                                                      None] = None):
        """AOT-compile the contraction and return XLA's memory analysis —
        lets callers (and tests) assert that slicing actually bounds peak
        temp memory (test_hipTensorNet_slicing.cpp checked values only)."""
        if isinstance(optimizer_config, dict):
            cfg = OptimizerConfig.from_dict(optimizer_config)
        else:
            cfg = optimizer_config or OptimizerConfig()
        if cfg.memory_limit_bytes is None:
            cfg.memory_limit_bytes = self.memory_limit_bytes
        jit_body, datas, _, _ = self._build_runner(cfg)
        return jax.jit(jit_body).lower(*datas).compile().memory_analysis()

    def _build_runner(self, cfg: OptimizerConfig, mesh=None,
                      axis_name: Optional[str] = None):
        plan = self._plan(cfg)
        self.last_plan = plan
        itemsize = np.dtype(config.complex_dtype()).itemsize
        limit_elems = (cfg.memory_limit_bytes // itemsize
                       if cfg.memory_limit_bytes else None)
        min_slices = int(getattr(cfg, "num_slices", 0) or 0)
        if mesh is not None:
            # every device must own at least one slice
            min_slices = max(min_slices, int(mesh.shape[axis_name]))

        tensors = list(self.tensors)
        datas = [t.data for t in tensors]
        labels = [t.labels for t in tensors]
        self.last_num_slices = 1
        # num_slices (hipTensorNet_api.h:35) applies to the step with the
        # largest output even when no memory limit forces slicing there
        biggest = max(plan.steps, key=lambda s: s.out_size, default=None) \
            if plan.steps else None

        def run(*arrays):
            cur = [Tensor(a, l) for a, l in zip(arrays, labels)]
            for step in plan.steps:
                a, b = cur[step.i], cur[step.j]
                rest = [t for k, t in enumerate(cur) if k not in (step.i, step.j)]
                keep = {l for t in rest for l in t.labels}
                # memory trigger accounts for the INPUT operands as well as
                # the output: the step's working set includes permuted input
                # copies (the reference staged both inputs through workspace
                # before the GEMM, hipTensorNet.cpp:74-196, but its
                # findSlicingPoint checked only the output size) — a
                # huge-inputs/small-output contraction must slice too
                step_elems = max(step.out_size,
                                 int(np.prod(a.shape, dtype=np.int64)),
                                 int(np.prod(b.shape, dtype=np.int64)))
                force = min_slices if (step is biggest
                                       and min_slices > 1) else 1
                if (limit_elems is not None and step_elems > limit_elems) \
                        or force > 1:
                    result = self._sliced_pair(a, b, step.out_labels, keep,
                                               limit_elems, force,
                                               mesh=mesh,
                                               axis_name=axis_name)
                else:
                    result = contract_pair(a, b, keep=keep)
                    # enforce planned output label set
                    if set(result.labels) != set(step.out_labels):
                        raise AssertionError(
                            f"executor/planner divergence: {result.labels} "
                            f"vs {step.out_labels}")
                cur = rest + [result]
            if len(cur) != 1:
                raise AssertionError("plan did not reduce to one tensor")
            return cur[0].data, cur[0].labels

        # trace+jit once per structure; labels are static so we close over
        # them and jit only the array computation
        out_labels_box = []

        def jit_body(*arrays):
            data, out_labels = run(*arrays)
            out_labels_box.append(out_labels)
            return data

        return jit_body, datas, out_labels_box, plan

    def _traced_labels(self, plan):
        # labels are deterministic from the plan; recompute without tracing
        cur = [t.labels for t in self.tensors]
        for step in plan.steps:
            rest = [l for k, l in enumerate(cur) if k not in (step.i, step.j)]
            cur = rest + [step.out_labels]
        return cur[0]

    def _sliced_pair(self, a: Tensor, b: Tensor, out_labels, keep,
                     limit_elems: Optional[int],
                     min_slices: int = 1, mesh=None,
                     axis_name: Optional[str] = None) -> Tensor:
        """Slice the largest free (output) indices of a violating contraction
        and stitch partial results (selectSliceIndex hipTensorNet.cpp:398-448
        + executeSlicedContraction :450-569).

        Executed as ONE lax.fori_loop over slice combinations: each
        iteration contracts one slab (inputs dynamically sliced) and writes
        it at its offset in the preallocated output — peak temp memory is a
        single slab, not num_slices of them, and the trace does not grow
        with the slice count.
        """
        out_labels = list(out_labels)
        dims = {}
        dims.update({l: a.dim_of(l) for l in a.labels})
        dims.update({l: b.dim_of(l) for l in b.labels})
        out_elems = int(np.prod([dims[l] for l in out_labels], dtype=np.int64))

        def divisor_at_least(dim: int, need: int) -> int:
            need = min(max(1, need), dim)
            for c in range(need, dim + 1):
                if dim % c == 0:
                    return c
            return dim

        # choose (label, chunks) specs, largest index first, until EVERY
        # per-iteration slab — output AND both input copies — fits the
        # memory limit (input-slab accounting; the reference checked only
        # the output, hipTensorNet.cpp:318-396)
        free_sorted = sorted(out_labels, key=lambda l: -dims[l])
        contracted_sorted = sorted(
            (l for l in dims if l not in set(out_labels)),
            key=lambda l: -dims[l])
        specs: List[Tuple[str, int]] = []
        chunks_of: Dict[str, int] = {}

        def next_divisor(dim: int, cur: int) -> Optional[int]:
            for c in range(cur + 1, dim + 1):
                if dim % c == 0:
                    return c
            return None

        def slab_of(ls) -> int:
            return int(np.prod([dims[l] // chunks_of.get(l, 1) for l in ls]
                               or [1], dtype=np.int64))

        if limit_elems is not None:
            if limit_elems < 1:
                raise MemoryError(
                    f"memory limit below one element ({out_elems}-element "
                    "output cannot fit)")
            while True:
                buffers = [bl for bl in (list(out_labels), a.labels, b.labels)
                           if slab_of(bl) > limit_elems]
                if not buffers:
                    break
                # grow the chunk count of the largest still-divisible label
                # present in an over-limit buffer (free labels preferred:
                # their slabs write disjoint regions, no accumulation)
                cands = [l for l in free_sorted + contracted_sorted
                         if any(l in bl for bl in buffers)
                         and dims[l] // chunks_of.get(l, 1) > 1]
                grown = False
                for l in cands:
                    c = next_divisor(dims[l], chunks_of.get(l, 1))
                    if c is not None:
                        chunks_of[l] = c
                        grown = True
                        break
                if not grown:
                    raise MemoryError(
                        f"contraction (inputs {slab_of(a.labels)}/"
                        f"{slab_of(b.labels)}, output {out_elems} elements) "
                        f"cannot be sliced under the memory limit "
                        f"({limit_elems} elements)")
            specs = [(l, chunks_of[l])
                     for l in free_sorted + contracted_sorted
                     if l in chunks_of]
        # honor a user-requested minimum slice count (hipTensorNet_api.h:35):
        # free (output) labels first — their slabs write disjoint regions —
        # then CONTRACTED labels, whose partial products accumulate into the
        # output (sum over slices). Contracted-index slicing is what makes
        # scalar/small-output contractions (amplitude and expectation
        # workloads, where there may be no free label at all) sliceable.
        total = int(np.prod([c for _, c in chunks_of.items()] or [1],
                            dtype=np.int64))
        if min_slices > 1:
            for l in free_sorted + contracted_sorted:
                if total >= min_slices:
                    break
                cur = chunks_of.get(l, 1)
                want = cur * (-(-min_slices // total))
                c = divisor_at_least(dims[l], min(want, dims[l]))
                if c > cur:
                    total = total // cur * c
                    chunks_of[l] = c
            specs = [(l, chunks_of[l])
                     for l in free_sorted + contracted_sorted
                     if l in chunks_of]
        if not specs:
            return contract_pair(a, b, keep=keep)

        csize = {l: dims[l] // c for l, c in specs}
        total = int(np.prod([c for _, c in specs], dtype=np.int64))
        self.last_num_slices = max(self.last_num_slices, total)

        a_labels, b_labels = list(a.labels), list(b.labels)
        out_shape = tuple(dims[l] for l in out_labels)
        dtype = jnp.result_type(a.data.dtype, b.data.dtype)
        accumulate = any(l not in set(out_labels) for l, _ in specs)
        slab_shape = tuple(csize.get(l, dims[l]) for l in out_labels)

        def slab_at(k, ad_full, bd_full):
            """(partial slab, output offsets) for slice index k."""
            rem = k
            starts: Dict[str, jnp.ndarray] = {}
            for l, c in reversed(specs):
                starts[l] = (rem % c) * csize[l]
                rem = rem // c
            ad, bd = ad_full, bd_full
            for l, _ in specs:
                if l in a_labels:
                    ad = jax.lax.dynamic_slice_in_dim(
                        ad, starts[l], csize[l], axis=a_labels.index(l))
                if l in b_labels:
                    bd = jax.lax.dynamic_slice_in_dim(
                        bd, starts[l], csize[l], axis=b_labels.index(l))
            # sliced free labels stay as (chunk-sized) output axes, so the
            # slab has exactly the out_labels axis order; sliced contracted
            # labels are summed inside the einsum (partial products)
            part = _einsum_pair(ad, a_labels, bd, b_labels, out_labels)
            # uniform offset dtype: the loop counter is int32 or int64
            # depending on the x64 mode, and dynamic_slice rejects mixes
            offs = tuple(jnp.asarray(starts.get(l, 0), jnp.int32)
                         for l in out_labels)
            return part.astype(dtype), offs

        def body(k, out):
            part, offs = slab_at(k, a.data, b.data)
            if accumulate:
                # the same output region receives one partial per contracted
                # slice: read-modify-write (the reference's accumulate-at-
                # offset kernel, AccumulationKernels.hip.cpp:8-33)
                cur = jax.lax.dynamic_slice(out, offs, slab_shape)
                part = cur + part
            return jax.lax.dynamic_update_slice(out, part, offs)

        if mesh is None:
            out = jax.lax.fori_loop(0, total, body,
                                    jnp.zeros(out_shape, dtype))
            return Tensor(out, tuple(out_labels))

        # distributed: each device runs ceil(total/ndev) slices and the
        # per-device partial outputs combine with ONE psum — free-sliced
        # slabs land in disjoint zero regions, contracted-sliced slabs
        # accumulate, so a plain sum merges both
        from jax.sharding import PartitionSpec as P

        ndev = int(mesh.shape[axis_name])
        per_dev = -(-total // ndev)

        def local_fn(ad_full, bd_full):
            base = jax.lax.axis_index(axis_name) * per_dev

            def dev_body(j, out):
                k = base + j
                valid = (k < total).astype(dtype)
                part, offs = slab_at(jnp.minimum(k, total - 1),
                                     ad_full, bd_full)
                cur = jax.lax.dynamic_slice(out, offs, slab_shape)
                return jax.lax.dynamic_update_slice(out, cur + part * valid,
                                                    offs)

            # the carry starts unvarying (zeros) but the body output varies
            # over the mesh axis (axis_index): mark it varying up front
            init = jax.lax.pcast(jnp.zeros(out_shape, dtype), (axis_name,),
                                 to="varying")
            local = jax.lax.fori_loop(0, per_dev, dev_body, init)
            return jax.lax.psum(local, axis_name)

        out = jax.shard_map(local_fn, mesh=mesh,
                            in_specs=(P(), P()), out_specs=P())(
                                a.data, b.data)
        return Tensor(out, tuple(out_labels))


def tensor_svd(tensor: Tensor, row_labels: Sequence[str],
               col_labels: Optional[Sequence[str]] = None,
               bond_label: str = "_s") -> Tuple[Tensor, Tensor, Tensor]:
    """Economy SVD A = U S V^H over a (row_labels | col_labels) bipartition
    (rocTensorSVD analog, hipTensorNet.cpp:628-680 — rocSOLVER cgesvd 'S'
    mode becomes jnp.linalg.svd(full_matrices=False))."""
    row_labels = list(row_labels)
    if col_labels is None:
        col_labels = [l for l in tensor.labels if l not in set(row_labels)]
    col_labels = list(col_labels)
    if set(row_labels) | set(col_labels) != set(tensor.labels) or \
            set(row_labels) & set(col_labels):
        raise ValueError("row/col labels must bipartition the tensor labels")

    perm = row_labels + col_labels
    data = jnp.transpose(tensor.data,
                         [tensor.labels.index(l) for l in perm])
    m = int(np.prod([tensor.dim_of(l) for l in row_labels], dtype=np.int64))
    n = int(np.prod([tensor.dim_of(l) for l in col_labels], dtype=np.int64))

    @jax.jit
    def do(x):
        u, s, vh = jnp.linalg.svd(x.reshape(m, n), full_matrices=False)
        return u, s, vh

    u, s, vh = do(data)
    k = min(m, n)
    u_t = Tensor(u.reshape(tuple(tensor.dim_of(l) for l in row_labels) + (k,)),
                 tuple(row_labels) + (bond_label,))
    s_t = Tensor(s, (bond_label,))
    v_t = Tensor(vh.reshape((k,) + tuple(tensor.dim_of(l) for l in col_labels)),
                 (bond_label,) + tuple(col_labels))
    return u_t, s_t, v_t
