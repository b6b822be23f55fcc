"""DensityCircuit: the main-API circuit handle on the density-matrix engine.

Completes the front-end matrix: the reference exposed density-matrix
simulation only through the DSL backend and raw binding
(rocq/backends.py DensityMatrixBackend, py_hip_density_mat.cpp); this class
gives it the same queue/flush/measure/sample/expval surface as
:class:`rocquantum_tpu.api.Circuit`, plus noise-channel application and
NoiseModel attachment.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import config
from .api import PauliOperator, Simulator, _GateMethods
from .ops import density as dmops
from .utils.cache import BoundedCache


# Module-level jitted helper: a fresh ``jax.jit(lambda ...)`` per call is
# a NEW function identity that retraces on every invocation.
@jax.jit
def _complex_to_pair(r):
    return jnp.real(r), jnp.imag(r)


_DM_INIT_CACHE = BoundedCache()

_DM_RUN_CACHE = BoundedCache()

# conjugation rules for named gates (U rho U†: the COLUMN side applies
# conj(U); with the op's is_adjoint flag kept, (conj U)† == conj(U†))
_CONJ_SELF = {"H", "X", "Z", "RY", "CRY", "CNOT", "CX", "CZ", "SWAP",
              "MCX", "CCX", "TOFFOLI", "CSWAP", "I", "ID"}
_CONJ_NAME = {"S": "SDG", "SDG": "S", "T": "TDG", "TDG": "T"}
_CONJ_NEGATE = {"RX", "RZ", "P", "PHASE", "CRX", "CRZ"}


def _gate_items_2n(n, name, tgt, ctrl, vals, mat_key, adj):
    """(row_op, col_op) GateOps on the flattened 2n-qubit view of rho, or
    (None, None) when the gate has no named conjugation rule (caller falls
    back to the per-gate dense path). Row (ket) bits are the HIGH n bits."""
    from .compiler.ir import GateOp

    row_t = tuple(q + n for q in tgt)
    row_c = tuple(q + n for q in ctrl)
    if mat_key is not None:
        m = np.frombuffer(mat_key[0], np.complex128).reshape(mat_key[1])
        row = GateOp("UNITARY", row_t, row_c, (), m, adj)
        col = GateOp("UNITARY", tuple(tgt), tuple(ctrl), (),
                     np.conj(m), adj)
        return row, col
    key = name.upper()
    row = GateOp(key, row_t, row_c, tuple(vals), None, adj)
    if key in _CONJ_SELF:
        return row, GateOp(key, tuple(tgt), tuple(ctrl), tuple(vals), None,
                           adj)
    if key in _CONJ_NAME:
        return row, GateOp(_CONJ_NAME[key], tuple(tgt), tuple(ctrl), (),
                           None, adj)
    if key in _CONJ_NEGATE:
        return row, GateOp(key, tuple(tgt), tuple(ctrl),
                           tuple(-v for v in vals), None, adj)
    if key == "Y":
        return row, GateOp("UNITARY", tuple(tgt), tuple(ctrl), (),
                           np.conj(np.array([[0, -1j], [1j, 0]])), adj)
    if key == "U3" and len(vals) == 3:
        return row, GateOp(key, tuple(tgt), tuple(ctrl),
                           (vals[0], -vals[1], -vals[2]), None, adj)
    return None, None


def _gate_items_2n_sched(n, name, tgt, ctrl, vals, mat_key, adj):
    """(row_op, col_op) like :func:`_gate_items_2n`, but ``vals`` may be the
    flush's ("slots", i...) marker: parameter slots are re-encoded as
    ("sslots", (slot, sign), ...) so the col side's sign flips survive until
    the traced resolution inside ``run`` (the sharded path schedules ops
    BEFORE tracing, so it cannot embed traced values)."""
    from .compiler.ir import GateOp

    if not (vals and vals[0] == "slots"):
        return _gate_items_2n(n, name, tgt, ctrl, vals, mat_key, adj)
    slots = vals[1:]
    key = name.upper()
    row_params = ("sslots",) + tuple((i, 1.0) for i in slots)
    row = GateOp(key, tuple(q + n for q in tgt), tuple(q + n for q in ctrl),
                 row_params, None, adj)
    if key in _CONJ_SELF:
        col_params = row_params
    elif key in _CONJ_NEGATE:
        col_params = ("sslots",) + tuple((i, -1.0) for i in slots)
    elif key == "U3" and len(slots) == 3:
        col_params = ("sslots", (slots[0], 1.0), (slots[1], -1.0),
                      (slots[2], -1.0))
    else:
        return None, None
    col = GateOp(key, tuple(tgt), tuple(ctrl), col_params, None, adj)
    return row, col


class DensityCircuit(_GateMethods):
    """Gate+channel queue over a density matrix; flush compiles the queued
    segment into one jitted program (structure-cached, angles dynamic).

    With ``mesh`` (a jax.sharding.Mesh with an 'sv' axis), rho — the
    flattened 2n-qubit view — is SHARDED over the mesh: the top index bits
    (high ROW qubits) select the device, and the flush routes the whole
    segment through the qubit-locality scheduler
    (compiler/sharded_schedule.py), relabeling index bits via all-to-all so
    gates and Kraus channels always touch local bits — never the
    all-gather fallback of the bare XLA partitioner. This extends the
    reference's multi-GPU design (MULTI_GPU_GUIDE.md:19-59, statevector
    only) to the density engine."""

    def __init__(self, num_qubits: int, simulator: Simulator,
                 noise_model=None, mesh=None):
        if not isinstance(simulator, Simulator):
            raise TypeError("A valid Simulator instance is required.")
        if num_qubits < 0:
            raise ValueError("Number of qubits must be non-negative.")
        self.num_qubits = num_qubits
        self.simulator = simulator
        self.noise_model = noise_model
        self.batch_size = 1
        self.mesh = mesh
        self._layout2n: List[int] = list(range(2 * num_qubits))
        self._queue: List[tuple] = []
        self._rho: Optional[jax.Array] = None
        if mesh is not None:
            from .parallel.sharded import num_global_qubits
            n_global = num_global_qubits(mesh)
            if n_global >= 2 * num_qubits:
                raise ValueError(
                    f"mesh has {n_global} device-selecting bits but rho has "
                    f"only {2 * num_qubits} index bits")

    def _sharding(self):
        if self.mesh is None:
            return None
        from .parallel.sharded import state_sharding
        return state_sharding(self.mesh)

    # -- queueing -------------------------------------------------------------

    def _enqueue(self, name, targets, controls=(), params=(), matrix=None,
                 is_adjoint=False):
        mat_key = None
        if matrix is not None:
            m = np.ascontiguousarray(matrix, np.complex128)
            mat_key = (m.tobytes(), m.shape)
        self._queue.append(("gate", name.upper(), tuple(targets),
                            tuple(controls),
                            tuple(float(p) for p in params), mat_key,
                            bool(is_adjoint)))
        if self.noise_model is not None:
            for ch in self.noise_model.get_channels():
                if ch["op"] is not None and ch["op"] != name.lower():
                    continue
                qs = ch["qubits"] if ch["qubits"] is not None else \
                    list(targets) + list(controls)
                self.apply_channel(ch["type"], ch["prob"], qs)

    def apply_channel(self, channel_type: str, probability: float,
                      qubits: List[int]):
        """Queue a named noise channel (hipDensityMatApplyChannel surface)."""
        if channel_type.lower() not in dmops.CHANNELS:
            raise ValueError(f"Unknown noise channel: {channel_type!r}")
        self._queue.append(("channel", channel_type.lower(),
                            float(probability), tuple(qubits)))

    def apply_kraus(self, kraus_ops, qubits: List[int]):
        mats = tuple((np.ascontiguousarray(k, np.complex128).tobytes(),
                      np.asarray(k).shape) for k in kraus_ops)
        self._queue.append(("kraus", mats, tuple(qubits)))

    # -- execution --------------------------------------------------------------

    def _use_pair(self) -> bool:
        """fp64 density circuits run the float-pair engine (ops/pairdm.py),
        sharded circuits included (both parts over 'sv'; relabels stay
        all-to-all transposes). Sticky once rho exists."""
        if self._rho is not None:
            return isinstance(self._rho, tuple)
        return config.get_precision() == "double"

    def _init_rho(self):
        n = self.num_qubits
        sh = self._sharding()
        pair = self._use_pair()
        key = (n, sh, pair, config.get_precision())
        fn = _DM_INIT_CACHE.get(key)
        if fn is None:
            if pair:
                from .ops import pairdm

                def mk():
                    re, im = pairdm.init_density_pair(n)
                    if sh is not None:
                        re = jax.lax.with_sharding_constraint(re, sh)
                        im = jax.lax.with_sharding_constraint(im, sh)
                    return re, im

                fn = jax.jit(mk)
            elif sh is None:
                fn = jax.jit(lambda: dmops.init_density(n))
            else:
                from .parallel.sharded import sharded_zero_state
                fn = jax.jit(lambda: sharded_zero_state(2 * n, sh))
            _DM_INIT_CACHE[key] = fn
        return fn()

    # Per-program op budget: gates expand to 2 ops on the 2n view and a
    # factored channel to ~4, so a long queue flushes as a CHAIN of
    # programs (same rule as Circuit's 96-item segments).
    _SEGMENT_OPS = 90

    def flush(self):
        if not self._queue:
            if self._rho is None:
                self._rho = self._init_rho()
            return
        queue, self._queue = list(self._queue), []
        for sub in self._plan_subs(queue):
            self._flush_items(sub)

    def _plan_subs(self, queue):
        """Chunk the queue by per-program op cost."""
        def cost(item):
            k = item[0]
            if k == "gate":
                return 2
            if k == "channel":
                return 4 * len(item[3])
            return 4  # kraus
        chunks, cur, acc = [], [], 0
        for item in queue:
            c = cost(item)
            if cur and acc + c > self._SEGMENT_OPS:
                chunks.append(cur)
                cur, acc = [], 0
            cur.append(item)
            acc += c
        if cur:
            chunks.append(cur)
        return chunks

    def _flush_items(self, queue):
        # split angles into a runtime vector for structure-keyed caching
        key_items, values = [], []
        for item in queue:
            if item[0] == "gate" and item[4]:
                slots = tuple(range(len(values), len(values) + len(item[4])))
                values.extend(item[4])
                key_items.append(item[:4] + (("slots",) + slots,) + item[5:])
            else:
                key_items.append(item)
        key_items = tuple(key_items)
        if self.mesh is not None:
            return self._flush_sharded(key_items, values)
        if self._use_pair():
            return self._flush_items_pair(key_items, values)
        cache_key = (self.num_qubits, key_items, config.get_precision())
        fn = _DM_RUN_CACHE.get(cache_key)
        if fn is None:
            n = self.num_qubits

            def run(rho, params):
                from .compiler.interpreter import execute as _exec
                from .compiler.ir import GateOp
                pending2n: List = []  # GateOps on the 2n-qubit flat view

                def drain(rho):
                    if pending2n:
                        rho = _exec(rho, list(pending2n), None)
                        pending2n.clear()
                    return rho

                for item in key_items:
                    kind = item[0]
                    if kind == "gate":
                        _, name, tgt, ctrl, vals, mat_key, adj = item
                        if vals and vals[0] == "slots":
                            vals = [params[i] for i in vals[1:]]
                        row, col = _gate_items_2n(n, name, tgt, ctrl, vals,
                                                  mat_key, adj)
                        if row is not None:
                            # consecutive unitaries run through the fused
                            # interpreter (diagonal fusion / consolidation)
                            # on the 2n-qubit view — the reference applied
                            # one kernel per gate side
                            pending2n.extend((row, col))
                            continue
                        rho = drain(rho)
                        rho = dmops.apply_gate_dm(rho, name, list(tgt),
                                                  list(ctrl), list(vals),
                                                  adjoint=adj)
                    elif kind == "channel":
                        # channels ride the SAME fused interpreter stream as
                        # the gates: factored into CNOT/U/CU or one D2
                        # diagonal when the superoperator
                        # block-diagonalizes, else one dense 4x4 per target
                        _, channel, prob, tgt = item
                        ks = dmops.CHANNELS[channel.lower()](prob)
                        s = dmops.kraus_superoperator(ks, xp=np)
                        for q in tgt:
                            fops = dmops.superop_kernel_ops(s, q, q + n)
                            pending2n.extend(fops if fops is not None else
                                             [GateOp("UNITARY", (q, q + n),
                                                     (), (), s)])
                    else:  # kraus
                        _, mats, tgt = item
                        ks = [np.frombuffer(b, np.complex128).reshape(shape)
                              for b, shape in mats]
                        s = dmops.kraus_superoperator(ks, xp=np)
                        fops = dmops.superop_kernel_ops(
                            s, tgt[0], tgt[0] + n) if len(tgt) == 1 else None
                        if fops is not None:
                            pending2n.extend(fops)
                        else:
                            pos = tuple(tgt) + tuple(q + n for q in tgt)
                            pending2n.append(GateOp("UNITARY", pos, (), (), s))
                return drain(rho)

            fn = jax.jit(run, donate_argnums=(0,))
            _DM_RUN_CACHE[cache_key] = fn
        if self._rho is None:
            self._rho = self._init_rho()
        params = jnp.asarray(values, dtype=config.real_dtype())
        self._rho = fn(self._rho, params)

    def _flush_items_pair(self, key_items, values):
        """fp64 float-pair twin of the run loop: exact sequential pair ops
        (no fused interpreter / superop factorization — those compute in
        f32); params stay runtime inputs for structure-keyed caching."""
        from .compiler.ir import GateOp
        from .ops import pairdm

        cache_key = ("pair", self.num_qubits, key_items)
        fn = _DM_RUN_CACHE.get(cache_key)
        if fn is None:
            n = self.num_qubits

            def run(re, im, params):
                for item in key_items:
                    kind = item[0]
                    if kind == "gate":
                        _, name, tgt, ctrl, vals, mat_key, adj = item
                        if vals and vals[0] == "slots":
                            vals = tuple(params[i] for i in vals[1:])
                        mat = None
                        if mat_key is not None:
                            mat = np.frombuffer(
                                mat_key[0], np.complex128).reshape(mat_key[1])
                        op = GateOp(name, tuple(tgt), tuple(ctrl), (), mat,
                                    adj)
                        re, im = pairdm.apply_op_pair_dm(
                            re, im, op, n, params_resolved=tuple(vals))
                    elif kind == "channel":
                        _, channel, prob, tgt = item
                        re, im = pairdm.apply_channel_pair_dm(
                            re, im, channel, prob, list(tgt), n)
                    else:  # kraus
                        _, mats, tgt = item
                        ks = [np.frombuffer(b, np.complex128).reshape(shape)
                              for b, shape in mats]
                        re, im = pairdm.apply_kraus_pair_dm(
                            re, im, ks, list(tgt), n)
                return re, im

            fn = jax.jit(run, donate_argnums=(0, 1))
            _DM_RUN_CACHE[cache_key] = fn
        if self._rho is None:
            self._rho = self._init_rho()
        params = jnp.asarray(values, dtype=config.real_dtype())
        self._rho = fn(*self._rho, params)

    def _flush_sharded(self, key_items, values):
        """Sharded flush: schedule the segment's 2n-qubit ops through the
        qubit-locality scheduler (SWAP_BITS relabels -> all-to-all, never
        all-gather) and execute under the rho sharding. Kraus channels ride
        placeholder ops so their row/col bits get localized like any gate's,
        then apply positionally (dmops.apply_kraus_at)."""
        import dataclasses as _dc

        from .compiler.ir import GateOp
        from .compiler.sharded_schedule import SWAP_BITS, schedule_for_sharding
        from .parallel.sharded import num_global_qubits

        n = self.num_qubits
        n2 = 2 * n
        sharding = self._sharding()
        pseudo: List[GateOp] = []
        kraus_table: List[tuple] = []  # ("channel", name, p, m)|("mats", mats, None, m)
        for item in key_items:
            kind = item[0]
            if kind == "gate":
                _, name, tgt, ctrl, vals, mat_key, adj = item
                row, col = _gate_items_2n_sched(n, name, tgt, ctrl, vals,
                                                mat_key, adj)
                if row is None:
                    raise NotImplementedError(
                        f"gate {name!r} has no named conjugation rule; the "
                        "sharded density path supports named and matrix "
                        "gates")
                pseudo.extend((row, col))
            elif kind == "channel":
                _, channel, prob, tgt = item
                ks = dmops.CHANNELS[channel.lower()](prob)
                s = dmops.kraus_superoperator(ks, xp=np)
                for q in tgt:
                    fops = dmops.superop_kernel_ops(s, q, q + n)
                    if fops is not None:
                        # factored channels are ordinary gates/diagonals:
                        # they ride the locality scheduler (and D2 factors
                        # are comm-free on global bits) instead of forcing
                        # a drain + positional Kraus apply
                        pseudo.extend(fops)
                        continue
                    idx = len(kraus_table)
                    kraus_table.append(("channel", channel, prob, 1))
                    pseudo.append(GateOp(f"__KRAUS_{idx}__", (q + n, q)))
            else:  # kraus
                _, mats, tgt = item
                ks = [np.frombuffer(b, np.complex128).reshape(shape)
                      for b, shape in mats]
                s = dmops.kraus_superoperator(ks, xp=np)
                fops = dmops.superop_kernel_ops(
                    s, tgt[0], tgt[0] + n) if len(tgt) == 1 else None
                if fops is not None:
                    pseudo.extend(fops)
                    continue
                idx = len(kraus_table)
                kraus_table.append(("mats", mats, None, len(tgt)))
                pseudo.append(GateOp(
                    f"__KRAUS_{idx}__",
                    tuple(q + n for q in tgt) + tuple(tgt)))
        sched, new_layout = schedule_for_sharding(
            pseudo, n2, num_global_qubits(self.mesh), self._layout2n)
        if self._use_pair():
            return self._run_sharded_pair(sched, new_layout, kraus_table,
                                          key_items, values, sharding)
        cache_key = ("sharded", n, key_items, tuple(self._layout2n),
                     self.mesh, config.get_precision())
        fn = _DM_RUN_CACHE.get(cache_key)
        if fn is None:
            def run(rho, params):
                from .compiler.interpreter import execute as _exec
                pending: List[GateOp] = []

                def drain(rho):
                    if pending:
                        rho = _exec(rho, list(pending), None,
                                    sharding=sharding)
                        pending.clear()
                    return rho

                for op in sched:
                    if op.name.startswith("__KRAUS_"):
                        rho = drain(rho)
                        idx = int(op.name[len("__KRAUS_"):-2])
                        rec = kraus_table[idx]
                        if rec[0] == "channel":
                            ks = [jnp.asarray(m, rho.dtype)
                                  for m in dmops.CHANNELS[rec[1]](rec[2])]
                        else:
                            ks = [jnp.asarray(
                                np.frombuffer(b, np.complex128).reshape(sh),
                                rho.dtype) for b, sh in rec[1]]
                        m = rec[3]
                        rho = dmops.apply_kraus_at(rho, ks,
                                                   list(op.targets[:m]),
                                                   list(op.targets[m:]))
                        rho = jax.lax.with_sharding_constraint(rho, sharding)
                        continue
                    if op.params and op.params[0] == "sslots":
                        vals = tuple(s * params[i] for i, s in op.params[1:])
                        op = _dc.replace(op, params=vals)
                    pending.append(op)
                return drain(rho)

            fn = jax.jit(run, donate_argnums=(0,), out_shardings=sharding)
            _DM_RUN_CACHE[cache_key] = fn
        if self._rho is None:
            self._rho = self._init_rho()
        params = jnp.asarray(values, dtype=config.real_dtype())
        self._rho = fn(self._rho, params)
        self._layout2n = list(new_layout)

    def _run_sharded_pair(self, sched, new_layout, kraus_table, key_items,
                          values, sharding):
        """fp64 sharded executor: the SAME scheduled op stream, run on the
        (re, im) pair — SWAP_BITS relabels as constrained transposes
        (all-to-all), gates/diagonals as exact flat pair math (diagonals
        comm-free), Kraus channels positionally via the dense superop
        rows."""
        import dataclasses as _dc

        from .compiler.sharded_schedule import SWAP_BITS
        from .ops import pairdm, pairsim
        from .ops import statevec as _sv

        cache_key = ("sharded-pair", self.num_qubits, key_items,
                     tuple(self._layout2n), self.mesh)
        fn = _DM_RUN_CACHE.get(cache_key)
        if fn is None:
            def run(re, im, params):
                for op in sched:
                    if op.name.startswith("__KRAUS_"):
                        idx = int(op.name[len("__KRAUS_"):-2])
                        rec = kraus_table[idx]
                        if rec[0] == "channel":
                            ks = dmops.CHANNELS[rec[1]](rec[2])
                        else:
                            ks = [np.frombuffer(b, np.complex128).reshape(sh)
                                  for b, sh in rec[1]]
                        m = rec[3]
                        re, im = pairdm.apply_kraus_at_pair_dm(
                            re, im, ks, list(op.targets[:m]),
                            list(op.targets[m:]))
                    elif op.name == SWAP_BITS:
                        a, b = op.targets
                        re = _sv.swap_index_bits(re, a, b,
                                                 use_transpose=True)
                        im = _sv.swap_index_bits(im, a, b,
                                                 use_transpose=True)
                    elif op.name == "PERMUTE_BITS":
                        d, s = ((op.controls, op.targets) if op.is_adjoint
                                else (op.targets, op.controls))
                        re = _sv.permute_index_bits(re, d, s)
                        im = _sv.permute_index_bits(im, d, s)
                    else:
                        if op.params and op.params[0] == "sslots":
                            vals = tuple(s * params[i]
                                         for i, s in op.params[1:])
                            op = _dc.replace(op, params=vals)
                        re, im = pairsim.apply_op_pair(re, im, op)
                    re = jax.lax.with_sharding_constraint(re, sharding)
                    im = jax.lax.with_sharding_constraint(im, sharding)
                return re, im

            fn = jax.jit(run, donate_argnums=(0, 1))
            _DM_RUN_CACHE[cache_key] = fn
        if self._rho is None:
            self._rho = self._init_rho()
        params = jnp.asarray(values, dtype=config.real_dtype())
        self._rho = fn(*self._rho, params)
        self._layout2n = list(new_layout)

    def _restore_layout(self):
        """Undo the locality relabeling so readbacks address logical bits."""
        if self.mesh is None or \
                self._layout2n == list(range(2 * self.num_qubits)):
            return
        from .compiler.interpreter import execute as _exec
        from .compiler.sharded_schedule import unpermute_ops

        # this path only runs SHARDED (mesh guard above): merge the whole
        # restore into ONE PERMUTE_BITS relabel (one all-to-all round)
        ops = unpermute_ops(self._layout2n, merge=True)
        sharding = self._sharding()

        if self._use_pair():
            from .ops import statevec as _sv

            def run_pair(re, im):
                for op in ops:
                    if op.name == "PERMUTE_BITS":
                        re = _sv.permute_index_bits(re, op.targets,
                                                    op.controls)
                        im = _sv.permute_index_bits(im, op.targets,
                                                    op.controls)
                    else:
                        a, b = op.targets
                        re = _sv.swap_index_bits(re, a, b,
                                                 use_transpose=True)
                        im = _sv.swap_index_bits(im, a, b,
                                                 use_transpose=True)
                    re = jax.lax.with_sharding_constraint(re, sharding)
                    im = jax.lax.with_sharding_constraint(im, sharding)
                return re, im

            self._rho = jax.jit(run_pair, donate_argnums=(0, 1))(*self._rho)
            self._layout2n = list(range(2 * self.num_qubits))
            return

        def run(rho):
            rho = _exec(rho, ops, None, sharding=sharding)
            return rho

        self._rho = jax.jit(run, donate_argnums=(0,),
                            out_shardings=sharding)(self._rho)
        self._layout2n = list(range(2 * self.num_qubits))

    @property
    def state(self) -> jax.Array:
        self.flush()
        self._restore_layout()
        return self._rho

    def reset(self):
        self._queue.clear()
        self._layout2n = list(range(2 * self.num_qubits))
        self._rho = None  # re-decide pair-vs-complex for the new state
        self._rho = self._init_rho()

    # -- measurement / readback ----------------------------------------------

    def measure(self, qubit: int) -> Tuple[int, float]:
        self.flush()
        self._restore_layout()
        self._validate_qubit_index(qubit)
        if self._use_pair():
            from .ops import pairdm
            n = self.num_qubits
            p1 = float(pairdm.prob_one_pair_dm_jit(self._rho[0], qubit, n))
            outcome = 1 if self.simulator.host_random() < p1 else 0
            self._rho = pairdm.collapse_pair_dm_jit(*self._rho, qubit,
                                                    outcome, n)
            if self.mesh is not None:  # re-pin (donation + in_shardings)
                sh = self._sharding()
                self._rho = tuple(jax.device_put(p, sh) for p in self._rho)
            return outcome, (p1 if outcome == 1 else 1.0 - p1)
        p1 = float(dmops.prob_one_dm_jit(self._rho, qubit))
        outcome = 1 if self.simulator.host_random() < p1 else 0
        prob = p1 if outcome == 1 else 1.0 - p1
        self._rho = dmops.collapse_dm_jit(self._rho, qubit, outcome)
        if self.mesh is not None:
            # re-pin to the rho sharding: the generic collapse jit's output
            # layout otherwise breaks buffer donation on the next flush
            self._rho = jax.device_put(self._rho, self._sharding())
        return outcome, prob

    def sample(self, measured_qubits: List[int], num_shots: int) -> np.ndarray:
        self.flush()
        self._restore_layout()
        if self._use_pair():
            from .ops import pairdm
            out = pairdm.sample_pair_dm_jit(
                self._rho[0], qubits=tuple(measured_qubits),
                shots=num_shots, key=self.simulator.next_key())
            return np.asarray(out)
        out = dmops.sample_dm_jit(self._rho, qubits=tuple(measured_qubits),
                                  shots=num_shots,
                                  key=self.simulator.next_key())
        return np.asarray(out)

    def get_density_matrix(self) -> np.ndarray:
        self.flush()
        self._restore_layout()
        dim = 1 << self.num_qubits
        if self._use_pair():
            re, im = self._rho
            return (np.asarray(re).reshape(dim, dim).astype(np.complex128)
                    + 1j * np.asarray(im).reshape(dim, dim))
        mat = dmops.to_matrix(self._rho)
        re, im = _complex_to_pair(mat)
        return np.asarray(re).astype(np.complex128) + 1j * np.asarray(im)

    def purity(self) -> float:
        self.flush()
        # purity is basis-independent: no layout restore needed
        if self._use_pair():
            from .ops import pairdm
            return float(pairdm.purity_pair_dm_jit(*self._rho))
        return float(dmops.purity_dm_jit(self._rho))

    def expval(self, pauli_operator: PauliOperator) -> float:
        if not isinstance(pauli_operator, PauliOperator):
            raise TypeError("Input must be a PauliOperator object.")
        self.flush()
        self._restore_layout()
        if self._use_pair():
            from .ops import pairdm
            terms_key = tuple(tuple(ops) for ops, _ in pauli_operator.terms)
            coeffs = tuple(float(c) for _, c in pauli_operator.terms)
            return float(pairdm.expval_terms_pair_dm_jit(
                *self._rho, terms=terms_key, coeffs=coeffs,
                n=self.num_qubits))
        total = 0.0
        for ops, coeff in pauli_operator.terms:
            if not ops:
                total += coeff
            elif all(p == "Z" for p, _ in ops):
                total += coeff * float(dmops.expval_pauli_product_z_dm_jit(
                    self._rho, qubits=tuple(q for _, q in ops)))
            else:
                total += coeff * float(dmops.expval_pauli_string_dm_jit(
                    self._rho, ops=tuple(ops)))
        return total
