"""Per-device cost counter of a traced step; the port's counterpart of
``repro.launch.hlo_analysis``.

The reference lowers and compiles a step with XLA and reads the
optimized HLO text.  Here the step runs once, eagerly, on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage, no arithmetic),
and :class:`CostCounter`, a ``TorchDispatchMode``, sees every op that
reaches a device.  Under DTensor the counter sits *below* the tensor
subclass: it declines the DTensor-level call, so DTensor's sharding
propagation runs first and the counter sees the rank-local ops and the
functional collectives that DTensor's redistributions issue.  The global
shape ops that DTensor's propagation runs on fake tensors to derive
output metadata are not part of the local computation and are not
counted (:func:`_shadow_ops_uncounted`).

Charged per device by the reference's rules (matmul-dominated lower
bounds):

* dot FLOPs: ``2 * prod(out) * K`` for the matmul family (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``: what ``einsum``, ``matmul`` and ``@`` lower to).
  No elementwise FLOPs and no convolutions, as in the reference.
* HBM bytes: the dots' operands and outputs; the outputs of the indexing
  ops that correspond to XLA's gather, scatter and dynamic-update-slice
  (``index``, ``gather``, ``scatter``, ``index_put``, ``index_copy``,
  ``index_add``, ...); and the collective bytes.
* collective bytes: operand bytes of the all-gather, all-reduce,
  reduce-scatter and all-to-all ops (functional ``_c10d_functional`` and
  ``c10d``), and of point-to-point sends, named with XLA's op names
  (``"all-gather"``, ``"all-reduce"``, ``"reduce-scatter"``,
  ``"all-to-all"``, ``"collective-permute"``) so records compare key by key.
* peak memory: the largest sum of live storage bytes over the trace,
  counting the arguments (:meth:`CostCounter.add_arguments`).  A storage is
  live from the op that makes it until its last reference dies.  The
  reference's counterpart is XLA's temp + arguments + outputs - aliases.
  With ``split_peak``, :meth:`CostCounter.peak_split` names the storages
  live at the peak by the op that made them and their shape.

No trip-count weighting: the reference's ``_build_multipliers`` re-weights
scan bodies by their trip counts because XLA's cost analysis counts a
loop body once; an eager trace executes every layer, flash key block, CE
chunk and remat recompute, so each is charged as often as it runs.

Hand-written kernels in a trace: ``repro_torch.kernels._build.launch``
given fake or meta tensors calls nothing and charges the active counter
(:func:`record_kernel`) with the bytes of its tensor arguments, by the
kernel table's bound convention (inputs read once, outputs written once).
These launches are counted in the record (``kernel_launches``), not in
``_build.LAUNCHES``.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten
_c10d_f = torch.ops._c10d_functional

DOT_OPS = {
    aten.mm.default: 0, aten.bmm.default: 0,
    aten.addmm.default: 1, aten.baddbmm.default: 1,
}
GATHER_SCATTER_OPS = {
    aten.index.Tensor, aten.index_select.default, aten.gather.default,
    aten.embedding.default,
    aten.scatter.src, aten.scatter.value, aten.scatter_.src, aten.scatter_.value,
    aten.scatter_add.default, aten.scatter_add_.default,
    aten.scatter_reduce.two, aten.scatter_reduce_.two,
    aten.index_put.default, aten.index_put_.default, aten._index_put_impl_.default,
    aten.index_copy.default, aten.index_copy_.default,
    aten.index_add.default, aten.index_add_.default,
    aten.slice_scatter.default, aten.select_scatter.default,
}


def _collective_table() -> dict:
    """op -> (XLA name, index of the operand argument)."""
    table = {}

    def add(ns, name, xla, arg):
        packet = getattr(ns, name, None)
        if packet is not None:
            for overload in packet.overloads():
                table[getattr(packet, overload)] = (xla, arg)

    for name, xla in (("all_gather_into_tensor", "all-gather"),
                      ("all_gather_into_tensor_coalesced", "all-gather"),
                      ("all_reduce", "all-reduce"), ("all_reduce_", "all-reduce"),
                      ("all_reduce_coalesced", "all-reduce"),
                      ("all_reduce_coalesced_", "all-reduce"),
                      ("reduce_scatter_tensor", "reduce-scatter"),
                      ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                      ("all_to_all_single", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("broadcast_", "collective-permute")):
        add(_c10d_f, name, xla, 0)
    # DTensor's shard-to-shard redistribution (Shard(i) -> Shard(j))
    add(getattr(torch.ops, "_dtensor"), "shard_dim_alltoall", "all-to-all", 0)
    c10d = torch.ops.c10d
    for name, xla, arg in (("allreduce_", "all-reduce", 0),
                           ("allgather_", "all-gather", 1),
                           ("_allgather_base_", "all-gather", 1),
                           ("reduce_scatter_", "reduce-scatter", 1),
                           ("_reduce_scatter_base_", "reduce-scatter", 1),
                           ("alltoall_base_", "all-to-all", 1),
                           ("alltoall_", "all-to-all", 1),
                           ("broadcast_", "collective-permute", 0),
                           ("send", "collective-permute", 0)):
        add(c10d, name, xla, arg)
    return table


_COLLECTIVES = None


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _argument_tensors(tree) -> list:
    """The tensors of a step argument: a module's parameters, a
    dataclass's fields (``AdamState``), a pytree's leaves."""
    import dataclasses

    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _argument_tensors(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _argument_tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _argument_tensors(v)]
    return _tensors(tree)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return StorageWeakRef(t.untyped_storage()).cdata


@dataclass
class OpCosts:
    """The counter's record of one traced step, per device."""

    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_detail: dict = field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    kernel_launches: dict = field(default_factory=dict)
    kernel_bytes: float = 0.0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class CostCounter(TorchDispatchMode):
    """Count a traced step's per-device costs (see the module docstring).

    Use inside the ``FakeTensorMode`` the step's tensors were made in,
    so the counter sees each op before the fake mode computes its
    output's metadata::

        with fake_mode, CostCounter() as cc, _shadow_ops_uncounted(cc):
            cc.add_arguments(params, batch)
            step(...)
        cc.costs
    """

    def __init__(self, split_peak: bool = False):
        super().__init__()
        self.split_peak = split_peak
        self._origin: dict = {}    # storage key -> (op, shape, dtype), with split_peak
        self._at_peak: list = []   # (bytes, origin) of the storages live at the peak
        global _COLLECTIVES
        if _COLLECTIVES is None:
            _COLLECTIVES = _collective_table()
        self.costs = OpCosts()
        self.op_counts: dict = defaultdict(int)
        self.paused = 0
        self._live: dict = {}      # storage key -> (weak ref, bytes)
        self._live_bytes = 0
        self._arguments: set = set()  # the arguments' storage keys

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor, origin: str = "argument") -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):  # a subclass without storage
            return
        ref = StorageWeakRef(st)
        if ref.cdata in self._live:
            return
        nb = st.nbytes()
        self._live[ref.cdata] = (ref, nb)
        self._live_bytes += nb
        if self.split_peak:
            self._origin[ref.cdata] = (origin, tuple(t.shape), str(t.dtype))
        if self._live_bytes > self.costs.peak_bytes:
            self._sweep()
            if self._live_bytes > self.costs.peak_bytes and self.split_peak:
                self._at_peak = [(b, self._origin.get(k)) for k, (_, b) in self._live.items()]
            self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)

    def peak_split(self, top: int = 20) -> list:
        """With ``split_peak``: the storages live at the peak grouped by the
        op that made them (``"argument"`` for the step's arguments), shape
        and dtype, as ``(bytes, count, op, shape, dtype)``, largest first."""
        groups: dict = {}
        for nb, origin in self._at_peak:
            g = groups.setdefault(origin or ("?", (), ""), [0, 0])
            g[0] += nb
            g[1] += 1
        rows = sorted(((b, n, *o) for o, (b, n) in groups.items()), reverse=True)
        return rows[:top]

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    def add_arguments(self, *trees) -> int:
        """Register the step's arguments (DTensors by their local tensors):
        their bytes are the record's ``argument_bytes`` and count as live
        from the start.  Returns the bytes added."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in _argument_tensors(trees):
            local = t.to_local() if isinstance(t, DTensor) else t
            added += _nbytes(local)
            self._track(local)
            self._arguments.add(_storage_key(local))
        self.costs.argument_bytes += added
        return added

    def output_bytes(self, *trees) -> tuple:
        """``(output bytes, alias bytes)`` of a step's outputs: their local
        bytes, and the part that lives in an argument's storage (updated
        in place, XLA's donated and aliased buffers)."""
        from torch.distributed.tensor import DTensor

        out = alias = 0
        for t in _argument_tensors(trees):
            local = t.to_local() if isinstance(t, DTensor) else t
            out += _nbytes(local)
            if _storage_key(local) in self._arguments:
                alias += _nbytes(local)
        return out, alias

    def live_bytes(self) -> int:
        self._sweep()
        return self._live_bytes

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor lower to local ops first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self.op_counts[func] += 1
        c = self.costs
        if func in DOT_OPS:
            a = args[DOT_OPS[func]]
            b = args[DOT_OPS[func] + 1]
            c.dot_flops += 2.0 * math.prod(out.shape) * a.shape[-1]
            c.hbm_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        elif func in GATHER_SCATTER_OPS:
            c.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
        elif func in _COLLECTIVES:
            name, i = _COLLECTIVES[func]
            nb = sum(_nbytes(t) for t in _tensors(args[i]))
            c.coll_bytes += nb
            c.hbm_bytes += nb
            d = c.coll_detail.setdefault(name, {"bytes": 0.0, "count": 0.0})
            d["bytes"] += nb
            d["count"] += 1
        for t in _tensors(out):
            self._track(t, str(func))
        return out

    def record_kernel(self, name: str, tensors) -> None:
        """A hand-written kernel launched on fake tensors: one launch of
        ``name`` reading or writing each tensor argument once."""
        nb = sum(_nbytes(t) for t in tensors)
        self.costs.kernel_launches[name] = self.costs.kernel_launches.get(name, 0) + 1
        self.costs.kernel_bytes += nb
        self.costs.hbm_bytes += nb


def active_counter():
    """The innermost :class:`CostCounter` on the dispatch-mode stack, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def is_traced(t: torch.Tensor) -> bool:
    """True for a fake or meta tensor: one that holds no data to compute on."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor) or t.is_meta


@contextlib.contextmanager
def _cluster_all_to_all():
    """DTensor turns a shard-to-shard redistribution on a CPU mesh into an
    all-gather and a chunk, because gloo has no all-to-all; a fake group
    is no gloo.  For the trace, take the all-to-all a cluster's backend
    runs (its fake implementation gives the shape), so a trace on fake CPU
    tensors charges the collectives of one on fake CUDA tensors."""
    from torch.distributed.tensor import _collective_utils, placement_types

    orig = getattr(_collective_utils, "shard_dim_alltoall", None)
    if orig is None or not hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        yield
        return
    from torch.distributed import _functional_collectives as funcol

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._resolve_group_name((mesh, mesh_dim)))

    patched = [m for m in (_collective_utils, placement_types)
               if getattr(m, "shard_dim_alltoall", None) is orig]
    for m in patched:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in patched:
            m.shard_dim_alltoall = orig


@contextlib.contextmanager
def _shadow_ops_uncounted(counter: CostCounter):
    """DTensor derives each op's global output metadata by running the op
    on fake tensors of the global shape; those ops reach the counter like
    the local ones.  Pause the counter while they run."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = ("_propagate_tensor_meta_non_cached"
            if hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
            else "_propagate_tensor_meta")
    orig = getattr(ShardingPropagator, name)

    def paused(self, *a, **k):
        counter.paused += 1
        try:
            return orig(self, *a, **k)
        finally:
            counter.paused -= 1

    setattr(ShardingPropagator, name, paused)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)
