"""Cost analysis of a traced torch program (counterpart of
``repro.utils.hlo``).

The name is the reference's, so a reader finds the counterpart; what it
costs is not HLO text but every aten op a step dispatches.  ``CostMode`` is
a ``TorchDispatchMode``: run a step under it, on real tensors or on fake
ones (``torch._subclasses.FakeTensorMode``, nothing allocated), and it adds
up the reference's cost model op by op:

- flops: the formulas ``torch.utils.flop_counter`` registers (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, convolution, scaled-dot-product
  attention).  Elementwise flops are ignored, as in the reference.
- bytes: every materialising op reads its tensor operands and writes its
  tensor results, each at its own dtype.  Views and bookkeeping (aliases,
  metadata queries, allocations) are free.  Slicing ops (``index_select``,
  ``gather``, ``index``, ``embedding``) are charged twice their output;
  updating ops (``index_put_``, ``scatter*``, ``index_add_``, ``copy_`` into
  a slice) twice their update.  A bf16 op is charged as bf16: the
  reference's CPU convert shim has no counterpart here.
- collective bytes: the operand bytes and a count of every ``c10d`` op
  that reaches the dispatcher (all-reduce, all-gather, reduce-scatter,
  all-to-all, broadcast; a send as the reference's collective-permute),
  under the reference's names.  Every collective of
  ``parallel/collectives.py`` reaches it (``dist.all_reduce``,
  ``all_gather``, ``reduce_scatter_tensor`` and ``batch_isend_irecv`` call
  the ``c10d`` ops), so none is counted by hand.  Collective bytes are also
  HBM bytes, as in the reference.
- live bytes, the counterpart of ``memory_analysis``: the arguments'
  storages, then each storage an op creates from its creation until it is
  freed (a ``weakref`` finalizer on the storage), with the peak.

An op on the meta device (shapes alone: ``parallel.sharding.layer_specs``
builds a layer there, once a process, to read its parameters' shapes)
moves no byte and holds no memory: it is not costed.

There is no trip-count parsing: an eager loop dispatches each trip.

These are the quantities of the process that runs the step: one rank of an
SPMD program, like the reference's per-device module.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry as _FLOPS

__all__ = ["Costs", "CostMode", "analyze"]

# Metadata queries and allocations: no bytes move.
_FREE = {
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
    "aten::new_empty_strided", "aten::_local_scalar_dense", "aten::is_nonzero",
    "aten::is_same_size", "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
    "aten::sym_storage_offset", "aten::size", "aten::stride", "aten::is_contiguous",
    "aten::set_", "aten::resize_", "aten::lift_fresh", "aten::_unsafe_view",
    "prim::device", "prim::layout", "c10d::barrier",
}
# Ops that read only the slice they return.
_SLICING = {"aten::index_select", "aten::gather", "aten::index", "aten::embedding",
            "aten::take"}
# Ops that update a region of their first operand: the update's argument.
_UPDATING = {
    "aten::index_put": "values", "aten::index_put_": "values",
    "aten::_index_put_impl_": "values", "aten::scatter": "src", "aten::scatter_": "src",
    "aten::scatter_add": "src", "aten::scatter_add_": "src", "aten::scatter_reduce": "src",
    "aten::scatter_reduce_": "src", "aten::index_add": "source", "aten::index_add_": "source",
    "aten::index_copy": "source", "aten::index_copy_": "source", "aten::copy_": "src",
    "aten::slice_scatter": "src", "aten::select_scatter": "src",
}
# c10d op -> (the reference's collective name, the operand argument).  Any
# other c10d op raises: a collective is never costed as a plain op.
_COLLECTIVES = {
    "c10d::allreduce_": ("all-reduce", "tensors"),
    "c10d::allgather_": ("all-gather", "input_tensors"),
    "c10d::_allgather_base_": ("all-gather", "input_tensor"),
    "c10d::reduce_scatter_": ("reduce-scatter", "input_tensors"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "input_tensor"),
    "c10d::alltoall_": ("all-to-all", "input_tensors"),
    "c10d::alltoall_base_": ("all-to-all", "input"),
    "c10d::broadcast_": ("broadcast", "tensors"),
    "c10d::send": ("collective-permute", "tensors"),
}
# A receive's bytes are the sender's collective; here its buffer's write.
_RECEIVES = {"c10d::recv_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` addresses: a broadcast (stride 0) dimension reads its
    element once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _nbytes(tree) -> int:
    return sum(_tensor_bytes(t) for t in _tensors(tree))


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages behind ``tensors``."""
    seen: dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_count: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    # The counterpart of ``memory_analysis``: the arguments' storages, the
    # result's storages that are not the arguments', and the most bytes
    # live at once (arguments included).
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    @property
    def temp_bytes(self) -> int:
        """The peak's bytes beyond the arguments (temporaries and outputs)."""
        return self.peak_bytes - self.argument_bytes

    def memory_analysis(self) -> dict:
        """The reference's ``memory_analysis`` keys (there is no generated
        code: 0)."""
        return {"argument_size": self.argument_bytes, "output_size": self.output_bytes,
                "temp_size": self.temp_bytes, "generated_code_size": 0}


class CostMode(TorchDispatchMode):
    """Costs every aten op dispatched while it is active (see the module's
    docstring); ``costs`` holds the totals.  ``args``: the step's inputs,
    whose storages are live from the start and make ``argument_bytes``."""

    def __init__(self, args=()):
        super().__init__()
        self.costs = Costs()
        self._live = 0
        self._known: dict[int, int] = {}
        args = _tensors(args)
        for t in args:
            self._track(t.untyped_storage())
        self.costs.argument_bytes = self._live
        self.costs.peak_bytes = self._live
        self._args = {id(t.untyped_storage()) for t in args}

    def _track(self, st) -> None:
        key = id(st)
        if key in self._known:
            return
        n = st.nbytes()
        self._known[key] = n
        self._live += n
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._known.pop(key, 0)

    def output_bytes(self, out) -> int:
        """The bytes of ``out``'s storages that are not the arguments'."""
        return _storage_bytes(t for t in _tensors(out)
                              if id(t.untyped_storage()) not in self._args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # A composite op reaches the mode whole where autograd is off
        # (``inference_mode``): cost the ops it decomposes into, as under
        # autograd.
        if func._overloadpacket not in _FLOPS and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        tensors = _tensors((args, kwargs, out))
        if tensors and all(t.device.type == "meta" for t in tensors):
            return out
        self._cost(func, args, kwargs, out)
        for t in _tensors(out):
            self._track(t.untyped_storage())
        return out

    def _cost(self, func, args, kwargs, out) -> None:
        c = self.costs
        name = func._schema.name
        if name in _FREE or func.is_view:
            return
        packet = func._overloadpacket
        if packet in _FLOPS:
            c.flops += _FLOPS[packet](*args, **kwargs, out_val=out)
        if name in _COLLECTIVES:
            op, arg = _COLLECTIVES[name]
            nbytes = _nbytes(_argument(func, args, kwargs, arg))
            c.coll_bytes += nbytes
            c.coll_by_op[op] += nbytes
            c.coll_count[op] += 1
            c.bytes += nbytes
        elif name in _RECEIVES:
            c.bytes += _nbytes(args[0])
        elif func.namespace == "c10d":
            raise NotImplementedError(f"no cost model for the collective {name}")
        elif name in _SLICING:
            c.bytes += 2 * _nbytes(out)
        elif name in _UPDATING:
            update = _argument(func, args, kwargs, _UPDATING[name])
            if not isinstance(update, torch.Tensor):  # a scalar scattered at the indices
                update = _argument(func, args, kwargs, "index")
                c.bytes += 2 * update.numel() * args[0].element_size()
            else:
                c.bytes += 2 * _nbytes(update)
        else:
            c.bytes += _nbytes((args, kwargs)) + _nbytes(out)


def _argument(func, args, kwargs, name: str):
    """The argument of ``func``'s call named ``name`` (None where its
    overload has none: ``scatter.value`` scatters a scalar)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else kwargs.get(name, a.default_value)
    return None


def analyze(fn, *args) -> Costs:
    """The costs of ``fn(*args)`` (the counterpart of ``analyze_compiled``):
    run it under ``CostMode``, with ``args`` its arguments."""
    mode = CostMode(args)
    with mode:
        out = fn(*args)
    mode.costs.output_bytes = mode.output_bytes(out)
    del out
    return mode.costs
