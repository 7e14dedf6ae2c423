"""What one traced step does on one rank: dot FLOPs, collectives and
memory (the port's counterpart of :mod:`repro.launch.hlo`, which parses
XLA's compiled HLO for the same numbers).

The dry run traces a step under ``FakeTensorMode`` on DTensors over
placeholder ranks.  :class:`TraceCounter` is a dispatch mode that sees
the ops each rank would run: it lets DTensor lower every op to its local
ops and collectives first (it declines DTensor ops, as torch's
``CommDebugMode`` and ``MemTracker`` do) and counts those:

* **dot FLOPs** by ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (the port's custom ops register theirs), on
  the local shapes: the FLOPs of one rank, also split by the type of
  the product's first operand (the card's peak rate depends on it);
* **collectives** by kind, each counting the bytes of its result, as
  ``hlo.py`` counts an HLO collective's result type (an all-gather the
  gathered tensor, a reduce-scatter the scattered shard);
* **bytes accessed**: the bytes of every local op's tensor inputs and
  outputs (each op on its own, nothing fused; views move nothing), the
  counterpart of
  ``cost_analysis()``'s "bytes accessed";
* **memory**: the bytes of the tensors alive on the rank (each storage
  once, from the op that made it until it is freed) and their peak,
  the counterpart of ``memory_analysis()``.

With ``attribute=True`` it also keys each dot and each collective by its
aten op and its *site*, the innermost frame under ``repro_torch/models/``
(``models/transformer.py:516 unembed``) other than the einsum wrappers
that every product passes through, or where the op comes from no model,
the innermost under ``repro_torch/`` (the optimizer, the step): the
counterpart of the ``op_name`` that the reference's ``tools/top_dots.py``
and ``tools/attribute_collectives.py`` read in the HLO.  An op that the
autograd engine runs in the backward has no model frame on the stack;
its site is the forward's, from the traceback that anomaly mode (on for
the trace) keeps on each autograd node, marked with the node's name.  The
sites' FLOPs add up to ``dot_flops`` and their bytes to each kind's total;
off (the default), the counter does what it did without it.

DTensor also runs each op once on fake tensors of the *global* shapes to
learn its output's shape, and the first time an op meets a mesh it runs
ops of its own to find a strategy (sharding propagation).  Those runs are
not a rank's work and are not counted, so a cell counts the same in a
process's first trace and in its later ones; ``MemTracker`` counts them under an
outer ``FakeTensorMode``, which is why the port counts memory here.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import sys
import time
import warnings
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_kinds() -> Dict[Any, str]:
    ops = torch.ops._c10d_functional
    kinds = {"all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
             "all_reduce_coalesced": "all-reduce",
             "all_reduce_coalesced_": "all-reduce",
             "all_to_all_single": "all-to-all"}
    return {getattr(ops, name): kind for name, kind in kinds.items()
            if hasattr(ops, name)}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def _nbytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


#: where a site's frame lives: a model's, else the package's (the
#: optimizer, the step); frames of anomaly mode's tracebacks
_PKG = "/repro_torch/"
_MODELS = "/repro_torch/models/"
_TB_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
#: the product wrappers every model einsum passes through: not a site
_WRAPPERS = {("models/layers.py", f) for f in
             ("einsum", "_einsum", "_local_einsum", "einsum_f32")}


def _pick(frames) -> Optional[str]:
    """``file:line function`` of the first of ``frames`` (filename, line,
    function; innermost first) under ``repro_torch/models/`` that is not
    a wrapper, else the first under ``repro_torch/`` outside this
    module."""
    for where in (_MODELS, _PKG):
        for filename, line, function in frames:
            if where not in filename:
                continue
            rel = filename[filename.rindex(_PKG) + len(_PKG):]
            if (rel, function) not in _WRAPPERS and \
                    rel != "launch/opcount.py":
                return f"{rel}:{line} {function}"
    return None


def _site() -> str:
    """Where the op being dispatched comes from (:func:`_pick` over the
    stack); in the autograd engine's backward, where its node's forward
    came from (anomaly mode's traceback), with the node's name; else
    "?"."""
    frames = []
    f = sys._getframe(2)
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is None or any(_MODELS in fn for fn, _, _ in frames):
        return _pick(frames) or "?"
    tb = [(m.group(1), int(m.group(2)), m.group(3)) for m in
          map(_TB_FRAME.search, reversed(node.metadata.get("traceback_")
                                         or [])) if m]
    return f"{_pick(tb) or '?'} [{node.name()}]"


#: DTensor's sharding propagation: the global-shape run that finds an
#: op's output shape, and the strategy search that, the first time an op
#: meets a mesh (its result is cached), runs ops of its own through a
#: decomposition on a fake mesh
_PROPAGATION = ("_propagate_tensor_meta", "propagate_op_sharding")


def _in_sharding_propagation() -> bool:
    """Whether this op runs inside DTensor's sharding propagation."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class TraceCounter(TorchDispatchMode):
    """A dispatch mode counting the local ops of a traced step (see the
    module doc).  :meth:`track` registers tensors made before the mode
    was entered (parameters, optimizer state, inputs, caches) as live.
    With ``budget_s``, an op dispatched more than that many seconds after
    the mode was first entered raises :class:`TimeoutError`.  With
    ``attribute``, :attr:`dot_sites` holds the FLOPs and
    :attr:`collective_sites` the bytes of each (op, site) and (kind, op,
    site), :attr:`site_calls` how many ops each key counted; enter
    :meth:`attribution` around the traced step, as
    :func:`repro_torch.launch.dryrun.trace_cell` does."""

    def __init__(self, budget_s: Optional[float] = None,
                 attribute: bool = False) -> None:
        super().__init__()
        self.budget_s = budget_s
        self.attribute = attribute
        self.dot_sites: Dict[tuple, int] = collections.Counter()
        self.collective_sites: Dict[tuple, float] = collections.Counter()
        self.site_calls: Dict[tuple, int] = collections.Counter()
        self._deadline: Optional[float] = None
        self.dot_flops = 0
        self.dot_flops_by_dtype: Dict[torch.dtype, int] = {}
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops: Dict[str, int] = {}
        self._kinds = _collective_kinds()
        self.collectives = CollectiveStats(dict.fromkeys(COLLECTIVES, 0.0),
                                           dict.fromkeys(COLLECTIVES, 0))
        self._storages: Dict[int, Any] = {}

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            self._hold(t._local_tensor if isinstance(t, DTensor) else t)

    def attribution(self):
        """Anomaly mode (without its NaN checks) where :attr:`attribute` is
        on, so that the backward's ops find their forward sites; a
        context that does nothing where it is off."""
        if not self.attribute:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(warnings.catch_warnings())
        warnings.filterwarnings("ignore", "Anomaly Detection has been "
                                "enabled")
        stack.enter_context(torch.autograd.detect_anomaly(check_nan=False))
        return stack

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()

        def _freed(_, key=key, n=n):
            self._storages.pop(key, None)
            self.live_bytes -= n
        self._storages[key] = weakref.ref(st, _freed)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __enter__(self):
        if self.budget_s is not None and self._deadline is None:
            self._deadline = time.perf_counter() + self.budget_s
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor lower it first
        if self._deadline is not None and time.perf_counter() > \
                self._deadline:
            raise TimeoutError(f"the trace ran past its {self.budget_s:.0f} "
                               f"s budget after {sum(self.ops.values())} "
                               "local ops")
        kwargs = kwargs or {}
        if func is torch.ops.prim.device.default or \
                _in_sharding_propagation():
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and packet not in self._kinds:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # the fake kernel makes a new tensor where a real wait hands its
            # argument back
            out = args[0]
        else:
            out = func(*args, **kwargs)
        name = str(packet)
        self.ops[name] = self.ops.get(name, 0) + 1
        kind = self._kinds.get(packet)
        site = _site() if self.attribute and (
            kind is not None or packet in flop_registry) else None
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            dt = next(t.dtype for t in tree_flatten(args)[0]
                      if isinstance(t, torch.Tensor))
            self.dot_flops += n
            self.dot_flops_by_dtype[dt] = \
                self.dot_flops_by_dtype.get(dt, 0) + n
            if site is not None:
                self.dot_sites[name, site] += n
                self.site_calls[name, site] += 1
        if kind is not None:
            b = _nbytes(out)
            self.collectives.bytes_by_kind[kind] += b
            self.collectives.count_by_kind[kind] += 1
            if site is not None:
                self.collective_sites[kind, name, site] += b
                self.site_calls[kind, name, site] += 1
        if not func.is_view:
            self.bytes_accessed += _nbytes(args) + _nbytes(kwargs) + \
                _nbytes(out)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


def count_op(counter: TraceCounter, opname: str) -> int:
    """How many times the traced step ran ``opname`` (an aten op's name,
    as ``aten.mm``)."""
    return counter.ops.get(opname, 0)
