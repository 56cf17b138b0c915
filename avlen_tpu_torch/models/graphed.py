"""CUDA-graph replay of the acting step's forwards.

Every acting step of a collect calls the same forwards at the same shapes:
the belief towers (``BeliefPredictorNet.forward``), the belief EMA
(``belief_predictor.update_beliefs``) and the goal policy's act
(``SMTPolicy.act``). Issued eagerly, they are hundreds of launch calls from
the host; replayed from CUDA graphs, a few input copies and launches, with
the same kernels in the same order at the same precision.

A ``GraphedCall`` sits behind such an entry point and engages only on what
the call shows: CUDA tensors and generator, autograd off, no capture under
way, and a key it has seen before. The key is the inputs' structure (dict keys, None
leaves), shapes, strides and dtypes; the call's static arguments; the
generator it samples from; the module and the storage of its parameters
and buffers; and the TF32 flags, which set the arithmetic. The first call at a key
runs eagerly, which also settles cuDNN's choice of algorithm and the SMT
wrapper's once-per-shape plan check; the second captures and runs; later
calls copy their tensors into the graph's static inputs, replay, and
return copies of the static outputs, so that what a caller keeps is not
overwritten by the next replay. Every other call (the CPU, autograd, a new
key) is the eager forward unchanged. At most ``MAX_KEYS`` keys are kept, the
least recently used dropped first.

A hand-written kernel (``ops.KERNELS``) is not captured: the capture ends
before its launch and a new graph begins after it, so that a replay makes
the launch from the host through its module's ``_launch``, as an eager
call does, and whatever counts or records launches there sees each one.
Its output is copied into the tensor that the next graph reads.

The generator is registered with the graphs, so that each replay draws from
its state and advances it as an eager call does. An optimizer step updates
parameters in place and a replay reads the new values; anything that moves
a parameter to new storage (``.to()``, a new tensor) changes the key.

Each entry point counts its ``captures``, ``replays`` and ``eager_calls``
in ``utils/profiling.GRAPH_COUNTERS``, which ``profiling.export`` reports.
"""

from __future__ import annotations

import functools
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from avlen_tpu_torch.ops import KERNELS
from avlen_tpu_torch.utils import profiling

MAX_KEYS = 4  # keys kept by each entry point


class _Node(NamedTuple):
    kind: type  # dict, tuple, list or a named tuple
    keys: Optional[Tuple]  # a dict's keys, in order
    children: Tuple


_TENSOR = object()  # a tensor's place in a structure


def flatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """The tensors of nested dicts, tuples, named tuples and lists, appended
    to ``leaves`` in order; returns the hashable structure that ``unflatten``
    rebuilds from them. Other values (None, numbers) stay in the structure."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, dict):
        return _Node(dict, tuple(tree), tuple(flatten(v, leaves) for v in tree.values()))
    if isinstance(tree, (tuple, list)):
        return _Node(type(tree), None, tuple(flatten(v, leaves) for v in tree))
    return tree


def unflatten(spec: Any, leaves) -> Any:
    """The structure ``spec`` with its tensors taken in order from the iterator ``leaves``."""
    if spec is _TENSOR:
        return next(leaves)
    if not isinstance(spec, _Node):
        return spec
    children = [unflatten(c, leaves) for c in spec.children]
    if spec.kind is dict:
        return dict(zip(spec.keys, children))
    if hasattr(spec.kind, "_fields"):
        return spec.kind(*children)
    return spec.kind(children)


class _Tree:
    """A module's submodules and their parameter and buffer dicts, kept so
    that the storage key reads the data pointers without walking the tree
    (a walk costs about three times more); walked again when a submodule
    is added, removed or replaced."""

    def __init__(self, module: torch.nn.Module, freed: Callable):
        self.ref = weakref.ref(module, freed)
        self.walk(module)

    def walk(self, module: torch.nn.Module) -> None:
        modules = list(module.modules())
        self.module_dicts = [m._modules for m in modules]
        self.children = self.submodules()
        self.tensor_dicts = [d for m in modules for d in (m._parameters, m._buffers)]

    def submodules(self) -> List[Optional[torch.nn.Module]]:
        return [m for d in self.module_dicts for m in d.values()]

    def storage_key(self, module: torch.nn.Module) -> Tuple[int, ...]:
        """The data pointers of the module's parameters and buffers."""
        if self.submodules() != self.children:
            self.walk(module)
        return tuple([t.data_ptr() for d in self.tensor_dicts for t in d.values() if t is not None])


def on_card(leaves: List[torch.Tensor], generator: Optional[torch.Generator]) -> bool:
    """Whether these tensors and the generator are on the card, with no
    capture under way (a host generator's draws cannot be captured)."""
    return (bool(leaves) and all(t.is_cuda for t in leaves) and (generator is None or generator.device.type == "cuda")
            and not torch.cuda.is_current_stream_capturing())


def capture(fn: Callable, inputs: Tuple, generator: Optional[torch.Generator]):
    """(captured, outputs): ``fn(*inputs)`` captured and run once;
    ``captured.replay()`` runs it again on the same tensors."""
    captured = Captured(generator)
    return captured, captured.run(fn, inputs)


class Captured:
    """A forward captured as CUDA graphs that share one memory pool, broken
    at each hand-written kernel's launch (module docstring)."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.launches: List[Tuple] = []  # (kernel module, args, kwargs, its output's tensors) after each graph
        self.capturing = None

    def run(self, fn: Callable, inputs: Tuple):
        launch = {m: m._launch for m in KERNELS.values()}
        for m in KERNELS.values():
            m._launch = functools.partial(self._launch, m, launch[m])
        self._begin()
        try:
            out = fn(*inputs)
        finally:
            for m in KERNELS.values():
                m._launch = launch[m]
            self._end()
        self.graphs[-1].replay()
        return out

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        pool = self.graphs[0].pool() if self.graphs else None
        self.capturing = torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")
        self.capturing.__enter__()
        self.graphs.append(graph)

    def _end(self) -> None:
        capturing, self.capturing = self.capturing, None
        if capturing is not None:
            capturing.__exit__(None, None, None)

    def _launch(self, module, launch: Callable, *args, **kwargs):
        """A kernel launch met while capturing: the graph so far ends and
        runs, the kernel launches, and the next graph begins."""
        self._end()
        self.graphs[-1].replay()
        out = launch(*args, **kwargs)
        static: List[torch.Tensor] = []
        flatten(out, static)
        self.launches.append((module, args, kwargs, static))
        self._begin()
        return out

    def replay(self) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.launches):
                module, args, kwargs, static = self.launches[i]
                out: List[torch.Tensor] = []
                flatten(module._launch(*args, **kwargs), out)
                torch._foreach_copy_(static, out)


class _Graph:
    """One captured forward: its static inputs, its graphs and its static
    outputs."""

    def __init__(self, fn: Callable, spec: Any, leaves: List[torch.Tensor], generator):
        self.static_in = [t.clone() for t in leaves]
        self.captured, out = capture(fn, unflatten(spec, iter(self.static_in)), generator)
        self.static_out: List[torch.Tensor] = []
        self.out_spec = flatten(out, self.static_out)

    def replay(self, leaves: List[torch.Tensor]) -> None:
        torch._foreach_copy_(self.static_in, leaves)
        self.captured.replay()

    def outputs(self):
        return unflatten(self.out_spec, (t.clone() for t in self.static_out))


class GraphedCall:
    """The CUDA graphs of one entry point and its counters (module docstring)."""

    def __init__(self, name: str):
        self.counts = {"captures": 0, "replays": 0, "eager_calls": 0}
        self.graphs: "OrderedDict[Tuple, Optional[_Graph]]" = OrderedDict()  # None: seen once
        self.trees: Dict[int, _Tree] = {}  # by module id: a freed module's keys go with it
        profiling.GRAPH_COUNTERS[name] = self.counts

    def __call__(self, module: Optional[torch.nn.Module], fn: Callable, inputs: Tuple, static: Tuple = (),
                 generator: Optional[torch.Generator] = None):
        """``fn(*inputs)``, a forward of ``module`` (None: of no module) whose
        result depends on nothing but ``inputs``, ``static``, ``generator``
        and the module's parameters and buffers."""
        leaves: List[torch.Tensor] = []
        spec = flatten(inputs, leaves)
        if torch.is_grad_enabled() or not on_card(leaves, generator):
            self.counts["eager_calls"] += 1
            return fn(*inputs)
        key = (id(module), spec, tuple((t.shape, t.stride(), t.dtype) for t in leaves), static, generator,
               self._storage_key(module), torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if key not in self.graphs:
            self._remember(key)
            self.counts["eager_calls"] += 1
            return fn(*inputs)
        self.graphs.move_to_end(key)
        graph = self.graphs[key]
        if graph is None:
            graph = self.graphs[key] = _Graph(fn, spec, leaves, generator)
            self.counts["captures"] += 1
        else:
            graph.replay(leaves)
            self.counts["replays"] += 1
        return graph.outputs()

    def _storage_key(self, module: Optional[torch.nn.Module]) -> Tuple[int, ...]:
        if module is None:
            return ()
        mid = id(module)
        if mid not in self.trees:
            self.trees[mid] = _Tree(module, lambda _, mid=mid: self._forget(mid))
        return self.trees[mid].storage_key(module)

    def _remember(self, key: Tuple) -> None:
        """Mark ``key`` seen once, dropping the oldest key over ``MAX_KEYS``."""
        self.graphs[key] = None
        while len(self.graphs) > MAX_KEYS:
            self.graphs.popitem(last=False)

    def _forget(self, mid: int) -> None:
        """A freed module's tree and keys."""
        del self.trees[mid]
        for key in [k for k in self.graphs if k[0] == mid]:
            del self.graphs[key]
