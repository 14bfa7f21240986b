"""A step function captured as a CUDA graph and replayed (the port's
counterpart of the JAX package's jitted, donated functions).

A step updates a tree of dataclasses whose leaves are tensors and
generators (``utils.tree.leaves``): an ``AgentState`` (``agents/base.py``),
an evaluation's loop-carried state (``train/loop.py``), the host loop's
state with its static input buffers (``train/host_loop.py``).  It works
partly in place and partly by rebinding a field to a new tensor
(``state.obs = obs``, a new ``ContextState``, ...).  A graph reads and
writes fixed addresses, so ``write_back(step)`` runs the step and then
(``leaves_kept``) copies every leaf that changed identity into the leaf it
replaced and rebinds the field to that original tensor: after the call
every tensor leaf of the tree is the tensor it was before, holding the new
value.  Networks are not leaves (an ``AgentState``'s parameters are views
of ``params`` and ``target_params``); a graph is bound to their parameters'
addresses too.  On the CPU that wrapper is all there is, and it is what
the tests hold against the plain step.

``GraphedStep`` runs a written-back step ``times`` times per call on the
card.  Its first call on a tree runs the step once for real on a side
stream (the warm-up of PyTorch's whole-network capture recipe), then
captures one more call on that stream into a ``torch.cuda.CUDAGraph``, with
every generator among the tree's leaves registered
(``register_generator_state``: a replay's draws are those the eager step
would make from the generator's state at the replay, and each replay
advances the generator as the eager step does), and replays it for the
remaining calls.  The graph is reused while the tree's leaves and networks
keep their addresses (``load_checkpoint`` writes into them in place); a
tree whose leaves moved is captured anew.  Every graph of one agent shares
its memory pool (``Agent.graph_pool``): they never run concurrently, and
nothing in the pool outlives a replay (every result lands in a leaf
allocated outside any capture), so they may replay in any order.  A
capture that fails raises, naming the step and the CUDA error; nothing
falls back to the eager step.

A caller that passes a fresh generator to each call (an evaluation) cannot
have it registered: the graph draws from generators of its own
(``own_generators``), loaded with the caller's state before the replays
and copied back after them (``copy_states``), so that the caller's
generator ends where the eager call leaves it.

Python code runs only while a graph is captured, so counters that Python
code advances (``launch_counts`` of ``ops.cuda_attention`` and
``ops.cuda_optimizer``: one per kernel launch) would count a capture, which
launches nothing, and no replay.
``counting_capture`` records what each dict of ``TRACKED_COUNTERS`` gained
during a capture and takes it back; ``CountedGraph.replay`` adds it on every
replay, so the counts stay those of the kernels that ran.  For the same
reason a step's phases (``utils/profiling.py``) are seen inside a replay
only through the boundary events that a capture made while tracing records
into the graph: the graph keeps them (``CountedGraph.marks``), and
``GraphedStep.phase_ms`` reads its last replay's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from dtqn_tpu_torch.models.stacked import StackedNetwork
from dtqn_tpu_torch.ops import cuda_attention, cuda_optimizer
from dtqn_tpu_torch.utils import profiling
from dtqn_tpu_torch.utils.tree import fields, leaves

# Dicts of counts, by name, that a replay advances by what they gained
# while its graph was captured.  The name is looked up at each replay: a
# caller that counts more (a ledger of launches by shape) may register a
# fresh dict under its name for each stretch it counts.
TRACKED_COUNTERS: Dict[str, Dict[Any, int]] = {
    "launch_counts": cuda_attention.launch_counts,
    "optimizer_launch_counts": cuda_optimizer.launch_counts,
}

Step = Callable[[Any], Any]
Gains = Dict[str, Dict[Any, int]]


@contextlib.contextmanager
def counting_capture() -> Iterator[Gains]:
    """Yields a dict that, when the context closes, holds by name what each
    tracked counter gained during the context; each counter is set back to
    what it held when the context opened."""
    before = {name: (c, dict(c)) for name, c in TRACKED_COUNTERS.items()}
    gains: Gains = {}
    try:
        yield gains
    finally:
        for name, (counter, old) in before.items():
            gained = {k: n - old.get(k, 0) for k, n in counter.items()
                      if n != old.get(k, 0)}
            counter.clear()
            counter.update(old)
            if gained:
                gains[name] = gained


class CountedGraph:
    """A captured graph and what the tracked counters gained during its
    capture, added again on every replay to the counter registered under
    each name then; and the phases' boundary events that the capture
    recorded (``profiling.recording_phases``; none while not tracing),
    which live as long as the graph that records them."""

    def __init__(self, graph, gains: Gains,
                 marks: Optional[profiling.Marks] = None):
        self.graph = graph
        self.gains = gains
        self.marks = marks or []

    def replay(self) -> None:
        self.graph.replay()
        for name, gained in self.gains.items():
            counter = TRACKED_COUNTERS.get(name)
            if counter is None:
                continue
            for k, n in gained.items():
                counter[k] = counter.get(k, 0) + n


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _rebind(node: Any, originals: Dict[str, Any], prefix: str = "") -> Any:
    """``node`` with every tensor leaf set back to ``originals[name]``:
    dataclasses in place, named tuples (the LSTM carry) replaced."""
    changes = {}
    for field, value in fields(node):
        name = prefix + field
        if isinstance(value, torch.Tensor):
            if value is not originals[name]:
                changes[field] = originals[name]
        elif dataclasses.is_dataclass(value) or isinstance(value, tuple):
            new = _rebind(value, originals, name + ".")
            if new is not value:
                changes[field] = new
    if not changes:
        return node
    if isinstance(node, tuple):
        return node._replace(**changes)
    for field, value in changes.items():
        setattr(node, field, value)
    return node


@contextlib.contextmanager
def leaves_kept(state) -> Iterator[None]:
    """Inside the context the state's fields may be rebound to new tensors;
    when it closes, every tensor leaf is the tensor it was when the context
    opened (same storage), holding what the context left there."""
    originals = dict(leaves(state))
    yield
    new = dict(leaves(state))
    if new.keys() != originals.keys():
        raise RuntimeError("the state's structure changed: "
                           f"{sorted(new.keys() ^ originals.keys())}")
    moved = []
    for name, old in originals.items():
        leaf = new[name]
        if leaf is old:
            continue
        if not isinstance(old, torch.Tensor):
            raise RuntimeError(f"the generator {name} was replaced")
        if leaf.shape != old.shape or leaf.dtype != old.dtype:
            raise RuntimeError(
                f"{name} changed from {tuple(old.shape)} {old.dtype} to "
                f"{tuple(leaf.shape)} {leaf.dtype}")
        moved.append((old, leaf))
    # A new leaf that reads an original about to be overwritten is taken
    # first.
    targets = {_storage(old) for old, _ in moved}
    moved = [(old, leaf.clone() if _storage(leaf) in targets else leaf)
             for old, leaf in moved]
    with torch.no_grad():
        for old, leaf in moved:
            old.copy_(leaf)
    _rebind(state, originals)


def write_back(step: Step) -> Step:
    """``step`` whose result lands in the state's own tensors
    (``leaves_kept``)."""

    def run(state):
        with leaves_kept(state):
            step(state)
        return state

    return run


def networks(node: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, network) for every network of a tree of dataclasses:
    what ``leaves`` leaves out."""
    for field, value in fields(node):
        if isinstance(value, (nn.Module, StackedNetwork)):
            yield prefix + field, value
        elif dataclasses.is_dataclass(value):
            yield from networks(value, prefix + field + ".")


def addresses(state) -> Tuple:
    """What a graph of ``state`` is bound to: every tensor leaf's address,
    every generator, and the parameters of every network."""
    return tuple(
        (name, leaf.data_ptr() if isinstance(leaf, torch.Tensor)
         else id(leaf))
        for name, leaf in leaves(state)) + tuple(
        (name, tuple(p.data_ptr() for p in network.parameters()))
        for name, network in networks(state))


def generators(state) -> List[torch.Generator]:
    return [leaf for _, leaf in leaves(state)
            if isinstance(leaf, torch.Generator)]


def fresh_buffers(tree):
    """``tree`` with every tensor leaf replaced by a copy of its own, in
    place: buffers that nothing else holds, for a written-back step to
    write into."""
    return _rebind(tree, {name: leaf.clone() for name, leaf in leaves(tree)
                          if isinstance(leaf, torch.Tensor)})


def _as_list(generator) -> List[torch.Generator]:
    return [generator] if isinstance(generator, torch.Generator) else list(
        generator)


def own_generators(like, device):
    """Generators on ``device`` as many as ``like`` holds (one, or a list
    per seed), for a graph to register in the place of a caller's."""
    owned = [torch.Generator(device=device) for _ in _as_list(like)]
    return owned[0] if isinstance(like, torch.Generator) else owned


def copy_states(source, target) -> None:
    """Each generator of ``target`` (one, or a list) set to the state of its
    counterpart in ``source``."""
    for s, t in zip(_as_list(source), _as_list(target), strict=True):
        t.set_state(s.get_state())


def shared_pool(owner):
    """The graph memory pool of ``owner`` (an ``Agent``), made at its first
    capture."""
    if owner.graph_pool is None:
        owner.graph_pool = torch.cuda.graph_pool_handle()
    return owner.graph_pool


# One side stream per device, on which every step is warmed up and then
# captured.  PyTorch keeps a cuBLAS workspace per (handle, stream) for the
# life of the process, made at the stream's first product: made by the
# warm-up, it stays out of the graphs' pool, which a capture that made it
# would keep from ever being freed.
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.device(device).index or 0
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device)
    return _STREAMS[index]


class GraphedStep:
    """``times`` calls of ``step`` per call on a tree on the card
    (``owner.device``): the first call on a tree runs the step once eagerly
    and captures it, every other one is a graph replay.  ``warm_up_s`` and
    ``capture_s`` time the last capture (host seconds, each ending in a
    synchronize)."""

    def __init__(self, name: str, step: Step, owner, times: int):
        self.name = name
        self.step = write_back(step)
        self.owner = owner
        self.times = times
        self.graph: Optional[CountedGraph] = None
        self.bound: Optional[Tuple] = None
        self.captures = 0
        self.warm_up_s = self.capture_s = None
        self.replayed = False  # since the last capture

    def __call__(self, state):
        todo = self.times
        if todo > 0 and addresses(state) != self.bound:
            self.capture(state)
            todo -= 1
        for _ in range(todo):
            self.graph.replay()
        self.replayed = self.replayed or todo > 0
        return state

    def phase_ms(self) -> Optional[dict]:
        """Device ms by phase of the last replay, and its span from the
        first boundary to the last (``profiling.phase_ms``), once it has
        ended; None for a graph captured while not tracing, or not replayed
        since its capture."""
        if self.graph is None or not self.graph.marks or not self.replayed:
            return None
        self.graph.marks[-1][1].synchronize()
        return profiling.phase_ms(self.graph.marks)

    def capture(self, state) -> None:
        """Runs the step once for real, then captures it into a graph bound
        to ``state``'s leaves and networks.  An earlier graph lives until the
        new one is captured: the pool they share stays in use throughout."""
        self.bound = None
        device = self.owner.device
        main = torch.cuda.current_stream(device)
        side = capture_stream(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step(state)
        main.wait_stream(side)
        torch.cuda.synchronize(device)
        self.warm_up_s = time.perf_counter() - t0

        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"capturing {self.name}: PyTorch {torch.__version__} has no "
                "CUDAGraph.register_generator_state, so a graph cannot draw "
                "from the agent's generators")
        for gen in generators(state):
            graph.register_generator_state(gen)
        t0 = time.perf_counter()
        try:
            with counting_capture() as gains:
                with torch.cuda.graph(graph, pool=shared_pool(self.owner),
                                      stream=side):
                    with profiling.recording_phases() as marks:
                        self.step(state)
            torch.cuda.synchronize(device)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing {self.name} as a CUDA graph failed: {e}") from e
        self.capture_s = time.perf_counter() - t0
        self.graph = CountedGraph(graph, gains, marks)
        self.bound = addresses(state)
        self.captures += 1
        self.replayed = False
