"""Captured programs: the JAX driver's compiled programs, on the card.

The JAX driver compiles each unit of its work once and then reuses it:
`CategoryModels.pose_fn` (`cppf2_tpu/eval/driver.py:59-87`, one ensemble
graph per configuration), `_frame_group_fn` (`:415-480`, one vmapped program
per (category, crop tier, bucket) group), `_vit_stage_fn` (`:354-393`, one
frame-wide ViT program per pack signature) and the jitted `preprocess_frame`
(`cppf2_tpu/infer/frontend.py:102`). A `Program` is one such unit here.

* On CUDA its first call runs the function once on a side stream (the
  warm-up that torch.cuda.graphs prescribes before a capture; autograd inside
  the function needs it), records it into a torch.cuda.CUDAGraph, in one
  memory pool shared by every program of the device, and replays it. A later
  call copies its inputs into the program's static inputs, replays the graph
  and returns clones of its outputs: a later replay of this program, or of
  another in the shared pool, may write where an output lies, and the driver
  queues its groups without reading them back.
* On the CPU, and on CUDA inside `disable_capture()` (the counterpart of
  `jax.disable_jit()`), the function runs eagerly.
* A capture or a replay that fails raises and names the program's key.
  Nothing falls back to the eager route.
* Programs do not nest: a program's body calls the eager functions, never
  another program (a capture inside a capture fails on the card). A program
  called while another one's body runs raises, on the CPU too.
* A stateful program (`stateful=True`: a train step, whose body updates the
  weights and the optimizer's state in place) must run its body exactly once
  a call. Its first CUDA call returns what its warm-up computed: the warm-up
  is that call's step. The capture that follows records and executes
  nothing, and every later call replays. What the body writes in place must
  lie outside the shared pool, allocated before the capture (the trainer's
  gradients and AdamW's moments), and the program is keyed on where it lies.
  Python side effects (the step count, the scheduler, a draw from a host
  generator) stay outside the body: a replay runs no Python.

`program(cache, key, fn, args)` finds or makes the program of a call: its key
is the caller's key (the JAX driver's) with the shape, dtype and device of
every input tensor, the value of every other input and the inputs' nesting,
so a call of other shapes gets a program of its own, as jax.jit traces again.

A graph reads and writes the addresses it was captured with. So a program
keeps alive what it writes across replays: its static inputs and outputs, and
K2's scratch (`hist16.owned_scratch`), which the kernel needs zeroed at every
launch and so lies outside the shared pool, where another capture could
reuse it. Weights are read where they lie: the driver keys its programs on
their addresses.

`weights(*modules)` is the address of every parameter and buffer of the
modules: a program that reads weights is keyed on it.

Spans and counters (`utils/profiling.py`): a call's copies into the static
inputs (`copy_in`), its `graph.replay()` (`launch`), its output clones
(`clone`) and a capture (`capture`) are spans; the frame record counts
replays, captures and their host ms (`capture_ms`) and eager runs.

Counters: the kernel wrappers count their launches in Python, in the launch
table (`ops/_build.py`), and a replay runs no Python. A program notes what
the table gained during its capture, when nothing ran on the device, takes
that back, and adds it again at each replay. It does the same for every
attribute a caller registers with `count_replays`: an integer its gain, a list
the items appended to it.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from cppf2_torch.ops import _build, hist16
from cppf2_torch.utils import profiling

_tallies: List[Tuple[Any, str]] = []   # (object, attribute) that `count_replays` registered
_disabled = 0
_pools: Dict[int, Any] = {}   # device index -> the graph memory pool its programs share
_anchors: Dict[int, Any] = {}  # device index -> the graph that keeps that pool in use
_running: List[Any] = []      # the key of the program whose body runs now, if one does
_recorders: List[Dict] = []   # the open `recorded()` blocks


@contextlib.contextmanager
def disable_capture():
    """Programs called inside run eagerly on CUDA too (they nest)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def capture_enabled() -> bool:
    return _disabled == 0


@contextlib.contextmanager
def recorded():
    """The programs called inside, found or made: {id: (program, its replays
    and its eager runs when first called here, whether that call made it)}.
    A script's models, and so their programs, may die when it returns; this
    keeps them."""
    used: Dict[int, Tuple[Any, int, int, bool]] = {}
    _recorders.append(used)
    try:
        yield used
    finally:
        del _recorders[next(i for i, u in enumerate(_recorders) if u is used)]


def weights(*modules) -> tuple:
    """Where the modules' parameters and buffers lie: a captured graph reads
    them at these addresses, so a program is keyed on them."""
    return tuple(t.data_ptr() for m in modules for t in itertools.chain(m.parameters(), m.buffers()))


def trained(optimizer) -> tuple:
    """Where a train step reads and writes an optimizer's tensors: every
    parameter, its gradient and its state tensors (AdamW's step and moments),
    and the learning rate where it is a tensor. A step program is keyed on it
    beside `weights`: a checkpoint restored into the optimizer replaces its
    state tensors, and the restored state then gets a program of its own."""
    out = []
    for group in optimizer.param_groups:
        lr = group["lr"]
        out.append(lr.data_ptr() if torch.is_tensor(lr) else None)
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            out.append((p.data_ptr(), None if p.grad is None else p.grad.data_ptr(),
                        tuple(v.data_ptr() for v in st.values() if torch.is_tensor(v))))
    return tuple(out)


def count_replays(obj, attr: str) -> None:
    """Count `obj.<attr>` (an int, or a list that grows) in the captures made
    from now on, and credit it at their replays."""
    if not any(o is obj and a == attr for o, a in _tallies):
        _tallies.append((obj, attr))


def _counts():
    """The launch table and the registered tallies as they stand."""
    return _build.snapshot(), [len(v) if isinstance(v, list) else v
                               for v in (getattr(o, a) for o, a in _tallies)]


def _take_back(before) -> Tuple[Dict[Tuple[str, str], int], List[Tuple[Any, str, Any]]]:
    """Undo what the launch table and the tallies gained since `before`
    (`_counts()`); returns the gains."""
    table0, tallies0 = before
    gained = _build.since(table0)
    for (kernel, entry), n in gained.items():
        _build.count(kernel, entry, -n)
    gains = []
    for (obj, attr), n0 in zip(list(_tallies), tallies0):
        v = getattr(obj, attr)
        if isinstance(v, list):
            gains.append((obj, attr, v[n0:]))
            del v[n0:]
        else:
            gains.append((obj, attr, v - n0))
            setattr(obj, attr, n0)
    return gained, [g for g in gains if g[2]]


def pool_handle(device):
    """The graph memory pool that the programs of `device` share.

    A one-node graph captured into the pool when it is made, and kept, holds
    the pool's use count above zero. The caching allocator asserts (in
    `create_or_incref_pool`) when a capture joins a pool whose graphs have
    all died while it still caches their memory, as it would after a
    trainer's step programs die with their step function."""
    dev = torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _pools:
        with torch.cuda.device(idx):
            handle = torch.cuda.graph_pool_handle()
            anchor = torch.cuda.CUDAGraph()
            with torch.cuda.graph(anchor, pool=handle):
                torch.zeros((), device=torch.device("cuda", idx))
            _pools[idx] = handle
            _anchors[idx] = anchor
    return _pools[idx]


def _eager(tensors) -> bool:
    """Whether a call with these input tensors runs its body eagerly: inside
    `disable_capture()`, or with no input on a card."""
    return not capture_enabled() or not any(x.device.type == "cuda" for x in tensors)


def _signature(args) -> tuple:
    """What besides the caller's key tells two calls' programs apart: the
    nesting of `args`, each tensor's shape, dtype and device, and every
    other leaf's value."""
    leaves, spec = pytree.tree_flatten(args)
    return (spec, tuple((tuple(x.shape), x.dtype, x.device) if torch.is_tensor(x) else x
                        for x in leaves))


class Program:
    """One function of tensors, captured once per key and replayed."""

    def __init__(self, key, fn: Callable, stateful: bool = False):
        self.key, self.fn, self.stateful = key, fn, stateful
        self.graph = None
        self.static: List[torch.Tensor] = []   # the input tensors the graph reads
        self.outputs = None
        self.scratch = [None]                  # K2's scratch, owned (hist16.owned_scratch)
        self.credits: Dict[Tuple[str, str], int] = {}   # launches one replay adds to the table
        self.tallies: List[Tuple[Any, str, Any]] = []   # what one replay adds to the tallies
        self.capture_ms = None                 # host ms of the warm-up and the capture (frame record)
        self.replays = 0
        self.eager_runs = 0                    # calls that ran the body eagerly

    @contextlib.contextmanager
    def _body(self):
        """The body runs: a program called meanwhile raises."""
        _running.append(self.key)
        try:
            yield
        finally:
            _running.pop()

    def credited(self, kernel: str, entry: Optional[str] = None) -> int:
        """The launches of `kernel`, or of its one `entry`, that one replay
        adds to the launch table."""
        return _build.total(self.credits, kernel, entry)

    def _credit(self) -> None:
        """Add what one replay launches and tallies, as its capture found."""
        for (kernel, entry), n in self.credits.items():
            _build.count(kernel, entry, n)
        for obj, attr, gain in self.tallies:
            v = getattr(obj, attr)
            if isinstance(v, list):
                v.extend(gain)
            else:
                setattr(obj, attr, v + gain)

    def __call__(self, *args):
        if _running:
            raise RuntimeError(f"program {self.key!r} called inside program {_running[-1]!r}: a "
                               f"program's body calls eager functions, never another program")
        leaves, spec = pytree.tree_flatten(args)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        if _eager(tensors):
            self.eager_runs += 1
            profiling.count("eager_runs")
            with self._body():
                return self.fn(*args)
        if self.graph is None:
            with profiling.span("capture"):
                first = self._capture(leaves, spec, tensors)
            profiling.count("captures")
            profiling.count("capture_ms", self.capture_ms)
            if self.stateful:
                return first
        else:
            with profiling.span("copy_in"):
                for s, x in zip(self.static, tensors):
                    if s.shape != x.shape or s.dtype != x.dtype or s.device != x.device:
                        raise RuntimeError(f"program {self.key!r}: an input of {tuple(x.shape)} "
                                           f"{x.dtype} on {x.device} where it was captured with "
                                           f"{tuple(s.shape)} {s.dtype} on {s.device}")
                    s.copy_(x)
        with profiling.span("launch"):
            try:
                self.graph.replay()
            except Exception as e:
                raise RuntimeError(f"replay of program {self.key!r} failed: {e}") from e
        self._credit()
        self.replays += 1
        profiling.count("replays")
        with profiling.span("clone"):
            return pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, self.outputs)

    def _capture(self, leaves, spec, tensors):
        """Warm up, capture into the shared pool, keep the graph; returns the
        warm-up's outputs (a stateful program's first call returns them)."""
        devs = {x.device for x in tensors}
        if len(devs) != 1:
            raise RuntimeError(f"program {self.key!r}: inputs on several devices {devs}")
        dev = tensors[0].device
        self.static = [x.clone() for x in tensors]
        it = iter(self.static)
        args = pytree.tree_unflatten([next(it) if torch.is_tensor(x) else x for x in leaves], spec)
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        try:
            with self._body(), torch.cuda.stream(side), hist16.owned_scratch(self.scratch):
                warm = self.fn(*args)
        except Exception as e:
            raise RuntimeError(f"warm-up of program {self.key!r} failed: {e}") from e
        main.wait_stream(side)
        # a stateful program returns the warm-up's outputs, copied on the caller's stream
        first = (pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, warm)
                 if self.stateful else None)
        del warm
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with self._body(), hist16.owned_scratch(self.scratch), \
                    torch.cuda.graph(graph, pool=pool_handle(dev)):
                out = self.fn(*args)
        except Exception as e:
            _take_back(before)
            raise RuntimeError(f"capture of program {self.key!r} failed: {e}") from e
        self.credits, self.tallies = _take_back(before)
        self.graph, self.outputs = graph, out
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        return first


def program(cache: Dict, key, fn: Callable, args, stateful: bool = False) -> Program:
    """The program of `key` and of the inputs `args` in `cache`, made from
    `fn` when there is none yet."""
    full = (key, _signature(args))
    prog = cache.get(full)
    if prog is None:
        prog = cache[full] = Program(full, fn, stateful)
    for used in _recorders:
        used.setdefault(id(prog), (prog, prog.replays, prog.eager_runs, prog.graph is None))
    return prog
