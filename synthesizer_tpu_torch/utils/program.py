"""Compiled device programs: the port's counterpart of ``jax.jit``.

The JAX package compiles each hot path (a patch step, a voice block, the
reverb, an fx processor's chunk, a ``Sample``'s pending op chain) into one
XLA program, cached by its static configuration and its inputs' shapes,
so that a call costs one dispatch instead of one per op.  PyTorch runs
eagerly, one launch per op; a :class:`Program` gets the JAX behaviour back
on the card with a CUDA graph:

* **The key** is the program's static configuration (fixed when the
  ``Program`` is built by :func:`program`, which keeps one module cache of
  them) plus the structure, shape, dtype and device of every tensor input
  and the number of scalars, as each JAX cache keys.
  Dynamic numbers -- a block's first frame, a release frame, knob values
  -- travel in the scalar vectors ``f`` (float32) and ``i`` (int64) as
  device tensors, so changing a knob reuses the program: a Python number
  inside the body would be baked into the capture.
* **On the card** the first call of a key runs the body eagerly (the
  warm-up a capture needs), the second captures it (a ``CUDAGraph`` on a
  side stream, ``capture_error_mode="thread_local"``, a memory pool of
  the key's own) and replays it, and every later call costs one pinned
  host -> device copy of the scalars, one device copy per tensor input
  into the captured buffers, one replay, and one copy of each output, so
  that no output is overwritten by the next replay.  A capture that fails
  raises, naming the key: nothing falls back to eager.  One lock per
  program covers a call from its input copies to its outputs, and one
  lock in the process lets one capture run at a time.
* **Memory is bounded.**  The keys that hold device buffers (a graph's
  pool, its static inputs, the constants of its first call) form one
  least-recently-used list over every program: past :data:`MAX_KEYS`
  keys or :data:`MAX_BYTES` bytes the oldest key is dropped, and its next
  call starts again with an eager first call.  A server that renders
  requests of many lengths therefore holds the newest ones only.  A body
  must also stay short whatever its input's length: a loop over a whole
  signal runs as replays of a program of a fixed number of steps (the
  reverb's comb stage, ``ops.effects``; the patch render, ``graph``).
* **On the CPU** every call runs the body eagerly.  :meth:`Program.trace_cpu`
  traces the body once with ``make_fx`` on fake tensors, the CPU analogue
  of a capture, so that the tests can show that a body reads no host
  value and bakes no number.
* A program called inside another program's body runs its body inline,
  as a ``jax.jit`` function inlines into its caller's trace.

Host arrays a body needs (delay tables, masks, wavetables) go through
:func:`constant`: made once for each key, before the capture, and checked
against the array the capture asks for.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import profiling

#: the most keys that hold device buffers at once, over every program
MAX_KEYS = 128
#: the most bytes that those keys hold at once: captured pools, static
#: inputs and recorded constants
MAX_BYTES = 4 << 30

_tls = threading.local()
#: one capture at a time in the process, and no pool is released while one
#: runs
_CAPTURE_LOCK = threading.Lock()
#: the programs, keyed by (name, static configuration, device)
_PROGRAMS: dict = {}
_PROGRAMS_LOCK = threading.Lock()
#: (id(program), key) -> (program, key, entry), oldest first
_LRU: "collections.OrderedDict" = collections.OrderedDict()
_LRU_LOCK = threading.Lock()
#: [bytes the listed keys hold, bytes of dropped pools not yet released]
_BYTES = [0, 0]


def _depth() -> int:
    return getattr(_tls, "depth", 0)


class _Inside:
    """Marks the thread as running a program body (nested programs then
    run inline), and installs the constants' recorder for it."""

    def __init__(self, consts=None):
        self.consts = consts

    def __enter__(self):
        self.saved = (_depth(), getattr(_tls, "consts", None))
        _tls.depth = self.saved[0] + 1
        if self.consts is not None:
            _tls.consts = self.consts
        return self

    def __exit__(self, *exc):
        _tls.depth, _tls.consts = self.saved
        return False


class _Constants:
    """The host constants of one key, in the order the body asks for them:
    recorded by the eager first call, handed out again to the capture."""

    def __init__(self):
        self.items: list = []
        self.pos: Optional[int] = None       # None while recording
        self.nbytes = 0

    def get(self, a: np.ndarray, device) -> torch.Tensor:
        if self.pos is None:
            t = torch.from_numpy(a).to(device)
            self.items.append((a.copy(), t))
            self.nbytes += t.numel() * t.element_size()
            return t
        if self.pos >= len(self.items):
            raise RuntimeError("the body asked for more host constants "
                               "than its first call")
        want, t = self.items[self.pos]
        self.pos += 1
        if want.dtype != a.dtype or want.shape != a.shape \
                or not np.array_equal(want, a):
            raise RuntimeError("a host constant of the body changed between "
                               "two calls of one key: it must be a dynamic "
                               "input")
        return t


def constant(array, device, dtype=None) -> torch.Tensor:
    """A host array (or list) as a tensor on ``device``.  Inside a program
    on the card the tensor is made once for each key; elsewhere it is
    made at each call."""
    a = np.asarray(array, dtype=dtype)
    dev = torch.device(device)
    rec = getattr(_tls, "consts", None)
    if rec is None or dev.type != "cuda":
        return torch.from_numpy(a).to(dev)
    return rec.get(a, dev)


def _resolve(device) -> torch.device:
    """``device`` with the current card's index where it names none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _scalars(f: Sequence, i: Sequence, out: torch.Tensor) -> None:
    """Write the scalars into a float64 host vector: float32 knobs are
    rounded to f32 in the body, int64 values are exact up to 2^53."""
    if len(i) and max(abs(int(v)) for v in i) > 2 ** 53:
        raise ValueError("an int64 program scalar beyond 2^53")
    out.numpy()[:] = [float(v) for v in f] + [float(int(v)) for v in i]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Entry:
    __slots__ = ("graph", "consts", "inputs", "vec", "host", "event",
                 "outputs", "spec", "nbytes")

    def __init__(self):
        self.graph = None
        self.consts = _Constants()
        self.nbytes = 0


def _hold(prog: "Program", key, e: _Entry, nbytes: int) -> None:
    """List (or move to the newest place) the key, count the bytes it
    holds, and drop the oldest keys past the bounds.  A dropped key's
    graph and buffers are freed when no call holds them any more; its
    pool's memory returns to the card once dropped pools add up to a
    quarter of :data:`MAX_BYTES` (``torch.cuda.empty_cache``, which must
    not meet a capture)."""
    k = (id(prog), key)
    dropped = []
    with _LRU_LOCK:
        old = _LRU.pop(k, None)
        if old is not None:
            _BYTES[0] -= old[2].nbytes
        e.nbytes = nbytes
        _BYTES[0] += nbytes
        _LRU[k] = (prog, key, e)
        for k2 in list(_LRU):
            if len(_LRU) <= MAX_KEYS and _BYTES[0] <= MAX_BYTES:
                break
            if k2 == k:
                continue
            p2, key2, e2 = _LRU.pop(k2)
            if p2._entries.get(key2) is e2:
                del p2._entries[key2]
            _BYTES[0] -= e2.nbytes
            if e2.graph is not None:
                _BYTES[1] += e2.nbytes
            dropped.append(e2)
        release = _BYTES[1] > MAX_BYTES // 4
        if release:
            _BYTES[1] = 0
    del dropped
    if release:
        with _CAPTURE_LOCK:
            torch.cuda.empty_cache()


def _touch(prog: "Program", key) -> None:
    with _LRU_LOCK:
        k = (id(prog), key)
        if k in _LRU:
            _LRU.move_to_end(k)


def held_bytes() -> int:
    """The bytes the listed keys hold (``MAX_BYTES`` bounds it)."""
    return _BYTES[0]


class Program:
    """``body(*args, f, i)`` as one device program per key (module
    docstring).  ``args`` are tensors or tuples/lists of them; ``f`` is a
    float32 and ``i`` an int64 1-D tensor of the dynamic scalars on the
    program's device.  The body returns a tensor or a structure of
    tensors, computes only on the device and reads nothing back from it.

    ``static`` is the configuration the body was built from; it names the
    program in errors and its counters describe it.  ``aux`` is what the
    ``build`` handed back beside the body (an initial state).  Counters:
    ``eager_calls`` (first calls of a key on the card, every call on the
    CPU), ``captures``, ``replays``, and the host seconds the captures
    took (``capture_s``), of which ``capture_end`` (the graph's
    instantiation) took ``instantiate_s``."""

    def __init__(self, body: Callable, name: str, device, static=(),
                 aux=None):
        self.body = body
        self.name = name
        self.device = _resolve(device)
        self.static = static
        self.aux = aux
        self._entries: dict = {}
        self._lock = threading.Lock()
        self.eager_calls = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.instantiate_s = 0.0

    def __len__(self) -> int:
        """The number of keys listed (on the card, one captured graph each
        from its second call)."""
        return len(self._entries)

    def _run(self, args, vec: torch.Tensor, nf: int):
        f = vec[:nf].to(torch.float32)
        i = vec[nf:].to(torch.int64)
        return self.body(*args, f=f, i=i)

    def _vec(self, f, i) -> torch.Tensor:
        """The scalars as one float64 vector on the device.  A 0-dim tensor
        among them (a nested call passes its caller's device scalars) is
        stacked on the device; numbers alone are a host constant."""
        vals = list(f) + list(i)
        if any(isinstance(v, torch.Tensor) for v in vals):
            return torch.stack([
                v.reshape(()).to(self.device, torch.float64)
                if isinstance(v, torch.Tensor)
                else torch.full((), float(v), dtype=torch.float64,
                                device=self.device) for v in vals])
        host = torch.empty(len(vals), dtype=torch.float64)
        _scalars(f, i, host)
        return constant(host.numpy(), self.device)

    def eager(self, *args, f=(), i=()):
        """The body run eagerly on these inputs (no capture, no count):
        the reference a replay is held against."""
        vec = self._vec(f, i)
        with _Inside():
            return self._run(args, vec, len(f))

    def trace_cpu(self, *args, f=(), i=()):
        """Trace the body once on fake tensors (``make_fx``): returns a
        callable ``traced(*args, f=..., i=...)`` that replays the trace on
        new inputs of the same key.  A body that reads a device value
        raises here; a number baked into the body replays its old value.
        For the tests: the CPU analogue of a capture, which it follows:
        an eager run first, so that whatever the body builds and caches
        (a nested program, a lowered patch) is built from real tensors."""
        from torch.fx.experimental.proxy_tensor import make_fx
        self.eager(*args, f=f, i=i)
        leaves, spec = pytree.tree_flatten(list(args))
        nf = len(f)

        def flat(*xs):
            with _Inside():
                return self._run(pytree.tree_unflatten(list(xs[:-1]), spec),
                                 xs[-1], nf)

        vec = self._vec(f, i)
        gm = make_fx(flat, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*leaves, vec)

        def traced(*args2, f=(), i=()):
            leaves2, spec2 = pytree.tree_flatten(list(args2))
            if spec2 != spec or len(f) != nf:
                raise ValueError("trace_cpu: another key than the trace's")
            return gm(*leaves2, self._vec(f, i))
        return traced

    def __call__(self, *args, f=(), i=()):
        if _depth():
            # inside another program's body: inline, as jit inlines
            return self._run(args, self._vec(f, i), len(f))
        profiling.record_program_launch()
        leaves, spec = pytree.tree_flatten(list(args))
        for t in leaves:
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise ValueError(
                    f"program {self.name}: every input must be a tensor on "
                    f"{self.device}, got {type(t).__name__}"
                    + (f" on {t.device}" if isinstance(t, torch.Tensor)
                       else ""))
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device)
                           for t in leaves), len(f), len(i))
        if self.device.type != "cuda":
            with self._lock:
                if key not in self._entries:
                    e = self._entries[key] = _Entry()
                    _hold(self, key, e, 0)
                else:
                    _touch(self, key)
                self.eager_calls += 1
            vec = self._vec(f, i)
            with _Inside():
                return self._run(args, vec, len(f))
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _Entry()
                self.eager_calls += 1
                vec = self._vec(f, i)
                with _Inside(e.consts):
                    out = self._run(args, vec, len(f))
                _hold(self, key, e, e.consts.nbytes)
                return out
            _touch(self, key)
            if e.graph is None:
                self._capture(e, key, leaves, spec, f, i)
            else:
                for dst, src in zip(e.inputs, leaves):
                    dst.copy_(src)
                e.event.synchronize()
                _scalars(f, i, e.host)
                e.vec.copy_(e.host, non_blocking=True)
                e.event.record()
            e.graph.replay()
            self.replays += 1
            outs = [t.clone() for t in e.outputs]
        return pytree.tree_unflatten(outs, e.spec)

    def _capture(self, e: _Entry, key, leaves, spec, f, i) -> None:
        e.inputs = [t.clone() for t in leaves]
        e.host = torch.empty(len(f) + len(i), dtype=torch.float64,
                             pin_memory=True)
        _scalars(f, i, e.host)
        e.vec = e.host.to(self.device, non_blocking=True)
        e.event = torch.cuda.Event()
        e.event.record()
        graph = torch.cuda.CUDAGraph()
        e.consts.pos = 0
        args = pytree.tree_unflatten(list(e.inputs), spec)
        # a side stream of the key's own, ordered after the inputs' copies
        side = torch.cuda.Stream(self.device)
        here = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            before = torch.cuda.memory_reserved(self.device)
            side.wait_stream(here)
            try:
                with torch.cuda.stream(side), _Inside(e.consts):
                    graph.capture_begin(
                        pool=torch.cuda.graph_pool_handle(),
                        capture_error_mode="thread_local")
                    try:
                        out = self._run(args, e.vec, len(f))
                    finally:
                        t1 = time.perf_counter()
                        graph.capture_end()
            except Exception as exc:
                raise RuntimeError(
                    f"program {self.name} {self.static!r}: the capture of "
                    f"key {key!r} failed: {exc}") from exc
            here.wait_stream(side)
            pool = max(0, torch.cuda.memory_reserved(self.device) - before)
            t2 = time.perf_counter()
            self.capture_s += t2 - t0
            self.instantiate_s += t2 - t1
        e.outputs, e.spec = pytree.tree_flatten(out)
        for t in e.outputs:
            if not isinstance(t, torch.Tensor):
                raise RuntimeError(f"program {self.name}: the body returned "
                                   f"a {type(t).__name__}, not a tensor")
        # the recorded host copies served their check
        e.consts.items = [(None, t) for _, t in e.consts.items]
        e.graph = graph
        self.captures += 1
        self._entries[key] = e          # listed again if it was dropped
        _hold(self, key, e, pool + _nbytes(e.inputs) + e.consts.nbytes)


def program(name: str, static, build: Callable, device) -> Program:
    """The program ``name`` of ``static`` on ``device``, from the module's
    one cache of programs (the counterpart of the JAX package's per-module
    caches).  ``build()`` makes its body the first time, from ``static``
    alone; it returns the body, or (body, aux) where the caller needs
    something built with it (an initial state: ``Program.aux``)."""
    dev = _resolve(device)
    k = (name, static, dev)
    prog = _PROGRAMS.get(k)
    if prog is None:
        made = build()
        body, aux = (made, None) if callable(made) else made
        with _PROGRAMS_LOCK:
            prog = _PROGRAMS.setdefault(k, Program(body, name, dev, static,
                                                   aux))
    return prog


def programs(name: str) -> list:
    """The cached programs named ``name`` (for tests and reports)."""
    return [p for (n, _, _), p in list(_PROGRAMS.items()) if n == name]


class Flat:
    """A fixed structure of tensors held as ONE byte buffer, so that a
    program's carried state costs one copy in and one copy out.  Leaves are
    laid out by descending element size, so every view is aligned."""

    def __init__(self, tree, device):
        leaves, self.spec = pytree.tree_flatten(tree)
        self.device = torch.device(device)
        order = sorted(range(len(leaves)),
                       key=lambda k: -leaves[k].element_size())
        #: (leaf index, byte offset, byte length, shape, dtype), leaf order
        self.layout = []
        off = 0
        for k in order:
            t = leaves[k]
            nb = t.numel() * t.element_size()
            self.layout.append((k, off, nb, tuple(t.shape), t.dtype))
            off += nb
        self.nbytes = off
        self.layout.sort()

    def pack(self, tree) -> torch.Tensor:
        leaves = pytree.tree_leaves(tree)
        parts = sorted((off, leaves[k]) for k, off, _, _, _ in self.layout)
        if not parts:
            return torch.zeros(0, dtype=torch.uint8, device=self.device)
        return torch.cat([t.reshape(-1).view(torch.uint8) for _, t in parts])

    def unpack(self, buf: torch.Tensor):
        return pytree.tree_unflatten(
            [buf[off:off + nb].view(dt).reshape(shape)
             for _, off, nb, shape, dt in self.layout], self.spec)
