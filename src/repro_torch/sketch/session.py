"""StreamSession: the stateful host-side companion of the sketch API.

Counterpart of ``repro/sketch/session.py`` (``StreamSession``, :132):
block buffering (``extend``/``observe`` auto-flush full blocks, the
tail zero-weight padded), validated ``ingest``, windowed deletion
scheduling (``push`` expires whole batches on per-tenant FIFOs,
``observe`` single items, after ``window`` steps; ``schedule_batch``
returns the due expiries without ingesting them), queries that flush
first (frequency reads, and ranks and quantiles of a quantile spec),
merge and consolidation, and tagged checkpoints with an optional
scheduling snapshot. A quantile state's 0-d ``mass`` is a state buffer
like its bank's three.

Ingest goes through one cached compiled ingest per ``(spec, block,
donate)`` and mesh layout (``_ingest_fn``, as the reference's jitted
one): on the card a CUDA graph of the adapter's ``update`` per state
shape, captured at its first call and replayed per block; on the CPU the
eager update. Under a mesh whose "shards" axes the sharded bank's
``"auto"`` path takes (``mesh_layout``), the update is the shard_map
path, DTensors in and out, and runs eagerly: no graph is captured.
``BlockFeeder`` stages block i on the host and the copy engine while
block i-1 computes.

Donation differs from JAX's. A donated JAX buffer is invalid after the
next ingest and raises when read; with ``donate=True`` here the next
ingest overwrites it: a state a caller kept from the session then holds
the newer state. ``donate=False`` leaves every kept state as it was, at
one device copy of the bank per block.

Fault tolerance (reference ``session.py:34-43``): ``replay=N`` keeps the
last N ingested blocks, host copies keyed by a block sequence number
(``replay_log``, for ``elastic.recover_session``); ``fault_plan`` (a
``faults.FaultPlan``) drops, duplicates, corrupts or delays a shard's
slice at the block boundary, the log holding the intended block; a
``monitor`` (``train.straggler.StragglerMonitor``) observes each shard's
block time, inflated by injected delays. ``save(include_schedule=True)``
carries pending delayed slices and the resize ``error_slack`` in the
reference's key names.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
import weakref
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.sketch_update import kernel as _kernel
from ..parallel import sharding as psh
from ..platform import DEFAULT_DEVICE, donate_state_buffers, resolve_device
from . import api
from .api import SketchSpec
from .state import I32


# ---------------------------------------------------------------------------
# The compiled ingest and its cache (reference session.py:67-129)
# ---------------------------------------------------------------------------

def ingest_cache_spec(spec: SketchSpec) -> SketchSpec:
    """A spec's compiled-ingest cache identity. The update reads the spec
    only through kind, variant, backend, bits and shards (the tenant
    adapter takes the tenant count from the state's shape), so tenant
    specs collapse onto a ``tenants=1`` form (capacity folded back into
    ``k``) and the cache stays bounded by layouts, not tenant
    populations; a cell holds one CUDA graph per state shape."""
    if spec.tenants is None:
        return spec
    changes = {"tenants": 1, "tenant_caps": None}
    if spec.tenant_caps is not None:
        changes["k"] = int(sum(spec.tenant_caps))
    return dataclasses.replace(spec, **changes)


def mesh_layout(spec: SketchSpec) -> Optional[Tuple]:
    """The active mesh as a sharded spec's update sees it: ``(mesh,
    axes)`` when the sharded banks' ``"auto"`` path takes the shard_map
    path (a mesh whose "shards" axes have 2 or more ranks and divide the
    spec's S), else None (the single-device update). Part of a compiled
    ingest cell's key, so a mesh layout never shares a cell with a
    single-device one."""
    if spec.shards is None:
        return None
    from .sharded import _shard_mesh_axes

    axes = _shard_mesh_axes(spec.shards)
    return (psh.current_mesh(), axes) if axes else None


def _leaves(state) -> List[torch.Tensor]:
    """The tensors of a state in field order, nested named tuples
    flattened: a bank's (ids, counts, errors), a dyadic state's 0-d
    ``mass`` after them, the family's two banks and then its key."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in _leaves(part)]


def _like(state, leaves):
    """A state of ``state``'s structure holding ``leaves``."""
    it = iter(leaves)

    def build(part):
        if isinstance(part, torch.Tensor):
            return next(it)
        return type(part)(*(build(p) for p in part))

    return build(state)


def _layout(spec: SketchSpec) -> dict:
    """A spec's fields but ``backend``: what two merged sessions must
    share."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
            if f.name != "backend"}


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A new tensor object on ``t``'s memory."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(t)


class _Graph:
    """One captured ingest: the CUDA graph of one state shape, its static
    buffers (the state's leaves, the block's items and weights), the
    launch counts it holds, and the states it returned."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.device: Optional[torch.device] = None
        self.buf: List[torch.Tensor] = []
        self.items: Optional[torch.Tensor] = None
        self.weights: Optional[torch.Tensor] = None
        self.delta: Dict = {}
        self.held: Optional[list] = None   # [(weakref, version)] returned
        self.lent: Optional[list] = None   # weakrefs to donated aliases


class CompiledIngest:
    """The ``(state, items, weights) -> state`` ingest of one cache cell.

    CPU states take the adapter's eager update. On the card the ingest
    is a CUDA graph of ``adapter.update`` per state shape (tenant specs
    that differ only in their tenant count share a cell and hold one
    graph each): it reads the graph's own state buffers and the block's
    static items and weights, and ends by writing the new state back
    into the same buffers. It is captured at the first call on a shape,
    after that call's block ran eagerly on a side stream (the warm-up
    PyTorch's graph documentation asks for: it builds and loads the
    kernels), so every block, the first included, launches each kernel
    once. A capture that fails raises; nothing falls back to the eager
    update. A graph stays on the device it was captured on.

    The wrappers count their launches at capture, when nothing runs:
    those counts are taken back, kept as the graph's delta and added at
    every replay.

    A state that arrives from outside (a restore, a merge, a spill,
    another session of the same cell) is copied into the buffers first;
    the state this graph last returned, unchanged since (the same tensor
    objects at the same version), is used as it is. With donation the
    returned state shares the buffers' memory, so the next replay
    updates it in place; before another state is copied in, a returned
    state still alive is moved to memory of its own, so two sessions
    sharing the cell never see each other's blocks. Without donation
    each call returns a copy of the buffers.

    ``items``/``weights`` are block-sized int32 tensors (pinned host or
    device) or host arrays; ``staged``, a CUDA event, is recorded once
    the block has been copied into the graph's inputs (the caller's host
    buffer may then be reused).
    """

    def __init__(self, spec: SketchSpec, block: int, donate: bool,
                 layout: Optional[Tuple] = None):
        self.spec = spec
        self.block = block
        self.layout = layout   # the cell's mesh_layout (its cache key)
        # donation only on the card (platform.donate_state_buffers)
        self.donate = bool(donate) and donate_state_buffers()
        self.graphs: Dict[Tuple, _Graph] = {}
        self._last: Optional[_Graph] = None

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The CUDA graph the last call replayed or captured (None before
        a call on the card)."""
        return self._last.graph if self._last is not None else None

    def __call__(self, state, items, weights, staged=None):
        if not isinstance(items, torch.Tensor):
            items = torch.from_numpy(np.ascontiguousarray(items, np.int32))
        if not isinstance(weights, torch.Tensor):
            weights = torch.from_numpy(np.ascontiguousarray(weights, np.int32))
        if items.shape != (self.block,) or weights.shape != (self.block,):
            raise ValueError(
                f"the compiled ingest takes blocks of {self.block} updates, "
                f"got items {tuple(items.shape)}, weights "
                f"{tuple(weights.shape)}")
        leaves = _leaves(state)
        dev = leaves[0].device
        if (dev.type != "cuda" or mesh_layout(self.spec) is not None
                or any(psh.is_dtensor(t) for t in leaves)):
            # the CPU, or a mesh: the eager update (a capture would hold
            # DTensor dispatch and, for a mesh-sharded state, a gather)
            return api.adapter_for(self.spec).update(
                self.spec, state, items.to(dev, I32), weights.to(dev, I32))
        shape = tuple(t.shape for t in leaves)
        g = self.graphs.get(shape)
        if g is None:
            g = _Graph()
            out = self._capture(g, state, items, weights, staged)
            self.graphs[shape] = self._last = g
            return out
        if dev != g.device:
            raise ValueError(f"this compiled ingest was captured on "
                             f"{g.device}, the state is on {dev}")
        self._last = g
        return self._replay(g, state, items, weights, staged)

    def _update(self, g: _Graph, template):
        return _leaves(api.adapter_for(self.spec).update(
            self.spec, _like(template, g.buf), g.items, g.weights))

    @staticmethod
    def _stage(g: _Graph, items, weights, staged) -> None:
        g.items.copy_(items, non_blocking=True)
        g.weights.copy_(weights, non_blocking=True)
        if staged is not None:
            staged.record()

    @staticmethod
    def _holds(g: _Graph, leaves) -> bool:
        return g.held is not None and all(
            ref() is t and t._version == version
            for (ref, version), t in zip(g.held, leaves))

    @staticmethod
    def _release(g: _Graph) -> None:
        """Move donated aliases still alive to memory of their own."""
        for ref in g.lent or ():
            t = ref()
            if t is not None:
                t.set_(t.clone())
        g.lent = None

    def _out(self, g: _Graph, state):
        if self.donate:
            if g.lent is None:
                out = [_alias(b) for b in g.buf]
                g.lent = [weakref.ref(t) for t in out]
            else:
                out = [ref() for ref in g.lent]
        else:
            out = [b.clone() for b in g.buf]
        g.held = [(weakref.ref(t), t._version) for t in out]
        return _like(state, out)

    def _capture(self, g: _Graph, state, items, weights, staged):
        leaves = _leaves(state)
        dev = leaves[0].device
        g.buf = [t.clone() for t in leaves]
        g.items = torch.empty(self.block, dtype=I32, device=dev)
        g.weights = torch.empty(self.block, dtype=I32, device=dev)
        self._stage(g, items, weights, staged)
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            # warm-up: this block's ingest, eagerly
            for b, t in zip(g.buf, self._update(g, state)):
                b.copy_(t)
        before = _kernel.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                for b, t in zip(g.buf, self._update(g, state)):
                    b.copy_(t)
        finally:
            after = _kernel.launch_counts()
            _kernel.set_launch_counts(before)
        caller.wait_stream(side)
        g.delta = _kernel.launch_delta(before, after)
        g.graph, g.device = graph, dev
        return self._out(g, state)

    def _replay(self, g: _Graph, state, items, weights, staged):
        leaves = _leaves(state)
        if not self._holds(g, leaves):
            self._release(g)
            for b, t in zip(g.buf, leaves):
                b.copy_(t)
        self._stage(g, items, weights, staged)
        g.graph.replay()
        _kernel.set_launch_counts(_kernel.add_counts(
            _kernel.launch_counts(), g.delta))
        return self._out(g, state)


@functools.lru_cache(maxsize=None)
def _ingest_fn_cached(spec: SketchSpec, block: int, donate: bool = True,
                      layout: Optional[Tuple] = None) -> CompiledIngest:
    return CompiledIngest(spec, block, donate, layout)


def _ingest_fn(spec: SketchSpec, block: int, donate: bool = True
               ) -> CompiledIngest:
    """The compiled ingest of one ``(spec, block, donate)`` cell, cached
    for the process (unbounded, as the reference's: an eviction would
    capture a live session's graph anew). The spec is normalised first
    (``ingest_cache_spec``), and the active mesh's layout for the spec
    (``mesh_layout``) is part of the key. A cell's CUDA graph holds the
    update's intermediates in its own memory pool (PERF.md gives the main
    spec's size)."""
    return _ingest_fn_cached(ingest_cache_spec(spec), int(block),
                             bool(donate), mesh_layout(spec))


def ingest_cache_stats() -> Dict[str, int]:
    """How many compiled-ingest cells exist (``entries``) and the cache's
    hit and miss counts."""
    info = _ingest_fn_cached.cache_info()
    return {"entries": int(info.currsize), "hits": int(info.hits),
            "misses": int(info.misses)}


def _host_copy(x) -> np.ndarray:
    """An int32 host copy of a block given as an array or a tensor."""
    return np.array(api.host_array(x), dtype=np.int32, copy=True)


class StreamSession:
    """Streaming front-end over one :class:`SketchSpec` on one device.

    ``block``: fixed ingest block length (one compiled ingest per spec).
    ``window``: optional bounded-deletion horizon, in pushes for ``push``
    and in observations for ``observe``. ``state``: resume from an
    existing state. ``donate``: let the compiled ingest update the state
    buffers in place on the card (see the module docstring); ``False``
    keeps every state a caller took unchanged. ``replay``: keep the last
    N ingested blocks for ``elastic.recover_session`` (at least the
    checkpoint cadence in blocks). ``fault_plan``: a
    ``faults.FaultPlan`` applied at the block boundary (sharded specs
    only). ``monitor``: a ``StragglerMonitor`` observing per-shard block
    times. ``device``: where the state lives (CUDA unless asked).
    """

    def __init__(self, spec: SketchSpec, block: int = 8192,
                 window: Optional[int] = None, state=None,
                 donate: bool = True, replay: int = 0, fault_plan=None,
                 monitor=None, device=DEFAULT_DEVICE):
        if block < 2:
            raise ValueError(f"block must be >= 2, got {block}")
        if fault_plan is not None and spec.shards is None:
            raise ValueError(
                "fault_plan injects shard-granular faults; the spec must "
                "be sharded (shards=S)")
        self.spec = spec
        self.block = int(block)
        self.window = window
        self.donate = donate
        self.device = resolve_device(device)
        self.state = state if state is not None else api.make(spec, self.device)
        self._compiled = _ingest_fn(spec, self.block, donate)
        # one pinned host slot for ingest_block's copies to the card, and
        # the event that says its last copy is done
        self._pinned: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._pinned_free: Optional[torch.cuda.Event] = None
        self.insertions = 0
        self.deletions = 0
        # positive mass validated into this session: the prior_mass bound
        # api.validate_block holds each new block against
        self.ingested_mass = 0
        # the bound widening resizes add (elastic.reshard_session)
        self.error_slack = 0
        self._buf_i: List[np.ndarray] = []
        self._buf_w: List[np.ndarray] = []
        self._buf_n = 0
        # batch expiry FIFOs per tenant (None: the single-stream
        # schedule, made now: the stats trackers alias it through
        # batch_fifo)
        self._batch_fifos: Dict[Optional[int],
                                Deque[Tuple[np.ndarray, np.ndarray]]] = {
            None: collections.deque()}
        self._item_fifo: Deque[Tuple[int, int]] = collections.deque()
        # the fault machinery, inert by default
        self.replay = int(replay)
        self._seq = 0   # blocks ingested so far; block i carries seq i
        self._replay: Deque[Tuple[int, np.ndarray, np.ndarray]] = (
            collections.deque(maxlen=max(self.replay, 0)))
        self.fault_plan = fault_plan
        self.monitor = monitor
        # due seq -> [(items, weights)] delayed slices
        self._deferred: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}

    @property
    def blocks_ingested(self) -> int:
        """Blocks ingested so far (the checkpoint's ``sched_seq``)."""
        return self._seq

    @property
    def replay_log(self) -> Tuple[Tuple[int, np.ndarray, np.ndarray], ...]:
        """The retained (seq, items, weights) blocks, oldest first."""
        return tuple(self._replay)

    # -- low-level ingest --------------------------------------------------

    def ingest_block(self, items, weights) -> None:
        """Feed ONE exactly block-sized, already-padded int32 block through
        the compiled ingest. On the card a host block goes through the
        session's pinned slot, copied to the device without synchronising
        the host; a block already on the card is used as it is.

        The replay log keeps a host copy of the block before any fault is
        injected (a caller's buffer, the pinned slot or a feeder's device
        slot is reused for later blocks): faults corrupt the live state,
        never the recovery truth."""
        self._seq += 1
        if self.replay:
            self._replay.append((self._seq, _host_copy(items),
                                 _host_copy(weights)))
        if self.fault_plan is not None or self.monitor is not None:
            self._ingest_faulty(self._seq, items, weights)
            return
        staged = None
        if self.device.type == "cuda" and not (
                isinstance(items, torch.Tensor) and items.is_cuda):
            items, weights = self._pin(items, weights)
            staged = self._pinned_free
        self.state = self._compiled(self.state, items, weights, staged)

    def _apply(self, items, weights) -> None:
        """One compiled ingest of a host block (the fault path's blocks and
        slices)."""
        self.state = self._compiled(self.state, items, weights)

    def _ingest_faulty(self, seq: int, items, weights) -> None:
        """The fault-injected or monitored ingest of one block (reference
        ``session.py:231``). Delayed slices that came due land before the
        new block; each shard's host reports the primary block's time to
        the monitor, a delayed shard's host the injected delay on top."""
        from . import faults as flt

        items, weights = api.host_array(items), api.host_array(weights)
        shards = self.spec.shards or 1
        for due in sorted(k for k in self._deferred if k <= seq):
            for di, dw in self._deferred.pop(due):
                self._apply(di, dw)
        delay_s = {}
        if self.fault_plan is not None:
            out = flt.inject(self.fault_plan, seq, shards, items, weights)
            delay_s = out.delay_s
            dt = self._timed_ingest(*out.blocks[0])
            for bi, bw in out.blocks[1:]:
                self._apply(bi, bw)
            for due, di, dw in out.deferred:
                self._deferred.setdefault(due, []).append((di, dw))
            if out.poison_rows:
                self.state = flt.poison_rows(self.state, out.poison_rows)
        else:
            dt = self._timed_ingest(items, weights)
        if self.monitor is not None:
            for r in range(shards):
                self.monitor.observe(r, dt + delay_s.get(r, 0.0))

    def _timed_ingest(self, items, weights) -> float:
        """One compiled ingest, timed to its end on the device when a
        monitor needs the time (the synchronisation costs the overlap, so
        a fault run without a monitor does not wait)."""
        t0 = time.perf_counter()
        self._apply(items, weights)
        if self.monitor is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _pin(self, items, weights):
        """The block in the pinned slot, once the slot's last copy to the
        card is done."""
        if self._pinned is None:
            self._pinned = tuple(
                torch.empty(self.block, dtype=I32).pin_memory()
                for _ in range(2))
            self._pinned_free = torch.cuda.Event()
        self._pinned_free.synchronize()
        for slot, src in zip(self._pinned, (items, weights)):
            slot.numpy()[:] = api.host_array(src)
        return self._pinned

    def ingest(self, items, weights) -> None:
        """Validate, chunk to the session block, pad, and ingest now.
        Items and weights are host arrays or tensors on any device (copied
        to the host for validation)."""
        items = api.host_array(items).ravel()
        weights = api.host_array(weights).ravel()
        self.ingested_mass += api.validate_block(
            self.spec, items, weights, prior_mass=self.ingested_mass)
        items = items.astype(np.int32)
        weights = weights.astype(np.int32)
        for s in range(0, len(items), self.block):
            ci = items[s:s + self.block]
            cw = weights[s:s + self.block]
            pad = self.block - len(ci)
            if pad:
                ci = np.pad(ci, (0, pad))  # weight-0 tail = padding
                cw = np.pad(cw, (0, pad))
            self.ingest_block(ci, cw)

    # -- buffered streaming ------------------------------------------------

    def extend(self, items, weights=None) -> None:
        """Buffer signed weighted updates; auto-flush full blocks.
        ``weights=None`` = unit inserts."""
        items = api.host_array(items).ravel()
        weights = (np.ones(len(items), np.int32) if weights is None
                   else api.host_array(weights).ravel())
        self.ingested_mass += api.validate_block(
            self.spec, items, weights, prior_mass=self.ingested_mass)
        self._append(items.astype(np.int32), weights.astype(np.int32))

    def _append(self, items: np.ndarray, weights: np.ndarray) -> None:
        self._buf_i.append(items)
        self._buf_w.append(weights)
        self._buf_n += len(items)
        if self._buf_n >= self.block:
            self._drain(keep_partial=True)

    def observe(self, item: int, weight: int = 1) -> None:
        """One observation; with ``window`` set, the observation that falls
        off the horizon is deleted in the same step (bounded deletion)."""
        item = int(item)
        weight = int(weight)
        if item < 0:
            raise ValueError(
                f"negative item id {item}: ids must be >= 0 (negative ids "
                f"are the EMPTY/BLOCKED sentinels)")
        if self.spec.kind == "quantile" and item >= (1 << self.spec.bits):
            raise ValueError(
                f"item {item} is outside the dyadic universe "
                f"[0, 2^{self.spec.bits}); raise SketchSpec.bits or bucket "
                f"ids before ingest")
        int32_max = int(np.iinfo(np.int32).max)
        if abs(weight) > int32_max:
            raise ValueError(f"weight {weight} does not fit int32")
        if weight > 0 and self.ingested_mass + weight > int32_max:
            raise ValueError(
                f"observation of weight {weight} on a session already "
                f"holding {self.ingested_mass} positive mass could carry a "
                f"counter past int32 max ({int32_max})")
        expire = self.window is not None and len(self._item_fifo) >= self.window
        if expire:
            old_i, old_w = self._item_fifo[0]
            frag_i = np.asarray([item, old_i], np.int32)
            frag_w = np.asarray([weight, -old_w], np.int32)
        else:
            frag_i = np.asarray([item], np.int32)
            frag_w = np.asarray([weight], np.int32)
        self._append(frag_i, frag_w)
        self.insertions += weight
        if weight > 0:
            self.ingested_mass += weight
        if self.window is not None:
            self._item_fifo.append((item, weight))
            if expire:
                self._item_fifo.popleft()
                self.deletions += old_w

    def flush(self) -> None:
        """Ingest everything buffered, padding the final partial block,
        then deliver the delayed fault slices still pending (a delay near
        the end of a stream would otherwise lose its slice)."""
        self._drain(keep_partial=False)
        self._drain_deferred()

    def _drain_deferred(self) -> None:
        for due in sorted(self._deferred):
            for di, dw in self._deferred.pop(due):
                self._apply(di, dw)

    def _drain(self, keep_partial: bool) -> None:
        if not self._buf_n:
            return
        items = np.concatenate(self._buf_i)
        weights = np.concatenate(self._buf_w)
        n_full = (len(items) // self.block) * self.block
        for s in range(0, n_full, self.block):
            self.ingest_block(items[s:s + self.block],
                              weights[s:s + self.block])
        tail = len(items) - n_full
        if not keep_partial and tail:
            pad = self.block - tail
            self.ingest_block(np.pad(items[n_full:], (0, pad)),
                              np.pad(weights[n_full:], (0, pad)))
        keep = keep_partial and tail
        self._buf_i = [items[n_full:]] if keep else []
        self._buf_w = [weights[n_full:]] if keep else []
        self._buf_n = tail if keep else 0

    # -- windowed batch scheduling -----------------------------------------

    def push(self, items, weights, tenant: Optional[int] = None) -> None:
        """Ingest one batch now; after ``window`` further pushes on the
        same ``tenant``'s FIFO (None: the single-stream schedule) it is
        re-ingested with negated weights. Buffered updates flush first."""
        self.flush()
        items = api.host_array(items).ravel()
        weights = api.host_array(weights).ravel()
        self.ingest(items, weights)
        for di, dw in self.schedule_batch(items.astype(np.int32),
                                          weights.astype(np.int32), tenant):
            self.ingest(di, dw)

    def schedule_batch(self, items: np.ndarray, weights: np.ndarray,
                       tenant: Optional[int] = None,
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Account one already-ingested batch on ``tenant``'s window FIFO
        and return the expiries now due (negated-weight fragments) without
        ingesting them: the sketch service coalesces many tenants' due
        expiries into its blocks. ``push`` is ``ingest``, this, and the
        ingest of what it returns."""
        self.insertions += int(weights.sum())
        if self.window is None:
            return []
        fifo = self._batch_fifos.setdefault(tenant, collections.deque())
        fifo.append((items, weights))
        due: List[Tuple[np.ndarray, np.ndarray]] = []
        while len(fifo) > self.window:
            di, dw = fifo.popleft()
            self.deletions += int(dw.sum())
            due.append((di, -dw))
        return due

    @property
    def batch_fifo(self) -> Deque[Tuple[np.ndarray, np.ndarray]]:
        """The pending batch expiries of the single-stream schedule
        (tenant None), oldest first; the same deque across ``load``."""
        return self._batch_fifos[None]

    @property
    def batch_fifos(self) -> Dict[Optional[int],
                                  Deque[Tuple[np.ndarray, np.ndarray]]]:
        """Every tenant's pending batch expiries (None: the default)."""
        return self._batch_fifos

    @property
    def alpha_bound(self) -> float:
        """Empirical alpha = I / (I - D) (paper Table 2)."""
        return self.insertions / max(self.insertions - self.deletions, 1)

    # -- queries (flush first: a query sees every prior update) ------------

    def query_many(self, items) -> torch.Tensor:
        self.flush()
        return api.query_many(self.spec, self.state, items)

    def query(self, item) -> torch.Tensor:
        self.flush()
        return api.query(self.spec, self.state, item)

    def topk(self, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
        self.flush()
        return api.topk(self.spec, self.state, m)

    def rank_many(self, xs) -> torch.Tensor:
        self.flush()
        return api.rank_many(self.spec, self.state, xs)

    def rank(self, x) -> int:
        self.flush()
        return api.rank(self.spec, self.state, x)

    def quantile_many(self, qs) -> torch.Tensor:
        self.flush()
        return api.quantile_many(self.spec, self.state, qs)

    def quantile(self, q: float) -> int:
        self.flush()
        return api.quantile(self.spec, self.state, q)

    # -- merge / consolidation ---------------------------------------------

    def merge_from(self, other: "StreamSession") -> None:
        """Cross-host reduction (mergeable summaries): ``other``'s state is
        merged into this one. The specs must agree on everything but
        ``backend`` (an execution path, not a layout), and the windows
        must match; the other session's pending expiries carry over, each
        on its tenant's FIFO, so every scheduled deletion still fires
        once."""
        if _layout(self.spec) != _layout(other.spec):
            raise ValueError(
                f"cannot merge sessions of different layouts: {self.spec} "
                f"vs {other.spec} (only `backend` may differ)")
        if self.window != other.window:
            raise ValueError(
                f"cannot merge sessions with mismatched window schedules "
                f"(window={self.window} vs window={other.window}): the "
                f"absorbed session's pending expiries would fire on the "
                f"wrong horizon")
        self.flush()
        other.flush()
        self.state = api.merge(self.spec, self.state, other.state)
        self.insertions += other.insertions
        self.deletions += other.deletions
        self.error_slack += other.error_slack
        for t, fifo in other._batch_fifos.items():
            self._batch_fifos.setdefault(t, collections.deque()).extend(fifo)
        self._item_fifo.extend(other._item_fifo)

    def consolidated(self):
        """The single summary of the state (identity when unsharded)."""
        self.flush()
        return api.consolidate(self.spec, self.state)

    # -- checkpointing -----------------------------------------------------

    def save(self, include_schedule: bool = False) -> dict:
        """Tagged checkpoint dict (``api.save``).

        ``include_schedule=False`` flushes first and saves the sketch only.
        ``include_schedule=True`` does not flush: it adds the reference's
        ``sched_*`` keys (buffer, expiry FIFOs, totals, block cursor,
        window, resize slack, pending delayed fault slices) so ``load``
        resumes mid-stream in either package; ``sched_seq`` keys
        ``elastic.recover_session``'s replay.
        """
        if not include_schedule:
            self.flush()
            return api.save(self.spec, self.state)
        d = api.save(self.spec, self.state)

        def cat(frags):
            return np.concatenate(frags) if frags else np.zeros(0, np.int32)

        d["sched_buf_items"] = cat(self._buf_i)
        d["sched_buf_weights"] = cat(self._buf_w)
        d["sched_item_fifo_items"] = np.asarray(
            [i for i, _ in self._item_fifo], np.int32)
        d["sched_item_fifo_weights"] = np.asarray(
            [w for _, w in self._item_fifo], np.int32)
        # the FIFOs flattened in the reference's key order (None, then
        # ascending tenants), each batch tagged with its tenant (-1: None)
        keys = sorted(self._batch_fifos,
                      key=lambda t: (t is not None, t if t is not None else 0))
        flat = [(t, b, w) for t in keys for b, w in self._batch_fifos[t]]
        d["sched_batch_items"] = cat([b for _, b, _ in flat])
        d["sched_batch_weights"] = cat([w for _, _, w in flat])
        d["sched_batch_lens"] = np.asarray([len(b) for _, b, _ in flat],
                                           np.int64)
        d["sched_batch_tenants"] = np.asarray(
            [-1 if t is None else int(t) for t, _, _ in flat], np.int64)
        d["sched_insertions"] = self.insertions
        d["sched_deletions"] = self.deletions
        d["sched_seq"] = self._seq
        d["sched_window"] = -1 if self.window is None else int(self.window)
        d["sched_error_slack"] = self.error_slack
        # pending delayed slices, in due order (a crash between a delay and
        # its due block must not lose the slice)
        flat = [(due, di, dw) for due in sorted(self._deferred)
                for di, dw in self._deferred[due]]
        d["sched_deferred_due"] = np.asarray([due for due, _, _ in flat],
                                             np.int64)
        d["sched_deferred_lens"] = np.asarray([len(di) for _, di, _ in flat],
                                              np.int64)
        d["sched_deferred_items"] = cat([np.asarray(di, np.int32)
                                         for _, di, _ in flat])
        d["sched_deferred_weights"] = cat([np.asarray(dw, np.int32)
                                           for _, _, dw in flat])
        return d

    def load(self, d: dict) -> None:
        """Restore from a ``save`` dict of either package; all scheduling
        state resets, then a ``sched_*`` snapshot is restored on top."""
        self._buf_i, self._buf_w, self._buf_n = [], [], 0
        # the None deque keeps its identity (the stats trackers alias it)
        none_fifo = self._batch_fifos[None]
        none_fifo.clear()
        self._batch_fifos = {None: none_fifo}
        self._item_fifo.clear()
        self.insertions = 0
        self.deletions = 0
        self.error_slack = 0
        self._seq = 0
        self._replay.clear()
        self._deferred = {}
        self.spec = api.infer_spec(self.spec, d)
        self.state = api.restore(self.spec, d, self.device)
        self._compiled = _ingest_fn(self.spec, self.block, self.donate)
        if "sched_seq" in d:
            self._restore_schedule(d)

    def _restore_schedule(self, d: dict) -> None:
        saved_w = int(np.asarray(d["sched_window"]))
        saved_window = None if saved_w < 0 else saved_w
        if self.window != saved_window:
            raise ValueError(
                f"checkpoint carries window={saved_window} but this session "
                f"was built with window={self.window}")
        bi = np.asarray(d["sched_buf_items"], np.int32)
        bw = np.asarray(d["sched_buf_weights"], np.int32)
        self._buf_i = [bi] if len(bi) else []
        self._buf_w = [bw] if len(bw) else []
        self._buf_n = len(bi)
        self._item_fifo.extend(
            (int(i), int(w)) for i, w in zip(
                np.asarray(d["sched_item_fifo_items"]),
                np.asarray(d["sched_item_fifo_weights"])))
        cat_i = np.asarray(d["sched_batch_items"], np.int32)
        cat_w = np.asarray(d["sched_batch_weights"], np.int32)
        lens = np.asarray(d["sched_batch_lens"], np.int64)
        # a dict from before the tenant tags loads onto the None FIFO
        tags = np.asarray(d.get("sched_batch_tenants",
                                np.full(len(lens), -1)), np.int64)
        s = 0
        for n, t in zip(lens, tags):
            n = int(n)
            key = None if int(t) < 0 else int(t)
            self._batch_fifos.setdefault(key, collections.deque()).append(
                (cat_i[s:s + n], cat_w[s:s + n]))
            s += n
        self.insertions = int(np.asarray(d["sched_insertions"]))
        self.deletions = int(np.asarray(d["sched_deletions"]))
        self._seq = int(np.asarray(d["sched_seq"]))
        self.error_slack = int(np.asarray(d["sched_error_slack"]))
        # schedule checkpoints from before the delayed slices carry none
        if "sched_deferred_due" in d:
            dd_i = np.asarray(d["sched_deferred_items"], np.int32)
            dd_w = np.asarray(d["sched_deferred_weights"], np.int32)
            s = 0
            for due, n in zip(np.asarray(d["sched_deferred_due"], np.int64),
                              np.asarray(d["sched_deferred_lens"], np.int64)):
                due, n = int(due), int(n)
                self._deferred.setdefault(due, []).append(
                    (dd_i[s:s + n], dd_w[s:s + n]))
                s += n


class BlockFeeder:
    """Host-side feeder that keeps the compiled ingest busy (reference
    ``session.py:722``).

    ``feed(items, weights)`` stages block i and dispatches block i-1: on
    the card, block i is copied into a pinned host slot and from there to
    a device slot on a copy stream, while block i-1 computes on the
    caller's stream. Each slot has two events: its copy is done (the host
    slot may be refilled; the ingest may read the device slot) and its
    ingest has read it (the device slot may be refilled). At most
    ``depth`` ingests stay in flight: the host waits for the oldest
    beyond that. ``flush()`` dispatches the staged block, waits and
    returns the state. Blocks are exactly session-block-sized and
    zero-weight padded (the ``ingest_block`` contract); feeding is
    bit-identical to calling ``ingest_block`` in order.
    """

    def __init__(self, session: StreamSession, depth: int = 2):
        self.session = session
        self.depth = max(1, int(depth))
        self._staged = None
        self._inflight: Deque = collections.deque()
        self._next = 0
        self._cuda = session.device.type == "cuda"
        if self._cuda:
            n, B, dev = self.depth + 1, session.block, session.device
            self._host = [tuple(torch.empty(B, dtype=I32).pin_memory()
                                for _ in range(2)) for _ in range(n)]
            self._dev = [tuple(torch.empty(B, dtype=I32, device=dev)
                               for _ in range(2)) for _ in range(n)]
            self._copied = [torch.cuda.Event() for _ in range(n)]
            self._read = [torch.cuda.Event() for _ in range(n)]
            self._copy_stream = torch.cuda.Stream(dev)

    def feed(self, items, weights) -> None:
        staged = self._stage(items, weights)
        if self._staged is not None:
            self._dispatch(self._staged)
        self._staged = staged

    def _stage(self, items, weights):
        if not self._cuda:
            return (np.array(items, np.int32), np.array(weights, np.int32))
        j = self._next
        self._next = (j + 1) % len(self._host)
        self._copied[j].synchronize()
        for slot, src in zip(self._host[j], (items, weights)):
            slot.numpy()[:] = api.host_array(src)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._read[j])
            for dst, src in zip(self._dev[j], self._host[j]):
                dst.copy_(src, non_blocking=True)
            self._copied[j].record()
        return j

    def _dispatch(self, staged) -> None:
        if not self._cuda:
            self.session.ingest_block(*staged)
            return
        caller = torch.cuda.current_stream(self.session.device)
        caller.wait_event(self._copied[staged])
        self.session.ingest_block(*self._dev[staged])
        self._read[staged].record(caller)
        done = torch.cuda.Event()
        done.record(caller)
        self._inflight.append(done)
        while len(self._inflight) > self.depth:
            self._inflight.popleft().synchronize()

    def flush(self):
        """Dispatch the staged block, wait for the device, return state."""
        if self._staged is not None:
            self._dispatch(self._staged)
            self._staged = None
        while self._inflight:
            self._inflight.popleft().synchronize()
        return self.session.state


__all__ = ["BlockFeeder", "CompiledIngest", "StreamSession", "_ingest_fn",
           "mesh_layout", "ingest_cache_spec", "ingest_cache_stats"]
