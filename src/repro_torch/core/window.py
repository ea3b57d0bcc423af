"""Fused training windows: K steps of the step body with no host read inside.

The counterpart of the JAX package's ``make_fused_train_step``
(``repro/core/trainer.py:145-187``): one jitted ``lax.scan`` over a stacked
window of batches, with ``lr_scale`` carried on the device and the step's
metrics gathered into an on-device ring.  Here a :class:`FusedWindow` runs a
step body (``Trainer._body``: loss, backward, the Adam kernels on device
scalars, the ``lr_scale`` decay) K times on one stacked window:

* On the card the body is a CUDA graph.  A window's first step of the run
  is an eager step on the window's stream (a real step: it also builds the
  kernels and warms autograd and cuBLAS up), then one step is captured and
  replayed for every later step: before each replay that step's slot of
  the stacked window is copied into the graph's static batch, after it the
  step's record is copied into ring slot i.  Every step but the capture's
  one-time synchronize runs under ``torch.cuda.set_sync_debug_mode
  ("error")``, the counterpart of ``repro/analysis/runtime.py:112``
  ``sync_free``.  The capture keeps the caching allocator's blocks (unlike
  ``torch.cuda.graph``, which empties the cache first), and the trainer
  runs the work between windows on the same stream (:meth:`FusedWindow.
  streamed`), so a merge at a boundary reuses the blocks the eager step
  freed instead of allocating device memory anew.  The graph's own pool
  needs about as much as the eager step's working set, which those cached
  blocks measure: where the device's free memory could not hold that much
  beside them (mamba2-1.3b at batch 8 on an 80 GB card), the capture
  empties the cache first, and the work between windows allocates anew
  (:attr:`FusedWindow.kept_cache`).
* On the CPU the same body runs K times without capture, and so it does on
  the card for a window built with ``graphs=False`` (the pipeline backend,
  whose gloo transfers run on the host, outside any graph).

A graph replays fixed addresses, so the window binds the state's leaves
(parameters, moments) at its first window; before each later window a leaf
whose identity changed (a strategy that hands back new tensors) is copied
into the bound one.  The device mirror of the host step (the Adam step
counter, ``lr_scale``) is written from the host state before every window,
since a rollback, a restart or a merge may have changed either; the ring
brings both back in the window's single copy to the host.

A graph also bakes in the stage cut (the omegas are summed over it, the ring
is ``OMEGAS + K`` wide), so a window belongs to one partition and refuses a
dispatch under another.  An elastic re-layout, the counterpart of the JAX
trainer's ``_rebuild_fused_step``, takes :meth:`FusedWindow.relayout`: the
old graph is reset and every reference into its private pool dropped, the
allocator's cache is emptied so that the pool goes back to the device, and
a new window for the new partition takes over the bound leaves, the device
mirror and the stream.  Its first window runs an eager step and captures,
as the run's first window does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.core.stages import StagePartition
from repro_torch.core.state import TrainState
from repro_torch.kernels import ops
from repro_torch.optim.adam import OptState

#: a step's record, one fp32 row of the ring: these, then the stages' omegas
RECORD = ("loss", "ce", "aux", "grad_norm", "lr", "lr_scale", "step")
OMEGAS = len(RECORD)

Batch = Dict[str, torch.Tensor]
# body(params, m, v, batch, step, lr_scale) -> the step's record: params the
# tree, m and v its moments' leaves, step (0-d int32) and lr_scale (0-d fp32)
# the device mirror, advanced in place
Body = Callable[..., torch.Tensor]


@contextlib.contextmanager
def sync_free(device: torch.device) -> Iterator[None]:
    """On the card, any synchronizing CUDA call inside raises."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@dataclasses.dataclass
class Pending:
    """A dispatched window: the state it started from, its size and its
    ring on the device (k rows of :data:`RECORD` + omegas)."""
    state: TrainState
    k: int
    ring: torch.Tensor


class FusedWindow:
    """Runs windows of ``body`` on ``device`` (graph replays on the card
    unless ``graphs`` is False), for the stage partition ``part`` that the
    body sums the omegas over."""

    def __init__(self, body: Body, device: torch.device,
                 part: StagePartition,
                 stream: Optional["torch.cuda.Stream"] = None, *,
                 graphs: bool = True):
        self.body = body
        self.device = device
        self.part = part
        self.graphs = graphs and device.type == "cuda"
        self.width = OMEGAS + part.num_stages
        # the device mirror of the host step, baked into the graph
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.lr_scale = torch.ones((), dtype=torch.float32, device=device)
        self.params = self.m = self.v = None      # the bound trees
        self.graph = None
        self.static_batch: Batch = {}
        self.static_record = None
        if stream is None and self.graphs:
            stream = torch.cuda.Stream(device)
        self.stream = stream
        #: graphs captured, replays run, and the kernel launches that the
        #: capture recorded (the wrappers count a launch once, when it is
        #: recorded; each replay runs it again): the replays ran
        #: ``recorded_launches`` times ``replays``
        self.captures = 0
        #: graphs captured by the windows of earlier stage partitions
        #: (:meth:`relayout` carries the count over)
        self.prior_captures = 0
        self.replays = 0
        self.recorded_launches: Dict[str, int] = {}
        #: whether the last capture kept the allocator's cache
        self.kept_cache = True

    # ---- state -----------------------------------------------------------
    @torch.no_grad()
    def bind(self, state: TrainState) -> TrainState:
        """``state`` on the bound leaves: the first window binds its leaves;
        later, a leaf whose identity changed is copied into the bound one."""
        trees = (state.params, state.opt_state.m, state.opt_state.v)
        if self.params is None:
            self.params, self.m, self.v = trees
            return state
        for bound, tree in zip((self.params, self.m, self.v), trees):
            for a, b in zip(TR.leaves(bound), TR.leaves(tree)):
                if a is not b:
                    a.copy_(b)
        return dataclasses.replace(
            state, params=self.params,
            opt_state=OptState(self.m, self.v, state.opt_state.step))

    # ---- re-layout -------------------------------------------------------
    def relayout(self, part: StagePartition) -> "FusedWindow":
        """A new window for ``part`` that takes over this one's bound leaves,
        device mirror and stream (a re-layout changes the cut, never the
        weights).  This one's graph is reset and every tensor of its private
        pool dropped first, then the allocator's cache emptied: the reset
        pool's blocks wait there until they go back to the device."""
        graph, self.graph = self.graph, None
        self.static_record = None
        self.static_batch = {}
        if graph is not None:
            graph.reset()
            del graph
            with TR.explicit("relayout"):
                torch.cuda.empty_cache()
        new = FusedWindow(self.body, self.device, part, self.stream)
        new.prior_captures = self.prior_captures + self.captures
        new.step, new.lr_scale = self.step, self.lr_scale
        new.params, new.m, new.v = self.params, self.m, self.v
        return new

    def streamed(self) -> contextlib.AbstractContextManager:
        """On the card, the window's stream as the current one: the work
        between windows then shares the cached blocks of the eager step."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _stage(self, stacked: Dict[str, np.ndarray]) -> Batch:
        """The stacked window on the device: on the card through pinned
        memory, one asynchronous copy a key."""
        out = {}
        for key, arr in stacked.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t
        return out

    # ---- one window ------------------------------------------------------
    def _run_body(self, batch: Batch) -> torch.Tensor:
        return self.body(self.params, TR.leaves(self.m), TR.leaves(self.v),
                         batch, self.step, self.lr_scale)

    def dispatch(self, state: TrainState, stacked: Dict[str, np.ndarray], *,
                 part: StagePartition) -> Pending:
        """Start the window ``stacked`` (k batches on a leading axis) from
        ``state`` under the caller's partition ``part``, which must be this
        window's own; on the card it runs on while the host goes on."""
        if part is not self.part:
            raise AssertionError(
                f"a window for {self.part.num_stages} stages "
                f"{self.part.layer_counts} dispatched under "
                f"{part.num_stages} stages {part.layer_counts}: its graph "
                "sums the omegas over another cut")
        state = self.bind(state)
        self.step.fill_(state.opt_state.step)
        self.lr_scale.fill_(state.lr_scale)
        window = self._stage(stacked)
        k = next(iter(window.values())).shape[0]
        ring = torch.empty((k, self.width), dtype=torch.float32,
                           device=self.device)
        slot = lambda i: {key: t[i] for key, t in window.items()}  # noqa: E731
        if not self.graphs:
            for i in range(k):
                ring[i].copy_(self._run_body(slot(i)))
            return Pending(state, k, ring)
        first = 0
        if self.graph is None:
            # the run's first step, eager on the side stream the graph is
            # captured on: a real step, and the capture's warm-up
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with sync_free(self.device), torch.cuda.stream(self.stream):
                ring[0].copy_(self._run_body(slot(0)))
            current.wait_stream(self.stream)
            self._capture(slot(0))
            first = 1
        else:
            want = {key: tuple(t.shape) for key, t in self.static_batch.items()}
            got = {key: tuple(t.shape[1:]) for key, t in window.items()}
            if got != want:
                raise ValueError(f"a window of batches {got}; the captured "
                                 f"step takes {want}")
        with sync_free(self.device):
            for i in range(first, k):
                for key, t in self.static_batch.items():
                    t.copy_(window[key][i])
                self.graph.replay()
                ring[i].copy_(self.static_record)
                self.replays += 1
        return Pending(state, k, ring)

    def _capture(self, batch: Batch) -> None:
        """Capture one step of the body into the graph's own pool
        (synchronizes once, in an explicit section; the capture itself runs
        nothing).  The cache of the eager step's blocks is kept for the work
        between windows when the device's free memory can hold the graph's
        pool beside it (a pool about the size of that cache), else emptied
        first."""
        self.static_batch = {key: torch.empty_like(t) for key, t in
                             batch.items()}
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with TR.explicit("capture"):
            # as torch.cuda.graph does: a collection during the capture
            # could free an unreachable graph, whose release invalidates
            # the capture
            gc.collect()
            torch.cuda.synchronize(self.device)
            free, _ = torch.cuda.mem_get_info(self.device)
            cached = (torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device))
            self.kept_cache = cached <= free
            if not self.kept_cache:
                torch.cuda.empty_cache()
        with torch.cuda.stream(self.stream):
            graph.capture_begin()
            try:
                self.static_record = self._run_body(self.static_batch)
            finally:
                graph.capture_end()
        after = ops.launch_counts()
        self.recorded_launches = {name: after[name] - before[name]
                                  for name in after}
        self.graph = graph
        self.captures += 1

    def drain(self, pending: Pending) -> Tuple[TrainState, np.ndarray]:
        """Wait for the window and bring its ring to the host in one copy,
        the explicit drain -> (the state after it, the ring as a (k, width)
        fp32 array)."""
        state, k = pending.state, pending.k
        ring = TR.device_get(pending.ring)
        step = state.opt_state.step + k
        if int(ring[-1, RECORD.index("step")]) != step:
            raise AssertionError(
                f"the device step counter reads "
                f"{int(ring[-1, RECORD.index('step')])} after a window of {k} "
                f"from step {state.opt_state.step}")
        return TrainState(
            state.params, OptState(state.opt_state.m, state.opt_state.v, step),
            float(ring[-1, RECORD.index("lr_scale")]),
            pending.ring[-1, OMEGAS:], state.effective_step + k), ring

