"""CUDA graphs of the K-step decode window's step (port-only: the
counterpart of the ``jax.jit`` around ``parallax_tpu/runtime/engine.py``'s
``_build_multistep``).

The window's step is one function of tensors (``StageEngine._window_step``):
it reads and writes only the window's state — the fed tokens, contexts, stop
mask, produced counts, a step counter and the token buffer it writes at the
counter's row — so the eager loop and a captured graph run the same code. A
window is ``k`` replays of one graph from a host loop with no sync, and a
chain of windows ``m * k``: ``k`` is not unrolled into one graph (a gpt-oss
step is about 10,752 ops, so 8 unrolled steps would be over 86,000 nodes).

One graph per key, the key being every shape and branch the step bakes in
(the state's shapes, the sampler variant, the sampling-feature set). At its
first use the step runs once eagerly on a side stream: that fills what must
not happen under capture (the kernel library's build,
``cudaFuncSetAttribute``, cuBLAS workspaces, the indexer kernels' tensor-map
table) and writes the same KV the first real step writes. Then the step is
captured on a copy of the state taken before the warm-up, whose tensors
become the graph's static buffers; later windows of the key copy their
state into them on the stream, after any replay still in flight. So a
replay reads only buffers the graph owns, never a tensor the caller may
free or reuse (a cached grammar table, a feature vector of another
window). All graphs of an engine share one memory pool, released with the
engine.

Launch counts: a replay runs no wrapper, so each graph records the counts
its capture tallied on the capturing thread (``ops/cuda_kernels.py::
tally``) and every replay adds them to ``LAUNCHES``. The capture launches
nothing, so its counts stay out of ``LAUNCHES``; the warm-up's launches ran
and are counted, and ``warmup_launches`` sums them so that a caller can
hold the counts to layers x forward steps exactly. The capture is
thread-local, so two engines serving from two threads of one process (two
workers on one card) capture and launch side by side. A capture that fails
raises: there is no eager fallback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from parallax_tpu_torch.ops import cuda_kernels as ck


@dataclasses.dataclass(eq=False)
class _Graph:
    graph: torch.cuda.CUDAGraph
    state: object                  # the static buffers (a WindowState)
    launches: dict[str, int]       # wrapper launches per replay


class WindowGraphs:
    """The decode window's step graphs of one engine."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        # Warm-ups and captures run here, one stream for the engine's life
        # (cuBLAS keeps a workspace per stream).
        self._stream = torch.cuda.Stream(self.device)
        self._graphs: dict[tuple, _Graph] = {}
        self.replays = 0
        # Host seconds spent on set-up, not serving: the warm-up steps, the
        # recording and capture_end (which instantiates the graph); and the
        # kernel launches of the warm-up steps.
        self.capture_parts_s = {"warmup": 0.0, "record": 0.0,
                                "instantiate": 0.0}
        self.warmup_launches: dict[str, int] = {}
        # Called as on_capture(key, seconds) after each new graph (the
        # engine reports captures to the compile observatory).
        self.on_capture: Callable | None = None
        # Allocated bytes the graphs hold live (each capture's growth of
        # the caching allocator's allocated bytes: the static state and
        # what the graph pool keeps), for the HBM ledger.
        self.pool_bytes = 0

    def drop(self, pred: Callable) -> int:
        """Forget the graphs whose key satisfies ``pred`` (their static
        buffers and pool memory go with them); returns how many."""
        keys = [k for k in self._graphs if pred(k)]
        for k in keys:
            del self._graphs[k]
        return len(keys)

    @property
    def captured(self) -> int:
        return len(self._graphs)

    @property
    def capture_s(self) -> float:
        return sum(self.capture_parts_s.values())

    def run(self, key: tuple, state, step: Callable, n: int,
            preserve: Callable | None = None):
        """Run ``step`` ``n`` times from ``state`` through the key's graph
        (captured at first use); returns the static state the replays
        advanced. ``state`` must offer ``clone()`` and ``copy_(other)``.
        ``preserve`` (a hybrid model's): called before a capture's warm-up
        step, it saves what that step writes outside the window state and
        returns a function that puts it back, run after the warm-up: a
        recurrence must not advance twice (the first replay repeats the
        warm-up's step)."""
        entry = self._graphs.get(key)
        if entry is None:
            t0 = time.perf_counter()
            m0 = torch.cuda.memory_allocated(self.device)
            entry = self._graphs[key] = self._capture(state, step, preserve)
            self.pool_bytes += max(
                0, torch.cuda.memory_allocated(self.device) - m0)
            if self.on_capture is not None:
                self.on_capture(key, time.perf_counter() - t0)
        else:
            entry.state.copy_(state)
        for _ in range(n):
            entry.graph.replay()
        ck.add_launches(entry.launches, n)
        self.replays += n
        return entry.state

    def _capture(self, state, step: Callable,
                 preserve: Callable | None = None) -> _Graph:
        t = [time.perf_counter()]
        stream = torch.cuda.current_stream(self.device)
        side = self._stream
        static = state.clone()
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # Capture on the side stream behind the warm-up, without the
        # synchronize, gc.collect and empty_cache that torch.cuda.graph adds
        # (emptying the allocator's cache would make the next eager steps
        # go back to cudaMalloc). The capture mode is thread-local: another
        # engine's step thread in this process (two workers on one card)
        # keeps making CUDA calls while this one captures. The launches of
        # this thread alone are tallied: the warm-up's ran, the capture's
        # run at each replay.
        with torch.cuda.stream(side):
            restore = preserve() if preserve is not None else None
            with ck.tally() as warm:
                step(state)
            if restore is not None:
                restore()
            t.append(time.perf_counter())
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                with ck.tally(into_launches=False) as delta:
                    step(static)
                t.append(time.perf_counter())
            finally:
                graph.capture_end()
        t.append(time.perf_counter())
        stream.wait_stream(side)
        for k, n in warm.items():
            self.warmup_launches[k] = self.warmup_launches.get(k, 0) + n
        for part, a, b in zip(self.capture_parts_s, t, t[1:]):
            self.capture_parts_s[part] += b - a
        return _Graph(graph, static, delta)
