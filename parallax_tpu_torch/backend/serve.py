"""Single-host serving: engine pipeline + OpenAI HTTP frontend in one process
(port of ``parallax_tpu/backend/serve.py``).

The stage engines and the HTTP frontend share the process; a runner thread
steps the pipeline continuously with ``step_round`` (so the served path runs
what the JAX package's serve runs: K-step decode windows inside
``engine.step()``, replayed from CUDA graphs on a card, and no overlap).
That thread is the only one that touches the engine's tensors: it also runs
the engines' obs refresh between rounds, and what other threads need done
on the device (starting and stopping the profiler) is posted to it
(``LocalRunner.call``).

The observability plane is the JAX serve's: ``/cluster/status_json``
serves the single-host status (device plane, merged histograms, goodput,
per-stage timing / cache / kernel / spec / constrained, the watchdog and
the SLO tracker), ``watchdog`` runs the stall watchdog over the runner loop
and each stage's admission queue (deep ``/healthz``), and a local timeline
serves ``/debug/timeline``. ``--qos`` is the JAX serve's too: the engine's
local scheduler runs the QoS policy, the frontend reads the class,
deadline and tenant headers, and the status carries the head's ``qos``
payload.
"""

from __future__ import annotations

import queue
import threading

import torch

from parallax_tpu_torch.backend.http_server import OpenAIFrontend
from parallax_tpu_torch.constrained import grammar_vocab_from_tokenizer
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class LocalRunner:
    """Steps an in-process pipeline on a background thread and completes
    per-request events. A step that raises stops the runner: every request
    it holds is aborted (its event set), and later submits raise.
    ``watchdog`` (obs/watchdog.py) gets one beat per loop pass."""

    def __init__(self, pipeline: InProcessPipeline, watchdog=None):
        self.pipeline = pipeline
        self.watchdog = watchdog
        self._calls: queue.Queue = queue.Queue()
        self._events: dict[str, threading.Event] = {}
        self._requests: dict[str, Request] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="pipeline-runner"
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)

    def submit(self, request: Request) -> threading.Event:
        ev = threading.Event()
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"the serving loop failed: {self.error}")
            self._events[request.request_id] = ev
            self._requests[request.request_id] = request
            try:
                accepted = self.pipeline.submit(request)
            except Exception:
                self._forget(request.request_id)
                raise
            if not accepted:
                self._forget(request.request_id)
                raise RuntimeError("engine queue full")
        return ev

    def stop_request(self, request_id: str) -> None:
        """Gracefully finish a request early (stop-string match): the next
        step round collects and releases it."""
        with self._lock:
            self.pipeline.head.stop_request(request_id)

    def call(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the runner thread between step rounds and return
        its result (re-raising its exception). For what must happen on the
        thread that steps the device."""
        if threading.current_thread() is self._thread:
            return fn()
        if not self._thread.is_alive():
            raise RuntimeError("the serving loop is not running")
        box: queue.Queue = queue.Queue(maxsize=1)
        self._calls.put((fn, box))
        try:
            ok, value = box.get(timeout=timeout)
        except queue.Empty as e:
            raise TimeoutError("the serving loop did not answer") from e
        if not ok:
            raise value
        return value

    def _run_calls(self) -> None:
        while True:
            try:
                fn, box = self._calls.get_nowait()
            except queue.Empty:
                return
            try:
                box.put((True, fn()))
            except Exception as e:
                box.put((False, e))

    def _forget(self, request_id: str) -> threading.Event | None:
        self._requests.pop(request_id, None)
        return self._events.pop(request_id, None)

    def _loop(self) -> None:
        device = self.pipeline.head.device
        if device.type == "cuda":
            # The current device is per thread.
            torch.cuda.set_device(device)
        engines = self.pipeline.engines
        while not self._stop.is_set():
            if self.watchdog is not None:
                self.watchdog.beat("step_loop")
            self._run_calls()
            for e in engines:
                e.obs_tick()
            if not self.pipeline.has_work():
                self._stop.wait(0.002)
                continue
            with self._lock:
                try:
                    finished = self.pipeline.step_round()
                except Exception as e:
                    logger.exception("the serving loop failed")
                    self._fail(e)
                    return
                for req in finished:
                    ev = self._forget(req.request_id)
                    if ev is not None:
                        ev.set()

    def _fail(self, error: BaseException) -> None:
        self.error = error
        self._run_calls()
        for rid in list(self._events):
            req = self._requests.get(rid)
            if req is not None and not req.status.is_finished:
                req.abort(f"serving loop failed: {error}")
            self._forget(rid).set()


def build_local_frontend(
    engines: list[StageEngine],
    tokenizer,
    model_name: str = "parallax-tpu",
    watchdog: bool = False,
    slo_config=None,
    qos_config=None,
) -> tuple[OpenAIFrontend, LocalRunner]:
    """The frontend and a started runner over ``engines`` (a pipeline in
    stage order), with the tokenizer's grammar vocabulary wired into the
    last stage. The web UI's catalog is sized against the first engine's
    device when it is a card (read here, before the runner starts: only
    the runner thread touches CUDA once it runs). ``watchdog=True`` runs
    the stall watchdog over the runner loop and each stage's admission
    queue (deep ``/healthz``); ``slo_config`` (obs/slo.py ``SLOConfig``)
    adds windowed SLO attainment and burn rates to the status;
    ``qos_config`` (``qos/classes.QoSConfig``) makes the frontend parse
    the QoS headers and body fields."""
    device = engines[0].device
    device_memory_bytes = (
        torch.cuda.get_device_properties(device).total_memory
        if device.type == "cuda" else None)
    pipeline = InProcessPipeline(engines)
    wd = None
    if watchdog:
        from parallax_tpu_torch.obs.watchdog import StallWatchdog

        wd = StallWatchdog(node_id="local")
        wd.register_beat(
            "step_loop",
            lambda: sum(e.scheduler.num_requests() for e in engines),
        )
        for i, e in enumerate(engines):
            sched = e.scheduler

            def _admission(sched=sched):
                return (
                    float(len(sched.wait_queue)),
                    float(sched.admitted_total),
                    f"{len(sched.running)} running",
                )

            wd.register(f"admission[{i}]", _admission)
        wd.start()
    slo_tracker = None
    if slo_config is not None:
        from parallax_tpu_torch.obs.slo import SLOTracker

        slo_tracker = SLOTracker(slo_config)
    # Grammar-constrained decoding lives on the LAST stage (where sampling
    # happens): wire the tokenizer's raw byte vocabulary into it before
    # the runner thread starts stepping.
    last = engines[-1]
    if last.model.is_last:
        try:
            vocab, eos = grammar_vocab_from_tokenizer(tokenizer)
            last.set_grammar_vocab(vocab, eos)
        except Exception as e:  # no EOS id / no recoverable vocab
            logger.warning("grammar vocab unavailable (%s); "
                           "json_schema requests will be rejected", e)
    runner = LocalRunner(pipeline, watchdog=wd)
    runner.start()

    def status():
        """The single-host twin of the swarm's /cluster/status. Host state
        and the step thread's snapshots only (no CUDA call)."""
        from parallax_tpu_torch.obs.device import get_device_plane
        from parallax_tpu_torch.obs.goodput import get_goodput
        from parallax_tpu_torch.obs.registry import (
            get_registry,
            summarize_snapshots,
        )

        snaps = get_registry().histogram_snapshots()
        goodput = get_goodput().payload(chips=1)
        out = {
            "mode": "single-host",
            "device": get_device_plane().payload(),
            "metrics": summarize_snapshots(snaps),
            "goodput": goodput,
            "stages": [
                {
                    "layers": [e.model.start_layer, e.model.end_layer],
                    "running": e.obs_snapshot()["running"],
                    "waiting": e.obs_snapshot()["queue"],
                    "free_pages": e.obs_snapshot()["free_pages"],
                    "cached_pages": e.obs_snapshot()["cached_pages"],
                    "step_timing": e.step_timing.summary(),
                    "cache_stats": e.cache_stats(),
                    "kernel": e.kernel_dispatch_summary(),
                    "spec": e.spec_summary(),
                    "constrained": e.constrained_summary(),
                }
                for e in engines
            ],
        }
        if wd is not None:
            out["health"] = wd.summary()
        if slo_tracker is not None:
            # Each status poll is one tracker sample.
            req = goodput.get("requests") or {}
            out["slo"] = slo_tracker.observe_and_evaluate({
                "hists": snaps,
                "finished": req.get("finished") or 0,
                "aborted": req.get("aborted") or 0,
            })
        # The head stage's class table, shed / burn state and counters.
        head_qos = engines[0].scheduler.qos
        if head_qos is not None:
            out["qos"] = head_qos.payload()
        return out

    from parallax_tpu_torch.obs.timeline import LocalTimeline

    local_timeline = LocalTimeline(node_id="local")

    def timeline(fmt: str, limit: int):
        if fmt == "chrome":
            return local_timeline.export_chrome()
        return local_timeline.snapshot(limit=limit)

    frontend = OpenAIFrontend(
        tokenizer,
        submit_fn=runner.submit,
        status_fn=status,
        model_name=model_name,
        stop_fn=runner.stop_request,
        device_memory_bytes=device_memory_bytes,
        healthz_fn=(wd.summary if wd is not None else None),
        timeline_fn=timeline,
        step_call=runner.call,
        qos_config=qos_config,
    )
    frontend.watchdog = wd
    return frontend, runner


def serve_main(args, on_start=None) -> int:
    """``parallax-tpu-torch serve`` entry: load the checkpoint onto
    ``args.device``, size the KV pages from its free memory (capped by
    the pages the configured batch can address) and serve until the
    frontend shuts down. ``on_start(frontend, runner)`` runs once the
    socket is bound."""
    from parallax_tpu_torch.config import (
        load_config,
        resolve_speculative_tokens,
    )
    from parallax_tpu_torch.models.loader import load_stage_params
    from parallax_tpu_torch.models.registry import create_stage_model
    from parallax_tpu_torch.runtime.cache_manager import derive_num_pages
    from parallax_tpu_torch.utils.hw import (
        default_host_cache_bytes,
        device_free_memory_bytes,
        resolve_device,
    )
    from parallax_tpu_torch.utils.tokenizer import load_tokenizer

    qos_config = None
    if args.qos:
        from parallax_tpu_torch.qos import parse_qos_spec

        # A malformed spec fails here, before the weights load.
        qos_config = parse_qos_spec(args.qos)
        if qos_config is not None and qos_config.autoscale:
            logger.warning(
                "qos autoscaler disabled: single-host serving has no "
                "phase pools to re-role (run a swarm scheduler with "
                "--qos ...,autoscale=1 for pool autoscaling)")
    device = resolve_device(args.device)
    config = load_config(args.model_path)
    n = config.num_hidden_layers
    start = args.start_layer or 0
    end = n if args.end_layer is None else args.end_layer
    if (start, end) != (0, n):
        # The JAX serve fails here too: its InProcessPipeline asserts that
        # the engines hold the first and the last layer.
        raise SystemExit(
            f"serve --start-layer {args.start_layer} --end-layer "
            f"{args.end_layer}: a single-host server holds every layer "
            f"[0, {n}) (its in-process pipeline needs the first and the "
            "last stage); serve a partial range with join")
    model = create_stage_model(config, start, end)
    params = load_stage_params(model, args.model_path, device=device)
    draft = None
    if args.draft_model_path:
        from parallax_tpu_torch.runtime.engine import DraftProposer

        # A single full stage holds every layer (checked above); the port
        # has no tensor parallelism to refuse.
        draft_cfg = load_config(args.draft_model_path)
        draft_model = create_stage_model(
            draft_cfg, 0, draft_cfg.num_hidden_layers)
        draft = DraftProposer(StageEngine(
            draft_model,
            load_stage_params(draft_model, args.draft_model_path,
                              device=device),
            EngineConfig(
                page_size=16,   # small pages: a small recomputed tail
                num_pages=max(
                    512,
                    args.max_batch_size
                    * ((args.max_model_len + 15) // 16 + 1),
                ),
                max_batch_size=args.max_batch_size,
                max_model_len=args.max_model_len,
                kv_dtype=args.kv_dtype,
                decode_lookahead=max(1, args.speculative_tokens or 4),
            ),
            device=device,
        ))

    page_size = args.page_size
    # Device memory budget, capped by the most pages the configured batch
    # can ever address (small models would otherwise derive absurd page
    # counts).
    addressable = (
        ((args.max_model_len + page_size - 1) // page_size + 1)
        * args.max_batch_size * 2
    )
    num_pages = min(
        derive_num_pages(
            device_free_memory_bytes(device, args.kv_utilization),
            config, model.num_local_layers, page_size,
        ),
        addressable,
    )
    engine = StageEngine(
        model,
        params,
        EngineConfig(
            page_size=page_size,
            num_pages=num_pages,
            max_batch_size=args.max_batch_size,
            max_model_len=args.max_model_len,
            max_num_tokens_per_batch=args.max_num_tokens_per_batch,
            prefill_chunk_size=args.prefill_chunk_size,
            kv_dtype=args.kv_dtype,
            enable_prefix_cache=not args.no_prefix_cache,
            # Host-DRAM KV tier: half of the host's available RAM on a
            # card unless pinned by flag; off on the CPU.
            host_cache_bytes=default_host_cache_bytes(
                override=args.host_cache_bytes, device=device),
            linear_prefix_slots=args.linear_prefix_slots,
            # None/0 = adaptive multi-step decode (engine default).
            decode_lookahead=args.decode_lookahead or None,
            decode_pipeline=args.decode_pipeline or 1,
            decode_fused=args.decode_fused,
            prefill_fused=args.prefill_fused,
            prefill_chunk_skip=args.prefill_chunk_skip,
            # A single host has no hop; carried so a worker spawned from
            # this config inherits the operator's wire choice.
            wire_dtype=args.wire_dtype,
            slow_request_ms=args.slow_request_ms,
            # Lifecycle-trace sampling (obs/trace.py).
            trace_sample_rate=args.trace_sample_rate or 0.0,
            # A draft model implies speculation at width 4.
            speculative_tokens=resolve_speculative_tokens(
                args.speculative_tokens, has_draft=draft is not None),
            speculative_ngram=args.speculative_ngram or 3,
            # Classes, deadline EDF and shed / park on the local
            # scheduler; None / "off" wires no policy.
            qos=args.qos,
        ),
        device=device,
        draft=draft,
    )
    del params
    slo_config = None
    if args.slo:
        from parallax_tpu_torch.obs.slo import parse_slo_spec

        # A malformed spec fails here, before the socket binds.
        slo_config = parse_slo_spec(args.slo, window_s=args.slo_window_s)
    tokenizer = load_tokenizer(args.model_path)
    frontend, runner = build_local_frontend(
        [engine], tokenizer, model_name=args.model_path,
        watchdog=bool(args.watchdog), slo_config=slo_config,
        qos_config=qos_config,
    )

    def started(fe: OpenAIFrontend) -> None:
        logger.info("serving %s layers [%d, %d) on %s (%d KV pages) at "
                    "%s:%d", args.model_path, start, end, device, num_pages,
                    args.host, fe.port)
        if on_start is not None:
            on_start(fe, runner)

    try:
        frontend.run(host=args.host, port=args.port, on_start=started)
    finally:
        runner.stop()
        if frontend.watchdog is not None:
            frontend.watchdog.stop()
    return 0
