"""Canonical ``parallax_*`` metric names: the single source of truth.

Every metric the package exposes is declared here ONCE — a constant for
code to reference plus a HELP entry for exposition and docs. The
``metric-hygiene`` checker (docs/static_analysis.md) enforces the
contract mechanically:

- a ``"parallax_..."`` string literal anywhere else in the package is a
  finding (use the constant — literals drift when a series is renamed);
- a constant declared here without a HELP entry, or with a duplicate
  name, is a finding against this file;
- every declared name must be documented in docs/observability.md and
  referenced somewhere in the package (stale entries rot loudly).

Import-light by design (stdlib only, no package imports): any module —
including :mod:`parallax_tpu.obs.registry` itself and the jax-free
analysis pass — can import it without cycles.

Naming conventions: ``parallax_<subsystem>_<what>[_total|_ms|_bytes|
_seconds]``. Counters end in ``_total``; latency histograms in ``_ms``;
gauges name the instantaneous quantity. The ``parallax_tpu_*`` family is
the HTTP frontend's public surface (name preserved from the first
release; do not "fix" it to ``parallax_http_*``).
"""

from __future__ import annotations

# -- engine step / request latency (runtime/engine.py) ----------------------
TTFT_MS = "parallax_ttft_ms"
TPOT_MS = "parallax_tpot_ms"
E2E_MS = "parallax_e2e_ms"
STEP_HOST_MS = "parallax_step_host_ms"
STEP_DEVICE_MS = "parallax_step_device_ms"
STEP_PER_TOKEN_HOST_MS = "parallax_step_per_token_host_ms"
STEP_BATCH_TOKENS = "parallax_step_batch_tokens"
QUEUE_DEPTH = "parallax_queue_depth"
RUNNING_REQUESTS = "parallax_running_requests"
ATTN_KERNEL_DISPATCH_TOTAL = "parallax_attn_kernel_dispatch_total"

# -- KV memory tier (runtime/engine.py) -------------------------------------
KV_PAGE_OCCUPANCY = "parallax_kv_page_occupancy"
KV_PREEMPTIONS_TOTAL = "parallax_kv_preemptions_total"
KV_RESUMES_TOTAL = "parallax_kv_resumes_total"
KV_OOM_TOTAL = "parallax_kv_oom_total"
KV_PAGES_EVICTED_TOTAL = "parallax_kv_pages_evicted_total"
PREFILL_TOKENS_SKIPPED_TOTAL = "parallax_prefill_tokens_skipped_total"

# -- activation transport (p2p/node.py) -------------------------------------
TRANSPORT_BYTES_OUT_TOTAL = "parallax_transport_bytes_out_total"
TRANSPORT_BYTES_IN_TOTAL = "parallax_transport_bytes_in_total"
TRANSPORT_FRAMES_OUT_TOTAL = "parallax_transport_frames_out_total"
TRANSPORT_DROPS_TOTAL = "parallax_transport_drops_total"
TRANSPORT_QUEUE_DEPTH = "parallax_transport_queue_depth"

# -- live migration (p2p/node.py) -------------------------------------------
MIGRATIONS_TOTAL = "parallax_migrations_total"
MIGRATION_MS = "parallax_migration_ms"
MIGRATION_CHECKPOINTS_TOTAL = "parallax_migration_checkpoints_total"

# -- disaggregated KV handoff (runtime/kv_handoff.py) ------------------------
KV_TRANSFER_BYTES_TOTAL = "parallax_kv_transfer_bytes_total"
KV_TRANSFER_FRAMES_TOTAL = "parallax_kv_transfer_frames_total"
KV_TRANSFER_MS = "parallax_kv_transfer_ms"
KV_TRANSFER_FALLBACKS_TOTAL = "parallax_kv_transfer_fallbacks_total"
KV_HANDOFFS_TOTAL = "parallax_kv_handoffs_total"

# -- cache-aware routing (scheduling/) ---------------------------------------
ROUTING_DECISIONS_TOTAL = "parallax_routing_decisions_total"
ROUTING_DISPATCH_TOTAL = "parallax_routing_dispatch_total"
ROUTING_PREDICTED_CACHED_TOKENS_TOTAL = (
    "parallax_routing_predicted_cached_tokens_total"
)
ROUTING_ACTUAL_CACHED_TOKENS_TOTAL = (
    "parallax_routing_actual_cached_tokens_total"
)

# -- multi-tenant QoS (qos/) -------------------------------------------------
QOS_SHEDDING = "parallax_qos_shedding"
QOS_BURN_RATE = "parallax_qos_burn_rate"
QOS_SHED_TRANSITIONS_TOTAL = "parallax_qos_shed_transitions_total"
QOS_ADMISSIONS_TOTAL = "parallax_qos_admissions_total"
QOS_SHEDS_TOTAL = "parallax_qos_sheds_total"
QOS_PARKS_TOTAL = "parallax_qos_parks_total"
QOS_DEADLINE_SLACK_MS = "parallax_qos_deadline_slack_ms"
QOS_TTFT_MS = "parallax_qos_ttft_ms"
QOS_REROLES_TOTAL = "parallax_qos_reroles_total"

# -- speculative decoding (runtime/engine.py) --------------------------------
SPEC_PROPOSALS_TOTAL = "parallax_spec_proposals_total"
SPEC_ACCEPTED_TOTAL = "parallax_spec_accepted_total"
SPEC_REJECTED_TOTAL = "parallax_spec_rejected_total"
SPEC_ACCEPTANCE_RATE = "parallax_spec_acceptance_rate"
SPEC_PROPOSE_MS = "parallax_spec_propose_ms"

# -- constrained decoding in the fused window (runtime/engine.py) ------------
CONSTRAINED_ACTIVE_ROWS = "parallax_constrained_active_rows"
CONSTRAINED_WINDOW_ROWS_TOTAL = "parallax_constrained_window_rows_total"
CONSTRAINED_MASK_STEPS_TOTAL = "parallax_constrained_mask_steps_total"
CONSTRAINED_TABLE_BUILDS_TOTAL = "parallax_constrained_table_builds_total"
CONSTRAINED_TABLE_CACHE_HITS_TOTAL = (
    "parallax_constrained_table_cache_hits_total"
)
CONSTRAINED_SPEC_MASK_REJECTIONS_TOTAL = (
    "parallax_constrained_spec_mask_rejections_total"
)
CONSTRAINED_FALLBACKS_TOTAL = "parallax_constrained_fallbacks_total"

# -- goodput ledger / SLO / health plane (obs/) ------------------------------
GOODPUT_TOKENS_TOTAL = "parallax_goodput_tokens_total"
GOODPUT_TIME_SECONDS_TOTAL = "parallax_goodput_time_seconds_total"
GOODPUT_FRACTION = "parallax_goodput_fraction"
REQUESTS_FINISHED_TOTAL = "parallax_requests_finished_total"
WATCHDOG_TRANSITIONS_TOTAL = "parallax_watchdog_transitions_total"
HEALTH_STATE = "parallax_health_state"
TIMELINE_EVENTS_TOTAL = "parallax_timeline_events_total"
TIMELINE_GAPS_TOTAL = "parallax_timeline_gaps_total"
SLO_ATTAINMENT = "parallax_slo_attainment"
SLO_BURN_RATE = "parallax_slo_burn_rate"
OBS_MERGE_SKIPPED_TOTAL = "parallax_obs_merge_skipped_total"

# -- global scheduler control plane (scheduling/scheduler.py) ----------------
SCHEDULER_EVENTS_TOTAL = "parallax_scheduler_events_total"
SCHEDULER_REBALANCES_TOTAL = "parallax_scheduler_rebalances_total"
SCHEDULER_HEARTBEAT_EVICTIONS_TOTAL = (
    "parallax_scheduler_heartbeat_evictions_total"
)
SCHEDULER_DRAINS_TOTAL = "parallax_scheduler_drains_total"
SCHEDULER_MIGRATION_TARGETS_TOTAL = (
    "parallax_scheduler_migration_targets_total"
)
SCHEDULER_MIGRATIONS_RECORDED_TOTAL = (
    "parallax_scheduler_migrations_recorded_total"
)
SCHEDULER_DISAGG_TARGETS_TOTAL = "parallax_scheduler_disagg_targets_total"

# -- scheduler HA (parallax_tpu/ha, docs/ha.md) ------------------------------
HA_PROMOTIONS_TOTAL = "parallax_ha_promotions_total"
HA_JOURNAL_RECORDS_TOTAL = "parallax_ha_journal_records_total"
HA_REPLAY_MS = "parallax_ha_replay_ms"

# -- device attribution plane (obs/device.py, utils/compile_cache.py) --------
# In parallax_tpu_torch the ``parallax_xla_compile*`` family counts CUDA-graph
# captures (runtime/step_graph.py) and the first-use nvcc / g++ builds of the
# kernel and native libraries (ops/cuda_kernels.py, native/__init__.py): the
# names stay so that a mixed swarm merges into one set of dashboards.
HBM_BYTES = "parallax_hbm_bytes"
HBM_HEADROOM_BYTES = "parallax_hbm_headroom_bytes"
HBM_HIGH_WATERMARK_BYTES = "parallax_hbm_high_watermark_bytes"
DEVICE_TIME_SECONDS_TOTAL = "parallax_device_time_seconds_total"
XLA_COMPILE_MS_TOTAL = "parallax_xla_compile_ms_total"
XLA_LIVE_EXECUTABLES = "parallax_xla_live_executables"
XLA_COMPILE_STORMS_TOTAL = "parallax_xla_compile_storms_total"
DEVICE_MERGE_SKIPPED_TOTAL = "parallax_device_merge_skipped_total"

# -- misc subsystems ---------------------------------------------------------
LORA_ADAPTER_EVICTIONS_TOTAL = "parallax_lora_adapter_evictions_total"
XLA_COMPILES_TOTAL = "parallax_xla_compiles_total"

# -- HTTP frontend (backend/http_server.py) ----------------------------------
HTTP_REQUESTS_TOTAL = "parallax_tpu_requests_total"
HTTP_PROMPT_TOKENS_TOTAL = "parallax_tpu_prompt_tokens_total"
HTTP_COMPLETION_TOKENS_TOTAL = "parallax_tpu_completion_tokens_total"
HTTP_UPTIME_SECONDS = "parallax_tpu_uptime_seconds"
HTTP_TTFT_MS = "parallax_http_ttft_ms"
HTTP_E2E_MS = "parallax_http_e2e_ms"

# HELP text per metric — the exposition string registration sites pass
# and the table docs/observability.md mirrors. One entry per constant
# above; the metric-hygiene checker fails the pass on a missing or
# orphaned entry.
HELP: dict[str, str] = {
    TTFT_MS: "Time to first token, milliseconds",
    TPOT_MS: "Time per output token after the first, milliseconds",
    E2E_MS: "End-to-end request latency, milliseconds",
    STEP_HOST_MS: "Host-blocking milliseconds per engine step",
    STEP_DEVICE_MS: "Device-readback milliseconds per engine step",
    STEP_PER_TOKEN_HOST_MS: (
        "Host-blocking milliseconds per committed token (host-visit "
        "cost amortized over the tokens that visit committed)"
    ),
    STEP_BATCH_TOKENS: "New tokens per dispatched engine step",
    QUEUE_DEPTH: "Requests parked in the stage wait queue",
    RUNNING_REQUESTS: "Requests admitted into the running set",
    ATTN_KERNEL_DISPATCH_TOTAL: (
        "Engine dispatches by attention kernel implementation"
    ),
    KV_PAGE_OCCUPANCY: "Fraction of KV pages in use (0..1)",
    KV_PREEMPTIONS_TOTAL: "Decode-OOM preemptions to the host KV tier",
    KV_RESUMES_TOTAL: "Preempted requests swapped back in",
    KV_OOM_TOTAL: "Last-resort kv_oom aborts",
    KV_PAGES_EVICTED_TOTAL: "Device pages reclaimed from the prefix tree",
    PREFILL_TOKENS_SKIPPED_TOTAL: (
        "Prompt tokens skipped by mid-prefill prefix-cache chunk "
        "skipping (radix re-consult after admission)"
    ),
    TRANSPORT_BYTES_OUT_TOTAL: "Wire bytes sent per link",
    TRANSPORT_BYTES_IN_TOTAL: "Wire bytes received per link",
    TRANSPORT_FRAMES_OUT_TOTAL: "Frames sent per link",
    TRANSPORT_DROPS_TOTAL: "Frames dropped per link (overflow / dead peer)",
    TRANSPORT_QUEUE_DEPTH: "Sender frames currently queued per link",
    MIGRATIONS_TOTAL: (
        "Requests restored on this head after a live migration or "
        "client resume"
    ),
    MIGRATION_MS: "Park -> resume latency of migrated requests, ms",
    MIGRATION_CHECKPOINTS_TOTAL: (
        "Requests checkpointed away from this head during node-churn "
        "drains"
    ),
    KV_TRANSFER_BYTES_TOTAL: (
        "KV-page handoff payload bytes over the transfer lane"
    ),
    KV_TRANSFER_FRAMES_TOTAL: "KV_TRANSFER frames over the transfer lane",
    KV_TRANSFER_MS: (
        "KV handoff transfer latency, ms (out: first frame enqueued -> "
        "decode-head result; in: begin frame -> image assembled)"
    ),
    KV_TRANSFER_FALLBACKS_TOTAL: (
        "KV handoffs that fell back down the re-prefill ladder, by rung"
    ),
    KV_HANDOFFS_TOTAL: (
        "Prefill->decode handoffs completed, by restore mode"
    ),
    ROUTING_DECISIONS_TOTAL: "Routing decisions per strategy reason",
    ROUTING_DISPATCH_TOTAL: "Requests dispatched per registered pipeline",
    ROUTING_PREDICTED_CACHED_TOKENS_TOTAL: (
        "Dispatch-time predicted prefix-cache hit tokens"
    ),
    ROUTING_ACTUAL_CACHED_TOKENS_TOTAL: (
        "Admission-time actual prefix-cache hit tokens (head engine, "
        "via request_complete)"
    ),
    QOS_SHEDDING: (
        "1 while admission control is shedding sheddable-class work "
        "(0 otherwise)"
    ),
    QOS_BURN_RATE: (
        "Windowed burn rate of the protected class's TTFT budget "
        "((1 - attainment) / (1 - target))"
    ),
    QOS_SHED_TRANSITIONS_TOTAL: "Admission-control state transitions",
    QOS_ADMISSIONS_TOTAL: (
        "Requests admitted into the running set, by QoS class"
    ),
    QOS_SHEDS_TOTAL: (
        "Requests held back in admission by shed state, by QoS class"
    ),
    QOS_PARKS_TOTAL: (
        "Running decodes parked to the host tier by shed enforcement, "
        "by QoS class"
    ),
    QOS_DEADLINE_SLACK_MS: (
        "Deadline slack at admission, milliseconds (negative slack is "
        "clamped into the first bucket)"
    ),
    QOS_TTFT_MS: (
        "Time to first token by QoS class, milliseconds (the admission "
        "controller's burn-rate input)"
    ),
    QOS_REROLES_TOTAL: (
        "Pipelines re-roled between phase pools by the autoscaler"
    ),
    SPEC_PROPOSALS_TOTAL: (
        "Speculative continuation tokens staged for verification, by "
        "proposal source (ngram / draft)"
    ),
    SPEC_ACCEPTED_TOTAL: (
        "Proposed tokens that survived target-model verification and "
        "committed, by proposal source"
    ),
    SPEC_REJECTED_TOTAL: (
        "Proposed tokens the target model rejected (computed and "
        "discarded), by proposal source"
    ),
    SPEC_ACCEPTANCE_RATE: (
        "Accepted fraction of verified proposal tokens on this stage "
        "(0..1; 0 before any verification) — the speculation tuning "
        "signal"
    ),
    SPEC_PROPOSE_MS: (
        "Host milliseconds spent staging one round of speculative "
        "proposals, by source"
    ),
    CONSTRAINED_ACTIVE_ROWS: (
        "Running requests with live grammar-DFA state on this stage"
    ),
    CONSTRAINED_WINDOW_ROWS_TOTAL: (
        "Feature rows (grammar / penalties / logprobs / logit_bias) "
        "dispatched into fused K-step decode windows"
    ),
    CONSTRAINED_MASK_STEPS_TOTAL: (
        "Grammar mask applications executed inside jitted decode "
        "windows (rows x scan steps)"
    ),
    CONSTRAINED_TABLE_BUILDS_TOTAL: (
        "Dense device grammar tables compiled (one all-states sweep "
        "per distinct schema)"
    ),
    CONSTRAINED_TABLE_CACHE_HITS_TOTAL: (
        "Grammar device-table lookups served from the compiler cache"
    ),
    CONSTRAINED_SPEC_MASK_REJECTIONS_TOTAL: (
        "Speculative proposal tokens rejected because the grammar mask "
        "excluded them at their position"
    ),
    CONSTRAINED_FALLBACKS_TOTAL: (
        "Feature batches that fell back to the host-sync sampler "
        "(constrained_window off, or an oversized grammar)"
    ),
    GOODPUT_TOKENS_TOTAL: (
        "Device-step tokens classified by usefulness (committed / "
        "frozen_tail / replayed / preempted_rework / "
        "speculative_rejected)"
    ),
    GOODPUT_TIME_SECONDS_TOTAL: (
        "Host-visit and device seconds by activity bucket (serve / "
        "compile / swap / migrate / kv_transfer; idle is derived)"
    ),
    GOODPUT_FRACTION: (
        "Committed fraction of all classified device-step tokens on "
        "this node (0..1; 0 before any device work)"
    ),
    REQUESTS_FINISHED_TOTAL: (
        "Requests finished on this node's head stage, by outcome"
    ),
    WATCHDOG_TRANSITIONS_TOTAL: (
        "Health state-machine transitions per component"
    ),
    HEALTH_STATE: (
        "Current component health (0 = ok, 1 = degraded, 2 = stalled)"
    ),
    TIMELINE_EVENTS_TOTAL: "Flight events merged into the cluster timeline",
    TIMELINE_GAPS_TOTAL: (
        "Flight-event sequence gaps detected while merging node "
        "timelines (dropped heartbeats / ring overruns)"
    ),
    SLO_ATTAINMENT: (
        "Windowed SLO attainment per objective (fraction of the "
        "window's requests inside the objective; 1.0 with no traffic)"
    ),
    SLO_BURN_RATE: (
        "Windowed error-budget burn rate per objective "
        "((1 - attainment) / (1 - target); > 1 burns faster than the "
        "budget accrues)"
    ),
    OBS_MERGE_SKIPPED_TOTAL: (
        "Histogram children whose bucket lattice could not be merged "
        "bucket-for-bucket (heterogeneous-build swarm); their "
        "sum/count still fold in, percentiles degrade loudly"
    ),
    SCHEDULER_EVENTS_TOTAL: (
        "Topology events handled by the scheduler event thread, by kind "
        "(join / leave / peer_down / update)"
    ),
    SCHEDULER_REBALANCES_TOTAL: (
        "Global rebalances (full teardown + re-allocation of every "
        "pipeline)"
    ),
    SCHEDULER_HEARTBEAT_EVICTIONS_TOTAL: (
        "Nodes evicted by the heartbeat sweep (missed-beat leaves, as "
        "opposed to clean node_leave departures)"
    ),
    SCHEDULER_DRAINS_TOTAL: (
        "Drain directives issued to pipeline heads around dead peers"
    ),
    SCHEDULER_MIGRATION_TARGETS_TOTAL: (
        "Migration targets chosen for parked requests (CacheIndex-"
        "scored)"
    ),
    SCHEDULER_MIGRATIONS_RECORDED_TOTAL: (
        "migration_done reports recorded into the where_is table"
    ),
    SCHEDULER_DISAGG_TARGETS_TOTAL: (
        "Decode-pool handoff targets chosen for finished prompts"
    ),
    HA_PROMOTIONS_TOTAL: (
        "Warm-standby scheduler promotions (lease expiries acted on)"
    ),
    HA_JOURNAL_RECORDS_TOTAL: (
        "State-mutating events appended to the scheduler HA journal"
    ),
    HA_REPLAY_MS: (
        "Promotion latency: journal/lease decision to active scheduler "
        "(ms)"
    ),
    HBM_BYTES: (
        "Device HBM bytes by allocation class (weights_<dtype> / "
        "kv_pages / host_staging / spec_draft / grammar_tables / "
        "sampling_workspace / compile_headroom / untracked); the "
        "ledger invariant sum(classes) + untracked == device_total "
        "is asserted on every refresh"
    ),
    HBM_HEADROOM_BYTES: (
        "Device HBM bytes still unclaimed by any allocation class "
        "(capacity minus tracked minus untracked)"
    ),
    HBM_HIGH_WATERMARK_BYTES: (
        "Highest total device HBM occupancy observed since process "
        "start (tracked + untracked)"
    ),
    DEVICE_TIME_SECONDS_TOTAL: (
        "Device/host-visit seconds by dispatched program family "
        "(prefill / decode / decode_window / spec_window / "
        "spec_verify / sp_prefill / swap_gather / swap_scatter) — "
        "splits the goodput ledger's serve bucket"
    ),
    XLA_COMPILE_MS_TOTAL: (
        "Cumulative XLA backend compile milliseconds by program "
        "family"
    ),
    XLA_LIVE_EXECUTABLES: (
        "Live compiled executables currently cached, by program "
        "family"
    ),
    XLA_COMPILE_STORMS_TOTAL: (
        "Recompile storms detected (N same-family compiles inside "
        "the sliding window), by program family"
    ),
    DEVICE_MERGE_SKIPPED_TOTAL: (
        "Heartbeat device payloads skipped by the cluster merge "
        "(node missing the device section — old build); the merged "
        "view degrades loudly instead of silently narrowing"
    ),
    LORA_ADAPTER_EVICTIONS_TOTAL: (
        "Adapters evicted by the hot-load LRU cache"
    ),
    XLA_COMPILES_TOTAL: (
        "XLA backend compilations by program family and recompile "
        "cause (first / new_shape_bucket / k_change / "
        "sampling_feature / spec_toggle / other)"
    ),
    HTTP_REQUESTS_TOTAL: (
        "Generation requests accepted by the HTTP frontend"
    ),
    HTTP_PROMPT_TOKENS_TOTAL: "Prompt tokens across accepted requests",
    HTTP_COMPLETION_TOKENS_TOTAL: (
        "Completion tokens generated (counted at request end)"
    ),
    HTTP_UPTIME_SECONDS: "Frontend process uptime",
    HTTP_TTFT_MS: (
        "Client-observed time to first streamed token, milliseconds"
    ),
    HTTP_E2E_MS: "Client-observed request latency, milliseconds",
}


def all_names() -> tuple[str, ...]:
    """Every declared metric name, sorted (docs/tests iterate this)."""
    return tuple(sorted(HELP))


def help_text(name: str) -> str:
    """The declared HELP string for a metric name (KeyError on an
    undeclared name — registration sites must not invent series)."""
    return HELP[name]
