"""Drive the PyTorch port (parallax_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                       # every phase, one card
    python3 chip_smoke.py --only kernels,moe_serve   # a short check
    python3 chip_smoke.py --only moe_serve,moe_profile   # with its profile

The per-model profiles (moe_profile, mla_profile, dsa_profile,
gptoss_profile) run only when ``--only`` names them: the whole script
keeps to its time limit on a slow host without them.

Phases, in order; any failure raises and the script exits non-zero:

1. env         the card's name and power limit, torch and CUDA versions;
               TF32 is switched off so the float32 checks mean what they say.
2. build       nvcc builds the kernels from parallax_tpu_torch/csrc.
3. kernels     each hand-written kernel against its plain PyTorch version on
               the card: the attention kernels and the sampler at the shapes
               Qwen2.5-7B gives them (Hq 28, Hkv 4, D 128, page 64, bf16
               cache, vocab 152064), plus a small float32 case with sinks, a
               sliding window and a soft cap; the KV append (A0) bitwise at
               one token, token counts off its 8-token blocks, dropped
               slots and a float32 cache, with its wrapper's host
               microseconds by part; the grouped GEMM (A4), both variants
               forced and the one M picks, at the shapes Qwen3-30B-A3B
               gives it (a 2048-token prefill step, M = 16384 rows over 128
               experts with empty and 1-row groups, and a 7-row decode
               step, M = 56; gate/up N 768 K 2048, down N 2048 K 768), at
               DeepSeek-V3's (256 experts, gate/up N 2048 K 7168, down N
               7168 K 2048: an expert tensor past 2**31 elements) and small
               cases with N and K tails, M < E, E = 1 and a 20-row group at
               decode M, each deterministic; the MLA decode kernels (A5
               fused, A6 split) at DeepSeek-V3's shapes (7 rows, Hq 128,
               R 512, Dr 64, page 64, contexts 292-732, bf16) and the
               indexer kernels (A7 fused, A8 split; DSA and MSA reductions)
               at DeepSeek-V3.2's (Hi 64, D 128), each plus a small float32
               case with a kv_len 0 row, a frozen slot -1 row, kv_len 1 and
               a context ending mid-page; the split decode kernel (A9) and
               the fused one (A2) at gpt-oss-20b's decode shapes (7 rows,
               Hq 64, Hkv 8, D 64, random sinks, window 128 and none) plus a
               small float32 case (a kv_len 0 row, kv_len 1, mid-page ends,
               windows shorter than and spanning a page) and the same in
               bf16, and at contexts over several decode splits (up to
               8,192 tokens, a window starting inside a split); A1
               attend-only on the same rows as one-token sequences must give
               A2's bits; A1's per-sequence tiles (one-token rows among long
               chunks, a chunk of several tiles, bucket padding at exact
               zeros); A1 attend-only at the dense split path's decode shape
               (7 rows x 1 token); A5 / A6 once more at 7 rows of 8,192
               keys (66 MB of latent cache); A7 / A8 once more at 7 rows
               of 32,768 keys (58.7 MB of index keys), with the MSA
               reduction at MiniMax-M3's indexer (Hi 16, D 64) and in bf16
               at pages of 16, 24 and 12 positions, each twice, the same
               bits; A3 at 64 rows of DeepSeek-V3's
               and gpt-oss-20b's vocabularies with ties forced over its
               chunk boundaries; A3, A5 and A6 twice, the same bits. Then it
               times each (CUDA events, median, L2 flushed) beside its plain
               version, a PyTorch library call where one computes the same
               function, and its bound, and A2 / A9 once more at 7 rows of
               2,048-8,192 tokens; the device_only_ms line times A0, A1, A2,
               A9, A3, A4 (each shape), A5 and A6 (both shapes) and their
               library calls with the host's enqueue hidden, and A7 / A8
               (both shapes); the noise kernel (gumbel_rows) against its
               twin (words equal, noise within 1 ulp, two calls bitwise) at
               the sampler's 8 rows of Qwen2.5's vocabulary and a
               vocabulary that is not a multiple of 4; A3 on grammar-masked
               rows of Qwen2.5's vocabulary (sampler_masked: 1, 3 or 258
               allowed tokens, the rest at -1e10, top-k 1 / 40 / 64,
               temperature 0 / 0.8), exactly the plain version's tokens;
               A0, A1 (fused and attend-only), A2 and A9 at head dim 256
               (Qwen3-Next's Hq 16, Hkv 2; bf16 and float32, prefix hits,
               windows, padding and frozen rows; two calls the same bits)
               and A4 at Qwen3-Next's MoE shapes (E 512, N 512, K 2048).
               The weight-only quantized products: A10 (quant_linear) at
               Qwen2.5-7B's shapes (q, k / v, o, gate / up, down, lm_head
               with f32 out; M 7 and 749; bits 8 and 4; groups 32, 64,
               128; the other variant forced once a shape) within
               QUANT_REL_TOL (f32 out) / BF16_TOL (bf16 out) of its plain
               version, two calls the same bits, the on-card quantization
               numpy's bit for bit; A11 (grouped_gemm_q) at Qwen3-30B-A3B's
               expert shapes (M 56 and 16,384; both variants forced and
               picked) within F32_TOL; both timed device-only beside the
               bound and (A10) ``F.linear`` on the bf16 weight; both
               swept across their variants' crossover in M (both forced,
               device time: kDecodeMaxRows / kQDecodeMaxRows are set from
               it); a quantized GLM-4.5-Air MoE block whose shared expert
               runs on A10 (3 launches a block) beside A11, within
               BF16_TOL of the plain block.
4. serve       a single-stage StageEngine on cuda:0 serving full-width,
               all-28-layer Qwen2.5-7B (random bf16 weights from a seeded
               torch.Generator on the card) to 8 concurrent requests
               through the one-in-flight drive_step loop, five times:
               fused with the engine's defaults (the K-step window,
               adaptive K = 8, overlapped, each window step a replayed CUDA
               graph), the same with graphs off (greedy and seeded rows
               bitwise the graphs run's), the same kernels in the parent's
               configuration (K1_SYNC: K = 1, synchronous), split (A1
               attend-only once per layer and forward step, the
               counterpart of the bundled ragged_paged_attention) and plain
               (use_kernels=False, K1_SYNC). Every kernel's launches are
               exact, graph replays included (layers x forward steps, m x
               k forward steps a window chain). The kernel runs' greedy
               streams must agree with the plain model's logits
               (tie-tolerant). One greedy stream is decoded again step
               by step, A2 against the plain decode on the same cache, and
               the largest logit difference printed (no limit).
5. pipeline    the fused run through a 14 + 14 layer InProcessPipeline on
               the same card (step_round; windows stay inert there),
               sharing the weight tensors.
6. profile     the serve phase once more under torch.profiler, with the
               engine's defaults: device time by kernel group and the
               device's busy share of the wall (the K1_SYNC profiles were
               cut to keep the script inside its time limit).
6.1 native    the native C++ cache manager on the same tree: the mix
               with the defaults on the native manager (asked for
               explicitly: a host that cannot build the library fails)
               and on the Python one, streams bitwise equal, the same
               prefix hits, launches exact; host us per admit / grow /
               release and host ms per step for both; the mix twice more
               on 48 pages (max batch 3) so the tree evicts, both
               managers, streams equal; and the host-only benchmark of
               the JAX package's 3-16x claim (no device).
6.2 spec_serve speculative decoding on the same tree: the mix plus two
               prompts of a repeated 64-token span, with speculation off
               and (a) n-gram P = 4 with the defaults (speculative K = 8
               windows from CUDA graphs, the verify forward A0 + A1 over
               S x 5 tokens), (b) the K = 1 sync fallback beside K1_SYNC
               off, (c) a draft that is the served tree (its tensors
               shared) and (d) its first 4 layers. Launches exact (the
               draft engine's own added), greedy rows within GREEDY_TOL of
               the plain path, each row equal to the spec-off run's or
               parting from it only at a near-tie, (c) at least 90% of its
               greedy rows' proposals accepted and every draft proposal
               off the committed stream at a gap under GREEDY_TOL. Per
               request acceptance, tokens a verify forward, decode tok/s
               and TTFT against spec off, the draft's share of the wall.
6.3 pp_spec    pipeline speculation over a 14 + 14 pipeline: spec_serve's
               requests with speculation off, n-gram P = 4 and the
               4-layer draft on the head; launches exact per stage, greedy
               within GREEDY_TOL, and the packets carrying ``spec_len``
               down and ``spec_accepted`` back counted (the draft run must
               send both).
6b. features_serve  sampling features on the same Qwen2.5-7B tree (its
               own, made the same way, when run alone): serve's 8 prompts,
               48 new tokens each, one feature set a row (r0 / r1 the
               JSON schema of tests/test_constrained_window.py, greedy /
               seeded top-k 40, EOS 257; r2 / r3 penalties; r4 logit_bias
               and logprobs; r5 logprobs; r6 everything; r7 none), with the
               byte tokenizer's grammar vocabulary (258 ids): the defaults
               (K = 8 feature windows from CUDA graphs), graphs off (every
               row's tokens and logprob bits equal), K1_SYNC and plain;
               launches exact (A3 on the feature rows); the defaults ran
               feature windows with no fallback; r0 / r2 / r4 within
               GREEDY_TOL of the plain one-shot logits with their features
               applied; grammar rows schema-valid JSON ending at EOS; one
               logprob (<= 0) a token on logprob rows. Then the same mix
               without features (its TTFT and decode rate beside), r0 with
               EOS biased +20 (stops at the grammar's terminal state, under
               its budget), and one window step's feature pass timed on the
               device (S 8, V 152,064).
6c. preempt_serve  the host KV tier on the same tree: serve's 8 prompts,
               48 new tokens each, on a 35-page pool (PREEMPT_PAGES) with
               a 4 GiB tier, with the defaults and with K1_SYNC: each
               preempts and resumes at least twice, aborts nothing,
               finishes every request at 48 tokens, launches exactly and
               keeps its greedy rows within GREEDY_TOL of the plain path;
               the defaults also fall back from windows to K = 1 steps.
               TTFT and decode tok/s beside the same mix on serve's 192
               pages; host ms a preemption and a resume. Then a live
               request's 11 pages through the tier into other pages,
               bitwise (D2H / H2D GB/s), 6 churn prompts of 512 ids, and
               r0's and r7's prompts again, which must swap host-resident
               prefix pages in (tokens_hit_host >= 256).
6d. migrate_serve  live migration on the same tree. (a) r1 (greedy) and
               r2 (seeded) alone: parked at 16 of 48 tokens on engine A,
               the KV image harvested, the checkpoint through frame bytes,
               adopted by engine B (same layout, A's weights): the
               uninterrupted run's tokens, one resume, no prefill step
               and no A0 / A1 on B; the same checkpoint without its image
               by re-prefill and replay: the same tokens. (b) a
               GlobalScheduler and four WorkerNodes in this process laid
               out as two 14 + 14 pipelines; the mix routed round robin
               through a SwarmClient; the tail of r0's pipeline stops
               once its requests streamed 4 tokens: its head parks them,
               they restore on the other pipeline by replay, the client
               follows: zero aborts, greedy rows within GREEDY_TOL,
               ``where_is`` answering each new head; park-to-restore
               seconds.
6e. disagg_serve  disaggregated prefill / decode on the same tree: a
               GlobalScheduler (cache-aware) and its service on TCP
               loopback with two WorkerNodes in this process, each serving
               all 28 layers of the shared tree with the defaults and a
               4 GiB tier; preempt_serve's mix (48 new tokens) routed and
               polled through a SwarmClient, three times: both workers
               mixed, then prefill + decode, then prefill + decode as two
               processes (``--disagg-worker``, each on its own draw of
               the tree). Every request ends by length with zero aborts,
               launches exact (summed over the in-process pair, per
               process for the pair of processes), greedy rows within
               GREEDY_TOL of the plain path; the disaggregated runs hand
               every request off by image (8 adopted, no fallback,
               ``where_is`` the decode head, no A0 / A1 on the decode
               head, the scheduler's disagg section active with 8 targets
               chosen); r0's pages on the decode head right after its
               swap-in are its harvested image bitwise. Per handoff: pages,
               bytes, frames, flag -> park, the park's own, park -> result
               and assembly ms, the transfer's GB/s and adopt ms; each
               run's TTFT and decode tok/s.
7. http_serve  the front door on the same Qwen2.5-7B tree (its own, made
               the same way, when run alone): written as an HF checkpoint
               (bf16 shards of at most 5 GB, the index, config.json; a
               writer of this script's own) into a temporary directory;
               ``python -m parallax_tpu_torch generate`` on it in a
               subprocess (exit 0, its summary line); loaded back with
               load_stage_params, every leaf the written one's bits (the
               random tree is dropped then); ``serve`` (the CLI's parser
               and serve_main, on a free port in a thread, pages from the
               addressable cap) answering the 8-request mix as text from 8
               client threads (4 chat, 4 completions, half streamed; r7
               sent once r0 is answered). Every reply 200 with finish
               reason "length" and 32 tokens; the text the ids' decode;
               launches exact with replays; impl cuda-fused; the greedy
               rows within GREEDY_TOL of the plain path on the loaded
               weights; the sharer hit the prefix cache. Then the same mix
               through the library API with the server's page count.
               Before the server stops: JSON mode (json_schema and
               json_object), logprobs streamed and not, logit_bias and
               penalties on chat and completions, each 200 with a logprob
               entry a completion token where asked and valid JSON where a
               schema was; an unsupported schema 400.
8. swarm_serve the scheduler-less swarm on the same checkpoint, 14 + 14
               layers (``--only swarm_serve`` runs http_serve first). (a)
               Two WorkerNodes on TcpTransports in this process, on slices
               of the loaded tree, serve the mix's prompt ids submitted at
               the head: every request ends by length, each worker's
               launches exact (A2 14 x its decode steps, A0 + A1 14 x its
               prefill steps, A3 and the noise kernel on the tail only), no
               window and no graph capture, the greedy rows within
               GREEDY_TOL of the plain path; the streams counted against
               the in-process 14 + 14 pipeline's on the same requests.
               Then (a) once more over a float8 link (``wire_dtype="fp8"``
               on both workers): float8 negotiated, every request
               complete, the hidden-state bytes a hop against the native
               bf16 run's, the greedy tokens equal to its reported.
               (b) Two ``python -m parallax_tpu_torch join`` processes
               (each binds port 0 and logs its address; the tail takes
               the head as its --peers; --advertise-addr 127.0.0.1) and
               ``chat-host --head`` in a third; the http_serve mix from 8
               client threads on the fresh processes, then a mix of the
               same shape with other text on the warm ones (a 503 while no
               route is retried): every reply 200 with 32 tokens; the
               greedy rows of the first mix once more over the head's
               chat RPCs, their ids against (a)'s and within GREEDY_TOL of
               the plain path, the HTTP text their decode; no step loop
               error and no traceback in any log; every process exits 0
               within 30 s of SIGTERM; the workers' exit summaries show no
               graph captured. TTFT, decode and output tok/s of both
               mixes beside the pipeline and HTTP figures, spawn-to-route
               time and the bytes each link carried.
9. sched_serve the swarm the global scheduler assigns, on the same
               checkpoint (``--only sched_serve`` runs http_serve first).
               (a) A GlobalScheduler and its SchedulerService on TCP
               loopback in this process, with two WorkerNodes that join it
               (``scheduler_peer``) and load slices of the loaded tree; the
               roofline's memory bound patched to 14 layers a node, so the
               scheduler lays out one 14 + 14 pipeline (checked). The mix's
               prompts routed and polled through a SwarmClient on the
               service: every request ends by length, each stage's launches
               exact, the greedy rows within GREEDY_TOL of the plain path.
               The tail then stops (node_leave): the pipeline dissolves and
               the SwarmClient routes a new request to None (the HTTP
               plane's 503); a new tail joins, a pipeline comes back and
               serves one more request. (b) ``python -m parallax_tpu_torch
               run --min-nodes 2 --routing cache_aware`` and two ``join
               --scheduler-addr`` processes (spawned together): each worker
               reports one H100, so the scheduler lays out two 28-layer
               replicas (checked from /cluster/status_json). The HTTP mix:
               r0-r6 from 7 client threads, then r7 (r0's prefix) once they
               are answered and a heartbeat carried the heads' digests;
               every reply 200 with 32 tokens; r7's replica, the router's
               reason and its cached prompt tokens from the status's
               routing section; the greedy rows once more through a
               SwarmClient over the route_request RPC, their ids against
               (a)'s and within GREEDY_TOL of the plain path; clean logs;
               every process exits 0 within 30 s of SIGTERM (the workers
               first: both node_leaves land). Spawn to route ready, route
               ms, TTFT, decode and output tok/s beside the pipeline's and
               swarm_serve's, and the seconds the phase took.
9a. refit_serve a weight refit on the same checkpoint (``--only
               refit_serve`` runs http_serve and sched_serve too). The
               donor is the same config drawn from REFIT_SEED on the card,
               written as one safetensors file beside the checkpoint and
               indexed with its sha256 (``p2p/refit.build_index_map``).
               (a) In this process, with the defaults and with K1_SYNC: an
               engine on a copy of the loaded tree serves the mix, takes
               the donor (fetched once on the host, swapped in place by
               ``apply_prefetched``) and serves the same mix again; a fresh
               engine on the donor serves it too. The post-refit streams
               are bitwise the fresh engine's, no row reuses a pre-refit
               page (its cached tokens are the fresh engine's, the
               invalidated pages counted), no graph is captured after the
               refit, every weight keeps its address, allocated HBM moves
               by less than the largest tensor, launches exact over both
               mixes. Fetch s and GB/s, sha256 s, apply ms. (b) After
               sched_serve (b)'s checks, on its ``run`` and two ``join``
               processes (which got ``--compilation-cache-dir`` at the
               build phase's directory): POST /weight/refit with the
               donor's index, both workers at refit_version 1 on
               /cluster/status_json, the HTTP mix again (every reply 200
               with 32 tokens) and the greedy rows through the route RPC
               (the byte tokenizer's text carries no ids), within
               GREEDY_TOL of the donor's plain argmax while the old tree's
               argmax is off by more; the joins built no library. POST to
               both at v1 s, POST to first token s, each worker's fetch /
               sha256 / apply figures from its ``refit:`` log line. The
               donor file goes at the phase's end (its bytes and the free
               disk printed).
9b. ha_serve   scheduler HA on the same checkpoint (``--only ha_serve``
               runs http_serve first). (a) In this process: a primary
               GlobalScheduler + SchedulerService journaling to a passive
               mirror whose StandbyScheduler tails it over TCP loopback
               (lease 3 s, pulls every 0.5 s), two WorkerNodes joined with
               ``scheduler_standby`` (one 14 + 14 pipeline, capacity
               patched as in sched_serve) and a SwarmClient over [primary,
               standby]: a seeded request alone, then the mix; once r0-r6
               stream, the primary's service stops. Every request ends by
               length with zero aborts, launches exact over the pair, no
               engine rebuilt, greedy rows within GREEDY_TOL of the plain
               path; the standby promotes to epoch 2 within lease + sync
               interval; the workers' heartbeats and the client's routes
               move to it; the seeded request once more through it gives
               the same tokens; the old primary fences on the epoch a
               worker echoes and refuses a join. (b) ``run
               --scheduler-standby S`` (P), ``run --standby-of P
               --ha-lease-s 3`` (S) and two ``join --scheduler-addr P
               --scheduler-standby S`` processes (two 28-layer replicas,
               cache_aware; four fixed ports from below the ephemeral
               range): S answers 503 while it mirrors; the HTTP mix to P
               (after one warm-up mix); this process's SwarmClient over [P,
               S] routes the mix's prompts at 96 new tokens (once
               unmeasured, so their window graphs are captured first,
               then again), and once r0-r6 stream, P gets SIGKILL. Every client row finishes by length,
               S promotes (its log line: epoch 2 and the journal seq it
               replayed), the client's next route lands on S, a second mix
               (other text) to S's HTTP port answers 200 with 32 tokens
               each; clean logs; the survivors exit 0 within 30 s of SIGTERM
               (the workers' node_leaves land on S); each worker built one
               engine and launched exactly; the client rows' greedy ids
               within GREEDY_TOL of the plain path. Kill to promoted ms,
               promoted to first route ms, journal records and bytes, TTFT
               and decode tok/s before and after, and the phase's seconds.
9c. obs_serve  the observability plane on the same checkpoint (``--only
               obs_serve`` runs http_serve first). (a) The mix through the
               library API on the loaded tree three times, each on fresh
               obs planes: obs at its defaults, fully on (every request
               traced, a watchdog, an SLO tracker), and on under
               torch.profiler. Streams bitwise equal and launches exact and
               equal between the first two; goodput committed equal to the
               tokens streamed; the HBM ledger's weights_bfloat16 and
               kv_pages equal to the tree's and the pool's bytes, the
               tracked bytes within torch.cuda.memory_allocated and the
               untracked residual under the ledger's threshold; the compile
               observatory's captures equal to the engine's graphs. The
               CUDA-event device ms by program beside the profiler's busy
               ms, capture seconds, the residual and host ms a visit in
               both runs; then one engine under a batch ramping down from
               32 rows: its captures and whether the observatory calls
               them a storm (a reading). (b)
               ``serve --trace-sample-rate 1 --watchdog --slo ...`` over
               HTTP with /metrics, /cluster/status_json, /debug/device,
               /healthz and /debug/flight scraped from another thread
               through the mix (graph captures included): 200s, no loop
               failure; /metrics parses with the core families, each in
               the JAX name table; /healthz ok; /debug/trace/<id> has the
               spans; /profile/start (409 on a second) and /profile/stop
               around one more mix write a trace naming A0-A3. (c) ``run
               --slo`` (on a thread here, the memory bound patched to 14
               layers) and two ``join --trace-sample-rate 1 --watchdog``
               processes, one 14 + 14 pipeline: half the mix over HTTP; the
               merged step-host histogram counts equal the nodes' sum,
               goodput / device / SLO sections from both nodes; each
               worker's exit line lists the first request's trace under its
               stage; the timeline names both workers; then the tail
               stops under a long request and the head's flight event
               (abort path or migration flag) reaches the timeline
               through its heartbeat; exits 0.
9e. quant_serve  weight-only quantization on serve's Qwen2.5-7B tree (all
               28 layers), quantized on the card (group 64) from a copy of
               its dicts: int8 fused with the defaults, K1_SYNC and plain
               (``use_kernels=False``: dequantize then multiply, no A10;
               both two rows, 8 tokens); int4 fused with the defaults. Launches
               exact (A10 7 x 28 + 1 a forward step); the fused runs'
               greedy rows within GREEDY_TOL of the plain one-shot logits
               of the same quantized tree; the tree's bytes against
               bf16's. It also makes http_serve run ``serve --quantization
               int8`` over HTTP on its checkpoint (launches exact, greedy
               rows within GREEDY_TOL, the library API on the same tree and
               prompts beside it) and read back an MLX-format checkpoint
               (packed uint32 words, config ``quantization``) of that tree
               bitwise.
9f. lora_serve  per-request LoRA (``--only lora_serve`` runs http_serve
               for (b)). (a) On serve's Qwen2.5-7B tree (28 layers) with
               three adapters drawn from the seed (rank 16 on all seven
               projections, rank 8 on the same, rank 16 on attention of
               every other layer): the mix all base, with no adapter and
               with the three registered (bitwise); the mix two base rows
               and two per adapter with the defaults (K = 8, graphs,
               overlap, native manager, an LRU cap of 3), graphs off and
               K1_SYNC (both bitwise the defaults), r16's rows alone
               (grouped decode) and a 14 + 14 pipeline. Launches exact;
               adapter rows within GREEDY_TOL of the plain path with
               their adapter, the no-delta and wrong-adapter mutants
               above it; no prefix hit across adapters, a repeat under
               one adapter hits; a fourth adapter after capture evicts an
               idle one and serves its own stream; the step's delta
               device ms. (b) http_serve's bf16 ``serve`` launch gets
               ``--lora-adapters`` (PEFT directories written by the
               package's writer): after the mix, ``/v1/models`` lists the
               variants, base / ``"lora": "a"`` / ``<model>:b`` answer
               with the library's tokens, an unknown adapter 502s; the
               load-time merge and ``lora-merge``'s output load within
               bf16 rounding of each other and serve within GREEDY_TOL of
               the per-request adapter.
9d. qos_serve  the QoS plane, the router and the chaos harness (``--only
               qos_serve`` runs http_serve first, for (b)'s checkpoint).
               (a) The library run on serve's tree with the defaults (K = 8
               windows from CUDA graphs, overlap) on a 96-page pool with a
               4 GiB host tier: 7 batch rows decode, then 2 interactive
               rows arrive and wait for a slot; QoS off, QoS on and QoS on
               over the native manager. Streams bitwise equal across the
               three, no abort, launches exact; QoS on sheds, parks batch
               rows and resumes every one; the native manager parks
               nothing and warns once. Interactive TTFT, parks, sheds, park
               and resume host ms and the release's seconds. (b) Two
               ``serve --qos on`` processes (each its own KV fraction)
               behind ``python -m parallax_tpu_torch.router.lb --strategy
               session_affinity``: a bad deadline header answers 400, a
               session key stays on its replica, /router/status shows both
               EMAs, the router's added ms a request; the pinned replica is
               killed and, once the probe saw it, every request answers
               200. (c) ``run --qos autoscale=1``'s scheduler in this
               process with three 28-layer ``--qos on`` workers (prefill,
               decode, decode; shared weights) under the port's
               ChaosController (KV frames delayed, a few dropped): two
               chatty sessions decode, a burst of prompts starves the
               prefill pool, the autoscaler re-roles a decode pipeline, its
               worker adopts the role in place and drains; every request
               finishes, none aborts; the ``qos`` status section shows the
               re-role.
10. moe_serve   Qwen3-30B-A3B at full width and all 48 layers (random bf16
               weights, about 61 GB; the dense phases' tensors are freed
               first) serving the same 8-request mix with the defaults and
               with K1_SYNC (two rows, 8 tokens); every kernel's launches
               exact (the grouped GEMM 3 x 48 times per forward step), and
               the greedy streams must agree with the plain path (plain
               grouped product and plain attention); the same one-shot
               forward with A4 in place of the plain grouped product
               reports its logit difference (no limit). Then (after
               moe_profile) the tree quantized in place on the card (int8,
               group 64; about 33 of 61 GB) and served with the defaults:
               A11 3 x 48 times a forward step and no A4, A10 on attention
               and the lm_head, greedy rows within MOE_GREEDY_TOL of the
               plain path on the same quantized tree.
11. moe_profile moe_serve once more under torch.profiler (defaults; only
               when ``--only`` names it, as the other per-model profiles).
12. mla_serve  DeepSeek-V3 at full width and 5 layers (3 dense + 2 MoE; one
               random bf16 tree of 26.7 B params, the MoE model freed first)
               serving the same mix four times: fused decode (A5 once per
               layer and decode step) and split decode (A6 the same, A5
               never) with the defaults, fused with K1_SYNC, and the plain
               path (no kernel but the noise; K1_SYNC). The default runs'
               greedy rows must be identical and agree with the plain
               path's one-shot logits (tie-tolerant; the plain run's own
               gaps are printed beside them). One greedy stream is decoded
               again step by step, A5 against the plain MLA decode on the
               same cache, and the largest logit difference printed (no
               limit).
13. mla_profile mla_serve's fused run once more under torch.profiler
               (defaults).
14. dsa_serve DeepSeek-V3.2 at the same width and depth, on the same tree
               plus the indexer, with one more request of 2,400 prompt ids
               so that sparse top-k selection runs: fused (A7), split (A8)
               and plain, the same checks; the long greedy stream is
               decoded again step by step, A7 against the plain indexer
               (the logit difference, argmax and top-k set agreement).
15. dsa_profile dsa_serve's fused run once more under torch.profiler
               (defaults).
16. gptoss_serve gpt-oss-20b at full width and all 24 layers (20.9 B params,
               42 GB in bf16, each layer's sinks drawn N(0, 1); DeepSeek's
               tree freed first) serving the mix three times with
               mla_serve's checks: fused (A2 per layer and decode
               step, A0 + A1 per layer and prefill step), split (A9 per
               layer and decode step, A1 attend-only per layer and prefill
               step, nothing else but the sampler's noise), fused with
               K1_SYNC on two rows of the mix for 8 tokens (launches and
               completion checked) and plain.
               The fused run's first greedy stream is decoded again step
               by step, A2 against the plain decode (the logit difference
               and argmax agreement; no limit).
17. gptoss_profile gptoss_serve's fused run once more under torch.profiler
               (defaults).
18. msa_serve  MiniMax-M3 at full width and 5 of 62 layers (a dense
               full-attention layer 0, then four MSA + MoE layers; one
               random bf16 tree of 16.1 B params, gpt-oss's freed first)
               serving the mix plus one greedy request of 4,600 ids (past
               32 blocks of 64 tokens, so the indexer drops blocks) three
               times: fused (A2 on layer 0 and A7 on each sparse layer per
               decode step, both in MSA mode for A7), split (A1 attend-only
               on layer 0 and A8 on each sparse layer), fused with
               K1_SYNC on two rows for 8 tokens, and plain;
               prefill on the split chain (MSA turns fused
               prefill off), A4 three times per MoE layer and forward
               step; launches exact. The long stream is decoded again step
               by step, A7 against the plain indexer: the logit
               difference, argmax agreement, the steps whose selected block
               sets agree in every sparse layer, and the selected and
               causal blocks (fewer must be selected). The greedy limit
               must pass and must be reached by at least one of two wrong
               indexers serving the long request (every causal block
               selected; DSA's head reduction).
19. m2_serve   MiniMax-M2 at full width and 4 of 62 layers (15.9 B params,
               M3's tree freed first): fused (A2, A0 + A1), split (A1
               attend-only), fused with K1_SYNC and plain, A4 per MoE
               layer and step, launches exact; the greedy check and a
               teacher-forced A2 check as gpt-oss has.
20. next_serve Qwen3-Next-80B-A3B at full width and 8 of 48 layers (linear
               0-2, full 3, linear 4-6, full 7; 13.8 B params, 27.5 GB):
               fused (A0 + A1 and A2 at head dim 256 on the two gated
               full-attention layers, A4 three times a layer and forward
               step, A3), split (A1 attend-only), fused with K1_SYNC on
               two rows and plain, launches exact, graph replays included;
               a 4 + 4 pipeline; a prefix-sharing pair on both cache
               managers (the second request restores the first's
               linear-state snapshot and gives its prefix-off stream); the
               greedy limit against two mutants (the slot reset skipped,
               the attention output gate dropped); each layer kind's
               device ms from torch.profiler (ROADMAP P6).
21. zoo_serve  one tree at a time: GLM-4-9B-0414 (all 40 layers), GLM-4.5-Air
               (2 of 46: dense layer 0, MoE layer 1) and Step-3.5-Flash (2
               of 45: one full, one sliding layer; 36.6 B params, refused
               below the tree's bytes plus 2 GB free): fused and plain,
               launches exact, the greedy check; Step-3.5's limit against
               its head-gate mutant.

Depth cuts for time (the script's limit): the checkpoint phases
(http_serve through obs_serve, qos_serve's part b) serve Qwen2.5-7B at 8
of 28 layers (CKPT_LAYERS; 4 + 4 pipelines) and gptoss_serve at 8 of 24
(GPTOSS_LAYERS); serve keeps all 28. The teacher-forced decode checks
run the first TEACHER_FORCED_STEPS (16) of a stream's 32 tokens, and
quant_serve's plain int8 run serves two rows for 8 tokens.

One JSON object per line; the ``kernels`` line and the card line come just
before the last line, which is ``{"ok": true, "device": {...}}``. Each
kernel's launches in the ``kernels`` line come from the path that runs it:
A0-A4 from moe_serve, A5 and A6 from mla_serve's fused and split runs, A7
and A8 from dsa_serve's, A9 from gptoss_serve's split run, K9's route (A1
attend-only, entry ``ragged_attend``) from serve's split run and the noise
kernel from serve's fused run; msa_serve prints A7's and A8's MSA-mode
launches on a line of its own. The head-dim-256 entries (``<kernel>@d256``)
take A0 / A1 / A2's from next_serve's fused run and K9's route from its
split run; A9 at D 256 is held in the kernels phase only (no served model
gives it that shape) and reports A9's launches on its own path. ``--only
kernels`` (comma-separated phase names) runs a subset and prints no result
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import random
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_TOL = (2e-2, 2e-2)            # atol, rtol: bf16 outputs, two roundings
F32_TOL = (1e-4, 1e-4)             # float32 outputs, summation order only
GREEDY_TOL = 0.1                   # bf16 logit gap accepted at a near-tie
# The MoE model routes every token to 8 of 128 experts in each of 48 layers.
# A bf16 rounding difference that swaps a token's 8th and 9th expert changes
# that token's FFN output by a whole expert's share, and attention carries
# it on: the plain path's logits move further than a dense model's. On an
# H100 the largest gap over the 160 greedy tokens was 0.07 against this
# reference, and 0.11 (4 tokens at 0.1 or more) against one that summed its
# expert products in another order. A broken kernel is off by whole logits
# (their spread is about 0.9).
MOE_GREEDY_TOL = 0.25
# DeepSeek's router is far touchier on random weights: sigmoid scores with
# group-limited selection (top 4 of 8 groups) and a routed scaling of 2.5,
# so one bf16 rounding can swap a whole group's experts, and each routed
# expert carries about 2.5 / 8 of the FFN output. The one-shot reference
# and a served run round differently (other GEMM shapes, chunked prefill),
# so even the plain path served step by step, with no kernel at all, lands
# over a logit away from the reference's argmax at a few tokens; the
# deepseek phases serve it and print its gaps beside the kernels'. The
# limit is set above that noise and below what a broken kernel gives: a
# wrong token sits about 7 logits under the argmax (logit spread 1.7 over
# 129,280 entries). The second test is by count: the kernel runs may hold
# at most DEEPSEEK_OFF_MARGIN more tokens off by GREEDY_TOL or more than
# the plain run, which a kernel that is off by a few percent would break.
DEEPSEEK_GREEDY_TOL = 2.0
DEEPSEEK_OFF_MARGIN = 8
# gpt-oss picks 4 of 32 experts per layer over router logits rounded to
# bf16, where ties are common and the tie goes to the lower index: a
# rounding difference between the one-shot reference and a served run
# (other GEMM shapes, chunked prefill, the kernels' summation order) swaps
# an expert carrying a quarter of the FFN, in each of 24 layers. On an H100
# the kernel runs' largest gap was 1.19 with 52 of the 160 greedy tokens
# off by GREEDY_TOL or more, and the plain path served step by step (no
# kernel) 1.23 with 22. A decode that drops the sinks lands at 1.93 with
# 55: at these contexts an N(0, 1) sink is one logit among hundreds of
# keys (128 in the windowed layers), so the count cannot tell it apart and
# the gap limit sits between 1.23 and 1.93; the margin only bounds the
# count's own noise. A wrong
# token sits about 4.9 logits under the argmax (the median of the row).
GPTOSS_GREEDY_TOL = 1.5
GPTOSS_OFF_MARGIN = 48
DENSE_MODEL = "qwen2.5-7b"         # parallax_tpu_torch/models/presets.py
MOE_MODEL = "Qwen/Qwen3-30B-A3B"
DSV3_MODEL = "deepseek-ai/DeepSeek-V3"           # presets.py MODEL_DB
DSV32_MODEL = "deepseek-ai/DeepSeek-V3.2-Exp"
GPTOSS_MODEL = "openai/gpt-oss-20b"
# gptoss_serve's cut: 8 of its 24 layers (4 sliding, 4 full), for time.
GPTOSS_LAYERS = 8
# DeepSeek's three dense layers plus two MoE layers: 26.7 B params (53 GB in
# bf16). A third MoE layer (11.3 B params) would leave no room for the
# caches, the activations and the plain reference on an 80 GB card.
DEEPSEEK_LAYERS = 5
# dsa_serve adds one request longer than index_topk (2048), so the indexer
# selects a sparse top-k on the card.
DSA_LONG_PROMPT = 2400
DSA_MAX_MODEL_LEN = 3072
MSA_MODEL = "MiniMaxAI/MiniMax-M3"               # its indexer: Hi 16, D 64
M2_MODEL = "MiniMaxAI/MiniMax-M2"
# msa_serve: MiniMax-M3's dense full-attention layer 0 and four MSA + MoE
# layers (16.1 B params, 32 GB in bf16), plus one greedy request of
# MSA_LONG_PROMPT ids: past topk_blocks x block_size (32 x 64 = 2,048)
# tokens the indexer drops blocks (the long request keeps 32 of its 72).
MSA_LAYERS = 5
MSA_LONG_PROMPT = 4600
MSA_MAX_MODEL_LEN = 6144
# m2_serve: MiniMax-M2's first four layers, all MoE (15.9 B params).
M2_LAYERS = 4
# MiniMax routes 8 of 256 experts by sigmoid scores on random weights, so a
# bf16 rounding difference swaps experts as in DeepSeek and gpt-oss. On an
# H100 the plain M3 path served step by step (no kernel) landed 1.69 from
# the one-shot reference's argmax (15 tokens off by GREEDY_TOL or more), the
# kernel runs 1.23 (25); a wrong block indexer that keeps every causal block
# (dense attention) serving the long request lands at 1.95. The limit sits
# between the two. M2's plain run landed 0.42 (1 token off) and its kernel
# runs 0.93 (22), and a wrong token sits about 5.0 logits under the argmax,
# as in M3. The margin bounds the count's own noise (M2's kernel runs held
# 21 more off-tokens than its plain run); only the gap tells a wrong model
# apart.
MSA_GREEDY_TOL = 1.8
M2_GREEDY_TOL = 1.5
MINIMAX_OFF_MARGIN = 32
# A7 / A8's long-context shape: 7 rows of this many keys each.
INDEXER_LONG_KEYS = 32768
# Decode contexts over several splits (kernels phase), one past 4096.
LONG_LENS = [8192, 4500, 300, 1, 0, 2049, 640]
# A5 / A6's long-context shape: 7 rows of this many keys each.
MLA_LONG_KEYS = 8192
# The parent's engine configuration: one decode step a host visit, each step
# resolved before the next (K = 1, synchronous). The plain reference runs
# keep it; the kernel runs take the engine's defaults (the K-step window on
# the one-in-flight loop, replayed from CUDA graphs) and, for the rates,
# this one once more.
K1_SYNC = dict(decode_lookahead=1, overlap_steps=False)
# A proposal deadline no spec_serve round reaches (a round takes well
# under a second).
DRAFT_NO_DEADLINE_MS = 600_000.0
# Indexer scores: f32 sums of the same exact products, in another order.
SCORE_TOL = (1e-4, 1e-4)


T_START = time.monotonic()
# Figures of earlier phases that a later phase reports beside its own.
FIGURES: dict = {}


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.monotonic() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, flush=None, hide_host=False,
            clean=False) -> float:
    """Median device time of ``fn`` over ``iters`` calls (CUDA events), with
    the L2 cache flushed before each call when ``flush`` is given: by
    zeroing the 64 MB buffer, which leaves L2 full of dirty lines that the
    call then writes back, or with ``clean`` by reading it. The interval
    also holds any time the device waits for the host to enqueue the call;
    ``hide_host`` first queues a spin kernel (``_sleep``, about 0.5 ms)
    that keeps the device busy meanwhile, so the interval is the call's
    device time alone."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
            flush.zero_()
        if hide_host:
            torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _paged_rows(torch, lens, page, frozen, pps=None):
    """Pages of ``lens``-long contexts, allocated in order from page 1,
    and each row's append slot (its position kv_len - 1; -1 for padding
    and for the ``frozen`` rows)."""
    s = len(lens)
    pps = pps or max(1, max((n + page - 1) // page for n in lens))
    pages = torch.zeros((s, pps), dtype=torch.int32)
    used = 1
    for i, n in enumerate(lens):
        npg = (n + page - 1) // page
        pages[i, :npg] = torch.arange(used, used + npg, dtype=torch.int32)
        used += npg
    slots = torch.full((s,), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        if n > 0 and i not in frozen:
            slots[i] = int(pages[i, (n - 1) // page]) * page + (n - 1) % page
    return pages, slots, used


def _decode_case(torch, gen, dev, dtype, hq, hkv, d, page, lens, frozen):
    s = len(lens)
    pages, slots, used = _paged_rows(torch, lens, page, frozen)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return dict(
        q=rnd(s, hq, d), k=rnd(s, hkv, d), v=rnd(s, hkv, d),
        cache=rnd(used + 2, page, 2 * hkv, d),
        lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        pages=pages.to(dev), slots=slots.to(dev),
    )


def _prefill_case(torch, gen, dev, dtype, hq, hkv, d, page, q_lens, cached,
                  pps):
    s = len(q_lens)
    cu = [0]
    for q in q_lens:
        cu.append(cu[-1] + q)
    t_real = cu[-1]
    t = 1 << (t_real - 1).bit_length()          # token bucket (padding)
    pages = (torch.arange(s * pps, dtype=torch.int32).reshape(s, pps) + 1)
    slots = torch.full((t,), -1, dtype=torch.int32)
    for i in range(s):
        pos = torch.arange(cached[i], cached[i] + q_lens[i])
        slots[cu[i]:cu[i + 1]] = (
            pages[i, pos // page] * page + pos % page
        ).to(torch.int32)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return dict(
        q=rnd(t, hq, d), k=rnd(t, hkv, d), v=rnd(t, hkv, d),
        cache=rnd(s * pps + 1, page, 2 * hkv, d),
        kv_lens=torch.tensor([c + q for c, q in zip(cached, q_lens)],
                             dtype=torch.int32, device=dev),
        pages=pages.to(dev), cu=torch.tensor(cu, dtype=torch.int32,
                                             device=dev),
        nseq=torch.tensor([s], dtype=torch.int32, device=dev),
        slots=slots.to(dev), t_real=t_real, q_lens=q_lens, cached=cached,
    )


def _close(torch, got, ref, tol) -> float:
    atol, rtol = tol
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max abs err "
            f"{float(err.max())} beyond atol {atol} + rtol {rtol}·|ref|"
        )
    return float(err.max())


def check_decode(torch, gen, dev, dtype, hq, hkv, d, page, lens, frozen,
                 window=None, cap=None, sinks=None):
    from parallax_tpu_torch.ops.decode_fused import (
        gqa_fused_decode,
        gqa_fused_decode_plain,
    )

    c = _decode_case(torch, gen, dev, dtype, hq, hkv, d, page, lens, frozen)
    kw = dict(sm_scale=d ** -0.5, sliding_window=window, soft_cap=cap)
    cache_k, cache_p = c["cache"].clone(), c["cache"].clone()
    out_k, _ = gqa_fused_decode(c["q"], c["k"], c["v"], cache_k, c["lens"],
                                c["pages"], c["slots"], sinks, **kw)
    out_p, _ = gqa_fused_decode_plain(c["q"], c["k"], c["v"], cache_p,
                                      c["lens"], c["pages"], c["slots"],
                                      sinks, **kw)
    torch.cuda.synchronize()
    if not torch.equal(cache_k, cache_p):
        raise AssertionError("gqa_decode: cache after the append differs")
    zero_rows = [i for i, n in enumerate(lens) if n == 0]
    if zero_rows and bool(out_k[zero_rows].any()):
        raise AssertionError("gqa_decode: kv_len 0 rows are not zero")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    return _close(torch, out_k, out_p, tol), c, kw


def check_prefill(torch, gen, dev, dtype, hq, hkv, d, page, q_lens, cached,
                  pps, window=None, cap=None, sinks=None):
    from parallax_tpu_torch.ops.prefill_fused import (
        gqa_fused_prefill,
        gqa_fused_prefill_plain,
    )

    c = _prefill_case(torch, gen, dev, dtype, hq, hkv, d, page, q_lens,
                      cached, pps)
    kw = dict(sm_scale=d ** -0.5, sliding_window=window, soft_cap=cap)
    cache_k, cache_p = c["cache"].clone(), c["cache"].clone()
    args = (c["kv_lens"], c["pages"], c["cu"], c["nseq"], c["slots"], sinks)
    out_k, _ = gqa_fused_prefill(c["q"], c["k"], c["v"], cache_k, *args, **kw)
    out_p, _ = gqa_fused_prefill_plain(c["q"], c["k"], c["v"], cache_p,
                                       *args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(cache_k, cache_p):
        raise AssertionError("kv_append/gqa_prefill: cache differs")
    if bool(out_k[c["t_real"]:].any()):
        raise AssertionError("gqa_prefill: padding tokens are not zero")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    cache_err = float((cache_k.float() - cache_p.float()).abs().max())
    return _close(torch, out_k, out_p, tol), cache_err, c, kw


def _sampler_batch(torch, gen, dev, v):
    from parallax_tpu_torch.ops.sampling import row_gumbel

    s = 8
    logits = torch.randn((s, v), generator=gen, device=dev) * 3.0
    # Forced ties: a duplicated maximum on a greedy row, and ties at and
    # around the k-th value of top-k rows.
    logits[1, 77] = logits[1].max() + 1.0
    logits[1, 90000] = logits[1, 77]
    for row, k in ((6, 5), (7, 64)):
        top = logits[row].max() + 2.0
        logits[row, 1000:1000 + k + 3] = top
    temp = torch.tensor([0.0, 0.0, 0.8, 1.0, 0.7, 1.3, 1.0, 0.5],
                        device=dev)
    top_k = torch.tensor([0, 0, 20, 64, 1, 0, 5, 64], dtype=torch.int32,
                         device=dev)
    gumbel = row_gumbel(s, v, base_seed=0, step=3,
                        seeds=[-1, -1, 11, -1, 5, -1, 9, 2],
                        out_steps=[0, 0, 4, 0, 1, 0, 7, 3], device=dev)
    return logits, gumbel, temp, top_k


def _sampler_wide_batch(torch, gen, dev, s, v):
    """``s`` rows over a ``v`` vocabulary for A3: greedy rows with their
    maximum in two chunks, and top-k rows (k 1, 2, 5, 20, 63, 64, 0, V)
    whose k-th value is tied over one of A3's chunk boundaries
    (sample_chunks)."""
    from parallax_tpu_torch.ops.sampling import row_gumbel, sample_chunks

    chunks, length = sample_chunks(s, v)
    logits = torch.randn((s, v), generator=gen, device=dev) * 3.0
    ks = [0, 1, 2, 5, 20, 63, 64, 0, v]
    top_k = torch.tensor([ks[i % len(ks)] for i in range(s)],
                         dtype=torch.int32, device=dev)
    temp = torch.tensor([0.0 if i % len(ks) == 0 else 0.5 + (i % 5) * 0.25
                         for i in range(s)], device=dev)
    for i in range(s):
        b = length * (1 + i % max(chunks - 1, 1))
        b = min(b, v - 1)
        top = float(logits[i].max())
        k = int(top_k[i])
        if float(temp[i]) == 0.0:
            logits[i, [b - 1, min(b + length, v - 1)]] = top + 1.0
        elif 0 < k < v:
            lo = max(b - k // 2, 0)
            logits[i, lo:lo + max(k - 2, 0)] = top + 3.0
            logits[i, lo + max(k - 2, 0):lo + k + 3] = top + 1.0
    gumbel = row_gumbel(s, v, base_seed=5, step=1, device=dev)
    return logits, gumbel, temp, top_k, chunks


def check_sampler_wide(torch, gen, dev, flush) -> dict:
    """A3 at 64 rows over DeepSeek-V3's and gpt-oss-20b's vocabularies:
    exactly the plain version's tokens, the same bits on two calls, timed
    beside the plain version and the bound."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.sampling import (
        fused_sample_topk,
        fused_sample_topk_plain,
    )

    line = {"phase": "kernels", "check": "sampler_wide", "rows": 64}
    for label, model in (("deepseek_v3", DSV3_MODEL),
                         ("gpt_oss", GPTOSS_MODEL)):
        v = get_preset(model).vocab_size
        logits, gumbel, temp, top_k, chunks = _sampler_wide_batch(
            torch, gen, dev, 64, v)
        args = (logits, gumbel, temp, top_k)
        tok_k = fused_sample_topk(*args)
        tok_2 = fused_sample_topk(*args)
        tok_p = fused_sample_topk_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(tok_k, tok_p):
            bad = (tok_k != tok_p).nonzero().flatten().tolist()
            raise AssertionError(f"sample_topk {label}: rows {bad} differ "
                                 "from the plain version")
        if not torch.equal(tok_k, tok_2):
            raise AssertionError(f"sample_topk {label}: two calls differ")
        b_ms, b_by = bound(2 * 64 * v * 4 + 64 * 12, 3 * 64 * v, "float32")
        line[label] = {
            "vocab": v, "chunks": chunks, "exact": True,
            "two_calls_bitwise_equal": True,
            "ms": time_ms(torch, lambda: fused_sample_topk(*args), 30, flush),
            "device_only_ms": time_ms(torch, lambda: fused_sample_topk(*args),
                                      30, flush, hide_host=True),
            "plain_ms": time_ms(torch, lambda: fused_sample_topk_plain(*args),
                                5, flush),
            "bound_ms": b_ms, "bound_by": b_by}
    return line


def check_sampler_masked(torch, gen, dev, flush) -> dict:
    """A3 on grammar-masked rows of Qwen2.5's vocabulary: 1, 3 or 258
    allowed tokens (the byte grammar's width), every other logit at -1e10
    (``ops/sampling.NEG_INF``, as the grammar mask leaves them), top-k 1,
    40 and 64, temperature 0 and 0.8: 18 rows, each once in a batch of 8
    (the serve shape) and all in one batch of 18. Fewer allowed tokens than
    top-k ties the k-th value across the masked tail; A3 must pick exactly
    the plain version's tokens, the same bits on two calls."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.sampling import (
        NEG_INF,
        fused_sample_topk,
        fused_sample_topk_plain,
        row_gumbel,
    )

    v = get_preset(DENSE_MODEL).vocab_size
    cases = [(n, k, t) for n in (1, 3, 258) for k in (1, 40, 64)
             for t in (0.0, 0.8)]
    s = len(cases)
    logits = torch.full((s, v), NEG_INF, device=dev)
    for row, (n, _, _) in enumerate(cases):
        # The allowed ids: the first n byte ids, or n spread over the vocab.
        ids = (torch.arange(n, device=dev) if n == 258 else
               torch.randint(0, v, (n,), generator=gen, device=dev))
        logits[row, ids] = torch.randn((n,), generator=gen, device=dev) * 3
    temp = torch.tensor([t for *_, t in cases], device=dev)
    top_k = torch.tensor([k for _, k, _ in cases], dtype=torch.int32,
                         device=dev)
    gumbel = row_gumbel(s, v, base_seed=0, step=5,
                        seeds=list(range(s)), out_steps=[3] * s, device=dev)
    checked = 0
    for rows in [list(range(a, min(a + 8, s))) for a in range(0, s, 8)] + [
            list(range(s))]:
        args = (logits[rows], gumbel[rows], temp[rows], top_k[rows])
        tok_k = fused_sample_topk(*args)
        tok_2 = fused_sample_topk(*args)
        tok_p = fused_sample_topk_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(tok_k, tok_p):
            bad = [cases[rows[i]] for i in
                   (tok_k != tok_p).nonzero().flatten().tolist()]
            raise AssertionError(f"sample_topk masked rows {bad} differ "
                                 "from the plain version")
        if not torch.equal(tok_k, tok_2):
            raise AssertionError("sample_topk masked: two calls differ")
        if not bool((logits[rows].gather(
                1, tok_k.long()[:, None]) > NEG_INF).all()):
            raise AssertionError("sample_topk masked: a masked token won")
        checked += len(rows)
    args = (logits[:8], gumbel[:8], temp[:8], top_k[:8])
    b_ms, b_by = bound(2 * 8 * v * 4 + 8 * 12, 3 * 8 * v, "float32")
    return {"phase": "kernels", "check": "sampler_masked", "vocab": v,
            "cases": s, "rows_checked": checked, "exact": True,
            "two_calls_bitwise_equal": True,
            "ms_8_rows": time_ms(torch, lambda: fused_sample_topk(*args),
                                 30, flush),
            "device_only_ms_8_rows": time_ms(
                torch, lambda: fused_sample_topk(*args), 30, flush,
                hide_host=True),
            "plain_ms_8_rows": time_ms(
                torch, lambda: fused_sample_topk_plain(*args), 5, flush),
            "bound_ms": b_ms, "bound_by": b_by}


def check_kv_append_edges(torch, gen, dev) -> dict:
    """A0 against reshape_and_cache, bitwise: one token, token counts that
    are not a multiple of the kernel's 8 tokens a block, negative and
    out-of-range slots, a float32 cache, and the head geometries of the
    registered GQA models (D 64 and 128)."""
    from parallax_tpu_torch.ops.kv_cache_ops import kv_append, reshape_and_cache

    cases = {}
    for name, dtype, hkv, d, t in (
        ("t1_bf16", torch.bfloat16, 4, 128, 1),
        ("t13_bf16", torch.bfloat16, 4, 128, 13),
        ("t21_f32_d64", torch.float32, 2, 64, 21),
        ("t749_bf16_hkv8_d64", torch.bfloat16, 8, 64, 749),
        ("t100_f32_d128", torch.float32, 4, 128, 100),
    ):
        p, page = (t + 63) // 64 + 2, 64
        cache = torch.randn((p, page, 2 * hkv, d), generator=gen,
                            device=dev).to(dtype)
        k = torch.randn((t, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((t, hkv, d), generator=gen, device=dev).to(dtype)
        slots = torch.randperm(p * page, generator=gen, device=dev)[:t]
        slots = slots.to(torch.int32)
        if t > 2:
            slots[1] = -1               # padding
            slots[-1] = p * page + 5    # out of range: dropped
        got, ref = cache.clone(), cache.clone()
        kv_append(got, k, v, slots)
        reshape_and_cache(ref, k, v, slots)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"kv_append {name}: cache differs from "
                                 "reshape_and_cache")
        cases[name] = "bitwise"
    return cases


def kv_append_host_us(torch, cache, k, v, slots, calls: int = 300) -> dict:
    """Host microseconds per A0 wrapper call, by part, over ``calls``
    calls each (time.perf_counter; the launches queue behind each other)."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.kv_cache_ops import (
        check_kv_append_args,
        kv_append,
    )

    lib = ck.lib()
    t, hkv, d = check_kv_append_args(cache, k, v, slots)
    total = cache.shape[0] * cache.shape[1]
    code = ck.dtype_code(cache)

    def launch():
        ck.check(lib.pk_kv_append(k.data_ptr(), v.data_ptr(),
                                  cache.data_ptr(), slots.data_ptr(), t, hkv,
                                  d, total, code, ck.stream_of(cache)),
                 "kv_append")

    parts = {
        "arg_checks": lambda: check_kv_append_args(cache, k, v, slots),
        "require_cuda": lambda: ck.require_cuda("kv_append", cache, k, v,
                                                slots),
        "lib_lookup": ck.lib,
        "stream_of": lambda: ck.stream_of(cache),
        "data_ptrs": lambda: (k.data_ptr(), v.data_ptr(), cache.data_ptr(),
                              slots.data_ptr()),
        "ctypes_launch": launch,
        "whole_wrapper": lambda: kv_append(cache, k, v, slots),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return out


def phase_kernels(torch, dev) -> list[dict]:
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.decode_fused import (
        gqa_fused_decode,
        gqa_fused_decode_plain,
    )
    from parallax_tpu_torch.ops.kv_cache_ops import kv_append, reshape_and_cache
    from parallax_tpu_torch.ops.prefill_fused import (
        gqa_prefill_attend,
        gqa_prefill_attend_plain,
    )
    from parallax_tpu_torch.ops.sampling import (
        fused_sample_topk,
        fused_sample_topk_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    bf16 = torch.bfloat16
    hq, hkv, d, page = 28, 4, 128, 64
    # Decode: S = 8 ragged rows with a page-exact row (320), a kv_len 0
    # padding row and a frozen slot -1 row (450).
    dec_lens = [700, 320, 0, 450, 129, 33, 511, 256]
    err_dec, dc, dkw = check_decode(torch, gen, dev, bf16, hq, hkv, d, page,
                                    dec_lens, frozen={3})
    # Prefill: a ragged chunked batch over cached prefixes, padded from 749
    # to a 1024-token bucket.
    pre_q, pre_cached = [256, 256, 200, 37], [0, 256, 192, 100]
    err_pre, err_app, pc, pkw = check_prefill(torch, gen, dev, bf16, hq, hkv,
                                              d, page, pre_q, pre_cached,
                                              pps=16)
    # Sinks + sliding window + soft cap, float32, G = 3.
    sinks = torch.randn((6,), generator=gen, device=dev)
    err_dec_s, *_ = check_decode(torch, gen, dev, torch.float32, 6, 2, 64, 16,
                                 [5, 17, 48, 0, 9, 16], frozen={4}, window=16,
                                 cap=30.0, sinks=sinks)
    err_pre_s, err_app_s, *_ = check_prefill(torch, gen, dev, torch.float32,
                                             6, 2, 64, 16, [17, 8, 33],
                                             [3, 16, 5], pps=12, window=11,
                                             cap=30.0, sinks=sinks)
    # Other head geometries the kernels take: G = 4 (Llama-3-8B), G = 1
    # with D = 64, and G = 20 (the decode kernel's 64-row variant).
    others = {}
    for name, dt, ghq, ghkv, gd, gpage in (
        ("g4_d128_bf16", bf16, 32, 8, 128, 64),
        ("g1_d64_bf16", bf16, 16, 16, 64, 32),
        ("g20_d128_f32", torch.float32, 40, 2, 128, 16),
    ):
        e_d, *_ = check_decode(torch, gen, dev, dt, ghq, ghkv, gd, gpage,
                               [300, 64, 0, 77], frozen={1})
        e_p, *_ = check_prefill(torch, gen, dev, dt, ghq, ghkv, gd, gpage,
                                [70, 1, 33], [0, 64, 9],
                                pps=(140 + gpage - 1) // gpage)
        others[name] = {"decode": e_d, "prefill": e_p}
    emit({"phase": "kernels", "check": "attention",
          "decode_bf16_max_abs_err": err_dec,
          "prefill_bf16_max_abs_err": err_pre,
          "decode_f32_sinks_window_softcap_max_abs_err": err_dec_s,
          "prefill_f32_sinks_window_softcap_max_abs_err": err_pre_s,
          "bf16_tol_atol_rtol": BF16_TOL, "f32_tol_atol_rtol": F32_TOL,
          "other_geometries_max_abs_err": others,
          "cache_bitwise_equal": True,
          "append_max_abs_err": max(err_app, err_app_s)})

    from parallax_tpu_torch.models.presets import get_preset

    v = get_preset(DENSE_MODEL).vocab_size
    logits, gumbel, temp, top_k = _sampler_batch(torch, gen, dev, v)
    tok_k = fused_sample_topk(logits, gumbel, temp, top_k)
    tok_2 = fused_sample_topk(logits, gumbel, temp, top_k)
    tok_p = fused_sample_topk_plain(logits, gumbel, temp, top_k)
    err_tok = float((tok_k - tok_p).abs().max())
    if not torch.equal(tok_k, tok_p):
        raise AssertionError(
            f"sample_topk: {tok_k.tolist()} != plain {tok_p.tolist()}"
        )
    if not torch.equal(tok_k, tok_2):
        raise AssertionError("sample_topk: two calls differ")
    if int(tok_k[1]) != 77:
        raise AssertionError("sample_topk: greedy tie must take index 77")
    emit({"phase": "kernels", "check": "sampler", "tokens": tok_k.tolist(),
          "exact": True, "two_calls_bitwise_equal": True})

    # -- timing at the main path's shapes --------------------------------
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device=dev)
    out = []
    esz = 2
    # A0: the prefill batch's append.
    t_real = pc["t_real"]
    n_app = t_real
    cache = pc["cache"].clone()
    ms = time_ms(torch, lambda: kv_append(cache, pc["k"], pc["v"],
                                          pc["slots"]), 50, flush)
    plain = time_ms(torch, lambda: reshape_and_cache(cache, pc["k"], pc["v"],
                                                     pc["slots"]), 20, flush)
    flat = cache.view(-1, 2 * hkv, d)
    from parallax_tpu_torch.ops.kv_cache_ops import interleave_kv

    rows = interleave_kv(pc["k"], pc["v"])[:t_real].contiguous()
    idx = pc["slots"][:t_real].long()
    lib = time_ms(torch, lambda: flat.index_copy_(0, idx, rows), 50, flush)
    device_only = {
        "kv_append": time_ms(torch, lambda: kv_append(
            cache, pc["k"], pc["v"], pc["slots"]), 50, flush, hide_host=True),
        "kv_append_library": time_ms(
            torch, lambda: flat.index_copy_(0, idx, rows), 50, flush,
            hide_host=True),
    }
    emit({"phase": "kernels", "check": "kv_append",
          "edge_cases": check_kv_append_edges(torch, gen, dev),
          "wrapper_host_us": kv_append_host_us(torch, cache, pc["k"],
                                               pc["v"], pc["slots"]),
          "tokens": t_real})
    b_ms, b_by = bound(2 * n_app * 2 * hkv * d * esz, 0, "bfloat16")
    out.append(dict(
        name="kv_append", route="cuda",
        source="parallax_tpu_torch/csrc/kv_append.cu",
        replaces="parallax_tpu/ops/prefill_fused_pallas.py:142",
        max_abs_err=err_app, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib,
    ))

    # A1: attend-only prefill over the same batch (its append done above).
    args = (pc["q"], cache, pc["kv_lens"], pc["pages"], pc["cu"],
            pc["nseq"], None)
    ms = time_ms(torch, lambda: gqa_prefill_attend(*args, **pkw), 30, flush)
    plain = time_ms(torch, lambda: gqa_prefill_attend_plain(*args, **pkw),
                    10, flush)
    ctx_tokens = sum(c + q for c, q in zip(pre_q, pre_cached))
    causal_pairs = sum(sum(c + j + 1 for j in range(q))
                       for c, q in zip(pre_cached, pre_q))
    b_ms, b_by = bound(
        2 * t_real * hq * d * esz + ctx_tokens * 2 * hkv * d * esz,
        4 * hq * d * causal_pairs, "bfloat16",
    )
    sdpa_pre = _sdpa_prefill(torch, dict(pc, cache=cache), hq, hkv, d, page)
    lib = time_ms(torch, sdpa_pre, 30, flush)
    device_only["gqa_prefill"] = time_ms(
        torch, lambda: gqa_prefill_attend(*args, **pkw), 30, flush,
        hide_host=True)
    device_only["gqa_prefill_library"] = time_ms(torch, sdpa_pre, 30, flush,
                                                 hide_host=True)
    out.append(dict(
        name="gqa_prefill", route="cuda",
        source="parallax_tpu_torch/csrc/gqa_prefill.cu",
        replaces="parallax_tpu/ops/prefill_fused_pallas.py:70",
        max_abs_err=err_pre, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
    ))

    # A2: fused decode over the S = 8 rows.
    cache_k = dc["cache"].clone()
    dargs = (dc["q"], dc["k"], dc["v"], cache_k, dc["lens"], dc["pages"],
             dc["slots"], None)
    ms = time_ms(torch, lambda: gqa_fused_decode(*dargs, **dkw), 50, flush)
    plain = time_ms(torch, lambda: gqa_fused_decode_plain(*dargs, **dkw), 20,
                    flush)
    ctx = sum(dec_lens)
    b_ms, b_by = bound(
        2 * len(dec_lens) * hq * d * esz
        + 2 * len(dec_lens) * 2 * hkv * d * esz + ctx * 2 * hkv * d * esz,
        4 * hq * d * ctx, "bfloat16",
    )
    sdpa_dec = _sdpa_decode(torch, dict(dc, cache=cache_k), hq, hkv, d, page)
    lib = time_ms(torch, sdpa_dec, 50, flush)
    device_only["gqa_decode"] = time_ms(
        torch, lambda: gqa_fused_decode(*dargs, **dkw), 50, flush,
        hide_host=True)
    device_only["gqa_decode_library"] = time_ms(torch, sdpa_dec, 50, flush,
                                                hide_host=True)
    out.append(dict(
        name="gqa_decode", route="cuda",
        source="parallax_tpu_torch/csrc/gqa_decode.cu",
        replaces="parallax_tpu/ops/decode_fused_pallas.py:314",
        max_abs_err=err_dec, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib,
    ))

    # A3: the sampler over the 8-row batch.
    ms = time_ms(torch, lambda: fused_sample_topk(logits, gumbel, temp,
                                                  top_k), 30, flush)
    plain = time_ms(torch, lambda: fused_sample_topk_plain(
        logits, gumbel, temp, top_k), 10, flush)
    device_only["sample_topk"] = time_ms(
        torch, lambda: fused_sample_topk(logits, gumbel, temp, top_k), 30,
        flush, hide_host=True)
    # A diagnosis, as for A4: the same after a reading L2 flush, which
    # leaves no dirty lines for the timed call to write back.
    device_only["sample_topk_clean_l2"] = time_ms(
        torch, lambda: fused_sample_topk(logits, gumbel, temp, top_k), 30,
        flush, hide_host=True, clean=True)
    s = logits.shape[0]
    b_ms, b_by = bound(2 * s * v * 4 + s * 12, 3 * s * v, "float32")
    out.append(dict(
        name="sample_topk", route="cuda",
        source="parallax_tpu_torch/csrc/sample_topk.cu",
        replaces="parallax_tpu/ops/decode_fused_pallas.py:604",
        max_abs_err=err_tok, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    ))
    emit(check_sampler_wide(torch, gen, dev, flush))
    emit(check_sampler_masked(torch, gen, dev, flush))
    out.append(kernels_gumbel(torch, dev, flush, device_only, v))
    out.append(kernels_grouped_gemm(torch, gen, dev, flush, device_only))
    kernels_grouped_gemm(torch, gen, dev, flush, device_only,
                         model=DSV3_MODEL, label="grouped_gemm_deepseek")
    out.extend(kernels_deepseek(torch, gen, dev, flush, device_only))
    split_out, split_device_only = kernels_split(torch, gen, dev, flush)
    out.extend(split_out)
    d256_out, d256_device_only = kernels_d256(torch, gen, dev, flush)
    out.extend(d256_out)
    kernels_grouped_gemm(torch, gen, dev, flush, device_only,
                         model=NEXT_MODEL, label="grouped_gemm_next")
    out.append(kernels_quant_linear(torch, gen, dev, flush, device_only))
    out.append(kernels_grouped_gemm_q(torch, gen, dev, flush, device_only))
    emit({"phase": "kernels", "check": "device_only_ms",
          "note": "time_ms(hide_host=True): the call's device time, a spin "
                  "kernel covering the host's enqueue",
          **device_only, **split_device_only, **d256_device_only})
    emit(attention_breakdown(torch, gen, dev, flush))
    del flush
    assert set(k["name"] for k in out) == set(KERNEL_PATH) >= set(ck.KERNELS)
    emit({"phase": "kernels", "timed": [
        {k: e[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                           "library_ms")} for e in out]})
    return out


def _ulps(torch, got, ref):
    """Largest distance of ``got`` from ``ref`` in units of ``ref``'s last
    place (float32)."""
    ulp = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))) \
        - ref.abs()
    return float(((got - ref).abs() / ulp).max())


def kernels_gumbel(torch, dev, flush, device_only, v) -> dict:
    """The noise kernel against its twin: the dense serve's 8 sampled-batch
    rows (seeded ones at their output steps, unseeded ones at an engine
    step and in the window's step range) over Qwen2.5's vocabulary, plus a
    vocabulary that is not a multiple of 4 (the scalar tail). The random
    words must be equal, the noise within 1 ulp, two calls bitwise equal.
    Times it at 8 and 64 rows beside the yardstick ``torch.rand`` plus the
    log-log transform (a different generator: timed only)."""
    from parallax_tpu_torch.ops.sampling import (
        gumbel_bits_plain,
        gumbel_from_bits,
        gumbel_rows,
        gumbel_rows_plain,
    )

    i64 = dict(dtype=torch.int64, device=dev)
    seeds = torch.tensor([-1, -1, 11, -1, 5, -1, 9, 2], **i64)
    steps = torch.tensor([3, 3, 4, (1 << 40) + (7 << 20) + 5, 1, 3, 7, 31],
                         **i64)
    worst, err = 0.0, 0.0
    for vv in (v, 1001):
        bits = torch.empty((8, vv), dtype=torch.int32, device=dev)
        g = gumbel_rows(seeds, steps, 0, vv, bits=bits)
        g2 = gumbel_rows(seeds, steps, 0, vv)
        torch.cuda.synchronize()
        ref_bits = gumbel_bits_plain(seeds, steps, 0, vv)
        if not torch.equal(bits.long() & 0xFFFFFFFF, ref_bits):
            raise AssertionError(f"gumbel_rows: random words differ (V {vv})")
        ref = gumbel_from_bits(ref_bits)
        worst = max(worst, _ulps(torch, g, ref))
        err = max(err, float((g - ref).abs().max()))
        if worst > 1.0:
            raise AssertionError(f"gumbel_rows: noise {worst} ulps from the "
                                 f"twin (V {vv})")
        if not torch.equal(g, g2):
            raise AssertionError("gumbel_rows: two calls differ")
    emit({"phase": "kernels", "check": "gumbel_rows", "vocabs": [v, 1001],
          "words_equal": True, "noise_max_ulps": worst, "max_abs_err": err,
          "two_calls_bitwise_equal": True})
    ms = time_ms(torch, lambda: gumbel_rows(seeds, steps, 0, v), 50, flush)
    plain = time_ms(torch, lambda: gumbel_rows_plain(seeds, steps, 0, v), 10,
                    flush)
    for rows in (8, 64):
        sd, st = seeds.repeat(rows // 8), steps.repeat(rows // 8)
        device_only[f"gumbel_rows_s{rows}"] = time_ms(
            torch, lambda: gumbel_rows(sd, st, 0, v), 50, flush,
            hide_host=True)
        device_only[f"gumbel_rows_s{rows}_bound"] = bound(rows * v * 4 + 16
                                                          * rows, 0,
                                                          "float32")[0]
        device_only[f"gumbel_rows_s{rows}_yardstick_rand_loglog"] = time_ms(
            torch, lambda: torch.rand((rows, v), device=dev).log_().neg_()
            .log_().neg_(), 50, flush, hide_host=True)
    b_ms, b_by = bound(8 * v * 4 + 16 * 8, 0, "float32")
    return dict(
        name="gumbel_rows", route="cuda",
        source="parallax_tpu_torch/csrc/gumbel.cu",
        replaces="parallax_tpu/ops/sampling.py:34",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    )


def _skewed_offsets(m: int, e: int, seed: int) -> list[int]:
    """Group offsets of ``m`` rows over ``e`` experts with a skewed
    (Zipf-like) spread that also holds empty and 1-row groups."""
    rng = random.Random(seed)
    empty, ones = {5, 17, 64, 99}, {3, 40, 77, 120}
    free = [g for g in range(e) if g not in empty | ones]
    w = [1.0 / (i + 1) ** 0.8 for i in range(len(free))]
    rng.shuffle(w)
    rest = m - len(ones)
    alloc = [int(rest * x / sum(w)) for x in w]
    alloc[0] += rest - sum(alloc)
    sizes = [0] * e
    for g in ones:
        sizes[g] = 1
    for g, a in zip(free, alloc):
        sizes[g] = a
    return [0] + [sum(sizes[:g + 1]) for g in range(e)]


def _decode_offsets(tokens: int, k: int, e: int, seed: int) -> list[int]:
    """Offsets of a decode step: ``tokens`` rows each routed to ``k``
    distinct experts drawn with a skew, so most groups hold 0 or 1 rows."""
    rng = random.Random(seed)
    w = [1.0 / (g + 1) ** 0.5 for g in range(e)]
    sizes = [0] * e
    for _ in range(tokens):
        for g in _weighted_distinct(rng, w, k):
            sizes[g] += 1
    return [0] + [sum(sizes[:g + 1]) for g in range(e)]


def _weighted_distinct(rng, w, k):
    picked: list[int] = []
    while len(picked) < k:
        g = rng.choices(range(len(w)), weights=w)[0]
        if g not in picked:
            picked.append(g)
    return picked


def _grouped_mm_library(torch, lhs, rhs, offsets):
    """``torch._grouped_mm`` on the same operands, timed only and never
    used by the port; None where this PyTorch has none. Its output is
    bf16: PyTorch 2.11 refuses an f32 one."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    mat_b, offs = rhs.transpose(1, 2), offsets[1:]
    return lambda: torch._grouped_mm(lhs, mat_b, offs=offs,
                                     out_dtype=torch.bfloat16)


def kernels_grouped_gemm(torch, gen, dev, flush, device_only,
                         model=MOE_MODEL, label="grouped_gemm") -> dict:
    """A4 against its plain version at the shapes ``model``'s MoE layers
    give it, then timed; each shape's device-only time and
    ``torch._grouped_mm``'s go into ``device_only`` as
    ``grouped_gemm_<model>_<shape>_<proj>[_library]``. Each shape runs both
    variants, forced, and the one M picks: each within F32_TOL of the plain
    version (both sum exact bf16 products in f32, in another order), the
    same bits on two calls, and the picked one's bits equal to its forced
    run's. Whether the bits also equal the plain version's is reported."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.grouped_matmul import (
        grouped_matmul,
        grouped_matmul_plain,
        variant_for,
    )

    bf16 = torch.bfloat16
    cfg = get_preset(model)
    e, hid = cfg.moe.num_experts, cfg.hidden_size
    inter, k_top = cfg.moe.moe_intermediate_size, cfg.moe.num_experts_per_tok

    def operands(offs, n, k):
        m = offs[-1]
        lhs = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        # One expert at a time: DeepSeek's [256, 2048, 7168] drawn whole
        # would be a 15 GB float32 transient.
        rhs = torch.empty((len(offs) - 1, n, k), dtype=bf16, device=dev)
        for g in range(len(offs) - 1):
            rhs[g] = (torch.randn((n, k), generator=gen, device=dev)
                      * k ** -0.5).to(bf16)
        return lhs, rhs, torch.tensor(offs, dtype=torch.int32, device=dev)

    bitwise = {}

    def check(name, offs, n, k):
        lhs, rhs, offsets = operands(offs, n, k)
        ref = grouped_matmul_plain(lhs, rhs, offsets)
        got = {}
        for v in ("prefill", "decode"):
            got[v] = grouped_matmul(lhs, rhs, offsets, _variant=v)
            again = grouped_matmul(lhs, rhs, offsets, _variant=v)
            torch.cuda.synchronize()
            if not torch.equal(got[v], again):
                raise AssertionError(f"{label} {name} {v}: two calls differ")
            errs[f"{name}_{v}"] = _close(torch, got[v], ref, F32_TOL)
            bitwise[f"{name}_{v}"] = bool(torch.equal(got[v], ref))
        picked = grouped_matmul(lhs, rhs, offsets)
        torch.cuda.synchronize()
        if not torch.equal(picked, got[variant_for(offs[-1])]):
            raise AssertionError(f"{label} {name}: the picked variant's bits "
                                 "differ from its forced run's")
        del got, picked, ref
        return lhs, rhs, offsets

    shapes = {
        "prefill": _skewed_offsets(2048 * k_top, e, seed=7),
        "decode": _decode_offsets(7, k_top, e, seed=8),
    }
    errs, timed = {}, {}
    tag = {MOE_MODEL: "qwen3", DSV3_MODEL: "deepseek",
           NEXT_MODEL: "next"}[model]
    if model == MOE_MODEL:
        # Tails: N and K below and between tiles (K not a multiple of the
        # 64-wide stage), empty and 1-row groups, M < E, E = 1 with every
        # row in one group (above and below the variant threshold), and a
        # 20-row group at decode M (more rows than one decode tile).
        one_20 = [0] * 4 + [20] + [1] * 36 + [0] * (e - 41)
        for name, offs, n, k in (
            ("tails_n37_k40", [0, 0, 1, 21, 37, 37], 37, 40),
            ("tails_n200_k72", [0, 1, 1, 21, 24, 160, 160, 300], 200, 72),
            ("m5_lt_e", [0] + [min(g, 5) for g in range(1, e + 1)], inter,
             hid),
            ("e1_m600", [0, 600], 200, 72),
            ("e1_m40", [0, 40], 37, 40),
            ("group_of_20_at_decode_m", [0] + [sum(one_20[:g + 1])
                                               for g in range(e)], inter,
             hid),
        ):
            check(name, offs, n, k)
    for shape, offs in shapes.items():
        m = offs[-1]
        touched = sum(1 for g in range(e) if offs[g + 1] > offs[g])
        for proj, n, k in (("gate_up", inter, hid), ("down", hid, inter)):
            lhs, rhs, offsets = check(f"{shape}_{proj}", offs, n, k)
            ms = time_ms(torch, lambda: grouped_matmul(lhs, rhs, offsets),
                         30, flush)
            plain = time_ms(torch, lambda: grouped_matmul_plain(
                lhs, rhs, offsets), 5, flush)
            lib_fn = _grouped_mm_library(torch, lhs, rhs, offsets)
            lib = time_ms(torch, lib_fn, 30, flush) if lib_fn else None
            key = f"grouped_gemm_{tag}_{shape}_{proj}"
            device_only[key] = time_ms(
                torch, lambda: grouped_matmul(lhs, rhs, offsets), 30, flush,
                hide_host=True)
            device_only[key + "_library"] = time_ms(
                torch, lib_fn, 30, flush, hide_host=True) if lib_fn else None
            if shape == "decode":
                # The write-back of the zeroing flush is a sizeable share
                # of a decode call's bytes: the same times after a clean
                # flush.
                device_only[key + "_clean_l2"] = time_ms(
                    torch, lambda: grouped_matmul(lhs, rhs, offsets), 30,
                    flush, hide_host=True, clean=True)
                device_only[key + "_library_clean_l2"] = time_ms(
                    torch, lib_fn, 30, flush, hide_host=True,
                    clean=True) if lib_fn else None
            b_ms, b_by = bound(touched * n * k * 2 + m * k * 2 + m * n * 4,
                               2 * m * n * k, "bfloat16")
            timed[f"{shape}_{proj}"] = dict(
                m=m, n=n, k=k, groups_touched=touched, ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            del lhs, rhs, offsets
    # Where the variants cross: both, forced, device-only at decode steps
    # of 7-256 rows (M = top_k x rows; the engine's default max_batch_size
    # is 64). kDecodeMaxRows is set from these readings.
    crossover = {}
    for rows in (7, 16, 32, 64, 128, 256):
        offs = _decode_offsets(rows, k_top, e, seed=9 + rows)
        for proj, n, k in (("gate_up", inter, hid), ("down", hid, inter)):
            lhs, rhs, offsets = check(f"rows{rows}_{proj}", offs, n, k)
            crossover[f"m{offs[-1]}_{proj}"] = {
                v: time_ms(torch, lambda v=v: grouped_matmul(
                    lhs, rhs, offsets, _variant=v), 30, flush,
                    hide_host=True)
                for v in ("prefill", "decode")}
            del lhs, rhs, offsets
    emit({"phase": "kernels", "check": label, "model": model,
          "experts": e, "max_abs_err": errs, "f32_tol_atol_rtol": F32_TOL,
          "deterministic": True, "bitwise_equal_to_plain": bitwise,
          "variant_by_shape": {sh: variant_for(o[-1])
                               for sh, o in shapes.items()},
          "group_sizes_prefill": [b - a for a, b in zip(
              shapes["prefill"], shapes["prefill"][1:])],
          "decode_rows": shapes["decode"][-1], "timed": timed,
          "crossover_device_ms": crossover})
    main = timed["prefill_gate_up"]
    return dict(
        name="grouped_gemm", route="cuda",
        source="parallax_tpu_torch/csrc/grouped_gemm.cu",
        replaces="parallax_tpu/models/moe.py:121",
        max_abs_err=max(errs.values()), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
    )


# A10 / A11, the weight-only quantized products (port-only kernels: the
# JAX package leaves the dequantize-and-multiply to XLA's fusion).
QUANT_GROUP = 64                   # the loader's on-load group size
QUANT_M = {"decode": 7, "prefill": 749}
# A10 against its plain version: f32 outputs within this share of the
# plain output's largest magnitude (both sum the same bf16 products in
# f32, in another order); bf16 outputs within BF16_TOL.
QUANT_REL_TOL = 1e-4


def numpy_quantize(w, bits: int, g: int):
    """numpy's affine group quantization, written out here as the JAX
    package's ``ops/quant.py::quantize_array`` computes it (min, max, an
    f32 divide, round half to even): the reference that the port's
    on-device quantization must equal bit for bit."""
    import numpy as np

    w = np.asarray(w, np.float32)
    *lead, last = w.shape
    grp = w.reshape(*lead, last // g, g)
    lo = grp.min(axis=-1)
    hi = grp.max(axis=-1)
    qmax = (1 << bits) - 1
    scales = np.maximum((hi - lo) / qmax, np.float32(1e-8))
    q = np.clip(np.round((grp - lo[..., None]) / scales[..., None]), 0, qmax)
    return (q.astype(np.uint8).reshape(*lead, last),
            scales.astype(np.float32), lo.astype(np.float32))


def _rel_close(torch, got, ref, rel) -> tuple[float, float]:
    """Largest |got - ref|, and it over the largest |ref|; raises past
    ``rel``."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if err > rel * scale:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {err} beyond {rel} x {scale}")
    return err, err / scale


def quant_bound(m, n, k, g, out_bytes, touched=None):
    """The least time for a quantized product: its u8 weights, 2 + 2 bytes
    of scale and bias a group, the activations and the output moved once
    (``touched`` groups of a stack), or its bf16 products."""
    w = (touched or 1) * n * k
    return bound(w + 4 * w / g + 2 * m * k + out_bytes * m * n,
                 2 * m * n * k, "bfloat16")


# Where A10's and A11's variants cross: both forced, device-only, at the
# M of decode steps and small prefill chunks (A10: rows; A11: tokens, each
# routed to top-k experts). kDecodeMaxRows / kQDecodeMaxRows of
# csrc/quant_linear.cu are set from these readings.
QUANT_SWEEP_SHAPES = ("o_proj", "gate_up", "down")
QUANT_SWEEP_M = (8, 16, 24, 32, 48, 64, 128)
QUANT_SWEEP_TOKENS = (7, 16, 32, 64, 128, 256)


def _sweep_quant_linear(torch, gen, dev, flush, args, k) -> dict:
    """A10 with each variant forced at QUANT_SWEEP_M rows (bf16 out, the
    loader's group): device ms, each within QUANT_REL_TOL of the plain
    version."""
    from parallax_tpu_torch.ops import quant_linear as ql

    out = {}
    for m in QUANT_SWEEP_M:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        ref = ql.quant_linear_plain(x, *args, torch.float32)
        row = {}
        for v in ("decode", "prefill"):
            _rel_close(torch, ql.quant_linear(x, *args, torch.float32,
                                              _variant=v), ref,
                       QUANT_REL_TOL)
            row[v] = time_ms(torch, lambda v=v, x=x: ql.quant_linear(
                x, *args, _variant=v), 20, flush, hide_host=True)
        out[f"m{m}"] = row
        del x, ref
    return out


def kernels_quant_linear(torch, gen, dev, flush, device_only) -> dict:
    """A10 against its plain version at Qwen2.5-7B's shapes (q, k / v, o,
    gate / up, down, lm_head), M 7 (a decode step) and 749 (the prefill
    batch), bits 8 and 4, groups 32, 64 and 128: f32 outputs within
    QUANT_REL_TOL of the plain version's, bf16 ones within BF16_TOL, two
    calls the same bits, the other variant forced once a shape; the
    port's on-device quantization bitwise numpy's on two leaves. Then
    timed (int8 and int4 at the loader's group, device-only, L2 flushed)
    beside the bound and ``F.linear`` on the bf16 weight of the same
    shape (what the unquantized model pays)."""
    import numpy as np
    import torch.nn.functional as F

    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops import quant as tq
    from parallax_tpu_torch.ops import quant_linear as ql

    bf16 = torch.bfloat16
    cfg = get_preset(DENSE_MODEL)
    h, hd = cfg.hidden_size, cfg.head_dim
    shapes = {"q_proj": (cfg.num_attention_heads * hd, h),
              "kv_proj": (cfg.num_key_value_heads * hd, h),
              "o_proj": (h, cfg.num_attention_heads * hd),
              "gate_up": (cfg.intermediate_size, h),
              "down": (h, cfg.intermediate_size),
              "lm_head": (cfg.vocab_size, h)}
    errs, rel_errs, timed, bitwise_numpy, crossover = {}, {}, {}, {}, {}
    xs = {name: {mode: torch.randn((m, k), generator=gen, device=dev).to(
        bf16) for mode, m in QUANT_M.items()}
        for name, (_, k) in shapes.items()}
    for name, (n, k) in shapes.items():
        w = torch.randn((n, k), generator=gen, device=dev) * k ** -0.5
        if name in ("o_proj", "down"):
            for bits in (8, 4):
                q, s, b = tq.quantize_array(w, bits, QUANT_GROUP)
                rq, rs, rb = numpy_quantize(w.cpu().numpy(), bits,
                                            QUANT_GROUP)
                if not (np.array_equal(q.cpu().numpy(), rq)
                        and np.array_equal(s.cpu().numpy(), rs)
                        and np.array_equal(b.cpu().numpy(), rb)):
                    raise AssertionError(f"quantize_array on the card is "
                                         f"not numpy's ({name}, {bits})")
                bitwise_numpy[f"{name}_int{bits}"] = True
                del q, s, b
        out_dtype = torch.float32 if name == "lm_head" else bf16
        for bits in (8, 4):
            for g in ql.GROUP_SIZES:
                p = tq.quantize_param_dict(w, bits, g, bf16)
                args = (p["qweight"], p["scales"], p["biases"])
                for mode, x in xs[name].items():
                    key = f"{name}_{mode}_int{bits}_g{g}"
                    ref = ql.quant_linear_plain(x, *args, torch.float32)
                    got = ql.quant_linear(x, *args, torch.float32)
                    again = ql.quant_linear(x, *args, torch.float32)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"quant_linear {key}: two "
                                             "calls differ")
                    errs[key], rel_errs[key] = _rel_close(
                        torch, got, ref, QUANT_REL_TOL)
                    _close(torch, ql.quant_linear(x, *args, bf16),
                           ql.quant_linear_plain(x, *args, bf16), BF16_TOL)
                    if bits == 8 and g == QUANT_GROUP:
                        other = ("prefill" if ql.variant_for(x.shape[0])
                                 == "decode" else "decode")
                        errs[key + "_" + other], rel_errs[
                            key + "_" + other] = _rel_close(
                            torch, ql.quant_linear(x, *args, torch.float32,
                                                   _variant=other),
                            ref, QUANT_REL_TOL)
                    del ref, got, again
                if g != QUANT_GROUP:
                    del p, args
                    continue
                w_bf = w.to(bf16)
                for mode, x in xs[name].items():
                    m = x.shape[0]
                    key = f"{name}_{mode}_int{bits}"

                    def call(x=x):
                        return ql.quant_linear(x, *args, out_dtype)

                    b_ms, b_by = quant_bound(m, n, k, g,
                                             2 if out_dtype == bf16 else 4)
                    timed[key] = dict(
                        m=m, n=n, k=k, variant=ql.variant_for(m),
                        ms=time_ms(torch, call, 20, flush),
                        device_ms=time_ms(torch, call, 20, flush,
                                          hide_host=True),
                        plain_ms=time_ms(torch, lambda x=x: (
                            ql.quant_linear_plain(x, *args, out_dtype)), 5,
                            flush),
                        f_linear_bf16_device_ms=time_ms(
                            torch, lambda x=x: F.linear(x, w_bf), 20, flush,
                            hide_host=True),
                        bound_ms=b_ms, bound_by=b_by)
                    device_only[f"quant_linear_{key}"] = timed[key][
                        "device_ms"]
                if bits == 8 and name in QUANT_SWEEP_SHAPES:
                    crossover[name] = _sweep_quant_linear(
                        torch, gen, dev, flush, args, k)
                del p, args, w_bf
        del w
    emit({"phase": "kernels", "check": "quant_linear", "model": DENSE_MODEL,
          "abs_err_f32_out": errs, "rel_err_f32_out": rel_errs,
          "max_rel_err": max(rel_errs.values()), "rel_tol": QUANT_REL_TOL,
          "bf16_out_tol_atol_rtol": BF16_TOL, "deterministic": True,
          "quantize_array_bitwise_numpy": bitwise_numpy,
          "group_sizes": list(ql.GROUP_SIZES), "timed": timed,
          "decode_max_rows": ql.DECODE_MAX_ROWS,
          "crossover_device_ms": crossover})
    main = timed["gate_up_decode_int8"]
    return dict(
        name="quant_linear", route="cuda",
        source="parallax_tpu_torch/csrc/quant_linear.cu",
        replaces="parallax_tpu/models/layers.py:127",
        max_abs_err=max(errs.values()), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
    )


def kernels_grouped_gemm_q(torch, gen, dev, flush, device_only) -> dict:
    """A11 against its plain version at Qwen3-30B-A3B's expert shapes (E
    128, top 8, gate / up N 768 K 2048, down N 2048 K 768), a decode step
    (M 56) and a 2048-token prefill step (M 16,384 with empty and 1-row
    groups), int8 and int4 at the loader's group (and at 32 and 128 on
    the decode step): both variants forced and the one M picks, each
    within F32_TOL, two calls the same bits; then timed device-only."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops import quant as tq
    from parallax_tpu_torch.ops import quant_linear as ql

    bf16 = torch.bfloat16
    cfg = get_preset(MOE_MODEL)
    e, hid = cfg.moe.num_experts, cfg.hidden_size
    inter, k_top = cfg.moe.moe_intermediate_size, cfg.moe.num_experts_per_tok
    shapes = {"decode": _decode_offsets(7, k_top, e, seed=8),
              "prefill": _skewed_offsets(2048 * k_top, e, seed=7)}
    errs, bitwise, timed, crossover = {}, {}, {}, {}
    for proj, n, k in (("gate_up", inter, hid), ("down", hid, inter)):
        w = torch.randn((e, n, k), generator=gen, device=dev) * k ** -0.5
        for bits in (8, 4):
            for g in ql.GROUP_SIZES:
                if g != QUANT_GROUP and bits != 8:
                    continue
                qp = tq.quantize_param_dict(w, bits, g, bf16)
                for shape, offs in shapes.items():
                    if g != QUANT_GROUP and shape != "decode":
                        continue
                    m = offs[-1]
                    lhs = torch.randn((m, k), generator=gen,
                                      device=dev).to(bf16)
                    offsets = torch.tensor(offs, dtype=torch.int32,
                                           device=dev)
                    ref = ql.grouped_matmul_q_plain(lhs, qp, offsets)
                    key = f"{shape}_{proj}_int{bits}_g{g}"
                    got = {}
                    for v in ("prefill", "decode"):
                        got[v] = ql.grouped_matmul_q(lhs, qp, offsets,
                                                     _variant=v)
                        again = ql.grouped_matmul_q(lhs, qp, offsets,
                                                    _variant=v)
                        torch.cuda.synchronize()
                        if not torch.equal(got[v], again):
                            raise AssertionError(f"grouped_gemm_q {key} {v}"
                                                 ": two calls differ")
                        errs[f"{key}_{v}"] = _close(torch, got[v], ref,
                                                    F32_TOL)
                        bitwise[f"{key}_{v}"] = bool(torch.equal(got[v],
                                                                 ref))
                    picked = ql.grouped_matmul_q(lhs, qp, offsets)
                    torch.cuda.synchronize()
                    if not torch.equal(picked,
                                       got[ql.grouped_variant_for(m)]):
                        raise AssertionError(f"grouped_gemm_q {key}: the "
                                             "picked variant's bits differ")
                    if g == QUANT_GROUP:
                        touched = sum(1 for i in range(e)
                                      if offs[i + 1] > offs[i])

                        def call(lhs=lhs, offsets=offsets, qp=qp):
                            return ql.grouped_matmul_q(lhs, qp, offsets)

                        b_ms, b_by = quant_bound(m, n, k, g, 4, touched)
                        timed[f"{shape}_{proj}_int{bits}"] = dict(
                            m=m, n=n, k=k, groups_touched=touched,
                            variant=ql.grouped_variant_for(m),
                            ms=time_ms(torch, call, 20, flush),
                            device_ms=time_ms(torch, call, 20, flush,
                                              hide_host=True),
                            plain_ms=time_ms(torch, lambda lhs=lhs,
                                             offsets=offsets, qp=qp:
                                             ql.grouped_matmul_q_plain(
                                                 lhs, qp, offsets), 5, flush),
                            bound_ms=b_ms, bound_by=b_by)
                        device_only[f"grouped_gemm_q_{shape}_{proj}_int"
                                    f"{bits}"] = timed[
                            f"{shape}_{proj}_int{bits}"]["device_ms"]
                    del lhs, offsets, ref, got, picked
                if bits == 8 and g == QUANT_GROUP:
                    for tokens in QUANT_SWEEP_TOKENS:
                        offs = _decode_offsets(tokens, k_top, e,
                                               seed=9 + tokens)
                        lhs = torch.randn((offs[-1], k), generator=gen,
                                          device=dev).to(bf16)
                        offsets = torch.tensor(offs, dtype=torch.int32,
                                               device=dev)
                        ref = ql.grouped_matmul_q_plain(lhs, qp, offsets)
                        row = {}
                        for v in ("decode", "prefill"):
                            _close(torch, ql.grouped_matmul_q(
                                lhs, qp, offsets, _variant=v), ref, F32_TOL)
                            row[v] = time_ms(
                                torch, lambda v=v, lhs=lhs, offsets=offsets,
                                qp=qp: ql.grouped_matmul_q(
                                    lhs, qp, offsets, _variant=v), 20,
                                flush, hide_host=True)
                        crossover[f"m{offs[-1]}_{proj}"] = row
                        del lhs, offsets, ref
                del qp
        del w
    emit({"phase": "kernels", "check": "grouped_gemm_q", "model": MOE_MODEL,
          "experts": e, "max_abs_err": errs, "f32_tol_atol_rtol": F32_TOL,
          "deterministic": True, "bitwise_equal_to_plain": bitwise,
          "variant_by_shape": {sh: ql.grouped_variant_for(o[-1])
                               for sh, o in shapes.items()},
          "timed": timed, "decode_max_rows": ql.GROUPED_DECODE_MAX_ROWS,
          "crossover_device_ms": crossover})
    emit(check_quant_shared_expert(torch, gen, dev))
    main = timed["decode_gate_up_int8"]
    return dict(
        name="grouped_gemm_q", route="cuda",
        source="parallax_tpu_torch/csrc/quant_linear.cu",
        replaces="parallax_tpu/models/moe.py:92",
        max_abs_err=max(errs.values()), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
    )


def check_quant_shared_expert(torch, gen, dev) -> dict:
    """A quantized MoE block with a shared expert (GLM-4.5-Air's widths:
    H 4096, E 128, top 8, I 1408, one shared expert of 1408; int8 at the
    loader's group) at a decode step of 7 tokens: the shared expert's
    three products launch A10 and the routed experts' three launch A11,
    and the block agrees with the plain block (``kernel_choice(False)``
    and ``kernel=False``: dequantize, then multiply) within BF16_TOL."""
    from parallax_tpu_torch.models import layers as L
    from parallax_tpu_torch.models.moe import moe_ffn
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops import quant as tq

    bf16 = torch.bfloat16
    cfg = get_preset(GLM4_MOE_MODEL)
    moe, h = cfg.moe, cfg.hidden_size
    e, inter = moe.num_experts, moe.moe_intermediate_size
    shared = (moe.shared_expert_intermediate_size
              or inter) * moe.num_shared_experts

    def quantized(*shape):
        w = torch.randn(shape, generator=gen, device=dev) * shape[-1] ** -0.5
        return tq.quantize_param_dict(w, 8, QUANT_GROUP, bf16)

    p = {"gate": {"weight": (torch.randn((e, h), generator=gen, device=dev)
                             * h ** -0.5).to(bf16)},
         "experts": {"gate_proj": quantized(e, inter, h),
                     "up_proj": quantized(e, inter, h),
                     "down_proj": quantized(e, h, inter)},
         "shared_expert": {"gate_proj": quantized(shared, h),
                           "up_proj": quantized(shared, h),
                           "down_proj": quantized(h, shared)}}
    x = torch.randn((7, h), generator=gen, device=dev).to(bf16)
    with ck.tally(into_launches=False) as launched:
        got = moe_ffn(x, p, moe)
        torch.cuda.synchronize()
    with L.kernel_choice(False), ck.tally(into_launches=False) as plain_run:
        ref = moe_ffn(x, p, moe, kernel=False)
    want = {"quant_linear": 3, "grouped_gemm_q": 3}
    if launched != want or plain_run:
        raise AssertionError(f"quantized shared expert: launches "
                             f"{launched} (plain {plain_run}), want {want}")
    err = _close(torch, got, ref, BF16_TOL)
    del p, x, got, ref
    return {"phase": "kernels", "check": "quant_shared_expert",
            "model": GLM4_MOE_MODEL, "tokens": 7, "shared_intermediate":
            shared, "launches": launched, "plain_launches": plain_run,
            "max_abs_err": err, "bf16_tol_atol_rtol": BF16_TOL}


def _mla_case(torch, gen, dev, dtype, hq, r, dr, page, lens, frozen,
              pps=None):
    """Random A5 / A6 inputs over ``lens``-long contexts (_paged_rows) and
    the wrappers' keywords."""
    pages, slots, used = _paged_rows(torch, lens, page, frozen, pps)
    s = len(lens)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    c = dict(ql=rnd(s, hq, r), qp=rnd(s, hq, dr), lat=rnd(s, r),
             kpe=rnd(s, dr), cache=rnd(used + 2, page, 1, r + dr),
             lens=torch.tensor(lens, dtype=torch.int32, device=dev),
             pages=pages.to(dev), slots=slots.to(dev))
    return c, dict(sm_scale=(128 + dr) ** -0.5, kv_lora_rank=r)


def check_mla(torch, gen, dev, dtype, hq, r, dr, page, lens, frozen,
              pps=None):
    """A5 (append + attend) and A6 (attend) against their plain versions on
    the same inputs: the cache bitwise, kv_len 0 rows exactly zero, the
    outputs within BF16_TOL / F32_TOL; A6 on A5's cache gives A5's bits."""
    from parallax_tpu_torch.ops.decode_fused import (
        mla_fused_decode,
        mla_fused_decode_plain,
    )
    from parallax_tpu_torch.ops.mla_decode import (
        mla_decode_attention,
        mla_decode_attention_plain,
    )

    c, kw = _mla_case(torch, gen, dev, dtype, hq, r, dr, page, lens, frozen,
                      pps)
    cache_k, cache_p = c["cache"].clone(), c["cache"].clone()
    args = (c["ql"], c["qp"], c["lat"], c["kpe"])
    out_k, _ = mla_fused_decode(*args, cache_k, c["lens"], c["pages"],
                                c["slots"], **kw)
    out_p, _ = mla_fused_decode_plain(*args, cache_p, c["lens"], c["pages"],
                                      c["slots"], **kw)
    out_6 = mla_decode_attention(c["ql"], c["qp"], cache_k, c["lens"],
                                 c["pages"], **kw)
    ref_6 = mla_decode_attention_plain(c["ql"], c["qp"], cache_p, c["lens"],
                                       c["pages"], **kw)
    # Two calls give the same bits: A5 again on a fresh copy of the cache,
    # A6 again on A5's.
    cache_2 = c["cache"].clone()
    out_k2, _ = mla_fused_decode(*args, cache_2, c["lens"], c["pages"],
                                 c["slots"], **kw)
    out_62 = mla_decode_attention(c["ql"], c["qp"], cache_k, c["lens"],
                                  c["pages"], **kw)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_k2) and torch.equal(cache_k, cache_2)
            and torch.equal(out_6, out_62)):
        raise AssertionError("mla_decode/mla_attend: two calls differ")
    if not torch.equal(cache_k, cache_p):
        raise AssertionError("mla_decode: cache after the append differs")
    zero_rows = [i for i, n in enumerate(lens) if n == 0]
    if zero_rows and (bool(out_k[zero_rows].any())
                      or bool(out_6[zero_rows].any())):
        raise AssertionError("mla_decode/mla_attend: kv_len 0 rows not zero")
    if not torch.equal(out_k, out_6):
        raise AssertionError("mla_attend on mla_decode's cache differs")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    return (_close(torch, out_k, out_p, tol), _close(torch, out_6, ref_6, tol),
            c, kw)


def _close_scores(torch, got, ref, tol) -> float:
    """Scores: the -inf positions identical, the rest within ``tol``."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(ref)):
        raise AssertionError("indexer: -inf positions differ from plain")
    if not bool(torch.isfinite(got[~torch.isneginf(got)]).all()):
        raise AssertionError("indexer: NaN or +inf scores")
    live = torch.isfinite(ref)
    return _close(torch, got[live], ref[live], tol)


def _indexer_case(torch, gen, dev, dtype, hi, d, page, lens, frozen, kind,
                  pps=None):
    """Random A7 / A8 inputs over ``lens``-long contexts (_paged_rows) and
    the wrappers' keywords."""
    pages, slots, used = _paged_rows(torch, lens, page, frozen, pps)
    s = len(lens)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    c = dict(q=rnd(s, hi, d), k=rnd(s, d), cache=rnd(used + 2, page, 1, d),
             w=(torch.rand((s, hi), generator=gen, device=dev)
                if kind == "dsa" else None),
             lens=torch.tensor(lens, dtype=torch.int32, device=dev),
             pages=pages.to(dev), slots=slots.to(dev))
    return c, dict(reduce_kind=kind, sm_scale=d ** -0.5)


def check_indexer(torch, gen, dev, dtype, hi, d, page, lens, frozen, kind,
                  pps=None):
    """A7 (append + score) and A8 (score) against their plain versions: the
    cache bitwise, the -inf positions identical, the scores within
    SCORE_TOL; A8 on A7's cache gives A7's bits, and two calls of each
    give the same bits."""
    from parallax_tpu_torch.ops.decode_fused import (
        indexer_scores_fused,
        indexer_scores_fused_plain,
    )
    from parallax_tpu_torch.ops.dsa_decode import (
        paged_token_scores_decode,
        paged_token_scores_decode_plain,
    )

    c, kw = _indexer_case(torch, gen, dev, dtype, hi, d, page, lens, frozen,
                          kind, pps)
    cache_k, cache_p = c["cache"].clone(), c["cache"].clone()
    sc_k, _ = indexer_scores_fused(c["q"], c["w"], c["k"], cache_k,
                                   c["lens"], c["pages"], c["slots"], **kw)
    sc_p, _ = indexer_scores_fused_plain(c["q"], c["w"], c["k"], cache_p,
                                         c["lens"], c["pages"], c["slots"],
                                         **kw)
    sc_8 = paged_token_scores_decode(c["q"], c["w"], cache_k, c["lens"],
                                     c["pages"], **kw)
    ref_8 = paged_token_scores_decode_plain(c["q"], c["w"], cache_p,
                                            c["lens"], c["pages"], **kw)
    cache_2 = c["cache"].clone()
    sc_k2, _ = indexer_scores_fused(c["q"], c["w"], c["k"], cache_2,
                                    c["lens"], c["pages"], c["slots"], **kw)
    sc_82 = paged_token_scores_decode(c["q"], c["w"], cache_k, c["lens"],
                                      c["pages"], **kw)
    torch.cuda.synchronize()
    if not torch.equal(cache_k, cache_p):
        raise AssertionError("indexer_fused: cache after the append differs")
    if not torch.equal(sc_k, sc_8):
        raise AssertionError("indexer_scores on indexer_fused's cache "
                             "differs")
    if not (torch.equal(sc_k, sc_k2) and torch.equal(cache_k, cache_2)
            and torch.equal(sc_8, sc_82)):
        raise AssertionError("indexer_fused/indexer_scores: two calls differ")
    return (_close_scores(torch, sc_k, sc_p, SCORE_TOL),
            _close_scores(torch, sc_8, ref_8, SCORE_TOL), c, kw)


def _sdpa_mla(torch, c, r, page, sm_scale):
    """The MLA yardstick: one scaled_dot_product_attention call over the
    densely gathered rows, q = [q_lat ‖ q_pe], k = [latent ‖ rope],
    v = latent, one key head shared by all query heads."""
    import torch.nn.functional as F

    lens = c["lens"].tolist()
    s, lmax = len(lens), max(lens)
    w = c["cache"].shape[-1]
    dt, dv = c["ql"].dtype, c["ql"].device
    k = torch.zeros((s, 1, lmax, w), dtype=dt, device=dv)
    mask = torch.zeros((s, 1, 1, lmax), dtype=torch.bool, device=dv)
    for i, n in enumerate(lens):
        npg = (n + page - 1) // page
        if n:
            k[i, 0, :n] = c["cache"][c["pages"][i, :npg].long()].reshape(
                npg * page, w)[:n]
            mask[i, :, :, :n] = True
        else:
            mask[i, :, :, 0] = True
    v = k[..., :r]
    q = torch.cat([c["ql"], c["qp"]], dim=-1)[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm_scale, enable_gqa=True)


def time_mla(torch, mc, mkw, lens, page, flush, device_only,
             suffix="") -> list[dict]:
    """A5 and A6 on ``mc``'s rows (a check_mla case) timed as the kernels
    line times them, beside their plain versions, SDPA over the gathered
    rows and the bound; each one's device time (and SDPA's as
    ``mla_library``) goes into ``device_only``, keyed with ``suffix``."""
    from parallax_tpu_torch.ops.decode_fused import (
        mla_fused_decode,
        mla_fused_decode_plain,
    )
    from parallax_tpu_torch.ops.mla_decode import (
        mla_decode_attention,
        mla_decode_attention_plain,
    )

    s, hq, r = mc["ql"].shape
    w, ctx, esz = mc["cache"].shape[-1], sum(lens), 2
    cache = mc["cache"].clone()
    fargs = (mc["ql"], mc["qp"], mc["lat"], mc["kpe"], cache, mc["lens"],
             mc["pages"], mc["slots"])
    aargs = (mc["ql"], mc["qp"], cache, mc["lens"], mc["pages"])
    sdpa = _sdpa_mla(torch, dict(mc, cache=cache), r, page, mkw["sm_scale"])
    lib = time_ms(torch, sdpa, 30, flush)
    device_only["mla_library" + suffix] = time_ms(torch, sdpa, 30, flush,
                                                  hide_host=True)
    del sdpa
    ops = 2 * hq * ctx * (w + r)
    out = []
    for name, fn, plain_fn, args, app, src in (
        ("mla_decode", mla_fused_decode, mla_fused_decode_plain, fargs, True,
         "parallax_tpu/ops/decode_fused_pallas.py:421"),
        ("mla_attend", mla_decode_attention, mla_decode_attention_plain,
         aargs, False, "parallax_tpu/ops/mla_pallas.py:114"),
    ):
        ms = time_ms(torch, lambda: fn(*args, **mkw), 50, flush)
        plain = time_ms(torch, lambda: plain_fn(*args, **mkw), 10, flush)
        device_only[name + suffix] = time_ms(
            torch, lambda: fn(*args, **mkw), 50, flush, hide_host=True)
        device_only[name + suffix + "_clean_l2"] = time_ms(
            torch, lambda: fn(*args, **mkw), 50, flush, hide_host=True,
            clean=True)
        moved = (s * hq * w + ctx * w + s * hq * r + (2 * s * w if app else 0)
                 ) * esz
        b_ms, b_by = bound(moved, ops, "bfloat16")
        out.append(dict(
            name=name, route="cuda",
            source="parallax_tpu_torch/csrc/mla_decode.cu", replaces=src,
            ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib,
        ))
    return out


def mla_long_context(torch, gen, dev, flush, device_only) -> dict:
    """A5 and A6 at 7 rows of 8,192 keys at DeepSeek-V3's widths (66 MB of
    latent cache, past the 50 MB L2): checked as check_mla checks, then
    timed as time_mla times them."""
    from parallax_tpu_torch.models.presets import get_preset

    cfg = get_preset(DSV3_MODEL)
    hq, r, dr, page = (cfg.num_attention_heads, cfg.mla.kv_lora_rank,
                       cfg.mla.qk_rope_head_dim, 64)
    lens = [MLA_LONG_KEYS] * 7
    e5, e6, mc, mkw = check_mla(torch, gen, dev, torch.bfloat16, hq, r, dr,
                                page, lens, set())
    timed = time_mla(torch, mc, mkw, lens, page, flush, device_only,
                     suffix="_long")
    line = {"phase": "kernels", "check": "mla_long_context", "lens": lens,
            "mla_decode_bf16_max_abs_err": e5,
            "mla_attend_bf16_max_abs_err": e6,
            "bf16_tol_atol_rtol": BF16_TOL, "cache_bitwise_equal": True,
            "a6_equals_a5": True, "two_calls_bitwise_equal": True}
    for e in timed:
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            line[f"{e['name']}_{key}"] = e[key]
        line[f"{e['name']}_device_only_ms"] = device_only[e["name"] + "_long"]
    line["library_device_only_ms"] = device_only["mla_library_long"]
    return line


def kernels_deepseek(torch, gen, dev, flush, device_only) -> list[dict]:
    """A5-A8: the checks at DeepSeek-V3 / V3.2's decode shapes and the
    small float32 edge cases, then the main shapes timed; A5 / A6 also at
    long contexts."""
    from parallax_tpu_torch.models.presets import get_preset

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_preset(DSV32_MODEL)
    hq, m = cfg.num_attention_heads, cfg.mla
    r, dr = m.kv_lora_rank, m.qk_rope_head_dim
    hi, di = cfg.dsa.index_n_heads, cfg.dsa.index_head_dim
    page = 64
    # The serve mix's seven decode rows at their last step (prompt + 32).
    lens = [292, 332, 482, 732, 544, 412, 672]
    edge = dict(lens=[37, 0, 1, 16, 50, 9], frozen={3})
    e5, e6, mc, mkw = check_mla(torch, gen, dev, bf16, hq, r, dr, page, lens,
                                set(), pps=1024 // page)
    e5s, e6s, *_ = check_mla(torch, gen, dev, f32, 16, 64, 16, 16,
                             **edge)
    emit({"phase": "kernels", "check": "mla", "hq": hq, "r": r, "dr": dr,
          "lens": lens, "mla_decode_bf16_max_abs_err": e5,
          "mla_attend_bf16_max_abs_err": e6,
          "f32_edge_cases": edge["lens"], "mla_decode_f32_max_abs_err": e5s,
          "mla_attend_f32_max_abs_err": e6s,
          "bf16_tol_atol_rtol": BF16_TOL, "f32_tol_atol_rtol": F32_TOL,
          "cache_bitwise_equal": True, "a6_equals_a5": True,
          "two_calls_bitwise_equal": True})
    errs = {}
    for kind in ("dsa", "msa"):
        e7, e8, ic, ikw = check_indexer(torch, gen, dev, bf16, hi, di, page,
                                        lens, set(), kind,
                                        pps=DSA_MAX_MODEL_LEN // page)
        e7s, e8s, *_ = check_indexer(torch, gen, dev, f32, 8, 32, 16, kind=kind,
                                     **edge)
        errs[kind] = dict(indexer_fused_bf16=e7, indexer_scores_bf16=e8,
                          indexer_fused_f32=e7s, indexer_scores_f32=e8s)
        if kind == "dsa":
            dsa_case, dsa_kw, e_dsa = ic, ikw, (max(e7, e7s), max(e8, e8s))
    emit({"phase": "kernels", "check": "indexer", "hi": hi, "d": di,
          "lens": lens, "max_abs_err": errs, "score_tol_atol_rtol": SCORE_TOL,
          "cache_bitwise_equal": True, "neg_inf_positions_identical": True,
          "a8_equals_a7": True})

    # A5 / A6 at the main shapes.
    out = time_mla(torch, mc, mkw, lens, page, flush, device_only)
    out[0]["max_abs_err"] = max(e5, e5s)
    out[1]["max_abs_err"] = max(e6, e6s)
    del mc
    emit(mla_long_context(torch, gen, dev, flush, device_only))
    # A7 / A8 at the main shapes (DSA reduction).
    out.extend(time_indexer(torch, dsa_case, dsa_kw, lens, page, flush,
                            device_only, e_dsa))
    del dsa_case
    emit(indexer_long_context(torch, dev, flush, device_only))
    return out


def time_indexer(torch, ic, kw, lens, page, flush, device_only, errs=None,
                 suffix="") -> list[dict]:
    """A7 and A8 on ``ic``'s rows (a check_indexer case) timed as the
    kernels line times them, beside their plain versions and the bound;
    each one's device time goes into ``device_only``, keyed with
    ``suffix``. ``errs``: (A7, A8) max abs errors for the kernels line."""
    from parallax_tpu_torch.ops.decode_fused import (
        indexer_scores_fused,
        indexer_scores_fused_plain,
    )
    from parallax_tpu_torch.ops.dsa_decode import (
        paged_token_scores_decode,
        paged_token_scores_decode_plain,
    )

    s, hi, d = ic["q"].shape
    ctx, esz = sum(lens), ic["cache"].element_size()
    cache = ic["cache"].clone()
    cap = ic["pages"].shape[1] * page
    fargs = (ic["q"], ic["w"], ic["k"], cache, ic["lens"], ic["pages"],
             ic["slots"])
    sargs = (ic["q"], ic["w"], cache, ic["lens"], ic["pages"])
    errs = errs or (None, None)
    out = []
    for name, fn, plain_fn, args, app, err, src in (
        ("indexer_fused", indexer_scores_fused, indexer_scores_fused_plain,
         fargs, True, errs[0], "parallax_tpu/ops/decode_fused_pallas.py:505"),
        ("indexer_scores", paged_token_scores_decode,
         paged_token_scores_decode_plain, sargs, False, errs[1],
         "parallax_tpu/ops/dsa_pallas.py:39"),
    ):
        ms = time_ms(torch, lambda: fn(*args, **kw), 50, flush)
        plain = time_ms(torch, lambda: plain_fn(*args, **kw), 10, flush)
        device_only[name + suffix] = time_ms(
            torch, lambda: fn(*args, **kw), 50, flush, hide_host=True)
        moved = ((s * hi * d + ctx * d + (2 * s * d if app else 0)) * esz
                 + (s * hi * 4 if ic["w"] is not None else 0) + s * cap * 4)
        b_ms, b_by = bound(moved, 2 * hi * d * ctx, "bfloat16")
        out.append(dict(
            name=name, route="cuda",
            source="parallax_tpu_torch/csrc/indexer_scores.cu",
            replaces=src, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
    return out


def indexer_long_context(torch, dev, flush, device_only) -> dict:
    """A7 and A8 at 7 rows of INDEXER_LONG_KEYS keys at DeepSeek-V3.2's
    indexer widths (Hi 64, D 128, bf16: 58.7 MB of index keys, past the
    50 MB L2), checked as check_indexer checks, then timed as
    time_indexer times them; and the MSA reduction at MiniMax-M3's indexer
    geometry (Hi 16, D 64) on the smoke rows, and bf16 at page sizes 16,
    24 and 12 on edge rows. Its own generator, so the other checks' inputs
    stay as they were."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.decode_fused import indexer_scores_fused

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    bf16, page = torch.bfloat16, 64
    m3 = get_preset(MSA_MODEL).msa
    smoke = [292, 332, 482, 732, 544, 412, 672]
    e7m, e8m, icm, kwm = check_indexer(
        torch, gen, dev, bf16, m3.index_n_heads, m3.index_head_dim, page,
        smoke, set(), "msa", pps=MSA_MAX_MODEL_LEN // page)
    # Timed at msa_serve's decode shape: the mix's rows over its page table.
    timed_m3 = time_indexer(torch, icm, kwm, smoke, page, flush, device_only,
                            suffix="_msa")
    del icm
    cfg = get_preset(DSV32_MODEL).dsa
    # bf16 at other page sizes, with the f32 cases' rows: 16 and 24 (the
    # tensor-core body's copies in boxes of 16 and 8 positions) and 12
    # (the CUDA-core body).
    edge = {}
    for epage in (16, 24, 12):
        e7e, e8e, *_ = check_indexer(
            torch, gen, dev, bf16, cfg.index_n_heads, cfg.index_head_dim,
            epage, [37, 0, 1, 16, 50, 9, 100], {3}, "dsa")
        edge[f"page_{epage}"] = {"indexer_fused_bf16_max_abs_err": e7e,
                                 "indexer_scores_bf16_max_abs_err": e8e}
    lens = [INDEXER_LONG_KEYS] * 7
    e7, e8, ic, kw = check_indexer(torch, gen, dev, bf16, cfg.index_n_heads,
                                   cfg.index_head_dim, page, lens, set(),
                                   "dsa")
    timed = time_indexer(torch, ic, kw, lens, page, flush, device_only,
                         suffix="_long")
    # Diagnoses, as for A4 / A5: A7 after a reading L2 flush, which leaves
    # no dirty lines for the call to write back, and one PyTorch reduction
    # reading the same live index keys (58.7 MB) after either flush: what
    # the card's reads reach under the same harness.
    cache = ic["cache"].clone()
    fused = lambda: indexer_scores_fused(ic["q"], ic["w"], ic["k"], cache,
                                         ic["lens"], ic["pages"],
                                         ic["slots"], **kw)
    device_only["indexer_fused_long_clean_l2"] = time_ms(
        torch, fused, 30, flush, hide_host=True, clean=True)
    keys = cache[1:1 + sum(-(-n // page) for n in lens)]
    read = lambda: keys.sum(dtype=torch.float32)
    device_only["indexer_keys_read_long"] = time_ms(torch, read, 30, flush,
                                                    hide_host=True)
    device_only["indexer_keys_read_long_clean_l2"] = time_ms(
        torch, read, 30, flush, hide_host=True, clean=True)
    del cache, keys
    line = {"phase": "kernels", "check": "indexer_long_context",
            "lens": lens, "hi": cfg.index_n_heads, "d": cfg.index_head_dim,
            "pps": ic["pages"].shape[1],
            "indexer_fused_bf16_max_abs_err": e7,
            "indexer_scores_bf16_max_abs_err": e8,
            "msa_minimax_m3": {"hi": m3.index_n_heads,
                               "d": m3.index_head_dim, "lens": smoke,
                               "pps": MSA_MAX_MODEL_LEN // page,
                               "indexer_fused_bf16_max_abs_err": e7m,
                               "indexer_scores_bf16_max_abs_err": e8m,
                               **{f"{e['name']}_{key}": e[key]
                                  for e in timed_m3
                                  for key in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")},
                               **{f"{e['name']}_device_only_ms":
                                  device_only[e["name"] + "_msa"]
                                  for e in timed_m3}},
            "bf16_page_sizes": edge,
            "score_tol_atol_rtol": SCORE_TOL, "cache_bitwise_equal": True,
            "neg_inf_positions_identical": True, "a8_equals_a7": True,
            "two_calls_bitwise_equal": True}
    for e in timed:
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            line[f"{e['name']}_{key}"] = e[key]
        line[f"{e['name']}_device_only_ms"] = device_only[e["name"] + "_long"]
    for key in ("indexer_fused_long_clean_l2", "indexer_keys_read_long",
                "indexer_keys_read_long_clean_l2"):
        line[f"{key}_device_only_ms"] = device_only[key]
    return line


def check_split_decode(torch, gen, dev, dtype, hq, hkv, d, page, lens,
                       window, sinks, pps=None):
    """A9 (split decode, no append) against its plain version, and A2 (the
    fused decode) against its own at the same shapes, sinks and window: the
    cache after A2's append bitwise, kv_len 0 rows exactly zero, outputs
    within BF16_TOL / F32_TOL; A9 on A2's cache gives A2's bits, and so
    does A1 attend-only on the same rows as one-token sequences (its decode
    role: the same split partition, device function and combine)."""
    from parallax_tpu_torch.ops.decode_fused import (
        gqa_fused_decode,
        gqa_fused_decode_plain,
    )
    from parallax_tpu_torch.ops.gqa_decode import (
        gqa_decode_attention,
        gqa_decode_attention_plain,
    )
    from parallax_tpu_torch.ops.prefill_fused import gqa_prefill_attend

    c = _decode_case(torch, gen, dev, dtype, hq, hkv, d, page, lens,
                     frozen=set())
    if pps is not None:
        pages = torch.zeros((len(lens), pps), dtype=torch.int32, device=dev)
        pages[:, :c["pages"].shape[1]] = c["pages"]
        c["pages"] = pages
    kw = dict(sm_scale=d ** -0.5, sliding_window=window)
    cache_k, cache_p = c["cache"].clone(), c["cache"].clone()
    out_2, _ = gqa_fused_decode(c["q"], c["k"], c["v"], cache_k, c["lens"],
                                c["pages"], c["slots"], sinks, **kw)
    ref_2, _ = gqa_fused_decode_plain(c["q"], c["k"], c["v"], cache_p,
                                      c["lens"], c["pages"], c["slots"],
                                      sinks, **kw)
    out_9 = gqa_decode_attention(c["q"], cache_k, c["lens"], c["pages"],
                                 sinks, **kw)
    ref_9 = gqa_decode_attention_plain(c["q"], cache_p, c["lens"],
                                       c["pages"], sinks, **kw)
    s = len(lens)
    out_1 = gqa_prefill_attend(
        c["q"], cache_k, c["lens"], c["pages"],
        torch.arange(s + 1, dtype=torch.int32, device=dev),
        torch.tensor([s], dtype=torch.int32, device=dev), sinks, **kw)
    torch.cuda.synchronize()
    if not torch.equal(cache_k, cache_p):
        raise AssertionError("gqa_decode: cache after the append differs")
    zero_rows = [i for i, n in enumerate(lens) if n == 0]
    if zero_rows and (bool(out_9[zero_rows].any())
                      or bool(out_2[zero_rows].any())):
        raise AssertionError("gqa_attend/gqa_decode: kv_len 0 rows not zero")
    if not torch.equal(out_9, out_2):
        raise AssertionError("gqa_attend on gqa_decode's cache differs")
    if not torch.equal(out_1, out_2):
        raise AssertionError("gqa_prefill's one-token rows on gqa_decode's "
                             "cache differ from gqa_decode")
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    return (_close(torch, out_9, ref_9, tol), _close(torch, out_2, ref_2, tol),
            dict(c, cache=cache_k), kw)


def _sdpa_sinks(torch, c, hq, hkv, d, page, sinks, sm_scale):
    """The yardstick for A9: one scaled_dot_product_attention call over the
    densely gathered rows plus one zero key / zero value column whose
    additive mask is the head's sink (a logit of 0 + sink, no value), which
    computes the same function."""
    import torch.nn.functional as F

    lens = c["lens"].tolist()
    s, lmax = len(lens), max(lens)
    dt, dv = c["q"].dtype, c["q"].device
    k = torch.zeros((s, hkv, lmax + 1, d), dtype=dt, device=dv)
    v = torch.zeros_like(k)
    mask = torch.full((s, hq, 1, lmax + 1), float("-inf"), dtype=dt,
                      device=dv)
    mask[:, :, 0, lmax] = sinks.to(dt)
    for i, n in enumerate(lens):
        if n:
            k[i, :, :n], v[i, :, :n] = _dense_kv(torch, c["pages"][i], n,
                                                 c["cache"], hkv, d, page)
            mask[i, :, :, :n] = 0.0
    q = c["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm_scale, enable_gqa=True)


def kernels_split(torch, gen, dev, flush) -> list[dict]:
    """The split path's kernels: A9 (K6) at gpt-oss-20b's decode shapes (7
    rows, Hq 64, Hkv 8, D 64, page 64, contexts 292-732, random sinks,
    window 128 and none) and a small float32 case, A2 beside it at the same
    shapes, A0 + A1 at gpt-oss-20b's prefill shapes; A1 attend-only (K9's
    route) at the split path's decode shape (Qwen2.5-7B, 7 rows x 1 token,
    one padding token) against the plain split path, real tokens only.
    Then each timed."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.attention import ragged_paged_attention
    from parallax_tpu_torch.ops.decode_fused import (
        gqa_fused_decode,
        gqa_fused_decode_plain,
    )
    from parallax_tpu_torch.ops.gqa_decode import (
        gqa_decode_attention,
        gqa_decode_attention_plain,
    )
    from parallax_tpu_torch.ops.kv_cache_ops import reshape_and_cache
    from parallax_tpu_torch.ops.prefill_fused import gqa_prefill_attend

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_preset(GPTOSS_MODEL)
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    page = 64
    lens = [292, 332, 482, 732, 544, 412, 672]
    sinks = torch.randn((hq,), generator=gen, device=dev)
    errs, cases = {}, {}
    for label, window in (("full", None), ("window", cfg.sliding_window)):
        e9, e2, c, kw = check_split_decode(torch, gen, dev, bf16, hq, hkv, d,
                                           page, lens, window, sinks,
                                           pps=1024 // page)
        errs[f"gqa_attend_bf16_{label}"] = e9
        errs[f"gqa_decode_bf16_{label}"] = e2
        cases[label] = (c, kw)
    # float32 edge cases, G = 3: a kv_len 0 row, kv_len 1, contexts ending
    # mid-page, windows shorter than a page (5) and spanning pages (20).
    sinks_s = torch.randn((6,), generator=gen, device=dev)
    edge = [37, 0, 1, 16, 50, 9]
    for window in (None, 5, 20):
        e9, e2, *_ = check_split_decode(torch, gen, dev, f32, 6, 2, 64, 16,
                                        edge, window, sinks_s)
        errs[f"gqa_attend_f32_window_{window}"] = e9
        errs[f"gqa_decode_f32_window_{window}"] = e2
    e9, _, *_ = check_split_decode(torch, gen, dev, f32, 6, 2, 64, 16, edge,
                                   None, None)
    errs["gqa_attend_f32_no_sinks"] = e9
    # The same edge cases in bf16.
    for window in (None, 5, 20):
        e9, e2, *_ = check_split_decode(torch, gen, dev, bf16, 6, 2, 64, 16,
                                        edge, window, sinks_s)
        errs[f"gqa_attend_bf16_edge_window_{window}"] = e9
        errs[f"gqa_decode_bf16_edge_window_{window}"] = e2
    # Contexts over several splits (8192: 32 splits of 4 pages; 4500: 24 of
    # 3), with kv_len 0 and 1; window 1000 starts inside a page of the first
    # split (8192 - 1000 = 7192 = 112 pages + 24).
    for label, window in (("full", None), ("window_1000", 1000)):
        e9, e2, *_ = check_split_decode(torch, gen, dev, bf16, hq, hkv, d,
                                        page, LONG_LENS, window, sinks)
        errs[f"gqa_attend_bf16_long_{label}"] = e9
        errs[f"gqa_decode_bf16_long_{label}"] = e2
    # A1's per-sequence tiles: one-token rows among long chunks, a chunk of
    # several tiles (300 tokens, 18 a tile at G = 7), bucket padding (489
    # live tokens of 512), at the dense shape and at gpt-oss-20b's with
    # sinks and its window.
    for label, shape, window, tile_sinks in (
        ("dense", (28, 4, 128), None, None),
        ("gptoss_window", (hq, hkv, d), cfg.sliding_window, sinks),
    ):
        e1, _, *_ = check_prefill(torch, gen, dev, bf16, *shape, page,
                                  [300, 1, 150, 1, 37], [0, 500, 64, 31, 0],
                                  pps=16, window=window, sinks=tile_sinks)
        errs[f"gqa_prefill_tiles_bf16_{label}"] = e1
    # A0 + A1 at gpt-oss-20b's prefill shapes: G = 8, D = 64, the sinks,
    # windowed and full layers, a ragged chunk over cached prefixes.
    for label, window in (("full", None), ("window", cfg.sliding_window)):
        e1, _, *_ = check_prefill(torch, gen, dev, bf16, hq, hkv, d, page,
                                  [256, 256, 200, 37], [0, 256, 192, 100],
                                  pps=16, window=window, sinks=sinks)
        errs[f"gqa_prefill_gptoss_bf16_{label}"] = e1

    # A1 attend-only at the dense split path's decode shape.
    dcfg = get_preset(DENSE_MODEL)
    dhq, dhkv, dd = (dcfg.num_attention_heads, dcfg.num_key_value_heads,
                     dcfg.head_dim)
    rc = _prefill_case(torch, gen, dev, bf16, dhq, dhkv, dd, page, [1] * 7,
                       [n - 1 for n in lens], pps=1024 // page)
    if rc["q"].shape[0] != 8:
        raise AssertionError("the decode-shaped batch must pad 7 rows to 8")
    reshape_and_cache(rc["cache"], rc["k"], rc["v"], rc["slots"])
    rargs = (rc["q"], rc["cache"], rc["kv_lens"], rc["pages"], rc["cu"],
             rc["nseq"])
    rkw = dict(sm_scale=dd ** -0.5)
    out_1 = gqa_prefill_attend(*rargs, None, **rkw)
    ref_1 = ragged_paged_attention(*rargs, use_kernels=False, **rkw)
    torch.cuda.synchronize()
    if bool(out_1[7:].any()):
        raise AssertionError("gqa_prefill: padding token is not zero")
    errs["gqa_prefill_decode_shape_bf16"] = _close(torch, out_1[:7],
                                                   ref_1[:7], BF16_TOL)
    emit({"phase": "kernels", "check": "split", "hq": hq, "hkv": hkv, "d": d,
          "lens": lens, "window": cfg.sliding_window, "f32_edge_cases": edge,
          "max_abs_err": errs, "bf16_tol_atol_rtol": BF16_TOL,
          "f32_tol_atol_rtol": F32_TOL, "cache_bitwise_equal": True,
          "a9_equals_a2": True, "a1_one_token_rows_equal_a2": True,
          "long_lens": LONG_LENS})

    out = []
    s, ctx, esz = len(lens), sum(lens), 2
    # A9 at the main shape (a full-attention layer), the windowed layer
    # timed beside it.
    c, kw = cases["full"]
    args = (c["q"], c["cache"], c["lens"], c["pages"], sinks)
    ms = time_ms(torch, lambda: gqa_decode_attention(*args, **kw), 50, flush)
    plain = time_ms(torch, lambda: gqa_decode_attention_plain(*args, **kw),
                    10, flush)
    sdpa_9 = _sdpa_sinks(torch, c, hq, hkv, d, page, sinks, kw["sm_scale"])
    lib = time_ms(torch, sdpa_9, 50, flush)
    b_ms, b_by = bound(2 * s * hq * d * esz + ctx * 2 * hkv * d * esz
                       + hq * 4, 4 * hq * d * ctx, "bfloat16")
    cw, kww = cases["window"]
    wargs = (cw["q"], cw["cache"], cw["lens"], cw["pages"], sinks)
    ms_w = time_ms(torch, lambda: gqa_decode_attention(*wargs, **kww), 50,
                   flush)
    # A2 at the same shape (its append included), for comparison.
    dargs = (c["q"], c["k"], c["v"], c["cache"].clone(), c["lens"],
             c["pages"], c["slots"], sinks)
    ms_2 = time_ms(torch, lambda: gqa_fused_decode(*dargs, **kw), 50, flush)
    plain_2 = time_ms(torch, lambda: gqa_fused_decode_plain(*dargs, **kw), 10,
                      flush)
    out.append(dict(
        name="gqa_attend", route="cuda",
        source="parallax_tpu_torch/csrc/gqa_decode.cu",
        replaces="parallax_tpu/ops/attention_pallas.py:130",
        max_abs_err=max(v for k, v in errs.items()
                        if k.startswith("gqa_attend")),
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
    ))
    # K9's route: A1 attend-only at the dense decode shape.
    ms_1 = time_ms(torch, lambda: gqa_prefill_attend(*rargs, None, **rkw), 50,
                   flush)
    plain_1 = time_ms(torch, lambda: ragged_paged_attention(
        *rargs, use_kernels=False, **rkw), 10, flush)
    dc = dict(q=rc["q"][:7], cache=rc["cache"], lens=rc["kv_lens"],
              pages=rc["pages"])
    sdpa_1 = _sdpa_decode(torch, dc, dhq, dhkv, dd, page)
    lib_1 = time_ms(torch, sdpa_1, 50, flush)
    dctx = int(rc["kv_lens"].sum())
    b1_ms, b1_by = bound(2 * 7 * dhq * dd * esz + dctx * 2 * dhkv * dd * esz,
                         4 * dhq * dd * dctx, "bfloat16")
    # A2 at the same dense decode shape.
    dcase = _decode_case(torch, gen, dev, bf16, dhq, dhkv, dd, page, lens,
                         frozen=set())
    a2args = (dcase["q"], dcase["k"], dcase["v"], dcase["cache"],
              dcase["lens"], dcase["pages"], dcase["slots"], None)
    ms_a2 = time_ms(torch, lambda: gqa_fused_decode(
        *a2args, sm_scale=dd ** -0.5), 50, flush)
    out.append(dict(
        name="ragged_attend", route="cuda",
        source="parallax_tpu_torch/csrc/gqa_prefill.cu",
        replaces="parallax_tpu/ops/attention.py:211",
        max_abs_err=errs["gqa_prefill_decode_shape_bf16"], ms=ms_1,
        plain_ms=plain_1, bound_ms=b1_ms, bound_by=b1_by, library_ms=lib_1,
    ))
    emit({"phase": "kernels", "check": "split_timed",
          "gqa_attend_window_ms": ms_w, "gqa_decode_at_gptoss_shape_ms": ms_2,
          "gqa_decode_at_gptoss_shape_plain_ms": plain_2,
          "gqa_decode_at_dense_decode_shape_ms": ms_a2,
          "ragged_attend_ms": ms_1, "ragged_attend_library_ms": lib_1})
    device_only = {
        "gqa_attend": time_ms(torch, lambda: gqa_decode_attention(*args, **kw),
                              50, flush, hide_host=True),
        "gqa_attend_library": time_ms(torch, sdpa_9, 50, flush,
                                      hide_host=True),
        "gqa_decode_at_gptoss_shape": time_ms(
            torch, lambda: gqa_fused_decode(*dargs, **kw), 50, flush,
            hide_host=True),
        "ragged_attend": time_ms(
            torch, lambda: gqa_prefill_attend(*rargs, None, **rkw), 50, flush,
            hide_host=True),
        "ragged_attend_library": time_ms(torch, sdpa_1, 50, flush,
                                         hide_host=True),
    }
    emit(long_context_timed(torch, gen, dev, flush, sinks))
    return out, device_only


def kernels_d256(torch, gen, dev, flush) -> tuple[list[dict], dict]:
    """A0, A1 (fused and attend-only), A2 and A9 at head dim 256, the
    shape Qwen3-Next's gated full-attention layers give them (Hq 16, Hkv 2,
    page 64), in bf16 and float32: prefix hits, sliding windows, kv_len 0
    and frozen rows, bucket padding, several tiles a chunk (the float32
    tile holds 64 rows). Each against its plain version (cache bitwise,
    attention BF16_TOL / F32_TOL), A1 and A2 called twice for the same
    bits, A9 and A1's one-token rows equal to A2's; then each timed beside
    its plain version, SDPA and its bound. Returns the kernels line's
    entries (``<kernel>@d256``) and their device-only times."""
    from parallax_tpu_torch.ops.decode_fused import gqa_fused_decode
    from parallax_tpu_torch.ops.gqa_decode import (
        gqa_decode_attention,
        gqa_decode_attention_plain,
    )
    from parallax_tpu_torch.ops.kv_cache_ops import (
        interleave_kv,
        kv_append,
        reshape_and_cache,
    )
    from parallax_tpu_torch.ops.prefill_fused import (
        gqa_fused_prefill,
        gqa_prefill_attend,
        gqa_prefill_attend_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    hq, hkv, d, page = 16, 2, 256, 64
    errs = {}
    dec_lens = [700, 320, 0, 450, 129, 33, 511, 256]
    errs["gqa_decode_bf16"], dc, dkw = check_decode(
        torch, gen, dev, bf16, hq, hkv, d, page, dec_lens, frozen={3})
    errs["gqa_decode_f32_window"], *_ = check_decode(
        torch, gen, dev, f32, hq, hkv, d, 16, [5, 17, 48, 0, 9, 16],
        frozen={4}, window=16)
    pre_q, pre_cached = [256, 256, 200, 37], [0, 256, 192, 100]
    errs["gqa_prefill_bf16"], app_b, pc, pkw = check_prefill(
        torch, gen, dev, bf16, hq, hkv, d, page, pre_q, pre_cached, pps=16)
    errs["gqa_prefill_f32"], app_f, *_ = check_prefill(
        torch, gen, dev, f32, hq, hkv, d, page, [300, 1, 150, 1, 37],
        [0, 500, 64, 31, 0], pps=16)
    errs["gqa_prefill_f32_window"], app_w, *_ = check_prefill(
        torch, gen, dev, f32, hq, hkv, d, 16, [17, 8, 33], [3, 16, 5],
        pps=12, window=11)
    lens = [292, 332, 482, 732, 544, 412, 672]
    cases = {}
    for label, dt, window in (("bf16", bf16, None), ("bf16_window", bf16, 128),
                              ("f32", f32, None)):
        e9, e2, c, kw = check_split_decode(torch, gen, dev, dt, hq, hkv, d,
                                           page, lens, window, None,
                                           pps=1024 // page)
        errs[f"gqa_attend_{label}"] = e9
        errs[f"gqa_decode_split_shape_{label}"] = e2
        cases[label] = (c, kw)
    # Two calls, the same bits (fused prefill on a fresh cache each time).
    c0 = pc["cache"].clone()
    pargs = (pc["kv_lens"], pc["pages"], pc["cu"], pc["nseq"], pc["slots"],
             None)
    o1, _ = gqa_fused_prefill(pc["q"], pc["k"], pc["v"], c0.clone(), *pargs,
                              **pkw)
    o2, _ = gqa_fused_prefill(pc["q"], pc["k"], pc["v"], c0.clone(), *pargs,
                              **pkw)
    d1, _ = gqa_fused_decode(dc["q"], dc["k"], dc["v"], dc["cache"].clone(),
                             dc["lens"], dc["pages"], dc["slots"], None, **dkw)
    d2, _ = gqa_fused_decode(dc["q"], dc["k"], dc["v"], dc["cache"].clone(),
                             dc["lens"], dc["pages"], dc["slots"], None, **dkw)
    torch.cuda.synchronize()
    if not (torch.equal(o1, o2) and torch.equal(d1, d2)):
        raise AssertionError("d256: two calls of A1 / A2 differ")
    emit({"phase": "kernels", "check": "attention_d256", "hq": hq,
          "hkv": hkv, "d": d, "page": page, "max_abs_err": errs,
          "append_max_abs_err": max(app_b, app_f, app_w),
          "bf16_tol_atol_rtol": BF16_TOL, "f32_tol_atol_rtol": F32_TOL,
          "cache_bitwise_equal": True, "two_calls_bitwise_equal": True,
          "a9_equals_a2": True, "a1_one_token_rows_equal_a2": True})

    out, device_only, esz = [], {}, 2

    def entry(name, source, replaces, err, fn, plain_fn, lib_fn, b):
        ms = time_ms(torch, fn, 30, flush)
        plain = time_ms(torch, plain_fn, 5, flush)
        lib = time_ms(torch, lib_fn, 30, flush)
        device_only[name] = time_ms(torch, fn, 30, flush, hide_host=True)
        device_only[name + "_library"] = time_ms(torch, lib_fn, 30, flush,
                                                 hide_host=True)
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, max_abs_err=err, ms=ms,
                        plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                        library_ms=lib))

    # A0: the prefill batch's append (749 tokens).
    t_real = pc["t_real"]
    cache = pc["cache"].clone()
    flat = cache.view(-1, 2 * hkv, d)
    rows = interleave_kv(pc["k"], pc["v"])[:t_real].contiguous()
    idx = pc["slots"][:t_real].long()
    entry("kv_append@d256", "parallax_tpu_torch/csrc/kv_append.cu",
          "parallax_tpu/ops/prefill_fused_pallas.py:142", app_b,
          lambda: kv_append(cache, pc["k"], pc["v"], pc["slots"]),
          lambda: reshape_and_cache(cache, pc["k"], pc["v"], pc["slots"]),
          lambda: flat.index_copy_(0, idx, rows),
          bound(2 * t_real * 2 * hkv * d * esz, 0, "bfloat16"))
    # A1 attend-only over the same batch (its append done above).
    args = (pc["q"], cache, pc["kv_lens"], pc["pages"], pc["cu"],
            pc["nseq"], None)
    ctx_tokens = sum(c + q for c, q in zip(pre_q, pre_cached))
    pairs = sum(sum(c + j + 1 for j in range(q))
                for c, q in zip(pre_cached, pre_q))
    entry("gqa_prefill@d256", "parallax_tpu_torch/csrc/gqa_prefill.cu",
          "parallax_tpu/ops/prefill_fused_pallas.py:70",
          errs["gqa_prefill_bf16"],
          lambda: gqa_prefill_attend(*args, **pkw),
          lambda: gqa_prefill_attend_plain(*args, **pkw),
          _sdpa_prefill(torch, dict(pc, cache=cache), hq, hkv, d, page),
          bound(2 * t_real * hq * d * esz + ctx_tokens * 2 * hkv * d * esz,
                4 * hq * d * pairs, "bfloat16"))
    # A2 over the 8 decode rows.
    from parallax_tpu_torch.ops.decode_fused import gqa_fused_decode_plain

    cache_k = dc["cache"].clone()
    dargs = (dc["q"], dc["k"], dc["v"], cache_k, dc["lens"], dc["pages"],
             dc["slots"], None)
    ctx = sum(dec_lens)
    s = len(dec_lens)
    entry("gqa_decode@d256", "parallax_tpu_torch/csrc/gqa_decode.cu",
          "parallax_tpu/ops/decode_fused_pallas.py:314",
          errs["gqa_decode_bf16"],
          lambda: gqa_fused_decode(*dargs, **dkw),
          lambda: gqa_fused_decode_plain(*dargs, **dkw),
          _sdpa_decode(torch, dict(dc, cache=cache_k), hq, hkv, d, page),
          bound(2 * s * hq * d * esz + 2 * s * 2 * hkv * d * esz
                + ctx * 2 * hkv * d * esz, 4 * hq * d * ctx, "bfloat16"))
    # A9 (no sinks: Qwen3-Next has none) and A1 attend-only (K9's route)
    # on the 7 split-path decode rows.
    c, kw = cases["bf16"]
    a9 = (c["q"], c["cache"], c["lens"], c["pages"], None)
    ctx9 = sum(lens)
    b9 = bound(2 * len(lens) * hq * d * esz + ctx9 * 2 * hkv * d * esz,
               4 * hq * d * ctx9, "bfloat16")
    sdpa9 = _sdpa_decode(torch, c, hq, hkv, d, page)
    entry("gqa_attend@d256", "parallax_tpu_torch/csrc/gqa_decode.cu",
          "parallax_tpu/ops/attention_pallas.py:130",
          errs["gqa_attend_bf16"],
          lambda: gqa_decode_attention(*a9, **kw),
          lambda: gqa_decode_attention_plain(*a9, **kw), sdpa9, b9)
    n7 = len(lens)
    r_args = (c["q"], c["cache"], c["lens"], c["pages"],
              torch.arange(n7 + 1, dtype=torch.int32, device=dev),
              torch.tensor([n7], dtype=torch.int32, device=dev), None)
    entry("ragged_attend@d256", "parallax_tpu_torch/csrc/gqa_prefill.cu",
          "parallax_tpu/ops/attention.py:211", errs["gqa_attend_bf16"],
          lambda: gqa_prefill_attend(*r_args, **kw),
          lambda: gqa_prefill_attend_plain(*r_args, **kw), sdpa9, b9)
    return out, device_only


def attention_breakdown(torch, gen, dev, flush) -> dict:
    """Device microseconds per call of each launch of A1, A2, A9, A5, A3,
    A7 and A8 (split, combine, tile, candidate, pick and indexer kernels)
    under torch.profiler, 20 calls with the L2 flushed before each: A1 on
    the 749-token chunk and on the dense decode shape, A2 on 8 rows and on
    7 rows of 2,048-8,192 tokens, A9 at gpt-oss-20b's decode shape, A5 at
    DeepSeek-V3's smoke and long shapes, A3 on the 8-row batch, A7 and A8
    at DeepSeek-V3.2's smoke shape and A7 at its long one."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.decode_fused import (
        gqa_fused_decode,
        indexer_scores_fused,
        mla_fused_decode,
    )
    from parallax_tpu_torch.ops.dsa_decode import paged_token_scores_decode
    from parallax_tpu_torch.ops.gqa_decode import gqa_decode_attention
    from parallax_tpu_torch.ops.kv_cache_ops import reshape_and_cache
    from parallax_tpu_torch.ops.prefill_fused import gqa_prefill_attend
    from parallax_tpu_torch.ops.sampling import fused_sample_topk

    bf16, page = torch.bfloat16, 64

    def a1(q_lens, cached):
        c = _prefill_case(torch, gen, dev, bf16, 28, 4, 128, page, q_lens,
                          cached, 1024 // page)
        reshape_and_cache(c["cache"], c["k"], c["v"], c["slots"])
        return lambda: gqa_prefill_attend(
            c["q"], c["cache"], c["kv_lens"], c["pages"], c["cu"], c["nseq"],
            None, sm_scale=128 ** -0.5)

    def a2(lens):
        c = _decode_case(torch, gen, dev, bf16, 28, 4, 128, page, lens, set())
        return lambda: gqa_fused_decode(
            c["q"], c["k"], c["v"], c["cache"], c["lens"], c["pages"],
            c["slots"], None, sm_scale=128 ** -0.5)

    def a5(lens):
        m = get_preset(DSV3_MODEL).mla
        c, kw = _mla_case(torch, gen, dev, bf16, 128, m.kv_lora_rank,
                          m.qk_rope_head_dim, page, lens, set())
        return lambda: mla_fused_decode(
            c["ql"], c["qp"], c["lat"], c["kpe"], c["cache"], c["lens"],
            c["pages"], c["slots"], **kw)

    def a7(lens, pps, fused):
        di = get_preset(DSV32_MODEL).dsa
        c, kw = _indexer_case(torch, gen, dev, bf16, di.index_n_heads,
                              di.index_head_dim, page, lens, set(), "dsa",
                              pps)
        if fused:
            return lambda: indexer_scores_fused(
                c["q"], c["w"], c["k"], c["cache"], c["lens"], c["pages"],
                c["slots"], **kw)
        return lambda: paged_token_scores_decode(
            c["q"], c["w"], c["cache"], c["lens"], c["pages"], **kw)

    smoke = [292, 332, 482, 732, 544, 412, 672]
    sampler = _sampler_batch(torch, gen, dev,
                             get_preset(DENSE_MODEL).vocab_size)
    sinks = torch.randn((64,), generator=gen, device=dev)
    c9 = _decode_case(torch, gen, dev, bf16, 64, 8, 64, page,
                      [292, 332, 482, 732, 544, 412, 672], set())
    calls = {
        "gqa_prefill": a1([256, 256, 200, 37], [0, 256, 192, 100]),
        "ragged_attend": a1([1] * 7, [291, 331, 481, 731, 543, 411, 671]),
        "gqa_decode": a2([700, 320, 0, 450, 129, 33, 511, 256]),
        "gqa_decode_long": a2([2048, 3000, 4096, 5000, 6144, 7000, 8192]),
        "gqa_attend": lambda: gqa_decode_attention(
            c9["q"], c9["cache"], c9["lens"], c9["pages"], sinks,
            sm_scale=64 ** -0.5),
        "mla_decode": a5([292, 332, 482, 732, 544, 412, 672]),
        "mla_decode_long": a5([MLA_LONG_KEYS] * 7),
        "sample_topk": lambda: fused_sample_topk(*sampler),
        "indexer_fused": a7(smoke, DSA_MAX_MODEL_LEN // page, fused=True),
        "indexer_scores": a7(smoke, DSA_MAX_MODEL_LEN // page, fused=False),
        "indexer_fused_long": a7([INDEXER_LONG_KEYS] * 7, None, fused=True),
    }
    line = {"phase": "kernels", "check": "attention_breakdown_us"}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        per = {}
        for evt in prof.key_averages():
            m = re.search(r"(gqa|mla|sample|indexer)\w*_kernel", evt.key)
            if m and evt.device_type == DeviceType.CUDA:
                per[m.group(0)] = float(evt.self_device_time_total) / 20
        if not per:
            raise AssertionError(f"{name}: the profiler saw no kernel")
        line[name] = per
    return line


def long_context_timed(torch, gen, dev, flush, sinks) -> dict:
    """A2 at the dense shape and A9 at gpt-oss-20b's with 7 rows of
    2,048-8,192 tokens, each beside its byte bound and SDPA (both timed as
    the kernels line times, and device-only)."""
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops.decode_fused import gqa_fused_decode
    from parallax_tpu_torch.ops.gqa_decode import gqa_decode_attention

    lens = [2048, 3000, 4096, 5000, 6144, 7000, 8192]
    ctx, s, page, esz = sum(lens), len(lens), 64, 2
    line = {"phase": "kernels", "check": "long_context_timed", "lens": lens}
    for name, model in (("gqa_decode", DENSE_MODEL),
                        ("gqa_attend", GPTOSS_MODEL)):
        cfg = get_preset(model)
        hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        c = _decode_case(torch, gen, dev, torch.bfloat16, hq, hkv, d, page,
                         lens, frozen=set())
        if name == "gqa_decode":
            def call():
                gqa_fused_decode(c["q"], c["k"], c["v"], c["cache"],
                                 c["lens"], c["pages"], c["slots"], None,
                                 sm_scale=d ** -0.5)
            sdpa = _sdpa_decode(torch, c, hq, hkv, d, page)
            extra = 2 * s * hkv * d * esz
        else:
            def call():
                gqa_decode_attention(c["q"], c["cache"], c["lens"],
                                     c["pages"], sinks, sm_scale=d ** -0.5)
            sdpa = _sdpa_sinks(torch, c, hq, hkv, d, page, sinks, d ** -0.5)
            extra = hq * 4
        b_ms, b_by = bound(2 * s * hq * d * esz + extra
                           + ctx * 2 * hkv * d * esz, 4 * hq * d * ctx,
                           "bfloat16")
        line.update({
            f"{name}_ms": time_ms(torch, call, 30, flush),
            f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by,
            f"{name}_library_ms": time_ms(torch, sdpa, 30, flush),
            f"{name}_device_only_ms": time_ms(torch, call, 30, flush,
                                              hide_host=True),
            f"{name}_library_device_only_ms": time_ms(torch, sdpa, 30, flush,
                                                      hide_host=True),
        })
        del c, sdpa
    return line


def _dense_kv(torch, pages_row, n, cache, hkv, d, page):
    """Gather one sequence's first ``n`` K and V rows: [Hkv, n, D] each."""
    npg = (n + page - 1) // page
    rows = cache[pages_row[:npg].long()].reshape(npg * page, 2 * hkv, d)[:n]
    return rows[:, 0::2].transpose(0, 1), rows[:, 1::2].transpose(0, 1)


def _sdpa_decode(torch, c, hq, hkv, d, page):
    """The yardstick: one scaled_dot_product_attention call over the
    gathered, padded dense K/V of the decode rows (masking the padding)."""
    import torch.nn.functional as F

    lens = c["lens"].tolist()
    s, lmax = len(lens), max(lens)
    k = torch.zeros((s, hkv, lmax, d), dtype=c["q"].dtype, device=c["q"].device)
    v = torch.zeros_like(k)
    mask = torch.zeros((s, 1, 1, lmax), dtype=torch.bool, device=k.device)
    for i, n in enumerate(lens):
        if n:
            k[i, :, :n], v[i, :, :n] = _dense_kv(torch, c["pages"][i], n,
                                                 c["cache"], hkv, d, page)
            mask[i, :, :, :n] = True
        else:
            mask[i, :, :, 0] = True
    q = c["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def _sdpa_prefill(torch, c, hq, hkv, d, page):
    """The yardstick for prefill: one SDPA call over padded per-sequence
    queries and dense K/V with a causal, ragged mask."""
    import torch.nn.functional as F

    q_lens, cached = c["q_lens"], c["cached"]
    s = len(q_lens)
    qmax = max(q_lens)
    lmax = max(a + b for a, b in zip(q_lens, cached))
    dev, dt = c["q"].device, c["q"].dtype
    q = torch.zeros((s, hq, qmax, d), dtype=dt, device=dev)
    k = torch.zeros((s, hkv, lmax, d), dtype=dt, device=dev)
    v = torch.zeros_like(k)
    mask = torch.zeros((s, 1, qmax, lmax), dtype=torch.bool, device=dev)
    cu = c["cu"].tolist()
    for i in range(s):
        n = q_lens[i] + cached[i]
        q[i, :, :q_lens[i]] = c["q"][cu[i]:cu[i + 1]].transpose(0, 1)
        k[i, :, :n], v[i, :, :n] = _dense_kv(torch, c["pages"][i], n,
                                             c["cache"], hkv, d, page)
        qpos = torch.arange(cached[i], n, device=dev)
        mask[i, 0, :q_lens[i], :n] = (
            torch.arange(n, device=dev)[None, :] <= qpos[:, None]
        )
        mask[i, 0, q_lens[i]:, 0] = True
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


# ---------------------------------------------------------------------------
# Phases 4 and 5: serving
# ---------------------------------------------------------------------------


def make_requests(vocab: int, long_prompt: int = 0):
    import random

    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    rng = random.Random(2024)
    prefix = [rng.randrange(1, vocab) for _ in range(256)]
    # r0 donates the shared 256-token prefix (its prefill finishes no later
    # than any other admitted row's); r7 waits for a batch slot
    # (max_batch_size 7) and is admitted once r0 released, so it must hit.
    lens = [260, 300, 450, 700, 512, 380, 640]
    prompts = [prefix + [rng.randrange(1, vocab) for _ in range(4)]]
    prompts += [[rng.randrange(1, vocab) for _ in range(n)] for n in lens[1:]]
    prompts.append(prefix + [rng.randrange(1, vocab) for _ in range(150)])
    sampled = {2: (0.8, 20, 11), 4: (1.0, 64, 5), 6: (0.7, 8, 9)}
    if long_prompt:
        # r8, greedy, past the DSA indexer's top-k budget.
        prompts.append([rng.randrange(1, vocab) for _ in range(long_prompt)])
    reqs = []
    for i, p in enumerate(prompts):
        temp, top_k, seed = sampled.get(i, (0.0, 0, None))
        reqs.append(Request(
            f"r{i}", prompt_ids=p,
            sampling_params=SamplingParams(
                temperature=temp, top_k=top_k, seed=seed, max_new_tokens=32,
                ignore_eos=True,
            ),
        ))
    return reqs, sampled


# serve_three's short K1_SYNC run: r0 (greedy) and r2 (seeded) of the mix.
K1_SHORT_ROWS = (0, 2)
K1_SHORT_NEW = 8


def k1_short_mix(vocab: int):
    """K1_SHORT_ROWS of the mix, each for K1_SHORT_NEW tokens, as
    ``serve``'s ``requests`` (requests, sampled)."""
    reqs, sampled = make_requests(vocab)
    short = [reqs[i] for i in K1_SHORT_ROWS]
    for r in short:
        r.sampling_params.max_new_tokens = K1_SHORT_NEW
    return short, {j: sampled[i] for j, i in enumerate(K1_SHORT_ROWS)
                   if i in sampled}


def engine_config(fused: bool, max_model_len: int = 1024, **over):
    from parallax_tpu_torch.runtime.engine import EngineConfig

    return EngineConfig(**{
        **dict(page_size=64, num_pages=192, max_batch_size=7,
               max_num_tokens_per_batch=2048, prefill_chunk_size=256,
               max_model_len=max_model_len, kv_dtype="bfloat16",
               enable_prefix_cache=True, decode_fused=fused,
               prefill_fused=fused),
        **over})


def serve(torch, bounds, params, cfg, dev, fused: bool, long_prompt: int = 0,
          max_model_len: int = 1024, model_kw=None, engine_kw=None,
          cuda_graphs=None, requests=None, use_native=None, draft=None,
          on_engines=None, grammar=True):
    """Serve the request mix: a single stage through the one-in-flight
    ``drive_step`` loop, a pipeline through ``step_round``. ``engine_kw``
    overrides the engine config (e.g. ``K1_SYNC``); ``cuda_graphs`` is the
    engine's switch (None = on, on the card). ``requests`` = (requests,
    sampled) serves another mix, with the byte tokenizer's grammar
    vocabulary wired into the last stage. ``use_native`` picks the cache
    manager, ``draft`` (a DraftProposer) goes to the head, and
    ``on_engines(engines)`` runs before the first submit."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine, drive_step
    from parallax_tpu_torch.runtime.pipeline import InProcessPipeline

    engines = []
    for s, e in bounds:
        p = {"layers": params["layers"][s:e]}
        last = e == cfg.num_hidden_layers
        if s == 0 or (last and "lm_head" not in params):
            p["embed_tokens"] = params["embed_tokens"]
        if last:
            p["norm"] = params["norm"]
            if "lm_head" in params:
                p["lm_head"] = params["lm_head"]
        engines.append(StageEngine(
            create_stage_model(cfg, s, e, **(model_kw or {})), p,
            engine_config(fused, max_model_len, **(engine_kw or {})),
            device=dev, cuda_graphs=cuda_graphs, use_native=use_native,
            draft=draft if s == 0 else None))
    pipe = InProcessPipeline(engines)
    if on_engines is not None:
        on_engines(engines)
    if requests is None:
        reqs, sampled = make_requests(cfg.vocab_size, long_prompt)
    else:
        reqs, sampled = requests
        if grammar:
            engines[-1].set_grammar_vocab(*GRAMMAR_VOCAB)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for r in reqs:
        r.arrival_time = t0
        pipe.submit(r)
    if len(engines) == 1:
        pending = None
        while engines[0].has_work() or pending is not None:
            _, pending = drive_step(engines[0], pending)
    else:
        pipe.run_until_complete()
    torch.cuda.synchronize()
    return reqs, sampled, engines, t0, time.monotonic()


def stream_metrics(reqs, t0: float, t1: float) -> dict:
    """TTFT per request (submit to first committed token), and decode
    throughput: tokens committed after each request's first token over the
    span from the first first-token to the end of the run."""
    ttft = [r.first_token_time - t0 for r in reqs]
    first = min(r.first_token_time for r in reqs)
    decode_tokens = sum(len(r.output_ids) - 1 for r in reqs)
    return {"ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
            # r7 waits for a batch slot: a window in flight delays it.
            "ttft_s_r7": ttft[7] if len(ttft) > 7 else None,
            "wall_s": t1 - t0,
            "output_tok_per_s": sum(len(r.output_ids) for r in reqs)
            / (t1 - t0),
            "decode_tok_per_s": decode_tokens / (t1 - first)}


def one_shot_rows(torch, model, params, r, dev, max_len=1024, lora=None):
    """``model``'s logits at each of ``r``'s output positions (a copy, so
    the whole forward's logits are freed), from one forward over prompt +
    outputs; ``lora`` is the forward's ``BatchInputs.lora`` (an adapter's
    delta on the plain path)."""
    from parallax_tpu_torch.runtime.batch import BucketSpec, assemble
    from parallax_tpu_torch.runtime.request import Request
    from parallax_tpu_torch.runtime.scheduler import BatchPlan, ScheduledSeq

    page = 64
    ctx = r.prompt_ids + r.output_ids[:-1]
    n = len(ctx)
    npg = (n + page - 1) // page
    ref_req = Request("ref", prompt_ids=list(ctx))
    ref_req.page_ids = list(range(1, npg + 1))
    # A hybrid model's linear layers: state slot 1, reset (a first chunk).
    hybrid = getattr(model, "has_linear_layers", False)
    ref_req.state_slot = 1
    plan = BatchPlan([ScheduledSeq(request=ref_req, num_new_tokens=n,
                                   token_ids=list(ctx), context_len=n)])
    spec = BucketSpec.build(max_len, 1, max_len, page)
    inputs = assemble(plan, spec, page, dev, gather_all_logits=True,
                      with_dense_map=hybrid)
    inputs.lora = lora
    kv = model.new_kv_caches(npg + 1, page, params["norm"]["weight"].dtype,
                             dev, **({"num_state_slots": 1} if hybrid
                                     else {}))
    with torch.no_grad():
        logits, _ = model(params, kv, inputs)
    p0 = len(r.prompt_ids) - 1
    return logits[p0:p0 + len(r.output_ids)].clone()


def greedy_check(torch, model_full, params, reqs, sampled, dev,
                 tol=None, max_len=1024, model_alt=None, lora_of=None):
    """Tie-tolerant check of every greedy stream against the plain path
    (``model_full`` with the plain attention, and for an MoE model the
    plain grouped product): one forward per row over prompt + outputs with
    logits at every position; each token must be within ``tol`` of that
    position's argmax (no limit when ``tol`` is None). Returns the largest
    gap seen, how many tokens were off by GREEDY_TOL or more, the median
    over positions of the argmax minus the row's median logit (how far
    below the argmax a wrong token typically sits), and, when ``model_alt``
    is given, the same one-shot forward teacher-forced through it: the
    largest logit difference from ``model_full``'s at any output position
    and how many positions share their argmax (no limit; None without
    ``model_alt``). ``lora_of(r)`` gives each row's adapter field for the
    plain forward (None: no delta)."""
    worst, over, spreads = 0.0, 0, []
    alt = None if model_alt is None else {
        "largest_logit_diff": 0.0, "positions": 0, "argmax_equal": 0}
    for i, r in enumerate(reqs):
        if i in sampled:
            continue
        rows = one_shot_rows(torch, model_full, params, r, dev, max_len,
                             None if lora_of is None else lora_of(r))
        toks = torch.tensor(r.output_ids, device=dev)
        best = rows.max(dim=-1).values
        gaps = best - rows.gather(1, toks[:, None])[:, 0]
        spreads.append(best - rows.median(dim=-1).values)
        g = float(gaps.max())
        worst = max(worst, g)
        over += int((gaps >= GREEDY_TOL).sum())
        if tol is not None and g >= tol:
            raise AssertionError(
                f"{r.request_id}: greedy token off the plain path's argmax "
                f"by {g} (tolerance {tol})"
            )
        if alt is not None:
            rows_alt = one_shot_rows(torch, model_alt, params, r, dev,
                                     max_len)
            alt["largest_logit_diff"] = max(
                alt["largest_logit_diff"],
                float((rows_alt.float() - rows.float()).abs().max()))
            alt["positions"] += rows.shape[0]
            alt["argmax_equal"] += int(
                (rows_alt.argmax(-1) == rows.argmax(-1)).sum())
            del rows_alt
    return worst, over, float(torch.cat(spreads).median()), alt


def forward_steps(summary) -> tuple[int, int]:
    """A run's forward steps from the engine's dispatch counts: (decode
    steps, the single ones and the decode windows' m * k each, multi-token
    steps: prefill and the speculative verify forwards, those of the
    speculative windows' m * k and of the K = 1 fallback)."""
    totals = summary["dispatch_total"]
    decode = sum(totals.get(f"{summary['impl']}/{path}", 0)
                 for path in ("decode", "multistep"))
    return decode, sum(totals.get(f"{summary['prefill_impl']}/{path}", 0)
                       for path in ("prefill", "spec", "spec_verify"))


def sampler_launches(summary) -> dict:
    """A3 launches once a fused sampler call; the noise kernel once a
    sampler call of either kind (an all-greedy step draws no noise)."""
    totals = summary["dispatch_total"]
    return {"sample_topk": totals.get("cuda-fused/sample", 0),
            "gumbel_rows": sum(n for key, n in totals.items()
                               if key.endswith("/sample"))}


def check_launches(phase, mode, launches, want, summary) -> None:
    """Every kernel's launches exactly as ``want`` says (0 where it says
    nothing), graph replays included, plus the launches of the graphs'
    warm-up steps (one eager step a captured graph, from the engine's
    summary)."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    want = {**{k: 0 for k in ck.KERNELS}, **want}
    for k, n in summary.get("graphs", {}).get("warmup_launches", {}).items():
        want[k] += n
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"{phase} {mode}: launches (got, want) {bad}")


def check_windows(phase, mode, summary, graphs: bool) -> None:
    """The run served decode windows, each step a graph replay when
    ``graphs``, else the eager loop."""
    windows = summary["dispatch_total"].get(f"{summary['impl']}/multistep", 0)
    replays = summary.get("graphs", {}).get("replays", 0)
    if windows <= 0 or summary["cuda_graphs"] != graphs or (
            graphs and replays != windows):
        raise AssertionError(f"{phase} {mode}: {windows} window steps, "
                             f"graphs {summary['cuda_graphs']}, {replays} "
                             f"replays")


def gqa_expected(mode, summary, n) -> dict:
    """The dense GQA path's launches: fused runs A2 once per layer and
    decode step and A0 + A1 per layer and prefill step; split runs A1
    attend-only (K9's route) per layer and step; each run's sampler
    launches as ``sampler_launches`` says; plain runs nothing else."""
    decode, prefill = forward_steps(summary)
    want = sampler_launches(summary)
    if mode.startswith("fused"):
        want.update(gqa_decode=n * decode, kv_append=n * prefill,
                    gqa_prefill=n * prefill)
    elif mode == "split":
        want["gqa_prefill"] = n * (decode + prefill)
    return want


# serve's runs: (mode, fused kernels, model kwargs, engine kwargs, graphs).
DENSE_RUNS = (
    ("fused", True, None, None, None),
    ("fused_eager", True, None, None, False),
    ("fused_k1_sync", True, None, K1_SYNC, None),
    ("split", False, None, None, None),
    ("plain", False, dict(use_kernels=False), K1_SYNC, None),
)


def dense_tree(torch, dev, phase: str):
    """Qwen2.5-7B's random bf16 tree at full width and depth (a seeded
    generator on the card), and the plain reference model (the plain split
    path even on the card)."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.presets import get_preset

    cfg = get_preset(DENSE_MODEL)
    n = cfg.num_hidden_layers
    model_full = create_stage_model(cfg, 0, n, use_kernels=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = model_full.init_params(gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(
        t.numel() for t in _leaves(params)
    )
    emit({"phase": phase, "weights": "random bf16", "params": n_params,
          "init_s": round(time.monotonic() - t0, 3), "layers": n})
    return cfg, model_full, params


def copy_tree(tree):
    """A tree's dicts and lists copied, its tensors shared: quantizing the
    copy in place leaves the original tree as it was."""
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v) for v in tree]
    return tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


# quant_serve's runs on the quantized tree: (bits, mode, fused kernels,
# model kwargs, engine kwargs). The K1_SYNC runs (fused and plain) serve
# K1_SHORT_ROWS of the mix for K1_SHORT_NEW tokens.
QUANT_RUNS = (
    (8, "fused", True, None, None),
    (8, "fused_k1_sync", True, None, K1_SYNC),
    (8, "plain", False, dict(use_kernels=False), K1_SYNC),
    (4, "fused", True, None, None),
)


def quant_expected(mode, summary, n_linear: int) -> dict:
    """A10's launches: ``n_linear`` quantized products a forward step (the
    layers' and the lm_head's) on the kernel runs, none on the plain one."""
    if not mode.startswith("fused"):
        return {}
    return {"quant_linear": n_linear * sum(forward_steps(summary))}


def phase_quant_serve(torch, dev, card: str, cfg, model_full, params):
    """Qwen2.5-7B at full width and all 28 layers, weight-only quantized on
    the card from serve's bf16 tree (``quantize_tree`` on a copy of its
    dicts, group QUANT_GROUP): int8 served fused with the defaults, with
    K1_SYNC and plain (``use_kernels=False``: the dequantize-then-multiply
    path, no A10), each two rows for 8 tokens, int4 fused with the
    defaults.
    Launches exact (A0-A3 as serve's, A10 seven times a layer plus the
    lm_head each forward step, graph replays included); the fused runs'
    greedy rows within GREEDY_TOL of the plain one-shot logits of the same
    quantized tree; the tree's bytes against the bf16 tree's. Returns the
    int8 fused run's launches."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.quant import quantize_tree

    n = cfg.num_hidden_layers
    bf16_bytes = tree_bytes(params)
    trees, out = {}, None
    for bits, mode, fused, model_kw, engine_kw in QUANT_RUNS:
        if bits not in trees:
            trees.clear()
            free_device_memory(torch)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trees[bits] = quantize_tree(copy_tree(params), bits=bits,
                                        group_size=QUANT_GROUP,
                                        dtype=torch.bfloat16)
            torch.cuda.synchronize()
            q_bytes = tree_bytes(trees[bits])
            emit({"phase": "quant_serve", "bits": bits,
                  "group_size": QUANT_GROUP,
                  "quantize_on_card_s": time.monotonic() - t0,
                  "tree_bytes": q_bytes, "bf16_tree_bytes": bf16_bytes,
                  "ratio": q_bytes / bf16_bytes,
                  "mem_free_gb": torch.cuda.mem_get_info()[0] / 1e9,
                  "card": card})
        qparams = trees[bits]
        short = engine_kw is K1_SYNC
        ck.reset_launches()
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, n)], qparams, cfg, dev, fused=fused,
            model_kw=model_kw, engine_kw=engine_kw,
            requests=k1_short_mix(cfg.vocab_size) if short else None,
            grammar=False)
        launches = ck.launches()
        new = K1_SHORT_NEW if short else 32
        for r in reqs:
            if r.status.value != "finished_length" or \
                    len(r.output_ids) != new:
                raise AssertionError(f"quant_serve int{bits} {mode} "
                                     f"{r.request_id}: {r.status.value}, "
                                     f"{len(r.output_ids)} tokens")
        summary = engines[0].kernel_dispatch_summary()
        check_launches("quant_serve", f"{mode}_int{bits}", launches, {
            **gqa_expected(mode, summary, n),
            **quant_expected(mode, summary, 7 * n + 1)}, summary)
        if engine_kw is None:
            check_windows("quant_serve", mode, summary, True)
        del engines
        line = {"phase": "quant_serve", "run": f"{mode}_int{bits}",
                "requests": len(reqs), "engine": engine_kw or "defaults",
                "launches": launches, "steps": sum(forward_steps(summary)),
                "dispatch": summary,
                "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                **stream_metrics(reqs, t0, t1), "card": card}
        if mode == "fused":
            worst, over, *_ = greedy_check(torch, model_full, qparams, reqs,
                                           sampled, dev, tol=GREEDY_TOL)
            line.update(greedy_vs_plain="pass", largest_logit_gap=worst,
                        tolerance=GREEDY_TOL,
                        plain="the same quantized tree, use_kernels=False",
                        **{f"tokens_off_by_{GREEDY_TOL}_or_more": over})
            if bits == 8:
                out = launches
        emit(line)
    trees.clear()
    free_device_memory(torch)
    return out


# -- lora_serve: per-request LoRA on serve's tree ----------------------------

# The adapters drawn from the seed: (name, rank, sites, seed). "all": the
# seven projections of every layer; "attn_half": the four attention
# projections of every other layer (the union of sites, and rank 8 padded
# to the set's 16).
LORA_ADAPTERS = (("r16", 16, "all", 101), ("r8", 8, "all", 102),
                 ("attn16", 16, "attn_half", 103))
# Registered after the graphs were captured, past the LRU cap.
LORA_FOURTH = ("late16", 16, "all", 104)
LORA_MAX_ADAPTERS = 3
# The mix's adapter row by row (make_requests seeds r2, r4 and r6): two
# base rows and two per adapter, each adapter with a greedy row; r7 shares
# r0's 256-token prefix under another adapter than r0's.
LORA_LIDS = (None, "r16", "r16", "r8", None, "r8", "attn16", "attn16")
# The wrong adapter a mutant serves each row with.
LORA_WRONG = {"r16": "r8", "r8": "attn16", "attn16": "r16"}
# PEFT alpha / r of every module, and B's draw (A is N(0, 1) * in**-0.5):
# a delta of about a quarter of the base projection, which moves tokens.
LORA_SCALE = 2.0
LORA_B_STD = 0.03
LORA_PROJ_DIMS = ("self_attn.q_proj", "self_attn.k_proj",
                  "self_attn.v_proj", "self_attn.o_proj", "mlp.gate_proj",
                  "mlp.up_proj", "mlp.down_proj")


def lora_tree(torch, dev, cfg, rank: int, sites: str, seed: int) -> dict:
    """An adapter tree ``{layer: {path: (A, B, scale)}}`` drawn on the card
    from ``seed`` at the config's full widths."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    q = cfg.num_attention_heads * cfg.head_dim
    kv = cfg.num_key_value_heads * cfg.head_dim
    dims = dict(zip(LORA_PROJ_DIMS, ((h, q), (h, kv), (h, kv), (q, h),
                                     (h, inter), (h, inter), (inter, h))))
    paths = [p for p in LORA_PROJ_DIMS
             if sites == "all" or p.startswith("self_attn.")]
    step = 1 if sites == "all" else 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree = {}
    for li in range(0, cfg.num_hidden_layers, step):
        tree[li] = {}
        for path in paths:
            i, o = dims[path]
            a = torch.randn((rank, i), generator=gen, device=dev) * i ** -0.5
            b = torch.randn((o, rank), generator=gen, device=dev) * LORA_B_STD
            tree[li][path] = (a, b, LORA_SCALE)
    return tree


def lora_mix(vocab: int, lids=LORA_LIDS):
    """make_requests' mix with an adapter on each row (``lids``)."""
    reqs, sampled = make_requests(vocab)
    for r, lid in zip(reqs, lids):
        r.lora_id = lid
    return reqs, sampled


def lora_register(trees, bounds):
    """``on_engines`` for serve: each stage gets its slice of every
    adapter."""
    def register(engines):
        for eng, (s, e) in zip(engines, bounds):
            for name, tree in trees.items():
                eng.load_adapter(name, {li - s: t for li, t in tree.items()
                                        if s <= li < e})
    return register


def lora_drive(engine, reqs) -> None:
    """Submit ``reqs`` to a served engine and drive it until they finish."""
    from parallax_tpu_torch.runtime.engine import drive_step

    for r in reqs:
        engine.submit(r)
    pending = None
    while engine.has_work() or pending is not None:
        _, pending = drive_step(engine, pending)


def lora_delta_ms(torch, dev, cfg, params, field) -> dict:
    """Device ms of one decode step's LoRA deltas at the mix's decode shape
    (7 rows in the tree's dtype, the mixed field: 7 sites x layers),
    beside the same step's base projections: each captured in a CUDA
    graph, as the window replays it, and the replay timed with CUDA
    events (the eager loop's enqueue of ~1,400 small launches would
    otherwise sit inside the interval); the eager interval beside it."""
    from parallax_tpu_torch.models import layers as L
    from parallax_tpu_torch.ops.lora import select_slot

    rows = 7
    sel = select_slot(field)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    xs = {}
    for path in LORA_PROJ_DIMS:
        grp, proj = path.split(".")
        w = params["layers"][0][grp][proj]["weight"]
        xs[path] = torch.randn((rows, w.shape[1]), generator=gen,
                               device=dev).to(w.dtype)
    sites = [(li, path) for li in range(cfg.num_hidden_layers)
             for path in LORA_PROJ_DIMS if path in sel.get(str(li), {})]

    def deltas():
        for li, path in sites:
            L._lora_delta(xs[path], sel[str(li)][path])

    def shrinks():
        # The first product alone: every site's rows against every stacked
        # adapter's A (f32), the part a gathered kernel would shrink most.
        for li, path in sites:
            a = sel[str(li)][path]["A"]
            torch.nn.functional.linear(xs[path].float(),
                                       a.reshape(-1, a.shape[-1]))

    def base():
        for li, path in sites:
            grp, proj = path.split(".")
            torch.nn.functional.linear(
                xs[path], params["layers"][li][grp][proj]["weight"])

    def graphed(fn):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            fn()
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        return graph

    g_delta, g_shrink, g_base = graphed(deltas), graphed(shrinks), \
        graphed(base)
    return {"sites": len(sites), "rows": rows,
            "delta_ms_per_step": time_ms(torch, g_delta.replay, 20),
            "shrink_ms_per_step": time_ms(torch, g_shrink.replay, 20),
            "base_projection_ms_per_step": time_ms(torch, g_base.replay, 20),
            "delta_ms_eager_interval": time_ms(torch, deltas, 20,
                                               hide_host=True)}


def phase_lora_serve(torch, dev, card: str, cfg, model_full, params):
    """Per-request LoRA on serve's Qwen2.5-7B tree (28 layers, bf16) with
    three adapters drawn from the seed (LORA_ADAPTERS: rank 16 on every
    projection, rank 8 on the same, rank 16 on attention of every other
    layer), the mix's rows two base and two per adapter (LORA_LIDS).
    Runs: the mix with every row base, with no adapter registered and
    with the three registered (bitwise: registration leaves base traffic
    as it was); the adapter mix with the defaults (K = 8 windows from CUDA graphs, overlap,
    the native manager; LORA_MAX_ADAPTERS), with graphs off and with
    K1_SYNC (both bitwise the defaults' streams); r16's rows alone
    (grouped decode); a 14 + 14 pipeline. Checks: launches exact
    (gqa_expected); every adapter row's greedy stream within GREEDY_TOL of
    the plain path with its adapter, and above it with no delta and with
    the wrong adapter's slot (the mix's base rows are held to the plain
    path without a delta: they share batches with adapter rows, so their
    GEMMs see other row counts than in the all-base run); r7
    (r0's prefix, another adapter) no prefix hit, a repeat under its
    adapter a hit, under another none; a fourth adapter registered after
    the graphs were captured evicts an idle one and serves its own
    stream. Figures: decode tok/s against base, the step's delta device
    ms, graph captures and seconds."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.lora import AdapterSet
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    t_phase = time.monotonic()
    n = cfg.num_hidden_layers
    trees = {name: lora_tree(torch, dev, cfg, rank, sites, seed)
             for name, rank, sites, seed in LORA_ADAPTERS}
    ref = AdapterSet(device=dev)
    for name, tree in trees.items():
        ref.register(name, tree)

    def lora_of(r):
        return None if r.lora_id is None else ref.batch_field(r.lora_id)

    def check_rows(mode, reqs):
        for r in reqs:
            if r.status.value != "finished_length" or len(
                    r.output_ids) != r.sampling_params.max_new_tokens:
                raise AssertionError(f"lora_serve {mode} {r.request_id} "
                                     f"({r.lora_id}): {r.status.value}, "
                                     f"{len(r.output_ids)} tokens")

    runs, lines = {}, {}
    full = [(0, n)]
    for mode, lids, engine_kw, graphs in (
            ("base", (None,) * 8, None, None),
            ("base_registered", (None,) * 8, None, None),
            ("lora", LORA_LIDS, dict(lora_max_adapters=LORA_MAX_ADAPTERS),
             None),
            ("lora_eager", LORA_LIDS, None, False),
            ("lora_k1_sync", LORA_LIDS, K1_SYNC, None),
            ("lora_grouped", ("r16", "r16"), None, None)):
        reqs, sampled = lora_mix(cfg.vocab_size, lids)
        if mode == "lora_grouped":
            reqs, sampled = reqs[1:3], {1: sampled[2]}
        ck.reset_launches()
        t_cap = time.monotonic()
        reqs, sampled, engines, t0, t1 = serve(
            torch, full, params, cfg, dev, fused=True, engine_kw=engine_kw,
            cuda_graphs=graphs, requests=(reqs, sampled), grammar=False,
            on_engines=(None if mode == "base"
                        else lora_register(trees, full)))
        if mode == "base_registered":
            # Registration leaves base traffic as it was, to the bit.
            differ = [r.request_id for r, b in zip(reqs, runs["base"])
                      if r.output_ids != b.output_ids]
            if differ:
                raise AssertionError(f"lora_serve: registered adapters "
                                     f"moved base rows {differ}")
        launches = ck.launches()
        check_rows(mode, reqs)
        summary = engines[0].kernel_dispatch_summary()
        check_launches("lora_serve", mode, launches,
                       gqa_expected("fused", summary, n), summary)
        if engine_kw is None or mode == "lora":
            check_windows("lora_serve", mode, summary, graphs is not False)
        runs[mode] = reqs
        lines[mode] = line = {
            "phase": "lora_serve", "run": mode, "requests": len(reqs),
            "adapters": list(lids), "engine": engine_kw or "defaults",
            "launches": launches, "steps": sum(forward_steps(summary)),
            "graphs": summary.get("graphs"), "cache": engines[0].cache_stats(),
            "serve_s_with_captures": t1 - t_cap,
            **stream_metrics(reqs, t0, t1), "card": card}
        if mode == "lora":
            eng = engines[0]
            emit(line)
            # r7 shares r0's prefix under another adapter: no hit. Its
            # prompt again under its adapter hits, under another does not.
            if reqs[7].num_cached_tokens != 0:
                raise AssertionError("lora_serve: r7 hit r0's pages across "
                                     "adapters")
            again = [Request(f"again_{lid}", prompt_ids=list(
                reqs[7].prompt_ids), lora_id=lid,
                sampling_params=SamplingParams(temperature=0.0,
                                               max_new_tokens=4,
                                               ignore_eos=True))
                for lid in ("attn16", "r8")]
            lora_drive(eng, again)
            hits = {r.lora_id: r.num_cached_tokens for r in again}
            if hits["attn16"] <= 0 or hits["r8"] != 0:
                raise AssertionError(f"lora_serve: repeat hits {hits}")
            # The fourth adapter after capture, past the cap (the later
            # runs keep the three: the stack's n * r is the contraction's
            # length, so a fourth adapter would move their bits).
            captured = eng.kernel_dispatch_summary().get(
                "graphs", {}).get("captured")
            name, rank, sites, seed = LORA_FOURTH
            fourth = lora_tree(torch, dev, cfg, rank, sites, seed)
            late_ref = AdapterSet(device=dev)
            late_ref.register(name, fourth)
            before = eng.adapter_names()
            eng.load_adapter(name, fourth)
            names = eng.adapter_names()
            if len(names) != LORA_MAX_ADAPTERS or name not in names:
                raise AssertionError(f"lora_serve: after {name}: {names}")
            late = lora_mix(cfg.vocab_size, (name,))[0][:1]
            late[0].request_id = "late"
            t_late = time.monotonic()
            lora_drive(eng, late)
            check_rows("lora", late)
            late_worst, *_ = greedy_check(
                torch, model_full, params, late, {}, dev, tol=GREEDY_TOL,
                lora_of=lambda r: late_ref.batch_field(r.lora_id))
            del late_ref, fourth
            emit({"phase": "lora_serve", "check": "after_capture",
                  "prefix_hits_repeat": hits,
                  "r7_cached_tokens_across_adapters":
                      reqs[7].num_cached_tokens,
                  "registered": name, "evicted": sorted(set(before)
                                                        - set(names)),
                  "graphs_before": captured,
                  "graphs_after": eng.kernel_dispatch_summary().get(
                      "graphs", {}).get("captured"),
                  "late_row_s": time.monotonic() - t_late,
                  "greedy_vs_plain": "pass",
                  "largest_logit_gap": late_worst,
                  "tolerance": GREEDY_TOL, "card": card})
            del eng
        else:
            emit(line)
        del engines
    # Every adapter row within the limit of the plain path with its own
    # adapter; the base rows bitwise the all-base run's.
    lora = runs["lora"]
    sampled = {i for i, _ in enumerate(lora) if i in (2, 4, 6)}
    worst, over, *_ = greedy_check(torch, model_full, params, lora,
                                   sampled, dev, tol=GREEDY_TOL,
                                   lora_of=lora_of)
    greedy_adapter = [r for i, r in enumerate(lora)
                      if i not in sampled and r.lora_id is not None]
    mutants = {}
    for label, pick in (("no_delta", lambda r: None),
                        ("wrong_adapter", lambda r: ref.batch_field(
                            LORA_WRONG[r.lora_id]))):
        g, *_ = greedy_check(torch, model_full, params, greedy_adapter, {},
                             dev, lora_of=pick)
        if g < GREEDY_TOL:
            raise AssertionError(f"lora_serve: the {label} mutant stays "
                                 f"within the limit ({g})")
        mutants[label] = g
    base_rows = [i for i, lid in enumerate(LORA_LIDS) if lid is None]
    partings = {}
    for mode in ("lora_eager", "lora_k1_sync"):
        partings[mode] = {
            r.request_id: _first_parting(torch, model_full, params, r, e, dev,
                                         lora=lora_of(r))
            for r, e in zip(lora, runs[mode]) if r.output_ids != e.output_ids}
    if any(partings.values()):
        emit({"phase": "lora_serve", "check": "bitwise", "partings":
              partings, "card": card})
        raise AssertionError(f"lora_serve: graphs off or K1_SYNC differ "
                             f"from the defaults: {partings}")
    grouped = runs["lora_grouped"]
    g_worst, *_ = greedy_check(torch, model_full, params, grouped, {1: 0},
                               dev, tol=GREEDY_TOL, lora_of=lora_of)
    emit({"phase": "lora_serve", "check": "greedy",
          "greedy_vs_plain_with_adapter": "pass", "largest_logit_gap": worst,
          f"tokens_off_by_{GREEDY_TOL}_or_more": over,
          "mutant_largest_logit_gap": mutants, "tolerance": GREEDY_TOL,
          "all_base_mix_bitwise_with_adapters_registered": len(
              runs["base_registered"]),
          "mix_base_rows_identical_to_all_base_run": sum(
              lora[i].output_ids == runs["base"][i].output_ids
              for i in base_rows),
          "eager_and_k1_sync_bitwise_defaults": len(lora),
          "grouped_decode_largest_logit_gap": g_worst,
          "grouped_rows_identical_to_mixed": sum(
              a.output_ids == b.output_ids for a, b in zip(grouped,
                                                           lora[1:3])),
          "decode_tok_per_s": {m: lines[m]["decode_tok_per_s"]
                               for m in ("base", "lora")},
          "card": card})
    # The two-stage pipeline (14 + 14): the single stage's adapter streams.
    bounds = [(0, n // 2), (n // 2, n)]
    ck.reset_launches()
    pipe, _, engines, t0, t1 = serve(
        torch, bounds, params, cfg, dev, fused=True,
        requests=lora_mix(cfg.vocab_size), grammar=False,
        on_engines=lora_register(trees, bounds))
    check_rows("pipeline", pipe)
    del engines
    p_worst, *_ = greedy_check(torch, model_full, params, pipe, sampled,
                               dev, tol=GREEDY_TOL, lora_of=lora_of)
    emit({"phase": "lora_serve", "run": f"pipeline_{n // 2}_{n - n // 2}",
          "greedy_vs_plain_with_adapter": "pass",
          "largest_logit_gap": p_worst, "tolerance": GREEDY_TOL,
          "rows_identical_to_single_stage": sum(
              a.output_ids == b.output_ids for a, b in zip(pipe, lora)),
          "rows": len(pipe), **stream_metrics(pipe, t0, t1), "card": card})
    emit({"phase": "lora_serve", "check": "delta_device_ms",
          **lora_delta_ms(torch, dev, cfg, params, ref.mixed_batch_field(
              [0, 1, 2, 3, 0, 1, 2])), "adapters": len(trees),
          "card": card})
    emit({"phase": "lora_serve", "seconds": time.monotonic() - t_phase,
          "card": card})
    free_device_memory(torch)


def phase_serve(torch, dev, card: str, cfg, model_full, params):
    """Qwen2.5-7B served five times: fused with the engine's defaults (the
    K-step window on the one-in-flight loop, replayed from CUDA graphs),
    the same with graphs off (its greedy and seeded rows must be bitwise
    the graphs run's), the same kernels in the parent's configuration (K=1,
    synchronous), split (A1 attend-only once per layer and forward step,
    the counterpart of the bundled ragged_paged_attention) and plain (no
    kernel but the sampler's noise). Every kernel's launches are exact.
    The kernel runs' greedy streams must agree with the plain model's
    logits. Returns the fused run and each run's launches."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    n = cfg.num_hidden_layers
    runs, launches_of = {}, {}
    for mode, fused, model_kw, engine_kw, graphs in DENSE_RUNS:
        ck.reset_launches()
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, n)], params, cfg, dev, fused=fused,
            model_kw=model_kw, engine_kw=engine_kw, cuda_graphs=graphs)
        launches = ck.launches()
        for r in reqs:
            if r.status.value != "finished_length" or len(r.output_ids) != 32:
                raise AssertionError(f"{mode} {r.request_id}: "
                                     f"{r.status.value}, "
                                     f"{len(r.output_ids)} tokens")
        sharer = reqs[-1]
        if sharer.num_cached_tokens <= 0:
            raise AssertionError("the sharer did not hit the prefix cache")
        summary = engines[0].kernel_dispatch_summary()
        check_launches("serve", mode, launches,
                       gqa_expected(mode, summary, n), summary)
        if engine_kw is None:
            check_windows("serve", mode, summary, graphs is not False)
        emit({"phase": "serve", "run": mode, "requests": len(reqs),
              "engine": engine_kw or "defaults", "launches": launches,
              "steps": sum(forward_steps(summary)), "dispatch": summary,
              "sharer_cached_tokens": sharer.num_cached_tokens,
              "cache": engines[0].cache_stats(),
              **stream_metrics(reqs, t0, t1), "card": card})
        del engines
        if mode in ("fused", "split"):
            worst, *_ = greedy_check(torch, model_full, params, reqs,
                                     sampled, dev, tol=GREEDY_TOL)
            emit({"phase": "serve", "run": mode, "greedy_vs_plain": "pass",
                  "largest_logit_gap": worst, "tolerance": GREEDY_TOL})
        runs[mode] = reqs
        launches_of[mode] = launches
    differ = [r.request_id for r, e in zip(runs["fused"], runs["fused_eager"])
              if r.output_ids != e.output_ids]
    if differ:
        raise AssertionError(f"serve: graphs on and off differ at {differ}")
    emit({"phase": "serve", "run": "fused_eager",
          "rows_bitwise_identical_to_graphs": len(runs["fused"]),
          "of_which_seeded": len(sampled)})
    for mode in ("fused_k1_sync", "split", "plain"):
        agree = {}
        for i in sorted(sampled):
            a, b = runs["fused"][i].output_ids, runs[mode][i].output_ids
            same = 0
            while same < len(a) and a[same] == b[same]:
                same += 1
            agree[runs["fused"][i].request_id] = same
        greedy_same = sum(
            runs["fused"][i].output_ids == runs[mode][i].output_ids
            for i in range(len(runs["fused"])) if i not in sampled
        )
        emit({"phase": "serve", "run": mode,
              "sampled_rows_common_prefix_vs_fused": agree,
              "greedy_rows_identical_to_fused": greedy_same})
    # The dense GQA decode kernel (A2) teacher-forced against the plain
    # decode on the same cache, step by step (no limit: the one-step
    # logit difference, free of a served stream's compounding).
    greedy = [i for i in range(len(runs["fused"])) if i not in sampled]
    emit({"phase": "serve", "check": "teacher_forced_gqa_decode_vs_plain",
          **teacher_forced_decode(torch, model_full, params,
                                  runs["fused"][greedy[0]], dev,
                                  "gqa_decode")})
    return runs["fused"], sampled, launches_of


def phase_pipeline(torch, dev, cfg, model_full, params, single, sampled):
    reqs, _, engines, t0, t1 = serve(torch, [(0, 14), (14, 28)], params,
                                     cfg, dev, fused=True)
    for r in reqs:
        if r.status.value != "finished_length":
            raise AssertionError(f"pipeline {r.request_id}: {r.status.value}")
    worst, *_ = greedy_check(torch, model_full, params, reqs, sampled, dev,
                             tol=GREEDY_TOL)
    identical = sum(
        a == b for r, s in zip(reqs, single)
        for a, b in zip(r.output_ids, s.output_ids)
    )
    total = sum(len(r.output_ids) for r in reqs)
    FIGURES["pipeline"] = stream_metrics(reqs, t0, t1)
    emit({"phase": "pipeline", "stages": [[0, 14], [14, 28]],
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tokens_identical_to_single_stage": identical,
          "tokens": total, **FIGURES["pipeline"],
          "dispatch": [e.kernel_dispatch_summary() for e in engines]})


def _kernel_group(name: str) -> str:
    # By kernel name: A2 / A9's split and combine launches
    # (gqa_decode_{split,combine}_kernel) fall under gqa_decode, A1's three
    # (gqa_prefill_{tile,split,combine}_kernel) under gqa_prefill, A5 / A6's
    # two (mla_{split,combine}_kernel) under mla_decode, A3's two
    # (sample_{candidates,pick}_kernel) under sample_topk and A7 / A8's
    # (indexer_*_kernel) under indexer.
    for key, group in (("gqa_decode", "gqa_decode"),
                       ("gqa_prefill", "gqa_prefill"),
                       ("kv_append", "kv_append"),
                       ("sample_candidates_kernel", "sample_topk"),
                       ("sample_pick_kernel", "sample_topk"),
                       ("grouped_gemm", "grouped_gemm"),
                       ("mla_split_kernel", "mla_decode"),
                       ("mla_combine_kernel", "mla_decode"),
                       ("indexer_", "indexer")):
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (elementwise, reductions, indexing)"


def phase_profile(torch, dev, cfg, params, phase="profile", **serve_kw):
    """Where a serve phase's device time goes, in the engine's defaults:
    the same 8 requests under torch.profiler (device activity only),
    device time summed by kernel group, and the share of the run's wall
    time the device was busy. The device events are read straight from
    the trace (no per-op tables), which keeps the post-processing short.
    The profiler's own overhead lengthens the wall, so the busy share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reqs, _, _, t0, t1 = serve(
            torch, [(0, cfg.num_hidden_layers)], params, cfg, dev,
            fused=True, **serve_kw)
    t_post = time.monotonic()
    by_name: dict[str, list] = {}
    for evt in prof.profiler.kineto_results.events():
        # Device events only: kernels, copies and fills.
        if evt.device_type() != DeviceType.CUDA:
            continue
        acc = by_name.setdefault(evt.name(), [0.0, 0])
        acc[0] += evt.duration_ns() / 1e3
        acc[1] += 1
    groups: dict[str, float] = {}
    top = []
    for name, (us, count) in by_name.items():
        if us <= 0.0:
            continue
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
        top.append((us, name[:80], count))
    busy_s = sum(groups.values()) / 1e6
    if busy_s <= 0.0:
        raise AssertionError("torch.profiler recorded no device time")
    top.sort(reverse=True)
    emit({"phase": phase, "config": "defaults", "wall_s": t1 - t0,
          "device_busy_s": busy_s,
          "device_busy_share": busy_s / (t1 - t0),
          "device_ms_by_group": {k: v / 1e3 for k, v in sorted(
              groups.items(), key=lambda kv: -kv[1])},
          "top_kernels": [{"name": n, "ms": us / 1e3, "calls": c}
                          for us, n, c in top[:8]],
          "tokens": sum(len(r.output_ids) for r in reqs),
          "post_processing_s": round(time.monotonic() - t_post, 1),
          **stream_metrics(reqs, t0, t1)})
    del prof


# ---------------------------------------------------------------------------
# Phase 6b: features_serve, sampling features on the served path
# ---------------------------------------------------------------------------

# The schema of tests/test_constrained_window.py, and the byte tokenizer's
# grammar vocabulary (258 entries over Qwen2.5's 152,064 ids; EOS 257).
FEATURE_SCHEMA = json.dumps({"type": "object",
                             "properties": {"v": {"enum": ["x", "y"]}},
                             "required": ["v"]})
GRAMMAR_VOCAB = ([bytes([i]) for i in range(256)] + [b"", b""], 257)
FEATURE_NEW = 48
PENALTIES = dict(repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.2)
# r0-r7's feature sets: (sampling, the row's extra fields); seeded rows
# take temperature 0.8 and top-k 40.
FEATURE_SETS = (
    ({}, dict(json_schema=FEATURE_SCHEMA)),
    ({"seed": 21}, dict(json_schema=FEATURE_SCHEMA)),
    ({}, PENALTIES),
    ({"seed": 23}, PENALTIES),
    ({}, dict(logit_bias={11: 4.0, 23: -6.0}, logprobs=True)),
    ({"seed": 25}, dict(logprobs=True)),
    ({"seed": 27}, dict(json_schema=FEATURE_SCHEMA, logprobs=True,
                        logit_bias={ord("x"): 2.5}, **PENALTIES)),
    ({}, {}),
)
FEATURE_RUNS = (
    ("fused", True, None, None, None),
    ("fused_eager", True, None, None, False),
    ("fused_k1_sync", True, None, K1_SYNC, None),
    ("plain", False, dict(use_kernels=False), K1_SYNC, None),
)


def feature_requests(vocab: int, features: bool = True):
    """serve's 8 prompts, 48 new tokens each, with r0-r7's feature sets
    (``FEATURE_SETS``); grammar rows stop at EOS 257, the rest run to
    their budget. ``features=False`` keeps the sampling and drops the
    features (the same mix without them)."""
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    base, _ = make_requests(vocab)
    reqs, sampled = [], {}
    for i, (r, (samp, feats)) in enumerate(zip(base, FEATURE_SETS)):
        kw = dict(temperature=0.0, max_new_tokens=FEATURE_NEW,
                  ignore_eos=True)
        if samp:
            kw.update(temperature=0.8, top_k=40, seed=samp["seed"])
            sampled[i] = (0.8, 40, samp["seed"])
        if features:
            kw.update(feats)
        grammar = "json_schema" in kw
        if grammar:
            kw["ignore_eos"] = False
        reqs.append(Request(
            r.request_id, prompt_ids=list(r.prompt_ids),
            eos_token_ids=(GRAMMAR_VOCAB[1],) if grammar else (),
            sampling_params=SamplingParams(**kw)))
    return reqs, sampled


def schema_json(ids) -> dict:
    """The JSON a grammar row decoded to, which must match FEATURE_SCHEMA."""
    obj = json.loads(bytes(t for t in ids if t < 256))
    if set(obj) != {"v"} or obj["v"] not in ("x", "y"):
        raise AssertionError(f"features_serve: {obj} does not match the "
                             "schema")
    return obj


def feature_greedy_check(torch, model_full, params, reqs, rows, dev) -> dict:
    """Each greedy feature row's committed tokens against the plain model's
    one-shot logits with that row's features applied at every position:
    the penalties from the tokens committed before it, the bias, and the
    host DFA's mask (columns past the grammar vocabulary masked). Each
    token must be within GREEDY_TOL of that argmax; returns each row's
    largest gap."""
    from parallax_tpu_torch.constrained import GrammarCompiler
    from parallax_tpu_torch.ops.sampling import NEG_INF, apply_penalties

    compiler = GrammarCompiler(*GRAMMAR_VOCAB)
    gaps = {}
    for i in rows:
        r = reqs[i]
        sp = r.sampling_params
        logits = one_shot_rows(torch, model_full, params, r, dev).float()
        v = logits.shape[1]
        counts = torch.zeros((1, v), dtype=torch.int32, device=dev)
        table = compiler.compile(sp.json_schema) if sp.json_schema else None
        state, worst = 0, 0.0
        for j, tok in enumerate(r.output_ids):
            row = logits[j:j + 1]
            if sp.presence_penalty or sp.frequency_penalty or (
                    sp.repetition_penalty != 1.0):
                row = apply_penalties(
                    row, counts,
                    torch.tensor([sp.presence_penalty], device=dev),
                    torch.tensor([sp.frequency_penalty], device=dev),
                    torch.tensor([sp.repetition_penalty], device=dev))
            row = row[0].clone()
            for tid, b in (sp.logit_bias or {}).items():
                row[int(tid)] += float(b)
            if table is not None:
                mask = torch.zeros((v,), dtype=torch.bool, device=dev)
                m = torch.from_numpy(table.allowed_mask(state)).to(dev)
                mask[: m.shape[0]] = m
                row = torch.where(mask, row, NEG_INF)
                state = table.advance(state, tok)
            gap = float(row.max() - row[tok])
            worst = max(worst, gap)
            if gap >= GREEDY_TOL:
                raise AssertionError(
                    f"features_serve {r.request_id} token {j}: {tok} sits "
                    f"{gap} under the featured argmax (limit {GREEDY_TOL})")
            counts[0, tok] += 1
        gaps[r.request_id] = worst
        del logits
    return gaps


def feature_pass_ms(torch, dev, v: int, s: int = 8) -> dict:
    """Device time of one window step's feature pass at S rows of V logits,
    every feature on (penalties from a count table, two bias rows, the
    schema's packed mask, logprobs, the count and DFA advance; the
    engine's own ``window_feature_logits`` / ``window_feature_advance``),
    by CUDA events with the host's enqueue hidden."""
    from parallax_tpu_torch.constrained import GrammarCompiler
    from parallax_tpu_torch.runtime.engine import (
        WindowState,
        window_feature_advance,
        window_feature_logits,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    dev_t = GrammarCompiler(*GRAMMAR_VOCAB).device_table(FEATURE_SCHEMA)[0]
    i32 = dict(dtype=torch.int32, device=dev)
    z = torch.zeros((s,), **i32)
    st = WindowState(
        page_indices=z[:, None], cu_q_lens=z, num_seqs=z[:1],
        logits_indices=z, feed=z, ctx=z, stopped=z.bool(), produced=z,
        counter=torch.zeros((1,), dtype=torch.int64, device=dev),
        tokens=torch.zeros((8, s), **i32), stop_tokens=z[:, None],
        limit=z, min_req=z,
        pen_pres=torch.full((s,), 0.5, device=dev),
        pen_freq=torch.full((s,), 0.2, device=dev),
        pen_rep=torch.full((s,), 1.3, device=dev),
        pen_counts=torch.randint(0, 2, (s, v), generator=gen, device=dev,
                                 dtype=torch.int32),
        bias_rows=torch.tensor([0, 1], **i32),
        bias_vecs=torch.randn((2, v), generator=gen, device=dev),
        g_trans=torch.from_numpy(dev_t.trans).to(dev),
        g_allowed=torch.from_numpy(dev_t.allowed.view("int32")).to(dev),
        g_constrained=torch.ones((s,), dtype=torch.bool, device=dev),
        g_dead=torch.full((s,), dev_t.dead_state, **i32),
        dfa=z.clone(),
        lps=torch.zeros((8, s), dtype=torch.float32, device=dev),
    )
    logits = torch.randn((s, v), generator=gen, device=dev)
    nxt = torch.full((s,), ord("{"), **i32)
    live = torch.ones((s,), dtype=torch.bool, device=dev)

    def step():
        window_feature_advance(st, window_feature_logits(st, logits), nxt,
                               live)

    ms = time_ms(torch, step, 50, hide_host=True)
    return {"device_ms": ms, "rows": s, "vocab": v,
            "grammar_states": dev_t.n_states}


def _common_prefix(a, b) -> int:
    same = 0
    while same < min(len(a), len(b)) and a[same] == b[same]:
        same += 1
    return same


def _featured_stats(reqs) -> dict:
    """Per-row finish, token count and logprob count of a features run."""
    return {r.request_id: [r.status.value, len(r.output_ids),
                           len(r.output_logprobs)] for r in reqs}


def check_feature_run(mode, reqs) -> None:
    """Every row of a features run: grammar rows (r0, r1, r6) stop at EOS
    with schema-valid JSON, the others run to 48 tokens; a logprob row has
    one logprob (<= 0) a token, any other row none."""
    for r in reqs:
        sp = r.sampling_params
        if sp.json_schema:
            if r.status.value != "finished_eos":
                raise AssertionError(f"features_serve {mode} "
                                     f"{r.request_id}: {r.status.value}")
            schema_json(r.output_ids)
        elif (r.status.value != "finished_length"
              or len(r.output_ids) != FEATURE_NEW):
            raise AssertionError(f"features_serve {mode} {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
        want = len(r.output_ids) if sp.logprobs else 0
        if len(r.output_logprobs) != want or any(
                lp > 0.0 for lp in r.output_logprobs):
            raise AssertionError(
                f"features_serve {mode} {r.request_id}: "
                f"{len(r.output_logprobs)} logprobs for "
                f"{len(r.output_ids)} tokens, max "
                f"{max(r.output_logprobs, default=None)}")


def phase_features_serve(torch, dev, card: str, cfg, model_full, params):
    """Qwen2.5-7B at full width serving serve's 8 prompts with one
    sampling-feature set a row (``FEATURE_SETS``), four times: the
    engine's defaults (K = 8 feature windows replayed from CUDA graphs),
    the same with graphs off (every row's tokens and logprob bits equal),
    K1_SYNC (the host-synchronous path) and plain; then the same mix
    without features under the defaults, for its TTFT and decode rate,
    and r0 with EOS biased +20, which must stop at the grammar's terminal
    state. Launches exact (A3 on every feature step); the defaults ran
    feature windows with no fallback; greedy feature rows within
    GREEDY_TOL of the plain one-shot logits with their features applied;
    the device time of one window step's feature pass."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    n = cfg.num_hidden_layers
    runs = {}
    for mode, fused, model_kw, engine_kw, graphs in FEATURE_RUNS + (
            ("fused_nofeatures", True, None, None, None),):
        ck.reset_launches()
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, n)], params, cfg, dev, fused=fused,
            model_kw=model_kw, engine_kw=engine_kw, cuda_graphs=graphs,
            requests=feature_requests(cfg.vocab_size,
                                      mode != "fused_nofeatures"))
        launches = ck.launches()
        summary = engines[0].kernel_dispatch_summary()
        check_launches("features_serve", mode, launches,
                       gqa_expected(mode, summary, n), summary)
        if engine_kw is None:
            check_windows("features_serve", mode, summary,
                          graphs is not False)
        constrained = engines[0].constrained_summary()
        if mode == "fused_nofeatures":
            emit({"phase": "features_serve", "run": mode,
                  **stream_metrics(reqs, t0, t1), "card": card})
            break
        check_feature_run(mode, reqs)
        if engine_kw is None and (
                not constrained or constrained["window_rows"] <= 0
                or constrained["mask_steps"] <= 0
                or constrained["fallbacks"] != 0):
            raise AssertionError(f"features_serve {mode}: feature windows "
                                 f"{constrained}")
        if fused and launches["sample_topk"] <= 0:
            raise AssertionError(f"features_serve {mode}: A3 not launched")
        emit({"phase": "features_serve", "run": mode,
              "engine": engine_kw or "defaults", "launches": launches,
              "steps": sum(forward_steps(summary)), "dispatch": summary,
              "constrained": constrained,
              "window_feature_sets": {
                  "+".join(k) or "none": v for k, v in
                  engines[0].window_feature_counts.items()},
              "rows": _featured_stats(reqs),
              "json": {reqs[i].request_id: schema_json(reqs[i].output_ids)
                       for i in (0, 1, 6)},
              **stream_metrics(reqs, t0, t1), "card": card})
        del engines
        if mode in ("fused", "plain"):
            gaps = feature_greedy_check(torch, model_full, params, reqs,
                                        (0, 2, 4), dev)
            emit({"phase": "features_serve", "run": mode,
                  "greedy_featured_vs_plain": "pass",
                  "largest_logit_gap": gaps, "tolerance": GREEDY_TOL})
        runs[mode] = reqs
    differ = [r.request_id for r, e in zip(runs["fused"], runs["fused_eager"])
              if r.output_ids != e.output_ids
              or r.output_logprobs != e.output_logprobs]
    if differ:
        raise AssertionError(f"features_serve: graphs on and off differ at "
                             f"{differ}")
    for mode in ("fused_k1_sync", "plain"):
        emit({"phase": "features_serve", "run": mode,
              "common_prefix_vs_defaults": {
                  a.request_id: _common_prefix(a.output_ids, b.output_ids)
                  for a, b in zip(runs["fused"], runs[mode])}})
    # r0 with EOS biased +20: EOS is the argmax wherever the grammar allows
    # it, at the accepting states only.
    r0 = runs["fused"][0]
    stop = Request("r0_eos", prompt_ids=list(r0.prompt_ids),
                   eos_token_ids=(GRAMMAR_VOCAB[1],),
                   sampling_params=SamplingParams(
                       temperature=0.0, max_new_tokens=FEATURE_NEW,
                       json_schema=FEATURE_SCHEMA,
                       logit_bias={GRAMMAR_VOCAB[1]: 20.0}))
    reqs, _, engines, _, _ = serve(torch, [(0, n)], params, cfg, dev,
                                   fused=True, requests=([stop], {}))
    windows = engines[0].kernel_dispatch_summary()["dispatch_total"].get(
        "cuda-fused/multistep", 0)
    del engines
    if (stop.status.value != "finished_eos"
            or len(stop.output_ids) >= FEATURE_NEW or windows <= 0):
        raise AssertionError(f"features_serve: terminal stop "
                             f"{stop.status.value}, {stop.output_ids}, "
                             f"{windows} window steps")
    emit({"phase": "features_serve", "check": "terminal_state_stop",
          "status": stop.status.value, "tokens": len(stop.output_ids),
          "json": schema_json(stop.output_ids), "window_steps": windows})
    emit({"phase": "features_serve", "check": "feature_pass",
          **feature_pass_ms(torch, dev, cfg.vocab_size), "card": card})


# ---------------------------------------------------------------------------
# Phases 6c and 6d: the host KV tier and live migration
# ---------------------------------------------------------------------------

PREEMPT_NEW = 48
# The pool of preempt_serve's wave 1: 35 pages (34 after the null page).
# Admission takes r0-r3 (29 prompt pages) at once and the other rows as
# pages free; their decode growth does not fit. The scheduling reads
# lengths, not weights, so the CPU shows what the card does: of the pools
# of 30-63 pages this mix was run on there, 35 is one where both the
# defaults and K1_SYNC preempt and resume at least twice and the defaults'
# windows also fall back to K = 1.
PREEMPT_PAGES = 35
PREEMPT_HOST_BYTES = 4 << 30
# Churn between the waves: prompts of 8 pages each, 8 new tokens, that
# need more than the pool between them.
CHURN_PROMPTS = 6
CHURN_LEN = 512
MIGRATE_AT = 16


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def preempt_mix(vocab: int, new: int = PREEMPT_NEW):
    """serve's 8 prompts and sampling with ``new`` new tokens each."""
    reqs, sampled = make_requests(vocab)
    for r in reqs:
        r.sampling_params.max_new_tokens = new
    return reqs, sampled


def _drain(engine) -> None:
    from parallax_tpu_torch.runtime.engine import drive_step

    pending = None
    while engine.has_work() or pending is not None:
        _, pending = drive_step(engine, pending)


def _timed(target, name: str, log: list) -> None:
    """Wrap ``target.name`` (an instance's bound method) so each call
    appends (host seconds, result) to ``log``."""
    fn = getattr(target, name)

    def wrapper(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        log.append((time.perf_counter() - t, out))
        return out

    setattr(target, name, wrapper)


def _wave(engine, reqs) -> tuple[float, float]:
    t0 = time.monotonic()
    for r in reqs:
        r.arrival_time = t0
        engine.submit(r)
    _drain(engine)
    return t0, time.monotonic()


def page_round_trip(torch, dev, engine, vocab: int, iters: int = 5) -> dict:
    """A live request's pages through the tier and back: its prompt is
    prefilled (and one token sampled), its pages demoted, then promoted
    into as many other free pages; every layer's pages the same bits.
    The D2H and H2D rates time the whole demote / promote calls (gather,
    staging, copies) after a sync, the median of ``iters``."""
    import random

    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    rng = random.Random(7)
    req = Request("rt", prompt_ids=[rng.randrange(1, vocab)
                                    for _ in range(700)],
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=2,
                                                 ignore_eos=True))
    engine.submit(req)
    while not req.output_ids:
        engine.step()
    pages = list(req.page_ids)
    tier, cache = engine.host_tier, engine.cache
    nbytes = len(pages) * tier.pool.page_nbytes
    d2h, h2d, equal = [], [], True
    for _ in range(iters):
        # Free pages from the prefix tree (demoting its pages) first.
        if not cache._reclaim(len(pages)):
            raise AssertionError("preempt_serve: no pages for the round "
                                 "trip")
        fresh = cache.allocator.alloc(len(pages))
        _sync(torch, dev)
        t = time.perf_counter()
        handles = tier.demote(pages)
        d2h.append(time.perf_counter() - t)
        t = time.perf_counter()
        tier.promote(handles, fresh)
        _sync(torch, dev)
        h2d.append(time.perf_counter() - t)
        src = torch.tensor(pages, device=dev)
        dst = torch.tensor(fresh, device=dev)
        equal = equal and all(
            torch.equal(layer.index_select(0, src), layer.index_select(0, dst))
            for layer in engine.kv)
        cache.allocator.free(fresh)
    _drain(engine)
    if not equal:
        raise AssertionError("preempt_serve: a page round trip changed bits")
    return {"pages": len(pages), "bytes": nbytes, "bitwise_equal": True,
            "d2h_gb_per_s": nbytes / statistics.median(d2h) / 1e9,
            "h2d_gb_per_s": nbytes / statistics.median(h2d) / 1e9,
            "d2h_ms": statistics.median(d2h) * 1e3,
            "h2d_ms": statistics.median(h2d) * 1e3}


def phase_preempt_serve(torch, dev, card: str, cfg, model_full, params):
    """The host KV tier on Qwen2.5-7B: serve's mix with PREEMPT_NEW new
    tokens on a PREEMPT_PAGES pool with a PREEMPT_HOST_BYTES tier, with the
    defaults and with K1_SYNC; each must preempt and resume at least twice,
    abort nothing, finish every request at full length, fall back from
    windows to K = 1 under pressure (defaults), launch exactly, and keep
    its greedy rows within GREEDY_TOL of the plain path. The same mix on
    serve's 192-page pool beside it (TTFT, decode tok/s; a discarded
    serve first takes the process's set-up out of both). Host ms a
    preemption and a resume. Then, on the defaults' engine: a page round
    trip (bitwise, D2H / H2D GB/s), CHURN_PROMPTS other prompts, and r0's
    and r7's prompts again, which must swap host-resident prefix pages in
    (tokens_hit_host >= 256)."""
    import random

    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    n = cfg.num_hidden_layers
    rates, kept = {}, {}
    # A discarded serve first: the first one of a process pays one-time
    # set-up (cuBLAS handles, the allocator's first blocks) inside its span.
    serve(torch, [(0, n)], params, cfg, dev, fused=True,
          requests=preempt_mix(cfg.vocab_size))
    for config, engine_kw in (("defaults", {}), ("k1_sync", K1_SYNC)):
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, n)], params, cfg, dev, fused=True,
            engine_kw=engine_kw, requests=preempt_mix(cfg.vocab_size))
        rates[f"{config}_192_pages"] = stream_metrics(reqs, t0, t1)
        del engines
        ck.reset_launches()
        reqs, sampled = preempt_mix(cfg.vocab_size)
        from parallax_tpu_torch.models import create_stage_model
        from parallax_tpu_torch.runtime.engine import StageEngine

        engine = StageEngine(
            create_stage_model(cfg, 0, n), params,
            engine_config(True, num_pages=PREEMPT_PAGES,
                          host_cache_bytes=PREEMPT_HOST_BYTES, **engine_kw),
            device=dev)
        if engine.host_tier is None:
            raise AssertionError("preempt_serve: no host tier")
        swaps = {"preempt": [], "resume": []}
        _timed(engine.cache, "preempt_to_host", swaps["preempt"])
        _timed(engine.cache, "resume_from_host", swaps["resume"])
        _sync(torch, dev)
        t0, t1 = _wave(engine, reqs)
        _sync(torch, dev)
        launches = ck.launches()
        stats = engine.cache_stats()
        summary = engine.kernel_dispatch_summary()
        bad = [(r.request_id, r.status.value, len(r.output_ids))
               for r in reqs if r.status.value != "finished_length"
               or len(r.output_ids) != PREEMPT_NEW]
        if bad or stats["kv_oom_aborts"] or stats["preemptions"] < 2 \
                or stats["resumes"] < 2:
            raise AssertionError(f"preempt_serve {config}: {bad}, {stats}")
        check_launches("preempt_serve", config, launches,
                       gqa_expected("fused", summary, n), summary)
        totals = summary["dispatch_total"]
        fallback = totals.get(f"{summary['impl']}/decode", 0)
        windows = totals.get(f"{summary['impl']}/multistep", 0)
        if not engine_kw and (fallback <= 0 or windows <= 0):
            raise AssertionError(f"preempt_serve {config}: no K = 1 "
                                 f"fallback beside windows: {totals}")
        worst, *_ = greedy_check(torch, model_full, params, reqs, sampled,
                                 dev, tol=GREEDY_TOL)
        preempt_ms = [s * 1e3 for s, ok in swaps["preempt"] if ok]
        resume_ms = [s * 1e3 for s, ok in swaps["resume"] if ok]
        rates[config] = stream_metrics(reqs, t0, t1)
        emit({"phase": "preempt_serve", "run": config,
              "engine": engine_kw or "defaults",
              "num_pages": PREEMPT_PAGES,
              "host_cache_bytes": PREEMPT_HOST_BYTES,
              "cache": stats, "launches": launches,
              "steps": sum(forward_steps(summary)),
              "k1_steps_beside_windows": fallback if not engine_kw else None,
              "window_steps": windows,
              "greedy_vs_plain": "pass", "largest_logit_gap": worst,
              "tolerance": GREEDY_TOL,
              "host_ms_per_preemption_median": statistics.median(preempt_ms),
              "host_ms_per_preemption_max": max(preempt_ms),
              "host_ms_per_resume_median": statistics.median(resume_ms),
              "host_ms_per_resume_max": max(resume_ms),
              **rates[config],
              "same_mix_192_pages": rates[f"{config}_192_pages"],
              "card": card})
        if engine_kw:
            del engine
            continue
        kept = {"engine": engine, "reqs": reqs}
    engine, wave1 = kept["engine"], kept["reqs"]
    trip = page_round_trip(torch, dev, engine, cfg.vocab_size)
    emit({"phase": "preempt_serve", "check": "page_round_trip", **trip,
          "card": card})
    rng = random.Random(11)
    churn = [Request(f"c{i}", prompt_ids=[rng.randrange(1, cfg.vocab_size)
                                          for _ in range(CHURN_LEN)],
                     sampling_params=SamplingParams(
                         temperature=0.0, max_new_tokens=8, ignore_eos=True))
             for i in range(CHURN_PROMPTS)]
    _wave(engine, churn)
    before = engine.cache_stats()
    again = [Request(f"w2_{r.request_id}", prompt_ids=list(r.prompt_ids),
                     sampling_params=SamplingParams(
                         temperature=0.0, max_new_tokens=8, ignore_eos=True))
             for r in (wave1[0], wave1[7])]
    _wave(engine, again)
    after = engine.cache_stats()
    hit_host = after["tokens_hit_host"] - before["tokens_hit_host"]
    swapped = after["pages_swapped_in"] - before["pages_swapped_in"]
    if hit_host < 256 or swapped <= 0 or any(
            r.status.value != "finished_length" for r in churn + again):
        raise AssertionError(f"preempt_serve second wave: {before} -> "
                             f"{after}")
    emit({"phase": "preempt_serve", "check": "second_wave",
          "churn": f"{CHURN_PROMPTS} x {CHURN_LEN} ids, 8 new tokens",
          "tokens_hit_host": hit_host, "pages_swapped_in": swapped,
          "tokens_hit_device": after["tokens_hit_device"]
          - before["tokens_hit_device"],
          "host_pages": after["host_pages"],
          "pages_demoted": after["pages_demoted"],
          "host_evictions": after["host_evictions"],
          "greedy_tokens_equal_to_wave1": [
              sum(x == y for x, y in zip(a.output_ids, r.output_ids))
              for a, r in zip(again, (wave1[0], wave1[7]))],
          "card": card})
    del engine, kept


def _migrate_engine(cfg, params, dev, host: bool = True):
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine

    return StageEngine(
        create_stage_model(cfg, 0, cfg.num_hidden_layers), params,
        engine_config(True, max_model_len=1024, host_cache_bytes=(
            PREEMPT_HOST_BYTES if host else 0)), device=dev)


def migrate_engines(torch, dev, card, cfg, params) -> dict:
    """Part (a): engine to engine on the card. r1 (greedy) and r2 (seeded)
    of preempt_serve's mix, each alone: the uninterrupted stream on one
    engine; on engine A the same request runs to MIGRATE_AT tokens, is
    preempted to A's tier, harvested, extracted and checkpointed; the
    checkpoint goes through encode_frame / decode_frame bytes and
    checkpoint_from_wire; engine B (same layout, A's parameter tensors)
    adopts the image and resumes it: the same tokens, one resume, no
    prefill step and no A0 / A1 launch on B. Then the checkpoint without
    its image restores on a fresh engine by re-prefill and replay: the
    same tokens again."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p import proto
    from parallax_tpu_torch.runtime.checkpoint import (
        build_resumed_request,
        checkpoint_from_request,
        checkpoint_from_wire,
        checkpoint_to_wire,
    )
    from parallax_tpu_torch.runtime.engine import drive_step
    from parallax_tpu_torch.runtime.request import Request

    mix, _sampled = preempt_mix(cfg.vocab_size)
    out = {}
    for label, src in (("greedy", mix[1]), ("seeded", mix[2])):
        def fresh(rid):
            return Request(rid, prompt_ids=list(src.prompt_ids),
                           sampling_params=dataclasses.replace(
                               src.sampling_params))

        base = fresh("base")
        engine = _migrate_engine(cfg, params, dev)
        engine.submit(base)
        _drain(engine)
        del engine
        mig = fresh("mig")
        engine_a = _migrate_engine(cfg, params, dev)
        engine_a.submit(mig)
        pending = None
        while len(mig.output_ids) < MIGRATE_AT:
            _, pending = drive_step(engine_a, pending)
        if pending is not None:
            engine_a.resolve(pending)
        at = len(mig.output_ids)
        t_park = time.perf_counter()
        if not engine_a.cache.preempt_to_host(mig):
            raise AssertionError("migrate_serve (a): preemption refused")
        image = engine_a.harvest_kv_image(mig)
        if image is None or engine_a.extract("mig") is not mig:
            raise AssertionError("migrate_serve (a): no image to harvest")
        ckpt = checkpoint_from_request(mig, routing_table=[], kv=image)
        engine_a.cache.release(mig)
        data = proto.encode_frame(proto.CHECKPOINT, {"checkpoints": [
            checkpoint_to_wire(ckpt)]})
        park_ms = (time.perf_counter() - t_park) * 1e3
        del engine_a
        got = checkpoint_from_wire(proto.decode_frame(data)["p"]
                                   ["checkpoints"][0])
        runs = {}
        for route in ("image", "replay"):
            engine_b = _migrate_engine(cfg, params, dev,
                                       host=route == "image")
            ck.reset_launches()
            t_restore = time.perf_counter()
            res = build_resumed_request(got, replay=route == "replay")
            if route == "image" and not engine_b.adopt_checkpoint_kv(
                    res, got.kv):
                raise AssertionError("migrate_serve (a): image refused")
            engine_b.submit(res)
            _drain(engine_b)
            restore_s = time.perf_counter() - t_restore
            launches = ck.launches()
            summary = engine_b.kernel_dispatch_summary()
            stats = engine_b.cache_stats()
            del engine_b
            totals = summary["dispatch_total"]
            prefill = totals.get(f"{summary['prefill_impl']}/prefill", 0)
            if res.full_output_ids != base.output_ids or len(
                    res.full_output_ids) != PREEMPT_NEW:
                raise AssertionError(
                    f"migrate_serve (a) {label} {route}: "
                    f"{res.full_output_ids} != {base.output_ids}")
            if route == "image" and (stats["resumes"] != 1 or prefill
                                     or launches["kv_append"]
                                     or launches["gqa_prefill"]):
                raise AssertionError(f"migrate_serve (a) {label}: B "
                                     f"prefilled: {totals}, {stats}")
            runs[route] = {"tokens_equal_to_uninterrupted": PREEMPT_NEW,
                           "prefill_steps_on_b": prefill,
                           "resumes_on_b": stats["resumes"],
                           "restore_to_finish_s": restore_s,
                           "launches_on_b": launches}
        out[label] = {"parked_at_token": at, "frame_bytes": len(data),
                      "image_pages": int(got.kv.layers[0].shape[0]),
                      "park_harvest_frame_ms": park_ms, **runs}
    emit({"phase": "migrate_serve", "part": "a_engines", **out,
          "card": card})
    return out


def migrate_swarm(torch, dev, card, cfg, model_full, params) -> dict:
    """Part (b): the swarm. A port GlobalScheduler and its SchedulerService
    on TCP loopback with four WorkerNodes, the roofline's memory bound
    patched to 14 layers a node, so the scheduler lays out two 14 + 14
    pipelines (checked); its rebalance test is pinned off, so a leave
    keeps the surviving pipeline (the test reads heartbeat-measured
    latencies). preempt_serve's mix routed (round robin) and polled
    through a SwarmClient; once the requests on r0's pipeline streamed 4
    tokens, that pipeline's tail stops. Its head parks them, the scheduler
    picks the other pipeline, they restore there by re-prefill and replay
    (the target has two stages), and the client follows ``migrated``:
    every request ends by length with zero aborts, the greedy rows within
    GREEDY_TOL of the plain path; ``where_is`` (over the RPC) names each
    moved request's new head. Park-to-restore seconds and routes."""
    import threading

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.backend.scheduler_service import SchedulerService
    from parallax_tpu_torch.p2p import proto
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.scheduling import node as sched_node
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

    n = cfg.num_hidden_layers
    roofline = sched_node.RooflinePerformanceModel
    real_capacity = roofline.max_layers_in_memory
    # Half the served tree's layers a node (14 of the full 28).
    roofline.max_layers_in_memory = (
        lambda self, kv_fraction=0.35: n // 2)
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=4)
    sched.allocator.should_global_rebalance = (
        lambda active, cv_threshold=0.5: False)
    service = SchedulerService(sched, TcpTransport("scheduler", "127.0.0.1"),
                               join_timeout_s=SWARM_TIMEOUT_S)
    workers = []
    try:
        service.start()
        for _ in range(4):
            t = TcpTransport("", "127.0.0.1")
            t.start()
            t.peer_id = t.address
            workers.append(WorkerNode(
                t, service.transport.address, cfg, engine_config(True),
                load_params=lambda m: _stage_tree(
                    params, m.start_layer, m.end_layer, n),
                heartbeat_interval_s=0.5, device=dev))
        threads = [threading.Thread(target=w.start, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SWARM_TIMEOUT_S)
        deadline = time.monotonic() + SWARM_TIMEOUT_S
        _wait_for(lambda: len(_sched_nodes(sched.cluster_status())) == 4
                  and all(x[2] for x in _sched_nodes(sched.cluster_status())),
                  deadline, "migrate_serve (b): no two ready pipelines")
        status = sched.cluster_status()
        if status["num_pipelines"] != 2:
            raise AssertionError(f"migrate_serve (b): allocation "
                                 f"{_sched_nodes(status)}")
        by_id = {w.node_id: w for w in workers}
        client = SwarmClient(service.transport, service)
        reqs, sampled = preempt_mix(cfg.vocab_size)
        events = []
        for r in reqs:
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            events.append(client.submit(r))
        doomed = list(reqs[0].routing_table)
        head, tail = by_id[doomed[0]], by_id[doomed[-1]]
        moved = [r for r in reqs if r.routing_table == doomed]
        _wait_for(lambda: all(len(r.output_ids) >= 4 for r in moved),
                  deadline, "migrate_serve (b): no tokens before the stop")
        streamed = {r.request_id: len(r.output_ids) for r in moved}
        t_stop = time.monotonic()
        tail.stop()
        for r, ev in zip(reqs, events):
            if not ev.wait(SWARM_TIMEOUT_S):
                raise AssertionError(f"migrate_serve (b) {r.request_id}: "
                                     f"{r.status.value}")
        wall_s = time.monotonic() - t_stop
        restores, where = {}, {}
        for r in moved:
            target = sched.migrated_head(r.request_id)
            reply = client.transport.call(
                service.transport.address, proto.WHERE_IS,
                {"rid": r.request_id}, timeout=10.0)
            if target is None or target == head.node_id \
                    or reply.get("head") != target:
                raise AssertionError(f"migrate_serve (b) {r.request_id}: "
                                     f"where_is {reply}, {target}")
            route, park_s = by_id[target].restores[r.request_id]
            restores[r.request_id] = {"route": route,
                                      "park_to_restore_s": park_s,
                                      "streamed_before_stop":
                                          streamed[r.request_id]}
            where[r.request_id] = target
    finally:
        for w in workers:
            w.stop()
            w.engine = None
        service.stop()
        roofline.max_layers_in_memory = real_capacity
    del workers
    bad = [(r.request_id, r.status.value, len(r.output_ids)) for r in reqs
           if r.status.value != "finished_length"
           or len(r.output_ids) != PREEMPT_NEW]
    if bad:
        raise AssertionError(f"migrate_serve (b): {bad}")
    free_device_memory(torch)
    worst, *_ = greedy_check(torch, model_full, params, reqs, sampled, dev,
                             tol=GREEDY_TOL)
    out = {"pipelines": 2, "moved": restores, "aborts": 0,
           "requests": len(reqs), "stop_to_all_done_s": wall_s,
           "where_is": "answers the new head", "greedy_vs_plain": "pass",
           "largest_logit_gap": worst, "tolerance": GREEDY_TOL}
    emit({"phase": "migrate_serve", "part": "b_swarm", **out, "card": card})
    return out


def phase_migrate_serve(torch, dev, card, cfg, model_full, params) -> None:
    migrate_engines(torch, dev, card, cfg, params)
    free_device_memory(torch)
    migrate_swarm(torch, dev, card, cfg, model_full, params)


# ---------------------------------------------------------------------------
# Phase 6e: disagg_serve, phase roles and the KV handoff
# ---------------------------------------------------------------------------

# (label, the two workers' roles, the workers in their own processes)
DISAGG_RUNS = (("mixed", (None, None), False),
               ("disagg", ("prefill", "decode"), False),
               ("disagg_processes", ("prefill", "decode"), True))


def _watch_handoff(torch, dev, prefill, decode, first: str,
                   out: dict) -> None:
    """Instrument the pair's engines, whose calls run on their step
    threads: the image the prefill head harvests for ``first`` is kept,
    the decode head's adopt is timed per request, and the pages the decode
    head swaps ``first``'s adopted image into are compared with that image
    bitwise, right after the swap-in, on the decode head's step thread."""
    peng = prefill.engine if prefill is not None else None
    deng = decode.engine
    real_adopt = deng.adopt_checkpoint_kv
    real_resume = deng.cache.resume_from_host

    def adopt(req, image):
        t = time.perf_counter()
        ok = real_adopt(req, image)
        out["adopt_ms"][req.request_id] = (time.perf_counter() - t) * 1e3
        return ok

    def resume(req):
        n = len(getattr(req, "host_page_handles", None) or ())
        ok = real_resume(req)
        if ok and n and req.request_id == first and "pages_equal" not in out:
            image = out.get("image")
            fresh = torch.tensor(req.page_ids[-n:], device=dev)
            out["swapped_in_pages"] = n
            out["pages_equal"] = (
                image is not None and len(image.layers) == len(deng.kv)
                and all(int(img.shape[0]) == n and torch.equal(
                    layer.index_select(0, fresh).cpu(), img)
                    for layer, img in zip(deng.kv, image.layers)))
        return ok

    deng.adopt_checkpoint_kv = adopt
    if peng is None:
        return
    real_harvest = peng.harvest_kv_image

    def harvest(req):
        image = real_harvest(req)
        if image is not None and req.request_id == first:
            out["image"] = image
        return image

    peng.harvest_kv_image = harvest
    deng.cache.resume_from_host = resume


def _disagg_worker(cfg, params, dev, service, role, chaos=None,
                   heartbeat_s: float = 0.5, **engine_kw):
    """A WorkerNode in this process on ``params`` (shared, not copied),
    its transport wrapped by ``chaos`` when given; ``engine_kw`` over the
    engine's defaults and a PREEMPT_HOST_BYTES tier."""
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport

    n = cfg.num_hidden_layers
    t = TcpTransport("", "127.0.0.1")
    t.start()
    t.peer_id = t.address
    return WorkerNode(
        chaos.wrap(t) if chaos is not None else t, service, cfg,
        engine_config(True, **{"host_cache_bytes": PREEMPT_HOST_BYTES,
                               **engine_kw}),
        load_params=lambda m: _stage_tree(params, m.start_layer,
                                          m.end_layer, n),
        heartbeat_interval_s=heartbeat_s, device=dev, role=role)


def disagg_worker_main(role: str, scheduler: str) -> int:
    """``chip_smoke.py --disagg-worker ROLE SCHEDULER``: one worker of
    disagg_serve's process pair. It draws serve's Qwen2.5-7B tree on the
    card (the same seed, so the same weights as the parent's), joins the
    scheduler with ``role`` (``mixed`` for none), times its engine's adopt
    per request, serves until SIGTERM, then prints one JSON line: its
    node id, this process's kernel launches, its engine's dispatch
    summary, its handoff counters and the adopt times."""
    import signal
    import threading

    import torch

    from parallax_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        return 2
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, _model, params = dense_tree(torch, dev, "disagg_worker")
    worker = _disagg_worker(cfg, params, dev, scheduler,
                            None if role == "mixed" else role)
    worker.start()
    watch = {"adopt_ms": {}}
    while worker.engine is None and not stop.wait(0.01):
        pass
    if worker.engine is not None:
        _watch_handoff(torch, dev, None, worker, "", watch)
    stop.wait()
    eng = worker.engine
    torch.cuda.synchronize(dev)
    out = {"disagg_worker": role, "node_id": worker.node_id,
           "launches": ck.launches(),
           "summary": eng.kernel_dispatch_summary() if eng else None,
           "handoffs": worker.handoff_stats.snapshot(),
           "adopt_ms": watch["adopt_ms"]}
    worker.stop()
    print(json.dumps(out, default=str), flush=True)
    return 0


def disagg_pair(torch, dev, cfg, params, roles, processes: bool) -> dict:
    """One run of disagg_serve: a port GlobalScheduler (cache-aware
    routing; the rebalance test pinned off, as in migrate_serve) and its
    SchedulerService on TCP loopback, and two workers joining with
    ``roles``, each serving all the layers of Qwen2.5-7B with the engine's
    defaults and a PREEMPT_HOST_BYTES tier: WorkerNodes in this process on
    ``params`` (shared, not copied), or, with ``processes``, two
    ``chip_smoke.py --disagg-worker`` processes, each on its own draw of
    the same tree. preempt_serve's mix is routed and polled through a
    SwarmClient on the service. Returns the requests, the launches (this
    process's, or each worker process's), each worker's dispatch summary
    and handoff counters, where_is per request, the scheduler's status,
    the watched handoff figures and the serve span."""
    import os
    import tempfile
    import threading

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.backend.scheduler_service import SchedulerService
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

    n = cfg.num_hidden_layers
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=2,
                            routing="cache_aware")
    sched.allocator.should_global_rebalance = (
        lambda active, cv_threshold=0.5: False)
    service = SchedulerService(sched, TcpTransport("scheduler", "127.0.0.1"),
                               join_timeout_s=SWARM_TIMEOUT_S)
    workers, procs, logs = [], [], []
    watch = {"adopt_ms": {}}
    stop_mon = threading.Event()
    repo = os.path.dirname(os.path.abspath(__file__))
    try:
        service.start()
        for role in roles:
            if not processes:
                workers.append(_disagg_worker(cfg, params, dev,
                                              service.transport.address,
                                              role))
                continue
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--disagg-worker", role or "mixed",
                 service.transport.address],
                cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                stdout=logs[-1], stderr=subprocess.STDOUT))
        threads = [threading.Thread(target=w.start, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SWARM_TIMEOUT_S)
        deadline = time.monotonic() + SWARM_TIMEOUT_S

        def up() -> bool:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("disagg_serve: a worker process "
                                     "exited")
            nodes = _sched_nodes(sched.cluster_status())
            return len(nodes) == 2 and all(x[2] for x in nodes)

        _wait_for(up, deadline, "disagg_serve: no two ready replicas")
        allocation = _sched_nodes(sched.cluster_status())
        if sorted(x[1] for x in allocation) != [[0, n], [0, n]]:
            raise AssertionError(f"disagg_serve: allocation {allocation}")
        reqs, sampled = preempt_mix(cfg.vocab_size)
        if roles[0] == "prefill" and workers:
            _watch_handoff(torch, dev, workers[0], workers[1],
                           reqs[0].request_id, watch)
        client = SwarmClient(service.transport, service)
        _sync(torch, dev)
        ck.reset_launches()
        mon = threading.Thread(target=_stamp_first_tokens,
                               args=(reqs, stop_mon, client.poll_interval_s),
                               daemon=True)
        t0 = time.monotonic()
        mon.start()
        events = []
        for r in reqs:
            r.arrival_time = t0
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            events.append(client.submit(r))
        for r, ev in zip(reqs, events):
            if not ev.wait(SWARM_TIMEOUT_S):
                raise AssertionError(f"disagg_serve {r.request_id}: "
                                     f"{r.status.value}")
        t1 = time.monotonic()
        stop_mon.set()
        mon.join(10)
        _sync(torch, dev)
        out = {
            "reqs": reqs, "sampled": sampled, "t0": t0, "t1": t1,
            "allocation": allocation,
            "where_is": {r.request_id: sched.migrated_head(r.request_id)
                         for r in reqs},
            "status": sched.cluster_status(), "watch": watch,
        }
        if workers:
            out.update(
                launches=[ck.launches()],
                workers=[w.node_id for w in workers],
                summaries=[w.engine.kernel_dispatch_summary()
                           for w in workers],
                handoffs=[w.handoff_stats.snapshot() for w in workers])
        else:
            for p in procs:
                p.send_signal(15)
            reports = []
            for p, log in zip(procs, logs):
                if p.wait(SWARM_EXIT_S) != 0:
                    raise AssertionError(f"disagg_serve: worker exit "
                                         f"{p.returncode}")
                log.seek(0)
                lines = [x for x in log.read().splitlines()
                         if x.startswith('{"disagg_worker"')]
                if not lines:
                    raise AssertionError("disagg_serve: no worker report")
                reports.append(json.loads(lines[-1]))
            by_id = {x[0]: i for i, x in enumerate(allocation)}
            reports.sort(key=lambda rep: roles.index(rep["disagg_worker"]))
            if sorted(by_id) != sorted(rep["node_id"] for rep in reports):
                raise AssertionError(f"disagg_serve: reports {reports}")
            watch["adopt_ms"] = reports[1]["adopt_ms"]
            out.update(
                launches=[rep["launches"] for rep in reports],
                workers=[rep["node_id"] for rep in reports],
                summaries=[rep["summary"] for rep in reports],
                handoffs=[rep["handoffs"] for rep in reports])
    finally:
        stop_mon.set()
        for w in workers:
            w.stop()
            w.engine = None
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for log in logs:
            log.close()
        service.stop()
    return out


def _check_handoffs(label: str, run: dict) -> list[dict]:
    """A disaggregated run's handoffs: all by image (adopted on the decode
    head, no fallback, no re-prefill, no local restore), where_is the
    decode head, no prefill step on the decode head, the scheduler's
    disagg section active with a target chosen for each. Returns the
    figures of each handoff."""
    decode_id = run["workers"][1]
    p_stats, d_stats = run["handoffs"]
    rids = [r.request_id for r in run["reqs"]]
    log = p_stats["log"]
    if d_stats["handoffs"] != {"kv_image": len(rids)} \
            or p_stats["fallbacks"] or d_stats["fallbacks"] \
            or sorted(log) != sorted(rids) \
            or any(e.get("outcome") != "image" for e in log.values()):
        raise AssertionError(f"disagg_serve {label}: handoffs "
                             f"{d_stats['handoffs']}, fallbacks "
                             f"{p_stats['fallbacks']}, "
                             f"{d_stats['fallbacks']}, log {log}")
    if any(run["where_is"][rid] != decode_id for rid in rids):
        raise AssertionError(f"disagg_serve {label}: where_is "
                             f"{run['where_is']}")
    decode = run["per_worker"][1]
    if decode["prefill_steps"] or decode["launches"].get("kv_append") \
            or decode["launches"].get("gqa_prefill"):
        raise AssertionError(f"disagg_serve {label}: the decode head "
                             f"prefilled: {decode}")
    disagg = run["status"]["disagg"]
    if not disagg["active"] or disagg["targets_chosen"] < len(rids):
        raise AssertionError(f"disagg_serve {label}: status disagg "
                             f"{disagg}")
    figures = []
    for rid in rids:
        e = log[rid]
        figures.append({
            "rid": rid, "pages": e["pages"], "bytes": e["bytes"],
            "frames": e["frames"],
            "flag_to_park_ms": e["flag_to_park_ms"],
            "park_own_ms": e["park_ms"],
            "park_to_result_ms": e["park_to_result_ms"],
            "ship_to_result_ms": e["ship_to_result_ms"],
            "assemble_ms": d_stats["log"].get(rid, {}).get("assemble_ms"),
            "transfer_gb_per_s": e["bytes"] / e["ship_to_result_ms"] / 1e6,
            "adopt_ms": run["watch"]["adopt_ms"].get(rid)})
    return figures


def phase_disagg_serve(torch, dev, card, cfg, model_full, params) -> None:
    """Qwen2.5-7B served by a pair of workers, three times: both mixed,
    then prefill + decode, in this process (disagg_pair), then prefill +
    decode once more as two processes. Each run: every request ends by
    length with zero aborts; launches exact (this process's summed over
    the in-process pair, each worker process's on its own; graph warm-ups
    included); the greedy rows within GREEDY_TOL of the plain path. The
    disaggregated runs also (_check_handoffs): every request handed off
    by image, where_is the decode head, no prefill step and so no A0 / A1
    on the decode head, the scheduler's disagg section; and, in process,
    the first request's pages on the decode head right after its swap-in
    bitwise its harvested image; each greedy row the mixed run's tokens
    or within GREEDY_TOL of the plain path. Figures: per handoff, its
    pages, bytes, frames, flag -> park ms (and the park's own), park ->
    result ms, the decode head's assembly ms, the transfer's GB/s (bytes
    over first frame enqueued -> result) and adopt ms; each run's TTFT
    median and decode tok/s; the phase's wall."""
    t_phase = time.monotonic()
    n = cfg.num_hidden_layers
    runs = {}
    for label, roles, processes in DISAGG_RUNS:
        run = disagg_pair(torch, dev, cfg, params, roles, processes)
        free_device_memory(torch)
        reqs = run["reqs"]
        bad = [(r.request_id, r.status.value, len(r.output_ids))
               for r in reqs if r.status.value != "finished_length"
               or len(r.output_ids) != PREEMPT_NEW]
        if bad:
            raise AssertionError(f"disagg_serve {label}: {bad}")
        want, per_worker = {}, []
        for node, summary in zip(run["workers"], run["summaries"]):
            if summary["impl"] != "cuda-fused":
                raise AssertionError(f"disagg_serve {label} {node}: impl "
                                     f"{summary['impl']}")
            mine = gqa_expected("fused", summary, n)
            for k, v in summary.get("graphs", {}).get(
                    "warmup_launches", {}).items():
                mine[k] = mine.get(k, 0) + v
            decode, prefill = forward_steps(summary)
            per_worker.append({"decode_steps": decode,
                               "prefill_steps": prefill,
                               "graph_replays": summary.get(
                                   "graphs", {}).get("replays", 0),
                               "launches": mine})
            if processes:
                check_launches("disagg_serve", f"{label} {node}",
                               run["launches"][len(per_worker) - 1], mine,
                               {})
            for k, v in mine.items():
                want[k] = want.get(k, 0) + v
        if not processes:
            check_launches("disagg_serve", label, run["launches"][0], want,
                           {})
        run["per_worker"] = per_worker
        run["roles"] = [r or "mixed" for r in roles]
        runs[label] = run
    mixed = runs["mixed"]
    if any(mixed["where_is"].values()):
        raise AssertionError(f"disagg_serve mixed: handoffs "
                             f"{mixed['where_is']}")
    watch = runs["disagg"]["watch"]
    if not watch.get("pages_equal"):
        raise AssertionError(f"disagg_serve: {mixed['reqs'][0].request_id}"
                             f"'s adopted pages are not its harvested "
                             f"image ({watch.get('swapped_in_pages')} "
                             "pages)")
    # Greedy rows: the mixed run's against the plain path; each
    # disaggregated row the mixed run's tokens, or within GREEDY_TOL.
    worst, *_ = greedy_check(torch, model_full, params, mixed["reqs"],
                             mixed["sampled"], dev, tol=GREEDY_TOL)
    checks = {}
    for label in ("disagg", "disagg_processes"):
        run = runs[label]
        figures = _check_handoffs(label, run)
        same = {r.request_id: r.output_ids == m.output_ids
                for r, m in zip(run["reqs"], mixed["reqs"])}
        parted = [r for i, r in enumerate(run["reqs"])
                  if i not in run["sampled"] and not same[r.request_id]]
        gap = 0.0
        if parted:
            gap, *_ = greedy_check(torch, model_full, params, parted, {},
                                   dev, tol=GREEDY_TOL)
        p_stats = run["handoffs"][0]
        checks[label] = {
            "handoffs": figures, "mode": run["handoffs"][1]["handoffs"],
            "fallbacks": p_stats["fallbacks"],
            "transfer_bytes": p_stats["transfer_bytes"]["out"],
            "transfer_frames": p_stats["transfer_frames"]["out"],
            "greedy_rows_equal_to_mixed": sum(
                same[r.request_id] for i, r in enumerate(run["reqs"])
                if i not in run["sampled"]),
            "greedy_rows_parted": [r.request_id for r in parted],
            "largest_logit_gap_parted": gap,
            "status_disagg": run["status"]["disagg"]}
    for label, run in runs.items():
        emit({"phase": "disagg_serve", "run": label, "roles": run["roles"],
              "processes": label == "disagg_processes",
              "allocation": run["allocation"], "launches": run["launches"],
              "per_worker": run["per_worker"],
              **stream_metrics(run["reqs"], run["t0"], run["t1"]),
              "card": card})
    for label, check in checks.items():
        emit({"phase": "disagg_serve", "check": f"{label}_handoffs",
              **check, "chunk_bytes": 4 << 20,
              "where_is": "the decode head for each",
              "decode_head_prefill_steps": 0, "tolerance": GREEDY_TOL,
              "card": card})
    emit({"phase": "disagg_serve", "check": "pages_and_greedy",
          "first_request_pages_bitwise": watch["swapped_in_pages"],
          "greedy_vs_plain": "pass", "largest_logit_gap_mixed": worst,
          "tolerance": GREEDY_TOL, "wall_s": time.monotonic() - t_phase,
          "card": card})


# ---------------------------------------------------------------------------
# Phase 7: http_serve, the front door
# ---------------------------------------------------------------------------

HTTP_TIMEOUT_S = 300
GENERATE_SUMMARY = (r"(\d+) prompt \+ (\d+) generated tokens \| ttft "
                    r"([\d.]+)s \| decode ([\d.]+) tok/s \| (\w+)")


def hf_tensors(tree) -> dict:
    """A dense stage tree under HF checkpoint names (``model.`` prefixed,
    ``lm_head`` outside it), in the tree's order."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix if prefix.startswith("lm_head.")
                else f"model.{prefix}"] = node

    walk("", tree)
    return out


def write_checkpoint(tensors: dict, raw_cfg: dict, path: str,
                     shard_bytes: int | None = None) -> int:
    """Write ``tensors`` (name -> torch tensor, on any device) as an HF
    safetensors checkpoint under ``path`` with the package's own writer
    (``utils/st_writer.py``: shards of about ``shard_bytes``, HF's 5 GB by
    default, the index, ``config.json``; the card may lack the
    ``safetensors`` package). Returns the bytes of tensor data written."""
    from parallax_tpu_torch.utils.st_writer import SHARD_BYTES
    from parallax_tpu_torch.utils.st_writer import write_checkpoint as write

    return write(tensors, raw_cfg, path, shard_bytes or SHARD_BYTES)


def _text_mix(seed: int = 2024):
    """The serve phases' 8-request mix as text for the byte tokenizer:
    prompts of 259-699 printable bytes (260-700 ids with BOS; chat adds its
    template), r0 and r7 sharing a 256-byte prefix; r2, r4 and r6 seeded
    top-k, the rest greedy; 32 tokens each; r0, r2, r4 and r7 through
    /v1/chat/completions, the rest /v1/completions; r1, r2, r5 and r7
    streamed. Another ``seed`` draws other text of the same shape."""
    import string

    rng = random.Random(seed)
    chars = string.ascii_letters + string.digits + " .,;:!?-"

    def text(n):
        return "".join(rng.choice(chars) for _ in range(n))

    prefix = text(256)
    prompts = [prefix + text(3)] + [text(n - 1) for n in
                                     (300, 450, 700, 512, 380, 640)]
    prompts.append(prefix + text(149))
    sampled = {2: (0.8, 20, 11), 4: (1.0, 64, 5), 6: (0.7, 8, 9)}
    mix = []
    for i, p in enumerate(prompts):
        temp, top_k, seed = sampled.get(i, (0.0, -1, None))
        body = {"max_tokens": 32, "temperature": temp, "top_k": top_k,
                "ignore_eos": True, "stream": i in (1, 2, 5, 7)}
        if seed is not None:
            body["seed"] = seed
        if i in (0, 2, 4, 7):
            path = "/v1/chat/completions"
            body["messages"] = [{"role": "user", "content": p}]
        else:
            path = "/v1/completions"
            body["prompt"] = p
        mix.append((path, body))
    return mix, sampled


def _http_client(port: int, path: str, body: dict, out: dict) -> None:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        out["t_send"] = time.monotonic()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        out["raw"] = resp.read().decode()
        out["t_done"] = time.monotonic()
    finally:
        conn.close()


def _http_reply(out: dict, body: dict):
    """(request id, finish reason, usage, text) of one client's reply."""
    if out.get("status") != 200:
        raise AssertionError(f"http_serve: status {out.get('status')}: "
                             f"{out.get('raw', '')[:300]}")
    chat = "messages" in body
    if not body["stream"]:
        reply = json.loads(out["raw"])
        c = reply["choices"][0]
        text = c["message"]["content"] if chat else c["text"]
        return reply["id"], c["finish_reason"], reply["usage"], text
    lines = out["raw"].splitlines()
    if "data: [DONE]" not in lines:
        raise AssertionError("http_serve: a stream without data: [DONE]")
    chunks = [json.loads(x[6:]) for x in lines
              if x.startswith("data: ") and x != "data: [DONE]"]
    text = "".join(c["choices"][0]["delta"].get("content", "") if chat
                   else c["choices"][0]["text"] for c in chunks)
    last = chunks[-1]
    return (last["id"], last["choices"][0]["finish_reason"], last["usage"],
            text)


def http_feature_bodies():
    """The feature requests sent after the mix: (name, path, body). JSON
    mode both ways (the schema of features_serve, at most 21 bytes and EOS,
    and json_object), on chat and completions; logprobs streamed and not;
    logit_bias; penalties; a schema the compiler refuses (400)."""
    prompt = "Reply with a JSON object naming one of x or y."
    chat = {"messages": [{"role": "user", "content": prompt}],
            "max_tokens": 32, "temperature": 0}
    comp = {"prompt": prompt, "max_tokens": 32, "temperature": 0}
    schema = {"type": "json_schema",
              "json_schema": {"name": "v", "schema":
                              json.loads(FEATURE_SCHEMA)}}
    out = []
    for kind, path, base in (("chat", "/v1/chat/completions", chat),
                             ("completion", "/v1/completions", comp)):
        out += [
            (f"{kind}_json_schema", path,
             {**base, "response_format": schema}),
            # Any JSON value, unbounded on random weights: '{', '}' and
            # EOS biased so the reply closes ({}) and stops there.
            (f"{kind}_json_object", path,
             {**base, "response_format": {"type": "json_object"},
              "logit_bias": {"123": 10.0, "125": 10.0, "257": 20.0}}),
            (f"{kind}_logprobs", path,
             {**base, "logprobs": True, "ignore_eos": True}),
            (f"{kind}_logprobs_stream", path,
             {**base, "logprobs": True, "ignore_eos": True,
              "stream": True}),
            (f"{kind}_logit_bias", path,
             {**base, "logit_bias": {"120": 6.0, "121": -3.0},
              "ignore_eos": True}),
            (f"{kind}_penalties", path,
             {**base, "presence_penalty": 0.5, "frequency_penalty": 0.2,
              "repetition_penalty": 1.3, "temperature": 0.8, "seed": 3,
              "top_k": 40, "ignore_eos": True, "logprobs": True,
              "stream": True}),
        ]
    out.append(("bad_schema", "/v1/chat/completions",
                {**chat, "response_format": {
                    "type": "json_schema",
                    "json_schema": {"schema": {"type": "frobnicate"}}}}))
    return out


def http_feature_checks(features) -> dict:
    """Each feature reply 200 (the bad schema 400) with one logprob entry
    a completion token where logprobs were asked (each <= 0), and JSON
    where a schema was (the schema's own where it was given)."""
    got = {}
    for name, path, body, out in features:
        if name == "bad_schema":
            if out.get("status") != 400:
                raise AssertionError(f"http_serve {name}: {out}")
            got[name] = 400
            continue
        chat = path.endswith("chat/completions")
        if out.get("status") != 200:
            raise AssertionError(f"http_serve {name}: {out}")
        if body.get("stream"):
            lines = out["raw"].splitlines()
            chunks = [json.loads(x[6:]) for x in lines
                      if x.startswith("data: ") and x != "data: [DONE]"]
            choices = [c["choices"][0] for c in chunks]
            usage = chunks[-1]["usage"]
            text = "".join(c["delta"].get("content", "") if chat
                           else c["text"] for c in choices)
        else:
            reply = json.loads(out["raw"])
            choices = reply["choices"]
            usage = reply["usage"]
            text = (choices[0]["message"]["content"] if chat
                    else choices[0]["text"])
        lps = []
        for c in choices:
            lp = c.get("logprobs") or {}
            lps += ([e["logprob"] for e in lp.get("content", [])] if chat
                    else lp.get("token_logprobs", []))
        want = usage["completion_tokens"] if body.get("logprobs") else 0
        if len(lps) != want or any(x > 0.0 for x in lps):
            raise AssertionError(f"http_serve {name}: {len(lps)} logprobs "
                                 f"for {usage['completion_tokens']} tokens")
        rf = body.get("response_format")
        if rf:
            obj = json.loads(text)
            if rf["type"] == "json_schema":
                schema_json(text.encode())
            text = obj
        got[name] = {"completion_tokens": usage["completion_tokens"],
                     "logprobs": len(lps), "json": text if rf else None}
    return got


def _serve_http(torch, dev, ckpt: str, mix, extra_args=(), after=None):
    """``serve`` through the CLI's parser and ``serve_main`` on a free port
    in a thread (``extra_args`` appended to its command line); the mix
    from 8 client threads (r7 once r0 is answered, so that it finds r0's
    prefix in the cache), then the feature requests and ``after(port)``
    (its result in ``info["after"]``, with every finished request by id in
    ``info["finished_after"]``); then the server is stopped. Returns the
    replies, the finished requests by id, the launches and the engine's
    summary (the launches and summary read before the feature
    requests)."""
    import threading

    from parallax_tpu_torch import cli
    from parallax_tpu_torch.backend.serve import serve_main
    from parallax_tpu_torch.ops import cuda_kernels as ck

    args = cli.build_parser().parse_args([
        "serve", "--model-path", ckpt, "--device", str(dev),
        "--host", "127.0.0.1", "--port", "0", "--max-batch-size", "7",
        "--page-size", "64", "--max-model-len", "1024", *extra_args])
    if cli.unported_flags(args):
        raise AssertionError(f"http_serve: {cli.unported_flags(args)}")
    box, started = [], threading.Event()

    def on_start(frontend, runner):
        box.append((frontend, runner))
        started.set()

    server = threading.Thread(target=serve_main, args=(args, on_start),
                              name="http-serve", daemon=True)
    t0 = time.monotonic()
    server.start()
    if not started.wait(HTTP_TIMEOUT_S):
        raise AssertionError("http_serve: the server did not start")
    startup_s = time.monotonic() - t0
    frontend, runner = box[0]
    engine = runner.pipeline.head
    # Nothing runs on the card now; from here until the server stops this
    # thread makes no CUDA call (a graph capture on the runner thread
    # allows none from any other thread).
    ck.reset_launches()
    outs = [{} for _ in mix]
    clients = [threading.Thread(target=_http_client, daemon=True,
                                args=(frontend.port, path, body, out))
               for (path, body), out in zip(mix, outs)]
    try:
        for c in clients[:-1]:
            c.start()
        clients[0].join(HTTP_TIMEOUT_S)
        clients[-1].start()
        for c in clients:
            c.join(HTTP_TIMEOUT_S)
        if any(c.is_alive() for c in clients):
            raise AssertionError("http_serve: a client is still waiting")
        launches = ck.launches()
        summary = engine.kernel_dispatch_summary()
        finished = {r.request_id: r for r in runner.pipeline.finished}
        info = {"startup_s": startup_s, "num_pages": engine.cfg.num_pages,
                "prefill_chunk_size": engine.cfg.prefill_chunk_size,
                "cache": engine.cache_stats()}
        # Then the sampling features, one request at a time.
        info["features"] = []
        for name, path, body in http_feature_bodies():
            out = {}
            _http_client(frontend.port, path, body, out)
            info["features"].append((name, path, body, out))
        info["constrained"] = engine.constrained_summary()
        if after is not None:
            info["after"] = after(frontend.port)
            info["finished_after"] = {r.request_id: r
                                      for r in runner.pipeline.finished}
            info["engine_cfg"] = dataclasses.asdict(engine.cfg)
    finally:
        frontend.shutdown()
        server.join(HTTP_TIMEOUT_S)
    if server.is_alive() or runner.error is not None:
        raise AssertionError(f"http_serve: the server did not stop cleanly "
                             f"({runner.error})")
    return outs, finished, launches, summary, info


def phase_http_serve(torch, dev, card: str, cfg, tree: list,
                     swarm: bool = False, sched: bool = False,
                     ha: bool = False, relay: bool = False,
                     obs: bool = False, qos: bool = False,
                     quant: bool = False, lora: bool = False,
                     refit: bool = False) -> None:
    """The port's front door on Qwen2.5-7B at full width: the random tree
    written as an HF checkpoint, the CLI's ``generate`` run on it in a
    subprocess, the checkpoint loaded back bitwise, then ``serve`` (CLI
    parser + ``serve_main``, pages from the addressable cap) answering the
    8-request mix over HTTP; launches exact, greedy rows against the plain
    path on the loaded weights, the prefix cache hit. ``tree`` holds the
    only reference to the random tree, dropped once it loaded back. With
    ``quant``, ``http_quant`` serves the same checkpoint quantized on
    load. With ``swarm``, phase_swarm_serve follows in the same checkpoint
    directory (the checkpoint is written once), with ``sched``
    phase_sched_serve,
    with ``ha`` phase_ha_serve, with ``relay`` phase_relay_serve, with
    ``obs`` phase_obs_serve and with ``qos`` qos_serve's part (b). With
    ``lora``, lora_serve's part (b): the same ``serve`` launch gets
    ``--lora-adapters`` (PEFT directories written beside the checkpoint)
    and answers adapter requests after the mix and the features
    (``lora_http``). With ``refit``, refit_serve: its donor beside the
    checkpoint, part (a) here and part (b) inside phase_sched_serve (which
    ``refit`` runs)."""
    import os
    import re
    import shutil
    import tempfile

    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.loader import load_stage_params
    from parallax_tpu_torch.models.presets import PRESETS

    raw = dict(PRESETS[DENSE_MODEL], num_hidden_layers=cfg.num_hidden_layers)
    tensors = hf_tensors(tree[0])
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    n = cfg.num_hidden_layers
    with tempfile.TemporaryDirectory(prefix="http_serve_") as ckpt:
        free = shutil.disk_usage(ckpt).free
        emit({"phase": "http_serve", "checkpoint_bytes": nbytes,
              "disk_free_bytes": free, "dir": ckpt, "layers": n})
        if free < nbytes + (1 << 30):
            raise AssertionError(f"http_serve: {free} bytes free under "
                                 f"{ckpt}, the checkpoint needs {nbytes}")
        t0 = time.monotonic()
        write_checkpoint(tensors, raw, ckpt)
        write_s = time.monotonic() - t0
        shards = sorted(f for f in os.listdir(ckpt)
                        if f.endswith(".safetensors"))
        emit({"phase": "http_serve", "written_bytes": nbytes,
              "shards": len(shards), "write_s": write_s,
              "write_gb_per_s": nbytes / write_s / 1e9})
        del tensors

        # The CLI's generate in a process of its own.
        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.monotonic()
        gen = subprocess.run(
            [sys.executable, "-m", "parallax_tpu_torch", "generate",
             "--model-path", ckpt, "--max-tokens", "16"],
            cwd=repo, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": repo})
        gen_s = time.monotonic() - t0
        m = re.search(GENERATE_SUMMARY, gen.stderr)
        if gen.returncode != 0 or m is None:
            raise AssertionError(f"http_serve: generate exited "
                                 f"{gen.returncode}: {gen.stderr[-2000:]}")
        emit({"phase": "http_serve", "cli": "generate", "exit": 0,
              "summary": m.group(0), "prompt_tokens": int(m.group(1)),
              "generated_tokens": int(m.group(2)),
              "ttft_s": float(m.group(3)),
              "decode_tok_per_s": float(m.group(4)),
              "process_wall_s": gen_s, "card": card})

        # Load it back: every leaf the written one's bits.
        model = create_stage_model(cfg, 0, n)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loaded = load_stage_params(model, ckpt, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        written, got = hf_tensors(tree[0]), hf_tensors(loaded)
        if list(written) != list(got) or not all(
                torch.equal(written[k], got[k]) for k in written):
            raise AssertionError("http_serve: the loaded tree differs from "
                                 "the written one")
        emit({"phase": "http_serve", "load": "bitwise equal",
              "leaves": len(got), "load_s": load_s,
              "load_gb_per_s": nbytes / load_s / 1e9,
              "page_cache": "warm (written just before)", "card": card})
        del written, got
        tree.clear()
        free_device_memory(torch)

        # serve over HTTP.
        mix, sampled = _text_mix()
        peft = lora_peft_dirs(torch, dev, cfg, ckpt) if lora else None
        outs, finished, launches, summary, info = _serve_http(
            torch, dev, ckpt, mix,
            extra_args=(("--lora-adapters", ",".join(
                f"{k}={v}" for k, v in peft.items())) if lora else ()),
            after=(lambda port: lora_http_requests(port, ckpt))
            if lora else None)
        free_device_memory(torch)
        if lora:
            lora_http(torch, dev, card, cfg, ckpt, loaded, peft,
                      info.pop("after"), info.pop("finished_after"),
                      info.pop("engine_cfg"))
        reqs = http_results(torch, dev, card, cfg, loaded, mix, sampled,
                            outs, finished, launches, summary, info)
        if quant:
            http_quant(torch, dev, card, cfg, ckpt, mix, sampled)
        if swarm:
            phase_swarm_serve(torch, dev, card, cfg, loaded, ckpt, mix,
                              sampled, reqs)
        donor = None
        if refit:
            t0 = time.monotonic()
            donor = refit_donor(torch, dev, card, cfg, ckpt)
            refit_in_process(torch, dev, card, cfg, loaded, donor)
            free_device_memory(torch)
            emit({"phase": "refit_serve", "part": "a",
                  "seconds": time.monotonic() - t0, "card": card})
        if sched or refit:
            phase_sched_serve(torch, dev, card, cfg, loaded, ckpt, mix,
                              sampled, reqs, refit=donor)
        if refit:
            os.remove(donor["path"])
            emit({"phase": "refit_serve", "donor_removed": donor["path"],
                  "donor_bytes": donor["bytes"],
                  "disk_free_bytes": shutil.disk_usage(ckpt).free,
                  "card": card})
            del donor
            free_device_memory(torch)
        if ha:
            phase_ha_serve(torch, dev, card, cfg, loaded, ckpt, mix,
                           sampled, reqs)
        if relay:
            phase_relay_serve(torch, dev, card, cfg, loaded, ckpt, mix,
                              sampled, reqs)
        if obs:
            phase_obs_serve(torch, dev, card, cfg, loaded, ckpt, mix)
        if qos:
            del loaded
            free_device_memory(torch)
            t0 = time.monotonic()
            qos_http(torch, dev, card, ckpt)
            emit({"phase": "qos_serve", "part": "b",
                  "seconds": time.monotonic() - t0, "card": card})


# lora_serve (b): the adapters written as PEFT directories beside
# http_serve's checkpoint, (name, rank, sites, seed) as LORA_ADAPTERS.
LORA_PEFT = (("a", 16, "all", 201), ("b", 8, "attn_half", 202))
LORA_HTTP_PROMPT = ("Adapters ride the same weights: one base model, many "
                    "tenants, each with its own low-rank delta.")


def lora_peft_dirs(torch, dev, cfg, ckpt: str) -> dict:
    """LORA_PEFT drawn on the card and written with the package's writer
    under ``ckpt`` (``peft_<name>``); returns {name: directory}."""
    import os

    from parallax_tpu_torch.utils.st_writer import write_peft_adapter

    out = {}
    for name, rank, sites, seed in LORA_PEFT:
        path = os.path.join(ckpt, f"peft_{name}")
        write_peft_adapter(path, lora_tree(torch, dev, cfg, rank, sites,
                                           seed),
                           rank=rank, alpha=LORA_SCALE * rank)
        out[name] = path
    return out


def lora_http_requests(port: int, model: str) -> dict:
    """After the mix: ``/v1/models``, then one greedy completion at a time
    as base, with ``"lora": "a"``, as ``model: "<name>:b"`` and as an
    unknown adapter's variant. Returns the replies."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("GET", "/v1/models")
        resp = conn.getresponse()
        models = (resp.status, json.loads(resp.read()))
    finally:
        conn.close()
    body = {"prompt": LORA_HTTP_PROMPT, "max_tokens": 32,
            "temperature": 0.0, "ignore_eos": True}
    outs = {}
    for key, extra in (("base", {}), ("a", {"lora": "a"}),
                       ("b", {"model": f"{model}:b"}),
                       ("nope", {"model": f"{model}:nope"})):
        out = {}
        _http_client(port, "/v1/completions", {**body, **extra}, out)
        outs[key] = out
    return {"models": models, "outs": outs}


def lora_http(torch, dev, card, cfg, ckpt: str, loaded, peft: dict,
              got: dict, finished: dict, engine_cfg: dict) -> None:
    """lora_serve (b)'s checks on the ``serve --lora-adapters`` replies:
    ``/v1/models`` lists the variants; base, ``"lora": "a"`` and
    ``<model>:b`` answer 200 with the library's tokens for the same
    adapters on the loaded tree (each alone, the server's engine config);
    the unknown adapter gets the JAX front door's 502. Then the load-time
    merge (``load_stage_params(lora_path=)``) and the ``lora-merge``
    command's output load to trees within bf16 rounding of each other, and
    a request on each serves within GREEDY_TOL of the plain path with the
    adapter applied per request."""
    import contextlib
    import io
    import os
    import shutil

    from parallax_tpu_torch import cli
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.loader import load_stage_params
    from parallax_tpu_torch.ops.lora import AdapterSet, adapter_tree_from_peft
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    t_b = time.monotonic()
    n = cfg.num_hidden_layers
    status, models = got["models"]
    ids = [m["id"] for m in models["data"]]
    if status != 200 or ids != [ckpt, f"{ckpt}:a", f"{ckpt}:b"]:
        raise AssertionError(f"lora_serve (b): /v1/models {status} {ids}")
    served = {}
    for key in ("base", "a", "b"):
        out = got["outs"][key]
        if out.get("status") != 200:
            raise AssertionError(f"lora_serve (b) {key}: {out.get('status')}"
                                 f" {out.get('raw', '')[:300]}")
        served[key] = finished[json.loads(out["raw"])["id"]]
    nope = got["outs"]["nope"]
    message = json.loads(nope["raw"])["error"]["message"]
    if nope["status"] != 502 or message != (
            "generation failed: unknown lora adapter 'nope'"):
        raise AssertionError(f"lora_serve (b) nope: {nope['status']} "
                             f"{message}")
    # The library, one request at a time as the server took them, on the
    # server's engine config (no host tier: it moves no bit).
    kw = {k: v for k, v in engine_cfg.items() if k != "host_cache_bytes"}
    max_len = kw.pop("max_model_len")
    lib = {}
    for key in ("base", "a", "b"):
        r = served[key]
        req = Request(f"lib_{key}", prompt_ids=list(r.prompt_ids),
                      lora_id=None if key == "base" else key,
                      sampling_params=SamplingParams(
                          temperature=0.0, max_new_tokens=32,
                          ignore_eos=True))
        lib[key] = serve(torch, [(0, n)], loaded, cfg, dev, fused=True,
                         max_model_len=max_len, engine_kw=kw,
                         requests=([req], {}), grammar=False,
                         on_engines=lambda es: [es[0].load_adapter(k, v)
                                                for k, v in peft.items()]
                         )[0][0]
    differ = [k for k in lib if lib[k].output_ids != served[k].output_ids]
    if differ or served["a"].output_ids == served["base"].output_ids:
        raise AssertionError(f"lora_serve (b): the server's tokens differ "
                             f"from the library's for {differ}")
    # Load-time merge against the lora-merge command's output.
    merged_dir = os.path.join(ckpt, "merged_a")
    need = sum(os.path.getsize(os.path.join(ckpt, f))
               for f in os.listdir(ckpt) if f.endswith(".safetensors"))
    if shutil.disk_usage(ckpt).free < need + (1 << 30):
        raise AssertionError("lora_serve (b): no room for the merged copy")
    t0 = time.monotonic()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["lora-merge", "--model-path", ckpt, "--adapter-path",
                       peft["a"], "--out-dir", merged_dir])
    if rc != 0:
        raise AssertionError("lora_serve (b): lora-merge failed")
    merge_s = time.monotonic() - t0
    model = create_stage_model(cfg, 0, n)
    t0 = time.monotonic()
    at_load = load_stage_params(model, ckpt, device=dev, lora_path=peft["a"])
    torch.cuda.synchronize()
    load_merge_s = time.monotonic() - t0
    tool = load_stage_params(model, merged_dir, device=dev)
    a_leaves, t_leaves = list(_leaves(at_load)), list(_leaves(tool))
    if len(a_leaves) != len(t_leaves):
        raise AssertionError("lora_serve (b): the merged trees differ")
    differing, worst_rel = 0, 0.0
    for x, y in zip(a_leaves, t_leaves):
        d = (x.float() - y.float()).abs()
        # One bf16 rounding apart at most: |x| * 2**-7.
        if bool((d > x.float().abs() * 2.0 ** -7).any()):
            raise AssertionError("lora_serve (b): the merges differ past "
                                 "bf16 rounding")
        differing += int((d > 0).sum())
        worst_rel = max(worst_rel, float((d / x.float().abs().clamp_min(
            1e-30)).max()))
    shutil.rmtree(merged_dir)
    ref = AdapterSet(device=dev)
    ref.register("a", adapter_tree_from_peft(peft["a"], 0, n))
    model_ref = create_stage_model(cfg, 0, n, use_kernels=False)
    merged_runs = []
    for label, tree in (("load_time_merge", at_load), ("lora_merge", tool)):
        req = Request(f"merged_{label}", prompt_ids=list(
            served["a"].prompt_ids), sampling_params=SamplingParams(
                temperature=0.0, max_new_tokens=32, ignore_eos=True))
        merged_runs.append(serve(torch, [(0, n)], tree, cfg, dev,
                                 fused=True, max_model_len=max_len,
                                 engine_kw=kw,
                                 requests=([req], {}), grammar=False)[0][0])
    worst, *_ = greedy_check(torch, model_ref, loaded,
                             merged_runs + [served["a"]], {}, dev,
                             tol=GREEDY_TOL,
                             lora_of=lambda r: ref.batch_field("a"))
    del at_load, tool
    free_device_memory(torch)
    emit({"phase": "lora_serve", "part": "b", "models": ids,
          "status": {"base": 200, "a": 200, "b": 200, "nope": 502},
          "server_tokens_equal_library": ["base", "a", "b"],
          "merge": {"lora_merge_says": printed.getvalue().strip(),
                    "lora_merge_s": merge_s, "load_time_merge_s":
                    load_merge_s, "elements_differing": differing,
                    "largest_relative_difference": worst_rel,
                    "limit": "one bf16 rounding (|x| * 2**-7)"},
          "merged_vs_per_request_greedy": "pass",
          "largest_logit_gap": worst, "tolerance": GREEDY_TOL,
          "merged_rows_identical_to_per_request": sum(
              r.output_ids == served["a"].output_ids for r in merged_runs),
          "seconds": time.monotonic() - t_b, "card": card})


def mlx_tensors(tree, bits: int) -> dict:
    """A quantized stage tree under MLX checkpoint names: each quantized
    module's values packed into uint32 words as its ``weight``
    (``pack_uint32``, little-endian in the word) beside its ``scales`` and
    ``biases``; float leaves as ``hf_tensors`` names them."""
    import torch

    from parallax_tpu_torch.ops.quant import pack_uint32

    out = {}
    for name, t in hf_tensors(tree).items():
        base, _, leaf = name.rpartition(".")
        if leaf == "qweight":
            # The words' uint32 view is taken on the host.
            out[base + ".weight"] = pack_uint32(t, bits).cpu().view(
                torch.uint32)
        else:
            out[name] = t
    return out


def http_quant(torch, dev, card, cfg, ckpt: str, mix, sampled) -> None:
    """The CLI path of quantization: ``serve --quantization int8`` over
    HTTP on http_serve's checkpoint (the mix from 8 clients): replies,
    launches exact (A10 seven times a layer plus the lm_head each forward
    step), greedy rows within GREEDY_TOL of the plain one-shot logits of
    the same tree quantized on load by the library, and that tree served
    by the library API on the same prompts (its greedy rows too, and how
    many equal the HTTP ones: the server's batches form as its clients
    arrive, so a row may part at a near-tie). Then an MLX-format
    checkpoint of that tree (``mlx_tensors``, config ``quantization``
    bits 8, group QUANT_GROUP) must load back into it bitwise."""
    import tempfile

    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.loader import load_stage_params
    from parallax_tpu_torch.models.presets import PRESETS
    from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer

    n = cfg.num_hidden_layers
    outs, finished, launches, summary, info = _serve_http(
        torch, dev, ckpt, mix, ("--quantization", "int8"))
    free_device_memory(torch)
    tok = SimpleTokenizer()
    reqs = []
    for out, (_, body) in zip(outs, mix):
        rid, reason, usage, text = _http_reply(out, body)
        r = finished[rid]
        if (reason != "length" or r.status.value != "finished_length"
                or len(r.output_ids) != 32
                or text != tok.decode(r.output_ids)):
            raise AssertionError(f"http_serve int8 {rid}: {reason}, "
                                 f"{usage}, {r.status.value}")
        reqs.append(r)
    check_launches("http_serve", "int8", launches, {
        **gqa_expected("fused", summary, n),
        **quant_expected("fused", summary, 7 * n + 1)}, summary)
    check_windows("http_serve", "int8", summary, True)
    model = create_stage_model(cfg, 0, n)
    qtree = load_stage_params(model, ckpt, device=dev, quantize="int8")
    model_ref = create_stage_model(cfg, 0, n, use_kernels=False)
    worst, over, *_ = greedy_check(torch, model_ref, qtree, reqs, sampled,
                                   dev, tol=GREEDY_TOL)
    lib, _, engines, t0, t1 = serve(
        torch, [(0, n)], qtree, cfg, dev, fused=True,
        engine_kw=dict(num_pages=info["num_pages"],
                       prefill_chunk_size=info["prefill_chunk_size"]),
        requests=(_swarm_requests(reqs, sampled), sampled), grammar=False)
    del engines
    worst_lib, *_ = greedy_check(torch, model_ref, qtree, lib, sampled, dev,
                                 tol=GREEDY_TOL)
    greedy = [i for i in range(len(reqs)) if i not in sampled]
    with tempfile.TemporaryDirectory(prefix="mlx_ckpt_") as mlx:
        raw = dict(PRESETS[DENSE_MODEL], num_hidden_layers=n,
                   quantization={"bits": 8, "group_size": QUANT_GROUP})
        written = mlx_tensors(qtree, 8)
        nbytes = write_checkpoint(written, raw, mlx)
        del written
        t_load = time.monotonic()
        loaded = load_stage_params(model, mlx, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t_load
    want, got = hf_tensors(qtree), hf_tensors(loaded)
    if set(want) != set(got) or not all(
            want[k].dtype == got[k].dtype and torch.equal(want[k], got[k])
            for k in want):
        raise AssertionError("http_serve: the MLX checkpoint did not load "
                             "into the on-load int8 tree bitwise")
    emit({"phase": "http_serve", "run": "serve_quantization_int8",
          "requests": len(reqs), "status": "8 x 200", "launches": launches,
          "steps": sum(forward_steps(summary)), "dispatch": summary,
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tolerance": GREEDY_TOL,
          f"tokens_off_by_{GREEDY_TOL}_or_more": over,
          "library_api_largest_logit_gap": worst_lib,
          "greedy_rows_identical_to_library_api": sum(
              reqs[i].output_ids == lib[i].output_ids for i in greedy),
          "greedy_rows": len(greedy),
          "library_api": stream_metrics(lib, t0, t1),
          "mlx_checkpoint": {"bytes": nbytes, "load_s": load_s,
                             "leaves": len(got),
                             "bitwise_equal_to_on_load_int8": True},
          "tree_bytes": tree_bytes(qtree), "card": card})
    del qtree, loaded, want, got
    free_device_memory(torch)


def http_results(torch, dev, card, cfg, loaded, mix, sampled, outs,
                 finished, launches, summary, info) -> list:
    """http_serve's checks and figures: every reply against its request,
    launches exact, greedy rows against the plain path; then the same mix
    through the library API. Returns the served requests in mix order."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer

    n = cfg.num_hidden_layers
    tok = SimpleTokenizer()
    reqs = []
    for out, (_, body) in zip(outs, mix):
        rid, reason, usage, text = _http_reply(out, body)
        r = finished[rid]
        if (reason != "length" or r.status.value != "finished_length"
                or usage["completion_tokens"] != 32
                or len(r.output_ids) != 32
                or usage["prompt_tokens"] != len(r.prompt_ids)):
            raise AssertionError(f"http_serve {rid}: {reason}, {usage}, "
                                 f"{r.status.value}")
        if text != tok.decode(r.output_ids):
            raise AssertionError(f"http_serve {rid}: the text is not the "
                                 "ids' decode")
        r.t_send, r.t_done = out["t_send"], out["t_done"]
        r.usage = usage
        reqs.append(r)
    if summary["impl"] != "cuda-fused":
        raise AssertionError(f"http_serve: impl {summary['impl']}")
    check_launches("http_serve", "fused", launches,
                   gqa_expected("fused", summary, n), summary)
    check_windows("http_serve", "fused", summary, True)
    sharer = reqs[-1]
    if sharer.num_cached_tokens <= 0:
        raise AssertionError("http_serve: the sharer did not hit the "
                             "prefix cache")
    model_ref = create_stage_model(cfg, 0, n, use_kernels=False)
    worst, *_ = greedy_check(torch, model_ref, loaded, reqs, sampled, dev,
                             tol=GREEDY_TOL)
    ttft = [r.first_token_time - r.t_send for r in reqs]
    first = min(r.first_token_time for r in reqs)
    t_end = max(r.t_done for r in reqs)
    t_start = min(r.t_send for r in reqs)
    FIGURES["http"] = {
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "decode_tok_per_s": sum(len(r.output_ids) - 1 for r in reqs)
        / (t_end - first),
        "output_tok_per_s": sum(len(r.output_ids) for r in reqs)
        / (t_end - t_start)}
    emit({"phase": "http_serve", "check": "sampling_features",
          "replies": http_feature_checks(info.pop("features")),
          "constrained": info.pop("constrained"), "card": card})
    emit({"phase": "http_serve", "run": "http", "requests": len(reqs),
          "status": "8 x 200", "launches": launches,
          "steps": sum(forward_steps(summary)), "dispatch": summary,
          "sharer_cached_tokens": sharer.num_cached_tokens,
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tolerance": GREEDY_TOL,
          # Client send to the engine's first commit, in this process.
          "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
          "ttft_s_r7": ttft[7],
          # The streams' own usage.ttft_ms: the handler's poll that first
          # saw a token.
          "stream_usage_ttft_ms": [r.usage["ttft_ms"] for r in reqs
                                   if "ttft_ms" in r.usage],
          "decode_tok_per_s": sum(len(r.output_ids) - 1 for r in reqs)
          / (t_end - first),
          "output_tok_per_s": sum(len(r.output_ids) for r in reqs)
          / (t_end - t_start),
          "wall_s": t_end - t_start, **info, "card": card})

    # The same mix through the library API, the engine's defaults, on the
    # loaded weights and the server's page count and chunk.
    lib, _, engines, t0, t1 = serve(
        torch, [(0, n)], loaded, cfg, dev, fused=True,
        engine_kw=dict(num_pages=info["num_pages"],
                       prefill_chunk_size=info["prefill_chunk_size"]))
    emit({"phase": "http_serve", "run": "library_api",
          "loop": "drive_step", "requests": len(lib),
          "dispatch": engines[0].kernel_dispatch_summary(),
          **stream_metrics(lib, t0, t1), "card": card})
    return reqs


# The checkpoint phases (http_serve through obs_serve, qos_serve's part b)
# serve Qwen2.5-7B at full width and CKPT_LAYERS of its 28 layers: their
# subject is the control plane, not the model (``serve`` keeps all 28).
CKPT_LAYERS = 8
SWARM_BOUNDS = ((0, CKPT_LAYERS // 2), (CKPT_LAYERS // 2, CKPT_LAYERS))
SWARM_TIMEOUT_S = 300
SWARM_EXIT_S = 30


def _stage_tree(params, s: int, e: int, n: int) -> dict:
    """Stage [s, e) of a full tree: slices of its lists, no tensor
    copied."""
    p = {"layers": params["layers"][s:e]}
    if s == 0 or (e == n and "lm_head" not in params):
        p["embed_tokens"] = params["embed_tokens"]
    if e == n:
        p["norm"] = params["norm"]
        if "lm_head" in params:
            p["lm_head"] = params["lm_head"]
    return p


def _swarm_requests(served, sampled, new: int = 32):
    """Fresh requests for the served requests' prompt ids, with the mix's
    sampling (``new`` tokens, EOS ignored)."""
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    out = []
    for i, r in enumerate(served):
        temp, top_k, seed = sampled.get(i, (0.0, -1, None))
        out.append(Request(f"r{i}", prompt_ids=list(r.prompt_ids),
                           sampling_params=SamplingParams(
                               temperature=temp, top_k=top_k, seed=seed,
                               max_new_tokens=new, ignore_eos=True)))
    return out


def _logged(path: str, pattern: str, proc, deadline: float) -> str:
    """The first group of ``pattern`` once it shows in the log at
    ``path`` (a process that binds port 0 logs the address it got)."""
    import re

    while True:
        with open(path) as f:
            m = re.search(pattern, f.read())
        if m is not None:
            return m.group(1)
        if time.monotonic() > deadline or proc.poll() is not None:
            raise AssertionError(f"swarm_serve (b): {path} never logged "
                                 f"{pattern!r}")
        time.sleep(0.05)


def _common_tokens(a, b) -> int:
    return sum(x == y for r, s in zip(a, b)
               for x, y in zip(r.output_ids, s.output_ids))


def _in_process_pipeline(cfg, params, reqs, dev):
    """``reqs`` served by the in-process pipeline of SWARM_BOUNDS's stages
    (sliced from ``params``); returns them."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine
    from parallax_tpu_torch.runtime.pipeline import InProcessPipeline

    n = cfg.num_hidden_layers
    pipe = InProcessPipeline([
        StageEngine(create_stage_model(cfg, s, e),
                    _stage_tree(params, s, e, n), engine_config(True),
                    device=dev)
        for s, e in SWARM_BOUNDS])
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    for r in reqs:
        if r.status.value != "finished_length":
            raise AssertionError(f"swarm_serve (a) pipeline {r.request_id}: "
                                 f"{r.status.value}")
    return reqs


def serve_swarm_pair(torch, dev, cfg, params, reqs, **engine_over):
    """Two port WorkerNodes on TcpTransports in this process, SWARM_BOUNDS
    of ``params`` (sliced, not copied), ``engine_config(True,
    **engine_over)`` each, serving ``reqs`` submitted at the head. Returns
    the launches, both engines' summaries, both links' transport stats,
    the head's negotiated wire dtype towards the tail, the seconds to the
    route and the serving span's (t0, t1)."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport

    n = cfg.num_hidden_layers
    transports = [TcpTransport("", "127.0.0.1") for _ in SWARM_BOUNDS]
    workers = []
    try:
        for t in transports:
            t.start()
            t.peer_id = t.address
        addrs = [t.address for t in transports]
        t0 = time.monotonic()
        for t, (s, e) in zip(transports, SWARM_BOUNDS):
            workers.append(WorkerNode(
                t, None, cfg, engine_config(True, **engine_over),
                load_params=lambda m: _stage_tree(params, m.start_layer,
                                                  m.end_layer, n),
                heartbeat_interval_s=0.5,
                static_peers=[a for a in addrs if a != t.address],
                layers=(s, e), device=dev))
        for w in workers:
            w.start()
        head, tail = workers
        deadline = time.monotonic() + SWARM_TIMEOUT_S
        while head.local_route() != addrs:
            if time.monotonic() > deadline:
                raise AssertionError(f"swarm_serve (a): no route "
                                     f"{head.local_route()}")
            time.sleep(0.05)
        route_s = time.monotonic() - t0
        ck.reset_launches()
        t0 = time.monotonic()
        events = []
        for r in reqs:
            r.arrival_time = t0
            events.append(head.submit(r))
        for r, ev in zip(reqs, events):
            if not ev.wait(SWARM_TIMEOUT_S):
                raise AssertionError(f"swarm_serve (a) {r.request_id}: "
                                     f"{r.status.value}")
        t1 = time.monotonic()
        launches = ck.launches()
        summaries = [w.engine.kernel_dispatch_summary() for w in workers]
        links = {"head_to_tail": head.transport_stats()[tail.node_id],
                 "tail_to_head": tail.transport_stats()[head.node_id]}
        wire = (head._wire_dtypes.get(tail.node_id) or (None,))[0]
    finally:
        for w in workers:
            w.stop()
            w.engine = None
        for t in transports:
            t.stop()
    del workers
    return launches, summaries, links, wire, route_s, t0, t1


def swarm_in_process(torch, dev, card, cfg, params, served, sampled):
    """Part (a): two port WorkerNodes on TcpTransports in this process,
    layers 0-14 and 14-28 of ``params`` (sliced, not copied), serving the
    mix's prompts submitted at the head. Every request ends by length;
    each worker's launches are exact (A2 14 x its decode steps, A0 / A1 14
    x its prefill steps, A3 and the noise kernel on the tail only) and no
    graph is captured; the greedy rows agree with the plain path. The
    streams are counted against the in-process pipeline's on the same
    requests. Then the float8 link (``swarm_fp8_link``). Returns the
    requests."""
    reqs = _swarm_requests(served, sampled)
    launches, summaries, links, _, route_s, t0, t1 = serve_swarm_pair(
        torch, dev, cfg, params, reqs)
    for r in reqs:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"swarm_serve (a) {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
    want, per_stage = {}, []
    for stage, summary in zip(("head", "tail"), summaries):
        if summary["impl"] != "cuda-fused":
            raise AssertionError(f"swarm_serve (a) {stage}: impl "
                                 f"{summary['impl']}")
        graphs = summary.get("graphs", {})
        if graphs.get("captured", 0) or graphs.get("replays", 0) or \
                summary["dispatch_total"].get("cuda-fused/multistep", 0):
            raise AssertionError(f"swarm_serve (a) {stage}: windows ran "
                                 f"{summary}")
        mine = gqa_expected("fused", summary, SWARM_BOUNDS[0][1])
        if stage == "head" and (mine["sample_topk"] or mine["gumbel_rows"]):
            raise AssertionError(f"swarm_serve (a): the head sampled "
                                 f"{summary['dispatch_total']}")
        for k, v in mine.items():
            want[k] = want.get(k, 0) + v
        decode, prefill = forward_steps(summary)
        per_stage.append({"stage": stage, "decode_steps": decode,
                          "prefill_steps": prefill, "launches": mine})
    check_launches("swarm_serve", "in_process", launches, want, {})
    # The in-process 14 + 14 pipeline (phase_pipeline's path) on the same
    # requests: a fault of the swarm itself shows beside it.
    free_device_memory(torch)
    piped = _in_process_pipeline(cfg, params, _swarm_requests(served,
                                                              sampled), dev)
    free_device_memory(torch)
    model_ref = create_plain_model(cfg)
    worst, *_ = greedy_check(torch, model_ref, params, reqs, sampled, dev,
                             tol=GREEDY_TOL)
    del model_ref
    FIGURES["swarm_in_process"] = stream_metrics(reqs, t0, t1)
    emit({"phase": "swarm_serve", "part": "a_in_process",
          "stages": [list(b) for b in SWARM_BOUNDS], "transport": "tcp",
          "requests": len(reqs), "status": "8 x finished_length",
          "route_ready_s": route_s, "launches": launches,
          "launches_per_stage": per_stage, "graphs_captured": 0,
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tolerance": GREEDY_TOL,
          "tokens_identical_to_in_process_pipeline": _common_tokens(reqs,
                                                                    piped),
          "greedy_rows_identical_to_in_process_pipeline": sum(
              r.output_ids == p.output_ids for i, (r, p) in enumerate(
                  zip(reqs, piped)) if i not in sampled),
          "tokens_identical_to_http_single_stage": _common_tokens(reqs,
                                                                  served),
          "tokens": sum(len(r.output_ids) for r in reqs),
          "links": links, **FIGURES["swarm_in_process"],
          "dispatch": summaries, "card": card})
    swarm_fp8_link(torch, dev, card, cfg, params, served, sampled, reqs,
                   links)
    return reqs


def swarm_fp8_link(torch, dev, card, cfg, params, served, sampled, native,
                   native_links) -> None:
    """Part (a) once more with ``wire_dtype="fp8"`` on both workers: the
    head must negotiate float8_e4m3fn with the tail over ``wire_caps`` and
    every request complete; the FORWARD hidden-state bytes a hop against
    the native bf16 run's (one byte a value plus a 4-byte scale a token:
    about 0.5x), and the share of greedy tokens equal to the native run's
    (reported: the mode is lossy by design)."""
    reqs = _swarm_requests(served, sampled)
    launches, summaries, links, wire, route_s, t0, t1 = serve_swarm_pair(
        torch, dev, cfg, params, reqs, wire_dtype="fp8")
    for r in reqs:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"swarm_serve fp8 {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
    if wire != "float8_e4m3fn":
        raise AssertionError(f"swarm_serve fp8: the link negotiated {wire}")
    fp8_bytes = links["head_to_tail"]["bytes_out"]
    bf16_bytes = native_links["head_to_tail"]["bytes_out"]
    greedy = [i for i in range(len(reqs)) if i not in sampled]
    same = sum(a == b for i in greedy for a, b in zip(
        reqs[i].output_ids, native[i].output_ids))
    emit({"phase": "swarm_serve", "part": "a_fp8_link",
          "negotiated": wire, "requests": len(reqs),
          "status": "8 x finished_length", "route_ready_s": route_s,
          "hidden_bytes_per_hop": fp8_bytes,
          "native_bf16_hidden_bytes_per_hop": bf16_bytes,
          "bytes_ratio": fp8_bytes / bf16_bytes,
          "compression_ratio": links["head_to_tail"].get(
              "compression_ratio"),
          "greedy_tokens_equal_to_native": same,
          "greedy_tokens": 32 * len(greedy),
          "greedy_equal_share": same / (32 * len(greedy)),
          "launches": launches, **stream_metrics(reqs, t0, t1),
          "card": card})


def create_plain_model(cfg):
    """The plain reference model over all layers (plain attention even on
    the card)."""
    from parallax_tpu_torch.models import create_stage_model

    return create_stage_model(cfg, 0, cfg.num_hidden_layers,
                              use_kernels=False)


def _http_client_retry_503(port: int, path: str, body: dict, out: dict,
                           deadline: float) -> None:
    """``_http_client``, sent again while the reply is 503 (no serviceable
    pipeline yet: the frontend's retryable answer) until ``deadline``;
    ``t_send`` stays the first attempt's, ``retries`` counts the rest."""
    t_send, retries = None, 0
    while True:
        _http_client(port, path, body, out)
        t_send = t_send or out["t_send"]
        if out.get("status") != 503 or time.monotonic() > deadline:
            break
        retries += 1
        time.sleep(0.2)
    out["t_send"], out["retries"] = t_send, retries


def _swarm_http_figures(outs, mix) -> dict:
    """One pass of the mix over HTTP: TTFT from the streamed replies'
    usage.ttft_ms (the chat host's first sight of a token, from the
    handler's start; the byte tokenizer shows no text for most ids, so a
    first content chunk would come late), decode tok/s from the first of
    those first tokens to the last reply, output tok/s over the wall."""
    usages = [_http_reply(o, body)[2] for o, (_, body) in zip(outs, mix)]
    streamed = [(o, u) for o, u in zip(outs, usages) if "ttft_ms" in u]
    ttft = [u["ttft_ms"] / 1e3 for _, u in streamed]
    t_start = min(o["t_send"] for o in outs)
    t_end = max(o["t_done"] for o in outs)
    first = min(o["t_send"] + u["ttft_ms"] / 1e3 for o, u in streamed)
    total = sum(u["completion_tokens"] for u in usages)
    return {"ttft_s": ttft, "ttft_s_median": statistics.median(ttft),
            "ttft_s_max": max(ttft),
            "decode_tok_per_s": (total - len(usages)) / (t_end - first),
            "output_tok_per_s": total / (t_end - t_start),
            "wall_s": t_end - t_start}


def _emit_log_tails(names, procs, texts) -> None:
    emit({"phase": "swarm_serve", "part": "b_processes", "failed": True,
          "exits": {nm: p.poll() for nm, p in zip(names, procs)},
          "log_tails": {nm: t[-3000:] for nm, t in zip(names, texts)}})


def _swarm_http_checks(names, texts, exits, outs, mix, again) -> None:
    """Part (b)'s checks of the logs, the exits and the replies."""
    from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer

    for nm, text in zip(names, texts):
        if "step loop error" in text or "Traceback" in text:
            raise AssertionError(f"swarm_serve (b) {nm}: a step loop error "
                                 "or a traceback in its log")
    if any(code != 0 for code in exits.values()):
        raise AssertionError(f"swarm_serve (b): exits {exits}")
    tok = SimpleTokenizer()
    for i, (out, (_, body)) in enumerate(zip(outs, mix)):
        _rid, reason, usage, text = _http_reply(out, body)
        if reason != "length" or usage["completion_tokens"] != 32:
            raise AssertionError(f"swarm_serve (b) r{i}: {reason}, {usage}")
        if i in again and text != tok.decode(again[i].output_ids):
            raise AssertionError(f"swarm_serve (b) r{i}: the reply is not "
                                 "the RPC stream's decode")
    for r in again.values():
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"swarm_serve (b) {r.request_id}: "
                                 f"{r.status.value}")


def _ready_blocks(transport, addr: str) -> dict:
    """A worker's own block from its announce reply (None while it has
    not allocated)."""
    reply = transport.call(addr, "__announce__", {"blocks": []}, timeout=5.0)
    for b in (reply or {}).get("blocks", []):
        if b["node_id"] == addr:
            return b
    return {}


def swarm_processes(torch, dev, card, cfg, params, ckpt, mix, sampled,
                    in_process):
    """Part (b): two ``python -m parallax_tpu_torch join`` processes
    (layers 0-14 and 14-28 of the checkpoint, each on the port 0 gave it,
    the tail with the head as its --peers, --advertise-addr 127.0.0.1)
    and ``chat-host --head`` in a third; the
    http_serve mix from 8 client threads on the fresh processes, then a
    mix of the same shape with other text on the warm ones. Every reply
    200 with 32 completion tokens; the greedy rows' ids, read back over the head's
    chat RPCs (the chat host's own path, minus HTTP), equal part (a)'s or
    part only where the plain path's gap check allows; no step loop error
    and no traceback in any log; every process exits 0 within 30 s of
    SIGTERM, and the workers' exit summaries show no graph captured."""
    import os
    import re
    import threading

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}

    def join_cmd(i: int, peers: list[str]) -> list[str]:
        s, e = SWARM_BOUNDS[i]
        return [sys.executable, "-m", "parallax_tpu_torch", "join",
                "--model-path", ckpt, "--start-layer", str(s),
                "--end-layer", str(e),
                *(["--peers", ",".join(peers)] if peers else []),
                "--advertise-addr", "127.0.0.1", "--port", "0",
                "--device", str(dev)]

    names = tuple(f"join_{s}_{e}" for s, e in SWARM_BOUNDS) + ("chat_host",)
    paths = [os.path.join(ckpt, f"{nm}.log") for nm in names]
    logs = [open(path, "w+") for path in paths]
    probe = TcpTransport("", "127.0.0.1")
    procs, exits, failed = [], {}, True
    try:
        probe.start()
        probe.peer_id = probe.address
        t_spawn = time.monotonic()
        deadline = t_spawn + SWARM_TIMEOUT_S

        def spawn(cmd: list[str], i: int) -> None:
            procs.append(subprocess.Popen(cmd, cwd=repo, env=env,
                                          stdout=logs[i],
                                          stderr=subprocess.STDOUT))

        # Every process binds port 0 and logs the address it got: the head
        # first, then the tail with the head as its peer (the head learns
        # the tail from its announcements) and the chat host in front of
        # the head.
        spawn(join_cmd(0, []), 0)
        addrs = [_logged(paths[0], r"worker (\S+) serving layers",
                         procs[0], deadline)]
        spawn(join_cmd(1, addrs), 1)
        spawn([sys.executable, "-m", "parallax_tpu_torch", "chat-host",
               "--head", addrs[0], "--model-path", ckpt, "--host",
               "127.0.0.1", "--port", "0"], 2)
        addrs.append(_logged(paths[1], r"worker (\S+) serving layers",
                             procs[1], deadline))
        host_port = int(_logged(paths[2], r"chat host on :(\d+)", procs[2],
                                deadline))
        # Each worker's own readiness, then the head's route.
        ready, route_s = {}, None
        while route_s is None:
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                raise AssertionError("swarm_serve (b): the swarm did not "
                                     "come up")
            for a in addrs:
                if a not in ready:
                    try:
                        if _ready_blocks(probe, a).get("ready"):
                            ready[a] = time.monotonic() - t_spawn
                    except Exception:
                        pass
            if len(ready) == 2 and probe.call(
                    addrs[0], "chat_ready", None, timeout=5.0).get("ready"):
                route_s = time.monotonic() - t_spawn
            else:
                time.sleep(0.1)
        # The chat host's HTTP socket.
        while True:
            try:
                import http.client

                conn = http.client.HTTPConnection("127.0.0.1", host_port,
                                                  timeout=5)
                conn.request("GET", "/health")
                resp = conn.getresponse()
                resp.read()
                conn.close()
                if resp.status == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline or procs[2].poll() is not None:
                raise AssertionError("swarm_serve (b): no chat host")
            time.sleep(0.1)
        host_s = time.monotonic() - t_spawn

        def send(m):
            """The mix from 8 client threads (r7 once r0 is answered)."""
            outs = [{} for _ in m]
            retry_until = time.monotonic() + 60.0
            clients = [threading.Thread(target=_http_client_retry_503,
                                        daemon=True,
                                        args=(host_port, path, body, out,
                                              retry_until))
                       for (path, body), out in zip(m, outs)]
            for c in clients[:-1]:
                c.start()
            clients[0].join(HTTP_TIMEOUT_S)
            clients[-1].start()
            for c in clients:
                c.join(HTTP_TIMEOUT_S)
            if any(c.is_alive() for c in clients):
                raise AssertionError("swarm_serve (b): a client is still "
                                     "waiting")
            return outs

        # The mix on the fresh processes, then the same shape of mix with
        # other text (no prefix shared with the first) on warm ones.
        outs = send(mix)
        warm_mix = _text_mix(2025)[0]
        warm_outs = send(warm_mix)
        # The greedy rows once more through the head's chat RPCs, to read
        # their ids.
        client = SwarmClient(probe, default_head=addrs[0])
        greedy = [i for i in range(len(mix)) if i not in sampled]
        again = {i: Request(f"ids-{i}",
                            prompt_ids=list(in_process[i].prompt_ids),
                            sampling_params=SamplingParams(
                                temperature=0.0, max_new_tokens=32,
                                ignore_eos=True))
                 for i in greedy}
        events = [client.submit(r) for r in again.values()]
        for ev in events:
            if not ev.wait(HTTP_TIMEOUT_S):
                raise AssertionError("swarm_serve (b): an RPC request "
                                     "hung")
        # SIGTERM: every process exits 0 within SWARM_EXIT_S.
        t_term = time.monotonic()
        for p in procs:
            p.send_signal(15)
        for nm, p in zip(names, procs):
            try:
                exits[nm] = p.wait(SWARM_EXIT_S)
            except subprocess.TimeoutExpired:
                exits[nm] = "timeout"
        exit_s = time.monotonic() - t_term
    except BaseException:
        failed = True
        raise
    else:
        failed = False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        probe.stop()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if failed:
            _emit_log_tails(names, procs, texts)
    try:
        _swarm_http_checks(names, texts, exits, outs + warm_outs,
                           mix + warm_mix, again)
    except AssertionError:
        _emit_log_tails(names, procs, texts)
        raise

    greedy_reqs = [again[i] for i in greedy]
    ref = [in_process[i] for i in greedy]
    model_ref = create_plain_model(cfg)
    worst, *_ = greedy_check(torch, model_ref, params, greedy_reqs, {}, dev,
                             tol=GREEDY_TOL)
    del model_ref
    # The workers' exit lines: forward steps, no graph captured, and the
    # bytes each link carried.
    worker_dispatch, links = [], {}
    for nm, text in zip(names[:2], texts[:2]):
        m = re.search(r"kernel dispatch: (\{.*\})", text)
        t = re.search(r"transport: (\{.*\}|null)", text)
        if m is None or t is None:
            raise AssertionError(f"swarm_serve (b) {nm}: no exit summary")
        summary = json.loads(m.group(1))
        if summary.get("graphs", {}).get("captured", 0):
            raise AssertionError(f"swarm_serve (b) {nm}: graphs {summary}")
        decode, prefill = forward_steps(summary)
        worker_dispatch.append({"worker": nm, "impl": summary["impl"],
                                "decode_steps": decode,
                                "prefill_steps": prefill,
                                "graphs_captured": 0})
        links[nm] = json.loads(t.group(1))
    FIGURES["swarm_http"] = _swarm_http_figures(outs, mix)
    FIGURES["swarm_http_warm"] = _swarm_http_figures(warm_outs, warm_mix)
    emit({"phase": "swarm_serve", "part": "b_processes",
          "processes": list(names), "requests": len(outs) + len(warm_outs),
          "status": "16 x 200", "retries_after_503": [
              o["retries"] for o in outs + warm_outs],
          "exits": exits,
          "exit_after_sigterm_s": exit_s,
          "spawn_to_worker_ready_s": [ready[a] for a in addrs],
          "spawn_to_route_ready_s": route_s,
          "spawn_to_chat_host_s": host_s,
          "greedy_rows_via_rpc": len(greedy_reqs),
          "greedy_tokens_identical_to_part_a": _common_tokens(greedy_reqs,
                                                              ref),
          "greedy_tokens": 32 * len(greedy_reqs),
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tolerance": GREEDY_TOL,
          "cold": FIGURES["swarm_http"],
          "warm": FIGURES["swarm_http_warm"],
          "links": links, "worker_dispatch": worker_dispatch,
          "card": card})


def phase_swarm_serve(torch, dev, card, cfg, params, ckpt, mix, sampled,
                      served) -> None:
    """The scheduler-less swarm on Qwen2.5-7B at full width, 14 + 14
    layers: part (a) in this process, part (b) as processes through the
    CLI; then both beside the in-process pipeline and the HTTP figures."""
    free_device_memory(torch)
    in_process = swarm_in_process(torch, dev, card, cfg, params, served,
                                  sampled)
    free_device_memory(torch)
    swarm_processes(torch, dev, card, cfg, params, ckpt, mix, sampled,
                    in_process)
    emit({"phase": "swarm_serve", "compare": {
        k: FIGURES.get(k) for k in ("pipeline", "http", "swarm_in_process",
                                    "swarm_http", "swarm_http_warm")},
        "card": card})


# ---------------------------------------------------------------------------
# sched_serve: the scheduler-assigned swarm (the control plane)
# ---------------------------------------------------------------------------

# Part (a) tells the scheduler that each node holds this many layers (the
# roofline's memory bound, patched as tests/test_swarm_e2e.py:62-72 does),
# so it lays out one 14 + 14 pipeline over the two workers.
SCHED_CAPACITY = CKPT_LAYERS // 2
# Part (b)'s workers heartbeat every 2 s (the join's default): r7 goes out
# once the other requests are done and a beat has carried their digests.
SCHED_BEAT_WAIT_S = 2.5


def _wait_for(cond, deadline: float, what: str,
              phase: str = "sched_serve") -> None:
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: {what}")
        time.sleep(0.05)


def _sched_nodes(status) -> list:
    return [(x["node_id"], x["layers"], x["ready"])
            for p in status["pipelines"] for x in p["nodes"]]


def _stamp_first_tokens(reqs, stop, poll_s: float) -> None:
    """Stamp each client-side request's first token as the SwarmClient's
    poll mirrors it in (client-observed TTFT). It looks as often as the
    client polls: more often sees nothing sooner, and only takes the GIL
    from the step threads that share this process."""
    while not stop.wait(poll_s):
        now = time.monotonic()
        for r in reqs:
            if r.first_token_time is None and r.output_ids:
                r.first_token_time = now


def sched_in_process(torch, dev, card, cfg, params, served, sampled):
    """Part (a): a port GlobalScheduler and its SchedulerService on TCP
    loopback with two WorkerNodes that join it (``scheduler_peer``), each
    stage's weights sliced from ``params``. The scheduler, told that a
    node holds 14 layers, lays out one 14 + 14 pipeline; the mix's prompts
    are routed and polled through a SwarmClient on the service. Every
    request ends by length, launches are exact per stage, the greedy rows
    agree with the plain path. Then the tail stops (node_leave): the
    pipeline dissolves, routing answers None; a new tail joins, the
    scheduler lays out a pipeline again and it serves one more request.
    Returns the requests."""
    import threading

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.backend.scheduler_service import SchedulerService
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.runtime.request import Request, SamplingParams
    from parallax_tpu_torch.scheduling import node as sched_node
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

    n = cfg.num_hidden_layers
    roofline = sched_node.RooflinePerformanceModel
    real_capacity = roofline.max_layers_in_memory
    roofline.max_layers_in_memory = (
        lambda self, kv_fraction=0.35: SCHED_CAPACITY)
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=2)
    service = SchedulerService(sched, TcpTransport("scheduler", "127.0.0.1"),
                               join_timeout_s=SWARM_TIMEOUT_S)
    workers = []

    def new_worker():
        t = TcpTransport("", "127.0.0.1")
        t.start()
        t.peer_id = t.address
        w = WorkerNode(t, service.transport.address, cfg, engine_config(True),
                       load_params=lambda m: _stage_tree(
                           params, m.start_layer, m.end_layer, n),
                       heartbeat_interval_s=0.5, device=dev)
        workers.append(w)
        return w

    def start(ws) -> None:
        # Each join blocks until the scheduler bootstraps: start together.
        threads = [threading.Thread(target=w.start, daemon=True) for w in ws]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SWARM_TIMEOUT_S)

    stop_mon = threading.Event()
    try:
        service.start()
        t_spawn = time.monotonic()
        deadline = t_spawn + SWARM_TIMEOUT_S
        start([new_worker(), new_worker()])
        _wait_for(lambda: _sched_nodes(sched.cluster_status()) and all(
            x[2] for x in _sched_nodes(sched.cluster_status())), deadline,
            "(a) no ready pipeline")
        route_s = time.monotonic() - t_spawn
        status = sched.cluster_status()
        allocation = _sched_nodes(status)
        if status["num_pipelines"] != 1 or [x[1] for x in allocation] != [
                [0, SCHED_CAPACITY], [SCHED_CAPACITY, n]]:
            raise AssertionError(f"sched_serve (a): allocation {allocation}")
        by_id = {w.node_id: w for w in workers}
        head, tail = by_id[allocation[0][0]], by_id[allocation[1][0]]
        client = SwarmClient(service.transport, service)
        reqs = _swarm_requests(served, sampled)
        ck.reset_launches()
        mon = threading.Thread(target=_stamp_first_tokens,
                               args=(reqs, stop_mon, client.poll_interval_s),
                               daemon=True)
        t0 = time.monotonic()
        mon.start()
        events, routes, route_ms = [], [], []
        for r in reqs:
            t_r = time.perf_counter()
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            route_ms.append((time.perf_counter() - t_r) * 1e3)
            routes.append(r.routing_table)
            events.append(client.submit(r))
        for r, ev in zip(reqs, events):
            if not ev.wait(SWARM_TIMEOUT_S):
                raise AssertionError(f"sched_serve (a) {r.request_id}: "
                                     f"{r.status.value}")
        t1 = time.monotonic()
        stop_mon.set()
        mon.join(10)
        launches = ck.launches()
        summaries = [head.engine.kernel_dispatch_summary(),
                     tail.engine.kernel_dispatch_summary()]

        # The tail leaves: its node_leave dissolves the pipeline.
        t_leave = time.monotonic()
        tail.stop()
        _wait_for(lambda: not sched.manager.pipelines
                  and sched.manager.get(tail.node_id) is None,
                  t_leave + SWARM_TIMEOUT_S, "(a) the pipeline outlived "
                  "the tail's leave")
        dissolve_s = time.monotonic() - t_leave
        t_r = time.monotonic()
        gone = client.route("after-leave",
                            prompt_ids=list(reqs[0].prompt_ids))
        if gone is not None:
            raise AssertionError(f"sched_serve (a): routed {gone} with no "
                                 "pipeline")
        none_s = time.monotonic() - t_r
        # A new tail joins; the scheduler lays out a pipeline again.
        t_join = time.monotonic()
        start([new_worker()])
        _wait_for(lambda: len(_sched_nodes(sched.cluster_status())) == 2
                  and all(x[2] for x in _sched_nodes(sched.cluster_status())),
                  t_join + SWARM_TIMEOUT_S, "(a) no pipeline after rejoin")
        rejoin_s = time.monotonic() - t_join
        allocation_after = _sched_nodes(sched.cluster_status())
        again = Request("after-rejoin", prompt_ids=list(reqs[0].prompt_ids),
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=32,
                            ignore_eos=True))
        again.routing_table = client.route(again.request_id,
                                           prompt_ids=again.prompt_ids)
        if not client.submit(again).wait(SWARM_TIMEOUT_S) or \
                again.status.value != "finished_length" or \
                len(again.output_ids) != 32:
            raise AssertionError(f"sched_serve (a) after rejoin: "
                                 f"{again.status.value}")
    finally:
        stop_mon.set()
        for w in workers:
            w.stop()
            w.engine = None
        service.stop()
        roofline.max_layers_in_memory = real_capacity
    del workers
    for r in reqs:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"sched_serve (a) {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
    want, per_stage = {}, []
    for stage, summary, (_, (s, e), _) in zip(("head", "tail"), summaries,
                                               allocation):
        if summary["impl"] != FUSED_IMPL:
            raise AssertionError(f"sched_serve (a) {stage}: impl "
                                 f"{summary['impl']}")
        mine = gqa_expected("fused", summary, e - s)
        if stage == "head" and (mine["sample_topk"] or mine["gumbel_rows"]):
            raise AssertionError(f"sched_serve (a): the head sampled "
                                 f"{summary['dispatch_total']}")
        for k, v in mine.items():
            want[k] = want.get(k, 0) + v
        decode, prefill = forward_steps(summary)
        per_stage.append({"stage": stage, "decode_steps": decode,
                          "prefill_steps": prefill, "launches": mine})
    check_launches("sched_serve", "in_process", launches, want, {})
    free_device_memory(torch)
    model_ref = create_plain_model(cfg)
    worst, *_ = greedy_check(torch, model_ref, params, reqs + [again],
                             sampled, dev, tol=GREEDY_TOL)
    del model_ref
    FIGURES["sched_in_process"] = {"spawn_to_route_ready_s": route_s,
                                   **stream_metrics(reqs, t0, t1)}
    emit({"phase": "sched_serve", "part": "a_in_process",
          "forced": f"RooflinePerformanceModel.max_layers_in_memory -> "
                    f"{SCHED_CAPACITY}",
          "allocation": allocation,
          "routes": sorted({tuple(p) for p in routes}),
          "requests": len(reqs), "status": "8 x finished_length",
          "route_ms_median": statistics.median(route_ms),
          "route_ms_max": max(route_ms), "launches": launches,
          "launches_per_stage": per_stage,
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tolerance": GREEDY_TOL,
          "tokens_identical_to_http_single_stage": _common_tokens(reqs,
                                                                  served),
          "tokens": sum(len(r.output_ids) for r in reqs),
          "leave": {"dissolve_s": dissolve_s, "route_after_leave": None,
                    "route_none_s": none_s, "rejoin_to_ready_s": rejoin_s,
                    "allocation_after": allocation_after,
                    "served_after": again.status.value,
                    "tokens_equal_to_r0": sum(
                        x == y for x, y in zip(again.output_ids,
                                               reqs[0].output_ids))},
          **FIGURES["sched_in_process"], "card": card})
    return reqs


def _status_json(port: int) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/cluster/status_json")
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise AssertionError(f"sched_serve (b): /cluster/status_json "
                                 f"{resp.status}")
        return json.loads(body)
    finally:
        conn.close()


def _send_mix(port: int, items, phase: str) -> list[dict]:
    """``items`` (path, body) from one client thread each, a 503 retried
    for 60 s; every client must be answered."""
    import threading

    outs = [{} for _ in items]
    clients = [threading.Thread(
        target=_http_client_retry_503, daemon=True,
        args=(port, path, body, out, time.monotonic() + 60.0))
        for (path, body), out in zip(items, outs)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(HTTP_TIMEOUT_S)
    if any(c.is_alive() for c in clients):
        raise AssertionError(f"{phase} (b): a client is still waiting")
    return outs


def _replica_exits(phase: str, names, texts, n: int) -> list[dict]:
    """Each 28-layer worker process's exit lines: its engine's dispatch
    summary and the process's launches, exact on the kernels, and its
    engine builds (``(re)loading layers``), exactly one."""
    import re

    out = []
    for nm, text in zip(names, texts):
        m = re.search(r"kernel dispatch: (\{.*\})", text)
        k = re.search(r"kernel launches: (\{.*\})", text)
        builds = len(re.findall(r"\(re\)loading layers", text))
        if m is None or k is None or builds != 1:
            raise AssertionError(f"{phase} (b) {nm}: {builds} engine builds "
                                 "or no exit summary")
        summary, launches = json.loads(m.group(1)), json.loads(k.group(1))
        if summary["impl"] != FUSED_IMPL:
            raise AssertionError(f"{phase} (b) {nm}: impl {summary['impl']}")
        check_launches(phase, f"b_{nm}", launches,
                       gqa_expected("fused", summary, n), summary)
        decode, prefill = forward_steps(summary)
        out.append({
            "worker": nm, "impl": summary["impl"], "engine_builds": builds,
            "decode_steps": decode, "prefill_steps": prefill,
            "launches": launches,
            "graphs_captured": summary.get("graphs", {}).get("captured", 0),
            "graph_replays": summary.get("graphs", {}).get("replays", 0)})
    return out


def _emit_sched_tails(names, procs, texts, phase="sched_serve") -> None:
    emit({"phase": phase, "part": "b_processes", "failed": True,
          "exits": {nm: p.poll() for nm, p in zip(names, procs)},
          "log_tails": {nm: t[-3000:] for nm, t in zip(names, texts)}})


def sched_processes(torch, dev, card, cfg, params, ckpt, mix, sampled,
                    in_process, refit=None):
    """Part (b): ``python -m parallax_tpu_torch run --min-nodes 2
    --routing cache_aware`` and two ``join --scheduler-addr`` processes
    on the checkpoint, both joins spawned before either is waited on.
    Each worker reports one H100, so the scheduler lays out two 28-layer
    replicas (printed from /cluster/status_json). The HTTP mix: r0-r6
    from 7 client threads, then, once they are done and a heartbeat has
    carried the heads' digests, r7 (r0's 256-byte prefix): its replica,
    the router's reason and its cached prompt tokens come from the
    status's routing section (the rates are r0-r6's, r7's TTFT its own). Every reply 200 with 32 tokens; the greedy
    rows once more through a SwarmClient over the route_request RPC,
    their ids counted against part (a)'s and checked against the plain
    path; clean logs; every process exits 0 within 30 s of SIGTERM. The
    joins build into and load from the build phase's directory
    (``--compilation-cache-dir``). With ``refit`` (``refit_donor``'s),
    refit_serve's part (b) runs on the same processes before the
    SIGTERM."""
    import os

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    names = ("run", "join_a", "join_b")
    paths = [os.path.join(ckpt, f"sched_{nm}.log") for nm in names]
    logs = [open(path, "w+") for path in paths]
    probe = TcpTransport("", "127.0.0.1")
    procs, exits, failed = [], {}, True
    try:
        probe.start()
        probe.peer_id = probe.address
        t_spawn = time.monotonic()
        deadline = t_spawn + SWARM_TIMEOUT_S

        def spawn(args: list[str], i: int) -> None:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "parallax_tpu_torch", *args],
                cwd=repo, env=env, stdout=logs[i], stderr=subprocess.STDOUT))

        # run binds both ports itself (--port 0) and logs them.
        spawn(["run", "--model-name", ckpt, "--min-nodes", "2",
               "--routing", "cache_aware", "--port", "0", "--host",
               "127.0.0.1"], 0)
        rpc = "127.0.0.1:" + _logged(paths[0], r"scheduler RPC on :(\d+)",
                                     procs[0], deadline)
        port = int(_logged(paths[0], r"scheduler RPC on :\d+, HTTP on "
                           r":(\d+)", procs[0], deadline))
        run_s = time.monotonic() - t_spawn
        for i in (1, 2):
            spawn(["join", "--scheduler-addr", rpc, "--model-path", ckpt,
                   "--advertise-addr", "127.0.0.1", "--port", "0",
                   "--device", str(dev), "--compilation-cache-dir",
                   ck.BUILD_DIR], i)

        def ready() -> bool:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("sched_serve (b): a process exited")
            nodes = _sched_nodes(_status_json(port))
            return len(nodes) == 2 and all(x[2] for x in nodes)

        _wait_for(ready, deadline, "(b) the replicas did not come up")
        route_s = time.monotonic() - t_spawn
        status = _status_json(port)
        decided = [[(x["node_id"], x["layers"]) for x in p["nodes"]]
                   for p in status["pipelines"]]
        if sorted(len(p) for p in decided) != [1, 1] or any(
                p[0][1] != [0, cfg.num_hidden_layers] for p in decided):
            raise AssertionError(f"sched_serve (b): allocation {decided}")

        def send(items):
            return _send_mix(port, items, "sched_serve")

        def completes(k: int) -> bool:
            return _status_json(port)["routing"]["predicted_vs_actual"][
                "requests"] >= k

        outs = send(mix[:-1])
        _wait_for(lambda: completes(len(mix) - 1), time.monotonic() + 30,
                  "(b) request_complete reports missing")
        time.sleep(SCHED_BEAT_WAIT_S)
        before = _status_json(port)["routing"]
        outs += send(mix[-1:])
        _wait_for(lambda: completes(len(mix)), time.monotonic() + 30,
                  "(b) r7's request_complete missing")
        after = _status_json(port)["routing"]
        pipe7 = [k for k, v in after["pipeline_dispatches"].items()
                 if v != before["pipeline_dispatches"].get(k, 0)]
        reason7 = [k for k, v in after["decisions"].items()
                   if v != before["decisions"].get(k, 0)]
        acc0, acc1 = before["predicted_vs_actual"], after["predicted_vs_actual"]
        sharer = {"pipeline": pipe7, "reason": reason7,
                  "cached_prompt_tokens": acc1["actual_tokens"]
                  - acc0["actual_tokens"],
                  "predicted_cached_tokens": acc1["predicted_tokens"]
                  - acc0["predicted_tokens"]}
        # The greedy rows once more, routed over the route_request RPC.
        client = SwarmClient(probe, scheduler_peers=[rpc])
        greedy = [i for i in range(len(mix)) if i not in sampled]
        again = {i: Request(f"ids-{i}",
                            prompt_ids=list(in_process[i].prompt_ids),
                            sampling_params=SamplingParams(
                                temperature=0.0, max_new_tokens=32,
                                ignore_eos=True))
                 for i in greedy}
        events, route_rpc_ms = [], []
        for r in again.values():
            t_r = time.perf_counter()
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            route_rpc_ms.append((time.perf_counter() - t_r) * 1e3)
            events.append(client.submit(r))
        for ev in events:
            if not ev.wait(HTTP_TIMEOUT_S):
                raise AssertionError("sched_serve (b): an RPC request hung")
        status_end = _status_json(port)
        if refit is not None:
            t_refit = time.monotonic()
            refit_run = _refit_swarm(
                port, client, refit, mix,
                {i: in_process[i].prompt_ids for i in greedy})
            refit_run["seconds"] = time.monotonic() - t_refit
        # SIGTERM: the workers first (each says node_leave), then run.
        t_term = time.monotonic()
        for p in procs[1:]:
            p.send_signal(15)
        for nm, p in zip(names[1:], procs[1:]):
            try:
                exits[nm] = p.wait(SWARM_EXIT_S)
            except subprocess.TimeoutExpired:
                exits[nm] = "timeout"
        _wait_for(lambda: _status_json(port)["num_nodes"] == 0,
                  time.monotonic() + 10, "(b) a worker's node_leave missing")
        procs[0].send_signal(15)
        try:
            exits[names[0]] = procs[0].wait(SWARM_EXIT_S)
        except subprocess.TimeoutExpired:
            exits[names[0]] = "timeout"
        exit_s = time.monotonic() - t_term
    except BaseException:
        failed = True
        raise
    else:
        failed = False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        probe.stop()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if failed:
            _emit_sched_tails(names, procs, texts)
    try:
        for nm, text in zip(names, texts):
            if "step loop error" in text or "Traceback" in text:
                raise AssertionError(f"sched_serve (b) {nm}: an error in "
                                     "its log")
        if any(code != 0 for code in exits.values()):
            raise AssertionError(f"sched_serve (b): exits {exits}")
        for i, (out, (_, body)) in enumerate(zip(outs, mix)):
            _rid, reason, usage, _text = _http_reply(out, body)
            if reason != "length" or usage["completion_tokens"] != 32:
                raise AssertionError(f"sched_serve (b) r{i}: {reason}, "
                                     f"{usage}")
        for r in again.values():
            if r.status.value != "finished_length" or \
                    len(r.output_ids) != 32:
                raise AssertionError(f"sched_serve (b) {r.request_id}: "
                                     f"{r.status.value}")
    except AssertionError:
        _emit_sched_tails(names, procs, texts)
        raise
    greedy_reqs = [again[i] for i in greedy]
    ref = [in_process[i] for i in greedy]
    model_ref = create_plain_model(cfg)
    worst, *_ = greedy_check(torch, model_ref, params, greedy_reqs, {}, dev,
                             tol=GREEDY_TOL)
    del model_ref
    worker_dispatch = _replica_exits("sched_serve", names[1:], texts[1:],
                                     cfg.num_hidden_layers)
    # The rates are the concurrent wave's (r0-r6); r7 went out alone.
    FIGURES["sched_http"] = {"spawn_to_route_ready_s": route_s,
                             **_swarm_http_figures(outs[:-1], mix[:-1])}
    sharer["ttft_s"] = _http_reply(outs[-1], mix[-1][1])[2]["ttft_ms"] / 1e3
    emit({"phase": "sched_serve", "part": "b_processes",
          "processes": list(names), "routing": "cache_aware",
          "allocation": decided, "requests": len(outs),
          "status": f"{len(outs)} x 200",
          "retries_after_503": [o["retries"] for o in outs],
          "spawn_to_run_listening_s": run_s,
          "sharer_r7": sharer,
          "routing_end": status_end["routing"],
          "greedy_rows_via_route_rpc": len(greedy_reqs),
          "route_rpc_ms_median": statistics.median(route_rpc_ms),
          "route_rpc_ms_max": max(route_rpc_ms),
          "greedy_tokens_identical_to_part_a": _common_tokens(greedy_reqs,
                                                              ref),
          "greedy_tokens": 32 * len(greedy_reqs),
          "greedy_vs_plain": "pass", "largest_logit_gap": worst,
          "tolerance": GREEDY_TOL, "exits": exits,
          "exit_after_sigterm_s": exit_s,
          "worker_dispatch": worker_dispatch,
          **FIGURES["sched_http"], "card": card})
    if refit is not None:
        refit_swarm_checks(torch, dev, card, cfg, params, refit, refit_run,
                           mix, names[1:], texts[1:])


def phase_sched_serve(torch, dev, card, cfg, params, ckpt, mix, sampled,
                      served, refit=None) -> None:
    """The scheduler-assigned swarm on Qwen2.5-7B at full width: part (a)
    in this process (one 14 + 14 pipeline, leave and rejoin), part (b) as
    ``run`` and two ``join --scheduler-addr`` processes (two replicas);
    then both beside the in-process pipeline and swarm_serve."""
    t0 = time.monotonic()
    free_device_memory(torch)
    in_process = sched_in_process(torch, dev, card, cfg, params, served,
                                  sampled)
    free_device_memory(torch)
    sched_processes(torch, dev, card, cfg, params, ckpt, mix, sampled,
                    in_process, refit=refit)
    emit({"phase": "sched_serve", "compare": {
        k: FIGURES.get(k) for k in ("pipeline", "http", "swarm_in_process",
                                    "swarm_http", "swarm_http_warm",
                                    "sched_in_process", "sched_http")},
        "phase_s": time.monotonic() - t0, "card": card})


# -- refit_serve: a weight refit, in place under the window graphs ------------

REFIT_SEED = 1       # the donor's generator seed (the served tree's is 0)
REFIT_RUNS = (("fused", None), ("fused_k1_sync", K1_SYNC))
REFIT_V1_S = 180     # POST to both workers at version 1, at most


def clone_tree(tree):
    """A tree with every tensor copied (an engine refitted in place must
    not write into the tree the later phases read)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone()


def refit_donor(torch, dev, card, cfg, ckpt: str) -> dict:
    """The donor: ``cfg`` drawn from REFIT_SEED on the card, written as one
    safetensors file in a directory beside the checkpoint's files, and its
    index (every tensor with the file's sha256)."""
    import os
    import shutil

    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.p2p.refit import build_index_map
    from parallax_tpu_torch.utils.st_writer import write_safetensors

    model = create_stage_model(cfg, 0, cfg.num_hidden_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(REFIT_SEED)
    tree = model.init_params(gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    tensors = hf_tensors(tree)
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    d = os.path.join(ckpt, "refit")
    os.makedirs(d)
    path = os.path.join(d, "v1.safetensors")
    free = shutil.disk_usage(d).free
    if free < nbytes + (1 << 30):
        raise AssertionError(f"refit_serve: {free} bytes free under {d}, "
                             f"the donor needs {nbytes}")
    t0 = time.monotonic()
    write_safetensors(path, tensors)
    write_s = time.monotonic() - t0
    del tensors
    t0 = time.monotonic()
    index = build_index_map(path)
    index_s = time.monotonic() - t0
    emit({"phase": "refit_serve", "donor": path, "seed": REFIT_SEED,
          "bytes": nbytes, "tensors": len(index), "disk_free_bytes": free,
          "write_s": write_s, "index_sha256_s": index_s,
          "index_gb_per_s": nbytes / index_s / 1e9,
          "page_cache": "warm (written just before)", "card": card})
    return {"tree": tree, "path": path, "index": index, "bytes": nbytes}


def _refit_drive(torch, engine, vocab: int, tag: str):
    """The mix through one engine's drive_step loop, its request ids
    tagged (an engine serves the mix twice)."""
    from parallax_tpu_torch.runtime.engine import drive_step

    reqs, sampled = make_requests(vocab)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for r in reqs:
        r.request_id = f"{r.request_id}-{tag}"
        r.arrival_time = t0
        engine.submit(r)
    pending = None
    while engine.has_work() or pending is not None:
        _, pending = drive_step(engine, pending)
    torch.cuda.synchronize()
    return reqs, sampled, t0, time.monotonic()


def refit_in_process(torch, dev, card, cfg, loaded, donor) -> None:
    """Part (a): each of REFIT_RUNS refits an engine in place between two
    passes of the mix and is held against a fresh engine on the donor."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p.refit import (
        apply_prefetched,
        fetch_refit_tensors,
    )
    from parallax_tpu_torch.runtime.engine import StageEngine

    n = cfg.num_hidden_layers
    largest = max(t.numel() * t.element_size() for t in _leaves(loaded))

    def engine(params, kw):
        return StageEngine(create_stage_model(cfg, 0, n), params,
                           engine_config(True, **(kw or {})), device=dev)

    fetched = fetch = None
    for mode, kw in REFIT_RUNS:
        eng = engine(clone_tree(loaded), kw)
        ck.reset_launches()
        _refit_drive(torch, eng, cfg.vocab_size, "before")
        captured = eng.kernel_dispatch_summary().get("graphs", {}).get(
            "captured", 0)
        ptrs = [t.data_ptr() for t in _leaves(eng.params)]
        cached_pages = eng.cache.prefix_cache.num_cached_pages
        if fetched is None:
            # The worker's refit-fetch thread's work, here on this thread:
            # host memory only.
            stats = {}
            t0 = time.monotonic()
            fetched = fetch_refit_tensors(eng, donor["index"], stats=stats)
            fetch = {**stats, "wall_s": time.monotonic() - t0,
                     "fetch_gb_per_s": stats["bytes"] / stats["fetch_s"]
                     / 1e9,
                     "sha256_gb_per_s": stats["bytes"] / stats["sha256_s"]
                     / 1e9}
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        applied = apply_prefetched(eng, fetched, 1)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        mem1 = torch.cuda.memory_allocated(dev)
        invalidated = eng.cache.stats.pages_invalidated
        if applied != len(fetched) or applied != len(donor["index"]):
            raise AssertionError(f"refit_serve (a) {mode}: {applied} of "
                                 f"{len(donor['index'])} tensors applied")
        if [t.data_ptr() for t in _leaves(eng.params)] != ptrs:
            raise AssertionError(f"refit_serve (a) {mode}: a weight moved")
        if mem1 - mem0 > largest:
            raise AssertionError(f"refit_serve (a) {mode}: HBM grew by "
                                 f"{mem1 - mem0} bytes (largest tensor "
                                 f"{largest})")
        if cached_pages <= 0 or invalidated != cached_pages:
            raise AssertionError(f"refit_serve (a) {mode}: {invalidated} "
                                 f"pages invalidated of {cached_pages}")
        after, _, t1, t2 = _refit_drive(torch, eng, cfg.vocab_size, "after")
        launches = ck.launches()
        summary = eng.kernel_dispatch_summary()
        graphs = summary.get("graphs", {})
        check_launches("refit_serve", f"a_{mode}", launches,
                       gqa_expected("fused", summary, n), summary)
        if kw is None:
            check_windows("refit_serve", f"a_{mode}", summary, True)
        if graphs.get("captured", 0) != captured:
            raise AssertionError(f"refit_serve (a) {mode}: "
                                 f"{graphs.get('captured')} graphs after the "
                                 f"refit, {captured} before")
        del eng
        free_device_memory(torch)
        fresh = engine(donor["tree"], kw)
        want, _, t3, t4 = _refit_drive(torch, fresh, cfg.vocab_size,
                                       "fresh")
        del fresh
        free_device_memory(torch)
        same = sum(a.output_ids == b.output_ids for a, b in zip(after, want))
        if same != len(want) or any(len(r.output_ids) != 32 for r in after):
            raise AssertionError(f"refit_serve (a) {mode}: {same} of "
                                 f"{len(want)} streams the fresh engine's")
        got_cached = [r.num_cached_tokens for r in after]
        if got_cached != [r.num_cached_tokens for r in want] or any(
                got_cached[:-1]):
            raise AssertionError(f"refit_serve (a) {mode}: cached tokens "
                                 f"{got_cached}, the fresh engine's "
                                 f"{[r.num_cached_tokens for r in want]}")
        emit({"phase": "refit_serve", "part": "a_in_process", "mode": mode,
              "tensors": applied, "apply_ms": apply_ms,
              "hbm_allocated_delta_bytes": mem1 - mem0,
              "largest_tensor_bytes": largest,
              "pages_invalidated": invalidated,
              "streams_bitwise_fresh_engine": f"{same} of {len(want)}",
              "cached_tokens_after": got_cached,
              "graphs_captured": graphs.get("captured", 0),
              "graphs_captured_after_refit": 0, "graph_replays":
              graphs.get("replays", 0), "weight_pointers": "unchanged",
              "launches": launches,
              "after": stream_metrics(after, t1, t2),
              "fresh_engine": stream_metrics(want, t3, t4),
              **({"fetch": fetch} if mode == "fused" else {}),
              "card": card})
    del fetched


def _refit_swarm(port: int, client, refit: dict, mix, prompts) -> dict:
    """Part (b) on sched_serve's processes: POST the donor's index, wait
    for both workers at version 1, then the HTTP mix and the greedy rows
    over the route RPC. Checks that need the logs or the card come after
    the processes ended (``refit_swarm_checks``)."""
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    t_post = time.monotonic()
    status, reply = _post_json(port, "/weight/refit",
                               {"index_map": refit["index"]})
    if status != 200 or reply != {"version": 1}:
        raise AssertionError(f"refit_serve (b): POST answered {status} "
                             f"{reply}")

    def at_v1() -> bool:
        r = _status_json(port).get("refit") or {}
        nodes = r.get("nodes") or {}
        return (r.get("version") == 1 and len(nodes) == 2
                and set(nodes.values()) == {1})

    _wait_for(at_v1, t_post + REFIT_V1_S, "(b) the workers did not reach "
              "refit_version 1", phase="refit_serve")
    v1_s = time.monotonic() - t_post
    outs = _send_mix(port, mix, "refit_serve")
    again = {i: Request(f"refit-{i}", prompt_ids=list(p),
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=32,
                            ignore_eos=True))
             for i, p in prompts.items()}
    events = []
    for r in again.values():
        r.routing_table = client.route(r.request_id, prompt_ids=r.prompt_ids)
        events.append(client.submit(r))
    for ev in events:
        if not ev.wait(HTTP_TIMEOUT_S):
            raise AssertionError("refit_serve (b): an RPC request hung")
    return {"t_post": t_post, "v1_s": v1_s, "outs": outs,
            "again": list(again.values())}


def refit_swarm_checks(torch, dev, card, cfg, params, refit, run, mix,
                       names, texts) -> None:
    """Part (b)'s checks once the processes ended: replies, the greedy
    rows on the donor (and off the old tree: the mutant "refit not
    applied" must fail), the joins' builds and refit lines."""
    import re

    for i, (out, (_, body)) in enumerate(zip(run["outs"], mix)):
        _rid, reason, usage, _text = _http_reply(out, body)
        if reason != "length" or usage["completion_tokens"] != 32:
            raise AssertionError(f"refit_serve (b) r{i}: {reason}, {usage}")
    for r in run["again"]:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"refit_serve (b) {r.request_id}: "
                                 f"{r.status.value}")
    model_ref = create_plain_model(cfg)
    worst, *_ = greedy_check(torch, model_ref, refit["tree"], run["again"],
                             {}, dev, tol=GREEDY_TOL)
    old, *_ = greedy_check(torch, model_ref, params, run["again"], {}, dev)
    del model_ref
    if old < GREEDY_TOL:
        raise AssertionError(f"refit_serve (b): the old tree's argmax "
                             f"passes the check ({old}): the refit is not "
                             "what was served")
    workers = {}
    for nm, text in zip(names, texts):
        c = re.search(r"compile cache: (\{.*\})", text)
        lines = [json.loads(x) for x in re.findall(r"refit: (\{.*\})", text)]
        if c is None or len(lines) != 1:
            raise AssertionError(f"refit_serve (b) {nm}: no compile-cache "
                                 f"line or {len(lines)} refit lines")
        builds = json.loads(c.group(1))["builds"]
        if any(builds.values()):
            raise AssertionError(f"refit_serve (b) {nm}: built {builds}")
        ln = lines[0]
        workers[nm] = {**ln, "builds": builds,
                       "cache_dir": json.loads(c.group(1))["dir"],
                       "fetch_gb_per_s": ln["bytes"] / ln["fetch_s"] / 1e9,
                       "sha256_gb_per_s": ln["bytes"] / ln["sha256_s"]
                       / 1e9}
    figures = _swarm_http_figures(run["outs"], mix)
    usages = [_http_reply(o, body)[2] for o, (_, body) in
              zip(run["outs"], mix)]
    first = min(o["t_send"] + u["ttft_ms"] / 1e3
                for o, u in zip(run["outs"], usages) if "ttft_ms" in u)
    emit({"phase": "refit_serve", "part": "b_processes",
          "seconds": run["seconds"], "post_to_both_v1_s": run["v1_s"],
          "post_to_first_token_s": first - run["t_post"],
          "requests": len(run["outs"]), "status":
          f"{len(run['outs'])} x 200", "greedy_rows_via_route_rpc":
          len(run["again"]), "greedy_vs_plain_donor": "pass",
          "largest_logit_gap": worst, "tolerance": GREEDY_TOL,
          "old_tree_largest_gap": old, "workers": workers, **figures,
          "card": card})


# The impl a fused run's dispatch summary names on the card.
FUSED_IMPL = "cuda-fused"
# ha_serve: the standby promotes after HA_LEASE_S of silence from the
# primary; it pulls (the lease probe) every HA_SYNC_S.
HA_LEASE_S = 3.0
HA_SYNC_S = 0.5
# The lease expires at most HA_LEASE_S after the kill (a push in flight
# at the kill may renew it once more) and the tail loop sees it at its
# next check, at most HA_SYNC_S later; that check's own pull (a refused
# dial) and the promotion's replay add milliseconds, which the two step
# threads' load can stretch.
HA_PROMOTE_SLACK_S = 0.25
# Part (b)'s client rows decode this many tokens, so the primary's kill
# lands while every row is still decoding (the 28-layer replicas run
# K = 8 windows).
HA_CLIENT_NEW = 96


def _ha_seeded(vocab: int, rid: str):
    """ha_serve's seeded request: 40 prompt ids (under one 64-token page,
    so no prefix of it is ever cached and a second serving computes what
    the first did), top-k 40 at temperature 0.8, seed 7, 32 tokens."""
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    rng = random.Random(4242)
    return Request(rid, prompt_ids=[rng.randrange(1, vocab)
                                    for _ in range(40)],
                   sampling_params=SamplingParams(
                       temperature=0.8, top_k=40, seed=7, max_new_tokens=32,
                       ignore_eos=True))


def _route(client, r, what: str) -> dict:
    """Route ``r`` through ``client``: the route's ms and its end."""
    t0 = time.monotonic()
    r.routing_table = client.route(r.request_id, prompt_ids=r.prompt_ids)
    t_route = time.monotonic()
    if not r.routing_table:
        raise AssertionError(f"ha_serve {what}: no route")
    return {"route_ms": (t_route - t0) * 1e3, "t_route": t_route}


def _serve_alone(client, r, what: str, routed: dict | None = None) -> dict:
    """Route ``r`` through ``client`` (unless ``routed`` holds its route),
    submit it and wait for it: route ms, TTFT (submit to the client's first
    sight of a token) and decode tok/s."""
    routed = routed or _route(client, r, what)
    t0 = time.monotonic()
    ev = client.submit(r)
    first = None
    while not ev.wait(client.poll_interval_s):
        if first is None and r.output_ids:
            first = time.monotonic()
        if time.monotonic() - t0 > SWARM_TIMEOUT_S:
            raise AssertionError(f"ha_serve {what}: {r.status.value}")
    t1 = time.monotonic()
    first = first or t1
    if r.status.value != "finished_length" or len(r.output_ids) != 32:
        raise AssertionError(f"ha_serve {what}: {r.status.value}, "
                             f"{len(r.output_ids)} tokens")
    return {**routed, "ttft_s": first - t0,
            "decode_tok_per_s": (len(r.output_ids) - 1) / max(t1 - first,
                                                              1e-9)}


def _journal_bytes(journal) -> int:
    """The wire bytes of the journal's records (each one HA_JOURNAL
    payload, as the replicator pushes it)."""
    from parallax_tpu_torch.p2p import wire

    records, _ = journal.records_since(0)
    return sum(len(wire.packb(r)) for r in records)


def ha_in_process(torch, dev, card, cfg, params, served, sampled):
    """Part (a): a primary GlobalScheduler + SchedulerService journaling to
    a passive mirror whose StandbyScheduler tails it over TCP loopback
    (lease HA_LEASE_S), two WorkerNodes joined with ``scheduler_standby``
    (one 14 + 14 pipeline, capacity patched as in sched_serve), and a
    SwarmClient over [primary, standby] on a transport of its own. The
    seeded request alone, then the mix; once r0-r6 stream, the primary's
    service stops (its threads and its transport). Every request ends by
    length with zero aborts, launches exact over the pair, no engine
    rebuilt; the standby promotes to epoch 2 within lease + sync interval;
    the workers' heartbeats and the client's routes move to it; the seeded
    request served once more through it gives the same tokens; the old
    primary, revived, fences on the epoch a worker echoes and refuses a
    join. Returns the mix's requests."""
    import threading

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.backend.scheduler_service import SchedulerService
    from parallax_tpu_torch.ha.journal import StateJournal, install_journal
    from parallax_tpu_torch.ha.standby import StandbyScheduler
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.scheduling import node as sched_node
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

    n = cfg.num_hidden_layers
    roofline = sched_node.RooflinePerformanceModel
    real_capacity = roofline.max_layers_in_memory
    roofline.max_layers_in_memory = (
        lambda self, kv_fraction=0.35: SCHED_CAPACITY)
    mirror = GlobalScheduler(cfg, min_nodes_bootstrapping=2, passive=True)
    mirror_service = SchedulerService(
        mirror, TcpTransport("standby", "127.0.0.1"),
        join_timeout_s=SWARM_TIMEOUT_S)
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=2)
    service = standby = journal = None
    workers, builds = [], {}
    client_t = TcpTransport("", "127.0.0.1")
    stop_mon = threading.Event()

    def new_worker(primary: str, standby_addr: str):
        t = TcpTransport("", "127.0.0.1")
        t.start()
        t.peer_id = t.address

        def load(m):
            builds[t.address] = builds.get(t.address, 0) + 1
            return _stage_tree(params, m.start_layer, m.end_layer, n)

        w = WorkerNode(t, primary, cfg, engine_config(True), load_params=load,
                       heartbeat_interval_s=0.5, device=dev,
                       scheduler_standby=[standby_addr])
        workers.append(w)
        return w

    try:
        mirror_service.start()          # passive: no scheduler threads
        standby_addr = mirror_service.transport.address
        service = SchedulerService(
            sched, TcpTransport("scheduler", "127.0.0.1"),
            join_timeout_s=SWARM_TIMEOUT_S, standby_addrs=[standby_addr])
        service.start()
        primary = service.transport.address
        journal = StateJournal(epoch=sched.epoch)
        journal.bind(service.transport)
        install_journal(sched, journal)
        # Built once the primary listens: the lease arms here.
        standby = StandbyScheduler(
            mirror, transport=mirror_service.transport, primary=primary,
            lease_s=HA_LEASE_S, sync_interval_s=HA_SYNC_S,
            node_id=standby_addr)
        standby.start()
        t_spawn = time.monotonic()
        pair = [new_worker(primary, standby_addr) for _ in range(2)]
        threads = [threading.Thread(target=w.start, daemon=True)
                   for w in pair]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SWARM_TIMEOUT_S)
        _wait_for(lambda: _sched_nodes(sched.cluster_status()) and all(
            x[2] for x in _sched_nodes(sched.cluster_status())),
            t_spawn + SWARM_TIMEOUT_S, "(a) no ready pipeline", "ha_serve")
        allocation = _sched_nodes(sched.cluster_status())
        if [x[1] for x in allocation] != [[0, SCHED_CAPACITY],
                                          [SCHED_CAPACITY, n]]:
            raise AssertionError(f"ha_serve (a): allocation {allocation}")
        by_id = {w.node_id: w for w in workers}
        head, tail = by_id[allocation[0][0]], by_id[allocation[1][0]]
        engines = {w.node_id: id(w.engine) for w in workers}
        client_t.start()
        client_t.peer_id = client_t.address
        client = SwarmClient(client_t,
                             scheduler_peers=[primary, standby_addr])
        ck.reset_launches()
        # Before: the seeded request alone on the un-failed swarm.
        pre = _ha_seeded(cfg.vocab_size, "ha-seeded-pre")
        before = _serve_alone(client, pre, "(a) seeded before")

        reqs = _swarm_requests(served, sampled)
        mon = threading.Thread(target=_stamp_first_tokens,
                               args=(reqs, stop_mon, client.poll_interval_s),
                               daemon=True)
        t0 = time.monotonic()
        mon.start()
        events = []
        for r in reqs:
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            events.append(client.submit(r))
        _wait_for(lambda: all(r.output_ids for r in reqs[:7]),
                  t0 + SWARM_TIMEOUT_S, "(a) r0-r6 never streamed",
                  "ha_serve")
        # Kill the primary mid-decode: its threads and transport die.
        service.stop()
        t_kill = time.monotonic()
        at_kill = [len(r.output_ids) for r in reqs]
        if max(at_kill[:7]) >= 32:
            raise AssertionError(f"ha_serve (a): a row finished before the "
                                 f"kill {at_kill}")
        _wait_for(lambda: standby.promoted_at is not None,
                  t_kill + SWARM_TIMEOUT_S, "(a) the standby never promoted",
                  "ha_serve")
        kill_to_promoted = standby.promoted_at - t_kill
        if not (t_kill < standby.promoted_at
                and kill_to_promoted <= (HA_LEASE_S + HA_SYNC_S
                                         + HA_PROMOTE_SLACK_S)
                and mirror.epoch == 2):
            raise AssertionError(f"ha_serve (a): promoted "
                                 f"{kill_to_promoted} s after the kill, "
                                 f"epoch {mirror.epoch}")
        # After: the same seeded request, routed at once through the
        # promoted scheduler and served once the mix is done (alone).
        post = _ha_seeded(cfg.vocab_size, "ha-seeded-post")
        routed = _route(client, post, "(a) seeded after")
        for r, ev in zip(reqs, events):
            if not ev.wait(SWARM_TIMEOUT_S):
                raise AssertionError(f"ha_serve (a) {r.request_id}: "
                                     f"{r.status.value}")
        t1 = time.monotonic()
        stop_mon.set()
        mon.join(10)
        launches = ck.launches()
        summaries = [head.engine.kernel_dispatch_summary(),
                     tail.engine.kernel_dispatch_summary()]
        after = _serve_alone(client, post, "(a) seeded after", routed)
        if client.sched_transport.active_peer != standby_addr:
            raise AssertionError("ha_serve (a): the client's route did not "
                                 "move to the standby")
        if post.output_ids != pre.output_ids:
            raise AssertionError("ha_serve (a): the seeded request after "
                                 "the promotion differs from before")
        _wait_for(lambda: all(w.sched_transport.epoch == 2
                              and w.sched_transport.active_peer
                              == standby_addr for w in workers),
                  time.monotonic() + 15, "(a) a worker's heartbeat did not "
                  "move to the promoted standby", "ha_serve")
        if builds != {w.node_id: 1 for w in workers} or engines != {
                w.node_id: id(w.engine) for w in workers}:
            raise AssertionError(f"ha_serve (a): engines rebuilt {builds}")
        # The old primary, revived, hears a worker echo epoch 2.
        nodes_before = sorted(x.node_id for x in sched.manager.nodes())
        reply = service._on_update(head.node_id, {
            "node_id": head.node_id, "load": 0,
            "epoch": head.sched_transport.epoch})
        refused = service._on_join("zombie", {"node_id": "zombie"})
        sched.drain_events()
        if not (reply.get("not_primary") and sched.fenced
                and refused.get("not_primary")) or nodes_before != sorted(
                    x.node_id for x in sched.manager.nodes()):
            raise AssertionError(f"ha_serve (a): the old primary was not "
                                 f"fenced: {reply}, {refused}")
        ha = {"kill_to_promoted_ms": kill_to_promoted * 1e3,
              "promotion_ms": standby.replay_ms,
              "promoted_to_first_route_ms": (
                  after["t_route"] - standby.promoted_at) * 1e3,
              "journal_records": journal.seq,
              "journal_bytes": _journal_bytes(journal),
              "journal_records_by_kind": dict(journal.records_by_kind),
              "records_pushed": journal.pushes,
              "push_resyncs": journal.resyncs,
              "standby_applied_seq": standby.applied_seq,
              "standby_resyncs": standby.resyncs,
              "tokens_at_kill": at_kill, "in_flight_aborts": sum(
                  r.status.value != "finished_length" for r in reqs),
              "engine_builds": builds}
    finally:
        stop_mon.set()
        for w in workers:
            w.stop()
            w.engine = None
        client_t.stop()
        for part in (standby, journal, mirror.journal):
            if part is not None:
                part.stop()
        mirror_service.stop()
        if service is not None:
            service.stop()
        roofline.max_layers_in_memory = real_capacity
    del workers
    for r in reqs:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"ha_serve (a) {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
    want = {}
    for summary, (_, (s, e), _) in zip(summaries, allocation):
        if summary["impl"] != FUSED_IMPL:
            raise AssertionError(f"ha_serve (a): impl {summary['impl']}")
        for k, v in gqa_expected("fused", summary, e - s).items():
            want[k] = want.get(k, 0) + v
    check_launches("ha_serve", "in_process", launches, want, {})
    FIGURES["ha_in_process"] = {
        **ha, "before": {k: v for k, v in before.items() if k != "t_route"},
        "after": {k: v for k, v in after.items() if k != "t_route"},
        **stream_metrics(reqs, t0, t1)}
    emit({"phase": "ha_serve", "part": "a_in_process",
          "forced": f"RooflinePerformanceModel.max_layers_in_memory -> "
                    f"{SCHED_CAPACITY}",
          "lease_s": HA_LEASE_S, "sync_interval_s": HA_SYNC_S,
          "promote_bound_s": HA_LEASE_S + HA_SYNC_S + HA_PROMOTE_SLACK_S,
          "allocation": allocation, "requests": len(reqs),
          "status": "8 x finished_length", "launches": launches,
          "seeded_after_equals_before": True,
          "old_primary": "fenced, join refused",
          **FIGURES["ha_in_process"], "card": card})
    return reqs


def _ha_ports() -> int:
    """The first of four consecutive ports for part (b)'s two ``run``
    processes (HTTP and RPC each), each of which must know the other's
    address before it starts. They come from below the kernel's ephemeral
    range, where no port-0 bind (the workers', the probe's) can land, so
    nothing in this run takes them between the pick and the binds."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    return random.Random(time.time_ns()).randrange(max(1024, low - 8000),
                                                   low - 8, 4)


def ha_processes(torch, dev, card, cfg, params, ckpt, mix, sampled, served):
    """Part (b): ``run --scheduler-standby S`` (the primary P), ``run
    --standby-of P --ha-lease-s 3`` (S) and two ``join --scheduler-addr P
    --scheduler-standby S`` processes on the checkpoint (two 28-layer
    replicas, cache_aware). S's HTTP answers 503 while it mirrors. The
    HTTP mix goes to P; then this process's SwarmClient over [P, S] routes
    the mix's prompts (HA_CLIENT_NEW tokens each), and once r0-r6 stream,
    P gets SIGKILL. Every client row finishes by length; S promotes (its
    log line: epoch 2, the journal seq it replayed); the client's next
    route lands on S; a second mix (other text) to S's HTTP port, every
    reply 200 with 32 tokens. Clean logs; the survivors exit 0 within 30 s
    of SIGTERM (the workers' node_leaves land on S); each worker built its
    engine once and its launches are exact. Returns the client rows."""
    import os
    import re

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.p2p.transport import TcpTransport

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    names = ("run_primary", "run_standby", "join_a", "join_b")
    paths = [os.path.join(ckpt, f"ha_{nm}.log") for nm in names]
    logs = [open(path, "w+") for path in paths]
    probe = TcpTransport("", "127.0.0.1")
    procs, exits, failed = [], {}, True
    base = _ha_ports()
    p_http, s_http = base, base + 2
    primary, standby = f"127.0.0.1:{base + 1}", f"127.0.0.1:{base + 3}"
    try:
        probe.start()
        probe.peer_id = probe.address
        t_spawn = time.monotonic()
        deadline = t_spawn + SWARM_TIMEOUT_S

        def spawn(args: list[str], i: int) -> None:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "parallax_tpu_torch", *args],
                cwd=repo, env=env, stdout=logs[i], stderr=subprocess.STDOUT))

        run = ["run", "--model-name", ckpt, "--min-nodes", "2", "--routing",
               "cache_aware", "--host", "127.0.0.1"]
        spawn(run + ["--port", str(p_http), "--scheduler-standby", standby],
              0)
        _logged(paths[0], r"scheduler RPC on :(\d+)", procs[0], deadline)
        # The standby's lease arms when it starts: the primary listens.
        spawn(run + ["--port", str(s_http), "--standby-of", primary,
                     "--ha-lease-s", str(HA_LEASE_S)], 1)
        _logged(paths[1], r"(warm standby of)", procs[1], deadline)
        for i in (2, 3):
            spawn(["join", "--scheduler-addr", primary,
                   "--scheduler-standby", standby, "--model-path", ckpt,
                   "--advertise-addr", "127.0.0.1", "--port", "0",
                   "--device", str(dev)], i)

        def ready(port) -> bool:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("ha_serve (b): a process exited")
            nodes = _sched_nodes(_status_json(port))
            return len(nodes) == 2 and all(x[2] for x in nodes)

        # The mirror shows what the primary decided (the journal).
        _wait_for(lambda: ready(p_http) and ready(s_http), deadline,
                  "(b) the replicas did not come up", "ha_serve")
        route_s = time.monotonic() - t_spawn
        decided = [[(x["node_id"], x["layers"]) for x in p["nodes"]]
                   for p in _status_json(p_http)["pipelines"]]
        if sorted(len(p) for p in decided) != [1, 1]:
            raise AssertionError(f"ha_serve (b): allocation {decided}")
        mirror_503 = {}
        _http_client(s_http, mix[1][0], mix[1][1], mirror_503)
        if mirror_503.get("status") != 503:
            raise AssertionError(f"ha_serve (b): the mirror answered "
                                 f"{mirror_503.get('status')}, not 503")

        # One unmeasured pass (other text) warms the fresh workers, so the
        # before and after mixes both meet warm ones.
        _send_mix(p_http, _text_mix(seed=2026)[0], "ha_serve")
        outs_before = _send_mix(p_http, mix, "ha_serve")
        client = SwarmClient(probe, scheduler_peers=[primary, standby])
        # The client's rows once, unmeasured, too: a window graph their
        # longer streams need is captured here, not between their first
        # tokens and the kill (a slow capture on one replica let the
        # other's rows finish before the kill).
        warm = _swarm_requests(served, sampled, new=HA_CLIENT_NEW)
        warm_events = []
        for r in warm:
            r.request_id = f"warm-{r.request_id}"
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            warm_events.append(client.submit(r))
        for r, ev in zip(warm, warm_events):
            if not ev.wait(HTTP_TIMEOUT_S):
                raise AssertionError(f"ha_serve (b) {r.request_id} hung")
        rows = _swarm_requests(served, sampled, new=HA_CLIENT_NEW)
        events = []
        for r in rows:
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            events.append(client.submit(r))
        _wait_for(lambda: all(r.output_ids for r in rows[:7]),
                  time.monotonic() + SWARM_TIMEOUT_S,
                  "(b) r0-r6 never streamed", "ha_serve")
        procs[0].kill()
        t_kill = time.monotonic()
        at_kill = [len(r.output_ids) for r in rows]
        promoted = r"standby promoted: epoch (\d+), (\d+) nodes, (\d+) " \
                   r"pipelines, journal seq (\d+), ([\d.]+) ms"
        _logged(paths[1], r"(standby promoted)", procs[1],
                t_kill + SWARM_TIMEOUT_S)
        t_promoted = time.monotonic()
        # The client's next route, beside the rows' tail: P refuses the
        # connection, S answers.
        late = _ha_seeded(cfg.vocab_size, "ha-late")
        after_alone = _serve_alone(client, late, "(b) after")
        for r, ev in zip(rows, events):
            if not ev.wait(HTTP_TIMEOUT_S):
                raise AssertionError(f"ha_serve (b) {r.request_id} hung")
        if client.sched_transport.active_peer != standby:
            raise AssertionError("ha_serve (b): the client's route did not "
                                 "move to S")
        mix_after, _ = _text_mix(seed=2025)
        outs_after = _send_mix(s_http, mix_after, "ha_serve")
        status_end = _status_json(s_http)
        procs[0].wait(30)
        exits[names[0]] = procs[0].returncode
        t_term = time.monotonic()
        for p in procs[2:]:
            p.send_signal(15)
        for nm, p in zip(names[2:], procs[2:]):
            try:
                exits[nm] = p.wait(SWARM_EXIT_S)
            except subprocess.TimeoutExpired:
                exits[nm] = "timeout"
        _wait_for(lambda: _status_json(s_http)["num_nodes"] == 0,
                  time.monotonic() + 10, "(b) a worker's node_leave did not "
                  "reach S", "ha_serve")
        procs[1].send_signal(15)
        try:
            exits[names[1]] = procs[1].wait(SWARM_EXIT_S)
        except subprocess.TimeoutExpired:
            exits[names[1]] = "timeout"
        exit_s = time.monotonic() - t_term
    except BaseException:
        failed = True
        raise
    else:
        failed = False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        probe.stop()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if failed:
            _emit_sched_tails(names, procs, texts, "ha_serve")
    try:
        for nm, text in zip(names, texts):
            if "step loop error" in text or "Traceback" in text:
                raise AssertionError(f"ha_serve (b) {nm}: an error in its "
                                     "log")
        if exits.pop(names[0]) != -9 or any(c != 0 for c in exits.values()):
            raise AssertionError(f"ha_serve (b): exits {exits}")
        m = re.search(promoted, texts[1])
        if m is None or int(m.group(1)) != 2 or int(m.group(2)) != 2 or \
                int(m.group(3)) != 2:
            raise AssertionError(f"ha_serve (b): promotion line {m}")
        for i, (out, (_, body)) in enumerate(
                list(zip(outs_before, mix)) + list(zip(outs_after,
                                                       mix_after))):
            _rid, reason, usage, _text = _http_reply(out, body)
            if reason != "length" or usage["completion_tokens"] != 32:
                raise AssertionError(f"ha_serve (b) reply {i}: {reason}, "
                                     f"{usage}")
        for r in rows:
            if r.status.value != "finished_length" or \
                    len(r.output_ids) != HA_CLIENT_NEW:
                raise AssertionError(f"ha_serve (b) {r.request_id}: "
                                     f"{r.status.value}")
        if max(at_kill[:7]) >= HA_CLIENT_NEW:
            raise AssertionError(f"ha_serve (b): a row finished before the "
                                 f"kill {at_kill}")
        worker_dispatch = _replica_exits("ha_serve", names[2:], texts[2:],
                                         cfg.num_hidden_layers)
    except AssertionError:
        _emit_sched_tails(names, procs, texts, "ha_serve")
        raise
    FIGURES["ha_http_before"] = _swarm_http_figures(outs_before, mix)
    FIGURES["ha_http_after"] = _swarm_http_figures(outs_after, mix_after)
    emit({"phase": "ha_serve", "part": "b_processes",
          "processes": list(names), "ports": [p_http, s_http],
          "lease_s": HA_LEASE_S, "allocation": decided,
          "spawn_to_route_ready_s": route_s,
          "mirror_http_before_promotion": 503,
          "client_rows": len(rows), "client_new_tokens": HA_CLIENT_NEW,
          "tokens_at_kill": at_kill,
          "in_flight_aborts": sum(r.status.value != "finished_length"
                                  for r in rows),
          "kill_to_promoted_log_ms": (t_promoted - t_kill) * 1e3,
          "promotion": {"epoch": int(m.group(1)), "nodes": int(m.group(2)),
                        "pipelines": int(m.group(3)),
                        "journal_seq_replayed": int(m.group(4)),
                        "promotion_ms": float(m.group(5))},
          "promoted_to_first_route_ms": (after_alone["t_route"]
                                         - t_promoted) * 1e3,
          "seeded_after_beside_rows": {k: v for k, v in after_alone.items()
                                       if k != "t_route"},
          "http_before_p": FIGURES["ha_http_before"],
          "http_after_s": FIGURES["ha_http_after"],
          "routing_end_s": status_end["routing"], "exits": exits,
          "exit_after_sigterm_s": exit_s,
          "worker_dispatch": worker_dispatch, "card": card})
    return rows


def phase_ha_serve(torch, dev, card, cfg, params, ckpt, mix, sampled,
                   served) -> None:
    """Scheduler HA on Qwen2.5-7B at full width: part (a) in this process
    (a 14 + 14 pipeline whose primary scheduler stops mid-decode), part
    (b) as two ``run`` and two ``join`` processes (two replicas, the
    primary SIGKILLed mid-decode); then the greedy rows of both against
    the plain path."""
    t0 = time.monotonic()
    free_device_memory(torch)
    in_process = ha_in_process(torch, dev, card, cfg, params, served,
                               sampled)
    free_device_memory(torch)
    rows = ha_processes(torch, dev, card, cfg, params, ckpt, mix, sampled,
                        served)
    free_device_memory(torch)
    model_ref = create_plain_model(cfg)
    worst, *_ = greedy_check(torch, model_ref, params, in_process + rows,
                             {**sampled, **{len(in_process) + i: s
                                            for i, s in sampled.items()}},
                             dev, tol=GREEDY_TOL)
    del model_ref
    emit({"phase": "ha_serve", "greedy_vs_plain": "pass",
          "greedy_rows": 2 * (len(in_process) - len(sampled)),
          "largest_logit_gap": worst, "tolerance": GREEDY_TOL,
          "compare": {k: FIGURES.get(k) for k in (
              "sched_in_process", "sched_http", "ha_in_process",
              "ha_http_before", "ha_http_after")},
          "phase_s": time.monotonic() - t0, "card": card})


# relay_serve: the scheduler's transport is the relay, and the NAT'd tail
# registers there with this token.
RELAY_TOKEN = "relay-serve-token"
# The model /scheduler/init switches to (parallax_tpu_torch/models/
# presets.py: Qwen3-8B, the qwen3 dense stage with q / k norms), its random
# bf16 tree drawn on the card from this seed.
SWITCH_MODEL = "qwen3-8b"
SWITCH_SEED = 8


def _half_capacity(self, kv_fraction=0.35):
    """relay_serve's roofline patch: a node holds half of the model's
    layers, so two nodes make one pipeline of either model (14 + 14 for
    Qwen2.5-7B, 18 + 18 for Qwen3-8B)."""
    return self.model.num_hidden_layers // 2


def _relay_counts(transport, tail_id: str) -> tuple[int, int]:
    routed = transport.transport_stats()["relay"]["routed"]
    c = routed.get(tail_id, {"envelopes": 0, "bytes": 0})
    return c["envelopes"], c["bytes"]


def _relay_run(client, reqs, stop_mon, part: str) -> tuple:
    """Route and submit ``reqs`` through the SwarmClient, stamping first
    tokens as the client sees them; every request must end by length.
    Returns (t0, t1, route ms)."""
    import threading

    mon = threading.Thread(target=_stamp_first_tokens,
                           args=(reqs, stop_mon, client.poll_interval_s),
                           daemon=True)
    t0 = time.monotonic()
    mon.start()
    events, route_ms = [], []
    for r in reqs:
        t_r = time.perf_counter()
        r.routing_table = client.route(r.request_id, prompt_ids=r.prompt_ids)
        route_ms.append((time.perf_counter() - t_r) * 1e3)
        events.append(client.submit(r))
    for r, ev in zip(reqs, events):
        if not ev.wait(SWARM_TIMEOUT_S):
            raise AssertionError(f"relay_serve {part} {r.request_id}: "
                                 f"{r.status.value}")
    t1 = time.monotonic()
    stop_mon.set()
    mon.join(10)
    for r in reqs:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"relay_serve {part} {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
    return t0, t1, route_ms


def _stage_launches(part, summaries, allocation, launches) -> list:
    """Each stage's expected launches (its layers x its forward steps),
    the process's counts held to their sum."""
    want, per_stage = {}, []
    for stage, summary, (_, (s, e), _) in zip(("head", "tail"), summaries,
                                               allocation):
        if summary["impl"] != FUSED_IMPL:
            raise AssertionError(f"relay_serve {part} {stage}: impl "
                                 f"{summary['impl']}")
        mine = gqa_expected("fused", summary, e - s)
        if stage == "head" and (mine["sample_topk"] or mine["gumbel_rows"]):
            raise AssertionError(f"relay_serve {part}: the head sampled "
                                 f"{summary['dispatch_total']}")
        for k, v in mine.items():
            want[k] = want.get(k, 0) + v
        decode, prefill = forward_steps(summary)
        per_stage.append({"stage": stage, "layers": [s, e],
                          "decode_steps": decode, "prefill_steps": prefill,
                          "launches": mine})
    check_launches("relay_serve", part, launches, want, {})
    return per_stage


def _http_get(port: int, path: str) -> tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_relay_serve(torch, dev, card, cfg, params, ckpt, mix, sampled,
                      served) -> None:
    """What the control plane leaves, on Qwen2.5-7B and Qwen3-8B at full
    width, in this process over loopback TCP.

    (a) The relay: a port scheduler whose transport carries a relay token,
    a direct head and a NAT'd tail (``relay:<id>@<scheduler>``, registered
    with the token, dialed by no one) as one 14 + 14 pipeline serving the
    mix; every FORWARD to the tail crosses the relay, launches are exact
    per stage, the greedy rows within GREEDY_TOL of the plain path, and a
    wrong token is refused.

    (b) The protobuf wire: the mix again on the same pipeline with
    one-chunk prompts, once with msgpack frames and once with the head's
    FORWARDs to the tail as the reference protobuf bytes
    (``p2p/interop.py``, hidden states as bf16 safetensors). The greedy
    tokens must be equal, or a row that parts must stay within GREEDY_TOL
    of the plain path (a near-tie); the schema carries no seed, so the
    seeded rows are only counted. The bytes the relay routed to the tail
    for the mix both ways, and a FORWARD's average.

    (c) The model switch: ``POST /scheduler/init`` to ``run``'s frontend
    names Qwen3-8B; the workers rejoin, drop Qwen2.5-7B and load all 36
    layers (one build each a model); the mix over ``/v1/completions``,
    launches exact, greedy rows within GREEDY_TOL of the plain Qwen3-8B
    path; ``/v1/models`` names it and the UI routes answer."""
    import threading

    from parallax_tpu_torch.backend.run import (
        build_swarm_frontend,
        resolve_model,
    )
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p import interop, proto
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.scheduling import node as sched_node
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
    from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer

    t_phase = time.monotonic()
    free_device_memory(torch)
    n = cfg.num_hidden_layers
    roofline = sched_node.RooflinePerformanceModel
    real_capacity = roofline.max_layers_in_memory
    roofline.max_layers_in_memory = _half_capacity
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=2)
    sched_t = TcpTransport("scheduler", "127.0.0.1", relay_token=RELAY_TOKEN)
    frontend, service, client = build_swarm_frontend(
        sched, sched_t, SimpleTokenizer(), DENSE_MODEL,
        resolve_model=resolve_model,
        tokenizer_fn=lambda _name: SimpleTokenizer(),
        device_memory_bytes=torch.cuda.get_device_properties(
            dev).total_memory)
    switch = {}          # the switch model's config and tree, once drawn
    builds = []          # (worker, model) per stage load

    def worker(label: str, relayed: bool) -> WorkerNode:
        t = TcpTransport("", "127.0.0.1", relay_token=RELAY_TOKEN)
        t.start()
        if relayed:
            t.peer_id = f"relay:{label}@{sched_t.address}"
            t.register_at_relay(sched_t.address)
        else:
            t.peer_id = t.address

        def load_dense(m):
            builds.append((label, DENSE_MODEL))
            return _stage_tree(params, m.start_layer, m.end_layer, n)

        def resolve(name):
            if name != SWITCH_MODEL:
                raise RuntimeError(f"{name} is not on this worker")
            qcfg, tree = switch["cfg"], switch["params"]

            def load(m):
                builds.append((label, name))
                return _stage_tree(tree, m.start_layer, m.end_layer,
                                   qcfg.num_hidden_layers)

            return qcfg, load

        return WorkerNode(t, sched_t.address, cfg, engine_config(True),
                          load_params=load_dense, heartbeat_interval_s=0.5,
                          device=dev, resolve_model=resolve)

    workers, stop_mons = [], []
    server = None
    try:
        service.start()
        head, tail = worker("direct", False), worker("natted", True)
        workers = [head, tail]
        t_spawn = time.monotonic()
        deadline = t_spawn + SWARM_TIMEOUT_S
        # The direct worker joins first: the bootstrap lays the nodes out
        # in join order, so the NAT'd one is the tail.
        starters = [threading.Thread(target=w.start, daemon=True)
                    for w in workers]
        starters[0].start()
        _wait_for(lambda: sched.manager.get(head.node_id) is not None,
                  deadline, "(a) the head never joined", "relay_serve")
        starters[1].start()
        for s in starters:
            s.join(SWARM_TIMEOUT_S)
        _wait_for(lambda: len(_sched_nodes(sched.cluster_status())) == 2
                  and all(x[2] for x in _sched_nodes(
                      sched.cluster_status())),
                  deadline, "(a) no ready pipeline", "relay_serve")
        ready_s = time.monotonic() - t_spawn
        allocation = _sched_nodes(sched.cluster_status())
        if [(x[0], x[1]) for x in allocation] != [
                (head.node_id, [0, n // 2]), (tail.node_id, [n // 2, n])]:
            raise AssertionError(f"relay_serve (a): allocation {allocation}")
        # A registration with a wrong token is refused.
        intruder = TcpTransport("", "127.0.0.1", relay_token="wrong-token")
        intruder.start()
        intruder.peer_id = f"relay:intruder@{sched_t.address}"
        try:
            intruder.register_at_relay(sched_t.address)
            _wait_for(lambda: sched_t.transport_stats()["relay"][
                "rejected"] >= 1, time.monotonic() + 10,
                "(a) a wrong token was not refused", "relay_serve")
            if intruder.peer_id in sched_t._relay_routes:
                raise AssertionError("relay_serve (a): a wrong token got "
                                     "a route")
        finally:
            intruder.stop()
        # The tail's FORWARD frames, by kind (True: protobuf bytes).
        frames = []
        on_forward = tail.transport._handlers[proto.FORWARD]

        def counted(peer, payload):
            frames.append(isinstance(payload, (bytes, bytearray)))
            return on_forward(peer, payload)

        tail.transport.register(proto.FORWARD, counted)

        # (a) the mix through the relayed pipeline.
        reqs = _swarm_requests(served, sampled)
        ck.reset_launches()
        stop_mons.append(threading.Event())
        t0, t1, route_ms = _relay_run(client, reqs, stop_mons[-1], "(a)")
        launches = ck.launches()
        per_stage = _stage_launches(
            "a_relay", [head.engine.kernel_dispatch_summary(),
                        tail.engine.kernel_dispatch_summary()],
            allocation, launches)
        env_a, bytes_a = _relay_counts(sched_t, tail.node_id)
        frames_a = len(frames)
        accepted = tail.transport.transport_stats()["accepted"]
        dials_to_tail = sum(
            t.transport_stats()["dials"].get(tail.transport.address, 0)
            for t in (head.transport, sched_t))
        if frames_a <= 0 or env_a < frames_a or any(frames):
            raise AssertionError(f"relay_serve (a): {env_a} envelopes "
                                 f"routed to the tail, {frames_a} FORWARD "
                                 "frames handled there")
        if accepted or dials_to_tail:
            raise AssertionError(f"relay_serve (a): the tail was dialed "
                                 f"({accepted} accepted, {dials_to_tail} "
                                 "dials)")
        relay_a = sched_t.transport_stats()["relay"]
        FIGURES["relay_in_process"] = stream_metrics(reqs, t0, t1)
        emit({"phase": "relay_serve", "part": "a_relay",
              "forced": "RooflinePerformanceModel.max_layers_in_memory -> "
                        "half the model's layers",
              "allocation": allocation, "spawn_to_ready_s": ready_s,
              "requests": len(reqs), "status": "8 x finished_length",
              "route_ms_median": statistics.median(route_ms),
              "launches": launches, "launches_per_stage": per_stage,
              "forward_frames_to_tail": frames_a,
              "envelopes_routed_to_tail": env_a,
              "bytes_routed_to_tail": bytes_a,
              "relay_envelopes_total": relay_a["envelopes"],
              "relay_bytes_total": relay_a["bytes"],
              "relay_registrations": relay_a["registrations"],
              "wrong_token_rejected": relay_a["rejected"],
              "tail_connections_accepted": accepted,
              "dials_to_tail": dials_to_tail,
              **FIGURES["relay_in_process"],
              "direct_pipeline_sched_serve": FIGURES.get("sched_in_process"),
              "card": card})

        # (b) one-chunk prompts, msgpack frames then the reference protobuf.
        head.engine.scheduler.prefill_chunk_size = 1024
        prompts = {}
        msgpack_payload = head._forward_payload

        def protobuf_payload(peer, ireqs):
            if peer != tail.node_id:
                return msgpack_payload(peer, ireqs)

            def build():
                raw = sum(i.hidden_states.numel()
                          * i.hidden_states.element_size()
                          for i in ireqs if i.hidden_states is not None)
                data = interop.ireqs_to_forward_bytes(
                    ireqs, full_input_ids={i.request_id:
                                           prompts[i.request_id]
                                           for i in ireqs})
                return data, raw, len(data)

            return build

        runs = {}
        for kind in ("msgpack", "protobuf"):
            run_reqs = _swarm_requests(served, sampled)
            for r in run_reqs:
                r.request_id = f"{kind}-{r.request_id}"
                prompts[r.request_id] = list(r.prompt_ids)
            head._forward_payload = (protobuf_payload if kind == "protobuf"
                                     else msgpack_payload)
            env0, bytes0 = _relay_counts(sched_t, tail.node_id)
            f0 = len(frames)
            stop_mons.append(threading.Event())
            t0, t1, _ = _relay_run(client, run_reqs, stop_mons[-1],
                                   f"(b) {kind}")
            env1, bytes1 = _relay_counts(sched_t, tail.node_id)
            kinds = frames[f0:]
            if not kinds or set(kinds) != {kind == "protobuf"}:
                raise AssertionError(f"relay_serve (b) {kind}: frame kinds "
                                     f"{kinds}")
            runs[kind] = {
                "reqs": run_reqs, "forward_frames": len(kinds),
                "envelopes": env1 - env0, "bytes": bytes1 - bytes0,
                "bytes_per_forward": (bytes1 - bytes0) / len(kinds),
                **stream_metrics(run_reqs, t0, t1)}
        head._forward_payload = msgpack_payload
        greedy_rows = [i for i in range(len(reqs)) if i not in sampled]
        pb_reqs, mp_reqs = runs["protobuf"]["reqs"], runs["msgpack"]["reqs"]
        equal_rows = [i for i in greedy_rows
                      if pb_reqs[i].output_ids == mp_reqs[i].output_ids]
        seeded_equal = sum(pb_reqs[i].output_ids == mp_reqs[i].output_ids
                           for i in sampled)
        b_figures = {k: {f: v for f, v in r.items() if f != "reqs"}
                     for k, r in runs.items()}

        # (c) the model switch over HTTP.
        qcfg = get_preset(SWITCH_MODEL)
        qn = qcfg.num_hidden_layers
        gen = torch.Generator(device=dev)
        gen.manual_seed(SWITCH_SEED)
        torch.cuda.synchronize()
        t_init = time.monotonic()
        switch["params"] = create_stage_model(
            qcfg, 0, qn, use_kernels=False).init_params(
                gen, torch.bfloat16, dev)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t_init
        switch["cfg"] = qcfg
        q_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(switch["params"]))
        started = threading.Event()
        server = threading.Thread(
            target=frontend.run, daemon=True,
            kwargs=dict(host="127.0.0.1", port=0,
                        on_start=lambda _fe: started.set()))
        server.start()
        if not started.wait(30):
            raise AssertionError("relay_serve (c): the frontend did not "
                                 "start")
        port = frontend.port
        submitted = []
        real_submit = frontend.submit_fn

        def recording_submit(r):
            submitted.append(r)
            return real_submit(r)

        frontend.submit_fn = recording_submit
        t_post = time.monotonic()
        out = {}
        _http_client(port, "/scheduler/init",
                     {"model_name": SWITCH_MODEL, "init_nodes_num": 2}, out)
        if out.get("status") != 200 or json.loads(out["raw"])["data"][
                "num_layers"] != qn:
            raise AssertionError(f"relay_serve (c): /scheduler/init "
                                 f"{out.get('status')}: {out.get('raw')}")
        post_s = time.monotonic() - t_post

        def switched() -> bool:
            nodes = _sched_nodes(service.scheduler.cluster_status())
            return (service.scheduler.model.model_name == SWITCH_MODEL
                    and len(nodes) == 2 and all(x[2] for x in nodes)
                    and all(w.engine is not None
                            and w._served_model_name == SWITCH_MODEL
                            and w.engine.model.num_local_layers == qn // 2
                            for w in workers))

        _wait_for(switched, t_post + SWARM_TIMEOUT_S,
                  "(c) the workers never served the new model",
                  "relay_serve")
        ready_after_post_s = time.monotonic() - t_post
        allocation_c = _sched_nodes(service.scheduler.cluster_status())
        by_id = {w.node_id: w for w in workers}
        stages_c = [by_id[x[0]] for x in allocation_c]
        if sorted(builds) != sorted([("direct", DENSE_MODEL),
                                     ("natted", DENSE_MODEL),
                                     ("direct", SWITCH_MODEL),
                                     ("natted", SWITCH_MODEL)]):
            raise AssertionError(f"relay_serve (c): engine builds {builds}")
        got = {p: _http_get(port, p)
               for p in ("/v1/models", "/ui", "/ui/meta", "/ui/models")}
        if any(status != 200 for status, _ in got.values()) or json.loads(
                got["/v1/models"][1])["data"][0]["id"] != SWITCH_MODEL:
            raise AssertionError("relay_serve (c): " + str(
                {p: s for p, (s, _) in got.items()}))
        catalog = json.loads(got["/ui/models"][1])
        q3_entry = next((m for m in catalog["models"]
                         if m["name"].lower() == "qwen/qwen3-8b"), None)
        # The mix over /v1/completions (a chat prompt as plain text).
        items = []
        for _path, body in mix:
            body = dict(body)
            if "messages" in body:
                body["prompt"] = body.pop("messages")[0]["content"]
            items.append(("/v1/completions", body))
        env_c0, bytes_c0 = _relay_counts(sched_t, tail.node_id)
        ck.reset_launches()
        stop_mons.append(threading.Event())
        mon = threading.Thread(target=_stamp_first_tokens,
                               args=(submitted, stop_mons[-1], 0.02),
                               daemon=True)
        mon.start()
        t_send = time.monotonic()
        outs = _send_mix(port, items, "relay_serve (c)")
        t_done = time.monotonic()
        stop_mons[-1].set()
        mon.join(10)
        for o, (_path, body) in zip(outs, items):
            _, finish, usage, _text = _http_reply(o, body)
            if finish != "length" or usage["completion_tokens"] != 32:
                raise AssertionError(f"relay_serve (c): {finish}, {usage}")
        launches_c = ck.launches()
        env_c1, bytes_c1 = _relay_counts(sched_t, tail.node_id)
        per_stage_c = _stage_launches(
            "c_switch", [w.engine.kernel_dispatch_summary()
                         for w in stages_c], allocation_c, launches_c)
        reqs_c = list(submitted)
        if len(reqs_c) != len(items):
            raise AssertionError(f"relay_serve (c): {len(reqs_c)} requests "
                                 f"submitted for {len(items)}")
        first_token_s = min(r.first_token_time for r in reqs_c) - t_post
        metrics_c = stream_metrics(reqs_c, t_send, t_done)
    finally:
        for ev in stop_mons:
            ev.set()
        if server is not None:
            frontend.shutdown()
            server.join(30)
        for w in workers:
            w.stop()
            w.engine = None
        service.stop()
        roofline.max_layers_in_memory = real_capacity
    del workers
    free_device_memory(torch)

    # The greedy rows against the plain paths.
    model_ref = create_plain_model(cfg)
    worst_a, *_ = greedy_check(torch, model_ref, params, reqs, sampled, dev,
                               tol=GREEDY_TOL)
    parted = [pb_reqs[i] for i in greedy_rows if i not in equal_rows]
    worst_b = None
    if parted:
        worst_b, *_ = greedy_check(torch, model_ref, params, parted, {}, dev,
                                   tol=GREEDY_TOL)
    del model_ref
    free_device_memory(torch)
    model_q = create_plain_model(switch["cfg"])
    sampled_c = {i for i, r in enumerate(reqs_c)
                 if r.sampling_params.temperature > 0}
    worst_c, *_ = greedy_check(torch, model_q, switch["params"], reqs_c,
                               sampled_c, dev, tol=GREEDY_TOL)
    del model_q
    switch.clear()
    free_device_memory(torch)
    emit({"phase": "relay_serve", "part": "b_protobuf",
          "prefill_chunk_size": 1024, "runs": b_figures,
          "greedy_rows_equal": f"{len(equal_rows)} of {len(greedy_rows)}",
          "greedy_tokens_equal": sum(
              x == y for i in greedy_rows
              for x, y in zip(pb_reqs[i].output_ids, mp_reqs[i].output_ids)),
          "seeded_rows_equal": f"{seeded_equal} of {len(sampled)} (the "
                               "schema carries no seed)",
          "parted_rows_largest_logit_gap": worst_b,
          # The same mix both ways: the bytes a FORWARD also move with how
          # the head happened to batch the rows.
          "bytes_protobuf_over_msgpack": (b_figures["protobuf"]["bytes"]
                                          / b_figures["msgpack"]["bytes"]),
          "card": card})
    emit({"phase": "relay_serve", "part": "c_switch",
          "model": SWITCH_MODEL, "layers": qn, "weights": "random bf16",
          "weight_bytes": q_bytes, "init_s": init_s,
          "post_reply_s": post_s,
          "post_to_workers_ready_s": ready_after_post_s,
          "post_to_first_token_s": first_token_s,
          "allocation": allocation_c, "engine_builds": builds,
          "envelopes_routed_to_natted": env_c1 - env_c0,
          "bytes_routed_to_natted": bytes_c1 - bytes_c0,
          "requests": len(reqs_c), "status": "8 x length over HTTP",
          "launches": launches_c, "launches_per_stage": per_stage_c,
          "greedy_vs_plain": "pass", "largest_logit_gap": worst_c,
          "tolerance": GREEDY_TOL,
          "ui": {p: s for p, (s, _) in got.items()},
          "ui_catalog_qwen3_8b": q3_entry,
          **metrics_c, "card": card})
    emit({"phase": "relay_serve", "greedy_vs_plain_a": "pass",
          "largest_logit_gap_a": worst_a, "tolerance": GREEDY_TOL,
          "compare": {k: FIGURES.get(k) for k in (
              "sched_in_process", "relay_in_process")},
          "phase_s": time.monotonic() - t_phase, "card": card})


# ---------------------------------------------------------------------------
# Phase 9c: obs_serve, the observability plane on the served path
# ---------------------------------------------------------------------------

OBS_SLO = "ttft_p95_ms=60000,tpot_p95_ms=5000,availability=0.9"
# The flight events a pipeline head records when its next hop goes away.
WORKER_PATH_EVENTS = ("abort_path", "migrate_flag", "migrate_park")
# A0-A3 in a torch.profiler trace, by kernel symbol (A3 is two launches).
OBS_PROFILE_KERNELS = {"A0": ("kv_append",), "A1": ("gqa_prefill",),
                       "A2": ("gqa_decode",),
                       "A3": ("sample_candidates_kernel",
                              "sample_pick_kernel")}
OBS_CORE_FAMILIES = (
    "parallax_ttft_ms", "parallax_tpot_ms", "parallax_e2e_ms",
    "parallax_step_host_ms", "parallax_step_device_ms",
    "parallax_goodput_tokens_total", "parallax_goodput_time_seconds_total",
    "parallax_hbm_bytes", "parallax_device_time_seconds_total",
    "parallax_xla_compiles_total", "parallax_tpu_requests_total",
    "parallax_http_ttft_ms", "parallax_health_state",
    "parallax_attn_kernel_dispatch_total")


def _fresh_obs_planes() -> None:
    """A new process-wide registry, goodput ledger and device plane: a
    run's planes then count that run alone (engines bind at build)."""
    from parallax_tpu_torch.obs import device, goodput, registry

    registry._REGISTRY = registry.MetricsRegistry()
    goodput._LEDGER = goodput.GoodputLedger()
    device._PLANE = device.DevicePlane()


def _host_ms_per_visit() -> tuple[float, int]:
    from parallax_tpu_torch.obs.registry import get_registry

    snaps = get_registry().histogram_snapshots()["parallax_step_host_ms"]
    total = sum(c["sum"] for c in snaps.values())
    count = sum(c["count"] for c in snaps.values())
    return total / max(1, count), count


def _profile_busy_ms(prof) -> dict:
    """Device milliseconds by kernel group from a torch.profiler run (the
    sum of the device events' durations, as phase_profile reads them)."""
    from torch.autograd import DeviceType

    groups: dict[str, float] = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        g = _kernel_group(evt.name())
        groups[g] = groups.get(g, 0.0) + evt.duration_ns() / 1e6
    return groups


def obs_library(torch, dev, card, cfg, params) -> dict:
    """Part (a): serve's mix through the library API on the loaded tree,
    with obs at its defaults, then fully on (every request traced, a stall
    watchdog over the engine's admission, an SLO tracker), each run on
    fresh planes; then once more on under torch.profiler. Checks: the
    streams bitwise equal and the launches exact and equal between the two
    runs; goodput ``committed`` equal to the tokens streamed; the ledger's
    ``weights_bfloat16`` and ``kv_pages`` equal to the tree's and the
    pool's bytes; the ledger's tracked bytes within the allocator's
    in-use bytes and the untracked residual under the ledger's own
    threshold (a share of capacity); the observatory's captures equal to
    the engine's captured graphs. Reports the event device ms by program
    beside the profiler's busy ms, capture seconds, the residual and host
    ms a visit in both runs; then obs_ramp."""
    from torch.profiler import ProfilerActivity, profile

    from parallax_tpu_torch.obs.device import get_device_plane
    from parallax_tpu_torch.obs.goodput import get_goodput
    from parallax_tpu_torch.obs.registry import get_registry
    from parallax_tpu_torch.obs.slo import SLOTracker, parse_slo_spec
    from parallax_tpu_torch.obs.trace import get_trace_store
    from parallax_tpu_torch.obs.watchdog import StallWatchdog
    from parallax_tpu_torch.ops import cuda_kernels as ck

    n = cfg.num_hidden_layers
    runs = {}
    for mode in ("defaults", "obs_on", "obs_on_profiled"):
        on = mode != "defaults"
        # What earlier phases left for the collector is not this run's.
        free_device_memory(torch)
        _fresh_obs_planes()
        watch = {}

        def on_engines(engines, on=on, watch=watch):
            if not on:
                return
            sched = engines[0].scheduler
            wd = StallWatchdog(node_id="obs-serve")
            wd.register("admission", lambda: (
                float(len(sched.wait_queue)), float(sched.admitted_total),
                f"{len(sched.running)} running"))
            wd.start()
            watch["wd"] = wd
            watch["slo"] = SLOTracker(parse_slo_spec(OBS_SLO))
            watch["slo"].observe({"hists": {}, "finished": 0,
                                  "aborted": 0})

        ck.reset_launches()
        kw = dict(engine_kw=dict(trace_sample_rate=1.0) if on else None,
                  on_engines=on_engines)
        if mode == "obs_on_profiled":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                reqs, sampled, engines, t0, t1 = serve(
                    torch, [(0, n)], params, cfg, dev, fused=True, **kw)
            busy = _profile_busy_ms(prof)
            del prof
        else:
            reqs, sampled, engines, t0, t1 = serve(
                torch, [(0, n)], params, cfg, dev, fused=True, **kw)
        eng = engines[0]
        launches = ck.launches()
        summary = eng.kernel_dispatch_summary()
        eng.flush_device_time()
        eng.obs_tick(force=True)
        in_use = torch.cuda.memory_allocated(dev)
        plane = get_device_plane()
        hbm = plane.hbm.snapshot()
        comp = plane.compile.snapshot()
        secs = plane.time.snapshot()["seconds"]
        tokens = get_goodput().snapshot()["tokens"]
        host_ms, visits = _host_ms_per_visit()
        streamed = sum(len(r.output_ids) for r in reqs)
        weights = sum(t.nbytes for t in _leaves(eng.params))
        kv = sum(t.nbytes for t in _leaves(eng.kv))
        captured = summary["graphs"]["captured"]
        noted = sum(comp["programs"].get(f, {}).get("compiles", 0)
                    for f in ("decode_window", "spec_window"))
        checks = {
            "goodput_committed_eq_streamed": tokens["committed"] == streamed,
            "weights_bfloat16_exact":
                hbm["classes"].get("weights_bfloat16") == weights,
            "kv_pages_exact": hbm["classes"].get("kv_pages") == kv,
            "tracked_le_in_use": hbm["tracked_bytes"] <= in_use,
            "untracked_under_threshold": hbm["invariant_ok"],
            "captures_eq_graphs": noted == captured and captured > 0,
            "device_time_programs":
                secs.get("prefill", 0) > 0 and secs.get("decode_window",
                                                        0) > 0,
        }
        out = {"phase": "obs_serve", "part": "a_library", "run": mode,
               "launches": launches, "streamed_tokens": streamed,
               "goodput_tokens": tokens, "hbm_classes": hbm["classes"],
               "tracked_bytes": hbm["tracked_bytes"],
               "untracked_bytes": hbm["untracked_bytes"],
               "untracked_limit_bytes": int(hbm["untracked_threshold"]
                                            * hbm["capacity_bytes"]),
               "allocated_bytes": in_use,
               "capacity_bytes": hbm["capacity_bytes"],
               "graphs_captured": captured, "observatory_captures": noted,
               "capture_s": summary["graphs"]["capture_s"],
               "capture_ms_observatory": comp["compile_ms_total"],
               "host_ms_per_visit": host_ms, "host_visits": visits,
               "event_device_ms_by_program": {k: v * 1e3
                                              for k, v in secs.items()},
               "wall_s": t1 - t0, "checks": checks, "card": card}
        if on:
            wd = watch["wd"]
            wd.stop()
            snaps = get_registry().histogram_snapshots()
            slo = watch["slo"].observe_and_evaluate({
                "hists": snaps,
                "finished": get_goodput().snapshot()["requests"]["finished"],
                "aborted": get_goodput().snapshot()["requests"]["aborted"]})
            spans = [s["name"] for s in get_trace_store().spans(
                reqs[0].request_id) or ()]
            out["health"] = wd.summary()["status"]
            out["slo_met"] = {k: v["met"] for k, v in
                              slo["objectives"].items()}
            out["trace_r0_spans"] = sorted(set(spans))
            checks["traced"] = {"queue_wait", "prefill", "decode",
                                "finish"} <= set(spans)
            checks["slo_evaluated"] = bool(slo["objectives"])
        if mode == "obs_on_profiled":
            out["profiler_busy_ms_by_group"] = busy
            out["profiler_busy_ms"] = sum(busy.values())
            out["event_device_ms"] = sum(secs.values()) * 1e3
        emit(out)
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError(f"obs_serve (a) {mode}: {bad}")
        check_launches("obs_serve", mode, launches,
                       gqa_expected("fused", summary, n), summary)
        check_windows("obs_serve", mode, summary, True)
        runs[mode] = (reqs, launches, host_ms)
        del engines, eng
        free_device_memory(torch)
    (a, la, ha), (b, lb, hb) = runs["defaults"], runs["obs_on"]
    if [r.output_ids for r in a] != [r.output_ids for r in b]:
        raise AssertionError("obs_serve (a): the streams differ with obs on")
    if la != lb:
        raise AssertionError(f"obs_serve (a): launches {la} != {lb}")
    FIGURES["obs_host_ms"] = {"defaults": ha, "obs_on": hb}
    emit({"phase": "obs_serve", "part": "a_library",
          "streams_bitwise_equal": True, "launches_equal": True,
          "host_ms_per_visit": {"defaults": ha, "obs_on": hb}, "card": card})
    obs_ramp(torch, dev, card, cfg, params)
    return runs


def obs_ramp(torch, dev, card, cfg, params) -> dict:
    """One engine under a batch that ramps down from 32 rows to 1 (32
    greedy requests of 8, 16, ..., 256 new tokens): the window graphs it
    captures, over how many seconds, and whether the compile observatory
    (JAX's storm rule: 5 captures of one family inside 30 s) calls that a
    storm, which ``--watchdog`` turns into a degraded ``compile``
    component. A reading, not a check."""
    import random

    from parallax_tpu_torch.obs.device import get_device_plane
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    free_device_memory(torch)
    _fresh_obs_planes()
    rng = random.Random(7)
    reqs = [Request(f"ramp{i}",
                    prompt_ids=[rng.randrange(1, cfg.vocab_size)
                                for _ in range(64)],
                    sampling_params=SamplingParams(
                        temperature=0.0, max_new_tokens=8 * (i + 1),
                        ignore_eos=True))
            for i in range(32)]
    n = cfg.num_hidden_layers
    reqs, _, engines, t0, t1 = serve(
        torch, [(0, n)], params, cfg, dev, fused=True,
        engine_kw=dict(max_batch_size=32), requests=(reqs, {}))
    graphs = engines[0].kernel_dispatch_summary()["graphs"]
    comp = get_device_plane().compile
    pending, _, detail = comp.probe()
    out = {"phase": "obs_serve", "part": "a_ramp", "rows": 32,
           "new_tokens": sum(len(r.output_ids) for r in reqs),
           "graphs_captured": graphs["captured"],
           "capture_s": graphs["capture_s"], "wall_s": t1 - t0,
           "window_compiles": comp.snapshot()["programs"].get(
               "decode_window", {}).get("compiles", 0),
           "storms": dict(comp.storms), "probe_pending": pending,
           "probe_detail": detail, "card": card}
    emit(out)
    del engines
    free_device_memory(torch)
    return out


def _scrape_loop(port: int, stop, counts: dict) -> None:
    """Scrape the host-side surfaces until ``stop``: a scrape that made a
    CUDA call during a graph capture on the runner thread would fail the
    capture (and the serving loop)."""
    while not stop.is_set():
        for path in ("/metrics", "/cluster/status_json", "/debug/device",
                     "/healthz", "/debug/flight"):
            try:
                status, _ = _http_get(port, path)
            except OSError:
                continue
            counts[status] = counts.get(status, 0) + 1
        time.sleep(0.02)


def _parse_exposition(text: str) -> dict:
    """Family -> type from a Prometheus text body; every sample line must
    parse as ``name{labels} value``."""
    import re

    fams, sample = {}, re.compile(r"^[a-zA-Z_:][\w:]*(\{.*\})? (\S+)$")
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split()
            fams[name] = kind
        elif ln and not ln.startswith("#"):
            m = sample.match(ln)
            if m is None:
                raise AssertionError(f"obs_serve (b): bad sample {ln!r}")
            float(m.group(2))
    return fams


def obs_http(torch, dev, card, ckpt: str, mix, tmp: str) -> dict:
    """Part (b): ``serve --trace-sample-rate 1 --watchdog --slo ...`` over
    HTTP on the checkpoint, with /metrics, /cluster/status_json,
    /debug/device, /healthz and /debug/flight scraped from another thread
    through the whole mix (the first graph captures included). Checks:
    the mix answers 200, the serving loop never failed and graphs were
    captured; /metrics parses and carries the core families, each a name
    of the JAX package's table; /healthz is ok; /debug/trace/<id> holds
    the request's spans; /profile/start and /profile/stop around one more
    mix write a trace naming A0, A1, A2 and A3."""
    import os
    import threading

    from parallax_tpu_torch import cli
    from parallax_tpu_torch.backend.serve import serve_main
    from parallax_tpu_torch.obs import names as mnames

    declared = {v for k, v in vars(mnames).items()
                if k.isupper() and isinstance(v, str)}
    args = cli.build_parser().parse_args([
        "serve", "--model-path", ckpt, "--device", str(dev),
        "--host", "127.0.0.1", "--port", "0", "--max-batch-size", "7",
        "--page-size", "64", "--max-model-len", "1024",
        "--trace-sample-rate", "1", "--watchdog", "--slo", OBS_SLO])
    if cli.unported_flags(args):
        raise AssertionError(f"obs_serve (b): {cli.unported_flags(args)}")
    _fresh_obs_planes()
    box, started = [], threading.Event()

    def on_start(frontend, runner):
        box.append((frontend, runner))
        started.set()

    server = threading.Thread(target=serve_main, args=(args, on_start),
                              name="obs-serve", daemon=True)
    server.start()
    if not started.wait(HTTP_TIMEOUT_S):
        raise AssertionError("obs_serve (b): the server did not start")
    frontend, runner = box[0]
    port = frontend.port
    stop, counts = threading.Event(), {}
    scraper = threading.Thread(target=_scrape_loop, args=(port, stop,
                                                          counts),
                               daemon=True)
    out = {"phase": "obs_serve", "part": "b_http", "card": card}
    try:
        scraper.start()
        outs = [{} for _ in mix]
        clients = [threading.Thread(target=_http_client, daemon=True,
                                    args=(port, path, body, o))
                   for (path, body), o in zip(mix, outs)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(HTTP_TIMEOUT_S)
        stop.set()
        scraper.join(30)
        rids = [_http_reply(o, body)[0] for o, (_, body) in zip(outs, mix)]
        if runner.error is not None:
            raise AssertionError(f"obs_serve (b): the serving loop failed: "
                                 f"{runner.error}")
        graphs = runner.pipeline.head.kernel_dispatch_summary()["graphs"]
        status, body = _http_get(port, "/metrics")
        fams = _parse_exposition(body.decode())
        missing = [f for f in OBS_CORE_FAMILIES if f not in fams]
        foreign = sorted(set(fams) - declared)
        status_h, health = _http_get(port, "/healthz")
        health = json.loads(health)
        status_t, trace = _http_get(port, f"/debug/trace/{rids[0]}")
        trace = json.loads(trace)
        span_names = sorted({e["name"] for e in trace.get("traceEvents", ())
                             if e.get("ph") == "X"})
        st = json.loads(_http_get(port, "/cluster/status_json")[1])
        # The profiler around one more mix (the same prompts, fresh ids).
        pdir = os.path.join(tmp, "obs_profile")
        code, started_p = _post_json(port, "/profile/start",
                                     {"dir": pdir, "max_seconds": 120})
        code2, again = _post_json(port, "/profile/start", {})
        outs2 = [{} for _ in mix]
        clients = [threading.Thread(target=_http_client, daemon=True,
                                    args=(port, path, body, o))
                   for (path, body), o in zip(mix, outs2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(HTTP_TIMEOUT_S)
        code3, stopped = _post_json(port, "/profile/stop", {})
        with open(stopped["trace"]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        named = {a: sorted(n for n in names if any(k in n for k in keys))
                 for a, keys in OBS_PROFILE_KERNELS.items()}
    finally:
        stop.set()
        frontend.shutdown()
        server.join(HTTP_TIMEOUT_S)
    checks = {
        "mix_200": all(o.get("status") == 200 for o in outs + outs2),
        "graphs_captured_during_scrapes": graphs["captured"] > 0
        and counts.get(200, 0) > 0,
        "metrics_families": status == 200 and not missing,
        "families_declared": not foreign,
        "healthz_ok": status_h == 200 and health["status"] == "ok",
        "trace_spans": status_t == 200 and {"queue_wait", "prefill",
                                            "decode"} <= set(span_names),
        "status_sections": {"device", "metrics", "goodput", "health",
                            "slo"} <= set(st),
        "profile": code == 200 and code2 == 409 and code3 == 200
        and all(named.values()),
    }
    out.update({"scrapes": counts, "graphs": graphs,
                "metrics_families": len(fams), "missing": missing,
                "undeclared": foreign, "health": health["status"],
                "trace_r0_spans": span_names,
                "slo": {k: v["met"] for k, v in
                        st["slo"]["objectives"].items()},
                "goodput": {k: st["goodput"][k] for k in (
                    "tokens_total", "tokens_useful", "goodput_fraction")},
                "profile_kernels": named, "checks": checks})
    emit(out)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"obs_serve (b): {bad}")
    return out


def _post_json(port: int, path: str, body: dict):
    out = {}
    _http_client(port, path, body, out)
    return out["status"], json.loads(out["raw"])


def obs_swarm(torch, dev, card, cfg, ckpt: str, mix) -> dict:
    """Part (c): ``run --slo`` (its parser and run_main, on a thread of
    this process, the roofline's memory bound patched to 14 layers so the
    scheduler lays out one 14 + 14 pipeline) and two ``join
    --trace-sample-rate 1 --watchdog`` processes. Half the mix over HTTP;
    then, from the run's scheduler: the merged step-host histogram's
    count equal to the sum of the nodes', goodput and device sections from
    both nodes, the SLO section; each worker's exit log lists the first
    request's trace under its own stage (the spans stitch by id across
    both processes), and the timeline holds both workers' events (their
    leave, recorded by the scheduler). Then the tail stops while a long
    request streams: the head's own flight event (the broken path) must
    reach the timeline under the head through its heartbeat."""
    import os
    import re
    import threading

    from parallax_tpu_torch import cli
    from parallax_tpu_torch.backend.run import run_main
    from parallax_tpu_torch.scheduling import node as p_node

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    real = p_node.RooflinePerformanceModel.max_layers_in_memory
    p_node.RooflinePerformanceModel.max_layers_in_memory = (
        lambda self, kv_fraction=0.35: SCHED_CAPACITY)
    args = cli.build_parser().parse_args([
        "run", "--model-name", ckpt, "--min-nodes", "2", "--port", "0",
        "--host", "127.0.0.1", "--slo", OBS_SLO])
    if cli.unported_flags(args):
        raise AssertionError(f"obs_serve (c): {cli.unported_flags(args)}")
    box, started = [], threading.Event()
    run_t = threading.Thread(
        target=run_main, args=(args, lambda fe, svc: (box.append((fe, svc)),
                                                      started.set())),
        daemon=True, name="obs-run")
    names = ("join_a", "join_b")
    paths = [os.path.join(ckpt, f"obs_{nm}.log") for nm in names]
    logs = [open(p, "w+") for p in paths]
    procs, texts = [], []
    try:
        run_t.start()
        if not started.wait(HTTP_TIMEOUT_S):
            raise AssertionError("obs_serve (c): run did not start")
        fe, service = box[0]
        rpc = service.transport.address
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "parallax_tpu_torch", "join",
                 "--scheduler-addr", rpc, "--model-path", ckpt,
                 "--advertise-addr", "127.0.0.1", "--port", "0",
                 "--device", str(dev), "--trace-sample-rate", "1",
                 "--watchdog"],
                cwd=repo, env=env, stdout=logs[i], stderr=subprocess.STDOUT))
        sched = service.scheduler

        def ready() -> bool:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("obs_serve (c): a join exited")
            st = sched.cluster_status()
            nodes = [n for p in st["pipelines"] for n in p["nodes"]]
            return len(nodes) == 2 and all(n["ready"] for n in nodes)

        _wait_for(ready, time.monotonic() + SWARM_TIMEOUT_S,
                  "the pipeline did not come up", "obs_serve (c)")
        layout = [[n["layers"] for n in p["nodes"]]
                  for p in sched.cluster_status()["pipelines"]]
        outs = _send_mix(fe.port, mix[:4], "obs_serve")
        rids = [_http_reply(o, body)[0] for o, (_, body) in
                zip(outs, mix[:4])]
        node_ids = [n.node_id for p in sched.manager.pipelines
                    for n in p.nodes]

        def beats() -> bool:
            # The head commits the tokens (its ledger counts them); the
            # tail's ledger ships too, with what it classified.
            nodes = [sched.manager.get(x) for x in node_ids]
            if any(n is None or n.goodput is None or not n.metrics
                   for n in nodes):
                return False
            return sum(n.goodput["tokens_total"] for n in nodes) > 0

        _wait_for(beats, time.monotonic() + 30,
                  "the planes did not arrive", "obs_serve (c)")
        time.sleep(SCHED_BEAT_WAIT_S)
        status = sched.cluster_status()
        nodes = [sched.manager.get(x) for x in node_ids]
        name = "parallax_step_host_ms"
        merged = {lbl: s["count"] for lbl, s in
                  status["metrics"][name].items()}
        summed = {}
        for nd in nodes:
            for lbl, c in (nd.metrics or {}).get(name, {}).items():
                summed[lbl] = summed.get(lbl, 0) + c["count"]
        # A worker's own flight event through its heartbeat: the tail
        # stops while a long request streams through the pipeline, and
        # the head records the broken path (its sender's abort path, or
        # the scheduler's drain flagging the request for migration) and
        # ships the event on its next beat.
        head, tail = node_ids
        joined = {}
        for i, pth in enumerate(paths):
            with open(pth) as f:
                m = re.search(r"worker (\S+) joined scheduler", f.read())
            if m is None:
                raise AssertionError(f"obs_serve (c) {names[i]}: no join "
                                     "line")
            joined[m.group(1)] = procs[i]
        ingested0 = sched.timeline.ingested
        long_body = dict(mix[0][1], max_tokens=2048)
        long_out = {}
        threading.Thread(target=_http_client, daemon=True,
                         args=(fe.port, mix[0][0], long_body,
                               long_out)).start()
        _wait_for(lambda: sched.manager.get(head).load > 0,
                  time.monotonic() + 20, "the long request was not "
                  "dispatched", "obs_serve (c)")
        time.sleep(2.0)
        joined[tail].send_signal(15)
        tail_exit = joined[tail].wait(SWARM_EXIT_S)

        def head_events() -> list:
            return [e for e in sched.timeline.snapshot()["events"]
                    if e.get("node") == head
                    and e.get("kind") in WORKER_PATH_EVENTS]

        _wait_for(lambda: bool(head_events()), time.monotonic() + 30,
                  "the head shipped no event", "obs_serve (c)")
        ingested = sched.timeline.ingested - ingested0
        joined[head].send_signal(15)
        head_exit = joined[head].wait(SWARM_EXIT_S)
        exits = [tail_exit if joined[tail] is p else head_exit
                 for p in procs]
        _wait_for(lambda: sched.cluster_status()["num_nodes"] == 0,
                  time.monotonic() + 10, "a node_leave is missing",
                  "obs_serve (c)")
        timeline = sched.timeline.snapshot()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        p_node.RooflinePerformanceModel.max_layers_in_memory = real
        if box:
            box[0][0].shutdown()
        run_t.join(30)
    traces = []
    for nm, text in zip(names, texts):
        m = re.search(r"obs: (\{.*\})", text)
        if m is None or "Traceback" in text:
            emit({"phase": "obs_serve", "part": "c_swarm", "failed": True,
                  "log_tails": {n: t[-3000:] for n, t in zip(names, texts)}})
            raise AssertionError(f"obs_serve (c) {nm}: no obs exit line")
        traces.append(json.loads(m.group(1)))
    stages = [sorted({s for s, _ in t["traces"].get(rids[0], ())})
              for t in traces]
    ev_nodes = {e.get("node") for e in timeline["events"]}
    checks = {
        "one_two_stage_pipeline": layout == [[[0, SCHED_CAPACITY],
                                               [SCHED_CAPACITY, CKPT_LAYERS]]],
        "mix_200": all(o.get("status") == 200 for o in outs),
        "merged_eq_sum_of_nodes": merged == summed and sum(merged.values()),
        "goodput_two_nodes": status["goodput"]["nodes"] == 2,
        "device_two_nodes": status["device"]["nodes"] == 2,
        "slo_section": bool(status.get("slo", {}).get("objectives")),
        "trace_stitched": sorted(s for st in stages for s in st)
        == [f"0-{SCHED_CAPACITY}", f"{SCHED_CAPACITY}-{CKPT_LAYERS}"],
        "timeline_both_workers": set(node_ids) <= ev_nodes,
        "head_event_ingested": ingested > 0 and bool(head_events()),
        "exits_0": exits == [0, 0],
    }
    out = {"phase": "obs_serve", "part": "c_swarm", "layout": layout,
           "merged_step_host_counts": merged, "sum_of_nodes": summed,
           "goodput": {k: status["goodput"][k] for k in (
               "tokens_total", "tokens_useful", "goodput_fraction")},
           "device_programs_s": status["device"]["programs"]["seconds"],
           "slo": {k: v["met"] for k, v in
                   status["slo"]["objectives"].items()},
           "trace_r0_stages": stages,
           "timeline": {"ingested_before_tail_stop":
                        status["timeline"]["ingested"],
                        "ingested_after": ingested,
                        "head_events": sorted({e["kind"]
                                               for e in head_events()}),
                        "events": [(e.get("node"), e.get("kind"))
                                   for e in timeline["events"]][-12:]},
           "long_request_status": long_out.get("status"),
           "worker_health": [t["health"] for t in traces],
           "checks": checks, "card": card}
    emit(out)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"obs_serve (c): {bad}")
    return out


def host_ms_main(label: str) -> int:
    """``chip_smoke.py --host-ms LABEL``: the host cost of the serving
    loop on the tree this script's package comes from (copy the script
    into another checkout to measure that one): Qwen2.5-7B's random tree,
    serve's mix through the one-in-flight ``drive_step`` loop four times
    on one engine (the first a warm-up that captures the graphs),
    and the mean of ``StepOutputs.host_ms`` over the host visits that
    committed tokens, per visit and per token. One JSON line."""
    import torch

    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.runtime.engine import StageEngine, drive_step

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    ck.build()
    cfg, _model, params = dense_tree(torch, dev, "host_ms")
    n = cfg.num_hidden_layers
    engine = StageEngine(create_stage_model(cfg, 0, n), params,
                         engine_config(True), device=dev)
    rounds = []
    for rep in range(4):
        reqs, _ = make_requests(cfg.vocab_size)
        for i, r in enumerate(reqs):
            r.request_id = f"rep{rep}-{r.request_id}"
            engine.submit(r)
        host, tokens, visits = 0.0, 0, 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pending = None
        while engine.has_work() or pending is not None:
            outs, pending = drive_step(engine, pending)
            for o in outs:
                if o.num_tokens:
                    host += o.host_ms
                    tokens += o.num_tokens
                    visits += 1
        torch.cuda.synchronize()
        rounds.append({"host_ms_per_visit": host / visits,
                       "host_ms_per_token": host / tokens,
                       "visits": visits, "tokens": tokens,
                       "wall_s": time.monotonic() - t0})
    timed = rounds[1:]
    emit({"phase": "host_ms", "tree": label, "rounds": rounds,
          "host_ms_per_visit": statistics.mean(
              r["host_ms_per_visit"] for r in timed),
          "host_ms_per_token": statistics.mean(
              r["host_ms_per_token"] for r in timed),
          "card": card_line()})
    return 0


def phase_obs_serve(torch, dev, card, cfg, params, ckpt, mix) -> None:
    """The observability plane on Qwen2.5-7B at full width, on
    http_serve's checkpoint and its loaded tree: (a) the library run, (b)
    the HTTP server with every obs flag on, (c) the scheduled 14 + 14
    swarm with run --slo."""
    t0 = time.monotonic()
    obs_library(torch, dev, card, cfg, params)
    free_device_memory(torch)
    obs_http(torch, dev, card, ckpt, mix, ckpt)
    free_device_memory(torch)
    obs_swarm(torch, dev, card, cfg, ckpt, mix)
    free_device_memory(torch)
    emit({"phase": "obs_serve", "seconds": time.monotonic() - t0,
          "card": card})


def phase_moe_serve(torch, dev, card: str, want) -> tuple[dict, dict]:
    """Qwen3-30B-A3B at full width and depth on one card: serve the
    8-request mix with the kernels, with the engine's defaults and with
    K1_SYNC (two rows, 8 tokens), check every kernel's launches (the
    grouped GEMM 3 x 48 times per forward step) and the default run's
    greedy streams against the plain path; then, if asked, profile the
    same serve; then the tree quantized in place (``moe_quantized``).
    Returns the launches of the default run and of the quantized one."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.presets import get_preset
    from parallax_tpu_torch.ops import cuda_kernels as ck

    cfg = get_preset(MOE_MODEL)
    n_layers = cfg.num_hidden_layers
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(n_layers))
    free0, total = torch.cuda.mem_get_info()
    emit({"phase": "moe_serve", "model": MOE_MODEL,
          "mem_free_gb_before_init": free0 / 1e9, "mem_total_gb": total / 1e9})
    model = create_stage_model(cfg, 0, n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = model.init_params(gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    free1, _ = torch.cuda.mem_get_info()
    emit({"phase": "moe_serve", "weights": "random bf16",
          "params": sum(t.numel() for t in _leaves(params)),
          "init_s": round(time.monotonic() - t0, 3), "layers": n_layers,
          "moe_layers": moe_layers, "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.num_experts_per_tok,
          "mem_free_gb_after_load": free1 / 1e9})

    for mode, engine_kw in (("fused", None), ("fused_k1_sync", K1_SYNC)):
        # The K1_SYNC run serves K1_SHORT_ROWS for K1_SHORT_NEW tokens (a
        # cut for time; launches and completion still exact).
        short = engine_kw is not None
        ck.reset_launches()
        reqs_m, sampled_m, engines, t0, t1 = serve(
            torch, [(0, n_layers)], params, cfg, dev, fused=True,
            engine_kw=engine_kw,
            requests=k1_short_mix(cfg.vocab_size) if short else None,
            grammar=False)
        launches_m = ck.launches()
        new = K1_SHORT_NEW if short else 32
        for r in reqs_m:
            if r.status.value != "finished_length" or \
                    len(r.output_ids) != new:
                raise AssertionError(f"moe {mode} {r.request_id}: "
                                     f"{r.status.value}, "
                                     f"{len(r.output_ids)} tokens")
        summary = engines[0].kernel_dispatch_summary()
        steps = sum(forward_steps(summary))
        check_launches("moe_serve", mode, launches_m, {
            **gqa_expected(mode, summary, n_layers),
            "grouped_gemm": 3 * moe_layers * steps}, summary)
        if engine_kw is None:
            check_windows("moe_serve", mode, summary, True)
            reqs, sampled, launches = reqs_m, sampled_m, launches_m
        emit({"phase": "moe_serve", "run": mode, "requests": len(reqs_m),
              "engine": engine_kw or "defaults", "launches": launches_m,
              "steps": steps, "dispatch": summary,
              "sharer_cached_tokens": None if short
              else reqs_m[-1].num_cached_tokens,
              "mem_free_gb_after_serve": torch.cuda.mem_get_info()[0] / 1e9,
              "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              **stream_metrics(reqs_m, t0, t1), "card": card})
        del engines
    model_plain = create_stage_model(cfg, 0, n_layers, moe_kernel=False,
                                     use_kernels=False)
    # The same one-shot forward with A4 in place of the plain grouped
    # product (attention plain in both): what A4 alone does to the logits,
    # apart from the compounding of the served greedy streams.
    model_a4 = create_stage_model(cfg, 0, n_layers, moe_kernel=True,
                                  use_kernels=False)
    worst, over, _, tf = greedy_check(torch, model_plain, params, reqs,
                                      sampled, dev, tol=MOE_GREEDY_TOL,
                                      model_alt=model_a4)
    emit({"phase": "moe_serve", "greedy_vs_plain": "pass",
          "largest_logit_gap": worst, "tolerance": MOE_GREEDY_TOL,
          f"tokens_off_by_{GREEDY_TOL}_or_more": over,
          "greedy_tokens": sum(len(r.output_ids) for i, r in enumerate(reqs)
                               if i not in sampled),
          "plain": "moe_ffn(kernel=False) + split attention",
          "teacher_forced_a4_vs_plain": tf})
    if want("moe_profile"):
        phase_profile(torch, dev, cfg, params, phase="moe_profile")
    return launches, moe_quantized(torch, dev, card, cfg, params,
                                   model_plain, moe_layers)


def moe_quantized(torch, dev, card, cfg, params, model_plain,
                  moe_layers: int) -> dict:
    """moe_serve's bf16 tree quantized in place on the card (int8, group
    QUANT_GROUP: the expert stacks, attention and the lm_head; the router
    stays float), so no second tree is drawn; then served fused with the
    defaults: A11 three times a MoE layer and forward step and never A4,
    A10 on the attention projections and the lm_head, greedy rows within
    MOE_GREEDY_TOL of the plain path on the same quantized tree. Returns
    the run's launches."""
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.quant import quantize_tree

    n_layers = cfg.num_hidden_layers
    bf16_bytes = tree_bytes(params)
    # The bf16 runs' engines hold dicts of their own over the same tensors
    # (``params_to``): collected first, each float leaf is freed as soon as
    # its quantized form replaces it.
    free_device_memory(torch)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    quantize_tree(params, bits=8, group_size=QUANT_GROUP,
                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    quant_s = time.monotonic() - t0
    free_device_memory(torch)
    q_bytes = tree_bytes(params)
    emit({"phase": "moe_serve", "quantized": "int8", "in_place": True,
          "group_size": QUANT_GROUP, "quantize_on_card_s": quant_s,
          "tree_bytes": q_bytes, "bf16_tree_bytes": bf16_bytes,
          "ratio": q_bytes / bf16_bytes,
          "mem_free_gb": torch.cuda.mem_get_info()[0] / 1e9, "card": card})
    ck.reset_launches()
    reqs, sampled, engines, t0, t1 = serve(torch, [(0, n_layers)], params,
                                           cfg, dev, fused=True)
    launches = ck.launches()
    for r in reqs:
        if r.status.value != "finished_length" or len(r.output_ids) != 32:
            raise AssertionError(f"moe quantized {r.request_id}: "
                                 f"{r.status.value}, {len(r.output_ids)}")
    summary = engines[0].kernel_dispatch_summary()
    steps = sum(forward_steps(summary))
    check_launches("moe_serve", "fused_int8", launches, {
        **gqa_expected("fused", summary, n_layers),
        **quant_expected("fused", summary, 4 * n_layers + 1),
        "grouped_gemm_q": 3 * moe_layers * steps}, summary)
    check_windows("moe_serve", "fused_int8", summary, True)
    del engines
    worst, over, *_ = greedy_check(torch, model_plain, params, reqs, sampled,
                                   dev, tol=MOE_GREEDY_TOL)
    emit({"phase": "moe_serve", "run": "fused_int8", "requests": len(reqs),
          "engine": "defaults", "launches": launches, "steps": steps,
          "dispatch": summary, "greedy_vs_plain": "pass",
          "largest_logit_gap": worst, "tolerance": MOE_GREEDY_TOL,
          f"tokens_off_by_{GREEDY_TOL}_or_more": over,
          "plain": "the same quantized tree, moe_ffn(kernel=False) + split "
                   "attention, use_kernels=False",
          "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          **stream_metrics(reqs, t0, t1), "card": card})
    return launches


def cut_config(name: str, layers: int):
    """``name``'s preset at full width, cut to ``layers`` layers through the
    raw dict, so per-layer lists (V3.2's indexer_types, MiniMax-M3's
    layer_types and mlp_layer_types) follow the cut."""
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models.presets import MODEL_DB

    raw = dict(MODEL_DB[name], num_hidden_layers=layers)
    for key in ("layer_types", "mlp_layer_types"):
        if key in raw:
            raw[key] = raw[key][:layers]
    return normalize_config(raw, model_name=name)


# teacher_forced_decode's steps: the first this many output tokens of a
# stream's 32 (a cut for the script's time limit).
TEACHER_FORCED_STEPS = 16


def teacher_forced_decode(torch, model, params, req, dev, kernel,
                          max_len=1024) -> dict:
    """One served greedy stream decoded again, step by step (its first
    TEACHER_FORCED_STEPS output tokens), through the
    stage ``model``: its prompt prefilled once, then each output token fed
    as a one-token decode step twice on the same cache, through the fused
    decode kernel (``decode_fused``; it must launch ``kernel`` once per
    layer) on a copy of the cache and through the plain path on the cache
    itself, which goes on to the next step. Returns the largest logit
    difference of any step and how many steps share their argmax (no
    limit): the fused kernel's effect on one step's logits, free of the
    compounding that a served stream adds. On a model with an indexer
    (``_indexer_topk``: DSA's top-k tokens, MSA's selected blocks as token
    positions) the kernel must launch once per indexer layer and step, and
    the result says how many steps select the same sets in every indexer
    layer (upstream rounding included: another attention kernel or a
    swapped expert in an earlier layer moves the indexer's inputs), and
    how many of the fused pass's indexer calls select what the plain
    indexer selects on the same inputs (the kernel alone); on MSA also the
    selected and causal blocks of the last step's first sparse layer,
    which must be fewer (the selection drops blocks)."""
    import dataclasses

    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.runtime.batch import BucketSpec, assemble
    from parallax_tpu_torch.runtime.request import Request
    from parallax_tpu_torch.runtime.scheduler import BatchPlan, ScheduledSeq

    page = 64
    prompt, outs = list(req.prompt_ids), list(req.output_ids)
    npg = (len(prompt) + len(outs) + page - 1) // page
    ref = Request("teacher_forced", prompt_ids=prompt)
    ref.page_ids = list(range(1, npg + 1))
    # A hybrid's linear layers carry the row's state in slot 1; only its
    # full-attention layers launch the decode kernel.
    hybrid = getattr(model, "has_linear_layers", False)
    ref.state_slot = 1
    spec = BucketSpec.build(max_len, 1, max_len, page)

    def plan(tokens, ctx):
        return BatchPlan([ScheduledSeq(request=ref, num_new_tokens=len(tokens),
                                       token_ids=tokens, context_len=ctx)])

    kv = model.new_kv_caches(npg + 1, page, params["norm"]["weight"].dtype,
                             dev, **({"num_state_slots": 1} if hybrid
                                     else {}))
    # An indexer model's top-k rows of each layer (the row of this stream).
    topk = []
    indexer = hasattr(model, "_indexer_topk")
    layers_per_step = None if indexer else model.num_local_layers
    if hybrid:
        from parallax_tpu_torch.config import LAYER_LINEAR

        layers_per_step = sum(
            model.config.layer_type(i) != LAYER_LINEAR
            for i in range(model.start_layer, model.end_layer))
    if indexer:
        indexer_topk = model._indexer_topk

        def recorded(*args):
            # The index cache is the second-to-last argument, the batch
            # the last (DeepSeek-V3.2's and MiniMax-M3's alike).
            plain_args = None
            if args[-1].decode_fused:
                plain_args = (*args[:-2], args[-2].clone(),
                              dataclasses.replace(args[-1],
                                                  decode_fused=False))
            idx, cache = indexer_topk(*args)
            topk.append(idx[0].sort().values)
            if plain_args is not None:
                idx_p, _ = indexer_topk(*plain_args)
                same_input[0] += int(torch.equal(idx_p[0].sort().values,
                                                 topk[-1]))
                same_input[1] += 1
            return idx, cache

        model._indexer_topk = recorded
    diff, same, same_topk, steps = 0.0, 0, 0, 0
    same_input = [0, 0]         # equal selections, fused indexer calls
    ck.reset_launches()
    try:
        with torch.no_grad():
            _, kv = model(params, kv, assemble(plan(prompt, len(prompt)),
                                               spec, page, dev,
                                               with_dense_map=hybrid))
            for j, tok in enumerate(outs[:-1][:TEACHER_FORCED_STEPS]):
                p = plan([tok], len(prompt) + j + 1)
                kv_f = [tuple(x if x is None else x.clone() for x in c)
                        if isinstance(c, tuple) else c.clone() for c in kv]
                topk.clear()
                lf, _ = model(params, kv_f, assemble(p, spec, page, dev,
                                                     with_dense_map=hybrid,
                                                     decode_only=True,
                                                     decode_fused=True))
                topk_f = list(topk)
                if layers_per_step is None:
                    layers_per_step = len(topk_f)
                topk.clear()
                lp, kv = model(params, kv, assemble(p, spec, page, dev,
                                                    with_dense_map=hybrid,
                                                    decode_only=True))
                diff = max(diff,
                           float((lf[0].float() - lp[0].float()).abs().max()))
                same += int(lf[0].argmax() == lp[0].argmax())
                same_topk += int(len(topk_f) == len(topk) and all(
                    torch.equal(a, b) for a, b in zip(topk_f, topk)))
                steps += 1
                del kv_f, lf, lp
    finally:
        if indexer:
            del model._indexer_topk
    torch.cuda.synchronize()
    want = (layers_per_step or 0) * steps
    if want <= 0 or ck.launches()[kernel] != want:
        raise AssertionError(f"teacher-forced {kernel}: "
                             f"{ck.launches()[kernel]} launches, want "
                             f"{want}")
    out = {"request": req.request_id, "prompt_ids": len(prompt),
           "steps": steps, "kernel": kernel,
           "kernel_layers": layers_per_step, "largest_logit_diff": diff,
           "argmax_equal": same}
    if indexer:
        out["topk_sets_equal_steps"] = same_topk
        out["same_input_sets_equal"] = same_input[0]
        out["same_input_calls"] = same_input[1]
    if getattr(model, "runs_msa", False):
        bs = model.config.msa.block_size
        out["selected_blocks_last_step"] = int((topk[0] >= 0).sum()) // bs
        out["causal_blocks_last_step"] = (len(prompt) + steps - 1) // bs + 1
        if out["selected_blocks_last_step"] >= out["causal_blocks_last_step"]:
            raise AssertionError(f"teacher-forced {kernel}: the selection "
                                 f"is not sparse: {out}")
    return out


def serve_three(torch, dev, card, phase, cfg, params, expected, *, tol,
                margin, plain_kw, plain_note, long_prompt=0,
                max_model_len=1024, teacher_forced=None, after=None,
                k1_sync_short: bool = False,
                modes=("fused", "split", "fused_k1_sync", "plain"),
                rows=None) -> dict:
    """Serve the mix on ``cfg``: fused decode and split decode (its kernels)
    with the engine's defaults (the window replayed from CUDA graphs), the
    fused kernels once more in the parent's configuration (K1_SYNC, for the
    rates) and the plain path (``plain_kw``: no kernel but the sampler's
    noise; K1_SYNC). ``expected(mode, summary)`` gives each run's exact
    launches of the attention kernels and the grouped GEMM; the sampler's
    are ``sampler_launches``. The kernel runs' greedy rows must be
    identical and agree with the plain model's one-shot logits within
    ``tol``, with at most ``margin`` more tokens off by GREEDY_TOL or more
    than the plain run, served the same way, shows. ``teacher_forced``, a decode kernel's name, adds
    teacher_forced_decode of the first greedy stream on the plain model,
    or with ``long_prompt`` of the long one (the last request). ``after``,
    if given, is called as ``after(model_plain, runs)`` (each run's
    requests by mode) once the greedy line is out, for a phase's own
    checks. ``k1_sync_short`` serves the fused K1_SYNC run on
    K1_SHORT_ROWS of the mix for K1_SHORT_NEW tokens each: its launches
    and its completion are checked as the full run's are, in a fraction
    of its time, and its rates are not comparable with the other runs'.
    ``modes`` picks the runs (a subset of the four, "plain" always among
    them) and ``rows`` serves only those requests of the mix.
    Returns each run's launches."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.ops import cuda_kernels as ck

    n = cfg.num_hidden_layers
    runs, out = {}, {}
    for mode, fused, model_kw, engine_kw in (
            ("fused", True, None, None), ("split", False, None, None),
            ("fused_k1_sync", True, None, K1_SYNC),
            ("plain", False, plain_kw, K1_SYNC)):
        if mode not in modes:
            continue
        short = mode == "fused_k1_sync" and k1_sync_short
        ck.reset_launches()
        requests = k1_short_mix(cfg.vocab_size) if short else None
        if rows is not None and not short:
            mix, mix_sampled = make_requests(cfg.vocab_size, long_prompt)
            requests = ([mix[i] for i in rows],
                        {j: mix_sampled[i] for j, i in enumerate(rows)
                         if i in mix_sampled})
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, n)], params, cfg, dev, fused=fused,
            long_prompt=long_prompt, max_model_len=max_model_len,
            model_kw=model_kw, engine_kw=engine_kw, requests=requests,
            grammar=short)
        launches = ck.launches()
        new_tokens = K1_SHORT_NEW if short else 32
        for r in reqs:
            if r.status.value != "finished_length" or \
                    len(r.output_ids) != new_tokens:
                raise AssertionError(f"{phase} {mode} {r.request_id}: "
                                     f"{r.status.value}, "
                                     f"{len(r.output_ids)} tokens")
        summary = engines[0].kernel_dispatch_summary()
        decode_steps, prefill_steps = forward_steps(summary)
        if decode_steps <= 0:
            raise AssertionError(f"{phase} {mode}: no decode step")
        check_launches(phase, mode, launches, {
            **sampler_launches(summary), **expected(mode, summary)},
            summary)
        if engine_kw is None:
            check_windows(phase, mode, summary, True)
        emit({"phase": phase, "run": mode, "requests": len(reqs),
              "engine": engine_kw or "defaults",
              "launches": launches, "steps": decode_steps + prefill_steps,
              "decode_steps": decode_steps, "dispatch": summary,
              "sharer_cached_tokens": None if short or len(reqs) < 8
              else reqs[7].num_cached_tokens,
              "mem_free_gb_after_serve": torch.cuda.mem_get_info()[0] / 1e9,
              "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              **stream_metrics(reqs, t0, t1), "card": card})
        runs[mode] = reqs
        out[mode] = launches
        del engines
    greedy = [i for i in range(len(runs["fused"])) if i not in sampled]
    other = runs.get("split", runs["fused"])
    differ = [runs["fused"][i].request_id for i in greedy
              if runs["fused"][i].output_ids != other[i].output_ids]
    if differ:
        raise AssertionError(f"{phase}: fused and split greedy rows differ: "
                             f"{differ}")
    sampled_same = sum(runs["fused"][i].output_ids
                       == other[i].output_ids for i in sampled)
    model_plain = create_stage_model(cfg, 0, n, **plain_kw)
    # The split run's greedy rows are the fused run's, so one check holds
    # both; the plain run is checked the same way, without a limit, to
    # show how far the path without kernels lands from the reference.
    worst, over, spread, _ = greedy_check(torch, model_plain, params,
                                       runs["fused"], sampled, dev,
                                       max_len=max_model_len)
    worst_p, over_p, *_ = greedy_check(torch, model_plain, params,
                                      runs["plain"], sampled, dev,
                                      max_len=max_model_len)
    if teacher_forced is not None:
        emit({"phase": phase, "check": f"teacher_forced_{teacher_forced}"
                                       "_vs_plain",
              **teacher_forced_decode(
                  torch, model_plain, params,
                  runs["fused"][greedy[-1] if long_prompt else greedy[0]],
                  dev, teacher_forced, max_model_len)})
    ok = worst < tol and over <= over_p + margin
    emit({"phase": phase,
          "greedy_fused_equals_split": True if "split" in runs else None,
          "sampled_rows_identical": sampled_same,
          "greedy_vs_plain": "pass" if ok else "FAIL",
          "largest_logit_gap": worst, "tolerance": tol,
          f"tokens_off_by_{GREEDY_TOL}_or_more": over,
          "plain_run_largest_logit_gap": worst_p,
          f"plain_run_tokens_off_by_{GREEDY_TOL}_or_more": over_p,
          "off_margin": margin, "argmax_minus_median_logit": spread,
          "greedy_tokens": sum(len(runs["fused"][i].output_ids)
                               for i in greedy),
          "plain": plain_note})
    if after is not None:
        after(model_plain, runs)
    if not ok:
        raise AssertionError(
            f"{phase}: greedy gap {worst} (tolerance {tol}); {over} tokens "
            f"off by {GREEDY_TOL} or more with the kernels, {over_p} "
            f"without them (margin {margin})"
        )
    return out


def deepseek_serve(torch, dev, card, phase, cfg, params, kernels,
                   long_prompt=0, max_model_len=1024,
                   teacher_forced=None) -> dict:
    """The DeepSeek paths' three runs. ``kernels`` names each kernel run's
    decode kernel, which must launch once per (MLA or full-indexer) layer
    and decode step; the other decode kernels and the GQA kernels never;
    the grouped GEMM 3 times per MoE layer and forward step."""
    n = cfg.num_hidden_layers
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(n))

    def expected(mode, summary):
        decode, prefill = forward_steps(summary)
        kernel = kernels.get("fused" if mode.startswith("fused") else mode)
        if kernel is None:
            return {}
        return {kernel: n * decode,
                "grouped_gemm": 3 * moe_layers * (decode + prefill)}

    return serve_three(
        torch, dev, card, phase, cfg, params, expected,
        tol=DEEPSEEK_GREEDY_TOL, margin=DEEPSEEK_OFF_MARGIN,
        plain_kw=dict(moe_kernel=False, use_kernels=False),
        plain_note="moe_ffn(kernel=False) + plain MLA / indexer",
        long_prompt=long_prompt, max_model_len=max_model_len,
        teacher_forced=teacher_forced)


def run_deepseek(torch, dev, card: str, want) -> dict:
    """Phases 9-12: one random DeepSeek-V3.2 tree at full width and
    DEEPSEEK_LAYERS layers serves V3 (which ignores the indexer weights) and
    V3.2. Returns the launches of each path's runs."""
    from parallax_tpu_torch.models import create_stage_model

    cfg32 = cut_config(DSV32_MODEL, DEEPSEEK_LAYERS)
    free0, total = torch.cuda.mem_get_info()
    emit({"phase": "mla_serve", "model": DSV3_MODEL, "and": DSV32_MODEL,
          "layers": DEEPSEEK_LAYERS, "mem_free_gb_before_init": free0 / 1e9,
          "mem_total_gb": total / 1e9})
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = create_stage_model(cfg32, 0, DEEPSEEK_LAYERS).init_params(
        gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_indexer = sum(t.numel() for lp in params["layers"]
                    for t in _leaves(lp["self_attn"]["indexer"]))
    emit({"phase": "mla_serve", "weights": "random bf16",
          "params_v32": n_params, "params_v3": n_params - n_indexer,
          "init_s": round(time.monotonic() - t0, 3),
          "moe_layers": sum(cfg32.is_moe_layer(i)
                            for i in range(DEEPSEEK_LAYERS)),
          "experts": cfg32.moe.num_experts,
          "mem_free_gb_after_load": torch.cuda.mem_get_info()[0] / 1e9})
    paths = {}
    cfg3 = cut_config(DSV3_MODEL, DEEPSEEK_LAYERS)
    dsa_kw = dict(long_prompt=DSA_LONG_PROMPT, max_model_len=DSA_MAX_MODEL_LEN)
    if want("mla_serve"):
        runs = deepseek_serve(torch, dev, card, "mla_serve", cfg3, params,
                              {"fused": "mla_decode", "split": "mla_attend"},
                              teacher_forced="mla_decode")
        paths["mla_serve/fused"] = runs["fused"]
        paths["mla_serve/split"] = runs["split"]
    if want("mla_profile"):
        phase_profile(torch, dev, cfg3, params, phase="mla_profile")
    if want("dsa_serve"):
        runs = deepseek_serve(torch, dev, card, "dsa_serve", cfg32, params,
                              {"fused": "indexer_fused",
                               "split": "indexer_scores"},
                              teacher_forced="indexer_fused", **dsa_kw)
        paths["dsa_serve/fused"] = runs["fused"]
        paths["dsa_serve/split"] = runs["split"]
    if want("dsa_profile"):
        phase_profile(torch, dev, cfg32, params, phase="dsa_profile", **dsa_kw)
    return paths


def run_gptoss(torch, dev, card: str, want) -> dict:
    """Phase 13: gpt-oss-20b at full width and GPTOSS_LAYERS of its 24
    layers (random bf16
    weights; each layer's sinks drawn N(0, 1) so that they matter) served
    three times: fused (A2 once per layer and decode step, A0 + A1 per layer
    and prefill step), split (A9 per layer and decode step, A1 attend-only
    per layer and prefill step, nothing else), fused with K1_SYNC on two
    rows for 8 tokens, and plain. Returns the launches of each run."""
    from parallax_tpu_torch.models import create_stage_model

    cfg = cut_config(GPTOSS_MODEL, GPTOSS_LAYERS)
    n = cfg.num_hidden_layers
    free0, total = torch.cuda.mem_get_info()
    emit({"phase": "gptoss_serve", "model": GPTOSS_MODEL, "layers": n,
          "mem_free_gb_before_init": free0 / 1e9, "mem_total_gb": total / 1e9})
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = create_stage_model(cfg, 0, n).init_params(gen, torch.bfloat16,
                                                       dev)
    for lp in params["layers"]:
        lp["self_attn"]["sinks"] = torch.randn(
            (cfg.num_attention_heads,), generator=gen, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "gptoss_serve", "weights": "random bf16, sinks N(0, 1)",
          "params": sum(t.numel() for t in _leaves(params)),
          "init_s": round(time.monotonic() - t0, 3),
          "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.num_experts_per_tok,
          "sliding_window": cfg.sliding_window,
          "mem_free_gb_after_load": torch.cuda.mem_get_info()[0] / 1e9})

    # Where a step's MoE time goes: one layer's dense expert loop at a
    # decode step's 7 rows (CUDA events around the whole call, so host
    # gaps count), and one expert's gate/up product with the f32 output the
    # port keeps (as the JAX package does) beside the same product rounded
    # to bf16, at 7 rows and at a 2048-token prefill step.
    from parallax_tpu_torch.models.gpt_oss import gpt_oss_moe_ffn
    from parallax_tpu_torch.models.layers import linear_f32

    mlp = params["layers"][0]["mlp"]
    w = mlp["experts"]["gate_up_proj"][0]                    # [H, 2I]
    probe = {}
    for m in (7, 2048):
        x = torch.randn((m, cfg.hidden_size), generator=gen,
                        device=dev).to(torch.bfloat16)
        probe[f"gate_up_f32_out_m{m}_ms"] = time_ms(
            torch, lambda: linear_f32(x, w.t()), 20)
        probe[f"gate_up_bf16_out_m{m}_ms"] = time_ms(
            torch, lambda: torch.mm(x, w), 20)
        probe[f"gate_up_bound_m{m}_ms"] = bound(
            w.numel() * 2 + x.numel() * 2 + m * w.shape[1] * 4,
            2 * m * w.numel(), "bfloat16")[0]
        if m == 7:
            probe["moe_ffn_layer_m7_ms"] = time_ms(
                torch, lambda: gpt_oss_moe_ffn(
                    x, mlp, cfg.moe.num_experts_per_tok), 5)
    emit({"phase": "gptoss_serve", "moe_probe": probe})

    def expected(mode, summary):
        decode, prefill = forward_steps(summary)
        if mode.startswith("fused"):
            return {"gqa_decode": n * decode, "kv_append": n * prefill,
                    "gqa_prefill": n * prefill}
        if mode == "split":
            return {"gqa_attend": n * decode, "gqa_prefill": n * prefill}
        return {}

    runs = serve_three(
        torch, dev, card, "gptoss_serve", cfg, params, expected,
        tol=GPTOSS_GREEDY_TOL, margin=GPTOSS_OFF_MARGIN,
        plain_kw=dict(use_kernels=False),
        plain_note="plain split attention + the plain MoE loop",
        teacher_forced="gqa_decode", k1_sync_short=True)
    if want("gptoss_profile"):
        phase_profile(torch, dev, cfg, params, phase="gptoss_profile")
    return {f"gptoss_serve/{mode}": launches
            for mode, launches in runs.items()}


def minimax_tree(torch, dev, phase: str, name: str, layers: int):
    """``name`` at full width and ``layers`` layers (``cut_config``) with a
    random bf16 tree from a seeded generator on the card."""
    from parallax_tpu_torch.models import create_stage_model

    cfg = cut_config(name, layers)
    free0, total = torch.cuda.mem_get_info()
    emit({"phase": phase, "model": name, "layers": layers,
          "mem_free_gb_before_init": free0 / 1e9,
          "mem_total_gb": total / 1e9})
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = create_stage_model(cfg, 0, layers).init_params(
        gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    emit({"phase": phase, "weights": "random bf16",
          "params": sum(t.numel() for t in _leaves(params)),
          "init_s": round(time.monotonic() - t0, 3),
          "moe_layers": sum(cfg.is_moe_layer(i) for i in range(layers)),
          "experts": cfg.moe.num_experts,
          "top_k": cfg.moe.num_experts_per_tok,
          "mem_free_gb_after_load": torch.cuda.mem_get_info()[0] / 1e9})
    return cfg, params


def serve_alone(torch, dev, cfg, params, req, max_model_len, **model_kw):
    """Serve ``req`` alone through one engine (fused off, K1_SYNC)."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine, drive_step

    engine = StageEngine(
        create_stage_model(cfg, 0, cfg.num_hidden_layers, **model_kw),
        params, engine_config(False, max_model_len, **K1_SYNC), device=dev)
    engine.submit(req)
    pending = None
    while engine.has_work() or pending is not None:
        _, pending = drive_step(engine, pending)
    torch.cuda.synchronize()
    return req


def _dsa_reduction(idx_q, index_cache, kv_lens, page_indices, cu_q_lens, *,
                   sm_scale, **kw):
    """A wrong block indexer (the mutation): DSA's head reduction, the sum
    over heads of the ReLU'd dots, in place of MSA's max."""
    import torch

    from parallax_tpu_torch.ops.dsa import dsa_indexer_scores_plain
    from parallax_tpu_torch.ops.msa import topk_block_positions
    from parallax_tpu_torch.ops.ragged import ragged_token_positions

    t, hi, _ = idx_q.shape
    weights = torch.full((t, hi), sm_scale, dtype=torch.float32,
                         device=idx_q.device)
    scores = dsa_indexer_scores_plain(idx_q, weights, index_cache, kv_lens,
                                      page_indices, cu_q_lens)
    _, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t,
                                      page_indices.shape[0])
    return topk_block_positions(scores, q_pos, **kw)


def msa_mutations(torch, dev, cfg, params, model_plain, runs) -> None:
    """Whether MSA_GREEDY_TOL separates a wrong model: the long request
    served alone by two mutants of the block indexer (every causal block
    selected, i.e. dense attention; DSA's head reduction in place of MSA's
    max), each checked as the served streams are, against the plain
    model's one-shot logits, beside the correct fused run's long stream.
    At least one mutant must land at or past the limit."""
    import dataclasses

    from parallax_tpu_torch.ops import msa as msa_ops

    def gap(req):
        worst, over, *_ = greedy_check(torch, model_plain, params, [req], {},
                                       dev, max_len=MSA_MAX_MODEL_LEN)
        return {"largest_logit_gap": worst,
                f"tokens_off_by_{GREEDY_TOL}_or_more": over}

    def long_request():
        return make_requests(cfg.vocab_size, MSA_LONG_PROMPT)[0][-1]

    t0 = time.monotonic()
    out = {"correct_fused": gap(runs["fused"][-1])}
    dense = dataclasses.replace(cfg, msa=dataclasses.replace(
        cfg.msa, topk_blocks=MSA_MAX_MODEL_LEN // cfg.msa.block_size))
    out["every_causal_block"] = gap(serve_alone(
        torch, dev, dense, params, long_request(), MSA_MAX_MODEL_LEN,
        use_kernels=False))
    real = msa_ops.msa_sparse_positions_plain
    msa_ops.msa_sparse_positions_plain = _dsa_reduction
    try:
        out["dsa_reduction"] = gap(serve_alone(
            torch, dev, cfg, params, long_request(), MSA_MAX_MODEL_LEN,
            use_kernels=False))
    finally:
        msa_ops.msa_sparse_positions_plain = real
    caught = [k for k in ("every_causal_block", "dsa_reduction")
              if out[k]["largest_logit_gap"] >= MSA_GREEDY_TOL]
    emit({"phase": "msa_serve", "check": "greedy_limit_vs_mutations",
          "request": runs["fused"][-1].request_id,
          "tolerance": MSA_GREEDY_TOL, **out, "caught": caught,
          "seconds": time.monotonic() - t0})
    if not caught:
        raise AssertionError(f"msa_serve: no mutant reaches the greedy "
                             f"limit {MSA_GREEDY_TOL}: {out}")


def phase_msa_serve(torch, dev, card: str) -> dict:
    """MiniMax-M3 at full width and MSA_LAYERS layers serving the mix plus
    the long request: fused (A2 on the dense layer, A7 on each sparse layer
    and decode step), split (A1 attend-only on the dense layer, A8 on the
    sparse ones), fused with K1_SYNC on two rows for 8 tokens, and plain;
    A4 three times per MoE
    layer and forward step; prefill on the split chain (MSA turns fused
    prefill off: A1 attend-only on the dense layer, no A0). Then A7
    teacher-forced on the long stream and the greedy limit against two
    mutants. Returns the fused and split runs' launches."""
    cfg, params = minimax_tree(torch, dev, "msa_serve", MSA_MODEL,
                               MSA_LAYERS)
    n = cfg.num_hidden_layers
    sparse = sum(cfg.msa.sparse_layer_mask[:n])
    dense = n - sparse
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(n))

    def expected(mode, summary):
        decode, prefill = forward_steps(summary)
        if mode == "plain":
            return {}
        want = {"grouped_gemm": 3 * moe_layers * (decode + prefill)}
        if mode.startswith("fused"):
            want.update(gqa_decode=dense * decode,
                        gqa_prefill=dense * prefill,
                        indexer_fused=sparse * decode)
        else:
            want.update(gqa_prefill=dense * (decode + prefill),
                        indexer_scores=sparse * decode)
        return want

    runs = serve_three(
        torch, dev, card, "msa_serve", cfg, params, expected,
        tol=MSA_GREEDY_TOL, margin=MINIMAX_OFF_MARGIN,
        plain_kw=dict(moe_kernel=False, use_kernels=False),
        plain_note="moe_ffn(kernel=False) + plain attention and block "
                   "indexer",
        long_prompt=MSA_LONG_PROMPT, max_model_len=MSA_MAX_MODEL_LEN,
        teacher_forced="indexer_fused",
        after=lambda model_plain, served: msa_mutations(
            torch, dev, cfg, params, model_plain, served), k1_sync_short=True)
    emit({"phase": "msa_serve", "msa_launches": {
        "indexer_fused (A7, fused run)": runs["fused"]["indexer_fused"],
        "indexer_scores (A8, split run)": runs["split"]["indexer_scores"],
        "sparse_layers": sparse, "reduce_kind": "msa"}, "card": card})
    return {"msa_serve/fused": runs["fused"], "msa_serve/split": runs["split"]}


def phase_m2_serve(torch, dev, card: str) -> dict:
    """MiniMax-M2 at full width and M2_LAYERS layers (all MoE) serving the
    mix: fused (A2, A0 + A1 fused prefill), split (A1 attend-only), fused
    with K1_SYNC and plain, A4 three times per layer and forward step.
    Returns each run's launches."""
    cfg, params = minimax_tree(torch, dev, "m2_serve", M2_MODEL, M2_LAYERS)
    n = cfg.num_hidden_layers
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(n))

    def expected(mode, summary):
        if mode == "plain":
            return {}
        return {**gqa_expected(mode, summary, n),
                "grouped_gemm": 3 * moe_layers * sum(forward_steps(summary))}

    runs = serve_three(
        torch, dev, card, "m2_serve", cfg, params, expected,
        tol=M2_GREEDY_TOL, margin=MINIMAX_OFF_MARGIN,
        plain_kw=dict(moe_kernel=False, use_kernels=False),
        plain_note="moe_ffn(kernel=False) + plain attention",
        teacher_forced="gqa_decode")
    return {f"m2_serve/{mode}": launches for mode, launches in runs.items()}


def run_minimax(torch, dev, card: str, want) -> dict:
    """Phases 18-19, each tree freed before the next is made."""
    paths = {}
    if want("msa_serve"):
        paths.update(phase_msa_serve(torch, dev, card))
        free_device_memory(torch)
    if want("m2_serve"):
        paths.update(phase_m2_serve(torch, dev, card))
    return paths


# ---------------------------------------------------------------------------
# next_serve / zoo_serve: the rest of the model zoo (Qwen3-Next, GLM-4,
# Step-3.5)
# ---------------------------------------------------------------------------

NEXT_MODEL = "Qwen/Qwen3-Next-80B-A3B-Instruct"
NEXT_LAYERS = 8
# HF's Qwen3-Next (full_attention_interval 4): three linear layers, then a
# full-attention one. The preset carries no layer_types (nor does the JAX
# package's copy), so the cut names them.
NEXT_LAYER_TYPES = (["linear_attention"] * 3 + ["full_attention"]) * 2
# Random routing over 512 experts (top 10) flips experts at bf16's near
# ties, as DeepSeek's and gpt-oss's do (ROADMAP queue 3): the served runs'
# largest gap was 1.35 (plain 1.21) on the smoke's tree.
NEXT_GREEDY_TOL = 2.5
NEXT_OFF_MARGIN = 48
NEXT_PREFIX = 300           # the prefix pair's first prompt
GLM4_MODEL = "zai-org/GLM-4-9B-0414"
GLM4_MOE_MODEL = "zai-org/GLM-4.5-Air"
STEP_MODEL = "stepfun-ai/Step-3.5-Flash"
# (model, layers kept, greedy limit, rows of the mix served); each tree is
# dropped before the next is made.
ZOO = ((GLM4_MODEL, 40, 0.5, None), (GLM4_MOE_MODEL, 2, 0.5, None),
       (STEP_MODEL, 2, 1.5, (0, 1)))
ZOO_OFF_MARGIN = 16


def family_tree(torch, dev, phase: str, cfg, name: str, reserve_gb=0.0):
    """A random bf16 tree of ``cfg`` from a seeded generator on the card;
    with ``reserve_gb`` it first refuses to start unless the card has the
    tree's bytes plus that much free."""
    from parallax_tpu_torch.models import create_stage_model

    n = cfg.num_hidden_layers
    model = create_stage_model(cfg, 0, n)
    free0, total = torch.cuda.mem_get_info()
    need = cfg_param_count(cfg) * 2
    emit({"phase": phase, "model": name, "layers": n,
          "mem_free_gb_before_init": free0 / 1e9,
          "tree_gb_estimate": need / 1e9, "mem_total_gb": total / 1e9})
    if reserve_gb and free0 < need + reserve_gb * 1e9:
        raise AssertionError(
            f"{phase}: {free0 / 1e9:.1f} GB free, the tree needs "
            f"{need / 1e9:.1f} GB + {reserve_gb} GB")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.monotonic()
    params = model.init_params(gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    emit({"phase": phase, "weights": "random bf16",
          "params": sum(t.numel() for t in _leaves(params)),
          "init_s": round(time.monotonic() - t0, 3),
          "mem_free_gb_after_load": torch.cuda.mem_get_info()[0] / 1e9})
    return params


def cfg_param_count(cfg) -> int:
    """Parameters of ``cfg``'s tree, from an init on the meta device (no
    memory, no draws)."""
    import torch

    from parallax_tpu_torch.models import create_stage_model

    model = create_stage_model(cfg, 0, cfg.num_hidden_layers)
    tree = model.init_params(None, torch.bfloat16, "meta")
    return sum(t.numel() for t in _leaves(tree))


def next_config():
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models.presets import MODEL_DB

    return normalize_config(dict(MODEL_DB[NEXT_MODEL],
                                 num_hidden_layers=NEXT_LAYERS,
                                 layer_types=NEXT_LAYER_TYPES),
                            model_name=NEXT_MODEL)


def _layer_counts(cfg, s, e) -> tuple[int, int]:
    """(full-attention layers, MoE layers) of ``cfg``'s layers [s, e)."""
    from parallax_tpu_torch.config import LAYER_LINEAR

    full = sum(cfg.layer_type(i) != LAYER_LINEAR for i in range(s, e))
    return full, sum(cfg.is_moe_layer(i) for i in range(s, e))


def _greedy_gap(torch, model_plain, params, reqs, dev, max_len=1024) -> dict:
    worst, over, *_ = greedy_check(torch, model_plain, params, reqs, {}, dev,
                                   max_len=max_len)
    return {"largest_logit_gap": worst,
            f"tokens_off_by_{GREEDY_TOL}_or_more": over}


def _serve_on(torch, dev, cfg, params, reqs, **engine_kw):
    """``reqs`` one after another on one plain engine (K1_SYNC, prefix cache
    off unless asked): a later request reuses an earlier one's state
    slot."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine, drive_step

    over = dict(K1_SYNC, enable_prefix_cache=False)
    over.update(engine_kw)
    engine = StageEngine(
        create_stage_model(cfg, 0, cfg.num_hidden_layers, use_kernels=False,
                           moe_kernel=False),
        params, engine_config(False, **over), device=dev)
    for r in reqs:
        engine.submit(r)
        pending = None
        while engine.has_work() or pending is not None:
            _, pending = drive_step(engine, pending)
    torch.cuda.synchronize()
    return reqs


def _fresh(reqs, new: int = 16):
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    return [Request(f"{r.request_id}m", prompt_ids=list(r.prompt_ids),
                    sampling_params=SamplingParams(temperature=0.0,
                                                   max_new_tokens=new,
                                                   ignore_eos=True))
            for r in reqs]


def next_mutations(torch, dev, cfg, params, model_plain, runs) -> dict:
    """Whether NEXT_GREEDY_TOL separates a wrong model: two greedy rows
    served one after another on one engine (the second, a 2-token prompt,
    reuses the first's state slot) by the correct plain path and by two
    mutants, each checked against the plain model's one-shot logits: the
    slot reset skipped (the second row starts from the first's final
    state; the random tree's recurrence forgets within a few tokens, so
    only a short prompt shows it) and the attention output gate dropped.
    At least one mutant must reach the limit."""
    import dataclasses

    from parallax_tpu_torch.models import qwen3_next as qn

    short = runs["fused"][1]
    base = [runs["fused"][0], type(short)(
        "r1short", prompt_ids=list(short.prompt_ids[:2]),
        sampling_params=short.sampling_params)]
    out = {"correct": _greedy_gap(torch, model_plain, params, _serve_on(
        torch, dev, cfg, params, _fresh(base)), dev)}
    real_dn, real_ga = (qn.Qwen3NextStageModel._gated_delta_net,
                        qn.Qwen3NextStageModel._gated_attention)

    def no_reset(self, p, x, state, inputs):
        return real_dn(self, p, x, state, dataclasses.replace(
            inputs, reset_state=torch.zeros_like(inputs.reset_state)))

    def no_gate(self, p, x, kv, inputs):
        # The gate rows of q_proj given a huge bias: sigmoid(gate) = 1.
        d = self.config.head_dim
        w = p["q_proj"]["weight"].view(-1, 2 * d, p["q_proj"]["weight"]
                                       .shape[1])
        gate_off = dict(p, q_proj={
            "weight": p["q_proj"]["weight"],
            "bias": torch.cat([torch.zeros((w.shape[0], d), dtype=w.dtype,
                                           device=w.device),
                               torch.full((w.shape[0], d), 1e4,
                                          dtype=w.dtype, device=w.device)],
                              dim=1).reshape(-1)})
        return real_ga(self, gate_off, x, kv, inputs)

    for name, attr, fn in (("slot_reset_skipped", "_gated_delta_net",
                            no_reset),
                           ("output_gate_dropped", "_gated_attention",
                            no_gate)):
        setattr(qn.Qwen3NextStageModel, attr, fn)
        try:
            reqs = _serve_on(torch, dev, cfg, params, _fresh(base))
        finally:
            qn.Qwen3NextStageModel._gated_delta_net = real_dn
            qn.Qwen3NextStageModel._gated_attention = real_ga
        # The reset mutant shows on the second row (the reused slot).
        out[name] = _greedy_gap(torch, model_plain, params,
                                reqs[1:] if name == "slot_reset_skipped"
                                else reqs, dev)
    caught = [k for k in ("slot_reset_skipped", "output_gate_dropped")
              if out[k]["largest_logit_gap"] >= NEXT_GREEDY_TOL]
    emit({"phase": "next_serve", "check": "greedy_limit_vs_mutations",
          "tolerance": NEXT_GREEDY_TOL, **out, "caught": caught})
    if not caught:
        raise AssertionError(f"next_serve: no mutant reaches the greedy "
                             f"limit {NEXT_GREEDY_TOL}: {out}")
    return out


def next_graphs_off(torch, dev, card, cfg, params, runs) -> None:
    """The fused run once more with the window's CUDA graphs off: every
    row, greedy and seeded, the graphs run's bits (a capture's warm-up step
    must not advance a row's recurrence twice)."""
    reqs, _, _, t0, t1 = serve(torch, [(0, cfg.num_hidden_layers)], params,
                               cfg, dev, fused=True, cuda_graphs=False)
    differ = [r.request_id for r, g in zip(reqs, runs["fused"])
              if r.output_ids != g.output_ids]
    emit({"phase": "next_serve", "run": "fused_eager",
          "rows_equal_to_graphs_run": len(reqs) - len(differ),
          **stream_metrics(reqs, t0, t1), "card": card})
    if differ:
        raise AssertionError(f"next_serve: graphs off differs on {differ}")


def next_pipeline(torch, dev, card, cfg, params, model_plain) -> None:
    """The fused run through a 4 + 4 InProcessPipeline (each stage one
    full-attention layer and three linear ones): launches exact per
    stage's layers and forward steps, greedy rows within the limit."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    n = cfg.num_hidden_layers
    bounds = [(0, n // 2), (n // 2, n)]
    ck.reset_launches()
    reqs, sampled, engines, t0, t1 = serve(torch, bounds, params, cfg, dev,
                                           fused=True)
    launches = ck.launches()
    want = {k: 0 for k in ck.KERNELS}
    for (s, e), eng in zip(bounds, engines):
        summary = eng.kernel_dispatch_summary()
        decode, prefill = forward_steps(summary)
        full, moe = _layer_counts(cfg, s, e)
        want["gqa_decode"] += full * decode
        want["kv_append"] += full * prefill
        want["gqa_prefill"] += full * prefill
        want["grouped_gemm"] += 3 * moe * (decode + prefill)
        if e == n:
            for k, v in sampler_launches(summary).items():
                want[k] += v
    bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if bad:
        raise AssertionError(f"next_serve pipeline: launches (got, want) "
                             f"{bad}")
    worst, over, *_ = greedy_check(torch, model_plain, params, reqs, sampled,
                                   dev, tol=NEXT_GREEDY_TOL)
    emit({"phase": "next_serve", "run": "pipeline_4_4",
          "stages": [list(b) for b in bounds], "launches": launches,
          "largest_logit_gap": worst,
          f"tokens_off_by_{GREEDY_TOL}_or_more": over,
          **stream_metrics(reqs, t0, t1), "card": card})


def next_prefix_pair(torch, dev, card, cfg, params) -> None:
    """A prefix-sharing pair on both cache managers: A (NEXT_PREFIX ids)
    alone, then B (A's prompt and 40 ids more) alone on the same engine
    (fused, the defaults); B must restore A's linear-state snapshot
    (num_cached_tokens > 0) and give the stream it gives on an engine with
    the prefix cache off."""
    import random

    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine, drive_step
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    rng = random.Random(77)
    a_ids = [rng.randrange(1, cfg.vocab_size) for _ in range(NEXT_PREFIX)]
    b_ids = a_ids + [rng.randrange(1, cfg.vocab_size) for _ in range(40)]

    def run(prefix: bool, native, ids_list):
        # 64-token chunks: the pair and the prefix-off run cut the prompt
        # at the same boundaries, so each computes B's tail the same way.
        engine = StageEngine(
            create_stage_model(cfg, 0, cfg.num_hidden_layers), params,
            engine_config(True, enable_prefix_cache=prefix,
                          prefill_chunk_size=64),
            device=dev, use_native=native)
        out = []
        for i, ids in enumerate(ids_list):
            r = Request(f"p{i}", prompt_ids=list(ids),
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=16,
                            ignore_eos=True))
            engine.submit(r)
            pending = None
            while engine.has_work() or pending is not None:
                _, pending = drive_step(engine, pending)
            out.append(r)
        torch.cuda.synchronize()
        return out, type(engine.cache).__name__

    oracle, _ = run(False, None, [b_ids])
    line = {"phase": "next_serve", "check": "prefix_pair",
            "prompt_tokens": [len(a_ids), len(b_ids)], "card": card}
    for label, native in (("native", True), ("python", False)):
        (a, b), manager = run(True, native, [a_ids, b_ids])
        if b.num_cached_tokens <= 0:
            raise AssertionError(f"next_serve prefix pair ({label}): no "
                                 "snapshot restored")
        if b.output_ids != oracle[0].output_ids:
            raise AssertionError(f"next_serve prefix pair ({label}): the "
                                 "stream differs from the prefix-off run")
        line[label] = {"manager": manager,
                       "num_cached_tokens": b.num_cached_tokens,
                       "stream_equals_prefix_off": True}
    emit(line)


def next_linear_profile(torch, dev, card, cfg, params) -> dict:
    """Device ms of one linear (GatedDeltaNet) layer and one gated
    full-attention layer, the MoE FFN of each included, at a decode step
    of 7 rows and at one 256-token prefill chunk, read from torch.profiler
    (the device events' durations, 5 calls each, eager), for ROADMAP P6."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parallax_tpu_torch.config import LAYER_LINEAR
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.base import BatchInputs

    model = create_stage_model(cfg, 0, cfg.num_hidden_layers)
    h = cfg.hidden_size
    page = 64
    kv = model.new_kv_caches(128, page, torch.bfloat16, dev,
                             num_state_slots=8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {}

    def inputs(rows, q):
        t = rows * q
        i32 = dict(dtype=torch.int32, device=dev)
        pages = torch.arange(1, rows * 16 + 1, **i32).reshape(rows, 16)
        ctx = 300 + q
        pos = torch.arange(300, ctx, **i32).repeat(rows)
        seq = torch.arange(rows, **i32).repeat_interleave(q)
        return BatchInputs(
            token_ids=None, hidden_states=None, positions=pos,
            kv_lens=torch.full((rows,), ctx, **i32), page_indices=pages,
            cu_q_lens=torch.arange(0, t + 1, q, **i32),
            num_seqs=torch.tensor([rows], **i32),
            slot_mapping=pages[seq.long(), (pos // page).long()] * page
            + pos % page,
            logits_indices=torch.arange(q - 1, t, q, **i32),
            state_slots=torch.arange(1, rows + 1, **i32),
            dense_map=torch.arange(t, **i32).reshape(rows, q),
            q_lens=torch.full((rows,), q, **i32),
            reset_state=torch.zeros((rows,), **i32),
            decode_only=q == 1, decode_fused=q == 1, prefill_fused=q > 1)

    for label, rows, q in (("decode_7_rows", 7, 1),
                           ("prefill_256_tokens", 1, 256)):
        inp = inputs(rows, q)
        x = torch.randn((rows * q, h), generator=gen, device=dev).to(
            torch.bfloat16)
        for kind in ("linear", "full"):
            li = next(i for i in range(cfg.num_hidden_layers)
                      if (cfg.layer_type(i) == LAYER_LINEAR)
                      == (kind == "linear"))
            with torch.no_grad():
                model._decoder_layer(params["layers"][li], x, kv[li], inp,
                                     None)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        model._decoder_layer(params["layers"][li], x, kv[li],
                                             inp, None)
                    torch.cuda.synchronize()
            us = sum(e.duration_ns() / 1e3
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
            out[f"{kind}_layer_{label}_device_ms"] = us / 5 / 1e3
            del prof
    n_lin = sum(cfg.layer_type(i) == LAYER_LINEAR
                for i in range(cfg.num_hidden_layers))
    out["linear_layers_decode_step_device_ms"] = (
        out["linear_layer_decode_7_rows_device_ms"] * n_lin)
    emit({"phase": "next_serve", "check": "layer_device_ms", "layers": {
        "linear": n_lin, "full": cfg.num_hidden_layers - n_lin}, **out,
        "card": card})
    return out


def phase_next_serve(torch, dev, card: str) -> dict:
    """Qwen3-Next-80B-A3B at full width and NEXT_LAYERS layers (linear
    0-2, full 3, linear 4-6, full 7; MoE everywhere: E 512, top 10): the
    mix fused (A0 + A1 and A2 at head dim 256 on the full layers, A4 three
    times a layer and forward step, A3), split (A1 attend-only), fused with
    K1_SYNC on two rows and plain; a 4 + 4 pipeline; the prefix pair on
    both managers; the greedy limit against two mutants; the layers'
    device ms. Returns the fused and split runs' launches."""
    cfg = next_config()
    params = family_tree(torch, dev, "next_serve", cfg, NEXT_MODEL)
    # HF's Qwen3-Next initializes its (1 + w) norms at w = 0, a unit scale;
    # the JAX package's init (which the port's copies) leaves them at ones,
    # a scale of 2 at every norm, which sharpens every attention and the
    # logits and lets bf16 rounding move the greedy stream. The smoke
    # serves HF's convention.
    for lp in params["layers"]:
        for norm in (lp["input_layernorm"], lp["post_attention_layernorm"],
                     *(lp["self_attn"][k] for k in ("q_norm", "k_norm")
                       if "self_attn" in lp)):
            norm["weight"].zero_()
    params["norm"]["weight"].zero_()
    n = cfg.num_hidden_layers
    full, moe = _layer_counts(cfg, 0, n)

    def expected(mode, summary):
        if mode == "plain":
            return {}
        return {**gqa_expected(mode, summary, full),
                "grouped_gemm": 3 * moe * sum(forward_steps(summary))}

    def after(model_plain, runs):
        next_mutations(torch, dev, cfg, params, model_plain, runs)
        next_graphs_off(torch, dev, card, cfg, params, runs)
        next_pipeline(torch, dev, card, cfg, params, model_plain)
        next_prefix_pair(torch, dev, card, cfg, params)
        next_linear_profile(torch, dev, card, cfg, params)

    runs = serve_three(
        torch, dev, card, "next_serve", cfg, params, expected,
        tol=NEXT_GREEDY_TOL, margin=NEXT_OFF_MARGIN,
        plain_kw=dict(moe_kernel=False, use_kernels=False),
        plain_note="moe_ffn(kernel=False) + plain attention; the linear "
                   "layers are plain PyTorch on every route",
        after=after, k1_sync_short=True, teacher_forced="gqa_decode")
    return {f"next_serve/{mode}": launches for mode, launches in runs.items()}


def step_mutation(torch, dev, cfg, params, model_plain, runs, tol) -> None:
    """Whether the greedy limit separates Step-3.5 without its head-wise
    attention gate: the fused run's rows served again by the plain path
    with ``g_proj`` dropped, against the correct plain model's logits."""
    from parallax_tpu_torch.models import step3p5

    real = step3p5.Step3p5StageModel._attention

    def no_gate(self, lp, h, kv, inputs, window):
        attn = {k: v for k, v in lp["self_attn"].items() if k != "g_proj"}
        return real(self, dict(lp, self_attn=attn), h, kv, inputs, window)

    step3p5.Step3p5StageModel._attention = no_gate
    try:
        reqs = _serve_on(torch, dev, cfg, params, _fresh(runs["fused"][:1]))
    finally:
        step3p5.Step3p5StageModel._attention = real
    gap = _greedy_gap(torch, model_plain, params, reqs, dev)
    emit({"phase": "zoo_serve", "model": STEP_MODEL,
          "check": "greedy_limit_vs_mutation", "tolerance": tol,
          "head_gate_dropped": gap,
          "caught": gap["largest_logit_gap"] >= tol})
    if gap["largest_logit_gap"] < tol:
        raise AssertionError(f"zoo_serve: the head-gate mutant stays under "
                             f"the greedy limit {tol}: {gap}")


def phase_zoo_serve(torch, dev, card: str) -> dict:
    """GLM-4-9B-0414 (all 40 layers), GLM-4.5-Air (2 of 46: dense layer 0,
    MoE layer 1) and Step-3.5-Flash (2 of 45: one full, one sliding layer;
    the tree's bytes plus 2 GB must be free), one tree at a time: fused
    (A0 + A1, A2, A3; A4 on MoE layers) and plain, launches exact, greedy
    rows within each model's limit; Step-3.5's limit against its head-gate
    mutant. Returns the fused runs' launches."""
    paths = {}
    for name, layers, tol, rows in ZOO:
        from parallax_tpu_torch.config import LAYER_SLIDING

        cfg = cut_config(name, layers)
        params = family_tree(torch, dev, "zoo_serve", cfg, name,
                             reserve_gb=2.0 if name == STEP_MODEL else 0.0)
        n = cfg.num_hidden_layers
        moe = sum(cfg.is_moe_layer(i) for i in range(n))

        def expected(mode, summary, n=n, moe=moe):
            if mode == "plain":
                return {}
            return {**gqa_expected(mode, summary, n),
                    "grouped_gemm": 3 * moe * sum(forward_steps(summary))}

        after = None
        if name == STEP_MODEL:
            def after(model_plain, runs, cfg=cfg, params=params, tol=tol):
                step_mutation(torch, dev, cfg, params, model_plain, runs, tol)
        emit({"phase": "zoo_serve", "model": name, "layers": n,
              "moe_layers": moe, "sliding_layers": sum(
                  cfg.layer_type(i) == LAYER_SLIDING for i in range(n)),
              "partial_rotary_factor": cfg.partial_rotary_factor})
        runs = serve_three(
            torch, dev, card, "zoo_serve", cfg, params, expected, tol=tol,
            margin=ZOO_OFF_MARGIN,
            plain_kw=dict(moe_kernel=False, use_kernels=False)
            if cfg.moe is not None else dict(use_kernels=False),
            plain_note=f"{name}: plain attention"
            + (" + moe_ffn(kernel=False)" if moe else ""),
            modes=("fused", "plain"), rows=rows, after=after)
        paths[f"zoo_serve/{name}"] = runs["fused"]
        del params
        free_device_memory(torch)
    return paths


# The run whose launches each kernel's entry in the kernels line reports.
# ---------------------------------------------------------------------------
# The native cache manager and speculative decoding (native, spec_serve,
# pp_spec) on the Qwen2.5-7B tree.


def _host_us(log) -> dict:
    """Calls and median / mean host microseconds of a ``_timed`` log."""
    ts = [t * 1e6 for t, _ in log]
    return {"calls": len(ts),
            "median_us": statistics.median(ts) if ts else None,
            "mean_us": statistics.fmean(ts) if ts else None}


def _time_manager(engines) -> dict:
    """Wrap the head's cache manager (admit / grow / release) and the
    engine's step (dispatch / resolve) with host timers."""
    eng = engines[0]
    logs = {k: [] for k in ("admit", "grow", "release", "dispatch",
                            "resolve")}
    for name, key in (("allocate_for_prompt", "admit"),
                      ("ensure_capacity", "grow"), ("release", "release")):
        _timed(eng.cache, name, logs[key])
    _timed(eng, "dispatch", logs["dispatch"])
    _timed(eng, "resolve", logs["resolve"])
    return logs


def _manager_figures(logs) -> dict:
    """Host us per manager call; host ms per step (dispatch plus resolve
    seconds over dispatches: an overlapped resolve's wait for the card
    counts)."""
    steps = len(logs["dispatch"])
    host = sum(t for t, _ in logs["dispatch"] + logs["resolve"])
    dispatch = sum(t for t, _ in logs["dispatch"])
    return {**{k: _host_us(logs[k]) for k in ("admit", "grow", "release")},
            "host_ms_per_step": host / steps * 1e3 if steps else None,
            "dispatch_ms_per_step": dispatch / steps * 1e3 if steps else None,
            "steps": steps}


def manager_host_bench(iters: int = 60) -> dict:
    """Host seconds of admit + grow + release through each manager with no
    device, in the regime of the JAX package's claim
    (``tests/test_native_cache.py::test_native_manager_faster_than_python``:
    8 prompts of 1,024 ids over a 5-id alphabet, page 16, 260 pages, so the
    tree is full and every admission evicts)."""
    from parallax_tpu_torch.native import NativeCacheManager
    from parallax_tpu_torch.runtime.cache_manager import CacheManager
    from parallax_tpu_torch.runtime.request import (
        Request,
        RequestStatus,
        SamplingParams,
    )

    rng = random.Random(2)
    prompts = [[rng.randrange(5) for _ in range(1024)] for _ in range(8)]

    def run(cm, n):
        t0 = time.perf_counter()
        for i in range(n):
            req = Request(f"b{i}", prompt_ids=list(prompts[i % 8]),
                          sampling_params=SamplingParams())
            if not cm.allocate_for_prompt(req):
                continue
            req.num_computed_tokens = req.num_prompt_tokens
            req.output_ids = [1]
            cm.ensure_capacity(req, req.total_len)
            req.status = RequestStatus.FINISHED_EOS
            cm.release(req)
        return time.perf_counter() - t0

    kw = dict(page_size=16, num_pages=260)
    run(NativeCacheManager(**kw), 10)
    out = {}
    for name, cls in (("python", CacheManager),
                      ("native", NativeCacheManager)):
        out[name + "_ms"] = min(run(cls(**kw), iters) for _ in range(3)) * 1e3
    out["python_over_native"] = out["python_ms"] / out["native_ms"]
    out["iterations"] = iters
    return out


# The eviction round's pool: 48 pages of 64 positions hold about four of the
# mix's contexts, so donated prefixes are evicted as the round goes on.
NATIVE_PRESSURE_PAGES = 48


def phase_native(torch, dev, card, cfg, model_full, params):
    """The native C++ cache manager on Qwen2.5-7B: serve's mix with the
    engine's defaults on the native manager (asked for explicitly: a card
    whose host cannot build the library fails here) and on the Python one,
    in turns (native, Python, Python, native: the first run of the phase
    pays the process's warm-up). Streams bitwise equal, the same sharer
    hit, launches exact. Host us per admit / grow / release and host ms
    per step, each run; then the mix twice on 48 pages (max batch 3), so
    the tree evicts, both managers; and the host-only benchmark of the JAX
    package's claim."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    n = cfg.num_hidden_layers
    out = {}
    for pages, batch, label in ((192, 7, "serve"),
                                (NATIVE_PRESSURE_PAGES, 3, "evicting")):
        runs = {}
        order = ((True, False, False, True) if label == "serve"
                 else (True, False))
        for turn, native in enumerate(order):
            box = {}
            ck.reset_launches()
            reqs, sampled, engines, t0, t1 = serve(
                torch, [(0, n)], params, cfg, dev, fused=True,
                use_native=native,
                engine_kw=dict(num_pages=pages, max_batch_size=batch),
                on_engines=lambda e: box.update(logs=_time_manager(e)))
            launches = ck.launches()
            name = type(engines[0].cache).__name__
            want_name = "NativeCacheManager" if native else "CacheManager"
            if name != want_name:
                raise AssertionError(f"native {label}: {name} served, "
                                     f"{want_name} asked for")
            for r in reqs:
                if (r.status.value != "finished_length"
                        or len(r.output_ids) != 32):
                    raise AssertionError(f"native {label} {r.request_id}: "
                                         f"{r.status.value}")
            summary = engines[0].kernel_dispatch_summary()
            check_launches("native", f"{label}/{want_name}", launches,
                           gqa_expected("fused", summary, n), summary)
            # The pressure round: the mix once more on the warm tree.
            second = None
            if label == "evicting":
                again, _ = make_requests(cfg.vocab_size)
                for r in again:
                    r.request_id += "b"
                tb = time.monotonic()
                for r in again:
                    r.arrival_time = tb
                    engines[0].submit(r)
                _drain(engines[0])
                second = {"hit_tokens": sum(r.num_cached_tokens
                                            for r in again),
                          "wall_s": time.monotonic() - tb}
                reqs = reqs + again
            if want_name in runs and [r.output_ids for r in reqs] != [
                    r.output_ids for r in runs[want_name]]:
                raise AssertionError(f"native {label}: {want_name}'s two "
                                     "runs differ")
            runs[want_name] = reqs
            fig = {"manager": want_name, "turn": turn,
                   **_manager_figures(box["logs"]),
                   "sharer_cached_tokens": reqs[7].num_cached_tokens,
                   "cache": engines[0].cache_stats(),
                   "second_round": second, **stream_metrics(
                       reqs[:8], t0, t1)}
            emit({"phase": "native", "run": label, **fig, "card": card})
            out[f"{label}/{want_name}/{turn}"] = fig
            del engines
        a, b = runs["NativeCacheManager"], runs["CacheManager"]
        differ = [x.request_id for x, y in zip(a, b)
                  if x.output_ids != y.output_ids]
        if differ:
            raise AssertionError(f"native {label}: streams differ from the "
                                 f"Python manager's at {differ}")
        hits = ([x.num_cached_tokens for x in a],
                [y.num_cached_tokens for y in b])
        # Under eviction the two trees may break LRU ties apart (the JAX
        # package's differential test compares evicted sets, not orders).
        if label == "serve" and hits[0] != hits[1]:
            raise AssertionError(f"native {label}: prefix hits differ "
                                 f"{hits}")
        emit({"phase": "native", "run": label, "hits_native_python": hits})
    bench = manager_host_bench()
    emit({"phase": "native", "check": "streams_bitwise_equal_python",
          "rows": 8, "evicting_rows": 16,
          "host_bench": bench, "card": card})
    FIGURES["native"] = out
    free_device_memory(torch)


def spec_requests(vocab: int):
    """serve's mix plus two greedy prompts made of a 64-token span repeated
    (4 and 6 times), so that n-gram lookup has matches in them."""
    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    reqs, sampled = make_requests(vocab)
    rng = random.Random(64)
    for i, reps in ((8, 4), (9, 6)):
        span = [rng.randrange(1, vocab) for _ in range(64)]
        reqs.append(Request(
            f"r{i}", prompt_ids=span * reps,
            sampling_params=SamplingParams(temperature=0.0,
                                           max_new_tokens=32,
                                           ignore_eos=True)))
    return reqs, sampled


def _track_spec(engine) -> dict:
    """Per-request speculation counters (accepted / rejected proposal
    tokens, as the engine counts them by source), the tokens the
    speculative resolves committed and the row-steps they committed them
    in (a row's verify forwards), read off the engine's own resolve
    paths."""
    track = {"rows": {}, "spec_tokens": 0, "row_steps": 0}
    queue: list = []
    count = engine._count_spec_result

    def count_row(src, acc, rej):
        rid = queue.pop(0) if queue else None
        e = track["rows"].setdefault(rid, [0, 0])
        e[0] += acc
        e[1] += rej
        count(src, acc, rej)

    window = engine._resolve_spec_multistep
    sync = engine._resolve_speculative

    def resolve_window(ticket):
        queue[:] = [seg.request.request_id for seg, src in zip(
            ticket.plan.seqs, ticket.spec_meta["sources"]) if src]
        o = window(ticket)
        track["spec_tokens"] += o.num_tokens
        # A row's verify forwards in the chain: the steps it committed in.
        track["row_steps"] += int((ticket.ms_counts.numpy() > 0).sum())
        return o

    def resolve_sync(ticket):
        spec_plan, proposals, _ = ticket.spec_verify
        queue[:] = [seg.request.request_id
                    for seg, prop in zip(spec_plan.seqs, proposals) if prop]
        o = sync(ticket)
        track["spec_tokens"] += o.num_tokens
        track["row_steps"] += len(spec_plan.seqs)
        return o

    engine._count_spec_result = count_row
    engine._resolve_spec_multistep = resolve_window
    engine._resolve_speculative = resolve_sync
    return track


def _draft_tree(params, layers: int) -> dict:
    """The served tree's first ``layers`` layers with its embedding, final
    norm and head: the same tensors, no copy."""
    return {"layers": params["layers"][:layers],
            "embed_tokens": params["embed_tokens"], "norm": params["norm"],
            "lm_head": params["lm_head"]}


def make_draft(torch, dev, cfg, params, layers: int,
               max_propose_ms: float = 250.0):
    """A DraftProposer on the served tree (``layers`` = all of them) or its
    first ``layers`` layers, sharing its tensors, with the target's page
    size and the engine's defaults (K = 4 windows from CUDA graphs);
    ``max_propose_ms`` is its proposal deadline."""
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.models.presets import PRESETS
    from parallax_tpu_torch.runtime.engine import DraftProposer, StageEngine

    dcfg = cfg if layers == cfg.num_hidden_layers else normalize_config(
        dict(PRESETS[DENSE_MODEL], num_hidden_layers=layers),
        model_name=DENSE_MODEL)
    eng = StageEngine(create_stage_model(dcfg, 0, layers),
                      _draft_tree(params, layers),
                      engine_config(True, 1024, decode_lookahead=4,
                                    num_pages=256),
                      device=dev, use_native=True)
    return DraftProposer(eng, max_propose_ms=max_propose_ms)


def _first_parting(torch, model_full, params, a, b, dev, lora=None) -> dict:
    """Where two streams of one prompt part: the index and the gap there
    between the two tokens, in logits, on the plain one-shot reference
    (None if equal). A seeded row draws argmax(logits / T + noise) over
    its top k with the noise of its (seed, output step) in both runs, so
    its gap is taken in that space, scaled back by T: (l_a - l_b) + T (g_a
    - g_b); where a drawn token lies past the reference's top k, the gap
    is how far it sits under the k-th logit (the runs kept different
    sets). ``lora`` is the reference forward's adapter field."""
    from parallax_tpu_torch.ops.sampling import gumbel_rows_plain

    same = 0
    while (same < min(len(a.output_ids), len(b.output_ids))
           and a.output_ids[same] == b.output_ids[same]):
        same += 1
    if same >= len(a.output_ids):
        return {"index": None, "gap": 0.0}
    row = one_shot_rows(torch, model_full, params, a, dev,
                        lora=lora)[same].float()
    ta, tb = a.output_ids[same], b.output_ids[same]
    gap = float(row[ta]) - float(row[tb])
    sp = a.sampling_params
    out = {"index": same}
    if sp.temperature > 0 and sp.seed is not None:
        noise = gumbel_rows_plain(
            torch.tensor([sp.seed & 0x7FFFFFFF]), torch.tensor([same]), 0,
            model_full.config.vocab_size)[0]
        order = torch.argsort(row, descending=True).tolist()
        out.update(logit_gap=gap, noise_gap=float(noise[ta] - noise[tb]),
                   ranks=[order.index(ta), order.index(tb)])
        gap = abs(gap + sp.temperature * float(noise[ta] - noise[tb]))
        k = sp.top_k
        outside = [t for t in (ta, tb) if 0 < k <= order.index(t)]
        if outside:
            # A token past the reference's top k was drawn: the runs kept
            # different top-k sets, a near-tie if it sits within the
            # tolerance of the k-th logit.
            boundary = max(float(row[order[k - 1]] - row[t])
                           for t in outside)
            out["top_k_boundary_gap"] = boundary
            gap = boundary
    return {**out, "gap": abs(gap)}


def _draft_rejection_gaps(torch, model_full, params, reqs, sampled, log,
                          dev) -> dict:
    """Every logged draft proposal of a greedy row against the committed
    stream: at its first token off the stream, the plain one-shot logit
    gap between the committed token and the proposed one. A same-weights
    draft (A2 decode) and the target (A1 verify) may only part at a
    near-tie. ``agreement`` is the share of proposed tokens the committed
    stream took, each compared on the stream's own prefix (up to and
    including a proposal's first parting)."""
    by_prompt = {tuple(r.prompt_ids): r for i, r in enumerate(reqs)
                 if i not in sampled}
    worst, partings, positions, rows_of = 0.0, 0, 0, {}
    for ctx, prop in log:
        r = None
        for plen in {len(x.prompt_ids) for x in by_prompt.values()}:
            r = by_prompt.get(tuple(ctx[:plen]))
            if r is not None:
                break
        if r is None or not prop:
            continue
        m = len(ctx) - len(r.prompt_ids)
        for j, tok in enumerate(prop):
            if m + j >= len(r.output_ids):
                break
            positions += 1
            if tok != r.output_ids[m + j]:
                if r.request_id not in rows_of:
                    rows_of[r.request_id] = one_shot_rows(
                        torch, model_full, params, r, dev)
                row = rows_of[r.request_id][m + j]
                worst = max(worst, float(row[r.output_ids[m + j]])
                            - float(row[tok]))
                partings += 1
                break
    rows_of.clear()
    return {"largest_gap": worst, "partings": partings,
            "positions": positions, "proposals": len(log),
            "agreement": 1.0 - partings / positions if positions else None}


# spec_serve's runs: (name, engine kwargs, draft layers or None).
SPEC_RUNS = (
    ("off", None, None),
    ("ngram", dict(speculative_tokens=4), None),
    ("off_k1_sync", K1_SYNC, None),
    ("ngram_k1_sync", dict(K1_SYNC, speculative_tokens=4), None),
    ("draft_same_tree", dict(speculative_tokens=4), "all"),
    ("draft_4_layers", dict(speculative_tokens=4), 4),
)


def phase_spec_serve(torch, dev, card, cfg, model_full, params):
    """Speculative decoding on Qwen2.5-7B at full width and depth: serve's
    mix plus two prompts of a repeated 64-token span, served with
    speculation off and (a) n-gram P = 4 with the defaults (K = 8 windows
    from CUDA graphs), (b) the K = 1 sync fallback (beside K1_SYNC with
    speculation off), (c) a draft that is the served tree (shared tensors)
    and (d) its first 4 layers. Launches exact (graph replays and the
    draft engine's own included); greedy rows within GREEDY_TOL of the
    plain one-shot argmax; each greedy and seeded row equal to the
    spec-off run's, or parting from it only at a near-tie (the verify runs
    on A1, the plain decode on A2); (c) at least 90% of its greedy rows'
    proposals accepted and every parting of a draft proposal from the
    committed stream at a gap under GREEDY_TOL. Per request: acceptance;
    per run: tokens committed per verify forward, decode tok/s and TTFT
    beside spec off, and the draft's share of the wall."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    n = cfg.num_hidden_layers
    runs, figs = {}, {}
    for name, engine_kw, draft_layers in SPEC_RUNS:
        draft = None
        log: list = []
        if draft_layers is not None:
            # The same-tree draft's agreement check needs fixed proposal
            # positions: its deadline is one no round reaches, so where it
            # proposes does not depend on the host's speed.
            draft = make_draft(torch, dev, cfg, params,
                               n if draft_layers == "all" else draft_layers,
                               max_propose_ms=DRAFT_NO_DEADLINE_MS
                               if draft_layers == "all" else 250.0)
            propose = draft.propose_batch

            def logged(contexts, budgets, _p=propose, _log=log):
                props = _p(contexts, budgets)
                _log.extend(zip([list(c) for c in contexts], props))
                return props

            draft.propose_batch = logged
        box = {}
        ck.reset_launches()
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, n)], params, cfg, dev, fused=True,
            engine_kw=engine_kw, requests=spec_requests(cfg.vocab_size),
            draft=draft,
            on_engines=lambda e: box.update(track=_track_spec(e[0])))
        launches = ck.launches()
        for r in reqs:
            if r.status.value != "finished_length" or len(r.output_ids) != 32:
                raise AssertionError(f"spec_serve {name} {r.request_id}: "
                                     f"{r.status.value}")
        summary = engines[0].kernel_dispatch_summary()
        want = gqa_expected("fused", summary, n)
        warm = dict(summary.get("graphs", {}).get("warmup_launches", {}))
        if draft is not None:
            dsum = draft.engine.kernel_dispatch_summary()
            dn = draft.engine.model.num_local_layers
            for k, v in gqa_expected("fused", dsum, dn).items():
                want[k] = want.get(k, 0) + v
            for k, v in dsum.get("graphs", {}).get(
                    "warmup_launches", {}).items():
                warm[k] = warm.get(k, 0) + v
        check_launches("spec_serve", name, launches, want,
                       {"graphs": {"warmup_launches": warm}})
        totals = summary["dispatch_total"]
        verify = sum(totals.get(f"{summary['prefill_impl']}/{path}", 0)
                     for path in ("spec", "spec_verify"))
        spec = engines[0].spec_summary()
        if engine_kw and engine_kw.get("speculative_tokens") and not (
                name.startswith("ngram") or spec["proposals"] > 0):
            raise AssertionError(f"spec_serve {name}: nothing proposed")
        if summary["cuda_graphs"] and "decode_lookahead" not in (
                engine_kw or {}):
            replays = summary["graphs"]["replays"]
            windows = (totals.get(f"{summary['impl']}/multistep", 0)
                       + totals.get(f"{summary['prefill_impl']}/spec", 0))
            if replays != windows:
                raise AssertionError(f"spec_serve {name}: {replays} "
                                     f"replays, {windows} window steps")
        worst, *_ = greedy_check(torch, model_full, params, reqs, sampled,
                                 dev, tol=GREEDY_TOL)
        track = box["track"]
        rows = {rid: {"accepted": a, "rejected": b,
                      "acceptance": round(a / (a + b), 4) if a + b else None}
                for rid, (a, b) in sorted(track["rows"].items())}
        fig = {
            "phase": "spec_serve", "run": name,
            "engine": engine_kw or "defaults",
            "draft_layers": draft_layers, "launches": launches,
            "spec": spec, "per_request": rows,
            "verify_forwards": verify,
            # Tokens a row commits a verify forward (1 = no proposal
            # accepted), and the batch's tokens a verify forward.
            "tokens_per_row_verify": (
                track["spec_tokens"] / track["row_steps"]
                if track["row_steps"] else None),
            "tokens_per_verify_forward": (
                track["spec_tokens"] / verify if verify else None),
            "dispatch": totals,
            "graph_replays": summary.get("graphs", {}).get("replays"),
            "largest_logit_gap": worst, "greedy_vs_plain": "pass",
            **stream_metrics(reqs, t0, t1), "card": card,
        }
        if draft is not None:
            fig["draft"] = {
                "rounds": draft.rounds, "propose_s": draft.propose_s,
                "share_of_wall": draft.propose_s / (t1 - t0),
                "dispatch": draft.engine.kernel_dispatch_summary()[
                    "dispatch_total"]}
            greedy_rows = [r.request_id for i, r in enumerate(reqs)
                           if i not in sampled]
            acc = sum(track["rows"].get(rid, [0, 0])[0]
                      for rid in greedy_rows)
            rej = sum(track["rows"].get(rid, [0, 0])[1]
                      for rid in greedy_rows)
            fig["greedy_acceptance"] = acc / (acc + rej) if acc + rej else None
            if draft_layers == "all":
                gaps = _draft_rejection_gaps(torch, model_full, params, reqs,
                                             sampled, log, dev)
                fig["draft_partings"] = gaps
                # The engine's acceptance also counts the proposal tail a
                # window keeps feeding after a parting (the buffer is read
                # at the produced count), so a near-tie early in a window
                # rejects the rest of it: the 90% bar holds the draft's
                # tokens on the committed stream's own prefix.
                if gaps["agreement"] is None or gaps["agreement"] < 0.9:
                    raise AssertionError(
                        f"spec_serve {name}: the draft agreed with the "
                        f"committed stream on {gaps['agreement']} of its "
                        f"tokens, under 0.9")
                if gaps["largest_gap"] >= GREEDY_TOL:
                    raise AssertionError(
                        f"spec_serve {name}: a draft proposal parted from "
                        f"the committed stream at a gap of "
                        f"{gaps['largest_gap']}")
        emit(fig)
        runs[name] = reqs
        figs[name] = fig
        del engines, draft
        free_device_memory(torch)
    # Speculation on against off, same run: the same tokens, or a parting
    # at a near-tie of the plain reference.
    for name, base in (("ngram", "off"), ("ngram_k1_sync", "off_k1_sync"),
                       ("draft_same_tree", "off"), ("draft_4_layers", "off")):
        if name not in runs or base not in runs:
            continue
        identical, partings = 0, []
        for a, b in zip(runs[name], runs[base]):
            if a.output_ids == b.output_ids:
                identical += 1
                continue
            p = _first_parting(torch, model_full, params, a, b, dev)
            partings.append({"request": a.request_id, **p})
            if p["gap"] >= GREEDY_TOL:
                raise AssertionError(
                    f"spec_serve {name}: {a.request_id} parts from {base} "
                    f"off a near-tie: {p}")
        emit({"phase": "spec_serve", "check": f"{name}_vs_{base}",
              "rows_identical": identical, "rows": len(runs[name]),
              "partings_at_near_ties": partings,
              "decode_tok_per_s": [figs[name]["decode_tok_per_s"],
                                   figs[base]["decode_tok_per_s"]],
              "ttft_s_median": [figs[name]["ttft_s_median"],
                                figs[base]["ttft_s_median"]]})
    FIGURES["spec_serve"] = {k: {x: v[x] for x in (
        "decode_tok_per_s", "ttft_s_median", "tokens_per_row_verify")}
        for k, v in figs.items()}


def _count_hops(engines) -> dict:
    """Count the pipeline's packets that carry speculation: head -> tail
    FORWARDs with ``spec_len`` and tail -> head runs with
    ``spec_accepted``."""
    hops = {"spec_len_packets": 0, "spec_len_tokens": 0,
            "spec_accepted_packets": 0, "spec_accepted_tokens": 0}
    for eng in engines:
        step = eng.step

        def counted(_step=step):
            out = _step()
            for f in out.forward:
                if f.spec_len:
                    hops["spec_len_packets"] += 1
                    hops["spec_len_tokens"] += f.spec_len
                if f.spec_accepted is not None:
                    hops["spec_accepted_packets"] += 1
                    hops["spec_accepted_tokens"] += len(f.spec_accepted)
            return out

        eng.step = counted
    return hops


def phase_pp_spec(torch, dev, card, cfg, model_full, params):
    """Pipeline speculation over serve's 14 + 14 pipeline in process:
    spec_serve's requests with speculation off, with n-gram P = 4 and with
    the 4-layer draft on the head. Greedy rows within GREEDY_TOL of the
    plain one-shot argmax, launches exact per stage (A2 14 x each stage's
    decode steps, A0 + A1 14 x its multi-token steps, the sampler on the
    tail), and the packets carrying ``spec_len`` / ``spec_accepted`` across
    the hop counted (the draft run must send both)."""
    from parallax_tpu_torch.ops import cuda_kernels as ck

    figs = {}
    for name, engine_kw, draft_layers in (
            ("off", None, None), ("ngram", dict(speculative_tokens=4), None),
            ("draft_4_layers", dict(speculative_tokens=4), 4)):
        draft = (make_draft(torch, dev, cfg, params, draft_layers)
                 if draft_layers else None)
        box = {}
        ck.reset_launches()
        reqs, sampled, engines, t0, t1 = serve(
            torch, [(0, 14), (14, 28)], params, cfg, dev, fused=True,
            engine_kw=engine_kw, requests=spec_requests(cfg.vocab_size),
            draft=draft,
            on_engines=lambda e: box.update(hops=_count_hops(e)))
        launches = ck.launches()
        for r in reqs:
            if r.status.value != "finished_length" or len(r.output_ids) != 32:
                raise AssertionError(f"pp_spec {name} {r.request_id}: "
                                     f"{r.status.value}")
        want, warm = {}, {}
        for eng in engines + ([draft.engine] if draft else []):
            s = eng.kernel_dispatch_summary()
            for k, v in gqa_expected(
                    "fused", s, eng.model.num_local_layers).items():
                want[k] = want.get(k, 0) + v
            for k, v in s.get("graphs", {}).get("warmup_launches",
                                                {}).items():
                warm[k] = warm.get(k, 0) + v
        check_launches("pp_spec", name, launches, want,
                       {"graphs": {"warmup_launches": warm}})
        worst, *_ = greedy_check(torch, model_full, params, reqs, sampled,
                                 dev, tol=GREEDY_TOL)
        hops = box["hops"]
        if draft_layers and not (hops["spec_len_packets"]
                                 and hops["spec_accepted_packets"]):
            raise AssertionError(f"pp_spec {name}: no speculation crossed "
                                 f"the hop ({hops})")
        tail = engines[-1]
        figs[name] = {
            "phase": "pp_spec", "run": name, "stages": [[0, 14], [14, 28]],
            "engine": engine_kw or "defaults", "hops": hops,
            "verify_rounds": tail.pp_spec_rounds,
            "verified_tokens": tail.pp_spec_tokens,
            "tokens_per_verify_round": (
                tail.pp_spec_tokens / tail.pp_spec_rounds
                if tail.pp_spec_rounds else None),
            "launches": launches, "largest_logit_gap": worst,
            "greedy_vs_plain": "pass",
            "dispatch": [e.kernel_dispatch_summary()["dispatch_total"]
                         for e in engines],
            **stream_metrics(reqs, t0, t1), "card": card}
        if draft is not None:
            figs[name]["draft"] = {"rounds": draft.rounds,
                                   "propose_s": draft.propose_s,
                                   "share_of_wall":
                                   draft.propose_s / (t1 - t0)}
        emit(figs[name])
        del engines, draft
        free_device_memory(torch)
    FIGURES["pp_spec"] = {k: {x: v[x] for x in (
        "decode_tok_per_s", "ttft_s_median", "tokens_per_verify_round")}
        for k, v in figs.items()}


# Phases that run only when ``--only`` names them (the whole script's time
# limit).
OPT_IN_PHASES = ("moe_profile", "mla_profile", "dsa_profile",
                 "gptoss_profile")

KERNEL_PATH = {
    "kv_append": "moe_serve", "gqa_prefill": "moe_serve",
    "gqa_decode": "moe_serve", "sample_topk": "moe_serve",
    "grouped_gemm": "moe_serve", "mla_decode": "mla_serve/fused",
    "mla_attend": "mla_serve/split", "indexer_fused": "dsa_serve/fused",
    "indexer_scores": "dsa_serve/split",
    "gqa_attend": "gptoss_serve/split", "ragged_attend": "serve/split",
    "gumbel_rows": "serve/fused", "quant_linear": "quant_serve",
    "grouped_gemm_q": "moe_serve/int8",
    # Head dim 256: Qwen3-Next's full-attention layers. A9 takes no D 256
    # row on a served path (Qwen3-Next has no sinks): its entry reports
    # the kernel's launches on its own path.
    "kv_append@d256": "next_serve/fused", "gqa_prefill@d256":
    "next_serve/fused", "gqa_decode@d256": "next_serve/fused",
    "ragged_attend@d256": "next_serve/split",
    "gqa_attend@d256": "gptoss_serve/split",
}
# The launch counter of an entry that is not a kernel of its own: K9's
# route is A1 (gqa_prefill) in attend-only mode; a shape's entry
# (``<kernel>@<shape>``) counts its kernel's launches.
KERNEL_COUNTER = {"ragged_attend": "gqa_prefill",
                  "ragged_attend@d256": "gqa_prefill"}


# The phases on the Qwen2.5-7B tree after serve, pipeline and profile, in
# order; the first one asked for names the tree's line when serve is not.
DENSE_PHASES = ("native", "spec_serve", "pp_spec", "features_serve",
                "preempt_serve", "migrate_serve",
                "disagg_serve", "qos_serve", "quant_serve", "lora_serve",
                "http_serve",
                "swarm_serve",
                "sched_serve", "refit_serve", "ha_serve", "relay_serve",
                "obs_serve")


# -- qos_serve: the QoS plane, the router and the chaos harness ----------------

# (a) the library run: a batch flood fills the batch (max_batch_size 7) on
# a QOS_PAGES pool with a QOS_HOST_BYTES tier, then the interactive rows
# arrive; QoS off, QoS on ("on": the interactive budget 1000 ms, so the
# queue-pressure trigger fires once an interactive row has waited 500 ms
# for a slot), and QoS on over the native manager (no tier).
QOS_FLOOD = 7
QOS_FLOOD_NEW = 192
QOS_INTERACTIVE = 2
QOS_INTERACTIVE_NEW = 32
QOS_PAGES = 96
QOS_HOST_BYTES = 4 << 30
# (c) the autoscaler's swarm: one prefill and two decode workers, each
# with a 1 GiB tier; two chatty sessions, then a burst of interactive
# prompts (QOS_BURST_IDS ids, one new token: each finishes at the prefill
# head) submitted back to back until the re-role, at most QOS_BURST_MAX.
QOS_CHATTY_NEW = 256
QOS_BURST_IDS = 900
QOS_BURST_MAX = 96
QOS_SWARM_HOST_BYTES = 1 << 30
QOS_KV_DROPS = 2
# (c)'s ``run --qos`` spec. A 28-layer pipeline on the H100 counts 233
# requests of capacity (the node model's KV budget at 2,048-token
# contexts), so util_high 0.01 calls the prefill pool starved once three
# prompts wait there, and a decode pool under half its capacity is idle;
# the loop looks every 0.5 s, and the cooldown allows one re-role a run.
QOS_AUTOSCALE_SPEC = ("autoscale=1,autoscale_interval_s=0.5,"
                      "autoscale_cooldown_s=600,autoscale_util_high=0.01,"
                      "autoscale_util_low=0.5")
# (b) serve --qos on behind the router: each replica's KV fraction.
QOS_KV_FRACTION = 0.1


def qos_mix(vocab: int):
    """QOS_FLOOD batch rows (greedy and seeded in turn) and QOS_INTERACTIVE
    interactive rows (one greedy, one seeded)."""
    import random

    from parallax_tpu_torch.runtime.request import Request, SamplingParams

    rng = random.Random(4242)
    flood, inter = [], []
    for i in range(QOS_FLOOD):
        seeded = i % 2 == 1
        flood.append(Request(
            f"b{i}", prompt_ids=[rng.randrange(1, vocab)
                                 for _ in range(128 + 40 * i)],
            qos_class="batch",
            sampling_params=SamplingParams(
                temperature=0.8 if seeded else 0.0,
                top_k=20 if seeded else 0, seed=31 + i if seeded else None,
                max_new_tokens=QOS_FLOOD_NEW, ignore_eos=True)))
    for i in range(QOS_INTERACTIVE):
        seeded = i == 1
        inter.append(Request(
            f"i{i}", prompt_ids=[rng.randrange(1, vocab)
                                 for _ in range(96)],
            qos_class="interactive",
            sampling_params=SamplingParams(
                temperature=0.7 if seeded else 0.0,
                top_k=8 if seeded else 0, seed=97 if seeded else None,
                max_new_tokens=QOS_INTERACTIVE_NEW, ignore_eos=True)))
    return flood, inter


def qos_library_run(torch, dev, cfg, params, qos, native: bool) -> dict:
    """One run of (a): the flood decodes, then the interactive rows arrive;
    everything to completion on the one-in-flight loop with the engine's
    defaults (K = 8 windows replayed from CUDA graphs). Returns the
    streams, the requests, the launches, the dispatch summary, the QoS
    payload, the cache counters, the host ms of each park and resume and
    the controller's transition times."""
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.runtime.engine import StageEngine, drive_step

    n = cfg.num_hidden_layers
    engine = StageEngine(
        create_stage_model(cfg, 0, n), params,
        engine_config(True, num_pages=QOS_PAGES, qos=qos,
                      host_cache_bytes=0 if native else QOS_HOST_BYTES),
        device=dev, use_native=native)
    if native != (type(engine.cache).__name__ == "NativeCacheManager"):
        raise AssertionError(f"qos_serve: cache manager "
                             f"{type(engine.cache).__name__}")
    swaps = {"preempt": [], "resume": []}
    if not native:
        _timed(engine.cache, "preempt_to_host", swaps["preempt"])
        _timed(engine.cache, "resume_from_host", swaps["resume"])
    transitions = []
    pol = engine.scheduler.qos
    if pol is not None:
        tick = pol.controller.tick

        def timed_tick(now=None):
            changed = tick(now)
            if changed:
                transitions.append((time.monotonic(),
                                    pol.controller.shedding))
            return changed

        pol.controller.tick = timed_tick
    flood, inter = qos_mix(cfg.vocab_size)
    _sync(torch, dev)
    ck.reset_launches()
    t0 = time.monotonic()
    for r in flood:
        r.arrival_time = t0
        engine.submit(r)
    pending = None
    while not all(len(r.output_ids) >= 8 for r in flood):
        _, pending = drive_step(engine, pending)
    t_inter = time.monotonic()
    for r in inter:
        r.arrival_time = t_inter
        engine.submit(r)
    while engine.has_work() or pending is not None:
        _, pending = drive_step(engine, pending)
    _sync(torch, dev)
    t1 = time.monotonic()
    reqs = flood + inter
    bad = [(r.request_id, r.status.value, len(r.output_ids)) for r in reqs
           if r.status.value != "finished_length"
           or len(r.output_ids) != r.sampling_params.max_new_tokens]
    if bad:
        raise AssertionError(f"qos_serve (a): unfinished or aborted {bad}")
    out = {
        "streams": {r.request_id: list(r.output_ids) for r in reqs},
        "reqs": reqs, "launches": ck.launches(),
        "summary": engine.kernel_dispatch_summary(),
        "qos": pol.payload() if pol is not None else None,
        "cache": engine.cache_stats(),
        "park_ms": [s * 1e3 for s, ok in swaps["preempt"] if ok],
        "resume_ms": [s * 1e3 for s, ok in swaps["resume"] if ok],
        "transitions": [(t - t_inter, shed) for t, shed in transitions],
        "interactive_ttft_ms": {
            r.request_id: (r.first_token_time - t_inter) * 1e3
            for r in inter},
        "wall_s": t1 - t0,
        "warned_no_tier": pol._warned_no_tier if pol is not None else None,
    }
    del engine
    free_device_memory(torch)
    return out


def qos_library(torch, dev, card, cfg, params) -> None:
    """(a): QoS off, QoS on and QoS on over the native manager; streams
    bitwise equal across the three, no abort, parks above 0 with every
    parked row resumed (on), none on the native manager, which only holds
    admissions and warns once; launches exact in each."""
    n = cfg.num_hidden_layers
    runs = {}
    for name, qos, native in (("off", None, False), ("on", "on", False),
                              ("native_on", "on", True)):
        run = qos_library_run(torch, dev, cfg, params, qos, native)
        check_launches("qos_serve", name, run["launches"],
                       gqa_expected("fused", run["summary"], n),
                       run["summary"])
        check_windows("qos_serve", name, run["summary"], graphs=True)
        runs[name] = run
    off = runs["off"]["streams"]
    for name in ("on", "native_on"):
        if runs[name]["streams"] != off:
            diff = sorted(rid for rid in off
                          if runs[name]["streams"][rid] != off[rid])
            raise AssertionError(f"qos_serve (a) {name}: streams differ "
                                 f"from QoS off in {diff}")
    on, native = runs["on"], runs["native_on"]
    parked = sum(on["qos"]["counters"]["parked"].values())
    held = sum(on["qos"]["counters"]["shed_held"].values())
    adm = on["qos"]["admission"]
    if parked <= 0 or on["cache"]["resumes"] < parked \
            or adm["sheds"] < 1 or adm["releases"] < 1 or held < parked:
        raise AssertionError(f"qos_serve (a) on: parks {parked}, "
                             f"{on['cache']}, {adm}")
    nat = native["qos"]
    if sum(nat["counters"]["parked"].values()) or \
            nat["admission"]["sheds"] < 1 or not native["warned_no_tier"]:
        raise AssertionError(f"qos_serve (a) native: {nat}")
    shed_at = [t for t, s in on["transitions"] if s]
    release_at = [t for t, s in on["transitions"] if not s]
    for name, run in runs.items():
        emit({"phase": "qos_serve", "part": "a", "run": name,
              "engine": "defaults", "num_pages": QOS_PAGES,
              "host_cache_bytes": 0 if name == "native_on"
              else QOS_HOST_BYTES,
              "flood": f"{QOS_FLOOD} batch rows x {QOS_FLOOD_NEW} new",
              "interactive": f"{QOS_INTERACTIVE} rows x "
                             f"{QOS_INTERACTIVE_NEW} new",
              "interactive_ttft_ms": run["interactive_ttft_ms"],
              "streams_equal_to_qos_off": True, "aborts": 0,
              "qos_counters": (run["qos"] or {}).get("counters"),
              "admission": (run["qos"] or {}).get("admission"),
              "preemptions": run["cache"].get("preemptions"),
              "resumes": run["cache"].get("resumes"),
              "park_ms": run["park_ms"], "resume_ms": run["resume_ms"],
              "launches": run["launches"], "wall_s": run["wall_s"],
              "card": card})
    figures = {
        "interactive_ttft_ms_off": _max_ttft(runs["off"]),
        "interactive_ttft_ms_on": _max_ttft(on),
        "parks": parked, "sheds": adm["sheds"],
        "shed_s_after_arrival": shed_at[0] if shed_at else None,
        "release_s_after_shed": (release_at[0] - shed_at[0])
        if shed_at and release_at else None,
        "park_ms_median": statistics.median(on["park_ms"]),
        "resume_ms_median": statistics.median(on["resume_ms"]),
    }
    emit({"phase": "qos_serve", "part": "a", "figures": figures,
          "card": card})


def _max_ttft(run) -> float:
    return max(run["interactive_ttft_ms"].values())


def qos_swarm(torch, dev, card, cfg, params) -> None:
    """(c): ``run --qos autoscale=1``'s scheduler in this process (its
    GlobalScheduler and SchedulerService on TCP loopback) with three
    28-layer workers joined with ``--qos on``: one prefill and two decode
    (the autoscaler never empties a pool, so a pair could not re-role).
    The workers share ``params``. The port's ChaosController wraps every
    transport, delays each KV frame and drops a few. Two chatty
    interactive sessions are handed off, one to each decode pipeline;
    then a burst of interactive prompts starves the prefill pool, the autoscaler re-roles a decode pipeline to prefill, its worker
    adopts the role from a heartbeat reply (same engine, no reload) and
    drains its session through the handoff; every request finishes, none
    aborts, and ``cluster_status``'s ``qos`` section records the
    re-role."""
    import random
    import threading

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.backend.scheduler_service import SchedulerService
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.p2p import proto
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.qos import parse_qos_spec
    from parallax_tpu_torch.runtime.request import Request, SamplingParams
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
    from parallax_tpu_torch.testing.chaos import ChaosController

    chaos = ChaosController(seed=7)
    qos = parse_qos_spec(QOS_AUTOSCALE_SPEC)
    sched = GlobalScheduler(cfg, min_nodes_bootstrapping=3,
                            routing="cache_aware", qos=qos)
    sched.allocator.should_global_rebalance = (
        lambda active, cv_threshold=0.5: False)
    service = SchedulerService(
        sched, chaos.wrap(TcpTransport("scheduler", "127.0.0.1")),
        join_timeout_s=SWARM_TIMEOUT_S)
    roles = ["prefill", "decode", "decode"]
    workers = []
    rng = random.Random(99)
    try:
        service.start()
        workers = [_disagg_worker(cfg, params, dev,
                                  service.transport.address, role, chaos,
                                  heartbeat_s=0.25, qos="on",
                                  host_cache_bytes=QOS_SWARM_HOST_BYTES)
                   for role in roles]
        threads = [threading.Thread(target=w.start, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SWARM_TIMEOUT_S)
        deadline = time.monotonic() + SWARM_TIMEOUT_S
        _wait_for(lambda: len(sched.manager.pipelines) == 3 and all(
            x[2] for x in _sched_nodes(sched.cluster_status())),
            deadline, "no three ready pipelines", "qos_serve (c)")
        engines = [w.engine for w in workers]
        # The first QOS_KV_DROPS KV frames are lost, so their transfers
        # fail over to the checkpoint-only rung; every other one pays 5 ms
        # (a frame takes the first rule that matches it).
        drops = chaos.drop_frames(method=proto.KV_TRANSFER,
                                  limit=QOS_KV_DROPS)
        chaos.delay_frames(0.005, method=proto.KV_TRANSFER)
        client = SwarmClient(service.transport, service)
        ck.reset_launches()

        def request(rid, n_prompt, new, seed=None):
            return Request(
                rid, prompt_ids=[rng.randrange(1, cfg.vocab_size)
                                 for _ in range(n_prompt)],
                qos_class="interactive",
                sampling_params=SamplingParams(
                    temperature=0.0 if seed is None else 0.8,
                    top_k=0 if seed is None else 20, seed=seed,
                    max_new_tokens=new, ignore_eos=True))

        def submit(r):
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids,
                                           qos_class=r.qos_class)
            if not r.routing_table:
                raise AssertionError(f"qos_serve (c): no route for "
                                     f"{r.request_id}")
            return client.submit(r)

        chatty, events = [], []
        for i in range(2):
            r = request(f"chat{i}", 200, QOS_CHATTY_NEW,
                        seed=(None, 71)[i])
            chatty.append(r)
            events.append(submit(r))
            _wait_for(lambda i=i: sum(
                w.handoff_stats.handoffs.get("kv_image", 0)
                + w.handoff_stats.handoffs.get("reprefill", 0)
                for w in workers[1:]) >= i + 1,
                time.monotonic() + SWARM_TIMEOUT_S,
                f"chat{i} never handed off", "qos_serve (c)")
            if i == 0:
                # The handoff's target is scored on heartbeat-fed loads,
                # and a heartbeat sent before the target admitted chat0
                # resets the dispatch's charge: chat1 goes out once the
                # heartbeats after the admission (three of the workers'
                # 0.25 s) carried chat0's load.
                _wait_for(lambda: sum(w.engine.scheduler.num_requests()
                                      for w in workers[1:]) == 1,
                          time.monotonic() + SWARM_TIMEOUT_S,
                          "chat0 never admitted", "qos_serve (c)")
                time.sleep(0.75)
                _wait_for(lambda: sorted(
                    sched.manager.get(w.node_id).load
                    for w in workers[1:]) == [0, 1],
                    time.monotonic() + SWARM_TIMEOUT_S,
                    "chat0's load never reached the scheduler",
                    "qos_serve (c)")
        loads = sorted(w.engine.scheduler.num_requests()
                       for w in workers[1:])
        if loads != [1, 1]:
            raise AssertionError(f"qos_serve (c): decode loads {loads}")
        burst, burst_events, flood_error = [], [], []
        stop_burst = threading.Event()

        def flood():
            try:
                while not stop_burst.is_set() and len(burst) < QOS_BURST_MAX:
                    r = request(f"burst{len(burst)}", QOS_BURST_IDS, 1)
                    burst_events.append(submit(r))
                    burst.append(r)
            except Exception as e:   # re-raised on the phase's thread
                flood_error.append(e)

        t_burst = time.monotonic()
        flooder = threading.Thread(target=flood, daemon=True)
        flooder.start()
        peak = {}

        def rerole() -> bool:
            from parallax_tpu_torch.qos.autoscaler import pool_report

            for role, pool in pool_report(sched.manager.pipelines).items():
                peak[role] = max(peak.get(role, 0.0), pool["utilization"])
            return sched.autoscaler.stats["reroles"] >= 1 or bool(
                flood_error)

        try:
            deadline = time.monotonic() + 60.0
            while not rerole():
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"qos_serve (c): no re-role: peak utilization "
                        f"{peak}, {len(burst)} prompts, autoscaler "
                        f"{sched.autoscaler.stats}, config "
                        f"{sched.autoscaler.config}")
                time.sleep(0.05)
        finally:
            stop_burst.set()
            flooder.join(SWARM_TIMEOUT_S)
        if flood_error:
            raise flood_error[0]
        t_rerole = time.monotonic()
        events += burst_events
        _wait_for(lambda: sum(w.role == "prefill" for w in workers) == 2,
                  time.monotonic() + 60.0, "the role never reached the "
                  "worker", "qos_serve (c)")
        t_adopt = time.monotonic()
        moved = next(w for w in workers[1:] if w.role == "prefill")
        _wait_for(lambda: moved.engine.scheduler.num_requests() == 0,
                  time.monotonic() + SWARM_TIMEOUT_S,
                  "the re-roled worker never drained", "qos_serve (c)")
        t_drained = time.monotonic()
        for r, ev in zip(chatty + burst, events):
            if not ev.wait(SWARM_TIMEOUT_S):
                raise AssertionError(f"qos_serve (c) {r.request_id}: "
                                     f"{r.status.value}")
        reqs = chatty + burst
        bad = [(r.request_id, r.status.value, len(r.output_ids))
               for r in reqs if r.status.value != "finished_length"
               or len(r.output_ids) != r.sampling_params.max_new_tokens]
        if bad:
            raise AssertionError(f"qos_serve (c): {bad}")
        if [w.engine for w in workers] != engines:
            raise AssertionError("qos_serve (c): a worker reloaded")
        fallbacks = sum(w.handoff_stats.fallbacks.get("transfer_failed", 0)
                        for w in workers)
        if drops.hits != QOS_KV_DROPS or fallbacks < 1:
            raise AssertionError(f"qos_serve (c): {drops.hits} KV frames "
                                 f"dropped, {fallbacks} transfers failed "
                                 f"over")
        status = sched.cluster_status()
        auto = status["qos"]["autoscaler"]
        if auto["reroles"] != 1 or auto["last_action"]["direction"] != \
                "decode->prefill" or sorted(
                    p["role"] for p in status["pipelines"]) != [
                        "decode", "prefill", "prefill"]:
            raise AssertionError(f"qos_serve (c): {status['qos']}")
        launches = ck.launches()
        for k in ("kv_append", "gqa_prefill", "gqa_decode"):
            if launches[k] <= 0:
                raise AssertionError(f"qos_serve (c): no {k} launch")
        out = {
            "phase": "qos_serve", "part": "c",
            "workers": "prefill + 2 decode, 28 layers each, shared weights",
            "qos_spec": QOS_AUTOSCALE_SPEC,
            "requests": len(reqs), "aborts": 0,
            "chatty": f"2 x {QOS_CHATTY_NEW} new",
            "burst": f"{len(burst)} prompts x {QOS_BURST_IDS} ids, 1 new",
            "rerole_s_after_burst": t_rerole - t_burst,
            "adopted_s_after_rerole": t_adopt - t_rerole,
            "drained_s_after_adopt": t_drained - t_adopt,
            "autoscaler": auto, "admission": status["qos"]["admission"],
            "chaos": dict(chaos.stats), "kv_frames_dropped": drops.hits,
            "handoffs": [w.handoff_stats.snapshot() for w in workers],
            "launches": launches, "card": card,
        }
    finally:
        for w in workers:
            w.stop()
            w.engine = None
        service.stop()
    emit(out)


def phase_qos_serve(torch, dev, card, cfg, params) -> None:
    """qos_serve's library run (a) and swarm (c) on serve's tree; (b) runs
    with http_serve's checkpoint (``qos_http``)."""
    t0 = time.monotonic()
    qos_library(torch, dev, card, cfg, params)
    qos_swarm(torch, dev, card, cfg, params)
    free_device_memory(torch)
    emit({"phase": "qos_serve", "parts": "a, c",
          "seconds": time.monotonic() - t0, "card": card})


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _qos_call(port: int, path: str, body: dict | None = None,
              headers: dict | None = None, method: str = "POST"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t = time.perf_counter()
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, (time.perf_counter() - t) * 1e3
    finally:
        conn.close()


def qos_http(torch, dev, card, ckpt: str) -> None:
    """(b): two ``serve --qos on`` processes on the card (each its own KV
    fraction) and ``python -m parallax_tpu_torch.router.lb --strategy
    session_affinity`` in front. A bad ``x-parallax-deadline-ms`` answers
    400 through the router; a session key stays on its replica; both
    replicas' EMAs show in ``/router/status``; the router's added ms a
    request (the same request direct and through it, alternating); then
    one replica is killed and, once the probe has seen it, every request
    (a stream too) answers 200 from the other."""
    import os
    import signal
    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo}
    ports = [_free_port() for _ in range(3)]
    logs = [tempfile.NamedTemporaryFile("w+", suffix=".log", delete=False)
            for _ in range(3)]
    procs = []
    body = {"prompt": "Tell me about the sea", "max_tokens": 16,
            "temperature": 0, "ignore_eos": True}
    t0 = time.monotonic()
    try:
        for port, log in zip(ports[:2], logs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "parallax_tpu_torch", "serve",
                 "--model-path", ckpt, "--device", str(dev), "--host",
                 "127.0.0.1", "--port", str(port), "--qos", "on",
                 "--kv-utilization", str(QOS_KV_FRACTION),
                 "--max-batch-size", "7", "--page-size", "64",
                 "--max-model-len", "1024"],
                cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT))
        urls = [f"http://127.0.0.1:{p}" for p in ports[:2]]
        deadline = time.monotonic() + HTTP_TIMEOUT_S

        def replicas_up():
            if any(p.poll() is not None for p in procs):
                raise AssertionError("qos_serve (b): a replica exited")
            try:
                return all(_qos_call(p, "/cluster/status_json",
                                     method="GET")[0] == 200
                           for p in ports[:2])
            except OSError:
                return False

        # The router probes at its start and then every 10 s (its
        # default): started once both replicas answer, its first probe
        # sees them.
        _wait_for(replicas_up, deadline, "the replicas never came up",
                  "qos_serve (b)")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "parallax_tpu_torch.router.lb",
             "--endpoints", *urls, "--strategy", "session_affinity",
             "--host", "127.0.0.1", "--port", str(ports[2])],
            cwd=repo, env=env, stdout=logs[2], stderr=subprocess.STDOUT))
        router = ports[2]

        def router_status():
            try:
                status, data, _ms = _qos_call(router, "/router/status",
                                              method="GET")
            except OSError:
                return None
            return json.loads(data) if status == 200 else None

        def healthy():
            if any(p.poll() is not None for p in procs):
                raise AssertionError("qos_serve (b): a process exited")
            st = router_status()
            return st is not None and sum(
                e["healthy"] for e in st["endpoints"]) == 2

        _wait_for(healthy, deadline, "the replicas never turned healthy",
                  "qos_serve (b)")
        startup_s = time.monotonic() - t0
        status, data, _ = _qos_call(router, "/v1/completions", body,
                                    {"x-parallax-deadline-ms": "soon"})
        if status != 400 or b"invalid QoS parameter" not in data:
            raise AssertionError(f"qos_serve (b): bad deadline {status} "
                                 f"{data[:200]!r}")

        def served_by():
            st = router_status()
            return {e["url"]: e["total_requests"] for e in st["endpoints"]}

        before = served_by()
        for _ in range(4):
            status, _, _ = _qos_call(router, "/v1/completions", body,
                                     {"x-session-id": "alice",
                                      "x-parallax-qos-class":
                                      "interactive"})
            if status != 200:
                raise AssertionError(f"qos_serve (b): {status}")
        after = served_by()
        moved = sorted(after[u] - before[u] for u in urls)
        if moved != [0, 4]:
            raise AssertionError(f"qos_serve (b): alice spread {moved}")
        pinned = next(u for u in urls if after[u] - before[u] == 4)
        keys = [f"user-{i}" for i in range(12)]
        for key in keys:
            status, _, _ = _qos_call(router, "/v1/completions", body,
                                     {"x-session-id": key,
                                      "x-parallax-qos-class": "batch"})
            if status != 200:
                raise AssertionError(f"qos_serve (b): {key} {status}")
        st = router_status()
        if not all(e["ema_tpot_s"] is not None and e["total_requests"] > 0
                   for e in st["endpoints"]):
            raise AssertionError(f"qos_serve (b): {st}")
        # The router's added ms: alice's request direct to her replica and
        # through the router, alternating.
        pin_port = ports[urls.index(pinned)]
        direct, via = [], []
        for _ in range(6):
            direct.append(_qos_call(pin_port, "/v1/completions", body)[2])
            via.append(_qos_call(router, "/v1/completions", body,
                                 {"x-session-id": "alice"})[2])
        # Kill the replica alice is pinned to, hard.
        victim = urls.index(pinned)
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(30)
        t_kill = time.monotonic()
        _wait_for(lambda: not next(
            e for e in router_status()["endpoints"]
            if e["url"] == pinned)["healthy"],
            time.monotonic() + 30.0, "the probe never saw the kill",
            "qos_serve (b)")
        seen_s = time.monotonic() - t_kill
        codes = [_qos_call(router, "/v1/completions", body,
                           {"x-session-id": key})[0]
                 for key in ["alice"] + keys]
        stream = _qos_call(router, "/v1/completions",
                           dict(body, stream=True),
                           {"x-session-id": "alice"})
        if codes != [200] * len(codes) or stream[0] != 200 \
                or b"[DONE]" not in stream[1]:
            raise AssertionError(f"qos_serve (b): after the kill {codes}, "
                                 f"stream {stream[0]}")
        out = {"phase": "qos_serve", "part": "b",
               "replicas": 2, "kv_fraction": QOS_KV_FRACTION,
               "startup_s": startup_s, "bad_deadline": 400,
               "session_alice_on_one_replica": True,
               "requests_per_replica": served_by(),
               "router_status": st["endpoints"],
               "direct_ms_median": statistics.median(direct),
               "via_router_ms_median": statistics.median(via),
               "router_added_ms_median": statistics.median(
                   [v - d for v, d in zip(via, direct)]),
               "probe_saw_kill_s": seen_s,
               "after_kill": {"requests": len(codes), "non_200": 0,
                              "stream": 200},
               "card": card}
    except Exception:
        for log in logs:
            log.seek(0)
            tail = log.read()[-3000:]
            print(f"qos_serve (b) log {log.name}:\n{tail}", file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(SWARM_EXIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)
        for log in logs:
            log.close()
            os.unlink(log.name)
    emit(out)


def run_dense(torch, dev, card: str, want) -> dict:
    """Phases 4-7 on Qwen2.5-7B; its tensors die with this frame (the
    http_serve phase drops the random tree once its checkpoint loaded
    back). Returns the split and fused serve runs' launches."""
    serving = any(want(p) for p in ("serve", "pipeline", "profile"))
    cfg, model_full, params = dense_tree(torch, dev, "serve" if serving else
                                         next(p for p in DENSE_PHASES
                                              if want(p)))
    paths = {}
    if serving:
        single, sampled, launches = phase_serve(torch, dev, card, cfg,
                                                model_full, params)
        paths = {"serve/split": launches["split"],
                 "serve/fused": launches["fused"]}
        if want("pipeline"):
            phase_pipeline(torch, dev, cfg, model_full, params, single,
                           sampled)
        if want("profile"):
            phase_profile(torch, dev, cfg, params)
    if want("native"):
        phase_native(torch, dev, card, cfg, model_full, params)
    if want("spec_serve"):
        phase_spec_serve(torch, dev, card, cfg, model_full, params)
    if want("pp_spec"):
        phase_pp_spec(torch, dev, card, cfg, model_full, params)
    if want("features_serve"):
        phase_features_serve(torch, dev, card, cfg, model_full, params)
    if want("preempt_serve"):
        phase_preempt_serve(torch, dev, card, cfg, model_full, params)
        free_device_memory(torch)
    if want("migrate_serve"):
        phase_migrate_serve(torch, dev, card, cfg, model_full, params)
        free_device_memory(torch)
    if want("disagg_serve"):
        phase_disagg_serve(torch, dev, card, cfg, model_full, params)
        free_device_memory(torch)
    if want("qos_serve"):
        phase_qos_serve(torch, dev, card, cfg, params)
    if want("quant_serve"):
        paths["quant_serve"] = phase_quant_serve(torch, dev, card, cfg,
                                                 model_full, params)
    if want("lora_serve"):
        phase_lora_serve(torch, dev, card, cfg, model_full, params)
    if any(want(p) for p in ("http_serve", "swarm_serve", "sched_serve",
                             "refit_serve", "ha_serve", "relay_serve",
                             "obs_serve", "qos_serve", "quant_serve",
                             "lora_serve")):
        from parallax_tpu_torch.config import normalize_config
        from parallax_tpu_torch.models.presets import PRESETS

        # The checkpoint phases' cut: the first CKPT_LAYERS layers (views).
        cfg = normalize_config(dict(PRESETS[DENSE_MODEL],
                                    num_hidden_layers=CKPT_LAYERS),
                               model_name=DENSE_MODEL)
        tree = [_draft_tree(params, CKPT_LAYERS)]
        del params
        phase_http_serve(torch, dev, card, cfg, tree,
                         swarm=want("swarm_serve"), sched=want("sched_serve"),
                         ha=want("ha_serve"), relay=want("relay_serve"),
                         obs=want("obs_serve"), qos=want("qos_serve"),
                         quant=want("quant_serve"),
                         lora=want("lora_serve"),
                         refit=want("refit_serve"))
    return paths


def free_device_memory(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated phases (build,kernels,serve,"
                         "pipeline,profile,native,spec_serve,pp_spec,"
                         "features_serve,preempt_serve,"
                         "migrate_serve,disagg_serve,quant_serve and "
                         "lora_serve (each runs http_serve too),"
                         "http_serve,"
                         "swarm_serve, sched_serve, ha_serve, relay_serve, "
                         "obs_serve and qos_serve (each runs http_serve "
                         "too), refit_serve (runs http_serve and "
                         "sched_serve too),"
                         "moe_serve,"
                         "moe_profile,"
                         "mla_serve,mla_profile,dsa_serve,dsa_profile,"
                         "gptoss_serve,gptoss_profile,msa_serve,m2_serve,"
                         "next_serve,zoo_serve); prints no result line")
    ap.add_argument("--host-ms", metavar="LABEL",
                    help="measure the serving loop's host ms a visit on "
                         "this script's tree and print one line (see "
                         "host_ms_main)")
    ap.add_argument("--disagg-worker", nargs=2,
                    metavar=("ROLE", "SCHEDULER"),
                    help="run one worker of disagg_serve's process pair "
                         "(the phase spawns it)")
    args = ap.parse_args()
    if args.host_ms:
        return host_ms_main(args.host_ms)
    if args.disagg_worker:
        return disagg_worker_main(*args.disagg_worker)
    only = set(filter(None, args.only.split(",")))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import parallax_tpu_torch  # noqa: F401  (fails outside the repo)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    def want(p):
        if p in OPT_IN_PHASES:
            return p in only
        return not only or p in only

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "env", "card": card,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.monotonic()
    ck.build(verbose="build" in only)
    nvcc_s = ck.last_build_seconds
    ck.lib()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "nvcc_seconds": round(nvcc_s, 3)})

    kernels = phase_kernels(torch, dev) if want("kernels") else None
    free_device_memory(torch)
    paths = {}
    if any(want(p) for p in ("serve", "pipeline", "profile") + DENSE_PHASES):
        paths.update(run_dense(torch, dev, card, want))
    # Qwen2.5-7B's tensors (about 15 GB) are gone before the MoE model's
    # 61 GB are made.
    free_device_memory(torch)
    if want("moe_serve") or want("moe_profile"):
        paths["moe_serve"], paths["moe_serve/int8"] = phase_moe_serve(
            torch, dev, card, want)
    # Qwen3-30B-A3B's 61 GB are gone before DeepSeek's 53 GB are made.
    free_device_memory(torch)
    if any(want(p) for p in ("mla_serve", "mla_profile", "dsa_serve",
                             "dsa_profile")):
        paths.update(run_deepseek(torch, dev, card, want))
    # DeepSeek's 53 GB are gone before gpt-oss-20b's 42 GB are made.
    free_device_memory(torch)
    if want("gptoss_serve") or want("gptoss_profile"):
        paths.update(run_gptoss(torch, dev, card, want))
    # gpt-oss-20b's 42 GB are gone before MiniMax-M3's 32 GB are made.
    free_device_memory(torch)
    if want("msa_serve") or want("m2_serve"):
        paths.update(run_minimax(torch, dev, card, want))
    free_device_memory(torch)
    if want("next_serve"):
        paths.update(phase_next_serve(torch, dev, card))
    free_device_memory(torch)
    if want("zoo_serve"):
        paths.update(phase_zoo_serve(torch, dev, card))
    if only:
        return 0
    for k in kernels:
        counter = KERNEL_COUNTER.get(k["name"], k["name"].split("@")[0])
        k["launches"] = paths[KERNEL_PATH[k["name"]]][counter]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: not launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: e[k] for k in keys} for e in kernels]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
