"""GPU smoke run of the PyTorch/CUDA port (``ray_dynamic_batching_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — ``nvcc`` builds the kernels from ``csrc/`` (one process
   each, in parallel);
3. kernels — each kernel against its plain PyTorch version at the main
   paths' shapes, in bf16 and f32 (the paged kernel also at a Tq = 4
   staircase window in f32; flash also at a paged chunk deep in a long
   prompt, q [2, 64, 32, 128] over 512 positions with 3 and 5 live KV
   tiles, and at the unmasked attention of ViT-B/16, q/k/v [64, 197, 12,
   64], and of ViT-G/14, [32, 257, 16, 104] (head_dim 104), each fed as
   the model feeds it: views of one packed qkv projection, read in place;
   their bounds count q, k, v and out once; the slab decode kernel also
   at the speculative verify window, q [16, 5, 32, 128] over k/v
   [16, 512, 8, 128] (llama3_8b: 20 window rows a KV head) and q
   [64, 5, 16, 64] over [64, 256, 16, 64] (gpt2_medium), with the
   staircase mask ``verify_step`` builds; the paged kernel at q
   [16, 5, 32, 128] over the 64-page pool, each slot 1-4 positions short
   of a page boundary with one scratch page past its owned run), and
   the int8-KV branch of both decode kernels (int8 codes +
   f32 scales, q in bf16 and f32): max abs error against the stated
   tolerance, median CUDA-event times of kernel / plain version / a
   PyTorch yardstick never used by the port (one
   ``F.scaled_dot_product_attention`` call for flash and slab decode;
   gather + SDPA, 3 calls, for the paged kernel; dequantize + SDPA, 3
   calls, and gather + dequantize + SDPA, 7 calls, for the int8
   branches), and the bound from bytes and FLOPs over what the call's
   data needs: the K/V of the positions some window row attends (kernels
   1 and 2 skip the 64-key tiles no row attends; kernel 3 the tiles past
   each length). The masked kernels are timed on the int8 keep-mask
   [B, 1, Tq, S], which the model makes once per forward and every
   layer's call takes as it is; their time on a boolean mask, which the
   wrapper casts first (one more kernel a call; the paged arm's flash
   chunks still build their staircase mask per layer), and the dense
   bound (every position of k and v read), are printed beside. Then the
   int8-weight GEMM (``ops/quant_matmul.py``) at every product phase 18
   launches — llama3_8b's q/k/v/o/gate/up/down at 16, 64, 128, 192 and
   256 rows in bf16 and in f32, its head [128256, 4096] at 1-4 and 16
   rows (f32 activations over bf16 and over f32 weights), the MoE
   experts at 16-160 rows and the router — against its plain version
   (dequantize + ``F.linear``), and at 16, 64 and 256 rows (the head at
   4 and 16) its time beside the plain version's, ``torch.matmul`` on the
   dequantized weight (what the bf16 deployment runs) and the bound (the
   code bytes against 2MNK at the activations' peak). Last, every shape
   phase 19 launches (``SERVABLE_*`` below), f32 and bf16: timed with
   their bounds and SDPA, flash at DistilBERT-SST2's key-masked
   [32, T, 12, 64] for T 64, 128 and 256, Whisper-large-v3's encoder
   [8, 1500, 20, 64] with its frame mask and gpt2_medium's causal
   no-cache forward with the token mask at T 64, 128 and 256; the slab
   decode kernel at Whisper's step over its 40-position cache and its
   cross read over 1500 states (G = 1); kernels 2 and 3 at head_dim 16
   (llama_tiny's step), bf16 and int8. Every check of kernels 1-3 also
   holds the body the launch reported (kernel 1: fma, A, B or C; kernels
   2-3: the 16-row scan or the single-row scan) to the launchers' shape
   rule (``body_for``) and prints it. Held but not timed: the rest
   (Whisper's 2-layer apply and its stream, DistilBERT at T = 8, the tiny
   servables' shapes);
4. parity — llama3_8b at full width, 2 layers, f32, with the model's own
   cache and with the int8 KV cache: slab ``prefill`` then one
   ``decode_step``, and paged ``prefill_chunk_paged`` (a W = 64 and a
   W = 8 chunk) then ``decode_step_paged``, each through the kernels and
   through the plain versions; the paged logits also against the slab
   logits of the same prompts; the int8-vs-f32-cache logit difference is
   printed, not gated;
5. main — ``LLMDeployment("llama3_8b")`` (slab + monolithic prefill) at
   full width and depth in bf16 with random weights serves 8 requests
   (6 greedy, 2 sampled);
6. paged — ``LLMDeployment("llama3_8b", paged=True)`` (paged pool +
   token-budget chunked prefill), the same model rebuilt after phase 5's
   is freed, serves 10 requests: 8 of 40-60 tokens (6 greedy, 2 sampled)
   and 2 greedy of 150-300 tokens, which run as multi-chunk trains;
7. int8 — ``LLMDeployment("llama3_8b", quantize_kv=True)`` (slab + mono,
   int8 KV cache) serves phase 6's 10 requests; the two long prompts go
   through the long fill;
8. int8_paged — ``LLMDeployment("llama3_8b", paged=True,
   quantize_kv=True)`` serves the same 10, and the cache bytes of the
   serving phases are printed side by side;
9. slab_chunked — ``LLMDeployment("llama3_8b", chunked_prefill=True)``
   (slab cache, token-budget chunk trains on row caches) serves the same
   10: every prompt is a train of 64-token chunks; its tok/s and TTFT are
   printed beside phases 5 and 7;
10. front — the default deployment built as ``bench.py`` builds it:
    ``make_replica`` -> ``Router(max_assign_timeout_s=30)`` ->
    ``DeploymentHandle(default_slo_ms=300000)``, an ``HTTPProxy`` on
    127.0.0.1 in front. Saturation: 16 greedy requests of 40-60 tokens
    through ``handle.remote`` (tok/s, capacity = tok/s / 32 req/s); then
    Poisson arrivals at 0.6 x capacity for 5 s from ``WorkloadDriver``
    (TTFT p50 / p99, the engine's TTFT breakdown, KV occupancy, the
    handle + router hop per request); then one buffered and one streamed
    ``POST /api/llama3_8b``, and ``GET /metrics``, which must carry the
    engine's ``rdb_decode_*`` families. Every request is answered (none
    rejected), the router routed exactly the requests submitted, and the
    streamed chunks equal the final line's tokens. The Poisson window
    alone runs with a ``ChromeTraceCollector`` installed: the load
    generator opens a root span for each arrival (submit -> answer; the
    serving path's spans join its trace), and ``request_ledgers`` splits
    each request into hops, once whole and once cut at its first token
    (the end of its ``decode.prefill``): every ledger must conserve, the
    served ledgers must be the answered requests, and the phase prints
    the per-hop p50 / p95 of both, the queue wait split by whether every
    slot was decoding at arrival (beside the share spent waiting out a
    scan), the 8 slowest TTFT ledgers and the engine's ``snapshot()``,
    and writes the Chrome trace to ``build/traces/front.json``. Then the
    sharded front door (``serve/frontdoor.py``): two ``HTTPProxy``s, each
    taking one shard of one ``FrontDoor(n_shards=2,
    gossip_interval_s=0.2)`` as its admission, in front of the same
    handle; the global budget's rate is 0.5 x the capacity just measured,
    its burst 1 s of that rate; Poisson arrivals (phase 10's prompts) at
    1.0 x the capacity for 5 s, alternating between the proxies. It fails
    unless the fleet admits no more than ``rate T + burst + (N - 1) rate
    staleness + N`` (the bound the reference's ``serve/frontdoor.py``
    states; T up to the last admission decision, staleness the largest
    peer age the shards' ledgers showed, sampled every 20 ms), every
    admitted request is
    answered 200 with its tokens, every reject is a 429 with
    ``Retry-After``, no other status comes back, the admitted requests
    are among those the router counted, and ``FrontDoor.stop()`` leaves
    no gossip thread alive; it prints the admitted and rejected counts per
    shard, ``drift_audit`` and the TTFT p50 / p99 of the admitted requests
    beside the card's name and power limit. Its launches count under
    ``front``;
11. controller — the declarative path of the README: ``apply_config``
    deploys application ``chat`` (route ``/chat``) with one ``llm:``
    deployment ``llama3_8b`` (phase 5's knobs, version ``v1``,
    ``max_ongoing_requests`` 4096) on the module controller and the module
    HTTP proxy that ``serve.api`` starts. Through the returned handle: 16
    saturating requests (tok/s and TTFT p50 beside phase 10's), one
    buffered and one streamed ``POST /chat``, ``serve.api.status()``; a
    redeploy of the same version with ``max_ongoing_requests`` 128
    reconfigures the live replica and every bucket queue; a wedged engine
    is replaced by the control loop and a 48-token probe served alone
    gives the same greedy tokens before and after; a 96-token generation
    decoding on v1 finishes through the rolling update to ``v2`` (the v1
    model through ``model=``, ``default_max_new_tokens`` 40), after which
    a request without ``max_new_tokens`` gets 40 tokens; after
    ``serve.api.shutdown()`` the device memory held by tensors is back
    within 0.5 GB of its value before the phase (both read with cuBLAS's
    workspaces dropped, as phase 12 reads them: cuBLAS keeps one for each
    stream a GEMM ran on, each engine's capture stream among them);
12. colocate — measured tables and Nexus colocation. The memory budget
    (``hbm_budget_bytes``) is set from the card's total memory through the
    config. ``DecodeProfiler`` sweeps llama3_8b's decode step (every slot
    active, horizon 1) at 4, 8, 16 and 32 slots, capacity 512, and its
    prefill group program at bucket 64, groups 1 and 4 (8 timed
    dispatches, 2 warmup), prints every row and writes the two summary
    tables into ``build/profiles_h100/``; a zero row fails.
    ``LLMDeployment(num_slots=0, profiles_dir=...)`` builds an engine from
    the table plan (slots and both horizons, from the token SLO and the
    model's registered 150 ms TTFT SLO), and ``auto_num_slots()`` sizes
    from the same budget (256, the cap). A deployment with
    ``length_buckets=[256, 512]`` serves a prompt that fits 256 and one
    (300 tokens, the long fill) that needs 512, each reaching its own
    engine. Then two contracts, ``llama_a`` and ``llama_b``, share one
    model: ``pack_llm_engines`` plans them from the table just written,
    one ``ColocatedLLMEngines`` on the card runs the plan under an
    ``LLMLiveScheduler`` (control interval 2 s, rate window 8 s,
    headroom 0.85). The token SLO is twice ``slo_safety_factor`` times
    the 16-slot step (at once that step, the packer's SLO term alone
    would need two cards for the pair; the phase prints the plan it would
    give). Poisson arrivals of 40-60-token greedy prompts with 32 new
    tokens (seed 11) offer each contract 0.1 of the 16-slot row's
    full-occupancy throughput for 12 s, then 12 s with ``llama_a`` at
    twice that (halves cut from 20 s for the time limit: the rate window
    is 8 s). Per contract and half: sent, completed, dropped, stale,
    SLO compliance, token gap and TTFT; planned fractions beside measured
    busy shares; the audit log; which branch the replan after the surge
    took, and whether it moved the plan. The phase fails on a dropped,
    stale or unanswered request; when no replan after the surge saw
    ``llama_a`` at 1.5 times its first-half offered rate, or the last such replan
    applied a plan other than the packer's for the rates it saw; on a
    48-token greedy probe through ``llama_a``'s colocated engine that
    differs from a lone engine of the same shape; or on device memory
    held by tensors after the shutdown more than 0.1 GB above its value
    before the phase (both read with cuBLAS's per-thread workspaces
    dropped: the process keeps one for each thread that ran a GEMM, and
    the phase starts several threads). The same traffic then runs again
    at 0.2, in halves of 6 s (cut from 20 for the time limit), as a
    diagnostic that gates nothing but a lost request: at 0.2 the packer
    admits a pair the host-bound card cannot keep, and the run prints how
    far it falls short. The diagnostic run alone is
    traced: each contract's ``decode.turn`` time per step is printed
    against the number of sequences active in the turn.

13. vision — the Nexus vision path, bf16 with random weights from seed 0.
    Parity: ``resnet50``, ``shufflenet_v2``, ``efficientnet_v2s``,
    ``vit_b_16`` and ``vit_g_14`` (48 layers, head_dim 104) at 224 x 224,
    batch 8, in f32 on the card (TF32 off): logits through the kernel
    route against ``plain_attention()``, held to 1e-4 (only the ViTs
    differ: 12 and 48 flash launches a forward); then the served bf16
    model's logits on the same input against that f32 forward, held to
    5e-2 x max |logit|. Profiles: ``ModelProfiler`` sweeps the
    reference's accelerator buckets (resnet50 1-1024, shufflenet_v2
    1-2048, efficientnet_v2s 1-512 at its 384, vit_b_16 1-256) into
    ``build/profiles_h100/`` and prints every row; ``vit_g_14``, which the
    SLO run does not serve (nor does the reference's demo), is timed at
    batch 1 and 32 through ``ModelProfiler.profile_bucket`` and printed.
    The SLO run is ``tools/run_slo_demo.py``'s non-CPU shape: the three
    demo models' tables -> ``SquishyBinPacker`` (12 GiB) -> three
    ``ReplicaEngine``s on the card under one ``LiveScheduler`` (monitor
    every 5 s, rate window 10 s, 5% threshold), SLOs 2000 / 1500 /
    4000 ms, Poisson arrivals of one NHWC example at min(200, max(0.2,
    0.010 x profiled peak)) rps for 30 s (cut from 60 for the time
    limit), resnet50's rate doubled at 15 s. It prints the plans, the replans with their rates, per model
    the sent / completed / stale / dropped counts and the compliance of
    each half, per engine the batches, busy share beside the planned
    occupancy and step / profiled-latency ratios, and resnet50's queue
    depth every 5 s. The scheduler plans at 1.5 x the rates it reads
    (``RATE_HEADROOM`` in ``scheduler/control.py``). It fails on a request
    not accounted for, when no rate-change replan after the shift saw
    resnet50 at 1.5 x its offered rate, or on a compliance under 0.95 in
    any half of any model. After the gated run (its numbers read first,
    with tracing off throughout), 5 s more at the second half's rates
    run traced: every 4th arrival goes in under a load root and a
    ``handle.remote`` span (``tools/run_slo_demo.py``'s shape); the
    phase prints those requests' per-hop p50 / p95, the 5 slowest
    requests' ledgers and, per model,
    ``collate.batch`` against the ``engine.step`` it runs in and the step
    less its collate against the profiled row, and writes
    ``build/traces/vision.json``; a traced request not answered or a
    ledger that does not conserve fails it. For phase 15 the gated run's
    drivers record every arrival they submit
    (``WorkloadDriver(record_path=build/profiles_h100/arrivals.jsonl)``,
    ``tools/run_slo_demo.py``'s shape), what it served per model and half
    goes to ``build/profiles_h100/vision_served.json``, and the traced
    window's spans to ``build/traces/vision_spans.jsonl`` (every popped
    request has a ``queue.wait`` span, traced or not, so the span replay
    is the whole window's).

14. graphs — the engine's hot programs captured as CUDA graphs
    (``ops/graphs.py``) against the same programs run eagerly
    (``graphs.disable_capture()``), in one call. Parity, gated: llama3_8b
    at full width, 2 layers, f32, phase 6's 10 requests on the slab,
    paged, int8, int8-paged and slab-train arms (the paged chunk program
    and the slab trains' row-cache chunks among them), each served by an
    eager and a graphed engine: greedy tokens identical, launch counts
    equal, and the graphed engine captured. Speed, printed only:
    llama3_8b at full width, ``SPEED_LAYERS`` = 2 layers (cut from 32 for
    the time limit), bf16, phase 5's 8 requests on the
    slab arm and phase 6's 10 on the paged arm, eager then graphed, each
    served twice — once with a span collector (tok/s, TTFT p50 / max,
    ``decode.turn`` a step p50 by horizon) and once under
    ``torch.profiler`` (CUDA activity only: the device's idle share) —
    with the graphed engine's captures, capture seconds and pool bytes,
    beside the card's name, power limit, the host's CPU and ``nproc``.

15. sim — the simulator (``sim/*``) on the card, over phase 13's files;
    it fails if one is missing. (a) ``python -m
    ray_dynamic_batching_tpu_torch.sim --smoke`` in-process: the reference
    arm (``scheduler/control.reference_headroom()``) must pass every check
    of the reference's gate, the port arm (1.5 x) determinism and the
    floors; its two occupancy comparisons are printed with their
    verdicts. (b) The recorded arrivals replayed on the card's
    ``resnet50``, ``shufflenet_v2`` and ``vit_b_16`` tables at the demo's
    SLOs, 3 engines and the port's rule, twice: the two reports must be
    byte-identical and every recorded arrival accounted for; per model and
    half, the sim's compliance is printed beside what phase 13 served.
    (c) ``--hop-drift`` over the traced window's spans: at least one hop
    must be graded; each graded hop's p50 / p95 live and sim and the hops
    past the tolerance are printed. (d) The occupancy floor phase 12's
    decode table implies (the 4-slot row over the 32-slot row) beside the
    sim's default 0.35, printed only, when that table is there.

16. reuse — KV reuse (prefix and session caches, the host spill tier,
    the page fabric). (a) f32 parity, llama3_8b at full width, 2 layers,
    graphed engines on the slab, paged (chunked and monolithic) and
    int8-paged arms: a prefix hit (chunk granularity on the slab, a
    borrowed page run on the pool) against a cache-off engine, a
    session's second turn over a 216-token history (the paged arms
    borrow its full page, gated by the journal; the slab chunks from an
    unaligned base) against the whole history served fresh, and on the
    paged arms a prefix reloaded
    from the spill tier against its in-memory hit and a stream migrated
    mid-decode between two engines against its straight run; greedy
    tokens identical. (b) Full depth, bf16: two replicas of phase 6's
    paged deployment with ``prefix_cache_size=8``,
    ``session_cache_size=8`` and ``host_spill_pages=16`` behind the
    controller's router: a 384-token shared prefix (1 page miss, then 7
    concurrent hits with 16-48-token tails, routed to the holder by the
    published digests' ``chain_for``, 3 pages borrowed each), four
    two-turn sessions (4 session hits), 15 streams of 100 + 300 tokens
    that fill the pool and spill the prefix to host memory, the same
    request before and after the reload (tokens equal), one stream
    migrated between the replicas through ``KVPageFabric.migrate``
    (tokens equal its straight run's), one prefix pushed to the peer,
    which then borrows it. Gated: every request answered, each queue's
    books conserve with ``migrated_out``, ``PageAllocator.check()``, no
    page left once the caches clear, ``check_steady()``. (c) The slab
    deployment with the same caches: the shared-prefix and session runs
    at chunk granularity. Printed: TTFT of the hits beside the miss, of
    turn 2 beside turn 1, the spill and reload ms and pages (a spill's
    read split into its wait for the engine's stream, its pinned
    allocation and the rest), the parcel bytes, export and import ms. The kernels on these inputs (a chunk
    past the borrowed prefix over the pool's own pages, a decode window
    over tables sharing their head pages, a session chunk from an
    unaligned base, a decode window over seeded slab rows) against their
    plain versions, in f32 in (a) and bf16 in (b) and (c), timed in
    bf16 beside SDPA or the gather yardstick, with their bounds.

17. spec — speculative decoding (``draft_model``, ``spec_tokens`` 4).
    (a) llama3_8b at full width, 2 layers, f32, graphed engines: phase
    6's 10 requests on the slab, paged (chunked and monolithic),
    int8-paged and slab-train arms with a divergent draft (a second
    module of the same widths from seed 1), each against the same engine
    without a draft: greedy tokens identical; then the target as its own
    draft on each of the five arms: tokens identical and acceptance at
    least 0.99, so that every fill path of the draft (group prefill,
    long-fill replay at a fill's and a train's end, catch-ups, int8) is
    held by what it proposes. (b) llama3_8b bf16 at full width,
    ``SPEED_LAYERS`` = 2 layers (cut from 32 for the time limit), the
    target module as its own draft (``LLMDeployment(draft_model=)``),
    on the slab and paged (chunked) arms beside the same deployment
    without a draft: phase 5's 6 greedy requests, then phase 5's whole
    mix (its 2 sampled rows make every step they share plain, each
    followed by the draft's catch-up); each window traced for
    ``decode.turn`` (a spec round's ms beside a plain step's). The mix's
    tokens decoded by plain steps (every sampled row, each greedy row up
    to its first round: all of it on the slab) must equal the plain
    deployment's mix token for token: the same programs at the same
    shapes. Tokens of verify rounds against plain steps are not gated
    (the verify's GEMMs have other shapes than a step's): where they
    differ, both tokens' gaps to the top logit are printed. (c)
    gpt2_medium (1024 x 24 layers x 16 heads of 64, vocab 50257) with
    the registry's ``gpt2_draft`` (``LLMDeployment(draft_model_name=)``,
    seed 1), bf16, random weights, at ``bench_llm_serving``'s shape cut
    to the phase (64 slots, ``max_len`` 256, one bucket of 64, horizon
    32, groups of 8): 64 requests of 48 tokens and 48 new (96 before
    the time limit's cut), with and
    without the draft, slab and paged; random weights put acceptance
    near 0, the reference's bounded-degradation floor. Every window:
    launch counts held to the dispatches (the target's decode kernel
    once a layer a step or round, the draft's ``k + 1`` times a layer a
    round and once a catch-up window, flash for every fill of either),
    the speculation families held to the rounds' device outputs (one
    round logged for each counted, k drafted a slot in a round, accepted
    the tokens each slot was offered less the target's own; every slot
    took all it was offered unless it finished), no capture after
    warmup, the pool whole with no scratch page left. Every kernel shape
    the phase launches (warmup captures included) must be one phase 3
    held against its plain version: phase 17 needs phase 3. Printed:
    tok/s and TTFT p50 with and without the draft, rounds, acceptance,
    tokens a row per round, catch-ups, the kernel shapes launched.

18. weights — weight-only int8 (``quantize_weights=True``) and the MoE
    decoder. (a) llama3_8b at full width, 2 layers, f32, quantized: slab
    prefill and decode logits through the int8 kernel against its plain
    version (1e-3), then phase 6's 10 requests on the slab, paged, slab
    train, int8-KV and int8-KV paged arms, graphed through the kernel and
    eager through the plain version (``quant_matmul.plain_products``):
    greedy tokens identical. (b) llama3_8b bf16 at full width,
    ``SPEED_LAYERS`` = 2 layers (cut from 32 for the time limit), random
    weights from seed 0: phase 5's 8 requests on the slab and
    phase 6's 10 on the pool, graphed, first in bf16 and then with the
    same model quantized on the card; printed side by side: tok/s, TTFT
    p50 and max, ``decode.turn`` ms a step, the device's idle share,
    resident weight GB (``tree_weight_bytes``), ``auto_num_slots()`` at
    ``max_len`` 512 from the card's memory, and the greedy rows (other
    weights: not gated); gated: every request answered, nothing captured
    after warmup, pools whole. (c) the MoE decoder with moe_tiny's
    routing (4 experts, top-2, capacity 1.25) at llama3_8b's widths, 2
    layers, bf16 (moe_tiny's own 16-wide heads are not a decode-kernel
    shape), on the slab and the pool, without and with int8 weights:
    graphed greedy tokens identical to eager. Every kernel shape the
    phase launches must be one phase 3 held: phase 18 needs phase 3.

19. servables — DistilBERT, Whisper-style ASR and CausalLM's no-cache
    forward (``models/{distilbert,asr}.py``, ``CausalLM.apply``). (a) f32,
    TF32 off, each through the kernel route against ``plain_attention()``
    (logits to 1e-3, 1e-4 for distilbert_tiny; greedy tokens identical),
    with its launches counted: distilbert_sst2 at full width and depth
    (batch 4, T = 128 on flash, T = 8 on the slab decode kernel);
    whisper_large_v3 at full width, 2 encoder + 2 decoder layers
    (teacher-forced logits of two clips of 3000 and 2400 frames, then
    ``bench_asr_rtf``'s transcribe loop, 32 tokens); gpt2_medium's
    ``apply`` at full width, 2 layers (batch 2 x 128, causal with the
    token mask); the head_dim-16 servables: distilbert_tiny at T = 16 and
    8, llama_tiny, llama_tiny_int8kv and moe_tiny through
    ``LLMDeployment`` on the slab and the pool (greedy tokens against an
    eager plain-route deployment; kernel 2 or 3 must launch) and
    whisper_tiny_test's stream. (b) distilbert_sst2 bf16:
    ``ModelProfiler`` over ``tools/run_profiles.py``'s buckets (batch
    1-512 x seq 64 / 128 / 256) into ``build/profiles_h100/``, then one
    ``ReplicaEngine`` planned by ``SquishyBinPacker`` from those rows
    (seq bucket 128) under a ``LiveScheduler``, Poisson arrivals of ragged
    token ids (8-128 tokens) for 12 s (cut from 30 for the time limit)
    at min(200, max(0.2, 0.010 x the
    profiled peak)) rps: compliance per half against the 100 ms SLO
    (stale and dropped count as misses), gated at 0.95, every request
    accounted for. (c) whisper_large_v3 bf16 at full width and depth:
    ``bench_asr_rtf``'s shape (batch 8 x 30 s, 32 tokens, median of 3;
    RTF, latency, encode / prefill / steps; the encoder's launches all on
    kernel 1's body C and every step's reads on the single-row scan,
    gated; the repeats' tokens equal; their sha1 printed), a 10 s clip
    streamed in 200-frame chunks (8 new tokens a chunk), and the served
    roundtrip controller -> router -> replica -> ``StreamingASR``
    factory, 4 requests, each transcript equal to a direct
    ``StreamingASR`` run (the transcripts and their sha1 printed, to set
    beside another tree's: ``whisper_tokens`` gives them for a tree whose
    script does not, and measures where two trees' transcripts and RTF
    rows first differ against two bf16 ulps of the top logit, with an f32
    plain-route witness of which token wins there). (d)
    gpt2_medium bf16 at full depth: ``ModelProfiler`` rows over batch
    1-32 x seq 64 / 128 / 256 with ``flops_per_sample`` beside each.
    Launches are held to what each run implies (one flash or decode call
    a layer a forward; the profiler's forwards a row). Every kernel shape
    the phase launches must be one phase 3 held: phase 19 needs phase 3.
    It prints its wall time.
20. tp — tensor-parallel serving (``DecodeEngine(mesh=)``,
    ``parallel/{mesh,spmd,collective}.py``): every mesh here is a gloo
    world whose ranks (one process each, spawned by rank 0) time-share
    this one card — the script needs one card, and NCCL takes one rank
    per card, so the NCCL path is not run. (a) f32 parity at
    full width, 2 layers: TP 4 engines against the single-card engine on
    phase 6's 10 prompts (``TP_NEW_TOKENS`` = 16 new tokens each, cut from
    32 for the time limit), on the slab and paged arms, mono and chunked,
    each with the f32 and the int8 KV cache, and TP 2 engines on the f32
    ones (the int8 pool's tp 2 shards are held in phase 3): greedy tokens
    identical; the logits of a prefill and a step through the TP model
    against the single-card model's (max abs error printed; every rank's
    gathered logits bit-identical); each rank reports its kernel counts
    and the arm's kernel (2 on the slab, 4 — kernel 3 per kv-head
    shard — on the pool) must have launched on every rank. (b) BASELINE
    config 4: llama3_8b bf16 at full width, ``SPEED_LAYERS`` = 2 layers
    (cut from 32 so phase 22 fits the time limit), TP = 4, served
    through ``LLMDeployment(paged=True, num_slots=16,
    mesh_backend="gloo", warmup=False)`` (a mesh engine's programs run
    eagerly: warming them would only record the capture ledger) and
    ``make_replica`` with a 4-chip bundle from a ``PlacementManager`` over
    four rank handles on cuda:0; phase 5's 8 requests all answered, every
    rank's launches held to what the dispatches imply (kernel 4 once a
    layer a step, flash once a layer a fill, nothing else); tok/s and the
    wall per decode step printed as
    "4 ranks time-sharing one H100 over gloo: not TP speed". (c) in
    20a's worlds, on the f32 shard, after its arms: speculation on the
    TP slab engine with a self-draft and a divergent draft (the target's
    weights, each times 1 + ``TP_DRAFT_NOISE`` n with n drawn from a
    seed for the whole leaf; each rank builds the target's shard from
    its seed and cuts the noise to its slice) at tp 2 and tp 4, greedy
    tokens and acceptance (accepted / drafted) against the one-card spec
    engine's, whose divergent acceptance must lie strictly between 0
    and 1 (so that the draft's proposals reach the output), kernel 2 on
    every rank; at tp 2 a paged
    engine with prefix, session and spill caches in phase 16's shape (a
    300-token prefix served then hit, a 216-token history whose turn 2
    borrows its page, every prefix entry spilled and the prompt
    reloaded), its answers against the one-card engine's and every page
    free once the caches clear; then the fabric: a stream migrated
    mid-decode from a TP 2 paged engine to a one-card paged engine (its
    tokens against the same stream served straight, the export's gather
    over gloo timed) and a prefix the one-card engine published pushed
    to the TP engine, where a prompt sharing it hits; kernel 4 on every
    rank. Each part prints its seconds; each part's counts are set to 0
    on every rank just before it and read just after (the kernels line's
    ``tp_spec``, ``tp_reuse``, ``tp_fabric``, every rank summed). It
    prints the backend, ``torch.cuda.device_count()`` and its wall time;
21. surface — the serving surface (``serve/{openai_api,grpc_proxy,
    dashboard}.py``, ``state.py``, ``engine/{ingress,shm_bridge}.py``,
    ``runtime/{native,cluster,jobs,checkpoint}.py``): phase 5's
    deployment (llama3_8b bf16 at full width and depth, random weights
    from seed 0, 16 slots, max_len 512) deployed once on a
    ``ServeController`` and shared by (a)-(d). (a) an ``HTTPProxy`` with
    ``/v1/completions -> CompletionsHandle`` takes phase 5's 8 prompts
    (6 greedy, 2 seeded) as token-id bodies, one at a time: the greedy
    ``choices[].tokens`` identical to the same payloads through the
    ``DeploymentHandle`` one at a time, ``usage`` and ``finish_reason``
    checked; then the 8 at once, and malformed bodies must get a 4xx;
    (b) when ``import grpc`` succeeds, ``Predict`` and ``PredictStream``
    on the 6 greedy prompts, tokens identical to (a) (otherwise it prints
    that the door was not served and why); (c) a dashboard over
    ``StateAPI``: ``/api/state`` lists the deployment and its replica,
    ``/metrics`` carries ``rdb_decode_*``, and the state CLI (``--url
    ... --iterations 1``) runs as a ``JobManager`` job that must end
    ``SUCCEEDED``; (d) 4 greedy prompts over the ``SocketIngress`` and 4
    from a spawned ``ShmFrontend`` process into a ``ShmBridge`` on the
    replica's ``assign``, tokens identical to (a) (``/dev/shm``'s size
    printed); (a)-(d) held to the engine's dispatches. (e) the head's
    controller and HTTP ingress serve a ``ProcessDeployment`` of the
    demo factory (two spawned worker nodes, off the card); one node is
    SIGKILLed and the heal timed; requests resume. (f) llama3_8b at full
    width and 2 layers (1.49 B parameters, 4.0 GB: bf16, the head f32;
    16 GB written and read at full depth would spend a large share of
    the time limit and the disk) saved with ``CheckpointManager`` and served from
    ``LLMDeployment(checkpoint_dir=)``: 8 greedy prompts identical to
    the same weights served from memory; save and restore seconds and
    GB/s printed. Kernels 1 and 2 report their launches under
    ``surface``. It prints its wall time.
22. train — the training path (``parallel/{train,optim,pipeline}.py``,
    ``ops/ring_attention.py``, kernel 1's backward
    ``csrc/flash_attention_bwd.cu`` behind ``FlashAttentionFn``). (a) the
    backward against autograd of the plain version on the same inputs,
    causal + a key mask: llama3_8b's training shape q [4, 512, 32, 128],
    k/v [4, 512, 8, 128] in f32 and bf16, a small GQA case and a case
    with fully masked rows (their dq must be exactly 0); out / dq / dk /
    dv max abs error over the reference's largest |value| against
    ``TRAIN_TOL``; at the training shape in bf16, forward + backward
    timed beside the plain version's autograd, SDPA forward + backward on
    the same tensors, and the bound (q, k, v, dO, the mask, out, dq, dk,
    dv moved once; 12 H FLOPs an attended pair a head) and the
    backward's own bound (10 H FLOPs a pair); the bare launch must
    refuse an input that requires grad. (b)
    llama3_8b at full width:
    f32 at 2 layers, one step's loss and gradients through kernel 1 and
    its backward against the plain route; then bf16 compute over f32
    params and AdamW moments at ``TRAIN_LAYERS`` = 4 layers (1.92 B
    params: AdamW's 16 B a param puts all 32 layers, 128 GB, past the
    card), B 4 x T 512, random weights from seed 0, 5 steps on one
    batch, AdamW at 1e-4: the loss must fall; step ms, tokens/s, model
    TFLOP/s and peak
    memory printed. Its counts are set to 0 just before the 5 steps and
    read after: kernel 1 and its backward once a layer a step, nothing
    else. A sixth step then runs under ``torch.profiler`` (CUDA activity)
    and prints its device time by kernel family (attention forward and
    backward, GEMMs, AdamW, the rest), its idle share, and kernel 1's
    forward and its backward's kernels a layer at the training shape
    (the preprocess, and one launch for the dK/dV and dQ roles; 22a's
    own short profiles traced nothing after phase 14's sessions in a
    whole-script run). (c) two gloo
    worlds of four ranks on cuda:0, one after the other, each against the
    one-card step computed (and reduced to its loss and gradients on the
    host) before the world starts: dp x sp x
    tp = 1 x 2 x 2, llama3_8b at full width, 2 layers, f32 (ring
    attention over sp, TP collectives; each rank's gradient slices
    against a file of the one-card gradients it maps), and pp x ep = 2 x
    2, moe_tiny in two GPipe stages with its experts over ep (the
    gradients merged from every rank), and sp x ep = 2 x 2, moe_tiny
    with each MoE layer routing the gathered sequence (capacity over the
    whole of it), ring attention over sp and its experts over ep (the
    gradients merged from every rank); loss within ``TRAIN_LOSS_TOL``,
    every leaf within ``TRAIN_GRAD_TOL``; then two steps whose loss
    falls (every rank's counts read around the check and the steps: the
    kernels line's ``train_mesh``). After its two steps the sp x ep
    world's train state, params and AdamW moments, is saved whole
    (``save_train_state`` of rank 0's shard: every rank's distinct
    slices sent to rank 0), restored as one device's state onto the card
    and held bit for bit against the world's leaves gathered again;
    seconds and bytes printed, the checkpoint removed (the sp x tp
    world's llama3_8b state, 17.84 GB with its moments, would spend
    ~100 s of the time limit). Not distributed speed: the ranks time-share one
    card.

Phase 3 also holds kernel 4 (``paged_decode_attention_tp``): at llama3_8b's
shape, q [16, 1, 32, 128] over pools [64, 128, 8, 128] in bf16 and f32
and with int8 pools, the tp = 2 and tp = 4 shards' launches of kernel 3
(at tp 4 each q [16, 1, 8, 128] over [64, 128, 2, 128]), concatenated,
must be bit-identical to one unsharded launch and within tolerance of
the plain version; one rank's shard is timed at tp 4 (and tp 2) with its
bound over the shard's bytes and gather + SDPA on the same shard.

Every engine is warmed before it serves, and every serving phase (5-12,
14, 16-18) ends with the capture ledger's ``check_steady()``: no program
was captured after a warmup ended. Phases 5 to 13 and 16 to 18 are
served graphed (phase 19's decoders too; its encoders and ``StreamingASR``
run eagerly).

Phases 5 to 14, 16 to 19, 20b's, 21's and 22b's runs each set every launch count to 0
just before they serve and read them just after (20c's parts and 22c's
worlds read every rank's counts the same way, for the kernels line; on
every rank 20c's kernel must have launched and, in both, the plain
route and the kv-head gather never, but their counts are not held to
dispatches): each kernel of the path must have
launched the number of times the
engine's dispatches imply, the other kernels, the plain route and the
kv-head gather of a straddling TP layout never (a graph replay adds the
launches its capture recorded); a quantized model's int8 GEMM once per
int8 weight (each MoE expert's apart) in every forward. Phase 11 builds three engines inside its
window (v1, the heal's replacement, v2); each engine's warmup dispatches
(its prefill grid with greedy and sampled rows, the long fill's chunk,
the decode keys: ``warmup_fills`` and ``warmup_steps``) are added to the
dispatches the engines counted while serving. Phase 12 adds, beside its
engines' dispatches and warmups (the length-bucket replica's two
engines, every engine the scheduler builds and the lone probe engine are
warmed), the profiler's: each config runs 2 + 3 x 8 dispatches, one
prefill group or one decode step each. Phase 13 sets them to 0 just
before its SLO run and reads them after its traced window: flash = 12 x
(the vit_b_16 batches served in both + the vit_b_16 buckets the engines
warmed).

The line before the last is one JSON object with the per-kernel numbers
(``launches`` sums the serving phases, phase 14's graphed speed runs
among them; ``launches_by_path`` splits them; kernel 1's row has its
``launches_by_body`` and kernel 2's the bodies of kernels 2-4, every
phase but phase 3 summed) and the numbers of the
front, controller, colocate, vision, graphs, sim, reuse, spec, weights,
servables, tp, surface and train phases (``front``, ``controller``,
``colocate``, ``vision``, ``graphs``, ``sim``, ``reuse``, ``spec``,
``weights``, ``servables``, ``tp``, ``surface``, ``train``; the
per-hop splits under ``front.hops``, ``colocate.runs.diagnostic.turns``
and ``vision.traced``, the front-door run under ``front.front_door``);
the last line is
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (for
bring-up); the default runs all. ``--profile`` traces each serving window
with ``torch.profiler`` (CUDA activity) and prints the device's busy share
and its time by kernel (used for PERF.md's breakdown); ``--eager`` builds
every engine with its programs run eagerly (``graphs.disable_capture()``),
for the eager side of PERF.md's graphed-vs-eager table (phase 14 skips
under it: it makes that comparison itself).

Tolerances: bf16 2e-2 absolute — kernel and plain version both accumulate
in f32 from the same bf16 inputs, and the outputs (|x| < 4) differ by at
most a couple of bf16 ulps (2^-8 at 1) from the probabilities rounded at
another running max; f32 1e-4 — the same math summed in another order.
Model parity: 1e-3 absolute on logits of unit scale, two layers of f32
matmuls between the two attention paths (with int8 KV an f32 sum in
another order can flip a code at a .5 boundary in layer 1, which moves
these logits by ~2e-4). The paged run is also held, at 1e-3, to the slab
path in the same chunks (``prefill_chunk``), whose k/v come from the
same products.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import http.client
import json
import os
import platform
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LOGIT_TOL = 1e-3

# Main-path shapes (llama3_8b, 16 slots, max_len 512, bucket 64, groups of
# 4; paged: 128-token pages, 4 table entries per slot, a 64-page pool).
NB, T, S, SLOTS = 4, 64, 512, 16
N_HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
PS = 128
NP = S // PS
POOL = SLOTS * NP
# ViT-B/16's attention (phase 3's vit case): batch 64, 197 tokens, 12
# heads of 64; ViT-G/14's (the vit_g case): batch 32, 257 tokens, 16
# heads of 104.
VIT_SHAPE = (64, 197, 12, 64)
VIT_G_SHAPE = (32, 257, 16, 104)


# The depth of the speed-only llama3_8b runs of phases 14, 17b, 18b and 20b
# (full width): cut from 32 so the script, phase 22 with it, fits the chip
# call's time limit, and from 8 to 2 for 20c and 22c's additions (PERF.md
# section 4).
SPEED_LAYERS = 2
SPEED_NAME = "llama3_8b_speed_cut"   # 20b's registry name for it


def _speed_model(**kwargs):
    """llama3_8b at full width and SPEED_LAYERS deep (bf16, seed 0 unless
    ``kwargs`` say otherwise)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    kwargs.setdefault("dtype", torch.bfloat16)
    kwargs.setdefault("seed", 0)
    return CausalLM(dataclasses.replace(LLAMA3_8B, num_layers=SPEED_LAYERS),
                    "llama3_8b", **kwargs)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: Clock cycles of the card a second, for the spin kernel's length (H100
#: SXM at its boost clock, 1.98 GHz: a spin of N cycles lasts at least
#: N / SPIN_HZ seconds at any lower clock).
SPIN_HZ = 1.98e9
SPIN_MAX_CYCLES = 50_000_000      # ~30 ms at the clocks the card runs


def time_ms(fn, launches: int = 20, batches: int = 5) -> float:
    """Device time of one call: the median over ``batches`` of (CUDA-event
    time of ``launches`` back-to-back calls) / ``launches``. A spin kernel
    queued first keeps the card busy while the host enqueues the batch,
    so host-side wrapper time does not enter the measurement; it spins
    for twice the host time of a batch (one call timed on the host), at
    least 2 ms and at most ``SPIN_MAX_CYCLES``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(min(SPIN_MAX_CYCLES,
                   SPIN_HZ * max(2e-3, 2.0 * launches * host_s)))
    per_call = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def bound(nbytes: int, flops: int, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    line = _smi()
    print(f"[device] {line}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"cards {torch.cuda.device_count()}", flush=True)
    return {"smi": line, "kind": torch.cuda.get_device_name(0)}


def phase_build() -> None:
    from ray_dynamic_batching_tpu_torch.ops import _build

    seconds = _build.build()
    for name in _build.KERNELS:
        _build.load(name)
        for ln in _build.ptxas_log.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[ptxas] {name}: {ln.strip()}", file=sys.stderr)
    print(f"[build] {len(_build.KERNELS)} kernels built and loaded in "
          f"{seconds:.3f} s", flush=True)


# --- phase 3: each kernel against its plain version ------------------------
def _prefill_inputs(dtype, gen, rng):
    from ray_dynamic_batching_tpu_torch.models.decoder import prefill_mask

    dev = "cuda"
    q = torch.randn((NB, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((NB, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((NB, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = torch.tensor([40, 47, 53, 60], device=dev)
    attn = (torch.arange(T, device=dev)[None, :] < lengths[:, None]).int()
    mask = torch.cat([prefill_mask(attn), torch.zeros(
        (NB, 1, T, S - T), dtype=torch.bool, device=dev)], dim=-1)
    return _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                                mask=mask))


def _with_keep_mask(x):
    """Beside the boolean mask, the int8 keep-mask [B, Tq, S] the kernels
    read, made once, as the model makes it once per forward for all its
    layers (``ops/attention.py`` ``kernel_mask``): ``ms`` is the call as
    the slab layers make it; ``ms_bool_mask`` is the call on the boolean
    mask, the wrapper's cast included."""
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    B, Tq = x["q"].shape[:2]
    return dict(x, keep=fl.keep_mask(x["mask"], B, Tq, x["k"].shape[1]))


def _paged_chunk_inputs(dtype, gen, rng):
    """A paged chunk deep in a long prompt, as the paged arm's flash call
    sees it: q [2, 64, 32, 128] over the gathered view k/v [2, 512, 8, 128]
    with the staircase of lengths 128 and 256 (3 and 5 live KV tiles)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        paged_window_mask,
    )

    dev = "cuda"
    q = torch.randn((2, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((2, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((2, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    mask = paged_window_mask(torch.tensor([128, 256], device=dev), S, T)
    return _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                                mask=mask))


def _packed_qkv(shape, dtype, gen):
    """q, k, v [B, T, N, H] as ``models/vit.py`` hands them to the
    attention: views of one packed [B, T, 3 N H] projection (strided over
    tokens, heads H apart), non-causal, no mask."""
    B, T, N, H = shape
    qkv = torch.randn((B, T, 3 * N * H), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = qkv.view(B, T, 3, N, H).unbind(2)
    return dict(q=q, k=k, v=v, mask=None, keep=None)


def _vit_inputs(dtype, gen, rng):
    """ViT-B/16's attention at the profiled batch 64 (197 tokens: 13
    query slabs of 16, the last with 5 rows)."""
    return _packed_qkv(VIT_SHAPE, dtype, gen)


def _vit_g_inputs(dtype, gen, rng):
    """ViT-G/14's attention at batch 32 (257 tokens, head_dim 104 on the
    kernel's 128-wide tiles)."""
    return _packed_qkv(VIT_G_SHAPE, dtype, gen)


def _qkvo_cost(x) -> tuple:
    """An unmasked call reads q, k and v once and writes out once; FLOPs
    4 B N Tq Tk H."""
    B, Tq, N, H = x["q"].shape
    return (_nbytes(x["q"], x["k"], x["v"], x["q"]),
            4 * B * N * Tq * x["k"].shape[1] * H)


def _decode_inputs(dtype, gen, rng):
    from ray_dynamic_batching_tpu_torch.models.decoder import decode_mask

    dev = "cuda"
    q = torch.randn((SLOTS, 1, N_HEADS, HEAD_DIM), generator=gen, device=dev)
    k = torch.randn((SLOTS, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((SLOTS, S, KV_HEADS, HEAD_DIM), generator=gen, device=dev)
    lengths = torch.randint(40, S - 1, (SLOTS,), generator=gen, device=dev)
    return _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                                mask=decode_mask(lengths, S)))


def _quantized(x):
    """The same inputs with k/v as int8 codes + f32 scales, quantized by
    the cache's write rule."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        quantize_kv_rows,
    )

    k, ks = quantize_kv_rows(x["k"])
    v, vs = quantize_kv_rows(x["v"])
    return dict(x, k=k, v=v, ks=ks, vs=vs)


def _int8_decode_inputs(dtype, gen, rng):
    return _quantized(_decode_inputs(dtype, gen, rng))


def _int8_paged_inputs(dtype, gen, rng, tq: int = 1):
    return _quantized(_paged_inputs(dtype, gen, rng, tq))


def _paged_inputs(dtype, gen, rng, tq: int = 1,
                  shape=(SLOTS, N_HEADS, KV_HEADS, HEAD_DIM, NP)):
    """A pool of B x NP pages in shuffled order, lengths 40..NP ps - 2 over
    the B slots (in shuffled slot order), each slot holding just the
    pages its positions <= length + tq - 1 need and the sentinel past
    them. ``shape`` is (B, N, K, H, NP); the default is llama3_8b's
    16 slots over a 64-page pool."""
    B, n_heads, kv_heads, head_dim, n_table = shape
    pool, cap = B * n_table, n_table * PS
    dev = "cuda"
    q = torch.randn((B, tq, n_heads, head_dim), generator=gen, device=dev)
    k = torch.randn((pool, PS, kv_heads, head_dim), generator=gen,
                    device=dev)
    v = torch.randn((pool, PS, kv_heads, head_dim), generator=gen,
                    device=dev)
    lengths = np.minimum(np.linspace(40, cap - 2, B).astype(np.int32),
                         cap - tq)
    rng.shuffle(lengths)
    perm = rng.permutation(pool)
    table = np.full((B, n_table), pool, np.int32)
    used = 0
    for b in range(B):
        n = -(-(int(lengths[b]) + tq) // PS)
        table[b, :n] = perm[used: used + n]
        used += n
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                table=torch.from_numpy(table).to(dev),
                lengths=torch.from_numpy(lengths).to(dev))


def _sdpa(q, k, v, mask):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True,
    ).transpose(1, 2)


def _scales(x) -> list:
    return [x[n] for n in ("ks", "vs") if n in x]


def _mask_bytes(keep) -> int:
    """Bytes of the int8 keep-mask as its layout stores them, each read
    once: one row of ``ceil(Tk / 16) * 16`` bytes for each distinct
    (batch row, query row) — a row stride of 0 stores one row for all
    query rows (``flash_attention.mask_strides``)."""
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    if keep is None:
        return 0
    B, Tq, Tk = keep.shape
    bs, rs = fl.mask_strides(keep)
    return (1 if bs == 0 else B) * (1 if rs == 0 else Tq) * (-(-Tk // 16) * 16)


def _dense_cost(x) -> tuple:
    """Bytes (q, k, v, the scales of int8 k/v, out once each, the int8
    mask as its layout stores it) and FLOPs (4 B N Tq S H) of a
    dense-window call, printed beside the recount over attended
    positions."""
    B, tq, n_heads, head_dim = x["q"].shape
    Tk = x["k"].shape[1]
    nbytes = (_nbytes(x["q"], x["k"], x["v"], x["q"], *_scales(x))
              + _mask_bytes(x["keep"]))
    return nbytes, 4 * B * n_heads * tq * Tk * head_dim


def _masked_cost(x) -> tuple:
    """What this call's data needs (kernels 1 and 2): the K/V (and, int8,
    the scales) of the positions that at least one window row attends,
    read once, plus q, out and the int8 mask as its layout stores it;
    FLOPs 4 N H per attended (row, key) pair. The kernels skip the 64-key
    tiles no row attends."""
    keep = x["keep"] != 0                               # [B, Tq, Tk]
    if x.get("causal"):     # the kernel applies the causal rule itself
        Tq, Tk = keep.shape[1:]
        keep = keep & torch.ones((Tq, Tk), dtype=torch.bool,
                                 device=keep.device).tril(Tk - Tq)
    positions = int(keep.any(dim=1).sum().item())
    pairs = int(keep.sum().item())
    n_heads, head_dim = x["q"].shape[2:]
    kv_heads = x["k"].shape[2]
    kv_elt = kv_heads * head_dim * x["k"].element_size()
    if "ks" in x:
        kv_elt += kv_heads * 4
    nbytes = (2 * positions * kv_elt + 2 * _nbytes(x["q"])
              + _mask_bytes(x["keep"]))
    return nbytes, 4 * n_heads * head_dim * pairs


def _paged_cost(x) -> tuple:
    """What this call's data needs: each slot attends positions
    [0, length + Tq) (the kernel skips tiles past them); the K/V (and,
    int8, the scales) of each distinct (page, offset) those windows reach
    is read once, so tables that share head pages share their bytes; plus
    q, out, the table and the lengths. FLOPs 4 N Tq H per position a slot
    attends."""
    B, tq, n_heads, head_dim = x["q"].shape
    ps, kv_heads = x["k"].shape[1:3]
    kv_elt = kv_heads * head_dim * x["k"].element_size()
    if "ks" in x:
        kv_elt += kv_heads * 4
    need = x["lengths"].long() + tq                             # [B]
    table = x["table"].long()
    first = torch.arange(table.shape[1], device=table.device) * ps
    used = (need[:, None] - first[None, :]).clamp(0, ps)        # [B, NP]
    live = used > 0
    # A slot uses offsets [0, used) of each page it reaches: a page read
    # by several slots is read to the deepest of them.
    deepest = torch.zeros(int(table.max().item()) + 1, dtype=torch.long,
                          device=table.device).scatter_reduce_(
        0, table[live], used[live], "amax")
    distinct = int(deepest.sum().item())
    pairs = int(need.sum().item())
    nbytes = (2 * distinct * kv_elt + 2 * _nbytes(x["q"])
              + _nbytes(x["table"], x["lengths"]))
    return nbytes, 4 * n_heads * tq * head_dim * pairs


# The speculative verify window: spec_tokens + 1 = 5 query rows a slot.
SPEC_WINDOW = 5
# Phase 17's own launch shapes beside the main path's, as its engines
# launch them (B included), each held to its plain version and timed:
# llama3_8b's draft slab is max_len + 5 = 517 positions, its long fill's
# row cache 576; gpt2_medium (16 heads of 64) serves 64 slots over 256
# positions (a 128-page pool, 2 pages a slot), gpt2_draft (4 heads of 64)
# over 261, both long fills over 320. Catch-up windows are as wide as
# the plain step's horizon (1, 2 or 8 on llama3_8b; 8 or 32 on
# gpt2_medium, flash from 16 on).
FLASH_SPEC_CASES = (
    # (case, B, Tq, N, Tk, K, H, prefill)
    ("draft_prefill", NB, T, N_HEADS, 517, KV_HEADS, HEAD_DIM, True),
    ("long_chunk", 1, T, N_HEADS, 576, KV_HEADS, HEAD_DIM, False),
    ("gpt2_prefill", 8, 64, 16, 256, 16, 64, True),
    ("gpt2_long_chunk", 1, 64, 16, 320, 16, 64, False),
    ("gpt2_draft_prefill", 8, 64, 4, 261, 4, 64, True),
    ("gpt2_draft_long_chunk", 1, 64, 4, 320, 4, 64, False),
    ("gpt2_draft_catchup32", 64, 32, 4, 261, 4, 64, False),
)
DECODE_SPEC_CASES = (
    # (case, B, Tq, N, Tk, K, H); the verify windows first
    ("verify", SLOTS, SPEC_WINDOW, N_HEADS, S, KV_HEADS, HEAD_DIM),
    ("verify_gpt2", 64, SPEC_WINDOW, 16, 256, 16, 64),
    ("draft_step", SLOTS, 1, N_HEADS, 517, KV_HEADS, HEAD_DIM),
    ("draft_catchup2", SLOTS, 2, N_HEADS, 517, KV_HEADS, HEAD_DIM),
    ("draft_catchup8", SLOTS, 8, N_HEADS, 517, KV_HEADS, HEAD_DIM),
    ("gpt2_step", 64, 1, 16, 256, 16, 64),
    ("gpt2_draft_step", 64, 1, 4, 261, 4, 64),
    ("gpt2_draft_catchup8", 64, 8, 4, 261, 4, 64),
)
# The int8 draft slab of 17a's self-draft on the int8 pool.
DECODE_INT8_SPEC_CASES = DECODE_SPEC_CASES[2:5]
PAGED_SPEC_CASES = (
    # (case, B, Tq, N, K, H, pages a slot, scratch)
    ("verify", SLOTS, SPEC_WINDOW, N_HEADS, KV_HEADS, HEAD_DIM, NP, True),
    ("gpt2_step", 64, 1, 16, 16, 64, 2, False),
    ("gpt2_verify", 64, SPEC_WINDOW, 16, 16, 64, 2, True),
)


def _slab_case(B, tq, n_heads, Tk, kv_heads, head_dim, prefill=False,
               int8=False):
    """Inputs of kernel 1 or 2 as a slab program hands them over: q
    [B, tq, N, H] over k/v [B, Tk, K, H]. ``prefill``: a prompt group's
    causal mask over positions [0, tq) (prompts of 3/4 tq to tq tokens)
    and nothing past them. Else the staircase ``pos <= lengths + t``
    (``paged_window_mask``; at tq = 1 ``decode_mask``) from lengths drawn
    in [min(40, Tk - tq), Tk - tq]: a decode step, a verify or catch-up
    window, a long fill's chunk at its base. ``int8``: k/v as codes and
    scales (:func:`_quantized`)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        paged_window_mask,
        prefill_mask,
    )

    def make(dtype, gen, rng):
        dev = "cuda"
        q = torch.randn((B, tq, n_heads, head_dim), generator=gen,
                        device=dev)
        k = torch.randn((B, Tk, kv_heads, head_dim), generator=gen,
                        device=dev)
        v = torch.randn((B, Tk, kv_heads, head_dim), generator=gen,
                        device=dev)
        if prefill:
            n = torch.randint(3 * tq // 4, tq + 1, (B,), generator=gen,
                              device=dev)
            attn = (torch.arange(tq, device=dev)[None, :] < n[:, None]).int()
            mask = torch.cat([prefill_mask(attn), torch.zeros(
                (B, 1, tq, Tk - tq), dtype=torch.bool, device=dev)], dim=-1)
        else:
            lengths = torch.randint(min(40, Tk - tq), Tk - tq + 1, (B,),
                                    generator=gen, device=dev)
            mask = paged_window_mask(lengths, Tk, tq)
        x = _with_keep_mask(dict(q=q.to(dtype), k=k.to(dtype),
                                 v=v.to(dtype), mask=mask))
        return _quantized(x) if int8 else x

    return make


def _paged_case(B, tq, n_heads, kv_heads, head_dim, n_table,
                scratch=False, int8=False):
    """Kernel 3's inputs: q [B, tq, N, H] over a pool of B x n_table
    pages of ``PS`` positions. ``scratch``: a spec round's tables, each
    slot's length 1..tq - 1 positions short of a page boundary, its
    table holding its owned pages and then one SCRATCH page that only
    the window reaches, the sentinel past. Else
    :func:`_paged_inputs`'s tables. ``int8``: codes and scales."""
    shape = (B, n_heads, kv_heads, head_dim, n_table)

    def make(dtype, gen, rng):
        if not scratch:
            x = _paged_inputs(dtype, gen, rng, tq, shape)
            return _quantized(x) if int8 else x
        pool, dev = B * n_table, "cuda"
        q = torch.randn((B, tq, n_heads, head_dim), generator=gen,
                        device=dev)
        k = torch.randn((pool, PS, kv_heads, head_dim), generator=gen,
                        device=dev)
        v = torch.randn((pool, PS, kv_heads, head_dim), generator=gen,
                        device=dev)
        owned = rng.integers(1, n_table, B)
        lengths = (owned * PS - rng.integers(1, tq, B)).astype(np.int32)
        perm = rng.permutation(pool)
        table = np.full((B, n_table), pool, np.int32)
        used = 0
        for b in range(B):
            n = int(owned[b]) + 1
            table[b, :n] = perm[used: used + n]
            used += n
        x = dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                 table=torch.from_numpy(table).to(dev),
                 lengths=torch.from_numpy(lengths).to(dev))
        return _quantized(x) if int8 else x

    return make


# Phase 19's launch shapes (the remaining servables), as its models hand
# them over. Timed: DistilBERT-SST2's key-masked attention at batch 32 and
# the profiled seq buckets, Whisper-large-v3's encoder at bench_asr_rtf's
# batch 8 x 1500 states, gpt2_medium's causal no-cache forward with the
# token mask, Whisper's step over its 40-position cache and its cross read
# over 1500 states (G = 1), and the decode kernels at head_dim 16
# (llama_tiny's step: 4 heads over 2 KV heads) in bf16 and int8.
SERVABLE_FLASH_CASES = (
    # (case, B, Tq, N, Tk, K, H, mask: "key" | "prefill" | "stair", causal)
    ("distilbert_T64", 32, 64, 12, 64, 12, 64, "key", False),
    ("distilbert_T128", 32, 128, 12, 128, 12, 64, "key", False),
    ("distilbert_T256", 32, 256, 12, 256, 12, 64, "key", False),
    ("whisper_encoder", 8, 1500, 20, 1500, 20, 64, "key", False),
    ("gpt2_apply_T64", 8, 64, 16, 64, 16, 64, "key", True),
    ("gpt2_apply_T128", 8, 128, 16, 128, 16, 64, "key", True),
    ("gpt2_apply_T256", 8, 256, 16, 256, 16, 64, "key", True),
)
SERVABLE_DECODE_CASES = (
    # (case, B, Tq, N, Tk, K, H, mask)
    ("whisper_step", 8, 1, 20, 40, 20, 64, "stair"),
    ("whisper_cross", 8, 1, 20, 1500, 20, 64, "key"),
    ("h16_step", 16, 1, 4, 64, 2, 16, "stair"),
)
SERVABLE_PAGED_CASES = (
    # (case, B, Tq, N, K, H, pages a slot, scratch)
    ("h16_step", 16, 1, 4, 2, 16, 2, False),
)
# Held, not timed: every other shape phase 19 launches. Whisper-large-v3's
# 2-layer f32 apply and its stream (200-frame chunks: 100 states; a
# prefix in text buckets 16, 32, 64 over caches of bucket + 8), DistilBERT
# at T = 8, and the tiny servables' shapes (head_dim 16: llama_tiny,
# llama_tiny_int8kv and moe_tiny on the slab of 64 and the pool of 128-
# position pages, buckets 8 and 16; whisper_tiny_test's stream of 100
# states and caches of 20 and 80; distilbert_tiny at T = 8 and 16).
SERVABLE_FLASH_HELD = (
    ("whisper_apply_self", 2, 16, 20, 16, 20, 64, "prefill", False),
    ("whisper_apply_cross", 2, 16, 20, 1500, 20, 64, "key", False),
    ("whisper_stream_encoder", 1, 100, 20, 100, 20, 64, "key", False),
) + tuple(
    (f"whisper_stream_self_T{t}", 1, t, 20, t + 8, 20, 64, "prefill", False)
    for t in (16, 32, 64)) + tuple(
    (f"whisper_stream_cross_T{t}", 1, t, 20, 100, 20, 64, "key", False)
    for t in (16, 32, 64)) + (
    ("h16_key16", 4, 16, 4, 16, 4, 16, "key", False),
    ("h16_prefill16", 4, 16, 4, 64, 2, 16, "prefill", False),
    ("h16_chunk_paged", 4, 16, 4, 256, 2, 16, "stair", False),
    ("h16_long_row", 1, 16, 4, 80, 2, 16, "stair", False),
    ("h16_asr_self", 1, 16, 4, 20, 4, 16, "prefill", False),
    ("h16_asr_cross", 1, 16, 4, 100, 4, 16, "key", False),
    ("h16_asr_encoder", 1, 100, 4, 100, 4, 16, "key", False),
)
SERVABLE_DECODE_HELD = (
    ("distilbert_T8", 4, 8, 12, 8, 12, 64, "key"),
) + tuple(
    (f"whisper_stream_step_S{t + 8}", 1, 1, 20, t + 8, 20, 64, "stair")
    for t in (16, 32, 64)) + (
    ("whisper_stream_cross", 1, 1, 20, 100, 20, 64, "key"),
    ("h16_key8", 4, 8, 4, 8, 4, 16, "key"),
    ("h16_prefill8", 4, 8, 4, 64, 2, 16, "prefill"),
    ("h16_asr_step", 1, 1, 4, 20, 4, 16, "stair"),
    ("h16_asr_cross", 1, 1, 4, 100, 4, 16, "key"),
)
SERVABLE_DECODE_INT8_HELD = (
    ("h16_prefill8", 4, 8, 4, 64, 2, 16, "prefill"),
)
SERVABLE_PAGED_HELD = (
    ("h16_window8", 4, 8, 4, 2, 16, 2, False),
)


def _own_stream(make, seed: int):
    """``make`` drawing from generators of its own, seeded by ``seed``,
    instead of phase 3's shared ones: a case added this way leaves the
    inputs of every case after it as they were."""
    def made(dtype, gen, rng):
        return make(dtype, torch.Generator(device="cuda").manual_seed(seed),
                    np.random.default_rng(seed))

    return made


def _servable_case(B, tq, n_heads, Tk, kv_heads, head_dim, mask_kind,
                   causal=False, int8=False):
    """Kernel 1 or 2 inputs as phase 19's models hand them over: q
    [B, tq, N, H] over k/v [B, Tk, K, H] with a ``mask_kind`` mask —
    ``"key"``: each row's valid keys a prefix of 3/4 Tk .. Tk (a token or
    frame mask), with ``causal`` the causal flag beside it (the kernel
    gets the key mask and applies the causal rule; SDPA the two
    combined); ``"prefill"`` and ``"stair"``: :func:`_slab_case`'s
    prefill and staircase masks."""
    if mask_kind != "key":
        return _slab_case(B, tq, n_heads, Tk, kv_heads, head_dim,
                          prefill=mask_kind == "prefill", int8=int8)
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    def make(dtype, gen, rng):
        dev = "cuda"
        q = torch.randn((B, tq, n_heads, head_dim), generator=gen,
                        device=dev)
        k = torch.randn((B, Tk, kv_heads, head_dim), generator=gen,
                        device=dev)
        v = torch.randn((B, Tk, kv_heads, head_dim), generator=gen,
                        device=dev)
        n = torch.randint(max(1, 3 * Tk // 4), Tk + 1, (B,), generator=gen,
                          device=dev)
        key = (torch.arange(Tk, device=dev)[None, :] < n[:, None])
        key = key[:, None, None, :].expand(B, 1, tq, Tk)
        keep = fl.keep_mask(key, B, tq, Tk)
        mask = key
        if causal:
            mask = key & torch.ones((tq, Tk), dtype=torch.bool,
                                    device=dev).tril(Tk - tq)
        x = dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), mask=mask,
                 keep=keep, causal=causal)
        return _quantized(x) if int8 else x

    return make


def _dequant_sdpa(x):
    """The int8 slab yardstick: dequantize k and v, then SDPA (3 calls)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import dequantize_kv

    dt = x["q"].dtype
    return _sdpa(x["q"], dequantize_kv(x["k"], x["ks"], dt),
                 dequantize_kv(x["v"], x["vs"], dt), x["mask"])


def _gather_sdpa(x):
    """The paged yardstick: gather the logical view (k, v; with int8 pools
    also their scales, then dequantize them), then SDPA — 3 calls, 7 with
    int8 pools."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        dequantize_kv,
        paged_window_mask,
    )
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec

    k_g = dec.logical_view(x["k"], x["table"])
    v_g = dec.logical_view(x["v"], x["table"])
    if "ks" in x:
        dt = x["q"].dtype
        k_g = dequantize_kv(k_g, dec.logical_view(x["ks"], x["table"]), dt)
        v_g = dequantize_kv(v_g, dec.logical_view(x["vs"], x["table"]), dt)
    mask = paged_window_mask(x["lengths"], k_g.shape[1], x["q"].shape[1])
    return _sdpa(x["q"], k_g, v_g, mask)


def _kernel_specs():
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    return {
        "flash_attention": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/flash_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/flash_attention.py:154",
            inputs=_prefill_inputs,
            kernel=lambda x: fl.flash_attention(
                x["q"], x["k"], x["v"], causal=x.get("causal", False),
                mask=None if x["keep"] is None else x["keep"][:, None]),
            kernel_bool_mask=lambda x: fl.flash_attention(
                x["q"], x["k"], x["v"], causal=x.get("causal", False),
                mask=x["mask"]),
            plain=lambda x: fl.flash_attention_plain(
                x["q"], x["k"], x["v"], x["keep"],
                causal=x.get("causal", False)),
            library=lambda x: _sdpa(x["q"], x["k"], x["v"], x["mask"]),
            yardstick=None,
            cost=_masked_cost,
            # A paged chunk deep in a long prompt (3 and 5 live tiles),
            # ViT-B/16's and ViT-G/14's unmasked attention (the vision
            # path), and phase 17's fills.
            serving_cases=[("paged_chunk", _paged_chunk_inputs, None),
                           ("vit", _vit_inputs, _qkvo_cost),
                           ("vit_g", _vit_g_inputs, _qkvo_cost)] + [
                (c, _slab_case(*dims), None)
                for c, *dims in FLASH_SPEC_CASES] + [
                (c, _own_stream(_servable_case(*dims), i), None)
                for i, (c, *dims) in enumerate(SERVABLE_FLASH_CASES)],
            held_cases=[(c, _own_stream(_servable_case(*dims), 100 + i))
                        for i, (c, *dims) in enumerate(SERVABLE_FLASH_HELD)],
        ),
        "decode_attention": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/decode_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:238",
            inputs=_decode_inputs,
            kernel=lambda x: dec.decode_attention(x["q"], x["k"], x["v"],
                                                  mask=x["keep"][:, None]),
            kernel_bool_mask=lambda x: dec.decode_attention(
                x["q"], x["k"], x["v"], mask=x["mask"]),
            plain=lambda x: dec.decode_attention_plain(
                x["q"], x["k"], x["v"], x["keep"]),
            library=lambda x: _sdpa(x["q"], x["k"], x["v"], x["mask"]),
            yardstick=None,
            cost=_masked_cost,
            # Phase 17's: the slab verify windows, llama3_8b's (20 rows a
            # KV head) and gpt2_medium's (5), the draft steps, the
            # catch-up windows, gpt2_medium's step.
            serving_cases=[(c, _slab_case(*dims), None)
                           for c, *dims in DECODE_SPEC_CASES] + [
                (c, _own_stream(_servable_case(*dims), 200 + i), None)
                for i, (c, *dims) in enumerate(SERVABLE_DECODE_CASES)],
            held_cases=[(c, _own_stream(_servable_case(*dims), 300 + i))
                        for i, (c, *dims) in enumerate(SERVABLE_DECODE_HELD)],
        ),
        "paged_decode_attention": dict(
            source=("ray_dynamic_batching_tpu_torch/csrc/"
                    "paged_decode_attention.cu"),
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:319",
            inputs=_paged_inputs,
            kernel=lambda x: dec.paged_decode_attention(
                x["q"], x["k"], x["v"], x["table"], x["lengths"]),
            plain=lambda x: dec.paged_decode_attention_plain(
                x["q"], x["k"], x["v"], x["table"], x["lengths"]),
            library=None,       # no one PyTorch call reads a page table
            yardstick=(_gather_sdpa, "gather + sdpa (3 calls)"),
            cost=_paged_cost,
            extra_cases=[(torch.float32, 4)],   # Tq = 4 staircase
            # Phase 17's: the paged verify windows over scratch pages,
            # gpt2_medium's step.
            serving_cases=[(c, _paged_case(*dims), None)
                           for c, *dims in PAGED_SPEC_CASES] + [
                (c, _own_stream(_paged_case(*dims), 400 + i), None)
                for i, (c, *dims) in enumerate(SERVABLE_PAGED_CASES)],
            held_cases=[(c, _own_stream(_paged_case(*dims), 500 + i))
                        for i, (c, *dims) in enumerate(SERVABLE_PAGED_HELD)],
        ),
        # The int8-KV branch of kernels 2 and 3: the same sources and
        # wrappers, 1-byte codes + f32 scales (the reference's scale
        # BlockSpecs and _scan_tile's ks/vs arithmetic).
        "decode_attention_int8": dict(
            source="ray_dynamic_batching_tpu_torch/csrc/decode_attention.cu",
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:268",
            inputs=_int8_decode_inputs,
            kernel=lambda x: dec.decode_attention(
                x["q"], x["k"], x["v"], mask=x["keep"][:, None], k_scale=x["ks"],
                v_scale=x["vs"]),
            kernel_bool_mask=lambda x: dec.decode_attention(
                x["q"], x["k"], x["v"], mask=x["mask"], k_scale=x["ks"],
                v_scale=x["vs"]),
            plain=lambda x: dec.decode_attention_plain(
                x["q"], x["k"], x["v"], x["keep"], k_scale=x["ks"],
                v_scale=x["vs"]),
            library=None,       # no one PyTorch call reads int8 codes
            yardstick=(_dequant_sdpa, "dequantize + sdpa (3 calls)"),
            cost=_masked_cost,
            serving_cases=[(c, _slab_case(*dims, int8=True), None)
                           for c, *dims in DECODE_INT8_SPEC_CASES] + [
                (c, _own_stream(_servable_case(*dims, int8=True), 600 + i),
                 None)
                for i, (c, *dims) in enumerate(SERVABLE_DECODE_CASES[2:])],
            held_cases=[(c, _own_stream(_servable_case(*dims, int8=True),
                                        700 + i))
                        for i, (c, *dims) in enumerate(
                            SERVABLE_DECODE_INT8_HELD)],
        ),
        "paged_decode_attention_int8": dict(
            source=("ray_dynamic_batching_tpu_torch/csrc/"
                    "paged_decode_attention.cu"),
            replaces="ray_dynamic_batching_tpu/ops/decode_attention.py:354",
            inputs=_int8_paged_inputs,
            kernel=lambda x: dec.paged_decode_attention(
                x["q"], x["k"], x["v"], x["table"], x["lengths"],
                k_scale=x["ks"], v_scale=x["vs"]),
            plain=lambda x: dec.paged_decode_attention_plain(
                x["q"], x["k"], x["v"], x["table"], x["lengths"],
                k_scale=x["ks"], v_scale=x["vs"]),
            library=None,
            yardstick=(_gather_sdpa, "gather + dequantize + sdpa (7 calls)"),
            cost=_paged_cost,
            extra_cases=[(torch.float32, 4)],
            serving_cases=[(c, _paged_case(*dims, int8=True), None)
                           for c, *dims in PAGED_SPEC_CASES[:1]] + [
                (c, _own_stream(_paged_case(*dims, int8=True), 800 + i), None)
                for i, (c, *dims) in enumerate(SERVABLE_PAGED_CASES)],
            held_cases=[(c, _own_stream(_paged_case(*dims, int8=True),
                                        900 + i))
                        for i, (c, *dims) in enumerate(SERVABLE_PAGED_HELD)],
        ),
    }


# Every kernel shape :func:`_check` has held against the plain version
# (keyed by :func:`_shape_key`): phase 17 fails on a launch outside it.
_CHECKED: set = set()


def _shape_key(name: str, q, k) -> tuple:
    """A kernel call's shape as phases 3 and 17 compare them: the kernel
    (its int8 branch apart), q without its batch, k/v without theirs (a
    pool's page count left out), and the two dtypes. The batch and the
    page count size the grid, not the code a block runs."""
    return (name, tuple(q.shape[1:]), tuple(k.shape[1:]),
            str(q.dtype).removeprefix("torch."),
            str(k.dtype).removeprefix("torch."))


@contextlib.contextmanager
def _kernel_shapes():
    """Count every kernel wrapper call, by :func:`_shape_key`, while the
    block runs: the wrappers as ``ops/attention`` reaches them, the
    models' only route to the kernels. A captured graph calls them once,
    at its capture; eager programs at every call."""
    import collections

    from ray_dynamic_batching_tpu_torch.ops import attention

    seen = collections.Counter()
    saved = []
    for mod, fn_name in ((attention._flash, "flash_attention"),
                         (attention._decode, "decode_attention"),
                         (attention._decode, "paged_decode_attention")):
        fn = getattr(mod, fn_name)

        def counted(q, k, *args, _fn=fn, _name=fn_name, **kw):
            int8 = kw.get("k_scale") is not None
            seen[_shape_key(_name + ("_int8" if int8 else ""), q, k)] += 1
            return _fn(q, k, *args, **kw)

        setattr(mod, fn_name, counted)
        saved.append((mod, fn_name, fn))
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul as qm

    w8 = qm.int8_linear

    def counted_w8(x, codes, scale, bias=None, *, weight_dtype):
        seen[_w8_key(x.numel() // x.shape[-1], codes, scale, x.dtype,
                     weight_dtype, bias is not None)] += 1
        return w8(x, codes, scale, bias, weight_dtype=weight_dtype)

    qm.int8_linear = counted_w8
    saved.append((qm, "int8_linear", w8))
    try:
        yield seen
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def _live_bodies() -> dict:
    """Launches of kernel 1 by body and of kernels 2-4 by body since the
    last ``attention.reset_counts`` (``launches_by_body``)."""
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    return {**{f"flash_attention/{b}": n
               for b, n in fl.launches_by_body.items()},
            **{f"decode_kernels/{b}": n
               for b, n in dec.launches_by_body.items()}}


#: Launches by body banked at each ``_reset_counts``: with the live counts,
#: the script's running totals (read as differences around a window).
_BODY_BANK: dict = {}


def _bodies() -> dict:
    """Launches of kernel 1 by body and of kernels 2-4 by body since the
    process started: the banked totals plus the live counts."""
    return {k: n + _BODY_BANK.get(k, 0) for k, n in _live_bodies().items()}


def _reset_counts() -> None:
    """``attention.reset_counts()``, which zeroes every launch count, the
    launches by body among them; those are banked first (``_bodies``)."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    for k, n in _live_bodies().items():
        _BODY_BANK[k] = _BODY_BANK.get(k, 0) + n
    attention.reset_counts()


def _body_delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in _bodies().items()
            if n != before.get(k, 0)}


def _want_body(name: str, x) -> str:
    """The body the launchers' shape rule names for a phase-3 case."""
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    B, Tq, N, H = x["q"].shape
    if name == "flash_attention":
        return "flash_attention/" + fl.body_for(
            x["q"].dtype, Tq, x["k"].shape[1], H,
            masked=x.get("keep") is not None, causal=x.get("causal", False))
    return "decode_kernels/" + dec.body_for(Tq, N, x["k"].shape[2])


def _check(name: str, tag: str, sp, x, dtype) -> float:
    """The kernel against its plain version on ``x``: max abs error, held
    to the dtype's tolerance (fails the run past it); the body it ran
    (kernels 1-3), held to the launcher's shape rule."""
    _CHECKED.add(_shape_key(name, x["q"], x["k"]))
    before = _bodies()
    out = sp["kernel"](x)
    torch.cuda.synchronize()
    ran = _body_delta(before)
    body = ""
    if name != "int8_weight_matmul":
        want = _want_body(name, x)
        if ran != {want: 1}:
            fail(f"{name} {tag}: ran {ran}, the shape rule names {want}")
        body = f", body {want.split('/')[1]}"
    ref = sp["plain"](x)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all():
        fail(f"{name} {tag}: non-finite output")
    print(f"[kernels] {name} {tag} q{tuple(x['q'].shape)} "
          f"k{tuple(x['k'].shape)}: max_abs_err {err:.3e} "
          f"(tol {TOL[dtype]:.0e}){body}", flush=True)
    if not err <= TOL[dtype]:
        fail(f"{name} {tag}: max_abs_err {err} > {TOL[dtype]}")
    return err


def _timed(sp, x, dtype, cost=None) -> dict:
    """Kernel, plain, library / yardstick times and the bounds of one bf16
    case: the bound over what the call needs, and (kernels 1 and 2, on a
    masked case) the dense bound (every position read)."""
    cost = cost or sp["cost"]
    nbytes, flops = cost(x)
    b_ms, b_by = bound(nbytes, flops, dtype)
    row = dict(ms=time_ms(lambda: sp["kernel"](x)),
               plain_ms=time_ms(lambda: sp["plain"](x)),
               library_ms=(time_ms(lambda: sp["library"](x))
                           if sp["library"] else None),
               bound_ms=b_ms, bound_by=b_by, bound_mb=nbytes / 1e6)
    if "kernel_bool_mask" in sp and x["mask"] is not None:
        row["ms_bool_mask"] = time_ms(lambda: sp["kernel_bool_mask"](x))
    if cost is _masked_cost:
        d_bytes, d_flops = _dense_cost(x)
        row["dense_bound_ms"], _ = bound(d_bytes, d_flops, dtype)
    if sp["yardstick"] is not None:
        fn, row["yardstick"] = sp["yardstick"]
        row["yardstick_ms"] = time_ms(lambda: fn(x))
    return row


def _print_times(name: str, row: dict) -> None:
    lib = (f"sdpa {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else
           f"{row['yardstick']} {row['yardstick_ms']:.4f} ms")
    extra = ""
    if "ms_bool_mask" in row:
        extra += f" ({row['ms_bool_mask']:.4f} ms with the bool-mask cast)"
    dense = ""
    if "dense_bound_ms" in row:
        dense = f"; dense bound {row['dense_bound_ms']:.4f} ms"
    print(f"[kernels] {name} bf16: kernel {row['ms']:.4f} ms{extra}, plain "
          f"{row['plain_ms']:.4f} ms, {lib}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {row['bound_mb']:.1f} MB){dense}", flush=True)


def phase_kernels() -> dict:

    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    results = {}
    for name, sp in _kernel_specs().items():
        row = {"name": name, "route": "cuda", "source": sp["source"],
               "replaces": sp["replaces"]}
        cases = [(torch.float32, None), (torch.bfloat16, None)]
        cases += sp.get("extra_cases", [])
        for dtype, tq in cases:
            make = sp["inputs"]
            x = make(dtype, gen, rng) if tq is None else make(dtype, gen,
                                                             rng, tq)
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            if tq is not None:
                tag += f" Tq={tq}"
            err = _check(name, tag, sp, x, dtype)
            if tq is not None:
                row[f"max_abs_err_f32_tq{tq}"] = err
                continue
            if dtype == torch.float32:
                row["max_abs_err_f32"] = err
                continue
            row.update(
                dtype="bfloat16",
                kv_dtype=str(x["k"].dtype).replace("torch.", ""),
                q_shape=list(x["q"].shape), kv_shape=list(x["k"].shape),
                max_abs_err=err, **_timed(sp, x, dtype))
            _print_times(name, row)
        for case, make, cost in sp.get("serving_cases", []):
            for dtype in (torch.float32, torch.bfloat16):
                x = make(dtype, gen, rng)
                tag = ("bf16" if dtype == torch.bfloat16 else "f32") + \
                    f" {case}"
                err = _check(name, tag, sp, x, dtype)
                if dtype == torch.float32:
                    row[f"{case}_max_abs_err_f32"] = err
                    continue
                sub = dict(q_shape=list(x["q"].shape),
                           kv_shape=list(x["k"].shape), max_abs_err=err,
                           **_timed(sp, x, dtype, cost))
                _print_times(f"{name} {case}", sub)
                row.update({f"{case}_{k}": v for k, v in sub.items()})
        for case, make in sp.get("held_cases", []):
            errs = []
            for dtype in (torch.float32, torch.bfloat16):
                tag = ("bf16" if dtype == torch.bfloat16 else "f32") + \
                    f" {case} (held)"
                errs.append(_check(name, tag, sp, make(dtype, gen, rng),
                                   dtype))
            row.setdefault("held_max_abs_err", {})[case] = errs
        results[name] = row
    results["int8_weight_matmul"] = _w8_kernel_row()
    results["paged_decode_attention_tp"] = _tp_kernel_row()
    _reset_counts()   # comparison launches do not count
    return results


# --- phase 3: kernel 4, kernel 3 per kv-head shard ---------------------------
TP_SOURCE = "ray_dynamic_batching_tpu_torch/csrc/paged_decode_attention.cu"
TP_REPLACES = "ray_dynamic_batching_tpu/ops/decode_attention.py:519"


def _tp_mesh(tp: int):
    """A mesh's shape as a rank's kernel wrapper reads it (no ranks are
    started: phase 3 launches each shard here)."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import Mesh

    return Mesh({"tp": tp}, ["cuda:0"] * tp)


def _tp_shard(x: dict, tp: int, r: int) -> dict:
    """Rank r's shard of a whole paged call: its query heads and kv heads
    (and their scales), each contiguous as a rank holds them; the table
    and lengths whole."""
    n = x["q"].shape[2] // tp
    kk = x["k"].shape[2] // tp
    out = dict(x, q=x["q"][:, :, r * n:(r + 1) * n].contiguous(),
               k=x["k"][:, :, r * kk:(r + 1) * kk].contiguous(),
               v=x["v"][:, :, r * kk:(r + 1) * kk].contiguous())
    for name in ("ks", "vs"):
        if name in x:
            out[name] = x[name][:, :, r * kk:(r + 1) * kk].contiguous()
    return out


def _tp_kernel_row() -> dict:
    """Kernel 4 at llama3_8b's shape (see the module docstring): the tp 2
    and 4 shards' launches, concatenated, bit-identical to one unsharded
    kernel-3 launch and within tolerance of the plain version, bf16, f32
    and int8 pools; one rank's shard timed at tp 4 and 2 beside its plain
    version, gather + SDPA and its bound."""
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec

    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.default_rng(4)
    row = {"name": "paged_decode_attention_tp", "route": "cuda",
           "source": TP_SOURCE, "replaces": TP_REPLACES, "library_ms": None}

    def scales(x):
        return dict(k_scale=x.get("ks"), v_scale=x.get("vs"))

    for kind, make in (("", _paged_inputs), ("int8 ", _int8_paged_inputs)):
        for dtype in (torch.float32, torch.bfloat16):
            x = make(dtype, gen, rng)
            args = (x["q"], x["k"], x["v"], x["table"], x["lengths"])
            whole = dec.paged_decode_attention(*args, **scales(x))
            plain = dec.paged_decode_attention_plain(*args, **scales(x))
            tag = kind + ("bf16" if dtype == torch.bfloat16 else "f32")
            for tp in (2, 4):
                out = dec.paged_decode_attention_tp(*args, tp=tp,
                                                    **scales(x))
                torch.cuda.synchronize()
                if out is None or not torch.equal(out, whole):
                    fail(f"kernel 4 {tag} tp={tp}: shards not bit-identical "
                         "to one unsharded launch")
                if not torch.isfinite(out.float()).all():
                    fail(f"kernel 4 {tag} tp={tp}: non-finite output")
                err = (out.float() - plain.float()).abs().max().item()
                print(f"[kernels] paged_decode_attention_tp {tag} tp={tp} "
                      f"q{tuple(x['q'].shape)} pools{tuple(x['k'].shape)}: "
                      f"bit-identical to the unsharded launch, max_abs_err "
                      f"{err:.3e} vs plain (tol {TOL[dtype]:.0e})",
                      flush=True)
                if not err <= TOL[dtype]:
                    fail(f"kernel 4 {tag} tp={tp}: max_abs_err {err}")
                key = ("int8_" if kind else "") + (
                    "max_abs_err" if dtype == torch.bfloat16
                    else "max_abs_err_f32") + f"_tp{tp}"
                row[key] = err
            if dtype != torch.bfloat16:
                continue
            for tp in (4, 2):
                sh = _tp_shard(x, tp, 0)
                mesh = _tp_mesh(tp)
                nbytes, flops = _paged_cost(sh)
                b_ms, b_by = bound(nbytes, flops, dtype)
                sub = dict(
                    q_shape=list(sh["q"].shape), kv_shape=list(sh["k"].shape),
                    ms=time_ms(lambda: dec.paged_decode_attention(
                        sh["q"], sh["k"], sh["v"], sh["table"],
                        sh["lengths"], mesh=mesh, **scales(sh))),
                    plain_ms=time_ms(lambda: dec.paged_decode_attention_plain(
                        sh["q"], sh["k"], sh["v"], sh["table"],
                        sh["lengths"], **scales(sh))),
                    bound_ms=b_ms, bound_by=b_by, bound_mb=nbytes / 1e6,
                    yardstick="gather + sdpa (3 calls)" if not kind else
                    "gather + dequantize + sdpa (7 calls)",
                    yardstick_ms=time_ms(lambda: _gather_sdpa(sh)))
                print(f"[kernels] paged_decode_attention_tp {kind}bf16 one "
                      f"rank's shard at tp={tp} q{tuple(sh['q'].shape)} "
                      f"pools{tuple(sh['k'].shape)}: kernel {sub['ms']:.4f} "
                      f"ms, plain {sub['plain_ms']:.4f} ms, "
                      f"{sub['yardstick']} {sub['yardstick_ms']:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)",
                      flush=True)
                if tp == 4 and not kind:
                    row.update(dtype="bfloat16", kv_dtype="bfloat16",
                               max_abs_err=row["max_abs_err_tp4"], **sub)
                else:
                    pre = ("int8_" if kind else "") + f"tp{tp}_"
                    row.update({pre + k: v for k, v in sub.items()})
    return row


# --- phase 3: the int8-weight GEMM (ops/quant_matmul.py) ---------------------
# llama3_8b's int8 products as phase 18 runs them: (role, N, K, period); q,
# k and v keep one scale per head_dim index (their flax kernel is [D, N,
# H]), the rest one per output feature. The MoE run's router and experts.
W8_LLAMA = (("q", 4096, 4096, 128), ("kv", 1024, 4096, 128),
            ("o", 4096, 4096, 4096), ("gate_up", 14336, 4096, 14336),
            ("down", 4096, 14336, 4096))
W8_HEAD = ("head", 128256, 4096, 128256)
W8_ROUTER = ("router", 4, 4096, 4)
# The rows of those products in phase 18's arms (rehearsed at these knobs
# and payloads): a decode step's 16 slots and prefill groups / chunks of
# 1-4 x 64 tokens; the head at a step and at the groups' taken rows; the
# experts at 16 slots x capacity 1 (a step) and 1-4 x 40 (the capacity of
# a 64-token row: ceil(2 x 64 / 4 x 1.25)).
W8_PROJ_M = (16, 64, 128, 192, 256)
W8_LOGITS_M = (2,)       # 18a's logits check: one decode step of 2 rows (f32)
W8_HEAD_M = (1, 2, 3, 4, 16)
W8_EXPERT_M = (16, 40, 80, 120, 160)
W8_TIMED = {"bf16": (16, 64, 256), "head": (4, 16)}
W8_SOURCE = "ray_dynamic_batching_tpu_torch/csrc/int8_weight_matmul.cu"
# No pallas_call: it stands for the XLA fusion of the dequant into the
# consuming matmul that the JAX engine's in-program dequantize relies on.
W8_REPLACES = "ray_dynamic_batching_tpu/engine/decode.py:934"


def _w8_key(M: int, codes, scale, act, weight_dtype, bias) -> tuple:
    """An int8 product's shape as phases 3 and 18 compare them: rows,
    codes [N, K], the scale period, both dtypes, a bias or none."""
    return ("int8_weight_matmul", (M, codes.shape[1]),
            (codes.shape[0], codes.shape[1], scale.numel()),
            str(act).removeprefix("torch."),
            str(weight_dtype).removeprefix("torch.") + ("+bias" if bias
                                                        else ""))


def _w8_cases() -> list:
    """(role, M, N, K, period, activations, weight dtype, timed) of every
    int8 product phase 18 launches, each once."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for role, N, K, period in W8_LLAMA:
        for M in W8_PROJ_M:
            cases.append((role, M, N, K, period, bf, bf,
                          M in W8_TIMED["bf16"]))
        for M in W8_PROJ_M + W8_LOGITS_M:
            cases.append((role, M, N, K, period, f32, f32, False))
    for M in W8_HEAD_M:
        cases.append(W8_HEAD[:1] + (M,) + W8_HEAD[1:]
                     + (f32, bf, M in W8_TIMED["head"]))
        cases.append(W8_HEAD[:1] + (M,) + W8_HEAD[1:] + (f32, f32, False))
    for role, N, K, period in W8_LLAMA[3:]:
        for M in W8_EXPERT_M:
            cases.append((f"expert_{role}", M, N, K, period, bf, bf, False))
    for M in W8_PROJ_M:
        cases.append(W8_ROUTER[:1] + (M,) + W8_ROUTER[1:] + (f32, bf, False))
    seen, out = set(), []
    for c in cases:
        if c[1:7] not in seen:
            seen.add(c[1:7])
            out.append(c)
    return out


def _w8_inputs(M, N, K, period, act, gen, weights: dict):
    """x [M, K] ~ N(0, 1) in ``act``; codes uniform in [-127, 127] and
    scales that keep |y| below ~2, made once per (N, K, period)."""
    if (N, K, period) not in weights:
        codes = torch.randint(-127, 128, (N, K), generator=gen,
                              device="cuda", dtype=torch.int8)
        scale = (torch.rand((period,), generator=gen, device="cuda") + 0.5) \
            * (0.5 / (127 * K ** 0.5))
        weights[(N, K, period)] = (codes, scale)
    codes, scale = weights[(N, K, period)]
    x = torch.randn((M, K), generator=gen, device="cuda").to(act)
    return x, codes, scale


def _w8_body(M: int, act, wd) -> str:
    """The body ``ops/quant_matmul`` launches for M rows of ``act``
    activations over ``wd`` weights (its ``BODIES``)."""
    if act == torch.bfloat16:
        return "prefill" if M > 16 else "decode"
    return "split3" if wd == torch.bfloat16 else "fma"


def _w8_ops(M, N, K, act, wd) -> tuple:
    """The operations behind an int8-weight product's bound, at the peak
    of the units the kernel runs them on: bf16 x on the tensor cores
    (2MNK at the bf16 peak); f32 x over bf16 weights (a bf16 model's
    head) on the tensor cores too, as three bf16 products (x split into
    hi + mid + lo); f32 x over f32 weights on the CUDA cores (f32 peak)."""
    if act == torch.float32 and wd == torch.bfloat16:
        return 3 * 2 * M * N * K, torch.bfloat16
    return 2 * M * N * K, act


def _w8_kernel_row() -> dict:
    """Phase 3's int8-weight cases: the kernel against its plain version at
    every product phase 18 launches (bf16 2e-2, f32 1e-4 — the same sums
    in another order), and at the timed ones its time beside the plain
    version (dequantize + ``F.linear``, the three-call yardstick too),
    ``torch.matmul`` on the bf16 (head: f32) weight — what the bf16
    deployment runs — and the bound: the code bytes (plus x, scales, y)
    at 3.35 TB/s against the products at their units' peak
    (:func:`_w8_ops`)."""
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(18)
    weights: dict = {}
    row = {"name": "int8_weight_matmul", "route": "cuda",
           "source": W8_SOURCE, "replaces": W8_REPLACES, "cases": []}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bodies: dict = {}
    for role, M, N, K, period, act, wd, timed in _w8_cases():
        x, codes, scale = _w8_inputs(M, N, K, period, act, gen, weights)
        _CHECKED.add(_w8_key(M, codes, scale, act, wd, None))
        before = dict(qm.launches_by_body)
        out = qm.int8_linear(x, codes, scale, weight_dtype=wd)
        torch.cuda.synchronize()
        body = [b for b, n in qm.launches_by_body.items() if n != before[b]]
        ref = qm.int8_linear_plain(x, codes, scale, weight_dtype=wd)
        err = (out.float() - ref.float()).abs().max().item()
        tag = (f"{role} x[{M}, {K}] codes[{N}, {K}] period {period} "
               f"{str(act)[6:]}/{str(wd)[6:]}")
        if body != [_w8_body(M, act, wd)]:
            fail(f"int8_weight_matmul {tag}: launched body {body}, expected "
                 f"{_w8_body(M, act, wd)}")
        bodies[body[0]] = bodies.get(body[0], 0) + 1
        if not torch.isfinite(out.float()).all():
            fail(f"int8_weight_matmul {tag}: non-finite output")
        if not err <= TOL[act]:
            fail(f"int8_weight_matmul {tag}: max_abs_err {err} > "
                 f"{TOL[act]}")
        errs[act] = max(errs[act], err)
        if not timed:
            continue
        w = qm.dequantize_rows(codes, scale, wd).to(act)
        nbytes = _nbytes(x, codes, scale) + M * N * x.element_size()
        b_ms, b_by = bound(nbytes, *_w8_ops(M, N, K, act, wd))
        case = dict(role=role, M=M, N=N, K=K, period=period,
                    dtype=str(act)[6:], weight_dtype=str(wd)[6:],
                    body=body[0], max_abs_err=err,
                    ms=time_ms(lambda: qm.int8_linear(
                        x, codes, scale, weight_dtype=wd)),
                    plain_ms=time_ms(lambda: qm.int8_linear_plain(
                        x, codes, scale, weight_dtype=wd)),
                    library_ms=time_ms(lambda: torch.matmul(x, w.T)),
                    bound_ms=b_ms, bound_by=b_by, bound_mb=nbytes / 1e6)
        del w
        row["cases"].append(case)
        print(f"[kernels] int8_weight_matmul {tag}: body {body[0]}, kernel "
              f"{case['ms']:.4f} ms, plain (dequantize + F.linear, 3 "
              f"calls) {case['plain_ms']:.4f} ms, torch.matmul on the "
              f"dequantized weight {case['library_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); max_abs_err "
              f"{err:.3e}", flush=True)
    print(f"[kernels] int8_weight_matmul: {len(_w8_cases())} shapes held "
          f"against the plain version (launches by body {bodies}), "
          f"max_abs_err f32 "
          f"{errs[torch.float32]:.3e} (tol {TOL[torch.float32]:.0e}), bf16 "
          f"{errs[torch.bfloat16]:.3e} (tol {TOL[torch.bfloat16]:.0e})",
          flush=True)
    head = next(c for c in row["cases"]
                if c["role"] == "gate_up" and c["M"] == 16)
    row.update({k: head[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err")},
               q_shape=[16, 4096], kv_shape=[14336, 4096],
               dtype="bfloat16", kv_dtype="int8",
               max_abs_err_f32=errs[torch.float32],
               yardstick="dequantize + F.linear (3 calls): the plain "
                         "version")
    del weights
    torch.cuda.empty_cache()
    return row


# --- phase 4: model parity --------------------------------------------------
def _counts() -> dict:
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul as qm

    return {"flash_attention": fl.launches,
            "flash_attention_bwd": fl.bwd_launches,
            "decode_attention": dec.launches,
            "paged_decode_attention": dec.paged_launches,
            "decode_attention_int8": dec.int8_launches,
            "paged_decode_attention_int8": dec.paged_int8_launches,
            "paged_decode_attention_tp": (dec.tp_paged_launches
                                          + dec.tp_paged_int8_launches),
            "int8_weight_matmul": qm.launches,
            **{f"int8_weight_matmul/{b}": n
               for b, n in qm.launches_by_body.items()},
            "plain": attention.plain_launches,
            # A TP rank whose query heads straddle a kv group gathers one
            # kv head a query head (no card path runs that layout: held
            # at 0 wherever a phase holds its counts).
            "kv_gather": attention.kv_gathers}


def _expect_only(tag: str, counts: dict, want: dict) -> None:
    """Every kernel count equals ``want`` (missing names: 0)."""
    got = {n: c for n, c in counts.items() if c or n in want}
    if got != want:
        fail(f"{tag}: launched {counts}, expected {want} and nothing else")


def _steady(tag: str) -> None:
    """No program was captured (or first run) after a warmup ended: the
    capture ledger's steady-state gate."""
    from ray_dynamic_batching_tpu_torch.utils.compile_ledger import (
        SteadyStateViolation,
        get_ledger,
    )

    try:
        get_ledger().check_steady()
    except SteadyStateViolation as e:
        fail(f"{tag}: {e}")


def _capture_line(tag: str, engines) -> str:
    """Captures, their seconds and the device memory reserved while
    capturing, per engine."""
    parts = []
    for e in engines:
        st = e.capture_stats()
        parts.append(f"{st['captures']} captures in {st['capture_s']:.2f} s, "
                     f"pool {st['pool_bytes'] / 1e6:.1f} MB")
    line = f"[{tag}] graphs per engine: " + "; ".join(parts)
    print(line, flush=True)
    return line


def _parity(model, tag: str) -> tuple:
    """Slab prefill + decode and paged chunks + decode through the kernels
    and through the plain versions (1e-3 apart), the paged logits also
    against the slab logits of the same prompts. Returns the kernel
    path's (slab, paged) logits."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    int8 = model.kv_dtype == torch.int8
    suffix = "_int8" if int8 else ""
    V = model.cfg.vocab_size
    rng = np.random.default_rng(0)

    def cuda_i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    # Slab: a 64-token prompt and a 50-token one, prefill then one step.
    tokens = rng.integers(0, V, (2, T))
    attn = np.ones((2, T), np.int32)
    attn[1, 50:] = 0
    nxt = cuda_i32(rng.integers(0, V, (2, 1)))
    active = torch.ones((2,), dtype=torch.bool, device="cuda")

    def run_slab(toks, mask, cap=S):
        with torch.inference_mode():
            cache = model.make_cache(2, cap)
            first, cache = model.prefill(cuda_i32(toks), cuda_i32(mask),
                                         cache)
            second, cache = model.decode_step(nxt, cache, active)
            return first.float(), second.float()

    _reset_counts()
    got_slab = run_slab(tokens, attn)
    _expect_only(f"parity {tag} slab", _counts(), {
        "flash_attention": 2, "decode_attention" + suffix: 2})
    with attention.plain_attention():
        want = run_slab(tokens, attn)
    errs = [(g - w).abs().max().item() for g, w in zip(got_slab, want)]
    scale = max(w.abs().max().item() for w in want)
    print(f"[parity] llama3_8b width, 2 layers, f32, {tag}: prefill logits "
          f"err {errs[0]:.3e}, decode logits err {errs[1]:.3e} (|logits| "
          f"max {scale:.2f}, tol {LOGIT_TOL:.0e})", flush=True)
    if not all(np.isfinite(errs)) or max(errs) > LOGIT_TOL:
        fail(f"parity {tag}: logits differ by {errs}")

    # Paged: row 0 a 72-token prompt as a W = 64 chunk and a W = 8 chunk,
    # row 1 a 50-token prompt in the first chunk (idle, all-sentinel
    # table, in the second); then one paged decode step. Pages shuffled.
    long_p = rng.integers(0, V, 72)
    pool = 2 * NP
    perm = rng.permutation(pool)
    table = np.full((2, NP), pool, np.int32)
    table[0, :1] = perm[:1]                  # 72 + 1 positions: one page
    table[1, :1] = perm[1:2]
    tok1 = np.zeros((2, T), np.int32)
    tok1[0] = long_p[:T]
    tok1[1, :50] = tokens[1, :50]
    idle = table.copy()
    idle[1] = pool

    def run_paged():
        with torch.inference_mode():
            cache = model.make_paged_cache(2, pool, PS, S)
            first_1, _ = model.prefill_chunk_paged(
                cuda_i32(tok1), cuda_i32(attn), cache, cuda_i32(table),
                cuda_i32([0, 0]), cuda_i32([T - 1, 49]))
            tok2 = np.zeros((2, 8), np.int32)
            tok2[0] = long_p[T:]
            first_0, _ = model.prefill_chunk_paged(
                cuda_i32(tok2), cuda_i32([[1] * 8, [0] * 8]), cache,
                cuda_i32(idle), cuda_i32([T, 0]), cuda_i32([7, 0]))
            cache.page_table = cuda_i32(table)
            cache.lengths = cuda_i32([72, 50])
            second, cache = model.decode_step_paged(nxt, cache, active)
            return (torch.stack([first_0[0], first_1[1]]).float(),
                    second.float())

    def run_slab_chunks():
        """The same two chunks and decode step on a slab cache through
        ``prefill_chunk`` (the long fill's program): every k/v row comes
        from the same products as the paged run's."""
        with torch.inference_mode():
            cache = model.make_cache(2, S)
            first_1, cache = model.prefill_chunk(
                cuda_i32(tok1), cuda_i32(attn), cache, 0, 49)
            tok2 = np.zeros((2, 8), np.int32)
            tok2[0] = long_p[T:]
            first_0, cache = model.prefill_chunk(
                cuda_i32(tok2), cuda_i32([[1] * 8, [0] * 8]), cache, T, 7)
            second, cache = model.decode_step(nxt, cache, active)
            return (torch.stack([first_0[0], first_1[1]]).float(),
                    second.float())

    _reset_counts()
    got_paged = run_paged()
    _expect_only(f"parity {tag} paged", _counts(), {
        "flash_attention": 2, "paged_decode_attention" + suffix: 4})
    with attention.plain_attention():
        want = run_paged()
    errs = [(g - w).abs().max().item() for g, w in zip(got_paged, want)]
    errs_chunks = [(g - w).abs().max().item()
                   for g, w in zip(got_paged, run_slab_chunks())]
    slab_toks = np.zeros((2, 72), np.int32)
    slab_toks[0] = long_p
    slab_toks[1, :50] = tokens[1, :50]
    slab_mask = np.ones((2, 72), np.int32)
    slab_mask[1, 50:] = 0
    slab = run_slab(slab_toks, slab_mask)
    errs_slab = [(g - w).abs().max().item() for g, w in zip(got_paged, slab)]
    print(f"[parity] paged, f32, {tag}: chunk logits err {errs[0]:.3e}, "
          f"decode logits err {errs[1]:.3e} vs plain; vs the slab path in "
          f"the same chunks {errs_chunks[0]:.3e} / {errs_chunks[1]:.3e}; "
          f"vs the slab path's one-shot prefill {errs_slab[0]:.3e} / "
          f"{errs_slab[1]:.3e}{' (not gated)' if int8 else ''} "
          f"(tol {LOGIT_TOL:.0e})", flush=True)
    # With int8 codes the one-shot prefill is not gated: its k/v come from
    # a [2, 72] product instead of [2, 64] + [2, 8] ones, f32 sums in
    # another order, and a value on a .5 code boundary rounds the other
    # way — one code flip moves these logits by ~2e-3 (measured on the
    # CPU at reduced width). The same-chunks run isolates the layouts.
    gated = errs + errs_chunks + ([] if int8 else errs_slab)
    if not all(np.isfinite(errs + errs_chunks + errs_slab)) or \
            max(gated) > LOGIT_TOL:
        fail(f"paged parity {tag}: logits differ by {errs} / {errs_chunks} "
             f"/ {errs_slab}")
    return got_slab, got_paged


def phase_parity() -> None:
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    runs = {}
    for kv_dtype, tag in ((None, "f32 cache"), (torch.int8, "int8 KV")):
        # The same seed: the same weights in both models.
        model = CausalLM(cfg, "llama3_8b_2layer", dtype=torch.float32,
                         device="cuda", seed=0, kv_dtype=kv_dtype)
        runs[tag] = _parity(model, tag)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    diffs = [(a - b).abs().max().item()
             for pair in zip(runs["int8 KV"], runs["f32 cache"])
             for a, b in zip(*pair)]
    print("[parity] int8 KV against the f32 cache, same weights and prompts "
          "(not gated): slab prefill / decode, paged chunk / decode logits "
          "differ by " + " / ".join(f"{d:.3e}" for d in diffs), flush=True)


# --- phases 5 to 8: serving through LLMDeployment ---------------------------
def _profile_report(prof, wall_s: float) -> None:
    """Device time by kernel and the device's busy share of the window."""
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"[profile] window {wall_s * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}"
          f"%), idle {100 - 100 * busy_us / 1e3 / (wall_s * 1e3):.1f}%",
          flush=True)
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:14]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def _serve(tag: str, payloads, dep_kwargs: dict, profile: bool):
    """Build a full-depth llama3_8b deployment, serve ``payloads`` with
    the launch counts zeroed just before, and return (results, counts,
    engine, wall seconds). The loop thread is stopped, the replica not."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    t0 = time.monotonic()
    dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                        **dep_kwargs)
    replica = dep.make_replica("llama3_8b-0",
                               DeploymentConfig(name="llama3_8b"))
    engine = replica.engine
    kv = "int8" if engine.model.kv_dtype == torch.int8 else "bf16"
    print(f"[{tag}] llama3_8b bf16 {engine.model.cfg.num_layers} layers, "
          f"{kv} KV cache, {engine.model.param_bytes() / 1e9:.2f} GB of "
          f"weights, replica built and warmed in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CUDA])
    with prof:
        _reset_counts()
        replica.start()
        t_start = time.monotonic()
        reqs = []
        for payload in payloads:   # arrival is stamped here, at assignment
            reqs.append(Request(model="llama3_8b", payload=payload,
                                slo_ms=600_000.0))
            if not replica.assign(reqs[-1]):
                fail(f"{tag}: replica refused a request")
        results = [r.future.result(timeout=600) for r in reqs]
        wall = time.monotonic() - t_start
        engine.stop()
        torch.cuda.synchronize()
        counts = _counts()
    if profile:
        _profile_report(prof, wall)
    V = engine.model.cfg.vocab_size
    for i, res in enumerate(results):
        if (len(res.tokens) != payloads[i]["max_new_tokens"]
                or res.finish_reason != "length"):
            fail(f"{tag} request {i}: {len(res.tokens)} tokens, "
                 f"{res.finish_reason}")
        if not all(0 <= t < V for t in res.tokens):
            fail(f"{tag} request {i}: token id out of vocab")
    return results, counts, engine, replica, wall


def _report(tag, results, counts, engine, wall) -> dict:
    ttfts = sorted(r.ttft_ms for r in results)
    n_tok = sum(len(r.tokens) for r in results)
    summary = dict(tok_s=n_tok / wall, ttft_p50_ms=statistics.median(ttfts),
                   ttft_max_ms=ttfts[-1])
    print(f"[{tag}] {len(results)} requests, {n_tok} tokens in {wall:.3f} s: "
          f"{summary['tok_s']:.1f} tok/s, TTFT p50 "
          f"{summary['ttft_p50_ms']:.1f} ms (max {ttfts[-1]:.1f} ms), "
          f"{engine.prefill_groups} prefill groups, {engine.chunk_dispatches}"
          f" chunk dispatches, {engine.long_chunk_dispatches} long-fill "
          f"chunks, {engine.steps} decode steps, launches {counts}",
          flush=True)
    print(f"[{tag}] TTFT parts {engine.ttft_breakdown()}", flush=True)
    return summary


def _payloads(rng, V, max_new, n_short, n_sampled, n_long) -> list:
    out = []
    for i in range(n_short + n_long):
        lo, hi = (40, 61) if i < n_short else (150, 301)
        prompt = rng.integers(0, V, int(rng.integers(lo, hi))).tolist()
        payload = {"tokens": prompt, "max_new_tokens": max_new}
        if n_short - n_sampled <= i < n_short:
            payload.update(temperature=0.8, top_k=50, seed=100 + i)
        out.append(payload)
    return out


# The serving knobs: 16 slots, max_len 512, one bucket of 64, groups of 4,
# horizon 8, 32 new tokens; paged: 128-token pages, a full-backing pool
# and a 256-token prefill budget.
SLAB_KNOBS = dict(num_slots=SLOTS, max_len=S, prompt_buckets=[T],
                  default_max_new_tokens=32, decode_horizon=8,
                  max_admissions_per_step=NB)
PAGED_KNOBS = dict(SLAB_KNOBS, paged=True, page_size=PS,
                   prefill_token_budget=256)


def _cache_bytes(engine) -> int:
    c = engine._cache
    return _nbytes(*[t for t in (c.k, c.v, c.k_scale, c.v_scale)
                     if t is not None])


DISPATCH_COUNTERS = ("steps", "prefill_groups", "long_chunk_dispatches",
                     "chunk_dispatches", "spec_rounds", "draft_catchups",
                     "draft_prefill_groups", "draft_chunk_dispatches")


def _dispatch_state(engine) -> dict:
    """The engine's dispatch counters, for :func:`_expect_dispatches` over
    one window of a longer-lived engine."""
    return {n: getattr(engine, n) for n in DISPATCH_COUNTERS}


def _expect_dispatches(tag: str, counts: dict, engine, since=None,
                       catchup_windows=None) -> None:
    """Each decode step (or speculative verify round) runs the arm's
    decode kernel once per layer; flash runs once per layer for each
    prefill group, long-fill chunk (monolithic arms) or chunk dispatch
    (chunked arms); every other kernel and the plain route never. With a
    draft (a slab, in its own KV dtype): its decode kernel once per
    draft layer for each of the k + 1 draft steps of a round and for
    each catch-up window of at most 8 rows (``catchup_windows``, by
    width, when the engine's horizons reach past 8: flash takes 16 and
    more), and flash once per draft layer for each draft prefill group
    and long-fill chunk. ``since`` (:func:`_dispatch_state`) counts from
    a point in the engine's life."""
    now = _dispatch_state(engine)
    d = {n: now[n] - (since or {}).get(n, 0) for n in now}
    L = engine.model.cfg.num_layers
    int8 = "_int8" if engine.model.kv_dtype == torch.int8 else ""
    decode = ("paged_decode_attention" if engine.paged
              else "decode_attention") + int8
    fills = (d["prefill_groups"] + d["long_chunk_dispatches"]
             + d["chunk_dispatches"])
    want = {decode: L * d["steps"], "flash_attention": L * fills}
    w8 = _w8_per_forward(engine.model)
    if w8:
        # Every target forward (a step, a fill, a verify round) runs each
        # int8 weight once (MoE experts once an expert).
        want["int8_weight_matmul"] = w8 * (d["steps"] + fills
                                           + d["spec_rounds"])
        # By body: bf16 activations take the decode body at a step's
        # slots (up to 16 rows) and the prefill body at every fill (64
        # rows and more) and verify window; f32 activations the split3
        # (bf16 weights: the head, the router) or fma body whatever the
        # rows.
        kinds = _w8_kinds(engine.model)
        step = "decode" if engine.num_slots <= 16 else "prefill"
        by_body = {b: 0 for b in ("prefill", "decode", "split3", "fma")}
        by_body[step] += kinds["bf16"] * d["steps"]
        by_body["prefill"] += kinds["bf16"] * (fills + d["spec_rounds"])
        for b in ("split3", "fma"):
            by_body[b] += kinds[b] * (d["steps"] + fills + d["spec_rounds"])
        want.update({f"int8_weight_matmul/{b}": n
                     for b, n in by_body.items() if n})
    if engine.draft_model is not None:
        if _w8_per_forward(engine.draft_model):
            # Also a self-draft of a quantized target, which shares its
            # int8 weights: no phase serves one.
            fail(f"{tag}: a quantized draft model is not counted here")
        Ld = engine.draft_model.cfg.num_layers
        ddec = "decode_attention" + (
            "_int8" if engine.draft_model.kv_dtype == torch.int8 else "")
        windows = catchup_windows or {1: d["draft_catchups"]}
        if sum(windows.values()) != d["draft_catchups"] or any(
                8 < h < 16 for h in windows):
            fail(f"{tag}: catch-up windows {windows} against "
                 f"{d['draft_catchups']} catch-ups")
        small = sum(n for h, n in windows.items() if h <= 8)
        want[ddec] = want.get(ddec, 0) + Ld * (
            (engine.spec_tokens + 1) * d["spec_rounds"] + small)
        want["flash_attention"] += Ld * (
            d["draft_prefill_groups"] + d["draft_chunk_dispatches"]
            + sum(n for h, n in windows.items() if h >= 16))
    if not all(want.values()):
        fail(f"{tag}: a kernel of the path never launched: {want}")
    _expect_only(tag, counts, want)


def _w8_kinds(model) -> dict:
    """int8-weight launches in one forward of ``model`` by activation
    dtype: ``bf16`` (the prefill and decode bodies), ``split3`` (f32 over bf16
    weights), ``fma`` (f32 over f32)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import Dense
    from ray_dynamic_batching_tpu_torch.models.moe import MoEBlock

    kinds = {"bf16": 0, "split3": 0, "fma": 0}

    def add(act, wd, n):
        kinds["bf16" if act == torch.bfloat16 else
              "split3" if wd == torch.bfloat16 else "fma"] += n

    for mod in model.module.modules():
        if isinstance(mod, Dense) and mod.weight_codes is not None:
            add(mod.dtype, mod.weight_dtype, 1)
        elif isinstance(mod, MoEBlock):
            add(mod.dtype, mod.weight_dtype, mod.num_experts * sum(
                getattr(mod, f"{w}_codes") is not None
                for w in mod.expert_names()))
    return kinds


def _w8_per_forward(model) -> int:
    """int8-weight launches in one forward of ``model``: each quantized
    Dense once, each quantized MoE expert tensor once an expert."""
    return sum(_w8_kinds(model).values())


def _serving_phase(tag: str, payloads, knobs: dict, profile: bool) -> tuple:
    """Serve ``payloads`` through a fresh deployment and hold every launch
    count to what the engine's dispatches imply (:func:`_expect_dispatches`).
    Returns (counts, cache bytes, tok/s and TTFT summary)."""
    gc.collect()
    torch.cuda.empty_cache()
    results, counts, engine, replica, wall = _serve(tag, payloads, knobs,
                                                    profile)
    _expect_dispatches(tag, counts, engine)
    # The two long prompts: chunks of T, as multi-chunk trains (chunked
    # arms) or through the long fill (monolithic arms).
    long_chunks = sum(-(-len(p["tokens"]) // T) for p in payloads
                      if len(p["tokens"]) > T)
    if engine.chunked_prefill and not engine.paged:
        # Slab trains: every prompt is a train of T-token chunks.
        chunks = sum(-(-len(p["tokens"]) // T) for p in payloads)
        if (engine.chunk_dispatches != chunks or engine.prefill_groups
                or engine.long_chunk_dispatches):
            fail(f"{tag}: {engine.chunk_dispatches} chunk dispatches, "
                 f"{engine.prefill_groups} prefill groups, "
                 f"{engine.long_chunk_dispatches} long-fill chunks; expected "
                 f"{chunks} chunk dispatches and nothing else")
    elif engine.chunked_prefill:
        # A multi-chunk train dispatches alone, once per chunk.
        if engine.chunk_dispatches < long_chunks:
            fail(f"{tag}: {engine.chunk_dispatches} chunk dispatches cannot "
                 f"have served the {long_chunks} chunks of the long prompts")
    elif engine.long_chunk_dispatches != long_chunks:
        fail(f"{tag}: {engine.long_chunk_dispatches} long-fill chunks, "
             f"expected {long_chunks}")
    if engine.paged:
        if engine.num_pages != POOL:
            fail(f"{tag}: pool of {engine.num_pages} pages, expected {POOL}")
        engine._allocator.check()
        if engine._allocator.free_pages != engine.num_pages:
            fail(f"{tag}: {engine._allocator.free_pages} of "
                 f"{engine.num_pages} pages free after the drain")
    _steady(tag)
    summary = _report(tag, results, counts, engine, wall)
    _capture_line(tag, [engine])
    summary["ttft_long_ms"] = [r.ttft_ms for p, r in zip(payloads, results)
                               if len(p["tokens"]) > T]
    if engine.paged:
        print(f"[{tag}] pool conserved: {engine.num_pages} of "
              f"{engine.num_pages} pages free after the drain", flush=True)
    nbytes = _cache_bytes(engine)
    print(f"[{tag}] KV cache {nbytes / 1e9:.3f} GB; "
          f"{engine.model.kv_bytes_per_slot(S) / 1e6:.1f} MB per slot at "
          f"max_len {S}", flush=True)
    replica.stop()
    return counts, nbytes, summary


# phase -> (launch-count path name, payloads of rng seed / long prompts,
# knobs): the int8 phases and slab_chunked serve phase 6's 10 requests.
SERVING = {
    "main": ("slab", 0, 0, SLAB_KNOBS),
    "paged": ("paged", 1, 2, PAGED_KNOBS),
    "int8": ("int8", 1, 2, dict(SLAB_KNOBS, quantize_kv=True)),
    "int8_paged": ("int8_paged", 1, 2, dict(PAGED_KNOBS, quantize_kv=True)),
    "slab_chunked": ("slab_chunked", 1, 2,
                     dict(SLAB_KNOBS, chunked_prefill=True)),
}


# --- phase 10: the front door ----------------------------------------------
def _answered(tag: str, fut, max_new: int):
    """A routed request's result: every request is answered with
    ``max_new`` tokens, none rejected."""
    try:
        res = fut.result(timeout=600)
    except Exception as e:  # noqa: BLE001 — a rejection fails the run
        fail(f"{tag}: request rejected or failed: {type(e).__name__}: {e}")
    if len(res.tokens) != max_new or res.finish_reason != "length":
        fail(f"{tag}: {len(res.tokens)} tokens, {res.finish_reason}")
    return res


def _post(proxy, path: str, payload: dict) -> tuple:
    """One POST through the proxy: (status, body text)."""
    conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


# --- flight records (phases 10, 12, 13) -------------------------------------
TRACE_DIR = "build/traces"


class _LoadRoots:
    """The load generator's own root span for each traced request: it
    opens before the request enters the serving path and closes when the
    request's future resolves. The generator originates the trace, as a
    client sending a W3C ``traceparent`` does, so the serving path's spans
    join it and a ledger's window is the request's latency as the client
    sees it. The roots stay with the generator; :meth:`spans` adds them
    to a capture."""

    NAME = "load.request"

    def __init__(self) -> None:
        self._roots: dict = {}
        self._lock = threading.Lock()

    def open(self, **attributes) -> dict:
        """A new root; returns the context its children join."""
        import random
        import uuid

        from ray_dynamic_batching_tpu_torch.utils.tracing import Span

        root = Span(name=self.NAME, trace_id=uuid.uuid4().hex,
                    span_id=random.getrandbits(63), parent_id=None,
                    start_ms=time.monotonic() * 1000.0,
                    attributes=dict(attributes))
        with self._lock:
            self._roots[root.trace_id] = root
        return root.context()

    def close_on(self, ctx: dict, fut) -> None:
        """Close the root when ``fut`` resolves."""
        root = self._roots[ctx["trace_id"]]

        def done(_f) -> None:
            root.end_ms = time.monotonic() * 1000.0

        fut.add_done_callback(done)

    def spans(self) -> list:
        with self._lock:
            return list(self._roots.values())


def _load_ledgers(tag: str, spans: list, loads: _LoadRoots,
                  cut_at: str | None = None) -> list:
    """The conserving hop ledger of every traced request whose root
    closed. With ``cut_at``, each root ends where its trace's span of
    that name ends (``decode.prefill``: the first token), so the ledger
    splits the TTFT. A ledger that does not conserve fails the phase."""
    from ray_dynamic_batching_tpu_torch.utils.hops import (
        LedgerError,
        request_ledgers,
    )

    roots = [r for r in loads.spans() if r.end_ms is not None]
    if cut_at is not None:
        ends = {s.trace_id: s.end_ms for s in spans if s.name == cut_at}
        roots = [dataclasses.replace(r, end_ms=ends[r.trace_id])
                 for r in roots if r.trace_id in ends]
    ids = {r.trace_id for r in roots}
    try:
        ledgers, _skipped = request_ledgers(list(spans) + roots,
                                            require_front_door=False)
    except LedgerError as e:
        fail(f"{tag}: a ledger does not conserve: {e}")
    return [l for l in ledgers if l.trace_id in ids]


def _hop_quantiles(ledgers: list) -> dict:
    """p50 / p95 (ms) of each hop over the ledgers, a ledger without the
    hop counting 0 ms, with the number of ledgers that have it; then the
    residual and the end-to-end."""
    from ray_dynamic_batching_tpu_torch.utils.hops import (
        HOP_ORDER,
        UNATTRIBUTED,
    )

    cols = {h: [l.hops.get(h, 0.0) for l in ledgers] for h in HOP_ORDER
            if any(h in l.hops for l in ledgers)}
    cols[UNATTRIBUTED] = [l.unattributed_ms for l in ledgers]
    cols["end_to_end"] = [l.end_to_end_ms for l in ledgers]
    return {h: dict(**_pcts(v), n=sum(1 for x in v if x > 0.0))
            for h, v in cols.items()}


def _print_hops(tag: str, label: str, ledgers: list) -> dict:
    q = _hop_quantiles(ledgers)
    worst = max(abs(sum(l.hops.values()) + l.unattributed_ms
                    - l.end_to_end_ms) for l in ledgers)
    print(f"[{tag}] {label}, {len(ledgers)} ledgers (every one conserves: "
          f"max |hops + unattributed - end to end| {worst:.2e} ms), p50 / "
          "p95 ms: " + "; ".join(
              f"{h} {v['p50']:.3f} / {v['p95']:.3f} ({v['n']})"
              for h, v in q.items()), flush=True)
    return q


def _write_trace(name: str, spans: list, journal=None) -> str:
    """The Chrome trace of a capture (with the page journal's lane when
    given) under ``build/traces/``."""
    import os

    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        to_chrome_trace,
    )

    os.makedirs(TRACE_DIR, exist_ok=True)
    path = f"{TRACE_DIR}/{name}.json"
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, journal=journal), f)
    return path


def _write_spans_jsonl(path: str, spans: list) -> str:
    """A capture as span JSONL (``utils/trace_export.FileSpanExporter``'s
    format, which the simulator's ``--spans`` and ``--hop-drift`` read)."""
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        FileSpanExporter,
    )

    os.makedirs(os.path.dirname(path), exist_ok=True)
    sink = FileSpanExporter(path)
    for span in spans:
        sink.export(span)
    sink.close()
    if sink.dropped:
        fail(f"{path}: {sink.dropped} spans not written")
    return path


def _pcts(values: list) -> dict | None:
    return (dict(p50=float(np.percentile(values, 50)),
                 p95=float(np.percentile(values, 95))) if values else None)


def _span_quantiles(values: list, unit: str = "ms") -> str:
    q = _pcts(values)
    return f"p50 {q['p50']:.3f} / p95 {q['p95']:.3f} {unit}" if q else "none"


def _get(proxy, path: str) -> str:
    """One GET through the proxy: the body text (200 or the run fails)."""
    conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET {path}: HTTP {resp.status}")
    return body


def phase_front(profile: bool) -> tuple:
    """Saturation, Poisson arrivals and HTTP through handle -> router ->
    replica, the launch counts zeroed just before and read just after.
    Returns (counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
        arrival_times,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )
    from ray_dynamic_batching_tpu_torch.serve.router import Router
    from ray_dynamic_batching_tpu_torch.utils.hops import (
        format_ledger_table,
        is_served,
    )
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    tag, max_new, duration_s = "front", 32, 5.0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                        **SLAB_KNOBS)
    replica = dep.make_replica(
        "llama3_8b#bench",
        DeploymentConfig(name="llama3_8b", max_ongoing_requests=4096))
    engine = replica.engine
    print(f"[{tag}] llama3_8b bf16 {engine.model.cfg.num_layers} layers "
          f"(slab + mono), replica built and warmed in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    V = engine.model.cfg.vocab_size
    rng = np.random.default_rng(2)

    def payload() -> dict:
        n = int(rng.integers(40, 61))
        return {"tokens": rng.integers(0, V, n).tolist(),
                "max_new_tokens": max_new}

    routes = ProxyRouter()
    proxy = HTTPProxy(routes, host="127.0.0.1", port=0)
    router = None
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = _profile(activities=[ProfilerActivity.CUDA])
    try:
        with prof:
            _reset_counts()
            t_window = time.monotonic()
            replica.start()
            router = Router("llama3_8b", replicas=[replica],
                            max_assign_timeout_s=30.0)
            handle = DeploymentHandle(router, default_slo_ms=300_000.0)
            routes.set_route("/api/llama3_8b", handle)
            proxy.start()

            # Saturation: every request at once.
            t_sat = time.monotonic()
            futs = [handle.remote(payload()) for _ in range(16)]
            sat = [_answered(f"{tag} saturation", f, max_new) for f in futs]
            sat_s = time.monotonic() - t_sat
            tok_s = sum(len(r.tokens) for r in sat) / sat_s
            capacity = tok_s / max_new
            print(f"[{tag}] saturation: 16 requests, {16 * max_new} tokens in "
                  f"{sat_s:.3f} s: {tok_s:.1f} tok/s, capacity "
                  f"{capacity:.2f} req/s", flush=True)

            # Poisson arrivals at 0.6 x capacity, each request traced:
            # the collector is installed for this window only.
            offered = 0.6 * capacity
            engine.reset_ttft_window()
            poisson_futs, hop_ms, seen_occ = [], [], []
            collector, loads = ChromeTraceCollector(), _LoadRoots()
            busy_at = {}    # trace id -> slots decoding as it arrived

            def submit(_model: str, _offset: float) -> None:
                p = payload()
                seen_occ.append(engine.kv_occupancy())
                ctx = loads.open(deployment="llama3_8b")
                busy_at[ctx["trace_id"]] = engine.active_slots
                with tracer().attach_context(ctx, "load.submit"):
                    t = time.perf_counter()
                    fut = handle.remote(p)
                    hop_ms.append((time.perf_counter() - t) * 1e3)
                loads.close_on(ctx, fut)
                poisson_futs.append(fut)

            pattern = RatePattern("constant", base_rps=offered)
            arrivals = len(list(arrival_times(pattern, duration_s, True, 7)))
            driver = WorkloadDriver(submit, "llama3_8b", pattern,
                                    duration_s=duration_s, poisson=True,
                                    seed=7)
            tracer().set_exporter(collector.export)
            try:
                driver.start()
                driver.join(duration_s + 60)
                if driver._thread.is_alive():
                    fail(f"{tag}: the workload driver did not finish")
                # The driver logs and skips a submit that raises: every
                # scheduled arrival must have been submitted.
                if driver.sent != arrivals or not arrivals:
                    fail(f"{tag}: {driver.sent} of {arrivals} arrivals "
                         "submitted")
                poisson = [_answered(f"{tag} poisson", f, max_new)
                           for f in poisson_futs]
                # decode.sequence is recorded just after each future
                # resolves.
                deadline = time.monotonic() + 10
                while (sum(s.name == "decode.sequence"
                           for s in collector.spans) < len(poisson)
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
            finally:
                tracer().reset()
            ttfts = sorted(r.ttft_ms for r in poisson)
            p50 = statistics.median(ttfts)
            p99 = ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))]
            breakdown = engine.ttft_breakdown()
            occupancy = engine.kv_occupancy()   # bench.py's read: drained
            occ_seen = statistics.mean(seen_occ)
            print(f"[{tag}] poisson @{offered:.2f} rps for {duration_s:.0f} s:"
                  f" {len(poisson)} of {driver.sent} requests answered, TTFT "
                  f"p50 {p50:.1f} ms p99 {p99:.1f} ms, handle + router hop "
                  f"p50 {statistics.median(hop_ms):.3f} ms (max "
                  f"{max(hop_ms):.3f}), TTFT parts {breakdown}, KV occupancy "
                  f"{occupancy:.4f} drained, {occ_seen:.4f} mean as each "
                  f"arrival saw it", flush=True)
            hops = _front_ledgers(tag, collector, loads, poisson, max_new,
                                  engine, busy_at, format_ledger_table,
                                  is_served)

            # HTTP: one buffered and one streamed request.
            code_b, body_b = _post(proxy, "/api/llama3_8b", payload())
            code_s, body_s = _post(proxy, "/api/llama3_8b",
                                   {**payload(), "stream": True})
            metrics_text = _get(proxy, "/metrics")
            front_door = _front_door_run(tag, handle, capacity, payload,
                                         max_new)
            wall = time.monotonic() - t_window
            engine.stop()
            torch.cuda.synchronize()
            counts = _counts()
    finally:
        proxy.stop()
        if router is not None:
            router.close()
        replica.stop(drain=False)
    if profile:
        _profile_report(prof, wall)
    if code_b != 200 or code_s != 200:
        fail(f"{tag}: HTTP {code_b} / {code_s}: {body_b[:200]} / "
             f"{body_s[:200]}")
    buffered = json.loads(body_b)["result"]["tokens"]
    lines = [json.loads(ln) for ln in body_s.splitlines() if ln]
    chunks = [ln["chunk"] for ln in lines if "chunk" in ln]
    finals = [ln["result"] for ln in lines if "result" in ln]
    if len(finals) != 1 or chunks != finals[0]["tokens"]:
        fail(f"{tag}: streamed chunks {chunks} against final {finals}")
    if len(buffered) != max_new or len(chunks) != max_new:
        fail(f"{tag}: HTTP answers of {len(buffered)} and {len(chunks)} "
             f"tokens, expected {max_new}")
    print(f"[{tag}] HTTP: buffered 200 ({len(buffered)} tokens), streamed "
          f"200 ({len(chunks)} chunks = the final line's tokens)", flush=True)
    families = ("rdb_decode_tokens_total", "rdb_decode_steps_total",
                "rdb_decode_prefills_total", "rdb_decode_ttft_ms_bucket")
    decode_lines = [ln for ln in metrics_text.splitlines()
                    if ln.startswith(families[:3])]
    missing = [f for f in families
               if not any(ln.startswith(f)
                          for ln in metrics_text.splitlines())]
    if missing:
        fail(f"{tag}: GET /metrics lacks the engine's families {missing}")
    print(f"[{tag}] GET /metrics: {'; '.join(decode_lines)}", flush=True)
    submitted = len(sat) + len(poisson) + 2 + front_door["admitted"]
    if router.total_routed != submitted:
        fail(f"{tag}: router routed {router.total_routed}, "
             f"{submitted} submitted")
    _expect_dispatches(tag, counts, engine)
    _steady(tag)
    print(f"[{tag}] {submitted} requests routed, none rejected, "
          f"{engine.prefill_groups} prefill groups, {engine.steps} decode "
          f"steps, launches {counts}", flush=True)
    numbers = dict(
        saturation_tok_s=tok_s, capacity_rps=capacity, offered_rps=offered,
        poisson_requests=len(poisson), ttft_p50_ms=p50, ttft_p99_ms=p99,
        ttft_breakdown=breakdown, kv_occupancy=occupancy,
        kv_occupancy_at_arrival=occ_seen,
        hop_p50_ms=statistics.median(hop_ms), hop_max_ms=max(hop_ms),
        routed=router.total_routed, http_buffered=code_b,
        http_streamed=code_s, hops=hops, front_door=front_door)
    return counts, numbers


# Phase 10's front-door run: shards of one FrontDoor, each the admission
# layer of its own HTTPProxy over the same deployment; the global budget a
# share of the capacity just measured, with a burst of ``burst_s`` of it,
# offered Poisson arrivals at ``offered_share`` of it.
FRONT_DOOR = dict(n_shards=2, gossip_interval_s=0.2, budget_share=0.5,
                  burst_s=1.0, offered_share=1.0, duration_s=5.0, seed=13)


class _TimedShard:
    """A front-door shard as a proxy's admission layer, stamping the
    time of each decision (the bound is taken at the last one)."""

    def __init__(self, shard) -> None:
        self.shard = shard
        self.last_s = 0.0

    def admit(self, deployment: str, tenant: str = "",
              qos_class: str = "standard") -> tuple:
        out = self.shard.admit(deployment, tenant, qos_class)
        self.last_s = max(self.last_s, time.monotonic())
        return out


def _front_door_run(tag: str, handle, capacity: float, payload,
                    max_new: int) -> dict:
    """Two ``HTTPProxy``s, each taking one shard of one
    ``FrontDoor(n_shards=2)`` as its admission, in front of the phase's
    deployment: Poisson arrivals split evenly over the two. Gated: the
    fleet admits no more than ``rate T + burst + (N - 1) rate staleness +
    N`` (``staleness`` the largest peer age the shards' ledgers showed);
    every admitted request is answered 200 with its tokens, every reject
    is a 429 with ``Retry-After``, nothing else comes back; ``stop()``
    leaves no gossip thread alive."""
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        arrival_times,
    )
    from ray_dynamic_batching_tpu_torch.serve.frontdoor import FrontDoor
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )

    c, dep = FRONT_DOOR, handle.deployment
    tag = f"{tag} front door"
    rate = c["budget_share"] * capacity
    burst = c["burst_s"] * rate
    offered = c["offered_share"] * capacity
    offsets = list(arrival_times(RatePattern("constant", base_rps=offered),
                                 c["duration_s"], True, c["seed"]))
    payloads = [payload() for _ in offsets]
    fd = FrontDoor(n_shards=c["n_shards"],
                   gossip_interval_s=c["gossip_interval_s"])
    fd.configure(dep, rate_rps=rate, burst=burst)
    gates = [_TimedShard(fd.shards[sid]) for sid in sorted(fd.shards)]
    routes = ProxyRouter()
    routes.set_route(f"/api/{dep}", handle)
    proxies = [HTTPProxy(routes, host="127.0.0.1", port=0, admission=g,
                         shard_id=g.shard.shard_id) for g in gates]
    results: list = [None] * len(offsets)
    staleness = [0.0]
    sampling = threading.Event()

    def sample() -> None:
        while not sampling.wait(0.02):
            now = time.monotonic()
            for shard in list(fd.shards.values()):
                ledger = shard.ledger(dep)
                if ledger is not None:
                    staleness[0] = max(staleness[0],
                                       ledger.peer_staleness_s(now))

    def send(i: int) -> None:
        proxy = proxies[i % len(proxies)]
        conn = http.client.HTTPConnection(proxy.host, proxy.port,
                                          timeout=600)
        try:
            conn.request("POST", f"/api/{dep}", body=json.dumps(payloads[i]),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            results[i] = (resp.status, resp.getheader("Retry-After"),
                          resp.read().decode(), i % len(proxies))
        except Exception as e:  # noqa: BLE001 — a lost request fails
            results[i] = (None, None, f"{type(e).__name__}: {e}",
                          i % len(proxies))
        finally:
            conn.close()

    senders = []
    sampler = threading.Thread(target=sample, daemon=True)
    try:
        for p in proxies:
            p.start()
        fd.start()
        sampler.start()
        t0 = time.monotonic()
        for i, offset in enumerate(offsets):
            delay = t0 + offset - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            senders.append(threading.Thread(target=send, args=(i,),
                                            daemon=True))
            senders[-1].start()
        for t in senders:
            t.join(600)
        wall_s = time.monotonic() - t0
    finally:
        sampling.set()
        if sampler.is_alive():
            sampler.join(5)
        fd.stop()
        for p in proxies:
            p.stop()
    gossip_alive = [t.name for t in threading.enumerate()
                    if t.name == "frontdoor-gossip" and t.is_alive()]
    if fd._thread is not None or gossip_alive:
        fail(f"{tag}: FrontDoor.stop() left {gossip_alive} alive")
    if any(t.is_alive() for t in senders):
        fail(f"{tag}: a request never returned")
    admitted = fd.true_admitted(dep)
    by_code: dict = {}
    ttfts, per_proxy = [], [dict(ok=0, rejected=0) for _ in proxies]
    for status, retry_after, body, k in results:
        by_code[status] = by_code.get(status, 0) + 1
        if status == 200:
            res = json.loads(body)["result"]
            if len(res["tokens"]) != max_new:
                fail(f"{tag}: an admitted request got {len(res['tokens'])}"
                     f" tokens, expected {max_new}")
            ttfts.append(res["ttft_ms"])
            per_proxy[k]["ok"] += 1
        elif status == 429:
            if not retry_after:
                fail(f"{tag}: a 429 without Retry-After: {body[:200]}")
            per_proxy[k]["rejected"] += 1
        else:
            fail(f"{tag}: HTTP {status}: {body[:200]}")
    if by_code.get(200, 0) != admitted:
        fail(f"{tag}: {by_code.get(200, 0)} answered 200, the shards "
             f"admitted {admitted}")
    budget = fd.budget(dep)
    horizon_s = max(g.last_s for g in gates) - budget.t0
    n = len(fd.shards)
    bound = (rate * horizon_s + burst + (n - 1) * rate * staleness[0] + n)
    shards = {sid: dict(admitted=s.admitted, rejected=s.rejected)
              for sid, s in sorted(fd.shards.items())}
    drift = fd.drift_audit(dep)
    ttfts.sort()
    p50 = statistics.median(ttfts) if ttfts else None
    p99 = ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))] if ttfts else None
    smi = _smi()
    print(f"[{tag}] {len(offsets)} Poisson arrivals at {offered:.2f} rps "
          f"over {c['duration_s']:.0f} s, split over {len(proxies)} proxies; "
          f"budget rate {rate:.2f} rps, burst {burst:.2f}; responses "
          f"{by_code}; per shard {shards}; per proxy {per_proxy}; admitted "
          f"{admitted} <= bound {bound:.2f} (rate x {horizon_s:.3f} s + "
          f"burst + {n - 1} x rate x staleness {staleness[0]:.3f} s + {n})"
          f"; gossip rounds {fd.gossip_rounds}; drift_audit {drift}; TTFT "
          f"of the admitted p50 {p50} ms p99 {p99} ms; wall {wall_s:.1f} s; "
          f"{smi}", flush=True)
    if admitted > bound:
        fail(f"{tag}: admitted {admitted} > bound {bound:.2f}")
    if not admitted or not by_code.get(429):
        fail(f"{tag}: the run admitted {admitted} and rejected "
             f"{by_code.get(429, 0)}: the budget was never exercised")
    return dict(arrivals=len(offsets), offered_rps=offered,
                budget_rps=rate, burst=burst, admitted=admitted,
                rejected=by_code.get(429, 0), shards=shards,
                proxies=per_proxy, bound=bound, horizon_s=horizon_s,
                staleness_s=staleness[0], gossip_rounds=fd.gossip_rounds,
                drift_audit=drift, ttft_p50_ms=p50, ttft_p99_ms=p99,
                wall_s=wall_s, card=smi)


def _front_ledgers(tag, collector, loads, poisson, max_new, engine, busy_at,
                   format_ledger_table, is_served) -> dict:
    """Phase 10's flight record: one ledger per Poisson request from its
    load root (submit -> answer) and one cut at its first token (the
    TTFT split), each conserving; the served ledgers must be the
    answered requests, each with one ``decode.prefill`` and a
    ``decode.sequence`` of ``max_new`` tokens. Prints the per-hop p50 /
    p95 of both; the queue wait split by whether every slot was decoding
    when the request arrived (``busy_at``: trace id -> slots decoding),
    beside the share of it spent waiting out an in-flight scan (the
    ``scan_wait_ms`` of its ``decode.prefill``); the slowest TTFT
    ledgers' rows and the engine's snapshot; and writes the Chrome trace
    under ``build/traces/``."""
    spans = collector.spans
    if collector.dropped:
        fail(f"{tag}: the collector dropped {collector.dropped} spans")
    full = _load_ledgers(tag, spans, loads)
    ttft = _load_ledgers(tag, spans, loads, cut_at="decode.prefill")
    served = [l for l in full if is_served(l)]
    prefills = [s for s in spans if s.name == "decode.prefill"]
    seqs = [s for s in spans if s.name == "decode.sequence"]
    traced = {l.trace_id for l in served}
    if (len(served) != len(poisson) or len(ttft) != len(poisson)
            or sorted(s.trace_id for s in prefills) != sorted(traced)
            or {s.trace_id for s in seqs} != traced
            or any(s.attributes["tokens"] != max_new for s in seqs)):
        fail(f"{tag}: {len(served)} served ledgers, {len(ttft)} TTFT "
             f"ledgers, {len(prefills)} decode.prefill and {len(seqs)} "
             f"decode.sequence spans for {len(poisson)} answered requests")
    turns: dict = {}       # horizon -> per-step ms of each decode.turn
    for s in spans:
        if s.name == "decode.turn":
            h = s.attributes["horizon"]
            turns.setdefault(h, []).append((s.end_ms - s.start_ms) / h)
    print(f"[{tag}] flight record of the Poisson window: {len(spans)} spans,"
          f" {len(served)} served ledgers = the answered requests; "
          "decode.turn by horizon (turns, ms a step p50 / p95): " + "; ".join(
              f"{h}: {len(v)}, {np.percentile(v, 50):.2f} / "
              f"{np.percentile(v, 95):.2f}" for h, v in sorted(turns.items())),
          flush=True)
    out = {"turns_by_horizon": {h: dict(n=len(v), **_pcts(v))
                                for h, v in sorted(turns.items())},
           "ttft": _print_hops(tag, "TTFT split by hop (load root cut at "
                               "the first token)", ttft),
           "request": _print_hops(tag, "whole request by hop (load root, "
                                  "submit -> answer)", served)}
    scan = {s.trace_id: s.attributes["scan_wait_ms"] for s in prefills}
    groups = {"a slot free": [], "every slot decoding": []}
    for l in ttft:
        full_at = busy_at[l.trace_id] >= engine.num_slots
        groups["every slot decoding" if full_at else "a slot free"].append(l)
    split = {}
    for label, ls in groups.items():
        wait = [l.hops.get("queue.wait", 0.0) for l in ls]
        sw = [scan[l.trace_id] for l in ls]
        split[label] = dict(n=len(ls), queue_wait=_pcts(wait),
                            scan_wait=_pcts(sw),
                            ttft=_pcts([l.end_to_end_ms for l in ls]))
        print(f"[{tag}] arrivals with {label}: {len(ls)}; queue.wait "
              f"{_span_quantiles(wait)}, of it waiting out a scan "
              f"{_span_quantiles(sw)}; TTFT "
              f"{_span_quantiles([l.end_to_end_ms for l in ls])}",
              flush=True)
    out["by_slots_at_arrival"] = split
    slow = sorted(ttft, key=lambda l: l.end_to_end_ms)[-8:]
    print(f"[{tag}] the 8 slowest TTFT ledgers (ms):\n"
          + format_ledger_table(slow), flush=True)
    print(f"[{tag}] engine snapshot {engine.snapshot()}", flush=True)
    snap = engine.snapshot().get("page_journal", {})
    path = _write_trace("front", spans + loads.spans(),
                        journal=snap.get("events"))
    print(f"[{tag}] Chrome trace written to {path}", flush=True)
    return out


# --- phase 11: the controller and the declarative entry points -------------
def _controller_run(front: dict | None) -> dict:
    """Deploy through ``apply_config``, then saturate, call over HTTP,
    read the status, redeploy in place, heal a wedged engine and roll to
    v2; shut everything down. Returns plain numbers only, so nothing of
    the phase outlives this call."""
    from ray_dynamic_batching_tpu_torch.serve import api as serve
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.schema import (
        ServeConfigSchema,
        apply_config,
    )

    tag, max_new, name = "controller", 32, "llama3_8b"
    rng = np.random.default_rng(11)

    def payload(n_new=max_new) -> dict:
        n = int(rng.integers(40, 61))
        out = {"tokens": rng.integers(0, 128256, n).tolist()}
        if n_new is not None:
            out["max_new_tokens"] = n_new
        return out

    built = {}      # replica id -> replica: every engine the window built

    def track(router) -> None:
        for r in router.replicas():
            built.setdefault(r.replica_id, r)

    config = ServeConfigSchema.from_dict({"applications": [{
        "name": "chat", "route_prefix": "/chat",
        "deployments": [{
            "name": name,
            "llm": {"model": name, "dtype": "bfloat16", "seed": 0,
                    **SLAB_KNOBS},
            "version": "v1", "max_ongoing_requests": 4096,
        }],
    }]})
    out = {}
    _reset_counts()
    t_phase = time.monotonic()
    try:
        # 1. Deploy: the module controller and proxy, as the README does.
        handle = apply_config(config)[name]
        ctl = serve._get_controller()
        router = ctl.get_router(name)
        track(router)
        out["deploy_s"] = time.monotonic() - t_phase
        print(f"[{tag}] apply_config deployed {name} (v1) on the module "
              f"controller (control interval {ctl.control_interval_s} s) in "
              f"{out['deploy_s']:.1f} s", flush=True)

        # 2. Saturation through the handle.
        t_sat = time.monotonic()
        futs = [handle.remote(payload()) for _ in range(16)]
        sat = [_answered(f"{tag} saturation", f, max_new) for f in futs]
        sat_s = time.monotonic() - t_sat
        out["saturation_tok_s"] = sum(len(r.tokens) for r in sat) / sat_s
        out["saturation_ttft_p50_ms"] = statistics.median(
            r.ttft_ms for r in sat)
        beside = ("" if front is None else
                  f"; phase 10 in this call: {front['saturation_tok_s']:.1f}"
                  " tok/s")
        print(f"[{tag}] saturation: 16 requests, {16 * max_new} tokens in "
              f"{sat_s:.3f} s: {out['saturation_tok_s']:.1f} tok/s, TTFT p50 "
              f"{out['saturation_ttft_p50_ms']:.1f} ms{beside}", flush=True)

        # 3. HTTP through the module proxy.
        proxy = serve.get_proxy()
        code_b, body_b = _post(proxy, "/chat", payload())
        code_s, body_s = _post(proxy, "/chat", {**payload(), "stream": True})
        if code_b != 200 or code_s != 200:
            fail(f"{tag}: HTTP {code_b} / {code_s}: {body_b[:200]} / "
                 f"{body_s[:200]}")
        buffered = json.loads(body_b)["result"]["tokens"]
        lines = [json.loads(ln) for ln in body_s.splitlines() if ln]
        chunks = [ln["chunk"] for ln in lines if "chunk" in ln]
        finals = [ln["result"] for ln in lines if "result" in ln]
        if len(finals) != 1 or chunks != finals[0]["tokens"]:
            fail(f"{tag}: streamed chunks {chunks} against final {finals}")
        if len(buffered) != max_new or len(chunks) != max_new:
            fail(f"{tag}: HTTP answers of {len(buffered)} and {len(chunks)} "
                 f"tokens, expected {max_new}")
        out["http"] = [code_b, code_s]
        print(f"[{tag}] HTTP /chat: buffered 200 ({len(buffered)} tokens), "
              f"streamed 200 ({len(chunks)} chunks = the final line's "
              "tokens)", flush=True)

        # 4. Status.
        st = serve.status()[name]
        stats = next(iter(st["replicas"].values()))
        if st["running_replicas"] != 1 or not {
                "active_slots", "decode_steps"} <= set(stats):
            fail(f"{tag}: status {st['running_replicas']} running, replica "
                 f"stats {sorted(stats)}")
        print(f"[{tag}] status: running_replicas 1, active_slots "
              f"{stats['active_slots']:.0f}, decode_steps "
              f"{stats['decode_steps']:.0f}, versions {st['versions']}",
              flush=True)

        # 5. Redeploy in place: same replica, the bound on every queue.
        replica = router.replicas()[0]
        ctl.deploy(DeploymentConfig(name=name, version="v1",
                                    max_ongoing_requests=128,
                                    user_config={"note": "redeploy"}))
        caps = [q.max_len for q in replica._queues.values()]
        if (router.replicas() != [replica]
                or replica.max_ongoing_requests != 128 or caps != [128]):
            fail(f"{tag}: redeploy rebuilt the replica or missed the queues:"
                 f" {replica.max_ongoing_requests}, queues {caps}")
        _answered(f"{tag} redeploy", handle.remote(payload()), max_new)
        print(f"[{tag}] redeploy in place: same replica "
              f"{replica.replica_id}, max_ongoing_requests 128 on the replica"
              f" and its {len(caps)} bucket queue(s); a request served",
              flush=True)

        # 6. Heal: wedge the engine, the control loop replaces the replica.
        probe = {"tokens": np.random.default_rng(48).integers(
            0, 128256, 48).tolist(), "max_new_tokens": max_new}
        before = _answered(f"{tag} probe", handle.remote(dict(probe)),
                           max_new).tokens
        victim = replica
        t_wedge = time.monotonic()
        victim.engine._run.clear()
        victim.engine.last_heartbeat -= 3600.0
        while True:
            reps = router.replicas()
            if reps and reps[0] is not victim and reps[0].healthy():
                break
            if time.monotonic() - t_wedge > 120:
                fail(f"{tag}: the wedged replica was not replaced in 120 s")
            time.sleep(0.05)
        replaced_s = time.monotonic() - t_wedge
        track(router)
        after = _answered(f"{tag} probe after heal",
                          handle.remote(dict(probe)), max_new).tokens
        out["heal_s"] = time.monotonic() - t_wedge
        out["heal_replaced_s"] = replaced_s
        if after != before:
            print(f"[{tag}] probe before the heal: {before}", flush=True)
            print(f"[{tag}] probe after the heal:  {after}", flush=True)
            fail(f"{tag}: the healed replica's greedy tokens differ")
        print(f"[{tag}] heal: {victim.replica_id} wedged, replaced by "
              f"{reps[0].replica_id} (healthy) in {replaced_s:.2f} s, serving "
              f"again {out['heal_s']:.2f} s after the wedge; the 48-token "
              f"probe gives the same {max_new} greedy tokens", flush=True)

        # 7. Rolling update to v2 while a 96-token generation decodes.
        old = reps[0]
        done_before = old.engine.completed
        inflight = handle.remote({**payload(None), "max_new_tokens": 96})
        deadline = time.monotonic() + 60
        while old.engine.active_slots == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        if old.engine.active_slots == 0:
            fail(f"{tag}: the 96-token generation never started decoding")
        v2 = LLMDeployment(name, model=old.engine.model, dtype=torch.bfloat16,
                           **dict(SLAB_KNOBS, default_max_new_tokens=40))
        t_roll = time.monotonic()
        ctl.deploy(DeploymentConfig(name=name, version="v2",
                                    max_ongoing_requests=4096), factory=v2)
        out["rollout_s"] = time.monotonic() - t_roll
        track(router)
        if not inflight.done():
            fail(f"{tag}: deploy(v2) returned before v1 drained")
        res = _answered(f"{tag} in-flight", inflight, 96)
        if old.engine.completed - done_before != 1:
            fail(f"{tag}: the in-flight request did not finish on v1")
        versions = serve.status()[name]["versions"]
        if versions != {"v2": 1}:
            fail(f"{tag}: versions {versions} after the rollout")
        fresh = _answered(f"{tag} v2 default", handle.remote(payload(None)),
                          40)
        print(f"[{tag}] rolling update: the 96-token generation finished on "
              f"{old.replica_id} (v1, {len(res.tokens)} tokens) through the "
              f"graceful drain; deploy(v2) took {out['rollout_s']:.2f} s; "
              f"versions {versions}; a request without max_new_tokens got "
              f"{len(fresh.tokens)} tokens", flush=True)
    finally:
        serve.shutdown()
    wall = time.monotonic() - t_phase
    torch.cuda.synchronize()
    counts = _counts()

    # Launches: 32 x (the dispatches the engines counted + their warmups).
    engines = [r.engine for r in built.values()]
    L = engines[0].model.cfg.num_layers
    fills = sum(e.prefill_groups + e.long_chunk_dispatches
                + e.chunk_dispatches for e in engines)
    steps = sum(e.steps for e in engines)
    warm_fills = sum(e.warmup_fills for e in engines)
    warm_steps = sum(e.warmup_steps for e in engines)
    if any(e.paged or e.chunked_prefill or e.model.kv_dtype == torch.int8
           or len(e.prompt_buckets) != 1 for e in engines):
        fail(f"{tag}: an engine off the slab + mono arm")
    want = {"flash_attention": L * (fills + warm_fills),
            "decode_attention": L * (steps + warm_steps)}
    _expect_only(tag, counts, want)
    _steady(tag)
    print(f"[{tag}] {len(engines)} engines built in the window "
          f"({', '.join(built)}): {fills} prefill dispatches + "
          f"{warm_fills} in warmups, {steps} decode steps + {warm_steps} in "
          f"warmups; launches {counts}; phase wall time {wall:.1f} s",
          flush=True)
    out.update(counts=counts, engines=len(engines), dispatches=fills,
               steps=steps, wall_s=wall)
    return out


def phase_controller(front: dict | None) -> tuple:
    """Phase 11; returns (counts, the phase's numbers)."""
    mem_before = _tensor_bytes_on_card()
    out = _controller_run(front)
    mem_after = _tensor_bytes_on_card()
    print(f"[controller] device memory held by tensors (cuBLAS workspaces "
          f"dropped): {mem_before / 1e9:.3f} GB before the phase, "
          f"{mem_after / 1e9:.3f} GB after the shutdown", flush=True)
    if abs(mem_after - mem_before) > 0.5e9:
        fail("controller: a replaced or retired engine was not released "
             f"({(mem_after - mem_before) / 1e9:.3f} GB more than before)")
    out.update(mem_before_gb=mem_before / 1e9, mem_after_gb=mem_after / 1e9)
    return out.pop("counts"), out


# --- phase 12: measured tables and Nexus colocation ------------------------
# The sweep, the sizing, the length buckets and the colocation traffic of
# phase 12 (llama3_8b, bf16, full width and depth; 16 slots where a count
# is pinned, capacity 512, prompt bucket 64, groups of 4, 32 new tokens).
# Each contract is offered 0.1 of the 16-slot row's full-occupancy
# throughput (halves of 12 s); 0.2 runs after it as a diagnostic, in
# halves of 6 s (both cut from 20 for the script's time limit): there the surged pair
# saturates the card although the packer admits it (PERF.md), since the
# planner's fraction counts decode steps at full occupancy and no
# prefill, while a co-tenant's partly filled step costs a whole step.
# A replan sees the surge when it reads llama_a at 1.5 x its first half.
COLOCATE = dict(
    model="llama3_8b", dtype=torch.bfloat16, capacity=S, bucket=T,
    slots=(4, 8, 16, 32), groups=(1, NB), timing_iters=8, warmup_iters=2,
    pinned=SLOTS, length_buckets=(256, S), long_prompt=300,
    contracts=("llama_a", "llama_b"), util=0.1, diagnostic_util=0.2,
    surge=2.0, surge_seen=1.5, half_s=12.0, diagnostic_half_s=6.0,
    headroom=0.85, monitoring_interval_s=2.0, rate_window_s=8.0,
    max_new=32, prompt=(40, 61), probe_len=48, seed=11, expect_auto=256,
)
PROFILES_DIR = "build/profiles_h100"
# What phase 13 leaves for phase 15: the gated run's recorded arrivals
# (every submitted arrival, WorkloadDriver(record_path=...)), what it
# served per model and half, and the traced window's spans as JSONL.
ARRIVALS_PATH = f"{PROFILES_DIR}/arrivals.jsonl"
SERVED_PATH = f"{PROFILES_DIR}/vision_served.json"
VISION_SPANS_PATH = f"{TRACE_DIR}/vision_spans.jsonl"


def _colocate_run(dev, budget: int, ttft_slo_ms: float, profiles_dir: str,
                  c: dict = COLOCATE) -> dict:
    """Profile the decode engine, size deployments from the table and
    from the budget, route two prompts through two length buckets, then
    serve two contracts colocated by ``pack_llm_engines`` under an
    ``LLMLiveScheduler`` through a rate surge, and hold a greedy probe of
    the colocated engine against a lone engine; then the same traffic at
    the diagnostic utilization. The config carries the
    budget and the control loop's timing for the run. Returns plain
    numbers only (the dispatches every engine and the profiler ran among
    them), so nothing of the run outlives this call."""
    from ray_dynamic_batching_tpu_torch.utils.config import (
        RDBConfig,
        reset_config,
        set_config,
    )

    set_config(RDBConfig.from_env(
        hbm_budget_bytes=budget,
        monitoring_interval_s=c["monitoring_interval_s"],
        rate_window_s=c["rate_window_s"]))
    try:
        return _colocate_body(dev, ttft_slo_ms, profiles_dir, c)
    finally:
        reset_config()


def _colocate_body(dev, ttft_slo_ms: float, profiles_dir: str,
                   c: dict) -> dict:
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.models import registry
    from ray_dynamic_batching_tpu_torch.profiles.decode_profiler import (
        DecodeProfiler,
    )
    from ray_dynamic_batching_tpu_torch.profiles.profiler import (
        write_profile_outputs,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        LLMSession,
        pack_llm_engines,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.config import get_config

    tag, name, cap = "colocate", c["model"], c["capacity"]
    cfg = get_config()
    out: dict = {"budget_bytes": cfg.hbm_budget_bytes}
    model = registry.get_model(name, dtype=c["dtype"], device=dev, seed=0)
    V = model.cfg.vocab_size
    engines, warmed = [], []   # every engine that dispatched in the run

    # 1. The sweep: decode (slots x capacity) and prefill (bucket x group).
    prof = DecodeProfiler(model, timing_iters=c["timing_iters"],
                          warmup_iters=c["warmup_iters"])
    decode, prefill = prof.sweep(slot_buckets=c["slots"], capacities=(cap,),
                                 prompt_buckets=(c["bucket"],),
                                 group_sizes=c["groups"])
    rows = decode.rows + prefill.rows
    for kind, table in (("decode", decode), ("prefill", prefill)):
        for r in table.rows:
            print(f"[{tag}] {kind} row: batch_size {r.batch_size}, seq_len "
                  f"{r.seq_len}, latency_ms {r.latency_ms:.3f}, "
                  f"latency_std_ms {r.latency_std_ms:.3f}, hbm_bytes "
                  f"{r.hbm_bytes}, compile_ms {r.compile_ms:.1f}", flush=True)
    if (len(decode.rows) != len(c["slots"])
            or len(prefill.rows) != len(c["groups"])
            or any(r.hbm_bytes <= 0 or r.latency_ms <= 0 for r in rows)):
        fail(f"{tag}: the sweep gave {len(decode.rows)} decode and "
             f"{len(prefill.rows)} prefill rows, or a zero row")
    paths = [write_profile_outputs(t, profiles_dir)[0]
             for t in (decode, prefill)]
    print(f"[{tag}] tables written: {', '.join(paths)}", flush=True)
    out["decode_rows"] = [dict(slots=r.batch_size, ms=r.latency_ms,
                               std_ms=r.latency_std_ms, hbm=r.hbm_bytes,
                               first_ms=r.compile_ms) for r in decode.rows]
    out["prefill_rows"] = [dict(group=r.batch_size, ms=r.latency_ms,
                                std_ms=r.latency_std_ms, hbm=r.hbm_bytes,
                                first_ms=r.compile_ms) for r in prefill.rows]
    prof_fills = len(prefill.rows) * prof.dispatches_per_config
    prof_steps = len(decode.rows) * prof.dispatches_per_config

    # 2. Sizing: the table plan and the budget's answer.
    pinned = decode.row_for(c["pinned"], cap)
    token_slo = cfg.slo_safety_factor * pinned.latency_ms * 2.0
    max_new = c["max_new"]
    knobs = dict(model=model, max_len=cap, prompt_buckets=[c["bucket"]],
                 default_max_new_tokens=max_new,
                 max_admissions_per_step=NB, token_slo_ms=token_slo,
                 ttft_slo_ms=ttft_slo_ms, profiles_dir=profiles_dir)
    sized = LLMDeployment(name, num_slots=0, **knobs)
    e = sized.build_engine(RequestQueue("sized"))
    plan = dict(num_slots=e.num_slots, decode_horizon=e.decode_horizon,
                ttft_horizon=e.ttft_horizon)
    e.release_buffers()
    auto = sized.auto_num_slots()
    out.update(token_slo_ms=token_slo, table_plan=plan, auto_num_slots=auto)
    print(f"[{tag}] token SLO {token_slo:.1f} ms (2 x slo_safety_factor "
          f"{cfg.slo_safety_factor} x the {c['pinned']}-slot step), TTFT "
          f"SLO {ttft_slo_ms:.0f} ms; LLMDeployment(num_slots=0) table plan "
          f"{plan}; auto_num_slots() on the same budget: {auto}",
          flush=True)
    if plan["num_slots"] not in {r.batch_size for r in decode.rows}:
        fail(f"{tag}: the table plan's {plan['num_slots']} slots is no "
             "measured row")
    if auto != c["expect_auto"]:
        fail(f"{tag}: auto_num_slots() {auto}, expected {c['expect_auto']}")

    # 3. Length buckets: one engine per bucket, the smallest that fits.
    rng = np.random.default_rng(c["seed"])
    lb = LLMDeployment(name, num_slots=c["pinned"],
                       length_buckets=list(c["length_buckets"]),
                       **{k: v for k, v in knobs.items()
                          if k not in ("profiles_dir", "token_slo_ms",
                                       "ttft_slo_ms")})
    replica = lb.make_replica(f"{name}-lb", DeploymentConfig(name=name))
    warmed += replica.engines.values()
    replica.start()
    small, large = sorted(replica.engines)
    lens = {small: int(rng.integers(*c["prompt"])), large: c["long_prompt"]}
    reqs = {b: Request(model=name, payload={
        "tokens": rng.integers(0, V, n).tolist(), "max_new_tokens": max_new},
        slo_ms=600_000.0) for b, n in lens.items()}
    for r in reqs.values():
        if not replica.assign(r):
            fail(f"{tag}: the length-bucket replica refused a request")
    for r in reqs.values():
        _answered(f"{tag} length bucket", r.future, max_new)
    deadline = time.monotonic() + 30
    while (sum(e.completed for e in replica.engines.values()) < 2
           and time.monotonic() < deadline):
        time.sleep(0.01)
    replica.stop()
    engines += replica.engines.values()
    done = {b: e.completed for b, e in replica.engines.items()}
    if any(n != 1 for n in done.values()):
        fail(f"{tag}: prompts of {lens[small]} and {lens[large]} tokens "
             f"left {done} completions by bucket, expected one each")
    print(f"[{tag}] length_buckets {sorted(replica.engines)}: a "
          f"{lens[small]}-token prompt reached the {small} engine, a "
          f"{lens[large]}-token prompt the {large} engine (+{max_new} new "
          "tokens each)", flush=True)
    out["length_buckets"] = {str(b): lens[b] for b in lens}

    # 4. Colocation: two contracts of one model, packed from the table,
    # at the gated utilization and then at the diagnostic one.
    budget = cfg.hbm_budget_bytes * cfg.hbm_plan_fraction
    slo_once = cfg.slo_safety_factor * pinned.latency_ms
    try:
        n = len(pack_llm_engines(
            [LLMSession(m, 1.0, slo_once) for m in c["contracts"]],
            {m: decode for m in c["contracts"]}, hbm_budget_bytes=budget,
            compute_headroom=c["headroom"]))
        at_once = f"{n} card(s) for the pair"
    except ValueError as e:
        at_once = f"no plan ({e})"
    print(f"[{tag}] at a token SLO of once slo_safety_factor x the "
          f"{c['pinned']}-slot step ({slo_once:.1f} ms) the packer needs "
          f"{at_once}", flush=True)
    out["slo_at_once"] = at_once
    runs = {}
    for label, util, half_s, gated in (
            ("gated", c["util"], c["half_s"], True),
            ("diagnostic", c["diagnostic_util"], c["diagnostic_half_s"],
             False)):
        run = _colocate_traffic(tag, c, util, half_s, model, decode, knobs,
                                token_slo, ttft_slo_ms, engines, warmed,
                                probe=gated, traced=not gated)
        runs[label] = _traffic_report(f"{tag} {label} {util}", c, run,
                                      decode, token_slo, budget, gated)
        if not gated:
            runs[label]["turns"] = _turn_report(f"{tag} {label} {util}",
                                                run)
    out.update(
        runs=runs,
        fills=prof_fills + sum(e.warmup_fills for e in warmed) + sum(
            e.prefill_groups + e.long_chunk_dispatches + e.chunk_dispatches
            for e in engines),
        steps=prof_steps + sum(e.warmup_steps for e in warmed) + sum(
            e.steps for e in engines),
        engines=len(engines), layers=model.cfg.num_layers)
    return out


def _colocate_traffic(tag, c, util, half_s, model, decode, knobs, token_slo,
                      ttft_slo_ms, engines, warmed, probe: bool,
                      traced: bool = False) -> dict:
    """Serve ``llama_a`` and ``llama_b`` colocated on the card under an
    ``LLMLiveScheduler``: each is offered ``util`` of the pinned row's
    full-occupancy throughput for one half of ``half_s`` seconds, then
    ``llama_a`` the surge multiple of it for the second. With ``probe``,
    a greedy probe goes through ``llama_a``'s colocated engine and a lone
    engine of its shape. With ``traced``, a collector is installed for
    the traffic and every request carries a trace context of its own; the
    record then holds the spans and each trace's contract. Appends every
    engine built to ``engines`` (and the warmed ones to ``warmed``), and
    returns the run's record."""
    import random
    import uuid

    from ray_dynamic_batching_tpu_torch.engine.colocate import (
        ColocatedLLMEngines,
    )
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.scheduler.llm_control import (
        LLMLiveScheduler,
        deployment_engine_factory,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    a, b = c["contracts"]
    cap, max_new, name = c["capacity"], c["max_new"], c["model"]
    V = model.cfg.vocab_size

    # Utilization of the pinned row's full-occupancy throughput, the row
    # the token SLO is set from. The host-bound rows are flat, so the
    # planner's row is the one with the least worst-case step and moves
    # with the rows' noise; a rate tied to it ranged 4x between calls, and
    # at its lowest a contract's 8 s window held no arrival and the
    # monitor drained it.
    row = decode.row_for(c["pinned"], cap)
    rate = util * 1000.0 * row.batch_size / row.latency_ms
    rates = {a: rate, b: rate}
    deployments = {m: LLMDeployment(name, num_slots=0, **knobs)
                   for m in (a, b)}
    build = deployment_engine_factory(deployments)

    def factory(m, placement, queue, device):
        engine = build(m, placement, queue, device)
        engine.warmup()          # attach-ready: a migration never serves cold
        warmed.append(engine)
        engines.append(engine)
        return engine

    chip = ColocatedLLMEngines(device=model.device, name="card0")
    sched = LLMLiveScheduler({a: decode, b: decode}, [chip], factory,
                             compute_headroom=c["headroom"])
    req_slo = ttft_slo_ms + max_new * token_slo
    for m in (a, b):
        sched.register_model(m, token_slo_ms=token_slo,
                             tokens_per_request=max_new)
    sent: dict = {}            # (contract, half) -> [request]
    colo_tokens = lone_tokens = None
    collector, contract_of = ChromeTraceCollector(), {}
    try:
        first = sched.rebalance(rates=rates)
        print(f"[{tag}] utilization {util}: offered {rate:.1f} tok/s each "
              f"({rate / max_new:.2f} req/s; of the {row.batch_size}-slot "
              f"row's {1000.0 * row.batch_size / row.latency_ms:.1f} tok/s)"
              "; plan: " + "; ".join(
                  f"{p.model} {p.num_slots} slots, f {p.compute_fraction:.3f}"
                  for chip_plan in first for p in chip_plan), flush=True)
        if len(first) != 1 or sorted(chip.models()) != [a, b]:
            fail(f"{tag}: the first plan does not colocate both contracts "
                 f"on the card: {[[p.model for p in x] for x in first]}")
        chip.start()
        sched.start_monitoring()
        if traced:
            tracer().set_exporter(collector.export)
        arr = np.random.default_rng(c["seed"])
        halves = []
        for half, mult in ((0, 1.0), (1, c["surge"])):
            events = []
            for m in (a, b):
                rps = rates[m] * (mult if m == a else 1.0) / max_new
                t = float(arr.exponential(1.0 / rps))
                while t < half_s:
                    events.append((t, m))
                    t += float(arr.exponential(1.0 / rps))
            events.sort()
            chip.reset_accounting()
            t_wall, t0 = time.time(), time.monotonic()
            for t, m in events:
                time.sleep(max(0.0, t0 + t - time.monotonic()))
                ctx = {}
                if traced:
                    ctx = {"trace_id": uuid.uuid4().hex,
                           "parent_span_id": random.getrandbits(63)}
                    contract_of[ctx["trace_id"]] = m
                req = Request(model=m, payload={
                    "tokens": arr.integers(
                        0, V, int(arr.integers(*c["prompt"]))).tolist(),
                    "max_new_tokens": max_new}, slo_ms=req_slo,
                    trace_ctx=ctx)
                sent.setdefault((m, half), []).append(req)
                sched.submit_request(req)
            time.sleep(max(0.0, t0 + half_s - time.monotonic()))
            plan_now = {p.model: p for x in sched._current_plan for p in x}
            halves.append(dict(
                start_wall=t_wall, busy=chip.busy_fractions(),
                planned={m: (p.num_slots, p.compute_fraction)
                         for m, p in plan_now.items()}))
        sched.stop_monitoring()
        results = {}
        for key, reqs_ in sent.items():
            results[key] = []
            for r in reqs_:
                try:
                    results[key].append(r.future.result(timeout=300))
                except Exception as e:  # noqa: BLE001 — counted, then fails
                    results[key].append(e)
        tracer().reset()
        if probe:   # llama_a's colocated engine against a lone engine
            toks = np.random.default_rng(48).integers(0, V, c["probe_len"])
            preq = Request(model=a, payload={"tokens": toks.tolist(),
                                             "max_new_tokens": max_new},
                           slo_ms=600_000.0)
            sched.submit_request(preq)
            colo_tokens = _answered(f"{tag} probe", preq.future,
                                    max_new).tokens
            served = chip.engine_for(a)
            lone = DecodeEngine(
                model, RequestQueue("lone"), num_slots=served.num_slots,
                max_len=served.max_len, prompt_buckets=served.prompt_buckets,
                default_max_new_tokens=max_new,
                decode_horizon=served.decode_horizon,
                ttft_horizon=served.ttft_horizon,
                max_admissions_per_step=served.max_admissions_per_step,
                device=model.device)
            lone.warmup()
            warmed.append(lone)
            lreq = Request(model=a, payload={"tokens": toks.tolist(),
                                             "max_new_tokens": max_new},
                           slo_ms=600_000.0)
            lone.queue.add_request(lreq)
            lone.run_until_idle(timeout_s=120)
            lone_tokens = _answered(f"{tag} lone probe", lreq.future,
                                    max_new).tokens
            lone.release_buffers()
            engines.append(lone)
        audit = sched.audit.to_dicts()
        stats = sched.queues.stats()
    finally:
        tracer().reset()
        sched.shutdown()
    return dict(util=util, rates=rates, req_slo=req_slo, sent=sent,
                results=results, halves=halves, audit=audit, stats=stats,
                probe=(colo_tokens, lone_tokens), spans=collector.spans,
                dropped_spans=collector.dropped, contract_of=contract_of)


def _turn_report(tag: str, run: dict) -> dict:
    """Each contract's ``decode.turn`` time per decode step (the turn's
    duration over its horizon) against the number of sequences active in
    the turn (a turn links to each of them, so its links name the
    contract), with the horizons it ran: what a step of each engine costs
    at each occupancy while the two share the card. Returns {contract:
    {active: {n, p50, p95}}} (ms)."""
    by: dict = {}
    horizons: dict = {}
    for s in run["spans"]:
        if s.name != "decode.turn":
            continue
        owners = {run["contract_of"].get(l["trace_id"]) for l in s.links}
        if len(owners) != 1 or None in owners:
            fail(f"{tag}: a decode.turn links to {owners}")
        (m,) = owners
        h = s.attributes["horizon"]
        by.setdefault(m, {}).setdefault(s.attributes["active"], []).append(
            (s.end_ms - s.start_ms) / h)
        horizons.setdefault(m, set()).add(h)
    out = {}
    for m in sorted(by):
        rows = {k: dict(n=len(v), **_pcts(v))
                for k, v in sorted(by[m].items())}
        out[m] = rows
        print(f"[{tag}] {m} decode.turn ms a step by active sequences "
              f"(horizons {sorted(horizons[m])}; turns, p50 / p95): "
              + "; ".join(f"{k}: {r['n']}, {r['p50']:.2f} / {r['p95']:.2f}"
                          for k, r in rows.items()), flush=True)
    if run["dropped_spans"]:
        print(f"[{tag}] the collector dropped {run['dropped_spans']} spans",
              flush=True)
    return out


def _replan(observed: dict, prev: list, decode, token_slo: float,
            budget: float, headroom: float) -> dict:
    """The plan ``LLMLiveScheduler.rebalance`` should apply for the rates
    it saw, from the packer alone: each contract's previous shape
    (``prev``, an audit record's placements) where that row alone still
    serves its rate, unless keeping them costs a card; else the packer's
    plan. Returns {contract: (slots, compute fraction)}."""
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        LLMSession,
        pack_llm_engines,
    )

    sessions = [LLMSession(m, r, token_slo)
                for m, r in observed.items() if r > 0]
    tables = {s.model: decode for s in sessions}

    def pack(t):
        return pack_llm_engines(sessions, t, hbm_budget_bytes=budget,
                                compute_headroom=headroom)

    plan, held = pack(tables), dict(tables)
    for s in sessions:
        shape = next(((p["slots"], p["capacity"]) for p in prev
                      if p["model"] == s.model), None)
        own = BatchProfile(decode.model_name, [
            r for r in decode.rows
            if (r.batch_size, r.seq_len) == shape and r.spec == "off"])
        try:
            pack_llm_engines([s], {s.model: own}, hbm_budget_bytes=budget,
                             compute_headroom=headroom)
        except ValueError:     # no such row, or it no longer serves
            continue
        held[s.model] = own
    kept = pack(held)
    return {p.model: (p.num_slots, p.compute_fraction)
            for chip in (kept if len(kept) <= len(plan) else plan)
            for p in chip}


def _traffic_report(tag, c, run, decode, token_slo, budget,
                    gated: bool) -> dict:
    """Print a colocation run: per contract and half, the plan beside the
    busy shares, the queues, the audit log, whether the scheduler saw the
    surge and what its replan did. With ``gated``, fail the phase on a
    stale or lost request, a surge no replan saw, a replan that applied
    another plan than the planner's for the rates it saw, or a probe that
    differs from the lone engine's; without it, fail only on a request
    that was never answered. Returns the run's numbers."""
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestStale
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        worst_latency_ms,
    )

    a, b = c["contracts"]
    halves, results, audit = run["halves"], run["results"], run["audit"]
    for h, half in enumerate(halves):
        for m in (a, b):
            res = results.get((m, h), [])
            done = [r for r in res if not isinstance(r, Exception)]
            ok = [r for r in done if r.total_ms <= run["req_slo"]]
            gaps = [(r.total_ms - r.ttft_ms) / max(1, len(r.tokens) - 1)
                    for r in done]
            half.setdefault("contracts", {})[m] = dict(
                sent=len(res), completed=len(done),
                stale=sum(isinstance(r, RequestStale) for r in res),
                dropped=sum(isinstance(r, Exception)
                            and not isinstance(r, RequestStale)
                            for r in res),
                slo_compliance=len(ok) / len(res) if res else 1.0,
                token_gap_p50_ms=statistics.median(gaps) if gaps else 0.0,
                ttft_p50_ms=statistics.median(r.ttft_ms for r in done)
                if done else 0.0)
        print(f"[{tag}] half {h + 1} ({'surge: ' + a + ' x' + str(c['surge']) if h else 'base'}): "
              + "; ".join(
                  f"{m} sent {s['sent']}, completed {s['completed']}, "
                  f"dropped {s['dropped']}, stale {s['stale']}, SLO "
                  f"compliance {s['slo_compliance']:.3f}, token gap p50 "
                  f"{s['token_gap_p50_ms']:.1f} ms, TTFT p50 "
                  f"{s['ttft_p50_ms']:.1f} ms"
                  for m, s in half["contracts"].items()), flush=True)
        print(f"[{tag}] half {h + 1}: planned (slots, compute fraction) "
              f"{ {m: (n, round(f, 3)) for m, (n, f) in half['planned'].items()} }"
              f", measured busy fractions "
              f"{ {m: round(f, 3) for m, f in half['busy'].items()} }",
              flush=True)
    stats = run["stats"]
    stale = {m: s["stale"] for m, s in stats.items()}
    print(f"[{tag}] queue totals: " + "; ".join(
        f"{m} enqueued {s['enqueued']:.0f}, completed {s['completed']:.0f},"
        f" dropped {s['dropped']:.0f}, stale {s['stale']:.0f}"
        for m, s in sorted(stats.items())), flush=True)
    for rec in audit:
        print(f"[{tag}] audit #{rec['seq']} {rec['trigger']} at "
              f"+{rec['wall_time'] - halves[0]['start_wall']:.1f} s: "
              f"rates {rec['observed'].get('rates_tok_s')}, placements "
              f"{rec['inputs'].get('placements')}, diff {rec['diff']}, "
              f"moved {rec['migration_cost']:.0f}"
              + (f", note: {rec['note']}" if rec["note"] else ""),
              flush=True)

    # The surge: a replan after it starts that saw llama_a's rate at
    # c["surge_seen"] times the first half's offered rate.
    base = run["rates"][a]
    after = [r for r in audit if r["trigger"] == "rate_change"
             and r["wall_time"] >= halves[1]["start_wall"]]
    seen = [r for r in after
            if r["observed"]["rates_tok_s"].get(a, 0.0)
            >= c["surge_seen"] * base]
    branch, moved_plan, agrees = "none", None, None
    if seen:
        last = seen[-1]
        observed = last["observed"]["rates_tok_s"]
        if "over capacity" in last["note"]:
            branch = "over capacity: kept the previous plan"
        elif "infeasible" in last["note"]:
            branch = "infeasible: kept the previous plan"
        else:
            placed = {p["model"]: (p["slots"], p["compute_fraction"])
                      for p in last["inputs"]["placements"]}
            branch = "applied on the same executor: " + ", ".join(
                f"{m} {n} slots, f {f}" for m, (n, f) in placed.items())
            prev = next(r["inputs"]["placements"]
                        for r in reversed(audit[:audit.index(last)])
                        if r["inputs"].get("placements"))
            want = _replan(observed, prev, decode, token_slo, budget,
                           c["headroom"])
            # The record rounds rates to 0.1 tok/s and fractions to 3
            # places, so a fraction may differ in its last place.
            agrees = (placed.keys() == want.keys() and all(
                placed[m][0] == want[m][0]
                and abs(placed[m][1] - want[m][1]) <= 2e-3 for m in want))
            before = halves[0]["planned"][a]
            moved_plan = placed.get(a, (0,))[0] != before[0]
            row = decode.row_for(placed[a][0], c["capacity"])
            terms = (f"on {placed[a][0]} slots its capacity term "
                     f"{observed[a] * row.latency_ms / (1000.0 * row.batch_size):.3f}"
                     f", its SLO term {worst_latency_ms(row) / token_slo:.3f}")
            branch += (f"; the surge moved {a} from {before[0]} to "
                       f"{placed[a][0]} slots ({terms})" if moved_plan else
                       f"; the surge left {a}'s row unchanged ({terms})")
            branch += ("; the planner gives the same plan for these rates"
                       " and the shapes it held" if agrees
                       else f"; the planner gives {want}")
        branch = (f"saw {a} at {observed[a]:.1f} tok/s (offered "
                  f"{base:.1f}, then {c['surge'] * base:.1f}): " + branch)
    print(f"[{tag}] {len(after)} replan(s) after the surge, {len(seen)} "
          f"saw {a} at >= {c['surge_seen']} x {base:.1f} tok/s; the last: "
          f"{branch}", flush=True)
    if any(x is not None for x in run["probe"]):
        print(f"[{tag}] probe: colocated {run['probe'][0]}", flush=True)
        print(f"[{tag}] probe: lone      {run['probe'][1]}", flush=True)
    unanswered = {k: sum(isinstance(r, TimeoutError) for r in v)
                  for k, v in results.items()}
    lost = {k: sum(isinstance(r, Exception)
                   and not isinstance(r, RequestStale) for r in v)
            for k, v in results.items()}
    if any(unanswered.values()) or sum(
            len(v) for v in run["sent"].values()) != sum(
            len(v) for v in results.values()):
        fail(f"{tag}: requests unanswered or unaccounted for: {unanswered}")
    if gated:
        if any(lost.values()) or any(stale.values()):
            fail(f"{tag}: requests dropped {lost}, stale {stale}")
        if not seen:
            fail(f"{tag}: no replan after the surge saw {a} at "
                 f"{c['surge_seen']} x its first-half rate")
        if agrees is False:
            fail(f"{tag}: the replan after the surge applied another plan "
                 "than the planner's for the rates it saw")
        if run["probe"][0] != run["probe"][1]:
            fail(f"{tag}: the colocated engine's greedy probe differs from "
                 "a lone engine's")
    return dict(
        util=run["util"], offered_tok_s=base,
        halves=[{k: v for k, v in h.items() if k != "start_wall"}
                for h in halves],
        replans_after_surge=len(after), saw_surge=len(seen), branch=branch,
        surge_moved_plan=moved_plan, stale=sum(stale.values()))


def _tensor_bytes_on_card() -> int:
    """Device memory held by live tensors once cuBLAS's GEMM workspaces
    are dropped: cuBLAS keeps one for each (thread, stream) a GEMM ran on
    — each new thread's first GEMM, each engine's capture stream — which
    the process keeps and reuses, not a leak of the phase's engines.
    Read only while no captured program is alive or running."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def phase_colocate() -> tuple:
    """Phase 12; returns (counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models import registry  # noqa: F401
    from ray_dynamic_batching_tpu_torch.models.base import _MODEL_SLOS

    mem_before = _tensor_bytes_on_card()
    budget = torch.cuda.get_device_properties(0).total_memory
    smi = _smi()
    print(f"[colocate] hbm_budget_bytes {budget} (the card's total memory; "
          f"{smi})", flush=True)
    _reset_counts()
    t0 = time.monotonic()
    out = _colocate_run(torch.device("cuda", 0), budget,
                        _MODEL_SLOS[COLOCATE["model"]].latency_slo_ms,
                        PROFILES_DIR)
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    counts = _counts()
    L = out.pop("layers")
    _expect_only("colocate", counts, {
        "flash_attention": L * out["fills"],
        "decode_attention": L * out["steps"]})
    _steady("colocate")
    mem_after = _tensor_bytes_on_card()
    print(f"[colocate] launches {counts} = {L} x ({out['fills']} prefill "
          f"dispatches, {out['steps']} decode steps) over the profiler, "
          f"{out['engines']} engines and their warmups; device memory held "
          f"by tensors (cuBLAS workspaces dropped) {mem_before / 1e9:.3f} GB "
          f"before the phase, {mem_after / 1e9:.3f} GB after the shutdown; "
          f"phase wall time {wall:.1f} s",
          flush=True)
    if mem_after - mem_before > 0.1e9:
        fail("colocate: a drained or replaced engine was not released "
             f"({(mem_after - mem_before) / 1e9:.3f} GB more than before)")
    out.update(mem_before_gb=mem_before / 1e9, mem_after_gb=mem_after / 1e9,
               wall_s=wall)
    return counts, out


# --- phase 13: the Nexus vision path ---------------------------------------
# The four vision servables at 224 x 224 (EfficientNet-V2-S profiles at its
# own 384), bf16, random weights from seed 0. Profile buckets are the
# reference's accelerator sweep (tools/run_profiles.py:41-44); the SLO run
# is tools/run_slo_demo.py's non-CPU shape (:52-58, :191-): its SLOs, its
# offered load (min(200, max(0.2, 0.010 x profiled peak throughput)) rps),
# one NHWC example per model, 60 s with resnet50's rate doubled at 30 s,
# three engines, the packer's 12 GiB budget and the scheduler's default
# config (monitor every 5 s, rate window 10 s, 5% threshold).
VISION = dict(
    parity=("resnet50", "shufflenet_v2", "efficientnet_v2s", "vit_b_16",
            "vit_g_14"),
    parity_batch=8, parity_size=224, parity_tol=1e-4, bf16_rel_tol=5e-2,
    buckets={
        "resnet50": [1, 8, 32, 64, 128, 256, 512, 1024],
        "shufflenet_v2": [1, 8, 32, 128, 256, 512, 1024, 2048],
        "efficientnet_v2s": [1, 8, 32, 64, 128, 256, 512],
        "vit_b_16": [1, 8, 16, 32, 64, 128, 256],
    },
    warmup_iters=2, timing_iters=4,
    workload=(("resnet50", 2000.0, 0.010, 2.0),
              ("shufflenet_v2", 1500.0, 0.010, 1.0),
              ("vit_b_16", 4000.0, 0.010, 1.0)),
    max_rps=200.0, min_rps=0.2, duration_s=30.0, engines=3,
    # The traced window after the gated run: its length, and every how
    # many arrivals one goes in traced.
    traced_s=5.0, traced_every=4,
    hbm_budget_bytes=12 << 30, gate=0.95, surge_seen=1.5,
    vit="vit_b_16", classes=1000,
    # Flash launches a forward (one a layer); the other models have none.
    flash_layers={"vit_b_16": 12, "vit_g_14": 48},
    # Timed apart from the sweep: not in the demo, so not in the SLO run.
    extra_buckets={"vit_g_14": [1, 32]},
)
COUNTER_FIELDS = ("completed", "violations", "stale", "dropped")


def _phase_compliance(start: dict, end: dict) -> dict:
    """tools/run_slo_demo.py's per-phase accounting: counter deltas, with
    stale and dropped requests counted as misses."""
    d = {k: end[k] - start[k] for k in COUNTER_FIELDS}
    accounted = d["completed"] + d["stale"] + d["dropped"]
    misses = d["violations"] + d["stale"] + d["dropped"]
    d["slo_compliance"] = 1.0 - misses / accounted if accounted else 1.0
    return d


def _vision_parity(c: dict) -> dict:
    """Each model in f32 on the card (TF32 off for convs and matmuls),
    batch 8: logits through the kernel route against the plain route; then
    the served bf16 model against that f32 forward."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    try:
        for name in c["parity"]:
            model = get_model(name, dtype=torch.float32,
                              image_size=c["parity_size"]).eval()
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (c["parity_batch"], c["parity_size"], c["parity_size"], 3)
            ).astype(np.float32)).cuda()
            before = fl.launches
            with torch.inference_mode():
                out = model(x)
                with attention.plain_attention():
                    ref = model(x)
            torch.cuda.synchronize()
            launched = fl.launches - before
            want = c["flash_layers"].get(name, 0)
            if tuple(out.shape) != (c["parity_batch"], c["classes"]) or not (
                    bool(torch.isfinite(out).all())):
                fail(f"vision parity {name}: logits {tuple(out.shape)} not "
                     f"finite [{c['parity_batch']}, {c['classes']}]")
            err = (out - ref).abs().max().item()
            print(f"[vision] parity {name} f32 batch {c['parity_batch']} at "
                  f"{c['parity_size']}: kernel route vs plain route max abs "
                  f"logit err {err:.3e} (max |logit| "
                  f"{ref.abs().max().item():.3f}; tol {c['parity_tol']:.0e}); "
                  f"flash launches {launched} (expected {want})", flush=True)
            if launched != want:
                fail(f"vision parity {name}: {launched} flash launches, "
                     f"expected {want}")
            if not err <= c["parity_tol"]:
                fail(f"vision parity {name}: {err} > {c['parity_tol']}")
            # The model as served (bf16, channels-last, cuDNN's bf16
            # convolutions) against the f32 forward of the same weights.
            served = get_model(name, image_size=c["parity_size"]).eval()
            with torch.inference_mode():
                low = served(x).float()
            scale = ref.abs().max().item()
            rel = (low - ref).abs().max().item() / scale
            print(f"[vision] parity {name} bf16 (served) vs f32: max abs "
                  f"logit err {rel * scale:.3e} = {rel:.3e} x max |logit| "
                  f"(tol {c['bf16_rel_tol']:.0e})", flush=True)
            if not rel <= c["bf16_rel_tol"]:
                fail(f"vision parity {name}: bf16 logits off the f32 "
                     f"forward by {rel:.3e} x max |logit|")
            errs[name] = {"route_f32": err, "bf16_vs_f32_rel": rel}
            del model, out, ref, served, low
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    _reset_counts()   # comparison launches do not count
    return errs


def _vision_profiles(c: dict, profiles_dir: str) -> dict:
    """``ModelProfiler`` over the reference's buckets for each model,
    written to ``profiles_dir``; returns name -> BatchProfile."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler

    out = {}
    for name, buckets in c["buckets"].items():
        t0 = time.monotonic()
        model = get_model(name).eval()
        profiler = ModelProfiler(model, warmup_iters=c["warmup_iters"],
                                 timing_iters=c["timing_iters"])
        prof = profiler.sweep(batch_buckets=buckets)
        if not prof.rows:
            fail(f"vision profile {name}: no feasible bucket")
        csv_path, _, _ = profiler.write_outputs(prof, profiles_dir)
        for r in prof.rows:
            r = r.with_throughput()
            print(f"[vision] profile {name} b={r.batch_size}: "
                  f"{r.latency_ms:.3f} ms (std {r.latency_std_ms:.3f}), "
                  f"{r.throughput_sps:.1f} img/s, hbm_bytes {r.hbm_bytes}, "
                  f"first dispatch {r.compile_ms:.1f} ms", flush=True)
        missing = sorted(set(buckets) - {r.batch_size for r in prof.rows})
        print(f"[vision] profile {name}: {len(prof.rows)} rows -> {csv_path}"
              f" (infeasible: {missing or 'none'}; "
              f"{time.monotonic() - t0:.1f} s)", flush=True)
        out[name] = prof
        del model, profiler
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _extra_profiles(c: dict) -> dict:
    """The models outside the SLO run, timed at a few buckets through
    ``ModelProfiler.profile_bucket`` and printed (nothing written)."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler

    out = {}
    for name, buckets in c["extra_buckets"].items():
        model = get_model(name).eval()
        profiler = ModelProfiler(model, warmup_iters=c["warmup_iters"],
                                 timing_iters=c["timing_iters"])
        rows = {}
        for b in buckets:
            r = profiler.profile_bucket(b)
            if r is None:
                fail(f"vision profile {name} b={b}: out of device memory")
            r = r.with_throughput()
            print(f"[vision] profile {name} b={b}: {r.latency_ms:.3f} ms "
                  f"(std {r.latency_std_ms:.3f}), {r.throughput_sps:.1f} "
                  f"img/s, hbm_bytes {r.hbm_bytes}, first dispatch "
                  f"{r.compile_ms:.1f} ms", flush=True)
            rows[b] = {"latency_ms": r.latency_ms,
                       "throughput_sps": r.throughput_sps,
                       "hbm_bytes": r.hbm_bytes}
        out[name] = rows
        del model, profiler
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _vision_slo_run(c: dict, profiles_dir: str) -> tuple:
    """run_slo_demo's live run on the card: profiles read back from
    ``profiles_dir`` -> ``SquishyBinPacker`` -> three ``ReplicaEngine``s
    under a ``LiveScheduler``, Poisson arrivals through a rate step.
    Returns (launch counts, the run's numbers)."""
    from ray_dynamic_batching_tpu_torch.engine import worker
    from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
    from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
    )
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
    from ray_dynamic_batching_tpu_torch.scheduler.control import (
        LiveScheduler,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        SquishyBinPacker,
    )

    names = [w[0] for w in c["workload"]]
    slos = {w[0]: w[1] for w in c["workload"]}
    profiles = {n: BatchProfile.from_csv(
        n, f"{profiles_dir}/{n}_summary.csv") for n in names}
    packer = SquishyBinPacker(profiles, hbm_budget_bytes=c["hbm_budget_bytes"])
    queues = QueueManager()
    host = ModelHost()
    engines = [worker.ReplicaEngine(f"card{i}", queues, host)
               for i in range(c["engines"])]
    sched = LiveScheduler(packer, engines, queues=queues)
    for n in names:
        sched.register_model(n, slo_ms=slos[n])
    example = {}   # one NHWC example per model (run_slo_demo.py:276-280)
    for n in names:
        (spec,) = get_model(n, device="meta", seed=None).input_shapes(1)
        example[n] = np.zeros(spec.shape[1:], np.float32)
    base = {n: min(c["max_rps"], max(c["min_rps"],
                                     util * profiles[n].max_throughput()))
            for n, _, util, _ in c["workload"]}
    mult = {n: m for n, _, _, m in c["workload"]}
    (surged,) = [n for n, m in mult.items() if m != 1.0]
    shift_at = c["duration_s"] / 2.0
    print(f"[vision] offered rps {({n: round(r, 2) for n, r in base.items()})}"
          f"; SLOs {slos} ms; shift at {shift_at:.0f} s: {surged} x "
          f"{mult[surged]}", flush=True)

    def batches(e, n):
        return worker.BATCHES_TOTAL.get(tags={"engine": e.engine_id,
                                              "model": n})

    b0 = {(e.engine_id, n): batches(e, n) for e in engines for n in names}
    depths: list = []            # (t_s, {model: queue depth}) every second
    sampling = threading.Event()

    def sample_depths(t_start: float) -> None:
        while not sampling.wait(1.0):
            depths.append((time.monotonic() - t_start,
                           {n: len(queues.queue(n)) for n in names}))

    _reset_counts()
    for e in engines:
        e.track_ratios = True
        e.start()
    drivers, snap_mid = [], None
    try:
        plans = sched.rebalance(rates=base)
        baseline = sched.schedule_changes
        for p in plans:
            print(f"[vision] plan: {p.describe()}", flush=True)
        initial = {e.engine_id: 0.0 for e in engines}
        deadline = time.monotonic() + 120
        while not set(names) <= {m for e in engines for m in e.models}:
            if time.monotonic() > deadline:
                fail("vision: engines never loaded the planned models")
            time.sleep(0.1)
        for e in engines:
            initial[e.engine_id] = sum(
                p.occupancy for p in e._schedule.placements)
            e.busy_ms = 0.0
            e.drain_ratios()
        sched.start_monitoring()

        def submit(model: str, _offset: float) -> None:
            sched.submit_request(Request(model=model, payload=example[model],
                                         slo_ms=slos[model]))

        os.makedirs(profiles_dir, exist_ok=True)
        open(ARRIVALS_PATH, "w").close()     # the drivers append to it
        drivers = [
            WorkloadDriver(submit, n, RatePattern(
                "step", base_rps=base[n], amplitude=base[n] * (mult[n] - 1.0),
                step_at_s=shift_at), duration_s=c["duration_s"],
                poisson=True, seed=17 + i, record_path=ARRIVALS_PATH)
            for i, n in enumerate(names)
        ]
        t0 = time.monotonic()
        for d in drivers:
            d.start()
        sampler = threading.Thread(target=sample_depths, args=(t0,),
                                   daemon=True)
        sampler.start()
        time.sleep(max(0.0, shift_at - (time.monotonic() - t0)))
        snap_mid = {n: dict(queues.queue(n).stats()) for n in names}
        for d in drivers:
            d.join(c["duration_s"] + 60)
        deadline = time.monotonic() + 60
        while (any(len(queues.queue(n)) > 0 for n in names)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        time.sleep(0.5)
        wall_s = time.monotonic() - t0
        last = {e.engine_id: sum(p.occupancy for p in e._schedule.placements)
                for e in engines}
        # The gated run's numbers, read before the traced window.
        sampling.set()
        ratios = {e.engine_id: e.drain_ratios() for e in engines}
        busy_ms = {e.engine_id: e.busy_ms for e in engines}
        ends = {n: queues.queue(n).stats() for n in names}
        served = {(e.engine_id, n): batches(e, n) - b0[(e.engine_id, n)]
                  for e in engines for n in names}
        schedule_log = list(sched.schedule_log)
        audit = sched.audit.to_dicts()
        traced = _vision_traced_window(
            c, sched, queues, names, example, slos,
            {n: base[n] * mult[n] for n in names}, profiles)
    finally:
        sampling.set()
        sched.stop_monitoring()
        for e in engines:
            e.stop()
    torch.cuda.synchronize()
    counts = _counts()
    layers = c["flash_layers"][c["vit"]]
    warmups = sum(1 for e in engines for k in e._warmed if k[0] == c["vit"])
    vit_batches = sum(v for (_, n), v in served.items() if n == c["vit"])
    vit_traced = sum(batches(e, c["vit"]) - b0[(e.engine_id, c["vit"])]
                     for e in engines) - vit_batches
    _expect_only("vision", counts, {
        "flash_attention": layers * (vit_batches + vit_traced + warmups)})

    out = {"offered_rps": base, "wall_s": wall_s, "models": {},
           "replans": [], "engines": {}, "traced": traced}
    worst = 1.0
    zero = {k: 0 for k in COUNTER_FIELDS}
    for d in drivers:
        n = d.model
        end = ends[n]
        p1 = _phase_compliance(zero, snap_mid[n])
        p2 = _phase_compliance(snap_mid[n], end)
        worst = min(worst, p1["slo_compliance"], p2["slo_compliance"])
        lost = d.sent - (end["completed"] + end["stale"] + end["dropped"])
        out["models"][n] = dict(
            sent=d.sent, completed=end["completed"], stale=end["stale"],
            dropped=end["dropped"], depth=end["depth"], lost=lost,
            phase1=p1, phase2=p2, p95_ms=end["latency_p95_ms"],
            p99_ms=end["latency_p99_ms"])
        print(f"[vision] {n}: sent {d.sent}, completed {end['completed']:.0f}"
              f", stale {end['stale']:.0f}, dropped {end['dropped']:.0f}, "
              f"unaccounted {lost:.0f}; compliance first half "
              f"{p1['slo_compliance']:.4f}, second half "
              f"{p2['slo_compliance']:.4f}; latency p95 "
              f"{end['latency_p95_ms']:.1f} ms, p99 "
              f"{end['latency_p99_ms']:.1f} ms", flush=True)
        if lost or end["depth"]:
            fail(f"vision: {n} has {lost:.0f} requests unaccounted for and "
                 f"{end['depth']:.0f} still queued")
    surge_seen = []
    for rec in schedule_log[baseline:]:
        t_s = rec["ts"] - t0
        rates = rec["rates"]
        out["replans"].append({"t_s": t_s, "rates": rates,
                               "nodes": rec["nodes"]})
        print(f"[vision] replan at {t_s:+.1f} s, rates "
              f"{({k: round(v, 2) for k, v in rates.items()})}: "
              f"{rec['nodes']}", flush=True)
        if t_s >= shift_at and (rates.get(surged, 0.0)
                                >= c["surge_seen"] * base[surged]):
            surge_seen.append(t_s)
    triggers = [a["trigger"] for a in audit]
    for e in engines:
        r = sorted(ratios[e.engine_id])
        busy = busy_ms[e.engine_id] / (wall_s * 1e3)
        out["engines"][e.engine_id] = dict(
            batches={n: served[(e.engine_id, n)] for n in names},
            busy_share=busy, planned_first=initial[e.engine_id],
            planned_last=last[e.engine_id],
            ratio_p50=r[len(r) // 2] if r else None,
            ratio_p95=r[int(0.95 * (len(r) - 1))] if r else None)
        print(f"[vision] engine {e.engine_id}: batches "
              f"{({n: served[(e.engine_id, n)] for n in names})}; busy "
              f"share {busy:.3f} against planned occupancy "
              f"{initial[e.engine_id]:.3f} (first plan), "
              f"{last[e.engine_id]:.3f} (last); step / profiled "
              f"bucket latency p50 "
              f"{out['engines'][e.engine_id]['ratio_p50']}, p95 "
              f"{out['engines'][e.engine_id]['ratio_p95']} over {len(r)} "
              f"steps", flush=True)
    out["depths"] = depths
    print(f"[vision] queue depth {surged} / all, every 5 s: " + ", ".join(
        f"{t_s:.0f} s {d[surged]} / {sum(d.values())}"
        for t_s, d in depths[4::5]), flush=True)
    low = {(n, h): out["models"][n][h]["slo_compliance"]
           for n in names for h in ("phase1", "phase2")
           if out["models"][n][h]["slo_compliance"] < c["gate"]}
    print(f"[vision] worst-phase compliance {worst:.4f} (gate {c['gate']}"
          f"; under it: {low or 'none'}); {surged} after the shift "
          f"{out['models'][surged]['phase2']['slo_compliance']:.4f}; "
          f"replan triggers {triggers}; replans after the "
          f"shift that saw {surged} >= {c['surge_seen']} x offered: "
          f"{len(surge_seen)}; launches {counts} = {layers} x "
          f"({vit_batches} {c['vit']} batches + {vit_traced} in the traced "
          f"window + {warmups} warm-ups); wall {wall_s:.1f} s", flush=True)
    out.update(worst_compliance=worst, triggers=triggers,
               surge_replans=len(surge_seen), vit_batches=vit_batches,
               vit_warmups=warmups)
    with open(SERVED_PATH, "w") as f:
        json.dump({"slo_ms": slos, "duration_s": c["duration_s"],
                   "shift_at_s": shift_at, "engines": c["engines"],
                   "arrivals": ARRIVALS_PATH,
                   "models": {n: {"sent": m["sent"],
                                  "phase1": m["phase1"]["slo_compliance"],
                                  "phase2": m["phase2"]["slo_compliance"]}
                              for n, m in out["models"].items()},
                   "traced": traced}, f, indent=1)
    if low:
        fail(f"vision: SLO compliance under {c['gate']}: {low}")
    if "rate_change" not in triggers[1:] or not surge_seen:
        fail(f"vision: no rate-change replan after the shift saw {surged}'s "
             "raised rate")
    return counts, out


def _vision_traced_window(c: dict, sched, queues, names, example, slos,
                          rates: dict, profiles: dict) -> dict:
    """After the gated SLO run, ``c["traced_s"]`` seconds more of Poisson
    arrivals at the rates of its second half with a collector installed.
    Every ``c["traced_every"]``-th arrival goes in under a load root and
    a ``handle.remote`` span whose context the request carries (as
    ``tools/run_slo_demo.py``'s ``_SchedulerHandle`` submits); the rest
    are submitted bare. Prints the traced requests' per-hop p50 / p95
    and, per model, ``collate.batch`` against the ``engine.step`` it
    runs in, and the step less its collate against the profiled row of
    the step's bucket; writes the Chrome trace under ``build/traces/``.
    Fails on a traced request not answered or a ledger that does not
    conserve."""
    import itertools

    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
    )
    from ray_dynamic_batching_tpu_torch.utils.hops import format_ledger_table
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    tag = "vision traced"
    collector, loads = ChromeTraceCollector(), _LoadRoots()
    counter = itertools.count()
    futs = []

    def submit(model: str, _offset: float) -> None:
        if next(counter) % c["traced_every"]:
            sched.submit_request(Request(model=model, payload=example[model],
                                         slo_ms=slos[model]))
            return
        ctx = loads.open(deployment=model)
        with tracer().attach_context(ctx, "handle.remote", deployment=model,
                                     lane=model):
            req = Request(model=model, payload=example[model],
                          slo_ms=slos[model],
                          trace_ctx=tracer().inject_context())
            sched.submit_request(req)
        loads.close_on(ctx, req.future)
        futs.append(req.future)

    drivers = [WorkloadDriver(submit, n, RatePattern("constant",
                                                     base_rps=rates[n]),
                              duration_s=c["traced_s"], poisson=True,
                              seed=71 + i)
               for i, n in enumerate(names)]
    before = {n: dict(queues.queue(n).stats()) for n in names}
    tracer().set_exporter(collector.export)
    try:
        for d in drivers:
            d.start()
        for d in drivers:
            d.join(c["traced_s"] + 60)
        for f in futs:
            try:
                f.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — a lost request fails
                fail(f"{tag}: a traced request failed: "
                     f"{type(e).__name__}: {e}")
        deadline = time.monotonic() + 60
        while (any(len(queues.queue(n)) > 0 for n in names)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        time.sleep(0.5)
    finally:
        tracer().reset()
    spans = collector.spans
    if collector.dropped:
        fail(f"{tag}: the collector dropped {collector.dropped} spans")
    window = {k: sum(queues.queue(n).stats()[k] - before[n][k]
                     for n in names) for k in COUNTER_FIELDS}
    jsonl = _write_spans_jsonl(VISION_SPANS_PATH, spans + loads.spans())
    waits = sum(1 for s in spans if s.name == "queue.wait")
    ledgers = _load_ledgers(tag, spans, loads)
    if len(ledgers) != len(futs):
        fail(f"{tag}: {len(ledgers)} ledgers for {len(futs)} traced "
             "requests")
    print(f"[{tag}] {c['traced_s']:.0f} s at {({n: round(r, 2) for n, r in rates.items()})}"
          f" rps: {sum(d.sent for d in drivers)} arrivals, {len(futs)} "
          f"traced, {len(spans)} spans", flush=True)
    print(f"[{tag}] queue.wait spans {waits} (every popped request's, "
          f"traced or not) for {window['completed']:.0f} completed, "
          f"{window['stale']:.0f} stale, {window['dropped']:.0f} dropped; "
          f"spans written to {jsonl}", flush=True)
    out = {"sent": sum(d.sent for d in drivers), "traced": len(futs),
           "queue_wait_spans": waits, "spans_jsonl": jsonl,
           **{f"window_{k}": v for k, v in window.items()},
           "hops": _print_hops(tag, "request by hop (load root, submit -> "
                               "answer)", ledgers), "models": {}}
    slow = sorted(ledgers, key=lambda l: l.end_to_end_ms)[-5:]
    print(f"[{tag}] the 5 slowest traced requests (ms):\n"
          + format_ledger_table(slow), flush=True)
    steps = {s.span_id: s for s in spans if s.name == "engine.step"}
    collates: dict = {}
    for s in spans:
        if s.name == "collate.batch" and s.parent_id in steps:
            collates[s.parent_id] = s
    for n in names:
        mine = [s for s in steps.values() if s.attributes["model"] == n]
        step_ms = [s.end_ms - s.start_ms for s in mine]
        coll_ms = [collates[s.span_id].end_ms - collates[s.span_id].start_ms
                   for s in mine if s.span_id in collates]
        share = sum(coll_ms) / sum(step_ms) if step_ms else 0.0
        # The step less its collate over the profiled row of its bucket.
        rest = [(s.end_ms - s.start_ms
                 - (collates[s.span_id].end_ms - collates[s.span_id].start_ms)
                 ) / profiles[n].latency_ms(s.attributes["batch_bucket"])
                for s in mine if s.span_id in collates]
        out["models"][n] = dict(
            steps=len(mine), collate_share=share, step_ms=_pcts(step_ms),
            collate_ms=_pcts(coll_ms), rest_over_profiled=_pcts(rest))
        print(f"[{tag}] {n}: {len(mine)} engine.step spans, "
              f"{_span_quantiles(step_ms)}; collate.batch inside them "
              f"{_span_quantiles(coll_ms)}; collate {share:.3f} of the "
              "steps' time; the step less its collate over the profiled "
              f"row of its bucket {_span_quantiles(rest, unit='x')} (buckets "
              f"{sorted({s.attributes['batch_bucket'] for s in mine})})",
              flush=True)
    path = _write_trace("vision", spans + loads.spans())
    print(f"[{tag}] Chrome trace written to {path}", flush=True)
    return out


def phase_vision() -> tuple:
    """Phase 13; returns (counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models import registry  # noqa: F401

    t0 = time.monotonic()
    errs = _vision_parity(VISION)
    profiles = _vision_profiles(VISION, PROFILES_DIR)
    extra = _extra_profiles(VISION)
    counts, out = _vision_slo_run(VISION, PROFILES_DIR)
    out.update(parity_max_abs_err=errs, wall_phase_s=time.monotonic() - t0,
               profiled={n: len(p.rows) for n, p in profiles.items()},
               extra_profiles=extra)
    print(f"[vision] phase wall time {out['wall_phase_s']:.1f} s",
          flush=True)
    return counts, out


# --- phase 14: the captured programs, graphed against eager -----------------
def _host() -> str:
    """The host's CPU model and core count: host-bound numbers move with
    them, so they stand beside the card's (``lscpu``'s model name, which
    also names CPUs whose ``/proc/cpuinfo`` carries none)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    names = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
             if ln.startswith("Model name")]
    return (f"{' / '.join(names) or platform.machine()}, "
            f"nproc {os.cpu_count()}")


def _graph_parity(model, arm: str, knobs: dict, payloads,
                  tag: str | None = None) -> dict:
    """One arm's engine, warmed and serving ``payloads`` twice: every
    program eager (``graphs.disable_capture()``), then captured. Greedy
    tokens must be identical and the launch counts equal."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import graphs

    tag = tag or f"graphs parity {arm}"
    runs = {}
    for mode in ("eager", "graphed"):
        ctx = (graphs.disable_capture() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            queue = RequestQueue(arm, max_len=64)
            engine = DecodeEngine(model, queue, device="cuda", **knobs)
            engine.warmup()
        reqs = [Request(model=arm, payload=p, slo_ms=600_000.0)
                for p in payloads]
        _reset_counts()
        for r in reqs:
            queue.add_request(r)
        engine.run_until_idle(timeout_s=300)
        torch.cuda.synchronize()
        runs[mode] = dict(tokens=[r.future.result(5).tokens for r in reqs],
                          counts=_counts(), stats=engine.capture_stats())
        if mode == "graphed":
            _expect_dispatches(tag, runs[mode]["counts"], engine)
            _steady(tag)
        engine.release_buffers()
    greedy = [i for i, p in enumerate(payloads)
              if not p.get("temperature")]
    same = [runs["eager"]["tokens"][i] == runs["graphed"]["tokens"][i]
            for i in range(len(payloads))]
    st = runs["graphed"]["stats"]
    print(f"[{tag}] greedy tokens identical on {sum(same[i] for i in greedy)}"
          f" of {len(greedy)} requests, sampled on "
          f"{sum(same) - sum(same[i] for i in greedy)} of "
          f"{len(payloads) - len(greedy)} (not gated); launches eager "
          f"{runs['eager']['counts']}, graphed {runs['graphed']['counts']}; "
          f"{st['captures']} captures ({st['graphs']})", flush=True)
    if not all(same[i] for i in greedy):
        fail(f"{tag}: greedy tokens differ between eager and graphed")
    if runs["eager"]["counts"] != runs["graphed"]["counts"]:
        fail(f"{tag}: launch counts differ between eager and graphed")
    if not st["captures"] or runs["eager"]["stats"]["captures"]:
        fail(f"{tag}: captures eager {runs['eager']['stats']}, graphed {st}")
    return {"greedy_identical": True, "captures": st["captures"],
            "counts": runs["graphed"]["counts"]}


def _speed_run(tag: str, model, payloads, knobs: dict, eager: bool):
    """One full-depth deployment (eager or graphed) serving ``payloads``
    twice: once with a span collector (tok/s, TTFT, ``decode.turn`` a
    step by horizon) and once under ``torch.profiler`` (CUDA activity
    only; the device's busy share of the window)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import graphs
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    with graphs.disable_capture() if eager else contextlib.nullcontext():
        dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                            model=model, **knobs)
        replica = dep.make_replica(f"llama3_8b-{tag}",
                                   DeploymentConfig(name="llama3_8b"))
    engine = replica.engine
    build_s = time.monotonic() - t0
    replica.start()

    def serve():
        t = time.monotonic()
        reqs = [Request(model="llama3_8b", payload=p, slo_ms=600_000.0)
                for p in payloads]
        for r in reqs:
            if not replica.assign(r):
                fail(f"{tag}: replica refused a request")
        res = [r.future.result(timeout=600) for r in reqs]
        return res, time.monotonic() - t

    collector = ChromeTraceCollector()
    _reset_counts()
    tracer().set_exporter(collector.export)
    try:
        results, wall = serve()
    finally:
        tracer().reset()
    torch.cuda.synchronize()
    counts = _counts()
    _expect_dispatches(tag, counts, engine)
    before = _dispatch_state(engine)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = serve()
        torch.cuda.synchronize()
    prof_dispatch = {n: v - before[n] for n, v in _dispatch_state(engine).items()}
    engine.stop()
    _steady(tag)
    if engine.paged:
        engine._allocator.check()
        if engine._allocator.free_pages != engine.num_pages:
            fail(f"{tag}: {engine._allocator.free_pages} of "
                 f"{engine.num_pages} pages free after the drain")
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    by_kernel = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                        for e in rows), key=lambda r: -r[2])
    turns: dict = {}
    for sp in collector.spans:
        if sp.name == "decode.turn":
            h = sp.attributes["horizon"]
            turns.setdefault(h, []).append((sp.end_ms - sp.start_ms) / h)
    ttfts = sorted(r.ttft_ms for r in results)
    n_tok = sum(len(r.tokens) for r in results)
    for i, r in enumerate(results):
        if (len(r.tokens) != payloads[i]["max_new_tokens"]
                or r.finish_reason != "length"):
            fail(f"{tag} request {i}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    st = engine.capture_stats()
    out = dict(
        tok_s=n_tok / wall, ttft_p50_ms=statistics.median(ttfts),
        ttft_max_ms=ttfts[-1],
        turn_ms_a_step_p50={h: statistics.median(v)
                            for h, v in sorted(turns.items())},
        turns={h: len(v) for h, v in sorted(turns.items())},
        busy_ms=busy_ms, window_ms=prof_wall * 1e3,
        idle_share=(1.0 - busy_ms / (prof_wall * 1e3)) if rows else None,
        kernel_rows=len(rows), by_kernel=by_kernel,
        prof_dispatch=prof_dispatch,
        captures=st["captures"],
        capture_s=st["capture_s"], pool_mb=st["pool_bytes"] / 1e6,
        build_and_warm_s=build_s, counts=counts,
        tokens=[r.tokens for r in results])
    replica.stop()
    return out


def phase_graphs() -> tuple:
    """Phase 14: graphed against eager. Parity (gated): llama3_8b at full
    width, 2 layers, f32, phase 6's 10 requests on the slab, paged, int8,
    int8-paged and slab-train arms. Speed (printed, not gated): llama3_8b
    at full width, SPEED_LAYERS deep, bf16, phase 5's 8 requests on the slab arm
    and phase 6's 10 on the paged arm, eager then graphed. Returns (the
    graphed speed runs' launch counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = _smi()
    host = _host()
    print(f"[graphs] {smi}; host {host}", flush=True)
    V = LLAMA3_8B.vocab_size
    payloads = _payloads(np.random.default_rng(1), V, 32, 8, 2, 2)
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    parity = {}
    arms = {None: (("slab", SLAB_KNOBS), ("paged", PAGED_KNOBS),
                   ("slab_chunked", dict(SLAB_KNOBS, chunked_prefill=True))),
            torch.int8: (("int8", SLAB_KNOBS),
                         ("int8_paged", PAGED_KNOBS))}
    for kv_dtype, cases in arms.items():
        model = CausalLM(cfg, "llama3_8b_2layer", dtype=torch.float32,
                         device="cuda", seed=0, kv_dtype=kv_dtype)
        for arm, knobs in cases:
            parity[arm] = _graph_parity(model, arm, knobs, payloads)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    model = _speed_model(device="cuda")
    speed, counts = {}, {}
    for arm, knobs, load in (
            ("slab", SLAB_KNOBS,
             _payloads(np.random.default_rng(0), V, 32, 8, 2, 0)),
            ("paged", PAGED_KNOBS, payloads)):
        for mode in ("eager", "graphed"):
            run = _speed_run(f"graphs {arm} {mode}", model, load, knobs,
                             eager=mode == "eager")
            speed[f"{arm}_{mode}"] = run
            run.pop("tokens")
            run.pop("by_kernel")
            if mode == "graphed":
                for name, n in run["counts"].items():
                    counts[name] = counts.get(name, 0) + n
        e, g = speed[f"{arm}_eager"], speed[f"{arm}_graphed"]

        def turn(r):
            return " / ".join(f"{r['turn_ms_a_step_p50'][h]:.2f}"
                              f" (h{h}, {r['turns'][h]})"
                              for h in r["turn_ms_a_step_p50"])

        def idle(r):
            return ("not traced" if r["idle_share"] is None
                    else f"{100 * r['idle_share']:.1f}%")

        print(f"[graphs] {arm} ({smi}; {host}), eager | graphed: tok/s "
              f"{e['tok_s']:.1f} | {g['tok_s']:.1f}; TTFT p50 "
              f"{e['ttft_p50_ms']:.1f} | {g['ttft_p50_ms']:.1f} ms (max "
              f"{e['ttft_max_ms']:.1f} | {g['ttft_max_ms']:.1f}); "
              f"decode.turn ms a step p50 by horizon (turns) {turn(e)} | "
              f"{turn(g)}; device idle {idle(e)} | {idle(g)} (busy "
              f"{e['busy_ms']:.1f} of {e['window_ms']:.1f} ms | "
              f"{g['busy_ms']:.1f} of {g['window_ms']:.1f} ms, "
              f"{e['kernel_rows']} | {g['kernel_rows']} kernel rows); "
              f"graphed engine: {g['captures']} captures in "
              f"{g['capture_s']:.2f} s, pool {g['pool_mb']:.1f} MB, built "
              f"and warmed in {g['build_and_warm_s']:.1f} s (eager "
              f"{e['build_and_warm_s']:.1f} s)", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(card=smi, host=host, parity=parity, speed=speed)


# --- phase 15: the simulator on the card's own tables ------------------------
# The demo's contracts as phase 13 serves them, for the sim's CLI.
SIM_MODEL_ARGS = ("--model", "resnet50=2000", "--model", "shufflenet_v2=1500",
                  "--model", "vit_b_16=4000")
SIM_OUT_DIR = "build/sim"


def _sim_cli(tag: str, argv: list) -> tuple:
    """The simulator's CLI (``python -m ray_dynamic_batching_tpu_torch.sim``)
    in-process: (exit code, its standard output)."""
    import io

    from ray_dynamic_batching_tpu_torch.sim.__main__ import main as sim_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sim_main(argv)
    print(f"[{tag}] sim {' '.join(argv)} -> exit {rc}", flush=True)
    return rc, buf.getvalue()


def _sim_smoke() -> dict:
    """(a) ``--smoke``: the reference arm gates every check of the
    reference's smoke, the port arm determinism and the floors; the port
    arm's occupancy comparisons are printed, not gated."""
    rc, text = _sim_cli("sim smoke", ["--smoke"])
    lines = text.splitlines()
    summary = json.loads(lines[0])
    for arm in ("reference", "port"):
        a = summary[arm]
        print(f"[sim smoke] {arm} arm (headroom {a['rate_headroom']}): "
              f"batch {a['slo_attainment']}, migrations {a['migrations']}, "
              f"chips {a['chips_used']}, completed {a['completed']}; slot "
              f"{a['occupancy_model']['slot_attainment']}, completed "
              f"{a['occupancy_model']['completed']}; deterministic "
              f"{a['deterministic']} / "
              f"{a['occupancy_model']['deterministic']}", flush=True)
    for ln in lines[1:]:
        print(f"[sim smoke] {ln}", flush=True)
    if rc != 0 or not summary["ok"]:
        fail(f"sim smoke: exit {rc}, ok {summary['ok']}")
    return summary


def _sim_replay(served: dict) -> dict:
    """(b) Phase 13's recorded arrivals on the card's tables, at the
    demo's SLOs and engine count, the port's rule: run twice (the reports
    must be byte-identical, every recorded arrival accounted for), and
    once to the step for the first half; per model and half the sim's
    compliance beside what phase 13 served."""
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
    from ray_dynamic_batching_tpu_torch.sim import Simulation, render_json
    from ray_dynamic_batching_tpu_torch.sim.simulator import (
        Scenario,
        SimModelSpec,
    )
    from ray_dynamic_batching_tpu_torch.sim.workload import (
        load_recorded_arrivals,
    )

    tag = "sim replay"
    slos = served["slo_ms"]
    profiles = {n: BatchProfile.from_csv(
        n, f"{PROFILES_DIR}/{n}_summary.csv") for n in slos}
    arrivals = load_recorded_arrivals(ARRIVALS_PATH)
    sent = {n: m["sent"] for n, m in served["models"].items()}
    recorded = {n: sum(1 for _, m in arrivals if m == n) for n in slos}
    if recorded != sent:
        fail(f"{tag}: {ARRIVALS_PATH} holds {recorded} arrivals, phase 13 "
             f"sent {sent}")

    def run(duration_s: float) -> dict:
        return Simulation(profiles, Scenario(
            models=[SimModelSpec(n, slo) for n, slo in slos.items()],
            duration_s=duration_s, n_engines=served["engines"], seed=0,
            arrivals=arrivals)).run()

    t0 = time.monotonic()
    texts = [render_json(run(served["duration_s"])) for _ in range(2)]
    first = run(served["shift_at_s"])
    wall_s = time.monotonic() - t0
    if texts[0] != texts[1]:
        fail(f"{tag}: two runs of the same replay differ")
    os.makedirs(SIM_OUT_DIR, exist_ok=True)
    with open(f"{SIM_OUT_DIR}/replay.json", "w") as f:
        f.write(texts[0])
    whole = json.loads(texts[0])
    lost = {n: m["arrivals"] - (m["completed"] + m["stale"] + m["dropped"]
                                + m["pending"])
            for n, m in whole["models"].items()}
    if (whole["arrivals_total"] != len(arrivals) or any(lost.values())
            or whole["arrivals_truncated_past_horizon"]
            or whole.get("arrivals_ignored_unregistered_model")):
        fail(f"{tag}: {whole['arrivals_total']} of {len(arrivals)} "
             f"arrivals replayed, unaccounted {lost}")
    out = {"arrivals": len(arrivals), "wall_s": wall_s,
           "chips_used": whole["chips_used"],
           "migrations": whole["migrations"],
           "schedule_changes": whole["schedule_changes"], "models": {}}
    def miss(m: dict) -> int:
        return m["stale"] + m["dropped"] + m["violations"]

    for n in slos:
        w, h = whole["models"][n], first["models"][n]
        a2 = w["arrivals"] - h["arrivals"]
        sim = (1.0 - miss(h) / h["arrivals"] if h["arrivals"] else 1.0,
               1.0 - (miss(w) - miss(h)) / a2 if a2 else 1.0)
        live = (served["models"][n]["phase1"], served["models"][n]["phase2"])
        out["models"][n] = {"sim": sim, "served": live,
                            "arrivals": w["arrivals"],
                            "completed": w["completed"], "stale": w["stale"],
                            "dropped": w["dropped"],
                            "violations": w["violations"]}
        print(f"[{tag}] {n}: {w['arrivals']} arrivals; compliance first "
              f"half sim {sim[0]:.4f} served {live[0]:.4f}, second half "
              f"sim {sim[1]:.4f} served {live[1]:.4f}", flush=True)
    print(f"[{tag}] {len(arrivals)} recorded arrivals replayed on "
          f"{served['engines']} engines at the port's rule, twice "
          f"(byte-identical), all accounted for; {whole['chips_used']} "
          f"chips used, {whole['migrations']} migrations, "
          f"{whole['schedule_changes']} schedule changes; 3 runs in "
          f"{wall_s:.2f} s", flush=True)
    return out


def _sim_hop_drift(served: dict) -> dict:
    """(c) ``--hop-drift`` over phase 13's traced window: at least one hop
    graded; each graded hop's p50 / p95 live and sim, and the hops past
    the tolerance, printed."""
    tag = "sim hop drift"
    path = f"{SIM_OUT_DIR}/hop_drift.json"
    os.makedirs(SIM_OUT_DIR, exist_ok=True)
    rc, _ = _sim_cli(tag, ["--hop-drift", VISION_SPANS_PATH, "--profiles",
                           PROFILES_DIR, *SIM_MODEL_ARGS, "--engines",
                           str(served["engines"]), "--out", path])
    if rc not in (0, 1):
        fail(f"{tag}: exit {rc} (2: no hop graded, or a usage error)")
    with open(path) as f:
        diff = json.load(f)
    if not diff["hops"]:
        fail(f"{tag}: no hop graded ({diff['ungraded']})")
    for hop, e in diff["hops"].items():
        print(f"[{tag}] {hop}: p50 live {e['p50']['live_ms']:.3f} sim "
              f"{e['p50']['sim_ms']:.3f} ms, p95 live "
              f"{e['p95']['live_ms']:.3f} sim {e['p95']['sim_ms']:.3f} ms, "
              f"worst drift {e['worst_drift']:.3f} ({e['live_count']} live / "
              f"{e['sim_count']} sim samples)", flush=True)
    print(f"[{tag}] drifting beyond {diff['tolerance']}: "
          f"{diff['drifting_hops'] or 'none'}; ungraded "
          f"{sorted(diff['ungraded'])}", flush=True)
    return diff


def _sim_occupancy_floor() -> dict:
    """(d) The slot occupancy floor phase 12's decode table implies (the
    4-slot step over the 32-slot step), beside the sim's default."""
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile
    from ray_dynamic_batching_tpu_torch.sim.simulator import Scenario

    default = Scenario(models=[]).occupancy_floor
    path = f"{PROFILES_DIR}/llama3_8b_decode_summary.csv"
    if not os.path.exists(path):
        print(f"[sim floor] {path} is not there (phase 12 did not run); "
              f"the sim's default floor is {default}", flush=True)
        return {"default": default, "table": None}
    table = BatchProfile.from_csv("llama3_8b_decode", path)
    rows = {r.batch_size: r.latency_ms for r in table.rows}
    floor = rows[4] / rows[32]
    print(f"[sim floor] llama3_8b decode step: 4 slots {rows[4]:.3f} ms, "
          f"32 slots {rows[32]:.3f} ms: implied occupancy floor "
          f"{floor:.3f} against the sim's default {default}", flush=True)
    return {"default": default, "table": floor, "rows_ms": rows}


def phase_sim() -> dict:
    """Phase 15: the simulator on the card, over phase 13's files."""
    t0 = time.monotonic()
    missing = [p for p in (SERVED_PATH, ARRIVALS_PATH, VISION_SPANS_PATH)
               if not os.path.exists(p)]
    if missing:
        fail(f"sim: phase 13's files are missing: {missing}")
    with open(SERVED_PATH) as f:
        served = json.load(f)
    out = {"smoke": _sim_smoke(), "replay": _sim_replay(served),
           "hop_drift": _sim_hop_drift(served),
           "occupancy_floor": _sim_occupancy_floor()}
    out["wall_s"] = time.monotonic() - t0
    print(f"[sim] phase wall time {out['wall_s']:.1f} s", flush=True)
    return out


# --- phase 16: KV reuse ------------------------------------------------------
# Phase 6's paged engine (16 slots, 128-token pages, a 64-page pool, a
# 256-token budget) with the reuse caches on; the slab arm with the same
# caches at chunk granularity.
REUSE_CACHES = dict(prefix_cache_size=8, session_cache_size=8)
REUSE_PAGED = dict(PAGED_KNOBS, **REUSE_CACHES, host_spill_pages=16)
REUSE_SLAB = dict(SLAB_KNOBS, **REUSE_CACHES)
REUSE_PREFIX = 384     # three full pages
REUSE_NEW = 32


def _reuse_counter(family: str, model_name: str, granularity=None) -> float:
    from ray_dynamic_batching_tpu_torch.engine import decode

    tags = {"model": model_name}
    if granularity is not None:
        tags["granularity"] = granularity
    return getattr(decode, family).get(tags=tags)


def _reuse_engine(model, knobs: dict):
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue

    queue = RequestQueue("reuse", max_len=256)
    engine = DecodeEngine(model, queue, device="cuda", **knobs)
    engine.warmup()
    return engine, queue


def _reuse_serve(engine, queue, payloads) -> list:
    """Serve ``payloads`` on a hand-driven engine; their token lists."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    reqs = [Request(model="reuse", payload=p, slo_ms=600_000.0)
            for p in payloads]
    for r in reqs:
        queue.add_request(r)
    engine.run_until_idle(timeout_s=300)
    return [r.future.result(timeout=5).tokens for r in reqs]


def _drained(tag: str, engine) -> None:
    """The pool conserves, no slot holds a page, and once the caches are
    cleared every page is free."""
    engine._allocator.check()
    if not all(s.free for s in engine._slots):
        fail(f"{tag}: a slot still holds a stream after the drain")
    for cache in (engine.paged_prefix, engine.paged_sessions):
        if cache is not None:
            cache.clear()
    engine._allocator.check()
    if engine._allocator.free_pages != engine.num_pages:
        fail(f"{tag}: {engine._allocator.free_pages} of {engine.num_pages} "
             "pages free once the caches were cleared (a page leaked)")


def _same(tag: str, what: str, got, want) -> None:
    if got != want:
        fail(f"{tag}: {what}: {got} != {want}")


def _reuse_parity_arm(model, arm: str, knobs: dict, rng, V: int) -> dict:
    """One arm at full width, 2 layers, f32: a prefix hit against a
    cache-off engine, a session's turn 2 against the whole history served
    fresh (paged: borrowing the history's full page), and (paged) a spill-reloaded prefix against the in-memory hit
    and a stream migrated mid-decode against the same stream served
    straight. Greedy tokens must be identical."""
    tag = f"reuse parity {arm}"
    name = model.name
    paged = bool(knobs.get("paged"))
    gran = "page" if paged else "chunk"
    caches = dict(REUSE_CACHES, **({"host_spill_pages": 16} if paged
                                   else {}))
    warm, wq = _reuse_engine(model, dict(knobs, **caches))
    cold, cq = _reuse_engine(model, knobs)
    head = rng.integers(0, V, 300).tolist()
    p1, p2, p3 = (head + rng.integers(0, V, n).tolist() for n in (20, 13, 9))
    out = {}
    _reuse_serve(warm, wq, [{"tokens": p1, "max_new_tokens": 16}])
    hits = _reuse_counter("PREFIX_HITS", name, gran)
    hit = _reuse_serve(warm, wq, [{"tokens": p2, "max_new_tokens": 16}])
    _same(tag, f"{gran} prefix hits", _reuse_counter(
        "PREFIX_HITS", name, gran) - hits, 1)
    _same(tag, "prefix hit against a cache-off engine", hit,
          _reuse_serve(cold, cq, [{"tokens": p2, "max_new_tokens": 16}]))
    # Turn 1's history (216 tokens) passes a page: a paged turn 2
    # borrows its full page and recomputes from the boundary; a slab turn
    # 2 starts its chunks at 216, not a multiple of 64.
    t1 = rng.integers(0, V, 200).tolist()
    s1 = _reuse_serve(warm, wq, [{"tokens": t1, "max_new_tokens": 16,
                                  "session_id": "parity"}])[0]
    t2 = t1 + s1 + rng.integers(0, V, 20).tolist()
    hits = _reuse_counter("SESSION_HITS", name)
    seen = warm._page_journal.total if paged else 0
    s2 = _reuse_serve(warm, wq, [{"tokens": t2, "max_new_tokens": 16,
                                  "session_id": "parity"}])
    _same(tag, "session hits", _reuse_counter("SESSION_HITS", name) - hits,
          1)
    if paged:
        journal = warm._page_journal
        borrowed = [e["pages"] for e in
                    journal.snapshot()[-(journal.total - seen):]
                    if e["kind"] == "cow_copy"
                    and e.get("source") == "session"]
        _same(tag, "pages turn 2 borrowed from the session", borrowed,
              [len(t1 + s1) // PS])
    _same(tag, "session turn 2 against the history served fresh", s2,
          _reuse_serve(cold, cq, [{"tokens": t2, "max_new_tokens": 16}]))
    out.update(prefix_hit=True, session=True)
    if paged:
        in_memory = _reuse_serve(warm, wq, [{"tokens": p3,
                                             "max_new_tokens": 16}])
        while len(warm.paged_prefix):
            warm._reclaim_cache_pins()      # spill + evict every entry
        reloads = warm.host_spill.reloads
        reloaded = _reuse_serve(warm, wq, [{"tokens": p3,
                                            "max_new_tokens": 16}])
        _same(tag, "reloads", warm.host_spill.reloads - reloads, 1)
        _same(tag, "spill-reloaded prefix against the in-memory hit",
              reloaded, in_memory)
        dest, dq = _reuse_engine(model, knobs)
        m = {"tokens": rng.integers(0, V, 40).tolist(),
             "max_new_tokens": 24}
        straight = _reuse_serve(cold, cq, [m])
        from ray_dynamic_batching_tpu_torch.engine.request import Request

        req = Request(model="reuse", payload=m, slo_ms=600_000.0)
        wq.add_request(req)
        while not warm.live_stream_ids():
            warm._admit()
            warm._pump_prefill()
            if warm._active_mask.any():
                warm._step()
        if not warm.request_migration(req.request_id, dest.accept_parcel):
            fail(f"{tag}: the live stream was not accepted for migration")
        warm._service_fabric()
        dest.run_until_idle(timeout_s=300)
        warm.run_until_idle(timeout_s=300)
        _same(tag, "migrations out / in",
              (warm.migrated_out, dest.migrated_in), (1, 1))
        _same(tag, "migrated stream against the straight run",
              [req.future.result(timeout=5).tokens], straight)
        out.update(reloaded=True, migrated=True)
        out["kernels"] = _reuse_kernels(tag, warm, torch.float32)
        for e in (warm, cold, dest):
            _drained(tag, e)
        dest.release_buffers()
    else:
        out["kernels"] = _reuse_kernels(tag, warm, torch.float32)
    _steady(tag)
    print(f"[{tag}] greedy tokens identical: prefix hit vs cache-off, "
          f"session turn 2 vs the history served fresh"
          + (", spill-reloaded vs in-memory hit, migrated vs straight"
             if paged else ""), flush=True)
    for e in (warm, cold):
        e.release_buffers()
    return out


def _reuse_kernel_inputs(engine, dtype, gen) -> dict:
    """The kernels' inputs on the reuse paths, from the engine's own
    cache, as ``case -> (kernel spec, inputs)``: paged, the logical view a
    chunk past the engine's deepest borrowed prefix gathers through a
    table whose head is that prefix's pages (layer 0 of the pool; an int8
    pool dequantized, as the route does before flash), and a decode window
    over 16 slots whose tables all begin with those pages; slab, a
    session chunk from an unaligned base over a 576-position row cache
    (the long-fill row of max_len 512), and a decode window over the slab
    cache's rows (layer 0)."""
    from ray_dynamic_batching_tpu_torch.models.decoder import (
        decode_mask,
        dequantize_kv,
        paged_window_mask,
    )
    from ray_dynamic_batching_tpu_torch.ops import decode_attention as dec

    dev = "cuda"
    cache = engine._cache
    out = {}
    if engine.paged:
        head = list(max(engine.paged_prefix._entries.values(), key=len))
        n = len(head)
        rest = [p for p in range(engine.num_pages) if p not in head]
        table = torch.full((1, NP), engine.num_pages, dtype=torch.int32)
        table[0, :n + 1] = torch.tensor(head + rest[:1])
        table = table.to(dev)
        k_g = dec.logical_view(cache.k[0], table)
        v_g = dec.logical_view(cache.v[0], table)
        if cache.quantized:
            k_g = dequantize_kv(k_g, dec.logical_view(cache.k_scale[0],
                                                      table), dtype)
            v_g = dequantize_kv(v_g, dec.logical_view(cache.v_scale[0],
                                                      table), dtype)
        q = torch.randn((1, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
        out["flash_borrowed_chunk"] = ("flash_attention", _with_keep_mask(
            dict(q=q.to(dtype), k=k_g.to(dtype), v=v_g.to(dtype),
                 mask=paged_window_mask(torch.tensor([n * PS], device=dev),
                                        S, T))))
        tables = torch.full((SLOTS, NP), engine.num_pages, dtype=torch.int32)
        lengths = []
        for b in range(SLOTS):
            length = min(n * PS + 16 + 8 * b, S - 1)
            tables[b, :n] = torch.tensor(head)
            for j in range(n, -(-(length + 1) // PS)):
                tables[b, j] = rest[(b * NP + j) % len(rest)]
            lengths.append(length)
        q = torch.randn((SLOTS, 1, N_HEADS, HEAD_DIM), generator=gen,
                        device=dev)
        x = dict(q=q.to(dtype), k=cache.k[0], v=cache.v[0],
                 table=tables.to(dev),
                 lengths=torch.tensor(lengths, dtype=torch.int32,
                                      device=dev))
        name = "paged_decode_attention"
        if cache.quantized:
            x.update(ks=cache.k_scale[0], vs=cache.v_scale[0])
            name += "_int8"
        else:
            x.update(k=x["k"].to(dtype), v=x["v"].to(dtype))
        out["paged_shared_heads"] = (name, x)
    else:
        row = 576
        start = 77                                  # not a multiple of 64
        q = torch.randn((1, T, N_HEADS, HEAD_DIM), generator=gen, device=dev)
        k = torch.randn((1, row, KV_HEADS, HEAD_DIM), generator=gen,
                        device=dev)
        v = torch.randn((1, row, KV_HEADS, HEAD_DIM), generator=gen,
                        device=dev)
        pos = start + torch.arange(T, device=dev)
        mask = (torch.arange(row, device=dev)[None, None, None, :]
                <= pos[None, None, :, None])
        out["flash_unaligned_chunk"] = ("flash_attention", _with_keep_mask(
            dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype), mask=mask)))
        B, Sc = cache.k.shape[1], cache.k.shape[2]
        q = torch.randn((B, 1, N_HEADS, HEAD_DIM), generator=gen, device=dev)
        lengths = torch.randint(40, Sc - 1, (B,), generator=gen, device=dev)
        out["decode_seeded_rows"] = ("decode_attention", _with_keep_mask(
            dict(q=q.to(dtype), k=cache.k[0].to(dtype),
                 v=cache.v[0].to(dtype), mask=decode_mask(lengths, Sc))))
    return out


def _reuse_kernels(tag: str, engine, dtype) -> dict:
    """Each kernel of the reuse paths against its plain version on those
    inputs (the phase-3 tolerance); in bf16 also timed beside the plain
    version and SDPA (or the gather yardstick), with its bound. These
    launches do not count: the counts are reset after."""

    specs = _kernel_specs()
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = {}
    for case, (name, x) in _reuse_kernel_inputs(engine, dtype, gen).items():
        sp = specs[name]
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        row = {"kernel": name,
               "max_abs_err": _check(name, f"{dt} {case}", sp, x, dtype),
               "q_shape": list(x["q"].shape),
               "kv_shape": list(x["k"].shape)}
        if dtype == torch.bfloat16:
            row.update(_timed(sp, x, dtype))
            _print_times(f"{name} {case}", row)
        rows[case] = row
    _reset_counts()
    return rows


def _reuse_parity(V: int) -> dict:
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    rng = np.random.default_rng(16)
    out = {}
    for kv_dtype, arms in ((None, (("slab", SLAB_KNOBS),
                                   ("paged", PAGED_KNOBS),
                                   ("paged_mono", dict(
                                       PAGED_KNOBS, chunked_prefill=False)))),
                           (torch.int8, (("int8_paged", PAGED_KNOBS),))):
        model = CausalLM(cfg, "llama3_8b_2layer", dtype=torch.float32,
                         device="cuda", seed=0, kv_dtype=kv_dtype)
        for arm, knobs in arms:
            out[arm] = _reuse_parity_arm(model, arm, knobs, rng, V)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


class _Timed:
    """Wall time of every call of ``fn`` (the spill tier's page IO, the
    fabric's export and import), in ms, up to the engine's stream
    finishing what the call queued (a host-to-card copy from pinned
    memory returns before it is done). The calls run on an engine's loop
    thread and queue on its current stream, the card's default stream,
    which the two replicas of a process share; only that stream is
    waited for. With ``split`` (a page read to host), the wait for what
    the stream held before the call is taken first and kept apart
    (``wait_ms``), so the call's own time starts on a drained stream, and
    the call's pinned host allocations (``torch.empty(pin_memory=True)``
    on its thread) are timed inside it (``alloc_ms``): the rest of the
    call is the gather and the copy."""

    def __init__(self, fn, split: bool = False):
        self.fn, self.split = fn, split
        self.ms, self.wait_ms, self.alloc_ms = [], [], []

    def __call__(self, *args):
        stream = torch.cuda.current_stream()
        empty, alloc = torch.empty, [0.0]
        if self.split:
            t0 = time.perf_counter()
            stream.synchronize()
            self.wait_ms.append((time.perf_counter() - t0) * 1e3)
            me = threading.get_ident()

            def timed_empty(*a, **kw):
                if not (kw.get("pin_memory") and threading.get_ident() == me):
                    return empty(*a, **kw)
                t = time.perf_counter()
                try:
                    return empty(*a, **kw)
                finally:
                    alloc[0] += (time.perf_counter() - t) * 1e3

            torch.empty = timed_empty
        t0 = time.perf_counter()
        try:
            return self.fn(*args)
        finally:
            stream.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if self.split:
                torch.empty = empty
                self.alloc_ms.append(alloc[0])


def _expect_reuse(tag: str, counts: dict, engines) -> None:
    """Each decode step of any engine runs the arm's decode kernel once a
    layer, each prefill group, long-fill chunk or chunk dispatch runs flash
    once a layer; nothing else launches."""
    L = engines[0].model.cfg.num_layers
    decode = ("paged_decode_attention" if engines[0].paged
              else "decode_attention")
    want = {decode: L * sum(e.steps for e in engines),
            "flash_attention": L * sum(
                e.prefill_groups + e.long_chunk_dispatches
                + e.chunk_dispatches for e in engines)}
    if not all(want.values()):
        fail(f"{tag}: a kernel of the path never launched: {want}")
    _expect_only(tag, counts, want)


def _queue_books(tag: str, replica) -> dict:
    """Every bucket queue conserves: enqueued = completed + stale +
    dropped + migrated_out + depth."""
    s = replica.stats()
    for key, b in s.items():
        if not key.startswith("bucket_"):
            continue
        rhs = (b["completed"] + b["stale"] + b["dropped"]
               + b.get("migrated_out", 0.0) + b["depth"])
        if b["enqueued"] != rhs:
            fail(f"{tag}: {replica.replica_id} {key} books do not conserve:"
                 f" {b}")
    return s


def _reuse_bf16(V: int) -> tuple:
    """Phase 16's full-depth paged run; returns (launch counts, numbers)."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.kv_fabric import KVPageFabric
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    tag = "reuse paged"
    rng = np.random.default_rng(160)
    t0 = time.monotonic()
    dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                        **REUSE_PAGED)
    ctl = ServeController(control_interval_s=3600.0)
    name = "llama3_8b_reuse"
    router = ctl.deploy(DeploymentConfig(name=name, num_replicas=2),
                        factory=dep)
    replicas = router.replicas()
    engines = [r.engine for r in replicas]
    print(f"[{tag}] two replicas of llama3_8b bf16, "
          f"{engines[0].model.cfg.num_layers} layers, caches prefix 8 / "
          f"session 8 / spill 16 pages, built and warmed in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    results, out = [], {}

    def send(replica_or_router, payload):
        req = Request(model=name, payload=payload, slo_ms=600_000.0)
        ok = (replica_or_router.assign_request(req)
              if replica_or_router is router else
              replica_or_router.assign(req))
        if not ok:
            fail(f"{tag}: a request was refused")
        return req

    def done(reqs):
        res = [r.future.result(timeout=300) for r in reqs]
        for p, r in zip((q.payload for q in reqs), res):
            if (len(r.tokens) != p["max_new_tokens"]
                    or r.finish_reason != "length"):
                fail(f"{tag}: {len(r.tokens)} tokens, {r.finish_reason}")
        results.extend(res)
        return res

    fabric = KVPageFabric()
    _reset_counts()
    t_start = time.monotonic()
    # Shared prefix: one miss, then seven concurrent hits on the holder.
    prefix = rng.integers(0, V, REUSE_PREFIX).tolist()
    tails = [rng.integers(0, V, int(n)).tolist()
             for n in rng.integers(16, 49, 9)]
    misses = _reuse_counter("PREFIX_MISSES", "llama3_8b", "page")
    hits = _reuse_counter("PREFIX_HITS", "llama3_8b", "page")
    first = send(router, {"tokens": prefix + tails[0],
                          "max_new_tokens": REUSE_NEW})
    miss_res = done([first])
    holder = next(r for r in replicas if r.replica_id ==
                  first._assigned_replica)
    other = next(r for r in replicas if r is not holder)
    ctl._publish_prefix_digests(ctl._deployments[name])
    chain = router.digests.chain_for({"tokens": prefix + tails[1]})
    if len(chain) != 3:
        fail(f"{tag}: chain_for gave {len(chain)} levels, expected 3")
    cow = len([e for e in holder.engine._page_journal.snapshot()
               if e["kind"] == "cow_copy"])
    batch = [send(router, {"tokens": prefix + t,
                           "max_new_tokens": REUSE_NEW})
             for t in tails[1:8]]
    hit_res = done(batch)
    steered = {r._assigned_replica for r in batch}
    _same(tag, "replicas the shared-prefix requests were routed to",
          steered, {holder.replica_id})
    _same(tag, "page misses / hits",
          (_reuse_counter("PREFIX_MISSES", "llama3_8b", "page") - misses,
           _reuse_counter("PREFIX_HITS", "llama3_8b", "page") - hits),
          (1, 7))
    borrows = [e for e in holder.engine._page_journal.snapshot()
               if e["kind"] == "cow_copy"][cow:]
    _same(tag, "pages borrowed by each hit", [e["pages"] for e in borrows],
          [3] * 7)
    out["ttft_miss_ms"] = miss_res[0].ttft_ms
    out["ttft_hit_ms"] = [r.ttft_ms for r in hit_res]
    print(f"[{tag}] shared {REUSE_PREFIX}-token prefix: 1 page miss, 7 page "
          f"hits on {holder.replica_id} (chain_for steered all 7), 3 pages "
          f"shared by each; TTFT of the miss {out['ttft_miss_ms']:.1f} ms, "
          f"of the hits {_span_quantiles(out['ttft_hit_ms'])}", flush=True)
    # Sessions: four two-turn chats.
    s_hits = _reuse_counter("SESSION_HITS", "llama3_8b")
    turn1 = [rng.integers(0, V, int(n)).tolist()
             for n in rng.integers(40, 61, 4)]
    r1 = done([send(holder, {"tokens": t, "max_new_tokens": REUSE_NEW,
                             "session_id": f"chat-{i}"})
               for i, t in enumerate(turn1)])
    r2 = done([send(holder, {"tokens": t + r.tokens
                             + rng.integers(0, V, 20).tolist(),
                             "max_new_tokens": REUSE_NEW,
                             "session_id": f"chat-{i}"})
               for i, (t, r) in enumerate(zip(turn1, r1))])
    _same(tag, "session hits",
          _reuse_counter("SESSION_HITS", "llama3_8b") - s_hits, 4)
    out["ttft_session_turn1_ms"] = [r.ttft_ms for r in r1]
    out["ttft_session_turn2_ms"] = [r.ttft_ms for r in r2]
    print(f"[{tag}] 4 sessions: 4 session hits; TTFT turn 1 "
          f"{_span_quantiles(out['ttft_session_turn1_ms'])}, turn 2 "
          f"{_span_quantiles(out['ttft_session_turn2_ms'])}", flush=True)
    # Spill and reload: the in-memory hit of one request alone, pool
    # pressure (15 streams growing to 4 pages each shed every cache pin,
    # the prefix's pages spilled to host memory), the same request alone
    # again (reloaded).
    he = holder.engine
    spill = he.host_spill
    spill._read = _Timed(spill._read, split=True)
    spill._write = _Timed(spill._write)
    x = {"tokens": prefix + tails[8], "max_new_tokens": REUSE_NEW}
    in_memory = done([send(holder, x)])[0]
    spills = spill.spills
    done([send(holder, {"tokens": rng.integers(0, V, 100).tolist(),
                        "max_new_tokens": 300}) for _ in range(15)])
    if spill.spills - spills < 3 or len(spill) < 3:
        fail(f"{tag}: pool pressure spilled {spill.spills - spills} "
             f"entries ({spill.stats()}); expected the prefix's 3 levels")
    reloads = spill.reloads
    reloaded = done([send(holder, x)])[0]
    _same(tag, "reloads", spill.reloads - reloads, 1)
    _same(tag, "reloaded tokens against the in-memory hit's",
          reloaded.tokens, in_memory.tokens)
    out["spill"] = dict(spill.stats(), spill_wait_ms=spill._read.wait_ms,
                        spill_ms=spill._read.ms,
                        spill_alloc_ms=spill._read.alloc_ms,
                        reload_ms=spill._write.ms,
                        ttft_in_memory_ms=in_memory.ttft_ms,
                        ttft_reloaded_ms=reloaded.ttft_ms)
    print(f"[{tag}] spill by pool pressure: {out['spill']['spills']} "
          f"spills; each page read to host waited "
          f"{[round(t, 2) for t in spill._read.wait_ms]} ms for the engine's "
          f"stream, then read in {[round(t, 2) for t in spill._read.ms]} ms,"
          f" of which allocating pinned host memory "
          f"{[round(t, 2) for t in spill._read.alloc_ms]} ms;"
          f" reload of {REUSE_PREFIX // PS} pages "
          f"{[round(t, 2) for t in spill._write.ms]} ms; reloaded tokens "
          f"equal the in-memory hit's; TTFT in memory "
          f"{in_memory.ttft_ms:.1f} ms, reloaded {reloaded.ttft_ms:.1f} ms",
          flush=True)
    # Migration: a straight run, then the same stream moved mid-decode
    # from the holder to the other replica.
    m = {"tokens": rng.integers(0, V, 50).tolist(), "max_new_tokens": 96}
    straight = done([send(holder, m)])[0]
    he._migrate_stream_out = _Timed(he._migrate_stream_out)
    oe = other.engine
    oe._import_parcel = _Timed(oe._import_parcel)
    moving = send(holder, m)
    deadline = time.monotonic() + 60
    while moving.request_id not in holder.live_stream_ids():
        if time.monotonic() > deadline:
            fail(f"{tag}: the stream never went live")
        time.sleep(0.001)
    t_m = time.monotonic()
    if not fabric.migrate(holder, other, moving.request_id):
        fail(f"{tag}: the migration was not requested")
    moved = done([moving])[0]
    _same(tag, "migrated tokens against the straight run's", moved.tokens,
          straight.tokens)
    _same(tag, "migrations out / in", (he.migrated_out, oe.migrated_in),
          (1, 1))
    ev = next(e for e in he._page_journal.snapshot()
              if e["kind"] == "migrate_out")
    out["migration"] = dict(parcel_bytes=ev["bytes"], pages=ev["pages"],
                            export_ms=he._migrate_stream_out.ms[-1],
                            import_ms=oe._import_parcel.ms[-1],
                            request_to_done_ms=(time.monotonic() - t_m)
                            * 1e3)
    print(f"[{tag}] migrated one live stream {holder.replica_id} -> "
          f"{other.replica_id} through KVPageFabric.migrate: "
          f"{ev['pages']} pages, parcel {ev['bytes'] / 1e6:.2f} MB, export "
          f"+ delivery {out['migration']['export_ms']:.1f} ms, import "
          f"{out['migration']['import_ms']:.1f} ms; tokens equal the "
          f"straight run's", flush=True)
    # Prefix push: the holder's hot prefix to the other replica, which
    # then hits it.
    pushed = fabric.push_hot_prefixes(name, replicas)
    deadline = time.monotonic() + 60
    while oe.pushes_in < 1:
        if time.monotonic() > deadline:
            fail(f"{tag}: no pushed prefix installed on {other.replica_id}")
        time.sleep(0.01)
    cow = len([e for e in oe._page_journal.snapshot()
               if e["kind"] == "cow_copy"])
    done([send(other, {"tokens": prefix + tails[2],
                       "max_new_tokens": REUSE_NEW})])
    peer = [e for e in oe._page_journal.snapshot()
            if e["kind"] == "cow_copy"][cow:]
    if not peer:
        fail(f"{tag}: the peer did not hit the pushed prefix")
    out["push"] = dict(parcels=pushed, peer_hit_pages=peer[0]["pages"])
    print(f"[{tag}] pushed {pushed} prefix parcel(s) to "
          f"{other.replica_id}; its next shared-prefix request borrowed "
          f"{peer[0]['pages']} pages", flush=True)
    wall = time.monotonic() - t_start
    for e in engines:
        e.stop()
    torch.cuda.synchronize()
    counts = _counts()
    _expect_reuse(tag, counts, engines)
    out["kernels"] = _reuse_kernels(tag, he, torch.bfloat16)
    for r in replicas:
        out.setdefault("books", {})[r.replica_id] = _queue_books(tag, r)
    _steady(tag)
    for e in engines:
        _drained(tag, e)
    n_tok = sum(len(r.tokens) for r in results)
    out.update(requests=len(results), tokens=n_tok, wall_s=wall)
    print(f"[{tag}] {len(results)} requests answered, {n_tok} tokens in "
          f"{wall:.1f} s; queue books conserve (migrated_out included); "
          f"pools conserve and are whole once the caches clear; launches "
          f"{counts}", flush=True)
    ctl.shutdown()
    return counts, out


def _reuse_slab(V: int) -> tuple:
    """Phase 16's slab arm at full depth: the shared-prefix and session
    runs at chunk granularity; returns (launch counts, numbers)."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    tag = "reuse slab"
    rng = np.random.default_rng(161)
    dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                        **REUSE_SLAB)
    replica = dep.make_replica("slab-0", DeploymentConfig(name="reuse_slab"))
    engine = replica.engine
    replica.start()

    def run(payloads):
        reqs = [Request(model="reuse_slab", payload=p, slo_ms=600_000.0)
                for p in payloads]
        for r in reqs:
            if not replica.assign(r):
                fail(f"{tag}: a request was refused")
        res = [r.future.result(timeout=300) for r in reqs]
        if any(len(r.tokens) != REUSE_NEW for r in res):
            fail(f"{tag}: a request was cut short")
        return res

    _reset_counts()
    prefix = rng.integers(0, V, REUSE_PREFIX).tolist()
    tails = [rng.integers(0, V, int(n)).tolist()
             for n in rng.integers(16, 49, 8)]
    misses = _reuse_counter("PREFIX_MISSES", "llama3_8b", "chunk")
    hits = _reuse_counter("PREFIX_HITS", "llama3_8b", "chunk")
    miss = run([{"tokens": prefix + tails[0], "max_new_tokens": REUSE_NEW}])
    hit = run([{"tokens": prefix + t, "max_new_tokens": REUSE_NEW}
               for t in tails[1:]])
    _same(tag, "chunk misses / hits",
          (_reuse_counter("PREFIX_MISSES", "llama3_8b", "chunk") - misses,
           _reuse_counter("PREFIX_HITS", "llama3_8b", "chunk") - hits),
          (1, 7))
    s_hits = _reuse_counter("SESSION_HITS", "llama3_8b")
    turn1 = [rng.integers(0, V, int(n)).tolist()
             for n in rng.integers(40, 61, 4)]
    r1 = run([{"tokens": t, "max_new_tokens": REUSE_NEW,
               "session_id": f"slab-{i}"} for i, t in enumerate(turn1)])
    r2 = run([{"tokens": t + r.tokens + rng.integers(0, V, 20).tolist(),
               "max_new_tokens": REUSE_NEW, "session_id": f"slab-{i}"}
              for i, (t, r) in enumerate(zip(turn1, r1))])
    _same(tag, "session hits",
          _reuse_counter("SESSION_HITS", "llama3_8b") - s_hits, 4)
    engine.stop()
    torch.cuda.synchronize()
    counts = _counts()
    _expect_reuse(tag, counts, [engine])
    _queue_books(tag, replica)
    _steady(tag)
    out = dict(ttft_miss_ms=miss[0].ttft_ms,
               ttft_hit_ms=[r.ttft_ms for r in hit],
               ttft_session_turn1_ms=[r.ttft_ms for r in r1],
               ttft_session_turn2_ms=[r.ttft_ms for r in r2])
    print(f"[{tag}] shared {REUSE_PREFIX}-token prefix at chunk "
          f"granularity: 1 miss, 7 hits (chunk 0 seeded); TTFT of the miss "
          f"{out['ttft_miss_ms']:.1f} ms, of the hits "
          f"{_span_quantiles(out['ttft_hit_ms'])}; 4 sessions, 4 hits, "
          f"TTFT turn 1 {_span_quantiles(out['ttft_session_turn1_ms'])}, "
          f"turn 2 {_span_quantiles(out['ttft_session_turn2_ms'])}; "
          f"launches {counts}",
          flush=True)
    out["kernels"] = _reuse_kernels(tag, engine, torch.bfloat16)
    replica.stop()
    return counts, out


def phase_reuse() -> tuple:
    """Phase 16; returns (launch counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import LLAMA3_8B

    t0 = time.monotonic()
    smi = _smi()
    V = LLAMA3_8B.vocab_size
    parity = _reuse_parity(V)
    gc.collect()
    torch.cuda.empty_cache()
    paged_counts, paged = _reuse_bf16(V)
    gc.collect()
    torch.cuda.empty_cache()
    slab_counts, slab = _reuse_slab(V)
    gc.collect()
    torch.cuda.empty_cache()
    counts = {n: paged_counts.get(n, 0) + slab_counts.get(n, 0)
              for n in set(paged_counts) | set(slab_counts)}
    wall = time.monotonic() - t0
    print(f"[reuse] {smi}: phase wall time {wall:.1f} s", flush=True)
    return counts, dict(card=smi, parity=parity, paged=paged, slab=slab,
                        wall_s=wall)


# --- phase 17: speculative decoding -----------------------------------------
SPEC_TOKENS = 4
# 17a's f32 self-draft: the least acceptance that passes (near ties that
# another GEMM shape rounds the other way may reject a few proposals).
SELF_DRAFT_ACCEPTANCE = 0.99
# gpt2_medium + gpt2_draft at bench_llm_serving's shape (the reference's
# bench.py), cut to fit the phase: 64 slots, max_len 256, one bucket of 64
# (48-token prompts), 96 new tokens, horizon 32, groups of 8.
GPT2_KNOBS = dict(num_slots=64, max_len=256, prompt_buckets=[64],
                  default_max_new_tokens=96, decode_horizon=32,
                  max_admissions_per_step=8)


def _spec_books(engine) -> dict:
    """The speculation families under the engine's tags: rounds, drafted,
    accepted and rejected tokens."""
    from ray_dynamic_batching_tpu_torch.engine import decode as dmod

    tags = {"model": engine.model.name,
            "paged": "true" if engine.paged else "false"}
    return {n: getattr(dmod, f"SPEC_{n.upper()}").get(tags=tags)
            for n in ("rounds", "drafted", "accepted", "rejected")}


def _watch_rounds(engine) -> list:
    """Log each speculative round as its harvest receives it: for every
    slot in the round, its request, the tokens it had, the tokens the
    round's device output offered it (``advanced``'s count, the
    target's own token included) and the tokens it took. The log is
    ``engine.round_log``."""
    log = []
    fn = engine._harvest

    def watched(toks, advanced, lengths, h, blocked_finishes_capacity=True):
        if blocked_finishes_capacity:
            return fn(toks, advanced, lengths, h)
        offered = advanced.sum(axis=0)
        rows = [(s.request, s.generated, len(s.generated), int(offered[i]))
                for i, s in enumerate(engine._slots)
                if not s.free and engine._active_mask[i]]
        fn(toks, advanced, lengths, h, blocked_finishes_capacity=False)
        log.append([dict(request=req, before=n0, offered=n,
                         took=len(gen) - n0, finished=req.future.done())
                    for req, gen, n0, n in rows])

    engine._harvest = watched
    engine.round_log = log
    return log


def _count_catchups(engine) -> "collections.Counter":
    """Count the engine's catch-up dispatches by window width (after its
    warmup): the launch rule routes widths of 16 and more to flash."""
    import collections

    seen = collections.Counter()
    fn = engine._draft_catchup_fn

    def counted(window, active, counts):
        seen[int(window.shape[1])] += 1
        return fn(window, active, counts)

    engine._draft_catchup_fn = counted
    engine.catchup_widths = seen
    return seen


def _pool_whole(tag: str, engine) -> None:
    """Paged: no scratch page outlived its round, and the pool is whole
    (:func:`_drained`)."""
    if not engine.paged:
        return
    if engine._spec_scratch:
        fail(f"{tag}: scratch {engine._spec_scratch} left after the drain")
    _drained(tag, engine)


def _spec_window(tag: str, engine, payloads, submit, wait) -> dict:
    """One served window on a warmed engine: launch counts zeroed just
    before and held to the engine's dispatches just after, the
    speculation books held to the rounds' device outputs
    (:func:`_round_books`), no capture after warmup, the pool whole.
    Returns tokens, results, counts and numbers; on a draft engine also
    ``plain_prefix``, each request's tokens before its first round (None:
    no round took it)."""
    import collections

    spec = engine.draft_model is not None
    state0 = _dispatch_state(engine)
    books0 = _spec_books(engine) if spec else None
    log0 = len(engine.round_log) if spec else 0
    widths0 = collections.Counter(getattr(engine, "catchup_widths", {}))
    captures0 = engine.capture_stats()["captures"]
    _reset_counts()
    t0 = time.monotonic()
    futures = submit(payloads)
    results = wait(futures)
    wall = time.monotonic() - t0
    # A replica's loop resets a slot just after fulfilling its request.
    deadline = time.monotonic() + 10
    while engine._active_mask.any() and time.monotonic() < deadline:
        time.sleep(0.001)
    torch.cuda.synchronize()
    counts = _counts()
    widths = None
    if spec:
        widths = dict(collections.Counter(engine.catchup_widths) - widths0)
    _expect_dispatches(tag, counts, engine, since=state0,
                       catchup_windows=widths)
    if engine.capture_stats()["captures"] != captures0:
        fail(f"{tag}: {engine.capture_stats()['captures'] - captures0} "
             "captures after warmup")
    _steady(tag)
    _pool_whole(tag, engine)
    for i, r in enumerate(results):
        if (len(r.tokens) != payloads[i]["max_new_tokens"]
                or r.finish_reason != "length"):
            fail(f"{tag} request {i}: {len(r.tokens)} tokens, "
                 f"{r.finish_reason}")
    ttfts = sorted(r.ttft_ms for r in results)
    out = dict(tokens=[r.tokens for r in results], counts=counts,
               tok_s=sum(len(r.tokens) for r in results) / wall,
               ttft_p50_ms=statistics.median(ttfts), wall_s=wall)
    if spec:
        b1 = _spec_books(engine)
        d = {n: b1[n] - books0[n] for n in b1}
        rounds = engine.spec_rounds - state0["spec_rounds"]
        catchups = engine.draft_catchups - state0["draft_catchups"]
        log = engine.round_log[log0:]
        _round_books(tag, engine, d, rounds, log)
        # A sampled row keeps every batch it is in plain: such a window
        # must catch the draft up; an all-greedy one must speculate.
        sampled = any(p.get("temperature") for p in payloads)
        if not (catchups if sampled else rounds):
            fail(f"{tag}: {rounds} rounds, {catchups} catch-ups")
        index = {id(r): i for i, r in enumerate(futures)}
        prefix = [None] * len(payloads)
        for rnd in log:
            for row in rnd:
                i = index[id(row["request"])]
                if prefix[i] is None or row["before"] < prefix[i]:
                    prefix[i] = row["before"]
        acc = d["accepted"] / d["drafted"] if d["drafted"] else 0.0
        out.update(rounds=rounds, drafted=d["drafted"],
                   accepted=d["accepted"], rejected=d["rejected"],
                   acceptance=acc,
                   tokens_a_row_per_round=1 + engine.spec_tokens * acc,
                   catchups=catchups,
                   catchup_widths=widths,
                   pool_fallbacks=engine.spec_pool_fallbacks,
                   plain_prefix=prefix)
    return out


def _round_books(tag: str, engine, books: dict, rounds: int, log) -> None:
    """The window's speculation families held to what its rounds' device
    outputs say (:func:`_watch_rounds`): one round logged for each the
    engine and ``rdb_decode_spec_rounds_total`` count; k drafted for each
    slot in a round; accepted the offered tokens less the target's own,
    summed over the slots offered any; rejected the rest. Every slot took
    all it was offered unless its request finished in that round."""
    k = engine.spec_tokens
    want = dict(rounds=len(log),
                drafted=k * sum(len(rnd) for rnd in log),
                accepted=sum(max(row["offered"] - 1, 0)
                             for rnd in log for row in rnd))
    want["rejected"] = want["drafted"] - want["accepted"]
    if books != want or rounds != len(log):
        fail(f"{tag}: books {books} and {rounds} engine rounds against the "
             f"rounds' outputs {want}")
    for j, rnd in enumerate(log):
        for row in rnd:
            if not (row["took"] <= row["offered"] <= k + 1
                    and (row["took"] == row["offered"] or row["finished"])):
                fail(f"{tag}: round {j} offered a slot {row['offered']} "
                     f"tokens, it took {row['took']} (finished "
                     f"{row['finished']})")


def _engine_io(engine, queue):
    """(submit, wait) for an engine driven by ``run_until_idle``."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    def submit(payloads):
        reqs = [Request(model="spec", payload=p, slo_ms=600_000.0)
                for p in payloads]
        for r in reqs:
            queue.add_request(r)
        engine.run_until_idle(timeout_s=600)
        return reqs

    return submit, lambda reqs: [r.future.result(5) for r in reqs]


def _replica_io(tag: str, replica):
    """(submit, wait) for a started replica (its engine's own thread)."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    def submit(payloads):
        reqs = [Request(model=replica.engine.model.name, payload=p,
                        slo_ms=600_000.0) for p in payloads]
        for r in reqs:
            if not replica.assign(r):
                fail(f"{tag}: replica refused a request")
        return reqs

    return submit, lambda reqs: [r.future.result(timeout=600) for r in reqs]


def _greedy_same(tag: str, got, want, payloads) -> None:
    """Every greedy request's tokens equal (fails on the first that
    differs)."""
    for i, p in enumerate(payloads):
        j = _first_difference(got[i], want[i])
        if not p.get("temperature") and (j is not None
                                          or len(got[i]) != len(want[i])):
            fail(f"{tag}: greedy request {i} differs from token {j}")


def _plain_rows_same(tag: str, payloads, row: dict, want) -> int:
    """Each request's tokens before its first speculative round (all of
    them where no round took it; see :func:`_spec_window`) equal
    ``want``'s, token for token; fails on the first that differs.
    Returns the number of tokens held."""
    held = 0
    for i, p in enumerate(payloads):
        cut = row["plain_prefix"][i]
        if p.get("temperature") and cut is not None:
            fail(f"{tag}: sampled request {i} was in a round")
        got, ref = row["tokens"][i][:cut], want[i][:cut]
        if got != ref:
            fail(f"{tag}: request {i} differs at token "
                 f"{_first_difference(got, ref)} of its {len(got)} "
                 "plain-step tokens")
        held += len(got)
    print(f"[spec] {tag}: {held} tokens decoded by plain steps identical "
          f"({sum(c is not None for c in row['plain_prefix'])} of "
          f"{len(payloads)} requests cut at their first round)", flush=True)
    return held


def _first_difference(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def _near_ties(tag: str, model, payloads, got, want) -> list:
    """Two greedy runs of the same prompts in bf16 through programs of
    other shapes (a verify window's GEMMs against a step's, or a plain
    step's against a verify's): where a stream first differs, recompute
    the logits after the prompt and the shared tokens (one prefill, on
    the attention's plain version) and measure both tokens' gaps to the
    top logit against two bf16 ulps of it (a near tie, which rounding in
    either run may break either way). Printed, not gated: each request
    when a few differ, else a summary. Returns one record per differing
    request."""
    import math

    from ray_dynamic_batching_tpu_torch.ops import attention

    out = []
    for i, p in enumerate(payloads):
        j = _first_difference(got[i], want[i])
        if j is None:
            continue
        seq = list(p["tokens"]) + list(got[i][:j])
        with torch.inference_mode(), attention.plain_attention():
            cache = model.make_cache(1, len(seq))
            tokens = torch.tensor([seq], dtype=torch.int32,
                                  device=model.device)
            logits, _ = model.prefill(tokens, torch.ones_like(tokens), cache)
        lg = logits[0].float()
        top = lg.max().item()
        tol = 2 * 2.0 ** (math.floor(math.log2(abs(top))) - 7)
        gaps = [top - lg[got[i][j]].item(), top - lg[want[i][j]].item()]
        out.append(dict(request=i, index=j, tokens=[got[i][j], want[i][j]],
                        top=top, gaps=gaps, tol=tol,
                        near_tie=max(gaps) <= tol))
    if len(out) <= 8:
        for r in out:
            print(f"[spec] {tag}: request {r['request']} first differs at "
                  f"token {r['index']}: {r['tokens'][0]} vs "
                  f"{r['tokens'][1]}, {r['gaps'][0]:.4f} and "
                  f"{r['gaps'][1]:.4f} below the top logit {r['top']:.3f} "
                  f"(two bf16 ulps {r['tol']:.4f}); not gated", flush=True)
    else:
        at = [r["index"] for r in out]
        print(f"[spec] {tag}: {len(out)} of {len(payloads)} requests "
              f"differ, first at tokens {min(at)}-{max(at)}; both tokens "
              f"within two bf16 ulps of the top logit in "
              f"{sum(r['near_tie'] for r in out)}, the largest gap "
              f"{max(max(r['gaps']) for r in out):.4f}; not gated",
              flush=True)
    return out


def _spec_parity(V: int) -> dict:
    """17a: llama3_8b at full width, 2 layers, f32, graphed engines;
    phase 6's 10 requests on five arms with a divergent draft (a second
    module of the same widths from seed 1) against the engine without a
    draft, then with the target as its own draft."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    payloads = _payloads(np.random.default_rng(1), V, 32, 8, 2, 2)
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    draft = CausalLM(cfg, "llama3_8b_2layer_draft", dtype=torch.float32,
                     device="cuda", seed=1)
    arms = {None: (("slab", SLAB_KNOBS), ("paged", PAGED_KNOBS),
                   ("paged_mono", dict(PAGED_KNOBS, chunked_prefill=False)),
                   ("slab_chunked", dict(SLAB_KNOBS, chunked_prefill=True))),
            torch.int8: (("int8_paged", PAGED_KNOBS),)}
    out, counts = {}, {}

    def run(tag, model, knobs, d):
        queue = RequestQueue("spec", max_len=64)
        extra = dict(draft_model=d, spec_tokens=SPEC_TOKENS) if d else {}
        engine = DecodeEngine(model, queue, device="cuda", **knobs, **extra)
        engine.warmup()
        if d is not None:
            _count_catchups(engine)
            _watch_rounds(engine)
        row = _spec_window(tag, engine, payloads, *_engine_io(engine, queue))
        for n, c in row.pop("counts").items():
            counts[n] = counts.get(n, 0) + c
        engine.release_buffers()
        return row

    for kv_dtype, cases in arms.items():
        model = CausalLM(cfg, "llama3_8b_2layer", dtype=torch.float32,
                         device="cuda", seed=0, kv_dtype=kv_dtype)
        for arm, knobs in cases:
            tag = f"spec parity {arm}"
            plain = run(f"{tag} plain", model, knobs, None)
            row = run(tag, model, knobs, draft)
            _greedy_same(tag, row["tokens"], plain["tokens"], payloads)
            print(f"[spec] {tag}: greedy tokens identical to the engine "
                  f"without a draft; {row['rounds']} rounds, acceptance "
                  f"{row['acceptance']:.3f}, {row['catchups']} catch-ups, "
                  f"pool fallbacks {row['pool_fallbacks']}", flush=True)
            out[arm] = {k: row[k] for k in ("rounds", "acceptance",
                                           "catchups", "drafted")}
            # The target as its own draft proposes what the target then
            # picks (f32, no TF32): every fill path of the draft (group
            # prefill, long-fill replay, catch-ups) must leave it in step,
            # or its rows stop being accepted.
            tag = f"spec parity {arm} self-draft"
            row = run(tag, model, knobs, model)
            _greedy_same(tag, row["tokens"], plain["tokens"], payloads)
            if not row["acceptance"] >= SELF_DRAFT_ACCEPTANCE:
                fail(f"{tag}: acceptance {row['acceptance']:.4f} < "
                     f"{SELF_DRAFT_ACCEPTANCE} ({row['accepted']} of "
                     f"{row['drafted']})")
            print(f"[spec] {tag}: greedy tokens identical; acceptance "
                  f"{row['acceptance']:.4f} ({int(row['accepted'])} of "
                  f"{int(row['drafted'])}, gate {SELF_DRAFT_ACCEPTANCE}), "
                  f"{row['tokens_a_row_per_round']:.2f} tokens a row per "
                  f"round, {row['catchups']} catch-ups", flush=True)
            out[f"{arm}_self"] = {k: row[k] for k in (
                "rounds", "acceptance", "drafted",
                "tokens_a_row_per_round")}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def _turn_ms(spans) -> dict:
    """decode.turn ms: a spec round's, and a plain step's (turn / h)."""
    spec = [s.end_ms - s.start_ms for s in spans
            if s.name == "decode.turn" and s.attributes["spec"]]
    plain = [(s.end_ms - s.start_ms) / s.attributes["horizon"] for s in spans
             if s.name == "decode.turn" and not s.attributes["spec"]]
    return dict(spec_round_p50=statistics.median(spec) if spec else None,
                spec_rounds=len(spec),
                plain_step_p50=statistics.median(plain) if plain else None,
                plain_turns=len(plain))


def _spec_deployment_runs(tag, model, knobs, loads, draft=None,
                          draft_name=None) -> tuple:
    """One deployment (``LLMDeployment`` -> ``make_replica``, warmed)
    serving each of ``loads`` in turn through the replica, each window
    traced (decode.turn spans) and held by :func:`_spec_window`."""
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.trace_export import (
        ChromeTraceCollector,
    )
    from ray_dynamic_batching_tpu_torch.utils.tracing import tracer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dep = LLMDeployment(model.name, dtype=torch.bfloat16, model=model,
                        draft_model=draft, draft_model_name=draft_name,
                        spec_tokens=SPEC_TOKENS, **knobs)
    replica = dep.make_replica(f"{model.name}-{tag}",
                               DeploymentConfig(name=model.name))
    engine = replica.engine
    build_s = time.monotonic() - t0
    if engine.draft_model is not None:
        _count_catchups(engine)
        _watch_rounds(engine)
    replica.start()
    rows, counts = [], {}
    try:
        for i, load in enumerate(loads):
            collector = ChromeTraceCollector()
            tracer().set_exporter(collector.export)
            try:
                row = _spec_window(f"{tag} window {i}", engine, load,
                                   *_replica_io(tag, replica))
            finally:
                tracer().reset()
            row.update(_turn_ms(collector.spans))
            for n, c in row.pop("counts").items():
                counts[n] = counts.get(n, 0) + c
            rows.append(row)
    finally:
        replica.stop()
    return rows, counts, dict(build_and_warm_s=build_s,
                              captures=engine.capture_stats()["captures"])


def _fmt(r: dict) -> str:
    s = (f"{r['tok_s']:.1f} tok/s, TTFT p50 {r['ttft_p50_ms']:.1f} ms")
    if r.get("spec_round_p50") is not None:
        s += (f", decode.turn a spec round p50 {r['spec_round_p50']:.2f} ms"
              f" ({r['spec_rounds']})")
    if r.get("plain_step_p50") is not None:
        s += (f", a plain step p50 {r['plain_step_p50']:.2f} ms "
              f"({r['plain_turns']} turns)")
    if "rounds" in r:
        s += (f"; {r['rounds']} rounds, acceptance {r['acceptance']:.3f} "
              f"({r['accepted']} of {r['drafted']} drafted, "
              f"{r['rejected']} rejected), "
              f"{r['tokens_a_row_per_round']:.2f} tokens a row per round, "
              f"{r['catchups']} catch-ups {r['catchup_widths']}, "
              f"pool fallbacks {r['pool_fallbacks']}")
    return s


def _spec_llama(smi: str, V: int) -> tuple:
    """17b: llama3_8b bf16, SPEED_LAYERS deep, self-draft (the target module
    as ``draft_model``), slab and paged (chunked): phase 5's 6 greedy
    requests alone, then phase 5's mix (2 sampled rows: plain steps and
    catch-ups); each beside the same deployment without a draft."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )

    mix = _payloads(np.random.default_rng(0), V, 32, 8, 2, 0)
    greedy = [p for p in mix if not p.get("temperature")]
    model = _speed_model(device="cuda")
    out, counts = {}, {}
    for arm, knobs in (("slab", SLAB_KNOBS), ("paged", PAGED_KNOBS)):
        tag = f"spec llama3_8b {arm}"
        (p_greedy, p_mix), p_counts, p_info = _spec_deployment_runs(
            f"{tag} plain", model, knobs, [greedy, mix])
        (s_greedy, s_mix), s_counts, s_info = _spec_deployment_runs(
            tag, model, knobs, [greedy, mix], draft=model)
        for c in (p_counts, s_counts):
            for n, k in c.items():
                counts[n] = counts.get(n, 0) + k
        # The mix's rows before their first round (on the slab the mix
        # runs none, on the pool the greedy rows may meet one before the
        # sampled rows are admitted) and its sampled rows (never in a
        # round) ran the plain deployment's own programs at its shapes:
        # equal to its mix token for token.
        gated = _plain_rows_same(f"{tag} mix vs the plain deployment's",
                                 mix, s_mix, p_mix["tokens"])
        # Verify rounds against plain steps: GEMMs of other shapes, where
        # bf16 may break a near tie the other way. Printed, not gated.
        mixed_greedy = [t for p, t in zip(mix, s_mix["tokens"])
                        if not p.get("temperature")]
        mixed_ties = _near_ties(f"{tag} mixed vs greedy-only", model,
                                greedy, mixed_greedy, s_greedy["tokens"])
        plain_ties = _near_ties(f"{tag} vs the plain deployment", model,
                                greedy, s_greedy["tokens"],
                                p_greedy["tokens"])
        print(f"[spec] {tag} ({smi}): greedy-only, draft | plain: "
              f"{_fmt(s_greedy)} | {_fmt(p_greedy)}", flush=True)
        print(f"[spec] {tag} ({smi}): phase 5's mix, draft | plain: "
              f"{_fmt(s_mix)} | {_fmt(p_mix)}; captures after warmup 0; "
              f"built and warmed in {s_info['build_and_warm_s']:.1f} s "
              f"({s_info['captures']} captures) | "
              f"{p_info['build_and_warm_s']:.1f} s", flush=True)
        for r in (s_greedy, s_mix, p_greedy, p_mix):
            r.pop("tokens")
            r.pop("plain_prefix", None)
        out[arm] = dict(spec_greedy=s_greedy, spec_mix=s_mix,
                        plain_greedy=p_greedy, plain_mix=p_mix,
                        mix_tokens_gated=gated,
                        mixed_vs_greedy_only=mixed_ties,
                        greedy_vs_plain=plain_ties,
                        spec_build=s_info, plain_build=p_info)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def _spec_gpt2(smi: str) -> tuple:
    """17c: gpt2_medium (24 layers x 16 heads of 64, vocab 50257) with
    the registry's gpt2_draft, both bf16 at their published widths and
    depths with random weights (the draft from seed 1), 64 greedy
    48-token requests of 48 new tokens at once, with and without the
    draft, slab and paged: random weights put acceptance near 0, so this is the
    reference's bounded-degradation floor."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        GPT2_MEDIUM,
        CausalLM,
    )

    V = GPT2_MEDIUM.vocab_size
    rng = np.random.default_rng(17)
    load = [{"tokens": rng.integers(0, V, 48).tolist(), "max_new_tokens": 48}
            for _ in range(64)]
    model = CausalLM(GPT2_MEDIUM, "gpt2_medium", dtype=torch.bfloat16,
                     device="cuda", seed=0)
    out, counts = {}, {}
    for arm, extra in (("slab", {}), ("paged", dict(paged=True,
                                                    page_size=PS))):
        knobs = dict(GPT2_KNOBS, **extra)
        tag = f"spec gpt2_medium {arm}"
        (plain,), p_counts, _pi = _spec_deployment_runs(
            f"{tag} plain", model, knobs, [load])
        (spec,), s_counts, s_info = _spec_deployment_runs(
            tag, model, knobs, [load], draft_name="gpt2_draft")
        for c in (p_counts, s_counts):
            for n, k in c.items():
                counts[n] = counts.get(n, 0) + k
        ties = _near_ties(f"{tag} vs the plain deployment", model, load,
                          spec["tokens"], plain["tokens"])
        print(f"[spec] {tag} + gpt2_draft ({smi}): draft | plain: "
              f"{_fmt(spec)} | {_fmt(plain)}; tok/s ratio "
              f"{spec['tok_s'] / plain['tok_s']:.3f}", flush=True)
        for r in (spec, plain):
            r.pop("tokens")
            r.pop("plain_prefix", None)
        out[arm] = dict(spec=spec, plain=plain, spec_build=s_info,
                        vs_plain=ties)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def phase_spec() -> tuple:
    """Phase 17; returns (launch counts, the phase's numbers)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import LLAMA3_8B

    t0 = time.monotonic()
    smi = _smi()
    with _kernel_shapes() as shapes:
        parity, c1 = _spec_parity(LLAMA3_8B.vocab_size)
        llama, c2 = _spec_llama(smi, LLAMA3_8B.vocab_size)
        gpt2, c3 = _spec_gpt2(smi)
    launched = _held_shapes(shapes)
    counts = {n: c1.get(n, 0) + c2.get(n, 0) + c3.get(n, 0)
              for n in set(c1) | set(c2) | set(c3)}
    wall = time.monotonic() - t0
    print(f"[spec] {smi}: phase wall time {wall:.1f} s", flush=True)
    return counts, dict(card=smi, parity=parity, llama3_8b=llama,
                        gpt2_medium=gpt2, kernel_shapes=launched, wall_s=wall)


# --- phase 18: weight-only int8 and the MoE decoder ------------------------
def _moe_cfg():
    """18c's MoE decoder: moe_tiny's routing (4 experts, top-2, capacity
    1.25) on llama3_8b's widths, 2 layers. moe_tiny's own heads are 16
    wide, and the decode kernels take head_dim 64 or 128."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        TINY_MOE,
    )

    return dataclasses.replace(
        LLAMA3_8B, num_layers=2, num_experts=TINY_MOE.num_experts,
        moe_top_k=TINY_MOE.moe_top_k,
        moe_capacity_factor=TINY_MOE.moe_capacity_factor)


def _w8_logits(model) -> float:
    """Slab prefill of two prompts and one decode step through the int8
    kernel and through its plain version: the logits' max abs error."""
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul as qm

    rng = np.random.default_rng(0)
    V = model.cfg.vocab_size
    tokens = torch.from_numpy(rng.integers(0, V, (2, T)).astype(
        np.int32)).cuda()
    attn = torch.ones_like(tokens)
    attn[1, 50:] = 0
    nxt = torch.from_numpy(rng.integers(0, V, (2, 1)).astype(
        np.int32)).cuda()
    active = torch.ones((2,), dtype=torch.bool, device="cuda")

    def run():
        with torch.inference_mode():
            cache = model.make_cache(2, S)
            first, cache = model.prefill(tokens, attn, cache)
            second, _ = model.decode_step(nxt, cache, active)
            return first.float(), second.float()

    got = run()
    with qm.plain_products():
        want = run()
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def _w8_serve(tag: str, model, knobs: dict, payloads, plain: bool):
    """A quantized engine serving ``payloads``: graphed through the int8
    kernel, or eager through its plain version (``plain_products``).
    Returns (tokens, launch counts)."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import graphs
    from ray_dynamic_batching_tpu_torch.ops import quant_matmul as qm

    with graphs.disable_capture() if plain else contextlib.nullcontext():
        queue = RequestQueue("w8", max_len=64)
        engine = DecodeEngine(model, queue, device="cuda",
                              quantize_weights=True, **knobs)
        engine.warmup()
    reqs = [Request(model="w8", payload=p, slo_ms=600_000.0)
            for p in payloads]
    _reset_counts()
    with qm.plain_products() if plain else contextlib.nullcontext():
        for r in reqs:
            queue.add_request(r)
        engine.run_until_idle(timeout_s=300)
    torch.cuda.synchronize()
    counts = _counts()
    if plain:
        if counts["int8_weight_matmul"]:
            fail(f"{tag}: the plain route launched the int8 kernel")
    else:
        _expect_dispatches(tag, counts, engine)
        _steady(tag)
    if engine.paged:
        engine._allocator.check()
        if engine._allocator.free_pages != engine.num_pages:
            fail(f"{tag}: pages leaked")
    tokens = [r.future.result(5).tokens for r in reqs]
    engine.release_buffers()
    return tokens, counts


def _w8_parity(V: int) -> tuple:
    """18a: llama3_8b at full width, 2 layers, f32, quantized; phase 6's
    10 requests on five arms, each served graphed through the int8 kernel
    and eager through its plain version: greedy tokens identical."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.models.quant import quantize_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    payloads = _payloads(np.random.default_rng(1), V, 32, 8, 2, 2)
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    arms = {None: (("slab", SLAB_KNOBS), ("paged", PAGED_KNOBS),
                   ("slab_chunked", dict(SLAB_KNOBS, chunked_prefill=True))),
            torch.int8: (("int8", SLAB_KNOBS),
                         ("int8_paged", PAGED_KNOBS))}
    out, counts = {}, {}
    for kv_dtype, cases in arms.items():
        model = quantize_tree(CausalLM(cfg, "llama3_8b_2layer",
                                       dtype=torch.float32, device="cuda",
                                       seed=0, kv_dtype=kv_dtype))
        err = _w8_logits(model)
        kv = "int8 KV" if kv_dtype else "f32 cache"
        # With the int8 KV cache the k/v of the two routes, f32 sums in
        # another order, can round to codes one apart at a .5 boundary
        # (phase 4's case): printed, not gated; greedy tokens are.
        print(f"[weights] parity, int8 weights, {kv}: slab prefill and "
              f"decode logits, kernel against plain: max abs err "
              f"{err:.3e} ({'not gated' if kv_dtype else 'tol'} "
              f"{LOGIT_TOL:.0e})", flush=True)
        if not kv_dtype and not err <= LOGIT_TOL:
            fail(f"weights parity {kv}: logits differ by {err}")
        out[f"logits_err_{'int8kv' if kv_dtype else 'f32'}"] = err
        for arm, knobs in cases:
            tag = f"weights parity {arm}"
            want, _ = _w8_serve(tag + " plain", model, knobs, payloads,
                                plain=True)
            got, c = _w8_serve(tag, model, knobs, payloads, plain=False)
            _greedy_same(tag, got, want, payloads)
            print(f"[weights] {tag}: greedy tokens of the int8 kernel route "
                  f"identical to the plain route's; launches {c}",
                  flush=True)
            out[arm] = {"greedy_identical": True,
                        "int8_launches": c["int8_weight_matmul"]}
            for n, v in c.items():
                counts[n] = counts.get(n, 0) + v
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out, counts


# Kernel names of the profiled int8 windows by role: the decode step's
# and the fills' weight products, attention, the head (both).
W8_PROFILE_ROLES = (("decode GEMM", "stream_kernel<__nv_bfloat16"),
                    ("prefill GEMM", "wgmma_kernel<"),
                    ("head / router GEMM", "stream_kernel<float"),
                    ("decode attention", "decode_kernel<"),
                    ("prefill attention", "flash_"))


def _w8_by_kernel(tag: str, run: dict) -> None:
    """18b's profiled int8 window of one arm by kernel: device ms and
    launches, the int8 GEMM's decode body (``stream_kernel<bf16``) a
    decode step and its prefill body (``wgmma_kernel``) a fill, beside
    attention and the rest."""
    d = run["prof_dispatch"]
    steps = d["steps"]
    fills = (d["prefill_groups"] + d["long_chunk_dispatches"]
             + d["chunk_dispatches"])
    busy = sum(ms for _, _, ms in run["by_kernel"])
    roles = {r: 0.0 for r, _ in W8_PROFILE_ROLES}
    rest = 0.0
    for name, _, ms in run["by_kernel"]:
        role = next((r for r, key in W8_PROFILE_ROLES if key in name), None)
        if role is None:
            rest += ms
        else:
            roles[role] += ms
    split = "; ".join(f"{r} {ms:.2f} ms" for r, ms in roles.items())
    print(f"[weights] profile {tag}: {busy:.2f} ms busy in a "
          f"{run['window_ms']:.1f} ms window of {steps} steps and {fills} "
          f"fills: {split}; the rest {rest:.2f} ms; decode GEMMs "
          f"{roles['decode GEMM'] / max(steps, 1):.3f} ms a step, prefill "
          f"GEMMs {roles['prefill GEMM'] / max(fills, 1):.3f} ms a fill; "
          f"by kernel:", flush=True)
    for name, count, ms in run["by_kernel"][:16]:
        print(f"[weights]   {ms:9.3f} ms {count:7d} x {1e3 * ms / count:8.2f} us"
              f"  {name[:110]}", flush=True)


def _w8_llama(smi: str, V: int, profile: bool = False) -> tuple:
    """18b: llama3_8b bf16 at full width, SPEED_LAYERS deep, seed 0, served on the
    slab (phase 5's 8 requests) and the pool (phase 6's 10), without and
    then with int8 weights (the same model, quantized on the card)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.models.quant import (
        quantize_tree,
        tree_weight_bytes,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.config import (
        RDBConfig,
        reset_config,
        set_config,
    )

    loads = {"slab": (SLAB_KNOBS, _payloads(np.random.default_rng(0), V, 32,
                                            8, 2, 0)),
             "paged": (PAGED_KNOBS, _payloads(np.random.default_rng(1), V,
                                              32, 8, 2, 2))}
    model = _speed_model(device="cuda")
    budget = torch.cuda.get_device_properties(0).total_memory
    runs, counts = {}, {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            t0 = time.monotonic()
            quantize_tree(model)
            torch.cuda.synchronize()
            runs["quantize_s"] = time.monotonic() - t0
        set_config(RDBConfig.from_env(hbm_budget_bytes=budget))
        try:
            slots = LLMDeployment(
                "llama3_8b", model=model, quantize_weights=mode == "int8",
                **SLAB_KNOBS).auto_num_slots(1, max_len=S)
        finally:
            reset_config()
        runs[mode] = {"weights_gb": tree_weight_bytes(model) / 1e9,
                      "auto_num_slots": slots}
        for arm, (knobs, load) in loads.items():
            run = _speed_run(f"weights {arm} {mode}", model, load,
                             dict(knobs, quantize_weights=mode == "int8"),
                             eager=False)
            if profile and mode == "int8":
                _w8_by_kernel(f"{arm} int8 weights ({smi})", run)
            run.pop("by_kernel")
            runs[mode][arm] = run
            for n, v in run.pop("counts").items():
                counts[n] = counts.get(n, 0) + v
    for arm, (knobs, load) in loads.items():
        b, q = runs["bf16"][arm], runs["int8"][arm]
        turn = " | ".join(" / ".join(f"{r['turn_ms_a_step_p50'][h]:.2f} (h{h})"
                                     for h in r["turn_ms_a_step_p50"])
                          for r in (b, q))
        idle = " | ".join("not traced" if r["idle_share"] is None else
                          f"{100 * r['idle_share']:.1f}%" for r in (b, q))
        print(f"[weights] llama3_8b {arm} ({smi}), bf16 | int8 weights: "
              f"tok/s {b['tok_s']:.1f} | {q['tok_s']:.1f}; TTFT p50 "
              f"{b['ttft_p50_ms']:.1f} | {q['ttft_p50_ms']:.1f} ms (max "
              f"{b['ttft_max_ms']:.1f} | {q['ttft_max_ms']:.1f}); "
              f"decode.turn ms a step p50 {turn}; device idle {idle}; "
              f"resident weights {runs['bf16']['weights_gb']:.2f} | "
              f"{runs['int8']['weights_gb']:.2f} GB; auto_num_slots at "
              f"max_len {S} {runs['bf16']['auto_num_slots']} | "
              f"{runs['int8']['auto_num_slots']}; captures after warmup 0; "
              f"built and warmed in {b['build_and_warm_s']:.1f} | "
              f"{q['build_and_warm_s']:.1f} s", flush=True)
        for i, p in enumerate(load):
            if p.get("temperature"):
                continue
            same = b["tokens"][i] == q["tokens"][i]
            print(f"[weights] {arm} greedy row {i} (different weights, not "
                  f"gated){' identical' if same else ''}: bf16 "
                  f"{b['tokens'][i][:8]}... int8 {q['tokens'][i][:8]}...",
                  flush=True)
        for r in (b, q):
            r.pop("tokens")
    print(f"[weights] quantized llama3_8b on the card in "
          f"{runs['quantize_s']:.1f} s", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return runs, counts


def _w8_moe(V: int) -> tuple:
    """18c: the MoE decoder (:func:`_moe_cfg`), bf16, on the slab and the
    pool, without and with int8 weights: graphed greedy tokens identical
    to eager, nothing captured after warmup."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import CausalLM
    from ray_dynamic_batching_tpu_torch.models.quant import quantize_tree

    payloads = _payloads(np.random.default_rng(1), V, 32, 8, 2, 2)
    out, counts = {}, {}
    for quant in (False, True):
        model = CausalLM(_moe_cfg(), "moe_llama_2layer",
                         dtype=torch.bfloat16, device="cuda", seed=0)
        if quant:
            quantize_tree(model)
        for arm, knobs in (("slab", SLAB_KNOBS), ("paged", PAGED_KNOBS)):
            name = f"moe {arm}{' int8' if quant else ''}"
            row = _graph_parity(model, arm, dict(knobs, quantize_weights=quant),
                                payloads, tag=f"weights {name}")
            for n, v in row.pop("counts").items():
                counts[n] = counts.get(n, 0) + v
            out[name] = row
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out, counts


def phase_weights(profile: bool = False) -> tuple:
    """Phase 18; returns (launch counts, the phase's numbers). With
    ``profile``, 18b's int8 windows are printed by kernel."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import LLAMA3_8B

    t0 = time.monotonic()
    smi = _smi()
    V = LLAMA3_8B.vocab_size
    with _kernel_shapes() as shapes:
        parity, c1 = _w8_parity(V)
        llama, c2 = _w8_llama(smi, V, profile)
        moe, c3 = _w8_moe(V)
    launched = _held_shapes(shapes, "weights", 18)
    counts = {n: c1.get(n, 0) + c2.get(n, 0) + c3.get(n, 0)
              for n in set(c1) | set(c2) | set(c3)}
    wall = time.monotonic() - t0
    print(f"[weights] {smi}: phase wall time {wall:.1f} s", flush=True)
    return counts, dict(card=smi, parity=parity, llama3_8b=llama, moe=moe,
                        kernel_shapes=launched, wall_s=wall)


# --- phase 19: the remaining servables ---------------------------------------
SERVABLES = dict(
    # 19a: f32 parity, kernel route against plain_attention().
    bert_batch=4, bert_seq=128,
    asr_layers=2, asr_batch=2, asr_frames=(3000, 2400), asr_text=16,
    gpt2_layers=2, gpt2_batch=2, gpt2_seq=128,
    tiny_lms=("llama_tiny", "llama_tiny_int8kv", "moe_tiny"),
    tiny_knobs={"slab": dict(num_slots=4, max_len=64, prompt_buckets=[8, 16],
                             default_max_new_tokens=6),
                "paged": dict(num_slots=4, max_len=256,
                              prompt_buckets=[8, 16],
                              default_max_new_tokens=6, paged=True)},
    tiny_prompts=(3, 7, 12, 5),
    tiny_clips=(90, 160), tiny_chunk=100, tiny_new=4,
    # 19b: distilbert_sst2 bf16, tools/run_profiles.py:45's buckets, then
    # one replica at phase 13's rate rule under the 100 ms SLO.
    bert_buckets=[1, 8, 32, 128, 256, 512], bert_seqs=(64, 128, 256),
    bert_serve_seq=128, bert_tokens=(8, 128), bert_util=0.010,
    max_rps=200.0, min_rps=0.2, bert_duration_s=12.0, gate=0.95,
    hbm_budget_bytes=12 << 30,
    # 19c: whisper_large_v3 bf16 at full depth: bench_asr_rtf's shape,
    # a 10 s stream in 200-frame chunks, the served roundtrip.
    rtf_batch=8, rtf_audio_s=30.0, rtf_tokens=32, rtf_repeats=3,
    stream_frames=1000, stream_chunk=200, stream_feed=100, stream_new=8,
    serve_clips=(150, 120, 180, 90),
    # 19d: gpt2_medium's no-cache rows (tools/run_profiles.py:46).
    gpt2_buckets=[1, 4, 8, 16, 32], gpt2_seqs=(64, 128, 256),
    warmup_iters=2, timing_iters=4,
)
BERT_LAYERS = 6
WHISPER_MAX_NEW = SERVABLES["stream_new"]


def _profiler_forwards(warmup_iters: int, timing_iters: int) -> int:
    """Forwards ``ModelProfiler.profile_bucket`` runs for one row: the
    first dispatch, ``warmup_iters - 1`` more (at least one) and three
    samples of ``max(timing_iters, 2)``."""
    return 1 + max(warmup_iters - 1, 1) + 3 * max(timing_iters, 2)


def _route_parity(tag: str, model, inputs, launches: dict, tol: float,
                  valid=None) -> dict:
    """One forward of ``model`` through the kernel route and one under
    ``plain_attention()``: the max abs logit error (over ``valid`` rows),
    identical argmax, and the kernel launches of the kernel route equal
    to ``launches``."""
    from ray_dynamic_batching_tpu_torch.ops import attention

    _reset_counts()
    with torch.inference_mode():
        out = model(*inputs)
        torch.cuda.synchronize()
        counts = _counts()
        with attention.plain_attention():
            ref = model(*inputs)
    torch.cuda.synchronize()
    if valid is not None:
        out, ref = out[valid], ref[valid]
    if not bool(torch.isfinite(out).all()):
        fail(f"{tag}: non-finite logits")
    err = (out.float() - ref.float()).abs().max().item()
    same = bool((out.argmax(-1) == ref.argmax(-1)).all())
    print(f"[servables] parity {tag}: kernel route vs plain route max abs "
          f"logit err {err:.3e} (max |logit| {ref.abs().max().item():.3f}; "
          f"tol {tol:.0e}), argmax identical {same}; launches {counts}",
          flush=True)
    _expect_only(f"servables {tag}", counts, launches)
    if not err <= tol or not same:
        fail(f"servables {tag}: logits off the plain route by {err} "
             f"(argmax identical: {same})")
    _reset_counts()
    return {"max_abs_err": err, "launches": counts}


def _asr_transcribe(model, mel, mask, tokens: int) -> tuple:
    """``bench_asr_rtf``'s program, eagerly: encode, a one-token SOT
    prefill into a cache of ``tokens + 8``, ``tokens - 1`` greedy steps;
    the tokens [B, tokens] fetched at the end. Returns (tokens, seconds of
    encode, prefill, steps), each part ended by a synchronize."""
    B = mel.shape[0]
    cfg = model.cfg
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, emask = model.encode(mel, mask)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = model.make_cache(B, max_len=tokens + 8)
        sot = torch.full((B, 1), cfg.sot_token, dtype=torch.int32,
                         device="cuda")
        last, cache = model.prefill(sot, torch.ones_like(sot), enc, emask,
                                    cache)
        tok = torch.argmax(last.float(), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = [tok]
        active = torch.ones((B,), dtype=torch.bool, device="cuda")
        for _ in range(tokens - 1):
            logits, cache = model.decode_step(out[-1][:, None], enc, emask,
                                              cache, active)
            out.append(torch.argmax(logits.float(), dim=-1).to(torch.int32))
        toks = torch.stack(out, dim=1).cpu()
        t3 = time.perf_counter()
    return toks, (t1 - t0, t2 - t1, t3 - t2)


def _digest(tokens) -> str:
    """sha1 of greedy tokens (a tensor or nested lists), to compare runs of
    two trees."""
    import hashlib

    if isinstance(tokens, torch.Tensor):
        tokens = tokens.tolist()
    return hashlib.sha1(json.dumps(tokens).encode()).hexdigest()[:16]


def _asr_logits_at(model, clip, k: int, prefix=None):
    """f32 logits of the k-th token ``StreamingASR`` emits for ``clip``
    (one flush: the clip is shorter than a chunk), by its greedy loop, or
    with ``prefix`` (a transcript, the start token first) fed that
    transcript's tokens instead of its own argmax."""
    from ray_dynamic_batching_tpu_torch.models.asr import collate_audio

    cfg = model.cfg
    mel, mask = collate_audio([clip], 1)
    with torch.inference_mode():
        enc, emask = model.encode(torch.from_numpy(mel).cuda(),
                                  torch.from_numpy(mask).cuda())
        tokens = torch.zeros((1, 16), dtype=torch.int32, device="cuda")
        tokens[0, 0] = cfg.sot_token
        text = torch.zeros_like(tokens)
        text[0, 0] = 1
        cache = model.make_cache(1, max_len=16 + SERVABLES["stream_new"])
        logits, cache = model.prefill(tokens, text, enc, emask, cache)
        active = torch.ones((1,), dtype=torch.bool, device="cuda")
        for i in range(k):
            step = (torch.argmax(logits[0].float()) if prefix is None else
                    torch.tensor(prefix[i + 1], device="cuda"))
            logits, cache = model.decode_step(step.to(torch.int32).view(1, 1),
                                              enc, emask, cache, active)
        return logits[0].float()


def _asr_forced_logits(model, mel, mask, toks, at) -> dict:
    """f32 logits [B, V] of ``_asr_transcribe``'s program (the same cache
    length) at each token index in ``at``, every step fed ``toks``'s
    previous token ([B, T]) instead of its own argmax."""
    B = mel.shape[0]
    cfg = model.cfg
    out = {}
    with torch.inference_mode():
        enc, emask = model.encode(mel, mask)
        cache = model.make_cache(B, max_len=SERVABLES["rtf_tokens"] + 8)
        sot = torch.full((B, 1), cfg.sot_token, dtype=torch.int32,
                         device="cuda")
        logits, cache = model.prefill(sot, torch.ones_like(sot), enc, emask,
                                      cache)
        active = torch.ones((B,), dtype=torch.bool, device="cuda")
        for j in range(max(at) + 1):
            if j:
                logits, cache = model.decode_step(
                    toks[:, j - 1:j].to(torch.int32).cuda(), enc, emask,
                    cache, active)
            if j in at:
                out[j] = logits.float()
    return out


def _gaps(lg, a: int, b: int) -> dict:
    """The top of one row of logits and the gaps of tokens a and b below
    it, against two bf16 ulps of the top."""
    import math

    top = lg.max().item()
    tol = 2 * 2.0 ** (math.floor(math.log2(abs(top))) - 7)
    gaps = [top - lg[a].item(), top - lg[b].item()]
    return dict(top=top, gaps=gaps, tol=tol, near_tie=max(gaps) <= tol)


def _witness_of(lg, a: int, b: int) -> dict:
    """What f32 logits say of two candidate tokens: the top token, each
    candidate's gap below the top, and which of the two is higher."""
    top = lg.max().item()
    la, lb = lg[a].item(), lg[b].item()
    return dict(top_token=int(lg.argmax().item()), gaps=[top - la, top - lb],
                picks="this" if la > lb else "other" if lb > la else "tie")


def whisper_tokens(reference=None, witness: bool = False) -> dict:
    """19c's greedy outputs alone, for a tree whose script does not print
    them: the RTF batch's tokens and the served clips' direct transcripts
    (``_asr_serving``'s inputs from the same seed), as sha1 digests. With
    ``reference`` (another tree's ``whisper_tokens``), each served clip
    and each RTF row that differs is measured where it first differs (the
    two trees share the tokens before it): this tree's top logit there
    and the gaps of both tokens below it, against two bf16 ulps of the top
    (a near tie, which rounding in either tree may break either way).
    With ``witness``, the same logits also come from the bf16 weights cast
    to f32 on the attention's plain route, TF32 off (no kernel of either
    tree runs): which of the two tokens they put higher."""
    from ray_dynamic_batching_tpu_torch.models.asr import StreamingASR
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.ops import attention

    c = SERVABLES
    model = get_model("whisper_large_v3", seed=0).eval()
    cfg = model.cfg
    rng = np.random.default_rng(3)
    B, frames = c["rtf_batch"], int(c["rtf_audio_s"] * 100)
    mel = torch.from_numpy(rng.standard_normal((B, frames, cfg.n_mels))
                           .astype(np.float32)).cuda()
    mask = torch.ones((B, frames), dtype=torch.int32, device="cuda")
    toks = _asr_transcribe(model, mel, mask, c["rtf_tokens"])[0]
    rng.standard_normal((c["stream_frames"], cfg.n_mels))   # the stream's clip
    clips = [rng.standard_normal((n, cfg.n_mels)).astype(np.float32)
             for n in c["serve_clips"]]
    direct = []
    for a in clips:
        asr = StreamingASR(model, chunk_frames=c["stream_chunk"],
                           max_new_tokens=c["stream_new"])
        asr.feed(a)
        if asr._buffer:
            asr.flush()
        direct.append(asr.transcript)
    out = dict(rtf=_digest(toks), served=_digest(direct), direct=direct,
               rtf_tokens=toks.tolist())
    if reference is None:
        return out
    clip_diffs, row_diffs = [], []
    for i, (got, want) in enumerate(zip(direct, reference["direct"])):
        j = _first_difference(got, want)
        if j is not None:
            lg = _asr_logits_at(model, clips[i], j - 1)
            clip_diffs.append(dict(clip=i, index=j, tokens=[got[j], want[j]],
                                   **_gaps(lg, got[j], want[j])))
    for r, (got, want) in enumerate(zip(out["rtf_tokens"],
                                        reference["rtf_tokens"])):
        j = _first_difference(got, want)
        if j is not None:
            row_diffs.append(dict(row=r, index=j, tokens=[got[j], want[j]]))
    if row_diffs:
        forced = _asr_forced_logits(model, mel, mask, toks,
                                    {d["index"] for d in row_diffs})
        for d in row_diffs:
            d.update(_gaps(forced[d["index"]][d["row"]], *d["tokens"]))
    if witness and (clip_diffs or row_diffs):
        f32 = get_model("whisper_large_v3", seed=None,
                        dtype=torch.float32).eval()
        f32.load_state_dict(model.state_dict())    # the bf16 weights, cast
        del model
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with attention.plain_attention():
                for d in clip_diffs:
                    lg = _asr_logits_at(f32, clips[d["clip"]], d["index"] - 1,
                                        prefix=direct[d["clip"]])
                    d["witness"] = _witness_of(lg, *d["tokens"])
                if row_diffs:
                    forced = _asr_forced_logits(
                        f32, mel, mask, toks, {d["index"] for d in row_diffs})
                    for d in row_diffs:
                        d["witness"] = _witness_of(
                            forced[d["index"]][d["row"]], *d["tokens"])
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    out["differences"] = clip_diffs
    out["rtf_differences"] = row_diffs
    return out


def _mel_batch(rng, frames, n_mels: int):
    """Ragged clips of ``frames`` each (numpy) and their collated
    (mel, mask) on the card."""
    from ray_dynamic_batching_tpu_torch.models.asr import collate_audio

    clips = [rng.standard_normal((n, n_mels)).astype(np.float32)
             for n in frames]
    mel, mask = collate_audio(clips, len(clips))
    return clips, torch.from_numpy(mel).cuda(), torch.from_numpy(mask).cuda()


def _tiny_lm_parity(name: str, c: dict) -> dict:
    """A registry tiny decoder (head_dim 16) through ``LLMDeployment`` on
    the card, f32, slab and paged: greedy tokens equal to an eager
    deployment on the plain route; the decode kernels launch."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.ops import attention, graphs
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).tolist() for n in c["tiny_prompts"]]
    out = {}
    for arm, knobs in c["tiny_knobs"].items():
        runs = {}
        for mode in ("kernel", "plain"):
            with contextlib.ExitStack() as ctx:
                if mode == "plain":
                    ctx.enter_context(attention.plain_attention())
                    ctx.enter_context(graphs.disable_capture())
                dep = LLMDeployment(name, dtype=torch.float32, seed=0,
                                    device="cuda", **knobs)
                replica = dep.make_replica(f"{name}-{arm}",
                                           DeploymentConfig(name=name))
                engine = replica.engine
                reqs = [Request(model=name, payload={"tokens": p},
                                slo_ms=600_000.0) for p in prompts]
                _reset_counts()
                for r in reqs:
                    engine.queue.add_request(r)
                engine.run_until_idle(timeout_s=300)
                torch.cuda.synchronize()
                runs[mode] = ([r.future.result(5).tokens for r in reqs],
                              _counts())
                engine.release_buffers()
        tokens, counts = runs["kernel"]
        kind = "paged_decode_attention" if arm == "paged" else \
            "decode_attention"
        if name.endswith("int8kv"):
            kind += "_int8"
        same = tokens == runs["plain"][0]
        print(f"[servables] {name} {arm} f32 (head_dim 16): greedy tokens "
              f"identical to the plain route {same}; launches {counts}",
              flush=True)
        if not same:
            fail(f"servables {name} {arm}: greedy tokens differ from the "
                 "plain route")
        if not counts.get(kind) or counts.get("plain"):
            fail(f"servables {name} {arm}: {kind} never launched, or the "
                 f"plain route did: {counts}")
        out[arm] = {"greedy_identical": True, "launches": counts}
    _reset_counts()
    return out


def _tiny_asr_parity(c: dict) -> dict:
    """``whisper_tiny_test`` (head_dim 16) streaming on the card, f32:
    transcripts through the kernel route equal the plain route's, and
    the decode kernel launches (its steps and cross reads)."""
    from ray_dynamic_batching_tpu_torch.models.asr import StreamingASR
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.ops import attention

    model = get_model("whisper_tiny_test", dtype=torch.float32, seed=0)
    clips, _, _ = _mel_batch(np.random.default_rng(7), c["tiny_clips"],
                             model.cfg.n_mels)
    runs = {}
    for mode in ("kernel", "plain"):
        ctx = (attention.plain_attention() if mode == "plain"
               else contextlib.nullcontext())
        with ctx:
            _reset_counts()
            got = []
            for clip in clips:
                stream = StreamingASR(model, chunk_frames=c["tiny_chunk"],
                                      max_new_tokens=c["tiny_new"])
                for i in range(0, len(clip), 50):
                    stream.feed(clip[i:i + 50])
                stream.flush()
                got.append(stream.transcript)
            torch.cuda.synchronize()
            runs[mode] = (got, _counts())
    same = runs["kernel"][0] == runs["plain"][0]
    counts = runs["kernel"][1]
    print(f"[servables] whisper_tiny_test f32 (head_dim 16) streaming: "
          f"transcripts identical to the plain route {same} "
          f"({runs['kernel'][0]}); launches {counts}", flush=True)
    if not same:
        fail("servables whisper_tiny_test: transcripts differ from the "
             "plain route")
    if not counts["decode_attention"] or not counts["flash_attention"]:
        fail(f"servables whisper_tiny_test: a kernel never launched: "
             f"{counts}")
    _reset_counts()
    return {"transcripts_identical": True, "launches": counts}


def _servable_parity(c: dict) -> dict:
    """19a: each servable's kernel route against its plain route, f32,
    TF32 off."""
    from ray_dynamic_batching_tpu_torch.models.asr import (
        WHISPER_LARGE_V3,
        ASRModel,
    )
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        GPT2_MEDIUM,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.ops import attention

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    rng = np.random.default_rng(19)
    try:
        # DistilBERT-SST2 at full width and depth: flash at T = 128 with
        # a key mask; T = 8 takes the slab decode kernel.
        bert = get_model("distilbert_sst2", dtype=torch.float32,
                         seed=0).eval()
        for T, kind in ((c["bert_seq"], "flash_attention"),
                        (8, "decode_attention")):
            B = c["bert_batch"]
            ids = torch.from_numpy(rng.integers(0, 30522, (B, T)).astype(
                np.int32)).cuda()
            lens = np.linspace(T // 2, T, B).astype(int)
            mask = torch.from_numpy((np.arange(T)[None, :] < lens[:, None])
                                    .astype(np.int32)).cuda()
            out[f"distilbert_sst2_T{T}"] = _route_parity(
                f"distilbert_sst2 T={T}", bert, (ids, mask),
                {kind: BERT_LAYERS}, LOGIT_TOL)
        del bert
        # Whisper-large-v3 at full width, 2 + 2 layers: teacher-forced
        # logits, then bench_asr_rtf's transcribe loop.
        cfg = dataclasses.replace(WHISPER_LARGE_V3,
                                  enc_layers=c["asr_layers"],
                                  dec_layers=c["asr_layers"])
        asr = ASRModel(cfg, "whisper_large_v3_2layer", dtype=torch.float32,
                       device="cuda", seed=0).eval()
        _, mel, mask = _mel_batch(rng, c["asr_frames"], cfg.n_mels)
        Tt = c["asr_text"]
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
            len(c["asr_frames"]), Tt)).astype(np.int32)).cuda()
        tmask = torch.ones_like(tokens)
        tmask[1, Tt - 5:] = 0
        L = c["asr_layers"]
        out["whisper_apply"] = _route_parity(
            "whisper_large_v3 (2+2 layers) apply", asr,
            (mel, mask, tokens, tmask),
            {"flash_attention": L + 2 * L}, LOGIT_TOL, valid=tmask.bool())
        runs = {}
        for mode in ("kernel", "plain"):
            ctx = (attention.plain_attention() if mode == "plain"
                   else contextlib.nullcontext())
            with ctx:
                _reset_counts()
                toks, _ = _asr_transcribe(asr, mel, mask, c["rtf_tokens"])
                runs[mode] = (toks, _counts())
        same = torch.equal(runs["kernel"][0], runs["plain"][0])
        want = {"flash_attention": L,
                "decode_attention": 2 * L * c["rtf_tokens"]}
        print(f"[servables] parity whisper_large_v3 (2+2 layers) transcribe "
              f"{c['rtf_tokens']} tokens x {mel.shape[0]}: greedy tokens "
              f"identical {same}; launches {runs['kernel'][1]}", flush=True)
        _expect_only("servables whisper transcribe", runs["kernel"][1], want)
        if not same:
            fail("servables whisper_large_v3: transcribe tokens differ from "
                 "the plain route")
        out["whisper_transcribe"] = {"greedy_identical": True,
                                     "launches": runs["kernel"][1]}
        del asr
        # gpt2_medium.apply at full width, 2 layers: causal flash with the
        # token mask.
        gpt2 = CausalLM(dataclasses.replace(GPT2_MEDIUM,
                                            num_layers=c["gpt2_layers"]),
                        "gpt2_medium_2layer", dtype=torch.float32,
                        device="cuda", seed=0).eval()
        T = c["gpt2_seq"]
        ids = torch.from_numpy(rng.integers(0, GPT2_MEDIUM.vocab_size, (
            c["gpt2_batch"], T)).astype(np.int32)).cuda()
        gmask = torch.ones_like(ids)
        gmask[1, T - 40:] = 0
        out["gpt2_medium_apply"] = _route_parity(
            "gpt2_medium (2 layers) apply", gpt2, (ids, gmask),
            {"flash_attention": c["gpt2_layers"]}, LOGIT_TOL,
            valid=gmask.bool())
        del gpt2
        # The tiny servables (head_dim 16): the decode kernels at 16.
        bert = get_model("distilbert_tiny", dtype=torch.float32,
                         seed=0).eval()
        for T, kind in ((16, "flash_attention"), (8, "decode_attention")):
            ids = torch.from_numpy(rng.integers(0, 1000, (4, T)).astype(
                np.int32)).cuda()
            mask = torch.ones_like(ids)
            mask[1, T // 2:] = 0
            mask[3, 1:] = 0
            out[f"distilbert_tiny_T{T}"] = _route_parity(
                f"distilbert_tiny T={T}", bert, (ids, mask), {kind: 2}, 1e-4)
        del bert
        for name in c["tiny_lms"]:
            out[name] = _tiny_lm_parity(name, c)
        out["whisper_tiny_test"] = _tiny_asr_parity(c)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _sweep(tag: str, model, buckets, seqs, c: dict) -> tuple:
    """``ModelProfiler`` over (batch, seq) buckets, stopped by the
    profiler as ``tools/run_profiles.py``'s sweep is; rows written to
    ``PROFILES_DIR`` and printed with ``flops_per_sample`` and the
    achieved rate. Returns (the table read back, printed rows, forwards
    run)."""
    from ray_dynamic_batching_tpu_torch.profiles.profiler import ModelProfiler
    from ray_dynamic_batching_tpu_torch.profiles.table import BatchProfile

    profiler = ModelProfiler(model, warmup_iters=c["warmup_iters"],
                             timing_iters=c["timing_iters"])
    prof = profiler.sweep(batch_buckets=buckets, seq_buckets=seqs)
    if not prof.rows:
        fail(f"{tag}: no feasible bucket")
    csv_path, _, _ = profiler.write_outputs(prof, PROFILES_DIR)
    rows = []
    for r in prof.rows:
        r = r.with_throughput()
        flops = model.flops_per_sample(r.seq_len)
        tflops = flops * r.batch_size / (r.latency_ms * 1e-3) / 1e12
        rows.append(dict(batch=r.batch_size, seq=r.seq_len,
                         latency_ms=r.latency_ms,
                         latency_std_ms=r.latency_std_ms,
                         throughput_sps=r.throughput_sps,
                         hbm_bytes=r.hbm_bytes, first_ms=r.compile_ms,
                         flops_per_sample=flops, tflop_s=tflops))
        print(f"[servables] {tag} b={r.batch_size} s={r.seq_len}: "
              f"{r.latency_ms:.3f} ms (std {r.latency_std_ms:.3f}), "
              f"{r.throughput_sps:.1f} samples/s, flops_per_sample "
              f"{flops:.4g}, {tflops:.1f} TFLOP/s, hbm_bytes {r.hbm_bytes}, "
              f"first dispatch {r.compile_ms:.1f} ms", flush=True)
    forwards = len(prof.rows) * _profiler_forwards(c["warmup_iters"],
                                                   c["timing_iters"])
    return BatchProfile.from_csv(model.name, csv_path), rows, forwards


def _bert_serving(c: dict) -> tuple:
    """19b: distilbert_sst2 bf16 — the profile sweep, then one
    ``ReplicaEngine`` planned by ``SquishyBinPacker`` from those rows under
    Poisson arrivals of ragged token ids. Returns (counts, numbers)."""
    from ray_dynamic_batching_tpu_torch.engine import worker
    from ray_dynamic_batching_tpu_torch.engine.host import ModelHost
    from ray_dynamic_batching_tpu_torch.engine.queue import QueueManager
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.engine.workload import (
        RatePattern,
        WorkloadDriver,
    )
    from ray_dynamic_batching_tpu_torch.models.base import get_model, get_slo
    from ray_dynamic_batching_tpu_torch.scheduler.control import (
        LiveScheduler,
    )
    from ray_dynamic_batching_tpu_torch.scheduler.nexus import (
        SquishyBinPacker,
    )

    name = "distilbert_sst2"
    slo = get_slo(name).latency_slo_ms
    model = get_model(name).eval()
    _reset_counts()
    prof, rows, forwards = _sweep(f"profile {name}", model,
                                  c["bert_buckets"], c["bert_seqs"], c)
    torch.cuda.synchronize()
    counts = _counts()
    _expect_only(f"servables profile {name}", counts,
                 {"flash_attention": BERT_LAYERS * forwards})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    seq = c["bert_serve_seq"]
    rate = min(c["max_rps"], max(c["min_rps"],
                                 c["bert_util"] * prof.max_throughput(seq)))
    queues = QueueManager()
    host = ModelHost()
    engine = worker.ReplicaEngine("bert0", queues, host)
    sched = LiveScheduler(SquishyBinPacker(
        {name: prof}, hbm_budget_bytes=c["hbm_budget_bytes"]), [engine],
        queues=queues)
    sched.register_model(name, slo_ms=slo, seq_len=seq)
    lo, hi = c["bert_tokens"]
    pay_rng = np.random.default_rng(23)

    def submit(model_name: str, _offset: float) -> None:
        n = int(pay_rng.integers(lo, hi + 1))
        sched.submit_request(Request(
            model=model_name, slo_ms=slo,
            payload=pay_rng.integers(0, 30522, n).astype(np.int32)))

    def batches():
        return worker.BATCHES_TOTAL.get(tags={"engine": "bert0",
                                              "model": name})

    b0 = batches()
    _reset_counts()
    engine.start()
    try:
        plans = sched.rebalance(rates={name: rate})
        for p in plans:
            print(f"[servables] plan: {p.describe()}", flush=True)
        deadline = time.monotonic() + 120
        while name not in engine.models:
            if time.monotonic() > deadline:
                fail("servables: the engine never loaded distilbert_sst2")
            time.sleep(0.1)
        engine.busy_ms = 0.0
        driver = WorkloadDriver(submit, name, RatePattern(
            "constant", base_rps=rate), duration_s=c["bert_duration_s"],
            poisson=True, seed=29)
        t0 = time.monotonic()
        driver.start()
        time.sleep(max(0.0, c["bert_duration_s"] / 2
                       - (time.monotonic() - t0)))
        mid = dict(queues.queue(name).stats())
        driver.join(c["bert_duration_s"] + 60)
        deadline = time.monotonic() + 60
        while len(queues.queue(name)) > 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        time.sleep(0.5)
        wall = time.monotonic() - t0
        end = queues.queue(name).stats()
        busy = engine.busy_ms / (wall * 1e3)
    finally:
        engine.stop()
    torch.cuda.synchronize()
    served = batches() - b0
    warmups = sum(1 for k in engine._warmed if k[0] == name)
    counts = _counts()
    _expect_only("servables distilbert serving", counts,
                 {"flash_attention": BERT_LAYERS * (served + warmups)})
    zero = {k: 0 for k in COUNTER_FIELDS}
    p1 = _phase_compliance(zero, mid)
    p2 = _phase_compliance(mid, end)
    lost = driver.sent - (end["completed"] + end["stale"] + end["dropped"])
    print(f"[servables] {name} bf16 served at {rate:.2f} rps (0.010 x "
          f"the profiled peak at seq {seq}) for {c['bert_duration_s']:.0f} "
          f"s, SLO {slo:.0f} ms: sent {driver.sent}, completed "
          f"{end['completed']:.0f}, stale {end['stale']:.0f}, dropped "
          f"{end['dropped']:.0f}, unaccounted {lost:.0f}; compliance first "
          f"half {p1['slo_compliance']:.4f}, second half "
          f"{p2['slo_compliance']:.4f}; latency p95 "
          f"{end['latency_p95_ms']:.1f} ms, p99 {end['latency_p99_ms']:.1f}"
          f" ms; {served} batches + {warmups} warm-ups, busy share "
          f"{busy:.3f}; launches {counts}", flush=True)
    if lost or end["depth"]:
        fail(f"servables {name}: {lost:.0f} requests unaccounted for, "
             f"{end['depth']:.0f} still queued")
    worst = min(p1["slo_compliance"], p2["slo_compliance"])
    if worst < c["gate"]:
        fail(f"servables {name}: SLO compliance {worst:.4f} under "
             f"{c['gate']}")
    return counts, dict(profile=rows, rate_rps=rate, sent=driver.sent,
                        completed=end["completed"], stale=end["stale"],
                        dropped=end["dropped"], phase1=p1, phase2=p2,
                        p95_ms=end["latency_p95_ms"],
                        p99_ms=end["latency_p99_ms"], batches=served,
                        warmups=warmups, busy_share=busy, wall_s=wall)


def _asr_serving(c: dict) -> tuple:
    """19c: whisper_large_v3 bf16 at full width and depth:
    ``bench_asr_rtf``'s shape (median of 3), a 10 s stream in 200-frame
    chunks, and the served roundtrip controller -> router -> replica ->
    ``StreamingASR``, each transcript equal to a direct run."""
    from ray_dynamic_batching_tpu_torch.models.asr import StreamingASR
    from ray_dynamic_batching_tpu_torch.models.base import get_model
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle

    model = get_model("whisper_large_v3", seed=0).eval()
    cfg = model.cfg
    rng = np.random.default_rng(3)
    B, frames = c["rtf_batch"], int(c["rtf_audio_s"] * 100)
    mel = torch.from_numpy(rng.standard_normal((B, frames, cfg.n_mels))
                           .astype(np.float32)).cuda()
    mask = torch.ones((B, frames), dtype=torch.int32, device="cuda")
    _asr_transcribe(model, mel, mask, c["rtf_tokens"])     # warm
    _reset_counts()
    before = _bodies()
    runs = [_asr_transcribe(model, mel, mask, c["rtf_tokens"])
            for _ in range(c["rtf_repeats"])]
    times = [t for _, t in runs]
    torch.cuda.synchronize()
    counts = _counts()
    L, E, n = cfg.dec_layers, cfg.enc_layers, c["rtf_repeats"]
    _expect_only("servables whisper rtf", counts, {
        "flash_attention": E * n,
        "decode_attention": 2 * L * c["rtf_tokens"] * n})
    # The encoder's layers on body C, every step's self and cross reads
    # (one row a (slot, head)) on the single-row scan.
    bodies = _body_delta(before)
    want = {"flash_attention/C": E * n,
            "decode_kernels/row": 2 * L * c["rtf_tokens"] * n}
    if bodies != want:
        fail(f"servables whisper rtf: bodies {bodies}, expected {want}")
    if any(not torch.equal(t, runs[0][0]) for t, _ in runs):
        fail("servables whisper rtf: the repeats' tokens differ")
    totals = [sum(t) for t in times]
    med = statistics.median(totals)
    split = times[totals.index(med)]
    rtf = B * c["rtf_audio_s"] / med
    print(f"[servables] whisper_large_v3 bf16 b{B} x {c['rtf_audio_s']:.0f}"
          f" s, {c['rtf_tokens']} tokens: latency {med * 1e3:.1f} ms (median"
          f" of {n}: {[round(t * 1e3, 1) for t in totals]}) -> RTF "
          f"{rtf:.1f} x real time; split encode {split[0] * 1e3:.1f} ms, "
          f"prefill {split[1] * 1e3:.1f} ms, {c['rtf_tokens'] - 1} steps "
          f"{split[2] * 1e3:.1f} ms; launches {counts}", flush=True)
    rtf_row = dict(rtf=rtf, latency_ms=med * 1e3, batch=B,
                   audio_s=c["rtf_audio_s"], tokens=c["rtf_tokens"],
                   encode_ms=split[0] * 1e3, prefill_ms=split[1] * 1e3,
                   steps_ms=split[2] * 1e3,
                   runs_ms=[t * 1e3 for t in totals], bodies=bodies,
                   tokens_sha1=_digest(runs[0][0]))
    del mel, mask

    # The stream: a 10 s clip fed 100 frames at a time, 200-frame chunks.
    clip = rng.standard_normal((c["stream_frames"], cfg.n_mels)).astype(
        np.float32)
    stream = StreamingASR(model, chunk_frames=c["stream_chunk"],
                          max_new_tokens=c["stream_new"])
    _reset_counts()
    chunks = []
    for i in range(0, len(clip), c["stream_feed"]):
        t0 = time.perf_counter()
        new = stream.feed(clip[i:i + c["stream_feed"]])
        if new is not None:
            chunks.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                               tokens=len(new)))
    torch.cuda.synchronize()
    s_counts = _counts()
    if (len(chunks) != c["stream_frames"] // c["stream_chunk"]
            or not all(0 <= t < cfg.vocab_size for t in stream.transcript)
            or not s_counts["flash_attention"]
            or not s_counts["decode_attention"] or s_counts["plain"]):
        fail(f"servables whisper stream: chunks {chunks}, launches "
             f"{s_counts}")
    print(f"[servables] whisper_large_v3 stream of {c['stream_frames']} "
          f"frames in {c['stream_chunk']}-frame chunks: per chunk "
          f"{[round(ch['ms'], 1) for ch in chunks]} ms, tokens "
          f"{[ch['tokens'] for ch in chunks]}, transcript length "
          f"{len(stream.transcript)}; launches {s_counts}", flush=True)

    # The served roundtrip, against direct runs on the same clips.
    clips = [rng.standard_normal((n, cfg.n_mels)).astype(np.float32)
             for n in c["serve_clips"]]

    def run(asr, audio):
        asr.reset()
        asr.feed(audio)
        if asr._buffer:
            asr.flush()
        return asr.transcript

    direct = [run(StreamingASR(model, chunk_frames=c["stream_chunk"],
                               max_new_tokens=c["stream_new"]), a)
              for a in clips]

    def factory():
        asr = StreamingASR(model, chunk_frames=c["stream_chunk"],
                           max_new_tokens=c["stream_new"])

        def transcribe(payloads):
            yield [run(asr, np.asarray(p, np.float32)) for p in payloads]

        return transcribe

    controller = ServeController(control_interval_s=0.2)
    _reset_counts()
    t0 = time.monotonic()
    try:
        router = controller.deploy(
            DeploymentConfig(name="whisper", num_replicas=1,
                             max_batch_size=2, batch_wait_timeout_s=0.01),
            factory=factory)
        controller.start()
        handle = DeploymentHandle(router, default_slo_ms=120_000.0)
        futs = [handle.remote(a.tolist()) for a in clips]
        served = [f.result(timeout=300)[0] for f in futs]
    finally:
        controller.shutdown()
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    r_counts = _counts()
    same = served == direct
    print(f"[servables] whisper served roundtrip (controller -> router -> "
          f"replica -> StreamingASR), {len(clips)} requests in {wall:.1f} s:"
          f" transcripts equal to direct runs {same}; launches {r_counts}",
          flush=True)
    print(f"[servables] whisper tokens: rtf batch sha1 "
          f"{rtf_row['tokens_sha1']}, served transcripts sha1 "
          f"{_digest(served)} {served}", flush=True)
    if not same:
        fail(f"servables whisper: served transcripts {served} differ from "
             f"direct runs {direct}")
    if not r_counts["decode_attention"] or r_counts["plain"]:
        fail(f"servables whisper served: launches {r_counts}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    total = {k: counts.get(k, 0) + s_counts.get(k, 0) + r_counts.get(k, 0)
             for k in counts}
    return total, dict(rtf=rtf_row, stream=dict(chunks=chunks,
                                                transcript_len=len(
                                                    stream.transcript)),
                       served=dict(requests=len(clips), wall_s=wall,
                                   identical=True))


def _gpt2_rows(c: dict) -> tuple:
    """19d: gpt2_medium bf16 at full depth, no cache: ``ModelProfiler``
    rows over (batch, seq) with ``flops_per_sample`` beside each."""
    from ray_dynamic_batching_tpu_torch.models.base import get_model

    model = get_model("gpt2_medium", seed=0).eval()
    _reset_counts()
    _, rows, forwards = _sweep("profile gpt2_medium (no cache)", model,
                               c["gpt2_buckets"], c["gpt2_seqs"], c)
    torch.cuda.synchronize()
    counts = _counts()
    _expect_only("servables gpt2_medium rows", counts, {
        "flash_attention": model.cfg.num_layers * forwards})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rows


def phase_servables() -> tuple:
    """Phase 19; returns (launch counts, the phase's numbers)."""
    c = SERVABLES
    t0 = time.monotonic()
    smi = _smi()
    os.makedirs(PROFILES_DIR, exist_ok=True)
    with _kernel_shapes() as shapes:
        parity = _servable_parity(c)
        c1, bert = _bert_serving(c)
        c2, asr = _asr_serving(c)
        c3, gpt2 = _gpt2_rows(c)
    launched = _held_shapes(shapes, "servables", 19)
    counts = {n: c1.get(n, 0) + c2.get(n, 0) + c3.get(n, 0)
              for n in set(c1) | set(c2) | set(c3)}
    wall = time.monotonic() - t0
    print(f"[servables] {smi}: phase wall time {wall:.1f} s", flush=True)
    return counts, dict(card=smi, parity=parity, distilbert=bert,
                        whisper=asr, gpt2_medium_rows=gpt2,
                        kernel_shapes=launched, wall_s=wall)


def _held_shapes(shapes, tag: str = "spec", phase: int = 17) -> list:
    """Every kernel shape phase ``phase`` launched (its captures and eager
    calls, by :func:`_shape_key` / :func:`_w8_key`) must be one that
    phase 3 held against its plain version; prints each with its wrapper
    calls."""
    rows = []
    for key, n in sorted(shapes.items()):
        name, q, kv, q_dtype, kv_dtype = key
        held = key in _CHECKED
        if name == "int8_weight_matmul":
            what = (f"x[{q[0]}, {q[1]}] codes[{kv[0]}, {kv[1]}] period "
                    f"{kv[2]}")
        else:
            what = (f"q[., {', '.join(map(str, q))}] "
                    f"k/v[., {', '.join(map(str, kv))}]")
        print(f"[{tag}] kernel shape {name} {what} {q_dtype}/{kv_dtype}: "
              f"{n} wrapper calls, held in phase 3: {held}", flush=True)
        rows.append(dict(kernel=name, q=list(q), kv=list(kv),
                         dtype=q_dtype, kv_dtype=kv_dtype, calls=n))
    missing = [k for k in shapes if k not in _CHECKED]
    if missing:
        fail(f"phase {phase} launched {len(missing)} kernel shapes phase 3 "
             f"did not hold against the plain version (run phase 3, "
             f"'kernels', with it): {missing}")
    return rows


# --- phase 20: tensor-parallel serving --------------------------------------
TP_PARITY_LAYERS = 2
# 20a / 20c: phase 6's prompts with 16 new tokens (32 there): the arms'
# eager gloo steps are most of the phase's time.
TP_NEW_TOKENS = 16
# arm -> (KV dtype, knobs): phase 6's 10 prompts through each.
TP_ARMS = {
    "slab": (None, SLAB_KNOBS),
    "slab_chunked": (None, dict(SLAB_KNOBS, chunked_prefill=True)),
    "paged": (None, PAGED_KNOBS),
    "paged_mono": (None, dict(PAGED_KNOBS, chunked_prefill=False)),
    "int8": (torch.int8, SLAB_KNOBS),
    "int8_chunked": (torch.int8, dict(SLAB_KNOBS, chunked_prefill=True)),
    "int8_paged": (torch.int8, PAGED_KNOBS),
    "int8_paged_mono": (torch.int8, dict(PAGED_KNOBS, chunked_prefill=False)),
}
TP_LABEL = "4 ranks time-sharing one H100 over gloo: not TP speed"
# KV dtypes 20a serves at each TP size: every arm at tp 4; the f32 arms at
# tp 2 (the int8 pool's tp 2 shards are held bit-identical in phase 3 and
# the card tests; the script's time limit is close).
TP_PARITY_KV = {2: (None,), 4: (None, torch.int8)}


def _rank_counts(ctx, seq) -> dict:
    """A rank's kernel launch counts (run on every rank)."""
    return _counts()


def _rank_reset(ctx, seq) -> None:

    torch.cuda.synchronize()
    _reset_counts()


def _rank_logits(ctx, seq, key: str, tokens, mask) -> tuple:
    """A prefill of ``tokens`` and one greedy step through rank r's shard
    of model ``key``: the gathered logits, as every rank computes them."""
    model = ctx.objects[key]
    with torch.inference_mode():
        tok = torch.from_numpy(tokens).to(ctx.mesh.device)
        am = torch.from_numpy(mask).to(ctx.mesh.device)
        cache = model.make_cache(tok.shape[0], S)
        first, cache = model.prefill(tok, am, cache)
        nxt = torch.argmax(first.float(), dim=-1).to(torch.int32)[:, None]
        active = torch.ones((tok.shape[0],), dtype=torch.bool,
                            device=tok.device)
        second, _ = model.decode_step(nxt, cache, active)
        return first.float().cpu().numpy(), second.float().cpu().numpy()


def _tp_serve(model, payloads, knobs: dict, mesh=None) -> tuple:
    """Serve ``payloads`` on a fresh engine (eager), drained; returns
    (results, engine)."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    q = RequestQueue("tp", max_len=256)
    engine = DecodeEngine(model, q, device="cuda", mesh=mesh, **knobs)
    reqs = [Request(model="tp", payload=p, slo_ms=600_000.0)
            for p in payloads]
    for r in reqs:
        q.add_request(r)
    engine.run_until_idle(timeout_s=600)
    return [r.future.result(timeout=60) for r in reqs], engine


# --- 20c: drafts, KV reuse and the page fabric on a TP engine ---------------
TP_SPEC_DRAFTS = ("self", "divergent")
# The divergent draft: the target's weights, each times (1 + TP_DRAFT_NOISE
# n), n standard normal drawn for the whole leaf from TP_DRAFT_SEED plus the
# leaf's index. A draft from another seed is rejected at every proposal at
# random weights (acceptance 0), and then a wrongly cut draft would pass;
# at 0.1 this one took 1 proposal in 76, at 0.01 about half (PERF.md section 6).
TP_DRAFT_NOISE = 0.01
TP_DRAFT_SEED = 1


def _perturb_draft(model, plan=None) -> None:
    """Turn ``model`` (the target's weights) into the divergent draft in
    place; on a mesh rank, ``plan`` (``parallel/mesh.shard_plan``) cuts
    each whole leaf's noise to the rank's slice."""
    with torch.no_grad():
        for i, (n, p) in enumerate(sorted(model.module.named_parameters())):
            whole = list(p.shape)
            for c in (plan[n].cuts() if plan else []):
                whole[c.dim] *= c.parts
            gen = torch.Generator(device=p.device)
            gen.manual_seed(TP_DRAFT_SEED + i)
            noise = torch.randn(whole, generator=gen, device=p.device,
                                dtype=torch.float32)
            if plan:
                noise = plan[n].take(noise)
            p.mul_(1.0 + TP_DRAFT_NOISE * noise.to(p.dtype))
            del noise


def _rank_perturb_draft(ctx, seq, key: str) -> None:
    from ray_dynamic_batching_tpu_torch.parallel.mesh import shard_plan

    model = ctx.objects[key]
    _perturb_draft(model, shard_plan(ctx.mesh, model))
TP_REUSE_KNOBS = dict(PAGED_KNOBS, **REUSE_CACHES, host_spill_pages=16)


def _tp_window(mesh, paths: dict, name: str, fn, *args):
    """``fn(*args)`` with every rank's counts set to 0 just before and read
    just after; the ranks' counts summed into ``paths[name]``. Fails when
    any rank ran the plain route or the kv-head gather in the window.
    Returns (fn's result, each rank's counts)."""
    mesh.world.call(_rank_reset)
    out = fn(*args)
    counts = mesh.world.call(_rank_counts)
    stray = [(r, c.get("plain", 0), c.get("kv_gather", 0))
             for r, c in enumerate(counts)
             if c.get("plain") or c.get("kv_gather")]
    if stray:
        fail(f"{name}: the plain route or the kv-head gather ran on a rank "
             f"(rank, plain, kv_gather): {stray}")
    total = paths.setdefault(name, {})
    for c in counts:
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return out, counts


def _every_rank(tag: str, counts: list, kernel: str) -> list:
    per_rank = [c.get(kernel, 0) for c in counts]
    if not all(per_rank):
        fail(f"{tag}: {kernel} did not launch on every rank: {counts}")
    return per_rank


def _tp_spec_run(model, draft, payloads, mesh=None) -> dict:
    """20c (a): ``payloads`` on a slab engine speculating with ``draft``
    (eager); tokens, acceptance (accepted / drafted) and rounds."""
    res, engine = _tp_serve(model, payloads, dict(SLAB_KNOBS,
                                                  draft_model=draft), mesh)
    out = dict(tokens=[r.tokens for r in res],
               acceptance=engine.spec_acceptance(),
               rounds=engine.spec_rounds)
    engine.release_buffers()
    return out


def _tp_reuse_run(tag: str, model, V: int, mesh=None) -> dict:
    """20c (b), phase 16's four-arm shape on the pool (f32, eager, cache
    knobs ``TP_REUSE_KNOBS``): a shared 300-token prefix served, then hit;
    a session's 216-token history whose turn 2 borrows its full page; a
    prefix hit in memory, then every entry spilled to host memory and the
    same prompt reloaded. Returns every answer's tokens; fails on a book
    that is off and on a page that is not free once the caches clear."""
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue

    rng = np.random.default_rng(2022)
    name = model.name
    q = RequestQueue("reuse", max_len=256)
    engine = DecodeEngine(model, q, device="cuda", mesh=mesh,
                          **TP_REUSE_KNOBS)
    head = rng.integers(0, V, 300).tolist()
    p1, p2, p3 = (head + rng.integers(0, V, n).tolist() for n in (20, 13, 9))
    answers = _reuse_serve(engine, q, [{"tokens": p1, "max_new_tokens": 16}])
    hits = _reuse_counter("PREFIX_HITS", name, "page")
    answers += _reuse_serve(engine, q, [{"tokens": p2, "max_new_tokens": 16}])
    _same(tag, "page prefix hits",
          _reuse_counter("PREFIX_HITS", name, "page") - hits, 1)
    t1 = rng.integers(0, V, 200).tolist()
    s1 = _reuse_serve(engine, q, [{"tokens": t1, "max_new_tokens": 16,
                                   "session_id": "tp"}])
    t2 = t1 + s1[0] + rng.integers(0, V, 20).tolist()
    hits = _reuse_counter("SESSION_HITS", name)
    seen = engine._page_journal.total
    s2 = _reuse_serve(engine, q, [{"tokens": t2, "max_new_tokens": 16,
                                   "session_id": "tp"}])
    _same(tag, "session hits", _reuse_counter("SESSION_HITS", name) - hits,
          1)
    journal = engine._page_journal
    borrowed = [e["pages"] for e in journal.snapshot()[-(journal.total -
                                                           seen):]
                if e["kind"] == "cow_copy" and e.get("source") == "session"]
    _same(tag, "pages turn 2 borrowed from the session", borrowed,
          [len(t1 + s1[0]) // PS])
    in_memory = _reuse_serve(engine, q, [{"tokens": p3,
                                          "max_new_tokens": 16}])
    t0 = time.monotonic()
    while len(engine.paged_prefix):
        engine._reclaim_cache_pins()      # spill + evict every entry
    spill_s = time.monotonic() - t0
    reloads = engine.host_spill.reloads
    reloaded = _reuse_serve(engine, q, [{"tokens": p3,
                                         "max_new_tokens": 16}])
    _same(tag, "reloads", engine.host_spill.reloads - reloads, 1)
    _same(tag, "spill-reloaded prefix against the in-memory hit", reloaded,
          in_memory)
    _drained(tag, engine)
    engine.release_buffers()
    return dict(tokens=answers + s1 + s2 + in_memory + reloaded,
                spill_s=spill_s)


def _tp_fabric_run(tag: str, one_card, shard, mesh, V: int) -> dict:
    """20c (c): one stream migrated mid-decode from a TP 2 paged engine to
    a one-card paged engine (its tokens against the same stream served
    straight on the one-card engine), then a prefix the one-card engine
    published pushed to the TP engine, where a prompt sharing it hits.
    The export's gather over the tp group timed."""
    from ray_dynamic_batching_tpu_torch.engine import pagefabric
    from ray_dynamic_batching_tpu_torch.engine.decode import DecodeEngine
    from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
    from ray_dynamic_batching_tpu_torch.engine.request import Request

    rng = np.random.default_rng(2023)
    knobs = dict(PAGED_KNOBS, prefix_cache_size=8)
    sq, dq = RequestQueue("src", max_len=256), RequestQueue("dst", max_len=256)
    src = DecodeEngine(shard, sq, device="cuda", mesh=mesh, **knobs)
    dst = DecodeEngine(one_card, dq, device="cuda", **knobs)
    m = {"tokens": rng.integers(0, V, 150).tolist(), "max_new_tokens": 24}
    straight = _reuse_serve(dst, dq, [m])
    req = Request(model="reuse", payload=m, slo_ms=600_000.0)
    sq.add_request(req)
    while not src.live_stream_ids():
        src._admit()
        src._pump_prefill()
        if src._active_mask.any():
            src._step()
    idx = next(i for i, sl in enumerate(src._slots) if not sl.free)
    t0 = time.monotonic()
    parcel = pagefabric.export_stream_parcel(src, idx)
    export_ms = (time.monotonic() - t0) * 1e3
    K = shard.cfg.num_kv_heads
    if tuple(parcel.payload["k"].shape[3:]) != (K, shard.cfg.head_dim):
        fail(f"{tag}: the TP engine's parcel holds "
             f"{tuple(parcel.payload['k'].shape)}, not every kv head")
    if not src.request_migration(req.request_id, dst.accept_parcel):
        fail(f"{tag}: the live stream was not accepted for migration")
    src._service_fabric()
    dst.run_until_idle(timeout_s=300)
    src.run_until_idle(timeout_s=300)
    _same(tag, "migrations out / in", (src.migrated_out, dst.migrated_in),
          (1, 1))
    _same(tag, "migrated stream against the straight run",
          [req.future.result(timeout=5).tokens], straight)
    prompt = rng.integers(0, V, 2 * PS + 10).tolist()
    for _ in range(2):
        _reuse_serve(dst, dq, [{"tokens": prompt, "max_new_tokens": 4}])
    hexkey, n_pages, _hits = dst.paged_prefix.hot(limit=4)[0]
    push = pagefabric.export_prefix_parcel(dst, bytes.fromhex(hexkey))
    if not src.accept_parcel(push):
        fail(f"{tag}: the TP engine refused a prefix push")
    src.run_until_idle(timeout_s=300)
    _same(tag, "pushes in", src.pushes_in, 1)
    hits = _reuse_counter("PREFIX_HITS", shard.name, "page")
    _reuse_serve(src, sq, [{"tokens": prompt[:n_pages * PS] + rng.integers(
        0, V, 7).tolist(), "max_new_tokens": 4}])
    _same(tag, "the pushed prefix's hits on the TP engine",
          _reuse_counter("PREFIX_HITS", shard.name, "page") - hits, 1)
    for e in (src, dst):
        _drained(tag, e)
        e.release_buffers()
    return dict(export_ms=export_ms, parcel_bytes=parcel.nbytes,
                pushed_pages=n_pages)


def _tp_extra(tp: int, mesh, shard, cfg, want: dict, one_card,
              payloads, paths: dict) -> dict:
    """20c (see the module docstring) on a TP world's f32 shard: the
    drafts at every tp, the caches and the fabric at tp 2."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import CausalLM
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm
    from ray_dynamic_batching_tpu_torch.parallel import spmd

    out = {}
    greedy = [i for i, p in enumerate(payloads) if "temperature" not in p]
    for draft in TP_SPEC_DRAFTS:
        t0 = time.monotonic()
        dshard = shard
        if draft == "divergent":
            dshard = pm.build_sharded_model(mesh, CausalLM, cfg, "llama3_8b",
                                            dtype=torch.float32, seed=0)
            mesh.world.call(_rank_perturb_draft, dshard.tp_shard.key)
        got, counts = _tp_window(mesh, paths, "tp_spec", _tp_spec_run,
                                 shard, dshard, payloads, mesh)
        ref = want[("spec", draft)]
        tag = f"20c tp={tp} {draft}-draft spec"
        same = [got["tokens"][i] == ref["tokens"][i] for i in greedy]
        per_rank = _every_rank(tag, counts, "decode_attention")
        print(f"[tp] {tag}: greedy tokens {sum(same)}/{len(same)} identical "
              f"to the one-card spec engine, acceptance {got['acceptance']} "
              f"(one card {ref['acceptance']}), {got['rounds']} rounds; "
              f"decode_attention launches by rank {per_rank}; "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        if not all(same) or got["acceptance"] != ref["acceptance"]:
            fail(f"{tag}: tokens or acceptance differ from the one-card "
                 "spec engine's")
        out[f"tp{tp}_spec_{draft}"] = dict(
            greedy_identical=True, acceptance=got["acceptance"],
            rounds=got["rounds"], launches_by_rank=per_rank,
            wall_s=time.monotonic() - t0)
        if dshard is not shard:
            spmd.drop_objects(mesh.world, dshard.tp_shard.key)
            del dshard
    if tp != 2:
        return out
    V = cfg.vocab_size
    t0 = time.monotonic()
    tag = "20c tp=2 reuse"
    got, counts = _tp_window(mesh, paths, "tp_reuse", _tp_reuse_run, tag,
                             shard, V, mesh)
    _same(tag, "tokens against the one-card engine", got["tokens"],
          want["reuse"]["tokens"])
    per_rank = _every_rank(tag, counts, "paged_decode_attention_tp")
    out["tp2_reuse"] = dict(identical=True, spill_s=got["spill_s"],
                            launches_by_rank=per_rank,
                            wall_s=time.monotonic() - t0)
    print(f"[tp] {tag}: prefix hit, session turn 2 (one page borrowed), "
          f"spill of every entry ({got['spill_s'] * 1e3:.1f} ms) and reload: "
          f"tokens identical to the one-card engine, every page free after; "
          f"kernel 4 launches by rank {per_rank}; "
          f"{out['tp2_reuse']['wall_s']:.1f} s", flush=True)
    t0 = time.monotonic()
    tag = "20c tp=2 fabric"
    got, counts = _tp_window(mesh, paths, "tp_fabric", _tp_fabric_run, tag,
                             one_card, shard, mesh, V)
    per_rank = _every_rank(tag, counts, "paged_decode_attention_tp")
    out["tp2_fabric"] = dict(got, launches_by_rank=per_rank,
                             wall_s=time.monotonic() - t0)
    print(f"[tp] {tag}: a stream migrated TP 2 -> one card mid-decode, "
          f"tokens identical to the straight run; a {got['pushed_pages']}-"
          f"page prefix pushed one card -> TP 2 hits; the stream's export "
          f"({got['parcel_bytes'] / 1e6:.1f} MB, gathered over gloo) "
          f"{got['export_ms']:.1f} ms; kernel 4 launches by rank "
          f"{per_rank}; {out['tp2_fabric']['wall_s']:.1f} s", flush=True)
    return out


def _tp_parity(payloads, paths: dict) -> dict:
    """20a and 20c (see the module docstring)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.ops import graphs
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm
    from ray_dynamic_batching_tpu_torch.parallel import spmd

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=TP_PARITY_LAYERS)
    greedy = [i for i, p in enumerate(payloads) if "temperature" not in p]
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, cfg.vocab_size, (4, T)).astype(np.int32)
    mask = np.ones((4, T), np.int32)
    mask[1, 40:] = 0
    mask[3, 9:] = 0
    out = {}
    want, want_logits = {}, {}
    one_card = None
    for kv in (None, torch.int8):
        model = CausalLM(cfg, name="llama3_8b", dtype=torch.float32,
                         device="cuda", seed=0, kv_dtype=kv)
        want_logits[kv] = _rank_logits(
            types_ns(mesh=types_ns(device=torch.device("cuda")),
                     objects={"m": model}), 0, "m", tokens, mask)
        with graphs.disable_capture():
            for arm, (arm_kv, knobs) in TP_ARMS.items():
                if arm_kv is kv:
                    res, engine = _tp_serve(model, payloads, knobs)
                    want[arm] = [r.tokens for r in res]
                    engine.release_buffers()
            if kv is None:
                # 20c's one-card references; the model stays for the
                # fabric's one-card engine.
                t0 = time.monotonic()
                divergent = CausalLM(cfg, name="llama3_8b",
                                     dtype=torch.float32, device="cuda",
                                     seed=0)
                _perturb_draft(divergent)
                for draft in TP_SPEC_DRAFTS:
                    want[("spec", draft)] = _tp_spec_run(
                        model, model if draft == "self" else divergent,
                        payloads)
                del divergent
                acc = want[("spec", "divergent")]["acceptance"]
                if not 0.0 < acc < 1.0:
                    fail(f"20c: the divergent draft's acceptance on one "
                         f"card is {acc}, not strictly between 0 and 1")
                want["reuse"] = _tp_reuse_run("20c one-card reuse", model,
                                              cfg.vocab_size)
                one_card = model
                print(f"[tp] 20c one-card references (spec with both "
                      f"drafts, reuse): {time.monotonic() - t0:.1f} s",
                      flush=True)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    for tp in (2, 4):
        t0 = time.monotonic()
        mesh = pm.build_mesh(pm.MeshConfig(tp=tp), ["cuda:0"] * tp,
                             backend="gloo")
        print(f"[tp] 20a tp={tp}: {mesh!r}, {tp - 1} ranks spawned and joined "
              f"in {time.monotonic() - t0:.1f} s", flush=True)
        try:
            for kv in TP_PARITY_KV[tp]:
                shard = pm.build_sharded_model(
                    mesh, CausalLM, cfg, "llama3_8b", dtype=torch.float32,
                    seed=0, kv_dtype=kv)
                key = shard.tp_shard.key
                logits = mesh.world.call(_rank_logits, key, tokens, mask)
                for r, pair in enumerate(logits[1:], start=1):
                    if not all(np.array_equal(a, b)
                               for a, b in zip(pair, logits[0])):
                        fail(f"20a tp={tp}: rank {r}'s gathered logits "
                             "differ from rank 0's")
                errs = [float(np.abs(a - b).max())
                        for a, b in zip(logits[0], want_logits[kv])]
                kvname = "int8" if kv is torch.int8 else "f32"
                print(f"[tp] 20a tp={tp} {kvname} KV: logits vs the "
                      f"single-card model, prefill {errs[0]:.3e}, step "
                      f"{errs[1]:.3e} (max abs; every rank's gathered logits "
                      "bit-identical)", flush=True)
                out[f"tp{tp}_{kvname}_logit_err"] = max(errs)
                for arm, (arm_kv, knobs) in TP_ARMS.items():
                    if arm_kv is not kv:
                        continue
                    mesh.world.call(_rank_reset)
                    t1 = time.monotonic()
                    res, engine = _tp_serve(shard, payloads, knobs, mesh)
                    wall = time.monotonic() - t1
                    counts = mesh.world.call(_rank_counts)
                    got = [r.tokens for r in res]
                    same = [got[i] == want[arm][i] for i in greedy]
                    sampled = [got[i] == want[arm][i]
                               for i in range(len(got)) if i not in greedy]
                    kernel = ("paged_decode_attention_tp" if engine.paged
                              else "decode_attention"
                              + ("_int8" if kv is torch.int8 else ""))
                    per_rank = [c[kernel] for c in counts]
                    print(f"[tp] 20a tp={tp} {arm}: greedy tokens "
                          f"{sum(same)}/{len(same)} identical to the "
                          f"single-card engine (sampled rows identical: "
                          f"{sampled}), {engine.steps} steps in {wall:.1f} "
                          f"s, {kernel} launches by rank {per_rank}",
                          flush=True)
                    if not all(same):
                        fail(f"20a tp={tp} {arm}: greedy tokens differ "
                             "from the single-card engine's")
                    if not all(per_rank):
                        fail(f"20a tp={tp} {arm}: {kernel} did not launch on "
                             f"every rank: {counts}")
                    if engine.paged:
                        engine._allocator.check()
                    engine.release_buffers()
                    out[f"tp{tp}_{arm}"] = dict(greedy_identical=all(same),
                                                launches_by_rank=per_rank)
                if kv is None:
                    with graphs.disable_capture():
                        out.update(_tp_extra(tp, mesh, shard, cfg, want,
                                             one_card, payloads, paths))
                spmd.drop_objects(mesh.world, key)
                del shard
        finally:
            procs = list(mesh.world._procs)
            mesh.shutdown()
            if any(p.is_alive() for p in procs):
                fail(f"20a tp={tp}: a rank outlived its mesh")
        gc.collect()
        torch.cuda.empty_cache()
    del one_card
    gc.collect()
    torch.cuda.empty_cache()
    return out


def types_ns(**kw):
    """A namespace (what a rank's functions read off their context)."""
    import types

    return types.SimpleNamespace(**kw)


def _tp_baseline(payloads) -> tuple:
    """20b (see the module docstring). Returns (summed launch counts of
    the serving window over the ranks, summary)."""
    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.parallel import placement as pl
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment

    total = torch.cuda.get_device_properties(0).total_memory
    mgr = pl.PlacementManager([pl.CudaDevice(id=0, hbm_bytes=total)] * 4)
    pg = mgr.create([pl.Bundle(chips=4)], pl.STRICT_PACK)
    t0 = time.monotonic()
    # Not warmed: a mesh engine's programs run eagerly, so warming them
    # would only record the capture ledger, ~35 s of four ranks on one card.
    # SPEED_LAYERS deep, under a name of its own so that every rank draws
    # its shard from the seed (a model handed in is broadcast whole).
    from ray_dynamic_batching_tpu_torch.models.base import register_model

    register_model(SPEED_NAME)(_speed_model)
    dep = LLMDeployment(SPEED_NAME, dtype=torch.bfloat16, seed=0,
                        mesh_backend="gloo", warmup=False, **PAGED_KNOBS)
    replica = dep.make_replica("llama3_8b-tp4",
                               DeploymentConfig(name="llama3_8b"),
                               devices=pg.bundle_devices(0))
    world = replica.mesh.world
    procs = list(world._procs)
    engine = replica.engine
    try:
        if engine.num_slots != SLOTS or not engine.paged:
            fail(f"20b: engine of {engine.num_slots} slots, paged "
                 f"{engine.paged}")
        print(f"[tp] 20b llama3_8b bf16 {engine.model.cfg.num_layers} layers "
              f"TP=4 ({replica.mesh!r}): rank 0 holds "
              f"{engine.model.param_bytes() / 1e9:.2f} GB of weights, kv "
              f"heads {engine.model.kv_heads} a rank; replica built and "
              f"sharded from the seed in {time.monotonic() - t0:.1f} s",
              flush=True)
        world.call(_rank_reset)
        replica.start()
        t1 = time.monotonic()
        reqs = []
        for payload in payloads:
            reqs.append(Request(model="llama3_8b", payload=payload,
                                slo_ms=600_000.0))
            if not replica.assign(reqs[-1]):
                fail("20b: replica refused a request")
        results = [r.future.result(timeout=600) for r in reqs]
        wall = time.monotonic() - t1
        engine.stop()
        counts = world.call(_rank_counts)
    finally:
        replica.stop(timeout_s=30.0)
        mgr.remove(pg)
    if any(p.is_alive() for p in procs) or not world.closed:
        fail("20b: a rank outlived its replica")
    V = engine.model.cfg.vocab_size
    for i, res in enumerate(results):
        if (len(res.tokens) != payloads[i]["max_new_tokens"]
                or res.finish_reason != "length"
                or not all(0 <= t < V for t in res.tokens)):
            fail(f"20b request {i}: {len(res.tokens)} tokens, "
                 f"{res.finish_reason}")
    L = engine.model.cfg.num_layers
    fills = (engine.prefill_groups + engine.long_chunk_dispatches
             + engine.chunk_dispatches)
    want = {"paged_decode_attention_tp": L * engine.steps,
            "flash_attention": L * fills}
    for r, c in enumerate(counts):
        _expect_only(f"20b rank {r}", c, want)
    summed = {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}
    n_tok = sum(len(r.tokens) for r in results)
    ttfts = sorted(r.ttft_ms for r in results)
    summary = dict(tok_s=n_tok / wall, wall_s=wall, steps=engine.steps,
                   ms_per_step=wall * 1e3 / max(1, engine.steps),
                   ttft_p50_ms=statistics.median(ttfts),
                   kernel4_launches_by_rank=[
                       c["paged_decode_attention_tp"] for c in counts],
                   label=TP_LABEL)
    print(f"[tp] 20b {len(results)} requests, {n_tok} tokens in {wall:.3f} s: "
          f"{summary['tok_s']:.1f} tok/s, {engine.steps} decode steps, "
          f"{summary['ms_per_step']:.1f} ms wall per step (prefill "
          f"included), TTFT p50 {summary['ttft_p50_ms']:.1f} ms — "
          f"{TP_LABEL}; kernel 4 launches by rank "
          f"{summary['kernel4_launches_by_rank']}", flush=True)
    return summed, summary


def phase_tp() -> tuple:
    """Phase 20 (see the module docstring)."""
    t0 = time.monotonic()
    print(f"[tp] backend gloo (ranks share the card; NCCL needs a card a "
          f"rank), torch.cuda.device_count() = {torch.cuda.device_count()}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    paths = {}
    parity = _tp_parity(_payloads(np.random.default_rng(1), 128256,
                                  TP_NEW_TOKENS, 8, 2, 2), paths)
    paths["tp"], baseline = _tp_baseline(
        _payloads(np.random.default_rng(0), 128256, 32, 8, 2, 0))
    wall = time.monotonic() - t0
    print(f"[tp] phase 20 took {wall:.1f} s", flush=True)
    return paths, dict(parity=parity, baseline=baseline, wall_s=wall)


# --- phase 21: the serving surface ------------------------------------------
SURFACE_DIR = "build/surface"
SURFACE_SHM_BYTES = 16 << 20     # the shm store, well inside 64 MB
SURFACE_NEW = 32


def _surface_client(name: str, payloads: list, store_bytes: int, out) -> None:
    """A frontend process: submit each payload over shm, one at a time,
    and put the token lists on ``out``. It never touches the card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from ray_dynamic_batching_tpu_torch.engine.shm_bridge import ShmFrontend

    fe = ShmFrontend(name, store_bytes=store_bytes)
    try:
        tokens = []
        for p in payloads:
            oid = fe.submit("llama3_8b", p, slo_ms=600_000.0)
            tokens.append(fe.get_result(oid, timeout_s=300)["tokens"])
        out.put(tokens)
    except Exception as e:  # noqa: BLE001 — reported to the parent
        out.put(f"{type(e).__name__}: {e}")
    finally:
        fe.close(unlink=False)


def _completion_body(p: dict) -> dict:
    body = {"prompt": p["tokens"], "max_tokens": p["max_new_tokens"]}
    body.update({k: p[k] for k in ("temperature", "top_k", "seed") if k in p})
    return body


def _same_tokens(tag: str, door: str, got: list, want: list) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            fail(f"{tag}: {door} request {i} gave other tokens than the "
                 f"handle: {g[:8]}... against {w[:8]}...")
    if len(got) != len(want):
        fail(f"{tag}: {door} answered {len(got)} of {len(want)} requests")


def _surface_openai(tag, proxy, handle, payloads) -> tuple:
    """(a): the payloads one at a time through the handle and through
    ``/v1/completions``; then the 8 at once through the route, and
    malformed bodies. Returns (greedy tokens, numbers)."""
    direct = [handle.remote(dict(p)).result(timeout=600) for p in payloads]
    served = []
    for p, d in zip(payloads, direct):
        code, text = _post(proxy, "/v1/completions", _completion_body(p))
        if code != 200:
            fail(f"{tag}: /v1/completions answered {code}: {text[:300]}")
        body = json.loads(text)["result"]
        choice = body["choices"][0]
        n = p["max_new_tokens"]
        if (body["object"] != "text_completion"
                or body["model"] != "llama3_8b"
                or choice["finish_reason"] != "length"
                or body["usage"] != {"prompt_tokens": len(p["tokens"]),
                                     "completion_tokens": n,
                                     "total_tokens": len(p["tokens"]) + n}):
            fail(f"{tag}: completion envelope {json.dumps(body)[:400]}")
        served.append(choice["tokens"])
    greedy = [i for i, p in enumerate(payloads) if "temperature" not in p]
    _same_tokens(tag, "/v1/completions", [served[i] for i in greedy],
                 [direct[i].tokens for i in greedy])
    seeded_same = [served[i] == direct[i].tokens for i in range(len(payloads))
                   if i not in greedy]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(payloads)) as pool:
        burst = list(pool.map(lambda p: _post(proxy, "/v1/completions",
                                              _completion_body(p)), payloads))
    for code, text in burst:
        if code != 200 or len(json.loads(text)["result"]["choices"][0][
                "tokens"]) != SURFACE_NEW:
            fail(f"{tag}: a completion of the burst: {code} {text[:300]}")
    rejected = []
    for body in ({"prompt": "text, not token ids"},
                 {"prompt": [1, 2], "stream": True},
                 {"prompt": [1], "temperature": "hot"}):
        code, text = _post(proxy, "/v1/completions", body)
        if not 400 <= code < 500:
            fail(f"{tag}: malformed body {body} answered {code}")
        rejected.append(code)
    print(f"[{tag}] (a) /v1/completions: {len(greedy)} greedy completions "
          f"token-identical to the handle, usage and finish_reason checked; "
          f"the 2 seeded ones identical: {seeded_same}; a burst of "
          f"{len(burst)} at once answered; malformed bodies -> {rejected}",
          flush=True)
    return [direct[i].tokens for i in greedy], {
        "greedy_identical": len(greedy), "seeded_identical": seeded_same,
        "malformed_codes": rejected}


def _surface_grpc(tag, routes, greedy_payloads, want) -> dict:
    """(b): Predict and PredictStream for the greedy payloads, if grpcio
    is installed."""
    from ray_dynamic_batching_tpu_torch.serve import grpc_proxy

    if not grpc_proxy.HAVE_GRPC:
        try:
            import grpc  # noqa: F401
            why = "grpc imports here, but the port's gate saw it missing"
        except ImportError as e:
            why = f"import grpc: {e}"
        print(f"[{tag}] (b) gRPC door NOT served on this card: grpcio is "
              f"not installed ({why}); Predict/PredictStream untested here",
              flush=True)
        return {"served": False, "why": why}
    import grpc

    proxy = grpc_proxy.GRPCProxy(routes, port=0).start()
    client = None
    try:
        client = grpc_proxy.GRPCIngressClient(proxy.host, proxy.port)
        if client.healthz() != {"status": "ok"}:
            fail(f"{tag}: gRPC Healthz")
        unary = [client.predict("llama3_8b", p, timeout_s=600)["tokens"]
                 for p in greedy_payloads]
        _same_tokens(tag, "gRPC Predict", unary, want)
        streamed = []
        for p in greedy_payloads:
            msgs = list(client.predict_stream("llama3_8b", p,
                                              timeout_s=600))
            chunks = [m["chunk"] for m in msgs if "chunk" in m]
            finals = [m["result"] for m in msgs if "result" in m]
            if len(finals) != 1 or finals[0]["tokens"] != chunks:
                fail(f"{tag}: gRPC stream chunks {chunks[:6]}... against "
                     f"its result")
            streamed.append(chunks)
        _same_tokens(tag, "gRPC PredictStream", streamed, want)
        try:
            client.predict("nope", 1, timeout_s=30)
            fail(f"{tag}: gRPC answered an unknown deployment")
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.NOT_FOUND:
                fail(f"{tag}: unknown deployment -> {e.code()}")
    finally:
        if client is not None:
            client.close()
        proxy.stop()
    print(f"[{tag}] (b) gRPC (grpcio {grpc.__version__}): Predict and "
          f"PredictStream token-identical to (a) on {len(want)} greedy "
          f"prompts; NOT_FOUND for an unknown deployment", flush=True)
    return {"served": True, "grpcio": grpc.__version__}


def _surface_state(tag, controller) -> dict:
    """(c): the dashboard's routes over a StateAPI of the controller, and
    the state CLI run as a job against it."""
    from ray_dynamic_batching_tpu_torch.runtime.jobs import (
        SUCCEEDED,
        JobManager,
    )
    from ray_dynamic_batching_tpu_torch.serve.dashboard import DashboardServer
    from ray_dynamic_batching_tpu_torch.state import StateAPI

    server = DashboardServer(StateAPI(controller=controller), port=0).start()
    try:
        dash = types.SimpleNamespace(host="127.0.0.1", port=server.port)
        base = f"http://127.0.0.1:{server.port}"
        state = json.loads(_get(dash, "/api/state"))
        names = [d["name"] for d in state["deployments"]]
        reps = [r for r in state["replicas"] if r["deployment"] == "llama3_8b"]
        if names != ["llama3_8b"] or len(reps) != 1 or not reps[0]["healthy"]:
            fail(f"{tag}: /api/state lists {names} and {state['replicas']}")
        metrics = _get(dash, "/metrics")
        decode_lines = [ln for ln in metrics.splitlines()
                        if ln.startswith("rdb_decode_")]
        if not decode_lines:
            fail(f"{tag}: /metrics carries no rdb_decode_* sample")
        if "dashboard" not in _get(dash, "/"):
            fail(f"{tag}: the dashboard page")
        jobs = JobManager(workdir=os.path.join(SURFACE_DIR, "jobs"))
        jid = jobs.submit(
            [sys.executable, "-m", "ray_dynamic_batching_tpu_torch.state",
             "--url", base, "--iterations", "1"],
            env={"PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
                 "CUDA_VISIBLE_DEVICES": ""})
        info = jobs.wait(jid, timeout_s=120)
        log = jobs.logs(jid)
        if info.status != SUCCEEDED or "llama3_8b" not in log:
            fail(f"{tag}: the state CLI job ended {info.status} "
                 f"(rc {info.return_code}): {log[-500:]}")
    finally:
        server.stop()
    print(f"[{tag}] (c) dashboard: /api/state lists llama3_8b and its "
          f"replica, /metrics {len(decode_lines)} rdb_decode_* samples "
          f"(e.g. {decode_lines[0]}); the state CLI ran as job {jid}: "
          f"{info.status}, its log: {log.strip().splitlines()[:3]}",
          flush=True)
    return {"decode_samples": len(decode_lines), "job": info.status}


def _surface_sockets(tag, replica, payloads, want) -> dict:
    """(d): the payloads over the socket ingress, then from a spawned
    frontend process over the shm bridge, both into the replica."""
    import multiprocessing as mp
    import uuid

    from ray_dynamic_batching_tpu_torch.engine.ingress import (
        IngressClient,
        SocketIngress,
    )
    from ray_dynamic_batching_tpu_torch.engine.shm_bridge import ShmBridge

    server = SocketIngress(replica.assign, port=0).start()
    client = None
    try:
        client = IngressClient("127.0.0.1", server.port, timeout_s=600)
        replies = [client.send("llama3_8b", p, slo_ms=600_000.0,
                               request_id=f"s{i}")
                   for i, p in enumerate(payloads)]
    finally:
        if client is not None:
            client.close()
        server.stop()
    bad = [r for r in replies if "result" not in r]
    if bad:
        fail(f"{tag}: socket ingress replied {bad[0]}")
    _same_tokens(tag, "the socket ingress",
                 [r["result"]["tokens"] for r in replies], want)
    shm = os.statvfs("/dev/shm")
    shm_total, shm_free = (shm.f_blocks * shm.f_frsize,
                           shm.f_bavail * shm.f_frsize)
    print(f"[{tag}] /dev/shm: {shm_total / 2**20:.0f} MiB, "
          f"{shm_free / 2**20:.0f} MiB free (the ObjectStore's default "
          f"capacity is 64 MiB; this bridge's store "
          f"{SURFACE_SHM_BYTES >> 20} MiB)", flush=True)
    name = f"/rdb_surface_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    bridge = ShmBridge(name, submit=replica.assign,
                       store_bytes=SURFACE_SHM_BYTES).start()
    ctx = mp.get_context("spawn")
    proc = None
    try:
        out = ctx.Queue()
        proc = ctx.Process(target=_surface_client,
                           args=(name, payloads, SURFACE_SHM_BYTES, out))
        proc.start()
        got = out.get(timeout=600)
        proc.join(60)
    finally:
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(10)
        bridge.stop()
    if isinstance(got, str) or proc.exitcode != 0:
        fail(f"{tag}: the shm frontend process: {got} (exit {proc.exitcode})")
    _same_tokens(tag, "the shm bridge", got, want)
    print(f"[{tag}] (d) socket ingress and a spawned shm frontend "
          f"({bridge.pumped} pumped, {bridge.errors} errors): "
          f"{len(payloads)} greedy prompts each, token-identical to (a)",
          flush=True)
    return {"shm_mib": shm_total / 2**20, "shm_free_mib": shm_free / 2**20,
            "pumped": bridge.pumped}


def _surface_nodes(tag) -> dict:
    """(e): a ProcessReplica deployment of the demo factory behind the
    head's controller and HTTP ingress; a node killed and healed."""
    from ray_dynamic_batching_tpu_torch.runtime.cluster import (
        ProcessDeployment,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )

    controller = ServeController(control_interval_s=0.1)
    proxy = None
    try:
        dep = ProcessDeployment(
            "ray_dynamic_batching_tpu_torch.runtime.cluster:"
            "demo_double_factory", os.path.join(SURFACE_DIR, "nodes"),
            heartbeat_stale_s=0.5, result_timeout_s=30.0)
        router = controller.deploy(
            DeploymentConfig(name="double", num_replicas=2, max_restarts=3),
            factory=dep)
        controller.start()
        routes = ProxyRouter()
        routes.set_route("/api/double", DeploymentHandle(
            router, default_slo_ms=30_000.0))
        proxy = HTTPProxy(routes, host="127.0.0.1", port=0).start()
        t_ready = time.monotonic()
        for r in controller._deployments["double"].replicas:
            if not r.wait_ready(60):
                fail(f"{tag}: worker node {r.replica_id} never got ready")
        ready_s = time.monotonic() - t_ready

        def doubled(label: str) -> None:
            for i in range(8):
                code, text = _post(proxy, "/api/double", i)
                if code != 200 or json.loads(text)["result"] != 2 * i:
                    fail(f"{tag}: {label} request {i}: {code} {text[:200]}")

        doubled("before the kill")
        live = list(controller._deployments["double"].replicas)
        pids = {r.process.pid for r in live}
        t_kill = time.monotonic()
        live[0].process.kill()
        healed_s = None
        while time.monotonic() - t_kill < 60:
            now = controller._deployments["double"].replicas
            if (controller.status()["double"]["running_replicas"] == 2
                    and {r.process.pid for r in now} != pids
                    and all(r.healthy() and r.wait_ready(0.01) for r in now)):
                healed_s = time.monotonic() - t_kill
                break
            time.sleep(0.02)
        if healed_s is None:
            fail(f"{tag}: the controller did not replace the killed node")
        doubled("after the heal")
    finally:
        if proxy is not None:
            proxy.stop()
        controller.shutdown()
    print(f"[{tag}] (e) worker nodes: 2 spawned nodes ready in "
          f"{ready_s:.2f} s, 8 requests over HTTP, one node SIGKILLed, "
          f"healed (replaced and serving) in {healed_s:.2f} s, 8 more "
          f"served", flush=True)
    return {"ready_s": ready_s, "heal_s": healed_s}


def _surface_checkpoint(tag, payloads) -> tuple:
    """(f): llama3_8b at full width and 2 layers saved, restored into a
    fresh deployment, both served on the kernels. Returns (counts of the
    two serving windows, numbers)."""
    import shutil

    from ray_dynamic_batching_tpu_torch.engine.request import Request
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.models.convert import params_to_flax
    from ray_dynamic_batching_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
    )
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
    )
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.utils.pytree import flatten_with_paths

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=2)
    root = os.path.join(SURFACE_DIR, "checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    summed, tokens, out = {}, {}, {}
    try:
        for arm in ("memory", "checkpoint"):
            model = CausalLM(cfg, "llama3_8b", dtype=torch.bfloat16,
                             device="cuda",
                             seed=0 if arm == "memory" else None)
            kw = {}
            if arm == "memory":
                tree = params_to_flax(model)
                leaves = list(flatten_with_paths(tree).values())
                out["params"] = sum(t.numel() for t in leaves)
                nbytes = sum(t.numel() * t.element_size() for t in leaves)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                CheckpointManager(root).save(0, tree)
                out["save_s"] = time.monotonic() - t0
                out["bytes"] = nbytes
                del tree
            else:
                kw = dict(checkpoint_dir=root)
            dep = LLMDeployment("llama3_8b", model=model, **SLAB_KNOBS, **kw)
            t0 = time.monotonic()
            dep._ensure_model()
            torch.cuda.synchronize()
            if arm == "checkpoint":
                out["restore_s"] = time.monotonic() - t0
            replica = dep.make_replica(f"llama3_8b-{arm}",
                                       DeploymentConfig(name="llama3_8b"))
            engine = replica.engine
            _reset_counts()
            replica.start()
            try:
                got = []
                for p in payloads:
                    req = Request(model="llama3_8b", payload=dict(p),
                                  slo_ms=600_000.0)
                    if not replica.assign(req):
                        fail(f"{tag}: the {arm} replica refused a request")
                    got.append(req.future.result(timeout=600).tokens)
                engine.stop()
                torch.cuda.synchronize()
                counts = _counts()
            finally:
                replica.stop()
            _expect_dispatches(f"{tag} {arm}", counts, engine)
            for k, v in counts.items():
                summed[k] = summed.get(k, 0) + v
            tokens[arm] = got
            del dep, replica, engine, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _same_tokens(tag, "the checkpoint-restored deployment",
                 tokens["checkpoint"], tokens["memory"])
    gb = out["bytes"] / 1e9
    out.update(save_gb_s=gb / out["save_s"], restore_gb_s=gb / out["restore_s"])
    print(f"[{tag}] (f) checkpoint: llama3_8b full width, 2 layers "
          f"({out['params'] / 1e9:.3f} B parameters, {gb:.3f} GB: bf16, the "
          f"head f32; cut from 32 layers: 16 GB written and read would spend "
          f"a large share of the run's limit and the disk) saved in "
          f"{out['save_s']:.2f} s "
          f"({out['save_gb_s']:.3f} GB/s, device -> npz), restored into a "
          f"fresh deployment in {out['restore_s']:.2f} s "
          f"({out['restore_gb_s']:.3f} GB/s, npz -> device, read warm); "
          f"{len(payloads)} greedy prompts token-identical to the same "
          f"weights served from memory", flush=True)
    return summed, out


def phase_surface() -> tuple:
    """Phase 21: llama3_8b at full depth behind every door of the serving
    surface, one deployment shared by (a)-(d); worker nodes (e); a
    checkpoint round trip (f). Returns (counts, numbers)."""
    from ray_dynamic_batching_tpu_torch.serve import CompletionsHandle
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle
    from ray_dynamic_batching_tpu_torch.serve.llm import LLMDeployment
    from ray_dynamic_batching_tpu_torch.serve.proxy import (
        HTTPProxy,
        ProxyRouter,
    )

    from ray_dynamic_batching_tpu_torch.utils.compile_ledger import get_ledger

    tag = "surface"
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    os.makedirs(SURFACE_DIR, exist_ok=True)
    # The process ledger still holds phase 20's records: its mesh engines
    # run their programs eagerly without a warmup, so each first run lands
    # after an earlier engine's steady-state mark, and phase 20 does not
    # gate them. This phase gates the captures of its own engines.
    get_ledger().reset()
    payloads = _payloads(np.random.default_rng(0), 128256, SURFACE_NEW, 8, 2,
                         0)     # phase 5's 8 prompts: 6 greedy, 2 seeded
    greedy = [p for p in payloads if "temperature" not in p]
    out = {}
    controller = ServeController()
    proxy = None
    try:
        t0 = time.monotonic()
        dep = LLMDeployment("llama3_8b", dtype=torch.bfloat16, seed=0,
                            **SLAB_KNOBS)
        router = controller.deploy(
            DeploymentConfig(name="llama3_8b", max_ongoing_requests=4096),
            factory=dep)
        replica = controller._deployments["llama3_8b"].replicas[0]
        engine = replica.engine
        print(f"[{tag}] llama3_8b bf16 {engine.model.cfg.num_layers} layers "
              f"(slab + mono) on the controller, built and warmed in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        handle = DeploymentHandle(router, default_slo_ms=600_000.0)
        routes = ProxyRouter()
        routes.set_route("/v1/completions",
                         CompletionsHandle(handle, model="llama3_8b"))
        routes.set_route("/api/llama3_8b", handle)
        proxy = HTTPProxy(routes, host="127.0.0.1", port=0).start()
        _reset_counts()
        since = _dispatch_state(engine)
        t_doors = time.monotonic()
        want, out["openai"] = _surface_openai(tag, proxy, handle, payloads)
        out["grpc"] = _surface_grpc(tag, routes, greedy, want)
        out["state"] = _surface_state(tag, controller)
        out["sockets"] = _surface_sockets(tag, replica, greedy[:4], want[:4])
        torch.cuda.synchronize()
        counts = _counts()
        out["doors_s"] = time.monotonic() - t_doors
        _expect_dispatches(tag, counts, engine, since=since)
        _steady(tag)
    finally:
        if proxy is not None:
            proxy.stop()
        controller.shutdown()
    del controller, dep, router, replica, engine, handle, routes
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] (a)-(d) launches {counts} in {out['doors_s']:.1f} s",
          flush=True)
    out["nodes"] = _surface_nodes(tag)
    ck_counts, out["checkpoint"] = _surface_checkpoint(
        tag, [{k: v for k, v in p.items()
               if k in ("tokens", "max_new_tokens")} for p in payloads])
    _steady(tag)
    for k, v in ck_counts.items():
        counts[k] = counts.get(k, 0) + v
    if not counts.get("flash_attention") or not counts.get("decode_attention"):
        fail(f"{tag}: kernels 1 and 2 must both launch: {counts}")
    out["wall_s"] = time.monotonic() - t_phase
    print(f"[{tag}] phase 21 wall {out['wall_s']:.1f} s; launches {counts}",
          flush=True)
    return counts, out


# --- phase 22: training ------------------------------------------------------
TRAIN_BWD_SOURCE = "ray_dynamic_batching_tpu_torch/csrc/flash_attention_bwd.cu"
# The backward of kernel 1's masked/causal body (port-own: the JAX package
# differentiates its attention with XLA's autodiff).
TRAIN_BWD_REPLACES = "ray_dynamic_batching_tpu/ops/flash_attention.py:154"
# dQ/dK/dV held to the plain version's autograd: max abs error over the
# largest |gradient| of the reference.
TRAIN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _train_attn_inputs(B, T, N, K, H, dtype, gen, masked_row=False):
    """q [B, T, N, H], k/v [B, T, K, H] ~ N(0, 1), a key mask with row 1's
    last quarter padding (and with ``masked_row`` row 0's first 3 keys
    padding: its first 3 query rows attend nothing under causal), dO."""
    mk = lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(dtype)
    tm = torch.ones((B, T), dtype=torch.bool, device="cuda")
    tm[min(1, B - 1), 3 * T // 4:] = False
    if masked_row:
        tm[0, :3] = False
    return dict(q=mk(B, T, N, H), k=mk(B, T, K, H), v=mk(B, T, K, H),
                dout=mk(B, T, N, H), keep=tm[:, None, None, :].expand(
                    B, 1, T, T).to(torch.int8).contiguous()[:, 0])


def _train_attn_grads(x, kernel: bool):
    """(out, dq, dk, dv): FlashAttentionFn (kernel) or autograd of the
    plain version on the same inputs, causal."""
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    q, k, v = (x[n].detach().requires_grad_(True) for n in "qkv")
    if kernel:
        out = fl.flash_attention(q, k, v, causal=True,
                                 mask=x["keep"][:, None])
    else:
        out = fl.flash_attention_plain(q, k, v, x["keep"], causal=True)
    return (out, *torch.autograd.grad(out, (q, k, v), x["dout"]))


def _train_attn_cost(x) -> tuple:
    """Forward + backward: q, k, v, dO, the mask and out, dq, dk, dv moved
    once each; 12 H FLOPs an attended (row, key) pair a query head (QK^T
    and PV forward; dV, dP, dQ, dK backward)."""
    keep = (x["keep"] != 0) & torch.ones(
        x["keep"].shape[1:], dtype=torch.bool, device="cuda").tril()
    pairs = int(keep.sum().item())
    N, H = x["q"].shape[2:]
    nbytes = 3 * _nbytes(x["q"], x["k"], x["v"]) + _nbytes(x["keep"])
    return nbytes, 12 * N * H * pairs


def _train_bwd_cost(x) -> tuple:
    """The backward alone: q, k, v, out, dO, the mask and the LSE read
    once, dq, dk, dv written once; 10 H FLOPs an attended pair a query
    head (QK^T recomputed, dV, dP, dQ, dK)."""
    keep = (x["keep"] != 0) & torch.ones(
        x["keep"].shape[1:], dtype=torch.bool, device="cuda").tril()
    pairs = int(keep.sum().item())
    B, T, N, H = x["q"].shape
    nbytes = (_nbytes(x["q"], x["k"], x["v"], x["q"], x["dout"], x["keep"])
              + _nbytes(x["q"], x["k"], x["v"]) + 4 * B * N * T)
    return nbytes, 10 * N * H * pairs


# Kernel names by role: kernel 1's forward and its backward's kernels.
# The bf16 route runs the dK/dV and dQ roles in one launch
# (``bwd_bf16_kernel``); the FMA route (f32) as two kernels.
TRAIN_BWD_ROLES = (
    ("forward", ("flash_bf16_kernel",)),
    ("preprocess", ("pre_bf16_kernel", "bwd_pre_kernel")),
    ("dK/dV + dQ", ("bwd_bf16_kernel",)),
    ("dK/dV", ("bwd_dkdv_kernel",)),
    ("dQ", ("bwd_dq_kernel",)),
)
# 22b's profiled (bf16) step by kernel family (first match wins).
TRAIN_STEP_FAMILIES = (
    ("attention forward", ("flash_bf16_kernel",)),
    ("attention backward", ("pre_bf16_kernel", "bwd_bf16_kernel")),
    ("GEMMs", ("gemm", "Gemm", "GEMM", "nvjet", "xmma", "cutlass",
               "sm90_")),
    ("AdamW", ("multi_tensor_apply",)),
    ("softmax / loss", ("softmax", "nll_loss", "cross_entropy")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise / copies", ("elementwise", "vectorized", "copy",
                              "Memcpy", "Memset", "fill")),
)


def _by_role(prof, roles, calls: int = 1) -> dict:
    """Device ms a call by role (the first role whose name fragment a
    kernel's name holds; the others under "rest") from a
    ``torch.profiler`` run over ``calls`` calls."""
    out = {role: 0.0 for role, _ in roles}
    out["rest"] = 0.0
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        role = next((r for r, keys in roles
                     if any(k in e.key for k in keys)), "rest")
        out[role] += e.self_device_time_total / 1e3 / calls
    return out


def _train_sdpa(x):
    """The library call: SDPA forward + backward on the same tensors (the
    causal and key masks as one boolean mask)."""
    T = x["q"].shape[1]
    mask = (x["keep"] != 0)[:, None] & torch.ones(
        (T, T), dtype=torch.bool, device="cuda").tril()
    q, k, v = (x[n].detach().requires_grad_(True) for n in "qkv")
    out = _sdpa(q, k, v, mask)
    return torch.autograd.grad(out, (q, k, v), x["dout"])


def _train_kernel_row() -> dict:
    """22a: the backward kernel against autograd of the plain version at
    llama3_8b's training shape (bf16, f32), a small GQA case and a case
    with fully masked rows; fwd + bwd times beside the plain version,
    SDPA forward + backward and the bound."""
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl

    gen = torch.Generator(device="cuda").manual_seed(22)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": TRAIN_BWD_SOURCE, "replaces": TRAIN_BWD_REPLACES}
    cases = [("llama3_8b", (4, 512, 32, 8, 128), False),
             ("gqa_small", (2, 80, 8, 2, 64), False),
             ("masked_rows", (2, 96, 4, 4, 128), True)]
    for case, dims, masked in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = _train_attn_inputs(*dims, dtype, gen, masked_row=masked)
            got = _train_attn_grads(x, kernel=True)
            torch.cuda.synchronize()
            want = _train_attn_grads(x, kernel=False)
            errs = []
            for g, w in zip(got, want):
                if not torch.isfinite(g.float()).all():
                    fail(f"22a {case}: non-finite gradient")
                scale = max(w.float().abs().max().item(), 1e-30)
                errs.append((g.float() - w.float()).abs().max().item()
                            / scale)
            if masked:
                dead = got[1][0, :3].float().abs().max().item()
                if dead != 0.0:
                    fail(f"22a {case}: a fully masked row's dq is {dead}, "
                         "not 0")
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"[train] 22a {case} {tag} q{tuple(x['q'].shape)} "
                  f"k{tuple(x['k'].shape)}: out / dq / dk / dv max abs err "
                  f"over max |ref| " + " / ".join(f"{e:.3e}" for e in errs)
                  + f" (tol {TRAIN_TOL[dtype]:.0e})", flush=True)
            if not max(errs) <= TRAIN_TOL[dtype]:
                fail(f"22a {case} {tag}: {errs} > {TRAIN_TOL[dtype]}")
            row[f"{case}_max_rel_err_{tag}"] = errs
            if case == "llama3_8b" and dtype == torch.bfloat16:
                nbytes, flops = _train_attn_cost(x)
                b_ms, b_by = bound(nbytes, flops, dtype)
                row.update(
                    q_shape=list(x["q"].shape), kv_shape=list(x["k"].shape),
                    dtype="bfloat16", max_abs_err=max(errs[1:]),
                    ms=time_ms(lambda: _train_attn_grads(x, True), 5, 3),
                    plain_ms=time_ms(lambda: _train_attn_grads(x, False),
                                     3, 3),
                    library_ms=time_ms(lambda: _train_sdpa(x), 5, 3),
                    bound_ms=b_ms, bound_by=b_by, bound_mb=nbytes / 1e6,
                    timed="forward + backward")
                fwd = time_ms(lambda: fl.flash_attention(
                    x["q"], x["k"], x["v"], causal=True,
                    mask=x["keep"][:, None]), 5, 3)
                row["forward_ms"] = fwd
                bw_bytes, bw_flops = _train_bwd_cost(x)
                bw_ms, bw_by = bound(bw_bytes, bw_flops, dtype)
                row.update(bwd_bound_ms=bw_ms, bwd_bound_by=bw_by)
                print(f"[train] 22a llama3_8b bf16 forward + backward: "
                      f"kernel {row['ms']:.4f} ms (forward alone "
                      f"{fwd:.4f}), plain {row['plain_ms']:.4f} ms, sdpa "
                      f"{row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({b_by}, "
                      f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP); "
                      f"the backward's own bound {bw_ms:.4f} ms ({bw_by}, "
                      f"{bw_bytes / 1e6:.1f} MB, {bw_flops / 1e9:.1f} "
                      f"GFLOP)", flush=True)
    # The guard: the bare launch refuses an input that requires grad.
    x = _train_attn_inputs(1, 32, 2, 2, 64, torch.bfloat16, gen)
    q = x["q"].detach().requires_grad_(True)
    try:
        fl._launch(q, x["k"], x["v"], None, causal=True, scale=0.125)
    except RuntimeError as e:
        print(f"[train] 22a guard: the bare launch refused ({e})",
              flush=True)
    else:
        fail("22a: the bare kernel-1 launch took an input that requires "
             "grad")
    _reset_counts()   # comparison launches do not count
    return row


TRAIN_LAYERS = 4          # 22b: AdamW state is 16 B a param (see PERF.md)
TRAIN_PARITY_LAYERS = 2   # 22b's parity and 22c's TP / ring program
TRAIN_STEPS = 5
TRAIN_LR = 1e-3           # 22c's steps and the parity's state (optax's 1e-3)
# 22b's AdamW rate: at 1e-3 the 1.92 B-param model overshoots after its
# third step on one batch (call 2 of PR 20: 12.29 9.44 7.01 7.26 8.12).
TRAIN_RUN_LR = 1e-4
# 22b / 22c: each gradient leaf against its reference, max abs error over
# the leaf's largest |gradient|; losses relative.
TRAIN_GRAD_TOL = 1e-4
TRAIN_LOSS_TOL = 1e-5
TRAIN_DIR = "build/train22"


def _train_batch(cfg, B: int, T: int, seed: int):
    """Tokens [B, T] from a seed and a mask with the last row's final
    quarter padding (host tensors: every rank cuts its own share)."""
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                        dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[-1, 3 * T // 4:] = 0
    return tok, mask


def _grad_errs(got: dict, want: dict, scale: dict = None) -> dict:
    """Each leaf's max abs error over its reference's largest entry."""
    out = {}
    for n, w in want.items():
        g = got[n].to(w.device).float()
        s = (scale or {}).get(n) or w.abs().max().item()
        out[n] = (g - w.float()).abs().max().item() / max(s, 1e-30)
    return out


def _train_parity() -> dict:
    """22b parity: llama3_8b full width, 2 layers, f32; one step's loss and
    gradients through kernel 1 (+ its backward) against the plain route."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.ops import attention
    from ray_dynamic_batching_tpu_torch.ops import flash_attention as fl
    from ray_dynamic_batching_tpu_torch.parallel import optim
    from ray_dynamic_batching_tpu_torch.parallel import train

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=TRAIN_PARITY_LAYERS)
    model = CausalLM(cfg, name="llama3_8b", dtype=torch.float32,
                     device="cuda", seed=0)
    params, _ = train.make_sharded_train_state(model, None,
                                               optim.adamw(TRAIN_LR))
    tok, mask = _train_batch(cfg, 2, 128, 22)
    _reset_counts()
    loss, grads = train.loss_and_grads(model, None, params, tok, mask)
    grads = {n: g.clone() for n, g in grads.items()}
    launched = (fl.launches, fl.bwd_launches)
    with attention.plain_attention():
        loss_p, grads_p = train.loss_and_grads(model, None, params, tok,
                                               mask)
    errs = _grad_errs(grads, grads_p)
    worst = max(errs, key=errs.get)
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    print(f"[train] 22b parity llama3_8b f32 {TRAIN_PARITY_LAYERS} layers "
          f"B2 x T128: loss {float(loss):.6f} kernel vs {float(loss_p):.6f} "
          f"plain (rel {rel:.2e}, tol {TRAIN_LOSS_TOL:.0e}); gradients max "
          f"err / max |ref| {errs[worst]:.3e} ({worst}; tol "
          f"{TRAIN_GRAD_TOL:.0e}); kernel 1 / backward launches {launched}",
          flush=True)
    if rel > TRAIN_LOSS_TOL or errs[worst] > TRAIN_GRAD_TOL:
        fail("22b parity: the kernel route's loss or gradients differ from "
             "the plain route's")
    if launched != (TRAIN_PARITY_LAYERS, TRAIN_PARITY_LAYERS):
        fail(f"22b parity: launches {launched}, expected one forward and "
             "one backward a layer")
    del model, params, grads, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts()
    return dict(loss_rel_err=rel, grad_max_rel_err=errs[worst])


def _train_run(smi: str) -> tuple:
    """22b training: llama3_8b full width, bf16 compute over f32 params and
    AdamW moments, TRAIN_LAYERS layers, B 4 x T 512, TRAIN_STEPS steps on
    one batch. Returns (the steps' launch counts, summary)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.parallel import optim
    from ray_dynamic_batching_tpu_torch.parallel import train

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=TRAIN_LAYERS)
    B, T = 4, 512
    torch.cuda.reset_peak_memory_stats()
    model = CausalLM(cfg, name="llama3_8b", dtype=torch.bfloat16,
                     device="cuda", seed=0)
    opt = optim.adamw(TRAIN_RUN_LR)
    params, opt_state = train.make_sharded_train_state(model, None, opt)
    n_params = sum(p.numel() for p in params.values())
    step = train.make_train_step(model, None, opt)
    tok, mask = _train_batch(cfg, B, T, 23)
    tok, mask = tok.cuda(), mask.cuda()
    torch.cuda.synchronize()
    _reset_counts()      # the main path's run starts here
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tok, mask)
        losses.append(float(loss))     # one host read a step
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    want = {"flash_attention": TRAIN_LAYERS * TRAIN_STEPS,
            "flash_attention_bwd": TRAIN_LAYERS * TRAIN_STEPS}
    _expect_only("22b training", counts, want)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"22b training: losses {losses} do not fall")
    steady = statistics.median(ms[1:])
    prof_step = _train_step_profile(step, params, opt_state, tok, mask)
    params, opt_state = prof_step.pop("state")
    tokens = B * T
    flops = 3 * model.flops_per_sample(T) * B       # forward + backward
    peak = torch.cuda.max_memory_allocated() / 1e9
    summary = dict(layers=TRAIN_LAYERS, params=n_params, batch=[B, T],
                   losses=losses, step_ms=ms, steady_step_ms=steady,
                   tokens_per_s=tokens / steady * 1e3,
                   model_tflops=flops / steady / 1e9, peak_gb=peak,
                   profiled_step=prof_step, card=smi)
    print(f"[train] 22b llama3_8b bf16 / f32 params + AdamW, "
          f"{TRAIN_LAYERS} layers ({n_params / 1e9:.3f} B params), B {B} x "
          f"T {T}: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; step {steady:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
          f"first {ms[0]:.1f}), {summary['tokens_per_s']:.0f} tokens/s, "
          f"{summary['model_tflops']:.1f} model TFLOP/s, peak "
          f"{peak:.2f} GB; launches {counts} ({smi})", flush=True)
    del model, params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts, summary


def _train_step_profile(step, params, opt_state, tok, mask) -> dict:
    """One more 22b step under ``torch.profiler`` (CUDA activity): its
    wall ms, device busy ms and idle share, device ms by kernel family
    (``TRAIN_STEP_FAMILIES``), kernel 1's and its backward's kernels a
    layer (``TRAIN_BWD_ROLES``) and the top kernels; "state" is the
    state the step returns."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tok, mask)
        float(loss)
        wall = (time.perf_counter() - t0) * 1e3
    fam = _by_role(prof, TRAIN_STEP_FAMILIES)
    busy = sum(fam.values())
    # Kernel 1 and its backward run once a layer of the step.
    split = _by_role(prof, TRAIN_BWD_ROLES, TRAIN_LAYERS)
    rows = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    top = [(e.key[:100], e.count, e.self_device_time_total / 1e3)
           for e in rows[:12]]
    if not busy:
        print(f"[train] 22b profiled step: wall {wall:.1f} ms, device time "
              "not measured (no device time traced)", flush=True)
        return dict(wall_ms=wall, busy_ms=None, by_family_ms=None, top=[],
                    bwd_split_ms=None, state=(params, opt_state))
    print(f"[train] 22b profiled step: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle {100 * (1 - busy / wall):.1f}%); by family "
          + ", ".join(f"{f} {t:.2f} ms ({100 * t / busy:.1f}%)"
                      for f, t in fam.items()), flush=True)
    for name, count, t in top:
        print(f"[train]   {t:8.2f} ms x{count:<5d} {name}", flush=True)
    print("[train] 22b profiled step, a layer's kernel 1 and backward "
          "(B 4 x T 512, 32 / 8 heads of 128, causal + key mask): "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in split.items()
                      if t and r != "rest"), flush=True)
    return dict(wall_ms=wall, busy_ms=busy, by_family_ms=fam, top=top,
                bwd_split_ms=split, state=(params, opt_state))


def _rank_grad_check(ctx, seq, key: str, ref_path: str) -> dict:
    """A rank's gradients (kept by ``loss_and_grads``) against its slice
    of the reference file: each leaf's max abs error over the whole
    reference leaf's largest entry."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import shard_plan

    ref = torch.load(ref_path, mmap=True)
    plan = shard_plan(ctx.mesh, ctx.objects[key])
    grads = ctx.objects.pop((key, "grads"))
    return {n: (g.float() - plan[n].take(ref["grads"][n]).to(g.device))
            .abs().max().item() / max(ref["scale"][n], 1e-30)
            for n, g in grads.items()}


def _rank_grads_np(ctx, seq, key: str) -> dict:
    """A rank's kept gradients as numpy with the cuts of its slices."""
    from ray_dynamic_batching_tpu_torch.parallel.mesh import shard_plan

    plan = shard_plan(ctx.mesh, ctx.objects[key])
    return {n: (g.float().cpu().numpy(),
                [(c.dim, c.parts, c.index) for c in plan[n].cuts()])
            for n, g in ctx.objects.pop((key, "grads")).items()}


def _merge_grads(per_rank, shapes) -> dict:
    out = {}
    for n, shape in shapes.items():
        full = torch.full(shape, float("nan"))
        for rank in per_rank:
            if n in rank:
                g, cuts = rank[n]
                view = full
                for dim, parts, index in cuts:
                    m = view.shape[dim] // parts
                    view = view.narrow(dim, index * m, m)
                view.copy_(torch.from_numpy(g))
        out[n] = full
    return out


def _world_run(tag: str, conf: dict, build, steps_fn, check,
               paths: dict, after=None) -> dict:
    """One gloo world of four ranks on cuda:0: build the train state,
    check one step's loss and gradients, take two steps (every rank's
    counts set to 0 before the check and read after the steps, summed
    into ``paths["train_mesh"]``), then ``after`` (22c (e)); the ranks
    end."""
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm

    t0 = time.monotonic()
    mesh = pm.build_mesh(pm.MeshConfig(**conf), ["cuda:0"] * 4,
                         backend="gloo")
    procs = list(mesh.world._procs)
    try:
        t1 = time.monotonic()
        state = build(mesh)
        (out, losses), counts = _tp_window(
            mesh, paths, "train_mesh",
            lambda: (check(mesh, state), steps_fn(mesh, state)))
        if not (np.isfinite(losses).all() and losses[1] < losses[0]):
            fail(f"22c {tag}: two steps' losses {losses}")
        out.update(step_losses=losses, spawn_s=t1 - t0,
                   bwd_launches_by_rank=[c["flash_attention_bwd"]
                                         for c in counts])
        if after is not None:
            out.update(after(mesh, state))
        out["wall_s"] = time.monotonic() - t0
    finally:
        mesh.shutdown()
    if any(p.is_alive() for p in procs):
        fail(f"22c {tag}: a rank outlived its mesh")
    print(f"[train] 22c {tag}: two steps' losses {losses[0]:.6f} -> "
          f"{losses[1]:.6f}; world {out['wall_s']:.1f} s ({TP_LABEL})",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_mesh_tp_sp(paths: dict) -> dict:
    """22c dp x sp x tp = 1 x 2 x 2: llama3_8b full width, 2 layers, f32 —
    ring attention over sp, TP collectives over tp — against the one-card
    step (its loss and gradients kept on the host; the gradients through a
    file each rank maps and slices)."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        LLAMA3_8B,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm
    from ray_dynamic_batching_tpu_torch.parallel import optim
    from ray_dynamic_batching_tpu_torch.parallel import train

    cfg = dataclasses.replace(LLAMA3_8B, num_layers=TRAIN_PARITY_LAYERS)
    tok, mask = _train_batch(cfg, 2, 128, 24)
    opt = optim.adamw(TRAIN_LR)
    model = CausalLM(cfg, name="llama3_8b", dtype=torch.float32,
                     device="cuda", seed=0)
    params, _ = train.make_sharded_train_state(model, None, opt)
    ref_loss, grads = train.loss_and_grads(model, None, params, tok, mask)
    ref_loss = float(ref_loss)
    os.makedirs(TRAIN_DIR, exist_ok=True)
    ref_path = os.path.join(TRAIN_DIR, "tp_sp_ref.pt")
    torch.save({"grads": {n: g.cpu() for n, g in grads.items()},
                "scale": {n: g.abs().max().item()
                          for n, g in grads.items()}}, ref_path)
    del model, params, grads
    gc.collect()
    torch.cuda.empty_cache()

    def build(mesh):
        shard = pm.build_sharded_model(mesh, CausalLM, cfg, "llama3_8b",
                                       dtype=torch.float32, seed=0)
        return shard, train.make_sharded_train_state(shard, mesh, opt)

    def check(mesh, state):
        shard, (p, _s) = state
        loss, _ = train.loss_and_grads(shard, mesh, p, tok, mask)
        errs = {}
        for r in mesh.world.call(_rank_grad_check, shard.tp_shard.key,
                                 ref_path):
            for n, e in r.items():
                errs[n] = max(errs.get(n, 0.0), e)
        worst = max(errs, key=errs.get)
        rel = abs(float(loss) - ref_loss) / abs(ref_loss)
        print(f"[train] 22c sp2 x tp2 llama3_8b f32 {TRAIN_PARITY_LAYERS} "
              f"layers B2 x T128: loss {float(loss):.6f} vs one card "
              f"{ref_loss:.6f} (rel {rel:.2e}); every rank's gradient "
              f"slice vs the one-card step: max err / max |ref| "
              f"{errs[worst]:.3e} ({worst}; tol {TRAIN_GRAD_TOL:.0e})",
              flush=True)
        if rel > TRAIN_LOSS_TOL or errs[worst] > TRAIN_GRAD_TOL:
            fail("22c sp x tp: loss or gradients differ from the one-card "
                 "step")
        return dict(loss_rel_err=rel, grad_max_rel_err=errs[worst])

    def steps(mesh, state):
        shard, (p, s) = state
        step = train.make_train_step(shard, mesh, opt)
        return [float(step(p, s, tok, mask)[2]) for _ in range(2)]

    try:
        return _world_run("sp2 x tp2", dict(sp=2, tp=2), build, steps,
                          check, paths)
    finally:
        os.remove(ref_path)


def _train_whole_save(shard, p, s, keep: dict) -> dict:
    """22c (e), in the sp x ep world: its train state after the two steps
    (params and AdamW moments) saved whole (``save_train_state(model=<rank
    0's shard>)``: every rank's distinct slices sent to rank 0), then the
    world's leaves gathered again onto the host for the check
    (:func:`_train_whole_check`, run once the world has ended and freed
    the card)."""
    from ray_dynamic_batching_tpu_torch.parallel import train
    from ray_dynamic_batching_tpu_torch.runtime import checkpoint as ck

    root = os.path.join(TRAIN_DIR, "whole")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.monotonic()
    path = ck.save_train_state(ck.CheckpointManager(root), 2, p, s,
                               model=shard, note="sp2 x ep2")
    save_s = time.monotonic() - t0
    t0 = time.monotonic()
    keep["twin"], keep["params"], keep["opt"] = train.gather_train_state(
        shard, p, s)
    keep["root"] = root
    return dict(whole_save_mb=sum(f.stat().st_size for f in path.iterdir())
                / 1e6, whole_save_s=save_s,
                whole_gather_s=time.monotonic() - t0)


def _train_whole_check(keep: dict, out: dict) -> dict:
    """22c (e), after the world: the checkpoint restored as one device's
    train state onto the card (the gathered trees give the targets'
    structure; the restore makes new tensors), held bit for bit against
    the world's gathered leaves; the checkpoint removed."""
    from ray_dynamic_batching_tpu_torch.runtime import checkpoint as ck

    tag = "22c (e) sp2 x ep2 whole save"
    gp, gs = keep.pop("params"), keep.pop("opt")
    t0 = time.monotonic()
    rp, rs, at = ck.restore_train_state(
        ck.CheckpointManager(keep["root"]), gp, gs, model=keep.pop("twin"),
        device="cuda")
    restore_s = time.monotonic() - t0
    if at != 2 or set(rp) != set(gp):
        fail(f"{tag}: restored step {at}, leaves {sorted(rp)[:3]}...")
    if int(rs[0].count) != 2 or int(gs[0].count) != 2:
        fail(f"{tag}: step count {int(rs[0].count)}")
    trees = [(rp, gp), (rs[0].mu, gs[0].mu), (rs[0].nu, gs[0].nu)]
    for got, want in trees:
        for n, w in want.items():
            if got[n].device.type != "cuda" or not torch.equal(
                    got[n].detach().cpu(), w):
                fail(f"{tag}: {n} restored on one card differs from the "
                     "world's gathered leaf")
    del rp, rs, gp, gs, trees
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(keep["root"], ignore_errors=True)
    print(f"[train] {tag}: the params and AdamW moments "
          f"({out['whole_save_mb']:.2f} MB) "
          f"gathered from the four ranks and saved in "
          f"{out['whole_save_s']:.1f} s, restored as one device's onto the "
          f"card in {restore_s:.1f} s, bit for bit the world's leaves "
          f"gathered again ({out['whole_gather_s']:.1f} s); checkpoint "
          "removed", flush=True)
    return dict(whole_restore_s=restore_s)


def _train_mesh_moe_sp(paths: dict) -> dict:
    """22c (d) sp x ep = 2 x 2: moe_tiny at its registered config, routing
    with capacity over the whole sequence (each MoE layer gathers the sp
    chunks), ring attention over sp, experts over ep, against the
    one-card step; the gradients merged from every rank."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        TINY_MOE,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.parallel import mesh as pm
    from ray_dynamic_batching_tpu_torch.parallel import optim
    from ray_dynamic_batching_tpu_torch.parallel import train

    tok, mask = _train_batch(TINY_MOE, 4, 64, 26)
    opt = optim.adamw(TRAIN_LR)
    model = CausalLM(TINY_MOE, name="moe_tiny", dtype=torch.float32,
                     device="cuda", seed=0)
    params, _ = train.make_sharded_train_state(model, None, opt)
    ref_loss, ref = train.loss_and_grads(model, None, params, tok, mask)
    ref_loss = float(ref_loss)
    ref = {n: g.cpu() for n, g in ref.items()}
    del params

    def build(mesh):
        shard = pm.shard_params(mesh, model)
        return shard, train.make_sharded_train_state(shard, mesh, opt)

    def check(mesh, state):
        shard, (p, _s) = state
        loss, _ = train.loss_and_grads(shard, mesh, p, tok, mask)
        merged = _merge_grads(
            mesh.world.call(_rank_grads_np, shard.tp_shard.key),
            {n: tuple(g.shape) for n, g in ref.items()})
        errs = _grad_errs(merged, ref)
        worst = max(errs, key=errs.get)
        rel = abs(float(loss) - ref_loss) / abs(ref_loss)
        print(f"[train] 22c sp2 x ep2 moe_tiny f32 B4 x T64: loss "
              f"{float(loss):.6f} vs one card {ref_loss:.6f} (rel "
              f"{rel:.2e}); merged gradients max err / max |ref| "
              f"{errs[worst]:.3e} ({worst}; tol {TRAIN_GRAD_TOL:.0e})",
              flush=True)
        if rel > TRAIN_LOSS_TOL or errs[worst] > TRAIN_GRAD_TOL:
            fail("22c sp x ep: loss or gradients differ from the one-card "
                 "step")
        return dict(loss_rel_err=rel, grad_max_rel_err=errs[worst])

    def steps(mesh, state):
        shard, (p, s) = state
        step = train.make_train_step(shard, mesh, opt)
        return [float(step(p, s, tok, mask)[2]) for _ in range(2)]

    keep = {}

    def save_whole(mesh, state):
        shard, (p, s) = state
        return _train_whole_save(shard, p, s, keep)

    try:
        out = _world_run("sp2 x ep2", dict(sp=2, ep=2), build, steps, check,
                         paths, after=save_whole)
        out.update(_train_whole_check(keep, out))
        return out
    finally:
        shutil.rmtree(os.path.join(TRAIN_DIR, "whole"), ignore_errors=True)


def _train_mesh_pp_ep(paths: dict) -> dict:
    """22c pp x ep = 2 x 2: moe_tiny (its registered config, 2 layers) in
    two GPipe stages with its experts over ep, against the one-card step;
    the gradients merged from every rank."""
    from ray_dynamic_batching_tpu_torch.models.causal_lm import (
        TINY_MOE,
        CausalLM,
    )
    from ray_dynamic_batching_tpu_torch.parallel import optim
    from ray_dynamic_batching_tpu_torch.parallel import pipeline
    from ray_dynamic_batching_tpu_torch.parallel import train

    tok, mask = _train_batch(TINY_MOE, 4, 64, 25)
    opt = optim.adamw(TRAIN_LR)
    model = CausalLM(TINY_MOE, name="moe_tiny", dtype=torch.float32,
                     device="cuda", seed=0)
    params, _ = train.make_sharded_train_state(model, None, opt)
    ref_loss, ref = train.loss_and_grads(model, None, params, tok, mask)
    ref_loss = float(ref_loss)
    ref = {n: g.cpu() for n, g in ref.items()}
    del params

    def build(mesh):
        pmodel = pipeline.PipelinedCausalLM(model, mesh, n_microbatches=2)
        return pmodel, pipeline.make_pp_train_state(pmodel, opt)

    def check(mesh, state):
        pmodel, (p, _s) = state
        loss, _ = pipeline.pp_loss_and_grads(pmodel, p, tok, mask)
        merged = _merge_grads(
            mesh.world.call(_rank_grads_np, pmodel.model.tp_shard.key),
            {n: tuple(g.shape) for n, g in ref.items()})
        errs = _grad_errs(merged, ref)
        worst = max(errs, key=errs.get)
        rel = abs(float(loss) - ref_loss) / abs(ref_loss)
        print(f"[train] 22c pp2 x ep2 moe_tiny f32 B4 x T64, 2 "
              f"microbatches: loss {float(loss):.6f} vs one card "
              f"{ref_loss:.6f} (rel {rel:.2e}); merged gradients max err / "
              f"max |ref| {errs[worst]:.3e} ({worst}; tol "
              f"{TRAIN_GRAD_TOL:.0e})", flush=True)
        if rel > TRAIN_LOSS_TOL or errs[worst] > TRAIN_GRAD_TOL:
            fail("22c pp x ep: loss or gradients differ from the one-card "
                 "step")
        return dict(loss_rel_err=rel, grad_max_rel_err=errs[worst])

    def steps(mesh, state):
        pmodel, (p, s) = state
        step = pipeline.make_pp_train_step(pmodel, opt)
        return [float(step(p, s, tok, mask)[2]) for _ in range(2)]

    return _world_run("pp2 x ep2", dict(pp=2, ep=2), build, steps, check,
                      paths)


def phase_train(smi: str) -> tuple:
    """Phase 22 (see the module docstring). Returns (the main path's launch
    counts, the backward kernel's row, summary)."""
    t0 = time.monotonic()
    row = _train_kernel_row()
    parity = _train_parity()
    counts, run = _train_run(smi)
    row["split_ms"] = run["profiled_step"]["bwd_split_ms"]
    paths = {"train": counts}
    meshes = {"sp2_tp2": _train_mesh_tp_sp(paths),
              "pp2_ep2": _train_mesh_pp_ep(paths),
              "sp2_ep2": _train_mesh_moe_sp(paths)}
    wall = time.monotonic() - t0
    print(f"[train] phase 22 took {wall:.1f} s", flush=True)
    return paths, row, dict(parity=parity, run=run, meshes=meshes,
                            wall_s=wall)


#: phase -> launches of kernel 1 and kernels 2-4 by body in that phase.
_PHASE_BODIES: dict = {}


def _phase_time(name: str, fn, *args):
    """``fn(*args)``, printing its wall seconds (the script's time budget,
    PERF.md section 4); the phase's launches by body are kept."""
    t0 = time.monotonic()
    before = _bodies()
    out = fn(*args)
    _PHASE_BODIES[name] = _body_delta(before)
    print(f"[time] {name}: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    with contextlib.ExitStack() as stack:
        _main(stack)


def _main(stack: contextlib.ExitStack) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    all_phases = (["build", "kernels", "parity"] + list(SERVING)
                  + ["front", "controller", "colocate", "vision", "graphs",
                     "sim", "reuse", "spec", "weights", "servables", "tp",
                     "surface", "train"])
    ap.add_argument("--phases", default=",".join(all_phases),
                    help=f"comma-separated subset of {','.join(all_phases)} "
                         "(the device phase always runs)")
    ap.add_argument("--profile", action="store_true",
                    help="trace each serving window with torch.profiler "
                         "(CUDA activity) and print device time by kernel")
    ap.add_argument("--eager", action="store_true",
                    help="build every engine with its programs run eagerly "
                         "(graphs.disable_capture()): the eager side of "
                         "PERF.md's graphed-vs-eager table")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(all_phases):
        fail(f"unknown phases {sorted(phases - set(all_phases))}")
    dev = phase_device()
    try:
        import ray_dynamic_batching_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package does not import beside this script ({e}): "
             "run chip_smoke.py from the root of a checkout")
    if args.eager:
        from ray_dynamic_batching_tpu_torch.ops import graphs

        stack.enter_context(graphs.disable_capture())
        print("[device] --eager: every engine runs its programs eagerly",
              flush=True)
    t_start = time.monotonic()
    if "build" in phases:
        phase_build()
    kernels = (_phase_time("kernels", phase_kernels) if "kernels" in phases
               else {})
    print(f"[time] through phase 3: {time.monotonic() - t_start:.1f} s",
          flush=True)
    if "parity" in phases:
        _phase_time("parity", phase_parity)
    by_path, cache, summary = {}, {}, {}
    for phase, (path, seed, n_long, knobs) in SERVING.items():
        if phase in phases:
            payloads = _payloads(np.random.default_rng(seed), 128256, 32, 8,
                                 2, n_long)
            by_path[path], cache[path], summary[path] = _phase_time(
                phase, _serving_phase, phase, payloads, knobs, args.profile)
    if cache:
        print("[cache] KV cache bytes by serving phase: " + ", ".join(
            f"{p} {b / 1e9:.3f} GB" for p, b in cache.items()), flush=True)
    if "slab_chunked" in summary:
        beside = []
        for p in ("slab", "int8", "slab_chunked"):
            if p not in summary:
                continue
            s = summary[p]
            longs = " / ".join(f"{t:.1f}" for t in s["ttft_long_ms"])
            beside.append(
                f"{p} {s['tok_s']:.1f} tok/s, TTFT p50 {s['ttft_p50_ms']:.1f}"
                f" ms (max {s['ttft_max_ms']:.1f})"
                + (f", the long prompts {longs} ms" if longs else ""))
        print("[slab_chunked] beside main and int8: " + "; ".join(beside),
              flush=True)
    front = controller = colocate = vision = graphed = sim = reuse = None
    spec = weights = servables = tp = surface = training = None
    if "front" in phases:
        by_path["front"], front = _phase_time("front", phase_front,
                                              args.profile)
    if "controller" in phases:
        by_path["controller"], controller = _phase_time(
            "controller", phase_controller, front)
    if "colocate" in phases:
        by_path["colocate"], colocate = _phase_time("colocate", phase_colocate)
    if "vision" in phases:
        by_path["vision"], vision = _phase_time("vision", phase_vision)
    if "graphs" in phases and not args.eager:
        by_path["graphs"], graphed = _phase_time("graphs", phase_graphs)
    if "sim" in phases:
        sim = _phase_time("sim", phase_sim)
    if "reuse" in phases:
        by_path["reuse"], reuse = _phase_time("reuse", phase_reuse)
    if "spec" in phases:
        by_path["spec"], spec = _phase_time("spec", phase_spec)
    if "weights" in phases:
        by_path["weights"], weights = _phase_time("weights", phase_weights,
                                                  args.profile)
    if "servables" in phases:
        by_path["servables"], servables = _phase_time("servables",
                                                      phase_servables)
    if "tp" in phases:
        tp_paths, tp = _phase_time("tp", phase_tp)
        by_path.update(tp_paths)
    if "surface" in phases:
        by_path["surface"], surface = _phase_time("surface", phase_surface)
    if "train" in phases:
        train_paths, kernels["flash_attention_bwd"], training = \
            _phase_time("train", phase_train, dev["smi"])
        by_path.update(train_paths)
    print(f"[time] all phases: {time.monotonic() - t_start:.1f} s",
          flush=True)
    for name, row in kernels.items():
        split = {path: c.get(name, 0) for path, c in by_path.items()}
        row["launches"] = sum(split.values()) if split else None
        row["launches_by_path"] = split
    # The bodies every phase but phase 3 (comparisons) launched: kernel 1's
    # on its row, kernels 2-4's (one counter) on kernel 2's.
    for name, prefix in (("flash_attention", "flash_attention/"),
                         ("decode_attention", "decode_kernels/")):
        if name in kernels:
            kernels[name]["launches_by_body"] = {
                k.removeprefix(prefix): sum(
                    d.get(k, 0) for ph, d in _PHASE_BODIES.items()
                    if ph != "kernels")
                for k in _bodies() if k.startswith(prefix)}
    print(json.dumps({"kernels": list(kernels.values()), "front": front,
                      "controller": controller, "colocate": colocate,
                      "vision": vision, "graphs": graphed, "sim": sim,
                      "reuse": reuse, "spec": spec, "weights": weights,
                      "servables": servables, "tp": tp,
                      "surface": surface, "train": training}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
