#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. environment — torch and CUDA versions, the card's capability (9.0
   required) and ``nvidia-smi``'s name and power limit;
2. build — the hand-written CUDA kernels, compiled from the checkout's
   sources with ``nvcc`` into ``build/kernels/`` (one ``nvcc`` per
   source, all started together); the Triton kernel compiles at its first
   launch, into ``build/triton/``;
3. link — the card's links, measured: a 1 GiB pinned host -> device copy
   and the copy back on a side stream (the pool's copy stream's kind),
   and one device-to-device ``copy_`` of a 142.6 MB trainer chunk (the
   simulated ranks' gather: HBM, not NVLink), in GB/s; the H100 record
   (``repro_torch.analysis.roofline.H100_SXM``) with these rates prices
   the timeline phases below;
4. kernel / flash_attention_fwd — K2's forward against its plain PyTorch
   version at the serving slice's prefill and decode shapes, the
   training shape and a long row (B=1, S=4096, H=16, D=128, causal), bf16
   (tolerance 2e-2) and fp32 (1e-4), with GQA, D=32, kv_len < Sk, a
   window, and decode at kv_len 1, 37, 64, 65 and 1024, both without the
   log-sum-exp (serving's launch) and with it (the training launch; the
   lse held at 1e-4 absolute); each row names the schedule
   ``plan_forward`` chose (``tc``, ``splitkv`` or ``tf32x3``) and prints
   the output's relative Frobenius error beside its largest absolute
   one, and a split-kv row also holds the kernel against the same splits
   merged in plain PyTorch; its time (kernel, SDPA, SDPA, kernel, in
   turns, and the profiler's device time) beside the plain version's,
   ``scaled_dot_product_attention``'s (a yardstick the port never calls)
   and the least time the card could take (in fp32 the lesser of the
   FMA pipes' time and that of three TF32 products on the tensor cores),
   and its TFLOP/s; then the long row's relative errors beside the
   training shape's; then ``decode_kvlens`` (bf16 and fp32): the compiled
   serving round's decode, 8 slots each at its own length (1, 37, 64,
   65, 500, 512, 1023, 1024 over a 1024-row horizon) read from the card
   (``kv_lens``), splits over the whole horizon: against the plain
   version and its split arithmetic, then captured once in a CUDA graph
   and replayed at other lengths against the plain version at those
   (the capture counted as captured, not launched); its eager and
   replay times beside the plain version's, SDPA's with a boolean mask,
   its device time and its byte bound.  The same rows at gpt2-paper-4b's
   head dim 144 (training shape B=8, S=1024, H=16; its prefill cohort;
   decode at kv_len 1024; ``decode_kvlens``), qwen2.5-3b's decode (GQA
   16/2) and zamba2-1.2b's shared block (32 heads x 128: training B=2,
   S=2048, and decode B=4 at kv_len 1024; and training on one model rank
   of tp 2, 16 heads) with the same checks;
5. kernel / chunked_adam — K1 (Triton) against its plain version at one
   param chunk of gpt2-paper-1b's training chunk map: fp32 and bf16 g and
   output, weight decay 0 and 0.1, a ragged length, g aliased to the
   output (tolerance 1e-6 on p, m and v and on an fp32 output; a bf16
   output within 1e-6 plus one bf16 ulp of the updated params); its time
   beside the plain version's, ``torch._fused_adam_``'s (a yardstick)
   alone and followed by ``out.copy_(p)`` (K1's whole work), its bound and
   the fused call's own (28 bytes an element);
6. kernel / flash_attention_bwd — K2's backward against its plain version
   at the training shape (B=8, S=1024, H=16, D=128, causal), GQA, D=64,
   ragged S=1000 and a long row (B=1, S=4096), each in bf16 (schedule
   ``tc``) and fp32 (``tf32x3``), gpt2-paper-4b's training shape at
   D=144 in both, zamba2-1.2b's (B=2, S=2048, H=32, and H=16 on one
   model rank of tp 2, bf16), and unmasked
   D=32 (fp32, ragged, GQA),
   the long row's relative errors printed beside the training shape's:
   the forward's output and lse
   against the plain forward's, then the backward wrapper and the autograd
   function (``ops.flash_attention`` on leaf tensors, the route of every
   BWD recompute) against the plain backward fed the plain forward's
   output and lse, each of dq, dk and dv on its own (absolute error
   within 2e-2 in bf16, 1e-4 in fp32, times its largest value, at least
   1; relative Frobenius error within 1e-2 in bf16, 1e-4 in fp32; each
   row prints the median |gradient| beside its limits); its time beside
   the plain version's, SDPA's backward (forward + backward minus forward,
   timed in turns with the kernel) and the bound (10*D flops per visible
   pair: S recomputed, dP, dV, dK, dQ; in fp32 the lesser of the FMA
   pipes' time and that of three TF32 products on the tensor cores); and
   the names of the kernels SDPA's fp32 backward runs, from the profiler;
6a. window_kernels — K2 with mixtral's sliding window at its attention
    shape (B=1, S=8192, H=32, KV=8, D=128, window 4096), bf16 and fp32:
    the forward and the backward against the plain version (one kv head
    group a call), timed beside it, SDPA with a boolean window mask and
    the same kernel without the window; the split-kv decode over a
    4096-row ring with per-row ``kv_lens``; the smoke window (32) at
    S = 32 (bit-identical to no window), 33 and 96;
6b. mla_kernels — K2 at MLA's head dims (q/k 192, values 128) at
    deepseek-v2-lite's training shape (B=2, S=4096, H=16, causal) and its
    eager prefill (B=1, S=512), bf16 and fp32: the forward with its lse
    and the backward through the autograd function against the plain
    version (the same tolerances), each timed beside the plain version
    and SDPA (the backend that took Dv != D named), its bound from the
    (192, 128) counts (2 (D + Dv) flops a visible pair-head forward,
    2 (3 D + 2 Dv) backward, each tensor's bytes at its own width), its
    TFLOP/s and ptxas's registers for the pair's instances (a spill
    raises);
6c. whisper_kernels — K2 at whisper-large-v3's shapes (20 heads of 64;
    1500 rows are not a multiple of its tiles), bf16 and fp32: the
    encoder's bidirectional and the decoder's causal self-attention at 4 x
    1500, cross-attention of 432 queries over 1500 frames, each forward
    (with its lse) and backward against the plain version, and the
    split-kv decode against a 448-row self cache and the 1500-row cross
    cache, each timed beside the plain version and SDPA with its bound;
7. params_4b — gpt2-paper-4b's weights at full width, 24 of its 64
    layers (seed 0, drawn on the card), made once for the two phases
    after it (every model's weights in the script are drawn on the card);
8. train_4b — gpt2-paper-4b at full width, 24 layers (a cut for the
    script's time limit), trained by the
    eager engine as in train_slice (a warm-up step and 1 step, 2 before
    whisper's phases joined, then a profiled one) under a 16 GiB device
    budget against ~26 GB of chunked model data, a chunk the size of the
    pinned host
    block it occupies; ``MemTotal`` and ``MemAvailable`` first, and a
    depth cut (never width) if the host cannot hold the pinned tier;
    tokens/s, FWD/BWD/ADAM seconds, the bytes (hidden and critical), the
    peak against its limit, the idle share of a profiled step, K2 and K1
    launches against the plan;
9. serve_4b — gpt2-paper-4b at full width, 24 layers, serving the
    slice's requests:
    the eager engine under 4 GiB (slice's checks), then the compiled
    engine under 4 GiB and under the smallest whole GiB that holds the
    param stream and the KV, with compiled_slice's gates and yardsticks;
    prefill and decode tokens/s and the round wall split;
9a. params_mixtral, train_mixtral, serve_mixtral — mixtral-8x7b at full
    width (4096, 8 experts of 14336 top-2, GQA 32/8, window 4096), its
    weights drawn on the card for 2 layers: the eager trainer on 1
    layer, bf16, 1 x 8192 tokens, 16 GiB against ~24 GB of model data
    (2 GiB chunks: one expert tensor is 469.8 M elements), a warm-up step,
    1 step (2 before whisper's phases joined) and a profiled one,
    launches as planned, the peak against a
    limit that counts one layer's MoE intermediates; the eager and the
    compiled engine on 2 layers under 8 GiB (the slice's requests),
    counters equal, K2 as planned, differing tokens reported;
9b. moe_parity — mixtral at full width, 2 layers, fp32, served on the CPU
    and on the card (two prompts of 16 tokens, 2 new, a budget that
    pages): tokens and counters identical, K2 as planned;
9c. moe_smoke_parity — mixtral's smoke config (window 32), fp32: eager
    and compiled serving on the CPU and the card (prompts of 40, 64 and
    96 tokens: the ring wraps), tokens identical, counters identical CPU
    against card and compiled against eager; the runtime and the eager
    trainer 3 steps each, losses within 1e-4, launches as planned;
9d. params_dsv2, train_dsv2, serve_dsv2 — deepseek-v2-lite-16b at full
    width (2048, MLA with a 512 latent and q/k 128 + 64, 64 experts of
    1408 top-6 and 2 shared, a leading dense layer with GQA at head dim
    128, vocab 102,400), its weights drawn on the card for 6 layers: the
    eager trainer on 3 (1 dense, 2 MoE), bf16, 2 x 4096 tokens, 8 GiB
    against ~20 GB of model data, the engine's own chunk (it holds one
    [64, 2048, 1408] expert tensor), a warm-up step, 1 step (2 before
    whisper's phases joined) and a profiled one, K2 by head-dim pair and
    K1 as planned, the peak against
    a limit that counts one layer's MoE intermediates and the dense
    layer's MLP; the eager and the compiled engine on all 6 under 8 GiB
    (counters equal, K2 as planned: MLA prefills at (192, 128) and decodes
    without K2, so the decode graph holds the dense layer's one call),
    and the compiled engine under the smallest whole GiB that holds the
    param stream and the KV;
9e. dsv2_parity — deepseek-v2-lite at full width, 2 layers (the dense
    one and one MoE layer), fp32: served on the CPU and on the card
    (tokens and counters identical, K2 as planned by pair), then the
    runtime 1 step and the eager trainer 2 steps of 1 x 64 tokens,
    losses within 1e-4 relative, launches as planned by pair;
9f. params_zamba, train_zamba, serve_zamba — zamba2-1.2b at full depth
    and width (38 Mamba2 layers x 2048: 6 units of 6 behind the shared
    attention + MLP block, 32 heads of 128 at 4096 wide, and a 2-layer
    tail; 1.26 B params), its weights drawn on the card: the eager
    trainer, bf16, 2 x 2048 tokens, 4 GiB against ~18 GB of model data,
    a warm-up step, 1 step (2 before whisper's phases joined) and a
    profiled one, K2 (6 units a pass) and K1 as planned, the peak against
    a limit that counts a unit's saved
    SSD intermediates; the eager and the compiled engine (prefill cohorts
    of one: counters equal) under 2 GiB and under the smallest whole GiB
    that holds the param stream and the caches, prompts 512/512/500/500,
    8 new tokens (16 before whisper's phases joined), K2 as planned (6 a
    prefill, 6 a sequence a decoded token eagerly, 6 a graph replay);
    then, from the same draw, rt_zamba_tp — the runtime at full depth and
    width on the simulated model axis, bf16, dp 2 x tp 2, 4 x 2048
    tokens (2 x 2048 a data rank), full remat, ``xent_block=256``, the
    optimizer state on the card, 3 steps: launches against the plan (K2
    on each rank's 16 heads), the loss finite, the peak under a limit
    from the layout and a unit's recompute; tokens/s, the FWD+BWD / ADAM
    split, the third step profiled — and serve_ssm_tp at tp 4 against
    tp 1 (serve_tp's checks, 23c: 4 prompts of 512 tokens, 8 greedy
    tokens, bf16 and the fp32 prefill);
9g. zamba_parity — zamba2-1.2b at full width, 8 layers (one unit and the
    tail), fp32: eager and compiled serving on the CPU and the card
    (tokens and counters identical), the runtime 1 step and the eager
    trainer 2 steps of 1 x 128 tokens, losses within 1e-5 relative, and
    the shared block's step-1 gradient equal CPU against card and not
    zero;
9h. params_xlstm, train_xlstm, serve_xlstm — xlstm-1.3b at full width
    (48 layers x 2048: 6 units of 7 mLSTM + 1 sLSTM, d_inner 4096, 4
    heads of 1024, vocab 50304; 3.70 B params as the reference builds
    it), its weights drawn on the card: the eager trainer on 1 unit,
    bf16, 2 x 512 tokens, 4 GiB against ~9.6 GB of model data, a warm-up
    step, 1 step (2 before whisper's phases joined) and a profiled one, K1
    as planned and K2 never, the
    peak against a limit that counts a unit's scan tape; the eager and
    the compiled engine (prefill cohorts of one: counters equal) at 2
    units under the smallest whole GiB that holds the fp32 stream and
    every sequence's state, and again under the smallest whole GiB at
    the eager engine's floor (4 GiB, below their stream), prompts
    512/512/500/500, 8 new tokens (16 before whisper's phases joined), K2
    never; then, from the same draw, serve_ssm_tp at tp 2 against tp 1
    (serve_tp's checks, 23c: 4 prompts of 512 tokens, 8 greedy tokens,
    bf16 and the fp32 prefill);
9i. xlstm_parity — xlstm-1.3b at full width, one mLSTM and one sLSTM
    layer, fp32: eager and compiled serving on the CPU and the card
    (tokens and counters identical; a ragged prompt), the runtime 1 step
    (2 before whisper's phases joined) and the eager trainer 2 steps of 1
    x 128 tokens, losses within 1e-6 relative, K1 as planned and K2
    never;
9j. params_whisper, train_whisper, rt_whisper, serve_whisper —
    whisper-large-v3 at full depth and width (32 encoder + 32 decoder
    layers x 1280, 20 heads of 64, d_ff 5120, vocab 51866; 1.54 B
    params), its weights drawn on the card: the eager trainer, bf16, 4 x
    1500 tokens over 1500 frames each (Whisper's 30 s window), 8 GiB
    against ~25 GB of model data, a warm-up step, 1 step and a profiled
    one, K2 (96 calls a pass: one an encoder layer, two a decoder layer)
    and K1 as planned, the peak against a limit that counts a layer's
    MLP and the cross-attention's k/v; the runtime at full depth (bf16
    stores, half the optimizer state on the host) 2 steps, launches as
    planned; the runtime's prefill of 4 x (1500 frames + 432 tokens) and
    16 greedy decode steps over a 448-position horizon from the untrained
    weights, K2 as planned (96 ``tc`` calls a prefill, 64 ``splitkv``
    calls a decode step: the self cache and the 1500-row cross cache), one
    decode step profiled;
9k. whisper_parity — whisper-large-v3 at full width, 2 encoder + 2
    decoder layers, fp32, CPU against card: the runtime 1 step and the
    eager trainer 2 steps of 1 x 200 tokens over 200 frames (losses
    within 1e-4 relative, the trainer's counters identical, launches as
    planned, the first update's stem gradient equal within 1e-4 of each
    leaf's largest), then the runtime's prefill of 2 x (1500 frames + 64
    tokens) and 8 decode steps (tokens identical, logits within 1e-4, K2
    as planned);
9l. nemotron_kernels (after vlm_kernels), params_nemotron and
    serve_nemotron (after the kernel phases, ahead of the other
    full-width models), nemotron_parity (after phi3v_parity) —
    nemotron-4-340b: K2 at (D, Dv) = (192, 192), 96 heads over 8 kv
    heads, in every schedule against the plain version (one kv head's
    query heads at a time at the training shape, 1 x 4096), SDPA and
    ptxas's registers; its serving plan at full width (8 GiB chunks, the
    depth: 2 of 96 layers, 3 before the dry-run's phase joined, unless
    the host's pinned tier or the card's compiled stores beside the
    budget do not fit, then fewer); the eager
    and the compiled engine at full width under a budget that pages the
    fp32 stream every round, 4 prompts of 500-512 tokens and 4 new tokens
    (8 before; counters equal, K2 as planned, prefill tokens equal); its
    structure at 12 heads of 192 over one kv head, 2304 wide, 2 layers,
    fp32, CPU against card (the runtime, the eager trainer with the
    untied head's gradient, the serving steps);
10. parity — serving: gpt2-paper-1b at full width, 2 layers, fp32, the same
   weights served on the CPU (plain attention) and on the card (the
   kernel) under a device budget that pages chunks: greedy tokens and
   every per-round memory counter must be identical, K2 launched as
   planned;
11. slice — serving: gpt2-paper-1b at full depth and width, bf16 compute,
   under a 2 GiB device budget: 4 requests (prompts 512, 512, 500, 500)
   for 16 new tokens each.  Launch counts are zeroed just before
   ``run()`` and read just after; K2 must have run exactly as often as
   the plan implies, and ``torch.cuda.max_memory_allocated`` must stay
   within the budget plus the stem plus 1 GiB of activations;
12. compiled_parity — the compiled serving plane (``CompiledServingEngine``:
   the round's decode one CUDA graph per padded slot count) on parity's
   configuration: eager and compiled, on the CPU and on the card,
   identical tokens; each engine's per-round counters identical on both
   devices; the compiled counters equal an eager run one sequence a
   decode call (the replay pins one kv page at a time); one graph at 2
   slots; K2 calls (eager launches + replays x the calls captured in the
   graph) as planned;
13. compiled_slice — the slice's configuration served by the compiled
   engine, under the slice's 2 GiB and under 8 GiB (the whole param
   stream and every sequence's KV fit): at 2 GiB the counters equal an
   eager run one sequence a decode call exactly (and are compared with
   the eager slice's), prefill tokens equal the eager slice's (decode
   tokens compared and reported), K2 calls 20 x (2 cohorts + 15 decode
   rounds) = 340, one graph at 4 slots, the peak within budget + stem +
   bf16 stores + slot caches + 1 GiB; at 8 GiB the same beside the eager
   engine at that budget; per round the host-clock wall split into
   decode, prefill and pool replay, each replay's device time, prefill
   and decode tokens/s; one profiled decode round each, whose split-kv
   kernels must equal the graph's K2 calls;
14. train_parity — training: gpt2-paper-1b at full width, 2 layers, fp32,
   batch 2 x 128, 2 steps (4 before xlstm's phases joined, 3 before
   whisper's), under a device budget that pages param chunks
   and places one optimizer group on the device: the same weights train
   on the CPU (plain versions) and on the card (the kernels); per-step
   losses agree to 1e-4 relative and every per-step memory counter is
   identical; K1 ran once per device-placed chunk per post-warm-up step,
   and K2 (fp32: forward and backward ``tf32x3``) exactly as planned; the
   card's per-step FWD, BWD and ADAM seconds (the engine's step metrics);
15. train_slice — training: gpt2-paper-1b at full depth and width, bf16
   compute, batch 8 x 1024, 3 steps, under an 8 GiB device budget (below
   the 16.1 GB of fp32 model data): optimizer groups on both the device
   and the host, bytes moving both ways every post-warm-up step, the
   launch counts of K2 forward, K2 backward and K1 exactly as planned,
   finite losses, and ``torch.cuda.max_memory_allocated`` within the
   budget plus the stem (param, grad, moments) plus the head's fp32
   logits and their gradient plus 1 GiB;
16. dist_parity — the rank-parallel plane (two ranks simulated on the
    card, chunked ZeRO): gpt2-paper-1b at full width, 2 layers, fp32,
    global batch 4 x 128, 2 steps (4 before xlstm's phases joined, 3
    before whisper's), under a per-rank budget that pages
    chunks: the same weights train on the CPU and on the card; per-step
    losses agree to 1e-4 relative, every per-rank counter and ledger is
    identical (collective bytes, h2d/d2h, evictions, prefetch hits and
    misses), the chunked volume is exactly 3 (p-1) x groups x chunk bytes,
    launches are as planned, and one rank on the whole batch is within
    1e-4 of the two; then the serving fleet (two ranks) gives the same
    greedy tokens on the CPU, on the card and from one ServingEngine, with
    zero collective bytes;
17. dist_slice — the rank-parallel plane at full size: gpt2-paper-1b, 20
    layers, bf16 compute, two ranks of 4 x 1024 (global 8 x 1024), 2
    steps (3 before whisper's phases joined), a 6 GiB budget per rank (each owns 8.55 GB of model data), OPT,
    prefetch, gather prefetch (lookahead 2), the act stream and placement:
    per step the loss, tokens/s, each rank's FWD/BWD/ADAM seconds, the
    collective bytes (counts of the ledger: the copies between ranks run on
    one card, so no link time is measured), each rank's h2d/d2h and hits,
    and each rank's K2 and K1 launches against the plan; the exact volume
    every step, hidden gathers after the warm-up, the peak within a limit
    computed before the run; then one profiled step's device time by kind,
    the gathers and the reduce-scatter sums as their own kinds;
18. rt_parity — the chunked-ZeRO runtime (``repro_torch.runtime``):
    gpt2-paper-1b at full width, 1 layer, batch 2 x 128, 2 steps, half
    the optimizer groups on the host, weight decay 0.1, the blockwise head
    (``xent_block=64``), fp32 and bf16 at dp 2 (fp32 at dp 1 too before
    whisper's phases joined): the same
    weights train on the CPU and on the card; per-step losses within 1e-4
    relative in
    fp32 and 2e-2 in bf16, the collective counts identical, the host
    part's bytes each way equal to 12 B x its elements, K2 and K1
    launched as planned; then on the card (fp32, dp 2) a checkpoint saved
    after step 1 and restored into a fresh runtime, whose step 2 and
    final stores equal the uninterrupted run's exactly;
19. rt_slice — the runtime at full depth and width: gpt2-paper-1b, bf16,
    dp 1, batch 8 x 1024, full remat, per-layer gather, half the
    optimizer groups on the host, ``xent_block=256``, weight decay 0.1, 3
    steps: per step the loss, tokens/s, FWD+BWD and ADAM seconds, the
    host part's h2d/d2h bytes (12 B x its elements each way), K2 forward,
    K2 backward and K1 launches against the plan; the peak of
    ``max_memory_allocated`` under a limit computed from the layout
    before the run; then one profiled step's device time by kind (the
    layers' bf16 GEMMs apart from the head's fp32 ones) and idle share;
20. timeline_parity — the transfer timeline on the CPU and on the card,
    on the same fixed lanes (``TransferTimeline.calibrated()``, the
    recorded H100 rates): the trainer (train_parity's configuration, 2
    steps) with bandwidth-aware prefetch on and off, serving (parity's)
    managed and with ``manage_kv=False``, and the two-rank trainer with
    ``timeline_factory=``: every StepTimeline field of every step, round
    and rank identical, every counter identical, losses within 1e-4
    relative, tokens identical, managed and unmanaged alike;
21. timeline_slice — train_slice's configuration (gpt2-paper-1b, bf16,
    8 x 1024, 8 GiB against 17.1 GB of model data) on
    ``TransferTimeline.calibrated(hw)`` with the rates ``link`` measured,
    bandwidth-aware prefetch on, then off, a warm-up step and 1 step
    each (2 before xlstm's phases joined): per step the loss, host-clock
    wall and tokens/s, FWD/BWD/ADAM
    seconds, the bytes, hidden and critical h2d, hits and misses, the
    modelled compute, stalls and wall, the peak; the warm-up's bytes
    equal on and off and no more bytes aware than fixed after it (each
    way), identical losses, wall == compute + stall (1e-9), hidden +
    critical == h2d, launches as planned; the aware/fixed ratio of the
    modelled stall and of the measured wall, and measured over modelled;
22. cotenancy — one pool of 9 GiB on the card hosting qwen3-0.6b served
    at full width (28 x 1024, GQA 16/8, vocab 151,936, bf16; priority
    10, a 1 GiB device soft budget, a host budget of its param stream
    plus the burst's KV; 4 prompts of 500-512 tokens, 4 new tokens each,
    128-token pages) beside gpt2-paper-1b training (train_slice's, an
    8 GiB share, no budget; a warm-up step and 1 step, 2 before xlstm's
    phases joined), OPT and the
    calibrated timeline, against each alone on a private pool of its
    share (the host pool: both solo host peaks plus 1 GiB): co-resident
    tokens equal solo, the serve tenant within its budgets every round,
    no serve chunk evicted for the trainer, co-resident losses equal
    solo, launches as planned, the peak within the pool plus both stems,
    the logits and 1 GiB; the modelled and measured latency and
    throughput ratios, reported; then the fleet pairing
    (``cotenancy_fleets``): a 2-rank qwen3-0.6b serving fleet (8 layers,
    4 prompts of 250-256 tokens, 2 new tokens) and a 2-rank gpt2-paper-1b
    trainer (4 layers, 4 x 512, 2 steps) as tenants of per-rank shared
    pools, against each fleet alone: tokens and losses equal solo, the
    serve budgets held on every rank every round, no serve chunk evicted
    for the trainer on any rank;
23. zoo_parity — gpt2-paper-4b (D=144), qwen2.5-3b (GQA 16/2, QKV
    bias) and deepseek-7b at full width, 2 layers, fp32, served by the
    eager engine on the CPU and on the card (two prompts, 2 new tokens (4
    before the tensor-parallel phases joined), a
    budget that pages): tokens and per-round counters identical, K2 as
    planned; then gpt2-paper-4b trained 2 steps (3 before whisper's
    phases joined) as in train_parity (``tf32x3`` at D=144 inside a
    model);
23a. tp_parity — tensor parallelism on the simulated model axis
    (``repro_torch.models.tp``): qwen2.5-3b at full width (16 heads of
    128 over 2 kv heads, vocab 151,936), 2 of 36 layers, fp32, through
    the runtime at tp = 1, 2 and 4 from one set of global weights: the
    first batch's gradients, every leaf within 2e-4 of its largest tp = 1
    value (the CPU tests' rule), before ADAM; 2 steps of 2 x 256 tokens,
    losses within 1e-5 relative of tp = 1's, the fp32 master weights
    reassembled from the shards as the CPU tests hold stores, the
    replicated leaves' copies (gradients too) bitwise equal across ranks;
    then 2 x 128 prompts and 8 greedy tokens identical across tp (tp = 4
    decodes through the "dist" cache); K2 and K1 launched as planned (one
    call a model rank);
23b. params_tp (qwen2.5-3b's weights at full size, drawn on the card once
    for the next two), rt_tp — the runtime at full depth and width on
    qwen2.5-3b, bf16, dp
    2 x tp 2, 8 x 1024 tokens, full remat, ``xent_block=256``, the
    optimizer state on the card, 3 steps: launches against the plan, the
    loss finite, the peak under a limit from the layout; tokens/s, the
    FWD+BWD / ADAM split, the third step's idle share (profiled); then
    dryrun_check: the dry-run (``repro_torch.launch.dryrun``) of rt_tp's
    configuration on the meta device, every rank, no card work: its K2
    forward and backward calls and its K1 calls equal rt_tp's launches a
    step, its simulated peak within 10% of rt_tp's measured
    ``max_memory_allocated`` (less what was allocated before), and one
    production record (qwen2.5-3b train_4k at 16 x 16) with its trace
    time;
23c. serve_tp — qwen2.5-3b at full depth and width, bf16, served through
    the runtime's prefill and decode steps at tp = 4 ("dist" cache) and at
    tp = 1 on the same weights: 4 prompts of 512 tokens, 16 greedy
    tokens; the same prefill in fp32 at both tp, its logits at tp = 4
    within 1e-4 of tp = 1's largest; each bf16 run held element by
    element against the fp32 tp = 1 logits, tp = 4's RMS deviation at
    most twice tp = 1's; the residual stream's gap between the tp after
    every layer, both dtypes; the tokens beside tp = 1's with their first
    difference, K2 as planned (the "dist" decode's partial attention is
    the reference's plain product), prefill and decode tokens/s, the
    cache bytes a rank;
23d. ssm_tp_parity — the SSM layers on the simulated model axis:
    zamba2-1.2b at full width, 8 layers (one unit and the tail), and
    xlstm-1.3b at full width, one unit of 6 (7 mLSTM + 1 sLSTM), fp32,
    each through the runtime at tp = 1, 2 and 4 from one set of global
    weights with tp_parity's shapes and gates (23a);
The parity phases' CPU oracles (``ORACLE_KEYS``: the trainers of zamba,
xlstm, whisper, phi-3-vision, nemotron and deepseek-v2-lite, the
frontend phases' CPU serving, and the CPU engines of parity,
train_parity, dist_parity, rt_parity, timeline_parity and zoo_parity)
run in one spawned process (``Oracles``, ``ORACLE_THREADS``), started
after the build; after serve_4b their weights are drawn on the card, as
each phase draws them (once a config), and a thread writes them under
``build/oracle/`` as numpy arrays for the process; each phase then waits
on its oracle's result.

24. seconds — each phase's wall time (and, apart, the time between
    phases, and that time's parts summed over the phases; each phase's
    own line as it ends); oracle_process — the seconds each phase waited
    on the oracle process and each job took there; host_memory —
    ``MemAvailable`` after each phase (between phases the script collects
    garbage, gives PyTorch's cached pinned blocks back and trims glibc's
    heap);
25. kernels — one line listing every ported kernel with its TPU
    counterpart, schedule, launches on each path (the timeline_slice,
    cotenancy and compiled serving phases' included, with the decode
    graph's replays), error and
    times (K2 forward: training, prefill, decode and fp32; K2 backward:
    bf16 and fp32; fp32 with both bounds, the library's time and the
    launches in train_parity and dist_parity; K1 beside two yardsticks,
    ``torch._fused_adam_`` alone and followed by the copy K1 also makes;
    the launches in rt_parity and rt_slice; K2's rows at (192, 128) and
    the deepseek phases' launches by head-dim pair; K2's rows at
    whisper's shapes and the whisper phases' launches; K2's rows at
    (192, 192) and the nemotron phases' launches; the tensor-parallel
    phases' launches, the SSM ones' by model).

Then the card's name and power limit on a line of their own, and last the
``{"ok": true, "device": ...}`` line.  Any failed check raises, and the
script exits non-zero without that line; so it does when no card is
present or when the script stands alone, without the repository beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (the roofline the bound is taken against)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# dense TF32 on the tensor cores: the fp32 backward's three TF32 products
PEAK_TF32_FLOPS = 494.7e12
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_TOL = 1e-4  # absolute, on K2's fp32 log-sum-exp
# K2's backward, on each of dq, dk and dv: relative Frobenius error
# |g - w| / |w|, which a dropped tile fails even where the largest
# gradient makes the absolute tolerance loose
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
GIB = 1 << 30


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, after
    a warm-up)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_events(prof) -> list:
    """``(name, start_us, end_us)`` of each device event (kernels, copies)
    of a profiled span: the device events ``prof.events()`` lists, with
    its names and times, read straight from the profiler's results.
    ``prof.events()`` first builds every host event and their tree: the
    ~280,000 kernels of an xlstm training step took ~50 s of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    cached = getattr(prof, "_device_events", None)
    if cached is not None:
        return cached
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names, out = {}, []
    for ev in res.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        hidden = getattr(ev, "is_hidden_event", None)
        raw = ev.name()
        if (hidden is not None and hidden()) or _filter_name(raw):
            continue
        name = names.get(raw)
        if name is None:  # the profiler's own demangled name
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 \
                else raw
        out.append((name, (ev.start_ns() - t0) / 1000,
                    (ev.end_ns() - t0) / 1000))
    prof._device_events = out
    return out


def kernel_names(fn, iters: int = 1) -> dict:
    """Device ms per call of ``fn`` of each kernel it runs, by the
    profiler's kernel name, longest first: the profiler's kernel durations
    over ``iters`` calls, summed and divided."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    # the lean reader against the profiler's own events, on this span's
    # few events (the long spans are why the reader exists)
    want = [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    if sorted(events) != sorted(want):
        raise AssertionError(f"device_events read {len(events)} device "
                             f"events, prof.events() lists {len(want)}")
    by_name = {}
    for name, start, end in events:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3 / iters
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def device_ms(fn, iters: int = 5) -> float:
    """Device time of one call of ``fn``, all its kernels, averaged over
    ``iters`` calls.  Unlike :func:`time_ms` it leaves out the host's
    time between launches, which bounds a call whose kernels are shorter
    than the wrapper's own host work.  Five calls by default (twenty
    before whisper's phases joined: the profiler's event processing, not
    the kernels, took most of the kernel phases' time)."""
    return sum(kernel_names(fn, iters).values())


def time_pair(kernel, library, iters: int = 20):
    """A kernel and its yardstick timed in turns, kernel, library, library,
    kernel, in one call: (kernel ms, library ms, the four times)."""
    k1 = time_ms(kernel, iters)
    l1 = time_ms(library, iters)
    l2 = time_ms(library, iters)
    k2 = time_ms(kernel, iters)
    return (k1 + k2) / 2, (l1 + l2) / 2, [k1, l1, l2, k2]


# --------------------------------------------------------------- kernel phase
def attention_bound(case) -> dict:
    """Least time for the work on this run's data: each input byte the
    masks let through read once, the output written once, each tensor at
    its own head dim (q and k at D, v and the output at Dv, ``case["dv"]``,
    D when absent); 2*(D + Dv) flops per visible (query, key) pair per
    head (S = Q K^T and P V).  In fp32 the operations take the lesser of
    two times: on the FMA pipes, or as three TF32 products on the tensor
    cores (what the ``tf32x3`` schedule runs); both are kept.  Returns
    bytes, flops and the bound (ms, what bounds it)."""
    from repro_torch.kernels.flash_attention import forward_work

    b, sq, sk, h, kv, d = case["shape"]
    item = 2 if case["dtype"] == "bfloat16" else 4
    # the count the dry-run's meta K2 calls add up (one shared formula)
    work = forward_work(b, sq, sk, h, kv, d, case.get("dv", d), item,
                        causal=case["causal"],
                        q_offset=case.get("q_offset", 0),
                        kv_len=case.get("kv_len") or sk,
                        window=case.get("window"),
                        kv_lens=case.get("kv_lens"))
    nbytes, flops = work["bytes"], work["flops"]
    out = dict(bytes=nbytes, flops=flops,
               bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    t_ops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
    if case["dtype"] == "float32":
        out["fma_bound_ms"] = t_ops
        out["tf32x3_bound_ms"] = 3 * flops / PEAK_TF32_FLOPS * 1e3
        t_ops = min(t_ops, out["tf32x3_bound_ms"])
    if out["bytes_ms"] >= t_ops:
        return dict(out, bound_ms=out["bytes_ms"], bound_by="bytes")
    return dict(out, bound_ms=t_ops, bound_by="operations")


KERNEL_CASES = [
    # the slice's prefill cohorts (B=2, S=512 and ragged 500, H=16, D=128)
    dict(name="prefill_512", shape=(2, 512, 512, 16, 16, 128), causal=True),
    dict(name="prefill_500", shape=(2, 500, 500, 16, 16, 128), causal=True),
    # the slice's decode batches: one query over a 1024-slot cache
    dict(name="decode_kv1", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=0, kv_len=1),
    dict(name="decode_kv37", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=36, kv_len=37),
    dict(name="decode_kv1024", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=1023, kv_len=1024),
    # decode: GQA, and kv_len at a 64-row split boundary and one past it
    dict(name="decode_gqa", shape=(4, 1, 1024, 16, 8, 128), causal=True,
         q_offset=1023, kv_len=1024),
    dict(name="decode_kv64", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=63, kv_len=64),
    dict(name="decode_kv65", shape=(4, 1, 1024, 16, 16, 128), causal=True,
         q_offset=64, kv_len=65),
    # prefill with kv_len < Sk, and a sliding window
    dict(name="prefill_kvlen", shape=(2, 500, 512, 16, 16, 128),
         causal=True, kv_len=480),
    dict(name="prefill_window", shape=(2, 512, 512, 16, 16, 128),
         causal=True, window=128),
    # GQA and the small head dim
    dict(name="prefill_gqa", shape=(2, 512, 512, 16, 8, 128), causal=True),
    dict(name="prefill_d32", shape=(2, 256, 256, 16, 16, 32), causal=True),
    # the training slice's shape (FWD and the BWD recompute)
    dict(name="train", shape=(8, 1024, 1024, 16, 16, 128), causal=True),
    # a long row: the accumulators' drift over 4096 keys
    dict(name="long_4096", shape=(1, 4096, 4096, 16, 16, 128), causal=True),
    # gpt2-paper-4b (16 heads x 144): its training shape, the serving
    # slice's prefill cohort and decode batch; qwen2.5-3b's decode (GQA
    # 16/2, 8 query heads a kv head)
    dict(name="train_d144", shape=(8, 1024, 1024, 16, 16, 144), causal=True),
    dict(name="prefill_d144", shape=(2, 512, 512, 16, 16, 144), causal=True),
    dict(name="decode_d144", shape=(4, 1, 1024, 16, 16, 144), causal=True,
         q_offset=1023, kv_len=1024),
    dict(name="decode_gqa8", shape=(4, 1, 1024, 16, 2, 128), causal=True,
         q_offset=1023, kv_len=1024),
    # zamba2-1.2b's shared block (32 heads x 128 at 2 x d_model): its
    # training shape and the serving slice's decode
    dict(name="train_zamba", shape=(2, 2048, 2048, 32, 32, 128),
         causal=True),
    dict(name="decode_zamba", shape=(4, 1, 1024, 32, 32, 128), causal=True,
         q_offset=1023, kv_len=1024),
    # the shared block on one model rank of rt_zamba_tp (tp 2: 16 heads)
    dict(name="train_zamba_tp", shape=(2, 2048, 2048, 16, 16, 128),
         causal=True),
]


def kernel_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_splitkv_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for base in KERNEL_CASES:
        for dtype in ("bfloat16", "float32"):
            case = dict(base, dtype=dtype)
            b, sq, sk, h, kv, d = case["shape"]
            dt = getattr(torch, dtype)
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
            kw = {key: case[key] for key in ("causal", "q_offset", "kv_len",
                                             "window") if key in case}
            plan = fa.plan_forward(b, sq, sk, h, dt, **kw)
            # serving's launch (no lse) and training's (with it)
            got = fa.flash_attention_cuda(q, k, v, **kw)
            got_l, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
            want, want_lse = fa.plain(q, k, v, return_lse=True, **kw)
            split_err = None
            if plan.schedule == "splitkv":
                # the combine kernel against the same splits merged in
                # plain PyTorch
                s_want, s_lse = flash_attention_splitkv_ref(
                    q, k, v, splits=plan.splits, split_lo=plan.split_lo,
                    split_rows=plan.split_rows, return_lse=True, **kw)
                split_err = max((got_l.float() - s_want.float()).abs().max()
                                .item(), (lse - s_lse).abs().max().item())
            torch.cuda.synchronize()
            err = max((x.float() - want.float()).abs().max().item()
                      for x in (got, got_l))
            rel_err = max(((x.float() - want.float()).norm()
                           / want.float().norm()).item() for x in (got, got_l))
            lse_err = (lse - want_lse).abs().max().item()
            if not (math.isfinite(err) and err <= TOL[dtype]
                    and math.isfinite(lse_err) and lse_err <= LSE_TOL
                    and (split_err is None or split_err <= TOL[dtype])):
                raise AssertionError(f"K2 {case['name']} {dtype} "
                                     f"({plan.schedule}): max abs error "
                                     f"{err} (tol {TOL[dtype]}), lse "
                                     f"{lse_err} (tol {LSE_TOL}), against "
                                     f"the split arithmetic {split_err}")
            # the yardstick: one library call on the same inputs, [B,H,S,D]
            kvl = kw.get("kv_len", sk)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kvl],
                                                       v[:, :kvl]))
            mask = None
            if "window" in kw or (sq > 1 and "q_offset" in kw):
                from repro_torch.kernels.ref import _visible

                mask = _visible(sq, kvl, q.device, causal=True,
                                q_offset=kw.get("q_offset", 0), kv_len=kvl,
                                window=kw.get("window"))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask,
                is_causal=mask is None and sq > 1, enable_gqa=kv != h)
            ms, library_ms, turns = time_pair(
                lambda: fa.flash_attention_cuda(q, k, v, **kw), lib)
            dev_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
            # the library's device time where the host's launch time
            # dominates the call (decode); the plain version's time over 3
            # calls (20 and every row before phi-3-vision's phases joined,
            # for the time limit)
            library_dev_ms = device_ms(lib) if sq < 16 else None
            plain_ms = time_ms(lambda: fa.plain(q, k, v, **kw), 3)
            bound = attention_bound(case)
            row = dict(case=case["name"], dtype=dtype, shape=case["shape"],
                       schedule=plan.schedule,
                       splits=plan.splits if plan.schedule == "splitkv"
                       else None, max_abs_err=err, tol=TOL[dtype],
                       rel_err=rel_err, lse_max_abs_err=lse_err,
                       lse_tol=LSE_TOL, split_ref_max_abs_err=split_err,
                       ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       library_device_ms=library_dev_ms,
                       times_kernel_lib_lib_kernel=turns,
                       tflops=bound["flops"] / (ms * 1e-3) / 1e12, **bound)
            emit({"phase": "kernel", "kernel": "flash_attention_fwd", **row})
            results[(case["name"], dtype)] = row
            del q, k, v, got, got_l, lse, want, want_lse
    emit(long_rows("flash_attention_fwd", results,
                   ("max_abs_err", "rel_err", "lse_max_abs_err")))
    for dtype in BOTH:
        results[("decode_kvlens", dtype)] = kv_lens_row(dtype, gen)
        results[("decode_kvlens_d144", dtype)] = kv_lens_row(dtype, gen,
                                                             d=144)
    return results


# the compiled serving round's decode: 8 slots, each at its own length
# over a 1024-row horizon (one visible key, a split boundary and one past
# it, the prompts' lengths, the full horizon); then other lengths, to
# replay a captured graph after they change
KV_LENS = (1, 37, 64, 65, 500, 512, 1023, 1024)
KV_LENS_NEXT = (2, 1024, 63, 1, 700, 129, 64, 999)


def kv_lens_row(dtype: str, gen, d: int = 128, h: int = 16,
                phase: str = "kernel", kv: int | None = None) -> dict:
    """K2's decode with per-row lengths read from the card (``kv_lens``,
    splits planned over the whole horizon): against the plain version and
    the same splits merged in plain PyTorch; captured once in a CUDA graph
    and replayed after the lengths change, against the plain version at
    the new lengths; its time (eager call and graph replay) beside the
    plain version's and SDPA's with a boolean mask (a yardstick), its
    device time and its byte bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_splitkv_ref

    b, sk, kv = len(KV_LENS), 1024, kv or h
    dt = getattr(torch, dtype)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, sk, kv, d), generator=gen, device="cuda").to(dt)
    lens = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    kw = dict(causal=False, kv_lens=lens)
    plan = fa.plan_forward(b, 1, sk, h, dt, causal=False)
    got, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want, want_lse = fa.plain(q, k, v, return_lse=True, **kw)
    s_want = flash_attention_splitkv_ref(
        q, k, v, splits=plan.splits, split_lo=plan.split_lo,
        split_rows=plan.split_rows, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    split_err = (got.float() - s_want.float()).abs().max().item()
    # the graph: warm-up on a side stream, capture (which launches
    # nothing), then replays at new lengths and back
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launched, captured = fa.launches, fa.captured
    with torch.cuda.graph(graph):
        out = fa.flash_attention_cuda(q, k, v, **kw)
    if (fa.launches, fa.captured) != (launched, captured + 1):
        raise AssertionError("K2 decode_kvlens: the capture counted as a "
                             "launch, or was not counted as captured")
    graph_err = 0.0
    for lengths in (KV_LENS_NEXT, KV_LENS):
        lens.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        w = fa.plain(q, k, v, **kw)
        graph_err = max(graph_err,
                        (out.float() - w.float()).abs().max().item())
    if not all(math.isfinite(x) and x <= TOL[dtype]
               for x in (err, split_err, graph_err)) or lse_err > LSE_TOL:
        raise AssertionError(f"K2 decode_kvlens D={d} {dtype}: max abs "
                             f"error "
                             f"{err}, against the split arithmetic "
                             f"{split_err}, after a graph replay at new "
                             f"lengths {graph_err} (tol {TOL[dtype]}), lse "
                             f"{lse_err} (tol {LSE_TOL})")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = (torch.arange(sk, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=kv != h)
    call = lambda: fa.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
    ms, library_ms, turns = time_pair(call, lib)
    graph_ms = time_ms(graph.replay)
    bound = attention_bound(dict(shape=(b, 1, sk, h, kv, d), dtype=dtype,
                                 causal=False, kv_lens=KV_LENS))
    row = dict(case="decode_kvlens" + ("" if d == 128 else f"_d{d}"),
               dtype=dtype, shape=(b, 1, sk, h, kv, d),
               kv_lens=list(KV_LENS), replayed_at=list(KV_LENS_NEXT),
               schedule=plan.schedule, splits=plan.splits,
               max_abs_err=err, tol=TOL[dtype], lse_max_abs_err=lse_err,
               split_ref_max_abs_err=split_err,
               graph_replay_max_abs_err=graph_err, ms=ms,
               graph_replay_ms=graph_ms, device_ms=device_ms(call),
               plain_ms=time_ms(lambda: fa.plain(q, k, v, **kw), 3),
               library_ms=library_ms, library_device_ms=device_ms(lib),
               times_kernel_lib_lib_kernel=turns,
               tflops=bound["flops"] / (ms * 1e-3) / 1e12, **bound)
    emit({"phase": phase, "kernel": "flash_attention_fwd", **row})
    del graph, out
    return row


def long_rows(kernel: str, results: dict, keys) -> dict:
    """The long row's errors beside the training shape's, per dtype."""
    return {"phase": "kernel", "kernel": f"{kernel}_long_rows",
            **{f"{dtype}_{name}": {key: results[(name, dtype)][key]
                                   for key in keys}
               for dtype in BOTH for name in ("train", "long_4096")}}


# ------------------------------------------------------------ K1 (ADAM)
ADAM_HP = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-8, bias_corr1=0.1,
               bias_corr2=0.05)


def chunk_plan(cfg, nproc: int = 1, chunk_size: int | None = None):
    """The trainer's chunk map for ``cfg`` over ``nproc`` ranks, from one
    layer's shapes of each block group, the groups in order: the engine's
    own naming and chunk-size search (or ``chunk_size`` elements)."""
    import torch

    from repro_torch.configs import model_class
    from repro_torch.core.chunk import (TensorSpec, build_chunk_map,
                                        search_chunk_size)
    from repro_torch.core.serving import _leaves_with_names
    from repro_torch.models.layers import AxisCtx

    specs = []
    for group in model_class(cfg)(cfg, AxisCtx()).groups():
        with torch.device("meta"):  # shapes only
            layer = group.init_layer(torch.Generator())
        specs += [TensorSpec(n, tuple(v.shape)) for i in range(group.length)
                  for n, v in _leaves_with_names(layer,
                                                 f"{group.name}.{i}")]
    size = chunk_size or search_chunk_size(specs, nproc=nproc,
                                           align=256).chunk_size
    return build_chunk_map(specs, size, nproc=nproc)


def adam_phase() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import chunked_adam as ka

    n = chunk_plan(get_config("gpt2-paper-1b")).chunk_size
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        # (name, n, g dtype, out dtype, weight decay, out is g)
        ("fp32", n, "float32", "float32", 0.0, False),
        ("fp32_wd", n, "float32", "float32", 0.1, False),
        ("bf16", n, "bfloat16", "bfloat16", 0.0, False),
        ("bf16_wd", n, "bfloat16", "bfloat16", 0.1, False),
        ("ragged", n - 333, "float32", "float32", 0.1, False),
        # the engine's path: fp32 g is the param payload K1 writes back
        ("path", n, "float32", "float32", 0.0, True),
    ]
    results = {}
    for name, size, gdt, odt, wd, alias in cases:
        hp = dict(ADAM_HP, weight_decay=wd)
        p = torch.randn(size, generator=gen, device="cuda")
        m = torch.randn(size, generator=gen, device="cuda") * 0.01
        v = torch.rand(size, generator=gen, device="cuda") * 0.01
        g = torch.randn(size, generator=gen, device="cuda").to(
            getattr(torch, gdt))
        want = ka.plain(p, m, v, g, **hp)
        out = g if alias else torch.empty(size, device="cuda",
                                          dtype=getattr(torch, odt))
        ka.chunked_adam_triton(p, m, v, g, out, **hp)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip((p, m, v),
                                                             want))
        out_err = (out.float() - want[0]).abs().max().item()
        if odt == "bfloat16":
            # p' rounded to bf16, give or take the fp32 tolerance (which
            # may move a p' that cancels to near 0 by several of its
            # ulps): within 1e-6 + one bf16 ulp of p'.  An output that
            # kept the old params is off by lr |update|, several ulps
            # wherever |p| is small
            _, e = torch.frexp(want[0])
            out_ok = (out.float() - want[0]).abs().le(1e-6 + torch.ldexp(
                torch.ones_like(want[0]), e - 8)).all().item()
            del e
        else:
            out_ok = out_err <= 1e-6
        if not (math.isfinite(err) and err <= 1e-6 and out_ok):
            raise AssertionError(f"K1 {name}: max abs error {err} on p/m/v "
                                 f"(tol 1e-6), {out_err} on the output")
        row = dict(case=name, n=size, g_dtype=gdt, out_dtype=odt, wd=wd,
                   out_aliases_g=alias, max_abs_err=err,
                   out_max_abs_err=out_err)
        if name == "path":
            row["ms"] = time_ms(lambda: ka.chunked_adam_triton(
                p, m, v, g, out, **hp))
            row["plain_ms"] = time_ms(lambda: ka.plain(p, m, v, g, **hp))
            # the yardstick: the fused ADAM behind torch.optim.Adam, on the
            # same fp32 tensors (the port never calls it)
            steps = [torch.ones((), device="cuda")]

            def fused():
                torch._fused_adam_(
                    [p], [g], [m], [v], [], steps, lr=hp["lr"],
                    beta1=hp["beta1"], beta2=hp["beta2"], weight_decay=0.0,
                    eps=hp["eps"], amsgrad=False, maximize=False)

            def fused_copy():
                # K1's whole work: the fused update, then the new params
                # written into the param chunk (here the aliased output)
                fused()
                out.copy_(p)

            row["library_ms"] = time_ms(fused)
            row["library_copy_ms"] = time_ms(fused_copy)
            # _fused_adam_ alone: p, m, v, g read and p, m, v written
            row["library_bytes"] = size * (12 + 4 + 12)
            row["library_bound_ms"] = (row["library_bytes"]
                                       / HBM_BYTES_PER_S * 1e3)
            # the host-placed groups' ADAM: the same update on the CPU, on
            # pinned host tensors (host clock; not a device number)
            from repro_torch.core.engine import host_adam

            hp32, hm, hv, hg = (t.cpu().pin_memory() for t in (p, m, v, g))
            host_adam(hg, hp32, hm, hv, **{k: hp[k] for k in (
                "lr", "beta1", "beta2", "eps", "bias_corr1", "bias_corr2")})
            h0 = time.perf_counter()
            for _ in range(3):
                host_adam(hg, hp32, hm, hv, **{k: hp[k] for k in (
                    "lr", "beta1", "beta2", "eps", "bias_corr1",
                    "bias_corr2")})
            row["host_adam_ms"] = (time.perf_counter() - h0) / 3 * 1e3
            del hp32, hm, hv, hg
            # each element: p, m, v, g read, p, m, v and the output written
            # (the count the dry-run's meta K1 calls add up)
            row["bytes"] = ka.work(size, g.element_size(),
                                   out.element_size())["bytes"]
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            row["bound_by"] = "bytes"
        emit({"phase": "kernel", "kernel": "chunked_adam", **row})
        results[name] = row
        del p, m, v, g, out, want
    return results


# ------------------------------------------------------- K2's backward
BOTH = ("bfloat16", "float32")
BWD_CASES = [
    dict(name="train", shape=(8, 1024, 16, 16, 128), causal=True,
         dtypes=BOTH),
    dict(name="gqa", shape=(8, 1024, 16, 8, 128), causal=True, dtypes=BOTH),
    dict(name="d64", shape=(8, 1024, 16, 16, 64), causal=True, dtypes=BOTH),
    dict(name="ragged", shape=(8, 1000, 16, 16, 128), causal=True,
         dtypes=BOTH),
    # the other mask the backward takes, at the small head dim, ragged, GQA
    dict(name="d32_unmasked", shape=(4, 777, 16, 8, 32), causal=False,
         dtypes=("float32",)),
    # a long row: the accumulators' drift over 4096 rows
    dict(name="long_4096", shape=(1, 4096, 16, 16, 128), causal=True,
         dtypes=BOTH),
    # gpt2-paper-4b's training shape (16 heads x 144)
    dict(name="train_d144", shape=(8, 1024, 16, 16, 144), causal=True,
         dtypes=BOTH),
    # zamba2-1.2b's shared block in training (32 heads x 128)
    dict(name="train_zamba", shape=(2, 2048, 32, 32, 128), causal=True,
         dtypes=("bfloat16",)),
    # ... and on one model rank of rt_zamba_tp (tp 2: 16 heads)
    dict(name="train_zamba_tp", shape=(2, 2048, 16, 16, 128), causal=True,
         dtypes=("bfloat16",)),
]


def attention_bwd_bound(shape, dtype, causal=True, window=None,
                        dv=None, sk=None) -> dict:
    """Bytes, flops and the least time for the backward: q, k, v, o, dO,
    dQ, dK, dV once each, each at its own head dim (q, k, dQ, dK at D; v,
    o, dO, dV at ``dv``, D when None), plus lse and delta; five products
    per visible (query, key) pair per head (the pairs the causal mask and
    the ``window`` let through): S recomputed from the lse, dK and dQ at
    2*D flops each, dP and dV at 2*Dv, 2*(3 D + 2 Dv) in all (10*D where
    Dv = D).  ``sk``: the key rows where they differ from the query rows
    (unmasked cross-attention), S when None.  In fp32 the operations take
    the lesser of two times: on the FMA pipes, or as three TF32 products
    on the tensor cores (what the ``tf32x3`` schedule runs); both are
    kept."""
    from repro_torch.kernels.flash_attention import backward_work

    b, s, h, kv, d = shape
    item = 2 if dtype == "bfloat16" else 4
    # query i sees keys j <= i (causal) and j > i - window; the count the
    # dry-run's meta K2 backward calls add up (one shared formula)
    work = backward_work(b, s, h, kv, d, d if dv is None else dv, item,
                         causal=causal, window=window, sk=sk)
    nbytes, flops = work["bytes"], work["flops"]
    out = dict(bytes=nbytes, flops=flops,
               bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    ops_by = "operations"
    if dtype == "float32":
        out["fma_bound_ms"] = t_ops
        out["tf32x3_bound_ms"] = 3 * flops / PEAK_TF32_FLOPS * 1e3
        if out["tf32x3_bound_ms"] < t_ops:
            t_ops, ops_by = out["tf32x3_bound_ms"], \
                "operations, 3xTF32 on tensor cores"
    if out["bytes_ms"] >= t_ops:
        return dict(out, bound_ms=out["bytes_ms"], bound_by="bytes")
    return dict(out, bound_ms=t_ops, bound_by="operations",
                bound_note=ops_by)


def attention_bwd_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for case in BWD_CASES:
        b, s, h, kv, d = case["shape"]
        causal = case["causal"]
        for dtype in case["dtypes"]:
            dt = getattr(torch, dtype)
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(dt)
            do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
            # the forward's output and lse against the plain forward's
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
            o_ref, lse_ref = fa.plain(q, k, v, causal=causal,
                                      return_lse=True)
            o_err = (o.float() - o_ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            if not (math.isfinite(o_err) and o_err <= TOL[dtype]
                    and math.isfinite(lse_err) and lse_err <= LSE_TOL):
                raise AssertionError(f"K2 fwd (lse) {case['name']} {dtype}: "
                                     f"output error {o_err} (tol "
                                     f"{TOL[dtype]}), lse {lse_err} (tol "
                                     f"{LSE_TOL})")
            # the plain backward reads only the plain forward's numbers
            want = fa.plain_bwd(q, k, v, o_ref, lse_ref, do, causal=causal)
            del o_ref, lse_ref
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                              causal=causal)
            # the route of every BWD recompute: K2 with its lse, then the
            # backward, through the autograd function
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            got_ag = torch.autograd.grad(
                ops.flash_attention(*leaves, causal=causal), leaves, do)
            del leaves
            torch.cuda.synchronize()
            # each gradient against its own: the absolute error within
            # TOL x its largest value (at least 1), and the relative
            # Frobenius error within REL_TOL
            grads = {}
            for name, g, g_ag, w in zip(("dq", "dk", "dv"), got, got_ag,
                                        want):
                w = w.float()
                tol = TOL[dtype] * max(1.0, w.abs().max().item())
                norm = w.norm().item()
                errs = [((x.float() - w).abs().max().item(),
                         (x.float() - w).norm().item() / norm)
                        for x in (g, g_ag)]
                grads[name] = dict(
                    max_abs_err=errs[0][0], autograd_max_abs_err=errs[1][0],
                    tol=tol, rel_err=errs[0][1],
                    autograd_rel_err=errs[1][1], rel_tol=REL_TOL[dtype],
                    median_abs=w.abs().median().item())
                if not all(math.isfinite(a) and a <= tol and math.isfinite(r)
                           and r <= REL_TOL[dtype] for a, r in errs):
                    raise AssertionError(
                        f"K2 bwd {case['name']} {dtype} {name}: (max abs, "
                        f"relative) error {errs[0]} (wrapper), {errs[1]} "
                        f"(autograd) > ({tol}, {REL_TOL[dtype]}); median "
                        f"|{name}| {grads[name]['median_abs']}")
            err = max(r["max_abs_err"] for r in grads.values())
            ag_err = max(r["autograd_max_abs_err"] for r in grads.values())
            del got_ag
            # enough launches for a ~0.4 ms kernel; the fp32 one is longer
            iters = 20 if dtype == "bfloat16" else 5
            # the yardstick: SDPA's backward = (forward + backward) -
            # forward, [B,H,S,D] layout (the port never calls it)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                with torch.no_grad():
                    F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=kv != h)

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=kv != h)
                torch.autograd.grad(out, (qt, kt, vt), dot)

            def sdpa_bwd():
                return time_ms(sdpa_fwd_bwd, iters) - time_ms(sdpa_fwd,
                                                              iters)

            def kern():
                return time_ms(lambda: fa.flash_attention_bwd_cuda(
                    q, k, v, o, lse, do, causal=causal), iters)

            # in turns: kernel, SDPA, SDPA, kernel
            turns = [kern(), sdpa_bwd(), sdpa_bwd(), kern()]
            ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1]
                                                          + turns[2]) / 2
            dev_ms = device_ms(lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=causal), iters)
            plain_ms = time_ms(lambda: fa.plain_bwd(q, k, v, o, lse, do,
                                                    causal=causal), iters)
            bound = attention_bwd_bound(case["shape"], dtype, causal)
            if dtype == "float32" and case["name"] == "train":
                # which kernels the yardstick runs (SDPA's fp32 backward),
                # and the device time of each of ours
                emit({"phase": "kernel", "kernel": "sdpa_fp32_fwd_bwd",
                      "shape": case["shape"],
                      "kernels_ms": kernel_names(sdpa_fwd_bwd)})
                emit({"phase": "kernel", "kernel": "flash_attention_bwd_fp32",
                      "shape": case["shape"],
                      "kernels_ms": kernel_names(
                          lambda: fa.flash_attention_bwd_cuda(
                              q, k, v, o, lse, do, causal=causal))})
            row = dict(case=case["name"], dtype=dtype, shape=case["shape"],
                       causal=causal, schedule=fa.plan_backward(dt),
                       rel_err=max(r["rel_err"] for r in grads.values()),
                       max_abs_err=max(err, ag_err),
                       wrapper_max_abs_err=err, autograd_max_abs_err=ag_err,
                       grads=grads, fwd_max_abs_err=o_err,
                       lse_max_abs_err=lse_err, ms=ms, device_ms=dev_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       times_kernel_lib_lib_kernel=turns,
                       tflops=bound["flops"] / (ms * 1e-3) / 1e12, **bound)
            emit({"phase": "kernel", "kernel": "flash_attention_bwd", **row})
            results[(case["name"], dtype)] = row
            del q, k, v, do, o, lse, got, want, qt, kt, vt, dot
    emit(long_rows("flash_attention_bwd", results,
                   ("max_abs_err", "rel_err")))
    return results


# --------------------------------------------------------------- serving
def serve(cfg, params, prompts, new_tokens, *, device, engine=None, **kw):
    """Serve ``prompts`` on ``device`` with ``engine`` (default the eager
    ``ServingEngine``); returns (engine, round metrics)."""
    from repro_torch.configs import model_class
    from repro_torch.core.serving import ServingEngine

    eng = (engine or ServingEngine)(model_class(cfg), cfg, device=device,
                                    init_params=params, **kw)
    for p in prompts:
        eng.submit(p, new_tokens)
    return eng, eng.run()


COUNTERS = ("h2d_bytes", "d2h_bytes", "hidden_h2d_bytes",
            "critical_h2d_bytes", "prefetch_hits", "demand_misses",
            "peak_device_bytes")


def decode_k2_layers(cfg) -> int:
    """Layers whose decode runs K2: every layer but MLA's, which decode
    over their latent cache with plain products (no attention kernel):
    deepseek-v2-lite's leading dense layer only; zamba's units, whose
    shared block runs attention once a unit (the mamba layers run none);
    none of xLSTM's; whisper's decoder layers twice each (self- and
    cross-attention; its encoder has no decode)."""
    if getattr(cfg, "use_mla", False):
        return cfg.first_dense_layers
    if cfg.arch_type == "hybrid":
        return cfg.num_units
    if cfg.arch_type == "ssm":  # xLSTM: no attention anywhere
        return 0
    if cfg.arch_type == "audio":  # whisper's decoder: self + cross
        return 2 * cfg.num_layers
    return cfg.num_layers


def k2_layers(cfg) -> dict:
    """Layers that run K2, by (q/k head dim, value head dim): MLA's at
    (qk_nope + qk_rope, v_head_dim), the others at (head_dim, head_dim).
    Whisper's are K2 calls a forward pass: one an encoder layer, two a
    decoder layer (self- and cross-attention)."""
    if cfg.arch_type == "audio":
        return {(cfg.head_dim, cfg.head_dim):
                cfg.num_encoder_layers + 2 * cfg.num_layers}
    dense = decode_k2_layers(cfg)
    out = {(cfg.head_dim, cfg.head_dim): dense} if dense else {}
    if getattr(cfg, "use_mla", False) and cfg.num_layers > dense:
        out[(cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)] = \
            cfg.num_layers - dense
    return out


def k2_pairs_plan(cfg, cohorts: int, decodes: int) -> dict:
    """K2 forward launches by head-dim pair for ``cohorts`` prefill calls
    and ``decodes`` decode calls a layer: MLA's layers prefill only."""
    dense = (cfg.head_dim, cfg.head_dim)
    plan = {pair: n * (cohorts + (decodes if pair == dense else 0))
            for pair, n in k2_layers(cfg).items()}
    return {pair: n for pair, n in plan.items() if n}


def eager_k2_pairs(cfg, eng, rounds) -> dict:
    """K2 launches of an eager serving run by head-dim pair: one a layer
    for each prefill cohort and one a K2-decoding layer
    (:func:`decode_k2_layers`) for each decode call — a batch of
    same-position sequences, or each sequence where the engine decodes one
    sequence a call (MoE: expert capacity depends on the call's token
    count)."""
    batched = eng._prefill_batchable()
    return k2_pairs_plan(
        cfg, sum(m.prefill_cohorts for m in rounds),
        sum(m.decode_batches if batched else m.decode_tokens
            for m in rounds))


def eager_k2_plan(cfg, eng, rounds) -> int:
    """K2 launches of an eager serving run (:func:`eager_k2_pairs`)."""
    return sum(eager_k2_pairs(cfg, eng, rounds).values())


def pairs_row(counter) -> dict:
    """A launch count by (D, Dv) as JSON keys ``"D,Dv"``."""
    return {f"{d},{dv}": n for (d, dv), n in sorted(counter.items()) if n}



def parity_setup(arch: str, lens, new_tokens: int):
    """parity_phase's config (``arch`` at full width, 2 layers, fp32), its
    prompts of ``lens`` tokens (seed 0) and its horizon."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(arch).replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    return cfg, prompts, max(lens) + new_tokens


def oracle_serve(cfg, params, prompts, new_tokens: int, horizon: int,
                 chunk_size=None) -> dict:
    """parity_phase's CPU engine: the budget (half of a 2-layer param
    stream is below one layer's chunks, so it is the engine's floor: one
    layer's param chunks plus two kv chunks, and the stream must page),
    the tokens and every round's metrics."""
    from repro_torch.configs import model_class
    from repro_torch.core.serving import ServingEngine

    t0 = time.perf_counter()
    probe = ServingEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 40,
                          max_seq_len=horizon, init_params=params,
                          chunk_size=chunk_size)
    stream_bytes = probe._param_stream_bytes
    budget = max(stream_bytes // 2, probe.device_floor_bytes)
    del probe
    cpu, rounds = serve(cfg, params, prompts, new_tokens, device="cpu",
                        device_memory_bytes=budget, max_seq_len=horizon,
                        chunk_size=chunk_size)
    return dict(stream_bytes=stream_bytes, budget=budget, rounds=rounds,
                tokens=[cpu.result(i) for i in range(len(prompts))],
                cpu_s=time.perf_counter() - t0)


def parity_phase(arch: str = "gpt2-paper-1b", lens=(128, 128),
                 new_tokens: int = 8, label: str = "parity", params=None,
                 chunk_size: int | None = None) -> dict:
    """``arch`` at full width, 2 layers, fp32, served on the CPU and on
    the card (prompts of ``lens`` tokens) under a budget that pages the
    param stream: tokens and every per-round counter identical, K2 as
    planned.  ``params`` (else drawn on the CPU from seed 0) and
    ``chunk_size`` (elements; else the engine's search) may be given."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    cfg, prompts, horizon = parity_setup(arch, lens, new_tokens)
    if params is None:
        params = card_params(cfg)
    # the CPU engine (and the budget it finds), from the oracle process
    # (or here)
    oracle = ORACLES.result(f"{label}:{arch}", lambda: oracle_serve(
        cfg, params, prompts, new_tokens, horizon, chunk_size))
    stream_bytes, budget = oracle["stream_bytes"], oracle["budget"]
    cpu_rounds, toks_cpu = oracle["rounds"], oracle["tokens"]
    kw = dict(device_memory_bytes=budget, max_seq_len=horizon,
              chunk_size=chunk_size)
    t1 = time.perf_counter()
    fa.launches = 0
    fa.pair_launches.clear()
    gpu, gpu_rounds = serve(cfg, params, prompts, new_tokens, device="cuda",
                            **kw)
    launches, pairs = fa.launches, dict(fa.pair_launches)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gpu.check_invariants()
    toks_gpu = [gpu.result(i) for i in range(len(prompts))]
    if toks_cpu != toks_gpu:
        raise AssertionError(f"{label}: tokens differ cpu={toks_cpu} "
                             f"cuda={toks_gpu}")
    per_round = []
    for a, b in zip(cpu_rounds, gpu_rounds, strict=True):
        ca = {f: getattr(a, f) for f in COUNTERS}
        cb = {f: getattr(b, f) for f in COUNTERS}
        if ca != cb:
            raise AssertionError(f"{label}: round {a.round_index} counters "
                                 f"differ cpu={ca} cuda={cb}")
        per_round.append(ca)
    h2d = sum(r["h2d_bytes"] for r in per_round)
    if h2d <= 0:
        raise AssertionError(f"{label}: the budget did not page any chunk")
    planned = eager_k2_plan(cfg, gpu, gpu_rounds)
    pairs_planned = eager_k2_pairs(cfg, gpu, gpu_rounds)
    if launches != planned or pairs != pairs_planned:
        raise AssertionError(f"{label}: K2 launched {launches} times "
                             f"({pairs}), the plan implies {planned} "
                             f"({pairs_planned})")
    out = dict(phase=label, config=cfg.name, layers=2,
               dtype="float32", prompts=list(lens), new_tokens=new_tokens,
               d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
               head_dim=cfg.head_dim, param_stream_bytes=stream_bytes,
               device_budget_bytes=budget,
               tokens=toks_gpu, rounds=len(per_round), h2d_bytes=h2d,
               d2h_bytes=sum(r["d2h_bytes"] for r in per_round),
               prefetch_hits=sum(r["prefetch_hits"] for r in per_round),
               k2_launches=launches, k2_planned=planned,
               k2_by_head_dims=pairs_row(pairs),
               cpu_s=oracle["cpu_s"], cuda_s=t2 - t1,
               oracle=ORACLES.row(f"{label}:{arch}"), tokens_identical=True,
               counters_identical=True)
    emit(out)
    del gpu, params
    return out


def slice_phase(cfg=None, params=None, budget: int | None = None,
                label: str = "slice", chunk_size: int | None = None,
                extra_limit: int = 0, new_tokens: int = 16,
                pages: bool = True, engine_kw: dict | None = None,
                setup_peak: bool = False) -> dict:
    """The eager serving slice: ``cfg`` (default gpt2-paper-1b, 20 layers,
    bf16 compute) at full depth and width under ``budget``, prompts
    512/512/500/500, ``new_tokens`` new tokens each, horizon 1024.
    ``params``: the weights, or a function that draws them (called once
    the allocations at the start are counted, so the engine holds the
    only reference once it is built); ``chunk_size`` (elements) overrides
    the engine's search; ``engine_kw``: further engine options;
    ``extra_limit`` bytes join the peak's limit (a model's own
    intermediates, stated by its phase); ``pages`` asks that the budget
    page chunks both ways (a budget that holds everything does not);
    ``setup_peak`` reports the engine's construction peak apart (the
    weights it copies from) and holds the run's peak alone to the
    limit."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.kernels import flash_attention as fa

    cfg = cfg or get_config("gpt2-paper-1b")
    budget = budget or 2 * GIB
    t0 = time.perf_counter()
    if params is None:
        params = card_params(cfg)
    rng = np.random.default_rng(0)
    lens = (512, 512, 500, 500)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated (the peak includes it)
    at_start = torch.cuda.memory_allocated()
    from repro_torch.core.serving import ServingEngine

    if callable(params):
        params = params()
    eng = ServingEngine(model_class(cfg), cfg, device="cuda",
                        device_memory_bytes=budget, max_seq_len=1024,
                        policy="opt", prefetch=True, init_params=params,
                        chunk_size=chunk_size, **(engine_kw or {}))
    del params
    setup = None
    if setup_peak:
        gc.collect()
        torch.cuda.empty_cache()
        setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for p in prompts:
        eng.submit(p, new_tokens)
    t1 = time.perf_counter()
    fa.launches = 0
    fa.pair_launches.clear()
    rounds = eng.run()
    launches, pairs = fa.launches, dict(fa.pair_launches)
    torch.cuda.synchronize()
    eng.check_invariants()
    peak = torch.cuda.max_memory_allocated()
    planned = eager_k2_plan(cfg, eng, rounds)
    pairs_planned = eager_k2_pairs(cfg, eng, rounds)
    if launches != planned or pairs != pairs_planned:
        raise AssertionError(f"{label}: K2 launched {launches} times "
                             f"({pairs}), the plan implies {planned} "
                             f"({pairs_planned})")
    h2d = sum(m.h2d_bytes for m in rounds)
    d2h = sum(m.d2h_bytes for m in rounds)
    if pages and (h2d <= 0 or d2h <= 0):
        raise AssertionError(f"{label}: no paging (h2d={h2d}, d2h={d2h})")
    limit = budget + eng.stem_bytes + GIB + extra_limit
    if peak > limit:
        raise AssertionError(f"{label}: max_memory_allocated {peak} > "
                             f"budget + stem + 1 GiB + {extra_limit} = "
                             f"{limit}")
    for rid in range(len(prompts)):
        toks = eng.result(rid)
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            raise AssertionError(f"{label}: request {rid} gave {toks}")
    pre = [m for m in rounds if m.prefill_tokens]
    dec = [m for m in rounds if m.decode_tokens and not m.prefill_tokens]
    pre_tok = sum(m.prefill_tokens for m in pre)
    dec_tok = sum(m.decode_tokens for m in dec)
    out = dict(
        phase=label, config=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, compute_dtype=cfg.compute_dtype,
        device_budget_bytes=budget,
        param_stream_bytes=eng._param_stream_bytes,
        param_chunk_bytes=eng.params_mgr.chunk_bytes,
        kv_chunk_bytes=eng.kv_chunk_bytes, stem_bytes=eng.stem_bytes,
        prompts=list(lens), new_tokens=new_tokens, rounds=len(rounds),
        setup_s=t1 - t0,
        prefill_tokens=pre_tok, prefill_s=sum(m.wall_s for m in pre),
        prefill_tok_per_s=pre_tok / sum(m.wall_s for m in pre),
        decode_tokens=dec_tok, decode_s=sum(m.wall_s for m in dec),
        decode_tok_per_s=dec_tok / sum(m.wall_s for m in dec),
        round_wall_s=[m.wall_s for m in rounds],
        round_h2d_bytes=[m.h2d_bytes for m in rounds],
        round_d2h_bytes=[m.d2h_bytes for m in rounds],
        round_counters=[{f: getattr(m, f) for f in COUNTERS}
                        for m in rounds],
        h2d_bytes=h2d, d2h_bytes=d2h,
        hidden_h2d_bytes=sum(m.hidden_h2d_bytes for m in rounds),
        prefetch_hits=sum(m.prefetch_hits for m in rounds),
        demand_misses=sum(m.demand_misses for m in rounds),
        k2_launches=launches, k2_planned=planned,
        k2_by_head_dims=pairs_row(pairs),
        max_memory_allocated=peak, allocated_at_start=at_start,
        memory_limit=limit, setup_max_memory_allocated=setup,
        tokens=[eng.result(i) for i in range(len(prompts))])
    emit(out)
    del eng
    return out


# ------------------------------------------------------- compiled serving
def round_rows(rounds) -> list:
    return [{f: getattr(m, f) for f in COUNTERS} for m in rounds]


def first_difference(a: list, b: list):
    """Index of the first round whose counters differ (None: none)."""
    if len(a) != len(b):
        return min(len(a), len(b))
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def k2_plan(cfg, rounds) -> int:
    """K2 calls of a compiled run: one a layer for each prefill cohort and
    one a K2-decoding layer for each round that decodes (one graph replay
    over every slot)."""
    return sum(k2_pairs_plan(
        cfg, sum(m.prefill_cohorts for m in rounds),
        sum(bool(m.decode_tokens) for m in rounds)).values())


def k2_calls(eng) -> dict:
    """The compiled engine's K2 calls: the wrapper's eager launches
    (prefill, and the decode round that warms the graph up) plus each
    replay's calls captured in its graph."""
    from repro_torch.kernels import flash_attention as fa

    g = eng.decode_graph
    return dict(eager_launches=fa.launches, graph_replays=g.replays,
                graph_k2_calls=g.k2_calls,
                total=fa.launches + g.replays * g.k2_calls)


def compiled_parity_phase(arch: str = "gpt2-paper-1b", layers: int = 2,
                          lens=(128, 128), new_tokens: int = 8,
                          label: str = "compiled_parity", params=None,
                          overrides: dict | None = None,
                          **engine_kw) -> dict:
    """``arch`` (default gpt2-paper-1b) at full width, ``layers`` deep,
    fp32, the parity phase's budget, prompts of ``lens`` tokens: eager and
    compiled engines on the CPU and on the card give identical tokens,
    each engine's per-round counters are identical on both devices, and
    the compiled counters equal an eager run one sequence a decode call
    (the replay's choreography); the eager engine on the card launches K2
    as planned, the compiled one captures one graph and calls K2 as
    planned.  ``params`` (else drawn on the card from seed 0),
    ``overrides`` (further config fields: a depth cut inside a unit) and
    ``engine_kw`` (options of every engine) may be given."""
    import numpy as np

    from repro_torch.configs import get_config, model_class
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.serve import CompiledServingEngine

    cfg = get_config(arch).replace(
        num_layers=layers, param_dtype="float32", compute_dtype="float32",
        **(overrides or {}))
    if params is None:
        params = card_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    horizon = max(lens) + new_tokens
    probe = ServingEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 40,
                          max_seq_len=horizon, init_params=params)
    budget = max(probe._param_stream_bytes // 2, probe.device_floor_bytes)
    del probe
    kw = dict(engine_kw, device_memory_bytes=budget, max_seq_len=horizon)
    runs, seconds, launches = {}, {}, {}
    for dev in ("cpu", "cuda"):
        for name, engine in (("eager", ServingEngine),
                             ("compiled", CompiledServingEngine)):
            t0 = time.perf_counter()
            fa.launches = 0
            runs[(dev, name)] = serve(cfg, params, prompts, new_tokens,
                                      device=dev, engine=engine, **kw)
            launches[(dev, name)] = fa.launches
            seconds[f"{dev}_{name}_s"] = time.perf_counter() - t0
    eager, eager_rounds = runs[("cuda", "eager")]
    eager_planned = eager_k2_plan(cfg, eager, eager_rounds)
    if launches[("cuda", "eager")] != eager_planned:
        raise AssertionError(f"{label}: the eager engine launched K2 "
                             f"{launches[('cuda', 'eager')]} times, the "
                             f"plan implies {eager_planned}")
    comp, comp_rounds = runs[("cuda", "compiled")]
    calls = k2_calls(comp)
    kw["max_prefill_batch"] = comp.max_prefill_batch
    one, one_rounds = serve(cfg, params, prompts, new_tokens, device="cuda",
                            max_decode_batch=1, **kw)
    comp.check_invariants()
    tokens = {f"{d}_{n}": [e.result(i) for i in range(len(prompts))]
              for (d, n), (e, _) in runs.items()}
    tokens["cuda_eager_one"] = [one.result(i) for i in range(len(prompts))]
    rows = {f"{d}_{n}": round_rows(r) for (d, n), (_, r) in runs.items()}
    rows["cuda_eager_one"] = round_rows(one_rounds)
    if len({json.dumps(t) for t in tokens.values()}) != 1:
        raise AssertionError(f"{label}: tokens differ {tokens}")
    for a, b in (("cpu_eager", "cuda_eager"),
                 ("cpu_compiled", "cuda_compiled"),
                 ("cuda_eager_one", "cuda_compiled")):
        if rows[a] != rows[b]:
            raise AssertionError(
                f"{label}: counters {a} and {b} differ from round "
                f"{first_difference(rows[a], rows[b])}")
    slots = max(2, 1 << (len(lens) - 1).bit_length())
    if (comp.decode_compile_count, comp.padded_slots) != (1, slots):
        raise AssertionError(f"{label}: {comp.decode_compile_count} "
                             f"decode graphs at {comp.padded_slots} slots")
    planned = k2_plan(cfg, comp_rounds)
    if calls["total"] != planned:
        raise AssertionError(f"{label}: K2 calls {calls}, the plan "
                             f"implies {planned}")
    if sum(r["h2d_bytes"] for r in rows["cuda_compiled"]) <= 0:
        raise AssertionError(f"{label}: the budget did not page")
    out = dict(phase=label, config=cfg.name, layers=layers,
               dtype="float32", prompts=list(lens), new_tokens=new_tokens,
               device_budget_bytes=budget, tokens=tokens["cuda_compiled"],
               rounds=len(comp_rounds), tokens_identical=True,
               counters_identical_cpu_cuda=True,
               counters_compiled_equal_eager_one_a_call=True,
               counters_compiled_equal_eager_batched=(
                   rows["cuda_eager"] == rows["cuda_compiled"]),
               first_round_eager_batched_differs=first_difference(
                   rows["cuda_eager"], rows["cuda_compiled"]),
               decode_compile_count=comp.decode_compile_count,
               prefill_compile_count=comp.prefill_compile_count,
               padded_slots=comp.padded_slots, k2=calls, k2_planned=planned,
               k2_eager_launches=launches[("cuda", "eager")],
               k2_eager_planned=eager_planned, **seconds)
    emit(out)
    del runs, comp, one, params
    return out


PROFILE_TRIES = 6  # profiled decode rounds of a compiled run at most


def compiled_run(cfg, params, prompts, budget, *,
                 profile_round: int, new_tokens: int = 16,
                 setup_peak: bool = False, graph_census=None,
                 **engine_kw) -> dict:
    """Serve the slice's requests (``new_tokens`` each) round by round on
    the compiled engine under ``budget`` (``engine_kw``: further engine
    options; ``params``: the weights or a function that draws them, as
    for :func:`slice_phase`, and ``setup_peak`` as there); launch
    counts zeroed just before the first round and read after the last;
    one decode round profiled.  Returns the engine, its rounds and what
    the profile saw.

    ``graph_census(prof)`` (optional) counts the decode graph's K2
    kernels in a profile.  A replay runs all of the graph's kernels or
    none, so a count strictly between 0 and the graph's means the profiler
    dropped kernel records: it keeps only the device events whose
    converted timestamps fall inside its host-clock window, and late in a
    long process, after unprofiled device work, they drift off the host
    clock by milliseconds (``tools/profile_window.py markers`` measures
    it).  Such a profile is replaced by the next decode round's, up to
    ``PROFILE_TRIES`` rounds; ``censuses`` lists each profiled round's
    (round, count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import model_class
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.serve import CompiledServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = CompiledServingEngine(
        model_class(cfg), cfg, device="cuda", device_memory_bytes=budget,
        max_seq_len=1024, policy="opt", prefetch=True,
        init_params=params() if callable(params) else params, **engine_kw)
    setup = None
    if setup_peak:
        gc.collect()
        torch.cuda.empty_cache()
        setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for p in prompts:
        eng.submit(p, new_tokens)
    setup_s = time.perf_counter() - t0
    fa.launches = 0
    rounds, prof, prof_wall, censuses = [], None, None, []
    while True:
        if len(rounds) == profile_round or (
                censuses and len(rounds) == censuses[-1][0] + 1
                and len(censuses) < PROFILE_TRIES
                and 0 < censuses[-1][1] < eng.decode_graph.k2_calls):
            # the round alone (the previous round's work finished first),
            # device activity only, as train_slice profiles: the readers
            # take device events
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                w0 = time.perf_counter()
                m = eng.step_round()
                torch.cuda.synchronize()
                wall = time.perf_counter() - w0
            if m is not None:  # a round ran: its profile replaces any other
                prof, prof_wall = p, wall
                if graph_census is not None:
                    censuses.append((len(rounds), graph_census(prof)))
        else:
            m = eng.step_round()
        if m is None:
            break
        rounds.append(m)
    torch.cuda.synchronize()
    if prof is None:
        raise AssertionError(f"compiled_run: round {profile_round} was to be "
                             f"profiled; the run has {len(rounds)} rounds")
    eng.check_invariants()
    return dict(eng=eng, rounds=rounds, setup_s=setup_s, at_start=at_start,
                peak=torch.cuda.max_memory_allocated(), setup_peak=setup,
                prof=prof, prof_wall=prof_wall, launches=fa.launches,
                censuses=censuses)


def tok_rates(rounds, times=None) -> dict:
    """Prefill and decode tokens/s on the host clock of the rounds that
    did each (the round's wall, and with ``times`` the compute part)."""
    pre = [i for i, m in enumerate(rounds) if m.prefill_tokens]
    dec = [i for i, m in enumerate(rounds)
           if m.decode_tokens and not m.prefill_tokens]
    out = dict(
        prefill_tokens=sum(rounds[i].prefill_tokens for i in pre),
        prefill_s=sum(rounds[i].wall_s for i in pre),
        decode_tokens=sum(rounds[i].decode_tokens for i in dec),
        decode_s=sum(rounds[i].wall_s for i in dec))
    out["prefill_tok_per_s"] = out["prefill_tokens"] / out["prefill_s"]
    out["decode_tok_per_s"] = out["decode_tokens"] / out["decode_s"]
    if times is not None:
        pc = sum(times[i]["prefill_s"] for i in pre)
        dc = sum(times[i]["decode_s"] for i in dec)
        out.update(prefill_compute_s=pc, decode_compute_s=dc,
                   prefill_compute_tok_per_s=out["prefill_tokens"] / pc,
                   decode_compute_tok_per_s=out["decode_tokens"] / dc,
                   replay_s=sum(t["replay_s"] for t in times))
    return out


def compiled_slice_phase(sl, cfg=None, params=None, budgets=None,
                         phase: str = "compiled_slice") -> dict:
    """The serving slice's configuration (``cfg``, default gpt2-paper-1b,
    20 layers, bf16 compute, prompts 512/512/500/500, 16 new tokens,
    horizon 1024) served by the compiled engine: under the eager slice's
    budget (``budgets[0]``, 2 GiB), against the eager slice (``sl``) and
    an eager run one sequence a decode call (the replay's choreography:
    the exact counter oracle); then under ``budgets[1]`` (8 GiB), which
    holds the whole param stream and every sequence's KV, beside the eager
    engine at that budget.  Per round the counters, host-clock wall split
    into decode, prefill and replay, and the decode graph's replay device
    time; one profiled decode round of each compiled run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = cfg or get_config("gpt2-paper-1b")
    budgets = budgets or (2 * GIB, 8 * GIB)
    if params is None:
        params = card_params(cfg)
    rng = np.random.default_rng(0)
    lens = (512, 512, 500, 500)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    out = dict(phase=phase, config=cfg.name,
               layers=cfg.num_layers, compute_dtype=cfg.compute_dtype,
               prompts=list(lens), new_tokens=16, horizon=1024)
    keys = [f"{budget // GIB}gib" for budget in budgets]
    for key, budget in zip(keys, budgets):
        label = f"{phase} {key}"
        r = compiled_run(cfg, params, prompts, budget, profile_round=8,
                         graph_census=splitkv_calls)
        eng, rounds = r["eng"], r["rounds"]
        calls = k2_calls(eng)
        planned = k2_plan(cfg, rounds)
        if calls["total"] != planned or r["launches"] != calls[
                "eager_launches"]:
            raise AssertionError(f"{label}: K2 calls {calls},"
                                 f" the plan implies {planned}")
        if (eng.decode_compile_count, eng.padded_slots) != (1, 4):
            raise AssertionError(
                f"{label}: {eng.decode_compile_count} decode "
                f"graphs at {eng.padded_slots} slots")
        store_bytes = sum(t.numel() * t.element_size()
                          for t in eng._pstores.values())
        slot_bytes = sum(t.numel() * t.element_size()
                         for tree in eng._slot_caches.values()
                         for t in tree.values())
        limit = (r["at_start"] + budget + eng.stem_bytes + store_bytes
                 + slot_bytes + GIB)
        if r["peak"] > limit:
            raise AssertionError(f"{label}: max_memory_"
                                 f"allocated {r['peak']} > {limit}")
        toks = [eng.result(i) for i in range(len(prompts))]
        if any(len(t) != 16 or not all(0 <= x < cfg.vocab_size for x in t)
               for t in toks):
            raise AssertionError(f"{label}: tokens {toks}")
        graph_ms = eng.decode_graph.device_ms
        prof = dict(device_time_breakdown(r["prof"], r["prof_wall"],
                                          kinds=RT_KINDS),
                    top_kernels=top_kernels(r["prof"]))
        seen = splitkv_calls(r["prof"])
        if seen not in (0, calls["graph_k2_calls"]):
            raise AssertionError(f"{label}: the profiled rounds (round, "
                                 f"split-kv kernels) {r['censuses']}, the "
                                 f"graph holds {calls['graph_k2_calls']}")
        row = dict(
            device_budget_bytes=budget, setup_s=r["setup_s"],
            rounds=len(rounds), tokens=toks,
            round_counters=round_rows(rounds),
            round_wall_s=[m.wall_s for m in rounds],
            round_decode_s=[t["decode_s"] for t in eng.round_times],
            round_prefill_s=[t["prefill_s"] for t in eng.round_times],
            round_replay_s=[t["replay_s"] for t in eng.round_times],
            graph_replay_device_ms=graph_ms,
            graph_warmup_s=eng.decode_graph.warmup_s,
            h2d_bytes=sum(m.h2d_bytes for m in rounds),
            d2h_bytes=sum(m.d2h_bytes for m in rounds),
            h2d_bytes_after_admission=sum(m.h2d_bytes for m in rounds[1:]),
            **tok_rates(rounds, eng.round_times), k2=calls,
            k2_planned=planned, decode_compile_count=eng.decode_compile_count,
            prefill_compile_count=eng.prefill_compile_count,
            padded_slots=eng.padded_slots, max_memory_allocated=r["peak"],
            allocated_at_start=r["at_start"], memory_limit=limit,
            store_bytes=store_bytes, slot_cache_bytes=slot_bytes,
            profiled_round=r["censuses"][-1][0],
            profiled_rounds_splitkv=r["censuses"],
            profiled_splitkv_kernels=(
                seen if seen else "not measured: the profiler recorded no "
                "split-kv kernel of the graph"),
            profiled_round_device=prof)
        del r
        # the yardsticks: at the eager slice's budget the eager run one
        # sequence a decode call (the replay's choreography), at the budget
        # that holds everything the eager engine as is
        kw = (dict(max_decode_batch=1, max_prefill_batch=eng.max_prefill_batch)
              if key == keys[0] else {})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        ref, ref_rounds = serve(cfg, params, prompts, 16, device="cuda",
                                device_memory_bytes=budget, max_seq_len=1024,
                                policy="opt", prefetch=True, **kw)
        ref_toks = [ref.result(i) for i in range(len(prompts))]
        if key == keys[0]:
            if round_rows(ref_rounds) != row["round_counters"]:
                raise AssertionError(
                    f"{label}: counters differ from the eager run "
                    "one sequence a decode call from round "
                    f"{first_difference(round_rows(ref_rounds), row['round_counters'])}")
            eager = sl["tokens"]
            eager_rows = sl["round_counters"]
            row.update(
                counters_equal_eager_one_a_call=True,
                counters_equal_eager_slice=eager_rows == row["round_counters"],
                first_round_eager_slice_differs=first_difference(
                    eager_rows, row["round_counters"]),
                eager_one_tokens_equal=ref_toks == toks)
        else:
            eager = ref_toks
            row.update(eager=dict(
                **tok_rates(ref_rounds),
                round_wall_s=[m.wall_s for m in ref_rounds],
                counters_equal=round_rows(ref_rounds)
                == row["round_counters"]))
        if [t[0] for t in eager] != [t[0] for t in toks]:
            raise AssertionError(f"{label}: prefill tokens "
                                 f"{[t[0] for t in toks]} differ from the "
                                 f"eager engine's {[t[0] for t in eager]}")
        row["prefill_tokens_equal_eager"] = True
        row["decode_tokens_equal_eager"] = [t[1:] == e[1:]
                                            for t, e in zip(toks, eager)]
        out[key] = row
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    emit(out)
    out["launches"] = out[keys[0]]["k2"]["total"]
    out["graph_replays"] = out[keys[0]]["k2"]["graph_replays"]
    del params
    return out


# --------------------------------------------------------------- training
KINDS = (("flash_attention_fwd", "flash_fwd_"),
         ("flash_attention_bwd", "bwd_"),
         ("chunked_adam", "_adam_kernel"),
         ("memcpy_h2d", "Memcpy HtoD"), ("memcpy_d2h", "Memcpy DtoH"),
         ("gemm", ("gemm", "sm90_xmma", "cutlass", "Kernel2")))
GEMM_NAMES = ("gemm", "sm90_xmma", "cutlass", "Kernel2", "nvjet")


def _rt_gemm(name: str):
    """The chunked runtime's GEMMs by source: the LM head's products are
    its only fp32 ones (fp32 copies of the bf16 table: the reference's
    fp32 logits), and cuBLAS names their kernels ``f32``/``sgemm``; every
    other product in its step is bf16 on bf16 (the layers' projections,
    whose Hopper ``nvjet`` kernels name no type).  None for a kernel that
    is not a GEMM."""
    if not any(p in name for p in GEMM_NAMES):
        return None
    if "f32f32" in name or "sgemm" in name:
        return "gemm_head_fp32"
    return "gemm_layers_bf16"


# the chunked runtime's kinds: its GEMMs split by source and operand type
RT_KINDS = KINDS[:5] + (("gemm", _rt_gemm),)


def device_time_breakdown(prof, wall_s: float, ranges=None,
                          kinds=KINDS) -> dict:
    """Device time of one profiled span by kind of work, from the
    profiler's device events (kernels, copies), and the busy share: the
    union of their intervals over the span's host-clock wall time.
    ``kinds`` are (kind, name pattern or patterns) in order of precedence;
    a pattern may be a function of the event's name returning its kind
    (or None).  ``ranges`` maps ``record_function`` labels to kinds: a
    device event that starts inside the device-side range of such a
    label counts as that kind (the ranges themselves are not work)."""
    def kind_of(name: str) -> str:
        for k, pat in kinds:
            if callable(pat):
                hit = pat(name)
                if hit:
                    return hit
            elif any(p in name for p in (pat if isinstance(pat, tuple)
                                         else (pat,))):
                return k
        return "other"

    ranges = ranges or {}
    events = device_events(prof)
    labelled = [(start, end, ranges[name])
                for name, start, end in events if name in ranges]
    spans, by_kind, kinds_of = [], {}, {}
    for name, start, end in events:
        if name in ranges:
            continue
        spans.append((start, end))
        kind = next((k for lo, hi, k in labelled if lo <= start < hi), None)
        if kind is None:
            kind = kinds_of.get(name)
            if kind is None:
                kind = kinds_of[name] = kind_of(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
    if not spans:
        return dict(device_time="not measured: the profiler recorded no "
                    "device events", wall_ms=wall_s * 1e3)
    busy, cur_s, cur_e = 0.0, None, None
    for st, en in sorted(spans):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    out = dict(wall_ms=wall_s * 1e3, device_busy_ms=busy / 1e3,
               device_busy_share=busy / 1e3 / (wall_s * 1e3),
               device_ms_by_kind=by_kind, device_events=len(spans))
    if ranges and not labelled:
        out["ranges"] = ("not measured: the profiler recorded no device-side "
                         "range of " + ", ".join(sorted(ranges)))
    return out


TRAIN_COUNTERS = ("h2d_bytes", "d2h_bytes", "adam_h2d_bytes",
                  "adam_d2h_bytes", "hidden_h2d_bytes", "critical_h2d_bytes",
                  "prefetch_hits", "demand_misses", "peak_device_bytes")


def train(cfg, params, batches, *, device, **kw):
    """Train on ``batches`` on ``device``; returns (engine, step metrics)."""
    from repro_torch.configs import model_class
    from repro_torch.core.engine import PatrickStarEngine

    eng = PatrickStarEngine(model_class(cfg), cfg, device=device,
                            init_params=params, **kw)
    return eng, [eng.step(b) for b in batches]


def device_chunks(eng) -> int:
    """Chunks (holding tensors) whose ADAM the plan runs on the device."""
    if eng.placement is None:
        return 0
    return sum(1 for c in eng.placement.os_device_chunk_ids(eng.cmap)
               if eng.cmap.chunk_tensors(c))


def margin_budget(cmap, act_bytes: int, groups: int,
                  group: str = "layers") -> int:
    """A device budget whose margin space (Section 8.2) holds ``groups``
    optimizer groups: two fp32 copies of layer 0's params (the placement's
    working set; ``group``: the block group's name), the activation
    stream's two co-resident chunks, the groups' three fp32 chunks each,
    and 64 MiB for the non-model peak."""
    layer0 = [p for p in cmap.placements
              if p.name.startswith(f"{group}.0[")]
    working = sum(p.numel for p in layer0) * 4
    return 2 * working + 2 * act_bytes + groups * 3 * cmap.chunk_size * 4 \
        + (64 << 20)


def train_parity_setup(arch: str, steps: int):
    """train_parity's trainer: ``arch`` at full width, 2 layers, fp32,
    ``steps`` batches of 2 x 128, the margin budget of one optimizer
    group: (cfg, batches, options)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn

    cfg = get_config(arch).replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    b, s = 2, 128
    nxt = make_batch_fn(cfg, b, s)
    batches = [nxt() for _ in range(steps)]
    budget = margin_budget(chunk_plan(cfg), b * s * cfg.d_model * 4,
                           groups=1)
    return cfg, batches, dict(device_memory_bytes=budget, policy="opt",
                              prefetch=True, lr=1e-3)


def train_parity_phase(arch: str = "gpt2-paper-1b", steps: int = 2,
                       label: str = "train_parity") -> dict:
    """``arch`` at full width, 2 layers, fp32, batch 2 x 128: the same
    weights trained on the CPU and on the card for ``steps`` steps (2; 3
    before whisper's phases joined, for the script's time limit)."""
    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    cfg, batches, kw = train_parity_setup(arch, steps)
    b, s = 2, 128
    budget = kw["device_memory_bytes"]
    cmap = chunk_plan(cfg)
    params = card_params(cfg)
    # the CPU trainer, from the oracle process (or here)
    oracle = ORACLES.result(label, lambda: oracle_train(
        cfg, params, batches, kw))
    cpu_steps = oracle["steps"]
    t1 = time.perf_counter()
    fa.launches = fa.bwd_launches = ka.launches = 0
    gpu, gpu_steps = train(cfg, params, batches, device="cuda", **kw)
    k1 = ka.launches
    # fp32: K2's forward and backward both run tf32x3
    k2 = dict(fwd=fa.launches, bwd=fa.bwd_launches)
    schedules = dict(
        fwd=fa.plan_forward(b, s, s, cfg.n_heads, torch.float32).schedule,
        bwd=fa.plan_backward(torch.float32))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gpu.pool.check_invariants()
    per_step = []
    for i, (a, c) in enumerate(zip(cpu_steps, gpu_steps, strict=True)):
        ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
        cc = {f: getattr(c, f) for f in TRAIN_COUNTERS}
        if ca != cc:
            raise AssertionError(f"{label}: step {i} counters differ "
                                 f"cpu={ca} cuda={cc}")
        rel = abs(a.loss - c.loss) / max(abs(a.loss), 1e-30)
        if not (math.isfinite(c.loss) and rel <= 1e-4):
            raise AssertionError(f"{label}: step {i} loss cpu "
                                 f"{a.loss} cuda {c.loss} (rel {rel})")
        per_step.append(dict(ca, loss_cpu=a.loss, loss_cuda=c.loss,
                             rel_loss_diff=rel, fwd_s=c.fwd_s, bwd_s=c.bwd_s,
                             adam_s=c.adam_s))
    dev = device_chunks(gpu)
    if dev < 1:
        raise AssertionError(f"{label}: no optimizer group on the "
                             f"device (plan {gpu.placement})")
    if sum(r["h2d_bytes"] + r["adam_h2d_bytes"] for r in per_step) <= 0:
        raise AssertionError(f"{label}: the budget paged no chunk")
    if k1 != dev * (steps - 1):
        raise AssertionError(f"{label}: K1 launched {k1} times, the "
                             f"plan implies {dev} x {steps - 1}")
    layers = cfg.num_layers
    if k2 != dict(fwd=2 * layers * steps, bwd=layers * steps):
        raise AssertionError(f"{label}: K2 launched {k2}, the plan "
                             f"implies {2 * layers * steps} forward and "
                             f"{layers * steps} backward")
    out = dict(phase=label, config=cfg.name, layers=2,
               dtype="float32", batch=[b, s], steps=steps,
               param_chunks=cmap.num_chunks,
               chunk_bytes=cmap.chunk_size * 4, device_budget_bytes=budget,
               os_device_groups=gpu.placement.os_device_groups,
               device_chunks=dev, k1_launches=k1, k2_launches=k2,
               k2_schedules=schedules,
               fwd_s=[r["fwd_s"] for r in per_step],
               bwd_s=[r["bwd_s"] for r in per_step],
               adam_s=[r["adam_s"] for r in per_step],
               cpu_s=oracle["cpu_s"], oracle=ORACLES.row(label),
               cuda_s=t2 - t1, losses_cuda=[r["loss_cuda"] for r in per_step],
               max_rel_loss_diff=max(r["rel_loss_diff"] for r in per_step),
               counters_identical=True, steps_detail=per_step)
    emit(out)
    del gpu, params
    return out


def train_slice_phase(cfg=None, params=None, budget: int | None = None,
                      label: str = "train_slice", chunk_size=None,
                      batch=(8, 1024), extra_limit: int = 0,
                      need_device_adam: bool = True, steps: int = 3) -> dict:
    """The eager trainer at full width: ``cfg`` (default gpt2-paper-1b, 20
    layers, bf16 compute), ``batch`` (default 8 x 1024), a warm-up step
    and ``steps - 1`` timed steps under ``budget``, then one profiled
    step.
    ``chunk_size`` (elements) overrides the engine's search;
    ``extra_limit`` bytes join the peak's limit (a model's own
    intermediates, stated by its phase); ``need_device_adam`` raises if
    the placement put no optimizer group on the device."""
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    cfg = cfg or get_config("gpt2-paper-1b")
    budget = budget or 8 * GIB
    b, s = batch
    t0 = time.perf_counter()
    if params is None:
        params = card_params(cfg)
    nxt = make_batch_fn(cfg, b, s)
    batches = [nxt() for _ in range(steps)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases left allocated (the peak includes it)
    at_start = torch.cuda.memory_allocated()
    from repro_torch.core.engine import PatrickStarEngine

    eng = PatrickStarEngine(model_class(cfg), cfg, device="cuda",
                            device_memory_bytes=budget, policy="opt",
                            prefetch=True, manage_activations=True,
                            chunk_size=chunk_size, init_params=params)
    del params
    gc.collect()
    t1 = time.perf_counter()
    fa.launches = fa.bwd_launches = ka.launches = 0
    fa.pair_launches.clear()
    fa.bwd_pair_launches.clear()
    mets = []
    for batch in batches:
        w0 = time.perf_counter()
        m = eng.step(batch)
        mets.append((m, time.perf_counter() - w0))
    launches = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
    pairs = dict(fwd=dict(fa.pair_launches), bwd=dict(fa.bwd_pair_launches))
    torch.cuda.synchronize()
    eng.pool.check_invariants()
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    dev = device_chunks(eng)
    host = sum(1 for c in range(eng.cmap.num_chunks)
               if eng.cmap.chunk_tensors(c)) - dev
    by_pair = k2_layers(cfg)
    attn = sum(by_pair.values())  # layers whose forward runs K2
    planned = dict(fwd=2 * attn * steps, bwd=attn * steps,
                   adam=dev * (steps - 1))
    pairs_planned = dict(fwd={k: 2 * n * steps for k, n in by_pair.items()},
                         bwd={k: n * steps for k, n in by_pair.items()})
    if launches != planned or pairs != pairs_planned:
        raise AssertionError(f"{label}: launches {launches} ({pairs}), the "
                             f"plan implies {planned} ({pairs_planned})")
    if (need_device_adam and dev < 1) or host < 1:
        raise AssertionError(f"{label}: optimizer groups on the device "
                             f"{dev}, on the host {host}: both must be >= 1")
    for i, (m, _) in enumerate(mets):
        if not math.isfinite(m.loss):
            raise AssertionError(f"{label}: step {i} loss {m.loss}")
        if i and (m.h2d_bytes + m.adam_h2d_bytes <= 0
                  or m.d2h_bytes + m.adam_d2h_bytes <= 0):
            raise AssertionError(f"{label}: step {i} moved no bytes "
                                 f"one way (h2d {m.h2d_bytes}+"
                                 f"{m.adam_h2d_bytes}, d2h {m.d2h_bytes}+"
                                 f"{m.adam_d2h_bytes})")
    stem = sum(t.numel() * t.element_size() for t in eng._stem)
    # param, grad (in the leaf's dtype) and the two fp32 moments
    stem_bytes = 2 * stem + 2 * 4 * sum(t.numel() for t in eng._stem)
    logits_bytes = 2 * b * s * cfg.vocab_size * 4
    limit = budget + stem_bytes + logits_bytes + GIB + extra_limit
    if peak > limit:
        raise AssertionError(f"{label}: max_memory_allocated {peak} > "
                             f"budget + stem + logits + 1 GiB + "
                             f"{extra_limit} = {limit}")
    tokens = b * s
    per_step = [dict(
        step=i, loss=m.loss, wall_s=w, fwd_s=m.fwd_s, bwd_s=m.bwd_s,
        adam_s=m.adam_s, tokens_per_s=tokens / w, h2d_bytes=m.h2d_bytes,
        d2h_bytes=m.d2h_bytes, adam_h2d_bytes=m.adam_h2d_bytes,
        adam_d2h_bytes=m.adam_d2h_bytes,
        hidden_h2d_bytes=m.hidden_h2d_bytes,
        critical_h2d_bytes=m.critical_h2d_bytes,
        prefetch_hits=m.prefetch_hits, demand_misses=m.demand_misses,
        peak_device_bytes=m.peak_device_bytes) for i, (m, w) in
        enumerate(mets)]
    for row in per_step:
        emit({"phase": f"{label}_step" if label != "train_slice"
              else "train_step", **row})
    # one more step under the profiler, after the launch counts were read:
    # where the device time of a post-warm-up step goes, and how busy the
    # card is over the step's wall time
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the breakdown reads device events, and a
    # zamba step's ~60,000 kernels with their host-side ops took ~28 s of
    # the profiler's post-processing
    extra = nxt()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        eng.step(extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    profiled = device_time_breakdown(prof, wall)
    emit({"phase": f"{label}_profile" if label != "train_slice"
           else "train_profile", **profiled})
    out = dict(
        phase=label, config=cfg.name, layers=layers,
        d_model=cfg.d_model, compute_dtype=cfg.compute_dtype, batch=[b, s],
        steps=steps, device_budget_bytes=budget,
        model_data_bytes=4 * eng.cmap.num_chunks * eng.params_mgr.chunk_bytes,
        chunk_bytes=eng.params_mgr.chunk_bytes, chunks=eng.cmap.num_chunks,
        act_chunk_bytes=eng.act_mgr.chunk_bytes,
        os_device_chunks=dev, os_host_chunks=host, setup_s=t1 - t0,
        launches=launches, planned=planned,
        k2_by_head_dims={k: pairs_row(v) for k, v in pairs.items()},
        stem_bytes=stem_bytes,
        max_memory_allocated=peak, allocated_at_start=at_start,
        memory_limit=limit, extra_limit=extra_limit,
        losses=[m.loss for m, _ in mets],
        post_warmup_tokens_per_s=tokens * (steps - 1)
        / sum(w for _, w in mets[1:]), profiled_step=profiled)
    emit(out)
    del eng
    return dict(out, steps_detail=per_step)


# ------------------------------------------------------ rank-parallel plane
def rank_ledgers(dist) -> list:
    """Each simulated rank's cumulative pool ledgers: collective bytes
    (all-gather hidden and critical, reduce-scatter, all-reduce), h2d and
    d2h, prefetch hits and misses, and evictions."""
    import dataclasses

    return [dict({k: dataclasses.asdict(getattr(c.pool, k))
                  for k in ("collectives", "stats", "prefetch")},
                 evictions=dict(c.pool.evictions)) for c in dist.ranks]


def owned_device_chunks(core) -> int:
    """Chunks (holding tensors) that this rank owns and whose ADAM the
    plan runs on the device: K1's launches in a post-warm-up step."""
    if core.placement is None:
        return 0
    return sum(1 for c in core.placement.os_device_chunk_ids(core.cmap)
               if core.cmap.chunk_tensors(c)
               and core.cmap.chunk_owner(c) == core.rank)


class RankLaunches:
    """K2 forward, K2 backward and K1 launches attributed to each
    simulated rank: each rank's ``forward_layer``, ``backward_layer`` and
    ``adam_chunks`` is wrapped to add the kernel counters' increase over
    the call to that rank's tally (the collectives inside those calls
    launch none of these kernels)."""

    def __init__(self, dist):
        from repro_torch.kernels import chunked_adam as ka
        from repro_torch.kernels import flash_attention as fa

        self.read = lambda: (fa.launches, fa.bwd_launches, ka.launches)
        self.by_rank = [[0, 0, 0] for _ in dist.ranks]
        for r, core in enumerate(dist.ranks):
            for name in ("forward_layer", "backward_layer", "adam_chunks"):
                setattr(core, name, self._wrap(getattr(core, name), r))

    def _wrap(self, fn, r):
        def call(*args):
            before = self.read()
            out = fn(*args)
            for i, (a, b) in enumerate(zip(before, self.read())):
                self.by_rank[r][i] += b - a
            return out
        return call

    def take(self) -> list[dict]:
        out = [dict(fwd=f, bwd=b, adam=a) for f, b, a in self.by_rank]
        self.by_rank = [[0, 0, 0] for _ in self.by_rank]
        return out


def check_volume(dist, m, step: int) -> int:
    """The chunked plane's exact per-rank volume on every step, warm-up
    included: 3 (p-1) x groups x chunk bytes, all-gather twice the
    reduce-scatter, hidden + critical == all-gather."""
    exact = 3 * (dist.nproc - 1) * dist.cmap.num_comm_groups \
        * dist.ranks[0].params_mgr.chunk_bytes
    if not (m.chunk_collective_bytes == exact
            and m.allgather_bytes == 2 * m.reduce_scatter_bytes
            and m.hidden_allgather_bytes + m.critical_allgather_bytes
            == m.allgather_bytes):
        raise AssertionError(
            f"step {step}: collective bytes ag {m.allgather_bytes} (hidden "
            f"{m.hidden_allgather_bytes}, critical "
            f"{m.critical_allgather_bytes}), rs {m.reduce_scatter_bytes}; "
            f"3 (p-1) G chunk_bytes = {exact}")
    return exact


def dist_train(cfg, params, batches, *, device, nproc, **kw):
    """Train on ``batches`` over ``nproc`` ranks simulated on ``device``;
    returns (engine, step metrics)."""
    from repro_torch.configs import model_class
    from repro_torch.core.distributed import DistributedPatrickStarEngine

    dist = DistributedPatrickStarEngine(model_class(cfg), cfg, nproc=nproc,
                                        device=device, init_params=params,
                                        **kw)
    return dist, [dist.step(b) for b in batches]


DIST_COLLECTIVES = ("allgather_bytes", "reduce_scatter_bytes",
                    "allreduce_bytes", "hidden_allgather_bytes",
                    "critical_allgather_bytes")


def dist_parity_setup():
    """dist_parity's trainer: gpt2-paper-1b at full width, 2 layers,
    fp32, 2 steps of 4 x 128 over 2 ranks (3 steps before whisper's
    phases joined, for the script's time limit: the warm-up and one step
    on the installed schedules), each rank's budget the margin for one
    optimizer group, below its share of the model data (4 streams x its
    owned chunks), so chunks page: (cfg, batches, ranks, options)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn

    cfg = get_config("gpt2-paper-1b").replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    b, s, steps, p = 4, 128, 2, 2
    nxt = make_batch_fn(cfg, b, s)
    batches = [nxt() for _ in range(steps)]
    budget = margin_budget(chunk_plan(cfg, nproc=p),
                           b // p * s * cfg.d_model * 4, groups=1)
    return cfg, batches, p, dict(device_memory_bytes=budget, policy="opt",
                                 prefetch=True, lr=1e-3)


def oracle_dist(cfg, params, batches, nproc, kw) -> dict:
    """dist_parity's CPU ranks: their step metrics and pool ledgers."""
    t0 = time.perf_counter()
    cpu, steps = dist_train(cfg, params, batches, device="cpu", nproc=nproc,
                            **kw)
    return dict(steps=steps, ledgers=rank_ledgers(cpu),
                cpu_s=time.perf_counter() - t0)


def dist_parity_phase() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import model_class
    from repro_torch.core.distributed import DistributedServingEngine
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    cfg, batches, p, kw = dist_parity_setup()
    b, s, steps = 4, 128, len(batches)
    budget = kw["device_memory_bytes"]
    params = card_params(cfg)
    # the CPU ranks, from the oracle process (or here, run alone)
    oracle = ORACLES.result("dist_parity", lambda: oracle_dist(
        cfg, params, batches, p, kw))
    cpu_steps = oracle["steps"]
    t1 = time.perf_counter()
    fa.launches = fa.bwd_launches = ka.launches = 0
    gpu, gpu_steps = dist_train(cfg, params, batches, device="cuda",
                                nproc=p, **kw)
    launches = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gpu.check_invariants()
    ledgers = rank_ledgers(gpu)
    if ledgers != oracle["ledgers"]:
        raise AssertionError(f"dist_parity: rank ledgers differ cpu="
                             f"{oracle['ledgers']} cuda={ledgers}")
    # one rank on the whole batch, the same budget
    _, single_steps = train(cfg, params, batches, device="cuda", **kw)
    t3 = time.perf_counter()
    per_step = []
    for i, (a, c, one) in enumerate(zip(cpu_steps, gpu_steps, single_steps,
                                        strict=True)):
        ca = [{f: getattr(m, f) for f in TRAIN_COUNTERS}
              for m in a.rank_metrics]
        cc = [{f: getattr(m, f) for f in TRAIN_COUNTERS}
              for m in c.rank_metrics]
        coll = {f: getattr(c, f) for f in DIST_COLLECTIVES}
        if ca != cc or coll != {f: getattr(a, f) for f in DIST_COLLECTIVES}:
            raise AssertionError(f"dist_parity: step {i} counters differ "
                                 f"cpu={ca} cuda={cc}")
        check_volume(gpu, c, i)
        rel = abs(a.loss - c.loss) / max(abs(a.loss), 1e-30)
        rel_one = abs(one.loss - c.loss) / max(abs(one.loss), 1e-30)
        if not (math.isfinite(c.loss) and rel <= 1e-4 and rel_one <= 1e-4):
            raise AssertionError(f"dist_parity: step {i} loss cpu {a.loss} "
                                 f"cuda {c.loss} (rel {rel}), one rank "
                                 f"{one.loss} (rel {rel_one})")
        per_step.append(dict(step=i, loss_cpu=a.loss, loss_cuda=c.loss,
                             loss_one_rank=one.loss, rel_loss_diff=rel,
                             rel_loss_diff_one_rank=rel_one, **coll,
                             ranks=cc))
    if gpu_steps[-1].hidden_allgather_bytes <= 0:
        raise AssertionError("dist_parity: no gather was prefetched")
    if sum(r["h2d_bytes"] + r["adam_h2d_bytes"] for row in per_step
           for r in row["ranks"]) <= 0:
        raise AssertionError("dist_parity: the budget paged no chunk")
    layers = cfg.num_layers
    dev = [owned_device_chunks(core) for core in gpu.ranks]
    planned = dict(fwd=p * 2 * layers * steps, bwd=p * layers * steps,
                   adam=sum(dev) * (steps - 1))
    if launches != planned or sum(dev) < 1:
        raise AssertionError(f"dist_parity: launches {launches}, the plan "
                             f"implies {planned} (owned device chunks "
                             f"{dev})")
    train_out = dict(
        phase="dist_parity", part="train", config="gpt2-paper-1b",
        layers=layers, dtype="float32", nproc=p, batch=[b, s], steps=steps,
        chunks=gpu.cmap.num_chunks, comm_groups=gpu.cmap.num_comm_groups,
        chunk_bytes=gpu.ranks[0].params_mgr.chunk_bytes,
        device_budget_bytes_per_rank=budget, owned_device_chunks=dev,
        launches=launches, planned=planned, cpu_s=oracle["cpu_s"],
        cuda_s=t2 - t1, oracle=ORACLES.row("dist_parity"),
        one_rank_cuda_s=t3 - t2,
        max_rel_loss_diff=max(r["rel_loss_diff"] for r in per_step),
        max_rel_loss_diff_one_rank=max(r["rel_loss_diff_one_rank"]
                                       for r in per_step),
        counters_identical=True, ledgers=ledgers, steps_detail=per_step)
    emit(train_out)
    del gpu

    # the serving fleet: sequences sharded round-robin over the ranks
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=128) for _ in range(4)]
    horizon = 128 + 8
    probe = ServingEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 40,
                          max_seq_len=horizon, init_params=params)
    sbudget = max(probe._param_stream_bytes // 2, probe.device_floor_bytes)
    del probe
    skw = dict(device_memory_bytes=sbudget, max_seq_len=horizon)
    toks, secs = {}, {}
    for device in ("cpu", "cuda"):
        w0 = time.perf_counter()
        fleet = DistributedServingEngine(model_class(cfg), cfg, nproc=p,
                                         device=device, init_params=params,
                                         **skw)
        gids = [fleet.submit(q, 8) for q in prompts]
        rounds = fleet.run()
        fleet.check_invariants()  # zero collective bytes on every rank
        toks[device] = [fleet.result(g) for g in gids]
        secs[device] = time.perf_counter() - w0
        del fleet
    one, _ = serve(cfg, params, prompts, 8, device="cuda", **skw)
    toks["one_engine"] = [one.result(i) for i in range(len(prompts))]
    del one, params
    if not toks["cpu"] == toks["cuda"] == toks["one_engine"]:
        raise AssertionError(f"dist_parity: fleet tokens differ {toks}")
    serve_out = dict(phase="dist_parity", part="serve",
                     config="gpt2-paper-1b", layers=layers, dtype="float32",
                     nproc=p, prompts=[128] * 4, new_tokens=8,
                     device_budget_bytes_per_rank=sbudget,
                     rounds=len(rounds), tokens=toks["cuda"],
                     tokens_identical=True, collective_bytes=0,
                     cpu_s=secs["cpu"], cuda_s=secs["cuda"])
    emit(serve_out)
    return dict(train=train_out, serve=serve_out)


def dist_slice_phase() -> dict:
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.core.distributed import DistributedPatrickStarEngine
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models.api import flatten_with_paths

    cfg = get_config("gpt2-paper-1b")  # 20 layers, bf16 compute
    # a warm-up step and 1 step (2 before whisper's phases joined, for the
    # script's time limit)
    b, s, steps, p = 8, 1024, 2, 2
    budget = 6 * GIB  # per rank
    t0 = time.perf_counter()
    params = card_params(cfg)
    nxt = make_batch_fn(cfg, b, s)
    batches = [nxt() for _ in range(steps)]
    # the limit, before the run: per rank its budget, the stem (param,
    # grad, two fp32 moments) and the head's fp32 logits and their
    # gradient on its batch shard; 1 GiB for everything else
    stem = [t for _, t in flatten_with_paths(params["stem"])]
    stem_bytes = 2 * sum(t.numel() * t.element_size() for t in stem) \
        + 2 * 4 * sum(t.numel() for t in stem)
    logits_bytes = 2 * (b // p) * s * cfg.vocab_size * 4
    limit = p * (budget + stem_bytes + logits_bytes) + GIB
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    dist = DistributedPatrickStarEngine(
        model_class(cfg), cfg, nproc=p, device="cuda",
        device_memory_bytes=budget, policy="opt", prefetch=True,
        gather_lookahead=2, manage_activations=True,
        device_aware_placement=True, init_params=params)
    del params, stem
    gc.collect()
    t1 = time.perf_counter()
    counts = RankLaunches(dist)
    layers, tokens = cfg.num_layers, b * s
    rows, walls = [], []
    for i, batch in enumerate(batches):
        w0 = time.perf_counter()
        m = dist.step(batch)
        wall = time.perf_counter() - w0
        walls.append(wall)
        exact = check_volume(dist, m, i)
        if i and m.hidden_allgather_bytes <= 0:
            raise AssertionError(f"dist_slice: step {i} prefetched no "
                                 f"gather")
        got = counts.take()
        plan = [dict(fwd=2 * layers, bwd=layers,
                     adam=owned_device_chunks(core) if i else 0)
                for core in dist.ranks]
        if got != plan:
            raise AssertionError(f"dist_slice: step {i} launches per rank "
                                 f"{got}, the plan implies {plan}")
        if not math.isfinite(m.loss):
            raise AssertionError(f"dist_slice: step {i} loss {m.loss}")
        row = dict(
            phase="dist_step", step=i, loss=m.loss, wall_s=wall,
            tokens_per_s=tokens / wall, exact_chunked_bytes=exact,
            **{f: getattr(m, f) for f in DIST_COLLECTIVES},
            ranks=[dict(
                rank=r, fwd_s=rm.fwd_s, bwd_s=rm.bwd_s, adam_s=rm.adam_s,
                h2d_bytes=rm.h2d_bytes, adam_h2d_bytes=rm.adam_h2d_bytes,
                d2h_bytes=rm.d2h_bytes, adam_d2h_bytes=rm.adam_d2h_bytes,
                hidden_h2d_bytes=rm.hidden_h2d_bytes,
                prefetch_hits=rm.prefetch_hits,
                demand_misses=rm.demand_misses,
                peak_device_bytes=rm.peak_device_bytes,
                launches=got[r], planned=plan[r])
                for r, rm in enumerate(m.rank_metrics)])
        emit(row)
        rows.append(row)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    dist.check_invariants()
    if peak > limit:
        raise AssertionError(f"dist_slice: max_memory_allocated {peak} > "
                             f"{p} x (budget + stem + logits) + 1 GiB = "
                             f"{limit}")
    profiled = dist_profile(dist, nxt())
    emit({"phase": "dist_profile", **profiled})
    out = dict(
        phase="dist_slice", config="gpt2-paper-1b", layers=layers,
        d_model=cfg.d_model, compute_dtype=cfg.compute_dtype, nproc=p,
        batch=[b, s], batch_per_rank=[b // p, s], steps=steps,
        device_budget_bytes_per_rank=budget,
        model_data_bytes=4 * dist.cmap.num_chunks
        * dist.ranks[0].params_mgr.chunk_bytes,
        chunk_bytes=dist.ranks[0].params_mgr.chunk_bytes,
        chunks=dist.cmap.num_chunks, comm_groups=dist.cmap.num_comm_groups,
        owned_device_chunks=[owned_device_chunks(c) for c in dist.ranks],
        setup_s=t1 - t0, losses=[r["loss"] for r in rows],
        post_warmup_tokens_per_s=tokens * (steps - 1) / sum(walls[1:]),
        launches={k: sum(rk["launches"][k] for r in rows for rk in r["ranks"])
                  for k in ("fwd", "bwd", "adam")},
        max_memory_allocated=peak, allocated_at_start=at_start,
        memory_limit=limit, stem_bytes=stem_bytes,
        logits_bytes_per_rank=logits_bytes)
    emit(out)
    del dist
    return out


def dist_profile(dist, batch) -> dict:
    """One more step under the profiler: the device-time breakdown with
    the on-card gathers and reduce-scatter sums as their own kinds (each
    call wrapped in a ``record_function`` range, whose device-side range
    the profiler records), and each kind's span on the stream between
    CUDA events recorded around its calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    spans = {"dist.allgather": [], "dist.reduce_scatter": []}

    def wrap(fn, label):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            with record_function(label):
                out = fn(*args, **kw)
            ev[1].record()
            spans[label].append(ev)
            return out
        return call

    dist.fetch_group = wrap(dist.fetch_group, "dist.allgather")
    dist.reduce_scatter_group = wrap(dist.reduce_scatter_group,
                                     "dist.reduce_scatter")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            m = dist.step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
    finally:
        del dist.fetch_group, dist.reduce_scatter_group
    out = device_time_breakdown(prof, wall, ranges={
        "dist.allgather": "gather_copy", "dist.reduce_scatter": "reduce_sum"})
    for label, evs in spans.items():
        kind = label.split(".")[1]
        out[f"{kind}_calls"] = len(evs)
        out[f"{kind}_stream_span_ms"] = sum(a.elapsed_time(z)
                                            for a, z in evs)
    return dict(out, loss=m.loss,
                tokens_per_s=int(batch["tokens"].size) / wall)


# ---------------------------------------------- compiled chunked-ZeRO runtime
RT_OPTIONS = dict(os_host_fraction=0.5, weight_decay=0.1)


def rt_make(cfg, dp, device, tp=1, **opt):
    from repro_torch.configs import model_class
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

    return ChunkedRuntime(model_class(cfg), cfg,
                          make_smoke_mesh(dp, tp, device=device),
                          RuntimeOptions(**opt))


def rt_k1_plan(rt) -> int:
    """K1 launches of one step: each data rank's slice of each non-empty
    optimizer-state part, per layer and model rank, one launch where the
    slice is contiguous (one data rank) and one a group where it is
    strided."""
    n, p = 0, rt.ctx.dp
    for name in rt.layouts:
        layers = 1 if name == "stem" else rt.group_lengths[name]
        for groups in rt.os_split(name):
            if groups:
                n += layers * p * (1 if p == 1 else groups)
    return n * rt.ctx.tp


def rt_host_elems(rt) -> int:
    """Elements of the host-resident optimizer-state part (one stream)."""
    n = 0
    for name, lay in rt.layouts.items():
        layers = 1 if name == "stem" else rt.group_lengths[name]
        n += layers * rt.os_split(name)[1] * lay.nproc * lay.chunk_size
    return n


def rt_train(rt, params, batches, *, timed=False, start=0, state=None):
    """Steps of the runtime from ``params`` (or from ``state``); returns
    (pstores, osstores, per-step metrics with the loss as a float)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.runtime import driver

    b, s = batches[0]["tokens"].shape
    if "patch_embeds" in batches[0]:  # the vlm family: patches lead
        s += batches[0]["patch_embeds"].shape[1]
    step, _, _ = driver.build_train_step(rt, InputShape("rt", s, b, "train"),
                                         timed=timed)
    ps, os_ = state or driver.init_state(rt, params=params)
    mets = []
    for i, batch in enumerate(batches, start=start):
        ps, os_, m = step(ps, os_, batch, i)
        mets.append(dict(m, loss=float(m["loss"]),
                         aux_loss=float(m["aux_loss"])))
    return ps, os_, mets


# --------------------------------------------- the parity phases' CPU oracles
ORACLE_DIR = ROOT / "build" / "oracle"
# the oracle process's intra-op threads: fixed, since the CPU's summation
# order (and so xlstm's loss at the last bits) follows the thread count;
# half the machine's eight cores, the other half left to the card's host
ORACLE_THREADS = 4


def parity_trainer(cfg, params, batches, dev, tkw, stem_prefix=None):
    """A parity phase's ``PatrickStarEngine`` on ``dev`` from ``params``
    for ``batches`` (``tkw``: its budget and options): (engine, step
    metrics, the stem gradient of its first update, the leaves whose
    path starts with ``stem_prefix``, "" for all of them; None takes
    none)."""
    from repro_torch.configs import model_class
    from repro_torch.core.engine import PatrickStarEngine

    eng = PatrickStarEngine(model_class(cfg), cfg, device=dev,
                            init_params=params, **tkw)
    stem = {}
    if stem_prefix is not None:
        update = eng.update_stem

        def first_update(stem_grad):
            if not stem:
                stem.update({
                    path: g.detach().float().cpu()
                    for path, g in zip(eng._stem_paths, stem_grad)
                    if not stem_prefix or path[0] == stem_prefix})
            return update(stem_grad)

        eng.update_stem = first_update
    return eng, [eng.step(batch) for batch in batches], stem


def oracle_train(cfg, params, batches, tkw, stem_prefix=None) -> dict:
    """The CPU trainer a parity phase holds the card against (run in the
    oracle process): its step metrics and first stem gradient."""
    t0 = time.perf_counter()
    eng, steps, stem = parity_trainer(cfg, params, batches, "cpu", tkw,
                                      stem_prefix)
    del eng
    return dict(steps=steps, stem=stem, cpu_s=time.perf_counter() - t0)


def _flat_params(params) -> dict:
    """A param tree as numpy arrays by path; numpy has no bf16, so a bf16
    leaf travels as its bits (int16), its key marked."""
    import torch

    from repro_torch.models.api import flatten_with_paths

    out = {}
    for path, t in flatten_with_paths(params):
        key = "/".join(path)
        if t.dtype == torch.bfloat16:
            key, t = key + ":bf16", t.view(torch.int16)
        out[key] = t.numpy()
    return out


def _tree_params(arrays) -> dict:
    """The inverse of :func:`_flat_params`."""
    import torch

    from repro_torch.models.api import unflatten

    paths, leaves = [], []
    for key, a in arrays.items():
        t = torch.from_numpy(a)
        if key.endswith(":bf16"):
            key, t = key[:-len(":bf16")], t.view(torch.bfloat16)
        paths.append(tuple(key.split("/")))
        leaves.append(t)
    return unflatten(paths, leaves)


def oracle_child(jobs, done, threads: int) -> None:
    """The oracle process: with CUDA hidden and ``threads`` intra-op
    threads, each job from ``jobs`` in turn until ``None`` (``(key,
    function name, weights file, kwargs)``): the weights read back as
    numpy arrays, the function run, its result saved beside them; ``done``
    gets ``(key, result file or None, seconds, error)``."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    for key, fn, weights, kw in iter(jobs.get, None):
        t0 = time.perf_counter()
        params = None
        try:
            with np.load(weights) as z:
                params = _tree_params({k: z[k] for k in z.files})
            out = globals()[fn](params=params, **kw)
            path = ORACLE_DIR / f"{key}.result.pt"
            torch.save(out, path)
            done.put((key, str(path), time.perf_counter() - t0, None))
        except BaseException:  # noqa: BLE001 - reported to the parent
            done.put((key, None, time.perf_counter() - t0,
                      traceback.format_exc()))
        del params


class Oracles:
    """The parity phases' CPU oracles in one spawned process, so they run
    while the card works on the phases before them (a forked child
    deadlocked in OpenMP, and threads slowed both sides).  :meth:`start`
    spawns the process (it imports while the card works); :meth:`submit`
    takes a phase's jobs, each with its weights drawn on the card as the
    phase draws them and written as numpy arrays under ``build/oracle/``
    by a thread (the child reads them back: it never redraws), then
    queued; a phase blocks on :meth:`result`.  A key never submitted runs
    inline, so a phase also runs alone."""

    def __init__(self):
        self.keys, self.results, self.wait_s, self.child_s = [], {}, {}, {}
        self.proc = self._jobs = self._done = self._writer = None

    def start(self) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._jobs, self._done = ctx.Queue(), ctx.Queue()
        # a run that fails exits at once: its queued jobs are not flushed
        # to a process that will never read them
        self._jobs.cancel_join_thread()
        self.proc = ctx.Process(target=oracle_child, daemon=True, args=(
            self._jobs, self._done, ORACLE_THREADS))
        self.proc.start()

    def submit(self, keys, jobs) -> None:
        """Queue the jobs of ``keys``: ``jobs(keys)`` yields each ``(key,
        function name, weights, kwargs)`` in the order the phases need
        them, the weights drawn on the card here, in the calling thread
        (a draw beside a phase would count in that phase's memory peak);
        a thread writes each set of weights once (jobs may share one) and
        queues its jobs, so the card's phases go on meanwhile.  A failure
        in the thread fails every job it had not queued."""
        import queue
        import threading
        import traceback

        import numpy as np

        ORACLE_DIR.mkdir(parents=True, exist_ok=True)
        self.keys += list(keys)
        todo = queue.Queue()

        def write():
            queued, paths = set(), {}
            try:
                while (job := todo.get()) is not None:
                    key, fn, params, kw = job
                    if id(params) not in paths:
                        paths[id(params)] = ORACLE_DIR / f"{key}.npz"
                        np.savez(paths[id(params)], **_flat_params(params))
                    self._jobs.put((key, fn, str(paths[id(params)]), kw))
                    queued.add(key)
            except BaseException:  # noqa: BLE001 - the phases raise it
                err = traceback.format_exc()
                for key in keys:
                    if key not in queued:
                        self._done.put((key, None, 0.0, err))

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()
        try:
            for job in jobs(keys):
                todo.put(job)
        finally:
            todo.put(None)

    def result(self, key: str, inline):
        """The job's result: from the process when it was submitted
        (blocking; the wait is recorded), else ``inline()``."""
        import queue

        import torch

        if key not in self.keys:
            return inline()
        t0 = time.perf_counter()
        while key not in self.results:
            try:
                k, path, sec, err = self._done.get(timeout=5)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise RuntimeError(f"oracle process ended (exit "
                                       f"{self.proc.exitcode}) before "
                                       f"{key}") from None
                continue
            self.results[k], self.child_s[k] = (path, err), sec
        self.wait_s[key] = time.perf_counter() - t0
        path, err = self.results[key]
        if err is not None:
            raise RuntimeError(f"oracle {key} failed:\n{err}")
        out = torch.load(path, weights_only=False)
        (ORACLE_DIR / f"{key}.result.pt").unlink(missing_ok=True)
        return out

    def row(self, key: str) -> dict:
        """How a phase's oracle ran: in the process (its seconds there and
        the phase's wait) or inline."""
        if key not in self.wait_s:
            return dict(process="inline")
        return dict(process="spawned", threads=ORACLE_THREADS,
                    process_s=self.child_s[key], wait_s=self.wait_s[key])

    def close(self) -> None:
        """End the process (every result read, or the run failed) and
        remove the weights it read."""
        import shutil

        if self.proc is None:
            return
        self._jobs.put(None)
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.proc = None
        shutil.rmtree(ORACLE_DIR, ignore_errors=True)


ORACLES = Oracles()


# the phases whose CPU oracles the process runs, in the order ``main``
# runs them
ORACLE_KEYS = ("zamba_parity", "xlstm_parity", "whisper_parity",
               "phi3v_parity", "nemotron_parity", "dsv2_parity",
               "parity:gpt2-paper-1b", "train_parity", "dist_parity",
               "rt_parity_float32", "rt_parity_bfloat16", "timeline_parity",
               "zoo_parity:gpt2-paper-4b", "zoo_parity_train")


def oracle_jobs(keys=ORACLE_KEYS):
    """The oracle process's jobs of ``keys``, one at a time: each phase's
    weights drawn on the card as the phase draws them, and its CPU
    trainer's (and server's) inputs."""
    frontends = {"whisper_parity": whisper_parity_args,
                 "phi3v_parity": phi3v_parity_args,
                 "nemotron_parity": nemotron_parity_args}
    drawn = {}

    def card_params(cfg):  # one draw a config: its phases draw the same
        if cfg not in drawn:
            drawn[cfg] = globals()["card_params"](cfg)
        return drawn[cfg]

    for key in keys:
        if key.startswith(("parity:", "zoo_parity:")):
            cfg, prompts, horizon = parity_setup(
                key.split(":")[1], (128, 128) if key.startswith("parity")
                else (64, 48), 8 if key.startswith("parity") else 2)
            yield key, "oracle_serve", card_params(cfg), dict(
                cfg=cfg, prompts=prompts, new_tokens=8 if key.startswith(
                    "parity") else 2, horizon=horizon)
            continue
        if key in ("train_parity", "zoo_parity_train"):
            cfg, batches, kw = train_parity_setup(
                "gpt2-paper-1b" if key == "train_parity" else "gpt2-paper-4b",
                2)
            yield key, "oracle_train", card_params(cfg), dict(
                cfg=cfg, batches=batches, tkw=kw)
            continue
        if key == "timeline_parity":
            su = timeline_parity_setup()
            yield key, "oracle_timeline", card_params(su["cfg"]), su
            continue
        if key == "dist_parity":
            cfg, batches, p, kw = dist_parity_setup()
            yield key, "oracle_dist", card_params(cfg), dict(
                cfg=cfg, batches=batches, nproc=p, kw=kw)
            continue
        if key.startswith("rt_parity_"):
            cfg, batches = rt_parity_setup(key.rsplit("_", 1)[1])
            yield key, "oracle_rt", card_params(cfg), dict(
                cfg=cfg, batches=batches, dp=2, opt=RT_PARITY_OPTIONS)
            continue
        if key in frontends:
            (_, cfg, train_len, sbatch, serve_len, new, group, _), _ = \
                frontends[key]()
            batches, tkw = parity_train_setup(cfg, 1, train_len, 2, group)
            yield key, "oracle_frontend", card_params(cfg), dict(
                cfg=cfg, batches=batches, tkw=tkw, serve_batch=sbatch,
                serve_len=serve_len, new=new)
            continue
        if key == "zamba_parity":
            cfg = zamba_parity_config()
            batches, tkw = parity_train_setup(cfg, 1, 128, 2, "units")
            kw = dict(stem_prefix="shared_attn")
        elif key == "xlstm_parity":
            cfg = xlstm_parity_config()
            batches, tkw = xlstm_parity_setup(cfg)
            kw = {}
        else:
            cfg = dsv2_parity_config()
            batches, tkw = parity_train_setup(cfg, 1, 64, 2, "moe_layers")
            kw = {}
        yield key, "oracle_train", card_params(cfg), dict(
            cfg=cfg, batches=batches, tkw=tkw, **kw)


def rt_oracle(cpu_steps, rt_steps: int) -> list:
    """The CPU oracle of a parity phase's one runtime step: the CPU
    trainer's first loss.  At one step the runtime's loss is the model's
    fp32 forward on the parity weights and batch, which the CPU trainer's
    first step computes too: the two CPU runs agreed to the bit in every
    parity phase of every card run that had both, so the CPU runtime's own
    step (10-20 s a phase) is not run."""
    if rt_steps != 1:
        raise ValueError(f"the trainer's first loss is the oracle of one "
                         f"runtime step, not {rt_steps}")
    return [dict(loss=cpu_steps[0].loss)]


def rt_parts(ps, os_) -> dict:
    out = {f"param/{k}": v for k, v in ps.items()}
    for name, streams in os_.items():
        for k, parts in streams.items():
            for part, t in parts.items():
                out[f"{name}/{k}/{part}"] = t
    return out


# rt_parity, for the script's time limit (the CPU runs dominate): one
# layer, 2 rows (4 before zamba's phases joined), 2 steps (3 before
# xlstm's), both dtypes at dp=2 only (bf16 at dp=1 too before xlstm's,
# fp32 before whisper's: the whisper, zamba, xlstm and deepseek parity
# phases hold the runtime at dp=1 in fp32, CPU against card); the resume
# after step 1 still has a step to continue
RT_PARITY = (2, 128, 2, 1)  # batch, tokens, steps, layers
RT_PARITY_OPTIONS = dict(RT_OPTIONS, xent_block=64)


def rt_parity_setup(dtype: str):
    """rt_parity's config in ``dtype`` and its batches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn

    b, s, steps, layers = RT_PARITY
    cfg = get_config("gpt2-paper-1b").replace(
        num_layers=layers, param_dtype=dtype, compute_dtype=dtype)
    nxt = make_batch_fn(cfg, b, s)
    return cfg, [{k: v for k, v in nxt().items() if k != "mask"}
                 for _ in range(steps)]


def oracle_rt(cfg, params, batches, dp: int, opt: dict) -> dict:
    """rt_parity's CPU runtime: its per-step metrics."""
    t0 = time.perf_counter()
    _, _, metrics = rt_train(rt_make(cfg, dp, "cpu", **opt), params,
                             batches)
    return dict(metrics=metrics, cpu_s=time.perf_counter() - t0)


def rt_parity_phase() -> dict:
    import shutil

    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    b, s, steps, layers = RT_PARITY
    opt = RT_PARITY_OPTIONS
    cases, launches = [], dict(fwd=0, bwd=0, adam=0)
    for dtype, dps in (("float32", (2,)), ("bfloat16", (2,))):
        cfg, batches = rt_parity_setup(dtype)
        params = card_params(cfg)
        for dp in dps:
            # the CPU runtime, from the oracle process (or here)
            oracle = ORACLES.result(f"rt_parity_{dtype}", lambda: oracle_rt(
                cfg, params, batches, dp, opt))
            cm = oracle["metrics"]
            t0, t1 = 0.0, time.perf_counter()
            gpu = rt_make(cfg, dp, "cuda", **opt)
            fa.launches = fa.bwd_launches = ka.launches = 0
            ps, os_, gm = rt_train(gpu, params, batches)
            got = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            plan = dict(fwd=2 * layers * dp * steps, bwd=layers * dp * steps,
                        adam=rt_k1_plan(gpu) * steps)
            if got != plan:
                raise AssertionError(f"rt_parity {dtype} dp={dp}: launches "
                                     f"{got}, the plan implies {plan}")
            for k in launches:
                launches[k] += got[k]
            host_bytes = 12 * rt_host_elems(gpu)
            rels = []
            for i, (c, g) in enumerate(zip(cm, gm, strict=True)):
                rel = abs(c["loss"] - g["loss"]) / max(abs(c["loss"]), 1e-30)
                rels.append(rel)
                if not (math.isfinite(g["loss"]) and rel <= TOL[dtype]):
                    raise AssertionError(
                        f"rt_parity {dtype} dp={dp}: step {i} loss cpu "
                        f"{c['loss']} cuda {g['loss']} (rel {rel})")
                if c["collectives"] != g["collectives"]:
                    raise AssertionError(
                        f"rt_parity {dtype} dp={dp}: step {i} collectives "
                        f"cpu {c['collectives']} cuda {g['collectives']}")
                if not (g["h2d_bytes"] == g["d2h_bytes"] == host_bytes > 0
                        and c["h2d_bytes"] == c["d2h_bytes"] == 0):
                    raise AssertionError(
                        f"rt_parity {dtype} dp={dp}: step {i} host-part "
                        f"bytes h2d {g['h2d_bytes']} d2h {g['d2h_bytes']}, "
                        f"12 B x host elements = {host_bytes}")
            row = dict(phase="rt_parity", dtype=dtype, dp=dp, layers=layers,
                       batch=[b, s], steps=steps, options=opt,
                       layouts={k: list(v.store_shape)
                                for k, v in gpu.layouts.items()},
                       os_split={k: list(gpu.os_split(k))
                                 for k in gpu.layouts},
                       losses_cpu=[c["loss"] for c in cm],
                       losses_cuda=[g["loss"] for g in gm],
                       max_rel_loss_diff=max(rels),
                       collectives=gm[-1]["collectives"],
                       host_part_bytes_each_way=host_bytes,
                       launches=got, planned=plan, cpu_s=oracle["cpu_s"],
                       cuda_s=t2 - t1,
                       oracle=ORACLES.row(f"rt_parity_{dtype}"))
            emit(row)
            cases.append(row)
            if dtype == "float32" and dp == 2:
                resume = rt_resume(cfg, dp, opt, params, batches, ps, os_, gm)
                emit(resume)
            del gpu, ps, os_
        del params
    shutil.rmtree(ROOT / "build" / "rt_checkpoint", ignore_errors=True)
    return dict(cases=cases, resume=resume, launches=launches)


def rt_resume(cfg, dp, opt, params, batches, ps_full, os_full, full) -> dict:
    """Save after every step but the last on the card, restore into a
    fresh runtime, run the last: losses and every store part equal the
    uninterrupted run's exactly."""
    import torch

    from repro_torch.checkpoint import checkpoint as ckpt

    path = ROOT / "build" / "rt_checkpoint"
    first = rt_make(cfg, dp, "cuda", **opt)
    ps, os_, _ = rt_train(first, params, batches[:-1])
    ckpt.save(first, ps, os_, str(path), step=len(batches) - 1)
    del first, ps, os_
    fresh = rt_make(cfg, dp, "cuda", **opt)
    ps, os_, at = ckpt.restore(fresh, str(path))
    ps, os_, rest = rt_train(fresh, None, batches[at:], start=at,
                             state=(ps, os_))
    torch.cuda.synchronize()
    want = [m["loss"] for m in full[at:]]
    got = [m["loss"] for m in rest]
    a, b = rt_parts(ps, os_), rt_parts(ps_full, os_full)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if got != want or differ:
        raise AssertionError(f"rt_parity resume: losses {got} against "
                             f"{want}; parts that differ {differ}")
    return dict(phase="rt_parity", part="resume", dtype=cfg.param_dtype,
                dp=dp, saved_at=at, losses=got, identical=True,
                parts=len(a))


def rt_slice_phase() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime import driver

    cfg = get_config("gpt2-paper-1b")  # 20 x 2048, vocab 50304, bf16
    b, s, steps, block = 8, 1024, 3, 256
    opt = dict(RT_OPTIONS, remat="full", gather_policy="layer",
               xent_block=block)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    rt = rt_make(cfg, 1, "cuda", **opt)
    # the limit, from the layout, before the run: bf16 params and grads,
    # the device part of the optimizer state, the host part fetched, one
    # xent block of fp32 logits and their gradient, 1 GiB
    store_elems = sum(t.numel() for t in rt.store_specs().values())
    dev_elems = sum(os_["p32"]["dev"].numel()
                    for os_ in rt.os_specs().values())
    host_elems = rt_host_elems(rt)
    logits_bytes = 2 * b * block * cfg.vocab_size * 4
    limit = (at_start + 2 * 2 * store_elems + 12 * dev_elems
             + 12 * host_elems + logits_bytes + GIB)
    params = card_params(cfg)
    nxt = make_batch_fn(cfg, b, s)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(steps + 1)]
    ps, os_ = driver.init_state(rt, params=params)
    del params
    gc.collect()
    step, _, _ = driver.build_train_step(rt, InputShape("rt", s, b, "train"),
                                         timed=True)
    t1 = time.perf_counter()
    layers = cfg.num_layers
    plan = dict(fwd=2 * layers, bwd=layers, adam=rt_k1_plan(rt))
    rows = []
    for i, batch in enumerate(batches[:steps]):
        fa.launches = fa.bwd_launches = ka.launches = 0
        w0 = time.perf_counter()
        ps, os_, m = step(ps, os_, batch, i)
        loss = float(m["loss"])
        wall = time.perf_counter() - w0
        got = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
        if got != plan:
            raise AssertionError(f"rt_slice: step {i} launches {got}, the "
                                 f"plan implies {plan}")
        if not (m["h2d_bytes"] == m["d2h_bytes"] == 12 * host_elems > 0):
            raise AssertionError(f"rt_slice: step {i} host-part bytes h2d "
                                 f"{m['h2d_bytes']} d2h {m['d2h_bytes']}, "
                                 f"12 B x {host_elems} elements")
        if not math.isfinite(loss):
            raise AssertionError(f"rt_slice: step {i} loss {loss}")
        row = dict(phase="rt_step", step=i, loss=loss, wall_s=wall,
                   tokens_per_s=b * s / wall, fwd_bwd_s=m["fwd_bwd_s"],
                   adam_s=m["adam_s"], h2d_bytes=m["h2d_bytes"],
                   d2h_bytes=m["d2h_bytes"], launches=got, planned=plan)
        emit(row)
        rows.append(row)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if peak > limit:
        raise AssertionError(f"rt_slice: max_memory_allocated {peak} > "
                             f"limit {limit}")
    # one more step under the profiler, after the launch counts were read
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        ps, os_, m = step(ps, os_, batches[steps], steps)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    profiled = device_time_breakdown(prof, wall, kinds=RT_KINDS)
    # the algorithm's products: the layers' 4 passes (forward, the remat
    # forward, two backward products) over b x s tokens, the head's 4
    flops = dict(
        gemm_layers_bf16=4 * 2 * b * s * layers * (
            4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff),
        gemm_head_fp32=4 * 2 * b * s * cfg.d_model * cfg.vocab_size)
    by_kind = profiled.get("device_ms_by_kind", {})
    profiled.update(
        loss=loss, fwd_bwd_s=m["fwd_bwd_s"], adam_s=m["adam_s"],
        gemm_flops=flops, gemm_calls=kind_calls(prof, _rt_gemm),
        gemm_tflops={k: f / by_kind[k] / 1e9 for k, f in flops.items()
                     if by_kind.get(k)},
        # the copies' rate from the profiler's durations: a check of them
        # against the link (PCIe 5.0 x16 carries at most ~64 GB/s a way)
        copy_gb_per_s={k: 12 * host_elems / by_kind[k] / 1e6
                       for k in ("memcpy_h2d", "memcpy_d2h")
                       if by_kind.get(k)},
        top_kernels=top_kernels(prof, 20))
    emit({"phase": "rt_profile", **profiled})
    out = dict(
        phase="rt_slice", config="gpt2-paper-1b", layers=layers,
        d_model=cfg.d_model, dtype=cfg.param_dtype, dp=1, batch=[b, s],
        steps=steps, options=opt,
        layouts={k: list(v.store_shape) for k, v in rt.layouts.items()},
        os_split={k: list(rt.os_split(k)) for k in rt.layouts},
        param_store_elems=store_elems, os_device_elems=dev_elems,
        os_host_elems=host_elems, host_part_bytes_each_way=12 * host_elems,
        collectives=m["collectives"], setup_s=t1 - t0,
        losses=[r["loss"] for r in rows],
        # the steps after the warm-up one, but for the profiled last one
        post_warmup_tokens_per_s=b * s * (steps - 2)
        / sum(r["wall_s"] for r in rows[1:-1]),
        launches={k: sum(r["launches"][k] for r in rows)
                  for k in ("fwd", "bwd", "adam")},
        planned_per_step=plan, max_memory_allocated=peak,
        allocated_at_start=at_start, memory_limit=limit,
        logits_bytes=logits_bytes, profiled_step=profiled)
    emit(out)
    del rt, ps, os_
    return out


# ------------------------------------------------------ transfer timeline
TRAIN_CHUNK_BYTES = 142_606_336  # one chunk of gpt2-paper-1b's trainer


def link_phase():
    """The card's links, measured: a 1 GiB pinned host -> device copy and
    the device -> host copy back, each on a side stream like the pool's
    copy stream, and one device-to-device ``copy_`` of a trainer chunk
    (the rank-parallel plane's "gather": both ranks live on this card, so
    this is HBM, not NVLink).  Returns the H100 record with these rates
    in place of the recorded ones."""
    import dataclasses

    import torch

    from repro_torch.analysis.roofline import H100_SXM

    dev = torch.device("cuda", torch.cuda.current_device())
    host = torch.ones(GIB, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(GIB, dtype=torch.uint8, device=dev)
    side = torch.cuda.Stream(dev)

    def timed(dst, src, stream, reps):
        out = []
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)  # warm-up
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record(stream)
                dst.copy_(src, non_blocking=True)
                b.record(stream)
                out.append((a, b))
        torch.cuda.synchronize(dev)
        return sorted(a.elapsed_time(b) / 1e3 for a, b in out)

    h2d = timed(card, host, side, 3)
    d2h = timed(host, card, side, 3)
    src = torch.ones(TRAIN_CHUNK_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    d2d = timed(dst, src, torch.cuda.current_stream(dev), 5)
    del host, card, src, dst
    rate = {k: n / t[len(t) // 2] for k, n, t in (
        ("h2d", GIB, h2d), ("d2h", GIB, d2h),
        ("gather", TRAIN_CHUNK_BYTES, d2d))}
    hw = dataclasses.replace(H100_SXM, h2d_bw=rate["h2d"],
                             d2h_bw=rate["d2h"],
                             collective_bw=rate["gather"])
    out = dict(phase="link", h2d_bytes=GIB, d2h_bytes=GIB,
               gather_bytes=TRAIN_CHUNK_BYTES, h2d_s=h2d, d2h_s=d2h,
               gather_s=d2d, h2d_gb_per_s=rate["h2d"] / 1e9,
               d2h_gb_per_s=rate["d2h"] / 1e9,
               gather_gb_per_s=rate["gather"] / 1e9,
               recorded_gb_per_s=dict(
                   h2d=H100_SXM.h2d_bw / 1e9, d2h=H100_SXM.d2h_bw / 1e9,
                   gather=H100_SXM.collective_bw / 1e9),
               gather_note="device-to-device copy_ between two buffers on "
               "one card (the simulated ranks' gather), not NVLink",
               hardware=dataclasses.asdict(hw), card=card_line())
    emit(out)
    return hw


def timeline_row(tl) -> dict:
    """A StepTimeline's fields (the per-stream and per-moment stall maps
    with string keys, as JSON needs)."""
    import dataclasses

    row = dataclasses.asdict(tl)
    row["stall_by_moment"] = {str(k): v
                              for k, v in row["stall_by_moment"].items()}
    return row


def check_timelines(label: str, cpu, cuda) -> int:
    """CPU and card StepTimelines of one run, step by step: identical in
    every field.  Returns how many carried a stall."""
    import dataclasses

    stalled = 0
    for i, (a, c) in enumerate(zip(cpu, cuda, strict=True)):
        if dataclasses.asdict(a) != dataclasses.asdict(c):
            raise AssertionError(f"{label}: step/round {i} timelines differ "
                                 f"cpu={a} cuda={c}")
        stalled += c.stall_s > 0.0
    return stalled


def timeline_parity_setup() -> dict:
    """timeline_parity's inputs: gpt2-paper-1b at full width, 2 layers,
    fp32; the trainer as in train_parity (2 steps, 3 before xlstm's phases
    joined, for the script's time limit: the warm-up and one step);
    serving as in parity, 2 prompts of 128 and 4 new tokens (8 before the
    tensor-parallel phases joined); two ranks on 4 x 128."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn

    cfg = get_config("gpt2-paper-1b").replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    b, s, steps, p = 2, 128, 2, 2
    nxt = make_batch_fn(cfg, b, s)
    batches = [nxt() for _ in range(steps)]
    kw = dict(device_memory_bytes=margin_budget(
        chunk_plan(cfg), b * s * cfg.d_model * 4, groups=1), policy="opt",
        prefetch=True, lr=1e-3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=128) for _ in range(2)]
    nxt = make_batch_fn(cfg, 2 * b, s)
    dist_batches = [nxt() for _ in range(steps)]
    dist_kw = dict(device_memory_bytes=margin_budget(
        chunk_plan(cfg, nproc=p), b * s * cfg.d_model * 4, groups=1),
        policy="opt", prefetch=True, lr=1e-3)
    return dict(cfg=cfg, batches=batches, kw=kw, prompts=prompts,
                horizon=128 + 4, dist_batches=dist_batches,
                dist_kw=dist_kw)


def oracle_timeline(cfg, params, batches, kw, prompts, horizon,
                    dist_batches, dist_kw) -> dict:
    """timeline_parity's CPU runs on the calibrated lanes: the trainer
    with aware prefetch on and off, serving managed and unmanaged (and
    the budget: the parity phase's), the two-rank trainer."""
    from repro_torch.configs import model_class
    from repro_torch.core.serving import ServingEngine
    from repro_torch.core.timeline import TransferTimeline

    t0 = time.perf_counter()
    out = {"train": {aware: train(cfg, params, batches, device="cpu",
                                  timeline=TransferTimeline.calibrated(),
                                  bandwidth_aware_prefetch=aware, **kw)[1]
                     for aware in (True, False)}}
    probe = ServingEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 40, max_seq_len=horizon,
                          init_params=params)
    out["budget"] = budget = max(probe._param_stream_bytes // 2,
                                 probe.device_floor_bytes)
    del probe
    out["serve"] = {}
    for manage_kv in (True, False):
        eng, rounds = serve(cfg, params, prompts, 4, device="cpu",
                            device_memory_bytes=budget, max_seq_len=horizon,
                            manage_kv=manage_kv,
                            timeline=TransferTimeline.calibrated())
        eng.check_invariants()
        out["serve"][manage_kv] = dict(
            rounds=rounds, tokens=[eng.result(i) for i in range(len(prompts))])
    out["dist"] = dist_train(cfg, params, dist_batches, device="cpu",
                             nproc=2,
                             timeline_factory=TransferTimeline.calibrated,
                             **dist_kw)[1]
    out["cpu_s"] = time.perf_counter() - t0
    return out


def timeline_parity_phase() -> dict:
    """The simulated clock sees only bytes, moments and durations, so the
    CPU and the card must report identical timelines: the trainer with
    bandwidth-aware prefetch on and off, serving managed and unmanaged,
    the two-rank trainer with ``timeline_factory=``, each on the same
    fixed lanes (``TransferTimeline.calibrated()``: the recorded H100
    rates)."""
    from repro_torch.core.timeline import TransferTimeline

    su = timeline_parity_setup()
    cfg, params = su["cfg"], card_params(su["cfg"])
    # the CPU runs, from the oracle process (or here)
    oracle = ORACLES.result("timeline_parity", lambda: oracle_timeline(
        params=params, **su))
    out = dict(phase="timeline_parity", config="gpt2-paper-1b", layers=2,
               dtype="float32", lanes="TransferTimeline.calibrated()",
               oracle=ORACLES.row("timeline_parity"))

    # the trainer, as in train_parity
    b, s, steps = 2, 128, 2
    batches, kw = su["batches"], su["kw"]
    for aware in (True, False):
        runs = [oracle["train"][aware],
                train(cfg, params, batches, device="cuda",
                      timeline=TransferTimeline.calibrated(),
                      bandwidth_aware_prefetch=aware, **kw)[1]]
        for i, (a, c) in enumerate(zip(*runs)):
            ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
            if ca != {f: getattr(c, f) for f in TRAIN_COUNTERS}:
                raise AssertionError(f"timeline_parity: trainer step {i} "
                                     f"counters differ (aware={aware})")
            if abs(a.loss - c.loss) > 1e-4 * abs(a.loss):
                raise AssertionError(f"timeline_parity: trainer step {i} "
                                     f"loss cpu {a.loss} cuda {c.loss}")
        stalled = check_timelines(f"timeline_parity: trainer aware={aware}",
                                  [m.timeline for m in runs[0]],
                                  [m.timeline for m in runs[1]])
        if not stalled:
            raise AssertionError("timeline_parity: no trainer step stalled")
        out[f"train_{'aware' if aware else 'fixed'}"] = dict(
            steps=steps, batch=[b, s], stalled_steps=stalled,
            losses_cuda=[m.loss for m in runs[1]],
            timelines=[timeline_row(m.timeline) for m in runs[1]])

    # serving, as in parity: managed and unmanaged
    prompts, horizon = su["prompts"], su["horizon"]
    budget = oracle["budget"]
    toks = {}
    for manage_kv in (True, False):
        runs = {"cpu": oracle["serve"][manage_kv]["rounds"]}
        toks[(manage_kv, "cpu")] = oracle["serve"][manage_kv]["tokens"]
        eng, runs["cuda"] = serve(cfg, params, prompts, 4, device="cuda",
                                  device_memory_bytes=budget,
                                  max_seq_len=horizon, manage_kv=manage_kv,
                                  timeline=TransferTimeline.calibrated())
        eng.check_invariants()
        toks[(manage_kv, "cuda")] = [eng.result(i)
                                     for i in range(len(prompts))]
        del eng
        stalled = check_timelines(
            f"timeline_parity: serving manage_kv={manage_kv}",
            [m.timeline for m in runs["cpu"]],
            [m.timeline for m in runs["cuda"]])
        out[f"serve_{'managed' if manage_kv else 'unmanaged'}"] = dict(
            rounds=len(runs["cuda"]), stalled_rounds=stalled,
            device_budget_bytes=budget,
            wall_s=[m.timeline.wall_s for m in runs["cuda"]])
    if len({str(t) for t in toks.values()}) != 1:
        raise AssertionError(f"timeline_parity: serving tokens differ "
                             f"{toks}")

    # the two-rank trainer, each rank on its own timeline
    b, p = 4, 2
    runs = [oracle["dist"], dist_train(
        cfg, params, su["dist_batches"], device="cuda", nproc=p,
        timeline_factory=TransferTimeline.calibrated, **su["dist_kw"])[1]]
    gather_stall = 0.0
    for i, (a, c) in enumerate(zip(*runs)):
        if abs(a.loss - c.loss) > 1e-4 * abs(a.loss):
            raise AssertionError(f"timeline_parity: two-rank step {i} loss "
                                 f"cpu {a.loss} cuda {c.loss}")
        for r in range(p):
            check_timelines(f"timeline_parity: two-rank step {i} rank {r}",
                            [a.rank_metrics[r].timeline],
                            [c.rank_metrics[r].timeline])
            gather_stall += c.rank_metrics[r].timeline.gather_stall_s
    if gather_stall <= 0.0:
        raise AssertionError("timeline_parity: no gather stalled")
    out["two_rank"] = dict(nproc=p, batch=[b, s], steps=steps,
                           gather_stall_s=gather_stall,
                           losses_cuda=[m.loss for m in runs[1]])
    out.update(timelines_identical=True, counters_identical=True,
               tokens_identical=True)
    emit(out)
    return out


def engine_limit(eng, budget: int, b: int, s: int) -> int:
    """A trainer's device limit: its budget, its stem (param, grad and
    two fp32 moments), the head's fp32 logits and their gradient, and
    1 GiB."""
    stem = sum(t.numel() * t.element_size() for t in eng._stem)
    stem_bytes = 2 * stem + 2 * 4 * sum(t.numel() for t in eng._stem)
    return budget + stem_bytes + 2 * b * s * eng.cfg.vocab_size * 4 + GIB


def step_row(i, m, wall, tokens) -> dict:
    """One timed training step: host clock and the modelled clock."""
    t = m.timeline
    return dict(
        step=i, loss=m.loss, wall_s=wall, tokens_per_s=tokens / wall,
        fwd_s=m.fwd_s, bwd_s=m.bwd_s, adam_s=m.adam_s,
        h2d_bytes=m.h2d_bytes + m.adam_h2d_bytes,
        d2h_bytes=m.d2h_bytes + m.adam_d2h_bytes,
        hidden_h2d_bytes=m.hidden_h2d_bytes,
        critical_h2d_bytes=m.critical_h2d_bytes,
        prefetch_hits=m.prefetch_hits, demand_misses=m.demand_misses,
        peak_device_bytes=m.peak_device_bytes,
        modelled_compute_s=t.compute_s, modelled_h2d_stall_s=t.h2d_stall_s,
        modelled_d2h_stall_s=t.d2h_stall_s,
        modelled_gather_stall_s=t.gather_stall_s,
        modelled_stall_s=t.stall_s, modelled_wall_s=t.wall_s)


def check_step(label: str, m) -> None:
    """The timeline's conservation law and the prefetcher's split."""
    t = m.timeline
    if abs(t.wall_s - (t.compute_s + t.stall_s)) > 1e-9 * t.wall_s:
        raise AssertionError(f"{label}: wall {t.wall_s} != compute "
                             f"{t.compute_s} + stall {t.stall_s}")
    if m.hidden_h2d_bytes + m.critical_h2d_bytes != \
            m.h2d_bytes + m.adam_h2d_bytes:
        raise AssertionError(f"{label}: hidden {m.hidden_h2d_bytes} + "
                             f"critical {m.critical_h2d_bytes} != h2d "
                             f"{m.h2d_bytes + m.adam_h2d_bytes}")


def timeline_slice_phase(hw) -> dict:
    """train_slice's configuration on the calibrated timeline (the link
    rates ``link`` measured), bandwidth-aware prefetch on, then off: no
    more bytes and the same losses, the modelled stall beside the
    measured wall."""
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.core.engine import PatrickStarEngine
    from repro_torch.core.timeline import TransferTimeline
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config("gpt2-paper-1b")  # 20 layers, bf16 compute
    # a warm-up step and 1 step (2 before xlstm's phases joined, for the
    # script's time limit)
    b, s, steps = 8, 1024, 2
    budget = 8 * GIB
    params = card_params(cfg)
    nxt = make_batch_fn(cfg, b, s)
    batches = [nxt() for _ in range(steps)]
    runs, launches = {}, {}
    for aware in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = PatrickStarEngine(
            model_class(cfg), cfg, device="cuda", device_memory_bytes=budget,
            policy="opt", prefetch=True, manage_activations=True,
            init_params=params, timeline=TransferTimeline.calibrated(hw),
            bandwidth_aware_prefetch=aware)
        fa.launches = fa.bwd_launches = ka.launches = 0
        rows = []
        for i, batch in enumerate(batches):
            w0 = time.perf_counter()
            m = eng.step(batch)
            check_step(f"timeline_slice aware={aware} step {i}", m)
            rows.append(step_row(i, m, time.perf_counter() - w0, b * s))
        key = "aware" if aware else "fixed"
        launches[key] = dict(fwd=fa.launches, bwd=fa.bwd_launches,
                             adam=ka.launches)
        torch.cuda.synchronize()
        eng.pool.check_invariants()
        peak = torch.cuda.max_memory_allocated()
        limit = engine_limit(eng, budget, b, s)
        planned = dict(fwd=2 * cfg.num_layers * steps,
                       bwd=cfg.num_layers * steps,
                       adam=device_chunks(eng) * (steps - 1))
        if launches[key] != planned:
            raise AssertionError(f"timeline_slice: {key} launches "
                                 f"{launches[key]}, the plan implies "
                                 f"{planned}")
        if peak > limit:
            raise AssertionError(f"timeline_slice: {key} peak {peak} > "
                                 f"{limit}")
        for row in rows:
            emit({"phase": "timeline_step", "prefetch": key, **row})
        runs[key] = dict(rows=rows, peak=peak, limit=limit, planned=planned)
        del eng
    aware, fixed = runs["aware"]["rows"], runs["fixed"]["rows"]
    # the warm-up step (no prefetch yet) moves the same bytes; after it
    # the bandwidth-aware prefetcher may stage where the fixed depth
    # would evict and fetch again, so it moves no MORE bytes than the
    # fixed depth each way (the reference does the same:
    # tests/test_torch_timeline.py holds both packages to it)
    for f in ("h2d_bytes", "d2h_bytes"):
        if aware[0][f] != fixed[0][f] or \
                sum(r[f] for r in aware) > sum(r[f] for r in fixed):
            raise AssertionError(f"timeline_slice: aware moved more {f} "
                                 f"than fixed: {[r[f] for r in aware]} "
                                 f"{[r[f] for r in fixed]}")
    if [r["loss"] for r in aware] != [r["loss"] for r in fixed]:
        raise AssertionError(f"timeline_slice: losses differ on and off: "
                             f"{[r['loss'] for r in aware]} "
                             f"{[r['loss'] for r in fixed]}")

    def post(rows, f):
        return sum(r[f] for r in rows[1:])

    out = dict(
        phase="timeline_slice", config="gpt2-paper-1b",
        layers=cfg.num_layers, compute_dtype=cfg.compute_dtype,
        batch=[b, s], steps=steps, device_budget_bytes=budget,
        lanes=dict(h2d=hw.h2d_bw, d2h=hw.d2h_bw, gather=hw.collective_bw),
        launches=launches["aware"], planned=runs["aware"]["planned"],
        peak=dict(aware=runs["aware"]["peak"], fixed=runs["fixed"]["peak"]),
        memory_limit=runs["aware"]["limit"],
        losses=[r["loss"] for r in aware], losses_identical=True,
        bytes=dict(aware=dict(h2d=post(aware, "h2d_bytes"),
                              d2h=post(aware, "d2h_bytes")),
                   fixed=dict(h2d=post(fixed, "h2d_bytes"),
                              d2h=post(fixed, "d2h_bytes"))),
        modelled_stall_s=dict(aware=post(aware, "modelled_stall_s"),
                              fixed=post(fixed, "modelled_stall_s")),
        modelled_wall_s=dict(aware=post(aware, "modelled_wall_s"),
                             fixed=post(fixed, "modelled_wall_s")),
        measured_wall_s=dict(aware=post(aware, "wall_s"),
                             fixed=post(fixed, "wall_s")),
        aware_over_fixed=dict(
            modelled_stall=post(aware, "modelled_stall_s")
            / max(post(fixed, "modelled_stall_s"), 1e-30),
            modelled_wall=post(aware, "modelled_wall_s")
            / post(fixed, "modelled_wall_s"),
            measured_wall=post(aware, "wall_s") / post(fixed, "wall_s"),
            # the first full-size engine of a call also pays for pinning
            # its host buffers; the last step of each run is steady
            measured_wall_last_step=aware[-1]["wall_s"]
            / fixed[-1]["wall_s"]),
        measured_over_modelled_wall=dict(
            aware=post(aware, "wall_s") / post(aware, "modelled_wall_s"),
            fixed=post(fixed, "wall_s") / post(fixed, "modelled_wall_s")))
    emit(out)
    return out


class HostPeak:
    """The high-water mark of a pool's host tier: every charge to the
    pool is followed by a read of its host bytes."""

    def __init__(self, pool):
        self.peak = pool.host_bytes_used()
        charge = pool._charge

        def tracked(mgr, dev, nbytes):
            charge(mgr, dev, nbytes)
            self.peak = max(self.peak, pool.host_bytes_used())

        pool._charge = tracked


def cotenancy_phase(hw) -> dict:
    """The reference's co-tenancy pairing at full width on one card:
    qwen3-0.6b served (priority 10, a 1 GiB device soft budget below its
    fp32 layer stream, a host budget of its param stream plus the burst's
    KV) beside gpt2-paper-1b training (10 of its 20 layers, an 8 GiB
    planning share, no budget) on one pool of 9 GiB with OPT eviction and the calibrated
    timeline; against each alone on a private pool of its share.  Bars
    1, 2 and 4 of the reference are asserted; the latency and throughput
    ratios are reported."""
    import statistics

    import numpy as np
    import torch

    from repro_torch import cotenancy as co
    from repro_torch.configs import get_config, model_class
    from repro_torch.core.engine import PatrickStarEngine
    from repro_torch.core.serving import ServeRequest, ServingEngine
    from repro_torch.core.timeline import TransferTimeline
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    scfg = get_config("qwen3-0.6b")  # 28 layers, bf16 compute
    # 10 of its 20 layers (all 20 before phi-3-vision's phases joined,
    # for the script's time limit: its model data, ~9.7 GB, still pages in
    # the 8 GiB share), bf16 compute
    tcfg = get_config("gpt2-paper-1b").replace(num_layers=10)
    # 4 new tokens and a warm-up step and 1 step (8 tokens and 2 steps
    # before xlstm's phases joined, 5 tokens before the tensor-parallel
    # ones, for the script's time limit; the solo run profiles round 3)
    new_tokens, steps, b, s = 4, 2, 8, 1024
    serve_kw = dict(max_seq_len=1024, page_tokens=128)
    sparams = card_params(scfg)
    tparams = card_params(tcfg)
    rng = np.random.default_rng(0)
    lens = (512, 512, 500, 500)
    prompts = [rng.integers(0, scfg.vocab_size, size=n) for n in lens]
    nxt = make_batch_fn(tcfg, b, s)
    batches = [nxt() for _ in range(steps)]
    # the serve tenant's host budget from its chunk maps: the param stream
    # plus every request's KV pages at its final position
    probe = ServingEngine(model_class(scfg), scfg, device="cpu",
                          device_memory_bytes=1 << 40, init_params=sparams,
                          **serve_kw)
    stream = probe._param_stream_bytes
    burst_kv = sum(probe._kv_commit_bytes(ServeRequest(
        rid=-1, prompt=np.asarray(p, np.int32), max_new_tokens=new_tokens))
        for p in prompts)
    del probe
    serve_device, train_device = GIB, 8 * GIB
    serve_host = stream + burst_kv

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # serving alone, on a private pool of its share
    fresh()
    seng = ServingEngine(model_class(scfg), scfg, device="cuda",
                         device_memory_bytes=serve_device,
                         host_memory_bytes=serve_host,
                         timeline=TransferTimeline.calibrated(hw),
                         init_params=sparams, **serve_kw)
    shost = HostPeak(seng.pool)
    rids = [seng.submit(p, new_tokens) for p in prompts]
    # one decode round under the profiler: how much of the measured round
    # the card is busy, and with what
    from torch.profiler import ProfilerActivity, profile

    solo_rounds = []
    while seng.queued_count or seng.active_count:
        if len(solo_rounds) == 3:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                solo_rounds.append(seng.step_round())
                torch.cuda.synchronize()
                wall = time.perf_counter() - w0
            round_profile = device_time_breakdown(prof, wall)
        else:
            solo_rounds.append(seng.step_round())
    emit({"phase": "cotenancy_serve_profile", "round": 3,
          **round_profile})
    seng.check_invariants()
    solo_tokens = [seng.result(r) for r in rids]
    serve_stem = seng.stem_bytes
    del seng
    # training alone on its 8 GiB share, the host tier unbounded: its
    # host peak sizes the shared pool's
    fresh()
    teng = PatrickStarEngine(model_class(tcfg), tcfg, device="cuda",
                             device_memory_bytes=train_device,
                             timeline=TransferTimeline.calibrated(hw),
                             init_params=tparams)
    thost = HostPeak(teng.pool)
    solo_steps = [teng.step(x) for x in batches]
    teng.pool.check_invariants()
    train_extra = engine_limit(teng, train_device, b, s) - train_device
    del teng
    margin = GIB  # above the two solo host peaks
    shares = co.Shares(serve_device=serve_device, serve_host=serve_host,
                       train_device=train_device,
                       device_pool=serve_device + train_device,
                       host_pool=shost.peak + thost.peak + margin)

    fresh()
    at_start = torch.cuda.memory_allocated()
    fa.launches = fa.bwd_launches = ka.launches = 0
    serve, trn, report = co.coresident(
        scfg, sparams, prompts, new_tokens, tcfg, tparams, batches, shares,
        timeline=TransferTimeline.calibrated(hw), device="cuda",
        serve_kw=serve_kw)
    launches = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    limit = shares.device_pool + serve_stem + train_extra
    serve_calls = sum(m.prefill_cohorts + m.decode_batches
                      for m in serve.rounds)
    planned = dict(fwd=scfg.num_layers * serve_calls
                   + 2 * tcfg.num_layers * steps,
                   bwd=tcfg.num_layers * steps,
                   adam=device_chunks(trn.engine) * (steps - 1))
    if launches != planned:
        raise AssertionError(f"cotenancy: launches {launches}, the plan "
                             f"implies {planned}")
    if peak > limit:
        raise AssertionError(f"cotenancy: peak {peak} > pool + stems + "
                             f"logits + 1 GiB = {limit}")
    # bar 1: residency, shared or not, never changes a token
    if serve.tokens != solo_tokens:
        raise AssertionError(f"cotenancy: co-resident tokens "
                             f"{serve.tokens} != solo {solo_tokens}")
    for t in serve.tokens:
        if len(t) != new_tokens or not all(
                0 <= x < scfg.vocab_size for x in t):
            raise AssertionError(f"cotenancy: tokens {t}")
    # bar 4 (its exact half): co-training is the solo math
    solo_losses = [m.loss for m in solo_steps]
    if trn.losses != solo_losses or not all(
            math.isfinite(x) for x in solo_losses):
        raise AssertionError(f"cotenancy: co-resident losses {trn.losses} "
                             f"!= solo {solo_losses}")
    # bar 2 was held every round inside coresident(); once more at the end
    if report["cross_evictions"].get("serve<-train", 0) != 0:
        raise AssertionError(f"cotenancy: {report['cross_evictions']}")

    def mean_lat(rounds, modelled):
        # the measured mean leaves out round 3, which the profiler slowed
        # in the solo run
        return statistics.mean(
            m.timeline.wall_s if modelled else m.wall_s
            for i, m in enumerate(rounds) if modelled or i != 3)

    def tput(steps_, modelled):
        return co.throughput([m.timeline.wall_s if modelled else m.total_s
                              for m in steps_])

    for m in serve.rounds:
        emit({"phase": "cotenancy_round", "round": m.round_index,
              "wall_s": m.wall_s, "modelled_wall_s": m.timeline.wall_s,
              "modelled_stall_s": m.timeline.stall_s,
              "peak_device_bytes": m.peak_device_bytes,
              "h2d_bytes": m.h2d_bytes, "d2h_bytes": m.d2h_bytes,
              "prefill_tokens": m.prefill_tokens,
              "decode_tokens": m.decode_tokens})
    for i, (m, solo) in enumerate(zip(trn.steps, solo_steps)):
        emit({"phase": "cotenancy_step", "step": i, "loss": m.loss,
              "solo_loss": solo.loss, "total_s": m.total_s,
              "solo_total_s": solo.total_s,
              "modelled_wall_s": m.timeline.wall_s,
              "solo_modelled_wall_s": solo.timeline.wall_s,
              "h2d_bytes": m.h2d_bytes + m.adam_h2d_bytes,
              "peak_device_bytes": m.peak_device_bytes})
    out = dict(
        phase="cotenancy", serve_config="qwen3-0.6b",
        serve_layers=scfg.num_layers, train_config="gpt2-paper-1b",
        train_layers=tcfg.num_layers, compute_dtype="bfloat16",
        prompts=list(lens), new_tokens=new_tokens, page_tokens=128,
        batch=[b, s], steps=steps,
        shares=dict(serve_device=serve_device, serve_host=serve_host,
                    serve_param_stream=stream, serve_burst_kv=burst_kv,
                    train_device=train_device,
                    device_pool=shares.device_pool,
                    host_pool=shares.host_pool,
                    solo_serve_host_peak=shost.peak,
                    solo_train_host_peak=thost.peak, host_margin=margin),
        serve_rounds=len(serve.rounds), solo_serve_rounds=len(solo_rounds),
        tokens_equal_solo=True, losses_equal_solo=True,
        losses=trn.losses, report=report, launches=launches,
        planned=planned, max_memory_allocated=peak,
        allocated_at_start=at_start, memory_limit=limit,
        latency_ratio=dict(
            modelled=mean_lat(serve.rounds, True)
            / mean_lat(solo_rounds, True),
            measured=mean_lat(serve.rounds, False)
            / mean_lat(solo_rounds, False)),
        throughput_ratio=dict(
            modelled=tput(trn.steps, True) / tput(solo_steps, True),
            measured=tput(trn.steps, False) / tput(solo_steps, False)),
        solo_decode_round_profile=round_profile,
        serve_mean_round_s=dict(
            solo=mean_lat(solo_rounds, False),
            co=mean_lat(serve.rounds, False),
            solo_modelled=mean_lat(solo_rounds, True),
            co_modelled=mean_lat(serve.rounds, True)),
        train_steps_per_s=dict(
            solo=tput(solo_steps, False), co=tput(trn.steps, False),
            solo_modelled=tput(solo_steps, True),
            co_modelled=tput(trn.steps, True)))
    emit(out)
    del serve, trn
    out["fleets"] = cotenancy_fleets(scfg, sparams, tcfg, tparams, fresh)
    return out


# the fleet pairing's cuts, for the script's time limit (depth, tokens and
# steps only; the widths are the single pairing's)
COTENANCY_FLEETS = dict(nproc=2, serve_layers=8, train_layers=4,
                        prompts=(256, 256, 250, 250), new_tokens=2,
                        batch=(4, 512), steps=2)


def cotenancy_fleets(scfg, sparams, tcfg, tparams, fresh) -> dict:
    """The pairing fleet-wide (``repro_torch.cotenancy.coresident_
    fleets``): a 2-rank qwen3-0.6b serving fleet (``COTENANCY_FLEETS``'s
    depth, prompts and tokens) and a 2-rank gpt2-paper-1b trainer
    (its depth, batch and steps) as tenants of per-rank shared pools on
    the card, the server prioritised with a 1 GiB device budget and its
    stream's and burst's host budget, the trainer a 2 GiB share a rank;
    against each fleet alone on private per-rank pools.  Bars 1, 2 and 4
    of the reference: tokens and losses exactly the solo fleets', the
    serve budgets held on every rank every round, and no serve chunk
    evicted for the trainer on any rank."""
    import numpy as np

    from repro_torch import cotenancy as co
    from repro_torch.configs import model_class
    from repro_torch.core.serving import ServeRequest, ServingEngine
    from repro_torch.data.pipeline import make_batch_fn

    spec = COTENANCY_FLEETS
    t0 = time.perf_counter()
    nproc, new_tokens = spec["nproc"], spec["new_tokens"]
    scfg = scfg.replace(num_layers=spec["serve_layers"])
    tcfg = tcfg.replace(num_layers=spec["train_layers"])
    sparams = cut_layers(sparams, spec["serve_layers"])
    tparams = cut_layers(tparams, spec["train_layers"])
    serve_kw = dict(max_seq_len=512, page_tokens=128)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, scfg.vocab_size, size=n)
               for n in spec["prompts"]]
    b, s = spec["batch"]
    nxt = make_batch_fn(tcfg, b, s)
    batches = [nxt() for _ in range(spec["steps"])]
    probe = ServingEngine(model_class(scfg), scfg, device="cpu",
                          device_memory_bytes=1 << 40, init_params=sparams,
                          **serve_kw)
    serve_host = probe._param_stream_bytes + sum(
        probe._kv_commit_bytes(ServeRequest(
            rid=-1, prompt=np.asarray(p, np.int32),
            max_new_tokens=new_tokens)) for p in prompts)
    del probe
    shares = co.Shares(serve_device=GIB, serve_host=serve_host,
                       train_device=2 * GIB, device_pool=3 * GIB,
                       host_pool=None)
    fresh()
    solo_serve = co.solo_serving_fleet(
        scfg, sparams, prompts, new_tokens, nproc=nproc,
        device_bytes=shares.serve_device, host_bytes=serve_host,
        device="cuda", **serve_kw)
    solo_tokens = solo_serve.tokens
    del solo_serve
    fresh()
    solo_train = co.solo_training_fleet(
        tcfg, tparams, batches, nproc=nproc,
        device_bytes=shares.train_device, device="cuda")
    solo_losses = solo_train.losses
    del solo_train
    fresh()
    serve, trn, report = co.coresident_fleets(
        scfg, sparams, prompts, new_tokens, tcfg, tparams, batches, shares,
        nproc=nproc, device="cuda", serve_kw=serve_kw)
    # bar 1: residency, shared or not, never changes a token
    if serve.tokens != solo_tokens:
        raise AssertionError(f"cotenancy fleets: co-resident tokens "
                             f"{serve.tokens} != solo {solo_tokens}")
    # bar 4 (its exact half): co-training is the solo math
    if trn.losses != solo_losses or not all(
            math.isfinite(x) for x in solo_losses):
        raise AssertionError(f"cotenancy fleets: co-resident losses "
                             f"{trn.losses} != solo {solo_losses}")
    # bar 2 was held every round on every rank; once more at the end
    if any(r.get("serve<-train", 0) for r in report["cross_evictions"]):
        raise AssertionError(f"cotenancy fleets: {report['cross_evictions']}")
    out = dict(phase="cotenancy_fleets", nproc=nproc,
               serve_config="qwen3-0.6b", serve_layers=scfg.num_layers,
               train_config="gpt2-paper-1b", train_layers=tcfg.num_layers,
               prompts=list(spec["prompts"]), new_tokens=new_tokens,
               batch=[b, s], steps=spec["steps"],
               shares=dataclasses.asdict(shares), losses=trn.losses,
               tokens_equal_solo=True, losses_equal_solo=True,
               serve_rounds=len(serve.rounds), report=report,
               seconds=time.perf_counter() - t0)
    emit(out)
    del serve, trn
    return out


# ------------------------------------------------------------- model zoo
ZOO = ("gpt2-paper-4b", "qwen2.5-3b", "deepseek-7b")


def zoo_parity_phase() -> dict:
    """The configs new to the card at full width, 2 layers, fp32, CPU
    against card: gpt2-paper-4b (16 heads x 144), qwen2.5-3b (GQA 16/2,
    QKV bias, rope theta 1e6), deepseek-7b (32 x 128), each served as in
    the parity phase (prompts of 64 and 48 tokens, 2 new tokens); then
    gpt2-paper-4b trained 2 steps (3 before whisper's phases joined, for
    the script's time limit) as in train_parity: there the fp32 kernels
    (``tf32x3``) run at D = 144 inside a model."""
    # 2 new tokens (4 before the tensor-parallel phases joined: cut for
    # the script's time limit)
    out = {arch: parity_phase(arch, (64, 48), 2, label="zoo_parity")
           for arch in ZOO}
    out["train"] = train_parity_phase("gpt2-paper-4b", steps=2,
                                      label="zoo_parity_train")
    return out


# gpt2-paper-4b's depth in train_4b and serve_4b: its full 64 layers took
# ~230 s of the script's 1200 s on a slow host once mixtral joined
FOURB_LAYERS = 24


def params_4b_phase() -> dict:
    """gpt2-paper-4b's weights at full width, ``FOURB_LAYERS`` deep (seed
    0, bf16, drawn on the card: ``card_params``), made once for train_4b
    and serve_4b."""
    from repro_torch.configs import get_config

    return card_params(get_config("gpt2-paper-4b").replace(
        num_layers=FOURB_LAYERS))


def meminfo() -> dict:
    """``MemTotal`` and ``MemAvailable`` of /proc/meminfo, in bytes."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, val = line.partition(":")
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    return out


def host_room() -> int:
    """The bytes this process may still take on the host: ``MemAvailable``,
    or less where the process's cgroup sets a lower limit (v2's
    ``memory.max``, v1's ``memory.limit_in_bytes``; read only)."""
    room = meminfo()["MemAvailable"]
    for limit, usage in (("memory.max", "memory.current"),
                         ("memory/memory.limit_in_bytes",
                          "memory/memory.usage_in_bytes")):
        try:
            top = Path("/sys/fs/cgroup", limit).read_text().strip()
            used = int(Path("/sys/fs/cgroup", usage).read_text())
        except (OSError, ValueError):
            continue
        if top.isdigit():
            room = min(room, int(top) - used)
    return room


def wait_host_room(need: int, timeout: float = 60.0) -> dict:
    """Poll :func:`host_room` until it holds ``need`` bytes, at most
    ``timeout`` seconds: on the card's machine ``MemAvailable`` comes back
    seconds after a release (one eager nemotron engine's pinned blocks:
    65 GiB free right after ``cudaFreeHost``, 91 GiB 5 s later, the
    process's RSS at 5 GiB throughout), so a reading taken at once
    undercounts.  Returns the last reading and the seconds waited."""
    t0 = time.perf_counter()
    room = host_room()
    while room < need and time.perf_counter() - t0 < timeout:
        time.sleep(0.5)
        room = host_room()
    return dict(room=room, waited_s=time.perf_counter() - t0)


def empty_host_cache() -> str:
    """Give PyTorch's cached pinned host blocks (earlier phases' pool
    payloads) back to the system; returns the call used."""
    import torch

    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return name
    return "not available"


def release_host_memory(trim: bool = True) -> dict:
    """Between phases: collect garbage, give PyTorch's cached pinned
    blocks back once the card is done with them, and (``trim``) ask glibc
    to return its free heap to the system.  Returns each part's seconds.
    The trim is the costly part (about 70 s of a 1170 s script when it ran
    after every phase), so the script trims only at the start of the
    phases that pin the most host memory; elsewhere the freed heap stays
    in the process for the next phase's allocations."""
    import ctypes

    import torch

    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    gc.collect()
    lap("gc")
    torch.cuda.synchronize()
    lap("synchronize")
    empty_host_cache()
    lap("empty_host_cache")
    if trim:
        try:
            ctypes.CDLL(None).malloc_trim(0)
        except AttributeError:  # not glibc: nothing to trim
            pass
        lap("malloc_trim")
    return parts


def pinned_block(nbytes: int) -> int:
    """What PyTorch's pinned host allocator hands out for ``nbytes``: the
    next power of two."""
    return 1 << max(0, (nbytes - 1).bit_length())


# the steps of the full-width training phases of the model zoo (train_4b,
# train_mixtral, train_dsv2, train_zamba, train_xlstm, train_whisper;
# train_slice keeps 3): a warm-up and one timed step (two before whisper's
# phases joined: cut for the script's time limit), then the profiled one
ZOO_TRAIN_STEPS = 2


def train_4b_phase(params) -> dict:
    """gpt2-paper-4b (PatrickStar Table 2: 64 x 2304, 16 heads x 144,
    d_ff 9216, vocab 50304, tied) trained by the eager engine, bf16
    compute, 8 x 1024 tokens, OPT, prefetch, the act stream and placement,
    a warm-up step and ``ZOO_TRAIN_STEPS - 1`` timed step, then one
    profiled step, under a 16 GiB device budget against ~68 GB of chunked
    model data: the heterogeneous tier is real.  PyTorch's pinned host
    allocator rounds every block up to a power of two, so the engine's
    searched chunk size is rounded up to the block a chunk occupies
    anyway.  ``MemTotal`` and
    ``MemAvailable`` are printed first; if the host cannot hold the pinned
    tier (every chunk of the four streams the device budget does not hold,
    one act chunk a layer, the weights, 4 GiB for the rest), the depth is
    cut, never the width, and the cut is printed."""

    from repro_torch.configs import get_config
    from repro_torch.models.api import flatten_with_paths, tree_map

    cfg = get_config("gpt2-paper-4b")
    budget = 16 * GIB
    cache_call = empty_host_cache()
    mem = meminfo()
    searched = chunk_plan(cfg).chunk_size
    chunk = pinned_block(searched * 4) // 4
    act_block = pinned_block(8 * 1024 * cfg.d_model * 4)
    params_bytes = sum(t.numel() * t.element_size()
                       for _, t in flatten_with_paths(params))

    def host_need(layers: int) -> int:
        chunks = chunk_plan(cfg.replace(num_layers=layers),
                            chunk_size=chunk).num_chunks
        return (chunk * 4 * max(0, 4 * chunks - budget // (chunk * 4))
                + layers * act_block + params_bytes + 4 * GIB)

    layers = FOURB_LAYERS
    while layers > 1 and host_need(layers) > mem["MemAvailable"]:
        layers -= 1
    head = dict(phase="train_4b_host", meminfo=mem, host_cache=cache_call,
                searched_chunk_elems=searched, chunk_elems=chunk,
                chunk_bytes=chunk * 4, host_need_bytes=host_need(layers),
                layers=layers, full_layers=cfg.num_layers,
                depth_cut=f"{cfg.num_layers} -> {layers} layers: the "
                f"script's time limit" + (
                    "" if layers == FOURB_LAYERS else
                    f"; the host holds {mem['MemAvailable']} bytes"))
    emit(head)
    if layers < cfg.num_layers:
        cfg = cfg.replace(num_layers=layers)
        params = dict(params, groups={
            name: tree_map(lambda t: t[:layers], g)
            for name, g in params["groups"].items()})
    out = train_slice_phase(cfg, params, budget=budget, label="train_4b",
                            steps=ZOO_TRAIN_STEPS,
                            chunk_size=chunk)
    steps = out["steps_detail"]
    timed = steps[1:]
    busy = out["profiled_step"].get("device_busy_share")
    summary = dict(
        phase="train_4b_summary", layers=layers, d_model=cfg.d_model,
        depth_cut=head["depth_cut"], meminfo=mem,
        tokens_per_s=out["post_warmup_tokens_per_s"],
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"],
        idle_share=None if busy is None else 1 - busy,
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        model_data_bytes=out["model_data_bytes"])
    emit(summary)
    return dict(out, host=head, summary=summary)


def serve_4b_phase(params) -> dict:
    """gpt2-paper-4b at full size (bf16 compute) serving the slice's
    requests (prompts 512/512/500/500, 16 new tokens, horizon 1024): the
    eager ``ServingEngine`` under 4 GiB (slice's checks: K2 as planned,
    paging both ways, the peak), then the ``CompiledServingEngine`` under
    4 GiB and under the smallest whole GiB that holds the param stream
    and every sequence's KV, with compiled_slice's gates (prefill tokens
    equal the eager engine's, counters equal the eager run one sequence a
    decode call, K2 calls as planned, one graph at 4 slots), each beside
    its eager yardstick."""
    from repro_torch.configs import get_config

    cfg = get_config("gpt2-paper-4b").replace(num_layers=FOURB_LAYERS)
    sl = slice_phase(cfg, params, budget=4 * GIB, label="serve_4b_eager")
    kv_bytes = sl["kv_chunk_bytes"] * 4 * cfg.num_layers  # a (seq, layer)
    fit = -(-(sl["param_stream_bytes"] + kv_bytes) // GIB) * GIB
    cs = compiled_slice_phase(sl, cfg, params, budgets=(4 * GIB, fit),
                              phase="serve_4b")
    low, high = (f"{b // GIB}gib" for b in (4 * GIB, fit))
    summary = dict(
        phase="serve_4b_summary", layers=cfg.num_layers,
        depth_cut=f"64 -> {cfg.num_layers} layers: the script's time "
        f"limit",
        param_stream_bytes=sl["param_stream_bytes"], kv_bytes=kv_bytes,
        fit_budget_bytes=fit,
        eager_4gib=dict(prefill_tok_per_s=sl["prefill_tok_per_s"],
                        decode_tok_per_s=sl["decode_tok_per_s"]),
        **{f"compiled_{key}": dict(
            prefill_tok_per_s=cs[key]["prefill_tok_per_s"],
            decode_tok_per_s=cs[key]["decode_tok_per_s"],
            round_decode_s=sum(cs[key]["round_decode_s"]),
            round_prefill_s=sum(cs[key]["round_prefill_s"]),
            round_replay_s=sum(cs[key]["round_replay_s"]),
            decode_tokens_equal_eager=cs[key]["decode_tokens_equal_eager"],
            h2d_bytes_after_admission=cs[key]["h2d_bytes_after_admission"],
            max_memory_allocated=cs[key]["max_memory_allocated"])
           for key in (low, high)},
        eager_fit=dict(prefill_tok_per_s=cs[high]["eager"][
            "prefill_tok_per_s"], decode_tok_per_s=cs[high]["eager"][
                "decode_tok_per_s"]),
        k2_launches_eager=sl["k2_launches"], k2_calls_compiled=cs["launches"])
    emit(summary)
    return dict(cs, eager=sl, summary=summary)


# ------------------------------------------------------- mixtral-8x7b
MIXTRAL_ATTN = (1, 8192, 32, 8, 128)  # B, S, H, KV, D: one train sequence
MIXTRAL_WINDOW = 4096
MIXTRAL_CHUNK = 1 << 29  # fp32 elements: 2 GiB, the pinned allocator's block
# mixtral's depth in train_mixtral and serve_mixtral: 2 and 4 layers took
# ~115-135 s of the script's time, cut to 1 and 2 when deepseek-v2-lite's
# phases joined
MIXTRAL_TRAIN_LAYERS = 1
MIXTRAL_SERVE_LAYERS = 2
# serving packs layer after layer, so a layer straddles four such chunks;
# 2^21 elements less keeps that floor and two kv chunks within 8 GiB
MIXTRAL_SERVE_CHUNK = MIXTRAL_CHUNK - (1 << 21)
# the smoke config's window (32): the backward at S = W, just past it, 3 W
WINDOW_SMOKE = [(2, 32, 4, 2, 32), (2, 33, 4, 2, 32), (2, 96, 4, 2, 32)]
RING_POS = (0, 99, 4095, 9000)  # decode positions over a 4096-row ring


def grouped(fn, q, k, v, *rest, **kw):
    """``fn`` (a plain attention function) one kv head and its query heads
    at a time, outputs joined along the head axis: the plain version at
    mixtral's shape holds [Sq, Sk] fp32 scores a head, 8.6 GB for all 32
    heads, several times over in its backward."""
    import torch

    kvh = k.shape[2]
    g = q.shape[2] // kvh
    outs = []
    for j in range(kvh):
        hs = slice(j * g, (j + 1) * g)
        part = [t[:, :, hs] if t.shape[2] == q.shape[2] else
                (t[:, hs] if t.dim() == 3 else t) for t in rest]
        outs.append(fn(q[:, :, hs], k[:, :, j:j + 1], v[:, :, j:j + 1],
                       *part, **kw))
    if isinstance(outs[0], tuple):
        # (o, lse) of the forward, or (dq, dk, dv) of the backward
        axes = [1 if t.dim() == 3 else 2 for t in outs[0]]
        return tuple(torch.cat([o[i] for o in outs], dim=axes[i])
                     for i in range(len(outs[0])))
    return torch.cat(outs, dim=2)


def grad_errors(label, got, want, dtype) -> dict:
    """dq, dk, dv each against its plain value: the absolute error within
    TOL x its largest value (at least 1) and the relative Frobenius error
    within REL_TOL; raises otherwise."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.float()
        tol = TOL[dtype] * max(1.0, w.abs().max().item())
        err = (g.float() - w).abs().max().item()
        rel = ((g.float() - w).norm() / w.norm()).item()
        out[name] = dict(max_abs_err=err, tol=tol, rel_err=rel,
                         rel_tol=REL_TOL[dtype])
        if not (math.isfinite(err) and err <= tol and math.isfinite(rel)
                and rel <= REL_TOL[dtype]):
            raise AssertionError(f"{label} {name}: (max abs, relative) "
                                 f"error ({err}, {rel}) > ({tol}, "
                                 f"{REL_TOL[dtype]})")
    return out


def window_kernels_phase() -> dict:
    """K2 with mixtral's sliding window at its attention shape (B=1,
    S=8192, H=32, KV=8, D=128, window 4096: the window cuts half of each
    late row), both dtypes: the forward (``tc`` / ``tf32x3``) and the
    backward (both schedules) against the plain version (fed the plain
    forward's o and lse), each timed beside the plain version (one kv head
    group a call), SDPA with an explicit boolean window mask (the
    library's yardstick) and the same kernel without the window (which
    shows the skipped tiles), with its bound from this run's visible
    pairs; the split-kv decode over a 4096-row ring with per-row
    ``kv_lens = min(pos + 1, C)``; and, at the smoke config's window (32),
    both backward schedules at S = 32, 33 and 96 (S = W is bit-identical
    to the kernel without a window)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import _visible

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, kv, d = MIXTRAL_ATTN
    w = MIXTRAL_WINDOW
    rows = {}
    for dtype in BOTH:
        dt = getattr(torch, dtype)
        q, do = (torch.randn((b, s, h, d), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        label = f"window_kernels {dtype}"
        plan = fa.plan_forward(b, s, s, h, dt, causal=True, window=w)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=w,
                                         return_lse=True)
        o_ref, lse_ref = grouped(fa.plain, q, k, v, causal=True, window=w,
                                 return_lse=True)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        o_rel = ((o.float() - o_ref.float()).norm()
                 / o_ref.float().norm()).item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (math.isfinite(o_err) and o_err <= TOL[dtype]
                and lse_err <= LSE_TOL):
            raise AssertionError(f"{label} forward ({plan.schedule}): max "
                                 f"abs error {o_err} (tol {TOL[dtype]}), "
                                 f"lse {lse_err} (tol {LSE_TOL})")
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                          window=w)
        want = grouped(fa.plain_bwd, q, k, v, o_ref, lse_ref, do,
                       causal=True, window=w)
        torch.cuda.synchronize()
        grads = grad_errors(f"{label} backward", got, want, dtype)
        del got, want, o_ref, lse_ref
        fwd_iters, bwd_iters = (20, 10) if dtype == "bfloat16" else (5, 3)
        mask = _visible(s, s, q.device, causal=True, q_offset=0,
                        kv_len=None, window=w)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 enable_gqa=True)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        fwd = lambda: fa.flash_attention_cuda(  # noqa: E731
            q, k, v, causal=True, window=w)
        bwd = lambda: fa.flash_attention_bwd_cuda(  # noqa: E731
            q, k, v, o, lse, do, causal=True, window=w)
        def sdpa_bwd():
            return time_ms(sdpa_fwd_bwd, bwd_iters) - time_ms(sdpa_fwd,
                                                              bwd_iters)

        ms, lib_ms, turns = time_pair(fwd, sdpa_fwd, fwd_iters)
        # in turns: kernel, SDPA, SDPA, kernel
        bturns = [time_ms(bwd, bwd_iters), sdpa_bwd(), sdpa_bwd(),
                  time_ms(bwd, bwd_iters)]
        # the same kernels without the window: the tiles the band skips
        o_c, lse_c = fa.flash_attention_cuda(q, k, v, causal=True,
                                             return_lse=True)
        causal_ms = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=True), fwd_iters)
        causal_bwd_ms = time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o_c, lse_c, do, causal=True), bwd_iters)
        del o_c, lse_c
        plain_ms = time_ms(lambda: grouped(fa.plain, q, k, v, causal=True,
                                           window=w), 2)
        plain_bwd_ms = time_ms(lambda: grouped(
            fa.plain_bwd, q, k, v, o, lse, do, causal=True, window=w), 2)
        case = dict(shape=(b, s, s, h, kv, d), dtype=dtype, causal=True,
                    window=w)
        bound = attention_bound(case)
        bbound = attention_bwd_bound((b, s, h, kv, d), dtype, True, w)
        bms = (bturns[0] + bturns[3]) / 2
        rows[("fwd", dtype)] = dict(
            case="mixtral_window", kernel="flash_attention_fwd",
            dtype=dtype, shape=case["shape"], window=w,
            schedule=plan.schedule, max_abs_err=o_err, rel_err=o_rel,
            tol=TOL[dtype], lse_max_abs_err=lse_err, lse_tol=LSE_TOL, ms=ms,
            device_ms=device_ms(fwd, fwd_iters), plain_ms=plain_ms,
            plain_note="one kv head group (4 query heads) a call, 8 calls",
            library_ms=lib_ms, library="SDPA, boolean window mask",
            times_kernel_lib_lib_kernel=turns, causal_no_window_ms=causal_ms,
            window_over_causal=ms / causal_ms,
            tflops=bound["flops"] / (ms * 1e-3) / 1e12, **bound)
        rows[("bwd", dtype)] = dict(
            case="mixtral_window", kernel="flash_attention_bwd",
            dtype=dtype, shape=(b, s, h, kv, d), window=w,
            schedule=fa.plan_backward(dt), grads=grads,
            max_abs_err=max(r["max_abs_err"] for r in grads.values()),
            rel_err=max(r["rel_err"] for r in grads.values()), ms=bms,
            device_ms=device_ms(bwd, bwd_iters), plain_ms=plain_bwd_ms,
            plain_note="one kv head group (4 query heads) a call, 8 calls",
            library_ms=(bturns[1] + bturns[2]) / 2,
            library="SDPA backward, boolean window mask (fwd+bwd - fwd)",
            times_kernel_lib_lib_kernel=bturns,
            causal_no_window_ms=causal_bwd_ms,
            window_over_causal=bms / causal_bwd_ms,
            tflops=bbound["flops"] / (bms * 1e-3) / 1e12, **bbound)
        for key in ("fwd", "bwd"):
            emit({"phase": "window_kernels", **rows[(key, dtype)]})
        del q, k, v, do, o, lse, qt, kt, vt, dot, mask
        torch.cuda.empty_cache()
        rows[("ring", dtype)] = ring_decode_row(dtype, gen)
    smoke = []
    for shape in WINDOW_SMOKE:
        bb, ss, hh, kk, dd = shape
        for dtype in BOTH:
            dt = getattr(torch, dtype)
            q, do = (torch.randn((bb, ss, hh, dd), generator=gen,
                                 device="cuda").to(dt) for _ in range(2))
            k, v = (torch.randn((bb, ss, kk, dd), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=32,
                                             return_lse=True)
            o_ref, lse_ref = fa.plain(q, k, v, causal=True, window=32,
                                      return_lse=True)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                              causal=True, window=32)
            want = fa.plain_bwd(q, k, v, o_ref, lse_ref, do, causal=True,
                                window=32)
            grads = grad_errors(f"window_kernels smoke {shape} {dtype}", got,
                                want, dtype)
            same = None
            if ss <= 32:  # the window masks nothing: bit for bit
                o_n, lse_n = fa.flash_attention_cuda(q, k, v, causal=True,
                                                     return_lse=True)
                got_n = fa.flash_attention_bwd_cuda(q, k, v, o_n, lse_n, do,
                                                    causal=True)
                same = all(torch.equal(a, c) for a, c in zip(
                    (o, lse) + tuple(got), (o_n, lse_n) + tuple(got_n)))
                if not same:
                    raise AssertionError(f"window_kernels smoke {shape} "
                                         f"{dtype}: window >= S is not the "
                                         f"unwindowed kernel bit for bit")
            smoke.append(dict(shape=shape, dtype=dtype, window=32,
                              schedule=fa.plan_backward(dt), grads=grads,
                              bit_identical_without_window=same))
    emit({"phase": "window_kernels_smoke", "rows": smoke})
    rows["smoke"] = smoke
    return rows


def ring_decode_row(dtype: str, gen) -> dict:
    """The split-kv decode over mixtral's 4096-row ring: 4 rows at
    positions ``RING_POS``, each reading ``min(pos + 1, 4096)`` slots from
    the card (``kv_lens``), against the plain version; timed beside it,
    SDPA with the same boolean mask, its device time and byte bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    _, _, h, kv, d = MIXTRAL_ATTN
    c, b = MIXTRAL_WINDOW, len(RING_POS)
    dt = getattr(torch, dtype)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, c, kv, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, c, kv, d), generator=gen, device="cuda").to(dt)
    lens_host = [min(p + 1, c) for p in RING_POS]
    lens = torch.tensor(lens_host, dtype=torch.int32, device="cuda")
    kw = dict(causal=False, kv_lens=lens)
    plan = fa.plan_forward(b, 1, c, h, dt, causal=False)
    got, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    want, want_lse = fa.plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    if not (math.isfinite(err) and err <= TOL[dtype] and lse_err <= LSE_TOL):
        raise AssertionError(f"window_kernels ring decode {dtype}: max abs "
                             f"error {err} (tol {TOL[dtype]}), lse "
                             f"{lse_err} (tol {LSE_TOL})")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = (torch.arange(c, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    call = lambda: fa.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
    ms, library_ms, turns = time_pair(call, lib)
    bound = attention_bound(dict(shape=(b, 1, c, h, kv, d), dtype=dtype,
                                 causal=False, kv_lens=lens_host))
    row = dict(case="mixtral_ring_decode", kernel="flash_attention_fwd",
               dtype=dtype, shape=(b, 1, c, h, kv, d), positions=RING_POS,
               kv_lens=lens_host, schedule=plan.schedule, splits=plan.splits,
               max_abs_err=err, tol=TOL[dtype], lse_max_abs_err=lse_err,
               ms=ms, device_ms=device_ms(call),
               plain_ms=time_ms(lambda: fa.plain(q, k, v, **kw)),
               library_ms=library_ms, library="SDPA, boolean length mask",
               times_kernel_lib_lib_kernel=turns,
               tflops=bound["flops"] / (ms * 1e-3) / 1e12, **bound)
    emit({"phase": "window_kernels", **row})
    return row


def card_params(cfg, seed: int = 0) -> dict:
    """``cfg``'s weights drawn on the card from ``seed`` (a CUDA
    generator: billions of normals in a second, where the CPU's take
    minutes) and brought to CPU memory."""
    import torch

    from repro_torch.configs import model_class
    from repro_torch.models.api import tree_map
    from repro_torch.models.layers import AxisCtx

    with torch.device("cuda"):
        params = model_class(cfg)(cfg, AxisCtx()).init_params(
            torch.Generator(device="cuda").manual_seed(seed))
    out = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    return out


def moe_smoke_parity_phase() -> dict:
    """mixtral's smoke config (2 layers, 4 experts, window 32), fp32:
    served by the eager and the compiled engine on the CPU and on the card
    (prompts of 40, 64 and 96 tokens, so the ring wraps, 8 new tokens,
    under a budget that pages): tokens identical across the four runs,
    each engine's per-round counters identical CPU against card, and the
    compiled counters equal the eager engine's (it serves MoE one
    sequence a call, and each prompt length is its own cohort); then
    ``ChunkedRuntime`` and ``PatrickStarEngine`` 3 steps each of 2 x 128
    tokens (the windowed backward), losses within 1e-4 relative CPU
    against card, launches as planned."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.core.serving import ServingEngine
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.runtime.serve import CompiledServingEngine

    label = "moe_smoke_parity"
    cfg = get_config("mixtral-8x7b", smoke=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = card_params(cfg)
    rng = np.random.default_rng(0)
    lens, new = (40, 64, 96), 8
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    horizon = max(lens) + new
    probe = ServingEngine(model_class(cfg), cfg, device="cpu",
                          device_memory_bytes=1 << 40, max_seq_len=horizon,
                          init_params=params)
    budget = max(probe._param_stream_bytes // 2, probe.device_floor_bytes)
    del probe
    kw = dict(device_memory_bytes=budget, max_seq_len=horizon)
    runs, k2 = {}, {}
    for dev in ("cpu", "cuda"):
        for name, engine in (("eager", ServingEngine),
                             ("compiled", CompiledServingEngine)):
            fa.launches = 0
            runs[(dev, name)] = serve(cfg, params, prompts, new, device=dev,
                                      engine=engine, **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
                eng, rounds = runs[(dev, name)]
                if name == "eager":
                    k2[name] = dict(total=fa.launches,
                                    planned=eager_k2_plan(cfg, eng, rounds))
                else:
                    k2[name] = dict(k2_calls(eng),
                                    planned=k2_plan(cfg, rounds))
                if k2[name]["total"] != k2[name]["planned"]:
                    raise AssertionError(f"{label}: {name} K2 calls "
                                         f"{k2[name]}")
    eager, comp = runs[("cuda", "eager")][0], runs[("cuda", "compiled")][0]
    if eager._prefill_batchable() or not comp._prefill_batchable():
        raise AssertionError(f"{label}: the eager engine must serve MoE one "
                             f"sequence a call, the compiled one batch rows")
    tokens = {f"{d}_{n}": [e.result(i) for i in range(len(prompts))]
              for (d, n), (e, _) in runs.items()}
    rows = {f"{d}_{n}": round_rows(r) for (d, n), (_, r) in runs.items()}
    if len({json.dumps(t) for t in tokens.values()}) != 1:
        raise AssertionError(f"{label}: tokens differ {tokens}")
    for a, c in (("cpu_eager", "cuda_eager"),
                 ("cpu_compiled", "cuda_compiled"),
                 ("cuda_eager", "cuda_compiled")):
        if rows[a] != rows[c]:
            raise AssertionError(f"{label}: counters {a} and {c} differ "
                                 f"from round "
                                 f"{first_difference(rows[a], rows[c])}")
    if sum(r["h2d_bytes"] for r in rows["cuda_eager"]) <= 0:
        raise AssertionError(f"{label}: the budget did not page")
    if (comp.decode_compile_count, comp.padded_slots) != (1, 4):
        raise AssertionError(f"{label}: {comp.decode_compile_count} decode "
                             f"graphs at {comp.padded_slots} slots")
    out = dict(phase=label, config=cfg.name, layers=cfg.num_layers,
               dtype="float32", window=cfg.sliding_window,
               experts=[cfg.n_experts, cfg.top_k], prompts=list(lens),
               new_tokens=new, horizon=horizon, device_budget_bytes=budget,
               tokens=tokens["cuda_compiled"], tokens_identical=True,
               counters_identical_cpu_cuda=True,
               counters_compiled_equal_eager=True, k2=k2,
               padded_slots=comp.padded_slots)
    del runs, eager, comp
    # training: the runtime and the eager trainer, CPU against card
    b, s, steps = 2, 128, 3
    nxt = make_batch_fn(cfg, b, s)
    batches = [{key: val for key, val in nxt().items() if key != "mask"}
               for _ in range(steps)]
    layers = cfg.num_layers
    cpu_rt = rt_make(cfg, 1, "cpu", **RT_OPTIONS)
    _, _, cm = rt_train(cpu_rt, params, batches)
    gpu_rt = rt_make(cfg, 1, "cuda", **RT_OPTIONS)
    fa.launches = fa.bwd_launches = ka.launches = 0
    _, _, gm = rt_train(gpu_rt, params, batches)
    torch.cuda.synchronize()
    rt_launches = dict(fwd=fa.launches, bwd=fa.bwd_launches,
                       adam=ka.launches)
    rt_plan = dict(fwd=2 * layers * steps, bwd=layers * steps,
                   adam=rt_k1_plan(gpu_rt) * steps)
    if rt_launches != rt_plan:
        raise AssertionError(f"{label}: runtime launches {rt_launches}, the "
                             f"plan implies {rt_plan}")
    rt_rel = [abs(c["loss"] - g["loss"]) / abs(c["loss"]) for c, g in
              zip(cm, gm, strict=True)]
    aux_rel = [abs(c["aux_loss"] - g["aux_loss"]) / abs(c["aux_loss"])
               for c, g in zip(cm, gm)]
    if max(rt_rel) > 1e-4 or max(aux_rel) > 1e-4:
        raise AssertionError(f"{label}: runtime losses cpu "
                             f"{[c['loss'] for c in cm]} cuda "
                             f"{[g['loss'] for g in gm]}, aux rel {aux_rel}")
    cmap = chunk_plan(cfg)
    tbudget = margin_budget(cmap, b * s * cfg.d_model * 4, groups=1,
                            group="moe_layers")
    tkw = dict(device_memory_bytes=tbudget, policy="opt", prefetch=True,
               lr=1e-3)
    cpu, cpu_steps = train(cfg, params, batches, device="cpu", **tkw)
    fa.launches = fa.bwd_launches = ka.launches = 0
    gpu, gpu_steps = train(cfg, params, batches, device="cuda", **tkw)
    torch.cuda.synchronize()
    tr_launches = dict(fwd=fa.launches, bwd=fa.bwd_launches,
                       adam=ka.launches)
    dev = device_chunks(gpu)
    tr_plan = dict(fwd=2 * layers * steps, bwd=layers * steps,
                   adam=dev * (steps - 1))
    if tr_launches != tr_plan or dev < 1:
        raise AssertionError(f"{label}: trainer launches {tr_launches}, the "
                             f"plan implies {tr_plan}")
    tr_rel = []
    for i, (a, c) in enumerate(zip(cpu_steps, gpu_steps, strict=True)):
        ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
        cc = {f: getattr(c, f) for f in TRAIN_COUNTERS}
        tr_rel.append(abs(a.loss - c.loss) / abs(a.loss))
        if ca != cc or tr_rel[-1] > 1e-4:
            raise AssertionError(f"{label}: trainer step {i} loss cpu "
                                 f"{a.loss} cuda {c.loss}, counters cpu "
                                 f"{ca} cuda {cc}")
    out.update(
        train_batch=[b, s], train_steps=steps,
        runtime=dict(losses_cuda=[g["loss"] for g in gm],
                     aux_cuda=[g["aux_loss"] for g in gm],
                     max_rel_loss_diff=max(rt_rel),
                     max_rel_aux_diff=max(aux_rel), launches=rt_launches,
                     planned=rt_plan),
        trainer=dict(losses_cuda=[c.loss for c in gpu_steps],
                     max_rel_loss_diff=max(tr_rel), launches=tr_launches,
                     planned=tr_plan, device_budget_bytes=tbudget,
                     os_device_chunks=dev, counters_identical=True))
    emit(out)
    return out


def moe_parity_phase() -> dict:
    """mixtral-8x7b at full width (4096 wide, 8 experts of 14336, GQA
    32/8, window 4096), cut to 2 layers, fp32, on the eager serving
    engine: two prompts of 16 tokens (64 before the tensor-parallel
    phases joined, 32 before the SSM layers' tensor parallelism joined)
    and 2 new tokens (4 before zamba's
    phases joined: every round streams the fp32 layers) on the CPU and on
    the card under a budget that pages, tokens and counters identical, K2
    as planned (one sequence a call).  A chunk is 2^29 fp32 elements (2
    GiB): it holds the largest tensor, [8, 4096, 14336] (469.8 M), and is
    exactly the pinned allocator's block."""
    from repro_torch.configs import get_config

    cfg = get_config("mixtral-8x7b").replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    params = card_params(cfg)
    # prompts of 16 (64 before the tensor-parallel phases joined, 32
    # before the SSM ones: cut for the script's time limit, the CPU's
    # fp32 expert products)
    return parity_phase("mixtral-8x7b", (16, 16), 2, label="moe_parity",
                        params=params, chunk_size=MIXTRAL_CHUNK)


def params_mixtral_phase() -> dict:
    """mixtral-8x7b's weights at full width, ``MIXTRAL_SERVE_LAYERS``
    deep (bf16, drawn on the card from seed 0), made once for
    train_mixtral (its first ``MIXTRAL_TRAIN_LAYERS``) and serve_mixtral."""
    from repro_torch.configs import get_config

    return card_params(get_config("mixtral-8x7b").replace(
        num_layers=MIXTRAL_SERVE_LAYERS))


def cut_layers(params, layers: int) -> dict:
    from repro_torch.models.api import tree_map

    return dict(params, groups={
        name: tree_map(lambda t: t[:layers], g)
        for name, g in params["groups"].items()})


def train_mixtral_phase(params) -> dict:
    """mixtral-8x7b at full width, ``MIXTRAL_TRAIN_LAYERS`` deep, on the
    eager engine (the paper's Listing 1 path): bf16 compute, batch 1 x
    8192 (the window cut is active: rows past 4096 see 4096 keys), OPT,
    prefetch, the act stream and placement, a warm-up step,
    ``ZOO_TRAIN_STEPS - 1`` timed step and a profiled one, under a 16
    GiB device budget against ~24 GB of
    chunked model data a layer.  A chunk is 2^29 fp32 elements (2 GiB, the pinned block): three
    a layer a stream.  The peak's limit, written down before the first
    run: budget + stem + 2 x the fp32 logits + 1 GiB + twelve fp32
    [E, C, f] buffers (one layer's saved MoE intermediates, ~8 of them at
    fp32 payloads, and the backward's in flight).  If the host cannot
    hold the pinned tier the depth is cut to 1 layer, and the cut is
    printed."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import flatten_with_paths

    cfg = get_config("mixtral-8x7b")
    budget = 16 * GIB
    b, s = 1, 8192
    release_host_memory()
    mem = meminfo()
    chunk_bytes = MIXTRAL_CHUNK * 4
    act_block = pinned_block(b * s * cfg.d_model * 4)

    def host_need(layers: int) -> int:
        chunks = chunk_plan(cfg.replace(num_layers=layers),
                            chunk_size=MIXTRAL_CHUNK).num_chunks
        weights = sum(t.numel() * t.element_size() for _, t in
                      flatten_with_paths(cut_layers(params, layers)))
        return (chunk_bytes * max(0, 4 * chunks - budget // chunk_bytes)
                + layers * act_block + weights + 4 * GIB)

    layers = MIXTRAL_TRAIN_LAYERS
    while layers > 1 and host_need(layers) > mem["MemAvailable"]:
        layers -= 1
    cut = (None if layers == MIXTRAL_TRAIN_LAYERS else
           f"{MIXTRAL_TRAIN_LAYERS} -> {layers} layers: the host holds "
           f"{mem['MemAvailable']} bytes, the pinned tier needs "
           f"{host_need(MIXTRAL_TRAIN_LAYERS)}")
    emit(dict(phase="train_mixtral_host", meminfo=mem, layers=layers,
              host_need_bytes=host_need(layers), depth_cut=cut))
    cfg = cfg.replace(num_layers=layers)
    capacity = int(b * s * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    moe_bytes = 12 * 4 * cfg.n_experts * capacity * cfg.d_ff_expert
    out = train_slice_phase(cfg, cut_layers(params, layers), budget=budget,
                            label="train_mixtral", chunk_size=MIXTRAL_CHUNK,
                            batch=(b, s), extra_limit=moe_bytes,
                            need_device_adam=False,
                            steps=ZOO_TRAIN_STEPS)
    timed = out["steps_detail"][1:]
    busy = out["profiled_step"].get("device_busy_share")
    summary = dict(
        phase="train_mixtral_summary", layers=layers, d_model=cfg.d_model,
        experts=[cfg.n_experts, cfg.top_k, cfg.d_ff_expert],
        window=cfg.sliding_window, batch=[b, s], depth_cut=cut,
        depth_cut_reason="46.6 B params (186 GB fp32) do not fit a host "
        "of ~96 GB; 1 layer holds ~24 GB of chunked model data (2 did "
        "until deepseek-v2-lite's phases took the script's time)",
        tokens_per_s=out["post_warmup_tokens_per_s"],
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"], moe_limit_bytes=moe_bytes,
        idle_share=None if busy is None else 1 - busy,
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        os_device_chunks=out["os_device_chunks"],
        os_host_chunks=out["os_host_chunks"],
        model_data_bytes=out["model_data_bytes"], chunk_bytes=chunk_bytes)
    emit(summary)
    return dict(out, summary=summary)


def serve_mixtral_phase(params) -> dict:
    """mixtral-8x7b at full width, ``MIXTRAL_SERVE_LAYERS`` deep (2 layers
    are a 12.8 GB fp32 param stream, stem and KV on top), bf16 compute, the slice's requests (prompts
    512/512/500/500, 16 new tokens, horizon 1024) under 8 GiB: the eager
    ``ServingEngine`` (one sequence a call: K2 as planned, paging both
    ways, the peak) and the ``CompiledServingEngine`` (cohorts of one, as
    the eager engine's, and the decode graph over 4 slots routing each on
    its own): its counters equal the eager engine's, K2 calls as planned,
    one graph; tokens may differ only where the compiled engine's bf16
    tensor-core GEMMs flip a near-tie against the eager engine's fp32
    payloads, and which do is reported.  The param stream packs layer
    after layer, so a layer straddles four chunks and the floor is four
    chunks and two kv chunks: a chunk of 2^29 - 2^21 fp32 elements keeps
    it within 8 GiB (the engine's search, ~998 M, would need 11.2 GiB)
    and fills a 2 GiB pinned block."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config("mixtral-8x7b").replace(num_layers=MIXTRAL_SERVE_LAYERS)
    budget = 8 * GIB
    cap = int(512 * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    moe_bytes = 12 * 4 * cfg.n_experts * cap * cfg.d_ff_expert
    sl = slice_phase(cfg, params, budget=budget, label="serve_mixtral_eager",
                     chunk_size=MIXTRAL_SERVE_CHUNK, extra_limit=moe_bytes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (512, 512, 500, 500)]
    label = "serve_mixtral compiled"
    r = compiled_run(cfg, params, prompts, budget, profile_round=8,
                     chunk_size=MIXTRAL_SERVE_CHUNK, max_prefill_batch=1)
    eng, rounds = r["eng"], r["rounds"]
    calls = k2_calls(eng)
    planned = k2_plan(cfg, rounds)
    if calls["total"] != planned:
        raise AssertionError(f"{label}: K2 calls {calls}, the plan implies "
                             f"{planned}")
    if (eng.decode_compile_count, eng.padded_slots) != (1, 4):
        raise AssertionError(f"{label}: {eng.decode_compile_count} decode "
                             f"graphs at {eng.padded_slots} slots")
    rows = round_rows(rounds)
    if rows != sl["round_counters"]:
        raise AssertionError(f"{label}: counters differ from the eager "
                             f"engine's from round "
                             f"{first_difference(sl['round_counters'], rows)}")
    store_bytes = sum(t.numel() * t.element_size()
                      for t in eng._pstores.values())
    slot_bytes = sum(t.numel() * t.element_size()
                     for tree in eng._slot_caches.values()
                     for t in tree.values())
    limit = (r["at_start"] + budget + eng.stem_bytes + store_bytes
             + slot_bytes + GIB + moe_bytes)
    if r["peak"] > limit:
        raise AssertionError(f"{label}: max_memory_allocated {r['peak']} > "
                             f"{limit}")
    toks = [eng.result(i) for i in range(len(prompts))]
    if any(len(t) != 16 or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        raise AssertionError(f"{label}: tokens {toks}")
    prof = dict(device_time_breakdown(r["prof"], r["prof_wall"],
                                      kinds=RT_KINDS),
                top_kernels=top_kernels(r["prof"]))
    eager_toks = sl["tokens"]
    comp = dict(
        device_budget_bytes=budget, setup_s=r["setup_s"], rounds=len(rounds),
        tokens=toks, round_counters=rows,
        round_wall_s=[m.wall_s for m in rounds],
        round_decode_s=[t["decode_s"] for t in eng.round_times],
        round_prefill_s=[t["prefill_s"] for t in eng.round_times],
        round_replay_s=[t["replay_s"] for t in eng.round_times],
        graph_replay_device_ms=eng.decode_graph.device_ms,
        graph_warmup_s=eng.decode_graph.warmup_s,
        h2d_bytes=sum(m.h2d_bytes for m in rounds),
        d2h_bytes=sum(m.d2h_bytes for m in rounds),
        **tok_rates(rounds, eng.round_times), k2=calls, k2_planned=planned,
        padded_slots=eng.padded_slots, max_memory_allocated=r["peak"],
        memory_limit=limit, store_bytes=store_bytes,
        slot_cache_bytes=slot_bytes, counters_equal_eager=True,
        prefill_tokens_equal_eager=[t[0] == e[0]
                                    for t, e in zip(toks, eager_toks)],
        decode_tokens_equal_eager=[t[1:] == e[1:]
                                   for t, e in zip(toks, eager_toks)],
        profiled_round=8, profiled_round_device=prof)
    del r, eng
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(
        phase="serve_mixtral_summary", layers=cfg.num_layers,
        depth_cut_reason="46.6 B params do not fit the host; 2 layers are "
        "a 12.8 GB fp32 param stream (4 were until deepseek-v2-lite's "
        "phases took the script's time)",
        param_stream_bytes=sl["param_stream_bytes"],
        param_chunk_bytes=sl["param_chunk_bytes"],
        eager=dict(prefill_tok_per_s=sl["prefill_tok_per_s"],
                   decode_tok_per_s=sl["decode_tok_per_s"],
                   h2d_bytes=sl["h2d_bytes"], d2h_bytes=sl["d2h_bytes"],
                   bytes_a_round=[c["h2d_bytes"] + c["d2h_bytes"]
                                  for c in sl["round_counters"]],
                   max_memory_allocated=sl["max_memory_allocated"],
                   memory_limit=sl["memory_limit"],
                   k2_launches=sl["k2_launches"]),
        compiled=comp)
    emit(summary)
    return dict(summary, k2_eager=sl["k2_launches"],
                k2_compiled=calls["total"])


# ------------------------------------------------ deepseek-v2-lite-16b
DSV2 = "deepseek-v2-lite-16b"
# K2 at MLA's head dims: q/k 192 (qk_nope 128 + qk_rope 64), values 128
MLA_CASES = [
    # the training shape (B=2, S=4096, deepseek-v2-lite's 16 heads) and
    # the eager engine's prefill of one 512-token prompt
    dict(name="mla_train", shape=(2, 4096, 16, 16), causal=True),
    dict(name="mla_prefill", shape=(1, 512, 16, 16), causal=True),
]
MLA_D, MLA_DV = 192, 128
# depth: one dense layer and this many MoE layers (3 and 7 before
# zamba2-1.2b's phases joined: cut for the script's time limit)
DSV2_TRAIN_MOE = 2   # train_dsv2: 3 layers, 1.24 B params
DSV2_SERVE_MOE = 5   # serve_dsv2: 6 layers, a 12.2 GB fp32 param stream


def sdpa_yardstick(q, k, v, causal: bool):
    """``scaled_dot_product_attention`` on the same inputs ([B,H,S,D]
    views), the library's yardstick: the first fused backend that takes
    Dv != D (flash, cuDNN, memory-efficient), forward and backward; if
    none does, V zero-padded to D (the output's first Dv columns are the
    same function).  Returns (backend name, fwd(), fwd_bwd(do))."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def calls(backend, vv, name):
        def fwd():
            with torch.no_grad(), sdpa_kernel(backend):
                F.scaled_dot_product_attention(qt, kt, vv, is_causal=causal)

        def fwd_bwd(do):
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qt, kt, vv,
                                                     is_causal=causal)
            # a padded V's output gets the gradient padded with zeros
            torch.autograd.grad(out, (qt, kt, vv), F.pad(
                do, (0, out.shape[-1] - do.shape[-1])))
        return name, fwd, fwd_bwd

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        name, fwd, fwd_bwd = calls(backend, vt, backend.name)
        try:
            fwd()
            fwd_bwd(torch.zeros_like(qt[..., :v.shape[-1]]))
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return name, fwd, fwd_bwd
    vp = F.pad(vt.detach(), (0, q.shape[-1] - v.shape[-1])).requires_grad_()
    return calls(SDPBackend.EFFICIENT_ATTENTION, vp,
                 "EFFICIENT_ATTENTION, V zero-padded to D")


def mla_kernels_phase(ptxas: dict) -> dict:
    """K2 at MLA's head dims (q/k 192, values 128) against its plain
    version at deepseek-v2-lite's training shape (B=2, S=4096, H=16,
    causal) and its eager prefill (B=1, S=512), bf16 (``tc``) and fp32
    (``tf32x3``): the forward with its lse, and the backward through the
    autograd function, against the plain backward fed the plain forward's
    o and lse (``TOL``/``REL_TOL``, lse 1e-4); each timed beside the plain
    version and SDPA (the backend that ran named), with its bound from
    the (192, 128) flop and byte counts, its TFLOP/s and ptxas's
    registers for the pair's instances (any spill raises)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    regs = {src: {name: row for name, row in rep.items()
                  if f"Li{MLA_D}ELi{MLA_DV}E" in name}
            for src, rep in ptxas.items()}
    if any(row.get("spill_bytes", 0) for rep in regs.values()
           for row in rep.values()) or not all(regs.values()):
        raise AssertionError(f"mla_kernels: the (192, 128) instances are "
                             f"missing or spill: {regs}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    scale = 1.0 / math.sqrt(MLA_D)
    results = {}
    for case in MLA_CASES:
        b, s, h, kv = case["shape"]
        causal = case["causal"]
        for dtype in BOTH:
            dt = getattr(torch, dtype)
            label = f"mla_kernels {case['name']} {dtype}"

            def rand(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)
            q, k = rand(b, s, h, MLA_D), rand(b, s, kv, MLA_D)
            v, do = rand(b, s, kv, MLA_DV), rand(b, s, h, MLA_DV)
            kw = dict(causal=causal, scale=scale)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            o_ref, lse_ref = fa.plain(q, k, v, return_lse=True, **kw)
            o_err = (o.float() - o_ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            o_rel = ((o.float() - o_ref.float()).norm()
                     / o_ref.float().norm()).item()
            if not (math.isfinite(o_err) and o_err <= TOL[dtype]
                    and math.isfinite(lse_err) and lse_err <= LSE_TOL):
                raise AssertionError(f"{label}: output error {o_err} (tol "
                                     f"{TOL[dtype]}), lse {lse_err}")
            want = fa.plain_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            del o_ref, lse_ref
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            got = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                      leaves, do)
            del leaves
            torch.cuda.synchronize()
            grads = grad_errors(label, got, want, dtype)
            del got, want
            backend, sdpa_fwd, sdpa_fwd_bwd = sdpa_yardstick(q, k, v,
                                                             causal)
            dot = do.transpose(1, 2)
            fp32 = dtype == "float32"
            iters = 5 if fp32 or s > 1024 else 20
            # the training launch keeps the lse; the prefill's does not
            with_lse = case["name"] == "mla_train"

            def fwd():
                fa.flash_attention_cuda(q, k, v, return_lse=with_lse, **kw)

            def bwd():
                fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)

            def sdpa_bwd():
                return time_ms(lambda: sdpa_fwd_bwd(dot), iters) - \
                    time_ms(sdpa_fwd, iters)

            ms, lib_ms, turns = time_pair(fwd, sdpa_fwd, iters)
            bturns = [time_ms(bwd, iters), sdpa_bwd(), sdpa_bwd(),
                      time_ms(bwd, iters)]
            plain_iters = 2 if s > 1024 else 5
            fbound = attention_bound(dict(
                shape=(b, s, s, h, kv, MLA_D), dv=MLA_DV, dtype=dtype,
                causal=causal))
            bbound = attention_bwd_bound((b, s, h, kv, MLA_D), dtype,
                                         causal, dv=MLA_DV)
            fwd_row = dict(
                case=case["name"], dtype=dtype, head_dims=[MLA_D, MLA_DV],
                shape=[b, s, s, h, kv, MLA_D], causal=causal,
                schedule=fa.plan_forward(b, s, s, h, dt, causal=causal,
                                         head_dims=(MLA_D, MLA_DV)).schedule,
                with_lse=with_lse, max_abs_err=o_err, rel_err=o_rel,
                lse_max_abs_err=lse_err, ms=ms, device_ms=device_ms(
                    fwd, iters), plain_ms=time_ms(lambda: fa.plain(
                        q, k, v, **kw), plain_iters),
                library_ms=lib_ms, library=f"SDPA {backend}",
                times_kernel_lib_lib_kernel=turns,
                tflops=fbound["flops"] / (ms * 1e-3) / 1e12,
                registers=regs[fa.SOURCE], **fbound)
            bms = (bturns[0] + bturns[3]) / 2
            bwd_row = dict(
                case=case["name"], dtype=dtype, head_dims=[MLA_D, MLA_DV],
                shape=[b, s, h, kv, MLA_D], causal=causal,
                schedule=fa.plan_backward(dt), grads=grads,
                max_abs_err=max(r["max_abs_err"] for r in grads.values()),
                rel_err=max(r["rel_err"] for r in grads.values()),
                ms=bms, device_ms=device_ms(bwd, iters),
                plain_ms=time_ms(lambda: fa.plain_bwd(q, k, v, o, lse, do,
                                                      **kw), plain_iters),
                library_ms=(bturns[1] + bturns[2]) / 2,
                library=f"SDPA {backend} (forward + backward - forward)",
                times_kernel_lib_lib_kernel=bturns,
                tflops=bbound["flops"] / (bms * 1e-3) / 1e12,
                registers=regs[fa.BWD_SOURCE], **bbound)
            emit({"phase": "mla_kernels", "kernel": "flash_attention_fwd",
                  **fwd_row})
            emit({"phase": "mla_kernels", "kernel": "flash_attention_bwd",
                  **bwd_row})
            results[("fwd", case["name"], dtype)] = fwd_row
            results[("bwd", case["name"], dtype)] = bwd_row
            del q, k, v, do, o, lse, dot
            torch.cuda.empty_cache()
    return results


def params_dsv2_phase() -> dict:
    """deepseek-v2-lite-16b's weights at full width (bf16, drawn on the
    card from seed 0): the dense layer and ``DSV2_SERVE_MOE`` MoE layers,
    made once for train_dsv2 (the dense layer and the first
    ``DSV2_TRAIN_MOE``) and serve_dsv2."""
    from repro_torch.configs import get_config

    return card_params(get_config(DSV2).replace(
        num_layers=1 + DSV2_SERVE_MOE))


def moe_buffer_bytes(cfg, tokens: int) -> int:
    """Twelve fp32 [E, C, f] buffers at ``tokens`` tokens a call: one MoE
    layer's saved intermediates at fp32 payloads and the backward's in
    flight (mixtral's measure); with a leading dense layer, four fp32
    [tokens, d_ff] buffers of its MLP beside them."""
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    out = 12 * 4 * cfg.n_experts * cap * cfg.d_ff_expert
    if cfg.first_dense_layers:
        out += 4 * 4 * tokens * cfg.d_ff
    return out


def dsv2_parity_config():
    from repro_torch.configs import get_config

    return get_config(DSV2).replace(num_layers=2, param_dtype="float32",
                                    compute_dtype="float32")


def dsv2_parity_phase() -> dict:
    """deepseek-v2-lite-16b at full width, 2 layers (the dense layer with
    GQA at head dim 128 and one MoE layer with MLA, 64 experts top-6 and 2
    shared; 0.88 B params with the stem), fp32: served on the CPU and on
    the card (parity's checks: tokens and per-round counters identical,
    K2 as planned by head-dim pair: MLA prefills at (192, 128) and decodes
    without K2), then ``ChunkedRuntime`` 1 step and ``PatrickStarEngine``
    2 steps of 1 x 64 tokens (both 3 before zamba's phases joined, the
    runtime 2 before xlstm's; 128 tokens before the SSM layers' tensor
    parallelism joined, for the script's time limit), CPU against
    card: losses within 1e-4 relative (the runtime's against the CPU
    trainer's first loss, :func:`rt_oracle`: the CPU runtime's own step
    took ~20 s), launches as planned by pair."""
    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    label = "dsv2_parity"
    cfg = dsv2_parity_config()
    params = card_params(cfg)
    # 2 new tokens (4 until nemotron-4-340b's phases joined: cut for the
    # script's time limit)
    out = parity_phase(DSV2, (64, 64), 2, label="dsv2_parity_serving",
                       params=params)
    b, s, steps, rt_steps = 1, 64, 2, 1
    batches, tkw = parity_train_setup(cfg, b, s, steps, "moe_layers")
    tbudget = tkw["device_memory_bytes"]
    by_pair = k2_layers(cfg)

    def pairs_plan_of(n):
        return dict(fwd={k: 2 * m * n for k, m in by_pair.items()},
                    bwd={k: m * n for k, m in by_pair.items()})

    pairs_plan = pairs_plan_of(steps)

    def reset():
        fa.launches = fa.bwd_launches = ka.launches = 0
        fa.pair_launches.clear()
        fa.bwd_pair_launches.clear()

    def counts():
        torch.cuda.synchronize()
        return (dict(fwd=fa.launches, bwd=fa.bwd_launches,
                     adam=ka.launches),
                dict(fwd=dict(fa.pair_launches),
                     bwd=dict(fa.bwd_pair_launches)))

    layers = cfg.num_layers
    oracle = ORACLES.result(label, lambda: oracle_train(
        cfg, params, batches, tkw))
    cpu_steps = oracle["steps"]
    cm = rt_oracle(cpu_steps, rt_steps)
    gpu_rt = rt_make(cfg, 1, "cuda", **RT_OPTIONS)
    reset()
    _, _, gm = rt_train(gpu_rt, params, batches[:rt_steps])
    rt_launches, rt_pairs = counts()
    rt_plan = dict(fwd=2 * layers * rt_steps, bwd=layers * rt_steps,
                   adam=rt_k1_plan(gpu_rt) * rt_steps)
    del gpu_rt
    if rt_launches != rt_plan or rt_pairs != pairs_plan_of(rt_steps):
        raise AssertionError(f"{label}: runtime launches {rt_launches} "
                             f"({rt_pairs}), the plan implies {rt_plan} "
                             f"({pairs_plan_of(rt_steps)})")
    rt_rel = [abs(c["loss"] - g["loss"]) / abs(c["loss"]) for c, g in
              zip(cm, gm, strict=True)]
    if max(rt_rel) > 1e-4:
        raise AssertionError(f"{label}: runtime losses cpu "
                             f"{[c['loss'] for c in cm]} cuda "
                             f"{[g['loss'] for g in gm]}")
    reset()
    gpu, gpu_steps = train(cfg, params, batches, device="cuda", **tkw)
    tr_launches, tr_pairs = counts()
    dev = device_chunks(gpu)
    del gpu
    tr_plan = dict(fwd=2 * layers * steps, bwd=layers * steps,
                   adam=dev * (steps - 1))
    if tr_launches != tr_plan or tr_pairs != pairs_plan or dev < 1:
        raise AssertionError(f"{label}: trainer launches {tr_launches} "
                             f"({tr_pairs}), the plan implies {tr_plan} "
                             f"({pairs_plan})")
    tr_rel = []
    for i, (a, c) in enumerate(zip(cpu_steps, gpu_steps, strict=True)):
        ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
        cc = {f: getattr(c, f) for f in TRAIN_COUNTERS}
        tr_rel.append(abs(a.loss - c.loss) / abs(a.loss))
        if ca != cc or tr_rel[-1] > 1e-4:
            raise AssertionError(f"{label}: trainer step {i} loss cpu "
                                 f"{a.loss} cuda {c.loss}, counters cpu "
                                 f"{ca} cuda {cc}")
    out = dict(
        out, phase=label, mla=dict(kv_lora_rank=cfg.kv_lora_rank,
                                   qk=[cfg.qk_nope_dim, cfg.qk_rope_dim],
                                   v_head_dim=cfg.v_head_dim),
        experts=[cfg.n_experts, cfg.top_k, cfg.n_shared_experts],
        train_batch=[b, s], train_steps=steps, runtime_steps=rt_steps,
        runtime=dict(losses_cpu=[c["loss"] for c in cm],
                     oracle="the CPU trainer's first loss",
                     losses_cuda=[g["loss"] for g in gm],
                     max_rel_loss_diff=max(rt_rel), launches=rt_launches,
                     planned=rt_plan),
        trainer=dict(losses_cpu=[a.loss for a in cpu_steps],
                     losses_cuda=[c.loss for c in gpu_steps],
                     max_rel_loss_diff=max(tr_rel), launches=tr_launches,
                     planned=tr_plan, device_budget_bytes=tbudget,
                     os_device_chunks=dev, counters_identical=True,
                     cpu_s=oracle["cpu_s"]),
        oracle=ORACLES.row(label),
        k2_train_by_head_dims={k: pairs_row(v) for k, v in
                               pairs_plan.items()})
    emit(out)
    return out


def train_dsv2_phase(params) -> dict:
    """deepseek-v2-lite-16b at full width, 3 layers (the dense one and
    ``DSV2_TRAIN_MOE`` MoE layers: 1.24 B params, 5.0 GB fp32, with m and
    v ~22 GB), on the eager engine: bf16 compute, batch 2 x 4096, OPT,
    prefetch, the act stream and placement, a warm-up step,
    ``ZOO_TRAIN_STEPS - 1`` timed step and a profiled one, under an 8
    GiB device budget.  The chunk is the
    engine's own search; it must hold one layer's routed experts
    [64, 2048, 1408] (184.5 M elements).  The peak's limit, written down
    before the first run: budget + stem + 2 x the fp32 logits + 1 GiB +
    :func:`moe_buffer_bytes` at 8192 tokens.  If the host cannot hold the
    pinned tier the MoE depth is cut, and the cut is printed."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import flatten_with_paths

    cfg = get_config(DSV2)
    budget = 8 * GIB
    b, s = 2, 4096
    release_host_memory()
    mem = meminfo()
    act_block = pinned_block(b * s * cfg.d_model * 4)

    def host_need(moe: int) -> int:
        plan = chunk_plan(cfg.replace(num_layers=1 + moe))
        block = pinned_block(plan.chunk_size * 4)
        weights = sum(t.numel() * t.element_size() for _, t in
                      flatten_with_paths(cut_layers(params, moe)))
        return (block * max(0, 4 * plan.num_chunks - budget // block)
                + (1 + moe) * act_block + weights + 4 * GIB)

    moe = DSV2_TRAIN_MOE
    while moe > 1 and host_need(moe) > mem["MemAvailable"]:
        moe -= 1
    cut = (f"27 -> {1 + moe} layers: the script's time limit" + (
        "" if moe == DSV2_TRAIN_MOE else f"; the host holds "
        f"{mem['MemAvailable']} bytes, the pinned tier needs "
        f"{host_need(DSV2_TRAIN_MOE)}"))
    emit(dict(phase="train_dsv2_host", meminfo=mem, layers=1 + moe,
              host_need_bytes=host_need(moe), depth_cut=cut))
    cfg = cfg.replace(num_layers=1 + moe)
    out = train_slice_phase(cfg, cut_layers(params, moe), budget=budget,
                            label="train_dsv2", batch=(b, s),
                            extra_limit=moe_buffer_bytes(cfg, b * s),
                            need_device_adam=False,
                            steps=ZOO_TRAIN_STEPS)
    largest = cfg.n_experts * cfg.d_model * cfg.d_ff_expert
    if out["chunk_bytes"] < 4 * largest:
        raise AssertionError(f"train_dsv2: a chunk of {out['chunk_bytes']} "
                             f"bytes cannot hold the [64, 2048, 1408] "
                             f"experts ({4 * largest} bytes)")
    timed = out["steps_detail"][1:]
    busy = out["profiled_step"].get("device_busy_share")
    summary = dict(
        phase="train_dsv2_summary", layers=cfg.num_layers,
        d_model=cfg.d_model,
        experts=[cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
                 cfg.d_ff_expert],
        batch=[b, s], depth_cut=cut,
        tokens_per_s=out["post_warmup_tokens_per_s"],
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"],
        idle_share=None if busy is None else 1 - busy,
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k2_by_head_dims=out["k2_by_head_dims"],
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        os_device_chunks=out["os_device_chunks"],
        os_host_chunks=out["os_host_chunks"],
        model_data_bytes=out["model_data_bytes"],
        chunk_bytes=out["chunk_bytes"], largest_tensor_elems=largest)
    emit(summary)
    return dict(out, summary=summary)


def serve_dsv2_phase(params) -> dict:
    """deepseek-v2-lite-16b at full width, 6 layers (the dense one and
    ``DSV2_SERVE_MOE`` MoE layers: a 12.2 GB fp32 param stream), bf16
    compute, the slice's requests (prompts 512/512/500/500, 16 new tokens,
    horizon 1024): the eager ``ServingEngine`` under 8 GiB (one sequence a
    call: K2 as planned by head-dim pair, paging both ways, the peak), the
    ``CompiledServingEngine`` under 8 GiB with prefill cohorts of one (its
    counters equal the eager engine's, K2 calls as planned: the graph's
    decode holds the dense layer's split-kv call only, MLA decoding over
    its latent cache) and under the smallest whole GiB that holds the
    param stream and every sequence's KV; prefill and decode tokens/s and
    the round wall split."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(DSV2).replace(num_layers=1 + DSV2_SERVE_MOE)
    budget = 8 * GIB
    moe_bytes = moe_buffer_bytes(cfg, 512)
    sl = slice_phase(cfg, params, budget=budget, label="serve_dsv2_eager",
                     extra_limit=moe_bytes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (512, 512, 500, 500)]
    kv_bytes = sl["kv_chunk_bytes"] * 4 * cfg.num_layers  # a (seq, layer)
    fit = -(-(sl["param_stream_bytes"] + kv_bytes) // GIB) * GIB
    runs = {}
    for key, bud in (("8gib", budget), (f"{fit // GIB}gib", fit)):
        label = f"serve_dsv2 compiled {key}"
        r = compiled_run(cfg, params, prompts, bud, profile_round=8,
                         max_prefill_batch=1)
        eng, rounds = r["eng"], r["rounds"]
        calls = k2_calls(eng)
        planned = k2_plan(cfg, rounds)
        if calls["total"] != planned or calls["graph_k2_calls"] != \
                decode_k2_layers(cfg):
            raise AssertionError(f"{label}: K2 calls {calls}, the plan "
                                 f"implies {planned} ("
                                 f"{decode_k2_layers(cfg)} a replay)")
        if (eng.decode_compile_count, eng.padded_slots) != (1, 4):
            raise AssertionError(f"{label}: {eng.decode_compile_count} "
                                 f"decode graphs at {eng.padded_slots} "
                                 f"slots")
        rows = round_rows(rounds)
        if bud == budget and rows != sl["round_counters"]:
            raise AssertionError(
                f"{label}: counters differ from the eager engine's from "
                f"round {first_difference(sl['round_counters'], rows)}")
        store_bytes = sum(t.numel() * t.element_size()
                          for t in eng._pstores.values())
        slot_bytes = sum(t.numel() * t.element_size()
                         for tree in eng._slot_caches.values()
                         for t in tree.values())
        limit = (r["at_start"] + bud + eng.stem_bytes + store_bytes
                 + slot_bytes + GIB + moe_bytes)
        if r["peak"] > limit:
            raise AssertionError(f"{label}: max_memory_allocated "
                                 f"{r['peak']} > {limit}")
        toks = [eng.result(i) for i in range(len(prompts))]
        if any(len(t) != 16 or not all(0 <= x < cfg.vocab_size for x in t)
               for t in toks):
            raise AssertionError(f"{label}: tokens {toks}")
        runs[key] = dict(
            device_budget_bytes=bud, setup_s=r["setup_s"],
            rounds=len(rounds), tokens=toks, round_counters=rows,
            **({"counters_equal_eager": True} if bud == budget else {}),
            round_wall_s=[m.wall_s for m in rounds],
            round_decode_s=[t["decode_s"] for t in eng.round_times],
            round_prefill_s=[t["prefill_s"] for t in eng.round_times],
            round_replay_s=[t["replay_s"] for t in eng.round_times],
            graph_replay_device_ms=eng.decode_graph.device_ms,
            graph_warmup_s=eng.decode_graph.warmup_s,
            h2d_bytes=sum(m.h2d_bytes for m in rounds),
            d2h_bytes=sum(m.d2h_bytes for m in rounds),
            **tok_rates(rounds, eng.round_times), k2=calls,
            k2_planned=planned, padded_slots=eng.padded_slots,
            max_memory_allocated=r["peak"], memory_limit=limit,
            store_bytes=store_bytes, slot_cache_bytes=slot_bytes,
            prefill_tokens_equal_eager=[t[0] == e[0] for t, e in
                                        zip(toks, sl["tokens"])],
            decode_tokens_equal_eager=[t[1:] == e[1:] for t, e in
                                       zip(toks, sl["tokens"])],
            profiled_round=8, profiled_round_device=dict(
                device_time_breakdown(r["prof"], r["prof_wall"],
                                      kinds=RT_KINDS),
                top_kernels=top_kernels(r["prof"])))
        del r, eng
        gc.collect()
        torch.cuda.empty_cache()
    summary = dict(
        phase="serve_dsv2_summary", layers=cfg.num_layers,
        depth_cut=f"27 -> {cfg.num_layers} layers: the script's time limit",
        param_stream_bytes=sl["param_stream_bytes"],
        param_chunk_bytes=sl["param_chunk_bytes"], kv_bytes=kv_bytes,
        fit_budget_bytes=fit,
        eager=dict(prefill_tok_per_s=sl["prefill_tok_per_s"],
                   decode_tok_per_s=sl["decode_tok_per_s"],
                   h2d_bytes=sl["h2d_bytes"], d2h_bytes=sl["d2h_bytes"],
                   max_memory_allocated=sl["max_memory_allocated"],
                   memory_limit=sl["memory_limit"],
                   k2_launches=sl["k2_launches"],
                   k2_by_head_dims=sl["k2_by_head_dims"]),
        compiled=runs)
    emit(summary)
    return dict(summary, k2_eager=sl["k2_launches"],
                k2_compiled={key: row["k2"]["total"]
                             for key, row in runs.items()})


# ------------------------------------------------------------- zamba2-1.2b
ZAMBA = "zamba2-1.2b"
# the compiled round serve_zamba and serve_xlstm profile: a decode round of
# their 8 (round 8 of 16 before whisper's phases cut their new tokens)
PROFILED_ROUND = 4
# zamba_parity's depth: one unit (6 mamba layers behind the shared block)
# and the 2-layer tail, so both block groups run
ZAMBA_PARITY_LAYERS = 8


def zamba_extra_bytes(cfg, tokens: int) -> int:
    """What a zamba unit's backward holds beside the trainer's budget (the
    eager trainer recomputes a whole unit, 6 mamba layers and the shared
    block, at a time): each mamba layer's twenty fp32 [tokens, d_inner]
    (projections, conv inputs and outputs, the scan's terms, the gate and
    the norm) and four fp32 [tokens, chunk_len, mamba_heads] (the
    intra-chunk decay, its exp and the weights), and ten fp32
    [tokens, d_ff] of the shared block's MLP."""
    layer = 4 * tokens * (20 * cfg.d_inner + 4 * cfg.chunk_len
                          * cfg.mamba_heads)
    return cfg.shared_interval * layer + 10 * 4 * tokens * cfg.d_ff


def zamba_parity_config():
    from repro_torch.configs import get_config

    return get_config(ZAMBA).replace(num_layers=ZAMBA_PARITY_LAYERS,
                                     param_dtype="float32",
                                     compute_dtype="float32")


def zamba_parity_phase() -> dict:
    """zamba2-1.2b at full width, ``ZAMBA_PARITY_LAYERS`` deep (one unit
    and the tail: 0.49 B params with the stem), fp32: served eagerly and
    compiled on the CPU and on the card (``compiled_parity_phase``'s
    checks, prefill cohorts of one as the eager engine prefills zamba; 3
    new tokens, 4 before xlstm's phases joined),
    then ``ChunkedRuntime`` 1 step (2 before xlstm's phases joined, for
    the script's time limit) and ``PatrickStarEngine`` 2 steps of 1 x 128
    tokens (two 64-token chunks of the scan), CPU against card: losses
    within 1e-5 relative (the runtime's against the CPU trainer's first
    loss, :func:`rt_oracle`), the trainer's counters identical, launches as planned, and the shared
    block's gradient (the stem gradient the trainer's first update
    takes, reached only through the extras) equal on both devices within
    1e-4 of its largest value, and not zero."""
    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    label = "zamba_parity"
    cfg = zamba_parity_config()
    params = card_params(cfg)
    serving = compiled_parity_phase(
        ZAMBA, ZAMBA_PARITY_LAYERS, (64, 64), 3,
        label="zamba_parity_serving", params=params, max_prefill_batch=1)
    b, s, steps, rt_steps = 1, 128, 2, 1
    batches, tkw = parity_train_setup(cfg, b, s, steps, "units")
    tbudget = tkw["device_memory_bytes"]
    attn = sum(k2_layers(cfg).values())

    def reset():
        fa.launches = fa.bwd_launches = ka.launches = 0

    def counts():
        torch.cuda.synchronize()
        return dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)

    # the step-1 gradient of the shared block, all units summed; the CPU
    # trainer's from the oracle process
    oracle = ORACLES.result(label, lambda: oracle_train(
        cfg, params, batches, tkw, "shared_attn"))
    cpu_steps, shared = oracle["steps"], {"cpu": oracle["stem"]}
    cm = rt_oracle(cpu_steps, rt_steps)
    gpu_rt = rt_make(cfg, 1, "cuda", **RT_OPTIONS)
    reset()
    _, _, gm = rt_train(gpu_rt, params, batches[:rt_steps])
    rt_launches = counts()
    rt_plan = dict(fwd=2 * attn * rt_steps, bwd=attn * rt_steps,
                   adam=rt_k1_plan(gpu_rt) * rt_steps)
    del gpu_rt
    if rt_launches != rt_plan:
        raise AssertionError(f"{label}: runtime launches {rt_launches}, "
                             f"the plan implies {rt_plan}")
    rt_rel = [abs(c["loss"] - g["loss"]) / abs(c["loss"]) for c, g in
              zip(cm, gm, strict=True)]
    if max(rt_rel) > 1e-5:
        raise AssertionError(f"{label}: runtime losses cpu "
                             f"{[c['loss'] for c in cm]} cuda "
                             f"{[g['loss'] for g in gm]}")
    reset()
    gpu, gpu_steps, shared["cuda"] = parity_trainer(
        cfg, params, batches, "cuda", tkw, "shared_attn")
    tr_launches = counts()
    dev = device_chunks(gpu)
    del gpu
    tr_plan = dict(fwd=2 * attn * steps, bwd=attn * steps,
                   adam=dev * (steps - 1))
    if tr_launches != tr_plan or dev < 1:
        raise AssertionError(f"{label}: trainer launches {tr_launches}, "
                             f"the plan implies {tr_plan}")
    tr_rel = []
    for i, (a, c) in enumerate(zip(cpu_steps, gpu_steps, strict=True)):
        ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
        cc = {f: getattr(c, f) for f in TRAIN_COUNTERS}
        tr_rel.append(abs(a.loss - c.loss) / abs(a.loss))
        if ca != cc or tr_rel[-1] > 1e-5:
            raise AssertionError(f"{label}: trainer step {i} loss cpu "
                                 f"{a.loss} cuda {c.loss}, counters cpu "
                                 f"{ca} cuda {cc}")
    grad_rows = {}
    for path, want in shared["cpu"].items():
        got = shared["cuda"][path]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        grad_rows[".".join(path)] = dict(max_abs=scale, max_abs_err=err)
        if not (scale > 0 and math.isfinite(err) and err <= 1e-4 * scale):
            raise AssertionError(f"{label}: shared block gradient {path}: "
                                 f"largest {scale}, card against CPU {err}")
    out = dict(
        phase=label, config=cfg.name, layers=cfg.num_layers,
        units=cfg.num_units, tail_layers=cfg.tail_layers,
        serving={key: serving[key] for key in (
            "tokens", "rounds", "k2", "k2_planned", "k2_eager_launches",
            "k2_eager_planned", "device_budget_bytes")},
        train_batch=[b, s], train_steps=steps, runtime_steps=rt_steps,
        runtime=dict(losses_cpu=[c["loss"] for c in cm],
                     oracle="the CPU trainer's first loss",
                     losses_cuda=[g["loss"] for g in gm],
                     max_rel_loss_diff=max(rt_rel), launches=rt_launches,
                     planned=rt_plan),
        trainer=dict(losses_cpu=[a.loss for a in cpu_steps],
                     losses_cuda=[c.loss for c in gpu_steps],
                     max_rel_loss_diff=max(tr_rel), launches=tr_launches,
                     planned=tr_plan, device_budget_bytes=tbudget,
                     os_device_chunks=dev, counters_identical=True,
                     cpu_s=oracle["cpu_s"]),
        oracle=ORACLES.row(label), shared_block_grad=grad_rows)
    emit(out)
    return out


def params_zamba_phase() -> dict:
    """zamba2-1.2b's weights at full depth and width (bf16, drawn on the
    card from seed 0), made once for train_zamba and serve_zamba."""
    from repro_torch.configs import get_config

    return card_params(get_config(ZAMBA))


def train_zamba_phase(params) -> dict:
    """zamba2-1.2b at full depth and width (38 Mamba2 layers: 6 units of 6
    behind the shared block, a 2-layer tail; 1.26 B params, 1.02 B of them
    chunk-managed, ~16 GB of model data in fp32 payloads) on the eager
    trainer: bf16 compute, batch 2 x 2048, OPT, prefetch, the act stream
    and placement, a warm-up step, ``ZOO_TRAIN_STEPS - 1`` timed step
    and a profiled one, under a 4 GiB device budget.  The peak's limit,
    written down before the first run: budget + stem (with its gradient
    and moments) + 2 x the fp32 logits + 1 GiB + :func:`zamba_extra_bytes`
    at 4096 tokens."""
    from repro_torch.configs import get_config

    cfg = get_config(ZAMBA)
    b, s = 2, 2048
    release_host_memory()
    out = train_slice_phase(cfg, params, budget=4 * GIB,
                            label="train_zamba", batch=(b, s),
                            extra_limit=zamba_extra_bytes(cfg, b * s),
                            need_device_adam=False,
                            steps=ZOO_TRAIN_STEPS)
    largest = cfg.shared_interval * cfg.d_model * cfg.d_inner
    if out["chunk_bytes"] < 4 * largest:
        raise AssertionError(f"train_zamba: a chunk of {out['chunk_bytes']}"
                             f" bytes cannot hold a unit's stacked "
                             f"[6, 2048, 4096] ({4 * largest} bytes)")
    timed = out["steps_detail"][1:]
    busy = out["profiled_step"].get("device_busy_share")
    summary = dict(
        phase="train_zamba_summary", layers=cfg.num_layers,
        units=cfg.num_units, tail_layers=cfg.tail_layers,
        d_model=cfg.d_model, batch=[b, s],
        tokens_per_s=out["post_warmup_tokens_per_s"],
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"],
        idle_share=None if busy is None else 1 - busy,
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        os_device_chunks=out["os_device_chunks"],
        os_host_chunks=out["os_host_chunks"],
        model_data_bytes=out["model_data_bytes"],
        chunk_bytes=out["chunk_bytes"], largest_tensor_elems=largest)
    emit(summary)
    return dict(out, summary=summary)


def serve_zamba_phase(params) -> dict:
    """zamba2-1.2b at full depth and width (a 4.1 GB fp32 param stream),
    bf16 compute, prompts 512/512/500/500, 8 new tokens (32 before
    xlstm's phases joined, 16 before whisper's, for the script's time
    limit), horizon 1024:
    the eager ``ServingEngine`` (one sequence a call: the units' mamba
    states do not lead with the batch dim) and the
    ``CompiledServingEngine`` (prefill cohorts of one, so its counters
    equal the eager engine's; one decode graph over 4 slots) under 2 GiB,
    where every round pages the param stream, and under the smallest
    whole GiB that holds the stream and every sequence's caches.  K2 as
    planned: 6 calls a prefill and 6 a sequence a decoded token eagerly
    (`tc` in prefill, `splitkv` in decode), 6 a graph replay.  Prefill and
    decode tokens/s, the round wall split, bytes a round, peaks."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import flatten_with_paths

    cfg = get_config(ZAMBA)
    budget, new = 2 * GIB, 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (512, 512, 500, 500)]
    eager = {"2gib": slice_phase(cfg, params, budget=budget,
                                 label="serve_zamba_eager", new_tokens=new)}
    sl = eager["2gib"]
    seq_kv = sl["kv_chunk_bytes"] * (cfg.num_units + cfg.tail_layers)
    fit = -(-(sl["param_stream_bytes"] + 4 * seq_kv) // GIB) * GIB
    fit_key = f"{fit // GIB}gib"
    eager[fit_key] = slice_phase(cfg, params, budget=fit,
                                 label="serve_zamba_eager_fit",
                                 new_tokens=new, pages=False)
    schedules = dict(
        prefill=fa.plan_forward(1, 512, 512, cfg.n_heads,
                                torch.bfloat16).schedule,
        decode=fa.plan_forward(1, 1, 1024, cfg.n_heads, torch.bfloat16,
                               q_offset=600, kv_len=601).schedule)
    runs = {}
    for key, bud in (("2gib", budget), (fit_key, fit)):
        label = f"serve_zamba compiled {key}"
        r = compiled_run(cfg, params, prompts, bud,
                         profile_round=PROFILED_ROUND, new_tokens=new,
                         max_prefill_batch=1)
        eng, rounds = r["eng"], r["rounds"]
        calls = k2_calls(eng)
        planned = k2_plan(cfg, rounds)
        if calls["total"] != planned or calls["graph_k2_calls"] != \
                decode_k2_layers(cfg):
            raise AssertionError(f"{label}: K2 calls {calls}, the plan "
                                 f"implies {planned} ("
                                 f"{decode_k2_layers(cfg)} a replay)")
        if (eng.decode_compile_count, eng.padded_slots) != (1, 4):
            raise AssertionError(f"{label}: {eng.decode_compile_count} "
                                 f"decode graphs at {eng.padded_slots} "
                                 f"slots")
        rows = round_rows(rounds)
        if rows != eager[key]["round_counters"]:
            raise AssertionError(
                f"{label}: counters differ from the eager engine's from "
                f"round {first_difference(eager[key]['round_counters'], rows)}")
        store_bytes = sum(t.numel() * t.element_size()
                          for t in eng._pstores.values())
        slot_bytes = sum(t.numel() * t.element_size()
                         for tree in eng._slot_caches.values()
                         for _, t in flatten_with_paths(tree))
        limit = (r["at_start"] + bud + eng.stem_bytes + store_bytes
                 + slot_bytes + GIB)
        if r["peak"] > limit:
            raise AssertionError(f"{label}: max_memory_allocated "
                                 f"{r['peak']} > {limit}")
        toks = [eng.result(i) for i in range(len(prompts))]
        if any(len(t) != new or not all(0 <= x < cfg.vocab_size for x in t)
               for t in toks):
            raise AssertionError(f"{label}: tokens {toks}")
        want = eager[key]["tokens"]
        runs[key] = dict(
            device_budget_bytes=bud, setup_s=r["setup_s"],
            rounds=len(rounds), counters_equal_eager=True,
            round_wall_s=[m.wall_s for m in rounds],
            round_decode_s=[t["decode_s"] for t in eng.round_times],
            round_prefill_s=[t["prefill_s"] for t in eng.round_times],
            round_replay_s=[t["replay_s"] for t in eng.round_times],
            round_h2d_bytes=[m.h2d_bytes for m in rounds],
            round_d2h_bytes=[m.d2h_bytes for m in rounds],
            graph_replay_device_ms=eng.decode_graph.device_ms,
            graph_warmup_s=eng.decode_graph.warmup_s,
            h2d_bytes=sum(m.h2d_bytes for m in rounds),
            d2h_bytes=sum(m.d2h_bytes for m in rounds),
            **tok_rates(rounds, eng.round_times), k2=calls,
            k2_planned=planned, padded_slots=eng.padded_slots,
            max_memory_allocated=r["peak"], memory_limit=limit,
            store_bytes=store_bytes, slot_cache_bytes=slot_bytes,
            prefill_tokens_equal_eager=[t[0] == e[0] for t, e in
                                        zip(toks, want)],
            decode_tokens_equal_eager=[t[1:] == e[1:] for t, e in
                                       zip(toks, want)],
            profiled_round=PROFILED_ROUND, profiled_round_device=dict(
                device_time_breakdown(r["prof"], r["prof_wall"],
                                      kinds=RT_KINDS),
                top_kernels=top_kernels(r["prof"])))
        del r, eng
        gc.collect()
        torch.cuda.empty_cache()
    summary = dict(
        phase="serve_zamba_summary", layers=cfg.num_layers,
        param_stream_bytes=sl["param_stream_bytes"],
        param_chunk_bytes=sl["param_chunk_bytes"],
        kv_chunk_bytes=sl["kv_chunk_bytes"], seq_cache_bytes=seq_kv,
        fit_budget_bytes=fit, k2_schedules=schedules,
        eager={key: dict(
            prefill_tok_per_s=row["prefill_tok_per_s"],
            decode_tok_per_s=row["decode_tok_per_s"],
            h2d_bytes=row["h2d_bytes"], d2h_bytes=row["d2h_bytes"],
            round_wall_s=row["round_wall_s"],
            max_memory_allocated=row["max_memory_allocated"],
            memory_limit=row["memory_limit"],
            k2_launches=row["k2_launches"], k2_planned=row["k2_planned"])
            for key, row in eager.items()},
        compiled=runs)
    emit(summary)
    return dict(summary, k2_eager={key: row["k2_launches"]
                                   for key, row in eager.items()},
                k2_compiled={key: row["k2"]["total"]
                             for key, row in runs.items()})


XLSTM = "xlstm-1.3b"
# train_xlstm's depth: one unit (7 mLSTM layers and the sLSTM layer)
XLSTM_TRAIN_UNITS = 1
# train_xlstm's batch: 2 x 512 tokens (2 x 2048 until nemotron-4-340b's
# phases joined, 2 x 1024 until the SSM layers' tensor parallelism did:
# the sLSTM's loop over positions is most of its step, cut for the
# script's time limit)
XLSTM_TRAIN = (2, 512)
# serve_xlstm's paging case: 2 units (16 layers) under the least whole
# GiB the eager engine takes, below their fp32 stream
XLSTM_SERVE_UNITS = 2
# serve_xlstm's other depth, under the budget that holds its stream: 2 of
# the 6 units (all 6 until nemotron-4-340b's phases joined, 3 until the
# SSM layers' tensor parallelism did, whose serve_ssm_tp runs all 6
# through the runtime: cut for the script's time limit)
XLSTM_FIT_UNITS = 2


def xlstm_cut(cfg, units: int):
    """``cfg`` cut in depth to ``units`` whole units."""
    return cfg.replace(num_layers=units * (cfg.mlstm_per_unit
                                           + cfg.slstm_per_unit))


def xlstm_extra_bytes(cfg, tokens: int) -> int:
    """What an xLSTM unit's backward holds beside the trainer's budget
    (the eager trainer recomputes a whole unit at a time, with grad),
    from the tape measured on the CPU at full width (4.39 MB a token for
    one unit: ~1.84 of it the mLSTM layers' chunk-end matrix memories,
    the rest fp32 projections and the sLSTM steps' states), with room for
    the backward's temporaries: each mLSTM layer's 24 fp32 values of
    d_inner a token plus twice its [nh, dh, dh] fp32 memory a chunk, and
    the sLSTM layer's 24 fp32 values of d_inner a token."""
    dh = cfg.d_inner // cfg.n_heads
    mlstm = 24 * cfg.d_inner + 2 * cfg.n_heads * dh * dh // cfg.chunk_len
    return 4 * tokens * (cfg.mlstm_per_unit * mlstm + 24 * cfg.d_inner)


def xlstm_state_bytes(cfg) -> int:
    """One sequence's decode state over every unit, fp32: each mLSTM
    layer's matrix memory, normaliser and stabiliser, each sLSTM layer's
    four [nh, dh] vectors."""
    nh, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    unit = cfg.mlstm_per_unit * nh * (dh * dh + dh + 1) + 4 * nh * dh
    return 4 * unit * cfg.num_units


def xlstm_serve_floor(cfg) -> int:
    """The eager serving engine's least budget for ``cfg``: a unit's fp32
    param chunks (the engine's own chunk search) and two of its state
    chunks (each one unit's state for one sequence)."""
    cmap = chunk_plan(cfg)
    unit = len({p.chunk_id for p in cmap.placements
                if p.name.startswith("units.0[")})
    kv = -(-xlstm_state_bytes(cfg) // cfg.num_units // 1024) * 1024
    return unit * cmap.chunk_size * 4 + 2 * kv


XLSTM_PARITY_CUT = dict(mlstm_per_unit=1)


def xlstm_parity_config():
    from repro_torch.configs import get_config

    return get_config(XLSTM).replace(num_layers=2, param_dtype="float32",
                                     compute_dtype="float32",
                                     **XLSTM_PARITY_CUT)


def xlstm_parity_setup(cfg):
    """xlstm_parity's trainer inputs: 2 steps of 1 x 128 at lr 1e-4."""
    batches, tkw = parity_train_setup(cfg, 1, 128, 2, "units")
    return batches, dict(tkw, lr=1e-4)


def xlstm_parity_phase() -> dict:
    """xlstm-1.3b at full width, its unit cut in depth to one mLSTM and
    one sLSTM layer (``mlstm_per_unit=1``: 0.25 B params with the stem),
    fp32: served eagerly and compiled on the CPU and on the card
    (``compiled_parity_phase``'s checks: tokens identical, counters
    identical, the compiled ones equal the eager engine's one sequence a
    decode call; prefill cohorts of one, as the eager engine prefills
    xLSTM), a ragged 100-token prompt beside a 64-token one; then
    ``ChunkedRuntime`` 1 step (2 before whisper's phases joined, for the
    script's time limit) and ``PatrickStarEngine`` 2 steps of 1 x 128
    tokens (two 64-token mLSTM chunks, 128 sLSTM steps) at lr 1e-4, CPU
    against card: losses within 1e-6 relative (the runtime's against the
    CPU trainer's first loss, :func:`rt_oracle`), the trainer's counters
    identical, K1 as planned and K2 never.  (At lr 1e-3 the first ADAM
    step overshoots, the loss rises, and two CPU runs that differ only in
    their thread count already differ by 1.1e-6 at step 2; at 1e-4 the
    loss falls and they differ by 2.7e-7.)"""
    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    label = "xlstm_parity"
    cut = XLSTM_PARITY_CUT
    cfg = xlstm_parity_config()
    params = card_params(cfg)
    serving = compiled_parity_phase(
        XLSTM, 2, (100, 64), 4, label="xlstm_parity_serving", params=params,
        overrides=cut, max_prefill_batch=1)
    if serving["k2_eager_launches"] or serving["k2"]["total"]:
        raise AssertionError(f"{label}: K2 ran in serving "
                             f"{serving['k2']}")
    b, s, steps, rt_steps = 1, 128, 2, 1
    batches, tkw = xlstm_parity_setup(cfg)
    tbudget, lr = tkw["device_memory_bytes"], tkw["lr"]

    def reset():
        fa.launches = fa.bwd_launches = ka.launches = 0

    def counts():
        torch.cuda.synchronize()
        return dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)

    oracle = ORACLES.result(label, lambda: oracle_train(
        cfg, params, batches, tkw))
    cpu_steps = oracle["steps"]
    cm = rt_oracle(cpu_steps, rt_steps)
    gpu_rt = rt_make(cfg, 1, "cuda", **RT_OPTIONS, lr=lr)
    reset()
    _, _, gm = rt_train(gpu_rt, params, batches[:rt_steps])
    rt_launches = counts()
    rt_plan = dict(fwd=0, bwd=0, adam=rt_k1_plan(gpu_rt) * rt_steps)
    del gpu_rt
    if rt_launches != rt_plan:
        raise AssertionError(f"{label}: runtime launches {rt_launches}, "
                             f"the plan implies {rt_plan}")
    rt_rel = [abs(c["loss"] - g["loss"]) / abs(c["loss"]) for c, g in
              zip(cm, gm, strict=True)]
    if not all(math.isfinite(g["loss"]) for g in gm) or max(rt_rel) > 1e-6:
        raise AssertionError(f"{label}: runtime losses cpu "
                             f"{[c['loss'] for c in cm]} cuda "
                             f"{[g['loss'] for g in gm]}")
    reset()
    gpu, gpu_steps = train(cfg, params, batches, device="cuda", **tkw)
    tr_launches = counts()
    dev = device_chunks(gpu)
    del gpu
    tr_plan = dict(fwd=0, bwd=0, adam=dev * (steps - 1))
    if tr_launches != tr_plan or dev < 1:
        raise AssertionError(f"{label}: trainer launches {tr_launches}, "
                             f"the plan implies {tr_plan}")
    tr_rel = []
    for i, (a, c) in enumerate(zip(cpu_steps, gpu_steps, strict=True)):
        ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
        cc = {f: getattr(c, f) for f in TRAIN_COUNTERS}
        tr_rel.append(abs(a.loss - c.loss) / abs(a.loss))
        if ca != cc or not math.isfinite(c.loss) or tr_rel[-1] > 1e-6:
            raise AssertionError(f"{label}: trainer step {i} loss cpu "
                                 f"{a.loss} cuda {c.loss}, counters cpu "
                                 f"{ca} cuda {cc}")
    out = dict(
        phase=label, config=cfg.name, layers=cfg.num_layers,
        units=cfg.num_units, mlstm_per_unit=cfg.mlstm_per_unit,
        serving={key: serving[key] for key in (
            "tokens", "rounds", "k2", "k2_planned", "k2_eager_launches",
            "k2_eager_planned", "device_budget_bytes")},
        train_batch=[b, s], train_steps=steps, runtime_steps=rt_steps,
        lr=lr,
        runtime=dict(losses_cpu=[c["loss"] for c in cm],
                     oracle="the CPU trainer's first loss",
                     losses_cuda=[g["loss"] for g in gm],
                     max_rel_loss_diff=max(rt_rel), launches=rt_launches,
                     planned=rt_plan),
        trainer=dict(losses_cpu=[a.loss for a in cpu_steps],
                     losses_cuda=[c.loss for c in gpu_steps],
                     max_rel_loss_diff=max(tr_rel), launches=tr_launches,
                     planned=tr_plan, device_budget_bytes=tbudget,
                     os_device_chunks=dev, counters_identical=True,
                     cpu_s=oracle["cpu_s"]),
        oracle=ORACLES.row(label))
    emit(out)
    return out


def params_xlstm_phase() -> dict:
    """xlstm-1.3b's weights at full depth and width (48 layers, 3.70 B
    params as the reference builds the model; bf16 with its fp32 gate
    leaves, drawn on the card from seed 0), made once for train_xlstm
    and serve_xlstm."""
    from repro_torch.configs import get_config

    return card_params(get_config(XLSTM))


def train_xlstm_phase(params) -> dict:
    """xlstm-1.3b at full width, ``XLSTM_TRAIN_UNITS`` unit deep (7 mLSTM
    layers and the sLSTM layer: 0.60 B chunk-managed params, ~9.6 GB of
    model data in fp32 payloads) on the eager trainer: bf16 compute,
    OPT, prefetch, the act stream and placement, a
    warm-up step, ``ZOO_TRAIN_STEPS - 1`` timed step and a profiled
    one, under a 4 GiB device budget, batch ``XLSTM_TRAIN``.  K2 never
    runs (no attention); K1 as planned.  The peak's limit, written down
    before the first run: budget + stem (with its gradient and moments) +
    2 x the fp32 logits + 1 GiB + :func:`xlstm_extra_bytes` at the
    batch's tokens."""
    from repro_torch.configs import get_config

    cfg = xlstm_cut(get_config(XLSTM), XLSTM_TRAIN_UNITS)
    b, s = XLSTM_TRAIN
    out = train_slice_phase(cfg, cut_layers(params, XLSTM_TRAIN_UNITS),
                            budget=4 * GIB, label="train_xlstm",
                            batch=(b, s),
                            extra_limit=xlstm_extra_bytes(cfg, b * s),
                            need_device_adam=False,
                            steps=ZOO_TRAIN_STEPS)
    largest = cfg.mlstm_per_unit * cfg.d_inner * cfg.d_inner
    if out["chunk_bytes"] < 4 * largest:
        raise AssertionError(f"train_xlstm: a chunk of {out['chunk_bytes']}"
                             f" bytes cannot hold a unit's stacked "
                             f"[7, 4096, 4096] ({4 * largest} bytes)")
    timed = out["steps_detail"][1:]
    busy = out["profiled_step"].get("device_busy_share")
    summary = dict(
        phase="train_xlstm_summary", layers=cfg.num_layers,
        units=cfg.num_units, d_model=cfg.d_model, d_inner=cfg.d_inner,
        batch=[b, s], tokens_per_s=out["post_warmup_tokens_per_s"],
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"], extra_limit=out["extra_limit"],
        idle_share=None if busy is None else 1 - busy,
        device_events=out["profiled_step"].get("device_events"),
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        os_device_chunks=out["os_device_chunks"],
        os_host_chunks=out["os_host_chunks"],
        model_data_bytes=out["model_data_bytes"],
        chunk_bytes=out["chunk_bytes"], largest_tensor_elems=largest)
    emit(summary)
    return dict(out, summary=summary)


def serve_xlstm_phase(params) -> dict:
    """xlstm-1.3b, bf16 compute, prompts 512/512/500/500 (ragged against
    the 64-position chunks), 8 new tokens (16 before whisper's phases
    joined, for the script's time limit), horizon 1024, on the eager
    ``ServingEngine`` (one sequence a call: the mLSTM carries stack their
    7 layers ahead of the batch axis) and the ``CompiledServingEngine``
    (prefill cohorts of one, so its counters equal the eager engine's;
    one decode graph over 4 slots), at two depths: ``XLSTM_FIT_UNITS``
    units (all 6 before nemotron's phases joined: a 16.4 GiB fp32 param
    stream in the engine's 672 MiB chunks; each sequence's state is 0.66
    GiB) under the smallest whole GiB that holds the stream and every
    sequence's state, and ``XLSTM_SERVE_UNITS`` units (a 5.5 GiB
    stream in 1120 MiB chunks) under the smallest whole GiB at the eager
    engine's floor (a unit's 3 chunks and two state chunks: 4 GiB), where
    params and states page every round.  K2 never runs.  Prefill and
    decode tokens/s, the compiled round's wall split (decode call,
    prefill, pool replay), bytes a round, peaks against limits written
    before the first run (the eager engine's: budget + stem + 1 GiB; the
    compiled engine's: what was allocated before it + budget + stem + its
    bf16 stores + its slot caches + 1 GiB)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.api import flatten_with_paths

    full = xlstm_cut(get_config(XLSTM), XLSTM_FIT_UNITS)
    new = 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, full.vocab_size, size=n)
               for n in (512, 512, 500, 500)]
    cmap = chunk_plan(full)
    stream = cmap.num_payload_chunks * cmap.chunk_size * 4
    fit = -(-(stream + 4 * xlstm_state_bytes(full)) // GIB) * GIB
    cut = xlstm_cut(full, XLSTM_SERVE_UNITS)
    low = -(-xlstm_serve_floor(cut) // GIB) * GIB
    cmap = chunk_plan(cut)
    if low >= cmap.num_payload_chunks * cmap.chunk_size * 4:
        raise AssertionError(f"serve_xlstm: {low} bytes hold the "
                             f"{XLSTM_SERVE_UNITS}-unit stream: nothing pages")
    cases = {"fit": (full, cut_layers(params, XLSTM_FIT_UNITS), fit, False),
             "cut_paged": (cut, cut_layers(params, XLSTM_SERVE_UNITS), low,
                           True)}
    eager, runs = {}, {}
    for key, (cfg, prm, bud, pages) in cases.items():
        row = slice_phase(cfg, prm, budget=bud, label=f"serve_xlstm_eager_"
                          f"{key}", new_tokens=new, pages=pages)
        if row["k2_launches"] or row["k2_planned"]:
            raise AssertionError(f"serve_xlstm eager {key}: K2 ran "
                                 f"{row['k2_launches']} times")
        eager[key] = row
        label = f"serve_xlstm compiled {key}"
        r = compiled_run(cfg, prm, prompts, bud,
                         profile_round=PROFILED_ROUND, new_tokens=new,
                         max_prefill_batch=1)
        eng, rounds = r["eng"], r["rounds"]
        calls = k2_calls(eng)
        if calls["total"] or calls["graph_k2_calls"]:
            raise AssertionError(f"{label}: K2 calls {calls}, the plan "
                                 f"implies none")
        if (eng.decode_compile_count, eng.padded_slots) != (1, 4):
            raise AssertionError(f"{label}: {eng.decode_compile_count} "
                                 f"decode graphs at {eng.padded_slots} "
                                 f"slots")
        rows = round_rows(rounds)
        if rows != row["round_counters"]:
            first = first_difference(row["round_counters"], rows)
            raise AssertionError(f"{label}: counters differ from the eager "
                                 f"engine's from round {first}")
        store_bytes = sum(t.numel() * t.element_size()
                          for t in eng._pstores.values())
        slot_bytes = sum(t.numel() * t.element_size()
                         for tree in eng._slot_caches.values()
                         for _, t in flatten_with_paths(tree))
        limit = (r["at_start"] + bud + eng.stem_bytes + store_bytes
                 + slot_bytes + GIB)
        if r["peak"] > limit:
            raise AssertionError(f"{label}: max_memory_allocated "
                                 f"{r['peak']} > {limit}")
        toks = [eng.result(i) for i in range(len(prompts))]
        if any(len(t) != new or not all(0 <= x < cfg.vocab_size for x in t)
               for t in toks):
            raise AssertionError(f"{label}: tokens {toks}")
        runs[key] = dict(
            layers=cfg.num_layers, device_budget_bytes=bud,
            setup_s=r["setup_s"], rounds=len(rounds),
            counters_equal_eager=True,
            round_wall_s=[m.wall_s for m in rounds],
            round_decode_s=[t["decode_s"] for t in eng.round_times],
            round_prefill_s=[t["prefill_s"] for t in eng.round_times],
            round_replay_s=[t["replay_s"] for t in eng.round_times],
            round_h2d_bytes=[m.h2d_bytes for m in rounds],
            round_d2h_bytes=[m.d2h_bytes for m in rounds],
            graph_replay_device_ms=eng.decode_graph.device_ms,
            graph_warmup_s=eng.decode_graph.warmup_s,
            h2d_bytes=sum(m.h2d_bytes for m in rounds),
            d2h_bytes=sum(m.d2h_bytes for m in rounds),
            **tok_rates(rounds, eng.round_times), k2=calls,
            padded_slots=eng.padded_slots,
            max_memory_allocated=r["peak"], memory_limit=limit,
            store_bytes=store_bytes, slot_cache_bytes=slot_bytes,
            tokens_equal_eager=[t == e for t, e in
                                zip(toks, row["tokens"])],
            profiled_round=PROFILED_ROUND, profiled_round_device=dict(
                device_time_breakdown(r["prof"], r["prof_wall"],
                                      kinds=RT_KINDS),
                top_kernels=top_kernels(r["prof"])))
        del r, eng, prm
        gc.collect()
        torch.cuda.empty_cache()
    summary = dict(
        phase="serve_xlstm_summary", param_stream_bytes_full=stream,
        state_bytes_a_sequence=xlstm_state_bytes(full), fit_budget_bytes=fit,
        paged_budget_bytes=low,
        eager={key: dict(
            layers=row["layers"], device_budget_bytes=row[
                "device_budget_bytes"],
            param_stream_bytes=row["param_stream_bytes"],
            kv_chunk_bytes=row["kv_chunk_bytes"],
            prefill_tok_per_s=row["prefill_tok_per_s"],
            decode_tok_per_s=row["decode_tok_per_s"],
            h2d_bytes=row["h2d_bytes"], d2h_bytes=row["d2h_bytes"],
            round_wall_s=row["round_wall_s"],
            max_memory_allocated=row["max_memory_allocated"],
            memory_limit=row["memory_limit"],
            k2_launches=row["k2_launches"]) for key, row in eager.items()},
        compiled=runs)
    emit(summary)
    return dict(summary, k2_eager={key: row["k2_launches"]
                                   for key, row in eager.items()},
                k2_compiled={key: row["k2"]["total"]
                             for key, row in runs.items()})


# ---------------------------------------------------------- whisper-large-v3
WHISPER = "whisper-large-v3"
WHISPER_TRAIN = (4, 1500)  # batch x tokens; frames = min(1500, tokens)
WHISPER_PROMPT = 432       # prompt tokens: 432 + 16 new = its 448 positions
WHISPER_NEW = 16
# K2 at whisper's attention (20 heads of 64): B, Sq, Sk, H, KV, D
WHISPER_KERNEL_CASES = [
    # the encoder's bidirectional self-attention over its 1500 frames;
    # at frames = tokens = 1500 the training cross-attention is this shape
    dict(name="encoder", shape=(4, 1500, 1500, 20, 20, 64), causal=False,
         bwd=True),
    # the decoder's causal self-attention at the training shape
    dict(name="decoder", shape=(4, 1500, 1500, 20, 20, 64), causal=True,
         bwd=True),
    # cross-attention with fewer queries than frames: the serving prefill
    dict(name="cross", shape=(4, WHISPER_PROMPT, 1500, 20, 20, 64),
         causal=False, bwd=True),
    # decode: one query against the self cache and the 1500-row cross cache
    dict(name="decode_self", shape=(4, 1, WHISPER_PROMPT + WHISPER_NEW, 20,
                                    20, 64), causal=True,
         q_offset=WHISPER_PROMPT + 8, kv_len=WHISPER_PROMPT + 9),
    dict(name="decode_cross", shape=(4, 1, 1500, 20, 20, 64), causal=False),
]


def whisper_kernels_phase() -> dict:
    """K2 at whisper-large-v3's shapes (20 heads of 64; 1500 rows are not a
    multiple of the 128-row ``tc`` tile or the 64-row split grain), bf16
    and fp32: :func:`kernel_cases_phase` over
    ``WHISPER_KERNEL_CASES``."""
    return kernel_cases_phase("whisper_kernels", WHISPER_KERNEL_CASES, 6)


def kernel_cases_phase(phase: str, cases: list, seed: int) -> dict:
    """K2 at a model's shapes (``cases``: B, Sq, Sk, H, KV, D, the masks,
    ``dtypes``, default both, ``bwd`` where training runs the case, and
    ``grouped`` where the plain version runs one kv head's query heads at
    a time, :func:`grouped`, to fit the card):
    the forward with its lse against the plain forward, the backward
    through the autograd function (the BWD recompute's route) against the
    plain backward fed the plain forward's o and lse (dq, dk, dv each:
    ``TOL`` x its largest value and ``REL_TOL``), and ``splitkv`` decodes.
    Each row times the kernel beside the plain version and SDPA (the port
    never calls it), with its bound and TFLOP/s."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for case in cases:
        b, sq, sk, h, kv, d = case["shape"]
        kw = {key: case[key] for key in ("causal", "q_offset", "kv_len")
              if key in case}
        plain, plain_bwd = fa.plain, fa.plain_bwd
        if case.get("grouped"):
            def plain(*args, **kwargs):
                return grouped(fa.plain, *args, **kwargs)

            def plain_bwd(*args, **kwargs):
                return grouped(fa.plain_bwd, *args, **kwargs)
        for dtype in case.get("dtypes", BOTH):
            dt = getattr(torch, dtype)
            label = f"{phase} {case['name']} {dtype}"

            def rand(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)
            q, k, v = rand(b, sq, h, d), rand(b, sk, kv, d), rand(b, sk, kv, d)
            plan = fa.plan_forward(b, sq, sk, h, dt, **kw)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            o_ref, lse_ref = plain(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            o_err = (o.float() - o_ref.float()).abs().max().item()
            o_rel = ((o.float() - o_ref.float()).norm()
                     / o_ref.float().norm()).item()
            lse_err = (lse - lse_ref).abs().max().item()
            if not (math.isfinite(o_err) and o_err <= TOL[dtype]
                    and math.isfinite(lse_err) and lse_err <= LSE_TOL):
                raise AssertionError(f"{label} ({plan.schedule}): output "
                                     f"error {o_err} (tol {TOL[dtype]}), "
                                     f"lse {lse_err} (tol {LSE_TOL})")
            iters = 10 if dtype == "bfloat16" else 4
            kvl = kw.get("kv_len", sk)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k[:, :kvl], v[:, :kvl]))
            causal_lib = kw["causal"] and sq > 1

            def sdpa():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal_lib,
                        enable_gqa=kv != h)
            with_lse = "bwd" in case  # training keeps the lse

            def fwd():
                return fa.flash_attention_cuda(q, k, v, return_lse=with_lse,
                                               **kw)
            ms, lib_ms, turns = time_pair(fwd, sdpa, iters)
            bound = attention_bound(dict(case, dtype=dtype))
            row = dict(case=case["name"], dtype=dtype, shape=case["shape"],
                       causal=kw["causal"], schedule=plan.schedule,
                       splits=plan.splits if plan.schedule == "splitkv"
                       else None, with_lse=with_lse, max_abs_err=o_err,
                       rel_err=o_rel, lse_max_abs_err=lse_err, ms=ms,
                       device_ms=device_ms(fwd, iters),
                       plain_ms=time_ms(lambda: plain(q, k, v, **kw), 2),
                       plain=("a kv head's query heads a call"
                              if case.get("grouped") else "whole"),
                       library_ms=lib_ms, times_kernel_lib_lib_kernel=turns,
                       tflops=bound["flops"] / (ms * 1e-3) / 1e12, **bound)
            emit({"phase": phase, "kernel":
                  "flash_attention_fwd", **row})
            results[("fwd", case["name"], dtype)] = row
            if "bwd" not in case:
                del q, k, v, o, lse, o_ref, lse_ref, qt, kt, vt
                continue
            do = rand(b, sq, h, d)
            want = plain_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            del o_ref, lse_ref
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            got = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                      leaves, do)
            del leaves
            torch.cuda.synchronize()
            grads = grad_errors(label, got, want, dtype)
            del got, want
            dot = do.transpose(1, 2)

            def bwd():
                fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal_lib,
                                                     enable_gqa=kv != h)
                torch.autograd.grad(out, (qt, kt, vt), dot)

            def sdpa_bwd():
                return time_ms(sdpa_fwd_bwd, iters) - time_ms(sdpa, iters)
            bturns = [time_ms(bwd, iters), sdpa_bwd(), sdpa_bwd(),
                      time_ms(bwd, iters)]
            bms = (bturns[0] + bturns[3]) / 2
            bbound = attention_bwd_bound((b, sq, h, kv, d), dtype,
                                         kw["causal"], sk=sk)
            brow = dict(
                case=case["name"], dtype=dtype, shape=case["shape"],
                causal=kw["causal"], schedule=fa.plan_backward(dt),
                grads=grads,
                max_abs_err=max(r["max_abs_err"] for r in grads.values()),
                rel_err=max(r["rel_err"] for r in grads.values()), ms=bms,
                device_ms=device_ms(bwd, iters),
                plain_ms=time_ms(lambda: plain_bwd(q, k, v, o, lse, do,
                                                   **kw), 2),
                library_ms=(bturns[1] + bturns[2]) / 2,
                library="SDPA (forward + backward - forward)",
                times_kernel_lib_lib_kernel=bturns,
                tflops=bbound["flops"] / (bms * 1e-3) / 1e12, **bbound)
            emit({"phase": phase, "kernel":
                  "flash_attention_bwd", **brow})
            results[("bwd", case["name"], dtype)] = brow
            del q, k, v, do, o, lse, qt, kt, vt, dot
            torch.cuda.empty_cache()
    return results


WHISPER_TRAIN_BUDGET = 8 * GIB  # against ~12.5 GB of model data: chunks page
# train_whisper's depth: 16 + 16 of the 32 + 32 layers (all until
# nemotron-4-340b's phases joined: cut for the script's time limit)
WHISPER_TRAIN_LAYERS = 16


def whisper_extra_bytes(cfg, tokens: int) -> int:
    """What a whisper layer's backward holds beside the trainer's budget:
    ten fp32 [tokens, d_ff] of the MLP, and eight fp32 [tokens, d_model]:
    the cross-attention's k and v over the frames (frames = tokens here)
    with their gradients, the encoder output and its cotangent."""
    return 10 * 4 * tokens * cfg.d_ff + 8 * 4 * tokens * cfg.d_model


def params_whisper_phase() -> dict:
    """whisper-large-v3's weights at full depth and width (bf16, drawn on
    the card from seed 0), made once for train_whisper and rt_whisper."""
    from repro_torch.configs import get_config

    return card_params(get_config(WHISPER))


def train_whisper_phase(params) -> dict:
    """whisper-large-v3 at full width, ``WHISPER_TRAIN_LAYERS`` encoder +
    as many decoder layers (a depth cut for the script's time limit; all
    32 + 32, ~25 GB of model data in fp32 payloads, until nemotron's
    phases joined) on the eager trainer: bf16 compute, batch
    ``WHISPER_TRAIN`` (4 x 1500 tokens over 1500 frames each: Whisper's
    30 s window), OPT, prefetch, the act stream and placement, a warm-up
    step, ``ZOO_TRAIN_STEPS - 1`` timed step and a profiled one, under
    ``WHISPER_TRAIN_BUDGET``.  Its BWD differentiates the encoder-decoder
    boundary (``PatrickStarEngine.backward_boundary``).  The peak's
    limit, written down before the first run: budget + stem (with its
    gradient and moments) + 2 x the fp32 logits + 1 GiB +
    :func:`whisper_extra_bytes`."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER).replace(num_layers=WHISPER_TRAIN_LAYERS,
                                      num_encoder_layers=WHISPER_TRAIN_LAYERS)
    b, s = WHISPER_TRAIN
    out = train_slice_phase(cfg, cut_layers(params, WHISPER_TRAIN_LAYERS),
                            budget=WHISPER_TRAIN_BUDGET,
                            label="train_whisper", batch=(b, s),
                            extra_limit=whisper_extra_bytes(cfg, b * s),
                            steps=ZOO_TRAIN_STEPS)
    if out["model_data_bytes"] <= WHISPER_TRAIN_BUDGET:
        raise AssertionError(f"train_whisper: model data "
                             f"{out['model_data_bytes']} fits the budget")
    timed = out["steps_detail"][1:]
    busy = out["profiled_step"].get("device_busy_share")
    summary = dict(
        phase="train_whisper_summary", encoder_layers=cfg.num_encoder_layers,
        decoder_layers=cfg.num_layers, d_model=cfg.d_model, batch=[b, s],
        frames=min(cfg.encoder_frames, s),
        tokens_per_s=out["post_warmup_tokens_per_s"],
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"],
        idle_share=None if busy is None else 1 - busy,
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        os_device_chunks=out["os_device_chunks"],
        os_host_chunks=out["os_host_chunks"],
        model_data_bytes=out["model_data_bytes"],
        chunk_bytes=out["chunk_bytes"])
    emit(summary)
    return dict(out, summary=summary)


def rt_full_phase(label: str, cfg, params, batch_shape, **fields) -> dict:
    """``cfg`` at full depth and width on ``ChunkedRuntime`` (bf16 stores,
    one rank, half the optimizer state on the host, ``RT_OPTIONS``): 2
    timed steps of ``batch_shape`` (B, S: S positions, the vlm family's
    patches among them), the losses, text tokens/s and positions/s, the
    step time split, the host part's bytes and the K1/K2 launches against
    the plan (each attention forward twice under full remat, backward
    once, all at the config's head dim; K1 once a layer and part).
    ``fields`` join the row.  Returns the row with the runtime, for the
    serving phase that follows."""
    import torch

    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    (b, s), steps = batch_shape, 2
    nxt = make_batch_fn(cfg, b, s)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(steps)]
    text = batches[0]["tokens"].shape[1]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = rt_make(cfg, 1, "cuda", **RT_OPTIONS)
    fa.launches = fa.bwd_launches = ka.launches = 0
    fa.pair_launches.clear()
    ps, os_, mets = rt_train(rt, params, batches, timed=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    attn = sum(k2_layers(cfg).values())
    launches = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
    plan = dict(fwd=2 * attn * steps, bwd=attn * steps,
                adam=rt_k1_plan(rt) * steps)
    pairs = pairs_row(fa.pair_launches)
    d = cfg.head_dim
    if launches != plan or pairs != {f"{d},{d}": plan["fwd"]}:
        raise AssertionError(f"{label}: launches {launches} ({pairs}), the "
                             f"plan implies {plan}")
    host_bytes = 12 * rt_host_elems(rt)
    for i, m in enumerate(mets):
        if not math.isfinite(m["loss"]) or not (
                m["h2d_bytes"] == m["d2h_bytes"] == host_bytes > 0):
            raise AssertionError(f"{label}: step {i} loss {m['loss']}, "
                                 f"host-part bytes {m['h2d_bytes']} / "
                                 f"{m['d2h_bytes']} (want {host_bytes})")
    last = mets[-1]["fwd_bwd_s"] + mets[-1]["adam_s"]
    out = dict(
        phase=label, config=cfg.name, **fields, d_model=cfg.d_model,
        dtype=cfg.param_dtype, batch=[b, s], text_tokens=text, steps=steps,
        options=RT_OPTIONS, losses=[m["loss"] for m in mets],
        fwd_bwd_s=[m["fwd_bwd_s"] for m in mets],
        adam_s=[m["adam_s"] for m in mets],
        tokens_per_s_last=b * text / last, positions_per_s_last=b * s / last,
        host_part_bytes_each_way=host_bytes, launches=launches,
        planned=plan, k2_by_head_dims=pairs, wall_s=wall,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    del ps, os_
    return dict(out, rt=rt)


def rt_whisper_phase(params) -> dict:
    """whisper-large-v3 at full depth and width on the runtime
    (:func:`rt_full_phase`): 2 timed steps of ``WHISPER_TRAIN``."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER)
    return rt_full_phase("rt_whisper", cfg, params, WHISPER_TRAIN,
                         encoder_layers=cfg.num_encoder_layers,
                         decoder_layers=cfg.num_layers)


def serve_full(label: str, rp, params, batch, s: int, new: int,
               plan: dict) -> dict:
    """The runtime's serving steps at full depth, on the runtime that
    ``rp`` (the training phase's row) hands over, from the untrained
    weights' param stores (two runtime steps at lr 1e-3 overshoot: the
    trained model repeats one token), bf16: a warm-up prefill, the timed
    prefill of ``batch`` (numpy: tokens and the model's stub-frontend
    input; ``s`` cached positions a row), ``new`` greedy decode steps from
    position ``s`` and one more under the profiler.  K2's calls against
    ``plan`` ({"prefill": n, "decode": n}); the logits finite and the
    tokens in the vocabulary.  Returns the row, not yet emitted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import flatten_with_paths
    from repro_torch.models.layers import greedy_token
    from repro_torch.runtime import driver

    rt = rp.pop("rt")
    ps = driver.param_stores(rt, params)
    cfg = rt.cfg
    b, p = batch["tokens"].shape
    horizon = s + new
    pre, _ = driver.build_prefill_step(rt, InputShape("serve", s, b,
                                                      "prefill"))
    dshape = InputShape("serve", horizon, b, "decode")
    dec, _ = driver.build_decode_step(rt, dshape)
    pre(ps, batch)  # warm-up: the first call's lazy set-up
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    logits, caches = pre(ps, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre_k2 = fa.launches
    caches = driver.grow_caches(rt, caches, s, horizon, dshape)
    tok = greedy_token(logits, cfg.vocab_size, rt.ctx)
    toks = [tok]
    fa.launches = 0
    t0 = time.perf_counter()
    for pos in range(s, horizon):
        tok, caches = dec(ps, caches, tok.reshape(b, 1), pos)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_k2 = fa.launches
    # one more step (position ``horizon - 1`` again) under the profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        dec(ps, caches, tok.reshape(b, 1), horizon - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    if (pre_k2, dec_k2) != (plan["prefill"], plan["decode"]):
        raise AssertionError(f"{label}: K2 calls prefill {pre_k2}, decode "
                             f"{dec_k2}; the plan implies {plan}")
    out_toks = torch.stack(toks, dim=1).cpu()
    if not (bool(torch.isfinite(logits).all())
            and int(out_toks.min()) >= 0
            and int(out_toks.max()) < cfg.vocab_size):
        raise AssertionError(f"{label}: logits finite "
                             f"{bool(torch.isfinite(logits).all())}, "
                             f"tokens {out_toks.tolist()}")
    return dict(
        phase=label, config=cfg.name, batch=b, prompt_tokens=p,
        new_tokens=new + 1, horizon=horizon, prefill_s=prefill_s,
        decode_s=decode_s, prefill_tok_per_s=b * p / prefill_s,
        decode_tok_per_s=b * new / decode_s, k2_prefill=pre_k2,
        k2_decode=dec_k2, k2_planned=plan, tokens=out_toks.tolist(),
        distinct_tokens=len(set(out_toks.flatten().tolist())),
        cache_shapes={".".join(path): list(t.shape) for path, t in
                      flatten_with_paths(caches)},
        profiled_decode_step=dict(device_time_breakdown(prof, wall),
                                  top_kernels=top_kernels(prof)),
        max_memory_allocated=torch.cuda.max_memory_allocated())


def serve_whisper_phase(rw, params) -> dict:
    """whisper-large-v3 served at full depth through the runtime's serving
    steps (:func:`serve_full`; the reference serves whisper only there: its
    ``ServingEngine`` refuses encoder-input archs): a prefill of 4
    sequences, each 1500 frames and a ``WHISPER_PROMPT`` token prompt (the
    encoder, then the decoder's self and cross caches), then
    ``WHISPER_NEW`` greedy decode steps over a 448-position horizon
    (Whisper's text context).  K2's plan: a prefill one call an encoder
    layer and two a decoder layer (``tc``), a decode step two a decoder
    layer (``splitkv``: the self cache and the 1500-row cross cache)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    cfg = rw["rt"].cfg
    b, p, new = 4, WHISPER_PROMPT, WHISPER_NEW
    horizon = p + new
    rng = np.random.default_rng(0)
    batch = {"frames": rng.standard_normal(
        (b, cfg.encoder_frames, cfg.frontend_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (b, p))}
    plan = dict(prefill=cfg.num_encoder_layers + 2 * cfg.num_layers,
                decode=2 * cfg.num_layers * new)
    out = serve_full("serve_whisper", rw, params, batch, p, new, plan)
    out.update(
        frames=cfg.encoder_frames,
        prefill_frames_and_tok_per_s=b * (p + cfg.encoder_frames)
        / out["prefill_s"],
        k2_schedules=dict(
            prefill_encoder=fa.plan_forward(
                b, cfg.encoder_frames, cfg.encoder_frames, cfg.n_heads,
                torch.bfloat16, causal=False).schedule,
            prefill_cross=fa.plan_forward(
                b, p, cfg.encoder_frames, cfg.n_heads, torch.bfloat16,
                causal=False).schedule,
            decode_self=fa.plan_forward(
                b, 1, horizon, cfg.n_heads, torch.bfloat16,
                q_offset=horizon - 1, kv_len=horizon).schedule,
            decode_cross=fa.plan_forward(
                b, 1, cfg.encoder_frames, cfg.n_heads, torch.bfloat16,
                causal=False).schedule))
    emit(out)
    return out


def parity_train_setup(cfg, b: int, s: int, steps: int, group: str):
    """A parity phase's trainer inputs: ``steps`` batches of b x s from
    the data pipeline, and the engine's options, its margin budget sized
    on ``group``'s layer 0 (lr 1e-3)."""
    from repro_torch.data.pipeline import make_batch_fn

    nxt = make_batch_fn(cfg, b, s)
    batches = [{key: val for key, val in nxt().items() if key != "mask"}
               for _ in range(steps)]
    tbudget = margin_budget(chunk_plan(cfg), b * s * cfg.d_model * 4,
                            groups=1, group=group)
    return batches, dict(device_memory_bytes=tbudget, policy="opt",
                         prefetch=True, lr=1e-3)


def rt_serve_run(rt, params, serve_batch, serve_len: int, new: int):
    """The runtime's prefill of ``serve_batch`` and ``new`` greedy decode
    steps: (last-position logits, the tokens), on the CPU."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.models.layers import greedy_token
    from repro_torch.runtime import driver

    sb = serve_batch["tokens"].shape[0]
    dshape = InputShape("d", serve_len + new, sb, "decode")
    ps = driver.param_stores(rt, params)
    pre, _ = driver.build_prefill_step(rt, InputShape("p", serve_len, sb,
                                                      "prefill"))
    dec, _ = driver.build_decode_step(rt, dshape)
    logits, caches = pre(ps, serve_batch)
    caches = driver.grow_caches(rt, caches, serve_len, serve_len + new,
                                dshape)
    tok = greedy_token(logits, rt.cfg.vocab_size, rt.ctx)
    toks = [tok]
    for pos in range(serve_len, serve_len + new):
        tok, caches = dec(ps, caches, tok.reshape(sb, 1), pos)
        toks.append(tok)
    return logits.cpu(), torch.stack(toks, 1).cpu()


def oracle_frontend(cfg, params, batches, tkw, serve_batch, serve_len: int,
                    new: int) -> dict:
    """:func:`frontend_parity_phase`'s CPU oracles: the trainer (every
    stem leaf of its first update) and the runtime's serving."""
    out = oracle_train(cfg, params, batches, tkw, "")
    t0 = time.perf_counter()
    cpu_rt = rt_make(cfg, 1, "cpu", **RT_OPTIONS)  # serves, trains nothing
    out["logits"], out["tokens"] = rt_serve_run(cpu_rt, params, serve_batch,
                                                serve_len, new)
    out["serve_s"] = time.perf_counter() - t0
    return out


def frontend_parity_phase(label: str, cfg, train_len: int, serve_batch,
                          serve_len: int, new: int, group: str,
                          stem_leaves, **fields) -> dict:
    """A stub-frontend model (``cfg``: a depth cut at full width, fp32),
    CPU against card: ``ChunkedRuntime`` 1 step and ``PatrickStarEngine``
    2 steps of 1 x ``train_len`` (losses within 1e-4 relative, the
    runtime's against the CPU trainer's first loss, :func:`rt_oracle`; the
    trainer's counters identical, K1/K2 launches as planned, and the
    stem's gradient of the first update, ``stem_leaves`` among its leaves
    (the frontend's, reached only through ``embed`` or the boundary),
    equal within 1e-4 of each leaf's largest value); then the runtime's
    prefill of ``serve_batch`` (``serve_len`` cached positions a row) and
    ``new`` greedy decode steps from the untrained weights (a step at lr
    1e-3 overshoots, and the trained model repeats one token): tokens
    identical, logits within 1e-4, K2's calls as planned.  ``group``: the
    block group whose layer 0 sizes the trainer's margin budget;
    ``fields`` join the row."""
    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    params = card_params(cfg)
    b, s, steps, rt_steps = 1, train_len, 2, 1
    batches, tkw = parity_train_setup(cfg, b, s, steps, group)
    tbudget = tkw["device_memory_bytes"]
    attn = sum(k2_layers(cfg).values())

    def reset():
        fa.launches = fa.bwd_launches = ka.launches = 0

    def counts():
        torch.cuda.synchronize()
        return dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)

    # the CPU trainer and the CPU runtime's serving, from the oracle
    # process (or here, when the phase runs alone)
    oracle = ORACLES.result(label, lambda: oracle_frontend(
        cfg, params, batches, tkw, serve_batch, serve_len, new))
    cpu_steps, stem = oracle["steps"], {"cpu": oracle["stem"]}
    cm = rt_oracle(cpu_steps, rt_steps)
    gpu_rt = rt_make(cfg, 1, "cuda", **RT_OPTIONS)
    reset()
    _, _, gm = rt_train(gpu_rt, params, batches[:rt_steps])
    rt_launches = counts()
    rt_plan = dict(fwd=2 * attn * rt_steps, bwd=attn * rt_steps,
                   adam=rt_k1_plan(gpu_rt) * rt_steps)
    if rt_launches != rt_plan:
        raise AssertionError(f"{label}: runtime launches {rt_launches}, "
                             f"the plan implies {rt_plan}")
    rt_rel = [abs(c["loss"] - g["loss"]) / abs(c["loss"]) for c, g in
              zip(cm, gm, strict=True)]
    if max(rt_rel) > 1e-4:
        raise AssertionError(f"{label}: runtime losses cpu "
                             f"{[c['loss'] for c in cm]} cuda "
                             f"{[g['loss'] for g in gm]}")

    sb = serve_batch["tokens"].shape[0]
    c_logits, c_toks = oracle["logits"], oracle["tokens"]
    fa.launches = 0
    g_logits, g_toks = rt_serve_run(gpu_rt, params, serve_batch, serve_len,
                                    new)
    serve_k2 = counts()["fwd"]
    serve_plan = attn + decode_k2_layers(cfg) * new
    logit_rel = ((g_logits - c_logits).abs().max()
                 / c_logits.abs().max()).item()
    if not torch.equal(c_toks, g_toks) or logit_rel > 1e-4 \
            or serve_k2 != serve_plan:
        raise AssertionError(f"{label}: serving tokens cpu "
                             f"{c_toks.tolist()} cuda {g_toks.tolist()}, "
                             f"logits {logit_rel}, K2 {serve_k2} (plan "
                             f"{serve_plan})")
    del gpu_rt

    reset()
    gpu, gpu_steps, stem["cuda"] = parity_trainer(cfg, params, batches,
                                                  "cuda", tkw, "")
    tr_launches = counts()
    dev = device_chunks(gpu)
    del gpu
    tr_plan = dict(fwd=2 * attn * steps, bwd=attn * steps,
                   adam=dev * (steps - 1))
    if tr_launches != tr_plan or dev < 1:
        raise AssertionError(f"{label}: trainer launches {tr_launches}, "
                             f"the plan implies {tr_plan}")
    tr_rel = []
    for i, (a, c) in enumerate(zip(cpu_steps, gpu_steps, strict=True)):
        ca = {f: getattr(a, f) for f in TRAIN_COUNTERS}
        cc = {f: getattr(c, f) for f in TRAIN_COUNTERS}
        tr_rel.append(abs(a.loss - c.loss) / abs(a.loss))
        if ca != cc or tr_rel[-1] > 1e-4:
            raise AssertionError(f"{label}: trainer step {i} loss cpu "
                                 f"{a.loss} cuda {c.loss}, counters cpu "
                                 f"{ca} cuda {cc}")
    if sum(a.h2d_bytes for a in cpu_steps) <= 0:
        raise AssertionError(f"{label}: the trainer's budget paged no chunk")
    if not set(stem_leaves) <= set(stem["cpu"]):
        raise AssertionError(f"{label}: the stem's leaves "
                             f"{sorted(stem['cpu'])} lack {stem_leaves}")
    grad_rows = {}
    for path, want in stem["cpu"].items():
        got = stem["cuda"][path]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        grad_rows[".".join(path)] = dict(max_abs=scale, max_abs_err=err)
        if not (scale > 0 and math.isfinite(err) and err <= 1e-4 * scale):
            raise AssertionError(f"{label}: stem gradient {path}: largest "
                                 f"{scale}, card against CPU {err}")
    out = dict(
        phase=label, config=cfg.name, **fields, d_model=cfg.d_model,
        train_batch=[b, s], train_steps=steps, runtime_steps=rt_steps,
        runtime=dict(losses_cpu=[c["loss"] for c in cm],
                     oracle="the CPU trainer's first loss",
                     losses_cuda=[g["loss"] for g in gm],
                     max_rel_loss_diff=max(rt_rel), launches=rt_launches,
                     planned=rt_plan),
        serving=dict(batch=sb, prompt=serve_batch["tokens"].shape[1],
                     new_tokens=new + 1, tokens=g_toks.tolist(),
                     tokens_identical=True, max_rel_logit_diff=logit_rel,
                     k2=serve_k2, k2_planned=serve_plan,
                     cpu_s=oracle["serve_s"]),
        trainer=dict(losses_cpu=[a.loss for a in cpu_steps],
                     losses_cuda=[c.loss for c in gpu_steps],
                     max_rel_loss_diff=max(tr_rel), launches=tr_launches,
                     planned=tr_plan, device_budget_bytes=tbudget,
                     os_device_chunks=dev, counters_identical=True,
                     cpu_s=oracle["cpu_s"]),
        oracle=ORACLES.row(label),
        stem_grad=grad_rows)
    emit(out)
    return out


WHISPER_PARITY = dict(num_layers=2, num_encoder_layers=2)


def whisper_parity_phase() -> dict:
    """whisper-large-v3 at full width, 2 encoder + 2 decoder layers (a
    depth cut), fp32, CPU against card (:func:`frontend_parity_phase`):
    the runtime 1 step and the trainer 2 steps of 1 x 200 tokens over 200
    frames, the first update's stem gradient (the frontend, the positions
    and ``enc_norm`` reached only through the boundary); then the
    runtime's prefill of 2 x (1500 frames + 64 tokens) and 8 greedy decode
    steps."""
    args, fields = whisper_parity_args()
    return frontend_parity_phase(*args, **fields)


def whisper_parity_args():
    """:func:`whisper_parity_phase`'s arguments of
    :func:`frontend_parity_phase` (the oracle process's job takes them
    too)."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(WHISPER).replace(param_dtype="float32",
                                      compute_dtype="float32",
                                      **WHISPER_PARITY)
    sb, sp = 2, 64
    rng = np.random.default_rng(1)
    sbatch = {"frames": rng.standard_normal(
        (sb, cfg.encoder_frames, cfg.frontend_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (sb, sp))}
    return (("whisper_parity", cfg, 200, sbatch, sp, 8, "encoder",
             [("frontend_proj",), ("enc_pos",), ("enc_norm",)]),
            dict(encoder_layers=cfg.num_encoder_layers,
                 decoder_layers=cfg.num_layers,
                 frames=min(cfg.encoder_frames, 200)))


PHI3V = "phi-3-vision-4.2b"
PHI3V_TRAIN_LAYERS = 8       # of 32: the eager trainer's depth cut
PHI3V_TRAIN = (4, 576 + 1472)  # batch x positions: the patches, then text
PHI3V_RT = (2, 576 + 3520)     # the reference's train_4k length, 4096
PHI3V_PROMPT = 448             # text tokens after the patches of a prompt
PHI3V_NEW = 16
PHI3V_TRAIN_BUDGET = 8 * GIB   # against ~16 GB of model data: chunks page
# K2 at phi-3-vision's attention (32 heads of 96 over the 576 patches and
# the text): B, Sq, Sk, H, KV, D
VLM_KERNEL_CASES = [
    # rt_phi3v's training shape and train_phi3v's (FWD, the BWD recompute
    # and the backward)
    dict(name="train", shape=(2, 4096, 4096, 32, 32, 96), causal=True,
         bwd=True, dtypes=("bfloat16",)),
    dict(name="train_eager", shape=(4, 2048, 2048, 32, 32, 96), causal=True,
         bwd=True, dtypes=("bfloat16",)),
    # phi3v_parity's fp32 length (576 patches + 64 tokens)
    dict(name="parity", shape=(1, 640, 640, 32, 32, 96), causal=True,
         bwd=True, dtypes=("float32",)),
    # serve_phi3v's prefill (576 patches + 448 tokens) and a decode step
    # over its 1040-position horizon
    dict(name="prefill", shape=(4, 1024, 1024, 32, 32, 96), causal=True,
         dtypes=("bfloat16",)),
    dict(name="decode", shape=(4, 1, 1040, 32, 32, 96), causal=True,
         q_offset=1031, kv_len=1032),
]


def vlm_kernels_phase(ptxas: dict) -> dict:
    """K2 at phi-3-vision-4.2b's head dim 96 (32 heads; the ``tc`` tiles
    are six 16-column boxes with the 32B swizzle, O += P V one n96
    product): :func:`kernel_cases_phase` over ``VLM_KERNEL_CASES`` (the
    ``tc`` forward and backward at the runtime's and the eager trainer's
    training shapes, ``tf32x3`` forward and backward at the parity phase's
    length, the prefill, ``splitkv`` decode in both dtypes), the decode
    with per-row ``kv_lens`` read from the card (:func:`kv_lens_row`, both
    dtypes), and ptxas's registers of every D = 96 instance (any spill
    raises)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    regs = {src: {name: row for name, row in rep.items() if "Li96E" in name}
            for src, rep in ptxas.items()}
    if any(row.get("spill_bytes", 0) for rep in regs.values()
           for row in rep.values()) or not all(regs.values()):
        raise AssertionError(f"vlm_kernels: the D = 96 instances are "
                             f"missing or spill: {regs}")
    emit(dict(phase="vlm_kernels_registers", **regs))
    results = kernel_cases_phase("vlm_kernels", VLM_KERNEL_CASES, 9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    for dtype in BOTH:
        results[("fwd", "decode_kvlens", dtype)] = kv_lens_row(
            dtype, gen, d=96, h=32, phase="vlm_kernels")
    for (kind, _, _), row in results.items():
        row["registers"] = regs[fa.SOURCE if kind == "fwd"
                                else fa.BWD_SOURCE]
    return results


def phi3v_extra_bytes(cfg, positions: int) -> int:
    """What a phi-3-vision layer's backward holds beside the trainer's
    budget: ten fp32 [positions, d_ff] of the gated MLP and eight fp32
    [positions, d_model] (q, k, v and the attention output with their
    gradients)."""
    return 10 * 4 * positions * cfg.d_ff + 8 * 4 * positions * cfg.d_model


def params_phi3v_phase() -> dict:
    """phi-3-vision-4.2b's weights at full depth and width (bf16, 3.74 B
    params, drawn on the card from seed 0), made once for train_phi3v
    (its first ``PHI3V_TRAIN_LAYERS`` layers) and rt_phi3v."""
    from repro_torch.configs import get_config

    return card_params(get_config(PHI3V))


def train_phi3v_phase(params) -> dict:
    """phi-3-vision-4.2b at full width, ``PHI3V_TRAIN_LAYERS`` of its 32
    layers (a depth cut for the script's time limit; 1.02 B params, ~16 GB
    of model data in fp32 payloads), on the eager trainer: bf16 compute,
    batch ``PHI3V_TRAIN`` (4 x (576 patches + 1472 text tokens); the
    loss reads the text), OPT, prefetch, the act stream and placement, a
    warm-up step, ``ZOO_TRAIN_STEPS - 1`` timed step and a profiled one,
    under ``PHI3V_TRAIN_BUDGET``.  The projector's gradient comes from
    ``backward_embed``'s VJP of ``embed``.  Text tokens/s beside positions
    a second.  The peak's limit, written down before the first run:
    budget + stem (with its gradient and moments) + 2 x the fp32 logits
    + 1 GiB + :func:`phi3v_extra_bytes`."""
    from repro_torch.configs import get_config

    cfg = get_config(PHI3V).replace(num_layers=PHI3V_TRAIN_LAYERS)
    b, s = PHI3V_TRAIN
    text = s - cfg.num_patches
    out = train_slice_phase(cfg, cut_layers(params, PHI3V_TRAIN_LAYERS),
                            budget=PHI3V_TRAIN_BUDGET, label="train_phi3v",
                            batch=(b, s),
                            extra_limit=phi3v_extra_bytes(cfg, b * s),
                            steps=ZOO_TRAIN_STEPS)
    if out["model_data_bytes"] <= PHI3V_TRAIN_BUDGET:
        raise AssertionError(f"train_phi3v: model data "
                             f"{out['model_data_bytes']} fits the budget")
    timed = out["steps_detail"][1:]
    busy = out["profiled_step"].get("device_busy_share")
    positions_per_s = out["post_warmup_tokens_per_s"]
    summary = dict(
        phase="train_phi3v_summary", layers=cfg.num_layers,
        full_depth=get_config(PHI3V).num_layers, d_model=cfg.d_model,
        batch=[b, s], patches=cfg.num_patches, text_tokens=text,
        text_tokens_per_s=positions_per_s * text / s,
        positions_per_s=positions_per_s,
        fwd_s=[r["fwd_s"] for r in timed], bwd_s=[r["bwd_s"] for r in timed],
        adam_s=[r["adam_s"] for r in timed],
        **{key: sum(r[key] for r in timed) for key in (
            "h2d_bytes", "d2h_bytes", "adam_h2d_bytes", "adam_d2h_bytes",
            "hidden_h2d_bytes", "critical_h2d_bytes")},
        max_memory_allocated=out["max_memory_allocated"],
        memory_limit=out["memory_limit"],
        idle_share=None if busy is None else 1 - busy,
        k2_launches=dict(fwd=out["launches"]["fwd"],
                         bwd=out["launches"]["bwd"]),
        k2_planned=dict(fwd=out["planned"]["fwd"], bwd=out["planned"]["bwd"]),
        k2_by_head_dims=out["k2_by_head_dims"],
        k1_launches=out["launches"]["adam"], k1_planned=out["planned"]["adam"],
        os_device_chunks=out["os_device_chunks"],
        os_host_chunks=out["os_host_chunks"],
        model_data_bytes=out["model_data_bytes"],
        chunk_bytes=out["chunk_bytes"])
    emit(summary)
    return dict(out, summary=summary)


def rt_phi3v_phase(params) -> dict:
    """phi-3-vision-4.2b at full depth and width on the runtime
    (:func:`rt_full_phase`): 2 timed steps of ``PHI3V_RT`` (2 x (576
    patches + 3520 text tokens)).  Returns the runtime for
    serve_phi3v."""
    from repro_torch.configs import get_config

    cfg = get_config(PHI3V)
    return rt_full_phase("rt_phi3v", cfg, params, PHI3V_RT,
                         layers=cfg.num_layers, patches=cfg.num_patches)


def serve_phi3v_phase(rp, params) -> dict:
    """phi-3-vision-4.2b served at full depth through the runtime's
    serving steps (:func:`serve_full`; the reference serves the vlm family
    only there: its ``ServingEngine`` refuses patch-input archs): a
    prefill of 4 sequences, each 576 patches and a ``PHI3V_PROMPT`` token
    prompt (1024 cached positions), then ``PHI3V_NEW`` greedy decode steps
    from position 1024 over a 1040-position horizon.  K2's plan: a prefill
    one call a layer (``tc``), a decode step one a layer (``splitkv``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    cfg = rp["rt"].cfg
    b, p, new = 4, PHI3V_PROMPT, PHI3V_NEW
    s = cfg.num_patches + p
    rng = np.random.default_rng(0)
    batch = {"patch_embeds": rng.standard_normal(
        (b, cfg.num_patches, cfg.vision_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (b, p))}
    plan = dict(prefill=cfg.num_layers, decode=cfg.num_layers * new)
    out = serve_full("serve_phi3v", rp, params, batch, s, new, plan)
    out.update(
        layers=cfg.num_layers, patches=cfg.num_patches,
        prefill_positions_per_s=b * s / out["prefill_s"],
        k2_schedules=dict(
            prefill=fa.plan_forward(b, s, s, cfg.n_heads,
                                    torch.bfloat16).schedule,
            decode=fa.plan_forward(b, 1, s + new, cfg.n_heads,
                                   torch.bfloat16, q_offset=s + new - 1,
                                   kv_len=s + new).schedule))
    emit(out)
    return out


PHI3V_PARITY_LAYERS = 2


def phi3v_parity_phase() -> dict:
    """phi-3-vision-4.2b at full width, ``PHI3V_PARITY_LAYERS`` layers (a
    depth cut), fp32, CPU against card (:func:`frontend_parity_phase`):
    the runtime 1 step and the trainer 2 steps of 1 x (576 patches + 64
    text tokens), the first update's stem gradient (the projector's w1
    and w2 among its leaves, reached only through ``embed``); then the
    runtime's prefill of 1 x (576 patches + 64 tokens) and 8 greedy
    decode steps from position 640."""
    args, fields = phi3v_parity_args()
    return frontend_parity_phase(*args, **fields)


def phi3v_parity_args():
    """:func:`phi3v_parity_phase`'s arguments of
    :func:`frontend_parity_phase`."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(PHI3V).replace(param_dtype="float32",
                                    compute_dtype="float32",
                                    num_layers=PHI3V_PARITY_LAYERS)
    text = 64
    rng = np.random.default_rng(1)
    sbatch = {"patch_embeds": rng.standard_normal(
        (1, cfg.num_patches, cfg.vision_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (1, text))}
    s = cfg.num_patches + text
    return (("phi3v_parity", cfg, s, sbatch, s, 8, "layers",
             [("projector", "w1"), ("projector", "w2")]),
            dict(layers=cfg.num_layers, patches=cfg.num_patches,
                 text_tokens=text))


# ---------------------------------------------------- nemotron-4-340b
NEMOTRON = "nemotron-4-340b"
# serve_nemotron's requests: the slice's prompts, 4 new tokens each (16 in
# the slice; 8 until the tensor-parallel phases joined: cut for the
# script's time limit, each decode round pages the whole param stream in
# over PCIe)
NEMOTRON_NEW = 4
# its depth: 2 of the 96 layers (3 before the dry-run's phase joined, for
# the script's time limit: at 2 the 34.4 GB fp32 stream still pages
# through the 25 GiB budget every round; 4 layers are 55.3 GB of fp32
# payloads, 68.7 GB in pinned blocks, and the compiled engine's bf16
# stores beside the budget outgrow the card), fewer where the host cannot
# hold the pinned tier or the card the compiled engine's bf16 stores
# beside the budget (params_nemotron)
NEMOTRON_SERVE_LAYERS = 2
# a param chunk: 2^31 fp32 elements, 8 GiB, exactly the pinned allocator's
# block; a chunk must hold one MLP matrix (18432 x 73728 = 1.359 B
# elements, 5.44 GB), which any size rounds up to that block anyway, and
# this one packs a layer's attention beside a matrix (8 chunks for 4
# layers, where 1.359 B-element chunks take 12)
NEMOTRON_CHUNK = 1 << 31
# serve_nemotron's prefill batch: the engines' own choice at its budget
# (min(8, the kv chunks that fit beside a layer's param chunks)), given to
# the eager engine before the compiled one exists (the compiled engine's
# is checked against it)
NEMOTRON_PREFILL_BATCH = 8
# nemotron_parity's configuration: the smoke config at the real head dim
# (192) and the real 12:1 GQA, 12 heads at 2304 wide, the MLP at 4 x,
# 2 layers, fp32 (the smoke config's head dim 48 is no K2 head dim)
NEMOTRON_PARITY = dict(head_dim=192, n_heads=12, n_kv_heads=1, d_model=2304,
                       d_ff=9216, num_layers=2, param_dtype="float32",
                       compute_dtype="float32")
NEMOTRON_PARITY_LEN = 512  # training tokens; serving 2 x 128 and 8 new
# K2 at nemotron's attention (96 heads of 192, 8 kv heads): B, Sq, Sk, H,
# KV, D; the plain version one kv head's 12 query heads at a time where
# the whole would hold [Sq, Sk] fp32 scores for all 96
NEMOTRON_KERNEL_CASES = [
    # the training shape (one 4096-token sequence), forward and backward
    dict(name="train", shape=(1, 4096, 4096, 96, 8, 192), causal=True,
         bwd=True, dtypes=("bfloat16",), grouped=True),
    # serve_nemotron's prefill: its cohorts are 2 x 512 and 2 x 500
    dict(name="prefill", shape=(4, 512, 512, 96, 8, 192), causal=True,
         dtypes=("bfloat16",), grouped=True),
    # a decode step over serve_nemotron's 1024-row horizon
    dict(name="decode", shape=(4, 1, 1024, 96, 8, 192), causal=True,
         q_offset=1023, kv_len=1024),
    # nemotron_parity's fp32 training length at its 12 heads, 1 kv head
    dict(name="parity", shape=(1, NEMOTRON_PARITY_LEN, NEMOTRON_PARITY_LEN,
                               12, 1, 192), causal=True, bwd=True,
         dtypes=("float32",)),
]


def nemotron_kernels_phase(ptxas: dict) -> dict:
    """K2 at nemotron-4-340b's (D, Dv) = (192, 192), 96 heads over 8 kv
    heads: :func:`kernel_cases_phase` over ``NEMOTRON_KERNEL_CASES`` (the
    ``tc`` forward and backward at the training shape, the prefill, the
    ``splitkv`` decode in both dtypes, ``tf32x3`` forward and backward at
    nemotron_parity's length), the decode with per-row ``kv_lens`` read
    from the card (:func:`kv_lens_row`, both dtypes, GQA 96/8), and
    ptxas's registers and spill of every (192, 192) instance (any spill
    raises)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    # (192, 192)'s instances: every 192 one but MLA's (192, 128)
    regs = {src: {name: row for name, row in rep.items()
                  if "Li192E" in name and "Li128E" not in name}
            for src, rep in ptxas.items()}
    if any(row.get("spill_bytes", 0) for rep in regs.values()
           for row in rep.values()) or not all(regs.values()):
        raise AssertionError(f"nemotron_kernels: the (192, 192) instances "
                             f"are missing or spill: {regs}")
    emit(dict(phase="nemotron_kernels_registers", **regs))
    results = kernel_cases_phase("nemotron_kernels", NEMOTRON_KERNEL_CASES,
                                 11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in BOTH:
        results[("fwd", "decode_kvlens", dtype)] = kv_lens_row(
            dtype, gen, d=192, h=96, kv=8, phase="nemotron_kernels")
    for (kind, _, _), row in results.items():
        row["registers"] = regs[fa.SOURCE if kind == "fwd"
                                else fa.BWD_SOURCE]
    return results


def nemotron_weights(cfg, seed: int = 0, device: str = "cuda",
                     stem_fp32: bool = False) -> dict:
    """``cfg``'s weights drawn on the card from ``seed`` in the param
    dtype (bf16), in ``init_params``' order (the same values at every
    call): the stem then each layer, written into the stacked layers as
    it is drawn.  The layers stay on the card; the stem goes to the host
    or, with ``stem_fp32``, stays on the card cast to fp32 (the eager
    engine's own copy, which it then keeps without copying).  At 4 of
    nemotron's layers the stem and the layers are 46.5 GB in bf16: on the
    card beside an engine's own stem (the eager one's fp32, 37.75 GB; the
    compiled one's bf16 stores) they would not fit its 80 GB, and on the
    host beside the pinned stream (68.7 GB) not its ~95 GB.  Each engine
    copies the layers into its pinned host stream (the compiled one into
    its stores too); the phases hand it this function, so that it holds
    the only reference and lets the weights go once it is built."""
    import torch

    from repro_torch.configs import model_class
    from repro_torch.models.api import tree_map
    from repro_torch.models.layers import AxisCtx

    model = model_class(cfg)(cfg, AxisCtx())
    (group,) = model.groups()
    gen = torch.Generator(device=device).manual_seed(seed)

    def put(dst, src, i):
        for key, val in src.items():
            if isinstance(val, dict):
                put(dst[key], val, i)
            else:
                dst[key][i] = val

    with torch.device(device):
        stem = model.init_stem(gen)
        stem = tree_map(lambda t: t.float() if stem_fp32 else t.cpu(), stem)
        torch.cuda.empty_cache()
        stacked = None
        for i in range(group.length):
            layer = group.init_layer(gen)
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty((group.length,
                                                          *t.shape)), layer)
            put(stacked, layer, i)
            del layer
    torch.cuda.empty_cache()
    return {"stem": stem, "groups": {group.name: stacked}}


def params_nemotron_phase() -> dict:
    """nemotron-4-340b's serving plan at full width (96 heads of 192 over 8
    kv heads, d_model 18432, d_ff 73728, vocab 256,000, untied): the
    param chunk map of ``NEMOTRON_CHUNK`` (8 GiB) chunks, the depth and
    the device budget, which holds one layer's chunks (the most a layer
    spans) and every sequence's KV but not the stream, so every round
    pages the stream in: the least whole GiB above them.  The weights are
    not kept: serve_nemotron draws them for each engine
    (:func:`nemotron_weights`, seed 0: the same values).  The host's free
    room comes first (after the pinned cache and glibc's free heap went
    back, :func:`wait_host_room`); the depth is ``NEMOTRON_SERVE_LAYERS``
    unless the host cannot hold the pinned tier (every chunk of the
    stream in an 8 GiB pinned block), the bf16 stem the compiled engine
    copies from (18.9 GB) and 4 GiB, or the card the compiled engine's
    bf16 stores (the runtime's padded layout: 55.4 GB at 4 layers) with
    the budget and 4 GiB; then fewer, never a narrower width."""
    import torch

    from repro_torch.configs import get_config, model_class
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

    cfg = get_config(NEMOTRON)
    release = release_host_memory()
    stem_host = 2 * (2 * cfg.vocab_size + 1) * cfg.d_model  # bf16
    block = pinned_block(NEMOTRON_CHUNK * 4)

    def plan(layers: int):
        return chunk_plan(cfg.replace(num_layers=layers),
                          chunk_size=NEMOTRON_CHUNK)

    def host_need(layers: int) -> int:
        return plan(layers).num_payload_chunks * block + stem_host + 4 * GIB

    waited = wait_host_room(host_need(NEMOTRON_SERVE_LAYERS), timeout=30.0)
    mem = dict(meminfo(), **waited)
    card = torch.cuda.get_device_properties(0).total_memory
    # a (sequence, layer) kv chunk: k and v over the 1024-row horizon, fp32
    kv_chunk = 2 * 1024 * cfg.n_kv_heads * cfg.head_dim * 4

    def layer_chunks(layers: int) -> int:
        """The most chunks one layer spans."""
        spans = {}
        for p in plan(layers).placements:
            spans.setdefault(p.name.split("[")[0], set()).add(p.chunk_id)
        return max(len(c) for c in spans.values())

    def budget_of(layers: int) -> int:
        need = (layer_chunks(layers) * NEMOTRON_CHUNK * 4
                + 4 * layers * kv_chunk)
        return -(-need // GIB) * GIB

    def store_bytes(layers: int) -> int:
        # the compiled engine's bf16 stores: the runtime's padded layouts
        c = cfg.replace(num_layers=layers)
        rt = ChunkedRuntime(model_class(c), c,
                            make_smoke_mesh(1, 1, device="cpu"),
                            RuntimeOptions())
        return sum(math.prod(rt.store_shape(name))
                   * rt.layouts[name].dtype.itemsize
                   for name in rt.layouts)

    def card_need(layers: int) -> int:
        return store_bytes(layers) + budget_of(layers) + 4 * GIB

    layers, cuts = NEMOTRON_SERVE_LAYERS, []
    while layers > 1 and (host_need(layers) > mem["room"]
                          or card_need(layers) > card):
        cuts.append(f"{layers} layers need {host_need(layers)} bytes of "
                    f"the host's {mem['room']} free and {card_need(layers)}"
                    f" of the card's {card}")
        layers -= 1
    cmap = plan(layers)
    budget = budget_of(layers)
    stream = cmap.num_payload_chunks * NEMOTRON_CHUNK * 4
    if budget >= stream:
        raise AssertionError(f"params_nemotron: the budget {budget} holds "
                             f"the stream {stream} at {layers} layers")
    model_bytes = 4 * sum(p.numel for p in cmap.placements)
    out = dict(
        phase="params_nemotron", config=cfg.name, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, meminfo=mem,
        release_seconds=release, layers=layers, full_layers=cfg.num_layers,
        depth_cut=f"{cfg.num_layers} -> {layers} layers: the host holds "
        f"the param stream in pinned blocks (at most "
        f"{NEMOTRON_SERVE_LAYERS} layers, {NEMOTRON_SERVE_LAYERS * 13.8:.1f}"
        f" GB of fp32 payloads)" + "".join(f"; {c}" for c in cuts),
        card_total_memory=card, compiled_store_bytes=store_bytes(layers),
        card_need_bytes=card_need(layers),
        chunk_elems=NEMOTRON_CHUNK, chunk_bytes=NEMOTRON_CHUNK * 4,
        pinned_block_bytes=block, chunks=cmap.num_payload_chunks,
        layer_chunks=layer_chunks(layers), param_stream_bytes=stream,
        model_bytes_fp32=model_bytes, stem_bytes_bf16=stem_host,
        host_need_bytes=host_need(layers), kv_chunk_bytes=kv_chunk,
        kv_bytes=4 * layers * kv_chunk, device_budget_bytes=budget)
    emit(out)
    return out


def serve_nemotron_phase(plan: dict) -> dict:
    """nemotron-4-340b at full width, ``plan["layers"]`` deep
    (params_nemotron), bf16 compute, the slice's requests (prompts
    512/512/500/500, ``NEMOTRON_NEW`` new tokens each, horizon 1024)
    under ``plan["device_budget_bytes"]``, which holds one layer's param
    chunks and the KV but not the stream: the eager ``ServingEngine`` one
    sequence a decode call with the compiled engine's prefill batch
    (``NEMOTRON_PREFILL_BATCH``: the replay's choreography, so its
    counters are the compiled engine's exact oracle), then the
    ``CompiledServingEngine``.  Each builds from its own draw of the
    weights (:func:`nemotron_weights`, the same values): the eager one
    keeps its fp32 stem on the card (37.75 GB, drawn there), the
    compiled one its bf16 stores (46.6 GB at 3 layers; its stem comes
    from the host), both the fp32 stream in pinned host blocks, which the
    compiled engine takes over from PyTorch's host cache.  Gates: K2 as
    planned in both; the compiled counters equal the eager ones; every
    round pages in at least the part of the param stream the budget
    cannot keep (reported beside the stream: a round's share of it); one
    decode graph at 4 slots; prefill tokens equal (decode tokens compared
    and reported: the eager engine's GEMMs run on fp32 payloads, the
    compiled engine's on bf16 stores); each run's peak within its limit,
    the construction's peak (the weights it copies from beside its own
    copies) reported apart.  No budget that holds the stream is run: the
    stream and an engine's stem exceed the card (printed)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(NEMOTRON).replace(num_layers=plan["layers"])
    budget = plan["device_budget_bytes"]
    stream = plan["param_stream_bytes"]

    def weights(stem_fp32=False):
        return nemotron_weights(cfg, stem_fp32=stem_fp32)

    sl = slice_phase(cfg, lambda: weights(stem_fp32=True), budget=budget,
                     label="serve_nemotron_eager", chunk_size=NEMOTRON_CHUNK,
                     new_tokens=NEMOTRON_NEW, setup_peak=True,
                     engine_kw=dict(max_decode_batch=1,
                                    max_prefill_batch=NEMOTRON_PREFILL_BATCH))
    # the compiled engine takes the eager engine's pinned blocks from
    # PyTorch's host cache (pinning them again took ~20 s) where the host
    # still holds the stem it copies from beside them; else they go back
    # first (the host cannot hold two streams)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    beside = plan["stem_bytes_bf16"] + 4 * GIB
    host = dict(phase="serve_nemotron_host", after_eager=meminfo(),
                pinned_after_eager=torch.cuda.host_memory_stats().get(
                    "allocated_bytes.current"),
                beside_cached_blocks=wait_host_room(beside, timeout=15.0))
    host["reuse_pinned_blocks"] = host["beside_cached_blocks"]["room"] \
        >= beside
    need = beside if host["reuse_pinned_blocks"] else plan["host_need_bytes"]
    if not host["reuse_pinned_blocks"]:
        host["release_seconds"] = release_host_memory(trim=False)
        host["released"] = wait_host_room(need)
    emit(host)
    if host_room() < need:
        raise AssertionError(f"serve_nemotron: after the eager engine the "
                             f"host has {host_room()} bytes, the compiled "
                             f"engine needs {need}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (512, 512, 500, 500)]
    label = "serve_nemotron compiled"
    # the last decode round, a replay (round 0 prefills)
    r = compiled_run(cfg, weights, prompts, budget,
                     profile_round=NEMOTRON_NEW - 1,
                     new_tokens=NEMOTRON_NEW, setup_peak=True,
                     chunk_size=NEMOTRON_CHUNK)
    eng, rounds = r["eng"], r["rounds"]
    calls = k2_calls(eng)
    planned = k2_plan(cfg, rounds)
    if calls["total"] != planned or r["launches"] != calls["eager_launches"]:
        raise AssertionError(f"{label}: K2 calls {calls}, the plan implies "
                             f"{planned}")
    if (eng.decode_compile_count, eng.padded_slots,
            eng.max_prefill_batch) != (1, 4, NEMOTRON_PREFILL_BATCH):
        raise AssertionError(f"{label}: {eng.decode_compile_count} decode "
                             f"graphs at {eng.padded_slots} slots, prefill "
                             f"batch {eng.max_prefill_batch}")
    rows = round_rows(rounds)
    if rows != sl["round_counters"]:
        raise AssertionError(f"{label}: counters differ from the eager "
                             f"engine's from round "
                             f"{first_difference(sl['round_counters'], rows)}")
    # every round brings in at least the part of the stream the budget
    # cannot keep (OPT keeps what the next round reads first: at 4 layers
    # the decode rounds paged the whole stream, at fewer part of it stays)
    short = [(i, c["h2d_bytes"]) for i, c in enumerate(rows)
             if c["h2d_bytes"] < stream - budget]
    if short:
        raise AssertionError(f"serve_nemotron: rounds (index, h2d bytes) "
                             f"{short} paged in less than the param "
                             f"stream's {stream} bytes less the budget's "
                             f"{budget}")
    store_bytes = sum(t.numel() * t.element_size()
                      for t in eng._pstores.values())
    slot_bytes = sum(t.numel() * t.element_size()
                     for tree in eng._slot_caches.values()
                     for t in tree.values())
    limit = (r["at_start"] + budget + eng.stem_bytes + store_bytes
             + slot_bytes + GIB)
    if r["peak"] > limit:
        raise AssertionError(f"{label}: max_memory_allocated {r['peak']} > "
                             f"{limit}")
    toks = [eng.result(i) for i in range(len(prompts))]
    if any(len(t) != NEMOTRON_NEW or not all(0 <= x < cfg.vocab_size
                                             for x in t) for t in toks):
        raise AssertionError(f"{label}: tokens {toks}")
    eager = sl["tokens"]
    if [t[0] for t in eager] != [t[0] for t in toks]:
        raise AssertionError(f"{label}: prefill tokens "
                             f"{[t[0] for t in toks]} differ from the eager "
                             f"engine's {[t[0] for t in eager]}")
    prof = dict(device_time_breakdown(r["prof"], r["prof_wall"],
                                      kinds=RT_KINDS),
                top_kernels=top_kernels(r["prof"]))
    comp = dict(
        phase="serve_nemotron_compiled", device_budget_bytes=budget,
        setup_s=r["setup_s"], rounds=len(rounds), tokens=toks,
        round_counters=rows, round_wall_s=[m.wall_s for m in rounds],
        round_decode_s=[t["decode_s"] for t in eng.round_times],
        round_prefill_s=[t["prefill_s"] for t in eng.round_times],
        round_replay_s=[t["replay_s"] for t in eng.round_times],
        graph_replay_device_ms=eng.decode_graph.device_ms,
        graph_warmup_s=eng.decode_graph.warmup_s,
        h2d_bytes=sum(m.h2d_bytes for m in rounds),
        d2h_bytes=sum(m.d2h_bytes for m in rounds),
        **tok_rates(rounds, eng.round_times), k2=calls, k2_planned=planned,
        padded_slots=eng.padded_slots,
        max_prefill_batch=eng.max_prefill_batch,
        max_memory_allocated=r["peak"],
        setup_max_memory_allocated=r["setup_peak"], memory_limit=limit,
        store_bytes=store_bytes, slot_cache_bytes=slot_bytes,
        counters_equal_eager=True, prefill_tokens_equal_eager=True,
        decode_tokens_equal_eager=[t[1:] == e[1:]
                                   for t, e in zip(toks, eager)],
        profiled_round=NEMOTRON_NEW - 1, profiled_round_device=prof)
    emit(comp)
    del r, eng
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    summary = dict(
        phase="serve_nemotron_summary", config=cfg.name,
        layers=cfg.num_layers, full_layers=plan["full_layers"],
        depth_cut=plan["depth_cut"], d_model=cfg.d_model,
        new_tokens=NEMOTRON_NEW,
        new_tokens_cut="16 -> 8 -> 4: the script's time limit (each "
        "round pages most of the param stream in)",
        chunk_bytes=plan["chunk_bytes"],
        pinned_block_bytes=plan["pinned_block_bytes"],
        param_stream_bytes=stream, device_budget_bytes=budget,
        h2d_bytes_a_round=[c["h2d_bytes"] for c in rows],
        stream_share_a_round=[c["h2d_bytes"] / stream for c in rows],
        d2h_bytes_a_round=[c["d2h_bytes"] for c in rows],
        eager=dict(prefill_tok_per_s=sl["prefill_tok_per_s"],
                   decode_tok_per_s=sl["decode_tok_per_s"],
                   round_wall_s=sl["round_wall_s"], setup_s=sl["setup_s"],
                   max_memory_allocated=sl["max_memory_allocated"],
                   setup_max_memory_allocated=sl[
                       "setup_max_memory_allocated"],
                   memory_limit=sl["memory_limit"],
                   k2_launches=sl["k2_launches"],
                   k2_by_head_dims=sl["k2_by_head_dims"]),
        compiled={key: comp[key] for key in (
            "prefill_tok_per_s", "decode_tok_per_s", "round_wall_s",
            "round_decode_s", "round_prefill_s", "round_replay_s",
            "graph_replay_device_ms", "setup_s", "max_memory_allocated",
            "setup_max_memory_allocated", "memory_limit", "k2",
            "decode_tokens_equal_eager")},
        fit_budget=f"not run: a budget that holds the stream ({stream} "
        f"bytes) and the KV, beside the eager engine's fp32 stem "
        f"({sl['stem_bytes']}) or the compiled engine's stores "
        f"({store_bytes}), exceeds the card's {total} bytes",
        card_total_memory=total)
    emit(summary)
    return dict(summary, k2_eager=sl["k2_launches"],
                k2_compiled=calls["total"])


def nemotron_parity_phase() -> dict:
    """nemotron-4-340b's structure at a reduced width with the real head
    dim (``NEMOTRON_PARITY``: 12 heads of 192 over one kv head, 2304
    wide, a squared-ReLU un-gated MLP of 9216, the untied head, 2 layers,
    fp32), CPU against card (:func:`frontend_parity_phase`): the runtime 1
    step and the eager trainer 2 steps of 1 x ``NEMOTRON_PARITY_LEN``
    tokens (``tf32x3`` forward and backward at (192, 192)), the first
    update's gradient of the untied head and of the embedding; then the
    runtime's prefill of 2 x 128 tokens and 8 greedy decode steps
    (``splitkv`` at (192, 192), fp32).  The configuration lives here
    only; the registry holds the published one."""
    args, fields = nemotron_parity_args()
    return frontend_parity_phase(*args, **fields)


def nemotron_parity_args():
    """:func:`nemotron_parity_phase`'s arguments of
    :func:`frontend_parity_phase`."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(NEMOTRON, smoke=True).replace(
        name="nemotron-parity", **NEMOTRON_PARITY)
    rng = np.random.default_rng(1)
    sbatch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 128))}
    return (("nemotron_parity", cfg, NEMOTRON_PARITY_LEN, sbatch, 128, 8,
             "layers", [("unembed", "table"), ("embed", "table")]),
            dict(layers=cfg.num_layers, heads=[cfg.n_heads, cfg.n_kv_heads],
                 head_dim=cfg.head_dim, d_ff=cfg.d_ff))


# ------------------------------------------------- tensor parallelism
TP_ARCH = "qwen2.5-3b"
# tp_parity: 2 of the 36 layers at full width, fp32, the same global
# weights and batches through the runtime at each tp; tp=2 keeps the
# "tp" cache plan (2 kv heads), tp=4 takes the "dist" one
TP_PARITY_LAYERS = 2
TP_PARITY_TPS = (1, 2, 4)
TP_PARITY_TRAIN = (2, 256)  # batch, tokens; 2 steps
TP_PARITY_SERVE = (2, 128, 8)  # prompts, prompt tokens, greedy tokens
# rt_tp: full depth and width, bf16, the optimizer state on the card
RT_TP = dict(dp=2, tp=2, batch=(8, 1024), steps=3, block=256)
RT_TP_OPTIONS = dict(remat="full", gather_policy="layer", xent_block=256,
                     weight_decay=0.1)
# serve_tp: full depth and width, bf16, tp=4 (the "dist" cache) against
# tp=1 on the same weights
SERVE_TP = dict(tp=4, batch=4, prompt=512, new=16)


def tp_k2_plan(cfg, rt, steps: int) -> dict:
    """K2 launches of ``steps`` runtime steps: every model rank of every
    data rank runs its own heads' attention, twice an attention layer
    forward under full remat and once backward (:func:`k2_layers`: every
    layer of a dense model, zamba's shared block once a unit, none of
    xLSTM's); K1 once a model rank's owned slice."""
    n = (sum(k2_layers(cfg).values()) * rt.ctx.tp * rt.ctx.dp
         * rt.ctx.pods)
    return dict(fwd=2 * n * steps, bwd=n * steps,
                adam=rt_k1_plan(rt) * steps)


def tp_serve_plan(cfg, tp: int, decodes: int) -> dict:
    """K2 launches of a prefill and ``decodes`` decode steps: one an
    attention layer and model rank each, but for the "dist" cache plan's
    decode, whose partial attention is the reference's plain product (no
    kernel)."""
    from repro_torch.models.layers import decode_cache_plan

    dist = decode_cache_plan(cfg, tp)[0] == "dist"
    return dict(prefill=sum(k2_layers(cfg).values()) * tp,
                decode=0 if dist else decode_k2_layers(cfg) * tp * decodes)


def tp_global(rt, store) -> dict:
    """A runtime's ``[tp, ...]`` store (params or fp32 master weights) ->
    the global param tree (``driver.global_params``: sharded leaves
    joined by the model's split rule, replicated leaves rank 0's), a list
    of layer trees a store, after checking every rank's copy of every
    replicated leaf is bitwise equal to rank 0's (raises otherwise).
    Returns (tree, replicated elements checked)."""
    import torch

    from repro_torch.models.api import tree_map
    from repro_torch.models.tp import replicated_ranges
    from repro_torch.runtime import driver

    tp, checked = rt.ctx.tp, 0
    for name, lay in rt.layouts.items():
        axes = (rt.tp_axes["stem"] if name == "stem"
                else rt.tp_axes["groups"][name])
        flat = store[name].reshape(tp, -1, lay.capacity)
        for off, n in replicated_ranges(lay, axes):
            seg = flat[..., off:off + n]
            for r in range(1, tp):
                if not torch.equal(seg[r], seg[0]):
                    raise AssertionError(
                        f"tp_parity: replicated {name} leaf at {off} "
                        f"differs across ranks")
                checked += seg[r].numel()
    tree = driver.global_params(rt, store)
    out = {"stem": [tree["stem"]]}
    for g, stacked in tree["groups"].items():
        out[g] = [tree_map(lambda t, _i=i: t[_i], stacked)
                  for i in range(rt.group_lengths[g])]
    return out, checked


def tp_grad_stores(grads) -> dict:
    """``ChunkedRuntime.grads``' gradients (``{"stem": [G, p, S], group:
    [L x [G, p, S]]}``, each a ``Ranks`` of the model ranks' at tp > 1)
    -> ``[tp, ...]`` stores laid out as the param stores, for
    :func:`tp_global`."""
    import torch

    from repro_torch.models.tp import shards

    return {name: torch.stack(shards(g)) if name == "stem"
            else torch.stack([torch.stack(shards(x)) for x in g], 1)
            for name, g in grads.items()}


def tp_grad_gaps(got: dict, want: dict, tol: float) -> dict:
    """Every gradient leaf of ``got`` against ``want`` (trees from
    :func:`tp_global`), layer by layer, relative to the leaf's largest
    ``want`` value, as the CPU tests hold them.  Raises if a leaf is past
    ``tol``; returns the worst ratio and the leaf it is on."""
    from repro_torch.models.api import flatten_with_paths

    worst, where = 0.0, None
    for name, layers in want.items():
        for layer, (gl, wl) in enumerate(zip(got[name], layers)):
            for (path, g), (_, w) in zip(flatten_with_paths(gl),
                                         flatten_with_paths(wl)):
                leaf = f"{name}[{layer}].{'.'.join(path)}"
                rel = float((g - w).abs().max()) / float(w.abs().max())
                if rel > tol:
                    raise AssertionError(f"tp_parity: gradient {leaf} "
                                         f"differs by {rel} of its largest "
                                         f"value > {tol}")
                if rel >= worst:
                    worst, where = rel, leaf
    return dict(grad_max_rel_err=worst, grad_worst_leaf=where)


def tp_parity_runs(label: str, cfg, params, tps, train, serve,
                   lr: float = 1e-3) -> dict:
    """The runtime at each tp of ``tps`` (the first is 1, the oracle; one
    data rank, the model ranks simulated on the card) from one set of
    global weights and one batch stream: the first batch's gradients
    before any update, ``len(train[2])`` training steps, then a prefill
    of ``serve``'s prompts and greedy tokens from the initial weights.
    Gates, each tp > 1 against tp = 1: every gradient leaf, reassembled
    from the shards, within 2e-4 of its largest tp = 1 value (the CPU
    tests' rule, :func:`tp_grad_gaps`), the replicated leaves' gradient
    copies bitwise equal across ranks; every loss within 1e-5 relative;
    the updated fp32 master weights, reassembled, within 1e-5 but for at
    most 1e-4 of the elements of a store, all within ADAM's bound (2 lr a
    step: the CPU tests' rule), their replicated copies bitwise equal;
    the greedy tokens identical; K2 and K1 launches equal the plan.
    Emits a ``<label>_run`` line a tp; returns the runs by tp."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core.engine import to_device_batch
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import flatten_with_paths
    from repro_torch.models.layers import AxisCtx, decode_cache_plan, \
        greedy_token
    from repro_torch.runtime import driver

    batches, prompts, new = train, serve[0], serve[1]
    steps = len(batches)
    pb, plen = prompts.shape
    runs, ref = {}, None
    for tp in tps:
        gc.collect()
        torch.cuda.empty_cache()
        w0 = time.perf_counter()
        rt = rt_make(cfg, 1, "cuda", tp=tp, lr=lr)
        fa.launches = fa.bwd_launches = ka.launches = 0
        ps, os_, mets = rt_train(rt, params, batches)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - w0
        launches = dict(fwd=fa.launches, bwd=fa.bwd_launches,
                        adam=ka.launches)
        plan = tp_k2_plan(cfg, rt, steps)
        if launches != plan:
            raise AssertionError(f"{label}: tp={tp} launches {launches}, "
                                 f"the plan implies {plan}")
        master, checked = tp_global(
            rt, {k: v["p32"]["dev"] for k, v in os_.items()})
        tp_global(rt, ps)  # the param stores' copies too
        # the first batch's gradients at the initial weights, before ADAM
        # (which barely reacts to a gradient's scale); their replicated
        # copies checked bitwise equal by tp_global.  Served from these
        # stores too (two steps at lr 1e-3 overshoot: the trained model
        # repeats one token)
        ps = driver.param_stores(rt, params)
        _, _, grads = rt.grads(ps, to_device_batch(batches[0], rt.device))
        grads, grad_checked = tp_global(rt, tp_grad_stores(grads))
        pre, _ = driver.build_prefill_step(
            rt, InputShape("serve", plen, pb, "prefill"))
        dshape = InputShape("serve", plen + new, pb, "decode")
        dec, _ = driver.build_decode_step(rt, dshape)
        fa.launches = 0
        logits, caches = pre(ps, {"tokens": prompts})
        torch.cuda.synchronize()
        pre_k2 = fa.launches
        caches = driver.grow_caches(rt, caches, plen, plen + new, dshape)
        tok = greedy_token(logits, cfg.vocab_size, AxisCtx())
        toks = [tok]
        fa.launches = 0
        for pos in range(plen, plen + new - 1):
            tok, caches = dec(ps, caches, tok.reshape(pb, 1), pos)
            toks.append(tok)
        torch.cuda.synchronize()
        serve_plan = tp_serve_plan(cfg, tp, new - 1)
        served = dict(prefill=pre_k2, decode=fa.launches)
        if served != serve_plan:
            raise AssertionError(f"{label}: tp={tp} serving K2 {served}, "
                                 f"the plan implies {serve_plan}")
        run = dict(tp=tp, losses=[m["loss"] for m in mets],
                   launches=launches, planned=plan, k2_serving=served,
                   k2_serving_planned=serve_plan,
                   replicated_elements_equal=checked,
                   replicated_grad_elements_equal=grad_checked,
                   tokens=torch.stack(toks, 1).cpu().tolist(),
                   cache_plan=list(decode_cache_plan(cfg, tp)),
                   cache_shapes={".".join(p): list(t.shape) for p, t in
                                 flatten_with_paths(caches)},
                   tp_bytes=mets[-1]["collectives"]["tp_bytes"],
                   train_s=train_s, wall_s=time.perf_counter() - w0)
        logits = logits.float()
        if ref is None:
            ref = dict(run=run, master=master, logits=logits, grads=grads)
        else:
            run.update(tp_grad_gaps(grads, ref["grads"], 2e-4))
            rl = ref["run"]["losses"]
            if any(abs(g - w) > 1e-5 * abs(w) for g, w in zip(run["losses"],
                                                            rl)):
                raise AssertionError(f"{label}: tp={tp} losses "
                                     f"{run['losses']} against tp=1's {rl}")
            # the CPU tests' rule, per store: every element within 1e-5
            # but for at most 1e-4 of them (ADAM's sign flips where a
            # first gradient is near zero, e.g. the k bias's, which the
            # softmax cancels), all within ADAM's bound below
            worst, far, n = 0.0, 0, 0
            for name, layers in master.items():
                far_s, n_s = 0, 0
                for got, want in zip(layers, ref["master"][name]):
                    for (path, g), (_, w) in zip(flatten_with_paths(got),
                                                 flatten_with_paths(want)):
                        err = (g - w).abs()
                        worst = max(worst, float(err.max()))
                        far_s += int((err > 1e-5).sum())
                        n_s += err.numel()
                if far_s > 1e-4 * n_s:
                    raise AssertionError(
                        f"{label}: tp={tp} {name}: {far_s} of {n_s} "
                        f"elements past 1e-5")
                far, n = far + far_s, n + n_s
            if worst > 2 * steps * lr:
                raise AssertionError(f"{label}: tp={tp} master weights "
                                     f"differ by {worst} > ADAM's bound")
            if run["tokens"] != ref["run"]["tokens"]:
                raise AssertionError(
                    f"{label}: tp={tp} tokens {run['tokens']} against "
                    f"tp=1's {ref['run']['tokens']}")
            run.update(master_max_abs_err=worst, master_elems_past_1e5=far,
                       master_elems=n,
                       logits_max_abs_err=float(
                           (logits - ref["logits"]).abs().max()),
                       loss_rel_err=[abs(g - w) / abs(w) for g, w in
                                     zip(run["losses"], rl)])
        runs[tp] = run
        emit(dict(phase=f"{label}_run", config=cfg.name, **run))
        del rt, ps, os_, caches, master, grads
    return runs


def tp_parity_phase() -> dict:
    """qwen2.5-3b at full width (2048 wide, 16 heads of 128 over 2 kv
    heads, d_ff 11008, vocab 151,936), 2 of 36 layers, fp32, through the
    runtime at tp = 1, 2 and 4 (:func:`tp_parity_runs`, its gates) from
    one set of global weights drawn on the card and one batch stream:
    the first batch's gradients before any update, 2 training steps of 2
    x 256 tokens, then a prefill of 2 x 128 tokens and 8 greedy tokens (7
    decode steps; tp = 4 decodes through the "dist" cache)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn

    cfg = get_config(TP_ARCH).replace(num_layers=TP_PARITY_LAYERS,
                                      param_dtype="float32",
                                      compute_dtype="float32")
    (b, s), steps = TP_PARITY_TRAIN, 2
    pb, plen, new = TP_PARITY_SERVE
    t0 = time.perf_counter()
    params = card_params(cfg)
    nxt = make_batch_fn(cfg, b, s)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(steps)]
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (pb, plen))
    runs = tp_parity_runs("tp_parity", cfg, params, TP_PARITY_TPS,
                          batches, (prompts, new))
    out = dict(phase="tp_parity", config=cfg.name, layers=cfg.num_layers,
               d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
               vocab=cfg.vocab_size, dtype="float32", train=[b, s],
               steps=steps, serve=[pb, plen, new],
               launches={tp: r["launches"] for tp, r in runs.items()},
               k2_serving={tp: r["k2_serving"] for tp, r in runs.items()},
               losses={tp: r["losses"] for tp, r in runs.items()},
               tokens_identical=True, wall_s=time.perf_counter() - t0)
    emit(out)
    return out


def params_tp_phase() -> dict:
    """qwen2.5-3b's global weights at full width and depth, bf16, drawn on
    the card from seed 0, made once for rt_tp and serve_tp."""
    from repro_torch.configs import get_config

    return card_params(get_config(TP_ARCH))


def rt_tp_phase(params) -> dict:
    """qwen2.5-3b at full depth and width (36 x 2048, ~3.09 B params),
    bf16, through the runtime at dp 2 x tp 2 (four simulated ranks on
    the card), ``RT_TP``'s 8 x 1024 tokens a step, full remat, the
    blockwise head (256), every optimizer state on the card
    (:func:`rt_tp_run`)."""
    from repro_torch.configs import get_config

    return rt_tp_run("rt_tp", get_config(TP_ARCH), params, RT_TP)


def rt_tp_run(label: str, cfg, params, spec: dict, extra_bytes: int = 0
              ) -> dict:
    """``cfg`` through the runtime at ``spec``'s dp x tp, its batch a step,
    ``RT_TP_OPTIONS`` (full remat, the blockwise head, every optimizer
    state on the card): ``spec["steps"]`` steps, each with launches
    against the plan, a finite loss and the peak under a limit computed
    from the layout before the run (``extra_bytes``: what a layer's
    backward holds beyond its saved input, zamba's unit recompute);
    tokens/s (the second step), the FWD+BWD / ADAM split; the last step
    runs under the profiler (its idle share, the top device kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import tree_map
    from repro_torch.runtime import driver

    dp, tp = spec["dp"], spec["tp"]
    (b, s), steps, block = spec["batch"], spec["steps"], spec["block"]
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    rt = rt_make(cfg, dp, "cuda", tp=tp, **RT_TP_OPTIONS)
    # the limit, from the layout, before the run: bf16 params, two sets
    # of bf16 grads (a data rank's beside the running sum), the fp32
    # optimizer state, a block of fp32 logits over every rank's vocab
    # and its exponent, the layers' saved inputs under full remat, 1 GiB
    store_elems = sum(t.numel() for t in rt.store_specs().values())
    dev_elems = sum(os_["p32"]["dev"].numel()
                    for os_ in rt.os_specs().values())
    vocab_all = tp * -(-cfg.vocab_size // tp)
    logits_bytes = 2 * (b // dp) * block * vocab_all * 4
    act_bytes = cfg.num_layers * (b // dp) * s * cfg.d_model * 2
    limit = (at_start + 2 * store_elems + 2 * 2 * store_elems
             + 12 * dev_elems + logits_bytes + act_bytes + extra_bytes
             + GIB)
    nxt = make_batch_fn(cfg, b, s)
    batches = [{k: v for k, v in nxt().items() if k != "mask"}
               for _ in range(steps)]
    # the weights moved to the card once: the stores are split and filled
    # there, not leaf by leaf from the host
    on_card = tree_map(lambda t: t.to("cuda"), params)
    ps, os_ = driver.init_state(rt, params=on_card)
    del on_card
    gc.collect()
    step, _, _ = driver.build_train_step(rt, InputShape("rt", s, b, "train"),
                                         timed=True)
    t1 = time.perf_counter()
    plan = tp_k2_plan(cfg, rt, 1)
    rows = []
    for i, batch in enumerate(batches):
        fa.launches = fa.bwd_launches = ka.launches = 0
        # the last step runs under the profiler (its idle share), device
        # activity only: the breakdown reads device events, and recording
        # every host op as well (half a million in zamba's step) doubled
        # a host-bound step and its reading
        prof = (profile(activities=[ProfilerActivity.CUDA])
                if i == steps - 1 else contextlib.nullcontext())
        with prof:
            w0 = time.perf_counter()
            ps, os_, m = step(ps, os_, batch, i)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
        got = dict(fwd=fa.launches, bwd=fa.bwd_launches, adam=ka.launches)
        if got != plan:
            raise AssertionError(f"{label}: step {i} launches {got}, the "
                                 f"plan implies {plan}")
        if not math.isfinite(loss):
            raise AssertionError(f"{label}: step {i} loss {loss}")
        peak = torch.cuda.max_memory_allocated()
        if peak > limit:
            raise AssertionError(f"{label}: step {i} max_memory_allocated "
                                 f"{peak} > limit {limit}")
        row = dict(phase=f"{label}_step", step=i, loss=loss, wall_s=wall,
                   tokens_per_s=b * s / wall, fwd_bwd_s=m["fwd_bwd_s"],
                   adam_s=m["adam_s"], launches=got, planned=plan,
                   max_memory_allocated=peak, profiled=i == steps - 1)
        emit(row)
        rows.append(row)
    profiled = device_time_breakdown(prof, rows[-1]["wall_s"],
                                     kinds=RT_KINDS)
    profiled.update(loss=loss, fwd_bwd_s=m["fwd_bwd_s"], adam_s=m["adam_s"],
                    top_kernels=top_kernels(prof, 12))
    emit({"phase": f"{label}_profile", **profiled})
    out = dict(
        phase=label, config=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, dtype=cfg.param_dtype, dp=dp, tp=tp,
        batch=[b, s], steps=steps, options=RT_TP_OPTIONS,
        layouts={k: list(v.store_shape) for k, v in rt.layouts.items()},
        param_store_elems=store_elems, os_device_elems=dev_elems,
        collectives=m["collectives"], setup_s=t1 - t0,
        losses=[r["loss"] for r in rows],
        # the steps after the warm-up one, but for the profiled last one
        post_warmup_tokens_per_s=b * s * (steps - 2)
        / sum(r["wall_s"] for r in rows[1:-1]),
        fwd_bwd_s=[r["fwd_bwd_s"] for r in rows],
        adam_s=[r["adam_s"] for r in rows],
        launches={k: sum(r["launches"][k] for r in rows)
                  for k in ("fwd", "bwd", "adam")},
        planned_per_step=plan,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        allocated_at_start=at_start, memory_limit=limit,
        idle_share=1 - profiled.get("device_busy_share", float("nan")),
        profiled_step=profiled)
    emit(out)
    del rt, ps, os_
    return out


DRYRUN_GAP = 0.10  # the predicted peak against rt_tp's measured one


def dryrun_check_phase(rq) -> dict:
    """The dry-run (``repro_torch.launch.dryrun``) held against the card:
    rt_tp's configuration (qwen2.5-3b, bf16, dp 2 x tp 2, ``RT_TP``'s
    8 x 1024 tokens, ``RT_TP_OPTIONS``) traced on the meta device, every
    rank, with no card work.  Its K2 forward and backward calls and K1
    calls must equal the launches rt_tp measured in one step, and its
    simulated device peak must come within ``DRYRUN_GAP`` of rt_tp's
    measured ``max_memory_allocated`` (less what was allocated before the
    phase).  Then one production record, qwen2.5-3b ``train_4k`` at the
    16 x 16 mesh, printed with its trace time."""
    from repro_torch.configs import get_config, model_class
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.runtime.step import ChunkedRuntime, RuntimeOptions

    cfg = get_config(TP_ARCH)
    b, s = RT_TP["batch"]
    rt = ChunkedRuntime(model_class(cfg), cfg, make_smoke_mesh(
        RT_TP["dp"], RT_TP["tp"], device="meta"),
        RuntimeOptions(**RT_TP_OPTIONS))
    rec = dryrun.record(rt, InputShape("rt_tp", s, b, "train"), ranks="all")
    measured = {k: v // rq["steps"] for k, v in rq["launches"].items()}
    predicted = dict(rec["k2_calls"], adam=rec["k1_calls"])
    if predicted != measured:
        raise AssertionError(f"dryrun_check: predicted calls {predicted}, "
                             f"rt_tp launched {measured} a step")
    peak = rq["max_memory_allocated"] - rq["allocated_at_start"]
    gap = (rec["simulated_device_bytes"] - peak) / peak
    if abs(gap) > DRYRUN_GAP:
        raise AssertionError(f"dryrun_check: predicted peak "
                             f"{rec['simulated_device_bytes']}, rt_tp "
                             f"measured {peak} ({gap:+.2%})")
    prod = dryrun.dryrun_one(TP_ARCH, "train_4k", multi_pod=False,
                             verbose=False)
    out = dict(phase="dryrun_check", config=cfg.name, dp=RT_TP["dp"],
               tp=RT_TP["tp"], batch=[b, s], device="meta",
               predicted_calls=predicted, measured_calls=measured,
               predicted_peak_bytes=rec["simulated_device_bytes"],
               predicted_resident_bytes=rec["resident_bytes"],
               measured_peak_bytes=peak,
               measured_max_memory_allocated=rq["max_memory_allocated"],
               allocated_at_start=rq["allocated_at_start"], peak_gap=gap,
               gap_limit=DRYRUN_GAP, trace_s=rec["trace_s"],
               tp_psum_bytes=rec["tp_psum_bytes"],
               measured_tp_bytes=rq["collectives"]["tp_bytes"],
               production=prod)
    emit(out)
    return out


def tp_prefill_states(rt, pstores, tokens) -> tuple:
    """A prefill of ``tokens`` through the runtime's own pieces (its
    serving stem, each layer's params and prefill under its model axis,
    its head), keeping the residual stream after every layer: (the
    states, fp32, the last position's logits as the prefill step returns
    them, fp32).  serve_tp reads the gap between two tp's layer by layer
    from it."""
    import torch

    model, batch = rt.model, {"tokens": tokens}
    states = []
    with torch.no_grad():
        stem = rt._serving_stem(pstores)
        x, extras = model.embed(stem, batch)
        for g in model.groups():
            x, extras = model.between_groups(g.name, x, extras, stem, batch)
            for i in range(rt.group_lengths[g.name]):
                x, _ = g.prefill(rt._layer_params(pstores, g.name, i), x,
                                 extras, rt.ctx)
                states.append(x.float())
        logits = rt._logits(model.head_logits(stem, x[:, -1:, :]))
    return states, logits.float()


def max_rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max()) / float(want.abs().max())


def serve_tp_phase(params) -> dict:
    """qwen2.5-3b at full depth and width, bf16, served through the
    runtime's prefill and decode steps at tp = 4 (the "dist" cache: 2 kv
    heads over 4 ranks, 2 head groups x 2 strided sequence chunks) and at
    tp = 1 on the same weights (:func:`serve_tp_run`): ``SERVE_TP``'s 4
    prompts of 512 tokens and 16 greedy tokens."""
    from repro_torch.configs import get_config

    return serve_tp_run("serve_tp", get_config(TP_ARCH), params, SERVE_TP)


def serve_tp_run(label: str, cfg, params, spec: dict) -> dict:
    """``cfg`` served through the runtime's prefill and decode steps at
    tp = ``spec["tp"]`` and at tp = 1 on the same weights: ``spec``'s
    prompts (a layer-by-layer prefill, :func:`tp_prefill_states`, which
    warms the kernels up, then the timed prefill step) and greedy tokens;
    then the same layer-by-layer prefill in fp32 from the same weights at
    both tp (with ``spec["ulp"]``, once more at tp = 1 from its weights
    moved by one rounding).  Gates: the fp32 prefill logits at the larger
    tp within 1e-4 of tp = 1's largest (the design is exact up to fp32
    rounding), or within twice what one rounding of tp = 1's weights
    moves them where that is more (xlstm-1.3b: its 48 exp-gated layers
    grow a rounding to ~6e-4 of the largest logit); each
    bf16 run's logits held element by element against the fp32 tp = 1
    run, the larger tp's root-mean-square deviation at most twice tp =
    1's (bf16 rounds each rank's work in another order, a fault moves the
    logits by their own size); the residual stream's gap between the tp
    after every layer, in both dtypes, reported; the greedy tokens beside
    tp = 1's with their first difference; K2 against the plan (prefill
    one call an attention layer and rank, the "dist" decode's partial
    attention the reference's plain product); prefill and decode
    tokens/s, the cache bytes per rank."""
    import numpy as np
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import flatten_with_paths, tree_map
    from repro_torch.models.layers import AxisCtx, decode_cache_plan, \
        greedy_token
    from repro_torch.runtime import driver

    b, plen, new = spec["batch"], spec["prompt"], spec["new"]
    many_tp = spec["tp"]
    t0 = time.perf_counter()
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                                (b, plen))
    tokens = torch.as_tensor(prompts, device="cuda")
    # the weights moved to the card once: every store below is filled (and
    # in fp32 cast) there, not from the host
    on_card = tree_map(lambda t: t.to("cuda"), params)
    runs, states = {}, {}
    for tp in (1, many_tp):
        gc.collect()
        torch.cuda.empty_cache()
        w0 = time.perf_counter()
        rt = rt_make(cfg, 1, "cuda", tp=tp)
        ps = driver.param_stores(rt, on_card)
        pre, _ = driver.build_prefill_step(
            rt, InputShape("serve", plen, b, "prefill"))
        dshape = InputShape("serve", plen + new, b, "decode")
        dec, _ = driver.build_decode_step(rt, dshape)
        states[("bfloat16", tp)] = tp_prefill_states(rt, ps, tokens)
        torch.cuda.synchronize()
        fa.launches = 0
        p0 = time.perf_counter()
        logits, caches = pre(ps, {"tokens": prompts})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - p0
        pre_k2 = fa.launches
        caches = driver.grow_caches(rt, caches, plen, plen + new, dshape)
        tok = greedy_token(logits, cfg.vocab_size, AxisCtx())
        toks = [tok]
        fa.launches = 0
        d0 = time.perf_counter()
        for pos in range(plen, plen + new - 1):
            tok, caches = dec(ps, caches, tok.reshape(b, 1), pos)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - d0
        served = dict(prefill=pre_k2, decode=fa.launches)
        plan = tp_serve_plan(cfg, tp, new - 1)
        if served != plan:
            raise AssertionError(f"{label}: tp={tp} K2 {served}, the plan "
                                 f"implies {plan}")
        lg = logits.float()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{label}: tp={tp} logits not finite")
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in flatten_with_paths(caches))
        runs[tp] = dict(
            tp=tp, cache_plan=list(decode_cache_plan(cfg, tp)),
            prefill_s=prefill_s, decode_s=decode_s,
            prefill_tok_per_s=b * plen / prefill_s,
            decode_tok_per_s=b * (new - 1) / decode_s,
            k2=served, k2_planned=plan,
            cache_bytes_per_rank=cache_bytes // tp,
            cache_shapes={".".join(p): list(t.shape) for p, t in
                          flatten_with_paths(caches)},
            tokens=torch.stack(toks, 1).cpu().tolist(), logits=lg,
            wall_s=time.perf_counter() - w0)
        del rt, ps, caches
    # the same prefill in fp32 from the same (bf16-drawn) weights; with
    # spec["ulp"], once more at tp = 1 from stores moved by one rounding
    # (each element times 1 +- 2^-24): the model's own fp32 conditioning
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    w0 = time.perf_counter()
    for tp in (1, many_tp) + (("ulp",) if spec.get("ulp") else ()):
        gc.collect()
        torch.cuda.empty_cache()
        rt = rt_make(f32, 1, "cuda", tp=1 if tp == "ulp" else tp)
        ps = driver.param_stores(rt, on_card)
        if tp == "ulp":
            gen = torch.Generator(device="cuda").manual_seed(1)
            for t in ps.values():
                t.mul_(1 + 2.0 ** -24 * torch.sign(torch.randn(
                    t.shape, generator=gen, device="cuda")))
        states[("float32", tp)] = tp_prefill_states(rt, ps, tokens)
        del rt, ps
    del on_card
    fp32_s = time.perf_counter() - w0
    layer_gaps = {dtype: [max_rel_gap(g, w) for g, w in zip(
        states[(dtype, many_tp)][0], states[(dtype, 1)][0])]
        for dtype in ("bfloat16", "float32")}
    exact = states[("float32", 1)][1]
    fp32_err = max_rel_gap(states[("float32", many_tp)][1], exact)
    # the limit: 1e-4 of the largest logit, or, where one rounding of
    # tp = 1's own weights moves its logits further (spec["ulp"]), twice
    # that move: no pair of fp32 runs a rounding apart can meet a tighter
    # one, and a fault moves the logits by their own size
    ulp_err = (max_rel_gap(states[("float32", "ulp")][1], exact)
               if spec.get("ulp") else None)
    fp32_limit = max(1e-4, 2 * (ulp_err or 0.0))
    if fp32_err > fp32_limit:
        raise AssertionError(f"{label}: fp32 prefill logits at tp="
                             f"{many_tp} differ from tp=1's by {fp32_err} "
                             f"of their largest > {fp32_limit} (one "
                             f"rounding of tp=1's weights: {ulp_err})")

    def rms(t):
        return float(t.pow(2).mean().sqrt())

    one, many = runs[1], runs[many_tp]
    deviation = {tp: rms(runs[tp]["logits"] - exact) for tp in runs}
    if deviation[many_tp] > 2 * deviation[1]:
        raise AssertionError(f"{label}: bf16 logits' deviation from the "
                             f"fp32 run {deviation}: tp={many_tp}'s over "
                             f"twice tp=1's")
    scale = float(one["logits"].abs().max())
    err = float((many["logits"] - one["logits"]).abs().max())
    rows = [many["tokens"][i] for i in range(b)]
    first = [first_difference(a, c) for a, c in zip(one["tokens"], rows)]
    out = dict(phase=label, config=cfg.name, layers=cfg.num_layers,
               dtype=cfg.param_dtype, batch=b, prompt_tokens=plen,
               new_tokens=new, logits_max_abs_err=err, logits_scale=scale,
               logits_max_rel_err=err / scale,
               fp32_logits_max_rel_err=fp32_err,
               fp32_ulp_logits_max_rel_err=ulp_err, fp32_limit=fp32_limit,
               fp32_ulp_layer_max_rel_gap=None if ulp_err is None else [
                   max_rel_gap(g, w) for g, w in zip(
                       states[("float32", "ulp")][0],
                       states[("float32", 1)][0])],
               bf16_rms_deviation_from_fp32=deviation,
               bf16_deviation_ratio=deviation[many_tp] / deviation[1],
               fp32_logits_rms=rms(exact),
               layer_max_rel_gap=layer_gaps, fp32_s=fp32_s,
               tokens_first_difference=first,
               tokens_identical=all(f is None for f in first),
               **{f"tp{tp}": {k: v for k, v in r.items() if k != "logits"}
                  for tp, r in runs.items()},
               wall_s=time.perf_counter() - t0,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    return out


# ------------------------------------- tensor parallelism of the SSM layers
# ssm_tp_parity: zamba2-1.2b at full width, ZAMBA_PARITY_LAYERS deep (one
# unit and the tail), and xlstm-1.3b at full width, one unit of 6 (7
# mLSTM + 1 sLSTM), fp32, the same global weights and batches through the
# runtime at each tp (tp_parity's shapes and gates)
SSM_TP_TPS = (1, 2, 4)
SSM_TP_TRAIN = (2, 256)  # batch, tokens; 2 steps
SSM_TP_SERVE = (2, 128, 8)  # prompts, prompt tokens, greedy tokens
# the training steps' lr: at tp_parity's 1e-3 ADAM's sign-like first
# step turns rounding-level gradient gaps into +-lr flips of small
# elements, and the master-weight rule reads that, not the model axis
# (one rounding of tp = 1's own weights moves 3-4e-4 of zamba's past
# 1e-5 at 1e-3); xlstm's exp-gated mLSTM stack grows the rounding
# further (its gradients ~9e-5 of a leaf's largest apart at tp 2, 1.5%
# of the unit's master weights past 1e-5 after 2 steps at 1e-4)
SSM_TP_LR = {"zamba": 1e-4, "xlstm": 1e-5}
# rt_zamba_tp: zamba2-1.2b at full depth and width, bf16, dp 2 x tp 2,
# train_zamba's 2 x 2048 tokens a data rank
RT_ZAMBA_TP = dict(dp=2, tp=2, batch=(4, 2048), steps=3, block=256)
# serve_ssm_tp: full depth and width, bf16 and fp32, against tp 1 on the
# same weights: zamba2-1.2b at tp 4 (16 kv heads of its shared block's 32
# a rank: the "tp" cache), xlstm-1.3b at tp 2
SERVE_SSM_TP = {"zamba2-1.2b": dict(tp=4, batch=4, prompt=512, new=8),
                "xlstm-1.3b": dict(tp=2, batch=4, prompt=512, new=8,
                                   ulp=True)}


def ssm_tp_parity_phase() -> dict:
    """The SSM layers on the simulated model axis at full width, fp32:
    zamba2-1.2b ``ZAMBA_PARITY_LAYERS`` deep (one unit of 6 Mamba2 layers
    behind the shared block, then the 2-layer tail; the shared block's 32
    heads of 128 run K2 one call a model rank) and xlstm-1.3b one unit of
    6 (7 mLSTM layers, the value channels split within each head, and the
    replicated sLSTM; no attention), each through the runtime at tp = 1,
    2 and 4 from one set of global weights drawn on the card and one
    batch stream: the first batch's gradients, 2 steps of 2 x 256 tokens,
    a prefill of 2 x 128 and 8 greedy tokens, with tp_parity's gates
    (:func:`tp_parity_runs`), at ``SSM_TP_LR`` (1e-4 and 1e-5: below
    tp_parity's 1e-3, where ADAM's first step turns rounding into the
    master weights' gaps)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn

    t0 = time.perf_counter()
    (b, s), steps = SSM_TP_TRAIN, 2
    pb, plen, new = SSM_TP_SERVE
    out = dict(phase="ssm_tp_parity", dtype="float32", train=[b, s],
               steps=steps, serve=[pb, plen, new])
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    for short, cfg in (
            ("zamba", get_config(ZAMBA).replace(
                num_layers=ZAMBA_PARITY_LAYERS, **fp32)),
            ("xlstm", xlstm_cut(get_config(XLSTM), 1).replace(**fp32))):
        w0 = time.perf_counter()
        lr = SSM_TP_LR[short]
        params = card_params(cfg)
        nxt = make_batch_fn(cfg, b, s)
        batches = [{k: v for k, v in nxt().items() if k != "mask"}
                   for _ in range(steps)]
        prompts = np.random.default_rng(5).integers(
            0, cfg.vocab_size, (pb, plen))
        runs = tp_parity_runs(f"ssm_tp_parity_{short}", cfg, params,
                              SSM_TP_TPS, batches, (prompts, new), lr=lr)
        del params
        out[short] = dict(
            config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
            lr=lr,
            launches={tp: r["launches"] for tp, r in runs.items()},
            k2_serving={tp: r["k2_serving"] for tp, r in runs.items()},
            losses={tp: r["losses"] for tp, r in runs.items()},
            grad_max_rel_err={tp: r.get("grad_max_rel_err")
                              for tp, r in runs.items()},
            tokens_identical=True, wall_s=time.perf_counter() - w0)
    out["wall_s"] = time.perf_counter() - t0
    emit(out)
    return out


def rt_zamba_tp_phase(params) -> dict:
    """zamba2-1.2b at full depth and width (38 Mamba2 layers: 6 units
    behind the shared block, a 2-layer tail; ~1.26 B params), bf16,
    through the runtime at dp 2 x tp 2 (four simulated ranks on the
    card), 4 x 2048 tokens a step (train_zamba's 2 x 2048 a data rank),
    full remat, the blockwise head, every optimizer state on the card
    (:func:`rt_tp_run`; the peak's limit adds :func:`zamba_extra_bytes`
    of a data rank's tokens: the unit a backward recomputes)."""
    from repro_torch.configs import get_config

    cfg = get_config(ZAMBA)
    b, s = RT_ZAMBA_TP["batch"]
    return rt_tp_run("rt_zamba_tp", cfg, params, RT_ZAMBA_TP,
                     extra_bytes=zamba_extra_bytes(
                         cfg, b // RT_ZAMBA_TP["dp"] * s))


def serve_ssm_tp_phase(arch: str, params) -> dict:
    """``arch`` (zamba2-1.2b or xlstm-1.3b) at full depth and width served
    through the runtime's prefill and decode steps at
    ``SERVE_SSM_TP[arch]``'s tp and at tp = 1 on the same weights, bf16
    and fp32 (:func:`serve_tp_run`: serve_tp's gates)."""
    from repro_torch.configs import get_config

    return serve_tp_run("serve_ssm_tp", get_config(arch), params,
                        SERVE_SSM_TP[arch])


def splitkv_calls(prof) -> int:
    """K2 split-kv kernels in a profiled span."""
    return kind_calls(prof, lambda n: "splitkv" if
                      "flash_fwd_splitkv_kernel" in n else None).get(
                          "splitkv", 0)


def kind_calls(prof, classify) -> dict:
    """Device events of each kind ``classify`` names (None: not counted)."""
    out = {}
    for name, _, _ in device_events(prof):
        kind = classify(name)
        if kind:
            out[kind] = out.get(kind, 0) + 1
    return out


def top_kernels(prof, n: int = 8) -> list:
    """The ``n`` device kernels with the most time in the span: name
    (cut to 90 characters), calls, ms."""
    agg = {}
    for name, start, end in device_events(prof):
        calls, ms = agg.get(name, (0, 0.0))
        agg[name] = (calls + 1, ms + (end - start) / 1e3)
    top = sorted(agg.items(), key=lambda kv: -kv[1][1])[:n]
    return [dict(name=k[:90], calls=c, ms=ms) for k, (c, ms) in top]


def kernel_instance(mangled: str) -> str:
    """A mangled kernel name shortened to its last name and its mangled
    template arguments (``_ZN12_GLOBAL__N_12tc19flash_fwd_tc_kernelILi128E
    EEv...`` -> ``flash_fwd_tc_kernel<Li128E>``): the nested name is read
    one length-prefixed part at a time, so digits inside a name stay
    there."""
    rest = mangled[3:] if mangled.startswith("_ZN") else ""
    parts = []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest)[0]
        parts.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    if not parts:
        return mangled
    args = re.match(r"I(\w+?E)E", rest)
    return f"{parts[-1]}<{args[1]}>" if args else parts[-1]


def ptxas_report(log: str) -> dict:
    """``-Xptxas -v`` per kernel instance: registers at entry, spilled
    bytes, static shared memory, keyed by :func:`kernel_instance`."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = kernel_instance(m.group(1))
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            out[name]["spill_bytes"] = int(spill[1]) + int(spill[2])
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[name]["registers"] = int(regs[1])
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem[1]) if smem else 0
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False;"
                         " this script needs an NVIDIA card")
    # full fp32 products: the parity phase compares against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    emit(dict(phase="environment", python=sys.version.split()[0],
              torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), capability=list(cap),
              nvidia_smi=card))
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke.py: needs a Hopper card (capability "
                         f"9.0), found {cap}")

    from repro_torch.kernels import build
    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    # Triton compiles K1 into the checkout's build/, from its source
    os.environ["TRITON_CACHE_DIR"] = str(ka.TRITON_CACHE)
    t0 = time.perf_counter()
    sources = [fa.SOURCE, fa.BWD_SOURCE]
    libs = build.build_all(sources)
    fa.load()
    fa.load_bwd()
    ka.load()
    ptxas = {}
    for src, lib in zip(sources, libs):
        log = (lib.parent / "build.log").read_text()
        ptxas[src] = ptxas_report(log)
    emit(dict(phase="build", sources=sources, seconds=time.perf_counter()
              - t0, libraries=[str(lib.relative_to(ROOT)) for lib in libs],
              triton_cache=str(ka.TRITON_CACHE.relative_to(ROOT)),
              ptxas=ptxas))
    # the fp32 kernels keep their accumulators (O; dK and dV; dQ) and split
    # fragments in registers: a spill would put them in local memory
    for src in sources:
        tf32 = {k: v for k, v in ptxas[src].items() if "tf32" in k}
        if not tf32 or any(v.get("spill_bytes", 0) for v in tf32.values()):
            raise AssertionError(f"build: {src}'s tf32x3 kernels are missing "
                                 f"or spill: {tf32}")

    # the parity phases' CPU oracles: one spawned process, importing now
    # while the card works; its jobs come after the host-heavy phases
    ORACLES.start()
    try:
        run_phases(card, ptxas)
    finally:
        ORACLES.close()


def run_phases(card: str, ptxas: dict) -> None:
    """Every phase after the build, the summary lines and the last
    line."""
    import torch

    from repro_torch.kernels import chunked_adam as ka
    from repro_torch.kernels import flash_attention as fa

    # the modules and the build stay for the whole run: keep their objects
    # out of every later collection (each between-phase gc.collect()
    # scanned them again, ~12 s of a 1100 s run)
    gc.freeze()
    seconds, host_available, between, release = {}, {}, {}, {}

    def run(name, phase):
        w0 = time.perf_counter()
        out = phase()
        seconds[name] = time.perf_counter() - w0
        for part, sec in release_host_memory(trim=False).items():
            release[part] = release.get(part, 0.0) + sec
        between[name] = time.perf_counter() - w0 - seconds[name]
        # each phase's time as it ends (the seconds line comes last)
        emit(dict(phase="phase_seconds", name=name, seconds=seconds[name],
                  between=between[name]))
        pinned = torch.cuda.host_memory_stats()
        host_available[name] = dict(
            available=meminfo()["MemAvailable"],
            pinned_allocated=pinned.get("allocated_bytes.current"),
            pinned_reserved=pinned.get("reserved_bytes.current"))
        return out

    hw = run("link", link_phase)
    kern = run("kernel_fwd", kernel_phase)
    adam = run("kernel_adam", adam_phase)
    bwd = run("kernel_bwd", attention_bwd_phase)
    win = run("window_kernels", window_kernels_phase)
    mla = run("mla_kernels", lambda: mla_kernels_phase(ptxas))
    wk = run("whisper_kernels", whisper_kernels_phase)
    vk = run("vlm_kernels", lambda: vlm_kernels_phase(ptxas))
    nk = run("nemotron_kernels", lambda: nemotron_kernels_phase(ptxas))
    # nemotron-4-340b first of the full-width models: its pinned tier
    # (8 GiB blocks, 68.7 GB at 4 layers) needs the host's memory before
    # the other phases' CPU runs have grown the process
    pn = run("params_nemotron", params_nemotron_phase)
    sn = run("serve_nemotron", lambda: serve_nemotron_phase(pn))
    # the 4B rung first: its pinned host tier needs the host's memory
    # before the other phases' CPU runs have fragmented it
    p4 = run("params_4b", params_4b_phase)
    t4 = run("train_4b", lambda: train_4b_phase(p4))
    s4 = run("serve_4b", lambda: serve_4b_phase(p4))
    del p4
    # the host-heavy phases are done: the oracle process takes its jobs
    # (the parity weights drawn on the card here, written by a thread)
    run("oracle_jobs", lambda: ORACLES.submit(ORACLE_KEYS, oracle_jobs))
    # mixtral at full width next, while the host still has its memory
    pm = run("params_mixtral", params_mixtral_phase)
    tm = run("train_mixtral", lambda: train_mixtral_phase(pm))
    sm = run("serve_mixtral", lambda: serve_mixtral_phase(pm))
    del pm
    # deepseek-v2-lite at full width: MLA, shared experts, a dense layer
    pd = run("params_dsv2", params_dsv2_phase)
    td = run("train_dsv2", lambda: train_dsv2_phase(pd))
    sd = run("serve_dsv2", lambda: serve_dsv2_phase(pd))
    del pd
    # zamba2-1.2b at full depth and width: Mamba2, the shared block
    pz = run("params_zamba", params_zamba_phase)
    tz = run("train_zamba", lambda: train_zamba_phase(pz))
    sz = run("serve_zamba", lambda: serve_zamba_phase(pz))
    # zamba2-1.2b on the simulated model axis, from the same draw
    rzt = run("rt_zamba_tp", lambda: rt_zamba_tp_phase(pz))
    szt = run("serve_ssm_tp_zamba", lambda: serve_ssm_tp_phase(ZAMBA, pz))
    del pz
    zz = run("zamba_parity", zamba_parity_phase)
    # xlstm-1.3b at full width: mLSTM and sLSTM, no attention
    px = run("params_xlstm", params_xlstm_phase)
    tx = run("train_xlstm", lambda: train_xlstm_phase(px))
    sx = run("serve_xlstm", lambda: serve_xlstm_phase(px))
    sxt = run("serve_ssm_tp_xlstm", lambda: serve_ssm_tp_phase(XLSTM, px))
    del px
    # whisper-large-v3 at full depth and width: the encoder-decoder
    pw = run("params_whisper", params_whisper_phase)
    tw = run("train_whisper", lambda: train_whisper_phase(pw))
    rw = run("rt_whisper", lambda: rt_whisper_phase(pw))
    sw = run("serve_whisper", lambda: serve_whisper_phase(rw, pw))
    del pw
    # phi-3-vision-4.2b at full width: projected patches ahead of the
    # text, K2 at head dim 96
    pv = run("params_phi3v", params_phi3v_phase)
    tv = run("train_phi3v", lambda: train_phi3v_phase(pv))
    rv = run("rt_phi3v", lambda: rt_phi3v_phase(pv))
    sv = run("serve_phi3v", lambda: serve_phi3v_phase(rv, pv))
    del pv
    xx = run("xlstm_parity", xlstm_parity_phase)
    ww = run("whisper_parity", whisper_parity_phase)
    vv = run("phi3v_parity", phi3v_parity_phase)
    nn = run("nemotron_parity", nemotron_parity_phase)
    d2 = run("dsv2_parity", dsv2_parity_phase)
    mp = run("moe_parity", moe_parity_phase)
    ms = run("moe_smoke_parity", moe_smoke_parity_phase)
    run("parity", parity_phase)
    sl = run("slice", slice_phase)
    cp = run("compiled_parity", compiled_parity_phase)
    cs = run("compiled_slice", lambda: compiled_slice_phase(sl))
    tp = run("train_parity", train_parity_phase)
    # a warm-up and one timed step, as the zoo's (two timed steps before
    # phi-3-vision's phases joined, for the time limit)
    tr = run("train_slice", lambda: train_slice_phase(steps=ZOO_TRAIN_STEPS))
    dp = run("dist_parity", dist_parity_phase)
    ds = run("dist_slice", dist_slice_phase)
    rp = run("rt_parity", rt_parity_phase)
    rs = run("rt_slice", rt_slice_phase)
    run("timeline_parity", timeline_parity_phase)
    ts = run("timeline_slice", lambda: timeline_slice_phase(hw))
    ct = run("cotenancy", lambda: cotenancy_phase(hw))
    zp = run("zoo_parity", zoo_parity_phase)
    # tensor parallelism: qwen2.5-3b at full width on the simulated model
    # axis (after the pinned tiers' phases: it needs the card, not the host)
    tq = run("tp_parity", tp_parity_phase)
    pq = run("params_tp", params_tp_phase)
    rq = run("rt_tp", lambda: rt_tp_phase(pq))
    # the dry-run on the meta device, held against rt_tp's measurements
    run("dryrun_check", lambda: dryrun_check_phase(rq))
    sq = run("serve_tp", lambda: serve_tp_phase(pq))
    del pq
    # the SSM layers on the model axis: zamba2-1.2b's and xlstm-1.3b's
    # parity at full width (rt_zamba_tp and serve_ssm_tp ran beside their
    # models' other phases, on the same draws)
    st = run("ssm_tp_parity", ssm_tp_parity_phase)
    emit(dict(phase="seconds", **seconds))
    emit(dict(phase="oracle_process", threads=ORACLE_THREADS,
              wait_s=ORACLES.wait_s, total_wait_s=sum(ORACLES.wait_s.values()),
              process_s=ORACLES.child_s))
    emit(dict(phase="seconds_between_phases", **between))
    emit(dict(phase="release_seconds_by_part", **release))
    emit(dict(phase="host_memory", mem_total=meminfo()["MemTotal"],
              available_after=host_available))

    def brief(row):
        return {key: row.get(key) for key in (
            "schedule", "shape", "max_abs_err", "ms", "device_ms",
            "graph_replay_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tflops")}

    fwd_main = kern[("train", "bfloat16")]
    fwd_fp32 = kern[("train", "float32")]
    prefill = kern[("prefill_512", "bfloat16")]
    decode = kern[("decode_kv1024", "bfloat16")]
    kvlens = kern[("decode_kvlens", "bfloat16")]
    bwd_main = bwd[("train", "bfloat16")]
    bwd_fp32 = bwd[("train", "float32")]
    adam_main = adam["path"]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": fa.REPLACES, "launches": tr["launches"]["fwd"],
        "launches_serving_slice": sl["k2_launches"],
        "max_abs_err": max([r["max_abs_err"] for r in kern.values()]
                           + [r["max_abs_err"] for (kind, *_), r in
                              (*mla.items(), *wk.items(),
                               *vk.items(), *nk.items())
                              if kind == "fwd"]),
        "ms": fwd_main["ms"], "plain_ms": fwd_main["plain_ms"],
        "bound_ms": fwd_main["bound_ms"], "bound_by": fwd_main["bound_by"],
        "library_ms": fwd_main["library_ms"],
        "shape": "train B=8 S=1024 H=16 D=128 bf16 causal",
        "schedule": fwd_main["schedule"], "tflops": fwd_main["tflops"],
        "device_ms": fwd_main["device_ms"],
        "prefill_ms": prefill["ms"], "prefill_bound_ms": prefill["bound_ms"],
        "prefill_library_ms": prefill["library_ms"],
        "prefill_device_ms": prefill["device_ms"],
        "prefill_schedule": prefill["schedule"],
        "decode_ms": decode["ms"], "decode_plain_ms": decode["plain_ms"],
        "decode_bound_ms": decode["bound_ms"],
        "decode_library_ms": decode["library_ms"],
        "decode_device_ms": decode["device_ms"],
        "decode_library_device_ms": decode["library_device_ms"],
        "decode_schedule": decode["schedule"],
        "decode_splits": decode["splits"],
        "decode_kvlens_ms": kvlens["ms"],
        "decode_kvlens_graph_replay_ms": kvlens["graph_replay_ms"],
        "decode_kvlens_device_ms": kvlens["device_ms"],
        "decode_kvlens_plain_ms": kvlens["plain_ms"],
        "decode_kvlens_bound_ms": kvlens["bound_ms"],
        "decode_kvlens_bound_by": kvlens["bound_by"],
        "decode_kvlens_library_ms": kvlens["library_ms"],
        "decode_kvlens_splits": kvlens["splits"],
        "decode_kvlens_fp32_ms": kern[("decode_kvlens", "float32")]["ms"],
        "launches_compiled_slice": cs["launches"],
        "graph_replays_compiled_slice": cs["graph_replays"],
        "launches_compiled_slice_8gib": cs["8gib"]["k2"]["total"],
        "fp32_launches_compiled_parity": cp["k2"]["total"],
        "fp32_ms": fwd_fp32["ms"], "fp32_schedule": fwd_fp32["schedule"],
        "fp32_device_ms": fwd_fp32["device_ms"],
        "fp32_plain_ms": fwd_fp32["plain_ms"],
        "fp32_bound_ms": fwd_fp32["bound_ms"],
        "fp32_bound_by": fwd_fp32["bound_by"],
        "fp32_fma_bound_ms": fwd_fp32["fma_bound_ms"],
        "fp32_tf32x3_bound_ms": fwd_fp32["tf32x3_bound_ms"],
        "fp32_library_ms": fwd_fp32["library_ms"],
        "fp32_tflops": fwd_fp32["tflops"],
        "fp32_launches_train_parity": tp["k2_launches"]["fwd"],
        "launches_dist_slice": ds["launches"]["fwd"],
        "fp32_launches_dist_parity": dp["train"]["launches"]["fwd"],
        "launches_rt_slice": rs["launches"]["fwd"],
        "launches_rt_parity": rp["launches"]["fwd"],
        "launches_timeline_slice": ts["launches"]["fwd"],
        "launches_cotenancy": ct["launches"]["fwd"],
        # the backward phase launches the forward too (its o and lse)
        "head_dims": sorted({r["shape"][-1] for r in kern.values()}
                            | {r["shape"][-1] for r in bwd.values()}
                            | {r["shape"][-1] for r in vk.values()}
                            | {r["shape"][-1] for r in nk.values()}),
        "d144": {f"{name}_{dtype}": brief(kern[(name, dtype)])
                 for name in ("train_d144", "prefill_d144", "decode_d144",
                              "decode_kvlens_d144") for dtype in BOTH},
        "gqa8_decode": {dtype: brief(kern[("decode_gqa8", dtype)])
                        for dtype in BOTH},
        "launches_train_4b": t4["launches"]["fwd"],
        "launches_serve_4b_eager": s4["eager"]["k2_launches"],
        "calls_serve_4b_compiled": s4["launches"],
        "launches_zoo_parity": {a: zp[a]["k2_launches"] for a in ZOO},
        "fp32_launches_zoo_parity_train": zp["train"]["k2_launches"]["fwd"],
        "window_mixtral": {dtype: brief(win[("fwd", dtype)])
                           for dtype in BOTH},
        "window_mixtral_causal_ms": {
            dtype: win[("fwd", dtype)]["causal_no_window_ms"]
            for dtype in BOTH},
        "ring_decode_mixtral": {dtype: brief(win[("ring", dtype)])
                                for dtype in BOTH},
        "launches_train_mixtral": tm["launches"]["fwd"],
        "launches_serve_mixtral_eager": sm["k2_eager"],
        "calls_serve_mixtral_compiled": sm["k2_compiled"],
        "fp32_launches_moe_parity": mp["k2_launches"],
        "fp32_launches_moe_smoke_parity": {
            "serving": ms["k2"], "runtime": ms["runtime"]["launches"]["fwd"],
            "trainer": ms["trainer"]["launches"]["fwd"]},
        "mla_192_128": {f"{name}_{dtype}": brief(mla[("fwd", name, dtype)])
                        for name in ("mla_train", "mla_prefill")
                        for dtype in BOTH},
        "mla_192_128_library": {
            dtype: mla[("fwd", "mla_train", dtype)]["library"]
            for dtype in BOTH},
        "mla_192_128_registers": mla[("fwd", "mla_train", "bfloat16")][
            "registers"],
        "launches_train_dsv2": td["k2_by_head_dims"]["fwd"],
        "launches_serve_dsv2_eager": sd["eager"]["k2_by_head_dims"],
        "calls_serve_dsv2_compiled": sd["k2_compiled"],
        "fp32_launches_dsv2_parity": {
            "serving": d2["k2_by_head_dims"],
            "runtime": d2["runtime"]["launches"]["fwd"],
            "trainer": d2["trainer"]["launches"]["fwd"]},
        "zamba": {f"{name}_{dtype}": brief(kern[(name, dtype)])
                  for name in ("train_zamba", "decode_zamba",
                               "train_zamba_tp")
                  for dtype in BOTH},
        "launches_train_zamba": tz["launches"]["fwd"],
        "launches_serve_zamba_eager": sz["k2_eager"],
        "calls_serve_zamba_compiled": sz["k2_compiled"],
        "fp32_launches_zamba_parity": {
            "serving_eager": zz["serving"]["k2_eager_launches"],
            "serving_compiled": zz["serving"]["k2"]["total"],
            "runtime": zz["runtime"]["launches"]["fwd"],
            "trainer": zz["trainer"]["launches"]["fwd"]},
        # xLSTM has no attention: every count below is 0, as planned
        "launches_train_xlstm": tx["launches"]["fwd"],
        "launches_serve_xlstm_eager": sx["k2_eager"],
        "calls_serve_xlstm_compiled": sx["k2_compiled"],
        "fp32_launches_xlstm_parity": {
            "serving_eager": xx["serving"]["k2_eager_launches"],
            "serving_compiled": xx["serving"]["k2"]["total"],
            "runtime": xx["runtime"]["launches"]["fwd"],
            "trainer": xx["trainer"]["launches"]["fwd"]},
        "whisper": {f"{name}_{dtype}": brief(row) for (kind, name, dtype),
                    row in wk.items() if kind == "fwd"},
        "launches_train_whisper": tw["launches"]["fwd"],
        "launches_rt_whisper": rw["launches"]["fwd"],
        "calls_serve_whisper": {"prefill": sw["k2_prefill"],
                                "decode": sw["k2_decode"]},
        "fp32_launches_whisper_parity": {
            "serving": ww["serving"]["k2"],
            "runtime": ww["runtime"]["launches"]["fwd"],
            "trainer": ww["trainer"]["launches"]["fwd"]},
        "vlm_d96": {f"{name}_{dtype}": brief(row) for (kind, name, dtype),
                    row in vk.items() if kind == "fwd"},
        "vlm_d96_registers": vk[("fwd", "train", "bfloat16")]["registers"],
        "launches_train_phi3v": tv["launches"]["fwd"],
        "launches_rt_phi3v": rv["launches"]["fwd"],
        "calls_serve_phi3v": {"prefill": sv["k2_prefill"],
                              "decode": sv["k2_decode"]},
        "fp32_launches_phi3v_parity": {
            "serving": vv["serving"]["k2"],
            "runtime": vv["runtime"]["launches"]["fwd"],
            "trainer": vv["trainer"]["launches"]["fwd"]},
        "nemotron_192": {f"{name}_{dtype}": brief(row) for (kind, name,
                                                            dtype),
                         row in nk.items() if kind == "fwd"},
        "nemotron_192_registers": nk[("fwd", "train", "bfloat16")][
            "registers"],
        "launches_serve_nemotron_eager": sn["k2_eager"],
        "calls_serve_nemotron_compiled": sn["k2_compiled"],
        "fp32_launches_nemotron_parity": {
            "serving": nn["serving"]["k2"],
            "runtime": nn["runtime"]["launches"]["fwd"],
            "trainer": nn["trainer"]["launches"]["fwd"]},
        # tensor parallelism: one call a model rank where tp=1 makes one
        "fp32_launches_tp_parity": {tp: r["fwd"] for tp, r in
                                    tq["launches"].items()},
        "fp32_calls_tp_parity_serving": tq["k2_serving"],
        "launches_rt_tp": rq["launches"]["fwd"],
        "calls_serve_tp": {f"tp{t}": sq[f"tp{t}"]["k2"]
                           for t in (1, SERVE_TP["tp"])},
        # the SSM layers on the model axis: zamba's shared block one call
        # a model rank (xLSTM has no attention: its counts are 0)
        "fp32_launches_ssm_tp_parity": {
            m: {tp: r["fwd"] for tp, r in st[m]["launches"].items()}
            for m in ("zamba", "xlstm")},
        "fp32_calls_ssm_tp_parity_serving": {
            m: st[m]["k2_serving"] for m in ("zamba", "xlstm")},
        "launches_rt_zamba_tp": rzt["launches"]["fwd"],
        "calls_serve_ssm_tp": {
            name: {f"tp{t}": row[f"tp{t}"]["k2"]
                   for t in (1, SERVE_SSM_TP[arch]["tp"])}
            for name, arch, row in (("zamba", ZAMBA, szt),
                                    ("xlstm", XLSTM, sxt))},
        "dist_decode": "no kernel: the \"dist\" cache's partial attention "
                       "is the reference's own plain product "
                       "(src/repro/models/layers.py:640-646), plain "
                       "PyTorch on the card",
        "card": card,
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": fa.BWD_REPLACES, "launches": tr["launches"]["bwd"],
        "max_abs_err": max([r["max_abs_err"] for r in bwd.values()]
                           + [r["max_abs_err"] for (kind, *_), r in
                              (*mla.items(), *wk.items(),
                               *vk.items(), *nk.items())
                              if kind == "bwd"]),
        "ms": bwd_main["ms"], "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"], "bound_by": bwd_main["bound_by"],
        "library_ms": bwd_main["library_ms"],
        "shape": "train B=8 S=1024 H=16 D=128 bf16 causal",
        "schedule": bwd_main["schedule"], "tflops": bwd_main["tflops"],
        "device_ms": bwd_main["device_ms"],
        "fp32_ms": bwd_fp32["ms"], "fp32_schedule": bwd_fp32["schedule"],
        "fp32_device_ms": bwd_fp32["device_ms"],
        "fp32_plain_ms": bwd_fp32["plain_ms"],
        "fp32_bound_ms": bwd_fp32["bound_ms"],
        "fp32_bound_by": bwd_fp32.get("bound_note", bwd_fp32["bound_by"]),
        "fp32_fma_bound_ms": bwd_fp32["fma_bound_ms"],
        "fp32_tf32x3_bound_ms": bwd_fp32["tf32x3_bound_ms"],
        "fp32_library_ms": bwd_fp32["library_ms"],
        "fp32_tflops": bwd_fp32["tflops"],
        "fp32_launches_train_parity": tp["k2_launches"]["bwd"],
        "launches_dist_slice": ds["launches"]["bwd"],
        "fp32_launches_dist_parity": dp["train"]["launches"]["bwd"],
        "launches_rt_slice": rs["launches"]["bwd"],
        "launches_rt_parity": rp["launches"]["bwd"],
        "launches_timeline_slice": ts["launches"]["bwd"],
        "launches_cotenancy": ct["launches"]["bwd"],
        "head_dims": sorted({r["shape"][-1] for r in bwd.values()}
                            | {r["shape"][-1] for (kind, *_), r in
                               (*vk.items(), *nk.items())
                               if kind == "bwd"}),
        "d144": {dtype: brief(bwd[("train_d144", dtype)]) for dtype in BOTH},
        "launches_train_4b": t4["launches"]["bwd"],
        "fp32_launches_zoo_parity_train": zp["train"]["k2_launches"]["bwd"],
        "window_mixtral": {dtype: brief(win[("bwd", dtype)])
                           for dtype in BOTH},
        "window_mixtral_causal_ms": {
            dtype: win[("bwd", dtype)]["causal_no_window_ms"]
            for dtype in BOTH},
        "window_smoke_max_rel_err": max(
            g["rel_err"] for row in win["smoke"]
            for g in row["grads"].values()),
        "launches_train_mixtral": tm["launches"]["bwd"],
        "fp32_launches_moe_smoke_parity": {
            "runtime": ms["runtime"]["launches"]["bwd"],
            "trainer": ms["trainer"]["launches"]["bwd"]},
        "mla_192_128": {f"{name}_{dtype}": brief(mla[("bwd", name, dtype)])
                        for name in ("mla_train", "mla_prefill")
                        for dtype in BOTH},
        "mla_192_128_registers": mla[("bwd", "mla_train", "bfloat16")][
            "registers"],
        "launches_train_dsv2": td["k2_by_head_dims"]["bwd"],
        "fp32_launches_dsv2_parity": {
            "runtime": d2["runtime"]["launches"]["bwd"],
            "trainer": d2["trainer"]["launches"]["bwd"]},
        "zamba": {f"{name}_bfloat16": brief(bwd[(name, "bfloat16")])
                  for name in ("train_zamba", "train_zamba_tp")},
        "launches_train_zamba": tz["launches"]["bwd"],
        "fp32_launches_zamba_parity": {
            "runtime": zz["runtime"]["launches"]["bwd"],
            "trainer": zz["trainer"]["launches"]["bwd"]},
        "launches_train_xlstm": tx["launches"]["bwd"],
        "fp32_launches_xlstm_parity": {
            "runtime": xx["runtime"]["launches"]["bwd"],
            "trainer": xx["trainer"]["launches"]["bwd"]},
        "whisper": {f"{name}_{dtype}": brief(row) for (kind, name, dtype),
                    row in wk.items() if kind == "bwd"},
        "launches_train_whisper": tw["launches"]["bwd"],
        "launches_rt_whisper": rw["launches"]["bwd"],
        "fp32_launches_whisper_parity": {
            "runtime": ww["runtime"]["launches"]["bwd"],
            "trainer": ww["trainer"]["launches"]["bwd"]},
        "vlm_d96": {f"{name}_{dtype}": brief(row) for (kind, name, dtype),
                    row in vk.items() if kind == "bwd"},
        "vlm_d96_registers": vk[("bwd", "train", "bfloat16")]["registers"],
        "launches_train_phi3v": tv["launches"]["bwd"],
        "launches_rt_phi3v": rv["launches"]["bwd"],
        "fp32_launches_phi3v_parity": {
            "runtime": vv["runtime"]["launches"]["bwd"],
            "trainer": vv["trainer"]["launches"]["bwd"]},
        "nemotron_192": {f"{name}_{dtype}": brief(row) for (kind, name,
                                                            dtype),
                         row in nk.items() if kind == "bwd"},
        "nemotron_192_registers": nk[("bwd", "train", "bfloat16")][
            "registers"],
        "fp32_launches_nemotron_parity": {
            "runtime": nn["runtime"]["launches"]["bwd"],
            "trainer": nn["trainer"]["launches"]["bwd"]},
        "fp32_launches_tp_parity": {tp: r["bwd"] for tp, r in
                                    tq["launches"].items()},
        "launches_rt_tp": rq["launches"]["bwd"],
        "fp32_launches_ssm_tp_parity": {
            m: {tp: r["bwd"] for tp, r in st[m]["launches"].items()}
            for m in ("zamba", "xlstm")},
        "launches_rt_zamba_tp": rzt["launches"]["bwd"],
        "card": card,
    }, {
        "name": "chunked_adam", "route": "triton", "source": ka.SOURCE,
        "replaces": ka.REPLACES, "launches": tr["launches"]["adam"],
        "max_abs_err": max(r["max_abs_err"] for r in adam.values()),
        "ms": adam_main["ms"], "plain_ms": adam_main["plain_ms"],
        "bound_ms": adam_main["bound_ms"], "bound_by": adam_main["bound_by"],
        "library_ms": adam_main["library_ms"],
        "library_copy_ms": adam_main["library_copy_ms"],
        "library_bound_ms": adam_main["library_bound_ms"],
        "launches_dist_slice": ds["launches"]["adam"],
        "launches_dist_parity": dp["train"]["launches"]["adam"],
        "launches_rt_slice": rs["launches"]["adam"],
        "launches_rt_parity": rp["launches"]["adam"],
        "launches_timeline_slice": ts["launches"]["adam"],
        "launches_cotenancy": ct["launches"]["adam"],
        "launches_train_4b": t4["launches"]["adam"],
        "launches_zoo_parity_train": zp["train"]["k1_launches"],
        "launches_train_mixtral": tm["launches"]["adam"],
        "launches_moe_smoke_parity": {
            "runtime": ms["runtime"]["launches"]["adam"],
            "trainer": ms["trainer"]["launches"]["adam"]},
        "launches_train_dsv2": td["launches"]["adam"],
        "launches_dsv2_parity": {
            "runtime": d2["runtime"]["launches"]["adam"],
            "trainer": d2["trainer"]["launches"]["adam"]},
        "launches_train_zamba": tz["launches"]["adam"],
        "launches_zamba_parity": {
            "runtime": zz["runtime"]["launches"]["adam"],
            "trainer": zz["trainer"]["launches"]["adam"]},
        "launches_train_xlstm": tx["launches"]["adam"],
        "launches_xlstm_parity": {
            "runtime": xx["runtime"]["launches"]["adam"],
            "trainer": xx["trainer"]["launches"]["adam"]},
        "launches_train_whisper": tw["launches"]["adam"],
        "launches_rt_whisper": rw["launches"]["adam"],
        "launches_whisper_parity": {
            "runtime": ww["runtime"]["launches"]["adam"],
            "trainer": ww["trainer"]["launches"]["adam"]},
        "launches_train_phi3v": tv["launches"]["adam"],
        "launches_rt_phi3v": rv["launches"]["adam"],
        "launches_phi3v_parity": {
            "runtime": vv["runtime"]["launches"]["adam"],
            "trainer": vv["trainer"]["launches"]["adam"]},
        "launches_nemotron_parity": {
            "runtime": nn["runtime"]["launches"]["adam"],
            "trainer": nn["trainer"]["launches"]["adam"]},
        "launches_tp_parity": {tp: r["adam"] for tp, r in
                               tq["launches"].items()},
        "launches_rt_tp": rq["launches"]["adam"],
        "launches_ssm_tp_parity": {
            m: {tp: r["adam"] for tp, r in st[m]["launches"].items()}
            for m in ("zamba", "xlstm")},
        "launches_rt_zamba_tp": rzt["launches"]["adam"],
        "shape": f"N={adam_main['n']} fp32 g aliased to the fp32 output",
        "schedule": "elementwise", "card": card}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
