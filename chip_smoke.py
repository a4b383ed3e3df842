#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Print the card (``nvidia-smi``), build the kernels from
   ``src/repro_torch/kernels/csrc`` (the five sweep kernels, the
   bit-matrix AND and the flash kernels; one nvcc per source, in parallel)
   and print the build time.
2. Kernel parity at full size on the paper-§5 uniform workloads
   (L = 1e6): n = m = 1e6 at α = 1 and n = m = 1e5 at α = 100.  Passes A
   and B (at both segment sizes the main path launches them with: 2048
   for counting, 4096 for enumeration) and the delta-bitmask kernel equal
   their plain versions exactly, the delta-bitmask kernel also on the
   records of ``ref.off_contract_records`` (a lower twice, an upper
   twice, an upper before its lower, a dropped lower, one owner's lower
   in two segments); the delta-scan kernel equals the plain loop
   (``prefix.delta_scan_exclusive``) on both extent types' words, also
   with Del widened to share every bit of Add; at n = m = 1e6 the
   delta-bitmask kernel is timed (full size A) beside its
   plain version and its byte bound, its launches counted in the pass-C
   engine's run;
   pass C equals its plain replay at a reduced size (printed) and, at
   n = m = 1e6, at full size with its masks in global memory; it is timed
   at both full sizes; at full size the pass-C engine's pair set equals the rank-table
   ``sbm_enumerate``'s and its count equals K; K equals the sequential
   sweep's count.
3. The main path: ``repro_torch.api.DDMService(device="cuda")`` at
   n = m = 1e5 regions (α = 1): bulk register, flush, match_count, pairs,
   then churn flushes of b = 1, 100, 1000 and 10000 moves whose
   ``BatchDelta``s must equal a ``device="cpu"`` twin's, and ``pairs()``
   after the churn must equal a fresh rebuild.  The kernels' launch counts
   are zeroed just before and read just after; each must be > 0.  Then
   five more rebuilds by the host clock and one under ``torch.profiler``
   (device busy time, idle share, top device kernels and host ops, each
   sweep kernel's device time).  Then one warm rebuild on each route
   under the profiler, device and wall time: the pass-C kernel engine
   (the default: the main path's scratch, ``ops.pass_c_scratch_bytes``,
   is far below ``service.REBUILD_SCRATCH_BUDGET``) and the rank-table
   engine (the budget set to 0 in this process); equal pair sets, pass C
   launched on the first route only.  Then ``ops.sbm_enumerate_kernel``
   at the main path's shapes asked for segments of 32768 (above the
   delta-bitmask kernel's and pass C's limits, so run at
   ``ops.card_segment``'s size) must equal its output at 4096: the same
   pairs in the same order, the same count.
4. Each sweep kernel at the main path's shapes: held against its plain
   version again (the delta-bitmask kernel also on the off-contract
   records of phase 2; passes A and B also at block sizes 36, shorter
   than pass B's span of a warp, and 2050, its scalar path),
   then timed (device time per launch) beside the
   plain version and the least time the card could take (bytes over the
   published HBM rate); pass C with its masks in shared memory, no block
   taking its general path.  On records outside the contract of its fast
   path (an entering set that says a lower's extent is already open, a
   lower seen twice, stray bits in every entering set, and those with a
   cap that cuts) pass C must equal its plain replay element for element,
   with a nonzero count of blocks that took the general path.  Then the
   delta-scan kernel at ``ddm-paper.match-a100``'s shape (n = m = 5e5,
   alpha = 100: 489 segments of 15,625 words a side): held against the
   plain loop, both sides' device time beside the loop's and the byte
   bound, and two launches in one ``ops.sbm_enumerate_kernel`` match.
5. The bit-matrix AND kernel against its plain version and the numpy brute
   force: the shapes of ``tests/test_kernels_bitmatch.py`` and d = 5 and 8
   (the kernel's run-time-d form), an unbounded
   ``[-inf, +inf]²`` subscription against m = 5, empty sides, and edge
   shapes that straddle the kernel's tiles (m = 1, 31, 33, 1025; n not a
   multiple of its 512-row tile; d = 1, 4, 5; integer-grid ties with -0.0
   and infinite bounds).
6. The bit-matrix at full size on tall-thin workloads (wide dim 0):
   (a) n = m = 32768, d = 2, α = 10 and (b) n = m = 1e5, d = 3, α = 100.
   Words, row counts and K equal the plain version's (run over row
   blocks); K equals the selective sweep's count; in (a) the kernel
   engine's pair set equals the selective sweep's, and
   ``enumerate_matches_ddim_planned(method="bitmatrix")`` runs on the
   kernel (launch count zeroed before, > 0 after).
7. The d-dim service path: ``DDMService(dims=2, device="cuda")`` at
   n = m = 1e5 tall-thin regions (α = 1), the same steps and churn as
   phase 3 (moved regions keep the tall-thin shape) against a
   ``device="cpu"`` twin; the regime ``sweep_dim1`` and the ``device``
   rematch must show in ``stats()``, and the five sweep kernels' launch
   counts, zeroed before, must all be > 0.  Then a service rebuild above
   the budget: n = m = 1e7 regions (α = 1) registered in bulk, the cold
   ``match_count()`` (passes A and B) equal to ``len(pairs())``, which
   the rank-table engine enumerates (pass C not launched); its peak
   device memory printed beside the pass-C engine's reckoned scratch
   (~98 GB) at the same sizes.
8. The bit-matrix kernel timed at cell (a) beside its plain version and its
   bound (the larger of bytes over the HBM rate and compares over the
   float32 rate); then its run-time-d form at d = 5 on the same cell
   (dimensions repeated, so the words must equal the plain d = 2 words).
9. Flash battery: the block-sparse flash attention kernel against its plain
   version ``ref_flash_attention`` (same schedule) and the dense oracle
   ``ref_attention``, in float32 (within 2e-5; the float32 kernel) and
   bfloat16 (the tensor-core kernel; scores of std 4, within 2e-2 and
   within the bound derived at ``flash_full_tol``): the shapes of
   ``tests/test_kernels_attention.py`` (GQA 2:1 and 4:1, MQA with 5 heads),
   windows of 64, 100 and 128, softcap 30 and 50, segments, q_offset > 0, a
   global block, 32-blocks, 512-blocks (eight q tiles per block, with and
   without a window), D = 64, 128 and 256, D = 16, which the wrapper
   zero-pads to the next built width, D = 96, which runs its own wgmma +
   TMA kernel (``flash_attention_fwd_d96_kernel``), and D = 257, 320, 512 and
   593, which run the wide bf16 kernel (every feature at D = 320; the
   float32 cases all run the float32 kernel), one launch a case; and
   non-causal: Sq == Skv
   at 64-blocks with GQA and segments, at 512-blocks with D = 64 and 96,
   Sq = 1024 / Skv = 2048 and Sq = 2048 / Skv = 1024 at 512-blocks, a
   window with a global block, and D = 128, 256 (softcap 50) and 320
   (the wide kernel) with Sq != Skv.
10. Flash at full width: smollm-360m's prefill shapes (B = 4, H = 15,
    Hkv = 5, S = 2048, D = 64, bfloat16, causal 512-blocks) with a peaked
    softmax (scores of std 4): kernel == plain and dense oracle within the
    bound derived at ``flash_full_tol``, then its device time beside the
    plain version's, one ``scaled_dot_product_attention`` call on the same
    tensors (the yardstick; the port never calls it) and the bound over
    the live (q, k) pairs, S(S+1)/2 per (batch, head).  Then the same at
    gemma2-2b's shapes (B = 2, H = 8, Hkv = 4, S = 8192, D = 256,
    softcap 50), once for a global layer (causal) and once for a local
    one (window 4096), each beside the same function in one
    ``flex_attention`` call (compiled; a tanh score_mod and a causal or
    sliding-window block mask), the yardstick.  Then row 6c: phi-3-vision's
    widths (B = 4, H = Hkv = 32, S = 2048, D = 96, causal 512-blocks) on
    the wgmma + TMA kernel through ``ops.flash_attention`` (one launch,
    counted), timed over the whole wrapper call, beside SDPA and, in turns
    (new, padded, padded, new), the padded route that served D = 96 before
    it (zero-padding to 128, the D = 128 instance, the slice back).  Then
    row 6d: the wide bf16 kernel at
    B = 1, H = Hkv = 8, S = 4096, D = 512, causal 512-blocks, through
    ``ops.flash_attention`` (one launch, counted), beside SDPA; row 6e:
    the same shapes in float32 on the float32 kernel (within 2e-5 of its
    plain version), beside SDPA in float32 with TF32 off, its bound at the
    float32 rate; row 6f: smollm-360m's prefill shapes in float32 (the
    width the model twin runs) on the same kernel, beside SDPA in float32
    with TF32 off and ``enable_gqa``; and row 6g: granite-moe-3b-a800m's
    prefill shapes (B = 4, H = 24, Hkv = 8, S = 2048, D = 64, bf16, causal
    512-blocks) through ``ops.flash_attention``, beside SDPA with
    ``enable_gqa`` (its launches: phase 15's).  Rows 6h and 6i:
    seamless-m4t-medium's prefill shapes, non-causal (B = 4, H = Hkv =
    16, D = 64, bf16, 512-blocks): the encoder's self-attention (S =
    2048) and the cross-attention (Sq = 1024, Skv = 2048), each beside
    its plain version, its bound (every (q, k) pair live) and one
    non-causal SDPA call (their launches: phase 18's per prefill).
11. The serving path: smollm-360m at full width and depth (32 layers,
    bfloat16 compute, float32 weights from a seeded generator) behind
    ``ServeEngine`` with 4 slots answers 8 requests of 2048-token prompts,
    16 new tokens each (max_len 2560).  Every request returns 16 tokens
    below the vocabulary size, every decode step's logits are finite, and
    the flash kernel's launch count, zeroed just before, is 32 layers x 2
    waves = 64 just after.  Prints prefill ms per wave, decode ms per step
    and tokens/s; then one more wave (prefill and 4 decode steps) under
    ``torch.profiler``: device time by kernel class and the device's idle
    share.
12. gemma2-2b at full width and depth (26 layers, head_dim 256, local
    window 4096 and global layers alternating, softcap 50 on every
    layer) behind ``ServeEngine`` with 2 slots answers 2 requests of
    8192-token prompts, 8 new tokens each (max_len 8704): the same checks,
    and 26 flash launches for its one wave (counts zeroed just before),
    counted also per layer kind at the call site: 13 global, 13 local.
13. Model twin: a 2-layer smollm-360m at full width in float32, one
    1024-token prefill (the blockwise path, so the kernel) and 4 greedy
    decode steps on the card and on a ``device="cpu"`` twin with the same
    weights: last-position logits and KV caches within 1e-3 relative, and
    equal greedy tokens.
14. The DDM surface on the card, timed as a whole beside the script's
    total so far.  (a) At the matching benchmark's bf/rank cell (n = m =
    1e5, α = 100, uniform): ``rank_count``, ``bf_count(block=2048)``,
    ``sbm_count`` under each ``scan_impl`` and ``grid_count(cap=2048)``
    (overflow 0) equal the sequential sweep's K; ``grid_count`` at its
    default cap gives the CPU's (count, overflow), overflow > 0, and its
    strict form raises ``GridOverflowError``; K past 2**31 (65,536 x
    32,769 identical extents) is exact on ``bf_count``, ``rank_count`` and
    ``sbm_count_exact``; device time of each call.  (b) ``sbm_count``
    under the three scans at n = m = 1e6, α = 1, equal to the kernel
    count, and ``sbm_enumerate``'s buffers under the three at the main
    path's size, identical; device times.  (c) A ``Broker(journal=True,
    flush_interval=0.01)`` with two sessions of 1e5 regions a side (d = 1
    uniform, d = 2 tall-thin), four producer threads each submitting,
    per session, 2,500 single-region moves, 100 registers and 100
    unregisters: every ticket resolves, each session's ``pairs()`` equals
    ``replay_journal``'s into a ``device="cpu"`` service, a forced
    degraded read (``grid_count`` for d = 1, ``probe_count`` for d = 2)
    equals the same estimator on the replay's state, a healthy read is
    exact; the five sweep kernels' launch counts, zeroed before the load,
    are > 0 after it; flush p50/p99 and the admission counters printed.
    (d) Every engine of ``repro_torch.api.engines_for(d)``, d = 1, 2, 3,
    on ``cuda`` extents through ``check_engine``: edge cases (ties,
    touching endpoints, -0.0, infinite bounds, empty sides, n = m = 1)
    and seeded uniform, clustered and tall-thin workloads of 400 to 2,000
    regions; pass C's and the bit-matrix kernel's launch counts, zeroed
    before, > 0 after.
15. granite-moe-3b-a800m at full width and depth (32 layers of attention,
    24/8 heads of 64, and MoE, 40 experts top-8, sort-based dispatch;
    3,299,182,080 parameters, 881,690,112 active) behind ``ServeEngine``
    with 4 slots: 8 requests of 2048-token prompts, 16 new tokens each
    (max_len 2560); the checks of phase 11, flash launches 32 x 2 waves =
    64 (counts zeroed just before).  Prints each prefill wave's drop
    fraction (a wave's four prompts form one dispatch group, capacity 2048
    an expert); then a profiled wave: device time by class (flash, matrix
    products, the dispatch's sort / gather / scatter kernels, the rest),
    idle share and device events.  Then a 2-layer full-width float32 twin
    (TF32 off): a 1024-token prefill and 4 greedy decode steps on the card
    and on a ``device="cpu"`` twin: equal expert choices at every MoE
    call, logits and KV caches within 1e-3 relative, equal tokens.
16. mamba2-2.7b at full width and depth (64 attention-free SSD layers,
    80 heads of 64, state 128) behind ``ServeEngine`` with 4 slots: 4
    requests of 2048-token prompts, 16 new tokens: the same checks, flash
    launches 0; a profiled wave; a 2-layer float32 twin (h and the conv
    histories within 1e-3 relative); then reduced jamba-1.5-large-398b
    (the 8-layer hybrid block) and grok-1-314b (softcap 30) card against
    CPU the same way (64-token prompts, 4 decode steps).
17. phi-3-vision-4.2b at full width and depth (32 layers, 32 heads of 96:
    bf16 flash on the wgmma + TMA kernel at D = 96, row 6c; random
    float32 weights from a seeded generator, bf16 compute) through
    ``Model.prefill`` and ``decode_step`` (its serving engine takes token
    prompts only): 4 sequences of 576 ``prefix_embeds`` and 1472 text
    tokens (2048 positions), two prefills (cold, warm) with 32 flash
    launches each, counted at the ``kernels.ops`` call site, every one on
    the ``"wgmma"`` route, then 16
    greedy decode steps (max_len 2560): tokens below the vocabulary,
    finite logits; prefill ms, decode ms a step, tokens/s of the warm
    wave; a profiled prefill and 4 decode steps (device time by class,
    idle share, the flash kernel's share of the prefill); then a 2-layer
    float32 twin at full width (1024 positions, 576 of them the prefix)
    card against CPU within 1e-3 relative, equal greedy tokens.
18. seamless-m4t-medium at full width and depth (12 encoder layers of
    bidirectional attention, 12 decoder layers with cross-attention, 16
    heads of 64) the same way: 4 x 2048 ``frame_embeds`` into the encoder
    and 4 x 1024-token decoder prompts; 36 flash launches a prefill, 12
    at each site (encoder non-causal at S = 2048, decoder causal at S =
    1024, cross-attention non-causal at Sq = 1024, Skv = 2048); the
    encoder output of ``Model._encode`` (timed) feeds 16 greedy decode
    steps (max_len 1536), which project the cross K/V at every step;
    then a 2 + 2-layer float32 twin (2048 frames, 1024 decoder tokens;
    the encoder output held too).

19. Training.  (a) The flash kernel under autograd at smollm-360m's
    training microbatch (B = 4, H = 15, Hkv = 5, S = 4096, D = 64, bf16,
    causal 512-blocks, ``SyntheticLM`` segments): through
    ``ops.flash_attention`` with grad required (``FlashAttentionFunction``,
    one launch), its output == the plain version within
    ``flash_full_tol``; dq, dk, dv for a seeded upstream gradient == autograd
    through the float32 torch twin on the card; the forward kernel's device
    time, the backward's (``flash_attention_vjp``) and its peak memory,
    and one ``scaled_dot_product_attention`` forward and forward plus
    backward (``is_causal``, ``enable_gqa``, no segment mask: not the same
    function, the yardstick); the bound over the pairs the causal and
    document masks leave live.  (b) smollm-360m at full width and depth
    (361,821,120 parameters) through ``TrainLoop``: B = 8, S = 4096, two
    microbatches, 8 steps, cosine schedule to 3e-4, bf16 moments, remat,
    async checkpoints at steps 4 and 8; every loss and grad_norm finite,
    grad_norm > 0; flash launches (every count zeroed just before) exactly
    32 layers x 2 microbatches x 2 (the forward and remat's recompute) x 8
    steps; a fresh loop resumes from the step-4 checkpoint to step 8 and
    repeats the first run's losses; cold and warm step ms, tokens/s, peak
    memory and ``train_mfu``; one more step under ``torch.profiler``
    (device time by class: flash forward, attention backward, products,
    elementwise, optimizer, the rest; idle share).  (c) A 2-layer
    full-width float32 twin (TF32 off, B = 2, S = 1024: the float32
    kernel): one step's loss, every gradient leaf and the parameters after
    one AdamW step (float32 moments) on the card == a ``device="cpu"``
    twin within 1e-3 relative.  (d) Reduced granite-moe-3b-a800m,
    mamba2-2.7b and seamless-m4t-medium the same way (equal expert
    choices; seamless's encoder gradients nonzero).
20. The sharded engines (``repro_torch.core.*_sharded`` over a
    ``launch.mesh.make_host_mesh`` of the whole world) in two worlds:
    (a) one rank on NCCL, in this process (its CPU tensors on gloo), and
    (b) 4 spawned ranks on gloo, all on cuda:0 (NCCL refuses two ranks on
    one device; the kernels are built before the spawn).  Every rank:
    ``sbm_count_sharded`` and ``rank_count_sharded`` at full size A equal
    the single-device ``sbm_count_kernel`` and ``rank_count``;
    ``sbm_enumerate_sharded`` there with max_pairs = K has the pair set of
    ``sbm_enumerate``, and with 65,536 pairs a shard leaves holes and
    keeps every other row; ``bf_count_sharded`` at phase 14's cell equals
    K; ``bitmatrix_sharded`` at bit-matrix cell (a) equals
    ``bitmatrix_words`` bit for bit and ``bitmatrix_count``; K = 65,536²
    past 2**31 exact; each engine on CPU tensors in the same world (its
    plain twin) equals the card's, row for row (bf_count on the first
    10,000 regions a side).  Passes A and B launch once per rank per
    count, the bit-matrix kernel once per rank per call (counts zeroed
    just before, read just after).  Warm medians of 5 calls per engine and
    rank beside the single-device engines' (world (a)); in (b) the ranks
    share one card, so those times measure the collectives and the
    padding, not scaling.
21. Model-side parallelism (``repro_torch.parallel``, ``Model(cfg,
    sharder=...)``).  (a) A world of 1 on NCCL, in this process, mesh
    (1, 1): one prefill wave of 4 x 2048 tokens of ``Model(cfg, sharder)``
    equals ``Model(cfg)`` bit for bit, for smollm-360m and
    granite-moe-3b-a800m at full width and depth (the latter's logits are
    (b)'s reference); then the one-rank references of (b) and (c): a
    2-layer float32 granite prefill, a 2-layer float32 smollm loss and
    gradients, and ``launch.train`` on smollm-360m (3 steps of 4 x 4096,
    checkpoint at step 2).  (b)-(e) in 4 spawned gloo ranks on cuda:0
    (:func:`model_parallel_work`): (b) granite-moe-3b-a800m at full width
    and depth on (data 1, model 4), each rank holding its blocks (drawn
    leaf by leaf from the seeded generator): one prefill wave of 4 x 2048
    tokens for ``moe_impl`` auto (which picks ``ep``: 40 % 4 = 0), ``cap``
    and ``ffn``, and on the einsum path ``gspmd`` (the experts over the
    model axis, as the rules resolve) and ``gspmd capshard`` (the
    capacity slots over it, the expert weights stored whole), each
    mode's collectives per rank printed by kind: last-position logits
    within ``MP_BF16_ERR_BOUND`` of a float32 run of the same weights (relative to its max), greedy tokens equal to the one rank's wherever the
    float32 run's top-1 margin exceeds twice both errors, the drop
    fraction and the tokens whose experts differ from one rank's (and the
    float32 run's) in each layer printed, 32 flash launches a prefill on
    each rank (counts zeroed just before) on its 6 q heads and 2 KV
    heads; every MoE layer's output the same on every model rank; the
    control, an ``ep`` wave with rank 0's partial left out of every
    layer's reduction, must read above the bound; the flash kernel at
    those launch shapes against its plain version and the dense oracle
    within row 6g's ``flash_full_tol``; one MoE layer at full width, each
    mode's bf16 output within ``MP_LAYER_RATIO`` x the one-rank einsum
    path's error against float64 on the same bins, and above it with a
    rank's partial dropped; the 2-layer float32 twin of each mode within
    1e-4 relative.  (c) smollm-360m on (data 2, model 2) through
    ``launch.train.main([..., "--tp", "2", "--distributed"])``: 3 steps
    of 4 x 4096 from the world of 1's seed, every loss finite and within
    ``MP_LOSS_BOUND`` of the world of 1's, and a step apart from it above
    the bound;
    the float32 twin's loss and every gradient leaf (summed over data,
    gathered) within 1e-4; the step-2 checkpoint (gathered, rank 0's) has
    the world of 1's layout and restores in a world of 1 bit for bit.
    (d) ``ring_attention`` (causal) and ``halo_window_attention`` (window
    4096, softcap 50) at gemma2-2b's shapes (B = 1, H = 8, KV = 4, S =
    8192, D = 256; 2048 positions a rank) against dense attention of the
    whole sequence in float32 within 2e-5.  (e) ``compressed_psum`` of a
    47,185,920-float gradient (smollm-360m's embedding) over the 4 ranks:
    the same on every rank bit for bit, within the int8 bound of the exact
    mean.  Times: (b)'s prefill per mode, (c)'s steps, (d), (e).
22. The fuzz, metamorphic and shrink harness (``repro_torch.testing``),
    the dry run and the example twins.  (a) ``fuzz.run_fuzz`` on ``cuda``
    over 44 seeds at the full size ladder (every corpus four times: the
    registry's engines against the host oracle, the metamorphic
    relations, churn scripts through every delta implementation, the
    duplicate-rid probes, the batch split), then each of the 11 corpora
    at n = m of 1 to 4,000 (``FUZZ_SCALED``) through every registered
    engine: zero failures; the wrappers' launch counts, zeroed just
    before, printed, and ``delta_bitmasks``, ``emit_pairs`` and
    ``bitmatch`` must have launched.  (b) ``fuzz.self_check`` on
    ``cuda`` catches the injected tie bug and shrinks it to at most 6
    regions; the shrunk workload's pytest snippet, run on the card,
    passes for every registered engine of its dimension and fails for
    the broken engine.  (c) Every metamorphic relation for every engine
    at d = 1, 2, 3 and the batch split for every churn implementation at
    d = 1, 2, on ``cuda``.  (d) While (a)-(c) run: the dry run
    (``python -m repro_torch.launch.dryrun``, one process a cell, no card
    visible) traces smollm-360m ``train_4k`` on 16 x 16 and grok-1-314b
    ``decode_32k`` on 2 x 16 x 16; each cell's JSON must be written with
    counted flops; its trace seconds and each rank's argument and peak
    bytes are printed; the one-card argument bytes of phase 19's training
    configuration (``dryrun.argument_bytes``) must lie below phase 19's
    measured peak memory.  (e) Also meanwhile, in their own processes on
    the card: ``examples/ddm_service_torch.py --n 20000`` (every count
    against the sequential sweep), ``examples/quickstart_torch.py
    --preset tiny --steps 30`` (the loss falls) and
    ``examples/interest_serving_torch.py`` (every request served).

The build prints every kernel's registers, shared memory and spills from
nvcc's ``-Xptxas -v`` report, and SASS opcode counts (the float32 flash
kernel must hold FFMA and cp.async and no tensor-core instruction).
Every line of numbers that a phase prints is followed, at the latest before
the last line, by the card's name and power limit.

``python3 chip_smoke.py --model-parallel-cards`` runs phase 21 alone with
its world of 4 on NCCL across 4 cards, one rank a card.

``python3 chip_smoke.py --delta-scan`` runs phase 4's delta-scan kernel at
``ddm-paper.match-a100``'s shape alone.

``python3 chip_smoke.py --pass-c [SRC]`` times pass C (``emit_pairs_kernel``,
device time) at the main path's shapes, at full sizes A and B and at
``ddm-paper.match-a100``'s shape
on the port under SRC (another checkout's ``src/``, default this one's), so
that two commits' pass C are timed in one call on one card; at the cell's
shape one ``ops.sbm_enumerate_kernel`` match must give
``core.sbm_enumerate``'s pair set.

``python3 chip_smoke.py --flash-d96 [SRC]`` runs row 6c and phase 17
alone the same way, on the route that port takes for bf16 at D = 96.

``python3 chip_smoke.py --flash-f32-rows [SRC]`` runs rows 6e and 6f
alone (each beside SDPA in float32 with TF32 off and its bound), on the
port under SRC (another checkout's ``src/``, default this one's), so
that two commits' float32 kernels are timed in one call on one card.
The last lines are the ``{"kernels": [...]}`` record (each row's
``sharded_launches``: its launches in phase 20; ``model_parallel_launches``:
in phase 21 (b), every rank; ``harness_launches``: in phase 22 (a)), the
flash rows at
gemma2-2b's shapes, the launch counts (d = 1 main path, d-dim service
path, the four serving paths, phase 14, the prefills of phases 17 and
18, the training run of phase 19, the sharded path of phase 20, the
model-parallel prefills of phase 21, phase 22 (a)), the phase timings,
the card line, and ``{"ok": true, "device": {...}}``.
Data come from a fixed seed.  Exits 2 without a result when no CUDA device
is present or the script stands outside the repository.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
LENGTH = 1.0e6                 # routing space side L (paper §5)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# H100 SXM float32 outside the tensor cores, NVIDIA data sheet: the rate
# the bit-matrix compares are held to
FP32_OPS_PER_S = 67e12
FULL = ((1_000_000, 1.0), (100_000, 100.0))   # (n = m, alpha)
REDUCED_N = 20_000             # pass C against its Python replay
# pass C against its replay at full size A too: there its masks do not fit
# a block's shared memory and live in global memory
PASS_C_FULL_N = 1_000_000
MAIN_N = 100_000               # the service's regions per side
# ddm-paper.match-a100's regions per side and alpha (the delta scan's row)
SCAN_CELL = (500_000, 100.0)
# a service rebuild above the pass-C engine's scratch budget (2 GiB: the
# route changes at n = m ~ 1.48e6), on the rank-table engine
ABOVE_BUDGET_N = 10_000_000
# sbm_enumerate_kernel asked for segments above the kernels' limits
BIG_SEGMENT = 32768
# pass B at block sizes the main path does not launch: 36, shorter than a
# warp's span, and 2050 (not a multiple of 4), the scalar path
PASS_B_EXTRA_BLOCKS = (36, 2050)
CHURN = (("sub", 1), ("upd", 100), ("sub", 1000), ("upd", 10_000))
# d = 5 and 8 run the kernel's run-time-d form
BITMATCH_SHAPES = ((1, 33, 40), (2, 64, 70), (2, 37, 130), (3, 96, 257),
                   (5, 64, 100), (8, 96, 257))
# (d, n, m): m straddles the kernel's words and 128-update stages, n its
# 512-row tiles; integer-grid ties, -0.0 and infinite bounds
BITMATCH_EDGES = ((1, 1030, 1), (4, 1030, 31), (5, 515, 33), (1, 7, 1025),
                  (4, 513, 1025), (5, 1030, 1025))
BITMATCH_FULL = (("a", 32_768, 2, 10.0), ("b", 100_000, 3, 100.0))
DDIM_N = 100_000               # the d-dim service's regions per side
# the serving traffic: prompts a multiple of attn_block_q (512), so prefill
# takes the blockwise path (the flash kernel)
SERVE = dict(arch="smollm-360m", slots=4, requests=8, prompt_len=2048,
             max_new=16, max_len=2560)
# gemma 2's context: 16 blocks of 512, so the local layers' 4096-window
# drops blocks while the global layers stay causal over all 8192
SERVE_GEMMA = dict(arch="gemma2-2b", slots=2, requests=2, prompt_len=8192,
                   max_new=8, max_len=8704)
TWIN = dict(layers=2, prompt_len=1024, steps=4)
# phases 15 and 16: the MoE and the Mamba-2 serves at full width and depth
# (granite: 2 waves of 4; mamba2: 1 wave of 4), and their float32 twins
SERVE_GRANITE = dict(arch="granite-moe-3b-a800m", slots=4, requests=8,
                     prompt_len=2048, max_new=16, max_len=2560)
SERVE_MAMBA = dict(arch="mamba2-2.7b", slots=4, requests=4, prompt_len=2048,
                   max_new=16, max_len=2560)
# phases 17 and 18: the vision-prefix and the encoder-decoder model at full
# width and depth through Model.prefill / decode_step (the reference's
# entry points for them: its serving engine takes token prompts only).
# phi-3-vision: 4 sequences of 576 prefix embeddings + 1472 text tokens
# (2048 positions); seamless: 4 x 2048 frame embeddings into the encoder,
# 4 x 1024-token decoder prompts.  16 greedy decode steps each.
SERVE_PHI3 = dict(arch="phi-3-vision-4.2b", slots=4, prompt_len=2048,
                  max_new=16, max_len=2560)
SERVE_SEAMLESS = dict(arch="seamless-m4t-medium", slots=4, frames=2048,
                      prompt_len=1024, max_new=16, max_len=1536)
# their float32 twins: 2 layers (seamless: 2 + 2) at full width; phi-3's
# 1024 positions hold its 576 prefix embeddings, seamless's 1024 decoder
# tokens cross-attend to 2048 frames
ENCDEC_TWIN = dict(layers=2, prompt_len=1024, frames=2048, steps=4)
# reduced archs held card against CPU (64-token prompts take the blockwise
# path at their 32-blocks)
REDUCED_TWINS = ("jamba-1.5-large-398b", "grok-1-314b")
REDUCED_TWIN = dict(prompt_len=64, steps=4)
# phase 19: training.  smollm-360m at full width and depth, two microbatches
# of 4 x 4096 tokens a step; the flash row at one microbatch's shapes
TRAIN = dict(arch="smollm-360m", batch=8, seq=4096, microbatches=2,
             steps=8, ckpt_every=4, peak_lr=3e-4, params=361_821_120)
TRAIN_FLASH = dict(B=4, H=15, Hkv=5, S=4096, D=64, block=512)
TRAIN_TWIN = dict(layers=2, batch=2, seq=1024)
TRAIN_REDUCED = ("granite-moe-3b-a800m", "mamba2-2.7b",
                 "seamless-m4t-medium")
TRAIN_REDUCED_SEQ = 128
TWIN_TOL = 1e-3                # card vs CPU, relative to the CPU's max |.|
TWIN_LR = 1e-3                 # the training twins' one AdamW step
DECODE_PROFILED = 4            # decode steps under the profiler
# substrings of cuBLAS / CUTLASS matrix-product kernel names
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# substrings of the MoE dispatch's kernels: sort (and searchsorted), the
# gathers into the expert bins and the scatters (bins, combine); the
# embedding lookup's index kernel lands here too
DISPATCH_NAMES = ("sort", "gather", "scatter", "index")
# (B, H, Hkv, Sq, Skv, D, block, features): tests/test_kernels_attention.py
# and the CPU tests' feature grid
FLASH_CASES = (
    (1, 2, 2, 256, 256, 64, 64, {}),
    (2, 4, 2, 128, 128, 64, 64, {}),
    (1, 8, 2, 256, 256, 128, 64, {}),
    (1, 5, 1, 128, 128, 64, 64, {}),
    (1, 2, 2, 256, 256, 64, 64, {"window": 64}),
    (1, 2, 2, 256, 256, 64, 64, {"window": 100}),
    (1, 2, 2, 256, 256, 64, 64, {"window": 128}),
    (1, 2, 2, 128, 128, 64, 64, {"softcap": 30.0}),
    (2, 2, 2, 256, 256, 64, 64, {"segments": True}),
    (1, 2, 2, 128, 512, 64, 64, {}),
    (1, 2, 2, 256, 256, 64, 64, {"window": 64, "num_global_blocks": 1}),
    (2, 6, 2, 96, 192, 128, 32, {"window": 40, "softcap": 30.0,
                                 "segments": True}),
    # the serving schedule's 512-blocks: eight 64-row q tiles per block
    (1, 4, 2, 1024, 1024, 64, 512, {}),
    (1, 3, 1, 512, 1536, 128, 512, {"window": 300}),
    # head width 256 (gemma2-2b): causal; 32-blocks with every feature;
    # 512-blocks with a window, softcap 50 and q_offset
    (1, 4, 2, 256, 256, 256, 64, {}),
    (2, 4, 2, 128, 128, 256, 32, {"window": 40, "softcap": 50.0,
                                  "segments": True}),
    (1, 4, 2, 512, 1536, 256, 512, {"window": 700, "softcap": 50.0}),
    # a width with no instance, zero-padded by the wrapper in bf16 (16 ->
    # 64), with every feature; D = 96 (phi-3-vision), which runs its own
    # wgmma + TMA kernel in bf16: causal, every feature with GQA 3:1 at
    # 32-blocks, and 512-blocks with a window and q_offset
    (1, 4, 2, 128, 128, 16, 32, {"window": 40, "softcap": 30.0,
                                 "segments": True}),
    (1, 4, 2, 256, 256, 96, 64, {}),
    (2, 6, 2, 96, 192, 96, 32, {"window": 40, "softcap": 30.0,
                                "segments": True}),
    (1, 3, 1, 512, 1536, 96, 512, {"window": 300}),
    # widths above 256, the wide bf16 kernel (the float32 kernel runs
    # every float32 case of this battery): every feature (GQA,
    # window, softcap, segments, q_offset) at 32-blocks, causal 64-blocks,
    # 512-blocks with a window, softcap and q_offset; the domain's edges 257
    # and 593 (rows staged by element loads: D not a multiple of 8)
    (1, 4, 2, 96, 192, 320, 32, {"window": 40, "softcap": 30.0,
                                 "segments": True}),
    (1, 4, 2, 256, 256, 512, 64, {}),
    (1, 2, 1, 512, 1536, 512, 512, {"window": 700, "softcap": 50.0}),
    (1, 4, 2, 128, 256, 257, 64, {"softcap": 30.0, "segments": True}),
    (2, 2, 1, 96, 96, 593, 32, {"window": 40}),
    # non-causal (an encoder's self-attention, cross-attention): Sq == Skv
    # at 64-blocks with GQA and segments; at 512-blocks, D = 64 and D = 96
    # (the wgmma kernel); seamless-m4t-medium's cross-attention (Sq = 1024, Skv =
    # 2048) and queries longer than the keys (Sq = 2048, Skv = 1024) at
    # 512-blocks; a window with a global block; D = 128, 256 (softcap) and
    # 320 (the wide kernel) with Sq != Skv
    (2, 4, 2, 256, 256, 64, 64, {"causal": False, "segments": True}),
    (1, 4, 2, 1024, 1024, 64, 512, {"causal": False}),
    (1, 4, 4, 1024, 1024, 96, 512, {"causal": False}),
    (1, 4, 4, 1024, 2048, 64, 512, {"causal": False}),
    (1, 2, 2, 2048, 1024, 64, 512, {"causal": False}),
    (1, 2, 2, 256, 256, 64, 64, {"causal": False, "window": 64,
                                 "num_global_blocks": 1}),
    (1, 4, 2, 128, 256, 128, 64, {"causal": False}),
    (1, 4, 2, 256, 512, 256, 64, {"causal": False, "softcap": 50.0}),
    (1, 2, 1, 256, 128, 320, 64, {"causal": False}),
)
# row 6c: phi-3-vision's attention widths (src/repro/configs/
# phi3_vision_4b.py: 32 heads of 96, kv 32) at smollm-360m's prefill batch,
# length and block
PHI3_FLASH = dict(B=4, H=32, Hkv=32, S=2048, D=96, block=512)
# rows 6d / 6e: a head width above 256 (no config of the repo has one),
# served in bf16 by the wide tensor-core kernel and in float32 by the
# float32 kernel
WIDE_FLASH = dict(B=1, H=8, Hkv=8, S=4096, D=512, block=512)
# row 6f: float32 at smollm-360m's prefill shapes (the width the float32
# model twin runs), on the float32 kernel
F32_FLASH = dict(B=4, H=15, Hkv=5, S=2048, D=64, block=512)
# row 6g: granite-moe-3b-a800m's prefill shapes (24 heads of 64, kv 8)
GRANITE_FLASH = dict(B=4, H=24, Hkv=8, S=2048, D=64, block=512)
# (atol, rtol) as |kernel - ref| <= atol + rtol * |ref|;
# tests/test_kernels_attention.py's bounds
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}


def flash_full_tol(v) -> tuple:
    """(atol, rtol) of the bf16 kernel against a float32 reference that is
    rounded to bf16, |kernel - ref| <= atol + rtol |ref|, for values v.

    The kernel rounds each probability p to bf16 (RNE) before P·V, so
    p~ = p (1 + eps) with |eps| <= 2^-9.  l is summed from the float32 p,
    so its float32 result a = sum p~ v / l differs from the reference's
    b = sum p v / l by |a - b| = |sum (p/l) eps v| <= 2^-9 max|v| =: delta.
    Both sides round to bf16, half a unit in the last place each, at most
    2^-8 of the value: |rnd(a) - ref| <= 2^-8 |a| + delta + 2^-8 |b| with
    |b| <= |ref| / (1 - 2^-8) and |a| <= |b| + delta, hence
    <= (1 + 2^-8) delta + 2^-7 |ref| / (1 - 2^-8).  1e-4 more covers the
    float32 sums taken in another order and exp2 with log2(e) folded into
    the scale (score errors of ~1e-5 at scores of std 4, times max|v| ~ 5).
    """
    delta = 2.0 ** -9 * float(v.float().abs().max())
    return (1 + 2.0 ** -8) * delta + 1e-4, 2.0 ** -7 / (1 - 2.0 ** -8)


# full-width query gain: scores q.k/sqrt(D) of std 4, so the softmax is
# peaked and the online rescale between KV blocks is exercised
FLASH_FULL_Q_GAIN = 4.0
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores, data sheet
REPLACES = {
    "block_sums": "src/repro/kernels/sbm_sweep.py:54",
    "emission": "src/repro/kernels/sbm_sweep.py:63",
    "delta_bitmasks": "src/repro/kernels/sbm_sweep.py:126",
    "emit_pairs": "src/repro/kernels/sbm_sweep.py:205",
    # no Pallas kernel: the JAX package scans with lax.associative_scan
    "delta_scan": "src/repro/core/prefix.py:140",
    "bitmatch": "src/repro/kernels/bitmatch.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:33",
}
SOURCES = dict.fromkeys(
    ("block_sums", "emission", "delta_bitmasks", "delta_scan", "emit_pairs"),
    "src/repro_torch/kernels/csrc/sbm_sweep.cu")
SOURCES["bitmatch"] = "src/repro_torch/kernels/csrc/bitmatch.cu"
SOURCES["flash_attention"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
# bf16 at D = 96 (row 6c, phase 17): the wgmma + TMA kernel
SOURCES["flash_attention_wgmma"] = \
    "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
# phase 14: the DDM surface.  (a) the matching benchmark's bf/rank cell
# (benchmarks/matching.py: n = m = 1e5, alpha = 100, uniform, L = 1e6);
# grid_count's cap that holds every cell there, and bf_count's block
SURFACE_N, SURFACE_ALPHA = 100_000, 100.0
GRID_CAP_EXACT = 2048
BF_BLOCK = 2048
# n * m identical extents: K passes 2**31 (the JAX package's int32 wraps)
WIDE_K = (65_536, 32_769)
SCANS = ("two_level", "blelloch", "xla")
# (c) the broker: sessions of BROKER_N regions a side, BROKER_THREADS
# producers each submitting, per session, BROKER_MOVES single-region moves,
# BROKER_CHURN registers and BROKER_CHURN unregisters
BROKER_N = 100_000
BROKER_THREADS = 4
BROKER_MOVES = 2_500
BROKER_CHURN = 100
# (d) the conformance battery: seeded workloads (n, m) per d
BATTERY_SEEDED = {1: (("uniform", 1000, 1000), ("clustered", 600, 400)),
                  2: (("uniform", 500, 500), ("tall_thin", 300, 300)),
                  3: (("uniform", 400, 300), ("tall_thin", 200, 200))}
# phase 20: the sharded engines in (a) a world of 1 on NCCL (its CPU
# tensors on gloo) and (b) SHARDED_WORLD gloo ranks sharing cuda:0; warm
# medians of SHARDED_REPS calls; a max_pairs_per_shard that cuts at full
# size A; bf_count's CPU twin on the first BF_TWIN_N regions a side of its
# cell; K = n * m past 2**31 on WIDE_SHARDED identical extents
SHARDED_WORLD = 4
SHARDED_REPS = 5
SHARDED_CAP = 65_536
BF_TWIN_N = 10_000
WIDE_SHARDED = (65_536, 65_536)
SHARDED_TIMEOUT_S = 300        # a collective waiting longer fails the rank
# phase 21: model-side parallelism.  A world of 4 gloo ranks on cuda:0
MP_WORLD = 4
MP_TIMEOUT_S = 600
MP_SERVE = dict(arch="granite-moe-3b-a800m", rows=4, prompt_len=2048,
                modes=("auto", "cap", "ffn", "gspmd", "gspmd capshard"),
                seed=SEED + 110)
# the config fields of each phase 21 (b) mode that is not a moe_impl:
# "gspmd capshard" is the einsum path with the capacity slots split over
# the model axis (the JAX layout sweep's v_capshard, the experts
# replicated so that no mesh axis is mapped twice)
MP_MODE_FIELDS = {"gspmd capshard": dict(
    moe_impl="gspmd", sharding_overrides=(("experts", None),
                                          ("expert_ffn", None),
                                          ("moe_cap", "model")))}
MP_SMOLLM_SEED = SEED + 111
MP_TRAIN = dict(arch="smollm-360m", tp=2, batch=4, seq=4096, steps=3,
                ckpt_every=2, seed=SEED + 120)
MP_TWIN = dict(layers=2, rows=4, seq=1024, seed=SEED + 121)
MP_TWIN_TOL = 1e-4             # float32 twins: relative to the max |.|
# bf16 granite logits in a world of 4 against one rank: both are bf16
# evaluations of one function, differing in the order and rounding of
# partial sums.  The yardstick is a float32 run of the same weights (TF32
# off): each mode's last logits must lie within MP_BF16_ERR_BOUND of it,
# relative to its max (2x the largest ep / cap reading on an H100 80GB,
# 0.0252; one rank 0.0234).  Every MoE layer's output must also be the
# same on every model rank (the sum of its bit patterns): the next
# layer routes each token on each rank from it.  The control, an ep wave
# with rank 0's partial left out of every layer's reduction, must read
# above the bound (a fault of one late layer does not: with the partial
# left out of the last layer alone the logits moved 0.024 on an H100,
# so the one-layer check below carries the per-layer precision).
MP_BF16_ERR_BOUND = 0.05
MP_CONTROL_MODE = "auto"
# one MoE layer at full width on the same dispatch (a 4 x 2048 wave,
# x from a seed): each mode's bf16 output within MP_LAYER_RATIO x the
# one-rank einsum path's error, both against a float64 evaluation of the
# einsum path's bins and weights; with one rank's partial dropped from
# the reduction (the control) each mode must read above that bound
MP_LAYER_RATIO = 2.0
MP_LAYER_SEED = SEED + 115
# bf16 smollm losses in a world of 4 (data 2 x model 2) against one rank:
# readings 2.1e-5 (a mean over 16,384 tokens of per-token errors of the
# same kind); the control: the world of 4's loss at step t against the
# world of 1's at step t - 1 (a lost update) must read above the bound
MP_LOSS_BOUND = 1e-3
MP_CP = dict(B=1, H=8, KV=4, S=8192, D=256, window=4096, softcap=50.0,
             seed=SEED + 130)
MP_CP_TOL = 2e-5               # tests/test_context_parallel.py
MP_COMP_N = 49_152 * 960       # smollm-360m's embedding gradient
# phase 22: the fuzz, metamorphic and shrink harness on the card, the dry
# run on the host (subprocesses) and the three example twins.  (a) run_fuzz
# over FUZZ_SEEDS seeds at the full size ladder (seed % 11 picks the
# corpus: every corpus four times), then each corpus at the (n = m, d) of
# FUZZ_SCALED through every registered engine: the dense corpora smaller,
# so that each case's host oracle (a Python set of every pair) stays
# within a few seconds; tall-thin too, whose sequential oracle sweeps
# dimension 0 and so meets all n * m pairs when that dimension is wide
FUZZ_SEEDS = 44
FUZZ_SCALED = (("integer_ties", 300, 1), ("zero_width", 2000, 3),
               ("all_identical", 300, 1), ("duplicates", 400, 2),
               ("uniform_float", 2000, 3), ("extreme_floats", 400, 1),
               ("tall_thin", 1000, 2), ("clustered", 4000, 1),
               ("equal_selectivity", 500, 2), ("single_region", 1, 3),
               ("empty_side", 3000, 1))
# the wrappers that phase 22 (a) must launch (passes A and B launch too)
FUZZ_MUST_LAUNCH = ("delta_bitmasks", "emit_pairs", "bitmatch")
# (d) dry-run cells (arch, shape, mesh), each its own host process
DRYRUN_CELLS = (("smollm-360m", "train_4k", "single"),
                ("grok-1-314b", "decode_32k", "multi"))
DRYRUN_TIMEOUT_S = 600
# (e) the example twins on the card, each its own process
EXAMPLES = (("ddm_service_torch.py", "--n", "20000"),
            ("quickstart_torch.py", "--preset", "tiny", "--steps", "30"),
            ("interest_serving_torch.py",))
EXAMPLE_TIMEOUT_S = 600
# phase 23: the run-time layout is the JAX shard layout (parameters and
# moments cut over data, FSDP; Mamba-2 heads cut over model).  Four gloo
# ranks on cuda:0, as phase 21.  (a) mamba2-2.7b at full width and depth
# on (data 1, model 4), 20 of its 80 heads a rank, with phase 16's
# weights: a 4 x 2048 prefill and 8 decode steps fed one rank's greedy
# tokens; a 2-layer float32 twin for the gradient bits
LAYOUT_MAMBA = dict(arch="mamba2-2.7b", rows=4, prompt_len=2048, steps=8,
                    seed=SEED + 40)
LAYOUT_TWIN = dict(layers=2, seed=SEED + 150)
# phase 21 (b)'s bf16 yardstick, a float32 run of the same weights, does
# not separate a fault here: at depth 64 with random weights one rank's
# own bf16 logits lie 0.45 of the max from it (an H100 run), as far as a
# rank's partial left out of every layer (0.86).  So the bf16 run gives
# the times, the bytes and the greedy tokens (the same on every rank),
# and the check is in float32 (TF32 off): each rank's logits, at the
# prefill and every decode step, and its MambaState.h after the prefill
# within LAYOUT_F32_TOL of one rank's float32 run (relative to its max),
# and the control, rank 0's partial left out of every Mamba layer's
# reduce_from, above it.  The card read 3.24e-4 (logits) and 2.2e-4 (h),
# the control 0.897 (the float32 reordering is amplified as bf16's is)
LAYOUT_F32_TOL = 1e-3
# (b) smollm-360m through the launcher on (data 4, model 1), phase 21
# (c)'s run (4 x 4096, 3 steps), each step's loss and gradient norm within
# MP_LOSS_BOUND of one rank's (relative); the control leaves data rank
# 0's partial out of every FSDP reduce-scatter and must read above the
# bound: one step, whose gradient norm moves at once (the losses barely
# move: AdamW's first updates are near lr · sign(g) whatever the
# gradient's scale; a CPU rehearsal at reduced size read 6.0e-4 on the
# losses, 0.16 on the norms; the card 0.153 over 3 steps)
LAYOUT_DATA = 4
# (c) the dry run's cells of phase 22 (d) against their bytes a rank in
# the replicated layout (parameters replicated over pod and data, Mamba
# heads over model; an H100 run of phase 22 (d)): arguments, peak live
# fake-tensor bytes
DRYRUN_REPLICATED = {"single_smollm-360m_train_4k": (771_726_848, 37_446_167_316),
               "multi_grok-1-314b_decode_32k": (75_337_576_720,
                                                75_476_169_256)}
LAYOUT_TIMEOUT_S = 600
DEVICE = "cuda"
# the sweep kernels' names in a profile (the rebuild trace sums each)
SWEEP_KERNELS = ("block_sums_kernel", "emission_kernel",
                 "delta_bitmask_kernel", "delta_scan_kernel",
                 "emit_pairs_kernel")
# SASS opcodes counted per kernel: tensor cores, cp.async, ldmatrix, and
# the float32 kernel's FFMA and shared loads
SASS_OPS = ("HMMA", "HGMMA", "LDGSTS", "LDSM", "FFMA", "LDS", "UTMALDG")


class SmokeFailure(Exception):
    pass


def live_pairs(kv_index, kv_count, block: int, sq: int, skv: int,
               window=None, causal: bool = True) -> int:
    """(q, k) pairs of a schedule that its token masks (causal or not)
    leave live, per (batch, head): the work the function needs (q
    right-aligned)."""
    import numpy as np

    rows = np.arange(block)[:, None]
    cols = np.arange(block)[None, :]
    total = 0
    for i, n in enumerate(kv_count):
        q_pos = skv - sq + i * block + rows
        for kb in kv_index[i, :n]:
            k_pos = kb * block + cols
            live = k_pos <= q_pos if causal \
                else np.ones((block, block), bool)
            if window is not None:
                live &= k_pos > q_pos - window
            total += int(live.sum())
    return total


def _short_names(mangled) -> dict:
    """Mangled kernel name -> demangled, template arguments kept, return
    type, namespace and parameter list dropped (mangled if no c++filt)."""
    mangled = list(mangled)
    full = dict(zip(mangled, mangled))
    if mangled and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(mangled),
                             capture_output=True, text=True).stdout
        full.update(zip(mangled, out.splitlines()))
    short = {}
    for name, text in full.items():
        text = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", text)
        short[name] = text[:text.index(">") + 1] if "<" in text \
            else text.split("(")[0]
    return short


def ptxas_resources(log: str) -> dict:
    """Registers, spill bytes and static shared memory of every kernel in
    nvcc's ``-Xptxas -v`` report, by short demangled name."""
    names = _short_names(re.findall(r"Compiling entry function '(\w+)'", log))
    res, cur = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            cur = names[entry.group(1)]
            res[cur] = {}
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            res[cur]["spill_stores"] = int(spill.group(1))
            res[cur]["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            res[cur]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            res[cur]["static_smem"] = int(smem.group(1)) if smem else 0
    return res


def sass_counts(library: str, nvcc: str):
    """Per kernel of the built library, how many tensor-core (HMMA, HGMMA),
    asynchronous-copy (LDGSTS) and ldmatrix (LDSM) instructions its SASS
    holds, by ``cuobjdump -sass`` from nvcc's toolkit; None without one."""
    tool = pathlib.Path(nvcc).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\w+)", line)
        if fn:
            cur = fn.group(1)
            counts[cur] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if cur is not None and op and op.group(1) in SASS_OPS:
            counts[cur][op.group(1)] += 1
    names = _short_names(counts)
    return {names[k]: v for k, v in counts.items()}


def flash_dynamic_smem(d: int) -> int:
    """Dynamic shared memory of one block of the bf16 flash instance at
    head width d: ``bf16_smem_bytes`` of ``flash_attention.cu`` (Q and a
    two-stage K/V ring of 64-row sub-tiles, 32-row at d = 256)."""
    kv_rows = 32 if d == 256 else 64
    return (64 * d + 2 * 2 * kv_rows * d) * 2


def wide_flash_dynamic_smem(d: int) -> int:
    """Dynamic shared memory of one block of the wide bf16 flash kernel at
    head width d: ``WideShape::smem_bytes`` of ``flash_attention.cu`` (Q at
    the padded width dp, a two-stage ring of 32-row K sub-tiles at dp and V
    sub-tiles at the block's two chunks, vs 16-byte chunks a row, and the
    partial scores the warpgroups swap)."""
    dp = -(-d // 64) * 64
    nc = 2 if dp <= 512 else 4
    cw = -(-(-(-dp // nc)) // 16) * 16
    vs = -(-(2 * cw // 8) // 8) * 8
    return (64 * dp + 2 * 32 * (dp + 8 * vs)) * 2 + 2 * 64 * 32 * 4


# dynamic shared memory of one block of the float32 flash kernel at every
# width: kF32SmemBytes of flash_attention.cu (a three-stage ring of Q/K
# chunks, 2 x 64 rows x 36 floats, and P^T, 64 x 68 floats)
F32_FLASH_SMEM = (3 * 2 * 64 * 36 + 64 * 68) * 4
# dynamic shared memory of the D = 96 wgmma kernel (kSmemBytes of
# flash_attention_wgmma.cu): 1,024 B of alignment slack, Q (128 x 96
# bf16), three stages of K and V (128 x 96 each), the mbarriers
WGMMA_FLASH_SMEM = 1024 + 128 * 96 * 2 + 3 * 2 * 128 * 96 * 2 + 64


def attention_layers(cfg) -> int:
    """Layers of ``cfg`` with an attention mixer (the flash kernel's call
    sites in a prefill that takes the blockwise path)."""
    return cfg.num_blocks * sum(spec.mixer != "mamba" for spec in cfg.pattern)


def prefill_flash_calls(cfg, seq: int, frames: int = 0) -> dict:
    """Flash launches of one prefill of ``seq`` decoder positions (and
    ``frames`` encoder frames), keyed (site, Sq, Skv, causal): attention
    takes the blockwise path when Sq is above ``attn_block_q`` and Sq, Skv
    are multiples of the blocks.  Sites: ``decoder`` self-attention at
    (seq, seq), causal unless ``attn_bidir``; ``cross``-attention at (seq,
    frames) and the ``encoder``'s self-attention at (frames, frames),
    non-causal unless causal mixers.  ``_encode`` launches the encoder's
    again."""
    bq, bk = cfg.attn_block_q, cfg.attn_block_k
    calls = {}

    def add(site, sq, skv, causal, n):
        if cfg.attn_impl != "dense" and sq > bq and sq % bq == 0 \
                and skv % bk == 0:
            key = (site, sq, skv, causal)
            calls[key] = calls.get(key, 0) + n

    for spec in cfg.pattern:
        if spec.mixer != "mamba":
            add("decoder", seq, seq, spec.mixer != "attn_bidir",
                cfg.num_blocks)
        if spec.cross_attn:
            add("cross", seq, frames, False, cfg.num_blocks)
    if cfg.is_encoder_decoder:
        n_enc = cfg.num_encoder_layers // len(cfg.encoder_pattern)
        for spec in cfg.encoder_pattern:
            if spec.mixer != "mamba":
                add("encoder", frames, frames, spec.mixer != "attn_bidir",
                    n_enc)
    return calls


def train_flash_calls(cfg, seq: int, frames: int = 0,
                      microbatches: int = 1) -> int:
    """Flash launches of one training step: every attention call of the
    forward (``prefill_flash_calls``; the encoder once), per microbatch,
    and again in the backward pass's recomputation with ``cfg.remat``."""
    per_pass = sum(prefill_flash_calls(cfg, seq, frames).values())
    return per_pass * microbatches * (2 if cfg.remat else 1)


def doc_pairs(segments) -> int:
    """(q, k) pairs a causal mask over packed documents leaves live: the
    sum over the rows' documents of n (n + 1) / 2."""
    import numpy as np

    total = 0
    for row in segments.cpu().numpy():
        n = np.unique(row, return_counts=True)[1].astype(np.int64)
        total += int((n * (n + 1) // 2).sum())
    return total


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch

    t_start = time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    rows_only = argv[0] if argv[:1] in (["--flash-f32-rows"],
                                        ["--flash-d96"]) else None
    rows_only = "--pass-c" if argv[:1] == ["--pass-c"] else rows_only
    src = pathlib.Path(argv[1]).resolve() if rows_only and len(argv) > 1 \
        else ROOT / "src"
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the repository root (src/repro_torch "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if rows_only == "--flash-f32-rows":
        return flash_f32_rows(torch, src)
    if rows_only == "--flash-d96":
        return flash_d96(torch, src)
    if rows_only == "--pass-c":
        return pass_c_alone(torch, src)
    if argv[:1] == ["--model-parallel-cards"]:
        return model_parallel_cards(torch)
    if argv[:1] == ["--layout"]:
        return layout_alone(torch)
    if argv[:1] == ["--delta-scan"]:
        return delta_scan_alone(torch)
    # torch.compile's caches (the flex_attention yardstick) stay in the
    # checkout's build/
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    for n, alpha in FULL:
        smoke.full_size(n, alpha)
    smoke.main_path()
    smoke.segment_sizes()
    smoke.kernels_at_main_shapes()
    smoke.scan_at_cell_shape()
    smoke.pass_c_at_cell_shape()
    smoke.bitmatch_battery()
    for cell, n, d, alpha in BITMATCH_FULL:
        smoke.bitmatch_full(cell, n, d, alpha)
    smoke.ddim_service()
    smoke.above_budget()
    smoke.bitmatch_timing()
    smoke.flash_battery()
    smoke.flash_full()
    smoke.flash_encdec_rows()
    smoke.serve()
    smoke.serve_gemma()
    smoke.model_twin()
    smoke.ddm_surface(card, t_start)
    smoke.serve_granite()
    smoke.serve_mamba()
    smoke.serve_phi3()
    smoke.serve_seamless()
    smoke.train()
    smoke.sharded(card)
    smoke.model_parallel(card)
    smoke.harness(card)
    smoke.layout(card)
    smoke.report(card)
    return 0


def layout_alone(torch) -> int:
    """``chip_smoke.py --layout``: phase 23 (a) and (b) alone (no dry run:
    (c) reads phase 22's cells)."""
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    smoke.layout(card)
    print("timings_ms: " + json.dumps(
        {k: round(v, 3) for k, v in smoke.phase_ms.items()}))
    print(card)
    return 0


def delta_scan_alone(torch) -> int:
    """``chip_smoke.py --delta-scan``: phase 4's delta-scan row at
    ``ddm-paper.match-a100``'s shape alone."""
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    smoke.scan_at_cell_shape()
    print(json.dumps({"card": card, "kernels": list(smoke.rows.values())}))
    print(card)
    return 0


def pass_c_alone(torch, src) -> int:
    """``chip_smoke.py --pass-c [SRC]``: pass C's device time at the main
    path's shapes (shared masks), at full sizes A and B and at
    ``ddm-paper.match-a100``'s shape, on the port whose ``src/`` directory
    is SRC (default this checkout's)."""
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    subs, upds = smoke.workload(MAIN_N, 1.0, SEED + 2)
    smoke.pass_c_timed(smoke.pass_inputs(subs, upds),
                       f"main path n=m={MAIN_N} alpha=1")
    for n, alpha in FULL:
        subs, upds = smoke.workload(n, alpha, SEED)
        smoke.pass_c_timed(smoke.pass_inputs(subs, upds),
                           f"n=m={n} alpha={alpha:g}")
    smoke.pass_c_at_cell_shape()
    print(json.dumps({"src": str(src), "card": card,
                      "pass_c": smoke.pass_c_rows}))
    print(card)
    return 0


def model_parallel_cards(torch) -> int:
    """``chip_smoke.py --model-parallel-cards``: phase 21 alone with its
    world of 4 on NCCL, one rank a card (needs ``MP_WORLD`` cards): the
    scaling that four ranks sharing one card cannot show."""
    if torch.cuda.device_count() < MP_WORLD:
        print(f"chip_smoke: --model-parallel-cards needs {MP_WORLD} cards",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    smoke.model_parallel(card, cards=True)
    print("timings_ms: " + json.dumps(
        {k: round(v, 3) for k, v in smoke.phase_ms.items()}))
    print(card)
    return 0


def flash_d96(torch, src) -> int:
    """``chip_smoke.py --flash-d96 [SRC]``: row 6c and phase 17 alone, on
    the port whose ``src/`` directory is SRC (default this checkout's), on
    whichever route that port takes for bf16 at D = 96 (``"wgmma"`` here,
    ``"padded"`` before), so that two commits are timed in one call on
    one card."""
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    route = smoke.flash_route(96, torch.bfloat16)[0]
    smoke.flash_via_ops("flash_attention_d96", PHI3_FLASH,
                        "phi-3-vision widths", SEED + 18, route, True)
    smoke.serve_phi3(route)
    prof = smoke.phi3_numbers["profile"]["prefill"]
    print(json.dumps({
        "src": str(src), "card": card, "route": route,
        "kernels": list(smoke.rows.values()),
        "phase_17": {k: smoke.phi3_numbers[k] for k in (
            "prefill_ms", "flash_calls_device_ms_per_prefill",
            "flash_launches_by_route", "flash_share_of_prefill_device_time")},
        "prefill_device_ms_per_step": prof["device_ms_per_step"]},
        default=str))
    print(card)
    return 0


def flash_f32_rows(torch, src) -> int:
    """``chip_smoke.py --flash-f32-rows [SRC]``: rows 6e and 6f alone, on
    the port whose ``src/`` directory is SRC (default this checkout's), so
    that two commits' float32 kernels are timed in one call on one card:
    each beside SDPA in float32 with TF32 off and its bound."""
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    smoke.flash_via_ops("flash_attention_d512_f32", WIDE_FLASH,
                        "wide head, float32", SEED + 21, "runtime", False,
                        torch.float32)
    smoke.flash_via_ops("flash_attention_d64_f32", F32_FLASH,
                        "smollm-360m prefill, float32", SEED + 22, "runtime",
                        False, torch.float32)
    print(json.dumps({"src": str(src), "card": card,
                      "kernels": list(smoke.rows.values())}))
    print(card)
    return 0


class Smoke:
    def __init__(self, torch):
        from repro_torch.core import runtime
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import bitmatch as B
        from repro_torch.kernels import sbm_sweep as K
        from repro_torch.kernels.flash_attention import KERNEL_WRAPPERS as F
        from repro_torch.kernels.flash_attention import flash_route

        self.torch = torch
        self.K, self.B, self.ref, self.ops, self._build = K, B, ref, ops, _build
        self.flash = F[0]
        self.flash_route = flash_route
        self.wrappers = K.KERNEL_WRAPPERS + B.KERNEL_WRAPPERS + F
        self.round_up_pow2 = runtime.round_up_pow2
        self.dev = torch.device(DEVICE)
        self.err = {w.__name__: 0 for w in K.KERNEL_WRAPPERS
                    + B.KERNEL_WRAPPERS}
        self.err["flash_attention"] = 0.0
        self.phase_ms = {}
        self.launches = {}
        self.rows = {}
        self.timing_source = {}
        self.pass_c_rows = {}

    # -- helpers ---------------------------------------------------------
    def workload(self, n: int, alpha: float, seed: int):
        from repro_torch.core import make_uniform_workload

        g = self.torch.Generator().manual_seed(seed)
        return make_uniform_workload(n, n, alpha, length=LENGTH, generator=g,
                                     device=self.dev)

    def same(self, name: str, got, want, what: str) -> None:
        """Exact equality of kernel and plain outputs; records max |diff|."""
        torch = self.torch
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"{what}: shape/dtype {g.shape}/{g.dtype} vs "
                    f"{w.shape}/{w.dtype}")
            diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
                if g.numel() else 0
            self.err[name] = max(self.err[name], diff)
            require(diff == 0, f"{what}: kernel != plain (max |diff| {diff})")

    def stream(self, subs, upds, block_size: int):
        from repro_torch.core.sweep import (_indicator_deltas, _pad_stream,
                                            encode_endpoints)

        torch = self.torch
        ep = _pad_stream(encode_endpoints(subs, upds), block_size)
        return ep, torch.stack(_indicator_deltas(ep)).contiguous()

    def pass_inputs(self, subs, upds):
        """Every kernel's inputs for one workload, as the entry points in
        repro_torch.kernels.ops build them."""
        torch, K = self.torch, self.K
        n, m = subs.size, upds.size
        ep, deltas = self.stream(subs, upds, self.ops.COUNT_BLOCK)
        ep4, deltas4 = self.stream(subs, upds, self.ops.ENUMERATE_BLOCK)
        up = ep4.is_upper.to(torch.int32)
        real = ep4.owner >= 0
        vs, vu = (ep4.is_sub & real).to(torch.int32), \
            (~ep4.is_sub & real).to(torch.int32)
        ws, wu = -(-n // 32), -(-m // 32)
        _, seg, k = K.sweep_count(deltas4, block_size=self.ops.ENUMERATE_BLOCK)
        sa, sd = K.delta_bitmasks(ep4.owner, up, vs, num_words=ws,
                                  block_size=self.ops.ENUMERATE_BLOCK)
        ua, ud = K.delta_bitmasks(ep4.owner, up, vu, num_words=wu,
                                  block_size=self.ops.ENUMERATE_BLOCK)
        return {
            "deltas": deltas, "deltas4": deltas4, "ep4": ep4, "up": up,
            "vs": vs, "vu": vu,
            "ws": ws, "wu": wu, "cap": max(int(seg.max()), 1), "k": int(k),
            "scan": (sa, sd, ua, ud),
            "c_args": (ep4.owner.clamp(min=0), up, ep4.is_sub.to(torch.int32),
                       real.to(torch.int32), K.delta_scan(sa, sd),
                       K.delta_scan(ua, ud)),
        }

    def check_counting(self, deltas, what, bs):
        K, ref = self.K, self.ref
        what = f"{what} block {bs}"
        sums = K.block_sums(deltas, block_size=bs)
        self.same("block_sums", [sums], [ref.ref_block_sums(deltas,
                                                            block_size=bs)],
                  f"pass A {what}")
        offsets = self.torch.cumsum(sums, dim=0, dtype=self.torch.int32) - sums
        got = K.emission(deltas, offsets, block_size=bs)
        self.same("emission", got, ref.ref_emission(deltas, offsets,
                                                    block_size=bs),
                  f"pass B {what}")
        return int(got[1].sum())

    def check_bitmasks(self, x, what):
        """The delta-bitmask kernel == its plain version on both extent
        types' records, as the stream gives them and pushed off its
        contract by each kind of ``ref.off_contract_records``."""
        K, ref, bs = self.K, self.ref, self.ops.ENUMERATE_BLOCK
        for valid, words in ((x["vs"], x["ws"]), (x["vu"], x["wu"])):
            streams = {"": (x["ep4"].owner, x["up"], valid)}
            for kind in ref.OFF_CONTRACT_KINDS:
                streams[f", {kind}"] = ref.off_contract_records(
                    kind, x["ep4"].owner, x["up"], valid, block_size=bs)
            for kind, records in streams.items():
                got = K.delta_bitmasks(*records, num_words=words,
                                       block_size=bs)
                want = ref.ref_delta_bitmasks(*records, num_words=words,
                                              block_size=bs)
                self.same("delta_bitmasks", got, want,
                          f"delta bitmasks {what}{kind}")

    def check_scan(self, x, what):
        """The delta-scan kernel == the plain loop on the same card tensors:
        each extent type's Add/Del words as the bitmask kernel gives them,
        and with Del widened to share every bit of Add."""
        from repro_torch.core import prefix

        sa, sd, ua, ud = x["scan"]
        for side, add, rem in (("subscriptions", sa, sd),
                               ("updates", ua, ud)):
            for kind, r in (("", rem), (", Add and Del overlapping",
                                        rem | add)):
                self.same("delta_scan", [self.K.delta_scan(add, r)],
                          [prefix.delta_scan_exclusive(add, r)],
                          f"delta scan {what}, {side}{kind}")

    def check_pass_c(self, x, what, placement=None):
        """Pass C == its replay; the kernel's mask placement must be
        ``placement`` when given.  Returns the replay's ms."""
        bs = self.ops.ENUMERATE_BLOCK
        place = self.K.emit_pairs_placement(bs, x["ws"], x["wu"])
        require(placement in (None, place), f"pass C {what}: masks in "
                f"{place} memory, expected {placement}")
        got = self.K.emit_pairs(*x["c_args"], block_size=bs, cap=x["cap"])
        t0 = time.perf_counter()
        want = self.ref.ref_emit_pairs(*x["c_args"], block_size=bs,
                                       cap=x["cap"])
        self.torch.cuda.synchronize()
        self.same("emit_pairs", got, want, f"pass C {what} ({place} masks)")
        return (time.perf_counter() - t0) * 1e3

    @staticmethod
    def pair_keys(pairs, m):
        """The sorted keys i * m + j of a pair buffer's valid rows."""
        keep = pairs[:, 0] >= 0
        return (pairs[keep, 0].long() * m + pairs[keep, 1]).sort().values

    @staticmethod
    def pair_set(pairs) -> set:
        return {(i, j) for i, j in pairs.cpu().tolist() if i >= 0}

    @staticmethod
    def dim_rows(e):
        """(d, n) contiguous bounds of extents (1-d promoted to one row)."""
        lo, hi = (e.lo, e.hi) if e.lo.ndim == 2 else (e.lo[None], e.hi[None])
        return lo.contiguous(), hi.contiguous()

    def timed(self, name, fn):
        """Run ``fn`` once to completion on the card; record its ms."""
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.phase_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    # -- phases ----------------------------------------------------------
    def build(self):
        t0 = time.perf_counter()
        self._build.library()
        secs = time.perf_counter() - t0
        print(f"build: {secs:.3f} s (nvcc sm_90a + ctypes load)", flush=True)
        # nvcc -Xptxas -v: registers, spills and shared memory per kernel
        resources = ptxas_resources(self._build.build_log())
        require(resources, "build: no -Xptxas -v report beside the "
                "library; delete build/kernels and run again")
        lib = self._build.library()
        sass = sass_counts(lib._name, self._build._nvcc())
        for name, res in resources.items():
            flash = re.match(r"flash_attention_fwd_bf16_kernel<(\d+)>", name)
            wide = name == "flash_attention_fwd_wide_kernel"
            if flash or wide:
                res["dynamic_smem"] = (
                    flash_dynamic_smem(int(flash.group(1))) if flash else
                    {f"D={d}": wide_flash_dynamic_smem(d)
                     for d in (257, 320, 512, 593)})
                if sass is not None:
                    res["sass"] = sass.get(name, dict.fromkeys(SASS_OPS, 0))
                    # the bf16 kernel runs on the tensor cores, fed by cp.async
                    require(res["sass"]["HMMA"] + res["sass"]["HGMMA"] > 0
                            and res["sass"]["LDGSTS"] > 0,
                            f"{name}: no tensor-core or cp.async instruction "
                            f"in its SASS: {res['sass']}")
            if name == "flash_attention_fwd_d96_kernel":
                res["dynamic_smem"] = WGMMA_FLASH_SMEM
                if sass is not None:
                    res["sass"] = sass.get(name, dict.fromkeys(SASS_OPS, 0))
                    # wgmma fed by TMA, no mma.sync and no cp.async
                    require(res["sass"]["HGMMA"] > 0
                            and res["sass"]["UTMALDG"] > 0
                            and res["sass"]["HMMA"] == 0
                            and res["sass"]["LDGSTS"] == 0,
                            f"{name}: no wgmma or TMA instruction, or "
                            f"mma.sync or cp.async, in its SASS: "
                            f"{res['sass']}")
            if name.startswith("flash_attention_fwd_f32_kernel"):
                res["dynamic_smem"] = F32_FLASH_SMEM
                if sass is not None:
                    res["sass"] = sass.get(name, dict.fromkeys(SASS_OPS, 0))
                    # FFMA only, fed by cp.async
                    require(res["sass"]["HMMA"] + res["sass"]["HGMMA"] == 0
                            and res["sass"]["FFMA"] > 0
                            and res["sass"]["LDGSTS"] > 0,
                            f"{name}: tensor-core instructions, or no FFMA "
                            f"or cp.async, in its SASS: {res['sass']}")
            print(f"  {name}: " + json.dumps(res))
        if sass is None:
            print("  (no cuobjdump beside nvcc: SASS not counted)")
        self.phase_ms["build"] = secs * 1e3

    def full_size(self, n: int, alpha: float):
        from repro_torch.core import sbm_enumerate, sequential_sbm_count_numpy

        torch = self.torch
        tag = f"n=m={n} alpha={alpha:g}"
        subs, upds = self.workload(n, alpha, SEED)
        x = self.pass_inputs(subs, upds)
        k = self.check_counting(x["deltas"], tag, self.ops.COUNT_BLOCK)
        k4 = self.check_counting(x["deltas4"], tag, self.ops.ENUMERATE_BLOCK)
        self.check_bitmasks(x, tag)
        self.check_scan(x, tag)
        t0 = time.perf_counter()
        k_seq = sequential_sbm_count_numpy(subs, upds)
        require(k == k4 == k_seq == x["k"],
                f"{tag}: K {k} (count block) / {k4}, {x['k']} (enumerate "
                f"block) != sequential {k_seq}")
        seq_s = time.perf_counter() - t0
        max_pairs = self.round_up_pow2(k)
        torch.cuda.synchronize()
        self.K.delta_bitmasks.launches = 0
        t0 = time.perf_counter()
        pairs, count = self.ops.sbm_enumerate_kernel(subs, upds,
                                                     max_pairs=max_pairs)
        torch.cuda.synchronize()
        engine_ms = (time.perf_counter() - t0) * 1e3
        if n == PASS_C_FULL_N:
            self.bitmasks_full(x, tag, self.K.delta_bitmasks.launches)
        t0 = time.perf_counter()
        plain, plain_count = sbm_enumerate(subs, upds, max_pairs=max_pairs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(int(count) == k == int(plain_count),
                f"{tag}: pass-C engine count {int(count)} != K {k}")
        require(torch.equal(self.pair_keys(pairs, n),
                            self.pair_keys(plain, n)),
                f"{tag}: pass-C engine pair set != sbm_enumerate pair set")
        small_s, small_u = self.workload(REDUCED_N, alpha, SEED + 1)
        replay_ms = self.check_pass_c(self.pass_inputs(small_s, small_u),
                                      f"n=m={REDUCED_N} alpha={alpha:g}")
        self.pass_c_full(x, tag, check=n == PASS_C_FULL_N)
        print(f"full size {tag}: K={k} exact (sequential sweep {seq_s:.1f} s); "
              f"passes A/B and delta bitmasks == plain (bitmasks also off the "
              f"contract); pass-C engine "
              f"{engine_ms:.1f} ms, pair set == sbm_enumerate "
              f"({plain_ms:.1f} ms); pass C == "
              f"replay at n=m={REDUCED_N} (replay {replay_ms:.0f} ms)",
              flush=True)
        self.phase_ms[f"enumerate_kernel {tag}"] = engine_ms
        self.phase_ms[f"sbm_enumerate (plain) {tag}"] = plain_ms

    def bitmasks_full(self, x, tag, launches: int):
        """The delta-bitmask kernel's row at full size A: device time per
        launch beside its plain version and its byte bound (three int32
        records read, two rows of words written); ``launches`` were counted
        in the pass-C engine's run at this size."""
        K, ref, bs = self.K, self.ref, self.ops.ENUMERATE_BLOCK
        require(launches > 0, f"{tag}: the pass-C engine launched no "
                "delta-bitmask kernel")
        args = (x["ep4"].owner, x["up"], x["vs"])
        total = args[0].shape[0]
        ms = self.time_ms(lambda: K.delta_bitmasks(
            *args, num_words=x["ws"], block_size=bs), 20,
            "delta_bitmask_kernel")
        self.bitmask_full_row = {
            "name": f"delta_bitmasks (full size A, {tag})", "route": "cuda",
            "source": SOURCES["delta_bitmasks"],
            "replaces": REPLACES["delta_bitmasks"], "launches": launches,
            "max_abs_err": self.err["delta_bitmasks"], "ms": ms,
            "plain_ms": self.time_ms(lambda: ref.ref_delta_bitmasks(
                *args, num_words=x["ws"], block_size=bs), 20),
            "bound_ms": (12 * total + 8 * (total // bs) * x["ws"])
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
        }
        print(f"delta bitmasks at full size {tag}: {ms:.4f} ms per launch "
              f"(source {self.timing_source.get('delta_bitmask_kernel')}), "
              f"plain {self.bitmask_full_row['plain_ms']:.4f} ms, bound "
              f"{self.bitmask_full_row['bound_ms']:.5f} ms; {launches} "
              "launches in the pass-C engine", flush=True)

    def pass_c_full(self, x, tag, check: bool):
        """Pass C at full size: its device time per launch and, when
        ``check``, == its replay with its masks in global memory (at the
        other cell, dense sets, the reduced replay above holds it)."""
        if check:
            replay_ms = self.check_pass_c(x, tag, "global")
            print(f"pass C at full size {tag}: kernel == replay "
                  f"({replay_ms:.0f} ms), masks in global memory", flush=True)
            self.check_pass_c_any_records(x, tag, "global",
                                          with_stray=False)
        self.pass_c_timed(x, tag)

    def drive_service(self, tag, dims, subs, upds, move_bounds, rng):
        """Bulk register, flush, match_count, pairs, then the CHURN flushes
        on a ``DEVICE`` service and a ``device="cpu"`` twin: every
        BatchDelta must be equal, pairs() after churn equal to a fresh
        rebuild.  The sweep kernels' launch counts are zeroed just before
        and read just after.  Returns (service, pairs, regimes, launches)."""
        import numpy as np
        from repro_torch.api import DDMService

        torch, K = self.torch, self.K
        twin = DDMService(dims=dims, device="cpu")
        block = (lambda x: x.numpy()) if dims == 1 else (lambda x: x.T.numpy())
        bounds = {"sub": (block(subs.lo), block(subs.hi)),
                  "upd": (block(upds.lo), block(upds.hi))}
        for w in K.KERNEL_WRAPPERS:
            w.launches = 0
        torch.cuda.synchronize()
        svc = DDMService(dims=dims, device=DEVICE)
        rids = {}
        for side, (lo, hi) in bounds.items():
            rids[side] = self.timed(f"{tag}register {side}",
                                    lambda: svc.register(side, lo, hi))
            require(np.array_equal(rids[side], twin.register(side, lo, hi)),
                    f"{tag}register: rids differ from the cpu twin")
        delta = self.timed(f"{tag}flush bulk", svc.flush)
        require(delta == twin.flush(), f"{tag}bulk flush: BatchDelta != cpu twin")
        k = self.timed(f"{tag}match_count", svc.match_count)
        require(k == len(delta.added), f"{tag}match_count {k} != |pairs| "
                f"{len(delta.added)}")
        pairs = self.timed(f"{tag}pairs (rebuild)", svc.pairs)
        require(pairs == delta.added, f"{tag}pairs() != the bulk flush's delta")
        for side, b in CHURN:
            moved = rng.choice(rids[side], size=b, replace=False)
            lo, hi = move_bounds(b)
            svc.move(side, moved, lo, hi)
            twin.move(side, moved, lo, hi)
            delta = self.timed(f"{tag}flush b={b}", svc.flush)
            require(delta == twin.flush(),
                    f"{tag}churn b={b}: BatchDelta != cpu twin")
            pairs = (pairs - delta.removed) | delta.added
        regimes = svc.stats()["by_regime"]
        require(regimes.get("device", 0) > 0,
                f"{tag}the device rematch regime never ran: {regimes}")
        cached = svc.pairs()
        require(cached == pairs, f"{tag}delta-composed pairs != the service cache")
        svc.invalidate_cache()
        rebuilt = self.timed(f"{tag}pairs (rebuild after churn)", svc.pairs)
        require(rebuilt == cached, f"{tag}pairs() after churn != a fresh rebuild")
        require(svc.match_count() == len(rebuilt), f"{tag}match_count != |pairs|")
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}
        require(all(v > 0 for v in launches.values()),
                f"{tag}a kernel was not launched on the path: {launches}")
        return svc, rebuilt, svc.stats()["by_regime"], launches

    def main_path(self):
        import numpy as np
        from repro_torch.core import make_uniform_workload

        g = self.torch.Generator().manual_seed(SEED + 2)
        subs, upds = make_uniform_workload(MAIN_N, MAIN_N, 1.0, length=LENGTH,
                                           generator=g, device="cpu")
        rng = np.random.default_rng(SEED + 3)
        seg_len = 1.0 * LENGTH / (2 * MAIN_N)

        def move_bounds(b):
            lo = rng.uniform(0.0, LENGTH - seg_len, size=b).astype(np.float32)
            return lo, lo + np.float32(seg_len)

        svc, rebuilt, regimes, self.launches = self.drive_service(
            "", 1, subs, upds, move_bounds, rng)
        self.main_live = (svc._subs.compact(svc._subs.live_ids(), self.dev),
                          svc._upds.compact(svc._upds.live_ids(), self.dev))
        print(f"main path: n=m={MAIN_N}, K={len(rebuilt)}, churn "
              f"{[b for _, b in CHURN]} deltas == cpu twin, pairs == rebuild, "
              f"regimes {regimes}", flush=True)
        self.rebuild_profile(svc, rebuilt)
        self.rebuild_routes(svc, rebuilt)

    def profiled_rebuild(self, svc):
        """One rebuild (cache dropped, ``pairs()``) under torch.profiler:
        (pairs, wall ms by the host clock, device busy ms)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        svc.invalidate_cache()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            got = svc.pairs()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        return got, wall_ms, busy

    def rebuild_routes(self, svc, want):
        """One warm rebuild on each route at the main path: the pass-C
        kernel engine (the default: its scratch is far below the budget)
        and the rank-table engine (``REBUILD_SCRATCH_BUDGET`` set to 0 in
        this process); device and wall time, equal pair sets, and which
        engine ran by pass C's launch count."""
        from repro_torch.core import service as service_lib

        K = self.K
        budget = service_lib.REBUILD_SCRATCH_BUDGET
        scratch = self.ops.pass_c_scratch_bytes(MAIN_N, MAIN_N)
        require(scratch <= budget, f"the main path's scratch {scratch} B is "
                f"above the budget {budget} B")
        out = {}
        try:
            for route, cap in (("kernel", budget), ("rank_table", 0)):
                service_lib.REBUILD_SCRATCH_BUDGET = cap
                svc.invalidate_cache()
                require(svc.pairs() == want, f"rebuild ({route} route): "
                        "pairs() differs from the main path's")   # warm-up
                before = K.emit_pairs.launches
                got, wall, busy = self.profiled_rebuild(svc)
                ran = K.emit_pairs.launches - before
                require(got == want, f"rebuild ({route} route): pairs() "
                        "differs from the main path's")
                require(ran == (route == "kernel"), f"rebuild ({route} "
                        f"route): pass C launched {ran} times")
                out[route] = {"wall_ms": round(wall, 3),
                              "device_ms": round(busy, 4)}
                self.phase_ms[f"rebuild {route} route wall"] = wall
                self.phase_ms[f"rebuild {route} route device"] = busy
        finally:
            service_lib.REBUILD_SCRATCH_BUDGET = budget
        print(f"rebuild routes (main path, n=m={MAIN_N}, pass-C scratch "
              f"{scratch} B, budget {budget} B; one warm rebuild each, "
              f"pairs equal): {json.dumps(out)}; {card_line()}", flush=True)

    def above_budget(self):
        """A service rebuild above the budget on the card: n = m =
        ABOVE_BUDGET_N regions (α = 1), registered in bulk; the cold count
        (passes A and B) must equal len(pairs()), which the rank-table
        engine enumerates.  Peak device memory of the rebuild beside the
        pass-C engine's reckoned scratch at the same sizes."""
        from repro_torch.api import DDMService
        from repro_torch.core import make_uniform_workload
        from repro_torch.core import service as service_lib

        torch, K, n = self.torch, self.K, ABOVE_BUDGET_N
        scratch = self.ops.pass_c_scratch_bytes(n, n)
        budget = service_lib.REBUILD_SCRATCH_BUDGET
        require(scratch > budget, f"n=m={n}: scratch {scratch} B is not "
                f"above the budget {budget} B")
        g = torch.Generator().manual_seed(SEED + 30)
        subs, upds = make_uniform_workload(n, n, 1.0, length=LENGTH,
                                           generator=g, device="cpu")
        svc = DDMService(device=DEVICE)
        for side, e in (("sub", subs), ("upd", upds)):
            self.timed(f"above budget register {side}",
                       lambda e=e, side=side: svc.register(
                           side, e.lo.numpy(), e.hi.numpy()))
        del subs, upds
        k = self.timed("above budget match_count", svc.match_count)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = K.emit_pairs.launches
        pairs = self.timed("above budget pairs (rebuild)", svc.pairs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        require(K.emit_pairs.launches == before, "above the budget the "
                "rebuild launched pass C")
        require(len(pairs) == k and k > 0, f"above the budget: "
                f"len(pairs()) {len(pairs)} != match_count() {k}")
        print(f"above the budget: n=m={n}, K={k} == len(pairs()); rebuild "
              f"peak device memory {peak} B ({peak - base} B above the "
              f"{base} B held before it) beside the pass-C engine's "
              f"reckoned scratch {scratch} B (budget {budget} B); register "
              f"{self.phase_ms['above budget register sub']:.0f} + "
              f"{self.phase_ms['above budget register upd']:.0f} ms, "
              f"match_count {self.phase_ms['above budget match_count']:.0f} "
              f"ms, pairs() {self.phase_ms['above budget pairs (rebuild)']:.0f}"
              f" ms; {card_line()}", flush=True)
        self.above = {"n": n, "K": k, "peak_bytes": peak, "base_bytes": base,
                      "scratch_bytes": scratch}
        del svc, pairs

    def segment_sizes(self):
        """``ops.sbm_enumerate_kernel`` at the main path's shapes asked for
        segments of BIG_SEGMENT (above the delta-bitmask kernel's and pass
        C's limits, so run at ``card_segment``'s size) equals its output at
        ENUMERATE_BLOCK: the same pairs in the same order, the same count."""
        torch, ops = self.torch, self.ops
        subs, upds = self.main_live
        n, m = subs.size, upds.size
        k = int(ops.sbm_count_kernel(subs, upds))
        want, k_want = ops.sbm_enumerate_kernel(
            subs, upds, max_pairs=k, block_size=ops.ENUMERATE_BLOCK)
        got, k_got = ops.sbm_enumerate_kernel(subs, upds, max_pairs=k,
                                              block_size=BIG_SEGMENT)
        torch.cuda.synchronize()
        seg = ops.card_segment(BIG_SEGMENT, n, m)
        pass_c = self.K.emit_pairs_max_block(ops._num_words(n),
                                             ops._num_words(m))
        require(int(k_got) == int(k_want) == k and torch.equal(got, want),
                f"sbm_enumerate_kernel at block_size={BIG_SEGMENT} (run at "
                f"{seg}) != at {ops.ENUMERATE_BLOCK}")
        print(f"segment size: sbm_enumerate_kernel at block_size="
              f"{BIG_SEGMENT} (run at {seg}: the delta-bitmask kernel takes "
              f"{self.K.BITMASK_MAX_BLOCK}, pass C {pass_c}) == at "
              f"{ops.ENUMERATE_BLOCK}: K={k}, pairs in order",
              flush=True)

    def rebuild_profile(self, svc, want):
        """The main path's rebuild (cache dropped, ``pairs()``) five more
        times by the host clock, then once under ``torch.profiler``: device
        busy time, idle share, the top device kernels and host ops, and
        each sweep kernel's device time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        walls = []
        for _ in range(5):
            svc.invalidate_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = svc.pairs()
            walls.append((time.perf_counter() - t0) * 1e3)
            require(got == want, "rebuild: pairs() differs from the first")
        svc.invalidate_cache()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.pairs()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, dev, host = 0.0, [], []
        sweep = dict.fromkeys(SWEEP_KERNELS, 0.0)
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA:
                ms = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
                busy += ms
                dev.append((round(ms, 4), evt.count, evt.key[:50]))
                for name in sweep:
                    if name in evt.key:
                        sweep[name] += ms
            else:
                host.append((round(evt.self_cpu_time_total / 1e3, 3),
                             evt.count, evt.key[:50]))
        out = {"warm_wall_ms": [round(w, 3) for w in walls],
               "profiled_wall_ms": round(wall_ms, 3),
               "device_busy_ms": round(busy, 4),
               "device_idle_share": round(1.0 - busy / wall_ms, 4),
               "top_device": sorted(dev, reverse=True)[:5],
               "sweep_kernels_ms": {k: round(v, 4) for k, v in sweep.items()},
               "top_host_self": sorted(host, reverse=True)[:6]}
        self.phase_ms["rebuild warm (median of 5)"] = sorted(walls)[2]
        print("rebuild profile (main path, n=m=%d): %s" % (MAIN_N,
                                                          json.dumps(out)),
              flush=True)

    def time_ms(self, fn, reps: int, kernel: str = "") -> float:
        """Per-call time: the kernel's own device time from the profiler
        when it records one, else CUDA events around ``reps`` calls."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        if kernel:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            for evt in prof.key_averages():
                dev_us = getattr(evt, "device_time_total", 0.0)
                if kernel in evt.key and evt.count and dev_us > 0:
                    self.timing_source[kernel] = "profiler"
                    return dev_us / evt.count / 1e3
            self.timing_source[kernel] = "cuda events"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernels_at_main_shapes(self):
        from repro_torch.core import prefix

        torch, K, ref = self.torch, self.K, self.ref
        self.timing_source = {}
        subs, upds = self.main_live
        x = self.pass_inputs(subs, upds)
        tag = "main-path shapes"
        self.check_counting(x["deltas"], tag, self.ops.COUNT_BLOCK)
        self.check_counting(x["deltas4"], tag, self.ops.ENUMERATE_BLOCK)
        # pass B's other shapes: a segment shorter than a warp's span (36)
        # and the scalar path (2050, not a multiple of 4)
        for bs in PASS_B_EXTRA_BLOCKS:
            self.check_counting(self.stream(subs, upds, bs)[1], tag, bs)
        self.check_bitmasks(x, tag)
        self.check_scan(x, tag)
        plain_c_ms = self.check_pass_c(x, tag, "shared")
        require(int(K.emit_pairs.general_blocks) == 0, "pass C at the main "
                "path's shapes: a block took the general path")
        bsc, bse = self.ops.COUNT_BLOCK, self.ops.ENUMERATE_BLOCK
        d = x["deltas"]
        total, total4 = d.shape[1], x["ep4"].owner.shape[0]
        nbc, nbe = total // bsc, total4 // bse
        sums = K.block_sums(d, block_size=bsc)
        offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
        owner, up, vs = x["ep4"].owner, x["up"], x["vs"]
        c_args, cap = x["c_args"], x["cap"]
        blocked = d.view(4, nbc, bsc)
        # one library call computes pass A's sums, in (4, num_blocks) layout
        library = {"block_sums": lambda: torch.sum(blocked, dim=-1,
                                                    dtype=torch.int32)}
        rows = {
            "block_sums": (
                lambda: K.block_sums(d, block_size=bsc),
                lambda: ref.ref_block_sums(d, block_size=bsc),
                16 * total + 16 * nbc, "block_sums_kernel", 50),
            "emission": (
                lambda: K.emission(d, offsets, block_size=bsc),
                lambda: ref.ref_emission(d, offsets, block_size=bsc),
                16 * total + 16 * nbc + 4 * total + 8 * nbc,
                "emission_kernel", 50),
            "delta_bitmasks": (
                lambda: K.delta_bitmasks(owner, up, vs, num_words=x["ws"],
                                         block_size=bse),
                lambda: ref.ref_delta_bitmasks(owner, up, vs,
                                               num_words=x["ws"],
                                               block_size=bse),
                12 * total4 + 8 * nbe * x["ws"], "delta_bitmask_kernel", 20),
            "delta_scan": (
                lambda: K.delta_scan(*x["scan"][:2]),
                lambda: prefix.delta_scan_exclusive(*x["scan"][:2]),
                12 * nbe * x["ws"], "delta_scan_kernel", 20),
            "emit_pairs": (
                lambda: K.emit_pairs(*c_args, block_size=bse, cap=cap),
                None,
                16 * total4 + 4 * nbe * (x["ws"] + x["wu"]) + 8 * nbe * cap,
                "emit_pairs_kernel", 5),
        }
        for name, (kern, plain, nbytes, kname, reps) in rows.items():
            ms = self.time_ms(kern, reps, kname)
            plain_ms = plain_c_ms if plain is None else self.time_ms(plain,
                                                                     reps)
            self.rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": self.launches[name],
                "max_abs_err": self.err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": (self.time_ms(library[name], reps)
                               if name in library else None),
            }
        self.rows["delta_bitmasks_full_a"] = self.bitmask_full_row
        # pass C's wrapper by the host clock: allocation, placement query
        # and launch (nothing waits for the card), then one sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            K.emit_pairs(*c_args, block_size=bse, cap=cap)
        call_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        self.phase_ms["emit_pairs wrapper call (host clock)"] = call_ms
        print(f"kernel timing at {tag}: total={total} (count, block {bsc}), "
              f"{total4} (enumerate, block {bse}), cap={cap}, "
              f"sources {self.timing_source}; pass C's wrapper call "
              f"{call_ms:.4f} ms by the host clock (its kernel "
              f"{self.rows['emit_pairs']['ms']:.4f} ms)", flush=True)
        self.check_pass_c_any_records(x, "main-path shapes", "shared",
                                      with_stray=True)

    def scan_at_cell_shape(self):
        """The delta-scan kernel at ``ddm-paper.match-a100``'s shape (n = m
        = 5e5, alpha = 100): both extent types' words held against the
        plain loop, both launches timed (device time) beside the loop on the
        same card tensors and the byte bound (Add and Del read, active
        written, once); then one ``ops.sbm_enumerate_kernel`` match there
        must launch it twice and count K."""
        from repro_torch.core import prefix

        torch, K = self.torch, self.K
        n, alpha = SCAN_CELL
        tag = f"n=m={n} alpha={alpha:g}"
        subs, upds = self.workload(n, alpha, SEED + 7)
        x = self.pass_inputs(subs, upds)
        sa, sd, ua, ud = x["scan"]
        rows = sa.shape[0]
        require((rows, x["ws"], x["wu"]) == (489, 15_625, 15_625),
                f"delta scan at {tag}: ({rows}, {x['ws']}, {x['wu']}) words, "
                "not the cell's (489, 15625, 15625)")
        self.check_scan(x, tag)
        ms = sum(self.time_ms(lambda a=a, r=r: K.delta_scan(a, r), 20,
                              "delta_scan_kernel")
                 for a, r in ((sa, sd), (ua, ud)))
        call_ms = self.time_ms(lambda: (K.delta_scan(sa, sd),
                                        K.delta_scan(ua, ud)), 20)
        plain_ms = self.time_ms(lambda: (prefix.delta_scan_exclusive(sa, sd),
                                         prefix.delta_scan_exclusive(ua, ud)),
                                3)
        torch.cuda.synchronize()
        K.delta_scan.launches = 0
        _, count = self.ops.sbm_enumerate_kernel(
            subs, upds, max_pairs=self.round_up_pow2(x["k"]))
        torch.cuda.synchronize()
        launches = K.delta_scan.launches
        require(launches == 2 and int(count) == x["k"],
                f"delta scan at {tag}: {launches} launches in a match "
                f"(want 2), count {int(count)} != K {x['k']}")
        self.rows["delta_scan_ddm_cell"] = {
            "name": "delta_scan_ddm_cell", "route": "cuda",
            "source": SOURCES["delta_scan"], "replaces": REPLACES["delta_scan"],
            "launches": launches, "max_abs_err": self.err["delta_scan"],
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": 12 * rows * (x["ws"] + x["wu"]) / HBM_BYTES_PER_S
            * 1e3, "bound_by": "bytes", "library_ms": None,
        }
        row = self.rows["delta_scan_ddm_cell"]
        print(f"delta scan at {tag} ({rows} segments, {x['ws']} words a "
              f"side): == the plain loop (also Add and Del overlapping); both "
              f"sides {ms:.5f} ms device (source "
              f"{self.timing_source.get('delta_scan_kernel')}), whole calls "
              f"{call_ms:.5f} ms (events), the loop {plain_ms:.3f} ms, bound "
              f"{row['bound_ms']:.5f} ms; {launches} launches in a match, "
              f"K={x['k']}", flush=True)

    def pass_c_timed(self, x, tag):
        """Pass C's device time per launch on ``x``'s inputs, its mask
        placement and its blocks on the general path (with a list path:
        those that left it)."""
        K, bs = self.K, self.ops.ENUMERATE_BLOCK
        ms = self.time_ms(lambda: K.emit_pairs(*x["c_args"], block_size=bs,
                                               cap=x["cap"]),
                          5, "emit_pairs_kernel")
        self.torch.cuda.synchronize()
        row = {"ms": ms, "source": self.timing_source.get("emit_pairs_kernel"),
               "blocks": x["c_args"][0].shape[0] // bs,
               "placement": K.emit_pairs_placement(bs, x["ws"], x["wu"]),
               "general_blocks": int(K.emit_pairs.general_blocks),
               "cap": x["cap"], "k": x["k"],
               "bound_ms": (16 * x["c_args"][0].shape[0] + 8 * x["k"])
               / HBM_BYTES_PER_S * 1e3}
        self.pass_c_rows[tag] = row
        self.phase_ms[f"emit_pairs kernel device {tag}"] = ms
        print(f"pass C at {tag}: {ms:.4f} ms per launch (source "
              f"{row['source']}), bound {row['bound_ms']:.4f} ms, "
              f"{row['placement']} masks, blocks {row['blocks']}, general "
              f"path {row['general_blocks']}", flush=True)
        return row

    def pass_c_at_cell_shape(self):
        """Pass C at ``ddm-paper.match-a100``'s shape (n = m = 5e5, alpha =
        100, 489 segments of 15,625 words a side, masks in global memory):
        its device time; one ``ops.sbm_enumerate_kernel`` match there must
        count K and give ``core.sbm_enumerate``'s pair set."""
        from repro_torch.core import sbm_enumerate

        torch = self.torch
        n, alpha = SCAN_CELL
        tag = f"n=m={n} alpha={alpha:g}"
        subs, upds = self.workload(n, alpha, SEED + 7)
        x = self.pass_inputs(subs, upds)
        require((x["c_args"][4].shape[0], x["ws"], x["wu"])
                == (489, 15_625, 15_625), f"pass C at {tag}: not the cell's "
                "(489, 15625, 15625)")
        row = self.pass_c_timed(x, tag)
        require(row["general_blocks"] == 0, f"pass C at {tag}: blocks left "
                f"the fast path: {row}")
        max_pairs = self.round_up_pow2(x["k"])
        pairs, count = self.ops.sbm_enumerate_kernel(subs, upds,
                                                     max_pairs=max_pairs)
        plain, plain_count = sbm_enumerate(subs, upds, max_pairs=max_pairs)
        torch.cuda.synchronize()
        require(int(count) == int(plain_count) == x["k"],
                f"pass C at {tag}: count {int(count)} != K {x['k']}")
        require(torch.equal(self.pair_keys(pairs, n),
                            self.pair_keys(plain, n)),
                f"pass C at {tag}: pair set != sbm_enumerate pair set")
        print(f"pass C at {tag}: the engine's pair set == sbm_enumerate's "
              f"(K={x['k']})", flush=True)

    def check_pass_c_any_records(self, x, tag, placement, with_stray):
        """Pass C on records outside the contract of its fast path must
        equal its plain replay element for element, with its masks in
        ``placement`` memory, and its count of blocks that took the general
        path must be > 0: segment 0's entering subscription set gets the
        bit of its first subscription endpoint, a lower, which then finds
        it set; that lower again in place of the record after it; a lower
        of segment 0 whose upper lies in segment 0 dropped, so the upper
        finds its bit clear; with ``with_stray``, 16 stray bits in every
        entering set, and those with a cap that cuts."""
        import numpy as np

        torch, K, ref = self.torch, self.K, self.ref
        owner, up, is_sub, valid, sub0, upd0 = x["c_args"]
        bs, cap = self.ops.ENUMERATE_BLOCK, x["cap"]
        place = K.emit_pairs_placement(bs, x["ws"], x["wu"])
        require(place == placement, f"pass C off-contract, {tag}: masks in "
                f"{place} memory, expected {placement}")
        first = int(torch.nonzero((is_sub[:bs] != 0) & (valid[:bs] != 0))[0])
        require(int(up[first]) == 0, "pass C: segment 0's first "
                "subscription endpoint is not a lower")
        o = int(owner[first])
        bad = sub0.clone()
        bad[0, o // 32] ^= int(np.uint32(1 << (o % 32)).view(np.int32))
        twice = [t.clone() for t in (owner, up, is_sub, valid)]
        for t, val in zip(twice, (o, 0, 1, 1)):
            t[first + 1] = val
        # the first subscription lower of segment 0 whose upper follows in
        # segment 0, made padding
        rec = [t[:bs].cpu().numpy() for t in (owner, up, is_sub, valid)]
        live = (rec[2] != 0) & (rec[3] != 0)
        closed = set(rec[0][live & (rec[1] != 0)].tolist())
        lows = np.flatnonzero(live & (rec[1] == 0)
                              & np.isin(rec[0], list(closed)))
        require(lows.size > 0, "pass C: no subscription opens and closes in "
                "segment 0")
        dropped = valid.clone()
        dropped[int(lows[0])] = 0
        rng = np.random.default_rng(SEED + 19)

        def stray(words, per_row=16):
            # a few stray members per entering set: the plain replay sorts
            # each set at every emission, so dense ones would take hours
            nb, w = words.shape
            ids = rng.integers(0, 32 * w, (nb, per_row))
            bits = np.zeros((nb, w), np.uint32)
            np.bitwise_or.at(bits, (np.arange(nb)[:, None], ids // 32),
                             np.uint32(1) << (ids % 32).astype(np.uint32))
            return words | torch.from_numpy(bits.view(np.int32)).to(self.dev)

        records = (owner, up, is_sub, valid)
        streams = {"entering bit set": ((*records, bad, upd0), cap),
                   "lower twice": ((*twice, sub0, upd0), cap),
                   "upper bit clear": ((owner, up, is_sub, dropped, sub0,
                                        upd0), cap)}
        if with_stray:
            streams["stray bits"] = ((*records, stray(sub0), stray(upd0)),
                                     cap)
            streams["stray bits, cap / 3"] = (streams["stray bits"][0],
                                              max(cap // 3, 1))
        general = {}
        for what, (args, c) in streams.items():
            got = K.emit_pairs(*args, block_size=bs, cap=c)
            want = ref.ref_emit_pairs(*args, block_size=bs, cap=c)
            torch.cuda.synchronize()
            self.same("emit_pairs", got, want, f"pass C {tag}, {what}")
            general[what] = int(K.emit_pairs.general_blocks)
            require(general[what] > 0, f"pass C {tag}, {what}: no block took "
                    "the general path")
        print(f"pass C at {tag} on records outside its fast path's contract "
              f"== replay ({place} masks); blocks that took the general path "
              f"(of {owner.shape[0] // bs}): {general}", flush=True)

    # -- the d-dim slice: bit-matrix AND and the d > 1 service ------------
    def bitmatch_battery(self):
        """Kernel == plain == numpy brute force on small and edge shapes."""
        import numpy as np
        from repro_torch.core import Extents, brute_force_pairs_numpy, ddim

        torch = self.torch
        rng = np.random.default_rng(SEED + 4)
        cases = []
        for d, n, m in BITMATCH_SHAPES:
            arrs = []
            for size in (n, m):
                lo = rng.uniform(0, 40, (d, size)).astype(np.float32)
                arrs += [lo, lo + rng.uniform(0, 20, (d, size))
                         .astype(np.float32)]
            cases.append((f"d={d} n={n} m={m}", arrs, None))
        inf = np.float32(np.inf)
        u = np.arange(10, dtype=np.float32).reshape(2, 5)
        cases.append(("unbounded [-inf, inf]^2 vs m=5",
                      [np.full((2, 1), -inf, np.float32),
                       np.full((2, 1), inf, np.float32), u, u + 1], 5))
        for d, n, m in BITMATCH_EDGES:
            arrs = []
            for size in (n, m):
                lo = rng.integers(-4, 5, (d, size)).astype(np.float32)
                hi = lo + rng.integers(0, 4, (d, size)).astype(np.float32)
                lo[(lo == 0) & (rng.random(lo.shape) < 0.5)] = np.float32(-0.0)
                lo[rng.random(lo.shape) < 0.1] = -inf
                hi[rng.random(hi.shape) < 0.1] = inf
                arrs += [lo, hi]
            cases.append((f"edge d={d} n={n} m={m} (ties, -0.0, inf)", arrs,
                          None))
        none, some = np.zeros((2, 0), np.float32), np.ones((2, 3), np.float32)
        cases.append(("empty subs", [none, none, some, some + 1], 0))
        cases.append(("empty upds", [some, some + 1, none, none], 0))
        for what, arrs, k_want in cases:
            s_lo, s_hi, u_lo, u_hi = (torch.from_numpy(a).to(self.dev)
                                      for a in arrs)
            got = self.B.bitmatch(s_lo, s_hi, u_lo, u_hi)
            self.same("bitmatch", got, self.ref.ref_bitmatrix(s_lo, s_hi, u_lo,
                                                              u_hi),
                      f"bitmatch {what}")
            truth = brute_force_pairs_numpy(Extents(s_lo, s_hi),
                                            Extents(u_lo, u_hi))
            pairs, count = ddim.pairs_from_bitmatrix(
                got[0], m=u_lo.shape[1], max_pairs=max(len(truth), 1),
                count=got[1].sum(dtype=torch.int64))
            require(self.pair_set(pairs) == truth and int(count) == len(truth)
                    and (k_want is None or k_want == len(truth)),
                    f"bitmatch {what}: {int(count)} pairs, brute force "
                    f"{len(truth)}")
        print(f"bitmatch battery: {len(cases)} cases, kernel == plain == "
              f"brute force", flush=True)

    def bitmatch_full(self, cell: str, n: int, d: int, alpha: float):
        """Cell (a) or (b): kernel == plain over row blocks; K == the
        selective sweep's count; in (a) the pair sets and the bitmatrix
        path's launches."""
        from repro_torch.core import ddim, make_tall_thin_workload

        torch, B = self.torch, self.B
        tag = f"bitmatch ({cell}) n=m={n} d={d} alpha={alpha:g}"
        g = torch.Generator().manual_seed(SEED + 5)
        subs, upds = make_tall_thin_workload(n, n, alpha, length=LENGTH, d=d,
                                             wide_dim=0, generator=g,
                                             device=self.dev)
        torch.cuda.synchronize()
        words, counts, k = self.timed(f"{tag} kernel (cold)",
                                      lambda: B.bitmatrix_kernel(subs, upds))
        want = self.timed(f"{tag} plain",
                          lambda: self.ref.ref_bitmatrix(*self.dim_rows(subs),
                                                         *self.dim_rows(upds)))
        self.same("bitmatch", (words, counts), want, tag)
        k = int(k)
        sweep_pairs, count, stats = self.timed(
            f"{tag} selective sweep (plain engine)",
            lambda: ddim.enumerate_matches_ddim_planned(subs, upds,
                                                        method="sweep"))
        require(int(count) == k, f"{tag}: K {k} != selective sweep "
                f"{int(count)}")
        line = (f"{tag}: K={k} == selective sweep ({stats.regime}); "
                f"words {tuple(words.shape)} == plain")
        # warm times: the kernel's device time, the selective sweep's
        # (CUDA events, plain engine) — launches outside any counted run
        self.phase_ms[f"{tag} kernel device"] = self.time_ms(
            lambda: B.bitmatrix_kernel(subs, upds), 5, "bitmatch_kernel")
        self.phase_ms[f"{tag} selective sweep warm"] = self.time_ms(
            lambda: ddim.enumerate_matches_ddim_planned(subs, upds,
                                                        method="sweep"), 3)
        if cell == "a":
            pairs, bcount = B.sbm_bitmatrix_kernel(subs, upds,
                                                   max_pairs=stats.capacity)
            require(int(bcount) == k and torch.equal(
                self.pair_keys(pairs, n), self.pair_keys(sweep_pairs, n)),
                f"{tag}: kernel engine pair set != the selective sweep's")
            B.bitmatch.launches = 0
            torch.cuda.synchronize()
            _, c2, st = self.timed(
                f"{tag} bitmatrix planned",
                lambda: ddim.enumerate_matches_ddim_planned(
                    subs, upds, method="bitmatrix"))
            self.launches["bitmatch"] = B.bitmatch.launches
            require(B.bitmatch.launches > 0 and int(c2) == k
                    and st.regime == "bitmatrix" and st.retries == 0,
                    f"{tag}: bitmatrix path launches "
                    f"{B.bitmatch.launches}, K {int(c2)}, {st.regime}")
            self.bitmatch_inputs = (*self.dim_rows(subs), *self.dim_rows(upds))
            line += (f"; pair set == selective sweep's; bitmatrix path "
                     f"launches {B.bitmatch.launches}")
        print(line, flush=True)

    def ddim_service(self):
        """The d-dim service path at n = m = DDIM_N tall-thin (α = 1)."""
        import numpy as np
        from repro_torch.core import make_tall_thin_workload

        g = self.torch.Generator().manual_seed(SEED + 6)
        subs, upds = make_tall_thin_workload(DDIM_N, DDIM_N, 1.0,
                                             length=LENGTH, d=2, wide_dim=0,
                                             generator=g, device="cpu")
        rng = np.random.default_rng(SEED + 7)
        seg_len = 1.0 * LENGTH / (2 * DDIM_N)

        def move_bounds(b):     # wide in dim 0, thin in dim 1
            wide = rng.uniform(0.0, 0.02 * LENGTH, size=b).astype(np.float32)
            thin = rng.uniform(0.0, LENGTH - seg_len, size=b).astype(np.float32)
            return (np.stack([wide, thin], axis=1),
                    np.stack([wide + np.float32(0.98 * LENGTH),
                              thin + np.float32(seg_len)], axis=1))

        _, rebuilt, regimes, self.ddim_launches = self.drive_service(
            "ddim ", 2, subs, upds, move_bounds, rng)
        require(regimes.get("sweep_dim1", 0) > 0,
                f"ddim: the rebuild did not generate on dim 1: {regimes}")
        print(f"d-dim service path: d=2 n=m={DDIM_N} tall-thin, "
              f"K={len(rebuilt)}, churn {[b for _, b in CHURN]} deltas == cpu "
              f"twin, pairs == rebuild, regimes {regimes}, launches "
              f"{self.ddim_launches}", flush=True)

    def bitmatch_timing(self):
        """The bit-matrix kernel at cell (a): device time, plain time, bound."""
        args = self.bitmatch_inputs                 # s_lo, s_hi, u_lo, u_hi
        self.same("bitmatch", self.B.bitmatch(*args),
                  self.ref.ref_bitmatrix(*args), "bitmatch at cell (a)")
        d, n = args[0].shape
        m = args[2].shape[1]
        num_words = -(-m // 32)
        nbytes = 4 * n * num_words + 4 * n + 8 * d * (n + m)
        ops = 2 * d * n * m
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        self.rows["bitmatch"] = {
            "name": "bitmatch", "route": "cuda", "source": SOURCES["bitmatch"],
            "replaces": REPLACES["bitmatch"],
            "launches": self.launches["bitmatch"],
            "max_abs_err": self.err["bitmatch"],
            "ms": self.time_ms(lambda: self.B.bitmatch(*args), 20,
                               "bitmatch_kernel"),
            "plain_ms": self.time_ms(lambda: self.ref.ref_bitmatrix(*args), 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        }
        print(f"bitmatch timing at cell (a): d={d} n={n} m={m}, {nbytes} "
              f"bytes ({bytes_ms:.4f} ms at HBM rate), {ops} compares "
              f"({ops_ms:.4f} ms at {FP32_OPS_PER_S:.3g}/s), source "
              f"{self.timing_source.get('bitmatch_kernel')}", flush=True)
        # the run-time-d kernel (d >= 5) on the same cell: its dimensions
        # repeated up to d = 5 and 8 select the same pairs, so the words
        # must be the plain d = 2 words
        for dr in (5, 8):
            wide = [x.repeat(-(-dr // d), 1)[:dr].contiguous() for x in args]
            self.same("bitmatch", self.B.bitmatch(*wide),
                      self.ref.ref_bitmatrix(*args),
                      f"bitmatch d={dr} at cell (a)")
            ms_r = self.time_ms(lambda: self.B.bitmatch(*wide), 20,
                                "bitmatch_kernel_rt")
            ops_r = 2 * dr * n * m / FP32_OPS_PER_S * 1e3
            bytes_r = (nbytes + 8 * (dr - d) * (n + m)) / HBM_BYTES_PER_S * 1e3
            self.phase_ms[f"bitmatch d={dr} (run-time d) at cell (a) "
                          f"device"] = ms_r
            print(f"bitmatch d={dr} (run-time d) at cell (a)'s n, m: == "
                  f"plain; {ms_r:.4f} ms, bound {max(ops_r, bytes_r):.4f} ms "
                  f"({'operations' if ops_r >= bytes_r else 'bytes'}), "
                  f"source {self.timing_source.get('bitmatch_kernel_rt')}",
                  flush=True)

    # -- the model stack's serving path: block-sparse flash attention -----
    def flash_inputs(self, B, H, Hkv, Sq, Skv, D, dtype, gen, q_gain=None):
        """randn q, k, v; scores of std 1/sqrt(D) (near-uniform softmax)
        unless ``q_gain``, which gives scores of std ``q_gain``."""
        torch = self.torch
        q = torch.randn((B, H, Sq, D), generator=gen)
        k = torch.randn((B, Hkv, Skv, D), generator=gen)
        v = torch.randn((B, Hkv, Skv, D), generator=gen)
        if q_gain is None:
            q, k = q / D ** 0.25, k / D ** 0.25
        else:
            q = q * q_gain
        return tuple(x.to(self.dev, dtype) for x in (q, k, v))

    def flash_check(self, what, q, k, v, seg, block, window=None,
                    softcap=None, num_global_blocks=0, tols=None,
                    causal=True):
        """Kernel against the plain replay of the same schedule and, on the
        same inputs, the dense oracle, within every (atol, rtol) of ``tols``
        (by default FLASH_TOL of q's dtype); returns (the kernel's output,
        its max |kernel - plain|)."""
        torch = self.torch
        sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
        qseg = None if seg is None else seg[:, skv - sq:].contiguous()
        idx, cnt, _ = self.ops.build_block_structure(
            sq, skv, block_q=block, block_k=block, causal=causal,
            window=window, num_global_blocks=num_global_blocks)
        # the schedule stays on the host: the wrapper checks and uploads it
        args = (q, k, v, torch.from_numpy(idx), torch.from_numpy(cnt), qseg,
                seg)
        kw = dict(scale=d ** -0.5, causal=causal, window=window,
                  softcap=softcap, block_q=block, block_k=block,
                  q_offset=skv - sq)
        got = self.flash(*args, **kw)
        want = self.ref.ref_flash_attention(*args, **kw)
        dense = self.ref.ref_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_segments=qseg,
                                       kv_segments=seg)
        torch.cuda.synchronize()
        tols = tols or (FLASH_TOL[str(q.dtype).split(".")[-1]],)
        require(got.shape == q.shape and got.dtype == q.dtype,
                f"flash {what}: output {got.shape}/{got.dtype}")
        require(bool(torch.isfinite(got).all()), f"flash {what}: not finite")
        errs = []
        for name, ref_out in (("plain", want), ("dense oracle", dense)):
            diff = (got.float() - ref_out.float()).abs()
            errs.append(float(diff.max()))
            for atol, rtol in tols:
                require(bool((diff <= atol + rtol * ref_out.float().abs())
                             .all()),
                        f"flash {what}: kernel != {name} (max |diff| "
                        f"{errs[-1]}, tolerance {atol:.4g} + {rtol:.4g} |ref|)")
        self.err["flash_attention"] = max(self.err["flash_attention"], errs[0])
        return got, errs[0]

    def flash_battery(self):
        torch = self.torch
        gen = torch.Generator().manual_seed(SEED + 8)
        worst, noncausal, routes = {}, {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            for B, H, Hkv, Sq, Skv, D, blk, feats in FLASH_CASES:
                q, k, v = self.flash_inputs(
                    B, H, Hkv, Sq, Skv, D, dtype, gen,
                    q_gain=FLASH_FULL_Q_GAIN if bf16 else None)
                seg = None
                if feats.get("segments"):
                    seg = torch.sort(torch.randint(0, 3, (B, Skv),
                                                   generator=gen), dim=1) \
                        .values.to(torch.int32).to(self.dev)
                key = str(dtype)[6:]
                route = self.flash_route(D, dtype)[0]
                what = (f"{key} B={B} H={H}/{Hkv} Sq={Sq} Skv={Skv} D={D} "
                        f"block={blk} {feats} ({route})")
                tols = (FLASH_TOL[key],) + ((flash_full_tol(v),) if bf16
                                            else ())
                before = self.flash.launches
                _, err = self.flash_check(
                    what, q, k, v, seg, blk, window=feats.get("window"),
                    softcap=feats.get("softcap"),
                    num_global_blocks=feats.get("num_global_blocks", 0),
                    tols=tols, causal=feats.get("causal", True))
                require(self.flash.launches == before + 1,
                        f"flash {what}: {self.flash.launches - before} "
                        f"launches, not 1")
                routes[route] = routes.get(route, 0) + 1
                worst[key] = max(worst.get(key, 0.0), err)
                if not feats.get("causal", True):
                    noncausal[key] = max(noncausal.get(key, 0.0), err)
        print(f"flash battery: {len(FLASH_CASES)} cases x 2 dtypes, kernel "
              f"== plain == dense oracle (bf16: scores of std "
              f"{FLASH_FULL_Q_GAIN}, also within flash_full_tol), one "
              f"launch each, cases by route {routes}; max "
              f"|kernel - plain| {worst}, of the "
              f"{sum(not f.get('causal', True) for *_, f in FLASH_CASES)} "
              f"non-causal cases {noncausal}", flush=True)

    def flash_row(self, tag, B, H, Hkv, S, D, blk, seed, window=None,
                  softcap=None, whole_call=False, dtype=None, causal=True,
                  skv=None):
        """One full-width shape (bf16 unless ``dtype``, scores of std
        FLASH_FULL_Q_GAIN; Sq = S, Skv = ``skv`` or S; causal unless
        ``causal`` is False, then without a window): kernel == plain and
        dense oracle within ``flash_full_tol`` (float32: FLASH_TOL), then
        the kernel's device time, the plain time and the bound over the
        live (q, k) pairs at the dtype's rate (bf16 tensor cores, float32
        CUDA cores).  With ``whole_call`` the row's time is the whole
        wrapper call by CUDA events (a padded width's copies in and out
        included), the flash kernel's own device time printed beside it.
        Returns (row, (q, k, v), |kernel - plain|, the kernel's output)."""
        torch = self.torch
        dtype = dtype or torch.bfloat16
        bf16 = dtype == torch.bfloat16
        skv = skv or S
        gen = torch.Generator().manual_seed(seed)
        q, k, v = self.flash_inputs(B, H, Hkv, S, skv, D, dtype, gen,
                                    q_gain=FLASH_FULL_Q_GAIN)
        tol = flash_full_tol(v) if bf16 else FLASH_TOL["float32"]
        got, err = self.flash_check(f"full width {tag}", q, k, v, None, blk,
                                    window=window, softcap=softcap,
                                    tols=(tol,), causal=causal)
        idx, cnt, _ = self.ops.build_block_structure(
            S, skv, block_q=blk, block_k=blk, causal=causal, window=window)
        args = (q, k, v, torch.from_numpy(idx), torch.from_numpy(cnt))
        kw = dict(scale=D ** -0.5, causal=causal, window=window,
                  softcap=softcap, block_q=blk, block_k=blk,
                  q_offset=skv - S)
        pairs = live_pairs(idx, cnt, blk, S, skv, window, causal)
        if causal:
            w = S if window is None else min(window, S)
            want = w * (w + 1) // 2 + (S - w) * w  # sum_i min(i + 1, w)
        else:
            require(window is None, f"flash {tag}: a non-causal row has no "
                    "window")
            want = S * skv
        require(pairs == want, f"flash {tag}: {pairs} live pairs, the token "
                f"mask leaves {want}")
        ops = 4 * D * pairs * B * H
        nbytes = q.element_size() * (2 * q.numel() + 2 * B * Hkv * skv * D) \
            + 4 * (idx.size + cnt.size)
        ops_ms = ops / (BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S) * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        kernel_ms = self.time_ms(lambda: self.flash(*args, **kw), 20,
                                 "flash_attention_fwd")
        source = self.timing_source.get("flash_attention_fwd")
        if whole_call:
            call_ms = self.time_ms(lambda: self.flash(*args, **kw), 20)
            source = (f"cuda events over the wrapper call; the kernel alone "
                      f"{kernel_ms:.4f} ms ({source})")
        row = {
            "name": "flash_attention", "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"],
            "launches": None, "max_abs_err": None,
            "ms": call_ms if whole_call else kernel_ms,
            "plain_ms": self.time_ms(
                lambda: self.ref.ref_flash_attention(*args, **kw), 3),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        }
        print(f"flash at full width ({tag}, scores of std "
              f"{FLASH_FULL_Q_GAIN}): kernel == plain == dense oracle within "
              f"{tol[0]:.4g} + {tol[1]:.4g} |ref|, max |kernel - plain| "
              f"{err:.4g}; {pairs} live (q, k) pairs per (b, h), {ops} flop "
              f"({ops / BF16_OPS_PER_S * 1e3:.4f} ms at bf16 tensor-core "
              f"rate, {ops / FP32_OPS_PER_S * 1e3:.4f} ms at the float32 "
              f"rate; bound at the {'bf16' if bf16 else 'float32'} rate), "
              f"{nbytes} bytes ({bytes_ms:.4f} ms); "
              f"{'wrapper call' if whole_call else 'kernel'} {row['ms']:.4f} "
              f"ms ({ops / row['ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{row['plain_ms']:.3f} ms; source {source}", flush=True)
        return row, (q, k, v), err, got

    def flash_full(self):
        """The flash kernel at smollm-360m's and gemma2-2b's prefill shapes:
        parity, device time, plain time, bound, and the library yardstick
        where one PyTorch call computes the same function."""
        from repro_torch.configs import get_config

        torch = self.torch
        F = torch.nn.functional
        cfg = get_config(SERVE["arch"])
        B, S = SERVE["slots"], SERVE["prompt_len"]
        D = cfg.head_dim
        row, (q, k, v), err, got = self.flash_row(
            f"{cfg.name}: B={B} H={cfg.num_heads}/{cfg.num_kv_heads} S={S} "
            f"D={D} bf16 block {cfg.attn_block_q}", B, cfg.num_heads,
            cfg.num_kv_heads, S, D, cfg.attn_block_q, SEED + 9)
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 enable_gqa=True)
        lib_err = float((lib_out.float() - got.float()).abs().max())
        require(lib_err <= 5e-2, f"flash full width: kernel vs "
                f"scaled_dot_product_attention max |diff| {lib_err}")
        row["library_ms"] = self.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True), 20)
        self.rows["flash_attention"] = row
        print(f"  sdpa (is_causal, enable_gqa; the same function): "
              f"{row['library_ms']:.4f} ms, max |kernel - sdpa| "
              f"{lib_err:.4g}", flush=True)
        del q, k, v, got, lib_out
        self.flash_via_ops("flash_attention_d96", PHI3_FLASH,
                           "phi-3-vision widths", SEED + 18, "wgmma", True)
        self.flash_via_ops("flash_attention_d512", WIDE_FLASH,
                           "wide head", SEED + 20, "wide", False)
        self.flash_via_ops("flash_attention_d512_f32", WIDE_FLASH,
                           "wide head, float32", SEED + 21, "runtime", False,
                           torch.float32)
        self.flash_via_ops("flash_attention_d64_f32", F32_FLASH,
                           "smollm-360m prefill, float32", SEED + 22,
                           "runtime", False, torch.float32)
        self.flash_via_ops("flash_attention_granite", GRANITE_FLASH,
                           "granite-moe-3b-a800m prefill", SEED + 23,
                           "instance", False)
        self.rows["flash_attention_granite"]["name"] = \
            "flash_attention (D=64, granite-moe-3b-a800m prefill)"
        # softcapped attention is one flex_attention call (a tanh score_mod
        # and a causal or sliding-window block mask), compiled by inductor
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        gcfg = get_config(SERVE_GEMMA["arch"])
        B, S, D = SERVE_GEMMA["slots"], SERVE_GEMMA["prompt_len"], \
            gcfg.head_dim
        H, Hkv, blk = gcfg.num_heads, gcfg.num_kv_heads, gcfg.attn_block_q
        cap = gcfg.attn_softcap
        flex = torch.compile(flex_attention, dynamic=False)

        def softcap(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        self.gemma_rows = {}
        for layer, window, seed in (("global", None, SEED + 15),
                                    ("local", gcfg.window, SEED + 16)):
            row, (q, k, v), err, got = self.flash_row(
                f"{gcfg.name} {layer} layer: B={B} H={H}/{Hkv} S={S} D={D} "
                f"bf16 block {blk} window {window} softcap {cap}", B, H, Hkv,
                S, D, blk, seed, window=window, softcap=cap)
            mask = create_block_mask(_live_mask(window), None, None, S, S,
                                     device=self.dev)

            def library(q=q, k=k, v=v, mask=mask):
                return flex(q, k, v, score_mod=softcap, block_mask=mask,
                            scale=D ** -0.5, enable_gqa=True)

            lib_err = float((library().float() - got.float()).abs().max())
            require(lib_err <= 5e-2, f"flash {gcfg.name} {layer}: kernel vs "
                    f"flex_attention max |diff| {lib_err}")
            row["library_ms"] = self.time_ms(library, 20)
            self.gemma_rows[layer] = dict(row, layer=layer, max_abs_err=err)
            print(f"  flex_attention (compiled; tanh softcap score_mod, "
                  f"{layer} block mask, enable_gqa; the same function): "
                  f"{row['library_ms']:.4f} ms, max |kernel - flex| "
                  f"{lib_err:.4g}", flush=True)
            del q, k, v, got, mask, library

    def flash_via_ops(self, key: str, c: dict, label: str, seed: int,
                      route: str, whole_call: bool, dtype=None):
        """A flash row at widths no config's path runs (``c``): kernel ==
        plain (``flash_row``), the wrapper's ``route`` for the width, one
        counted launch through the public ``ops.flash_attention``, SDPA on
        the same tensors beside it.  Rows 6c (D = 96 on the wgmma + TMA
        kernel, timed over the whole wrapper call as SDPA is over its own,
        and in turns beside the padded route it replaced:
        ``padded_route_turns``), 6d
        (D = 512, the wide bf16 kernel), 6e (D = 512 in float32, the
        float32 kernel, beside SDPA with TF32 off) and 6f (smollm-360m's
        prefill shapes in float32)."""
        torch = self.torch
        F = torch.nn.functional
        dtype = dtype or torch.bfloat16
        bf16 = dtype == torch.bfloat16
        B, H, Hkv, S, D, blk = (c[k] for k in ("B", "H", "Hkv", "S", "D",
                                               "block"))
        got_route = self.flash_route(D, dtype)[0]
        require(got_route == route,
                f"flash D={D} {dtype}: routed {got_route}, not {route}")
        kind = str(dtype).split(".")[-1]
        row, (q, k, v), err, got = self.flash_row(
            f"{label}: B={B} H={H}/{Hkv} S={S} D={D} ({route}) {kind} block "
            f"{blk}", B, H, Hkv, S, D, blk, seed, whole_call=whole_call,
            dtype=dtype)
        self.flash.launches = 0
        out = self.ops.flash_attention(q, k, v, causal=True, block_q=blk,
                                       block_k=blk)
        torch.cuda.synchronize()
        require(self.flash.launches == 1 and out.shape == q.shape
                and torch.equal(out, got),
                f"flash D={D} {kind}: ops.flash_attention launched "
                f"{self.flash.launches} times or differs from the kernel")
        # the float32 yardstick in float32: TF32 off for its products
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gqa = H != Hkv
        lib_out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 enable_gqa=gqa)
        lib_err = float((lib_out.float() - got.float()).abs().max())
        require(lib_err <= 5e-2, f"flash D={D} {kind}: kernel vs "
                f"scaled_dot_product_attention max |diff| {lib_err}")
        lib_ms = self.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=gqa), 20)
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        row.update(name=f"flash_attention (D={D}, {route}"
                        f"{'' if bf16 else ', float32'})",
                   launches=self.flash.launches, max_abs_err=err,
                   library_ms=lib_ms)
        if route == "wgmma":
            row["source"] = SOURCES["flash_attention_wgmma"]
            row.update(self.padded_route_turns(q, k, v, blk, got))
        self.rows[key] = row
        print(f"  sdpa (is_causal{'' if bf16 else ', TF32 off'}; the same "
              f"function): {row['library_ms']:.4f} ms, max |kernel - sdpa| "
              f"{lib_err:.4g}; ops.flash_attention launches 1; {card_line()}",
              flush=True)

    def padded_route_turns(self, q, k, v, blk: int, got) -> dict:
        """Row 6c's width on the route that served it before the wgmma
        kernel: q, k, v zero-padded to 128 (``_pad_head_dim``), the D = 128
        instance with the scale of the true width, the output sliced back,
        as one wrapper-level call.  Its output against the wgmma kernel's
        within ``flash_full_tol`` (both are held to the plain version
        already); the two whole calls timed by CUDA events in turns (new,
        padded, padded, new), and the padded call's kernel alone."""
        from repro_torch.kernels.flash_attention import _pad_head_dim

        torch = self.torch
        S, D = q.shape[2], q.shape[3]
        idx, cnt, _ = self.ops.build_block_structure(S, S, block_q=blk,
                                                     block_k=blk)
        sched = (torch.from_numpy(idx), torch.from_numpy(cnt))
        kw = dict(scale=D ** -0.5, causal=True, block_q=blk, block_k=blk)

        def new():
            return self.flash(q, k, v, *sched, **kw)

        def padded():
            pq, pk, pv = _pad_head_dim(q, k, v, 128)
            return self.flash(pq, pk, pv, *sched, **kw)[..., :D].contiguous()

        out = padded()
        torch.cuda.synchronize()
        atol, rtol = flash_full_tol(v)
        diff = (out.float() - got.float()).abs()
        require(bool((diff <= atol + rtol * got.float().abs()).all()),
                f"flash D={D}: the padded route differs from the wgmma "
                f"kernel by {float(diff.max())}")
        turns = [(name, self.time_ms(fn, 20)) for name, fn in
                 (("wgmma", new), ("padded", padded), ("padded", padded),
                  ("wgmma", new))]
        pq, pk, pv = _pad_head_dim(q, k, v, 128)
        kernel_ms = self.time_ms(lambda: self.flash(pq, pk, pv, *sched, **kw),
                                 20, "flash_attention_fwd_bf16_kernel")
        res = {"turns_ms": turns, "padded_ms": [t for n, t in turns
                                                if n == "padded"],
               "padded_kernel_ms": kernel_ms}
        print(f"  in turns, whole wrapper calls (CUDA events): "
              + ", ".join(f"{n} {t:.4f}" for n, t in turns)
              + f" ms; the padded route's D = 128 kernel alone "
              f"{kernel_ms:.4f} ms ({self.timing_source.get('flash_attention_fwd_bf16_kernel')}); "
              f"max |padded - wgmma| {float(diff.max()):.4g}", flush=True)
        return res

    def serve_path(self, spec: dict, seed: int):
        """One ``ServeEngine`` run of ``spec`` at full width and depth;
        every wrapper's launch count zeroed just before and read just
        after, the flash kernel's must be layers x waves.  Returns (model,
        params, the unwrapped (prefill, decode_step), numbers, launches)."""
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.models import Model
        from repro_torch.serve.engine import Request, ServeEngine

        torch = self.torch
        cfg = get_config(spec["arch"])
        model = Model(cfg, device=DEVICE)
        params = self.timed(f"{cfg.name} init weights", lambda: model.init(
            torch.Generator(DEVICE).manual_seed(seed)))
        prefill_ms, decode_ms, finite = [], [], []
        vocab = cfg.vocab_size

        def timed_call(fn, log):
            def call(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cache, logits = fn(*args)
                finite.append(bool(torch.isfinite(logits[..., :vocab]).all()))
                log.append((time.perf_counter() - t0) * 1e3)
                return cache, logits
            return call

        plain_steps = (model.prefill, model.decode_step)
        model.prefill = timed_call(model.prefill, prefill_ms)
        model.decode_step = timed_call(model.decode_step, decode_ms)
        eng = ServeEngine(model, params, num_slots=spec["slots"],
                          max_len=spec["max_len"], device=DEVICE)
        rng = np.random.default_rng(seed + 1)
        for rid in range(spec["requests"]):
            eng.submit(Request(rid, rng.integers(
                1, vocab, spec["prompt_len"]).tolist(), spec["max_new"]))
        for w in self.wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in self.wrappers}
        waves = -(-spec["requests"] // spec["slots"])
        attn = attention_layers(cfg)
        want = attn * waves
        require(self.flash.launches == want,
                f"serve {cfg.name}: flash kernel launched "
                f"{self.flash.launches} times, expected {attn} attention "
                f"layers x {waves} waves = {want}")
        require(sorted(results) == list(range(spec["requests"])),
                f"serve {cfg.name}: results for {sorted(results)}")
        for rid, res in results.items():
            require(len(res.tokens) == spec["max_new"]
                    and all(0 <= t < vocab for t in res.tokens),
                    f"serve {cfg.name}: request {rid} returned {res.tokens}")
        require(all(finite), f"serve {cfg.name}: non-finite logits")
        tokens = sum(len(r.tokens) for r in results.values())
        steps = decode_ms[1:] if len(decode_ms) > 1 else decode_ms
        numbers = {
            "prefill_ms_per_wave": prefill_ms,
            "decode_ms_per_step_mean": sum(steps) / len(steps),
            "decode_steps": len(decode_ms),
            "tokens_per_s": tokens / wall, "wall_s": wall,
            "new_tokens": tokens,
        }
        self.phase_ms[f"serve {cfg.name} (engine run)"] = wall * 1e3
        print(f"serve: {cfg.name} full width ({cfg.param_count()} params, "
              f"{cfg.active_param_count()} active, {cfg.num_layers} layers, "
              f"{attn} with attention), {spec['requests']} requests x "
              f"{spec['prompt_len']}-token prompts, {waves} waves of "
              f"{spec['slots']}: {tokens} tokens, all < vocab, logits "
              f"finite; flash launches {self.flash.launches}; "
              + json.dumps(numbers), flush=True)
        print(f"  first tokens: {results[0].tokens[:8]}", flush=True)
        return model, params, plain_steps, numbers, launches

    def serve(self):
        """smollm-360m at full width through ServeEngine (the model slice's
        main path), then one profiled wave."""
        model, params, steps, self.serve_numbers, self.serve_launches = \
            self.serve_path(SERVE, SEED + 10)
        self.rows["flash_attention"]["launches"] = self.flash.launches
        self.serve_profile(model, params, *steps, SERVE, self.serve_numbers)

    def serve_gemma(self):
        """gemma2-2b at full width through ServeEngine: head width 256,
        local and global layers, softcap 50.  The wrapper's launches are
        also counted per layer kind (by the window it is called with) at
        the call site in ``kernels.ops``."""
        from repro_torch.configs import get_config

        ops, wrapper = self.ops, self.flash
        by_window = {}

        def counted(*args, window=None, **kw):
            before = wrapper.launches
            out = wrapper(*args, window=window, **kw)
            by_window[window] = by_window.get(window, 0) \
                + wrapper.launches - before
            return out

        self.torch.cuda.empty_cache()
        ops.flash_attention_kernel = counted
        try:
            _, _, _, self.gemma_numbers, self.gemma_launches = \
                self.serve_path(SERVE_GEMMA, SEED + 17)
        finally:
            ops.flash_attention_kernel = wrapper
        window = get_config(SERVE_GEMMA["arch"]).window
        for layer, key in (("global", None), ("local", window)):
            self.gemma_rows[layer]["launches"] = by_window.get(key, 0)
        require(sorted(by_window, key=str) == sorted((None, window), key=str)
                and all(by_window.values())
                and sum(by_window.values()) == wrapper.launches,
                f"serve {SERVE_GEMMA['arch']}: flash launches by window "
                f"{by_window}, {wrapper.launches} in all")
        self.torch.cuda.empty_cache()

    def serve_profile(self, model, params, prefill, decode_step, spec,
                      numbers, batch=None, enc_out=None):
        """Where a wave's time goes, after the counted run: one more prefill
        (``spec``'s slots and prompt length; ``batch`` if given, a vision
        prefix or encoder frames with it) and DECODE_PROFILED decode steps
        (given ``enc_out``) under ``torch.profiler``; device time by kernel
        class (flash, matrix products, the MoE dispatch's sort / gather /
        scatter kernels, the rest) against the host clock, so the device's
        idle share shows; stored in ``numbers["profile"]``.  The profiler's
        own cost inflates the host clock, so the idle share is an upper
        bound; the unprofiled step times are the serve phase's."""
        import numpy as np
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        cfg = model.cfg
        if batch is None:
            rng = np.random.default_rng(SEED + 14)
            batch = {"tokens": torch.from_numpy(rng.integers(
                1, cfg.vocab_size, (spec["slots"], spec["prompt_len"]))).to(
                    self.dev)}
        cache = model.init_cache(spec["slots"], spec["max_len"])
        extra = () if enc_out is None else (enc_out,)
        out = {}
        state = {}

        def run_prefill():
            state["cache"], state["logits"] = prefill(params, batch, cache)

        def run_decode():
            pos = spec["prompt_len"]
            for _ in range(DECODE_PROFILED):
                cur = state["logits"][:, -1, :cfg.vocab_size].argmax(-1)[:, None]
                state["cache"], state["logits"] = decode_step(
                    params, cur, state["cache"], pos, *extra)
                pos += 1

        for phase, fn, steps in (("prefill", run_prefill, 1),
                                 ("decode", run_decode, DECODE_PROFILED)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kinds = {"flash": 0.0, "matmul": 0.0, "dispatch": 0.0,
                     "other": 0.0}
            launches = 0
            top = []
            for evt in prof.key_averages():
                # device-side events only (kernels, copies, fills): the
                # host ops that launched them carry the same time again
                if evt.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(evt, "self_device_time_total",
                                 getattr(evt, "self_cuda_time_total", 0.0))
                launches += evt.count
                name = evt.key.lower()
                kind = "flash" if "flash_attention_fwd" in name else (
                    "matmul" if any(w in name for w in MATMUL_NAMES)
                    else "dispatch" if any(w in name for w in DISPATCH_NAMES)
                    else "other")
                kinds[kind] += dev_us / 1e3
                top.append((dev_us / 1e3, evt.key[:60]))
            busy = sum(kinds.values())
            out[phase] = {
                "wall_ms_per_step": wall_ms / steps,
                "device_ms_per_step": {k: v / steps for k, v in kinds.items()},
                "device_idle_share": 1.0 - busy / wall_ms,
                "device_events_per_step": launches / steps,
                "top_kernels_ms": [(round(ms / steps, 4), name) for ms, name
                                   in sorted(top, reverse=True)[:4]],
            }
        flash_ms = out["prefill"]["device_ms_per_step"]["flash"]
        require((flash_ms > 0) == (attention_layers(cfg) > 0),
                f"serve profile {cfg.name}: flash kernel time {flash_ms} ms "
                f"in the prefill trace, {attention_layers(cfg)} attention "
                "layers")
        numbers["profile"] = out
        print(f"serve profile {cfg.name} (one wave: prefill, then "
              f"{DECODE_PROFILED} decode steps): " + json.dumps(out),
              flush=True)

    def model_twin(self):
        """2-layer full-width float32 smollm-360m on the card against a CPU
        twin."""
        import dataclasses

        from repro_torch.configs import get_config

        cfg = dataclasses.replace(get_config(SERVE["arch"]),
                                  num_layers=TWIN["layers"],
                                  dtype=self.torch.float32)
        self.twin(cfg, TWIN["prompt_len"], TWIN["steps"], SEED + 12)

    def twin(self, cfg, prompt_len: int, steps: int, seed: int,
             frames: int = 0) -> dict:
        """``cfg`` (float32) on the card and on a ``device="cpu"`` twin with
        the same weights, TF32 off: one prefill of ``prompt_len`` positions
        (a vision frontend's prefix embeddings among them; an
        encoder-decoder model's decoder tokens, with ``frames`` frame
        embeddings into the encoder) and ``steps`` greedy decode steps
        (given ``_encode``'s output).  Last-position logits, every floating
        cache leaf (K/V; a Mamba layer's h and conv histories) and the
        encoder output within TWIN_TOL of the CPU's relative to its max
        |.|, equal greedy tokens, equal expert choices at every MoE layer
        call, and the flash kernel launched as ``prefill_flash_calls``
        says (and once more per encoder layer for ``_encode``).  Returns
        the numbers printed."""
        import numpy as np
        from repro_torch.models import Model, moe

        torch = self.torch
        cpu_model, card_model = Model(cfg, device="cpu"), Model(cfg,
                                                                device=DEVICE)
        params = cpu_model.init(torch.Generator().manual_seed(seed))
        card_params = _to_device(params, self.dev)
        rng = np.random.default_rng(seed + 1)
        gen = torch.Generator().manual_seed(seed + 2)
        text = prompt_len - (cfg.num_prefix_tokens if cfg.frontend == "vision"
                             else 0)
        inputs = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                                          (1, text)))}
        if cfg.frontend == "vision":
            inputs["prefix_embeds"] = torch.randn(
                (1, cfg.num_prefix_tokens, cfg.d_model), generator=gen)
        if cfg.is_encoder_decoder:
            inputs["frame_embeds"] = torch.randn((1, frames, cfg.d_model),
                                                 generator=gen)
        max_len = prompt_len + steps + 1
        runs = {}
        before = self.flash.launches
        real_top_k = moe.top_k
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            for name, model, p, dev in (("cpu", cpu_model, params, "cpu"),
                                        ("card", card_model, card_params,
                                         self.dev)):
                choices = []

                def spy(probs, k, choices=choices):
                    vals, idx = real_top_k(probs, k)
                    choices.append(idx.cpu())
                    return vals, idx

                moe.top_k = spy
                batch = {k: t.to(dev) for k, t in inputs.items()}
                cache, logits = model.prefill(p, batch,
                                              model.init_cache(1, max_len))
                enc = (model._encode(p, batch),) if cfg.is_encoder_decoder \
                    else ()
                vocab = cfg.vocab_size   # the padded columns are all -1e30
                out, tokens = [logits[:, -1, :vocab].cpu()], []
                pos = prompt_len
                for _ in range(steps):
                    cur = logits[:, -1, :vocab].argmax(-1)[:, None]
                    tokens.append(int(cur[0, 0]))
                    cache, logits = model.decode_step(p, cur, cache, pos,
                                                      *enc)
                    out.append(logits[:, -1, :vocab].cpu())
                    pos += 1
                leaves = {f"{n}.{field}": t.cpu()
                          for n, c in cache.items()
                          for field, t in zip(c._fields, c)
                          if t.is_floating_point()}
                leaves.update({"encoder.enc_out": t.cpu() for t in enc})
                runs[name] = (out, tokens, leaves, choices)
            torch.cuda.synchronize()
        finally:
            moe.top_k = real_top_k
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = tf32
        calls = prefill_flash_calls(cfg, prompt_len, frames)
        want = sum(calls.values()) + sum(
            n for key, n in calls.items() if key[0] == "encoder")
        require(self.flash.launches - before == want,
                f"twin {cfg.name}: flash launches "
                f"{self.flash.launches - before}, expected {want}")
        (c_out, c_tok, c_leaves, c_moe), (g_out, g_tok, g_leaves, g_moe) = \
            runs["cpu"], runs["card"]
        require(c_leaves.keys() == g_leaves.keys(),
                f"twin {cfg.name}: cache leaves differ")
        worst = {"logits": 0.0}
        pairs = [("logits", a, b) for a, b in zip(c_out, g_out)] + [
            (n.split(".")[1], c_leaves[n], g_leaves[n]) for n in c_leaves]
        for kind, want_t, got_t in pairs:
            rel = float((got_t - want_t).abs().max()
                        / want_t.abs().max().clamp(min=1e-30))
            worst[kind] = max(worst.get(kind, 0.0), rel)
        require(max(worst.values()) <= TWIN_TOL,
                f"twin {cfg.name}: card vs cpu relative error {worst}")
        require(c_tok == g_tok,
                f"twin {cfg.name}: greedy tokens {g_tok} != cpu {c_tok}")
        require(len(c_moe) == len(g_moe)
                and all(torch.equal(a, b) for a, b in zip(c_moe, g_moe)),
                f"twin {cfg.name}: expert choices differ between the card "
                f"and the cpu ({len(g_moe)} / {len(c_moe)} MoE calls)")
        numbers = {"max_rel_err": worst, "greedy_tokens": g_tok,
                   "moe_calls_equal_choices": len(g_moe),
                   "flash_launches": want}
        print(f"twin: {cfg.num_layers}-layer {cfg.name} float32 (d_model "
              f"{cfg.d_model}), {prompt_len}-position prefill"
              + (f" ({frames} frames)" if frames else "")
              + f" + {steps} decode steps, card vs cpu: "
              + json.dumps(numbers), flush=True)
        return numbers

    # -- phases 15 and 16: the MoE and Mamba-2 serves -----------------------
    def serve_granite(self):
        """Phase 15: granite-moe-3b-a800m at full width and depth through
        ServeEngine (flash launches 32 layers x 2 waves), the drop fraction
        of each prefill wave (every MoE call's, read after the run), a
        profiled wave, then a 2-layer float32 twin (card vs CPU, equal
        expert choices)."""
        import dataclasses

        from repro_torch.models import moe

        torch = self.torch
        torch.cuda.empty_cache()
        real, drops = moe.moe_layer, []

        def counted(params, x, cfg, *args, **kwargs):
            out, aux = real(params, x, cfg, *args, **kwargs)
            if x.shape[1] > 1:          # a prefill's dispatch group
                drops.append(aux["moe_drop_fraction"])
            return out, aux

        t0 = time.perf_counter()
        moe.moe_layer = counted
        try:
            model, params, steps, self.granite_numbers, \
                self.granite_launches = self.serve_path(SERVE_GRANITE,
                                                        SEED + 30)
        finally:
            moe.moe_layer = real
        cfg = model.cfg
        waves = -(-SERVE_GRANITE["requests"] // SERVE_GRANITE["slots"])
        require(len(drops) == waves * cfg.num_layers,
                f"serve {cfg.name}: {len(drops)} prefill MoE calls")
        per_wave = torch.stack(drops).view(waves, cfg.num_layers).cpu()
        self.granite_numbers["prefill_drop_fraction"] = {
            "mean_per_wave": per_wave.mean(dim=1).tolist(),
            "max_layer_per_wave": per_wave.max(dim=1).values.tolist()}
        self.rows["flash_attention_granite"]["launches"] = \
            self.flash.launches
        print(f"  {cfg.name} prefill drop fraction (capacity factor "
              f"{cfg.moe_capacity_factor}, one dispatch group a wave): "
              + json.dumps(self.granite_numbers["prefill_drop_fraction"]),
              flush=True)
        self.serve_profile(model, params, *steps, SERVE_GRANITE,
                           self.granite_numbers)
        del model, params, steps
        torch.cuda.empty_cache()
        self.granite_numbers["twin"] = self.twin(
            dataclasses.replace(cfg, num_layers=TWIN["layers"],
                                dtype=torch.float32),
            TWIN["prompt_len"], TWIN["steps"], SEED + 31)
        self.phase_ms["phase 15 (granite-moe-3b-a800m)"] = \
            (time.perf_counter() - t0) * 1e3
        print(card_line(), flush=True)

    def serve_mamba(self):
        """Phase 16: mamba2-2.7b at full width and depth through ServeEngine
        (no flash launch), a profiled wave, a 2-layer float32 twin (h and
        the conv histories card vs CPU), then reduced jamba-1.5-large-398b
        and grok-1-314b card vs CPU."""
        import dataclasses

        from repro_torch.configs import get_config, reduce_config

        torch = self.torch
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model, params, steps, self.mamba_numbers, self.mamba_launches = \
            self.serve_path(SERVE_MAMBA, SEED + 40)
        cfg = model.cfg
        self.serve_profile(model, params, *steps, SERVE_MAMBA,
                           self.mamba_numbers)
        del model, params, steps
        torch.cuda.empty_cache()
        self.mamba_numbers["twin"] = self.twin(
            dataclasses.replace(cfg, num_layers=TWIN["layers"],
                                dtype=torch.float32),
            TWIN["prompt_len"], TWIN["steps"], SEED + 41)
        self.reduced_twins = {
            arch: self.twin(reduce_config(get_config(arch)),
                            REDUCED_TWIN["prompt_len"], REDUCED_TWIN["steps"],
                            SEED + 42 + i)
            for i, arch in enumerate(REDUCED_TWINS)}
        self.phase_ms["phase 16 (mamba2-2.7b, reduced twins)"] = \
            (time.perf_counter() - t0) * 1e3
        print(card_line(), flush=True)

    # -- phases 17 and 18: the vision-prefix and encoder-decoder models ----
    def flash_encdec_rows(self):
        """Rows 6h and 6i: the flash kernel at seamless-m4t-medium's
        prefill shapes, non-causal (bf16, 512-blocks): the encoder's
        self-attention (Sq = Skv = 2048) and the decoder's cross-attention
        (Sq = 1024, Skv = 2048), each == plain and dense oracle, timed
        beside its plain version, its bound (every (q, k) pair live) and
        one non-causal SDPA call; launches: phase 18's per prefill."""
        from repro_torch.configs import get_config

        torch = self.torch
        F = torch.nn.functional
        cfg = get_config(SERVE_SEAMLESS["arch"])
        B, frames, seq = (SERVE_SEAMLESS[k] for k in ("slots", "frames",
                                                      "prompt_len"))
        H, Hkv, D, blk = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
            cfg.attn_block_q
        for key, label, sq, skv, seed in (
                ("flash_attention_encoder", "encoder self-attention", frames,
                 frames, SEED + 50),
                ("flash_attention_cross", "cross-attention", seq, frames,
                 SEED + 51)):
            row, (q, k, v), err, got = self.flash_row(
                f"{cfg.name} {label}: B={B} H={H}/{Hkv} Sq={sq} Skv={skv} "
                f"D={D} bf16 block {blk} non-causal", B, H, Hkv, sq, D, blk,
                seed, causal=False, skv=skv)

            def library(q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=False, enable_gqa=H != Hkv)

            lib_err = float((library().float() - got.float()).abs().max())
            require(lib_err <= 5e-2, f"flash {label}: kernel vs "
                    f"scaled_dot_product_attention max |diff| {lib_err}")
            row.update(name=f"flash_attention (D={D}, non-causal, {label}, "
                            f"{cfg.name} prefill)",
                       max_abs_err=err, library_ms=self.time_ms(library, 20))
            self.rows[key] = row
            print(f"  sdpa (is_causal=False; the same function): "
                  f"{row['library_ms']:.4f} ms, max |kernel - sdpa| "
                  f"{lib_err:.4g}; {card_line()}", flush=True)
            del q, k, v, got, library

    def model_inputs(self, cfg, spec: dict, seed: int) -> dict:
        """The batch of phases 17 and 18 on the card, from a seeded
        generator: tokens below the vocabulary, and standard normal
        ``prefix_embeds`` (vision: ``num_prefix_tokens`` of the
        ``prompt_len`` positions) or ``frame_embeds`` (an encoder's
        ``frames``) in the compute dtype."""
        torch = self.torch
        gen = torch.Generator(DEVICE).manual_seed(seed)
        B, seq = spec["slots"], spec["prompt_len"]
        batch = {}
        if cfg.frontend == "vision":
            batch["prefix_embeds"] = torch.randn(
                (B, cfg.num_prefix_tokens, cfg.d_model), generator=gen,
                device=self.dev).to(cfg.dtype)
            seq -= cfg.num_prefix_tokens
        if cfg.is_encoder_decoder:
            batch["frame_embeds"] = torch.randn(
                (B, spec["frames"], cfg.d_model), generator=gen,
                device=self.dev).to(cfg.dtype)
        batch["tokens"] = torch.randint(1, cfg.vocab_size, (B, seq),
                                        generator=gen, device=self.dev)
        return batch

    def drive_model(self, spec: dict, seed: int):
        """``spec['arch']`` at full width and depth (random float32 weights
        from a seeded generator, bf16 compute) through ``Model.prefill``
        and ``decode_step``: two prefills of ``model_inputs`` (cold, warm),
        each counted at the ``kernels.ops`` call site by (Sq, Skv, causal)
        and held to ``prefill_flash_calls`` (those wrapper calls timed by
        CUDA events and summed: a padded width's copies with the kernel,
        and any wait for the host inside a call), every wrapper's count
        zeroed
        just before the first and read after the second; an
        encoder-decoder model's ``_encode`` (timed); ``max_new`` greedy
        decode steps (given its output): every token below the vocabulary,
        every logit finite.  Then a profiled prefill and DECODE_PROFILED
        decode steps, and the flash kernel's share of the prefill's device
        time.  Returns (numbers, launches, flash launches per prefill by
        site)."""
        from repro_torch.configs import get_config
        from repro_torch.models import Model

        torch = self.torch
        ops, wrapper = self.ops, self.flash
        cfg = get_config(spec["arch"])
        model = Model(cfg, device=DEVICE)
        params = self.timed(f"{cfg.name} init weights", lambda: model.init(
            torch.Generator(DEVICE).manual_seed(seed)))
        batch = self.model_inputs(cfg, spec, seed + 1)
        cache = model.init_cache(spec["slots"], spec["max_len"])
        frames = spec.get("frames", 0)
        want = prefill_flash_calls(cfg, spec["prompt_len"], frames)
        vocab = cfg.vocab_size
        by_call, events, by_route = {}, [], {}

        def counted(q, k, *args, causal=True, **kw):
            before = wrapper.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = wrapper(q, k, *args, causal=causal, **kw)
            end.record()
            events.append((start, end))
            key = (q.shape[2], k.shape[2], causal)
            n = wrapper.launches - before
            by_call[key] = by_call.get(key, 0) + n
            # the kernel the wrapper picks for this width and dtype
            route = self.flash_route(q.shape[3], q.dtype)[0]
            by_route[route] = by_route.get(route, 0) + n
            return out

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        prefill_ms, calls_ms = [], []
        for w in self.wrappers:
            w.launches = 0
        ops.flash_attention_kernel = counted
        try:
            for _ in range(2):
                by_call.clear()
                events.clear()
                (cache, logits), ms = timed(
                    lambda: model.prefill(params, batch, cache))
                prefill_ms.append(ms)
                calls_ms.append(sum(a.elapsed_time(b) for a, b in events))
                got = {key: by_call.get(key[1:], 0) for key in want}
                require(got == want and sum(by_call.values())
                        == sum(want.values()),
                        f"{cfg.name}: flash launches a prefill {by_call}, "
                        f"expected {want}")
                require(bool(torch.isfinite(logits[..., :vocab]).all()),
                        f"{cfg.name}: non-finite prefill logits")
        finally:
            ops.flash_attention_kernel = wrapper
        launches = {w.__name__: w.launches for w in self.wrappers}
        enc_out, encode_ms = None, 0.0
        if cfg.is_encoder_decoder:
            enc_out, encode_ms = timed(lambda: model._encode(params, batch))
            require(tuple(enc_out.shape) == (spec["slots"], frames,
                                              cfg.d_model)
                    and bool(torch.isfinite(enc_out).all()),
                    f"{cfg.name}: encoder output {tuple(enc_out.shape)}")
        extra = () if enc_out is None else (enc_out,)
        decode_ms, tokens = [], []
        pos = spec["prompt_len"]
        for _ in range(spec["max_new"]):
            cur = logits[:, -1, :vocab].argmax(-1)[:, None]
            tokens.append(cur[:, 0].cpu())
            (cache, logits), ms = timed(
                lambda: model.decode_step(params, cur, cache, pos, *extra))
            decode_ms.append(ms)
            require(bool(torch.isfinite(logits[..., :vocab]).all()),
                    f"{cfg.name}: non-finite logits at position {pos}")
            pos += 1
        tokens = torch.stack(tokens, dim=1)
        require(tokens.shape == (spec["slots"], spec["max_new"])
                and bool(((tokens >= 0) & (tokens < vocab)).all()),
                f"{cfg.name}: greedy tokens {tokens.tolist()}")
        steps = decode_ms[1:]
        wave_ms = prefill_ms[1] + encode_ms + sum(decode_ms)
        numbers = {
            "prefill_ms": prefill_ms, "encode_ms": encode_ms,
            # CUDA events around each wrapper call of a prefill, summed: a
            # padded width's copies in and out with the kernel, and any time
            # the card waits for the host inside a call (a host-bound
            # prefill's events read above its kernels' device time)
            "flash_calls_device_ms_per_prefill": calls_ms,
            "decode_ms_per_step_mean": sum(steps) / len(steps),
            "decode_steps": len(decode_ms),
            "new_tokens": tokens.numel(),
            "tokens_per_s": tokens.numel() / wave_ms * 1e3,
            "flash_launches_per_prefill": {
                f"{site} Sq={sq} Skv={skv} causal={c}": n
                for (site, sq, skv, c), n in want.items()},
            # both prefills, by the kernel that served them
            "flash_launches_by_route": by_route,
        }
        print(f"{cfg.name}: full width ({cfg.param_count()} params, "
              f"{cfg.num_layers} layers"
              + (f" + {cfg.num_encoder_layers} encoder layers"
                 if cfg.is_encoder_decoder else "")
              + f"), {spec['slots']} x {spec['prompt_len']} positions"
              + (f" ({cfg.num_prefix_tokens} prefix embeddings)"
                 if cfg.frontend == "vision" else "")
              + (f", {frames} frames" if frames else "")
              + f", {spec['max_new']} greedy steps: tokens < vocab, logits "
              f"finite; " + json.dumps(numbers), flush=True)
        print(f"  first tokens: {tokens[0, :8].tolist()}; {card_line()}",
              flush=True)
        self.serve_profile(model, params, model.prefill, model.decode_step,
                           spec, numbers, batch=batch, enc_out=enc_out)
        prof = numbers["profile"]["prefill"]["device_ms_per_step"]
        numbers["flash_share_of_prefill_device_time"] = \
            prof["flash"] / sum(prof.values())
        print(f"  flash share of the profiled prefill's device time: "
              f"{numbers['flash_share_of_prefill_device_time']:.4f} "
              f"({prof['flash']:.3f} of {sum(prof.values()):.3f} ms)",
              flush=True)
        del model, params, batch, cache, logits, enc_out
        torch.cuda.empty_cache()
        return numbers, launches, want

    def serve_phi3(self, route: str = "wgmma"):
        """Phase 17: phi-3-vision-4.2b at full width and depth (32 heads of
        96: the bf16 wgmma + TMA kernel at D = 96, row 6c), 32 flash
        launches a prefill, every one on the ``"wgmma"`` route, then a
        2-layer float32 twin (card vs CPU)."""
        import dataclasses

        from repro_torch.configs import get_config

        torch = self.torch
        t0 = time.perf_counter()
        self.phi3_numbers, self.phi3_launches, calls = self.drive_model(
            SERVE_PHI3, SEED + 60)
        routes = self.phi3_numbers["flash_launches_by_route"]
        require(routes == {route: 2 * sum(calls.values())},
                f"phi-3-vision-4.2b: flash launches by route {routes}, "
                f"expected all {2 * sum(calls.values())} on {route}")
        self.rows["flash_attention_d96"]["launches"] = routes[route]
        cfg = get_config(SERVE_PHI3["arch"])
        self.phi3_numbers["twin"] = self.twin(
            dataclasses.replace(cfg, num_layers=ENCDEC_TWIN["layers"],
                                dtype=torch.float32),
            ENCDEC_TWIN["prompt_len"], ENCDEC_TWIN["steps"], SEED + 61)
        self.phase_ms["phase 17 (phi-3-vision-4.2b)"] = \
            (time.perf_counter() - t0) * 1e3
        print(card_line(), flush=True)

    def serve_seamless(self):
        """Phase 18: seamless-m4t-medium at full width and depth (12
        encoder + 12 decoder layers, 16 heads of 64): 36 flash launches a
        prefill, 12 at each site (encoder non-causal, decoder causal,
        cross-attention non-causal at Sq = 1024, Skv = 2048), then a 2 + 2
        layer float32 twin (card vs CPU)."""
        import dataclasses

        from repro_torch.configs import get_config

        torch = self.torch
        t0 = time.perf_counter()
        self.seamless_numbers, self.seamless_launches, calls = \
            self.drive_model(SERVE_SEAMLESS, SEED + 70)
        for key, site in (("flash_attention_encoder", "encoder"),
                          ("flash_attention_cross", "cross")):
            self.rows[key]["launches"] = sum(
                n for k, n in calls.items() if k[0] == site)
        cfg = get_config(SERVE_SEAMLESS["arch"])
        self.seamless_numbers["twin"] = self.twin(
            dataclasses.replace(cfg, num_layers=ENCDEC_TWIN["layers"],
                                num_encoder_layers=ENCDEC_TWIN["layers"],
                                dtype=torch.float32),
            ENCDEC_TWIN["prompt_len"], ENCDEC_TWIN["steps"], SEED + 71,
            frames=ENCDEC_TWIN["frames"])
        self.phase_ms["phase 18 (seamless-m4t-medium)"] = \
            (time.perf_counter() - t0) * 1e3
        print(card_line(), flush=True)

    # -- phase 14: the DDM surface ---------------------------------------
    def ddm_surface(self, card: str, t_start: float):
        """Phase 14: (a) the core engines at the matching benchmark's
        bf/rank cell, (b) the scan variants at full size, (c) the broker,
        (d) the conformance battery, all on the card."""
        t0 = time.perf_counter()
        self.surface_core()
        self.surface_scans()
        self.surface_broker()
        self.surface_battery()
        secs = time.perf_counter() - t0
        self.phase_ms["phase 14"] = secs * 1e3
        print(f"phase 14: {secs:.3f} s; chip_smoke so far "
              f"{time.perf_counter() - t_start:.3f} s", flush=True)
        print(card, flush=True)

    def surface_core(self):
        """(a) rank_count, bf_count, sbm_count under each scan and
        grid_count at a cap that holds every cell, each equal to the
        sequential sweep on the host; grid_count at its default cap equal
        to the same call on the CPU (an overflowing lower bound), and its
        strict form raising; K past 2**31 exact on three engines."""
        from repro_torch import core
        from repro_torch.core.intervals import Extents

        torch = self.torch
        subs, upds = self.workload(SURFACE_N, SURFACE_ALPHA, SEED + 40)
        k = core.sequential_sbm_count_numpy(subs, upds)
        calls = {"rank_count": lambda: core.rank_count(subs, upds),
                 f"bf_count block={BF_BLOCK}":
                     lambda: core.bf_count(subs, upds, block=BF_BLOCK)}
        for scan in SCANS:
            calls[f"sbm_count {scan}"] = (
                lambda scan=scan: core.sbm_count(subs, upds, scan_impl=scan))
        calls[f"grid_count cap={GRID_CAP_EXACT}"] = (
            lambda: core.grid_count(subs, upds, cap=GRID_CAP_EXACT))
        calls["grid_count cap=512"] = lambda: core.grid_count(subs, upds)
        outs = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
        for name, out in outs.items():
            got = out if isinstance(out, tuple) else (out, None)
            require(all(t.device.type == self.dev.type for t in got
                        if t is not None), f"(a) {name}: result off the card")
        for name in list(calls)[:5]:
            require(int(outs[name]) == k, f"(a) {name} = {int(outs[name])} "
                    f"!= the sequential sweep's {k}")
        count, over = outs[f"grid_count cap={GRID_CAP_EXACT}"]
        require((int(count), int(over)) == (k, 0),
                f"(a) grid_count cap={GRID_CAP_EXACT}: ({int(count)}, "
                f"{int(over)}) != ({k}, 0)")
        count, over = outs["grid_count cap=512"]
        host = (Extents(subs.lo.cpu(), subs.hi.cpu()),
                Extents(upds.lo.cpu(), upds.hi.cpu()))
        c_count, c_over = core.grid_count(*host)
        require((int(count), int(over)) == (int(c_count), int(c_over))
                and int(over) > 0 and int(count) < k,
                f"(a) grid_count cap=512: ({int(count)}, {int(over)}) on the "
                f"card, ({int(c_count)}, {int(c_over)}) on the CPU, K={k}")
        raised = False
        try:
            core.grid_count(subs, upds, strict=True)
        except core.GridOverflowError:
            raised = True
        require(raised, "(a) grid_count(strict=True) did not raise "
                "GridOverflowError on an overflowing cap")
        n, m = WIDE_K
        ws = Extents(torch.zeros(n, device=self.dev),
                     torch.ones(n, device=self.dev))
        wu = Extents(torch.zeros(m, device=self.dev),
                     torch.ones(m, device=self.dev))
        wide = (int(core.bf_count(ws, wu, block=16_384)),
                int(core.rank_count(ws, wu)), core.sbm_count_exact(ws, wu))
        require(wide == (n * m,) * 3,
                f"(a) K past 2**31: bf/rank/sbm {wide} != {n * m}")
        times = {}
        for name, fn in calls.items():
            times[name] = self.time_ms(fn, 3)
            self.phase_ms[f"surface (a) {name}"] = times[name]
        print(f"phase 14 (a) n=m={SURFACE_N} alpha={SURFACE_ALPHA:g} uniform: "
              f"K={k} on rank_count, bf_count, sbm_count x {len(SCANS)} "
              f"scans and grid_count cap={GRID_CAP_EXACT} (overflow 0); "
              f"grid_count cap=512 ({int(count)}, overflow {int(over)}) == "
              f"the CPU's, strict raises; K={n * m} past 2**31 exact; "
              "device ms per call: "
              + json.dumps({k_: round(v, 4) for k_, v in times.items()}),
              flush=True)

    def surface_scans(self):
        """(b) sbm_count under the three scans at full size A, equal to
        each other and to the kernel count; sbm_enumerate's buffer under
        the three scans at the main path's size, identical."""
        from repro_torch import core

        torch = self.torch
        n_a, alpha_a = FULL[0]
        subs, upds = self.workload(n_a, alpha_a, SEED)
        ks = {scan: int(core.sbm_count(subs, upds, scan_impl=scan))
              for scan in SCANS}
        k_kernel = int(self.ops.sbm_count_kernel(subs, upds))
        require(set(ks.values()) == {k_kernel},
                f"(b) sbm_count by scan {ks} != the kernel count {k_kernel}")
        times = {f"sbm_count {scan} n=m={n_a}": self.time_ms(
            lambda scan=scan: core.sbm_count(subs, upds, scan_impl=scan), 3)
            for scan in SCANS}
        g = torch.Generator().manual_seed(SEED + 2)
        subs, upds = core.make_uniform_workload(MAIN_N, MAIN_N, 1.0,
                                                length=LENGTH, generator=g,
                                                device=self.dev)
        k = int(core.sbm_count(subs, upds))
        bufs = {scan: core.sbm_enumerate(subs, upds, max_pairs=k + 64,
                                         scan_impl=scan) for scan in SCANS}
        base = bufs[SCANS[0]][0]
        for scan, (pairs, count) in bufs.items():
            require(int(count) == k and torch.equal(pairs, base),
                    f"(b) sbm_enumerate {scan}: count {int(count)} (K={k}) "
                    "or its buffer differs from two_level's")
        for scan in SCANS:
            times[f"sbm_enumerate {scan} n=m={MAIN_N}"] = self.time_ms(
                lambda scan=scan: core.sbm_enumerate(
                    subs, upds, max_pairs=k + 64, scan_impl=scan), 3)
        for name, ms in times.items():
            self.phase_ms[f"surface (b) {name}"] = ms
        print(f"phase 14 (b) scans {list(SCANS)}: sbm_count K={k_kernel} at "
              f"n=m={n_a} alpha={alpha_a:g} on each == the kernel count; "
              f"sbm_enumerate buffers identical at n=m={MAIN_N} (K={k}); "
              "device ms per call: "
              + json.dumps({k_: round(v, 4) for k_, v in times.items()}),
              flush=True)

    @staticmethod
    def region_bounds(rng, d: int, seg: float):
        """One region's bounds: d = 1 a uniform thin segment; d = 2 wide
        in dim 0, thin in dim 1 (the tall-thin shape)."""
        thin = float(rng.uniform(0.0, LENGTH - seg))
        if d == 1:
            return thin, thin + seg
        wide = float(rng.uniform(0.0, 0.02 * LENGTH))
        return [wide, thin], [wide + 0.98 * LENGTH, thin + seg]

    def surface_broker(self):
        """(c) Two broker sessions (d = 1 uniform, d = 2 tall-thin) of
        BROKER_N regions a side on the card, loaded by BROKER_THREADS
        producer threads; every ticket resolves, pairs() equals the
        journal's replay into a ``device="cpu"`` service, a forced degraded
        read equals its estimator on the replay's state, a healthy read is
        exact.  The sweep kernels' counts are zeroed before the load and
        read after the joins and the reads: each must be > 0.  The
        admission policy blocks producers for up to a minute (the default
        5 s would turn a slow flush into rejected tickets)."""
        import threading

        import numpy as np
        from repro_torch import api, core
        from repro_torch.core import ddim as ddim_lib

        torch, K = self.torch, self.K
        t0 = time.perf_counter()
        broker = api.Broker(journal=True, flush_interval=0.01,
                            admission=api.AdmissionPolicy(block_timeout=60.0))
        g = torch.Generator().manual_seed(SEED + 41)
        uniform = core.make_uniform_workload(BROKER_N, BROKER_N, 1.0,
                                             length=LENGTH, generator=g,
                                             device="cpu")
        g = torch.Generator().manual_seed(SEED + 42)
        tall = core.make_tall_thin_workload(BROKER_N, BROKER_N, 1.0,
                                            length=LENGTH, d=2, wide_dim=0,
                                            generator=g, device="cpu")
        sessions = {}
        for name, d, (subs, upds) in (("uniform d=1", 1, uniform),
                                      ("tall-thin d=2", 2, tall)):
            block = (lambda x: x.numpy()) if d == 1 \
                else (lambda x: x.T.contiguous().numpy())
            sess = broker.create_session(name, dims=d, device=DEVICE)
            tickets = [sess.register(side, block(e.lo), block(e.hi))
                       for side, e in (("sub", subs), ("upd", upds))]
            sess.flush()
            sessions[name] = (sess, d, {side: t.result(timeout=600)
                                        for side, t in zip(("sub", "upd"),
                                                           tickets)})
        self.phase_ms["surface (c) bulk register + flush"] = \
            (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        for w in K.KERNEL_WRAPPERS:
            w.launches = 0
        seg = LENGTH / (2 * BROKER_N)             # alpha = 1
        span = BROKER_N // BROKER_THREADS
        every = BROKER_MOVES // BROKER_CHURN
        tickets = [[] for _ in range(BROKER_THREADS)]
        errors = []
        barrier = threading.Barrier(BROKER_THREADS)

        def producer(k):
            """Per session: moves of rids of its own range, a register and
            an unregister (of its range's tail, never moved) every
            ``every`` moves.  Touches no tensor."""
            rng = np.random.default_rng(SEED + 50 + k)
            base = k * span
            try:
                barrier.wait(timeout=60.0)
                for sess, d, rids in sessions.values():
                    for i in range(BROKER_MOVES):
                        side = ("sub", "upd")[i % 2]
                        rid = int(rids[side][base + int(rng.integers(
                            0, span - BROKER_CHURN))])
                        tickets[k].append(sess.move(
                            side, rid, *self.region_bounds(rng, d, seg)))
                        if i % every == 0:
                            j = i // every
                            tickets[k].append(sess.register(
                                side, *self.region_bounds(rng, d, seg)))
                            tickets[k].append(sess.unregister(
                                side, int(rids[side][base + span - 1 - j])))
            except Exception as exc:    # reported below, after the joins
                errors.append(repr(exc))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=producer, args=(k,))
                   for k in range(BROKER_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        require(not any(th.is_alive() for th in threads) and not errors,
                f"(c) producers did not finish cleanly: {errors}")
        failed = []
        for t in (t for per in tickets for t in per):
            try:
                t.result(timeout=600)
            except api.DDMError as exc:
                failed.append(repr(exc))
        load_s = time.perf_counter() - t0
        self.phase_ms["surface (c) load (submit to last ticket)"] = load_s * 1e3
        n_tickets = sum(len(per) for per in tickets)
        require(not failed and n_tickets == BROKER_THREADS * len(sessions)
                * (BROKER_MOVES + 2 * BROKER_CHURN),
                f"(c) {len(failed)} of {n_tickets} tickets failed: "
                f"{failed[:3]}")
        lines = {}
        for name, (sess, d, _) in sessions.items():
            t0 = time.perf_counter()
            replay = api.replay_journal(sess.journal, dims=d,
                                        service_factory=_warm_service,
                                        device="cpu")
            self.phase_ms[f"surface (c) {name} cpu replay"] = \
                (time.perf_counter() - t0) * 1e3
            host = [t.compact(t.live_ids(), "cpu")
                    for t in (replay._subs, replay._upds)]
            if d == 1:
                estimator, source = "grid", "grid_count"
                want_est = int(core.grid_count(*host)[0])
            else:
                estimator, source = "probe", "probe_count"
                gen, counts = ddim_lib.select_dimension(*host)
                want_est = int(counts[gen])
            sess.degrade = api.DegradePolicy(max_queue_depth=0,
                                             estimator=estimator)
            degraded = sess.match_count()
            sess.degrade = api.DegradePolicy()
            require(not degraded.exact and degraded.source == source
                    and degraded.count == want_est,
                    f"(c) {name}: degraded read {degraded} != {source} "
                    f"{want_est} on the replay's state")
            exact = sess.match_count()
            pairs = sess.pairs()
            want = replay.pairs()
            require(exact.exact and exact.count == len(pairs),
                    f"(c) {name}: healthy read {exact} != |pairs| "
                    f"{len(pairs)}")
            require(pairs == want, f"(c) {name}: pairs() differ from the "
                    f"journal's replay on the CPU ({len(pairs ^ want)} pairs)")
            lines[name] = (len(pairs), degraded.count)
        broker.close()
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}
        require(all(v > 0 for v in launches.values()),
                f"(c) a sweep kernel was not launched by the broker's "
                f"sessions: {launches}")
        self.broker_launches = launches
        st = broker.stats()
        per = {name: {key: st["sessions"][name][key] for key in (
            "flush_p50_us", "flush_p99_us", "accepted", "rejected", "shed",
            "expired", "failed", "applied", "flushes")}
            for name in sessions}
        print(f"phase 14 (c) broker: {BROKER_THREADS} producers, per session "
              f"{BROKER_THREADS * BROKER_MOVES} moves, "
              f"{BROKER_THREADS * BROKER_CHURN} registers and unregisters on "
              f"n=m={BROKER_N}; {n_tickets} tickets resolved in "
              f"{load_s:.3f} s; (K, degraded estimate) "
              f"{json.dumps(lines)} == the cpu replay's; launches "
              f"{json.dumps(launches)}; stats {json.dumps(per)}", flush=True)

    def surface_battery(self):
        """(d) Every engine of the port's registry for d = 1, 2, 3 on
        ``cuda`` extents through ``check_engine``: edge cases and seeded
        workloads; the kernel engines' launch counts must be > 0."""
        from repro_torch import api
        from repro_torch.testing import conformance

        torch, K, B = self.torch, self.K, self.B
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        emit = next(w for w in K.KERNEL_WRAPPERS if w.__name__ == "emit_pairs")
        bitmatch = next(w for w in B.KERNEL_WRAPPERS
                        if w.__name__ == "bitmatch")
        emit.launches = bitmatch.launches = 0
        graded = {}
        for d in (1, 2, 3):
            engines = api.engines_for(d)
            cases = dict(battery_edge_cases(d))
            for kind, n, m in BATTERY_SEEDED[d]:
                cases[f"{kind} n={n} m={m}"] = battery_workload(kind, d, n, m,
                                                                SEED + 60 + d)
            for case, (lo_s, hi_s, lo_u, hi_u) in cases.items():
                subs, upds = (self.extents(lo, hi)
                              for lo, hi in ((lo_s, hi_s), (lo_u, hi_u)))
                for engine in engines:
                    mm = conformance.check_engine(engine, subs, upds)
                    require(mm is None, f"(d) d={d} {case}: {mm and mm.describe()}")
            graded[d] = (len(engines), len(cases))
        torch.cuda.synchronize()
        launches = {emit.__name__: emit.launches,
                    bitmatch.__name__: bitmatch.launches}
        require(all(v > 0 for v in launches.values()),
                f"(d) a kernel engine did not launch its kernel: {launches}")
        self.battery_launches = launches
        secs = time.perf_counter() - t0
        self.phase_ms["surface (d) battery"] = secs * 1e3
        print(f"phase 14 (d) conformance on the card: (engines, cases) by d "
              f"{json.dumps(graded)} all conform in {secs:.3f} s; launches "
              f"{json.dumps(launches)}", flush=True)

    def extents(self, lo, hi):
        from repro_torch.core.intervals import Extents

        torch = self.torch
        return Extents(torch.from_numpy(lo).to(self.dev),
                       torch.from_numpy(hi).to(self.dev))

    # -- phase 19: training ----------------------------------------------
    def train(self):
        """Phase 19: (a) the flash kernel under autograd at smollm-360m's
        training microbatch, (b) smollm-360m trained at full width and
        depth through ``TrainLoop`` (resumed from its step-4 checkpoint, a
        profiled step), (c) a 2-layer full-width float32 twin and (d)
        reduced granite-moe, mamba2 and seamless twins, card vs CPU."""
        torch = self.torch
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        self.train_flash_row()
        self.phase_ms["phase 19 (a) flash row"] = \
            (time.perf_counter() - t0) * 1e3
        self.train_numbers = self.train_smollm()
        self.rows["flash_attention_train"]["launches"] = \
            self.train_numbers["flash_launches"] // TRAIN["steps"]
        t1 = time.perf_counter()
        self.train_numbers["twins"] = self.train_twins()
        self.phase_ms["phase 19 (c, d) twins"] = \
            (time.perf_counter() - t1) * 1e3
        self.phase_ms["phase 19 (training)"] = \
            (time.perf_counter() - t0) * 1e3
        print(card_line(), flush=True)

    def train_flash_row(self):
        """(a): ``ops.flash_attention`` with grad required at one training
        microbatch's shapes (``SyntheticLM`` segments): one launch, output
        == plain within ``flash_full_tol``, dq / dk / dv == autograd
        through the plain version (the replay oracle, code apart from
        ``flash_vjp``'s) and through the twin; forward and backward times,
        the backward's peak memory, and one compiled ``flex_attention``
        (causal and document block mask: the same function) forward and
        forward + backward."""
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
        from repro_torch.kernels.flash_vjp import (blockwise_attention_twin,
                                                   flash_attention_vjp)

        torch = self.torch
        c = TRAIN_FLASH
        B, H, Hkv, S, D, blk = c["B"], c["H"], c["Hkv"], c["S"], c["D"], \
            c["block"]
        gen = torch.Generator().manual_seed(SEED + 90)
        q, k, v = self.flash_inputs(B, H, Hkv, S, S, D, torch.bfloat16, gen,
                                    q_gain=FLASH_FULL_Q_GAIN)
        seg = SyntheticLM(SyntheticConfig(vocab_size=49_152, seq_len=S,
                                          global_batch=B, seed=SEED + 91),
                          device=DEVICE).batch(0)["segments"]
        dout = torch.randn((B, H, S, D), generator=gen).to(self.dev,
                                                            torch.bfloat16)
        idx, cnt, _ = self.ops.build_block_structure(
            S, S, block_q=blk, block_k=blk, causal=True)
        sched = (torch.from_numpy(idx), torch.from_numpy(cnt))
        opts = dict(scale=D ** -0.5, causal=True, window=None, softcap=None,
                    block_q=blk, block_k=blk, q_offset=0)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        before = self.flash.launches
        out = self.ops.flash_attention(q, k, v, scale=D ** -0.5,
                                       q_segments=seg, kv_segments=seg,
                                       block_q=blk, block_k=blk)
        torch.cuda.synchronize()
        require(self.flash.launches - before == 1 and out.requires_grad,
                f"train flash: {self.flash.launches - before} launches, "
                f"grad_fn {out.grad_fn}")
        plain = self.ref.ref_flash_attention(q.detach(), k.detach(),
                                             v.detach(), *sched, seg, seg,
                                             **opts)
        tol = flash_full_tol(v.detach())
        diff = (out.detach().float() - plain.float()).abs()
        err = float(diff.max())
        require(bool((diff <= tol[0] + tol[1] * plain.float().abs()).all()),
                f"train flash: kernel != plain (max |diff| {err})")
        del plain, diff
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        vjp_peak = torch.cuda.max_memory_allocated() - base
        # autograd through the plain version (code apart from flash_vjp's)
        # and through the twin (whose VJP the backward is)
        grad_err = {}
        for against, fn in (("plain", self.ref.ref_flash_attention),
                            ("twin", blockwise_attention_twin)):
            o = fn(q, k, v, *sched, seg, seg, **opts)
            want = torch.autograd.grad(o, (q, k, v), dout.to(o.dtype))
            del o
            for name, got, w in zip(("dq", "dk", "dv"), grads, want):
                rel = float((got.float() - w.float()).abs().max()
                            / w.float().abs().max())
                grad_err[f"{name} vs {against}"] = rel
                require(got.dtype == torch.bfloat16 and rel <= 1e-2,
                        f"train flash: {name} != autograd through the "
                        f"{against} (relative {rel}, dtype {got.dtype})")
            del want
        del grads
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        kernel_ms = self.time_ms(
            lambda: self.flash(qd, kd, vd, *sched, seg, seg, **opts), 10,
            "flash_attention_fwd")
        backward_ms = self.time_ms(
            lambda: flash_attention_vjp(qd, kd, vd, dout, *sched, seg, seg,
                                        **opts), 3)
        plain_ms = self.time_ms(
            lambda: self.ref.ref_flash_attention(qd, kd, vd, *sched, seg,
                                                 seg, **opts), 2)
        # the same function in one library call: flex_attention (compiled)
        # with a causal and document block mask
        flex = torch.compile(flex_attention, dynamic=False)
        seg_d = seg.to(self.dev)

        def documents(b, h, q_idx, kv_idx):
            return (q_idx >= kv_idx) & (seg_d[b, q_idx] == seg_d[b, kv_idx])

        mask = create_block_mask(documents, B, None, S, S, device=self.dev)

        def library(q=qd, k=kd, v=vd):
            return flex(q, k, v, block_mask=mask, scale=D ** -0.5,
                        enable_gqa=True)

        lib_err = float((library().float() - out.detach().float()).abs()
                        .max())
        require(lib_err <= 5e-2, f"train flash: kernel vs flex_attention "
                f"max |diff| {lib_err}")
        library_ms = self.time_ms(library, 10)

        def library_fwd_bwd():
            o = flex(q, k, v, block_mask=mask, scale=D ** -0.5,
                     enable_gqa=True)
            return torch.autograd.grad(o, (q, k, v), dout)

        library_fwd_bwd_ms = self.time_ms(library_fwd_bwd, 5)
        pairs = doc_pairs(seg) * H
        flops = 4 * D * pairs
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
            + 4 * (2 * seg.numel() + idx.size + cnt.size)
        ops_ms = flops / BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {
            "name": "flash_attention (training forward under autograd, "
                    "smollm-360m microbatch B=4 S=4096 with segments)",
            "route": "cuda", "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"], "launches": None,
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms,
            "backward_ms": backward_ms,
            "library_fwd_bwd_ms": library_fwd_bwd_ms,
        }
        self.rows["flash_attention_train"] = row
        print(f"train flash (B={B} H={H}/{Hkv} S={S} D={D} bf16, causal "
              f"{blk}-blocks, {int(seg.max()) + 1} documents in row 0): one "
              f"launch under autograd, == plain within {tol[0]:.4g} + "
              f"{tol[1]:.4g} |ref| (max |diff| {err:.4g}); dq/dk/dv vs "
              f"autograd through the plain version and the twin (relative "
              f"to max): {json.dumps(grad_err)}; "
              f"forward kernel {kernel_ms:.4f} ms "
              f"({self.timing_source.get('flash_attention_fwd')}), backward "
              f"(flash_attention_vjp, float32 torch) {backward_ms:.3f} ms, "
              f"its peak memory {vjp_peak / 2**30:.3f} GiB above the inputs; "
              f"plain forward {plain_ms:.3f} ms; {pairs} live (q, k) pairs "
              f"(causal and document masks), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); flex_attention (compiled; causal and "
              f"document block mask, enable_gqa; the same function; max "
              f"|kernel - flex| {lib_err:.4g}) forward {library_ms:.4f} ms, "
              f"forward + backward {library_fwd_bwd_ms:.4f} ms", flush=True)
        print(card_line(), flush=True)

    def train_smollm(self) -> dict:
        """(b): smollm-360m at full width and depth through ``TrainLoop``,
        then a fresh loop resumed from the step-4 checkpoint, then one
        profiled step.  Returns the numbers printed."""
        import shutil
        import tempfile

        from repro_torch.configs import get_config
        from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
        from repro_torch.models import Model
        from repro_torch.models.api import iter_leaves
        from repro_torch.train.loop import TrainLoop, TrainLoopConfig
        from repro_torch.train.optimizer import AdamW, cosine_schedule

        torch = self.torch
        t = TRAIN
        cfg = get_config(t["arch"])
        require(cfg.param_count() == t["params"] and cfg.remat,
                f"train: {cfg.name} has {cfg.param_count()} parameters, "
                f"remat {cfg.remat}")
        model = Model(cfg, device=DEVICE)
        data = SyntheticLM(SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=t["seq"],
            global_batch=t["batch"], seed=SEED + 92), device=DEVICE)
        per_step = train_flash_calls(cfg, t["seq"],
                                     microbatches=t["microbatches"])
        (ROOT / "build").mkdir(exist_ok=True)
        root = pathlib.Path(tempfile.mkdtemp(prefix="train_ckpt_",
                                             dir=ROOT / "build"))

        def loop_for(directory, records):
            return TrainLoop(
                model,
                AdamW(cosine_schedule(t["peak_lr"], max(t["steps"] // 10, 1),
                                      t["steps"])),
                data,
                TrainLoopConfig(total_steps=t["steps"],
                                checkpoint_every=t["ckpt_every"],
                                checkpoint_dir=str(directory), log_every=1,
                                microbatches=t["microbatches"]),
                metrics_hook=lambda step, rec: records.append(rec))

        try:
            records = []
            loop = loop_for(root / "run", records)
            for w in self.wrappers:
                w.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = loop.run(SEED + 93)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            self.phase_ms["phase 19 (b) training run"] = run_s * 1e3
            peak = torch.cuda.max_memory_allocated()
            launches = {w.__name__: w.launches for w in self.wrappers}
            loop.close()
            saved = sorted(p.name for p in (root / "run").iterdir())
            require(saved == ["step_00000004", "step_00000008"],
                    f"train: checkpoints {saved}")
            want = per_step * t["steps"]
            require(launches["flash_attention_kernel"] == want
                    and sum(launches.values()) == want,
                    f"train: launches {launches}, expected {want} flash "
                    f"launches ({per_step} a step) and no other")
            losses = [r["loss"] for r in records]
            norms = [r["grad_norm"] for r in records]
            require(len(records) == t["steps"]
                    and all(math.isfinite(x) for x in losses + norms)
                    and all(x > 0 for x in norms),
                    f"train: losses {losses}, grad norms {norms}")
            # a fresh loop resumes from the step-4 checkpoint
            shutil.copytree(root / "run" / "step_00000004",
                            root / "resume" / "step_00000004")
            resumed = []
            loop2 = loop_for(root / "resume", resumed)
            self.flash.launches = 0
            t1 = time.perf_counter()
            state2 = loop2.run(SEED + 93)
            loop2.close()
            self.phase_ms["phase 19 (b) resumed run"] = \
                (time.perf_counter() - t1) * 1e3
            require(self.flash.launches == per_step * (t["steps"] - 4)
                    and [r["step"] for r in resumed] == [4, 5, 6, 7],
                    f"train resume: steps {[r['step'] for r in resumed]}, "
                    f"{self.flash.launches} flash launches")
            # resumed == uninterrupted, bitwise: losses, parameters, both
            # moments and the optimizer's step counter
            resume_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                             for a, b in zip(resumed, records[4:]))
            trees = {"params": (state.params, state2.params),
                     "m": (state.opt_state.m, state2.opt_state.m),
                     "v": (state.opt_state.v, state2.opt_state.v)}
            diffs = {part: max(float((a.float() - b.float()).abs().max())
                               for (_, a), (_, b)
                               in zip(iter_leaves(x), iter_leaves(y)))
                     for part, (x, y) in trees.items()}
            param_diff = diffs["params"]
            opt_steps = (int(state.opt_state.step),
                         int(state2.opt_state.step))
            require([r["loss"] for r in resumed] == losses[4:]
                    and max(diffs.values()) == 0
                    and opt_steps == (t["steps"], t["steps"])
                    and state2.step == t["steps"],
                    f"train resume: losses {[r['loss'] for r in resumed]} "
                    f"!= {losses[4:]} (relative {resume_rel}), max |diff| "
                    f"{diffs}, optimizer steps {opt_steps}, loop step "
                    f"{state2.step}")
            del state
            t1 = time.perf_counter()
            profile = self.train_profile(loop2, state2, data)
            self.phase_ms["phase 19 (b) profiled step"] = \
                (time.perf_counter() - t1) * 1e3
        finally:
            shutil.rmtree(root, ignore_errors=True)
        tokens = t["batch"] * t["seq"]
        steps_ms = [r["time_s"] * 1e3 for r in records]
        warm_ms = sorted(steps_ms[1:])[len(steps_ms[1:]) // 2]
        S, D, H, L = t["seq"], cfg.head_dim, cfg.num_heads, cfg.num_layers
        attn_flops = 3 * 4 * D * (S * (S + 1) // 2) * H * L * t["batch"]
        model_flops = 6 * t["params"] * tokens + attn_flops
        numbers = {
            "arch": cfg.name, "params": cfg.param_count(),
            "batch": t["batch"], "seq": S,
            "microbatches": t["microbatches"], "steps": t["steps"],
            "losses": losses, "grad_norms": norms,
            "step_ms": steps_ms, "cold_step_ms": steps_ms[0],
            "warm_step_ms_median": warm_ms,
            "tokens_per_s_warm": tokens / warm_ms * 1e3,
            "run_s": run_s, "peak_memory_bytes": peak,
            "model_tflop_per_step": model_flops / 1e12,
            "train_mfu": model_flops / (warm_ms / 1e3) / BF16_OPS_PER_S,
            "flash_launches_per_step": per_step,
            "flash_launches": launches["flash_attention_kernel"],
            "resumed_losses": [r["loss"] for r in resumed],
            "resume_max_rel_loss_diff": resume_rel,
            "resume_max_abs_param_diff": param_diff,
            "resume_max_abs_moment_diff": max(diffs["m"], diffs["v"]),
            "profile": profile,
        }
        self.train_launches = launches
        print(f"train {cfg.name} at full width and depth "
              f"({cfg.param_count()} parameters; B={t['batch']} x "
              f"S={S}, {t['microbatches']} microbatches, remat, bf16 "
              f"moments, async checkpoints at 4 and 8): cold step "
              f"{steps_ms[0]:.1f} ms, warm step (median) {warm_ms:.1f} ms, "
              f"{numbers['tokens_per_s_warm']:.1f} tokens/s, peak memory "
              f"{peak / 2**30:.3f} GiB, train_mfu {numbers['train_mfu']:.4f} "
              f"({numbers['model_tflop_per_step']:.2f} TFLOP a step over "
              f"989 TFLOP/s); flash launches {numbers['flash_launches']} "
              f"({per_step} a step); resumed from step 4: losses, params "
              f"and moments bitwise equal to the uninterrupted run's",
              flush=True)
        print("train numbers: " + json.dumps(numbers), flush=True)
        print(card_line(), flush=True)
        return numbers

    def train_profile(self, loop, state, data) -> dict:
        """One more training step under ``torch.profiler``: device time by
        class (the flash forward kernel; the attention backward, i.e. every
        kernel ``flash_attention_vjp`` launches; the optimizer's; matrix
        products; PyTorch's elementwise kernels; the rest) against the
        host clock, and the idle share (an upper bound: the profiler's
        cost inflates the host clock)."""
        import bisect
        import importlib

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.train import loop as loop_lib

        # the module (the package's ``flash_attention`` is a function)
        fa = importlib.import_module("repro_torch.kernels.flash_attention")

        torch = self.torch
        real = {"vjp": fa.flash_attention_vjp, "update": loop.opt.update,
                "apply": loop_lib.apply_updates}

        def labelled(label, fn):
            def run(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return run

        batch = data.batch(TRAIN["steps"])
        torch.cuda.synchronize()
        fa.flash_attention_vjp = labelled("smoke/attention_backward",
                                          real["vjp"])
        # AdamW is a frozen dataclass: its update is shadowed on the instance
        object.__setattr__(loop.opt, "update",
                           labelled("smoke/optimizer", real["update"]))
        loop_lib.apply_updates = labelled("smoke/optimizer", real["apply"])
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                loop.train_step(state.params, state.opt_state, batch)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            exit_s = time.perf_counter() - t0 - wall_ms / 1e3
        finally:
            fa.flash_attention_vjp = real["vjp"]
            object.__delattr__(loop.opt, "update")
            loop_lib.apply_updates = real["apply"]
        # the raw trace (building the profiler's event tree for the
        # ~130,000 kernels of a step takes minutes): device events are
        # kernels, copies and fills, and the ranges' device annotations
        # ("smoke/..."), which span the kernels their range launched on the
        # one stream; a kernel is attributed to the range whose annotation
        # holds its start, else classed by name
        t_parse = time.perf_counter()
        raw = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        spans = {"attention_backward": [], "optimizer": []}
        for e in raw:
            if e.name().startswith("smoke/"):
                spans[e.name().split("/")[1]].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        for v in spans.values():
            v.sort()
        kinds = dict.fromkeys(("flash_forward", "attention_backward",
                               "products", "elementwise", "optimizer",
                               "rest"), 0.0)
        rest = {}
        busy = events = 0
        for e in raw:
            key = e.name()
            if key.startswith("smoke/"):
                continue
            ms = e.duration_ns() / 1e6
            busy += ms
            events += 1
            name = key.lower()
            kind = "flash_forward" if "flash_attention_fwd" in name else None
            start = e.start_ns()
            for label, v in spans.items():
                i = bisect.bisect_right(v, (start, float("inf"))) - 1
                if kind is None and i >= 0 and v[i][0] <= start <= v[i][1]:
                    kind = label
            kind = kind or ("products" if any(w in name for w in MATMUL_NAMES)
                            else "elementwise" if "elementwise" in name
                            else "rest")
            kinds[kind] += ms
            if kind == "rest":
                rest[key[:50]] = rest.get(key[:50], 0.0) + ms
        out = {"wall_ms": wall_ms, "device_ms": kinds,
               "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
               "device_events": events,
               "ranges": {k: len(v) for k, v in spans.items()},
               "profiler_exit_s": exit_s,
               "trace_read_s": time.perf_counter() - t_parse,
               "torch": torch.__version__,
               "top_rest_kernels_ms": sorted(
                   ((round(ms, 3), name) for name, ms in rest.items()),
                   reverse=True)[:6]}
        require(kinds["flash_forward"] > 0 and kinds["attention_backward"] > 0
                and kinds["optimizer"] > 0,
                f"train profile: a class saw no device time {kinds}")
        print("train profile (one step): " + json.dumps(out), flush=True)
        return out

    def train_twins(self) -> dict:
        """(c) and (d): one training step card vs CPU twin."""
        import dataclasses

        from repro_torch.configs import get_config, reduce_config

        cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                                  num_layers=TRAIN_TWIN["layers"],
                                  dtype=self.torch.float32)
        t0 = time.perf_counter()
        out = {cfg.name: self.train_twin(cfg, TRAIN_TWIN["batch"],
                                         TRAIN_TWIN["seq"], SEED + 94)}
        self.phase_ms["phase 19 (c) full-width twin"] = \
            (time.perf_counter() - t0) * 1e3
        for i, arch in enumerate(TRAIN_REDUCED):
            rcfg = reduce_config(get_config(arch))
            out[f"{arch} (reduced)"] = self.train_twin(
                rcfg, 2, TRAIN_REDUCED_SEQ, SEED + 95 + i)
        return out

    def train_twin(self, cfg, batch: int, seq: int, seed: int) -> dict:
        """One training step of ``cfg`` (float32, TF32 off) on the card and
        on a ``device="cpu"`` twin from the same parameters and batch: the
        loss and every gradient leaf within TWIN_TOL of the CPU's,
        relative to each leaf's max |.|; the parameters after one AdamW
        step (float32 moments) within TWIN_TOL · lr of the CPU's, beyond
        one float32 rounding of the parameter, wherever that step is
        lr · sign(g) to 1e-3 and the sign is sure.  A first step from zero
        moments moves a parameter by lr · g / (|g| + eps / c) (c the clip
        scale) plus the weight decay, so a gradient whose sign the
        card-vs-CPU difference can flip moves it 2 lr apart, and one near
        eps / c moves it by a share of lr that the gradient's error sets,
        with no fault present: the entries kept have |g| above twice the
        leaf's gradient difference and |g| · c ≥ 1e3 · eps.  Equal expert
        choices at every MoE call; every gradient leaf nonzero (an
        encoder's too); flash launches as ``train_flash_calls`` says."""
        import numpy as np

        from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
        from repro_torch.models import Model, moe
        from repro_torch.models.api import iter_leaves
        from repro_torch.train.loop import value_and_grad
        from repro_torch.train.optimizer import (AdamW, apply_updates,
                                                 constant_schedule, tree_map)

        torch = self.torch
        cpu_model, card_model = Model(cfg, device="cpu"), Model(cfg,
                                                                device=DEVICE)
        params = cpu_model.init(torch.Generator().manual_seed(seed))
        inputs = SyntheticLM(SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=seed), device="cpu").batch(0)
        gen = torch.Generator().manual_seed(seed + 1)
        if cfg.frontend == "vision":
            inputs["tokens"] = inputs["tokens"][:, cfg.num_prefix_tokens:]
            inputs["labels"][:, :cfg.num_prefix_tokens] = -1
            inputs["prefix_embeds"] = torch.randn(
                (batch, cfg.num_prefix_tokens, cfg.d_model), generator=gen)
        if cfg.is_encoder_decoder:
            inputs["frame_embeds"] = torch.randn((batch, seq, cfg.d_model),
                                                 generator=gen)
        runs = {}
        opt = AdamW(constant_schedule(TWIN_LR), moment_dtype=torch.float32)
        real_top_k = moe.top_k
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            for name, model, dev in (("cpu", cpu_model, "cpu"),
                                     ("card", card_model, self.dev)):
                choices = []

                def spy(probs, k, choices=choices):
                    vals, idx = real_top_k(probs, k)
                    choices.append(idx.cpu())
                    return vals, idx

                moe.top_k = spy
                # copies: the step writes into them
                p = tree_map(lambda t: t.to(dev, copy=True), params)
                b = {k: v.to(dev) for k, v in inputs.items()}
                before = self.flash.launches
                (loss, _), grads = value_and_grad(model, p, b)
                launched = self.flash.launches - before
                up, _, om = opt.update(grads, opt.init(p), p)
                apply_updates(p, up)
                runs[name] = (float(loss),
                              {k: g.cpu() for k, g in iter_leaves(grads)},
                              {k: t.cpu() for k, t in iter_leaves(p)},
                              choices, launched, float(om["grad_norm"]))
            torch.cuda.synchronize()
        finally:
            moe.top_k = real_top_k
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = tf32
        (c_loss, c_g, c_p, c_moe, c_n, c_norm), \
            (g_loss, g_g, g_p, g_moe, g_n, _) = runs["cpu"], runs["card"]
        frames = seq if cfg.is_encoder_decoder else 0
        want = train_flash_calls(cfg, seq, frames)
        require(g_n == want and c_n == 0,
                f"train twin {cfg.name}: flash launches card {g_n} cpu "
                f"{c_n}, expected {want} on the card")
        worst = {"loss": abs(g_loss - c_loss) / abs(c_loss), "grads": 0.0,
                 "params_in_lr": 0.0}
        unsure = total = 0
        worst_leaf = None
        clip = min(1.0, opt.clip_norm / (c_norm + 1.0e-9))
        for path, w in c_g.items():
            gdiff = (g_g[path] - w).abs()
            worst["grads"] = max(worst["grads"], float(
                gdiff.max() / w.abs().max().clamp(min=1e-30)))
            sure = (w.abs() > 2 * gdiff.max()) \
                & (w.abs() * clip >= 1e3 * opt.eps)
            unsure += int(sure.numel() - sure.sum())
            total += sure.numel()
            rounding = torch.finfo(torch.float32).eps * c_p[path].abs()
            excess = ((g_p[path] - c_p[path]).abs() - rounding)[sure]
            if excess.numel() and float(excess.max()) / TWIN_LR \
                    > worst["params_in_lr"]:
                worst["params_in_lr"] = float(excess.max()) / TWIN_LR
                worst_leaf = path
        zero = [path for path, g in c_g.items() if float(g.abs().max()) == 0]
        require(max(worst.values()) <= TWIN_TOL and not zero,
                f"train twin {cfg.name}: card vs cpu relative error {worst} "
                f"(params: {worst_leaf}), zero gradient leaves {zero[:4]}")
        require(len(c_moe) == len(g_moe)
                and all(torch.equal(a, b) for a, b in zip(c_moe, g_moe)),
                f"train twin {cfg.name}: expert choices differ "
                f"({len(g_moe)} / {len(c_moe)} MoE calls)")
        numbers = {"max_rel_err": worst, "params_worst_leaf": worst_leaf,
                   "loss": g_loss,
                   "params_unheld_share": unsure / total,
                   "moe_calls_equal_choices": len(g_moe),
                   "flash_launches": g_n,
                   "encoder_leaves_nonzero": sum(
                       1 for p in c_g if p.startswith("enc_"))}
        print(f"train twin: {cfg.num_layers}-layer {cfg.name} float32 "
              f"(d_model {cfg.d_model}), B={batch} S={seq}, one step card "
              f"vs cpu: " + json.dumps(numbers), flush=True)
        return numbers

    def sharded(self, card: str):
        """Phase 20: the sharded engines (``repro_torch.core.*_sharded``)
        in (a) a world of 1 on NCCL, in this process, and (b)
        ``SHARDED_WORLD`` spawned ranks on gloo, all on cuda:0, each rank
        running :func:`sharded_work` (checks, launch counts, warm times).
        The kernels are built (phase 1) before the ranks are spawned, so
        they load the built library and never race one build."""
        import datetime

        import torch.distributed as dist
        import torch.multiprocessing as mp

        torch = self.torch
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(
                                    seconds=SHARDED_TIMEOUT_S))
        try:
            one = [sharded_work(torch, 1, 0, single=True)]
        finally:
            dist.destroy_process_group()
        self.phase_ms["phase 20 (a) world of 1"] = \
            (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        out = ROOT / "build" / "sharded"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        torch.cuda.empty_cache()
        try:
            mp.start_processes(sharded_rank,
                               args=(SHARDED_WORLD, _free_port(), str(out)),
                               nprocs=SHARDED_WORLD, join=True,
                               start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            raise SmokeFailure(f"phase 20 (b): a rank failed: {exc}") from exc
        four = [json.loads((out / f"rank{r}.json").read_text())
                for r in range(SHARDED_WORLD)]
        self.phase_ms[f"phase 20 (b) world of {SHARDED_WORLD}"] = \
            (time.perf_counter() - t1) * 1e3
        self.sharded_launches = {}
        for rec in one + four:
            for name, count in rec["launches"].items():
                self.sharded_launches[name] = \
                    self.sharded_launches.get(name, 0) + count
        single = one[0]["single_ms"]
        for label, ranks in (("(a) world of 1, NCCL", one),
                             (f"(b) world of {SHARDED_WORLD}, gloo, all on "
                              "cuda:0 (the ranks share one card's SMs: the "
                              "times measure the collectives and the padding, "
                              "not scaling)", four)):
            rec = ranks[0]
            ms = {k: [round(r["ms"][k], 4) for r in ranks] for k in rec["ms"]}
            for k, v in rec["ms"].items():
                self.phase_ms[f"phase 20 {label[:3]} {k}"] = v
            print(f"phase 20 {label}: K={rec['k']} (full size A) on "
                  f"sbm/rank_count_sharded, CPU twins equal; bf_count_sharded "
                  f"K={rec['k_bf']} (n=m={SURFACE_N}, alpha="
                  f"{SURFACE_ALPHA:g}); enumerate pair set == sbm_enumerate, "
                  f"capped at {SHARDED_CAP} a shard: {rec['holes']} holes, "
                  f"rows == uncapped and == CPU twin; bitmatrix (a) words == "
                  f"bitmatrix_words, K={rec['k_bitmatrix']}; K={rec['k_wide']}"
                  f" past 2**31; launches per rank {rec['launches']}; warm "
                  f"median ms of {SHARDED_REPS} calls per rank: "
                  + json.dumps(ms) + "; single-device ms (world of 1): "
                  + json.dumps({k: round(v, 4) for k, v in single.items()}),
                  flush=True)
        self.phase_ms["phase 20 (sharded)"] = (time.perf_counter() - t0) * 1e3
        print(f"phase 20: {time.perf_counter() - t0:.3f} s", flush=True)
        print(card, flush=True)

    def model_parallel(self, card: str, cards: bool = False):
        """Phase 21: model-side parallelism.  (a) A world of 1 on NCCL in
        this process: ``Model(cfg, sharder)`` on a (1, 1) mesh equals
        ``Model(cfg)`` bit for bit at full width; then the one-rank
        references of (b) and (c).  (b)-(e) in ``MP_WORLD`` spawned gloo
        ranks on cuda:0 (:func:`model_parallel_work`); with ``cards``,
        NCCL ranks on ``MP_WORLD`` cards."""
        import datetime
        import gc

        import torch.distributed as dist
        import torch.multiprocessing as mp

        torch = self.torch
        t0 = time.perf_counter()
        out = ROOT / "build" / "phase21"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        torch.cuda.empty_cache()
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(
                                    seconds=MP_TIMEOUT_S))
        try:
            refs = self.mp_world_of_one(out)
        finally:
            dist.destroy_process_group()
        torch.save(refs, out / "refs.pt")
        del refs
        gc.collect()
        torch.cuda.empty_cache()
        self.phase_ms["phase 21 (a) world of 1 and references"] = \
            (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        try:
            mp.start_processes(model_parallel_rank,
                               args=(MP_WORLD, _free_port(), str(out),
                                     cards),
                               nprocs=MP_WORLD, join=True,
                               start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            raise SmokeFailure(f"phase 21: a rank failed: {exc}") from exc
        ranks = [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(MP_WORLD)]
        self.phase_ms[f"phase 21 (b)-(e) world of {MP_WORLD}"] = \
            (time.perf_counter() - t1) * 1e3
        self.mp_launches = sum(sum(m["launches"] for m in r["b"].values())
                               for r in ranks)
        self.mp_check_checkpoint(out)
        rec = ranks[0]
        for mode, m in rec["b"].items():
            self.phase_ms[f"phase 21 (b) {MP_SERVE['arch']} prefill "
                          f"{mode}"] = m["ms"]
            moved = [i for i, n in enumerate(m["routing_moved"]) if n]
            print(f"phase 21 (b) {MP_SERVE['arch']} model 4, moe_impl "
                  f"{mode} (runs {m['mode']}): prefill "
                  f"{MP_SERVE['rows']} x {MP_SERVE['prompt_len']} ms per "
                  f"rank {[r['b'][mode]['ms'] for r in ranks]}; last "
                  f"logits max |diff| from one rank {m['rel']:.3e}, from "
                  f"the float32 run {m['err']:.3e} (bound {m['bound']}; one "
                  f"rank's {m['err_one']:.3e}), relative to the float32 "
                  f"logits' max; layers whose MoE output differs between "
                  f"the model ranks: {m['layers_differing_between_ranks']}; "
                  f"tokens whose experts differ from one "
                  f"rank's: {sum(m['routing_moved'])} over layers {moved} "
                  f"(from the float32 run's: "
                  f"{sum(m['routing_moved_float32'])}; one rank's from it: "
                  f"{sum(rec['ref_routing_moved_float32'])}); greedy tokens "
                  f"equal {m['tokens_equal']} of {MP_SERVE['rows']} (with "
                  f"a float32 margin above twice the errors: "
                  f"{m['tokens_decided']}); drop "
                  f"fraction (mean of the layers) {m['drop']:.5f} (one "
                  f"rank {rec['ref_drop']:.5f}); flash launches per rank "
                  f"{[r['b'][mode]['launches'] for r in ranks]}; float32 "
                  f"2-layer twin rel {rec['twin_b'][mode]:.3e}", flush=True)
            traffic = [r["b"][mode]["traffic"] for r in ranks]
            print(f"phase 21 (b) {mode}: the prefill's collectives per "
                  "rank (record_traffic; kind: counts, wire bytes of ranks "
                  "0-3) " + "; ".join(
                      f"{k}: {[t[k]['count'] for t in traffic]}, "
                      f"{[t[k]['wire_bytes'] for t in traffic]}"
                      for k in sorted({k for t in traffic for k in t})),
                  flush=True)
        print(f"phase 21 (b) control: {MP_CONTROL_MODE} with rank 0's "
              f"partial left out of every layer's reduction, last logits "
              f"{rec['b_control']:.3e} from the float32 run (above the "
              f"bound {MP_BF16_ERR_BOUND})", flush=True)
        self.mp_flash_err = max(r["flash_err"] for r in ranks)
        print(f"phase 21 (b) flash kernel at each rank's launch shapes "
              f"(B={MP_SERVE['rows']}, 6 q / 2 KV heads, S="
              f"{MP_SERVE['prompt_len']}, D=64, bf16, causal) == plain == "
              f"dense oracle within flash_full_tol; max |kernel - plain| "
              f"{self.mp_flash_err:.4g}", flush=True)
        layer = rec["layer"]
        print(f"phase 21 (b) one MoE layer at full width, bf16 error "
              f"against float64 of the same bins (relative to its max): one "
              f"rank {layer['one']:.3e}; "
              + ", ".join(f"{m} {layer[m]:.3e} (control "
                          f"{layer[m + ' control']:.3e})"
                          for m in MP_SERVE["modes"])
              + f"; bound {MP_LAYER_RATIO} x one rank's", flush=True)
        c = rec["c"]
        self.phase_ms["phase 21 (c) train step (median)"] = c["step_ms"]
        print(f"phase 21 (c) {MP_TRAIN['arch']} data 2 x model 2, "
              f"{MP_TRAIN['batch']} x {MP_TRAIN['seq']}: losses "
              f"{c['losses']} (one rank {c['ref_losses']}, max rel diff "
              f"{c['loss_rel']:.3e}, bound {MP_LOSS_BOUND}; a step apart "
              f"{c['loss_shifted']:.3e}); step ms "
              f"{c['step_times_ms']}; float32 2-layer twin: loss rel "
              f"{c['twin_loss_rel']:.3e}, worst gradient leaf rel "
              f"{c['twin_grad_rel']:.3e} ({c['twin_worst_leaf']}); the "
              f"step-{MP_TRAIN['ckpt_every']} checkpoint restores in a "
              "world of 1 bit for bit; each rank's bytes in the FSDP layout "
              f"(counted from its blocks): params {c['bytes']['params']}, "
              f"bf16 moments {c['bytes']['moments']} (the replicated "
              f"layout: {c['bytes']['replicated_params']}, "
              f"{c['bytes']['replicated_moments']})",
              flush=True)
        d = rec["d"]
        print(f"phase 21 (d) context parallel at gemma2-2b's shapes "
              f"(B={MP_CP['B']}, H={MP_CP['H']}, KV={MP_CP['KV']}, "
              f"S={MP_CP['S']}, D={MP_CP['D']}, s_l = "
              f"{MP_CP['S'] // MP_WORLD}): ring max |diff| "
              f"{max(r['d']['ring_err'] for r in ranks):.3e}, halo (window "
              f"{MP_CP['window']}, softcap {MP_CP['softcap']}) "
              f"{max(r['d']['halo_err'] for r in ranks):.3e} (tol "
              f"{MP_CP_TOL}); ms ring {d['ring_ms']:.3f}, halo "
              f"{d['halo_ms']:.3f}", flush=True)
        e = rec["e"]
        print(f"phase 21 (e) compressed_psum of {MP_COMP_N} floats over "
              f"{MP_WORLD} ranks: identical on every rank, max |out - "
              f"mean| {e['max_err']:.3e} (int8 bound {e['bound']:.3e}); "
              f"{e['ms']:.3f} ms", flush=True)
        for key in ("ring_ms", "halo_ms"):
            self.phase_ms[f"phase 21 (d) {key}"] = d[key]
        self.phase_ms["phase 21 (e) compressed_psum ms"] = e["ms"]
        self.phase_ms["phase 21 (model parallel)"] = \
            (time.perf_counter() - t0) * 1e3
        print(f"phase 21: {time.perf_counter() - t0:.3f} s", flush=True)
        print(card, flush=True)

    def mp_world_of_one(self, out) -> dict:
        """Phase 21 (a) and the one-rank references of (b) and (c), in a
        world of 1 (this process, NCCL)."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.launch import train as train_launcher
        from repro_torch.launch.mesh import make_elastic_mesh
        from repro_torch.models import Model, moe
        from repro_torch.models.api import iter_leaves
        from repro_torch.parallel.sharding import make_sharder
        from repro_torch.train.loop import value_and_grad

        torch = self.torch
        mesh = make_elastic_mesh(model_parallel=1, device=DEVICE)
        refs = {}
        rows, plen = MP_SERVE["rows"], MP_SERVE["prompt_len"]
        for arch, seed in (("smollm-360m", MP_SMOLLM_SEED),
                           (MP_SERVE["arch"], MP_SERVE["seed"])):
            cfg = get_config(arch)
            plain = Model(cfg, device=DEVICE)
            sharded = Model(cfg, sharder=make_sharder(cfg, mesh),
                            device=DEVICE)
            params = plain.init(torch.Generator(DEVICE).manual_seed(seed))
            toks = torch.randint(1, cfg.vocab_size, (rows, plen),
                                 generator=torch.Generator().manual_seed(
                                     seed)).to(self.dev)
            drops, choices, real = [], [], moe.moe_layer

            def counted(*args, **kwargs):
                res = real(*args, **kwargs)
                drops.append(res[1]["moe_drop_fraction"])
                return res
            moe.moe_layer = counted
            try:
                with recorded_choices(moe, choices):
                    _, want = plain.prefill(params, {"tokens": toks},
                                            plain.init_cache(rows, plen + 8))
                ref_drop = float(torch.stack(drops).mean()) if drops \
                    else 0.0
                self.flash.launches = 0
                _, got = sharded.prefill(params, {"tokens": toks},
                                         sharded.init_cache(rows, plen + 8))
                torch.cuda.synchronize()
            finally:
                moe.moe_layer = real
            require(torch.equal(got, want) and bool(torch.isfinite(
                want[..., :cfg.vocab_size]).all()),
                    f"phase 21 (a) {arch}: Model(cfg, sharder) on a (1, 1) "
                    "mesh != Model(cfg) bit for bit, or not finite")
            require(self.flash.launches == attention_layers(cfg),
                    f"phase 21 (a) {arch}: flash launches "
                    f"{self.flash.launches} != {attention_layers(cfg)}")
            print(f"phase 21 (a) {arch} world of 1, mesh (1, 1): prefill "
                  f"{rows} x {plen} of Model(cfg, sharder) == Model(cfg) "
                  "bit for bit", flush=True)
            if arch == MP_SERVE["arch"]:
                exact, choices32 = self.mp_float32_logits(cfg, params, toks)
                refs["serve"] = {
                    "tokens": toks.cpu(), "logits": want.cpu(),
                    "float32": exact, "drop": ref_drop,
                    "choices": [c.cpu() for c in choices],
                    "choices_float32": choices32,
                    "routing_moved_float32": choice_diffs(choices,
                                                          choices32)}
            del params, plain, sharded, want, got
            torch.cuda.empty_cache()

        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cfg = dataclasses.replace(get_config(MP_SERVE["arch"]),
                                      num_layers=MP_TWIN["layers"],
                                      dtype=torch.float32)
            model = Model(cfg, device=DEVICE)
            params = model.init(torch.Generator(DEVICE).manual_seed(
                MP_TWIN["seed"]))
            toks = torch.randint(1, cfg.vocab_size,
                                 (MP_TWIN["rows"], MP_TWIN["seq"]),
                                 generator=torch.Generator().manual_seed(
                                     MP_TWIN["seed"])).to(self.dev)
            _, want = model.prefill(params, {"tokens": toks}, model.init_cache(
                MP_TWIN["rows"], MP_TWIN["seq"] + 8))
            refs["serve_twin"] = {"tokens": toks.cpu(), "logits": want.cpu()}
            del model, params
            cfg = dataclasses.replace(get_config(MP_TRAIN["arch"]),
                                      num_layers=MP_TWIN["layers"],
                                      dtype=torch.float32)
            model = Model(cfg, device=DEVICE)
            params = model.init(torch.Generator(DEVICE).manual_seed(
                MP_TWIN["seed"]))
            batch = mp_twin_batch(torch, cfg)
            (loss, _), grads = value_and_grad(model, params, batch)
            refs["train_twin"] = {
                "loss": float(loss),
                "grads": {p: g.cpu() for p, g in iter_leaves(grads)}}
            del model, params, grads
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.cuda.empty_cache()

        loop = train_launcher.main(mp_train_argv(out / "ck1"))
        refs["train"] = {"losses": [h["loss"] for h in loop.history]}
        del loop
        return refs

    def mp_float32_logits(self, cfg, params, toks):
        """Phase 21 (b)'s yardstick: the logits of ``cfg`` computed in
        float32 (TF32 off) on the same weights, and its expert choices a
        layer (both on the host)."""
        import dataclasses

        from repro_torch.models import Model, moe

        torch = self.torch
        c = dataclasses.replace(cfg, dtype=torch.float32)
        model = Model(c, device=DEVICE)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        choices = []
        try:
            with recorded_choices(moe, choices):
                _, logits = model.prefill(params, {"tokens": toks},
                                          model.init_cache(toks.shape[0],
                                                           toks.shape[1] + 8))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return logits.cpu(), [c.cpu() for c in choices]

    def mp_check_checkpoint(self, out):
        """Phase 21 (c): the step-``ckpt_every`` checkpoint of the world of
        4 (gathered, rank 0's) has the layout the world of 1 wrote and
        restores in a world of 1 to its arrays bit for bit."""
        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.models import Model
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train.optimizer import AdamW, constant_schedule

        torch = self.torch
        step = MP_TRAIN["ckpt_every"]
        four = out / "ck4" / f"step_{step:08d}"
        one = out / "ck1" / f"step_{step:08d}"
        layout = [{k: json.loads((d / "meta.json").read_text())[k]
                   for k in ("paths", "shapes", "dtypes")}
                  for d in (four, one)]
        require(layout[0] == layout[1], "phase 21 (c): the world of 4's "
                "checkpoint layout != the world of 1's")
        cfg = get_config(MP_TRAIN["arch"])
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        restored, meta = ckpt.restore_checkpoint(
            four, {"params": params,
                   "opt_state": AdamW(constant_schedule(1.0)).init(params)})
        with np.load(four / "arrays.npz") as z:
            saved = [z[f"a{i}"] for i in range(len(layout[0]["paths"]))]
        host = ckpt.host_copy(restored)
        require(meta["step"] == step and [p for p, _ in host]
                == layout[0]["paths"] and all(
                    np.array_equal(arr.reshape(-1).view(np.uint8),
                                   want.reshape(-1).view(np.uint8))
                    for (_, (arr, _)), want in zip(host, saved)),
                "phase 21 (c): the world of 4's checkpoint does not restore "
                "in a world of 1 bit for bit")

    # -- phase 22: the harness, the dry run and the examples ---------------
    def harness(self, card: str):
        """Phase 22: (a) the fuzz and the scaled corpus, (b) the
        self-check and its artifact, (c) the metamorphic relations and the
        batch split, all on the card in this process, while (d) the dry
        run's cells (host only) and (e) the example twins run as
        subprocesses; every subprocess is stopped before the phase ends."""
        t0 = time.perf_counter()
        jobs = self.start_host_jobs()
        try:
            self.harness_fuzz()
            self.harness_self_check()
            self.harness_relations()
            self.harness_dryrun(jobs)
            self.harness_examples(jobs)
        finally:
            for proc, _, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        secs = time.perf_counter() - t0
        self.phase_ms["phase 22"] = secs * 1e3
        print(f"phase 22: {secs:.3f} s", flush=True)
        print(card, flush=True)

    def start_host_jobs(self) -> dict:
        """Start (d) and (e): {name: (process, log path, command)}."""
        logs = ROOT / "build" / "phase22"
        shutil.rmtree(logs, ignore_errors=True)
        logs.mkdir(parents=True)
        # one host thread each: the jobs share the host with (a)-(c)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        host_env = dict(env, CUDA_VISIBLE_DEVICES="")   # the dry run: no card
        jobs = {}

        def start(name, argv, job_env):
            log = logs / f"{name}.log"
            with open(log, "w") as fh:
                proc = subprocess.Popen(argv, cwd=ROOT, env=job_env,
                                        stdout=fh, stderr=subprocess.STDOUT)
            jobs[name] = (proc, log, argv)

        for arch, shape, mesh in DRYRUN_CELLS:
            start(f"dryrun_{mesh}_{arch}_{shape}",
                  [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", str(logs / "dryrun")], host_env)
        for script, *args in EXAMPLES:
            if script == "quickstart_torch.py":
                args = args + ["--ckpt-dir", str(logs / "quickstart_ckpt")]
            start(script[:-3], [sys.executable, str(ROOT / "examples" / script),
                                *args], env)
        return jobs

    @staticmethod
    def finish(job, timeout: float) -> str:
        """Wait for a job; its output; fails unless it exited 0."""
        proc, log, argv = job
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        text = log.read_text()
        require(proc.returncode == 0,
                f"{' '.join(argv[1:])} exited {proc.returncode}: "
                f"{text[-3000:]}")
        return text

    def harness_fuzz(self):
        """(a) ``run_fuzz`` on ``cuda`` over ``FUZZ_SEEDS`` seeds, then each
        corpus at its ``FUZZ_SCALED`` size through every registered
        engine; zero failures, and the sweep's delta-bitmask and pass-C
        kernels and the bit-matrix kernel launched (counts zeroed just
        before, read just after)."""
        import numpy as np

        from repro_torch.testing import conformance, fuzz, oracles

        torch = self.torch
        t0 = time.perf_counter()
        for w in self.wrappers:
            w.launches = 0
        checks, failures = fuzz.run_fuzz(FUZZ_SEEDS, smoke=False,
                                         verbose=False, device=DEVICE)
        require(not failures, "(a) fuzz: " + "; ".join(
            str(f) for f in failures[:3]))
        t_fuzz = time.perf_counter() - t0
        scaled = {}
        for k, (corpus, n, d) in enumerate(FUZZ_SCALED):
            rng = np.random.RandomState(SEED + 220 + k)
            subs, upds = fuzz.CORPUS[corpus](rng, n, n, d, device=DEVICE)
            want = oracles.reference_pairs(subs, upds)
            engines = conformance.engines_for(subs.ndim_space)
            for engine in engines:
                mm = conformance.check_engine(engine, subs, upds, want=want)
                require(mm is None, f"(a) scaled {corpus} n=m={n} d={d}: "
                        f"{mm and mm.describe()}")
            scaled[corpus] = dict(n=n, d=subs.ndim_space, pairs=len(want),
                                  engines=len(engines))
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in self.wrappers}
        self.harness_launches = launches
        require(all(launches[name] > 0 for name in FUZZ_MUST_LAUNCH),
                f"(a) a kernel of the harness's engines did not launch: "
                f"{launches}")
        secs = time.perf_counter() - t0
        self.phase_ms["phase 22 (a) fuzz"] = secs * 1e3
        print(f"phase 22 (a) fuzz on the card: {FUZZ_SEEDS} seeds, {checks} "
              f"checks, 0 failures in {t_fuzz:.3f} s; scaled corpus through "
              f"every engine: {json.dumps(scaled)}; {secs:.3f} s in all; "
              f"launches {json.dumps(launches)}", flush=True)

    def harness_self_check(self):
        """(b) ``self_check(device="cuda")`` catches the injected tie bug
        and shrinks it to at most 6 regions; the shrunk workload's pytest
        snippet on the card passes for every registered engine of its
        dimension and fails for the broken engine."""
        import dataclasses

        from repro_torch.testing import conformance, fuzz

        t0 = time.perf_counter()
        arts = []
        rc = fuzz.self_check(verbose=False, device=DEVICE, artifact=arts)
        require(rc == 0 and arts, f"(b) self-check returned {rc}")
        best = arts[0]
        broken = fuzz.broken_open_interval_engine()

        def run_snippet(engine):
            code = dataclasses.replace(best, engine=engine).to_pytest(DEVICE)
            ns = {}
            exec(compile(code, f"<repro {engine}>", "exec"), ns)
            next(v for k, v in ns.items() if k.startswith("test_repro_"))()

        engines = [e.name for e in conformance.engines_for(best.dims)]
        for name in engines:
            run_snippet(name)
        conformance.register(broken)
        try:
            try:
                run_snippet(broken.name)
            except AssertionError:
                pass
            else:
                raise SmokeFailure("(b) the shrunk repro's snippet passes "
                                   "on the broken engine")
        finally:
            conformance.unregister(broken.name)
        secs = time.perf_counter() - t0
        self.phase_ms["phase 22 (b) self-check"] = secs * 1e3
        print(f"phase 22 (b) self-check on the card: the injected tie bug "
              f"caught and shrunk to {best.region_count()} regions (d = "
              f"{best.dims}); its snippet passes for {len(engines)} engines "
              f"and fails for the broken one; {secs:.3f} s", flush=True)

    def harness_relations(self):
        """(c) Every metamorphic relation for every engine on integer-grid
        workloads at d = 1, 2, 3 and the batch split for every churn
        implementation at d = 1, 2, on ``cuda``."""
        import numpy as np

        from repro_torch.testing import conformance, fuzz, metamorphic

        t0 = time.perf_counter()
        rng = np.random.RandomState(SEED + 230)
        held = 0
        for d in (1, 2, 3):
            lo_s = rng.randint(0, 10, (d, 40)).astype(np.float32)
            lo_u = rng.randint(0, 10, (d, 30)).astype(np.float32)
            hi_s = (lo_s + rng.randint(0, 4, (d, 40))).astype(np.float32)
            hi_u = (lo_u + rng.randint(0, 4, (d, 30))).astype(np.float32)
            if d == 1:
                lo_s, hi_s, lo_u, hi_u = lo_s[0], hi_s[0], lo_u[0], hi_u[0]
            subs, upds = self.extents(lo_s, hi_s), self.extents(lo_u, hi_u)
            for engine in conformance.engines_for(d):
                v = metamorphic.check_relations(engine.pairs, subs, upds)
                require(v == [], f"(c) {engine.name} d={d}: "
                        f"{[str(x) for x in v]}")
                held += 1
        for impl in conformance.CHURN_IMPLS:
            for dims in (1, 2):
                script = fuzz.random_script(rng, dims, batches=2, max_ops=6)
                v = metamorphic.check_batch_split(dims, script[0], script[1],
                                                  impl=impl, device=DEVICE)
                require(v is None, f"(c) batch split {impl} d={dims}: {v}")
        secs = time.perf_counter() - t0
        self.phase_ms["phase 22 (c) relations"] = secs * 1e3
        print(f"phase 22 (c) on the card: {len(metamorphic.STATELESS_RELATIONS)}"
              f" relations hold for {held} (engine, d) pairs; the batch split "
              f"holds for {list(conformance.CHURN_IMPLS)} at d = 1, 2; "
              f"{secs:.3f} s", flush=True)

    def harness_dryrun(self, jobs: dict):
        """(d) The dry run's cells, each traced in its own process with no
        card visible: every cell's JSON written, its trace seconds and
        each rank's bytes printed; and the one-card argument bytes of
        phase 19's training configuration below phase 19's measured peak
        memory."""
        from repro_torch.configs import ShapeDef, get_config
        from repro_torch.launch.dryrun import argument_bytes
        from repro_torch.parallel.sharding import MeshShape

        t0 = time.perf_counter()
        cells = {}
        for arch, shape, mesh in DRYRUN_CELLS:
            tag = f"{mesh}_{arch}_{shape}"
            self.finish(jobs[f"dryrun_{tag}"], DRYRUN_TIMEOUT_S)
            path = ROOT / "build" / "phase22" / "dryrun" / f"dryrun_{tag}.json"
            require(path.exists(), f"(d) {path.name} not written")
            rec = json.loads(path.read_text())
            require("error" not in rec and rec["cost"]["flops"] > 0,
                    f"(d) {tag}: {rec.get('error', rec.get('cost'))}")
            cells[tag] = {k: rec[k] for k in (
                "mesh", "devices", "trace_s", "args_bytes", "peak_live_bytes",
                "cost")}
            cells[tag]["analytic_total_flops_per_rank"] = \
                rec["analytic"]["total_flops"] / rec["devices"]
            cells[tag]["collective_wire_bytes"] = \
                rec["collectives"]["wire_bytes"]
            cells[tag]["collectives_by_op"] = rec["collectives"]["by_op"]
        t = TRAIN
        cfg = get_config(t["arch"])
        one = argument_bytes(cfg, ShapeDef("phase19", t["seq"], t["batch"],
                                           "train"),
                             MeshShape((1, 1), ("data", "model")))
        peak = getattr(self, "train_numbers", {}).get("peak_memory_bytes")
        require(peak is not None and one["total"] < peak,
                f"(d) one-card argument bytes {one} not below phase 19's "
                f"peak {peak}")
        secs = time.perf_counter() - t0
        self.phase_ms["phase 22 (d) dry run (wait)"] = secs * 1e3
        self.dryrun_cells = cells
        print(f"phase 22 (d) dry run on the host: {json.dumps(cells)}; "
              f"{t['arch']} B={t['batch']} S={t['seq']} on one card: "
              f"argument bytes {json.dumps(one)} < phase 19 peak {peak}",
              flush=True)

    def harness_examples(self, jobs: dict):
        """(e) The three example twins on the card: each exits 0; the
        quickstart's loss falls; the serving example serves every
        request."""
        t0 = time.perf_counter()
        outs = {script[:-3]: self.finish(jobs[script[:-3]], EXAMPLE_TIMEOUT_S)
                for script, *_ in EXAMPLES}
        require(outs["ddm_service_torch"].rstrip().endswith("OK"),
                "(e) ddm_service_torch did not finish")
        m = re.search(r"loss ([0-9.]+) -> ([0-9.]+)",
                      outs["quickstart_torch"])
        require(m is not None and float(m.group(2)) < float(m.group(1)),
                f"(e) quickstart_torch: the loss did not fall "
                f"({m and m.group(0)})")
        require("all requests served" in outs["interest_serving_torch"],
                "(e) interest_serving_torch did not serve every request")
        table = [line for line in outs["ddm_service_torch"].splitlines()
                 if re.match(r"\s+[0-9.]+\s+\d+\s", line)]
        secs = time.perf_counter() - t0
        self.phase_ms["phase 22 (e) examples (wait)"] = secs * 1e3
        print(f"phase 22 (e) example twins on the card: ddm_service_torch "
              f"(alpha, K, SBM / rank / BF ms) {json.dumps(table)}; "
              f"quickstart_torch {m.group(0)}; interest_serving_torch served "
              f"every request", flush=True)

    # -- phase 23: the run-time layout is the JAX shard layout -----------
    def layout(self, card: str):
        """Phase 23: (a) mamba2-2.7b tensor-parallel over its heads and
        (b) smollm-360m trained in the FSDP layout, in ``MP_WORLD``
        spawned gloo ranks on cuda:0 (:func:`layout_work`) against one
        rank's runs made here first (:meth:`layout_refs`); (c) the dry
        run's cells of phase 22 (d) against the replicated layout's bytes a
        rank."""
        import torch.multiprocessing as mp

        torch = self.torch
        t0 = time.perf_counter()
        out = ROOT / "build" / "phase23"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        torch.cuda.empty_cache()
        self.layout_refs(out)
        self.phase_ms["phase 23 one-rank references"] = \
            (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        try:
            mp.start_processes(layout_rank,
                               args=(MP_WORLD, _free_port(), str(out)),
                               nprocs=MP_WORLD, join=True,
                               start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            raise SmokeFailure(f"phase 23: a rank failed: {exc}") from exc
        ranks = [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(MP_WORLD)]
        self.phase_ms[f"phase 23 (a), (b) world of {MP_WORLD}"] = \
            (time.perf_counter() - t1) * 1e3
        a = ranks[0]["a"]
        m = LAYOUT_MAMBA
        print(f"phase 23 (a) {m['arch']} (data 1, model {MP_WORLD}), "
              f"{a['heads']} of {a['heads_whole']} heads a rank: bf16 prefill "
              f"{m['rows']} x {m['prompt_len']} + {m['steps']} decode steps, "
              f"ms per rank {[r['a']['ms'] for r in ranks]}, greedy tokens "
              f"the same on every rank ({a['tokens_equal']} of {a['tokens']} "
              f"equal to one rank's), logits against one rank's float32 run "
              f"{a['err_bf16']:.3e} (one rank's bf16 {a['err_bf16_one']:.3e}"
              f"); float32 (TF32 off) against one rank's float32 run, "
              f"relative to its max: logits (max over the prefill and the "
              f"steps) per rank {[r['a']['err'] for r in ranks]}, "
              f"MambaState.h after the prefill per rank "
              f"{[r['a']['h_err'] for r in ranks]}, bound {LAYOUT_F32_TOL}; "
              f"control (rank 0's partial left out of every Mamba layer's "
              f"reduce_from) {[r['a']['control'] for r in ranks]}; params a "
              f"rank {[r['a']['param_bytes'] for r in ranks]} B (whole "
              f"{a['param_bytes_whole']}); peak allocated a rank "
              f"{[r['a']['peak_bytes'] for r in ranks]} B; float32 "
              f"{LAYOUT_TWIN['layers']}-layer twin: {a['twin_replicated']} "
              "leaves replicated over the model axis, their gradients the "
              "same bits on every model rank", flush=True)
        b = ranks[0]["b"]
        print(f"phase 23 (b) {MP_TRAIN['arch']} (data {LAYOUT_DATA}, model "
              f"1), {MP_TRAIN['batch']} x {MP_TRAIN['seq']}, "
              f"{MP_TRAIN['steps']} steps: losses {b['losses']} (one rank "
              f"{b['ref_losses']}), gradient norms {b['grad_norms']} (one "
              f"rank {b['ref_grad_norms']}), max rel diff "
              f"{b['loss_rel']:.3e}, bound {MP_LOSS_BOUND}; control (data "
              f"rank 0's partial left out of every reduce-scatter) "
              f"{b['control']:.3e}; step ms "
              f"{b['step_times_ms']}; params / bf16 moments a rank "
              f"{[r['b']['param_bytes'] for r in ranks]} / "
              f"{[r['b']['moment_bytes'] for r in ranks]} B (replicated "
              f"{b['param_bytes_whole']} / {b['moment_bytes_whole']}); peak "
              f"allocated a rank {[r['b']['peak_bytes'] for r in ranks]} B; "
              f"flash launches a rank {[r['b']['launches'] for r in ranks]}",
              flush=True)
        self.phase_ms["phase 23 (b) train step (median)"] = b["step_ms"]
        self.layout_launches = sum(r["b"]["launches"] for r in ranks)
        self.layout_dryrun()
        self.phase_ms["phase 23"] = (time.perf_counter() - t0) * 1e3
        print(f"phase 23: {time.perf_counter() - t0:.3f} s", flush=True)
        print(card, flush=True)

    def layout_refs(self, out):
        """Phase 23's one-rank runs, in this process: (a) mamba2-2.7b's
        bf16 prefill and decode steps (fed its own greedy tokens) and the
        float32 run of the same weights fed the same tokens, their logits
        and the float32 run's states after the prefill; (b) the training
        launcher's losses and gradient norms in a world of 1."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.launch import train as train_launcher
        from repro_torch.models import Model

        torch = self.torch
        m = LAYOUT_MAMBA
        cfg = get_config(m["arch"])
        rows, plen, steps, vocab = m["rows"], m["prompt_len"], m["steps"], \
            cfg.vocab_size
        params = Model(cfg, device=DEVICE).init(
            torch.Generator(DEVICE).manual_seed(m["seed"]))
        toks = torch.randint(1, vocab, (rows, plen),
                             generator=torch.Generator().manual_seed(
                                 m["seed"])).to(self.dev)
        refs, states = {"tokens": toks.cpu()}, {}
        tf32 = torch.backends.cuda.matmul.allow_tf32
        feed = None
        for name, dtype in (("one", cfg.dtype), ("float32", torch.float32)):
            model = Model(dataclasses.replace(cfg, dtype=dtype),
                          device=DEVICE)
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                logits, h, fed = mamba_run(torch, model, params, toks, steps,
                                           feed)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            feed = fed if feed is None else feed
            refs[name] = logits.cpu()
            states[name] = h.cpu()
            del model, logits, h
            torch.cuda.empty_cache()
        refs["feed"] = feed.cpu()
        torch.save(states["float32"], out / "h_float32.pt")
        del states, params
        torch.cuda.empty_cache()
        loop = train_launcher.main(mp_train_argv(out / "ck1"))
        refs["train"] = [h["loss"] for h in loop.history]
        refs["train_norms"] = [h["grad_norm"] for h in loop.history]
        del loop
        torch.cuda.empty_cache()
        torch.save(refs, out / "refs.pt")

    def layout_dryrun(self):
        """Phase 23 (c): phase 22 (d)'s cells, arguments and peak live
        bytes a rank at or below the replicated layout's."""
        cells = getattr(self, "dryrun_cells", None)
        if cells is None:
            print("phase 23 (c): no phase 22 (d) cells in this run",
                  flush=True)
            return
        for tag, (args, peak) in DRYRUN_REPLICATED.items():
            rec = cells[tag]
            got = (rec["args_bytes"]["total"], rec["peak_live_bytes"])
            require(got[0] <= args and got[1] <= peak,
                    f"phase 23 (c) {tag}: arguments {got[0]}, peak "
                    f"{got[1]} B a rank above the replicated layout's "
                    f"{args}, {peak}")
            print(f"phase 23 (c) dry run {tag}: arguments a rank {got[0]} B "
                  f"(params {rec['args_bytes']['params']}, moments "
                  f"{rec['args_bytes']['moments']}, cache "
                  f"{rec['args_bytes']['cache']}), replicated {args}; peak "
                  f"live {got[1]} B, replicated {peak}; collectives "
                  f"{json.dumps(rec['collectives_by_op'])}", flush=True)

    def report(self, card: str):
        torch = self.torch
        self.rows["flash_attention"]["max_abs_err"] = self.err["flash_attention"]
        # launches on phase 20's path: passes A and B in the sharded count,
        # the bit-matrix kernel in the sharded bit-matrix (both worlds)
        for name in REPLACES:
            self.rows[name]["sharded_launches"] = \
                self.sharded_launches.get(name, 0)
        # launches on phase 21's path: the flash kernel on each rank's
        # local heads (row 6g's shapes cut over the model axis)
        for row in self.rows.values():
            row["model_parallel_launches"] = 0
        self.rows["flash_attention_granite"]["model_parallel_launches"] = \
            self.mp_launches
        self.rows["flash_attention_granite"]["model_parallel_max_abs_err"] = \
            self.mp_flash_err
        # launches on phase 23 (b)'s path: the flash kernel at smollm's
        # training shapes on each data rank's row (row 6j's kernel)
        for row in self.rows.values():
            row["layout_launches"] = 0
        self.rows["flash_attention_train"]["layout_launches"] = \
            self.layout_launches
        # launches in phase 22 (a): the fuzz and the scaled corpus on the
        # card (the wrappers' names are the rows' keys of the sweep and
        # bit-matrix kernels; the flash kernel's row is "flash_attention")
        for key, row in self.rows.items():
            row["harness_launches"] = self.harness_launches.get(
                "flash_attention_kernel" if key == "flash_attention"
                else key, 0)
        print(json.dumps({"kernels": list(self.rows.values())}))
        print("launches on the main path (bitmatch: the bitmatrix path at "
              "cell (a)): " + json.dumps(self.launches))
        print("launches on the d-dim service path: "
              + json.dumps(self.ddim_launches))
        print("launches on the serving path: "
              + json.dumps(self.serve_launches))
        print(f"flash at {SERVE_GEMMA['arch']} shapes: "
              + json.dumps(list(self.gemma_rows.values())))
        print(f"launches on the {SERVE_GEMMA['arch']} serving path: "
              + json.dumps(self.gemma_launches))
        for spec, launches in ((SERVE_GRANITE, self.granite_launches),
                               (SERVE_MAMBA, self.mamba_launches)):
            print(f"launches on the {spec['arch']} serving path: "
                  + json.dumps(launches))
        for spec, launches in ((SERVE_PHI3, self.phi3_launches),
                               (SERVE_SEAMLESS, self.seamless_launches)):
            print(f"launches in the {spec['arch']} prefills (two): "
                  + json.dumps(launches))
        print("launches in phase 14 (broker sessions; conformance battery): "
              + json.dumps([self.broker_launches, self.battery_launches]))
        print(f"launches on the {TRAIN['arch']} training run (phase 19, "
              f"{TRAIN['steps']} steps): " + json.dumps(self.train_launches))
        print("launches on the sharded path (phase 20, both worlds, every "
              "rank): " + json.dumps(self.sharded_launches))
        print("flash launches on the model-parallel path (phase 21 (b), "
              "every rank, every prefill): " + json.dumps(self.mp_launches))
        print("launches in phase 22 (a) (fuzz and scaled corpus on the "
              "card): " + json.dumps(self.harness_launches))
        print("flash launches on the FSDP training path (phase 23 (b), every "
              "rank): " + json.dumps(self.layout_launches))
        print("timings_ms: " + json.dumps(
            {k: round(v, 3) for k, v in self.phase_ms.items()}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phase 20 (b), one spawned rank: join the gloo world on cuda:0, run
    :func:`sharded_work` and save its record as ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=SHARDED_TIMEOUT_S))
    try:
        rec = sharded_work(torch, world, rank)
    finally:
        dist.destroy_process_group()
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))


def sharded_work(torch, world: int, rank: int, single: bool = False) -> dict:
    """Every rank of a phase-20 world: the five sharded engines on cuda:0
    over a 1-D mesh of the whole world, each held against its single-device
    engine on the card and against itself on CPU tensors (its plain twin,
    the same world); passes A and B, and the bit-matrix kernel, must launch
    once per call (counts zeroed just before, read just after); warm
    medians of ``SHARDED_REPS`` calls (host clock to a sync), and with
    ``single`` the single-device engines' too.  Returns the rank's record."""
    import statistics

    from repro_torch import core
    from repro_torch.core import ddim
    from repro_torch.core.intervals import Extents
    from repro_torch.kernels import bitmatch as B
    from repro_torch.kernels import ops
    from repro_torch.kernels import sbm_sweep as K
    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device(DEVICE)
    mesh = make_host_mesh(axis="p", device=DEVICE)
    tag = f"phase 20 world of {world} rank {rank}"
    rec = {"world": world, "rank": rank, "ms": {}, "single_ms": {},
           "launches": {"block_sums": 0, "emission": 0, "bitmatch": 0}}

    def sync():
        torch.cuda.synchronize()

    def counted(fn, wrappers, what):
        """One call with ``wrappers``' counts zeroed before and read after:
        each must have launched exactly once."""
        sync()
        for w in wrappers:
            w.launches = 0
        res = fn()
        sync()
        got = {w.__name__: w.launches for w in wrappers}
        require(all(v == 1 for v in got.values()),
                f"{tag}: {what} launches {got}, expected 1 each")
        for name, v in got.items():
            rec["launches"][name] += v
        return res

    def warm_ms(fn):
        fn()
        sync()
        times = []
        for _ in range(SHARDED_REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def host(e):
        return Extents(e.lo.cpu(), e.hi.cpu())

    def uniform(n, alpha, seed):
        g = torch.Generator().manual_seed(seed)
        return core.make_uniform_workload(n, n, alpha, length=LENGTH,
                                          generator=g, device=dev)

    # the count engines at full size A
    n, alpha = FULL[0]
    subs, upds = uniform(n, alpha, SEED)
    k = int(ops.sbm_count_kernel(subs, upds))
    require(int(core.rank_count(subs, upds)) == k,
            f"{tag}: single-device rank_count != sbm_count_kernel")
    got = counted(lambda: core.sbm_count_sharded(subs, upds, mesh, "p"),
                  (K.block_sums, K.emission), "sbm_count_sharded")
    twin = core.sbm_count_sharded(host(subs), host(upds), mesh, "p")
    require(got.device.type == dev.type and int(got) == k == int(twin),
            f"{tag}: sbm_count_sharded {int(got)} (CPU twin {int(twin)}) "
            f"!= K {k}")
    got = core.rank_count_sharded(subs, upds, mesh, "p")
    twin = core.rank_count_sharded(host(subs), host(upds), mesh, "p")
    require(int(got) == k == int(twin), f"{tag}: rank_count_sharded "
            f"{int(got)} (CPU twin {int(twin)}) != K {k}")
    rec["k"] = k
    rec["ms"]["sbm_count_sharded"] = warm_ms(
        lambda: core.sbm_count_sharded(subs, upds, mesh, "p"))
    rec["ms"]["rank_count_sharded"] = warm_ms(
        lambda: core.rank_count_sharded(subs, upds, mesh, "p"))

    # sbm_enumerate_sharded at full size A: max_pairs = K, then capped
    pairs, count = core.sbm_enumerate_sharded(subs, upds, mesh, "p",
                                              max_pairs=k)
    plain, _ = core.sbm_enumerate(subs, upds, max_pairs=k)
    require(int(count) == k and torch.equal(Smoke.pair_keys(pairs, n),
                                            Smoke.pair_keys(plain, n)),
            f"{tag}: sbm_enumerate_sharded count {int(count)} or pair set "
            "!= sbm_enumerate's")
    capped, c_count = core.sbm_enumerate_sharded(
        subs, upds, mesh, "p", max_pairs=k, max_pairs_per_shard=SHARDED_CAP)
    live = capped[:, 0] >= 0
    holes = int((~live).sum())
    require(int(c_count) == k and 0 < holes < k
            and torch.equal(capped[live], pairs[live]),
            f"{tag}: capped buffer: count {int(c_count)}, {holes} holes, or "
            "rows != the uncapped buffer's")
    for buf, cap in ((pairs, None), (capped, SHARDED_CAP)):
        t_pairs, t_count = core.sbm_enumerate_sharded(
            host(subs), host(upds), mesh, "p", max_pairs=k,
            max_pairs_per_shard=cap)
        require(int(t_count) == k and torch.equal(t_pairs, buf.cpu()),
                f"{tag}: sbm_enumerate_sharded (cap {cap}) on the CPU twin "
                "!= the card's, row for row")
    rec["holes"] = holes
    rec["ms"]["sbm_enumerate_sharded"] = warm_ms(
        lambda: core.sbm_enumerate_sharded(subs, upds, mesh, "p",
                                           max_pairs=k))

    # bf_count_sharded at phase 14's cell; its CPU twin on a subset
    bs, bu = uniform(SURFACE_N, SURFACE_ALPHA, SEED + 40)
    k_bf = int(core.rank_count(bs, bu))
    got = core.bf_count_sharded(bs, bu, mesh, "p", block=BF_BLOCK)
    part = (Extents(bs.lo[:BF_TWIN_N], bs.hi[:BF_TWIN_N]),
            Extents(bu.lo[:BF_TWIN_N], bu.hi[:BF_TWIN_N]))
    card_part = core.bf_count_sharded(*part, mesh, "p", block=BF_BLOCK)
    twin = core.bf_count_sharded(*map(host, part), mesh, "p", block=BF_BLOCK)
    require(int(got) == k_bf and int(card_part) == int(twin)
            == int(core.rank_count(*part)),
            f"{tag}: bf_count_sharded {int(got)} != K {k_bf}, or on "
            f"{BF_TWIN_N} a side {int(card_part)} != CPU twin {int(twin)}")
    rec["k_bf"] = k_bf
    rec["ms"]["bf_count_sharded"] = warm_ms(
        lambda: core.bf_count_sharded(bs, bu, mesh, "p", block=BF_BLOCK))

    # bitmatrix_sharded at bit-matrix cell (a)
    _, nb, d, alpha_b = BITMATCH_FULL[0]
    g = torch.Generator().manual_seed(SEED + 5)
    ts, tu = core.make_tall_thin_workload(nb, nb, alpha_b, length=LENGTH,
                                          d=d, wide_dim=0, generator=g,
                                          device=dev)
    words, count = counted(lambda: core.bitmatrix_sharded(ts, tu, mesh, "p"),
                           (B.bitmatch,), "bitmatrix_sharded")
    want = ddim.bitmatrix_words(ts, tu)
    k_b = int(ddim.bitmatrix_count(ts, tu))
    t_words, t_count = core.bitmatrix_sharded(host(ts), host(tu), mesh, "p")
    require(torch.equal(words, want) and int(count) == k_b == int(t_count)
            and torch.equal(t_words, words.cpu()),
            f"{tag}: bitmatrix_sharded words or K {int(count)} != "
            f"bitmatrix_words / bitmatrix_count {k_b} or the CPU twin")
    rec["k_bitmatrix"] = k_b
    rec["ms"]["bitmatrix_sharded"] = warm_ms(
        lambda: core.bitmatrix_sharded(ts, tu, mesh, "p"))

    # K past 2**31, exact
    wn, wm = WIDE_SHARDED
    ws = Extents(torch.zeros(wn, device=dev), torch.ones(wn, device=dev))
    wu = Extents(torch.full((wm,), 0.5, device=dev),
                 torch.full((wm,), 2.0, device=dev))
    wide = (int(counted(lambda: core.sbm_count_sharded(ws, wu, mesh, "p"),
                        (K.block_sums, K.emission), "sbm_count_sharded")),
            int(core.rank_count_sharded(ws, wu, mesh, "p")),
            int(core.sbm_enumerate_sharded(ws, wu, mesh, "p",
                                           max_pairs=16)[1]))
    require(wide == (wn * wm,) * 3, f"{tag}: K past 2**31 {wide} != "
            f"{wn * wm}")
    rec["k_wide"] = wn * wm

    if single:
        rec["single_ms"] = {
            "sbm_count_kernel": warm_ms(lambda: ops.sbm_count_kernel(subs,
                                                                     upds)),
            "rank_count": warm_ms(lambda: core.rank_count(subs, upds)),
            "sbm_enumerate": warm_ms(lambda: core.sbm_enumerate(
                subs, upds, max_pairs=k)),
            "bf_count": warm_ms(lambda: core.bf_count(bs, bu,
                                                      block=BF_BLOCK)),
            "bitmatrix_kernel": warm_ms(lambda: B.bitmatrix_kernel(ts, tu)),
        }
    return rec


class recorded_choices:
    """While active, ``moe.top_k`` appends each call's expert choices
    (uint8, on the device) to ``store``: one (B, S, k) tensor a layer."""

    def __init__(self, moe, store: list):
        self.moe, self.store, self.real = moe, store, moe.top_k

    def __enter__(self):
        real, store = self.real, self.store

        def top_k(probs, k):
            vals, idx = real(probs, k)
            store.append(idx.byte())
            return vals, idx
        self.moe.top_k = top_k

    def __exit__(self, *exc):
        self.moe.top_k = self.real


def choice_diffs(got, want) -> list:
    """Per MoE layer, the tokens whose set of experts differs."""
    return [int((a.cpu().sort(-1).values != b.cpu().sort(-1).values)
                .any(-1).sum()) for a, b in zip(got, want)]


class dropped_partial:
    """While active, ``moe.reduce_from`` over a non-empty group leaves out
    the model coordinate 0's partial: phase 21's controls, a fault the
    bounds must catch."""

    def __init__(self, moe, torch, midx: int):
        self.moe, self.real = moe, moe.reduce_from
        self.torch, self.midx = torch, midx

    def __enter__(self):
        real = self.real

        def reduce_from(x, groups):
            if groups and self.midx == 0:
                x = self.torch.zeros_like(x)
            return real(x, groups)
        self.moe.reduce_from = reduce_from

    def __exit__(self, *exc):
        self.moe.reduce_from = self.real


def mp_mode_config(cfg, mode: str):
    """``cfg`` as phase 21 (b) runs ``mode`` (``MP_SERVE["modes"]``)."""
    import dataclasses

    return dataclasses.replace(cfg, **MP_MODE_FIELDS.get(
        mode, {"moe_impl": mode}))


def mp_flash_check(torch, cfg, sharder, rows: int, plen: int) -> float:
    """Phase 21 (b): the flash kernel at this rank's launch shapes in the
    granite prefill (its local q and KV heads, bf16, causal blocks of
    ``attn_block_q``) against the plain version and the dense oracle on
    the same inputs, within row 6g's ``flash_full_tol``.  Returns the max
    |kernel - plain|."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import KERNEL_WRAPPERS

    h = cfg.num_heads // sharder.split("heads", cfg.num_heads).size
    hkv = cfg.num_kv_heads // sharder.split("kv_heads",
                                            cfg.num_kv_heads).size
    d, blk = cfg.head_dim, cfg.attn_block_q
    gen = torch.Generator().manual_seed(MP_SERVE["seed"] + 1)
    q = torch.randn((rows, h, plen, d), generator=gen) * FLASH_FULL_Q_GAIN
    k = torch.randn((rows, hkv, plen, d), generator=gen)
    v = torch.randn((rows, hkv, plen, d), generator=gen)
    q, k, v = (t.to(DEVICE, torch.bfloat16) for t in (q, k, v))
    idx, cnt, _ = ops.build_block_structure(plen, plen, block_q=blk,
                                            block_k=blk, causal=True)
    args = (q, k, v, torch.from_numpy(idx), torch.from_numpy(cnt))
    kw = dict(scale=d ** -0.5, causal=True, window=None, softcap=None,
              block_q=blk, block_k=blk, q_offset=0)
    got = KERNEL_WRAPPERS[0](*args, **kw)
    atol, rtol = flash_full_tol(v)
    errs = []
    for name, want in (("plain", ref.ref_flash_attention(*args, **kw)),
                       ("dense oracle", ref.ref_attention(
                           q, k, v, scale=d ** -0.5, causal=True))):
        diff = (got.float() - want.float()).abs()
        errs.append(float(diff.max()))
        require(got.shape == q.shape and got.dtype == q.dtype
                and bool((diff <= atol + rtol * want.float().abs()).all()),
                f"phase 21 (b) flash at B={rows} H={h}/{hkv} S={plen} "
                f"D={d}: kernel != {name} (max |diff| {errs[-1]}, "
                f"tolerance {atol:.4g} + {rtol:.4g} |ref|)")
    return errs[0]


def mp_layer_check(torch, cfg, sharder, midx: int) -> dict:
    """Phase 21 (b): one granite MoE layer at full width on the (data 1,
    model 4) mesh, a 4 x 2048 wave of x from a seed.  Each mode's bf16
    output against a float64 evaluation of the einsum path's own bins,
    records and weights (its ``_apply`` arguments), within ``MP_LAYER_RATIO`` x the
    one-rank einsum path's error; then the control, one rank's partial
    left out of every reduction, which must read above that bound.  A
    mode whose rules store the weights otherwise takes the same weights
    in its own layout.  Returns the errors relative to the reference's
    max."""
    from repro_torch.models import moe
    from repro_torch.models.api import init_params
    from repro_torch.parallel.sharding import make_sharder

    defs = moe.moe_defs(cfg)
    rows, plen = MP_SERVE["rows"], MP_SERVE["prompt_len"]
    gen = torch.Generator(DEVICE).manual_seed(MP_LAYER_SEED)
    whole = init_params(defs, torch.float32, gen, device=DEVICE)
    gen = torch.Generator(DEVICE).manual_seed(MP_LAYER_SEED)
    local = init_params(defs, torch.float32, gen, device=DEVICE,
                        local=sharder.local)
    x = torch.randn((rows, plen, cfg.d_model), generator=gen,
                    device=DEVICE).to(cfg.dtype)
    seen, real = {}, moe._apply

    def captured(*args):
        seen["args"] = args
        return real(*args)
    moe._apply = captured
    try:
        one = moe.moe_layer(whole, x, cfg)[0]
    finally:
        moe._apply = real
    xs, bt, w, (expert, slot, gate) = seen.pop("args")[:4]
    want = real(xs.double(), bt, {n: t.double() for n, t in w.items()},
                (expert, slot, gate.double())).reshape(one.shape)
    scale = float(want.abs().max())

    def err(out):
        return float((out.double() - want).abs().max()) / scale
    rec = {"one": err(one)}
    bound = MP_LAYER_RATIO * rec["one"]
    for impl in MP_SERVE["modes"]:
        c = mp_mode_config(cfg, impl)
        sh, w = make_sharder(c, sharder.mesh), local
        if sh.rules != sharder.rules:
            w = init_params(defs, torch.float32, torch.Generator(
                DEVICE).manual_seed(MP_LAYER_SEED), device=DEVICE,
                local=sh.local)
        rec[impl] = err(moe.moe_layer(w, x, c, sh)[0])
        with dropped_partial(moe, torch, midx):
            rec[f"{impl} control"] = err(moe.moe_layer(w, x, c, sh)[0])
        del w
        require(rec[impl] <= bound < rec[f"{impl} control"],
                f"phase 21 (b) one MoE layer, {impl}: bf16 error "
                f"{rec[impl]:.3e}, control {rec[f'{impl} control']:.3e}, "
                f"bound {bound:.3e} ({MP_LAYER_RATIO} x one rank's)")
    return rec


def mp_train_argv(directory, tp=None, steps=None) -> list:
    """Phases 21 (c) and 23 (b): the training launcher's arguments (the
    world of 1's, or with ``--tp TP --distributed`` the world of 4's;
    ``MP_TRAIN``'s steps unless ``steps``)."""
    t = MP_TRAIN
    argv = ["--arch", t["arch"], "--steps", str(steps or t["steps"]),
            "--batch", str(t["batch"]), "--seq", str(t["seq"]),
            "--ckpt-every", str(t["ckpt_every"]), "--seed", str(t["seed"]),
            "--ckpt-dir", str(directory), "--device", DEVICE]
    return argv + ([] if tp is None else ["--tp", str(tp), "--distributed"])


def layout_bytes(sharder, defs, dtype_bytes: int, stored: bool = True) -> int:
    """Each rank's bytes of a ParamDef tree's blocks (elements of
    ``dtype_bytes``): as stored (the JAX shard layout), or with
    ``stored=False`` in the replicated layout (parameters replicated over
    the batch axes, where only ``embed`` maps, and Mamba heads
    replicated)."""
    import dataclasses

    from repro_torch.models.api import iter_leaves
    if not stored:
        sharder = dataclasses.replace(sharder, rules=dict(
            sharder.rules, embed=None, mamba_heads=None))
    return sum(math.prod(sharder.block_shape(d.axes, d.shape)) * dtype_bytes
               for _, d in iter_leaves(defs))


def mp_twin_batch(torch, cfg) -> dict:
    """Phase 21 (c)'s float32 twin: one ``SyntheticLM`` batch on the card
    (every rank the same)."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    return SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=MP_TWIN["seq"],
        global_batch=MP_TWIN["rows"], seed=MP_TWIN["seed"]),
        device=DEVICE).batch(0)


def model_parallel_rank(rank: int, world: int, port: int, out_dir: str,
                        cards: bool = False) -> None:
    """Phase 21, one spawned rank: join the gloo world on cuda:0 (with
    ``cards``, the NCCL world with rank r on cuda:r), run
    :func:`model_parallel_work` and save its record as ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank if cards else 0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("nccl" if cards else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    try:
        rec = model_parallel_work(torch, rank, pathlib.Path(out_dir))
    finally:
        dist.destroy_process_group()
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def model_parallel_work(torch, rank: int, out) -> dict:
    """Every rank of phase 21's world of 4 (gloo, all on cuda:0):
    (b) granite-moe-3b-a800m at full width and depth on a (data 1, model
    4) mesh, one prefill wave per MoE mode against the world of 1's
    logits, and a 2-layer float32 twin; (c) smollm-360m trained through
    ``launch.train --tp 2 --distributed`` on (data 2, model 2), and a
    2-layer float32 twin's loss and gradients; (d) ring and halo attention
    at gemma2-2b's shapes over the model group of 4; (e)
    ``compressed_psum`` over it.  Returns the rank's record."""
    import contextlib
    import dataclasses
    import gc
    import statistics

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import record_traffic
    from repro_torch.kernels.flash_attention import KERNEL_WRAPPERS
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import Model, moe
    from repro_torch.models.api import iter_leaves, param_shapes
    from repro_torch.models.attention import dense_attention
    from repro_torch.parallel import compression
    from repro_torch.parallel import context_parallel as cp
    from repro_torch.parallel.collectives import all_reduce_max
    from repro_torch.parallel.sharding import gather_params, make_sharder
    from repro_torch.train.loop import data_parallel_sum, value_and_grad

    dev = torch.device(DEVICE)
    flash = KERNEL_WRAPPERS[0]
    refs = torch.load(out / "refs.pt", weights_only=False)
    tag = f"phase 21 rank {rank}"
    rec = {"b": {}, "twin_b": {}}
    mesh4 = make_elastic_mesh(model_parallel=MP_WORLD, device=DEVICE)

    def sync():
        torch.cuda.synchronize()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (b) granite at full width and depth, model 4, one wave per mode
    cfg = get_config(MP_SERVE["arch"])
    base = Model(cfg, sharder=make_sharder(cfg, mesh4), device=DEVICE)
    midx = base.sharder.coordinate("model")
    mgroup = mesh4.get_group("model")
    held = {}

    def weights(model):
        """The seed's weights in ``model``'s layout; one layout's held at
        a time (a mode whose rules store the expert weights replicated
        holds 12 GB a rank)."""
        if held.get("rules") != model.sharder.rules:
            held.clear()
            free()
            held["params"] = model.init(torch.Generator(DEVICE).manual_seed(
                MP_SERVE["seed"]))
            held["rules"] = model.sharder.rules
        return held["params"]
    ref = refs["serve"]
    toks = ref["tokens"].to(dev)
    rows, plen = toks.shape
    want = ref["logits"][:, -1, :cfg.vocab_size].float()
    exact = ref["float32"][:, -1, :cfg.vocab_size].float()
    scale = exact.abs().max()
    err_one = float((want - exact).abs().max() / scale)
    top2 = exact.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]) / scale
    real = moe.moe_layer

    def prefill(impl, control=False):
        """One wave of mode ``impl``: (logits, ms, flash launches, drop
        fractions, expert choices a layer, the number of layers whose MoE
        output differs between the model ranks, this rank's collective
        traffic by kind); with ``control`` rank 0's partial is left out of
        every layer's reduction."""
        c = mp_mode_config(cfg, impl)
        model = Model(c, sharder=make_sharder(c, mesh4), device=DEVICE)
        params = weights(model)
        drops, choices, bits = [], [], []

        def counted(*args, **kwargs):
            res = real(*args, **kwargs)
            drops.append(res[1]["moe_drop_fraction"])
            bits.append(res[0].contiguous().view(torch.int16)
                        .sum(dtype=torch.int64))
            return res
        cache = model.init_cache(rows, plen + 8)
        sync()
        flash.launches = 0
        moe.moe_layer = counted
        t0 = time.perf_counter()
        try:
            drop = dropped_partial(moe, torch, midx) if control \
                else contextlib.nullcontext()
            with recorded_choices(moe, choices), drop, \
                    record_traffic() as traffic:
                _, logits = model.prefill(params, {"tokens": toks}, cache)
            sync()
        finally:
            moe.moe_layer = real
        ms = (time.perf_counter() - t0) * 1e3
        got = logits[:, -1, :cfg.vocab_size].float().cpu()
        bits = torch.stack(bits)
        hi = all_reduce_max(bits, (mgroup,))
        lo = -all_reduce_max(-bits, (mgroup,))
        return (got, ms, flash.launches, drops, choices,
                int((hi != lo).sum()),
                {k: dict(v) for k, v in traffic.items()})

    for impl in MP_SERVE["modes"]:
        mode = moe.select_moe_mode(mp_mode_config(cfg, impl), mesh4,
                                   moe._capacity(rows * plen, cfg))
        got, ms, launches, drops, choices, differ, traffic = prefill(impl)
        rel = float((got - want).abs().max() / scale)
        err = float((got - exact).abs().max() / scale)
        same = got.argmax(dim=-1) == want.argmax(dim=-1)
        decided = margin > 2 * (err + err_one)
        moved = choice_diffs(choices, ref["choices"])
        moved32 = choice_diffs(choices, ref["choices_float32"])
        bound = MP_BF16_ERR_BOUND
        rec["b"][impl] = {
            "mode": mode, "ms": ms, "launches": launches, "rel": rel,
            "err": err, "err_one": err_one, "bound": bound,
            "layers_differing_between_ranks": differ,
            "tokens_equal": int(same.sum()),
            "tokens_decided": int(decided.sum()),
            "drop": float(torch.stack(drops).mean()),
            "routing_moved": moved, "routing_moved_float32": moved32,
            "traffic": traffic}
        if rank == 0:
            print(f"{tag} (b) {impl}: " + json.dumps(rec["b"][impl]),
                  flush=True)
        require(launches == attention_layers(cfg),
                f"{tag} (b) {impl}: flash launches {launches} != "
                f"{attention_layers(cfg)} a prefill")
        require(differ == 0, f"{tag} (b) {impl}: the MoE output of "
                f"{differ} layers differs between the model ranks")
        require(bool(torch.isfinite(got).all()) and err <= bound
                and bool(same[decided].all()),
                f"{tag} (b) {impl}: last logits {err:.3e} from the float32 "
                f"run (bound {bound}; one rank {err_one:.3e}), "
                "or a greedy token with margin differs")
    got = prefill(MP_CONTROL_MODE, control=True)[0]
    control = float((got - exact).abs().max() / scale)
    rec["b_control"] = control
    require(control > MP_BF16_ERR_BOUND,
            f"{tag} (b) control: {MP_CONTROL_MODE} with one rank's partial "
            f"left out of every layer reads {control:.3e}, not above the "
            f"bound {MP_BF16_ERR_BOUND}")
    rec["ref_drop"] = ref["drop"]
    rec["ref_routing_moved_float32"] = ref["routing_moved_float32"]
    sharder = base.sharder
    held.clear()
    del base
    free()
    rec["flash_err"] = mp_flash_check(torch, cfg, sharder, rows, plen)
    rec["layer"] = mp_layer_check(torch, cfg, sharder, midx)
    free()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c = dataclasses.replace(cfg, num_layers=MP_TWIN["layers"],
                                dtype=torch.float32)
        ref = refs["serve_twin"]
        for impl in MP_SERVE["modes"]:
            ci = mp_mode_config(c, impl)
            model = Model(ci, sharder=make_sharder(ci, mesh4), device=DEVICE)
            params = model.init(torch.Generator(DEVICE).manual_seed(
                MP_TWIN["seed"]))
            _, logits = model.prefill(params, {"tokens": ref["tokens"].to(dev)},
                                      model.init_cache(MP_TWIN["rows"],
                                                       MP_TWIN["seq"] + 8))
            v = c.vocab_size
            rel = _rel(logits[..., :v].cpu(), ref["logits"][..., :v])
            require(rel <= MP_TWIN_TOL, f"{tag} (b) float32 twin {impl}: "
                    f"logits rel {rel:.3e} > {MP_TWIN_TOL}")
            rec["twin_b"][impl] = rel
        del params, model
        free()

        # (c) the float32 twin of the training step, data 2 x model 2
        mesh2 = make_elastic_mesh(model_parallel=MP_TRAIN["tp"],
                                  device=DEVICE)
        c = dataclasses.replace(get_config(MP_TRAIN["arch"]),
                                num_layers=MP_TWIN["layers"],
                                dtype=torch.float32)
        model = Model(c, sharder=make_sharder(c, mesh2), device=DEVICE)
        params = model.init(torch.Generator(DEVICE).manual_seed(
            MP_TWIN["seed"]))
        batch = mp_twin_batch(torch, c)
        (loss, _), grads = value_and_grad(model, params, batch)
        grads = data_parallel_sum(grads, model, batch["tokens"].shape[0])
        grads = gather_params(grads, model.sharder, model.specs(),
                              param_shapes(model.defs(), torch.float32))
        ref = refs["train_twin"]
        worst = max(((_rel(g.cpu(), ref["grads"][p]), p)
                     for p, g in iter_leaves(grads)))
        loss_rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
        require(loss_rel <= MP_TWIN_TOL and worst[0] <= MP_TWIN_TOL,
                f"{tag} (c) float32 twin: loss rel {loss_rel:.3e}, "
                f"gradient {worst[1]} rel {worst[0]:.3e} > {MP_TWIN_TOL}")
        twin_c = {"twin_loss_rel": loss_rel, "twin_grad_rel": worst[0],
                  "twin_worst_leaf": worst[1]}
        del model, params, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    free()

    # (c) smollm-360m trains through the launcher, data 2 x model 2
    loop = train_launcher.main(mp_train_argv(out / "ck4", MP_TRAIN["tp"]))
    losses = [h["loss"] for h in loop.history]
    model = loop.model
    defs = model.defs()
    c_bytes = {"params": layout_bytes(model.sharder, defs, 4),
               "moments": 2 * layout_bytes(model.sharder, defs, 2),
               "replicated_params": layout_bytes(model.sharder, defs, 4,
                                                 False),
               "replicated_moments": 2 * layout_bytes(model.sharder, defs, 2,
                                                      False)}
    times = [h["time_s"] * 1e3 for h in loop.history]
    ref_losses = refs["train"]["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    # the control: a step's loss against the world of 1's a step earlier
    shifted = min(abs(a - b) / abs(b)
                  for a, b in zip(losses[1:], ref_losses[:-1]))
    require(len(losses) == len(ref_losses) == MP_TRAIN["steps"]
            and all(math.isfinite(x) for x in losses)
            and loss_rel <= MP_LOSS_BOUND < shifted,
            f"{tag} (c): losses {losses} against the world of 1's "
            f"{ref_losses} (bound {MP_LOSS_BOUND}; a step apart "
            f"{shifted:.3e})")
    rec["c"] = {"losses": losses, "ref_losses": ref_losses,
                "loss_rel": loss_rel, "loss_shifted": shifted,
                "step_times_ms": times, "bytes": c_bytes,
                "step_ms": statistics.median(times[1:]), **twin_c}
    del loop
    free()

    # (d) context parallelism over the model group of 4
    group = mesh4.get_group("model")
    idx = dist.get_rank(group)
    t = MP_CP
    gen = torch.Generator(DEVICE).manual_seed(t["seed"])
    q = torch.randn((t["B"], t["H"], t["S"], t["D"]), generator=gen,
                    device=dev)
    k = torch.randn((t["B"], t["KV"], t["S"], t["D"]), generator=gen,
                    device=dev)
    v = torch.randn((t["B"], t["KV"], t["S"], t["D"]), generator=gen,
                    device=dev)
    s_l = t["S"] // MP_WORLD
    ql = q[:, :, idx * s_l:(idx + 1) * s_l].contiguous()
    kl = k[:, :, idx * s_l:(idx + 1) * s_l].contiguous()
    vl = v[:, :, idx * s_l:(idx + 1) * s_l].contiguous()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec["d"] = {}
        for name, fn, kwargs in (
                ("ring", cp.ring_attention, {}),
                ("halo", cp.halo_window_attention,
                 {"window": t["window"], "softcap": t["softcap"]})):
            sync()
            t0 = time.perf_counter()
            got = fn(ql, kl, vl, group=group, **kwargs)
            sync()
            rec["d"][f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
            want = dense_attention(ql, k, v, scale=t["D"] ** -0.5,
                                   causal=True,
                                   window=kwargs.get("window"),
                                   softcap=kwargs.get("softcap"),
                                   q_offset=idx * s_l)
            err = float((got - want).abs().max())
            require(bool(torch.allclose(got, want, rtol=MP_CP_TOL,
                                        atol=MP_CP_TOL)),
                    f"{tag} (d) {name}: max |diff| {err:.3e} > {MP_CP_TOL}")
            rec["d"][f"{name}_err"] = err
            del got, want
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del q, k, v, ql, kl, vl
    free()

    # (e) compressed_psum of a 47M-float gradient over the model group
    x = torch.randn(MP_COMP_N, generator=torch.Generator(DEVICE).manual_seed(
        SEED + 140 + rank), device=dev) * 0.01
    err0 = torch.zeros_like(x)
    sync()
    t0 = time.perf_counter()
    mean, _ = compression.compressed_psum(x, group, err0)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    hi = all_reduce_max(mean, (group,))
    lo = -all_reduce_max(-mean, (group,))
    exact = x.clone()
    dist.all_reduce(exact, group=group)
    exact /= MP_WORLD
    bound = float(all_reduce_max(x.abs().max(), (group,))) / 127
    max_err = float((mean - exact).abs().max())
    require(torch.equal(hi, mean) and torch.equal(lo, mean)
            and max_err <= bound,
            f"{tag} (e): ranks differ or max |out - mean| {max_err:.3e} > "
            f"int8 bound {bound:.3e}")
    rec["e"] = {"ms": ms, "max_err": max_err, "bound": bound}
    return rec


def mamba_run(torch, model, params, toks, steps: int, feed=None):
    """A prefill of ``toks`` and ``steps`` decode steps, fed ``feed``
    (rows, steps) or, without it, the greedy tokens.  Returns (logits
    (steps + 1, rows, vocab) float32, the stacked MambaState.h after the
    prefill, the tokens fed)."""
    cfg = model.cfg
    rows, plen = toks.shape
    vocab = cfg.vocab_size
    cache = model.init_cache(rows, plen + steps)
    cache, last = model.prefill(params, {"tokens": toks}, cache)
    h = cache["layer0"].h.clone()
    out, fed = [last[:, 0, :vocab].float()], []
    for t in range(steps):
        tok = out[-1].argmax(-1)[:, None] if feed is None \
            else feed[:, t:t + 1].to(toks.device)
        fed.append(tok)
        cache, last = model.decode_step(params, tok, cache, plen + t)
        out.append(last[:, 0, :vocab].float())
    return torch.stack(out), h, torch.cat(fed, dim=1)


class dropped_slice:
    """While active, the FSDP gather's backward on data coordinate 0
    leaves its own partial out of the reduce-scatter (zeros in its place):
    phase 23 (b)'s control."""

    def __init__(self, collectives, torch, didx: int):
        self.cls, self.torch, self.didx = collectives._FsdpGather, torch, didx

    def __enter__(self):
        real = self.real = self.cls.backward
        torch, didx = self.torch, self.didx

        def backward(ctx, grad):
            return real(ctx, torch.zeros_like(grad) if didx == 0 else grad)
        self.cls.backward = staticmethod(backward)

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.real)


def train_reading(history, refs) -> float:
    """Phase 23 (b): the largest relative difference of a step's loss or
    gradient norm from one rank's (the norm is that of the summed
    gradient, before the update: a lost partial moves it at once)."""
    return max(max(abs(h["loss"] - a) / abs(a), abs(h["grad_norm"] - b) / b)
               for h, a, b in zip(history, refs["train"],
                                  refs["train_norms"]))


def layout_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phase 23, one spawned rank: join the gloo world on cuda:0, run
    :func:`layout_work` and save its record as ``rank<r>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=LAYOUT_TIMEOUT_S))
    try:
        rec = layout_work(torch, rank, pathlib.Path(out_dir))
    finally:
        dist.destroy_process_group()
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(rec))


def _tree_bytes(tree) -> int:
    from repro_torch.models.api import iter_leaves
    return sum(t.numel() * t.element_size() for _, t in iter_leaves(tree))


def layout_work(torch, rank: int, out) -> dict:
    """Every rank of phase 23's world of 4 (gloo, all on cuda:0): (a)
    mamba2-2.7b on (data 1, model 4): the bf16 run, the float32 run
    against one rank's and its control, the float32 twin's replicated
    gradients;
    (b) smollm-360m trained through ``launch.train --tp 1 --distributed``
    on (data 4, model 1) against one rank's losses, and the control.
    Returns the rank's record."""
    import dataclasses
    import gc
    import statistics

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL_WRAPPERS
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import Model
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models.api import iter_leaves
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import make_sharder
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import AdamW

    dev = torch.device(DEVICE)
    refs = torch.load(out / "refs.pt", weights_only=False)
    tag = f"phase 23 rank {rank}"

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) mamba2-2.7b, 20 of 80 heads a rank: the bf16 run, then the
    # float32 run and its control against one rank's float32 run
    checks = []
    torch.cuda.reset_peak_memory_stats()
    m = LAYOUT_MAMBA
    cfg = get_config(m["arch"])
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    mesh = make_elastic_mesh(model_parallel=MP_WORLD, device=DEVICE)
    model = Model(cfg, sharder=make_sharder(cfg, mesh), device=DEVICE)
    model32 = Model(c32, sharder=make_sharder(c32, mesh), device=DEVICE)
    sharder = model.sharder
    midx = sharder.coordinate("model")
    mgroup = mesh.get_group("model")
    split = sharder.split("mamba_heads", cfg.mamba_heads)
    hl = cfg.mamba_heads // split.size
    h_lo = split.index * hl
    params = model.init(torch.Generator(DEVICE).manual_seed(m["seed"]))
    toks, feed = refs["tokens"].to(dev), refs["feed"]
    exact, one = refs["float32"], refs["one"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _, _ = mamba_run(torch, model, params, toks, m["steps"], feed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    logits = logits.cpu()
    # the bf16 logits on every model rank are one all-reduce's bits, so
    # the greedy tokens are the same on each
    greedy = logits.argmax(-1)
    peers = [torch.empty_like(greedy) for _ in range(MP_WORLD)]
    dist.all_gather(peers, greedy, group=mgroup)
    checks.append((bool(torch.isfinite(logits).all()) and all(
        torch.equal(p, greedy) for p in peers),
        f"{tag} (a): bf16 logits not finite, or greedy tokens differ "
        "between the model ranks"))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            logits32, h, _ = mamba_run(torch, model32, params, toks,
                                       m["steps"], feed)
            with dropped_partial(mamba_lib, torch, midx):
                cache = model32.init_cache(m["rows"], m["prompt_len"] + 1)
                _, last = model32.prefill(params, {"tokens": toks}, cache)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    h_f32 = torch.load(out / "h_float32.pt", mmap=True)[:, :, h_lo:h_lo + hl]
    err32 = max(_rel(a, b) for a, b in zip(logits32.cpu(), exact))
    h_err = _rel(h.cpu(), h_f32)
    control = _rel(last[:, 0, :cfg.vocab_size].cpu(), exact[0])
    same = greedy == one.argmax(-1)
    rec = {"a": {
        "heads": hl, "heads_whole": cfg.mamba_heads, "ms": ms,
        "err_bf16": max(_rel(a, b) for a, b in zip(logits, exact)),
        "err_bf16_one": max(_rel(a, b) for a, b in zip(one, exact)),
        "err": err32, "h_err": h_err, "control": control,
        "tokens": int(same.numel()), "tokens_equal": int(same.sum()),
        "param_bytes": _tree_bytes(params),
        "param_bytes_whole": cfg.param_count() * 4}}
    checks.append((err32 <= LAYOUT_F32_TOL and h_err <= LAYOUT_F32_TOL
                   < control,
                   f"{tag} (a): float32 logits {err32:.3e}, h {h_err:.3e} "
                   f"from one rank's (bound {LAYOUT_F32_TOL}), control "
                   f"{control:.3e}"))
    del params, model, model32, logits, logits32, h, h_f32, cache, last
    free()
    rec["a"]["peak_bytes"] = torch.cuda.max_memory_allocated()

    # (a) the float32 twin: every leaf replicated over the model axis has
    # the same gradient bits on every model rank
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c = dataclasses.replace(cfg, num_layers=LAYOUT_TWIN["layers"],
                                dtype=torch.float32)
        model = Model(c, sharder=make_sharder(c, mesh), device=DEVICE)
        params = model.init(torch.Generator(DEVICE).manual_seed(
            LAYOUT_TWIN["seed"]))
        _, grads = value_and_grad(model, params, mp_twin_batch(torch, c))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    defs = dict(iter_leaves(model.defs()))
    checked = 0
    for path, g in iter_leaves(grads):
        d = defs[path]
        if any("model" in s.axes for s in model.sharder.layout(d.axes,
                                                               d.shape)):
            continue
        peers = [torch.empty_like(g) for _ in range(MP_WORLD)]
        dist.all_gather(peers, g.contiguous(), group=mgroup)
        checks.append((all(torch.equal(p.view(torch.int32),
                                       g.view(torch.int32)) for p in peers),
                       f"{tag} (a) twin: {path}'s gradient differs between "
                       "the model ranks"))
        checked += 1
    checks.append((checked > 0, f"{tag} (a) twin: no replicated leaf"))
    rec["a"]["twin_replicated"] = checked
    del model, params, grads
    free()

    # (b) smollm-360m on (data 4, model 1): FSDP alone
    cfg = get_config(MP_TRAIN["arch"])
    mesh = make_elastic_mesh(model_parallel=1, device=DEVICE)
    model = Model(cfg, sharder=make_sharder(cfg, mesh), device=DEVICE)
    didx = model.sharder.coordinate("data")
    params = model.init(torch.Generator(DEVICE).manual_seed(MP_TRAIN["seed"]))
    opt = AdamW(lambda step: torch.tensor(0.0))
    state = opt.init(params)
    b_bytes = {"param_bytes": _tree_bytes(params),
               "moment_bytes": _tree_bytes({"m": state.m, "v": state.v}),
               "param_bytes_whole": cfg.param_count() * 4,
               "moment_bytes_whole": 2 * cfg.param_count() * 2}
    del model, params, state
    free()
    torch.cuda.reset_peak_memory_stats()
    flash = KERNEL_WRAPPERS[0]
    flash.launches = 0
    loop = train_launcher.main(mp_train_argv(out / "ck4", 1))
    launches = flash.launches
    peak = torch.cuda.max_memory_allocated()
    losses = [x["loss"] for x in loop.history]
    norms = [x["grad_norm"] for x in loop.history]
    times = [x["time_s"] * 1e3 for x in loop.history]
    del loop
    free()
    with dropped_slice(collectives, torch, didx):
        loop = train_launcher.main(mp_train_argv(out / "ck4_control", 1,
                                                 steps=1))
    control = train_reading(loop.history, refs)
    del loop
    free()
    ref = refs["train"]
    loss_rel = train_reading([{"loss": a, "grad_norm": b}
                              for a, b in zip(losses, norms)], refs)
    rec["b"] = {"losses": losses, "ref_losses": ref, "loss_rel": loss_rel,
                "grad_norms": norms, "ref_grad_norms": refs["train_norms"],
                "control": control, "step_times_ms": times,
                "step_ms": statistics.median(times[1:]), "peak_bytes": peak,
                "launches": launches, **b_bytes}
    want = MP_TRAIN["steps"] * train_flash_calls(cfg, MP_TRAIN["seq"])
    checks += [(len(losses) == len(ref) == MP_TRAIN["steps"]
                and all(math.isfinite(x) for x in losses)
                and loss_rel <= MP_LOSS_BOUND < control,
                f"{tag} (b): losses {losses} against one rank's {ref} (bound "
                f"{MP_LOSS_BOUND}; control {control:.3e})"),
               (launches == want,
                f"{tag} (b): flash launches {launches} != {want}")]
    if rank == 0:
        print(f"{tag}: " + json.dumps(rec), flush=True)
    for cond, what in checks:
        require(cond, what)
    return rec


def _warm_service(**kwargs):
    """A DDMService whose (empty) match cache is warm, so that each flush
    keeps it current by its delta and ``pairs()`` never rebuilds."""
    from repro_torch.api import DDMService

    svc = DDMService(**kwargs)
    svc.pairs()
    return svc


def battery_edge_cases(d: int):
    """The battery's edge cases for d dims: name -> (lo_s, hi_s, lo_u,
    hi_u) float32 numpy arrays ((n,) for d = 1, (d, n) above): ties on an
    integer grid, touching endpoints, -0.0, infinite bounds, empty sides,
    n = m = 1.  Above d = 1 each dimension holds the 1-d case's extents in
    its own order."""
    import numpy as np

    rng = np.random.default_rng(SEED + 70 + d)
    inf = np.inf

    def side(lo, hi):
        lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        if d == 1:
            return lo, hi
        perms = [rng.permutation(lo.shape[0]) for _ in range(d)]
        return (np.stack([lo[p] for p in perms]),
                np.stack([hi[p] for p in perms]))

    def case(subs, upds):
        return side(*subs) + side(*upds)

    lo_s = rng.integers(0, 12, 40)
    lo_u = rng.integers(0, 12, 30)
    return {
        "ties": case((lo_s, lo_s + rng.integers(0, 4, 40)),
                     (lo_u, lo_u + rng.integers(0, 3, 30))),
        "touching": case(([0, 2, 4, 6], [1, 3, 5, 7]),
                         ([1, 3, 5, 7], [2, 4, 6, 8])),
        "negative zero": case(([-0.0, -1, 0, -0.0], [0, -0.0, 0, 1]),
                              ([0, -0.0, -2, 0], [-0.0, 0, -0.0, 3])),
        "infinite bounds": case(([-inf, -inf, 3, 7], [inf, 5, inf, 9]),
                                ([-inf, 4, 10, 6], [-1, inf, inf, 6])),
        "empty subs": case(([], []), ([0, 1], [1, 2])),
        "empty upds": case(([0, 1], [1, 2]), ([], [])),
        "n=m=1": case(([3], [4]), ([4], [5])),
    }


def battery_workload(kind: str, d: int, n: int, m: int, seed: int):
    """A seeded workload of the battery as numpy (lo_s, hi_s, lo_u, hi_u):
    uniform, clustered (Gaussian hot spots) or tall-thin (dim 0 wide)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seg = np.float32(8.0 * LENGTH / (n + m))
    shape = (n + m,) if d == 1 else (d, n + m)
    if kind == "clustered":
        centers = rng.uniform(0.0, LENGTH, 8)
        lo = centers[rng.integers(0, 8, shape)] \
            + rng.normal(0.0, LENGTH / 400, shape)
    else:
        lo = rng.uniform(0.0, LENGTH - seg, shape)
    lo = lo.astype(np.float32)
    hi = lo + seg
    if kind == "tall_thin":
        lo[0] = rng.uniform(0.0, 0.02 * LENGTH, n + m).astype(np.float32)
        hi[0] = lo[0] + np.float32(0.98 * LENGTH)
    return (np.ascontiguousarray(lo[..., :n]), np.ascontiguousarray(hi[..., :n]),
            np.ascontiguousarray(lo[..., n:]), np.ascontiguousarray(hi[..., n:]))


def _live_mask(window):
    """flex_attention mask_mod: causal, and inside ``window`` if given (the
    kernel's token mask, k_pos > q_pos - window)."""
    def mask(b, h, q_idx, kv_idx):
        live = q_idx >= kv_idx
        if window is not None:
            live = live & (q_idx - kv_idx < window)
        return live
    return mask


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
