#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Every phase is fatal on failure; nothing is caught and passed over.

1. card: CUDA must be present; prints the card's name and power limit.
2. build: ``nvcc`` builds the three kernels from ``src/repro_torch/kernels/csrc/``,
   one process per source, all started together (build time and the ptxas
   reports printed).
3. check: each kernel against its plain PyTorch version on the card, rtol =
   atol = 1e-5 and equal inf positions (bf16 reps: 2e-2).  frontier_scores:
   kl, itakura_saito, renyi_0.25, l2 and negdot at the search and NN-descent
   shapes, m'=128, -1 padding, and once into a column range of a wider
   block; at the search shapes gather_scores must equal it bit for bit (the
   search step runs gather_scores).  two_hop_scores: the same distances on a (4,096, 30) adjacency
   with a padded row and a hub of ~300 edges.  distance_matrix: kl,
   itakura_saito, renyi_0.25, renyi_2, l2 and negdot at 128x4096x{8,32,128},
   512x8192x128, a ragged 33x300x64, 33x300x30 (rows TMA cannot read),
   m'=512 and 2,100, bf16 cases at m'=128 and 36, the build_sharded stitch
   shape (20,000 x 64, m'=32) and ``mode="right"``.
   gather_scores: the same distances at (64, 30, 128), (64, 240, 128) with
   -1 padding and a row of padding only, the wave builder's reverse-edge
   shapes (960, 1, 32) and (960, 1, 128), wide rows (64, 30, 2100), a B*M
   that is no multiple of a warp's cells (5, 3, 16), one cell (1, 1, 4),
   wide rows at too few cells per row for a run (960, 1, 512) and
   (4, 3, 2100), an ``x_rep`` base 4 bytes off a 16-byte word (scalar
   loads), and ``ops.beam_gather_scores``.  The wrappers (avg, min, reverse,
   max, blend(0.25), rankblend(0.5) with its tau calibrated on the data,
   learned with a Mahalanobis branch over KL at m'=128, and the viewed BM25
   at m'=2048): their branch-lowered kernel scores against the wrapper's
   own plain forms, one launch per branch counted, at gather_scores
   (64, 240), the NN-descent round (two_hop_scores + frontier_scores) on a
   (4,096, 30) adjacency (rows 0-255 held to the plain version) and
   distance_matrix at 512x8192 in both modes.
4. serve defaults: n=20,000, d=32, KL, NN-descent, ef 96, frontier 4, k 10,
   256 queries in batches of 64 through ``launch.serve.build_and_serve``;
   recall@10 >= 0.90.
5. SW-graph at the serve defaults: the same entry point with
   ``builder="swgraph"`` (wave 64, NN 15, ef_construction 100); recall@10
   >= 0.98 (the JAX driver reaches 0.9898 at these flags); the launch counts
   are set to 0 just before and read just after: the build (its searches
   and reverse edges) and the search must launch gather_scores.
6. SW-graph at d=128 (the paper's Wiki-d width): first n=20,000, recall@10
   >= 0.70 (the JAX driver reaches 0.7156); the per-wave time of that build
   picks the largest n of 10^6, 200,000, 100,000, 50,000, 30,000, 20,000 and 10,000 whose
   build fits SWGRAPH_BUILD_BUDGET_S; at that n, recall@10 at ef 96 and 512 beside an
   NN-descent build (the full cell's NN 30) on the same data.  No floor.
7. sequential and reference paths: ``build_swgraph`` at n=250, d=16,
   NN 8, ef_construction 40 against ``build_swgraph_wave`` at W=1 (equal
   adjacency); a batch of 64 through the reference engine against the
   batched engine at frontier 1 from entry 0 under kl (equal ids, n_evals
   and hops).
8. build_sharded at world size 1 in a one-rank NCCL group, n=10,000, d=32:
   distance_matrix must launch (counts set to 0 just before), every cross
   link is -1, and the local part equals ``build_swgraph_wave`` on the same
   rows.
9. main path at full size: n=1,000,000 LDA-like histograms (d=128,
   alpha=0.08), 1,024 held-out queries in batches of 64, NN-descent with the
   graph degree doubled (NN 30) and ef 512.  The launch counts are set to 0
   just before and read just after; the build must have launched
   two_hop_scores and frontier_scores, the search gather_scores, and the
   ground truth (``knn_scan``) distance_matrix; recall@10 must exceed 0.5.
10. timing: each kernel per launch beside its bound, the plain version's
    time and, for distance_matrix, ``torch.matmul`` with TF32 off (the
    product without the epilogue).  ``ms`` (and ``ms_again``, a second
    reading) is device time from the profiler's kernel records, profiled
    again where a window does not hold one record of the kernel per call;
    ``event_ms`` is CUDA events around back-to-back calls, which also
    counts the host's launch gaps; ``ids_pass_ms`` is one PyTorch
    elementwise kernel over the same ids (``ids.neg()``), the launch and
    id latency any gather pays.  gather_scores is timed at the search
    steps (64, 240) and (64, 120) at m'=128, at the reverse edges
    (960, 1, 32) of the serve data and (960, 1, 128) of the d=128 SW-graph
    cell, at wide rows (64, 30, 2100) and at reverse edges of wide rows
    (960, 1, 2100), at the online index's shapes of phase 16's cell (an
    insert or repair wave's search step (32, 240), a repair wave's reverse
    edges (960, 1) with ids over n=10^6, and ``from_graph``'s edge distances
    over the real (10^6 + 512, 60) adjacency, its plain version on 4,096
    rows), and at the slot scheduler's shapes, each also held to the plain
    version: a tick's lock-step over 48 slots at frontier 12, (48, 720) with
    ids over n=10^6 at m'=128 and (48, 360) over the serve data at m'=32,
    and the retire-time rerank of one request, (1, 512) over n=10^6;
    frontier_scores at the NN-descent rounds.  The
    NN-descent round is timed on the real candidate block of the phase 9
    build (rebuilt from the same data and seed): the general kernel over
    all R columns against the grouped join plus the general kernel over the
    rest, in turns, and held to each other; the join's columns are also held
    to the plain version on 2,048 rows and on every edge of the largest hub.
11. profile: device time by kernel and the device's idle share for one
    full-size NN-descent build, one search batch and one SW-graph wave
    build of PROFILED_WAVES waves (``torch.profiler``).
12. graph quality of the NN-descent cell, NN 15 against NN 30, at
    n = GRAPH_QUALITY_N: the share of each node's true NN nearest neighbours
    that the graph holds, and search recall@10 at ef 96 and 512.
13. the policies at full width, phase 9's cell through the same entry point:
    (a) built under ``min`` and searched under KL, (b) built and searched
    under ``min`` with k_c = 512 candidates re-ranked under KL.  The launch
    counts are set to 0 before each and read after: each build must launch
    two_hop_scores and frontier_scores twice as often as phase 9's (one per
    branch); (b)'s search launches gather_scores twice per lock-step and
    once per batch for the rerank (held exactly on one batch); recall@10
    must exceed 0.5 for both.  Then the ``min`` build is profiled, and (a)
    and (b) are timed batch by batch in turns over one graph each and
    profiled on one batch.
14. every policy at the serve defaults (n=20,000, d=32, KL, NN-descent)
    through ``build_and_serve``: avg, min, reverse, l2, max, blend(0.25),
    rankblend(0.5); then ``--spec TUNED_spec.json`` and
    ``--spec LEARNED_weights.json`` from the repo; then BM25 against its
    ``natural`` build on a text collection (vocab 2,048) at n=4,000 and
    20,000 documents.  Each recall@10 must reach JAX_RECALL (the JAX
    package's ``launch.serve`` at the same flags, on the CPU) less 0.02;
    the 20,000-document BM25 pair has no JAX number (the JAX package
    materialises its gathered rows there, ~40 GB) and is reported.
15. churn at the serve defaults through ``build_and_serve`` with
    ``churn_rounds=4, churn_insert=256, churn_delete=200`` (capacity n +
    1,024): recall@k_after_churn must reach JAX_CHURN_RECALL (the JAX
    package's driver at the same flags, on the CPU) less 0.02, with
    capacity_used < n + inserted (slots recycled); the counts are set to 0
    before the run and each phase is counted on its own: gather_scores must
    launch in the build (``from_graph``), the inserts, the compaction and
    the search, distance_matrix in the audit.  Then, on a fresh index with
    256 inserts and 16 deletes, ``compact_slice`` drained at max_nodes = wave
    on a copy of the state must leave ``compact()``'s adjacency.
16. churn at full width, phase 9's cell (n=10^6, d=128, NN 30, ef 512,
    1,024 queries, capacity n + 512): ``ANNIndex.build`` and ``run_churn``
    with 2 rounds of 256 inserts; the deletes per round are sized so that
    ``compact()`` is predicted to fit COMPACT_BUDGET_S from phase 15's time
    per repaired node.  The same launch checks; recall@k_after_churn must
    exceed 0.5.  One more insert round (PROFILED_INSERTS points) and a
    compact after 4 deletes are profiled.
17. continuous at the serve defaults through ``build_and_serve`` with
    ``continuous=True`` (48 slots, frontier 12, utilization 0.4: static,
    dynamic and slot-scheduler latency over one Poisson trace), then again
    with ``slo_ms`` = 1.5 x the p50 it just measured, 2 tenants and the class
    mix 0.6/0.4 (SLO admission against FIFO).  Every request of every stream
    is answered exactly once; the continuous recall@10 must reach
    JAX_CONTINUOUS_RECALL (the JAX driver at the same flags, on the CPU)
    less 0.02 and must not fall more than 0.005 below the static line;
    gather_scores must launch in both runs and no plain version may run on
    a CUDA tensor.  Latency, in-SLO share, goodput, demoted and shed are
    reported, not gated.
18. continuous at full width, phase 9's cell: 64 queries submitted up front
    to 64 slots at the searcher's frontier (no refill) must give the
    one-shot search's ids, n_evals and hops; then 1,024 queries as a
    Poisson trace at utilization 0.4 through 48 slots at frontier 12, whose
    recall@10 must not fall more than 0.005 below phase 9's.  Ticks,
    lock-steps per tick, ms per tick and the launches by site (admission,
    lock-steps) are printed, and no plain version may run on a CUDA
    tensor; one window of ticks is profiled.

19. sharded serving at the serve defaults: ``launch.serve.build_and_serve_sharded``
    on 4 ranks spawned on the one card (gloo with CUDA tensors: NCCL refuses
    two ranks on one card), n=20,000, d=32, KL, NN 15, 8 rounds, 32 slots,
    ef 96, k 10, 256 queries (``repro``'s ``--shards 4`` defaults); then
    ``--drop-shards 1``, ``--steps-per-sync 2`` and n=19,999 (a pad row), all
    in one spawn with the launch counts set to 0 before each run.  Each
    recall@10 must reach JAX_SHARDED_RECALL (the JAX package's ``launch.serve``
    at the same flags, on the CPU) less 0.02 and, without a dropped shard, stay at least
    the replicated scheduler's less 0.005; no id >= n may surface; under
    ``--drop-shards 1`` ids stay below 3 x n_local and evals fall.  On every
    rank the local build must launch two_hop_scores and frontier_scores, the
    ground truth (``sharded_knn_scan``) distance_matrix and the ticks
    gather_scores, and no plain version may run on a CUDA tensor.  Then one
    run at world size 1 under NCCL in this process, whose one-shot sharded
    search and sharded scheduler must equal ``batched_beam_search`` from
    entry 0 on the same graph (ids, evals, distances).
20. sharded at full width: phase 9's data over 4 spawned ranks of 250,000
    rows (NN 30, M 60): each rank's local NN-descent build, the
    ``sharded_knn_scan`` ground truth against phase 18's ``knn_scan``
    (distances within rtol 1e-4, >= 0.98 of ids equal), the one-shot
    ``sharded_graph_search`` at frontier 4, ef 512 in batches of 64
    (recall@10 > 0.5, beside phase 9's), 64 queries through 64 slots of the
    ``ShardedSlotScheduler`` with no refill (equal to the one-shot search bit
    for bit: ids, distances, evals), then 256 queries through 48 slots at
    frontier 12, 4 lock-steps per sync: ticks, ms per tick, the exchange's
    share of the tick and q/s.  The same launch and plain-version checks.

21. the tuner: ``core.autotune`` at ``benchmarks/bench_autotune.py``'s full
    workload on the port's numpy data (KL, n=4,096, d=32, 128 queries split 64
    calibration / 64 holdout; SW-graph wave 64, NN 15, ef_construction 100; the
    full axes, patience included; 3 rungs; the hand anchor ``blend(0.75)/ef 32``).
    ``pick(max_evals=hand)`` must recall at least as much as the hand spec at no
    more evals; its holdout recall@10 must reach JAX_TUNED (the JAX package's
    tuner on the same arrays, on the CPU) less 0.02; its artifact must load back
    through the port's ``load_spec``.  Then ``build_and_serve(spec=tuned)`` at the
    serve defaults (n=20,000): recall, q/s, build seconds and whether the port
    chose the JAX tuner's spec are reported, not gated (near-ties can flip).
22. learned distances: ``core.learned.fit_construction_distance`` on
    ``benchmarks/bench_learned.py``'s workload B at full size (BM25, 2,048
    documents, vocab 1,024, 64 queries split 32 / 32, with the ``natural``
    context row): learned >= hand at no more evals on calibration, and the
    holdout recall@10 at least JAX_LEARNED's less 0.02.  Then, on phase 9's data
    (n=10^6, d=128), ``true_neighbor_ids`` for 512 anchors (through
    ``distance_matrix``) must hold no anchor among its own positives and equal
    ``knn_scan``'s k_pos + 1 ids with self removed; ``fit_mahalanobis_map`` at its
    defaults must give a finite map.  The seconds are reported.
23. the two-tower path at ``examples/recsys_ann.py``'s shape: the SMOKE config
    trained 60 steps at batch 256 (the loss must fall), 20,000 candidates and 64
    queries embedded, K=20, the ``knn_scan`` truth; a plain SW-graph index (wave
    64, NN 16, ef_construction 100, ef 128); the learned construction
    distance fitted on a subsample of 4,096 with 32 calibration queries,
    deployed at 20,000 and served through
    ``ANNIndex.scheduler(frontier=spec.frontier)``, whose ids must equal the
    searcher's.  Each index must recall > 0.7 (the example's own check) in a
    tie-aware recall@20, which counts a returned id as a hit when it is as
    near as the 20th true neighbour (the corpus repeats item rows), and its
    id-based recall@20 must reach JAX_TWO_TOWER_RECALL less 0.02.
    Phases 21–23 log their launches by kernel and site; gather_scores and
    distance_matrix must launch, and no plain version may run on a CUDA tensor.

24. the dense LM, llama3.2-1b at full width (16 layers, d 2,048, 32/8 heads,
    d_ff 8,192, vocab 128,256, tied, remat; bf16): ``launch.train.main(["--arch",
    "llama3.2-1b", "--steps", "20"])`` at ``repro``'s defaults (batch 8, seq 128,
    block 64; steps cut from 100): the loss must be finite and fall; tok/s, ms per
    step, peak memory and the model-FLOPs share (6 N tokens over the step time at
    the bf16 peak) are printed, and one step is profiled.  Then, in float32 with
    TF32 off, a prompt of 32 (batch 2) and 16 greedy decode steps: every step's
    logits within DECODE_TOL of ``forward``'s over the same prefix, relative to
    the step's largest logit, with equal argmax.  Then bf16 serving (batch 8,
    prompt 512: prefill ms, decode ms per token over 32 tokens, one decode step
    profiled); ``blockwise_attention`` forward and backward at (8, 128, 32/8, 64)
    and (1, 4,096, 32/8, 64, block 512) beside ``scaled_dot_product_attention``
    (the library yardstick; never on the path); the SMOKE forward on the card
    within 1e-5 of the CPU's.
25. crash-resume at ``examples/train_lm.py``'s llama-110m (12 layers, d 512,
    vocab 32,000, f32, batch 4, seq 256, a checkpoint every 50 steps): 75 steps
    uninterrupted, then a run killed after step 50 and one resumed from its
    checkpoint to 75; the resumed losses and final parameters equal the
    uninterrupted run's bit for bit, the save and restore seconds printed.  Then
    gemma3-12b at full width: 6 layers (one 5:1 period) in f32, a prompt of 1,536
    past the 1,024 window and 16 decode steps held to ``forward`` as in phase 24,
    and again with the decode window planted one key wide, which the check must
    fail; and all 48 layers in bf16: prefill of 2,048 and 16 decode steps, timed.
26. the MoE LMs at full width, cut in depth to fit the card (no kernel of the
    port lies on this path: the experts are batched ``@`` products).
    phi3.5-moe (16 experts, top-2, d 4,096, d_ff 6,400) at 1 layer trained for
    20 steps through ``train_lm`` at ``repro``'s defaults (batch 8, seq 128,
    block 64): the loss finite and falling; ms per step, tok/s, the model-FLOPs
    share at ``n_active_params``, peak memory and the aux printed, one step
    profiled.  At 16 layers in bf16: prefill 8 x 512 and 32 decode tokens timed
    (one decode step profiled) and each prefill layer's dropped share of
    assignments.  At 4 layers in f32 with a dropless capacity (capacity_factor
    E / top_k, C = N + 1): decode held to ``forward`` as in phase 24, and no
    assignment dropped.  kimi-k2 (384 experts, top-8, one shared, d 7,168,
    vocab 163,840) at 1 layer in bf16: ``forward`` and ``lm_loss`` at
    1 x 2,048 under no_grad, then prefill 8 x 512 and 16 decode tokens, with
    the dropped shares; its ``moe_ffn`` at 1 x 2,048 and at 8 x 1 held, at 8
    tokens each (those with a dropped assignment first), against a plain loop
    over each token's kept top-8 experts and the shared expert on the same
    weights, within 2% relative Frobenius error.  The kimi-k2 SMOKE forward on
    the card within 1e-5 of the CPU's.
27. the GCN (gcn-cora's 2 layers, hidden 16, sym norm): ``random_graph`` at
    ogb_products' shape (2,449,029 nodes, 61,859,140 edges, d_feat 100, 47
    classes) trained full batch for 20 AdamW steps through ``gnn_loss``: the
    loss finite and falling, ms per step, the peak beside the reckoned one, one
    step profiled; the first layer's aggregate at 4,096 sampled receivers
    within rtol = atol = 1e-4 of a float64 recomputation on the host from the
    same edge list.  Then minibatch_lg's (232,965 nodes, 114,615,892 edges,
    d_feat 602, 41 classes): ``build_csr`` at max_degree 64 timed, 1,024 seeds
    sampled at fanouts (15, 10) from a generator on the card, the sampled
    forward and its backward timed over 10 steps; the last step's logits
    within rtol = atol = 1e-4 of the same function on the CPU over the same
    sampled ids (``index_add_`` adds in no fixed order on the card).
28. the recsys ranking models at full width, tables not cut (no kernel of the
    port lies on this path: ``repro``'s einsums, ``@`` products and gathers
    stay PyTorch ops): AutoInt (39 criteo-like fields, 29,011,456 padded rows
    x 16), DIN (5 fields, 1,111,552 x 18, history 100) and DCN-v2 (13 dense +
    26 sparse, 28,999,168 x 16).  For each: ``launch.train.main(["--arch",
    a])`` at ``repro``'s launcher defaults (batch 8, 100 steps), the loss
    finite; ``train_recsys`` for 20 steps at ``repro.launch.cells``'
    train_batch (65,536), the loss finite and falling: ms per step after the
    first, examples/s, peak memory, the model-FLOPs share (3 x
    ``_recsys_flops`` over the step time at the bf16 peak) and the step's
    bytes bound (``_recsys_cell``'s ``analytic_bytes`` at 3.35 TB/s), the
    host's draw of one batch, one step profiled; ``forward`` under no_grad
    timed at serve_p99 (512 rows), serve_bulk (262,144) and retrieval_cand
    (10^6 rows in chunks of 262,144, then one top-100); the trained model
    against a CPU copy (TF32 off): a 256-row forward within 1e-5 of the
    largest |logit|, one train step at batch 4,096 from equal weights, loss
    and grad_norm within 1e-4 relative; the SMOKE forward within 1e-5 of
    the CPU's; at DCN-v2 ``embedding_bag`` over its table, 65,536 ragged
    bags of 1-40 ids in sum, mean and max, within rtol = atol = 1e-5 of the
    CPU.  Then the paper's six retrieval configs resolve through
    ``configs.get_config`` / ``get_module`` and are printed.
29. the device mesh (``repro_torch.sharding.api``; no kernel of the port lies on
    these paths: ``repro``'s regions are einsums, takes, softmax and
    ``segment_sum``): one spawn of 4 ranks that share the card (gloo with CUDA
    tensors, ``psum_scatter`` composed of an all-reduce and the rank's block), a
    (2, 2) ("data", "model") mesh, the sub-checks in turn with memory freed
    between them, rank 0 running each off-mesh reference first on the global
    tensors it shards.  ``sharded_xent`` on llama3.2-1b FULL's tied head (vocab
    over "model") and hidden states of its ``forward_hidden`` at 4 x 4,096
    (``t_chunk`` 512): loss rtol 1e-5, gradients of hidden and the head rtol
    1e-4, atol 1e-6.  ``decode_step(mesh=)`` for 8 steps from seeded random
    caches, llama3.2-1b FULL in f32 at cache 32,768 and gemma3-12b at 6 layers in
    f32 at cache 4,096 (batch 4, dp 2 x seq 2; rows cross the seq-shard boundary,
    gemma3's past its window): each step's logits within DECODE_TOL of its
    largest |logit|, equal argmax, the written k and v within rtol = atol = 1e-5
    and no other entry changed; a block-local mask planted into gemma3's run
    must fail.  ``moe_ffn`` (expert-parallel) on phi3.5-moe at 1 layer in f32, 8
    x 512 tokens at its capacity factor (assignments drop): output, aux and the
    gradients of the input, the router and the experts within rtol 2e-4, atol
    2e-5 of the off-mesh gather path over the 2 data groups.  The row-sharded
    ``embedding_lookup`` over AutoInt FULL's whole table at B 65,536 (scatter
    path) and 5 (psum path), with an integer-valued cotangent: the lookup and
    each rank's block of the table's gradient equal, and no collective of the
    path as large as a table block.  The GCN at ogb_products' shape on a (4, 1)
    mesh, each rank a quarter of the self-looped edges: ``forward(edge_sharded=
    True)``, ``loss_fn`` and the gradients within rtol = atol = 1e-4.  Per
    check: the collectives by kind (calls, bytes, seconds), ms on and off the
    mesh, peak memory per rank.  Then every path at SMOKE (and ``lm_loss``
    through ``sharded_xent``, dense and MoE, and the MoE's on a ("data",) mesh
    through the gather path) on a (1, 1) mesh of a world-1 NCCL group in this
    process, against the off-mesh path.
30. FSDP x TP and the dry run (``models/transformer.py`` on parameters laid
    out by ``param_specs``, ``launch/{cells,dryrun,roofline}.py``).  (a) On
    phase 29's 4 ranks and (2, 2) ("data", "model") mesh (the same spawn):
    llama3.2-1b at full width in f32, cut to FSDP_LAYERS layers, its
    parameters as FSDP x TP blocks: ``prefill`` of FSDP_B x FSDP_PROMPT
    tokens into a FSDP_CACHE-position cache (sequence over "model") and
    FSDP_DECODE_STEPS ``decode_step(mesh=)`` steps, then one AdamW train step
    of FSDP_B x FSDP_T tokens with ``accum_steps=2``, each against rank 0's
    off-mesh path: the prefill logits and each decode step's within
    DECODE_TOL of the largest |logit| (logits reach ~1,600 at full width,
    and a TP sum's rounding scales with them, not with each entry) with
    equal argmax, the cache within rtol = atol = 1e-5, the loss and gradient norm within 1e-5 relative, the clipped
    gradients within 1e-5 and the parameters after the step within 2e-6
    (within the lr where the gradient is below 1e-6: AdamW's first update
    g / (|g| + 1e-8) amplifies its rounding there).  Per rank: the
    collectives by kind, the FSDP gathers' seconds, the peak.  Then the same
    at SMOKE on phase 29's (1, 1) mesh of a world-1 NCCL group.  (b) In
    subprocesses,
    rank 0 of the (16, 16) production mesh under a ``fake`` group of 256:
    ``dryrun.run_cell`` for PRODUCTION_CELLS, its meta pass in one process
    beside (a), its card pass (``count=False``) in another after it; each
    cell's measured peak beside its meta-reckoned peak and its step's ms;
    fails if
    a cell errs, if a cell the meta record says fits passes 80 GB, or if the
    two-tower retrieval cell launches no ``distance_matrix`` (the counts set
    to 0 just before its step and read just after).  ``distance_matrix`` is
    timed at that cell's per-rank shape (1 x 3,908 x 256, negdot).

31. strict mode on the card (``core/runtime_checks.py``): under
    ``enable_strict_mode({"REPRO_STRICT": "1"})`` (CUDA sync debug ``warn``)
    with every warning recorded, at the serve defaults (n=20,000, d=32, KL,
    NN-descent NN 15): (a) one batch of STRICT_BATCH queries through the
    static searcher (ef 96, frontier 4), (b) the slot scheduler's
    ``run_stream`` over STRICT_STREAM queries (48 slots, frontier 12, 4
    lock-steps per tick).  Each synchronizing call is counted by its site
    (the innermost frame of the repo on the warning's stack).  Held: (a)
    one ``.item()`` per lock-step plus SEARCH_SYNCS_FIXED (the loop's last
    check, the seeding's scalar upload and the readback); (b) per stepping
    tick one ``done`` read, per admission ADMIT_SYNCS uploads, per retiring
    tick RETIRE_SYNCS (the retiring rows' index upload and their copy);
    results equal to the same calls without strict mode.  Then, under
    ``REPRO_STRICT_TRANSFER=disallow``, a tick whose slots were admitted
    before must raise at its ``done`` read; strict mode is then turned off.

Phase 10 also times each kernel at the sharded paths' shapes and, each held
to the plain version, at the shapes phases 21-23 give it: gather_scores at
the tuner's search step (64, 60) at m'=32, BM25's search step (32, 30) at
vocab 1,024 under both views, a wave-build step under a learned BM25
distance with its rank-16 Mahalanobis branch (64, 30), and the two-tower
search step (64, 32) under negdot at m'=32; distance_matrix at a
``true_neighbor_ids`` chunk, 512 x 4,096 x 128.  The last
three lines are the card line, a JSON object with the kernels' numbers, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
DISTANCES = ["kl", "itakura_saito", "renyi_0.25", "l2", "negdot"]
TOL = dict(rtol=1e-5, atol=1e-5)

N_FULL, D_FULL, Q_FULL, BATCH = 1_000_000, 128, 1024, 64
KERNEL_SOURCES = ("frontier_gather", "distance_matrix", "gather_topk")
DM_DISTANCES = DISTANCES[:3] + ["renyi_2"] + DISTANCES[3:]
# (B, N, m'): bench_kernels.py's SHAPES, a ragged tile (once with rows TMA
# cannot read), m' on both sides of the TPU kernel's block_k (2048), and
# build_sharded's stitch at the serve data
DM_CHECK_SHAPES = [(128, 4096, 8), (128, 4096, 32), (128, 4096, 128), (512, 8192, 128),
                   (33, 300, 64), (33, 300, 30), (64, 1000, 512), (64, 1000, 2100),
                   (20_000, 64, 32)]
# (B, M, m'): a frontier block, a search step, the wave build's reverse edges
# at d = 32 and 128, wide rows (chunked), a B*M that is no multiple of a
# warp's cells, one cell, and wide rows at too few cells per row for a run
# (reverse edges at d = 512; M = 3)
GS_CHECK_SHAPES = [(64, 30, 128), (64, 240, 128), (960, 1, 32), (960, 1, 128), (64, 30, 2100),
                   (5, 3, 16), (1, 1, 4), (960, 1, 512), (4, 3, 2100)]
SWGRAPH_NS = (1_000_000, 200_000, 100_000, 50_000, 30_000, 20_000, 10_000)
# phase 7's n: 250 (500 before the mesh phase joined the script, 2,000 before the
# churn phases, 1,000 before the tuning and learning phases; the sequential paths
# are host-bound, one lock-step per kernel launch)
SEQ_N = 250
# 15 s (45 s, which chose n = 20,000 at 85 ms per wave, before the FSDP x TP phase
# joined the script; 75 s, which chose n = 50,000, before the LM phases; 150 s, which
# chose n = 100,000, before the churn phases); 30,000 and 20,000 joined the sizes when
# a host at 82.5 ms per wave fit none of the others in 75 s, 10,000 with the 15 s
SWGRAPH_BUILD_BUDGET_S = 15.0
# phase 8's rows (20,000, the serve defaults', before the FSDP x TP phase joined the
# script; a one-shard build is two wave builds of them)
SHARDED_BUILD_N = 10_000
# phase 11's profiled SW-graph wave build: 8 waves of 64 (32 before the FSDP x TP
# phase: the profiler's host work per recorded kernel, ~0.7 ms, made its 108,549
# kernels the phase's 76 s); phase 16's profiled insert round: 64 points (192)
PROFILED_WAVES, PROFILED_INSERTS = 8, 64
GRAPH_QUALITY_N = 1_000_000
WRAPPER_KINDS = ("avg", "min", "reverse", "max", "blend(0.25)", "rankblend(0.5)", "learned",
                 "bm25")
# recall@10 of the JAX package's repro.launch.serve on the CPU at the same
# flags (tools/jax_policy_recall.py); phase 14 holds the port to each less 0.02
JAX_RECALL = {"avg": 0.9902, "min": 0.9766, "reverse": 0.952, "l2": 0.9516, "max": 0.9879,
              "blend(0.25)": 0.9898, "rankblend(0.5)": 0.991, "TUNED_spec.json": 0.9629,
              "LEARNED_weights.json": 0.7098, "bm25 none n=4000": 0.7234,
              "bm25 natural n=4000": 0.7160}

# recall@k_after_churn of the JAX package's repro.launch.serve on the CPU at the
# serve defaults with --churn-rounds 4 --churn-insert 256 --churn-delete 200
# (tools/jax_policy_recall.py --runs churn); phase 15 holds the port to it less 0.02
JAX_CHURN_RECALL = 0.9441
# recall@10 of the continuous line of the JAX package's repro.launch.serve on the
# CPU at the serve defaults with --continuous (tools/jax_policy_recall.py --runs
# continuous; its static line 0.9207); phase 17 holds the port to it less 0.02
JAX_CONTINUOUS_RECALL = 0.9246
# the scheduler's serve defaults (repro.launch.serve --slots, --cont-frontier)
SCHED_SLOTS, SCHED_FRONTIER = 48, 12
# recall@10 of the JAX package's repro.launch.serve --shards 4 on the CPU at its CLI
# defaults, and with --drop-shards 1 (tools/jax_policy_recall.py --runs sharded);
# phase 19 holds the port to each less 0.02 (n=19,999 and --steps-per-sync 2 to
# the defaults' floor)
JAX_SHARDED_RECALL = {"defaults": 0.9855, "drop 1": 0.7391}
# phase 19: repro's --shards 4 CLI defaults, then the same with --drop-shards 1,
# --steps-per-sync 2 and n = 19,999
SHARDS = 4
SHARDED_SERVE = dict(n_db=20_000, dim=32, n_queries=256, k=10, ef_search=96, slots=32, NN=15,
                     nnd_iters=8)
SHARDED_RUNS = {"defaults": {}, "drop 1": {"drop_shards": 1}, "steps 2": {"steps_per_sync": 2},
                "n=19999": {"n_db": 19_999}}
# phase 16: the deletes per round are sized so that compact() is predicted to
# fit this many seconds (60 s before the LM phases joined the script)
COMPACT_BUDGET_S = 30.0
CHURN_ROUNDS_FULL, CHURN_INSERT_FULL = 2, 256

# phase 21: bench_autotune.py's full workload, drawn as tools/jax_policy_recall.py
# --runs autotune draws it (KL, n = 4,096, d = 32, 128 queries split 64 / 64)
TUNE_N, TUNE_Q, TUNE_DIM = 4096, 128, 32
TUNE_BASE = dict(distance="kl", builder="swgraph", build_engine="wave", wave=64, NN=15,
                 ef_construction=100, k=10, frontier=1)
HAND_ALPHA, HAND_EF = 0.75, 32
# the JAX package's tuned spec on the same arrays (tools/jax_policy_recall.py --runs
# autotune): its holdout recall@10, the floor of phase 21 less 0.02, and its fingerprint
JAX_TUNED = {"holdout_recall@k": 0.9906, "spec_fingerprint": "5998cabb1169"}
# phase 22: bench_learned.py's workload B at full size (BM25, 2,048 documents and 64
# queries split 32 / 32, vocab 1,024); the JAX package's learned spec on the same arrays
# (tools/jax_policy_recall.py --runs learned): its holdout recall@10 and weights
JAX_LEARNED = {"holdout_recall@k": 0.75, "weights_fingerprint": "58d1967c9ff3"}
BM25_DOCS, BM25_Q, BM25_VOCAB = 2048, 64, 1024
# phase 23: examples/recsys_ann.py's shape (candidates, queries, K, the fit's subsample)
TT_N, TT_Q, TT_K, TT_FIT = 20_000, 64, 20, 4096
# recall@20 of examples/recsys_ann.py (the JAX package) on the CPU: its plain and its
# learned index; phase 23 holds the port's id-based recall to each less 0.02
JAX_TWO_TOWER_RECALL = {"plain": 0.705, "learned": 0.674}

# (B, R): search step = batch x frontier*M, NN-descent round = rows x (K*K + K + 8)
CHECK_SHAPES = [(64, 120), (4096, 248), (64, 240), (2048, 938)]
# the search step runs gather_scores, the NN-descent round frontier_scores
TIME_SHAPES = [("full search step B=64 R=240 (NN 30)", 64, 240),
               ("full NN-descent round B=1e6 R=938 (NN 30)", N_FULL, 938),
               ("serve-default search step B=64 R=120 (NN 15)", 64, 120),
               ("serve-default NN-descent round B=1e6 R=248 (NN 15)", N_FULL, 248)]
GS_KERNELS = ("gather_scores_kernel", "gather_cells_kernel")
# phase 24: llama3.2-1b trained at repro.launch.train's defaults (batch 8, seq 128,
# block 64) for LLAMA_STEPS steps (its default 100, cut for time); greedy decode of
# LM_DECODE steps after a prompt of LM_PROMPT, each step's logits held to forward's
LLAMA_STEPS, LM_PROMPT, LM_DECODE = 20, 32, 16
# each step's logits within DECODE_TOL of forward's, relative to the step's largest
# |logit| (f32 sums over d = 2,048 at logits up to ~650 differ by ~1e-3: an
# elementwise rtol = atol = 2e-4 fails on the small logits of such a row); the card
# reads 1.6e-6 at llama3.2-1b and 3.2e-6 at gemma3-12b, and phase 25 shows that a
# decode window off by one at gemma3-12b's prompt lies above it
DECODE_TOL = 1e-5
# (B, T, Hq, Hkv, dh, block, reps): the train step's attention and a long prefill's
ATTN_SHAPES = ((8, 128, 32, 8, 64, 64, 50), (1, 4096, 32, 8, 64, 512, 5))
# phase 25: examples/train_lm.py's llama-110m, its batch 4, seq 256 and checkpoint
# period 50; killed after step KILL_AT and resumed to RESUME_STEPS (steps cut from
# 100 and 150 for time)
CFG_110M_FIELDS = dict(name="llama-110m", n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                       d_head=64, d_ff=2048, vocab_size=32_000, rope_theta=10_000.0,
                       tie_embeddings=True, dtype="float32", remat=False, full_attention=True)
# the resumed run's losses and parameters equal the uninterrupted run's bit for bit:
# the same kernels on the same shapes in the same order, from the same state
KILL_AT, RESUME_STEPS = 50, 75
# gemma3-12b: one 5:1 period in f32 at a prompt longer than the 1,024 window
GEMMA_CUT_LAYERS, GEMMA_PROMPT = 6, 1536
# phase 26: phi3.5-moe at full width, cut in depth to fit one card: trained at
# repro.launch.train's defaults for MOE_STEPS steps at 1 layer (1.563 B params,
# ~38 GB with AdamW), served at 16 layers in bf16 (21.07 B, 42.1 GB), decode held to
# forward at 4 layers in f32 (21.8 GB); kimi-k2 at 1 layer in bf16 (19.44 B with its
# embeddings, 38.9 GB): forward and lm_loss at 1 x KIMI_SEQ, then serving at batch 8
PHI_TRAIN_LAYERS, PHI_SERVE_LAYERS, PHI_DECODE_LAYERS, KIMI_LAYERS = 1, 16, 4, 1
MOE_STEPS, KIMI_SEQ = 20, 2048
# kimi-k2's moe_ffn held at MOE_CHECK_TOKENS tokens of a 1 x KIMI_SEQ input (half of
# them with a dropped assignment where there are any) and of a decode-shaped 8 x 1
# one, against a per-token loop over the same weights: relative Frobenius error
# within the bf16 tolerance of the CPU tests (2%)
MOE_CHECK_TOKENS, MOE_CHECK_TOL = 8, 0.02
# phase 27: repro.launch.cells.GNN_SHAPE_DEFS' ogb_products (full batch) and
# minibatch_lg (sampled), gcn-cora at each shape's widths; AdamW at the cells' peak
# learning rate 1e-2 with train_lm's warmup (max(steps // 20, 5))
OGB_PRODUCTS = dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47)
MINIBATCH_LG = dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602, n_classes=41,
                    batch_nodes=1_024, fanouts=(15, 10))
GCN_STEPS, GCN_LR, CSR_MAX_DEGREE, SAMPLED_STEPS = 20, 1e-2, 64, 10
# index_add_ adds with atomics on the card: its sums are in no fixed order
SAMPLED_TOL = dict(rtol=1e-4, atol=1e-4)
# ogb_products' first-layer aggregate held at this many sampled receivers against a
# float64 recomputation on the host, within SAMPLED_TOL
AGG_CHECK_ROWS = 4096
# phase 28: the recsys ranking models at FULL, tables not cut: repro.launch.train's
# launcher defaults (batch 8, 100 steps), then train_recsys at repro.launch.cells'
# train_batch (65,536) for RECSYS_STEPS steps; forward at the cells' serving shapes,
# the 10^6 rows of retrieval_cand in chunks of RECSYS_CHUNK (DIN's attention MLP over
# 10^6 x 100 positions needs more than 80 GB in one pass), then a top-RECSYS_TOPK
RECSYS_ARCHS = ("autoint", "din", "dcn-v2")
RECSYS_STEPS, RECSYS_TRAIN_BATCH = 20, 65_536
RECSYS_SERVE = (("serve_p99", 512), ("serve_bulk", 262_144), ("retrieval_cand", 1_000_000))
RECSYS_SERVE_REPS = {"serve_p99": 20, "serve_bulk": 5, "retrieval_cand": 3}
RECSYS_CHUNK, RECSYS_TOPK = 262_144, 100
# the card against the CPU: a forward of RECSYS_PARITY_ROWS rows within RECSYS_FWD_TOL
# of the largest |logit| (f32, TF32 off); one train step at RECSYS_STEP_BATCH, loss and
# grad_norm within RECSYS_STEP_RTOL (the table's gradient is summed with atomics)
RECSYS_PARITY_ROWS, RECSYS_FWD_TOL = 256, 1e-5
RECSYS_STEP_BATCH, RECSYS_STEP_RTOL = 4096, 1e-4
# embedding_bag over DCN-v2's table: BAG_COUNT bags of 1 to BAG_MAX ids
BAG_COUNT, BAG_MAX = 65_536, 40
# phase 29: the on-mesh paths on 4 ranks that share the card, a (2, 2) ("data",
# "model") mesh (gloo with CUDA tensors), each held to the off-mesh path on rank 0;
# the GCN on a (4, 1) mesh so that its edges split four ways
MESH_RANKS, MESH_22, MESH_41 = SHARDS, ((2, 2), ("data", "model")), ((4, 1), ("data", "model"))
# sharded_xent: llama3.2-1b FULL's tied head and its hidden states at train_4k's seq
# 4,096, batch cut from the cell's 256 to 4; tests/test_multidevice.py's tolerances
XENT_B, XENT_T, XENT_CHUNK = 4, 4096, 512
XENT_LOSS_RTOL, XENT_GRAD_TOL = 1e-5, dict(rtol=1e-4, atol=1e-6)
# decode_step(mesh=): 8 steps from caches of seeded random k and v, batch cut from
# decode_32k's 128 to 4; rows 0 and 1 cross the seq-shard boundary (S / 2) during the
# steps, and gemma3-12b's rows all lie past its 1,024 window
MESH_DECODE_STEPS, MESH_DECODE_B = 8, 4
LLAMA_CACHE, LLAMA_LENGTHS = 32_768, (16_380, 16_383, 100, 32_000)
GEMMA_CACHE, GEMMA_LENGTHS = 4_096, (2_044, 2_047, 1_500, 3_000)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
# moe_ffn -> _moe_ffn_ep: phi3.5-moe at 1 layer in f32, 8 x 512 tokens at its own
# capacity factor; held to the off-mesh gather path over the mesh's 2 data groups
MOE_MESH_TOKENS, MOE_MESH_TOL = (8, 512), dict(rtol=2e-4, atol=2e-5)
# embedding_lookup: AutoInt FULL's whole table, the scatter path at the cells'
# train_batch and the psum path at a batch the 4 row shards do not divide
EMB_MESH_BATCHES = (65_536, 5)
# the GCN at ogb_products' shape: phase 27's tolerance (index_add_'s atomics)
GCN_MESH_TOL = dict(rtol=1e-4, atol=1e-4)
# phase 30: FSDP x TP on the (2, 2) mesh of phase 29, llama3.2-1b at full width in f32
# cut to FSDP_LAYERS layers; prefill of FSDP_PROMPT tokens into a FSDP_CACHE-position
# cache and FSDP_DECODE_STEPS decode steps, one AdamW step at FSDP_LR of FSDP_B x FSDP_T
# tokens in 2 microbatches
FSDP_LAYERS, FSDP_B, FSDP_T, FSDP_LR = 2, 4, 1024, 1e-3
FSDP_PROMPT, FSDP_CACHE, FSDP_DECODE_STEPS = 512, 1024, 4
STEP_TOL = dict(rtol=2e-6, atol=2e-6)
# one rank of the (16, 16) production mesh, executed (launch/dryrun.py)
PRODUCTION_CELLS = ("llama3.2-1b::train_4k", "llama3.2-1b::decode_32k", "gemma3-12b::decode_32k",
                    "two-tower-retrieval::retrieval_cand", "autoint::serve_p99")
PROFILER_FALLBACKS = []  # timings read from CUDA events where the profiler fell short
# phase 31: strict mode (CUDA sync debug) at the serve defaults; the host syncs held,
# site by site, to the counts the card showed (PERF.md §3).  A site is (file,
# function, a piece of its source line); each count is per unit of the run
STRICT_BATCH, STRICT_STREAM = 64, 256
# the static search: (site, per lock-step, per call)
SEARCH_SYNC_SITES = (
    # the loop's condition, once per lock-step and once more to end it
    (("src/repro_torch/core/batched_beam.py", "batched_beam_search", "st.done.all().item()"),
     1, 1),
    # seed_beams' upload of the scalar True
    (("src/repro_torch/core/batched_beam.py", "_pack_bits", "mask[ids.long()] = True"), 0, 1),
    # the readback of ids and evals
    (("chip_smoke.py", "searched", ".cpu().numpy()"), 0, 2),
)
# the slot scheduler: (site, per stepping tick, per admission, per retiring tick)
SCHED_SYNC_SITES = (
    (("src/repro_torch/core/scheduler.py", "tick", "done.cpu()"), 1, 0, 0),
    (("src/repro_torch/core/scheduler.py", "tick", "torch.as_tensor(ctl,"), 0, 1, 0),
    (("src/repro_torch/core/scheduler.py", "tick", "torch.as_tensor(Q_new,"), 0, 1, 0),
    (("src/repro_torch/core/batched_beam.py", "_pack_bits", "mask[ids.long()] = True"), 0, 1, 0),
    (("src/repro_torch/core/scheduler.py", "tick", "torch.as_tensor(idx,"), 0, 0, 1),
    (("src/repro_torch/core/scheduler.py", "tick", ".cpu().numpy()  # the retiring rows"),
     0, 0, 1),
)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_ids(gen, B, R, n, pad=0.1):
    ids = torch.randint(0, n, (B, R), generator=gen, device="cuda", dtype=torch.int32)
    drop = torch.rand((B, R), generator=gen, device="cuda") < pad
    return torch.where(drop, -1, ids).contiguous()


def bound(ids, m: int):
    """Least time for one call: (ms, "bytes" | "operations", gathered-rows ms).

    Bytes count every input read once and the output written once: the ids,
    the query reps and biases, the DISTINCT database rows and biases the ids
    name, and the (B, R) output.  Operations are 2 m' per valid (b, r) at the
    float32 rate.  The third number is the time to read every gathered row
    from device memory, with no reuse: the floor of a design that, like this
    kernel, fetches each (b, r) row on its own.
    """
    B, R = ids.shape
    valid = ids[ids >= 0]
    distinct = int(torch.unique(valid).numel())
    n_valid = int(valid.numel())
    row = 4 * m + 4
    nbytes = 4 * B * R + 4 * B * m + 4 * B + distinct * row + 4 * B * R
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2.0 * m * n_valid / H100_FP32_FLOPS
    gathered = (4 * B * R + 4 * B * m + n_valid * row + 4 * B * R) / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * gathered


def time_ms(fn, args_list, reps: int) -> float:
    """Mean ms per call from CUDA events around ``reps`` back-to-back calls
    cycling through ``args_list``; counts the host's launch gaps too."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(reps):
        fn(*args_list[i % len(args_list)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _profiled(fn):
    """Run ``fn()`` under torch.profiler; (host wall ms, [(device ms, count, kernel)]).

    The rows are the CUDA kernels' own times, as the profiler's table sums them.
    """
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  reverse=True)
    return wall_ms, rows


def device_ms(fn, args_list, reps: int, kernel=None) -> float:
    """Mean device time per call: the kernels ``fn`` launches, without host gaps.

    CUDA events around back-to-back calls also count the time the card
    waits for the host to launch the next call, which exceeds a short
    kernel's own time; the profiler's kernel records do not.  ``kernel``
    names (a substring, or a tuple of them) the kernel of which each call
    launches exactly one: a window that holds another number of its records
    lost some (or caught others) and is profiled again, at most twice.
    Without ``kernel`` (plain versions) a window needs one record per call.
    Every window's counts are logged, so a reading can be traced.  The
    profiler on the card sometimes loses every record of a window; when all
    three windows fall short, the time is read from CUDA events instead
    (``time_ms``, host gaps included) and the log says so.
    """
    names = (kernel,) if isinstance(kernel, str) else kernel
    for a in args_list[:2]:
        fn(*a)

    def run():
        for i in range(reps):
            fn(*args_list[i % len(args_list)])

    for _ in range(3):
        _, rows = _profiled(run)
        recorded = sum(r[1] for r in rows)
        if names is None:
            ok, what = recorded >= reps, f"{recorded} records"
        else:
            mine = sum(r[1] for r in rows if any(k in r[2] for k in names))
            ok, what = mine == reps, f"{mine} of {'/'.join(names)} in {recorded} records"
        log(f"device_ms: {what} for {reps} calls" + ("" if ok else "; again"))
        if ok:
            return sum(r[0] for r in rows) / reps
    return event_fallback(fn, args_list, reps)


def event_fallback(fn, args_list, reps: int) -> float:
    """CUDA-event time per call, where the profiler recorded too little."""
    PROFILER_FALLBACKS.append(getattr(fn, "__name__", "fn"))
    ms = time_ms(fn, args_list, reps)
    log(f"device_ms: the profiler fell short three times; CUDA events read {ms:.6f} ms "
        f"per call (host gaps included)")
    return ms


def device_ms_of(fn, reps: int, kernel: str):
    """Mean device time per call of ``fn()``, split in two: the kernels whose
    name holds ``kernel``, and every other kernel ``fn`` launches.  Where the
    profiler records no ``kernel`` in three windows, the first is the whole
    call's CUDA-event time and the second is None (not measured)."""
    fn()
    for _ in range(3):
        _, rows = _profiled(lambda: [fn() for _ in range(reps)])
        mine = sum(r[0] for r in rows if kernel in r[2])
        if mine:
            return mine / reps, (sum(r[0] for r in rows) - mine) / reps
        log(f"device_ms_of: the profiler recorded no {kernel} kernel; again")
    return event_fallback(fn, [()], reps), None


def profile_device(fn, label: str) -> None:
    """Device time by kernel and the idle share of ``fn()`` under torch.profiler.

    The wall time includes the profiler's own host overhead, so the idle
    share reads high.
    """
    wall_ms, rows = _profiled(fn)
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms:
        log(f"profile {label}: wall {wall_ms:.3f} ms, device time not measured "
            f"(the profiler recorded no CUDA kernels)")
        return
    log(f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f}, {sum(r[1] for r in rows)} kernels")
    for ms, count, key in rows[:8]:
        log(f"  {ms:10.3f} ms  {count:6d} x  {key[:90]}")


def dm_bound(B: int, N: int, m: int, itemsize: int = 4):
    """Least time of one (B, N, m') distance-matrix call, two lines:
    ``{"tensor_core": (ms, by), "fp32_simt": (ms, by)}``.

    Bytes: both reps and biases read once, the (B, N) float32 output written
    once.  Operations, tensor-core line (the kernel's type): float32 reps run
    as 3xTF32, 3 x 2 B N m' at the TF32 rate; bf16 reps 2 B N m' at the bf16
    rate.  The float32-SIMT line (2 B N m' at 67 TFLOP/s) is the bound of
    PR 12's SIMT kernel, kept for continuity.
    """
    nbytes = itemsize * (B + N) * m + 4 * (B + N) + 4 * B * N
    t_bytes = nbytes / H100_BYTES_PER_S
    flops = 2.0 * B * N * m
    t_tc = 3 * flops / H100_TF32_FLOPS if itemsize == 4 else flops / H100_BF16_FLOPS
    lines = {}
    for name, t_ops in (("tensor_core", t_tc), ("fp32_simt", flops / H100_FP32_FLOPS)):
        lines[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return lines


def two_hop_bound(safe_adj, m: int):
    """Least time of one two_hop_scores call on ``safe_adj``, two lines:
    ``{"tensor_core": (ms, by), "fp32_simt": (ms, by)}``.

    Bytes: the adjacency, both prepped copies of the rows (reps and biases)
    read once, the (n, K*K) output written once.  Operations: 2 m' per valid
    output (c != i).  Each work item is a small product (its edges' query
    rows against the K rows of its middle node), so the tensor-core line
    counts them as distance_matrix's: 3xTF32 at the TF32 rate; the
    float32-SIMT line (67 TFLOP/s) is the rate the kernel computes at.
    """
    n, K = safe_adj.shape
    two_hop = safe_adj[safe_adj.reshape(-1).long()].reshape(n, K * K)
    valid = int((two_hop != torch.arange(n, device=two_hop.device)[:, None]).sum())
    nbytes = 4 * n * K + 2 * (4 * n * m + 4 * n) + 4 * n * K * K
    t_bytes = nbytes / H100_BYTES_PER_S
    flops = 2.0 * m * valid
    lines = {}
    for name, t_ops in (("tensor_core", 3 * flops / H100_TF32_FLOPS),
                        ("fp32_simt", flops / H100_FP32_FLOPS)):
        lines[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return lines


def check_close(label, got, want, tol, pad=None):
    """Hold a kernel's output to its plain version; returns the max abs error."""
    torch.cuda.synchronize()
    inf_want = torch.isinf(want) if pad is None else pad
    if not torch.equal(torch.isinf(got), inf_want):
        raise AssertionError(f"{label}: inf positions differ")
    torch.testing.assert_close(got, want, **tol)
    fin = ~inf_want
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / want[fin].abs().clamp(min=1e-30)).max()) if diff.numel() else 0.0
    log(f"check {label}: max abs err {err:.3e}, max rel err {rel:.3e}")
    return err


def check_wrappers(X_chk, gen, rng) -> dict:
    """Phase 3 for the wrappers: each kind's branch-lowered kernel scores
    against its own plain forms on the card; the max abs error by (kernel,
    kind).  Each site must launch its kernels once per branch."""
    from repro_torch.core.distances import get_distance, tree_map
    from repro_torch.core.spec import DistancePolicy
    from repro_torch.core.symmetrize import LearnedDistance
    from repro_torch.data.synthetic import text_collection
    from repro_torch.kernels import ops

    kl = get_distance("kl")
    L = np.random.default_rng(7).normal(size=(D_FULL, 16)).astype(np.float32) * 0.1
    learned_w = {"alpha": 0.75, "beta": 0.5, "tau": None, "L": L.tolist()}
    texts = text_collection(rng, 20_000, vocab=2048, device="cuda")
    errs = {}

    def plain(dist, ids, qc, consts):
        safe = torch.where(ids >= 0, ids, 0).long()
        return torch.where(ids >= 0, dist.score(tree_map(lambda a: a[safe], consts), qc),
                           torch.inf)

    def launched(fn, kernel, nb, label):
        ops.reset_launch_counts()
        out = fn()
        if ops.launch_counts()[kernel] != nb:
            raise AssertionError(f"{label}: {ops.launch_counts()[kernel]} launches of {kernel}, "
                                 f"expected one per branch ({nb})")
        return out

    for kind in WRAPPER_KINDS:
        if kind == "bm25":
            dist, X = texts.bm25(), texts.counts
        elif kind == "learned":
            dist, X = LearnedDistance.from_weights(kl, learned_w), X_chk
        else:
            dist, X = DistancePolicy.parse(kind).bind(kl, data=X_chk), X_chk
        nb, n, m = len(dist.branches), X.shape[0], X.shape[1]
        consts = ops.prepped(dist.prep_scan(X))
        qc = ops.prepped(dist.prep_queries(X[torch.randint(0, n, (64,), generator=gen,
                                                            device="cuda")]))
        ids = random_ids(gen, 64, 240, n)
        label = f"{dist.name} ({nb} branches)"
        errs[("gather_scores", kind)] = check_close(
            f"gather_scores {label} B=64 M=240 m'={m}",
            launched(lambda: ops.gathered_scores(dist, ids, qc, consts), "gather_scores", nb,
                     label),
            plain(dist, ids, qc, consts), TOL, pad=ids < 0)
        # the NN-descent round on a (4,096, 30) adjacency, as build_nndescent scores it
        n_j, K_j, rows = 4096, 30, 256
        cj = ops.prepped(dist.prep_scan(X[:n_j]))
        qj = ops.prepped(dist.prep_queries(X[:n_j]))
        safe = torch.randint(0, n_j, (n_j, K_j), generator=gen, device="cuda", dtype=torch.int32)
        iota = torch.arange(n_j, device="cuda", dtype=torch.int32)[:, None]
        rest = random_ids(gen, n_j, K_j + 8, n_j)
        rest = torch.where(rest == iota, -1, rest)
        out = torch.empty((n_j, K_j * K_j + K_j + 8), device="cuda")
        launched(lambda: ops.round_scores(dist, safe, rest, qj, cj, out), "two_hop_scores", nb,
                 label)
        if ops.launch_counts()["frontier_scores"] != nb:
            raise AssertionError(f"{label}: the round's frontier_scores ran "
                                 f"{ops.launch_counts()['frontier_scores']} times, not {nb}")
        cand = torch.cat([safe[safe[:rows].reshape(-1).long()].reshape(rows, K_j * K_j),
                          rest[:rows]], dim=1)
        cand = torch.where(cand == iota[:rows], -1, cand)
        errs[("round", kind)] = check_close(
            f"two_hop_scores + frontier_scores {label} n={n_j} K={K_j}, rows 0-{rows - 1}",
            out[:rows], plain(dist, cand, tree_map(lambda a: a[:rows], qj), cj), TOL,
            pad=cand < 0)
        Q, Xd = X[:512], X[512:512 + 8192]
        for mode in ("left", "right"):
            errs[("distance_matrix", kind, mode)] = check_close(
                f"distance_matrix {label} 512x8192x{m} {mode} mode",
                launched(lambda: ops.query_distance_matrix(dist, Q, Xd, mode=mode),
                         "distance_matrix", nb, label),
                dist.query_matrix(Q, Xd, mode=mode), TOL)
    return errs


def bm25_cell(n_db: int, policy: str) -> dict:
    """Phase 14's BM25 cell: a Zipf text collection (vocab 2,048, 256 held-out
    queries), NN-descent at the serve defaults under ``policy``, searched
    under BM25; recall@10 against ``knn_scan`` under BM25."""
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.core.spec import RetrievalSpec
    from repro_torch.data.synthetic import split_queries, text_collection
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    tc = text_collection(rng, n_db + 256, vocab=2048, mean_len=60, device="cuda")
    Q, X = split_queries(tc.counts, 256, rng)
    dist = tc.bm25()
    _, true_ids = knn_scan(dist, Q, X, 10)
    spec = RetrievalSpec(distance="bm25", build_policy=policy, NN=15, ef_search=96, frontier=4,
                         n_entries=4)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = ANNIndex.build(X, dist, spec=spec, natural=tc.natural,
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = ops.launch_counts()
    search = idx.searcher()
    found = torch.cat([search(Q[lo:lo + BATCH])[1] for lo in range(0, 256, BATCH)])
    return {"n_db": n_db, "build_policy": policy, "build_dist": idx.build_dist.name,
            "recall@k": recall_at_k(found, true_ids), "build_s": build_s,
            "build_launches": built}


class PlainCalls:
    """Counts the calls of the kernels' plain versions (``ops``' references)
    that receive a CUDA tensor, while the block runs; the originals after."""

    NAMES = ("gather_scores_ref", "distance_matrix_ref", "two_hop_scores_ref")

    def __init__(self, ops):
        self.ops, self.n = ops, 0

    def __enter__(self):
        self.saved = {name: getattr(self.ops, name) for name in self.NAMES}

        def counting(fn):
            def call(*args, **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    self.n += 1
                return fn(*args, **kwargs)
            return call

        for name, fn in self.saved.items():
            setattr(self.ops, name, counting(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


class Answered:
    """Records, for every ``run_stream`` of every slot scheduler while the
    block runs, the request count, the rids its ticks answered since its
    last ``reset`` (a stream answers each request exactly once), its ticks
    and their host wall ms, and its latency percentiles by class."""

    def __init__(self, cls):
        self.cls, self.streams, self.live = cls, [], {}

    def __enter__(self):
        cls, rec = self.cls, self
        self.saved = cls.tick, cls.reset, cls.run_stream

        def tick(sched, now=0.0):
            t0 = time.perf_counter()
            out = rec.saved[0](sched, now)
            live = rec.live.setdefault(id(sched), {"rids": [], "ticks": 0, "ms": 0.0})
            live["rids"].extend(r.rid for r in out)
            live["ticks"] += 1
            live["ms"] += 1e3 * (time.perf_counter() - t0)
            return out

        def reset(sched):
            rec.saved[1](sched)
            rec.live[id(sched)] = {"rids": [], "ticks": 0, "ms": 0.0}

        def run_stream(sched, Q, *args, **kwargs):
            res = rec.saved[2](sched, Q, *args, **kwargs)
            live = rec.live[id(sched)]
            lat = np.asarray([r.latency for r in res])
            prio = np.asarray([r.priority for r in res])
            rec.streams.append((len(Q), sorted(live["rids"]), {
                "requests": len(Q), "qos": sched._qos, "ticks": live["ticks"],
                "ms_per_tick": live["ms"] / max(live["ticks"], 1),
                "p50_ms_by_class": {int(c): 1e3 * float(np.percentile(lat[prio == c], 50))
                                    for c in np.unique(prio)},
                "p99_ms_by_class": {int(c): 1e3 * float(np.percentile(lat[prio == c], 99))
                                    for c in np.unique(prio)}}))
            return res

        cls.tick, cls.reset, cls.run_stream = tick, reset, run_stream
        return self

    def __exit__(self, *exc):
        self.cls.tick, self.cls.reset, self.cls.run_stream = self.saved

    def check(self, label):
        for n, rids, _ in self.streams:
            if rids != list(range(n)):
                raise AssertionError(f"{label}: a stream of {n} requests answered "
                                     f"{len(rids)} times, {len(set(rids))} distinct rids")
        log(f"{label}: {len(self.streams)} streams, every request answered exactly once: "
            + json.dumps([line for _, _, line in self.streams]))


def count_sites(sched):
    """Count the scheduler's device calls by site (admissions, ticks' steps,
    reranks), each wrapped on the instance; also the ticks and their wall ms."""
    calls = {"admit": 0, "step": 0, "rerank": 0, "tick": 0, "tick_ms": 0.0}

    def wrap(site, fn):
        def counted(*args, **kwargs):
            calls[site] += 1
            return fn(*args, **kwargs)
        return counted

    tick = sched.tick

    def timed_tick(now=0.0):
        t0 = time.perf_counter()
        out = tick(now)
        calls["tick"] += 1
        calls["tick_ms"] += 1e3 * (time.perf_counter() - t0)
        return out

    sched._admit = wrap("admit", sched._admit)
    sched._step = wrap("step", sched._step)
    sched.tick = timed_tick
    if sched._rerank_fn is not None:
        sched._rerank_fn = wrap("rerank", sched._rerank_fn)
    return calls


class Laps:
    """Wall seconds of each phase, logged as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        log(f"phase {phase}: {now - self.t:.1f} s")
        self.t = now


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def float32_highest() -> None:
    """This script's float32 settings: no TF32 in any PyTorch matmul."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def spawn_ranks(fn, *args) -> list:
    """``fn(device, *args)`` on SHARDS ranks through ``launch.serve.run_ranks``
    (the kernels are built: the ranks only load them); every rank's result.
    This process first returns its cached blocks to the card: the ranks
    need room for their contexts and their blocks."""
    from repro_torch.launch.serve import run_ranks

    torch.cuda.empty_cache()
    log(f"spawning {SHARDS} ranks: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    return run_ranks(fn, SHARDS, "cuda", *args)


def sharded_serve_rank(dev, runs: dict) -> dict:
    """Phase 19 on one rank: ``build_and_serve_sharded`` for each run, the
    launch counts set to 0 before each."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_and_serve_sharded

    float32_highest()
    out = {}
    with PlainCalls(ops) as plain:
        for label, kw in runs.items():
            ops.reset_launch_counts()
            out[label] = build_and_serve_sharded(shards=SHARDS, device=dev, verbose=False,
                                                 **{**SHARDED_SERVE, **kw})
    out["plain_calls_on_cuda"] = plain.n
    return out


def sharded_full_rank(dev, out_dir: str) -> dict:
    """Phase 20 on one rank, over its block of ``out_dir/X.npy``: the local
    build, the sharded ground truth, the one-shot search in batches, the
    no-refill scheduler and a 256-query stream.  Rank 0 also writes the
    replicated results to ``results.npz``."""
    from repro_torch.core.distances import get_distance
    from repro_torch.core.distributed import (ShardedSlotScheduler, build_local_subgraphs,
                                              collective_stats, local_block,
                                              sharded_graph_search, sharded_knn_scan,
                                              world_and_rank)
    from repro_torch.kernels import ops

    float32_highest()
    world, rank = world_and_rank()
    kl = get_distance("kl")
    X_local, n_real, n_local = local_block(
        torch.from_numpy(np.load(f"{out_dir}/X.npy", mmap_mode="r")), rank, world)
    X_local = X_local.to(dev)
    Q = torch.from_numpy(np.load(f"{out_dir}/Q.npy")).to(dev)
    Q_host = Q.cpu().numpy()
    out, launches, batch_ms = {"n_local": n_local}, {}, []

    def counted(name, fn):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
        launches[name] = ops.launch_counts()
        return r

    def one_shot():
        parts = []
        for lo in range(0, Q.shape[0], BATCH):
            t0 = time.perf_counter()
            parts.append(sharded_graph_search(kl, Q[lo:lo + BATCH], X_local, nbrs, 10, 512,
                                              n_real, frontier=4))
            torch.cuda.synchronize()
            batch_ms.append(1e3 * (time.perf_counter() - t0))
        return [torch.cat(p) for p in zip(*parts)]

    with PlainCalls(ops) as plain:
        nbrs = counted("build", lambda: build_local_subgraphs(kl, X_local, NN=30, nnd_iters=8,
                                                              seed=0))
        gt_d, gt_i = counted("ground_truth", lambda: sharded_knn_scan(kl, Q, X_local, 10, n_real))
        d1, i1, e1 = counted("search", one_shot)
        # (a) no refill: 64 slots at the one-shot's frontier
        sched = ShardedSlotScheduler(kl, X_local, nbrs, n_real, slots=BATCH, ef=512, k=10,
                                     frontier=4, steps_per_sync=4)
        res = counted("no_refill", lambda: sched.run_stream(Q_host[:BATCH]))
        got = [np.stack([r.ids for r in res]), np.stack([r.dists for r in res]),
               np.asarray([r.n_evals for r in res])]
        out["no_refill"] = {
            "ids_equal": bool(np.array_equal(got[0], i1[:BATCH].cpu().numpy())),
            "dists_equal": bool(np.array_equal(got[1], d1[:BATCH].cpu().numpy())),
            "n_evals_equal": bool(np.array_equal(got[2], e1[:BATCH].cpu().numpy()))}
        # (b) 256 queries through 48 slots at frontier 12
        sched = ShardedSlotScheduler(kl, X_local, nbrs, n_real, slots=SCHED_SLOTS, ef=512,
                                     k=10, frontier=SCHED_FRONTIER, steps_per_sync=4)
        sched.warmup(Q_host[0])
        c0 = collective_stats()
        res = counted("scheduler", lambda: sched.run_stream(Q_host[:256], warm=False))
        c1 = collective_stats()
    out.update(
        plain_calls_on_cuda=plain.n, launches=launches,
        batch_ms_p50=float(np.percentile(batch_ms, 50)),
        search_qps=Q.shape[0] / out["search_s"],
        scheduler={"queries": 256, "slots": SCHED_SLOTS, "frontier": SCHED_FRONTIER,
                   "steps_per_sync": 4, "ticks": sched.ticks,
                   "ms_per_tick": 1e3 * sched.tick_s / max(sched.ticks, 1),
                   "collectives_per_tick": (c1["calls"] - c0["calls"]) / max(sched.ticks, 1),
                   "collective_share": sched.exchange_s / max(sched.tick_s, 1e-12),
                   "qps": 256 / out["scheduler_s"],
                   "ids": np.stack([r.ids for r in res]).tolist()})
    if rank == 0:
        np.savez(f"{out_dir}/results.npz", gt_d=gt_d.cpu().numpy(), gt_i=gt_i.cpu().numpy(),
                 ids=i1.cpu().numpy(), evals=e1.cpu().numpy())
    return out


def check_rank_launches(label: str, ranks: list, runs: list, wanted: dict) -> None:
    """Every rank launched each kernel ``wanted`` names in its phase (the
    counts of ``runs``' launch dicts), and ran no plain version on the card."""
    for r, out in enumerate(ranks):
        if out["plain_calls_on_cuda"]:
            raise AssertionError(f"{label}: rank {r} ran {out['plain_calls_on_cuda']} "
                                 f"plain-version calls on CUDA tensors")
        for launched in runs[r]:
            for phase, kernels in wanted.items():
                for name in kernels:
                    if not launched[phase][name] > 0:
                        raise AssertionError(f"{label}: rank {r} did not launch {name} in its "
                                             f"{phase}: {launched}")


def sync_sites(fn):
    """``fn()`` with every synchronizing CUDA call counted by its site: the
    innermost frame of this repo on the warning's stack, as (path, line,
    function, source).  Returns (fn's result, Counter of sites)."""
    import traceback
    import warnings

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            log(f"phase 31: another warning under strict mode: {category.__name__}: {message}")
            return
        here = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(ROOT)) and f.name != "sync_sites"]
        f = here[-1] if here else traceback.FrameSummary(filename, lineno, "?")
        where = os.path.relpath(f.filename, ROOT) if f.filename.startswith(str(ROOT)) else f.filename
        sites[(where, f.lineno, f.name, (f.line or "").strip())] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        out = fn()
    return out, sites


def held_sites(sites, table, units) -> dict:
    """Each measured site's count beside the one ``table`` gives it for
    ``units`` (a tuple of unit counts, one per column of the table), as
    {"path:line function: source": [measured, held to]}.  A site that no
    row names, or that more than one row names, is held to 0; a row that
    names no measured site is held to its count as "<missing> ..."."""
    out, matched = {}, collections.Counter()
    for (where, line, name, src), n in sites.items():
        rows = [i for i, ((f, fn, piece), *_) in enumerate(table)
                if f == where and fn == name and piece in src]
        want = sum(u * c for u, c in zip(units, table[rows[0]][1:])) if len(rows) == 1 else 0
        if len(rows) == 1:
            matched[rows[0]] += 1
        out[f"{where}:{line} {name}: {src}"] = [n, want]
    for i, ((f, fn, piece), *counts) in enumerate(table):
        if not matched[i]:
            out[f"<missing> {f} {fn}: {piece}"] = [0, sum(u * c for u, c in zip(units, counts))]
    return out


def phase31() -> dict:
    """Strict mode on the card: the host syncs of the static searcher and of the
    slot scheduler at the serve defaults, by site, held to the counts PERF.md
    states; then the transfer guard's ``disallow`` on the scheduler's done read."""
    from repro_torch.core import batched_beam
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.runtime_checks import disable_strict_mode, enable_strict_mode
    from repro_torch.core.spec import RetrievalSpec
    from repro_torch.data.synthetic import lda_like_histograms, split_queries
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)  # build_and_serve's data at the serve defaults
    data = lda_like_histograms(rng, 20_000 + STRICT_STREAM, 32, device="cuda")
    Q, rest = split_queries(data, STRICT_STREAM, rng)
    X = rest[:20_000]
    spec = RetrievalSpec(distance="kl", builder="nndescent", NN=15, ef_construction=100,
                         n_entries=4, k=10, ef_search=96, frontier=4, slots=SCHED_SLOTS,
                         sched_frontier=SCHED_FRONTIER, steps_per_sync=4)
    idx = ANNIndex.build(X, spec=spec, generator=torch.Generator(device="cuda").manual_seed(0))
    search, Qb, Q_host = idx.searcher(), Q[:STRICT_BATCH], Q.cpu().numpy()

    def searched():
        _, ids, evals, _ = search(Qb)
        return ids.cpu().numpy(), evals.cpu().numpy()

    def scheduled(sched):
        res = sched.run_stream(Q_host, warm=False)
        return np.stack([r.ids for r in res]), np.asarray([r.n_evals for r in res])

    want_search = searched()  # also the warm-up
    plain = idx.scheduler()
    want_stream = scheduled(plain)
    torch.cuda.synchronize()

    steps = {"n": 0}
    step0 = batched_beam.beam_step

    def counted_step(*args, **kwargs):
        steps["n"] += 1
        return step0(*args, **kwargs)

    sched = idx.scheduler()
    calls = count_sites(sched)
    tick0, retiring = sched.tick, {"n": 0}

    def tick(now=0.0):
        out = tick0(now)
        retiring["n"] += bool(out)
        return out

    sched.tick = tick
    ops.reset_launch_counts()
    applied = enable_strict_mode({"REPRO_STRICT": "1"})
    try:
        batched_beam.beam_step = counted_step
        try:
            got_search, search_sites = sync_sites(searched)
        finally:
            batched_beam.beam_step = step0
        got_stream, stream_sites = sync_sites(lambda: scheduled(sched))
    finally:
        disable_strict_mode()
    launches = ops.launch_counts()
    if applied["sync_debug_mode"] != "warn" or torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError(f"phase 31: strict mode applied {applied}, left "
                             f"{torch.cuda.get_sync_debug_mode()} behind")
    for label, got, want in (("search", got_search, want_search),
                             ("stream", got_stream, want_stream)):
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"phase 31: the {label} under strict mode differs from "
                                 f"the same call without it")
    search_held = held_sites(search_sites, SEARCH_SYNC_SITES, (steps["n"], 1))
    search_line = {"lock_steps": steps["n"], "syncs": sum(search_sites.values()),
                   "held_to": sum(w for _, w in search_held.values()), "sites": search_held}
    stream_held = held_sites(stream_sites, SCHED_SYNC_SITES,
                             (calls["step"], calls["admit"], retiring["n"]))
    stream_line = {"requests": STRICT_STREAM, "ticks": calls["tick"],
                   "stepping_ticks": calls["step"], "admissions": calls["admit"],
                   "retiring_ticks": retiring["n"], "lock_steps": 4 * calls["step"],
                   "syncs": sum(stream_sites.values()),
                   "held_to": sum(w for _, w in stream_held.values()), "sites": stream_held}
    log("phase 31 (a) static search, one batch of 64: " + json.dumps(search_line))
    log("phase 31 (b) slot scheduler, 256 queries: " + json.dumps(stream_line))
    for label, line in (("(a) search", search_line), ("(b) scheduler", stream_line)):
        off = {site: c for site, c in line["sites"].items() if c[0] != c[1]}
        if off or line["syncs"] != line["held_to"]:
            raise AssertionError(f"phase 31 {label}: {line['syncs']} synchronizing calls, "
                                 f"held to {line['held_to']}; sites off their count "
                                 f"[measured, held to]: {off}")
    if not launches["gather_scores"] > 0:
        raise AssertionError(f"phase 31: gather_scores not launched: {launches}")

    # disallow: slots admitted without strict mode, then a tick that only steps
    guard = idx.scheduler()
    guard.reset()
    for q in Q_host[:guard.S]:
        guard.submit(q)
    guard.tick()
    if guard.n_pending or not guard.n_inflight:
        raise AssertionError("phase 31: the guard's first tick left requests pending or "
                             "retired every slot")
    enable_strict_mode({"REPRO_STRICT": "1", "REPRO_STRICT_TRANSFER": "disallow"})
    raised = None
    try:
        guard.tick()
    except RuntimeError as e:
        import traceback
        raised = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(str(SRC))][-1]
    finally:
        disable_strict_mode()
    if raised is None or "done" not in (raised.line or ""):
        raise AssertionError(f"phase 31: disallow did not raise at the done read: {raised}")
    disallow = f"{os.path.relpath(raised.filename, ROOT)}:{raised.lineno}: {raised.line.strip()}"
    log(f"phase 31: disallow raised at {disallow}")
    return {"applied": {k: list(v) if isinstance(v, tuple) else v for k, v in applied.items()},
            "search": search_line, "scheduler": stream_line, "launches": launches,
            "disallow_raised_at": disallow, "s": time.perf_counter() - t0}


def phase19(kl) -> dict:
    """Sharded serving at the serve defaults (see the module docstring)."""
    import torch.distributed as tdist

    from repro_torch.core.batched_beam import make_step_searcher
    from repro_torch.core.distributed import (ShardedSlotScheduler, build_local_subgraphs,
                                              init_group, pick_backend, sharded_graph_search)
    from repro_torch.data.synthetic import lda_like_histograms, split_queries
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_and_serve_sharded

    backend, per_card = pick_backend(SHARDS, "cuda")
    log(f"phase 19: {SHARDS} ranks, backend {backend}, {per_card} ranks per card")
    ranks = spawn_ranks(sharded_serve_rank, SHARDED_RUNS)
    runs = ranks[0]
    check_rank_launches("phase 19", ranks, [[rk[label]["kernel_launches"] for label in SHARDED_RUNS]
                                            for rk in ranks],
                        {"build": ("two_hop_scores", "frontier_scores"),
                         "ground_truth": ("distance_matrix",), "serve": ("gather_scores",)})
    for label, st in runs.items():
        if label == "plain_calls_on_cuda":
            continue
        floor = JAX_SHARDED_RECALL["drop 1" if st["drop_shards"] else "defaults"] - 0.02
        st["floor"] = round(floor, 4)
        log(f"sharded serve {label}: " + json.dumps(st))
        if st["recall@k"] < floor:
            raise AssertionError(f"phase 19 {label}: recall@10 {st['recall@k']} < {floor}")
        if not st["drop_shards"] and st["recall_gap"] > 0.005:
            raise AssertionError(f"phase 19 {label}: recall@10 {st['recall@k']} is more than "
                                 f"0.005 below the replicated {st['replicated_recall@k']}")
        if st["max_id"] >= st["n_db"]:
            raise AssertionError(f"phase 19 {label}: id {st['max_id']} >= n {st['n_db']}")
    drop, base = runs["drop 1"], runs["defaults"]
    if not (drop["max_id"] < 3 * drop["rows_per_shard"]
            and drop["mean_evals"] < base["mean_evals"]):
        raise AssertionError(f"phase 19: a dropped shard's ids surfaced or its evals counted: "
                             f"max id {drop['max_id']}, mean evals {drop['mean_evals']} against "
                             f"{base['mean_evals']}")

    # world size 1 under NCCL in this process: the sharded paths equal the
    # lock-step engine from entry 0 on the same graph
    rng = np.random.default_rng(0)  # build_and_serve_sharded's data
    data = lda_like_histograms(rng, 20_000 + 256, 32, device="cuda")
    Q, rest = split_queries(data, 256, rng)
    X = rest[:20_000]
    torch.cuda.set_device(0)
    init_group("nccl", f"tcp://localhost:{free_port()}", 0, 1)
    try:
        ops.reset_launch_counts()
        world1 = build_and_serve_sharded(shards=1, device="cuda", verbose=False,
                                         compare_replicated=False, **SHARDED_SERVE)
        nbrs = build_local_subgraphs(kl, X, NN=15, nnd_iters=8, seed=0)
        one = sharded_graph_search(kl, Q, X, nbrs, 10, 96, 20_000)
        res = ShardedSlotScheduler(kl, X, nbrs, 20_000, slots=32, ef=96, k=10).run_stream(Q)
        world1_launches = ops.launch_counts()
    finally:
        tdist.destroy_process_group()
    ref = make_step_searcher(kl, nbrs, X, 96, 10, frontier=1,
                             entries=torch.zeros((1,), dtype=torch.int32, device="cuda"))(Q)
    want = [t.cpu().numpy() for t in ref[:3]]  # dists, ids, evals
    sched = [np.stack([r.dists for r in res]), np.stack([r.ids for r in res]),
             np.asarray([r.n_evals for r in res])]
    equal = {f"{site} {key} equal": bool(np.array_equal(got, w))
             for site, outs in (("one-shot", [t.cpu().numpy() for t in one]), ("scheduler", sched))
             for key, got, w in zip(("dists", "ids", "evals"), outs, want)}
    world1 = {k: v for k, v in world1.items() if k != "kernel_launches_by_rank"}
    log("sharded serve world 1 (nccl): " + json.dumps({**world1, **equal,
                                                       "launches": world1_launches}))
    if not all(equal.values()):
        raise AssertionError(f"phase 19: world size 1 differs from batched_beam_search: {equal}")
    if world1["backend"] != "nccl":
        raise AssertionError(f"phase 19: world size 1 ran on {world1['backend']}, not nccl")
    return {"backend": backend, "ranks_per_card": per_card, "runs": runs,
            "launches_by_rank": [rk["defaults"]["kernel_launches"] for rk in ranks],
            "world1": world1, "world1_equal": equal}


def phase20(X, Q, d_true, true_ids, recall9) -> dict:
    """Sharded at full width over phase 9's data (see the module docstring)."""
    from repro_torch.core.distributed import pick_backend
    from repro_torch.core.metrics import recall_at_k

    backend, per_card = pick_backend(SHARDS, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/X.npy", X.cpu().numpy())
        np.save(f"{tmp}/Q.npy", Q.cpu().numpy())
        ranks = spawn_ranks(sharded_full_rank, tmp)
        res = dict(np.load(f"{tmp}/results.npz"))
    check_rank_launches("phase 20", ranks, [[rk["launches"]] for rk in ranks],
                        {"build": ("two_hop_scores", "frontier_scores"),
                         "ground_truth": ("distance_matrix",), "search": ("gather_scores",),
                         "no_refill": ("gather_scores",), "scheduler": ("gather_scores",)})
    true_ids, d_true = true_ids.cpu().numpy(), d_true.cpu().numpy()
    sched_ids = np.asarray(ranks[0]["scheduler"].pop("ids"))
    for rk in ranks[1:]:
        if np.asarray(rk["scheduler"].pop("ids")).tolist() != sched_ids.tolist():
            raise AssertionError("phase 20: the ranks retired different results")
    line = {"backend": backend, "ranks_per_card": per_card, "n_local": ranks[0]["n_local"],
            "knn_ids_equal_share": float((res["gt_i"] == true_ids).mean()),
            "knn_dists_max_rel_diff": float(np.max(np.abs(res["gt_d"] - d_true)
                                                   / np.maximum(np.abs(d_true), 1e-30))),
            "recall@k": recall_at_k(res["ids"], true_ids), "phase9_recall@k": recall9,
            "eval_reduction": float(N_FULL / res["evals"].mean()),
            "scheduler_recall@k": recall_at_k(sched_ids, true_ids[:256]),
            **{k: ranks[0][k] for k in ("no_refill", "batch_ms_p50", "search_qps", "scheduler",
                                        "build_s", "ground_truth_s", "search_s", "launches")}}
    log("sharded at full width n=1000000 d=128: " + json.dumps(line))
    if not np.allclose(res["gt_d"], d_true, rtol=1e-4, atol=0.0):
        raise AssertionError("phase 20: sharded_knn_scan distances differ from knn_scan's")
    if line["knn_ids_equal_share"] < 0.98:
        raise AssertionError(f"phase 20: {line['knn_ids_equal_share']} of the sharded scan's ids "
                             f"equal knn_scan's")
    if not line["recall@k"] > 0.5:
        raise AssertionError(f"phase 20: recall@10 {line['recall@k']} <= 0.5")
    if not all(ranks[0]["no_refill"].values()):
        raise AssertionError(f"phase 20: the no-refill scheduler differs from the one-shot "
                             f"sharded search: {ranks[0]['no_refill']}")
    return line


def launched_by(ops, fn):
    """``fn()``'s result, its wall seconds (to a device sync) and the kernel
    launches it made (the counts set to 0 just before)."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def tune_axes():
    """bench_autotune.py's full axes (patience included)."""
    from repro_torch.core.spec import Blend

    return dict(build_policy=[Blend(a) for a in (0.0, 0.25, 0.5, 0.75, 1.0)],
                ef_search=[16, 32, 96], frontier=[1, 2], adaptive=[False, True],
                patience=[1, 2])


def held_out(spec, X, Q, true_ids, seed, dist=None, natural=None) -> dict:
    """A fresh build of ``spec`` over X searched with Q: recall@10 and evals."""
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.metrics import recall_at_k

    idx = ANNIndex.build(X, dist, spec=spec, natural=natural,
                         generator=torch.Generator(device="cuda").manual_seed(seed))
    _, ids, n_evals, _ = idx.searcher(spec=spec)(Q)
    return {"recall@10": round(recall_at_k(ids, true_ids), 4),
            "evals_per_query": round(float(n_evals.float().mean()), 1)}


def m15_sites(X32, gen, max_err) -> list:
    """Phase 10 at the shapes phases 21-23 give ``gather_scores``: the tuner's
    KL search step at frontier 2 over its last rung (64 x 60, m' = 32); the
    BM25 search step of bench_learned's workload B (32 x 30, vocab 1,024)
    under both views (``bm25`` and ``natural``); a wave-build step under a
    learned distance over BM25 with a rank-16 Mahalanobis branch (64 x 30,
    two branches); the two-tower search step under negdot (64 x 32, m' = 32,
    ids over 20,000 unit rows).  Each branch's launch is held to the plain
    version on the same reps, and the whole site (a launch per branch, then
    the combine) to the same combine of the plain outputs; the rows time
    every branch (the combine excluded)."""
    from repro_torch.core.distances import get_distance
    from repro_torch.core.symmetrize import LearnedDistance
    from repro_torch.data.synthetic import text_collection
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_topk import gather_scores
    from repro_torch.kernels.ref import gather_scores_ref

    def site(label, dist, X_rows, Q_rows, M):
        consts = ops.prepped(dist.prep_scan(X_rows))
        qc = ops.prepped(dist.prep_queries(Q_rows))
        B, n = Q_rows.shape[0], X_rows.shape[0]
        args = [(random_ids(gen, B, M, n),) for _ in range(32)]
        ids = args[0][0]
        parts, plains = [], []
        for i, (b, x, q) in enumerate(zip(dist.branches, dist.branch_reps(consts),
                                          dist.branch_reps(qc))):
            def kernel(ids, b=b, x=x, q=q):
                return gather_scores(ids, q["rep"], q["bias"], x["rep"], x["bias"], b.post_id,
                                     b.c0)

            def plain(ids, b=b, x=x, q=q):
                return gather_scores_ref(ids, q["rep"], x["rep"], q["bias"], x["bias"],
                                         b.post_id, b.c0, b.query_left)

            m = int(x["rep"].shape[1])
            max_err[("gather_scores", "m15", label, i)] = check_close(
                f"gather_scores {label}, branch {i} m'={m} vs plain", kernel(ids), plain(ids),
                TOL, pad=ids < 0)
            b_ms, b_by, _ = bound(ids, m)
            plains.append(plain)
            parts.append({"branch": getattr(b, "name", str(i)), "m": m,
                          "ms": device_ms(kernel, args, 320, GS_KERNELS),
                          "ms_again": device_ms(kernel, args, 320, GS_KERNELS),
                          "event_ms": time_ms(kernel, args, 320), "bound_ms": b_ms,
                          "bound_by": b_by, "plain_ms": device_ms(plain, args, 64)})
        # the site as the path calls it (one launch per branch, then the
        # combine) against the same combine of the plain versions
        max_err[("gather_scores", "m15", label)] = check_close(
            f"gather_scores {label} B={B} M={M}, the whole site",
            ops.gathered_scores(dist, ids, qc, consts), dist.combine_([p(ids) for p in plains]),
            TOL, pad=ids < 0)
        row = {"shape": f"{label} B={B} M={M} m'={'+'.join(str(p['m']) for p in parts)}",
               "B": B, "R": M, "m": [p["m"] for p in parts],
               "ms": sum(p["ms"] for p in parts), "plain_ms": sum(p["plain_ms"] for p in parts),
               "bound_ms": sum(p["bound_ms"] for p in parts),
               "bound_by": max(parts, key=lambda p: p["bound_ms"])["bound_by"],
               "branches": parts}
        log("time gather_scores " + json.dumps(row))
        return row

    kl, negdot = get_distance("kl"), get_distance("negdot")
    tc = text_collection(np.random.default_rng(5), BM25_DOCS + BM25_Q, vocab=BM25_VOCAB,
                         device="cuda")
    docs, texts_q = tc.counts[:BM25_DOCS], tc.counts[BM25_DOCS:BM25_DOCS + BM25_Q // 2]
    L = np.random.default_rng(7).normal(size=(BM25_VOCAB, 16)).astype(np.float32) * 0.1
    learned = LearnedDistance.from_weights(tc.bm25(), {"alpha": HAND_ALPHA, "beta": 0.5,
                                                       "tau": None, "L": L.tolist()})
    emb = torch.randn((TT_N + 64, 32), generator=gen, device="cuda")
    emb = emb / emb.norm(dim=1, keepdim=True)
    return [
        site(f"tuner search step at frontier 2 (phase 21), ids over n={TUNE_N}", kl,
             X32[:TUNE_N], X32[TUNE_N:TUNE_N + 64], 2 * 2 * TUNE_BASE["NN"]),
        site(f"BM25 search step (phase 22), ids over {BM25_DOCS} documents", tc.bm25(), docs,
             texts_q, 2 * TUNE_BASE["NN"]),
        site(f"BM25 natural view (phase 22), ids over {BM25_DOCS} documents", tc.natural(),
             docs, texts_q, 2 * TUNE_BASE["NN"]),
        site("wave-build step under a learned BM25 distance with a rank-16 Mahalanobis branch "
             "(phases 22-23)", learned, docs, docs[:64], 2 * TUNE_BASE["NN"]),
        site(f"two-tower search step under negdot (phase 23), ids over {TT_N} unit rows", negdot,
             emb[:TT_N], emb[TT_N:], 2 * 16)]


def tie_aware_recall(users, items, ids, true_ids) -> float:
    """recall@K under negdot that counts a returned id as a hit when its
    distance is at most the K-th true distance, so that an item row as near
    as the K-th true neighbour (a duplicate) is no miss.  One formula, in
    float64 on the host, scores both sides."""
    U, I = users.double().cpu(), items.double().cpu()
    ids, true_ids = torch.as_tensor(ids).long().cpu(), torch.as_tensor(true_ids).long().cpu()
    kth = (-(U[:, None, :] * I[true_ids]).sum(-1)).max(dim=1).values
    d = -(U[:, None, :] * I[ids.clamp(min=0)]).sum(-1)
    hits = ((d <= kth[:, None]) & (ids >= 0)).sum(1).clamp(max=true_ids.shape[1])
    return float(hits.sum()) / true_ids.numel()


def phase21() -> dict:
    """The tuner at bench_autotune's full workload; its spec at the serve defaults."""
    from repro_torch.core.autotune import autotune
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.spec import Blend, RetrievalSpec, load_spec
    from repro_torch.data.synthetic import lda_like_histograms, split_queries
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_and_serve

    rng = np.random.default_rng(0)
    Q, X = split_queries(lda_like_histograms(rng, TUNE_N + TUNE_Q, TUNE_DIM, device="cuda"),
                         TUNE_Q, rng)
    Q_cal, Q_hold = Q[:TUNE_Q // 2], Q[TUNE_Q // 2:]
    base = RetrievalSpec(**TUNE_BASE)
    hand = base.replace(build_policy=Blend(HAND_ALPHA), ef_search=HAND_EF)
    with PlainCalls(ops) as plain:
        res, tune_s, tune_launches = launched_by(ops, lambda: autotune(
            X, Q_cal, base=base, axes=tune_axes(), anchors=[hand], k=10, rungs=3, seed=0,
            verbose=False))
        hand_c = res.lookup(hand)
        choice = res.pick(max_evals=hand_c.objectives["evals_per_query"])
        _, true_hold = knn_scan(base.base_distance(), Q_hold, X, 10)
        holdout = {name: held_out(spec, X, Q_hold, true_hold, 2)
                   for name, spec in (("hand", hand), ("tuned", choice.spec))}
        with tempfile.TemporaryDirectory() as tmp:
            path = str(pathlib.Path(tmp) / "TUNED_spec.json")
            res.save(path, choice)
            loaded = load_spec(path)
        served, serve_s, serve_launches = launched_by(ops, lambda: build_and_serve(
            spec=choice.spec, n_db=20_000, dim=32, n_queries=256, batch=64, device="cuda",
            verbose=False))
    h, t = hand_c.objectives, choice.objectives
    line = {"tune_s": tune_s, "rungs": [[r["n"], len(r["evaluated"]), len(r["survivors"])]
                                        for r in res.history],
            "hand_cal": h, "tuned_cal": t, "tuned_spec": choice.spec.to_dict(),
            "tuned_spec_fingerprint": choice.fingerprint,
            "jax_tuned_spec_fingerprint": JAX_TUNED["spec_fingerprint"],
            "same_spec_as_jax": choice.fingerprint == JAX_TUNED["spec_fingerprint"],
            "holdout": holdout, "jax_holdout_recall@k": JAX_TUNED["holdout_recall@k"],
            "floor": round(JAX_TUNED["holdout_recall@k"] - 0.02, 4),
            "tune_launches": tune_launches,
            "deploy": {k: served[k] for k in ("recall@k", "qps", "build_s", "p50_batch_ms",
                                              "eval_reduction")},
            "deploy_s": serve_s, "deploy_launches": serve_launches,
            "plain_calls_on_cuda": plain.n}
    log("tuner at bench_autotune's full workload (KL n=4096 d=32, 64 + 64 queries), then the "
        "tuned spec at the serve defaults: " + json.dumps(line))
    if plain.n:
        raise AssertionError(f"phase 21: {plain.n} plain-version calls on CUDA tensors")
    if not (t["recall"] >= h["recall"] and t["evals_per_query"] <= h["evals_per_query"]):
        raise AssertionError(f"phase 21: the tuned spec {t} loses to the hand spec {h}")
    if holdout["tuned"]["recall@10"] < line["floor"]:
        raise AssertionError(f"phase 21: tuned holdout recall@10 {holdout['tuned']['recall@10']}"
                             f" < {line['floor']} (JAX {JAX_TUNED['holdout_recall@k']} less 0.02)")
    if loaded != choice.spec:
        raise AssertionError("phase 21: the TUNED artifact does not load back as the tuned spec")
    for label, counts in (("tuning", tune_launches), ("deploy", serve_launches)):
        if not (counts["gather_scores"] > 0 and counts["distance_matrix"] > 0):
            raise AssertionError(f"phase 21: kernel not launched in the {label}: {counts}")
    return line


def phase22(X_full) -> dict:
    """Learned distances: bench_learned's workload B, then the metric learner's
    ground truth and fit over phase 9's data."""
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.distances import get_distance
    from repro_torch.core.learned import fit_construction_distance
    from repro_torch.core.metric_learning import fit_mahalanobis_map, true_neighbor_ids
    from repro_torch.core.spec import Blend, RetrievalSpec
    from repro_torch.data.synthetic import text_collection
    from repro_torch.kernels import ops

    tc = text_collection(np.random.default_rng(5), BM25_DOCS + BM25_Q, vocab=BM25_VOCAB,
                         device="cuda")
    X, Q = tc.counts[:BM25_DOCS], tc.counts[BM25_DOCS:]
    Q_cal, Q_hold = Q[:BM25_Q // 2], Q[BM25_Q // 2:]
    dist, kl = tc.bm25(), get_distance("kl")
    base = RetrievalSpec(**dict(TUNE_BASE, distance="bm25"), ef_search=HAND_EF)
    with PlainCalls(ops) as plain:
        res, fit_s, fit_launches = launched_by(ops, lambda: fit_construction_distance(
            X, Q_cal, base=base, dist=dist, natural=tc.natural, hand_policy=Blend(HAND_ALPHA),
            rank=16, steps=150, n_anchors=256, seed=1, verbose=False))
        _, true_hold = knn_scan(dist, Q_hold, X, 10)
        holdout = {name: held_out(spec, X, Q_hold, true_hold, 17, dist, tc.natural)
                   for name, spec in (("hand", base.replace(build_policy=Blend(HAND_ALPHA))),
                                      ("learned", res.spec))}
        _, true_cal = knn_scan(dist, Q_cal, X, 10)
        natural = held_out(base.replace(build_policy="natural"), X, Q_cal, true_cal, 17, dist,
                           tc.natural)
        # the metric learner over phase 9's data: 512 anchors' true neighbours, then the fit
        anchors = torch.randperm(N_FULL, device="cuda",
                                 generator=torch.Generator(device="cuda").manual_seed(3))[:512]
        pos, tni_s, tni_launches = launched_by(
            ops, lambda: true_neighbor_ids(kl, X_full, anchors, 10))
        _, raw = knn_scan(kl, X_full[anchors], X_full, 11)
        L, map_s, map_launches = launched_by(ops, lambda: fit_mahalanobis_map(
            X_full, kl, torch.Generator(device="cuda").manual_seed(4)))
    pos, raw, anc = pos.cpu().numpy(), raw.cpu().numpy(), anchors.cpu().numpy()
    want = np.stack([r[r != a][:10] for r, a in zip(raw, anc)])
    line = {"fit_s": fit_s, "anchor_cal": res.anchor, "learned_cal": res.objectives,
            "build_policy": str(res.spec.build_policy), "candidates": list(res.candidates),
            "calibration": res.calibration, "holdout": holdout, "natural_cal": natural,
            "jax_holdout_recall@k": JAX_LEARNED["holdout_recall@k"],
            "floor": round(JAX_LEARNED["holdout_recall@k"] - 0.02, 4),
            "jax_weights_fingerprint": JAX_LEARNED["weights_fingerprint"],
            "fit_launches": fit_launches,
            "true_neighbor_ids_s": tni_s, "true_neighbor_ids_launches": tni_launches,
            "self_in_positives": int(sum(a in p for p, a in zip(pos, anc))),
            "ids_equal_knn_scan_without_self": bool(np.array_equal(pos, want)),
            "fit_mahalanobis_map_s": map_s, "fit_mahalanobis_map_launches": map_launches,
            "L_shape": list(L.shape), "L_finite": bool(torch.isfinite(L).all()),
            "plain_calls_on_cuda": plain.n}
    log("learned distances, BM25 2048 docs vocab 1024 (32 + 32 queries), then 512 anchors at "
        "n=1e6 d=128: " + json.dumps(line))
    if plain.n:
        raise AssertionError(f"phase 22: {plain.n} plain-version calls on CUDA tensors")
    a, o = res.anchor, res.objectives
    if not (o["recall"] >= a["recall"] and o["evals_per_query"] <= a["evals_per_query"]):
        raise AssertionError(f"phase 22: learned {o} loses to the hand anchor {a}")
    if holdout["learned"]["recall@10"] < line["floor"]:
        raise AssertionError(f"phase 22: learned holdout recall@10 "
                             f"{holdout['learned']['recall@10']} < {line['floor']}")
    if line["self_in_positives"] or not line["ids_equal_knn_scan_without_self"]:
        raise AssertionError("phase 22: true_neighbor_ids kept an anchor or differs from knn_scan")
    if not line["L_finite"]:
        raise AssertionError("phase 22: the fitted map is not finite")
    for label, counts, kernel in (("fit", fit_launches, "gather_scores"),
                                  ("fit", fit_launches, "distance_matrix"),
                                  ("true_neighbor_ids", tni_launches, "distance_matrix"),
                                  ("fit_mahalanobis_map", map_launches, "distance_matrix")):
        if not counts[kernel] > 0:
            raise AssertionError(f"phase 22: {kernel} not launched in the {label}: {counts}")
    return line


def phase23() -> dict:
    """The two-tower path at recsys_ann.py's shape (see the module docstring)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.distances import get_distance
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.learned import fit_construction_distance
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.core.spec import RetrievalSpec
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_recsys
    from repro_torch.models.recsys import tower_embeddings

    cfg = get_smoke_config("two-tower-retrieval")
    dist = get_distance("negdot")
    spec = RetrievalSpec(distance="negdot", builder="swgraph", build_engine="wave", wave=64,
                         NN=16, ef_construction=100, k=TT_K, ef_search=128)
    with PlainCalls(ops) as plain:
        (model, history), train_s, train_launches = launched_by(ops, lambda: train_recsys(
            cfg, steps=60, batch=256, log_every=20, device="cuda"))
        corpus = recsys_batch(np.random.default_rng(7), TT_N, cfg.vocab_sizes, device="cuda")
        queries = recsys_batch(np.random.default_rng(8), TT_Q, cfg.vocab_sizes, device="cuda")
        with torch.no_grad():
            items = tower_embeddings(model, corpus, cfg)[1].contiguous()
            users = tower_embeddings(model, queries, cfg)[0].contiguous()
        (_, true_ids), truth_s, truth_launches = launched_by(
            ops, lambda: knn_scan(dist, users, items, TT_K))
        idx, build_s, build_launches = launched_by(ops, lambda: ANNIndex.build(
            items, dist, spec=spec, generator=torch.Generator(device="cuda").manual_seed(9)))
        search = idx.searcher()
        search(users)
        (_, ids, n_evals, _), search_s, search_launches = launched_by(ops, lambda: search(users))
        res, fit_s, fit_launches = launched_by(ops, lambda: fit_construction_distance(
            items[:TT_FIT], users[:TT_Q // 2], base=spec.replace(frontier=1), dist=dist, rank=16,
            steps=60, n_anchors=128, alphas=(0.75, 1.0), betas=(0.5,), verbose=False))
        idx_l, build_l_s, build_l_launches = launched_by(ops, lambda: ANNIndex.build(
            items, dist, spec=res.spec, generator=torch.Generator(device="cuda").manual_seed(10)))
        _, ids_l, n_evals_l, _ = idx_l.searcher(spec=res.spec)(users)
        out, sched_s, sched_launches = launched_by(ops, lambda: idx_l.scheduler(
            spec=res.spec, frontier=res.spec.frontier).run_stream(users))
    got = np.stack([r.ids for r in sorted(out, key=lambda r: r.rid)])
    line = {"train_s": train_s, "loss": history, "train_launches": train_launches,
            "items_shape": list(items.shape), "users_shape": list(users.shape),
            "finite": bool(torch.isfinite(items).all() and torch.isfinite(users).all()),
            "truth_s": truth_s, "truth_launches": truth_launches,
            "plain": {"recall@k": recall_at_k(ids, true_ids),
                      "tie_aware_recall@k": tie_aware_recall(users, items, ids, true_ids),
                      "build_s": build_s,
                      "search_ms": 1e3 * search_s,
                      "eval_reduction": TT_N / float(n_evals.float().mean()),
                      "build_launches": build_launches, "search_launches": search_launches},
            "fit_s": fit_s, "fit_launches": fit_launches, "anchor_cal": res.anchor,
            "learned_cal": res.objectives, "build_policy": str(res.spec.build_policy),
            "learned": {"recall@k": recall_at_k(ids_l, true_ids),
                        "tie_aware_recall@k": tie_aware_recall(users, items, ids_l, true_ids),
                        "build_s": build_l_s,
                        "evals_per_query": float(n_evals_l.float().mean()),
                        "build_launches": build_l_launches},
            "scheduler": {"served": len(out), "recall@k": recall_at_k(got, true_ids),
                          "tie_aware_recall@k": tie_aware_recall(users, items, got, true_ids),
                          "ids_equal_searcher": bool(np.array_equal(got, ids_l.cpu().numpy())),
                          "s": sched_s, "launches": sched_launches},
            "plain_calls_on_cuda": plain.n}
    log("two-tower path: SMOKE trained 60 steps x 256, 20,000 item embeddings, 64 queries, "
        "K=20: " + json.dumps(line))
    if plain.n:
        raise AssertionError(f"phase 23: {plain.n} plain-version calls on CUDA tensors")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"phase 23: the training loss did not fall: {history}")
    if not line["finite"] or line["items_shape"] != [TT_N, cfg.tower_mlp_dims[-1]]:
        raise AssertionError(f"phase 23: embeddings {line['items_shape']}, finite "
                             f"{line['finite']}")
    # recsys_ann.py's own check (> 0.7), on the tie-aware recall: the id-based one
    # counts an equally distant duplicate item row as a miss (PERF.md section 7);
    # the id-based recall is held to the JAX example's less 0.02
    for label in ("plain", "learned"):
        if not line[label]["tie_aware_recall@k"] > 0.7:
            raise AssertionError(f"phase 23: {label} index tie-aware recall@{TT_K} "
                                 f"{line[label]['tie_aware_recall@k']} <= 0.7")
        if line[label]["recall@k"] < JAX_TWO_TOWER_RECALL[label] - 0.02:
            raise AssertionError(f"phase 23: {label} index recall@{TT_K} "
                                 f"{line[label]['recall@k']} < the JAX example's "
                                 f"{JAX_TWO_TOWER_RECALL[label]} less 0.02")
    if not line["scheduler"]["ids_equal_searcher"]:
        raise AssertionError("phase 23: the scheduler's ids differ from the searcher's")
    for label, counts, kernel in (("ground truth", truth_launches, "distance_matrix"),
                                  ("plain build", build_launches, "gather_scores"),
                                  ("search", search_launches, "gather_scores"),
                                  ("fit", fit_launches, "gather_scores"),
                                  ("fit", fit_launches, "distance_matrix"),
                                  ("learned build", build_l_launches, "gather_scores"),
                                  ("scheduler", sched_launches, "gather_scores")):
        if not counts[kernel] > 0:
            raise AssertionError(f"phase 23: {kernel} not launched in the {label}: {counts}")
    return line


def lm_attention_times() -> list:
    """``blockwise_attention`` forward and backward beside SDPA (the library
    yardstick, never on the path) at phase 24's two shapes, bf16 on the card."""
    import torch.nn.functional as F

    from repro_torch.models.layers import blockwise_attention

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(24)
    for B, T, Hq, Hkv, dh, block, reps in ATTN_SHAPES:
        q = torch.randn((B, T, Hq, dh), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, T, Hkv, dh), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = blockwise_attention(q, k, v, block_q=block, block_kv=block)
        dout = torch.randn(out.shape, generator=gen, device="cuda").bfloat16()

        def fwd():
            return blockwise_attention(q, k, v, block_q=block, block_kv=block)

        def bwd():
            return torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)

        # SDPA's layout (B, H, T, dh); its GQA groups q head h with kv head h // g (the
        # port groups h % Hkv): the same work, timed only
        qs, ks, vs = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

        sout = sdpa()
        sdout = dout.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(sout, (qs, ks, vs), sdout, retain_graph=True)

        # CUDA events around back-to-back calls (host gaps included), and the
        # kernels' own device time from the profiler
        times = {f"{name}{kind}": timer(fn, [()], reps)
                 for name, fn in (("fwd", fwd), ("bwd", bwd), ("sdpa_fwd", sdpa),
                                  ("sdpa_bwd", sdpa_bwd))
                 for kind, timer in (("_ms", time_ms), ("_device_ms", device_ms))}
        # causal work: 2 B H T^2 dh multiply-adds forward (QK^T and PV over half the
        # tiles), 2.5x that backward; bytes: q, k, v, out (and their gradients) once
        flops = 2.0 * B * Hq * T * T * dh
        io = 2 * (B * T * (Hq + 2 * Hkv) * dh + B * T * Hq * dh)
        bound_f = 1e3 * max(flops / H100_BF16_FLOPS, io / H100_BYTES_PER_S)
        bound_b = 1e3 * max(2.5 * flops / H100_BF16_FLOPS, 2 * io / H100_BYTES_PER_S)
        rows.append({"shape": f"B={B} T={T} H={Hq}/{Hkv} dh={dh} block={block} bf16",
                     **times, "bound_fwd_ms": bound_f, "bound_bwd_ms": bound_b,
                     "bound_by": "operations at the bf16 peak" if flops / H100_BF16_FLOPS
                     > io / H100_BYTES_PER_S else "bytes"})
        del q, k, v, out, dout, qs, ks, vs, sout, sdout
    return rows


def greedy_decode_against_forward(model, cfg, prompt, n_steps: int, block: int) -> dict:
    """Prefill ``prompt``, ``n_steps`` greedy decode steps; every step's logits
    against ``forward`` over the same prefix (one causal forward over the
    prompt and the decoded tokens: its position t is the prefix up to t)."""
    from repro_torch.models import transformer as tt

    T = prompt.shape[1]
    logits, cache = tt.prefill(model, prompt, cfg, max_len=T + n_steps, block_q=block,
                               block_kv=block)
    steps, toks = [logits], [prompt]
    for _ in range(n_steps):
        nxt = steps[-1].argmax(dim=-1)
        toks.append(nxt[:, None])
        logits, cache = tt.decode_step(model, cache, nxt, cfg)
        steps.append(logits)
    seq = torch.cat(toks, dim=1)
    with torch.no_grad():
        full, _ = tt.forward(model, seq, cfg, block_q=block, block_kv=block)
    want = full[:, T - 1:]
    got = torch.stack(steps, dim=1)
    err = (got - want).abs()
    scale = want.abs().amax(dim=-1, keepdim=True).clamp(min=1.0)  # per step and row
    top2 = want.topk(2, dim=-1).values
    return {"steps": n_steps, "prompt": list(prompt.shape),
            "max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / scale).max()),
            "max_abs_logit": float(want.abs().max()),
            "close": bool((err <= DECODE_TOL * scale).all()),
            "argmax_equal": bool(torch.equal(got.argmax(-1), want.argmax(-1))),
            "min_top2_gap": float((top2[..., 0] - top2[..., 1]).min()),
            "finite": bool(torch.isfinite(got).all())}


def serve_times(model, cfg, batch: int, prompt_len: int, n_tokens: int, gen) -> dict:
    """prefill ms and decode ms per token (CUDA events; one warm-up of each)."""
    from repro_torch.models import transformer as tt

    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device="cuda")
    max_len = prompt_len + n_tokens
    logits, cache = tt.prefill(model, prompt, cfg, max_len=max_len)
    tt.decode_step(model, cache, logits.argmax(-1), cfg)
    t0, t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    t0.record()
    logits, cache = tt.prefill(model, prompt, cfg, max_len=max_len)
    t1.record()
    for _ in range(n_tokens):
        logits, cache = tt.decode_step(model, cache, logits.argmax(-1), cfg)
    t2.record()
    torch.cuda.synchronize()
    decode_ms = t1.elapsed_time(t2) / n_tokens
    line = {"batch": batch, "prompt": prompt_len, "tokens": n_tokens,
            "prefill_ms": t0.elapsed_time(t1), "decode_ms_per_token": decode_ms,
            "decode_tok_s": batch * 1e3 / decode_ms,
            "finite": bool(torch.isfinite(logits).all()),
            "length": int(cache["length"][0])}
    # one more decode step under the profiler (into the cache's last free slot)
    cache["length"] -= 1
    line["decode_profile"] = kernel_breakdown(
        *_profiled(lambda: tt.decode_step(model, cache, logits.argmax(-1), cfg)))
    return line


def kernel_breakdown(wall_ms, rows, top: int = 12) -> dict:
    """A profiled window's busy and idle share, device ms by kind of kernel
    and its ``top`` kernels."""
    busy = sum(r[0] for r in rows)
    kinds = {}
    for ms, _, name in rows:
        low = name.lower()
        kind = ("gemm" if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90", "nvjet"))
                else "reduce" if "reduce" in low else
                "index/scatter" if any(k in low for k in ("index", "scatter", "gather")) else
                "elementwise" if "elementwise" in low else "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return {"profiled_wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "kernels": sum(r[1] for r in rows), "by_kind_ms": kinds,
            "top": [[round(ms, 3), n, name[:90]] for ms, n, name in rows[:top]]}


def profile_train_step(cfg) -> dict:
    """One train step of ``cfg`` as ``train_lm`` builds it for LLAMA_STEPS
    steps, after three timed steps: device time by kernel (top 15) and by kind,
    the busy share."""
    from repro_torch.launch.train import lm_batch_fn, lm_trainer

    model, opt_state, step_fn = lm_trainer(cfg, LLAMA_STEPS, 64, torch.device("cuda"))
    state = [opt_state]
    batch = {k: v.cuda() for k, v in lm_batch_fn(cfg, 8, 128)(0).items()}

    def one():
        _, state[0], _ = step_fn(model, state[0], batch)

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    line = {"first_steps_ms": walls, **kernel_breakdown(*_profiled(one), top=15)}
    del model, state
    torch.cuda.empty_cache()
    return line


def train_line(history, tokens: int, n_active: int, peak_gb: float, before_gb: float) -> dict:
    """ms per step between the first and the last logged step, tok/s and the
    model-FLOPs share (6 N_active tokens over the step time at the bf16 peak)."""
    first, last = history[0], history[-1]
    ms_step = 1e3 * (last["s"] - first["s"]) / (last["step"] - first["step"])
    return {"history": history, "ms_per_step": ms_step, "first_step_s": first["s"],
            "tok_s": tokens * 1e3 / ms_step, "peak_gb": peak_gb,
            "allocated_before_gb": before_gb,
            "model_flops_share": 6 * n_active * tokens / (ms_step / 1e3 * H100_BF16_FLOPS)}


def phase24() -> dict:
    """llama3.2-1b at full width (see the module docstring)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import transformer as tt

    cfg = get_config("llama3.2-1b")
    line = {"config": dataclasses.asdict(cfg), "n_params": cfg.n_params()}

    # 1. train at repro's launcher defaults, steps cut to LLAMA_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    history = train_main(["--arch", "llama3.2-1b", "--steps", str(LLAMA_STEPS)])
    train_s = time.perf_counter() - t0
    line["train"] = {"steps": LLAMA_STEPS, "batch": 8, "seq": 128, "block": 64, "s": train_s,
                     **train_line(history, 8 * 128, cfg.n_params(),
                                  (torch.cuda.max_memory_allocated() - before) / 1e9,
                                  before / 1e9)}
    log("llama3.2-1b train: " + json.dumps(line["train"]))
    losses = [h["loss"] for h in history]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 24: the loss is not finite and falling: {losses}")

    line["train_profile"] = profile_train_step(cfg)
    log("llama3.2-1b train step profile: " + json.dumps(line["train_profile"]))

    # 2. decode equals forward at full width, float32, TF32 off
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = tt.init_params(cfg32, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT), generator=gen, device="cuda")
    line["decode_vs_forward"] = greedy_decode_against_forward(model, cfg32, prompt, LM_DECODE,
                                                              64)
    log("llama3.2-1b decode vs forward, f32: " + json.dumps(line["decode_vs_forward"]))
    check_decode("phase 24", line["decode_vs_forward"])
    del model
    torch.cuda.empty_cache()

    # 3. serving times in bf16
    model = tt.init_params(cfg, gen, "cuda")
    line["serve"] = serve_times(model, cfg, 8, 512, 32, gen)
    log("llama3.2-1b serve, bf16: " + json.dumps(line["serve"]))
    if not line["serve"]["finite"] or line["serve"]["length"] != 512 + 32:
        raise AssertionError(f"phase 24: serving {line['serve']}")
    del model
    torch.cuda.empty_cache()

    # 4. attention alone beside SDPA
    line["attention"] = lm_attention_times()
    log("blockwise_attention vs SDPA: " + json.dumps(line["attention"]))

    # 5. the SMOKE forward on the card equals the CPU's
    smoke = get_smoke_config("llama3.2-1b")
    cpu_model = tt.init_params(smoke, torch.Generator().manual_seed(1), device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    toks = torch.randint(0, smoke.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want, _ = tt.forward(cpu_model, toks, smoke, block_q=8, block_kv=8)
        got, _ = tt.forward(card_model, toks.cuda(), smoke, block_q=8, block_kv=8)
    line["cpu_agreement_max_abs_err"] = float((got.cpu() - want).abs().max())
    log(f"SMOKE forward, card against CPU: max abs err {line['cpu_agreement_max_abs_err']}")
    if not torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"phase 24: the card's SMOKE forward differs from the CPU's by "
                             f"{line['cpu_agreement_max_abs_err']}")
    return line


def check_decode(label: str, res: dict) -> None:
    if not (res["finite"] and res["close"] and res["argmax_equal"]):
        raise AssertionError(f"{label}: decode differs from forward beyond {DECODE_TOL} of "
                             f"the largest logit, or in its argmax: {res}")


class SimulatedCrash(Exception):
    """The failure phase 25 injects into a training run."""


@contextlib.contextmanager
def batches_die_at(step: int):
    """``launch.train``'s batch source raises SimulatedCrash at ``step``: the
    run dies there, after the steps before it and their checkpoints."""
    from repro_torch.launch import train

    batches = train.lm_batch_fn

    def dying(*args, **kwargs):
        make = batches(*args, **kwargs)

        def made(s):
            if s == step:
                raise SimulatedCrash(f"killed before step {step}")
            return make(s)

        return made

    train.lm_batch_fn = dying
    try:
        yield
    finally:
        train.lm_batch_fn = batches


@contextlib.contextmanager
def decode_window_off_by_one():
    """A planted fault: ``decode_step``'s local layers attend one key more
    than their window (``pos >= total - w - 1``); forward is left as it is."""
    from repro_torch.models import transformer as tt

    attend = tt.decode_attention_local

    def wider(q, k, v, total, *, window=0, **kw):
        return attend(q, k, v, total, window=window + 1 if window > 0 else 0, **kw)

    tt.decode_attention_local = wider
    try:
        yield
    finally:
        tt.decode_attention_local = attend


def phase25() -> dict:
    """Crash-resume at llama-110m and gemma3-12b at full width (module docstring)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LMConfig
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as tt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import adamw, warmup_cosine

    cfg110 = LMConfig(**CFG_110M_FIELDS)
    line = {}
    # 1. crash-resume: killed after step KILL_AT (its checkpoint) and resumed to the end,
    # beside an uninterrupted run; same schedule, data and seed
    kw = dict(steps=RESUME_STEPS, batch=4, seq=256, block=64, device="cuda", ckpt_every=50)
    t0 = time.perf_counter()
    full_model, full = train_lm(cfg110, **kw)
    full_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        try:
            with batches_die_at(KILL_AT + 1):
                train_lm(cfg110, ckpt_dir=d, **kw)
            raise AssertionError("phase 25: the run to be killed was not")
        except SimulatedCrash:
            pass
        killed_s = time.perf_counter() - t0
        resumed_from = ckpt.latest_step(d)
        t0 = time.perf_counter()
        model, resumed = train_lm(cfg110, ckpt_dir=d, **kw)
        resumed_s = time.perf_counter() - t0
        # save and restore of this size alone: params and an AdamW state
        params = dict(model.named_parameters())
        tree = {"params": params, "opt": adamw(warmup_cosine(1e-3, 1, 2)).init(params)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(os.path.join(d, "timed"), 0, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.restore(os.path.join(d, "timed"), tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in (list(params.values())
                     + list(tree["opt"]["mu"].values()) + list(tree["opt"]["nu"].values())))
    by_step = {h["step"]: h["loss"] for h in full}
    pairs = [(h["step"], h["loss"], by_step[h["step"]]) for h in resumed]
    rel = max(abs(a - b) / abs(b) for _, a, b in pairs)
    want = dict(full_model.named_parameters())
    params_equal = all(torch.equal(p, want[n]) for n, p in params.items())
    param_err = max(float((p - want[n]).abs().max()) for n, p in params.items())
    line["resume"] = {"config": dataclasses.asdict(cfg110), "n_params": cfg110.n_params(),
                      "steps": RESUME_STEPS, "killed_after": KILL_AT,
                      "resumed_from": resumed_from,
                      "losses_resumed_vs_uninterrupted": pairs, "max_rel_diff": rel,
                      "bit_exact": all(a == b for _, a, b in pairs),
                      "params_bit_exact": params_equal, "params_max_abs_diff": param_err,
                      "uninterrupted_s": full_s, "killed_run_s": killed_s,
                      "resumed_run_s": resumed_s, "save_s": save_s, "restore_s": restore_s,
                      "checkpoint_gb": nbytes / 1e9,
                      "first_loss": full[0]["loss"], "last_loss": full[-1]["loss"]}
    log("llama-110m crash-resume: " + json.dumps(line["resume"]))
    if resumed_from != KILL_AT or resumed[0]["step"] <= KILL_AT:
        raise AssertionError(f"phase 25: resumed from {resumed_from}, first logged "
                             f"{resumed[0]}")
    bit_exact = line["resume"]["bit_exact"] and params_equal
    if not bit_exact or not full[-1]["loss"] < full[0]["loss"]:
        raise AssertionError(f"phase 25: the resumed run's losses (rel {rel}) or parameters "
                             f"(max abs {param_err}) differ from the uninterrupted run's, or "
                             f"the loss did not fall")
    del model, full_model, params, want, tree
    torch.cuda.empty_cache()

    # 2. gemma3-12b at full width: one 5:1 period in f32, the window bites past 1,024
    gen = torch.Generator(device="cuda").manual_seed(25)
    cfg6 = dataclasses.replace(get_config("gemma3-12b"), n_layers=GEMMA_CUT_LAYERS,
                               dtype="float32")
    model = tt.init_params(cfg6, gen, "cuda")
    prompt = torch.randint(0, cfg6.vocab_size, (1, GEMMA_PROMPT), generator=gen, device="cuda")
    line["gemma_window"] = greedy_decode_against_forward(model, cfg6, prompt, LM_DECODE, 512)
    line["gemma_window"]["n_params"] = cfg6.n_params()
    log(f"gemma3-12b at {GEMMA_CUT_LAYERS} layers, f32, prompt {GEMMA_PROMPT}: "
        + json.dumps(line["gemma_window"]))
    check_decode("phase 25", line["gemma_window"])
    # the same with the decode window planted one key wide: the check must fail it
    with decode_window_off_by_one():
        planted = greedy_decode_against_forward(model, cfg6, prompt, LM_DECODE, 512)
    line["gemma_window_planted_off_by_one"] = planted
    log("gemma3-12b, decode window planted one key wide: " + json.dumps(planted))
    if planted["close"]:
        raise AssertionError(f"phase 25: a decode window off by one passes DECODE_TOL "
                             f"{DECODE_TOL}: {planted}")
    del model
    torch.cuda.empty_cache()

    # then the full 48 layers in bf16: prefill 2,048 and 16 decode steps
    cfg = get_config("gemma3-12b")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = tt.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    line["gemma_full"] = serve_times(model, cfg, 1, 2048, LM_DECODE, gen)
    line["gemma_full"].update(n_params=cfg.n_params(), init_s=init_s,
                              peak_gb=(torch.cuda.max_memory_allocated() - before) / 1e9,
                              allocated_before_gb=before / 1e9)
    log("gemma3-12b full, bf16: " + json.dumps(line["gemma_full"]))
    if not line["gemma_full"]["finite"]:
        raise AssertionError(f"phase 25: gemma3-12b {line['gemma_full']}")
    del model
    torch.cuda.empty_cache()
    return line


@contextlib.contextmanager
def routing_drops():
    """Each MoE layer's share of assignments past its capacity (``dest`` = E*C
    in ``_routing_plan``), one device scalar per call, read after the run."""
    from repro_torch.models import moe

    plan_fn = moe._routing_plan
    shares = []

    def recording(idx, E, C):
        plan = plan_fn(idx, E, C)
        shares.append((plan["dest"] == E * C).float().mean())
        return plan

    moe._routing_plan = recording
    try:
        yield shares
    finally:
        moe._routing_plan = plan_fn


def prefill_drops(model, cfg, batch: int, prompt_len: int, gen) -> dict:
    """One more prefill of ``batch`` x ``prompt_len`` random tokens: the dropped
    share of each layer's assignments and the capacity C per expert."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tt

    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device="cuda")
    with routing_drops() as shares:
        tt.prefill(model, prompt, cfg)
    return {"tokens": batch * prompt_len, "capacity": moe._capacity(batch * prompt_len, cfg),
            "dropped_share_per_layer": [float(x) for x in shares]}


def moe_against_loop(lp, cfg, h, gen) -> dict:
    """``moe_ffn(h)`` held at MOE_CHECK_TOKENS tokens against a plain loop on
    the same weights: softmax over the router, ``torch.topk``, the gates
    renormalised, an assignment kept while its expert has had fewer than C
    earlier ones in token-major order, each kept expert's SwiGLU in the
    model's dtype weighted by its gate, plus the shared expert.  At
    ``repro``'s init a routed expert's output is ~1e-4 of the shared one's,
    so the routed part is also held alone (``n_shared`` set to 0).  Tokens
    with a dropped assignment are checked first, the rest drawn from ``gen``."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.models import moe

    m = cfg.moe
    B, T, d = h.shape
    N, E, K = B * T, m.n_experts, m.top_k
    c = int(N * K * m.capacity_factor / E) + 1
    C = max(8, -(-c // 8) * 8)
    routed_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, n_shared=0))
    with torch.no_grad():
        out = moe.moe_ffn(h, lp, cfg)[0].reshape(N, d)
        out_routed = moe.moe_ffn(h, lp, routed_cfg)[0].reshape(N, d)
        flat = h.reshape(N, d)
        probs = torch.softmax(flat[None].float() @ lp["router"], dim=-1)[0]
        gate, idx = torch.topk(probs, K, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        seen = np.zeros(E, dtype=np.int64)
        kept = np.zeros(N * K, dtype=bool)
        for j, e in enumerate(idx.reshape(-1).tolist()):
            kept[j] = seen[e] < C
            seen[e] += 1
        kept = kept.reshape(N, K)
        dropped = np.nonzero(~kept.all(1))[0]
        rest = np.setdiff1d(np.arange(N), dropped)
        pick = torch.randperm(len(rest), generator=gen, device=gen.device).cpu().numpy()
        n_drop = min(len(dropped), MOE_CHECK_TOKENS // 2)
        tokens = np.concatenate([dropped[:n_drop], rest[pick[:MOE_CHECK_TOKENS - n_drop]]])

        def rel(got, want):
            return float(torch.linalg.norm(got.float() - want) / torch.linalg.norm(want))

        errs, errs_routed = [], []
        for t in tokens.tolist():
            x = flat[t]
            routed = torch.zeros(d, dtype=torch.float32, device=h.device)
            for k in range(K):
                if kept[t, k]:
                    e = int(idx[t, k])
                    y = (F.silu(x @ lp["e_gate"][e]) * (x @ lp["e_up"][e])) @ lp["e_down"][e]
                    routed += gate[t, k] * y.float()
            shared = 0.0
            if m.n_shared:
                shared = ((F.silu(x @ lp["sh_gate"]) * (x @ lp["sh_up"])) @ lp["sh_down"]).float()
            errs.append(rel(out[t], routed + shared))
            errs_routed.append(rel(out_routed[t], routed))
    return {"shape": [B, T], "capacity": C, "tokens": tokens.tolist(),
            "dropped_assignments_in_checked": int((~kept[tokens]).sum()),
            "dropped_share": float((~kept).mean()), "max_rel_err": max(errs),
            "max_rel_err_routed": max(errs_routed)}


def phase26() -> dict:
    """The MoE LMs at full width, cut in depth (module docstring)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.train import lm_batch_fn, train_lm
    from repro_torch.models import transformer as tt
    from repro_torch.train.train_step import lm_loss

    phi = get_config("phi3.5-moe-42b-a6.6b")
    line = {}
    # 1. phi3.5-moe at 1 layer, trained at repro's launcher defaults
    cfg1 = dataclasses.replace(phi, n_layers=PHI_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, history = train_lm(cfg1, steps=MOE_STEPS, batch=8, seq=128, block=64, device="cuda")
    train_s = time.perf_counter() - t0
    line["phi_train"] = {"layers": PHI_TRAIN_LAYERS, "n_params": cfg1.n_params(),
                         "n_active_params": cfg1.n_active_params(), "steps": MOE_STEPS,
                         "batch": 8, "seq": 128, "block": 64, "s": train_s,
                         **train_line(history, 8 * 128, cfg1.n_active_params(),
                                      (torch.cuda.max_memory_allocated() - before) / 1e9,
                                      before / 1e9)}
    log("phi3.5-moe train: " + json.dumps(line["phi_train"]))
    losses = [h["loss"] for h in history]
    if not all(np.isfinite(losses + [h["aux"] for h in history])) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 26: the loss is not finite and falling: {history}")
    del model
    torch.cuda.empty_cache()
    line["phi_train_profile"] = profile_train_step(cfg1)
    log("phi3.5-moe train step profile: " + json.dumps(line["phi_train_profile"]))

    # 2. serving at 16 layers, bf16
    gen = torch.Generator(device="cuda").manual_seed(26)
    cfg16 = dataclasses.replace(phi, n_layers=PHI_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = tt.init_params(cfg16, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    line["phi_serve"] = serve_times(model, cfg16, 8, 512, 32, gen)
    line["phi_serve"].update(layers=PHI_SERVE_LAYERS, n_params=cfg16.n_params(), init_s=init_s,
                             prefill=prefill_drops(model, cfg16, 8, 512, gen),
                             peak_gb=(torch.cuda.max_memory_allocated() - before) / 1e9)
    log("phi3.5-moe serve, bf16: " + json.dumps(line["phi_serve"]))
    if not line["phi_serve"]["finite"] or line["phi_serve"]["length"] != 512 + 32:
        raise AssertionError(f"phase 26: phi3.5-moe serving {line['phi_serve']}")
    del model
    torch.cuda.empty_cache()

    # 3. decode = forward at 4 layers in f32, on a dropless copy (C = N + 1): forward
    # over T tokens drops past the capacity, a decode step's B tokens never reach it
    cfg4 = dataclasses.replace(phi, n_layers=PHI_DECODE_LAYERS, dtype="float32",
                               moe=dataclasses.replace(phi.moe, capacity_factor=phi.moe.n_experts
                                                       / phi.moe.top_k))
    model = tt.init_params(cfg4, gen, "cuda")
    prompt = torch.randint(0, phi.vocab_size, (2, LM_PROMPT), generator=gen, device="cuda")
    with routing_drops() as shares:
        line["phi_decode_vs_forward"] = greedy_decode_against_forward(model, cfg4, prompt,
                                                                      LM_DECODE, 64)
    line["phi_decode_vs_forward"].update(layers=PHI_DECODE_LAYERS, n_params=cfg4.n_params(),
                                         max_dropped_share=max(float(x) for x in shares))
    log("phi3.5-moe decode vs forward, f32, dropless: "
        + json.dumps(line["phi_decode_vs_forward"]))
    check_decode("phase 26", line["phi_decode_vs_forward"])
    if line["phi_decode_vs_forward"]["max_dropped_share"] != 0.0:
        raise AssertionError("phase 26: the dropless copy dropped assignments")
    del model
    torch.cuda.empty_cache()

    # 4. kimi-k2 at 1 layer, bf16, its shared expert on: forward and lm_loss at
    # 1 x KIMI_SEQ, then prefill and decode at batch 8
    cfg_k = dataclasses.replace(get_config("kimi-k2-1t-a32b"), n_layers=KIMI_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = tt.init_params(cfg_k, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: v.cuda() for k, v in lm_batch_fn(cfg_k, 1, KIMI_SEQ)(0).items()}
    with torch.no_grad():
        lm_loss(model, batch, cfg_k)  # warm-up
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        with routing_drops() as shares:
            loss, aux = lm_loss(model, batch, cfg_k)
        t1.record()
        torch.cuda.synchronize()
    line["kimi"] = {"layers": KIMI_LAYERS, "n_params": cfg_k.n_params(),
                    "n_active_params": cfg_k.n_active_params(), "init_s": init_s,
                    "loss_tokens": KIMI_SEQ, "forward_loss_ms": t0.elapsed_time(t1),
                    "loss": float(loss), "nll": float(aux["nll"]), "aux": float(aux["aux"]),
                    "forward_dropped_share_per_layer": [float(x) for x in shares]}
    line["kimi"]["serve"] = serve_times(model, cfg_k, 8, 512, LM_DECODE, gen)
    line["kimi"]["serve"]["prefill"] = prefill_drops(model, cfg_k, 8, 512, gen)
    line["kimi"]["peak_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    log("kimi-k2 at 1 layer, bf16: " + json.dumps(line["kimi"]))
    if not (np.isfinite(line["kimi"]["loss"]) and line["kimi"]["serve"]["finite"]):
        raise AssertionError(f"phase 26: kimi-k2 {line['kimi']}")
    lp = tt._layer_views(model, cfg_k)[0][0]
    line["kimi"]["moe_vs_loop"] = [
        moe_against_loop(lp, cfg_k, torch.randn(shape, generator=gen, device="cuda",
                                                dtype=model.embed.dtype), gen)
        for shape in ((1, KIMI_SEQ, cfg_k.d_model), (8, 1, cfg_k.d_model))]
    log("kimi-k2 moe_ffn against the per-token loop: "
        + json.dumps(line["kimi"]["moe_vs_loop"]))
    if not all(max(r["max_rel_err"], r["max_rel_err_routed"]) <= MOE_CHECK_TOL
               for r in line["kimi"]["moe_vs_loop"]):
        raise AssertionError(f"phase 26: kimi-k2's moe_ffn differs from the per-token loop "
                             f"beyond {MOE_CHECK_TOL}: {line['kimi']['moe_vs_loop']}")
    del model, batch
    torch.cuda.empty_cache()

    # 5. the SMOKE MoE forward on the card equals the CPU's
    smoke = get_smoke_config("kimi-k2-1t-a32b")
    cpu_model = tt.init_params(smoke, torch.Generator().manual_seed(1), device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    toks = torch.randint(0, smoke.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want, want_aux = tt.forward(cpu_model, toks, smoke, block_q=8, block_kv=8)
        got, got_aux = tt.forward(card_model, toks.cuda(), smoke, block_q=8, block_kv=8)
    line["cpu_agreement_max_abs_err"] = float((got.cpu() - want).abs().max())
    log(f"SMOKE MoE forward, card against CPU: max abs err {line['cpu_agreement_max_abs_err']}")
    if not (torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5)
            and torch.allclose(got_aux.cpu(), want_aux, rtol=1e-5)):
        raise AssertionError(f"phase 26: the card's SMOKE MoE forward differs from the CPU's "
                             f"by {line['cpu_agreement_max_abs_err']}")
    return line


def reckon_gcn_peak_gb(n: int, e: int, d: int, n_classes: int, d_hidden: int) -> float:
    """The full-batch GCN step's largest live set, reckoned: the graph (f32
    features, int32 edges and labels), the int64 edges with self loops, the
    first layer's f32 scale and (E', d) message block scaled in place, its
    (n, d) aggregate, and the hidden activations and their gradients."""
    e_loops = e + n
    graph = 4 * n * d + 4 * 2 * e + 4 * n
    edges = 8 * 2 * e_loops
    first = 4 * 3 * e_loops + 4 * e_loops * d + 4 * n * d
    hidden = 4 * 4 * n * (d_hidden + n_classes)
    return (graph + edges + first + hidden) / 1e9


def gcn_aggregate_rows(g, cfg, n_rows: int) -> dict:
    """The first layer's aggregate (``gcn_aggregate`` over the edges and the
    self loops) on the card, held at ``n_rows`` sampled receivers against a
    float64 recomputation on the host from the same edge list: each message
    scaled by deg_out(s)^-1/2 deg_in(r)^-1/2, degrees counted over the whole
    list, and summed per receiver."""
    from repro_torch.models import gnn

    if cfg.norm != "sym":
        raise ValueError(f"the recomputation covers the sym norm, not {cfg.norm!r}")
    x = g["features"]
    n = x.shape[0]
    with torch.no_grad():
        s, r = gnn._with_self_loops(g["senders"], g["receivers"], n)
        agg = gnn.gcn_aggregate(x, s, r, n, norm=cfg.norm, aggregator=cfg.aggregator)
        del s, r
    rows = np.sort(np.random.default_rng(27).choice(n, n_rows, replace=False))
    got = agg[torch.from_numpy(rows).cuda()].double().cpu().numpy()
    del agg
    loops = np.arange(n, dtype=np.int64)
    s = np.concatenate([g["senders"].cpu().numpy().astype(np.int64), loops])
    r = np.concatenate([g["receivers"].cpu().numpy().astype(np.int64), loops])
    deg_in = np.maximum(np.bincount(r, minlength=n), 1).astype(np.float64)
    deg_out = np.maximum(np.bincount(s, minlength=n), 1).astype(np.float64)
    picked = np.zeros(n, dtype=bool)
    picked[rows] = True
    e = np.nonzero(picked[r])[0]
    msgs = x[torch.from_numpy(s[e]).cuda()].double().cpu().numpy()
    msgs *= (1.0 / np.sqrt(deg_out[s[e]] * deg_in[r[e]]))[:, None]
    want = np.zeros((n_rows, x.shape[1]))
    np.add.at(want, np.searchsorted(rows, r[e]), msgs)
    return {"rows": n_rows, "edges": int(e.shape[0]),
            "max_abs_err": float(np.abs(got - want).max()),
            "max_abs": float(np.abs(want).max()),
            "close": bool(np.allclose(got, want, **SAMPLED_TOL))}


def phase27() -> dict:
    """The GCN at ogb_products' and minibatch_lg's shapes (module docstring)."""
    import copy

    from repro_torch.configs.gcn_cora import with_shape
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import gnn_loss, make_train_step

    line = {}
    # 1. full-batch training on ogb_products' shape
    sh = OGB_PRODUCTS
    cfg = with_shape(sh["d_feat"], sh["n_classes"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = random_graph(np.random.default_rng(27), sh["n_nodes"], sh["n_edges"], sh["d_feat"],
                     n_classes=sh["n_classes"], device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    model = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = adamw(warmup_cosine(GCN_LR, max(GCN_STEPS // 20, 5), GCN_STEPS))
    state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(lambda m, b: gnn_loss(m, b, cfg), opt)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    losses, walls = [], []
    for _ in range(GCN_STEPS):
        t0 = time.perf_counter()
        model, state, metrics = step_fn(model, state, g)
        losses.append(float(metrics["loss"]))
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile = kernel_breakdown(*_profiled(lambda: step_fn(model, state, g)))
    line["ogb_products"] = {
        **sh, "config": {"d_hidden": cfg.d_hidden, "norm": cfg.norm, "n_layers": cfg.n_layers},
        "data_s": data_s, "steps": GCN_STEPS, "losses": losses, "first_step_ms": walls[0],
        "ms_per_step": float(np.mean(walls[1:])), "ms_per_step_min": min(walls[1:]),
        "peak_gb": peak, "allocated_before_gb": before / 1e9,
        "reckoned_peak_gb": reckon_gcn_peak_gb(sh["n_nodes"], sh["n_edges"], sh["d_feat"],
                                               sh["n_classes"], cfg.d_hidden),
        "message_block_gb": 4 * (sh["n_edges"] + sh["n_nodes"]) * sh["d_feat"] / 1e9,
        "step_profile": profile}
    log("GCN full batch, ogb_products: " + json.dumps(line["ogb_products"]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 27: the loss is not finite and falling: {losses}")
    del state
    torch.cuda.empty_cache()
    line["ogb_products"]["aggregate_vs_float64"] = gcn_aggregate_rows(g, cfg, AGG_CHECK_ROWS)
    log("GCN first-layer aggregate against float64: "
        + json.dumps(line["ogb_products"]["aggregate_vs_float64"]))
    if not line["ogb_products"]["aggregate_vs_float64"]["close"]:
        raise AssertionError(f"phase 27: the aggregate differs from the float64 recomputation "
                             f"beyond {SAMPLED_TOL}: {line['ogb_products']}")
    del g, model
    torch.cuda.empty_cache()

    # 2. minibatch_lg: the CSR table, 1,024 seeds sampled at fanouts (15, 10), the
    # sampled forward and its backward; the logits held to the CPU's on the same ids
    sh = MINIBATCH_LG
    cfg = with_shape(sh["d_feat"], sh["n_classes"])
    n = sh["n_nodes"]
    t0 = time.perf_counter()
    g = random_graph(np.random.default_rng(28), n, sh["n_edges"], sh["d_feat"],
                     n_classes=sh["n_classes"], device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    gnn.build_csr(g["senders"][:1000], g["receivers"][:1000], n, CSR_MAX_DEGREE)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = gnn.build_csr(g["senders"], g["receivers"], n, CSR_MAX_DEGREE)
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    deg = torch.bincount(g["receivers"].long(), minlength=n)
    model = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(27)

    def step():
        seeds = torch.randperm(n, generator=gen, device="cuda")[:sh["batch_nodes"]].int()
        sub = gnn.sample_subgraph(gen, table, seeds, sh["fanouts"])
        loss, logits = gnn.sampled_forward(model, g["features"], g["labels"], sub, cfg,
                                           n_seed=sh["batch_nodes"])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return sub, loss, logits, grads

    step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SAMPLED_STEPS):
        sub, loss, logits, grads = step()
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / SAMPLED_STEPS
    cpu_model = copy.deepcopy(model).to("cpu")
    want_loss, want = gnn.sampled_forward(cpu_model, g["features"].cpu(), g["labels"].cpu(),
                                          {k: v.cpu() for k, v in sub.items()}, cfg,
                                          n_seed=sh["batch_nodes"])
    err = float((logits.detach().cpu() - want.detach()).abs().max())
    close = bool(torch.allclose(logits.detach().cpu(), want.detach(), **SAMPLED_TOL))
    line["minibatch_lg"] = {
        **sh, "data_s": data_s, "max_degree": CSR_MAX_DEGREE, "csr_build_s": csr_s,
        "rows_over_max_degree": int((deg > CSR_MAX_DEGREE).sum()),
        "sampled_edges": int(sub["senders"].shape[0]), "steps": SAMPLED_STEPS,
        "ms_per_step": ms_step, "loss": float(loss.detach()),
        "cpu_loss": float(want_loss.detach()),
        "logits_max_abs_err_vs_cpu": err, "close": close,
        "grads_finite": all(bool(torch.isfinite(x).all()) for x in grads)}
    log("GCN sampled, minibatch_lg: " + json.dumps(line["minibatch_lg"]))
    if not (close and line["minibatch_lg"]["grads_finite"]
            and np.isfinite(line["minibatch_lg"]["loss"])):
        raise AssertionError(f"phase 27: the sampled forward on the card differs from the "
                             f"CPU's beyond {SAMPLED_TOL}: {line['minibatch_lg']}")
    del g, table, model
    torch.cuda.empty_cache()
    return line


def recsys_flops(cfg, batch: int) -> float:
    """Forward FLOPs of one recsys batch (``repro.launch.cells._recsys_flops``)."""
    d = cfg.embed_dim
    f = 0.0
    if cfg.interaction == "self-attn":
        F = cfg.n_sparse
        da = cfg.d_attn
        for i in range(cfg.n_attn_layers):
            d_in = d if i == 0 else da
            f += 2.0 * batch * F * d_in * da * 4  # q,k,v,res projections
            f += 2.0 * batch * F * F * da * 2  # scores + weighted sum
        f += 2.0 * batch * (F * da)
    elif cfg.interaction == "target-attn":
        T = cfg.seq_len
        dims = (4 * d,) + tuple(cfg.attn_mlp_dims) + (1,)
        per_tok = sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        f += batch * T * per_tok
        mdims = (2 * d + (cfg.n_sparse - 1) * d + cfg.n_dense,) + tuple(cfg.mlp_dims) + (1,)
        f += batch * sum(2.0 * mdims[i] * mdims[i + 1] for i in range(len(mdims) - 1))
    elif cfg.interaction == "cross":
        x0 = cfg.n_dense + cfg.n_sparse * d
        f += 2.0 * batch * x0 * x0 * cfg.n_cross_layers
        mdims = (x0,) + tuple(cfg.mlp_dims) + (1,)
        f += batch * sum(2.0 * mdims[i] * mdims[i + 1] for i in range(len(mdims) - 1))
    elif cfg.interaction == "dot":
        fu = cfg.n_sparse // 2
        for dims, nf in ((cfg.tower_mlp_dims, fu), (cfg.tower_mlp_dims, cfg.n_sparse - fu)):
            full = (nf * d,) + tuple(dims)
            f += batch * sum(2.0 * full[i] * full[i + 1] for i in range(len(full) - 1))
    # embedding gather bytes dominate; flops negligible but count the reduce
    f += 2.0 * batch * cfg.n_sparse * d
    return f


def recsys_step_bytes(cfg, n_params: int, batch: int) -> float:
    """The train step's bytes (``repro.launch.cells._recsys_cell``'s
    ``analytic_bytes``): 8 x the f32 params and 2 x AdamW's two moments (the
    dense update reads and writes the whole table), the gathered rows three
    times, and 6 x the (batch, fields, d) embeddings."""
    param_b = 4.0 * n_params
    gather_b = 3.0 * batch * (cfg.n_sparse + cfg.seq_len) * cfg.embed_dim * 4
    return (8.0 * param_b + 2.0 * (2.0 * param_b) + gather_b
            + 6.0 * batch * cfg.embed_dim * cfg.n_sparse * 4)


def recsys_batch_of(cfg, rows: int, seed, device="cuda") -> dict:
    from repro_torch.data.synthetic import recsys_batch

    return recsys_batch(np.random.default_rng(seed), rows, cfg.vocab_sizes, device,
                        n_dense=cfg.n_dense, seq_len=cfg.seq_len)


def recsys_serve(model, cfg, shape: str, rows: int) -> dict:
    """``forward`` under no_grad over ``rows`` rows in chunks of RECSYS_CHUNK
    (concatenated), then at retrieval_cand a top-RECSYS_TOPK over all the
    scores: ms per call (CUDA events), rows/s, the peak above the model."""
    from repro_torch.models.recsys import forward

    batch = recsys_batch_of(cfg, rows, (28, rows))
    chunks = [{k: v[i:i + RECSYS_CHUNK] for k, v in batch.items()}
              for i in range(0, rows, RECSYS_CHUNK)]

    def run():
        with torch.no_grad():
            logits = torch.cat([forward(model, c, cfg) for c in chunks])
            return torch.topk(logits, RECSYS_TOPK) if shape == "retrieval_cand" else logits

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = time_ms(run, [()], RECSYS_SERVE_REPS[shape])
    out = run()
    torch.cuda.synchronize()
    logits = out.values if shape == "retrieval_cand" else out
    return {"rows": rows, "chunks": len(chunks), "ms": ms, "rows_s": rows * 1e3 / ms,
            "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "finite": bool(torch.isfinite(logits).all()),
            "shape_ok": tuple(logits.shape) == ((RECSYS_TOPK,) if shape == "retrieval_cand"
                                                else (rows,))}


def recsys_against_cpu(model, cfg, arch: str) -> dict:
    """The trained card model against a CPU copy of it: a RECSYS_PARITY_ROWS-row
    forward (TF32 off) within RECSYS_FWD_TOL of the largest |logit|; at DCN-v2
    ``embedding_bag`` over its table; then one train step at RECSYS_STEP_BATCH
    from the same weights, batch and a fresh AdamW state on each side: loss and
    grad_norm within RECSYS_STEP_RTOL relative."""
    import copy

    from repro_torch.launch.train import PEAK_LR, WARMUP
    from repro_torch.models.recsys import forward
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step, recsys_loss

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 28: TF32 is on; the parity needs it off")
    line = {}
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = recsys_batch_of(cfg, RECSYS_PARITY_ROWS, (28, 1), device="cpu")
    with torch.no_grad():
        want = forward(cpu_model, batch, cfg)
        got = forward(model, {k: v.cuda() for k, v in batch.items()}, cfg).cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    line["forward"] = {"rows": RECSYS_PARITY_ROWS, "max_abs_err": err, "max_abs_logit": scale,
                       "rel_to_largest": err / scale, "ok": err <= RECSYS_FWD_TOL * scale}
    if arch == "dcn-v2":
        line["embedding_bag"] = embedding_bag_against_cpu(model.table.detach(),
                                                          cpu_model.table.detach(),
                                                          cfg.table_rows())
    opt = adamw(warmup_cosine(PEAK_LR, WARMUP, RECSYS_STEPS))
    step_fn = make_train_step(lambda m, b: recsys_loss(m, b, cfg), opt)
    metrics = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        b = recsys_batch_of(cfg, RECSYS_STEP_BATCH, (28, 2), device=dev)
        _, _, out = step_fn(m, opt.init(dict(m.named_parameters())), b)
        metrics[dev] = {k: float(out[k]) for k in ("loss", "grad_norm")}
    rel = {k: abs(metrics["cuda"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in ("loss", "grad_norm")}
    line["train_step"] = {"batch": RECSYS_STEP_BATCH, "cuda": metrics["cuda"],
                          "cpu": metrics["cpu"], "rel_err": rel,
                          "ok": max(rel.values()) <= RECSYS_STEP_RTOL}
    line["s"] = time.perf_counter() - t0
    del cpu_model
    return line


def embedding_bag_against_cpu(table, cpu_table, n_rows: int) -> dict:
    """BAG_COUNT ragged bags of 1 to BAG_MAX ids over the table's rows (a
    twentieth of the ids -1), sum, mean and max on the card against the CPU
    within rtol = atol = 1e-5 (``index_add_`` sums with atomics on the card);
    the card's ms per call."""
    from repro_torch.models.embedding import embedding_bag

    rng = np.random.default_rng(28)
    lengths = rng.integers(1, BAG_MAX + 1, BAG_COUNT)
    seg = torch.from_numpy(np.repeat(np.arange(BAG_COUNT), lengths).astype(np.int32))
    ids = rng.integers(0, n_rows, seg.shape[0]).astype(np.int32)
    ids[rng.random(seg.shape[0]) < 0.05] = -1
    ids = torch.from_numpy(ids)
    line = {"bags": BAG_COUNT, "ids": int(ids.shape[0]), "table_rows": int(table.shape[0])}
    seg_c, ids_c = seg.cuda(), ids.cuda()
    for mode in ("sum", "mean", "max"):
        got = embedding_bag(table, ids_c, seg_c, BAG_COUNT, mode=mode)
        want = embedding_bag(cpu_table, ids, seg, BAG_COUNT, mode=mode)
        ms = time_ms(lambda: embedding_bag(table, ids_c, seg_c, BAG_COUNT, mode=mode), [()], 10)
        line[mode] = {"max_abs_err": float((got.cpu() - want).abs().max()), "ms": ms,
                      "ok": bool(torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5))}
    return line


def phase28() -> dict:
    """The recsys ranking models at full width, and the retrieval configs
    (module docstring)."""
    import dataclasses

    from repro_torch.configs import get_config, get_module, get_smoke_config
    from repro_torch.launch.train import PEAK_LR, WARMUP
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import train_recsys
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step, recsys_loss

    line = {}
    for arch in RECSYS_ARCHS:
        cfg = get_config(arch)
        res = {"table_rows": recsys._pad_vocab(cfg), "embed_dim": cfg.embed_dim}
        # 1. the launcher at repro's defaults
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        history = train_main(["--arch", arch])
        res["launcher"] = {"steps": 100, "batch": 8, "s": time.perf_counter() - t0,
                           "losses": [h["loss"] for h in history]}
        if not all(np.isfinite(res["launcher"]["losses"])):
            raise AssertionError(f"phase 28: {arch}'s launcher loss is not finite: {history}")
        torch.cuda.empty_cache()

        # 2. training at the train_batch cell's batch
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        model, history = train_recsys(cfg, steps=RECSYS_STEPS, batch=RECSYS_TRAIN_BATCH)
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        first, last = history[0], history[-1]
        ms_step = 1e3 * (last["s"] - first["s"]) / (last["step"] - first["step"])
        n_params = sum(p.numel() for p in model.parameters())
        res["train"] = {
            "steps": RECSYS_STEPS, "batch": RECSYS_TRAIN_BATCH, "n_params": n_params,
            "history": history, "first_step_s": first["s"], "ms_per_step": ms_step,
            "examples_s": RECSYS_TRAIN_BATCH * 1e3 / ms_step, "peak_gb": peak,
            "model_flops_share": 3 * recsys_flops(cfg, RECSYS_TRAIN_BATCH)
            / (ms_step / 1e3 * H100_BF16_FLOPS),
            "step_gb": recsys_step_bytes(cfg, n_params, RECSYS_TRAIN_BATCH) / 1e9,
            "bytes_bound_ms": 1e3 * recsys_step_bytes(cfg, n_params, RECSYS_TRAIN_BATCH)
            / H100_BYTES_PER_S}
        losses = [h["loss"] for h in history]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase 28: {arch}'s loss is not finite and falling: {history}")
        # the host's share of a step: train_recsys draws each batch with numpy
        t0 = time.perf_counter()
        for i in range(3):
            recsys_batch_of(cfg, RECSYS_TRAIN_BATCH, (28, 10 + i))
        torch.cuda.synchronize()
        res["train"]["batch_draw_ms"] = 1e3 * (time.perf_counter() - t0) / 3

        # one step profiled, from a fresh AdamW state after a warm step
        opt = adamw(warmup_cosine(PEAK_LR, WARMUP, RECSYS_STEPS))
        step_fn = make_train_step(lambda m, b: recsys_loss(m, b, cfg), opt)
        state = [opt.init(dict(model.named_parameters()))]
        batch = recsys_batch_of(cfg, RECSYS_TRAIN_BATCH, (28, 0))

        def one():
            _, state[0], _ = step_fn(model, state[0], batch)

        one()
        res["train"]["step_profile"] = kernel_breakdown(*_profiled(one), top=10)
        del state, batch
        torch.cuda.empty_cache()
        log(f"{arch} train: " + json.dumps(res))

        # 3. serving
        res["serve"] = {shape: recsys_serve(model, cfg, shape, rows)
                        for shape, rows in RECSYS_SERVE}
        log(f"{arch} serve: " + json.dumps(res["serve"]))
        if not all(r["finite"] and r["shape_ok"] for r in res["serve"].values()):
            raise AssertionError(f"phase 28: {arch}'s serving output: {res['serve']}")
        torch.cuda.empty_cache()

        # 4. the card against the CPU, at full width and at SMOKE
        res["vs_cpu"] = recsys_against_cpu(model, cfg, arch)
        del model
        torch.cuda.empty_cache()
        smoke = get_smoke_config(arch)
        cpu_model = recsys.init_params(smoke, torch.Generator().manual_seed(1), device="cpu")
        card_model = recsys.init_params(smoke, torch.Generator().manual_seed(1), device="cuda")
        b = recsys_batch_of(smoke, 64, (28, 3), device="cpu")
        with torch.no_grad():
            want = recsys.forward(cpu_model, b, smoke)
            got = recsys.forward(card_model, {k: v.cuda() for k, v in b.items()}, smoke).cpu()
        res["vs_cpu"]["smoke"] = {"max_abs_err": float((got - want).abs().max()),
                                  "ok": bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))}
        log(f"{arch} card against the CPU: " + json.dumps(res["vs_cpu"]))
        checks = [res["vs_cpu"]["forward"]["ok"], res["vs_cpu"]["train_step"]["ok"],
                  res["vs_cpu"]["smoke"]["ok"]]
        checks += [res["vs_cpu"]["embedding_bag"][m]["ok"] for m in ("sum", "mean", "max")
                   if "embedding_bag" in res["vs_cpu"]]
        if not all(checks):
            raise AssertionError(f"phase 28: {arch} on the card differs from the CPU: "
                                 f"{res['vs_cpu']}")
        line[arch] = res

    # 5. the paper's retrieval configs resolve through the registry
    mod = get_module("swgraph-retrieval")
    names = ("WIKI8_KL", "WIKI128_KL", "RCV128_IS", "RANDHIST32_RENYI2", "MANNER_BM25", "SMOKE")
    line["retrieval_configs"] = {n: dataclasses.asdict(getattr(mod, n)) for n in names}
    if not (get_config("swgraph-retrieval") is mod.WIKI128_KL
            and get_smoke_config("swgraph-retrieval") is mod.SMOKE):
        raise AssertionError("phase 28: swgraph-retrieval does not resolve to WIKI128_KL and "
                             "SMOKE")
    log("retrieval configs: " + json.dumps(line["retrieval_configs"]))
    return line


# ---------------------------------------------------------------------------
# phase 29: the device mesh, every on-mesh path against the off-mesh one
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_call(dev, fn):
    """(fn(), ms): the host clock around one synchronised call."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _seeded(dev, seed: int):
    return torch.Generator(device=dev).manual_seed(seed)


def _free() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _close(got, want, tol: dict) -> dict:
    """Elementwise ``|got - want| <= atol + rtol |want|``, with the largest error."""
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.all(diff <= tol["atol"] + tol["rtol"] * want.float().abs()))
    return {"ok": ok and bool(torch.isfinite(got).all()), "max_abs_err": float(diff.max()),
            "max_abs": float(want.float().abs().max())}


def _rel_to_max(got, want) -> float:
    """max |got - want| over max |want|: the decode checks' measure."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30))


def mesh_xent_check(mesh, dev, cfg, B: int, T: int, t_chunk: int) -> dict:
    """``sharded_xent`` on ``cfg``'s tied head (vocab over "model") and hidden
    states from its ``forward_hidden`` (computed once on rank 0, sharded over
    "data"): the loss and the gradients of hidden and the head block, against
    the plain cross-entropy's autograd on rank 0, one batch row at a time.
    Twice: with the head as drawn, whose logits (std ~sqrt(d) at init)
    saturate the softmax, so the gradients are differences of two head rows;
    and with the head scaled by d^-1/2, logits of unit scale, where every
    vocabulary block's share of the log-sum-exp counts."""
    import torch.distributed as tdist

    from repro_torch.core import distributed as cd
    from repro_torch.models import transformer
    from repro_torch.sharding.api import P, shard, unshard
    from repro_torch.train.train_step import sharded_xent

    rank0 = mesh.rank == 0
    V, d = cfg.vocab_size, cfg.d_model
    hidden = torch.empty((B, T, d), device=dev)
    head = torch.empty((d, V), device=dev)
    if rank0:
        model = transformer.init_params(cfg, device=dev)
        tokens = torch.randint(0, V, (B, T), generator=_seeded(dev, 290), device=dev)
        with torch.no_grad():
            h, _ = transformer.forward_hidden(model, tokens, cfg)
        hidden.copy_(h.float())
        head.copy_(transformer.lm_head(model, cfg).detach().float())
        del model, h
        _free()
    tdist.broadcast(hidden, 0, group=mesh.group)
    tdist.broadcast(head, 0, group=mesh.group)
    labels = torch.randint(0, V, (B, T), generator=_seeded(dev, 291), device=dev)
    rows, cols = P(("data",), None, None), P(None, "model")
    hidden_l, head_l = shard(hidden, rows, mesh), shard(head, cols, mesh)
    labels_l = shard(labels, P(("data",), None), mesh)
    res = {"shape": [B, T, d, V], "t_chunk": t_chunk}
    for tag, scale in (("head", 1.0), ("head_scaled", d ** -0.5)):
        r = {"head_scale": scale}
        if rank0:
            hr = hidden.clone().requires_grad_(True)
            wr = (head * scale).requires_grad_(True)

            def reference():
                total = 0.0
                for b in range(B):
                    logits = hr[b] @ wr
                    ll = torch.gather(logits, -1, labels[b][:, None])[:, 0]
                    nll = torch.sum(torch.logsumexp(logits, dim=-1) - ll) / (B * T)
                    nll.backward()
                    total += float(nll.detach())
                return total

            ref_loss, r["off_mesh_ms"] = _timed_call(dev, reference)
            ref_gh, ref_gw = hr.grad, wr.grad
            del hr, wr
            _free()
        hl = hidden_l.clone().requires_grad_(True)
        wl = (head_l * scale).requires_grad_(True)
        cd.reset_collective_stats()

        def run():
            loss = sharded_xent(hl, wl, labels_l, mesh, t_chunk=t_chunk)
            loss.backward()
            return loss.detach()

        loss, r["mesh_ms"] = _timed_call(dev, run)
        r["collectives"] = cd.collective_stats()["kinds"]
        gh, gw = unshard(hl.grad, rows, mesh), unshard(wl.grad, cols, mesh)
        if rank0:
            r.update(loss=float(loss), loss_off_mesh=ref_loss,
                     loss_rel_err=abs(float(loss) - ref_loss) / abs(ref_loss),
                     grad_hidden=_close(gh, ref_gh, XENT_GRAD_TOL),
                     grad_head=_close(gw, ref_gw, XENT_GRAD_TOL))
            r["ok"] = (r["loss_rel_err"] <= XENT_LOSS_RTOL and r["grad_hidden"]["ok"]
                       and r["grad_head"]["ok"])
            del ref_gh, ref_gw
        del hl, wl, gh, gw
        _free()
        res[tag] = r
    if rank0:
        res["ok"] = res["head"]["ok"] and res["head_scaled"]["ok"]
    return res


def _kv_fill(dev, kind: str, cfg, layer: int, row: int, cache_len: int):
    """The seeded random k or v of one (layer, row) of a decode check's cache."""
    seed = 29_000_000 + 10_000 * layer + 10 * row + ("k", "v").index(kind)
    return torch.randn((cache_len, cfg.n_kv_heads, cfg.d_head), generator=_seeded(dev, seed),
                       device=dev)


def block_local_mask(attend):
    """A planted fault: the sequence-parallel decode masks by the block's own
    positions (``pos_offset`` 0), not the absolute ones."""
    def planted(*args, **kw):
        kw["pos_offset"] = 0
        return attend(*args, **kw)

    return planted


def mesh_decode_check(mesh, dev, cfg, cache_len: int, lengths, steps: int,
                      plant: bool = False) -> dict:
    """``decode_step(mesh=)``, the cache over ("data", "model"): ``steps``
    steps from seeded random caches at ``lengths``, each step's logits within
    DECODE_TOL of rank 0's off-mesh decode relative to its largest |logit|,
    equal argmax; the written k and v within CACHE_TOL and no other entry
    changed.  With ``plant``, the same run under a block-local mask must fail."""
    from repro_torch.core import distributed as cd
    from repro_torch.models import transformer as tt
    from repro_torch.sharding.api import P, psum, shard, unshard, use_mesh

    rank0 = mesh.rank == 0
    B, L = len(lengths), cfg.n_layers
    params = tt.init_params(cfg, device=dev)  # one seed on one card: alike on every rank
    tokens = torch.randint(0, cfg.vocab_size, (steps, B), generator=_seeded(dev, 292), device=dev)
    length0 = torch.tensor(lengths, dtype=torch.int32, device=dev)
    res = {"layers": L, "batch": B, "cache_len": cache_len, "lengths": list(lengths),
           "steps": steps}
    if rank0:
        cache = tt.init_kv_cache(cfg, B, cache_len, device=dev)
        for layer in range(L):
            for b in range(B):
                for kind in ("k", "v"):
                    cache[kind][layer, b] = _kv_fill(dev, kind, cfg, layer, b, cache_len)
        cache["length"].copy_(length0)
        ref_logits, ms = [], []
        for i in range(steps):
            (logits, cache), t = _timed_call(dev, lambda: tt.decode_step(params, cache,
                                                                         tokens[i], cfg))
            ref_logits.append(logits)
            ms.append(t)
        res["off_mesh_ms_per_step"] = float(np.mean(ms[1:]))
        pos = length0.long()[:, None] + torch.arange(steps, device=dev)
        rows_idx = torch.arange(B, device=dev)[:, None]
        ref_written = {kind: cache[kind][:, rows_idx, pos] for kind in ("k", "v")}
        del cache
        _free()
    n_dp, n_sp = mesh.shape["data"], mesh.shape["model"]
    B_loc, S_loc = B // n_dp, cache_len // n_sp
    rows = [mesh.axis_index("data") * B_loc + j for j in range(B_loc)]
    lo = mesh.axis_index("model") * S_loc
    length_l = shard(length0, P(("data",)), mesh)

    def local_cache():
        shape = (L, B_loc, S_loc, cfg.n_kv_heads, cfg.d_head)
        c = {"k": torch.empty(shape, device=dev), "v": torch.empty(shape, device=dev),
             "length": length_l.clone()}
        for layer in range(L):
            for j, b in enumerate(rows):
                for kind in ("k", "v"):
                    c[kind][layer, j] = _kv_fill(dev, kind, cfg, layer, b, cache_len)[lo:lo + S_loc]
        return c

    def run(cache):
        logits, ms = [], []
        with use_mesh(mesh):
            for i in range(steps):
                toks = shard(tokens[i], P(("data",)), mesh)
                (lg, cache), t = _timed_call(dev, lambda: tt.decode_step(
                    params, cache, toks, cfg, mesh=mesh, seq_axes=("model",), dp=("data",)))
                logits.append(lg)
                ms.append(t)
        return [unshard(lg, P(("data",), None), mesh) for lg in logits], cache, ms

    cd.reset_collective_stats()
    logits, cache_l, ms = run(local_cache())
    res["collectives"] = cd.collective_stats()["kinds"]
    res["mesh_ms_per_step"] = float(np.mean(ms[1:]))
    # the written entries, from whichever block holds each; nothing else changed
    pos = length_l.long()[:, None] + torch.arange(steps, device=dev) - lo  # (B_loc, steps)
    held = (pos >= 0) & (pos < S_loc)
    j_idx = torch.arange(B_loc, device=dev)[:, None]
    written = {kind: unshard(psum(cache_l[kind][:, j_idx, pos.clamp(0, S_loc - 1)]
                                  * held[None, :, :, None, None], "model", mesh),
                             P(None, ("data",), None, None, None), mesh)
               for kind in ("k", "v")}
    changed = 0
    for layer in range(L):
        for j, b in enumerate(rows):
            keep = torch.ones(S_loc, dtype=torch.bool, device=dev)
            keep[pos[j][held[j]]] = False
            for kind in ("k", "v"):
                want = _kv_fill(dev, kind, cfg, layer, b, cache_len)[lo:lo + S_loc]
                changed += int((cache_l[kind][layer, j] != want).flatten(1).any(1)[keep].sum())
    res["unwritten_changed"] = int(psum(torch.tensor(float(changed), device=dev),
                                        ("data", "model"), mesh))
    del cache_l
    _free()
    if plant:
        attend = tt.decode_attention_local
        tt.decode_attention_local = block_local_mask(attend)
        try:
            planted, _, _ = run(local_cache())
        finally:
            tt.decode_attention_local = attend
    if rank0:
        errs = [_rel_to_max(g, w) for g, w in zip(logits, ref_logits)]
        res.update(rel_err_per_step=errs, max_rel_err=max(errs),
                   argmax_equal=all(bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                                    for g, w in zip(logits, ref_logits)),
                   finite=all(bool(torch.isfinite(g).all()) for g in logits),
                   written={kind: _close(written[kind], ref_written[kind], CACHE_TOL)
                            for kind in ("k", "v")})
        res["ok"] = (res["max_rel_err"] <= DECODE_TOL and res["argmax_equal"] and res["finite"]
                     and all(w["ok"] for w in res["written"].values())
                     and res["unwritten_changed"] == 0)
        if plant:
            res["planted_max_rel_err"] = max(_rel_to_max(g, w)
                                             for g, w in zip(planted, ref_logits))
            res["planted_fails"] = res["planted_max_rel_err"] > DECODE_TOL
            res["ok"] = res["ok"] and res["planted_fails"]
    return res


def mesh_moe_check(mesh, dev, cfg, shape) -> dict:
    """``moe_ffn`` under the mesh (``_moe_ffn_ep``): the output, aux and the
    gradients of the input, the router and every expert of ``loss = sum(out
    * cot) + 0.5 aux``, against rank 0's off-mesh ``_moe_ffn_gather`` over the
    mesh's data groups (one call per group, the aux their mean); some
    assignment must drop."""
    from repro_torch.core import distributed as cd
    from repro_torch.models import moe
    from repro_torch.sharding.api import P, psum, shard, unshard, use_mesh

    rank0 = mesh.rank == 0
    n_dp = mesh.shape["data"]
    B, T = shape
    d = cfg.d_model
    full = {k: w[0] for k, w in moe.init_moe_layer(cfg, _seeded(dev, 293), dev).items()}
    # tokens that share a component route alike: the experts' loads skew and the
    # capacity drops assignments (independent tokens at init spread evenly)
    shared = torch.randn((d,), generator=_seeded(dev, 300), device=dev)
    h = torch.randn((B, T, d), generator=_seeded(dev, 294), device=dev) + shared
    cot = torch.randn((B, T, d), generator=_seeded(dev, 295), device=dev)
    res = {"tokens": [B, T], "capacity_factor": cfg.moe.capacity_factor}
    if rank0:
        ref_h = h.clone().requires_grad_(True)
        ref_lp = {k: w.clone().requires_grad_(True) for k, w in full.items()}

        def reference():
            parts = [moe._moe_ffn_gather(hb, ref_lp, cfg) for hb in ref_h.chunk(n_dp)]
            out = torch.cat([p[0] for p in parts])
            aux = torch.stack([p[1] for p in parts]).mean()
            (torch.sum(out * cot) + 0.5 * aux).backward()
            return out.detach(), aux.detach()

        (ref_out, ref_aux), res["off_mesh_ms"] = _timed_call(dev, reference)
        ref_grads = {"h": ref_h.grad, **{k: w.grad for k, w in ref_lp.items()}}
        del ref_h, ref_lp
        _free()
    specs = {k: P(*s[1:]) for k, s in moe.moe_layer_specs(cfg).items()}
    rows = P(("data",), None, None)
    lp = {k: shard(full[k], specs[k], mesh).requires_grad_(True) for k in specs}
    hl = shard(h, rows, mesh).requires_grad_(True)
    cot_l = shard(cot, rows, mesh)
    del full, h, cot
    _free()
    cd.reset_collective_stats()

    def run():
        with use_mesh(mesh):
            out, aux = moe.moe_ffn(hl, lp, cfg)
            (psum(torch.sum(out * cot_l), "data", mesh) + 0.5 * aux).backward()
        return out.detach(), aux.detach()

    (out, aux), res["mesh_ms"] = _timed_call(dev, run)
    res["collectives"] = cd.collective_stats()["kinds"]
    N_loc = hl.shape[0] * hl.shape[1]
    _, _, idx = moe._route(hl.detach().reshape(N_loc, d), lp["router"].detach(), cfg.moe.top_k)
    C = moe._capacity(N_loc, cfg)
    plan = moe._routing_plan(idx[None], cfg.moe.n_experts, C)
    dropped = psum((plan["dest"] >= cfg.moe.n_experts * C).sum().float(), "data", mesh)
    res["dropped_share"] = float(dropped) / (B * T * cfg.moe.top_k)
    got = {"out": unshard(out, rows, mesh)}
    if rank0:
        res["out"] = _close(got.pop("out"), ref_out, MOE_MESH_TOL)
        res["aux"] = _close(aux, ref_aux, MOE_MESH_TOL)
    grads = {"h": (hl, rows), **{k: (lp[k], specs[k]) for k in specs}}
    for name, (t, spec) in grads.items():  # one full gradient at a time
        g = unshard(t.grad, spec, mesh)
        if rank0:
            res[f"grad_{name}"] = _close(g, ref_grads.pop(name), MOE_MESH_TOL)
        del g
        _free()
    if rank0:
        res["ok"] = (res["dropped_share"] > 0
                     and all(v["ok"] for v in res.values() if isinstance(v, dict) and "ok" in v))
    return res


def mesh_embedding_check(mesh, dev, cfg, batches) -> dict:
    """The row-sharded ``embedding_lookup`` over ``cfg``'s whole padded table,
    its rows over ("model", "data"), at each batch (the scatter path where the
    4 row shards divide it, else the psum path): the lookup against rank 0's
    ``table[ids + offsets]``, and each rank's block of the table's gradient
    against the off-mesh gradient's rows.  The cotangent is integer-valued,
    so every sum is exact in float32 in any order: both must be equal.  No
    collective of the path, forward or backward, moves more than the
    lookup's (B, F, dim) block."""
    from repro_torch.core import distributed as cd
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import recsys
    from repro_torch.models.embedding import embedding_lookup, field_offsets, table_spec
    from repro_torch.sharding.api import P, psum, shard, unshard, use_mesh

    rank0 = mesh.rank == 0
    rows, d = recsys._pad_vocab(cfg), cfg.embed_dim
    table = torch.randn((rows, d), generator=_seeded(dev, 296), device=dev) * d ** -0.5
    offsets = field_offsets(cfg.vocab_sizes, dev)
    spec = table_spec("model", "data")
    block = shard(table, spec, mesh)
    res = {"table_rows": rows, "embed_dim": d, "table_gb": table.numel() * 4 / 1e9,
           "block_gb": block.numel() * 4 / 1e9}
    if not rank0:
        del table
        _free()
    for B in batches:
        ids = recsys_batch(np.random.default_rng(297), B, cfg.vocab_sizes, dev,
                           n_dense=cfg.n_dense)["sparse_ids"]
        cot = torch.randint(-4, 5, (B, ids.shape[1], d), generator=_seeded(dev, 298),
                            device=dev).float()
        r = {}
        if rank0:
            tr = table.clone().requires_grad_(True)

            def reference():
                out = embedding_lookup(tr, ids, offsets)
                torch.sum(out * cot).backward()
                return out.detach()

            ref_out, r["off_mesh_ms"] = _timed_call(dev, reference)
            ref_grad = tr.grad
            del tr
        n_shards = mesh.size_of(("model", "data"))
        scatter = B % n_shards == 0 and B >= n_shards
        out_spec = P(("data",), None, None) if scatter else P()
        tl = block.clone().requires_grad_(True)
        cot_l = shard(cot, out_spec, mesh)
        cd.reset_collective_stats()

        def run():
            with use_mesh(mesh):
                out = embedding_lookup(tl, ids, offsets)
                loss = torch.sum(out * cot_l)
                (psum(loss, "data", mesh) if scatter else loss).backward()
            return out.detach()

        out, r["mesh_ms"] = _timed_call(dev, run)
        r["collectives"] = cd.collective_stats()["kinds"]
        r["path"] = "psum_scatter" if scatter else "psum"
        r["max_collective_bytes"] = max(s["max_bytes"] for s in r["collectives"].values())
        r["lookup_bytes"] = cot.numel() * 4
        r["moves_at_most_the_lookup"] = r["max_collective_bytes"] <= r["lookup_bytes"]
        got_out, got_grad = unshard(out, out_spec, mesh), unshard(tl.grad, spec, mesh)
        if rank0:
            r["out_equal"] = bool(torch.equal(got_out, ref_out))
            r["grad_equal"] = bool(torch.equal(got_grad, ref_grad))
            r["grad"] = _close(got_grad, ref_grad, dict(rtol=1e-6, atol=0.0))
            r["ok"] = r["out_equal"] and r["grad_equal"] and r["moves_at_most_the_lookup"]
            del ref_grad
        del got_grad, tl
        _free()
        res[f"B={B}"] = r
    if rank0:
        res["ok"] = all(r["ok"] for k, r in res.items() if k.startswith("B="))
    return res


def mesh_gcn_check(mesh, dev, cfg, n_nodes: int, n_edges: int, seed: int) -> dict:
    """``gnn.forward(edge_sharded=True)``, ``loss_fn`` and the gradients: each
    rank holds a contiguous quarter of the self-looped edge list (the count
    need not divide), the features whole; against rank 0's off-mesh path."""
    from repro_torch.core import distributed as cd
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models import gnn
    from repro_torch.sharding.api import use_mesh

    rank0 = mesh.rank == 0
    g = random_graph(np.random.default_rng(seed), n_nodes, n_edges, cfg.d_feat,
                     n_classes=cfg.n_classes, device=dev)
    params = gnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    res = {"n_nodes": n_nodes, "n_edges": n_edges, "d_feat": cfg.d_feat,
           "n_classes": cfg.n_classes}
    if rank0:
        def reference():
            with torch.no_grad():
                logits = gnn.forward(params, g, cfg)
            loss = gnn.loss_fn(params, g, cfg)
            loss.backward()
            return logits, loss.detach()

        (ref_logits, ref_loss), res["off_mesh_ms"] = _timed_call(dev, reference)
        ref_grads = {k: p.grad for k, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        _free()
    loops = torch.arange(n_nodes, dtype=g["senders"].dtype, device=dev)
    shards = mesh.size_of(("data",))
    local = {k: torch.tensor_split(torch.cat([g.pop(k), loops]), shards)[mesh.index("data")]
             .clone() for k in ("senders", "receivers")}
    local.update(features=g["features"], labels=g["labels"])
    res["edges_per_rank"] = int(local["senders"].shape[0])
    del g
    _free()
    cd.reset_collective_stats()

    def run():
        with use_mesh(mesh):
            with torch.no_grad():
                logits = gnn.forward(params, local, cfg, edge_sharded=True)
            loss = gnn.loss_fn(params, local, cfg, edge_sharded=True)
            loss.backward()
        return logits, loss.detach()

    (logits, loss), res["mesh_ms"] = _timed_call(dev, run)
    res["collectives"] = cd.collective_stats()["kinds"]
    if rank0:
        res["logits"] = _close(logits, ref_logits, GCN_MESH_TOL)
        res["loss"] = _close(loss, ref_loss, GCN_MESH_TOL)
        res["grads"] = {k: _close(p.grad, ref_grads[k], GCN_MESH_TOL)
                        for k, p in params.named_parameters()}
        res["ok"] = (res["logits"]["ok"] and res["loss"]["ok"]
                     and all(v["ok"] for v in res["grads"].values()))
    return res


def mesh_lm_loss_check(mesh, dev, cfg, B: int, T: int) -> dict:
    """``lm_loss`` under the mesh (``sharded_xent``; the MoE expert-parallel,
    its experts as ``moe_layer_specs`` blocks, or on a mesh without "model"
    the gather path on the rank's block; the dense weights replicated)
    against the mean of the off-mesh ``lm_loss`` over the data blocks: the
    loss and every parameter's gradient."""
    from repro_torch.convert import shard_tree
    from repro_torch.models import moe
    from repro_torch.models import transformer as tt
    from repro_torch.sharding.api import P, shard, unshard, use_mesh
    from repro_torch.train.train_step import lm_loss

    n_dp = mesh.shape["data"]
    full = tt.init_params(cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=_seeded(dev, 299), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ref, off_ms = _timed_call(dev, lambda: sum(
        lm_loss(full, {k: v.chunk(n_dp)[b] for k, v in batch.items()}, cfg)[0]
        for b in range(n_dp)) / n_dp)
    ref.backward()
    specs = moe.moe_layer_specs(cfg) if cfg.is_moe and "model" in mesh.axis_names else {}
    layers = {k: p.detach() for k, p in full.layers.items()}
    local = shard_tree(layers, {k: specs.get(k, P()) for k in layers}, mesh)
    model = tt.LMParams(full.embed.detach().clone(), full.ln_f.detach().clone(), local,
                        None if full.lm_head is None else full.lm_head.detach().clone())

    def run():
        with use_mesh(mesh):
            block = {k: shard(v, P(("data",), None), mesh) for k, v in batch.items()}
            loss, _ = lm_loss(model, block, cfg)
            loss.backward()
        return loss.detach()

    loss, ms = _timed_call(dev, run)
    grads = {k: _close(unshard(p.grad, specs.get(k.removeprefix("layers."), P()), mesh),
                       dict(full.named_parameters())[k].grad, TOL)
             for k, p in model.named_parameters()}
    res = {"loss": float(loss), "loss_off_mesh": float(ref.detach()), "mesh_ms": ms,
           "off_mesh_ms": off_ms,
           "loss_close": _close(loss, ref.detach(), TOL), "grads": grads}
    res["ok"] = res["loss_close"]["ok"] and all(g["ok"] for g in grads.values())
    return res


def mesh_rank(dev) -> dict:
    """Phase 29 on one of the 4 ranks: the sub-checks in turn, memory freed
    between them; rank 0 runs each off-mesh reference first."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.gcn_cora import with_shape
    from repro_torch.sharding.api import Mesh

    float32_highest()
    mesh22, mesh41 = Mesh(*MESH_22), Mesh(*MESH_41)
    llama, gemma = get_config("llama3.2-1b"), get_config("gemma3-12b")
    phi = get_config("phi3.5-moe-42b-a6.6b")
    sh = OGB_PRODUCTS
    checks = {
        "sharded_xent llama3.2-1b": lambda: mesh_xent_check(mesh22, dev, llama, XENT_B, XENT_T,
                                                            XENT_CHUNK),
        "decode_step llama3.2-1b": lambda: mesh_decode_check(
            mesh22, dev, dataclasses.replace(llama, dtype="float32"), LLAMA_CACHE,
            LLAMA_LENGTHS, MESH_DECODE_STEPS),
        "decode_step gemma3-12b": lambda: mesh_decode_check(
            mesh22, dev, dataclasses.replace(gemma, dtype="float32", n_layers=GEMMA_CUT_LAYERS),
            GEMMA_CACHE, GEMMA_LENGTHS, MESH_DECODE_STEPS, plant=True),
        "moe_ffn phi3.5-moe": lambda: mesh_moe_check(
            mesh22, dev, dataclasses.replace(phi, n_layers=1, dtype="float32"), MOE_MESH_TOKENS),
        "embedding_lookup autoint": lambda: mesh_embedding_check(mesh22, dev,
                                                                 get_config("autoint"),
                                                                 EMB_MESH_BATCHES),
        "gcn ogb_products": lambda: mesh_gcn_check(
            mesh41, dev, with_shape(sh["d_feat"], sh["n_classes"]), sh["n_nodes"],
            sh["n_edges"], 29),
    }
    out = {"rank": mesh22.rank, "backend": mesh22.backend, "composed": mesh22.composed,
           "checks": {}}
    for name, fn in checks.items():
        _free()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fn()
        res["seconds"] = time.perf_counter() - t0
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["checks"][name] = res
    out["fsdp"] = fsdp_rank(dev, mesh22)  # phase 30 (a) on the same ranks and mesh
    return out


def mesh_world1() -> dict:
    """Every on-mesh path at SMOKE on a (1, 1) mesh of a world-1 NCCL group in
    this process (one card per rank: NCCL's reduce_scatter_tensor and
    all_gather_into_tensor), against the off-mesh path."""
    import torch.distributed as tdist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import distributed as cd
    from repro_torch.core.distributed import init_group
    from repro_torch.sharding import api

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_group("nccl", f"tcp://localhost:{free_port()}", 0, 1)
    try:
        mesh = api.Mesh((1, 1), ("data", "model"))
        cd.reset_collective_stats()
        checks = {
            "sharded_xent": mesh_xent_check(mesh, dev, get_smoke_config("llama3.2-1b"), 2, 64,
                                            16),
            "lm_loss llama3.2-1b": mesh_lm_loss_check(mesh, dev,
                                                      get_smoke_config("llama3.2-1b"), 8, 32),
            "lm_loss phi3.5-moe": mesh_lm_loss_check(
                mesh, dev, get_smoke_config("phi3.5-moe-42b-a6.6b"), 8, 32),
            "lm_loss phi3.5-moe data-only": mesh_lm_loss_check(
                api.Mesh((1,), ("data",)), dev, get_smoke_config("phi3.5-moe-42b-a6.6b"), 8, 32),
            "decode_step gemma3-12b": mesh_decode_check(mesh, dev, get_smoke_config("gemma3-12b"),
                                                        32, (13, 15, 9, 20), 5),
            "moe_ffn phi3.5-moe": mesh_moe_check(mesh, dev,
                                                 get_smoke_config("phi3.5-moe-42b-a6.6b"),
                                                 (4, 16)),
            "embedding_lookup autoint": mesh_embedding_check(mesh, dev,
                                                             get_smoke_config("autoint"), (64, 5)),
            "gcn": mesh_gcn_check(mesh, dev, get_smoke_config("gcn-cora"), 500, 2000, 29),
        }
        totals = cd.collective_stats()["kinds"]
        fsdp = fsdp_world1(mesh, dev)  # phase 30 (a) at SMOKE on the same NCCL rank
    finally:
        tdist.destroy_process_group()
    return {"backend": mesh.backend, "composed": mesh.composed, "checks": checks,
            "collectives": totals, "fsdp": fsdp}


def mesh_line(ranks: list, backend: str, per_card) -> dict:
    """Phase 29's line from every rank's results; fails unless every check
    held, and unless no rank's lookup moved a collective as large as a table
    block or larger than its (B, F, dim) lookup."""
    line = {"backend": backend, "ranks_per_card": per_card, "composed": ranks[0]["composed"],
            "checks": ranks[0]["checks"],
            "peak_gb_by_rank": {name: [rk["checks"][name]["peak_gb"] for rk in ranks]
                                for name in ranks[0]["checks"]}}
    for name, res in line["checks"].items():
        log(f"phase 29 {name}: " + json.dumps(res))
        if not res["ok"]:
            raise AssertionError(f"phase 29: {name} on the mesh differs from the off-mesh path: "
                                 f"{res}")
    for rk in ranks:  # no collective the size of the table, or of a rank's block of it
        emb = rk["checks"]["embedding_lookup autoint"]
        for key, r in emb.items():
            if key.startswith("B=") and not (r["moves_at_most_the_lookup"] and
                                             r["max_collective_bytes"] < 1e9 * emb["block_gb"]):
                raise AssertionError(f"phase 29: rank {rk['rank']}'s lookup at {key} moved "
                                     f"{r['max_collective_bytes']} bytes in one collective")
    log("phase 29 peak GB by rank: " + json.dumps(line["peak_gb_by_rank"]))
    log(f"phase 29: backend {backend}, composed {json.dumps(line['composed'])}")
    return line


def phase29() -> tuple:
    """The device mesh (module docstring); also returns the ranks' and the
    world-1 group's phase 30 (a) results, run on the same spawn and group."""
    from repro_torch.core.distributed import pick_backend

    from repro_torch.launch import mesh as launch_mesh

    backend, per_card = pick_backend(MESH_RANKS, "cuda")
    log(f"phase 29: {MESH_RANKS} ranks, backend {backend}, {per_card} ranks per card")
    constants = {name: getattr(launch_mesh, name)
                 for name in ("PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "HBM_PER_CHIP")}
    constants["card_total_memory"] = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 29: launch/mesh.py's constants beside the card ({card_line()}): "
        + json.dumps(constants))
    ranks = spawn_ranks(mesh_rank)
    fsdp_ranks = [rk.pop("fsdp") for rk in ranks]
    line = mesh_line(ranks, backend, per_card)
    line["constants"] = constants
    world1 = mesh_world1()
    fsdp_world = world1.pop("fsdp")
    for name, res in world1["checks"].items():
        log(f"phase 29 world 1 (nccl) {name}: " + json.dumps(res))
        if not res["ok"]:
            raise AssertionError(f"phase 29: world size 1 {name} differs from the off-mesh "
                                 f"path: {res}")
    if world1["backend"] != "nccl" or world1["composed"]:
        raise AssertionError(f"phase 29: world size 1 ran on {world1['backend']}, composed "
                             f"{world1['composed']}")
    line["world1"] = world1
    return line, fsdp_ranks, fsdp_world


def fsdp_check(mesh, dev, cfg, B: int, T: int, prompt: int, cache_len: int,
               steps: int) -> dict:
    """FSDP x TP blocks of ``cfg`` against rank 0's off-mesh path: prefill,
    ``steps`` decode steps, one AdamW step with ``accum_steps=2`` (phase 30)."""
    from repro_torch.core import distributed as cd
    from repro_torch.models import transformer as tt
    from repro_torch.sharding.api import P, flatten, shard, unshard, use_mesh
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import lm_loss, make_train_step

    rank0 = mesh.rank == 0
    full = tt.init_params(cfg, device=dev)  # one seed on one card: alike on every rank
    specs = tt.param_specs(cfg, fsdp_axis=("data",))
    flat = flatten(specs)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=_seeded(dev, 301), device=dev)
    ptoks = torch.randint(0, cfg.vocab_size, (B, prompt), generator=_seeded(dev, 302),
                          device=dev)
    dtoks = torch.randint(0, cfg.vocab_size, (steps, B), generator=_seeded(dev, 303), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rows = P(("data",), None)
    kv = tt.kv_cache_specs(("model",), ("data",))
    res = {"layers": cfg.n_layers, "batch": B, "seq": T, "prompt": prompt,
           "cache_len": cache_len, "decode_steps": steps}
    with use_mesh(mesh):
        model = tt.shard_params(full, specs, mesh)
    res["block_share"] = (sum(p.numel() for p in model.parameters())
                          / sum(p.numel() for p in full.parameters()))

    def stats(label, t0):
        st = cd.collective_stats()["kinds"]
        res[f"{label}_collectives"] = {k: {"calls": v["calls"], "bytes": v["bytes"],
                                           "seconds": v["seconds"]} for k, v in st.items()}
        res[f"{label}_fsdp_gather_s"] = st.get("fsdp_gather", {}).get("seconds", 0.0)
        res[f"{label}_s"] = time.perf_counter() - t0

    # serving: prefill, then decode on its cache
    if rank0:
        (ref_pl, ref_cache), res["off_mesh_prefill_ms"] = _timed_call(dev, lambda: tt.prefill(
            full, ptoks, cfg, max_len=cache_len))
        ref_dec = []
        for i in range(steps):
            lg, ref_cache = tt.decode_step(full, ref_cache, dtoks[i], cfg)
            ref_dec.append(lg)
    cd.reset_collective_stats()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        (pl, cache), res["mesh_prefill_ms"] = _timed_call(dev, lambda: tt.prefill(
            model, shard(ptoks, rows, mesh), cfg, max_len=cache_len))
        dec = []
        for i in range(steps):
            lg, cache = tt.decode_step(model, cache, shard(dtoks[i], P(("data",)), mesh), cfg,
                                       mesh=mesh, seq_axes=("model",), dp=("data",))
            dec.append(unshard(lg, rows, mesh))
        pl = unshard(pl, rows, mesh)
        cache = {k: unshard(cache[k], kv[k], mesh) for k in ("k", "v")}
    _sync(dev)
    stats("serve", t0)
    if rank0:
        errs = [_rel_to_max(g, w) for g, w in zip(dec, ref_dec)]
        res.update(prefill_rel_err=_rel_to_max(pl, ref_pl),
                   prefill_argmax_equal=bool(torch.equal(pl.argmax(-1), ref_pl.argmax(-1))),
                   cache={k: _close(cache[k], ref_cache[k], CACHE_TOL) for k in ("k", "v")},
                   decode_rel_err=errs,
                   decode_argmax_equal=all(bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                                           for g, w in zip(dec, ref_dec)))
        del ref_cache
    del cache, pl, dec
    _free()

    # one AdamW step, accum_steps=2, against the off-mesh step on rank 0
    lr = topt.warmup_cosine(FSDP_LR, 1, 100)

    def step_of(seen):
        inner = topt.adamw(lr)

        def update(grads, state, params):
            seen.update({k: g.detach() for k, g in grads.items()})
            return inner.update(grads, state, params)

        opt = topt.Optimizer(inner.init, update, inner.state_specs)
        return opt, make_train_step(lambda m, b: lm_loss(m, b, cfg), opt, accum_steps=2)

    if rank0:
        ref_seen = {}
        opt, step = step_of(ref_seen)
        (_, _, ref_m), res["off_mesh_step_ms"] = _timed_call(dev, lambda: step(
            full, opt.init(dict(full.named_parameters())), batch))
        ref_params = {k: p.detach() for k, p in full.named_parameters()}
    del full
    _free()
    seen = {}
    opt, step = step_of(seen)
    cd.reset_collective_stats()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        state = opt.init(dict(model.named_parameters()))
        block = {k: shard(v, rows, mesh) for k, v in batch.items()}
        (_, _, m), res["mesh_step_ms"] = _timed_call(dev, lambda: step(model, state, block))
    stats("train", t0)
    del state
    grads, params = {}, {}
    for k, p in model.named_parameters():
        g = unshard(seen[k].float(), flat[k], mesh)
        w = unshard(p.detach(), flat[k], mesh)
        if rank0:
            amp = ref_seen[k].abs() < 1e-6
            grads[k] = _close(g, ref_seen[k], TOL)
            params[k] = {"held": _close(w[~amp], ref_params[k][~amp], STEP_TOL),
                         "amplified": int(amp.sum()),
                         "amplified_within_lr": bool(((w - ref_params[k]).abs()[amp]
                                                      <= FSDP_LR).all())}
        del g, w
    if rank0:
        res.update(loss=float(m["loss"]), loss_off_mesh=float(ref_m["loss"]),
                   grad_norm=float(m["grad_norm"]), grad_norm_off_mesh=float(ref_m["grad_norm"]),
                   grads=grads, params=params)
        res["ok"] = (res["prefill_rel_err"] <= DECODE_TOL and res["prefill_argmax_equal"]
                     and all(c["ok"] for c in res["cache"].values())
                     and max(errs) <= DECODE_TOL and res["decode_argmax_equal"]
                     and abs(res["loss"] - res["loss_off_mesh"]) <= 1e-5 * abs(
                         res["loss_off_mesh"])
                     and abs(res["grad_norm"] - res["grad_norm_off_mesh"]) <= 1e-5 * abs(
                         res["grad_norm_off_mesh"])
                     and all(g["ok"] for g in grads.values())
                     and all(p["held"]["ok"] and p["amplified_within_lr"]
                             for p in params.values()))
    return res


def fsdp_rank(dev, mesh) -> dict:
    """Phase 30 (a) on one of the 4 ranks of phase 29's (2, 2) mesh."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32", n_layers=FSDP_LAYERS)
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = fsdp_check(mesh, dev, cfg, FSDP_B, FSDP_T, FSDP_PROMPT, FSDP_CACHE, FSDP_DECODE_STEPS)
    res["seconds"] = time.perf_counter() - t0
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return {"rank": mesh.rank, "backend": mesh.backend, "check": res}


def fsdp_world1(mesh, dev) -> dict:
    """Phase 30 (a) at SMOKE on phase 29's (1, 1) mesh of a world-1 NCCL group."""
    from repro_torch.configs import get_smoke_config

    res = fsdp_check(mesh, dev, get_smoke_config("llama3.2-1b"), 4, 32, 16, 32, 4)
    return {"backend": mesh.backend, "check": res}


def production_rank(out_path: str, device: str) -> None:
    """Phase 30 (b), run in its own process: rank 0 of the (16, 16) mesh
    under a fake group of 256 ranks, each cell's record to ``out_path``:
    the meta pass (``device="meta"``, on the CPU beside phase 29), or the
    card pass alone (``"cuda"``, ``count=False``, after it)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import list_cells

    by_id = {c.cell_id: c for c in list_cells()}
    mesh = dryrun.make_mesh("single_pod_16x16")
    recs = {}
    with tempfile.TemporaryDirectory() as art:
        for cid in PRODUCTION_CELLS:
            t0 = time.perf_counter()
            recs[cid] = dryrun.run_cell(by_id[cid], mesh, "single_pod_16x16", art, device,
                                        count=device == "meta")
            recs[cid]["wall_s"] = time.perf_counter() - t0
            _free()
    pathlib.Path(out_path).write_text(json.dumps(recs, default=str))


def retrieval_dm_row(rows: int, d: int) -> dict:
    """distance_matrix at the retrieval cell's per-rank shape: one negdot
    query against ``rows`` candidate rows of width ``d``, held to the plain
    version and timed beside it and ``torch.matmul``."""
    from repro_torch.core.distances import get_distance
    from repro_torch.kernels.distance_matrix import distance_matrix
    from repro_torch.kernels.ref import distance_matrix_ref, exact_float32_matmul

    dist = get_distance("negdot")
    g = _seeded(torch.device("cuda"), 304)
    # the cell's query and candidates are the towers' L2-normalised embeddings
    Q = torch.nn.functional.normalize(torch.randn(1, d, generator=g, device="cuda"), dim=1)
    X = torch.nn.functional.normalize(torch.randn(rows, d, generator=g, device="cuda"), dim=1)
    args = [(dist.prep_right(Q).contiguous(), dist.prep_left(X).contiguous(),
             dist.bias_right(Q).contiguous(), dist.bias_left(X).contiguous())]
    dm = lambda a, b, c, e: distance_matrix(a, b, c, e, dist.post_id, dist.c0)  # noqa: E731
    plain = lambda a, b, c, e: distance_matrix_ref(a, b, c, e, dist.post_id, dist.c0)  # noqa: E731

    def library(a, b, c, e):
        with exact_float32_matmul():
            return torch.matmul(a, b.T)

    err = check_close(f"distance_matrix retrieval cell 1x{rows}x{d}", dm(*args[0]),
                      plain(*args[0]), TOL)
    (b_ms, b_by) = dm_bound(1, rows, d)["tensor_core"]
    return {"shape": f"two-tower retrieval_cand, one rank of 256: 1x{rows}x{d} negdot",
            "B": 1, "N": rows, "m": d, "max_abs_err": err,
            "ms": device_ms(dm, args, 50, "distance_matrix_kernel"),
            "event_ms": time_ms(dm, args, 50), "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": device_ms(plain, args, 50), "library_ms": device_ms(library, args, 50)}


def production_pass(dev: str, tmp: str):
    """Phase 30 (b)'s ``dev`` pass (``production_rank``) in a new process."""
    code = ("import sys; sys.path[:0] = [sys.argv[3], sys.argv[4]]; import chip_smoke; "
            "chip_smoke.production_rank(sys.argv[1], sys.argv[2])")
    return subprocess.Popen(
        [sys.executable, "-c", code, str(pathlib.Path(tmp) / f"{dev}.json"), dev, str(SRC),
         str(ROOT)], cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def phase30(ranks: list, world1: dict, procs: dict, tmp) -> dict:
    """FSDP x TP and the dry run (module docstring): (a)'s results from phase
    29's ranks and world-1 group, (b)'s meta pass already running in
    ``procs`` (started before phase 29, on the CPU beside it)."""
    from repro_torch.core.distributed import pick_backend

    backend, per_card = pick_backend(MESH_RANKS, "cuda")
    t0 = time.perf_counter()
    line = {"backend": backend, "ranks_per_card": per_card, "check": ranks[0]["check"],
            "peak_gb_by_rank": [rk["check"]["peak_gb"] for rk in ranks],
            "fsdp_gather_s_by_rank": [{k: rk["check"][f"{k}_fsdp_gather_s"]
                                       for k in ("serve", "train")} for rk in ranks],
            "collectives_by_rank": [{k: rk["check"][f"{k}_collectives"]
                                     for k in ("serve", "train")} for rk in ranks]}
    log("phase 30 fsdp x tp llama3.2-1b: " + json.dumps(line))
    if not line["check"]["ok"]:
        raise AssertionError(f"phase 30: FSDP x TP differs from the off-mesh path: "
                             f"{line['check']}")
    log("phase 30 world 1 (nccl) fsdp x tp: " + json.dumps(world1))
    if world1["backend"] != "nccl" or not world1["check"]["ok"]:
        raise AssertionError(f"phase 30: world size 1 FSDP x TP differs: {world1}")
    line["world1"] = world1

    _free()
    with tmp:  # the card's pass alone on the card, once (a) has ended
        procs["cuda"] = production_pass("cuda", tmp.name)
        outs = {dev: p.communicate(timeout=600)[0] for dev, p in procs.items()}
        for dev, p in procs.items():
            log(f"phase 30 production cells, {dev} pass: rc {p.returncode}, "
                f"{time.perf_counter() - t0:.1f} s into phase 30\n" + outs[dev][-4000:])
            if p.returncode:
                raise AssertionError(f"phase 30: the production-mesh {dev} pass failed")
        recs = {dev: json.loads((pathlib.Path(tmp.name) / f"{dev}.json").read_text())
                for dev in procs}
    cells = {}
    for cid in PRODUCTION_CELLS:
        meta, card = recs["meta"][cid], recs["cuda"][cid]
        for rec in (meta, card):
            if rec["status"] != "ok":
                raise AssertionError(f"phase 30: {cid} on one rank of the (16, 16) mesh "
                                     f"({rec['device']}): {rec.get('error')}\n"
                                     f"{rec.get('traceback')}")
        mem, reck = card["memory"], meta["memory"]
        cells[cid] = {"measured_peak_gb": mem["measured_peak_bytes"] / 1e9,
                      "reckoned_peak_gb": reck["reckoned_peak_bytes"] / 1e9,
                      "argument_gb": reck["argument_bytes"] / 1e9, "step_ms": mem["step_ms"],
                      "launches": mem["launches"],
                      "useful_flops_ratio": meta["useful_flops_ratio"],
                      "roofline": meta["roofline"], "collectives": meta["collectives"],
                      "card_collectives": card["collectives"],
                      "meta_s": meta["wall_s"], "card_s": card["wall_s"]}
        log(f"phase 30 {cid}: measured peak {cells[cid]['measured_peak_gb']:.3f} GB beside "
            f"the reckoned {cells[cid]['reckoned_peak_gb']:.3f} GB, step "
            f"{mem['step_ms']:.2f} ms ({card_line()})")
        if meta["memory"]["fits"] and mem["measured_peak_bytes"] > 80e9:
            raise AssertionError(f"phase 30: {cid} fits by its meta record but peaked at "
                                 f"{mem['measured_peak_bytes']} bytes on the card")
    launches = cells["two-tower-retrieval::retrieval_cand"]["launches"].get("distance_matrix", 0)
    if launches < 1:
        raise AssertionError("phase 30: the retrieval cell launched no distance_matrix")
    line["production_cells"] = cells
    line["retrieval_distance_matrix_launches"] = launches
    line["retrieval_dm"] = retrieval_dm_row(-(-1_000_000 // 512) * 512 // 256, 256)
    log("time distance_matrix " + json.dumps(line["retrieval_dm"]))
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.distributed as tdist

    from repro_torch.core.batched_beam import make_step_searcher
    from repro_torch.core.beam_search import make_batched_searcher
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.build_engine import build_sharded, build_swgraph_wave
    from repro_torch.core.distances import get_distance
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.core.nndescent import _sampled_reverse
    from repro_torch.core.spec import RetrievalSpec, load_spec
    from repro_torch.core.swgraph import build_swgraph
    from repro_torch.data.synthetic import lda_like_histograms, split_queries
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.distance_matrix import distance_matrix
    from repro_torch.kernels.frontier_gather import (frontier_scores, two_hop_scores,
                                                     two_hop_work_list)
    from repro_torch.kernels.gather_topk import gather_scores
    from repro_torch.kernels.ref import (distance_matrix_ref, exact_float32_matmul,
                                         gather_scores_ref, two_hop_scores_ref)
    from repro_torch.convert import online_from_jax
    from repro_torch.core.scheduler import SlotScheduler
    from repro_torch.launch.serve import build_and_serve, poisson_arrivals, run_churn

    # the serve scenario with the graph degree doubled (NN 30, M 60) and ef 512:
    # at NN 15 the NN-descent graph holds few of each node's true neighbours
    # at n = 1e6, d = 128, and recall@10 stays below the 0.5 floor (phase 12
    # measures both; PERF.md)
    full_spec = RetrievalSpec(distance="kl", builder="nndescent", NN=30, ef_search=512,
                              frontier=4, wave=64, slots=48, sched_frontier=12,
                              steps_per_sync=4)
    sw_spec = full_spec.replace(builder="swgraph", NN=15, ef_search=96)

    float32_highest()
    t_start = time.perf_counter()
    lap = Laps()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build: one nvcc per source, all started together ---------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.build, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        build.load(name)
    log(f"build {', '.join(KERNEL_SOURCES)}: {time.perf_counter() - t0:.3f} s")
    for name in KERNEL_SOURCES:
        print(build.build_log(name).strip(), flush=True)

    lap("2 build")

    # -- 3. each kernel against its plain version --------------------------------------
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    X_chk = lda_like_histograms(rng, 200_000, D_FULL, device="cuda")
    max_err = {}
    for name in DISTANCES:
        dist = get_distance(name)
        x_rep = dist.prep_left(X_chk).contiguous()
        x_bias = dist.bias_left(X_chk).contiguous()
        for B, R in CHECK_SHAPES:
            Q = X_chk[torch.randint(0, X_chk.shape[0], (B,), generator=gen, device="cuda")]
            q_rep, q_bias = dist.prep_right(Q).contiguous(), dist.bias_right(Q).contiguous()
            ids = random_ids(gen, B, R, X_chk.shape[0])
            got = frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
            want = gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
            max_err[("frontier_scores", name, B, R)] = check_close(
                f"frontier_scores {name} B={B} R={R}", got, want, TOL, pad=ids < 0)
            if B == 64 and not torch.equal(gather_scores(ids, q_rep, q_bias, x_rep, x_bias,
                                                         dist.post_id, dist.c0), got):
                # the search step moved to gather_scores on this equality
                raise AssertionError(f"gather_scores != frontier_scores bit for bit, {name} "
                                     f"B={B} R={R}")
        # into a column range of a wider block, as the NN-descent round writes
        block = torch.full((B, R + 7), -7.0, device="cuda")
        frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0,
                        out=block[:, 7:])
        check_close(f"frontier_scores {name} B={B} R={R} into a column range",
                    block[:, 7:], want, TOL, pad=ids < 0)
        if not bool((block[:, :7] == -7.0).all()):
            raise AssertionError("frontier_scores wrote outside its column range")
        # the NN-descent join, grouped by the middle node: a padded row (its
        # -1 become 0, as in the round) and a hub of ~300 edges at node 17
        n_j, K_j = 4096, 30
        X_j = X_chk[:n_j]
        adj = torch.randint(0, n_j, (n_j, K_j), generator=gen, device="cuda", dtype=torch.int32)
        adj[5, 10:] = -1
        adj[torch.rand((n_j, K_j), generator=gen, device="cuda") < 300 / (n_j * K_j)] = 17
        safe = torch.where(adj >= 0, adj, 0).to(torch.int32).contiguous()
        reps_j = [a.contiguous() for a in (dist.prep_right(X_j), dist.bias_right(X_j),
                                           dist.prep_left(X_j), dist.bias_left(X_j))]
        got = two_hop_scores(safe, *reps_j, dist.post_id, dist.c0)
        want = two_hop_scores_ref(safe, *reps_j, dist.post_id, dist.c0)
        max_err[("two_hop_scores", name, n_j, K_j)] = check_close(
            f"two_hop_scores {name} n={n_j} K={K_j}", got, want, TOL)
    del x_rep, x_bias
    # gather_scores' rows at the narrower and wider widths, drawn once
    gs_data = {m: lda_like_histograms(rng, 20_000 if m <= D_FULL else 4_000, m, device="cuda")
               for m in sorted({m for _, _, m in GS_CHECK_SHAPES} - {D_FULL})}
    for name in DM_DISTANCES:
        dist = get_distance(name)
        for B, N, m in DM_CHECK_SHAPES:
            data = lda_like_histograms(rng, B + N, m, device="cuda")
            Q, X = data[:B], data[B:]
            got = ops.query_distance_matrix(dist, Q, X)
            want = distance_matrix_ref(dist.prep_right(Q), dist.prep_left(X),
                                       dist.bias_right(Q), dist.bias_left(X), dist.post_id,
                                       dist.c0)
            max_err[("distance_matrix", name, B, N, m)] = check_close(
                f"distance_matrix {name} {B}x{N}x{m}", got, want, TOL)
        # right mode: d(Q[b], X[i]), as knn_scan(mode="right") asks
        data = lda_like_histograms(rng, 128 + 4096, 128, device="cuda")
        Q, X = data[:128], data[128:]
        check_close(f"distance_matrix {name} 128x4096x128 right mode",
                    ops.query_distance_matrix(dist, Q, X, mode="right"),
                    distance_matrix_ref(dist.prep_left(Q), dist.prep_right(X),
                                        dist.bias_left(Q), dist.bias_right(X), dist.post_id,
                                        dist.c0), TOL)
        # bf16 reps: float32 out, held to 2e-2 as the JAX kernel is
        data = lda_like_histograms(rng, 128 + 4096, 128, device="cuda")
        Q, X = data[:128], data[128:]
        reps = (dist.prep_right(Q).bfloat16(), dist.prep_left(X).bfloat16(),
                dist.bias_right(Q).float(), dist.bias_left(X).float())
        check_close(f"distance_matrix {name} 128x4096x128 bf16",
                    distance_matrix(*reps, dist.post_id, dist.c0),
                    distance_matrix_ref(*reps, dist.post_id, dist.c0), dict(rtol=2e-2, atol=2e-2))
        # bf16 rows of 72 bytes: staged without TMA
        data = lda_like_histograms(rng, 33 + 300, 36, device="cuda")
        Q, X = data[:33], data[33:]
        reps = (dist.prep_right(Q).bfloat16(), dist.prep_left(X).bfloat16(),
                dist.bias_right(Q).float(), dist.bias_left(X).float())
        check_close(f"distance_matrix {name} 33x300x36 bf16",
                    distance_matrix(*reps, dist.post_id, dist.c0),
                    distance_matrix_ref(*reps, dist.post_id, dist.c0), dict(rtol=2e-2, atol=2e-2))
        x_rep = dist.prep_left(X_chk).contiguous()
        x_bias = dist.bias_left(X_chk).contiguous()
        for B, M, m in GS_CHECK_SHAPES:
            X = X_chk if m == D_FULL else gs_data[m]
            xr, xb = (x_rep, x_bias) if m == D_FULL else (dist.prep_left(X).contiguous(),
                                                         dist.bias_left(X).contiguous())
            Q = X[torch.randint(0, X.shape[0], (B,), generator=gen, device="cuda")]
            q_rep, q_bias = dist.prep_right(Q).contiguous(), dist.bias_right(Q).contiguous()
            ids = random_ids(gen, B, M, xr.shape[0])
            if M > 1:
                ids[B // 2] = -1  # a row of padding only
            got = gather_scores(ids, q_rep, q_bias, xr, xb, dist.post_id, dist.c0)
            want = gather_scores_ref(ids, q_rep, xr, q_bias, xb, dist.post_id, dist.c0)
            max_err[("gather_scores", name, B, M, m)] = check_close(
                f"gather_scores {name} B={B} M={M} m'={m}", got, want, TOL, pad=ids < 0)
        # database rows from a base 4 bytes off a 16-byte word: the scalar loads
        xr_off = torch.empty(x_rep[:20_000].numel() + 1, device="cuda")[1:].view(20_000, D_FULL)
        xr_off.copy_(x_rep[:20_000])
        ids = random_ids(gen, 64, 30, 20_000)
        Q = X_chk[:64]
        q_rep, q_bias = dist.prep_right(Q).contiguous(), dist.bias_right(Q).contiguous()
        max_err[("gather_scores", name, "base off 16 bytes")] = check_close(
            f"gather_scores {name} B=64 M=30 m'={D_FULL}, x_rep base off 16 bytes",
            gather_scores(ids, q_rep, q_bias, xr_off, x_bias[:20_000], dist.post_id, dist.c0),
            gather_scores_ref(ids, q_rep, x_rep[:20_000], q_bias, x_bias[:20_000], dist.post_id,
                              dist.c0), TOL, pad=ids < 0)
        del xr_off
        ids = random_ids(gen, 64, 30, 20_000)
        Q = X_chk[:64]
        got = ops.beam_gather_scores(dist, ids, Q, X_chk[:20_000])
        want = gather_scores_ref(ids, dist.prep_right(Q), dist.prep_left(X_chk[:20_000]),
                                 dist.bias_right(Q), dist.bias_left(X_chk[:20_000]),
                                 dist.post_id, dist.c0)
        check_close(f"ops.beam_gather_scores {name}", got, want, TOL, pad=ids < 0)
    del x_rep, x_bias, gs_data
    wrapper_err = check_wrappers(X_chk, gen, rng)
    del X_chk

    lap("3 check")

    # -- 4. serve defaults (NN-descent) -------------------------------------------------
    small = build_and_serve(n_db=20_000, dim=32, n_queries=256, batch=64, ef_search=96,
                            frontier=4, device="cuda", verbose=False)
    log("serve defaults n=20000 d=32: " + json.dumps(
        {k: v for k, v in small.items() if k != "spec"}))
    if small["recall@k"] < 0.90:
        raise AssertionError(f"recall@10 {small['recall@k']} < 0.90 at the serve defaults")

    lap("4 serve defaults")

    # -- 5. SW-graph at the serve defaults ------------------------------------------------
    ops.reset_launch_counts()
    sw_small = build_and_serve(n_db=20_000, dim=32, n_queries=256, batch=64, ef_search=96,
                               builder="swgraph", wave=64, frontier=4, device="cuda",
                               verbose=False)
    sw_launches = ops.launch_counts()
    log("swgraph serve defaults n=20000 d=32: " + json.dumps(
        {k: v for k, v in sw_small.items() if k != "spec"}))
    log(f"swgraph path launches: {sw_launches}")
    built_k = sw_small["kernel_launches"]["build"]
    if not (built_k["gather_scores"] > 0
            and sw_small["kernel_launches"]["search"]["gather_scores"] > 0):
        raise AssertionError(f"kernels not launched on the SW-graph path: {sw_launches}")
    if sw_small["recall@k"] < 0.98:
        raise AssertionError(f"SW-graph recall@10 {sw_small['recall@k']} < 0.98 at the "
                             f"serve defaults")

    lap("5 swgraph serve defaults")

    # -- 6. SW-graph at d = 128 -------------------------------------------------------------
    sw128 = build_and_serve(n_db=20_000, dim=D_FULL, n_queries=256, batch=64, ef_search=96,
                            builder="swgraph", wave=64, frontier=4, device="cuda",
                            verbose=False)
    waves_20k = -(-(20_000 - 1) // 64)
    per_wave_s = sw128["build_s"] / waves_20k
    log("swgraph n=20000 d=128: " + json.dumps(
        {k: v for k, v in sw128.items() if k != "spec"}))
    log(f"swgraph d=128 build: {per_wave_s * 1e3:.3f} ms per wave of 64 ({waves_20k} waves)")
    if sw128["recall@k"] < 0.70:
        raise AssertionError(f"SW-graph recall@10 {sw128['recall@k']} < 0.70 at n=20000, d=128")
    # later waves search a larger prefix: allow 1.25x the measured per-wave time
    n_sw = next((n for n in SWGRAPH_NS
                 if 1.25 * per_wave_s * (n - 1) / 64 <= SWGRAPH_BUILD_BUDGET_S), None)
    if n_sw is None:
        raise AssertionError(f"no SW-graph size fits {SWGRAPH_BUILD_BUDGET_S} s at "
                             f"{per_wave_s:.3f} s per wave")
    log(f"swgraph large-n cut: n={n_sw} (predicted build "
        f"{1.25 * per_wave_s * (n_sw - 1) / 64:.1f} s; budget {SWGRAPH_BUILD_BUDGET_S} s)")
    rng = np.random.default_rng(1)
    data = lda_like_histograms(rng, n_sw + 512, D_FULL, device="cuda")
    Q_sw, rest = split_queries(data, 512, rng)
    X_sw = rest[:n_sw]
    del data, rest
    kl = get_distance("kl")
    _, true_sw = knn_scan(kl, Q_sw, X_sw, 10)
    for spec in (sw_spec, full_spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = ANNIndex.build(X_sw, spec=spec,
                             generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        line = {"builder": spec.builder, "NN": spec.NN, "n": n_sw, "d": D_FULL,
                "build_s": time.perf_counter() - t0}
        if spec.builder == "swgraph":
            line["ms_per_wave"] = 1e3 * line["build_s"] / (-(-(n_sw - 1) // 64))
        for ef in (96, 512):
            found = torch.cat([idx.searcher(ef_search=ef)(Q_sw[lo:lo + BATCH])[1]
                               for lo in range(0, 512, BATCH)])
            line[f"recall@10_ef{ef}"] = recall_at_k(found, true_sw)
        log("builder at large n: " + json.dumps(line))
        del idx
    del X_sw, Q_sw

    lap("6 swgraph d=128")

    # -- 7. sequential builder and reference engine ------------------------------------------
    rng = np.random.default_rng(2)
    data = lda_like_histograms(rng, SEQ_N + 64, 16, device="cuda")
    X_seq, Q_seq = data[:SEQ_N], data[SEQ_N:]
    t0 = time.perf_counter()
    adj_seq, _ = build_swgraph(kl, X_seq, NN=8, ef_construction=40)
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj_w1, _ = build_swgraph_wave(kl, X_seq, NN=8, ef_construction=40, wave=1)
    torch.cuda.synchronize()
    t_w1 = time.perf_counter() - t0
    same = float((adj_seq == adj_w1).float().mean())
    log(f"sequential vs W=1 n={SEQ_N} d=16: {t_seq:.3f} s vs {t_w1:.3f} s, "
        f"equal entries {same:.6f}")
    if not torch.equal(adj_seq, adj_w1):
        raise AssertionError("W=1 wave build differs from the sequential build on the card")
    ref = make_batched_searcher(kl, adj_seq, X_seq, 48, 10, entry=0)(Q_seq)
    bat = make_step_searcher(kl, adj_seq, X_seq, 48, 10,
                             entries=torch.zeros((1,), dtype=torch.int32, device="cuda"),
                             frontier=1)(Q_seq)
    log("reference vs batched (frontier 1, entry 0): ids equal "
        f"{float((ref[1] == bat[1]).float().mean()):.6f}, n_evals equal "
        f"{float((ref[2] == bat[2]).float().mean()):.6f}, hops equal "
        f"{float((ref[3] == bat[3]).float().mean()):.6f}")
    for label, a, b in zip(("ids", "n_evals", "hops"), ref[1:], bat[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"reference and batched engines differ in {label}")

    lap("7 sequential and reference")

    # -- 8. build_sharded in a one-rank NCCL group ---------------------------------------------
    rng = np.random.default_rng(0)  # the serve-default data
    data = lda_like_histograms(rng, 20_000 + 256, 32, device="cuda")
    _, rest = split_queries(data, 256, rng)
    X_sh = rest[:SHARDED_BUILD_N]
    torch.cuda.set_device(0)
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                             world_size=1)
    try:
        ops.reset_launch_counts()
        stitched = build_sharded(kl, X_sh, NN=15, builder="wave", wave=64, cross_links=4,
                                 sample_per_shard=64,
                                 generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        sharded_launches = ops.launch_counts()
    finally:
        tdist.destroy_process_group()
    log(f"build_sharded world 1 n={SHARDED_BUILD_N} d=32: shape {tuple(stitched.shape)}, "
        f"launches {sharded_launches}")
    if sharded_launches["distance_matrix"] < 1:
        raise AssertionError("build_sharded did not launch distance_matrix")
    if not bool((stitched[:, -4:] == -1).all()):
        raise AssertionError("a one-shard build made a cross link")
    local, _ = build_swgraph_wave(kl, X_sh, NN=15, wave=64)
    if not torch.equal(stitched[:, :-4], local):
        raise AssertionError("build_sharded's local part differs from build_swgraph_wave")
    del data, rest

    lap("8 build_sharded")

    # -- 9. the NN-descent main path at full size --------------------------------------------
    ops.reset_launch_counts()
    full = build_and_serve(spec=full_spec, n_db=N_FULL, dim=D_FULL, n_queries=Q_FULL,
                           batch=BATCH, alpha=0.08, device="cuda", verbose=False)
    main_launches = ops.launch_counts()
    log("main path n=1000000 d=128: " + json.dumps(
        {k: v for k, v in full.items() if k != "spec"}))
    log(f"main path launches: {main_launches} (build {full['kernel_launches']['build']}, "
        f"timed search {full['kernel_launches']['search']}, the rest warm-up search and the "
        f"knn_scan ground truth)")
    built_k, searched_k = full["kernel_launches"]["build"], full["kernel_launches"]["search"]
    if not (built_k["two_hop_scores"] > 0 and built_k["frontier_scores"] > 0
            and searched_k["gather_scores"] > 0 and main_launches["distance_matrix"] > 0):
        raise AssertionError(f"kernel not launched on the main path: {main_launches}")
    if not full["recall@k"] > 0.5:
        raise AssertionError(f"recall@10 {full['recall@k']} <= 0.5 at n=1e6")

    lap("9 main path")

    # -- 10. timing at the paths' shapes ----------------------------------------------------
    rng = np.random.default_rng(0)  # the data build_and_serve drew for the same seed
    data = lda_like_histograms(rng, N_FULL + Q_FULL, D_FULL, device="cuda")
    Q, rest = split_queries(data, Q_FULL, rng)
    X = rest[:N_FULL]
    del data, rest
    dist = kl
    x_rep, x_bias = dist.prep_left(X).contiguous(), dist.bias_left(X).contiguous()
    qa_rep, qa_bias = dist.prep_right(X).contiguous(), dist.bias_right(X).contiguous()

    def kernel(ids, q_rep, q_bias):
        return frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)

    def gs(ids, q_rep, q_bias):
        return gather_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)

    def plain(ids, q_rep, q_bias):
        return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)

    def ids_pass(ids, q_rep, q_bias):
        # one PyTorch elementwise kernel that reads the ids and writes a block
        # of their size: the launch and the ids' latency that any gather pays
        return ids.neg()

    fs_rows, gs_steps = [], []
    for label, B, R in TIME_SHAPES:
        step = B < N_FULL  # a search step (gather_scores) or an NN-descent round
        fn, names = (gs, GS_KERNELS) if step else (kernel, "frontier_scores_kernel")
        q_rep, q_bias = (qa_rep[:B], qa_bias[:B]) if B == N_FULL else (
            dist.prep_right(Q[:B]).contiguous(), dist.bias_right(Q[:B]).contiguous())
        # search steps cycle through 32 id sets, so a step does not find the
        # previous step's rows in L2; an NN-descent round is 1 GB+ of ids
        sets = 32 if step else 1
        args = [(random_ids(gen, B, R, N_FULL), q_rep, q_bias) for _ in range(sets)]
        reps = 320 if step else 5
        b_ms, b_by, g_ms = bound(args[0][0], D_FULL)
        row = {"shape": label, "kernel": "gather_scores" if step else "frontier_scores",
               "B": B, "R": R, "m": D_FULL,
               "ms": device_ms(fn, args, reps, names),
               "ms_again": device_ms(fn, args, reps, names),
               "event_ms": time_ms(fn, args, reps),
               "bound_ms": b_ms, "bound_by": b_by, "gathered_rows_ms": g_ms}
        # the plain version materialises (B, R, m'): rows beyond 4096 would not fit
        rows = min(B, 4096)
        sub = [(a[0][:rows].contiguous(), a[1][:rows].contiguous(), a[2][:rows].contiguous())
               for a in args]
        row["plain_rows"] = rows
        row["plain_ms"] = device_ms(plain, sub, 64 if step else 5)
        row["plain_event_ms"] = time_ms(plain, sub, 64 if step else 5)
        if rows < B:
            row["kernel_ms_same_rows"] = device_ms(fn, sub, 20, names)
        if step:
            row["ids_pass_ms"] = device_ms(ids_pass, args, reps)
        (gs_steps if step else fs_rows).append(row)
        log(f"time {label}: " + json.dumps(row))
        del args, sub

    # gather_scores at its other shapes: the wave build's reverse edges, 960
    # (owner, candidate) cells, at the serve data's m' = 32 and at the d = 128
    # SW-graph cell (ids over the n of phase 6's large-n cut); wide rows
    # (64, 30, 2100), which run the chunked loop; and reverse edges at wide
    # rows (960, 1, 2100), one cell per warp looping over words
    def gs_time(label, xr, xb, args, reps, check=False):
        def gs_x(ids, q_rep, q_bias):
            return gather_scores(ids, q_rep, q_bias, xr, xb, dist.post_id, dist.c0)

        def gs_plain(ids, q_rep, q_bias):
            return gather_scores_ref(ids, q_rep, xr, q_bias, xb, dist.post_id, dist.c0)

        if check:
            max_err[("gather_scores", dist.name, label)] = check_close(
                f"gather_scores {label}", gs_x(*args[0]), gs_plain(*args[0]), TOL,
                pad=args[0][0] < 0)
        B, M = args[0][0].shape
        b_ms, b_by, _ = bound(args[0][0], xr.shape[1])
        row = {"shape": label, "B": B, "R": M, "m": xr.shape[1],
               "ms": device_ms(gs_x, args, reps, GS_KERNELS),
               "ms_again": device_ms(gs_x, args, reps, GS_KERNELS),
               "event_ms": time_ms(gs_x, args, reps), "bound_ms": b_ms, "bound_by": b_by,
               "plain_ms": device_ms(gs_plain, args, 64),
               "plain_event_ms": time_ms(gs_plain, args, 64),
               "ids_pass_ms": device_ms(ids_pass, args, reps)}
        log("time gather_scores " + json.dumps(row))
        return row

    def rev_args(qr, qb, n_rows, sets=32):
        out = []
        for _ in range(sets):
            owners = torch.randint(0, n_rows, (960,), generator=gen, device="cuda")
            out.append((random_ids(gen, 960, 1, n_rows, pad=0.0), qr[owners].contiguous(),
                        qb[owners].contiguous()))
        return out

    X32 = X_sh
    xr32, xb32 = dist.prep_left(X32).contiguous(), dist.bias_left(X32).contiguous()
    args32 = rev_args(dist.prep_right(X32).contiguous(), dist.bias_right(X32).contiguous(),
                      X32.shape[0])
    gs_rev32 = gs_time("wave-build reverse edges B=960 M=1 m'=32", xr32, xb32, args32, 320)
    args128 = rev_args(qa_rep, qa_bias, n_sw)
    gs_rev128 = gs_time(f"reverse edges at the d=128 SW-graph cell B=960 M=1 m'=128 "
                        f"(ids over n={n_sw})", x_rep[:n_sw], x_bias[:n_sw], args128, 320)
    Xw = lda_like_histograms(np.random.default_rng(4), 20_000, 2100, device="cuda")
    xrw, xbw = dist.prep_left(Xw).contiguous(), dist.bias_left(Xw).contiguous()
    qrw, qbw = dist.prep_right(Xw).contiguous(), dist.bias_right(Xw).contiguous()
    argsw = [(random_ids(gen, 64, 30, 20_000), qrw[:64], qbw[:64]) for _ in range(8)]
    gs_wide = gs_time("wide rows B=64 M=30 m'=2100", xrw, xbw, argsw, 64)
    argsw1 = rev_args(qrw, qbw, 20_000, sets=8)
    gs_rev_wide = gs_time("reverse edges at wide rows B=960 M=1 m'=2100", xrw, xbw, argsw1, 64)
    del Xw, xrw, qrw, argsw, argsw1, args32, args128
    # the online index at phase 16's cell (ids over n = 1e6): an insert or
    # repair wave's search step, 32 queries x frontier 4 x M 60, and a repair
    # wave's reverse edges, 32 x NN 30 (owner, candidate) cells
    args_wave = []
    for _ in range(32):
        rows = torch.randint(0, N_FULL, (32,), generator=gen, device="cuda")
        args_wave.append((random_ids(gen, 32, 4 * 2 * full_spec.NN, N_FULL),
                          qa_rep[rows].contiguous(), qa_bias[rows].contiguous()))
    gs_online = [
        gs_time(f"online wave search step B=32 R={4 * 2 * full_spec.NN} m'=128 (ids over n=1e6)",
                x_rep, x_bias, args_wave, 320),
        gs_time("online repair-wave reverse edges B=960 M=1 m'=128 (ids over n=1e6)",
                x_rep, x_bias, rev_args(qa_rep, qa_bias, N_FULL), 320)]
    del args_wave
    # the slot scheduler: a tick's lock-step over 48 slots at frontier 12, at
    # phase 18's cell (M = 60, ids over n = 1e6) and at the serve defaults
    # (M = 30, the serve data at m' = 32); the retire-time rerank of one
    # request, B = 1 over k_c = 512 candidates (phase 13's rerank width)
    def sched_args(qr, qb, R, n_rows, B=SCHED_SLOTS, sets=32):
        out = []
        for _ in range(sets):
            rows = torch.randint(0, n_rows, (B,), generator=gen, device="cuda")
            out.append((random_ids(gen, B, R, n_rows), qr[rows].contiguous(),
                        qb[rows].contiguous()))
        return out

    R_full, R_serve = SCHED_FRONTIER * 2 * full_spec.NN, SCHED_FRONTIER * 2 * 15
    gs_sched = [
        gs_time(f"scheduler step S={SCHED_SLOTS} R={R_full} m'=128 (ids over n=1e6)", x_rep,
                x_bias, sched_args(qa_rep, qa_bias, R_full, N_FULL), 320, check=True),
        gs_time(f"scheduler step at the serve defaults S={SCHED_SLOTS} R={R_serve} m'=32",
                xr32, xb32, sched_args(dist.prep_right(X32).contiguous(),
                                       dist.bias_right(X32).contiguous(), R_serve,
                                       X32.shape[0]), 320, check=True),
        gs_time("scheduler rerank B=1 k_c=512 m'=128 (ids over n=1e6)", x_rep, x_bias,
                sched_args(qa_rep, qa_bias, 512, N_FULL, B=1), 320, check=True)]

    # the NN-descent round on its real candidate block: the forward adjacency
    # of the phase 9 build (rebuilt from the same data and seed), with the
    # round's reverse and random columns drawn as build_nndescent draws them
    idx_full = ANNIndex.build(X, spec=full_spec,
                              generator=torch.Generator(device="cuda").manual_seed(0))
    K_nn, n_rnd = full_spec.NN, 8
    adj = idx_full.neighbors[:, :K_nn].contiguous()
    nbrs_full = idx_full.neighbors
    del idx_full
    safe = torch.where(adj >= 0, adj, 0).to(torch.int32).contiguous()
    KK = K_nn * K_nn
    width = KK + K_nn + n_rnd
    cand = torch.empty((N_FULL, width), dtype=torch.int32, device="cuda")
    cand[:, :KK] = safe[safe.reshape(-1).long()].reshape(N_FULL, KK)
    cand[:, KK:KK + K_nn] = _sampled_reverse(adj, K_nn, torch.randint(
        0, K_nn, (K_nn,), generator=gen, device="cuda", dtype=torch.int32))
    cand[:, KK + K_nn:] = torch.randint(0, N_FULL, (N_FULL, n_rnd), generator=gen,
                                        device="cuda", dtype=torch.int32)
    iota = torch.arange(N_FULL, device="cuda", dtype=torch.int32)
    cand.masked_fill_(cand == iota[:, None], -1)
    indeg = torch.bincount(safe.reshape(-1).long(), minlength=N_FULL).float()
    out_general = torch.empty((N_FULL, width), dtype=torch.float32, device="cuda")
    out_grouped = torch.empty_like(out_general)
    reps_all = (qa_rep, qa_bias, x_rep, x_bias)

    def round_general():
        frontier_scores(cand, *reps_all, dist.post_id, dist.c0, out=out_general)

    def round_grouped():
        ops.nndescent_round_scores(dist, safe, cand[:, KK:], *reps_all, out=out_grouped)

    # in turns: general, grouped, grouped, general
    fs_k, join_k = "frontier_scores_kernel", "two_hop_kernel"
    rt = {"general_ms": device_ms(round_general, [()], 3, fs_k),
          "grouped_ms": device_ms(round_grouped, [()], 3, join_k)}
    rt["grouped_ms_again"] = device_ms(round_grouped, [()], 3, join_k)
    rt["general_ms_again"] = device_ms(round_general, [()], 3, fs_k)
    rt["general_event_ms"] = time_ms(round_general, [()], 3)
    rt["grouped_event_ms"] = time_ms(round_grouped, [()], 3)
    round_general()
    round_grouped()
    check_close("NN-descent round, real block: grouped join + general vs general",
                out_grouped, out_general, TOL, pad=cand < 0)
    # the join's columns against the plain version: the first rows, and every
    # edge of the largest hub (its work items at the real skew)
    plain_rows = 2048  # the plain join materialises (rows, K*K, m')
    sub = cand[:plain_rows, :KK].contiguous()

    def join_plain():
        return gather_scores_ref(sub, qa_rep[:plain_rows], x_rep, qa_bias[:plain_rows], x_bias,
                                 dist.post_id, dist.c0)

    max_err[("two_hop_scores", dist.name, "real block rows")] = check_close(
        f"two_hop_scores real block, rows 0-{plain_rows - 1} vs plain",
        out_grouped[:plain_rows, :KK], join_plain(), TOL)
    hub = int(torch.argmax(indeg))
    hub_edges = torch.nonzero(safe.reshape(-1) == hub).squeeze(1)
    hub_i = hub_edges // K_nn
    hub_cols = (hub_edges % K_nn)[:, None] * K_nn + torch.arange(K_nn, device="cuda")[None, :]
    max_err[("two_hop_scores", dist.name, "real block hub")] = check_close(
        f"two_hop_scores real block, the {hub_edges.numel()} edges of hub {hub} vs plain",
        out_grouped[hub_i[:, None], hub_cols],
        gather_scores_ref(cand[hub_i[:, None], hub_cols].contiguous(), qa_rep[hub_i], x_rep,
                          qa_bias[hub_i], x_bias, dist.post_id, dist.c0), TOL)
    join_out = out_grouped[:, :KK]
    # one two_hop_scores call: the join kernel, and the work list's kernels
    rt["join_kernel_ms"], rt["work_list_ms"] = device_ms_of(lambda: two_hop_scores(
        safe, qa_rep, qa_bias, x_rep, x_bias, dist.post_id, dist.c0, out=join_out), 5,
        "two_hop_kernel")
    rt["rest_general_ms"] = device_ms(lambda: frontier_scores(
        cand[:, KK:], *reps_all, dist.post_id, dist.c0, out=out_grouped[:, KK:]), [()], 5, fs_k)
    join_lines = two_hop_bound(safe, D_FULL)
    rt["join_bound_ms"], rt["join_bound_by"] = join_lines["tensor_core"]
    rt["join_bound_fp32_simt_ms"], rt["join_bound_fp32_simt_by"] = join_lines["fp32_simt"]
    rt["general_bound_ms"], rt["general_bound_by"], rt["general_gathered_rows_ms"] = bound(
        cand, D_FULL)
    rt["join_plain_rows"] = plain_rows
    rt["join_plain_ms"] = device_ms(join_plain, [()], 5)
    rt.update({"n": N_FULL, "K": K_nn, "R": width,
               "work_items": int(two_hop_work_list(safe)[1].shape[0]),
               "hub": hub, "hub_edges": int(hub_edges.numel()),
               "in_degree_mean": float(indeg.mean()), "in_degree_max": float(indeg.max()),
               "in_degree_p99": float(torch.quantile(indeg, 0.99))})
    log("time NN-descent round, real candidate block: " + json.dumps(rt))
    del cand, out_general, out_grouped, join_out, sub, hub_edges, hub_i, hub_cols
    # from_graph's edge distances at phase 16's capacity: gather_scores with
    # ids = the (capacity, M) adjacency, every row its own query
    pad_rows = CHURN_ROUNDS_FULL * CHURN_INSERT_FULL
    M_full = nbrs_full.shape[1]
    adj_cap = torch.cat([nbrs_full, torch.full((pad_rows, M_full), -1, dtype=torch.int32,
                                                        device="cuda")]).contiguous()
    qe_rep = torch.cat([qa_rep, torch.zeros((pad_rows, D_FULL), device="cuda")]).contiguous()
    qe_bias = torch.cat([qa_bias, torch.zeros((pad_rows,), device="cuda")]).contiguous()
    e_ms, e_by, e_g = bound(adj_cap, D_FULL)
    edge_rows = 4096  # the plain version materialises (rows, M, m')
    edge_sub = [(adj_cap[:edge_rows].contiguous(), qe_rep[:edge_rows], qe_bias[:edge_rows])]
    gs_edge = {"shape": f"from_graph edge distances B={N_FULL + pad_rows} M={M_full} m'=128 "
                        f"(the real adjacency)",
               "B": N_FULL + pad_rows, "R": M_full, "m": D_FULL,
               "ms": device_ms(gs, [(adj_cap, qe_rep, qe_bias)], 5, GS_KERNELS),
               "ms_again": device_ms(gs, [(adj_cap, qe_rep, qe_bias)], 5, GS_KERNELS),
               "event_ms": time_ms(gs, [(adj_cap, qe_rep, qe_bias)], 5),
               "bound_ms": e_ms, "bound_by": e_by, "gathered_rows_ms": e_g,
               "plain_rows": edge_rows, "plain_ms": device_ms(plain, edge_sub, 5),
               "kernel_ms_same_rows": device_ms(gs, edge_sub, 20, GS_KERNELS)}
    check_close("gather_scores from_graph edge distances, rows 0-4095 vs plain",
                gs(*edge_sub[0]), plain(*edge_sub[0]), TOL, pad=edge_sub[0][0] < 0)
    log("time gather_scores " + json.dumps(gs_edge))
    del adj_cap, qe_rep, qe_bias, edge_sub, nbrs_full

    # distance_matrix: a knn_scan chunk (the main path's ground truth),
    # build_sharded's stitch, 512 rows, a knn_scan chunk at d = 30, whose
    # 120-byte rows the producer warp stages without TMA, and a chunk of
    # true_neighbor_ids (phase 22: 512 anchors of the full cell against
    # 4,096 rows); each held to the plain version
    dm_rows = []
    stitch = (X_sh.shape[0], 64, 32)
    data30 = lda_like_histograms(np.random.default_rng(3), 1024 + 8192, 30, device="cuda")
    for label, (B, N, m), src_q, src_x in [
            ("knn_scan chunk", (1024, 8192, D_FULL), Q, X[:8192]),
            ("build_sharded stitch", stitch, X_sh, X_sh[:64]),
            ("bench_kernels", (512, 8192, D_FULL), Q[:512], X[8192:16384]),
            ("knn_scan chunk, rows staged without TMA", (1024, 8192, 30), data30[:1024],
             data30[1024:]),
            ("true_neighbor_ids chunk", (512, 4096, D_FULL), X[:512], X[16384:20480])]:
        q_rep, x_rep_t = dist.prep_right(src_q).contiguous(), dist.prep_left(src_x).contiguous()
        q_b, x_b = dist.bias_right(src_q).contiguous(), dist.bias_left(src_x).contiguous()
        args = [(q_rep, x_rep_t, q_b, x_b)]
        dm = lambda a, b, c, d: distance_matrix(a, b, c, d, dist.post_id, dist.c0)  # noqa: E731
        dm_plain = lambda a, b, c, d: distance_matrix_ref(  # noqa: E731
            a, b, c, d, dist.post_id, dist.c0)

        def library(a, b, c, d):
            with exact_float32_matmul():
                return torch.matmul(a, b.T)

        max_err[("distance_matrix", dist.name, label)] = check_close(
            f"distance_matrix {label} {B}x{N}x{m}", dm(*args[0]), dm_plain(*args[0]), TOL)
        lines = dm_bound(B, N, m)
        (b_ms, b_by), (s_ms, s_by) = lines["tensor_core"], lines["fp32_simt"]
        row = {"shape": f"{label} {B}x{N}x{m}", "B": B, "N": N, "m": m,
               "ms": device_ms(dm, args, 50, "distance_matrix_kernel"),
               "ms_again": device_ms(dm, args, 50, "distance_matrix_kernel"),
               "event_ms": time_ms(dm, args, 50), "bound_ms": b_ms, "bound_by": b_by,
               "bound_fp32_simt_ms": s_ms, "bound_fp32_simt_by": s_by,
               "plain_ms": device_ms(dm_plain, args, 50),
               "plain_event_ms": time_ms(dm_plain, args, 50),
               "library_ms": device_ms(library, args, 50),
               "library_event_ms": time_ms(library, args, 50)}
        dm_rows.append(row)
        log("time distance_matrix " + json.dumps(row))

    # the sharded paths' shapes (phases 19, 20): a sharded tick's lock-step at
    # the serve defaults (32 slots x frontier 1 x M 30, ids over a 5,000-row
    # shard, m' = 32) and at full width (48 slots x frontier 12 x M 60 over a
    # 250,000-row shard); the local NN-descent round of one of 4 shards at
    # full width (random ids over its rows); one shard's scan at the serve
    # defaults (256 queries x 5,000 rows, m' = 32)
    n_shard = N_FULL // SHARDS
    gs_shard = [
        gs_time("sharded tick step at the serve defaults S=32 R=30 m'=32 (ids over a "
                "5,000-row shard)", xr32[:5000], xb32[:5000],
                sched_args(dist.prep_right(X32).contiguous(), dist.bias_right(X32).contiguous(),
                           30, 5000, B=32), 320, check=True),
        gs_time(f"sharded tick step at full width S={SCHED_SLOTS} R={R_full} m'=128 (ids over a "
                f"{n_shard}-row shard)", x_rep[:n_shard], x_bias[:n_shard],
                sched_args(qa_rep, qa_bias, R_full, n_shard), 320, check=True)]
    R_round = TIME_SHAPES[1][2]
    args = [(random_ids(gen, n_shard, R_round, n_shard), qa_rep[:n_shard], qa_bias[:n_shard])]

    def shard_round(ids, q_rep, q_bias):
        return frontier_scores(ids, q_rep, q_bias, x_rep[:n_shard], x_bias[:n_shard],
                               dist.post_id, dist.c0)

    def shard_round_plain(ids, q_rep, q_bias):
        return gather_scores_ref(ids, q_rep, x_rep[:n_shard], q_bias, x_bias[:n_shard],
                                 dist.post_id, dist.c0)

    sub = [tuple(a[:4096].contiguous() for a in args[0])]
    max_err[("frontier_scores", dist.name, "shard round")] = check_close(
        "frontier_scores sharded NN-descent round, rows 0-4095 vs plain", shard_round(*sub[0]),
        shard_round_plain(*sub[0]), TOL, pad=sub[0][0] < 0)
    b_ms, b_by, g_ms = bound(args[0][0], D_FULL)
    fs_shard = {"shape": f"sharded NN-descent round B={n_shard} R={R_round} (NN 30, one of "
                         f"{SHARDS} shards)", "kernel": "frontier_scores",
                "B": n_shard, "R": R_round, "m": D_FULL,
                "ms": device_ms(shard_round, args, 5, "frontier_scores_kernel"),
                "ms_again": device_ms(shard_round, args, 5, "frontier_scores_kernel"),
                "event_ms": time_ms(shard_round, args, 5), "bound_ms": b_ms, "bound_by": b_by,
                "gathered_rows_ms": g_ms, "plain_rows": 4096,
                "plain_ms": device_ms(shard_round_plain, sub, 5),
                "kernel_ms_same_rows": device_ms(shard_round, sub, 20, "frontier_scores_kernel")}
    log("time " + json.dumps(fs_shard))
    del args, sub
    q_rep, x_rep_t = dist.prep_right(X32[5000:5256]).contiguous(), xr32[:5000]
    q_b, x_b = dist.bias_right(X32[5000:5256]).contiguous(), xb32[:5000]
    args = [(q_rep, x_rep_t, q_b, x_b)]
    (b_ms, b_by), (s_ms, s_by) = dm_bound(256, 5000, 32)["tensor_core"], dm_bound(
        256, 5000, 32)["fp32_simt"]
    dm_shard = {"shape": "sharded_knn_scan, one shard at the serve defaults 256x5000x32",
                "B": 256, "N": 5000, "m": 32,
                "ms": device_ms(dm, args, 50, "distance_matrix_kernel"),
                "ms_again": device_ms(dm, args, 50, "distance_matrix_kernel"),
                "event_ms": time_ms(dm, args, 50), "bound_ms": b_ms, "bound_by": b_by,
                "bound_fp32_simt_ms": s_ms, "bound_fp32_simt_by": s_by,
                "plain_ms": device_ms(dm_plain, args, 50), "library_ms": device_ms(library, args, 50)}
    max_err[("distance_matrix", dist.name, "shard scan")] = check_close(
        "distance_matrix sharded scan at the serve defaults", dm(*args[0]), dm_plain(*args[0]), TOL)
    log("time distance_matrix " + json.dumps(dm_shard))
    del args
    # the tuning and learning paths' gather_scores sites (phases 21-23)
    gs_m15 = m15_sites(X32, gen, max_err)

    lap("10 timing")

    # -- 11. profiles ---------------------------------------------------------------------------
    built = {}
    profile_device(lambda: built.setdefault("idx", ANNIndex.build(
        X, spec=full_spec, generator=torch.Generator(device="cuda").manual_seed(0))),
        "NN-descent build n=1e6")
    search = built["idx"].searcher()
    search(Q[:BATCH])
    out = {}
    profile_device(lambda: out.setdefault("r", search(Q[BATCH:2 * BATCH])), "search batch of 64")
    d, ids, n_evals, hops = out["r"]
    if not (d.shape == ids.shape == (BATCH, full_spec.k) and bool(torch.isfinite(d).all())
            and bool((ids >= 0).all())):
        raise AssertionError("search results are not finite (64, k) beams")
    log(f"profiled batch: {int(hops.max())} lock-steps, {float(n_evals.float().mean()):.1f} "
        f"evals per query")
    # one SW-graph wave build: PROFILED_WAVES waves of 64 at d = 128
    profile_device(lambda: build_swgraph_wave(kl, X[:1 + PROFILED_WAVES * 64], NN=15, wave=64),
                   f"SW-graph wave build n={1 + PROFILED_WAVES * 64} d=128 ({PROFILED_WAVES} "
                   f"waves of 64)")

    lap("11 profiles")

    # -- 12. graph quality: why the full-size cell doubles NN ----------------------------
    Xg = X[:GRAPH_QUALITY_N]
    probe = torch.arange(0, GRAPH_QUALITY_N, GRAPH_QUALITY_N // 512, device="cuda")[:512]
    _, true_q = knn_scan(dist, Q[:512], Xg, 10)
    for nn in (15, full_spec.NN):
        spec = full_spec.replace(NN=nn)
        if nn == full_spec.NN and GRAPH_QUALITY_N == N_FULL:
            idx = built["idx"]
        else:
            idx = ANNIndex.build(Xg, spec=spec,
                                 generator=torch.Generator(device="cuda").manual_seed(0))
        _, true_nb = knn_scan(dist, Xg[probe], Xg, nn + 1)
        hits = 0
        for p, t, g in zip(probe.tolist(), true_nb.tolist(), idx.neighbors[probe, :nn].tolist()):
            hits += len(set([v for v in t if v != p][:nn]) & set(g))
        line = {"n": GRAPH_QUALITY_N, "NN": nn, "nnd_iters": spec.nnd_iters,
                "graph_recall@NN": hits / (nn * 512)}
        for ef in (96, 512):
            _, found, evals, _ = idx.searcher(ef_search=ef)(Q[:512])
            line[f"recall@10_ef{ef}"] = recall_at_k(found, true_q)
            line[f"evals_ef{ef}"] = float(evals.float().mean())
        log("graph quality d=128: " + json.dumps(line))

    lap("12 graph quality")

    # -- 13. the policies at full width: phase 9's cell under min, and min/min + rerank -----
    base_built = full["kernel_launches"]["build"]
    n_batches = Q_FULL // BATCH
    policy_full = {}
    spec_a = full_spec.replace(build_policy="min")
    spec_b = full_spec.replace(build_policy="min", search_policy="min", k_c=512)
    cells = {"a": ("min build, KL search", spec_a),
             "b": ("min build, min search, k_c 512 reranked under KL", spec_b)}
    for key, (label, spec) in cells.items():
        ops.reset_launch_counts()
        st = build_and_serve(spec=spec, n_db=N_FULL, dim=D_FULL, n_queries=Q_FULL, batch=BATCH,
                             alpha=0.08, device="cuda", verbose=False)
        built_k, searched_k = st["kernel_launches"]["build"], st["kernel_launches"]["search"]
        row = {k: st[k] for k in ("recall@k", "build_s", "qps", "p50_batch_ms", "p99_batch_ms",
                                  "eval_reduction", "index_sym_resolved", "query_sym_resolved")}
        row.update(cell=label, phase9_recall=full["recall@k"], phase9_build_s=full["build_s"],
                   phase9_qps=full["qps"], build_launches=built_k, search_launches=searched_k,
                   all_launches=ops.launch_counts())
        policy_full[key] = row
        log(f"policy at full width, {label}: " + json.dumps(row))
        for kname in ("two_hop_scores", "frontier_scores"):
            if built_k[kname] != 2 * base_built[kname]:
                raise AssertionError(f"{label}: the build launched {kname} {built_k[kname]} "
                                     f"times, not twice phase 9's {base_built[kname]}")
        if spec.needs_rerank:
            extra = searched_k["gather_scores"] - n_batches  # one rerank launch per batch
            if extra <= 0 or extra % 2:
                raise AssertionError(f"{label}: {searched_k['gather_scores']} gather_scores "
                                     f"launches over {n_batches} batches are not two per "
                                     f"lock-step plus one per batch")
        elif searched_k["gather_scores"] <= 0:
            raise AssertionError(f"{label}: the search launched no gather_scores")
        if not st["recall@k"] > 0.5:
            raise AssertionError(f"{label}: recall@10 {st['recall@k']} <= 0.5 at n=1e6")
    # the min build profiled, then both searches over one graph each, batch by
    # batch in turns (a, b, b, a, ...): the host's share moves more between
    # batches of one run than between the two paths
    built = {}
    profile_device(lambda: built.setdefault("b", ANNIndex.build(
        X, spec=spec_b, generator=torch.Generator(device="cuda").manual_seed(0))),
        "NN-descent build n=1e6 under min")
    built["a"] = ANNIndex.build(X, spec=spec_a,
                                generator=torch.Generator(device="cuda").manual_seed(0))
    searches = {key: idx.searcher() for key, idx in built.items()}
    # one batch of (b), counted exactly: per branch one seed launch and one per
    # lock-step (the last finds every query done), then one rerank launch
    ops.reset_launch_counts()
    _, _, _, hops_b = searches["b"](Q[:BATCH])
    torch.cuda.synchronize()
    want_b = 2 * (int(hops_b.max()) + 2) + 1
    log(f"rerank batch: {ops.launch_counts()['gather_scores']} gather_scores launches, "
        f"{int(hops_b.max())} hops at most, expected {want_b}")
    if ops.launch_counts()["gather_scores"] != want_b:
        raise AssertionError(f"rerank batch launched gather_scores "
                             f"{ops.launch_counts()['gather_scores']} times, not {want_b}")
    searches["a"](Q[:BATCH])
    turns = {"a": [], "b": []}
    for i in range(8):
        qb = Q[BATCH * (1 + i):BATCH * (2 + i)]
        for key in ("a", "b") if i % 2 == 0 else ("b", "a"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            searches[key](qb)
            torch.cuda.synchronize()
            turns[key].append(1e3 * (time.perf_counter() - t0))
    log("search batches in turns, ms: " + json.dumps(
        {key: {"each": v, "median": float(np.median(v))} for key, v in turns.items()}))
    for key, (label, _) in cells.items():
        policy_full[key]["batch_ms_in_turns"] = float(np.median(turns[key]))
        profile_device(lambda: searches[key](Q[BATCH:2 * BATCH]), f"search batch of 64, {label}")
    del built, searches

    lap("13 policies at full width")

    # -- 14. every policy at the serve defaults, the repo's artifacts, BM25 vs natural ------
    policy_rows = []

    def held(label, recall, extra):
        row = {"run": label, "recall@k": recall, **extra}
        if label in JAX_RECALL:
            row["jax_recall@k"] = JAX_RECALL[label]
            row["floor"] = round(JAX_RECALL[label] - 0.02, 4)
        policy_rows.append(row)
        log("policy at the serve defaults: " + json.dumps(row))
        if "floor" in row and recall < row["floor"]:
            raise AssertionError(f"{label}: recall@10 {recall} < {row['floor']} "
                                 f"(JAX {JAX_RECALL[label]} less 0.02)")

    for policy in ("avg", "min", "reverse", "l2", "max", "blend(0.25)", "rankblend(0.5)"):
        st = build_and_serve(index_sym=policy, n_db=20_000, dim=32, n_queries=256, batch=64,
                             ef_search=96, frontier=4, device="cuda", verbose=False)
        built_k = st["kernel_launches"]["build"]
        branches = 1 if policy in ("reverse", "l2") else 2
        if built_k["two_hop_scores"] != branches * 8:
            raise AssertionError(f"{policy}: {built_k['two_hop_scores']} two_hop_scores "
                                 f"launches, not {branches} per round")
        held(policy, st["recall@k"], {k: st[k] for k in ("index_sym_resolved", "build_s",
                                                         "qps", "eval_reduction")})
    for path in ("TUNED_spec.json", "LEARNED_weights.json"):
        spec = load_spec(str(ROOT / path))
        st = build_and_serve(spec=spec, n_db=20_000, dim=32, n_queries=256, batch=64,
                             device="cuda", verbose=False)
        built_k = st["kernel_launches"]["build"]
        if built_k["gather_scores"] <= 0 or built_k["gather_scores"] % 2:
            raise AssertionError(f"{path}: {built_k['gather_scores']} gather_scores launches "
                                 f"in a two-branch build")
        held(path, st["recall@k"], {"spec_fingerprint": st["spec_fingerprint"],
                                    "build_policy": str(spec.build_policy),
                                    "build_s": st["build_s"], "qps": st["qps"]})
    for n_db in (4_000, 20_000):
        for policy in ("none", "natural"):
            row = bm25_cell(n_db, policy)
            held(f"bm25 {policy} n={n_db}", row.pop("recall@k"), row)

    lap("14 policies at the serve defaults")

    # -- 15. churn at the serve defaults ------------------------------------------------------
    ops.reset_launch_counts()
    served = build_and_serve(n_db=20_000, dim=32, n_queries=256, batch=64, ef_search=96,
                             frontier=4, churn_rounds=4, churn_insert=256, churn_delete=200,
                             device="cuda", verbose=False)
    churn15_all = ops.launch_counts()
    churn15 = served["churn"]
    churn15.update(jax_recall=JAX_CHURN_RECALL, floor=round(JAX_CHURN_RECALL - 0.02, 4),
                   static_recall=served["recall@k"], build_s=served["build_s"],
                   build_launches=served["kernel_launches"]["build"], all_launches=churn15_all)
    log("churn at the serve defaults n=20000 d=32: " + json.dumps(churn15))
    if churn15["recall@k_after_churn"] < churn15["floor"]:
        raise AssertionError(f"recall@10 after churn {churn15['recall@k_after_churn']} < "
                             f"{churn15['floor']} (JAX {JAX_CHURN_RECALL} less 0.02)")
    if not churn15["capacity_used"] < 20_000 + churn15["inserted"]:
        raise AssertionError(f"no slot recycled: capacity_used {churn15['capacity_used']}")
    phase_k = churn15["kernel_launches"]
    if not (all(phase_k[p]["gather_scores"] > 0 for p in ("insert", "compact", "search"))
            and phase_k["audit"]["distance_matrix"] > 0
            and served["kernel_launches"]["build"]["gather_scores"] > 0):
        raise AssertionError(f"kernel not launched on the churn path: {phase_k}")
    # compact_slice drained at max_nodes = wave against one compact() on a copy
    # of the same state
    rng = np.random.default_rng(0)  # the serve-default data and its churn pool
    data = lda_like_histograms(rng, 20_000 + 256, 32, device="cuda")
    _, rest = split_queries(data, 256, rng)
    X_c = rest[:20_000]
    pool_c = lda_like_histograms(rng, 1024, 32, device="cuda")
    idx_c = ANNIndex.build(X_c, spec=full_spec.replace(NN=15, ef_search=96, capacity=21_024),
                           generator=torch.Generator(device="cuda").manual_seed(0))
    o_c = idx_c.online
    idx_c.insert(pool_c[:256])
    idx_c.delete(np.random.default_rng(1).choice(20_000, size=16, replace=False))
    state = {"X": o_c.X.cpu().numpy(), "adj": o_c.adj.cpu().numpy(),
             "adj_d": o_c.adj_d.cpu().numpy(), "alive": o_c.alive.cpu().numpy(),
             "entries": o_c.entries.cpu().numpy(), "n_total": o_c.n_total,
             "free": list(o_c._free), "killed_epoch": o_c.killed_epoch,
             "mutation_epoch": o_c.mutation_epoch, "compact_dirty": o_c._compact_dirty}
    copy_c = online_from_jax(state, idx_c.spec.to_dict(), device="cuda")
    ops.reset_launch_counts()
    slices = 0
    while copy_c.compact_slice(max_nodes=copy_c.wave)["remaining"]:
        slices += 1
    copy_c.compact_slice(max_nodes=copy_c.wave)
    slice_launches = ops.launch_counts()
    stats_c = idx_c.compact()
    same = torch.equal(copy_c.adj, o_c.adj) and torch.equal(copy_c.adj_d, o_c.adj_d)
    log(f"compact_slice drained in {slices + 2} slices vs compact() {stats_c}: adjacency "
        f"{'equal' if same else 'DIFFERS'}; the slices launched {slice_launches}")
    if not same or slice_launches["gather_scores"] <= 0:
        raise AssertionError("compact_slice drained at max_nodes = wave differs from compact()")
    del data, rest, X_c, pool_c, idx_c, o_c, copy_c

    lap("15 churn at the serve defaults")

    # -- 16. churn at full width: phase 9's cell -----------------------------------------------
    pool_n = CHURN_ROUNDS_FULL * CHURN_INSERT_FULL
    rng = np.random.default_rng(0)  # phase 9's data; the pool is drawn after the queries
    data = lda_like_histograms(rng, N_FULL + Q_FULL, D_FULL, device="cuda")
    Q, rest = split_queries(data, Q_FULL, rng)
    X = rest[:N_FULL]
    del data, rest
    pool = lda_like_histograms(rng, pool_n + CHURN_INSERT_FULL, D_FULL, device="cuda")
    pool, extra = pool[:pool_n], pool[pool_n:]
    spec16 = full_spec.replace(capacity=N_FULL + pool_n)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx16 = ANNIndex.build(X, spec=spec16, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    build16_s = time.perf_counter() - t0
    build16 = ops.launch_counts()
    # the deletes: each round's inserts recycle the tombstones of the round
    # before (deletes <= inserts), so compact() finds the last round's; each
    # leaves ~ out-degree + in-degree = 2 x mean degree nodes to repair, and
    # phase 15's compact gives the seconds per repaired node (x1.5 for the
    # larger graph's longer searches)
    per_node_s = churn15["compact_s"] / max(churn15["compact_repaired"], 1)
    per_delete = 2 * idx16.build_info["mean_degree"]
    del16 = int(np.clip(COMPACT_BUDGET_S / (1.5 * per_delete * per_node_s), 16,
                        CHURN_INSERT_FULL))
    log(f"full-width churn: {del16} deletes per round, so that compact() is predicted to fit "
        f"{COMPACT_BUDGET_S} s ({del16} tombstones left by the last round, {per_delete:.1f} "
        f"nodes to repair per tombstone, {per_node_s * 1e3:.3f} ms per repaired node at the "
        f"serve defaults, x1.5)")
    ops.reset_launch_counts()
    churn16 = run_churn(idx16, Q, pool, rounds=CHURN_ROUNDS_FULL, insert_n=CHURN_INSERT_FULL,
                        delete_n=del16, batch=BATCH, k=full_spec.k, ef_search=full_spec.ef_search,
                        frontier=full_spec.frontier, verbose=False)
    churn16_all = ops.launch_counts()
    churn16.update(build_s=build16_s, build_launches=build16, all_launches=churn16_all,
                   deletes_per_round=del16)
    log("churn at full width n=1000000 d=128: " + json.dumps(churn16))
    phase_k = churn16["kernel_launches"]
    if not (all(phase_k[p]["gather_scores"] > 0 for p in ("insert", "compact", "search"))
            and phase_k["audit"]["distance_matrix"] > 0 and build16["gather_scores"] > 0):
        raise AssertionError(f"kernel not launched on the full-width churn path: {phase_k}")
    if not churn16["recall@k_after_churn"] > 0.5:
        raise AssertionError(f"recall@10 after churn {churn16['recall@k_after_churn']} <= 0.5")
    if not churn16["capacity_used"] < N_FULL + churn16["inserted"]:
        raise AssertionError(f"no slot recycled: capacity_used {churn16['capacity_used']}")
    n_extra = min(PROFILED_INSERTS, idx16.online.free_slots)
    profile_device(lambda: idx16.insert(extra[:n_extra]),
                   f"insert round of {n_extra} (waves of 32), n=1e6 d=128 (phase 16)")
    idx16.delete(np.random.default_rng(2).choice(N_FULL, size=4, replace=False))
    profile_device(lambda: idx16.compact(), "compact after 4 deletes, n=1e6 d=128 (phase 16)")
    del idx16, X, Q, pool, extra

    lap("16 churn at full width")

    # -- 17. continuous at the serve defaults ----------------------------------------------
    cont_runs = {}
    with PlainCalls(ops) as plain17, Answered(SlotScheduler) as answered17:
        for key in ("continuous", "qos"):
            qos_kw = {} if key == "continuous" else dict(
                slo_ms=1.5 * cont_runs["continuous"]["continuous"]["p50_ms"], tenants=2,
                priority_mix=[0.6, 0.4])
            ops.reset_launch_counts()
            cont_runs[key] = build_and_serve(
                n_db=20_000, dim=32, n_queries=256, batch=64, ef_search=96, frontier=4,
                continuous=True, slots=SCHED_SLOTS, cont_frontier=SCHED_FRONTIER,
                utilization=0.4, device="cuda", verbose=False, **qos_kw)
            cont_runs[key]["all_launches"] = ops.launch_counts()
    answered17.check("phase 17")
    c17, q17 = cont_runs["continuous"], cont_runs["qos"]
    cont17 = {**c17["continuous"], "static_recall@k": c17["recall@k"],
              "jax_recall@k": JAX_CONTINUOUS_RECALL,
              "floor": round(JAX_CONTINUOUS_RECALL - 0.02, 4),
              "recall_minus_static": c17["continuous"]["recall@k"] - c17["recall@k"],
              "launches": c17["kernel_launches"], "all_launches": c17["all_launches"],
              "plain_calls_on_cuda": plain17.n}
    qos17 = {**q17["qos"], "continuous_recall@k": q17["continuous"]["recall@k"],
             "demoted_plus_shed": q17["qos"]["demoted"] + q17["qos"]["shed"],
             "launches": q17["kernel_launches"], "all_launches": q17["all_launches"]}
    log(f"continuous at the serve defaults n=20000 d=32: slo_ms for the QoS run "
        f"{qos17['slo_ms']:.3f} (1.5 x the continuous p50 {cont17['p50_ms']:.3f} ms)")
    log("continuous at the serve defaults n=20000 d=32: " + json.dumps(cont17))
    log("QoS at the serve defaults n=20000 d=32: " + json.dumps(qos17))
    if plain17.n:
        raise AssertionError(f"phase 17: {plain17.n} plain-version calls on CUDA tensors")
    for key, run in cont_runs.items():
        if not (run["kernel_launches"][key]["gather_scores"] > 0
                and run["all_launches"]["distance_matrix"] > 0):
            raise AssertionError(f"phase 17: kernel not launched on the {key} path: "
                                 f"{run['kernel_launches']}")
    if cont17["recall@k"] < cont17["floor"]:
        raise AssertionError(f"continuous recall@10 {cont17['recall@k']} < {cont17['floor']} "
                             f"(JAX {JAX_CONTINUOUS_RECALL} less 0.02)")
    if cont17["recall_minus_static"] < -0.005:
        raise AssertionError(f"continuous recall@10 {cont17['recall@k']} is more than 0.005 "
                             f"below the static line {cont17['static_recall@k']}")

    lap("17 continuous at the serve defaults")

    # -- 18. continuous at full width: phase 9's cell -------------------------------------------
    rng = np.random.default_rng(0)  # phase 9's data
    data = lda_like_histograms(rng, N_FULL + Q_FULL, D_FULL, device="cuda")
    Q, rest = split_queries(data, Q_FULL, rng)
    X = rest[:N_FULL]
    del data, rest
    idx18 = ANNIndex.build(X, spec=full_spec,
                           generator=torch.Generator(device="cuda").manual_seed(0))
    d18, true18 = knn_scan(kl, Q, X, full_spec.k)
    with PlainCalls(ops) as plain18, Answered(SlotScheduler) as answered18:
        # (a) no refill: S = B = 64 at the searcher's frontier, against one batch
        one = idx18.searcher()(Q[:BATCH])
        sched = idx18.scheduler(slots=BATCH, frontier=full_spec.frontier)
        res = sched.run_stream(Q[:BATCH])
        one = [t.cpu().numpy() for t in one]
        got = [np.stack([r.ids for r in res]), np.stack([r.dists for r in res]),
               np.asarray([r.n_evals for r in res]), np.asarray([r.hops for r in res])]
        no_refill = {"ids_equal": bool(np.array_equal(got[0], one[1])),
                     "n_evals_equal": bool(np.array_equal(got[2], one[2])),
                     "hops_equal": bool(np.array_equal(got[3], one[3])),
                     "dists_max_abs_diff": float(np.abs(got[1] - one[0]).max())}
        log("no-refill scheduler vs one-shot search at n=1e6 (64 slots, 64 queries): "
            + json.dumps(no_refill))
        if not (no_refill["ids_equal"] and no_refill["n_evals_equal"]
                and no_refill["hops_equal"]):
            raise AssertionError(f"phase 18: the no-refill scheduler differs from the "
                                 f"one-shot search: {no_refill}")
        # (b) a Poisson trace at utilization 0.4 of phase 9's measured batch capacity
        rate = 0.4 * BATCH / (full["p50_batch_ms"] / 1e3)
        arrivals = poisson_arrivals(Q_FULL, rate, np.random.default_rng(1))
        sched = idx18.scheduler(slots=SCHED_SLOTS, frontier=SCHED_FRONTIER)
        sched.warmup(Q[0].cpu().numpy())
        sites = count_sites(sched)
        ops.reset_launch_counts()
        res = sched.run_stream(Q, arrivals, warm=False)
        torch.cuda.synchronize()
        launches18 = ops.launch_counts()
    answered18.check("phase 18")
    lat = np.asarray([r.latency for r in res])
    cont18 = {"offered_qps": rate, "slots": SCHED_SLOTS, "frontier": SCHED_FRONTIER,
              "steps_per_sync": sched.steps_per_sync,
              "recall@k": recall_at_k(np.stack([r.ids for r in res]), true18),
              "phase9_recall@k": full["recall@k"],
              "eval_reduction": float(N_FULL / np.mean([r.n_evals for r in res])),
              "p50_ms": 1e3 * float(np.percentile(lat, 50)),
              "p95_ms": 1e3 * float(np.percentile(lat, 95)),
              "p99_ms": 1e3 * float(np.percentile(lat, 99)),
              "ticks": sites["tick"], "lock_steps_per_tick": sched.steps_per_sync,
              "ms_per_tick": sites["tick_ms"] / max(sites["tick"], 1),
              "admissions": sites["admit"], "step_calls": sites["step"],
              "launches": launches18, "plain_calls_on_cuda": plain18.n,
              "no_refill": no_refill}
    log("continuous at full width n=1000000 d=128: " + json.dumps(cont18))
    if plain18.n:
        raise AssertionError(f"phase 18: {plain18.n} plain-version calls on CUDA tensors")
    want18 = sites["admit"] + sched.steps_per_sync * sites["step"]
    if launches18["gather_scores"] != want18:
        raise AssertionError(f"phase 18: {launches18['gather_scores']} gather_scores launches, "
                             f"not one per admission and lock-step ({want18})")
    if cont18["recall@k"] < full["recall@k"] - 0.005:
        raise AssertionError(f"phase 18: continuous recall@10 {cont18['recall@k']} is more than "
                             f"0.005 below phase 9's {full['recall@k']}")
    # one window of ticks: 48 queries admitted, 16 ticks of 4 lock-steps
    sched.reset()
    for i in range(SCHED_SLOTS):
        sched.submit(Q[i].cpu().numpy(), rid=i)
    sched.tick()
    profile_device(lambda: [sched.tick() for _ in range(16)],
                   f"16 scheduler ticks, {SCHED_SLOTS} slots x {sched.steps_per_sync} lock-steps, "
                   "n=1e6 d=128 (phase 18)")
    del idx18, sched, res

    lap("18 continuous at full width")

    # -- 19. sharded serving at the serve defaults ----------------------------------------------
    sharded19 = phase19(kl)

    lap("19 sharded serving at the serve defaults")

    # -- 20. sharded at full width: phase 9's data ----------------------------------------------
    sharded20 = phase20(X, Q, d18, true18, full["recall@k"])
    del Q

    lap("20 sharded at full width")

    # -- 21. the tuner at bench_autotune's full workload, its spec at the serve defaults -------
    tune21 = phase21()

    lap("21 tuner")

    # -- 22. learned distances: BM25 workload B, the metric learner at n=1e6 -------------------
    learned22 = phase22(X)
    del X

    lap("22 learned distances")

    # -- 23. the two-tower path at recsys_ann.py's shape ----------------------------------------
    two_tower23 = phase23()

    lap("23 two-tower path")

    # -- 24. llama3.2-1b at full width: train, decode = forward, serving, attention -------
    lm24 = phase24()

    lap("24 llama3.2-1b")

    # -- 25. crash-resume at llama-110m; gemma3-12b's window and full depth --------------
    lm25 = phase25()

    lap("25 resume and gemma3-12b")

    # -- 26. the MoE LMs at full width: phi3.5-moe trained and served, kimi-k2 served -----
    moe26 = phase26()

    lap("26 MoE LMs")

    # -- 27. the GCN: full batch at ogb_products' shape, sampled at minibatch_lg's --------
    gnn27 = phase27()

    lap("27 GCN")

    # -- 28. the recsys ranking models at full width; the retrieval configs ------------
    recsys28 = phase28()

    lap("28 recsys")

    # -- 29. the device mesh: every on-mesh path on 4 ranks, then world 1 under NCCL -----
    # (the same spawn and NCCL group run phase 30 (a); phase 30 (b)'s meta pass counts
    # on the CPU meanwhile)
    prod_tmp = tempfile.TemporaryDirectory()
    prod_procs = {"meta": production_pass("meta", prod_tmp.name)}
    mesh29, fsdp_ranks, fsdp_world = phase29()

    lap("29 mesh (and 30 (a))")

    # -- 30. FSDP x TP on 4 ranks, then one rank of the production mesh executed -----
    fsdp30 = phase30(fsdp_ranks, fsdp_world, prod_procs, prod_tmp)
    max_err[("distance_matrix", "negdot", "retrieval cell")] = \
        fsdp30["retrieval_dm"]["max_abs_err"]

    lap("30 fsdp x tp and the dry run")

    # -- 31. strict mode on the card: the host syncs of search and scheduler by site ---
    strict31 = phase31()

    lap("31 strict mode")

    def err_of(kernel_name):
        return max(v for k, v in max_err.items() if k[0] == kernel_name and k[1] == "kl")

    def all_err(kernel_name):
        return max(v for k, v in max_err.items() if k[0] == kernel_name)

    def wrapper_errs(*sites):
        return max(v for k, v in wrapper_err.items() if k[0] in sites)

    policy_a, policy_b = policy_full["a"], policy_full["b"]
    # the sharded paths' launches on rank 0 (every rank was checked)
    l19, l20 = sharded19["launches_by_rank"][0], sharded20["launches"]

    def sharded_path(name):
        return (f"; sharded (rank 0 of 4 on the card): phase 19 at the serve defaults "
                f"{ {phase: l19[phase][name] for phase in l19} }, phase 20 at full width "
                f"{ {phase: l20[phase][name] for phase in l20} }")
    def m15_path(name):
        return (f"; tuning and learning: the tuner's rungs (phase 21: "
                f"{tune21['tune_launches'][name]}, its deploy {tune21['deploy_launches'][name]}), "
                f"the BM25 fit (phase 22: {learned22['fit_launches'][name]}), true_neighbor_ids "
                f"and fit_mahalanobis_map at n=1e6 (phase 22: "
                f"{learned22['true_neighbor_ids_launches'][name]} and "
                f"{learned22['fit_mahalanobis_map_launches'][name]}), the two-tower path "
                f"(phase 23: ground truth {two_tower23['truth_launches'][name]}, plain build "
                f"{two_tower23['plain']['build_launches'][name]}, search "
                f"{two_tower23['plain']['search_launches'][name]}, fit "
                f"{two_tower23['fit_launches'][name]}, learned build "
                f"{two_tower23['learned']['build_launches'][name]}, scheduler "
                f"{two_tower23['scheduler']['launches'][name]})")
    main_row, gs_main = fs_rows[0], gs_steps[0]
    dm_main = dm_rows[0]
    kernels = [{
        "name": "frontier_scores",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_gather.cu",
        "replaces": "src/repro/kernels/frontier_gather.py:95",
        "launches": main_launches["frontier_scores"],
        "max_abs_err": err_of("frontier_scores"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
        "path": "NN-descent build of the main path, n=1e6 (phase 9); once per branch under "
                f"a policy: {policy_a['build_launches']['frontier_scores']} launches in the "
                "min build at n=1e6 (phase 13)" + sharded_path("frontier_scores"),
        "max_abs_err_all_distances": all_err("frontier_scores"),
        "max_abs_err_wrappers": wrapper_errs("round"),
        "other_shapes": fs_rows[1:] + [fs_shard],
    }, {
        "name": "two_hop_scores",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/frontier_gather.cu",
        "replaces": "src/repro/kernels/frontier_gather.py:95",
        "launches": main_launches["two_hop_scores"],
        "max_abs_err": err_of("two_hop_scores"),
        "ms": rt["join_kernel_ms"],
        "plain_ms": rt["join_plain_ms"],
        "bound_ms": rt["join_bound_ms"],
        "bound_by": rt["join_bound_by"],
        "library_ms": None,
        "shape": f"NN-descent round join n=1e6 K={K_nn} m'=128, real candidate block",
        "path": "NN-descent main path, n=1e6 (phase 9), one launch per round; once per "
                f"round and branch under a policy: "
                f"{policy_a['build_launches']['two_hop_scores']} launches in the min build at "
                "n=1e6 (phase 13)" + sharded_path("two_hop_scores"),
        "plain_rows": plain_rows,
        "max_abs_err_all_distances": all_err("two_hop_scores"),
        "max_abs_err_wrappers": wrapper_errs("round"),
        "round": rt,
    }, {
        "name": "distance_matrix",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/distance_matrix.cu",
        "replaces": "src/repro/kernels/distance_matrix.py:119",
        "launches": main_launches["distance_matrix"],
        "max_abs_err": err_of("distance_matrix"),
        "ms": dm_main["ms"],
        "plain_ms": dm_main["plain_ms"],
        "bound_ms": dm_main["bound_ms"],
        "bound_by": dm_main["bound_by"],
        "library_ms": dm_main["library_ms"],
        "library": "torch.matmul, TF32 off, without the epilogue",
        "shape": dm_main["shape"],
        "path": "knn_scan ground truth of the NN-descent main path (phase 9); also "
                f"build_sharded (phase 8: {sharded_launches['distance_matrix']} launch), entry "
                "selection and rankblend's tau (once per branch), the ground truth of "
                "phases 13 and 14, the churn audit's scan of the surviving rows (phases 15 "
                f"and 16: {churn16['kernel_launches']['audit']['distance_matrix']} launches "
                "at full width)" + sharded_path("distance_matrix") + m15_path("distance_matrix"),
        "max_abs_err_all_distances": all_err("distance_matrix"),
        "max_abs_err_wrappers": wrapper_errs("distance_matrix"),
        "other_shapes": dm_rows[1:] + [dm_shard, fsdp30["retrieval_dm"]],
        "launches_phase30": fsdp30["retrieval_distance_matrix_launches"],
    }, {
        "name": "gather_scores",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gather_topk.cu",
        "replaces": "src/repro/kernels/gather_topk.py:79",
        "launches": main_launches["gather_scores"],
        "max_abs_err": err_of("gather_scores"),
        "ms": gs_main["ms"],
        "plain_ms": gs_main["plain_ms"],
        "bound_ms": gs_main["bound_ms"],
        "bound_by": gs_main["bound_by"],
        "library_ms": None,
        "ms_again": gs_main["ms_again"],
        "shape": gs_main["shape"],
        "path": "search steps of the NN-descent main path, n=1e6 (phase 9); also the "
                f"SW-graph wave build's searches and reverse edges (phase 5: "
                f"{sw_launches['gather_scores']} launches); twice per lock-step and once "
                "per batch for the rerank under a min search policy: "
                f"{policy_b['search_launches']['gather_scores']} launches in the timed "
                "search at n=1e6 (phase 13); every scoring site of the online index: "
                "from_graph's edge distances, each insert and repair wave's search, "
                "intra-wave block and reverse edges, and the alive-masked search (phases 15 "
                "and 16, churn_launches); the slot scheduler's admissions and lock-steps "
                "at the serve defaults (phase 17: "
                f"{cont17['launches']['continuous']['gather_scores']} launches in the continuous "
                f"run, {qos17['launches']['qos']['gather_scores']} in the QoS run) and at "
                f"n=1e6 (phase 18: {launches18['gather_scores']} launches = "
                f"{cont18['admissions']} admissions + {cont18['step_calls']} ticks x "
                f"{cont18['lock_steps_per_tick']} lock-steps)" + sharded_path("gather_scores")
                + m15_path("gather_scores"),
        "max_abs_err_all_distances": all_err("gather_scores"),
        "max_abs_err_wrappers": wrapper_errs("gather_scores"),
        "other_shapes": gs_steps[1:] + [gs_rev32, gs_rev128, gs_wide, gs_rev_wide, gs_edge]
        + gs_online + gs_sched + gs_shard + gs_m15,
        "churn_launches": {"serve_defaults": churn15["kernel_launches"],
                           "serve_defaults_build": churn15["build_launches"],
                           "full_width": churn16["kernel_launches"],
                           "full_width_build": churn16["build_launches"]},
    }]
    log("policies: " + json.dumps({"full_width": policy_full, "serve_defaults": policy_rows}))
    log("churn: " + json.dumps({"serve_defaults": churn15, "full_width": churn16}))
    log("continuous: " + json.dumps({"serve_defaults": cont17, "qos": qos17,
                                     "full_width": cont18}))
    log("sharded: " + json.dumps({"serve_defaults": sharded19, "full_width": sharded20}))
    log("tuning and learning: " + json.dumps({"tuner": tune21, "learned": learned22,
                                              "two_tower": two_tower23}))
    log("dense LM: " + json.dumps({"llama3.2-1b": lm24, "resume_and_gemma3": lm25}))
    log("MoE LM: " + json.dumps(moe26))
    log("GCN: " + json.dumps(gnn27))
    log("recsys: " + json.dumps(recsys28))
    log("mesh: " + json.dumps(mesh29))
    log("fsdp x tp and the dry run: " + json.dumps(fsdp30))
    log("strict mode: " + json.dumps(strict31))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"timings read from CUDA events, the profiler having fallen short: "
        f"{len(PROFILER_FALLBACKS)} {PROFILER_FALLBACKS}")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
