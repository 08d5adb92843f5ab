#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``combblas_tpu_torch``) on one NVIDIA card.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints one JSON line):
  1. card: name and power limit (``nvidia-smi``), float32 matmul settings;
  2. build: compiles every CUDA source of the port with ``nvcc``, one
     process per source, all started together; per K1 kind, the FFMA /
     FADD / FMNMX / LDS counts of the kernel's main loop from
     ``cuobjdump -sass`` of the built library;
  3. kernels: the semiring GEMM (K1) against its plain PyTorch version, all
     four semiring kinds, at a small, a ragged and the main path's full
     shape, and on either side of its 128 x 128 x 16 tiles so that both
     instantiations (tiled, edge) run; per kind a case with NaN, -0.0,
     +0.0, +inf and -inf cells (NaN cells compared by position, the rest
     by their bits); plus_times exact on integers of 12 significant bits
     times {-1, 0, 1}, which a product at TF32 or bf16 precision would
     round; and plus_times on uniform [-1, 1] data at 4096^3 against a
     float64 product, within K * 2^-24 * sum|a||b| per cell, both
     instantiations bit-equal;
  4. compaction: both instantiations of the dense -> sparse compaction
     kernel (K2: single, two_pass) against its plain version, whole arrays,
     at a small, a ragged and a multi-panel shape, on a case where the
     greedy placement drops a panel, over a density sweep at 8192 x 8192,
     with 8-row panels, with one panel of 2^15 rows and at 16384 x 16384;
     at each timed case the two in turns (single, two_pass, two_pass,
     single), each with its bound, share of it and achieved GB/s;
  5. main path: ``spgemm_auto`` through the mxu tier on an R-MAT scale-13
     graph (n = 8192, edgefactor 16) for MIN_PLUS, MAX_MIN and PLUS_TIMES,
     each result held exactly against the dense product recomputed with
     the plain version, then timed;
  6. K2 path: the mxu tier's dense accumulator for the same products
     (densify, stage product, fold), sized with ``dense_support_nnz`` and
     extracted with ``dense_to_sptuples``; the live entries held exactly
     against ``sparsify_windowed``, ``sparsify`` and the main path's
     result, then the extraction layers timed (K2's instantiations in
     turns), and for MIN_PLUS the device time of each operator and kernel
     of ``dense_support_nnz`` and ``dense_to_sptuples`` (``torch.profiler``);
  7. times: K1 per kind at the main path's shape, beside its bound, its
     instruction-issue floor (``floor_ms``, at the SM clock ``nvidia-smi``
     reads at the end of the timed loop), its plain version and
     (plus_times) one ``torch.matmul``;
  8. BFS path: the Graph500 batched BFS at scale 20, edgefactor 16, 256
     roots on a 1 x 1 grid. The host builds the graph and its search
     structures (``build_graph``, ``build_structures``); after the upload
     ``bfs_batch_compact`` + ``batch_traversed_edges`` run dense-only and
     direction-optimised (CSC budgets n/8 columns and max(nnz/16, 2^20)
     edges), a warm-up then timed calls (CUDA events and host clock
     around the whole call, the edge counts' readback inside). Both modes
     must agree on levels, parents and edge counts; ``validate_bfs_device``
     on 4 lanes must report no violation, every root must reach an edge,
     and a numpy BFS on the host from the same 4 roots must give the same
     levels and max-id parents. Then, level by level, the dense and (where
     the budgets hold) the sparse step timed on the same frontier, the
     parents pass, each beside its bytes bound, and a sweep of the row
     slicing's byte envelopes with peak memory. This path is PyTorch ops
     only (the reference runs it in XLA ops, outside any Pallas kernel):
     it launches no hand kernel, and the phase checks that. On the same
     graph and structures, last: ``bfs_single`` with ``DEFAULT_SEQ_TIERS``
     (the CSC arrays serve as the CSR companion, shown equal to the graph's
     CSR arrays on this 1 x 1 grid), a warm-up root then the first 16 roots
     one after another, each timed on the host clock around the search, the
     edge count and its readback, with the step of each level, per-root
     MTEPS and their harmonic mean; each root's parents, levels and edge
     count must equal its lane of the dense batched search, two roots must
     give the same with tiers "" (always dense), and the roots must take at
     least one top-down and one bottom-up step. Then the first root's levels
     driven by hand, each level's step and the dense sweep timed (CUDA
     events) beside their bytes bounds; ``bfs_batch`` on the first 16 roots
     (equal to those lanes; its SpMV ``dist_spmv_ell_masked_multi`` timed
     a launch); ``sssp_batch`` on unit float32 weights (distances equal to
     those lanes' levels, rounds the depth + 1; ``dist_spmv_ell_multi``
     timed a launch). The elapsed time is printed before these steps.
  9. SpParMat path, on the same graph and the batch's results: the graph
     as a COO ``SpParMat`` (host bucketing and upload timed), ``bfs``,
     ``bfs_diropt`` (the budgets of phase 8) and ``bfs_diropt_auto`` from
     the first root, each equal to lane 0 of the batch (parents, levels,
     edge count), with at least one top-down and one bottom-up level;
     ``sssp`` on unit float32 weights (distances equal to the levels,
     rounds to bfs's levels); FastSV and LACC equal to each other and to
     each scipy component's least vertex; ``pagerank`` within 1e-4 (L1) of
     a float64 power iteration of as many rounds, ``pagerank_batch`` on the
     column-normalised ELL (16 roots, two lanes held the same way); ``mis``
     independent and maximal over the edge list; each timed a call on the
     host clock (3 calls after a warm-up). Then ``dist_spmv`` per semiring
     and ``dist_spmspv_masked`` at a top-down level, timed a launch (CUDA
     events) beside their bytes bounds, with ``torch.profiler``'s operator
     breakdown; K1 and K2 must not launch in these steps.
 10. spgemm_general, the general SpGEMM and what runs on it (each step a
     warm-up call, whose result the checks read, and one call timed with
     CUDA events around it; ms a call, output nonzeros per
     second, peak memory): (1) on phase 5's scale-13 graph (1 x 1) the esc
     tier, ``spgemm(merge="runs")`` and the scan tier give the mxu tier's
     live entries bit for bit for min_plus, max_min and plus_times; (2) A·A
     of an R-MAT scale-16 graph on a 4 x 4 grid of tiles per semiring
     through ``spgemm`` (sort), ``spgemm(merge="runs")``, ``spgemm_scan``
     and ``mem_efficient_spgemm(phases=4)``: 355,881,582 live entries each,
     min_plus and max_min equal bit for bit across the four, plus_times
     within float32 rounding of the exact float64 product (expand, sort and
     sum on the card: integer weights); the router's
     answer (windowed, as the reference's) and ``spgemm_auto``'s product on
     it, equal to sort; the bytes bound and ``torch.sparse.mm`` on CSR for
     plus_times;
     (3) ``kselect(16)`` and ``prune_column`` on the min_plus A·A against
     numpy; (4) ``subsref`` of a seeded half of the vertices against
     scipy's slice; (5) triangles of the scale-15, 16 and 18 graphs
     (6,708,365 / 15,684,546 / 82,878,317) by every kernel that fits;
     (6) betweenness centrality of phase 8's graph from its first 16 roots,
     ``bc_batch_dense`` on the ELL form against ``bc_batch`` on a 2 x 2
     ``SpParMat``, the first two lanes against a float64 Brandes on the
     host, the capacities of each product. K1 runs only in step 1's mxu
     calls, K2 never.
 11. spgemm_windowed, the windowed SpGEMM tier and ``semantic.py`` (each
     timed step a warm-up and two calls, CUDA events around the whole call):
     (1) phase 10's A·A at scale 16 on 4 x 4 through plain ``spgemm_auto``:
     the router answers windowed (also with backend="dot"), the scatter
     backend's blocked form runs, equal to ``spgemm`` (sort) bit for bit for
     min_plus and max_min, plus_times within float32 rounding of the exact
     float64 product (its largest sum passes 2^24), with the plan,
     peak memory and a bytes bound (A and B read, the accumulators' cells
     written and read, C written once) beside phase 10's sort time; (2)
     R-MAT scale 15 on 2 x 2 (16384-wide tiles) through the dot backend:
     equal to the scatter backend and to sort, K1 launched tiles × stages ×
     live windows a call at [4096, 16384] x [16384, 8192], the carousel once
     for min_plus, and that launch rebuilt from the path's operands held bit
     for bit against the plain version; (3) phase 5's graph on 1 x 1 forced
     to the windowed tier (scatter; dot with the oracle off and on, one K1
     launch a tropical call), equal to phase 5's mxu result bit for bit;
     (4) phase 9's matrix with a seeded attribute an edge (w[i] + w[j]):
     ``filtered_bfs`` materialized and masked equal to each other and to a
     numpy BFS over the passing edges, ``filtered_mis`` independent and
     maximal over them. K1 runs as often as the plans say, K2 never.
 12. apps, the CombBLAS applications on the SpGEMM and SpMV layers (each
     timed step a warm-up, whose result the checks read and whose readbacks
     are counted, then one call with CUDA events and the host clock around
     it; peak memory): (1) MCL at HipMCL's defaults (select
     1100, recover 1400 at 0.9, hard threshold 1e-4, inflation 2) on R-MAT
     scale 14, edgefactor 8: the dense loop (bf16x3, plateau kicks at 5e-5,
     at most 20 iterations) with its chaos trajectory, kicks and clusters;
     the sparse loop at phases 1 and 2 and the block loop (chaos_every=4),
     one iteration each, the iteration's expansion beside its bytes bound;
     three sparse iterations on the same recipe at scale 12 (8 phases), each
     iterate column-stochastic within 2 nnz_j 2^-24 and holding fewer than
     1400 entries above its least kept value, its chaos within 1e-3 of a
     float64 MCL of the same steps on the host; a ring of 64 cliques of 64
     vertices through both loops, which must return the cliques; labels are
     each cluster's least vertex id. (2) On phase 10's scale-18 graph
     Karp-Sipser ``maximal_matching``, ``maximum_matching`` and ``awpm``
     (weights default_rng(5).random + 0.1), on phase 8's scale-20 graph the
     first two: valid and maximal over the edge list, the maximum and AWPM
     cardinalities equal to scipy's; the phases' SELECT2ND_MIN layer SpMV
     timed a launch. (3) ``rcm_ordering`` on phase 9's scale-20 matrix from
     root 0 and from the pseudo-peripheral probe, each equal to the reversed
     numpy lexsort of (level, degree, id) from a host BFS, bandwidth before
     and after; ``minimum_degree_ordering`` on R-MAT scale 10 against a host
     elimination. (4) On phase 8's ELL layout (unit float32 values) at F =
     64, 2 hops: ``spmm_khop`` plus_times normalised (mxu_gather, scatter)
     within 2 (dmax + 2) 2^-24 |M|(|M||X|) of the float64 product,
     min_plus (scatter); ``summa_spmm`` on a 2 x 2 SpParMat of the same
     graph (scatter, both stage orders), min_plus bit-equal to the ELL's;
     ``propagate_features``; ``_propagate_batch_impl`` on 128 roots (8
     PAD_ROOT lanes, exactly zero) against the whole-graph rows. K1 and K2
     never run.
 13. graph_input, Graph500 graph input at scale 20, edgefactor 16: (1)
     ``kernel1_device`` on 1 x 1 as the reference's benchmark runs it (a
     warm-up with key 41, then key 42 uncompressed), each stage's seconds,
     peak memory and the deferred drop count (0); the matrix has no loops,
     no duplicates, only ones, is symmetric, and its entries are exactly the
     distinct symmetrised loop-free pairs of the card's own ``rmat_edges``;
     its degrees are the row counts; the compressed call gives P A P^T with
     the compression permutation read back (live vertices a prefix in
     order, nkeep their count); on 2 x 2 with the extra relabel it gives
     P Q A Q^T P^T with Q the key's ``randperm``; ``bfs`` from 4 roots on the
     matrix equals a numpy BFS; ``rmat_edges`` on the card equals the CPU's
     at scale 14; the layers G1 (``rmat_edges``), G2 (route + dedup) and G3
     (``permute_vertices``) timed beside their bytes bounds with the
     kernels a call. (2) The Graph500 v2.1 generator (native, user seed
     0xDECAFBAD) timed, equal to the numpy stream on three ranges of 2^16
     edges (head, middle, tail); its symmetrised loop-free edges routed onto
     2 x 2 by ``from_device_coo(dedup_sr=SELECT2ND_MAX)`` equal scipy's
     deduplicated COO tile array for tile array. (3) That graph as a 2 x 2
     ``EllParMat``: ``bfs_batch_compact(ring=True)`` from 64 roots, timed,
     4 lanes' levels, parents and edge counts equal to a numpy BFS.
     (4) Phase 10's scale-18 graph through ``write_mm``, the native
     ``read_mm`` (parse rate) and ``read_mm_distributed`` onto 2 x 2; kernel
     1's matrix through ``write_binary`` / ``read_binary``; a checkpoint of
     the 2 x 2 matrix loaded onto 2 x 2 (verbatim) and 1 x 1; its degree
     vector through ``write_vec`` / ``read_vec``; every round trip gives the
     data back exactly. The files live in ``build/chip_smoke_io`` and are
     removed, but for the Matrix Market file, moved to
     ``build/chip_smoke_multiproc`` for phase 23. K1 and K2 never run.
 14. mesh3d, the 3D (layered) tier on 2 x 2 x 2 (layers emulated on the
     card): (1) phase 10's A·A recipe through ``spgemm3d(tier="esc")`` with
     each fiber merge tier (sort, runs, hash), min_plus and plus_times,
     each equal to the others and to the 2D ``spgemm`` (sort) on 2 x 2;
     scale 16 is reckoned first (output tiles and hash table from the
     tier's own capacity rule) and cut to 15 above 70 GB; ms a call, peak
     memory, the fiber exchange's and the merge's ms, the bytes bound.
     (2) The same min_plus product through ``spgemm_auto(grid3=...)``: the
     router answers windowed3d, the result on the 2D grid equals step 1's;
     timed beside the 2D windowed route. (3) Phase 11's scale-15 recipe
     through ``spgemm3d_windowed(backend="dot")``, min_plus and max_min,
     bit for bit equal to the scatter backend and to the 2D dot backend
     (phase 11's products of the same operands, kept on the host: the 2D
     product is not run again here); K1 launched layers x tiles x stages x
     live windows a call; K1 at the
     layer's window shape held against its plain version. (4) Phase 8's
     scale-20 matrix onto 2 x 2 x 2 col- and row-split, ``resplit3d`` both
     ways and back to 1 x 1: the key and value set unchanged. (5) Phase
     12's MCL graph on 2 x 2 through ``mcl(layers=2)``, one iteration: its
     bare expansion equal in support to the 2D one's (values within 1e-4),
     its iterate too but for entries at a column's select threshold, where
     the order of a float sum decides a tie;
     at scale 12 the plain and ``chaos_every=2`` 3D loops to convergence
     with the 2D loop's labels. K2 never runs.
 15. tuner, the measured-plan tuner (at most 60 s; each step's plan store a
     fresh directory under ``build/chip_smoke_plans``): (1) on phase 5's
     scale-13 graph (1 x 1, min_plus) with ``COMBBLAS_TUNER_PROBE=1``, one
     ``spgemm_auto`` misses the store and probes the admissible rungs on
     the 2048-wide proxy at the default budget: each rung's seconds, the
     winner, the store's ``stats()``, K1's launches by candidate, warm-up
     and timed run each counted (the mxu rung runs K1); K1 at the mxu
     rung's shape on the probe's proxy held against its plain version;
     nothing skipped (``probe_spgemm.last_errors`` empty),
     ``plan_source`` "probe", one line in the store file; the product equal
     to phase 5's mxu result and to ``spgemm_auto(tier=<winner>)`` with the
     store off, bit for bit; (2) the same call again: "store", no new probe
     run, one more hit, the same product, its seconds beside step 1's; (3)
     a fresh ``PlanStore`` reading the file: the same record, the key's
     platform "cuda"; (4) step 1 under ``COMBBLAS_SPGEMM_BACKEND=dot`` in a
     second store (the windowed rung and any geometry sweep run K1; K1
     also held at the windowed rung's window shape on the proxy); (5)
     ``resolve_spmm_backend(PLUS_TIMES, E, 64, X=X)`` on phase 8's ELL layout
     (unit values): both backends measured, the winner persisted and
     replayed, one hop under each within twice the one-hop rounding bound;
     (6) ``spgemm3d`` on phase 14's min_plus recipe on 2 x 2 x 2: the
     (tier, merge) candidates measured on the real operands, the winner
     replayed from the store, the product equal to phase 14's ESC sort
     result. K2 never runs.
 16. obs, the telemetry (at most 40 s; ``combblas_tpu_torch.obs``): (1)
     phase 5's min_plus ``spgemm_auto`` (mxu) with obs off, on, and on with
     ``DEVICE_SYNC``: the products bit for bit equal, K1 twice each, the
     same device kernels in ``torch.profiler`` traces off and on (a mode
     whose trace shows fewer is traced again, 8 traces at most: the
     profiler drops device records here) and the same synchronising calls
     (``torch.cuda.set_sync_debug_mode("warn")``) off and on, traced and
     not, ``DEVICE_SYNC`` adding exactly the readback of
     ``spgemm.realized_nnz``; ``spgemm.auto.tier{tier=mxu, sr=min_plus}``
     1, ``spgemm.mxu.overflow_retries`` 1 (the second attempt),
     ``spgemm.realized_nnz`` nnz(C); the call's ms with obs off and on, in
     turns; (2) the ``spgemm.auto`` range around K1's two kernels on the
     profiler's timeline, and ``timers.trace`` writing a trace that names
     it; (3) ``bfs_levels_instrumented`` on phase 8's ELL layout from 4
     roots: levels equal to a numpy BFS, the frontier events equal to its
     level sizes, ``spmv.dispatch`` one a hop, ms a hop beside ``bfs``'s
     ms a level on the same roots; (4) phase 15's probe of the scale-13
     product with obs on, in a fresh store: the ``tuner.probe.*``,
     ``tuner.store.*`` and ``spgemm.auto.plan_source`` series of the
     probing call and the replay, K1's launches the candidates' plus the
     product's; (5) on the host: ``dump_jsonl`` -> ``parse_jsonl`` ->
     ``aggregate`` and ``export.render`` -> ``parse_exposition`` equal to
     the registry, one fetch from a ``ScrapeServer`` on 127.0.0.1, a
     ``FlightRecorder`` dump and a ``FleetLog`` read back, and
     ``psum_counters`` on a 2 x 2 grid's counters on the card against
     numpy. Files in ``build/chip_smoke_obs``, removed. K2 never runs.
 17. engine: the serving engine and the mutation lane, on the graphs of
     phases 8 and 10 (kept on the host). (1) ``GraphEngine.from_coo`` on
     phase 8's scale-20 graph (1 x 1) with weights ``default_rng(7)``
     1..15 and a seeded F = 64 feature table, all five kinds, timed (the
     rebuild baseline); ``warmup`` over widths 1-16; 16 roots a kind
     through ``batcher.assemble`` -> ``execute`` -> ``scatter``, every
     served lane bit for bit equal to the direct call on the same operands
     (``bfs_batch``, ``sssp_batch``, ``pagerank_batch``,
     ``bc_batch_dense_lanes``, the propagate batch), 2 lanes' levels equal
     to a numpy BFS, a 5-root batch in the 8-lane bucket equal to its 16-lane
     lanes with inert ``PAD_ROOT`` lanes; ms a batch by kind (host clock,
     readback inside), plan hits and misses. (2) The reference's churn
     recipe, cut from 24 to 2 pairs for time (PERF.md §4): disjoint vertex
     pairs of degree 5-19 (below their class width) that are not edges,
     inserted one batch each through ``DeltaBuffer`` -> ``drain`` ->
     ``apply_delta`` -> ``swap``, then deleted; every merge incremental, no plan built after the warm-up;
     ``E.to_host_coo()`` equal to the expected edge set after the inserts
     and to the original after the deletes; served BFS on the merged
     version equal to a bfs-only rebuild of the same edges; the first
     merge's ms (it bootstraps the merge state) and the others' mean and
     max, swap ms, buckets uploaded and reused, the uploads' ms, arrays
     and MB a merge (``_put_buckets``, one ``.to(device)`` an array, timed
     with a synchronise), amortization (build_s over the others' mean
     merge). (3) ``refresh`` bfs, cc and pagerank cold on the first
     version, warm after the first insert and equal to a forced cold run
     (pagerank in L1 within 2 tol / (1 - alpha) and within 2% at the
     inserted edge's ends, in no more sweeps; the stale ranks, as a
     control, must fail the ends' limit), cold with reason
     ``deletes`` after the first delete. (The merges run on the host, 1.6-1.8
     s each at scale 20; the phase's budget of 60 s holds 4.) (4) On phase
     10's scale-18 graph (2 x 2, kinds bfs and pagerank, in
     ``build/chip_smoke_engine``, kept for phase 18): a snapshot, 4 batches (cut from
     8 for time) appended to the WAL and merged, the engine dropped; ``recover`` equal to the last version (every bucket
     array, E's COO), and with the WAL's last line cut in half to the one
     before; the recovered version swapped into a warmed replica loaded
     from the snapshot serves the same BFS with no plan built; one batch
     past ``dynamic_spill_frac`` rebuilds, equal to a fresh build. Neither
     K1 nor K2 runs. The scale-20 engine (back at its first version after
     the churn), its 16 roots and served lanes, and step 4's directory with
     its last version are handed to phase 18.
 18. server: ``Server`` (``serve/api.py``) on phase 17's engine and
     directory, building no graph (it fails past 40 s). (1) ``eng.serve`` with
     lane widths 1-16 and a 10 s SLO deadline, ``warmup``, the worker
     started; 4 client threads submit 112 requests (each of the 16 roots 4
     times for bfs, once for sssp, pagerank and bc, one ``submit_many`` a
     kind): every result bit for bit equal to phase 17's lane for its root,
     no plan built after the warm-up; requests/s, p50 and p99 latency by
     kind (submit to settle, host clock), batches and mean occupancy, the
     queue wait, execute and scatter ms of each batch (the flight recorder), the SLO
     budget and ``health()`` (``ok``, no device error). (2) On buckets of at
     most 4 lanes, pumped in the phase's thread: a scripted
     ``engine.execute`` fault bisected with every request served, a
     malformed root (n + 5) failed alone with its lane-mates served, an
     expired request dropped before execution, the bfs breaker closed. (3)
     ``submit_update`` of one of phase 17's churn pairs, merged
     incrementally on the mutation thread and swapped, a 16-root bfs batch
     timed beside the merge and alone; a bfs from the pair's end sees the
     edge; its delete restores phase 17's lanes; no plan built. (4)
     ``Server.from_recovery`` on phase 17's scale-18 directory (2 x 2) with
     ``checkpoint_every=1``, ``checkpoint_retain=2``: equal to phase 17's
     last version (every bucket array, E's COO), 2 write batches each
     snapshotted by the checkpointer thread, 2 snapshots retained and the
     WAL truncated; after ``close`` a second recovery equal to the served
     version. Neither K1 nor K2 runs.
 19. fleet: the tenant pool and the replica fleet (``serve/pool.py``,
     ``policy.py``, ``fleet.py``) on phase 17's engine and directory (it
     fails past 75 s; it removes the directory). (1) An ``EnginePool`` on
     1 x 1: ``big`` (phase 17's scale-20 graph from its retained COO, bfs
     and sssp, weight 3) and ``a``, ``b`` (scale-18 R-MAT graphs drawn on
     the card from seeds 5 and 6, weight 1) under a byte budget of big + a
     + 5%: big's lanes bit for bit equal to phase 17's, a's to its engine's
     ``execute``; two saturated rounds of the fair queue (quantum 16) serve
     big 3 : 1 against a; no plan built after the warm-up; a write merged
     into a; admitting b evicts a (the coldest), resident bytes within the
     budget after every admit; evicting b gives at least 0.9 of its
     ``device_bytes`` back to ``memory_allocated``; a re-admitted shows the
     write, its lanes equal to a fresh build of the merged COO; a scripted
     fault in a's bfs opens a's breaker and leaves big's closed. (2) A
     ``save_version`` snapshot of phase 17's engine booting a two-replica
     ``FleetRouter.from_checkpoint`` (bfs, sssp): after ``warmup``, 64 bfs
     and 16 sssp reads from 4 client threads, equal to phase 17's lanes,
     both replicas routed to, no plan built; one write fanned out to
     replica 1, the edge one hop on both; replica 1 killed through
     ``replica.death``, ``supervise_once`` replaces it from the home's COO
     and its lanes equal the home's. (3) ``FleetRouter.from_recovery`` of
     phase 17's scale-18 directory (2 x 2, two replicas), one acknowledged
     write, the home killed: ``supervise_once`` promotes the survivor at
     the WAL frontier and rebuilds the dead slot from checkpoint and WAL,
     equal to the new home, the write visible on both. Neither K1 nor K2
     runs.
 20. procfleet: the process fleet (``serve/procfleet.py``,
     ``_procworker.py``, ``frame.py``, ``ipc.py``) on a ``save_version``
     snapshot of an unsharded engine (bfs, sssp; phase 17's weight draw)
     over phase 10's scale-18 graph, the cut from phase 19's scale 20
     (PERF.md §4) (it fails past 90 s; it removes its directory). The
     card's free bytes (``mem_get_info``) after ``empty_cache``, then
     (1) ``ProcessFleet.from_checkpoint`` of two child processes on the
     card (1 x 1, bfs + sssp, each its own CUDA context), under the run's
     plan store: 24 bfs and 8 sssp reads of the graph's first 16 roots
     with an edge from 4 client threads over IPC (phase 19's 80 cut to 32
     in its mix), equal to the snapshot engine's lanes, both replicas
     routed to, no plan built after the children's warm-up; requests/s
     beside phase 19's thread fleet (at scale 20); (2) one insert through ``submit_update``: the home merges and
     logs it, spools ``save_version``, replica 1 swaps from the file, the
     edge one hop on both; (3) replica 1 SIGKILLed through the router's
     ``ProcessFaultPlan``: the card's free bytes rise by at least 0.9 of
     its ``device_bytes``, ``supervise_once`` respawns it from checkpoint
     and WAL, its lanes equal the home's, the write included; (4) the home
     SIGSTOPped: the heartbeat timeout (2.5 s) detects it, ``supervise_once``
     promotes replica 1 at the WAL frontier over IPC (the write visible
     there) and respawns the stopped slot. The largest heartbeat age seen
     for each replica is printed. K1 and K2 launch 0 times in this process
     (the children run the serving code of phases 17-19).
 21. shard: sharded serving (``serve/shard.py``, ``_shardworker.py``) on
     phase 17's inputs (it fails past 90 s; its home under ``build/`` is
     removed). (1) ``ShardedEngine.build`` of phase 8's scale-20 graph
     (phase 17's weights and F = 64 features) over 2 row slabs in this
     process on the card (bfs, sssp, propagate; warmed at widths 1-16):
     bfs parents, levels and ``batch_niter`` and sssp distances for phase
     17's 16 roots bit for bit equal to phase 17's lanes, propagate's
     features within rtol 1e-4 and 1e-4 of their largest magnitude; each
     slice's ``device_bytes`` beside phase 17's unsharded engine's; bfs and
     sssp again under forced ``dense`` and ``sparse`` frontiers (the same
     answers), the encodings chosen hop by hop and the wire bytes by
     encoding in each mode. (2) A ``Server`` over it (``serve()``): 13 bfs
     and 3 sssp reads (16, phase 19's 4 : 1 mix as near as 16 allows)
     equal to phase 17's lanes; one insert through ``submit_update``
     acknowledged with the frontier vector at [1, 1] and the edge one hop
     away from either end; ``checkpoint_now`` delegated to the slices;
     slice 0 killed, the next read healed by a whole-batch replay equal to
     before, one replacement, slice 1 untouched. (3) Two ``_shardworker``
     children on the card (each its own CUDA context) over phase 17's
     scale-18 graph (the process step's cut, PERF.md §4; unit-to-15
     weights): one bfs and one sssp batch equal to an unsharded
     ``GraphEngine`` built on the card from the same COO; slice 0
     SIGKILLed, the card's free bytes rise by at least 0.9 of its
     ``device_bytes``, the batch replays equal, no plan built after the
     warm-up; one two-phase write; ``ShardedEngine.recover(mode="local")``
     of the same home equal (``to_host_coo``) to the process engine's. K1
     and K2 launch 0 times in this process.
 22. net: the network front door (``serve/net/``) over a ``Server`` on
     phase 17's scale-20 engine, rebuilt from the host arrays (bfs, sssp;
     phase 17's weights; widths 1-16, SLO deadline 10 s), telemetry on; a
     ``NetFrontend`` on an ephemeral port (it fails past 60 s; no child
     process). (1) 16 bfs and 16 sssp single-root submits over 4
     ``NetClient`` connections and one ``submit_many`` of 4 bfs roots (a
     frame holds 64 MiB, a scale-20 bfs reply 8 MiB), every answer bit for
     bit equal to phase 17's lanes and to ``Server.submit``'s; requests/s,
     ``serve.net.bytes_in`` / ``bytes_out``, no reply dropped. (2) An
     unknown kind answers ``invalid`` (``ValueError``), a 1 ms deadline
     ``timeout`` (``TimeoutError``), a 16-root bfs ``submit_many`` past the
     frame cap ``unavailable`` (``RuntimeError``), and a second frontend
     with ``max_conns=1`` rejects a second hello with ``backpressure``
     (``BackpressureError``). (3) Phase 17's absent churn pair inserted
     with ``submit_update`` over the wire, then a bfs from one end until
     the other is at level 1: submit to visible ms. (4) ``loadgen.run``
     over the Server: seeded Poisson arrivals at 24 requests/s (about 0.8
     of phase 18's rate) over 8 connections for 5 s, roots from phase 17's
     16, deadline 10 s, every request traced: achieved requests/s, p50 /
     p99, availability, status counts, no plan built, no stranded future,
     the mean ms of each trace stage (``net_accept``, ``net_read``,
     ``queue_wait``, ``assemble``, ``execute``, ``net_write``); the run's
     gate ``ok``. K1 and K2 launch 0 times.
 23. multiproc: the grid over several processes (``parallel/multihost.py``)
     on the card (it fails past 60 s; its directory under ``build/`` is
     removed). The parent writes phase 8's scale-20 graph (phase 17's
     weights 1..15, a seeded x of integers 0..7 in float32, so that every
     plus_times sum is exact whatever the order of ``index_add_`` on the
     card) and phase 5's scale-13 graph as
     ``.npy`` files beside phase 13's scale-18 Matrix Market file, and runs
     every step on a one-process 2 x 2 grid on the card for the results to
     match; then ``multihost.launch`` starts two ranks (each its own CUDA
     context on the card, gloo on CUDA tensors: NCCL takes one rank a card)
     that run the same steps on the global 2 x 2 grid, each holding its two
     tiles: ``dist_spmv`` plus_times and min_plus at scale 20 (a warm-up,
     then 5 calls timed, the exchange's bytes, collectives and seconds a
     call), ``spgemm_mxu`` (``spgemm_auto``'s mxu tier: ``summa_spgemm_mxu``
     with its overflow rerun) min_plus at scale 13 (K1 launched on both
     ranks as often as on one process, the same capacities), ``spgemm`` (ESC, min_plus) at
     scale 13, ``read_mm_distributed`` of the scale-18 file (each rank
     parses its byte range); every result bit for bit equal to the
     one-process grid's (tile by tile digests; the read's entries sorted
     within each tile), each rank's matrix bytes beside the one-process
     matrix's. K1's launches are the ranks'; the parent launches none while
     they run, K2 never.
The plan store of the whole run is ``build/chip_smoke_plans`` (probing off,
so phases 1-14 route as without a store), removed at the end. Each path
runs with every launch count set to 0 just before it and read just after.
Then the ``kernels`` line (K1's launches by path: main_path, spgemm_general,
spgemm_windowed, apps, graph_input, mesh3d, tuner, obs, engine, server,
fleet, procfleet, shard, net, multiproc; K2's: k2_path, net)
and, last, ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA card it exits 1
before printing any result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from combblas_tpu_torch import (
    DEFAULT_SEQ_TIERS,
    MAX_MIN,
    MIN_PLUS,
    PAD_ROOT,
    PLUS_TIMES,
    SELECT2ND_MAX,
    SELECT2ND_MIN,
    DenseParMat,
    DistMultiVec,
    DistVec,
    EllParMat,
    Grid,
    Grid3D,
    SemanticGraph,
    SpParMat3D,
    SpParMat,
    awpm,
    batch_traversed_edges,
    bfs,
    bfs_batch,
    bfs_batch_compact,
    bfs_diropt,
    bfs_diropt_auto,
    bc_batch,
    bc_batch_dense,
    bc_batch_dense_lanes,
    bfs_single,
    checkpoint,
    from_device_coo,
    graph500_edges,
    graph500_edges_native,
    isolated_compression_perm,
    kernel1_device,
    permute_vertices,
    read_binary,
    read_mm,
    read_mm_distributed,
    read_vec,
    rmat_edges,
    write_binary,
    write_mm,
    write_vec,
    build_graph,
    build_structures,
    choose_spgemm_tier,
    connected_components,
    csc_tiles,
    dense_support_nnz,
    dense_to_sptuples,
    densify_combine,
    dist_spmspv_masked,
    dist_spmv,
    dist_spmv_ell_masked_multi,
    dist_spmv_ell_multi,
    estimate_flops,
    expand_ranges,
    filtered_bfs,
    filtered_mis,
    flat_to_tuples_arrays,
    flat_to_tuples_arrays_reference,
    hash_table_capacity,
    lacc,
    maximal_matching,
    maximum_matching,
    mcl,
    mcl_prune_recovery_select,
    mem_efficient_spgemm,
    minimum_degree_ordering,
    mis,
    num_components,
    ones_f32,
    packed_windows,
    packed_windows_2d,
    pad_features,
    pagerank,
    pagerank_batch,
    parse_tier_spec,
    propagate_features,
    pseudo_peripheral_vertex,
    rcm_ordering,
    rmat_symmetric_coo_host,
    row_invdeg,
    semiring_matmul,
    semiring_matmul_reference,
    single_traversed_edges,
    sparsify,
    sparsify_windowed,
    spgemm,
    spgemm3d,
    spgemm_auto,
    spgemm_scan,
    spgemm_windowed,
    spmm_khop,
    sssp,
    sssp_batch,
    subsref,
    summa_spmm,
    traversed_edges,
    triangle_count,
    upload_csc_companion,
    validate_bfs_device,
)
from combblas_tpu_torch import _build, obs
from combblas_tpu_torch.io.mm import _mm_header_span, read_mm_range
from combblas_tpu_torch.models.bfs import bfs_levels_instrumented
from combblas_tpu_torch.obs import export as obs_export
from combblas_tpu_torch.obs.fleetlog import FleetLog
from combblas_tpu_torch.obs.recorder import FlightRecorder
from combblas_tpu_torch.utils import timers
from combblas_tpu_torch.ops.dense_to_tuples import _PANEL_ROWS, _panels
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS as K2_VARIANTS
from combblas_tpu_torch.ops.semiring_matmul import KINDS, TILE, main_loop_counts
from combblas_tpu_torch.ops.spgemm import densify, mask_rows
from combblas_tpu_torch.models import bfs as bfs_mod
from combblas_tpu_torch.models import mcl as mcl_mod
from combblas_tpu_torch.models import propagate as propagate_mod
from combblas_tpu_torch.models.matching import maximum_matching_device
from combblas_tpu_torch.parallel import ellmat
from combblas_tpu_torch.parallel import mesh3d as mesh3d_mod
from combblas_tpu_torch.parallel import multihost
from combblas_tpu_torch.parallel.mesh3d import spgemm3d_windowed
from combblas_tpu_torch.parallel.spgemm import (
    _PALLAS_KINDS,
    _colmajor_with_starts,
    _dense_col_panel,
    _mxu_dot,
    _pad128,
    _shift_rowblock,
    coo_has_duplicates,
    spgemm_mxu,
)
from combblas_tpu_torch.parallel.spmm import SPMM_BACKENDS, dist_spmm_ell, resolve_spmm_backend
from combblas_tpu_torch.parallel.spmv import spmspv_counts
from combblas_tpu_torch.tuner import config as tuner_config
from combblas_tpu_torch.tuner import probe as tuner_probe
from combblas_tpu_torch.tuner import store as tuner_store
from combblas_tpu_torch.utils import threefry
from combblas_tpu_torch.dynamic import (
    REFRESH_KINDS,
    DeltaBatch,
    DeltaBuffer,
    apply_delta,
    open_wal,
    recover,
)
from combblas_tpu_torch.dynamic import merge as merge_mod
from combblas_tpu_torch.obs import trace as obs_trace
from combblas_tpu_torch.serve import (
    BackpressureError,
    EnginePool,
    FleetRouter,
    GraphEngine,
    NetClient,
    NetFrontend,
    ProcessFleet,
    ReplicaDeadError,
    Request,
    ServeConfig,
    Server,
    ShardedEngine,
    assemble,
    scatter,
)
from combblas_tpu_torch.serve.net import loadgen

SCALE, EDGEFACTOR, GRAPH_SEED, WEIGHT_SEED = 13, 16, 42, 7
FULL = 1 << SCALE  # the mxu tier's largest tile: 8192
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_SOURCE = "combblas_tpu_torch/csrc/semiring_mm.cu"
TPU_KERNEL = "combblas_tpu/ops/pallas_kernels.py:33"
K2_SOURCE = "combblas_tpu_torch/csrc/dense_to_tuples.cu"
K2_TPU_KERNEL = "combblas_tpu/ops/pallas_sparsify.py:109"
SOURCES = ["semiring_mm", "dense_to_tuples"]
IDENTITY = {"min_plus": float("inf"), "max_plus": -float("inf"),
            "max_min": -float("inf"), "plus_times": 0.0}
# K1's exact cases: a small, a ragged and the full shape, then shapes on
# either side of its tiles
K1_SHAPES = ((256, 256, 256), (1000, 777, 1234), (FULL, FULL, FULL), (128, 128, 128),
             (129, 8, 127), (1024, 777, 1024), (FULL, FULL - 1, FULL))
K1_SPECIAL_SHAPES = ((256, 256, 256), (200, 136, 72))
# plus_times' wide-integer cases (tiled, edge): k <= 4096 keeps every sum
# of |a| <= 4095 times {-1, 0, 1} below 2^24, so any order is exact
K1_WIDE_INT_SHAPES = ((4096, 4096, 4096), (1000, 4095, 1234))
# cell values of the special cases and their odds (NaN rare enough that
# most outputs stay finite)
SPECIALS = (float("nan"), 0.0, -0.0, float("inf"), -float("inf"), 1.0, -1.0, 2.5, 3.0)
SPECIAL_ODDS = (0.002, 0.15, 0.15, 0.01, 0.01, 0.17, 0.17, 0.17, 0.168)
LANES_PER_SM_CLOCK = 4 * 32  # four schedulers, one 32-lane warp instruction each
# the BFS path: the defaults of the reference's benchmark script
BFS_SCALE, BFS_EDGEFACTOR, BFS_NROOTS = 20, 16, 256
BFS_CHECK_LANES = 4  # lanes validated on the device and against the host BFS
BFS_REPS = 3
SEQ_ROOTS = 16  # sequential roots, as the reference's benchmark script times them
SEQ_DENSE_ROOTS = 2  # of those, also searched with tiers "" (always dense)
# the SpParMat path: timed calls a search, PageRank's bound of its L1
# distance to float64, the personalised lanes held against float64
SPMAT_REPS = 3
PAGERANK_L1_BOUND = 1e-4
PAGERANK_W = 16
PAGERANK_CHECK_LANES = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_with_clock(fn, reps: int, tail_ms: float = 1500.0) -> tuple[float, dict]:
    """``time_cuda_ms`` of ``fn``, and the SM clock, power draw and
    temperature ``nvidia-smi`` reads at the end of the timed loop, while
    about ``tail_ms`` more of the same calls (not timed) keep the card
    busy."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()  # warm-up, and the length of one call
    end.record()
    end.synchronize()
    tail = max(1, math.ceil(tail_ms / max(start.elapsed_time(end), 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    for _ in range(tail):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    torch.cuda.synchronize()
    clock, power, temp = (float(x) for x in smi.stdout.splitlines()[0].split(","))
    return start.elapsed_time(end) / reps, {
        "sm_clock_mhz": clock, "power_draw_w": power, "temperature_c": temp}


def bound(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for an m×k by k×n semiring product: 2mnk operations at
    the float32 peak, or each operand read and the output written once."""
    ops_ms = 2.0 * m * n * k / PEAK_F32_OPS * 1e3
    bytes_ms = 4.0 * (m * k + k * n + m * n) / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def issue_floor_ms(m: int, k: int, n: int, insns_per_step: float, clock_mhz: float) -> float:
    """Least time to issue m·n·k semiring steps at ``insns_per_step`` warp
    instructions each (the kernel's main loop, from its machine code), one
    per scheduler a clock on every SM at ``clock_mhz``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return m * n * k * insns_per_step / (sms * LANES_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    same = (got == want) | (got.isnan() & want.isnan())
    diff = torch.where(same, 0.0, (got - want).abs())
    return float(diff.max()) if diff.numel() else 0.0


def operands(kind: str, m: int, k: int, n: int, seed: int, dev):
    """Integer-valued float32 operands in [-8, 8], drawn on ``dev`` from a
    seeded torch generator, a tenth of the cells set to the fold's
    identity (as the densified tiles hold it)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for shape in ((m, k), (k, n)):
        x = torch.randint(-8, 9, shape, generator=gen, device=dev).float()
        x[torch.rand(shape, generator=gen, device=dev) < 0.1] = IDENTITY[kind]
        out.append(x)
    return out


def special_operands(m: int, k: int, n: int, seed: int, dev):
    """float32 operands drawn from ``SPECIALS`` with ``SPECIAL_ODDS``."""
    rng = np.random.default_rng(seed)
    odds = np.array(SPECIAL_ODDS) / sum(SPECIAL_ODDS)
    values = np.array(SPECIALS, np.float32)
    return [torch.from_numpy(rng.choice(values, size=shape, p=odds)).to(dev)
            for shape in ((m, k), (k, n))]


def wide_int_operands(m: int, k: int, n: int, seed: int, dev):
    """A with integers in [-4095, 4095] (up to 12 significant bits, more
    than TF32's 11 or bf16's 8 keep), B in {-1, 0, 1}."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-4095, 4096, (m, k)).astype(np.float32)
    b = rng.integers(-1, 2, (k, n)).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def offset_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` one element into its buffer, so that its
    address is not 16-byte aligned."""
    store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = store[1:].view(x.shape)
    view.copy_(x)
    return view


def launch_k1(kind: str, a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, str]:
    """One K1 launch through its wrapper; the result and the instantiation
    that ran."""
    before = semiring_matmul.launches
    got = semiring_matmul(kind, a, b)
    torch.cuda.synchronize()
    if semiring_matmul.launches != before + 1:
        raise AssertionError(f"{kind}: the kernel did not launch")
    return got, semiring_matmul.last_variant


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision must be 'highest'")
    emit({"phase": "card", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False,
          "float32_matmul_precision": "highest"})
    return card


def phase_build() -> dict:
    """Build every source; then K1's main-loop instruction counts per kind
    and instantiation, which ``phase_times`` turns into ``floor_ms``."""
    report = _build.build(SOURCES)
    ptxas = {name: [ln.strip() for ln in report[name]["log"].splitlines()
                    if "registers" in ln or "spill" in ln] for name in SOURCES}
    emit({"phase": "build", "seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": ptxas})
    loops = main_loop_counts()
    for kind in KINDS:
        if set(loops.get(kind, ())) != {"tiled", "edge"}:
            raise AssertionError(f"K1 {kind}: main loops not found in the machine code")
        emit({"phase": "build", "kernel": f"semiring_mm_{kind}", "tile": TILE,
              "main_loop": loops[kind]})
    return loops


def phase_kernels(dev) -> dict:
    """Each kind at ``K1_SHAPES`` with exact equality, and on special
    values; then plus_times on non-integer data. Returns per kind the
    full-shape max error and plain-version time."""
    full = {}
    for kind in KINDS:
        variants = set()
        for shape in K1_SHAPES:
            a, b = operands(kind, *shape, seed=sum(shape), dev=dev)
            got, variant = launch_k1(kind, a, b)
            variants.add(variant)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = semiring_matmul_reference(kind, a, b)
            end.record()
            end.synchronize()
            err = max_abs_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{kind} {shape}: kernel != plain (max err {err})")
            emit({"phase": "kernels", "kind": kind, "shape": shape, "variant": variant,
                  "equal": True, "max_abs_err": err})
            if shape == (FULL, FULL, FULL):
                full[kind] = {"max_abs_err": err, "plain_ms": start.elapsed_time(end)}
            del a, b, got, want
        for shape in K1_SPECIAL_SHAPES:
            a, b = special_operands(*shape, seed=sum(shape) + KINDS.index(kind), dev=dev)
            got, variant = launch_k1(kind, a, b)
            variants.add(variant)
            want = semiring_matmul_reference(kind, a, b)
            nan = want.isnan()
            if not (torch.equal(got.isnan(), nan) and torch.equal(
                    got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])):
                raise AssertionError(f"{kind} {shape} specials: kernel != plain")
            emit({"phase": "kernels", "kind": kind, "case": "specials", "shape": shape,
                  "variant": variant, "nan_cells": int(nan.sum()), "cells": nan.numel(),
                  "equal": True, "max_abs_err": max_abs_err(got, want)})
        if variants != {"tiled", "edge"}:
            raise AssertionError(f"{kind}: instantiations run {variants}")
    check_plus_times_wide_int(dev)
    check_plus_times_float(dev)
    torch.cuda.empty_cache()
    return full


def check_plus_times_wide_int(dev) -> None:
    """plus_times on ``wide_int_operands``, equal to the plain version at a
    tiled and an edge shape: rounding the inputs to TF32 or bf16 would
    change the sums."""
    for shape, expect in zip(K1_WIDE_INT_SHAPES, ("tiled", "edge")):
        a, b = wide_int_operands(*shape, seed=sum(shape), dev=dev)
        got, variant = launch_k1("plus_times", a, b)
        if variant != expect:
            raise AssertionError(f"plus_times wide integers {shape}: ran {variant}")
        want = semiring_matmul_reference("plus_times", a, b)
        if not torch.equal(got, want):
            raise AssertionError(f"plus_times wide integers {shape}: kernel != plain "
                                 f"(max err {max_abs_err(got, want)})")
        emit({"phase": "kernels", "kind": "plus_times", "case": "wide integers",
              "shape": shape, "variant": variant, "equal": True, "max_abs_err": 0.0,
              "max_abs_out": float(want.abs().max())})
        del a, b, got, want


def check_plus_times_float(dev, size: int = 4096) -> None:
    """plus_times on uniform [-1, 1] data against the float64 product:
    every cell within K · 2^-24 · Σ|a||b| (the float32 rounding of a
    K-term sum, whatever its order), and the tiled and edge instantiations
    bit-equal (both fold k in order with one FMA chain)."""
    m = k = n = size
    rng = np.random.default_rng(17)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(dev)
            for shape in ((m, k), (k, n)))
    got, variant = launch_k1("plus_times", a, b)
    got_edge, variant_edge = launch_k1("plus_times", offset_copy(a), offset_copy(b))
    if (variant, variant_edge) != ("tiled", "edge"):
        raise AssertionError(f"plus_times float: instantiations {variant}, {variant_edge}")
    want = a.double() @ b.double()
    tol = k * 2.0**-24 * (a.double().abs() @ b.double().abs())
    err = (got.double() - want).abs()
    if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError("plus_times float: error above K * 2^-24 * sum|a||b|")
    if not torch.equal(got, got_edge):
        raise AssertionError("plus_times float: tiled and edge results differ")
    emit({"phase": "kernels", "kind": "plus_times", "case": "uniform[-1,1] vs float64",
          "shape": [m, k, n], "variants": [variant, variant_edge],
          "tolerance": "K * 2^-24 * sum|a||b| per cell", "within_tolerance": True,
          "max_abs_err": float(err.max()), "max_err_over_tolerance": float((err / tol).max()),
          "tiled_equals_edge": True})


def k2_bound(cells: int, slots: int) -> tuple[float, str]:
    """Least time for K2: each input cell read once (4 bytes) and each
    output slot written once (index and value, 8 bytes); it does no
    arithmetic to speak of, so bytes bound it."""
    return (4.0 * cells + 8.0 * slots) / PEAK_BYTES * 1e3, "bytes"


def random_dense(shape, density: float, seed: int, dev) -> torch.Tensor:
    """float32 cells in 1..99 with probability ``density``, else 0, from a
    seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand(shape, generator=g, device=dev) < density
    vals = torch.randint(1, 100, shape, generator=g, device=dev).to(torch.float32)
    return torch.where(keep, vals, 0.0)


def greedy_case(dev) -> torch.Tensor:
    """Four panels of 32 flat rows with 3000 / 100 / 3000 / 100 nonzeros:
    at capacity 64 the greedy placement writes panels 0, 1 and 3."""
    rng = np.random.default_rng(11)
    flat = np.zeros(4 * 4096, np.float32)
    for p, k in enumerate((3000, 100, 3000, 100)):
        flat[p * 4096 + rng.choice(4096, size=k, replace=False)] = rng.integers(1, 100, k)
    return torch.from_numpy(flat.reshape(128, 128)).to(dev)


def check_k2(case: str, xf: torch.Tensor, *, zero: float = 0.0, capacity: int,
             panel_rows: int = _PANEL_ROWS) -> dict:
    """Each instantiation of K2 against its plain version on one input: the
    whole idx and vals arrays (vals as bits, so that NaN compares), total
    and end_row equal."""
    kw = dict(zero=zero, capacity=capacity, panel_rows=panel_rows)
    wi, wv, wt, we = flat_to_tuples_arrays_reference(xf, **kw)
    before = flat_to_tuples_arrays.launches
    errs = []
    for variant in K2_VARIANTS:
        gi, gv, gt, ge = flat_to_tuples_arrays(xf, variant=variant, **kw)
        torch.cuda.synchronize()
        if flat_to_tuples_arrays.last_variant != variant:
            raise AssertionError(f"K2 {case}: {variant} did not launch")
        if not (int(gt) == int(wt) and int(ge) == int(we) and torch.equal(gi, wi)
                and torch.equal(gv.view(torch.int32), wv.view(torch.int32))):
            raise AssertionError(f"K2 {case} ({variant}): kernel != plain")
        errs.append(max_abs_err(gv, wv))
    if flat_to_tuples_arrays.launches != before + len(K2_VARIANTS):
        raise AssertionError(f"K2 {case}: launch count off")
    flat_to_tuples_arrays.launches = before  # checks are not a path's launches
    end = int(we) * 128
    out = {"phase": "compaction", "case": case, "shape": list(xf.shape),
           "capacity": capacity, "panel_rows": panel_rows, "total": int(wt),
           "end_row": int(we), "live": int((wi[:end] >= 0).sum()),
           "variants": list(K2_VARIANTS), "equal": True, "max_abs_err": max(errs)}
    emit(out)
    return out


def time_k2(case: str, xf: torch.Tensor, *, reps: int, zero: float = 0.0, capacity: int,
            panel_rows: int = _PANEL_ROWS) -> dict:
    """K2's instantiations timed in turns (single, two_pass, two_pass,
    single; ``reps`` calls each), one line per instantiation with its time,
    bound, share of the bound and achieved rate (the bound's bytes over the
    time). Returns ``{variant: line}`` and the default choice under
    ``"default"``."""
    kw = dict(zero=zero, capacity=capacity, panel_rows=panel_rows)
    before = flat_to_tuples_arrays.launches
    flat_to_tuples_arrays(xf, **kw)
    default = flat_to_tuples_arrays.last_variant
    turns = {v: [] for v in K2_VARIANTS}
    for variant in (*K2_VARIANTS, *K2_VARIANTS[::-1]):
        turns[variant].append(
            time_cuda_ms(lambda: flat_to_tuples_arrays(xf, variant=variant, **kw), reps))
    flat_to_tuples_arrays.launches = before  # timing launches are not a path's
    slots = _panels(xf, capacity, panel_rows)[1] * 128  # every output slot is stored once
    bound_ms, bound_by = k2_bound(xf.numel(), slots)
    out = {"default": default}
    for variant, times in turns.items():
        ms = sum(times) / len(times)
        out[variant] = {
            "phase": "compaction", "case": case, "shape": list(xf.shape),
            "panel_rows": panel_rows, "capacity": capacity, "variant": variant,
            "default": variant == default, "ms": ms, "turns_ms": times,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "gb_per_s": (4.0 * xf.numel() + 8.0 * slots) / (ms / 1e3) / 1e9}
        emit(out[variant])
    return out


def phase_compaction(dev) -> None:
    """K2's instantiations against the plain version at a small (with NaN
    and -0.0 cells), a ragged (panels of gcd(8000, 8192) = 64 rows) and a
    multi-panel shape, and on the greedy-drop case; then both timed in
    turns over a density sweep at 8192 x 8192, at 16384 x 16384 (5%), with
    8-row panels and with one panel of 2^15 rows. Each capacity is the exact
    count, except where the case says."""
    small = random_dense((64, 128), 0.3, 1, dev)
    small[0, :8] = torch.tensor([float("nan"), -0.0] * 4)
    check_k2("small", small, capacity=3000)
    check_k2("ragged", random_dense((8000, 128), 0.3, 2, dev), capacity=400_000)
    multi = random_dense((8 * 8192, 128), 0.2, 3, dev)
    check_k2("multi-panel", multi, capacity=int((multi != 0).sum()))
    check_k2("multi-panel-half-capacity", multi, capacity=int((multi != 0).sum()) // 2)
    greedy = greedy_case(dev)
    for cap in (64, 3100):
        check_k2(f"greedy-cap{cap}", greedy, capacity=cap, panel_rows=32)
    del small, multi, greedy
    for pct in (0.0, 0.1, 5.0, 20.0, 50.0, 100.0):
        x = random_dense((FULL, FULL), pct / 100, 4, dev).view(-1, 128)
        cap = int((x != 0).sum())
        check_k2(f"sweep-{FULL}-{pct}%", x, capacity=cap)
        time_k2(f"sweep-{FULL}-{pct}%", x, capacity=cap, reps=10)
        del x
    x = random_dense((FULL, FULL), 0.05, 6, dev).view(-1, 128)
    cap = int((x != 0).sum())
    for case, rows in (("pr8", 8), ("tall-panel", 1 << 15)):
        check_k2(f"{case}-{FULL}-5.0%", x, capacity=cap, panel_rows=rows)
        time_k2(f"{case}-{FULL}-5.0%", x, capacity=cap, panel_rows=rows, reps=5)
    x = random_dense((2 * FULL, 2 * FULL), 0.05, 5, dev).view(-1, 128)
    cap = int((x != 0).sum())
    check_k2(f"{2 * FULL}-5.0%", x, capacity=cap)
    time_k2(f"{2 * FULL}-5.0%", x, capacity=cap, reps=5)
    del x
    torch.cuda.empty_cache()


def dense_plain_product(sr, r, c, v, n: int, dev) -> torch.Tensor:
    """The graph's dense n×n matrix, duplicates folded with ``sr.add`` by a
    scatter on the card, squared with the plain semiring product."""
    zero = float(sr.zero_fn(torch.float32))
    flat = torch.from_numpy(r * n + c).to(dev)
    vals = torch.from_numpy(v).to(dev)
    dense = torch.full((n * n,), zero, device=dev)
    if sr.add_kind == "sum":
        dense.index_add_(0, flat, vals)
    else:
        reduce = "amin" if sr.add_kind == "min" else "amax"
        dense.scatter_reduce_(0, flat, vals, reduce=reduce, include_self=False)
    dense = dense.view(n, n)
    want = semiring_matmul_reference(_PALLAS_KINDS[sr.name], dense, dense)
    if sr.add_kind == "sum" and float(want.abs().max()) >= 2**24:
        # exactness in any summation order needs every partial sum < 2**24
        raise AssertionError("plus_times sums reach 2**24; exact comparison void")
    return want


def phase_main_path(dev) -> dict:
    """The counted run: spgemm_auto for each semiring with the launch
    count set to 0 just before and read just after; then the checks and
    the timed runs."""
    r, c = rmat_symmetric_coo_host(GRAPH_SEED, SCALE, EDGEFACTOR)
    v = np.random.default_rng(WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(np.float32)
    grid = Grid.make(1, 1, device=dev)
    p = grid.pr
    semirings = (MIN_PLUS, MAX_MIN, PLUS_TIMES)

    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    runs = {}
    for sr in semirings:
        before = semiring_matmul.launches
        t0 = time.perf_counter()
        A = SpParMat.from_global_coo(grid, r, c, v, FULL, FULL, dedup_sr=sr)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tier = choose_spgemm_tier(sr, A, A)
        C = spgemm_auto(sr, A, A)
        torch.cuda.synchronize()
        runs[sr.name] = (A, C, tier, semiring_matmul.launches - before, load_s)
    launches = semiring_matmul.launches

    per_kind = {}
    for sr in semirings:
        A, C, tier, n_launch, load_s = runs[sr.name]
        if tier != "mxu":
            raise AssertionError(f"{sr.name}: routed to {tier}, not mxu")
        nnz = int(C.getnnz())
        cap0 = 1 << (max(A.capacity, 64) - 1).bit_length()
        attempts = 1 if int(C.nnz.max()) <= cap0 else 2
        if sr.name != "plus_times" and n_launch != attempts * p**3:
            raise AssertionError(
                f"{sr.name}: {n_launch} kernel launches for {attempts} attempts"
            )
        # exact check against the dense plain product
        zero = float(sr.zero_fn(torch.float32))
        want = dense_plain_product(sr, r, c, v, FULL, dev)
        wr, wc = torch.nonzero(want != zero, as_tuple=True)
        if nnz != wr.numel():
            raise AssertionError(f"{sr.name}: nnz {nnz} != plain {wr.numel()}")
        t = C.local_tile(0, 0)
        for got, exp, name in ((t.rows[:nnz], wr, "rows"), (t.cols[:nnz], wc, "cols"),
                               (t.vals[:nnz], want[wr, wc], "vals")):
            if not torch.equal(got.to(exp.dtype), exp):
                raise AssertionError(f"{sr.name}: {name} differ from the plain product")
        if not bool(torch.isfinite(t.vals[:nnz]).all()):
            raise AssertionError(f"{sr.name}: non-finite output values")
        del want, wr, wc
        torch.cuda.empty_cache()
        # timed runs (the counted run above was the warm-up)
        torch.cuda.reset_peak_memory_stats()
        reps = 3
        t0 = time.perf_counter()
        ms = time_cuda_ms(lambda: spgemm_auto(sr, A, A), reps)
        host_s = (time.perf_counter() - t0) / (reps + 1)
        per_kind[sr.name] = {
            "tier": tier, "nnz_in": int(A.getnnz()), "load_s": load_s, "nnz_out": nnz,
            "attempts": attempts, "kernel_launches": n_launch,
            "out_capacity": C.capacity, "ms": ms, "host_s_per_call": host_s,
            "nnz_out_per_s": nnz / (ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "layers_ms": layer_times(sr, A, C.capacity),
        }
        emit({"phase": "main_path", "semiring": sr.name, "exact": True,
              **per_kind[sr.name]})
    mats = {name: (run[0], run[1]) for name, run in runs.items()}
    return {"launches": launches, "per_kind": per_kind, "mats": mats, "host": (r, c, v)}


def stage_product(sr, da: torch.Tensor) -> torch.Tensor:
    """The mxu tier's stage product ``da ⊗ da``: K1 for the tropical
    kinds, ``torch.matmul`` for plus_times, as ``summa_spgemm_mxu``."""
    kind = _PALLAS_KINDS[sr.name]
    if kind == "plus_times":
        return _mxu_dot(da, da, "f32", da.dtype)
    return semiring_matmul(kind, da, da)


def mxu_accumulator(sr, A: SpParMat) -> torch.Tensor:
    """The mxu tier's dense accumulator for A·A on a 1×1 grid, built as
    ``summa_spgemm_mxu`` builds it: densify, stage product, fold."""
    zero = float(sr.zero_fn(A.dtype))
    pm = _pad128(A.local_rows)
    prod = stage_product(sr, densify(A.local_tile(0, 0), pm, pm, zero))
    return sr.add(torch.full_like(prod, zero), prod)


def nonzero_gather(x: torch.Tensor, zero: float):
    """The nearest PyTorch call to K2: ``torch.nonzero`` of the mask plus
    the value gather (int64 indices, no panel layout)."""
    flat = x.view(-1)
    nz = torch.nonzero(flat != zero).squeeze(1)
    return nz, flat[nz]


def op_breakdown(fn, reps: int = 5) -> dict:
    """Device time per call of each operator and of each kernel of ``fn``,
    from a ``torch.profiler`` trace of ``reps`` calls after a warm-up
    (``key_averages``' own device time: an ``aten::`` operator's is that of
    the kernels it launched; the kernel list counts the same time again,
    by kernel, and also holds the kernels launched outside PyTorch's
    operators, such as K2's; only records of the device count as kernels:
    the host's "Command Buffer Full" waits also carry device time). Where
    the profiler reports no device time,
    each call is timed whole with CUDA events instead and the line says
    so. ``events_ms`` is each call timed whole with CUDA events, and
    ``coverage`` the share of it that the traced kernels account for: a
    trace that lost device records shows as a coverage well below 1."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for e in prof.key_averages():
        own = getattr(e, "self_device_time_total", None)
        if own is None:
            own = getattr(e, "self_cuda_time_total", 0.0)
        if own <= 0 or e.key.startswith("Activity Buffer"):  # the tracer's own entries
            continue
        row = {"calls": e.count / reps, "device_ms": own / 1e3 / reps}
        if e.key.startswith("aten::"):
            ops.append({"op": e.key, **row})
        elif e.device_type == DeviceType.CUDA:
            kernels.append({"kernel": e.key[:120], **row})
    if not kernels:
        return {"profiler_device_time": False, "events_ms": time_cuda_ms(fn, reps)}
    ops.sort(key=lambda r: -r["device_ms"])
    kernels.sort(key=lambda r: -r["device_ms"])
    kernels_ms = sum(k["device_ms"] for k in kernels)
    events_ms = time_cuda_ms(fn, reps)
    return {"profiler_device_time": True, "ops": ops, "kernels": kernels,
            "kernels_ms": kernels_ms, "events_ms": events_ms,
            "coverage": kernels_ms / events_ms}


def phase_k2_path(mats: dict) -> dict:
    """The counted run: for each semiring, the mxu accumulator, its exact
    support count (``dense_support_nnz``) as the capacity, and
    ``dense_to_sptuples`` (K2), with every launch count set to 0 just
    before and read just after. Then the checks: the live entries, in slot
    order, equal ``sparsify_windowed``'s and ``sparsify``'s prefixes and
    the main path's ``spgemm_auto`` result. Then the timed layers."""
    semirings = (MIN_PLUS, MAX_MIN, PLUS_TIMES)
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    runs = {}
    for sr in semirings:
        A, _ = mats[sr.name]
        zero = float(sr.zero_fn(A.dtype))
        acc = mxu_accumulator(sr, A)
        cap = int(dense_support_nnz(acc, zero, A.local_rows, A.local_cols))
        t, total = dense_to_sptuples(acc, A.local_rows, A.local_cols, zero=zero, capacity=cap)
        torch.cuda.synchronize()
        runs[sr.name] = (acc, zero, cap, t, total, flat_to_tuples_arrays.last_variant)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}

    per_kind = {}
    for sr in semirings:
        A, C = mats[sr.name]
        acc, zero, cap, t, total, variant = runs.pop(sr.name)
        n_r, n_c = A.local_rows, A.local_cols
        live = t.valid_mask()
        got = (t.rows[live], t.cols[live], t.vals[live])
        if not (int(total) == cap == got[0].numel() == int(t.nnz)):
            raise AssertionError(f"K2 path {sr.name}: total {int(total)}, nnz "
                                 f"{int(t.nnz)}, live {got[0].numel()}, capacity {cap}")
        w, w_total = sparsify_windowed(acc, zero, n_r, n_c, cap)
        s, s_total = sparsify(acc, zero, n_r, n_c, cap)
        c = C.local_tile(0, 0)
        nnz_c = int(C.getnnz())
        for other, o_total, name in ((w, w_total, "sparsify_windowed"),
                                     (s, s_total, "sparsify"), (c, C.nnz.sum(), "spgemm_auto")):
            k = min(cap, other.capacity)
            want = (other.rows[:k], other.cols[:k], other.vals[:k])
            if int(o_total) != cap or k != cap or not all(
                torch.equal(g, x) for g, x in zip(got, want)
            ):
                raise AssertionError(f"K2 path {sr.name}: entries differ from {name}")
        if not bool(torch.isfinite(got[2]).all()):
            raise AssertionError(f"K2 path {sr.name}: non-finite values")
        del w, s, got, t, live
        xf = acc.view(-1, 128)
        chk = check_k2(f"k2-path-{sr.name}", xf, zero=zero, capacity=cap)
        timed = time_k2(f"k2-path-{sr.name}", xf, zero=zero, capacity=cap, reps=20)
        k2 = timed[variant]
        rowcnt = (acc[:n_r, :n_c] != zero).sum(1, dtype=torch.int32)
        ramp = torch.arange(cap, dtype=torch.int32, device=acc.device)
        counted = flat_to_tuples_arrays.launches
        out = {
            "nnz": cap, "nnz_spgemm_auto": nnz_c, "k2_variant": variant, "k2_ms": k2["ms"],
            "k2_ms_other_variant": timed[next(v for v in K2_VARIANTS if v != variant)]["ms"],
            "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
            "max_abs_err": chk["max_abs_err"],
            "support_nnz_ms": time_cuda_ms(
                lambda: dense_support_nnz(acc, zero, n_r, n_c), 10),
            "dense_to_sptuples_ms": time_cuda_ms(
                lambda: dense_to_sptuples(acc, n_r, n_c, zero=zero, capacity=cap), 10),
            "sparsify_windowed_ms": time_cuda_ms(
                lambda: sparsify_windowed(acc, zero, n_r, n_c, cap), 5),
            "sparsify_ms": time_cuda_ms(lambda: sparsify(acc, zero, n_r, n_c, cap), 3),
            # sparsify's owner map, and one of its two cummax scans alone
            "expand_ranges_ms": time_cuda_ms(lambda: expand_ranges(rowcnt, cap), 3),
            "cummax_ms": time_cuda_ms(lambda: torch.cummax(ramp, 0), 3),
            "plain_ms": time_cuda_ms(
                lambda: flat_to_tuples_arrays_reference(xf, zero=zero, capacity=cap), 2),
            "library_ms": time_cuda_ms(lambda: nonzero_gather(acc, zero), 10),
            "library_call": "torch.nonzero(x.view(-1) != zero) + value gather "
                            "(int64 indices, no panel layout)",
        }
        if sr is MIN_PLUS:  # where the extraction step's time goes, op by op
            out["sizing_ops"] = op_breakdown(lambda: dense_support_nnz(acc, zero, n_r, n_c))
            out["dense_to_sptuples_ops"] = op_breakdown(
                lambda: dense_to_sptuples(acc, n_r, n_c, zero=zero, capacity=cap))
        flat_to_tuples_arrays.launches = counted
        per_kind[sr.name] = out
        emit({"phase": "k2_path", "semiring": sr.name, "exact": True, **out})
        del acc, xf, rowcnt, ramp
        torch.cuda.empty_cache()
    return {"launches": launches, "per_kind": per_kind}


def layer_times(sr, A: SpParMat, out_capacity: int) -> dict:
    """CUDA-event times of the mxu tier's layers at the main path's shapes
    (one tile, one stage): densify, stage product, fold, extraction."""
    zero = float(sr.zero_fn(A.dtype))
    pm = _pad128(A.local_rows)
    tile = A.local_tile(0, 0)
    da = densify(tile, pm, pm, zero)

    def product():
        return stage_product(sr, da)

    prod = product()
    acc = torch.full_like(prod, zero)
    counted = semiring_matmul.launches
    out = {
        "densify": time_cuda_ms(lambda: densify(tile, pm, pm, zero), 5),
        "stage_product": time_cuda_ms(product, 3),
        "fold": time_cuda_ms(lambda: sr.add(acc, prod), 5),
        "extract": time_cuda_ms(
            lambda: sparsify_windowed(prod, zero, A.local_rows, A.local_cols, out_capacity), 5
        ),
    }
    semiring_matmul.launches = counted  # timing launches are not the path's
    return out


def phase_times(dev, full: dict, loops: dict) -> dict:
    """The kernel per kind at the main path's shape: time, bound, issue
    floor at the clock read at the end of the timed loop, plain version
    and (plus_times) the library call."""
    m = k = n = FULL
    b_ms, b_by = bound(m, k, n)
    out = {}
    for kind in KINDS:
        a, b = operands(kind, m, k, n, seed=1, dev=dev)
        counted = semiring_matmul.launches
        ms, card = time_with_clock(lambda: semiring_matmul(kind, a, b), 5)
        variant = semiring_matmul.last_variant
        semiring_matmul.launches = counted
        lib = None
        if kind == "plus_times":
            lib = time_cuda_ms(lambda: torch.matmul(a, b), 5)
        ips = loops[kind][variant]["insns_per_step"]
        floor_ms = issue_floor_ms(m, k, n, ips, card["sm_clock_mhz"])
        out[kind] = {"ms": ms, "variant": variant, "bound_ms": b_ms, "bound_by": b_by,
                     "share_of_bound": b_ms / ms, "floor_ms": floor_ms,
                     "share_of_floor": floor_ms / ms, "insns_per_step": ips, **card,
                     "plain_ms": full[kind]["plain_ms"],
                     "library_ms": lib, "max_abs_err": full[kind]["max_abs_err"],
                     "shape": [m, k, n]}
        emit({"phase": "times", "kind": kind, **out[kind]})
        del a, b
    return out


def timed_call(fn):
    """One call of ``fn`` between two CUDA events and on the host clock,
    synchronised after it: (result, device ms, host seconds)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def host_bfs_levels(indptr: np.ndarray, cols: np.ndarray, root: int) -> np.ndarray:
    """Levels of a frontier-at-a-time BFS in numpy over a CSR graph (-1 =
    unreached): the check that shares no code with the device path."""
    level = np.full(len(indptr) - 1, -1, np.int32)
    level[root] = 0
    frontier = np.array([root], np.int64)
    seen = np.zeros(len(level), bool)  # the next frontier as marks: no sort
    depth = 0
    while len(frontier):
        depth += 1
        counts = indptr[frontier + 1] - indptr[frontier]
        ends = np.cumsum(counts)
        slot = np.arange(ends[-1]) - np.repeat(ends - counts, counts)
        nbr = cols[np.repeat(indptr[frontier], counts) + slot]
        seen[nbr[level[nbr] < 0]] = True
        frontier = np.flatnonzero(seen)
        seen[frontier] = False
        level[frontier] = depth
    return level


def host_max_parents(rows: np.ndarray, cols: np.ndarray, indptr: np.ndarray,
                     level: np.ndarray, root: int) -> np.ndarray:
    """Per vertex the maximum-id neighbour one level up (-1 where
    unreached; the root is its own parent), from row-sorted COO."""
    up = (level[rows] > 0) & (level[cols] == level[rows] - 1)
    cand = np.where(up, cols, -1).astype(np.int64)
    deg = indptr[1:] - indptr[:-1]
    parent = np.full(len(level), -1, np.int64)
    has = deg > 0
    parent[has] = np.maximum.reduceat(cand, indptr[:-1][has])
    parent[root] = root
    return parent


def step_bounds(E: EllParMat, n: int, W: int) -> dict:
    """Bytes bounds (ms) of one dense level (M1) and of the parents pass
    (M2) at W lanes: the structure read once (int32 column ids and row
    ids), W bytes gathered per stored slot, and the state read and
    written ([n, W] int8 frontier, undiscovered mask and result for M1;
    [n, W] int8 levels twice and int32 parents for M2)."""
    slots = sum(bc.numel() for bc, _, _ in E.buckets)
    rows = sum(br.numel() for _, _, br in E.buckets)
    structure = 4 * slots + 4 * rows
    m1 = structure + slots * W + 3 * n * W
    m2 = structure + slots * W + 2 * n * W + 4 * n * W
    return {"slots": slots, "bucket_rows": rows,
            "m1_bytes": m1, "m1_bound_ms": m1 / PEAK_BYTES * 1e3,
            "m2_bytes": m2, "m2_bound_ms": m2 / PEAK_BYTES * 1e3}


def sparse_step_bound_ms(n: int, W: int, cnt: int, edges: int) -> float:
    """Bytes bound of one union-frontier level (M3) on this level's data:
    the frontier read once to find its union ([n, W]), the column
    pointers of the ``cnt`` active columns, one row id and W gathered
    bytes per walked edge, the undiscovered mask read and the result
    written ([n, W] each)."""
    return (3 * n * W + 8 * cnt + 4 * edges + edges * W) / PEAK_BYTES * 1e3


def bfs_level_breakdown(E, roots_dev, csc, fcap: int, ecap: int) -> tuple[list, dict]:
    """The search's level loop driven by hand, each level's steps timed on
    the same frontier: the dense sweep always, the sparse step where the
    union frontier fits the budgets (the step the direction-optimised
    call takes there), with its slots cut to the level's counts as the
    search calls it and at the full budgets. Returns one record per level and the final state
    (levels, and the widest frontier's operands for the envelope sweep)."""
    grid, n = E.grid, E.nrows
    W = roots_dev.numel()
    gids = torch.arange(n, dtype=torch.int32, device=grid.device)[None, :, None]
    at_root = gids == roots_dev[None, None, :]
    levels = at_root.to(torch.int8) - 1
    x = at_root.to(torch.int8)
    coldeg = csc[0][0, 0, 1:] - csc[0][0, 0, :-1]
    records, widest = [], None
    level, active = 0, True
    while active:
        undisc = (levels < 0).to(torch.int8)
        act = x.amax(dim=2) > 0
        cnt, edges = int(act.sum()), int((coldeg * act[0]).sum())
        if widest is None or edges > widest[0]:
            widest = (edges, x, undisc)
        rec = {"level": level + 1, "union_frontier": cnt, "union_edges": edges,
               "frontier_cells": int(x.sum()),
               "dense_ms": time_cuda_ms(lambda: ellmat._ell_levels_step(E, x, undisc), 2)}
        sparse_ok = cnt <= fcap and edges <= ecap
        rec["diropt_step"] = "sparse" if sparse_ok else "dense"
        if sparse_ok:  # at this level's counts, as the search calls it; at the budgets
            rec["sparse_ms"] = time_cuda_ms(
                lambda: ellmat._ell_union_sparse_step(E, *csc, x, undisc, cnt, edges), 2)
            rec["sparse_at_budgets_ms"] = time_cuda_ms(
                lambda: ellmat._ell_union_sparse_step(E, *csc, x, undisc, fcap, ecap), 2)
            rec["sparse_bound_ms"] = sparse_step_bound_ms(n, W, cnt, edges)
        reached = ellmat._ell_levels_step(E, x, undisc)
        new = reached > 0
        level += 1
        levels = levels.masked_fill(new, level)
        x = reached
        active = bool(new.any())
        rec["discovered_cells"] = int(new.sum())
        records.append(rec)
    return records, {"levels": levels, "widest": widest[1:]}


def envelope_sweep(E, state: dict) -> dict:
    """One dense level (at the widest frontier) and the parents pass under
    several byte envelopes of the row slicing: ms and peak device memory
    each. The envelopes in use are restored afterwards."""
    x, undisc = state["widest"]
    levels = state["levels"]
    out = {"levels_step": [], "parents_pass": []}
    keep = (ellmat.LEVELS_BUDGET_BYTES, ellmat.PARENTS_BUDGET_BYTES)
    try:
        for name, key, budgets, fn in (
            ("LEVELS_BUDGET_BYTES", "levels_step", (1 << 26, 1 << 28, 1 << 30, 1 << 32),
             lambda: ellmat._ell_levels_step(E, x, undisc)),
            ("PARENTS_BUDGET_BYTES", "parents_pass", (1 << 27, 1 << 29, 1 << 31, 1 << 32),
             lambda: ellmat._ell_parents_from_levels(E, levels, levels)),
        ):
            for budget in budgets:
                setattr(ellmat, name, budget)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                ms = time_cuda_ms(fn, 2)
                out[key].append({"budget_bytes": budget, "ms": ms, "in_use": budget == keep[
                    0 if key == "levels_step" else 1],
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    finally:
        ellmat.LEVELS_BUDGET_BYTES, ellmat.PARENTS_BUDGET_BYTES = keep
    return out


def single_step_bound_ms(E: EllParMat, n: int, step: str, selected: int, entries: int) -> float:
    """Bytes bound of one level of ``bfs_single``. The dense sweep: per
    stored slot its int32 column id read and the int32 candidate gathered,
    the bucket row ids read, the [n] frontier and undiscovered mask read and
    the result written. A walk: per walked entry its int32 row (or column)
    id read and one int32 candidate moved, per selected vertex its range
    start and length."""
    if step == "dense":
        slots = sum(bc.numel() for bc, _, _ in E.buckets)
        rows = sum(br.numel() for _, _, br in E.buckets)
        return (8 * slots + 4 * rows + 9 * n) / PEAK_BYTES * 1e3
    return (8 * entries + 8 * selected) / PEAK_BYTES * 1e3


def device_time(fn, reps: int = 3) -> dict:
    """Kernel launches a call of ``fn`` and their summed device ms
    (``op_breakdown``'s kernel list): beside the CUDA-event time of the
    same call, the share of it the card was busy."""
    trace = op_breakdown(fn, reps)
    if not trace["profiler_device_time"]:
        return {"kernels_ms": None, "kernel_launches": None}
    return {"kernels_ms": trace["kernels_ms"],
            "kernel_launches": sum(k["calls"] for k in trace["kernels"])}


def single_level_breakdown(E, csc, coldeg, rowdeg, tiers, root: int) -> tuple:
    """``bfs_single``'s level loop for one root driven by hand: per level
    the class counts (one readback), the step the rule picks, that step and
    the dense sweep each timed on the same state (CUDA events), the counts'
    and the step's kernel launches and device time (``torch.profiler``),
    and the step's bytes bound. Returns the records, one a level, and the
    parents and levels found."""
    search = bfs_mod._SingleSearch(E, csc, csc, coldeg, rowdeg, tiers)
    row_gids, col_gids = search.row_gids, search.col_gids
    parents = torch.where(row_gids == root, root, -1).to(torch.int32)
    levels = torch.where(row_gids == root, 0, -1).to(torch.int32)
    x = torch.where(col_gids == root, root, -1).to(torch.int32)
    n, new, level, records = E.nrows, None, 0, []
    while True:
        undisc = parents < 0
        counts_ms = time_cuda_ms(lambda: search.counts(x, undisc, new), 3)
        counts = search.counts(x, undisc, new)
        if not counts["active"]:
            break
        step = search.select(counts)
        kind = step[:2]
        selected = entries = 0
        if kind != "de":  # the walk's selected vertices and entries (1x1: one tile)
            selected, entries = sum(counts[kind][0]), sum(counts[kind][1])
        rec = {"level": level + 1, "branch": step, "counts_ms": counts_ms,
               "active_columns": sum(counts["fc"]), "undiscovered_rows": sum(counts["uc"]),
               "selected": selected, "walked_entries": entries,
               "step_ms": time_cuda_ms(lambda: search.step(step, x, undisc, counts), 3),
               "step_bound_ms": single_step_bound_ms(E, n, step, selected, entries),
               "dense_ms": time_cuda_ms(lambda: search.dense(x, undisc), 3),
               "dense_bound_ms": single_step_bound_ms(E, n, "dense", 0, 0),
               "counts_device": device_time(lambda: search.counts(x, undisc, new)),
               "step_device": device_time(lambda: search.step(step, x, undisc, counts))}
        y = search.step(step, x, undisc, counts)
        new = (y >= 0) & undisc & (row_gids >= 0)
        parents = torch.where(new, y, parents)
        level += 1
        levels = torch.where(new, level, levels)
        x = DistVec(blocks=torch.where(new, row_gids, -1), length=n, align="row",
                    grid=E.grid).realign("col").blocks
        rec["discovered"] = int(new.sum())
        records.append(rec)
    return records, parents, levels


def phase_bfs_single(g: dict, E: EllParMat, csc, indptr: np.ndarray, rowidx: np.ndarray,
                     deg_blocks, batch: tuple) -> dict:
    """The single-root search and the ELL SpMV family on the batched path's
    graph (module docstring, phase 8, its last four steps). ``batch``: the
    dense batched search's parents, levels and edge counts."""
    pd_, ld, ted = batch
    grid, n = E.grid, E.nrows
    # csr=csc: valid only on a 1x1 grid for a symmetric matrix; shown here by
    # the CSC arrays being equal to the graph's CSR arrays
    rows64 = g["rows"].astype(np.int64)
    if (grid.pr, grid.pc) != (1, 1) or not (
            np.array_equal(indptr[0, 0], np.searchsorted(rows64, np.arange(n + 1)))
            and np.array_equal(rowidx[0, 0], g["cols"])):
        raise AssertionError("bfs_single: csr=csc needs a 1x1 grid and a symmetric graph")
    tiers = parse_tier_spec(DEFAULT_SEQ_TIERS)
    coldeg = DistVec.from_global(grid, g["deg"], align="col").blocks
    kw = dict(csr=csc, coldeg=coldeg, rowdeg=deg_blocks)
    roots = [int(v) for v in g["roots"][:SEQ_ROOTS]]

    def one_root(root, spec):
        """The timed unit: the search, the edge count and its readback."""
        t0 = time.perf_counter()
        p, lv, it = bfs_single(E, root, csc, tiers=spec, **kw)
        te = int(single_traversed_edges(deg_blocks, p))
        return p, lv, it, te, time.perf_counter() - t0, bfs_single.last_run

    one_root(roots[0], tiers)  # warm-up
    lines, mteps = [], []
    for k, root in enumerate(roots):
        p, lv, it, te, dt, run = one_root(root, tiers)
        if not (torch.equal(p.blocks[0], pd_.blocks[0, :, k])
                and torch.equal(lv.blocks[0], ld.blocks[0, :, k].to(torch.int32))
                and te == int(ted[k])):
            raise AssertionError(f"bfs_single root {k}: differs from lane {k} of the batch")
        if k < SEQ_DENSE_ROOTS:
            pd1, ld1, it1, te1, _, _ = one_root(root, ())
            if not (torch.equal(pd1.blocks, p.blocks) and torch.equal(ld1.blocks, lv.blocks)
                    and (it1, te1) == (it, te)):
                raise AssertionError(f"bfs_single root {k}: tiers '' give another result")
        mteps.append(te / dt / 1e6)
        lines.append({"root": root, "levels": it, "steps": run["steps"],
                      "readbacks": run["readbacks"], "ms": dt * 1e3, "traversed_edges": te,
                      "mteps": mteps[-1]})
    kinds = {st[:2] for line in lines for st in line["steps"]}
    if not {"td", "bu"} <= kinds:
        raise AssertionError(f"bfs_single never took a td and a bu step: {sorted(kinds)}")
    single = {"phase": "bfs_path", "step": "single", "tiers": DEFAULT_SEQ_TIERS,
              "csr": "csc (1x1 grid, symmetric graph: the CSC arrays equal the CSR arrays)",
              "degrees": "g['deg'] as rowdeg and coldeg", "roots": lines,
              "harmonic_mean_mteps": len(mteps) / sum(1.0 / m for m in mteps),
              "median_ms": float(np.median([line["ms"] for line in lines])),
              "equal_to_batch_lanes": len(roots), "dense_tiers_equal_roots": SEQ_DENSE_ROOTS}
    emit(single)

    records, p0, l0 = single_level_breakdown(E, csc, coldeg, deg_blocks, tiers, roots[0])
    if not (torch.equal(p0[0], pd_.blocks[0, :, 0])
            and torch.equal(l0[0], ld.blocks[0, :, 0].to(torch.int32))):
        raise AssertionError("bfs_single: the level loop driven by hand gives another tree")
    for rec in records:
        emit({"phase": "bfs_path", "step": "single_levels", "root": roots[0], **rec})

    # the int32 batch (bfs_batch, M5 = dist_spmv_ell_masked_multi a level)
    W = SEQ_ROOTS
    roots_dev = torch.tensor(roots, dtype=torch.int32, device=grid.device)
    bfs_batch(E, roots_dev)  # warm-up
    runs = [timed_call(lambda: bfs_batch(E, roots_dev)) for _ in range(BFS_REPS)]
    pb, lb, itb = runs[-1][0]
    if not (torch.equal(pb.blocks, pd_.blocks[:, :, :W])
            and torch.equal(lb.blocks, ld.blocks[:, :, :W].to(torch.int32))):
        raise AssertionError("bfs_batch: differs from the first lanes of the batch")
    slots = sum(bc.numel() for bc, _, _ in E.buckets)
    rows = sum(br.numel() for _, _, br in E.buckets)
    # the first level's operands; the step reads every slot whatever the frontier
    xcol = torch.full((1, n, W), -1, dtype=torch.int32, device=grid.device)
    xcol[0, roots_dev.long(), torch.arange(W, device=grid.device)] = roots_dev
    undisc = DistMultiVec(blocks=xcol < 0, length=n, align="row", grid=grid)
    xv = DistMultiVec(blocks=xcol, length=n, align="col", grid=grid)
    m5_ms = time_cuda_ms(lambda: dist_spmv_ell_masked_multi(SELECT2ND_MAX, E, xv, undisc), 3)
    # column ids and row ids read, W int32 lanes gathered a slot, the [n, W]
    # frontier and mask read and the result written
    m5_bound = (4 * slots + 4 * rows + 4 * W * slots + 9 * n * W) / PEAK_BYTES * 1e3
    emit({"phase": "bfs_path", "step": "bfs_batch", "W": W, "levels": itb,
          "readbacks_per_call": bfs_batch.last_run["readbacks"],
          "ms_per_call": [r[1] for r in runs], "wall_s": [r[2] for r in runs],
          "equal_to_batch_lanes": W,
          "m5_dist_spmv_ell_masked_multi": {"ms_per_launch": m5_ms, "launches_per_call": itb,
                                            "bound_ms": m5_bound, "bound_by": "bytes"}})

    # the batched Bellman-Ford on unit weights (M6 = dist_spmv_ell_multi)
    lc = E.local_cols
    Ew = EllParMat(buckets=tuple((bc, torch.where(bc < lc, 1.0, 0.0), br)
                                 for bc, _, br in E.buckets), nrows=n, ncols=n, grid=grid)
    weight_bytes = sum(bv.numel() * bv.element_size() for _, bv, _ in Ew.buckets)
    sssp_batch(Ew, roots_dev)  # warm-up
    runs = [timed_call(lambda: sssp_batch(Ew, roots_dev)) for _ in range(BFS_REPS)]
    d, its = runs[-1][0]
    want = ld.blocks[:, :, :W].to(torch.float32)
    if not torch.equal(d.blocks, torch.where(want >= 0, want, float("inf"))):
        raise AssertionError("sssp_batch: unit-weight distances differ from the BFS levels")
    if its != int(ld.blocks[:, :, :W].max()) + 1:
        raise AssertionError(f"sssp_batch: {its} rounds, want the depth + 1")
    dv = DistMultiVec(blocks=d.blocks, length=n, align="row", grid=grid)
    m6_ms = time_cuda_ms(lambda: dist_spmv_ell_multi(MIN_PLUS, Ew, dv), 3)
    # column ids, weights and row ids read, W float32 lanes gathered a
    # slot, the [n, W] input read and the result written
    m6_bound = (8 * slots + 4 * rows + 4 * W * slots + 8 * n * W) / PEAK_BYTES * 1e3
    emit({"phase": "bfs_path", "step": "sssp_batch", "W": W, "weights": "1.0 (float32)",
          "weight_bytes": weight_bytes, "rounds": its,
          "readbacks_per_call": sssp_batch.last_run["readbacks"],
          "ms_per_call": [r[1] for r in runs], "wall_s": [r[2] for r in runs],
          "distances_equal_batch_levels": W,
          "m6_dist_spmv_ell_multi": {"ms_per_launch": m6_ms, "launches_per_call": its,
                                     "bound_ms": m6_bound, "bound_by": "bytes"}})
    return {"single": single, "levels": records}


def host_pagerank(csr, iters: int, alpha: float = 0.85, e=None) -> np.ndarray:
    """``iters`` rounds of the same power iteration in float64 with scipy:
    the column-stochastic matrix of the symmetric ``csr`` (out-degree =
    row degree), the dangling mass spread uniformly, or to ``e`` (a
    personalised lane: teleport and dangling mass both go to its source)."""
    n = csr.shape[0]
    deg = np.diff(csr.indptr).astype(np.float64)
    inv = np.divide(1.0, deg, out=np.zeros(n), where=deg > 0)
    x = np.full(n, 1.0 / n) if e is None else e.copy()
    for _ in range(iters):
        spread = csr @ (x * inv)
        dmass = x[deg == 0].sum()
        if e is None:
            x = alpha * spread + ((1 - alpha) + alpha * dmass) / n
        else:
            x = alpha * (spread + dmass * e) + (1 - alpha) * e
    return x


def spmv_bytes(nnz: int, n: int, reads_vals: bool) -> int:
    """Bytes ``dist_spmv`` must move on one tile: the int32 row and column
    id of every entry (and its 4-byte value where the product reads it),
    the 4-byte x gathered at every entry, x read once and the [n] result
    written once."""
    return nnz * (12 + (4 if reads_vals else 0)) + 8 * n


def phase_spmat_path(dev, g: dict, E: EllParMat, csr, batch: tuple) -> dict:
    """The SpParMat path on the BFS path's graph (module docstring, phase
    9): the COO matrix, bfs / bfs_diropt / bfs_diropt_auto, sssp, FastSV and
    LACC, pagerank and pagerank_batch, mis, then the SpMV layer timed a
    launch beside its bounds. ``E``: the BFS path's ELL buckets; ``csr``:
    the graph as a scipy CSR matrix; ``batch``: the dense batched search's
    parents, levels and edge counts. Raises on any disagreement."""
    pd_, ld, ted = batch
    n, nnz = len(g["deg"]), len(g["rows"])
    root = int(g["roots"][0])
    want_p, want_l = pd_.blocks[0, :, 0], ld.blocks[0, :, 0].to(torch.int32)
    want_te = int(ted[0])

    # spmat_build: the host bucketing on a CPU grid, then the upload
    t0 = time.perf_counter()
    host = SpParMat.from_global_coo(Grid.make(1, 1, device="cpu"), g["rows"], g["cols"],
                                    np.ones(nnz, np.int32), n, n)
    host_s = time.perf_counter() - t0
    grid = Grid.make(1, 1, device=dev)
    t0 = time.perf_counter()
    A = SpParMat(rows=host.rows.to(dev), cols=host.cols.to(dev), vals=host.vals.to(dev),
                 nnz=host.nnz.to(dev), nrows=n, ncols=n, grid=grid)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del host
    tile_bytes = sum(t.numel() * t.element_size() for t in (A.rows, A.cols, A.vals, A.nnz))
    emit({"phase": "spmat_path", "step": "spmat_build", "grid": "1x1", "n": n, "nnz": nnz,
          "capacity": A.capacity, "host_s": host_s, "upload_s": upload_s,
          "bytes": tile_bytes})

    # spmat_bfs: three searches from the first root, each equal to lane 0
    fcap, ecap = n // 8, max(nnz // 16, 1 << 20)
    searches = {
        "bfs": (lambda: bfs(A, root), bfs),
        "bfs_diropt": (lambda: bfs_diropt(A, root, frontier_capacity=fcap,
                                          exp_capacity=ecap), bfs_diropt),
        "bfs_diropt_auto": (lambda: bfs_diropt_auto(A, root), bfs_diropt),
    }
    lines, kinds = {}, set()
    for name, (call, fn) in searches.items():
        def unit():
            p, lv, it = call()
            return p, lv, it, int(traversed_edges(A, p))

        unit()  # warm-up
        runs = [timed_call(unit) for _ in range(SPMAT_REPS)]
        p, lv, it, te = runs[-1][0]
        if not (torch.equal(p.blocks[0], want_p) and torch.equal(lv.blocks[0], want_l)
                and te == want_te):
            raise AssertionError(f"{name}: differs from lane 0 of the batch")
        wall = [r[2] for r in runs]
        lines[name] = {"phase": "spmat_path", "step": "spmat_bfs", "search": name,
                       "niter": it, "readbacks": fn.last_run["readbacks"],
                       "ms_per_call": [w * 1e3 for w in wall], "device_ms": [r[1] for r in runs],
                       "traversed_edges": te, "mteps": te / float(np.median(wall)) / 1e6}
        if fn is bfs_diropt:
            lines[name]["steps"] = fn.last_run["steps"]
            lines[name]["frontiers"] = fn.last_run["frontiers"]
            kinds |= set(fn.last_run["steps"])
        emit(lines[name])
    if not {"td", "bu"} <= kinds:
        raise AssertionError(f"bfs_diropt never took a td and a bu level: {sorted(kinds)}")
    niter = lines["bfs"]["niter"]

    # spmat_sssp: unit float32 weights, distances equal to the levels
    Aw = A.apply(ones_f32)
    sssp(Aw, root)  # warm-up
    runs = [timed_call(lambda: sssp(Aw, root)) for _ in range(SPMAT_REPS)]
    d, rounds = runs[-1][0]
    wl = want_l.to(torch.float32)
    if not torch.equal(d.blocks[0], torch.where(wl >= 0, wl, float("inf"))):
        raise AssertionError("sssp: unit-weight distances differ from the BFS levels")
    if rounds != niter:
        raise AssertionError(f"sssp: {rounds} rounds, bfs ran {niter} levels")
    emit({"phase": "spmat_path", "step": "spmat_sssp", "weights": "1.0 (float32)",
          "rounds": rounds, "readbacks": sssp.last_run["readbacks"],
          "ms_per_call": [r[2] * 1e3 for r in runs], "device_ms": [r[1] for r in runs],
          "distances_equal_levels": True})

    # spmat_cc: FastSV and LACC against scipy's components
    t0 = time.perf_counter()
    ncomp, comp = csgraph.connected_components(csr, directed=False)
    first = np.full(ncomp, n, np.int64)
    np.minimum.at(first, comp, np.arange(n))
    scipy_s = time.perf_counter() - t0
    cc_line = {"phase": "spmat_path", "step": "spmat_cc", "scipy_components": int(ncomp),
               "scipy_s": scipy_s}
    labels = {}
    for name, fn in (("fastsv", connected_components), ("lacc", lacc)):
        fn(A)  # warm-up
        runs = [timed_call(lambda: fn(A)) for _ in range(SPMAT_REPS)]
        lab, it = runs[-1][0]
        labels[name] = lab.blocks
        if num_components(lab) != ncomp:
            raise AssertionError(f"{name}: {num_components(lab)} components, scipy {ncomp}")
        if not np.array_equal(lab.to_global(), first[comp]):
            raise AssertionError(f"{name}: labels are not each component's least vertex")
        cc_line[name] = {"iterations": it, "readbacks": fn.last_run["readbacks"],
                         "ms_per_call": [r[2] * 1e3 for r in runs],
                         "device_ms": [r[1] for r in runs]}
    if not torch.equal(labels["fastsv"], labels["lacc"]):
        raise AssertionError("FastSV and LACC give different labels")
    emit(cc_line)

    # spmat_pagerank: against float64 power iterations of the same rounds
    pagerank(A)  # warm-up
    runs = [timed_call(lambda: pagerank(A, 0.85, 1e-6, 100)) for _ in range(SPMAT_REPS)]
    x, it = runs[-1][0]
    want = host_pagerank(csr, it)
    got = x.to_global().astype(np.float64)
    l1 = float(np.abs(got - want).sum())
    if not np.isfinite(got).all() or l1 > PAGERANK_L1_BOUND:
        raise AssertionError(f"pagerank: L1 distance {l1} to float64 above {PAGERANK_L1_BOUND}")
    pr_line = {"phase": "spmat_path", "step": "spmat_pagerank", "iterations": it,
               "readbacks": pagerank.last_run["readbacks"], "l1_to_float64": l1,
               "sum": float(got.sum()), "bound": PAGERANK_L1_BOUND,
               "ms_per_call": [r[2] * 1e3 for r in runs], "device_ms": [r[1] for r in runs]}
    # the column-normalised ELL from the same COO: the BFS path's buckets
    # with 1/deg(column) in every stored slot
    lc = E.local_cols
    inv = torch.from_numpy(np.divide(1.0, g["deg"], out=np.zeros(n), where=g["deg"] > 0)
                           .astype(np.float32)).to(dev)
    inv_pad = torch.cat([inv, inv.new_zeros(1)])
    P_ell = EllParMat(buckets=tuple((bc, inv_pad[torch.clamp(bc, max=lc).long()], br)
                                    for bc, _, br in E.buckets),
                      nrows=n, ncols=n, grid=grid)
    dang = DistVec.from_global(grid, (g["deg"] == 0).astype(np.float32), align="col")
    srcs = torch.from_numpy(g["roots"][:PAGERANK_W].astype(np.int32)).to(dev)
    pagerank_batch(P_ell, srcs, dang)  # warm-up
    runs = [timed_call(lambda: pagerank_batch(P_ell, srcs, dang)) for _ in range(SPMAT_REPS)]
    X, itb = runs[-1][0]
    lanes = []
    for k in range(PAGERANK_CHECK_LANES):
        e = np.zeros(n)
        e[int(g["roots"][k])] = 1.0
        lane = X.blocks[0, :, k].cpu().numpy().astype(np.float64)
        l1k = float(np.abs(lane - host_pagerank(csr, itb, e=e)).sum())
        if not np.isfinite(lane).all() or l1k > PAGERANK_L1_BOUND:
            raise AssertionError(f"pagerank_batch lane {k}: L1 {l1k} above {PAGERANK_L1_BOUND}")
        lanes.append({"lane": k, "l1_to_float64": l1k, "sum": float(lane.sum())})
    pr_line["batch"] = {"W": PAGERANK_W, "iterations": itb,
                        "readbacks": pagerank_batch.last_run["readbacks"], "lanes": lanes,
                        "ms_per_call": [r[2] * 1e3 for r in runs],
                        "device_ms": [r[1] for r in runs]}
    emit(pr_line)
    del P_ell, X

    # spmat_mis: independent and maximal over the edge list
    gen = torch.Generator(device=dev)
    mis(A, gen.manual_seed(1))  # warm-up
    runs = [timed_call(lambda: mis(A, gen.manual_seed(1))) for _ in range(SPMAT_REPS)]
    status, mrounds = runs[-1][0]
    s_ = status.to_global()
    rows64, cols64 = g["rows"].astype(np.int64), g["cols"].astype(np.int64)
    member = s_ == 1
    if (member[rows64] & member[cols64]).any():
        raise AssertionError("mis: two members share an edge")
    covered = np.zeros(n, bool)
    covered[rows64[member[cols64]]] = True
    if not (member | covered).all() or not set(np.unique(s_)) <= {1, -1}:
        raise AssertionError("mis: a vertex is undecided or has no member beside it")
    emit({"phase": "spmat_path", "step": "spmat_mis", "rounds": mrounds,
          "readbacks": mis.last_run["readbacks"], "members": int(member.sum()),
          "ms_per_call": [r[2] * 1e3 for r in runs], "device_ms": [r[1] for r in runs],
          "independent": True, "maximal": True})

    # spmat_layers: dist_spmv per semiring and one top-down level, a launch
    rng = np.random.default_rng(11)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    x_ids = DistVec(blocks=torch.where(torch.from_numpy(rng.random(n) < 0.1).to(dev), ids, -1)
                    [None], length=n, align="col", grid=grid)
    x_f = DistVec(blocks=torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)[None],
                  length=n, align="col", grid=grid)
    layers = {}
    for name, sr, M, x, reads_vals in (("select2nd_max_int32", SELECT2ND_MAX, A, x_ids, False),
                                       ("min_plus_f32", MIN_PLUS, Aw, x_f, True),
                                       ("plus_times_f32", PLUS_TIMES, Aw, x_f, True)):
        ms = time_cuda_ms(lambda: dist_spmv(sr, M, x), 5)
        b = spmv_bytes(nnz, n, reads_vals)
        layers[name] = {"ms_per_launch": ms, "bytes": b, "bound_ms": b / PEAK_BYTES * 1e3,
                        "bound_by": "bytes", "share": b / PEAK_BYTES * 1e3 / ms}
    # the library's call for the plus_times SpMV: cuSPARSE's CSR × dense
    # column (float32, the same values and x)
    aw_r, aw_c, aw_v = Aw.to_global_coo()
    lib = sp.csr_matrix((aw_v, (aw_r, aw_c)), shape=(n, n))
    lib_csr = torch.sparse_csr_tensor(torch.from_numpy(lib.indptr.astype(np.int64)),
                                      torch.from_numpy(lib.indices.astype(np.int64)),
                                      torch.from_numpy(lib.data.astype(np.float32)),
                                      size=(n, n), check_invariants=True).to(dev)
    x_col = x_f.blocks.reshape(-1)[:n].reshape(n, 1).contiguous()
    layers["plus_times_f32"]["library_ms"] = time_cuda_ms(lambda: torch.sparse.mm(lib_csr, x_col), 5)
    layers["plus_times_f32"]["library_call"] = "torch.sparse.mm(csr, x)"
    del lib, lib_csr
    layers["min_plus_f32"]["ops"] = op_breakdown(lambda: dist_spmv(MIN_PLUS, Aw, x_f), 3)
    layers["select2nd_max_int32"]["ops"] = op_breakdown(
        lambda: dist_spmv(SELECT2ND_MAX, A, x_ids), 3)
    # dist_spmspv_masked at the bfs_diropt run's first top-down level past
    # the root: its frontier and undiscovered rows rebuilt from the levels
    steps = lines["bfs_diropt"]["steps"]
    k = next((i for i, st in enumerate(steps) if st == "td" and i > 0), 0)
    frontier = want_l == k
    csc = csc_tiles(A)
    xk = DistVec(blocks=torch.where(frontier, ids, -1)[None], length=n, align="col",
                 grid=grid)
    ak = DistVec(blocks=frontier[None], length=n, align="col", grid=grid)
    uk = DistVec(blocks=((want_l < 0) | (want_l > k))[None], length=n, align="row", grid=grid)
    counts = spmspv_counts(csc, ak.blocks, fcap, ecap).tolist()
    td_ms = time_cuda_ms(lambda: dist_spmspv_masked(
        SELECT2ND_MAX, A, xk, ak, uk, frontier_capacity=fcap, exp_capacity=ecap, csc=csc,
        counts=counts), 5)
    cols_k, walked = counts[0], counts[1]
    # per active column its two pointers and its x value, per walked entry
    # its row id and the 4-byte candidate, the column and row masks read
    # and the [n] result written
    td_bytes = 8 * cols_k + 4 * cols_k + 8 * walked + 2 * n + 4 * n
    layers["dist_spmspv_masked"] = {
        "level": k + 1, "active_columns": cols_k, "walked_entries": walked,
        "ms_per_launch": td_ms, "bytes": td_bytes, "bound_ms": td_bytes / PEAK_BYTES * 1e3,
        "bound_by": "bytes", "share": td_bytes / PEAK_BYTES * 1e3 / td_ms,
        "launches_per_call": {"bfs_diropt": steps.count("td"),
                              "bfs_diropt_auto": lines["bfs_diropt_auto"]["steps"].count("td")},
        "ops": op_breakdown(lambda: dist_spmspv_masked(
            SELECT2ND_MAX, A, xk, ak, uk, frontier_capacity=fcap, exp_capacity=ecap, csc=csc,
            counts=counts), 3)}
    layers["select2nd_max_int32"]["launches_per_call"] = {
        "bfs": niter, "bfs_diropt": steps.count("bu"),
        "bfs_diropt_auto": lines["bfs_diropt_auto"]["steps"].count("bu"),
        "fastsv": cc_line["fastsv"]["iterations"], "lacc": 2 * cc_line["lacc"]["iterations"],
        "mis": 2 * mrounds}
    layers["min_plus_f32"]["launches_per_call"] = {"sssp": rounds}
    layers["plus_times_f32"]["launches_per_call"] = {"pagerank": it}
    emit({"phase": "spmat_path", "step": "spmat_layers", **layers})
    del Aw, csc
    torch.cuda.empty_cache()
    return {"lines": lines, "layers": layers, "A": A}


def phase_bfs_path(dev, t_start: float, scale: int = BFS_SCALE,
                   nroots: int = BFS_NROOTS) -> dict:
    """The Graph500 batched BFS, host kernel 1 to validated trees, then the
    single-root search and the SpMV family on the same graph (see the
    module docstring, phase 8). Raises on any disagreement."""
    n = 1 << scale
    t0 = time.perf_counter()
    g = build_graph(scale, BFS_EDGEFACTOR, nroots, device=dev)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets, (indptr, rowidx) = build_structures(g["rows"], g["cols"], n)
    structures_s = time.perf_counter() - t0
    nnz = len(g["rows"])
    slots = sum(bc.size for bc, _, _ in buckets)
    structure_bytes = (sum(a.nbytes for b in buckets for a in b) + indptr.nbytes
                       + rowidx.nbytes)
    emit({"phase": "bfs_path", "step": "host_build", "scale": scale,
          "edgefactor": BFS_EDGEFACTOR, "roots": nroots, "grid": "1x1", "n": n, "nnz": nnz,
          "graph_s": graph_s, "structures_s": structures_s,
          "bucket_classes_nb_x_kb": [[bc.shape[2], bc.shape[3]] for bc, _, _ in buckets],
          "slots": slots, "slot_padding_ratio": slots / nnz,
          "structure_bytes": structure_bytes})

    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    t0 = time.perf_counter()
    grid = Grid.make(1, 1, device=dev)
    E = EllParMat.from_host_buckets(grid, buckets, n, n)
    csc = upload_csc_companion(grid, indptr, rowidx)
    deg_blocks = DistVec.from_global(grid, g["deg"], align="row").blocks
    roots_dev = torch.from_numpy(g["roots"]).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    fcap, ecap = n // 8, max(nnz // 16, 1 << 20)
    modes = {"dense": {}, "diropt": dict(csc=csc, frontier_capacity=fcap, edge_capacity=ecap)}

    def search(kw):
        """The timed unit: the search, the edge count and its readback."""
        p, l, it = bfs_batch_compact(E, roots_dev, **kw)
        te = batch_traversed_edges(deg_blocks, p).cpu().numpy()
        return p, l, it, te, bfs_batch_compact.last_run

    results, lines = {}, {}
    for mode, kw in modes.items():
        torch.cuda.reset_peak_memory_stats()
        _, warm_ms, _ = timed_call(lambda: search(kw))
        runs = [timed_call(lambda: search(kw)) for _ in range(BFS_REPS)]
        p, l, it, te, run = runs[-1][0]
        dev_ms = [r[1] for r in runs]
        wall_s = [r[2] for r in runs]
        dt = float(np.median(wall_s))
        total_te = int(te.astype(np.int64).sum())
        live = te[te > 0].astype(np.float64)
        results[mode] = (p, l, it, te)
        lines[mode] = {
            "phase": "bfs_path", "step": "search", "mode": mode, "levels": it,
            "steps": run["steps"], "host_readbacks_per_call": run["readbacks"] + 1,
            "warmup_ms": warm_ms, "device_ms": dev_ms, "wall_s": wall_s,
            "median_wall_s": dt, "total_traversed_edges": total_te,
            "mteps": total_te / dt / 1e6,
            "harmonic_mean_amortized_mteps": len(live) * len(te) / (dt * np.sum(1.0 / live)) / 1e6,
            "reachable_roots": int((te > 0).sum()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        }
        if lines[mode]["reachable_roots"] != nroots:
            raise AssertionError(f"bfs {mode}: a root reached no edge")
        emit(lines[mode])
    hand_launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(hand_launches.values()):
        raise AssertionError(f"the BFS path launched hand kernels: {hand_launches}")

    # both modes agree
    (pd_, ld, itd, ted), (ps, ls, its, tes) = results["dense"], results["diropt"]
    if not (torch.equal(pd_.blocks, ps.blocks) and torch.equal(ld.blocks, ls.blocks)
            and itd == its and np.array_equal(ted, tes)):
        raise AssertionError("bfs: dense and direction-optimised results differ")
    if "sparse" not in lines["diropt"]["steps"]:
        raise AssertionError(f"bfs diropt never took the sparse step: {lines['diropt']['steps']}")

    # the trees on the device, a lane subset (levels widened to int32)
    lanes = lambda mv, dt_: DistMultiVec(
        blocks=mv.blocks[:, :, :BFS_CHECK_LANES].to(dt_).contiguous(), length=mv.length,
        align=mv.align, grid=mv.grid)
    pv, lv = lanes(pd_, torch.int32), lanes(ld, torch.int32)
    viol, validate_ms, _ = timed_call(lambda: validate_bfs_device(E, pv, lv).cpu().numpy())
    if viol.shape != (4, BFS_CHECK_LANES) or viol.any():
        raise AssertionError(f"bfs validation: violations {viol.tolist()}")

    # the same lanes against a numpy BFS on the host
    t0 = time.perf_counter()
    rows64, cols64 = g["rows"].astype(np.int64), g["cols"].astype(np.int64)
    row_ptr = np.searchsorted(rows64, np.arange(n + 1))
    P = pd_.blocks[0, :, :BFS_CHECK_LANES].cpu().numpy()
    L = ld.blocks[0, :, :BFS_CHECK_LANES].cpu().numpy()
    for k in range(BFS_CHECK_LANES):
        root = int(g["roots"][k])
        want_l = host_bfs_levels(row_ptr, cols64, root)
        if not np.array_equal(L[:, k], want_l):
            raise AssertionError(f"bfs lane {k}: levels differ from the host BFS")
        if not np.array_equal(P[:, k], host_max_parents(rows64, cols64, row_ptr, want_l, root)):
            raise AssertionError(f"bfs lane {k}: parents are not the max-id neighbour one level up")
        if int(ted[k]) != int(g["deg"][want_l >= 0].astype(np.int64).sum()) // 2:
            raise AssertionError(f"bfs lane {k}: traversed edges differ from the host count")
    host_check_s = time.perf_counter() - t0
    emit({"phase": "bfs_path", "step": "checks", "modes_agree": True,
          "validate_bfs_device": viol.tolist(), "validate_lanes": BFS_CHECK_LANES,
          "validate_ms": validate_ms, "host_bfs_lanes_equal": BFS_CHECK_LANES,
          "host_check_s": host_check_s, "finite_shapes": [list(pd_.blocks.shape),
                                                          list(ld.blocks.shape)],
          "hand_kernel_launches": hand_launches})

    # where the time goes: level by level, the parents pass, the bounds
    bounds = step_bounds(E, n, nroots)
    records, state = bfs_level_breakdown(E, roots_dev, csc, fcap, ecap)
    if not torch.equal(state["levels"], ld.blocks):
        raise AssertionError("bfs: the level loop driven by hand gives other levels")
    for rec in records:
        emit({"phase": "bfs_path", "step": "level", **rec,
              "dense_bound_ms": bounds["m1_bound_ms"]})
    parents_ms = time_cuda_ms(
        lambda: ellmat._ell_parents_from_levels(E, state["levels"], state["levels"]), 2)
    te_ms = time_cuda_ms(lambda: batch_traversed_edges(deg_blocks, pd_), 3)
    dense_ms = [r["dense_ms"] for r in records]
    programs = {
        "phase": "bfs_path", "step": "programs", **bounds, "upload_s": upload_s,
        "m1_levels_step": {"ms_per_launch": sum(dense_ms) / len(dense_ms),
                           "ms_min_max": [min(dense_ms), max(dense_ms)],
                           "launches_per_call": {m: lines[m]["steps"].count("dense")
                                                 for m in modes},
                           "bound_ms": bounds["m1_bound_ms"], "bound_by": "bytes"},
        "m2_parents_from_levels": {"ms_per_launch": parents_ms,
                                   "launches_per_call": {m: 1 for m in modes},
                                   "bound_ms": bounds["m2_bound_ms"], "bound_by": "bytes"},
        "m3_union_sparse_step": {
            "ms_per_launch": [r["sparse_ms"] for r in records if "sparse_ms" in r],
            "bound_ms": [r["sparse_bound_ms"] for r in records if "sparse_ms" in r],
            "bound_by": "bytes",
            "launches_per_call": {m: lines[m]["steps"].count("sparse") for m in modes}},
        "batch_traversed_edges_ms": te_ms,
        # device time per operator at the widest frontier (torch.profiler)
        "m1_ops": op_breakdown(lambda: ellmat._ell_levels_step(E, *state["widest"]), 2),
        "m2_ops": op_breakdown(
            lambda: ellmat._ell_parents_from_levels(E, state["levels"], state["levels"]), 2),
        "envelopes_in_use": {"levels": ellmat.LEVELS_BUDGET_BYTES,
                             "parents": ellmat.PARENTS_BUDGET_BYTES},
    }
    emit(programs)
    sweep = envelope_sweep(E, state)
    emit({"phase": "bfs_path", "step": "envelope_sweep", **sweep})
    del state
    torch.cuda.empty_cache()

    emit({"phase": "bfs_path", "step": "elapsed", "total_s": time.perf_counter() - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    single = phase_bfs_single(g, E, csc, indptr, rowidx, deg_blocks, (pd_, ld, ted))
    hand_launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(hand_launches.values()):
        raise AssertionError(f"the single-root steps launched hand kernels: {hand_launches}")
    emit({"phase": "bfs_path", "step": "single_checks", "hand_kernel_launches": hand_launches,
          "total_s": time.perf_counter() - t_start})
    torch.cuda.empty_cache()

    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    csr = sp.csr_matrix((np.ones(len(rowidx[0, 0]), np.float64), rowidx[0, 0], indptr[0, 0]),
                        shape=(n, n))  # the CSC arrays of a symmetric graph on one tile
    spmat = phase_spmat_path(dev, g, E, csr, (pd_, ld, ted))
    hand_launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(hand_launches.values()):
        raise AssertionError(f"the SpParMat steps launched hand kernels: {hand_launches}")
    emit({"phase": "spmat_path", "step": "spmat_checks", "hand_kernel_launches": hand_launches,
          "total_s": time.perf_counter() - t_start})
    return {"lines": lines, "programs": programs, "single": single, "spmat": spmat, "g": g,
            "E": E, "csr_host": {"indptr": indptr[0, 0], "cols": rowidx[0, 0]}}


# --- phase 10: the general SpGEMM, the elementwise layer, TC and BC ----------

GEN_SCALE, GEN_GRID = 16, 4  # A·A of an R-MAT scale-16 graph on a 4×4 grid of tiles
GEN_AA_NNZ = 355_881_582  # nnz(A·A), from scipy on the host
TRIANGLES = {15: 6_708_365, 16: 15_684_546, 18: 82_878_317}
KSELECT_K, KSELECT_SAMPLE = 16, 2048
BC_ROOTS, BC_CHECK_LANES = 16, 2


def step_times(fn, digest=None, reps: int = 1) -> tuple:
    """The step's protocol: one warm-up call (its result, reduced by
    ``digest`` and then dropped, is what the checks read), then ``reps``
    calls timed together with CUDA events around the whole call. Returns
    ``(digest(result), ms a call, peak GB)``, the peak over all the calls
    (``max_memory_allocated``, reset first)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    out = digest(out) if digest is not None else out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps, torch.cuda.max_memory_allocated() / 2**30


def live_entries(C: SpParMat) -> tuple[torch.Tensor, torch.Tensor]:
    """The live entries of C as (global key row * ncols + col, sorted; the
    values in that order), on the card: comparable across tiers whatever
    their capacities and slot order."""
    lr, lc = C.local_rows, C.local_cols
    keys, vals = [], []
    for i in range(C.grid.pr):
        for j in range(C.grid.pc):
            t = C.local_tile(i, j)
            m = t.valid_mask()
            keys.append((t.rows[m].long() + i * lr) * C.ncols + t.cols[m].long() + j * lc)
            vals.append(t.vals[m])
    key, order = torch.sort(torch.cat(keys))
    return key, torch.cat(vals)[order]


def same_entries(a, b) -> bool:
    """Equal keys and values bit for bit."""
    return (a[0].shape == b[0].shape and torch.equal(a[0], b[0])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


def weighted_rmat(scale: int, dev, grid: Grid, sr) -> tuple:
    """``rmat_symmetric_coo_host(42, scale, 16)`` with ``default_rng(7)``
    weights 1..15, duplicates folded with ``sr`` (phase 5's recipe)."""
    r, c = rmat_symmetric_coo_host(GRAPH_SEED, scale, EDGEFACTOR)
    v = np.random.default_rng(WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(np.float32)
    n = 1 << scale
    return r, c, v, SpParMat.from_global_coo(grid, r, c, v, n, n, dedup_sr=sr)


def step_cross_tier(dev) -> dict:
    """Step 1: on phase 5's scale-13 graph (1×1), ``spgemm_auto(tier="esc")``,
    ``spgemm(merge="runs")`` and ``spgemm_auto(tier="scan")`` give the mxu
    tier's live entries bit for bit."""
    grid = Grid.make(1, 1, device=dev)
    out = {}
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        _, _, _, A = weighted_rmat(SCALE, dev, grid, sr)
        k1_before = semiring_matmul.launches
        want = live_entries(spgemm_auto(sr, A, A, tier="mxu"))
        k1 = semiring_matmul.launches - k1_before
        line = {"phase": "spgemm_general", "step": "cross_tier", "semiring": sr.name,
                "scale": SCALE, "grid": "1x1", "nnz_out": int(want[0].numel()),
                "k1_launches": k1}
        for name, fn in (("esc", lambda: spgemm_auto(sr, A, A, tier="esc")),
                         ("runs", lambda: spgemm(sr, A, A, merge="runs")),
                         ("scan", lambda: spgemm_auto(sr, A, A, tier="scan"))):
            got, ms, peak = step_times(fn, live_entries)
            if not same_entries(got, want):
                raise AssertionError(f"cross-tier {sr.name}: {name} differs from the mxu tier")
            line[name] = {"ms": ms, "nnz_out_per_s": line["nnz_out"] / (ms / 1e3),
                          "peak_mem_gb": peak}
        emit(line)
        out[sr.name] = line
    return out


def esc_bytes_bound_ms(nnz_a: int, nnz_c: int) -> float:
    """Read A and B once (12 bytes an entry: int32 row, col, float32 value),
    write C once, over the card's memory rate."""
    return (2 * nnz_a + nnz_c) * 12 / PEAK_BYTES * 1e3


def read_once_bound_ms(entries: int, out_bytes: int) -> float:
    """Bytes bound of a function of one sparse matrix: its stored entries
    read once (12 bytes each), its output written once, over the card's
    memory rate. (Triangle counting's popcounts are integer ALU work, for
    which the published peak table gives no rate, so bytes bound it.)"""
    return (12 * entries + out_bytes) / PEAK_BYTES * 1e3


def library_spgemm_ms(r, c, v, n: int, grid_p: int, dev) -> dict:
    """``torch.sparse.mm`` on CSR (the library's SpGEMM) for the same
    PLUS_TIMES product: the whole product if it fits, else one tile's stage
    product A_00 · A_00, beside the port's ``spgemm`` of that product on a
    1×1 grid (``esc_same_ms``)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix((v.astype(np.float32), (r, c)), shape=(n, n))
    csr.sum_duplicates()

    def as_torch(m):
        m = m.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)), torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data), size=m.shape, check_invariants=True).to(dev)

    for what, m in (("whole product", csr), ("one tile's stage product A_00 · A_00",
                                             csr[: n // grid_p, : n // grid_p])):
        X = as_torch(m)
        try:
            _, ms, peak = step_times(lambda: torch.sparse.mm(X, X))
        except (torch.cuda.OutOfMemoryError, RuntimeError) as e:  # cuSPARSE's buffers
            emit({"phase": "spgemm_general", "step": "library", "timed": what,
                  "refused": str(e)[:200]})
            del X
            torch.cuda.empty_cache()
            continue
        del X
        torch.cuda.empty_cache()
        out = {"library_ms": ms, "library_call": "torch.sparse.mm(csr, csr)",
               "library_timed": what, "library_peak_mem_gb": peak}
        if m is not csr:
            # the port's own product, outside the try: its failure stops the smoke
            mc = m.tocoo()
            sub = SpParMat.from_global_coo(Grid.make(1, 1, device=dev), mc.row, mc.col,
                                           mc.data, *m.shape)
            _, out["esc_same_ms"], _ = step_times(lambda: spgemm(PLUS_TIMES, sub, sub))
        return out
    return {"library_ms": None, "library_timed": "neither fits"}


def step_aa16(dev) -> dict:
    """Step 2: A·A at scale 16 on a 4×4 grid of tiles, per semiring through
    spgemm (sort), spgemm(merge="runs"), spgemm_scan and
    mem_efficient_spgemm(phases=4): 355,881,582 live entries each, min_plus
    and max_min equal bit for bit across the four, plus_times within float32
    rounding of the exact float64 product (``float64_square``). The
    router's answer ("windowed", as the reference's) and spgemm_auto's
    product on it, equal to sort."""
    import scipy.sparse as sp

    grid = Grid.make(GEN_GRID, GEN_GRID, device=dev)
    n = 1 << GEN_SCALE
    lines = {}
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        r, c, v, A = weighted_rmat(GEN_SCALE, dev, grid, sr)
        nnz_a = int(A.getnnz())
        tier = choose_spgemm_tier(sr, A, A)
        if tier != "windowed":
            raise AssertionError(f"A·A {sr.name}: routed to {tier}, the reference's rule "
                                 "gives windowed")
        line = {"phase": "spgemm_general", "step": "aa16", "semiring": sr.name,
                "scale": GEN_SCALE, "grid": f"{GEN_GRID}x{GEN_GRID}", "nnz_a": nnz_a,
                "flops": estimate_flops(A, A), "router": tier,
                "bytes_bound_ms": esc_bytes_bound_ms(nnz_a, GEN_AA_NNZ)}
        ref = None
        for name, fn in (("sort", lambda: spgemm(sr, A, A)),
                         ("runs", lambda: spgemm(sr, A, A, merge="runs")),
                         ("scan", lambda: spgemm_scan(sr, A, A)),
                         ("mem_efficient4", lambda: mem_efficient_spgemm(sr, A, A, 4))):
            caps = {}

            def digest(C):
                caps.update(capacity=C.capacity, max_tile_nnz=int(C.nnz.max()))
                if name == "scan":
                    caps.update(spgemm_scan.last_run)
                return live_entries(C)

            got, ms, peak = step_times(fn, digest)
            nnz = int(got[0].numel())
            if nnz != GEN_AA_NNZ:
                raise AssertionError(f"A·A {sr.name} {name}: {nnz} entries, want {GEN_AA_NNZ}")
            if ref is None:
                ref = got
            elif sr.name != "plus_times" and not same_entries(got, ref):
                raise AssertionError(f"A·A {sr.name}: {name} differs from sort")
            if sr.name == "plus_times":
                line.setdefault("max_rel_err", {})[name] = plus_times_check(got, r, c, v, n)
            line[name] = {"ms": ms, "nnz_out_per_s": nnz / (ms / 1e3), "peak_mem_gb": peak,
                          "sort_bound_share": line["bytes_bound_ms"] / ms, **caps}
            del got
            torch.cuda.empty_cache()
        # the router's route: spgemm_auto serves it (phase 11 times it), equal to
        # sort; plus_times within float32 rounding of the float64 product
        auto = live_entries(spgemm_auto(sr, A, A))
        if sr.name == "plus_times":
            line["spgemm_auto"] = {"tier": tier, "max_rel_err": plus_times_check(auto, r, c, v, n)}
        elif same_entries(auto, ref):
            line["spgemm_auto"] = {"tier": tier, "equal_to_sort": True}
        else:
            raise AssertionError(f"A·A {sr.name}: spgemm_auto (windowed) differs from sort")
        del auto
        torch.cuda.empty_cache()
        if sr.name == "plus_times":
            line.update(library_spgemm_ms(r, c, v, n, GEN_GRID, dev))
        if sr.name == "min_plus":  # where a sort-merge call's time goes, by operator
            line["sort_ops"] = op_breakdown(lambda: spgemm(sr, A, A), 1)
            for key in ("ops", "kernels"):
                line["sort_ops"][key] = line["sort_ops"].get(key, [])[:12]
        emit(line)
        lines[sr.name] = line
        del ref, A
        torch.cuda.empty_cache()
    _F64_AA.clear()  # 5.7 GB on the card; phase 11 makes it again
    return lines


_F64_AA = {}
F64_AA_PIECE = 1 << 26  # products expanded, sorted and summed at a time


def float64_square(r, c, v, n: int, dev) -> dict:
    """A·A in float64 on the card, by expand, sort and sum in pieces of
    whole rows, sharing no code with the port: the duplicates of (r, c)
    summed, every product ``A[i, k] · A[k, j]`` listed, and equal keys
    summed. The weights are integers and every sum stays below 2^53, so
    each entry is exact whatever the order of its terms: the entries of
    scipy's float64 product. Returns the sorted keys ``row * n + col``, the
    sums and the longest row of A."""
    key = torch.from_numpy(r).to(dev).long() * n + torch.from_numpy(c).to(dev).long()
    key, inv = torch.unique(key, return_inverse=True)
    val = torch.zeros(len(key), dtype=torch.float64, device=dev).index_add_(
        0, inv, torch.from_numpy(v).to(dev).double())
    del inv
    rows, cols = key // n, key % n
    rowlen = torch.bincount(rows, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(rowlen, 0)
    fan = rowlen[cols]  # products of each entry
    ends = torch.cumsum(fan, 0)
    # pieces of whole rows, each from the first row past a multiple of the piece
    row_cum = torch.cat([ends.new_zeros(1), ends])[indptr[1:]]  # products through each row
    marks = torch.arange(F64_AA_PIECE, max(int(ends[-1]), F64_AA_PIECE), F64_AA_PIECE, device=dev)
    cuts = sorted({0, len(key), *indptr[torch.searchsorted(row_cum, marks, right=True)].tolist()})
    keys, sums = [], []
    for e0, e1 in zip(cuts[:-1], cuts[1:]):
        f = fan[e0:e1]
        src = torch.repeat_interleave(torch.arange(e0, e1, device=dev), f)
        start = torch.cumsum(f, 0) - f
        slot = torch.arange(len(src), device=dev) - torch.repeat_interleave(start, f)
        b = indptr[cols[src]] + slot
        pk, order = torch.sort(rows[src] * n + cols[b])
        pv = (val[src] * val[b])[order]
        del src, slot, b, order
        uk, pinv = torch.unique_consecutive(pk, return_inverse=True)
        keys.append(uk)
        sums.append(torch.zeros(len(uk), dtype=torch.float64, device=dev).index_add_(0, pinv, pv))
        del pk, pv, pinv
    return {"C": (torch.cat(keys), torch.cat(sums)), "kmax": int(rowlen.max())}


def plus_times_check(got, r, c, v, n: int) -> float:
    """The largest relative error of got's values against the float64
    A·A (``float64_square``), which must be at most ``k_max * 2^-24`` (a
    float32 sum of at most k_max positive terms; k_max the largest row
    length)."""
    if "C" not in _F64_AA:
        _F64_AA.update(float64_square(r, c, v, n, got[0].device))
    wkey, wval = _F64_AA["C"]
    gkey, gval = got[0], got[1].double()
    if gkey.shape != wkey.shape or not torch.equal(gkey, wkey):
        raise AssertionError("plus_times A·A: the pattern differs from the float64 product's")
    rel = float(((gval - wval).abs() / wval).max())
    if rel > _F64_AA["kmax"] * 2.0**-24:
        raise AssertionError(f"plus_times A·A: relative error {rel} past float32 rounding")
    return rel


def step_kselect(C: SpParMat) -> dict:
    """Step 3: ``kselect(16)`` and ``prune_column`` on the min_plus A·A;
    the thresholds of a seeded sample of columns against numpy's 16th
    largest, the pruned count against numpy's over every column."""
    (th, ms, peak) = step_times(lambda: C.kselect(KSELECT_K))
    (pruned, pms, ppeak) = step_times(lambda: C.prune_column(th, lambda x, t: x >= t),
                                      lambda P: int(P.getnnz()))
    key, val = live_entries(C)
    key, val = key.cpu().numpy(), val.cpu().numpy()
    col = key % C.ncols
    thr = th.to_global()
    kept = int((val >= thr[col]).sum())
    if pruned != kept:
        raise AssertionError(f"prune_column kept {pruned}, numpy {kept}")
    sample = np.random.default_rng(13).choice(C.ncols, min(KSELECT_SAMPLE, C.ncols), replace=False)
    in_sample = np.zeros(C.ncols, bool)
    in_sample[sample] = True
    pick = in_sample[col]
    sc, sv = col[pick], val[pick]
    order = np.lexsort((-sv, sc))  # by column, then value descending
    sc, sv = sc[order], sv[order]
    starts = np.searchsorted(sc, sample)
    counts = np.searchsorted(sc, sample, side="right") - starts
    kth = sv[np.minimum(starts + KSELECT_K - 1, len(sv) - 1)]
    want = np.where(counts >= KSELECT_K, kth, -np.inf).astype(np.float32)
    bad = np.flatnonzero(thr[sample] != want)
    if bad.size:
        j = sample[bad[0]]
        raise AssertionError(f"kselect column {j}: {thr[j]}, numpy {want[bad[0]]}")
    line = {"phase": "spgemm_general", "step": "kselect", "semiring": "min_plus",
            "k": KSELECT_K, "kselect_ms": ms, "kselect_peak_mem_gb": peak,
            "prune_column_ms": pms, "prune_column_peak_mem_gb": ppeak, "kept": kept,
            "columns_checked": len(sample),
            "columns_below_k": int((thr == -np.inf).sum())}
    emit(line)
    return line


def step_subsref(A_host: tuple) -> dict:
    """Step 4: ``subsref`` of a seeded random half of the vertices from the
    4×4 min_plus A (duplicates folded by min), against scipy slicing."""
    import scipy.sparse as sp

    r, c, v, A = A_host
    n = A.nrows
    idx = np.random.default_rng(17).permutation(n)[: n // 2]
    got, ms, peak = step_times(lambda: subsref(A, idx, idx), live_entries)
    ar, ac, av = A.to_global_coo()
    S = sp.csr_matrix((av.astype(np.float64), (ar, ac)), shape=(n, n))[idx][:, idx].tocoo()
    key = S.row.astype(np.int64) * len(idx) + S.col
    order = np.argsort(key)
    if not (np.array_equal(got[0].cpu().numpy(), key[order])
            and np.array_equal(got[1].cpu().numpy(), S.data[order].astype(np.float32))):
        raise AssertionError("subsref differs from scipy's slice")
    line = {"phase": "spgemm_general", "step": "subsref", "rows": len(idx), "cols": len(idx),
            "nnz_out": int(got[0].numel()), "ms": ms, "peak_mem_gb": peak,
            "nnz_out_per_s": int(got[0].numel()) / (ms / 1e3)}
    emit(line)
    return line


def step_triangles(dev) -> tuple[list, dict]:
    """Step 5: triangles of the scale-15, 16 and 18 graphs (``build_graph``'s
    recipe) by every kernel that fits, each against the count scipy gives
    on the host. Returns the lines and the scale-18 graph (phase 12's
    matching graph)."""
    runs = {15: [("auto", 1), ("dense", 1), ("edgeharvest", 1), ("edgeharvest_bf16", 1),
                 ("sparse", 1)],
            16: [("auto", 1), ("edgeharvest_bf16", 1), ("sparse", 1), ("sparse", 2)],
            18: [("auto", 1), ("auto", 2)]}
    lines, kept = [], None
    for scale, kernels in runs.items():
        g = build_graph(scale, BFS_EDGEFACTOR, nroots=1, device=dev)
        if scale == MATCH_SCALE:
            kept = g
        n = 1 << scale
        mats = {}
        for kernel, p in kernels:
            if p not in mats:
                mats[p] = SpParMat.from_global_coo(Grid.make(p, p, device=dev), g["rows"],
                                                   g["cols"], np.ones(len(g["rows"]), np.float32),
                                                   n, n)
            count, ms, peak = step_times(lambda: triangle_count(mats[p], kernel))
            if count != TRIANGLES[scale]:
                raise AssertionError(f"TC scale {scale} {kernel} {p}x{p}: {count}, want "
                                     f"{TRIANGLES[scale]}")
            line = {"phase": "spgemm_general", "step": "triangles", "scale": scale,
                    "kernel": kernel, "grid": f"{p}x{p}", "triangles": count, "ms": ms,
                    "peak_mem_gb": peak, "edges": len(g["rows"]) // 2,
                    "edges_per_s": len(g["rows"]) / 2 / (ms / 1e3),
                    "bytes_bound_ms": read_once_bound_ms(len(g["rows"]), 8)}
            emit(line)
            lines.append(line)
        del mats
        torch.cuda.empty_cache()
    return lines, kept


def host_brandes(indptr, indices, n: int, source: int) -> np.ndarray:
    """Float64 Brandes dependencies of one source on a symmetric graph,
    level by level with scipy (the source's own entry zero)."""
    import scipy.sparse as sp

    adj = sp.csr_matrix((np.ones(len(indices)), indices, indptr), shape=(n, n))
    lvl = np.full(n, -1)
    sig = np.zeros(n)
    lvl[source], sig[source] = 0, 1.0
    d = 0
    while True:
        arriving = adj @ np.where(lvl == d, sig, 0)
        new = (arriving > 0) & (lvl < 0)
        if not new.any():
            break
        lvl[new], sig[new] = d + 1, arriving[new]
        d += 1
    delta = np.zeros(n)
    for dd in range(d, 0, -1):
        w = np.where(lvl == dd, (1 + delta) / np.maximum(sig, 1e-300), 0)
        delta += np.where(lvl == dd - 1, (adj.T @ w) * sig, 0)
    delta[source] = 0
    return delta


def step_bc(dev, g: dict) -> dict:
    """Step 6: BC of the BFS path's scale-20 graph from its first 16 roots:
    ``bc_batch_dense`` on the ELL form (1×1, float32 ones) and ``bc_batch``
    on a 2×2 ``SpParMat``, equal within 1e-4 of the larger score plus 1e-6
    of the largest; the first two lanes of ``bc_batch_dense_lanes`` against
    a float64 Brandes on the host. ``g``: the BFS path's graph."""
    n = len(g["deg"])
    roots = g["roots"][:BC_ROOTS].astype(np.int32)
    ones = np.ones(len(g["rows"]), np.float32)
    t0 = time.perf_counter()
    E = EllParMat.from_host_coo(Grid.make(1, 1, device=dev), g["rows"], g["cols"], ones, n, n)
    A = SpParMat.from_global_coo(Grid.make(2, 2, device=dev), g["rows"], g["cols"], ones, n, n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dense, dms, dpeak = step_times(lambda: bc_batch_dense(E, E, roots).to_global())
    dense_run = dict(bc_batch_dense.last_run)
    sparse, sms, speak = step_times(lambda: bc_batch(A, roots).to_global())
    sparse_run = dict(bc_batch.last_run)
    diff = np.abs(dense - sparse)
    tol = 1e-4 * np.maximum(np.abs(dense), np.abs(sparse)) + 1e-6 * np.abs(dense).max()
    if not (diff <= tol).all():
        raise AssertionError(f"bc: dense and SpGEMM forms differ by {diff.max()}")
    lanes = bc_batch_dense_lanes(E, E, roots).blocks[0, :n, :BC_CHECK_LANES].cpu().numpy()
    indptr = np.searchsorted(g["rows"].astype(np.int64), np.arange(n + 1))
    errs = []
    for k in range(BC_CHECK_LANES):
        want = host_brandes(indptr, g["cols"], n, int(roots[k]))
        err = np.abs(lanes[:, k] - want)
        if not (err <= 1e-4 * np.abs(want) + 1e-6 * np.abs(want).max()).all():
            raise AssertionError(f"bc lane {k}: off the float64 Brandes by {err.max()}")
        errs.append(float((err / np.maximum(np.abs(want), 1e-30)).max()))
    line = {"phase": "spgemm_general", "step": "bc", "scale": BFS_SCALE, "roots": BC_ROOTS,
            "build_s": build_s, "bc_batch_dense_ms": dms, "bc_batch_dense_peak_mem_gb": dpeak,
            "bc_batch_dense_readbacks": dense_run["readbacks"],
            "bc_batch_ms": sms, "bc_batch_peak_mem_gb": speak,
            "bytes_bound_ms": read_once_bound_ms(len(g["rows"]), 4 * n),
            "bc_batch_levels": sparse_run["levels"], "bc_batch_readbacks": sparse_run["readbacks"],
            "bc_batch_forward_capacities": sparse_run["forward_capacities"],
            "bc_batch_backward_capacities": sparse_run["backward_capacities"],
            "max_abs_diff": float(diff.max()), "max_score": float(np.abs(dense).max()),
            "lanes_max_rel_err_vs_float64": errs}
    emit(line)
    return line


def phase_spgemm_general(dev, t_start: float, g: dict) -> dict:
    """Phase 10 (module docstring): steps 1-6, with K1's and K2's launch
    counts set to 0 just before and read just after; K1 runs only in step
    1's three mxu calls (two attempts of one stage each for min_plus and
    max_min, as phase 5 asserts), K2 never."""
    emit({"phase": "spgemm_general", "step": "elapsed", "total_s": time.perf_counter() - t_start,
          "allocated_gb": torch.cuda.memory_allocated() / 2**30})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        step_s[name] = time.perf_counter() - t0
        return out

    cross = timed("cross_tier", step_cross_tier, dev)
    k1_step1 = semiring_matmul.launches
    aa = timed("aa16", step_aa16, dev)

    def select_and_slice():
        A_min = weighted_rmat(GEN_SCALE, dev, Grid.make(GEN_GRID, GEN_GRID, device=dev),
                              MIN_PLUS)
        C = spgemm(MIN_PLUS, A_min[3], A_min[3])
        ks = step_kselect(C)
        del C
        torch.cuda.empty_cache()
        return ks, step_subsref(A_min)

    ks, sub = timed("kselect_subsref", select_and_slice)
    torch.cuda.empty_cache()
    tri, g18 = timed("triangles", step_triangles, dev)
    bc = timed("bc", step_bc, dev, g)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if launches != {"k1": 4, "k2": 0} or k1_step1 != 4:
        raise AssertionError(f"spgemm_general launched {launches} (step 1: {k1_step1}); "
                             "want k1 4, all in step 1, and k2 0")
    emit({"phase": "spgemm_general", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "total_s": time.perf_counter() - t_start})
    return {"cross": cross, "aa": aa, "kselect": ks, "subsref": sub, "g18": g18,
            "triangles": tri, "bc": bc}


# --- phase 11: the windowed SpGEMM tier and semantic.py ------------------------

WIN_DOT_SCALE, WIN_DOT_GRID = 15, 2  # 16384-wide tiles, as phase 10's: K1 at full shape
WIN_REPS = 2  # timed calls after the warm-up
SEMANTIC_SEED = 11


def plan_summary(plan: dict) -> dict:
    """The JSON-able part of ``spgemm_windowed.last_plan`` (no skip list)."""
    return {k: v for k, v in plan.items() if k != "skip"}


def accumulator_cells(plan: dict, A: SpParMat) -> int:
    """Dense accumulator cells a windowed call of ``plan`` on A·A fills, over
    all tiles: each live block's ``rb × pad128(lc)`` (scatter) or each live
    window's ``pad(rb) × pad(block_cols)`` (dot)."""
    lr, lc, br = A.local_rows, A.local_cols, plan["block_rows"]
    if plan["backend"] == "scatter":
        pc = -(-lc // 128) * 128
        cells = sum(min(br, lr - g * br) * pc for g in packed_windows(plan["skip"]))
    else:
        pw = _pad128(plan["block_cols"])
        cells = sum(_pad128(min(br, lr - g * br)) * pw
                    for g, _ in packed_windows_2d(plan["skip"]))
    return cells * A.grid.size


def windowed_bound(plan: dict, A: SpParMat, nnz_c: int, launches: int) -> tuple[float, str]:
    """Least time of a windowed A·A call: A and B read once (12 bytes an
    entry), every dense accumulator cell written and read once (4 bytes
    each way), C written once; for the dot backend also its ``launches``
    stage products at the float32 peak (2 operations a multiply), the
    larger of the two."""
    nnz_a = int(A.getnnz())
    bytes_ms = (2 * 12 * nnz_a + 8 * accumulator_cells(plan, A) + 12 * nnz_c) / PEAK_BYTES * 1e3
    ops_ms = 0.0
    if plan["backend"] == "dot" and launches:
        br = min(plan["block_rows"], A.local_rows)
        ops_ms = (launches * 2.0 * _pad128(br) * _pad128(A.local_rows)
                  * _pad128(plan["block_cols"]) / PEAK_F32_OPS * 1e3)
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def step_windowed_aa16(dev, aa: dict) -> dict:
    """Step 1: A·A at scale 16 on 4×4 through plain ``spgemm_auto``: the
    router answers windowed (and windowed with backend="dot"), the scatter
    backend's blocked form runs; min_plus and max_min equal ``spgemm``
    (sort) bit for bit; plus_times within float32 rounding of the exact
    float64 product (duplicates fold by sum, so its largest sum passes 2^24
    and the order of a sum shows)."""
    grid = Grid.make(GEN_GRID, GEN_GRID, device=dev)
    n = 1 << GEN_SCALE
    lines = {}
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        r, c, v, A = weighted_rmat(GEN_SCALE, dev, grid, sr)
        tier, dot_tier = choose_spgemm_tier(sr, A, A), choose_spgemm_tier(sr, A, A, backend="dot")
        if (tier, dot_tier) != ("windowed", "windowed"):
            raise AssertionError(f"A·A {sr.name}: routed to {tier} ({dot_tier} with dot)")
        ref = live_entries(spgemm(sr, A, A))
        got, ms, peak = step_times(lambda: spgemm_auto(sr, A, A), live_entries, WIN_REPS)
        plan = spgemm_windowed.last_plan
        if (plan["backend"], plan["form"]) != ("scatter", "blocked"):
            raise AssertionError(f"A·A {sr.name}: ran {plan['backend']} {plan['form']}")
        nnz = int(got[0].numel())
        exact = sr is not PLUS_TIMES
        if nnz != GEN_AA_NNZ or (exact and not same_entries(got, ref)):
            raise AssertionError(f"A·A {sr.name}: windowed differs from spgemm (sort)")
        if not bool(torch.isfinite(got[1]).all()):
            raise AssertionError(f"A·A {sr.name}: non-finite values")
        b_ms, b_by = windowed_bound(plan, A, nnz, 0)
        line = {"phase": "spgemm_windowed", "step": "aa16", "semiring": sr.name,
                "scale": GEN_SCALE, "grid": f"{GEN_GRID}x{GEN_GRID}", "router": tier,
                "router_dot": dot_tier, "equal_to_sort": exact, "nnz_out": nnz, "ms": ms,
                "nnz_out_per_s": nnz / (ms / 1e3), "peak_mem_gb": peak,
                "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
                "product_bound_ms": esc_bytes_bound_ms(int(A.getnnz()), nnz),
                "share_of_product_bound": esc_bytes_bound_ms(int(A.getnnz()), nnz) / ms,
                "accumulator_cells": accumulator_cells(plan, A),
                "esc_sort_ms": aa[sr.name]["sort"]["ms"], "plan": plan_summary(plan)}
        if sr is PLUS_TIMES:
            line["largest_sum"] = float(got[1].max())
            line["max_rel_err"] = plus_times_check(got, r, c, v, n)
        emit(line)
        lines[sr.name] = line
        del A, ref, got
        torch.cuda.empty_cache()
    _F64_AA.clear()
    return lines


def k1_at_window_shape(sr, A: SpParMat, plan: dict, B: SpParMat | None = None) -> dict:
    """The dot backend's first K1 launch of a call A·B (B defaults to A;
    tile (0, 0), stage 0, block 0, window 0) rebuilt from the path's own
    operands, launched once and held bit for bit against the plain
    version; both timed. The launch is not counted."""
    kind = _PALLAS_KINDS[sr.name]
    B = A if B is None else B
    a, b = A.local_tile(0, 0), B.local_tile(0, 0)
    rb = min(plan["block_rows"], A.local_rows)
    arows, pk, pwin = _pad128(rb), _pad128(B.local_rows), _pad128(plan["block_cols"])
    da = densify_combine(sr, _shift_rowblock(mask_rows(a, 0, rb), 0, arows), arows, pk)
    bs, starts = _colmajor_with_starts(b, plan["block_cols"])
    panel = _dense_col_panel(sr, bs, starts, 0, plan["block_cols"], pk, pwin, plan["panel_cap"])
    return hold_k1(kind, da, panel)


def hold_k1(kind: str, da: torch.Tensor, panel: torch.Tensor) -> dict:
    """One K1 launch on the path's own operands, not counted, held bit for
    bit against the plain version; both timed."""
    counted = semiring_matmul.launches
    got, ms, _ = timed_call(lambda: semiring_matmul(kind, da, panel))
    semiring_matmul.launches = counted
    want, plain_ms, _ = timed_call(lambda: semiring_matmul_reference(kind, da, panel))
    m, k = da.shape
    n = panel.shape[1]
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"K1 {kind} at {[m, k, n]} differs from its plain version")
    return {"kind": kind, "shape": [m, k, n], "variant": semiring_matmul.last_variant,
            "bit_equal": True, "max_abs_err": max_abs_err(got, want), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound(m, k, n)[0]}


def step_windowed_dot(dev) -> tuple[dict, dict, dict]:
    """Step 2: R-MAT scale 15 on 2×2 (16384-wide tiles) through
    ``spgemm_windowed(backend="dot")``: equal to the scatter backend and to
    ``spgemm`` (sort); K1 launches equal to tiles × stages × live windows a
    call; the carousel once for min_plus; K1 at the window shape held
    against its plain version for min_plus and max_min. Returns (lines, K1
    launches by kind, the tropical products' live entries on the host, which
    phase 14's 3D dot step holds its products against)."""
    grid = Grid.make(WIN_DOT_GRID, WIN_DOT_GRID, device=dev)
    p = WIN_DOT_GRID
    lines, k1, host = {}, {}, {}
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        _, _, _, A = weighted_rmat(WIN_DOT_SCALE, dev, grid, sr)
        ref = live_entries(spgemm(sr, A, A))
        if not same_entries(live_entries(spgemm_windowed(sr, A, A)), ref):
            raise AssertionError(f"scale-15 {sr.name}: scatter backend differs from sort")
        before = semiring_matmul.launches
        got, ms, peak = step_times(lambda: spgemm_windowed(sr, A, A, backend="dot"),
                                   live_entries, WIN_REPS)
        launched = semiring_matmul.launches - before
        plan = spgemm_windowed.last_plan
        per_call = 0 if sr is PLUS_TIMES else p * p * p * plan["packed"]  # tiles × stages × windows
        if launched != (1 + WIN_REPS) * per_call:
            raise AssertionError(f"dot {sr.name}: {launched} K1 launches, the plan says "
                                 f"{(1 + WIN_REPS) * per_call}")
        if not same_entries(got, ref):
            raise AssertionError(f"dot {sr.name}: differs from spgemm (sort)")
        if sr is PLUS_TIMES and float(got[1].max()) >= 2**24:
            raise AssertionError("plus_times sums reach 2^24: an exact comparison is void")
        nnz = int(got[0].numel())
        b_ms, b_by = windowed_bound(plan, A, nnz, per_call)
        line = {"phase": "spgemm_windowed", "step": "dot", "semiring": sr.name,
                "scale": WIN_DOT_SCALE, "grid": f"{p}x{p}", "mode": "f32", "nnz_out": nnz,
                "largest_value": float(got[1].max()),
                "equal_to_sort_and_scatter": True, "k1_launches_per_call": per_call,
                "ms": ms, "nnz_out_per_s": nnz / (ms / 1e3), "peak_mem_gb": peak,
                "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
                "plan": plan_summary(plan)}
        if sr is MIN_PLUS:
            before = semiring_matmul.launches
            ring, ring_ms, _ = timed_call(lambda: live_entries(
                spgemm_windowed(sr, A, A, backend="dot", ring=True)))
            if semiring_matmul.launches - before != per_call or not same_entries(ring, got):
                raise AssertionError("dot min_plus: the carousel differs from the gathered run")
            line["ring"] = {"equal": True, "ms": ring_ms}
            launched += per_call
        if sr is not PLUS_TIMES:
            line["k1_window_shape"] = k1_at_window_shape(sr, A, plan)
            k1[sr.name] = launched
            host[sr.name] = tuple(t.cpu() for t in got)
        emit(line)
        lines[sr.name] = line
        del A, ref, got
        torch.cuda.empty_cache()
    return lines, k1, host


def step_windowed_local(dev, mxu13: dict) -> tuple[dict, dict]:
    """Step 3: phase 5's scale-13 graph on 1×1 through ``spgemm_auto(tier=
    "windowed")``: the scatter backend, and the dot backend with the oracle
    off and on (``local_spgemm_windowed``, one K1 launch a tropical call);
    each equal to phase 5's mxu result bit for bit."""
    grid = Grid.make(1, 1, device=dev)
    lines, k1 = {}, {}
    forms = (("scatter", {}), ("dot", {"backend": "dot"}),
             ("dot_oracle", {"backend": "dot", "oracle": True}))
    for sr in (MIN_PLUS, MAX_MIN, PLUS_TIMES):
        _, _, _, A = weighted_rmat(SCALE, dev, grid, sr)
        line = {"phase": "spgemm_windowed", "step": "local", "semiring": sr.name,
                "scale": SCALE, "grid": "1x1", "nnz_out": int(mxu13[sr.name][0].numel())}
        for name, kw in forms:
            before = semiring_matmul.launches
            got, ms, peak = step_times(lambda: spgemm_auto(sr, A, A, tier="windowed", **kw),
                                       live_entries, WIN_REPS)
            launched = semiring_matmul.launches - before
            plan = spgemm_windowed.last_plan
            per_call = plan["packed"] if name != "scatter" and sr is not PLUS_TIMES else 0
            if plan["form"] != "local" or launched != (1 + WIN_REPS) * per_call:
                raise AssertionError(f"local {sr.name} {name}: {plan['form']}, {launched} K1")
            if not same_entries(got, mxu13[sr.name]):
                raise AssertionError(f"local {sr.name} {name}: differs from the mxu tier")
            line[name] = {"ms": ms, "nnz_out_per_s": line["nnz_out"] / (ms / 1e3),
                          "peak_mem_gb": peak, "k1_launches_per_call": per_call,
                          "packed": plan["packed"], "packed_before_oracle":
                              plan.get("packed_before_oracle"), "out_caps": plan["out_caps"]}
            k1[sr.name] = k1.get(sr.name, 0) + launched
        emit(line)
        lines[sr.name] = line
        del A
    return lines, {k: v for k, v in k1.items() if k != "plus_times"}


def step_semantic(dev, A: SpParMat, g: dict) -> dict:
    """Step 4: phase 9's scale-20 ``SpParMat`` with one attribute, ``w[i] +
    w[j]`` for a seeded uniform ``w`` a vertex (symmetric: about half the
    edges pass ``< 1``). ``filtered_bfs`` materialized and masked from the
    first root: equal parents and levels, equal to a numpy BFS over the
    passing edges (max-id parents); ``filtered_mis`` independent and
    maximal over them; each timed a call (host clock)."""
    n = len(g["deg"])
    rows, cols = g["rows"].astype(np.int64), g["cols"].astype(np.int64)
    w = np.random.default_rng(SEMANTIC_SEED).random(n).astype(np.float32)
    wpad = torch.from_numpy(np.append(w, np.float32(0))).to(dev)
    t = A.local_tile(0, 0)
    attr = wpad[torch.clamp(t.rows, max=n).long()] + wpad[torch.clamp(t.cols, max=n).long()]
    G = SemanticGraph(structure=A, attrs={"w": attr.view(1, 1, -1)})

    def keep(a):
        return a["w"] < 1.0

    passing = (w[rows] + w[cols]) < np.float32(1.0)
    kr, kc = rows[passing], cols[passing]  # still sorted by row
    indptr = np.concatenate([[0], np.cumsum(np.bincount(kr, minlength=n))])
    root = int(g["roots"][0])
    want_l = host_bfs_levels(indptr, kc, root)
    want_p = host_max_parents(kr, kc, indptr, want_l, root)
    line = {"phase": "spgemm_windowed", "step": "semantic", "n": n, "nnz": len(rows),
            "passing": int(passing.sum()), "root": root}
    found = []
    for materialize in (True, False):
        def search():
            return filtered_bfs(G, keep, root, materialize=materialize)

        search()  # warm-up
        runs = [timed_call(search) for _ in range(SPMAT_REPS)]
        p_, l_, it = runs[-1][0]
        found.append((p_.to_global(), l_.to_global()))
        line["bfs_materialized" if materialize else "bfs_masked"] = {
            "levels": it, "ms_per_call": [r[2] * 1e3 for r in runs],
            "device_ms": [r[1] for r in runs]}
    for p_, l_ in found:
        if not (np.array_equal(l_, want_l) and np.array_equal(p_, want_p)):
            raise AssertionError("filtered_bfs differs from the numpy BFS over passing edges")
    gen = torch.Generator(device=dev)
    filtered_mis(G, keep, gen.manual_seed(1))  # warm-up
    runs = [timed_call(lambda: filtered_mis(G, keep, gen.manual_seed(1)))
            for _ in range(SPMAT_REPS)]
    status, rounds = runs[-1][0]
    member = status.to_global() == 1
    covered = np.zeros(n, bool)
    covered[kr[member[kc]]] = True
    if (member[kr] & member[kc]).any() or not (member | covered).all():
        raise AssertionError("filtered_mis: not independent and maximal over passing edges")
    line["mis"] = {"rounds": rounds, "members": int(member.sum()), "independent": True,
                   "maximal": True, "ms_per_call": [r[2] * 1e3 for r in runs],
                   "device_ms": [r[1] for r in runs]}
    emit(line)
    return line


def phase_spgemm_windowed(dev, t_start: float, aa: dict, mxu13: dict, A20: SpParMat,
                          g: dict) -> dict:
    """Phase 11 (module docstring): steps 1-4 with K1's and K2's launch
    counts set to 0 just before and read just after. K1 runs only in the
    dot backend's tropical calls, and as often as their plans say: step 2
    (warm-up and ``WIN_REPS`` timed calls, each tiles × stages × live
    windows; min_plus once more in the carousel) plus step 3 (the same
    three calls, one launch each, with the oracle off and on). K2 never."""
    emit({"phase": "spgemm_windowed", "step": "elapsed", "total_s": time.perf_counter() - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        step_s[name] = time.perf_counter() - t0
        return out

    aa_w = timed("aa16", step_windowed_aa16, dev, aa)
    if semiring_matmul.launches:
        raise AssertionError("the scatter backend launched K1")
    dot, k1_dot, dot_host = timed("dot", step_windowed_dot, dev)
    local, k1_local = timed("local", step_windowed_local, dev, mxu13)
    sem = timed("semantic", step_semantic, dev, A20, g)
    k1 = {kind: k1_dot[kind] + k1_local[kind] for kind in k1_dot}
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if launches != {"k1": sum(k1.values()), "k2": 0} or min(k1.values()) < 1:
        raise AssertionError(f"spgemm_windowed launched {launches}; its plans say K1 {k1}, K2 0")
    emit({"phase": "spgemm_windowed", "step": "checks", "hand_kernel_launches": launches,
          "k1_by_semiring": k1, "step_s": step_s, "total_s": time.perf_counter() - t_start})
    return {"aa16": aa_w, "dot": dot, "local": local, "semantic": sem, "k1": k1,
            "dot_host": dot_host}


# --- phase 12: the applications (MCL, matchings, orderings, SpMM) --------------

# HipMCL's InitParam (MCL.cpp:144-150): prune limit 1e-4, select 1100, recover
# 1400 at 0.9; inflation 2
MCL_PARAMS = dict(hard_threshold=1e-4, select_num=1100, recover_num=1400, recover_pct=0.9)
MCL_SCALE, MCL_EDGEFACTOR = 14, 8  # the reference's app benchmark graph
MCL_DENSE_MAX_ITERS = 20  # a depth cut: PERF.md section 4
MCL_PERTURB = 5e-5  # the reference's app benchmark operating point
# the sparse loop at scale 14 runs one iteration (its second expands 1.2e10
# products, PERF.md section 4); three iterations are held against float64 on
# the same recipe at scale 12, phased so that a phase's expansion fits
MCL_SPARSE_MAX_ITERS = 1
MCL_CHECK_SCALE, MCL_CHECK_ITERS, MCL_CHECK_PHASES = 12, 3, 8
MCL_CHAOS_RTOL = 1e-3
CLIQUES, CLIQUE_SIZE, CLIQUE_BRIDGE = 64, 64, 0.1
MATCH_SCALE, MATCH_WEIGHT_SEED = 18, 5
MD_SCALE = 10
SPMM_F, SPMM_HOPS, SPMM_QUERIES, SPMM_PADS, SPMM_SEED = 64, 2, 128, 8, 13
APPS_REPS = 1  # timed calls after the warm-up


class Readbacks:
    """Counts device → host reads of CUDA tensors (``bool``, ``int``,
    ``float``, ``item``, ``cpu``, ``tolist``) while active: the readbacks
    a call of the port makes."""

    METHODS = ("__bool__", "__int__", "__float__", "__index__", "item", "cpu", "tolist")

    def __enter__(self):
        self.count = 0
        self.saved = {m: getattr(torch.Tensor, m) for m in self.METHODS}

        def wrap(orig):
            def f(t, *a, **k):
                if t.is_cuda:
                    self.count += 1
                return orig(t, *a, **k)
            return f

        for m, orig in self.saved.items():
            setattr(torch.Tensor, m, wrap(orig))
        return self

    def __exit__(self, *exc):
        for m, orig in self.saved.items():
            setattr(torch.Tensor, m, orig)


def apps_times(fn, reps: int = APPS_REPS) -> dict:
    """A step's protocol: one warm-up call (its result is what the checks
    read; its readbacks are counted), then ``reps`` calls, each timed with
    CUDA events and on the host clock around the whole call (the warm-up
    too, the only time of a step run once). Peak memory over all calls."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Readbacks() as rb:
        out, warm_ms, warm_s = timed_call(fn)
    dev_ms, wall_s = [], []
    for _ in range(reps):
        _, ms, s = timed_call(fn)
        dev_ms.append(ms)
        wall_s.append(s)
    return {"out": out, "warmup_ms": warm_ms, "warmup_wall_s": warm_s, "ms": dev_ms,
            "wall_s": wall_s, "readbacks_per_call": rb.count,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def timing(t: dict) -> dict:
    return {k: v for k, v in t.items() if k != "out"}


def mcl_matrix(scale: int, dev) -> tuple[SpParMat, dict]:
    """The R-MAT graph of the reference's MCL benchmark recipe (symmetric,
    deduplicated, no loops; ``mcl`` adds them) on a 1×1 grid, unit weights."""
    g = build_graph(scale, MCL_EDGEFACTOR, nroots=1, device=dev)
    n = 1 << scale
    return SpParMat.from_global_coo(Grid.make(1, 1, device=dev), g["rows"], g["cols"],
                                    np.ones(len(g["rows"]), np.float32), n, n), g


def mcl_prune(C: SpParMat) -> SpParMat:
    """The sparse loop's prune hook at ``MCL_PARAMS``."""
    return mcl_prune_recovery_select(C, **MCL_PARAMS)


def check_least_ids(labels: np.ndarray) -> int:
    """Each label is the least vertex id of its cluster; the cluster count."""
    uniq, first = np.unique(labels, return_index=True)
    if not np.array_equal(uniq, labels[first]) or not np.array_equal(uniq, first):
        raise AssertionError("mcl: a label is not its cluster's least vertex id")
    return len(uniq)


def host_mcl_chaos(rows, cols, n: int, iters: int) -> list:
    """MCL in float64 with scipy: the same steps as the port's sparse loop
    (loops, column-stochastic, then A², hard threshold, per-column select /
    recover thresholds with ties kept, column-stochastic, chaos, inflation
    2), sharing no code with it. The chaos of each iteration."""
    p = MCL_PARAMS

    def colnorm(M):
        s = np.asarray(M.sum(0)).ravel()
        return (M @ sp.diags(1.0 / np.where(s == 0, 1, s))).tocsc()

    def colids(M):
        return np.repeat(np.arange(M.shape[1]), np.diff(M.indptr))

    def kth(M, k):
        cols_ = colids(M)
        sd = M.data[np.lexsort((-M.data, cols_))]
        cnt = np.diff(M.indptr)
        out = np.full(M.shape[1], -np.inf)
        ok = cnt >= k
        out[ok] = sd[M.indptr[:-1][ok] + k - 1]
        return out

    A = sp.csc_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    A = colnorm(A + sp.identity(n, format="csc"))
    out = []
    for _ in range(iters):
        C = (A @ A).tocsc()
        C.data[C.data < p["hard_threshold"]] = 0
        C.eliminate_zeros()
        C.sort_indices()
        cc = colids(C)
        s_th = kth(C, p["select_num"])
        keep = C.data >= s_th[cc]
        kept = np.bincount(cc, weights=np.where(keep, C.data, 0), minlength=n)
        orig = np.bincount(cc, weights=C.data, minlength=n)
        need = kept < p["recover_pct"] * orig
        if need.any():
            th = np.where(need, np.minimum(kth(C, p["recover_num"]), s_th), s_th)
            keep = C.data >= th[cc]
        C.data = np.where(keep, C.data, 0)
        C.eliminate_zeros()
        C = colnorm(C)
        cc = colids(C)
        mx = np.full(n, -np.inf)
        np.maximum.at(mx, cc, C.data)
        ssq = np.bincount(cc, weights=C.data**2, minlength=n)
        nz = np.diff(C.indptr)
        out.append(float(np.where(nz > 0, (mx - ssq) * nz, 0).max()))
        A = C.copy()
        A.data = A.data**2
        A = colnorm(A)
    return out


def check_iterate(C: SpParMat) -> dict:
    """An iterate after prune and re-normalisation: every non-empty column
    sums to 1 within 2 · nnz_j · 2^-24 (its nnz_j float32 quotients summed
    again in another order), and holds fewer than max(select, recover)
    entries above its least kept value (the threshold keeps ties)."""
    sums = C.reduce(PLUS_TIMES, "rows").blocks
    nnz = C.nnz_per_column().blocks
    err = torch.where(nnz > 0, (sums - 1).abs(), 0)
    over = float((err - 2 * nnz * 2.0**-24).max())
    colmin = C.reduce(MIN_PLUS, "rows")
    above = C.dim_apply(colmin, lambda v, m: (v > m).to(torch.float32), "cols").reduce(
        PLUS_TIMES, "rows").blocks
    most = int(above.max())
    cap = max(MCL_PARAMS["select_num"], MCL_PARAMS["recover_num"])
    if over > 0 or most >= cap:
        raise AssertionError(f"mcl iterate: a column sum is {over} past its bound, {most} "
                             f"entries above a column's least kept value (cap {cap})")
    return {"max_col_sum_err": float(err.max()), "max_col_nnz": int(nnz.max()),
            "max_above_least_kept": most, "nnz": int(C.getnnz())}


def step_mcl(dev) -> dict:
    """Step 1: MCL at HipMCL's defaults. (a) the dense loop on R-MAT scale
    14 (bf16x3, plateau kicks at 5e-5) to convergence or its iteration cap;
    (b) the sparse loop there (phases 1, 2 and the block loop, one
    iteration: PERF.md section 4); three sparse iterations driven by hand on
    the scale-12 graph, each iterate checked and its chaos held to a
    float64 MCL on the host; a ring of 64 cliques of 64 vertices through
    both loops, which must return the cliques."""
    A14, g14 = mcl_matrix(MCL_SCALE, dev)
    n = 1 << MCL_SCALE
    out = {"scale": MCL_SCALE, "n": n, "edges": len(g14["rows"]), **MCL_PARAMS}

    dense = apps_times(lambda: (*mcl(A14, 2.0, max_iters=MCL_DENSE_MAX_ITERS,
                                     expansion="dense", dense_mode="bf16x3",
                                     perturb_delta=MCL_PERTURB, **MCL_PARAMS),
                                dict(mcl_mod.mcl.last_run)))
    labels, it, ch, run = dense["out"]
    clusters = check_least_ids(labels.to_global())
    npad = -(-n // 128) * 128
    ops_ms = 3 * 2.0 * npad**3 / PEAK_F32_OPS * 1e3  # three float32 products an iteration
    iter_ms = min(dense["ms"]) / max(it, 1)
    out["dense"] = {"iterations": it, "chaos": ch, "converged": ch < 1e-3,
                    "chaos_trajectory": run["chaos"], "kicks": run["kicks"],
                    "clusters": clusters, **timing(dense), "ms_per_iteration": iter_ms,
                    "iteration_bound_ms": ops_ms, "bound_by": "operations",
                    "iteration_share_of_bound": ops_ms / iter_ms}
    emit({"phase": "apps", "step": "mcl_dense", **out["dense"]})
    del labels
    torch.cuda.empty_cache()

    sparse = {}
    for name, kw in (("phases1", dict(phases=1)), ("phases2", dict(phases=2)),
                     ("block4", dict(chaos_every=4))):
        fn = lambda kw=kw: (*mcl(A14, 2.0, max_iters=MCL_SPARSE_MAX_ITERS, **kw, **MCL_PARAMS),
                            dict(mcl_mod.mcl.last_run))
        t = apps_times(fn) if name == "phases1" else apps_times(fn, reps=0)
        labels, it, ch, run = t["out"]
        line = {"iterations": it, "chaos": ch, "loop": run, **timing(t),
                "clusters": check_least_ids(labels.to_global())}
        sparse[name] = line
        emit({"phase": "apps", "step": f"mcl_sparse_{name}", "scale": MCL_SCALE, **line})
    # a column's sums of up to ~1100 float32 terms in another order, scaled
    # by its entry count: within 1100 * 2^-24 < 1e-4 relative of each other
    chs = [v["chaos"] for v in sparse.values()]
    if max(chs) - min(chs) > 1e-4 * max(chs):
        raise AssertionError(f"mcl: the sparse loops' first chaos differ: {chs}")
    # one iteration's share: the expansion (ESC, E1's product) and the rest
    A = mcl_mod.make_col_stochastic(A14.add_loops(1))
    exp = apps_times(lambda: mem_efficient_spgemm(PLUS_TIMES, A, A, 1, prune_fn=mcl_prune))
    flops = estimate_flops(A, A)
    nnz_out = int(exp["out"].getnnz())
    bound = esc_bytes_bound_ms(int(A.getnnz()), nnz_out)
    ar, ac, av = A.to_global_coo()
    it_line = {"expansion_with_prune": timing(exp), "products": flops, "nnz_out": nnz_out,
               "bound_ms": bound, "bound_by": "bytes", "share": bound / min(exp["ms"]),
               "iteration_ms": min(sparse["phases1"]["ms"]),
               **library_spgemm_ms(ar, ac, av, n, 1, dev)}
    emit({"phase": "apps", "step": "mcl_sparse_iteration", "scale": MCL_SCALE, **it_line})
    out["sparse"] = {**sparse, "iteration": it_line}
    del A, exp
    torch.cuda.empty_cache()

    # three iterations, every iterate checked, chaos against float64
    A12, g12 = mcl_matrix(MCL_CHECK_SCALE, dev)
    t0 = time.perf_counter()
    want = host_mcl_chaos(g12["rows"], g12["cols"], 1 << MCL_CHECK_SCALE, MCL_CHECK_ITERS)
    host_s = time.perf_counter() - t0
    A = mcl_mod.make_col_stochastic(A12.add_loops(1))
    iters = []
    for k in range(MCL_CHECK_ITERS):
        C = mem_efficient_spgemm(PLUS_TIMES, A, A, MCL_CHECK_PHASES, prune_fn=mcl_prune)
        C = mcl_mod.make_col_stochastic(C)
        ch = float(mcl_mod.chaos(C))
        iters.append({"chaos": ch, "float64_chaos": want[k], **check_iterate(C)})
        if abs(ch - want[k]) > MCL_CHAOS_RTOL * want[k]:
            raise AssertionError(f"mcl iteration {k + 1}: chaos {ch}, float64 {want[k]}")
        A = mcl_mod.inflate(C, 2.0)
    out["float64_check"] = {"scale": MCL_CHECK_SCALE, "phases": MCL_CHECK_PHASES,
                            "rtol": MCL_CHAOS_RTOL, "iterations": iters, "host_s": host_s}
    emit({"phase": "apps", "step": "mcl_float64_check", **out["float64_check"]})
    del A, C, A12
    torch.cuda.empty_cache()

    # the clique ring: both loops give the cliques exactly
    nc = CLIQUES * CLIQUE_SIZE
    blk = np.arange(nc) // CLIQUE_SIZE
    ii, jj = np.nonzero(blk[:, None] == blk[None, :])
    keep = ii != jj
    ends = np.arange(CLIQUES) * CLIQUE_SIZE
    bi, bj = ends + CLIQUE_SIZE - 1, (ends + CLIQUE_SIZE) % nc
    r = np.concatenate([ii[keep], bi, bj])
    c = np.concatenate([jj[keep], bj, bi])
    v = np.concatenate([np.ones(keep.sum(), np.float32),
                        np.full(2 * CLIQUES, CLIQUE_BRIDGE, np.float32)])
    ring = SpParMat.from_global_coo(Grid.make(1, 1, device=dev), r, c, v, nc, nc)
    want_labels = blk * CLIQUE_SIZE
    ring_out = {}
    for name, kw in (("dense", dict(expansion="dense", perturb_delta=MCL_PERTURB)),
                     ("sparse", {})):
        lab, it, ch = mcl(ring, 2.0, **kw, **MCL_PARAMS)
        if not np.array_equal(lab.to_global(), want_labels) or not ch < 1e-3:
            raise AssertionError(f"mcl {name}: the clique ring's clusters are not the cliques")
        ring_out[name] = {"iterations": it, "chaos": ch}
    out["clique_ring"] = {"cliques": CLIQUES, "size": CLIQUE_SIZE, **ring_out}
    emit({"phase": "apps", "step": "mcl_clique_ring", **out["clique_ring"]})
    return out


def check_matching(rows, cols, n: int, mr: np.ndarray, mc: np.ndarray) -> int:
    """A valid matching of the edge list (each matched row's column an edge,
    the two mate arrays inverse) that is maximal (no edge with both ends
    free); its cardinality."""
    i = np.flatnonzero(mr >= 0)
    j = mr[i].astype(np.int64)
    keys = rows.astype(np.int64) * n + cols
    pos = np.searchsorted(keys, i * n + j)
    ok = (pos < len(keys)) & (keys[np.minimum(pos, len(keys) - 1)] == i * n + j)
    if not ok.all() or not (mc[j] == i).all() or (mc >= 0).sum() != len(i):
        raise AssertionError("matching: not a valid matching of the edges")
    if ((mr[rows] < 0) & (mc[cols] < 0)).any():
        raise AssertionError("matching: not maximal (an edge has both ends free)")
    return len(i)


def step_matching(dev, g18: dict, g20: dict) -> dict:
    """Step 2: on ``build_graph``'s scale 18 (phase 10's), Karp-Sipser
    ``maximal_matching``, ``maximum_matching`` (device phases) and ``awpm``
    (weights ``default_rng(5).random + 0.1``), and the first two on phase
    8's scale 20: valid and maximal over the edge list, the maximum
    cardinality and AWPM's equal to scipy's. Then the phases' layer SpMV
    timed a launch at scale 18."""
    out = {}
    for scale, g in ((MATCH_SCALE, g18), (BFS_SCALE, g20)):
        rows, cols = g["rows"], g["cols"]
        n = len(g["deg"])
        grid = Grid.make(1, 1, device=dev)
        A = SpParMat.from_global_coo(grid, rows, cols, np.ones(len(rows), np.float32), n, n)
        t0 = time.perf_counter()
        csr = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
        want = int((csgraph.maximum_bipartite_matching(csr, perm_type="column") >= 0).sum())
        res = {"n": n, "edges": len(rows), "scipy_cardinality": want,
               "scipy_s": time.perf_counter() - t0}
        runs = [("maximal_ks", lambda: maximal_matching(A)),
                ("maximum", lambda: maximum_matching(A))]
        if scale == MATCH_SCALE:
            w = (np.random.default_rng(MATCH_WEIGHT_SEED).random(len(rows)) + 0.1).astype(
                np.float32)
            Aw = SpParMat.from_global_coo(grid, rows, cols, w, n, n)
            runs.append(("awpm", lambda: awpm(Aw)))
        for name, fn in runs:
            maximum_matching_device.last_run = None
            t = apps_times(lambda: (fn(), dict(maximal_matching.last_run),
                                    dict(maximum_matching_device.last_run or {})))
            (mr, mc), ks_run, mm_run = t["out"]
            card = check_matching(rows, cols, n, mr.to_global(), mc.to_global())
            line = {"cardinality": card, **timing(t), "karp_sipser_rounds": ks_run["rounds"]}
            if name != "maximal_ks":
                if card != want:
                    raise AssertionError(f"{name} scale {scale}: cardinality {card}, scipy "
                                         f"{want}")
                line.update(phases=mm_run["phases"], bfs_depths=mm_run["depths"],
                            ms_per_phase=min(t["ms"]) / mm_run["phases"])
            if name == "awpm":
                mrg = mr.to_global()
                i = np.flatnonzero(mrg >= 0)
                keys = rows.astype(np.int64) * n + cols
                line["matched_weight"] = float(
                    w[np.searchsorted(keys, i * n + mrg[i])].astype(np.float64).sum())
            res[name] = line
            emit({"phase": "apps", "step": f"matching_{name}", "scale": scale,
                  "scipy_cardinality": want, **line})
        out[scale] = res
        if scale == MATCH_SCALE:
            # a phase's layer SpMV (SELECT2ND_MIN over Aᵀ, an int32 frontier)
            AT = A.transpose().apply(ones_f32)
            fr = torch.arange(n, device=dev, dtype=torch.int32)
            fr = torch.where(fr % 2 == 0, fr, torch.iinfo(torch.int32).max)
            x = DistVec(blocks=fr.view(1, n), length=n, align="row", grid=grid)
            ms = time_cuda_ms(lambda: dist_spmv(SELECT2ND_MIN, AT, x), 5)
            bound = spmv_bytes(len(rows), n, False) / PEAK_BYTES * 1e3
            out["layer_spmv"] = {"scale": scale, "ms": ms, "bound_ms": bound,
                                 "bound_by": "bytes", "share": bound / ms}
            emit({"phase": "apps", "step": "matching_layer_spmv", **out["layer_spmv"]})
            del AT, Aw
        del A
        torch.cuda.empty_cache()
    return out


def host_min_degree(rows, cols, n: int) -> np.ndarray:
    """Minimum-degree elimination in Python sets: each step the least-degree
    live vertex (least id on ties), its live neighbours joined into a
    clique, the vertex removed."""
    adj = [set() for _ in range(n)]
    for a, b in zip(rows.tolist(), cols.tolist()):
        if a != b:
            adj[a].add(b)
            adj[b].add(a)
    alive = np.ones(n, bool)
    order = []
    for _ in range(n):
        deg = np.array([len(s) if alive[v] else np.iinfo(np.int32).max
                        for v, s in enumerate(adj)])
        v = int(np.argmin(deg))
        if not alive[v]:
            break
        order.append(v)
        alive[v] = False
        nbrs = sorted(adj[v])
        for a in nbrs:
            adj[a].discard(v)
            if len(nbrs) > 1:
                adj[a].update(b for b in nbrs if b != a)
        adj[v] = set()
    return np.asarray(order + np.flatnonzero(alive).tolist())


def step_ordering(dev, g20: dict, A20: SpParMat) -> dict:
    """Step 3: ``rcm_ordering`` on phase 8's scale-20 graph with ``root=0``
    and with the pseudo-peripheral probe, each a permutation equal to the
    reversed numpy lexsort of (level, degree, id) from a host BFS of the
    same root, with the bandwidth before and after; then
    ``minimum_degree_ordering`` on R-MAT scale 10 against a host
    elimination with the same tie rule."""
    rows, cols, deg = g20["rows"], g20["cols"], g20["deg"]
    n = len(deg)
    indptr = np.searchsorted(rows.astype(np.int64), np.arange(n + 1))
    before = int(np.abs(rows.astype(np.int64) - cols).max())
    out = {"scale": BFS_SCALE, "n": n, "bandwidth_before": before}
    probe = apps_times(lambda: pseudo_peripheral_vertex(A20), reps=0)
    for name, root in (("root0", 0), ("probe", probe["out"])):
        t = apps_times(lambda: rcm_ordering(A20, root=None if name == "probe" else 0))
        perm = t["out"].to_global().astype(np.int64)
        lv = host_bfs_levels(indptr, cols.astype(np.int64), root)
        lv = np.where(lv < 0, n, lv)
        want = np.lexsort((np.arange(n), deg, lv))[::-1]
        if not np.array_equal(np.sort(perm), np.arange(n)) or not np.array_equal(perm, want):
            raise AssertionError(f"rcm {name}: not the reversed (level, degree, id) order")
        pinv = np.empty(n, np.int64)
        pinv[perm] = np.arange(n)
        line = {"root": int(root), **timing(t), "bandwidth_before": before,
                "bandwidth_after": int(np.abs(pinv[rows] - pinv[cols]).max()),
                "unreached": int((lv == n).sum())}
        out[name] = line
        emit({"phase": "apps", "step": f"rcm_{name}", **line})
    out["probe_ms"] = probe["ms"]
    out["probe_wall_s"] = probe["wall_s"]
    gmd = build_graph(MD_SCALE, BFS_EDGEFACTOR, nroots=1, device=dev)
    nmd = 1 << MD_SCALE
    Amd = SpParMat.from_global_coo(Grid.make(1, 1, device=dev), gmd["rows"], gmd["cols"],
                                   np.ones(len(gmd["rows"]), np.float32), nmd, nmd)
    t = apps_times(lambda: minimum_degree_ordering(Amd), reps=0)
    want = host_min_degree(gmd["rows"], gmd["cols"], nmd)
    if not np.array_equal(t["out"].to_global(), want):
        raise AssertionError("minimum_degree_ordering differs from the host elimination")
    out["min_degree"] = {"scale": MD_SCALE, "n": nmd, "edges": len(gmd["rows"]), **timing(t)}
    emit({"phase": "apps", "step": "min_degree", **out["min_degree"]})
    return out


def spmm_bound_ms(E: EllParMat, n: int, F: int) -> float:
    """Bytes bound of one ELL SpMM hop: every slot's column id and value
    (4 + 4 bytes) and every bucket row's id, X read once and Y written once
    (F float32 lanes a row)."""
    slots = sum(bc.numel() for bc, _, _ in E.buckets)
    rowids = sum(br.numel() for _, _, br in E.buckets)
    return (8 * slots + 4 * rowids + 2 * 4 * n * F) / PEAK_BYTES * 1e3


def library_spmm_ms(rows, cols, n: int, X: np.ndarray, dev) -> float:
    """``torch.sparse.mm`` (the library's SpMM) of the unit-valued graph as
    CSR (rows sorted) and X: one unnormalised hop, ms a launch."""
    indptr = np.searchsorted(rows.astype(np.int64), np.arange(n + 1))
    csr = torch.sparse_csr_tensor(torch.from_numpy(indptr),
                                  torch.from_numpy(cols.astype(np.int64)), torch.ones(len(cols)),
                                  size=(n, n), check_invariants=True).to(dev)
    Xt = torch.from_numpy(X).to(dev)
    return time_cuda_ms(lambda: torch.sparse.mm(csr, Xt), 5)


def step_spmm(dev, g20: dict, E: EllParMat) -> dict:
    """Step 4: the SpMM lane on phase 8's ELL layout (unit float32 values
    on its slots) at F = 64, 2 hops: ``spmm_khop`` plus_times normalised
    (mxu_gather, scatter) and min_plus (scatter), ``summa_spmm`` on a 2×2
    ``SpParMat`` of the same graph (scatter; both stage orders),
    ``propagate_features`` and ``_propagate_batch_impl`` on 128 roots."""
    rows, cols, deg = g20["rows"], g20["cols"], g20["deg"]
    n, F = len(deg), SPMM_F
    lc = E.local_cols
    E1 = EllParMat(buckets=tuple((bc, (bc < lc).to(torch.float32), br)
                                 for bc, _, br in E.buckets), nrows=n, ncols=n, grid=E.grid)
    rng = np.random.default_rng(SPMM_SEED)
    X = rng.standard_normal((n, F)).astype(np.float32)
    Xmin = rng.random((n, F)).astype(np.float32)
    Xd = DistMultiVec.from_global(E.grid, X)
    Xmind = DistMultiVec.from_global(E.grid, Xmin)
    bound = spmm_bound_ms(E1, n, F)
    # float64 reference of the normalised hops, on the card (M = D^-1 A as
    # a float64 CSR, two cuSPARSE products a side), and the rounding bound:
    # each hop's sums of at most dmax + 1 terms, 2^-24 each, on |M|·|Y|
    M = torch.sparse_csr_tensor(
        torch.from_numpy(np.searchsorted(rows.astype(np.int64), np.arange(n + 1))),
        torch.from_numpy(cols.astype(np.int64)),
        torch.from_numpy(1.0 / np.maximum(deg, 1)[rows]), size=(n, n),
        check_invariants=True).to(dev)

    def hops64(Y: np.ndarray) -> np.ndarray:
        Y = torch.from_numpy(Y).to(dev).double()
        return torch.sparse.mm(M, torch.sparse.mm(M, Y)).cpu().numpy()

    want, mag = hops64(X), hops64(np.abs(X))
    del M
    tol = SPMM_HOPS * (int(deg.max()) + 2) * 2.0**-24 * mag + 1e-30
    out = {"scale": BFS_SCALE, "n": n, "F": F, "hops": SPMM_HOPS, "hop_bound_ms": bound,
           "bound_by": "bytes", "plus_times_bound": "2 (dmax + 2) 2^-24 |M|(|M||X|)",
           "library_hop_ms": library_spmm_ms(rows, cols, n, X, dev),
           "library_call": "torch.sparse.mm(csr, X)"}
    emit({"phase": "apps", "step": "spmm_library", **out})
    results = {}
    for name, sr, Xv, kw in (("plus_times_mxu_gather", PLUS_TIMES, Xd,
                              dict(normalize=True, backend="mxu_gather")),
                             ("plus_times_scatter", PLUS_TIMES, Xd,
                              dict(normalize=True, backend="scatter")),
                             ("min_plus_scatter", MIN_PLUS, Xmind, dict(backend="scatter"))):
        t = apps_times(lambda: spmm_khop(sr, E1, Xv, SPMM_HOPS, **kw).blocks[0, :n])
        y = t["out"]
        results[name] = y
        hop_ms = min(t["ms"]) / SPMM_HOPS
        line = {**timing(t), "ms_per_hop": hop_ms, "share_of_bound": bound / hop_ms}
        if sr is PLUS_TIMES:
            err = np.abs(y.cpu().numpy().astype(np.float64) - want)
            if not (err <= tol).all():
                raise AssertionError(f"spmm {name}: off the float64 product beyond bound")
            line["max_abs_err_vs_float64"] = float(err.max())
        out[name] = line
        emit({"phase": "apps", "step": f"spmm_khop_{name}", **line})
    # propagate_features is spmm_khop with the pad lanes cut
    prop = propagate_features(E1, X, SPMM_HOPS, normalize=True)
    if not (np.abs(prop - results["plus_times_scatter"].cpu().numpy()) <= 2 * tol).all():
        raise AssertionError("propagate_features differs from spmm_khop")
    # summa_spmm on a 2×2 SpParMat: two hops, both stage orders
    g2 = Grid.make(2, 2, device=dev)
    A2 = SpParMat.from_global_coo(g2, rows, cols, np.ones(len(rows), np.float32), n, n)
    lr2 = g2.local_rows(n)
    inv = torch.zeros(2 * lr2, dtype=torch.float32, device=dev)
    inv[:n] = torch.from_numpy(1.0 / np.maximum(deg, 1).astype(np.float32)).to(dev)
    inv = inv.view(2, 1, lr2, 1)  # row block i of every [pr, pc, lr, fc] block
    for name, sr, Xh in (("plus_times", PLUS_TIMES, X), ("min_plus", MIN_PLUS, Xmin)):
        for ring in (False, True):
            def two_hops(sr=sr, Xh=Xh, ring=ring):
                Y = DenseParMat.from_global(g2, Xh)
                for _ in range(SPMM_HOPS):
                    Y = summa_spmm(sr, A2, Y, backend="scatter", ring=ring)
                    if sr is PLUS_TIMES:  # the same normalisation as spmm_khop's
                        Y = DenseParMat(blocks=Y.blocks * inv, nrows=n, ncols=F, grid=g2)
                return Y.to_global()
            t = apps_times(two_hops)
            y = t["out"]
            if sr is PLUS_TIMES:
                ok = (np.abs(y.astype(np.float64) - want) <= tol).all()
            else:
                ok = np.array_equal(y.view(np.int32),
                                    results["min_plus_scatter"].cpu().numpy().view(np.int32))
            if not ok:
                raise AssertionError(f"summa_spmm {name} ring={ring} differs")
            line = {"ring": ring, **timing(t), "ms_per_hop": min(t["ms"]) / SPMM_HOPS}
            out[f"summa_{name}_ring{int(ring)}"] = line
            emit({"phase": "apps", "step": f"summa_spmm_{name}", "grid": "2x2", **line})
    del A2
    torch.cuda.empty_cache()
    # 128 root queries through the transpose, PAD_ROOT lanes zero
    roots = g20["roots"][:SPMM_QUERIES].copy()
    roots[-SPMM_PADS:] = PAD_ROOT
    Xr = DistMultiVec.from_global(E.grid, pad_features(X), align="row")
    invdeg = row_invdeg(E1).realign("col")
    t = apps_times(lambda: propagate_mod._propagate_batch_impl(
        E1, Xr, invdeg, torch.from_numpy(roots).to(dev), hops=SPMM_HOPS, normalize=True,
        backend="mxu_gather").cpu().numpy())
    got = t["out"]
    live = roots != PAD_ROOT
    if not (got[:, ~live] == 0).all():
        raise AssertionError("propagate batch: a PAD_ROOT lane is not zero")
    err = np.abs(got[:F, live].T.astype(np.float64) - want[roots[live]])
    if not (err <= 2 * tol[roots[live]]).all():
        raise AssertionError("propagate batch: lanes differ from the whole-graph rows")
    out["propagate_batch"] = {"queries": SPMM_QUERIES, "pad_lanes": SPMM_PADS, **timing(t),
                              "max_abs_err_vs_float64": float(err.max())}
    emit({"phase": "apps", "step": "propagate_batch", **out["propagate_batch"]})
    return out


def phase_apps(dev, t_start: float, g20: dict, E: EllParMat, A20: SpParMat, g18: dict) -> dict:
    """Phase 12 (module docstring): steps 1-4 with K1's and K2's launch
    counts set to 0 just before and read just after; neither runs."""
    emit({"phase": "apps", "step": "elapsed", "total_s": time.perf_counter() - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        step_s[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        emit({"phase": "apps", "step": f"{name}_done", "step_s": step_s[name],
              "total_s": time.perf_counter() - t_start})
        return out

    res = {"mcl": timed("mcl", step_mcl, dev),
           "matching": timed("matching", step_matching, dev, g18, g20),
           "ordering": timed("ordering", step_ordering, dev, g20, A20),
           "spmm": timed("spmm", step_spmm, dev, g20, E)}
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the apps phase launched hand kernels: {launches}")
    emit({"phase": "apps", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "total_s": time.perf_counter() - t_start})
    res["k1"] = launches["k1"]
    return res


# --- phase 13: graph input ---------------------------------------------------------

GI_SCALE, GI_EDGEFACTOR = 20, 16  # bench.py:138-139, the BFS path's graph
GI_WARM_SEED, GI_SEED = 41, 42  # bench.py:k1_device_child's keys
GI_BFS_ROOTS = 4
GI_RMAT_CHECK_SCALE = 14  # cut from 16 for time: threefry on the CPU is the slow side
GI_V21_SEED = 0xDECAFBAD  # RefGen21's fallback seed
GI_V21_RANGE = 1 << 16
GI_BATCH_ROOTS = 64
GI_IO_SCALE = 18
GI_IO_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_io"
HOST_SOURCES = ("graphgen", "mmparse")  # combblas_tpu_torch/io/native/*.cpp


def device_keys(A: SpParMat) -> torch.Tensor:
    """Sorted int64 global keys row * ncols + col of every entry, on the
    matrix's device."""
    lr, lc = A.local_rows, A.local_cols
    parts = []
    for i in range(A.grid.pr):
        for j in range(A.grid.pc):
            r, c = A.rows[i, j], A.cols[i, j]
            ok = r < lr
            parts.append((r[ok].long() + i * lr) * A.ncols + c[ok].long() + j * lc)
    return torch.sort(torch.cat(parts)).values


def same_keys(A: SpParMat, keys: np.ndarray) -> bool:
    """A's entries are exactly the host keys (sorted on the card)."""
    want = torch.sort(torch.from_numpy(keys).to(A.rows.device)).values
    return torch.equal(device_keys(A), want)


def same_tiles(a: SpParMat, b: SpParMat) -> bool:
    return (a.nrows, a.ncols) == (b.nrows, b.ncols) and all(
        torch.equal(getattr(a, f).view(torch.uint8), getattr(b, f).view(torch.uint8))
        for f in ("rows", "cols", "vals", "nnz"))


def gi_layer(name: str, fn, bytes_moved: int, reps: int = 2) -> dict:
    """A graph-input layer timed with CUDA events (``reps`` calls after the
    path's own warm-up), beside its bytes bound over 3.35 TB/s, with the
    device kernels a call and their time from ``op_breakdown``."""
    ms = [timed_call(fn)[1] for _ in range(reps)]
    bound = bytes_moved / PEAK_BYTES * 1e3
    trace = op_breakdown(fn, 1)
    line = {"layer": name, "ms": ms, "bound_ms": bound, "bound_by": "bytes",
            "share_of_bound": bound / min(ms)}
    if trace["profiler_device_time"]:
        line.update(kernels_per_call=sum(k["calls"] for k in trace["kernels"]),
                    kernels_ms=trace["kernels_ms"], coverage=trace["coverage"],
                    top_kernels=trace["kernels"][:5])
    return line


def step_kernel1(dev) -> dict:
    """Step 1: kernel 1 on the card (bench.py:k1_device_child's protocol),
    its checks, four searches on its matrix, and G1-G3."""
    n = 1 << GI_SCALE
    g11 = Grid.make(1, 1, device=dev)
    key = threefry.key(GI_SEED)

    def run(grid, seed, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        A, deg, nkeep, t = kernel1_device(grid, GI_SCALE, GI_EDGEFACTOR, threefry.key(seed), **kw)
        wall = time.perf_counter() - t0
        dropped = int(t.pop("dropped_dev"))
        if dropped:
            raise AssertionError(f"kernel1_device dropped {dropped} tuples")
        line = {"grid": f"{grid.pr}x{grid.pc}", **kw, "wall_s": wall, **t, "dropped": dropped,
                "nnz": int(A.getnnz()), "nkeep": int(nkeep),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        return A, deg, line

    out = {}
    _, _, out["warmup"] = run(g11, GI_WARM_SEED, compress_isolated=False)
    emit({"phase": "graph_input", "step": "kernel1_warmup", **out["warmup"]})
    A, deg, out["timed"] = run(g11, GI_SEED, compress_isolated=False)
    emit({"phase": "graph_input", "step": "kernel1", **out["timed"]})

    # the card's own edge list, symmetrised, loops out: keys in numpy, their
    # distinct set sorted on the card (numpy's sort of 33.5 M keys is too slow
    # on the card's host for the phase's time)
    t0 = time.perf_counter()
    src, dst = (x.cpu().numpy().astype(np.int64)
                for x in rmat_edges(key, GI_SCALE, GI_EDGEFACTOR << GI_SCALE, device=dev))
    keep = src != dst
    want = torch.unique(torch.from_numpy(np.concatenate(
        [src[keep] * n + dst[keep], dst[keep] * n + src[keep]])).to(dev))
    got = device_keys(A)
    R, C = got // n, got % n
    if not (bool((got[1:] > got[:-1]).all()) and not bool((R == C).any())
            and bool((A.vals[A.rows < n] == 1).all())):
        raise AssertionError("kernel 1: duplicates, loops or values other than 1")
    if not torch.equal(torch.sort(C * n + R).values, got):
        raise AssertionError("kernel 1: the matrix is not symmetric")
    if not torch.equal(got, want):
        raise AssertionError(f"kernel 1: {got.numel()} entries, the card's edge list gives "
                             f"{want.numel()} distinct ones")
    del want
    R, C = R.cpu().numpy(), C.cpu().numpy()  # row-major
    rowcnt = np.bincount(R, minlength=n)
    if not np.array_equal(deg.to_global(), rowcnt.astype(np.float32)):
        raise AssertionError("kernel 1: degrees differ from the row counts")
    nkeep = int((rowcnt > 0).sum())
    host_s = time.perf_counter() - t0

    # compressed: P A Pᵀ with the compression permutation read back
    Ac, degc, out["compressed"] = run(g11, GI_SEED, compress_isolated=True)
    p, nk = isolated_compression_perm(A)
    pg = p.to_global().astype(np.int64)
    if not out["compressed"]["nkeep"] == int(nk) == nkeep:
        raise AssertionError(f"kernel 1: nkeep {out['compressed']['nkeep']}, host {nkeep}")
    if not np.array_equal(pg[rowcnt > 0], np.arange(nkeep)):
        raise AssertionError("kernel 1: the live vertices are not a prefix in order")
    if not same_keys(Ac, pg[R] * n + pg[C]):
        raise AssertionError("kernel 1: the compressed matrix is not P A P^T")
    if not np.array_equal(degc.to_global(), np.bincount(pg[R], minlength=n).astype(np.float32)):
        raise AssertionError("kernel 1: compressed degrees differ")
    emit({"phase": "graph_input", "step": "kernel1_compressed", **out["compressed"]})
    del Ac, degc
    torch.cuda.empty_cache()

    # 2x2 with the extra relabel: Q, then the compression of Q A Qᵀ
    g22 = Grid.make(2, 2, device=dev)
    A22, deg22, out["relabel_2x2"] = run(g22, GI_SEED, extra_relabel=True)
    q = DistVec.randperm(g22, n, threefry.fold_in(key, 1)).to_global().astype(np.int64)
    live = np.zeros(n, bool)
    live[q[rowcnt > 0]] = True
    p2 = np.empty(n, np.int64)
    p2[live] = np.arange(live.sum())
    p2[~live] = live.sum() + np.arange((~live).sum())
    if not same_keys(A22, p2[q[R]] * n + p2[q[C]]):
        raise AssertionError("kernel 1 on 2x2: the relabelled matrix is not P Q A Qᵀ Pᵀ")
    if not np.array_equal(deg22.to_global(),
                          np.bincount(p2[q[R]], minlength=n).astype(np.float32)):
        raise AssertionError("kernel 1 on 2x2: degrees differ")
    emit({"phase": "graph_input", "step": "kernel1_relabel", **out["relabel_2x2"]})
    del A22, deg22
    torch.cuda.empty_cache()

    # bfs (the SpParMat app) from 4 roots, held against a numpy BFS
    indptr = np.concatenate([[0], np.cumsum(rowcnt)])
    roots = np.random.default_rng(7).choice(np.flatnonzero(rowcnt > 0), GI_BFS_ROOTS,
                                            replace=False)
    searches = []
    for root in roots:
        bfs(A, int(root))  # warm-up
        (par, lev, it), ms, wall = timed_call(lambda: bfs(A, int(root)))
        te = int(traversed_edges(A, par))
        if not np.array_equal(lev.to_global(), host_bfs_levels(indptr, C, int(root))):
            raise AssertionError(f"bfs from {root} on kernel 1's matrix: levels differ")
        searches.append({"root": int(root), "levels": it, "ms": ms, "wall_s": wall,
                         "traversed_edges": te, "mteps": te / wall / 1e6})
    out["bfs"] = searches
    emit({"phase": "graph_input", "step": "kernel1_bfs", "searches": searches,
          "host_check_s": host_s})

    # the generator on the card equals the port's CPU path (integer arithmetic)
    t0 = time.perf_counter()
    a = rmat_edges(key, GI_RMAT_CHECK_SCALE, GI_EDGEFACTOR << GI_RMAT_CHECK_SCALE, device=dev)
    b = rmat_edges(key, GI_RMAT_CHECK_SCALE, GI_EDGEFACTOR << GI_RMAT_CHECK_SCALE, device="cpu")
    if not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
        raise AssertionError("rmat_edges on the card differs from the CPU path")
    emit({"phase": "graph_input", "step": "rmat_card_equals_cpu",
          "scale": GI_RMAT_CHECK_SCALE, "seconds": time.perf_counter() - t0})

    # G1-G3 on kernel 1's own inputs (the timed call above was their warm-up)
    nedges = GI_EDGEFACTOR << GI_SCALE
    layers = [gi_layer("G1 rmat_edges",
                       lambda: rmat_edges(key, GI_SCALE, nedges, device=dev), 2 * nedges * 4)]
    rows = torch.from_numpy(np.concatenate([src, dst]).astype(np.int32)).to(dev)
    cols = torch.from_numpy(np.concatenate([dst, src]).astype(np.int32)).to(dev)
    loops = rows == cols
    rows, cols = rows.masked_fill(loops, n).view(1, 1, -1), cols.masked_fill(loops, n).view(1, 1, -1)
    ones = torch.ones_like(rows, dtype=torch.float32)
    routed = A.capacity * 12 + 4  # tile rows, cols, vals written, nnz
    layers.append(gi_layer(
        "G2 redistribute_coo (route + dedup)",
        lambda: from_device_coo(g11, rows, cols, ones, n, n, dedup_sr=SELECT2ND_MAX,
                                defer_drop_check=True),
        rows.numel() * 12 + routed))
    del rows, cols, ones, loops
    torch.cuda.empty_cache()
    layers.append(gi_layer(
        "G3 permute_vertices", lambda: permute_vertices(A, p),
        A.capacity * 12 + 4 + n * 4 + 2 * A.capacity * 12 + 4))
    for line in layers:
        emit({"phase": "graph_input", "step": "layer", **line})
    out["layers"] = layers
    out["A"] = A
    return out


def step_refgen(dev) -> dict:
    """Step 2: the v2.1 generator at scale 20 (native, against numpy on three
    ranges), its graph routed onto 2x2 against scipy's deduplicated COO."""
    n = 1 << GI_SCALE
    m = GI_EDGEFACTOR << GI_SCALE
    t0 = time.perf_counter()
    src, dst = graph500_edges_native(GI_SCALE, userseed=GI_V21_SEED)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in (0, m // 2 - GI_V21_RANGE // 2, m - GI_V21_RANGE):
        s, d = graph500_edges(GI_SCALE, userseed=GI_V21_SEED, start_edge=lo,
                              end_edge=lo + GI_V21_RANGE)
        if not (np.array_equal(s, src[lo:lo + GI_V21_RANGE])
                and np.array_equal(d, dst[lo:lo + GI_V21_RANGE])):
            raise AssertionError(f"native v2.1 generator differs from numpy at edge {lo}")
    numpy_s = time.perf_counter() - t0
    keep = src != dst
    r = np.concatenate([src[keep], dst[keep]])
    c = np.concatenate([dst[keep], src[keep]])
    # host oracle: scipy's deduplicated COO, laid out as from_device_coo's tiles
    t0 = time.perf_counter()
    coo = sp.coo_matrix((np.ones(len(r), np.float32), (r, c)), shape=(n, n)).tocsr()
    coo.sum_duplicates()
    coo = coo.tocoo()
    hr, hc = coo.row.astype(np.int64), coo.col.astype(np.int64)
    scipy_s = time.perf_counter() - t0
    g22 = Grid.make(2, 2, device=dev)
    chunk = -(-len(r) // 4)
    R = np.full(4 * chunk, n, np.int32)
    Cc = np.full(4 * chunk, n, np.int32)
    R[:len(r)], Cc[:len(r)] = r, c
    up = [torch.from_numpy(x.reshape(2, 2, chunk)).to(dev) for x in (R, Cc)]
    ones = torch.ones((2, 2, chunk), dtype=torch.float32, device=dev)
    (A, dropped), route_ms, _ = timed_call(lambda: from_device_coo(
        g22, *up, ones, n, n, dedup_sr=SELECT2ND_MAX, defer_drop_check=True))
    if int(dropped):
        raise AssertionError(f"routing the v2.1 graph dropped {int(dropped)} tuples")
    lr = lc = n // 2
    cap = A.capacity
    want = {f: np.empty((2, 2, cap), np.int32) for f in ("rows", "cols")}
    nnz = np.zeros((2, 2), np.int32)
    for i in range(2):
        for j in range(2):
            sel = (hr // lr == i) & (hc // lc == j)  # row-major within the tile
            k = int(sel.sum())
            nnz[i, j] = k
            want["rows"][i, j] = lr
            want["cols"][i, j] = lc
            want["rows"][i, j, :k] = hr[sel] - i * lr
            want["cols"][i, j, :k] = hc[sel] - j * lc
    vals = (np.arange(cap)[None, None, :] < nnz[:, :, None]).astype(np.float32)
    if not (np.array_equal(A.rows.cpu().numpy(), want["rows"])
            and np.array_equal(A.cols.cpu().numpy(), want["cols"])
            and np.array_equal(A.vals.cpu().numpy(), vals)
            and np.array_equal(A.nnz.cpu().numpy(), nnz)):
        raise AssertionError("the routed v2.1 graph differs from scipy's deduplicated COO")
    line = {"scale": GI_SCALE, "edges": m, "native_s": native_s,
            "native_medges_per_s": m / native_s / 1e6, "numpy_check_s": numpy_s,
            "numpy_ranges": 3, "nnz": len(hr), "scipy_s": scipy_s, "route_ms": route_ms,
            "tile_capacity": cap}
    emit({"phase": "graph_input", "step": "refgen21", **line})
    return {"line": line, "rows": hr, "cols": hc}


def step_batch_bfs(dev, g: dict) -> dict:
    """Step 3: bfs_batch_compact with the ring fold on step 2's graph as a
    2x2 EllParMat, from 64 roots; BFS_CHECK_LANES lanes held against a numpy
    BFS (levels, max-id parents one level up, traversed edges)."""
    n = 1 << GI_SCALE
    r, c = g["rows"], g["cols"]  # row-sorted, deduplicated
    t0 = time.perf_counter()
    E = EllParMat.from_host_coo(Grid.make(2, 2, device=dev), r, c,
                                np.zeros(len(r), np.int8), n, n)
    build_s = time.perf_counter() - t0
    deg = np.bincount(r, minlength=n)
    roots = np.random.default_rng(7).choice(np.flatnonzero(deg > 0), GI_BATCH_ROOTS,
                                            replace=False).astype(np.int32)
    roots_dev = torch.from_numpy(roots).to(dev)
    lr = E.grid.local_rows(n)
    deg_blocks = torch.zeros(2 * lr, dtype=torch.int32)
    deg_blocks[:n] = torch.from_numpy(deg.astype(np.int32))
    deg_blocks = deg_blocks.view(2, lr).to(dev)
    bfs_batch_compact(E, roots_dev, ring=True)  # warm-up
    (par, lev, it), ms, wall = timed_call(lambda: bfs_batch_compact(E, roots_dev, ring=True))
    te = batch_traversed_edges(deg_blocks, par).cpu().numpy()
    t0 = time.perf_counter()
    P = par.blocks.reshape(-1, GI_BATCH_ROOTS)[:n, :BFS_CHECK_LANES].cpu().numpy()
    L = lev.blocks.reshape(-1, GI_BATCH_ROOTS)[:n, :BFS_CHECK_LANES].cpu().numpy()
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    for k in range(BFS_CHECK_LANES):
        root = int(roots[k])
        want_l = host_bfs_levels(row_ptr, c, root)
        if not np.array_equal(L[:, k], want_l):
            raise AssertionError(f"bfs_batch_compact lane {k}: levels differ from the host BFS")
        if not np.array_equal(P[:, k], host_max_parents(r, c, row_ptr, want_l, root)):
            raise AssertionError(f"bfs_batch_compact lane {k}: parents are not the max-id "
                                 "neighbour one level up")
        if int(te[k]) != int(deg[want_l >= 0].sum()) // 2:
            raise AssertionError(f"bfs_batch_compact lane {k}: traversed edges differ")
    line = {"scale": GI_SCALE, "grid": "2x2", "roots": GI_BATCH_ROOTS, "ring": True,
            "host_build_s": build_s, "nnz": len(r), "levels": it, "ms": ms, "wall_s": wall,
            "traversed_edges": int(te.astype(np.int64).sum()),
            "host_bfs_lanes_equal": BFS_CHECK_LANES, "host_check_s": time.perf_counter() - t0}
    emit({"phase": "graph_input", "step": "batch_bfs", **line})
    return line


def step_io(dev, A20: SpParMat, g18: dict) -> dict:
    """Step 4: Matrix Market, binary, checkpoint and vector round trips."""
    shutil.rmtree(GI_IO_DIR, ignore_errors=True)
    GI_IO_DIR.mkdir(parents=True)
    out = {}
    try:
        n = 1 << GI_IO_SCALE
        r, c = g18["rows"].astype(np.int64), g18["cols"].astype(np.int64)
        v = np.ones(len(r))
        mm = GI_IO_DIR / "g18.mtx"
        t0 = time.perf_counter()
        write_mm(str(mm), (r, c, v, n, n))
        write_s = time.perf_counter() - t0
        size = mm.stat().st_size
        t0 = time.perf_counter()
        got = read_mm(str(mm))
        read_s = time.perf_counter() - t0
        order = np.lexsort((r, c))  # the file's column-major order
        if not (got[3:] == (n, n) and np.array_equal(got[0], r[order])
                and np.array_equal(got[1], c[order]) and np.array_equal(got[2], v)):
            raise AssertionError("read_mm does not give back what write_mm wrote")
        g22 = Grid.make(2, 2, device=dev)
        (A18, _, read_dist_s) = timed_call(lambda: read_mm_distributed(g22, str(mm)))
        if not same_keys(A18, r * n + c):
            raise AssertionError("read_mm_distributed lost or moved entries")
        out["matrix_market"] = {"scale": GI_IO_SCALE, "entries": len(r), "bytes": size,
                                "write_s": write_s, "read_s": read_s,
                                "parse_mb_per_s": size / read_s / 1e6,
                                "read_distributed_s": read_dist_s}
        emit({"phase": "graph_input", "step": "matrix_market", **out["matrix_market"]})
        MULTIPROC_DIR.mkdir(parents=True, exist_ok=True)
        os.replace(mm, MULTIPROC_MM)  # phase 23 reads it across two processes

        # binary at scale 20: kernel 1's matrix
        R, C, V = A20.to_global_coo()
        b = GI_IO_DIR / "k1.bin"
        t0 = time.perf_counter()
        write_binary(str(b), A20)
        bw = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = read_binary(str(b))
        br = time.perf_counter() - t0
        if not (got[3:] == (A20.nrows, A20.ncols) and np.array_equal(got[0], R)
                and np.array_equal(got[1], C) and np.array_equal(got[2], V.astype(np.float64))):
            raise AssertionError("read_binary does not give back kernel 1's matrix")
        out["binary"] = {"scale": GI_SCALE, "entries": len(R), "bytes": b.stat().st_size,
                         "write_s": bw, "read_s": br}
        emit({"phase": "graph_input", "step": "binary", **out["binary"]})
        b.unlink()

        # checkpoint of the 2x2 matrix: same grid verbatim, 2x2 -> 1x1
        ck = GI_IO_DIR / "a18.npz"
        t0 = time.perf_counter()
        checkpoint.save(str(ck), A18)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load(str(ck), g22)
        load_s = time.perf_counter() - t0
        if not same_tiles(back, A18):
            raise AssertionError("checkpoint.load on the same grid changed the tiles")
        t0 = time.perf_counter()
        one = checkpoint.load(str(ck), Grid.make(1, 1, device=dev))
        cross_s = time.perf_counter() - t0
        if not same_tiles(one, SpParMat.from_global_coo(one.grid, *A18.to_global_coo(), n, n)):
            raise AssertionError("checkpoint.load onto 1x1 differs from the global tuples")
        out["checkpoint"] = {"scale": GI_IO_SCALE, "bytes": ck.stat().st_size,
                             "tile_capacity": A18.capacity, "save_s": save_s,
                             "load_same_grid_s": load_s, "load_1x1_s": cross_s}
        emit({"phase": "graph_input", "step": "checkpoint", **out["checkpoint"]})

        # the degree vector
        deg = A18.reduce(PLUS_TIMES, "cols", map_fn=ones_f32)
        vf = GI_IO_DIR / "deg.txt"
        t0 = time.perf_counter()
        write_vec(str(vf), deg)
        back, act = read_vec(g22, str(vf), align="row")
        vec_s = time.perf_counter() - t0
        if not (torch.equal(back.blocks, deg.blocks) and bool(act.blocks.reshape(-1)[:n].all())):
            raise AssertionError("read_vec does not give back the degree vector")
        out["vector"] = {"length": n, "round_trip_s": vec_s}
        emit({"phase": "graph_input", "step": "vector", **out["vector"]})
    finally:
        shutil.rmtree(GI_IO_DIR, ignore_errors=True)
    return out


def phase_graph_input(dev, t_start: float, g18: dict) -> dict:
    """Phase 13 (module docstring): steps 1-4 with K1's and K2's launch counts
    set to 0 just before and read just after; neither runs."""
    emit({"phase": "graph_input", "step": "elapsed", "total_s": time.perf_counter() - t_start})
    # the two host C++ sources (the v2.1 generator, the Matrix Market
    # parser), built by g++ before anything is timed
    builds = {name: _build.build_host(name)["seconds"] for name in HOST_SOURCES}
    emit({"phase": "graph_input", "step": "host_build", "seconds": builds})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        emit({"phase": "graph_input", "step": f"{name}_done", "step_s": step_s[name],
              "total_s": time.perf_counter() - t_start})
        return res

    k1 = timed("kernel1", step_kernel1, dev)
    gen = timed("refgen21", step_refgen, dev)
    batch = timed("batch_bfs", step_batch_bfs, dev, gen)
    io = timed("io", step_io, dev, k1.pop("A"), g18)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the graph-input phase launched hand kernels: {launches}")
    emit({"phase": "graph_input", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "total_s": time.perf_counter() - t_start})
    return {"kernel1": k1, "refgen21": gen["line"], "batch_bfs": batch, "io": io,
            "k1": launches["k1"]}


# --- phase 14: the 3D (layered) tier ------------------------------------------------

M3_LAYERS, M3_P = 2, 2  # Grid3D.make(2, 2, 2)
M3_SCALE = 16  # phase 10's A·A; cut to M3_CUT_SCALE when the reckoned peak passes the cap
M3_CUT_SCALE, M3_PEAK_CAP_GB = 15, 70.0
M3_MERGES = ("sort", "runs", "hash")
M3_REPS = 1  # timed calls after the warm-up
M3_MCL_GRID = 2  # the MCL matrix on 2×2: add_loops and the transpose need square blocking
# an MCL value's relative error bound: its column is re-normalised by a
# float32 sum of up to 1,400 kept terms (2^-24 each) in another order
M3_MCL_RTOL = 1e-4
# the most columns whose select ties may differ between the 3D and the 2D
# iterate: the H100 showed 22-24 of 16,384, and two 2D runs differ at a few
M3_MCL_TIE_COLUMNS = 64


def live_entries3(C3) -> tuple[torch.Tensor, torch.Tensor]:
    """``live_entries`` of a 3D matrix: its live entries as sorted global
    keys and the values in that order, on the card."""
    gr, gc, gv = mesh3d_mod._globalize3d(C3)
    m = gr < C3.nrows
    key, order = torch.sort(gr[m].long() * C3.ncols + gc[m].long())
    return key, gv[m][order]


def reckon_esc3d_gb(scale: int, dev) -> dict:
    """The output and hash-table bytes ``spgemm3d(tier="esc")`` would hold
    for the min_plus A·A at ``scale`` on the 3D grid, from its own capacity
    rule (``_esc3d_caps``; output 12 bytes a slot, the table 12 bytes a slot
    and an int32 claim)."""
    _, _, _, A = weighted_rmat(scale, dev, Grid.make(M3_P, M3_P, device=dev), MIN_PLUS)
    g3 = Grid3D.make(M3_LAYERS, M3_P, M3_P, device=dev)
    A3, B3 = SpParMat3D.from_spmat(A, g3, "col"), SpParMat3D.from_spmat(A, g3, "row")
    _, _, out_cap = mesh3d_mod._esc3d_caps(A3, B3, 1.05)
    out_gb = g3.size * out_cap * 12 / 1e9
    table_gb = hash_table_capacity(out_cap) * 16 / 1e9
    return {"scale": scale, "out_capacity": out_cap, "output_gb": out_gb,
            "hash_table_gb": table_gb, "reckoned_peak_gb": out_gb + table_gb}


def fiber_breakdown(fn) -> dict:
    """One more call of ``fn`` with the 3D tier's fiber exchange
    (``_fiber_exchange``) and merge (``_fiber_merge``) each timed between two
    synchronisations (host clock): their ms a call."""
    spent = {"_fiber_exchange": 0.0, "_fiber_merge": 0.0}
    saved = {name: getattr(mesh3d_mod, name) for name in spent}

    def wrap(name):
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return f

    try:
        for name in spent:
            setattr(mesh3d_mod, name, wrap(name))
        _, total_ms, _ = timed_call(fn)
    finally:
        for name, orig in saved.items():
            setattr(mesh3d_mod, name, orig)
    return {"call_ms": total_ms, "fiber_exchange_ms": spent["_fiber_exchange"] * 1e3,
            "merge_ms": spent["_fiber_merge"] * 1e3}


def same_or_close(got, want, exact: bool) -> bool:
    """Equal keys, and values bit for bit (``exact``) or within 2^-20
    relative (float32 sums of positive terms in another order)."""
    if got[0].shape != want[0].shape or not torch.equal(got[0], want[0]):
        return False
    if exact:
        return torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    return bool(((got[1] - want[1]).abs() <= 2.0**-20 * want[1].abs()).all())


def step_esc3d(dev) -> dict:
    """Step 1: A·A (phase 10's recipe) on 2×2×2 through ``spgemm3d(tier=
    "esc")`` with each fiber merge tier, min_plus and plus_times: every
    tier's live entries equal to each other and to the 2D ``spgemm`` (sort)
    on 2×2, bit for bit (plus_times: integer sums below 2^24, so exact in
    any order; else within 2^-20); ms a call, peak GB, the fiber exchange's
    and the merge's ms, and the bytes bound. Scale 16 is cut to 15 when its
    reckoned peak passes ``M3_PEAK_CAP_GB``."""
    reckon = reckon_esc3d_gb(M3_SCALE, dev)
    scale = M3_SCALE if reckon["reckoned_peak_gb"] <= M3_PEAK_CAP_GB else M3_CUT_SCALE
    emit({"phase": "mesh3d", "step": "esc_reckoning", **reckon, "cap_gb": M3_PEAK_CAP_GB,
          "scale_run": scale, "cut": scale != M3_SCALE})
    grid = Grid.make(M3_P, M3_P, device=dev)
    g3 = Grid3D.make(M3_LAYERS, M3_P, M3_P, device=dev)
    out = {"scale": scale, "grid2": grid, "grid3": g3, "lines": {}}
    for sr in (MIN_PLUS, PLUS_TIMES):
        _, _, _, A = weighted_rmat(scale, dev, grid, sr)
        nnz_a = int(A.getnnz())
        ref = live_entries(spgemm(sr, A, A))
        exact = sr is not PLUS_TIMES or float(ref[1].max()) < 2**24
        A3 = SpParMat3D.from_spmat(A, g3, "col")
        B3 = SpParMat3D.from_spmat(A, g3, "row")
        line = {"phase": "mesh3d", "step": "esc3d", "semiring": sr.name, "scale": scale,
                "grid3": f"{M3_LAYERS}x{M3_P}x{M3_P}", "nnz_a": nnz_a,
                "nnz_out": int(ref[0].numel()), "largest_value": float(ref[1].max()),
                "compared": "bit for bit" if exact else "within 2^-20 relative",
                "bytes_bound_ms": esc_bytes_bound_ms(nnz_a, int(ref[0].numel()))}
        first = None
        for merge in M3_MERGES:
            def call(merge=merge):
                return spgemm3d(sr, A3, B3, tier="esc", merge=merge)

            got, ms, peak = step_times(call, live_entries3, M3_REPS)
            if not same_or_close(got, ref, exact):
                raise AssertionError(f"esc3d {sr.name} {merge}: differs from the 2D spgemm")
            if first is not None and not same_or_close(got, first, True):
                raise AssertionError(f"esc3d {sr.name} {merge}: differs from merge=sort")
            first = got if first is None else first
            line[merge] = {"ms": ms, "peak_mem_gb": peak, "share_of_bound":
                           line["bytes_bound_ms"] / ms, **mesh3d_mod.spgemm3d.last_run,
                           **fiber_breakdown(call)}
            del got
            torch.cuda.empty_cache()
        emit(line)
        out["lines"][sr.name] = line
        if sr is MIN_PLUS:
            out.update(A=A, A3=A3, B3=B3, ref=ref)
        del first
        torch.cuda.empty_cache()
    return out


def step_routed3d(dev, esc: dict) -> dict:
    """Step 2: the same min_plus product through ``spgemm_auto(grid3=...)``:
    the router answers windowed3d, the result comes back on the 2D grid
    equal to step 1's; timed beside the 2D windowed route on the same
    matrix."""
    A, g3 = esc["A"], esc["grid3"]
    tier = choose_spgemm_tier(MIN_PLUS, A, A, grid3=g3)
    if tier != "windowed3d" or choose_spgemm_tier(MIN_PLUS, A, A) != "windowed":
        raise AssertionError(f"router: {tier} with grid3; the reference's rule gives windowed3d")
    got, ms, peak = step_times(lambda: spgemm_auto(MIN_PLUS, A, A, grid3=g3), live_entries,
                               M3_REPS)
    plan = plan_summary(mesh3d_mod.spgemm3d_windowed.last_plan)
    if not same_entries(got, esc["ref"]):
        raise AssertionError("spgemm_auto(grid3=...) differs from step 1's product")
    _, ms2d, peak2d = step_times(lambda: spgemm_auto(MIN_PLUS, A, A), None, M3_REPS)
    nnz = int(got[0].numel())
    line = {"phase": "mesh3d", "step": "routed", "semiring": "min_plus", "scale": esc["scale"],
            "router": tier, "equal_to_step1": True, "nnz_out": nnz, "ms": ms,
            "peak_mem_gb": peak, "nnz_out_per_s": nnz / (ms / 1e3), "plan": plan,
            "windowed_2d_ms": ms2d, "windowed_2d_peak_mem_gb": peak2d,
            "bytes_bound_ms": esc_bytes_bound_ms(int(A.getnnz()), nnz)}
    line["share_of_bound"] = line["bytes_bound_ms"] / ms
    emit(line)
    return line


def k1_at_layer_window_shape(sr, A3, B3, plan: dict) -> dict:
    """The 3D dot backend's first K1 launch of a call (layer 0, tile (0,
    0), stage 0, block 0, window 0) rebuilt from the path's operands: each
    layer carries half the contraction."""
    a, b = A3.local_tile(0, 0, 0), B3.local_tile(0, 0, 0)
    rb = min(plan["block_rows"], A3.tile_rows)
    arows, pk, pwin = _pad128(rb), _pad128(B3.tile_rows), _pad128(plan["block_cols"])
    da = densify_combine(sr, _shift_rowblock(mask_rows(a, 0, rb), 0, arows), arows, pk)
    bs, starts = _colmajor_with_starts(b, plan["block_cols"])
    panel = _dense_col_panel(sr, bs, starts, 0, plan["block_cols"], pk, pwin, plan["panel_cap"])
    return hold_k1(_PALLAS_KINDS[sr.name], da, panel)


def step_dot3d(dev, esc: dict, dot2d_host: dict) -> tuple[dict, dict]:
    """Step 3: phase 11's scale-15 recipe on 2×2×2 through
    ``spgemm3d_windowed(backend="dot")`` for min_plus and max_min: bit for
    bit equal to the scatter backend and to the 2D dot backend on 2×2
    (``dot2d_host``: phase 11's products of the same operands, kept on the
    host, uploaded here); K1 launched layers × tiles × stages × live
    windows a call; K1 at the layer's window shape held against its plain
    version. Returns (lines, K1 launches by semiring)."""
    g3, grid = esc["grid3"], esc["grid2"]
    per_device = M3_LAYERS * M3_P * M3_P * M3_P  # layers × tiles × stages
    lines, k1 = {}, {}
    for sr in (MIN_PLUS, MAX_MIN):
        if sr is MIN_PLUS and esc["scale"] == WIN_DOT_SCALE:
            A, A3, B3 = esc["A"], esc["A3"], esc["B3"]
        else:
            _, _, _, A = weighted_rmat(WIN_DOT_SCALE, dev, grid, sr)
            A3, B3 = SpParMat3D.from_spmat(A, g3, "col"), SpParMat3D.from_spmat(A, g3, "row")
        counted = semiring_matmul.launches
        ref = tuple(t.to(dev) for t in dot2d_host[sr.name])
        scatter, sc_ms, sc_peak = step_times(
            lambda: spgemm3d_windowed(sr, A3, B3, backend="scatter"), live_entries3, M3_REPS)
        if semiring_matmul.launches != counted or not same_entries(scatter, ref):
            raise AssertionError(f"3D scatter {sr.name}: differs from the 2D dot backend")
        before = semiring_matmul.launches
        got, ms, peak = step_times(lambda: spgemm3d_windowed(sr, A3, B3, backend="dot"),
                                   live_entries3, M3_REPS)
        launched = semiring_matmul.launches - before
        plan = mesh3d_mod.spgemm3d_windowed.last_plan
        per_call = per_device * plan["packed"]
        if launched != (1 + M3_REPS) * per_call:
            raise AssertionError(f"3D dot {sr.name}: {launched} K1 launches, the plan says "
                                 f"{(1 + M3_REPS) * per_call}")
        if not same_entries(got, ref):
            raise AssertionError(f"3D dot {sr.name}: differs from the 2D dot backend")
        nnz = int(got[0].numel())
        br = min(plan["block_rows"], A3.tile_rows)
        ops_ms = (per_call * 2.0 * _pad128(br) * _pad128(B3.tile_rows)
                  * _pad128(plan["block_cols"]) / PEAK_F32_OPS * 1e3)
        line = {"phase": "mesh3d", "step": "dot3d", "semiring": sr.name, "scale": WIN_DOT_SCALE,
                "grid3": f"{M3_LAYERS}x{M3_P}x{M3_P}", "nnz_out": nnz,
                "equal_to_scatter_and_2d_dot": True, "k1_launches_per_call": per_call,
                "scatter": {"ms": sc_ms, "peak_mem_gb": sc_peak,
                            "product_bound_ms": esc_bytes_bound_ms(int(A.getnnz()), nnz)},
                "ms": ms, "nnz_out_per_s": nnz / (ms / 1e3), "peak_mem_gb": peak,
                "bound_ms": ops_ms, "bound_by": "operations", "share_of_bound": ops_ms / ms,
                "plan": plan_summary(plan),
                "k1_layer_window_shape": k1_at_layer_window_shape(sr, A3, B3, plan)}
        emit(line)
        lines[sr.name] = line
        k1[sr.name] = launched
        del A, A3, B3, got, ref, scatter
        torch.cuda.empty_cache()
    return lines, k1


def step_convert3d(dev, A20: SpParMat) -> dict:
    """Step 4: phase 8's scale-20 matrix onto 2×2×2 col-split and row-split
    (``from_spmat``), ``resplit3d`` between them, and ``to_spmat`` back to
    its 1×1 grid: the global key and value set unchanged at every step; ms
    a call beside a bytes bound (every tuple read and written once)."""
    g3 = Grid3D.make(M3_LAYERS, M3_P, M3_P, device=dev)
    want = live_entries(A20)
    nnz = int(want[0].numel())
    bound_ms = 2 * 12 * nnz / PEAK_BYTES * 1e3
    line = {"phase": "mesh3d", "step": "convert", "n": A20.nrows, "nnz": nnz,
            "grid2": f"{A20.grid.pr}x{A20.grid.pc}", "grid3": f"{M3_LAYERS}x{M3_P}x{M3_P}",
            "bound_ms": bound_ms, "bound_by": "bytes"}
    held = {}
    for name, fn in (("from_spmat_col", lambda: SpParMat3D.from_spmat(A20, g3, "col")),
                     ("from_spmat_row", lambda: SpParMat3D.from_spmat(A20, g3, "row")),
                     ("resplit_col_to_row", lambda: mesh3d_mod.resplit3d(held["col"], "row")),
                     ("resplit_row_to_col", lambda: mesh3d_mod.resplit3d(held["row"], "col")),
                     ("to_spmat", lambda: held["col"].to_spmat(A20.grid))):
        got, ms, peak = step_times(fn, None, M3_REPS)
        keys = live_entries(got) if name == "to_spmat" else live_entries3(got)
        if not same_entries(keys, want):
            raise AssertionError(f"3D conversion {name}: the key and value set changed")
        if name.startswith("from_spmat"):
            held[name.rsplit("_", 1)[1]] = got
        line[name] = {"ms": ms, "peak_mem_gb": peak, "share_of_bound": bound_ms / ms,
                      "capacity": got.capacity}
        del got, keys
    emit(line)
    return line


def mcl3d_products(S: SpParMat, g3) -> tuple:
    """One 3D MCL expansion from the loop-added, column-stochastic S: the
    bare product and the iterate (the 3D sparsifier, re-normalised), as
    live entries."""
    A3 = SpParMat3D.from_spmat(S, g3, "col")
    B3 = mesh3d_mod.resplit3d(A3, "row").shrink_to_fit()
    bare = live_entries3(mesh3d_mod.mem_efficient_spgemm3d(PLUS_TIMES, A3, B3, 1))
    C3 = mesh3d_mod.mem_efficient_spgemm3d(
        PLUS_TIMES, A3, B3, 1,
        prune_fn=lambda C: mcl_mod.mcl_prune_recovery_select3d(C, **MCL_PARAMS))
    return bare, live_entries3(mcl_mod.make_col_stochastic3d(C3))


def max_rel(got, want) -> float:
    return float(((got - want).abs() / want.abs()).max()) if want.numel() else 0.0


def hold_iterate(got, want, bare_got, bare_want, n: int) -> dict:
    """An MCL iterate against another made with sums in another order. An
    entry that only one of them keeps must be a tie that the order of a
    float sum flips: in the bare expansions' values (the select's input),
    within ``M3_MCL_RTOL`` of the other iterate's threshold in its column
    (that side's least kept value there) or of the hard threshold. At most
    ``M3_MCL_TIE_COLUMNS`` columns may hold such entries; every other column
    keeps the same entries with values within ``M3_MCL_RTOL``."""
    def at(keys, expansion):
        pos = torch.searchsorted(expansion[0], keys).clamp(max=expansion[0].numel() - 1)
        if not torch.equal(expansion[0][pos], keys):
            raise AssertionError("mcl 3D iterate: an entry is not in the expansion")
        return expansion[1][pos]

    def col_min(keys, vals):
        out = torch.full((n,), float("inf"), device=vals.device)
        return out.scatter_reduce_(0, keys % n, vals, "amin")

    hard = MCL_PARAMS["hard_threshold"]
    only, touched, gap_max = {}, [], 0.0
    for name, (k, _), bare, (ko, _), bare_o in (("got", got, bare_got, want, bare_want),
                                                ("want", want, bare_want, got, bare_got)):
        alone = ~torch.isin(k, ko)
        cols = k[alone] % n
        x = at(k[alone], bare)
        gap = torch.minimum((x / col_min(ko, at(ko, bare_o))[cols] - 1).abs(),
                            (x / hard - 1).abs())
        if gap.numel():
            gap_max = max(gap_max, float(gap.max()))
        only[name] = int(alone.sum())
        touched.append(cols)
    if gap_max > M3_MCL_RTOL:
        raise AssertionError(f"mcl 3D iterate: an entry only one side keeps is {gap_max} "
                             "relative from the other side's threshold in its column")
    touched = torch.unique(torch.cat(touched))
    if touched.numel() > M3_MCL_TIE_COLUMNS:
        raise AssertionError(f"mcl 3D iterate: select ties in {touched.numel()} columns, more "
                             f"than {M3_MCL_TIE_COLUMNS}")
    rest = []
    for k, v in (got, want):
        keep = ~torch.isin(k % n, touched)
        rest.append((k[keep], v[keep]))
    if not torch.equal(rest[0][0], rest[1][0]):
        raise AssertionError("mcl 3D iterate: its support differs from the 2D one's off the ties")
    rel = max_rel(rest[0][1], rest[1][1])
    if rel > M3_MCL_RTOL:
        raise AssertionError(f"mcl 3D iterate: values {rel} relative from the 2D's")
    return {"only_3d": only["got"], "only_2d": only["want"], "tie_columns": int(touched.numel()),
            "tie_columns_cap": M3_MCL_TIE_COLUMNS, "tie_max_rel_to_threshold": gap_max,
            "same_support_elsewhere": True, "max_rel_err_elsewhere": rel}


def step_mcl3d(dev) -> dict:
    """Step 5: phase 12's MCL graph (scale 14, HipMCL's defaults) on 2×2 runs
    ``mcl(layers=2)`` on 2×2×2 for one iteration (phase 12's depth cut),
    its chaos within 1e-4 relative of the 2D loop's; its expansion, made by
    hand, has the 2D one's support with values within ``M3_MCL_RTOL``, and
    its iterate too but for ties at the select threshold
    (``hold_iterate``; on the card a float sum's order is unordered, so two
    2D runs may differ at such ties too). At scale 12, ``mcl(layers=2)``
    plain and with ``chaos_every=2`` run to convergence with the 2D loop's
    labels."""
    grid = Grid.make(M3_MCL_GRID, M3_MCL_GRID, device=dev)
    g3 = Grid3D.make(M3_LAYERS, M3_P, M3_P, device=dev)
    out = {}
    for scale in (MCL_SCALE, MCL_CHECK_SCALE):
        A1, g = mcl_matrix(scale, dev)
        r, c, v = A1.to_global_coo()
        n = 1 << scale
        A = SpParMat.from_global_coo(grid, r, c, v, n, n)
        del A1
        if scale == MCL_SCALE:
            t = apps_times(lambda: (*mcl(A, 2.0, max_iters=MCL_SPARSE_MAX_ITERS, layers=2,
                                         grid3=g3, **MCL_PARAMS), dict(mcl_mod.mcl.last_run)))
            labels, it, ch3, run = t["out"]
            t2 = apps_times(lambda: mcl(A, 2.0, max_iters=MCL_SPARSE_MAX_ITERS, **MCL_PARAMS),
                            reps=0)
            ch2 = t2["out"][2]
            if abs(ch3 - ch2) > 1e-4 * ch2 or run["loop"] != "3d":
                raise AssertionError(f"mcl 3D: first chaos {ch3}, the 2D loop's {ch2}")
            S = mcl_mod.make_col_stochastic(A.add_loops(1))
            bare, got = mcl3d_products(S, g3)
            bare2 = live_entries(mem_efficient_spgemm(PLUS_TIMES, S, S, 1))
            want = live_entries(mcl_mod.make_col_stochastic(mem_efficient_spgemm(
                PLUS_TIMES, S, S, 1, prune_fn=mcl_prune)))
            del S
            # the bare expansion has no threshold: the same support exactly
            if not torch.equal(bare[0], bare2[0]) or max_rel(bare[1], bare2[1]) > M3_MCL_RTOL:
                raise AssertionError("mcl 3D expansion: differs from the 2D one")
            out["one_iteration"] = {
                "scale": scale, "grid2": f"{M3_MCL_GRID}x{M3_MCL_GRID}", "iterations": it,
                "chaos": ch3, "chaos_2d": ch2, "expansion_nnz": int(bare[0].numel()),
                "expansion_same_support": True,
                "expansion_max_rel_err": max_rel(bare[1], bare2[1]),
                "iterate_nnz": int(got[0].numel()), "iterate_nnz_2d": int(want[0].numel()),
                **hold_iterate(got, want, bare, bare2, n), "rtol": M3_MCL_RTOL,
                "clusters": check_least_ids(labels.to_global()), **timing(t),
                "ms_2d": t2["warmup_ms"], "peak_mem_gb_2d": t2["peak_mem_gb"]}
            emit({"phase": "mesh3d", "step": "mcl3d_one_iteration", **out["one_iteration"]})
            del got, want, bare, bare2
        else:
            want, it2, _ = mcl(A, 2.0, **MCL_PARAMS)
            line = {"scale": scale, "iterations_2d": it2,
                    "clusters": check_least_ids(want.to_global())}
            for name, kw in (("plain", {}), ("chaos_every2", {"chaos_every": 2})):
                (lab, it, ch), ms, s = timed_call(lambda kw=kw: mcl(
                    A, 2.0, layers=2, grid3=g3, **kw, **MCL_PARAMS))
                if not np.array_equal(lab.to_global(), want.to_global()) or not ch < 1e-3:
                    raise AssertionError(f"mcl 3D {name} at scale {scale}: labels differ from "
                                         "the 2D loop's")
                run = {k: v for k, v in mcl_mod.mcl.last_run.items()
                       if k not in ("chaos", "chaos_at_sync")}
                line[name] = {"iterations": it, "chaos": ch, "ms": ms, "wall_s": s, "loop": run}
            out["converged"] = line
            emit({"phase": "mesh3d", "step": "mcl3d_converged", **line})
        del A
        torch.cuda.empty_cache()
    return out


def phase_mesh3d(dev, t_start: float, A20: SpParMat, dot2d_host: dict) -> dict:
    """Phase 14 (module docstring): steps 1-5 with K1's and K2's launch
    counts set to 0 just before and read just after. K1 runs only in step
    3's dot calls, as their plans say; K2 never."""
    emit({"phase": "mesh3d", "step": "elapsed", "total_s": time.perf_counter() - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        emit({"phase": "mesh3d", "step": f"{name}_done", "step_s": step_s[name],
              "total_s": time.perf_counter() - t_start})
        return res

    esc = timed("esc3d", step_esc3d, dev)
    if semiring_matmul.launches:
        raise AssertionError("the ESC 3D tier launched K1")
    routed = timed("routed", step_routed3d, dev, esc)
    if semiring_matmul.launches:
        raise AssertionError("the 3D scatter backend launched K1")
    dot, k1 = timed("dot3d", step_dot3d, dev, esc, dot2d_host)
    # step 1's min_plus product, kept on the host for phase 15
    ref_host = tuple(t.cpu() for t in esc["ref"])
    for key in ("A", "A3", "B3", "ref"):
        esc.pop(key, None)
    torch.cuda.empty_cache()
    conv = timed("convert", step_convert3d, dev, A20)
    mcl3 = timed("mcl3d", step_mcl3d, dev)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if launches != {"k1": sum(k1.values()), "k2": 0} or min(k1.values()) < 1:
        raise AssertionError(f"mesh3d launched {launches}; its plans say K1 {k1}, K2 0")
    emit({"phase": "mesh3d", "step": "checks", "hand_kernel_launches": launches,
          "k1_by_semiring": k1, "step_s": step_s, "total_s": time.perf_counter() - t_start})
    return {"esc3d": esc["lines"], "routed": routed, "dot3d": dot, "convert": conv,
            "mcl3d": mcl3, "k1": k1, "scale": esc["scale"], "ref_host": ref_host}


# --- phase 15: the measured-plan tuner ----------------------------------------------

PLAN_STORE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_plans"
TUNER_CAP_S = 60.0  # the phase's time budget
TUNER_SPMM_F = 64


@contextlib.contextmanager
def tuner_env(**knobs):
    """The tuner's knobs set (a value) or unset (None) for the block, by
    their ``tuner.config`` names, restored after; the process's plan store
    is reloaded on the way in and out."""
    names = {k: getattr(tuner_config, k) for k in knobs}
    saved = {name: os.environ.get(name) for name in names.values()}
    for k, v in knobs.items():
        if v is None:
            os.environ.pop(names[k], None)
        else:
            os.environ[names[k]] = str(v)
    tuner_store._reset_for_tests()
    try:
        yield
    finally:
        for name, v in saved.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v
        tuner_store._reset_for_tests()


@contextlib.contextmanager
def counted_measure(log: list):
    """The probe's cost functional, unchanged, wrapped to append to ``log``
    each measured candidate's K1 launches as ``(warm_up, timed)``: the
    timed run's are counted around it, the warm-up's since the end of the
    previous measurement (the probe runs a candidate's warm-up just before
    measuring it, and nothing else between)."""
    real = tuner_probe.wall_measure
    mark = [semiring_matmul.launches]

    def factory(device):
        measure = real(device)

        def counted(fn):
            before = semiring_matmul.launches
            dt = measure(fn)
            mark[0], warm = semiring_matmul.launches, before - mark[0]
            log.append((warm, semiring_matmul.launches - before))
            return dt

        return counted

    tuner_probe.wall_measure = factory
    try:
        yield
    finally:
        tuner_probe.wall_measure = real


def host_timed(fn):
    """(result, seconds) on the host clock around a call ending in a
    synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def store_off():
    """``COMBBLAS_PLAN_STORE=0`` for the block, the process's cached store
    kept for after it."""
    saved = os.environ.get(tuner_config.ENV_PLAN_STORE)
    os.environ[tuner_config.ENV_PLAN_STORE] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(tuner_config.ENV_PLAN_STORE)
        else:
            os.environ[tuner_config.ENV_PLAN_STORE] = saved


def k1_at_probe_shapes(A: SpParMat, name: str, backend: str | None) -> dict:
    """K1 at the shapes the probe of ``spgemm_auto(MIN_PLUS, A, A)`` gave
    it, on the probe's own proxy (``proxy_coo`` at the default ``max_dim``
    and seed), launched uncounted and held bit for bit against the plain
    version: the mxu rung's dense tiles, and under the dot backend the
    windowed rung's first window (its plan from a rerun of that rung on the
    proxy, whose launches are taken off the count again)."""
    (ra, ca, va), (rb, cb, vb), (pm, pk, pn) = tuner_probe.proxy_coo(
        A, A, tuner_config.probe_max_dim())
    pA = SpParMat.from_global_coo(A.grid, ra, ca, va, pm, pk)
    pB = SpParMat.from_global_coo(A.grid, rb, cb, vb, pk, pn)
    zero = float(MIN_PLUS.zero_fn(pA.dtype))
    da = densify(pA.local_tile(0, 0), _pad128(pm), _pad128(pk), zero)
    db = densify(pB.local_tile(0, 0), _pad128(pk), _pad128(pn), zero)
    holds = {"mxu_rung": hold_k1("min_plus", da, db)}
    del da, db
    if backend == "dot":
        counted = semiring_matmul.launches
        spgemm_auto(MIN_PLUS, pA, pB, tier="windowed", backend="dot", assume_unique=True)
        semiring_matmul.launches = counted
        plan = spgemm_windowed.last_plan
        holds["windowed_rung"] = k1_at_window_shape(MIN_PLUS, pA, plan, pB)
    for rung, h in holds.items():
        emit({"phase": "tuner", "step": f"{name} k1 at the {rung}'s shape", **h})
    return {rung: {"shape": h["shape"], "ms": h["ms"], "plain_ms": h["plain_ms"]}
            for rung, h in holds.items()}


def step_tuner_probe(dev, A: SpParMat, mxu_min: tuple, store_dir: Path,
                     backend: str | None) -> dict:
    """Steps 1-3 (``backend`` None) or step 4 (``"dot"``): one
    ``spgemm_auto`` with the probe on misses the fresh store and probes at
    the default ``max_dim`` and budget; its product against phase 5's and
    against ``spgemm_auto(tier=<winner>)`` with the store off; then (steps
    2, 3) the replay from the same store and from a fresh ``PlanStore``
    reading the file."""
    name = "probe" if backend is None else f"probe_{backend}"
    with tuner_env(ENV_PLAN_STORE=store_dir, ENV_PROBE="1", ENV_BACKEND=backend):
        st = tuner_store.get_store()
        log: list = []
        k1 = semiring_matmul.launches
        with counted_measure(log):
            C, call_s = host_timed(lambda: spgemm_auto(MIN_PLUS, A, A))
        call_k1 = semiring_matmul.launches - k1
        run = dict(spgemm_auto.last_run)
        errors = list(tuner_probe.probe_spgemm.last_errors)
        costs = tuner_probe.probe_spgemm.last_costs
        stats = st.stats()
        if run["plan_source"] != "probe" or errors:
            raise AssertionError(f"tuner {name}: source {run['plan_source']}, skipped {errors}")
        lines = Path(st.file).read_text().splitlines()
        if len(lines) != 1 or stats["entries"] != 1:
            raise AssertionError(f"tuner {name}: the store holds {len(lines)} lines")
        used = backend or "scatter"
        key = tuner_store.spgemm_plan_key(MIN_PLUS, A, A, used)
        rec = st.peek(key)
        if rec.tier != run["tier"] or key.platform != dev.type:
            raise AssertionError(f"tuner {name}: record {rec} under {key}")
        got = live_entries(C)
        del C
        if not same_entries(tuple(t.cpu() for t in got), mxu_min):
            raise AssertionError(f"tuner {name}: differs from phase 5's mxu product")
        with store_off():
            k1 = semiring_matmul.launches
            forced = live_entries(spgemm_auto(MIN_PLUS, A, A, tier=run["tier"]))
            forced_k1 = semiring_matmul.launches - k1
        if not same_entries(got, forced):
            raise AssertionError(f"tuner {name}: differs from spgemm_auto(tier={run['tier']!r})")
        del forced
        # per measured candidate: K1 in its warm-up and timed runs
        tiers = list(costs["tiers"])
        geo = list(costs.get("geometry", {}))
        k1_by = {t: {"warm_up": w, "timed": n}
                 for t, (w, n) in zip(tiers + [f"geometry {g}" for g in geo], log)}
        if (len(log) != len(k1_by)
                or sum(w + n for w, n in log) != call_k1 - forced_k1):
            raise AssertionError(f"tuner {name}: K1 launches {k1_by} vs {call_k1 - forced_k1}")
        holds = k1_at_probe_shapes(A, name, backend)
        line = {"phase": "tuner", "step": name, "backend": used, "winner": run["tier"],
                "plan_source": run["plan_source"], "probe_dim": rec.probe_dim,
                "record": {"block_rows": rec.block_rows, "block_cols": rec.block_cols,
                           "cost_s": rec.cost_s},
                "rung_seconds": costs["tiers"], "geometry_seconds": costs.get("geometry", {}),
                "probe_seconds": stats["probe_seconds"], "probe_runs": stats["probe_runs"],
                "store": {k: v for k, v in stats.items() if k != "path"},
                "call_s": call_s, "k1_call": call_k1, "k1_probe": call_k1 - forced_k1,
                "k1_by_candidate": k1_by, "k1_product": forced_k1, "last_errors": errors,
                "k1_held_at_probe_shapes": holds, "equal_to_phase5": True, "equal_to_forced_tier": True, "key": key.to_json()}
        emit(line)
        if backend is not None:
            return {"line": line, "k1": call_k1 + forced_k1}
        # step 2: the replay from the same store; step 3: a fresh PlanStore
        # reading the file
        replay = {}
        k1_replay = 0
        for step in ("replay", "reload"):
            if step == "reload":
                tuner_store._reset_for_tests()
            st = tuner_store.get_store()
            before = st.stats()
            k1 = semiring_matmul.launches
            C, s = host_timed(lambda: spgemm_auto(MIN_PLUS, A, A))
            k1_replay += semiring_matmul.launches - k1
            after = st.stats()
            src = spgemm_auto.last_run["plan_source"]
            if (src != "store" or after["probe_runs"] != before["probe_runs"]
                    or after["hits"] != before["hits"] + 1 or st.peek(key) != rec):
                raise AssertionError(f"tuner {step}: source {src}, stats {before} -> {after}")
            if not same_entries(live_entries(C), got):
                raise AssertionError(f"tuner {step}: differs from the probing call's product")
            del C
            replay[step] = {"call_s": s, "plan_source": src, "hits": after["hits"],
                            "probe_runs": after["probe_runs"],
                            "k1": semiring_matmul.launches - k1}
        file_key = json.loads(Path(st.file).read_text().splitlines()[0])["key"]
        if file_key["platform"] != dev.type:
            raise AssertionError(f"tuner reload: the file's key is {file_key}")
    emit({"phase": "tuner", "step": "replay", **replay["replay"], "probing_call_s": call_s})
    emit({"phase": "tuner", "step": "reload", **replay["reload"], "file_key": file_key})
    return {"line": line, "replay": replay, "k1": call_k1 + forced_k1 + k1_replay}


def step_tuner_spmm(dev, E_host: tuple, store_dir: Path) -> dict:
    """Step 5: ``resolve_spmm_backend(PLUS_TIMES, E, 64, X=X)`` on phase
    8's ELL layout (unit float32 values) with the probe on: both backends
    measured on the real operands, the winner persisted, the second call
    replaying it; one hop under each backend, the two within twice the
    one-hop rounding bound (dmax + 2) 2^-24 |A||X| (phase 12's bound for
    one hop)."""
    buckets, n = E_host
    grid = Grid.make(1, 1, device=dev)
    lc = grid.local_cols(n)
    E1 = EllParMat(buckets=tuple((bc.to(dev), (bc < lc).to(torch.float32).to(dev), br.to(dev))
                                 for bc, br in buckets), nrows=n, ncols=n, grid=grid)
    X = np.random.default_rng(SPMM_SEED).standard_normal((n, TUNER_SPMM_F)).astype(np.float32)
    Xd = DistMultiVec.from_global(grid, X)
    with tuner_env(ENV_PLAN_STORE=store_dir, ENV_PROBE="1"):
        st = tuner_store.get_store()
        backend, s = host_timed(lambda: resolve_spmm_backend(PLUS_TIMES, E1, TUNER_SPMM_F,
                                                             X=Xd))
        errors = list(tuner_probe.probe_spmm.last_errors)
        costs = dict(tuner_probe.probe_spmm.last_costs)
        first = st.stats()
        again, s2 = host_timed(lambda: resolve_spmm_backend(PLUS_TIMES, E1, TUNER_SPMM_F,
                                                            X=Xd))
        second = st.stats()
    if (errors or set(costs) != {"mxu_gather", "scatter"} or again != backend
            or second["probe_runs"] != first["probe_runs"] or second["hits"] != first["hits"] + 1):
        raise AssertionError(f"tuner spmm: {backend}/{again}, {costs}, {errors}, {second}")
    y = {b: dist_spmm_ell(PLUS_TIMES, E1, Xd, backend=b).blocks for b in SPMM_BACKENDS}
    mag = dist_spmm_ell(PLUS_TIMES, E1, DistMultiVec.from_global(grid, np.abs(X)),
                        backend="scatter").blocks
    deg = E1.reduce(PLUS_TIMES, "cols").blocks
    tol = (float(deg.max()) + 2) * 2.0**-24 * mag.double()
    diff = (y["mxu_gather"].double() - y["scatter"].double()).abs()
    if not bool((diff <= 2 * tol).all()):
        raise AssertionError("tuner spmm: the backends' hops differ beyond the rounding bound")
    line = {"phase": "tuner", "step": "spmm", "F": TUNER_SPMM_F, "n": n, "winner": backend,
            "backend_seconds": costs, "probing_call_s": s, "replay_call_s": s2,
            "store": {k: v for k, v in second.items() if k != "path"}, "last_errors": errors,
            "max_abs_diff_between_backends": float(diff.max()),
            "bound": "2 (dmax + 2) 2^-24 |A||X|"}
    emit(line)
    return line


def step_tuner_3d(dev, store_dir: Path, scale: int, ref_host: tuple) -> dict:
    """Step 6: ``spgemm3d`` on phase 14's recipe (min_plus A·A on 2×2×2, at
    its scale) with the probe on: the (tier, merge) candidates measured on
    the real operands, the winner persisted and replayed from the store;
    the product equal to phase 14's ESC sort result."""
    grid = Grid.make(M3_P, M3_P, device=dev)
    g3 = Grid3D.make(M3_LAYERS, M3_P, M3_P, device=dev)
    _, _, _, A = weighted_rmat(scale, dev, grid, MIN_PLUS)
    A3 = SpParMat3D.from_spmat(A, g3, "col")
    B3 = SpParMat3D.from_spmat(A, g3, "row")
    del A
    with tuner_env(ENV_PLAN_STORE=store_dir, ENV_PROBE="1"):
        st = tuner_store.get_store()
        C, s = host_timed(lambda: spgemm3d(MIN_PLUS, A3, B3))
        run = dict(mesh3d_mod.spgemm3d.last_run)
        errors = list(tuner_probe.probe_spgemm3d.last_errors)
        costs = dict(tuner_probe.probe_spgemm3d.last_costs)
        first = st.stats()
        if run["plan_source"] != "probe" or errors:
            raise AssertionError(f"tuner 3d: source {run['plan_source']}, skipped {errors}")
        got = live_entries3(C)
        del C
        if not same_entries(tuple(t.cpu() for t in got), ref_host):
            raise AssertionError("tuner 3d: differs from phase 14's ESC sort result")
        C, s2 = host_timed(lambda: spgemm3d(MIN_PLUS, A3, B3))
        run2 = dict(mesh3d_mod.spgemm3d.last_run)
        second = st.stats()
        if (run2["plan_source"] != "store" or second["probe_runs"] != first["probe_runs"]
                or not same_entries(live_entries3(C), got)):
            raise AssertionError(f"tuner 3d replay: {run2}, {second}")
        rec = st.peek(tuner_store.spgemm3d_plan_key(MIN_PLUS, A3, B3, ""))
    line = {"phase": "tuner", "step": "spgemm3d", "scale": scale,
            "grid3": f"{M3_LAYERS}x{M3_P}x{M3_P}", "winner": [rec.tier, rec.merge],
            "candidate_seconds": costs, "probing_call_s": s, "replay_call_s": s2,
            "replay_source": run2["plan_source"], "merge_source": run2["merge_source"],
            "store": {k: v for k, v in second.items() if k != "path"}, "last_errors": errors,
            "equal_to_phase14": True}
    emit(line)
    return line


def phase_tuner(dev, t_start: float, mxu_min: tuple, E_host: tuple, m3: dict) -> dict:
    """Phase 15 (module docstring): steps 1-6 with K1's and K2's launch
    counts set to 0 just before and read just after; each step's store is
    a fresh directory under ``PLAN_STORE_DIR``."""
    t0 = time.perf_counter()
    emit({"phase": "tuner", "step": "elapsed", "total_s": t0 - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    r, c = rmat_symmetric_coo_host(GRAPH_SEED, SCALE, EDGEFACTOR)
    v = np.random.default_rng(WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(np.float32)
    A = SpParMat.from_global_coo(Grid.make(1, 1, device=dev), r, c, v, FULL, FULL,
                                 dedup_sr=MIN_PLUS)
    step_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
        return res

    probe = timed("probe_replay_reload", step_tuner_probe, dev, A, mxu_min,
                  PLAN_STORE_DIR / "mxu", None)
    dot = timed("probe_dot", step_tuner_probe, dev, A, mxu_min, PLAN_STORE_DIR / "dot", "dot")
    del A
    spmm = timed("spmm", step_tuner_spmm, dev, E_host, PLAN_STORE_DIR / "spmm")
    d3 = timed("spgemm3d", step_tuner_3d, dev, PLAN_STORE_DIR / "spgemm3d", m3["scale"],
               m3["ref_host"])
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    k1 = probe["k1"] + dot["k1"]
    if launches != {"k1": k1, "k2": 0} or probe["line"]["k1_probe"] < 1:
        raise AssertionError(f"tuner launched {launches}; the steps count K1 {k1}, K2 0")
    phase_s = time.perf_counter() - t0
    emit({"phase": "tuner", "step": "checks", "hand_kernel_launches": launches,
          "k1_by_step": {"probe_replay_reload": probe["k1"], "probe_dot": dot["k1"],
                         "spmm": 0, "spgemm3d": 0},
          "step_s": step_s, "phase_s": phase_s, "cap_s": TUNER_CAP_S,
          "within_cap": phase_s <= TUNER_CAP_S, "total_s": time.perf_counter() - t_start})
    return {"probe": probe["line"], "dot": dot["line"], "spmm": spmm, "spgemm3d": d3,
            "k1": {"min_plus": k1, "max_min": 0}}


# --- phase 16: telemetry (obs) -------------------------------------------------------

OBS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_obs"
OBS_CAP_S = 40.0  # the phase's time budget
OBS_BFS_ROOTS = 4
OBS_REPS = 3  # timed calls after the warm-up, obs off and on
OBS_TRACES = 8  # profiler traces of a mode at most (records can be dropped)


def count_syncs(fn):
    """(result, synchronising calls) of ``fn``, counted as the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(1 for w in caught if "synchroniz" in str(w.message).lower())


def profiled(fn):
    """(result, profiler) of one call of ``fn`` under ``torch.profiler``
    (CPU and CUDA), the device synchronised inside the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def device_kernels(prof, span_names: set) -> list:
    """The kernels of a trace: device records, less copies and fills and
    less the ranges that ``record_function`` spans leave on the device's
    timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in span_names
            and not e.name.startswith(("Memcpy", "Memset", "Activity Buffer"))]


def same_tiles_bits(a: SpParMat, b: SpParMat) -> bool:
    """Every array of two products equal, padding slots included, values by
    their bits."""
    return (a.capacity == b.capacity and torch.equal(a.rows, b.rows)
            and torch.equal(a.cols, b.cols) and torch.equal(a.nnz, b.nnz)
            and torch.equal(a.vals.view(torch.int32), b.vals.view(torch.int32)))


def obs_series(prefixes: tuple) -> dict:
    """The registry's series whose name starts with one of ``prefixes``,
    as ``name{labels}`` -> value (a histogram: its count)."""
    out = {}
    for r in obs.registry.snapshot():
        if r["name"].startswith(prefixes):
            lab = ",".join(f"{k}={v}" for k, v in sorted(r["labels"].items()))
            out[r["name"] + (f"{{{lab}}}" if lab else "")] = (
                r["count"] if r["kind"] == "histogram" else r["value"])
    return out


def step_obs_contract(dev, A: SpParMat) -> dict:
    """Steps 1 and 2: phase 5's min_plus ``spgemm_auto`` (mxu) with obs off,
    on, and on with ``DEVICE_SYNC``: outputs bit-equal, K1 twice a call,
    the same device kernels in the profiler's traces off and on, the same
    synchronising calls off and on (traced and not), ``DEVICE_SYNC``
    adding the one readback of ``spgemm.realized_nnz``; the gated series; the ``spgemm.auto`` range
    around K1's two kernels; ``timers.trace`` naming the span; the call's
    ms with obs off and on."""
    def call():
        return spgemm_auto(MIN_PLUS, A, A)

    def traced(mode):
        obs.disable()
        obs.reset()
        if mode != "off":
            obs.enable(device_sync=mode == "sync", install_hooks=False)
        k1 = semiring_matmul.launches
        (C, syncs), prof = profiled(lambda: count_syncs(call))
        names = {r["name"] for r in obs._spans.log}
        run = {"C": C, "syncs": syncs, "k1": semiring_matmul.launches - k1,
               "kernels": device_kernels(prof, names), "prof": prof,
               "series": obs_series(("spgemm.",))}
        obs.disable()
        return run

    # warm-up, traced and counted as below and dropped: the duplicate
    # check's memo on A, and the first trace's one-time synchronisation
    traced("off")
    # The profiler drops device records on this machine (PERF.md §7), never
    # adds any: a mode whose trace shows fewer kernels than another's is
    # traced again, up to OBS_TRACES times, and its largest count stands.
    # DEVICE_SYNC is held to its synchronising calls, not traced.
    runs = {mode: [traced(mode)] for mode in ("off", "on")}
    while True:
        best = max(len(r["kernels"]) for rs in runs.values() for r in rs)
        short = [m for m, rs in runs.items()
                 if max(len(r["kernels"]) for r in rs) < best and len(rs) < OBS_TRACES]
        if not short:
            break
        for m in short:
            runs[m].append(traced(m))
    traces = {m: [len(r["kernels"]) for r in rs] for m, rs in runs.items()}
    # the synchronising calls again without the profiler, DEVICE_SYNC too
    untraced = {}
    for mode in ("off", "on", "sync"):
        obs.reset()
        if mode != "off":
            obs.enable(device_sync=mode == "sync", install_hooks=False)
        k1 = semiring_matmul.launches
        C, syncs = count_syncs(call)
        untraced[mode] = {"C": C, "syncs": syncs, "k1": semiring_matmul.launches - k1,
                          "series": obs_series(("spgemm.",))}
        obs.disable()
    every = [r for rs in runs.values() for r in rs] + list(untraced.values())
    C = runs["off"][0]["C"]
    nnz = int(C.getnnz())
    if not all(same_tiles_bits(C, r["C"]) for r in every):
        raise AssertionError("obs: the product differs with telemetry on")
    if any(r["k1"] != 2 for r in every):
        raise AssertionError(f"obs: K1 launches {[r['k1'] for r in every]}, want 2 each")
    n_kernels = {m: max(n) for m, n in traces.items()}
    if len(set(n_kernels.values())) != 1 or n_kernels["off"] < 2:
        raise AssertionError(f"obs: device kernels by trace {traces}")
    sync_sets = {m: {r["syncs"] for r in rs} for m, rs in runs.items()}
    if any(len(v) != 1 for v in sync_sets.values()) or sync_sets["on"] != sync_sets["off"]:
        raise AssertionError(f"obs: synchronising calls in the traces {sync_sets}")
    syncs = {m: r["syncs"] for m, r in untraced.items()}
    if syncs["on"] != syncs["off"] or syncs["sync"] != syncs["off"] + 1:
        raise AssertionError(f"obs: synchronising calls {syncs}")
    runs = {m: max(rs, key=lambda r: len(r["kernels"])) for m, rs in runs.items()}
    ser = untraced["sync"]["series"]
    want = {"spgemm.auto.tier{sr=min_plus,tier=mxu}": 1,
            "spgemm.mxu.overflow_retries": 1, "spgemm.realized_nnz": nnz}
    if any(ser.get(k) != v for k, v in want.items()):
        raise AssertionError(f"obs: series {ser}, want {want}")
    if untraced["on"]["series"].get("spgemm.realized_nnz") is not None:
        raise AssertionError("obs: spgemm.realized_nnz recorded without DEVICE_SYNC")
    # step 2: the span's range on the profiler's timeline
    evs = runs["on"]["prof"].events()
    spans = [e for e in evs if e.name == "spgemm.auto" and e.device_type.name == "CPU"]
    k1_kernels = [e for e in runs["on"]["kernels"] if "semiring_mm" in e.name]
    if len(spans) != 1 or len(k1_kernels) != 2:
        raise AssertionError(f"obs: {len(spans)} spgemm.auto ranges, {len(k1_kernels)} K1 kernels")
    lo, hi = spans[0].time_range.start, spans[0].time_range.end
    inside = [lo <= k.time_range.start and k.time_range.end <= hi for k in k1_kernels]
    if not all(inside):
        raise AssertionError(f"obs: K1 kernels outside the spgemm.auto range ({inside})")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    obs.enable(install_hooks=False)
    k1 = semiring_matmul.launches
    with timers.trace(str(OBS_DIR / "trace")):
        call()
        torch.cuda.synchronize()
    k1_trace = semiring_matmul.launches - k1
    obs.disable()
    files = list((OBS_DIR / "trace").iterdir())
    body = files[0].read_text() if len(files) == 1 else ""
    if "spgemm.auto" not in body or "semiring_mm" not in body:
        raise AssertionError(f"obs: timers.trace wrote {files}, naming the span: "
                             f"{'spgemm.auto' in body}")
    # the call's time, obs off and on (DEVICE_SYNC off), in turns
    ms = {}
    k1 = semiring_matmul.launches
    for mode in ("off", "on", "on", "off"):
        obs.reset()
        if mode == "on":
            obs.enable(install_hooks=False)
        ms.setdefault(mode, []).append(time_cuda_ms(call, OBS_REPS))
        obs.disable()
    k1_timed = semiring_matmul.launches - k1
    if k1_timed != 4 * (1 + OBS_REPS) * 2 or k1_trace != 2:
        raise AssertionError(f"obs: K1 launches in the timed calls {k1_timed}, trace {k1_trace}")
    line = {"phase": "obs", "step": "contract", "nnz_out": nnz, "bit_equal": True,
            "k1_per_call": 2, "device_kernels": n_kernels, "kernels_by_trace": traces,
            "sync_calls": syncs, "sync_calls_traced": {m: min(v) for m, v in sync_sets.items()},
            "series": ser, "span_encloses_k1": True,
            "span_ms": (hi - lo) / 1e3,
            "k1_kernel_ms": [(k.time_range.end - k.time_range.start) / 1e3 for k in k1_kernels],
            "trace_file_names_span": True, "ms_off": ms["off"], "ms_on": ms["on"]}
    emit(line)
    n_calls = len(every)
    del runs, every, untraced
    return {"line": line, "k1": 2 * (1 + n_calls) + k1_trace + k1_timed}


def step_obs_bfs(dev, E_host: tuple, bfs_host: dict) -> dict:
    """Step 3: ``bfs_levels_instrumented`` on phase 8's ELL layout from its
    first roots: levels equal to the numpy BFS, the frontier events equal to
    its level sizes (summing to the vertices found less the root),
    ``spmv.dispatch`` one a hop; ms a hop beside ``bfs``'s ms a level on the
    same roots."""
    buckets, n = E_host
    grid = Grid.make(1, 1, device=dev)
    E = EllParMat(buckets=tuple((bc.to(dev), torch.zeros(bc.shape, dtype=torch.int8, device=dev),
                                 br.to(dev)) for bc, br in buckets),
                  nrows=n, ncols=n, grid=grid)
    indptr, cols = bfs_host["indptr"], bfs_host["cols"]
    per_root = []
    for root in bfs_host["roots"][:OBS_BFS_ROOTS]:
        root = int(root)
        want = host_bfs_levels(indptr, cols, root)
        obs.reset()
        obs.enable(install_hooks=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, levels, hops = bfs_levels_instrumented(E, root)
        torch.cuda.synchronize()
        inst_s = time.perf_counter() - t0
        obs.disable()
        lv = levels.to_global()
        curve = [r["events"][0]["nnz"] for r in obs._spans.log if r["name"] == "bfs.hop"]
        sizes = np.bincount(want[want >= 0]).tolist()[1:] + [0]
        dispatch = obs.registry.get_counter("spmv.dispatch", kernel="dist_spmv_masked")
        if not np.array_equal(lv, want):
            raise AssertionError(f"obs bfs {root}: levels differ from the numpy BFS")
        if curve != sizes or sum(curve) != int((want >= 0).sum()) - 1 or dispatch != hops:
            raise AssertionError(f"obs bfs {root}: frontier {curve} vs {sizes}, "
                                 f"dispatch {dispatch} vs {hops} hops")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lv2, niter = bfs(E, root)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if niter != hops or not torch.equal(lv2.blocks, levels.blocks):
            raise AssertionError(f"obs bfs {root}: bfs gives {niter} levels, {hops} hops")
        per_root.append({"root": root, "hops": hops, "frontier": curve,
                         "ms_per_hop": inst_s * 1e3 / hops,
                         "bfs_ms_per_level": plain_s * 1e3 / niter})
    obs.reset()
    line = {"phase": "obs", "step": "bfs_levels_instrumented", "scale": BFS_SCALE,
            "levels_equal_numpy": True, "per_root": per_root,
            "ms_per_hop": float(np.mean([r["ms_per_hop"] for r in per_root])),
            "bfs_ms_per_level": float(np.mean([r["bfs_ms_per_level"] for r in per_root]))}
    emit(line)
    return line


def step_obs_tuner(dev, A: SpParMat, mxu_min: tuple) -> dict:
    """Step 4: phase 15's probe of the scale-13 min_plus product with obs on,
    in a fresh store: the ``tuner.probe.*``, ``tuner.store.*`` and
    ``spgemm.auto.plan_source`` series of the probing call and of the
    replay; K1's launches: the probe's candidates (warm-up and timed) plus
    the product, which the replay runs again."""
    prefixes = ("tuner.probe.", "tuner.store.", "spgemm.auto.plan_source")
    with tuner_env(ENV_PLAN_STORE=PLAN_STORE_DIR / "obs", ENV_PROBE="1"):
        obs.reset()
        obs.enable(install_hooks=False)
        log: list = []
        k1 = semiring_matmul.launches
        with counted_measure(log):
            C = spgemm_auto(MIN_PLUS, A, A)
        k1_probe = semiring_matmul.launches - k1
        probing = obs_series(prefixes)
        src1 = spgemm_auto.last_run["plan_source"]
        if not same_entries(tuple(t.cpu() for t in live_entries(C)), mxu_min):
            raise AssertionError("obs tuner: the probing call differs from phase 5's product")
        del C
        obs.reset()
        k1 = semiring_matmul.launches
        spgemm_auto(MIN_PLUS, A, A)
        k1_replay = semiring_matmul.launches - k1
        replay = obs_series(prefixes)
        src2 = spgemm_auto.last_run["plan_source"]
        obs.disable()
        obs.reset()
    candidates = sum(w + n for w, n in log)
    winner = [k for k in probing if k.startswith("tuner.probe.winner")]
    if (src1, src2) != ("probe", "store") or k1_probe != candidates + k1_replay:
        raise AssertionError(f"obs tuner: sources {src1}/{src2}, K1 {k1_probe} vs "
                             f"{candidates} + {k1_replay}")
    if (len(winner) != 1 or probing.get("tuner.store.misses{op=spgemm}") != 1
            or replay.get("tuner.store.hits{op=spgemm}") != 1
            or f"spgemm.auto.plan_source{{op=spgemm,source=probe,{winner[0][19:-1]}}}"
            not in probing):
        raise AssertionError(f"obs tuner: series {probing} / {replay}")
    line = {"phase": "obs", "step": "tuner", "probing_call": probing, "replay": replay,
            "k1_probing_call": k1_probe, "k1_candidates": candidates, "k1_replay": k1_replay}
    emit(line)
    return {"line": line, "k1": k1_probe + k1_replay}


def step_obs_sinks(dev) -> dict:
    """Step 5, on the host: the registry of the phase's last call through
    ``dump_jsonl`` -> ``parse_jsonl(validate=True)`` -> ``aggregate``, and
    ``export.render`` -> ``parse_exposition``, both equal to the registry;
    one fetch from a ``ScrapeServer`` on 127.0.0.1; a ``FlightRecorder``
    dump and a ``FleetLog`` read back; ``psum_counters`` on a 2x2 grid's
    counter tensor on the card against numpy."""
    import urllib.request

    obs.reset()
    obs.enable(install_hooks=False)
    with obs.span("obs.sinks", step=5):
        obs.count("obs.sinks.check", 3, kind="counter")
        obs.gauge("obs.sinks.gauge", 2.5)
        for i in range(600):
            obs.observe("obs.sinks.hist", i / 7)
        obs.span_event("checked", n=1)
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    path = obs.dump_jsonl(str(OBS_DIR / "obs.jsonl"))
    recs = obs.parse_jsonl(path, validate=True)
    agg = obs.aggregate(recs)
    snap = obs.registry.snapshot()
    counters = {r["name"]: r["value"] for r in snap if r["kind"] == "counter"}
    if (recs[0]["schema"] != obs.SCHEMA or {k.split("{")[0]: v for k, v in
                                             agg["counters"].items()} != counters
            or agg["span_table"]["obs.sinks"][1] != 1):
        raise AssertionError(f"obs sinks: JSONL round trip {agg['counters']} vs {counters}")
    text = obs_export.render()
    parsed = obs_export.parse_exposition(text)
    for r in snap:
        name = obs_export.metric_name(r["name"])
        lab = obs_export._labels(r["labels"])
        got = parsed.get((name + ("_count" if r["kind"] == "histogram" else ""), lab))
        want = r["count"] if r["kind"] == "histogram" else r["value"]
        if got != float(want):
            raise AssertionError(f"obs sinks: exposition {name}{lab} = {got}, want {want}")
    srv = obs_export.serve_scrape()
    try:
        body = urllib.request.urlopen(srv.url + "/metrics", timeout=10).read().decode()
    finally:
        srv.stop()
    scraped = {k: v for k, v in obs_export.parse_exposition(body).items()
               if not k[0].startswith("combblas_obs_scrape")}
    if scraped != parsed:
        raise AssertionError("obs sinks: the scrape differs from render()")
    rec = FlightRecorder(capacity=8, out_dir=str(OBS_DIR / "flightrec"))
    for i in range(10):
        rec.record("serve.batch", batch=i, outcome="ok")
    fr = obs.parse_jsonl(rec.dump("manual", force=True), validate=True)
    log = FleetLog(str(OBS_DIR / "fleet.jsonl"))
    for i in range(3):
        log.event("spawn", replica=i)
    fl = obs.parse_jsonl(log.path, validate=True)
    if (fr[0]["schema"] != obs.FLIGHTREC_SCHEMA or [e["batch"] for e in fr[1:]] != list(
            range(2, 10)) or fl[0]["schema"] != obs.FLEETLOG_SCHEMA or len(fl) != 4):
        raise AssertionError("obs sinks: flight recorder or fleet log round trip")
    local = torch.arange(2 * 2 * 5, dtype=torch.int64, device=dev).reshape(2, 2, 5) * 3 - 7
    tot = obs.psum_counters(Grid.make(2, 2, device=dev), local)
    if not np.array_equal(tot.cpu().numpy(), local.cpu().numpy().sum(axis=(0, 1))):
        raise AssertionError("obs sinks: psum_counters differs from numpy")
    obs.disable()
    obs.reset()
    line = {"phase": "obs", "step": "sinks", "jsonl_records": len(recs),
            "exposition_lines": len(text.splitlines()), "scrape_equal": True,
            "flightrec_events": len(fr) - 1, "fleetlog_events": len(fl) - 1,
            "psum_counters": tot.cpu().tolist()}
    emit(line)
    return line


def phase_obs(dev, t_start: float, mxu_min: tuple, E_host: tuple, bfs_host: dict) -> dict:
    """Phase 16 (module docstring): steps 1-5 with K1's and K2's launch
    counts set to 0 just before and read just after; K1 runs only in the
    min_plus products of steps 1, 2 and 4."""
    t0 = time.perf_counter()
    emit({"phase": "obs", "step": "elapsed", "total_s": t0 - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    r, c = rmat_symmetric_coo_host(GRAPH_SEED, SCALE, EDGEFACTOR)
    v = np.random.default_rng(WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(np.float32)
    A = SpParMat.from_global_coo(Grid.make(1, 1, device=dev), r, c, v, FULL, FULL,
                                 dedup_sr=MIN_PLUS)
    step_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
        return res

    try:
        contract = timed("contract", step_obs_contract, dev, A)
        bfs_line = timed("bfs", step_obs_bfs, dev, E_host, bfs_host)
        tuner = timed("tuner", step_obs_tuner, dev, A, mxu_min)
        sinks = timed("sinks", step_obs_sinks, dev)
    finally:
        obs.disable()
        obs.reset()
        shutil.rmtree(OBS_DIR, ignore_errors=True)
    del A
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    k1 = contract["k1"] + tuner["k1"]
    if launches != {"k1": k1, "k2": 0}:
        raise AssertionError(f"obs launched {launches}; the steps count K1 {k1}, K2 0")
    phase_s = time.perf_counter() - t0
    emit({"phase": "obs", "step": "checks", "hand_kernel_launches": launches,
          "k1_by_step": {"contract": contract["k1"], "bfs": 0, "tuner": tuner["k1"],
                         "sinks": 0},
          "step_s": step_s, "phase_s": phase_s, "cap_s": OBS_CAP_S,
          "within_cap": phase_s <= OBS_CAP_S, "total_s": time.perf_counter() - t_start})
    return {"contract": contract["line"], "bfs": bfs_line, "tuner": tuner["line"],
            "sinks": sinks, "k1": {"min_plus": k1, "max_min": 0}}


# --- phase 17: the serving engine and the mutation lane -----------------------------

ENGINE_KINDS = ("bfs", "sssp", "pagerank", "bc", "propagate")
ENGINE_ROOTS = 16  # of phase 8's roots, served a kind in one 16-lane batch
ENGINE_WIDTHS = (1, 2, 4, 8, 16)  # the batcher's buckets, warmed up
ENGINE_PADDED = 5  # a bfs batch of 5 roots in the 8-lane bucket: 3 PAD_ROOT lanes
ENGINE_HOST_LANES = 2  # lanes also held against a numpy BFS
CHURN_PAIRS = 2  # insert batches, then as many deletes (the reference's recipe has 24: cut)
CHURN_DEGREES = (5, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19)  # +1 stays in the class
DUR_KINDS, DUR_GRID, DUR_BATCHES, DUR_ROOTS = ("bfs", "pagerank"), (2, 2), 4, 4  # 8 batches: cut
DUR_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_engine"
REFRESH_PR_L1 = 2.0  # warm vs cold ranks: L1 within this many tol / (1 - alpha)
# warm vs cold ranks at the inserted edge's ends, relative: an H100 run read
# 0.0024 for the warm ranks and 0.061 for the stale ones (PERF.md §6)
REFRESH_PR_END_REL = 0.02
ENGINE_CAP_S = 60.0  # the phase's time budget


def _requests(kind: str, roots) -> list:
    return [Request(rid=i, kind=kind, root=int(r), future=Future(),
                    submitted_at=time.monotonic()) for i, r in enumerate(roots)]


def _direct_lanes(eng, kind: str, src: np.ndarray) -> dict:
    """The port's direct batch call of ``kind`` on the engine's current
    operands: host arrays with the lane axis last, as ``execute`` gives."""
    if kind == "bfs":
        p, lv, _ = bfs_batch(eng.E, src, max_iters=eng.max_iters)
        return {"parents": p.to_global(), "levels": lv.to_global()}
    if kind == "sssp":
        return {"dist": sssp_batch(eng.E_weighted, src)[0].to_global()}
    if kind == "pagerank":
        alpha, tol, iters = eng.pagerank_opts
        x, _ = pagerank_batch(eng.P_ell, src, eng.dangling, alpha=alpha, tol=tol,
                              max_iters=iters)
        return {"ranks": x.to_global()}
    if kind == "bc":
        return {"scores": bc_batch_dense_lanes(eng.E, eng.ET, src).to_global()}
    hops, normalize = eng.propagate_opts
    feats = propagate_mod._propagate_batch_impl(
        eng.ET, eng.version.X, None, src, hops=hops, normalize=normalize,
        backend=eng._resolve_spmm_backend())
    return {"features": feats.cpu().numpy()[: eng.version.feat_dim]}


def _same_lanes(lanes: list, want: dict) -> None:
    """Raise unless each request's lane equals ``want``'s lane bit for bit."""
    for k, lane in enumerate(lanes):
        for key, w in want.items():
            got, ref = lane[key], np.ascontiguousarray(w[..., k])
            if got.dtype != ref.dtype or got.tobytes() != ref.tobytes():
                raise AssertionError(f"served lane {k} {key} differs from the direct call")


def _engine_coo(csr_host: dict):
    """Phase 8's graph as row-sorted COO (its CSC arrays on one tile: the
    graph is symmetric) and n."""
    indptr, rowidx = csr_host["indptr"], csr_host["cols"]
    n = len(indptr) - 1
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr)), rowidx.astype(np.int64), n


def step_engine_serve(dev, csr_host: dict, roots: np.ndarray) -> dict:
    """Step 1: the engine on phase 8's graph, warmed up, serving 16 roots a
    kind through the batcher, each lane held against the direct call."""
    t = time.perf_counter()
    rows, cols, n = _engine_coo(csr_host)
    w = np.random.default_rng(WEIGHT_SEED).integers(1, 16, len(rows)).astype(np.float32)
    X = np.random.default_rng(SPMM_SEED).standard_normal((n, SPMM_F)).astype(np.float32)
    spent = {"inputs": time.perf_counter() - t}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = GraphEngine.from_coo(Grid.make(1, 1, device=dev), rows, cols, n, weights=w,
                               features=X, kinds=ENGINE_KINDS, keep_coo=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    del w, X
    warm = eng.warmup(widths=ENGINE_WIDTHS)
    mark = eng.trace_mark()
    ms, niter, lanes16 = {}, {}, {}
    spent["direct"] = 0.0
    for kind in ENGINE_KINDS:
        reqs = _requests(kind, roots)
        src = assemble(reqs, ENGINE_WIDTHS)
        res, sec = host_timed(lambda: eng.execute(kind, src))
        ms[kind] = sec * 1e3
        if scatter(reqs, res) != len(reqs):
            raise AssertionError(f"{kind}: scatter settled fewer requests than it was given")
        lanes16[kind] = [r.future.result() for r in reqs]
        niter[kind] = res.get("batch_niter")
        t = time.perf_counter()
        _same_lanes(lanes16[kind], _direct_lanes(eng, kind, src))
        spent["direct"] += time.perf_counter() - t
    # a padded batch: 5 roots in the 8-lane bucket, equal to their lanes in
    # the 16-lane batch, the pad lanes inert
    reqs = _requests("bfs", roots[:ENGINE_PADDED])
    src = assemble(reqs, ENGINE_WIDTHS)
    res = eng.execute("bfs", src)
    scatter(reqs, res)
    if len(src) != 8 or (src[ENGINE_PADDED:] != PAD_ROOT).any() or (
            res["levels"][:, ENGINE_PADDED:] != -1).any() or (
            res["parents"][:, ENGINE_PADDED:] != -1).any():
        raise AssertionError("the padded bfs batch's pad lanes are not inert")
    for k, r in enumerate(reqs):
        for key in ("parents", "levels"):
            if not np.array_equal(r.future.result()[key], lanes16["bfs"][k][key]):
                raise AssertionError(f"padded batch lane {k} {key} differs from the 16-lane batch")
    t = time.perf_counter()
    for k in range(ENGINE_HOST_LANES):
        want = host_bfs_levels(csr_host["indptr"], csr_host["cols"], int(roots[k]))
        if not np.array_equal(lanes16["bfs"][k]["levels"], want):
            raise AssertionError(f"served bfs lane {k} differs from the numpy BFS")
    spent["host_bfs"] = time.perf_counter() - t
    if eng.retraces_since(mark):
        raise AssertionError("serving built a plan after the warm-up")
    stats = eng.stats()
    line = {"phase": "engine", "step": "serve", "scale": BFS_SCALE, "grid": "1x1", "n": n,
            "nnz": eng.version.nnz, "kinds": list(ENGINE_KINDS), "F": SPMM_F,
            "build_s": build_s, "device_bytes": eng.version.device_bytes(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "warmup_s": {f"{k}/{w_}": s for (k, w_), s in warm.items()},
            "warmup_total_s": sum(warm.values()), "spent_s": spent,
            "W": len(roots), "ms_per_batch": ms, "batch_niter": niter,
            "plan_hits": stats["plan_hits"], "plan_misses": stats["plan_misses"],
            "lanes_equal_direct": True, "host_bfs_lanes": ENGINE_HOST_LANES,
            "padded_batch_lanes": [ENGINE_PADDED, 8]}
    emit(line)
    return {"line": line, "eng": eng, "mark": mark, "rows": rows, "cols": cols, "n": n,
            "build_s": build_s, "lanes16": lanes16}


def churn_pairs(csr_host: dict, deg: np.ndarray, count: int) -> list:
    """Disjoint vertex pairs (in vertex order) whose degrees sit below
    their class width and that are not yet edges: the reference's churn
    recipe (each merge stays in place)."""
    indptr, nbrs = csr_host["indptr"], csr_host["cols"]
    pool = np.flatnonzero(np.isin(deg, CHURN_DEGREES)).tolist()
    pairs = []
    for a, b in zip(pool[0::2], pool[1::2]):
        row = nbrs[indptr[a]:indptr[a + 1]]
        if not (row == b).any():
            pairs.append((a, b))
        if len(pairs) == count:
            return pairs
    raise AssertionError(f"only {len(pairs)} churn pairs in the graph, want {count}")


@contextlib.contextmanager
def timed_uploads(log: dict):
    """Time ``dynamic.merge._put_buckets`` (one ``.to(device)`` an array)
    while the block runs, with a synchronise after each call: seconds,
    arrays and bytes added to ``log``."""
    put = merge_mod._put_buckets

    def timed(grid, host_buckets):
        t = time.perf_counter()
        out = put(grid, host_buckets)
        torch.cuda.synchronize()
        log["s"] += time.perf_counter() - t
        log["arrays"] += sum(len(triple) for triple in host_buckets)
        log["bytes"] += sum(a.nbytes for triple in host_buckets for a in triple)
        return out

    merge_mod._put_buckets = timed
    try:
        yield log
    finally:
        merge_mod._put_buckets = put


def _swap_merge(eng, buf, ops) -> tuple:
    """One write through the lane: admit, drain, merge, swap. Returns the
    merge stats and the swap seconds."""
    buf.add_many(ops)
    v = eng.apply_delta(buf.drain())
    st = v.dyn.last_stats
    if st.mode != "incremental":
        raise AssertionError(f"churn merge was {st.mode} ({st.reason}), want incremental")
    return st, eng.swap(v)


def _refresh_line(out: dict) -> dict:
    return {"mode": out["mode"], "reason": out.get("cold_reason", ""), "sweeps": out["niter"],
            "ms": out["latency_s"] * 1e3}


def pagerank_readings(eng, stale, warm, cold, ends) -> dict:
    """Warm against cold ranks after an insert, beside the same readings
    of the stale (unrefreshed) ranks as a control: the L1 distance, its
    limit (both runs stop within tol / (1 - alpha) of the fixed point, in
    L1), and the largest relative difference at the inserted edge's ends."""
    alpha, tol, _ = eng.pagerank_opts
    ends = np.asarray(ends)
    cold = cold.astype(np.float64)

    def read(x):
        d = np.abs(x.astype(np.float64) - cold)
        return float(d.sum()), float((d[ends] / cold[ends]).max())

    (l1, end_rel), (stale_l1, stale_end_rel) = read(warm), read(stale)
    return {"l1": l1, "l1_limit": REFRESH_PR_L1 * tol / (1 - alpha), "end_rel": end_rel,
            "stale_l1": stale_l1, "stale_end_rel": stale_end_rel}


def step_engine_churn(serve: dict, csr_host: dict, roots: np.ndarray) -> dict:
    """Steps 2 and 3: the churn through the lane, the refreshes interleaved
    with its first insert and its first delete."""
    eng, n = serve["eng"], serve["n"]
    pairs = churn_pairs(csr_host, np.asarray(eng.version.deg), CHURN_PAIRS)
    buf = DeltaBuffer(nrows=n, ncols=n)
    root = int(roots[0])
    refresh = {"v0": {k: eng.refresh(k, root=root if k == "bfs" else None)
                      for k in REFRESH_KINDS}}
    if any(r["mode"] != "cold" for r in refresh["v0"].values()):
        raise AssertionError("the first refreshes were not cold")
    stats, swap_s = [], []
    up = {"s": 0.0, "arrays": 0, "bytes": 0}
    for k, (a, b) in enumerate(pairs):
        with timed_uploads(up):
            st, sw = _swap_merge(eng, buf, [("insert", a, b), ("insert", b, a)])
        stats.append(st)
        swap_s.append(sw)
        if k == 0:
            warm = {kind: eng.refresh(kind, root=root if kind == "bfs" else None)
                    for kind in REFRESH_KINDS}
            cold = {kind: eng.refresh(kind, root=root if kind == "bfs" else None,
                                      force_cold=True) for kind in REFRESH_KINDS}
            if any(r["mode"] != "warm" for r in warm.values()):
                raise AssertionError(f"refresh after an insert: {[r['mode'] for r in warm.values()]}")
            for kind in ("bfs", "cc"):
                if not np.array_equal(warm[kind]["result"], cold[kind]["result"]):
                    raise AssertionError(f"warm {kind} refresh differs from the cold one")
            pr = pagerank_readings(eng, refresh["v0"]["pagerank"]["result"],
                                   warm["pagerank"]["result"], cold["pagerank"]["result"], (a, b))
            if (pr["l1"] > pr["l1_limit"] or pr["end_rel"] > REFRESH_PR_END_REL
                    or warm["pagerank"]["niter"] > refresh["v0"]["pagerank"]["niter"]):
                raise AssertionError(f"warm pagerank: {pr}, sweeps {warm['pagerank']['niter']} "
                                     f"vs cold {refresh['v0']['pagerank']['niter']}")
            if pr["stale_end_rel"] <= REFRESH_PR_END_REL:
                raise AssertionError(f"the stale ranks pass the warm pagerank check: {pr}")
            refresh["insert_warm"], refresh["insert_cold"] = warm, cold
    # the merged edge set on the card, and served BFS against a rebuild
    r0, c0 = serve["rows"], serve["cols"]
    keys0 = r0 * np.int64(n) + c0
    ins = np.sort([a * n + b for a, b in pairs] + [b * n + a for a, b in pairs])
    want = np.insert(keys0, np.searchsorted(keys0, ins), ins)
    (rr, cc, vv), coo_s = host_timed(eng.E.to_host_coo)
    if not (np.array_equal(rr * np.int64(n) + cc, want) and (vv == 1).all()):
        raise AssertionError("the merged E differs from the expected edge set")
    src = assemble(_requests("bfs", roots), ENGINE_WIDTHS)
    served = eng.execute("bfs", src)
    t = time.perf_counter()
    rebuilt = GraphEngine.from_coo(eng.grid, want // n, want % n, n, kinds=("bfs",))
    rebuild_bfs_s = time.perf_counter() - t
    again = rebuilt.execute("bfs", src)
    del rebuilt
    for key in ("parents", "levels"):
        if not np.array_equal(served[key], again[key]):
            raise AssertionError(f"served bfs {key} on the merged version differs from a rebuild")
    # before the first delete, the cache at its parent version
    pre = {kind: eng.refresh(kind, root=root if kind == "bfs" else None) for kind in ("bfs", "cc")}
    for k, (a, b) in enumerate(pairs):
        with timed_uploads(up):
            st, sw = _swap_merge(eng, buf, [("delete", a, b), ("delete", b, a)])
        stats.append(st)
        swap_s.append(sw)
        if k == 0:
            after = {kind: eng.refresh(kind, root=root if kind == "bfs" else None)
                     for kind in ("bfs", "cc")}
            if any((r["mode"], r["cold_reason"]) != ("cold", "deletes") for r in after.values()):
                raise AssertionError(f"refresh after a delete: {after}")
            refresh["pre_delete"], refresh["delete"] = pre, after
    rr, cc, vv = eng.E.to_host_coo()
    if not (np.array_equal(rr, r0) and np.array_equal(cc, c0) and (vv == 1).all()):
        raise AssertionError("E after the deletes differs from the original")
    if eng.retraces_since(serve["mark"]):
        raise AssertionError("the churn built a plan after the warm-up")
    # the first merge bootstraps the merge state: it is printed apart, and
    # the mean, the tail and the amortization are those of the others
    merge_ms = np.array([s.latency_s * 1e3 for s in stats[1:]])
    line = {"phase": "engine", "step": "churn", "batches": len(stats), "pairs": len(pairs),
            "modes": sorted({s.mode for s in stats}),
            "merge_ms_mean": float(merge_ms.mean()), "merge_ms_max": float(merge_ms.max()),
            "merge_ms_first": stats[0].latency_s * 1e3, "bootstrapped_first": stats[0].bootstrapped,
            "swap_ms_mean": float(np.mean(swap_s) * 1e3), "swap_ms_max": float(np.max(swap_s) * 1e3),
            "buckets_uploaded": sum(s.buckets_uploaded for s in stats),
            "buckets_reused": sum(s.buckets_reused for s in stats),
            "rows_patched": sum(s.rows_patched for s in stats),
            "upload_ms_per_merge": up["s"] * 1e3 / len(stats),
            "upload_arrays_per_merge": up["arrays"] / len(stats),
            "upload_mb_per_merge": up["bytes"] / 2**20 / len(stats),
            "upload_gb_per_s": up["bytes"] / max(up["s"], 1e-12) / 1e9,
            "amortization": serve["build_s"] / (merge_ms.mean() / 1e3),
            "to_host_coo_ms": coo_s * 1e3, "rebuild_bfs_only_s": rebuild_bfs_s,
            "plan_builds_after_warmup": 0, "edge_sets_equal": True, "served_bfs_equals_rebuild": True}
    emit(line)
    rline = {"phase": "engine", "step": "refresh", "root": root, "pagerank_warm_vs_cold": pr,
             **{f"{stage}/{kind}": _refresh_line(out) for stage, group in refresh.items()
                for kind, out in group.items()}}
    emit(rline)
    return {"churn": line, "refresh": rline, "pairs": pairs}


def _same_version(a, b, what: str) -> None:
    """Raise unless every bucket array of E and P_ell and E's
    ``to_host_coo`` are equal (the buckets fix P_ell's COO too)."""
    for nm in ("E", "P_ell"):
        x, y = getattr(a, nm), getattr(b, nm)
        if len(x.buckets) != len(y.buckets) or not all(
                torch.equal(p, q) for bx, by in zip(x.buckets, y.buckets) for p, q in zip(bx, by)):
            raise AssertionError(f"{what}: {nm} buckets differ")
    if not all(np.array_equal(p, q) for p, q in zip(a.E.to_host_coo(), b.E.to_host_coo())):
        raise AssertionError(f"{what}: E's COO differs")


def step_engine_durability(dev, g18: dict) -> dict:
    """Step 4: WAL + snapshot on phase 10's scale-18 graph on 2x2: crash,
    recover, torn tail, swap into a warmed replica, a spilling batch."""
    shutil.rmtree(DUR_DIR, ignore_errors=True)
    DUR_DIR.mkdir(parents=True)
    grid = Grid.make(*DUR_GRID, device=dev)
    rows, cols = g18["rows"].astype(np.int64), g18["cols"].astype(np.int64)
    n = len(g18["deg"])
    t = time.perf_counter()
    eng = GraphEngine.from_coo(grid, rows, cols, n, kinds=DUR_KINDS, keep_coo=True)
    build_s = time.perf_counter() - t
    v = eng.version
    snap = str(DUR_DIR / checkpoint.snapshot_name(v.wal_seq))
    t = time.perf_counter()
    checkpoint.save_version(snap, v)
    save_s = time.perf_counter() - t
    # a read-only replica from the snapshot, warmed up
    replica = GraphEngine(grid, version=checkpoint.load_version(snap, grid, writable=False),
                          kinds=DUR_KINDS)
    droots = np.flatnonzero(g18["deg"] > 0)[:DUR_ROOTS].astype(np.int32)
    replica.warmup(kinds=("bfs",), widths=(DUR_ROOTS,))
    mark = replica.trace_mark()
    wal = open_wal(str(DUR_DIR))
    buf = DeltaBuffer(nrows=n, ncols=n)
    csr = {"indptr": np.searchsorted(rows, np.arange(n + 1)), "cols": cols}
    versions = []
    more = churn_pairs(csr, g18["deg"], DUR_BATCHES + SERVER_DUR_BATCHES)
    for a, b in more[:DUR_BATCHES]:
        ops = [("insert", a, b, 1.0), ("insert", b, a, 1.0)]
        last = buf.add_many(ops)
        wal.append(last - 1, [a, b], [b, a], [1.0, 1.0], [0, 0])
        batch = buf.drain()
        v = eng.apply_delta(batch)
        v.wal_seq = batch.last_seq
        eng.swap(v)
        versions.append(v)
    served = eng.execute("bfs", droots)
    del eng, wal, buf  # the crash: only the files survive
    t = time.perf_counter()
    got = recover(str(DUR_DIR), grid, kinds=DUR_KINDS)
    recover_s = time.perf_counter() - t
    _same_version(got, versions[-1], "recovered")
    replayed = got.recovered_from[2]
    # a torn final line: recovery gives the version before the last batch;
    # the whole log is put back afterwards for phase 18
    walp = DUR_DIR / "wal.jsonl"
    whole = walp.read_bytes()
    lines = whole.splitlines(keepends=True)
    walp.write_bytes(b"".join(lines[:-1]) + lines[-1][: len(lines[-1]) // 2])
    torn = recover(str(DUR_DIR), grid, kinds=DUR_KINDS)
    _same_version(torn, versions[-2], "recovered from a torn tail")
    walp.write_bytes(whole)
    replica.swap(got)
    again = replica.execute("bfs", droots)
    if replica.retraces_since(mark) or not all(
            np.array_equal(served[k], again[k]) for k in ("parents", "levels")):
        raise AssertionError("the recovered version built a plan or served another BFS")
    # one batch past the spill fraction: a rebuild equal to a fresh build
    frac = tuner_config.dynamic_spill_frac()
    m = int(frac * got.nnz) + 2
    rng = np.random.default_rng(GRAPH_SEED)
    a, b = rng.integers(0, n, m), rng.integers(0, n, m)
    spill = DeltaBatch(rows=np.concatenate([a, b]), cols=np.concatenate([b, a]),
                       vals=np.ones(2 * m, np.float32), ops=np.zeros(2 * m, np.int8),
                       first_seq=0, last_seq=2 * m - 1, oldest_at=0.0)
    t = time.perf_counter()
    big = apply_delta(got, spill, kinds=DUR_KINDS)
    spill_ms = (time.perf_counter() - t) * 1e3
    st = big.dyn.last_stats
    if (st.mode, st.reason) != ("rebuild", "threshold"):
        raise AssertionError(f"the spilling batch merged {st.mode} ({st.reason})")
    r1, c1, _ = big.host_coo
    _same_version(big, replica.build_version(r1, c1), "the spill rebuild against a fresh build")
    line = {"phase": "engine", "step": "durability", "scale": 18, "grid": "x".join(map(str, DUR_GRID)),
            "n": n, "nnz": int(len(rows)), "kinds": list(DUR_KINDS), "build_s": build_s,
            "save_s": save_s, "snapshot_mb": os.path.getsize(snap) / 2**20,
            "batches": DUR_BATCHES, "recover_s": recover_s, "replayed_ops": replayed,
            "torn_tail_recovers_batch": DUR_BATCHES - 1, "swap_plan_builds": 0,
            "spill_frac": frac, "spill_ops": 2 * m, "spill_mode": st.mode, "spill_ms": spill_ms,
            "bit_exact": True}
    emit(line)
    # phase 18 recovers from this directory, and removes it
    return {"line": line, "grid": grid, "never": versions[-1], "pairs": more[DUR_BATCHES:]}


def phase_engine(dev, t_start: float, csr_host: dict, roots: np.ndarray, g18: dict) -> dict:
    """Phase 17 (module docstring): steps 1-4 with K1's and K2's launch
    counts set to 0 just before and read just after; neither runs."""
    t0 = time.perf_counter()
    emit({"phase": "engine", "step": "elapsed", "total_s": t0 - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t
        return res

    serve = timed("serve", step_engine_serve, dev, csr_host, roots)
    churn = timed("churn", step_engine_churn, serve, csr_host, roots)
    torch.cuda.empty_cache()
    dur = timed("durability", step_engine_durability, dev, g18)
    torch.cuda.empty_cache()
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the engine phase launched hand kernels: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "engine", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "phase_s": phase_s, "cap_s": ENGINE_CAP_S,
          "within_cap": phase_s <= ENGINE_CAP_S, "total_s": time.perf_counter() - t_start})
    # phase 18 serves the scale-20 engine and recovers from the scale-18
    # directory
    return {"churn": churn, "durability": dur["line"], "k1": {"min_plus": 0, "max_min": 0},
            "serve": serve, "dur": dur}


# --- phase 18: the Server --------------------------------------------------------

SERVER_WIDTHS = ENGINE_WIDTHS  # the lane buckets, as phase 17 warmed them
SERVER_KINDS = ("bfs", "sssp", "pagerank", "bc")  # served in step 1
SERVER_REPEATS = 4  # bfs submits of each root in step 1 (from 4 clients)
SERVER_CLIENTS = 4
SERVER_MAX_WAIT_S = 0.05  # a submit_many of 16 fills its bucket well inside it
# the SLO deadline: step 1's p99 is under 4 s on an H100 (PERF.md §6);
# a request past it expires, so it is set well clear of that
SERVER_SLO_S = 10.0
SERVER_RES_WIDTHS = (1, 2, 4)  # step 2's buckets: a bisection of at most 4 roots
SERVER_DUR_BATCHES = 2  # step 4's write batches
SERVER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_server"  # flight recorder
SERVER_CAP_S = 40.0  # the phase's time budget


def _settled_lane(res: dict, want: dict, kind: str, root: int) -> None:
    """Raise unless a served result equals phase 17's lane, bit for bit."""
    for key, arr in want.items():
        if not isinstance(arr, np.ndarray):
            continue
        got = res[key]
        if got.dtype != arr.dtype or got.tobytes() != arr.tobytes():
            raise AssertionError(f"served {kind} {key} for root {root} differs from phase 17's lane")


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _check_health(srv, what: str) -> dict:
    h = srv.health()
    if h["status"] != "ok" or h["device_error"] is not None or h["worker_errors"]:
        raise AssertionError(f"{what}: health {h['status']}, device error {h['device_error']}, "
                             f"worker errors {h['worker_errors']}")
    return h


def step_server_serve(serve: dict, roots: np.ndarray) -> dict:
    """Step 1: ``eng.serve`` over phase 17's scale-20 engine, 112 requests
    from 4 client threads, every result equal to phase 17's lane."""
    eng = serve["eng"]
    lanes = {kind: dict(zip(map(int, roots), serve["lanes16"][kind])) for kind in SERVER_KINDS}
    cfg = ServeConfig(lane_widths=SERVER_WIDTHS, max_wait_s=SERVER_MAX_WAIT_S,
                      slo_deadline_s=SERVER_SLO_S, update_flush=2,
                      flight_recorder_dir=str(SERVER_DIR))
    srv = eng.serve(cfg)
    t = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t
    mark = eng.trace_mark()
    srv.start()
    # client k submits the 16 roots for bfs (the first SERVER_REPEATS
    # clients), then one other kind: one submit_many a kind, one 16-lane
    # batch, as phase 17 served them (a pagerank lane depends on its
    # batch-mates: the batch runs until its slowest lane converges)
    plan = [[("bfs", roots)] if k < SERVER_REPEATS else [] for k in range(SERVER_CLIENTS)]
    for k, kind in enumerate(SERVER_KINDS[1:]):
        plan[k].append((kind, roots))
    futs, lock = [], threading.Lock()

    def client(jobs):
        for kind, rs in jobs:
            t0 = time.monotonic()
            fs = srv.submit_many(kind, [int(r) for r in rs])
            with lock:
                for r, f in zip(rs, fs):
                    rec = {"kind": kind, "root": int(r), "t0": t0, "f": f}
                    f.add_done_callback(lambda _f, rec=rec: rec.__setitem__("t1", time.monotonic()))
                    futs.append(rec)

    t = time.perf_counter()
    threads = [threading.Thread(target=client, args=(p,)) for p in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [(rec, rec["f"].result(timeout=120)) for rec in futs]
    wall_s = time.perf_counter() - t
    want_n = len(roots) * (SERVER_REPEATS + len(SERVER_KINDS) - 1)
    if len(results) != want_n:
        raise AssertionError(f"{len(results)} requests settled, want {want_n}")
    for rec, res in results:
        _settled_lane(res, lanes[rec["kind"]][rec["root"]], rec["kind"], rec["root"])
    if eng.retraces_since(mark):
        raise AssertionError("the server built a plan after its warm-up")
    st = srv.stats()
    h = _check_health(srv, "step 1")
    lat = {kind: [(r["t1"] - r["t0"]) * 1e3 for r, _ in results if r["kind"] == kind]
           for kind in SERVER_KINDS}
    events = [e for e in srv._recorder.snapshot() if e.get("name") == "serve.batch"]
    waits = [e["queue_wait_s"] * 1e3 for e in events if "queue_wait_s" in e]
    exec_ms = {kind: [e["execute_s"] * 1e3 for e in events
                      if e.get("query") == kind and "execute_s" in e] for kind in SERVER_KINDS}
    scatter_ms = {kind: [e["scatter_s"] * 1e3 for e in events
                         if e.get("query") == kind and "scatter_s" in e] for kind in SERVER_KINDS}
    line = {"phase": "server", "step": "serve", "scale": BFS_SCALE, "grid": "1x1",
            "requests": len(results), "clients": len(plan), "bfs_repeats": SERVER_REPEATS,
            "warmup_s": warm_s, "wall_s": wall_s, "requests_per_s": len(results) / wall_s,
            "p50_ms": {k: _pct(v, 50) for k, v in lat.items()},
            "p99_ms": {k: _pct(v, 99) for k, v in lat.items()},
            "execute_ms": exec_ms, "scatter_ms": scatter_ms, "batches": st["batches"],
            "mean_occupancy": st["mean_occupancy"],
            "queue_wait_ms_mean": float(np.mean(waits)) if waits else None,
            "queue_wait_ms_max": float(np.max(waits)) if waits else None,
            "slo": st["slo"], "health": h["status"], "device_error": h["device_error"],
            "plan_builds_after_warmup": 0, "lanes_equal_phase17": True}
    emit(line)
    return {"line": line, "srv": srv, "mark": mark, "lanes": lanes}


def step_server_resilience(serve: dict, roots: np.ndarray, lanes: dict) -> dict:
    """Step 2: a scripted execute fault bisected, a malformed root failed
    alone, an expired request dropped before execution; batches of at
    most 4 roots, pumped in this thread."""
    eng, n = serve["eng"], serve["n"]
    srv = eng.serve(ServeConfig(lane_widths=SERVER_RES_WIDTHS, max_wait_s=60.0,
                                flight_recorder_dir=str(SERVER_DIR)))
    rs = [int(r) for r in roots[:4]]
    k0 = srv.faults.stats()["calls"].get("engine.execute", 0)
    srv.faults.script("engine.execute", at=[k0])
    t = time.perf_counter()
    futs = srv.submit_many("bfs", rs)
    srv.pump(force=True)
    bisect_ms = (time.perf_counter() - t) * 1e3
    for r, f in zip(rs, futs):
        _settled_lane(f.result(timeout=0), lanes["bfs"][r], "bfs", r)
    srv.faults.clear()
    fired = srv.faults.stats()["fired"].get("engine.execute", 0)
    if fired != 1 or srv.retry_batches != 2:
        raise AssertionError(f"the fault fired {fired} times, {srv.retry_batches} retry batches")
    # a malformed root fails alone at admission; its lane-mates are served
    mixed = [rs[0], n + 5, rs[1], rs[2]]
    futs = srv.submit_many("bfs", mixed)
    srv.pump(force=True)
    if not isinstance(futs[1].exception(timeout=0), ValueError):
        raise AssertionError("the malformed root did not fail with a ValueError")
    for r, f in zip(mixed, futs):
        if r != n + 5:
            _settled_lane(f.result(timeout=0), lanes["bfs"][r], "bfs", r)
    # a request whose timeout has passed is dropped before it rides a lane
    before = srv.batches
    f = srv.submit("bfs", rs[3], timeout_s=1e-6)
    time.sleep(0.001)
    srv.pump(force=True)
    if not isinstance(f.exception(timeout=0), TimeoutError) or srv.batches != before:
        raise AssertionError("the expired request was not dropped before execution")
    st = srv.stats()["per_kind"]["bfs"]
    h = srv.health()
    if h["breakers"]["bfs"]["state"] != "closed" or h["device_error"] is not None:
        raise AssertionError(f"bfs breaker {h['breakers']['bfs']['state']}")
    srv.close()
    line = {"phase": "server", "step": "resilience", "widths": list(SERVER_RES_WIDTHS),
            "bisect_batch_ms": bisect_ms, "fault_fired": fired,
            "retry_batches": srv.retry_batches, "retried": st["retried"],
            "poison_isolated": st["poisoned"], "invalid": st["invalid"],
            "timeout": st["timeout"], "breaker": h["breakers"]["bfs"]["state"],
            "all_settled_as_planned": True}
    emit(line)
    return line


def _bfs_batch_ms(srv, roots) -> tuple:
    t = time.perf_counter()
    futs = srv.submit_many("bfs", [int(r) for r in roots])
    res = [f.result(timeout=120) for f in futs]
    return res, (time.perf_counter() - t) * 1e3


def step_server_write(serve: dict, srv, mark: int, roots: np.ndarray, lanes: dict,
                      pair: tuple) -> dict:
    """Step 3: one write through ``submit_update`` (merged incrementally on
    the mutation thread and swapped), a bfs batch timed beside the merge,
    the edge visible, its delete restoring phase 17's lanes."""
    eng = serve["eng"]
    a, b = map(int, pair)
    _, idle_ms = _bfs_batch_ms(srv, roots)
    t = time.perf_counter()
    fut = srv.submit_update([("insert", a, b), ("insert", b, a)])
    res_during, during_ms = _bfs_batch_ms(srv, roots)  # the worker beside the merge
    overlapped = not fut.done()
    ins = fut.result(timeout=120)
    visible_ms = (time.perf_counter() - t) * 1e3
    if ins["mode"] != "incremental":
        raise AssertionError(f"the write merged as {ins['mode']}")
    for r, x in zip(map(int, roots), res_during):  # on v0 or v1, as the swap fell
        if x["levels"][r] != 0:
            raise AssertionError("a bfs served beside the merge lost its root")
    got = srv.submit("bfs", a).result(timeout=120)
    if got["levels"][b] != 1 or got["levels"][a] != 0:
        raise AssertionError("the inserted edge is not visible to a later bfs")
    t = time.perf_counter()
    dele = srv.submit_update([("delete", a, b), ("delete", b, a)]).result(timeout=120)
    delete_ms = (time.perf_counter() - t) * 1e3
    res, after_ms = _bfs_batch_ms(srv, roots)
    for r, x in zip(map(int, roots), res):
        _settled_lane(x, lanes["bfs"][r], "bfs", r)
    if eng.retraces_since(mark):
        raise AssertionError("the write lane built a plan")
    upd = srv.stats()["updates"]
    h = _check_health(srv, "step 3")
    srv.close()
    line = {"phase": "server", "step": "write", "pair": [a, b], "mode": ins["mode"],
            "submit_to_visible_ms": visible_ms, "merge_ms": ins["merge_s"] * 1e3,
            "delete_visible_ms": delete_ms, "delete_merge_ms": dele["merge_s"] * 1e3,
            "bfs_batch_ms_idle": idle_ms, "bfs_batch_ms_beside_merge": during_ms,
            "bfs_batch_done_before_write_visible": overlapped, "bfs_batch_ms_after": after_ms,
            "merges": upd["merges"], "by_mode": upd["by_mode"], "health": h["status"],
            "delete_restores_v0": True, "plan_builds_after_warmup": 0}
    emit(line)
    return line


def step_server_durability(dur: dict) -> dict:
    """Step 4: ``Server.from_recovery`` on phase 17's scale-18 directory
    (2 x 2), bit-exact; 2 write batches, snapshotted by the checkpointer
    (``checkpoint_every=1``, 2 retained, the WAL truncated); ``close``,
    then a second recovery equal to the served version."""
    grid = dur["grid"]
    d = str(DUR_DIR)
    cfg = ServeConfig(lane_widths=(1,), wal_dir=d, checkpoint_every=1, checkpoint_retain=2,
                      update_autostart=False, flight_recorder_dir=str(SERVER_DIR))
    t = time.perf_counter()
    srv = Server.from_recovery(grid, cfg, kinds=DUR_KINDS)
    recover_s = time.perf_counter() - t
    if srv.engine.grid.device.type != "cuda" or not srv.engine.version.E.buckets[0][0].is_cuda:
        raise AssertionError("the recovered version is not on the card")
    _same_version(srv.engine.version, dur["never"], "Server.from_recovery")
    boot = srv.checkpoints
    srv.start()
    merge_ms = []
    t = time.perf_counter()
    for k, (a, b) in enumerate(dur["pairs"]):
        f = srv.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)])
        srv.pump_updates(force=True)
        merge_ms.append(f.result(timeout=120)["merge_s"] * 1e3)
        deadline = time.monotonic() + 30
        while srv.checkpoints < boot + k + 1 and time.monotonic() < deadline:
            time.sleep(0.01)
    with srv._ckpt_lock:  # the count moves before the prune and truncation it holds this lock for
        pass
    writes_s = time.perf_counter() - t
    snaps = checkpoint.list_snapshots(d)
    stats = srv.stats()["durability"]
    if srv.checkpoints != boot + len(dur["pairs"]) or len(snaps) != 2 or srv.checkpoint_failures:
        raise AssertionError(f"checkpoints {srv.checkpoints} (boot {boot}), {len(snaps)} retained, "
                             f"{srv.checkpoint_failures} failed")
    if stats["wal"]["truncated_records"] < DUR_BATCHES:
        raise AssertionError(f"the WAL was not truncated: {stats['wal']}")
    served = srv.engine.version
    snap_mb = os.path.getsize(snaps[-1]) / 2**20
    srv.close()
    t = time.perf_counter()
    again = Server.from_recovery(grid, cfg, kinds=DUR_KINDS)
    recover2_s = time.perf_counter() - t
    _same_version(again.engine.version, served, "the second recovery")
    again.close()
    line = {"phase": "server", "step": "durability", "scale": 18, "grid": "x".join(map(str, DUR_GRID)),
            "recover_s": recover_s, "bootstrap_checkpoints": boot,
            "write_batches": len(dur["pairs"]), "writes_s": writes_s, "merge_ms": merge_ms,
            "checkpoints": boot + len(dur["pairs"]), "retained": len(snaps),
            "snapshot_mb": snap_mb, "wal": stats["wal"], "recover2_s": recover2_s,
            "bit_exact": True}
    emit(line)
    return line


def phase_server(dev, t_start: float, engine: dict, roots: np.ndarray) -> dict:
    """Phase 18 (module docstring): steps 1-4 on phase 17's engine and
    durability directory, with K1's and K2's launch counts set to 0 just
    before and read just after; neither runs."""
    t0 = time.perf_counter()
    emit({"phase": "server", "step": "elapsed", "total_s": t0 - t_start})
    shutil.rmtree(SERVER_DIR, ignore_errors=True)
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t
        return res

    serve, dur = engine["serve"], engine["dur"]
    try:
        one = timed("serve", step_server_serve, serve, roots)
        res = timed("resilience", step_server_resilience, serve, roots, one["lanes"])
        write = timed("write", step_server_write, serve, one["srv"], one["mark"], roots,
                      one["lanes"], engine["churn"]["pairs"][0])
        durable = timed("durability", step_server_durability, dur)
    finally:
        # phase 19 runs its durable fleet on DUR_DIR and removes it
        shutil.rmtree(SERVER_DIR, ignore_errors=True)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the server phase launched hand kernels: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "server", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "phase_s": phase_s, "cap_s": SERVER_CAP_S,
          "within_cap": phase_s <= SERVER_CAP_S, "total_s": time.perf_counter() - t_start})
    if phase_s > SERVER_CAP_S:
        raise AssertionError(f"the server phase took {phase_s:.1f} s, over its {SERVER_CAP_S} s cap")
    return {"serve": one["line"], "resilience": res, "write": write, "durability": durable,
            "k1": {"min_plus": 0, "max_min": 0}}


# --- phase 19: the tenant pool and the replica fleet ----------------------------

FLEET_CAP_S = 75.0  # the phase's time budget
POOL_SEEDS = (5, 6)  # the two scale-18 tenants' R-MAT seeds
POOL_WIDTHS = (1, 2, 4, 8, 16)
POOL_KINDS = ("bfs", "sssp")
POOL_WEIGHTS = {"big": 3.0, "a": 1.0, "b": 1.0}
POOL_QUANTUM = 16  # a round grants big 48 requests, a 16: three 16-lane batches to one
POOL_ROUNDS = 2  # saturated WFQ rounds
POOL_BUDGET_SLACK = 1.05  # the budget: big + one scale-18 tenant + 5%
POOL_FREED_SHARE = 0.9  # memory_allocated must fall by this share of an evicted tenant's bytes
FLEET_REPLICAS = 2
FLEET_CLIENTS = 4
FLEET_BFS_REPEATS = 4  # bfs submits of each of the 16 roots (64), plus 16 sssp
FLEET_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_fleet"


def _lanes_equal(res: dict, want: dict, what: str) -> None:
    for key, arr in want.items():
        if isinstance(arr, np.ndarray) and not np.array_equal(res[key], arr):
            raise AssertionError(f"{what}: {key} differs")


def _absent_churn_pair(rows: np.ndarray, cols: np.ndarray, n: int, avoid=()) -> tuple:
    """A churn pair (``churn_pairs``) of a row-sorted COO, not in ``avoid``."""
    csr = {"indptr": np.searchsorted(rows, np.arange(n + 1)), "cols": cols}
    deg = np.bincount(rows, minlength=n)
    for p in churn_pairs(csr, deg, len(avoid) + 1):
        if tuple(p) not in {tuple(q) for q in avoid}:
            return tuple(int(x) for x in p)
    raise AssertionError("no fresh churn pair")


def _freed_bytes(fn) -> int:
    """Bytes ``memory_allocated`` falls by across ``fn()`` and a
    ``gc.collect()``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fn()
    gc.collect()
    torch.cuda.synchronize()
    return before - torch.cuda.memory_allocated()


def step_fleet_pool(dev, serve: dict) -> dict:
    """Step 1: an ``EnginePool`` on 1 x 1 with phase 17's scale-20 graph
    (``big``, weight 3) and two scale-18 R-MAT graphs (``a``, ``b``) under
    a byte budget that holds big and one of them."""
    from combblas_tpu_torch.utils.rmat import rmat_symmetric_coo_drawn

    eng17 = serve["eng"]
    rows20, cols20, _ = eng17.version.host_coo
    w20 = eng17.version.host_weights
    roots = [int(r) for r in serve["roots"]]
    lanes17 = {k: dict(zip(roots, serve["lanes16"][k])) for k in POOL_KINDS}
    graphs = {}
    for t, seed in zip(("a", "b"), POOL_SEEDS):
        r, c = rmat_symmetric_coo_drawn(seed, MATCH_SCALE, BFS_EDGEFACTOR, device=dev)
        graphs[t] = (r.cpu().numpy(), c.cpu().numpy())
        del r, c
    n18 = 1 << MATCH_SCALE
    cfg = ServeConfig(lane_widths=POOL_WIDTHS, update_autostart=False, update_flush=1,
                      breaker_threshold=1, max_queue=512, max_wait_s=60.0)
    grid = Grid.make(1, 1, device=dev)
    pool = EnginePool(grid)
    psrv = pool.serve(quantum=POOL_QUANTUM)
    admit_s, resident = {}, []

    def add(t):
        t0 = time.perf_counter()
        if t == "big":
            pool.add_tenant("big", rows20, cols20, serve["n"], weights=w20, kinds=POOL_KINDS,
                            weight=POOL_WEIGHTS["big"], config=cfg)
        else:
            r, c = graphs[t]
            pool.add_tenant(t, r, c, n18, weights=np.ones(len(r), np.float32), kinds=POOL_KINDS,
                            weight=POOL_WEIGHTS[t], config=cfg, keep_coo=True)
        torch.cuda.synchronize()
        admit_s[t] = time.perf_counter() - t0
        st = pool.stats()
        resident.append(st["resident_bytes"])
        if st["resident_bytes"] > pool.byte_budget > 0:
            raise AssertionError(f"resident {st['resident_bytes']} past the budget {pool.byte_budget}")

    add("big")
    add("a")
    sizes = {t: s["device_bytes"] for t, s in pool.stats()["tenants"].items()}
    pool.byte_budget = int((sizes["big"] + sizes["a"]) * POOL_BUDGET_SLACK)
    t = time.perf_counter()
    warm = psrv.warmup()
    warm_s = time.perf_counter() - t
    marks = {t: pool.engine(t).trace_mark() for t in ("big", "a")}
    # step 1a: each tenant's lanes; big's equal phase 17's, a's its engine's
    roots18 = [int(x) for x in np.flatnonzero(np.bincount(graphs["a"][0], minlength=n18))[:16]]
    futs = {(t, k): psrv.submit_many(t, k, rs) for t, rs in (("big", roots), ("a", roots18))
            for k in POOL_KINDS}
    while psrv.pump(force=True):
        pass
    for (t, k), fs in futs.items():
        if t == "big":
            for r, f in zip(roots, fs):
                _lanes_equal(f.result(timeout=0), lanes17[k][r], f"pool big {k} root {r}")
        else:
            direct = pool.engine("a").execute(k, np.asarray(roots18, np.int32))
            for i, f in enumerate(fs):
                _lanes_equal(f.result(timeout=0), {key: v[..., i] for key, v in direct.items()
                                                   if isinstance(v, np.ndarray)},
                             f"pool a {k} lane {i}")
    # step 1b: saturated WFQ rounds, 3 : 1
    sat = {"big": roots * (POOL_ROUNDS * 3), "a": roots18 * POOL_ROUNDS}
    recs = []
    t0 = time.monotonic()
    for name, rs in sat.items():
        for f in psrv.submit_many(name, "bfs", rs):
            rec = {"t": name, "t0": t0}
            f.add_done_callback(lambda _f, rec=rec: rec.__setitem__("t1", time.monotonic()))
            recs.append((rec, f))
    served0 = dict(psrv.wfq.describe()["served"])
    t = time.perf_counter()
    for _ in range(POOL_ROUNDS):
        psrv.pump(force=True)
    wfq_s = time.perf_counter() - t
    served = {k: v - served0.get(k, 0) for k, v in psrv.wfq.describe()["served"].items()}
    ratio = served["big"] / max(served["a"], 1)
    if not 2.4 <= ratio <= 3.6:
        raise AssertionError(f"WFQ served {served}, ratio {ratio:.2f}, want 3 : 1")
    while psrv.pump(force=True):
        pass
    for rec, f in recs:
        f.result(timeout=0)
    lat = {name: [(r["t1"] - r["t0"]) * 1e3 for r, _ in recs if r["t"] == name] for name in sat}
    for t, m in marks.items():
        if pool.engine(t).retraces_since(m):
            raise AssertionError(f"pool tenant {t} built a plan after its warm-up")
    # step 1c: a write merged into a; the third tenant's admission evicts a
    rows_a, cols_a = graphs["a"]
    pa, pb = _absent_churn_pair(rows_a, cols_a, n18)
    wf = psrv.submit_update("a", [("insert", pa, pb, 1.0), ("insert", pb, pa, 1.0)])
    while psrv.pump(force=True):
        pass
    wres = wf.result(timeout=0)
    mv = pool.engine("a").version
    merged = (mv.host_coo[0], mv.host_coo[1], mv.host_weights)
    del mv
    pool.engine("big")  # big is warmer than a
    add("b")
    st = pool.stats()["tenants"]
    if st["a"]["resident"] or not st["big"]["resident"] or st["a"]["evictions"] != 1:
        raise AssertionError(f"admitting b did not evict a: {st}")
    # step 1d: b evicted explicitly gives its bytes back to the allocator
    b_bytes = st["b"]["device_bytes"]
    freed = _freed_bytes(lambda: pool.evict("b"))
    if freed < POOL_FREED_SHARE * b_bytes:
        raise AssertionError(f"evicting b freed {freed} of its {b_bytes} device bytes")
    # step 1e: a re-admitted: the write is there, lanes equal a fresh build
    t = time.perf_counter()
    ea = pool.engine("a")
    torch.cuda.synchronize()
    admit_s["a_again"] = time.perf_counter() - t
    resident.append(pool.stats()["resident_bytes"])
    if resident[-1] > pool.byte_budget:
        raise AssertionError("re-admitting a left the pool over its budget")
    got = psrv.submit("a", "bfs", pa)
    while psrv.pump(force=True):
        pass
    got = got.result(timeout=0)
    if got["levels"][pb] != 1:
        raise AssertionError("the write into a did not survive its eviction")
    fresh = GraphEngine.from_coo(grid, merged[0], merged[1], n18, weights=merged[2],
                                 kinds=POOL_KINDS)
    src = np.asarray(roots18[:8] + [pa], np.int32)
    for k in POOL_KINDS:
        x, y = ea.execute(k, src), fresh.execute(k, src)
        _lanes_equal(x, {key: v for key, v in y.items() if isinstance(v, np.ndarray)},
                     f"re-admitted a {k} against a fresh build")
    del fresh
    # step 1f: a fault in a's bfs opens a's breaker only
    psrv.faults("a").when("engine.execute", lambda ctx: ctx.get("kind") == "bfs")
    fa, fb = psrv.submit("a", "bfs", roots18[0]), psrv.submit("big", "bfs", roots[0])
    while psrv.pump(force=True):
        pass
    psrv.faults("a").clear()
    h = psrv.health()
    if (fa.exception(timeout=0) is None or fb.exception(timeout=0) is not None
            or h["breakers"]["a"]["bfs"]["state"] != "open"
            or h["breakers"]["big"]["bfs"]["state"] != "closed" or h["device_error"] is not None):
        raise AssertionError(f"breaker isolation: {h['breakers']}")
    _lanes_equal(fb.result(timeout=0), lanes17["bfs"][roots[0]], "pool big after a's fault")
    stats = pool.stats()
    psrv.close(drain=False)
    line = {"phase": "fleet", "step": "pool", "grid": "1x1", "tenants": {
                "big": {"scale": BFS_SCALE, "nnz": int(len(rows20))},
                "a": {"scale": MATCH_SCALE, "seed": POOL_SEEDS[0]},
                "b": {"scale": MATCH_SCALE, "seed": POOL_SEEDS[1]}},
            "weights": POOL_WEIGHTS, "byte_budget": pool.byte_budget, "device_bytes": sizes,
            "rebuild_s": admit_s, "warmup_s": warm_s, "warmup_lanes": {
                t: len(v) for t, v in warm.items()},
            "wfq_rounds": POOL_ROUNDS, "wfq_served": served, "wfq_ratio": ratio,
            "wfq_s": wfq_s, "requests_per_s": sum(served.values()) / wfq_s,
            "p50_ms": {t: _pct(v, 50) for t, v in lat.items()},
            "p99_ms": {t: _pct(v, 99) for t, v in lat.items()},
            "write": {"pair": [pa, pb], "mode": wres["mode"], "merge_ms": wres["merge_s"] * 1e3},
            "evictions": {t: s["evictions"] for t, s in stats["tenants"].items()},
            "resident_bytes_after_admits": resident, "freed_bytes_b": freed,
            "b_device_bytes": b_bytes, "plan_builds_after_warmup": 0,
            "breakers": {t: h["breakers"][t]["bfs"]["state"] for t in ("big", "a")},
            "lanes_equal": True}
    emit(line)
    return line


def step_fleet_replicas(dev, serve: dict, pair: tuple) -> dict:
    """Step 2: two replicas booted from a ``save_version`` snapshot of
    phase 17's scale-20 engine, reads from 4 clients, one write fanned
    out, a replica killed and replaced from the home's COO."""
    eng17 = serve["eng"]
    roots = [int(r) for r in serve["roots"]]
    lanes17 = {k: dict(zip(roots, serve["lanes16"][k])) for k in POOL_KINDS}
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    path = str(FLEET_DIR / "v.npz")
    t = time.perf_counter()
    checkpoint.save_version(path, eng17.version)
    save_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    cfg = ServeConfig(lane_widths=ENGINE_WIDTHS, max_wait_s=SERVER_MAX_WAIT_S,
                      update_flush=1, update_max_delay_s=0.005, flight_recorder=False)
    grid = Grid.make(1, 1, device=dev)
    t = time.perf_counter()
    fr = FleetRouter.from_checkpoint(path, grid, replicas=FLEET_REPLICAS, config=cfg,
                                     kinds=POOL_KINDS)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t
    try:
        t = time.perf_counter()
        fr.warmup()
        warm_s = time.perf_counter() - t
        marks = [s.engine.trace_mark() for s in fr.replicas]
        plan = [[("bfs", roots)] if k < FLEET_BFS_REPEATS else [] for k in range(FLEET_CLIENTS)]
        plan[0].append(("sssp", roots))
        futs, lock = [], threading.Lock()

        def client(jobs):
            for kind, rs in jobs:
                t0 = time.monotonic()
                fs = fr.submit_many(kind, rs)
                with lock:
                    for r, f in zip(rs, fs):
                        rec = {"kind": kind, "root": r, "t0": t0, "f": f}
                        f.add_done_callback(
                            lambda _f, rec=rec: rec.__setitem__("t1", time.monotonic()))
                        futs.append(rec)

        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=(p,)) for p in plan]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for rec in futs:
            _lanes_equal(rec["f"].result(timeout=120), lanes17[rec["kind"]][rec["root"]],
                         f"fleet {rec['kind']} root {rec['root']}")
        reads_s = time.perf_counter() - t
        if len(futs) != len(roots) * (FLEET_BFS_REPEATS + 1) or min(fr.submitted) == 0:
            raise AssertionError(f"{len(futs)} reads, routed {fr.submitted}")
        for s, m in zip(fr.replicas, marks):
            if s.engine.retraces_since(m):
                raise AssertionError("a replica built a plan after its warm-up")
        lat = {k: [(r["t1"] - r["t0"]) * 1e3 for r in futs if r["kind"] == k] for k in POOL_KINDS}
        # one write: merged home, fanned out to replica 1
        a, b = pair
        t = time.perf_counter()
        res = fr.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)]).result(timeout=120)
        write_s = time.perf_counter() - t
        if res["fanned_out"] != FLEET_REPLICAS - 1 or res["lagging"]:
            raise AssertionError(f"the write fanned out to {res['fanned_out']}, lagging {res['lagging']}")
        for i, s in enumerate(fr.replicas):
            if s.submit("bfs", a).result(timeout=120)["levels"][b] != 1:
                raise AssertionError(f"replica {i} does not show the new edge")
        # replica 1 killed, then replaced from the home's retained COO
        fr.replicas[1].faults.script("replica.death", at=(0,))
        probe = fr.replicas[1].submit("bfs", a)
        deadline = time.monotonic() + 30
        while not fr._dead(1):
            if time.monotonic() > deadline:
                raise AssertionError("replica 1's worker did not die")
            time.sleep(0.005)
        t = time.perf_counter()
        out = fr.supervise_once()
        replace_s = time.perf_counter() - t
        if out["replaced"] != [1] or not isinstance(probe.exception(timeout=10), ReplicaDeadError):
            raise AssertionError(f"supervise_once {out}")
        x = fr.replicas[1].submit_many("bfs", roots[:4] + [a])
        y = fr.replicas[0].submit_many("bfs", roots[:4] + [a])
        for i, (f, g) in enumerate(zip(x, y)):
            _lanes_equal(f.result(timeout=120), g.result(timeout=120), f"replaced lane {i}")
        h = fr.health()
        if h["status"] != "ok" or h["device_error"] is not None:
            raise AssertionError(f"fleet health {h['status']}, device error {h['device_error']}")
        st = fr.stats()
    finally:
        fr.close(drain=False)
    line = {"phase": "fleet", "step": "replicas", "scale": BFS_SCALE, "grid": "1x1",
            "replicas": FLEET_REPLICAS, "kinds": list(POOL_KINDS), "save_s": save_s,
            "from_checkpoint_s": boot_s, "warmup_s": warm_s, "reads": len(futs),
            "clients": FLEET_CLIENTS, "reads_s": reads_s, "requests_per_s": len(futs) / reads_s,
            "p50_ms": {k: _pct(v, 50) for k, v in lat.items()},
            "p99_ms": {k: _pct(v, 99) for k, v in lat.items()},
            "routed": st["routed"], "spillovers": st["spillovers"],
            "write_s": write_s, "merge_ms": res["merge_s"] * 1e3, "mode": res["mode"],
            "fanout_s": write_s - res["merge_s"], "fanned_out": res["fanned_out"],
            "replace_s": replace_s, "supervise": out, "replacements": st["replacements"],
            "fanouts": st["fanouts"], "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "plan_builds_after_warmup": 0, "lanes_equal_phase17": True}
    emit(line)
    return line


def step_fleet_durable(dur: dict) -> dict:
    """Step 3: ``FleetRouter.from_recovery`` on phase 17's scale-18
    directory (2 x 2), one acknowledged write, the home killed:
    ``supervise_once`` promotes the survivor at the WAL frontier and
    rebuilds the dead slot from checkpoint and WAL."""
    grid = dur["grid"]
    cfg = ServeConfig(lane_widths=(1, 2), update_flush=1, update_max_delay_s=0.005,
                      flight_recorder=False)
    t = time.perf_counter()
    fr = FleetRouter.from_recovery(grid, replicas=FLEET_REPLICAS, config=cfg, kinds=DUR_KINDS,
                                   wal_dir=str(DUR_DIR))
    boot_s = time.perf_counter() - t
    try:
        home = fr.replicas[fr.home].engine.version
        rows, cols, _ = home.host_coo
        a, b = _absent_churn_pair(rows, cols, home.nrows, avoid=dur["pairs"])
        t = time.perf_counter()
        res = fr.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)]).result(timeout=120)
        write_s = time.perf_counter() - t
        if res["fanned_out"] != FLEET_REPLICAS - 1:
            raise AssertionError(f"the durable write fanned out to {res['fanned_out']}")
        old = fr.home
        fr.replicas[old].faults.script("replica.death", at=(0,))
        fr.replicas[old].submit("bfs", a)
        deadline = time.monotonic() + 30
        while not fr._dead(old):
            if time.monotonic() > deadline:
                raise AssertionError("the home's worker did not die")
            time.sleep(0.005)
        t = time.perf_counter()
        out = fr.supervise_once()
        heal_s = time.perf_counter() - t
        if out["promoted"] is None or fr.home == old or out["replaced"] != [old]:
            raise AssertionError(f"supervise_once {out}")
        for i, s in enumerate(fr.replicas):
            if s.submit("bfs", a).result(timeout=120)["levels"][b] != 1:
                raise AssertionError(f"replica {i} lost the acknowledged write")
        _same_version(fr.replicas[old].engine.version, fr.replicas[fr.home].engine.version,
                      "the rebuilt slot against the promoted home")
        h = fr.health()
        if h["status"] != "ok" or not h["durable"]:
            raise AssertionError(f"durable fleet health {h['status']}")
        promoted = fr.home
    finally:
        fr.close(drain=False)
    line = {"phase": "fleet", "step": "durable", "scale": 18, "grid": "x".join(map(str, DUR_GRID)),
            "replicas": FLEET_REPLICAS, "from_recovery_s": boot_s, "write_s": write_s,
            "merge_ms": res["merge_s"] * 1e3, "mode": res["mode"],
            "promote_and_replace_s": heal_s, "supervise": out, "new_home": promoted,
            "write_visible_everywhere": True, "rebuilt_equal_home": True}
    emit(line)
    return line


def phase_fleet(dev, t_start: float, engine: dict, roots: np.ndarray) -> dict:
    """Phase 19 (module docstring): steps 1-3 on phase 17's engine and
    durability directory, with K1's and K2's launch counts set to 0 just
    before and read just after; neither runs. Removes the directory."""
    t0 = time.perf_counter()
    emit({"phase": "fleet", "step": "elapsed", "total_s": t0 - t_start})
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    step_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        step_s[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
        return res

    serve = {**engine["serve"], "roots": roots}
    pair = engine["churn"]["pairs"][-1]
    try:
        pool = timed("pool", step_fleet_pool, dev, serve)
        replicas = timed("replicas", step_fleet_replicas, dev, serve, pair)
        durable = timed("durable", step_fleet_durable, engine["dur"])
    finally:
        for d in (DUR_DIR, FLEET_DIR):
            shutil.rmtree(d, ignore_errors=True)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the fleet phase launched hand kernels: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "fleet", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "phase_s": phase_s, "cap_s": FLEET_CAP_S,
          "within_cap": phase_s <= FLEET_CAP_S, "total_s": time.perf_counter() - t_start})
    if phase_s > FLEET_CAP_S:
        raise AssertionError(f"the fleet phase took {phase_s:.1f} s, over its {FLEET_CAP_S} s cap")
    return {"pool": pool, "replicas": replicas, "durable": durable,
            "k1": {"min_plus": 0, "max_min": 0}}


# --- phase 20: the process fleet ---------------------------------------------

PROCFLEET_CAP_S = 90.0  # the phase's time budget
PROCFLEET_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_procfleet"
# phase 10's graph: the children's snapshot cut from phase 19's scale 20,
# whose 1.17 GB loads, spool and swap took the phase to 89-96 s of its
# cap (PERF.md §4)
PROCFLEET_SCALE = 18
# half the reference's 5 s default: the largest heartbeat age seen in
# three runs of this phase on the card was 0.58 s (PERF.md §6, PR 19)
PROCFLEET_HB_TIMEOUT_S = 2.5
PROCFLEET_FREED_SHARE = 0.9  # free bytes must rise by this share of a killed child's device_bytes
# 24 bfs + 8 sssp reads, 6 + 2 a client: phase 19's 80 (64 bfs + 16 sssp)
# cut to 32 in the same 4 : 1 mix, to keep the phase inside its cap
# (PERF.md §4, PR 19)
PROCFLEET_READS_PER_CLIENT = {"bfs": 6, "sssp": 2}


class HeartbeatWatch:
    """The largest heartbeat age seen for each replica slot, sampled every
    20 ms on a thread of its own; a slot under a scripted fault is paused
    (its process is dead or stopped on purpose) until its respawn."""

    def __init__(self, fr):
        self.fr, self.max_age, self.paused = fr, {}, set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.02):
            for i, rp in enumerate(list(self.fr.replicas)):
                if i not in self.paused and not rp.quarantined:
                    self.max_age[i] = max(self.max_age.get(i, 0.0), rp.heartbeat_age())

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(10)
        return {str(i): a for i, a in sorted(self.max_age.items())}


def _timed_calls(rp, log: dict) -> None:
    """Accumulate the seconds of ``rp``'s synchronous RPCs in ``log`` by op."""
    call = rp.call

    def timed(op, *a, **k):
        t = time.perf_counter()
        try:
            return call(op, *a, **k)
        finally:
            log[op] = log.get(op, 0.0) + time.perf_counter() - t

    rp.call = timed


def _timed_method(fr, name: str, log: dict) -> None:
    """Accumulate the seconds of ``fr.<name>`` calls in ``log[name]``."""
    fn = getattr(fr, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            log[name] = log.get(name, 0.0) + time.perf_counter() - t

    setattr(fr, name, timed)


def _mem_info() -> tuple:
    """The card's (free, total) bytes: each child's context and graph
    count there, and nowhere in this process's ``memory_allocated``."""
    return torch.cuda.mem_get_info()


def _free_bytes() -> int:
    return _mem_info()[0]


def _same_replica_lanes(fr, i: int, j: int, roots: list, what: str) -> None:
    x = [fr.replicas[i].submit("bfs", r) for r in roots]
    y = [fr.replicas[j].submit("bfs", r) for r in roots]
    for k, (f, g) in enumerate(zip(x, y)):
        _lanes_equal(f.result(timeout=120), g.result(timeout=120), f"{what} lane {k}")


def procfleet_snapshot(dev, g18: dict, path: Path) -> dict:
    """The children's snapshot: an unsharded engine (bfs, sssp) on phase
    10's scale-18 graph with phase 17's weight draw, saved with
    ``save_version``; its lanes for the graph's first 16 roots with an
    edge are what the children's reads are held to."""
    rows, cols = g18["rows"].astype(np.int64), g18["cols"].astype(np.int64)
    n = len(g18["deg"])
    w = np.random.default_rng(WEIGHT_SEED).integers(1, 16, len(rows)).astype(np.float32)
    src = np.flatnonzero(g18["deg"] > 0)[:ENGINE_ROOTS].astype(np.int32)
    # the COO travels in the snapshot: a child's WAL lane merges on it
    eng = GraphEngine.from_coo(Grid.make(1, 1, device=dev), rows, cols, n, weights=w,
                               kinds=POOL_KINDS, keep_coo=True)
    lanes = {}
    for kind, keys in (("bfs", ("parents", "levels")), ("sssp", ("dist",))):
        res = eng.execute(kind, src)
        lanes[kind] = {int(r): {key: np.ascontiguousarray(res[key][..., k]) for key in keys}
                       for k, r in enumerate(src)}
    checkpoint.save_version(str(path), eng.version)
    nbytes = eng.version.device_bytes()
    del eng
    torch.cuda.empty_cache()
    return {"roots": [int(r) for r in src], "lanes": lanes, "n": n, "nnz": len(rows),
            "device_bytes": nbytes}


def step_procfleet_reads(fr, lanes: dict, roots: list) -> dict:
    """Step 1 after the boot: 24 bfs and 8 sssp reads from 4 client
    threads over IPC (phase 19's mix), equal to the snapshot engine's
    lanes, both replicas routed to, no plan built after the children's
    warm-up."""
    marks = fr.trace_marks()
    plan = [[(kind, [roots[(k * n + j) % len(roots)] for j in range(n)])
             for kind, n in PROCFLEET_READS_PER_CLIENT.items()]
            for k in range(FLEET_CLIENTS)]
    futs, lock = [], threading.Lock()

    def client(jobs):
        for kind, rs in jobs:
            t0 = time.monotonic()
            fs = fr.submit_many(kind, rs)
            with lock:
                for r, f in zip(rs, fs):
                    rec = {"kind": kind, "root": r, "t0": t0, "f": f}
                    f.add_done_callback(lambda _f, rec=rec: rec.__setitem__("t1", time.monotonic()))
                    futs.append(rec)

    t = time.perf_counter()
    threads = [threading.Thread(target=client, args=(p,)) for p in plan]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for rec in futs:
        _lanes_equal(rec["f"].result(timeout=120), lanes[rec["kind"]][rec["root"]],
                     f"procfleet {rec['kind']} root {rec['root']}")
    reads_s = time.perf_counter() - t
    if len(futs) != FLEET_CLIENTS * sum(PROCFLEET_READS_PER_CLIENT.values()) or min(fr.submitted) == 0:
        raise AssertionError(f"{len(futs)} reads, routed {fr.submitted}")
    builds = fr.retraces_since(marks)
    if builds:
        raise AssertionError(f"the children built {builds} plans after their warm-up")
    lat = {k: [(r["t1"] - r["t0"]) * 1e3 for r in futs if r["kind"] == k] for k in POOL_KINDS}
    return {"reads": len(futs), "clients": FLEET_CLIENTS, "reads_s": reads_s,
            "requests_per_s": len(futs) / reads_s, "routed": list(fr.submitted),
            "p50_ms": {k: _pct(v, 50) for k, v in lat.items()},
            "p99_ms": {k: _pct(v, 99) for k, v in lat.items()}, "plan_builds_after_warmup": 0}


def step_procfleet_write(fr, pair: tuple, rpc_s: dict) -> dict:
    """Step 2: one insert through ``submit_update``: the home merges and
    logs it, spools ``save_version``, replica 1 swaps from the file."""
    a, b = pair
    for rp in fr.replicas:
        _timed_calls(rp, rpc_s)
    t = time.perf_counter()
    res = fr.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)]).result(timeout=180)
    write_s = time.perf_counter() - t
    if res["fanned_out"] != 1 or res["lagging"]:
        raise AssertionError(f"the write fanned out to {res['fanned_out']}, lagging {res['lagging']}")
    for i, rp in enumerate(fr.replicas):
        if rp.submit("bfs", a).result(timeout=120)["levels"][b] != 1:
            raise AssertionError(f"replica {i} does not show the new edge")
    return {"write_s": write_s, "merge_s": res["merge_s"], "mode": res["mode"],
            "spool_s": rpc_s.get("spool_version"), "swap_s": rpc_s.get("swap_from_checkpoint"),
            "fanned_out": res["fanned_out"]}


def step_procfleet_kill(fr, hb: HeartbeatWatch, pair: tuple, roots: list, heal_s: dict) -> dict:
    """Step 3: replica 1 SIGKILLed through the router's fault plan; its
    device memory comes back to the card; ``supervise_once`` respawns it
    from checkpoint and WAL, and it answers as the home does."""
    a, b = pair
    nbytes = fr.replicas[1].boot["device_bytes"]
    hb.paused.add(1)
    free_before = _free_bytes()
    fr.proc_faults.sigkill(fr.proc_faults.calls, replica=1)
    probe = fr.submit("bfs", roots[0])  # fires the kill, then routes
    deadline = time.monotonic() + 30
    while not fr._dead(1):
        if time.monotonic() > deadline:
            raise AssertionError("the SIGKILLed replica was not seen dead")
        time.sleep(0.005)
    freed = 0
    deadline = time.monotonic() + 10
    while freed < PROCFLEET_FREED_SHARE * nbytes and time.monotonic() < deadline:
        freed = _free_bytes() - free_before
        time.sleep(0.05)
    if freed < PROCFLEET_FREED_SHARE * nbytes:
        raise AssertionError(f"the kill freed {freed} bytes of the card, its child held {nbytes}")
    t = time.perf_counter()
    out = fr.supervise_once()
    respawn_s = time.perf_counter() - t
    heal_s["kill_supervise"] = respawn_s
    if out != {"detected": [1], "promoted": None, "replaced": [1]}:
        raise AssertionError(f"supervise_once after the kill: {out}")
    child_boot_s = fr.replicas[1].boot["boot_s"]
    hb.paused.discard(1)
    want = fr.replicas[0].submit("bfs", roots[0]).result(timeout=120)
    _lanes_equal(probe.result(timeout=120), want, "the read routed at the kill")
    if fr.replicas[1].submit("bfs", a).result(timeout=120)["levels"][b] != 1:
        raise AssertionError("the respawned replica lost the acknowledged write")
    _same_replica_lanes(fr, 1, 0, roots[:4] + [a], "respawned")
    return {"device_bytes": nbytes, "freed_bytes": freed, "freed_share": freed / nbytes,
            "respawn_s": respawn_s, "child_boot_s": child_boot_s, "supervise": out,
            "probe_settled": True}


def step_procfleet_hang(fr, hb: HeartbeatWatch, pair: tuple, roots: list, heal_s: dict) -> dict:
    """Step 4: the home SIGSTOPped through the router's fault plan; the
    heartbeat timeout detects it, ``supervise_once`` promotes replica 1
    at the WAL frontier over IPC and respawns the stopped slot."""
    a, b = pair
    old = fr.home
    hb.paused.add(old)
    _timed_method(fr, "promote", heal_s)
    _timed_method(fr, "_spawn", heal_s)
    fr.proc_faults.sigstop(fr.proc_faults.calls, replica="home")
    t = time.perf_counter()
    probe = fr.submit("bfs", roots[1])
    deadline = time.monotonic() + 30
    while not fr._dead(old):
        if time.monotonic() > deadline:
            raise AssertionError("the stopped home was not seen dead")
        time.sleep(0.005)
    detect_s = time.perf_counter() - t
    t = time.perf_counter()
    out = fr.supervise_once()
    supervise_s = time.perf_counter() - t
    if out["detected"] != [old] or out["promoted"] is None or out["replaced"] != [old]:
        raise AssertionError(f"supervise_once after the hang: {out}")
    hb.paused.discard(old)
    new = fr.home
    if new == old or fr.replicas[new].submit("bfs", a).result(timeout=120)["levels"][b] != 1:
        raise AssertionError("the promoted home lost the acknowledged write")
    want = fr.replicas[new].submit("bfs", roots[1]).result(timeout=120)
    _lanes_equal(probe.result(timeout=120), want, "the read routed at the hang")
    _same_replica_lanes(fr, old, new, roots[:4] + [a], "respawned home slot")
    st, h = fr.stats(), fr.health()
    if (st["promotions"], st["replacements"], st["sigkills"], st["sigstops"]) != (1, 2, 1, 1):
        raise AssertionError(f"fleet stats {st}")
    if h["status"] != "ok" or h["device_error"] is not None:
        raise AssertionError(f"fleet health {h['status']}")
    return {"detect_s": detect_s, "supervise_s": supervise_s, "promote_s": heal_s.get("promote"),
            "respawn_s": heal_s.get("_spawn"), "child_boot_s": fr.replicas[old].boot["boot_s"],
            "supervise": out, "new_home": new,
            "write_visible_on_new_home": True}


def phase_procfleet(dev, t_start: float, g18: dict, pair: tuple,
                    thread_fleet_rps: float) -> dict:
    """Phase 20 (module docstring): the process fleet on a snapshot of
    phase 10's scale-18 graph, with K1's and K2's launch counts (the
    parent's) set to 0 just before and read just after; neither runs.
    ``pair`` is an edge absent from the graph. Removes its directory."""
    t0 = time.perf_counter()
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    emit({"phase": "procfleet", "step": "elapsed", "total_s": t0 - t_start})
    shutil.rmtree(PROCFLEET_DIR, ignore_errors=True)
    PROCFLEET_DIR.mkdir(parents=True)
    step_s = {}
    t = time.perf_counter()
    snap = procfleet_snapshot(dev, g18, PROCFLEET_DIR / "v.npz")
    step_s["snapshot"] = time.perf_counter() - t
    roots = snap["roots"]
    free0, total = _mem_info()
    emit({"phase": "procfleet", "step": "snapshot", "scale": PROCFLEET_SCALE, "n": snap["n"],
          "nnz": snap["nnz"], "device_bytes": snap["device_bytes"], "snapshot_s": step_s["snapshot"],
          "card_free_gb": free0 / 2**30, "card_total_gb": total / 2**30})
    cfg = ServeConfig(lane_widths=ENGINE_WIDTHS, max_wait_s=SERVER_MAX_WAIT_S,
                      update_flush=1, update_max_delay_s=0.005, flight_recorder=False)
    rpc_s, heal_s = {}, {}
    try:
        t = time.perf_counter()
        fr = ProcessFleet.from_checkpoint(
            str(PROCFLEET_DIR / "v.npz"), (1, 1), replicas=FLEET_REPLICAS, kinds=POOL_KINDS,
            config=cfg, wal_dir=str(PROCFLEET_DIR / "wal"), workdir=str(PROCFLEET_DIR / "work"),
            device=dev, hb_timeout_s=PROCFLEET_HB_TIMEOUT_S)
        boot_s = time.perf_counter() - t
        hb = HeartbeatWatch(fr)
        try:
            free_boot = _free_bytes()
            devices = [rp.boot["device"] for rp in fr.replicas]
            if any(torch.device(d).type != torch.device(dev).type for d in devices):
                raise AssertionError(f"children on {devices}")
            reads = step_procfleet_reads(fr, snap["lanes"], roots)
            step_s["boot_and_reads"] = time.perf_counter() - t
            emit({"phase": "procfleet", "step": "reads", "scale": PROCFLEET_SCALE, "grid": "1x1",
                  "replicas": FLEET_REPLICAS, "kinds": list(POOL_KINDS), "boot_s": boot_s,
                  "children": devices, "device_bytes": [rp.boot["device_bytes"] for rp in fr.replicas],
                  "child_boot_s": [rp.boot["boot_s"] for rp in fr.replicas],
                  "card_free_gb_after_boot": free_boot / 2**30,
                  "card_gb_taken_by_children": (free0 - free_boot) / 2**30, **reads,
                  "thread_fleet_scale20_requests_per_s": thread_fleet_rps,
                  "lanes_equal_snapshot_engine": True})
            t = time.perf_counter()
            write = step_procfleet_write(fr, pair, rpc_s)
            step_s["write"] = time.perf_counter() - t
            emit({"phase": "procfleet", "step": "write", **write})
            t = time.perf_counter()
            kill = step_procfleet_kill(fr, hb, pair, roots, heal_s)
            step_s["kill"] = time.perf_counter() - t
            emit({"phase": "procfleet", "step": "kill", **kill})
            t = time.perf_counter()
            hang = step_procfleet_hang(fr, hb, pair, roots, heal_s)
            step_s["hang"] = time.perf_counter() - t
            emit({"phase": "procfleet", "step": "hang", **hang})
        finally:
            max_age = hb.stop()
            fr.close(drain=False)
    except Exception:
        # the children's own output, for the failure's cause
        for log in sorted((PROCFLEET_DIR / "work").glob("replica*.log")):
            print(f"--- {log.name} (tail)\n{log.read_text(errors='replace')[-3000:]}",
                  file=sys.stderr)
        raise
    finally:
        shutil.rmtree(PROCFLEET_DIR, ignore_errors=True)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the procfleet phase launched hand kernels: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "procfleet", "step": "checks", "hand_kernel_launches_parent": launches,
          "max_heartbeat_age_s": max_age, "hb_timeout_s": PROCFLEET_HB_TIMEOUT_S,
          "step_s": step_s, "phase_s": phase_s, "cap_s": PROCFLEET_CAP_S,
          "within_cap": phase_s <= PROCFLEET_CAP_S, "total_s": time.perf_counter() - t_start})
    if phase_s > PROCFLEET_CAP_S:
        raise AssertionError(
            f"the procfleet phase took {phase_s:.1f} s, over its {PROCFLEET_CAP_S} s cap")
    return {"reads": reads, "write": write, "kill": kill, "hang": hang,
            "k1": {"min_plus": 0, "max_min": 0}}


# --- phase 21: sharded serving --------------------------------------------------

SHARD_CAP_S = 90.0  # the phase's time budget
SHARD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_shard"
SHARD_SLICES = 2
SHARD_KINDS = ("bfs", "sssp", "propagate")
SHARD_MODES = ("dense", "sparse")  # forced encodings, beside step 1's auto
SHARD_READS = {"bfs": 13, "sssp": 3}  # 16 reads, 4 : 1 as near as 16 allows
SHARD_PROC_SCALE = 18  # the process step's cut (PERF.md §4)
SHARD_PROC_ROOTS = 16
# propagate: float32 sums of 2-hop path counts in another order
SHARD_FEAT_RTOL = 1e-4


def _same_batch(res: dict, lanes: list, keys: tuple, what: str) -> None:
    """Raise unless each lane of ``res`` equals the phase 17 lane bit for bit
    (and ``batch_niter`` equals phase 17's)."""
    for k, want in enumerate(lanes):
        for key in keys:
            got = np.ascontiguousarray(res[key][..., k])
            if got.dtype != want[key].dtype or got.tobytes() != want[key].tobytes():
                raise AssertionError(f"{what}: lane {k} {key} differs from phase 17")
        if int(res["batch_niter"]) != int(want["batch_niter"]):
            raise AssertionError(f"{what}: batch_niter {res['batch_niter']} against "
                                 f"phase 17's {want['batch_niter']}")


def _wire(st: dict) -> dict:
    return {"hops": st["hops"], "enc_hops": dict(st["enc_hops"]),
            "bytes_by_enc": dict(st["bytes_by_enc"]), "frontier_nnz": list(st["frontier_nnz"]),
            "bytes_out": st["bytes_out"], "bytes_in": st["bytes_in"],
            "hop_wall_s": st["hop_wall_s"]}


def step_shard_local(dev, p21: dict) -> dict:
    """Step 1: the 2-slice local engine at scale 20, held against phase
    17's lanes, under the auto, dense and sparse frontier encodings."""
    t = time.perf_counter()
    rows, cols, n = _engine_coo(p21["csr_host"])
    w = np.random.default_rng(WEIGHT_SEED).integers(1, 16, len(rows)).astype(np.float32)
    X = np.random.default_rng(SPMM_SEED).standard_normal((n, SPMM_F)).astype(np.float32)
    inputs_s = time.perf_counter() - t
    t = time.perf_counter()
    sh = ShardedEngine.build(rows, cols, nrows=n, nslices=SHARD_SLICES, weights=w, features=X,
                             kinds=SHARD_KINDS, symmetric=True, home=str(SHARD_DIR / "local"),
                             mode="local", device=dev, warmup_widths=ENGINE_WIDTHS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t  # with each slice's warm-up (a respawn warms too)
    del w, X
    plans = sh.stats()["plans"]
    mark = sh.trace_mark()
    lanes = p21["lanes16"]
    src = np.asarray(p21["roots"], np.int32)
    ms, wire = {}, {}
    for kind in SHARD_KINDS:
        res, sec = host_timed(lambda: sh.execute(kind, src))
        ms[f"{kind}/auto"] = sec * 1e3
        if kind == "propagate":
            want = np.stack([lane["features"] for lane in lanes[kind]], axis=-1)
            err = float(np.abs(res["features"] - want).max())
            scale = float(np.abs(want).max())
            if not np.allclose(res["features"], want, rtol=SHARD_FEAT_RTOL,
                               atol=SHARD_FEAT_RTOL * scale):
                raise AssertionError(f"sharded propagate off phase 17's by {err} (max {scale})")
            feat_err = {"max_abs_err": err, "max_abs": scale}
        else:
            keys = ("parents", "levels") if kind == "bfs" else ("dist",)
            _same_batch(res, lanes[kind], keys, f"sharded {kind} (auto)")
            wire[f"{kind}/auto"] = _wire(sh.last_exec_stats)
    for mode in SHARD_MODES:
        sh.frontier_mode = mode
        for kind, keys in (("bfs", ("parents", "levels")), ("sssp", ("dist",))):
            res, sec = host_timed(lambda: sh.execute(kind, src))
            ms[f"{kind}/{mode}"] = sec * 1e3
            _same_batch(res, lanes[kind], keys, f"sharded {kind} ({mode})")
            st = sh.last_exec_stats
            if set(st["enc_hops"]) != {mode}:
                raise AssertionError(f"forced {mode}: hops went {st['enc_hops']}")
            wire[f"{kind}/{mode}"] = _wire(st)
    sh.frontier_mode = "auto"
    if sh.retraces_since(mark):
        raise AssertionError("the sharded engine built a plan after its warm-up")
    for kind in ("bfs", "sssp"):
        sparse = wire[f"{kind}/sparse"]["bytes_by_enc"]["sparse"]
        dense = wire[f"{kind}/dense"]["bytes_by_enc"]["dense"]
        if not sparse < dense:
            raise AssertionError(f"{kind}: sparse hop bytes {sparse} not below dense {dense}")
    per_slice = list(sh.version.device_bytes_per_slice)
    line = {"phase": "shard", "step": "local", "scale": BFS_SCALE, "n": n, "nnz": sh.version.nnz,
            "slices": SHARD_SLICES, "bounds": [list(b) for b in sh.spec.bounds],
            "kinds": list(SHARD_KINDS), "F": SPMM_F, "inputs_s": inputs_s, "build_s": build_s,
            "plans_warmed": len(plans), "device_bytes_per_slice": per_slice,
            "device_bytes_unsharded_phase17": p21["device_bytes17"],
            "slice_over_unsharded": max(per_slice) / p21["device_bytes17"],
            "W": len(src), "ms_per_batch": ms, "propagate": feat_err, "wire": wire,
            "lanes_equal_phase17": True, "plan_builds_after_warmup": 0}
    emit(line)
    return {"sh": sh, "line": line}


def step_shard_server(sh, p21: dict) -> dict:
    """Step 2: a Server over the local engine: reads, one write, the
    delegated checkpoint, a killed slice healed by a replay."""
    roots = [int(r) for r in p21["roots"]]
    lanes = {k: dict(zip(roots, p21["lanes16"][k])) for k in POOL_KINDS}
    srv = sh.serve(ServeConfig(lane_widths=ENGINE_WIDTHS, max_wait_s=SERVER_MAX_WAIT_S,
                               update_flush=1, update_max_delay_s=0.005,
                               flight_recorder=False))
    srv.start()
    try:
        if not srv.durable:
            raise AssertionError("a Server over a sharded engine is not durable")
        mark = sh.trace_mark()
        t = time.perf_counter()
        futs = [(kind, r, f) for kind, k in SHARD_READS.items()
                for r, f in zip(roots[:k], srv.submit_many(kind, roots[:k]))]
        for kind, r, f in futs:
            _lanes_equal(f.result(timeout=120), lanes[kind][r], f"served sharded {kind} root {r}")
        reads_s = time.perf_counter() - t
        a, b = p21["pair"]
        t = time.perf_counter()
        res = srv.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)]).result(timeout=120)
        write_s = time.perf_counter() - t
        if sh.version.frontier != [1] * SHARD_SLICES or res["ops"] != 2:
            raise AssertionError(f"after the write: frontier {sh.version.frontier}, {res}")
        owners = [sh.spec.owner_of(a), sh.spec.owner_of(b)]
        for x, y in ((a, b), (b, a)):
            if srv.submit("bfs", x).result(timeout=120)["levels"][y] != 1:
                raise AssertionError(f"the inserted edge {x} -> {y} is not one hop away")
        t = time.perf_counter()
        ck = srv.checkpoint_now(reason="phase21")
        checkpoint_s = time.perf_counter() - t
        if ck is None or ck["frontier"] != [1] * SHARD_SLICES or len(ck["slices"]) != SHARD_SLICES:
            raise AssertionError(f"the delegated checkpoint: {ck}")
        before = srv.submit("bfs", roots[0]).result(timeout=120)
        survivor = sh.slices[1]
        sh.slices[0].kill()
        t = time.perf_counter()
        after = srv.submit("bfs", roots[0]).result(timeout=120)
        heal_s = time.perf_counter() - t
        _lanes_equal(after, before, "the read healed by a replay")
        if sh.replacements != 1 or sh.slices[1] is not survivor:
            raise AssertionError(f"replacements {sh.replacements}, slice 1 replaced")
        if sh.retraces_since(mark):
            raise AssertionError("the served sharded engine built a plan after its warm-up")
        h = srv.health()
        if h["status"] != "ok" or h["device_error"] is not None:
            raise AssertionError(f"server health {h['status']}")
    finally:
        srv.close(drain=False)
    return {"reads": len(futs), "mix": dict(SHARD_READS), "reads_s": reads_s,
            "requests_per_s": len(futs) / reads_s, "write_s": write_s,
            "merge_s": res["merge_s"], "frontier": list(sh.version.frontier),
            "pair_owners": owners, "checkpoint_s": checkpoint_s,
            "checkpoint_seq": [s_["wal_seq"] for s_ in ck["slices"].values()],
            "heal_read_s": heal_s, "replacements": sh.replacements, "survivor_untouched": True}


def step_shard_process(dev, p21: dict) -> dict:
    """Step 3: two slice processes on the card at scale 18 against an
    unsharded engine; SIGKILL, replay, a write, and a local recovery of
    the same home."""
    g18 = p21["g18"]
    rows, cols = g18["rows"].astype(np.int64), g18["cols"].astype(np.int64)
    n = len(g18["deg"])
    w = np.random.default_rng(WEIGHT_SEED).integers(1, 16, len(rows)).astype(np.float32)
    kinds = POOL_KINDS
    src = np.flatnonzero(g18["deg"] > 0)[:SHARD_PROC_ROOTS].astype(np.int32)
    home = SHARD_DIR / "proc"
    out = {}
    t = time.perf_counter()
    eng = GraphEngine.from_coo(Grid.make(1, 1, device=dev), rows, cols, n, weights=w,
                               kinds=kinds)
    want = {k: eng.execute(k, src) for k in kinds}
    out["unsharded_s"] = time.perf_counter() - t
    unsharded_bytes = eng.version.device_bytes()
    del eng
    torch.cuda.empty_cache()
    free0 = _free_bytes()
    t = time.perf_counter()
    sh = ShardedEngine.build(rows, cols, nrows=n, nslices=SHARD_SLICES, weights=w, kinds=kinds,
                             home=str(home), mode="process", device=dev,
                             warmup_widths=(SHARD_PROC_ROOTS,))
    out["boot_s"] = time.perf_counter() - t
    try:
        out["child_boot_s"] = [sl.boot_info["boot_s"] for sl in sh.slices]
        out["children"] = [sl.boot_info["device"] for sl in sh.slices]
        out["device_bytes_per_slice"] = [sl.boot_info["device_bytes"] for sl in sh.slices]
        out["device_bytes_unsharded"] = unsharded_bytes
        out["card_gb_taken_by_children"] = (free0 - _free_bytes()) / 2**30
        mark = sh.trace_mark()
        ms = {}
        for kind in kinds:
            got, sec = host_timed(lambda: sh.execute(kind, src))
            ms[kind] = sec * 1e3
            same_result_bits(got, want[kind], f"process-mode {kind}")
        out["ms_per_batch"] = ms
        nbytes = sh.slices[0].boot_info["device_bytes"]
        torch.cuda.empty_cache()
        free_before = _free_bytes()
        sh.slices[0].kill()
        freed = 0
        deadline = time.monotonic() + 10
        while freed < PROCFLEET_FREED_SHARE * nbytes and time.monotonic() < deadline:
            freed = _free_bytes() - free_before
            time.sleep(0.05)
        if freed < PROCFLEET_FREED_SHARE * nbytes:
            raise AssertionError(f"the kill freed {freed} bytes of the card, the slice held {nbytes}")
        t = time.perf_counter()
        got = sh.execute("bfs", src)
        out["replay_s"] = time.perf_counter() - t
        same_result_bits(got, want["bfs"], "the replayed bfs batch")
        if sh.replacements != 1 or sh.retraces_since(mark):
            raise AssertionError(f"replacements {sh.replacements}, plans built "
                                 f"{sh.retraces_since(mark)}")
        out["respawned_child_boot_s"] = sh.slices[0].boot_info["boot_s"]
        out["freed_bytes"], out["freed_share"] = freed, freed / nbytes
        a, b = p21["pair18"]
        batch = DeltaBatch.from_ops([("insert", a, b, 1.0), ("insert", b, a, 1.0)], start_seq=0)
        t = time.perf_counter()
        v = sh.apply_delta(batch)
        sh.swap(v)
        out["write_s"] = time.perf_counter() - t
        if v.frontier != [1] * SHARD_SLICES:
            raise AssertionError(f"the two-phase write left the frontier at {v.frontier}")
        coo = sh.to_host_coo()
    finally:
        sh.close()
    t = time.perf_counter()
    rec = ShardedEngine.recover(str(home), mode="local", device=dev)
    try:
        out["recover_local_s"] = time.perf_counter() - t
        got = rec.to_host_coo()
        if not all(np.array_equal(x, y) for x, y in zip(got[:2], coo[:2])) or not np.array_equal(
                got[2], coo[2]):
            raise AssertionError("the local recovery's COO differs from the process engine's")
        out["recovered_frontier"] = list(rec.version.frontier)
    finally:
        rec.close()
    out["scale"], out["n"], out["nnz"] = SHARD_PROC_SCALE, n, int(len(coo[0]))
    return out


def same_result_bits(got: dict, want: dict, what: str) -> None:
    for key, arr in want.items():
        if isinstance(arr, np.ndarray):
            if got[key].dtype != arr.dtype or got[key].tobytes() != arr.tobytes():
                raise AssertionError(f"{what}: {key} differs from the unsharded engine")
        elif int(got[key]) != int(arr):
            raise AssertionError(f"{what}: {key} {got[key]} against {arr}")


def shard_inputs(p17: dict, engine: dict, csr_host: dict, g18: dict) -> dict:
    """What phase 21 takes from phases 8, 10 and 17, on the host: the
    scale-20 CSR arrays, the scale-18 COO, phase 17's roots, lanes and
    unsharded ``device_bytes``, its churn pair and one of the scale-18
    graph."""
    r18, c18 = g18["rows"].astype(np.int64), g18["cols"].astype(np.int64)
    return {"roots": p17["roots"], "lanes16": p17["lanes16"], "pair": p17["pair"],
            "csr_host": csr_host, "g18": g18,
            "device_bytes17": engine["serve"]["line"]["device_bytes"],
            "pair18": _absent_churn_pair(r18, c18, len(g18["deg"]))}


def phase_shard(dev, t_start: float, p21: dict) -> dict:
    """Phase 21 (module docstring): sharded serving, with K1's and K2's
    launch counts set to 0 just before and read just after; neither runs.
    Removes its home."""
    t0 = time.perf_counter()
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    emit({"phase": "shard", "step": "elapsed", "total_s": t0 - t_start})
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    step_s = {}
    try:
        t = time.perf_counter()
        local = step_shard_local(dev, p21)
        step_s["local"] = time.perf_counter() - t
        sh = local["sh"]
        try:
            t = time.perf_counter()
            served = step_shard_server(sh, p21)
            step_s["server"] = time.perf_counter() - t
            emit({"phase": "shard", "step": "server", **served})
        finally:
            sh.close()
        del sh, local["sh"]
        torch.cuda.empty_cache()
        t = time.perf_counter()
        proc = step_shard_process(dev, p21)
        step_s["process"] = time.perf_counter() - t
        emit({"phase": "shard", "step": "process", **proc})
    except Exception:
        for log in sorted((SHARD_DIR / "proc").glob("slice*.log")):
            print(f"--- {log.name} (tail)\n{log.read_text(errors='replace')[-3000:]}",
                  file=sys.stderr)
        raise
    finally:
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the shard phase launched hand kernels: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "shard", "step": "checks", "hand_kernel_launches": launches,
          "step_s": step_s, "phase_s": phase_s, "cap_s": SHARD_CAP_S,
          "within_cap": phase_s <= SHARD_CAP_S, "total_s": time.perf_counter() - t_start})
    if phase_s > SHARD_CAP_S:
        raise AssertionError(f"the shard phase took {phase_s:.1f} s, over its {SHARD_CAP_S} s cap")
    return {"local": local["line"], "server": served, "process": proc,
            "k1": {"min_plus": 0, "max_min": 0}}


# --- phase 22: the network front door ----------------------------------------------

NET_CAP_S = 60.0  # the phase's time budget
NET_KINDS = POOL_KINDS  # bfs and sssp, phase 17's weights
NET_CLIENTS = 4
# a bfs reply at scale 20 carries 8 MiB (int32 levels and parents) and a frame
# holds 64 MiB, so one submit_many takes 4 roots (PERF.md §4); the 16-root one
# is step 2's oversized reply
NET_MANY = 4
NET_SHORT_DEADLINE_S = 0.001  # no scale-20 bfs meets it
NET_RATE = 24.0  # open loop: about 0.8 of phase 18's 28.75-29.97 requests/s
NET_CONNS = 8
NET_SECONDS = 5.0
NET_LOADGEN_SEED = 7


def _net_series(name: str) -> float:
    """The sum of a counter's values over its labels, from the registry."""
    return sum(r["value"] for r in obs.metrics_snapshot() if r["name"] == name)


def _net_status_counts() -> dict:
    return {r["labels"]["code"]: r["value"] for r in obs.metrics_snapshot()
            if r["name"] == "serve.net.status"}


def step_net_setup(dev, p21: dict) -> dict:
    """Phase 17's scale-20 engine (bfs, sssp) rebuilt from the host arrays,
    a ``Server`` over it with phase 18's widths and SLO deadline, and a
    ``NetFrontend`` on an ephemeral port."""
    t = time.perf_counter()
    rows, cols, n = _engine_coo(p21["csr_host"])
    w = np.random.default_rng(WEIGHT_SEED).integers(1, 16, len(rows)).astype(np.float32)
    inputs_s = time.perf_counter() - t
    t = time.perf_counter()
    eng = GraphEngine.from_coo(Grid.make(1, 1, device=dev), rows, cols, n, weights=w,
                               kinds=NET_KINDS, keep_coo=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    del rows, cols, w
    srv = eng.serve(ServeConfig(lane_widths=SERVER_WIDTHS, max_wait_s=SERVER_MAX_WAIT_S,
                                slo_deadline_s=SERVER_SLO_S, update_flush=1,
                                update_max_delay_s=0.005, flight_recorder=False))
    t = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t
    srv.start()
    fe = NetFrontend(srv)
    return {"eng": eng, "srv": srv, "fe": fe, "n": n,
            "line": {"inputs_s": inputs_s, "build_s": build_s, "warmup_s": warm_s,
                     "port": fe.port, "device_bytes": eng.version.device_bytes()}}


def step_net_wire(srv, fe, p21: dict, clients: list) -> dict:
    """Step 1: 16 bfs and 16 sssp single-root submits over 4 connections and
    one submit_many, equal to phase 17's lanes and to ``Server.submit``'s."""
    roots = [int(r) for r in p21["roots"]]
    lanes = {k: dict(zip(roots, p21["lanes16"][k])) for k in NET_KINDS}
    direct = {}
    for kind in NET_KINDS:
        for r, f in zip(roots, srv.submit_many(kind, roots)):
            direct[kind, r] = f.result(timeout=120)
            _settled_lane(direct[kind, r], lanes[kind][r], kind, r)
    b_in, b_out = _net_series("serve.net.bytes_in"), _net_series("serve.net.bytes_out")
    t = time.perf_counter()
    futs = [(kind, r, clients[i % len(clients)].submit_nowait(kind, r))
            for i, (kind, r) in enumerate((k, r) for k in NET_KINDS for r in roots)]
    many = clients[0].submit_many_nowait("bfs", roots[:NET_MANY])
    for kind, r, f in futs:
        res = f.result(timeout=120)
        _settled_lane(res, lanes[kind][r], f"wire {kind}", r)
        _lanes_equal(res, direct[kind, r], f"wire {kind} root {r} against Server.submit")
    entries = many.result(timeout=120)
    wire_s = time.perf_counter() - t
    if [e["status"] for e in entries] != ["ok"] * NET_MANY:
        raise AssertionError(f"submit_many over the wire: {[e['status'] for e in entries]}")
    for r, e in zip(roots[:NET_MANY], entries):
        _settled_lane(e["result"], lanes["bfs"][r], "wire submit_many bfs", r)
    if fe.reply_drops:
        raise AssertionError(f"{fe.reply_drops} replies dropped")
    requests = len(futs) + 1
    return {"requests": requests, "roots_answered": len(futs) + NET_MANY,
            "clients": len(clients), "wire_s": wire_s, "requests_per_s": requests / wire_s,
            "bytes_in": _net_series("serve.net.bytes_in") - b_in,
            "bytes_out": _net_series("serve.net.bytes_out") - b_out,
            "reply_drops": fe.reply_drops, "lanes_equal_phase17": True,
            "equal_server_submit": True}


def step_net_typed(srv, fe, p21: dict, client) -> dict:
    """Step 2: an unknown kind, a deadline no batch meets, a connection past
    ``max_conns`` and a reply past the frame cap, each a typed reply that the
    client raises as the in-process exception type."""
    roots = [int(r) for r in p21["roots"]]
    seen = {}

    def typed(what, fut, want):
        exc = fut.exception(timeout=120)
        if type(exc) is not want:
            raise AssertionError(f"{what}: {exc!r}, want {want.__name__}")
        seen[what] = type(exc).__name__

    typed("unknown_kind", client.submit_nowait("nope", roots[0]), ValueError)
    typed("short_deadline",
          client.submit_nowait("bfs", roots[0], deadline_s=NET_SHORT_DEADLINE_S), TimeoutError)
    t = time.perf_counter()
    typed("oversized_reply", client.submit_many_nowait("bfs", roots), RuntimeError)
    oversized_s = time.perf_counter() - t
    fe2 = NetFrontend(srv, max_conns=1)
    try:
        first = NetClient("127.0.0.1", fe2.port)
        try:
            try:
                NetClient("127.0.0.1", fe2.port, max_retries=0)
            except BackpressureError:
                seen["connection_limit"] = "BackpressureError"
            else:
                raise AssertionError("a second hello past max_conns=1 was admitted")
            if fe2.rejected_conns != 1 or first.ping()["pong"] is not True:
                raise AssertionError(f"rejected {fe2.rejected_conns}, the admitted one gone")
        finally:
            first.close()
    finally:
        fe2.close()
    return {"typed": seen, "status_counts": _net_status_counts(),
            "oversized_reply_s": oversized_s}


def step_net_write(client, p21: dict) -> dict:
    """Step 3: phase 17's absent churn pair inserted over the wire, then a bfs
    from one end until the other is one hop away."""
    a, b = p21["pair"]
    t = time.perf_counter()
    res = client.submit_update([("insert", a, b, 1.0), ("insert", b, a, 1.0)])
    ack_s = time.perf_counter() - t
    polls = 0
    while True:
        polls += 1
        if int(client.submit("bfs", a)["levels"][b]) == 1:
            break
        if time.perf_counter() - t > 30:
            raise AssertionError(f"the inserted edge {a} -> {b} not visible after 30 s")
    return {"pair": [a, b], "ack_s": ack_s, "submit_to_visible_ms": (time.perf_counter() - t) * 1e3,
            "bfs_polls": polls, "version": res["version"], "mode": res["mode"],
            "merge_s": res.get("merge_s")}


def step_net_open_loop(eng, srv, p21: dict) -> dict:
    """Step 4: ``loadgen.run`` over the Server: seeded Poisson arrivals at
    about 0.8 of phase 18's rate, 8 connections, 5 s."""
    mark = eng.trace_mark()
    n_traces0 = len(obs_trace.records())
    out = loadgen.run(rate=NET_RATE, conns=NET_CONNS, seconds=NET_SECONDS, kind="bfs",
                      deadline_s=SERVER_SLO_S, trace_rate=1.0, backend=srv,
                      roots=p21["roots"], seed=NET_LOADGEN_SEED)
    builds = eng.retraces_since(mark)
    recs = [r for r in obs_trace.records()[n_traces0:] if r["labels"].get("transport") == "net"]
    # net_accept is charged to a connection's first request, one of loadgen's
    # 8 blocking warm-up reads (its frontend's traces net1 to net8); the other
    # stages are the scheduled requests', as loadgen's decomposition counts them
    accept = [st["s"] for r in recs for st in r["stages"] if st["stage"] == "net_accept"]
    recs = [r for r in recs if int(str(r["rid"])[3:]) > 8]
    stages = {k: v["mean_s"] * 1e3 for k, v in obs_trace.stage_summary(recs).items()}
    stages["net_accept"] = float(np.mean(accept)) * 1e3 if accept else None
    line = {k: out[k] for k in ("offered_qps", "achieved_qps", "requests", "conns", "p50_ms",
                                "p99_ms", "availability", "status_counts", "untyped_failures",
                                "stranded_futures", "retraces_after_warmup", "send_lag_max_ms",
                                "sent_wall_s", "wall_s", "slo", "ok")}
    line.update({"plan_builds_after_warmup": builds, "traced": len(recs),
                 "stage_mean_ms": stages, "decomposition": out["decomposition"]})
    if not out["ok"] or builds or out["stranded_futures"] or out["retraces_after_warmup"]:
        raise AssertionError(f"the open loop: {line}")
    return line


def phase_net(dev, t_start: float, p21: dict) -> dict:
    """Phase 22 (module docstring): the network front door over a Server, with
    K1's and K2's launch counts set to 0 just before and read just after;
    neither runs."""
    t0 = time.perf_counter()
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    emit({"phase": "net", "step": "elapsed", "total_s": t0 - t_start})
    obs.enable(install_hooks=False)
    step_s, out = {}, {}
    setup = clients = None
    try:
        t = time.perf_counter()
        setup = step_net_setup(dev, p21)
        step_s["setup"] = time.perf_counter() - t
        emit({"phase": "net", "step": "setup", "scale": BFS_SCALE, "n": setup["n"],
              "kinds": list(NET_KINDS), **setup["line"]})
        srv, fe = setup["srv"], setup["fe"]
        clients = [NetClient("127.0.0.1", fe.port) for _ in range(NET_CLIENTS)]
        for name, fn in (("wire", lambda: step_net_wire(srv, fe, p21, clients)),
                         ("typed", lambda: step_net_typed(srv, fe, p21, clients[0])),
                         ("write", lambda: step_net_write(clients[1], p21)),
                         ("open_loop", lambda: step_net_open_loop(setup["eng"], srv, p21))):
            t = time.perf_counter()
            out[name] = fn()
            step_s[name] = time.perf_counter() - t
            emit({"phase": "net", "step": name, **out[name]})
        if fe.reply_drops:
            raise AssertionError(f"{fe.reply_drops} replies dropped")
        # step 2's timeout is a bad request of the SLO budget (target 0.999),
        # so the Server may report its SLO breached; nothing else may be off
        h = fe.health()
        back = h["backend"]
        if (h["status"] not in ("ok", "degraded") or back["device_error"] is not None
                or back["worker_errors"]
                or any(b["state"] != "closed" for b in back["breakers"].values())):
            raise AssertionError(f"the net phase's Server: health {h['status']}, "
                                 f"device error {back['device_error']}")
        out["health"] = {"status": h["status"], "slo_breached": bool(
            back["slo"] and back["slo"]["breached"]), "connections": h["net"]["connections"]}
    finally:
        for c in clients or ():
            c.close()
        if setup is not None:
            setup["fe"].close()
            setup["srv"].close(drain=False)
            del setup
        obs.disable()
        obs.reset()
        obs_trace.clear()
        torch.cuda.empty_cache()
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if any(launches.values()):
        raise AssertionError(f"the net phase launched hand kernels: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "net", "step": "checks", "hand_kernel_launches": launches,
          "health": out.get("health"), "step_s": step_s, "phase_s": phase_s, "cap_s": NET_CAP_S,
          "within_cap": phase_s <= NET_CAP_S, "total_s": time.perf_counter() - t_start})
    if phase_s > NET_CAP_S:
        raise AssertionError(f"the net phase took {phase_s:.1f} s, over its {NET_CAP_S} s cap")
    return {**out, "k1": {"min_plus": 0, "max_min": 0}, "k2": launches["k2"]}

# --- phase 23: the grid over several processes ----------------------------------

MULTIPROC_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_multiproc"
MULTIPROC_MM = MULTIPROC_DIR / "g18.mtx"  # phase 13's Matrix Market file, kept for phase 23
MULTIPROC_CAP_S = 60.0  # the phase's time budget
MULTIPROC_RANKS, MULTIPROC_P = 2, 2  # two ranks on one card, a 2 x 2 grid
MULTIPROC_REPS = 5  # timed dist_spmv calls a semiring
MULTIPROC_TIMEOUT_S = 45.0  # the ranks' run, and each of their collectives
MULTIPROC_X_SEED = 23


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def tile_digests(M: SpParMat) -> dict:
    """The tiles this process holds, each as a digest of its arrays (indices,
    values and count; padding slots included), by ``"i,j"``."""
    out = {}
    for i, j in M.grid.owned_tiles():
        t = M.local_tile(i, j)
        out[f"{i},{j}"] = _digest(t.rows, t.cols, t.vals, t.nnz.view(1))
    return out


def entry_digests(M: SpParMat) -> dict:
    """The tiles this process holds, each as a digest of its valid entries
    sorted by (row, col), by ``"i,j"``: equal for the same entries in
    another slot order."""
    out = {}
    for i, j in M.grid.owned_tiles():
        t = M.local_tile(i, j)
        m = t.valid_mask()
        r, c, v = t.rows[m].long(), t.cols[m].long(), t.vals[m]
        order = torch.argsort(r * M.local_cols + c)
        out[f"{i},{j}"] = _digest(r[order], c[order], v[order])
    return out


def matrix_bytes(M: SpParMat) -> int:
    return sum(x.numel() * x.element_size() for x in (M.rows, M.cols, M.vals, M.nnz))


def multiproc_spmv(A: SpParMat, x: DistVec) -> dict:
    """``dist_spmv`` for plus_times and min_plus: a warm-up (its digest),
    then ``MULTIPROC_REPS`` calls on the host clock, synchronised, with
    this process's exchange a call (``multihost.STATS``)."""
    out = {}
    for sr in (PLUS_TIMES, MIN_PLUS):
        y = dist_spmv(sr, A, x)
        torch.cuda.synchronize()
        s0 = dict(multihost.STATS)
        t0 = time.perf_counter()
        for _ in range(MULTIPROC_REPS):
            dist_spmv(sr, A, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / MULTIPROC_REPS * 1e3
        out[sr.name] = {
            "digest": _digest(y.blocks), "ms": ms,
            "exchange_bytes": (multihost.STATS["bytes"] - s0["bytes"]) / MULTIPROC_REPS,
            "exchange_collectives": (multihost.STATS["collectives"] - s0["collectives"])
            / MULTIPROC_REPS,
            "exchange_ms": (multihost.STATS["seconds"] - s0["seconds"]) / MULTIPROC_REPS * 1e3}
    return out


def multiproc_steps(grid: Grid, d: Path) -> dict:
    """Phase 23's steps on ``grid`` (one process or a rank's share of two),
    from the host arrays in ``d``: digests, times, bytes and K1's launches
    of the mxu step."""
    out = {}
    r20, c20, v20, x20 = (np.load(d / f"{k}20.npy") for k in "rcvx")
    n = len(x20)
    t0 = time.perf_counter()
    A = SpParMat.from_global_coo(grid, r20, c20, v20, n, n)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["nnz"] = int(A.getnnz())
    out["matrix_bytes"] = matrix_bytes(A)
    out["capacity"] = A.capacity
    out["spmv"] = multiproc_spmv(A, DistVec.from_global(grid, x20, align="col"))
    del A, r20, c20, v20
    torch.cuda.empty_cache()
    r13, c13, v13 = (np.load(d / f"{k}13.npy") for k in "rcv")
    A13 = SpParMat.from_global_coo(grid, r13, c13, v13, FULL, FULL, dedup_sr=MIN_PLUS)
    if coo_has_duplicates(A13):
        raise AssertionError("the scale-13 tiles hold duplicates after dedup")
    semiring_matmul.launches = 0
    C, ms, _ = timed_call(lambda: spgemm_mxu(MIN_PLUS, A13, A13))
    tried = list(spgemm_mxu.last_capacities)
    out["mxu"] = {"launches": semiring_matmul.launches, "capacities": tried, "ms": ms,
                  "digests": tile_digests(C), "nnz": int(C.getnnz())}
    del C
    semiring_matmul.launches = 0
    C, ms, _ = timed_call(lambda: spgemm(MIN_PLUS, A13, A13))
    out["esc"] = {"ms": ms, "capacities": list(spgemm.last_capacities),
                  "digests": tile_digests(C), "nnz": int(C.getnnz()),
                  "k1_launches": semiring_matmul.launches}
    del C, A13
    torch.cuda.empty_cache()
    M, _, read_s = timed_call(lambda: read_mm_distributed(grid, str(MULTIPROC_MM)))
    out["read"] = {"s": read_s, "digests": entry_digests(M), "nnz": int(M.getnnz())}
    return out


def multiproc_rank(workdir: str) -> dict:
    """A rank of phase 23 (``multihost.launch`` runs it on each rank, which
    has joined the group over gloo on the card): ``multiproc_steps`` on the
    global 2 x 2 grid, and what the byte-range parse of this rank's share of
    the file takes alone."""
    grid = multihost.make_global_grid(MULTIPROC_P, MULTIPROC_P)
    out = {"rank": grid.rank, "owned": grid.owned_tiles(), "device": str(grid.device),
           "backend": torch.distributed.get_backend(),
           **multiproc_steps(grid, Path(workdir))}
    span_lo = _mm_header_span(MULTIPROC_MM)[0]
    span = MULTIPROC_MM.stat().st_size - span_lo
    lo = span_lo + span * grid.rank // grid.world
    hi = span_lo + span * (grid.rank + 1) // grid.world
    t0 = time.perf_counter()
    part = read_mm_range(MULTIPROC_MM, lo, hi)
    out["parse_s"], out["parse_entries"] = time.perf_counter() - t0, len(part[0])
    out["stats"] = dict(multihost.STATS)
    return out


def phase_multiproc(dev, t_start: float, p21: dict, host13: tuple) -> dict:
    """Phase 23 (module docstring): the grid over two processes on the
    card, against the one-process grid, with K1's launch count set to 0
    just before the ranks run and their counts read just after. Removes
    its directory."""
    t0 = time.perf_counter()
    semiring_matmul.launches = 0
    flat_to_tuples_arrays.launches = 0
    emit({"phase": "multiproc", "step": "elapsed", "total_s": t0 - t_start})
    step_s = {}
    try:
        t = time.perf_counter()
        rows, cols, n = _engine_coo(p21["csr_host"])
        arrays = {
            "r20": rows.astype(np.int32), "c20": cols.astype(np.int32),
            "v20": np.random.default_rng(WEIGHT_SEED).integers(1, 16, len(rows)).astype(np.float32),
            # integer x: every plus_times sum below 2^24, exact in any order
            "x20": np.random.default_rng(MULTIPROC_X_SEED).integers(0, 8, n).astype(np.float32),
            "r13": host13[0], "c13": host13[1], "v13": host13[2]}
        for k, a in arrays.items():
            np.save(MULTIPROC_DIR / f"{k}.npy", a)
        del rows, cols, arrays
        step_s["inputs"] = time.perf_counter() - t

        # the one-process grid on the same card: the results the ranks must give
        t = time.perf_counter()
        whole_s = timed_call(lambda: read_mm(str(MULTIPROC_MM)))[2]
        one = multiproc_steps(Grid.make(MULTIPROC_P, MULTIPROC_P, device=dev), MULTIPROC_DIR)
        one_launches = one["mxu"]["launches"]
        torch.cuda.empty_cache()
        step_s["one_process"] = time.perf_counter() - t

        # the two ranks, each its own CUDA context on the card, over gloo
        semiring_matmul.launches = 0
        t = time.perf_counter()
        ranks = multihost.launch(
            f"{Path(__file__).resolve()}:multiproc_rank", MULTIPROC_RANKS,
            kwargs={"workdir": str(MULTIPROC_DIR)}, device="cuda", backend="gloo",
            timeout_s=MULTIPROC_TIMEOUT_S, workdir=MULTIPROC_DIR / "ranks")
        step_s["ranks"] = time.perf_counter() - t
        if semiring_matmul.launches:
            raise AssertionError("the parent launched K1 while the ranks ran")
    finally:
        shutil.rmtree(MULTIPROC_DIR, ignore_errors=True)

    owned = [tuple(map(tuple, r["owned"])) for r in ranks]
    if sorted(t for o in owned for t in o) != [(i, j) for i in range(MULTIPROC_P)
                                               for j in range(MULTIPROC_P)]:
        raise AssertionError(f"the ranks' tiles {owned} do not cover the grid once")
    if any(r["backend"] != "gloo" or r["device"] != "cuda:0" for r in ranks):
        raise AssertionError("a rank ran off the card or off gloo")
    for sr in ("plus_times", "min_plus"):
        if any(r["spmv"][sr]["digest"] != one["spmv"][sr]["digest"] for r in ranks):
            raise AssertionError(f"dist_spmv {sr} on two ranks differs from one process")
    for step, key in (("mxu", "digests"), ("esc", "digests"), ("read", "digests")):
        got = {k: v for r in ranks for k, v in r[step][key].items()}
        if got != one[step][key]:
            raise AssertionError(f"{step} on two ranks differs from one process")
        if any(r[step]["nnz"] != one[step]["nnz"] for r in ranks):
            raise AssertionError(f"{step}: the ranks' global nnz differs from one process")
    two_launches = sum(r["mxu"]["launches"] for r in ranks)
    if two_launches != one_launches or any(r["mxu"]["capacities"] != one["mxu"]["capacities"]
                                           for r in ranks):
        raise AssertionError(f"K1 launched {two_launches} times on two ranks, {one_launches} on "
                             "one, or the ranks took other capacities")
    if any(r["esc"]["capacities"] != one["esc"]["capacities"] or r["esc"]["k1_launches"]
           for r in ranks):
        raise AssertionError("spgemm's capacities differ on two ranks, or it launched K1")

    def worst(step, key="ms"):
        return max(r[step][key] for r in ranks)

    for sr in ("plus_times", "min_plus"):
        emit({"phase": "multiproc", "step": "dist_spmv", "semiring": sr, "scale": BFS_SCALE,
              "grid": "2x2", "ranks": MULTIPROC_RANKS, "bit_equal": True,
              "one_process_ms": one["spmv"][sr]["ms"],
              "two_rank_ms": max(r["spmv"][sr]["ms"] for r in ranks),
              "exchange_bytes_per_call": [r["spmv"][sr]["exchange_bytes"] for r in ranks],
              "exchange_collectives_per_call": [r["spmv"][sr]["exchange_collectives"]
                                                for r in ranks],
              "exchange_ms_per_call": [r["spmv"][sr]["exchange_ms"] for r in ranks]})
    emit({"phase": "multiproc", "step": "matrix", "scale": BFS_SCALE, "nnz": one["nnz"],
          "one_process_bytes": one["matrix_bytes"],
          "rank_bytes": [r["matrix_bytes"] for r in ranks], "capacity": one["capacity"],
          "rank_capacity": [r["capacity"] for r in ranks],
          "one_process_build_s": one["build_s"], "rank_build_s": [r["build_s"] for r in ranks]})
    emit({"phase": "multiproc", "step": "mxu", "semiring": "min_plus", "scale": SCALE,
          "bit_equal": True, "k1_launches_one_process": one_launches,
          "k1_launches_by_rank": [r["mxu"]["launches"] for r in ranks],
          "capacities": one["mxu"]["capacities"], "nnz": one["mxu"]["nnz"],
          "one_process_ms": one["mxu"]["ms"], "two_rank_ms": worst("mxu")})
    emit({"phase": "multiproc", "step": "esc", "semiring": "min_plus", "scale": SCALE,
          "bit_equal": True, "capacities": one["esc"]["capacities"], "nnz": one["esc"]["nnz"],
          "one_process_ms": one["esc"]["ms"], "two_rank_ms": worst("esc")})
    emit({"phase": "multiproc", "step": "read_mm_distributed", "scale": GI_IO_SCALE,
          "same_entries": True, "nnz": one["read"]["nnz"], "whole_file_parse_s": whole_s,
          "one_process_s": one["read"]["s"], "two_rank_s": worst("read", "s"),
          "rank_range_parse_s": [r["parse_s"] for r in ranks],
          "rank_range_entries": [r["parse_entries"] for r in ranks]})
    launches = {"k1": semiring_matmul.launches, "k2": flat_to_tuples_arrays.launches}
    if launches["k2"]:
        raise AssertionError(f"the multiproc phase launched K2: {launches}")
    phase_s = time.perf_counter() - t0
    emit({"phase": "multiproc", "step": "checks", "k1_launches_by_rank":
          [r["mxu"]["launches"] for r in ranks], "step_s": step_s,
          "rank_exchange": [r["stats"] for r in ranks], "phase_s": phase_s,
          "cap_s": MULTIPROC_CAP_S, "within_cap": phase_s <= MULTIPROC_CAP_S,
          "total_s": time.perf_counter() - t_start})
    if phase_s > MULTIPROC_CAP_S:
        raise AssertionError(f"the multiproc phase took {phase_s:.1f} s, over its "
                             f"{MULTIPROC_CAP_S} s cap")
    return {"k1": {"min_plus": two_launches, "max_min": 0}}


WATCHDOG_S = 1100  # short of the 1,200 s the script must finish in


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    # the routed calls ask the plan store: a fresh one of the script's own,
    # probing off, so their tiers come from the code, not an ambient store
    shutil.rmtree(PLAN_STORE_DIR, ignore_errors=True)
    os.environ[tuner_config.ENV_PLAN_STORE] = str(PLAN_STORE_DIR)
    for name in (tuner_config.ENV_PROBE, tuner_config.ENV_TIER, tuner_config.ENV_BACKEND,
                 tuner_config.ENV_TIER3D, tuner_config.ENV_MERGE, tuner_config.ENV_SPMM_BACKEND):
        os.environ.pop(name, None)
    # a run still going after WATCHDOG_S prints every thread's stack to stderr
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    try:
        return run_phases()
    finally:
        faulthandler.cancel_dump_traceback_later()
        for d in (PLAN_STORE_DIR, DUR_DIR, FLEET_DIR, PROCFLEET_DIR, SHARD_DIR, MULTIPROC_DIR):
            shutil.rmtree(d, ignore_errors=True)


def run_phases() -> int:
    """Phases 1-23 (module docstring), then the ``kernels`` line and the
    contract's last line."""
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # torch.sparse.mm, timed as the library's call, is marked beta
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
    phase_card()
    loops = phase_build()
    full = phase_kernels(dev)
    phase_compaction(dev)
    path = phase_main_path(dev)
    # phase 5's products, as live entries, for phase 11's single-tile forms
    mxu13 = {name: live_entries(C) for name, (_, C) in path["mats"].items()}
    k2_path = phase_k2_path(path.pop("mats"))
    host13 = path.pop("host")  # phase 5's graph, on the host, for phase 23
    times = phase_times(dev, full, loops)
    bfs = phase_bfs_path(dev, t_start)
    A20, bfs_graph = bfs["spmat"].pop("A"), bfs["g"]
    torch.cuda.empty_cache()
    general = phase_spgemm_general(dev, t_start, bfs_graph)
    torch.cuda.empty_cache()
    windowed = phase_spgemm_windowed(dev, t_start, general["aa"], mxu13, A20, bfs_graph)
    torch.cuda.empty_cache()
    g18 = general.pop("g18")
    apps = phase_apps(dev, t_start, bfs_graph, bfs["E"], A20, g18)
    # for phase 15, on the host: phase 5's min_plus product and phase 8's
    # ELL structure
    mxu_min = tuple(t.cpu() for t in mxu13["min_plus"])
    E_host = (tuple((bc.cpu(), br.cpu()) for bc, _, br in bfs["E"].buckets), bfs["E"].nrows)
    # for phases 16 and 17, on the host: the graph's CSR arrays and its roots
    bfs_host = {**bfs.pop("csr_host"), "roots": bfs_graph["roots"][:OBS_BFS_ROOTS].copy()}
    engine_roots = bfs_graph["roots"][:ENGINE_ROOTS].copy()
    del bfs, bfs_graph, mxu13
    general.pop("aa")
    torch.cuda.empty_cache()
    graph_input = phase_graph_input(dev, t_start, g18)
    torch.cuda.empty_cache()
    mesh3d = phase_mesh3d(dev, t_start, A20, windowed.pop("dot_host"))
    del A20
    torch.cuda.empty_cache()
    tuner = phase_tuner(dev, t_start, mxu_min, E_host, mesh3d)
    torch.cuda.empty_cache()
    obs_phase = phase_obs(dev, t_start, mxu_min, E_host, bfs_host)
    del mxu_min, E_host
    torch.cuda.empty_cache()
    engine = phase_engine(dev, t_start, bfs_host, engine_roots, g18)
    server = phase_server(dev, t_start, engine, engine_roots)
    fleet = phase_fleet(dev, t_start, engine, engine_roots)
    p17 = {"roots": engine_roots, "lanes16": engine["serve"]["lanes16"],
           "pair": engine["churn"]["pairs"][-1]}
    p21 = shard_inputs(p17, engine, bfs_host, g18)
    del engine["serve"], engine["dur"], bfs_host, g18
    torch.cuda.empty_cache()
    procfleet = phase_procfleet(dev, t_start, p21["g18"], p21["pair18"],
                                fleet["replicas"]["requests_per_s"])
    torch.cuda.empty_cache()
    shard = phase_shard(dev, t_start, p21)
    torch.cuda.empty_cache()
    net = phase_net(dev, t_start, p21)
    torch.cuda.empty_cache()
    multiproc = phase_multiproc(dev, t_start, p21, host13)
    kernels = []
    for sr in (MIN_PLUS, MAX_MIN):  # the kinds the main path and phase 11 launch
        kind = _PALLAS_KINDS[sr.name]
        t = times[kind]
        by_path = {"main_path": path["per_kind"][sr.name]["kernel_launches"],
                   "spgemm_general": general["cross"][sr.name]["k1_launches"],
                   "spgemm_windowed": windowed["k1"][sr.name],
                   "apps": apps["k1"], "graph_input": graph_input["k1"],
                   "mesh3d": mesh3d["k1"][sr.name], "tuner": tuner["k1"][sr.name],
                   "obs": obs_phase["k1"][sr.name], "engine": engine["k1"][sr.name],
                   "server": server["k1"][sr.name], "fleet": fleet["k1"][sr.name],
                   "procfleet": procfleet["k1"][sr.name], "shard": shard["k1"][sr.name],
                   "net": net["k1"][sr.name], "multiproc": multiproc["k1"][sr.name]}
        kernels.append({
            "name": f"semiring_mm_{kind}", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "floor_ms": t["floor_ms"],
        })
    if sum(k["launches_by_path"]["main_path"] for k in kernels) != path["launches"]:
        raise AssertionError("K1's launch counts do not add up on the main path")
    if sum(k["launches_by_path"]["spgemm_general"] for k in kernels) != 4:
        raise AssertionError("K1's launch counts do not add up on the spgemm_general path")
    if sum(k["launches_by_path"]["mesh3d"] for k in kernels) != sum(mesh3d["k1"].values()):
        raise AssertionError("K1's launch counts do not add up on the mesh3d path")
    if (sum(k["launches_by_path"]["tuner"] for k in kernels) != sum(tuner["k1"].values())
            or tuner["k1"]["min_plus"] < 1):
        raise AssertionError("K1's launch counts do not add up on the tuner path")
    if (sum(k["launches_by_path"]["obs"] for k in kernels) != sum(obs_phase["k1"].values())
            or obs_phase["k1"]["min_plus"] < 1):
        raise AssertionError("K1's launch counts do not add up on the obs path")
    if (sum(k["launches_by_path"]["multiproc"] for k in kernels)
            != sum(multiproc["k1"].values()) or multiproc["k1"]["min_plus"] < 1):
        raise AssertionError("K1's launch counts do not add up on the multiproc path")
    k2 = k2_path["per_kind"]["min_plus"]
    kernels.append({
        "name": "dense_to_tuples_f32", "variant": k2["k2_variant"], "route": "cuda",
        "source": K2_SOURCE, "replaces": K2_TPU_KERNEL, "launches": k2_path["launches"]["k2"],
        "launches_by_path": {"k2_path": k2_path["launches"]["k2"], "net": net["k2"]},
        "max_abs_err": max(v["max_abs_err"] for v in k2_path["per_kind"].values()),
        "ms": k2["k2_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
        "floor_ms": None,  # no instruction-issue floor is derived for K2
    })
    # one extraction per semiring; K1 builds the tropical accumulators
    if k2_path["launches"] != {"k1": 2, "k2": 3}:
        raise AssertionError(f"K2 path launches {k2_path['launches']}, want k1 2, k2 3")
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never launched on the main path")
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
