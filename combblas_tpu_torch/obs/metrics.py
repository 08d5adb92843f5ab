"""Metrics registry — counterpart of ``combblas_tpu/obs/metrics.py``:
counters, gauges, histograms with labels.

The structured replacement for the reference's global ``cblas_*`` counter
variables (``CombBLAS.h:77-102``): instead of a fixed set of doubles, a
registry of named scalar facts — nnz in/out, SpGEMM symbolic flops,
redistribute drop counts, kernel build-cache hits, per-op load imbalance —
each optionally qualified by labels (``kernel="summa"``), snapshottable
for the JSONL exporter and mergeable across processes.

Everything here is plain host-side Python over dicts: no tensor ever
enters the registry (call sites convert to ``int``/``float`` first), so a
metric can never force a device sync.

The catalog below keeps the reference's rows, word for word, for the
series this package emits. Spans (``serve.shard.batch``) have no row, and the
port counts no traces (``trace.serve.shard``: a plan is built, not
traced). Where a row
speaks of the TPU's machinery the port's meaning is its counterpart:
``compile_cache.hits/misses`` count the hand kernels' library builds
(``_build.py``: found built, or compiled), ``compile_cache.entries`` the
files of the build dir, and the ``mxu`` tier is the dense tier (K1 for
the tropical semirings).

SpGEMM tier-router series (round 6 — the auto-tiered kernel ladder,
docs/spgemm.md):

==================================  =======  ==============================
name                                kind     meaning
==================================  =======  ==============================
``spgemm.auto.tier``                counter  calls routed per tier; labels
                                             ``tier`` (mxu / windowed /
                                             scan / esc / edgeharvest) and
                                             ``sr`` (semiring name)
``spgemm.windowed.windows_skipped`` counter  row blocks skipped because the
                                             symbolic pass proved them
                                             empty (never scanned)
``spgemm.windowed.blocks``          gauge    row blocks in the last plan
``spgemm.auto.mask_density``        gauge    symbolic output-support bound
                                             over dense cells (the oracle's
                                             density estimate)
==================================  =======  ==============================

2D windowed ``dot`` backend series (round 7 — the B-column-windowed MXU
tier that makes ``windowed`` the TPU mid-scale default, docs/spgemm.md):

=========================================  =======  =====================
name                                       kind     meaning
=========================================  =======  =====================
``spgemm.windowed.col_windows_skipped``    counter  (row block, col
                                                    window) pairs proved
                                                    symbolically empty —
                                                    never densified,
                                                    matmul'd, or scanned
``spgemm.windowed.col_windows``            gauge    col windows per row
                                                    block in the last 2D
                                                    plan
``spgemm.windowed.panel_cells``            gauge    padded-k × padded-
                                                    window cells of one
                                                    dense B stage panel
                                                    (the stage-operand
                                                    memory envelope; ≤
                                                    WINDOWED_MAX_PANEL_
                                                    CELLS when routed)
``spgemm.windowed.window_density``         gauge    symbolic output bound
                                                    over dense cells,
                                                    restricted to LIVE
                                                    (non-skipped) windows
``spgemm.auto.dedup_fallback``             counter  mxu routings demoted
                                                    because a tile held
                                                    duplicate entries
                                                    (labels: ``sr``)
``spgemm.windowed.oracle_skipped``         counter  oracle=True requests
                                                    that fell back to
                                                    clamped-flops caps
                                                    (outside the oracle
                                                    envelope)
=========================================  =======  =====================

Serve resilience series (round 8 — fault injection, poisoned-batch
isolation, circuit breakers, graph hot-swap; docs/serving.md
"Resilience"):

==============================  =========  ==============================
name                            kind       meaning
==============================  =========  ==============================
``serve.faults.injected``       counter    faults fired by the injection
                                           framework; labels ``point``
                                           (serve/faults.py
                                           FAULT_POINTS) and ``rule``
                                           (script/rate/when)
``serve.retry.requests``        counter    requests re-executed by the
                                           poisoned-batch bisection
                                           retrier (labels: ``kind``)
``serve.poison.isolated``       counter    requests failed after
                                           exhausting the retry budget
                                           (the isolated poison, or
                                           every rider of a genuinely
                                           dead engine); labels ``kind``
``serve.breaker.state``         gauge      per-kind breaker state:
                                           0 closed / 1 half-open /
                                           2 open (labels: ``kind``)
``serve.breaker.opened``        counter    breaker open transitions
                                           (labels: ``kind``)
``serve.breaker.fast_fail``     counter    submits rejected by an open
                                           breaker (labels: ``kind``)
``serve.worker.errors``         counter    worker-loop (scheduler-bug)
                                           errors, labeled by
                                           ``exc_type``
``serve.worker.backoff_s``      gauge      current worker error backoff
                                           (exponential, capped, reset
                                           on success)
``serve.swap.latency_s``        histogram  atomic graph-version swap
                                           latency (lock wait + pointer
                                           flip)
``serve.swap.build_s``          histogram  off-lock build time of the
                                           next GraphVersion
``serve.swap.count``            counter    completed hot-swaps
``serve.graph.version``         gauge      currently-served graph
                                           version id
==============================  =========  ==============================

``serve.requests{status=timeout}`` now also counts EXECUTION-time
deadline drops (a request already expired when its batch reached the
device is settled before occupying a lane), not just queue-sweep
expiries.

Pipelined / packed / 3D SpGEMM series (round 9 — the stage-pipelined
windowed carousel, oracle-packed launches, and the windowed 3D tier;
docs/spgemm.md):

=======================================  =======  =====================
name                                     kind     meaning
=======================================  =======  =====================
``spgemm.pipeline.stages_overlapped``    counter  TRACE-TIME: carousel
                                                  stages whose
                                                  successor rotation
                                                  was issued before
                                                  their accumulate
                                                  (p−1 per compiled
                                                  pipelined ring
                                                  program; the jit
                                                  retrace-visibility
                                                  convention of the
                                                  ``trace.*`` series)
``spgemm.windowed.windows_packed``       counter  windows in the packed
                                                  launch list — the
                                                  MXU/scatter launches
                                                  a plan actually pays
                                                  (vs ``blocks`` ×
                                                  ``col_windows``
                                                  total)
``spgemm.windowed.pack_ratio``           gauge    windows_packed /
                                                  windows_total of the
                                                  last plan (< 1 means
                                                  the skip list or the
                                                  oracle pruned
                                                  launches)
``spgemm.summa3d.layers``                gauge    L of the last 3D
                                                  windowed product
                                                  (``spgemm3d_windowed``
                                                  / the ``windowed3d``
                                                  auto route)
=======================================  =======  =====================

Span events: the carousel body emits one ``spgemm.pipeline.stage``
event per stage at trace time (fields ``stage``,
``overlapped`` — whether the next rotation was issued early), so a
trace export shows the planned comm/compute overlap structure of the
compiled schedule.

Autotuner / plan-store series (round 10 — the measured-cost plan store
and micro-probe pass, docs/autotuning.md):

===================================  =======  =========================
name                                 kind     meaning
===================================  =======  =========================
``tuner.store.hits``                 counter  routing decisions served
                                              from a remembered plan
                                              (labels: ``op`` =
                                              spgemm / spgemm3d)
``tuner.store.misses``               counter  lookups with no matching
                                              plan (probe or fallback
                                              follows)
``tuner.store.entries``              gauge    plans currently loaded
                                              (labels: ``dir``); also
                                              published by the
                                              compile-cache provider
                                              as ``compile_cache.
                                              entries{cache=plans}`` —
                                              one health surface for
                                              both caches
``tuner.store.invalid``              counter  corrupted / truncated /
                                              schema-mismatched JSONL
                                              lines skipped at load
``tuner.store.write_errors``         counter  failed store appends
                                              (read-only replica; the
                                              in-memory plan still
                                              routes)
``tuner.probe.runs``                 counter  candidate rungs measured
                                              by the micro-probe pass
                                              (labels: ``tier``)
``tuner.probe.seconds``              counter  cumulative timed probe
                                              seconds (the obs-visible
                                              probe cost)
``tuner.probe.winner``               counter  probe passes won per
                                              tier (labels: ``tier``)
``tuner.probe.errors``               counter  candidate rungs that
                                              faulted on the proxy
                                              (dropped, not fatal)
``tuner.probe.budget_exhausted``     counter  probe passes cut short
                                              by the probe budget
``tuner.store.rejected``             counter  key-matched records
                                              DISCARDED at routing
                                              (labels: ``reason`` =
                                              tier / no_grid3 / dup) —
                                              pair with ``hits`` to
                                              read the true hit rate
``spgemm.windowed.dispatch_conflict``  counter  ring requests that
                                              overrode an explicit
                                              blocked dispatch (ring
                                              is fused-only; the more
                                              specific ask wins)
``spgemm.auto.plan_source``          counter  WHERE each routing came
                                              from: labels ``source``
                                              (arg / store / env /
                                              probe / heuristic),
                                              ``tier``, ``op``
``spgemm.windowed.dispatch``         counter  windowed-tier program
                                              decomposition per call:
                                              labels ``mode`` (local /
                                              fused / blocked — the
                                              building-block default)
===================================  =======  =========================

The ``tuner.probe`` span wraps each probe pass (attrs ``sr``, proxy
``dim``), so trace exports show probe cost inline with the product that
paid it.

Dynamic-graph mutation series (round 11 — delta buffers, incremental
version builds, warm-restart recompute, the serve write lane;
docs/dynamic.md):

====================================  =========  =======================
name                                  kind       meaning
====================================  =========  =======================
``dynamic.delta.depth``               gauge      ops pending in a
                                                 ``DeltaBuffer``
``dynamic.delta.ops``                 counter    ops admitted (labels:
                                                 ``op`` = insert /
                                                 delete / upsert)
``dynamic.delta.batches``             counter    batches drained
``dynamic.delta.age_s``               histogram  oldest-op age at drain
                                                 (write-coalescing
                                                 latency)
``dynamic.state.bootstrap``           counter    merge states built
                                                 from scratch (first
                                                 ``apply_delta`` on a
                                                 version without one)
``dynamic.merge.applied``             counter    ``apply_delta`` calls,
                                                 labels ``mode`` =
                                                 incremental / rebuild
                                                 (the amortization
                                                 ratio's numerator and
                                                 denominator)
``dynamic.merge.spill``               counter    incremental attempts
                                                 that fell back to a
                                                 rebuild; labels
                                                 ``reason`` (threshold /
                                                 bucket_full / no_state
                                                 / forced)
``dynamic.merge.latency_s``           histogram  wall time of one
                                                 ``apply_delta``
``dynamic.merge.rows_patched``        counter    rows rewritten in
                                                 place (degree class
                                                 survived)
``dynamic.merge.rows_rebucketed``     counter    rows that claimed a
                                                 free slot in another
                                                 degree class
``dynamic.merge.edges_inserted``      counter    edges added by merges
``dynamic.merge.edges_removed``       counter    edges removed by merges
``dynamic.refresh.runs``              counter    ``engine.refresh``
                                                 calls; labels ``kind``
                                                 (bfs / cc / pagerank),
                                                 ``mode`` (cached /
                                                 warm / cold)
``dynamic.refresh.iters``             histogram  sweeps/iterations one
                                                 refresh ran (labels
                                                 ``kind``, ``mode`` —
                                                 warm-restart savings)
``dynamic.refresh.latency_s``         histogram  refresh wall time
                                                 (labels ``kind``,
                                                 ``mode``)
``serve.update.submitted``            counter    ``submit_update``
                                                 admissions
``serve.update.rejected``             counter    write-lane
                                                 backpressure rejects
                                                 (full delta buffer)
``serve.update.invalid``              counter    malformed update
                                                 batches (failed their
                                                 own future)
``serve.update.merges``               counter    merge+swap cycles run
                                                 by the mutation
                                                 thread; labels
                                                 ``mode``
``serve.update.failed``               counter    merge cycles that
                                                 failed (their updates'
                                                 futures carry the
                                                 error); labels
                                                 ``exc_type``
``serve.update.coalesced``            histogram  ops per merged batch
                                                 (write coalescing)
``tuner.store.compacted``             counter    superseded/evicted
                                                 JSONL lines removed by
                                                 the load-time
                                                 compaction rewrite
``tuner.store.evicted``               counter    plans dropped by the
                                                 max-entries
                                                 oldest-cost eviction
====================================  =========  =======================

Batched-SpMM / propagate-lane series (round 12 — the MXU-resident
SpMM kernel family, the ``"propagate"`` serve kind, headroom-aware
bucket sizing and window-geometry probing; docs/spmm.md):

====================================  =======  =========================
name                                  kind     meaning
====================================  =======  =========================
``spmm.pipeline.stages_overlapped``   counter  TRACE-TIME: carousel
                                               stages whose successor
                                               panel rotation was
                                               issued before their
                                               contraction (p−1 per
                                               compiled pipelined ring
                                               program — the SpMM twin
                                               of ``spgemm.pipeline.
                                               stages_overlapped``)
``spgemm.auto.plan_source``           counter  gains ``op="spmm"``
                                               rows: where each SpMM
                                               backend resolution came
                                               from (arg / store / env
                                               / probe / heuristic)
``serve.propagate.feature_dim``       gauge    TRUE feature width of
                                               the loaded table (pad
                                               stripped; the pow2 pad
                                               width is the compiled
                                               shape)
``dynamic.merge.headroom_used``       counter  free padding slots
                                               claimed by re-bucketing
                                               rows (the
                                               ``from_coo(headroom=)``
                                               reserve paying off
                                               instead of a
                                               ``bucket_full`` spill)
``tuner.probe.geometry_runs``         counter  windowed block-geometry
                                               candidates measured by
                                               the probe's
                                               window-geometry sweep
                                               (the winner persists
                                               with ``block_rows`` /
                                               ``block_cols`` in its
                                               plan record)
====================================  =======  =========================

Merge-tier / 3D-carousel series (round 13 — the sort-free fiber
reduce and the carousel-pipelined per-layer 3D SUMMA;
docs/spgemm.md "merge tiers"):

====================================  =======  =========================
name                                  kind     meaning
====================================  =======  =========================
``spgemm.merge.tier``                 counter  combine-merge tier each
                                               merge-consuming entry
                                               resolved (labels
                                               ``tier`` = sort / runs
                                               / hash, ``source`` =
                                               arg / store / env /
                                               probe / heuristic /
                                               hash_fallback, with a
                                               ``_degraded`` suffix
                                               when a forced hash on a
                                               generic monoid degraded
                                               to runs at the knob,
                                               and ``op``)
``spgemm.merge.hash_overflow``        counter  entries the hash tier's
                                               bounded table failed to
                                               place (the product
                                               transparently reruns
                                               through the sorted-runs
                                               tier — this counter is
                                               how a mis-routed plan
                                               gets noticed)
``spgemm.summa3d.piece_overflow``     counter  fiber-exchange entries
                                               that exceeded
                                               piece_capacity (the
                                               entry RAISES naming the
                                               slack knob; round-13
                                               bugfix — previously
                                               detected but silently
                                               ignored by callers)
``spgemm.pipeline.stages_overlapped`` counter  now ALSO emitted by the
                                               3D kernels' pipelined
                                               rings (p−1 per layer
                                               program per compiled
                                               trace, same trace-time
                                               convention)
====================================  =======  =========================

Multi-tenant pool / fleet series (round 14 — the engine pool, WFQ
scheduling and the replicated serving fleet; docs/serving.md
"Multi-tenant pool & fleet"):

====================================  =======  =========================
name                                  kind     meaning
====================================  =======  =========================
``serve.pool.resident_bytes``         gauge    device bytes of all
                                               resident tenant
                                               versions (the LRU's
                                               accounting surface —
                                               ``GraphVersion.
                                               device_bytes``)
``serve.pool.resident_tenants``       gauge    tenants whose engine is
                                               currently on-device
``serve.pool.admits``                 counter  engine builds/rebuilds
                                               (label ``tenant``) —
                                               re-admission after an
                                               eviction counts here
``serve.pool.evictions``              counter  device-state evictions
                                               (label ``tenant``)
``serve.pool.over_budget``            counter  admits that found no
                                               idle victim and left
                                               the pool over its byte
                                               budget
``serve.pool.rebuild_s``              hist     admit-time engine build
                                               latency (the rebuild-
                                               not-reload cost)
``serve.wfq.rounds``                  counter  deficit-round-robin
                                               scheduling rounds
``serve.wfq.served``                  counter  requests/ops charged
                                               per tenant (label
                                               ``tenant``) — the
                                               weighted-share property
                                               is asserted on this
``serve.wfq.deficit``                 gauge    per-tenant deficit
                                               balance at round grant
                                               (label ``tenant``)
``serve.fleet.replicas``              gauge    replica count behind
                                               the router
``serve.fleet.submitted``             counter  queries routed (label
                                               ``replica``)
``serve.fleet.spillover``             counter  backpressure re-routes
                                               to the next replica
                                               (label ``replica`` =
                                               the one that rejected)
``serve.fleet.fanout``                counter  home-merge version
                                               fan-outs applied fleet-
                                               wide
``serve.fleet.fanout_s``              hist     wall time of one full
                                               fan-out (rebuilds +
                                               atomic swaps)
``serve.checkpoint.save_s``           hist     ``save_version``
                                               snapshot wall time
``serve.checkpoint.load_s``           hist     ``load_version``
                                               restore wall time (one
                                               device_put per array)
====================================  =======  =========================

Pre-existing serve series gain a ``tenant`` label when the emitting
scheduler/breaker is owned by a pool tenant (``serve.queue.depth``,
``serve.queue.rejected``, ``serve.requests``, ``serve.breaker.*``);
single-tenant servers emit the unchanged label sets.

Foundation series (rounds 1-5 — cataloged here since round 15; the
static catalog-drift sweep in tests/test_obs_catalog.py asserts every
literal ``obs.count/gauge/observe`` series name in the package appears
in this docstring):

=====================================  =========  =====================
name                                   kind       meaning
=====================================  =========  =====================
``spgemm.symbolic_fill_slots``         counter    symbolic fill-in of a
                                                  product (pre-launch)
``spgemm.realized_nnz``                counter    realized output nnz
                                                  (DEVICE_SYNC only)
``spgemm.load_imbalance``              gauge      max/mean per-tile
                                                  flops (the
                                                  reference's
                                                  LoadImbalance)
``spgemm.phases``                      gauge      multi-phase SpGEMM
                                                  phase count
``spgemm.phase_adjusted``              counter    phase counts adjusted
                                                  upward by the memory
                                                  estimator
``spgemm.scan.overflow_retries``       counter    scan-tier capacity
                                                  retries
``spgemm.scan.overflow_slots``         counter    slots dropped pre-
                                                  retry (always
                                                  retried to zero)
``spgemm.mxu.overflow_retries``        counter    mxu-tier extraction
                                                  retries
``redistribute.dropped``               counter    entries dropped by a
                                                  capacity-bounded
                                                  route (0 = complete)
``redistribute.retries``               counter    capacity-doubling
                                                  retries
``redistribute.stage_capacity``        gauge      per-stage routing
                                                  capacity of the last
                                                  call
``redistribute.tile_capacity``         gauge      per-tile landing
                                                  capacity of the last
                                                  call
``spmv.dispatch``                      counter    SpMV dispatches per
                                                  kernel (labels:
                                                  ``kernel``)
``compile_cache.hits/misses``          counter    persistent XLA cache
                                                  traffic (the
                                                  jax.monitoring
                                                  bridge)
``compile_cache.entries``              gauge      cache files on disk
                                                  (labels ``cache`` =
                                                  xla / plans)
``mcl.perturb_kicks``                  counter    MCL chaos-plateau
                                                  perturbation kicks
``mcl.block_rerolls``                  counter    MCL sparse-block
                                                  capacity rerolls
``k1.*`` (``k1.<stage>_s``)            histogram  Graph500 kernel-1
                                                  stage seconds
``serve.plan_cache.hits`` /            counter    engine plan-cache
``serve.plan_cache.misses``
                                                  traffic (labels
                                                  ``kind``, ``width``)
``serve.queue.depth``                  gauge      pending requests
``serve.queue.rejected``               counter    backpressure rejects
                                                  (labels ``kind``)
``serve.requests``                     counter    request dispositions
                                                  (labels ``kind``,
                                                  ``status`` = ok /
                                                  error / timeout /
                                                  invalid / cancelled)
``serve.request.latency_s``            histogram  submit-to-settle
                                                  latency (labels
                                                  ``kind``)
``serve.batch.occupancy``              histogram  live lanes / bucket
                                                  width per batch
``serve.batch.padding_waste``          histogram  pad lanes per batch
``serve.batches``                      gauge      total batches
                                                  executed
``obs.provider_errors``                counter    broken pull-provider
                                                  callbacks (caught)
=====================================  =========  =====================

Production-observability series (round 15 — per-request tracing, the
flight recorder, SLO error budgets, freshness gauges and the scrape
surface; docs/observability.md "Serving observability"):

========================================  =========  ==================
name                                      kind       meaning
========================================  =========  ==================
``serve.trace.sampled``                   counter    requests whose
                                                     deterministic
                                                     sample-hash
                                                     admitted a trace
                                                     (labels ``lane`` =
                                                     request / update)
``serve.trace.dropped``                   counter    completed traces
                                                     dropped by the
                                                     bounded trace log
``serve.flightrec.events``                counter    events recorded
                                                     into flight-
                                                     recorder rings
``serve.flightrec.dumps``                 counter    ring snapshots
                                                     written (labels
                                                     ``reason`` =
                                                     worker_error /
                                                     breaker_open /
                                                     poisoned /
                                                     merge_failed /
                                                     slo_breach /
                                                     manual)
``serve.slo.good``                        counter    requests that met
                                                     the SLO deadline
                                                     (labels ``kind``
                                                     [, ``tenant``])
``serve.slo.bad``                         counter    requests that blew
                                                     it — timeout,
                                                     error, poisoned,
                                                     rejected (labels
                                                     ``kind``
                                                     [, ``tenant``])
``serve.slo.budget_burn``                 gauge      rolling-window bad
                                                     count over the
                                                     error budget
                                                     ``(1 - target) x
                                                     window total``;
                                                     >= 1 = budget
                                                     exhausted (labels
                                                     [``tenant``])
``dynamic.freshness.versions_behind``     gauge      graph versions
                                                     between a cached
                                                     analytic and the
                                                     served version at
                                                     refresh time
                                                     (labels ``kind``)
``dynamic.freshness.repair_ratio``        gauge      warm / (warm +
                                                     cold) refresh
                                                     runs on this
                                                     engine — the
                                                     repair-vs-cold
                                                     ratio the
                                                     streaming bench
                                                     gates on
``obs.scrape.requests``                   counter    HTTP scrape hits
                                                     (labels ``path``)
========================================  =========  ==================

Durability & self-healing series (round 16 — the write-ahead log,
crash recovery, replica supervision and write-home failover;
docs/serving.md "Durability & self-healing"):

========================================  =========  ==================
name                                      kind       meaning
========================================  =========  ==================
``serve.wal.appends``                     counter    WAL records
                                                     durably appended
                                                     (data records and
                                                     drop tombstones;
                                                     frontier marks
                                                     are written by
                                                     truncation, not
                                                     counted here)
``serve.wal.append_s``                    histogram  per-append latency
                                                     (fsync included
                                                     under policy
                                                     ``always``)
``serve.wal.append_failed``               counter    appends that
                                                     failed — the
                                                     write was
                                                     REJECTED, never
                                                     acknowledged
                                                     undurable
``serve.wal.invalid``                     counter    damaged JSONL
                                                     lines skipped at
                                                     replay (counted
                                                     once per line;
                                                     the expected
                                                     torn-final-line
                                                     crash artifact
                                                     included)
``serve.wal.truncated``                   counter    replayed-prefix
                                                     records dropped
                                                     by checkpoint
                                                     truncation
``serve.checkpoint.auto``                 counter    snapshots taken
                                                     (labels
                                                     ``reason`` =
                                                     bootstrap / auto /
                                                     close / manual)
``serve.checkpoint.failed``               counter    failed snapshot
                                                     attempts (labels
                                                     ``exc_type``;
                                                     previous snapshot
                                                     + WAL stay
                                                     intact)
``serve.recovery.runs``                   counter    ``recover_version``
                                                     completions
``serve.recovery.replayed_ops``           counter    WAL ops replayed
                                                     through
                                                     ``apply_delta``
                                                     during recovery
``serve.recovery.recover_s``              histogram  snapshot-load +
                                                     replay wall time
``serve.recovery.snapshot_seq``           gauge      ``wal_seq`` stamp
                                                     of the snapshot
                                                     recovery loaded
``serve.recovery.snapshot_rejected``      counter    corrupt/truncated
                                                     snapshots skipped
                                                     (fallback to the
                                                     previous retained
                                                     one)
``serve.fleet.versions_behind``           gauge      fan-out
                                                     generations a
                                                     replica lags the
                                                     home (labels
                                                     ``replica``; > 0
                                                     degrades fleet
                                                     health)
``serve.fleet.fanout_failed``             counter    per-replica
                                                     rebuild/swap
                                                     failures inside
                                                     ``fan_out`` —
                                                     the replica lags,
                                                     the fleet
                                                     continues (labels
                                                     ``replica``)
``serve.fleet.supervisor``                counter    supervision events
                                                     (labels
                                                     ``action`` =
                                                     detected /
                                                     replaced / error /
                                                     warmup_error)
``serve.fleet.promotions``                counter    home promotions at
                                                     the WAL frontier
``serve.fleet.replaced``                  counter    dead replicas
                                                     rebuilt from
                                                     checkpoint+WAL
                                                     and re-admitted
                                                     (labels
                                                     ``replica``)
``serve.fleet.quarantined``               counter    dead servers taken
                                                     out of service,
                                                     pending futures
                                                     failed honestly
``serve.fleet.read_retry``                counter    reads re-submitted
                                                     to the next-best
                                                     replica after an
                                                     execution-side
                                                     failure (labels
                                                     ``replica`` — the
                                                     retry target)
``serve.fleet.drained`` /                 counter    rolling-restart
``serve.fleet.restored`` /                           lifecycle events
``serve.fleet.rolling_restarts``                     (labels
                                                     ``replica`` on
                                                     the per-replica
                                                     pair)
========================================  =========  ==================

Process-fleet series (round 17 — subprocess replicas with real crash
domains; docs/serving.md "Process fleet").  The shared policy layer
(``serve/policy.py``) emits the routing/supervision disposition under
the fleet's own prefix, so ``serve.procfleet.submitted`` /
``.spillover`` / ``.read_retry`` / ``.supervisor`` are the
``serve.fleet.*`` rows above with processes instead of threads; the
rows below are process-specific:

========================================  =========  ==================
name                                      kind       meaning
========================================  =========  ==================
``serve.procfleet.replicas``              gauge      subprocess replica
                                                     count behind the
                                                     router
``serve.procfleet.heartbeat_age_s``       gauge      seconds since a
                                                     replica's last
                                                     heartbeat (labels
                                                     ``replica``) —
                                                     the HANG detector:
                                                     a SIGSTOPped
                                                     process is alive
                                                     but silent, and
                                                     past the timeout
                                                     it is quarantined
                                                     and routed around
``serve.procfleet.rpc_latency_s``         histogram  per-RPC round-trip
                                                     over the framed
                                                     IPC channel
                                                     (labels ``op``)
``serve.procfleet.ipc_timeouts``          counter    RPCs that ran out
                                                     their per-request
                                                     deadline (labels
                                                     ``op``) — futures
                                                     fail; the router
                                                     never wedges on a
                                                     hung replica
``serve.procfleet.quarantined``           counter    replica processes
                                                     taken out of
                                                     service (in-flight
                                                     futures failed
                                                     honestly, process
                                                     SIGKILLed; labels
                                                     ``replica``)
``serve.procfleet.respawns``              counter    replacement
                                                     subprocesses
                                                     booted warm from
                                                     checkpoint+WAL
                                                     (labels
                                                     ``replica``)
``serve.procfleet.respawn_failed``        counter    failed respawn
                                                     attempts — the
                                                     fleet keeps
                                                     serving degraded
                                                     on survivors with
                                                     capped-backoff
                                                     retry (labels
                                                     ``replica``)
``serve.procfleet.promotions``            counter    dead-home
                                                     promotions at the
                                                     WAL frontier, over
                                                     IPC
``serve.procfleet.sigkills`` /            counter    scripted
``serve.procfleet.sigstops``                         ``ProcessFaultPlan``
                                                     signals fired at
                                                     replica processes
                                                     (labels
                                                     ``replica``)
``serve.procfleet.fanout``                counter    home-merge version
                                                     fan-outs (spooled
                                                     checkpoint file +
                                                     per-replica
                                                     ``swap_from_
                                                     checkpoint``)
``serve.procfleet.fanout_s``              histogram  wall time of one
                                                     full fan-out
                                                     (spool + swaps)
``serve.procfleet.fanout_failed``         counter    per-replica swap
                                                     failures inside a
                                                     fan-out — the
                                                     replica lags, the
                                                     fleet continues
                                                     (labels
                                                     ``replica``)
``serve.procfleet.versions_behind``       gauge      fan-out
                                                     generations a
                                                     replica lags the
                                                     home (labels
                                                     ``replica``)
``tuner.store.compact_skipped``           counter    plan-store
                                                     compactions
                                                     skipped on
                                                     advisory-lock
                                                     contention (a
                                                     sibling process
                                                     is compacting) —
                                                     the next loader
                                                     compacts instead
``tuner.store.append_unfenced``           counter    plan appends that
                                                     proceeded without
                                                     the shared fence
                                                     after the bounded
                                                     non-blocking
                                                     retries (a wedged
                                                     lock holder must
                                                     never hang the
                                                     write path)
========================================  =========  ==================

Fleet observability plane (round 18, the serve/procfleet.py +
serve/ipc.py cross-process plane; ``replica=``-labeled child-process
series additionally arrive in a ``ProcessFleet.serve_metrics()``
scrape via the heartbeat-piggybacked registry snapshots):

========================================  =========  ==================
``serve.ipc.bytes_out`` /                 counter    framed bytes sent/
``serve.ipc.bytes_in``                               received on one
                                                     IPC channel, wire
                                                     size incl. the
                                                     length prefix —
                                                     the isolation
                                                     tax's bandwidth
                                                     half (labels
                                                     ``peer``)
``serve.ipc.encode_s`` /                  histogram  frame encode /
``serve.ipc.decode_s``                               decode seconds —
                                                     the serialization
                                                     half of the
                                                     isolation tax
                                                     (labels ``peer``)
``serve.ipc.deadline_missed``             counter    RPCs that expired
                                                     in the parent-side
                                                     deadline sweep (a
                                                     hung replica's
                                                     per-request
                                                     failure; labels
                                                     ``replica``)
``serve.procfleet.hb_snapshots``          counter    child registry
                                                     snapshots
                                                     piggybacked on
                                                     heartbeats (the
                                                     federation wire;
                                                     emitted INSIDE the
                                                     child process)
``serve.fleetlog.events``                 counter    supervision
                                                     timeline events
                                                     appended to the
                                                     ``combblas_tpu.
                                                     fleetlog/v1`` log
                                                     (labels ``event``)
========================================  =========  ==================

Network front door (round 19, serve/net/ — the TCP frontend; wire
byte/serialization accounting rides the shared ``serve.ipc.*`` series
above with ``peer="net"`` / ``peer="netclient"``, one codec for both
transports):

========================================  =========  ==================
``serve.net.connections``                 gauge      currently-open
                                                     admitted
                                                     connections
``serve.net.accept_queue``                gauge      connections
                                                     accepted but still
                                                     mid-handshake
                                                     (hello pending)
``serve.net.requests``                    counter    request frames
                                                     dispatched (labels
                                                     ``op``)
``serve.net.bytes_in`` /                  counter    wire bytes per
``serve.net.bytes_out``                              reply direction
                                                     incl. the length
                                                     prefix (derived
                                                     from the channel
                                                     byte totals)
``serve.net.status``                      counter    replies by
                                                     protocol status
                                                     code (labels
                                                     ``code`` — the
                                                     error-taxonomy
                                                     wire mapping;
                                                     rejections are
                                                     COUNTED wire
                                                     replies, never
                                                     dropped
                                                     connections)
``serve.net.reply_drops``                 counter    replies whose
                                                     connection was
                                                     gone at send time
                                                     (the request still
                                                     settled — dropped
                                                     reply, not a
                                                     stranded future)
========================================  =========  ==================

Sharded serving (round 20, serve/shard.py + serve/_shardworker.py —
one graph partitioned over N slice processes, served as one engine;
slice-side series carry a ``slice=`` label):

========================================  =========  ==================
``serve.shard.slices``                    gauge      live slice count
                                                     (0 after close)
``serve.shard.hops``                      counter    bulk-synchronous
                                                     hop rounds fanned
                                                     to every slice
``serve.shard.hop_s``                     histogram  slice-side wall of
                                                     one hop program
``serve.shard.exec_retries``              counter    whole-batch
                                                     replays after a
                                                     mid-batch slice
                                                     death + heal
``serve.shard.writes``                    counter    two-phase write
                                                     batches committed
                                                     on every slice
``serve.shard.write_aborts``              counter    phase-1 append
                                                     failures (batch
                                                     tombstoned, write
                                                     rejected)
``serve.shard.wal_appends`` /             counter    per-slice phase-1
``serve.shard.wal_aborts``                           appends / abort
                                                     tombstones
``serve.shard.commits``                   counter    per-slice phase-2
                                                     applies (frontier
                                                     advances)
``serve.shard.merge_s``                   histogram  slice-side slab
                                                     merge latency
``serve.shard.frontier_min``              gauge      vector frontier
                                                     minimum (the
                                                     scalar wal_seq
                                                     projection)
``serve.shard.frontier_lag``              gauge      max-min frontier
                                                     spread right after
                                                     a commit round
``serve.shard.checkpoints``               counter    slab snapshots
                                                     (labels ``reason``)
``serve.shard.checkpoint_failed``         counter    failed slab
                                                     auto-snapshots
                                                     (previous snapshot
                                                     + WAL intact)
``serve.shard.recoveries``                counter    slice boots via
                                                     slab snapshot +
                                                     filtered WAL-
                                                     suffix replay
``serve.shard.slice_deaths``              counter    slices quarantined
                                                     (dead / hung /
                                                     failed RPC)
``serve.shard.replacements``              counter    successful slice
                                                     respawns
``serve.shard.respawn_failed``            counter    respawn attempts
                                                     that failed (next
                                                     try after capped
                                                     backoff)
``serve.shard.heal_wait_s``               histogram  wall spent driving
                                                     supervision until
                                                     all slices serve
``serve.shard.supervisor_errors``         counter    supervisor-loop
                                                     tick exceptions
``serve.shard.hb_snapshots``              counter    slice-worker
                                                     heartbeat metric
                                                     snapshots
                                                     federated to the
                                                     router
========================================  =========  ==================

Sharded hop wire protocol (round 21, serve/shard.py — sparse frontier
triples + slice-resident loop state; see docs/serving.md "Sharded hop
wire protocol"):

========================================  =========  ==================
``serve.shard.hop_bytes``                 counter    logical payload
                                                     bytes per fan
                                                     (labels
                                                     ``direction``
                                                     out|in,
                                                     ``encoding``
                                                     sparse|dense|
                                                     final|collect)
``serve.shard.frontier_nnz``              histogram  router-side
                                                     frontier entries
                                                     per hop (label
                                                     ``kind``)
``serve.shard.encoding``                  counter    per-hop router
                                                     encoding decision
                                                     (label ``choice``
                                                     sparse|dense;
                                                     frontier hops
                                                     only)
``serve.shard.stale_epochs``              counter    healthy-slice
                                                     resident-state
                                                     misses that forced
                                                     a whole-batch
                                                     replay (label
                                                     ``kind``)
``serve.shard.wire_quant_err``            histogram  router-side max
                                                     abs bf16
                                                     quantization error
                                                     per outbound dense
                                                     payload (only
                                                     under
                                                     COMBBLAS_SHARD_
                                                     WIRE=bf16)
========================================  =========  ==================
"""

from __future__ import annotations

import threading

from .sinks import quantile_summary

#: Metric-kind tags used in snapshots and the JSONL schema.
KIND_COUNTER = "counter"
KIND_GAUGE = "gauge"
KIND_HISTOGRAM = "histogram"

#: Per-histogram sample reservoir size (round 15): the last RESERVOIR
#: observations ride along in snapshots so quantile summaries
#: (p50/p95/p99) are computable ONCE (``sinks.quantile_summary``) for
#: the Prometheus exporter, ``aggregate()`` and the bench sidecars —
#: instead of every bench keeping its own latency list.  Overflow
#: overwrites in arrival order (a sliding window of recent values).
RESERVOIR = 512


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Threadsafe in-memory metric store.

    Counters are monotonically-added floats/ints; gauges hold the last
    set value; histograms keep (count, sum, min, max) — enough for the
    per-app tables and for cross-process aggregation without binning
    policy baked in.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        # [count, sum, min, max, samples] — samples is the bounded
        # quantile reservoir (RESERVOIR), overwritten in arrival order
        self._hists: dict[tuple, list] = {}

    def _key(self, name: str, labels: dict) -> tuple:
        # labels live inside the key (sorted tuple); snapshot()
        # reconstructs the dict from it
        return (name, _label_key(labels))

    # -- writers -----------------------------------------------------------
    def count(self, name: str, value=1, **labels):
        with self._lock:
            key = self._key(name, labels)
            self._counters[key] = self._counters.get(key, 0) + value

    def gauge(self, name: str, value, **labels):
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value, **labels):
        with self._lock:
            key = self._key(name, labels)
            h = self._hists.get(key)
            if h is None:
                self._hists[key] = [1, value, value, value, [value]]
            else:
                h[0] += 1
                h[1] += value
                h[2] = min(h[2], value)
                h[3] = max(h[3], value)
                samples = h[4]
                if len(samples) < RESERVOIR:
                    samples.append(value)
                else:  # sliding window: overwrite in arrival order
                    samples[(h[0] - 1) % RESERVOIR] = value

    # -- readers -----------------------------------------------------------
    def get_counter(self, name: str, default=0, **labels):
        return self._counters.get((name, _label_key(labels)), default)

    def get_gauge(self, name: str, default=None, **labels):
        return self._gauges.get((name, _label_key(labels)), default)

    def get_histogram(self, name: str, **labels):
        h = self._hists.get((name, _label_key(labels)))
        if h is None:
            return None
        return {
            "count": h[0], "sum": h[1], "min": h[2], "max": h[3],
            **quantile_summary(h[4]),
        }

    def empty(self) -> bool:
        return not (self._counters or self._gauges or self._hists)

    def snapshot(self) -> list[dict]:
        """All metrics as schema records (no ``v``/``ts`` envelope — the
        sink adds those)."""
        with self._lock:
            out = []
            for (name, lk), v in sorted(self._counters.items()):
                out.append({
                    "kind": KIND_COUNTER, "name": name,
                    "labels": dict(lk), "value": v,
                })
            for (name, lk), v in sorted(self._gauges.items()):
                out.append({
                    "kind": KIND_GAUGE, "name": name,
                    "labels": dict(lk), "value": v,
                })
            for (name, lk), h in sorted(self._hists.items()):
                out.append({
                    "kind": KIND_HISTOGRAM, "name": name,
                    "labels": dict(lk), "count": h[0], "sum": h[1],
                    "min": h[2], "max": h[3],
                    # the bounded reservoir + its quantile summary:
                    # computed HERE once, reused by the exporter,
                    # aggregate() and the bench sidecars
                    "samples": [round(float(v), 9) for v in h[4]],
                    **quantile_summary(h[4]),
                })
            return out

    def prune_labels(self, **labels) -> int:
        """Delete every series whose label set CONTAINS all the given
        ``key=value`` pairs (round 15: the tenant-churn label-space
        prune — a removed pool tenant's ``tenant=...`` series must not
        live in the registry, and its scrape surface, forever).
        Returns the number of series removed."""
        items = tuple(labels.items())
        if not items:
            return 0

        def hit(lk: tuple) -> bool:
            d = dict(lk)
            return all(d.get(k) == v for k, v in items)

        removed = 0
        with self._lock:
            for store in (self._counters, self._gauges, self._hists):
                dead = [k for k in store if hit(k[1])]
                for k in dead:
                    del store[k]
                removed += len(dead)
        return removed

    def clear(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
