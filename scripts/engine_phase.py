#!/usr/bin/env python3
"""Phases 17 to 22 of ``chip_smoke.py`` (the serving engine and the
mutation lane, the ``Server`` on them, the tenant pool and the replica
fleet, the process fleet, sharded serving, then the network front door)
alone, on a card.

    python3 scripts/engine_phase.py [--net-only]

Builds phase 17's two graphs afresh with ``chip_smoke.py``'s recipe (R-MAT
scale 20 with its CSR arrays and roots, as phase 8 keeps them, and the
scale-18 graph of phase 10), then runs ``chip_smoke.phase_engine``,
``chip_smoke.phase_server``, ``chip_smoke.phase_fleet``,
``chip_smoke.phase_procfleet`` (on a snapshot of the scale-18 graph) and
``chip_smoke.phase_shard`` (on both graphs and phase 17's lanes) and
``chip_smoke.phase_net`` (on phase 17's inputs): the same steps, checks
and JSON lines as in the whole script, in a few minutes instead of
twenty. ``--net-only`` runs phase 17, which phase 22 takes its lanes
from, then phase 22. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from combblas_tpu_torch.utils.graph500 import build_graph, build_structures  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net-only", action="store_true",
                    help="phase 17, then phase 22 (skip phases 18-21)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("engine_phase: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    # a fresh plan store of the script's own, as chip_smoke.main gives
    shutil.rmtree(cs.PLAN_STORE_DIR, ignore_errors=True)
    os.environ[cs.tuner_config.ENV_PLAN_STORE] = str(cs.PLAN_STORE_DIR)
    try:
        return run(args.net_only)
    finally:
        for d in (cs.PLAN_STORE_DIR, cs.DUR_DIR, cs.FLEET_DIR, cs.PROCFLEET_DIR, cs.SHARD_DIR):
            shutil.rmtree(d, ignore_errors=True)


def run(net_only: bool = False) -> int:
    cs.phase_card()
    dev, t = torch.device("cuda"), time.perf_counter()
    g = build_graph(cs.BFS_SCALE, cs.BFS_EDGEFACTOR, cs.BFS_NROOTS, device=dev)
    _, (indptr, rowidx) = build_structures(g["rows"], g["cols"], 1 << cs.BFS_SCALE)
    csr_host = {"indptr": indptr[0, 0], "cols": rowidx[0, 0]}
    roots = g["roots"][:cs.ENGINE_ROOTS].copy()
    del g
    g18 = build_graph(cs.MATCH_SCALE, cs.BFS_EDGEFACTOR, nroots=1, device=dev)
    cs.emit({"driver": "graphs", "s": time.perf_counter() - t})
    t0 = time.perf_counter()
    engine = cs.phase_engine(dev, t0, csr_host, roots, g18)
    if not net_only:
        cs.phase_server(dev, t0, engine, roots)
        fleet = cs.phase_fleet(dev, t0, engine, roots)
    p17 = {"roots": roots, "lanes16": engine["serve"]["lanes16"],
           "pair": engine["churn"]["pairs"][-1]}
    p21 = cs.shard_inputs(p17, engine, csr_host, g18)
    del engine["serve"], engine["dur"], g18
    torch.cuda.empty_cache()
    if not net_only:
        cs.phase_procfleet(dev, t0, p21["g18"], p21["pair18"],
                           fleet["replicas"]["requests_per_s"])
        torch.cuda.empty_cache()
        cs.phase_shard(dev, t0, p21)
        torch.cuda.empty_cache()
    cs.phase_net(dev, t0, p21)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
