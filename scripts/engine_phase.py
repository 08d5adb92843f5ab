#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (the serving engine and the mutation lane)
alone, on a card.

    python3 scripts/engine_phase.py

Builds the phase's two graphs afresh with ``chip_smoke.py``'s recipe (R-MAT
scale 20 with its CSR arrays and roots, as phase 8 keeps them, and the
scale-18 graph of phase 10), then runs ``chip_smoke.phase_engine``: the same
steps, checks and JSON lines as in the whole script, in a few minutes
instead of twenty. Exits 1 without a card.
"""

from __future__ import annotations

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
    if not torch.cuda.is_available():
        print("engine_phase: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    # a fresh plan store of the script's own, as chip_smoke.main gives
    shutil.rmtree(cs.PLAN_STORE_DIR, ignore_errors=True)
    os.environ[cs.tuner_config.ENV_PLAN_STORE] = str(cs.PLAN_STORE_DIR)
    try:
        return run()
    finally:
        shutil.rmtree(cs.PLAN_STORE_DIR, ignore_errors=True)


def run() -> int:
    cs.phase_card()
    t = time.perf_counter()
    g = build_graph(cs.BFS_SCALE, cs.BFS_EDGEFACTOR, cs.BFS_NROOTS)
    _, (indptr, rowidx) = build_structures(g["rows"], g["cols"], 1 << cs.BFS_SCALE)
    csr_host = {"indptr": indptr[0, 0], "cols": rowidx[0, 0]}
    roots = g["roots"][:cs.ENGINE_ROOTS].copy()
    del g
    g18 = build_graph(cs.MATCH_SCALE, cs.BFS_EDGEFACTOR, nroots=1)
    cs.emit({"driver": "graphs", "s": time.perf_counter() - t})
    cs.phase_engine(torch.device("cuda"), time.perf_counter(), csr_host, roots, g18)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
