#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` (the grid over several processes) alone,
on a card.

    python3 scripts/multiproc_phase.py [--nccl-probe]

Builds the kernels (phase 2), then phase 23's inputs afresh with
``chip_smoke.py``'s recipes: phase 8's scale-20 graph (its row-sorted COO is
the CSR arrays phase 8 keeps: the graph is symmetric),
phase 5's scale-13 graph, and phase 13's scale-18 Matrix Market file
(``write_mm`` of phase 10's graph); then runs ``chip_smoke.phase_multiproc``
with the same steps, checks and JSON lines as in the whole script.

``--nccl-probe`` runs, instead of phase 23, two ranks on the card over
NCCL (``NCCL_DEBUG=WARN``), each one ``all_reduce`` of a CUDA tensor, and
prints how it ends: NCCL takes one rank a card, so it is expected to refuse
two ranks on one card; phase 23 runs gloo on CUDA tensors instead. Exits 1
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from combblas_tpu_torch.io.mm import write_mm  # noqa: E402
from combblas_tpu_torch.parallel import multihost  # noqa: E402
from combblas_tpu_torch.utils.graph500 import build_graph  # noqa: E402
from combblas_tpu_torch.utils.rmat import rmat_symmetric_coo_host  # noqa: E402

NCCL_PROBE_TIMEOUT_S = 60.0


def nccl_probe() -> str:
    """A rank's one ``all_reduce`` of a CUDA tensor (``launch`` runs it
    over NCCL)."""
    t = torch.ones(4, device=multihost.device()) * (multihost.rank() + 1)
    multihost.all_reduce_(t)
    torch.cuda.synchronize()
    return f"all_reduce gave {t.tolist()}"


def probe_nccl() -> dict:
    t0 = time.perf_counter()
    try:
        got = multihost.launch(f"{Path(__file__).resolve()}:nccl_probe", 2, device="cuda",
                               backend="nccl", timeout_s=NCCL_PROBE_TIMEOUT_S,
                               env={**os.environ, "NCCL_DEBUG": "WARN"})
        return {"ran": True, "results": got, "s": time.perf_counter() - t0}
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines()
                 if "Error" in ln or "NCCL" in ln or "Duplicate" in ln]
        return {"ran": False, "error_lines": lines[-12:], "s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nccl-probe", action="store_true",
                    help="instead, try two NCCL ranks on the one card and print how it ends")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multiproc_phase: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 1
    shutil.rmtree(cs.PLAN_STORE_DIR, ignore_errors=True)
    os.environ[cs.tuner_config.ENV_PLAN_STORE] = str(cs.PLAN_STORE_DIR)
    try:
        cs.phase_card()
        if args.nccl_probe:
            cs.emit({"script": "multiproc_phase", "step": "nccl_probe", **probe_nccl()})
            return 0
        cs.phase_build()
        dev, t = torch.device("cuda"), time.perf_counter()
        g = build_graph(cs.BFS_SCALE, cs.BFS_EDGEFACTOR, cs.BFS_NROOTS, device=dev)
        # the graph is symmetric and its COO sorted by row: phase 8's CSC arrays
        csr_host = {"indptr": np.concatenate([[0], np.cumsum(g["deg"], dtype=np.int64)]),
                    "cols": g["cols"]}
        del g
        r, c = rmat_symmetric_coo_host(cs.GRAPH_SEED, cs.SCALE, cs.EDGEFACTOR)
        v = np.random.default_rng(cs.WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(
            np.float32)
        g18 = build_graph(cs.GI_IO_SCALE, cs.BFS_EDGEFACTOR, nroots=1, device=dev)
        cs.MULTIPROC_DIR.mkdir(parents=True, exist_ok=True)
        n18 = 1 << cs.GI_IO_SCALE
        write_mm(str(cs.MULTIPROC_MM), (g18["rows"].astype(np.int64),
                                        g18["cols"].astype(np.int64),
                                        np.ones(len(g18["rows"])), n18, n18))
        del g18
        cs.emit({"script": "multiproc_phase", "step": "inputs", "s": time.perf_counter() - t})
        p21 = {"csr_host": csr_host}
        out = cs.phase_multiproc(dev, time.perf_counter(), p21, (r, c, v))
        print(json.dumps({"ok": True, "k1": out["k1"]}))
        return 0
    finally:
        for d in (cs.PLAN_STORE_DIR, cs.MULTIPROC_DIR):
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
