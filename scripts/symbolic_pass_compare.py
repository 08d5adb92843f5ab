#!/usr/bin/env python3
"""Time this checkout's SpGEMM symbolic pass, ESC product and mxu-tier
``spgemm_auto`` beside another checkout's, in turns, on one CUDA card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/symbolic_pass_compare.py --parent DIR [--reps 5]

``DIR`` is another checkout of the repository (``git archive <commit>``
unpacked there). Each turn is a fresh process that imports the package of
one checkout (parent, this, this, parent) and, on ``chip_smoke.py``'s
scale-13 R-MAT (phase 5's graph, min_plus, duplicates folded), times with
CUDA events, after one warm-up:

  * ``summa_capacities`` (the symbolic pass and its one readback) on a
    2 x 2 and a 4 x 4 one-process grid;
  * ``spgemm`` (the ESC tier, which runs the symbolic pass) on 2 x 2;
  * ``spgemm_auto`` on a 1 x 1 grid, phase 5's product (the mxu tier, K1).

Each turn prints one JSON line with its times and a digest of every
result; the script then checks that all turns give the same digests and
prints the card's name and power limit. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def turn(root: str, reps: int) -> dict:
    """One checkout's times and digests (runs in its own process)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from combblas_tpu_torch import MIN_PLUS, Grid, SpParMat, spgemm, spgemm_auto
    from combblas_tpu_torch.parallel.spgemm import summa_capacities, summa_stage_flops

    dev = torch.device("cuda")
    r, c = cs.rmat_symmetric_coo_host(cs.GRAPH_SEED, cs.SCALE, cs.EDGEFACTOR)
    v = np.random.default_rng(cs.WEIGHT_SEED).integers(1, 16, r.shape[0]).astype(np.float32)

    def matrix(p):
        return SpParMat.from_global_coo(Grid.make(p, p, device=dev), r, c, v, cs.FULL, cs.FULL,
                                        dedup_sr=MIN_PLUS)

    out = {"root": root}
    for p in (2, 4):
        A = matrix(p)
        out[f"stage_flops_{p}x{p}"] = _digest(summa_stage_flops(A, A))
        out[f"capacities_{p}x{p}"] = list(summa_capacities(A, A))
        out[f"symbolic_{p}x{p}_ms"] = cs.time_cuda_ms(lambda A=A: summa_capacities(A, A), reps)
        if p == 2:
            C = spgemm(MIN_PLUS, A, A)
            out["esc_2x2"] = _digest(C.rows, C.cols, C.vals, C.nnz)
            out["esc_2x2_ms"] = cs.time_cuda_ms(lambda A=A: spgemm(MIN_PLUS, A, A), reps)
        del A
    A = matrix(1)
    C = spgemm_auto(MIN_PLUS, A, A)
    out["tier"] = spgemm_auto.last_run["tier"]
    out["auto_1x1"] = _digest(C.rows, C.cols, C.vals, C.nnz)
    out["auto_1x1_ms"] = cs.time_cuda_ms(lambda: spgemm_auto(MIN_PLUS, A, A), reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("symbolic_pass_compare: needs a CUDA card and --parent", file=sys.stderr)
        return 1
    this, parent = str(HERE.parent.parent), str(Path(args.parent).resolve())
    runs = []
    for name, root in (("parent", parent), ("this", this), ("this", this), ("parent", parent)):
        got = subprocess.run([sys.executable, str(HERE), "--turn", root, "--reps",
                              str(args.reps)], capture_output=True, text=True, timeout=600,
                             cwd=root)
        if got.returncode:
            print(got.stderr[-4000:], file=sys.stderr)
            return 1
        res = {"checkout": name, **json.loads(got.stdout.strip().splitlines()[-1])}
        print(json.dumps(res), flush=True)
        runs.append(res)
    keys = [k for k in runs[0] if not k.endswith("_ms") and k not in ("root", "checkout")]
    same = all(r[k] == runs[0][k] for r in runs for k in keys)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"same_results": same, "card": card.strip()}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
