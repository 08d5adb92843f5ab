#!/usr/bin/env python3
"""Time formulations of ``expand_ranges`` beside the package's, on a card.

    python3 scripts/expand_ranges_compare.py

``combblas_tpu_torch.ops.segment.expand_ranges`` maps each of ``capacity``
slots to the source range it falls into. Three formulations give the same
four outputs for every input: the package's (binary search of the slot
number in the starts), the reference's (scatter-max of each source's index
at its start, then a cumulative max; the port's formulation until the
search replaced it) and a counting one (scatter-add of ones at the starts,
then a cumulative sum). This script holds the other two, checks all three
equal on each case and times them in turns (package, scatter+cummax,
scatter+cumsum, then back), CUDA events, one JSON line per case.

Cases: the union-frontier step of the batched BFS at Graph500 scale 20
(2**17 frontier slots into 2**21 edge slots, short and long totals) and
the row expansion of ``sparsify`` at the SpGEMM path's output (8192 rows
into 13.4 M slots), lengths from a seeded generator.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from combblas_tpu_torch.ops.segment import expand_ranges  # noqa: E402


def _starts(lens):
    lens = lens.to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=lens.device)
    return torch.cat([zero, torch.cumsum(lens, 0, dtype=torch.int32)])


def expand_ranges_cummax(lens: torch.Tensor, capacity: int):
    """Scatter-max at the starts (those at or past ``capacity`` go to a sink
    slot that is cut off), then ``torch.cummax``; the same for the bases."""
    dev, n = lens.device, lens.shape[0]
    starts = _starts(lens)
    pos = starts[:-1]
    sink = torch.clamp(pos, max=capacity).long()
    seed = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    seed.scatter_reduce_(0, sink, torch.arange(n, dtype=torch.int32, device=dev), "amax")
    owner = torch.clamp(torch.cummax(seed[:capacity], 0).values, 0, n - 1)
    base = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    base.scatter_reduce_(0, sink, pos, "amax")
    base = torch.cummax(base[:capacity], 0).values
    f = torch.arange(capacity, dtype=torch.int32, device=dev)
    return owner, f - base, f < starts[-1], starts[-1]


def expand_ranges_cumsum(lens: torch.Tensor, capacity: int):
    """Count the sources that start at or before each slot: ones added at
    the starts, then ``torch.cumsum``; the base is a gather."""
    dev, n = lens.device, lens.shape[0]
    starts = _starts(lens)
    sink = torch.clamp(starts[:-1], max=capacity).long()
    begun = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    begun.index_add_(0, sink, torch.ones(n, dtype=torch.int32, device=dev))
    owner = torch.clamp(torch.cumsum(begun[:capacity], 0, dtype=torch.int32) - 1, 0, n - 1)
    f = torch.arange(capacity, dtype=torch.int32, device=dev)
    return owner, f - starts.index_select(0, owner), f < starts[-1], starts[-1]


FORMS = {"package (searchsorted)": expand_ranges, "scatter-max + cummax": expand_ranges_cummax,
         "scatter-add + cumsum": expand_ranges_cumsum}


def time_ms(fn, reps: int) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("expand_ranges_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    cases = {
        # mean length 8: the slots a quarter filled; mean 24: past the capacity
        "bfs-union-step-short": (rng.poisson(4, 1 << 17) * (rng.random(1 << 17) < 0.5), 1 << 21),
        "bfs-union-step-over": (rng.poisson(24, 1 << 17), 1 << 21),
        "sparsify-rows": (rng.poisson(1640, 8192), 13_439_626),
    }
    for name, (lens, capacity) in cases.items():
        lens = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
        want = expand_ranges_cummax(lens, capacity)
        for form, fn in FORMS.items():
            got = fn(lens, capacity)
            for field, g, w in zip(("owner", "offset", "valid", "total"), got, want):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"{name}: {form} differs in {field}")
        turns = {form: [] for form in FORMS}
        for form in (*FORMS, *reversed(FORMS)):
            turns[form].append(time_ms(lambda: FORMS[form](lens, capacity), 10))
        print(json.dumps({
            "case": name, "sources": lens.numel(), "capacity": capacity,
            "total": int(want[3]), "equal": True,
            "ms": {form: sum(t) / len(t) for form, t in turns.items()}, "turns_ms": turns,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
