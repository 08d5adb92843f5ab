#!/usr/bin/env python3
"""Time this checkout's dense -> sparse compaction kernel (K2,
``combblas_tpu_torch/csrc/dense_to_tuples.cu``) beside another checkout's,
in turns, on one CUDA card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k2_compare.py --parent DIR [--reps 10]

``DIR`` is another checkout of the repository (``git archive <commit>``
unpacked there) whose K2 has the earlier five-launch interface
(``dense_to_tuples_f32(x, R, pr, cap_rows, zero, work, idx, vals,
stream)``); it is built by that checkout's own ``_build``. The script
prints each build's registers and spills, checks both against the plain
version (this checkout's at both instantiations), then times the parent
and this checkout's default instantiation in turns (parent, this, this,
parent) over a density sweep at 8192 x 8192, at 16384 x 16384 (5%), with
8-row panels and with one panel of 2^15 rows, each beside its bound. One
JSON line per result.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import FULL, emit, k2_bound, random_dense, time_cuda_ms  # noqa: E402
from combblas_tpu_torch import _build, flat_to_tuples_arrays  # noqa: E402
from combblas_tpu_torch import flat_to_tuples_arrays_reference  # noqa: E402
from combblas_tpu_torch.ops.dense_to_tuples import VARIANTS, _panels  # noqa: E402


class ParentK2:
    """The other checkout's launcher, called through ctypes with the
    scratch it expects (tile counts and prefixes, panel totals and
    offsets, total, end_row)."""

    def __init__(self, path):
        self.fn = ctypes.CDLL(path).dense_to_tuples_f32
        self.fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float]
                            + [ctypes.c_void_p] * 4)
        self.fn.restype = ctypes.c_int

    def __call__(self, xf, *, zero=0.0, capacity, panel_rows=8192):
        pr, cap_rows = _panels(xf, capacity, panel_rows)
        R = xf.shape[0]
        idx = torch.empty(cap_rows * 128, dtype=torch.int32, device=xf.device)
        vals = torch.empty(cap_rows * 128, dtype=torch.float32, device=xf.device)
        work = torch.empty(2 * (R // 8) + 2 * (R // pr) + 2, dtype=torch.int32, device=xf.device)
        err = self.fn(xf.data_ptr(), R, pr, cap_rows, zero, work.data_ptr(), idx.data_ptr(),
                      vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K2 launch failed: CUDA error {err}")
        return idx, vals, work[-2], work[-1]


def build_parent(root: Path) -> dict:
    """Build ``csrc/dense_to_tuples.cu`` of the checkout at ``root`` with
    that checkout's own ``_build``."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", root / "combblas_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    report = mod.build(["dense_to_tuples"])["dense_to_tuples"]
    report.setdefault("path", str(mod.library_path("dense_to_tuples")))
    return report


def same(got, want) -> bool:
    """Equal total and end_row, and equal idx and vals (as bits) below
    end_row * 128 (the parent leaves the slots past it as the reference
    does: undefined)."""
    end = int(want[3]) * 128
    return (int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])
            and torch.equal(got[0][:end], want[0][:end])
            and torch.equal(got[1][:end].view(torch.int32), want[1][:end].view(torch.int32)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    reports = {"parent": build_parent(args.parent.resolve()),
               "this": _build.build(["dense_to_tuples"])["dense_to_tuples"]}
    for name, report in reports.items():
        emit({"build": name, "seconds": report["seconds"],
              "ptxas": [ln.strip() for ln in report["log"].splitlines()
                        if "registers" in ln or "spill" in ln]})
    parent = ParentK2(reports["parent"]["path"])
    cases = []
    for pct in (0.0, 0.1, 5.0, 20.0, 50.0, 100.0):
        cases.append((f"sweep-{FULL}-{pct}%", (FULL, FULL), pct, 8192))
    cases += [(f"pr8-{FULL}-5.0%", (FULL, FULL), 5.0, 8),
              (f"tall-panel-{FULL}-5.0%", (FULL, FULL), 5.0, 1 << 15),
              (f"{2 * FULL}-5.0%", (2 * FULL, 2 * FULL), 5.0, 8192)]
    for case, shape, pct, panel_rows in cases:
        xf = random_dense(shape, pct / 100, 4, dev).view(-1, 128)
        kw = dict(capacity=int((xf != 0).sum()), panel_rows=panel_rows)
        want = flat_to_tuples_arrays_reference(xf, **kw)
        if not same(parent(xf, **kw), want):
            raise AssertionError(f"{case}: parent != plain")
        for variant in VARIANTS:
            if not same(flat_to_tuples_arrays(xf, variant=variant, **kw), want):
                raise AssertionError(f"{case}: this ({variant}) != plain")
        flat_to_tuples_arrays(xf, **kw)
        row = {"case": case, "shape": list(shape), "panel_rows": panel_rows,
               "capacity": kw["capacity"], "variant": flat_to_tuples_arrays.last_variant}
        calls = {"parent": lambda: parent(xf, **kw),
                 "this": lambda: flat_to_tuples_arrays(xf, **kw)}
        for name in ("parent", "this", "this", "parent"):
            row.setdefault(name, []).append(time_cuda_ms(calls[name], args.reps))
        row["bound_ms"], row["bound_by"] = k2_bound(xf.numel(), want[0].numel())
        for name in ("parent", "this"):
            row[f"{name}_share_of_bound"] = row["bound_ms"] / (sum(row[name]) / 2)
        emit(row)
        del xf, want
        torch.cuda.empty_cache()
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
