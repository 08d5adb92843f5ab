#!/usr/bin/env python3
"""Time this checkout's semiring GEMM kernel (K1,
``combblas_tpu_torch/csrc/semiring_mm.cu``) beside another checkout's, in
turns, on one CUDA card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k1_compare.py --parent DIR [--shape 8192] [--reps 5]

``DIR`` is another checkout of the repository (``git archive <commit>``
unpacked there); its K1 is built by that checkout's own ``_build``. For
each build the script prints ``-Xptxas -v``'s registers and spills and,
per kind, the instructions of the kernel's main loop (``cuobjdump
-sass``); checks both against the plain version at 1024^3 and at a
ragged shape (this checkout's at both instantiations); then times every
kind at ``shape``^3 in turns (parent, this, this, parent), and
``torch.matmul`` beside plus_times, with the SM clock, power draw and
temperature that ``nvidia-smi`` reads while the card is still busy with
the same kernel (``chip_smoke.time_with_clock``, on
``chip_smoke.operands``). One JSON line per result.
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

from chip_smoke import emit, operands, time_with_clock  # noqa: E402
from combblas_tpu_torch import _build  # noqa: E402
from combblas_tpu_torch.ops.semiring_matmul import (  # noqa: E402
    KINDS,
    main_loop_counts,
    semiring_matmul_reference,
)


class Lib:
    """One build's launchers, called through ctypes. A kernel without an
    edge instantiation (``parent``) takes every shape in its one."""

    def __init__(self, path):
        self.cdll = ctypes.CDLL(path)
        self.has_edge = hasattr(self.cdll, "semiring_mm_min_plus_edge")

    def __call__(self, kind, a, b, c, edge=False):
        fn = getattr(self.cdll, f"semiring_mm_{kind}{'_edge' if edge and self.has_edge else ''}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        m, k = a.shape
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, c.shape[1], k,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
        return c


def build_parent(root: Path) -> dict:
    """Build ``csrc/semiring_mm.cu`` of the checkout at ``root`` with that
    checkout's own ``_build`` (its flags, its build directory)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", root / "combblas_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    report = mod.build(["semiring_mm"])["semiring_mm"]
    report.setdefault("path", str(mod.library_path("semiring_mm")))
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    names = ("parent", "this")
    libs = {}
    for name in names:
        if name == "parent":
            report = build_parent(args.parent.resolve())
        else:
            report = _build.build(["semiring_mm"])["semiring_mm"]
        libs[name] = Lib(report["path"])
        ptxas = [ln.strip() for ln in report["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"build": name, "seconds": report["seconds"], "ptxas": ptxas,
              "main_loop": main_loop_counts(report["path"])})
    for name in names:
        for kind in KINDS:
            for shape, edge in (((1024, 1024, 1024), False), ((1024, 1024, 1024), True),
                                ((1000, 777, 1234), True)):
                a, b = operands(kind, *shape, seed=sum(shape), dev=dev)
                c = torch.empty((shape[0], shape[2]), device=dev)
                got = libs[name](kind, a, b, c, edge)
                torch.cuda.synchronize()
                if not torch.equal(got, semiring_matmul_reference(kind, a, b)):
                    raise AssertionError(f"{name} {kind} {shape} edge={edge}: != plain")
        emit({"build": name, "checked": True})
    s = args.shape
    for kind in KINDS:
        a, b = operands(kind, s, s, s, seed=1, dev=dev)
        c = torch.empty((s, s), device=dev)
        row = {"kind": kind, "shape": s}
        for name in (*names, *names[::-1]):
            ms, card = time_with_clock(lambda: libs[name](kind, a, b, c), args.reps)
            row.setdefault(name, []).append({"ms": ms, **card})
        if kind == "plus_times":
            ms, card = time_with_clock(lambda: torch.matmul(a, b, out=c), args.reps)
            row["torch.matmul"] = {"ms": ms, **card}
        emit(row)
        del a, b, c
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
