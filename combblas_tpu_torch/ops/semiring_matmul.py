"""Dense semiring matrix product — counterpart of ``ops/pallas_kernels.py``.

``C[i,j] = ⊕_k a[i,k] ⊗ b[k,j]`` for the four kinds of the reference's
``_FOLDS``: ``min_plus``, ``max_plus``, ``max_min`` and ``plus_times``.
XLA had no tropical lowering, so the JAX package wrote it in Pallas; here
the kernel is hand-written CUDA (``csrc/semiring_mm.cu``), and
``semiring_matmul_reference`` is its plain PyTorch version.

Dispatch: tensors on the CPU take the plain version; CUDA tensors launch
the kernel or raise. ``semiring_matmul.launches`` counts kernel launches
and ``semiring_matmul.last_variant`` names the instantiation that ran.
Unlike the Pallas kernel, any shape is accepted: the kernel has a tiled
instantiation for shapes that are multiples of its tile (``TILE``) with
16-byte-aligned operands, and an edge instantiation that masks ragged
edges and takes everything else (``kernel_variant``).
"""

from __future__ import annotations

import ctypes
import re
from collections import Counter

import torch

from .. import _build

#: kind -> (fold, elementwise product, fold identity); the products are the
#: reference's plain ``jnp.add`` / ``jnp.minimum`` / ``jnp.multiply``.
_FOLDS = {
    "min_plus": (torch.minimum, torch.add, float("inf")),
    "max_plus": (torch.maximum, torch.add, -float("inf")),
    "max_min": (torch.maximum, torch.minimum, -float("inf")),
    "plus_times": (torch.add, torch.mul, 0.0),
}
_REDUCE = {torch.minimum: torch.amin, torch.maximum: torch.amax, torch.add: torch.sum}
KINDS = tuple(_FOLDS)
#: (bm, bn, bk): the tiled instantiation needs m % bm == n % bn == k % bk == 0
#: (``BM``, ``BN``, ``BK`` in ``csrc/semiring_mm.cu``, whose launcher refuses
#: any other shape)
TILE = (128, 128, 16)
#: instructions per semiring step: FFMA; FADD + FMNMX; FMNMX + FMNMX
_STEP_INSNS = {"min_plus": 2, "max_plus": 2, "max_min": 2, "plus_times": 1}


def _check(kind: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if kind not in _FOLDS:
        raise ValueError(f"unknown semiring kind {kind!r}; expected one of {KINDS}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} do not chain")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"float32 operands only, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def semiring_matmul_reference(
    kind: str, a: torch.Tensor, b: torch.Tensor, *, chunk_elems: int = 1 << 24
) -> torch.Tensor:
    """Plain PyTorch version: fold k in chunks so that no ``[m, k, n]``
    tensor is built (one ``[m, c, n]`` product of at most ``chunk_elems``
    cells per chunk, c >= 1)."""
    _check(kind, a, b)
    add, mul, zero = _FOLDS[kind]
    reduce = _REDUCE[add]
    m, k = a.shape
    n = b.shape[1]
    out = torch.full((m, n), zero, dtype=a.dtype, device=a.device)
    step = max(1, min(k, chunk_elems // max(m * n, 1)))
    for k0 in range(0, k, step):
        prods = mul(a[:, k0 : k0 + step, None], b[None, k0 : k0 + step, :])
        out = add(out, reduce(prods, dim=1))
    return out


def kernel_variant(m: int, k: int, n: int, *ptrs: int) -> str:
    """Which instantiation of the kernel takes an m×k by k×n product whose
    operand and output buffers start at ``ptrs``: "tiled" when the shape is
    a multiple of ``TILE`` and every pointer is 16-byte aligned, else
    "edge"."""
    bm, bn, bk = TILE
    if m % bm == 0 and n % bn == 0 and k % bk == 0 and all(p % 16 == 0 for p in ptrs):
        return "tiled"
    return "edge"


def semiring_matmul(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``C = a ⊗ b`` over ``kind``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check(kind, a, b)
    if a.device.type == "cpu":
        return semiring_matmul_reference(kind, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"semiring_matmul runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("semiring_matmul needs contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 1 << 31:
        raise ValueError(f"dims {(m, k, n)} exceed the kernel's int32 range")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    ptrs = (a.data_ptr(), b.data_ptr(), c.data_ptr())
    variant = kernel_variant(m, k, n, *ptrs)
    fn = _kernel(kind, variant)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"semiring_mm_{kind} ({variant}) launch failed: CUDA error {err}")
    semiring_matmul.launches += 1
    semiring_matmul.last_variant = variant
    return c


semiring_matmul.launches = 0
semiring_matmul.last_variant = None


def _kernel(kind: str, variant: str):
    suffix = "" if variant == "tiled" else "_edge"
    fn = getattr(_build.load("semiring_mm"), f"semiring_mm_{kind}{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# /*0450*/  @!P0 FFMA.FTZ R4, R5, R6, R4 ;  -> address, opcode, modifiers, operands
_SASS_INSN = re.compile(
    r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);"
)
_SASS_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")
#: the instructions that are semiring steps: FFMA (plus_times), FADD and
#: FMNMX (the tropical kinds)
SEMIRING_OPS = ("FFMA", "FADD", "FMNMX")


def main_loops(sass: str) -> dict[str, Counter]:
    """Per function of a ``cuobjdump -sass`` (or ``nvdisasm``) listing, the
    opcode counts (modifiers dropped) of its main loop, with the key
    ``"total"`` for all its instructions. The main loop is the body of the
    backward branch that holds the most semiring steps (``SEMIRING_OPS``),
    the shortest such body on a tie. Functions without a backward branch
    are left out."""
    funcs: dict[str, tuple[list, dict]] = {}
    insns: list = []
    labels: dict = {}
    pending: list = []
    for line in sass.splitlines():
        fm = _SASS_FUNCTION.search(line)
        if fm:
            insns, labels, pending = [], {}, []
            funcs[fm.group(1)] = (insns, labels)
            continue
        lm = _SASS_LABEL.match(line)
        if lm:
            pending.append(lm.group(1))
            continue
        im = _SASS_INSN.search(line)
        if im and funcs:
            addr = int(im.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            insns.append((addr, im.group(2), im.group(4)))
    out = {}
    for fname, (insns, labels) in funcs.items():
        best = None
        for addr, op, args in insns:
            target = _SASS_TARGET.search(args) if op == "BRA" else None
            if target is None:
                continue
            tgt = target.group(1)
            start = labels.get(tgt) if tgt.startswith(".") else int(tgt, 16)
            if start is None or start > addr:
                continue
            body = Counter(o for a, o, _ in insns if start <= a <= addr)
            key = (sum(body[o] for o in SEMIRING_OPS), -sum(body.values()))
            if best is None or key > best[0]:
                best = (key, body)
        if best is not None:
            best[1]["total"] = sum(best[1].values())
            out[fname] = best[1]
    return out


def main_loop_counts(library=None) -> dict[str, dict[str, dict]]:
    """Per kind and instantiation ("tiled", "edge"), the instructions of
    the built kernel's main loop, read from its machine code: the FFMA,
    FADD, FMNMX and LDS counts, ``total``, the semiring ``steps`` one pass
    makes per thread, and ``insns_per_step`` (``total / steps``). Needs the
    CUDA toolkit's ``cuobjdump``. ``library`` is the path of a build
    (default: the one ``semiring_matmul`` loads); a kernel with one
    instantiation counts as "tiled"."""
    out: dict[str, dict[str, dict]] = {}
    path = _build.library_path("semiring_mm") if library is None else library
    for fname, counts in main_loops(_build.disassemble(path)).items():
        found = re.search(r"semiring_mm_kernelILi(\d)E(?:Lb([01])E)?", fname)
        if found is None:
            continue
        kind = KINDS[int(found.group(1))]
        steps = sum(counts[o] for o in SEMIRING_OPS) / _STEP_INSNS[kind]
        entry = {o: counts[o] for o in (*SEMIRING_OPS, "LDS")}
        entry.update(total=counts["total"], steps=steps,
                     insns_per_step=counts["total"] / steps if steps else None)
        out.setdefault(kind, {})["edge" if found.group(2) == "1" else "tiled"] = entry
    return out


def min_plus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical matmul — the APSP / repeated-squaring building block."""
    return semiring_matmul("min_plus", a, b)
