"""Dense semiring matrix product — counterpart of ``ops/pallas_kernels.py``.

``C[i,j] = ⊕_k a[i,k] ⊗ b[k,j]`` for the four kinds of the reference's
``_FOLDS``: ``min_plus``, ``max_plus``, ``max_min`` and ``plus_times``.
XLA had no tropical lowering, so the JAX package wrote it in Pallas; here
the kernel is hand-written CUDA (``csrc/semiring_mm.cu``), and
``semiring_matmul_reference`` is its plain PyTorch version.

Dispatch: tensors on the CPU take the plain version; CUDA tensors launch
the kernel or raise. ``semiring_matmul.launches`` counts kernel launches.
Unlike the Pallas kernel, any shape is accepted: the kernel masks ragged
edges itself, so callers need not pad to block multiples.
"""

from __future__ import annotations

import ctypes

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
    fn = _kernel(kind)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"semiring_mm_{kind} launch failed: CUDA error {err}")
    semiring_matmul.launches += 1
    return c


semiring_matmul.launches = 0


def _kernel(kind: str):
    fn = getattr(_build.load("semiring_mm"), f"semiring_mm_{kind}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def min_plus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical matmul — the APSP / repeated-squaring building block."""
    return semiring_matmul("min_plus", a, b)
