"""Dense -> sparse compaction — counterpart of ``ops/pallas_sparsify.py``.

``flat_to_tuples_arrays`` compacts the cells ``!= zero`` of a flat
row-major ``[R, 128]`` view into (global flat index, value) pairs in
row-major order, with the exact count ``total`` and the end row
``end_row``. The JAX package wrote it in Pallas for the TPU; here the
kernel is hand-written CUDA (``csrc/dense_to_tuples.cu``), and
``flat_to_tuples_arrays_reference`` is its plain PyTorch version.

The output contract is the reference's, slot for slot:

- The view is cut into panels of ``pr = gcd(R, min(panel_rows, R))`` rows
  (``pr % 8 == 0``). The output has ``cap_rows * 128`` slots, where
  ``cap_rows = ceil8(ceil(capacity / 128)) + 8 * npanels``: it can hold
  more live entries than ``capacity``.
- Panels are placed greedily, in order, at a running row offset ``off``.
  A panel with ``total_p`` nonzeros takes ``rows_used8 = 8 *
  ceil(total_p / 1024)`` rows and is written only if ``total_p > 0`` and
  ``off + rows_used8 <= cap_rows``; only a written panel advances ``off``.
  A panel that does not fit is dropped whole, and a later smaller one may
  still be written.
- A written panel's entries start at slot ``off * 128``; the slots from
  its last entry up to ``(off + rows_used8) * 128`` hold index ``-1`` and
  value ``zero``. ``total`` sums every panel (exact past capacity) and
  ``end_row`` is the final ``off``. Live slots are exactly
  ``(idx >= 0) & (slot < end_row * 128)``. Slots at or past
  ``end_row * 128`` are undefined in the reference; here they hold ``-1``
  and ``zero``.
- The mask is the float compare ``x != zero``: ``-0.0`` counts as zero,
  NaN as a nonzero.

Dispatch: tensors on the CPU take the plain version; CUDA tensors launch
the kernel (float32 only) or raise. The kernel has two instantiations:
"single" reads the input once, keeping each chunk in shared memory until
its panel is placed, so a panel's chunks must fit in the blocks the card
holds at once (its launcher refuses the rest); "two_pass" reads it twice
and takes any panel height. ``kernel_variant`` picks one unless the caller
names it. ``flat_to_tuples_arrays.launches`` counts kernel launches and
``flat_to_tuples_arrays.last_variant`` names the instantiation that ran.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from .tuples import SpTuples

#: Flat-view panel height (x128 lanes = 1M elements per panel).
_PANEL_ROWS = 8192
#: The kernel's largest chunk, the rows one block compacts
#: (``MAX_CHUNK_ROWS`` in ``csrc/dense_to_tuples.cu``).
_MAX_CHUNK_ROWS = 64
VARIANTS = ("single", "two_pass")
#: cudaErrorInvalidConfiguration: the single-pass launcher's refusal
_REFUSED = 9


def chunk_rows(pr: int) -> int:
    """Rows of the kernel's chunk for panels of ``pr`` rows: the largest of
    64, 32, 16 and 8 that divides ``pr``, so that no chunk straddles two
    panels."""
    return 8 * math.gcd(pr // 8, _MAX_CHUNK_ROWS // 8)


def kernel_variant(pr: int, resident_blocks: int) -> str:
    """The instantiation for panels of ``pr`` rows (``pr`` comes from R and
    ``panel_rows``, see ``_panels``) on a card that holds
    ``resident_blocks`` blocks of the kernel at once: "single" when a
    panel's chunks are no more than that, else "two_pass"."""
    return "single" if pr // chunk_rows(pr) <= resident_blocks else "two_pass"


_resident: dict[int, int] = {}


def resident_blocks(device: torch.device) -> int:
    """Blocks of the single-pass kernel that ``device`` holds at once (the
    occupancy calculator times the SMs), read once per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _resident:
        fn = _build.load("dense_to_tuples").dense_to_tuples_resident_blocks
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"dense_to_tuples occupancy query failed: CUDA error {err}")
        _resident[index] = out.value
    return _resident[index]


def _panels(xf: torch.Tensor, capacity: int, panel_rows: int) -> tuple[int, int]:
    """``(pr, cap_rows)`` for ``xf``, checking the reference's shape rules."""
    if xf.dim() != 2 or xf.shape[1] != 128:
        raise ValueError(f"expected a flat [R, 128] view, got {tuple(xf.shape)}")
    R = xf.shape[0]
    if R * 128 >= 1 << 31:
        raise ValueError(f"{R} x 128 cells exceed the int32 flat index")
    pr = math.gcd(R, min(panel_rows, R))
    if pr == 0 or pr % 8:
        raise ValueError(f"panel height {pr} (R={R}, panel_rows={panel_rows}) is not a multiple of 8")
    cap_rows = -(-capacity // 128)
    cap_rows = -(-cap_rows // 8) * 8 + 8 * (R // pr)
    return pr, cap_rows


def flat_to_tuples_arrays_reference(
    xf: torch.Tensor, *, zero: float = 0.0, capacity: int, panel_rows: int = _PANEL_ROWS
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the mask, per-panel counts, the greedy
    placement in a Python loop over the counts, and per-panel ``cumsum``
    ranks scattered into the output (plus a drop slot)."""
    pr, cap_rows = _panels(xf, capacity, panel_rows)
    dev = xf.device
    npanels = xf.shape[0] // pr
    flat_cap = cap_rows * 128
    mask = (xf != zero).reshape(npanels, pr * 128)
    counts = mask.sum(1)
    panel_off = []
    off = 0
    for total_p in counts.tolist():
        rows_used8 = -(-total_p // 1024) * 8
        fired = total_p > 0 and off + rows_used8 <= cap_rows
        panel_off.append(off if fired else -1)
        off += rows_used8 if fired else 0
    start = torch.tensor(panel_off, dtype=torch.long, device=dev)[:, None] * 128
    rank = torch.cumsum(mask, 1) - 1
    slot = torch.where(mask & (start >= 0), start + rank, flat_cap).reshape(-1)
    idx = torch.full((flat_cap + 1,), -1, dtype=torch.int32, device=dev)
    vals = torch.full((flat_cap + 1,), zero, dtype=xf.dtype, device=dev)
    idx.scatter_(0, slot, torch.arange(xf.numel(), dtype=torch.int32, device=dev))
    vals.scatter_(0, slot, xf.reshape(-1))
    total = counts.sum().to(torch.int32)
    end_row = torch.tensor(off, dtype=torch.int32, device=dev)
    return idx[:flat_cap], vals[:flat_cap], total, end_row


def flat_to_tuples_arrays(
    xf: torch.Tensor,
    *,
    zero: float = 0.0,
    capacity: int,
    panel_rows: int = _PANEL_ROWS,
    variant: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact the cells ``!= zero`` of the flat row-major view
    ``xf [R, 128]``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.

    ``variant`` ("single" or "two_pass") names the kernel's instantiation;
    by default ``kernel_variant`` picks it. A single-pass launch the card
    cannot finish is refused and raises. Both give the same arrays.

    Returns ``(flat_idx int32 [cap_rows*128], vals [cap_rows*128], total
    int32, end_row int32)``, the last two 0-dim tensors on ``xf``'s device;
    see the module docstring for the layout.
    """
    pr, cap_rows = _panels(xf, capacity, panel_rows)
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if xf.device.type == "cpu":
        return flat_to_tuples_arrays_reference(
            xf, zero=zero, capacity=capacity, panel_rows=panel_rows
        )
    if xf.device.type != "cuda":
        raise ValueError(f"flat_to_tuples_arrays runs on cuda or cpu, not {xf.device}")
    if xf.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 only, got {xf.dtype}")
    if not xf.is_contiguous() or xf.data_ptr() % 16:
        raise ValueError("flat_to_tuples_arrays needs a contiguous, 16-byte aligned view")
    R = xf.shape[0]
    rows = chunk_rows(pr)
    if variant is None:
        variant = kernel_variant(pr, resident_blocks(xf.device))
    flat_cap = cap_rows * 128
    idx = torch.empty(flat_cap, dtype=torch.int32, device=xf.device)
    vals = torch.empty(flat_cap, dtype=torch.float32, device=xf.device)
    # total, end_row, ticket, unused, a 64-bit status word a chunk, a 64-bit
    # descriptor and a 64-bit counter a panel; the launcher clears it
    work = torch.empty(4 + 2 * (R // rows) + 4 * (R // pr), dtype=torch.int32, device=xf.device)
    fn = _kernel()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xf.data_ptr(), R, pr, rows, cap_rows, zero, variant == "single",
                 work.data_ptr(), idx.data_ptr(), vals.data_ptr(), stream)
    if err == _REFUSED and variant == "single":
        raise RuntimeError(
            f"dense_to_tuples (single) refused: a panel of {pr // rows} chunks exceeds the "
            f"{resident_blocks(xf.device)} blocks the card holds at once; use two_pass"
        )
    if err != 0:
        raise RuntimeError(f"dense_to_tuples ({variant}) launch failed: CUDA error {err}")
    flat_to_tuples_arrays.launches += 1
    flat_to_tuples_arrays.last_variant = variant
    return idx, vals, work[0], work[1]


flat_to_tuples_arrays.launches = 0
flat_to_tuples_arrays.last_variant = None


@functools.cache
def _kernel():
    fn = _build.load("dense_to_tuples").dense_to_tuples_f32
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def dense_to_tuples_arrays(
    x: torch.Tensor, *, zero: float = 0.0, capacity: int, panel_rows: int = _PANEL_ROWS
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-D entry: ``x [M, N]`` as its flat ``[M*N/128, 128]`` view, packed
    by ``flat_to_tuples_arrays``."""
    M, N = x.shape
    if (M * N) % 128:
        raise ValueError(f"{M} x {N} cells do not fill rows of 128")
    return flat_to_tuples_arrays(
        x.reshape(-1, 128), zero=zero, capacity=capacity, panel_rows=panel_rows
    )


def dense_to_sptuples(
    x: torch.Tensor,
    nrows: int,
    ncols: int,
    *,
    zero: float = 0.0,
    capacity: int,
    panel_rows: int = _PANEL_ROWS,
) -> tuple[SpTuples, torch.Tensor]:
    """Dense ``[M >= nrows, N >= ncols]`` -> row-major SpTuples and the
    exact count before truncation.

    Cells in padding rows or columns must already equal ``zero`` (the
    caller's contract; nothing masks them). The padding is not a suffix:
    each written panel ends in sentinel slots, which hold ``(nrows,
    ncols)`` and value 0 like every other padding slot.
    """
    N = x.shape[1]
    fi, fv, total, end_row = dense_to_tuples_arrays(
        x, zero=zero, capacity=capacity, panel_rows=panel_rows
    )
    slot = torch.arange(fi.shape[0], dtype=torch.int32, device=fi.device)
    live = (fi >= 0) & (slot < end_row * 128)
    r = fi // N
    out = SpTuples(
        rows=torch.where(live, r, nrows).to(torch.int32),
        cols=torch.where(live, fi - r * N, ncols).to(torch.int32),
        vals=torch.where(live, fv, 0),
        nnz=live.sum().to(torch.int32),
        nrows=nrows,
        ncols=ncols,
    )
    return out, total
