"""Grid — the pr×pc process grid (≈ CommGrid), counterpart of
``combblas_tpu/parallel/grid.py``.

The owner math is the reference's: every tile is ``ceil(m/pr) ×
ceil(n/pc)`` and the owner of global row r is ``r // local_rows``. A grid
lives on one device: a distributed matrix is held as ``[pr, pc, ...]``
tile tensors there, and the tiles are walked in a loop, so the 2×2 parity
cases run in one process. Grids over several cards come later.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HostGrid:
    """Device-free grid carrying only the owner math."""

    pr: int
    pc: int

    @property
    def size(self) -> int:
        return self.pr * self.pc

    @property
    def is_square(self) -> bool:
        return self.pr == self.pc

    def local_rows(self, nrows: int) -> int:
        return -(-nrows // self.pr)

    def local_cols(self, ncols: int) -> int:
        return -(-ncols // self.pc)

    def row_owner(self, nrows: int, gr):
        return gr // self.local_rows(nrows)

    def col_owner(self, ncols: int, gc):
        return gc // self.local_cols(ncols)


@dataclasses.dataclass(frozen=True)
class Grid(HostGrid):
    """A pr×pc grid whose tiles live on ``device``."""

    device: torch.device = torch.device("cuda")

    @staticmethod
    def make(pr: int, pc: int, device: str | torch.device | None = None) -> "Grid":
        """A pr×pc grid on ``device`` (default: the current CUDA card).
        Raises when CUDA is asked for, explicitly or by default, and is
        absent; pass ``device="cpu"`` to run on the CPU."""
        if pr < 1 or pc < 1:
            raise ValueError(f"grid dims must be positive, got {pr}x{pc}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return Grid(pr=pr, pc=pc, device=dev)
