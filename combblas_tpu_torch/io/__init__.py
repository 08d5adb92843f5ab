"""I/O — counterpart of ``combblas_tpu/io``: Matrix Market, binary
triples, vectors, and string-labelled tuples.

The reference's I/O layer is native (C ``mmio.c`` + MPI-parallel byte-range
text ingestion, ``SpParMat::ParallelReadMM`` SpParMat.cpp:3980-4127). Here
the coordinate reader is a C++ multithreaded parser (``native/mmparse.cpp``)
loaded with ctypes, built with g++ at first use; a failed build raises.
"""

from .labels import read_labeled_spmat, read_labeled_tuples
from .mm import (
    read_binary,
    read_mm,
    read_mm_distributed,
    read_mm_spmat,
    read_vec,
    write_binary,
    write_mm,
    write_vec,
)

__all__ = [
    "read_binary",
    "read_labeled_spmat",
    "read_labeled_tuples",
    "read_mm",
    "read_mm_distributed",
    "read_mm_spmat",
    "read_vec",
    "write_binary",
    "write_mm",
    "write_vec",
]
