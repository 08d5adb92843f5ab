"""Edge semantics of the port's semiring GEMM that the card's tests build on,
checked on the CPU.

- The plain version (``semiring_matmul_reference``, the CPU path and the
  card's oracle) against the JAX package's Pallas kernel in interpret mode
  on operands with NaN, ±0 and ±inf cells: NaN in the same cells, every
  other cell equal bit for bit. Only NaN payloads may differ (torch's
  min/max give another NaN than JAX's), so NaN cells are compared by
  position.
- The wrapper's choice of kernel instantiation from shapes and alignment
  (``kernel_variant``), which needs no card.
- The reading of a kernel's main loop from its machine code
  (``main_loops``, ``main_loop_counts``) on listings written out
  here, in ``cuobjdump``'s and in ``nvdisasm``'s form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from combblas_tpu.ops.pallas_kernels import semiring_matmul as jax_semiring_matmul
from combblas_tpu_torch import _build
from combblas_tpu_torch.ops import semiring_matmul as sm
from combblas_tpu_torch.ops.semiring_matmul import KINDS, TILE, kernel_variant

# cell values and their odds: NaN rare enough that most outputs stay finite
_VALUES = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, 3.0], np.float32)
_ODDS = np.array([0.002, 0.15, 0.15, 0.01, 0.01, 0.17, 0.17, 0.17, 0.168])


def _specials(rng, shape):
    return rng.choice(_VALUES, size=shape, p=_ODDS / _ODDS.sum())


@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_pallas_kernel_on_specials(kind):
    rng = np.random.default_rng(2024 + KINDS.index(kind))
    a, b = _specials(rng, (128, 128)), _specials(rng, (128, 128))
    want = np.asarray(
        jax_semiring_matmul(kind, jnp.asarray(a), jnp.asarray(b), interpret=True)
    )
    got = sm.semiring_matmul_reference(kind, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    nan = np.isnan(want)
    assert 0 < nan.sum() < nan.size  # both kinds of cell occur
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


@pytest.mark.parametrize(
    "shape, offsets, variant",
    [
        ((128, 128, 128), (0, 0, 0), "tiled"),
        ((8192, 8192, 8192), (0, 0, 0), "tiled"),
        ((256, 0, 384), (0, 0, 0), "tiled"),
        ((129, 8, 127), (0, 0, 0), "edge"),
        ((1024, 777, 1024), (0, 0, 0), "edge"),
        ((8192, 8191, 8192), (0, 0, 0), "edge"),
        ((128, 12, 128), (0, 0, 0), "edge"),
        ((128, 128, 128), (4, 0, 0), "edge"),
        ((128, 128, 128), (0, 8, 0), "edge"),
        ((128, 128, 128), (0, 0, 12), "edge"),
    ],
)
def test_kernel_variant_from_shape_and_alignment(shape, offsets, variant):
    base = 1 << 20  # a 16-byte-aligned address
    assert kernel_variant(*shape, *(base + o for o in offsets)) == variant


def test_kernel_variant_of_a_view_at_offset_one():
    m, k, n = TILE[0], TILE[2], TILE[1]
    store = torch.zeros(m * k + 1)
    aligned, shifted = store[: m * k].view(m, k), store[1:].view(m, k)
    b, c = torch.zeros(k, n), torch.zeros(m, n)
    assert shifted.is_contiguous()
    assert kernel_variant(m, k, n, aligned.data_ptr(), b.data_ptr(), c.data_ptr()) == "tiled"
    assert kernel_variant(m, k, n, shifted.data_ptr(), b.data_ptr(), c.data_ptr()) == "edge"


# Two kernels in cuobjdump's form: a plus_times loop (2 FFMA, 1 LDS, 1 BRA
# back to 0x0040) and a min_plus one (2 FADD, 2 FMNMX, 2 LDS, 1 BRA).
_CUOBJDUMP = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118semiring_mm_kernelILi3ELb0EEEvPKfS2_Pfiii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;       /* 0x0000000000007919 */
        /*0040*/                   LDS.128 R4, [R2] ;       /* 0x0000000002047984 */
        /*0050*/                   FFMA R8, R4, R5, R8 ;    /* 0x0000000504087223 */
        /*0060*/                   FFMA R9, R6, R7, R9 ;    /* 0x0000000706097223 */
        /*0070*/               @P0 BRA 0x40 ;               /* 0xfffffffc00f00947 */
        /*0080*/                   STG.E.128 desc[UR4][R2.64], R8 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
\t\tFunction : _ZN12_GLOBAL__N_118semiring_mm_kernelILi0ELb1EEEvPKfS2_Pfiii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   LDS.128 R12, [R2+0x200] ;
        /*0030*/                   FADD R3, R4, R5 ;
        /*0040*/                   FMNMX.NAN R8, R8, R3, PT ;
        /*0050*/                   FADD R3, R6, R7 ;
        /*0060*/                   FMNMX.NAN R9, R9, R3, PT ;
        /*0070*/              @!P0 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""

# The same plus_times loop in nvdisasm's form, with labels.
_NVDISASM = """
\t.text._ZN12_GLOBAL__N_118semiring_mm_kernelILi3ELb0EEEvPKfS2_Pfiii:
        Function : _ZN12_GLOBAL__N_118semiring_mm_kernelILi3ELb0EEEvPKfS2_Pfiii
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0040*/                   LDS.128 R4, [R2] ;
        /*0050*/                   FFMA R8, R4, R5, R8 ;
        /*0060*/                   FFMA R9, R6, R7, R9 ;
        /*0070*/               @P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0080*/                   EXIT ;
        /*0090*/                   BRA `(.L_x_1);
"""


@pytest.mark.parametrize("listing", [_CUOBJDUMP, _NVDISASM], ids=["cuobjdump", "nvdisasm"])
def test_main_loop_read_from_machine_code(listing):
    loops = sm.main_loops(listing)
    pt = loops["_ZN12_GLOBAL__N_118semiring_mm_kernelILi3ELb0EEEvPKfS2_Pfiii"]
    assert (pt["FFMA"], pt["LDS"], pt["BRA"], pt["total"]) == (2, 1, 1, 4)
    assert pt["STG"] == pt["EXIT"] == 0


def test_main_loop_counts_per_kind_and_variant(monkeypatch):
    monkeypatch.setattr(_build, "disassemble", lambda path: _CUOBJDUMP)
    counts = sm.main_loop_counts()
    assert set(counts) == {"plus_times", "min_plus"}
    pt, mp = counts["plus_times"]["tiled"], counts["min_plus"]["edge"]
    assert (pt["FFMA"], pt["LDS"], pt["total"], pt["steps"]) == (2, 1, 4, 2)
    assert pt["insns_per_step"] == 2.0
    assert (mp["FADD"], mp["FMNMX"], mp["LDS"], mp["total"], mp["steps"]) == (2, 2, 2, 7, 2)
    assert mp["insns_per_step"] == 3.5


def test_main_loop_counts_of_a_kernel_with_one_instantiation(monkeypatch):
    """A kernel whose name carries only the kind (no edge flag) counts as
    "tiled"."""
    listing = _CUOBJDUMP.replace("ILi0ELb1EE", "ILi2EE").replace("FADD", "FMNMX")
    monkeypatch.setattr(_build, "disassemble", lambda path: listing)
    mm = sm.main_loop_counts()["max_min"]["tiled"]
    assert (mm["FMNMX"], mm["total"], mm["steps"], mm["insns_per_step"]) == (4, 7, 2, 3.5)
