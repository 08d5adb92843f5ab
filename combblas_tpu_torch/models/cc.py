"""Connected components — counterpart of ``combblas_tpu/models/cc.py``.

``connected_components`` is FastSV (≈ ``FastSV.h``): with ``gf = f[f]`` and
``u[i]`` the minimum of ``gf`` over i's neighbours (one ``SELECT2ND_MIN``
SpMV), each round applies stochastic hooking ``f[f[i]] <- min(f[f[i]],
u[i])`` (``DistVec.scatter_combine``), aggressive hooking ``f[i] <-
min(f[i], u[i])`` and shortcutting ``f[i] <- min(f[i], gf[i])`` until f
stops changing, then pointer jumping compresses the remaining chains.
``lacc`` is LACC (≈ ``CC.h``, Azad-Buluç): conditional and unconditional
star hooking, star tracking, shortcutting and star detection, in the
reference's order. Labels are the minimum vertex id of each component.

The reference runs each loop as one device program (``lax.while_loop``);
here each is a host loop that reads back one flag a round. Round counts
come back as Python ints. Every value is an int32, so labels and round
counts equal the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.spmat import ones_i32
from ..parallel.spmv import dist_spmv
from ..parallel.vec import DistVec
from ..semiring import PLUS_TIMES, SELECT2ND_MIN

_STAR, _NONSTAR, _CONVERGED = 1, 0, 2
#: SELECT2ND_MIN's identity on int32: "no neighbour" / "no hook"
NOHOOK = 2**31 - 1


def _jump(mk, fb: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pointer jumping ``f <- f[f]`` until nothing changes: the labels and
    the passes run (one readback a pass)."""
    passes, changed = 0, True
    while changed:
        gf = mk(fb).gather(mk(fb)).blocks
        changed = bool((gf != fb).any())
        fb = gf
        passes += 1
    return fb, passes


def connected_components(A):
    """FastSV labels of the symmetric matrix A (any stored entry is an
    edge): ``(labels, num_iters)``, a row-aligned int32 DistVec (padding
    slots carry their own ids and never touch a real vertex) and the
    hooking rounds run. ``connected_components.last_run`` holds the
    readbacks."""
    grid = A.grid
    n = A.nrows

    def mk(b):
        return DistVec(blocks=b, length=n, align="row", grid=grid)

    fb = DistVec.iota(grid, n, torch.int32, align="row").blocks
    it, changed = 0, True
    while changed and it < n:
        f = mk(fb)
        gf = f.gather(f)
        u = dist_spmv(SELECT2ND_MIN, A, gf.realign("col"))
        f1 = f.scatter_combine(SELECT2ND_MIN, idx=f, src=u)
        nb = torch.minimum(torch.minimum(f1.blocks, u.blocks), gf.blocks)
        changed = bool((nb != fb).any())
        fb = nb
        it += 1
    fb, passes = _jump(mk, fb)
    connected_components.last_run = {"readbacks": it + passes}
    return mk(fb), it


# the last call's device -> host readbacks (one a round, one a jumping pass)
connected_components.last_run = None


def lacc(A):
    """LACC labels of the symmetric matrix A: ``(labels, num_iters)`` like
    ``connected_components``. Isolated vertices start converged. Two
    deviations of the reference, kept: a uniform star-tracking path in the
    first round (marking extra vertices NONSTAR is safe, star detection
    promotes them again), and hooks that collide resolve by the minimum."""
    grid = A.grid
    n = A.nrows

    def mk(b):
        return DistVec(blocks=b, length=n, align="row", grid=grid)

    def scatter_min(base, idx, src):
        return mk(base).scatter_combine(SELECT2ND_MIN, idx=mk(idx), src=mk(src)).blocks

    def scatter_set(base, idx, src):
        """``out[p]``: the least ``src`` hitting p where any does, else
        ``base[p]``. A hook overwrites (the reference's Assign); a plain
        scatter-min into ``base`` would drop hooks above the target's
        parent and leave the hooked star a star for ever."""
        hit = scatter_min(torch.full_like(base, NOHOOK), idx, src)
        return torch.where(hit != NOHOOK, hit, base)

    def unstar(star, hook, tgt, val, parent):
        """Star tracking after a hook: the hooks, their roots and the hook
        targets become NONSTAR, then stars read their parent's flag."""
        flag = _flag(hook)
        star = torch.where(hook, _NONSTAR, star)
        star = scatter_min(star, tgt, flag)
        star = scatter_min(star, val, flag)
        pstar = mk(star).gather(mk(parent)).blocks
        return torch.where((star == _STAR) & (pstar == _NONSTAR), _NONSTAR, star)

    deg = A.reduce(PLUS_TIMES, "cols", map_fn=ones_i32)
    star = torch.where(deg.blocks == 0, _CONVERGED, _STAR).to(torch.int32)
    star = mk(star).mask_padding(_CONVERGED).blocks
    parent = DistVec.iota(grid, n, torch.int32, align="row").blocks

    it, done = 0, False
    while not done and it < n:
        # conditional star hooking: a star's root takes its least
        # neighbouring parent below its own
        mnp = dist_spmv(SELECT2ND_MIN, A, mk(parent).realign("col")).blocks
        hook = (star == _STAR) & (mnp < parent)
        tgt = torch.where(hook, parent, -1)
        val = torch.where(hook, mnp, NOHOOK)
        parent = scatter_min(parent, tgt, val)
        star = unstar(star, hook, tgt, val, parent)

        # unconditional star hooking onto nonstar neighbours
        masked = torch.where(star == _STAR, NOHOOK, parent)
        mnp2 = dist_spmv(SELECT2ND_MIN, A, mk(masked).realign("col")).blocks
        hook2 = (star == _STAR) & (mnp2 != NOHOOK)
        tgt2 = torch.where(hook2, parent, -1)
        val2 = torch.where(hook2, mnp2, NOHOOK)
        parent = scatter_set(parent, tgt2, val2)
        star = unstar(star, hook2, tgt2, val2, parent)

        # the remaining stars are converged
        star = torch.where(star == _STAR, _CONVERGED, star)
        done_t = (star == _CONVERGED).all()

        # shortcut the nonstars
        gp = mk(parent).gather(mk(parent)).blocks
        parent = torch.where(star == _NONSTAR, gp, parent)

        # star detection on the nonstars
        active = star == _NONSTAR
        star = torch.where(active, _STAR, star)
        gp = mk(parent).gather(mk(parent)).blocks
        bad = active & (gp != parent)
        star = torch.where(bad, _NONSTAR, star)
        flag = _flag(bad)
        star = scatter_min(star, torch.where(bad, parent, -1), flag)
        star = scatter_min(star, torch.where(bad, gp, -1), flag)
        pstar = mk(star).gather(mk(parent)).blocks
        star = torch.where(active & (star == _STAR) & (pstar == _NONSTAR), _NONSTAR, star)
        it += 1
        done = bool(done_t)
    parent, passes = _jump(mk, parent)
    lacc.last_run = {"readbacks": it + passes}
    return mk(parent), it


# the last call's device -> host readbacks (one a round, one a jumping pass)
lacc.last_run = None


def _flag(mask: torch.Tensor) -> torch.Tensor:
    """int32 NONSTAR where ``mask``, NOHOOK (no change) elsewhere."""
    return torch.where(mask, _NONSTAR, NOHOOK).to(torch.int32)


def num_components(labels: DistVec) -> int:
    """The number of distinct labels among the real (non-padding) slots."""
    return int(np.unique(labels.to_global()).size)
