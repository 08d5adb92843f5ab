"""DeltaBuffer — the bounded host-side COO delta log of the mutation lane;
counterpart of ``combblas_tpu/dynamic/delta.py``, host numpy, kept as the
reference has it (same semantics, same ``obs`` series).

Production graphs change while they serve.  The write path starts here:
edge mutations (``insert`` / ``delete`` / ``upsert``) are ADMITTED into a
bounded in-memory log instead of touching the loaded matrices, so writes
coalesce while reads stay hot, and a full buffer REJECTS instead of
buffering unboundedly (the same load-shedding stance as the serve
queue).  A drained batch is a plain numpy COO record
(:class:`DeltaBatch`) that :func:`combblas_tpu_torch.dynamic.merge.apply_delta`
folds into the current ``GraphVersion``.

Semantics, applied in ADMISSION ORDER (every op carries a monotonically
increasing sequence number, so replay is deterministic even when several
ops hit the same (row, col) key):

* ``insert(r, c, w)`` — the edge exists with weight ``w`` afterwards
  (an existing edge is overwritten — a *reset* op);
* ``delete(r, c)``    — the edge is absent afterwards (also a reset);
* ``upsert(r, c, w)`` — combine ``w`` into the edge's current weight via
  the buffer's ``combine`` monoid (``min`` by default — the
  shortest-path dedup convention of ``GraphEngine.from_coo``), or
  insert it with weight ``w`` when absent.

The fold of many same-key ops reduces to: the LAST reset op decides
presence, and the upserts AFTER it combine associatively — which is what
lets :func:`fold_ops` vectorize the whole dedup (no per-key Python loop)
while staying bit-identical to sequential replay.

Unweighted graphs ignore the weight payload (every surviving edge is
structural weight 1); ``upsert`` then degrades to ``insert``.

Thread-safe; obs series ``dynamic.delta.*`` (cataloged in
``obs/metrics.py``) make depth and batch age visible.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from .. import obs

#: Op codes carried in ``DeltaBatch.ops`` (int8).
OP_INSERT, OP_DELETE, OP_UPSERT = 0, 1, 2
OP_NAMES = ("insert", "delete", "upsert")
_OP_CODE = {name: i for i, name in enumerate(OP_NAMES)}

#: Supported duplicate-key combine monoids for ``upsert``.
COMBINES = ("min", "max", "sum", "last")


class DeltaOverflowError(RuntimeError):
    """The delta buffer is full: the caller should back off and retry
    (mirror of the serve queue's ``BackpressureError`` — the write lane
    sheds load the same way the read lane does).  ``retry_after_s`` is
    the buffer's flush-delay hint."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"delta buffer full ({depth} pending ops); retry after "
            f"{retry_after_s:.3f}s"
        )
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One drained batch of edge mutations, in admission order.

    ``rows``/``cols`` are int64 global indices, ``vals`` float32 weights
    (1.0 for ops that carried none), ``ops`` the int8 op codes above.
    ``first_seq``/``last_seq`` delimit the buffer sequence numbers the
    batch covers (the write lane settles update futures by comparing
    their ticket against ``last_seq``); ``oldest_at`` is the admission
    ``time.monotonic()`` of the oldest op (batch age at drain).
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    ops: np.ndarray
    first_seq: int
    last_seq: int
    oldest_at: float

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_ops(ops, start_seq: int = 0,
                 now: float | None = None) -> "DeltaBatch":
        """Build a batch directly from an iterable of
        ``(op, row, col[, weight])`` tuples — the test/tooling path that
        skips the buffer."""
        rows, cols, vals, codes = [], [], [], []
        for item in ops:
            op, r, c = item[0], item[1], item[2]
            w = item[3] if len(item) > 3 else 1.0
            code = _OP_CODE.get(op)
            if code is None:
                raise ValueError(
                    f"unknown delta op {op!r}; expected one of {OP_NAMES}"
                )
            rows.append(int(r))
            cols.append(int(c))
            vals.append(float(w))
            codes.append(code)
        now = time.monotonic() if now is None else now
        return DeltaBatch(
            rows=np.asarray(rows, np.int64),
            cols=np.asarray(cols, np.int64),
            vals=np.asarray(vals, np.float32),
            ops=np.asarray(codes, np.int8),
            first_seq=start_seq,
            last_seq=start_seq + max(len(rows) - 1, 0),
            oldest_at=now,
        )


class DeltaBuffer:
    """Bounded, thread-safe delta log (see module docstring).

    ``capacity`` bounds PENDING ops (admission control); ``nrows`` /
    ``ncols``, when given, validate indices at the front door so a
    malformed op is rejected before it can poison a merge.  ``combine``
    names the upsert duplicate-key monoid.
    """

    def __init__(self, capacity: int = 65536, *,
                 nrows: int | None = None, ncols: int | None = None,
                 combine: str = "min",
                 retry_after_s: float = 0.05,
                 start_seq: int = 0):
        if capacity < 1:
            raise ValueError("delta buffer capacity must be >= 1")
        if combine not in COMBINES:
            raise ValueError(
                f"combine must be one of {COMBINES}, got {combine!r}"
            )
        self.capacity = int(capacity)
        self.nrows = None if nrows is None else int(nrows)
        self.ncols = None if ncols is None else int(ncols)
        self.combine = combine
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._rows: list[int] = []
        self._cols: list[int] = []
        self._vals: list[float] = []
        self._ops: list[int] = []
        # start_seq (round 16): a recovered / promoted server resumes
        # the WAL's seqno lineage instead of restarting at 0 — replay
        # dedup and snapshot stamps depend on sequence numbers being a
        # single monotone line across process lives
        self._next_seq = int(start_seq)
        self._oldest_at: float | None = None
        # host-side counters (always live; obs mirrors cost nothing
        # when telemetry is disabled)
        self.admitted = 0
        self.rejected = 0
        self.drained_batches = 0

    # -- admission ---------------------------------------------------------

    def _validate(self, op: str, row: int, col: int) -> int:
        code = _OP_CODE.get(op)
        if code is None:
            raise ValueError(
                f"unknown delta op {op!r}; expected one of {OP_NAMES}"
            )
        row, col = int(row), int(col)
        if row < 0 or (self.nrows is not None and row >= self.nrows):
            raise ValueError(f"row {row} outside [0, {self.nrows})")
        if col < 0 or (self.ncols is not None and col >= self.ncols):
            raise ValueError(f"col {col} outside [0, {self.ncols})")
        return code

    def add(self, op: str, row: int, col: int,
            weight: float = 1.0) -> int:
        """Admit one op; returns its sequence number (the caller's
        ticket — a drain whose ``last_seq`` >= it contains this op).
        Raises ``DeltaOverflowError`` when full and ``ValueError`` for a
        malformed op (neither mutates the buffer)."""
        code = self._validate(op, row, col)
        with self._lock:
            depth = len(self._rows)
            if depth >= self.capacity:
                self.rejected += 1
                obs.count("serve.update.rejected")
                raise DeltaOverflowError(depth, self.retry_after_s)
            seq = self._next_seq
            self._next_seq += 1
            self._rows.append(int(row))
            self._cols.append(int(col))
            self._vals.append(float(weight))
            self._ops.append(code)
            if self._oldest_at is None:
                self._oldest_at = time.monotonic()
            self.admitted += 1
            depth += 1
        obs.count("dynamic.delta.ops", op=op)
        obs.gauge("dynamic.delta.depth", depth)
        return seq

    def add_many(self, ops) -> int:
        """Admit a sequence of ``(op, row, col[, weight])`` tuples
        ATOMICALLY (all admitted or none — a partially-admitted update
        would make the caller's future ambiguous).  Returns the LAST
        sequence number."""
        items = []
        for item in ops:
            op, r, c = item[0], item[1], item[2]
            w = item[3] if len(item) > 3 else 1.0
            self._validate(op, r, c)  # raises before any admission
            items.append((op, int(r), int(c), float(w)))
        if not items:
            raise ValueError("add_many needs at least one op")
        with self._lock:
            depth = len(self._rows)
            if depth + len(items) > self.capacity:
                self.rejected += 1
                obs.count("serve.update.rejected")
                raise DeltaOverflowError(depth, self.retry_after_s)
            for op, r, c, w in items:
                self._rows.append(r)
                self._cols.append(c)
                self._vals.append(w)
                self._ops.append(_OP_CODE[op])
            last = self._next_seq + len(items) - 1
            self._next_seq += len(items)
            if self._oldest_at is None:
                self._oldest_at = time.monotonic()
            self.admitted += len(items)
            depth += len(items)
        for op, _r, _c, _w in items:
            obs.count("dynamic.delta.ops", op=op)
        obs.gauge("dynamic.delta.depth", depth)
        return last

    def rollback(self, from_seq: int) -> int:
        """Un-admit the TAIL of pending ops with sequence number >=
        ``from_seq`` and rewind the sequence counter — the write
        lane's WAL-append failure path (round 16): ops whose durable
        record could not be written were never acknowledged, so they
        must not merge.  Only a tail can be rolled back (earlier ops
        may already be acknowledged); the caller must ensure no drain
        ran in between (``Server.submit_update`` holds its admission
        lock across append + rollback).  Returns ops removed."""
        with self._lock:
            first_pending = self._next_seq - len(self._rows)
            if from_seq < first_pending:
                raise ValueError(
                    f"rollback(from_seq={from_seq}) reaches below the "
                    f"pending tail (first pending seq {first_pending})"
                    " — those ops were already drained/acknowledged"
                )
            n = self._next_seq - int(from_seq)
            if n <= 0:
                return 0
            del self._rows[-n:]
            del self._cols[-n:]
            del self._vals[-n:]
            del self._ops[-n:]
            self._next_seq = int(from_seq)
            self.admitted -= n
            if not self._rows:
                self._oldest_at = None
            depth = len(self._rows)
        obs.gauge("dynamic.delta.depth", depth)
        return n

    # -- introspection -----------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return len(self._rows)

    def oldest_age(self, now: float | None = None) -> float | None:
        """Age in seconds of the oldest pending op, or None when empty
        (the write lane's flush-deadline input)."""
        with self._lock:
            if self._oldest_at is None:
                return None
            now = time.monotonic() if now is None else now
            return max(0.0, now - self._oldest_at)

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": len(self._rows),
                "capacity": self.capacity,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "drained_batches": self.drained_batches,
                "combine": self.combine,
            }

    # -- drain -------------------------------------------------------------

    def drain(self, now: float | None = None) -> DeltaBatch | None:
        """Pop everything pending as one :class:`DeltaBatch` (admission
        order), or ``None`` when empty."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not self._rows:
                return None
            n = len(self._rows)
            batch = DeltaBatch(
                rows=np.asarray(self._rows, np.int64),
                cols=np.asarray(self._cols, np.int64),
                vals=np.asarray(self._vals, np.float32),
                ops=np.asarray(self._ops, np.int8),
                first_seq=self._next_seq - n,
                last_seq=self._next_seq - 1,
                oldest_at=self._oldest_at,
            )
            self._rows, self._cols = [], []
            self._vals, self._ops = [], []
            age = max(0.0, now - self._oldest_at)
            self._oldest_at = None
            self.drained_batches += 1
        obs.count("dynamic.delta.batches")
        obs.observe("dynamic.delta.age_s", age)
        obs.gauge("dynamic.delta.depth", 0)
        return batch


def fold_ops(batch: DeltaBatch, base_keys: np.ndarray,
             base_weights: np.ndarray | None, ncols: int,
             combine: str = "min"):
    """Fold a batch against a SORTED base edge-key set, vectorized.

    ``base_keys`` are the current deduped edge keys (``row * ncols +
    col``, strictly increasing); ``base_weights`` the aligned weights
    (``None`` for unweighted graphs — the weight payload is then
    ignored and every surviving edge has weight 1).

    Returns ``(final_keys, final_present, final_weights)`` for exactly
    the keys the batch TOUCHES (sorted, unique): ``final_present[i]``
    says whether key ``i`` exists after the batch, ``final_weights[i]``
    its post-combine weight.  Bit-identical to replaying the ops one by
    one in sequence order (the per-key fold described in the module
    docstring), which the property tests assert.
    """
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}")
    m = len(batch)
    if m == 0:
        e = np.empty(0, np.int64)
        return e, np.empty(0, bool), np.empty(0, np.float32)
    keys = batch.rows.astype(np.int64) * np.int64(ncols) + batch.cols
    pos = np.arange(m, dtype=np.int64)
    order = np.lexsort((pos, keys))  # by key, then admission order
    ks, ops, vs, ps = keys[order], batch.ops[order], batch.vals[order], pos[order]
    uniq, start = np.unique(ks, return_index=True)
    nseg = len(uniq)
    sorted_idx = np.arange(m, dtype=np.int64)
    seg_of = np.searchsorted(start, sorted_idx, side="right") - 1
    # base state per touched key
    bpos = np.searchsorted(base_keys, uniq)
    in_base = (bpos < len(base_keys)) & (
        base_keys[np.minimum(bpos, max(len(base_keys) - 1, 0))] == uniq
    ) if len(base_keys) else np.zeros(nseg, bool)
    base_w = np.ones(nseg, np.float32)
    if base_weights is not None and len(base_keys):
        base_w = np.where(
            in_base,
            base_weights[np.minimum(bpos, len(base_keys) - 1)],
            np.float32(1.0),
        ).astype(np.float32)
    # last RESET (insert/delete) position per segment (-1 = none)
    reset_pos = np.where(ops != OP_UPSERT, sorted_idx, np.int64(-1))
    last_reset = np.maximum.reduceat(reset_pos, start)
    # presence/weight after the last reset (or the base, if none)
    has_reset = last_reset >= 0
    safe_reset = np.maximum(last_reset, 0)
    present0 = np.where(has_reset, ops[safe_reset] == OP_INSERT, in_base)
    w0 = np.where(has_reset, vs[safe_reset], base_w).astype(np.float32)
    # upserts AFTER the reset combine associatively
    up_mask = (ops == OP_UPSERT) & (sorted_idx > last_reset[seg_of])
    if combine == "min":
        ident, ufunc = np.float32(np.inf), np.minimum
    elif combine == "max":
        ident, ufunc = np.float32(-np.inf), np.maximum
    elif combine == "sum":
        ident, ufunc = np.float32(0.0), np.add
    else:  # "last": the max-position upsert's value wins
        ident, ufunc = None, None
    has_up_seg = np.zeros(nseg, bool)
    np.logical_or.at(has_up_seg, seg_of, up_mask)
    if combine == "last":
        lastpos = np.full(nseg, -1, np.int64)
        np.maximum.at(
            lastpos, seg_of, np.where(up_mask, sorted_idx, np.int64(-1))
        )
        up_red = vs[np.maximum(lastpos, 0)].astype(np.float32)
        # "last" treats the combine as overwrite: the reduced value IS
        # the final weight whenever any upsert fired
        w_with_up = up_red
    else:
        acc = np.full(nseg, ident, np.float32)
        ufunc.at(acc, seg_of, np.where(up_mask, vs, ident).astype(np.float32))
        up_red = acc
        w_with_up = np.where(
            present0, ufunc(w0, up_red), up_red
        ).astype(np.float32)
    final_present = present0 | has_up_seg
    final_w = np.where(has_up_seg, w_with_up, w0).astype(np.float32)
    if base_weights is None:
        final_w = np.ones(nseg, np.float32)  # unweighted: structural 1s
    return uniq, final_present, final_w
