"""Slice subprocess entry point (sharded serving); counterpart of
``combblas_tpu/serve/_shardworker.py``.

``python -m combblas_tpu_torch.serve._shardworker --fd N`` is what
``ProcSlice`` spawns: one OS process hosting ONE row slab of the sharded
graph (a ``shard.SliceRuntime``) with its OWN CUDA context — a fresh
interpreter, so nothing of the parent's context is inherited, and a
slice is the host of the multi-host story (the mesh lives across
processes, not inside one).

Protocol: the ``_procworker`` conventions — framed request/reply on the
inherited socketpair (``{"id": n, "op": ...}`` → ``{"id": n, "ok":
...}``), unsolicited ``{"hb": {...}}`` heartbeats carrying
depth/frontier/serving so the router's ``ReplicaProc`` machinery tells
wedged from busy, and op dispatch shared with the in-process slice
through :func:`shard.dispatch_slice_op` — one protocol, two transports.

A first boot builds the slab from the COO the router wrote into the
slice's home (``shard.SLAB_COO_NAME``: rows in slab coordinates, global
columns, weights and the feature slab), since no whole-graph checkpoint
exists to load from — sharding is the point — and removes the file once
the bootstrap snapshot holds the slab. Respawn boots recover from the
slice's own home directory (slab snapshot + per-slice WAL suffix).

On the card. The boot message names the device (``"cuda"`` on the card,
``"cpu"`` in the tests); ``boot`` builds the slice's grid there, and
every op that touches the device runs under ``api.device_scope``
(``dispatch_slice_op`` scopes the slice ops). The heartbeat thread does
host work only.

Deviations from the reference, kept on purpose:

* No ``JAX_PLATFORMS`` or ``XLA_FLAGS`` are set: there is no runtime to
  pin, and the parent passes ``CUDA_VISIBLE_DEVICES`` through.
* The hand-run ``--hb-interval-s`` flag has no caller (``ProcSlice``
  passes only ``--fd``): the interval comes from the boot message.
* A CUDA error met by the boot's warm-up fails the boot (the reference
  records a warm-up error and goes on): the parent quarantines the
  child, so a poisoned context never serves a slab.
* Once an op has met a CUDA error, the heartbeat says ``serving:
  false`` (the reference always says true) and carries the error's
  repr as ``device_error``: the parent's supervisor then replaces the
  child even when no hop is in flight.
* ``boot`` also reports ``device`` (its name) and ``boot_s`` (seconds
  of the build or recovery, and of the warm-up).
* The first boot's slab is a file (``coo``), not arrays inside the boot
  message (the reference's): a frame is capped at 64 MB, which a
  scale-18 slab passes.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
import traceback

# import-light; reads COMBBLAS_OBS (pinned by the parent) at import
from .. import obs


class ShardWorker:
    """The child-side dispatcher: one SliceRuntime, one channel."""

    #: minimum seconds between registry snapshots piggybacked on
    #: heartbeats (metrics federation)
    METRICS_INTERVAL_S = 1.0

    def __init__(self, channel):
        self.ch = channel
        self.rt = None
        #: heartbeat cadence, set by ``boot`` (the thread starts there)
        self.hb_interval_s = None
        #: the first CUDA error an op met: this context is poisoned
        self.device_error: Exception | None = None
        self._last_snap_t = 0.0
        self._hb_stop = threading.Event()
        self._busy = 0
        self._busy_lock = threading.Lock()

    def _reply(self, rid, result=None, exc: Exception | None = None):
        from .ipc import ChannelClosed

        try:
            if exc is None:
                self.ch.send({"id": rid, "ok": True, "result": result})
            else:
                self.ch.send({
                    "id": rid, "ok": False,
                    "etype": type(exc).__name__,
                    "error": str(exc),
                    "retry_after_s": getattr(exc, "retry_after_s",
                                             None),
                })
        except ChannelClosed:
            pass  # parent died; the recv loop exits on its own

    # -- heartbeat ---------------------------------------------------------

    def _hb_loop(self):
        from .ipc import ChannelClosed

        while not self._hb_stop.wait(self.hb_interval_s):
            rt = self.rt
            if rt is None:
                continue
            err = self.device_error
            hb = {
                "t": time.time(),
                "pid": os.getpid(),
                "depth": self._busy,
                "serving": err is None,
                "device_error": repr(err) if err is not None else None,
                "slice": rt.idx,
                "wal_frontier": int(rt.version.wal_seq),
                "graph_version": int(rt.version.vid),
            }
            if obs.ENABLED:
                now = time.monotonic()
                if now - self._last_snap_t >= self.METRICS_INTERVAL_S:
                    self._last_snap_t = now
                    try:
                        obs.count("serve.shard.hb_snapshots")
                        hb["metrics"] = obs.metrics_snapshot()
                    except Exception:
                        pass  # liveness outranks telemetry
            try:
                self.ch.send({"hb": hb})
            except ChannelClosed:
                return

    # -- boot --------------------------------------------------------------

    def _op_boot(self, m: dict) -> dict:
        import numpy as np

        from ..parallel.grid import Grid
        from .api import _is_device_error, device_scope
        from .shard import FEATURES_NAME, SliceRuntime

        grid = Grid.make(1, 1, device=m["device"])
        kinds = tuple(m["kinds"])
        common = dict(
            fsync=m.get("fsync"),
            max_iters=m.get("max_iters"),
            propagate_hops=int(m.get("propagate_hops", 2)),
            checkpoint_every=int(m.get("checkpoint_every", 0)),
            checkpoint_retain=int(m.get("checkpoint_retain", 2)),
        )
        t0 = time.perf_counter()
        with device_scope(grid.device):
            if m.get("recover"):
                rt = SliceRuntime.recover(
                    grid, int(m["idx"]), m["home"], kinds, **common
                )
            else:
                with np.load(m["coo"]) as z:
                    slab = {k: z[k] for k in z.files}
                rt = SliceRuntime.build(
                    grid, int(m["idx"]), int(m["row0"]), int(m["row1"]),
                    int(m["nrows"]), int(m["ncols"]),
                    slab["rows"], slab["cols"], slab.get("weights"), kinds,
                    features=None, home=m.get("home"), **common,
                )
                feats = slab.get("features")
                if feats is not None:
                    # the build path slices features by global row
                    # bounds; the file holds the PRE-SLICED slab —
                    # attach it directly
                    rt.attach_features(feats)
                    np.save(os.path.join(m["home"], FEATURES_NAME), feats)
                del slab, feats
                os.unlink(m["coo"])
        t1 = time.perf_counter()
        warmed = {}
        if m.get("warmup", True):
            try:
                with device_scope(grid.device):
                    warmed = {
                        f"{k}/{w}": s
                        for (k, w), s in rt.warmup(
                            widths=m.get("warmup_widths")
                        ).items()
                    }
            except Exception as e:
                if _is_device_error(e):
                    # a poisoned context must not serve a slab: the
                    # boot fails and the parent quarantines this child
                    raise
                warmed = {"error": repr(e)}
        self.rt = rt
        self.hb_interval_s = float(m["hb_interval_s"])
        threading.Thread(
            target=self._hb_loop, name="combblas-shard-hb",
            daemon=True,
        ).start()
        return {
            "pid": os.getpid(),
            "slice": rt.idx,
            "device": str(grid.device),
            "rows": [rt.row0, rt.row1],
            "nnz": int(rt.version.nnz),
            "wal_seq": int(rt.version.wal_seq),
            "device_bytes": rt.device_bytes(),
            "boot_s": {"load": t1 - t0,
                       "warmup": time.perf_counter() - t1},
            "warmed": warmed,
        }

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, m: dict) -> bool:
        from .api import _is_device_error
        from .shard import dispatch_slice_op

        rid = m.get("id")
        op = m.get("op")
        try:
            if op == "boot":
                self._reply(rid, result=self._op_boot(m))
            elif op == "close":
                self._hb_stop.set()
                if self.rt is not None:
                    self.rt.close()
                self._reply(rid, result={"closed": True})
                return False
            else:
                with self._busy_lock:
                    self._busy += 1
                try:
                    self._reply(
                        rid, result=dispatch_slice_op(self.rt, op, m)
                    )
                finally:
                    with self._busy_lock:
                        self._busy -= 1
        except Exception as e:
            # a failed op fails ITS request, never the worker — the
            # router decides quarantine vs per-request handling; a
            # CUDA error also stops this slice serving (heartbeat)
            if _is_device_error(e) and self.device_error is None:
                self.device_error = e
            if self.rt is not None:
                self.rt.worker_errors += 1
            self._reply(rid, exc=e)
        return True

    def run(self) -> None:
        while True:
            try:
                m = self.ch.recv(timeout=1.0)
            except socket.timeout:
                continue
            except Exception:
                break  # ChannelClosed / corrupt frame: parent gone
            if "hb" in m:
                continue
            if not self.dispatch(m):
                break
        self._hb_stop.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socketpair fd (pass_fds)")
    args = ap.parse_args(argv)
    sock = socket.socket(fileno=args.fd)
    from .ipc import Channel

    worker = ShardWorker(Channel(sock, peer="parent"))
    try:
        worker.run()
    except Exception:
        traceback.print_exc(file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
