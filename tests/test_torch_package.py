"""Boundaries of the port package ``combblas_tpu_torch``: it imports neither
JAX nor the JAX package, and its entry points default to the CUDA card."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from combblas_tpu_torch import Grid, Grid3D, HostGrid

REPO = Path(__file__).resolve().parent.parent
# modules the walk below must reach (the Graph500 BFS path among them)
MODULES = {"convert", "operations", "semiring", "models", "models.bfs", "models.sssp",
           "models.pagerank", "models.cc", "models.mis", "models.tc", "models.bc",
           "models.mcl", "models.matching", "models.ordering", "models.propagate",
           "ops.segment", "ops.spgemm", "ops.dense_to_tuples", "ops.semiring_matmul",
           "ops.tuples", "ops.compressed", "ops.spmv", "ops.ewise",
           "parallel.ellmat", "parallel.vec", "parallel.spmat", "parallel.spgemm",
           "parallel.spmv", "parallel.dense", "parallel.indexing", "parallel.spmm",
           "semantic", "utils.graph500", "utils.rmat", "utils.threefry", "utils.refgen21",
           "parallel.redistribute", "parallel.collectives", "parallel.mesh3d", "models.graph500", "io", "io.mm",
           "io.labels", "utils.checkpoint", "utils.compile_cache", "tuner", "tuner.config",
           "tuner.store", "tuner.resolve", "tuner.probe", "obs", "obs.metrics", "obs.spans",
           "obs.sinks", "obs.trace", "obs.recorder", "obs.export", "obs.fleetlog",
           "utils.timers", "serve", "serve.engine", "serve.batcher", "serve.faults",
           "serve.slo", "serve.scheduler", "serve.api", "serve.policy", "serve.pool",
           "serve.fleet", "serve.frame", "serve.ipc", "serve.procfleet", "serve._procworker",
           "serve.shard", "serve._shardworker", "serve.net", "serve.net.protocol",
           "serve.net.client", "serve.net.frontend", "serve.net.loadgen", "dynamic", "dynamic.delta",
           "dynamic.merge", "dynamic.refresh", "dynamic.wal"}


def test_import_pulls_in_no_jax():
    """In a fresh interpreter, importing every module of
    ``combblas_tpu_torch`` and ``chip_smoke.py`` loads no ``jax*`` module
    and no ``combblas_tpu`` module. The port's own name shares that
    prefix, so those names are matched exactly."""
    code = (
        "import sys, pkgutil, importlib, chip_smoke, combblas_tpu_torch as pkg\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    seen.add(m.name.split('.', 1)[1])\n"
        f"missing = set({sorted(MODULES)!r}) - seen\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.startswith('jax')\n"
        "       or m == 'combblas_tpu' or m.startswith('combblas_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_grid_defaults_to_cuda(monkeypatch):
    """Without a device, ``Grid.make`` asks for CUDA, and raises where
    CUDA is absent; ``device="cpu"`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Grid.make(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Grid.make(2, 2, device="cuda")
    g = Grid.make(2, 2, device="cpu")
    assert g.device == torch.device("cpu") and g.size == 4 and g.is_square


def test_grid3d_defaults_to_cuda(monkeypatch):
    """``Grid3D.make`` asks for CUDA without a device and raises where CUDA
    is absent, as ``Grid.make`` does; ``device="cpu"`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Grid3D.make(2, 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Grid3D.make(2, 1, 1, device="cuda")
    with pytest.raises(ValueError, match="positive"):
        Grid3D.make(0, 2, 2, device="cpu")
    g = Grid3D.make(2, 2, 4, device="cpu")
    assert g.device == torch.device("cpu") and g.size == 16
    assert (g.local_rows(10), g.local_cols(10)) == (5, 3)


def test_owner_math_is_ceil_blocked():
    g = HostGrid(2, 3)
    assert (g.local_rows(10), g.local_cols(10)) == (5, 4)
    assert g.row_owner(10, 9) == 1 and g.col_owner(10, 9) == 2


def test_booted_replica_child_pulls_in_no_jax(tmp_path):
    """A process-fleet child (``serve/_procworker.py``'s receive loop, fed
    a ``boot`` of a CPU snapshot, one read and ``close`` over a
    socketpair) in a fresh interpreter loads no ``jax*`` and no
    ``combblas_tpu`` module."""
    import numpy as np

    from combblas_tpu_torch.serve import GraphEngine
    from combblas_tpu_torch.utils import checkpoint

    rows = np.array([0, 1, 1, 2], np.int64)
    cols = np.array([1, 0, 2, 1], np.int64)
    eng = GraphEngine.from_coo(Grid.make(1, 1, device="cpu"), rows, cols, 3, kinds=("bfs",))
    ckpt = str(tmp_path / "boot.npz")
    checkpoint.save_version(ckpt, eng.version)
    code = (
        "import socket, sys, threading\n"
        "from combblas_tpu_torch.serve._procworker import ProcWorker\n"
        "from combblas_tpu_torch.serve.ipc import Channel\n"
        "a, b = socket.socketpair()\n"
        "w = ProcWorker(Channel(a))\n"
        "t = threading.Thread(target=w.run)\n"
        "t.start()\n"
        "ch = Channel(b)\n"
        f"ch.send({{'id': 0, 'op': 'boot', 'grid': [1, 1], 'device': 'cpu', 'ckpt': {ckpt!r},\n"
        f"         'kinds': ['bfs'], 'config': {{'lane_widths': [1]}}, 'wal_dir': None,\n"
        f"         'hb_interval_s': 0.25, 'metrics_interval_s': 1.0}})\n"
        "ch.send({'id': 1, 'op': 'submit', 'kind': 'bfs', 'root': 0})\n"
        "ch.send({'id': 2, 'op': 'close'})\n"
        "got = {}\n"
        "while len(got) < 3:\n"
        "    m = ch.recv(timeout=60)\n"
        "    if 'id' in m:\n"
        "        got[m['id']] = m\n"
        "t.join(60)\n"
        "assert not t.is_alive() and all(m['ok'] for m in got.values()), got\n"
        "assert got[0]['result']['device'] == 'cpu'\n"
        "assert list(got[1]['result']['levels']) == [0, 1, 2]\n"
        "bad = [m for m in sys.modules if m.startswith('jax')\n"
        "       or m == 'combblas_tpu' or m.startswith('combblas_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_booted_shard_child_pulls_in_no_jax(tmp_path):
    """A sharded-serving child (``serve/_shardworker.py``'s receive loop,
    fed a ``boot`` of a slab COO on the CPU, one bfs hop, ``collect`` and
    ``close`` over a socketpair) in a fresh interpreter loads no ``jax*``
    and no ``combblas_tpu`` module."""
    home = tmp_path / "slice0"
    home.mkdir()
    code = (
        "import socket, sys, threading\n"
        "import numpy as np\n"
        "from combblas_tpu_torch.serve._shardworker import ShardWorker\n"
        "from combblas_tpu_torch.serve.frame import SparseFrontier\n"
        "from combblas_tpu_torch.serve.ipc import Channel\n"
        "a, b = socket.socketpair()\n"
        "w = ShardWorker(Channel(a))\n"
        "t = threading.Thread(target=w.run)\n"
        "t.start()\n"
        "ch = Channel(b)\n"
        f"coo = {str(home / 'slab_coo.npz')!r}\n"
        "np.savez(coo, rows=np.array([0, 1, 1]), cols=np.array([1, 0, 2]))\n"
        "ch.send({'id': 0, 'op': 'boot', 'device': 'cpu', 'idx': 0, 'row0': 0, 'row1': 2,\n"
        f"         'nrows': 3, 'ncols': 3, 'coo': coo, 'kinds': ['bfs'], 'home': {str(home)!r},\n"
        "         'warmup': True, 'warmup_widths': [1], 'hb_interval_s': 0.25})\n"
        "ch.send({'id': 1, 'op': 'hop', 'kind': 'bfs', 'width': 1, 'epoch': 1, 'seed': True,\n"
        "         'enc': 'sparse', 'level': 0,\n"
        "         'xs': SparseFrontier(3, 1, np.array([0]), np.array([0]))})\n"
        "ch.send({'id': 2, 'op': 'collect', 'kind': 'bfs', 'epoch': 1})\n"
        "ch.send({'id': 3, 'op': 'close'})\n"
        "got = {}\n"
        "while len(got) < 4:\n"
        "    m = ch.recv(timeout=60)\n"
        "    if 'id' in m:\n"
        "        got[m['id']] = m\n"
        "t.join(60)\n"
        "assert not t.is_alive() and all(m['ok'] for m in got.values()), got\n"
        "assert got[0]['result']['device'] == 'cpu'\n"
        "assert got[1]['result']['xs'].rows.tolist() == [1]\n"
        "assert got[2]['result']['levels'][:, 0].tolist() == [0, 1]\n"
        "bad = [m for m in sys.modules if m.startswith('jax')\n"
        "       or m == 'combblas_tpu' or m.startswith('combblas_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
