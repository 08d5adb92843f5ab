"""Build the port's CUDA and host C++ sources into shared libraries and
load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``<build dir>/<name>-<hash>.so``, keyed by a hash of the source and the
flags, at first use. The build dir is the one committed by
``utils.compile_cache.enable_compile_cache``, else ``BUILD_DIR``
(``build/combblas_tpu_torch`` beside the package). The libraries have a plain
C interface and load with ``ctypes``; no PyTorch header is compiled, which
keeps a build to seconds. The host sources ``io/native/<name>.cpp`` (the
Graph500 v2.1 generator and the Matrix Market parser) build the same way
with ``g++`` (``build_host`` / ``load_host``). Each build writes a
temporary file and renames it into place, so processes that build at once
do not see a half-written library. Nothing here runs at import time, and
nothing falls back: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .utils import compile_cache

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(compile_cache.CACHE_DIR)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_SRC = Path(__file__).resolve().parent / "io" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}
_host_loaded: dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()


def _cuda_tool(tool: str) -> str:
    """A CUDA toolkit program: on PATH, in $CUDA_HOME/bin, or (for
    ``cuobjdump``) in the ``triton`` package's copy of the toolkit."""
    found = shutil.which(tool)
    if found:
        return found
    dirs = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        dirs += [Path(d) / "backends" / "nvidia" / "bin" for d in spec.submodule_search_locations]
    for d in dirs:
        if (d / tool).is_file():
            return str(d / tool)
    raise RuntimeError(f"{tool} not found (looked on PATH, in {', '.join(map(str, dirs))})")


def build_dir() -> Path:
    """Where libraries are built and loaded from: the compile cache's
    committed dir (``compile_cache.configured_dir()``), else
    ``BUILD_DIR``."""
    committed = compile_cache.configured_dir()
    return BUILD_DIR if committed is None else Path(committed)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns, per name, the build seconds
    (0.0 when it was already built), the compiler's log (``-Xptxas -v``:
    registers, shared memory, spills) and the library's path."""
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "path": str(out)}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}"
            )
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "log": log, "path": str(out)}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def disassemble(path: str | Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    proc = subprocess.run(
        [_cuda_tool("cuobjdump"), "-sass", str(path)], capture_output=True, text=True,
        timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {path}:\n{proc.stderr}")
    return proc.stdout


def host_library_path(name: str) -> Path:
    src = HOST_SRC / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str) -> dict:
    """Compile ``io/native/<name>.cpp`` with ``g++`` unless its library
    exists. Returns the build seconds (0.0 when it was built already) and
    the library's path; raises with the compiler's log on a failure."""
    out = host_library_path(name)
    if out.exists():
        return {"seconds": 0.0, "path": str(out)}
    out.parent.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; io/native/{name}.cpp cannot be built")
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, str(HOST_SRC / f"{name}.cpp"), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed for io/native/{name}.cpp (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "path": str(out)}


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``io/native/<name>.cpp``, built first if
    needed (one build a process, under a lock)."""
    with _host_lock:
        lib = _host_loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_host(name)["path"])
            _host_loaded[name] = lib
        return lib
