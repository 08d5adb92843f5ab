"""The kernel build cache switch — counterpart of
``combblas_tpu/utils/compile_cache.py``.

The port's compile cache is the directory where ``_build`` compiles the
CUDA and host C++ sources and loads the libraries from:
``build/combblas_tpu_torch`` beside the package unless a process commits
another one with ``enable_compile_cache``. Unlike the reference's XLA
cache it cannot be off — a kernel is built into some directory before it
loads — so the reference's ``BENCH_NOCACHE`` switch has no counterpart.

IDEMPOTENCE CONTRACT (the reference's): the first enable call wins.
Re-enabling with no argument ("ensure the cache is on") or with the SAME
(resolved) dir is a no-op; an EXPLICIT different dir raises — retargeting
the cache mid-process would split the built libraries across two dirs.
``_reset_for_tests()`` is the explicit escape hatch.

The plan store (``tuner.store``) defaults to ``.plan_store``, the sibling
of the cache dir (``build/.plan_store`` by default), so whoever ships the
built libraries ships the measured plans with them.

When telemetry is on (``combblas_tpu_torch.obs``), enabling the cache also
installs the build hooks, so kernel builds found built / compiled surface
as the ``compile_cache.hits`` / ``compile_cache.misses`` counters, and
registers a pull-provider publishing the ``compile_cache.entries`` gauge
(files currently in the cache dir) into every report/JSONL dump. The
reference's ``compile_cache.disabled`` counter belongs to
``BENCH_NOCACHE``, which has no counterpart here.
"""

from __future__ import annotations

import os

from .. import obs

CACHE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "build", "combblas_tpu_torch")
)

#: The dir the process committed to on the first successful enable call
#: (None = not yet enabled). See the idempotence contract above.
_configured_dir: str | None = None


def configured_dir() -> str | None:
    """The cache dir this process committed to, or None when the cache
    was never enabled."""
    return _configured_dir


def plan_store_dir() -> str:
    """Default measured-plan store dir: the ``.plan_store`` sibling of
    the cache dir. ``COMBBLAS_PLAN_STORE`` overrides (parsed by
    ``tuner.config.store_dir``, which calls this for the default)."""
    base = _configured_dir or CACHE_DIR
    return os.path.join(os.path.dirname(os.path.abspath(base)), ".plan_store")


def _record_cache_entries() -> None:
    """obs provider: build-cache entry count, polled at export time.  ONE
    health surface covers both caches: the sibling plan store's entry
    count is published by the same provider (``cache="plans"`` labeled
    series + the ``tuner.store.entries`` gauge)."""
    if _configured_dir is not None:
        try:
            entries = sum(1 for e in os.scandir(_configured_dir) if e.is_file())
        except OSError:
            entries = 0
        obs.gauge("compile_cache.entries", entries, dir=_configured_dir)
    try:
        from ..tuner import store as plan_store

        st = plan_store.get_store()
    except Exception:
        st = None
    if st is not None:
        obs.gauge("compile_cache.entries", st.entries(), cache="plans", dir=st.path)
        obs.gauge("tuner.store.entries", st.entries(), dir=st.path)


def enable_compile_cache(cache_dir: str | None = None) -> None:
    """Commit ``cache_dir`` (default ``CACHE_DIR``) as the directory
    ``_build`` builds into and loads from, under the idempotence contract
    above."""
    global _configured_dir
    if obs.ENABLED:
        obs.install_hooks()
    # abspath: the committed identity must not drift under a later chdir
    resolved = os.path.abspath(cache_dir or CACHE_DIR)
    if _configured_dir is not None:
        if cache_dir is None or resolved == _configured_dir:
            return  # idempotent re-enable
        raise ValueError(
            f"compile cache already enabled at {_configured_dir!r}; "
            f"cannot retarget to {resolved!r} in the same process "
            "(the build directory is process-global — see the "
            "idempotence contract in utils/compile_cache.py)"
        )
    _configured_dir = resolved
    obs.register_provider(_record_cache_entries)


def _reset_for_tests() -> None:
    """Forget the committed cache dir (lets a test exercise the
    idempotence contract; restore the prior value afterwards)."""
    global _configured_dir
    _configured_dir = None
