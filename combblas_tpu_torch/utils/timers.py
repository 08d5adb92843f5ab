"""Phase timers — counterpart of ``combblas_tpu/utils/timers.py``, a
COMPATIBILITY SHIM over ``combblas_tpu_torch.obs``.

Host-side phase accumulation (≈ the reference's cblas_* counters,
CombBLAS.h:77-102). ``phase`` records into the same span accumulator
``obs.report()`` reads; new code should use ``obs.span`` /
``obs.span_event`` directly. ``annotate`` is
``torch.profiler.record_function`` (the reference's
``jax.profiler.TraceAnnotation``), and ``trace`` captures a
``torch.profiler`` trace (the reference's ``jax.profiler`` device trace).

``ENABLED`` here keeps its historical meaning (phases accumulate even
when the global obs flag is off); flip it False to silence this module
alone.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .. import obs

ENABLED = True


def phase(name: str, *, sync=None):
    """Accumulate wall time under ``name`` (≈ one cblas_* counter).

    ``sync``: optional tensor (or container of tensors) whose CUDA streams
    are synchronised before the timer closes, so async launches don't hide
    device time.
    """
    if not ENABLED:  # the historical silencing knob, obs flag or not
        return obs.NULL_SPAN
    return obs.span(name, sync=sync, force=True)


def get(name: str) -> float:
    return obs.span_seconds(name)


def report(reset: bool = False) -> dict[str, tuple[float, int]]:
    """{name: (seconds, calls)} — the per-app timing table the reference
    prints after each run."""
    return obs.report(reset=reset)


def reset_all():
    obs.reset_spans()


def print_report(reset: bool = False):
    obs.print_report(reset=reset)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (the CPU
    and, where there is one, the CUDA timeline) and write it into
    ``logdir`` as a Chrome trace, ``trace-<pid>.json`` (Perfetto /
    chrome://tracing — the PAPI/MPI_Pcontrol analog). Spans and
    ``annotate`` ranges show up in it by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))


annotate = torch.profiler.record_function
