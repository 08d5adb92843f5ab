"""``combblas_tpu_torch.serve.net`` — the TCP network front door (round
19); counterpart of ``combblas_tpu/serve/net/``.

Layer 10 of the serving stack (``serve/__init__.py`` has the map):
``frontend.py`` listens on a stdlib TCP socket and bridges the
versioned wire protocol (``protocol.py``, spoken over the shared
``serve/frame.py`` codec — one codec, two transports) to any
in-process backend (``Server``/``PoolServer``/``FleetRouter``/
``ProcessFleet``); ``client.py`` is the blocking client; and
``loadgen.py`` is the OPEN-LOOP Poisson load harness
(``python -m combblas_tpu_torch.serve.net.loadgen``, on the card by
default) — the coordinated-omission-free serving bench.
``protocol.py``'s docstring has the frames, the status taxonomy table
and the deadline semantics.
"""

from .client import NetClient
from .frontend import NetFrontend
from .protocol import (
    ERROR_STATUSES,
    PROTOCOL_VERSION,
    wire_error,
    wire_exception,
)

__all__ = [
    "NetClient",
    "NetFrontend",
    "PROTOCOL_VERSION",
    "ERROR_STATUSES",
    "wire_error",
    "wire_exception",
]
