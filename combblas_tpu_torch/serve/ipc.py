"""Process-fleet IPC: the frame codec under its historical name;
counterpart of ``combblas_tpu/serve/ipc.py``.

The length-prefixed JSON+binary codec lives in ``serve/frame.py`` so the
process fleet and the network front door (``serve/net/``) share ONE
implementation — one codec, two
transports, no copy-paste drift.  This module is the procfleet-facing
alias kept for its import sites (``from .ipc import Channel,
ChannelClosed``) and for the obs series names, which stay
``serve.ipc.*`` for both transports (frame.py documents why).

See ``serve/frame.py`` for the wire format, the ``__ndb__`` ndarray
hoisting, and the Channel threading contract.
"""

from __future__ import annotations

from .frame import MAX_FRAME, Channel, ChannelClosed, decode, encode

__all__ = [
    "MAX_FRAME",
    "Channel",
    "ChannelClosed",
    "decode",
    "encode",
]
