"""Signal chaining (port of ``dispatch_prev_handler`` from
``deepspeed_tpu/monitor/flight.py``; the flight recorder itself is not
ported yet). The checkpoint ``PreemptSaver`` (runtime/async_ckpt.py)
continues a SIGTERM through it after its final save."""
from __future__ import annotations

import os
import signal
import sys


def dispatch_prev_handler(prev, signum, frame, own_handler) -> None:
    """Continue a chained signal after our handler ran: call a callable
    prior handler, or re-raise under the default disposition so the
    process reports the true termination signal (None / C-installed
    handlers are opaque — dying by the signal is the only honest
    continuation; SIG_IGN stays ignored)."""
    if callable(prev) and prev is not own_handler:
        prev(signum, frame)
    elif prev in (signal.SIG_DFL, None):
        # If the process disposition still points at the caller (a chain
        # restored it), force the default first — otherwise the re-raise
        # would re-enter it forever.
        try:
            if signal.getsignal(signum) == own_handler:
                signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        try:
            os.kill(os.getpid(), signum)
        except Exception:
            sys.exit(128 + int(signum))


__all__ = ["dispatch_prev_handler"]
