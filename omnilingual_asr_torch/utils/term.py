"""Clean SIGTERM handling for trainers and servers.

Python's default SIGTERM disposition ends the process without running
``finally`` blocks, context managers or atexit hooks. A trainer stopped with
a plain ``kill <pid>`` (by a queue's watchdog, ``utils/watchdog.py``) then
leaves behind whatever those would have closed: a half-written metrics log,
a temporary checkpoint file, a CUDA context torn down mid-copy. Installing
this handler turns SIGTERM into ``SystemExit``, so all of them run.

The port of ``omnilingual_asr_tpu/utils/term.py``; every trainer's ``main``
calls it first.
"""

from __future__ import annotations

import signal
import sys


def install_sigterm_exit() -> None:
    """Route SIGTERM through ``sys.exit(0)`` (idempotent, main thread
    only: a no-op where signals cannot be installed)."""
    try:
        signal.signal(
            signal.SIGTERM, lambda _sig, _frm: sys.exit(0))
    except (ValueError, OSError):  # not the main thread, or no signals
        pass
