"""Trainer-watchdog decision logic, kept apart so that it is unit-testable.

The port of ``omnilingual_asr_tpu/utils/watchdog.py`` (host code only; the
port keeps its own copy). A long training run can wedge in two ways that
leave its process alive:

  (b) at the first step: the process lives on but its metrics log is never
      written. A watchdog that fires only on a stale non-empty log never
      fires, so an empty log has its own limit (a clean start-up, with
      compilation and a filled data pool, has taken up to ~15 min; 26 min
      was already wedged).
  (c) mid-run: the metrics stop and every thread waits. A stale-log check
      catches this.

(Signature (a), a device claim that hangs before any process starts, is
guarded by running the claim under ``timeout``, not here.)

:func:`should_kill` is the single place the decision table is written
down; ``tests/test_torch_trainers_text.py`` runs it, and the JAX package's,
on fabricated log states.

    python -m omnilingual_asr_torch.utils.watchdog --pid P --log L

runs the same logic as a standalone supervisor: it sends SIGTERM (which
a trainer that called ``utils/term.py::install_sigterm_exit`` turns into
a clean exit), then SIGKILL, and exits 97 when it killed the process.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["WatchdogPolicy", "should_kill", "observe", "watch"]


@dataclasses.dataclass(frozen=True)
class WatchdogPolicy:
    """Kill thresholds, in seconds.

    ``stale_s``: max age of the newest line in a non-empty metrics log
    (signature (c)); trainer eval cadence bounds the healthy gap — 1500 s
    covers a 500-step eval interval at the slowest observed 0.5 steps/s.

    ``empty_limit_s``: max total runtime with a still-empty metrics log
    (signature (b)); must exceed the worst clean startup (claim + compile
    + device-pool fill ≈ 15 min) by a safety margin.
    """

    stale_s: float = 1500.0
    empty_limit_s: float = 1560.0


def should_kill(log_size: int, log_age_s: Optional[float],
                elapsed_s: float,
                policy: WatchdogPolicy = WatchdogPolicy(),
                ) -> Tuple[bool, str]:
    """Decide whether a watched trainer is wedged.

    log_size: bytes currently in the metrics log (0 = never written).
    log_age_s: seconds since the log's last modification (None if absent).
    elapsed_s: seconds since the trainer was started.
    Returns (kill?, reason). reason is "" when healthy.
    """
    if log_size > 0 and log_age_s is not None:
        if log_age_s > policy.stale_s:
            return True, (f"stale log: no metrics for {log_age_s:.0f}s "
                          f"> {policy.stale_s:.0f}s (wedge signature (c))")
        return False, ""
    # Empty (or missing) log: the trainer has not reached its first
    # metric line. Healthy only while within the startup envelope.
    if elapsed_s > policy.empty_limit_s:
        return True, (f"empty log after {elapsed_s:.0f}s "
                      f"> {policy.empty_limit_s:.0f}s (wedge signature (b))")
    return False, ""


def observe(log_path: Path, started_at: float,
            now: Optional[float] = None) -> Tuple[int, Optional[float], float]:
    """Filesystem observation feeding :func:`should_kill`."""
    now = time.time() if now is None else now
    try:
        st = os.stat(log_path)
        return st.st_size, max(0.0, now - st.st_mtime), now - started_at
    except OSError:
        return 0, None, now - started_at


def watch(pid: int, log_path: Path,
          policy: WatchdogPolicy = WatchdogPolicy(),
          poll_s: float = 60.0, kill_grace_s: float = 10.0) -> int:
    """Supervise ``pid`` until it exits or wedges. Returns 0 if the process
    exited on its own, 97 if the watchdog killed it (the queue scripts'
    convention for 'wedged, retry the segment')."""
    import signal

    def alive(p: int) -> bool:
        try:
            os.kill(p, 0)
        except ProcessLookupError:
            return False
        # A zombie (exited, unreaped by its real parent) still answers
        # kill(0); it is NOT running and must count as a clean exit.
        try:
            with open(f"/proc/{p}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return False
        except OSError:
            return False
        return True

    started = time.time()
    while True:
        if not alive(pid):
            return 0
        time.sleep(poll_s)
        size, age, elapsed = observe(Path(log_path), started)
        kill, reason = should_kill(size, age, elapsed, policy)
        if kill:
            print(f"watchdog: {reason}; killing {pid}", flush=True)
            try:
                os.kill(pid, signal.SIGTERM)
                time.sleep(kill_grace_s)
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            return 97


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--log", type=Path, required=True)
    ap.add_argument("--stale-s", type=float, default=1500.0)
    ap.add_argument("--empty-limit-s", type=float, default=1560.0)
    ap.add_argument("--poll-s", type=float, default=60.0)
    args = ap.parse_args(argv)
    raise SystemExit(watch(
        args.pid, args.log,
        WatchdogPolicy(stale_s=args.stale_s,
                       empty_limit_s=args.empty_limit_s),
        poll_s=args.poll_s))


if __name__ == "__main__":
    main()
