"""Host-clock helpers the drivers share: the set-up's phases, and the
window's rate in slices (a record for the log, not a metric: it shows
whether a run's rate drifts inside its window or only between runs)."""

from __future__ import annotations

import time


class Clock:
    """Prints the seconds of each set-up phase to ``log``."""

    def __init__(self, log):
        self.log, self.t = log, time.time()

    def __call__(self, what):
        now = time.time()
        if self.log is not None:
            print(f"  set-up: {what} {now - self.t:.3f} s", file=self.log)
        self.t = now


def slice_rates(done_at, window_s, slice_s=5.0):
    """Units a second in each whole ``slice_s`` of the window, from the
    host seconds (since the window's start) at which each unit ended."""
    n = int(window_s // slice_s)
    counts = [0] * n
    for t in done_at:
        i = int(t // slice_s)
        if i < n:
            counts[i] += 1
    return [c / slice_s for c in counts]
