"""The program's own spans in a traced run.

The program records its stage spans (``dispu_tpu_torch.utils.tracing``)
while a profiler records, which in a run is the profiled sub-window
alone; :func:`of` reads them after it.  ``Trace`` keeps times relative to
the trace's start and not the start itself, so the records are aligned to
it by the harness spans that directly wrap the program's entries
(:data:`PAIRS`): the offset is the median of the per-unit differences of
their starts, of their ends or of their centres, whichever spread least
(the train driver gathers the batch inside ``bench.step`` before it
calls the step, and the host's CPU is shared, so a start can lag by 0.2
ms), and a spread of those differences (between their first and third
quartiles) over :data:`MAX_SPREAD_US` refuses the alignment.  Each idle gap of the trace
then goes, by its start, to the innermost program span open on the
calling thread (``lib/trace.py``'s rule for the harness's spans), and is
summed by the stage it lies in: the child of the unit's outermost span
(``serve.request``, ``train.step``), that span itself for its own time.
On a program without the tracer, :func:`of` gives None."""

from __future__ import annotations

import statistics
import sys

#: harness span → the program span it directly wraps
PAIRS = {"bench.generate": "serve.generate", "bench.step": "train.step"}
MAX_SPREAD_US = 50.0
#: the stage of a gap when no program span was open
OUTSIDE = "outside"


def spread(values):
    """The distance between the first and the third quartile (0 for one
    value, None for none)."""
    if len(values) < 2:
        return 0.0 if values else None
    q1, _, q3 = statistics.quantiles(values, n=4, method="inclusive")
    return q3 - q1


class Spans:
    """``records`` (``tracing.Record`` s) against ``trace`` (its ``spans``
    and ``idle_gaps()``) over ``units`` units."""

    def __init__(self, records, trace, units):
        self.records, self.units = list(records), units
        paired = self._pairs(trace)
        self.thread = paired[0][2].thread if paired else None
        self.spread_us = self.side = self.offset_us = None
        self.lags_us, self.spreads = [], {}
        if paired:
            # the starts', the ends' or the centres' differences, whichever
            # spread least
            starts = [r.t0_ns / 1e3 - s for s, _, r in paired]
            ends = [r.t1_ns / 1e3 - e for _, e, r in paired]
            self.spreads = {
                side: (spread(d), side, d) for side, d in (
                    ("starts", starts), ("ends", ends),
                    ("centres", [(a + b) / 2 for a, b in zip(starts, ends)]))}
            self.spread_us, self.side, diffs = min(self.spreads.values())
            self.lags_us = [d - min(diffs) for d in diffs]
            if self.spread_us <= MAX_SPREAD_US:
                self.offset_us = statistics.median(diffs)
        self.stage_s: dict = {}   # idle s by stage
        self.within_s: dict = {}  # idle s while a span of the name was open
        self.harness_s: dict = {}  # idle s by harness label, for the log
        if self.offset_us is not None:
            self._attribute(trace.idle_gaps())

    def _pairs(self, trace):
        """[(harness span start µs, its end µs, program record)], one a
        unit, where the counts agree."""
        for outer, inner in PAIRS.items():
            theirs = sorted((s, e) for name, s, e in trace.spans
                            if name == outer)
            mine = sorted((r for r in self.records if r.name == inner),
                          key=lambda r: r.t0_ns)
            if theirs and len(theirs) == len(mine):
                return [(s, e, r) for (s, e), r in zip(theirs, mine)]
        return []

    def _attribute(self, gaps):
        own = [r for r in self.records if r.thread == self.thread]
        for label, g0_us, sec in gaps:
            if label in PAIRS:
                self.harness_s[label] = self.harness_s.get(label, 0.0) + sec
            at_ns = (g0_us + self.offset_us) * 1e3
            chain = sorted((r for r in own if r.t0_ns <= at_ns < r.t1_ns),
                           key=lambda r: r.t0_ns)
            stage = (chain[1] if len(chain) > 1 else chain[0]).name \
                if chain else OUTSIDE
            self.stage_s[stage] = self.stage_s.get(stage, 0.0) + sec
            for name in {r.name for r in chain}:
                self.within_s[name] = self.within_s.get(name, 0.0) + sec

    def has(self, name) -> bool:
        return any(r.name == name for r in self.records)

    def host_ms(self, name):
        """Host ms a unit inside spans ``name`` (None where none opened)."""
        if not self.has(name):
            return None
        return sum(r.t1_ns - r.t0_ns for r in self.records
                   if r.name == name) / 1e6 / self.units

    def syncs(self, name):
        """The host's waits a unit inside spans ``name``."""
        if not self.has(name):
            return None
        return sum(r.syncs for r in self.records
                   if r.name == name) / self.units

    def stage_idle_ms(self, *stages):
        """Device-idle ms a unit while the host was in the stages (their
        child spans included); None without alignment or without any of
        the stages."""
        if self.offset_us is None or not any(self.has(s) for s in stages):
            return None
        return 1e3 * sum(self.stage_s.get(s, 0.0)
                         for s in stages) / self.units

    def table(self) -> str:
        """Host ms, idle ms and syncs a unit, by span name."""
        names = list(dict.fromkeys(r.name for r in self.records))
        lines = [f"program spans ({self.units} units; alignment "
                 + ("refused" if self.offset_us is None else "spread")
                 + f" {self.spread_us} us by the {self.side} ("
                 + ", ".join(f"{k} {v[0]}" for k, v in self.spreads.items())
                 + "); lags over the least "
                 + " ".join(f"{x:.1f}" for x in self.lags_us) + " us):",
                 f"  {'span':<16}{'n/unit':>8}{'host ms':>11}"
                 f"{'idle ms':>11}{'syncs':>8}"]
        for n in names:
            count = sum(r.name == n for r in self.records) / self.units
            idle = (f"{1e3 * self.within_s.get(n, 0.0) / self.units:11.3f}"
                    if self.offset_us is not None else f"{'-':>11}")
            lines.append(f"  {n:<16}{count:8.2f}{self.host_ms(n):11.3f}"
                         f"{idle}{self.syncs(n):8.2f}")
        if self.offset_us is not None:
            lines.append("  idle ms a unit by stage: " + ", ".join(
                f"{k} {1e3 * v / self.units:.3f}"
                for k, v in sorted(self.stage_s.items(),
                                   key=lambda kv: -kv[1])))
            lines.append("  harness idle ms a unit: " + ", ".join(
                f"{k} {1e3 * v / self.units:.3f}"
                for k, v in self.harness_s.items()))
        return "\n".join(lines)


def of(run, log=sys.stderr):
    """The :class:`Spans` of ``run``'s profiled sub-window, made and logged
    once a run; None where the program records no spans."""
    if not hasattr(run, "_program_spans"):
        run._program_spans = None
        try:
            from dispu_tpu_torch.utils import tracing
        except ImportError:
            return None
        records = tracing.records()
        if records and run.trace is not None and run.units:
            run._program_spans = Spans(records, run.trace, run.units)
            print(run._program_spans.table(), file=log)
    return run._program_spans
