"""``lib/spans.py`` on a synthetic trace and record list: the alignment by
the harness spans that wrap the program's entries, its refusal past 50 µs
of spread, the idle gaps given to the stages, and the readers' None where
the program records no spans."""

import sys

import pytest

from dispu_tpu_torch.utils.tracing import Record
from port_bench.lib import cell as C
from port_bench.lib import spans as S

OFFSET_US = 1.7e12  # the trace's start on the host's clock, in µs
MAIN, OTHER = 11, 22


class FakeTrace:
    def __init__(self, spans, gaps):
        self.spans, self._gaps = spans, gaps

    def idle_gaps(self):
        return list(self._gaps)


def rec(name, parent, t0_us, t1_us, syncs=0, thread=MAIN):
    """A record at trace-relative µs."""
    return Record(name, parent, thread, int((t0_us + OFFSET_US) * 1e3),
                  int((t1_us + OFFSET_US) * 1e3), syncs)


def train_units(starts=(5.0, 5.0, 5.0), ends=(7.0, 12.0, 40.0)):
    """A step of 1,000 µs a pair of lags from 1,000 µs on, each wrapped by
    ``bench.step`` that starts a lag from ``starts`` before
    ``train.step`` and ends one from ``ends`` after it."""
    spans, records = [], []
    for i, (lag, after) in enumerate(zip(starts, ends)):
        t = 1000.0 * (i + 1)
        spans.append(("bench.step", t - lag, t + 890 + after))
        records += [
            rec("train.step", None, t, t + 890, syncs=25),
            rec("train.draw", "train.step", t + 10, t + 100),
            rec("train.forward", "train.step", t + 100, t + 400, syncs=25),
            rec("gen.extract", "train.forward", t + 110, t + 300, syncs=24),
            rec("train.losses", "train.step", t + 400, t + 500),
            rec("train.backward", "train.step", t + 500, t + 800),
            rec("train.update", "train.step", t + 820, t + 880),
        ]
    return spans, records


def gaps_of_each_step():
    """(label, start µs, s): in the draw, in gen.extract (the forward), in
    the backward, in the step's own time, and one before any step."""
    out = [("bench.window", 10.0, 5e-6)]
    for i in range(3):
        t = 1000.0 * (i + 1)
        out += [("bench.step", t + 50, 10e-6), ("bench.step", t + 200, 20e-6),
                ("bench.step", t + 600, 40e-6),
                ("bench.step", t + 810, 80e-6)]
    return out


def test_alignment_and_attribution():
    spans, records = train_units()
    s = S.Spans(records, FakeTrace(spans, gaps_of_each_step()), 3)
    assert s.spread_us == pytest.approx(0.0)
    assert s.offset_us == pytest.approx(OFFSET_US + 5.0)
    assert s.stage_idle_ms("train.draw") == pytest.approx(0.010)
    assert s.stage_idle_ms("train.forward") == pytest.approx(0.020)
    assert s.stage_idle_ms("train.draw", "train.forward", "train.losses") \
        == pytest.approx(0.030)
    assert s.stage_idle_ms("train.backward") == pytest.approx(0.040)
    assert s.stage_idle_ms("train.update") == pytest.approx(0.0)
    assert s.stage_idle_ms("train.step") == pytest.approx(0.080)
    assert s.stage_s[S.OUTSIDE] == pytest.approx(5e-6)
    assert s.stage_idle_ms("train.critic") is None  # no such span
    # the stages with the step's own time are the harness's bench.step
    inside = sum(v for k, v in s.stage_s.items() if k != S.OUTSIDE)
    assert inside == pytest.approx(s.harness_s["bench.step"])
    assert s.host_ms("train.step") == pytest.approx(0.890)
    assert s.syncs("train.step") == 25
    assert "train.forward" in s.table()


def test_spread_over_50_us_is_refused():
    # the middle unit's harness span 120 µs earlier against the program's
    # (its start and its end): every side's quartiles 60 µs apart
    spans, records = train_units(starts=(5.0, 125.0, 5.0),
                                 ends=(7.0, -113.0, 7.0))
    s = S.Spans(records, FakeTrace(spans, gaps_of_each_step()), 3)
    assert s.spread_us > S.MAX_SPREAD_US
    assert s.offset_us is None
    assert s.stage_idle_ms("train.backward") is None
    assert s.syncs("train.step") == 25  # the counts need no alignment
    assert "refused" in s.table()


def test_the_steadier_side_aligns():
    # one slow entry among many moves the quartiles little
    spans, records = train_units(starts=(300.0,) + (5.0,) * 7,
                                 ends=(7.0, 90.0) * 4)
    s = S.Spans(records, FakeTrace(spans, []), 8)
    assert (s.side, s.offset_us) == ("starts", pytest.approx(OFFSET_US + 5))
    # entries that lag by up to 0.2 ms: the ends align
    spans, records = train_units(starts=(0.0, 60.0, 200.0, 25.0),
                                 ends=(7.0, 9.0, 8.0, 7.0))
    s = S.Spans(records, FakeTrace(spans, []), 4)
    assert (s.side, s.offset_us) == ("ends", pytest.approx(OFFSET_US - 7.5))
    # a whole harness span longer on both sides: the centres align
    spans, records = train_units(starts=(5.0, 90.0, 5.0, 160.0),
                                 ends=(5.0, 90.0, 5.0, 160.0))
    s = S.Spans(records, FakeTrace(spans, []), 4)
    assert (s.side, s.spread_us) == ("centres", 0.0)
    assert s.offset_us == pytest.approx(OFFSET_US)


def test_gaps_go_to_the_calling_thread():
    spans, records = train_units()
    # autograd's thread, inside the draw's gap, opens a span of its own
    records.append(rec("gen.extract", None, 1040, 1060, thread=OTHER))
    s = S.Spans(records, FakeTrace(spans, gaps_of_each_step()), 3)
    assert s.stage_idle_ms("train.draw") == pytest.approx(0.010)
    assert "gen.extract" not in s.stage_s


def test_serving_aligns_by_generate():
    spans, records = [], []
    for i in range(2):
        t = 1000.0 * (i + 1)
        spans += [("bench.request", t - 20, t + 900),
                  ("bench.generate", t + 100, t + 600 + 40 * i)]
        records += [rec("serve.request", None, t, t + 880, syncs=27),
                    rec("serve.prepare", "serve.request", t + 10, t + 90),
                    rec("serve.generate", "serve.request", t + 103, t + 590,
                        syncs=25),
                    rec("serve.pass", "serve.generate", t + 110, t + 580),
                    rec("serve.merge", "serve.request", t + 600, t + 870)]
    gaps = [("bench.generate", 1000.0 * (i + 1) + 300, 1e-3)
            for i in range(2)]
    s = S.Spans(records, FakeTrace(spans, gaps), 2)
    assert s.side == "starts"  # the ends lag by 10 and 50 µs
    assert s.offset_us == pytest.approx(OFFSET_US + 3.0)
    assert s.stage_idle_ms("serve.generate") == pytest.approx(1.0)
    assert s.within_s["serve.pass"] == pytest.approx(2e-3)
    assert s.syncs("serve.request") == 27


class FakeRun:
    def __init__(self, trace, units):
        self.trace, self.units = trace, units


NEW = ("host_syncs.serve", "generate_host_ms", "generate_idle_ms",
       "host_syncs.train", "forward_idle_ms.train", "backward_idle_ms.train",
       "update_idle_ms.train", "critic_idle_ms.train")


@pytest.mark.parametrize("metric", NEW)
def test_readers_give_none_without_spans(metric, monkeypatch):
    from dispu_tpu_torch.utils import tracing

    tracing.clear()
    assert C.metric_reader(metric)(FakeRun(FakeTrace([], []), 3)) is None
    # a program without the tracer (the module does not import)
    import dispu_tpu_torch.utils

    monkeypatch.delattr(dispu_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "dispu_tpu_torch.utils.tracing", None)
    assert C.metric_reader(metric)(FakeRun(FakeTrace([], []), 3)) is None
