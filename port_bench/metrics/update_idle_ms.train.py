"""Device-idle ms a step while the host is in the program's span
``train.update`` (the Adam update of the generator), over the profiled
steps (``lib/spans.py``)."""

from port_bench.lib import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.stage_idle_ms("train.update")
