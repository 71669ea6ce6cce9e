"""Device-idle ms a request while the host is in the program's span
``serve.generate`` (its passes' spans included), over the profiled
requests (``lib/spans.py``)."""

from port_bench.lib import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.stage_idle_ms("serve.generate")
