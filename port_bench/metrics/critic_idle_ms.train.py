"""Device-idle ms a GAN step while the host is in the program's span
``train.critic`` (the critic's neighbourhoods and its update), over the
profiled steps (``lib/spans.py``)."""

from port_bench.lib import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.stage_idle_ms("train.critic")
