"""The host's waits on the device a step, inside the program's span
``train.step``: the tracer's sync counter over the profiled steps."""

from port_bench.lib import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.syncs("train.step")
