"""The host's waits on the device a request, inside the program's span
``serve.request`` (``upsample_many``, the copies to and from the card
included): the tracer's sync counter over the profiled requests."""

from port_bench.lib import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.syncs("serve.request")
