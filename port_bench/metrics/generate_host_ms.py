"""Host ms a request inside the program's span ``serve.generate`` (the
generator's chunks and passes, as the host enqueues them), over the
profiled requests; the device's ms there stay ``generate_ms``."""

from port_bench.lib import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.host_ms("serve.generate")
