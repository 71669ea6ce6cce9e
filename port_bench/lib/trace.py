"""Reading a ``torch.profiler`` trace of a few steady requests or steps.

The harness wraps its own calls in ``record_function`` spans named
``bench.*`` (a request or step, and its stages); the program has no spans
of its own yet.  From the trace: the device's busy time (the union of
kernel, copy and set intervals), the window (the outermost span), device
time by kernel name, and the idle gaps, each labelled by the innermost
harness span the host was in when the device went idle.
"""

from __future__ import annotations

import contextlib
import re


def kernel_name(name: str) -> str:
    """A device event's kernel name without namespace, return type and
    arguments: ``"void (anonymous namespace)::fps_kernel<1024>(float
    const*, ...)"`` → ``"fps_kernel<1024>"``."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split()[0]
    m = re.search(r"(\w+)\s*(<[^()]*>)?\s*\(",
                  name.replace("(anonymous namespace)::", "").replace(
                      "void ", ""))
    return (m.group(1) + (m.group(2) or "")) if m else name


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@contextlib.contextmanager
def profiled(device):
    """``with profiled(dev) as box: ...`` → ``box['trace']`` a
    :class:`Trace` once the block has run (the block must synchronize)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    box = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            yield box
    box["trace"] = Trace(prof)


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = list(prof.events())
        self.spans = [(e.name, e.time_range.start, e.time_range.end)
                      for e in events if e.device_type == DeviceType.CPU
                      and e.name.startswith("bench.")]
        win = [s for s in self.spans if s[0] == "bench.window"]
        self.start, self.end = win[0][1], win[0][2]
        # the harness's own spans also appear on the device's timeline
        # (user annotations): they are no device work
        self.device = [(kernel_name(e.name), e.time_range.start,
                        e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA
                       and not e.name.startswith("bench.")]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return _union([(max(s, self.start), min(e, self.end))
                       for _, s, e in self.device
                       if e > self.start and s < self.end]) / 1e6

    def by_kernel(self) -> dict:
        """Device seconds by kernel name."""
        out: dict = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
        return out

    def seconds_of(self, prefixes) -> float:
        return sum(v for k, v in self.by_kernel().items()
                   if k.startswith(tuple(prefixes)))

    def idle_gaps(self):
        """[(label, start_us, seconds)] of every stretch of the window with
        no device activity."""
        iv = sorted((max(s, self.start), min(e, self.end))
                    for _, s, e in self.device
                    if e > self.start and s < self.end)
        gaps, t = [], self.start
        for s, e in iv:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        out = []
        for g0, g1 in gaps:
            inner = [sp for sp in self.spans if sp[1] <= g0 < sp[2]]
            label = max(inner, key=lambda sp: sp[1])[0] if inner else "host"
            out.append((label, g0, (g1 - g0) / 1e6))
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and idle time
        summed by the harness span the host was in, the ten largest."""
        ops = sorted(self.by_kernel().items(), key=lambda kv: -kv[1])[:10]
        idle: dict = {}
        for label, _, sec in self.idle_gaps():
            idle[label] = idle.get(label, 0.0) + sec
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}
