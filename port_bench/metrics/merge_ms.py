"""Device ms a request spends from the program's ``merge`` call to its
return (the merge FPS and the gather; CUDA events as ``generate_ms``), the
mean over the traced run's window."""


def read(run):
    ev = [e for e in run.record.get("events", []) if len(e) == 6]
    if not ev:
        return None
    return sum(e[4].elapsed_time(e[5]) for e in ev) / len(ev)
