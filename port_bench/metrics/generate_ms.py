"""Device ms a request spends from the program's ``generate`` call to its
return (CUDA events the harness records around the call, no synchronize
between the stages), the mean over the traced run's window."""


def read(run):
    ev = [e for e in run.record.get("events", []) if len(e) == 6]
    if not ev:
        return None
    return sum(e[2].elapsed_time(e[3]) for e in ev) / len(ev)
