"""Median host ms for the program's ``step()`` call to return, over the
traced run's window, with no synchronize: the host's share of a step."""

import statistics


def read(run):
    enq = run.record.get("enqueue_s")
    if not enq:
        return None
    return 1e3 * statistics.median(enq)
