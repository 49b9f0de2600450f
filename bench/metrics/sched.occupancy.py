"""sched.occupancy: mean live rows per decode step of the window (the
scheduler's batch), from the harness's stamps, outside the profiled
stretch."""


def read(run):
    log = getattr(run, "log", None)
    if log is None:
        return None
    rows = [c.rows for c in log.calls if c.kind == "decode"
            and log.in_window(c) and log.untraced(c)]
    return sum(rows) / len(rows) if rows else None
