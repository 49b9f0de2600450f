"""fl.sync_ms: wall milliseconds of a global sync (the replicas'
FedAvg, ``global_sync``) over the window's syncs outside the profiled
stretch."""


def read(run):
    log = getattr(run, "log", None)
    if log is None or not hasattr(log, "steps"):
        return None
    walls = [s.t1 - s.t0 for s in log.steps if s.kind == "sync"
             and log.in_window(s) and log.untraced(s)]
    return 1e3 * sum(walls) / len(walls) if walls else None
