"""train.local_step_ms: wall milliseconds of one cluster's local step
(a round's wall over the clusters), over the window's rounds outside the
profiled stretch."""


def read(run):
    log = getattr(run, "log", None)
    if log is None or not hasattr(log, "steps"):
        return None
    walls = [s.t1 - s.t0 for s in log.steps if s.kind == "round"
             and log.in_window(s) and log.untraced(s)]
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls) / int(run.traffic["clusters"])
