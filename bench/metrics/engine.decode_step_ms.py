"""engine.decode_step_ms: wall milliseconds of the engine's decode step
(call to return, tokens on the host) averaged over the window's steps
outside the profiled stretch."""


def read(run):
    log = getattr(run, "log", None)
    if log is None:
        return None
    walls = [c.t1 - c.t0 for c in log.calls if c.kind == "decode"
             and log.in_window(c) and log.untraced(c)]
    return 1e3 * sum(walls) / len(walls) if walls else None
