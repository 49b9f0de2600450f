"""serve_tokens_per_s: output tokens returned to clients inside the
window (each admission's first token and every live row's token of each
decode step, stamped when the call returned), over the window's
seconds."""


def read(run):
    log = getattr(run, "log", None)
    if log is None:
        return None
    return sum(c.tokens for c in log.calls if log.in_window(c)) / run.seconds
