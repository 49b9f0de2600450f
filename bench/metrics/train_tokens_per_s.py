"""train_tokens_per_s: tokens of the local rounds the window completed,
the global syncs inside it, over the window's seconds; the round in
flight at the close counts for the share of it inside the window."""


def read(run):
    log = getattr(run, "log", None)
    if log is None or not hasattr(log, "steps"):
        return None
    tokens = 0.0
    for s in log.steps:
        if s.kind != "round" or s.t0 < log.t_start or s.t0 >= log.deadline:
            continue
        share = min(1.0, (log.deadline - s.t0) / (s.t1 - s.t0))
        tokens += s.tokens * share
    return tokens / run.seconds
