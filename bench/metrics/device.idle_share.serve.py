"""device.idle_share.serve: share of the profiled stretch in which no
device operation ran, in percent (``TraceSummary.idle_percent``)."""


def read(run):
    s = getattr(run, "summary", None)
    return s.idle_percent() if s is not None else None
