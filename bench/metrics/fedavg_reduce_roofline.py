"""fedavg_reduce_roofline: the FedAvg reduction kernel's share of its
roofline over the profiled sync: each launch reads the C replicas of N
elements and C weights and writes N (chip_smoke.py's count), N the
parameters of the one dtype group, over the launches' device time (by
kernel name), in percent.  One launch a dtype group a sync."""
import math

from roofline import peaks
from benchkit import weights

KERNELS = ("fedavg_reduce",)


def read(run):
    s, log = getattr(run, "summary", None), getattr(run, "log", None)
    if s is None or log is None or not hasattr(log, "steps"):
        return None
    device_s, launches = s.kernel_seconds(KERNELS)
    if device_s <= 0 or launches == 0:
        return None
    leaves = weights.leaves(run.cfg)
    C = int(run.traffic["clusters"])
    bound = 0.0
    for kinds, item in ((("normal", "scale"), 2), (("router",), 4)):
        n = sum(math.prod(shape) for _, shape, kind, _ in leaves
                if kind in kinds)
        if n:
            bound += peaks.bound_s(C * n * item + C * 4 + n * item, 2 * C * n)
    syncs = sum(1 for st in log.steps if st.kind == "sync"
                and log.traced[0] <= st.t0 and st.t1 <= log.traced[1])
    if not syncs:
        return None
    return 100.0 * syncs * bound / device_s
