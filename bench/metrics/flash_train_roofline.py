"""flash_train_roofline: the flash attention kernel's share of its
roofline over the profiled rounds: every launch at the training shape
(batch x heads rows of seq_len queries over as many keys, causal, at the
architecture's score and value dims; roofline/work.py) times its bound,
over the launches' device time (by kernel name, merges included), in
percent.  Forward launches only: the backward is plain PyTorch; a
layer's forward runs twice a step under per-layer recomputation, and
each launch counts."""
import configs
from roofline import peaks, work

KERNELS = ("flash_attention",)


def read(run):
    s, log = getattr(run, "summary", None), getattr(run, "log", None)
    if s is None or log is None or not hasattr(log, "steps"):
        return None
    device_s, _ = s.kernel_seconds(KERNELS)
    launches = sum(1 for n, _, _ in s.kernels
                   if "flash_attention" in n and "merge" not in n)
    if device_s <= 0 or launches == 0:
        return None
    _, H, Hkv, D, Dv = configs.arch(run.cfg).attention(run.cfg)
    B, S = int(run.traffic["batch"]), int(run.traffic["seq_len"])
    nbytes, flops = work.flash(B * H, B * Hkv, S, D, Dv)
    return 100.0 * launches * peaks.bound_s(nbytes, flops) / device_s
