"""paged_mla_decode_roofline: the paged latent-attention decode kernel's
share of its roofline over the profiled stretch: the least time the H100
could take for its launches (roofline/work.py, from each step's row
lengths, one launch a step in each layer with attention) over their
device time (by kernel name), in percent.  None where the kernel did not
run."""
import configs
from roofline import peaks, work

KERNELS = ("paged_mla_decode",)


def read(run):
    s, log = getattr(run, "summary", None), getattr(run, "log", None)
    if s is None or log is None:
        return None
    device_s, launches = s.kernel_seconds(KERNELS)
    if not launches:
        return None
    cfg = run.cfg
    layers, H = configs.arch(cfg).attention(cfg)[:2]
    pseq = -(-run.max_len // run.page_size)
    bound = 0.0
    for c in log.calls:
        if c.kind == "decode" and log.traced_call(c):
            nbytes, flops = work.paged_mla_decode(
                c.lengths, run.page_size, pseq, H, cfg["kv_lora_rank"],
                cfg["qk_rope_head_dim"])
            bound += layers * peaks.bound_s(nbytes, flops)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
