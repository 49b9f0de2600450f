"""mfu.serve: model FLOPs of the work the window returned (every decoded
token at its context, every admitted prompt; roofline/model.py) over the
window's seconds, as a share of the H100's bf16 peak, in percent;
outside the profiled stretch."""
from roofline import model


def read(run):
    log = getattr(run, "log", None)
    if log is None:
        return None
    flops = 0
    for c in log.calls:
        if not (log.in_window(c) and log.untraced(c)):
            continue
        if c.kind == "admit":
            flops += model.prefill_flops(run.cfg, c.prompt_len)
        else:
            flops += sum(model.decode_token_flops(run.cfg, int(n))
                         for n in c.lengths[c.live])
    return model.mfu_percent(flops, log.untraced_seconds())
