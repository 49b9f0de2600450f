"""mfu.train: model FLOPs of the window's training rounds (6 N a token
for the products, the head included, and three times the forward's
causal attention; no recomputation) over the window's seconds, as a share
of the H100's bf16 peak, in percent; the syncs' time counts, the profiled
stretch is left out."""
from roofline import model


def round_flops(cfg, traffic) -> float:
    B, S = int(traffic["batch"]), int(traffic["seq_len"])
    C = int(traffic["clusters"])
    tokens = C * B * S
    prods = 6 * (model.matmul_params(cfg) * tokens
                 + cfg["hidden_size"] * cfg["vocab_size"] * tokens)
    attn = 3 * model.attention_flops(cfg, C * B * S * (S + 1) // 2)
    return prods + attn


def read(run):
    log = getattr(run, "log", None)
    if log is None or not hasattr(log, "steps"):
        return None
    n = sum(1 for s in log.steps if s.kind == "round" and log.in_window(s)
            and log.untraced(s))
    return model.mfu_percent(n * round_flops(run.cfg, run.traffic),
                             log.untraced_seconds())
