"""Public wrappers of the port's kernels, the counterpart of
``repro/kernels/ops.py``: every TPU kernel of the JAX package has one,
and the dense decode kernel a second instance,
``decode_attention_partial``, for a cache split along its slots over
ranks.

Each wrapper counts its kernel launches in a plain integer
(``gru_seq.launches``), so a run can show that its path went through
the kernel; ``flash_attention`` also counts the launches of its split's
merge kernel (``flash_attention.merges``, ``"flash_attention_merge"`` in
:func:`launch_counts`).  On the card, with grad mode on and a floating
input that requires grad, a wrapper's output stays in the graph: the
forward is the kernel's, the backward its plain version's
(``kernels/_grad.py``)."""
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_partial)
from repro_torch.kernels.fedavg_reduce import fedavg_reduce
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gru_cell import gru_seq
from repro_torch.kernels.mamba_scan import mamba_chunk_scan
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention, paged_mla_decode_attention)
from repro_torch.kernels.topk_router import topk_router

KERNELS = (gru_seq, fedavg_reduce, flash_attention, decode_attention,
           decode_attention_partial, paged_decode_attention,
           paged_mla_decode_attention, topk_router, mamba_chunk_scan)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    flash_attention.merges = 0


def launch_counts() -> dict:
    return {**{k.__name__: k.launches for k in KERNELS},
            "flash_attention_merge": flash_attention.merges}


__all__ = ["decode_attention", "decode_attention_partial", "fedavg_reduce", "flash_attention",
           "gru_seq", "launch_counts", "mamba_chunk_scan",
           "paged_decode_attention", "paged_mla_decode_attention",
           "reset_launches", "topk_router"]
