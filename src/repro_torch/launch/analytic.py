"""Analytic (napkin-math) roofline model per (arch x shape x mesh), the
counterpart of ``repro/launch/analytic.py``: its flop and byte terms
verbatim, on the port's ``layer_window`` / ``FULL_WINDOW``, and its
seconds on the H100 constants of ``launch/mesh.py`` (NVIDIA H100 80GB
HBM3 at 700 W; peak and link rates from NVIDIA's datasheets).

Why it exists (the reference's reason): a trace of a scanned or looped
program need not show every trip.  The port's dry run traces one
microbatch of a train step and scales it (``launch/dryrun.py``); this
model sizes every term with the right trip counts.

The port splits the reference's ``ici_bytes`` in two, by where the
traffic runs on a cluster of 8-GPU nodes: ``nvlink_bytes``, the
tensor-parallel all-reduces over ``"model"`` (one node), and
``ib_bytes``, the FSDP gathers and gradient scatters over ``"data"``
(across nodes).  They sum to ``ici_bytes``.  Cross-pod traffic
(``dci_bytes``) is charged at ``IB_BW`` and reported apart.

Not a fault, kept from the reference: the FSDP terms (``ag``, ``gs``)
count parameter traffic even on a mesh of one rank, where nothing moves.

All quantities are per-device per-step."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import (HBM_BW, IB_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.models.common import mesh_shape


def _axis(mesh_shape: Dict[str, int], name: str) -> int:
    return mesh_shape.get(name, 1)


def _chips(mesh_shape: Dict[str, int]) -> int:
    n = 1
    for v in mesh_shape.values():
        n *= v
    return n


@dataclass
class AnalyticRoofline:
    flops: float
    hbm_bytes: float
    ici_bytes: float                 # intra-pod collective bytes
    dci_bytes: float                 # cross-pod collective bytes
    nvlink_bytes: float = 0.0        # of ici: TP all-reduces, one node
    ib_bytes: float = 0.0            # of ici: FSDP traffic across nodes

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def cross_pod_s(self) -> float:
        return self.dci_bytes / IB_BW

    @property
    def collective_s(self) -> float:
        return (self.nvlink_bytes / NVLINK_BW + self.ib_bytes / IB_BW
                + self.cross_pod_s)

    @property
    def dominant(self) -> str:
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return max(t, key=t.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    def mfu(self, model_flops_per_dev: float) -> float:
        t = max(self.compute_s, self.memory_s, self.collective_s)
        return model_flops_per_dev / PEAK_FLOPS_BF16 / t if t else 0.0

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "ici_bytes": self.ici_bytes, "dci_bytes": self.dci_bytes,
                "nvlink_bytes": self.nvlink_bytes,
                "ib_bytes": self.ib_bytes,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "cross_pod_s": self.cross_pod_s, "dominant": self.dominant}


def _attn_flops_per_token(cfg: ArchConfig, s_context: float) -> float:
    """2 * (QK + AV) flops per token per layer-average."""
    m = cfg.model
    a = m.attention
    if a.kind == "none":
        return 0.0
    # average context per query (causal ~ S/2, windowed ~ min(W, S/2))
    total = 0.0
    L = m.num_layers
    from repro_torch.models.transformer import FULL_WINDOW, layer_window
    if m.family == "hybrid":
        n_attn = max(1, m.num_layers // max(m.shared_attn_every, 1))
        w = a.window or FULL_WINDOW
        ctx = min(w, s_context / 2)
        qk = a.num_heads * a.head_dim
        return n_attn / L * 4.0 * ctx * qk * 2  # QK^T + AV
    for i in range(L):
        w = layer_window(cfg.model, i)
        ctx = min(w, s_context / 2) if w != FULL_WINDOW else s_context / 2
        if a.kind == "mla" and a.mla:
            qk = a.num_heads * (a.mla.qk_nope_head_dim + a.mla.qk_rope_head_dim)
            av = a.num_heads * a.mla.v_head_dim
        else:
            qk = a.num_heads * a.head_dim
            av = qk
        total += 2.0 * ctx * (qk + av) * 2
    return total / L


def _cache_bytes_per_seq(cfg: ArchConfig, S: int) -> float:
    """KV/state cache bytes per sequence (decode reads all of it)."""
    m = cfg.model
    a = m.attention
    from repro_torch.models.transformer import FULL_WINDOW, layer_window
    if m.family == "ssm" and m.xlstm:       # matrix memories
        dc = int(m.d_model * m.xlstm.proj_factor_mlstm)
        hd = dc // m.xlstm.num_heads
        per_mlstm = m.xlstm.num_heads * hd * hd * 4
        return m.num_layers * per_mlstm
    if m.family == "hybrid" and m.ssm:
        d_in = m.d_model * m.ssm.expand
        H = d_in // m.ssm.head_dim
        per = H * m.ssm.state_dim * m.ssm.head_dim * 4
        n_attn = max(1, m.num_layers // max(m.shared_attn_every, 1))
        w = min(a.window or S, S)
        attn_cache = n_attn * w * a.num_kv_heads * a.head_dim * 2 * 2
        return m.num_layers * per + attn_cache
    total = 0.0
    for i in range(m.num_layers):
        w = layer_window(cfg.model, i)
        c = min(w, S) if w != FULL_WINDOW else S
        if a.kind == "mla" and a.mla:
            total += c * (a.mla.kv_lora_rank + a.mla.qk_rope_head_dim) * 2
        else:
            total += c * a.num_kv_heads * a.head_dim * 2 * 2
    return total


def activation_peak_bytes(cfg: ArchConfig, shape: InputShape, mesh) -> float:
    """Per-device activation high-water mark (remat stashes + logits +
    attention transient) — complements XLA's argument accounting, whose
    CPU-backend peak metric mirrors argument size."""
    m = cfg.model
    ms = mesh_shape(mesh)
    chips = _chips(ms)
    dp = _axis(ms, "pod") * _axis(ms, "data") * _axis(ms, "cluster")
    tp = _axis(ms, "model")
    B, S = shape.global_batch, shape.seq_len
    d_bytes = 2
    vocab = m.padded_vocab if m.vocab_size else 1
    if shape.mode == "train":
        k = max(cfg.run.microbatches, 1)
        tok_dev = B * S / dp / k
        stash = tok_dev * m.d_model * d_bytes * max(m.num_layers, 1) / tp
        logits = tok_dev * vocab / tp * 4 * 2     # fwd fp32 + grad
        a = m.attention
        heads_dev = max(1, a.num_heads // tp)
        chunk = min(S, 2048)
        attn_t = heads_dev * chunk * min(S, 1 << 30) * 4 * (B / dp / k)
        return stash + logits + attn_t
    if shape.mode == "prefill":
        tok_dev = B * S / dp
        act = tok_dev * m.d_model * d_bytes * 4 / tp
        logits = tok_dev * vocab / tp * 2
        return act + logits
    bdev = max(1.0, B / dp)
    return bdev * vocab * 4 + bdev * m.d_model * 4 * 8


def analytic_roofline(cfg: ArchConfig, shape: InputShape, mesh,
                      hfl_mode: bool = False,
                      global_sync_this_step: bool = False
                      ) -> AnalyticRoofline:
    m = cfg.model
    ms = mesh_shape(mesh)
    chips = _chips(ms)
    dp = _axis(ms, "pod") * _axis(ms, "data") * _axis(ms, "cluster")
    tp = _axis(ms, "model")
    B, S = shape.global_batch, shape.seq_len
    n_active = m.active_param_count()
    p_bytes_total = m.param_count() * 2          # bf16
    p_dev = p_bytes_total / chips
    d_bytes = 2

    if shape.mode == "train":
        tokens = B * S
        tok_dev = tokens / dp
        remat_f = 4.0 / 3.0 if cfg.run.remat != "none" else 1.0
        flops = (6.0 * n_active + 3.0 * _attn_flops_per_token(cfg, S)
                 ) * tokens * remat_f / chips
        k = cfg.run.microbatches
        # HBM: weights touched fwd+bwd+remat per microbatch (gathered copies
        # are written+read), grads, optimizer read+write
        opt_itemsize = 4 if cfg.run.opt_state_dtype == "float32" else 2
        opt_dev = m.param_count() * 2 * opt_itemsize / chips
        hbm = (p_dev * 3 * k                      # weight reads x microbatch
               + p_dev * 2                        # grad write+read
               + opt_dev * 2                      # moments r/w
               + tok_dev * m.d_model * d_bytes * m.num_layers / tp * 8)
        # collectives:
        #  - FSDP all-gather of params over 'data' (+pod if not HFL) per
        #    microbatch x (fwd + bwd-with-remat ~ 2)
        #  - gradient reduce-scatter over the same axes
        #  - 2 TP all-reduces per layer per microbatch of activations
        ag = p_dev * 2 * k
        gs = p_dev
        tp_ar = (2 * m.num_layers * tok_dev * m.d_model * d_bytes / tp * k
                 ) if tp > 1 else 0.0
        ici = ag + gs + tp_ar
        dci = 0.0
        if "pod" in ms and ms["pod"] > 1 and not hfl_mode:
            # flat data-parallel spans pods: grad sync crosses DCI
            dci = gs
        if hfl_mode and global_sync_this_step:
            dci = p_dev                           # param mean across pods
        return AnalyticRoofline(flops, hbm, ici, dci, nvlink_bytes=tp_ar,
                                ib_bytes=ag + gs)

    if shape.mode == "prefill":
        tokens = B * S
        flops = (2.0 * n_active + _attn_flops_per_token(cfg, S)
                 ) * tokens / chips
        tok_dev = tokens / dp
        hbm = p_dev + tok_dev * m.d_model * d_bytes * m.num_layers / tp * 4
        tp_ar = (2 * m.num_layers * tok_dev * m.d_model * d_bytes / tp
                 ) if tp > 1 else 0.0
        ici = p_dev + tp_ar                       # weight all-gather + TP
        return AnalyticRoofline(flops, hbm, ici, 0.0, nvlink_bytes=tp_ar,
                                ib_bytes=p_dev)

    # decode: one token per sequence, read the whole cache
    flops = (2.0 * n_active * B
             + 2.0 * _cache_bytes_per_seq(cfg, S) / 2 * B) / chips
    cache_dev = _cache_bytes_per_seq(cfg, S) * B / chips
    bdev = max(1.0, B / dp)
    hbm = p_dev + cache_dev + cache_dev           # read + rewrite cache
    tp_ar = (2 * m.num_layers * bdev * m.d_model * d_bytes
             ) if tp > 1 else 0.0
    ici = tp_ar + p_dev * 0.0                     # weights resident for decode
    return AnalyticRoofline(flops, hbm, ici, 0.0, nvlink_bytes=tp_ar,
                            ib_bytes=0.0)
