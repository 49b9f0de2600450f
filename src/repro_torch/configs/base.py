"""Configuration system of the PyTorch port: a copy of
``repro/configs/base.py``, kept in step with it by
``tests/test_torch_configs.py``.

Every architecture is expressed as a :class:`ModelConfig` plus a
:class:`RunConfig` describing how it is trained and served.  Configs are
frozen dataclasses so they can be hashed and compared.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 => no q compression (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "full"              # full | swa | local_global | mla | none
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    window: int = 0                 # sliding window size (swa / local layers)
    local_global_ratio: int = 0     # e.g. 5 => 5 local : 1 global (gemma3)
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0   # separate base for local layers (gemma3)
    rope_fraction: float = 1.0      # partial rotary (stablelm: 0.25)
    mla: Optional[MLAConfig] = None
    causal: bool = True
    qk_norm: bool = False           # gemma3 QK-norm
    logit_soft_cap: float = 0.0


# ---------------------------------------------------------------------------
# MoE / SSM / xLSTM
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared: int = 0             # always-on shared experts
    top_k: int = 2
    d_expert: int = 0               # per-expert FFN hidden size
    d_shared: int = 0               # shared-expert FFN hidden size (0 -> d_expert*num_shared)
    first_dense_layers: int = 0     # leading dense layers (deepseek: 1)
    aux_loss_coef: float = 0.001
    router_dtype: str = "float32"
    dense_d_ff: int = 0             # FFN size of the leading dense layers
    capacity_factor: float = 1.25   # dispatch buffer slack (tokens dropped beyond)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128                # SSD chunk length
    ngroups: int = 1


@dataclass(frozen=True)
class XLSTMConfig:
    num_heads: int = 4
    slstm_layers: Tuple[int, ...] = ()   # indices of sLSTM blocks; rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_width: int = 4


# ---------------------------------------------------------------------------
# Modality frontends (STUBS per the carve-out)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrontendConfig:
    """Audio/vision frontend stub: input_specs() provides embeddings."""
    kind: str = "none"              # none | audio_frames | vision_patches
    num_positions: int = 0          # e.g. 1500 audio frames / 256 image patches
    embed_dim: int = 0              # embedding dim delivered by the stub


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | hybrid | ssm | audio | vlm | rnn
    source: str = ""                # citation from the assignment table
    num_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32_000
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"               # silu (SwiGLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # hybrid (zamba2): indices at which the shared attention block is applied
    shared_attn_every: int = 0      # every k-th layer gets the shared attn block
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # rnn (paper's GRU)
    rnn_hidden: int = 0
    rnn_layers: int = 0
    # dtype policy
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # numerics
    embed_scale: bool = False       # gemma multiplies embeddings by sqrt(d)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode (O(1) or windowed per-token state)."""
        if self.family in ("ssm", "hybrid", "rnn"):
            return True
        return self.attention.kind in ("swa", "local_global")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS and the
        HFL communication-cost model)."""
        a = self.attention
        d = self.d_model
        n = 0
        # embeddings (+ untied head)
        n += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "rnn":
            h = self.rnn_hidden
            n = 0
            inp = 1
            for i in range(self.rnn_layers):
                din = inp if i == 0 else h
                n += 3 * (din * h + h * h + 2 * h)
            n += h * 1 + 1  # regression head
            return n
        # attention params
        if a.kind == "mla" and a.mla is not None:
            m = a.mla
            qdim = a.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            attn_p = d * qdim                                    # q proj
            attn_p += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down + rope
            attn_p += m.kv_lora_rank * a.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn_p += a.num_heads * m.v_head_dim * d             # o proj
        elif a.kind == "none":
            attn_p = 0
        else:
            attn_p = d * a.num_heads * a.head_dim                # q
            attn_p += 2 * d * a.num_kv_heads * a.head_dim        # k,v
            attn_p += a.num_heads * a.head_dim * d               # o
        # ffn params
        def ffn(dff: int) -> int:
            mult = 3 if self.act == "silu" else 2
            return mult * d * dff
        if self.family == "ssm" and self.xlstm is not None:
            x = self.xlstm
            per_layer = int(d * d * x.proj_factor_mlstm * 2.5) + int(d * d * x.proj_factor_slstm * 2)
            per_layer //= 2  # mix of mLSTM/sLSTM; coarse
            n += self.num_layers * per_layer
        elif self.family in ("ssm", "hybrid") and self.ssm is not None:
            s = self.ssm
            d_in = d * s.expand
            mamba_p = d * d_in * 2            # in proj (x, z)
            mamba_p += d_in * (2 * s.ngroups * s.state_dim)  # B, C proj
            mamba_p += d_in                    # dt
            mamba_p += s.conv_width * (d_in + 2 * s.ngroups * s.state_dim)
            mamba_p += d_in * d                # out proj
            n += self.num_layers * mamba_p
            if self.shared_attn_every:
                n += attn_p + ffn(self.d_ff)   # one shared block
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn_p + ffn(self.d_ff)
            layers = self.num_layers + self.encoder_layers
            n += layers * per_layer
            if self.is_encoder_decoder:
                n += self.num_layers * attn_p  # cross attention
        elif self.family == "moe" and self.moe is not None:
            mo = self.moe
            moe_layers = self.num_layers - mo.first_dense_layers
            shared = mo.d_shared if mo.d_shared else mo.num_shared * mo.d_expert
            per_moe = attn_p + mo.num_experts * ffn(mo.d_expert) // 1
            per_moe += ffn(shared) if shared else 0
            per_moe += d * mo.num_experts      # router
            dense_ff = mo.dense_d_ff or self.d_ff
            n += mo.first_dense_layers * (attn_p + ffn(dense_ff))
            n += moe_layers * per_moe
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        mo = self.moe
        d = self.d_model
        full = self.param_count()
        def ffn(dff: int) -> int:
            mult = 3 if self.act == "silu" else 2
            return mult * d * dff
        inactive = (mo.num_experts - mo.top_k) * ffn(mo.d_expert) * (
            self.num_layers - mo.first_dense_layers)
        return full - inactive


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Run config (how the arch runs on the mesh)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RunConfig:
    microbatches: int = 1           # grad-accumulation steps inside train_step
    remat: str = "layer"            # none | layer | dots
    scan_layers: bool = True
    opt_state_dtype: str = "float32"
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    # HFL schedule
    local_rounds_per_global: int = 2   # paper's l
    local_epochs: int = 5
    # serving
    max_cache_len: int = 32_768
    cache_dtype: str = ""            # "" -> model dtype; e.g. float8_e4m3fn
    # sharding overrides: logical axis -> mesh axis name tuple
    sharding_overrides: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    run: RunConfig = field(default_factory=RunConfig)

    @property
    def name(self) -> str:
        return self.model.name

    def reduced(self) -> "ArchConfig":
        """Reduced variant of the same family for CPU smoke tests:
        2 layers, d_model<=512, <=4 experts."""
        m = self.model
        a = m.attention
        heads = max(2, min(4, a.num_heads))
        kvh = 1 if a.num_kv_heads == 1 else max(1, min(2, a.num_kv_heads))
        hd = 32
        small_attn = dataclasses.replace(
            a, num_heads=heads, num_kv_heads=kvh, head_dim=hd,
            window=min(a.window, 64) if a.window else 0,
            mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                          qk_rope_head_dim=16, v_head_dim=16) if a.mla else None,
        )
        kw = dict(
            num_layers=2, d_model=min(m.d_model, 256),
            d_ff=min(m.d_ff, 512) if m.d_ff else 0,
            vocab_size=min(m.vocab_size, 1024),
            attention=small_attn,
            encoder_layers=2 if m.is_encoder_decoder else 0,
        )
        if m.moe is not None:
            kw["moe"] = dataclasses.replace(
                m.moe, num_experts=4, num_shared=min(m.moe.num_shared, 1),
                top_k=2, d_expert=64, d_shared=64 if m.moe.d_shared else 0,
                dense_d_ff=128 if m.moe.dense_d_ff else 0)
        if m.ssm is not None:
            kw["ssm"] = dataclasses.replace(m.ssm, state_dim=16, head_dim=16, chunk=32)
        if m.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(m.xlstm, num_heads=2, slstm_layers=(1,))
        if m.shared_attn_every:
            kw["shared_attn_every"] = 2
        if m.frontend.kind != "none":
            kw["frontend"] = dataclasses.replace(
                m.frontend, num_positions=16, embed_dim=min(m.d_model, 256))
        if m.family == "rnn":
            kw.update(rnn_hidden=32, rnn_layers=2, num_layers=0, d_ff=0)
        model = dataclasses.replace(m, **kw)
        run = dataclasses.replace(self.run, microbatches=1)
        return ArchConfig(model=model, run=run)
