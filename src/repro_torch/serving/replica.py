"""Tiered replica pool — the paper's "replication for free" (§III): HFL
leaves a model replica at every tier (device, edge aggregator, cloud), so
serving can dispatch to whichever tier routing selects.  Counterpart of
``repro/serving/replica.py``.

One :class:`ServeEngine` or :class:`PagedServeEngine` per LM tier, with
per-tier batch sizes (= concurrency caps) mirroring the hardware
asymmetry: a device serves one sequence at a time, an edge host a
handful, the cloud a large batch.  The paper's own GRU (family ``rnn``)
has no token decode loop — each request is one forward over a history
window — so it is served per request batch; the forward's recurrence
runs in the ``gru_seq`` CUDA kernel on the card.  The LM engines' prefill
and decode attention run in the ``flash_attention``, ``decode_attention``
and ``paged_decode_attention`` kernels (MLA models: ``flash_attention``
and ``paged_mla_decode_attention``), and every MoE layer routes its
tokens through ``topk_router``.  The recurrent families are served by
dense engines only, their prompts fed token by token through the decode
step: the zamba2 hybrid's serving path runs ``decode_attention`` in the
shared block and never the ``mamba_chunk_scan`` of its full-sequence
forward; xlstm-125m, the default LM (:func:`lm_tiers`), runs PyTorch ops
alone (the JAX package has no kernel for it); whisper's decoder runs
``decode_attention`` over its self ring and its cross rows.

``measure()`` produces the per-tier timings that
``LatencyModel.from_measurements`` turns into a calibrated latency model
for the routing simulator (the bridge closing the serving <-> simulation
loop).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import make_model
from repro_torch.params import from_numpy_tree
from repro_torch.serving.engine import (EngineMeasurement, PagedServeEngine,
                                       ServeEngine)

TIERS = ("device", "edge", "cloud")

#: replica health states
HEALTHY, DEGRADED, DOWN = "healthy", "degraded", "down"
HEALTH_STATES = (HEALTHY, DEGRADED, DOWN)

#: failover order: where a tier's traffic goes when its replica is down
#: (up the hierarchy — the cloud is the tier of last resort)
FAILOVER_ORDER: Dict[str, Tuple[str, ...]] = {
    "device": ("edge", "cloud"),
    "edge": ("cloud",),
    "cloud": (),
}


@dataclass(frozen=True)
class TierSpec:
    tier: str                        # device | edge | cloud
    arch: str = "gru-traffic"        # config-registry name
    batch_size: int = 1              # engine rows = concurrency cap
    max_len: int = 256
    reduced: bool = True             # CPU-sized config variant
    replicas: int = 1                # replicas behind this tier
    # paged cache (transformer families only): batch_size rows share a
    # PagePool instead of each reserving a dense max_len cache
    paged: bool = False
    page_size: int = 16
    num_pages: Optional[int] = None  # default: batch_size * ceil(max_len/ps)


# the paper serves ONE model from every tier; the tiers differ in
# concurrency, not in weights.  Like the JAX package's, these tiers serve
# the reduced (hidden 32) GRU; pass reduced=False for the paper's width.
DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("device", batch_size=1),
    TierSpec("edge", batch_size=4),
    TierSpec("cloud", batch_size=16),
)


def lm_tiers(arch: str = "xlstm-125m", max_len: int = 256,
             ) -> Tuple[TierSpec, ...]:
    """Tier layout for a token-decoding LM: dense engines with 1, 4 and 8
    slots, for any LM family; the default, as in the JAX package, is
    xlstm-125m, whose prompts are fed token by token through the decode
    step."""
    return (TierSpec("device", arch=arch, batch_size=1, max_len=max_len),
            TierSpec("edge", arch=arch, batch_size=4, max_len=max_len),
            TierSpec("cloud", arch=arch, batch_size=8, max_len=max_len))


def paged_lm_tiers(arch: str = "stablelm-1.6b", max_len: int = 256,
                   page_size: int = 16) -> Tuple[TierSpec, ...]:
    """Paged tier layout: each tier keeps the page budget a dense tier of
    :func:`lm_tiers` would hold but admits by actual token footprint, so
    it runs 4, 16 and 32 rows.  Transformer families only: building a
    tier of a recurrent or hybrid arch (zamba2) raises, as in JAX."""
    pages_dense = -(-max_len // page_size)
    return tuple(TierSpec(t, arch=arch, batch_size=b, max_len=max_len,
                          paged=True, page_size=page_size,
                          num_pages=n * pages_dense)
                 for t, b, n in (("device", 4, 1), ("edge", 16, 4),
                                 ("cloud", 32, 8)))


class _RnnReplica:
    """Per-request serving path for the paper's GRU: one forward per
    request batch (the request's unit of work, gru.decode_step)."""

    def __init__(self, cfg, params, device: torch.device):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.api = make_model(cfg)

    @torch.no_grad()
    def serve(self, windows) -> torch.Tensor:
        w = torch.as_tensor(windows, dtype=torch.float32, device=self.device)
        return self.api.forward(self.params, {"windows": w})[0]

    def measure(self, batch_size: int, history: int = 12,
                repeats: int = 8, seed: int = 0) -> EngineMeasurement:
        """Mean time of one request batch, after one warm-up call (which
        builds the kernels on first use).  On the card it is timed with
        CUDA events around ``repeats`` calls; on the CPU, which only a
        caller that asked for it gets, with the host clock."""
        rng = np.random.default_rng(seed)
        w = torch.as_tensor(rng.normal(size=(batch_size, history, 1)),
                            dtype=torch.float32, device=self.device)
        self.serve(w)                                   # warm up
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.device)
            start.record()
            for _ in range(repeats):
                self.serve(w)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / repeats
        else:
            t0 = time.perf_counter()
            for _ in range(repeats):
                self.serve(w)
            ms = (time.perf_counter() - t0) * 1e3 / repeats
        return EngineMeasurement(prefill_ms=ms, decode_ms_per_token=0.0,
                                 batch_size=batch_size, prompt_len=history,
                                 decode_steps=0)


class ReplicaPool:
    """One serving replica per tier, built lazily (deployments stay cheap
    until traffic actually arrives at a tier).  Runs on the GPU unless
    the caller passes ``device="cpu"``."""

    def __init__(self, specs: Sequence[TierSpec] = DEFAULT_TIERS,
                 seed: int = 0,
                 shared_params: Optional[Any] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.specs: Dict[str, TierSpec] = {}
        for s in specs:
            if s.tier not in TIERS:
                raise ValueError(f"unknown tier {s.tier!r}")
            self.specs[s.tier] = s
        self.seed = seed
        self._shared_params = shared_params
        self._replicas: Dict[str, Any] = {}
        self._health: Dict[str, str] = {t: HEALTHY for t in self.specs}
        self.failovers = 0               # dispatches re-routed off a down tier

    @property
    def tiers(self) -> Tuple[str, ...]:
        return tuple(self.specs)

    def concurrency(self, tier: str) -> int:
        s = self.specs[tier]
        return s.batch_size * s.replicas

    def _build(self, tier: str):
        spec = self.specs[tier]
        cfg = get_config(spec.arch)
        if spec.reduced:
            cfg = cfg.reduced()
        api = make_model(cfg)
        params = self._shared_params
        if params is None:
            # all tiers replicate the SAME weights (same seed)
            gen = torch.Generator().manual_seed(self.seed)
            params = api.init_params(gen, self.device)
        params = from_numpy_tree(params, self.device)
        if cfg.model.family == "rnn":
            return _RnnReplica(cfg, params, self.device)
        if spec.paged:
            return PagedServeEngine(cfg, params, max_seqs=spec.batch_size,
                                    page_size=spec.page_size,
                                    num_pages=spec.num_pages,
                                    max_len=spec.max_len, device=self.device)
        return ServeEngine(cfg, params, batch_size=spec.batch_size,
                           max_len=spec.max_len, device=self.device)

    def replica(self, tier: str):
        if tier not in self._replicas:
            self._replicas[tier] = self._build(tier)
        return self._replicas[tier]

    def engine(self, tier: str):
        rep = self.replica(tier)
        if not isinstance(rep, (ServeEngine, PagedServeEngine)):
            raise TypeError(f"tier {tier!r} serves a per-request model")
        return rep

    # -- health / failover --------------------------------------------------

    def health(self, tier: str) -> str:
        return self._health[tier]

    def set_health(self, tier: str, state: str) -> None:
        if tier not in self.specs:
            raise ValueError(f"unknown tier {tier!r}")
        if state not in HEALTH_STATES:
            raise ValueError(f"unknown health state {state!r}; "
                             f"pick from {HEALTH_STATES}")
        self._health[tier] = state

    def mark_down(self, tier: str) -> List[int]:
        """Crash a tier: drain its engine (in-flight sequences lose their
        cache; paged pools are checked leak-free by ``drain``) and stop
        routing to it until :meth:`mark_up`.  Returns the drained slot
        ids so callers can requeue (none for the per-request GRU)."""
        self.set_health(tier, DOWN)
        rep = self._replicas.get(tier)
        if rep is not None and hasattr(rep, "drain"):
            return rep.drain()
        return []

    def mark_up(self, tier: str) -> None:
        self.set_health(tier, HEALTHY)

    def resolve_tier(self, tier: str) -> str:
        """Failover routing: the requested tier if it can serve (healthy
        or degraded), else the first not-down tier up its
        :data:`FAILOVER_ORDER` chain.  Raises when the whole chain is
        down — there is no silent drop."""
        if self._health.get(tier, DOWN) != DOWN:
            return tier
        for alt in FAILOVER_ORDER.get(tier, ()):
            if alt in self.specs and self._health[alt] != DOWN:
                self.failovers += 1
                return alt
        raise RuntimeError(
            f"tier {tier!r} is down and so is its whole failover chain "
            f"{FAILOVER_ORDER.get(tier, ())}")

    # -- dispatch -----------------------------------------------------------

    def dispatch(self, tier: str, batch, steps: int = 8) -> torch.Tensor:
        """Serve one batch on ``tier`` (or its failover target when the
        tier is down — see :meth:`resolve_tier`): token generation for LM
        tiers ((B,S) int prompts -> (B,steps) tokens), a single forward
        for rnn tiers ((B,T,1) windows -> (B,1) predictions), on the
        pool's device."""
        rep = self.replica(self.resolve_tier(tier))
        if isinstance(rep, _RnnReplica):
            return rep.serve(batch)
        return rep.generate(batch, steps=steps)

    # -- calibration --------------------------------------------------------

    def measure(self, prompt_len: int = 64, decode_steps: int = 16,
                occupancy_levels: Optional[Sequence[int]] = None,
                ) -> Dict[str, EngineMeasurement]:
        """Per-tier timings — feed the result to
        ``LatencyModel.from_measurements``.  ``occupancy_levels`` sweeps
        LM tiers' decode time at those admitted-sequence counts (levels
        a tier cannot reach are dropped)."""
        out = {}
        for tier, spec in self.specs.items():
            rep = self.replica(tier)
            if isinstance(rep, _RnnReplica):
                out[tier] = rep.measure(spec.batch_size)
            else:
                out[tier] = rep.measure(prompt_len=prompt_len,
                                        decode_steps=decode_steps,
                                        occupancy_levels=occupancy_levels)
        return out
