"""Serving engines: one-shot bucketed prefill and continuous-batching
decode over the port's model API.  Counterpart of
``repro/serving/engine.py``, with the same API.

:class:`ServeEngine` owns ``batch_size`` slots, each with a private dense
``max_len`` ring (or MLA latent) cache: admission prefills into a slot,
and one batched decode step advances every slot under its own position.
JAX vmaps a batch-1 ``decode_step`` over the slots; the port writes that
as one call with per-slot ``pos (B,)`` and ring ``index (B,)``, since a
kernel launched through ctypes cannot be vmapped.  For an MoE model the
vmap gives every slot's token its own expert capacity, so the port's
step asks for per-row capacity (``moe_per_row``): with more slots than
an expert's pooled capacity, rows would otherwise compete for it and
tokens would change.

:class:`PagedServeEngine` replaces the per-slot reservation with a
shared :class:`~repro_torch.serving.page_pool.PagePool`: sequences hold
``ceil(tokens / page_size)`` pages, admission is gated on pages, decode
extends page by page and eviction reclaims them.  Its decode step is one
program over all rows in JAX too, so there an MoE layer's capacity is
pooled over the rows, free rows included.

A family without a one-shot ``prefill`` (the zamba2 hybrid and xLSTM,
whose states are recurrent, and whisper's encoder-decoder) is admitted
token by token through ``decode_step`` on the slot's batch-1 cache, as
the JAX engine's scan over decode steps does; only :class:`ServeEngine`
serves it (recurrent state is O(1) per sequence, so there is nothing to
page).

Caches are written in place (``models/attention.py``), so ``measure()``
clones them before it admits its probe sequences and puts the clones
back after: in-flight sequences resume where they were.  Each family
keeps the batch on its own axis: 1 in a stacked cache (the
transformer's ``"layers"``, the hybrid's ``"mamba"``, whisper's
``"self"`` ring and bare ``cross_k`` / ``cross_v``), 0 in a per-layer one
(gemma3's per-layer rings, the hybrid's ``"shared"`` rings, xLSTM's
states).  An admission resets its slot to a fresh batch-1 cache made
once at construction, and finds each leaf's batch axis by comparing the
two.  Both engines run on the GPU unless the caller passes
``device="cpu"``.

With a :class:`~repro_torch.telemetry.Telemetry` attached, the engines
record what the JAX engines record, at the same calls: ``serve.admit``
and ``serve.measure`` spans, and the ``serve.admissions``,
``serve.evictions`` and ``serve.decode_steps`` counters; the paged
engine's pool publishes its ``page_pool.*`` gauges.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import make_model
from repro_torch.params import (flatten_with_path, from_numpy_tree,
                                tree_map, tree_map_with_path)
from repro_torch.serving.page_pool import PagePool
from repro_torch.telemetry import Telemetry, maybe as _maybe_tel


def bucket_len(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (>= lo): prompts are right-padded to
    buckets, as in the JAX engine, so prefill shapes stay few."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class EngineMeasurement:
    """Wall-clock engine timings — the raw material for
    ``LatencyModel.from_measurements`` (routing/latency.py)."""
    prefill_ms: float              # one admission of a prompt_len prompt
    decode_ms_per_token: float     # one continuous-batching step
    batch_size: int                # max concurrent sequences
    prompt_len: int
    decode_steps: int
    # occupancy sweep: ((concurrency, decode_ms_per_step), ...) measured
    # at increasing admitted-sequence counts
    occupancy_ms: Tuple[Tuple[int, float], ...] = ()


def _clone(cache):
    return tree_map(torch.clone, cache)


def _restore(cache, saved) -> None:
    """Copy the tensors of ``saved`` back into ``cache`` in place."""
    for (_, dst), (_, src) in zip(flatten_with_path(cache),
                                  flatten_with_path(saved)):
        dst.copy_(src)


def _batch_axis(full: torch.Tensor, one: torch.Tensor) -> Optional[int]:
    """The axis on which a leaf of the engine's cache and the same leaf of
    a batch-1 cache differ: the batch axis, wherever the family keeps it
    (0 in a per-layer cache, 1 in a stacked one); None when the engine has
    one slot, whose view is then the whole leaf."""
    for ax, (a, b) in enumerate(zip(full.shape, one.shape)):
        if a != b:
            return ax
    return None


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token of each row (first maximum on ties, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1)


def _prompt_row(prompt) -> np.ndarray:
    return np.asarray(torch.as_tensor(prompt).cpu(), np.int64).reshape(-1)


class _EngineBase:
    """Slot bookkeeping and the calibration sweep the engines share."""

    def _setup(self, cfg: ArchConfig, params: Any, rows: int,
               max_len: Optional[int], device: DeviceLike) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = make_model(cfg)
        self.params = from_numpy_tree(params, self.device)
        self.batch_size = rows               # scheduler-facing name
        self.max_len = max_len or cfg.run.max_cache_len
        self.free_slots: Deque[int] = deque(range(rows))
        self._free_set: Set[int] = set(range(rows))

    def acquire_slot(self) -> Optional[int]:
        if not self.free_slots:
            return None
        slot = self.free_slots.popleft()
        self._free_set.discard(slot)
        return slot

    def _claim(self, slot: int) -> None:
        if slot in self._free_set:
            self._free_set.discard(slot)
            self.free_slots.remove(slot)

    def _release(self, slot: int) -> None:
        """Free an evicted slot (every eviction ends here)."""
        if slot in self._free_set:
            raise ValueError(f"slot {slot} is already free (double evict)")
        self.free_slots.append(slot)
        self._free_set.add(slot)
        self._count("serve.evictions")

    def _count(self, name: str) -> None:
        if self._tel is not None:
            self._tel.metrics.counter(name).inc()

    def _span(self, name: str, **args):
        if self._tel is None:
            return contextlib.nullcontext()
        return self._tel.tracer.wall(name, cat="serving", **args)

    def admit(self, prompt, slot: int,
              reserve_tokens: Optional[int] = None) -> int:
        """Prefill ``prompt`` (S,) into ``slot``; return the first greedy
        token (see the engine's ``_admit``)."""
        with self._span("serve.admit", slot=int(slot)):
            first = self._admit(prompt, slot, reserve_tokens)
        self._count("serve.admissions")
        return first

    def _padded(self, prompt) -> Tuple[torch.Tensor, int]:
        row = _prompt_row(prompt)
        S = row.shape[0]
        if S > self.max_len:
            raise ValueError(f"prompt ({S}) exceeds max_len {self.max_len}")
        padded = np.zeros((1, bucket_len(S)), np.int64)
        padded[0, :S] = row
        return torch.as_tensor(padded, device=self.device), S

    @property
    def active_slots(self) -> int:
        return self.batch_size - len(self.free_slots)

    def _generate(self, prompt_tokens, steps: int, reserve) -> torch.Tensor:
        """Greedy generation through prefill and continuous-batching
        decode; requires an idle engine (``decode`` advances every
        slot).  Returns (B, steps) int32 tokens on the engine's device."""
        prompts = np.asarray(torch.as_tensor(prompt_tokens).cpu())
        B = prompts.shape[0]
        if B > self.batch_size:
            raise ValueError(f"batch {B} exceeds {self.batch_size} rows")
        if self.active_slots:
            raise RuntimeError(
                "engine has active sequences; drive mixed workloads "
                "through a scheduler")
        slots = [self.acquire_slot() for _ in range(B)]
        first = [self.admit(prompts[b], slot=s, **reserve)
                 for b, s in enumerate(slots)]
        out = [np.asarray(first, np.int32)]
        for _ in range(steps - 1):
            toks = self.decode()
            out.append(toks[np.asarray(slots)])
        for s in slots:
            self.evict(s)
        return torch.as_tensor(np.stack(out, axis=1), device=self.device)

    @torch.no_grad()
    def measure(self, prompt_len: int = 64, decode_steps: int = 16,
                seed: int = 0,
                occupancy_levels: Optional[Sequence[int]] = None,
                ) -> EngineMeasurement:
        """Wall-clock prefill and continuous-batching step times, after a
        warm-up admission and step.  With ``occupancy_levels`` also sweeps
        the decode step time at increasing admitted-sequence counts
        (levels above the budget are skipped).  Host clock around calls
        that end in a synchronise (``admit`` and ``decode`` return host
        values).  Safe mid-serving: the engine's state is saved before
        and restored after, caches included."""
        with self._span("serve.measure", prompt_len=int(prompt_len),
                        decode_steps=int(decode_steps)):
            return self._measure(prompt_len, decode_steps, seed,
                                 occupancy_levels)

    def _measure(self, prompt_len: int, decode_steps: int, seed: int,
                 occupancy_levels: Optional[Sequence[int]]
                 ) -> EngineMeasurement:
        state = self._save()
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, max(self.cfg.model.vocab_size, 2),
                              (prompt_len,))
        try:
            prefill_ms, decode_ms = self._measure_steps(prompt, decode_steps)
            sweep = self._occupancy_sweep(occupancy_levels, prompt,
                                          decode_steps)
        finally:
            self._restore_state(state)
        return EngineMeasurement(prefill_ms=prefill_ms,
                                 decode_ms_per_token=decode_ms,
                                 batch_size=self.batch_size,
                                 prompt_len=prompt_len,
                                 decode_steps=decode_steps,
                                 occupancy_ms=sweep)

    def _time_decode(self, steps: int) -> float:
        t0 = time.perf_counter()
        for _ in range(steps):
            self.decode()
        return (time.perf_counter() - t0) * 1e3 / max(steps, 1)

    def _occupancy_sweep(self, levels, prompt, decode_steps: int
                         ) -> Tuple[Tuple[int, float], ...]:
        """Admit up to each requested concurrency level and time decode
        steps there; only ``can_admit`` differs between the engines
        (slots vs pages)."""
        if not levels:
            return ()
        out = []
        for lvl in sorted(set(int(v) for v in levels)):
            while self.active_slots < lvl \
                    and self.can_admit(len(prompt), decode_steps):
                s = self.acquire_slot()
                if s is None:
                    break
                self.admit(prompt, slot=s, reserve_tokens=decode_steps)
            if self.active_slots < lvl:
                break                       # slot/page budget exhausted
            out.append((lvl, self._time_decode(decode_steps)))
        return tuple(out)


class ServeEngine(_EngineBase):
    def __init__(self, cfg: ArchConfig, params: Any, batch_size: int,
                 max_len: Optional[int] = None, device: DeviceLike = None,
                 telemetry: Optional[Telemetry] = None):
        self._tel = _maybe_tel(telemetry)
        self._setup(cfg, params, batch_size, max_len, device)
        self.cache = self.api.init_cache(batch_size, self.max_len,
                                         device=self.device)
        if self.cache is None:
            raise ValueError(
                f"{cfg.name}: family {cfg.model.family!r} has no decode "
                "cache — serve it per-request via ReplicaPool instead")
        # the JAX engine's slot template: a fresh batch-1 cache, which
        # every admission copies into its slot (a fresh state is not all
        # zeros: empty ring slots hold position -1, an xLSTM stabiliser
        # -1e30), and each leaf's batch axis in the engine's cache
        fresh = flatten_with_path(self.api.init_cache(1, self.max_len,
                                                      device=self.device))
        self._fresh = dict(fresh)
        self._batch_axes = {
            path: _batch_axis(full, one) for (path, full), (_, one)
            in zip(flatten_with_path(self.cache), fresh)}
        self.pos = torch.zeros((batch_size,), dtype=torch.int64,
                               device=self.device)
        self.next_tok = torch.zeros((batch_size, 1), dtype=torch.int64,
                                    device=self.device)

    def _slot_cache(self, slot: int):
        """Slot ``slot`` of every leaf of the cache, as views (writes go
        through), reset to the fresh batch-1 template: the JAX engine
        prefills a copy of its template and inserts it into the slot."""
        def view(path, x):
            ax = self._batch_axes[path]
            v = x if ax is None else x.narrow(ax, slot, 1)
            return v.copy_(self._fresh[path])
        return tree_map_with_path(view, self.cache)

    # -- slot management ----------------------------------------------------

    def can_admit(self, prompt_len: int, max_new_tokens: int = 0) -> bool:
        """Dense admission is slot-gated only: every slot already owns a
        worst-case ``max_len`` cache."""
        return bool(self.free_slots)

    @torch.no_grad()
    def _admit(self, prompt, slot: int,
               reserve_tokens: Optional[int] = None) -> int:
        """Prefill ``prompt`` (S,) into ``slot``; return the first greedy
        token.  ``reserve_tokens`` is accepted for signature parity with
        :class:`PagedServeEngine` (a dense slot always reserves
        ``max_len``).

        A family without ``prefill`` runs the prompt token by token
        through ``decode_step`` on the slot's batch-1 cache and takes the
        greedy token of position S-1.  The JAX engine scans the whole
        padded bucket and keeps the cache of step t only where ``t <
        length``, so its padded steps leave the cache as it was; the
        port stops after the S-th token, with the same cache and token."""
        padded, S = self._padded(prompt)
        cache = self._slot_cache(slot)
        if self.api.prefill is None:
            if S == 0:
                raise ValueError("a recurrent prefill needs a prompt of at "
                                 "least one token")
            for t in range(S):
                logits, _ = self.api.decode_step(
                    self.params, padded[:, t:t + 1],
                    torch.tensor(t, device=self.device), cache)
            first = _argmax(logits[:, -1])
        else:
            logits, _ = self.api.prefill(self.params, padded, cache,
                                         length=S)
            first = _argmax(logits[:, S - 1])
        self.pos[slot] = S
        self.next_tok[slot, 0] = first[0]
        self._claim(slot)
        return int(first[0])

    def evict(self, slot: int) -> None:
        """Release a slot; its stale cache is emptied by the next
        admission.  Double eviction raises."""
        self._release(slot)

    def drain(self) -> List[int]:
        """Crash recovery: evict every live slot at once.  Returns the
        drained slot ids so callers can requeue their requests."""
        drained = [s for s in range(self.batch_size)
                   if s not in self._free_set]
        for slot in drained:
            self.evict(slot)
        return drained

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def decode(self) -> np.ndarray:
        """One continuous-batching step: every slot advances one token
        under its own position (free slots too, as in JAX; their entries
        are meaningless), each slot's MoE token with its own capacity.
        Returns (batch_size,) token ids."""
        logits, _ = self.api.decode_step(self.params, self.next_tok,
                                         self.pos, self.cache,
                                         moe_per_row=True)
        toks = _argmax(logits[:, -1])
        self.pos += 1
        self.next_tok = toks[:, None]
        self._count("serve.decode_steps")
        return toks.cpu().numpy().astype(np.int32)

    def generate(self, prompt_tokens, steps: int) -> torch.Tensor:
        """(B,S) prompts -> (B, steps) greedy tokens."""
        return self._generate(prompt_tokens, steps, {})

    @torch.no_grad()
    def generate_sequential(self, prompt_tokens, steps: int) -> torch.Tensor:
        """The baseline path: feeds the prompt token by token (S decode
        steps) into a fresh cache, then samples ``steps`` continuations."""
        prompts = torch.as_tensor(prompt_tokens, device=self.device).long()
        B, S = prompts.shape
        cache = self.api.init_cache(B, self.max_len, device=self.device)
        tok = None
        for s in range(S):
            logits, cache = self.api.decode_step(
                self.params, prompts[:, s:s + 1], torch.tensor(s), cache)
            tok = _argmax(logits[:, -1])
        out = []
        for t in range(steps):
            out.append(tok)
            logits, cache = self.api.decode_step(
                self.params, tok[:, None], torch.tensor(S + t), cache)
            tok = _argmax(logits[:, -1])
        return torch.stack(out, dim=1).int()

    # -- calibration --------------------------------------------------------

    def _save(self):
        return (_clone(self.cache), self.pos.clone(), self.next_tok.clone(),
                list(self.free_slots))

    def _restore_state(self, state) -> None:
        _restore(self.cache, state[0])
        self.pos, self.next_tok = state[1], state[2]
        self.free_slots = deque(state[3])
        self._free_set = set(state[3])

    def _measure_steps(self, prompt, decode_steps: int):
        slot = self.free_slots[0] if self.free_slots else 0
        self.admit(prompt, slot=slot)        # warm-up
        self.decode()
        t0 = time.perf_counter()
        self.admit(prompt, slot=slot)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        return prefill_ms, self._time_decode(decode_steps)


class PagedServeEngine(_EngineBase):
    """Continuous batching over a shared paged cache.

    Rows (``max_seqs``) are batch positions of the one batched decode
    step; the cache behind them is a page pool shared by every live
    sequence.  Admission allocates ``prompt_len + reserve_tokens`` worth
    of pages, decode extends page by page, eviction returns pages.  Free
    rows point their whole block table at the scratch page (id
    ``num_pages``; the page tensors hold one extra page for it).  Greedy
    outputs are token for token those of :class:`ServeEngine`."""

    def __init__(self, cfg: ArchConfig, params: Any, max_seqs: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_len: Optional[int] = None, reserve_tokens: int = 16,
                 device: DeviceLike = None,
                 telemetry: Optional[Telemetry] = None):
        self._tel = _maybe_tel(telemetry)
        self._setup(cfg, params, max_seqs, max_len, device)
        if self.api.paged_prefill is None:
            raise ValueError(
                f"{cfg.name}: family {cfg.model.family!r} has no paged "
                "cache path (recurrent state is O(1) per sequence — use "
                "ServeEngine)")
        self.max_seqs = max_seqs
        self.page_size = int(page_size)
        self.pages_per_seq = -(-self.max_len // self.page_size)
        # default budget: what a dense engine of the same (max_seqs,
        # max_len) reserves
        self.num_pages = int(num_pages or max_seqs * self.pages_per_seq)
        self.reserve_tokens = int(reserve_tokens)
        self.pool = PagePool(self.num_pages, self.page_size,
                             telemetry=telemetry)
        self.cache = self.api.init_paged_cache(self.num_pages, self.page_size,
                                               device=self.device)
        self.scratch_page = self.num_pages
        self._block_tables = np.full((max_seqs, self.pages_per_seq),
                                     self.scratch_page, np.int32)
        self._pos = np.zeros((max_seqs,), np.int32)
        self._next_tok = np.zeros((max_seqs, 1), np.int32)

    # -- admission ----------------------------------------------------------

    def can_admit(self, prompt_len: int, max_new_tokens: int = 0) -> bool:
        """True when a row is free and the pool can hold the prompt plus
        the decode reservation."""
        need = prompt_len + max(int(max_new_tokens), self.reserve_tokens)
        return bool(self.free_slots) and self.pool.can_allocate(need)

    @torch.no_grad()
    def _admit(self, prompt, slot: int,
               reserve_tokens: Optional[int] = None) -> int:
        """Allocate pages for ``prompt`` plus ``reserve_tokens`` of decode
        headroom (engine default when None), prefill through the block
        table, return the first greedy token.  Raises ``PagesExhausted``
        when the pool cannot hold the sequence; a failed prefill hands
        its pages back."""
        padded, S = self._padded(prompt)
        reserve = self.reserve_tokens if reserve_tokens is None \
            else int(reserve_tokens)
        table = self.pool.allocate(slot, min(S + max(reserve, 1),
                                             self.max_len))
        try:
            row = np.full((self.pages_per_seq,), self.scratch_page, np.int32)
            row[:len(table)] = table
            self._block_tables[slot] = row
            logits, _ = self.api.paged_prefill(
                self.params, padded, self.cache,
                torch.as_tensor(row[None], device=self.device), length=S)
            first = int(_argmax(logits[:, S - 1])[0])
        except BaseException:
            self.pool.release(slot)
            self._block_tables[slot] = self.scratch_page
            raise
        self._pos[slot] = S
        self._next_tok[slot, 0] = first
        self._claim(slot)
        return first

    def evict(self, slot: int) -> None:
        """Return the row's pages to the pool.  Double eviction raises; a
        row whose admission failed holds no pages and is just freed."""
        if slot in self._free_set:
            raise ValueError(f"slot {slot} is already free (double evict)")
        if slot in self.pool.sequences:
            self.pool.release(slot)
        self._block_tables[slot] = self.scratch_page
        self._pos[slot] = 0
        self._next_tok[slot] = 0
        self._release(slot)

    def drain(self) -> List[int]:
        """Crash recovery: evict every live row and check that the pool
        comes back whole.  Returns the drained slot ids."""
        drained = [s for s in range(self.max_seqs)
                   if s not in self._free_set]
        for slot in drained:
            self.evict(slot)
        self.pool.check_invariants()
        if self.pool.free_pages != self.num_pages:
            raise RuntimeError(
                f"page leak after drain: {self.pool.free_pages} free of "
                f"{self.num_pages}")
        return drained

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def decode(self) -> np.ndarray:
        """One continuous-batching step of every live row through the
        shared paged cache, extending page allocations where a row's next
        token crosses its reservation (raises ``PagesExhausted`` if the
        pool is dry).  Returns (max_seqs,) token ids (free rows'
        entries are meaningless)."""
        live = [s for s in range(self.max_seqs) if s not in self._free_set]
        for slot in live:
            needed = int(self._pos[slot]) + 1
            if needed > self.pool.length(slot):
                self.pool.extend(slot, needed)
                table = self.pool.block_table(slot)
                self._block_tables[slot, :len(table)] = table
        dev = self.device
        logits, _ = self.api.paged_decode_step(
            self.params, torch.as_tensor(self._next_tok, device=dev),
            torch.as_tensor(self._pos, device=dev), self.cache,
            torch.as_tensor(self._block_tables, device=dev))
        toks = _argmax(logits[:, -1]).cpu().numpy().astype(np.int32)
        self._pos[live] += 1
        self._next_tok[live, 0] = toks[live]
        self._count("serve.decode_steps")
        return toks

    def generate(self, prompt_tokens, steps: int) -> torch.Tensor:
        """Greedy generation: same contract and tokens as
        :meth:`ServeEngine.generate`."""
        return self._generate(prompt_tokens, steps,
                              {"reserve_tokens": steps})

    # -- calibration --------------------------------------------------------

    def _save(self):
        return (_clone(self.cache), self._pos.copy(), self._next_tok.copy(),
                self._block_tables.copy(), list(self.free_slots),
                self.pool.snapshot())

    def _restore_state(self, state) -> None:
        _restore(self.cache, state[0])
        self._pos, self._next_tok, self._block_tables = state[1:4]
        self.free_slots = deque(state[4])
        self._free_set = set(state[4])
        self.pool.restore(state[5])

    def _measure_steps(self, prompt, decode_steps: int):
        slot = self.acquire_slot()
        if slot is None:
            raise RuntimeError("measure() needs at least one free row")
        self.admit(prompt, slot=slot, reserve_tokens=decode_steps)  # warm-up
        self.decode()
        self.evict(slot)
        slot = self.acquire_slot()
        t0 = time.perf_counter()
        self.admit(prompt, slot=slot, reserve_tokens=decode_steps)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        return prefill_ms, self._time_decode(decode_steps)
