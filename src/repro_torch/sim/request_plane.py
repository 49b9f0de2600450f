"""Vectorized request plane of the macro-event co-simulation.

The simulation is split into a sparse **control plane** — the event
heap in ``repro.sim.events``: round/epoch/aggregation windows,
failures, moves, stragglers, tenant load, drift, reconfigurations,
telemetry; a few thousand events per run — and a dense **request
plane**: the inference traffic, processed here in vectorized NumPy
batches covering the windows *between* consecutive control events.
Within such a window every routing input is constant by construction
(busy flags, capacities, interference stretch, penalty windows all
change only at control events), so per-request work collapses to array
arithmetic:

  * admission through each edge's leaky bucket is replayed *exactly*
    (:func:`bucket_admissions`) with a vectorized Lindley recursion on
    the bucket's token deficit — saturated stretches fall back to an
    O(#admissions) alternation of bulk-admit / bulk-reject runs, each
    found by ``searchsorted``, so cost never scales with the offered
    (rejected) load;
  * service times are per-(tier, node) constants — interference
    stretch times the latency model's base — broadcast over the batch;
    occupancy-sensitive calibrated models go through
    :func:`occupancy_replay`, which collapses every stretch of
    occupancy below the replica's slot count to the same closed-form
    broadcast (completion times are arrival + a constant, so occupancy
    is two ``searchsorted`` counts) and replays only genuinely
    oversubscribed stretches — where service and occupancy couple —
    with the exact scalar arithmetic, so cost scales with
    time-at-oversubscription, not offered load;
  * network RTTs are drawn in bulk from the same generator stream the
    heap path would have consumed request-by-request, so a batched
    co-simulation run is *bit-identical* to the heap ("parity") run.

Results land in a :class:`ColumnarLog` — preallocated, geometrically
grown float/int arrays, not Python object lists — whose
:meth:`~ColumnarLog.recent_percentile` is incremental (binary-searched
window start), so telemetry ticks cost O(log n + window) instead of
rescanning the whole request history.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.routing.rules import EdgeState

#: rule-code table shared by the heap and batched engines; the columnar
#: log stores the int8 code, ``RequestLog`` materializes the string.
#: ``R4-failover`` is the fault-plane tier failover — a request whose
#: edge attempts were exhausted (down/dropped, retries timed out)
#: re-routed straight to the cloud replica.  The vectorized window path
#: never emits it (fault windows replay through the shared scalar
#: core), so it must stay *last*: ``_record_window``'s last-rule-gets-
#: the-remainder counting then assigns it an exact zero.
RULES = ("R1", "R1-flat", "R2-local", "R2-edge", "R2-cloud",
         "R3-overflow", "R4-failover")
RULE_CODE = {name: np.int8(k) for k, name in enumerate(RULES)}

TIER_DEVICE, TIER_EDGE, TIER_CLOUD = 0, 1, 2

# Lindley chunking: saturated buckets alternate short admit/reject runs,
# so scanning the whole remaining suffix per run would be quadratic —
# start small and grow geometrically while admissions stay clean.
_CHUNK0 = 64
_CHUNK_MAX = 1 << 20


class ColumnarLog:
    """Columnar request log: preallocated arrays grown geometrically.

    Both engines write here — the heap path appends one row per
    ``REQUEST_ARRIVAL`` event, the batched path extends whole windows —
    and rows are always in nondecreasing arrival-time order, which is
    what makes :meth:`recent_percentile` incremental."""

    __slots__ = ("n", "t", "device", "tier", "rule", "latency_ms",
                 "_win_cursor")

    def __init__(self, capacity: int = 1024):
        cap = max(int(capacity), 16)
        self.n = 0
        self.t = np.empty(cap, dtype=np.float64)
        self.device = np.empty(cap, dtype=np.int64)
        self.tier = np.empty(cap, dtype=np.int8)
        self.rule = np.empty(cap, dtype=np.int8)
        self.latency_ms = np.empty(cap, dtype=np.float64)
        self._win_cursor = 0

    def _grow(self, need: int) -> None:
        cap = self.t.size
        if self.n + need <= cap:
            return
        new = max(cap * 2, self.n + need)
        for name in ("t", "device", "tier", "rule", "latency_ms"):
            arr = getattr(self, name)
            out = np.empty(new, dtype=arr.dtype)
            out[: self.n] = arr[: self.n]
            setattr(self, name, out)

    def append(self, t: float, device: int, tier: int, rule: int,
               latency_ms: float) -> None:
        """One row (heap path)."""
        self._grow(1)
        k = self.n
        self.t[k] = t
        self.device[k] = device
        self.tier[k] = tier
        self.rule[k] = rule
        self.latency_ms[k] = latency_ms
        self.n = k + 1

    def extend(self, t: np.ndarray, device: np.ndarray, tier: np.ndarray,
               rule: np.ndarray, latency_ms: np.ndarray) -> None:
        """One window of rows (batched path)."""
        k = len(t)
        if k == 0:
            return
        self._grow(k)
        sl = slice(self.n, self.n + k)
        self.t[sl] = t
        self.device[sl] = device
        self.tier[sl] = tier
        self.rule[sl] = rule
        self.latency_ms[sl] = latency_ms
        self.n += k

    def recent_percentile(self, now: float, window_s: float, p: float,
                          min_requests: int = 1) -> Optional[float]:
        """p-th latency percentile over requests arriving in
        ``[now - window_s, now]``; None below ``min_requests``.

        Incremental: the window start index is found by binary search
        from a monotone cursor, so a telemetry tick costs
        O(log n + window size) — independent of total history.  The
        cursor resets itself if a caller moves ``now`` backward."""
        lo_t = now - window_s
        start = self._win_cursor
        if start > self.n or (start > 0 and self.t[start - 1] >= lo_t):
            start = 0                # window moved backward: full rescan
        lo = start + int(np.searchsorted(self.t[start:self.n], lo_t,
                                         side="left"))
        self._win_cursor = lo
        hi = lo + int(np.searchsorted(self.t[lo:self.n], now,
                                      side="right"))
        lat = self.latency_ms[lo:hi]
        if lat.size < min_requests:
            return None
        return float(np.percentile(lat, p))


def _bucket_replay(t: np.ndarray, admitted: np.ndarray, a: int, b: int,
                   rate: float, cap: float, tokens: float, last: float,
                   ) -> Tuple[float, float]:
    """Scalar replay of arrivals ``[a, b)`` with the verbatim
    ``EdgeState`` refill/admit arithmetic — the bit-exact fallback for
    chunks whose vectorized deficits graze the admission boundary."""
    for k in range(a, b):
        tokens = min(cap, tokens + rate * max(t[k] - last, 0.0))
        last = t[k]
        if tokens - 1.0 >= 0.0:
            tokens -= 1.0
            admitted[k] = True
    return tokens, last


def bucket_admissions(t: np.ndarray, st: EdgeState) -> np.ndarray:
    """Exact vectorized replay of :class:`EdgeState` leaky-bucket
    admission (priority class, rule R3) over a sorted arrival-time
    array.  Returns the heap path's admission mask and leaves
    ``st.tokens`` / ``st.last_t`` where the per-request heap path
    would, up to ULP-level rounding: compounded refills (one multiply
    over a skipped run, ``cumsum`` over a bulk chunk) associate floats
    differently than the heap's per-arrival arithmetic, so the carried
    token state can differ in the last bits.  A decision flips only if
    the true value sits within that ~1e-13 of the one-token admission
    threshold — measure-zero in practice (fuzzed against the scalar
    replay; the parity suite asserts bit-equality on fixed seeds) —
    and the bulk path additionally replays boundary-grazing chunks
    scalar.

    Three regimes, switched adaptively:

      * **bulk admission** — the all-admitted token *deficit*
        ``d_i = cap - tokens_i`` follows the Lindley recursion
        ``d_i = max(1, d_{i-1} + 1 - rate*dt_i)``, solved in closed
        form with ``cumsum`` + ``maximum.accumulate`` over
        geometrically growing chunks; the first index with
        ``d > cap`` is a rejection;
      * **saturation** — around a rejection the bucket hovers below
        one token: admissions are genuinely sequential, so they are
        replayed with the scalar ``EdgeState`` arithmetic (bit-exact
        by construction), and each *rejected run* in between — the
        bucket refills monotonically while nothing is admitted — is
        skipped with one ``searchsorted``.  Cost scales with the
        number of admissions at saturation (bounded by rate x window),
        never with the offered (rejected) load;
      * **boundary guard** — chunks whose vectorized deficits land
        within ``1e-6`` of the admission boundary, where ``cumsum``
        rounding could disagree with the heap's sequential ``min`` /
        ``max`` arithmetic, are replayed scalar as well."""
    n = t.size
    if not np.isfinite(st.capacity_rps):
        return np.ones(n, dtype=bool)          # infinite edge: admit all
    rate = float(st.capacity_rps)
    cap = rate * st.burst_s
    admitted = np.zeros(n, dtype=bool)
    tokens, last = float(st.tokens), float(st.last_t)
    starved = rate <= 0.0 or cap < 1.0         # can never refill to 1
    a, chunk = 0, _CHUNK0
    while a < n:
        if tokens - 1.0 < 0.0:
            # -- saturation: scalar admits + searchsorted run skips
            while a < n:
                tokens = min(cap, tokens + rate * max(t[a] - last, 0.0))
                last = t[a]
                if tokens - 1.0 >= 0.0:
                    tokens -= 1.0
                    admitted[a] = True
                    a += 1
                    if tokens - 1.0 >= 0.0:
                        break          # bucket recovered: back to bulk
                    continue
                if starved:            # reject the rest, but keep
                    # refilling toward cap like the heap does — a later
                    # CAPACITY_CHANGE may make these tokens admissible
                    tokens = min(cap, tokens
                                 + rate * max(t[n - 1] - last, 0.0))
                    last = t[n - 1]
                    a = n
                    break
                t_ok = last + (1.0 - tokens) / rate
                nxt = max(int(np.searchsorted(t, t_ok, side="left")),
                          a + 1)
                if nxt - 1 > a:        # roll refill through the run
                    tokens = min(cap, tokens + rate * (t[nxt - 1] - last))
                    last = t[nxt - 1]
                a = nxt
            chunk = _CHUNK0
            continue
        # -- bulk: closed-form Lindley over the next chunk
        b = min(a + chunk, n)
        dt = np.empty(b - a)
        dt[0] = t[a] - last
        np.subtract(t[a + 1:b], t[a:b - 1], out=dt[1:])
        g = 1.0 - rate * np.maximum(dt, 0.0, out=dt)
        s = np.cumsum(g)
        d = s + np.maximum(cap - tokens, np.maximum.accumulate(1.0 - s))
        if bool(np.any(np.abs(d - cap) < 1e-6)):
            tokens, last = _bucket_replay(t, admitted, a, b, rate, cap,
                                          tokens, last)
            a, chunk = b, _CHUNK0
            continue
        bad = d > cap
        v = int(np.argmax(bad)) if bad.any() else -1
        if v < 0:                              # whole chunk admitted
            admitted[a:b] = True
            tokens, last = cap - d[-1], t[b - 1]
            a = b
            chunk = min(chunk * 4, _CHUNK_MAX)
            continue
        admitted[a:a + v] = True               # admit the prefix ...
        if v > 0:
            tokens, last = cap - d[v - 1], t[a + v - 1]
        i = a + v                              # ... reject arrival i (its
        tokens = min(cap, tokens + rate * max(t[i] - last, 0.0))
        last = t[i]                            # refill still happens) and
        a, chunk = i + 1, _CHUNK0              # drop into saturation mode
    st.tokens, st.last_t = tokens, last
    return admitted


def _merge_pending(p: np.ndarray, c: np.ndarray, t_last: float,
                   ) -> np.ndarray:
    """In-flight completions surviving past the last processed arrival:
    the ``<= t_last`` prefix of either sorted array is exactly what the
    scalar replay's pops would have drained by then."""
    keep_p = p[np.searchsorted(p, t_last, side="right"):]
    keep_c = c[np.searchsorted(c, t_last, side="right"):]
    if keep_p.size == 0:
        return np.array(keep_c, dtype=np.float64)
    if keep_c.size == 0:
        return np.array(keep_p, dtype=np.float64)
    return np.sort(np.concatenate([keep_p, keep_c]))


def occupancy_replay(t: np.ndarray, pending: np.ndarray, base_ms: float,
                     slots: float,
                     service_ms_fn: Callable[[int], float],
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact vectorized replay of occupancy-coupled service on one
    edge's admitted arrivals ``t`` (sorted).  ``pending`` is the sorted
    array of in-flight completion times carried over from the previous
    window; ``base_ms`` the flat service (base x interference stretch)
    below ``slots`` occupancy (``LatencyModel.flat_service_slots``);
    ``service_ms_fn(occ)`` the exact scalar service at occupancy
    ``occ`` (used only while oversubscribed).  Returns the per-arrival
    service array and the new pending state.

    Mirrors the :func:`bucket_admissions` design — two regimes,
    switched adaptively over geometrically growing chunks:

      * **bulk (occupancy at most ``slots - 1``)** — every service is
        the same ``base_ms``, so completion times are
        ``t + base_ms/1000`` (the *identical* float add the scalar
        path performs) and the occupancy each arrival observes is two
        ``searchsorted`` counts: carried-over completions still in
        flight plus same-run predecessors not yet done.  The first
        arrival whose hypothesized occupancy reaches ``slots`` — where
        service departs from the base and the recursion genuinely
        couples — cuts the run; everything before it is exact;
      * **oversubscribed** — bulk-served in *runs of constant
        occupancy*: when arrival ``k`` observes occupancy ``L``, the
        replay hypothesizes that the whole next chunk stays at level
        ``L`` — every service is then the same ``service_ms_fn(L)``,
        completions are ``t + s/1000`` (the identical float add the
        scalar heap push performs), and each arrival's occupancy under
        the hypothesis is reconstructed exactly from two
        ``searchsorted`` counts (carried completions still in flight
        plus in-run predecessors not yet done).  The first arrival
        whose reconstructed occupancy differs from ``L`` cuts the run
        — everything before it is exact, and the occupancy *at* the
        cut is also exact, so the replay either drops to bulk
        (occupancy back under ``slots``) or re-buckets at the new
        level.  Cost scales with the number of occupancy-level
        *changes*, not with the number of oversubscribed arrivals.

    Bit-identical to the all-scalar replay by construction: both
    regimes perform the same float operations on the same operands
    (integer occupancy counts are exact), and every cut point is
    decided from exactly reconstructed occupancies."""
    n = t.size
    service = np.empty(n, dtype=np.float64)
    p = np.asarray(pending, dtype=np.float64)
    base_s = base_ms / 1000.0
    rel = np.arange(n, dtype=np.int64)       # chunk index template
    a, chunk = 0, _CHUNK0
    while a < n:
        # -- bulk: hypothesize flat service over the next chunk
        b = min(a + chunk, n)
        tc = t[a:b]
        c = tc + base_s                      # completion times if flat
        # same-run predecessors still in flight ...
        occ = rel[:b - a] - np.searchsorted(c, tc, side="right")
        np.maximum(occ, 0, out=occ)
        if p.size:                           # ... plus carried-over ones
            occ += p.size - np.searchsorted(p, tc, side="right")
        over = occ >= slots                  # service departs from base
        v = int(np.argmax(over)) if over.any() else -1
        if v < 0:                            # whole chunk stays flat
            service[a:b] = base_ms
            p = _merge_pending(p, c, float(tc[-1]))
            a = b
            chunk = min(chunk * 4, _CHUNK_MAX)
            continue
        service[a:a + v] = base_ms           # exact flat prefix ...
        if v > 0:
            p = _merge_pending(p, c[:v], float(tc[v - 1]))
        # ... then level-bucketed replay while oversubscribed: runs of
        # equal occupancy share one service value, so they commit in
        # bulk; the hypothesized occupancies are exact integer counts,
        # and the first level change cuts the run
        k = a + v
        lchunk = _CHUNK0
        while k < n:
            tk = t[k]
            p = p[np.searchsorted(p, tk, side="right"):]   # drain pops
            occ = p.size
            if occ < slots:                  # recovered: back to bulk
                break
            s_k = service_ms_fn(occ)
            sc = s_k / 1000.0
            e = min(k + lchunk, n)
            run_t = t[k:e]
            cr = run_t + sc                  # completions if level holds
            alive = p.size - np.searchsorted(p, run_t, side="right")
            done = np.minimum(np.searchsorted(cr, run_t, side="right"),
                              rel[:e - k])
            occ_run = alive + rel[:e - k] - done
            lvl_break = occ_run != occ       # occ_run[0] == occ always
            w = int(np.argmax(lvl_break)) if lvl_break.any() else e - k
            service[k:k + w] = s_k
            p = _merge_pending(p, cr[:w], float(run_t[w - 1]))
            lchunk = (min(lchunk * 4, _CHUNK_MAX) if w == e - k
                      else _CHUNK0)
            k += w
        a, chunk = k, _CHUNK0
    return service, p


def batched_rtt_draws(rng: np.random.Generator, lat,
                      first_tier: np.ndarray,
                      two_hop: np.ndarray) -> np.ndarray:
    """Network legs for one window, drawn from the *same* generator
    stream the heap path would consume: request k's draws occupy the
    same stream positions as its sequential ``lat.rtt(tier, rng)``
    calls would (``uniform(lo, hi)`` scales exactly one raw double), so
    batched and heap runs stay bit-identical when routing is
    deterministic.

    ``first_tier`` is the per-request tier of the first RTT leg
    (TIER_* code); ``two_hop`` marks requests that pay a second *edge*
    leg (R3 overflow / R2-cloud forwarding)."""
    n = first_tier.size
    if n == 0:
        return np.zeros(0)
    # per-tier (lo, width) gathered through one small LUT indexed by the
    # int8 tier code — one fancy-index pass instead of three masked
    # writes over the window
    lut = np.zeros((3, 2))
    for code, (rlo, rhi) in ((TIER_DEVICE, lat.device_rtt_ms),
                             (TIER_EDGE, lat.edge_rtt_ms),
                             (TIER_CLOUD, lat.cloud_rtt_ms)):
        lut[code, 0] = rlo
        lut[code, 1] = rhi - rlo
    bounds = lut[first_tier]
    any_two_hop = bool(two_hop.any())
    if not any_two_hop:
        # common case (no overflow forwarding in the window): one draw
        # per request, stream positions are just 0..n-1 — skip the
        # cumsum offset bookkeeping entirely
        raw = rng.random(n)
        return bounds[:, 0] + raw * bounds[:, 1]
    ndraw = 1 + two_hop.astype(np.int64)
    off = np.zeros(n, dtype=np.int64)
    np.cumsum(ndraw[:-1], out=off[1:])
    raw = rng.random(int(off[-1] + ndraw[-1]))
    net = bounds[:, 0] + raw[off] * bounds[:, 1]
    e_lo, e_hi = lat.edge_rtt_ms
    second = raw[off[two_hop] + 1]
    net[two_hop] += e_lo + second * (e_hi - e_lo)
    return net


# -- fault-plane retry policy -------------------------------------------


class RetryPolicy:
    """Per-request timeout + capped exponential backoff with jitter,
    shared by both engines' fault-mode scalar core.

    A failed attempt ``k`` (0-based) schedules a retry after
    ``min(backoff_cap_s, base_backoff_s * 2**k) * (1 + jitter * u)``
    with ``u`` one uniform draw from the shared generator stream — the
    only randomness retries consume (contract DET003).  A request
    fails over to the cloud replica (rule ``R4-failover``) once it has
    spent ``max_attempts`` tries or its next retry would land past
    ``timeout_s`` after the original arrival.  ``max_attempts <= 1``
    disables retries entirely (immediate failover); a huge
    ``max_attempts`` + ``timeout_s`` never fails over (requests back
    off until the fault clears) — the no-failover baseline of
    ``benchmarks/perf_faults.py``."""

    __slots__ = ("timeout_s", "base_backoff_s", "backoff_cap_s",
                 "max_attempts", "jitter")

    def __init__(self, timeout_s: float = 2.0,
                 base_backoff_s: float = 0.05,
                 backoff_cap_s: float = 0.8,
                 max_attempts: int = 4,
                 jitter: float = 0.5):
        self.timeout_s = float(timeout_s)
        self.base_backoff_s = float(base_backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.max_attempts = int(max_attempts)
        self.jitter = float(jitter)


def backoff_delay(policy: RetryPolicy, attempt: int, u: float) -> float:
    """Backoff before retry ``attempt + 1`` given one uniform draw
    ``u`` in [0, 1).  Pure float arithmetic — evaluated identically by
    the heap and batched engines."""
    base = min(policy.backoff_cap_s,
               policy.base_backoff_s * float(2 ** attempt))
    return base * (1.0 + policy.jitter * u)
