"""The one traffic generator: reads a mix's parameters and draws its
requests.

Lengths come from the mix's own ``lengths_seed``, so every run seed
serves the same multiset of sizes; the run seed only orders them (which
client gets which sequence of requests) and draws the token ids.  So
runs of different seeds do the same work in another order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class Ask:
    """One request as a client sends it."""
    client: int
    index: int                  # the client's k-th request
    prompt: np.ndarray          # (S,) int64 token ids
    max_new_tokens: int


def draw_lengths(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` whole lengths from ``dist``: ``loguniform`` over [lo, hi]
    (rounded, both ends reachable) or ``fixed`` at ``value``."""
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    if kind == "loguniform":
        lo, hi = float(dist["lo"]), float(dist["hi"])
        x = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def closed_loop(traffic: Dict, clients: int, vocab: int, seed: int
                ) -> List[List[Ask]]:
    """Every client's requests in the order it sends them (a
    ``serve-closed`` mix).  Client c's lengths are the mix's fixed row
    ``perm[c]``; token ids are uniform over [1, vocab)."""
    per = int(traffic["requests_per_client"])
    fixed = np.random.default_rng(int(traffic["lengths_seed"]))
    prompt_len = draw_lengths(traffic["prompt_len"], clients * per,
                              fixed).reshape(clients, per)
    output_len = draw_lengths(traffic["output_len"], clients * per,
                              fixed).reshape(clients, per)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(clients)
    out = []
    for c in range(clients):
        row = perm[c]
        out.append([Ask(client=c, index=k,
                        prompt=rng.integers(1, vocab, int(prompt_len[row, k]),
                                            dtype=np.int64),
                        max_new_tokens=int(output_len[row, k]))
                    for k in range(per)])
    return out
