"""Bytes and operations of one call of the port's attention kernels, from
the call's shapes alone (each input byte read once, each output byte
written once; the work a row's data needs, not the most it could).
Frozen copies of ``chip_smoke.py``'s ``paged_work`` and the byte and
operation counts beside its ``check_paged_mla`` and ``check_flash``
calls."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def paged_work(lengths: Sequence[int], ps: int, pseq: int,
               window: Optional[int] = None) -> Tuple[int, int, int]:
    """(counted tokens, mean slots, table entries) of a paged decode
    call: per row its counted tokens and the table entries of their
    pages; a row with none reads the V (latents) of all ``pseq * ps``
    slots and every table entry."""
    lengths = np.asarray(lengths, np.int64)
    hi = np.minimum(lengths, pseq * ps)
    lo = np.maximum(0, lengths - window) if window else np.zeros_like(hi)
    counted = hi > lo
    tokens = int(np.where(counted, hi - lo, 0).sum())
    pages = np.where(counted, -(-hi // ps) - lo // ps, pseq)
    return tokens, int((~counted).sum()) * pseq * ps, int(pages.sum())


def paged_mla_decode(lengths: Sequence[int], ps: int, pseq: int, H: int,
                     R: int, Dr: int, itemsize: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one ``paged_mla_decode_attention`` call: an
    absorbed query (R + Dr) a head over the row's latents."""
    B = len(lengths)
    tokens, mean_slots, pages = paged_work(lengths, ps, pseq)
    nbytes = (itemsize * (B * H * (2 * R + Dr) + tokens * (R + Dr)
                          + mean_slots * R) + 4 * (pages + B))
    return nbytes, (tokens * (2 * R + Dr) + mean_slots * R) * H * 2


def flash(BH: int, BHkv: int, T: int, D: int, Dv: int,
          causal: bool = True, itemsize: int = 2) -> Tuple[int, int]:
    """(bytes, flops) of one ``flash_attention`` call over T queries and
    T keys: q, k, v read and the output written once, QK^T and PV over
    the unmasked pairs only."""
    pairs = BH * (T * (T + 1) // 2 if causal else T * T)
    nbytes = itemsize * (BH * T * (D + Dv) + BHkv * T * (D + Dv))
    return nbytes, 2 * pairs * (D + Dv)
