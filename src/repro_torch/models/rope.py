"""Rotary position embeddings with partial rotation, the counterpart of
``repro/models/rope.py`` (half-split pairs, as there)."""
from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(head_dim: int, theta: float,
                     fraction: float = 1.0) -> np.ndarray:
    """Inverse frequencies (rot_dim // 2,) float32 of the rotated
    sub-dimension; ``fraction`` < 1 rotates only the leading
    ``fraction * head_dim`` dims (stablelm's partial rotary)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    k = np.arange(rot // 2, dtype=np.float32)
    return (1.0 / (theta ** (2.0 * k / rot))).astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by ``positions``
    (..., seq).  Only the leading ``2*len(inv_freq)`` dims rotate, and
    dim i pairs with dim i + len(inv_freq) (the first and second halves
    of the rotated dims, not interleaved); the rest pass through."""
    half = inv_freq.shape[-1]
    rot = 2 * half
    ang = positions[..., :, None].float() * inv_freq     # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]                # over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)
