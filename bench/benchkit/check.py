"""The correctness check of a served model: what the timed path served,
held against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the completed requests, drawn from the seed and holding the longest one,
goes through the reference: one forward pass over each prompt with its
served tokens.  At each position that served a token (the prefill's
last position for the first token, a decode step for each later one),
the gap is how far the served token's reference logit lies below the
reference's best.  The number compared is the mean gap over the
sample's served tokens; the widest gap is read beside it.  The control
reads the same gaps for the token that a lower precision of the
reference puts first (:func:`gaps` with ``control="fp8"``).  On random
weights the control's logits are only ~3x further from the reference's
than the bf16 program's, so the widest gap (a maximum over ~2,000
near-ties) separates the two by no more than that; the mean gap, which
grows with the square of that distance (how often the top two swap
times by how much), separates them ~10-fold.

The program's own logits are not compared: the engine's ``admit`` and
``decode`` return token ids, and its logits never leave the call.  So an
error that leaves every served token the reference's best, or one near
it, goes unseen here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from reference import transformer as ref


def sample(completed: Sequence[Any], n: int, seed: int) -> List[Any]:
    """``n`` of the completed requests: the longest (prompt and served
    tokens) and n - 1 others drawn from ``seed``."""
    if not completed:
        return []
    size = [len(r.prompt) + len(r.tokens) for r in completed]
    longest = int(np.argmax(size))
    rest = [i for i in range(len(completed)) if i != longest]
    rng = np.random.default_rng([int(seed), 0x5EED])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [completed[longest]] + [completed[rest[i]] for i in sorted(pick)]


def gaps(params: Dict[str, Any], cfg: Dict[str, Any], requests: Sequence[Any],
         device, control: str = "") -> Dict[str, float]:
    """The widest and mean gaps of the served tokens and, with
    ``control`` a precision, of the tokens the control puts first
    (``control_*``); the tokens and requests compared."""
    widest, widest_ctl, total, total_ctl, n_tok = 0.0, 0.0, 0.0, 0.0, 0
    for r in requests:
        served = np.asarray(r.tokens, np.int64)
        seq = np.concatenate([np.asarray(r.prompt, np.int64), served[:-1]])
        start = len(r.prompt) - 1
        toks = torch.as_tensor(seq, device=device)
        want = ref.logits(params, cfg, toks, start)
        best = want.max(dim=-1).values
        at = torch.as_tensor(served, device=device)
        g = best - want.gather(1, at[:, None])[:, 0]
        widest = max(widest, float(g.max()))
        total += float(g.sum())
        n_tok += len(served)
        if control:
            low = ref.logits(params, cfg, toks, start, precision=control)
            pick = low.argmax(dim=-1)
            gc = best - want.gather(1, pick[:, None])[:, 0]
            widest_ctl = max(widest_ctl, float(gc.max()))
            total_ctl += float(gc.sum())
        del want
    mean = total / max(n_tok, 1)
    out = {"widest_gap": widest, "mean_gap": mean, "tokens_checked": n_tok,
           "requests_checked": len(requests)}
    if control:
        out["control_widest_gap"] = widest_ctl
        out["control_mean_gap"] = total_ctl / max(n_tok, 1)
    return out


def complete(requests: Sequence[Any]) -> bool:
    """Every request holds all the tokens it asked for."""
    return all(len(r.tokens) == r.max_new_tokens for r in requests)
