#!/usr/bin/env python3
"""Time the port's GQA decode kernels beside another checkout's on one
GPU, at the shapes where the split walk matters and at the serving ones.

``--against DIR`` names the root of another checkout of the repo (a
parent commit unpacked by ``git archive <commit> --prefix=_parent/ | tar
-x`` into the gitignored ``_parent/``).  Its ``repro_torch`` package is
imported apart from this one's, so each side goes through its own
wrappers (``decode_attention``, ``decode_attention_partial``,
``paged_decode_attention``) and builds its own kernels with its own
``build.load``.  At each shape both run on the same inputs; each is held
against this checkout's plain version (bf16 3e-2, the partial statistics'
o / l, m, l at 3e-5) and they are timed in turns (other, this, this,
other) as ``chip_smoke.py`` times a kernel (a CUDA graph of 200 calls
replayed between CUDA events), beside the one PyTorch call that computes
the same function (SDPA with a mask; a gather of the pages, then SDPA;
memory-efficient attention with its log-sum-exp for the partial
statistics), timed in the same turns.  Each line also carries this
checkout's chunk count S and the bound of the work (``chip_smoke.bound``
over the bytes of the valid K/V rows).

The shapes: gemma3's (4 query heads on 1 kv head, D 256) paged 616-token
rows under window 512, dense 1024-slot ring of 616 valid and 512-slot
ring all valid, the split decode's 16,384-slot shares at B 3 (gemma3 and
stablelm's 32 heads of D 64); whisper's cross rows (B 4, 12 heads, 1500
slots, D 64); and the serving shapes, stablelm and gemma3 dense at B
1/4/8 over 256-slot rings of 57-64 valid and paged at B 4/16/32 over 16
pages of 16.  All bf16.

Prints the card's ``nvidia-smi`` name and power limit and one JSON line a
shape; the lines also go to ``--out``.  Exits 1 if a kernel disagrees
with the plain version.

    python3 scripts/torch_decode_compare.py --against _parent \\
        [--out results/decode_compare.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from _compare import import_other

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 200
MODULES = ("decode_attention", "paged_decode_attention")
#: (name, kernel, B, H, Hkv, D, slots, rows): dense / partial rows are
#: leading valid counts per row, or ("share", rank) for the split
#: decode's masks; paged rows are lengths (pages of 16, window last)
SERVING = [n for B in (1, 4, 8) for n in (
    (f"stablelm_dense_B{B}", "dense", B, 32, 32, 64, 256,
     [57 + b % 8 for b in range(B)]),
    (f"gemma_dense_B{B}", "dense", B, 4, 1, 256, 256,
     [57 + b % 8 for b in range(B)]))] + [n for B in (4, 16, 32) for n in (
    (f"stablelm_paged_B{B}", "paged", B, 32, 32, 64, 16,
     [57 + b % 8 for b in range(B)], None),
    (f"gemma_paged_B{B}", "paged", B, 4, 1, 256, 16,
     [57 + b % 8 for b in range(B)], None))]
LONG = [("gemma_paged_616_window_512", "paged", 2, 4, 1, 256, 64, [616] * 2,
         512),
        ("gemma_dense_C1024_616", "dense", 2, 4, 1, 256, 1024, [616] * 2),
        ("gemma_dense_C512", "dense", 2, 4, 1, 256, 512, [512] * 2),
        ("gemma_partial_r0", "partial", 3, 4, 1, 256, 16384, ("share", 0)),
        ("gemma_partial_r1", "partial", 3, 4, 1, 256, 16384, ("share", 1)),
        ("stablelm_partial_r0", "partial", 3, 32, 32, 64, 16384,
         ("share", 0)),
        ("whisper_dense_B4", "dense", 4, 12, 12, 64, 1500, [1500] * 4)]


def share_mask(rank: int) -> np.ndarray:
    """Rank ``rank``'s half of the split decode's 32,768-slot ring at its
    first step (``chip_smoke.split_masks``): rows of 3,001, 20,001 and
    40,001 tokens, leading slots valid."""
    tokens = np.array([3_001, 20_001, 40_001])
    lo = rank * 16_384
    held = np.clip(tokens - lo, 0, 16_384)
    return np.arange(16_384)[None, :] < held[:, None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "decode_compare.jsonl"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode compare: no CUDA device", file=sys.stderr)
        return 1
    other = import_other(args.against, MODULES)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import bound, device_ms, BF16_FLOP_PER_S
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import ref
    assert other["decode_attention"].decode_attention is not \
        da.decode_attention
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    log = open(args.out, "w")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        log.write(line + "\n")

    emit({"smi": smi, "against": args.against})
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    for case in LONG + SERVING:
        name, kind, B, H, Hkv, D, slots, rows = case[:8]
        randn = lambda *s: torch.randn(  # noqa: E731
            s, generator=gen, device=dev, dtype=torch.bfloat16)
        q = randn(B, H, D)
        if kind == "paged":
            window = case[8]
            ps, Pseq = 16, slots
            lengths = torch.tensor(rows, dtype=torch.int32, device=dev)
            P = B * Pseq
            kp, vp = randn(P, ps, Hkv, D), randn(P, ps, Hkv, D)
            bt = torch.randperm(P, generator=gen, device=dev).to(
                torch.int32).view(B, Pseq)
            t = torch.arange(Pseq * ps, device=dev)[None, :]
            ln = lengths.long()[:, None]
            mask = t < ln
            if window:
                mask &= ln - 1 - t < window
            counted = int(mask.sum())
            win = window if window and window < Pseq * ps else 0
            S = pda.splits(B, H, Hkv, ps, Pseq, D, D, win, dev)
            this = lambda: pda.paged_decode_attention(  # noqa: E731
                q, kp, vp, bt, lengths, window=window)
            theirs = lambda: other["paged_decode_attention"] \
                .paged_decode_attention(  # noqa: E731
                    q, kp, vp, bt, lengths, window=window)
            plain = ref.paged_decode_attention_ref(q, kp, vp, bt, lengths,
                                                   window=window)
            bt_l, m4 = bt.long(), mask[:, None, None, :]

            def library():
                k = kp[bt_l].flatten(1, 2).transpose(1, 2)
                v = vp[bt_l].flatten(1, 2).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=m4,
                    enable_gqa=H != Hkv)[:, :, 0]
            nbytes = 2 * (2 * B * H * D + 2 * counted * Hkv * D) \
                + 4 * (B * Pseq + B)
        else:
            k, v = randn(B, slots, Hkv, D), randn(B, slots, Hkv, D)
            if rows[0] == "share":
                valid = torch.as_tensor(share_mask(rows[1]), device=dev)
            else:
                valid = torch.arange(slots, device=dev)[None, :] < \
                    torch.tensor(rows, device=dev)[:, None]
            counted = int(valid.sum())
            S = da.splits(B, H, Hkv, slots, D, D, dev)
            none = int((~valid.any(1)).sum())
            if kind == "partial":
                this = lambda: da.decode_attention_partial(  # noqa: E731
                    q, k, v, valid)
                theirs = lambda: other["decode_attention"] \
                    .decode_attention_partial(q, k, v, valid)  # noqa: E731
                plain = ref.decode_attention_partial_ref(q, k, v, valid)
                q4 = q[:, :, None]
                k4, v4 = (x.transpose(1, 2).repeat_interleave(
                    H // Hkv, 1).contiguous() for x in (k, v))
                bias = torch.where(valid, 0.0, -1e30).to(q.dtype)[
                    :, None, None, :].expand(B, H, 1, slots).contiguous()

                def library():
                    return torch.ops.aten \
                        ._scaled_dot_product_efficient_attention(
                            q4, k4, v4, bias, True)[:2]
            else:
                this = lambda: da.decode_attention(  # noqa: E731
                    q, k, v, valid)
                theirs = lambda: other["decode_attention"] \
                    .decode_attention(q, k, v, valid)  # noqa: E731
                plain = ref.decode_attention_ref(q, k, v, valid)

                def library():
                    return F.scaled_dot_product_attention(
                        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=valid[:, None, None, :],
                        enable_gqa=H != Hkv)
            nbytes = 2 * (2 * B * H * D + (2 * counted + none * slots)
                          * Hkv * D) + B * slots
        got, old = this(), theirs()
        torch.cuda.synchronize()
        if kind == "partial":
            tol = 3e-5
            pairs = [(g[0] / g[2][..., None], *g[1:]) for g in
                     (got, old, plain)]
        else:
            tol = 3e-2
            pairs = [(x,) for x in (got, old, plain)]
        err = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(pairs[0], pairs[2]))
        err_other = max((a.float() - w.float()).abs().max().item()
                        for a, w in zip(pairs[1], pairs[2]))
        ok = all(torch.allclose(a.float(), w.float(), atol=tol, rtol=tol)
                 for a, w in zip(pairs[0], pairs[2]))
        failed += not ok
        turns = [device_ms(torch, f, ITERS) for f in
                 (theirs, this, library, this, theirs, library)]
        bound_ms, bound_by = bound(nbytes, 4 * counted * H * D,
                                   BF16_FLOP_PER_S)
        emit({"shape": name, "kind": kind, "B": B, "H": H, "Hkv": Hkv,
              "D": D, "slots": slots, "counted": counted, "splits": S,
              "ok": ok, "max_abs_err": err, "other_max_abs_err": err_other,
              "tol": tol, "ms": (turns[1] + turns[3]) / 2,
              "other_ms": (turns[0] + turns[4]) / 2,
              "library_ms": (turns[2] + turns[5]) / 2, "turns_ms": turns,
              "bound_ms": bound_ms, "bound_by": bound_by})
        torch.cuda.empty_cache()
    log.close()
    if failed:
        print(f"{failed} shapes disagree with the plain version",
              file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
