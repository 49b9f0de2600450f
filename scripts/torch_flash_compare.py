#!/usr/bin/env python3
"""Time the port's flash_attention beside another checkout's on one GPU,
at the bf16 shapes of the main paths: the long walks the split serves
and the serving prefills.

``--against DIR`` names the root of another checkout of the repo (a
parent commit unpacked by ``git archive <commit> --prefix=_parent/ | tar
-x`` into the gitignored ``_parent/``).  Its ``repro_torch`` package is
imported apart from this one's (``_compare.import_other``), so each side
goes through its own ``flash_attention`` wrapper and builds its own
kernels with its own ``build.load``.  At each shape both run on the same
inputs; each is held against this checkout's plain version (bf16 3e-2)
and they are timed in turns (other, this, SDPA, this, other, SDPA) as
``chip_smoke.py`` times a kernel (a CUDA graph of 200 calls replayed
between CUDA events, warm L2), beside PyTorch's
``scaled_dot_product_attention`` on 4-d views (the kv heads repeated
outside its timing; a boolean mask under a window).
Each line also carries this checkout's instance and chunk count S and
the bound of the work (``chip_smoke.bound``: inputs read once, the
output written once, the unmasked pairs' products at the bf16 rate).

The shapes: gemma3 (4 query heads on 1 kv head, D = Dv = 256: the
engines admit one row at a time) at T 1024 (global, and the local
layers' window 512) and T 64; whisper-small's cross attention (24 heads
of 64, 64 and 16 tokens to 1500 frames) and encoder (1500 frames without
the causal mask); zamba2's forward (64 heads of 64, T 1024); stablelm's
prefill (32 heads of 64, T 64), deepseek's (16 heads, D 192, Dv 128, T
64), the LM training forward (gemma3 at B 4: 16 heads on 4, T 64, window
512) and the expert-parallel rank's (16 heads, D 192, Dv 128, T 256).

Prints the card's ``nvidia-smi`` name and power limit and one JSON line a
shape; the lines also go to ``--out``.  Exits 1 if either side
disagrees with the plain version.

    python3 scripts/torch_flash_compare.py --against _parent \\
        [--out results/flash_compare.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from _compare import import_other

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 200
#: (name, BH, BHkv, T, Tk, D, Dv, causal, window)
SHAPES = [
    ("gemma3_T1024_global", 4, 1, 1024, 1024, 256, 256, True, 0),
    ("gemma3_T1024_window512", 4, 1, 1024, 1024, 256, 256, True, 512),
    ("whisper_cross_64_1500", 24, 24, 64, 1500, 64, 64, False, 0),
    ("whisper_cross_16_1500", 24, 24, 16, 1500, 64, 64, False, 0),
    ("whisper_encoder_1500", 24, 24, 1500, 1500, 64, 64, False, 0),
    ("zamba2_T1024", 64, 64, 1024, 1024, 64, 64, True, 0),
    ("gemma3_T64", 4, 1, 64, 64, 256, 256, True, 0),
    ("stablelm_T64", 32, 32, 64, 64, 64, 64, True, 0),
    ("deepseek_T64", 16, 16, 64, 64, 192, 128, True, 0),
    ("train_gemma3_B4_T64", 16, 4, 64, 64, 256, 256, True, 512),
    ("ep_rank_T256", 16, 16, 256, 256, 192, 128, True, 0),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "flash_compare.jsonl"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash compare: no CUDA device", file=sys.stderr)
        return 1
    other = import_other(args.against, ["flash_attention"])["flash_attention"]
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import bound, device_ms, BF16_FLOP_PER_S
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    assert other.flash_attention is not fa.flash_attention
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
    for name, BH, BHkv, T, Tk, D, Dv, causal, window in SHAPES:
        q, k, v = (torch.randn(s, generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for s in ((BH, T, D), (BHkv, Tk, D), (BHkv, Tk, Dv)))
        G = BH // BHkv
        q4 = q[None]
        k4, v4 = (x.repeat_interleave(G, 0)[None] for x in (k, v))
        d = (torch.arange(T, device=dev)[:, None]
             - torch.arange(Tk, device=dev)[None, :])
        allowed = torch.ones((T, Tk), dtype=torch.bool, device=dev)
        if causal:
            allowed &= d >= 0
        if window:
            allowed &= d < window

        def library():
            if window:
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=allowed)
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal)

        def this():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def theirs():
            return other.flash_attention(q, k, v, causal=causal,
                                         window=window)

        plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
        got, old = this(), theirs()
        torch.cuda.synchronize()
        errs = [(x.float() - plain.float()).abs().max().item()
                for x in (got, old)]
        ok = all(torch.allclose(x.float(), plain.float(), atol=3e-2,
                                rtol=3e-2) for x in (got, old))
        failed += not ok
        turns = [device_ms(torch, f, ITERS) for f in
                 (theirs, this, library, this, theirs, library)]
        pairs = BH * int(allowed.sum())
        bound_ms, bound_by = bound(
            2 * (BH * T * (D + Dv) + BHkv * Tk * (D + Dv)),
            pairs * 2 * (D + Dv), BF16_FLOP_PER_S)
        win = window if 0 < window < T else 0
        emit({"shape": name, "BH": BH, "BHkv": BHkv, "T": T, "Tk": Tk,
              "D": D, "Dv": Dv, "causal": causal, "window": window,
              "instance": fa.instance(q, k, v),
              "splits": fa.splits(q, k, v, causal, win), "ok": ok,
              "max_abs_err": errs[0], "other_max_abs_err": errs[1],
              "ms": (turns[1] + turns[3]) / 2,
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
