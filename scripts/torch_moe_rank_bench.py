"""Time three ways of ranking routed (token, slot) pairs within their
expert on the card: the cumsum of the int32 one-hot along the tokens (the
reference's layout), the same cumsum on the transposed one-hot (along
contiguous memory; ``models.moe.rank_within``), and a stable sort.  All
three give the same integers (checked).  Sizes: a decode batch (8 tokens
× top-8), a prefill of 8 × 512 and one of 8 × 544, 128 experts.

    python scripts/torch_moe_rank_bench.py      # on a machine with a card

Prints one line, ``RANK_BENCH {size: {variant: ms}}`` (CUDA events, mean
of 20 calls after 3 warm ones).
"""
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.models.moe import rank_within   # noqa: E402


def onehot_cumsum_tokens(ids, n):
    oh = F.one_hot(ids, n).to(torch.int32)
    csum = torch.cumsum(oh, -2, dtype=torch.int32)
    return torch.gather(csum, -1, ids[..., None])[..., 0] - 1


def sort_rank(ids, n):
    order = torch.sort(ids, stable=True).indices
    counts = torch.bincount(ids, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(ids)
    rank[order] = torch.arange(ids.numel(), device=ids.device) \
        - starts[ids[order]]
    return rank


def time_ms(fn, *a, reps: int = 20) -> float:
    for _ in range(3):
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    variants = {"onehot_cumsum_dim0": onehot_cumsum_tokens,
                "onehot_cumsum_last": rank_within, "sort": sort_rank}
    out = {}
    for pairs in (8 * 8, 4096 * 8, 4352 * 8):
        ids = torch.randint(0, 128, (pairs,), device="cuda")
        want = variants["onehot_cumsum_dim0"](ids, 128).long()
        for name, fn in variants.items():
            if not torch.equal(fn(ids, 128).long(), want):
                sys.exit(f"{name} ranks differently")
        out[pairs] = {name: time_ms(fn, ids, 128)
                      for name, fn in variants.items()}
    print("RANK_BENCH", json.dumps(out))


if __name__ == "__main__":
    main()
