#!/usr/bin/env python3
"""Time the two attention kernels of one checkout of the PyTorch port on the
card: by both of the methods ``chip_smoke.py`` uses, and the host cost of
their wrappers.

    python3 scripts/torch_kernel_ab.py --root DIR [--label NAME]

Imports ``quorum_tpu_torch`` from DIR (the repo root, or an older commit
unpacked with ``git archive`` into a git-ignored directory), builds that
checkout's kernels there, and times them at the kernels line's shapes:

  K1 flash_prefill_attention  B=1, H=32, K=8, S=2048 at full length, hd=128, bf16
  K2 flash_decode_attention   4 slots, T=8192, lengths 1/100/4096/8191,
                              H=32, K=8, hd=128, bf16
  K2q8 flash_decode_q8_attention  the same lengths over an int8 cache with
                              f32 scales, bf16 q; and 4 slots of T=32768,
                              all live (``long``)

  graph_ms  device time per call from one CUDA graph over input copies that
            together exceed the 50 MB L2 (cold inputs, no host cost);
  eager_ms  CUDA events around each wrapper call on the same inputs (warm
            L2; the wrapper's host cost, the launch and the kernel in series);
  host_us   host time per wrapper call: wall time over batches of 50 calls,
            the card synchronised between batches (what the wrapper costs a
            host-paced decode step).

Prints one JSON line with the card's name and power limit. To compare two
commits, run both on one card, one after another, in the order parent,
change, change, parent. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timers(torch):
    """chip_smoke.py's two timers and its input-copy rule, loaded from this
    repo's copy (DIR may hold an older chip_smoke.py)."""
    spec = importlib.util.spec_from_file_location("_chip_smoke_timers",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    median_ms = mod.make_timer(torch, False)
    return median_ms, mod.make_graph_timer(torch, False, median_ms), mod._copies


def host_us(torch, fn, n: int = 2000, batch: int = 50) -> float:
    """Host microseconds per call of ``fn`` (after ``batch`` warm-up calls)."""
    for _ in range(batch):
        fn()
    total = 0.0
    for _ in range(n // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / (n // batch * batch) * 1e6


def _time_q8(torch, graph_ms, median_ms, copies, clusters) -> dict:
    """K2q8 at the kernels line's shape and at the long-cache one: graph_ms
    and eager_ms as above; with ``clusters``, graph_ms again with each
    cluster size forced in place of the wrapper's choice."""
    from quorum_tpu_torch.ops import flash_decode_q8 as fq
    from quorum_tpu_torch.ops.attention import quantize_rows

    h, kv, hd = 32, 8, 128
    res = {}
    for name, t, lens in (("main", 8192, [1, 100, 4096, 8191]), ("long", 32768, [32768] * 4)):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def side():
            x8, xs = quantize_rows(torch.randn((4, kv, t, hd), device="cuda"), -1)
            return x8, xs[..., 0].contiguous()

        sets = [(torch.randn((4, h, 1, hd), device="cuda").to(torch.bfloat16),
                 *side(), *side(), lengths)
                for _ in range(copies(sum(lens) * kv * (2 * hd + 8)))]
        row = {"graph_ms": graph_ms([lambda a=a: fq.flash_decode_q8_attention(*a)
                                     for a in sets]),
               "eager_ms": median_ms(lambda: fq.flash_decode_q8_attention(*sets[0]))}
        if clusters and hasattr(fq, "q8_cluster_size"):
            chosen = fq.q8_cluster_size
            row["cluster_chosen"] = chosen(4, kv, t)
            try:
                for c in clusters:
                    fq.q8_cluster_size = lambda *shape, c=c: c
                    row[f"graph_ms_cluster_{c}"] = graph_ms(
                        [lambda a=a: fq.flash_decode_q8_attention(*a) for a in sets])
            finally:
                fq.q8_cluster_size = chosen
        res[name] = row
        del sets
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose quorum_tpu_torch is timed")
    ap.add_argument("--label", default=None, help="name printed with the result")
    ap.add_argument("--q8-clusters", default="",
                    help="also time K2q8 with each of these cluster sizes forced (comma-"
                         "separated; checkouts that choose one with q8_cluster_size)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import quorum_tpu_torch
    from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention
    from quorum_tpu_torch.ops.flash_decode import flash_decode_attention

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(quorum_tpu_torch.__file__)))
    if pkg_root != root:
        print(f"torch_kernel_ab: imported the port from {pkg_root}, not {root}", file=sys.stderr)
        return 1
    median_ms, graph_ms, copies = _timers(torch)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)

    h, kv, hd = 32, 8, 128
    s = 2048
    full = torch.tensor([s], dtype=torch.int32, device="cuda")
    sets = [(rnd(1, h, s, hd), rnd(1, kv, s, hd), rnd(1, kv, s, hd), full)
            for _ in range(copies(2 * (2 * h + 2 * kv) * s * hd))]
    k1 = {"graph_ms": graph_ms([lambda a=a: flash_prefill_attention(*a) for a in sets]),
          "eager_ms": median_ms(lambda: flash_prefill_attention(*sets[0])),
          "host_us": host_us(torch, lambda: flash_prefill_attention(*sets[0]))}
    del sets

    t, lens = 8192, [1, 100, 4096, 8191]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sets = [(rnd(4, h, 1, hd), rnd(4, kv, t, hd), rnd(4, kv, t, hd), lengths)
            for _ in range(copies(2 * 2 * sum(lens) * kv * hd))]
    k2 = {"graph_ms": graph_ms([lambda a=a: flash_decode_attention(*a) for a in sets]),
          "eager_ms": median_ms(lambda: flash_decode_attention(*sets[0])),
          "host_us": host_us(torch, lambda: flash_decode_attention(*sets[0]))}
    del sets

    torch.manual_seed(0)
    k2q8 = _time_q8(torch, graph_ms, median_ms, copies,
                    [int(c) for c in args.q8_clusters.split(",") if c])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label or root, "flash_prefill": k1, "flash_decode": k2,
                      "flash_decode_q8": k2q8,
                      "card": smi.splitlines()[0] if smi else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
