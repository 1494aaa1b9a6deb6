#!/usr/bin/env python3
"""The disaggregated handoff's copy between two cards, alone.

    python3 scripts/torch_handoff_probe.py [--mb 16,64,256] [--repeats 5]

Needs two cards. Prints the cards' names and power limits, whether each can
read the other's memory directly (``torch.cuda.can_device_access_peer``),
then, for pieces of each size (a bf16 tensor of that many MB on ``cuda:0``),
the seconds and GB/s of ``cache/kv_transfer.transfer`` onto ``cuda:1`` (the
engine's route: the copy timed by the CUDA events around it on a stream of
the decode device) and of a plain ``copy_`` issued on each side's stream,
timed the same way, the median of ``--repeats`` after one warm-up each. One
JSON line per size, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _timed_copy(torch, src, dst, stream) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        start.record(stream)
        dst.copy_(src, non_blocking=True)
        end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", default="16,64,256")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from quorum_tpu_torch.cache import kv_transfer

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_handoff_probe: needs two CUDA devices", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    src_dev, dst_dev = torch.device("cuda", 0), torch.device("cuda", 1)
    peer = {"0->1": torch.cuda.can_device_access_peer(0, 1),
            "1->0": torch.cuda.can_device_access_peer(1, 0)}
    rows = []
    for mb in (int(x) for x in args.mb.split(",")):
        n = mb * (1 << 20) // 2
        src = torch.randn((n,), device=src_dev).to(torch.bfloat16)
        torch.cuda.synchronize(src_dev)
        dst_stream = torch.cuda.Stream(dst_dev)
        src_stream = torch.cuda.Stream(src_dev)
        out = {}
        for label in ("transfer", "copy_on_decode_stream", "copy_on_prefill_stream"):
            times = []
            for i in range(args.repeats + 1):
                if label == "transfer":
                    moved, nbytes, secs, _ = kv_transfer.transfer(
                        (src, src), dst_dev, stream=dst_stream, record=False)
                    secs_one = secs / 2  # two leaves of one size
                    del moved
                else:
                    dst = torch.empty_like(src, device=dst_dev)
                    stream = dst_stream if label == "copy_on_decode_stream" else src_stream
                    secs_one = _timed_copy(torch, src, dst, stream)
                if i:
                    times.append(secs_one)
            med = statistics.median(times)
            out[label] = {"seconds": med, "gb_per_s": src.numel() * 2 / med / 1e9}
        row = {"mb": mb, "bytes": src.numel() * 2, **out}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"peer_access": peer, "devices": [torch.cuda.get_device_name(i) for i in
                                                       range(torch.cuda.device_count())],
                      "sizes": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
