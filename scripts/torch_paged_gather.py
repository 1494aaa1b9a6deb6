#!/usr/bin/env python3
"""Device time of the paged decode gather on the card: one step's window
reads (``cache/paging``: one ``window_index`` a step, one ``index_select``
a leaf a layer) against a plain contiguous copy of the same bytes and
against the per-element advanced-index gather the port used first.

    python3 scripts/torch_paged_gather.py [--layers 32] [--rows 4]

llama-3-8b's cache geometry (8 kv heads, head_dim 128, 512-token pages),
bf16 and int8 pools, history buckets 2 048 and 8 192. Each variant's step
(every layer of a pool larger than the 50 MB L2, as a decode step finds
it) is captured in a CUDA graph, as the engine's decode step is, and
replayed between CUDA events; the variants' windows are checked equal. Prints one JSON line per case, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _advanced_index(p, phys, hist):
    """The first gather: per-element advanced indexing."""
    import torch

    heads = torch.arange(p.shape[1], device=p.device)[None, :, None]
    g = p[phys[:, None, :], heads]
    g = g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])
    return g[:, :, :hist].contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from quorum_tpu_torch.cache.paging import PagedKV, _gather, page_read, window_index

    if not torch.cuda.is_available():
        print("torch_paged_gather: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    n_kv, hd, ps, b, n_layers = 8, 128, 512, args.rows, args.layers
    torch.manual_seed(0)
    for kind in ("bfloat16", "int8"):
        for hist in (2048, 8192):
            hp = hist // ps
            n_pages = b * hp + 2
            shape = (n_layers, n_pages, n_kv, ps, hd)
            if kind == "int8":
                pools = [(torch.randint(-127, 128, shape, dtype=torch.int8, device=dev),
                          torch.rand(shape[:-1], device=dev)) for _ in range(2)]
            else:
                pools = [torch.randn(shape, device=dev).bfloat16() for _ in range(2)]
            table = torch.zeros((b, 16384 // ps), dtype=torch.int32, device=dev)
            table[:, :hp] = (torch.randperm(b * hp, device=dev) + 1).view(b, hp).int()
            phys = table[:, :hp].long()
            leaves = [leaf for pool in pools for leaf in (pool if kind == "int8" else (pool,))]
            # a token's bytes in one leaf: [K, hd] values or [K] scales
            nbytes = sum(b * hist * leaf[0, 0, :, 0].numel() * leaf.element_size()
                         for leaf in leaves) * n_layers
            # the bytes a step's gather moves: each window read once, written once
            moved = 2 * nbytes

            def index_select_step():
                idx = window_index(table, hist, ps, n_kv)
                return [_gather(leaf[l], idx, b, hist) for l in range(n_layers)
                        for leaf in leaves]

            def advanced_step():
                return [_advanced_index(leaf[l], phys, hist) for l in range(n_layers)
                        for leaf in leaves]

            def copy_step():
                return [leaf[l][:b * hp].reshape(b, -1).clone() for l in range(n_layers)
                        for leaf in leaves]

            variants = {"index_select": index_select_step, "advanced_index": advanced_step,
                        "contiguous_copy": copy_step}
            ms = {}
            for name, fn in variants.items():
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn()  # lazy state before the capture
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    fn()
                for _ in range(3):
                    graph.replay()
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(args.rounds):
                    graph.replay()
                t1.record()
                torch.cuda.synchronize()
                ms[name] = t0.elapsed_time(t1) / args.rounds
                del graph
            a, c = index_select_step(), advanced_step()
            assert all(torch.equal(x, y) for x, y in zip(a, c))
            del a, c
            first = tuple(x[0] for x in pools[0]) if kind == "int8" else pools[0][0]
            w = page_read(PagedKV(first, table), hist)
            assert (w[0] if kind == "int8" else w).shape == (b, n_kv, hist, hd)
            print(json.dumps({
                "kind": kind, "history": hist, "rows": b, "layers": n_layers,
                "window_bytes_per_step": nbytes, "moved_bytes_per_step": moved,
                "bound_ms_per_step": moved / HBM_BYTES_PER_S * 1e3,
                "ms_per_step": ms,
                "tb_per_s": {k: moved / (v / 1e3) / 1e12 for k, v in ms.items()}}), flush=True)
            del pools, leaves
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
