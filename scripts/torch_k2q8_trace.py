#!/usr/bin/env python3
"""Where K2q8's time goes inside one launch, block by block, on the card.

    python3 scripts/torch_k2q8_trace.py

Copies ``quorum_tpu_torch`` into ``build/k2q8_trace/`` (git-ignored), adds
``%globaltimer`` trace points to the copy of ``csrc/flash_decode_q8.cu``
(thread 0 of each block: its start, the mbarrier init, each phase's end and
each cluster barrier; inside the first tile of each phase), builds it, runs
one traced call after three warm-up calls, and prints one JSON line per
case with the median and largest time of every segment over the active
blocks (µs), when blocks started, how many ran at once and on how many SMs:

  main   4 slots, T=8192, lengths 1/100/4096/8191 (the kernels line)
  all1   4 slots, T=8192, every length 1: one tile a cluster, the fixed cost
  long   4 slots, T=32768, all live

llama-3-8b widths (H=32, K=8, hd=128), bf16 q, the cluster size the wrapper
chooses. The trace points are inserted by matching the kernel's source
text; the script stops if an anchor is missing. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DST = os.path.join(ROOT, "build", "k2q8_trace")
SLOTS = 16  # trace words per block

DEFS = """
__device__ unsigned long long g_trace[1 << 14][16];
#define BLIN (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define TR(k) if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_trace[BLIN][k] = t_; }
"""
P1_WAIT = ("    mbar_wait(smem_u32(&full_bar[s]), (it / ST) & 1);\n    if (jb < nkeys) {\n"
           "      const uint32_t tile = base + s * CF::TILE;\n      const float* ksh")
P2_WAIT = ("    mbar_wait(smem_u32(&full_bar[s]), (it / ST) & 1);\n    if (jb < nkeys) {\n"
           "      const uint32_t tile = base + s * CF::TILE;\n      const int vrow")
P2_END = ("               __byte_perm(x[2], x[3], 0x6420), __byte_perm(x[2], x[3], 0x7531), "
          "pb0, pb1);\n      }\n    }\n    __syncwarp();\n")
OUT_END = "      o[i] = from_f<T>((float)acc_sh[i] * row_sm[3 * (i / HD) + 2]);\n  }\n"
WAIT2 = "  cluster_arrive();\n  cluster_wait();\n  if (rank == 0) {"
# (anchor in the kernel source, its replacement): trace point k is TR(k);
# 10 and 11 hold the block's SM and active-block count.
EDITS = (
    ("namespace {\n", "namespace {\n" + DEFS),
    ("  split_range(n, window, C, rank, &c_begin, &c_end, &n_act);\n",
     "  split_range(n, window, C, rank, &c_begin, &c_end, &n_act);\n  TR(0);\n"
     "  if (threadIdx.x == 0) { unsigned sm_;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_));\n"
     "    g_trace[BLIN][10] = sm_; g_trace[BLIN][11] = n_act; }\n"),
    ("  if (rank >= n_act) return;", "  if (rank >= n_act) { TR(7); return; }"),
    ("  __syncthreads();\n\n  if (warp == NW) {",
     "  __syncthreads();\n  TR(1);\n\n  if (warp == NW) {"),
    (P1_WAIT, P1_WAIT.replace("    if (jb", "    if (it == 0) TR(14);\n    if (jb")),
    ("        m = mx;\n      }\n    }\n",
     "        m = mx;\n      }\n    }\n    if (it == 0) TR(15);\n"),
    ("  // The block's partial: a tree over", "  TR(2);\n  // The block's partial: a tree over"),
    ("  cluster_arrive();\n  cluster_wait();\n\n",
     "  cluster_arrive();\n  cluster_wait();\n  TR(3);\n\n"),
    ("  // Phase 2: O^T[dims, heads]", "  TR(4);\n  // Phase 2: O^T[dims, heads]"),
    ("  fetch(key0);\n", "  fetch(key0);\n  TR(8);\n"),
    ("      if (jb + TK < nkeys) fetch(jb + TK);\n      __syncwarp();\n",
     "      if (jb + TK < nkeys) fetch(jb + TK);\n      __syncwarp();\n"
     "      if (it == nk) TR(9);\n"),
    (P2_WAIT, P2_WAIT.replace("    if (jb", "    if (it == nk) TR(12);\n    if (jb")),
    (P2_END, P2_END + "    if (it == nk) TR(13);\n"),
    ("  // The block's int32 sums", "  TR(5);\n  // The block's int32 sums"),
    (WAIT2, WAIT2.replace("  if (rank == 0) {", "  TR(6);\n  if (rank == 0) {")),
    (OUT_END, OUT_END + "  TR(7);\n"),
)


def _patch(src: str) -> str:
    for anchor, text in EDITS:
        if anchor not in src:
            raise SystemExit(f"torch_k2q8_trace: anchor not found in the kernel: {anchor!r}")
        src = src.replace(anchor, text, 1)
    return src + """
extern "C" int qt_trace_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, bytes);
}
extern "C" int qt_trace_clear() {
  static unsigned long long z[1 << 14][16];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
"""


# (name, first trace point, last trace point)
SEGMENTS = (("init", 0, 1), ("phase1", 1, 2), ("p1_first_wait", 1, 14),
            ("p1_first_tile", 14, 15), ("barrier1", 2, 3), ("merge", 3, 4), ("phase2", 4, 5),
            ("p2_prologue", 4, 8),
            ("p2_first_p8", 8, 9), ("p2_first_wait", 9, 12), ("p2_first_mma", 12, 13),
            ("barrier2", 5, 6), ("out", 6, 7), ("whole", 0, 7))


def _summary(rows: list) -> dict:
    t0 = min(r[0] for r in rows)
    active = [r for r in rows if r[1]]
    res = {"span_us": (max(r[7] for r in rows) - t0) / 1e3, "blocks": len(rows),
           "active_blocks": len(active), "sms": len({r[10] for r in rows})}
    starts = sorted((r[0] - t0) / 1e3 for r in rows)
    res["start_us_quantiles"] = [round(starts[int(q * (len(starts) - 1))], 2)
                                 for q in (0, .25, .5, .75, 1)]
    events = sorted([(r[0], 1) for r in rows] + [(r[7], -1) for r in rows])
    cur = most = 0
    for _, d in events:
        cur += d
        most = max(most, cur)
    res["max_blocks_at_once"] = most
    for name, i, j in SEGMENTS:
        v = [(r[j] - r[i]) / 1e3 for r in active if r[i] and r[j]]
        if v:
            res[name + "_us"] = [round(statistics.median(v), 2), round(max(v), 2)]
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k2q8_trace: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(DST, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "quorum_tpu_torch"),
                    os.path.join(DST, "quorum_tpu_torch"))
    cu = os.path.join(DST, "quorum_tpu_torch", "csrc", "flash_decode_q8.cu")
    with open(cu) as f:
        src = f.read()
    with open(cu, "w") as f:
        f.write(_patch(src))
    sys.path.insert(0, DST)
    from quorum_tpu_torch.ops import flash_decode_q8 as fq
    from quorum_tpu_torch.ops.attention import quantize_rows

    lib = fq._lib()
    h, kv, hd = 32, 8, 128
    torch.manual_seed(0)
    for name, t, lens in (("main", 8192, [1, 100, 4096, 8191]), ("all1", 8192, [1] * 4),
                          ("long", 32768, [32768] * 4)):
        def side():
            x8, xs = quantize_rows(torch.randn((4, kv, t, hd), device="cuda"), -1)
            return x8, xs[..., 0].contiguous()

        args = (torch.randn((4, h, 1, hd), device="cuda").to(torch.bfloat16), *side(), *side(),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        for _ in range(3):
            fq.flash_decode_q8_attention(*args)
        torch.cuda.synchronize()
        fq.cuda_build.check(lib.qt_trace_clear(), "trace clear")
        fq.flash_decode_q8_attention(*args)
        torch.cuda.synchronize()
        cluster = fq.q8_cluster_size(4, kv, t)
        n_blocks = cluster * kv * 4
        buf = (ctypes.c_ulonglong * (n_blocks * SLOTS))()
        fq.cuda_build.check(lib.qt_trace_read(buf, n_blocks * SLOTS * 8), "trace read")
        rows = [list(buf[i * SLOTS:(i + 1) * SLOTS]) for i in range(n_blocks)]
        print(json.dumps({"case": name, "T": t, "lengths": lens, "cluster": cluster,
                          **_summary(rows)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0] if smi else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
