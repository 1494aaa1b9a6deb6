// Kernel K2q8: one-token decode attention over the int8 KV cache, for sm_90a.
//
// Computes the JAX package's quorum_tpu/ops/attention.py decode_attention_q8
// (XLA there, no Pallas kernel): q [B, H, 1, hd] (bf16 or f32) against
// k8 / v8 [B, KV, T, hd] int8 with per-token scales ks / vs [B, KV, T] f32,
// row b attending positions [lengths[b] - W, lengths[b]) (W = window, or the
// whole prefix without one), GQA by index. Its arithmetic, step for step:
//   - each query head's row is quantized amax/127 (1e-30 floor, round half
//     to even, clip +-127; the scale as amax * fl(1/127), as PyTorch divides
//     by a scalar on the card); logits_t = ((q8 . k8_t) * qs * ks_t) *
//     hd^-0.5, the dot an exact int32 sum;
//   - softmax over the live range in f32;
//   - pv_t = p_t * vs_t (V's scale folded into the probabilities), quantized
//     over t with ONE scale per (row, head), ps = max_t pv_t / 127;
//   - out = (sum_t p8_t * v8_t, exact int32) * ps, in q's dtype.
//
// Bound: bytes — the live int8 K and V rows and their f32 scales,
// sum(live) * KV * (2 * hd + 8), read once for all G query heads of their kv
// head; the integer products are ~1 operation per byte, far below the int8
// tensor cores' rate. The design streams each byte once through TMA and keeps
// everything else on chip, and spreads a long row over up to 16 SMs.
//
// Design — ONE launch per call: a grid (C, KV, B) of thread-block clusters
// of C blocks, one cluster per (row b, kv head); C (8 or 16) is chosen on
// the host from the shapes alone (ops/flash_decode_q8.py q8_cluster_size).
// Block `rank` of a cluster sizes its own chunk of the row's live range from
// lengths[b] (ceil(live / C) rounded up to 128 keys, at least 128; the host
// never reads the lengths; q8_split_plan mirrors the rule). A block is a
// producer warp, which streams the chunk's K tiles (with ks and vs) and then
// its V tiles, 128 keys each, through a 2-stage shared-memory ring by TMA on
// mbarriers (128-byte swizzle; scales by 1-D boxes), and 4 consumer warps,
// each owning 32 keys of every tile:
//   1. q.K^T on the int8 tensor cores: mma.sync m16n8k32 s8 with 16 keys as
//      the rows (A = the K tile as the cache stores it, through ldmatrix) and
//      the G <= 8 query heads as the 8 columns (B = q8, quantized into shared
//      memory by the block). A warp passes the exact int32 dots through a
//      small scratch so that every lane scales a share of the 16 x G logits,
//      ((dot * qs) * ks_t) * hd^-0.5, and keeps an online (max m, sum s =
//      sum exp(l - m), a = max exp(l - m) * vs) for one head. The stage is
//      released before that bookkeeping. The logits and V's scales stay in
//      shared memory (logit_stride(G, 12 KB) keys a block at hd <= 128: 584
//      at G = 4, 328 at G = 8; a chunk longer than that spills the rest to a
//      global scratch the wrapper sizes from T, read back a tile ahead).
//   2. The row's merge inside the cluster: each block publishes (m, s, a)
//      per head in its shared memory; after barrier.cluster one thread per
//      (head, block) reads a partial through distributed shared memory (mapa
//      + ld.shared::cluster, one round trip) and a shuffle tree merges them
//      in a fixed order, so every block holds the same probability scale
//      ps = max(a / s) / 127. The ring meanwhile loads the first V tiles: V
//      does not depend on the scale.
//   3. p.V on the tensor cores: each lane computes p8 = clip(rint(exp(l - m)
//      / s * vs_t / ps)) — the plain version's order of operations — for
//      one key and every head, before the V tile is waited for; the warp
//      reads them back as B fragments (the heads as columns, 32 keys deep).
//      A = V^T, 16 dims x 32 keys: an ldmatrix.trans of 16-bit pairs gives
//      each lane two dims of two keys, and byte permutes (prmt) regroup them
//      into one dim of four keys; the keys of a 32-key step are taken in a
//      fixed permuted order that A and B share. The warps' int32 sums meet
//      in the idle ring and every block adds its [G, hd] sums into rank 0's
//      shared memory with red.shared::cluster.add (exact, in any order).
//   4. After a second cluster barrier (which also keeps every block's
//      shared memory alive until its peers are done with it) rank 0 writes
//      out = sum * ps in q's dtype.
// The cluster barrier is the only wait between blocks: the hardware
// schedules a cluster's blocks together, so the wait cannot deadlock however
// many calls run at once on other streams. A block past its row's live range
// exits at once (barrier.cluster waits only for threads that have not
// exited), freeing its slot for the next cluster. About 55 KB of shared
// memory a block at hd <= 128 lets four blocks share an SM, so 28 clusters of
// 16 run at once. A row with no live key writes zeros. The integer sums are
// exact and order-free; only m, s and a are merged in float, in a fixed
// order: repeated calls are bit for bit equal.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int GMAX = 8;              // query heads per kv head a block holds
constexpr int NW = 4;                // consumer warps, 32 keys of a stage each
constexpr int NT = (NW + 1) * 32;    // + one producer warp
constexpr int TK = NW * 32;          // keys per ring stage
constexpr int MIN_CHUNK = TK;        // keys: the least work a block takes
constexpr int MAX_CLUSTER = 16;      // non-portable cluster size of the H100
constexpr int RING_BYTES = 32 * 1024;  // K / V tiles of the ring (at least 2 stages)
// A K stage's scales come as one TMA box from the 16-byte-aligned element
// at or before its first key (TMA boxes start on 16 bytes): TK + 4 of them,
// in a slot of SC_SLOT floats (a multiple of 128 bytes, as TMA's destination).
constexpr int SC_BOX = TK + 4;
constexpr int SC_SLOT = 160;
constexpr int DOT_STRIDE = 9;        // words per key in a warp's int32 dots (odd: no conflicts)
constexpr int KPL = 4;               // keys of a 16-key tile a lane scales in phase 1, at most
// amax/127 as PyTorch computes it on the card: its CUDA division by a scalar
// multiplies by the f32 reciprocal, so the plain version's quantize_rows
// scales are amax * RCP127 there (a true division can differ by an ulp, and
// an element at a rounding tie then takes another int8 value).
constexpr float RCP127 = 1.0f / 127.0f;

// Shared-memory layout of one block (offsets from a 1024-byte-aligned base,
// as the 128-byte TMA swizzle needs): 55 KB at hd <= 128, so four blocks
// share an SM; 108 KB at hd 256 (two).
template <int HD>
struct Cfg {
  static constexpr int TILE = TK * HD;                   // one K or V tile, bytes
  static constexpr int ST = RING_BYTES / TILE > 2 ? RING_BYTES / TILE : 2;  // ring stages
  static constexpr int PB = HD < 128 ? HD : 128;         // bytes per swizzled panel row
  // The logits (and V's scales beside them) a block keeps on chip.
  static constexpr int LOGIT = HD > 128 ? 28 * 1024 : 12 * 1024;
  static constexpr int OFF_SCALE = ST * TILE;            // [ST][2][SC_SLOT] f32: ks, vs
  static constexpr int OFF_LOGIT = OFF_SCALE + ST * 2 * SC_SLOT * 4;
  static constexpr int OFF_ACC = OFF_LOGIT + LOGIT;      // [GMAX][HD] int32, rank 0's sums
  static constexpr int OFF_Q8 = OFF_ACC + GMAX * HD * 4;   // [GMAX][HD] int8
  // Per-phase scratch: the warps' int32 dots [NW][16][DOT_STRIDE] (phase 1),
  // then the warps' p8 [NW][GMAX][32] (phase 2); the warps' partials
  // [NW][GMAX][3] f32 after them.
  static constexpr int OFF_U = OFF_Q8 + GMAX * HD;
  static constexpr int U_DOTS = NW * 16 * DOT_STRIDE * 4;
  static constexpr int OFF_F = OFF_U + U_DOTS + NW * GMAX * 3 * 4;  // qs, part, row
  static constexpr int SMEM = OFF_F + GMAX * 7 * 4 + 1024;          // + alignment slack
  static constexpr int MIN_BLOCKS = HD > 128 ? 2 : 4;               // per SM
  static_assert(SMEM + 1024 <= 233472 / MIN_BLOCKS, "MIN_BLOCKS blocks must fit an SM");
  static_assert(U_DOTS >= NW * GMAX * 32, "the scratch must hold the warps' p8");
  static_assert(NW * 32 == GMAX * MAX_CLUSTER, "the merge takes one thread per (head, block)");
  static_assert(NW * GMAX * HD * 4 <= ST * TILE, "p.V sums must fit in the ring");
};

// Keys a block keeps on chip per row of its logit store — G rows of
// logits and one of V's scales — and the rows' stride (= 8 mod 32 words,
// so the rows fall on distinct banks).
__host__ __device__ inline int logit_stride(int G, int logit_bytes) {
  return ((logit_bytes / 4 / (G + 1) - 8) / 32) * 32 + 8;
}

// The key range [begin, end) of block r of a row of n live-or-earlier keys,
// and how many of the row's C blocks are active (at least 1: a row with no
// live key still has one block, which writes zeros).
__host__ __device__ inline void split_range(int n, int window, int C, int r, int* begin,
                                            int* end, int* n_act) {
  const int lo = window > 0 ? (n - window > 0 ? n - window : 0) : 0;
  const int live = n - lo;
  int chunk = (live + C - 1) / C;
  chunk = (chunk + MIN_CHUNK - 1) / MIN_CHUNK * MIN_CHUNK;
  chunk = chunk > MIN_CHUNK ? chunk : MIN_CHUNK;
  const int act = (live + chunk - 1) / chunk;
  *n_act = act > 1 ? act : 1;
  *begin = lo + r * chunk;
  *end = *begin + chunk < n ? *begin + chunk : n;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Merge (m2, s2, a2) into (m, s, a): sums and maxima rescaled to the larger
// max; an empty side has m = -inf.
__device__ __forceinline__ void merge(float& m, float& s, float& a, float m2, float s2,
                                      float a2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  const float c1 = expf(m - mm), c2 = expf(m2 - mm);
  s = s * c1 + s2 * c2;
  a = fmaxf(a * c1, a2 * c2);
  m = mm;
}

// --- PTX: cluster, distributed shared memory, tensor cores, TMA ------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// barrier.cluster: arrive releases this thread's earlier writes (shared,
// distributed shared and global) to the cluster; wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// The shared::cluster address of the same shared-memory offset in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void red_add_cluster(uint32_t addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.s32 [%0], %1;\n"
               :: "r"(addr), "r"(v) : "memory");
}
// The consumer warps alone (the producer warp may still be issuing copies).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NW * 32) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// C[16 x 8] += A[16 x 32] . B[32 x 8], int8 in, exact int32 accumulate.
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// 1-D TMA load of `SC_BOX` f32 scales starting at element x (a multiple of
// 4; past the tensor's end the box is zero-filled).
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Byte address of 16-byte chunk c16 (along the head dim) of key row `row` in
// a TMA-loaded tile: panels of TK rows x PB bytes, the chunk index XORed with
// the row as CU_TENSOR_MAP_SWIZZLE_128B (PB = 128) or _64B (PB = 64) lays it
// out, so the 8 rows an ldmatrix reads fall on distinct banks.
template <int HD>
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int c16) {
  constexpr int PB = Cfg<HD>::PB, CPP = PB / 16;
  const int x = PB == 128 ? (row & 7) : ((row >> 1) & 3);
  return tile + (c16 / CPP) * (TK * PB) + row * PB + (((c16 % CPP) ^ x) << 4);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, Cfg<HD>::MIN_BLOCKS) q8_decode_cluster_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap ksmap, const __grid_constant__ CUtensorMap vsmap,
    const T* __restrict__ q, const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ spill, int H, int KV, int Tc, int window, int spill_keys,
    float scale) {
  using CF = Cfg<HD>;
  constexpr int ST = CF::ST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[ST], empty_bar[ST];

  if (threadIdx.x == NW * 32) {  // the producer's lane: fetch the TMA descriptors early
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&ksmap);
    prefetch_map(&vsmap);
  }
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rank = (int)cluster_rank(), C = (int)cluster_size();
  const int G = H / KV;
  const int n = min(max(lengths[b], 0), Tc);
  int c_begin, c_end, n_act;
  split_range(n, window, C, rank, &c_begin, &c_end, &n_act);
  // Idle for this row: nothing to publish, and no peer reads its shared
  // memory. It exits at once (barrier.cluster waits only for the threads
  // that have not exited), so its SM slot goes to the next cluster.
  if (rank >= n_act) return;
  const int nkeys = c_end - c_begin;
  const int nk = (nkeys + TK - 1) / TK;  // K tiles, and as many V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));
  const float* scl = reinterpret_cast<const float*>(sm + CF::OFF_SCALE);
  float* lsm = reinterpret_cast<float*>(sm + CF::OFF_LOGIT);
  int* acc_sh = reinterpret_cast<int*>(sm + CF::OFF_ACC);
  int8_t* q8s = reinterpret_cast<int8_t*>(sm + CF::OFF_Q8);
  float* wpart = reinterpret_cast<float*>(sm + CF::OFF_U + CF::U_DOTS);  // [NW][GMAX][3]
  float* qss = reinterpret_cast<float*>(sm + CF::OFF_F);  // [GMAX]
  float* part = qss + GMAX;         // [GMAX][3] this block's (m, s, a): read by the cluster
  float* row_sm = part + 3 * GMAX;  // [GMAX][3] the row's (m, s, ps)
  const int row0 = (b * KV + kvh) * Tc + c_begin;  // first key's row in [B * KV * T]

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // Producer: one lane keeps the ring full — the chunk's K tiles (with ks
    // and vs), then its V tiles. Rows past the chunk are loaded
    // too (zero-filled past the tensor's end) and masked by the consumers.
    // The producer publishes nothing, so it arrives at the first cluster
    // barrier before it starts: the consumers' merge never waits on it.
    cluster_arrive();
    if (lane == 0) {
      for (int it = 0; it < 2 * nk; ++it) {
        const int s = it % ST;
        mbar_wait(smem_u32(&empty_bar[s]), ((it / ST) & 1) ^ 1);
        const bool kph = it < nk;
        const int row = row0 + (kph ? it : it - nk) * TK;
        const uint32_t fb = smem_u32(&full_bar[s]);
        mbar_expect_tx(fb, CF::TILE + (kph ? 2 * SC_BOX * 4 : 0));
        const uint32_t tile = base + s * CF::TILE;
#pragma unroll
        for (int p = 0; p < HD / CF::PB; ++p)
          tma_load_2d(tile + p * TK * CF::PB, kph ? &kmap : &vmap, fb, p * CF::PB, row);
        if (kph) {
          const uint32_t sc = base + CF::OFF_SCALE + s * 2 * SC_SLOT * 4;
          tma_load_1d(sc, &ksmap, fb, row & ~3);
          tma_load_1d(sc + SC_SLOT * 4, &vsmap, fb, row & ~3);
        }
      }
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  // ---- consumers: warp `warp` takes keys key0 .. key0 + 31 of every tile ----
  const int LS = logit_stride(G, CF::LOGIT);
  float* spill_blk =
      spill_keys ? spill + (size_t)((b * KV + kvh) * C + rank) * (G + 1) * spill_keys : nullptr;
  // Row r (r < G: head r's logits, r = G: V's scales) of chunk key j: on
  // chip below LS, in the spill past it.
  auto store_row = [&](int r, int j, float x) {
    if (j < LS)
      lsm[r * LS + j] = x;
    else
      __stcg(spill_blk + (size_t)r * spill_keys + (j - LS), x);
  };
  auto load_row = [&](int r, int j) {
    return j < LS ? lsm[r * LS + j] : __ldcg(spill_blk + (size_t)r * spill_keys + (j - LS));
  };
  const int key0 = 32 * warp;
  if (rank == 0)
    for (int i = tid; i < G * HD; i += NW * 32) acc_sh[i] = 0;  // peers add after barrier 1
  // Quantize the G query rows (one warp per head); rows past G are zero.
  for (int gq = warp; gq < GMAX; gq += NW) {
    int8_t* dst = q8s + gq * HD;
    if (gq < G) {
      const T* qr = q + ((size_t)b * H + kvh * G + gq) * HD;
      float x[HD / 32];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) {
        x[i] = to_f(qr[lane + 32 * i]);
        amax = fmaxf(amax, fabsf(x[i]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float qs = fmaxf(amax, 1e-30f) * RCP127;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i)
        dst[lane + 32 * i] = (int8_t)fminf(fmaxf(rintf(x[i] / qs), -127.f), 127.f);
      if (lane == 0) qss[gq] = qs;
    } else {
#pragma unroll
      for (int i = 0; i < HD / 32; ++i) dst[lane + 32 * i] = 0;
    }
  }
  consumers_sync();

  // Fragment coordinates: g = groupID (a head of B, rows g and g + 8 of A
  // and C), t = thread in group.
  const int g = lane >> 2, t = lane & 3;
  uint32_t qb[HD / 32][2];  // B = q8: head g, dims kk*32 + 4t (+16)
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk) {
    qb[kk][0] = *reinterpret_cast<const uint32_t*>(q8s + g * HD + kk * 32 + 4 * t);
    qb[kk][1] = *reinterpret_cast<const uint32_t*>(q8s + g * HD + kk * 32 + 16 + 4 * t);
  }
  // The scaling and softmax of a 16-key tile's 16 x G logits: lane (eh,
  // eslot) takes head eh = lane % G and keys eslot, eslot + lph, ... (every
  // lane busy while G divides 16; a few idle otherwise).
  const int lph = 32 / G, eh = lane % G, eslot = lane / G;
  const bool elane = eslot < lph;
  const float qs_e = qss[eh];
  int* dots = reinterpret_cast<int*>(sm + CF::OFF_U) + warp * 16 * DOT_STRIDE;
  float m = -INFINITY, ssum = 0.f, amx = 0.f;

  // Phase 1: S = K . q8^T on the tensor cores, two 16-key tiles a warp. The
  // stage is released once its dots and scales are in registers; the
  // softmax bookkeeping runs while the producer refills it.
  for (int it = 0; it < nk; ++it) {
    const int s = it % ST;
    const int jb = it * TK + key0;  // the warp's key 0 in the chunk
    int dr[2][KPL];
    float ksr[2][KPL], vsr[2][KPL];
    mbar_wait(smem_u32(&full_bar[s]), (it / ST) & 1);
    if (jb < nkeys) {
      const uint32_t tile = base + s * CF::TILE;
      const float* ksh = scl + s * 2 * SC_SLOT + (row0 & 3) + key0;  // the warp's key 0
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        int c[4] = {0, 0, 0, 0};
        const int arow = key0 + 16 * sub + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) {
          uint32_t a[4];
          ldsm_x4(swz<HD>(tile, arow, 2 * kk + (lane >> 4)), a);
          mma_s8(c, a[0], a[1], a[2], a[3], qb[kk][0], qb[kk][1]);
        }
        // c[e]: key g + 8 (e >> 1) of the 16, head 2t + (e & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) dots[(g + 8 * (e >> 1)) * DOT_STRIDE + 2 * t + (e & 1)] = c[e];
        __syncwarp();
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int k = eslot + lph * i;
          if (elane && k < 16) {
            dr[sub][i] = dots[k * DOT_STRIDE + eh];
            ksr[sub][i] = ksh[16 * sub + k];
            vsr[sub][i] = ksh[SC_SLOT + 16 * sub + k];
          }
        }
        __syncwarp();
      }
    }
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
    if (jb < nkeys && elane) {
      float l[2][KPL];
      float mx = m;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int k = eslot + lph * i, j = jb + 16 * sub + k;
          l[sub][i] = -INFINITY;
          if (k < 16 && j < nkeys) {
            l[sub][i] = (((float)dr[sub][i] * qs_e) * ksr[sub][i]) * scale;
            store_row(eh, j, l[sub][i]);
            if (eh == 0) store_row(G, j, vsr[sub][i]);
            mx = fmaxf(mx, l[sub][i]);
          }
        }
      if (mx > -INFINITY) {
        const float c = expf(m - mx);
        ssum *= c;
        amx *= c;
#pragma unroll
        for (int sub = 0; sub < 2; ++sub)
#pragma unroll
          for (int i = 0; i < KPL; ++i) {
            if (l[sub][i] > -INFINITY) {
              const float e = expf(l[sub][i] - mx);
              ssum += e;
              amx = fmaxf(amx, e * vsr[sub][i]);
            }
          }
        m = mx;
      }
    }
  }
  // The block's partial: a tree over the lanes of each head, then the warps.
  for (int d = 1; d < lph; d <<= 1) {
    const float m2 = __shfl_down_sync(0xffffffffu, m, d * G);
    const float s2 = __shfl_down_sync(0xffffffffu, ssum, d * G);
    const float a2 = __shfl_down_sync(0xffffffffu, amx, d * G);
    if (elane && eslot % (2 * d) == 0 && eslot + d < lph) merge(m, ssum, amx, m2, s2, a2);
  }
  if (lane < G) {
    float* w = wpart + (warp * GMAX + lane) * 3;
    w[0] = m;
    w[1] = ssum;
    w[2] = amx;
  }
  consumers_sync();
  if (tid < G) {
    float mm = -INFINITY, ss = 0.f, aa = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* p = wpart + (w * GMAX + tid) * 3;
      merge(mm, ss, aa, p[0], p[1], p[2]);
    }
    part[3 * tid] = mm;
    part[3 * tid + 1] = ss;
    part[3 * tid + 2] = aa;
  }
  cluster_arrive();
  cluster_wait();

  // The row's (m, s) and single probability scale: thread (h, r) reads
  // block r's partial of head h through distributed shared memory (one
  // remote round trip, all in flight at once) and a tree over r merges them
  // — the same order in every block, so all hold the same values.
  {
    const int hr = tid >> 4, rr = tid & 15;
    float mm = -INFINITY, ss = 0.f, aa = 0.f;
    if (hr < G && rr < n_act) {
      const uint32_t p = map_rank(smem_u32(part + 3 * hr), rr);
      mm = ld_cluster(p);
      ss = ld_cluster(p + 4);
      aa = ld_cluster(p + 8);
    }
#pragma unroll
    for (int d = 1; d < MAX_CLUSTER; d <<= 1) {
      const float m2 = __shfl_down_sync(0xffffffffu, mm, d, MAX_CLUSTER);
      const float s2 = __shfl_down_sync(0xffffffffu, ss, d, MAX_CLUSTER);
      const float a2 = __shfl_down_sync(0xffffffffu, aa, d, MAX_CLUSTER);
      if (rr % (2 * d) == 0) merge(mm, ss, aa, m2, s2, a2);
    }
    if (rr == 0 && hr < G) {
      row_sm[3 * hr] = mm;
      row_sm[3 * hr + 1] = ss;
      row_sm[3 * hr + 2] = ss > 0.f ? fmaxf(aa / ss, 1e-30f) * RCP127 : 0.f;
    }
  }
  consumers_sync();

  // Phase 2: O^T[dims, heads] += V^T[dims, 32 keys] . P^T[32 keys, heads].
  // k index 4t + i (i < 4) of either 16-key half is key 2t + (i & 1) +
  // 8 (i >> 1) of that half (kperm); A rows g and g + 8 of dim group mt are
  // dims 16 mt + 2g and 16 mt + 2g + 1. Lane k computes p8 of every head at
  // k index k into the warp's [GMAX][32] bytes, from which each lane reads
  // its B fragment — before it waits for the V tile, which p8 does not need.
  // Its logits and V scale are fetched a tile ahead (spilled ones come from
  // L2), so their latency hides behind the tile before.
  int8_t* p8w = reinterpret_cast<int8_t*>(sm + CF::OFF_U) + warp * GMAX * 32;
  for (int i = G * 32 + lane; i < GMAX * 32; i += 32) p8w[i] = 0;  // heads past G
  const int kperm = (lane & 16) + 2 * ((lane & 15) >> 2) + (lane & 1) + 8 * ((lane >> 1) & 1);
  int acc[HD / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  float lrow[GMAX], vrow;  // this lane's key of the next tile: its G logits and V scale
  auto fetch = [&](int jb) {
    const int j = jb + kperm;
#pragma unroll
    for (int h = 0; h < GMAX; ++h)
      if (h < G) lrow[h] = j < nkeys ? load_row(h, j) : 0.f;
    vrow = j < nkeys ? load_row(G, j) : 0.f;
  };
  fetch(key0);
  for (int it = nk; it < 2 * nk; ++it) {
    const int s = it % ST;
    const int jb = (it - nk) * TK + key0;
    uint32_t pb0 = 0u, pb1 = 0u;
    if (jb < nkeys) {
      const int j = jb + kperm;
#pragma unroll
      for (int h = 0; h < GMAX; ++h) {
        if (h < G) {
          int p8 = 0;
          const float sg = row_sm[3 * h + 1];
          if (j < nkeys && sg > 0.f) {
            const float prob = expf(lrow[h] - row_sm[3 * h]) / sg;
            const float pv = prob * vrow;
            p8 = (int)fminf(fmaxf(rintf(pv / row_sm[3 * h + 2]), -127.f), 127.f);
          }
          p8w[h * 32 + lane] = (int8_t)p8;
        }
      }
      if (jb + TK < nkeys) fetch(jb + TK);
      __syncwarp();
      pb0 = *reinterpret_cast<const uint32_t*>(p8w + g * 32 + 4 * t);
      pb1 = *reinterpret_cast<const uint32_t*>(p8w + g * 32 + 16 + 4 * t);
    }
    mbar_wait(smem_u32(&full_bar[s]), (it / ST) & 1);
    if (jb < nkeys) {
      const uint32_t tile = base + s * CF::TILE;
      const int vrow = key0 + (lane & 7) + (lane >> 3) * 8;
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        uint32_t x[4];  // x[r]: keys 8r + 2t, 8r + 2t + 1 of dims 2g, 2g + 1
        ldsm_x4_t(swz<HD>(tile, vrow, mt), x);
        mma_s8(acc[mt], __byte_perm(x[0], x[1], 0x6420), __byte_perm(x[0], x[1], 0x7531),
               __byte_perm(x[2], x[3], 0x6420), __byte_perm(x[2], x[3], 0x7531), pb0, pb1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
  }

  // The block's int32 sums: the warps' through the (now idle) ring, then
  // added into rank 0's shared memory across the cluster.
  consumers_sync();  // every tile has landed and been read
  int* slots = reinterpret_cast<int*>(sm);  // [NW][GMAX][HD]
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = 2 * t + (e & 1);
      if (h < G) slots[(warp * GMAX + h) * HD + 16 * mt + 2 * g + (e >> 1)] = acc[mt][e];
    }
  }
  consumers_sync();
  const uint32_t acc0 = map_rank(base + CF::OFF_ACC, 0);
  for (int i = tid; i < G * HD; i += NW * 32) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += slots[w * GMAX * HD + i];
    red_add_cluster(acc0 + 4 * i, v);
  }
  cluster_arrive();
  cluster_wait();
  if (rank == 0) {
    T* o = out + ((size_t)b * H + kvh * G) * HD;
    for (int i = tid; i < G * HD; i += NW * 32)
      o[i] = from_f<T>((float)acc_sh[i] * row_sm[3 * (i / HD) + 2]);
  }
}

// 2-D tensor map over the [rows, HD] int8 cache, boxes of TK rows x one
// swizzled panel (128 bytes, or 64 at HD = 64).
inline int make_map_s8(CUtensorMap* map, const void* ptr, uint64_t rows, int HD) {
  const uint32_t pb = HD < 128 ? HD : 128;
  cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)HD};
  cuuint32_t box[2] = {pb, (cuuint32_t)TK};
  cuuint32_t estr[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      pb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1;
}

// 1-D tensor map over the [n] f32 scales, boxes of SC_BOX.
inline int make_map_f32(CUtensorMap* map, const float* ptr, uint64_t n) {
  cuuint64_t dims[1] = {(cuuint64_t)n};
  cuuint64_t strides[1] = {4};  // rank 1: not read
  cuuint32_t box[1] = {(cuuint32_t)SC_BOX};
  cuuint32_t estr[1] = {1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides, box,
      estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1;
}

// The kernel's attributes (dynamic shared memory above 48 KB, clusters above
// the portable 8) and a launch configuration of clusters of C blocks.
template <typename T, int HD>
cudaError_t configure(int C, int B, int KV, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  auto kern = q8_decode_cluster_kernel<T, HD>;
  constexpr int smem = Cfg<HD>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C, KV, B);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k8, const float* ks, const void* v8,
                   const float* vs, const int* lengths, void* out, float* spill, int B, int H,
                   int KV, int Tc, int window, int C, int spill_keys, float scale,
                   cudaStream_t stream) {
  int begin, end, n_act;
  split_range(Tc, 0, C, 0, &begin, &end, &n_act);  // the longest chunk: every key live
  const int need = end - begin - logit_stride(H / KV, Cfg<HD>::LOGIT);
  if (need > spill_keys || (need > 0 && spill == nullptr)) return cudaErrorInvalidValue;
  const uint64_t rows = (uint64_t)B * KV * Tc;
  CUtensorMap km, vm, ksm, vsm;
  if (make_map_s8(&km, k8, rows, HD) || make_map_s8(&vm, v8, rows, HD) ||
      make_map_f32(&ksm, ks, rows) || make_map_f32(&vsm, vs, rows))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T, HD>(C, B, KV, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, q8_decode_cluster_kernel<T, HD>, km, vm, ksm, vsm,
                           static_cast<const T*>(q), lengths, static_cast<T*>(out), spill, H,
                           KV, Tc, window, spill_keys, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t occupancy(int C, int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<T, HD>(C, 1, 1, 0, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(max_clusters, q8_decode_cluster_kernel<T, HD>, &cfg);
}

template <typename T>
cudaError_t by_head_dim(int HD, const void* q, const void* k8, const float* ks, const void* v8,
                        const float* vs, const int* lengths, void* out, float* spill, int B,
                        int H, int KV, int Tc, int window, int C, int spill_keys, float scale,
                        cudaStream_t stream) {
  switch (HD) {
    case 64:
      return launch<T, 64>(q, k8, ks, v8, vs, lengths, out, spill, B, H, KV, Tc, window, C,
                           spill_keys, scale, stream);
    case 128:
      return launch<T, 128>(q, k8, ks, v8, vs, lengths, out, spill, B, H, KV, Tc, window, C,
                            spill_keys, scale, stream);
    case 256:
      return launch<T, 256>(q, k8, ks, v8, vs, lengths, out, spill, B, H, KV, Tc, window, C,
                            spill_keys, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). cluster: C blocks per (row,
// kv head), 1..16. spill: [B, KV, C, G + 1, spill_keys] f32, the logits (and
// V's scales) of a block past logit_stride keys; spill_keys must cover the longest chunk
// the cache allows (null when it needs none). Returns the cudaError_t of the
// launch (a refused launch, for a cluster the card cannot hold, included).
extern "C" int qt_flash_decode_q8(const void* q, const void* k8, const float* ks, const void* v8,
                                  const float* vs, const int* lengths, void* out, float* spill,
                                  int B, int H, int KV, int Tc, int HD, int window, int cluster,
                                  int spill_keys, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Tc <= 0 || H % KV != 0 || H / KV > GMAX || window < 0 ||
      cluster < 1 || cluster > MAX_CLUSTER || spill_keys < 0 ||
      (uint64_t)B * KV * Tc >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_head_dim<float>(HD, q, k8, ks, v8, vs, lengths, out, spill, B, H, KV, Tc,
                                   window, cluster, spill_keys, scale, st);
  if (dtype == 1)
    return (int)by_head_dim<__nv_bfloat16>(HD, q, k8, ks, v8, vs, lengths, out, spill, B, H, KV,
                                           Tc, window, cluster, spill_keys, scale, st);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` blocks the card holds at once, and the
// dynamic shared memory of a block (cudaOccupancyMaxActiveClusters).
extern "C" int qt_flash_decode_q8_occupancy(int HD, int dtype, int cluster, int* max_clusters,
                                            int* smem_bytes) {
  if (cluster < 1 || cluster > MAX_CLUSTER || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (HD) {
    case 64:
      *smem_bytes = Cfg<64>::SMEM;
      err = dtype ? occupancy<__nv_bfloat16, 64>(cluster, max_clusters)
                  : occupancy<float, 64>(cluster, max_clusters);
      break;
    case 128:
      *smem_bytes = Cfg<128>::SMEM;
      err = dtype ? occupancy<__nv_bfloat16, 128>(cluster, max_clusters)
                  : occupancy<float, 128>(cluster, max_clusters);
      break;
    case 256:
      *smem_bytes = Cfg<256>::SMEM;
      err = dtype ? occupancy<__nv_bfloat16, 256>(cluster, max_clusters)
                  : occupancy<float, 256>(cluster, max_clusters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
