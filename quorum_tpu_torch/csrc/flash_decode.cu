// Kernel K2: one-token decode attention over the slot KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel quorum_tpu/ops/flash_decode.py:
// _decode_kernel (launched by _decode_call). Same function: row b's query
// heads attend cache positions [lengths[b] - W, lengths[b]) (W = window, or
// the whole prefix [0, lengths[b]) without one), GQA by index, softmax in
// f32 with scale hd^-0.5.
//
// Bound: bytes — the live K and V rows, sum(live) * KV * hd * 2 * sizeof(T),
// read once for all G query heads of their kv head, at a few FLOPs per byte.
//
// Design — one launch per call, two routes chosen by dtype:
//   - a fixed grid (B, KV, n_splits), n_splits chosen on the host from the
//     shapes alone. Each block sizes its own chunk of its row's live range
//     from lengths[b] (ceil(live / n_splits) rounded up to 64 keys, at least
//     64), so a long row spreads over all its blocks, a short row uses one,
//     and the host never reads the lengths (that would cost a sync).
//     ops/flash_decode.py decode_split_plan mirrors this for the CPU tests;
//   - each (b, kv head) cache run [T, hd] is contiguous; a producer warp
//     streams the block's chunk through a shared-memory ring with
//     asynchronous copies (mbarrier completion) while 4 compute warps work;
//   - mma route (bf16): the ring holds 64-key K/V tiles loaded by TMA with
//     128-byte swizzle. Each compute warp takes 16 keys of a tile and runs
//     S = Q.K^T and O += P.V as mma.sync m16n8k16 on the tensor cores: the G
//     query heads are rows of a 16-row tile, K and V come through ldmatrix
//     (conflict-free on the swizzled rows), P goes from the S accumulators
//     to the A fragment in registers. The few instructions per key keep the
//     warps ahead of the copies;
//   - fma route (f32 — mma on f32 inputs would be TF32 and miss the f32
//     tolerance): 1-D bulk copies (cp.async.bulk) of 8 KB K/V stages; a group
//     of lanes covers one key with 16-byte vectors, every K vector read feeds
//     the dot products of all G query heads, reduced within the lane group
//     by shuffles; online softmax per lane group in registers;
//   - the block merges its warps or lane groups through shared memory. A row
//     whose live range fits in one block writes the output directly;
//     otherwise the block writes a partial (m, l, acc) and takes a ticket
//     (atomicAdd on a per-(b, kv head) counter after __threadfence); the last
//     block of the row merges the partials, writes the output and resets the
//     counter to 0, so no memset launch is needed. The wrapper caches the
//     counters and the partial scratch per device and shape.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int GMAX = 8;            // query heads per kv head a block can hold
constexpr int NW = 4;              // compute warps
constexpr int NT = (NW + 1) * 32;  // + one producer warp
constexpr int MIN_CHUNK = 64;      // keys: the least work a block takes
constexpr int MAX_SPLITS = 32;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 1-D bulk copy global -> shared; bytes and both addresses multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// The key range [begin, end) block `sp` of row b covers, and how many blocks
// of the row are active (at least 1: a row with no live key still has one
// block, which writes zeros).
__device__ __forceinline__ void split_range(int n, int window, int n_splits, int sp,
                                            int* begin, int* end, int* n_act) {
  const int lo = window > 0 ? max(n - window, 0) : 0;
  const int live = n - lo;
  int chunk = (live + n_splits - 1) / n_splits;
  chunk = max(MIN_CHUNK, (chunk + MIN_CHUNK - 1) / MIN_CHUNK * MIN_CHUNK);
  *n_act = max(1, (live + chunk - 1) / chunk);
  *begin = lo + sp * chunk;
  *end = min(*begin + chunk, n);
}

// The end of every block, once the block's n_grp groups (warps or lane
// groups) have written their partial (m, l, acc) for each query head to
// shared memory — red_o [n_grp][gs][HD], red_m / red_l [n_grp][gs]: merge
// them; a row that one block covers writes its output, otherwise the block
// writes its partial and the last block of the row (by ticket) merges all.
template <typename T, int HD>
__device__ __forceinline__ void finish_block(const float* red_o, const float* red_m,
                                             const float* red_l, int n_grp, int gs, int G,
                                             int H, int KV, int b, int kvh, int sp,
                                             int n_splits, int n_act, T* out, float* part_ml,
                                             float* part_acc, int* tickets) {
  __shared__ int last_block;
  __shared__ float w_sh[GMAX][MAX_SPLITS], l_sh[GMAX][MAX_SPLITS];
  const int tid = threadIdx.x;
  const size_t head0 = (size_t)b * H + kvh * G;  // first query head of this kv head
  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    float mx = -INFINITY;
    for (int r = 0; r < n_grp; ++r) mx = fmaxf(mx, red_m[r * gs + g]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float ls = 0.f, acc = 0.f;
    for (int r = 0; r < n_grp; ++r) {
      const float w = exp2f(red_m[r * gs + g] - mu);
      ls += w * red_l[r * gs + g];
      acc += w * red_o[(r * gs + g) * HD + d];
    }
    if (n_act == 1) {
      out[(head0 + g) * HD + d] = from_f<T>(ls > 0.f ? acc / ls : 0.f);
    } else {
      const size_t prow = (head0 + g) * n_splits + sp;
      part_acc[prow * HD + d] = acc;
      if (d == 0) {
        part_ml[2 * prow] = mx;
        part_ml[2 * prow + 1] = ls;
      }
    }
  }
  if (n_act == 1) return;

  // Ticket: the last block of this (row, kv head) to finish merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[b * KV + kvh], 1);
    last_block = ticket == n_act - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // Every (m, l) in one parallel read, the weights once per (head, split),
  // then the accumulators as float4 with 8 splits' loads in flight: the merge
  // costs a few L2 round trips, not one per split.
  for (int i = tid; i < G * n_act; i += NT) {
    const int g = i / n_act, r = i % n_act;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) +
                             (head0 + g) * n_splits + r);
    w_sh[g][r] = ml.x;
    l_sh[g][r] = ml.y;
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int r = 0; r < n_act; ++r) mx = fmaxf(mx, w_sh[tid][r]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float ls = 0.f;
    for (int r = 0; r < n_act; ++r) {
      w_sh[tid][r] = exp2f(w_sh[tid][r] - mu);
      ls += w_sh[tid][r] * l_sh[tid][r];
    }
    const float inv = ls > 0.f ? 1.f / ls : 0.f;
    for (int r = 0; r < n_act; ++r) w_sh[tid][r] *= inv;
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD / 4; idx += NT) {
    const int g = idx / (HD / 4), d4 = idx % (HD / 4);
    const float4* src = reinterpret_cast<const float4*>(part_acc) +
                        (head0 + g) * n_splits * (HD / 4) + d4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < n_act; ++r) {
      const float4 a = __ldcg(src + (size_t)r * (HD / 4));
      const float w = w_sh[g][r];
      acc.x = fmaf(w, a.x, acc.x);
      acc.y = fmaf(w, a.y, acc.y);
      acc.z = fmaf(w, a.z, acc.z);
      acc.w = fmaf(w, a.w, acc.w);
    }
    T* dst = out + (head0 + g) * HD + 4 * d4;
    dst[0] = from_f<T>(acc.x);
    dst[1] = from_f<T>(acc.y);
    dst[2] = from_f<T>(acc.z);
    dst[3] = from_f<T>(acc.w);
  }
  if (tid == 0) tickets[b * KV + kvh] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// mma route (bf16)
// ---------------------------------------------------------------------------
namespace mma_route {

constexpr int TK = NW * 16;  // keys per ring stage: 16 per compute warp
constexpr int PANEL = 64;    // bf16 columns per 128-byte swizzled panel

template <int HD>
struct Ring {
  static constexpr int TILE = TK * HD * 2;                 // one K (or V) stage, bytes
  static constexpr int ST = 65536 / (2 * TILE) > 2 ? 65536 / (2 * TILE) : 2;  // stages
  static constexpr int RING = ST * 2 * TILE;
  static constexpr int MERGE = NW * GMAX * (HD + 2) * 4;
  static constexpr int SMEM = (RING > MERGE ? RING : MERGE) + 1024;  // + alignment slack
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// C[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 accumulate. A rows 8..15
// (a1, a3) are always zero here: at most 8 query heads.
__device__ __forceinline__ void mma(float* c, uint32_t a0, uint32_t a2, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// Byte address of 16-byte chunk c16 (along the head dim) of row `row` in a
// TMA-loaded tile of TK rows: 64-column panels of TK x 128 B, the chunk index
// XOR-swizzled by row % 8 (CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int c16) {
  return tile + (c16 >> 3) * (TK * 128) + row * 128 + (((c16 & 7) ^ (row & 7)) << 4);
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_decode_mma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ tickets, int H, int KV, int Tc, int window, float scale) {
  using R = Ring<HD>;
  constexpr int ST = R::ST, TILE = R::TILE;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[ST], empty_bar[ST];

  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z, n_splits = gridDim.z;
  const int G = H / KV;
  int n = lengths[b];
  n = n < 0 ? 0 : (n > Tc ? Tc : n);
  int c_begin, c_end, n_act;
  split_range(n, window, n_splits, sp, &c_begin, &c_end, &n_act);
  if (sp >= n_act) return;
  const int nkeys = max(0, c_end - c_begin);
  const int n_stages = (nkeys + TK - 1) / TK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // TMA swizzle atoms
  float* red_o = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This thread's query head (row g of the mma tiles) and its column pair.
  const int g = lane >> 2, cq = (lane & 3) * 2;
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m = -INFINITY, l = 0.f;

  if (warp == NW) {
    // Producer warp: one lane keeps the ring full. A tile's rows past the
    // block's chunk are loaded too (or zero-filled past the tensor's end);
    // the compute warps mask them.
    if (lane == 0) {
      const int row0 = (b * KV + kvh) * Tc + c_begin;
      for (int it = 0; it < n_stages; ++it) {
        const int s = it % ST;
        mbar_wait(smem_u32(&empty_bar[s]), ((it / ST) & 1) ^ 1);
        const uint32_t fb = smem_u32(&full_bar[s]);
        mbar_expect_tx(fb, 2 * TILE);
#pragma unroll
        for (int p = 0; p < HD / PANEL; ++p) {
          tma_load_2d(ring + s * 2 * TILE + p * TK * 128, &kmap, fb, p * PANEL, row0 + it * TK);
          tma_load_2d(ring + s * 2 * TILE + TILE + p * TK * 128, &vmap, fb, p * PANEL,
                      row0 + it * TK);
        }
      }
    }
  } else {
    // A fragments of Q, rows 0..7 (query heads kvh*G + g; zero past G):
    // qa[kk] = columns kk*16 + cq (+1) and kk*16 + 8 + cq (+1).
    uint32_t qa[HD / 16][2];
    const __nv_bfloat16* qg = q + (size_t)(b * H + kvh * G + (g < G ? g : 0)) * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qg + kk * 16 + cq) : 0u;
      qa[kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(qg + kk * 16 + 8 + cq) : 0u;
    }
    const float sl2 = scale * LOG2E;
    // ldmatrix row addresses: for K, matrices (keys 0-7 | 8-15) x (chunk 0 | 1)
    // give the B fragments of two 8-key tiles; for V (transposed), matrices
    // (keys 0-7 | 8-15) x (chunk 0 | 1) give those of two 8-column tiles.
    const int krow = warp * 16 + (lane & 7) + ((lane >> 4) << 3), kchk = (lane >> 3) & 1;
    const int vrow = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3), vchk = lane >> 4;

    for (int it = 0; it < n_stages; ++it) {
      const int s = it % ST;
      mbar_wait(smem_u32(&full_bar[s]), (it / ST) & 1);
      const int keys = min(TK, nkeys - it * TK);
      const uint32_t ks = ring + s * 2 * TILE, vs = ks + TILE;

      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(swz(ks, krow, 2 * kk + kchk), kb);
        mma(sc[0], qa[kk][0], qa[kk][1], kb[0], kb[1]);
        mma(sc[1], qa[kk][0], qa[kk][1], kb[2], kb[3]);
      }
      // Online softmax of row g over this warp's 16 keys (the quad's four
      // lanes share the row): keys past the stage's end get -inf.
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = warp * 16 + nt * 8 + cq + e < keys;
          sc[nt][e] = live ? sc[nt][e] * sl2 : -INFINITY;
          mx = fmaxf(mx, sc[nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m - mu);
      m = m_new;
      float p[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) p[nt][e] = exp2f(sc[nt][e] - mu);
      l = l * corr + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
      const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        o[nt][0] *= corr;
        o[nt][1] *= corr;
      }
      // The chunk's last tile may end inside this warp's 16 keys: the V rows
      // past it hold whatever lies beyond the chunk (weight 0, but 0 x NaN is
      // NaN), so the warp zeroes them in shared memory first.
      const bool dead_rows = keys < warp * 16 + 16;
      if (dead_rows) {
        const int first = max(keys - warp * 16, 0);
        for (int i = lane; i < (16 - first) * (HD / 8); i += 32)
          *reinterpret_cast<uint4*>(smem_raw + (swz(vs, warp * 16 + first + i / (HD / 8),
                                                    i % (HD / 8)) - smem_u32(smem_raw))) =
              make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();
      }
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t vb[4];
        ldsm_x4_t(swz(vs, vrow, 2 * dn + vchk), vb);
        mma(o[2 * dn], pa0, pa2, vb[0], vb[1]);
        mma(o[2 * dn + 1], pa0, pa2, vb[2], vb[3]);
      }
      // Order the zeroing stores before the next TMA write to this stage.
      if (dead_rows) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
  }
  __syncthreads();  // every tile has landed and been read: the ring is free

  // Merge the warps: red_o [NW][GMAX][HD], red_m / red_l [NW][GMAX].
  float* red_m = red_o + NW * GMAX * HD;
  float* red_l = red_m + NW * GMAX;
  if (warp < NW && g < G) {
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      red_o[(warp * GMAX + g) * HD + nt * 8 + cq] = o[nt][0];
      red_o[(warp * GMAX + g) * HD + nt * 8 + cq + 1] = o[nt][1];
    }
    if ((lane & 3) == 0) {
      red_m[warp * GMAX + g] = m;
      red_l[warp * GMAX + g] = l;
    }
  }
  __syncthreads();
  finish_block<__nv_bfloat16, HD>(red_o, red_m, red_l, NW, GMAX, G, H, KV, b, kvh, sp,
                                  n_splits, n_act, out, part_ml, part_acc, tickets);
}

template <int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* lengths,
                   void* out, float* part_ml, float* part_acc, int* tickets, int B, int H,
                   int KV, int Tc, int window, int n_splits, float scale, cudaStream_t stream) {
  CUtensorMap km, vm;
  if (make_map(&km, kc, (uint64_t)B * KV * Tc, HD, TK) ||
      make_map(&vm, vc, (uint64_t)B * KV * Tc, HD, TK))
    return cudaErrorInvalidValue;
  constexpr int smem = Ring<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KV, n_splits);
  flash_decode_mma_kernel<HD><<<grid, NT, smem, stream>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), lengths, static_cast<__nv_bfloat16*>(out),
      part_ml, part_acc, tickets, H, KV, Tc, window, scale);
  return cudaGetLastError();
}

}  // namespace mma_route

// ---------------------------------------------------------------------------
// fma route (f32)
// ---------------------------------------------------------------------------
namespace fma_route {

constexpr int ST = 4;              // ring stages
constexpr int STAGE_BYTES = 8192;  // K (and V) bytes per stage

template <int HD>
struct Cfg {
  static constexpr int VEC = 4;                                      // floats per 16 B
  static constexpr int LPK = HD / VEC < 32 ? HD / VEC : 32;          // lanes per key
  static constexpr int NV = HD / (VEC * LPK);                        // vectors per lane
  static constexpr int E = NV * VEC;                                 // elements per lane
  static constexpr int KPW = 32 / LPK;                               // keys per warp
  static constexpr int NG = NW * KPW;                                // lane groups per block
  static constexpr int TK = STAGE_BYTES / (HD * 4);                  // keys per stage
  static constexpr int JN = TK / NG;                                 // keys per group per stage
  static_assert(JN >= 1 && TK % NG == 0, "stage must split evenly over lane groups");
};

// One 16-byte vector of shared memory into four registers.
__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

// Dynamic shared memory: the ring, reused after the last stage for the
// lane groups' partials (red_o [NG][GP][HD], red_m / red_l [NG][GP]).
template <int HD, int GP>
constexpr int smem_bytes() {
  constexpr int ring = ST * 2 * STAGE_BYTES;
  constexpr int merge = Cfg<HD>::NG * GP * (HD + 2) * 4;
  return ring > merge ? ring : merge;
}

template <int HD, int GP>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ kc, const float* __restrict__ vc,
    const int* __restrict__ lengths, float* __restrict__ out, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int* __restrict__ tickets, int H, int KV, int Tc,
    int window, float scale) {
  using C = Cfg<HD>;
  constexpr int E = C::E, VEC = C::VEC, LPK = C::LPK, TK = C::TK, JN = C::JN, NG = C::NG;
  extern __shared__ __align__(128) unsigned char ring[];  // smem_bytes<HD, GP>()
  __shared__ __align__(8) uint64_t full_bar[ST], empty_bar[ST];

  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z, n_splits = gridDim.z;
  const int G = H / KV;
  int n = lengths[b];
  n = n < 0 ? 0 : (n > Tc ? Tc : n);
  int c_begin, c_end, n_act;
  split_range(n, window, n_splits, sp, &c_begin, &c_end, &n_act);
  if (sp >= n_act) return;
  const int nkeys = max(0, c_end - c_begin);
  const int n_stages = (nkeys + TK - 1) / TK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t ring_s = smem_u32(ring);
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int grp = warp * C::KPW + lane / LPK;  // lane group (compute warps only)
  const int gl = lane % LPK;                    // lane within the group
  float m[GP], l[GP], o[GP][E];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[g][e] = 0.f;
  }

  if (warp == NW) {
    // Producer warp: one lane keeps the ring full.
    if (lane == 0) {
      const size_t row0 = ((size_t)(b * KV + kvh) * Tc + c_begin) * HD;
      for (int it = 0; it < n_stages; ++it) {
        const int s = it % ST;
        mbar_wait(smem_u32(&empty_bar[s]), ((it / ST) & 1) ^ 1);
        const uint32_t bytes = min(TK, nkeys - it * TK) * HD * 4u;
        const uint32_t fb = smem_u32(&full_bar[s]);
        mbar_expect_tx(fb, 2 * bytes);
        const size_t off = row0 + (size_t)it * TK * HD;
        bulk_load(ring_s + s * 2 * STAGE_BYTES, kc + off, bytes, fb);
        bulk_load(ring_s + s * 2 * STAGE_BYTES + STAGE_BYTES, vc + off, bytes, fb);
      }
    }
  } else {
    // This lane's slice of every query head of the group, pre-scaled into
    // log2 units: vectors gl + LPK * v, v < NV, of the head dim.
    float qr[GP][E];
    const float qs = scale * LOG2E;
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int v = 0; v < C::NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[g][v * VEC + e] =
              g < G ? q[(size_t)(b * H + kvh * G + g) * HD + (gl + LPK * v) * VEC + e] * qs : 0.f;

    for (int it = 0; it < n_stages; ++it) {
      const int s = it % ST;
      mbar_wait(smem_u32(&full_bar[s]), (it / ST) & 1);
      const int keys = min(TK, nkeys - it * TK);
      const float* ks = reinterpret_cast<const float*>(ring + s * 2 * STAGE_BYTES);
      const float* vs = reinterpret_cast<const float*>(ring + s * 2 * STAGE_BYTES + STAGE_BYTES);

      // Branch-free over the stage: a key past the stage's end reads key 0
      // (always loaded), gets score -inf and weight 0.
      float sc[JN][GP];
      int kidx[JN];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        kidx[j] = grp + NG * j < keys ? grp + NG * j : 0;
        float kf[E];
#pragma unroll
        for (int v = 0; v < C::NV; ++v)
          load4(ks + kidx[j] * HD + (gl + LPK * v) * VEC, kf + v * VEC);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
          sc[j][g] = dot;
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < JN; ++j)
#pragma unroll
          for (int g = 0; g < GP; ++g)
            sc[j][g] += __shfl_xor_sync(0xffffffffu, sc[j][g], off);

#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          if (grp + NG * j >= keys) sc[j][g] = -INFINITY;
          mx = fmaxf(mx, sc[j][g]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[g] - mu);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          sc[j][g] = exp2f(sc[j][g] - mu);
          psum += sc[j][g];
        }
        l[g] = l[g] * corr + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) o[g][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float vf[E];
#pragma unroll
        for (int v = 0; v < C::NV; ++v)
          load4(vs + kidx[j] * HD + (gl + LPK * v) * VEC, vf + v * VEC);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) o[g][e] = fmaf(sc[j][g], vf[e], o[g][e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
    }
  }
  __syncthreads();  // every copy has landed and been read: the ring is free

  // Merge the lane groups: red_o [NG][GP][HD], red_m / red_l [NG][GP].
  float* red_o = reinterpret_cast<float*>(ring);
  float* red_m = red_o + NG * GP * HD;
  float* red_l = red_m + NG * GP;
  if (warp < NW) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
#pragma unroll
      for (int v = 0; v < C::NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red_o[(grp * GP + g) * HD + (gl + LPK * v) * VEC + e] = o[g][v * VEC + e];
      if (gl == 0) {
        red_m[grp * GP + g] = m[g];
        red_l[grp * GP + g] = l[g];
      }
    }
  }
  __syncthreads();
  finish_block<float, HD>(red_o, red_m, red_l, NG, GP, G, H, KV, b, kvh, sp, n_splits, n_act,
                          out, part_ml, part_acc, tickets);
}

template <int HD, int GP>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* lengths,
                   void* out, float* part_ml, float* part_acc, int* tickets, int B, int H,
                   int KV, int Tc, int window, int n_splits, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD, GP>();
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<HD, GP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KV, n_splits);
  flash_decode_kernel<HD, GP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), lengths, static_cast<float*>(out), part_ml, part_acc,
      tickets, H, KV, Tc, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_group(int G, const void* q, const void* kc, const void* vc, const int* lengths,
                     void* out, float* part_ml, float* part_acc, int* tickets, int B, int H,
                     int KV, int Tc, int window, int n_splits, float scale, cudaStream_t st) {
  if (G <= 4)
    return launch<HD, 4>(q, kc, vc, lengths, out, part_ml, part_acc, tickets, B, H, KV, Tc,
                         window, n_splits, scale, st);
  return launch<HD, GMAX>(q, kc, vc, lengths, out, part_ml, part_acc, tickets, B, H, KV, Tc,
                          window, n_splits, scale, st);
}

}  // namespace fma_route

cudaError_t dispatch(int dtype, int HD, const void* q, const void* kc, const void* vc,
                     const int* lengths, void* out, float* part_ml, float* part_acc,
                     int* tickets, int B, int H, int KV, int Tc, int window, int n_splits,
                     float scale, cudaStream_t st) {
  const int G = H / KV;
#define QT_DECODE_ARGS q, kc, vc, lengths, out, part_ml, part_acc, tickets, B, H, KV, Tc, \
                       window, n_splits, scale, st
  if (dtype == 1) {
    switch (HD) {
      case 64: return mma_route::launch<64>(QT_DECODE_ARGS);
      case 128: return mma_route::launch<128>(QT_DECODE_ARGS);
      case 256: return mma_route::launch<256>(QT_DECODE_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (HD) {
      case 64: return fma_route::by_group<64>(G, QT_DECODE_ARGS);
      case 128: return fma_route::by_group<128>(G, QT_DECODE_ARGS);
      case 256: return fma_route::by_group<256>(G, QT_DECODE_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
#undef QT_DECODE_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,1,HD], k/v cache [B,KV,T,HD], out [B,H,1,HD], all contiguous and
// 16-byte aligned; lengths [B] int32 on the device (valid entries including
// the current token). part_ml [B*H*n_splits*2] and part_acc
// [B*H*n_splits*HD] are f32 scratch, tickets [B*KV] int32 counters that
// must be 0 on entry and are 0 again on return; the caller allocates all
// three and keeps them across calls on one stream. dtype: 0 = float32 (fma
// route), 1 = bfloat16 (mma route). Launches once on `stream`, allocates
// nothing, does not synchronise; returns the launch's cudaError_t.
extern "C" int qt_flash_decode(const void* q, const void* kc, const void* vc,
                               const int* lengths, void* out, float* part_ml, float* part_acc,
                               int* tickets, int B, int H, int KV, int Tc, int HD, int window,
                               int n_splits, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Tc <= 0 || H % KV != 0 || H / KV > GMAX ||
      n_splits < 1 || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, HD, q, kc, vc, lengths, out, part_ml, part_acc, tickets, B, H,
                       KV, Tc, window, n_splits, scale, static_cast<cudaStream_t>(stream));
}
