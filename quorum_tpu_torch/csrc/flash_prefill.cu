// Kernel K1: causal, length-masked prefill attention with GQA, for sm_90a.
//
// Replaces the Pallas TPU kernel quorum_tpu/ops/flash_attention.py:
// _flash_kernel (launched by _flash_call). Same function: query head h reads
// kv head h / (H / KV); key col is kept for query row iff col <= row,
// col < lengths[b] and, with a window W > 0, col > row - W; softmax in f32
// with scale hd^-0.5.
//
// Contract for rows past the length: every query row at or past lengths[b]
// comes out as exactly 0 (the model keeps only row lengths[b] - 1 of a
// prompt, so such rows are right padding nobody reads). A query tile whose
// first row is at or past the length writes its zeros and returns without
// loading anything, so the padding of a power-of-two prompt bucket costs no
// attention work.
//
// Bound: operations — 4 * H * (kept query/key pairs) * hd FLOPs against
// (2H + 2KV) * S * hd elements of traffic, far above the card's ridge once S
// is in the hundreds. Two routes, chosen by dtype and head dim in
// ops/flash_attention.py prefill_route, which passes the route to the entry
// point; the entry point refuses a route that cannot run the call:
//
// wgmma route (bf16, hd 64 or 128) — the FlashAttention-3 shape:
//   - persistent: one CTA per SM takes work tiles (128-row query tile, query
//     head, batch row) from an atomic counter, heaviest first (the bottom of
//     the causal triangle), tiles past the length last (tile_at). Warpgroup
//     0 is the producer (one thread takes the tiles and issues every load),
//     warpgroups 1 and 2 are consumers owning 64 query rows each; setmaxnreg
//     moves registers
//     from the producer (40) to the consumers (232). The consumers release Q
//     before their epilogue, so the next tile's loads overlap the stores;
//   - TMA loads Q and K/V tiles of 128 keys into a 3-stage ring with
//     128-byte swizzle (64-column panels), with mbarrier full/empty pairs.
//     The tensor maps are 2-D views [B*H*S, hd] of q and [B*KV*S, hd] of k/v,
//     encoded on the host per call. A K/V tile that straddles the end of a
//     row reads keys of the next (b, kv head), or zeros past the tensor's
//     end: those columns are >= S >= lengths[b], and the length mask
//     discards them. Likewise a Q tile past S reads rows that are never
//     stored;
//   - S = Q.K^T with wgmma m64n128k16, A = Q and B = K from shared memory,
//     both K-major; the k16 step advances the descriptor 32 bytes inside the
//     swizzled panel;
//   - online softmax on the accumulator fragments: ex2.approx with the scale
//     folded into log2(e), row max over the quad by shuffles, a guarded
//     rescale so a row with no live key stays finite; the causal / length /
//     window mask runs only on tiles that cross the diagonal, the length or
//     the window's edge;
//   - O += P.V with one wgmma m64n{hd}k16 per k16 step: A = P converted to
//     bf16 in registers (the f32 accumulator layout of S is the A-fragment
//     layout, so P never touches shared memory), B = V from shared memory as
//     MN-major with the transpose flag (SBO = the 8-row atom stride along K,
//     LBO = the stride to the next 64-column panel along N);
//   - ping-pong: each step issues one batch, P(j).V(j) then S(j+1), and the
//     two consumer warpgroups take turns to issue (named barriers 1 and 2),
//     so one's softmax overlaps the other's tensor-core work;
//   - output is normalised by l, converted to bf16 and stored from
//     registers.
//
// fma route (f32 — wgmma on f32 inputs would be TF32 and miss the f32
// tolerance — and bf16 with hd 256): the first version of this kernel, a
// 64-row query tile per block, 256 threads each holding a 4x4 score
// micro-tile and a 4 x hd/16 output slice, K/V tiles of 64 keys staged in
// shared memory, online softmax in f32 registers. Bounded by shared-memory
// reads of the FMA loops.
//
// Both routes start at the window's first live key tile and stop at
// min(q_end, len): tiles above the diagonal or left of the window cost
// neither loads nor math. ops/flash_attention.py prefill_tile_plan mirrors
// this schedule for the CPU tests.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// fma route
// ---------------------------------------------------------------------------
namespace fma_route {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per staged tile
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int RT = 4;    // rows per thread (BM / 16)
constexpr int CT = 4;    // score cols per thread (BN / 16)
constexpr int PP = BN + 1;  // probability row pitch (f32, odd)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
struct Smem {
  static constexpr int QP = HD + 1;  // f32 query row pitch (odd: conflict-free)
  static constexpr int KP = HD + 2;  // key row pitch in T (odd 32-bit word pitch for bf16)
  static constexpr size_t bytes =
      sizeof(float) * (BM * QP + BM * PP) + sizeof(T) * (BN * KP + BN * HD);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out,
    int H, int KV, int S, int window, float scale) {
  constexpr int DT = HD / 16;  // head dims per thread in the P.V product
  constexpr int QP = Smem<T, HD>::QP;
  constexpr int KP = Smem<T, HD>::KP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);         // [BM][QP] scaled queries
  float* p_s = q_s + BM * QP;                               // [BM][PP] probabilities
  T* k_s = reinterpret_cast<T*>(p_s + BM * PP);             // [BN][KP]
  T* v_s = k_s + BN * KP;                                   // [BN][HD]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  const T* qb = q + (size_t)(b * H + h) * S * HD;
  const T* kb = k + (size_t)(b * KV + kvh) * S * HD;
  const T* vb = v + (size_t)(b * KV + kvh) * S * HD;
  T* ob = out + (size_t)(b * H + h) * S * HD;

  if (q0 >= len) {  // every row is past the length: zeros, no loads
    const int n = min(BM, S - q0) * HD;
    for (int i = tid; i < n; i += NT) ob[(size_t)q0 * HD + i] = from_f<T>(0.f);
    return;
  }

  for (int i = tid; i < BM * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    q_s[r * QP + d] = row < S ? to_f(qb[(size_t)row * HD + d]) * scale : 0.f;
  }

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) acc[i][dd] = 0.f;
  }

  // Live key range of this query tile: the last row (q0 + BM - 1) sees keys
  // up to itself and below the length; the first row's window starts at
  // q0 - W + 1.
  const int k_end = min(q0 + BM, len);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BN;
  const int t_end = (k_end + BN - 1) / BN;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BN;
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < BN * HD; i += NT) {
      const int c = i / HD, d = i % HD, col = c0 + c;
      T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
      if (col < S) {
        kx = kb[(size_t)col * HD + d];
        vx = vb[(size_t)col * HD + d];
      }
      k_s[c * KP + d] = kx;
      v_s[c * HD + d] = vx;
    }
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RT], kv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = q_s[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < CT; ++j) kv[j] = to_f(k_s[(tx + 16 * j) * KP + d]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool keep = col <= row && col < len && (window <= 0 || col > row - window);
        s[i][j] = keep ? s[i][j] : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // The 16 threads of a row group are 16 consecutive lanes of one warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float p = expf(s[i][j] - m_use);
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[RT], vv[DT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) vv[dd] = to_f(v_s[c * HD + tx + 16 * dd]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int dd = 0; dd < DT; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < S) {
      const float inv = (row < len && l[i] > 0.f) ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int dd = 0; dd < DT; ++dd)
        ob[(size_t)row * HD + tx + 16 * dd] = from_f<T>(row < len ? acc[i][dd] * inv : 0.f);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* out, int B, int H, int KV, int S, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, H, B);
  flash_prefill_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), H, KV, S, window, scale);
  return cudaGetLastError();
}

}  // namespace fma_route

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------
namespace wgmma_route {

constexpr int BM = 128;        // query rows per CTA: two consumer warpgroups x 64
constexpr int BN = 128;        // keys per K/V tile
constexpr int SN = BN / 2;     // S accumulator registers per consumer thread
constexpr int PN = BN / 4;     // bf16x2 registers of P per consumer thread
constexpr int ST = 3;          // K/V ring stages
constexpr int NT = 384;        // producer warpgroup + two consumer warpgroups
constexpr int PANEL = 64;      // bf16 columns per 128-byte swizzled panel
constexpr int ROW_B = 128;     // bytes per panel row
constexpr int ATOM_B = 1024;   // 8 rows x 128 B: one swizzle atom

template <int HD>
struct Layout {
  static constexpr int NP = HD / PANEL;          // panels across the head dim
  static constexpr int Q_PANEL = BM * ROW_B;
  static constexpr int KV_PANEL = BN * ROW_B;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K (or V) tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + ST * KV_BYTES;
  static constexpr int N_BAR = 2 + 3 * ST;  // q full, q empty; k full, v full, empty per stage
  // + the tile slot, + slack to align the base
  static constexpr int BYTES = OFF_BAR + 8 * N_BAR + 16 + ATOM_B;
};

// Matrix descriptor of a 128-byte-swizzled operand in shared memory: rows of
// 128 B, 8-row atoms 1024 B apart. SBO is the atom stride (along MN for a
// K-major operand, along K for an MN-major one); LBO is the stride between
// 64-column panels of an MN-major operand (V, when one instruction spans
// both panels of hd 128) and is unused otherwise.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo = ATOM_B,
                                               uint32_t sbo = ATOM_B) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barriers 1 and 2 pass the tensor-core turn between the two
// consumer warpgroups (256 threads: one warpgroup syncs, the other arrives).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads of accumulators across a wait, or
// from reusing an A operand's registers while its product may still read them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]; A in registers (four bf16x2 per
// thread), B in shared memory MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128]; A in registers (four bf16x2 per
// thread), B in shared memory MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (flushes denormal results to 0: a
// probability below 2^-126 is 0 for the softmax).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This thread's place in a consumer warpgroup's 64 x 128 tile: its rows are
// lo and lo + 8, its first column of a pair in each 8-column block is cq;
// w0 .. w1 are the warpgroup's rows.
struct Rows {
  int lo, cq, w0, w1;
};

// Issue S = Q . K^T for one K tile (no commit, no wait).
template <int HD>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk / 4, kin = (kk % 4) * 32;  // panel; byte offset of the k16 slice
    wgmma_m64n128k16_ss(sc, sw128_desc(qa + p * Layout<HD>::Q_PANEL + kin),
                        sw128_desc(ks + p * Layout<HD>::KV_PANEL + kin), kk > 0);
  }
}

// Issue O += P . V for one V tile: one instruction per k16 step spans the
// whole head dim; for hd 128 it crosses from the first 64-column panel to
// the second, which lies LBO = one panel further on.
template <int HD>
__device__ __forceinline__ void issue_pv(float (*o)[32], const uint32_t* pf, uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (HD == 128)
      wgmma_m64n128k16_rs_tb(&o[0][0], &pf[4 * kk],
                             sw128_desc(vs + kk * 16 * ROW_B, Layout<HD>::KV_PANEL, ATOM_B));
    else
      wgmma_m64n64k16_rs_tb(o[0], &pf[4 * kk], sw128_desc(vs + kk * 16 * ROW_B));
  }
}

// Mask the tile where it crosses the diagonal, the length or the window's
// edge; update the running max m and sum l (thread-partial: the quad's
// lanes share m, so their l's are summed at the end); write P in bf16 — pair
// j holds accumulator elements 2j, 2j + 1, and pairs 4kk .. 4kk+3 are the A
// fragment of the k16 step kk — and the factors that rescale O.
// Accumulator element i sits at row lo + 8 * ((i >> 1) & 1) and column
// c0 + 8 * (i >> 2) + cq + (i & 1).
__device__ __forceinline__ void softmax_tile(float* sc, uint32_t* pf, float* m, float* l,
                                             float* corr, int c0, const Rows& rows, int len,
                                             int window, float scale_log2) {
  const bool interior = c0 + BN - 1 <= rows.w0 && c0 + BN <= len &&
                        (window <= 0 || c0 > rows.w1 - window);
  if (!interior) {
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      const int row = rows.lo + 8 * ((i >> 1) & 1);
      const int col = c0 + 8 * (i >> 2) + rows.cq + (i & 1);
      const bool keep = col <= row && col < len && (window <= 0 || col > row - window);
      if (!keep) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
  for (int i = 0; i < SN; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no live key yet
    corr[r] = ex2(m[r] - mu[r]);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < PN; ++j) {
    const int r = j & 1;
    const float p0 = ex2(fmaf(sc[2 * j], scale_log2, -mu[r]));
    const float p1 = ex2(fmaf(sc[2 * j + 1], scale_log2, -mu[r]));
    l[r] += p0 + p1;
    pf[j] = pack_bf16(p0, p1);
  }
}

// A work tile: query tile qt (rows qt*BM ..) of query head h of batch row b.
// Tile i of the launch's order: rank r = i / (B*H) picks, for each (b, h), the
// live query tiles heaviest first (the bottom of the causal triangle), then
// the tiles at or past the row's length (zeros, cheap) last.
struct Tile {
  int b, h, q0, len;
};

__device__ __forceinline__ Tile tile_at(int i, const int* lengths, int B, int H, int S) {
  const int r = i / (B * H), bh = i % (B * H);
  Tile t;
  t.b = bh / H;
  t.h = bh % H;
  int len = lengths[t.b];
  t.len = len < 0 ? 0 : (len > S ? S : len);
  const int n_live = (t.len + BM - 1) / BM;
  t.q0 = (r < n_live ? n_live - 1 - r : r) * BM;
  return t;
}

// Persistent: one CTA per SM walks tiles handed out by an atomic counter
// (sched[0]) in the order of tile_at; the producer thread takes each tile and
// passes its index to the consumers in shared memory, published by the Q
// barrier. The consumers release Q before their epilogue, so the next tile's
// loads overlap this tile's stores. The last CTA to run out of work resets
// both counters (sched[1] counts finished CTAs) for the next launch.
template <int HD>
__global__ void __launch_bounds__(NT, 1) prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int* __restrict__ sched, int B, int H, int KV, int S,
    int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int NP = L::NP;
  extern __shared__ unsigned char smem_raw[];

  const int n_tiles = B * H * ((S + BM - 1) / BM);
  const uint32_t base = (smem_u32(smem_raw) + (ATOM_B - 1)) & ~uint32_t(ATOM_B - 1);
  const uint32_t q_s = base, k_s = base + L::OFF_K, v_s = base + L::OFF_V;
  const uint32_t q_full = base + L::OFF_BAR, q_empty = q_full + 8u;
  auto k_full = [&](int s) { return q_full + 8u * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (2 + ST + s); };
  auto empty = [&](int s) { return q_full + 8u * (2 + 2 * ST + s); };
  volatile int* slot = reinterpret_cast<volatile int*>(
      smem_raw + (q_full + 8u * L::N_BAR - smem_u32(smem_raw)));
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // Producer warpgroup: one thread takes tiles and keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;  // K/V tiles loaded so far: the ring position
      for (int k = 0;; ++k) {
        mbar_wait(q_empty, (k & 1) ^ 1);  // the consumers are done with the last Q
        const int i = atomicAdd(&sched[0], 1);
        *slot = i < n_tiles ? i : -1;
        if (i >= n_tiles) {
          mbar_arrive(q_full);
          if (atomicAdd(&sched[1], 1) == gridDim.x - 1) {  // the last CTA out
            sched[0] = 0;
            sched[1] = 0;
          }
          break;
        }
        const Tile t = tile_at(i, lengths, B, H, S);
        if (t.q0 >= t.len) {  // zeros: nothing to load
          mbar_arrive(q_full);
          continue;
        }
        mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load_2d(q_s + p * L::Q_PANEL, &qmap, q_full, p * PANEL, (t.b * H + t.h) * S + t.q0);
        const int kv_row = (t.b * KV + t.h / (H / KV)) * S;
        const int k_end = min(t.q0 + BM, t.len);
        const int k_begin = window > 0 ? max(0, t.q0 - window + 1) : 0;
        for (int c = k_begin / BN; c < (k_end + BN - 1) / BN; ++c, ++it) {
          const int s = it % ST;
          mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            tma_load_2d(k_s + s * L::KV_BYTES + p * L::KV_PANEL, &kmap, k_full(s), p * PANEL,
                        kv_row + c * BN);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            tma_load_2d(v_s + s * L::KV_BYTES + p * L::KV_PANEL, &vmap, v_full(s), p * PANEL,
                        kv_row + c * BN);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each. Each step issues one batch of
    // tensor-core work, P(j).V(j) then S(j+1) = Q.K(j+1)^T, and the softmax
    // of S(j+1) follows once both are done. The two warpgroups take turns to
    // issue their batches (ping-pong on named barriers 1 and 2), so one's
    // softmax runs while the tensor cores work through the other's batch.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wgi - 1;
    const int tid = threadIdx.x - 128 * wgi;
    const int lane = tid & 31, warp = tid >> 5;
    const uint32_t qa = q_s + cw * 64 * ROW_B;
    int it = 0;  // ring position, as the producer counts it
    for (int k = 0;; ++k) {
      mbar_wait(q_full, k & 1);
      const int i = *slot;
      if (i < 0) break;
      const Tile t = tile_at(i, lengths, B, H, S);
      __nv_bfloat16* ob = out + (size_t)(t.b * H + t.h) * S * HD;
      if (t.q0 >= t.len) {  // every row is past the length: zeros
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
        uint4* dst = reinterpret_cast<uint4*>(ob + (size_t)t.q0 * HD);
        const int n16 = min(BM, S - t.q0) * HD / 8;
        for (int j = threadIdx.x - 128; j < n16; j += 256) dst[j] = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const int k_end = min(t.q0 + BM, t.len);
      const int k_begin = window > 0 ? max(0, t.q0 - window + 1) : 0;
      const int t_begin = k_begin / BN;
      const int n_t = (k_end + BN - 1) / BN - t_begin;
      Rows rows;
      rows.w0 = t.q0 + cw * 64;
      rows.w1 = rows.w0 + 63;
      rows.lo = rows.w0 + warp * 16 + (lane >> 2);
      rows.cq = (lane & 3) * 2;

      float o[NP][32];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[p][j] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      uint32_t pf[PN];  // P of the current K/V tile: the A operand of its P.V
      float sc[SN];

#pragma unroll
      for (int j = 0; j < SN; ++j) sc[j] = 0.f;
      mbar_wait(k_full(it % ST), (it / ST) & 1);
      wgmma_fence();
      issue_qk<HD>(sc, qa, k_s + (it % ST) * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<SN>(sc);
      softmax_tile(sc, pf, m, l, corr, t_begin * BN, rows, t.len, window, scale_log2);
      if (cw == 1) named_arrive(1);  // warpgroup 0 issues first
      // Every wgmma below is unconditional (a wgmma on a path the compiler
      // thinks divergent gets serialized), so the last step is peeled off.
      for (int j = 0; j < n_t - 1; ++j, ++it) {
        const int s = it % ST, sn = (it + 1) % ST;
        mbar_wait(v_full(s), (it / ST) & 1);
        mbar_wait(k_full(sn), ((it + 1) / ST) & 1);
#pragma unroll
        for (int e = 0; e < SN; ++e) sc[e] = 0.f;
        named_sync(1 + cw);  // this warpgroup's turn on the tensor cores
        wgmma_fence();
        issue_pv<HD>(o, pf, v_s + s * L::KV_BYTES);
        issue_qk<HD>(sc, qa, k_s + sn * L::KV_BYTES);
        wgmma_commit();
        named_arrive(2 - cw);  // the other warpgroup's turn
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs<32>(o[p]);
        fence_regs<PN>(pf);
        fence_regs<SN>(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));  // K(j) and V(j) are read
        softmax_tile(sc, pf, m, l, corr, (t_begin + j + 1) * BN, rows, t.len, window,
                     scale_log2);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[p][e] *= corr[(e >> 1) & 1];
      }
      {
        const int s = it % ST;
        mbar_wait(v_full(s), (it / ST) & 1);
        named_sync(1 + cw);
        wgmma_fence();
        issue_pv<HD>(o, pf, v_s + s * L::KV_BYTES);
        wgmma_commit();
        if (cw == 0) named_arrive(2);  // warpgroup 1's last turn
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs<32>(o[p]);
        fence_regs<PN>(pf);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty(s));
          mbar_arrive(q_empty);  // Q is read: the next tile's loads may start
        }
        ++it;
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = rows.lo + 8 * r;
        if (row >= S) continue;
        const bool live = row < t.len;
        const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int e = 4 * j + 2 * r;
            const float x = live ? o[p][e] * inv : 0.f;
            const float y = live ? o[p][e + 1] * inv : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * HD + p * PANEL + 8 * j +
                                               rows.cq) = __floats2bfloat162_rn(x, y);
          }
      }
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int* sched, int B, int H, int KV, int S, int window, float scale,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (make_map(&qm, q, (uint64_t)B * H * S, HD, BM) ||
      make_map(&km, k, (uint64_t)B * KV * S, HD, BN) ||
      make_map(&vm, v, (uint64_t)B * KV * S, HD, BN))
    return cudaErrorInvalidValue;
  const int smem = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(prefill_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int n_tiles = B * H * ((S + BM - 1) / BM);
  prefill_wgmma_kernel<HD><<<n_tiles < n_sm ? n_tiles : n_sm, NT, smem, stream>>>(
      qm, km, vm, lengths, static_cast<__nv_bfloat16*>(out), sched, B, H, KV, S, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace wgmma_route

template <typename T>
cudaError_t dispatch_fma(int HD, const void* q, const void* k, const void* v,
                         const int* lengths, void* out, int B, int H, int KV, int S,
                         int window, float scale, cudaStream_t stream) {
  switch (HD) {
    case 64: return fma_route::launch<T, 64>(q, k, v, lengths, out, B, H, KV, S, window, scale, stream);
    case 128: return fma_route::launch<T, 128>(q, k, v, lengths, out, B, H, KV, S, window, scale, stream);
    case 256: return fma_route::launch<T, 256>(q, k, v, lengths, out, B, H, KV, S, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,S,HD], k/v [B,KV,S,HD], out [B,H,S,HD], all contiguous and 16-byte
// aligned; lengths [B] int32 on the device; sched: two int32 scheduling
// counters of the wgmma route, 0 on entry and 0 again on return (the caller
// keeps them across calls on one stream). dtype: 0 = float32, 1 = bfloat16;
// route: 1 = wgmma (bf16 with HD 64 or 128 only), 0 = fma (either dtype, HD
// 64, 128 or 256). Launches on `stream`, allocates nothing, does not
// synchronise; returns the launch's cudaError_t (cudaErrorInvalidValue for a
// call the route cannot run).
extern "C" int qt_flash_prefill(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int* sched, int B, int H,
                                int KV, int S, int HD, int window, float scale, int dtype,
                                int route, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1 && dtype == 1 && HD == 64)
    return (int)wgmma_route::launch<64>(q, k, v, lengths, out, sched, B, H, KV, S, window,
                                        scale, st);
  if (route == 1 && dtype == 1 && HD == 128)
    return (int)wgmma_route::launch<128>(q, k, v, lengths, out, sched, B, H, KV, S, window,
                                         scale, st);
  if (route == 0 && dtype == 0)
    return (int)dispatch_fma<float>(HD, q, k, v, lengths, out, B, H, KV, S, window, scale, st);
  if (route == 0 && dtype == 1)
    return (int)dispatch_fma<__nv_bfloat16>(HD, q, k, v, lengths, out, B, H, KV, S, window,
                                            scale, st);
  return (int)cudaErrorInvalidValue;
}
