// Kernel K2q8: one-token decode attention over the int8 KV cache, for sm_90a.
//
// Computes the JAX package's quorum_tpu/ops/attention.py decode_attention_q8
// (XLA there, no Pallas kernel): q [B, H, 1, hd] (bf16 or f32) against
// k8 / v8 [B, KV, T, hd] int8 with per-token scales ks / vs [B, KV, T] f32,
// row b attending positions [lengths[b] - W, lengths[b]) (W = window, or the
// whole prefix without one), GQA by index. Its arithmetic, step for step:
//   - each query head's row is quantized amax/127 (1e-30 floor, round half
//     to even, clip +-127); logits_t = ((q8 . k8_t) * qs * ks_t) * hd^-0.5,
//     the dot an exact int32 sum;
//   - softmax over the live range in f32;
//   - pv_t = p_t * vs_t (V's scale folded into the probabilities), quantized
//     over t with ONE scale per (row, head), ps = max_t pv_t / 127;
//   - out = (sum_t p8_t * v8_t, exact int32) * ps, in q's dtype.
//
// Bound: bytes — the live int8 K and V rows and their f32 scales,
// sum(live) * KV * (2 * hd + 8), read once for all G query heads of their kv
// head. The integer dot products (__dp4a, four int8 products a lane per
// instruction) are far below the card's rate.
//
// Design — three launches on the caller's stream, a fixed grid (n_splits,
// KV, B) for the first two, n_splits chosen on the host from the shapes:
// each block sizes its own chunk of its row's live range from lengths[b]
// (ceil(live / n_splits) rounded up to 64 keys, at least 64: K2's
// split_range), so the host never reads the lengths.
//   1. logits: a block quantizes its G query rows into shared memory; each
//      thread takes one key at a time (16-byte loads of its int8 row, __dp4a
//      against the G rows), writes the G logits to an f32 scratch [B, H, T]
//      and keeps, per head, an online max m, sum s = sum exp(l - m) and
//      a = max exp(l - m) * vs_t; the block merges its threads and writes the
//      split's (m, s, a).
//   2. p.V: every block merges the row's split partials (m, s, and
//      amax(pv) = a / s), so all blocks of a row quantize their chunk of the
//      probabilities with the same single scale; p8 for a tile of 256 keys
//      goes to shared memory; each thread owns 4 adjacent dims (one 32-bit
//      word of a V row) and walks groups of 4 keys: four coalesced 32-bit
//      loads, a byte transpose (__byte_perm) into 4 words that each hold one
//      dim of the 4 keys, and __dp4a against the 4 keys' p8 per head. The
//      block's int32 sums go to a partial [B, H, n_splits, hd].
//   3. combine: out = (float)(sum of the row's active splits) * ps.
// The integer sums are exact and order-free, so splitting the range changes
// nothing in p.V; only the softmax's max, sum and amax are merged in float.
// A row with no live key writes zeros. The wrapper caches the scratch per
// device, stream and shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int GMAX = 8;          // query heads per kv head a block holds
constexpr int NT = 128;          // threads per block, kernels 1 and 2
constexpr int NW = NT / 32;
constexpr int MIN_CHUNK = 64;    // keys: the least work a block takes
constexpr int MAX_SPLITS = 32;
constexpr int TILE = 256;        // keys of p8 held in shared memory at once

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The key range [begin, end) of split sp of a row of n live-or-earlier keys
// (K2's rule; ops/flash_decode.py decode_split_plan mirrors it).
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

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
q8_logits_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                 const float* __restrict__ ks, const float* __restrict__ vs,
                 const int* __restrict__ lengths, float* __restrict__ logits,
                 float* __restrict__ part, int H, int KV, int Tc, int window, int n_splits,
                 float scale) {
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int n = min(max(lengths[b], 0), Tc);
  int c_begin, c_end, n_act;
  split_range(n, window, n_splits, sp, &c_begin, &c_end, &n_act);
  if (sp >= n_act) return;

  __shared__ __align__(16) int8_t q8s[GMAX][HD];
  __shared__ float qss[GMAX];
  __shared__ float red[3][NW][GMAX];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Quantize the G query rows: one warp per head.
  for (int g = warp; g < G; g += NW) {
    const T* qr = q + ((size_t)b * H + kvh * G + g) * HD;
    float x[HD / 32];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      x[i] = to_f(qr[lane + 32 * i]);
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float qs = fmaxf(amax, 1e-30f) / 127.f;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i)
      q8s[g][lane + 32 * i] = (int8_t)fminf(fmaxf(rintf(x[i] / qs), -127.f), 127.f);
    if (lane == 0) qss[g] = qs;
  }
  __syncthreads();

  float m[GMAX], s[GMAX], a[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) { m[g] = -INFINITY; s[g] = 0.f; a[g] = 0.f; }
  const size_t row = (size_t)b * KV + kvh;
  const int* qw = reinterpret_cast<const int*>(&q8s[0][0]);
  for (int t = c_begin + tid; t < c_end; t += NT) {
    const int4* kr = reinterpret_cast<const int4*>(k8 + (row * Tc + t) * HD);
    int acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0;
#pragma unroll
    for (int w4 = 0; w4 < HD / 16; ++w4) {
      const int4 kv = kr[w4];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const int* qg = qw + g * (HD / 4) + 4 * w4;
          acc[g] = __dp4a(kv.x, qg[0], acc[g]);
          acc[g] = __dp4a(kv.y, qg[1], acc[g]);
          acc[g] = __dp4a(kv.z, qg[2], acc[g]);
          acc[g] = __dp4a(kv.w, qg[3], acc[g]);
        }
      }
    }
    const float kst = ks[row * Tc + t], vst = vs[row * Tc + t];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float l = (((float)acc[g] * qss[g]) * kst) * scale;
        logits[((size_t)b * H + kvh * G + g) * Tc + t] = l;
        merge(m[g], s[g], a[g], l, 1.f, vst);
      }
    }
  }
  // Merge the block's threads: within each warp, then across the warps.
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[g], o);
      const float a2 = __shfl_xor_sync(0xffffffffu, a[g], o);
      merge(m[g], s[g], a[g], m2, s2, a2);
    }
    if (lane == 0) { red[0][warp][g] = m[g]; red[1][warp][g] = s[g]; red[2][warp][g] = a[g]; }
  }
  __syncthreads();
  if (tid < G) {
    float mm = -INFINITY, ss = 0.f, aa = 0.f;
    for (int w = 0; w < NW; ++w) merge(mm, ss, aa, red[0][w][tid], red[1][w][tid], red[2][w][tid]);
    float* p = part + (((size_t)b * H + kvh * G + tid) * n_splits + sp) * 3;
    p[0] = mm; p[1] = ss; p[2] = aa;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
q8_pv_kernel(const int8_t* __restrict__ v8, const float* __restrict__ vs,
             const int* __restrict__ lengths, const float* __restrict__ logits,
             const float* __restrict__ part, int* __restrict__ part_acc,
             float* __restrict__ pscale, int H, int KV, int Tc, int window, int n_splits) {
  constexpr int WPK = HD / 4;   // 32-bit words per key row
  constexpr int NQ = NT / WPK;  // key groups walked side by side
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int n = min(max(lengths[b], 0), Tc);
  int c_begin, c_end, n_act;
  split_range(n, window, n_splits, sp, &c_begin, &c_end, &n_act);
  if (sp >= n_act) return;

  __shared__ float mg[GMAX], sg[GMAX], psg[GMAX];
  __shared__ __align__(16) int8_t p8s[GMAX][TILE];
  __shared__ int red[GMAX][HD];
  const int tid = threadIdx.x;
  if (tid < G) {
    const float* p = part + ((size_t)b * H + kvh * G + tid) * n_splits * 3;
    float m = -INFINITY, s = 0.f, a = 0.f;
    for (int i = 0; i < n_act; ++i) merge(m, s, a, p[3 * i], p[3 * i + 1], p[3 * i + 2]);
    const float ps = s > 0.f ? fmaxf(a / s, 1e-30f) / 127.f : 0.f;
    mg[tid] = m; sg[tid] = s; psg[tid] = ps;
    if (sp == 0) pscale[(size_t)b * H + kvh * G + tid] = ps;
  }
  for (int i = tid; i < GMAX * HD; i += NT) (&red[0][0])[i] = 0;
  __syncthreads();

  const size_t row = (size_t)b * KV + kvh;
  const int word = tid % WPK, ql = tid / WPK;
  int acc[GMAX][4];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0;

  for (int t0 = c_begin; t0 < c_end; t0 += TILE) {
    const int tl = min(TILE, c_end - t0), tl4 = (tl + 3) & ~3;
    for (int i = tid; i < G * tl4; i += NT) {
      const int g = i / tl4, j = i % tl4;
      int8_t p8 = 0;
      if (j < tl && sg[g] > 0.f) {
        const int t = t0 + j;
        const float prob = expf(logits[((size_t)b * H + kvh * G + g) * Tc + t] - mg[g]) / sg[g];
        const float pv = prob * vs[row * Tc + t];
        p8 = (int8_t)fminf(fmaxf(rintf(pv / psg[g]), -127.f), 127.f);
      }
      p8s[g][j] = p8;
    }
    __syncthreads();
    for (int qd = ql; qd < tl4 / 4; qd += NQ) {
      const int t = t0 + 4 * qd;
      int w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = t + i < Tc ? reinterpret_cast<const int*>(v8 + (row * Tc + t + i) * HD)[word] : 0;
      // Byte transpose: d_j holds dim 4*word + j of the keys t..t+3.
      const int lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
      const int hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
      const int d[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                        __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const int pw = *reinterpret_cast<const int*>(&p8s[g][4 * qd]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[g][i] = __dp4a(pw, d[i], acc[g][i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G)
#pragma unroll
      for (int i = 0; i < 4; ++i) atomicAdd(&red[g][4 * word + i], acc[g][i]);
  __syncthreads();
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, dd = i % HD;
    part_acc[(((size_t)b * H + kvh * G + g) * n_splits + sp) * HD + dd] = red[g][dd];
  }
}

template <typename T>
__global__ void q8_combine_kernel(const int* __restrict__ part_acc,
                                  const float* __restrict__ pscale,
                                  const int* __restrict__ lengths, T* __restrict__ out, int H,
                                  int Tc, int HD, int window, int n_splits) {
  const int bh = blockIdx.x, b = bh / H, dd = threadIdx.x;
  const int n = min(max(lengths[b], 0), Tc);
  int c_begin, c_end, n_act;
  split_range(n, window, n_splits, 0, &c_begin, &c_end, &n_act);
  int sum = 0;
  for (int sp = 0; sp < n_act; ++sp) sum += part_acc[((size_t)bh * n_splits + sp) * HD + dd];
  out[(size_t)bh * HD + dd] = from_f<T>((float)sum * pscale[bh]);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k8, const float* ks, const void* v8,
                   const float* vs, const int* lengths, void* out, float* logits, float* part,
                   int* part_acc, float* pscale, int B, int H, int KV, int Tc, int window,
                   int n_splits, float scale, cudaStream_t stream) {
  const dim3 grid(n_splits, KV, B);
  q8_logits_kernel<T, HD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8), ks, vs, lengths, logits, part,
      H, KV, Tc, window, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_pv_kernel<HD><<<grid, NT, 0, stream>>>(static_cast<const int8_t*>(v8), vs, lengths, logits,
                                            part, part_acc, pscale, H, KV, Tc, window,
                                            n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q8_combine_kernel<T><<<B * H, HD, 0, stream>>>(part_acc, pscale, lengths,
                                                 static_cast<T*>(out), H, Tc, HD, window,
                                                 n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int HD, const void* q, const void* k8, const float* ks, const void* v8,
                        const float* vs, const int* lengths, void* out, float* logits,
                        float* part, int* part_acc, float* pscale, int B, int H, int KV,
                        int Tc, int window, int n_splits, float scale, cudaStream_t stream) {
  switch (HD) {
    case 64:
      return launch<T, 64>(q, k8, ks, v8, vs, lengths, out, logits, part, part_acc, pscale, B,
                           H, KV, Tc, window, n_splits, scale, stream);
    case 128:
      return launch<T, 128>(q, k8, ks, v8, vs, lengths, out, logits, part, part_acc, pscale, B,
                            H, KV, Tc, window, n_splits, scale, stream);
    case 256:
      return launch<T, 256>(q, k8, ks, v8, vs, lengths, out, logits, part, part_acc, pscale, B,
                            H, KV, Tc, window, n_splits, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). Scratch: logits [B, H, Tc]
// f32, part [B, H, n_splits, 3] f32, part_acc [B, H, n_splits, HD] int32,
// pscale [B, H] f32. Returns the launches' cudaError_t.
extern "C" int qt_flash_decode_q8(const void* q, const void* k8, const float* ks, const void* v8,
                                  const float* vs, const int* lengths, void* out, float* logits,
                                  float* part, int* part_acc, float* pscale, int B, int H,
                                  int KV, int Tc, int HD, int window, int n_splits, float scale,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Tc <= 0 || H % KV != 0 || H / KV > GMAX ||
      n_splits < 1 || n_splits > MAX_SPLITS || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_head_dim<float>(HD, q, k8, ks, v8, vs, lengths, out, logits, part, part_acc,
                                   pscale, B, H, KV, Tc, window, n_splits, scale, st);
  if (dtype == 1)
    return (int)by_head_dim<__nv_bfloat16>(HD, q, k8, ks, v8, vs, lengths, out, logits, part,
                                           part_acc, pscale, B, H, KV, Tc, window, n_splits,
                                           scale, st);
  return (int)cudaErrorInvalidValue;
}
