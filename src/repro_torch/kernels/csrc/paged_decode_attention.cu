// Decode attention for Hopper (sm_90a): one query token per sequence,
// grouped-query heads, online softmax over the sequence's cache. Two entries
// share one per-tile routine (attend_rows) and differ only in where token t's
// K and V rows live:
//
//   paged_decode_attention_bf16: a shared page pool addressed by a page table.
//     Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
//     paged_decode_attention (_paged_kernel).
//   decode_attention_bf16: a dense cache (B, KV, T, dh) given by its strides,
//     so the static path's (B, T, KV, dh) cache layer reaches it as a
//     transposed view, with no copy. Replaces decode_attention (_kernel) of
//     the same file.
//
// The TPU grids (B, KV, M) and (B, KV, T/bt) walked the cache in order and
// carried the softmax state in VMEM scratch; CUDA blocks run in no order, so
// one block per (kv head, sequence) walks that sequence's cache itself, TILE
// tokens at a time, and the G query heads of the kv head share every K/V tile
// it loads.
//
// Bound: device-memory bytes. Each live token's K and V row is read once
// (2 * dh * 2 bytes per kv head) for about 4 * G * dh FLOPs, far below the
// card's 295 FLOP/byte balance point. The design keeps the bytes minimal:
// only tokens below the live length are read (dead table slots, the trash
// page and cache rows past lengths[b] never are; the dense entry masks by the
// true T, where the TPU version padded T to its tile), tiles are loaded with
// 16-byte loads, and the scores, weights and accumulators never leave the SM.
//
// Layouts: q and out (B, KV, G, DH) bf16, contiguous; lengths (B,) int32.
// Paged: k/v pages (KV, P, page, DH) bf16; page_table (B, M) int32. Dense:
// k/v (B, KV, T, DH) bf16 with any strides over the first three axes (in
// elements, multiples of 8) and a contiguous last axis. f32 softmax and
// accumulation; a length-0 row yields zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // tokens per loaded K/V tile

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Token t's row of one (sequence, kv head) in a page pool: page
// table[t / page], row t % page. K and V share the offset.
struct PagedRows {
  const int32_t* table;   // this sequence's page-table row
  size_t pool;            // element offset of this kv head's pool
  int page, dh;
  __device__ __forceinline__ size_t k(int t) const {
    return pool + ((size_t)table[t / page] * page + t % page) * dh;
  }
  __device__ __forceinline__ size_t v(int t) const { return k(t); }
};

// Token t's row of one (sequence, kv head) in a strided dense cache.
struct DenseRows {
  size_t k0, v0;          // element offsets of row 0
  long long kt, vt;       // element strides along T
  __device__ __forceinline__ size_t k(int t) const { return k0 + (size_t)t * kt; }
  __device__ __forceinline__ size_t v(int t) const { return v0 + (size_t)t * vt; }
};

// The shared body: blockDim.x == DH, thread d owns output column d of every
// query head. q and out point at this (sequence, kv head)'s G x DH rows.
template <int DH, int G, class Rows>
__device__ __forceinline__ void attend_rows(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows rows, const int len,
    __nv_bfloat16* __restrict__ out, const float scale) {
  constexpr int KSTR = DH + 2;    // padded K row: odd 4-byte word stride
  constexpr int CH = DH / 8;      // 16-byte chunks per row
  constexpr int NWARP = DH / 32;
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * KSTR];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * DH];
  __shared__ float qs[G * DH];
  __shared__ float ps[G * TILE];
  __shared__ float m_s[G], l_s[G], a_s[G];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < G * DH; i += DH)
    qs[i] = __bfloat162float(q[i]) * scale;
  if (tid < G) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TILE) {
    // load the tile's K/V rows (TILE * CH chunks over DH threads, TILE / 8
    // each, every load started before any store); rows past len are zero
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int i = tid + j * DH;
      const int r = i / CH, c = i % CH, t = t0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (t < len) {
        kx = *reinterpret_cast<const uint4*>(k + rows.k(t) + c * 8);
        vx = *reinterpret_cast<const uint4*>(v + rows.v(t) + c * 8);
      }
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kx);
      __nv_bfloat162* kd = reinterpret_cast<__nv_bfloat162*>(ks + r * KSTR + c * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) kd[e] = k2[e];
      *reinterpret_cast<uint4*>(vs + r * DH + c * 8) = vx;
    }
    __syncthreads();

    // scores: one (head, token) dot product per thread
    for (int i = tid; i < G * TILE; i += DH) {
      const int g = i / TILE, r = i % TILE;
      float s = -INFINITY;
      if (t0 + r < len) {
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + r * KSTR);
        const float* qg = qs + g * DH;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH / 2; ++d) {
          const float2 kf = __bfloat1622float2(kr[d]);
          dot = fmaf(qg[2 * d], kf.x, dot);
          dot = fmaf(qg[2 * d + 1], kf.y, dot);
        }
        s = dot;
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head. Token t0 < len is live, so
    // the tile max is finite.
    for (int g = warp; g < G; g += NWARP) {
      const float s0 = ps[g * TILE + lane], s1 = ps[g * TILE + lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
      ps[g * TILE + lane] = p0;
      ps[g * TILE + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);   // 0 on the first tile
        a_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      float pv = 0.f;
#pragma unroll 8
      for (int r = 0; r < TILE; ++r)
        pv = fmaf(ps[g * TILE + r], __bfloat162float(vs[r * DH + tid]), pv);
      acc[g] = acc[g] * a_s[g] + pv;
    }
    __syncthreads();   // the next tile overwrites ks/vs/ps
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float l = l_s[g];
    out[g * DH + tid] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
  }
}

template <int DH, int G>
__global__ void __launch_bounds__(DH)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    int KV, int P, int page, int M, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t head = ((size_t)b * KV + h) * G * DH;
  const PagedRows rows{page_table + (size_t)b * M, (size_t)h * P * page * DH,
                       page, DH};
  attend_rows<DH, G>(q + head, k_pages, v_pages, rows, lengths[b], out + head,
                     scale);
}

template <int DH, int G>
__global__ void __launch_bounds__(DH)
dense_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int KV, int T,
                    long long kb, long long kh, long long kt, long long vb,
                    long long vh, long long vt, float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t head = ((size_t)b * KV + h) * G * DH;
  const DenseRows rows{(size_t)b * kb + (size_t)h * kh,
                       (size_t)b * vb + (size_t)h * vh, kt, vt};
  const int len = max(0, min(lengths[b], T));    // never past the true T
  attend_rows<DH, G>(q + head, k, v, rows, len, out + head, scale);
}

// Instantiates KERNEL<DH, G> for G in {1, 2, 4, 8} and launches it.
#define LAUNCH_G(KERNEL, DH, G_, GRID, ST, ...)                              \
  switch (G_) {                                                             \
    case 1: KERNEL<DH, 1><<<GRID, DH, 0, ST>>>(__VA_ARGS__); break;         \
    case 2: KERNEL<DH, 2><<<GRID, DH, 0, ST>>>(__VA_ARGS__); break;         \
    case 4: KERNEL<DH, 4><<<GRID, DH, 0, ST>>>(__VA_ARGS__); break;         \
    case 8: KERNEL<DH, 8><<<GRID, DH, 0, ST>>>(__VA_ARGS__); break;         \
    default: return cudaErrorInvalidValue;                                  \
  }                                                                         \
  return cudaGetLastError();

template <int DH>
cudaError_t launch_paged(int G, dim3 grid, cudaStream_t st,
                         const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const int32_t* pt,
                         const int32_t* len, __nv_bfloat16* out, int KV,
                         int P, int page, int M, float scale) {
  LAUNCH_G(paged_decode_kernel, DH, G, grid, st, q, k, v, pt, len, out, KV, P,
           page, M, scale)
}

template <int DH>
cudaError_t launch_dense(int G, dim3 grid, cudaStream_t st,
                         const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const int32_t* len,
                         __nv_bfloat16* out, int KV, int T,
                         const long long* s, float scale) {
  LAUNCH_G(dense_decode_kernel, DH, G, grid, st, q, k, v, len, out, KV, T,
           s[0], s[1], s[2], s[3], s[4], s[5], scale)
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). G in {1, 2, 4, 8},
// DH in {64, 128}; the Python wrapper checks shapes before calling.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out,
    int B, int KV, int G, int DH, int P, int page, int M, float scale,
    void* stream) {
  const dim3 grid(KV, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (DH == 128) return launch_paged<128>(G, grid, st, qp, kp, vp, pt, ln, op, KV, P, page, M, scale);
  if (DH == 64) return launch_paged<64>(G, grid, st, qp, kp, vp, pt, ln, op, KV, P, page, M, scale);
  return cudaErrorInvalidValue;
}

// Dense cache: strides (6,) = k's (B, KV, T) strides then v's, in elements.
// Returns the launch's cudaError_t (0 on success); same instances as above.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int KV, int G, int DH, int T, const long long* strides,
    float scale, void* stream) {
  const dim3 grid(KV, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (DH == 128) return launch_dense<128>(G, grid, st, qp, kp, vp, ln, op, KV, T, strides, scale);
  if (DH == 64) return launch_dense<64>(G, grid, st, qp, kp, vp, ln, op, KV, T, strides, scale);
  return cudaErrorInvalidValue;
}
