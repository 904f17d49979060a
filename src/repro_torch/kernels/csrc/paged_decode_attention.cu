// Paged decode attention for Hopper (sm_90a): one query token per sequence,
// grouped-query heads, online softmax over a shared page pool.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (paged_decode_attention / _paged_kernel). The TPU grid (B, KV, M) walked
// the table slots in order and carried the softmax state in VMEM scratch;
// CUDA blocks run in no order, so one block per (kv head, sequence) walks
// that sequence's pages itself, TILE tokens at a time, and the G query
// heads of the kv head share every K/V tile it loads.
//
// Bound: device-memory bytes. Each live token's K and V row is read once
// (2 * dh * 2 bytes per kv head) for about 4 * G * dh FLOPs, far below the
// card's 295 FLOP/byte balance point. The design keeps the bytes minimal:
// only table slots below lengths[b] are read (dead slots and the trash page
// never are), tiles are loaded with 16-byte loads, and the scores, weights
// and accumulators never leave the SM.
//
// Layouts: q (B, KV, G, DH) bf16; k/v pages (KV, P, page, DH) bf16;
// page_table (B, M) int32; lengths (B,) int32; out (B, KV, G, DH) bf16.
// f32 softmax and accumulation; a length-0 row yields zeros.

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

// blockDim.x == DH: thread d owns output column d of every query head.
template <int DH, int G>
__global__ void __launch_bounds__(DH)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    int KV, int P, int page, int M, float scale) {
  constexpr int KSTR = DH + 2;    // padded K row: odd 4-byte word stride
  constexpr int CH = DH / 8;      // 16-byte chunks per row
  constexpr int NWARP = DH / 32;
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * KSTR];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * DH];
  __shared__ float qs[G * DH];
  __shared__ float ps[G * TILE];
  __shared__ float m_s[G], l_s[G], a_s[G];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  const size_t head = ((size_t)b * KV + h) * G * DH;
  const size_t pool = (size_t)h * P * page * DH;
  const int32_t* row = page_table + (size_t)b * M;

  for (int i = tid; i < G * DH; i += DH)
    qs[i] = __bfloat162float(q[head + i]) * scale;
  if (tid < G) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TILE) {
    // gather the tile's K/V rows from their pages; rows past len are zero
    for (int i = tid; i < TILE * CH; i += DH) {
      const int r = i / CH, c = i % CH, t = t0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (t < len) {
        const size_t off = pool + ((size_t)row[t / page] * page + t % page) * DH
                           + c * 8;
        kx = *reinterpret_cast<const uint4*>(k_pages + off);
        vx = *reinterpret_cast<const uint4*>(v_pages + off);
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
    out[head + g * DH + tid] = __float2bfloat16(acc[g] / (l == 0.f ? 1.f : l));
  }
}

template <int DH>
cudaError_t launch_dh(int G, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                      const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const int32_t* pt, const int32_t* len, __nv_bfloat16* out,
                      int KV, int P, int page, int M, float scale) {
  switch (G) {
    case 1: paged_decode_kernel<DH, 1><<<grid, DH, 0, st>>>(q, k, v, pt, len, out, KV, P, page, M, scale); break;
    case 2: paged_decode_kernel<DH, 2><<<grid, DH, 0, st>>>(q, k, v, pt, len, out, KV, P, page, M, scale); break;
    case 4: paged_decode_kernel<DH, 4><<<grid, DH, 0, st>>>(q, k, v, pt, len, out, KV, P, page, M, scale); break;
    case 8: paged_decode_kernel<DH, 8><<<grid, DH, 0, st>>>(q, k, v, pt, len, out, KV, P, page, M, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  if (DH == 128) return launch_dh<128>(G, grid, st, qp, kp, vp, pt, ln, op, KV, P, page, M, scale);
  if (DH == 64) return launch_dh<64>(G, grid, st, qp, kp, vp, pt, ln, op, KV, P, page, M, scale);
  return cudaErrorInvalidValue;
}
