// Causal / windowed grouped-query flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel). The TPU grid (B, H, S/bq, T/bkv) stepped over
// key tiles in order with the softmax state in VMEM scratch; here one block
// per (query tile, head, batch row) loops over its key tiles itself and keeps
// the running max, sum and output in shared memory and registers.
//
// Bound: at prefill lengths the work is about 4 * S * T/2 * dh FLOPs per
// head against (S + 2T) * dh * 2 bytes, so the card's tensor-core rate is the
// ideal bound. This first version computes on the CUDA cores in f32 (no
// tensor cores): it is correct and simple, and far from that bound; the
// tensor-core (wgmma) version is later work. What it keeps from the design:
// the (S, T) scores never reach device memory, key tiles past the causal or
// window frontier are never loaded, and the ragged last tiles are masked by
// the true S and T (no padding of either).
//
// Layouts: q (B, H, S, DH), k/v (B, KV, T, DH), out (B, H, S, DH), bf16,
// each with arbitrary strides over (B, head, position) and a contiguous last
// axis; KV head = h / G. Query row i sits at key position i + T - S.
// f32 softmax and accumulation; a row with no visible key yields zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BKV = 64;    // keys per tile
constexpr int NT = 256;    // threads: (ty, tx) in 16 x 16

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

template <int DH>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * (DH + 2) + BKV * (DH + 2) + BKV * DH) * 2
         + (size_t)(BQ * (BKV + 1) + 3 * BQ) * 4;
}

// 8 bf16 from global (16-byte load) into a padded shared row (4-byte stores)
__device__ __forceinline__ void copy8_padded(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             bool live) {
  uint4 x = make_uint4(0, 0, 0, 0);
  if (live) x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&x);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
  for (int e = 0; e < 4; ++e) d2[e] = s2[e];
}

template <int DH>
__global__ void __launch_bounds__(NT)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int S, int T, int G,
             long long qsb, long long qsh, long long qss,
             long long ksb, long long ksh, long long kst,
             long long vsb, long long vsh, long long vst,
             long long osb, long long osh, long long oss,
             float scale, int causal, int window) {
  constexpr int QSTR = DH + 2, KSTR = DH + 2, PSTR = BKV + 1;
  constexpr int CH = DH / 8;       // 16-byte chunks per row
  constexpr int CPT = DH / 16;     // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * QSTR;
  __nv_bfloat16* vs = ks + BKV * KSTR;
  float* ps = reinterpret_cast<float*>(vs + BKV * DH);
  float* m_s = ps + BQ * PSTR;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int off = T - S;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + (h / G) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / G) * vsh;

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    copy8_padded(qs + r * QSTR + c * 8, qb + (q0 + r) * qss + c * 8, q0 + r < S);
  }
  if (tid < BQ) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; }

  // key tiles that hold a visible key for some row of this query tile
  const int last_row = min(q0 + BQ, S) - 1;
  const int kv_hi = causal ? min(T, last_row + off + 1) : T;
  const int kv_lo = window > 0 ? max(0, q0 + off - window + 1) / BKV * BKV : 0;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BKV) {
    for (int i = tid; i < BKV * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      const bool live = t0 + r < T;
      copy8_padded(ks + r * KSTR + c * 8, kb + (t0 + r) * kst + c * 8, live);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (live) x = *reinterpret_cast<const uint4*>(vb + (t0 + r) * vst + c * 8);
      *reinterpret_cast<uint4*>(vs + r * DH + c * 8) = x;
    }
    __syncthreads();

    // scores for rows ty + 16i, keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH / 2; ++d) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qs + (ty + 16 * i) * QSTR)[d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(ks + (tx + 16 * j) * KSTR)[d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, sc[i][j]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kp = t0 + c;
        bool ok = q0 + r < S && kp < T;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        ps[r * PSTR + c] = ok ? sc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = ps[r * PSTR + lane], s1 = ps[r * PSTR + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // row fully masked so far
      const float p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_use);
      const float p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_use);
      ps[r * PSTR + lane] = p0;
      ps[r * PSTR + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = m_old == -INFINITY ? 0.f : expf(m_old - m_use);
        a_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // out rows ty + 16i, columns tx * CPT + c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= a;
    }
#pragma unroll 2
    for (int j = 0; j < BKV; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PSTR + j];
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(vs + j * DH + tx * CPT);
#pragma unroll
      for (int c = 0; c < CPT / 2; ++c) {
        const float2 vf = __bfloat1622float2(vr[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * c] = fmaf(pv[i], vf.x, acc[i][2 * c]);
          acc[i][2 * c + 1] = fmaf(pv[i], vf.y, acc[i][2 * c + 1]);
        }
      }
    }
    __syncthreads();   // the next tile overwrites ks/vs/ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = l_s[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        o + b * osb + h * osh + (q0 + r) * oss + tx * CPT);
#pragma unroll
    for (int c = 0; c < CPT / 2; ++c)
      dst[c] = __floats2bfloat162_rn(acc[i][2 * c] * inv, acc[i][2 * c + 1] * inv);
  }
}

template <int DH>
cudaError_t launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                   const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* o,
                   int S, int T, int G, const long long* s, float scale,
                   int causal, int window) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  flash_kernel<DH><<<grid, NT, smem, st>>>(
      q, k, v, o, S, T, G, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11], scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). ``strides`` holds 12
// element strides: (batch, head, position) for q, k, v and out in turn.
// DH in {64, 128}; the Python wrapper checks shapes and alignment first.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out,
    int B, int H, int S, int T, int G, int DH, const long long* strides,
    float scale, int causal, int window, void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (DH == 128) return launch<128>(grid, st, qp, kp, vp, op, S, T, G, strides, scale, causal, window);
  if (DH == 64) return launch<64>(grid, st, qp, kp, vp, op, S, T, G, strides, scale, causal, window);
  return cudaErrorInvalidValue;
}
