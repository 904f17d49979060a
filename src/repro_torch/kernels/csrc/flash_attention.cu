// Causal / windowed grouped-query flash attention for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel). The TPU grid (B, H, S/bq, T/bkv) stepped over
// key tiles in order with the softmax state in VMEM scratch; here one block
// per (query tile, head, batch row) loops over its key tiles itself, in the
// FlashAttention-2 arrangement:
//
//   - 128 query rows a block. dh 128: 8 warps of 16 rows, whose Q fragments
//     are read once from shared memory with ldmatrix and stay in registers.
//     dh 64: 4 warps of 32 rows (two m16 tiles, so each K/V fragment read
//     from shared memory feeds two MMAs), re-reading Q from shared memory
//     each key tile, which keeps them under 255 registers.
//   - K and V tiles of 128 keys stream through a two-stage cp.async ring in
//     shared memory (rows padded by 16 bytes, so the 8 rows an ldmatrix
//     reads fall in 8 different bank groups). The next tile's copy is issued
//     right after the one barrier of each tile and is in flight while the
//     current tile is computed.
//   - S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, f32
//     accumulate). The online max and sum are taken in registers (each row
//     lives in one quad of lanes: two shuffles), and P is repacked from the
//     S accumulator fragment straight into the A fragment of P V: the scores
//     never touch shared memory.
//
// Bound: per head about 2 * S * T * dh FLOPs (causal; twice that without
// the mask) against 2 * (2S + 2T) * dh bytes (q, k, v read, out written):
// device-memory bytes bound it up to S = T of about 1,200 causal (590 not
// causal), the tensor-core rate beyond (whisper's 1,500-frame encoder).
// What the design keeps: the (S, T) scores never reach device memory, key
// tiles past the causal or window frontier are never loaded, and the ragged
// last tiles are masked by the true S and T (no padding of either). Blocks
// start with every head's last query tile, which carries the most causal
// work, so the longest blocks do not run last.
//
// Layouts: q (B, H, S, DH), k/v (B, KV, T, DH), out (B, H, S, DH), bf16,
// each with arbitrary strides over (B, head, position) and a contiguous last
// axis; KV head = h / G. Query row i sits at key position i + T - S.
// f32 softmax and accumulation (P is rounded to bf16 for the P V product, as
// the tensor cores take it); a row with no visible key yields zeros. For
// training the forward also writes each row's log-sum-exp (B, H, S) f32,
// which the backward kernels further down read; serving passes null.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BKV = 128;         // keys per tile

// WARPS warps, each owning MT 16-row m-tiles: BQ = 16 * WARPS * MT query
// rows a block. Every K/V fragment read from shared memory feeds MT MMAs.
// QREG keeps the Q fragments in registers (else re-read each key tile).
template <int DH, int WARPS, int MT, bool QREG>
struct Cfg {
  static constexpr int BQ = 16 * WARPS * MT;
  static constexpr int NT = 32 * WARPS;
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BKV) * (DH + 8) * 2;  // Q, 2 x (K, V)
};

// 2^x on the special-function unit (-inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte global -> shared copy; pred false fills zeros and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// d += a (16 x 16, row) . b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> one bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int DH, int WARPS, int MT, bool QREG>
__global__ void __launch_bounds__(32 * WARPS)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int S, int T, int G,
             long long qsb, long long qsh, long long qss,
             long long ksb, long long ksh, long long kst,
             long long vsb, long long vsh, long long vst,
             long long osb, long long osh, long long oss,
             float scale, int causal, int window, float* __restrict__ lse) {
  using C = Cfg<DH, WARPS, MT, QREG>;
  constexpr int BQ = C::BQ, NT = C::NT;
  constexpr int SROW = DH + 8;     // padded shared row: 8 ldmatrix rows, 8 bank groups
  constexpr int CH = DH / 8;       // 16-byte chunks per row
  constexpr int KD = DH / 16;      // k-steps of Q K^T
  constexpr int NS = BKV / 8;      // score n8 tiles
  constexpr int NO = DH / 8;       // output n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + BQ * SROW;     // stage st: K, then V

  // blocks start in index order: every head's last (most causal work)
  // query tile first, then the tiles before it
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;   // fragment row, column pair
  const int wrow = warp * 16 * MT;          // this warp's first row in the tile
  const int off = T - S;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + (h / G) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / G) * vsh;

  // key tiles that hold a visible key for some row of this query tile
  const int last_row = min(q0 + BQ, S) - 1;
  const int kv_hi = causal ? min(T, last_row + off + 1) : T;
  const int kv_lo = window > 0 ? max(0, q0 + off - window + 1) / BKV * BKV : 0;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BKV - 1) / BKV : 0;

  auto load_kv = [&](int t0, int st) {
    __nv_bfloat16* ks = ring + st * 2 * BKV * SROW;
    __nv_bfloat16* vs = ks + BKV * SROW;
    for (int i = tid; i < BKV * CH; i += NT) {
      const int r = i / CH, c = i % CH, t = t0 + r;
      const bool live = t < T;
      cp16(ks + r * SROW + c * 8, kb + (live ? (long long)t * kst + c * 8 : 0), live);
      cp16(vs + r * SROW + c * 8, vb + (live ? (long long)t * vst + c * 8 : 0), live);
    }
  };
  // the Q tile and the first K/V tile form the first copy group
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool live = q0 + r < S;
    cp16(qs + r * SROW + c * 8, qb + (live ? (long long)(q0 + r) * qss + c * 8 : 0), live);
  }
  if (ntiles > 0) load_kv(kv_lo, 0);
  cp_commit();

  const float sl2 = scale * 1.4426950408889634f;   // scores -> log2 units
  const int qp0 = q0 + wrow + g + off;              // key position of row g
  float o_acc[MT][NO][4];
  float m_r[MT][2], l_r[MT][2];                     // rows g, g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[mt][n][e] = 0.f;
    m_r[mt][0] = m_r[mt][1] = -INFINITY;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }
  uint32_t qf[QREG ? MT : 1][QREG ? KD : 1][4];

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = kv_lo + it * BKV, st = it & 1;
    cp_wait<0>();
    __syncthreads();   // tile it is visible to all; every warp is done with it - 1
    if (it + 1 < ntiles) load_kv(t0 + BKV, st ^ 1);
    cp_commit();
    if (QREG && it == 0) {
      // A: lane l addresses row l % 16, columns 16 kk + 8 (l / 16)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[QREG ? mt : 0][QREG ? kk : 0],
                  qs + (wrow + mt * 16 + (lane & 15)) * SROW + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = ring + st * 2 * BKV * SROW;
    const __nv_bfloat16* vs = ks + BKV * SROW;

    // S = Q K^T: K rows are B's columns (non-transposed ldmatrix); matrices
    // (keys 0-7 | 8-15) x (dims 0-7 | 8-15) give b0 b1 of two n8 tiles
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[mt][e] = qf[QREG ? mt : 0][QREG ? kk : 0][e];
        } else {
          ldsm_x4(qa[mt], qs + (wrow + mt * 16 + (lane & 15)) * SROW + kk * 16 +
                              (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * SROW + kk * 16 +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * jj], qa[mt], bk[0], bk[1]);
          mma16816(s[mt][2 * jj + 1], qa[mt], bk[2], bk[3]);
        }
      }
    }

    // masks, only on tiles that cross T, the causal diagonal or the window
    const bool edge = t0 + BKV > T || (causal && t0 + BKV - 1 > q0 + off) ||
                      (window > 0 && t0 <= q0 + BQ - 1 + off - window);
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = t0 + j * 8 + 2 * tg + (e & 1);
            const int qp = qp0 + mt * 16 + (e >> 1) * 8;
            bool ok = kp < T;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) s[mt][j][e] = -INFINITY;
          }
    }

    // online softmax in registers: fragment value e of tile j is row
    // g + 8 (e / 2); a row's BKV scores live in one quad of lanes
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m_r[mt][0], m_r[mt][1]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
      float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;   // no visible key yet
        alpha[r] = ex2(m_r[mt][r] * sl2 - base[r]);       // 0 on the first
        m_r[mt][r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], sl2, -base[e >> 1]));
          s[mt][j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[mt][r] = l_r[mt][r] * alpha[r] + rs[r];   // lane's share
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o_acc[mt][n][0] *= alpha[0]; o_acc[mt][n][1] *= alpha[0];
        o_acc[mt][n][2] *= alpha[1]; o_acc[mt][n][3] *= alpha[1];
      }
    }

    // O += P V: score tiles 2kk, 2kk + 1 are the A fragment of k-step kk;
    // V rows are B's k (transposed ldmatrix), as the grouped GEMM's weights
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int jj = 0; jj < NO / 2; ++jj) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW +
                          jj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(o_acc[mt][2 * jj], pa[mt], bv[0], bv[1]);
          mma16816(o_acc[mt][2 * jj + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  }

  // flush: each warp stages its rows in its own rows of the Q tile, then
  // stores them with 16-byte writes. The barrier covers a block with no key
  // tile, whose Q copies (issued by any thread) may still be landing.
  cp_wait<0>();
  __syncthreads();
  __nv_bfloat16* stage = qs + wrow * SROW;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      // natural-log sum of the row's scaled exponentials for the backward;
      // +inf on a row with no visible key, whose probabilities are all 0
      const int row = q0 + wrow + mt * 16 + g + 8 * r;
      if (lse != nullptr && tg == 0 && row < S)
        lse[((long long)b * gridDim.x + h) * S + row] =
            l > 0.f ? (m_r[mt][r] * sl2 + log2f(l)) * 0.6931471805599453f
                    : INFINITY;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(stage + (mt * 16 + g) * SROW + n * 8 + 2 * tg) =
          pack_bf16(o_acc[mt][n][0] * inv[0], o_acc[mt][n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(stage + (mt * 16 + g + 8) * SROW + n * 8 + 2 * tg) =
          pack_bf16(o_acc[mt][n][2] * inv[1], o_acc[mt][n][3] * inv[1]);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * MT * CH; i += 32) {
    const int r = i / CH, c = i % CH, row = q0 + wrow + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + b * osb + h * osh + (long long)row * oss + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * SROW + c * 8);
  }
}

template <int DH, int WARPS, int MT, bool QREG>
cudaError_t launch(int B, int H, cudaStream_t st, const __nv_bfloat16* q,
                   const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* o,
                   int S, int T, int G, const long long* s, float scale,
                   int causal, int window, float* lse) {
  using C = Cfg<DH, WARPS, MT, QREG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<DH, WARPS, MT, QREG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(H, (S + C::BQ - 1) / C::BQ, B);
  flash_kernel<DH, WARPS, MT, QREG><<<grid, C::NT, C::SMEM, st>>>(
      q, k, v, o, S, T, G, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11], scale, causal, window, lse);
  return cudaGetLastError();
}

// --- backward ----------------------------------------------------------------
//
// FlashAttention-2's backward in three launches, with no atomics (so a
// step repeats bit for bit): a row-dot pre-pass D = rowsum(dO o O); a dK/dV
// kernel, one block per (key tile, KV head, batch row), which walks the
// query tiles of the G heads of its group, recomputes P^T from K Q^T and
// the forward's log-sum-exp, and keeps dK and dV of its 64 keys in f32
// registers; and a dQ kernel, one block per (query tile, head, batch row),
// which walks the key tiles of the forward's range. Q K^T is recomputed in
// both. With P = exp(scale S - lse), dP = dO V^T, dS = P o (dP - D):
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, every product on
// mma.sync m16n8k16 (P and dS rounded to bf16 for it, as the forward's P),
// the mask the forward's without a window (causal or none): query row i
// sits at key i + T - S, and rows or keys past the true S and T count for
// nothing. The wrapper refuses a window.
//
// Bound: five (S, T, dh) products a head against q, k, v, o, dO read and
// dq, dk, dv written once (the pre-pass reads o and dO again): the tensor
// cores bound it at the training path's S = T = 512.

constexpr float LOG2E = 1.4426950408889634f;

// N element strides, passed to a kernel by value
template <int N>
struct Strides {
  long long v[N];
};

// D[r] = sum over dh of dO[r] * O[r] in f32, one warp a row r of B * H * S
__global__ void __launch_bounds__(256)
bwd_rowdot_kernel(const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ delta, int H, int S, int DH,
                  long long rows, long long osb, long long osh, long long oss,
                  long long dsb, long long dsh, long long dss) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < rows; r += nwarps) {
    const long long i = r % S, bh = r / S, hh = bh % H, bb = bh / H;
    const __nv_bfloat16* orow = o + bb * osb + hh * osh + i * oss;
    const __nv_bfloat16* drow = dout + bb * dsb + hh * dsh + i * dss;
    float acc = 0.f;
    for (int c = 2 * lane; c < DH; c += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + c));
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(drow + c));
      acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) delta[r] = acc;
  }
}

// dK/dV: 4 warps of 16 key rows (BK = 64 keys a block), BQ queries a step
template <int DH, int BQ>
struct BwdKV {
  static constexpr int BK = 64, NT = 128;
  // K, V, 2 stages of (Q, dO), 2 stages of (lse, D)
  static constexpr size_t SMEM = (size_t)(2 * BK + 4 * BQ) * (DH + 8) * 2 + 4 * BQ * 4;
};

template <int DH, int BQ>
__global__ void __launch_bounds__(128)
bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int H, int S, int T, int G, const __grid_constant__ Strides<18> st_,
                float scale, int causal) {
  using C = BwdKV<DH, BQ>;
  constexpr int BK = C::BK, NT = C::NT;
  constexpr int SROW = DH + 8, CH = DH / 8, KD = DH / 16, NS = BQ / 8, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BK * SROW;
  __nv_bfloat16* ring = vs + BK * SROW;              // stage st: Q, then dO
  float* stat = reinterpret_cast<float*>(ring + 4 * BQ * SROW);  // lse2, D

  // strides: q, k, v, dout, dk, dv, each (batch, head, position)
  const long long* s = st_.v;
  const int t0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3, wrow = warp * 16;
  const int off = T - S;
  const __nv_bfloat16* kb = k + b * s[3] + kvh * s[4];
  const __nv_bfloat16* vb = v + b * s[6] + kvh * s[7];

  for (int i = tid; i < BK * CH; i += NT) {
    const int r = i / CH, c = i % CH, t = t0 + r;
    const bool live = t < T;
    cp16(ks + r * SROW + c * 8, kb + (live ? (long long)t * s[5] + c * 8 : 0), live);
    cp16(vs + r * SROW + c * 8, vb + (live ? (long long)t * s[8] + c * 8 : 0), live);
  }
  // query rows that see a key of this tile: causal, from key t0's row
  const int q_lo = causal ? max(0, t0 - off) : 0;
  const int qs0 = q_lo / BQ * BQ;
  const int nq = S > q_lo ? (S - qs0 + BQ - 1) / BQ : 0;
  const int iters = G * nq;

  auto load_q = [&](int it, int st) {
    const int hh = kvh * G + it / nq, q0 = qs0 + (it % nq) * BQ;
    __nv_bfloat16* qd = ring + st * 2 * BQ * SROW;
    __nv_bfloat16* dd = qd + BQ * SROW;
    const __nv_bfloat16* qb = q + b * s[0] + hh * s[1];
    const __nv_bfloat16* db = dout + b * s[9] + hh * s[10];
    for (int i = tid; i < BQ * CH; i += NT) {
      const int r = i / CH, c = i % CH, row = q0 + r;
      const bool live = row < S;
      cp16(qd + r * SROW + c * 8, qb + (live ? (long long)row * s[2] + c * 8 : 0), live);
      cp16(dd + r * SROW + c * 8, db + (live ? (long long)row * s[11] + c * 8 : 0), live);
    }
    float* ls = stat + st * 2 * BQ;
    for (int i = tid; i < BQ; i += NT) {
      const int row = q0 + i;
      const long long idx = ((long long)b * H + hh) * S + row;
      ls[i] = row < S ? lse[idx] * LOG2E : INFINITY;   // P = 0 past S
      ls[BQ + i] = row < S ? delta[idx] : 0.f;
    }
  };
  if (iters > 0) load_q(0, 0);
  cp_commit();

  const float sl2 = scale * LOG2E;
  const int kp0 = t0 + wrow + g;                   // key of fragment row g
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int st = it & 1, q0 = qs0 + (it % nq) * BQ;
    cp_wait<0>();
    __syncthreads();   // step it is visible; every warp is done with it - 1
    if (it + 1 < iters) load_q(it + 1, st ^ 1);
    cp_commit();
    const __nv_bfloat16* qd = ring + st * 2 * BQ * SROW;
    const __nv_bfloat16* dd = qd + BQ * SROW;
    const float* ls = stat + st * 2 * BQ;
    const float* ds = ls + BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's key rows are A, the
    // query tile's rows B's columns (non-transposed ldmatrix)
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + (wrow + (lane & 15)) * SROW + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(va, vs + (wrow + (lane & 15)) * SROW + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        uint32_t bq[4], bd[4];
        const int o = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * SROW + kk * 16 +
                      ((lane >> 3) & 1) * 8;
        ldsm_x4(bq, qd + o);
        ldsm_x4(bd, dd + o);
        mma16816(sc[2 * jj], ka, bq[0], bq[1]);
        mma16816(sc[2 * jj + 1], ka, bq[2], bq[3]);
        mma16816(dp[2 * jj], va, bd[0], bd[1]);
        mma16816(dp[2 * jj + 1], va, bd[2], bd[3]);
      }
    }

    // P^T and dS^T; fragment value e of tile j is key row g + 8 (e / 2),
    // query column 8 j + 2 tg + (e & 1). Keys past T give rows never stored.
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kp0 + (e >> 1) * 8, col = j * 8 + 2 * tg + (e & 1);
        const int qp = q0 + col + off;
        const bool ok = !causal || kp <= qp;
        const float p = ok ? ex2(fmaf(sc[j][e], sl2, -ls[col])) : 0.f;
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ds[col]);
      }

    // dV += P^T dO, dK += dS^T Q: query tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk; dO and Q rows are B's k (transposed ldmatrix)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int jj = 0; jj < NO / 2; ++jj) {
        uint32_t bd[4], bq[4];
        const int o = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW + jj * 16 +
                      (lane >> 4) * 8;
        ldsm_x4_t(bd, dd + o);
        ldsm_x4_t(bq, qd + o);
        mma16816(dv_acc[2 * jj], pa, bd[0], bd[1]);
        mma16816(dv_acc[2 * jj + 1], pa, bd[2], bd[3]);
        mma16816(dk_acc[2 * jj], da, bq[0], bq[1]);
        mma16816(dk_acc[2 * jj + 1], da, bq[2], bq[3]);
      }
    }
  }

  // flush: each warp stages its 16 rows in its own rows of the K and V
  // tiles (no other warp reads them), then stores them with 16-byte writes
  cp_wait<0>();
  __syncthreads();
  __nv_bfloat16* sk = ks + wrow * SROW;
  __nv_bfloat16* sv = vs + wrow * SROW;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(sk + g * SROW + n * 8 + 2 * tg) =
        pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(sk + (g + 8) * SROW + n * 8 + 2 * tg) =
        pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
    *reinterpret_cast<uint32_t*>(sv + g * SROW + n * 8 + 2 * tg) =
        pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(sv + (g + 8) * SROW + n * 8 + 2 * tg) =
        pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, t = t0 + wrow + r;
    if (t < T) {
      *reinterpret_cast<uint4*>(dk + b * s[12] + kvh * s[13] + (long long)t * s[14] + c * 8) =
          *reinterpret_cast<const uint4*>(sk + r * SROW + c * 8);
      *reinterpret_cast<uint4*>(dv + b * s[15] + kvh * s[16] + (long long)t * s[17] + c * 8) =
          *reinterpret_cast<const uint4*>(sv + r * SROW + c * 8);
    }
  }
}

// dQ: 4 warps of 16 query rows (BQ = 64 rows a block), BK keys a tile
template <int DH>
struct BwdQ {
  static constexpr int BQ = 64, BK = 64, NT = 128;
  // Q, dO, 2 stages of (K, V)
  static constexpr size_t SMEM = (size_t)(2 * BQ + 4 * BK) * (DH + 8) * 2;
};

template <int DH>
__global__ void __launch_bounds__(128)
bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int T, int G,
              const __grid_constant__ Strides<15> st_, float scale, int causal) {
  using C = BwdQ<DH>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT;
  constexpr int SROW = DH + 8, CH = DH / 8, KD = DH / 16, NS = BK / 8, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + BQ * SROW;
  __nv_bfloat16* ring = dos + BQ * SROW;             // stage st: K, then V

  // strides: q, k, v, dout, dq, each (batch, head, position)
  const long long* s = st_.v;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most causal work first
  const int h = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3, wrow = warp * 16;
  const int off = T - S;
  const __nv_bfloat16* qb = q + b * s[0] + h * s[1];
  const __nv_bfloat16* kb = k + b * s[3] + (h / G) * s[4];
  const __nv_bfloat16* vb = v + b * s[6] + (h / G) * s[7];
  const __nv_bfloat16* db = dout + b * s[9] + h * s[10];

  // the forward's key range
  const int last_row = min(q0 + BQ, S) - 1;
  const int kv_hi = causal ? min(T, last_row + off + 1) : T;
  const int ntiles = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;

  auto load_kv = [&](int t0, int st) {
    __nv_bfloat16* kd = ring + st * 2 * BK * SROW;
    __nv_bfloat16* vd = kd + BK * SROW;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH, t = t0 + r;
      const bool live = t < T;
      cp16(kd + r * SROW + c * 8, kb + (live ? (long long)t * s[5] + c * 8 : 0), live);
      cp16(vd + r * SROW + c * 8, vb + (live ? (long long)t * s[8] + c * 8 : 0), live);
    }
  };
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = q0 + r;
    const bool live = row < S;
    cp16(qs + r * SROW + c * 8, qb + (live ? (long long)row * s[2] + c * 8 : 0), live);
    cp16(dos + r * SROW + c * 8, db + (live ? (long long)row * s[11] + c * 8 : 0), live);
  }
  if (ntiles > 0) load_kv(0, 0);
  cp_commit();

  const float sl2 = scale * LOG2E;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    const long long idx = ((long long)b * gridDim.x + h) * S + row;
    lse2[r] = row < S ? lse[idx] * LOG2E : INFINITY;
    dd[r] = row < S ? delta[idx] : 0.f;
  }
  const int qp0 = q0 + wrow + g + off;
  float dq_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * BK, st = it & 1;
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_kv(t0 + BK, st ^ 1);
    cp_commit();
    const __nv_bfloat16* kd = ring + st * 2 * BK * SROW;
    const __nv_bfloat16* vd = kd + BK * SROW;

    // S = Q K^T and dP = dO V^T: K and V rows are B's columns
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, qs + (wrow + (lane & 15)) * SROW + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(da, dos + (wrow + (lane & 15)) * SROW + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        uint32_t bk[4], bv[4];
        const int o = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * SROW + kk * 16 +
                      ((lane >> 3) & 1) * 8;
        ldsm_x4(bk, kd + o);
        ldsm_x4(bv, vd + o);
        mma16816(sc[2 * jj], qa, bk[0], bk[1]);
        mma16816(sc[2 * jj + 1], qa, bk[2], bk[3]);
        mma16816(dp[2 * jj], da, bv[0], bv[1]);
        mma16816(dp[2 * jj + 1], da, bv[2], bv[3]);
      }
    }

    // dS = P o (dP - D): value e of tile j is row g + 8 (e / 2), key
    // 8 j + 2 tg + (e & 1)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + j * 8 + 2 * tg + (e & 1), r = e >> 1;
        const int qp = qp0 + 8 * r;
        bool ok = kp < T;
        if (causal) ok = ok && kp <= qp;
        const float p = ok ? ex2(fmaf(sc[j][e], sl2, -lse2[r])) : 0.f;
        sc[j][e] = p * (dp[j][e] - dd[r]);
      }

    // dQ += dS K: key tiles 2kk, 2kk + 1 are the A fragment of k-step kk;
    // K rows are B's k (transposed ldmatrix)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int jj = 0; jj < NO / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kd + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW +
                          jj * 16 + (lane >> 4) * 8);
        mma16816(dq_acc[2 * jj], pa, bk[0], bk[1]);
        mma16816(dq_acc[2 * jj + 1], pa, bk[2], bk[3]);
      }
    }
  }

  // flush through the warp's own rows of the Q tile, as the forward's
  cp_wait<0>();
  __syncthreads();
  __nv_bfloat16* stage = qs + wrow * SROW;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * SROW + n * 8 + 2 * tg) =
        pack_bf16(dq_acc[n][0] * scale, dq_acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * SROW + n * 8 + 2 * tg) =
        pack_bf16(dq_acc[n][2] * scale, dq_acc[n][3] * scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, row = q0 + wrow + r;
    if (row < S)
      *reinterpret_cast<uint4*>(dq + b * s[12] + h * s[13] + (long long)row * s[14] + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * SROW + c * 8);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  configured = e == cudaSuccess;
  return e;
}

template <int DH, int BQ>
cudaError_t launch_dkdv(int B, int KV, cudaStream_t st, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int S, int T, int G,
                        const long long* strides, float scale, int causal) {
  using C = BwdKV<DH, BQ>;
  static bool configured = false;
  cudaError_t e = allow_smem(bwd_dkdv_kernel<DH, BQ>, C::SMEM, configured);
  if (e != cudaSuccess) return e;
  Strides<18> sv;
  for (int i = 0; i < 18; ++i) sv.v[i] = strides[i];
  const dim3 grid((T + C::BK - 1) / C::BK, KV, B);
  bwd_dkdv_kernel<DH, BQ><<<grid, C::NT, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      KV * G, S, T, G, sv, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(int B, int H, cudaStream_t st, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int S, int T, int G,
                      const long long* strides, float scale, int causal) {
  using C = BwdQ<DH>;
  static bool configured = false;
  cudaError_t e = allow_smem(bwd_dq_kernel<DH>, C::SMEM, configured);
  if (e != cudaSuccess) return e;
  Strides<15> sv;
  for (int i = 0; i < 15; ++i) sv.v[i] = strides[i];
  const dim3 grid(H, (S + C::BQ - 1) / C::BQ, B);
  bwd_dq_kernel<DH><<<grid, C::NT, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, static_cast<__nv_bfloat16*>(dq), S, T, G, sv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). ``strides`` holds 12
// element strides: (batch, head, position) for q, k, v and out in turn.
// ``lse`` (B, H, S) f32, or null: each row's natural-log sum of exp(scale
// q.k) over its visible keys (+inf where none), which the backward reads.
// DH in {64, 128}; the Python wrapper checks shapes and alignment first.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int H, int S, int T, int G, int DH, const long long* strides,
    float scale, int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  if (DH == 128) return launch<128, 8, 1, true>(B, H, st, qp, kp, vp, op, S, T, G, strides, scale, causal, window, lp);
  if (DH == 64) return launch<64, 4, 2, false>(B, H, st, qp, kp, vp, op, S, T, G, strides, scale, causal, window, lp);
  return cudaErrorInvalidValue;
}

// The backward's three launches, in order. ``s`` holds element strides
// (batch, head, position) of each tensor named, in the order named. ``lse``
// is the forward's, ``delta`` (B, H, S) f32 the pre-pass's output.

// D = rowsum(dO o O): strides of o, dout (host array of 6).
extern "C" int flash_attention_bwd_rowdot(
    const void* o, const void* dout, void* delta, int B, int H, int S, int DH,
    const long long* s, void* stream) {
  const long long rows = (long long)B * H * S;
  const long long blocks = std::min<long long>((rows + 7) / 8, 132 * 16);
  bwd_rowdot_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), H, S, DH, rows, s[0], s[1], s[2], s[3], s[4], s[5]);
  return cudaGetLastError();
}

// dK, dV: strides of q, k, v, dout, dk, dv (18).
extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int KV, int S, int T, int G, int DH,
    const long long* s, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(delta);
  if (DH == 128) return launch_dkdv<128, 32>(B, KV, st, q, k, v, dout, l, d, dk, dv, S, T, G, s, scale, causal);
  if (DH == 64) return launch_dkdv<64, 64>(B, KV, st, q, k, v, dout, l, d, dk, dv, S, T, G, s, scale, causal);
  return cudaErrorInvalidValue;
}

// dQ: strides of q, k, v, dout, dq (15).
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int H, int S, int T, int G, int DH,
    const long long* s, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(delta);
  if (DH == 128) return launch_dq<128>(B, H, st, q, k, v, dout, l, d, dq, S, T, G, s, scale, causal);
  if (DH == 64) return launch_dq<64>(B, H, st, q, k, v, dout, l, d, dq, S, T, G, s, scale, causal);
  return cudaErrorInvalidValue;
}
