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

// --- backward ----------------------------------------------------------------
//
// FlashAttention-2's backward in three launches, with no atomics (so a
// step repeats bit for bit): a row-dot pre-pass D = rowsum(dO o O); a dK/dV
// kernel, whose blocks own key tiles of a KV head and batch row and walk
// the (64-row query tile, head) items of the G heads of the group,
// recomputing P^T from K Q^T and the forward's log-sum-exp and keeping dK
// and dV of their keys in f32 registers; and a dQ kernel, one block per
// (128 query rows, head, batch row), which walks the key tiles of the
// forward's range. Q K^T and dO V^T are recomputed in both (seven products
// instead of five: the price of no atomics). With P = exp(scale S - lse),
// dP = dO V^T, dS = P o (dP - D): dV = P^T dO, dK = scale dS^T Q, dQ = scale
// dS K; the mask is the forward's without a window (causal or none): query
// row i sits at key i + T - S, and rows or keys past the true S and T
// count for nothing. The wrapper refuses a window.
//
// The kernels are Hopper's: a producer warp loads every tile by TMA into
// a ring of stages guarded by mbarriers, and two consumer warpgroups
// multiply on wgmma (bf16 in, f32 accumulate), with registers moved from
// the producer's warpgroup to theirs by setmaxnreg. Every tile is 64 rows
// of a (batch, head, position, dh) view, landed as dh / 64 boxes of (64
// rows, 64 columns) under the 128-byte swizzle through a 5-D tensor map
// over the view's own strides (rows past S or T read as zeros). The same
// tile serves as a K-major operand (its rows along M or N) and as an
// MN-major one (its rows along K: wgmma transposes 16-bit operands
// itself), so no operand is copied or transposed by hand. Q K^T and dO V^T
// run with both operands in shared memory; P and dS are formed in the
// accumulator registers, rounded to bf16 (as the forward's P) and fed
// from there as the A operand of the products that follow (dV += P^T dO,
// dK += dS^T Q, dQ += dS K). The wgmma pipeline has to fit the kernel's
// 168 registers a thread, whatever setmaxnreg gives the consumers, or
// ptxas serializes every wgmma; so at dh 128 the dK/dV kernel splits dK
// and dV by columns between its warpgroups (bwd_dkdv_halves_kernel), and
// at dh 64 by keys (bwd_dkdv64_kernel). Every sum runs in a
// fixed order. The results are rounded into shared memory with stmatrix
// and stored by TMA, which clips at S or T.
//
// Bound: five (S, T, dh) products a head against q, k, v, o, dO read and
// dq, dk, dv written once (the pre-pass reads o and dO again): device
// memory bounds the training path's S = T = 512 (about 160 FLOPs a byte
// over the visible pairs, below the card's ~295), the tensor cores
// whisper's 448 x 1,500 cross attention.

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BWD_CONSUMERS = 256;                  // two warpgroups
constexpr int BWD_THREADS = BWD_CONSUMERS + 128;    // + the producer's warpgroup
constexpr int BWD_BOX = 64 * 128;                   // a (64 rows, 64 columns) box
constexpr int BWD_STAGES = 4;

// Shared memory, after 1,024 bytes of alignment slack; a tile is 64 rows
// of DH columns. A dK/dV stage holds a Q tile, a dO tile and their 64 lse
// and 64 D values (in 1,024 bytes); a dQ stage a K and a V tile. Then the
// barriers: full[s] and empty[s] of the stages, and those of the tiles a
// block loads once (dK/dV at DH 64: one) or double-buffers (two full, two
// empty).
//   dK/dV at DH 64: K and V (two tiles each: 128 keys), 4 stages.
//   dK/dV at DH 128: two buffers of (K, V), 3 stages, and two buffers of
//     the two warpgroups' A fragments (16 registers a thread each).
//   dQ: two buffers of (two Q tiles, two dO tiles), 3 stages.
template <int DH>
struct Bwd {
  static constexpr int TILE = DH / 64 * BWD_BOX;
  static constexpr int KV_STAGE = 2 * TILE + 1024;
  static constexpr int Q_STAGE = 2 * TILE;
  static constexpr int KV_SMEM = 1024 + 4 * TILE + BWD_STAGES * KV_STAGE + 8 * (2 * BWD_STAGES + 1);
  static constexpr int XCHG = 2 * 16 * 128 * 4;
  static constexpr int HALVES_STAGES = 3;
  static constexpr int HALVES_SMEM =
      1024 + 4 * TILE + HALVES_STAGES * KV_STAGE + 2 * XCHG + 8 * (2 * HALVES_STAGES + 4);
  static constexpr int Q_STAGES = 3;
  static constexpr int Q_SMEM = 1024 + 8 * TILE + Q_STAGES * Q_STAGE + 8 * (2 * Q_STAGES + 4);
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448 && HALVES_SMEM <= 232448,
                "shared memory");
};

// D[r] = sum over dh of dO[r] * O[r] in f32, for rows r of B * H * S: DH / 8
// lanes a row, each loading 16 bytes of O and of dO, so a warp takes 32 /
// (DH / 8) rows at a time and a row's sum is a few shuffles
template <int DH>
__global__ void __launch_bounds__(256)
bwd_rowdot_kernel(const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ delta, int H, int S, long long rows,
                  long long osb, long long osh, long long oss,
                  long long dsb, long long dsh, long long dss) {
  constexpr int LPR = DH / 8, RPW = 32 / LPR;
  const int lane = threadIdx.x & 31, c = (lane % LPR) * 8;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       w * RPW < rows; w += warps) {
    const long long r = w * RPW + lane / LPR;
    float acc = 0.f;
    if (r < rows) {
      const long long i = r % S, bh = r / S, hh = bh % H, bb = bh / H;
      const uint4 a = *reinterpret_cast<const uint4*>(o + bb * osb + hh * osh + i * oss + c);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + bb * dsb + hh * dsh + i * dss + c);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // bf16 pairs: the low half first
        acc = fmaf(__uint_as_float(av[e] << 16), __uint_as_float(dv[e] << 16), acc);
        acc = fmaf(__uint_as_float(av[e] & 0xffff0000u),
                   __uint_as_float(dv[e] & 0xffff0000u), acc);
      }
    }
#pragma unroll
    for (int m = LPR / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane % LPR == 0 && r < rows) delta[r] = acc;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// the bytes the phase's copies will bring, without an arrival
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`; a
// copy that never lands (a bad tensor map) traps after some seconds of
// polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}
// one box of a 5-D tensor map at element coordinates (c0 inner .. c4 outer)
__device__ __forceinline__ void tma5d(uint32_t dst, const CUtensorMap* map, int c0,
                                      int c1, int c2, int c3, int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(c4), "r"(bar) : "memory");
}
// one shared-memory box to a 5-D tensor map's box; elements outside the
// tensor are not written
__device__ __forceinline__ void tma5d_store(const CUtensorMap* map, uint32_t src, int c0,
                                            int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(c4) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // its shared memory read
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {   // read and written
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// four 8 x 8 bf16 matrices from a warp's registers: lane l gives the
// address of row l % 8 of matrix l / 8, and register i of lane l holds
// row l / 4, columns 2 (l % 4) and + 1 of matrix i (mma's fragment)
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}
__device__ __forceinline__ void consumers_sync() {   // the 8 consumer warps
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void group_sync(int wg) {  // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}
// generic-proxy stores to shared memory, ordered before the async proxy's
// (wgmma's, TMA's) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
// The descriptor of a bf16 (64 rows, 64 columns) box under the 128-byte
// swizzle (1,024-byte atoms of eight 128-byte rows), 8-row groups 1,024
// bytes apart; no operand spans two boxes, so the leading offset is
// unused. K-major (rows along M or N): a k step of 16 columns starts 32
// bytes further. MN-major (rows along K): a k step of 16 rows starts
// 2,048 bytes further.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x N f32; N / 2 a thread: value 4j + 2h + i is row 16 w + g + 8h
// of the warpgroup's 64, column 8j + 2t + i, for warp w, g = lane / 4, t =
// lane % 4) += a (64 x 16) . b (16 x N), bf16; scale_d 0 drops d's old
// value. ss: a and b in shared memory by descriptor, both K-major. rs: a
// in registers (a warp's 16 rows as mma.sync's A fragment: registers 0-3
// hold k pair (2t, 2t + 1) of rows g and g + 8, then pair (2t + 8, 2t + 9)
// of both), b by descriptor, MN-major.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss32(d, desc_a, desc_b, scale_d);
  else wgmma_ss64(d, desc_a, desc_b, scale_d);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their other uses across this point nor give their
// physical registers to other values while they are live.
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int C> __device__ __forceinline__ void pin(float (&r)[C][32]) {
#pragma unroll
  for (int c = 0; c < C; ++c) pin(r[c]);
}
template <int K> __device__ __forceinline__ void pin(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i) asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
}

// S (64 x N, f32 in the accumulators) = A B^T over the tiles' DH columns:
// the A tile's 64 rows (M) against N rows of the B tile from `b` on, both
// K-major, each DH / 64 boxes; committed as one group, not waited for
template <int DH, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<N>(d, desc_sw128(a + (kk >> 2) * BWD_BOX + (kk & 3) * 32),
                desc_sw128(b + (kk >> 2) * BWD_BOX + (kk & 3) * 32), kk > 0);
  wgmma_commit();
}
// d (64 x DH, as DH / 64 accumulators of 64 columns, one a box) += the A
// operand in registers (64 x 16 KS: a k step of 16 a register quad) . KS k
// steps of the tile from `b` on (rows along K, DH columns along N:
// MN-major); not committed
template <int DH, int KS>
__device__ __forceinline__ void product_rs(float (&d)[DH / 64][32],
                                           const uint32_t (&a)[KS][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int c = 0; c < DH / 64; ++c)
      wgmma_rs64(d[c], a[kk], desc_sw128(b + c * BWD_BOX + kk * 2048), 1);
}
// The accumulators' N columns as the A operand of a product whose K runs
// along them: k step kk holds columns 16 kk + 2t, + 1 (accumulator block
// 2 kk) and + 8 (block 2 kk + 1) of rows g and g + 8, rounded to bf16.
template <int N>
__device__ __forceinline__ void as_a(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// A warpgroup's 64 x 64 f32 accumulators times `mul`, rounded to bf16 into
// the swizzled (64 rows, 64 columns) box at `box` by stmatrix. `wt` is the
// thread's index in its warpgroup.
__device__ __forceinline__ void stage_box(const float (&acc)[32], float mul, uint32_t box,
                                          int wt) {
  const int lane = wt & 31;
  // lane l addresses row l % 8 (+ 8 for matrices 1 and 3) of the warp's
  // 16, 16-byte chunk 2i + l / 16 of the box, swizzled by the row
  const int row = 16 * (wt >> 5) + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int chunk = 2 * i + (lane >> 4);         // n8 blocks 2i and 2i + 1
    stmatrix_x4(box + row * 128 + ((chunk ^ (row & 7)) << 4),
                pack_bf16(acc[8 * i] * mul, acc[8 * i + 1] * mul),
                pack_bf16(acc[8 * i + 2] * mul, acc[8 * i + 3] * mul),
                pack_bf16(acc[8 * i + 4] * mul, acc[8 * i + 5] * mul),
                pack_bf16(acc[8 * i + 6] * mul, acc[8 * i + 7] * mul));
  }
}

// A warpgroup's 64 x 64 f32 accumulators times `mul` into the box at
// `box` (stage_box), then stored by one thread with one TMA store at row
// `row0` of (head, b), which clips at the view's rows
__device__ __forceinline__ void flush(const float (&acc)[32], float mul, uint32_t box,
                                      const CUtensorMap* map, int row0, int head, int b,
                                      int wg, int wt) {
  stage_box(acc, mul, box, wt);
  fence_proxy_async();
  group_sync(wg);
  if (wt == 0) {
    tma5d_store(map, box, 0, row0, 0, head, b);
    bulk_commit();
    bulk_wait_all();
  }
}

// A dK/dV producer's item: the Q and dO tiles of rows [q0, q0 + 64) of
// head hh by TMA into the stage at `st` (tiles `tile` bytes apart), then
// the rows' lse (in log2 units; +inf past S, so P = 0 there) and D after
// them, two rows a lane; every lane of the warp arrives on `bar`, which
// counts 32 and the copies' bytes.
template <typename Gen>
__device__ __forceinline__ void load_item(uint32_t st, int tile, uint32_t bar,
                                          const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                          Gen gen, const float* __restrict__ lse,
                                          const float* __restrict__ delta, int q0, int hh,
                                          int b, int H, int S, int lane) {
  if (lane == 0) {
    mbar_expect(bar, 2 * tile);
    tma5d(st, tm_q, 0, q0, 0, hh, b, bar);
    tma5d(st + tile, tm_do, 0, q0, 0, hh, b, bar);
  }
  float* stat = reinterpret_cast<float*>(gen(st + 2 * tile));
  for (int r = lane; r < 64; r += 32) {
    const int row = q0 + r;
    const long long idx = ((long long)b * H + hh) * S + row;
    stat[r] = row < S ? lse[idx] * LOG2E : INFINITY;
    stat[64 + r] = row < S ? delta[idx] : 0.f;
  }
  mbar_arrive(bar);
}

// dK/dV at DH 64: block (KV head, batch row, 128-key tile). Its items are
// the (head of the group, 64-row query tile) pairs that see one of its
// keys, head by head; warpgroup wg owns keys [64 wg, 64 wg + 64) and both
// walk every item. Keys (rows of S^T) are the accumulator rows, query
// rows its columns. dK and dV take 64 registers a thread together, which
// leaves the wgmma pipeline room.
__global__ void __launch_bounds__(BWD_THREADS, 1)
bwd_dkdv64_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_dk,
                  const __grid_constant__ CUtensorMap tm_dv,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  int H, int S, int T, int G, float scale, int causal) {
  constexpr int DH = 64;
  using C = Bwd<DH>;
  constexpr int NS = BWD_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // the swizzle's period
  auto gen = [&](uint32_t a) { return smem_raw + (a - raw); };
  const uint32_t ks = base, vs = base + 2 * C::TILE, ring = base + 4 * C::TILE;
  const uint32_t bars = ring + NS * C::KV_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  const uint32_t once = bars + 16 * NS;

  const int kvh = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = T - S;
  // query rows that see a key of this tile: causal, from key t0's row
  const int q_lo = causal ? max(0, t0 - off) : 0;
  const int qs0 = q_lo / 64 * 64;
  const int nq = S > q_lo ? (S - qs0 + 63) / 64 : 0;
  const int iters = G * nq;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 32);          // the producer's lanes
      mbar_init(empty(s), BWD_CONSUMERS / 32);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= BWD_CONSUMERS / 32) {
    // producer: one warp; lane 0 issues the copies, every lane writes two
    // rows' lse (in log2 units; +inf past S, so P = 0 there) and D
    regs_dec<40>();
    if (warp != BWD_CONSUMERS / 32) return;
    if (lane == 0) {
      mbar_expect_tx(once, 4 * C::TILE);
      for (int i = 0; i < 2; ++i) {
        tma5d(ks + i * C::TILE, &tm_k, 0, t0 + 64 * i, 0, kvh, b, once);
        tma5d(vs + i * C::TILE, &tm_v, 0, t0 + 64 * i, 0, kvh, b, once);
      }
    }
    for (int it = 0; it < iters; ++it) {
      const int s = it % NS, hh = kvh * G + it / nq, q0 = qs0 + (it % nq) * 64;
      if (it >= NS) mbar_wait(empty(s), (it / NS - 1) & 1);
      load_item(ring + s * C::KV_STAGE, C::TILE, full(s), &tm_q, &tm_do, gen, lse, delta,
                q0, hh, b, H, S, lane);
    }
  } else {
    regs_inc<232>();
    const int wg = warp >> 2, wt = tid & 127, tq = lane & 3;
    const int k0 = t0 + 64 * wg;                           // the warpgroup's keys
    const uint32_t kw = ks + wg * C::TILE, vw = vs + wg * C::TILE;
    const int kp0 = k0 + 16 * (warp & 3) + (lane >> 2);   // key of row g
    const float sl2 = scale * LOG2E;
    float dk[1][32] = {}, dv[1][32] = {};
    mbar_wait(once, 0);
    for (int it = 0; it < iters; ++it) {
      const int s = it % NS, q0 = qs0 + (it % nq) * 64;
      mbar_wait(full(s), (it / NS) & 1);
      const uint32_t qt = ring + s * C::KV_STAGE, dot = qt + C::TILE;
      const float* stat = reinterpret_cast<const float*>(gen(qt + 2 * C::TILE));
      // S^T = K Q^T and dP^T = V dO^T in two groups (zeroed: the first k
      // step drops them, but its asm reads them)
      float sc[32] = {}, dp[32] = {};
      pin(dk);
      pin(dv);
      wgmma_fence();
      product_ss<DH, 64>(sc, kw, qt);
      product_ss<DH, 64>(dp, vw, dot);
      wgmma_wait<1>();
      pin(sc);
      // P^T; value 4j + 2h + i is key kp0 + 8h, query q0 + 8j + 2tq + i.
      // Keys past T give rows never stored; they are masked all the same.
      const bool edge = k0 + 64 > T || (causal && k0 + 63 > q0 + off);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int kp = kp0 + 8 * (e >> 1), qp = q0 + 8 * j + 2 * tq + (e & 1) + off;
            if (kp >= T || (causal && kp > qp)) p = 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
      wgmma_wait<0>();                 // dP^T is done
      pin(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(stat + 64 + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      // dV += P^T dO and dK += dS^T Q, both as A operands in registers
      uint32_t pa[4][4], da[4][4];
      as_a<64>(sc, pa);
      as_a<64>(dp, da);
      wgmma_fence();
      product_rs<DH, 4>(dv, pa, dot);
      product_rs<DH, 4>(dk, da, qt);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dk);
      pin(dv);
      pin(pa);
      pin(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    if (k0 < T) {
      // each warpgroup its own keys, into its own K and V tiles (read by
      // its wgmmas alone)
      flush(dk[0], scale, kw, &tm_dk, k0, kvh, b, wg, wt);
      flush(dv[0], 1.f, vw, &tm_dv, k0, kvh, b, wg, wt);
    }
  }
}

// dK/dV at DH 128 in halves, persistent: the (64-key tile, KV head, batch
// row) work tiles are listed key tiles innermost, so that the blocks at
// work at once share the Q and dO of a few (KV head, batch row) groups in
// L2, and dealt to the blocks in snake order, round r giving block i tile
// r gridDim.x + i (r even) or + gridDim.x - 1 - i (r odd), which spreads
// the costly tiles (under the causal mask the first key tiles of a group)
// evenly; its items are bwd_dkdv64_kernel's. Both warpgroups take every
// item over the tile's 64 keys: warpgroup w forms S^T, dP^T, P^T and dS^T
// for the item's query rows [32 w, 32 w + 32) and owns columns [64 w, 64 w
// + 64) of dK and dV.
// The two swap their P^T and dS^T A fragments (bf16) through shared
// memory, one barrier an item, and each then runs all 64 query rows into
// its halves, its own rows first. So a warpgroup holds 64 accumulator
// registers of dK and dV instead of 128: with both whole, the wgmma
// pipeline does not fit the kernel's registers and ptxas serializes every
// wgmma. K and V are double-buffered: the next tile's load and the
// current tile's flush (which stages dK and dV in its K and V buffers)
// overlap the items, which stream through one ring across tiles.
template <int DH>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bwd_dkdv_halves_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dk,
                       const __grid_constant__ CUtensorMap tm_dv,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       int B, int KV, int S, int T, int G, float scale, int causal) {
  static_assert(DH == 128, "two 64-column halves");
  using C = Bwd<DH>;
  constexpr int NS = C::HALVES_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // the swizzle's period
  auto gen = [&](uint32_t a) { return smem_raw + (a - raw); };
  // K and V of buffer kb at base + 2 kb TILE and + TILE
  const uint32_t ring = base + 4 * C::TILE;
  const uint32_t xchg = ring + NS * C::KV_STAGE;
  const uint32_t bars = xchg + 2 * C::XCHG;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  auto kv_full = [&](int kb) { return bars + 8 * (2 * NS + kb); };
  auto kv_empty = [&](int kb) { return bars + 8 * (2 * NS + 2 + kb); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KV * G, off = T - S;
  const int ntiles = (T + 63) / 64 * KV * B;
  // a work tile's keys [t0, t0 + 64) of (kvh, b), and its items: the query
  // tiles from the first that sees key t0 (causal), for each head
  struct Tile {
    int t0, kvh, b, qs0, nq;
  };
  auto tile_of = [&](int t) {
    Tile x;
    const int nz = (T + 63) / 64, g = t / nz;
    x.t0 = t % nz * 64;
    x.kvh = g % KV;
    x.b = g / KV;
    const int q_lo = causal ? max(0, x.t0 - off) : 0;
    x.qs0 = q_lo / 64 * 64;
    x.nq = S > q_lo ? (S - x.qs0 + 63) / 64 : 0;
    return x;
  };
  auto snake = [&](int r) {
    return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 32);          // the producer's lanes
      mbar_init(empty(s), BWD_CONSUMERS / 32);
    }
    for (int kb = 0; kb < 2; ++kb) {
      mbar_init(kv_full(kb), 1);
      mbar_init(kv_empty(kb), 1);      // the flush's store has read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= BWD_CONSUMERS / 32) {
    // producer: one warp; lane 0 issues the copies, every lane writes two
    // rows' lse (in log2 units; +inf past S, so P = 0 there) and D
    regs_dec<40>();
    if (warp != BWD_CONSUMERS / 32) return;
    int it = 0;                        // ring uses so far
    for (int r = 0, n = 0; r * (int)gridDim.x < ntiles; ++r) {
      const int t = snake(r);
      if (t >= ntiles) continue;
      const Tile x = tile_of(t);
      const int u = n++, kb = u & 1;   // this block's u-th tile
      if (lane == 0) {
        if (u >= 2) mbar_wait(kv_empty(kb), ((u >> 1) - 1) & 1);
        mbar_expect_tx(kv_full(kb), 2 * C::TILE);
        tma5d(base + 2 * kb * C::TILE, &tm_k, 0, x.t0, 0, x.kvh, x.b, kv_full(kb));
        tma5d(base + (2 * kb + 1) * C::TILE, &tm_v, 0, x.t0, 0, x.kvh, x.b, kv_full(kb));
      }
      for (int i = 0; i < G * x.nq; ++i, ++it) {
        const int s = it % NS, hh = x.kvh * G + i / x.nq, q0 = x.qs0 + (i % x.nq) * 64;
        if (it >= NS) mbar_wait(empty(s), (it / NS - 1) & 1);
        load_item(ring + s * C::KV_STAGE, C::TILE, full(s), &tm_q, &tm_do, gen, lse, delta,
                  q0, hh, x.b, H, S, lane);
      }
    }
  } else {
    regs_inc<232>();
    const int w = warp >> 2, wt = tid & 127, tq = lane & 3;
    const float sl2 = scale * LOG2E;
    uint32_t* xg = reinterpret_cast<uint32_t*>(gen(xchg));
    int it = 0;
    for (int r = 0, n = 0; r * (int)gridDim.x < ntiles; ++r) {
      const int t = snake(r);
      if (t >= ntiles) continue;
      const Tile x = tile_of(t);
      const int u = n++, kb = u & 1;
      const uint32_t ks = base + 2 * kb * C::TILE, vs = ks + C::TILE;
      const int kp0 = x.t0 + 16 * (warp & 3) + (lane >> 2);   // key of row g
      float dk[32] = {}, dv[32] = {};                       // columns [64 w, + 64)
      mbar_wait(kv_full(kb), (u >> 1) & 1);
      for (int i = 0; i < G * x.nq; ++i, ++it) {
        const int s = it % NS, q0 = x.qs0 + (i % x.nq) * 64;
        mbar_wait(full(s), (it / NS) & 1);
        const uint32_t qt = ring + s * C::KV_STAGE, dot = qt + C::TILE;
        const float* stat = reinterpret_cast<const float*>(gen(qt + 2 * C::TILE)) + 32 * w;
        // the warpgroup's 32 query rows: S^T = K Q^T and dP^T = V dO^T
        // (zeroed: the first k step drops them, but its asm reads them)
        float sc[16] = {}, dp[16] = {};
        pin(dk);
        pin(dv);
        wgmma_fence();
        product_ss<DH, 32>(sc, ks, qt + w * 32 * 128);
        product_ss<DH, 32>(dp, vs, dot + w * 32 * 128);
        wgmma_wait<1>();
        pin(sc);
        // value 4j + 2h + i is key kp0 + 8h, query q0 + 32 w + 8j + 2tq + i
        const bool edge = x.t0 + 64 > T || (causal && x.t0 + 63 > q0 + 32 * w + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(sc[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int kp = kp0 + 8 * (e >> 1);
              const int qp = q0 + 32 * w + 8 * j + 2 * tq + (e & 1) + off;
              if (kp >= T || (causal && kp > qp)) p = 0.f;
            }
            sc[4 * j + e] = p;
          }
        }
        wgmma_wait<0>();
        pin(dp);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(stat + 64 + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        uint32_t pa[2][4], da[2][4], pb[2][4], db[2][4];   // mine, the other's
        as_a<32>(sc, pa);
        as_a<32>(dp, da);
        // swap: this warpgroup's fragments into its half of buffer it % 2,
        // the other's out of the other half
        uint32_t* mine = xg + ((it & 1) * 2 + w) * 16 * 128 + wt;
        const uint32_t* theirs = xg + ((it & 1) * 2 + (w ^ 1)) * 16 * 128 + wt;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          mine[r * 128] = pa[r / 4][r % 4];
          mine[(8 + r) * 128] = da[r / 4][r % 4];
        }
        consumers_sync();
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          pb[r / 4][r % 4] = theirs[r * 128];
          db[r / 4][r % 4] = theirs[(8 + r) * 128];
        }
        // dV += P^T dO and dK += dS^T Q over all 64 rows into this
        // warpgroup's columns (box w): its own rows [32 w, + 32), then the
        // other's [32 (1 - w), + 32)
        const uint32_t own = w * 32 * 128, other = (w ^ 1) * 32 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wgmma_rs64(dv, pa[kk], desc_sw128(dot + w * BWD_BOX + own + kk * 2048), 1);
          wgmma_rs64(dk, da[kk], desc_sw128(qt + w * BWD_BOX + own + kk * 2048), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wgmma_rs64(dv, pb[kk], desc_sw128(dot + w * BWD_BOX + other + kk * 2048), 1);
          wgmma_rs64(dk, db[kk], desc_sw128(qt + w * BWD_BOX + other + kk * 2048), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(dk);
        pin(dv);
        pin(pa);
        pin(da);
        pin(pb);
        pin(db);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
      // both warpgroups are done with this K and V: each stages its halves
      // of dK and dV into box w of them, and one thread stores both and
      // frees the buffer once the store has read it
      consumers_sync();
      stage_box(dk, scale, ks + w * BWD_BOX, wt);
      stage_box(dv, 1.f, vs + w * BWD_BOX, wt);
      fence_proxy_async();
      consumers_sync();
      if (tid == 0) {
        tma5d_store(&tm_dk, ks, 0, x.t0, 0, x.kvh, x.b);
        tma5d_store(&tm_dv, vs, 0, x.t0, 0, x.kvh, x.b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(kv_empty(kb));
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// dQ, persistent: the (128-row query tile, head, batch row) work tiles
// are listed (head, batch row) outermost, so that the blocks at work at
// once share the K and V of a few groups in L2, and a group's query tiles
// last first (under the causal mask they carry the most work); they are
// dealt in bwd_dkdv_halves_kernel's snake order. Warpgroup wg owns rows
// [64 wg, 64 wg + 64) of a tile and both walk the forward's key range, 64
// keys a stage, through one ring across tiles. Q and dO are
// double-buffered: the next tile's load overlaps the current tile's items
// and flush, which stages dQ in its Q buffer. Query rows are the
// accumulator rows, keys its columns.
template <int DH>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_dq,
              const float* __restrict__ lse, const float* __restrict__ delta,
              int B, int H, int S, int T, int G, float scale, int causal) {
  using C = Bwd<DH>;
  constexpr int NS = C::Q_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // Q (two 64-row tiles) and dO of buffer qb at base + 4 qb TILE and + 2 TILE
  const uint32_t ring = base + 8 * C::TILE;
  const uint32_t bars = ring + NS * C::Q_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  auto q_full = [&](int qb) { return bars + 8 * (2 * NS + qb); };
  auto q_empty = [&](int qb) { return bars + 8 * (2 * NS + 2 + qb); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = T - S, nq = (S + 127) / 128;
  const int ntiles = nq * H * B;
  // a work tile's rows [q0, q0 + 128) of (h, b), and the key tiles of the
  // forward's range
  struct Tile {
    int q0, h, b, nk;
  };
  auto tile_of = [&](int t) {
    Tile x;
    const int g = t / nq;
    x.q0 = (nq - 1 - t % nq) * 128;
    x.h = g % H;
    x.b = g / H;
    const int last_row = min(x.q0 + 128, S) - 1;
    const int kv_hi = causal ? min(T, last_row + off + 1) : T;
    x.nk = kv_hi > 0 ? (kv_hi + 63) / 64 : 0;
    return x;
  };
  auto snake = [&](int r) {
    return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), BWD_CONSUMERS / 32);
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 2);       // each warpgroup's store has read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= BWD_CONSUMERS / 32) {
    regs_dec<40>();
    if (warp != BWD_CONSUMERS / 32 || lane != 0) return;
    int it = 0;                        // ring uses so far
    for (int r = 0, n = 0; r * (int)gridDim.x < ntiles; ++r) {
      const int t = snake(r);
      if (t >= ntiles) continue;
      const Tile x = tile_of(t);
      const int u = n++, qb = u & 1;   // this block's u-th tile
      const uint32_t qs = base + 4 * qb * C::TILE, dos = qs + 2 * C::TILE;
      if (u >= 2) mbar_wait(q_empty(qb), ((u >> 1) - 1) & 1);
      mbar_expect_tx(q_full(qb), 4 * C::TILE);
      for (int i = 0; i < 2; ++i) {
        tma5d(qs + i * C::TILE, &tm_q, 0, x.q0 + 64 * i, 0, x.h, x.b, q_full(qb));
        tma5d(dos + i * C::TILE, &tm_do, 0, x.q0 + 64 * i, 0, x.h, x.b, q_full(qb));
      }
      for (int j = 0; j < x.nk; ++j, ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(empty(s), (it / NS - 1) & 1);
        const uint32_t st = ring + s * C::Q_STAGE;
        mbar_expect_tx(full(s), 2 * C::TILE);
        tma5d(st, &tm_k, 0, 64 * j, 0, x.h / G, x.b, full(s));
        tma5d(st + C::TILE, &tm_v, 0, 64 * j, 0, x.h / G, x.b, full(s));
      }
    }
  } else {
    regs_inc<232>();
    const int wg = warp >> 2, wt = tid & 127, tq = lane & 3;
    const float sl2 = scale * LOG2E;
    int it = 0;
    for (int r = 0, n = 0; r * (int)gridDim.x < ntiles; ++r) {
      const int t = snake(r);
      if (t >= ntiles) continue;
      const Tile x = tile_of(t);
      const int u = n++, qb = u & 1;
      const uint32_t qa = base + 4 * qb * C::TILE + wg * C::TILE;   // the warpgroup's
      const uint32_t da_s = qa + 2 * C::TILE;
      const int row0 = x.q0 + 64 * wg;
      const int r0 = row0 + 16 * (warp & 3) + (lane >> 2);    // row g
      float lse2[2], dd[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = r0 + 8 * h2;
        const long long idx = ((long long)x.b * H + x.h) * S + row;
        lse2[h2] = row < S ? lse[idx] * LOG2E : INFINITY;
        dd[h2] = row < S ? delta[idx] : 0.f;
      }
      float dq[DH / 64][32] = {};
      mbar_wait(q_full(qb), (u >> 1) & 1);
      for (int j = 0; j < x.nk; ++j, ++it) {
        const int s = it % NS, t0 = 64 * j;
        mbar_wait(full(s), (it / NS) & 1);
        const uint32_t kt = ring + s * C::Q_STAGE, vt = kt + C::TILE;
        // S = Q K^T and dP = dO V^T, in two groups (zeroed, as dK/dV's)
        float sc[32] = {}, dp[32] = {};
        pin(dq);
        wgmma_fence();
        product_ss<DH, 64>(sc, qa, kt);
        product_ss<DH, 64>(dp, da_s, vt);
        wgmma_wait<1>();
        pin(sc);
        // P; value 4j + 2h + i is row r0 + 8h, key t0 + 8j + 2tq + i
        const bool edge = t0 + 64 > T || (causal && t0 + 63 > row0 + off);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(sc[4 * jj + e], sl2, -lse2[e >> 1]));
            if (edge) {
              const int kp = t0 + 8 * jj + 2 * tq + (e & 1);
              if (kp >= T || (causal && kp > r0 + 8 * (e >> 1) + off)) p = 0.f;
            }
            sc[4 * jj + e] = p;
          }
        wgmma_wait<0>();
        pin(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]);
        uint32_t da[4][4];
        as_a<64>(dp, da);
        wgmma_fence();
        product_rs<DH, 4>(dq, da, kt);   // dQ += dS K, K MN-major
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        pin(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
      // into the warpgroup's own Q tile (read by its wgmmas alone), then
      // free the buffer once the store has read it
#pragma unroll
      for (int c = 0; c < DH / 64; ++c) stage_box(dq[c], scale, qa + c * BWD_BOX, wt);
      fence_proxy_async();
      group_sync(wg);
      if (wt == 0) {
        if (row0 < S) {
          tma5d_store(&tm_dq, qa, 0, row0, 0, x.h, x.b);
          bulk_commit();
          bulk_wait_read();
        }
        mbar_arrive(q_empty(qb));
      }
    }
    if (wt == 0) bulk_wait_all();
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// libcuda link)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a bf16 (B, heads, P, DH) view with element strides s[0..2]
// over (batch, head, position) and a contiguous last axis, as the 5-D
// tensor (64, P, DH / 64, heads, B) in (64, 64, DH / 64, 1, 1) boxes under
// the 128-byte swizzle: a box is a 64-row tile, DH / 64 swizzled (64
// rows, 64 columns) boxes side by side. Rows past P read as zeros, and a
// store does not write them. P 0 is mapped as 1 row (never loaded).
bool view_map(CUtensorMap* map, const void* ptr, int B, int heads, int P, int DH,
              const long long* s) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  P = std::max(P, 1);
  // an axis of one element is never stepped along: any valid stride
  auto bytes = [](long long st, int n) { return (cuuint64_t)(n > 1 ? st * 2 : 16); };
  const cuuint64_t dims[5] = {64, (cuuint64_t)P, (cuuint64_t)(DH / 64),
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[4] = {bytes(s[2], P), 128, bytes(s[1], heads), bytes(s[0], B)};
  const cuuint32_t box[5] = {64, 64, (cuuint32_t)(DH / 64), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  configured = e == cudaSuccess;
  return e;
}

// The card's SMs, read once
cudaError_t sm_count(int& sms) {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  sms = n;
  return cudaSuccess;
}

cudaError_t launch_dkdv_halves(int B, int KV, cudaStream_t st, const void* q,
                               const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dk, void* dv,
                               int S, int T, int G, const long long* s, float scale,
                               int causal) {
  constexpr int DH = 128, SMEM = Bwd<DH>::HALVES_SMEM;
  static bool configured = false;
  cudaError_t e = allow_smem(bwd_dkdv_halves_kernel<DH>, SMEM, configured);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(sms);
  if (e != cudaSuccess) return e;
  const int H = KV * G;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!view_map(&mq, q, B, H, S, DH, s) || !view_map(&mk, k, B, KV, T, DH, s + 3) ||
      !view_map(&mv, v, B, KV, T, DH, s + 6) || !view_map(&mdo, dout, B, H, S, DH, s + 9) ||
      !view_map(&mdk, dk, B, KV, T, DH, s + 12) || !view_map(&mdv, dv, B, KV, T, DH, s + 15))
    return cudaErrorNotSupported;
  const long long tiles = (long long)(T + 63) / 64 * KV * B;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min<long long>(tiles, sms);   // one block an SM
  bwd_dkdv_halves_kernel<DH><<<grid, BWD_THREADS, SMEM, st>>>(
      mq, mk, mv, mdo, mdk, mdv, lse, delta, B, KV, S, T, G, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_dkdv64(int B, int KV, cudaStream_t st, const void* q, const void* k,
                          const void* v, const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv, int S, int T, int G,
                          const long long* s, float scale, int causal) {
  constexpr int DH = 64, SMEM = Bwd<DH>::KV_SMEM;
  static bool configured = false;
  cudaError_t e = allow_smem(bwd_dkdv64_kernel, SMEM, configured);
  if (e != cudaSuccess) return e;
  const int H = KV * G;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!view_map(&mq, q, B, H, S, DH, s) || !view_map(&mk, k, B, KV, T, DH, s + 3) ||
      !view_map(&mv, v, B, KV, T, DH, s + 6) || !view_map(&mdo, dout, B, H, S, DH, s + 9) ||
      !view_map(&mdk, dk, B, KV, T, DH, s + 12) || !view_map(&mdv, dv, B, KV, T, DH, s + 15))
    return cudaErrorNotSupported;
  // key tiles along z: under the causal mask the first ones, which carry
  // the most work, start first
  const dim3 grid(KV, B, (T + 127) / 128);
  bwd_dkdv64_kernel<<<grid, BWD_THREADS, SMEM, st>>>(mq, mk, mv, mdo, mdk, mdv, lse, delta,
                                                     H, S, T, G, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(int B, int H, cudaStream_t st, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int S, int T, int G,
                      const long long* s, float scale, int causal) {
  using C = Bwd<DH>;
  static bool configured = false;
  cudaError_t e = allow_smem(bwd_dq_kernel<DH>, C::Q_SMEM, configured);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(sms);
  if (e != cudaSuccess) return e;
  const int KV = H / G;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!view_map(&mq, q, B, H, S, DH, s) || !view_map(&mk, k, B, KV, T, DH, s + 3) ||
      !view_map(&mv, v, B, KV, T, DH, s + 6) || !view_map(&mdo, dout, B, H, S, DH, s + 9) ||
      !view_map(&mdq, dq, B, H, S, DH, s + 12))
    return cudaErrorNotSupported;
  const long long tiles = (long long)(S + 127) / 128 * H * B;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)std::min<long long>(tiles, sms);   // one block an SM
  bwd_dq_kernel<DH><<<grid, BWD_THREADS, C::Q_SMEM, st>>>(
      mq, mk, mv, mdo, mdq, lse, delta, B, H, S, T, G, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The backward's three launches, in order. ``s`` holds element strides
// (batch, head, position) of each tensor named, in the order named. ``lse``
// is the forward's, ``delta`` (B, H, S) f32 the pre-pass's output. DH in
// {64, 128}; B and the key or query tiles at most 65,535.

// D = rowsum(dO o O): strides of o, dout (host array of 6).
extern "C" int flash_attention_bwd_rowdot(
    const void* o, const void* dout, void* delta, int B, int H, int S, int DH,
    const long long* s, void* stream) {
  const long long rows = (long long)B * H * S;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* op = static_cast<const __nv_bfloat16*>(o);
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  auto* d = static_cast<float*>(delta);
  // 8 warps a block, 32 / (DH / 8) rows a warp at a time
  const long long per_block = 8 * (32 / (DH / 8));
  const unsigned blocks = (unsigned)std::min<long long>((rows + per_block - 1) / per_block,
                                                        132 * 64);
  if (DH == 128)
    bwd_rowdot_kernel<128><<<blocks, 256, 0, st>>>(op, dp, d, H, S, rows, s[0], s[1], s[2],
                                                  s[3], s[4], s[5]);
  else if (DH == 64)
    bwd_rowdot_kernel<64><<<blocks, 256, 0, st>>>(op, dp, d, H, S, rows, s[0], s[1], s[2],
                                                 s[3], s[4], s[5]);
  else
    return cudaErrorInvalidValue;
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
  if (B == 0 || KV == 0 || T == 0) return cudaSuccess;   // no output
  if (B > 65535 || (T + 63) / 64 > 65535) return cudaErrorInvalidValue;
  if (DH == 128) return launch_dkdv_halves(B, KV, st, q, k, v, dout, l, d, dk, dv, S, T, G, s, scale, causal);
  if (DH == 64) return launch_dkdv64(B, KV, st, q, k, v, dout, l, d, dk, dv, S, T, G, s, scale, causal);
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
  if (B == 0 || H == 0 || S == 0) return cudaSuccess;    // no output
  if (DH == 128) return launch_dq<128>(B, H, st, q, k, v, dout, l, d, dq, S, T, G, s, scale, causal);
  if (DH == 64) return launch_dq<64>(B, H, st, q, k, v, dout, l, d, dq, S, T, G, s, scale, causal);
  return cudaErrorInvalidValue;
}
