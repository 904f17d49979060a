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
// the tensor cores take it); a row with no visible key yields zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
             float scale, int causal, int window) {
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
                   int causal, int window) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (DH == 128) return launch<128, 8, 1, true>(B, H, st, qp, kp, vp, op, S, T, G, strides, scale, causal, window);
  if (DH == 64) return launch<64, 4, 2, false>(B, H, st, qp, kp, vp, op, S, T, G, strides, scale, causal, window);
  return cudaErrorInvalidValue;
}
