// Grouped expert GEMM for Hopper (sm_90a):
//
//   y[e] (C, F) = x[e] (C, D) @ w[e] (D, F)   for e in [0, E)
//
// f32 accumulation, one rounding to x's type at the end; x, w and y share
// one type (f32 or bf16). With ``rows`` (E,) int32 on the device, only rows
// c < rows[e] of expert e are computed: the others of y[e] are written as
// zeros, their x rows are never read, and an expert with no rows reads none
// of its weights.
//
// Replaces the Pallas TPU kernel src/repro/kernels/packed_mvm.py
// (grouped_mvm / _kernel). The TPU grid (E, C/bc, F/bf, D/bd) stepped over
// D innermost and in order, carrying an f32 accumulator in VMEM across the
// D steps, and its _pick shrank each tile to a divisor of its dimension.
// CUDA blocks run in no order, so one CUDA block per (e, c-tile, f-tile;
// 128 columns, 64 at decode) walks the whole D axis itself and writes its
// output tile once;
// nothing crosses CUDA blocks. Tiles are fixed instead of divisors: loads
// and stores are masked by the true C (or rows[e]), D and F (F = 1408 is 11
// x 128; C = 5 or 60 happen in real routing), and rows or columns past an
// edge are zero-filled in shared memory, so they add nothing.
//
// Bound: at decode (C = 8) device-memory bytes: each expert's weights for
// 2 * C FLOPs a weight, far below the card's ~295 FLOP/byte balance point.
// A c-tile covers every row up to C = 32 (decode) and C = 128 (prefill), so
// there an expert's weights cross the memory bus once a launch, and only
// for experts with rows: with ``rows`` a routed decode reads the weights of
// the experts its tokens chose (8 tokens at top-6 touch about 35 of
// deepseek-v2-lite's 64). Chunks of w and x stream through a cp.async ring
// of three stages (four at decode), the next chunks in flight while one is
// multiplied, one barrier a chunk. bf16 multiplies on the tensor cores
// (mma.sync m16n8k16, f32 accumulate; the backward further down runs on
// wgmma and TMA): at decode the weights are the A operand and the few
// token rows the n8 tiles, so the block only streams;
// at prefill (C = 128) the multiply-adds dominate. C > 128 takes several
// 128-row c-tiles, adjacent in the grid, so the blocks that share an
// expert's weights run together. f32 runs on FMAs (the packing path's
// tests; no serving path is f32).
//
// Layouts: x (E, C, D), w (E, D, F), y (E, C, F), all row-major and
// contiguous. Loads move 16 bytes, so D and F must be multiples of
// 16 / sizeof(T) (8 for bf16, 4 for f32); the wrapper checks this.

#include <cuda.h>           // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;        // output columns and D rows per chunk
constexpr int THREADS = 256;
constexpr int RPT = 8;          // rows of x per thread
constexpr int SMEM_MAX = 232448;

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

// Live rows of expert e: rows[e] clamped to [0, C], or all C without rows.
__device__ __forceinline__ int live_rows(const int32_t* rows, int e, int C) {
  return rows == nullptr ? C : max(0, min(rows[e], C));
}

// A block whose rows are all dead writes zeros over its (bm, ft) tile.
template <typename T>
__device__ void zero_tile(T* __restrict__ y, int e, int c0, int bm, int C,
                          int f0, int ft, int F) {
  T* ye = y + (size_t)e * C * F;
  const T z(0.f);
  for (int i = threadIdx.x; i < bm * ft; i += blockDim.x) {
    const int row = c0 + i / ft, col = f0 + i % ft;
    if (row < C && col < F) ye[(size_t)row * F + col] = z;
  }
}

// --- f32 FMA instance ----------------------------------------------------------
// 256 threads = 8 warps; lane l owns output columns [4l, 4l+4) of the tile.
// The 8 warps are BM / 8 row groups of 8 rows times 64 / BM slices of each
// 128-deep chunk; the slices' partial sums meet in shared memory at the
// flush. A thread holds an 8 x 4 accumulator.

template <int BM>
struct Smem {
  static constexpr int KS = 64 / BM;                       // k slices
  static constexpr int WBYTES = BLK * BLK * 4;
  static constexpr int XBYTES = BM * BLK * 4;
  static constexpr int RED = KS * BM * BLK * 4;            // = 32 KB
  // three stages where they fit in a block's shared memory, else two
  static constexpr int STAGES = 3 * (WBYTES + XBYTES) <= SMEM_MAX ? 3 : 2;
  // the partial-sum area overlays the weight ring after the loop
  static constexpr int RING = STAGES * WBYTES > RED ? STAGES * WBYTES : RED;
  static constexpr int TOTAL = RING + STAGES * XBYTES;
};

template <int BM>
__global__ void __launch_bounds__(THREADS)
grouped_mvm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, const int32_t* __restrict__ rows,
                   int C, int D, int F) {
  using S = Smem<BM>;
  constexpr int KS = S::KS, KL = BLK / KS, NS = S::STAGES;
  constexpr int CH = BLK / 4;                      // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wring = smem;
  uint8_t* xring = smem + S::RING;

  const int e = blockIdx.z, c0 = blockIdx.x * BM, f0 = blockIdx.y * BLK;
  const int live = live_rows(rows, e, C);
  if (c0 >= live) {                // no live row here: no weight is read
    zero_tile(y, e, c0, BM, C, f0, BLK, F);
    return;
  }
  const float* xe = x + (size_t)e * C * D;
  const float* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / KS, ks = warp % KS;   // row group, k slice
  const int nk = (D + BLK - 1) / BLK;

  // stage D rows [k0, k0 + 128) of w[e]'s column tile and of x[e]'s live rows
  auto prefetch = [&](int kc) {
    const int k0 = kc * BLK, st = kc % NS;
    uint8_t* wd = wring + st * S::WBYTES;
    for (int i = tid; i < BLK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = k0 + r, col = f0 + c * 4;
      const bool ok = row < D && col < F;
      cp16(wd + ((size_t)r * BLK + c * 4) * 4,
           we + (ok ? (size_t)row * F + col : 0), ok);
    }
    uint8_t* xd = xring + st * S::XBYTES;
    for (int i = tid; i < BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = c0 + r, col = k0 + c * 4;
      const bool ok = row < live && col < D;
      cp16(xd + ((size_t)r * BLK + c * 4) * 4,
           xe + (ok ? (size_t)row * D + col : 0), ok);
    }
  };

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) prefetch(s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc % NS;
    cp_wait<NS - 2>();
    // chunk kc is visible to all; every thread is done with chunk kc - 1,
    // whose slot the prefetch below refills
    __syncthreads();
    if (kc + NS - 1 < nk) prefetch(kc + NS - 1);
    cp_commit();
    const float* ws = reinterpret_cast<const float*>(wring + st * S::WBYTES);
    const float* xrow = reinterpret_cast<const float*>(xring + st * S::XBYTES)
                        + (size_t)rg * RPT * BLK;
#pragma unroll 2
    for (int kk = ks * KL; kk < (ks + 1) * KL; kk += 4) {
      float wv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + (kk + i) * BLK + 4 * lane);
        wv[i][0] = v.x; wv[i][1] = v.y; wv[i][2] = v.z; wv[i][3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xrow + r * BLK + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[r][j];
          a = fmaf(xv.x, wv[0][j], a);
          a = fmaf(xv.y, wv[1][j], a);
          a = fmaf(xv.z, wv[2][j], a);
          a = fmaf(xv.w, wv[3][j], a);
          acc[r][j] = a;
        }
      }
    }
  }

  // flush: partial sums of the k slices meet in shared memory, laid out
  // [ks][row][col] over the weight ring once every thread is past the loop
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(wring);
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    *reinterpret_cast<float4*>(red + ((size_t)ks * BM + rg * RPT + r) * BLK + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  float* ye = y + (size_t)e * C * F;
  for (int i = tid; i < BM * BLK; i += THREADS) {
    const int row = i / BLK, c = i % BLK, grow = c0 + row, gcol = f0 + c;
    if (grow >= C) break;            // rows only grow with i
    if (gcol >= F) continue;
    float v = 0.f;                   // dead rows summed zero-filled x rows
#pragma unroll
    for (int k = 0; k < KS; ++k) v += red[((size_t)k * BM + row) * BLK + c];
    ye[(size_t)grow * F + gcol] = v;
  }
}

// --- bf16 tensor-core instances --------------------------------------------------
// Both multiply on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), fragments read from the staged chunks by ldmatrix. Rows of
// the staged tiles are padded by 8 elements (16 bytes), so the ldmatrix
// reads of 8 rows hit 8 different 16-byte bank groups.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
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

// Decode (C <= 32): y[e]^T = w[e]^T x[e]^T, so the expert's weights are the
// A operand (16 output columns a warp) and its BM = 8, 16 or 32 token rows
// the n8 tiles of B: the whole tile's products are a few MMAs a 16-deep
// step, and the kernel streams weights. A block takes a 64-column f-tile
// (4 warps), narrow so that the blocks a launch spreads over the SMs come
// out even (a 1408-wide F gives each SM 10.7 blocks of 64 columns, against
// 5.3 of 128), and a four-stage ring of 128-deep chunks (82,432 bytes at
// BM = 8: two blocks a SM). A probe of 32-, 64- and 128-column tiles and
// three, four and six stages on the H100 found 32 columns or six stages
// slower and the rest alike.

constexpr int DEC_FT = 64;                         // columns a block
constexpr int DEC_NS = 4;                          // ring stages
constexpr int DEC_THREADS = DEC_FT * 2;            // one warp a 16 columns
constexpr int WROW = DEC_FT + 8;                   // padded w row, elements
constexpr int SROW = BLK + 8;                      // padded 128-wide row
constexpr int DEC_WBYTES = BLK * WROW * 2;         // w chunk (128 x FT + 8)
template <int BM>
__host__ __device__ constexpr int dec_stage() { return DEC_WBYTES + BM * SROW * 2; }
template <int BM>
__host__ __device__ constexpr int dec_smem() { return DEC_NS * dec_stage<BM>(); }

template <int BM>
__global__ void __launch_bounds__(DEC_THREADS)
grouped_mvm_dec_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y,
                       const int32_t* __restrict__ rows, int C, int D, int F) {
  constexpr int NT = BM / 8, NS = DEC_NS, STAGE = dec_stage<BM>();
  constexpr int WCH = DEC_FT / 8, XCH = BLK / 8;   // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  const int e = blockIdx.z, f0 = blockIdx.y * DEC_FT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = live_rows(rows, e, C);
  if (live == 0) {                 // no token chose this expert
    zero_tile(y, e, 0, BM, C, f0, DEC_FT, F);
    return;
  }
  const __nv_bfloat16* xe = x + (size_t)e * C * D;
  const __nv_bfloat16* we = w + (size_t)e * D * F;
  const int nk = (D + BLK - 1) / BLK;
  // stage D rows [k0, k0 + 128) of the f-tile and of x's live rows
  auto prefetch = [&](int kc) {
    const int k0 = kc * BLK;
    uint8_t* wd = smem + (kc % NS) * STAGE;
    uint8_t* xd = wd + DEC_WBYTES;
    for (int i = tid; i < BLK * WCH; i += DEC_THREADS) {
      const int r = i / WCH, c = i % WCH, row = k0 + r, col = f0 + c * 8;
      const bool ok = row < D && col < F;
      cp16(wd + (r * WROW + c * 8) * 2, we + (ok ? (size_t)row * F + col : 0), ok);
    }
    for (int i = tid; i < BM * XCH; i += DEC_THREADS) {
      const int r = i / XCH, c = i % XCH, col = k0 + c * 8;
      const bool ok = r < live && col < D;
      cp16(xd + (r * SROW + c * 8) * 2, xe + (ok ? (size_t)r * D + col : 0), ok);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) prefetch(s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<NS - 2>();
    // chunk kc is visible to all; every warp is done with chunk kc - 1,
    // whose slot the prefetch below refills
    __syncthreads();
    if (kc + NS - 1 < nk) prefetch(kc + NS - 1);
    cp_commit();
    const __nv_bfloat16* ws =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kc % NS) * STAGE);
    const __nv_bfloat16* xs = ws + DEC_WBYTES / 2;
#pragma unroll
    for (int kk = 0; kk < BLK; kk += 16) {
      // A = w^T: matrix j = lane / 8 is (columns +8 (j & 1), k +8 (j / 2)),
      // read transposed from the [k][f] chunk
      uint32_t a[4];
      ldsm_x4_t(a, ws + (kk + (lane >> 4) * 8 + (lane & 7)) * WROW +
                       warp * 16 + ((lane >> 3) & 1) * 8);
      // B = x^T: x's rows (n) as stored, k +8 for the second register
      if constexpr (NT == 1) {
        uint32_t b[2];
        ldsm_x2(b, xs + (lane & 7) * SROW + kk + ((lane >> 3) & 1) * 8);
        mma16816(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t b[4];
          ldsm_x4(b, xs + (p * 16 + (lane >> 4) * 8 + (lane & 7)) * SROW + kk +
                         ((lane >> 3) & 1) * 8);
          mma16816(acc[2 * p], a, b[0], b[1]);
          mma16816(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // flush: d0, d1 = (column g, rows 2t, 2t + 1), d2, d3 = column g + 8, of
  // each n8 tile; g = lane / 4, t = lane % 4. Rows past the live count
  // summed zero-filled x rows.
  __nv_bfloat16* ye = y + (size_t)e * C * F;
  const int col = f0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = t * 8 + (lane & 3) * 2 + (j & 1), cc = col + (j >> 1) * 8;
      if (row < C && cc < F) ye[(size_t)row * F + cc] = __float2bfloat16(acc[t][j]);
    }
}

// Prefill (C > 32): a 128-row c-tile, 8 warps as 4 x 2, each owning a 32 x
// 64 piece of the (128, 128) output tile, so up to C = 128 one block holds
// every row of its (expert, f-tile) and the expert's weights are read once.
// A warp whose 32 rows are all past the expert's live rows skips its
// products. 64-deep chunks, three stages (107,520 bytes: two blocks a SM).

constexpr int MMA_BM = 128;
constexpr int MMA_KC = 64;                         // D rows a chunk
constexpr int MMA_STAGES = 3;
constexpr int XROW = MMA_KC + 8;                   // padded x row, elements
constexpr int MMA_WBYTES = MMA_KC * SROW * 2;      // w chunk (64 x 136)
constexpr int MMA_XBYTES = MMA_BM * XROW * 2;      // x chunk (128 x 72)
constexpr int MMA_STAGE = MMA_WBYTES + MMA_XBYTES;
constexpr int MMA_SMEM = MMA_STAGES * MMA_STAGE;

__global__ void __launch_bounds__(THREADS)
grouped_mvm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y,
                       const int32_t* __restrict__ rows, int C, int D, int F) {
  constexpr int NS = MMA_STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  const int e = blockIdx.z, c0 = blockIdx.x * MMA_BM, f0 = blockIdx.y * BLK;
  const int live = live_rows(rows, e, C);
  if (c0 >= live) {                // no live row here: no weight is read
    zero_tile(y, e, c0, MMA_BM, C, f0, BLK, F);
    return;
  }
  const __nv_bfloat16* xe = x + (size_t)e * C * D;
  const __nv_bfloat16* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;         // 32-row, 64-column piece
  const bool busy = c0 + wm * 32 < live;           // any live row in the piece
  const int nk = (D + MMA_KC - 1) / MMA_KC;
  // stage D rows [k0, k0 + 64) of w[e]'s column tile and of x[e]'s live rows
  auto prefetch = [&](int kc) {
    constexpr int WCH = BLK / 8, XCH = MMA_KC / 8;   // 16-byte copies a row
    const int k0 = kc * MMA_KC;
    uint8_t* wd = smem + (kc % NS) * MMA_STAGE;
    uint8_t* xd = wd + MMA_WBYTES;
    for (int i = tid; i < MMA_KC * WCH; i += THREADS) {
      const int r = i / WCH, c = i % WCH, row = k0 + r, col = f0 + c * 8;
      const bool ok = row < D && col < F;
      cp16(wd + (r * SROW + c * 8) * 2, we + (ok ? (size_t)row * F + col : 0), ok);
    }
    for (int i = tid; i < MMA_BM * XCH; i += THREADS) {
      const int r = i / XCH, c = i % XCH, row = c0 + r, col = k0 + c * 8;
      const bool ok = row < live && col < D;
      cp16(xd + (r * XROW + c * 8) * 2, xe + (ok ? (size_t)row * D + col : 0), ok);
    }
  };

  float acc[2][8][4];                              // [m16 tile][n8 tile][4]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) prefetch(s);
    cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<NS - 2>();
    // chunk kc is visible to all; every warp is done with chunk kc - 1,
    // whose slot the prefetch below refills
    __syncthreads();
    if (kc + NS - 1 < nk) prefetch(kc + NS - 1);
    cp_commit();
    if (!busy) continue;
    const __nv_bfloat16* ws =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kc % NS) * MMA_STAGE);
    const __nv_bfloat16* xs = ws + MMA_WBYTES / 2;
#pragma unroll
    for (int kk = 0; kk < MMA_KC; kk += 16) {
      uint32_t a[2][4];
      // A: lane l addresses row l % 16, columns kk + 8 (l / 16)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], xs + (wm * 32 + mi * 16 + (lane & 15)) * XROW + kk +
                           (lane >> 4) * 8);
      // B (k-major rows), transposed: matrices (k 0-7 | 8-15) x (n 0-7 |
      // 8-15) give b0b1 / b2b3 of two n8 tiles
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, ws + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW +
                         wn * 64 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // flush: fragment (row g | g + 8, columns 2t, 2t + 1) of each tile,
  // g = lane / 4, t = lane % 4; F % 8 == 0 keeps column pairs whole. Rows
  // past the live count hold zeros (their x rows were zero-filled, or the
  // warp skipped its products).
  __nv_bfloat16* ye = y + (size_t)e * C * F;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = f0 + wn * 64 + ni * 8 + (lane & 3) * 2;
      if (col >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = c0 + wm * 32 + mi * 16 + (lane >> 2) + h * 8;
        if (row < C)
          *reinterpret_cast<__nv_bfloat162*>(ye + (size_t)row * F + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// --- backward: dX and dW of the masked product (bf16) -----------------------------
// The gradient of y[e] = x[e] w[e] over the live rows c < rows[e] of expert e:
//
//   dX[e] (C, D) = dY[e] (C, F) . w[e]^T        rows c >= rows[e] zero
//   dW[e] (D, F) = x[e]^T (D, C) . dY[e] (C, F)  summed over c < rows[e] only
//
// Replaces no Pallas site: the reference differentiates jnp's einsum; the
// port's training forward runs the kernels above, its gradient these two.
//
// Bound: at olmoe-1b-7b's training shape (64 experts, C 640, D 2048, F
// 1024, ~504 live rows an expert) each is 137 GFLOP of multiply-adds, 0.139
// ms at 989 TFLOP/s, against 0.149 ms (dX) and 0.139 ms (dW) of HBM bytes:
// dW writes 268 MB of output, so its bytes and operations are balanced.
// On the way, a 128 x 256 tile with a 64-deep stage takes 48 KB into
// shared memory for 2.1 M multiply-adds, and two m64n256k16 wgmmas read
// 80 KB of it: at the tensor cores' rate that is all of the SM's shared-
// memory bandwidth, so neither kernel comes near its bound.
//
// Design (Hopper): one persistent kernel body for both, a grid of the
// blocks (or two-block clusters) that fit on the card at once, each
// walking work items in a fixed order; each output tile of 128 rows x 256
// columns is owned by one block (no split of the summed axis, no atomics,
// a fixed order of it: a launch repeats bit for bit). A producer warp
// keeps TMA loads in flight through a four-stage ring of 64-deep chunks
// (48 KB a stage, 128-byte swizzle, one full and one empty mbarrier a
// stage) and runs ahead into the block's next tile while the consumers
// flush. Two consumer warpgroups each multiply 64 of the rows with wgmma
// m64n256k16, both operands from shared memory, f32 in registers, one
// wgmma group kept in flight across chunks. The flush rounds once to bf16
// into swizzled staging boxes by stmatrix, and TMA stores write them out
// under the next tile's mainloop. Timed on the H100 at olmoe's shape
// (chip_smoke.py (m0)), the flush still costs ~15% (its 268 or 168 MB of
// writes), and the loads alone take half or more of the whole.
//
// dX is an NT product: dY (c, f) is A and w (d, f) is B, both K-major as
// stored (K = F), so the TMA boxes are the swizzled operands as they are.
// Where C holds two row tiles it runs in clusters of two blocks: a pair of
// row tiles under one column tile shares B, each block loading half of
// w's 256 rows and multicasting it to both (32 KB a block a stage from L2
// instead of 48); an expert's odd last live row tile goes in pairs of
// column tiles that share A (dY's rows) instead, so that no block
// multiplies a tile without live rows. Every expert's multiplying items
// come before any tile wholly past the live rows, which only writes zeros
// and loads nothing (an expert with no rows reads none of its weights):
// the blocks' round-robin then deals the costly items out evenly. Rows
// past the live count in a tile that holds a live row are loaded and
// multiplied (a dX row depends only on its own dY row) and flushed as
// zeros.
//
// dW is a TN product: x (c, d) is A and dY (c, f) is B, both MN-major in
// shared memory as the TMA lands them ((64 columns, 64 rows) boxes, side
// by side in one copy through a 4-D map where the columns divide by 64;
// wgmma transposes 16-bit operands itself, so no transposed copy is made).
// A tile is (d-tile, f-tile), one block each, and walks the expert's live
// rows, 64 a chunk. The tensor maps are (E, C, .), so rows past C read as
// zeros; rows in [rows[e], C) of the last chunk are zeroed in shared
// memory before the wgmma that reads them (then fence.proxy.async: generic
// stores before the async proxy's reads), so they add nothing whatever x
// and dY hold there. An expert with no live rows loads nothing and writes
// zeros.

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
// one box of a 3-D tensor map at element coordinates (c0 inner, c1, c2 outer)
__device__ __forceinline__ void tma3d(uint32_t dst, const CUtensorMap* map,
                                      int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar) : "memory");
}
// one box of a 4-D tensor map: (c0 inner, c1, c2, c3 outer)
__device__ __forceinline__ void tma4d(uint32_t dst, const CUtensorMap* map,
                                      int c0, int c1, int c2, int c3,
                                      uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
}
// the same box landing at the same offset in the shared memory of every
// block of `mask` in the cluster, each signalled on its own barrier at
// `bar`'s offset
__device__ __forceinline__ void tma3d_multicast(uint32_t dst,
                                                const CUtensorMap* map, int c0,
                                                int c1, int c2, uint32_t bar,
                                                uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar), "h"(mask) : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// arrive on the barrier at the same offset as `bar` in block `rank` of
// the cluster
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}
// every thread of the cluster's blocks
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
// one shared-memory box to a 3-D tensor map's (c0, c1, c2) box; elements
// outside the tensor are not written
__device__ __forceinline__ void tma3d_store(const CUtensorMap* map,
                                            uint32_t src, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's stores but the newest N have read their shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {   // and are written
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// four 8 x 8 bf16 matrices from a warp's registers: lane l gives the
// address of row l % 8 of matrix l / 8, and register i of lane l holds
// row l / 4, columns 2 (l % 4) and + 1 of matrix i (mma's fragment)
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void consumers_sync() {   // the 8 consumer warps
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// generic-proxy stores to shared memory, ordered before the async proxy's
// (wgmma's, TMA's) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The descriptor of a bf16 tile under the 128-byte swizzle (1,024-byte
// atoms of eight 128-byte rows). K-major: rows along M or N, 8-row groups
// 1,024 bytes apart (the leading offset is unused). MN-major: rows along
// K, 8-row K groups 1,024 bytes apart (stride offset), 64-element MN
// blocks `lbo` bytes apart (leading offset).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 16) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256 f32; 128 a thread) += a (64 x 16) . b (16 x 256), both bf16
// in shared memory by descriptor; TA / TB 1 reads that operand MN-major;
// scale_d 0 drops d's old value
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
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
// Pin registers that an asynchronous wgmma writes: the compiler may
// neither move their other uses across this point nor give their physical
// registers to other values while they are live.
__device__ __forceinline__ void pin(float (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

constexpr int BWD_BM = 128;                        // tile rows: 2 warpgroups x 64
constexpr int BWD_BN = 256;                        // tile columns
constexpr int BWD_BK = 64;                         // summed-axis depth a stage
constexpr int BWD_STAGES = 4;
constexpr int BWD_CONSUMERS = 256;
constexpr int BWD_THREADS = BWD_CONSUMERS + 32;    // + the producer warp
constexpr int BWD_BOX = 64 * 128;                  // a (64 columns, 64 rows) box
constexpr int BWD_ABYTES = BWD_BM * BWD_BK * 2;    // 16 KB: a warpgroup's 8 KB each
constexpr int BWD_BBYTES = BWD_BN * BWD_BK * 2;    // 32 KB
constexpr int BWD_STAGE = BWD_ABYTES + BWD_BBYTES;
constexpr int BWD_RING = BWD_STAGES * BWD_STAGE;   // 192 KB
constexpr int BWD_OUTBOX = 16 * 128;               // a warp's (64, 16) flush box
constexpr int BWD_STAGING = 8 * 2 * BWD_OUTBOX;    // two a consumer warp
constexpr int BWD_BARS = 16 * BWD_STAGES;          // full[s], empty[s]
constexpr int BWD_SMEM = 1024 + BWD_RING + BWD_STAGING + BWD_BARS;  // 1024: alignment slack
static_assert(BWD_SMEM <= SMEM_MAX, "shared memory over the per-block limit");

// One output tile of the walk: expert e, rows [m0, m0 + 128) and columns
// [n0, n0 + 256) of its (M, N) output, the expert's live rows, the chunks
// of the summed axis it multiplies (0: it only writes zeros), and, for
// dX's pairs, whether the two blocks share B (else they share A). dX: M =
// C, N = D, K = F; dW: M = D, N = F, K = the live rows. A tile past M or
// N (a pair's spare) loads only what it shares and stores nothing.
struct BwdTile {
  int e, m0, n0, live, nk;
  bool share_b;
};
// Where a block's walk stands: the pass over the experts and, in it, the
// expert of the last work item and that expert's first item. Items only
// grow along a walk, so the cursor only moves forward.
struct BwdCursor {
  int pass = -1, e = 0, first = 0, costly = 0;
};

// dX's work items of an expert in pairs, by its L = ceil(live / 128) live
// row tiles: floor(L / 2) pairs of row tiles per column tile (sharing B);
// for odd L, the last live row tile under pairs of column tiles (sharing
// A); then the tiles past the live rows, two at a time.
__device__ __forceinline__ void dx_items(int live, int nm, int nn, int& L,
                                         int& costly, int& zero) {
  L = min(nm, (live + BWD_BM - 1) / BWD_BM);
  costly = L / 2 * nn + (L & 1) * ((nn + 1) / 2);
  zero = ((nm - L) * nn + 1) / 2;
}

// The tile of work item p for block `rank` of its cluster: false past the
// last item. Alone (CL 1), item p is one tile, the row tiles of a column
// tile adjacent, expert-major. dX in pairs (CL 2) walks the experts
// twice: every expert's costly items (pairs that multiply), then the zero
// ones.
template <bool DW, int CL>
__device__ __forceinline__ bool bwd_tile(int p, int rank, BwdCursor& cur,
                                         const int32_t* rows, int E, int C,
                                         int D, int F, BwdTile& b) {
  const int M = DW ? D : C, N = DW ? F : D;
  const int nm = (M + BWD_BM - 1) / BWD_BM, nn = (N + BWD_BN - 1) / BWD_BN;
  const int kc = (F + BWD_BK - 1) / BWD_BK;      // dX's chunks
  b.share_b = true;
  if constexpr (CL == 1) {
    if (p >= E * nm * nn) return false;
    b.e = p / (nm * nn);
    const int r = p % (nm * nn);
    b.m0 = r % nm * BWD_BM;
    b.n0 = r / nm * BWD_BN;
    b.live = live_rows(rows, b.e, C);
    b.nk = DW ? (b.live + BWD_BK - 1) / BWD_BK : b.m0 < b.live ? kc : 0;
    return true;
  } else {
    static_assert(!DW && CL == 2, "only dX runs in pairs");
    int L, costly, zero;
    if (cur.pass < 0) {                          // the costly items' count
      for (int e = 0; e < E; ++e) {
        dx_items(live_rows(rows, e, C), nm, nn, L, costly, zero);
        cur.costly += costly;
      }
      cur.pass = 0;
    }
    if (cur.pass == 0 && p >= cur.costly) {      // into the zero items
      cur.pass = 1;
      cur.e = 0;
      cur.first = cur.costly;
    }
    for (;; ++cur.e) {
      if (cur.e >= E) return false;
      dx_items(live_rows(rows, cur.e, C), nm, nn, L, costly, zero);
      const int items = cur.pass == 0 ? costly : zero;
      if (p < cur.first + items) break;
      cur.first += items;
    }
    b.e = cur.e;
    b.live = live_rows(rows, b.e, C);
    const int pairs = L / 2;
    int r = p - cur.first;
    if (cur.pass == 1) {                         // a tile past the live rows
      const int z = 2 * r + rank, zm = nm - L;
      b.m0 = z < zm * nn ? (L + z % zm) * BWD_BM : M;
      b.n0 = z < zm * nn ? z / zm * BWD_BN : 0;
      b.nk = 0;
    } else if (r < pairs * nn) {                 // row tiles sharing B
      b.m0 = (2 * (r % pairs) + rank) * BWD_BM;
      b.n0 = r / pairs * BWD_BN;
      b.nk = kc;
    } else {                                     // the odd last live row tile
      r -= pairs * nn;
      b.m0 = (L - 1) * BWD_BM;
      b.n0 = (2 * r + rank) * BWD_BN;            // past D: the pair's spare
      b.nk = kc;
      b.share_b = false;
    }
    return true;
  }
}

// dW's chunk k0 of tile b into stage st: x's rows [k0, k0 + 64) of the
// tile's 128 columns (A) and dY's of its 256 (B), as 64-column boxes; in
// one copy each where its map is 4-D (``maps4`` bit 0 for A, 1 for B).
// Boxes wholly past D or F are not loaded: they would only feed output
// rows or columns that are never stored.
__device__ __forceinline__ void load_dw(const BwdTile& b, int k0, uint32_t st,
                                        uint32_t bar, const CUtensorMap* tm_a,
                                        const CUtensorMap* tm_b, int D, int F,
                                        int maps4) {
  const bool a4 = maps4 & 1, b4 = maps4 & 2;
  const int na = D - b.m0 > 64 ? 2 : 1;
  const int nb = min(4, (F - b.n0 + 63) / 64);
  mbar_expect_tx(bar, ((a4 ? 2 : na) + (b4 ? 4 : nb)) * BWD_BOX);
  if (a4) {
    tma4d(st, tm_a, 0, k0, b.m0 / 64, b.e, bar);
  } else {
    for (int i = 0; i < na; ++i)
      tma3d(st + i * BWD_BOX, tm_a, b.m0 + 64 * i, k0, b.e, bar);
  }
  if (b4) {
    tma4d(st + BWD_ABYTES, tm_b, 0, k0, b.n0 / 64, b.e, bar);
  } else {
    for (int j = 0; j < nb; ++j)
      tma3d(st + BWD_ABYTES + j * BWD_BOX, tm_b, b.n0 + 64 * j, k0, b.e, bar);
  }
}

// dX's chunk k0 of tile b into stage st for block `rank` of a cluster of
// CL: dY's 128 rows (A) and w's 256 (B), columns [k0, k0 + 64). tm_b
// holds (64, 256 / CL) boxes, tm_b_whole (64, 256). Pairs sharing B: each
// block its own A and w's 128-row half `rank`, multicast to both (a half
// wholly past D is not loaded). Pairs sharing A: rank 0 multicasts A, each
// block its own B in one copy (none for a spare past D).
template <int CL>
__device__ __forceinline__ void load_dx(const BwdTile& b, int rank, int k0,
                                        uint32_t st, uint32_t bar,
                                        const CUtensorMap* tm_a,
                                        const CUtensorMap* tm_b,
                                        const CUtensorMap* tm_b_whole, int D) {
  constexpr int SHARE = BWD_BN / CL, HALF = BWD_BBYTES / CL;
  if (!b.share_b) {
    mbar_expect_tx(bar, BWD_ABYTES + (b.n0 < D ? BWD_BBYTES : 0));
    if (rank == 0) tma3d_multicast(st, tm_a, k0, b.m0, b.e, bar, 0x3);
    if (b.n0 < D) tma3d(st + BWD_ABYTES, tm_b_whole, k0, b.n0, b.e, bar);
    return;
  }
  const int nb = min(CL, (D - b.n0 + SHARE - 1) / SHARE);
  mbar_expect_tx(bar, BWD_ABYTES + nb * HALF);
  tma3d(st, tm_a, k0, b.m0, b.e, bar);
  if (rank < nb) {
    if constexpr (CL > 1)
      tma3d_multicast(st + BWD_ABYTES + rank * HALF, tm_b, k0,
                      b.n0 + rank * SHARE, b.e, bar, 0x3);
    else
      tma3d(st + BWD_ABYTES, tm_b, k0, b.n0, b.e, bar);
  }
}

// The body of both kernels, for a cluster of CL blocks (dW: 1). dX: tm_a
// over dY (E, C, F) in (64, 128) boxes, tm_b and tm_b_whole over w (E, D,
// F) in (64, 256 / CL) and (64, 256) boxes. dW: tm_a over x (E, C, D),
// tm_b over dY (E, C, F), each a 4-D view (64, C, cols / 64, E) in (64,
// 64, 2 or 4, 1) boxes where its columns divide by 64, else 3-D in (64,
// 64) boxes. tm_out over dX (E, C, D) or dW (E, D, F) in (64, 16) boxes.
template <bool DW, int CL>
__device__ __forceinline__ void bwd_body(const CUtensorMap* tm_a,
                                         const CUtensorMap* tm_b,
                                         const CUtensorMap* tm_b_whole,
                                         const CUtensorMap* tm_out,
                                         const int32_t* __restrict__ rows,
                                         int E, int C, int D, int F,
                                         int maps4) {
  constexpr int NS = BWD_STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // the swizzle's period
  uint8_t* ring = smem_raw + (base - raw);
  const uint32_t bars = base + BWD_RING + BWD_STAGING;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int first = blockIdx.x / CL, step = gridDim.x / CL;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      // the consumer warps of every block: a stage is refilled in all
      mbar_init(empty(s), CL * BWD_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CL > 1) cluster_sync();  // every block's barriers exist before a copy
  else __syncthreads();

  BwdCursor cur;
  BwdTile b;
  int it = 0;                  // stage uses so far: stage it % NS, phase it / NS
  if (warp == BWD_CONSUMERS / 32) {
    // producer: lane 0 issues every copy
    for (int p = first; bwd_tile<DW, CL>(p, rank, cur, rows, E, C, D, F, b);
         p += step) {
      if (lane != 0) continue;
      for (int kc = 0; kc < b.nk; ++kc, ++it) {
        const int s = it % NS;
        if (it >= NS) mbar_wait(empty(s), (it / NS - 1) & 1);
        if constexpr (DW)
          load_dw(b, kc * BWD_BK, base + s * BWD_STAGE, full(s), tm_a, tm_b,
                  D, F, maps4);
        else
          load_dx<CL>(b, rank, kc * BWD_BK, base + s * BWD_STAGE, full(s),
                      tm_a, tm_b, tm_b_whole, D);
      }
    }
  } else {
    // consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of the
    // tile (always both: a wgmma under a condition the compiler cannot
    // prove uniform is serialized)
    const int wg = warp >> 2;
    const uint32_t staging = base + BWD_RING + warp * 2 * BWD_OUTBOX;
    int stores = 0;                              // boxes the warp has stored
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    // this warp is done with stage s: tell every block's producer, since
    // each refills its share of the stage in all of them
    auto release = [&](int s) {
      if (lane == 0)
        for (int r = 0; r < CL; ++r) {
          if (r == rank) mbar_arrive(empty(s));
          else mbar_arrive_peer(empty(s), r);
        }
    };
    for (int p = first; bwd_tile<DW, CL>(p, rank, cur, rows, E, C, D, F, b);
         p += step) {
      for (int kc = 0; kc < b.nk; ++kc, ++it) {
        const int s = it % NS;
        mbar_wait(full(s), (it / NS) & 1);
        const uint32_t st = base + s * BWD_STAGE;
        if constexpr (DW) {
          // the last chunk's rows at and past rows[e], in all six boxes
          const int r0 = b.live - kc * BWD_BK;
          if (r0 < BWD_BK) {
            const int per_box = (BWD_BK - r0) * 8;   // 16-byte pieces
            uint8_t* stage = ring + s * BWD_STAGE;
            for (int i = tid; i < 6 * per_box; i += BWD_CONSUMERS) {
              const int box = i / per_box, r = i % per_box;
              *reinterpret_cast<uint4*>(stage + box * BWD_BOX +
                                        (r0 + r / 8) * 128 + (r % 8) * 16) =
                  make_uint4(0u, 0u, 0u, 0u);
            }
            fence_proxy_async();
            consumers_sync();
          }
        }
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BWD_BK / 16; ++kk) {
          if constexpr (DW)   // MN-major: 16 K rows are 2,048 bytes
            wgmma_n256<1, 1>(acc, desc_sw128(st + wg * BWD_BOX + kk * 2048),
                             desc_sw128(st + BWD_ABYTES + kk * 2048, BWD_BOX),
                             kc > 0 || kk > 0);
          else                // K-major: 16 K columns are 32 bytes of a row
            wgmma_n256<0, 0>(acc, desc_sw128(st + wg * BWD_BOX + kk * 32),
                             desc_sw128(st + BWD_ABYTES + kk * 32),
                             kc > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();              // chunk kc - 1 is done: free its stage
        pin(acc);
        if (kc > 0) release((it - 1) % NS);
      }
      wgmma_wait<0>();
      pin(acc);
      if (b.nk > 0) release((it - 1) % NS);

      // flush: accumulator 4j + 2h + i of a thread is row 16 w4 + g + 8h of
      // its warpgroup's 64, column 8j + 2t + i (g = lane / 4, t = lane %
      // 4): for each n8 block j and row half h, mma's fragment of an 8 x 8
      // matrix, which stmatrix stores as it is. dX rows at and past the
      // live count, and every row of a dW tile without live rows, are
      // zeros. Each warp rounds its 16 x 256 piece into (64, 16) staging
      // boxes under the 128-byte swizzle, four 8 x 8 matrices a stmatrix,
      // and stores each box with one TMA store, which clips at C (or D)
      // and N and drains under the next tile's mainloop; the warp's two
      // staging boxes alternate from store to store. No barrier beyond
      // the warp's own.
      const int M = DW ? D : C, N = DW ? F : D;
      const int live_m = DW ? (b.live > 0 ? M : 0) : b.live;
      const int row0 = b.m0 + 64 * wg + 16 * (warp & 3);   // the warp's rows
      const bool keep0 = row0 + (lane >> 2) < live_m;
      const bool keep1 = row0 + (lane >> 2) + 8 < live_m;
      // stmatrix address of lane l: row l % 8 (+ 8 for the odd matrices),
      // 16-byte chunk 2i + l / 16 of the box, swizzled by the row
      const int srow = (lane & 7) + ((lane >> 3) & 1) * 8;
      if (row0 >= M) continue;
#pragma unroll
      for (int q = 0; q < BWD_BN / 64; ++q) {
        if (b.n0 + 64 * q >= N) break;
        if (lane == 0) bulk_wait_read<1>();   // its last store read it
        __syncwarp();
        const uint32_t box = staging + (stores++ & 1) * BWD_OUTBOX;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 8 * q + 2 * i;        // n8 blocks j and j + 1
          const int chunk = 2 * i + (lane >> 4);
          stmatrix_x4(box + srow * 128 + ((chunk ^ (srow & 7)) << 4),
                      keep0 ? bf16x2(acc[4 * j], acc[4 * j + 1]) : 0u,
                      keep1 ? bf16x2(acc[4 * j + 2], acc[4 * j + 3]) : 0u,
                      keep0 ? bf16x2(acc[4 * j + 4], acc[4 * j + 5]) : 0u,
                      keep1 ? bf16x2(acc[4 * j + 6], acc[4 * j + 7]) : 0u);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          tma3d_store(tm_out, box, b.n0 + 64 * q, row0, b.e);
          bulk_commit();
        }
      }
    }
    if (lane == 0) bulk_wait_all();
  }
  if (CL > 1) cluster_sync();  // no block exits while a peer may signal it
}

template <int CL>
__global__ void __launch_bounds__(BWD_THREADS, 1)
grouped_mvm_dx_kernel(const __grid_constant__ CUtensorMap tm_dy,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_w_whole,
                      const __grid_constant__ CUtensorMap tm_dx,
                      const int32_t* __restrict__ rows, int E, int C, int D,
                      int F, int maps4) {
  bwd_body<false, CL>(&tm_dy, &tm_w, &tm_w_whole, &tm_dx, rows, E, C, D, F,
                      maps4);
}

__global__ void __launch_bounds__(BWD_THREADS, 1)
grouped_mvm_dw_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_dy,
                      const __grid_constant__ CUtensorMap tm_dw,
                      const int32_t* __restrict__ rows, int E, int C, int D,
                      int F, int maps4) {
  bwd_body<true, 1>(&tm_x, &tm_dy, &tm_dy, &tm_dw, rows, E, C, D, F, maps4);
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

// a 3-D map over a row-major bf16 (E, rows, cols) tensor with (box_cols,
// box_rows, 1) boxes and the 128-byte swizzle; rows past `rows` and
// columns past `cols` read as zeros, and a store does not write them.
// With `blocks` > 0 (cols a multiple of 64), a 4-D view of it instead,
// (64, rows, cols / 64, E), in (64, box_rows, blocks, 1) boxes: `blocks`
// 64-column boxes side by side in one copy.
bool tensor_map(CUtensorMap* map, const void* ptr, uint64_t E, uint64_t rows,
                uint64_t cols, uint32_t box_cols, uint32_t box_rows,
                uint32_t blocks = 0) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (blocks) {
    const cuuint64_t dims[4] = {64, rows, cols / 64, E};
    const cuuint64_t strides[3] = {cols * 2, 128, rows * cols * 2};
    const cuuint32_t box[4] = {64, box_rows, blocks, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(ptr), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[3] = {cols, rows, E};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One backward launch in clusters of CL blocks: the kernel's shared-memory
// limit set, and the blocks (CL 1) or clusters that fit on the card at
// once counted, on its first launch (``grid`` is the kernel's own, 0 until
// then); then a persistent grid of that many (at most one a tile) over the
// (E, M / 128, N / 256) tiles.
template <int CL, typename Kernel, typename... Maps>
cudaError_t launch_bwd(Kernel kernel, int& grid, const int32_t* rows, int M,
                       int N, int E, int C, int D, int F, int maps4,
                       cudaStream_t stream, const Maps&... maps) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = BWD_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;   // a lone block is no cluster launch
  if (grid == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return err;
    if (CL > 1) {
      err = cudaOccupancyMaxActiveClusters(&grid, kernel, &cfg);
    } else {
      int dev = 0, sms = 0, per = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, kernel, BWD_THREADS, BWD_SMEM);
      grid = sms * per;
    }
    if (err != cudaSuccess) return err;
    if (grid < 1) return cudaErrorInvalidConfiguration;
  }
  const long long tiles = (long long)E * ((M + BWD_BM - 1) / BWD_BM) *
                          ((N + BWD_BN - 1) / BWD_BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(CL * (tiles < grid ? (int)tiles : grid));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, maps..., rows, E, C,
                                             D, F, maps4);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int CL>
cudaError_t launch_dx(const void* dy, const void* w, void* dx,
                      const int32_t* rows, int E, int C, int D, int F,
                      cudaStream_t st) {
  static int grid = 0;
  CUtensorMap a, b, bw, o;
  if (!tensor_map(&a, dy, E, C, F, 64, BWD_BM) ||
      !tensor_map(&b, w, E, D, F, 64, BWD_BN / CL) ||
      !tensor_map(&bw, w, E, D, F, 64, BWD_BN) ||
      !tensor_map(&o, dx, E, C, D, 64, 16))
    return cudaErrorNotSupported;
  return launch_bwd<CL>(grouped_mvm_dx_kernel<CL>, grid, rows, C, D, E, C, D,
                        F, 0, st, a, b, bw, o);
}

cudaError_t launch_dw(const void* x, const void* dy, void* dw,
                      const int32_t* rows, int E, int C, int D, int F,
                      cudaStream_t st) {
  static int grid = 0;
  const bool a4 = D % 64 == 0, b4 = F % 64 == 0;
  CUtensorMap a, b, o;
  if (!tensor_map(&a, x, E, C, D, 64, 64, a4 ? 2 : 0) ||
      !tensor_map(&b, dy, E, C, F, 64, 64, b4 ? 4 : 0) ||
      !tensor_map(&o, dw, E, D, F, 64, 16))
    return cudaErrorNotSupported;
  return launch_bwd<1>(grouped_mvm_dw_kernel, grid, rows, D, F, E, C, D, F,
                       (a4 ? 1 : 0) | (b4 ? 2 : 0), st, a, b, o);
}

// Sets the kernel's dynamic shared memory limit on its first launch (a
// stream capture must not be the first) and launches the (c-tiles,
// f-tiles, E) grid, c-tiles fastest. ``configured`` is the kernel's own.
template <typename T, typename Kernel>
cudaError_t launch_grid(Kernel kernel, bool& configured, int bytes, int bm,
                        const void* x, const void* w, void* y,
                        const int32_t* rows, int E, int C, int D, int F,
                        cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((C + bm - 1) / bm, (F + BLK - 1) / BLK, E);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w),
                                           static_cast<T*>(y), rows, C, D, F);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_fma(const void* x, const void* w, void* y,
                       const int32_t* rows, int E, int C, int D, int F,
                       cudaStream_t stream) {
  constexpr int bytes = Smem<BM>::TOTAL;
  static_assert(bytes <= SMEM_MAX, "shared memory over the per-block limit");
  static bool configured = false;
  return launch_grid<float>(grouped_mvm_kernel<BM>, configured, bytes, BM, x,
                            w, y, rows, E, C, D, F, stream);
}

template <int BM>
cudaError_t launch_dec(const void* x, const void* w, void* y,
                       const int32_t* rows, int E, int C, int D, int F,
                       cudaStream_t stream) {
  constexpr int bytes = dec_smem<BM>();
  static_assert(bytes <= SMEM_MAX, "shared memory over the per-block limit");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_mvm_dec_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(1, (F + DEC_FT - 1) / DEC_FT, E);
  grouped_mvm_dec_kernel<BM><<<grid, DEC_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), rows, C, D, F);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* w, void* y,
                       const int32_t* rows, int E, int C, int D, int F,
                       cudaStream_t stream) {
  static_assert(MMA_SMEM <= SMEM_MAX, "shared memory over the per-block limit");
  static bool configured = false;
  return launch_grid<__nv_bfloat16>(grouped_mvm_mma_kernel, configured,
                                    MMA_SMEM, MMA_BM, x, w, y, rows, E, C, D,
                                    F, stream);
}

}  // namespace

// dtype: 0 f32, 1 bf16 (x, w and y alike). bm: rows of x per CUDA block,
// 8, 16 or 32 (FMAs), or 64 (f32 FMAs) / 128 (bf16 tensor cores). rows:
// (E,) int32 live rows per expert on the device, or null for all C.
// Returns cudaError_t.
extern "C" int grouped_mvm_launch(const void* x, const void* w, void* y,
                                  const void* rows, int E, int C, int D,
                                  int F, int dtype, int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  if (E > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (bm) {
      case 8: return launch_fma<8>(x, w, y, r, E, C, D, F, st);
      case 16: return launch_fma<16>(x, w, y, r, E, C, D, F, st);
      case 32: return launch_fma<32>(x, w, y, r, E, C, D, F, st);
      case 64: return launch_fma<64>(x, w, y, r, E, C, D, F, st);
    }
  } else if (dtype == 1) {
    switch (bm) {
      case 8: return launch_dec<8>(x, w, y, r, E, C, D, F, st);
      case 16: return launch_dec<16>(x, w, y, r, E, C, D, F, st);
      case 32: return launch_dec<32>(x, w, y, r, E, C, D, F, st);
      case 128: return launch_mma(x, w, y, r, E, C, D, F, st);
    }
  }
  return cudaErrorInvalidValue;
}

// dX (E, C, D) = dY (E, C, F) . w^T over the live rows, bf16; rows as
// grouped_mvm_launch's. Returns cudaError_t.
extern "C" int grouped_mvm_bwd_dx_launch(const void* dy, const void* w,
                                         void* dx, const void* rows, int E,
                                         int C, int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rows);
  if (E > 65535) return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || D == 0) return cudaSuccess;   // no output
  if (F == 0) return cudaMemsetAsync(dx, 0, (size_t)E * C * D * 2, st);
  // pairs of row tiles where C has two, else one block a tile
  return C > BWD_BM ? launch_dx<2>(dy, w, dx, r, E, C, D, F, st)
                    : launch_dx<1>(dy, w, dx, r, E, C, D, F, st);
}

// dW (E, D, F) = x^T . dY summed over the live rows, bf16; an expert with
// none gets zeros. Returns cudaError_t.
extern "C" int grouped_mvm_bwd_dw_launch(const void* x, const void* dy,
                                         void* dw, const void* rows, int E,
                                         int C, int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E > 65535) return cudaErrorInvalidValue;
  if (E == 0 || D == 0 || F == 0) return cudaSuccess;   // no output
  if (C == 0) return cudaMemsetAsync(dw, 0, (size_t)E * D * F * 2, st);
  return launch_dw(x, dy, dw, static_cast<const int32_t*>(rows), E, C, D, F,
                   st);
}
