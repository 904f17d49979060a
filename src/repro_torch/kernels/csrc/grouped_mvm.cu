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
// multiplied, one barrier a chunk. bf16 multiplies on the tensor cores (mma.sync m16n8k16, f32
// accumulate; wgmma/TMA are later work): at decode the weights are the A
// operand and the few token rows the n8 tiles, so the block only streams;
// at prefill (C = 128) the multiply-adds dominate. C > 128 takes several
// 128-row c-tiles, adjacent in the grid, so the blocks that share an
// expert's weights run together. f32 runs on FMAs (the packing path's
// tests; no serving path is f32).
//
// Layouts: x (E, C, D), w (E, D, F), y (E, C, F), all row-major and
// contiguous. Loads move 16 bytes, so D and F must be multiples of
// 16 / sizeof(T) (8 for bf16, 4 for f32); the wrapper checks this.

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
// Not a Pallas site: the reference differentiates jnp's einsum; the port's
// training forward runs the kernels above, its gradient these two. Both take
// the prefill instance's shape: a 128 x 128 output tile on 8 warps as 4 x 2
// (a 32 x 64 piece each, mma.sync m16n8k16 bf16 -> f32), 64-deep chunks of
// the summed axis through a three-stage cp.async ring with one barrier a
// chunk, and one rounding at the flush. Each block writes its tile once:
// nothing crosses blocks, there are no atomics, and a launch repeats bit for
// bit.
//
// dX is an "NT" product: w[e] (D, F) row-major holds the F weights of each
// output column d contiguous, which is the column-major B operand of
// mma.sync ...row.col as it is stored. So its chunk is staged [d][f] like the
// dY chunk [c][f] and both are read by plain ldmatrix: no transposed copy of
// w. A block per (expert, 128-row c-tile, 128-column d-tile) walks F; rows
// past the live count are zero-filled, a warp whose 32 rows are all dead
// skips its products, and a tile wholly past them writes zeros and reads no
// weight (an expert with no rows reads none).
//
// dW is a "TN" product: a block per (expert, 128-row d-tile, 128-column
// f-tile) walks the expert's live rows itself, 64 a chunk, x's chunk staged
// [c][d] and read transposed by ldmatrix .trans as the A operand, dY's [c][f]
// read as the forward reads its w chunk. An expert with no live rows writes
// zeros and reads nothing.
//
// Bound: at training size (olmoe-1b-7b: 64 experts, C 640, D 2048, F 1024;
// about 512 live rows an expert) each is bound by its 2 x live rows x D x F
// multiply-adds, about 8 times its bytes at the card's balance point.

constexpr int BWD_ROW = MMA_KC + 8;                // padded 64-deep row, elements
constexpr int DX_TILE = BLK * BWD_ROW * 2;         // 128 rows x 72: 18,432 bytes
constexpr int DX_STAGE = 2 * DX_TILE;
constexpr int DX_SMEM = MMA_STAGES * DX_STAGE;     // 110,592: two blocks a SM
constexpr int DW_TILE = MMA_KC * SROW * 2;         // 64 rows x 136: 17,408 bytes
constexpr int DW_STAGE = 2 * DW_TILE;
constexpr int DW_SMEM = MMA_STAGES * DW_STAGE;     // 104,448: two blocks a SM

// The 4 x 2 warps' (128, 128) tile of f32 sums, rounded to bf16 into a
// row-major (rows, cols) matrix with leading dimension ``ld``: fragment (row
// g | g + 8, columns 2t, 2t + 1) of each tile, g = lane / 4, t = lane % 4;
// cols % 8 == 0 keeps column pairs whole.
__device__ __forceinline__ void flush_tile(const float (&acc)[2][8][4],
                                           __nv_bfloat16* __restrict__ out,
                                           int r0, int c0, int rows, int cols,
                                           int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = c0 + wn * 64 + ni * 8 + (lane & 3) * 2;
      if (col >= cols) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm * 32 + mi * 16 + (lane >> 2) + h * 8;
        if (row < rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ld + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

__global__ void __launch_bounds__(THREADS)
grouped_mvm_dx_kernel(const __nv_bfloat16* __restrict__ dy,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ dx,
                      const int32_t* __restrict__ rows, int C, int D, int F) {
  constexpr int NS = MMA_STAGES, CH = MMA_KC / 8;  // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  const int e = blockIdx.z, c0 = blockIdx.x * MMA_BM, d0 = blockIdx.y * BLK;
  const int live = live_rows(rows, e, C);
  if (c0 >= live) {                // no live row here: no weight is read
    zero_tile(dx, e, c0, MMA_BM, C, d0, BLK, D);
    return;
  }
  const __nv_bfloat16* dye = dy + (size_t)e * C * F;
  const __nv_bfloat16* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;         // 32-row, 64-column piece
  const bool busy = c0 + wm * 32 < live;           // any live row in the piece
  const int nk = (F + MMA_KC - 1) / MMA_KC;
  // stage F columns [k0, k0 + 64) of dY's live rows and of w's d-tile rows
  auto prefetch = [&](int kc) {
    const int k0 = kc * MMA_KC;
    uint8_t* ad = smem + (kc % NS) * DX_STAGE;
    uint8_t* bd = ad + DX_TILE;
    for (int i = tid; i < MMA_BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, col = k0 + c * 8;
      const bool oka = c0 + r < live && col < F, okb = d0 + r < D && col < F;
      cp16(ad + (r * BWD_ROW + c * 8) * 2,
           dye + (oka ? (size_t)(c0 + r) * F + col : 0), oka);
      cp16(bd + (r * BWD_ROW + c * 8) * 2,
           we + (okb ? (size_t)(d0 + r) * F + col : 0), okb);
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
    const __nv_bfloat16* as =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kc % NS) * DX_STAGE);
    const __nv_bfloat16* bs = as + DX_TILE / 2;
#pragma unroll
    for (int kk = 0; kk < MMA_KC; kk += 16) {
      uint32_t a[2][4];
      // A = dY: lane l addresses row l % 16, columns kk + 8 (l / 16)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * BWD_ROW + kk +
                           (lane >> 4) * 8);
      // B = w^T, stored [d][f] (n-major, k contiguous): matrices (n 0-7 |
      // 8-15) x (k 0-7 | 8-15) give b0b1 / b2b3 of two n8 tiles
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_x4(b, bs + (wn * 64 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) *
                            BWD_ROW + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();
  // rows past the live count hold zeros (their dY rows were zero-filled, or
  // the warp skipped its products)
  flush_tile(acc, dx + (size_t)e * C * D, c0, d0, C, D, D);
}

__global__ void __launch_bounds__(THREADS)
grouped_mvm_dw_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ dy,
                      __nv_bfloat16* __restrict__ dw,
                      const int32_t* __restrict__ rows, int C, int D, int F) {
  constexpr int NS = MMA_STAGES, CH = BLK / 8;     // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  const int e = blockIdx.z, f0 = blockIdx.x * BLK, d0 = blockIdx.y * BLK;
  const int live = live_rows(rows, e, C);
  if (live == 0) {                 // no token chose this expert
    zero_tile(dw, e, d0, BLK, D, f0, BLK, F);
    return;
  }
  const __nv_bfloat16* xe = x + (size_t)e * C * D;
  const __nv_bfloat16* dye = dy + (size_t)e * C * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;         // 32-row, 64-column piece
  const int nk = (live + MMA_KC - 1) / MMA_KC;     // the live rows only
  // stage live rows [k0, k0 + 64) of x's d-tile and of dY's f-tile
  auto prefetch = [&](int kc) {
    const int k0 = kc * MMA_KC;
    uint8_t* ad = smem + (kc % NS) * DW_STAGE;
    uint8_t* bd = ad + DW_TILE;
    for (int i = tid; i < MMA_KC * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = k0 + r;
      const bool oka = row < live && d0 + c * 8 < D;
      const bool okb = row < live && f0 + c * 8 < F;
      cp16(ad + (r * SROW + c * 8) * 2,
           xe + (oka ? (size_t)row * D + d0 + c * 8 : 0), oka);
      cp16(bd + (r * SROW + c * 8) * 2,
           dye + (okb ? (size_t)row * F + f0 + c * 8 : 0), okb);
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
    const __nv_bfloat16* as =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kc % NS) * DW_STAGE);
    const __nv_bfloat16* bs = as + DW_TILE / 2;
#pragma unroll
    for (int kk = 0; kk < MMA_KC; kk += 16) {
      // A = x^T, stored [c][d] (k-major): matrix j = lane / 8 is (d +8 (j &
      // 1), c +8 (j / 2)), read transposed
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(a[mi], as + (kk + (lane >> 4) * 8 + (lane & 7)) * SROW +
                             wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8);
      // B = dY, stored [c][f] (k-major rows), transposed as the forward's w
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, bs + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW +
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
  flush_tile(acc, dw + (size_t)e * D * F, d0, f0, D, F, F);
}

// One backward launch: the kernel's shared-memory limit set on its first
// launch (``configured`` is the kernel's own), a grid of (x tiles, y tiles,
// E) blocks.
template <typename Kernel>
cudaError_t launch_bwd(Kernel kernel, bool& configured, int bytes, dim3 grid,
                       const void* a, const void* b, void* out,
                       const int32_t* rows, int C, int D, int F,
                       cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), rows, C, D, F);
  return cudaGetLastError();
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
  static_assert(DX_SMEM <= SMEM_MAX, "shared memory over the per-block limit");
  static bool configured = false;
  if (E > 65535) return cudaErrorInvalidValue;
  const dim3 grid((C + MMA_BM - 1) / MMA_BM, (D + BLK - 1) / BLK, E);
  return launch_bwd(grouped_mvm_dx_kernel, configured, DX_SMEM, grid, dy, w,
                    dx, static_cast<const int32_t*>(rows), C, D, F,
                    static_cast<cudaStream_t>(stream));
}

// dW (E, D, F) = x^T . dY summed over the live rows, bf16; an expert with
// none gets zeros. Returns cudaError_t.
extern "C" int grouped_mvm_bwd_dw_launch(const void* x, const void* dy,
                                         void* dw, const void* rows, int E,
                                         int C, int D, int F, void* stream) {
  static_assert(DW_SMEM <= SMEM_MAX, "shared memory over the per-block limit");
  static bool configured = false;
  if (E > 65535) return cudaErrorInvalidValue;
  const dim3 grid((F + BLK - 1) / BLK, (D + BLK - 1) / BLK, E);
  return launch_bwd(grouped_mvm_dw_kernel, configured, DW_SMEM, grid, x, dy,
                    dw, static_cast<const int32_t*>(rows), C, D, F,
                    static_cast<cudaStream_t>(stream));
}
