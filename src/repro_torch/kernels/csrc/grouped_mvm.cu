// Grouped expert GEMM for Hopper (sm_90a):
//
//   y[e] (C, F) = x[e] (C, D) @ w[e] (D, F)   for e in [0, E)
//
// f32 accumulation, one rounding to x's type at the end; x, w and y share
// one type (f32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/packed_mvm.py
// (grouped_mvm / _kernel). The TPU grid (E, C/bc, F/bf, D/bd) stepped over
// D innermost and in order, carrying an f32 accumulator in VMEM across the
// D steps, and its _pick shrank each tile to a divisor of its dimension.
// CUDA blocks run in no order, so one CUDA block per (e, c-tile, f-tile)
// walks the whole D axis itself in 128-deep chunks and writes its (BM, 128)
// output tile once; nothing crosses CUDA blocks. Tiles are fixed instead of
// divisors: loads and stores are masked by the true C, D and F (F = 1408 is
// 11 x 128; C = 5 or 60 happen in real routing), and rows or columns past
// an edge are zero-filled in shared memory, so they add nothing.
//
// Bound: at decode (C = 8) device-memory bytes. Every expert's weights are
// read once per c-tile (369 MB a launch at deepseek-v2-lite widths) for
// 2 * C FLOPs a weight, far below the card's ~295 FLOP/byte balance point;
// a two-stage cp.async ring keeps the next 128-row weight chunk and its x
// slice in flight while the current one is multiplied. At prefill
// (C = 128) the multiply-adds: bf16 launches with C > 32 run them on the
// tensor cores (mma.sync m16n8k16, f32 accumulate; wgmma/TMA are later
// work), f32 launches as f32 FMAs on the CUDA cores.
//
// Work split of the FMA instances (as packed_canvas.cu): 256 threads = 8
// warps; lane l owns output columns [4l, 4l+4) of the tile. With BM = 64
// the 8 warps each own 8 rows of x; with BM = 8 they split each 128-deep
// chunk into 8 slices of 16 and their partial sums meet in shared memory
// at the flush. Either way a thread holds an 8 x 4 accumulator. The
// tensor-core instance is described where it is defined.
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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
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

// bf16 pair in one 32-bit word -> two floats (low half is the first)
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Rows kk..kk+3 of the staged weight chunk, columns [4 lane, 4 lane + 4).
template <typename T>
__device__ __forceinline__ void load_w4(const uint8_t* ws, int kk, int lane,
                                        float w[4][4]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          ws + ((kk + i) * BLK + 4 * lane) * 4);
      w[i][0] = v.x; w[i][1] = v.y; w[i][2] = v.z; w[i][3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          ws + ((kk + i) * BLK + 4 * lane) * 2);
      w[i][0] = bf_lo(v.x); w[i][1] = bf_hi(v.x);
      w[i][2] = bf_lo(v.y); w[i][3] = bf_hi(v.y);
    }
  }
}

template <typename T, int BM>
struct Smem {
  static constexpr int KS = 64 / BM;                       // k slices
  static constexpr int WBYTES = BLK * BLK * (int)sizeof(T);
  static constexpr int XBYTES = BM * BLK * (int)sizeof(T);
  static constexpr int RED = KS * BM * BLK * 4;            // = 32 KB
  // the partial-sum area overlays the weight ring after the loop
  static constexpr int RING = 2 * WBYTES > RED ? 2 * WBYTES : RED;
  static constexpr bool CONVERT_X = sizeof(T) != 4;        // bf16 x -> f32
  static constexpr int X_OFF = RING;
  static constexpr int XF_OFF = X_OFF + 2 * XBYTES;
  static constexpr int TOTAL = XF_OFF + (CONVERT_X ? BM * BLK * 4 : 0);
};

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS)
grouped_mvm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int C, int D, int F) {
  using S = Smem<T, BM>;
  constexpr int KS = S::KS, KL = BLK / KS;
  constexpr int VEC = 16 / (int)sizeof(T);         // elements a 16-byte copy
  constexpr int CH = BLK / VEC;                    // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wring = smem;
  uint8_t* xring = smem + S::X_OFF;

  const int e = blockIdx.z, c0 = blockIdx.x * BM, f0 = blockIdx.y * BLK;
  const T* xe = x + (size_t)e * C * D;
  const T* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / KS, ks = warp % KS;   // row group, k slice
  const int nk = (D + BLK - 1) / BLK;

  // stage D rows [k0, k0 + 128) of w[e]'s column tile and of x[e]'s rows
  auto prefetch = [&](int kc, int st) {
    const int k0 = kc * BLK;
    uint8_t* wd = wring + st * S::WBYTES;
    for (int i = tid; i < BLK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = k0 + r, col = f0 + c * VEC;
      const bool live = row < D && col < F;
      cp16(wd + ((size_t)r * BLK + c * VEC) * sizeof(T),
           we + (live ? (size_t)row * F + col : 0), live);
    }
    uint8_t* xd = xring + st * S::XBYTES;
    for (int i = tid; i < BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = c0 + r, col = k0 + c * VEC;
      const bool live = row < C && col < D;
      cp16(xd + ((size_t)r * BLK + c * VEC) * sizeof(T),
           xe + (live ? (size_t)row * D + col : 0), live);
    }
    cp_commit();
  };

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  prefetch(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) {
      prefetch(kc + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* xf;
    if constexpr (S::CONVERT_X) {
      // bf16 x chunk -> f32 once, so the inner loop reads ready floats
      const uint4* xr = reinterpret_cast<const uint4*>(xring + st * S::XBYTES);
      float4* xo = reinterpret_cast<float4*>(smem + S::XF_OFF);
      for (int i = tid; i < BM * BLK / 8; i += THREADS) {
        const uint4 v = xr[i];
        xo[2 * i] = make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
        xo[2 * i + 1] = make_float4(bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w));
      }
      __syncthreads();
      xf = reinterpret_cast<const float*>(smem + S::XF_OFF);
    } else {
      xf = reinterpret_cast<const float*>(xring + st * S::XBYTES);
    }
    const uint8_t* ws = wring + st * S::WBYTES;
    const float* xrow = xf + (size_t)rg * RPT * BLK;
#pragma unroll 2
    for (int kk = ks * KL; kk < (ks + 1) * KL; kk += 4) {
      float wv[4][4];
      load_w4<T>(ws, kk, lane, wv);
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
    __syncthreads();   // slot st is refilled by the next iteration's prefetch
  }

  // flush: partial sums of the k slices meet in shared memory, laid out
  // [ks][row][col] over the weight ring (every thread is past the loop)
  float* red = reinterpret_cast<float*>(wring);
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    *reinterpret_cast<float4*>(red + ((size_t)ks * BM + rg * RPT + r) * BLK + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  T* ye = y + (size_t)e * C * F;
  for (int i = tid; i < BM * BLK; i += THREADS) {
    const int row = i / BLK, c = i % BLK, grow = c0 + row, gcol = f0 + c;
    if (grow >= C) break;            // rows only grow with i
    if (gcol >= F) continue;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) v += red[((size_t)k * BM + row) * BLK + c];
    ye[(size_t)grow * F + gcol] = from_f<T>(v);
  }
}

// --- bf16 tensor-core instance (prefill: C > 32) -----------------------------
// The same walk over D, with each 128-deep chunk multiplied by mma.sync
// (m16n8k16, bf16 in, f32 accumulate) instead of FMAs: 8 warps as 2 x 4,
// each owning a 32 x 32 piece of the (64, 128) output tile. Rows of the
// staged tiles are padded to 136 elements (272 bytes), so the ldmatrix
// reads of 8 rows hit 8 different 16-byte bank groups.

constexpr int MMA_BM = 64;
constexpr int SROW = BLK + 8;                      // padded row, elements
constexpr int MMA_WBYTES = BLK * SROW * 2;         // w chunk (128 x 136)
constexpr int MMA_XBYTES = MMA_BM * SROW * 2;      // x chunk (64 x 136)
constexpr int MMA_STAGE = MMA_WBYTES + MMA_XBYTES;
constexpr int MMA_SMEM = 2 * MMA_STAGE;            // 104,448 bytes

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

__global__ void __launch_bounds__(THREADS)
grouped_mvm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, int C, int D, int F) {
  constexpr int VEC = 8, CH = BLK / VEC;           // 16-byte copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  const int e = blockIdx.z, c0 = blockIdx.x * MMA_BM, f0 = blockIdx.y * BLK;
  const __nv_bfloat16* xe = x + (size_t)e * C * D;
  const __nv_bfloat16* we = w + (size_t)e * D * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;         // 32-row, 32-column piece
  const int nk = (D + BLK - 1) / BLK;

  auto prefetch = [&](int kc, int st) {
    const int k0 = kc * BLK;
    uint8_t* wd = smem + st * MMA_STAGE;
    uint8_t* xd = wd + MMA_WBYTES;
    for (int i = tid; i < BLK * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = k0 + r, col = f0 + c * VEC;
      const bool live = row < D && col < F;
      cp16(wd + (r * SROW + c * VEC) * 2,
           we + (live ? (size_t)row * F + col : 0), live);
    }
    for (int i = tid; i < MMA_BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH, row = c0 + r, col = k0 + c * VEC;
      const bool live = row < C && col < D;
      cp16(xd + (r * SROW + c * VEC) * 2,
           xe + (live ? (size_t)row * D + col : 0), live);
    }
    cp_commit();
  };

  float acc[2][4][4];                              // [m16 tile][n8 tile][4]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  prefetch(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) {
      prefetch(kc + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ws =
        reinterpret_cast<const __nv_bfloat16*>(smem + st * MMA_STAGE);
    const __nv_bfloat16* xs = ws + MMA_WBYTES / 2;
#pragma unroll
    for (int kk = 0; kk < BLK; kk += 16) {
      uint32_t a[2][4], b[2][4];
      // A: lane l addresses row l % 16, columns kk + 8 (l / 16)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], xs + (wm * 32 + mi * 16 + (lane & 15)) * SROW + kk +
                           (lane >> 4) * 8);
      // B (k-major rows), transposed: matrices (k 0-7 | 8-15) x (n 0-7 |
      // 8-15) give b0b1 / b2b3 of two n8 tiles
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_t(b[nj], ws + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW +
                             wn * 32 + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma16816(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                   b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    __syncthreads();   // slot st is refilled by the next iteration's prefetch
  }

  // flush: fragment (row g | g + 8, columns 2t, 2t + 1) of each tile,
  // g = lane / 4, t = lane % 4; F % 8 == 0 keeps column pairs whole
  __nv_bfloat16* ye = y + (size_t)e * C * F;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = f0 + wn * 32 + ni * 8 + (lane & 3) * 2;
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

cudaError_t launch_mma(const void* x, const void* w, void* y, int E, int C,
                       int D, int F, cudaStream_t stream) {
  static_assert(MMA_SMEM <= 232448, "shared memory over the per-block limit");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_mvm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MMA_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((C + MMA_BM - 1) / MMA_BM, (F + BLK - 1) / BLK, E);
  grouped_mvm_mma_kernel<<<grid, THREADS, MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), C, D, F);
  return cudaGetLastError();
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, void* y, int E, int C,
                   int D, int F, cudaStream_t stream) {
  constexpr int bytes = Smem<T, BM>::TOTAL;
  static_assert(bytes <= 232448, "shared memory over the per-block limit");
  auto kernel = grouped_mvm_kernel<T, BM>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((C + BM - 1) / BM, (F + BLK - 1) / BLK, E);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w),
                                           static_cast<T*>(y), C, D, F);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (x, w and y alike). bm: 8 or 64 rows of x per CUDA
// block; bf16 with 64 rows runs on the tensor cores. Returns cudaError_t.
extern "C" int grouped_mvm_launch(const void* x, const void* w, void* y,
                                  int E, int C, int D, int F, int dtype,
                                  int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E > 65535) return cudaErrorInvalidValue;
  if (bm != 8 && bm != 64) return cudaErrorInvalidValue;
  if (dtype == 0)
    return bm == 8 ? launch<float, 8>(x, w, y, E, C, D, F, st)
                   : launch<float, 64>(x, w, y, E, C, D, F, st);
  if (dtype == 1)
    return bm == 8 ? launch<__nv_bfloat16, 8>(x, w, y, E, C, D, F, st)
                   : launch_mma(x, w, y, E, C, D, F, st);
  return cudaErrorInvalidValue;
}
