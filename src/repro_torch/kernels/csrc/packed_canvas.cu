// Packed-canvas block-sparse MVM for Hopper (sm_90a), fp and int8/int4
// weights, with an optional fused epilogue:
//
//   y (B, C) = act(x_packed (B, R) @ W_virtual (R, C) + bias) + residual
//
// where W_virtual is held only as its occupied 128x128 blocks, in the
// cb-major order of meta (4, G).
//
// Replaces the Pallas TPU kernels src/repro/kernels/packed_canvas.py
// (_packed_canvas_matmul / _kernel, _packed_canvas_epilogue /
// _kernel_epilogue) and src/repro/kernels/dequant.py (_matmul_dq /
// _kernel_dq, _matmul_dq_epilogue / _kernel_dq_epilogue). The TPU grid
// (B/bb, G) stepped over the blocks in order and carried an f32
// accumulator in VMEM from a run's first block to its last; CUDA blocks run
// in no order, so one CUDA block per (batch tile, output block cb) walks
// cb's run of blocks [cb_start[cb], cb_start[cb+1]) itself and writes its
// (BM, 128) output tile once. Nothing crosses CUDA blocks.
//
// Bound: at decode batch sizes, device-memory bytes. Each stored block is
// read once per batch tile (32 KB bf16, 16 KB int8, 8 KB int4) for
// 2 * B * 128 * 128 FLOPs, far below the card's ~295 FLOP/byte balance
// point; zero blocks of the virtual plane are never stored or read. The
// design: a two-stage cp.async ring keeps the next block's weights, scales
// and x tile in flight while the current one is multiplied; quantized
// blocks travel as their payload and are expanded to f32 (with the
// channel's scale) in registers as they are read from shared memory, so
// the fp plane never exists in device memory. Arithmetic is f32 FMAs on
// the CUDA cores (exact products of bf16 inputs, f32 sums); the tensor-core
// (wgmma/TMA) version is later work.
//
// Work split: 256 threads = 8 warps; lane l owns output columns
// [4l, 4l+4). With BM = 64 the 8 warps each own 8 batch rows; with BM = 8
// they split the 128-deep block into 8 slices of 16 and their partial sums
// are added in shared memory at the flush. Either way a thread holds an
// 8 x 4 accumulator. Rows at or past the true B are never loaded or stored.
//
// Layouts: x (B, R) f32 or bf16; fp blocks (G, 128, 128) f32 or bf16;
// int8 blocks (G, 128, 128); int4 blocks (G, 64, 128) uint8, byte [r][c]
// holding rows 2r (low nibble) and 2r+1 (high nibble) biased by +8; scales
// (G, 128) f32; meta row 0 = each block's kb; cb_start (C/128 + 1) int32;
// bias (C,) and residual (B, C) in x's type, or null; out (B, C) in x's
// type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;
constexpr int THREADS = 256;
constexpr int RPT = 8;        // batch rows per thread

enum WFormat { W_F32 = 0, W_BF16 = 1, W_INT8 = 2, W_INT4 = 3 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

template <int WF> struct WTraits;
template <> struct WTraits<W_F32>  { static constexpr int BYTES = BLK * BLK * 4; };
template <> struct WTraits<W_BF16> { static constexpr int BYTES = BLK * BLK * 2; };
template <> struct WTraits<W_INT8> { static constexpr int BYTES = BLK * BLK; };
template <> struct WTraits<W_INT4> { static constexpr int BYTES = BLK * BLK / 2; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// 16-byte global -> shared copy; src_bytes 0 fills zeros and reads nothing
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
// exact small integers through the float mantissa: 2^23 + n - 2^23 - off
__device__ __forceinline__ float int8_at(uint32_t u, int j) {   // q in [-127, 127]
  const uint32_t b = ((u >> (8 * j)) & 0xffu) ^ 0x80u;            // q + 128
  return __uint_as_float(0x4b000000u | b) - 8388736.0f;          // 2^23 + 128
}
__device__ __forceinline__ float nib_at(uint32_t u, int shift) {  // q in [-8, 7]
  const uint32_t n = (u >> shift) & 0xfu;                         // q + 8
  return __uint_as_float(0x4b000000u | n) - 8388616.0f;          // 2^23 + 8
}

// Rows kk..kk+3 of the staged block, columns [4 lane, 4 lane + 4), as f32
// (quantized formats times their channel's scale, as the reference's
// dequantize_blocks computes them).
template <int WF>
__device__ __forceinline__ void load_w4(const uint8_t* ws, int kk, int lane,
                                        const float* s, float w[4][4]) {
  if constexpr (WF == W_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          ws + ((kk + i) * BLK + 4 * lane) * 4);
      w[i][0] = v.x; w[i][1] = v.y; w[i][2] = v.z; w[i][3] = v.w;
    }
  } else if constexpr (WF == W_BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          ws + ((kk + i) * BLK + 4 * lane) * 2);
      w[i][0] = bf_lo(v.x); w[i][1] = bf_hi(v.x);
      w[i][2] = bf_lo(v.y); w[i][3] = bf_hi(v.y);
    }
  } else if constexpr (WF == W_INT8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          ws + (kk + i) * BLK + 4 * lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[i][j] = int8_at(v, j) * s[j];
    }
  } else {   // W_INT4: payload row p holds block rows 2p (low) and 2p+1 (high)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          ws + ((kk + i) >> 1) * BLK + 4 * lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[i][j] = nib_at(v, 8 * j) * s[j];
        w[i + 1][j] = nib_at(v, 8 * j + 4) * s[j];
      }
    }
  }
}

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.f);
    case ACT_SILU: return y / (1.f + expf(-y));
    case ACT_GELU: {   // tanh form, as jax.nn.gelu(approximate=True)
      const float c = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    default: return y;
  }
}

template <typename XT, int WF, int BM>
struct Smem {
  static constexpr int KS = 64 / BM;                       // k slices
  static constexpr int WBYTES = WTraits<WF>::BYTES;
  static constexpr int XBYTES = BM * BLK * (int)sizeof(XT);
  static constexpr int RED = KS * BM * BLK * 4;            // = 32 KB
  // the partial-sum area overlays the weight ring after the loop
  static constexpr int RING = 2 * WBYTES > RED ? 2 * WBYTES : RED;
  static constexpr bool QUANT = WF == W_INT8 || WF == W_INT4;
  static constexpr bool CONVERT_X = sizeof(XT) != 4;       // bf16 x -> f32
  static constexpr int W_OFF = 0;
  static constexpr int X_OFF = RING;
  static constexpr int XF_OFF = X_OFF + 2 * XBYTES;
  static constexpr int S_OFF = XF_OFF + (CONVERT_X ? BM * BLK * 4 : 0);
  static constexpr int TOTAL = S_OFF + (QUANT ? 2 * BLK * 4 : 0);
};

template <typename XT, int WF, int BM, bool EPI>
__global__ void __launch_bounds__(THREADS)
packed_canvas_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scales,
                     const int32_t* __restrict__ kb_of,
                     const int32_t* __restrict__ cb_start,
                     const XT* __restrict__ bias,
                     const XT* __restrict__ residual, XT* __restrict__ out,
                     int B, int R, int C, int act) {
  using S = Smem<XT, WF, BM>;
  constexpr int KS = S::KS, KL = BLK / KS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wring = smem + S::W_OFF;
  uint8_t* xring = smem + S::X_OFF;
  float* sring = reinterpret_cast<float*>(smem + S::S_OFF);

  const int cb = blockIdx.y, b0 = blockIdx.x * BM;
  const int g0 = cb_start[cb], g1 = cb_start[cb + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / KS, ks = warp % KS;   // row group, k slice

  // stage block g (weights, x tile, scales) into ring slot st
  auto prefetch = [&](int g, int st) {
    const uint8_t* src = w + (size_t)g * S::WBYTES;
    uint8_t* dst = wring + st * S::WBYTES;
    for (int i = tid; i < S::WBYTES / 16; i += THREADS)
      cp16(dst + 16 * i, src + 16 * i, true);
    constexpr int XCH = BLK * (int)sizeof(XT) / 16;   // 16-byte chunks a row
    const size_t col = (size_t)kb_of[g] * BLK;
    uint8_t* xd = xring + st * S::XBYTES;
    for (int i = tid; i < BM * XCH; i += THREADS) {
      const int r = i / XCH, c = i % XCH, row = b0 + r;
      const bool live = row < B;
      const XT* xs = x + (size_t)(live ? row : 0) * R + col;
      cp16(xd + (size_t)r * BLK * sizeof(XT) + 16 * c,
           reinterpret_cast<const uint8_t*>(xs) + 16 * c, live);
    }
    if constexpr (S::QUANT) {
      if (tid < BLK / 4)
        cp16(sring + st * BLK + 4 * tid, scales + (size_t)g * BLK + 4 * tid,
             true);
    }
    cp_commit();
  };

  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  if (g0 < g1) prefetch(g0, 0);
  for (int g = g0; g < g1; ++g) {
    const int st = (g - g0) & 1;
    if (g + 1 < g1) {
      prefetch(g + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* xf;
    if constexpr (S::CONVERT_X) {
      // bf16 x tile -> f32 once, so the inner loop reads ready floats
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
    float s[4] = {1.f, 1.f, 1.f, 1.f};
    if constexpr (S::QUANT) {
      const float4 sv = *reinterpret_cast<const float4*>(sring + st * BLK + 4 * lane);
      s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
    }
    const uint8_t* ws = wring + st * S::WBYTES;
    const float* xrow = xf + (size_t)rg * RPT * BLK;
#pragma unroll 2
    for (int kk = ks * KL; kk < (ks + 1) * KL; kk += 4) {
      float wv[4][4];
      load_w4<WF>(ws, kk, lane, s, wv);
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
  for (int i = tid; i < BM * BLK; i += THREADS) {
    const int row = i / BLK, c = i % BLK, grow = b0 + row;
    if (grow >= B) break;            // rows only grow with i
    float y = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) y += red[((size_t)k * BM + row) * BLK + c];
    const size_t gc = (size_t)cb * BLK + c, o = (size_t)grow * C + gc;
    if constexpr (EPI) {
      if (bias) y += to_f(bias[gc]);
      y = activate(y, act);
      if (residual) y += to_f(residual[o]);
    }
    out[o] = from_f<XT>(y);
  }
}

template <typename XT, int WF, int BM, bool EPI>
cudaError_t launch(const void* x, const void* w, const float* scales,
                   const int32_t* kb_of, const int32_t* cb_start,
                   const void* bias, const void* residual, void* out, int B,
                   int R, int C, int act, cudaStream_t stream) {
  constexpr int bytes = Smem<XT, WF, BM>::TOTAL;
  static_assert(bytes <= 232448, "shared memory over the per-block limit");
  auto kernel = packed_canvas_kernel<XT, WF, BM, EPI>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((B + BM - 1) / BM, C / BLK);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(w), scales,
      kb_of, cb_start, static_cast<const XT*>(bias),
      static_cast<const XT*>(residual), static_cast<XT*>(out), B, R, C, act);
  return cudaGetLastError();
}

template <typename XT, int WF, int BM>
cudaError_t pick_epi(int epi, const void* x, const void* w, const float* sc,
                     const int32_t* kb, const int32_t* cs, const void* bias,
                     const void* res, void* out, int B, int R, int C, int act,
                     cudaStream_t st) {
  return epi ? launch<XT, WF, BM, true>(x, w, sc, kb, cs, bias, res, out, B, R, C, act, st)
             : launch<XT, WF, BM, false>(x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
}

template <typename XT, int WF>
cudaError_t pick_bm(int bm, int epi, const void* x, const void* w,
                    const float* sc, const int32_t* kb, const int32_t* cs,
                    const void* bias, const void* res, void* out, int B,
                    int R, int C, int act, cudaStream_t st) {
  if (bm == 8) return pick_epi<XT, WF, 8>(epi, x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
  if (bm == 64) return pick_epi<XT, WF, 64>(epi, x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
  return cudaErrorInvalidValue;
}

template <typename XT>
cudaError_t pick_w(int wfmt, int bm, int epi, const void* x, const void* w,
                   const float* sc, const int32_t* kb, const int32_t* cs,
                   const void* bias, const void* res, void* out, int B,
                   int R, int C, int act, cudaStream_t st) {
  switch (wfmt) {
    case W_F32: return pick_bm<XT, W_F32>(bm, epi, x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
    case W_BF16: return pick_bm<XT, W_BF16>(bm, epi, x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
    case W_INT8: return pick_bm<XT, W_INT8>(bm, epi, x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
    case W_INT4: return pick_bm<XT, W_INT4>(bm, epi, x, w, sc, kb, cs, bias, res, out, B, R, C, act, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xfmt: 0 f32, 1 bf16. wfmt: 0 f32, 1 bf16, 2 int8, 3 int4. bm: 8 or 64.
// meta: (4, G) int32, row 0 read as each block's kb. Returns cudaError_t.
extern "C" int packed_canvas_launch(const void* x, const void* w,
                                    const void* scales, const void* meta,
                                    const void* cb_start, const void* bias,
                                    const void* residual, void* out, int B,
                                    int R, int C, int xfmt, int wfmt, int bm,
                                    int epi, int act, void* stream) {
  const float* sc = static_cast<const float*>(scales);
  const int32_t* kb = static_cast<const int32_t*>(meta);
  const int32_t* cs = static_cast<const int32_t*>(cb_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < ACT_NONE || act > ACT_GELU) return cudaErrorInvalidValue;
  if (xfmt == 0)
    return pick_w<float>(wfmt, bm, epi, x, w, sc, kb, cs, bias, residual, out, B, R, C, act, st);
  if (xfmt == 1)
    return pick_w<__nv_bfloat16>(wfmt, bm, epi, x, w, sc, kb, cs, bias, residual, out, B, R, C, act, st);
  return cudaErrorInvalidValue;
}
