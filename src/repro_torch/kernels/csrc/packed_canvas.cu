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
// accumulator in VMEM from a run's first block to its last. CUDA blocks
// run in no order, so one CUDA block per (chunk, batch tile) walks the
// chunk's blocks itself. A chunk is a whole run of output block cb,
// [cb_start[cb], cb_start[cb+1]), and then the block writes its output
// tile once. Where whole runs would leave SMs idle, the host's split plan
// cuts runs into chunks: each chunk writes its f32 sums to a workspace,
// and a combine kernel in the same call adds a run's chunks in their
// order, then applies the epilogue and the one rounding. No atomics, so
// the result does not depend on the schedule.
//
// Bound: device-memory bytes up to B = 128 on the tensor cores. Each
// stored block (32 KB bf16, 16 KB int8, 8 KB int4) is read once a launch
// for 2 * B * 128 * 128 operations; zero blocks of the virtual plane are
// never stored or read.
//
// Tensor-core routine (bf16 x over bf16, int8 or int4 blocks), tc_kernel:
// y^T = W^T x^T on wgmma (bf16 in, f32 accumulate), the weights the A
// operand from registers and a batch tile of 8, 16, 32, 64 or 128 rows
// (the smallest that holds B, 128 past it) the B operand from shared
// memory, so one batch tile reads each block once to B = 128. A producer
// warp streams each block's weights, its x tile and its scales through
// the Tensor Memory Accelerator into a ring of 3-4 stages (mbarriers;
// tensor maps with the 128-byte swizzle, which is also the wgmma
// descriptor's layout of the x tile, and under which the A loads hit
// distinct banks without padding). Two consumer warpgroups own 64 output
// columns each, one m64 x BM x 16 wgmma a k step; the next step's A is
// formed while this one's runs. bf16 weights reach the A fragment by
// ldmatrix.trans; the int8 and int4 payloads travel raw and are expanded
// to bf16 in registers as the fragment is formed (load_a: the integers
// are exact in bf16). The per-(block, column) scale multiplies the
// block's f32 partial sum once: acc[:, c] += s[g, c] * sum_k x[:, k]
// q[k, c].
//
// f32 FMA routine (f32 x, or f32 blocks), fma_kernel: the TPU's f32
// arithmetic on the CUDA cores, a two-stage cp.async ring, 256 threads as
// 8 warps whose lane l owns columns [4l, 4l + 4); with an 8-row tile the
// warps split the block's k into 8 slices, with a 64-row tile they own 8
// rows each. The same per-block scale, chunks and flush.
//
// Flush: the block's f32 sums go through shared memory, 8 columns a
// thread, to the sink: the epilogue (bias, activation, residual, one
// rounding to x's type) and 16-byte stores, or a chunk's workspace rows.
// Rows at or past the true B are never loaded (TMA fills them with zeros)
// or stored.
//
// Layouts: x (B, R) f32 or bf16; fp blocks (G, 128, 128) f32 or bf16;
// int8 blocks (G, 128, 128); int4 blocks (G, 64, 128) uint8, byte [r][c]
// holding rows 2r (low nibble) and 2r+1 (high nibble) biased by +8; scales
// (G, 128) f32; meta row 0 = each block's kb; chunk_off (n_chunks + 1),
// chunk_cb (n_chunks), order (n_chunks: the launch order of the chunks)
// and cb_chunk (C/128 + 1) int32 from the split plan; bias (C,) and
// residual (B, C) in x's type, or null; out (B, C) in x's type; ws
// (n_chunks, B, 128) f32 when the runs are split, else null.

#include <cuda.h>           // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;
constexpr int TROW = BLK + 4;       // f32 flush-tile row, padded
constexpr int SMEM_MAX = 232448;    // a block's shared memory, at most
constexpr int SMEM_SM = 233472;     // an SM's

enum WFormat { W_F32 = 0, W_BF16 = 1, W_INT8 = 2, W_INT4 = 3 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

template <int WF> struct WTraits;
template <> struct WTraits<W_F32>  { static constexpr int BYTES = BLK * BLK * 4; };
template <> struct WTraits<W_BF16> { static constexpr int BYTES = BLK * BLK * 2; };
template <> struct WTraits<W_INT8> { static constexpr int BYTES = BLK * BLK; };
template <> struct WTraits<W_INT4> { static constexpr int BYTES = BLK * BLK / 2; };

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
// exact small integers through the float mantissa: 2^23 + n - 2^23 - off
__device__ __forceinline__ float int8_at(uint32_t u, int j) {   // q in [-127, 127]
  const uint32_t b = ((u >> (8 * j)) & 0xffu) ^ 0x80u;            // q + 128
  return __uint_as_float(0x4b000000u | b) - 8388736.0f;          // 2^23 + 128
}
__device__ __forceinline__ float nib_at(uint32_t u, int shift) {  // q in [-8, 7]
  const uint32_t n = (u >> shift) & 0xfu;                         // q + 8
  return __uint_as_float(0x4b000000u | n) - 8388616.0f;          // 2^23 + 8
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

// 8 consecutive values (16-byte aligned) to and from f32
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  v[0] = bf_lo(u.x); v[1] = bf_hi(u.x); v[2] = bf_lo(u.y); v[3] = bf_hi(u.y);
  v[4] = bf_lo(u.z); v[5] = bf_hi(u.z); v[6] = bf_lo(u.w); v[7] = bf_hi(u.w);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf2(v[0], v[1]), pack_bf2(v[2], v[3]),
                                            pack_bf2(v[4], v[5]), pack_bf2(v[6], v[7]));
}

// --- the split plan and the flush ----------------------------------------------

// A launch's chunks (the host's split plan): chunk ci holds blocks
// [chunk_off[ci], chunk_off[ci+1]) of output block chunk_cb[ci]. CUDA
// block x runs batch tile x % tiles of chunk order[x / tiles]: a chunk's
// tiles run side by side, so its blocks' second reads hit L2.
struct Plan {
  const int32_t* kb_of;
  const int32_t* chunk_off;
  const int32_t* chunk_cb;
  const int32_t* order;
  int tiles;
};

// Where a CUDA block's f32 sums go, 8 columns at a time: the output through
// the epilogue, or a split chunk's workspace rows.
template <typename XT>
struct Sink {
  XT* out;
  float* ws;
  const XT* bias;
  const XT* residual;
  int B, C, act;

  // columns c .. c + 7 of output block cb in rows row0, row0 + step, ...
  // (N of them; those at or past `end` are skipped): + bias, activation,
  // + residual, one rounding. Every residual load is issued before the
  // first store, so a thread's rows wait on memory once.
  template <int N>
  __device__ __forceinline__ void final_rows(int cb, int row0, int step, int end,
                                             int c, float (&y)[N][8]) const {
    const size_t gc = (size_t)cb * BLK + c;
    float e[N][8];
    if (residual) {
#pragma unroll
      for (int it = 0; it < N; ++it)
        if (row0 + it * step < end)
          load8(residual + (size_t)(row0 + it * step) * C + gc, e[it]);
    }
    if (bias) {
      float bv[8];
      load8(bias + gc, bv);
#pragma unroll
      for (int it = 0; it < N; ++it)
#pragma unroll
        for (int j = 0; j < 8; ++j) y[it][j] += bv[j];
    }
#pragma unroll
    for (int it = 0; it < N; ++it) {
      if (row0 + it * step >= end) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[it][j] = activate(y[it][j], act);
        if (residual) y[it][j] += e[it][j];
      }
      store8(out + (size_t)(row0 + it * step) * C + gc, y[it]);
    }
  }
  // the same rows to the output, or to chunk ci's workspace rows
  template <int N>
  __device__ __forceinline__ void put_rows(int ci, int cb, int row0, int step,
                                           int end, int c, float (&y)[N][8]) const {
    if (!ws) return final_rows<N>(cb, row0, step, end, c, y);
#pragma unroll
    for (int it = 0; it < N; ++it)
      if (row0 + it * step < end)
        store8(ws + ((size_t)ci * B + row0 + it * step) * BLK + c, y[it]);
  }
};

// A block's output tile, its f32 sums in shared memory as KS slices of
// [BM][TROW] (added in slice order), to the sink: a thread takes 8
// consecutive columns of every (NTHREADS / 16)-th row, so loads and stores
// are 16 bytes and coalesced, up to 4 rows at a time (their residual loads
// in flight together). Rows at or past B are not stored.
template <typename XT, int BM, int KS, int NTHREADS>
__device__ __forceinline__ void flush_tile(const float* tile, const Sink<XT>& sink,
                                           int ci, int cb, int b0, int tid) {
  constexpr int STEP = NTHREADS / (BLK / 8), N = (BM + STEP - 1) / STEP;
  constexpr int GRP = N < 4 ? N : 4;
  static_assert(N % GRP == 0, "row groups");
  const int r0 = tid / (BLK / 8), c = (tid % (BLK / 8)) * 8;
  const int end = b0 + BM < sink.B ? b0 + BM : sink.B;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += GRP) {
    float y[GRP][8], v[8];
#pragma unroll
    for (int it = 0; it < GRP; ++it) {
      const int r = r0 + (i0 + it) * STEP, row = r < BM ? r : BM - 1;
      load8(tile + (size_t)row * TROW + c, y[it]);
#pragma unroll
      for (int k = 1; k < KS; ++k) {
        load8(tile + ((size_t)k * BM + row) * TROW + c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) y[it][j] += v[j];
      }
    }
    sink.template put_rows<GRP>(ci, cb, b0 + r0 + i0 * STEP, STEP, end, c, y);
  }
}

// A split run's chunks, summed in chunk order, through the epilogue: grid
// (C/128, row groups), 256 threads, 8 columns a thread.
template <typename XT>
__global__ void __launch_bounds__(256)
combine_kernel(const int32_t* __restrict__ cb_chunk, Sink<XT> sink) {
  const int cb = blockIdx.x, c0 = cb_chunk[cb], c1 = cb_chunk[cb + 1];
  for (int i = blockIdx.y * 256 + threadIdx.x; i < sink.B * (BLK / 8);
       i += gridDim.y * 256) {
    const int row = i / (BLK / 8), c = (i % (BLK / 8)) * 8;
    float y[1][8], v[8];
    load8(sink.ws + ((size_t)c0 * sink.B + row) * BLK + c, y[0]);
    for (int ch = c0 + 1; ch < c1; ++ch) {
      load8(sink.ws + ((size_t)ch * sink.B + row) * BLK + c, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[0][j] += v[j];
    }
    sink.template final_rows<1>(cb, row, 0, sink.B, c, y);
  }
}

// --- f32 FMA routine (f32 x, or f32 blocks) ----------------------------------------

constexpr int FMA_THREADS = 256;
constexpr int RPT = 8;        // batch rows per thread

// Rows kk..kk+3 of the staged block, columns [4 lane, 4 lane + 4), as f32
// (the quantized formats as their integers; the scale comes after the
// block's sum).
template <int WF>
__device__ __forceinline__ void load_w4(const uint8_t* ws, int kk, int lane,
                                        float w[4][4]) {
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
      for (int j = 0; j < 4; ++j) w[i][j] = int8_at(v, j);
    }
  } else {   // W_INT4: payload row p holds block rows 2p (low) and 2p+1 (high)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          ws + ((kk + i) >> 1) * BLK + 4 * lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[i][j] = nib_at(v, 8 * j);
        w[i + 1][j] = nib_at(v, 8 * j + 4);
      }
    }
  }
}

template <typename XT, int WF, int BM>
struct FmaSmem {
  static constexpr int KS = 64 / BM;                       // k slices
  static constexpr int WBYTES = WTraits<WF>::BYTES;
  static constexpr int XBYTES = BM * BLK * (int)sizeof(XT);
  static constexpr int TILE = KS * BM * TROW * 4;          // flush tile
  // the flush tile overlays the weight ring after the loop
  static constexpr int RING = 2 * WBYTES > TILE ? 2 * WBYTES : TILE;
  static constexpr bool QUANT = WF == W_INT8 || WF == W_INT4;
  static constexpr bool CONVERT_X = sizeof(XT) != 4;       // bf16 x -> f32
  static constexpr int W_OFF = 0;
  static constexpr int X_OFF = RING;
  static constexpr int XF_OFF = X_OFF + 2 * XBYTES;
  static constexpr int S_OFF = XF_OFF + (CONVERT_X ? BM * BLK * 4 : 0);
  static constexpr int TOTAL = S_OFF + (QUANT ? 2 * BLK * 4 : 0);
};

template <typename XT, int WF, int BM>
__global__ void __launch_bounds__(FMA_THREADS)
fma_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scales, Plan plan, Sink<XT> sink, int R) {
  using S = FmaSmem<XT, WF, BM>;
  constexpr int KS = S::KS, KL = BLK / KS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wring = smem + S::W_OFF;
  uint8_t* xring = smem + S::X_OFF;
  float* sring = reinterpret_cast<float*>(smem + S::S_OFF);

  const int ci = plan.order[blockIdx.x / plan.tiles], cb = plan.chunk_cb[ci];
  const int g0 = plan.chunk_off[ci], g1 = plan.chunk_off[ci + 1];
  const int b0 = (blockIdx.x % plan.tiles) * BM, B = sink.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / KS, ks = warp % KS;   // row group, k slice

  // stage block g (weights, x tile, scales) into ring slot st
  auto prefetch = [&](int g, int st) {
    const uint8_t* src = w + (size_t)g * S::WBYTES;
    uint8_t* dst = wring + st * S::WBYTES;
    for (int i = tid; i < S::WBYTES / 16; i += FMA_THREADS)
      cp16(dst + 16 * i, src + 16 * i, true);
    constexpr int XCH = BLK * (int)sizeof(XT) / 16;   // 16-byte chunks a row
    const size_t col = (size_t)plan.kb_of[g] * BLK;
    uint8_t* xd = xring + st * S::XBYTES;
    for (int i = tid; i < BM * XCH; i += FMA_THREADS) {
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

  float acc[RPT][4], part[RPT][4];
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
      for (int i = tid; i < BM * BLK / 8; i += FMA_THREADS) {
        const uint4 v = xr[i];
        xo[2 * i] = make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
        xo[2 * i + 1] = make_float4(bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w));
      }
      __syncthreads();
      xf = reinterpret_cast<const float*>(smem + S::XF_OFF);
    } else {
      xf = reinterpret_cast<const float*>(xring + st * S::XBYTES);
    }
    // fp blocks accumulate straight into acc; a quantized block's integer
    // sum gathers in part and meets its scale once
    float (&dst)[RPT][4] = S::QUANT ? part : acc;
    if constexpr (S::QUANT) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[r][j] = 0.f;
    }
    const uint8_t* ws = wring + st * S::WBYTES;
    const float* xrow = xf + (size_t)rg * RPT * BLK;
#pragma unroll 2
    for (int kk = ks * KL; kk < (ks + 1) * KL; kk += 4) {
      float wv[4][4];
      load_w4<WF>(ws, kk, lane, wv);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xrow + r * BLK + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = dst[r][j];
          a = fmaf(xv.x, wv[0][j], a);
          a = fmaf(xv.y, wv[1][j], a);
          a = fmaf(xv.z, wv[2][j], a);
          a = fmaf(xv.w, wv[3][j], a);
          dst[r][j] = a;
        }
      }
    }
    if constexpr (S::QUANT) {
      const float4 sv = *reinterpret_cast<const float4*>(sring + st * BLK + 4 * lane);
      const float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(s[j], part[r][j], acc[r][j]);
    }
    __syncthreads();   // slot st is refilled by the next iteration's prefetch
  }

  // flush: the k slices' sums meet in shared memory, laid out
  // [ks][row][TROW] over the weight ring (every thread is past the loop)
  float* tile = reinterpret_cast<float*>(wring);
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    *reinterpret_cast<float4*>(tile + ((size_t)ks * BM + rg * RPT + r) * TROW + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  flush_tile<XT, BM, KS, FMA_THREADS>(tile, sink, ci, cb, b0, tid);
}

// --- tensor-core routine (bf16 x over bf16, int8 or int4 blocks) -------------------

constexpr int TC_CONSUMERS = 256;                  // two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;      // + the producer warp
constexpr int TC_STAGES = 4;                       // ring stages, at most

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
// one box of a 2-D tensor map at element coordinates (c0 inner, c1 outer)
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map,
                                      int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar) : "memory");
}
// contiguous bytes (a multiple of 16, 16-byte aligned) through the TMA
__device__ __forceinline__ void tma_bytes(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void consumers_sync() {   // the 8 consumer warps
  asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS) : "memory");
}
__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
// The 128-byte swizzle of the tensor maps: in each 1,024-byte group of
// eight 128-byte rows, 16-byte chunk c of row r sits at chunk c ^ (r & 7).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}
// The descriptor of a K-major bf16 tile under the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1,024 bytes apart (the leading offset is
// unused in this mode)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x N f32; N / 2 a thread) += a (64 x 16 bf16, registers: a warp's
// 16 rows as mma.sync's A fragment) . b (16 x N, K-major in shared memory,
// by descriptor); scale_d 0 drops d's old value
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  if constexpr (N == 8) wgmma_n8(d, a, desc, scale_d);
  else if constexpr (N == 16) wgmma_n16(d, a, desc, scale_d);
  else if constexpr (N == 32) wgmma_n32(d, a, desc, scale_d);
  else if constexpr (N == 64) wgmma_n64(d, a, desc, scale_d);
  else wgmma_n128(d, a, desc, scale_d);
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
__device__ __forceinline__ void pin(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <int WF, int BM>
struct Tc {
  static constexpr bool QUANT = WF != W_BF16;
  static constexpr int WBYTES = WTraits<WF>::BYTES;
  static constexpr int XBYTES = BM * BLK * 2;            // two 64-wide boxes
  static constexpr int SBYTES = QUANT ? BLK * 4 : 0;
  static constexpr int STAGE = (WBYTES + XBYTES + SBYTES + 1023) / 1024 * 1024;
  static constexpr int BARS = 16 * TC_STAGES;            // full[s], empty[s]
  // stages that fit when `ctas` blocks share an SM
  static constexpr int fit(int ctas) {
    return ((ctas == 1 ? SMEM_MAX : SMEM_SM / ctas - 1024) - 1024 - BARS) / STAGE;
  }
  // two blocks an SM where each keeps three stages, else one
  static constexpr int CTAS = fit(2) >= 3 ? 2 : 1;
  static constexpr int STAGES = fit(CTAS) < TC_STAGES ? fit(CTAS) : TC_STAGES;
  static constexpr int TILE = BM * TROW * 4;             // f32 flush tile
  static constexpr int RING = STAGES * STAGE > TILE ? STAGES * STAGE : TILE;
  static constexpr int SMEM = 1024 + RING + BARS;        // 1024: alignment slack
  static_assert(STAGES >= 3, "ring");
};

// The output column of a thread's accumulator row g (rh 0) or g + 8 (rh
// 1), in warp w4's 16 columns [m0, m0 + 16) of warpgroup wg (m0 = 64 wg +
// 16 w4). bf16 blocks: ldmatrix's order. int8 and int4: the 2 columns of
// one 16-bit load, [m0 + 2g, m0 + 2g + 2).
template <int WF>
__device__ __forceinline__ int col_of(int m0, int g, int rh) {
  if constexpr (WF == W_BF16) return m0 + g + 8 * rh;
  else return m0 + 2 * g + rh;
}

// one k pair of column j (0 or 1) of an int8 word holding bytes (row lo,
// c), (row lo, c + 1), (row hi, c), (row hi, c + 1), each biased to q + 128
// -> bf16x2, exact: 2^23 + (q + 128) as a float, minus 2^23 + 128, then the
// floats' upper halves (q needs at most 8 significant bits)
__device__ __forceinline__ uint32_t int8_pair(uint32_t u, int j) {
  const float f0 = __uint_as_float(prmt(u, 0x4b000000u, 0x7540u + j)) - 8388736.0f;
  const float f1 = __uint_as_float(prmt(u, 0x4b000000u, 0x7542u + j)) - 8388736.0f;
  return prmt(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// The A fragment of warp columns [m0, m0 + 16) at k rows [k0, k0 + 16):
// a0 and a1 hold k pair (2t, 2t + 1) of rows g and g + 8, a2 and a3 pair
// (2t + 8, 2t + 9). The payloads are expanded to bf16 here, in registers.
// Under the swizzle each load instruction's 32 lanes hit distinct banks
// (or share a word): lanes t read 4 rows whose (row & 7) differ.
template <int WF>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t w, int k0,
                                       int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (WF == W_BF16) {
    // W^T read transposed from the block's two 64-column halves
    const int k = k0 + (lane & 7) + ((lane >> 4) << 3);
    const int col = m0 + (((lane >> 3) & 1) << 3);
    ldsm_x4_t(a, w + (col >> 6) * (BLK * 64 * 2) + swz(k, (col & 63) >> 3));
  } else if constexpr (WF == W_INT8) {
    // rows k0 + 2t, + 1, + 8, + 9; bytes (c, c + 1) of each
    const int c = m0 + 2 * g;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = lds16(w + swz(k0 + 2 * t + (i & 1) + 8 * (i >> 1), c >> 4) + (c & 15));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t u = prmt(v[2 * i], v[2 * i + 1], 0x5410u) ^ 0x80808080u;
      a[2 * i] = int8_pair(u, 0);
      a[2 * i + 1] = int8_pair(u, 1);
    }
  } else {
    // payload rows k0/2 + t and + 4 hold block rows (2t, 2t + 1) and (2t +
    // 8, 2t + 9) in a byte's low and high nibbles: bytes (c, c + 1) of
    // each; bf16 (128 + n) is the nibble under the exponent 0x43, minus 136
    const int c = m0 + 2 * g;
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t v = lds16(w + swz(k0 / 2 + t + 4 * i, c >> 4) + (c & 15));
      const uint32_t lo = v & 0x0f0fu, hi = (v >> 4) & 0x0f0fu;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // bytes (lo_j, 0, hi_j, 0): selector 8 copies byte 0's sign, a zero
        uint32_t u = prmt(lo, hi, 0x8080u | ((4u + j) << 8) | j) | 0x43004300u;
        __nv_bfloat162 q = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&u), bias);
        a[2 * i + j] = *reinterpret_cast<uint32_t*>(&q);
      }
    }
  }
}

template <int WF, int BM>
__global__ void __launch_bounds__(TC_THREADS, Tc<WF, BM>::CTAS)
tc_kernel(const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_x,
          const float* __restrict__ scales, Plan plan,
          Sink<__nv_bfloat16> sink) {
  using T = Tc<WF, BM>;
  constexpr int NS = T::STAGES, ND = BM / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // the swizzle's period
  uint8_t* ring = smem_raw + (base - raw);
  const uint32_t bars = base + T::RING;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci = plan.order[blockIdx.x / plan.tiles], cb = plan.chunk_cb[ci];
  const int g0 = plan.chunk_off[ci], n = plan.chunk_off[ci + 1] - g0;
  const int b0 = (blockIdx.x % plan.tiles) * BM;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {   // producer: one lane issues every copy
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % NS, g = g0 + i, kb = plan.kb_of[g];
        if (i >= NS) mbar_wait(empty(s), (i / NS - 1) & 1);
        const uint32_t st = base + s * T::STAGE, bar = full(s);
        mbar_expect_tx(bar, T::WBYTES + T::XBYTES + T::SBYTES);
        if constexpr (WF == W_BF16) {           // two 64-column boxes
          tma2d(st, &tm_w, 0, g * BLK, bar);
          tma2d(st + BLK * 64 * 2, &tm_w, 64, g * BLK, bar);
        } else {
          tma2d(st, &tm_w, 0, g * (WF == W_INT4 ? BLK / 2 : BLK), bar);
        }
        tma2d(st + T::WBYTES, &tm_x, kb * BLK, b0, bar);
        tma2d(st + T::WBYTES + BM * 128, &tm_x, kb * BLK + 64, b0, bar);
        if constexpr (T::QUANT)
          tma_bytes(st + T::WBYTES + T::XBYTES, scales + (size_t)g * BLK,
                    T::SBYTES, bar);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output columns [64 wg, 64 wg + 64), warp
  // w4 of it [m0, m0 + 16) as its A rows; the next k step's A is expanded
  // while this one's wgmma runs (two register sets, each pinned until its
  // wgmma is done)
  const int m0 = 64 * (warp >> 2) + 16 * (warp & 3), g = lane >> 2, t = lane & 3;
  float acc[ND], part[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % NS;
    mbar_wait(full(s), (i / NS) & 1);
    const uint32_t wst = base + s * T::STAGE, xst = wst + T::WBYTES;
    // bf16 blocks accumulate straight into acc; a quantized block's
    // integer sum gathers in part (its first k step drops part's old
    // value) and meets its scale once
    float (&dst)[ND] = T::QUANT ? part : acc;
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < BLK / 16; ++ks) {
      load_a<WF>(a[ks & 1], wst, 16 * ks, m0, lane);
      pin(a[ks & 1]);
      pin(dst);
      wgmma_fence();
      wgmma<BM>(dst, a[ks & 1],
                desc_sw128(xst + (ks >> 2) * (BM * 128) + (ks & 3) * 32),
                T::QUANT ? ks > 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();              // step ks - 1 is done: its A is free
      if (ks > 0) pin(a[(ks - 1) & 1]);
    }
    wgmma_wait<0>();
    pin(a[1]);
    pin(dst);
    if constexpr (T::QUANT) {
      const float* sc = reinterpret_cast<const float*>(
          ring + s * T::STAGE + T::WBYTES + T::XBYTES);
      const float s0 = sc[col_of<WF>(m0, g, 0)], s1 = sc[col_of<WF>(m0, g, 1)];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] = fmaf((j & 2) ? s1 : s0, part[j], acc[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with stage s
  }

  // flush: every consumer is past the ring (the producer issued nothing
  // that was not consumed), so the f32 tile overlays it. Accumulator j of
  // a thread: batch row 8 (j / 4) + 2t + (j & 1), row half (j / 2) & 1.
  consumers_sync();
  float* tile = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < ND; ++j)
    tile[(size_t)(8 * (j >> 2) + 2 * t + (j & 1)) * TROW +
         col_of<WF>(m0, g, (j >> 1) & 1)] = acc[j];
  consumers_sync();
  flush_tile<__nv_bfloat16, BM, 1, TC_CONSUMERS>(tile, sink, ci, cb, b0, tid);
}

// --- host side -------------------------------------------------------------------

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

// a 2-D row-major map over (rows, cols) elements with (box_cols, box_rows)
// boxes and the 128-byte swizzle; out-of-bounds rows read as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int esize, uint64_t rows, uint64_t cols, uint32_t box_cols,
                uint32_t box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int WF, int BM>
cudaError_t launch_tc(const void* x, const void* w, const float* scales,
                      const Plan& plan, const Sink<__nv_bfloat16>& sink,
                      int G, int R, int n_chunks, cudaStream_t stream) {
  using T = Tc<WF, BM>;
  auto kernel = tc_kernel<WF, BM>;
  static bool configured = false;
  cudaError_t e = allow_smem(kernel, T::SMEM, configured);
  if (e != cudaSuccess) return e;
  CUtensorMap tw, tx;
  bool ok;
  if constexpr (WF == W_BF16)
    ok = tensor_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    (uint64_t)G * BLK, BLK, 64, BLK);
  else
    ok = tensor_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                    (uint64_t)G * (WF == W_INT4 ? BLK / 2 : BLK), BLK, BLK,
                    WF == W_INT4 ? BLK / 2 : BLK);
  ok = ok && tensor_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, sink.B,
                        R, 64, BM);
  if (!ok) return cudaErrorNotSupported;
  Plan p = plan;
  p.tiles = (sink.B + BM - 1) / BM;
  kernel<<<n_chunks * p.tiles, TC_THREADS, T::SMEM, stream>>>(tw, tx, scales, p, sink);
  return cudaGetLastError();
}

template <int WF>
cudaError_t pick_tc(int bm, const void* x, const void* w, const float* sc,
                    const Plan& plan, const Sink<__nv_bfloat16>& sink, int G,
                    int R, int n_chunks, cudaStream_t st) {
  switch (bm) {
    case 8: return launch_tc<WF, 8>(x, w, sc, plan, sink, G, R, n_chunks, st);
    case 16: return launch_tc<WF, 16>(x, w, sc, plan, sink, G, R, n_chunks, st);
    case 32: return launch_tc<WF, 32>(x, w, sc, plan, sink, G, R, n_chunks, st);
    case 64: return launch_tc<WF, 64>(x, w, sc, plan, sink, G, R, n_chunks, st);
    case 128: return launch_tc<WF, 128>(x, w, sc, plan, sink, G, R, n_chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT, int WF, int BM>
cudaError_t launch_fma(const void* x, const void* w, const float* scales,
                       const Plan& plan, const Sink<XT>& sink, int R,
                       int n_chunks, cudaStream_t stream) {
  constexpr int bytes = FmaSmem<XT, WF, BM>::TOTAL;
  static_assert(bytes <= SMEM_MAX, "shared memory over the per-block limit");
  auto kernel = fma_kernel<XT, WF, BM>;
  static bool configured = false;
  const cudaError_t e = allow_smem(kernel, bytes, configured);
  if (e != cudaSuccess) return e;
  Plan p = plan;
  p.tiles = (sink.B + BM - 1) / BM;
  kernel<<<n_chunks * p.tiles, FMA_THREADS, bytes, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(w), scales, p,
      sink, R);
  return cudaGetLastError();
}

template <typename XT, int WF>
cudaError_t pick_fma_bm(int bm, const void* x, const void* w, const float* sc,
                        const Plan& plan, const Sink<XT>& sink, int R,
                        int n_chunks, cudaStream_t st) {
  if (bm == 8) return launch_fma<XT, WF, 8>(x, w, sc, plan, sink, R, n_chunks, st);
  if (bm == 64) return launch_fma<XT, WF, 64>(x, w, sc, plan, sink, R, n_chunks, st);
  return cudaErrorInvalidValue;
}

template <typename XT>
cudaError_t pick_fma(int wfmt, int bm, const void* x, const void* w,
                     const float* sc, const Plan& plan, const Sink<XT>& sink,
                     int R, int n_chunks, cudaStream_t st) {
  switch (wfmt) {
    case W_F32: return pick_fma_bm<XT, W_F32>(bm, x, w, sc, plan, sink, R, n_chunks, st);
    case W_BF16: return pick_fma_bm<XT, W_BF16>(bm, x, w, sc, plan, sink, R, n_chunks, st);
    case W_INT8: return pick_fma_bm<XT, W_INT8>(bm, x, w, sc, plan, sink, R, n_chunks, st);
    case W_INT4: return pick_fma_bm<XT, W_INT4>(bm, x, w, sc, plan, sink, R, n_chunks, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t combine(const int32_t* cb_chunk, const Sink<XT>& sink,
                    cudaStream_t st) {
  const int groups = (sink.B * (BLK / 8) + 255) / 256;
  const dim3 grid(sink.C / BLK, groups < 64 ? groups : 64);
  combine_kernel<XT><<<grid, 256, 0, st>>>(cb_chunk, sink);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t run(int wfmt, int bm, const void* x, const void* w,
                const float* sc, const Plan& plan, const int32_t* cb_chunk,
                const Sink<XT>& sink, int G, int R, int n_chunks,
                cudaStream_t st) {
  cudaError_t e;
  if constexpr (sizeof(XT) == 2) {
    switch (wfmt) {   // bf16 x: tensor cores unless the blocks are f32
      case W_F32: e = pick_fma_bm<XT, W_F32>(bm, x, w, sc, plan, sink, R, n_chunks, st); break;
      case W_BF16: e = pick_tc<W_BF16>(bm, x, w, sc, plan, sink, G, R, n_chunks, st); break;
      case W_INT8: e = pick_tc<W_INT8>(bm, x, w, sc, plan, sink, G, R, n_chunks, st); break;
      case W_INT4: e = pick_tc<W_INT4>(bm, x, w, sc, plan, sink, G, R, n_chunks, st); break;
      default: e = cudaErrorInvalidValue;
    }
  } else {
    e = pick_fma<XT>(wfmt, bm, x, w, sc, plan, sink, R, n_chunks, st);
  }
  if (e != cudaSuccess || !sink.ws) return e;
  return combine<XT>(cb_chunk, sink, st);
}

}  // namespace

// xfmt: 0 f32, 1 bf16. wfmt: 0 f32, 1 bf16, 2 int8, 3 int4. bm: the batch
// tile, 8, 16, 32, 64 or 128 on the tensor cores (bf16 x over bf16, int8
// or int4 blocks), else 8 or 64. meta: (4, G) int32, row 0 read as each block's
// kb. ws: (n_chunks, B, 128) f32 when the plan splits runs, else null.
// Returns cudaError_t.
extern "C" int packed_canvas_launch(
    const void* x, const void* w, const void* scales, const void* meta,
    const void* chunk_off, const void* chunk_cb, const void* order,
    const void* cb_chunk, const void* bias, const void* residual, void* out,
    void* ws, int B, int R, int C, int G, int n_chunks, int xfmt, int wfmt,
    int bm, int act, void* stream) {
  const Plan plan{static_cast<const int32_t*>(meta),
                  static_cast<const int32_t*>(chunk_off),
                  static_cast<const int32_t*>(chunk_cb),
                  static_cast<const int32_t*>(order), 0};
  const int32_t* cbc = static_cast<const int32_t*>(cb_chunk);
  const float* sc = static_cast<const float*>(scales);
  float* wsp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < ACT_NONE || act > ACT_GELU) return cudaErrorInvalidValue;
  if (xfmt == 0) {
    const Sink<float> sink{static_cast<float*>(out), wsp,
                           static_cast<const float*>(bias),
                           static_cast<const float*>(residual), B, C, act};
    return run<float>(wfmt, bm, x, w, sc, plan, cbc, sink, G, R, n_chunks, st);
  }
  if (xfmt == 1) {
    const Sink<__nv_bfloat16> sink{static_cast<__nv_bfloat16*>(out), wsp,
                                   static_cast<const __nv_bfloat16*>(bias),
                                   static_cast<const __nv_bfloat16*>(residual),
                                   B, C, act};
    return run<__nv_bfloat16>(wfmt, bm, x, w, sc, plan, cbc, sink, G, R,
                              n_chunks, st);
  }
  return cudaErrorInvalidValue;
}
