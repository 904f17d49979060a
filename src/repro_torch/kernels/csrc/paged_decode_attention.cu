// Decode attention for Hopper (sm_90a): one query token per sequence,
// grouped-query heads, online softmax over the sequence's cache. Two entries
// on one routine, attend_split, which takes a row-address functor that says
// where token t's K and V rows live (PagedRows / DenseRows):
//
//   paged_decode_attention_bf16: a shared page pool addressed by a page table.
//     Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
//     paged_decode_attention (_paged_kernel).
//   decode_attention_bf16: a dense cache (B, KV, T, dh) given by its strides,
//     so the static path's (B, T, KV, dh) cache layer reaches it as a
//     transposed view, with no copy. Replaces decode_attention (_kernel) of
//     the same file.
//
// The TPU grids (B, KV, M) and (B, KV, T/bt) walked the cache in order and
// carried the softmax state in VMEM scratch; CUDA blocks run in no order.
//
// Bound: device-memory bytes. Each live token's K and V row is read once
// (2 * dh * 2 bytes per kv head) for about 4 * G * dh FLOPs, far below the
// card's 295 FLOP/byte balance point. Only tokens below the live length are
// read (dead table slots, the trash page and cache rows past lengths[b] never
// are; the dense entry masks by the true T, where the TPU version padded T to
// its tile), with 16-byte loads, and the scores, weights and accumulators
// never leave the SM.
//
// Split-T (attend_split): B * KV blocks alone leave most of the 132 SMs idle
// and walk T serially, so the grid is (KV * ceil(G / 16), B, splits): each
// block takes one chunk of the sequence's tokens. Its 4 warps split each
// 64-token tile 16 keys apiece; the G query heads of the kv head (up to 16 a
// block) are the rows of one mma.sync m16n8k16 for Q K^T and for P V, so any
// G runs on the same code. K and V stream through a two-stage cp.async ring
// with one barrier a tile. Each warp keeps its own online softmax; at the end
// the block merges its warps by log-sum-exp and writes either the bf16 result
// (one split) or an f32 partial (m, l, acc) to a workspace, which a combine
// kernel merges the same way. A chunk past lengths[b] contributes l = 0; a
// row whose chunks are all empty (length 0) yields zeros. The paged entry
// reads the page table once a page: each tile's page ids are staged in shared
// memory one ring stage ahead of its K/V loads (PagedRows).
//
// Layouts: q and out (B, KV, G, DH) bf16, contiguous; lengths (B,) int32.
// Paged: k/v pages (KV, P, page, DH) bf16; page_table (B, M) int32. Dense:
// k/v (B, KV, T, DH) bf16 with any strides over the first three axes (in
// elements, multiples of 8) and a contiguous last axis. f32 softmax and
// accumulation; a length-0 row yields zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SPLIT_TILE = 64;   // tokens per ring stage: 4 warps x 16 keys
constexpr int SPLIT_NT = 128;
constexpr int QROWS = 16;        // query heads a block: the rows of one MMA
constexpr int IDS = SPLIT_TILE + 1;   // most pages a 64-token tile can span

// two (K, V) stages, the query rows, the warps' stats; then the paged
// entry's two slots of staged page ids
template <int DH>
__host__ __device__ constexpr size_t ids_offset() {
  return (size_t)(4 * SPLIT_TILE + QROWS) * (DH + 8) * 2 + 4 * 2 * QROWS * 4;
}
template <int DH, bool PAGED>
__host__ __device__ constexpr size_t split_smem() {
  return ids_offset<DH>() + (PAGED ? 2 * IDS * 4 : 0);
}

// 16-byte global -> shared copy; pred false fills zeros and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n));
}
// 4-byte global -> shared copy (cp.async's .ca form; .cg takes 16 bytes only)
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src));
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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}


// Token t's row of one (sequence, kv head) in a page pool: page
// table[t / page], row t % page; K and V share the offset. ``stage`` copies
// the ids of the pages that tokens [ta, min(ta + 64, t1)) lie in to shared
// slot ``slot`` (one 4-byte cp.async a page, in the caller's copy group);
// k(t, ta, slot) reads them back for a token of that tile.
struct PagedRows {
  static constexpr bool STAGED = true;
  const int32_t* table;   // this sequence's page-table row
  size_t pool;            // element offset of this kv head's pool
  int page, dh;
  int* ids;               // shared: [2][IDS]
  __device__ __forceinline__ void stage(int ta, int t1, int slot, int tid) const {
    const int p0 = ta / page, n = (min(ta + SPLIT_TILE, t1) - 1) / page - p0 + 1;
    for (int i = tid; i < n; i += SPLIT_NT) cp4(ids + slot * IDS + i, table + p0 + i);
  }
  __device__ __forceinline__ size_t k(int t, int ta, int slot) const {
    return pool + ((size_t)ids[slot * IDS + t / page - ta / page] * page
                   + t % page) * dh;
  }
  __device__ __forceinline__ size_t v(int t, int ta, int slot) const {
    return k(t, ta, slot);
  }
};

// Token t's row of one (sequence, kv head) in a strided dense cache.
struct DenseRows {
  static constexpr bool STAGED = false;
  size_t k0, v0;          // element offsets of row 0
  long long kt, vt;       // element strides along T
  __device__ __forceinline__ void stage(int, int, int, int) const {}
  __device__ __forceinline__ size_t k(int t, int, int) const { return k0 + (size_t)t * kt; }
  __device__ __forceinline__ size_t v(int t, int, int) const { return v0 + (size_t)t * vt; }
};

// One block: query rows q[0 .. gn) (gn <= 16, DH apart) of one (sequence, kv
// head) against tokens [t0, t1) of it. With ``out`` the block owns the whole
// sequence and writes bf16 rows; otherwise it writes its f32 partial: row r's
// acc at part_acc[r * pstride * DH], its (max in log2 units, sum) at
// part_ml[r * pstride * 2].
template <int DH, class Rows>
__device__ __forceinline__ void attend_split(
    const __nv_bfloat16* __restrict__ q, const int gn,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const Rows rows, const int t0, const int t1,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, const int pstride, const float scale) {
  constexpr int SROW = DH + 8;     // padded row: 8 ldmatrix rows, 8 bank groups
  constexpr int CH = DH / 8;       // 16-byte chunks per row
  constexpr int KD = DH / 16;      // k-steps of Q K^T
  constexpr int NO = DH / 8;       // output n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][K|V][TILE][SROW]
  __nv_bfloat16* qs = ring + 4 * SPLIT_TILE * SROW;               // [16][SROW]
  float* ml_s = reinterpret_cast<float*>(qs + QROWS * SROW);      // [warp][m|l][16]
  float* slab = reinterpret_cast<float*>(smem);   // after the walk: [warp][16][SROW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int ntiles = t1 > t0 ? (t1 - t0 + SPLIT_TILE - 1) / SPLIT_TILE : 0;

  auto load_kv = [&](int ta, int st) {
    __nv_bfloat16* ks = ring + st * 2 * SPLIT_TILE * SROW;
    __nv_bfloat16* vs = ks + SPLIT_TILE * SROW;
    for (int i = tid; i < SPLIT_TILE * CH; i += SPLIT_NT) {
      const int r = i / CH, c = i % CH, t = ta + r;
      const bool live = t < t1;
      cp16(ks + r * SROW + c * 8, k + (live ? rows.k(t, ta, st) + c * 8 : 0), live);
      cp16(vs + r * SROW + c * 8, v + (live ? rows.v(t, ta, st) + c * 8 : 0), live);
    }
  };
  // tile j's row addresses (paged: its page ids, slot j & 1) are staged one
  // copy group before its K/V loads; the first tile's before anything else
  if constexpr (Rows::STAGED) {
    if (ntiles > 0) rows.stage(t0, t1, 0, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
  // the query rows (past gn: zeros), the first tile and the second tile's
  // row addresses: one copy group
  for (int i = tid; i < QROWS * CH; i += SPLIT_NT) {
    const int r = i / CH, c = i % CH;
    cp16(qs + r * SROW + c * 8, q + (r < gn ? r * DH + c * 8 : 0), r < gn);
  }
  if (ntiles > 0) load_kv(t0, 0);
  if (ntiles > 1) rows.stage(t0 + SPLIT_TILE, t1, 1, tid);
  cp_commit();

  const float sl2 = scale * 1.4426950408889634f;   // scores -> log2 units
  float o_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};   // rows g, g + 8
  uint32_t qf[KD][4];

  for (int it = 0; it < ntiles; ++it) {
    const int ta = t0 + it * SPLIT_TILE, st = it & 1;
    cp_wait<0>();
    __syncthreads();   // tile it is visible to all; every warp is done with it - 1
    if (it + 1 < ntiles) load_kv(ta + SPLIT_TILE, st ^ 1);
    // slot st held tile it's addresses, whose loads every thread issued
    // before the barrier above
    if (it + 2 < ntiles) rows.stage(ta + 2 * SPLIT_TILE, t1, st, tid);
    cp_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], qs + (lane & 15) * SROW + kk * 16 + (lane >> 4) * 8);
    }
    // this warp's 16 keys of the tile
    const __nv_bfloat16* ks = ring + st * 2 * SPLIT_TILE * SROW + warp * 16 * SROW;
    const __nv_bfloat16* vs = ks + SPLIT_TILE * SROW;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, ks + ((lane & 7) + (lane >> 4) * 8) * SROW + kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[0], qf[kk], bk[0], bk[1]);
      mma16816(s[1], qf[kk], bk[2], bk[3]);
    }
    const int kw = ta + warp * 16;
    if (kw + 16 > t1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kw + j * 8 + 2 * tg + (e & 1) >= t1) s[j][e] = -INFINITY;
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float base[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;   // no live key yet
      alpha[r] = exp2f(m_r[r] * sl2 - base[r]);           // 0 on the first
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], sl2, -base[e >> 1]));
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o_acc[n][0] *= alpha[0]; o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1]; o_acc[n][3] *= alpha[1];
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int jj = 0; jj < NO / 2; ++jj) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * SROW + jj * 16 + (lane >> 4) * 8);
      mma16816(o_acc[2 * jj], pa, bv[0], bv[1]);
      mma16816(o_acc[2 * jj + 1], pa, bv[2], bv[3]);
    }
  }

  // merge the 4 warps: per-row max over warps, each warp's accumulator
  // rescaled to it in an f32 slab over the (now idle) ring, then summed
  cp_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  __syncthreads();   // every warp is done with the ring
  if (tg == 0) {
    ml_s[warp * 32 + g] = m_r[0];
    ml_s[warp * 32 + g + 8] = m_r[1];
    ml_s[warp * 32 + 16 + g] = l_r[0];
    ml_s[warp * 32 + 16 + g + 8] = l_r[1];
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, ml_s[w * 32 + g + 8 * r]);
    f[r] = m_r[r] == -INFINITY ? 0.f : exp2f((m_r[r] - mm) * sl2);
  }
  float* sw = slab + warp * QROWS * SROW;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(sw + g * SROW + n * 8 + 2 * tg) =
        make_float2(o_acc[n][0] * f[0], o_acc[n][1] * f[0]);
    *reinterpret_cast<float2*>(sw + (g + 8) * SROW + n * 8 + 2 * tg) =
        make_float2(o_acc[n][2] * f[1], o_acc[n][3] * f[1]);
  }
  __syncthreads();
  for (int i = tid; i < gn * DH; i += SPLIT_NT) {
    const int r = i / DH, d = i % DH;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, ml_s[w * 32 + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = ml_s[w * 32 + r];
      if (mw != -INFINITY) l += exp2f((mw - mm) * sl2) * ml_s[w * 32 + 16 + r];
      a += slab[(w * QROWS + r) * SROW + d];
    }
    if (out != nullptr) {
      out[r * DH + d] = __float2bfloat16(l > 0.f ? a / l : 0.f);
    } else {
      part_acc[(size_t)r * pstride * DH + d] = a;
      if (d == 0) {
        part_ml[(size_t)r * pstride * 2] = mm * sl2;
        part_ml[(size_t)r * pstride * 2 + 1] = l;
      }
    }
  }
}

// Block (kv head h, query rows g0 .. g0 + 16 of G, sequence b, split) of a
// split-T grid: tokens [split * chunk, min(len, (split + 1) * chunk)).
template <int DH, class Rows>
__device__ __forceinline__ void split_block(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows& rows, const int len,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, const int KV, const int G, const int h,
    const int g0, const int chunk, const float scale) {
  const int b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const size_t row0 = ((size_t)b * KV + h) * G + g0;   // first query row
  const int t0 = split * chunk, t1 = min(len, t0 + chunk);
  if (splits == 1)
    attend_split<DH>(q + row0 * DH, min(QROWS, G - g0), k, v, rows, t0, t1,
                     out + row0 * DH, nullptr, nullptr, 1, scale);
  else
    attend_split<DH>(q + row0 * DH, min(QROWS, G - g0), k, v, rows, t0, t1,
                     nullptr, part_acc + (row0 * splits + split) * DH,
                     part_ml + (row0 * splits + split) * 2, splits, scale);
}

template <int DH>
__global__ void __launch_bounds__(SPLIT_NT)
dense_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int32_t* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int KV, int G, int T, int chunk,
                   long long kb, long long kh, long long kt, long long vb,
                   long long vh, long long vt, float scale) {
  const int ngroups = (G + QROWS - 1) / QROWS;
  const int h = blockIdx.x / ngroups, g0 = (blockIdx.x % ngroups) * QROWS;
  const int b = blockIdx.y;
  const DenseRows rows{(size_t)b * kb + (size_t)h * kh,
                       (size_t)b * vb + (size_t)h * vh, kt, vt};
  const int len = max(0, min(lengths[b], T));    // never past the true T
  split_block<DH>(q, k, v, rows, len, out, part_acc, part_ml, KV, G, h, g0,
                  chunk, scale);
}

// The paged twin: sequence b's token t in page table[b, t / page] of kv
// head h's pool, lengths read on the device and clamped to M * page.
template <int DH>
__global__ void __launch_bounds__(SPLIT_NT)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pages,
                   const __nv_bfloat16* __restrict__ v_pages,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int KV, int G, int P, int page,
                   int M, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ngroups = (G + QROWS - 1) / QROWS;
  const int h = blockIdx.x / ngroups, g0 = (blockIdx.x % ngroups) * QROWS;
  const int b = blockIdx.y;
  const PagedRows rows{page_table + (size_t)b * M, (size_t)h * P * page * DH,
                       page, DH, reinterpret_cast<int*>(smem + ids_offset<DH>())};
  const int len = max(0, min(lengths[b], M * page));
  split_block<DH>(q, k_pages, v_pages, rows, len, out, part_acc, part_ml, KV,
                  G, h, g0, chunk, scale);
}

// Merges one query row's split partials by log-sum-exp: one block of DH
// threads per row, thread d owns column d. Splits with l = 0 (past the
// row's length) are skipped; a row with none left yields zeros.
template <int DH>
__global__ void __launch_bounds__(DH)
split_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ out, int splits) {
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  const float* acc = part_acc + row * splits * DH + threadIdx.x;
  float mm = -INFINITY;
  for (int s = 0; s < splits; ++s)
    if (ml[2 * s + 1] > 0.f) mm = fmaxf(mm, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {
      const float w = exp2f(ml[2 * s] - mm);
      l += w * ls;
      a += w * acc[(size_t)s * DH];
    }
  }
  out[row * DH + threadIdx.x] = __float2bfloat16(l > 0.f ? a / l : 0.f);
}

// Sets the kernel's dynamic shared memory limit on first use (a stream
// capture must not be the first use), launches the (KV * ceil(G / 16), B,
// splits) grid and, with splits > 1, the combine.
template <int DH, bool PAGED, class Kernel, class... Args>
cudaError_t launch_split(Kernel kernel, int B, int KV, int G, int splits,
                         cudaStream_t st, float* part_acc, float* part_ml,
                         __nv_bfloat16* out, Args... args) {
  constexpr size_t smem = split_smem<DH, PAGED>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(KV * ((G + QROWS - 1) / QROWS), B, splits);
  kernel<<<grid, SPLIT_NT, smem, st>>>(args...);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  split_combine_kernel<DH><<<B * KV * G, DH, 0, st>>>(part_acc, part_ml, out, splits);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_paged(int B, int KV, int G, int P, int page, int M,
                         int splits, int chunk, cudaStream_t st,
                         const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const int32_t* pt,
                         const int32_t* len, __nv_bfloat16* out,
                         float* part_acc, float* part_ml, float scale) {
  return launch_split<DH, true>(paged_split_kernel<DH>, B, KV, G, splits, st,
                                part_acc, part_ml, out, q, k, v, pt, len, out,
                                part_acc, part_ml, KV, G, P, page, M, chunk,
                                scale);
}

template <int DH>
cudaError_t launch_dense(int B, int KV, int G, int T, int splits, int chunk,
                         cudaStream_t st, const __nv_bfloat16* q,
                         const __nv_bfloat16* k, const __nv_bfloat16* v,
                         const int32_t* len, __nv_bfloat16* out, float* part_acc,
                         float* part_ml, const long long* s, float scale) {
  return launch_split<DH, false>(dense_split_kernel<DH>, B, KV, G, splits, st,
                                 part_acc, part_ml, out, q, k, v, len, out,
                                 part_acc, part_ml, KV, G, T, chunk, s[0],
                                 s[1], s[2], s[3], s[4], s[5], scale);
}

}  // namespace

// Paged pool: token t of sequence b lies in page page_table[b, t / page],
// row t % page, of each kv head's pool; lengths[b] is clamped to M * page.
// Any G >= 1, DH in {64, 128}. Splits, chunk and the two f32 workspaces as
// decode_attention_bf16's below, with M * page for T. Returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int KV, int G, int DH, int P, int page, int M,
    int splits, int chunk, float scale, void* stream) {
  if (G < 1 || page < 1 || splits < 1 || chunk % SPLIT_TILE
      || (long long)splits * chunk < (long long)M * page)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* pt = static_cast<const int32_t*>(page_table);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  if (DH == 128) return launch_paged<128>(B, KV, G, P, page, M, splits, chunk, st, qp, kp, vp, pt, ln, op, pa, pm, scale);
  if (DH == 64) return launch_paged<64>(B, KV, G, P, page, M, splits, chunk, st, qp, kp, vp, pt, ln, op, pa, pm, scale);
  return cudaErrorInvalidValue;
}

// Dense cache: strides (6,) = k's (B, KV, T) strides then v's, in elements.
// Any G >= 1, DH in {64, 128}. Tokens [s * chunk, (s + 1) * chunk) go to
// split s of ``splits`` (chunk a multiple of 64, splits * chunk >= T). With
// splits > 1, part_acc (B * KV * G * splits * DH) and part_ml (B * KV * G *
// splits * 2) are f32 workspaces and a combine kernel follows on the same
// stream; with one split they are not read. Returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_acc, void* part_ml, int B, int KV, int G, int DH,
    int T, int splits, int chunk, const long long* strides, float scale,
    void* stream) {
  if (G < 1 || splits < 1 || chunk % SPLIT_TILE || (long long)splits * chunk < T)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  if (DH == 128) return launch_dense<128>(B, KV, G, T, splits, chunk, st, qp, kp, vp, ln, op, pa, pm, strides, scale);
  if (DH == 64) return launch_dense<64>(B, KV, G, T, splits, chunk, st, qp, kp, vp, ln, op, pa, pm, strides, scale);
  return cudaErrorInvalidValue;
}
