// Dense-cell SGD epoch for Hopper (sm_90a).
//
// Replaces tpu_mf/ops/pallas_sgd_dense.py:_dense_kernel. The rating matrix is
// cut into (user tile i) x (item tile c) cells; each cell holds the dense sum
// S and count W of its ratings. Per cell, against the cell-START tiles theta_i
// (tu x lanes) and phi_c (tv x lanes), in fused homogeneous rows:
//
//     pred   = theta_i . phi_c^T + gb          (biases ride the one-lanes)
//     E      = S - W * pred                    (W doubles as mask and multiplicity)
//     dtheta = E   . phi_c                     k_u = row sums of W
//     dphi   = E^T . theta_i                   k_v = column sums of W
//     row   <- row * (1 + keep * (exp(k ln(1 - eta lam)) - 1))
//              + keep * eta * min(1, cap / max(k, 1)) * drow
//
// Order. The TPU walks the cells row-major on one core: cell (i, c) reads
// theta_i as (i, c-1) left it and phi_c as (i-1, c) left it. Any order that
// keeps those two edges gives exactly the row-major result. Two walks do:
//
// The wavefront walk (dense_walk_kernel; bf16, rows of up to 96 used lanes
// whose tiles fit on chip: the main path). One persistent launch per
// epoch. A unit is a user-tile row i, taken by an atomic ticket (so a unit
// only waits for units already running) and walked c = 0 .. n_gvp-1 by
// one thread-block cluster of ceil(tu / 64) blocks, block q owning user
// rows [64q, 64q + 64):
//   - unit i waits on a ready counter per item tile, numbered by epoch
//     (nothing is cleared between epochs), until every block of unit i - 1
//     has left tile c (ld.acquire.gpu / red.release.gpu);
//   - S and W arrive by TMA (2-D boxes, 128-byte swizzle) one cell ahead;
//     phi comes as a bf16 shadow that the unit above wrote beside the f32
//     rows, sent once to the whole cluster by TMA multicast;
//   - pred, E, dphi and dtheta stay in shared memory and registers; E
//     overwrites S in place; theta's bf16 tile stays on chip for the unit;
//   - the three products run on wgmma (m64nNk16, bf16 operands read from
//     shared memory by descriptor, f32 sums): pred on all four warpgroups,
//     then dphi on two and dtheta on the other two at once;
//   - dphi is a partial per block, reduced over the cluster through
//     distributed shared memory (ld.shared::cluster, each block its slice
//     of item rows, in rank order; no float atomics).
// Wider rows and the f32 working type take the diagonal walk
// (ops/sgd_dense.py: dense_route).
//
// The diagonal walk (dense_err_kernel, dense_apply_kernel; f32 parity
// working type, rows wider than the wavefront walk takes, cell shapes it
// does not take). Cells on one anti-diagonal touch disjoint tiles; two
// launches per diagonal:
//
//   dense_err_kernel   E for every cell of the diagonal (64x64 output tiles),
//                      plus copies of the cell-start theta_i / phi_c in the
//                      working type, so that the second kernel can update the
//                      live tables while other blocks still read the
//                      cell-start values (the TPU's `tb`/`pb`).
//   dense_apply_kernel dtheta (strips of 64 user rows) and dphi (strips of 64
//                      item rows, reading E transposed, so no S^T/W^T copy of
//                      the cell matrices is kept), then decay and apply.
//
// Rounding follows the TPU kernel: theta, phi and E are rounded to the working
// type (bf16 in production, f32 for parity runs) before each product; products
// and sums are f32. Counts k_u/k_v are exact integer sums of W, computed once
// per run beside S/W. In the diagonal walk the bf16 products run on mma.sync
// m16n8k16 (f32 accumulate) and the f32 ones as CUDA-core FMAs, which keeps
// the f32 parity mode exact.
//
// What bounds it on the H100. Per cell the three products cost
// 2 * tu * tv * 3 * (dim + 2) flops against 3 bytes of S/W per rating slot
// (bf16 + int8), 2 * (dim + 2) = 132 flop per byte at dim 64, below the
// tensor cores' ~295 flop/byte balance, so the floor is the S/W stream
// (~0.7 ms per ML-10M epoch at 3.35 TB/s). The diagonal walk is held above
// it by 628 launches an epoch at ML-10M and E's round trip through memory
// between the two launches of each diagonal. The wavefront walk has neither
// and keeps S/W's stream off its critical path. At ML-10M, 30 clusters of
// 4 fit the card, fewer than the 42 cells a diagonal could hold, so each
// cluster walks ~382 cells one after another and the epoch is one cell's
// block time times ~412: ~30k clocks at dim 64 (PERF.md). That time is
// set by data movement on chip, not by the products (~1k clocks for pred,
// ~4k for dphi with its stores): the cluster reduction's ~70 KB of
// distributed shared memory reads a block and cell (~12k clocks, ~6 bytes
// a clock), E's elementwise pass (~4k) and, beside the reduction, theta's
// f32 rows through L2 (dtheta and its apply, ~13k).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;      // output tile edge
constexpr int kDepth = 16;     // K slice staged in shared memory per step
constexpr int kThreads = 256;  // 8 warps; 16 outputs per thread

// ---- f32 path: CUDA-core FMA, 16 x 16 threads, 4 x 4 outputs each --------
struct StageF32 {
  float a[kDepth][kTile + 4];
  float b[kDepth][kTile + 4];
};

// ---- bf16 path: tensor cores (mma.sync m16n8k16, f32 accumulate) ---------
// 8 warps as 4 (rows) x 2 (cols); a warp owns 16 rows x 32 cols of the tile.
// Each operand is staged in its global orientation, 8 contiguous elements
// (16 bytes of bf16) per thread and stage, double-buffered: the next stage's
// global loads are in flight while the current stage's products run.
// ldmatrix (.trans for k-major operands) builds the mma fragments.
// The output tile is 64 rows x kN columns (kN = 64 or 128); a warp owns
// 16 rows x kN/2 columns.
constexpr int kDepthTC = 32;                    // K slice per stage
constexpr int kRowMajorStride = kDepthTC + 8;   // [row][k]: 80-byte rows
__host__ __device__ constexpr int kKMajorStride(int width) {  // [k][row]
  return width + 8;
}
template <int kN>
struct StageTC {  // [rows][k] is the larger of the two layouts
  __nv_bfloat16 a[2][kTile * kRowMajorStride];
  __nv_bfloat16 b[2][kN * kRowMajorStride];
};

// After the products, the epilogues park the 64 x kN f32 accumulator tile in
// shared memory (row stride kN + 4) and walk it by whole rows.
template <bool kTC, int kN>
__host__ __device__ constexpr size_t smem_bytes() {
  const size_t stage = kTC ? sizeof(StageTC<kN>) : sizeof(StageF32);
  const size_t tile = kTile * (kN + 4) * sizeof(float);
  return stage > tile ? stage : tile;
}

// One operand of a 64-wide tile product, as stored in device memory: rows of
// `inner` contiguous elements, `stride` apart. K-major operands have k as the
// row index (e.g. E^T, the table copies); row-major ones have the tile row.
// `n_outer` / `n_inner` bound the valid extent (n_inner a multiple of 8).
template <typename T>
struct Operand {
  const T* p;
  long long stride;
  int n_outer, n_inner;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint4 load8(const Operand<__nv_bfloat16>& o,
                                       int outer, int inner) {
  if (outer >= o.n_outer || inner >= o.n_inner) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(o.p + outer * o.stride + inner);
}

// f32 sources are rounded to bf16 here: the cast before the product.
__device__ __forceinline__ uint4 load8(const Operand<float>& o, int outer,
                                       int inner) {
  if (outer >= o.n_outer || inner >= o.n_inner) return make_uint4(0, 0, 0, 0);
  const float4* q = reinterpret_cast<const float4*>(o.p + outer * o.stride + inner);
  const float4 x = q[0], y = q[1];
  return make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                    pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Slot `v` of this thread in a stage of `width` x 32 k (k-major: 32 k-rows
// of `width` elements; else `width` rows of 32 k): (outer, inner) of its
// 16-byte vector.
template <bool kKMajor, int width>
__device__ __forceinline__ void stage_slot(int v, int& outer, int& inner) {
  const int id = threadIdx.x + v * kThreads;
  if constexpr (kKMajor) {
    outer = id / (width / 8);
    inner = id % (width / 8) * 8;
  } else {
    outer = id / (kDepthTC / 8);
    inner = id % (kDepthTC / 8) * 8;
  }
}

template <bool kKMajor, int width, typename T>
__device__ __forceinline__ void fetch_stage(uint4 (&r)[width / kTile],
                                            const Operand<T>& o, int k0) {
#pragma unroll
  for (int v = 0; v < width / kTile; ++v) {
    int outer, inner;
    stage_slot<kKMajor, width>(v, outer, inner);
    r[v] = kKMajor ? load8(o, k0 + outer, inner) : load8(o, outer, k0 + inner);
  }
}

template <bool kKMajor, int width>
__device__ __forceinline__ void put_stage(__nv_bfloat16* buf,
                                          const uint4 (&r)[width / kTile]) {
  constexpr int stride = kKMajor ? kKMajorStride(width) : kRowMajorStride;
#pragma unroll
  for (int v = 0; v < width / kTile; ++v) {
    int outer, inner;
    stage_slot<kKMajor, width>(v, outer, inner);
    *reinterpret_cast<uint4*>(buf + outer * stride + inner) = r[v];
  }
}

// acc += A . B on the tensor cores over k < K for a 64 x kN output tile,
// where A(m, k) is `a` (k-major when kAK) and B(k, n) is `b` (k-major when
// kBK, else stored [n][k]).
template <int kN, bool kAK, bool kBK, typename TA, typename TB>
__device__ void tile_mm_tc(float (&acc)[kN / 16][4], unsigned char* smem,
                           const Operand<TA>& a, const Operand<TB>& b, int K) {
  constexpr int kAStride = kAK ? kKMajorStride(kTile) : kRowMajorStride;
  constexpr int kBStride = kBK ? kKMajorStride(kN) : kRowMajorStride;
  StageTC<kN>& sm = *reinterpret_cast<StageTC<kN>*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * (kN / 2);
  const int r8 = lane % 8, mi = lane / 8;
  const int n_stages = (K + kDepthTC - 1) / kDepthTC;

  uint4 va[1], vb[kN / kTile];
  fetch_stage<kAK, kTile>(va, a, 0);
  fetch_stage<kBK, kN>(vb, b, 0);
  put_stage<kAK, kTile>(sm.a[0], va);
  put_stage<kBK, kN>(sm.b[0], vb);
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int cur = st & 1, k0 = st * kDepthTC;
    const bool more = st + 1 < n_stages;
    if (more) {
      fetch_stage<kAK, kTile>(va, a, k0 + kDepthTC);
      fetch_stage<kBK, kN>(vb, b, k0 + kDepthTC);
    }
    const __nv_bfloat16* sa = sm.a[cur];
    const __nv_bfloat16* sb = sm.b[cur];
#pragma unroll
    for (int kb = 0; kb < kDepthTC; kb += 16) {
      if (k0 + kb >= K) break;
      uint32_t af[4];
      if constexpr (kAK)  // [k][m]: transposed 8x8 loads
        ldsm_x4<true>(af, sa + (kb + r8 + (mi / 2) * 8) * kAStride + wr +
                              (mi % 2) * 8);
      else                // [m][k]
        ldsm_x4<false>(af, sa + (wr + lane % 16) * kAStride + kb +
                               (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < kN / 16; j += 2) {  // two n8 tiles per ldmatrix
        const int nb = wc + j * 8;
        uint32_t bf[4];
        if constexpr (kBK)  // [k][n]
          ldsm_x4<true>(bf, sb + (kb + r8 + (mi % 2) * 8) * kBStride + nb +
                                (mi / 2) * 8);
        else                // [n][k]
          ldsm_x4<false>(bf, sb + (nb + r8 + (mi / 2) * 8) * kBStride + kb +
                                 (mi % 2) * 8);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
    if (more) {
      put_stage<kAK, kTile>(sm.a[cur ^ 1], va);
      put_stage<kBK, kN>(sm.b[cur ^ 1], vb);
    }
    __syncthreads();
  }
}

// Tile position (row, col) of accumulator acc[a][b] held by this thread.
template <bool kTC, int kN>
__device__ __forceinline__ void frag_pos(int a, int b, int& row, int& col) {
  const int tid = threadIdx.x;
  if constexpr (kTC) {  // acc[n8 tile][c-fragment register]
    const int warp = tid / 32, lane = tid % 32;
    row = (warp % 4) * 16 + lane / 4 + (b >> 1) * 8;
    col = (warp / 4) * (kN / 2) + a * 8 + (lane % 4) * 2 + (b & 1);
  } else {
    row = tid / 16 + 16 * a;
    col = tid % 16 + 16 * b;
  }
}

// Accumulators per thread: 4 n8 tiles x 4 on the tensor cores per 64
// columns, 4 x 4 on the CUDA cores (64 columns only).
template <bool kTC, int kN>
constexpr int kAccRows = kTC ? kN / 16 : 4;

// Park the accumulators (+ add) as a 64 x kN f32 tile, row stride kN + 4.
template <bool kTC, int kN>
__device__ __forceinline__ void park_tile(const float (&acc)[kAccRows<kTC, kN>][4],
                                          float* tile, float add) {
#pragma unroll
  for (int a = 0; a < kAccRows<kTC, kN>; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int r, c;
      frag_pos<kTC, kN>(a, b, r, c);
      tile[r * (kN + 4) + c] = acc[a][b] + add;
    }
  __syncthreads();
}

// ---- f32 path --------------------------------------------------------------
// acc += A . B over one 64 x 64 output tile on the CUDA cores, with
// A(m, k) = a[m * sam + k * sak] for m < M, and B(k, n) = b[k * sbk + n * sbn]
// for n < N, over k < K. Consecutive threads load along whichever axis is
// contiguous.
__device__ void tile_mm_f32(float (&acc)[4][4], unsigned char* smem,
                            const float* a, long long sam, long long sak, int M,
                            const float* b, long long sbk, long long sbn, int N,
                            int K) {
  StageF32& sm = *reinterpret_cast<StageF32*>(smem);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool a_kfast = sak == 1, b_kfast = sbk == 1;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = tid; e < kDepth * kTile; e += kThreads) {
      int kk = a_kfast ? e % kDepth : e / kTile;
      const int mm = a_kfast ? e / kDepth : e % kTile;
      int k = k0 + kk;
      sm.a[kk][mm] = (mm < M && k < K) ? a[mm * sam + k * sak] : 0.f;
      kk = b_kfast ? e % kDepth : e / kTile;
      const int nn = b_kfast ? e / kDepth : e % kTile;
      k = k0 + kk;
      sm.b[kk][nn] = (nn < N && k < K) ? b[k * sbk + nn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---- epilogues: 8 contiguous elements per thread ---------------------------
__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
  const float4 x = reinterpret_cast<const float4*>(p)[0];
  const float4 y = reinterpret_cast<const float4*>(p)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}
__device__ __forceinline__ void load8f(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8f(const int8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = static_cast<float>(c[q]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// bf16 working type: tensor cores; f32 working type: exact f32 FMA.
template <typename TS>
constexpr bool kTensorCores = std::is_same<TS, __nv_bfloat16>::value;

// Lanes per block of the apply kernel: 128 on the tensor cores, so that one
// block stages its strip of E once for all lanes of a 128-lane row.
template <typename TS>
constexpr int kApplyLanes = kTensorCores<TS> ? 2 * kTile : kTile;

// grid (cells on the diagonal, tiles of the cell); block = one 64x64 tile of E.
template <typename TS, typename TW>
__global__ void __launch_bounds__(kThreads)
dense_err_kernel(const float* __restrict__ theta, const float* __restrict__ phi,
                 const TS* __restrict__ s, const TW* __restrict__ w,
                 TS* __restrict__ e_buf, TS* __restrict__ th_snap,
                 TS* __restrict__ ph_snap, int diag, int i_lo, int n_gvp,
                 int tu, int tv, int lanes, int kdim, float gb) {
  constexpr bool kTC = kTensorCores<TS>;
  __shared__ __align__(16) unsigned char sm[smem_bytes<kTC, kTile>()];
  const int x = blockIdx.x, i = i_lo + x, c = diag - i;
  const int n_tv = (tv + kTile - 1) / kTile;
  const int mt = blockIdx.y / n_tv, nt = blockIdx.y % n_tv;
  const int m0 = mt * kTile, n0 = nt * kTile;
  const float* th = theta + ((long long)i * tu + m0) * lanes;
  const float* ph = phi + ((long long)c * tv + n0) * lanes;

  // lanes >= dim + 2 are zero in both tables: the product stops at kdim
  // (rounded up to whole 8-lane vectors on the tensor-core path)
  const int k8 = (kdim + 7) / 8 * 8;
  float acc[kAccRows<kTC, kTile>][4] = {};
  if constexpr (kTC)
    tile_mm_tc<kTile, false, false>(acc, sm, Operand<float>{th, lanes, tu - m0, k8},
                             Operand<float>{ph, lanes, tv - n0, k8}, k8);
  else
    tile_mm_f32(acc, sm, th, lanes, 1, tu - m0, ph, 1, lanes, tv - n0, kdim);

  // E = S - W * pred, row by row in 8-element vectors
  float* pred = reinterpret_cast<float*>(sm);
  park_tile<kTC, kTile>(acc, pred, gb);
  const long long cell = ((long long)i * n_gvp + c) * tu * tv;
  TS* ec = e_buf + (long long)x * tu * tv;
  for (int e = threadIdx.x; e < kTile * kTile / 8; e += kThreads) {
    const int r = e / (kTile / 8), c8 = e % (kTile / 8) * 8;
    if (m0 + r >= tu || n0 + c8 >= tv) continue;
    const long long idx = (long long)(m0 + r) * tv + n0 + c8;
    float sv[8], wv[8], ev[8];
    load8f(s + cell + idx, sv);
    load8f(w + cell + idx, wv);
#pragma unroll
    for (int q = 0; q < 8; ++q) ev[q] = sv[q] - wv[q] * pred[r * (kTile + 4) + c8 + q];
    store8(ec + idx, ev);
  }

  // cell-start copies (working type) for the apply kernel; lanes in
  // [kdim, k8) are zero in the tables
  const int n_vec = k8 / 8;
  if (nt == 0) {
    TS* dst = th_snap + ((long long)x * tu + m0) * lanes;
    for (int e = threadIdx.x; e < kTile * n_vec; e += kThreads) {
      const int r = e / n_vec, l = e % n_vec * 8;
      float v[8];
      if (m0 + r >= tu) continue;
      load8f(th + (long long)r * lanes + l, v);
      store8(dst + (long long)r * lanes + l, v);
    }
  }
  if (mt == 0) {
    TS* dst = ph_snap + ((long long)x * tv + n0) * lanes;
    for (int e = threadIdx.x; e < kTile * n_vec; e += kThreads) {
      const int r = e / n_vec, l = e % n_vec * 8;
      float v[8];
      if (n0 + r >= tv) continue;
      load8f(ph + (long long)r * lanes + l, v);
      store8(dst + (long long)r * lanes + l, v);
    }
  }
}

// grid (cells on the diagonal, user strips then item strips, lane tiles);
// block = 64 rows x kApplyLanes lanes of one table's update.
template <typename TS>
__global__ void __launch_bounds__(kThreads)
dense_apply_kernel(float* __restrict__ theta, float* __restrict__ phi,
                   const TS* __restrict__ e_buf, const TS* __restrict__ th_snap,
                   const TS* __restrict__ ph_snap, const float* __restrict__ ku,
                   const float* __restrict__ kv, int diag, int i_lo, int n_gvp,
                   int tu, int tv, int lanes, int dim, float eta,
                   float ln_decay, float cap, int saturate) {
  constexpr bool kTC = kTensorCores<TS>;
  constexpr int kN = kApplyLanes<TS>;
  __shared__ __align__(16) unsigned char sm[smem_bytes<kTC, kN>()];
  const int k8 = (dim + 2 + 7) / 8 * 8;  // lanes held by the start copies
  const int x = blockIdx.x, i = i_lo + x, c = diag - i;
  const long long cell = (long long)i * n_gvp + c;
  const int n_su = (tu + kTile - 1) / kTile;
  const bool user = blockIdx.y < n_su;
  const int r0 = (user ? blockIdx.y : blockIdx.y - n_su) * kTile;
  const int l0 = blockIdx.z * kN;
  const TS* ec = e_buf + (long long)x * tu * tv;

  float acc[kAccRows<kTC, kN>][4] = {};
  float* tab;
  const float* kc;
  int rows;
  const TS* phs = ph_snap + (long long)x * tv * lanes + l0;
  const TS* ths = th_snap + (long long)x * tu * lanes + l0;
  if (user) {  // dtheta[r0:, l0:] = E[r0:, :] . phi_start[:, l0:]
    const TS* er = ec + (long long)r0 * tv;
    if constexpr (kTC)
      tile_mm_tc<kN, false, true>(acc, sm, Operand<TS>{er, tv, tu - r0, tv},
                              Operand<TS>{phs, lanes, tv, k8 - l0}, tv);
    else
      tile_mm_f32(acc, sm, er, tv, 1, tu - r0, phs, lanes, 1, k8 - l0,
                         tv);
    tab = theta + ((long long)i * tu + r0) * lanes;
    kc = ku + cell * tu + r0;
    rows = tu - r0;
  } else {     // dphi[r0:, l0:] = E[:, r0:]^T . theta_start[:, l0:]
    if constexpr (kTC)
      tile_mm_tc<kN, true, true>(acc, sm, Operand<TS>{ec + r0, tv, tu, tv - r0},
                             Operand<TS>{ths, lanes, tu, k8 - l0}, tu);
    else
      tile_mm_f32(acc, sm, ec + r0, 1, tv, tv - r0, ths, lanes, 1,
                         k8 - l0, tu);
    tab = phi + ((long long)c * tv + r0) * lanes;
    kc = kv + cell * tv + r0;
    rows = tv - r0;
  }

  // decay and apply, row by row in 8-lane vectors of the live table
  float* grad = reinterpret_cast<float*>(sm);
  park_tile<kTC, kN>(acc, grad, 0.f);
  for (int e = threadIdx.x; e < kTile * kN / 8; e += kThreads) {
    const int r = e / (kN / 8), c8 = e % (kN / 8) * 8, l = l0 + c8;
    if (r >= rows || l >= k8) continue;
    const float k = kc[r];
    const float dec = expf(k * ln_decay);
    const float sat = fminf(1.f, cap / fmaxf(k, 1.f));
    float* p = tab + (long long)r * lanes + l;
    float cur[8];
    load8f(p, cur);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // theta keeps factors and bu; phi keeps factors and bv (one-lanes stay 1)
      const int lq = l + q;
      const bool keep = user ? (lq <= dim) : (lq < dim || lq == dim + 1);
      if (!keep) continue;
      float d = grad[r * (kN + 4) + c8 + q] * eta;
      if (saturate) d = d * sat;
      cur[q] = cur[q] * (1.f + (dec - 1.f)) + d;
    }
    store8(p, cur);
  }
}

template <typename TS, typename TW>
int run_epoch(float* theta, float* phi, const void* s, const void* w,
              const float* ku, const float* kv, void* e_buf, void* th_snap,
              void* ph_snap, int n_gu, int n_gvp, int tu, int tv, int lanes,
              int dim, float eta, float lam, float gb, float cap, int saturate,
              cudaStream_t stream) {
  const int kdim = dim + 2;
  const int n_tu = (tu + kTile - 1) / kTile, n_tv = (tv + kTile - 1) / kTile;
  const int n_l = (kdim + kApplyLanes<TS> - 1) / kApplyLanes<TS>;
  const float ln_decay = logf(1.f - eta * lam);
  for (int d = 0; d < n_gu + n_gvp - 1; ++d) {
    const int i_lo = d - (n_gvp - 1) > 0 ? d - (n_gvp - 1) : 0;
    const int i_hi = d < n_gu - 1 ? d : n_gu - 1;
    const int nc = i_hi - i_lo + 1;
    dense_err_kernel<TS, TW><<<dim3(nc, n_tu * n_tv), kThreads, 0, stream>>>(
        theta, phi, static_cast<const TS*>(s), static_cast<const TW*>(w),
        static_cast<TS*>(e_buf), static_cast<TS*>(th_snap),
        static_cast<TS*>(ph_snap), d, i_lo, n_gvp, tu, tv, lanes, kdim, gb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_apply_kernel<TS><<<dim3(nc, n_tu + n_tv, n_l), kThreads, 0, stream>>>(
        theta, phi, static_cast<const TS*>(e_buf),
        static_cast<const TS*>(th_snap), static_cast<const TS*>(ph_snap), ku,
        kv, d, i_lo, n_gvp, tu, tv, lanes, dim, eta, ln_decay, cap, saturate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// ---- the wavefront walk (one persistent launch per epoch) ------------------
// A unit is one user-tile row i of the grid, walked c = 0 .. n_gvp-1 by one
// thread-block cluster of ceil(tu / 64) blocks; block q holds user rows
// [64q, 64q + 64) of every cell of the row. Units are numbered by an atomic
// ticket, so a unit only ever waits for a unit that is already running.

constexpr int kWalkRows = 64;       // user rows per block of a cluster
constexpr int kWalkThreads = 512;   // 4 warpgroups
constexpr int kGroup = 256;         // after E: the reduction group
                                    // (warpgroups 0-1) and the theta group (2-3)
constexpr int kMaxLC = 96;          // lanes of a row on chip (a multiple of 16)
constexpr int kMaxCluster = 8;      // blocks per cluster (the portable most)
constexpr int kBox = 8192;          // bytes of an S/W TMA box: 64 x 128 B
constexpr long long kSpinLimit = 1ll << 34;  // cycles (~9 s): a wait traps

struct WalkArgs {
  CUtensorMap tm_s;   // S as (n_gu n_gvp tu) rows of tv, boxes of 64 x 64
  CUtensorMap tm_w;   // W likewise, boxes of 64 rows x 128 bytes
  CUtensorMap tm_ph;  // the bf16 shadow of phi, boxes of 64 rows x 16 lanes
  float* theta;
  float* phi;
  __nv_bfloat16* shadow;  // phi's rows in bf16 ([n_gvp tv][lc])
  const float* ku;
  const float* kv;
  unsigned* ready;   // [n_gvp]: blocks that have left item tile c (numbered)
  unsigned* ticket;  // the unit tickets (numbered)
  int n_gu, n_gvp, tu, tv, lanes, dim, lc;
  unsigned ticket_base, ready_base;
  float eta, ln_decay, cap, gb;
  int saturate;
};

// Item rows each block of a cluster reduces: whole 16-row blocks.
__host__ __device__ inline int walk_slice(int tv, int cluster) {
  return ((tv + cluster - 1) / cluster + 15) / 16 * 16;
}

// Shared memory of one block, in bytes (ops/sgd_dense.py: walk_smem_bytes
// mirrors it). The S and W stages hold 128-byte-swizzled TMA boxes and
// start 1024-aligned; E overwrites S in place, in the same layout. The phi
// tile and the two theta tiles are bf16 in 16-lane boxes of rows of 32
// bytes under the 32-byte swizzle (pbo).
struct WalkLayout {
  int s, w, pb, tb, dp, ps, total;
  int tb_bytes;  // one theta tile; two at tb: the cell's and the next cell's
};

__host__ __device__ inline int align128(int x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline WalkLayout walk_layout(int tv, int lc, int w_bytes,
                                                  int cluster) {
  const int rq = walk_slice(tv, cluster);
  WalkLayout L;
  int off = 1024;  // mbarriers and the unit number; S 1024-aligned
  L.s = off;  off += kWalkRows * tv * 2;                   // S, then E
  L.w = off;  off += kWalkRows * tv * w_bytes;             // W
  L.pb = off; off += tv * lc * 2;                          // phi tile
  L.tb_bytes = kWalkRows * lc * 2;
  L.tb = off; off += 2 * L.tb_bytes;                       // theta tiles
  L.dp = off; off += align128(tv * (lc + 4) * 4);          // dphi partial
  L.ps = off; off += align128(rq * lc * 4);                // phi slice, f32
  L.total = off + 1024;  // slack to align the dynamic base to 1024
  return L;
}

// Byte offset of element `col` (of `eb` bytes) of row r in a stage of
// 64-row boxes of 128 bytes under the 128-byte swizzle: the 16-byte chunk
// index is XORed with the row's index mod 8.
__device__ __forceinline__ int swz(int r, int col, int eb) {
  const int b = col * eb;
  return (b >> 7) * kBox + r * 128 + ((((b >> 4) & 7) ^ (r & 7)) << 4) +
         (b & 15);
}

// Byte offset of (row r, lane l) of a bf16 tile of `rows` rows in 16-lane
// boxes of rows of 32 bytes under the 32-byte swizzle (the 16-byte half is
// XORed with bit 2 of the row).
__device__ __forceinline__ int pbo(int r, int l, int rows) {
  return (l >> 4) * (rows * 32) + r * 32 +
         ((((l >> 3) & 1) ^ ((r >> 2) & 1)) << 4) + (l & 7) * 2;
}

// ---- wgmma: m64nNk16, bf16 operands in shared memory, f32 sums ------------
// A descriptor of a swizzled shared-memory operand: start address, the
// leading byte offset (K-major: unused; MN-major: from one swizzle atom to
// the next along M or N), the stride byte offset (from one group of 8 rows
// to the next: along M or N when K-major, along K when MN-major), and the
// swizzle (1: 128 bytes, 3: 32 bytes).
constexpr int kSw128 = 1;
constexpr int kSw32 = 3;
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, int lbo, int sbo,
                                          int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}
// A descriptor moved on by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t gmove(uint64_t d, int bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}

// d (+)= A . B, one k16 step; the accumulators as mma.sync's m16n8 tiles:
// warp w of the warpgroup holds rows 16 w + lane / 4 (+ 8 for d[j][2..3])
// and columns 8 j + 2 (lane % 4) (+ 1 for d[j][1], d[j][3]). kTA / kTB: 1
// where that operand is MN-major. acc 0 overwrites d.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n16(float (&d)[2][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n48(float (&d)[6][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %26, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n80(float (&d)[10][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %42, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %50, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

template <int N, int kTA, int kTB>
__device__ __forceinline__ void wgmma(float (&d)[N / 8][4], uint64_t da,
                                      uint64_t db, int acc) {
  if constexpr (N == 16) wgmma_n16<kTA, kTB>(d, da, db, acc);
  else if constexpr (N == 32) wgmma_n32<kTA, kTB>(d, da, db, acc);
  else if constexpr (N == 48) wgmma_n48<kTA, kTB>(d, da, db, acc);
  else if constexpr (N == 64) wgmma_n64<kTA, kTB>(d, da, db, acc);
  else if constexpr (N == 80) wgmma_n80<kTA, kTB>(d, da, db, acc);
  else wgmma_n96<kTA, kTB>(d, da, db, acc);
}

// The accumulators are written asynchronously between wgmma_begin and
// wgmma_end: the register fences keep the compiler's own accesses out.
template <int J>
__device__ __forceinline__ void fence_acc(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+f"(d[j][k]) :: "memory");
}
template <int J>
__device__ __forceinline__ void wgmma_begin(float (&d)[J][4]) {
  fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
template <int J>
__device__ __forceinline__ void wgmma_end(float (&d)[J][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}

// Generic writes to shared memory before the tensor cores or TMA use it.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// The cluster barrier in two halves, so that a block can announce that it
// is done with its peers' shared memory and with its phi tile (the
// relaxed arrive: its reads have returned) and wait for the others only
// when it is about to overwrite them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A float4 of block `rank`'s shared memory at the offset of local address
// `addr` (mapa, then ld.shared::cluster).
__device__ __forceinline__ float4 ld_peer4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote));
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* tm,
                                        int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y),
         "r"(bar) : "memory");
}

// The same box into the same offset of every block in `mask`, completing on
// each one's mbarrier at `bar`.
__device__ __forceinline__ void tma_box_multicast(uint32_t dst,
                                                  const CUtensorMap* tm, int x,
                                                  int y, uint32_t bar,
                                                  uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y),
         "r"(bar), "h"(mask) : "memory");
}

// Thread 0: this block's 64 rows of one cell's S and W into the stage, as
// TMA boxes completing on the block's mbarrier (rows past the cell's, of
// the next cell or zero past the last, are ignored). Every thread's proxy
// fence before the preceding barrier orders the stage's generic accesses
// (E) before the asynchronous writes.
__device__ __forceinline__ void walk_fetch(const WalkArgs& a,
                                           uint32_t stage_s, uint32_t stage_w,
                                           uint32_t bar, int w_bytes,
                                           long long cell, int row0) {
  const int y = static_cast<int>(cell * a.tu + row0);
  const int ns = a.tv * 2 / 128, nw = a.tv * w_bytes / 128;
  mbar_expect(bar, (ns + nw) * kBox);
  for (int k = 0; k < ns; ++k) tma_box(stage_s + k * kBox, &a.tm_s, k * 64, y, bar);
  for (int k = 0; k < nw; ++k)
    tma_box(stage_w + k * kBox, &a.tm_w, k * 128 / w_bytes, y, bar);
}

// The block's 64 rows of the theta tile (`lanes` floats a row) rounded to
// bf16 into dst (pbo layout); rows from `rows` on and lanes from kdim on
// are zero. Read through L2, kTileBatch loads in flight a thread.
constexpr int kBatch = 4;
constexpr int kTileBatch = 8;
__device__ void walk_tile(unsigned char* dst, const float* src, int rows,
                          int lanes, int lc, int kdim) {
  const int q4 = lc / 4, n = kWalkRows * q4;
  for (int e0 = threadIdx.x; e0 < n; e0 += kTileBatch * kWalkThreads) {
    float4 v[kTileBatch];
#pragma unroll
    for (int b = 0; b < kTileBatch; ++b) {
      const int e = e0 + b * kWalkThreads, r = e / q4, l = e % q4 * 4;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n && r < rows && l < kdim)  // lanes past kdim are zero
        v[b] = __ldcg(reinterpret_cast<const float4*>(src + (long long)r * lanes + l));
    }
#pragma unroll
    for (int b = 0; b < kTileBatch; ++b) {
      const int e = e0 + b * kWalkThreads, r = e / q4, l = e % q4 * 4;
      if (e < n)
        *reinterpret_cast<uint2*>(dst + pbo(r, l, kWalkRows)) =
            make_uint2(pack_bf16(v[b].x, v[b].y), pack_bf16(v[b].z, v[b].w));
    }
  }
}

// The phi tile from its f32 rows (read through L2: other blocks write them
// during the epoch), rounded to bf16 into pb (pbo layout), lanes from kdim
// on zero; rows [m0, m0 + nm) are also kept in f32 in ps ([nm][lc]).
__device__ void walk_phi_f32(unsigned char* pb, float* ps, const float* src,
                             int tv, int lanes, int lc, int kdim, int m0,
                             int nm) {
  const int q4 = lc / 4, n = tv * q4;
  for (int e0 = threadIdx.x; e0 < n; e0 += kTileBatch * kWalkThreads) {
    float4 v[kTileBatch];
#pragma unroll
    for (int b = 0; b < kTileBatch; ++b) {
      const int e = e0 + b * kWalkThreads, r = e / q4, l = e % q4 * 4;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n && l < kdim)
        v[b] = __ldcg(reinterpret_cast<const float4*>(src + (long long)r * lanes + l));
    }
#pragma unroll
    for (int b = 0; b < kTileBatch; ++b) {
      const int e = e0 + b * kWalkThreads, r = e / q4, l = e % q4 * 4;
      if (e >= n) continue;
      *reinterpret_cast<uint2*>(pb + pbo(r, l, tv)) =
          make_uint2(pack_bf16(v[b].x, v[b].y), pack_bf16(v[b].z, v[b].w));
      if (r >= m0 && r < m0 + nm)
        *reinterpret_cast<float4*>(ps + (r - m0) * lc + l) = v[b];
    }
  }
}

// The phi tile from the bf16 shadow the unit above wrote: thread 0 of
// block q sends the 64-row boxes q, q + cs, ... to every block of the
// cluster (TMA multicast), each completing on the receiver's mbarrier at
// pbar; every thread copies its share of the block's f32 slice rows
// [m0, m0 + nm) into ps with cp.async and waits for its own copies before
// the barrier after E (cp.async.wait_all there), ahead of the reduction's
// reads. The proxy fence orders the generic writes of the shadow, which
// the ready counter's acquire made visible, before the TMA reads them.
__device__ __forceinline__ void walk_phi_shadow(const WalkArgs& a,
                                                uint32_t pb, uint32_t pbar,
                                                float* ps, int c, int q,
                                                int cs, int m0, int nm) {
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    const uint16_t mask = static_cast<uint16_t>((1u << cs) - 1u);
    for (int rb = q; rb < a.tv / 64; rb += cs)
      for (int lb = 0; lb < a.lc / 16; ++lb)
        tma_box_multicast(pb + lb * (a.tv * 32) + rb * 64 * 32, &a.tm_ph,
                          lb * 16, c * a.tv + rb * 64, pbar, mask);
  }
  const int q4 = a.lc / 4, kdim = a.dim + 2;
  const float* src = a.phi + ((long long)c * a.tv + m0) * a.lanes;
  for (int e = threadIdx.x; e < nm * q4; e += kWalkThreads) {
    const int r = e / q4, l = e % q4 * 4;
    if (l < kdim)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_addr(ps + r * a.lc + l)),
                      "l"(src + (long long)r * a.lanes + l) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// pred[64 x tv] = theta_b . phi_b^T: warpgroup g the columns
// [g N, g N + N), N = tv / 4, k over the lc lanes. Both operands K-major
// (pbo: a 16-lane box per k step, 8 rows a 256-byte group).
constexpr int kPredTiles = 8;  // 8-column tiles a warp (tv 256)
template <int N>
__device__ __forceinline__ void walk_pred_n(float (&acc)[N / 8][4],
                                            uint32_t tb, uint32_t pb, int lc) {
  const int g = threadIdx.x / 128;
  const uint64_t da = gdesc(tb, 16, 256, kSw32);
  const uint64_t db = gdesc(pb + g * N * 32, 16, 256, kSw32);
  wgmma_begin(acc);
  for (int k = 0; k < lc / 16; ++k)
    wgmma<N, 0, 0>(acc, gmove(da, k * kWalkRows * 32),
                   gmove(db, k * 4 * N * 32), k);
  wgmma_end(acc);
}
__device__ __forceinline__ void walk_pred(float (&acc)[kPredTiles][4],
                                          uint32_t tb, uint32_t pb, int tv,
                                          int lc) {
  if (tv == 256)
    walk_pred_n<64>(acc, tb, pb, lc);
  else
    walk_pred_n<32>(reinterpret_cast<float (&)[4][4]>(acc), tb, pb, lc);
}

__device__ __forceinline__ void load_w2(const int8_t* p, float& a, float& b) {
  a = static_cast<float>(p[0]);
  b = static_cast<float>(p[1]);
}
__device__ __forceinline__ void load_w2(const __nv_bfloat16* p, float& a,
                                        float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}

// E = S - W * (pred + gb), rounded to bf16, from the accumulators into the
// S stage in place (each element is read and written by the same thread);
// rows from `rows` on are zero.
template <typename TW>
__device__ __forceinline__ void walk_err(const float (&acc)[kPredTiles][4],
                                         unsigned char* s,
                                         const unsigned char* w, int tv,
                                         int rows, float gb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * (tv / 4), nj = tv / 32;
#pragma unroll
  for (int j = 0; j < kPredTiles; ++j) {
    if (j < nj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + lane / 4 + h * 8, c = wc + j * 8 + (lane % 4) * 2;
        uint32_t* sp = reinterpret_cast<uint32_t*>(s + swz(r, c, 2));
        float e0 = 0.f, e1 = 0.f;
        if (r < rows) {
          const float2 sv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sp));
          float w0, w1;
          load_w2(reinterpret_cast<const TW*>(w + swz(r, c, sizeof(TW))), w0,
                  w1);
          e0 = sv.x - w0 * (acc[j][2 * h] + gb);
          e1 = sv.y - w1 * (acc[j][2 * h + 1] + gb);
        }
        *sp = pack_bf16(e0, e1);
      }
    }
  }
}

// This block's dphi partial [tv x lc] = E^T . theta_b over its 64 user
// rows, f32 into dp ([tv][lc + 4]): reduction warpgroup h (0, 1) the
// 64-row blocks h, h + 2 of item rows. A = E^T, M-major in E's stage (a
// box of 64 item columns, 8 user rows a 1024-byte group); B = theta_b,
// N-major (16-lane boxes 64 x 32 bytes apart, 8 user rows a 256-byte
// group).
template <int N>
__device__ void walk_dphi_n(float* dp, uint32_t e, uint32_t tb, int tv) {
  const int h = threadIdx.x / 128, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32, ds = N + 4;
  const uint64_t db = gdesc(tb, kWalkRows * 32, 256, kSw32);
  for (int mb = h; mb < tv / 64; mb += 2) {
    float acc[N / 8][4] = {};
    const uint64_t da = gdesc(e + mb * kBox, kBox, 1024, kSw128);
    wgmma_begin(acc);
#pragma unroll
    for (int k = 0; k < kWalkRows / 16; ++k)
      wgmma<N, 1, 1>(acc, gmove(da, k * 2048), gmove(db, k * 512), k);
    wgmma_end(acc);
    const int r = mb * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int t = 0; t < N / 8; ++t) {
      const int c = t * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(dp + r * ds + c) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(dp + (r + 8) * ds + c) =
          make_float2(acc[t][2], acc[t][3]);
    }
  }
}
__device__ void walk_dphi(float* dp, uint32_t e, uint32_t tb, int tv, int lc) {
  switch (lc / 16) {
    case 1: walk_dphi_n<16>(dp, e, tb, tv); break;
    case 2: walk_dphi_n<32>(dp, e, tb, tv); break;
    case 3: walk_dphi_n<48>(dp, e, tb, tv); break;
    case 4: walk_dphi_n<64>(dp, e, tb, tv); break;
    case 5: walk_dphi_n<80>(dp, e, tb, tv); break;
    default: walk_dphi_n<96>(dp, e, tb, tv); break;
  }
}

__device__ __forceinline__ float walk_step(float row, float d, float dec,
                                           float sat, bool keep,
                                           const WalkArgs& a) {
  if (!keep) return row;
  d *= a.eta;
  if (a.saturate) d *= sat;
  return row * (1.f + (dec - 1.f)) + d;
}

// dtheta [64 x N] = E . phi_b for the lanes [16 p0, 16 p0 + N) of this
// theta warpgroup, then decay and apply to the block's live theta rows
// (kept lanes <= dim) and round the new rows into tn, the next cell's bf16
// tile. A = E, K-major in its stage (rows of 128 bytes, 8 a 1024-byte
// group, a box of 64 item columns per 4 k steps); B = phi_b, N-major
// (16-lane boxes tv x 32 bytes apart, 8 item rows a 256-byte group).
template <int N>
__device__ void walk_theta_n(const WalkArgs& a, uint32_t e, uint32_t pb,
                             unsigned char* tn, long long cell, int i,
                             int row0, int rows, int p0) {
  constexpr int kJ = N / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* th = a.theta + ((long long)i * a.tu + row0) * a.lanes;
  int r[2];
  float k[2];
  float2 cur[2][kJ];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    r[g] = (warp % 4) * 16 + lane / 4 + g * 8;
    k[g] = r[g] < rows ? a.ku[cell * a.tu + row0 + r[g]] : 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int l = p0 * 16 + j * 8 + (lane % 4) * 2;
      if (r[g] < rows && l <= a.dim)  // theta keeps lanes <= dim
        cur[g][j] = __ldcg(reinterpret_cast<const float2*>(
            th + (long long)r[g] * a.lanes + l));
    }
  }
  float acc[kJ][4] = {};
  const uint64_t da = gdesc(e, 16, 1024, kSw128);
  const uint64_t db = gdesc(pb + p0 * a.tv * 32, a.tv * 32, 256, kSw32);
  wgmma_begin(acc);
  for (int s = 0; s < a.tv / 16; ++s)
    wgmma<N, 0, 1>(acc, gmove(da, (s / 4) * kBox + (s % 4) * 32),
                   gmove(db, s * 512), s);
  wgmma_end(acc);
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const float dec = expf(k[g] * a.ln_decay);
    const float sat = fminf(1.f, a.cap / fmaxf(k[g], 1.f));
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int l = p0 * 16 + j * 8 + (lane % 4) * 2;
      if (!(r[g] < rows && l <= a.dim)) continue;
      float2 v = cur[g][j];
      v.x = walk_step(v.x, acc[j][2 * g], dec, sat, true, a);
      v.y = walk_step(v.y, acc[j][2 * g + 1], dec, sat, l + 1 <= a.dim, a);
      *reinterpret_cast<uint32_t*>(tn + pbo(r[g], l, kWalkRows)) =
          pack_bf16(v.x, v.y);
      __stcg(reinterpret_cast<float2*>(th + (long long)r[g] * a.lanes + l), v);
    }
  }
}
__device__ void walk_theta(const WalkArgs& a, uint32_t e, uint32_t pb,
                           unsigned char* tn, long long cell, int i, int row0,
                           int rows, int p0, int np) {
  switch (np) {
    case 1: walk_theta_n<16>(a, e, pb, tn, cell, i, row0, rows, p0); break;
    case 2: walk_theta_n<32>(a, e, pb, tn, cell, i, row0, rows, p0); break;
    case 3: walk_theta_n<48>(a, e, pb, tn, cell, i, row0, rows, p0); break;
    default: break;  // no lanes for this warpgroup (lc 16)
  }
}

// The column counts of the first batch of the reduction's rows.
__device__ __forceinline__ void walk_reduce_counts(float (&k)[kBatch],
                                                   const WalkArgs& a,
                                                   long long cell, int m0,
                                                   int nm) {
  const int q4 = a.lc / 4;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int e = threadIdx.x + b * kGroup;
    k[b] = e < nm * q4 ? a.kv[cell * a.tv + m0 + e / q4] : 0.f;
  }
}

// Sum the cluster's dphi partials for this block's slice of item rows
// [m0, m0 + nm), in rank order, reading the peers' shared memory
// (ld.shared::cluster), then decay and apply them to the slice's
// cell-start rows (f32 in ps) and write phi_c's rows and their bf16
// rounding into the shadow (lanes past dim + 1 as zero). phi keeps factors
// and bv (lane < dim or lane == dim + 1). k0: the first batch's column
// counts (walk_reduce_counts).
__device__ void walk_reduce_phi(float* dp, const float* ps, const WalkArgs& a,
                                long long cell, int c, int cs, int m0, int nm,
                                const float (&k0)[kBatch]) {
  const int ds = a.lc + 4, q4 = a.lc / 4, d = a.dim, n = nm * q4;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kGroup) {
    float4 g[kBatch];
    float k[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kGroup, m = m0 + e / q4, l = e % q4 * 4;
      g[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!(e < n && l <= d + 1)) continue;
      k[b] = e0 == threadIdx.x ? k0[b] : a.kv[cell * a.tv + m];
      const uint32_t mine = smem_addr(dp + m * ds + l);
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < cs) {
          const float4 v = ld_peer4(mine, r);
          g[b].x += v.x;
          g[b].y += v.y;
          g[b].z += v.z;
          g[b].w += v.w;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kGroup, m = m0 + e / q4, l = e % q4 * 4;
      if (e >= n) continue;
      uint2* sh = reinterpret_cast<uint2*>(
          a.shadow + ((long long)c * a.tv + m) * a.lc + l);
      if (l > d + 1) {
        *sh = make_uint2(0u, 0u);
        continue;
      }
      const float dec = expf(k[b] * a.ln_decay);
      const float sat = fminf(1.f, a.cap / fmaxf(k[b], 1.f));
      float4 v = *reinterpret_cast<const float4*>(ps + (e / q4) * a.lc + l);
      v.x = walk_step(v.x, g[b].x, dec, sat, l < d || l == d + 1, a);
      v.y = walk_step(v.y, g[b].y, dec, sat, l + 1 < d || l + 1 == d + 1, a);
      v.z = walk_step(v.z, g[b].z, dec, sat, l + 2 < d || l + 2 == d + 1, a);
      v.w = walk_step(v.w, g[b].w, dec, sat, l + 3 < d || l + 3 == d + 1, a);
      __stcg(reinterpret_cast<float4*>(
                 a.phi + ((long long)c * a.tv + m) * a.lanes + l), v);
      *sh = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
}

// Per-phase clock sums of the walk, in a diagnostic build only
// (-DTMF_WALK_CLOCKS, which chip_smoke.py phase 3 loads beside the main
// build): thread 0 times the shared part of each cell and the reduction
// group's phases (0-9), thread 256 the theta group's (10-13), each from its
// own last tick, in the block's shared-memory header. The main build has
// no clocks.
#ifdef TMF_WALK_CLOCKS
constexpr int kClockPhases = 14;
__device__ unsigned long long walk_clocks[kClockPhases];
__device__ __forceinline__ void walk_tick(unsigned char* sm, int who, int k) {
  if (threadIdx.x != who) return;
  unsigned long long* c = reinterpret_cast<unsigned long long*>(sm + 32);
  unsigned long long& mark = c[kClockPhases + (who ? 1 : 0)];
  const unsigned long long now = clock64();
  c[k] += now - mark;
  mark = now;
}
#define WALK_TICK(who, k) walk_tick(sm, who, k)
#else
#define WALK_TICK(who, k) ((void)0)
#endif

template <typename TW>
__global__ void __launch_bounds__(kWalkThreads, 1)
dense_walk_kernel(const __grid_constant__ WalkArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const WalkLayout L = walk_layout(a.tv, a.lc, sizeof(TW), cs);
  const uint32_t bar = smem_addr(sm), pbar = bar + 8;  // S/W; phi tile
  int* s_unit = reinterpret_cast<int*>(sm + 16);
  unsigned char* e = sm + L.s;  // S, then E in place
  unsigned char* pb = sm + L.pb;
  unsigned char* tb = sm + L.tb;
  float* dp = reinterpret_cast<float*>(sm + L.dp);
  float* ps = reinterpret_cast<float*>(sm + L.ps);
  const int row0 = q * kWalkRows, rows = min(kWalkRows, a.tu - row0);
  const int rq = walk_slice(a.tv, cs), m0 = q * rq;
  const int nm = max(0, min(a.tv, m0 + rq) - m0);  // item rows reduced here
  const int kdim = a.dim + 2, wg = threadIdx.x / 128;
  // the theta warpgroups split the lanes' 16-lane boxes: [0, nb2), [nb2, nb)
  const int nb = a.lc / 16, nb2 = (nb + 1) / 2;
  const int p0 = wg == 2 ? 0 : nb2, np = wg == 2 ? nb2 : nb - nb2;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(pbar);
  }
#ifdef TMF_WALK_CLOCKS
  if (threadIdx.x == 0) {
    unsigned long long* c = reinterpret_cast<unsigned long long*>(sm + 32);
    for (int k = 0; k < kClockPhases; ++k) c[k] = 0;
    c[kClockPhases] = c[kClockPhases + 1] = clock64();
  }
#endif
  cluster.sync();  // every block of the cluster runs before any remote access

  // The block's theta rows stay on chip for the whole unit (bf16,
  // double-buffered: the theta group rounds the next cell's tile while the
  // reduction group still reads this one), and the units hand phi on as a
  // bf16 shadow read by TMA multicast.
  const bool reducer = wg < 2;
  unsigned waited = 0, pwaited = 0;  // mbarrier phases waited for
  int par = 0;           // the theta tile of this cell
  bool pending = false;  // a cluster_arrive awaits its cluster_wait
  for (;;) {
    if (pending) cluster_wait();
    pending = false;
    if (q == 0 && threadIdx.x == 0) {
      const int unit = static_cast<int>(atomicAdd(a.ticket, 1u) - a.ticket_base);
      for (int r = 0; r < cs; ++r) *cluster.map_shared_rank(s_unit, r) = unit;
    }
    cluster.sync();
    const int i = *s_unit;
    if (i >= a.n_gu) break;
    if (threadIdx.x == 0)
      walk_fetch(a, bar + L.s, bar + L.w, bar, sizeof(TW),
                 (long long)i * a.n_gvp, row0);
    // both tiles: the rows and lanes no cell updates
    const float* th = a.theta + ((long long)i * a.tu + row0) * a.lanes;
    walk_tile(tb, th, rows, a.lanes, a.lc, kdim);
    walk_tile(tb + L.tb_bytes, th, rows, a.lanes, a.lc, kdim);
    fence_async_shared();
    par = 0;
    for (int c = 0; c < a.n_gvp; ++c) {
      const long long cell = (long long)i * a.n_gvp + c;
      unsigned char* tc = tb + par * L.tb_bytes;  // this cell's theta
      unsigned char* tn = tb + (par ^ 1) * L.tb_bytes;
      if (threadIdx.x == 0) {  // every block of unit i - 1 has left tile c
        const unsigned want =
            (a.ready_base + static_cast<unsigned>(i)) * static_cast<unsigned>(cs);
        const long long t0 = clock64();
        while (static_cast<int>(ld_acquire(a.ready + c) - want) < 0)
          if (clock64() - t0 > kSpinLimit) __trap();
        if (i > 0) mbar_expect(pbar, a.tv * a.lc * 2);
      }
      __syncthreads();
      WALK_TICK(0, 0);

      // unit 0 has no unit above it and reads phi in f32
      if (i > 0) {
        if (pending) cluster_wait();  // every block is done with its tile
        pending = false;
        walk_phi_shadow(a, bar + L.pb, pbar, ps, c, q, cs, m0, nm);
        mbar_wait(pbar, pwaited & 1);
        ++pwaited;
      } else {
        walk_phi_f32(pb, ps, a.phi + (long long)c * a.tv * a.lanes, a.tv,
                     a.lanes, a.lc, kdim, m0, nm);
        fence_async_shared();
        __syncthreads();
      }
      WALK_TICK(0, 1);
      float acc[kPredTiles][4] = {};
      walk_pred(acc, smem_addr(tc), bar + L.pb, a.tv, a.lc);
      WALK_TICK(0, 2);
      mbar_wait(bar, waited & 1);
      ++waited;
      WALK_TICK(0, 3);
      walk_err<TW>(acc, e, sm + L.w, a.tv, rows, a.gb);
      // this thread's copies into ps have landed, and E's generic writes
      // come before the tensor cores read it
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      fence_async_shared();
      __syncthreads();
      WALK_TICK(0, 4);
      WALK_TICK(kGroup, 10);

      if (pending) cluster_wait();  // the peers are done with dp
      pending = false;
      if (reducer) {  // dphi, the cluster's reduction, the hand-off
        float kc[kBatch];
        walk_reduce_counts(kc, a, cell, m0, nm);
        walk_dphi(dp, bar + L.s, smem_addr(tc), a.tv, a.lc);
        WALK_TICK(0, 5);
        cluster_arrive_release();  // this block's partial is complete
        cluster_wait();
        WALK_TICK(0, 6);
        walk_reduce_phi(dp, ps, a, cell, c, cs, m0, nm, kc);
        WALK_TICK(0, 7);
        asm volatile("bar.sync 1, %0;\n" :: "n"(kGroup) : "memory");
        // this block's rows of phi_c: the barrier orders the group's
        // stores before thread 0's release (cumulative at gpu scope), and
        // the proxy fence the shadow's before the next unit's TMA reads
        if (threadIdx.x == 0) {
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          red_release(a.ready + c, 1u);
        }
        WALK_TICK(0, 8);
      } else {  // dtheta and theta's update, at the same time
        cluster_arrive();  // no partial to publish
        walk_theta(a, bar + L.s, bar + L.pb, tn, cell, i, row0, rows, p0, np);
        WALK_TICK(kGroup, 11);
        cluster_wait();
        WALK_TICK(kGroup, 12);
      }
      // E's, the phi tile's and tn's generic accesses before the next
      // asynchronous accesses to them
      fence_async_shared();
      __syncthreads();
      cluster_arrive();  // done with the peers' dp and with the phi tile
      pending = true;
      par ^= 1;
      if (threadIdx.x == 0 && c + 1 < a.n_gvp)
        walk_fetch(a, bar + L.s, bar + L.w, bar, sizeof(TW), cell + 1, row0);
      WALK_TICK(0, 9);
      WALK_TICK(kGroup, 13);
    }
  }
#ifdef TMF_WALK_CLOCKS
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 0; k < kClockPhases; ++k)
      atomicAdd(&walk_clocks[k], reinterpret_cast<unsigned long long*>(sm + 32)[k]);
#endif
}

cudaLaunchConfig_t walk_config(cudaLaunchAttribute* attr, int cluster,
                               int n_clusters, int smem, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * n_clusters);
  cfg.blockDim = dim3(kWalkThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TW>
int walk_clusters(int cluster, int smem, int* out) {
  const void* kern = reinterpret_cast<const void*>(&dense_walk_kernel<TW>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = walk_config(attr, cluster, 1, smem, 0);
  err = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  return static_cast<int>(err);
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of `rows` rows of `row_bytes` bytes, boxes of 64 rows x
// `box_bytes` bytes under the swizzle of that width (128 or 32).
bool encode_rows(CUtensorMap* tm, const void* base, long long rows,
                 int row_bytes, int elem_bytes, int box_bytes) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes / elem_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes / elem_bytes),
                             static_cast<cuuint32_t>(kWalkRows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(tm,
            elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TW>
int walk_epoch(WalkArgs& a, const void* s, const void* w, int cluster,
               int n_clusters, int smem, cudaStream_t stream) {
  if (walk_layout(a.tv, a.lc, sizeof(TW), cluster).total != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)a.n_gu * a.n_gvp * a.tu;
  if (!encode_rows(&a.tm_s, s, rows, a.tv * 2, 2, 128) ||
      !encode_rows(&a.tm_w, w, rows, a.tv * (int)sizeof(TW), sizeof(TW), 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode_rows(&a.tm_ph, a.shadow, (long long)a.n_gvp * a.tv, a.lc * 2, 2,
                   32))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = reinterpret_cast<const void*>(&dense_walk_kernel<TW>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      walk_config(attr, cluster, n_clusters, smem, stream);
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, kern, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// One dense-cell epoch, in place on theta/phi, launched on `stream`.
// s_code: 0 = f32, 1 = bf16 (also the working type of E and the copies);
// w_code: 0 = f32, 1 = bf16, 2 = int8. Returns 0 or the CUDA error code.
extern "C" int tmf_dense_epoch(void* theta, void* phi, const void* s,
                               const void* w, const void* ku, const void* kv,
                               void* e_buf, void* th_snap, void* ph_snap,
                               int n_gu, int n_gvp, int tu, int tv, int lanes,
                               int dim, int s_code, int w_code, float eta,
                               float lam, float gb, float cap, int saturate,
                               void* stream) {
  float* th = static_cast<float*>(theta);
  float* ph = static_cast<float*>(phi);
  const float* k_u = static_cast<const float*>(ku);
  const float* k_v = static_cast<const float*>(kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TMF_RUN(TS, TW)                                                        \
  return run_epoch<TS, TW>(th, ph, s, w, k_u, k_v, e_buf, th_snap, ph_snap,    \
                           n_gu, n_gvp, tu, tv, lanes, dim, eta, lam, gb, cap, \
                           saturate, st)
  if (s_code == 0 && w_code == 0) TMF_RUN(float, float);
  if (s_code == 0 && w_code == 2) TMF_RUN(float, int8_t);
  if (s_code == 1 && w_code == 1) TMF_RUN(__nv_bfloat16, __nv_bfloat16);
  if (s_code == 1 && w_code == 2) TMF_RUN(__nv_bfloat16, int8_t);
#undef TMF_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most clusters of the wavefront walk the card keeps resident at once,
// into *out. w_code as below; smem from walk_layout. Returns 0 or the CUDA
// error code.
extern "C" int tmf_dense_walk_clusters(int w_code, int cluster, int smem,
                                       int* out) {
  if (w_code == 1) return walk_clusters<__nv_bfloat16>(cluster, smem, out);
  if (w_code == 2) return walk_clusters<int8_t>(cluster, smem, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef TMF_WALK_CLOCKS
// The diagnostic build's per-phase clock sums since the last call into out
// (kClockPhases u64), then zeroed. Returns 0 or the CUDA error code.
extern "C" int tmf_dense_walk_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, walk_clocks, sizeof(walk_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[kClockPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(walk_clocks, zero, sizeof(zero)));
}
#endif

// One dense-cell epoch on the wavefront walk, in place on theta/phi (bf16
// working type), launched on `stream` as n_clusters clusters of `cluster`
// blocks. counters: n_gvp ready counters, then the ticket counter; their
// values at the launch are ready_base and ticket_base (numbered across
// epochs by the caller). shadow: (n_gvp tv) x lc bf16 scratch where phi is
// handed on. lc: the lanes on chip, dim + 2 rounded up to 16.
extern "C" int tmf_dense_walk_epoch(
    void* theta, void* phi, const void* s, const void* w, const void* ku,
    const void* kv, void* counters, void* shadow, int n_gu, int n_gvp, int tu,
    int tv, int lanes, int dim, int lc, int w_code, int cluster,
    int n_clusters, int smem, unsigned ticket_base, unsigned ready_base,
    float eta, float lam, float gb, float cap, int saturate, void* stream) {
  WalkArgs a;
  a.theta = static_cast<float*>(theta);
  a.phi = static_cast<float*>(phi);
  a.ku = static_cast<const float*>(ku);
  a.kv = static_cast<const float*>(kv);
  a.ready = static_cast<unsigned*>(counters);
  a.ticket = a.ready + n_gvp;
  a.shadow = static_cast<__nv_bfloat16*>(shadow);
  a.n_gu = n_gu;
  a.n_gvp = n_gvp;
  a.tu = tu;
  a.tv = tv;
  a.lanes = lanes;
  a.dim = dim;
  a.lc = lc;
  a.ticket_base = ticket_base;
  a.ready_base = ready_base;
  a.eta = eta;
  a.ln_decay = logf(1.f - eta * lam);
  a.cap = cap;
  a.gb = gb;
  a.saturate = saturate;
  if (lc % 16 || lc > kMaxLC || lc < dim + 2 || tv % 128 || tv > 256 ||
      tu > kMaxCluster * kWalkRows ||
      cluster != (tu + kWalkRows - 1) / kWalkRows || n_clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_code == 1)
    return walk_epoch<__nv_bfloat16>(a, s, w, cluster, n_clusters, smem, st);
  if (w_code == 2)
    return walk_epoch<int8_t>(a, s, w, cluster, n_clusters, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
