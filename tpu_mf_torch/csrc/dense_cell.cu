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
// theta_i as (i, c-1) left it and phi_c as (i-1, c) left it. Cells on one
// anti-diagonal i + c = d touch disjoint tiles, so running the diagonals one
// after another, with the cells of a diagonal in parallel, gives exactly the
// row-major result. The host loop below launches two kernels per diagonal:
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
// per run beside S/W. In the bf16 working type the 64x64 tile products run on
// the tensor cores (mma.sync m16n8k16, f32 accumulate) from double-buffered
// shared-memory stages filled with 16-byte vector loads; in f32 they run as
// CUDA-core FMAs, which keeps the f32 parity mode exact. Both epilogues park
// the accumulator tile in shared memory and walk whole rows in 8-element
// vectors (S, W and E; the table rows they update).
//
// What bounds it on the H100. Per cell the three products cost
// 2 * tu * tv * 3 * (dim + 2) flops against 3 bytes of S/W per rating slot
// (bf16 + int8), 2 * (dim + 2) = 132 flop per byte at dim 64, below the
// tensor cores' ~295 flop/byte balance, so the floor is the S/W stream
// (~0.7 ms per ML-10M epoch at 3.35 TB/s). This version is well above it:
// E makes a round trip through memory between the two launches of each
// diagonal, each diagonal costs two launches (628 per epoch at ML-10M), the
// lane tile past the factors computes 64 lanes for the two bias lanes, and
// anti-diagonals hold at most min(n_gu, n_gvp) cells (42 at ML-10M), so the
// first and last diagonals leave most of the 132 SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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
