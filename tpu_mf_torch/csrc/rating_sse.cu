// Sum of squared errors of a rating set for Hopper (sm_90a).
//
// Replaces no TPU kernel: tpu_mf's calc_mse / predict (tpu_mf/models/mf.py)
// are plain jnp. It replaces the plain PyTorch chain of models/mf.py's
// calc_mse_reference on the card, which per chunk of rows copies the ids to
// int64, gathers theta[u] and phi[v] into new tensors, writes their product,
// reduces it, and reads the chunk's sum back to the host (0.5 GiB per table
// and chunk of 2^20 rows at dim 128). Here one launch computes
//
//     sse = sum_i (r_i - pred_i)^2,
//     pred_i = ((theta_u . phi_v + bu_u) + bv_v) + gb
//
// with predict's arithmetic: each product in the storage type (float32, or
// rounded to bf16 for bf16 tables), the dot product and the residual in
// float32 (no FMA contraction, no TF32, no bf16 operands for float32
// tables), each squared residual (float32) summed in float64.
//
// Bound. Bytes: each rating needs its ids and rating (8-16 B), and each
// table row it touches has to be read once. For the DP-SGLD train set at
// ML-10M, dim 128 (9M ratings, 69,878 + 10,677 rows) that is ~150 MB, ~45 us
// at 3.35 TB/s; the float32 dot products (~2.3 GFLOP) take ~35 us at 67
// TFLOP/s. The rows are gathered in rating order, so a row is read again at
// every rating that touches it: 1 KiB per rating at dim 128 from L2, where
// the ML-10M tables (~41 MB) fit and Yahoo's do not.
//
// Design. Blocks of 8 warps, 3 resident per SM, the grid sized to fill the
// card (or fewer blocks for a small set). A warp takes 32 ratings at a time
// with one coalesced load of their ids and ratings per lane, and broadcasts
// them by shuffle. A row is read in 16-byte lane loads where the row, its
// pointer and its stride allow (one float4 per lane at dim 128 float32),
// else element by element; a group of G lanes (the least power of two that
// covers the row's loads, at most 32) reads one rating's rows, so a warp
// reads 32 / G ratings at once. Each lane keeps kDepth = 3 ratings' row
// loads in flight before it uses any, to hide the gathers' latency (9M
// uniform ratings at ML-10M's shape, dim 128, NVIDIA H100 80GB HBM3 at 700
// W: depth 3 at 3 blocks an SM 1.49 ms, ~6 TB/s of rows from L2; 2 at 4
// blocks 1.52, 4 at 2 1.65, 6 at 2 1.60, 8 at 2 2.6 with spills). The group's
// partial dot products are summed by xor shuffles. Row strides and bias
// strides are the caller's: trimmed views of the fused tables (ops/rows.py
// split_params) are read in place. Ids are int32 or int64, read in place.
//
// Determinism: a rating's terms go to a fixed lane, in a fixed order; the
// warps of a block and then the blocks' partials (in a fixed buffer) are
// summed in a fixed order by the last block, which takes it by an integer
// ticket. No float atomics: two launches on the same inputs give the same
// bits. Ids out of range are not read; they set a flag the caller raises on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 3;         // resident an SM: <= 80 registers
constexpr int kDepth = 3;               // ratings a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// a float32 product as predict takes it: rounded to float32, or to bf16
template <typename T>
__device__ __forceinline__ float product(float a, float b);

template <>
__device__ __forceinline__ float product<float>(float a, float b) {
  return __fmul_rn(a, b);
}

template <>
__device__ __forceinline__ float product<__nv_bfloat16>(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, b)));
}

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One lane's load of a row: 16 bytes (VEC) or one element.
template <typename T, bool VEC>
struct Chunk;

template <typename T>
struct Chunk<T, true> {
  uint4 x;
  __device__ __forceinline__ void load(const T* row, int c) {
    x = __ldg(reinterpret_cast<const uint4*>(row) + c);
  }
};

template <typename T>
struct Chunk<T, false> {
  T x;
  __device__ __forceinline__ void load(const T* row, int c) {
    x = __ldg(row + c);
  }
};

// the chunk's products summed in order, in float32
__device__ __forceinline__ float chunk_dot(const Chunk<float, true>& a,
                                           const Chunk<float, true>& b) {
  float s = product<float>(__uint_as_float(a.x.x), __uint_as_float(b.x.x));
  s = __fadd_rn(s, product<float>(__uint_as_float(a.x.y),
                                  __uint_as_float(b.x.y)));
  s = __fadd_rn(s, product<float>(__uint_as_float(a.x.z),
                                  __uint_as_float(b.x.z)));
  return __fadd_rn(s, product<float>(__uint_as_float(a.x.w),
                                     __uint_as_float(b.x.w)));
}

__device__ __forceinline__ float chunk_dot(
    const Chunk<__nv_bfloat16, true>& a, const Chunk<__nv_bfloat16, true>& b) {
  const uint32_t wa[4] = {a.x.x, a.x.y, a.x.z, a.x.w};
  const uint32_t wb[4] = {b.x.x, b.x.y, b.x.z, b.x.w};
  float s = product<__nv_bfloat16>(bf16_lo(wa[0]), bf16_lo(wb[0]));
  s = __fadd_rn(s, product<__nv_bfloat16>(bf16_hi(wa[0]), bf16_hi(wb[0])));
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    s = __fadd_rn(s, product<__nv_bfloat16>(bf16_lo(wa[k]), bf16_lo(wb[k])));
    s = __fadd_rn(s, product<__nv_bfloat16>(bf16_hi(wa[k]), bf16_hi(wb[k])));
  }
  return s;
}

template <typename T>
__device__ __forceinline__ float chunk_dot(const Chunk<T, false>& a,
                                           const Chunk<T, false>& b) {
  return product<T>(to_float(a.x), to_float(b.x));
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

// The block's sum of `x` over its threads, in a fixed order, to thread 0.
__device__ __forceinline__ double block_sum(double x, double* smem) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += smem[w];
  }
  __syncthreads();
  return s;
}

struct Args {
  const void* theta;
  const void* phi;
  const void* bu;
  const void* bv;
  const float* gb;
  const void* u;
  const void* v;
  const float* r;
  long long n, nu, nv;
  long long ld_u, ld_v, s_bu, s_bv;  // row strides, bias strides (elements)
  int nchunks;                       // loads a row takes
  int group_log2;                    // lanes a rating: 1 << group_log2
  double* partials;                  // gridDim.x
  unsigned* flags;                   // [ticket, bad id], zero at the launch
  double* out;                       // [sse, bad id]
};

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    rating_sse_kernel(Args a) {
  __shared__ double smem[kWarps];
  __shared__ bool last;
  const T* theta = static_cast<const T*>(a.theta);
  const T* phi = static_cast<const T*>(a.phi);
  const T* bu = static_cast<const T*>(a.bu);
  const T* bv = static_cast<const T*>(a.bv);
  const I* us = static_cast<const I*>(a.u);
  const I* vs = static_cast<const I*>(a.v);
  const int lane = threadIdx.x & 31;
  const int G = 1 << a.group_log2;   // lanes a rating
  const int g = lane & (G - 1);      // this lane's place in its group
  const int gi = lane >> a.group_log2;
  const int R = 32 >> a.group_log2;  // ratings a warp reads at once
  const float gb = __ldg(a.gb);
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  double acc = 0.0;
  bool bad = false;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
           32;
       base < a.n; base += nwarps * 32) {
    // this lane's rating of the 32: ids in range (the caller keeps nu and
    // nv below 2^31) or not read
    int ul = 0, vl = 0, okl = 0;
    float rl = 0.f;
    if (base + lane < a.n) {
      const long long x = us[base + lane], y = vs[base + lane];
      okl = x >= 0 && x < a.nu && y >= 0 && y < a.nv;
      bad |= !okl;
      if (okl) {
        ul = static_cast<int>(x);
        vl = static_cast<int>(y);
      }
      rl = a.r[base + lane];
    }
    // round q reads rating q * R + gi of the 32; G rounds cover them
    for (int q0 = 0; q0 < G; q0 += kDepth) {
      int uu[kDepth], vv[kDepth];
      float rr[kDepth], s[kDepth], bias_u[kDepth], bias_v[kDepth];
      bool ok[kDepth];
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int j = ((q0 + k) * R + gi) & 31;
        uu[k] = __shfl_sync(kFull, ul, j);
        vv[k] = __shfl_sync(kFull, vl, j);
        rr[k] = __shfl_sync(kFull, rl, j);
        ok[k] = __shfl_sync(kFull, okl, j) && q0 + k < G;
        s[k] = bias_u[k] = bias_v[k] = 0.f;
        if (ok[k] && g == 0) {
          bias_u[k] = to_float(__ldg(bu + uu[k] * a.s_bu));
          bias_v[k] = to_float(__ldg(bv + vv[k] * a.s_bv));
        }
      }
      for (int c = g; c < a.nchunks; c += G) {
        Chunk<T, VEC> ta[kDepth], pb[kDepth];
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          if (ok[k]) {
            ta[k].load(theta + uu[k] * a.ld_u, c);
            pb[k].load(phi + vv[k] * a.ld_v, c);
          }
        }
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          if (ok[k]) s[k] = __fadd_rn(s[k], chunk_dot(ta[k], pb[k]));
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kDepth; ++k)
          s[k] = __fadd_rn(s[k], __shfl_xor_sync(kFull, s[k], off));
      }
      if (g == 0) {
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          if (ok[k]) {
            const float pred =
                __fadd_rn(__fadd_rn(__fadd_rn(s[k], bias_u[k]), bias_v[k]), gb);
            const float e = __fsub_rn(rr[k], pred);
            acc += static_cast<double>(__fmul_rn(e, e));
          }
        }
      }
    }
  }
  if (bad) atomicOr(a.flags + 1, 1u);
  const double total = block_sum(acc, smem);
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(a.flags, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double x = 0.0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads)
    x += __ldcg(a.partials + b);
  x = block_sum(x, smem);
  if (threadIdx.x == 0) {
    a.out[0] = x;
    a.out[1] = static_cast<double>(__ldcg(a.flags + 1));
  }
}

template <typename T, typename I>
cudaError_t launch(const Args& a, int vec, int grid, cudaStream_t st) {
  if (vec)
    rating_sse_kernel<T, I, true><<<grid, kThreads, 0, st>>>(a);
  else
    rating_sse_kernel<T, I, false><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The sum of squared errors of n ratings (u[i], v[i], r[i]) against the
// tables, into out[0] (float64 on the device), and into out[1] 1 if an id
// lay outside [0, nu) / [0, nv), else 0. theta / phi rows at strides ld_u /
// ld_v elements, bu / bv at strides s_bu / s_bv; gb one float32 on the
// device. t_code: 0 float32 tables, 1 bf16; i_code: 0 int32 ids, 1 int64.
// vec: rows are read in 16-byte loads (dim, pointers and strides allow it).
// Launched on `stream` as `grid` blocks of 256 threads (at most the length
// of `partials`); flags: 2 unsigned of scratch, zeroed here. Returns 0 or
// the CUDA error code.
extern "C" int tmf_rating_sse(const void* theta, const void* phi,
                              const void* bu, const void* bv, const void* gb,
                              const void* u, const void* v, const void* r,
                              long long n, long long nu, long long nv,
                              long long ld_u, long long ld_v, long long s_bu,
                              long long s_bv, int nchunks, int group_log2,
                              int t_code, int i_code, int vec, int grid,
                              void* partials, void* flags, void* out,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{theta, phi, bu, bv, static_cast<const float*>(gb), u, v,
         static_cast<const float*>(r), n, nu, nv, ld_u, ld_v, s_bu, s_bv,
         nchunks, group_log2, static_cast<double*>(partials),
         static_cast<unsigned*>(flags), static_cast<double*>(out)};
  if (grid < 1 || group_log2 < 0 || group_log2 > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t_code == 0 && i_code == 0)
    err = launch<float, int32_t>(a, vec, grid, st);
  else if (t_code == 0 && i_code == 1)
    err = launch<float, int64_t>(a, vec, grid, st);
  else if (t_code == 1 && i_code == 0)
    err = launch<__nv_bfloat16, int32_t>(a, vec, grid, st);
  else if (t_code == 1 && i_code == 1)
    err = launch<__nv_bfloat16, int64_t>(a, vec, grid, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
