// Free-column SGD epoch for Hopper (sm_90a).
//
// Replaces tpu_mf/ops/pallas_sgd_free.py:_free_kernel. The TPU kernel keeps
// both tables resident in VMEM, streams the ids as byte planes and gathers
// and scatters with one-hot matrix products; that is layout. What it
// computes, over the free-column plans of ops/sgd_free.py, is below.
//
// A plan batch holds 8 sub-batch columns of rating slots, and every column
// has its own user tile gu[i][k] and item tile gv[i][k] (tiles of 128 rows
// in the plans the runner builds). Columns run in plan order. Rows are the
// fused homogeneous rows of ops/rows.py (theta = [fac | bu | 1 | cnt],
// phi = [fac | 1 | bv | cnt]), so per rating
//
//     pred = t . p + gb,   err = eta * w * (r - pred)
//     dtheta[u] += err * p,   dphi[v] += err * t,   cnt lane (dim + 2) += w
//
// Windows. Both sides defer alike: user deltas sum over a window of
// wu = 8 / groups_u columns, item deltas over wv = 8 / groups_v columns,
// and at a window's end each tile applies at the last real column of the
// window that touches it (the walk's flags, ops/tile_walk.py:
// tile_apply_flags on each side). Every column reads both tables as they
// stood at the start of its windows, so the columns between two window
// ends of either side (min(wu, wv) of them) are independent: they run as
// one "window step". At 8 groups a window is one column and every column
// applies. At an apply a row touched k times becomes
//
//     row * (1 + keep * (exp(k ln(1 - eta lam)) - 1)) + keep * d * s,
//     s = min(1, cap / max(k, 1)) when saturating, else 1,
//
// with keep = lane <= dim (theta) or lane < dim | lane == dim + 1 (phi).
// Rows untouched in the window (k = 0) are left alone, which is the same
// result. Two columns of one step may share a tile: their atomics land in
// the same scratch rows, and the count lane carries k for both. Atomics
// sum in no fixed order, so the kernel matches its plain version
// (ops/sgd_free.py: free_epoch_reference) to a tolerance.
//
// Rounding follows the TPU kernel in the bf16 working type: rows are rounded
// to bf16 before the gather, t*p before the f32 row sum when mxu_pred is
// on, and the scatter operands err*p and err*t; every sum is f32. The f32
// working type rounds nothing.
//
// The tile walk (free_walk_kernel, tile_walk.cuh; ops/sgd_free.py:
// free_epoch launches it) runs the window steps as units: runs of real
// columns on one user tile. The plan deals its columns in cell order, user
// tile first, so each user tile is one unit (546 at ML-10M, ~84 columns
// each, one per item tile in order), and unit k can take item tile j once
// unit k - 1 has released it: a wavefront ~630 steps deep in place of
// 46,088 steps one after another. Each unit runs on one thread-block
// cluster, its user deltas in the cluster's dtheta slice, its item deltas
// in acc_v; applies follow the walk's flags on both sides (the real
// columns' last touch of a tile in its window), and a unit releases an
// item tile after its last touch of it, also where a later unit's column in
// the same window holds the apply. Rows and deltas change between window
// steps on other SMs, so they are read through L2 (ld.global.cg). The
// walk's chain is short beside its windows, so the clusters the card holds
// at once bound it as much as the chain does: ops/tile_walk.py:
// free_cluster_size picks the cluster size.
//
// What bounds it on the H100. Per rating two row reads and 2 * (dim + 3)
// atomic adds: at ML-10M shape (dim 64) a few GB an epoch, milliseconds at
// L2 rates. But the stand-in's window duplicates keep 8 groups a side at
// every eta from 0.02 to 0.005: an epoch is ~46k column steps of 256 slots,
// each with an apply of two tiles. Latency bounds the walk: the round trips
// of row reads, atomics and two cluster barriers of each step of a
// cluster's share of the units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tile_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;  // warps per block
// A slot, and an applied row, runs on half a warp: two at once a warp,
// each with kHalfCached chunks of 16 lanes in registers (dim <= 93 in one
// trip).
constexpr int kHalf = 16, kHalfCached = 6;

template <bool kBF16>
__device__ __forceinline__ float to_work(float x) {
  if constexpr (kBF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// Rows and deltas change between window steps on other SMs: read them from
// L2.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

struct FreeArgs {
  float* theta; float* phi; const int* u; const int* v; const float* r;
  const float* w;
  const int* ap_u;  // the walk's apply flags of the real columns, per side
  const int* ap_v;
  float* acc_v;
  int sub, tile_u, tile_v, lanes, dim, wu, wv, saturate;
  float eta, gb, cap, ln_decay;
};

// One rating slot of the plan: weight, rating, tile-local user row and
// global item row.
struct Slot {
  float w, r;
  long long urow, vrow;
};

// One slot on half a warp (hl: the lane's index in its half; `live`: a
// real slot, else the lanes only join the reduction's shuffles): gather
// both rows, predict, scatter the deltas; the first kHalfCached 16-lane
// chunks of both rows stay in registers.
template <bool kBF16, bool kMxuPred>
__device__ __forceinline__ void step_half(const float* tr, const float* pr,
                                          float* du, float* dv, bool live,
                                          float w, float r, int dim,
                                          float eta, float gb, int hl) {
  const int n = dim + 2;  // lanes >= dim + 2 are zero in both rows
  float tc[kHalfCached], pc[kHalfCached];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < kHalfCached; ++j) {
    const int l = hl + kHalf * j;
    tc[j] = live && l < n ? to_work<kBF16>(ld(tr + l)) : 0.f;
    pc[j] = live && l < n ? to_work<kBF16>(ld(pr + l)) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kHalfCached; ++j)
    part += kMxuPred ? to_work<kBF16>(tc[j] * pc[j]) : tc[j] * pc[j];
  for (int l = hl + kHalf * kHalfCached; live && l < n; l += kHalf) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    part += kMxuPred ? to_work<kBF16>(t * p) : t * p;
  }
#pragma unroll
  for (int o = kHalf / 2; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  if (!live) return;
  const float err = (eta * w) * (r - (part + gb));
#pragma unroll
  for (int j = 0; j < kHalfCached; ++j) {
    const int l = hl + kHalf * j;
    if (l >= n) break;
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * pc[j]));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * tc[j]));
  }
  for (int l = hl + kHalf * kHalfCached; l < n; l += kHalf) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * p));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * t));
  }
  if (hl == 0) {
    atomicAdd(du + dim + 2, w);
    atomicAdd(dv + dim + 2, w);
  }
}

// One applied row on half a warp (`live`: a row to apply): decay it and
// add its window delta (saturated), then clear the delta. The count and
// the first kHalfCached chunks arrive in one round trip.
__device__ __forceinline__ void apply_half(float* tr, float* dr, bool live,
                                           bool user, int dim, float ln_decay,
                                           float cap, int saturate, int hl) {
  const int n = dim + 3;
  const float k = live ? ld(dr + dim + 2) : 0.f;
  float dc[kHalfCached], rc[kHalfCached];
#pragma unroll
  for (int j = 0; j < kHalfCached; ++j) {
    const int l = hl + kHalf * j;
    dc[j] = live && l < n ? ld(dr + l) : 0.f;
    rc[j] = live && l < n ? ld(tr + l) : 0.f;
  }
  __syncwarp();  // every lane has read k before the lane at dim + 2 clears it
  if (k == 0.f) return;  // untouched in this window, or no row
  const float dec = expf(k * ln_decay);
  const float sat = saturate ? fminf(1.f, cap / fmaxf(k, 1.f)) : 1.f;
#pragma unroll
  for (int j = 0; j < kHalfCached; ++j) {
    const int l = hl + kHalf * j;
    if (l >= n) break;
    const bool keep = user ? l <= dim : (l < dim || l == dim + 1);
    if (keep) tr[l] = rc[j] * (1.f + (dec - 1.f)) + (saturate ? dc[j] * sat : dc[j]);
    dr[l] = 0.f;
  }
  for (int l = hl + kHalf * kHalfCached; l < n; l += kHalf) {
    const bool keep = user ? l <= dim : (l < dim || l == dim + 1);
    if (keep) {
      float dl = ld(dr + l);
      if (saturate) dl = dl * sat;
      tr[l] = ld(tr + l) * (1.f + (dec - 1.f)) + dl;
    }
    dr[l] = 0.f;
  }
}

// A barrier of the cluster's blocks that orders their stores and atomics
// before what follows (one block: its own barrier).
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl, int cs) {
  if (cs == 1)
    __syncthreads();
  else
    cl.sync();
}

// The tile walk (tile_walk.cuh, ops/tile_walk.py): the epoch's window
// steps, each unit (the run of real columns on one user tile) on one
// cluster of C blocks. Per window step of `step` columns, [lo, hi) of the
// unit's: each block's threads wait on the item tiles the unit touches
// first in the step; the cluster's warps scatter the step's real slots
// (user deltas into the cluster's dtheta slice, item deltas into acc_v),
// two at once a warp, each warp loading its next two before it works on
// these; a cluster barrier; where the step holds an apply flag (a.ap_u,
// a.ap_v: the walk's flags of the real columns), the applies of the unit's
// user tile and of the flagged item tiles, two rows at once a warp, and
// another cluster barrier; then the releases of the item tiles whose last
// touch by the unit lies in the step. The user tile is released when the
// unit ends, after its last apply. Rows and deltas stay in L2.
template <bool kBF16, bool kMxuPred>
__global__ void __launch_bounds__(32 * kWarps, 1)
free_walk_kernel(FreeArgs a, tile_walk::Walk w) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int s_unit;
  const int lane = threadIdx.x % 32;
  const int half = lane / kHalf, hl = lane % kHalf;
  const int cs = static_cast<int>(cl.num_blocks());
  const int n_cw = cs * kWarps;
  const int cw = static_cast<int>(cl.block_rank()) * kWarps + threadIdx.x / 32;
  const bool lead = cl.block_rank() == 0;
  const int lanes = a.lanes;
  float* dth = w.dtheta + (long long)(blockIdx.x / cs) * a.tile_u * lanes;
  const int step = a.wu < a.wv ? a.wu : a.wv;
  const int width = step * a.sub;
  TW_CLOCKS;
  TW_START();
  for (;;) {
    const int unit = tile_walk::next_unit(w, &s_unit);
    TW_TICK(0);
    if (unit >= w.n_units) break;
    const int c0 = __ldg(w.unit_c0 + unit), c1 = __ldg(w.unit_c1 + unit);
    const int gut = __ldg(w.unit_gu + unit);
    const float* trows = a.theta + (long long)gut * a.tile_u * lanes;
    if (threadIdx.x == 0)
      tile_walk::wait_tile(w.ready + w.n_gv + gut, w.gen,
                           __ldg(w.unit_wait + unit));
    for (int s = c0 - c0 % step; s < c1; s += step) {
      const int lo = s < c0 ? c0 : s, hi = s + step < c1 ? s + step : c1;
      bool any = false, th = false, ph = false;
      for (int c = lo; c < hi; ++c) {
        any |= __ldg(w.col_tile + c) >= 0;
        th |= __ldg(a.ap_u + c) != 0;
        ph |= __ldg(a.ap_v + c) != 0;
      }
      if (!any) continue;  // flags and releases lie on real columns only
      TW_COUNT();
      if (threadIdx.x < hi - lo) {
        const int c = lo + threadIdx.x;
        if (__ldg(w.col_tile + c) >= 0)
          tile_walk::wait_tile(w.ready + __ldg(w.col_tile + c), w.gen,
                               __ldg(w.col_wait + c));
      }
      __syncthreads();  // the acquires hold for the whole block
      TW_TICK(1);
      auto fetch = [&](int q) {
        const int col = s + q / a.sub;
        if (q >= width || col < lo || col >= hi) return Slot{};
        const int gv = __ldg(w.col_tile + col);
        if (gv < 0) return Slot{};
        const long long slot = (long long)col * a.sub + q % a.sub;
        return Slot{a.w[slot], a.r[slot], a.u[slot],
                    (long long)gv * a.tile_v + a.v[slot]};
      };
      Slot sl = fetch(2 * cw + half);
      for (int q = 2 * cw; q < width; q += 2 * n_cw) {
        const Slot next = fetch(q + 2 * n_cw + half);
        step_half<kBF16, kMxuPred>(
            trows + sl.urow * lanes, a.phi + sl.vrow * lanes,
            dth + sl.urow * lanes, a.acc_v + sl.vrow * lanes, sl.w != 0.f,
            sl.w, sl.r, a.dim, a.eta, a.gb, hl);
        sl = next;
      }
      TW_TICK(3);
      cluster_barrier(cl, cs);  // every block's deltas are in
      TW_TICK(4);
      if (th || ph) {
        const int rows_u = th ? a.tile_u : 0;
        const int total = rows_u + (ph ? (hi - lo) * a.tile_v : 0);
        for (int q0 = 2 * cw; q0 < total; q0 += 2 * n_cw) {
          const int q = q0 + half;
          const bool user = q < rows_u;
          bool live = q < total;
          float* tab = nullptr;
          float* d = nullptr;
          if (live && user) {
            tab = a.theta + ((long long)gut * a.tile_u + q) * lanes;
            d = dth + (long long)q * lanes;
          } else if (live) {
            const int qv = q - rows_u;
            const int col = lo + qv / a.tile_v;
            live = __ldg(a.ap_v + col) != 0;
            const long long off =
                ((long long)__ldg(w.col_tile + col) * a.tile_v +
                 qv % a.tile_v) * lanes;
            tab = a.phi + off;
            d = a.acc_v + off;
          }
          apply_half(tab, d, live, user, a.dim, a.ln_decay, a.cap,
                     a.saturate, hl);
        }
        TW_TICK(5);
        cluster_barrier(cl, cs);  // every block's applies are stored
        TW_TICK(6);
      }
      if (lead && threadIdx.x < hi - lo) {
        const int c = lo + threadIdx.x;
        if (__ldg(w.col_rel + c) > 0)
          tile_walk::release_tile(w.ready + __ldg(w.col_tile + c), w.gen,
                                  __ldg(w.col_rel + c));
      }
      TW_TICK(7);
    }
    if (lead && threadIdx.x == 0)
      tile_walk::release_tile(w.ready + w.n_gv + gut, w.gen,
                              __ldg(w.unit_wait + unit) + 1);
  }
  TW_FLUSH();
}

template <bool kBF16, bool kMxuPred>
int walk_clusters(int cluster, int* out) {
  return tile_walk::resident_clusters(free_walk_kernel<kBF16, kMxuPred>,
                                      cluster, 32 * kWarps, out);
}

bool valid_groups(int g) { return g == 1 || g == 2 || g == 4 || g == 8; }

}  // namespace

// One free-column epoch on the tile walk, in place on theta/phi, launched on
// `stream`. The plan arrays u, v, r, w are (nb, 8, sub), one column
// contiguous; ap_u and ap_v (nb, 8) are the walk's apply flags of the real
// columns (ops/tile_walk.py: tile_apply_flags) for groups_u and groups_v;
// acc_v (phi's shape) must be zero on entry and is zero again on return.
// `walk` is a tile_walk::WalkLaunch of the plan's walk (its user tiles and
// item tiles per column replace the plan's gu and gv; dtheta holds tile_u x
// lanes floats per cluster, zero on entry and on return). Returns 0 or the
// CUDA error code.
extern "C" int tmf_free_walk(void* theta, void* phi, const void* u,
                             const void* v, const void* r, const void* w,
                             const void* ap_u, const void* ap_v, void* acc_v,
                             int sub, int tile_u, int tile_v, int lanes,
                             int dim, int groups_u, int groups_v, int work,
                             int mxu_pred, int saturate, float eta, float lam,
                             float gb, float cap, const void* walk,
                             void* stream) {
  if (!valid_groups(groups_u) || !valid_groups(groups_v) || dim + 3 > lanes ||
      sub <= 0 || ap_u == nullptr || ap_v == nullptr || walk == nullptr ||
      (work != 0 && work != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  FreeArgs a{static_cast<float*>(theta), static_cast<float*>(phi),
             static_cast<const int*>(u), static_cast<const int*>(v),
             static_cast<const float*>(r), static_cast<const float*>(w),
             static_cast<const int*>(ap_u), static_cast<const int*>(ap_v),
             static_cast<float*>(acc_v), sub, tile_u, tile_v, lanes, dim,
             8 / groups_u, 8 / groups_v, saturate, eta, gb, cap,
             logf(1.f - eta * lam)};
  const auto& l = *static_cast<const tile_walk::WalkLaunch*>(walk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 32 * kWarps;
  if (work == 0)
    return tile_walk::launch(free_walk_kernel<false, false>, a, l, kThreads, st);
  if (mxu_pred)
    return tile_walk::launch(free_walk_kernel<true, true>, a, l, kThreads, st);
  return tile_walk::launch(free_walk_kernel<true, false>, a, l, kThreads, st);
}

// The most clusters of `cluster` blocks of the tile walk (work: 0 = f32,
// 1 = bf16; mxu_pred as tmf_free_walk's) the card keeps resident at once,
// into *out. Returns 0 or the CUDA error code.
extern "C" int tmf_free_walk_clusters(int work, int mxu_pred, int cluster,
                                      int* out) {
  if (work == 0) return walk_clusters<false, false>(cluster, out);
  if (mxu_pred) return walk_clusters<true, true>(cluster, out);
  return walk_clusters<true, false>(cluster, out);
}

#ifdef TMF_TILE_CLOCKS
// The diagnostic build's clock sums per phase since the last call.
extern "C" int tmf_free_walk_clocks(void* out) {
  return tile_walk::read_clocks(out);
}
#endif
