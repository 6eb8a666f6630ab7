// Window-plan SGD epoch for Hopper (sm_90a).
//
// Replaces three TPU kernels that compute the same epoch over different
// plans:
//   tpu_mf/ops/pallas_sgd.py:_epoch_kernel (gen-1 cell plans,
//     ops/sgd_cells.py);
//   tpu_mf/ops/pallas_sgd_packed.py:_packed_epoch_kernel (lane-packed plans,
//     ops/sgd_packed.py: columns of B/8 slots);
//   tpu_mf/ops/pallas_sgd_slot.py:_slot_kernel (plain and delta-striped
//     slot plans, ops/sgd_slot.py: columns of sub * P slots, up to 4096).
// The TPU kernels' lane packing, slot-major tables, lane rolls and one-hot
// gathers are layout; each family's host code converts its plan to the
// window plan below, and the packed and slot families run with mxu_pred off
// (their TPU kernels sum unrounded products).
//
// A plan batch holds 8 sub-batch columns of rating slots; all columns of a
// batch share one user tile gu[i], and column k has its own item tile
// gv[i][k]. Batches run
// in plan order, and inside a batch the columns run in order. Rows are the
// fused homogeneous rows of ops/rows.py (theta = [fac | bu | 1 | cnt],
// phi = [fac | 1 | bv | cnt]), so per rating
//
//     pred = t . p + gb,   err = eta * w * (r - pred)
//     dtheta[u] += err * p,   dphi[v] += err * t,   cnt lane (dim + 2) += w
//
// Windows. User deltas sum over a theta group of 8 / theta_groups columns
// and apply at its end; item deltas sum over a phi group of 8 / phi_groups
// columns into a phi-shaped scratch `acc`, and each item tile applies at the
// last column of the group that touches it (the plan's `ap` flags). Every
// column reads theta and phi as they stood at the start of its groups, and
// nothing is written inside a group, so the columns between two group ends
// are independent: they run as one "window step". At an apply a row touched
// k times becomes
//
//     row * (1 + keep * (exp(k ln(1 - eta lam)) - 1)) + keep * d * s,
//     s = min(1, cap / max(k, 1)) when saturating, else 1,
//
// with keep = lane <= dim (theta) or lane < dim | lane == dim + 1 (phi): the
// one-lanes stay 1 and the count lane 0. Rows untouched in the window (k = 0)
// are left alone, which is the same result.
//
// Rounding follows the TPU kernel in the bf16 working type: rows are rounded
// to bf16 before the gather, t*p is rounded before the f32 row sum when the
// TPU does its prediction on the MXU (mxu_pred, at most 2 lane groups), and
// the scatter operands err*p and err*t are rounded; every sum is f32. The f32
// working type rounds nothing.
//
// Two walks run an epoch's window steps; ops/tile_walk.py:
// upload_window_walks routes each plan at each window width (the columns a
// step takes, min(8 / theta_groups, 8 / phi_groups)) by a model of both
// walks' time, and cell_epoch(walk=...) forces one:
//   - the grid walk (cell_epoch_kernel): one cooperative launch on one
//     block of 32 warps per SM. Each window step is a scatter phase (one
//     warp per rating slot: gather both rows, warp-reduce the prediction,
//     f32 atomics of the deltas into `dtheta`, one user tile, and `acc`),
//     a grid-wide sync, and where a group ends an apply phase (one warp per
//     row of the user tile and of the item tiles that apply) and a second
//     sync, one step after another;
//   - the tile walk (cell_walk_kernel, tile_walk.cuh): one launch of
//     thread-block clusters of 4, 8 or 16 blocks (the model's pick). Each
//     unit, a run of real columns on one user tile, runs its steps on one
//     cluster, its user deltas in the cluster's own slice, waiting only on
//     the ready counters of the tiles it shares with earlier units; so
//     units on disjoint tiles run side by side, the chain of steps shrinks
//     to the plan's critical path, and columns with no real slot (a plan's
//     padding) are dropped. It applies only the rows a group's slots
//     touched where the group holds fewer slots than the tile has rows.
// The routes: the gen-1 plans at ML-10M, the item-sharded plans at the
// Yahoo tiles (4096 x 2040) but for their whole-batch windows (1/1, where
// the walks tie), and the packed, slot, mega and streamed plans take the
// tile walk; a plan whose real columns visit a user tile in two units
// keeps the grid walk.
// Rows and deltas change between phases on other SMs, so both walks read
// them through L2 (ld.global.cg), never a stale L1 line. Atomics sum in no
// fixed order, so each walk matches the plain version to a tolerance.
//
// What bounds it on the H100. Per rating the work is two row reads and
// 2 * (dim + 3) atomic adds: ~0.5 KB of L2 traffic at dim 64, so a 9M-rating
// epoch moves a few GB, milliseconds at L2 rates. But at ML-10M shape the
// window duplicates of zipfy heads keep 8 groups a side (fully sequential)
// at every eta from 0.02 down to 0.0015: an epoch is ~1.4k batches x 8
// column steps, each only B/8 = 1024 slots wide. Latency bounds both walks:
// a step waits on its row reads and its atomics, an apply on its row reads
// and writes. On the grid walk each of the 10,920 steps also waits on two
// grid syncs: ~5.8 us a step at gen-1 dim 64, of which ~4.1 us is its
// skeleton (slot loads, the two syncs, the apply's count reads) and ~1.8 us
// the memory chain. A walk of the whole chain on one 16-block cluster (one
// cluster barrier a step, tiles in distributed shared memory) measured no
// faster: its step's work, issued by 16 SMs instead of 132, took back what
// the barrier saved. The tile walk spreads the steps over ~16-33 clusters:
// its steps take longer (~15-25 us on the chain, each with two cluster
// barriers and the waits on the counters), but a gen-1 epoch runs ~330 of
// them one after another instead of 10,920, and a Yahoo shard's 8/8
// sub-epoch ~276 instead of 6,144, ~5-8x faster (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tile_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;      // warps per block of the persistent kernel
constexpr int kCached = 4;      // 32-lane row chunks held in registers (dim <= 125)

template <bool kBF16>
__device__ __forceinline__ float to_work(float x) {
  if constexpr (kBF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// Rows and deltas change between phases on other SMs: read them from L2.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// One rating slot of the plan: weight, rating, tile-local ids, item tile.
struct Slot {
  float w, r;
  int u, v, gv;
};

__device__ __forceinline__ Slot load_slot(const int* u, const int* v,
                                          const float* r, const float* w,
                                          const int* gv, int col,
                                          long long slot) {
  return Slot{w[slot], r[slot], u[slot], v[slot], gv[col]};
}

// One slot, one warp: gather both rows, predict, scatter the deltas. The
// first kCached 32-lane chunks of both rows stay in registers.
template <bool kBF16, bool kMxuPred>
__device__ __forceinline__ void step_slot(
    const float* theta, const float* phi, const Slot& sl, int gut,
    float* dtheta, float* acc, int tile_u, int tile_v, int lanes, int dim,
    float eta, float gb, int lane) {
  const float wk = sl.w, rk = sl.r;
  const int ul = sl.u, vl = sl.v, gvt = sl.gv;
  if (wk == 0.f) return;  // padded slot (sentinel ids): contributes nothing
  const float* tr = theta + ((long long)gut * tile_u + ul) * lanes;
  const long long vrow = (long long)gvt * tile_v + vl;
  const float* pr = phi + vrow * lanes;
  const int n = dim + 2;  // lanes >= dim + 2 are zero in both rows
  float tc[kCached], pc[kCached];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int l = lane + 32 * j;
    tc[j] = l < n ? to_work<kBF16>(ld(tr + l)) : 0.f;
    pc[j] = l < n ? to_work<kBF16>(ld(pr + l)) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kCached; ++j)
    part += kMxuPred ? to_work<kBF16>(tc[j] * pc[j]) : tc[j] * pc[j];
  for (int l = lane + 32 * kCached; l < n; l += 32) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    part += kMxuPred ? to_work<kBF16>(t * p) : t * p;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  const float err = (eta * wk) * (rk - (part + gb));
  // each side's one-lane takes the other side's bias term, which its apply
  // never reads: skip those two adds
  float* du = dtheta + (long long)ul * lanes;
  float* dv = acc + vrow * lanes;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * pc[j]));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * tc[j]));
  }
  for (int l = lane + 32 * kCached; l < n; l += 32) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * p));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * t));
  }
  if (lane == 0) {  // counts: the count lane of both rows is zero, so w
    atomicAdd(du + dim + 2, wk);
    atomicAdd(dv + dim + 2, wk);
  }
}

// Decay one table row and add its window delta (saturated), then clear the
// delta. The count and the first kCached chunks arrive in one round trip.
__device__ __forceinline__ void apply_row(float* tr, float* dr, bool user,
                                          int dim, float ln_decay, float cap,
                                          int saturate, int lane) {
  const int n = dim + 3;
  const float k = ld(dr + dim + 2);
  float dc[kCached], rc[kCached];
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int l = lane + 32 * j;
    dc[j] = l < n ? ld(dr + l) : 0.f;
    rc[j] = l < n ? ld(tr + l) : 0.f;
  }
  __syncwarp();  // every lane has read k before lane (dim + 2) % 32 clears it
  if (k == 0.f) return;  // untouched in this window
  const float dec = expf(k * ln_decay);
  const float sat = saturate ? fminf(1.f, cap / fmaxf(k, 1.f)) : 1.f;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    const bool keep = user ? l <= dim : (l < dim || l == dim + 1);
    if (keep) tr[l] = rc[j] * (1.f + (dec - 1.f)) + (saturate ? dc[j] * sat : dc[j]);
    dr[l] = 0.f;
  }
  for (int l = lane + 32 * kCached; l < n; l += 32) {
    const bool keep = user ? l <= dim : (l < dim || l == dim + 1);
    if (keep) {
      float dl = ld(dr + l);
      if (saturate) dl = dl * sat;
      tr[l] = ld(tr + l) * (1.f + (dec - 1.f)) + dl;
    }
    dr[l] = 0.f;
  }
}

struct EpochArgs {
  float* theta; float* phi; const int* u; const int* v; const float* r;
  const float* w; const int* gu; const int* gv; const int* ap; float* dtheta;
  float* acc; int nb, sub, tile_u, tile_v, lanes, dim, tg_w, pg_w, saturate;
  float eta, gb, cap, ln_decay;
};

// One epoch in one cooperative launch: every window step is a scatter
// phase over all slots of its columns, a grid-wide sync, and (where a group
// ends) an apply phase over the rows of the tiles that apply, then a sync.
template <bool kBF16, bool kMxuPred>
__global__ void __launch_bounds__(32 * kWarps)
cell_epoch_kernel(EpochArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int n_warps = gridDim.x * kWarps;
  const int step = a.tg_w < a.pg_w ? a.tg_w : a.pg_w;
  // when a step has at most one slot per warp, each warp loads its slot of
  // the next step before the grid syncs, so a step waits only on its rows
  Slot next{};
  bool have_next = false;
  for (int i = 0; i < a.nb; ++i) {
    const int gut = a.gu[i];
    for (int c0 = 0; c0 < 8; c0 += step) {
      const int width = step * a.sub;
      for (int q = gwarp; q < width; q += n_warps) {
        const int col = i * 8 + c0 + q / a.sub;
        const Slot sl = have_next && q == gwarp
            ? next : load_slot(a.u, a.v, a.r, a.w, a.gv, col,
                               (long long)col * a.sub + q % a.sub);
        step_slot<kBF16, kMxuPred>(a.theta, a.phi, sl, gut, a.dtheta, a.acc,
                                   a.tile_u, a.tile_v, a.lanes, a.dim, a.eta,
                                   a.gb, lane);
      }
      const int ni = c0 + step < 8 ? i : i + 1;
      const int nc = c0 + step < 8 ? c0 + step : 0;
      have_next = ni < a.nb && gwarp < width && width <= n_warps;
      if (have_next) {
        const int col = ni * 8 + nc + gwarp / a.sub;
        next = load_slot(a.u, a.v, a.r, a.w, a.gv, col,
                         (long long)col * a.sub + gwarp % a.sub);
      }
      grid.sync();
      const int end = c0 + step;
      const int n_pc = end % a.pg_w == 0 ? a.pg_w : 0;
      const int n_th = end % a.tg_w == 0 ? 1 : 0;
      if (n_pc + n_th == 0) continue;
      const int total = n_pc * a.tile_v + n_th * a.tile_u;
      for (int q = gwarp; q < total; q += n_warps) {
        const bool user = q >= n_pc * a.tile_v;
        float* tab;
        float* d;
        if (user) {
          const int row = q - n_pc * a.tile_v;
          tab = a.theta + ((long long)gut * a.tile_u + row) * a.lanes;
          d = a.dtheta + (long long)row * a.lanes;
        } else {
          const int col = i * 8 + end - a.pg_w + q / a.tile_v;
          if (a.ap[col] == 0) continue;
          const long long off =
              ((long long)a.gv[col] * a.tile_v + q % a.tile_v) * a.lanes;
          tab = a.phi + off;
          d = a.acc + off;
        }
        apply_row(tab, d, user, a.dim, a.ln_decay, a.cap, a.saturate, lane);
      }
      grid.sync();
    }
  }
}

template <bool kBF16, bool kMxuPred>
int run_epoch(const EpochArgs& args, cudaStream_t stream) {
  auto kernel = cell_epoch_kernel<kBF16, kMxuPred>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * kWarps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  EpochArgs a = args;
  void* params[] = {&a};
  // one block per SM: 32 warps a block cover the 1024-slot steps of the
  // ML-10M geometry at one slot a warp (fewer blocks measured no faster)
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(sms),
                                    dim3(32 * kWarps), params, 0, stream);
  return static_cast<int>(err);
}

// ---- the tile walk ------------------------------------------------------------

constexpr int kWalkCached = 5;  // the tile walk's chunks: dim <= 157 in one trip

struct WalkArgs {
  EpochArgs e;
  int dstride;  // floats a row of a cluster's dtheta slice (dim + 3)
  int claim_u;  // user applies by the theta group's slots, not the tile's rows
  int claim_v;  // item applies by the phi group's slots, not the tiles' rows
};

// step_slot of the tile walk: the user deltas go to the cluster's slice,
// rows of dstride floats. A function of its own, as walk_apply is, so that
// the grid walk's code stays as it was measured (a mode of these functions
// that cost registers slowed every instantiation of a window-plan kernel).
template <bool kBF16, bool kMxuPred>
__device__ __forceinline__ void walk_slot(const EpochArgs& a, const Slot& sl,
                                          int gut, float* dth, int dstride,
                                          int lane) {
  const float wk = sl.w, rk = sl.r;
  if (wk == 0.f) return;  // padded slot (sentinel ids): contributes nothing
  const int dim = a.dim, lanes = a.lanes;
  const float* tr = a.theta + ((long long)gut * a.tile_u + sl.u) * lanes;
  const long long vrow = (long long)sl.gv * a.tile_v + sl.v;
  const float* pr = a.phi + vrow * lanes;
  const int n = dim + 2;  // lanes >= dim + 2 are zero in both rows
  float tc[kWalkCached], pc[kWalkCached];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < kWalkCached; ++j) {
    const int l = lane + 32 * j;
    tc[j] = l < n ? to_work<kBF16>(ld(tr + l)) : 0.f;
    pc[j] = l < n ? to_work<kBF16>(ld(pr + l)) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kWalkCached; ++j)
    part += kMxuPred ? to_work<kBF16>(tc[j] * pc[j]) : tc[j] * pc[j];
  for (int l = lane + 32 * kWalkCached; l < n; l += 32) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    part += kMxuPred ? to_work<kBF16>(t * p) : t * p;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  const float err = (a.eta * wk) * (rk - (part + a.gb));
  float* du = dth + (long long)sl.u * dstride;
  float* dv = a.acc + vrow * lanes;
#pragma unroll
  for (int j = 0; j < kWalkCached; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * pc[j]));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * tc[j]));
  }
  for (int l = lane + 32 * kWalkCached; l < n; l += 32) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * p));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * t));
  }
  if (lane == 0) {  // counts: the count lane of both rows is zero, so w
    atomicAdd(du + dim + 2, wk);
    atomicAdd(dv + dim + 2, wk);
  }
}

// apply_row of the tile walk. With `claim`, lane 0 takes the row's count
// with an atomic exchange (leaving 0), so of the warps handed one row (a
// warp per slot that touched it) the first applies it and the others find
// 0; without, the warp holds the row alone and reads the count. The
// count and the first kWalkCached chunks arrive in one round trip.
__device__ __forceinline__ void walk_apply(float* tr, float* dr, bool user,
                                           bool claim, const EpochArgs& a,
                                           int lane) {
  const int dim = a.dim, n = dim + 3;
  float k = 0.f;
  if (!claim)
    k = ld(dr + dim + 2);
  else if (lane == 0)
    k = atomicExch(dr + dim + 2, 0.f);
  float dc[kWalkCached], rc[kWalkCached];
#pragma unroll
  for (int j = 0; j < kWalkCached; ++j) {
    const int l = lane + 32 * j;
    dc[j] = l < n ? ld(dr + l) : 0.f;
    rc[j] = l < n ? ld(tr + l) : 0.f;
  }
  // every lane has the count before lane (dim + 2) % 32 clears it
  k = claim ? __shfl_sync(0xffffffffu, k, 0) : k;
  __syncwarp();
  if (k == 0.f) return;  // untouched in this window, or claimed
  const float dec = expf(k * a.ln_decay);
  const float sat = a.saturate ? fminf(1.f, a.cap / fmaxf(k, 1.f)) : 1.f;
#pragma unroll
  for (int j = 0; j < kWalkCached; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    const bool keep = user ? l <= dim : (l < dim || l == dim + 1);
    if (keep)
      tr[l] = rc[j] * (1.f + (dec - 1.f)) + (a.saturate ? dc[j] * sat : dc[j]);
    dr[l] = 0.f;
  }
  for (int l = lane + 32 * kWalkCached; l < n; l += 32) {
    const bool keep = user ? l <= dim : (l < dim || l == dim + 1);
    if (keep) {
      float dl = ld(dr + l);
      if (a.saturate) dl = dl * sat;
      tr[l] = ld(tr + l) * (1.f + (dec - 1.f)) + dl;
    }
    dr[l] = 0.f;
  }
}

// The tile walk (tile_walk.cuh, ops/tile_walk.py): the grid walk's window
// steps, each unit (a run of real columns on one user tile) on one cluster
// of C blocks, ordered by the tiles' ready counters instead of grid syncs.
// Per window step of `step` columns: each block's threads wait on the
// item tiles the unit touches first in the step; the cluster's warps
// scatter the step's real slots into the cluster's own dtheta slice and
// acc, each warp loading its next slot before it works on this one; at a
// theta group end (or the unit's last step) where the slice holds deltas,
// and at a phi group end with an apply flag (w.tap), a cluster barrier,
// the applies, another cluster barrier, and the releases of the item tiles
// whose last touch was applied. The user tile is released when the unit
// ends; every delta it added has then been applied, so the slice and acc
// are zero again. An apply covers the rows the group's slots touched,
// claimed slot by slot (walk_apply), where a group holds fewer slots than
// the tile has rows (the Yahoo geometry's 4096 x 2040 tiles), else every
// row of the tile, as the grid walk.
template <bool kBF16, bool kMxuPred>
__global__ void __launch_bounds__(32 * kWarps, 1)
cell_walk_kernel(WalkArgs wa, tile_walk::Walk w) {
  const EpochArgs& a = wa.e;
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int s_unit;
  const int lane = threadIdx.x % 32;
  const int cs = static_cast<int>(cl.num_blocks());
  const int n_cw = cs * kWarps;
  const int cw = static_cast<int>(cl.block_rank()) * kWarps + threadIdx.x / 32;
  const bool lead = cl.block_rank() == 0;
  float* dth = w.dtheta + (long long)(blockIdx.x / cs) * a.tile_u * wa.dstride;
  const int tg_w = a.tg_w, pg_w = a.pg_w, sub = a.sub;
  const int step = tg_w < pg_w ? tg_w : pg_w;
  TW_CLOCKS;
  TW_START();
  for (;;) {
    const int unit = tile_walk::next_unit(w, &s_unit);
    TW_TICK(0);
    if (unit >= w.n_units) break;
    const int c0 = __ldg(w.unit_c0 + unit), c1 = __ldg(w.unit_c1 + unit);
    const int gut = __ldg(w.unit_gu + unit);
    if (threadIdx.x == 0)
      tile_walk::wait_tile(w.ready + w.n_gv + gut, w.gen,
                           __ldg(w.unit_wait + unit));
    bool dirty = false;  // user deltas since the last theta apply
    for (int s = c0 - c0 % step; s < c1; s += step) {
      const int end = s + step;
      bool any = false;
      for (int c = s < c0 ? c0 : s; c < end && c < c1; ++c)
        any |= __ldg(w.col_tile + c) >= 0;
      const bool last = end >= c1;
      const bool th = (dirty || any) && (end % tg_w == 0 || last);
      const int t0 = (end - 1) / tg_w * tg_w, g0 = (end - 1) / pg_w * pg_w;
      bool ph = false;
      if (end % pg_w == 0 || last)
        for (int c = g0 < c0 ? c0 : g0; c < end && c < c1; ++c)
          ph |= __ldg(w.tap + c) != 0;
      if (!any && !th && !ph) continue;
      TW_COUNT();
      if (any) {
        if (threadIdx.x < step) {
          const int c = s + threadIdx.x;
          if (c >= c0 && c < c1 && __ldg(w.col_tile + c) >= 0)
            tile_walk::wait_tile(w.ready + __ldg(w.col_tile + c), w.gen,
                                 __ldg(w.col_wait + c));
        }
        __syncthreads();  // the acquires hold for the whole block
        TW_TICK(1);
        auto fetch = [&](int q) {
          const int col = s + q / sub;
          return q < step * sub && col >= c0 && col < c1 &&
                         __ldg(w.col_tile + col) >= 0
                     ? load_slot(a.u, a.v, a.r, a.w, a.gv, col,
                                 (long long)col * sub + q % sub)
                     : Slot{};
        };
        Slot sl = fetch(cw);
        for (int q = cw; q < step * sub; q += n_cw) {
          const Slot next = fetch(q + n_cw);
          walk_slot<kBF16, kMxuPred>(a, sl, gut, dth, wa.dstride, lane);
          sl = next;
        }
        dirty = true;
        TW_TICK(3);
      }
      if (!th && !ph) continue;
      cl.sync();  // every block's deltas are in
      TW_TICK(4);
      // the user tile's rows (or its group's slots), then the item tiles'
      const int n_u = !th ? 0 : wa.claim_u ? (end - t0) * sub : a.tile_u;
      const int n_v = !ph ? 0 : wa.claim_v ? (end - g0) * sub
                                           : (end - g0) * a.tile_v;
      for (int q = cw; q < n_u + n_v; q += n_cw) {
        const bool user = q < n_u;
        const int qq = user ? q : q - n_u;
        const bool claim = user ? wa.claim_u : wa.claim_v;
        const int col = claim ? (user ? t0 : g0) + qq / sub : g0 + qq / a.tile_v;
        int row = qq;  // a row of the user tile, in rows mode
        if (claim) {
          if (col < c0 || col >= c1 || __ldg(w.col_tile + col) < 0) continue;
          const long long slot = (long long)col * sub + qq % sub;
          if (__ldg(a.w + slot) == 0.f) continue;
          row = __ldg((user ? a.u : a.v) + slot);
        } else if (!user) {
          if (col < c0 || col >= c1 || __ldg(w.tap + col) == 0) continue;
          row = qq % a.tile_v;
        }
        if (user) {
          walk_apply(a.theta + ((long long)gut * a.tile_u + row) * a.lanes,
                     dth + (long long)row * wa.dstride, true, claim, a, lane);
        } else {
          const long long off =
              ((long long)__ldg(w.col_tile + col) * a.tile_v + row) * a.lanes;
          walk_apply(a.phi + off, a.acc + off, false, claim, a, lane);
        }
      }
      if (th) dirty = false;
      TW_TICK(5);
      cl.sync();  // every block's applies are stored
      TW_TICK(6);
      if (lead && ph && threadIdx.x < pg_w) {
        const int c = g0 + threadIdx.x;
        if (c >= c0 && c < c1 && __ldg(w.col_rel + c) > 0)
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

bool valid_groups(int g) { return g == 1 || g == 2 || g == 4 || g == 8; }

}  // namespace

// One gen-1 epoch, in place on theta/phi, launched on `stream`. The plan
// arrays u, v, r, w are (nb, 8, sub), one column contiguous; gu (nb), gv and
// ap (nb, 8). dtheta (tile_u x lanes) and acc (phi's shape) must be zero on
// entry and are zero again on return. work: 0 = f32, 1 = bf16. Returns 0 or
// the CUDA error code.
extern "C" int tmf_cell_epoch(void* theta, void* phi, const void* u,
                              const void* v, const void* r, const void* w,
                              const void* gu, const void* gv, const void* ap,
                              void* dtheta, void* acc, int nb, int sub,
                              int tile_u, int tile_v, int lanes, int dim,
                              int theta_groups, int phi_groups, int work,
                              int mxu_pred, int saturate, float eta, float lam,
                              float gb, float cap, void* stream) {
  if (!valid_groups(theta_groups) || !valid_groups(phi_groups) ||
      dim + 3 > lanes || sub <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  EpochArgs a{static_cast<float*>(theta), static_cast<float*>(phi),
              static_cast<const int*>(u), static_cast<const int*>(v),
              static_cast<const float*>(r), static_cast<const float*>(w),
              static_cast<const int*>(gu), static_cast<const int*>(gv),
              static_cast<const int*>(ap), static_cast<float*>(dtheta),
              static_cast<float*>(acc), nb, sub, tile_u, tile_v, lanes, dim,
              8 / theta_groups, 8 / phi_groups, saturate, eta, gb, cap,
              logf(1.f - eta * lam)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (work == 0) return run_epoch<false, false>(a, st);
  if (mxu_pred) return run_epoch<true, true>(a, st);
  return run_epoch<true, false>(a, st);
}

// One epoch of the same plan on the tile walk: `walk` is a
// tile_walk::WalkLaunch whose units are the plan's, whose tap holds the
// real columns' apply flags for phi_groups and whose dtheta holds one
// tile_u x (dim + 3) slice per cluster, zero on entry and on return (gu,
// ap and the grid walk's dtheta are not read). acc (phi's shape) must be
// zero on entry and is zero again on return. The other arguments are
// tmf_cell_epoch's. Returns 0 or the CUDA error code.
extern "C" int tmf_cell_walk(void* theta, void* phi, const void* u,
                             const void* v, const void* r, const void* w,
                             const void* gv, void* acc, int nb, int sub,
                             int tile_u, int tile_v, int lanes, int dim,
                             int theta_groups, int phi_groups, int work,
                             int mxu_pred, int saturate, float eta, float lam,
                             float gb, float cap, const void* walk,
                             void* stream) {
  if (!valid_groups(theta_groups) || !valid_groups(phi_groups) ||
      dim + 3 > lanes || sub <= 0 || walk == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto& l = *static_cast<const tile_walk::WalkLaunch*>(walk);
  if (l.tap == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int tg_w = 8 / theta_groups, pg_w = 8 / phi_groups;
  WalkArgs a{{static_cast<float*>(theta), static_cast<float*>(phi),
              static_cast<const int*>(u), static_cast<const int*>(v),
              static_cast<const float*>(r), static_cast<const float*>(w),
              nullptr, static_cast<const int*>(gv), nullptr, nullptr,
              static_cast<float*>(acc), nb, sub, tile_u, tile_v, lanes, dim,
              tg_w, pg_w, saturate, eta, gb, cap, logf(1.f - eta * lam)},
             dim + 3, tg_w * sub < tile_u, sub < tile_v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 32 * kWarps;
  if (work == 0)
    return tile_walk::launch(cell_walk_kernel<false, false>, a, l, kThreads,
                             st);
  if (mxu_pred)
    return tile_walk::launch(cell_walk_kernel<true, true>, a, l, kThreads,
                             st);
  return tile_walk::launch(cell_walk_kernel<true, false>, a, l, kThreads, st);
}

// The most clusters of `cluster` blocks of the tile walk (work: 0 = f32,
// 1 = bf16; mxu_pred as tmf_cell_epoch's) the card keeps resident at once,
// into *out. Returns 0 or the CUDA error code.
extern "C" int tmf_cell_walk_clusters(int work, int mxu_pred, int cluster,
                                      int* out) {
  constexpr int kThreads = 32 * kWarps;
  if (work == 0)
    return tile_walk::resident_clusters(cell_walk_kernel<false, false>,
                                        cluster, kThreads, out);
  if (mxu_pred)
    return tile_walk::resident_clusters(cell_walk_kernel<true, true>,
                                        cluster, kThreads, out);
  return tile_walk::resident_clusters(cell_walk_kernel<true, false>, cluster,
                                      kThreads, out);
}

#ifdef TMF_TILE_CLOCKS
// The diagnostic build's clock sums per phase since the last call.
extern "C" int tmf_cell_walk_clocks(void* out) {
  return tile_walk::read_clocks(out);
}
#endif
