// AdaptReg segment of a window-plan epoch for Hopper (sm_90a).
//
// Replaces the two TPU AdaptReg kernels:
//   tpu_mf/ops/pallas_adreg.py:_adreg_kernel (gen-1 cell plans,
//     ops/adreg_cells.py);
//   tpu_mf/ops/pallas_adreg_slot.py:_slot_adreg_kernel (plain and striped
//     slot plans converted to window plans, ops/adreg_slot.py).
// Both compute the window-plan epoch of csrc/cell_sgd.cu (its header sets
// out the plan, the windows and the design) over one segment of a plan's
// batches, with the AdaptRegMF semantics (reference: src/admf.h:52-86):
//
//     pred = act(t . p + gb),   err = eta * w * (r - pred)
//     dtheta[u] += err * p,   dphi[v] += err * t,   cnt lane (dim + 2) += w
//
// act is the identity, or the logistic sigmoid with loss 1. At an apply a
// row touched k times in its window becomes, per kept lane l,
//
//     row_l * base_l^k + d_l,   base_l = 1 - eta * lam_l,
//
// lam_u on the user factor lanes and lam_bu on its bias lane (dim), lam_v
// and lam_bv on the item's (bias lane dim + 1); the one-lanes and the count
// lane are not kept. base^k = exp(k ln|base|), negated for a negative base
// and odd k: a learned lambda can push eta * lam past 1. There is no
// saturation, and t*p is summed unrounded (the TPU kernels round only the
// gathered rows and the scatter operands to the bf16 working type).
// Gen-1 AdaptReg runs at 8/8 groups with every apply flag set (a window is
// one column; both sides apply at every column); slot AdaptReg at the
// groups and apply flags its runner picks.
//
// One launch runs a segment, the plan batches [b0, b1). Between
// segments the runner takes a hypergradient step on the four learned
// lambdas on the device, so the kernel reads lam_u, lam_v, lam_bu, lam_bv
// from device memory and computes the bases itself: a segment never waits
// for the host.
//
// Why a source of its own: as a compile-time mode of csrc/cell_sgd.cu the
// MF instantiations compiled to other code (60-62 registers where they had
// 64) and their epochs measured 2-4% slower on an H100 80GB HBM3 at
// 700 W, so the MF kernel keeps its source and this file repeats the
// window machinery, specialized: no saturation, no rounded prediction,
// per-lane decay, the activation, a batch range, lambdas on the device.
//
// The tile walk runs a segment's window steps (adreg_walk_kernel,
// tile_walk.cuh, ops/tile_walk.py): one launch of thread-block clusters;
// each unit (a run of real columns on one user tile) runs its steps on one
// cluster, waiting only on the ready counters of the tiles it shares with
// earlier units, so units on disjoint tiles run side by side and the steps'
// chain shrinks to the plan's critical path.
//
// What bounds it on the H100: the chain of window steps, each waiting on
// its row reads and atomics. Per applied row it adds two exps; the logs of
// the four bases are taken once per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tile_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;  // warps per block
constexpr int kCached = 5;  // 32-lane row chunks held in registers (dim <= 157)

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
template <bool kBF16>
__device__ __forceinline__ void step_slot(
    const float* theta, const float* phi, const Slot& sl, int gut,
    float* dtheta, float* acc, int tile_u, int tile_v, int lanes, int dim,
    float eta, float gb, int loss, int lane) {
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
  for (int j = 0; j < kCached; ++j) part += tc[j] * pc[j];
  for (int l = lane + 32 * kCached; l < n; l += 32)
    part += to_work<kBF16>(ld(tr + l)) * to_work<kBF16>(ld(pr + l));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  float pred = part + gb;
  if (loss) pred = 1.f / (1.f + expf(-pred));
  const float err = (eta * wk) * (rk - pred);
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

// The decay of one side: ln|base| and the sign of base, for the factor
// lanes and for the bias lane.
struct LaneDecay {
  float ln_fac, ln_bias;
  bool neg_fac, neg_bias;
};

__device__ __forceinline__ LaneDecay lane_decay(float eta, float lam_fac,
                                                float lam_bias) {
  // 1 - eta * lam rounded as the TPU kernel rounds it (no fused multiply-add)
  const float bf = __fsub_rn(1.f, __fmul_rn(eta, lam_fac));
  const float bb = __fsub_rn(1.f, __fmul_rn(eta, lam_bias));
  return LaneDecay{logf(fmaxf(fabsf(bf), 1e-30f)),
                   logf(fmaxf(fabsf(bb), 1e-30f)), bf < 0.f, bb < 0.f};
}

// Decay one table row per lane and add its window delta, then clear the
// delta. The count and the first kCached chunks arrive in one round trip.
__device__ __forceinline__ void apply_row(float* tr, float* dr, bool user,
                                          int dim, LaneDecay ad, int lane) {
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
  const bool odd = fmodf(k, 2.f) == 1.f;
  float mf = expf(k * ad.ln_fac), mb = expf(k * ad.ln_bias);
  if (ad.neg_fac && odd) mf = -mf;
  if (ad.neg_bias && odd) mb = -mb;
  const int bias = user ? dim : dim + 1;
#pragma unroll
  for (int j = 0; j < kCached; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    if (l < dim || l == bias) tr[l] = rc[j] * (l < dim ? mf : mb) + dc[j];
    dr[l] = 0.f;
  }
  for (int l = lane + 32 * kCached; l < n; l += 32) {
    if (l < dim || l == bias)
      tr[l] = ld(tr + l) * (l < dim ? mf : mb) + ld(dr + l);
    dr[l] = 0.f;
  }
}

struct SegmentArgs {
  float* theta; float* phi; const int* u; const int* v; const float* r;
  const float* w; const int* gv; float* acc;
  const float* lams;  // lam_u, lam_v, lam_bu, lam_bv on the device
  int sub, tile_u, tile_v, lanes, dim, tg_w, pg_w, loss;
  float eta, gb;
};

// The tile walk (tile_walk.cuh, ops/tile_walk.py): a segment's window
// steps, each unit (a run of real columns on one user tile) on one cluster
// of C blocks. Per window step of `step` columns: each block's threads wait
// on the item tiles the unit touches first in the step; the cluster's warps
// scatter the step's real slots, each warp loading its next slot before it
// works on this one; at a group end (or the unit's last step) a cluster
// barrier, the applies of the user tile (into the cluster's own dtheta
// slice) and of the item tiles flagged in w.tap, another cluster barrier,
// and the releases of the item tiles whose last touch was applied. The user
// tile is released when the unit ends. Rows and deltas stay in L2 (a
// revision that kept the unit's user tile in shared memory measured slower,
// PERF.md).
template <bool kBF16>
__global__ void __launch_bounds__(32 * kWarps, 1)
adreg_walk_kernel(SegmentArgs a, tile_walk::Walk w) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int s_unit;
  const int lane = threadIdx.x % 32;
  const int cs = static_cast<int>(cl.num_blocks());
  const int n_cw = cs * kWarps;
  const int cw = static_cast<int>(cl.block_rank()) * kWarps + threadIdx.x / 32;
  const bool lead = cl.block_rank() == 0;
  float* dth = w.dtheta + (long long)(blockIdx.x / cs) * a.tile_u * a.lanes;
  const int tg_w = a.tg_w, pg_w = a.pg_w;
  const int step = tg_w < pg_w ? tg_w : pg_w;
  const LaneDecay dec_u = lane_decay(a.eta, __ldg(a.lams + 0),
                                     __ldg(a.lams + 2));
  const LaneDecay dec_v = lane_decay(a.eta, __ldg(a.lams + 1),
                                     __ldg(a.lams + 3));
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
      const int g0 = end - (end % pg_w == 0 ? pg_w : end % pg_w);
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
          const int col = s + q / a.sub;
          return q < step * a.sub && col >= c0 && col < c1 &&
                         __ldg(w.col_tile + col) >= 0
                     ? load_slot(a.u, a.v, a.r, a.w, a.gv, col,
                                 (long long)col * a.sub + q % a.sub)
                     : Slot{};
        };
        Slot sl = fetch(cw);
        for (int q = cw; q < step * a.sub; q += n_cw) {
          const Slot next = fetch(q + n_cw);
          step_slot<kBF16>(a.theta, a.phi, sl, gut, dth, a.acc, a.tile_u,
                           a.tile_v, a.lanes, a.dim, a.eta, a.gb, a.loss,
                           lane);
          sl = next;
        }
        dirty = true;
        TW_TICK(3);
      }
      if (!th && !ph) continue;
      cl.sync();  // every block's deltas are in
      TW_TICK(4);
      const int n_pc = ph ? pg_w : 0, n_th = th ? 1 : 0;
      const int total = n_pc * a.tile_v + n_th * a.tile_u;
      for (int q = cw; q < total; q += n_cw) {
        const bool user = q >= n_pc * a.tile_v;
        float* tab;
        float* d;
        if (user) {
          const int row = q - n_pc * a.tile_v;
          tab = a.theta + ((long long)gut * a.tile_u + row) * a.lanes;
          d = dth + (long long)row * a.lanes;
        } else {
          const int col = g0 + q / a.tile_v;
          if (col < c0 || col >= c1 || __ldg(w.tap + col) == 0) continue;
          const long long off =
              ((long long)__ldg(w.col_tile + col) * a.tile_v + q % a.tile_v) *
              a.lanes;
          tab = a.phi + off;
          d = a.acc + off;
        }
        apply_row(tab, d, user, a.dim, user ? dec_u : dec_v, lane);
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

// One AdaptReg segment on the tile walk, in place on theta/phi, launched
// on `stream`. The plan arrays are csrc/cell_sgd.cu's: u, v, r, w
// (nb, 8, sub), one column contiguous; gv (nb, 8). lams holds lam_u, lam_v,
// lam_bu, lam_bv (float32, on the device). acc (phi's shape) must be zero
// on entry and is zero again on return. work: 0 = f32, 1 = bf16; loss: 0 =
// least squares, 1 = logistic. `walk` is a tile_walk::WalkLaunch of the
// segment's units (its dtheta slices zero on entry and on return; its tap
// the real columns' apply flags for phi_groups); a null walk or tap is
// refused. Returns 0 or the CUDA error code.
extern "C" int tmf_adreg_segment(void* theta, void* phi, const void* u,
                                 const void* v, const void* r, const void* w,
                                 const void* gv, void* acc, const void* lams,
                                 int sub, int tile_u, int tile_v, int lanes,
                                 int dim, int theta_groups, int phi_groups,
                                 int work, int loss, float eta, float gb,
                                 const void* walk, void* stream) {
  if (!valid_groups(theta_groups) || !valid_groups(phi_groups) ||
      dim + 3 > lanes || sub <= 0 || lams == nullptr || walk == nullptr ||
      (loss != 0 && loss != 1) || (work != 0 && work != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto& l = *static_cast<const tile_walk::WalkLaunch*>(walk);
  if (l.tap == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  SegmentArgs a{static_cast<float*>(theta), static_cast<float*>(phi),
                static_cast<const int*>(u), static_cast<const int*>(v),
                static_cast<const float*>(r), static_cast<const float*>(w),
                static_cast<const int*>(gv), static_cast<float*>(acc),
                static_cast<const float*>(lams), sub, tile_u, tile_v, lanes,
                dim, 8 / theta_groups, 8 / phi_groups, loss, eta, gb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (work == 0)
    return tile_walk::launch(adreg_walk_kernel<false>, a, l, 32 * kWarps, st);
  return tile_walk::launch(adreg_walk_kernel<true>, a, l, 32 * kWarps, st);
}

// The most clusters of `cluster` blocks of the tile walk (work: 0 = f32,
// 1 = bf16) the card keeps resident at once, into *out. Returns 0 or the
// CUDA error code.
extern "C" int tmf_adreg_walk_clusters(int work, int cluster, int* out) {
  if (work == 0)
    return tile_walk::resident_clusters(adreg_walk_kernel<false>, cluster,
                                        32 * kWarps, out);
  return tile_walk::resident_clusters(adreg_walk_kernel<true>, cluster,
                                      32 * kWarps, out);
}

#ifdef TMF_TILE_CLOCKS
// The diagnostic build's clock sums per phase since the last call.
extern "C" int tmf_adreg_walk_clocks(void* out) {
  return tile_walk::read_clocks(out);
}
#endif
