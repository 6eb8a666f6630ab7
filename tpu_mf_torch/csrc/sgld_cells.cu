// DP-SGLD round for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute a DP-SGLD round (reference
// semantics: src/dpmf.h:37-92) over different plans:
//   tpu_mf/ops/pallas_sgld.py:_sgld_kernel (gen-1 cell plans,
//     ops/sgld_cells.py): the "gen-1 mode";
//   tpu_mf/ops/pallas_sgld_slot.py:_slot_sgld_kernel (plain and striped
//     slot plans converted to window plans, ops/sgld_slot.py): the
//     "slot mode".
// The TPU kernels' one-hot gathers, slot-major stacked tables, lane rolls,
// broadcast matmuls, split f32 stamp lanes and row layout are layout. Here
// rows are the fused homogeneous rows of ops/rows.py (theta = [fac | bu | 1
// | cnt], phi = [fac | 1 | bv | cnt]), the last-touch stamps are int64
// vectors beside the tables and the inverse frequencies a float vector.
//
// A plan batch holds 8 columns of rating slots on one user tile gu[i];
// column k has its own item tile gv[i][k]. Per rating slot
//
//     err = scal * w * (r - t . p - gb),   scal = eta * ntrain * bound * lambda_r
//     dtheta[u] += err * p,  dphi[v] += err * t,  count lane (dim + 2) += w
//
// and at an apply a row touched k times becomes, per kept lane l (factors
// and its own bias),
//
//     row_l * base_l^k + s * d_l,   base_l = 1 - eta * bound * invf_row * lam_l
//
// (|base|^k = exp(k ln|base|), negated for a negative base and odd k;
// s = min(1, cap / max(k, 1)) in slot mode, else 1). Lazy noise adds
// sqrt(max(temp * eta * (clock - stamp), 0)) * N(0, 1) to the kept lanes of
// a touched row and stamps it with the clock.
//
// Gen-1 mode: windows of one column (8/8 groups), no saturation. clock is
// the END-of-batch count; every row the batch touches takes its noise in a
// phase before the batch's first column (a row takes noise only at its first
// touch in a batch: at later touches the elapsed count is 0, and columns
// that do not touch a row leave it exactly as it was). The normals come
// from a counter-based hash of (seed + i, side, table row, lane): murmur3's
// 32-bit finalizer, 24-bit uniforms and Box-Muller; ops/sgld_cells.py
// computes the same bits in int64 torch ops.
// Slot mode: one window of all 8 columns, saturation on, clock the
// batch-START count. Item tiles apply where the plan's `ap` flag is set (a
// tile's last touching column), the user tile at batch end; on noise
// batches (flag 2, and i % noise_every == noise_every - 1 for the user tile)
// touched rows take normals from the round's ring, at the offsets of the
// TPU kernel.
//
// Rounding in the bf16 working type follows the TPU kernels: rows rounded
// to bf16 before the gather, t*p summed unrounded in f32, the scatter
// operands err*p and err*t rounded; every sum is f32. The f32 working type
// rounds nothing. Atomics sum in no fixed order.
//
// Design. One cooperative launch runs the round on one block of 32 warps
// per SM (cell_sgd.cu's structure): a noise phase per batch (gen-1 mode),
// then per window a scatter phase (one warp per slot, f32 atomics into
// `dtheta` and `acc`), a grid sync, an apply phase (one warp per row of the
// user tile and of the item tiles that apply), a grid sync. Rows, deltas and
// stamps change between phases on other SMs: they are read through L2
// (ld.global.cg).
//
// The tile walk (sgld_walk_kernel, tile_walk.cuh, ops/tile_walk.py) runs
// the same windows as units (runs of real columns on one user tile), one
// thread-block cluster each, ordered by ready counters per tile instead of
// grid syncs. In gen-1 mode the batch-start noise moves into the unit: the
// user rows of batch i take theirs when the unit enters batch i, the item
// rows of tile v after the wait on v, before the batch's first column on v.
// That is exact: a row takes noise only at its first touch in a batch, the
// columns between leave it as it was, and the normals hash (seed + i, side,
// row, lane) at the clock cum[i], none of which depends on the order.
//
// What bounds it on the H100. The bytes and operations are small (each real
// rating read once, each row read and written once; 6 (dim + 2) f32
// operations per rating, a normal per kept lane per noisy row, an exp per
// lane per apply). In gen-1 mode a round is ~1.4k batches x (1 noise phase
// + 8 columns x 2 phases) at ML-10M shape, each phase ending in a grid
// sync: the chain of dependent phases bounds it, as in cell_sgd.cu. The
// slot mode has 2 phases per batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "tile_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;   // warps per block of the persistent kernel
constexpr int kCached = 4;   // 32-lane row chunks held in registers
constexpr int kWalkCached = 5;  // the tile walk's: dim <= 157 in one trip
constexpr int kRingLanes = 128;

template <bool kBF16>
__device__ __forceinline__ float to_work(float x) {
  if constexpr (kBF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// Rows, deltas and stamps change between phases on other SMs: read from L2.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ long long ld(const long long* p) {
  return __ldcg(p);
}

// ---- counter-based normals (ops/sgld_cells.py: hash_normals) -------------

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// 32 random bits of counter c under key: two finalizer rounds
__device__ __forceinline__ uint32_t word(uint32_t key, uint32_t c) {
  return fmix32(fmix32(c ^ key) + key);
}

// the key of one table row's normals in batch i; side 0 users, 1 items
__device__ __forceinline__ uint32_t row_key(uint32_t seed, int i, int side,
                                            long long row) {
  const uint32_t kb = fmix32(seed + static_cast<uint32_t>(i));
  const uint32_t ks = fmix32(kb + (side ? 0x3C6EF372u : 0x9E3779B9u));
  return word(ks, static_cast<uint32_t>(row));
}

// the normal of logical lane L (factors 0..dim-1, bias dim) of a row
__device__ __forceinline__ float hash_normal(uint32_t kr, int L) {
  const uint32_t c = 2u * static_cast<uint32_t>(L);
  const uint32_t b1 = word(kr, c), b2 = word(kr, c + 1u);
  const float u1 = static_cast<float>(b1 >> 8) * 0x1p-24f + 0x1p-25f;
  const float u2 = static_cast<float>(b2 >> 8) * 0x1p-24f;
  return sqrtf(-2.f * logf(u1)) * cosf(6.28318548f * u2);
}

// ---- phases ------------------------------------------------------------------

struct SgldArgs {
  float* theta; float* phi; long long* stamp_u; long long* stamp_v;
  const float* invf_u; const float* invf_v; const float* lam;
  const int* u; const int* v; const float* r; const float* w;
  const int* gu; const int* gv; const int* ap; const long long* cum;
  const int* tu_off; const int* tu_ids; const int* tv_off; const int* tv_ids;
  const float* ring; float* dtheta; float* acc;
  const int* nz_lo; const int* nz_hi;  // the tile walk's item noise ranges
  long long clock0;
  int nb, col, tile_u, tile_v, lanes, dim, pack, nq_u, nq_v, noise_every;
  uint32_t seed;
  float scal, gb, eb, te, cap;
};

// One rating slot of the plan: weight, rating, tile-local ids, item tile.
struct Slot {
  float w, r;
  int u, v, gv;
};

__device__ __forceinline__ Slot load_slot(const SgldArgs& a, int cix,
                                          long long slot) {
  return Slot{a.w[slot], a.r[slot], a.u[slot], a.v[slot], a.gv[cix]};
}

// One slot, one warp: gather both rows, predict, scatter the deltas. The
// first kC 32-lane chunks of both rows stay in registers.
template <bool kBF16, int kC = kCached>
__device__ __forceinline__ void step_slot(const SgldArgs& a, const Slot& sl,
                                          int gut, float* dtheta, int lane) {
  const float wk = sl.w, rk = sl.r;
  if (wk == 0.f) return;  // padded slot (sentinel ids): contributes nothing
  const int dim = a.dim, lanes = a.lanes;
  const float* tr = a.theta + ((long long)gut * a.tile_u + sl.u) * lanes;
  const long long vrow = (long long)sl.gv * a.tile_v + sl.v;
  const float* pr = a.phi + vrow * lanes;
  const int n = dim + 2;  // lanes >= dim + 2 are zero in both rows
  float tc[kC], pc[kC];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int l = lane + 32 * j;
    tc[j] = l < n ? to_work<kBF16>(ld(tr + l)) : 0.f;
    pc[j] = l < n ? to_work<kBF16>(ld(pr + l)) : 0.f;
    part += tc[j] * pc[j];
  }
  for (int l = lane + 32 * kC; l < n; l += 32)
    part += to_work<kBF16>(ld(tr + l)) * to_work<kBF16>(ld(pr + l));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  const float err = (a.scal * wk) * (rk - (part + a.gb));
  // each side's one-lane takes the other side's bias term, which its apply
  // never reads: skip those two adds
  float* du = dtheta + (long long)sl.u * lanes;
  float* dv = a.acc + vrow * lanes;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * pc[j]));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * tc[j]));
  }
  for (int l = lane + 32 * kC; l < n; l += 32) {
    const float t = to_work<kBF16>(ld(tr + l)), p = to_work<kBF16>(ld(pr + l));
    if (l != dim + 1) atomicAdd(du + l, to_work<kBF16>(err * p));
    if (l != dim) atomicAdd(dv + l, to_work<kBF16>(err * t));
  }
  if (lane == 0) {  // counts: the count lane of both rows is zero, so w
    atomicAdd(du + dim + 2, wk);
    atomicAdd(dv + dim + 2, wk);
  }
}

// Gen-1 mode: the lazy noise of one row the batch touches, from the hash.
__device__ __forceinline__ void hash_noise_row(float* tr, long long* st,
                                               bool user, int dim, float te,
                                               long long clock, uint32_t kr,
                                               int lane) {
  const float sd = sqrtf(fmaxf(te * static_cast<float>(clock - ld(st)), 0.f));
  __syncwarp();  // every lane has read the stamp before lane 0 writes it
  if (sd > 0.f) {
    for (int L = lane; L <= dim; L += 32) {
      const int l = (!user && L == dim) ? dim + 1 : L;  // the item bias lane
      tr[l] = ld(tr + l) + sd * hash_normal(kr, L);
    }
  }
  if (lane == 0) *st = clock;
}

// Decay one table row and add its window delta (saturated), plus its noise
// from `nz` (indexed by table lane) when given, then clear the delta. The
// count and the first kC chunks arrive in one round trip.
template <int kC = kCached>
__device__ __forceinline__ void apply_row(float* tr, float* dr, long long* st,
                                          float inv, const float* lamv,
                                          bool user, const SgldArgs& a,
                                          bool saturate, const float* nz,
                                          float te, long long clock,
                                          int lane) {
  const int dim = a.dim, n = dim + 3;
  const float k = ld(dr + dim + 2);
  const long long stamp = nz ? ld(st) : 0;
  float dc[kC], rc[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int l = lane + 32 * j;
    dc[j] = l < n ? ld(dr + l) : 0.f;
    rc[j] = l < n ? ld(tr + l) : 0.f;
  }
  __syncwarp();  // every lane has read k and the stamp before they change
  if (k == 0.f) return;  // untouched in this window
  const float sat = saturate ? fminf(1.f, a.cap / fmaxf(k, 1.f)) : 1.f;
  const float ebi = a.eb * inv;
  const bool odd = fmodf(k, 2.f) == 1.f;
  const float sd =
      nz ? sqrtf(fmaxf(te * static_cast<float>(clock - stamp), 0.f)) : 0.f;
  auto update = [&](int l, float row, float d) {
    if (user ? l <= dim : (l < dim || l == dim + 1)) {  // kept lanes
      const float base = 1.f - ebi * __ldg(lamv + l);
      const float mag = expf(k * logf(fmaxf(fabsf(base), 1e-30f)));
      float out = row * ((base < 0.f && odd) ? -mag : mag) + d * sat;
      if (nz) out += sd * __ldg(nz + l);
      tr[l] = out;
    }
    dr[l] = 0.f;
  };
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int l = lane + 32 * j;
    if (l >= n) break;
    update(l, rc[j], dc[j]);
  }
  for (int l = lane + 32 * kC; l < n; l += 32)
    update(l, ld(tr + l), ld(dr + l));
  if (nz && lane == 0) *st = clock;
}

// Gen-1 mode: the lazy noise of batch i's touched rows, n_u user rows from
// tu_ids[u0:] (tile-local, the user tile at urow0) and n_v item rows from
// tv_ids[v0:], spread over warps `warp`, `warp + n_warps`, ...
__device__ __forceinline__ void inject_noise(const SgldArgs& a, int i,
                                             long long clock, long long urow0,
                                             int u0, int n_u, int v0, int n_v,
                                             int warp, int n_warps, int lane) {
  for (int q = warp; q < n_u + n_v; q += n_warps) {
    const bool user = q < n_u;
    const long long row =
        user ? urow0 + a.tu_ids[u0 + q] : (long long)a.tv_ids[v0 + q - n_u];
    hash_noise_row((user ? a.theta : a.phi) + row * a.lanes,
                   (user ? a.stamp_u : a.stamp_v) + row, user, a.dim, a.te,
                   clock, row_key(a.seed, i, user ? 0 : 1, row), lane);
  }
}

// The apply of one row of the user tile `tile` (its delta in `dtheta`) or
// of item tile `tile` (its delta in acc) at batch i: flag 2 adds the
// round's ring noise (slot mode: the TPU kernel's ring slice and slot
// lanes).
template <bool kSlot, int kC = kCached>
__device__ __forceinline__ void apply_tile_row(const SgldArgs& a,
                                               float* dtheta, bool user,
                                               int local, int tile, int flag,
                                               int i, long long clock,
                                               int lane) {
  const int rows = user ? a.tile_u : a.tile_v;
  const long long row = (long long)tile * rows + local;
  const float* nz = nullptr;
  if (kSlot && flag == 2) {
    const int site = user ? tile * a.tile_u + 1 : tile * a.tile_v;
    const int nq = user ? a.nq_u : a.nq_v;
    const int vq = static_cast<int>(static_cast<uint32_t>(i) * 40503u +
                                    static_cast<uint32_t>(site) * 25253u +
                                    a.seed);
    const int qs = (vq ^ (vq >> 7)) & (nq - 1);
    const int P = a.pack, s = local % P;
    nz = a.ring + (long long)(qs * 8 + s * (rows / P) + local / P) *
                      kRingLanes + s * (kRingLanes / P);
  }
  float* tab = (user ? a.theta : a.phi) + row * a.lanes;
  float* d = user ? dtheta + (long long)local * a.lanes
                  : a.acc + row * a.lanes;
  apply_row<kC>(tab, d, (user ? a.stamp_u : a.stamp_v) + row,
            __ldg((user ? a.invf_u : a.invf_v) + row),
            a.lam + (user ? 0 : a.lanes), user, a, kSlot, nz, a.te, clock,
            lane);
}

// One round in one cooperative launch (see the top of the file).
template <bool kBF16, bool kSlot>
__global__ void __launch_bounds__(32 * kWarps)
sgld_epoch_kernel(SgldArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int n_warps = gridDim.x * kWarps;
  constexpr int step = kSlot ? 8 : 1;  // columns per window
  const int width = step * a.col;
  // when a step has at most one slot per warp, each warp loads its slot of
  // the next step before the grid syncs
  Slot next{};
  bool have_next = false;
  for (int i = 0; i < a.nb; ++i) {
    const int gut = a.gu[i];
    const long long urow0 = (long long)gut * a.tile_u;
    const long long clock = a.clock0 + a.cum[i];
    if constexpr (!kSlot) {
      const int u0 = a.tu_off[i], n_u = a.tu_off[i + 1] - u0;
      const int v0 = a.tv_off[i];
      inject_noise(a, i, clock, urow0, u0, n_u, v0, a.tv_off[i + 1] - v0,
                   gwarp, n_warps, lane);
      grid.sync();
    }
    for (int c0 = 0; c0 < 8; c0 += step) {
      for (int q = gwarp; q < width; q += n_warps) {
        const int cix = i * 8 + c0 + q / a.col;
        const Slot sl = have_next && q == gwarp
            ? next : load_slot(a, cix, (long long)cix * a.col + q % a.col);
        step_slot<kBF16>(a, sl, gut, a.dtheta, lane);
      }
      const int ni = c0 + step < 8 ? i : i + 1;
      const int nc = c0 + step < 8 ? c0 + step : 0;
      have_next = ni < a.nb && gwarp < width && width <= n_warps;
      if (have_next) {
        const int cix = ni * 8 + nc + gwarp / a.col;
        next = load_slot(a, cix, (long long)cix * a.col + gwarp % a.col);
      }
      grid.sync();
      const bool noisy_u =
          kSlot && i % a.noise_every == a.noise_every - 1;
      const int total = step * a.tile_v + a.tile_u;
      for (int q = gwarp; q < total; q += n_warps) {
        if (q >= step * a.tile_v) {
          apply_tile_row<kSlot>(a, a.dtheta, true, q - step * a.tile_v, gut,
                                noisy_u ? 2 : 1, i, clock, lane);
        } else {
          const int cix = i * 8 + c0 + q / a.tile_v;
          const int flag = kSlot ? a.ap[cix] : 1;
          if (flag == 0) continue;
          apply_tile_row<kSlot>(a, a.dtheta, false, q % a.tile_v, a.gv[cix],
                                flag, i, clock, lane);
        }
      }
      grid.sync();
    }
  }
}

// The tile walk (tile_walk.cuh, ops/tile_walk.py): the same windows (one
// column in gen-1 mode, one batch in slot mode), each unit (a run of real
// columns on one user tile) on one cluster of C blocks. Per window: each
// block's threads wait on the item tiles the unit touches first in it; in
// gen-1 mode the noise of the batch's user rows when the unit enters the
// batch, and of its item rows on a tile at the batch's first column on
// that tile (nz_lo/nz_hi), then a cluster barrier; the scatter of the
// window's real slots into the cluster's own dtheta slice and acc; a
// cluster barrier; the applies of the user tile and of the item tiles
// flagged (every real column in gen-1 mode, w.tap in slot mode); a cluster
// barrier; the releases of the item tiles whose last touch was applied.
template <bool kBF16, bool kSlot>
__global__ void __launch_bounds__(32 * kWarps, 1)
sgld_walk_kernel(SgldArgs a, tile_walk::Walk w) {
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int s_unit;
  const int lane = threadIdx.x % 32;
  const int n_cw = static_cast<int>(cl.num_blocks()) * kWarps;
  const int cw = static_cast<int>(cl.block_rank()) * kWarps + threadIdx.x / 32;
  const bool lead = cl.block_rank() == 0;
  float* dth = w.dtheta +
      (long long)(blockIdx.x / cl.num_blocks()) * a.tile_u * a.lanes;
  constexpr int step = kSlot ? 8 : 1;  // columns per window
  TW_CLOCKS;
  TW_START();
  for (;;) {
    const int unit = tile_walk::next_unit(w, &s_unit);
    TW_TICK(0);
    if (unit >= w.n_units) break;
    const int c0 = __ldg(w.unit_c0 + unit), c1 = __ldg(w.unit_c1 + unit);
    const int gut = __ldg(w.unit_gu + unit);
    const long long urow0 = (long long)gut * a.tile_u;
    if (threadIdx.x == 0)
      tile_walk::wait_tile(w.ready + w.n_gv + gut, w.gen,
                           __ldg(w.unit_wait + unit));
    int batch = -1;  // the batch whose user rows took their noise
    for (int s = c0 - c0 % step; s < c1; s += step) {
      const int lo = s < c0 ? c0 : s, hi = s + step < c1 ? s + step : c1;
      bool any = false;
      for (int c = lo; c < hi; ++c) any |= __ldg(w.col_tile + c) >= 0;
      if (!any) continue;
      TW_COUNT();
      if (threadIdx.x < step) {
        const int c = s + threadIdx.x;
        if (c >= lo && c < hi && __ldg(w.col_tile + c) >= 0)
          tile_walk::wait_tile(w.ready + __ldg(w.col_tile + c), w.gen,
                               __ldg(w.col_wait + c));
      }
      __syncthreads();  // the acquires hold for the whole block
      TW_TICK(1);
      const int i = s / 8;
      const long long clock = a.clock0 + __ldg(a.cum + i);
      if constexpr (!kSlot) {
        const int u0 = i != batch ? __ldg(a.tu_off + i) : 0;
        const int n_u = i != batch ? __ldg(a.tu_off + i + 1) - u0 : 0;
        const int v0 = __ldg(a.nz_lo + s), n_v = __ldg(a.nz_hi + s) - v0;
        batch = i;
        if (n_u + n_v > 0) {
          inject_noise(a, i, clock, urow0, u0, n_u, v0, n_v, cw, n_cw, lane);
          cl.sync();  // the noisy rows before any gather
        }
        TW_TICK(2);
      }
      // each warp loads its next slot before it works on this one
      auto fetch = [&](int q) {
        const int cix = s + q / a.col;
        return q < step * a.col && cix >= lo && cix < hi &&
                       __ldg(w.col_tile + cix) >= 0
                   ? load_slot(a, cix, (long long)cix * a.col + q % a.col)
                   : Slot{};
      };
      Slot sl = fetch(cw);
      for (int q = cw; q < step * a.col; q += n_cw) {
        const Slot next = fetch(q + n_cw);
        step_slot<kBF16, kWalkCached>(a, sl, gut, dth, lane);
        sl = next;
      }
      TW_TICK(3);
      cl.sync();  // every block's deltas are in
      TW_TICK(4);
      const bool noisy_u = kSlot && i % a.noise_every == a.noise_every - 1;
      const int total = step * a.tile_v + a.tile_u;
      for (int q = cw; q < total; q += n_cw) {
        if (q >= step * a.tile_v) {
          apply_tile_row<kSlot, kWalkCached>(a, dth, true,
                                             q - step * a.tile_v, gut,
                                             noisy_u ? 2 : 1, i, clock, lane);
        } else {
          const int cix = s + q / a.tile_v;
          if (cix < lo || cix >= hi) continue;
          const int tile = __ldg(w.col_tile + cix);
          const int flag = kSlot ? __ldg(w.tap + cix) : tile >= 0;
          if (flag == 0) continue;
          apply_tile_row<kSlot, kWalkCached>(a, dth, false, q % a.tile_v,
                                             tile, flag, i, clock, lane);
        }
      }
      TW_TICK(5);
      cl.sync();  // every block's applies are stored
      TW_TICK(6);
      if (lead && threadIdx.x < step) {
        const int c = s + threadIdx.x;
        if (c >= lo && c < hi && __ldg(w.col_rel + c) > 0)
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

template <bool kBF16, bool kSlot>
int run_epoch(const SgldArgs& args, cudaStream_t stream) {
  auto kernel = sgld_epoch_kernel<kBF16, kSlot>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * kWarps, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  SgldArgs a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(sms),
                                    dim3(32 * kWarps), params, 0, stream);
  return static_cast<int>(err);
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// One SGLD round, in place on theta/phi and the stamps, launched on
// `stream`. The plan arrays u, v, r, w are (nb, 8, col), one column
// contiguous; gu and cum (int64 clock offsets) (nb); gv (nb, 8). Gen-1 mode
// (slot = 0) reads the touch lists tu_off/tu_ids (tile-local user rows) and
// tv_off/tv_ids (item table rows); slot mode reads ap (nb, 8), the ring
// (n_ring x 128), pack, nq_u/nq_v (ring slices per side, powers of two),
// noise_every and the saturation cap. dtheta (tile_u x lanes) and acc (phi's
// shape) must be zero on entry and are zero again on return. work: 0 = f32,
// 1 = bf16. `walk` (a tile_walk::WalkLaunch, or null for the grid walk)
// runs the round on the tile walk: dtheta is then unused, slot mode reads
// the walk's tap instead of ap, and gen-1 mode its nz_lo / nz_hi. Returns
// 0 or the CUDA error code.
extern "C" int tmf_sgld_epoch(
    void* theta, void* phi, void* stamp_u, void* stamp_v, const void* invf_u,
    const void* invf_v, const void* lam, const void* u, const void* v,
    const void* r, const void* w, const void* gu, const void* gv,
    const void* ap, const void* cum, const void* tu_off, const void* tu_ids,
    const void* tv_off, const void* tv_ids, const void* ring, void* dtheta,
    void* acc, long long clock0, int nb, int col, int tile_u, int tile_v,
    int lanes, int dim, int work, int slot, int pack, int n_ring, int nq_u,
    int nq_v, int noise_every, int seed, float scal, float gb,
    float eb, float te, float cap, const void* walk, void* stream) {
  if (dim + 3 > lanes || col <= 0 || nb < 0 || (work != 0 && work != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (slot) {
    if ((pack != 2 && pack != 4 && pack != 8) || dim + 2 > kRingLanes / pack ||
        tile_u % pack || tile_v % pack || !pow2(nq_u) || !pow2(nq_v) ||
        8 * (nq_u - 1) + tile_u > n_ring || 8 * (nq_v - 1) + tile_v > n_ring ||
        noise_every < 1 || ap == nullptr || ring == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (!tu_off || !tu_ids || !tv_off || !tv_ids) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SgldArgs a{static_cast<float*>(theta), static_cast<float*>(phi),
             static_cast<long long*>(stamp_u), static_cast<long long*>(stamp_v),
             static_cast<const float*>(invf_u), static_cast<const float*>(invf_v),
             static_cast<const float*>(lam), static_cast<const int*>(u),
             static_cast<const int*>(v), static_cast<const float*>(r),
             static_cast<const float*>(w), static_cast<const int*>(gu),
             static_cast<const int*>(gv), static_cast<const int*>(ap),
             static_cast<const long long*>(cum), static_cast<const int*>(tu_off),
             static_cast<const int*>(tu_ids), static_cast<const int*>(tv_off),
             static_cast<const int*>(tv_ids), static_cast<const float*>(ring),
             static_cast<float*>(dtheta), static_cast<float*>(acc), nullptr,
             nullptr, clock0,
             nb, col, tile_u, tile_v, lanes, dim, pack, nq_u, nq_v,
             noise_every, static_cast<uint32_t>(seed), scal, gb, eb,
             te, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (walk != nullptr) {
    const auto& l = *static_cast<const tile_walk::WalkLaunch*>(walk);
    if (slot ? l.tap == nullptr : (!l.nz_lo || !l.nz_hi))
      return static_cast<int>(cudaErrorInvalidValue);
    a.nz_lo = static_cast<const int*>(l.nz_lo);
    a.nz_hi = static_cast<const int*>(l.nz_hi);
    constexpr int kThreads = 32 * kWarps;
    if (slot)
      return work ? tile_walk::launch(sgld_walk_kernel<true, true>, a, l,
                                      kThreads, st)
                  : tile_walk::launch(sgld_walk_kernel<false, true>, a, l,
                                      kThreads, st);
    return work ? tile_walk::launch(sgld_walk_kernel<true, false>, a, l,
                                    kThreads, st)
                : tile_walk::launch(sgld_walk_kernel<false, false>, a, l,
                                    kThreads, st);
  }
  if (slot) return work ? run_epoch<true, true>(a, st) : run_epoch<false, true>(a, st);
  return work ? run_epoch<true, false>(a, st) : run_epoch<false, false>(a, st);
}

// The most clusters of `cluster` blocks of the tile walk (work: 0 = f32,
// 1 = bf16; slot: 0 = gen-1 mode, 1 = slot mode) the card keeps resident at
// once, into *out. Returns 0 or the CUDA error code.
extern "C" int tmf_sgld_walk_clusters(int work, int slot, int cluster,
                                      int* out) {
  constexpr int kThreads = 32 * kWarps;
  if (slot)
    return work ? tile_walk::resident_clusters(sgld_walk_kernel<true, true>,
                                               cluster, kThreads, out)
                : tile_walk::resident_clusters(sgld_walk_kernel<false, true>,
                                               cluster, kThreads, out);
  return work ? tile_walk::resident_clusters(sgld_walk_kernel<true, false>,
                                             cluster, kThreads, out)
              : tile_walk::resident_clusters(sgld_walk_kernel<false, false>,
                                             cluster, kThreads, out);
}

#ifdef TMF_TILE_CLOCKS
// The diagnostic build's clock sums per phase since the last call.
extern "C" int tmf_sgld_walk_clocks(void* out) {
  return tile_walk::read_clocks(out);
}
#endif
