// The tile walk of the window-plan kernels csrc/cell_sgd.cu,
// csrc/adreg_cells.cu and csrc/sgld_cells.cu and of the free-column kernel
// csrc/free_cells.cu: what the walk kernels share.
//
// ops/tile_walk.py sets out the walk and builds its plan: units (maximal
// runs of real columns on one user tile) taken by an atomic ticket in plan
// order, one thread-block cluster each, handing tiles on through ready
// counters. Here: the unit ticket, the waits and releases on those counters,
// the launch of a cluster kernel (clusters of up to 16 blocks, past the
// portable 8 where asked) at the clusters the card keeps resident, and the
// diagnostic clocks per phase of a window step.
//
// Hand-off protocol (the dense wavefront walk's, csrc/dense_cell.cu):
//   - a tile's counter is 64 bits: (launch generation << 32) | releases of
//     the launch; the unit with wait value w > 0 spins with ld.acquire.gpu
//     until it reads (gen << 32) | w, then __syncthreads() hands the
//     acquire on to its block (each block of the cluster waits itself);
//   - the holder's applies are plain stores; a cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire) orders every block's
//     stores before one thread's st.release.gpu of (gen << 32) | (w + 1);
//   - readers load rows and deltas with ld.global.cg (L2), never through a
//     stale L1 line.
// A wait spins at most kSpinLimit cycles (~10 s), then traps: a walk that
// lost a release fails instead of hanging the card.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace tile_walk {

namespace cg = cooperative_groups;

constexpr long long kSpinLimit = 1ll << 34;

// One launch range of a plan's tile walk (ops/tile_walk.py: DeviceWalk).
struct Walk {
  unsigned long long* ready;  // n_gv item tiles, then the user tiles
  unsigned* ticket;           // the unit ticket (32 bits)
  const int* unit_c0;         // first real column of each unit
  const int* unit_c1;         // one past its last real column
  const int* unit_gu;         // its user tile
  const int* unit_wait;       // earlier units of the launch on its user tile
  const int* col_tile;        // item tile of a real column, else -1
  const int* col_wait;        // wait value at a unit's first touch, else -1
  const int* col_rel;         // wait value + 1 at its last touch, else 0
  const int* tap;             // apply flags of the real columns (nb x 8)
  float* dtheta;              // one tile_u x lanes slice per cluster
  int n_units, n_gv;
  unsigned ticket_base, gen;
};

// What a launch of the tile walk takes beyond its kernel's own arguments,
// as the host passes it (ops/tile_walk.py: WalkLaunch, a ctypes structure
// of the same layout): the counters (n_gv + n_gu 64-bit ready counters),
// the 32-bit ticket, the per-cluster dtheta slices, the walk's int32 arrays
// (nz_lo / nz_hi: the gen-1 SGLD item noise ranges, else null), and the
// launch's numbers.
struct WalkLaunch {
  void* counters;
  void* ticket;
  void* dtheta;
  const void* unit_c0;
  const void* unit_c1;
  const void* unit_gu;
  const void* unit_wait;
  const void* col_tile;
  const void* col_wait;
  const void* col_rel;
  const void* tap;
  const void* nz_lo;
  const void* nz_hi;
  long long n_units, n_gv, cluster, n_clusters;
  unsigned long long ticket_base, gen;
};

inline bool valid_launch(const WalkLaunch& l) {
  return l.counters && l.ticket && l.dtheta && l.unit_c0 && l.unit_c1 &&
         l.unit_gu && l.unit_wait && l.col_tile && l.col_wait && l.col_rel &&
         l.n_units >= 0 && l.n_gv > 0 && l.cluster >= 1 && l.cluster <= 16 &&
         l.n_clusters >= 1;
}

inline Walk to_walk(const WalkLaunch& l) {
  return Walk{static_cast<unsigned long long*>(l.counters),
              static_cast<unsigned*>(l.ticket),
              static_cast<const int*>(l.unit_c0),
              static_cast<const int*>(l.unit_c1),
              static_cast<const int*>(l.unit_gu),
              static_cast<const int*>(l.unit_wait),
              static_cast<const int*>(l.col_tile),
              static_cast<const int*>(l.col_wait),
              static_cast<const int*>(l.col_rel),
              static_cast<const int*>(l.tap),
              static_cast<float*>(l.dtheta),
              static_cast<int>(l.n_units),
              static_cast<int>(l.n_gv),
              static_cast<unsigned>(l.ticket_base),
              static_cast<unsigned>(l.gen)};
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long stamp(unsigned gen, int w) {
  return (static_cast<unsigned long long>(gen) << 32) |
         static_cast<unsigned>(w);
}

// Spin until the counter shows that the w earlier units of this launch on
// the tile have released it (nothing to wait for at w = 0).
__device__ __forceinline__ void wait_tile(const unsigned long long* p,
                                          unsigned gen, int w) {
  if (w <= 0) return;
  const unsigned long long want = stamp(gen, w);
  const long long t0 = clock64();
  while (ld_acquire(p) != want)
    if (clock64() - t0 > kSpinLimit) __trap();
}

// Hand the tile on to the next unit (after a cluster barrier that follows
// the holder's last stores to it).
__device__ __forceinline__ void release_tile(unsigned long long* p,
                                             unsigned gen, int w1) {
  st_release(p, stamp(gen, w1));
}

// The next unit of this cluster: block 0's thread 0 draws a ticket and
// writes it into every block's `slot`; n_units or more ends the walk. The
// caller's barriers separate this from the next draw.
__device__ __forceinline__ int next_unit(const Walk& w, int* slot) {
  cg::cluster_group cl = cg::this_cluster();
  if (cl.block_rank() == 0 && threadIdx.x == 0) {
    const int unit = static_cast<int>(atomicAdd(w.ticket, 1u) - w.ticket_base);
    for (unsigned r = 0; r < cl.num_blocks(); ++r)
      *cl.map_shared_rank(slot, r) = unit;
  }
  cl.sync();
  return *slot;
}

// ---- diagnostic clocks (a -DTMF_TILE_CLOCKS build) -------------------------
// Thread 0 of every block adds the clocks since its last tick to the phase's
// sum: 0 ticket, 1 wait, 2 noise, 3 scatter, 4 barrier after the scatter,
// 5 apply, 6 barrier after the apply, 7 release; 8 counts the window steps.
constexpr int kClockPhases = 9;
#ifdef TMF_TILE_CLOCKS
__device__ unsigned long long tile_clocks[kClockPhases];
struct Clocks {
  unsigned long long sum[kClockPhases];
  long long t;
  __device__ void start() {
    for (int k = 0; k < kClockPhases; ++k) sum[k] = 0;
    t = clock64();
  }
  __device__ void tick(int k) {
    const long long now = clock64();
    sum[k] += now - t;
    t = now;
  }
  __device__ void count() { ++sum[kClockPhases - 1]; }
  __device__ void flush() {
    for (int k = 0; k < kClockPhases; ++k) atomicAdd(&tile_clocks[k], sum[k]);
  }
};
#define TW_CLOCKS tile_walk::Clocks tw_clk
#define TW_START() if (threadIdx.x == 0) tw_clk.start()
#define TW_TICK(k) if (threadIdx.x == 0) tw_clk.tick(k)
#define TW_COUNT() if (threadIdx.x == 0) tw_clk.count()
#define TW_FLUSH() if (threadIdx.x == 0) tw_clk.flush()

// The clock sums since the last call into out (kClockPhases u64), zeroed.
inline int read_clocks(void* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, tile_clocks, sizeof(tile_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[kClockPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(tile_clocks, zero, sizeof(zero)));
}
#else
#define TW_CLOCKS
#define TW_START()
#define TW_TICK(k)
#define TW_COUNT()
#define TW_FLUSH()
#endif

// ---- launch ----------------------------------------------------------------

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                         int cluster, int n_clusters,
                                         int threads, cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * n_clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Let `kernel` run in clusters past the portable 8 blocks (up to 16).
template <typename Kernel>
int allow_cluster(Kernel kernel, int cluster) {
  if (cluster <= 8) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

// The most clusters of `cluster` blocks of `kernel` the card keeps resident
// at once, into *out.
template <typename Kernel>
int resident_clusters(Kernel kernel, int cluster, int threads, int* out) {
  const int err = allow_cluster(kernel, cluster);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, cluster, 1, threads, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(kernel), &cfg));
}

// One launch of the walk kernel on l.n_clusters clusters of l.cluster
// blocks; the caller takes n_clusters from resident_clusters, so every
// cluster is on the card at once.
template <typename Kernel, typename Args>
int launch(Kernel kernel, const Args& args, const WalkLaunch& l, int threads,
           cudaStream_t stream) {
  if (!valid_launch(l)) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_cluster(kernel, static_cast<int>(l.cluster));
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, static_cast<int>(l.cluster),
                     static_cast<int>(l.n_clusters), threads, stream);
  Args a = args;
  Walk w = to_walk(l);
  void* params[] = {&a, &w};
  cudaError_t e =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), params);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile_walk
