// MoE routing transform: each (token, slot) assignment's rank in its
// expert's queue, and its flattened buffer destination.
//
// Replaces the Pallas TPU kernel moe_route_transform_pallas
// (src/repro/kernels/moe_route.py, body _kernel).
//
// What it computes, for one routing group of T tokens with K expert ids
// each, flattened t-major (i = t * K + k, earlier tokens then earlier
// slots win lower positions):
//   pos[i]  = #{ j < i : ids[j] == ids[i] }
//   dest[i] = ids[i] * C + pos[i], or DROP (-1) when pos[i] >= C or the
//             id lies outside [0, E).
// Out-of-range ids (padding at -1 included) get pos 0 and DROP and are
// not counted.
//
// What bounds it on this card: device-memory bytes.  It reads T*K ids
// and writes two T*K int32 arrays, with a handful of integer operations
// per assignment; at the serving shapes (T*K <= 4096 a group) that is far
// below a microsecond of traffic, so what a launch costs is latency: the
// launch itself and the dependent steps inside it.
//
// What the design does about it.  The TPU kernel carries a (1, E) running
// count across its in-order grid over token tiles.  The first port of it
// walked each group in order on one CTA, 256 ids at a time, with four
// block barriers and serial loops a chunk: its cost grew with T*K / 256 on
// one SM a group.  Here every call is one launch in one of two forms,
// chosen on the host (kernels/moe_route.py, launch_geometry):
//   * warp form, T*K <= 32 (a decode step): a group's ids sit in a
//     segment of a warp (the next power of two of T*K lanes, several
//     groups a warp).  __match_any_sync on (segment, id) finds the lanes
//     of the same expert and __popc(peers & lanemask_lt) ranks each among
//     them.  No shared memory, no barrier.
//   * cluster form: a group is split over a thread-block cluster of 1-16
//     CTAs, each owning a contiguous slice of it (ranks run in flat
//     order, so a slice's ids all come after the earlier slices' ones).
//     A CTA takes its slice in chunks of threads * R ids, R per thread;
//     a warp owns 32 * R consecutive ids of a chunk and takes them in R
//     rounds of 32, each one coalesced 128-byte load (all R issued before
//     the first is used) and store.  A round's ranks come from
//     __match_any_sync plus the warp's running count of each expert, a
//     row of a (warps, E | 1) table in shared memory that the lowest peer
//     advances; a lane holding 4 consecutive ids from a 16-byte load
//     could not take its ranks in flat order without a transpose.  One
//     barrier, then an exclusive scan down each expert's column (a
//     segment of `warps` lanes an expert, shuffles, 32 experts an
//     iteration over the CTA) gives each warp the earlier warps' counts
//     and the CTA its totals, which it publishes in its own shared
//     memory.  After one cluster barrier each CTA sums the totals of the
//     earlier CTAs of its cluster through distributed shared memory (all
//     the reads in flight at once), then writes pos and dest.  A slice
//     longer than one chunk is first counted (each round's lowest peers
//     add to the totals), then ranked chunk by chunk, carrying the
//     running counts; the one cluster exchange sits between the two
//     walks.  A thread's rounds grow with T*K / (cluster * threads).
// The table stays within the 48 KB a block gets without opting in: the
// host takes fewer warps for large E (8 at E = 1024).  A call allocates
// nothing, uses no global scratch and no memset, reads nothing back, so
// it can be captured in a CUDA graph.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on
// the given stream and returns the launch's error (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDrop = -1;
constexpr int kMaxThreads = 1024;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Warp form: 1 << seg_log2 lanes a group, 32 >> seg_log2 groups a warp.
__global__ void route_warp_kernel(const int* __restrict__ ids,
                                  int* __restrict__ pos,
                                  int* __restrict__ dest, int groups, int tk,
                                  int num_experts, int capacity,
                                  int seg_log2) {
  const int lane = threadIdx.x & 31;
  const int seg = lane >> seg_log2;
  const int i = lane & ((1 << seg_log2) - 1);
  const long long g =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          (32 >> seg_log2) + seg;
  const bool in = g < groups && i < tk;
  const size_t at = (size_t)g * tk + i;
  const int id = in ? __ldg(ids + at) : kDrop;
  const bool valid = in && id >= 0 && id < num_experts;
  // E <= 1024: the id takes 10 bits, the segment the bits above
  const unsigned peers =
      __match_any_sync(0xffffffffu, valid ? (seg << 10) | id : -1);
  if (in) {
    const int p = valid ? __popc(peers & lanemask_lt()) : 0;
    pos[at] = p;
    dest[at] = (valid && p < capacity) ? id * capacity + p : kDrop;
  }
}

// Cluster form: a group over a cluster, R ids a thread a chunk.
// Shared memory: tbl (warps, E | 1) per-warp counts (then the earlier
// warps' counts), tot (E) this CTA's totals (read by the later CTAs of
// the cluster), base (E) the queue lengths before the current chunk,
// ctot (E) the current chunk's totals.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
    route_cluster_kernel(const int* __restrict__ ids, int* __restrict__ pos,
                         int* __restrict__ dest, int tk, int num_experts,
                         int capacity, int slice, int chunks) {
  extern __shared__ int smem[];
  const int E = num_experts;
  const int stride = E | 1;  // odd: a column's W entries in W banks
  const int W = blockDim.x >> 5;
  int* tbl = smem;
  int* tot = tbl + W * stride;
  int* base = tot + E;
  int* ctot = base + E;
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const size_t g0 = (size_t)(blockIdx.x / cluster.num_blocks()) * tk;
  const int lo = crank * slice;
  const int hi = min(tk, lo + slice);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = lanemask_lt();
  int* row = tbl + warp * stride;
  const int first = lo + warp * 32 * R + lane;  // round 0 of chunk 0
  const int chunk = blockDim.x * R;
  int v[R];  // this thread's ids in the current chunk; kDrop if not counted
  int r[R];  // their ranks among the warp's ids of the chunk

  auto load = [&](int k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = first + k * chunk + j * 32;
      const int x = i < hi ? __ldg(ids + g0 + i) : kDrop;
      v[j] = (x >= 0 && x < E) ? x : kDrop;
    }
  };
  auto warp_ranks = [&]() {
    for (int e = lane; e < E; e += 32) row[e] = 0;
    __syncwarp();
    unsigned peers[R];
#pragma unroll
    for (int j = 0; j < R; ++j) peers[j] = __match_any_sync(0xffffffffu, v[j]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int before = v[j] >= 0 ? row[v[j]] : 0;
      __syncwarp();
      if (v[j] >= 0 && (peers[j] & lt) == 0)
        row[v[j]] = before + __popc(peers[j]);
      __syncwarp();
      r[j] = before + __popc(peers[j] & lt);
    }
  };
  // Exclusive scan of each expert's column of tbl over the warps, in
  // place; the column's total to out.  A segment of W lanes (lane = warp
  // row) takes an expert: 32 experts an iteration over the CTA.
  auto scan = [&](int* out) {
    const int w = lane & (W - 1);
    const int eo = warp * (32 / W) + lane / W;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + eo;
      const int x = e < E ? tbl[w * stride + e] : 0;
      int incl = x;
      for (int d = 1; d < W; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d, W);
        if (w >= d) incl += y;
      }
      if (e < E) {
        tbl[w * stride + e] = incl - x;
        if (w == W - 1) out[e] = incl;
      }
    }
  };
  auto write = [&](int k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = first + k * chunk + j * 32;
      if (i < hi) {
        int p = 0;
        int d = kDrop;
        if (v[j] >= 0) {
          p = base[v[j]] + row[v[j]] + r[j];
          if (p < capacity) d = v[j] * capacity + p;
        }
        pos[g0 + i] = p;
        dest[g0 + i] = d;
      }
    }
  };

  load(0);
  if (chunks == 1) {
    warp_ranks();
    __syncthreads();
    scan(tot);
  } else {  // count the slice first: its totals are all the exchange needs
    for (int e = tid; e < E; e += blockDim.x) tot[e] = 0;
    __syncthreads();
    for (int k = 0; k < chunks; ++k) {
      if (k) load(k);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const unsigned peers = __match_any_sync(0xffffffffu, v[j]);
        if (v[j] >= 0 && (peers & lt) == 0) atomicAdd(tot + v[j], __popc(peers));
      }
    }
  }
  cluster.sync();  // every CTA's totals are visible cluster-wide
  for (int e = tid; e < E; e += blockDim.x) {
    int s = 0;
#pragma unroll
    for (int c = 0; c < kMaxCluster - 1; ++c)  // all in flight at once
      if (c < crank) s += cluster.map_shared_rank(tot, c)[e];
    base[e] = s;
  }
  cluster_arrive();  // no more reads of other CTAs' shared memory
  __syncthreads();
  if (chunks == 1) {
    write(0);
  } else {
    for (int k = 0; k < chunks; ++k) {
      load(k);
      warp_ranks();
      __syncthreads();
      scan(ctot);
      __syncthreads();
      write(k);
      __syncthreads();
      for (int e = tid; e < E; e += blockDim.x) base[e] += ctot[e];
    }
  }
  cluster_wait();  // the later CTAs have read this CTA's totals
}

__global__ void route_empty_kernel() {}

template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, int grid, int threads,
                             size_t smem, int cluster, cudaStream_t s,
                             Args... args) {
  if (cluster > kPortableCluster) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

extern "C" {

// ids, pos, dest: (groups, tk) int32, tk = T * K per routing group.
// form 0 (warp): grid CTAs of `threads`, 1 << seg_log2 lanes a group.
// form 1 (cluster): grid = groups * cluster CTAs of `threads`, per_thread
// (1, 2, 4 or 8) ids a thread a chunk, `slice` ids a CTA in `chunks`
// chunks; (threads / 32 * (E | 1) + 3 * E) * 4 bytes of shared memory.
int moe_route(const int* ids, int* pos, int* dest, int groups, int tk,
              int num_experts, int capacity, int form, int grid, int threads,
              int seg_log2, int per_thread, int cluster, int slice,
              int chunks, void* stream) {
  if (groups == 0 || tk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    route_warp_kernel<<<grid, threads, 0, s>>>(ids, pos, dest, groups, tk,
                                               num_experts, capacity,
                                               seg_log2);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      ((size_t)(threads / 32) * (num_experts | 1) + 3 * (size_t)num_experts) *
      sizeof(int);
  cudaError_t e = cudaErrorInvalidValue;
  switch (per_thread) {
#define ROUTE_CASE(R_)                                                      \
  case R_:                                                                  \
    e = launch_clustered(route_cluster_kernel<R_>, grid, threads, smem,    \
                         cluster, s, ids, pos, dest, tk, num_experts,      \
                         capacity, slice, chunks);                         \
    break;
    ROUTE_CASE(1)
    ROUTE_CASE(2)
    ROUTE_CASE(4)
    ROUTE_CASE(8)
#undef ROUTE_CASE
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// An empty kernel launched like a routing call (grid CTAs of `threads`,
// clusters of `cluster`): the practical floor of a launch's device time.
int moe_route_floor(int grid, int threads, int cluster, void* stream) {
  cudaError_t e = launch_clustered(route_empty_kernel, grid, threads, 0,
                                   cluster, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // extern "C"
