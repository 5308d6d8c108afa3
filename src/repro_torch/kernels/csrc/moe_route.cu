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
// per assignment; at the serving shapes (T*K <= 4096 a group) a launch
// is far below a microsecond of traffic, so in practice launch latency
// and the serial walk of one group are what it costs.
//
// What the design does about it: the TPU kernel carries a (1, E)
// running count across its in-order grid over token tiles.  CUDA blocks
// have no order, so one CTA owns a whole routing group and walks its
// T*K assignments in order, in chunks of kThreads, with the (E,)
// running count in shared memory:
//   * inside a warp, __match_any_sync groups the lanes holding the same
//     expert and __popc(peers & lanemask_lt) ranks each lane among them;
//   * the warp's lowest peer writes the warp's count of that expert to
//     shared memory, and each lane adds the counts of the chunk's
//     earlier warps;
//   * after the chunk the running counts advance by the chunk's totals.
// Groups run in parallel, one CTA each.  Splitting one large group over
// several CTAs (two-pass scan or decoupled look-back) is later work.
//
// Plain C interface, loaded with ctypes.  The entry point launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDrop = -1;

__global__ void __launch_bounds__(kThreads)
    moe_route_kernel(const int* __restrict__ ids, int* __restrict__ pos,
                     int* __restrict__ dest, int tk, int num_experts,
                     int capacity) {
  extern __shared__ int smem[];
  int* running = smem;                   // (E,) queue length so far
  int* warp_cnt = smem + num_experts;    // (kWarps, E) counts of a chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const size_t g0 = (size_t)blockIdx.x * tk;

  for (int e = tid; e < num_experts; e += kThreads) running[e] = 0;
  for (int c0 = 0; c0 < tk; c0 += kThreads) {  // uniform across the block
    for (int e = tid; e < kWarps * num_experts; e += kThreads)
      warp_cnt[e] = 0;
    __syncthreads();
    const int i = c0 + tid;
    const bool in = i < tk;
    const int id = in ? ids[g0 + i] : kDrop;
    const bool valid = in && id >= 0 && id < num_experts;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? id : -1);
    const int rank = __popc(peers & lt_mask);
    if (valid && rank == 0) warp_cnt[warp * num_experts + id] = __popc(peers);
    __syncthreads();
    if (in) {
      int p = 0;
      int d = kDrop;
      if (valid) {
        p = running[id] + rank;
        for (int w = 0; w < warp; ++w) p += warp_cnt[w * num_experts + id];
        if (p < capacity) d = id * capacity + p;
      }
      pos[g0 + i] = p;
      dest[g0 + i] = d;
    }
    __syncthreads();  // every read of running/warp_cnt is done
    for (int e = tid; e < num_experts; e += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += warp_cnt[w * num_experts + e];
      running[e] += s;
    }
    __syncthreads();  // before the next chunk clears warp_cnt
  }
}

}  // namespace

extern "C" {

// ids, pos, dest: (groups, tk) int32, tk = T * K per routing group.
int moe_route(const int* ids, int* pos, int* dest, int groups, int tk,
              int num_experts, int capacity, void* stream) {
  if (groups == 0 || tk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(1 + kWarps) * num_experts * sizeof(int);
  moe_route_kernel<<<groups, kThreads, smem, s>>>(ids, pos, dest, tk,
                                                  num_experts, capacity);
  return (int)cudaGetLastError();
}

}  // extern "C"
