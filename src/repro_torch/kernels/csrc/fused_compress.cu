// Fused vcompress: mask -> destinations -> row moves, in one launch.
//
// Replaces the Pallas TPU kernel fused_vcompress_pallas
// (src/repro/kernels/fused_compress.py, body _kernel).
//
// What it computes, for a mask m of N rows and a payload x (N, D):
//   ones_below[i] = #{ j < i : m[j] }, total = #{ j : m[j] }
//   dest[i] = ones_below[i]                  if m[i]   (packed, in order)
//           = total + (i - ones_below[i])    otherwise (the tail, in order)
//   out[dest[i]] = x[i]; with tail "zero" the tail rows are zeros.
// dest is a bijection on [0, N) (the TPU kernel's `i - zeros_below` and
// `i + ones_above`, rewritten), so every output row is written once, and
// a row is in the tail exactly when dest[i] >= total.
//
// What bounds it on this card: device-memory bytes — N * D elements
// read and written, N mask elements read; no arithmetic on the payload.
//
// What the design does about it.  The TPU kernel builds an (N, N) one-hot
// tile and multiplies it on the MXU per D tile.  The first port of it
// (a one-CTA serial scan of the mask, then a row-move kernel, behind two
// cast kernels for the mask) spent most of its time in those dependent
// launches.  Here one launch does everything:
//   * a grid of at most two CTAs an SM; each CTA owns a contiguous range
//     of rows (a multiple of 16, so its first row's mask byte offset is a
//     multiple of 16).  It counts the whole mask itself — 16-byte loads
//     and SIMD byte/halfword compares with __popc — into `total` and the
//     ones below its first row, so no CTA waits for another.  The
//     redundant mask reads are grid x N elements, mostly L2 hits; the
//     host caps the grid at row_bytes / mask element size so that they
//     stay below the payload bytes for narrow rows;
//   * it ranks its own rows, a block at a time, with ballots and a
//     per-warp count in shared memory, and moves each row to its
//     destination: a group of 1-32 lanes a row (the row's width in
//     vectors, rounded up to a power of two), in the widest of 16-, 8-,
//     4-, 2- or 1-byte words that the row size and pointers allow.  Each
//     group loads the first 16 vectors a lane of its first row before the
//     mask is counted (a whole 8 KB row with 16-byte words), so the count
//     and the ranking overlap the payload's first trip from memory; the
//     rest moves eight vectors in flight a lane.  Zeroed tail rows are
//     never read.  Rows move as bits, so any dtype is exact;
//   * the mask is read in its own dtype (element size 1, 2, 4 or 8
//     bytes): a value selects when its bits outside `keep` are not all
//     zero.  The host clears the sign bit from `keep` for floating masks
//     (-0.0 does not select) — no cast kernel for bool, integer or
//     floating masks.
// No size is read back and the launch count is fixed, so the call can be
// captured in a CUDA graph.
//
// Plain C interface, loaded with ctypes.  The entry point launches the
// kernel on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPre = 16;   // vectors a lane loads before the mask is counted
constexpr int kBatch = 8;  // vectors in flight a lane in the rest of a move

template <int ES>
struct Elem;
template <>
struct Elem<1> { using T = uint8_t; };
template <>
struct Elem<2> { using T = uint16_t; };
template <>
struct Elem<4> { using T = uint32_t; };
template <>
struct Elem<8> { using T = unsigned long long; };

// Selecting elements in one 16-byte vector of ES-byte mask elements.
template <int ES>
__device__ __forceinline__ int selected_in(uint4 v, uint32_t keep_lo,
                                           uint32_t keep_hi) {
  if constexpr (ES == 1) {
    return (__popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) +
            __popc(__vcmpne4(v.z, 0u)) + __popc(__vcmpne4(v.w, 0u))) >> 3;
  } else if constexpr (ES == 2) {
    return (__popc(__vcmpne2(v.x & keep_lo, 0u)) +
            __popc(__vcmpne2(v.y & keep_lo, 0u)) +
            __popc(__vcmpne2(v.z & keep_lo, 0u)) +
            __popc(__vcmpne2(v.w & keep_lo, 0u))) >> 4;
  } else if constexpr (ES == 4) {
    return ((v.x & keep_lo) != 0u) + ((v.y & keep_lo) != 0u) +
           ((v.z & keep_lo) != 0u) + ((v.w & keep_lo) != 0u);
  } else {
    return (((v.x & keep_lo) | (v.y & keep_hi)) != 0u) +
           (((v.z & keep_lo) | (v.w & keep_hi)) != 0u);
  }
}

template <int ES>
__device__ __forceinline__ bool selected(const void* mask, int i,
                                         unsigned long long keep) {
  using T = typename Elem<ES>::T;
  return (static_cast<const T*>(mask)[i] & static_cast<T>(keep)) != 0;
}

// Copy a row's vectors v, v + lpr, ... (this lane's share from v on),
// kBatch loads in flight a lane.
template <typename V>
__device__ __forceinline__ void copy_from(const V* __restrict__ src,
                                          V* __restrict__ dst, int row_vecs,
                                          int v, int lpr) {
  for (; v + (kBatch - 1) * lpr < row_vecs; v += kBatch * lpr) {
    V buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) buf[u] = src[v + u * lpr];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) dst[v + u * lpr] = buf[u];
  }
  for (; v < row_vecs; v += lpr) dst[v] = src[v];
}

template <int ES, typename V>
__global__ void __launch_bounds__(kThreads)
    fused_vcompress_kernel(const void* __restrict__ mask, uint32_t keep_lo,
                           uint32_t keep_hi, int mask_vectors,
                           const V* __restrict__ x, V* __restrict__ out, int n,
                           int rows_per_cta, int row_vecs, int lpr_log2,
                           int zero_tail) {
  __shared__ int red_s[2][kWarps];
  __shared__ int chunk_s[kWarps];
  __shared__ int dest_s[kThreads];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = blockIdx.x * rows_per_cta;
  const int end = min(n, start + rows_per_cta);
  const unsigned long long keep =
      ((unsigned long long)keep_hi << 32) | keep_lo;

  // 0. Each group starts loading its first row (row g of the first
  //    chunk) before the mask is counted, unless the row is a zeroed tail
  //    row: the loads do not wait for the destinations.
  const int lpr = 1 << lpr_log2;
  const int groups = kThreads >> lpr_log2;
  const int g = tid >> lpr_log2;
  const int sub = tid & (lpr - 1);
  V pre[kPre];
  if (start + g < end && (!zero_tail || selected<ES>(mask, start + g, keep))) {
    const V* src = x + (size_t)(start + g) * row_vecs;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int v = sub + u * lpr;
      if (v < row_vecs) pre[u] = src[v];
    }
  }

  // 1. Selected rows below `start` and in the whole mask.  `start` is a
  //    multiple of 16 rows, so no 16-byte vector straddles it.
  constexpr int kPerVec = 16 / ES;
  const int n_vec = mask_vectors ? n / kPerVec : 0;
  const uint4* mv = static_cast<const uint4*>(mask);
  int below = 0, total = 0;
  for (int q = tid; q < n_vec; q += kThreads) {
    const int c = selected_in<ES>(mv[q], keep_lo, keep_hi);
    total += c;
    if (q * kPerVec < start) below += c;
  }
  for (int i = n_vec * kPerVec + tid; i < n; i += kThreads) {
    const int c = selected<ES>(mask, i, keep);
    total += c;
    if (i < start) below += c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, off);
    below += __shfl_xor_sync(0xffffffffu, below, off);
  }
  if (lane == 0) {
    red_s[0][warp] = total;
    red_s[1][warp] = below;
  }
  __syncthreads();
  total = 0;
  below = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total += red_s[0][w];
    below += red_s[1][w];
  }

  // 2. Rank this CTA's rows kThreads at a time, then move them: group g
  //    of (1 << lpr_log2) lanes moves rows g, g + groups, ...
  const unsigned lt_mask = (1u << lane) - 1u;
  int carry = below;
  for (int c0 = start; c0 < end; c0 += kThreads) {  // uniform in the block
    const int i = c0 + tid;
    const bool m = i < end && selected<ES>(mask, i, keep);
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (lane == 0) chunk_s[warp] = __popc(bits);
    __syncthreads();
    int ones = carry + __popc(bits & lt_mask);
    int chunk_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = chunk_s[w];
      ones += w < warp ? cw : 0;
      chunk_total += cw;
    }
    if (i < end) dest_s[tid] = m ? ones : total + (i - ones);
    __syncthreads();
    const int rows = min(kThreads, end - c0);
    for (int r = g; r < rows; r += groups) {
      const int d = dest_s[r];
      const V* src = x + (size_t)(c0 + r) * row_vecs;
      V* dst = out + (size_t)d * row_vecs;
      if (zero_tail && d >= total) {
        for (int v = sub; v < row_vecs; v += lpr) dst[v] = V{};
      } else if (c0 == start && r == g) {  // its first vectors are loaded
#pragma unroll
        for (int u = 0; u < kPre; ++u) {
          const int v = sub + u * lpr;
          if (v < row_vecs) dst[v] = pre[u];
        }
        copy_from<V>(src, dst, row_vecs, sub + kPre * lpr, lpr);
      } else {
        copy_from<V>(src, dst, row_vecs, sub, lpr);
      }
    }
    carry += chunk_total;
    __syncthreads();  // dest_s and chunk_s are rewritten next chunk
  }
}

template <int ES, typename V>
void launch(const void* mask, uint32_t keep_lo, uint32_t keep_hi,
            int mask_vectors, const void* x, void* out, int n, int row_bytes,
            int zero_tail, int grid, int rows_per_cta, int lpr_log2,
            cudaStream_t s) {
  fused_vcompress_kernel<ES, V><<<grid, kThreads, 0, s>>>(
      mask, keep_lo, keep_hi, mask_vectors, static_cast<const V*>(x),
      static_cast<V*>(out), n, rows_per_cta, row_bytes / (int)sizeof(V),
      lpr_log2, zero_tail);
}

template <int ES>
int launch_vec(const void* mask, uint32_t keep_lo, uint32_t keep_hi,
               int mask_vectors, const void* x, void* out, int n,
               int row_bytes, int vec_bytes, int zero_tail, int grid,
               int rows_per_cta, int lpr_log2, cudaStream_t s) {
  switch (vec_bytes) {
    case 16:
      launch<ES, uint4>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                        row_bytes, zero_tail, grid, rows_per_cta, lpr_log2, s);
      break;
    case 8:
      launch<ES, uint2>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                        row_bytes, zero_tail, grid, rows_per_cta, lpr_log2, s);
      break;
    case 4:
      launch<ES, uint32_t>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                           row_bytes, zero_tail, grid, rows_per_cta, lpr_log2,
                           s);
      break;
    case 2:
      launch<ES, uint16_t>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                           row_bytes, zero_tail, grid, rows_per_cta, lpr_log2,
                           s);
      break;
    case 1:
      launch<ES, uint8_t>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                          row_bytes, zero_tail, grid, rows_per_cta, lpr_log2,
                          s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mask: (n,) elements of mask_bytes bytes (a row selects when its bits
// under keep_hi:keep_lo are not all zero); mask_vectors: the mask may be
// read as 16-byte vectors (its address is 16-byte aligned).  x, out:
// (n, row_bytes) contiguous rows, moved in vec_bytes words (a divisor of
// row_bytes and of both addresses' alignment).  grid CTAs of
// rows_per_cta rows (a multiple of 16); each row moved by 1 << lpr_log2
// lanes.
int fused_vcompress(const void* mask, int mask_bytes, unsigned keep_lo,
                    unsigned keep_hi, int mask_vectors, const void* x,
                    void* out, int n, int row_bytes, int vec_bytes,
                    int zero_tail, int grid, int rows_per_cta, int lpr_log2,
                    void* stream) {
  if (n == 0 || row_bytes == 0) return 0;
  if (rows_per_cta % 16 != 0 || lpr_log2 < 0 || lpr_log2 > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mask_bytes) {
    case 1:
      return launch_vec<1>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                           row_bytes, vec_bytes, zero_tail, grid, rows_per_cta,
                           lpr_log2, s);
    case 2:
      return launch_vec<2>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                           row_bytes, vec_bytes, zero_tail, grid, rows_per_cta,
                           lpr_log2, s);
    case 4:
      return launch_vec<4>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                           row_bytes, vec_bytes, zero_tail, grid, rows_per_cta,
                           lpr_log2, s);
    case 8:
      return launch_vec<8>(mask, keep_lo, keep_hi, mask_vectors, x, out, n,
                           row_bytes, vec_bytes, zero_tail, grid, rows_per_cta,
                           lpr_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
