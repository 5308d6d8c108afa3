// Fused vcompress: mask -> prefix sums -> destinations -> row moves.
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
// `i + ones_above`, rewritten), so every output row is written once.
//
// What bounds it on this card: device-memory bytes — N * D elements
// read and written, N mask bytes read; no arithmetic on the payload.
//
// What the design does about it: the TPU kernel builds an (N, N) one-hot
// tile and multiplies it on the MXU per D tile, recomputing the prefix
// sums for every tile, which is why N had to fit one VMEM block.  A
// permutation needs no multiply here, so:
//   * one CTA scans the mask (a popcount pass for the total, then a
//     chunked ballot scan with a carry) and writes dest, any N;
//   * a second kernel moves rows, one warp per row, in the widest of
//     16-, 4-, 2- or 1-byte words that the row size and pointers allow;
//     rows are moved as bits, so the payload's dtype does not matter
//     and the move is exact.
//
// Plain C interface, loaded with ctypes.  The entry point launches both
// kernels on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kMoveThreads = 256;
constexpr int kRowsPerCta = kMoveThreads / 32;

__global__ void __launch_bounds__(kScanThreads)
    compress_dest_kernel(const uint8_t* __restrict__ mask, int n,
                         int* __restrict__ dest) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int total_s;
  __shared__ int carry_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  int cnt = 0;
  for (int i = tid; i < n; i += kScanThreads) cnt += mask[i] != 0;
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if (lane == 0) warp_sums[warp] = cnt;
  if (tid == 0) carry_s = 0;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) t += warp_sums[w];
    total_s = t;
  }
  __syncthreads();
  const int total = total_s;

  for (int c0 = 0; c0 < n; c0 += kScanThreads) {  // uniform across the block
    const int i = c0 + tid;
    const bool m = i < n && mask[i] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_sums[warp] = __popc(bits);
    __syncthreads();
    int ones_below = carry_s + __popc(bits & lt_mask);
    for (int w = 0; w < warp; ++w) ones_below += warp_sums[w];
    if (i < n) dest[i] = m ? ones_below : total + (i - ones_below);
    __syncthreads();  // every read of carry_s / warp_sums is done
    if (tid == 0) {
      int s = 0;
      for (int w = 0; w < kScanThreads / 32; ++w) s += warp_sums[w];
      carry_s += s;
    }
    __syncthreads();
  }
}

template <typename V>
__global__ void __launch_bounds__(kMoveThreads)
    compress_move_kernel(const uint8_t* __restrict__ mask,
                         const int* __restrict__ dest,
                         const V* __restrict__ x, V* __restrict__ out, int n,
                         int row_vecs, int zero_tail) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= n) return;
  const bool zero = zero_tail && mask[row] == 0;
  const V* src = x + (size_t)row * row_vecs;
  V* dst = out + (size_t)dest[row] * row_vecs;
  for (int v = lane; v < row_vecs; v += 32) dst[v] = zero ? V{} : src[v];
}

template <typename V>
void launch_move(const uint8_t* mask, const int* dest, const void* x,
                 void* out, int n, int row_bytes, int zero_tail,
                 cudaStream_t s) {
  const int grid = (n + kRowsPerCta - 1) / kRowsPerCta;
  compress_move_kernel<V><<<grid, kMoveThreads, 0, s>>>(
      mask, dest, static_cast<const V*>(x), static_cast<V*>(out), n,
      row_bytes / (int)sizeof(V), zero_tail);
}

}  // namespace

extern "C" {

// mask: (n,) uint8 (non-zero selects); x, out: (n, row_bytes / elem)
// contiguous rows of row_bytes bytes; dest: (n,) int32 scratch, left
// holding each row's destination.
int fused_vcompress(const uint8_t* mask, const void* x, void* out, int* dest,
                    int n, int row_bytes, int zero_tail, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compress_dest_kernel<<<1, kScanThreads, 0, s>>>(mask, n, dest);
  const int err = (int)cudaGetLastError();
  if (err != 0 || row_bytes == 0) return err;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    launch_move<uint4>(mask, dest, x, out, n, row_bytes, zero_tail, s);
  else if (row_bytes % 4 == 0 && align % 4 == 0)
    launch_move<uint32_t>(mask, dest, x, out, n, row_bytes, zero_tail, s);
  else if (row_bytes % 2 == 0 && align % 2 == 0)
    launch_move<uint16_t>(mask, dest, x, out, n, row_bytes, zero_tail, s);
  else
    launch_move<uint8_t>(mask, dest, x, out, n, row_bytes, zero_tail, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
