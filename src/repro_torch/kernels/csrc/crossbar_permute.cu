// The unified permutation crossbar, out = P @ x, on Hopper CUDA cores.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/crossbar_permute.py:
//   * crossbar_permute_pallas (dense grid, body _kernel / _onehot_tile), and
//   * crossbar_permute_sparse_pallas (tile-skipping grid over the
//     CompiledPlan schedule, body _sparse_kernel).
//
// What bounds it on this card: device-memory bytes.  A permutation does
// at most K multiply-adds per output element (K = selects per control
// row, 1 for routing plans, 11 for Keccak's theta-rho-pi), far below the
// ~20 operations per byte where float32 CUDA-core arithmetic would
// become the limit.  The cost is reading x and the int32 control and
// writing out.
//
// What the design does about it:
//   * P is never stored, as on the TPU.  Gather mode reads the K
//     selects of each output row straight from idx and gathers the
//     source rows of x (the "k-select gather" form of the one-hot
//     product): O(n_out * K * D) work instead of the TPU's
//     O(n_out * n_in * D) tile products, and no tensor cores at all —
//     TF32 would keep 10 mantissa bits and corrupt payloads, and true
//     float32 products of 0/1 selects need no matrix unit.
//   * Scatter mode decodes the one-hot columns from idx chunks staged in
//     shared memory.  Each output element (o, d) is owned by exactly one
//     thread, which adds its contributions in (input row, select) order:
//     no atomics, so colliding REAL scatters give the same bits on every
//     run and unique-destination scatters stay exact.
//   * Products are rounded multiply then rounded add (__fmul_rn /
//     __fadd_rn, never a fused FMA), so weighted sums reproduce the plain
//     PyTorch version bit for bit in the same order.
//   * bf16 payloads multiply by bf16-rounded weights (the TPU kernel's
//     compute dtype is x's dtype); the product of two bf16 values is
//     exact in float32, and the sum accumulates in float32.
//   * The sparse kernel runs one CTA per (o-run, d-tile) of the o-major
//     schedule: CUDA blocks have no order, so the TPU's sequential o-run
//     carry becomes a loop over the run's own pairs (CSR offsets built
//     on the host), with no accumulation across CTAs.  Output tiles not
//     in the schedule are not written; apply_plan pins them by coverage.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on
// the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // scatter control entries staged per pass

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float v);
template <>
__device__ __forceinline__ void store_f<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p,
                                                       float v) {
  *p = __float2bfloat16_rn(v);
}

// The weight as the payload's compute dtype sees it.
template <typename T>
__device__ __forceinline__ float weight_f(float w);
template <>
__device__ __forceinline__ float weight_f<float>(float w) {
  return w;
}
template <>
__device__ __forceinline__ float weight_f<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float madd(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// GF(2) accumulate: the float32 sum of 0/1 products is exact below 2^24
// and its parity is the XOR accumulation.
__device__ __forceinline__ float fold2(float r) {
  return r - 2.0f * floorf(r * 0.5f);
}

// Thread layout shared by both kernels: a CTA covers block_o output rows
// and bd payload columns; thread t owns column t % bd of the rows
// congruent to t / bd modulo kThreads / bd.  Every (row, column) element
// of the tile has exactly one owner.

template <typename T, bool kScatter>
__global__ void __launch_bounds__(kThreads)
    crossbar_dense_kernel(const int* __restrict__ idx, const T* __restrict__ x,
                          const float* __restrict__ w,
                          const T* __restrict__ merge, T* __restrict__ out,
                          int k, int n_in, int n_out, int n_ctrl_pad, int d,
                          int bd, int block_o, int fold) {
  const int tid = threadIdx.x;
  const int dl = tid % bd;
  const int rg = tid / bd;
  const int n_rg = kThreads / bd;
  const int o0 = blockIdx.y * block_o;
  const int dcol = blockIdx.x * bd + dl;
  const bool col_ok = dcol < d;

  if (!kScatter) {
    for (int ol = rg; ol < block_o; ol += n_rg) {
      const int o = o0 + ol;
      if (o >= n_out) break;
      const int* row = idx + (size_t)o * k;
      float acc = 0.0f;
      int cov = 0;
      for (int j = 0; j < k; ++j) {
        const int s = row[j];
        if (s >= 0 && s < n_in) {
          ++cov;
          if (col_ok) {
            const float wj = w ? weight_f<T>(w[(size_t)o * k + j]) : 1.0f;
            acc = madd(acc, wj, load_f<T>(x + (size_t)s * d + dcol));
          }
        }
      }
      if (!col_ok) continue;
      float r = fold ? fold2(acc) : acc;
      if (merge != nullptr && cov == 0)
        r = load_f<T>(merge + (size_t)o * d + dcol);
      store_f<T>(out + (size_t)o * d + dcol, r);
    }
    return;
  }

  extern __shared__ float smem[];
  float* acc = smem;                                 // block_o * bd
  int* cov = reinterpret_cast<int*>(acc + block_o * bd);   // block_o
  int* c_idx = cov + block_o;                        // kChunk
  float* c_w = reinterpret_cast<float*>(c_idx + kChunk);   // kChunk
  for (int e = tid; e < block_o * bd; e += kThreads) acc[e] = 0.0f;
  for (int e = tid; e < block_o; e += kThreads) cov[e] = 0;
  __syncthreads();

  const long long total = (long long)n_ctrl_pad * k;
  for (long long base = 0; base < total; base += kChunk) {
    const int cnt = (int)min((long long)kChunk, total - base);
    for (int e = tid; e < cnt; e += kThreads) {
      c_idx[e] = idx[base + e];
      c_w[e] = w ? w[base + e] : 1.0f;
    }
    __syncthreads();
    for (int e = 0; e < cnt; ++e) {
      const int ol = c_idx[e] - o0;
      if (ol < 0 || ol >= block_o || o0 + ol >= n_out) continue;
      if (ol % n_rg != rg) continue;
      if (dl == 0) cov[ol] += 1;
      if (col_ok) {
        const int i = (int)((base + e) / k);
        const float v = load_f<T>(x + (size_t)i * d + dcol);
        float* a = acc + ol * bd + dl;
        *a = madd(*a, weight_f<T>(c_w[e]), v);
      }
    }
    __syncthreads();
  }

  for (int ol = rg; ol < block_o; ol += n_rg) {
    const int o = o0 + ol;
    if (o >= n_out) break;
    if (!col_ok) continue;
    float r = acc[ol * bd + dl];
    if (fold) r = fold2(r);
    if (merge != nullptr && cov[ol] == 0)
      r = load_f<T>(merge + (size_t)o * d + dcol);
    store_f<T>(out + (size_t)o * d + dcol, r);
  }
}

template <typename T, bool kScatter>
__global__ void __launch_bounds__(kThreads)
    crossbar_sparse_kernel(const int* __restrict__ run_o,
                           const int* __restrict__ run_ptr,
                           const int* __restrict__ pair_n,
                           const int* __restrict__ idx,
                           const T* __restrict__ x,
                           const float* __restrict__ w, T* __restrict__ out,
                           int k, int n_in, int n_out, int d, int bd,
                           int block_o, int block_n, int fold) {
  extern __shared__ float acc[];  // block_o * bd, one owner per element
  const int tid = threadIdx.x;
  const int dl = tid % bd;
  const int rg = tid / bd;
  const int n_rg = kThreads / bd;
  const int run = blockIdx.y;
  const int o0 = run_o[run] * block_o;
  const int dcol = blockIdx.x * bd + dl;
  const bool col_ok = dcol < d;

  // Element e = ol * bd + dl with ol = rg + j * n_rg: exactly the
  // elements this thread owns, so no barrier is needed anywhere.
  for (int e = tid; e < block_o * bd; e += kThreads) acc[e] = 0.0f;

  for (int p = run_ptr[run]; p < run_ptr[run + 1]; ++p) {
    const int n0 = pair_n[p] * block_n;
    const int n1 = min(n0 + block_n, n_in);
    if (!kScatter) {
      for (int ol = rg; ol < block_o; ol += n_rg) {
        const int o = o0 + ol;
        if (o >= n_out) break;
        if (!col_ok) continue;
        float a = acc[ol * bd + dl];
        for (int j = 0; j < k; ++j) {
          const int s = idx[(size_t)o * k + j];
          if (s >= n0 && s < n1) {
            const float wj = w ? weight_f<T>(w[(size_t)o * k + j]) : 1.0f;
            a = madd(a, wj, load_f<T>(x + (size_t)s * d + dcol));
          }
        }
        acc[ol * bd + dl] = a;
      }
    } else {
      for (int i = n0; i < n1; ++i) {
        for (int j = 0; j < k; ++j) {
          const int ol = idx[(size_t)i * k + j] - o0;
          if (ol < 0 || ol >= block_o || o0 + ol >= n_out) continue;
          if (ol % n_rg != rg || !col_ok) continue;
          const float wj = w ? weight_f<T>(w[(size_t)i * k + j]) : 1.0f;
          float* a = acc + ol * bd + dl;
          *a = madd(*a, wj, load_f<T>(x + (size_t)i * d + dcol));
        }
      }
    }
  }

  for (int ol = rg; ol < block_o; ol += n_rg) {
    const int o = o0 + ol;
    if (o >= n_out) break;
    if (!col_ok) continue;
    float r = acc[ol * bd + dl];
    if (fold) r = fold2(r);
    store_f<T>(out + (size_t)o * d + dcol, r);
  }
}

int pick_bd(int d) {
  int bd = 1;
  while (bd < d && bd < 32) bd <<= 1;
  return bd;
}

template <typename T, bool kScatter>
void launch_dense(const int* idx, const void* x, const float* w,
                  const void* merge, void* out, int k, int n_in, int n_out,
                  int n_ctrl_pad, int d, int block_o, int fold,
                  cudaStream_t stream) {
  const int bd = pick_bd(d);
  dim3 grid((d + bd - 1) / bd, (n_out + block_o - 1) / block_o);
  size_t smem = kScatter ? (size_t)block_o * bd * sizeof(float) +
                               (size_t)block_o * sizeof(int) +
                               (size_t)kChunk * (sizeof(int) + sizeof(float))
                         : 0;
  crossbar_dense_kernel<T, kScatter><<<grid, kThreads, smem, stream>>>(
      idx, static_cast<const T*>(x), w, static_cast<const T*>(merge),
      static_cast<T*>(out), k, n_in, n_out, n_ctrl_pad, d, bd, block_o, fold);
}

template <typename T, bool kScatter>
void launch_sparse(const int* run_o, const int* run_ptr, const int* pair_n,
                   int n_runs, const int* idx, const void* x, const float* w,
                   void* out, int k, int n_in, int n_out, int d, int block_o,
                   int block_n, int fold, cudaStream_t stream) {
  const int bd = pick_bd(d);
  dim3 grid((d + bd - 1) / bd, n_runs);
  size_t smem = (size_t)block_o * bd * sizeof(float);
  crossbar_sparse_kernel<T, kScatter><<<grid, kThreads, smem, stream>>>(
      run_o, run_ptr, pair_n, idx, static_cast<const T*>(x), w,
      static_cast<T*>(out), k, n_in, n_out, d, bd, block_o, block_n, fold);
}

}  // namespace

extern "C" {

// idx: (n_ctrl_pad, k) int32, control rows DROP-padded; x: (n_in, d)
// float32 or bf16; w: like idx (float32) or null; merge: (n_out, d) in
// x's dtype or null; out: (n_out, d) in x's dtype.
int xb_dense(const int* idx, const void* x, const float* w, const void* merge,
             void* out, int k, int n_in, int n_out, int n_ctrl_pad, int d,
             int scatter, int bf16, int fold, int block_o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (scatter)
      launch_dense<__nv_bfloat16, true>(idx, x, w, merge, out, k, n_in, n_out,
                                        n_ctrl_pad, d, block_o, fold, s);
    else
      launch_dense<__nv_bfloat16, false>(idx, x, w, merge, out, k, n_in,
                                         n_out, n_ctrl_pad, d, block_o, fold,
                                         s);
  } else {
    if (scatter)
      launch_dense<float, true>(idx, x, w, merge, out, k, n_in, n_out,
                                n_ctrl_pad, d, block_o, fold, s);
    else
      launch_dense<float, false>(idx, x, w, merge, out, k, n_in, n_out,
                                 n_ctrl_pad, d, block_o, fold, s);
  }
  return (int)cudaGetLastError();
}

// run_o: (n_runs,) output tile of each o-run; run_ptr: (n_runs + 1,) CSR
// offsets into pair_n, the n-tiles of the o-major schedule.
int xb_sparse(const int* run_o, const int* run_ptr, const int* pair_n,
              int n_runs, const int* idx, const void* x, const float* w,
              void* out, int k, int n_in, int n_out, int d, int scatter,
              int bf16, int fold, int block_o, int block_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (scatter)
      launch_sparse<__nv_bfloat16, true>(run_o, run_ptr, pair_n, n_runs, idx,
                                         x, w, out, k, n_in, n_out, d, block_o,
                                         block_n, fold, s);
    else
      launch_sparse<__nv_bfloat16, false>(run_o, run_ptr, pair_n, n_runs, idx,
                                          x, w, out, k, n_in, n_out, d,
                                          block_o, block_n, fold, s);
  } else {
    if (scatter)
      launch_sparse<float, true>(run_o, run_ptr, pair_n, n_runs, idx, x, w,
                                 out, k, n_in, n_out, d, block_o, block_n,
                                 fold, s);
    else
      launch_sparse<float, false>(run_o, run_ptr, pair_n, n_runs, idx, x, w,
                                  out, k, n_in, n_out, d, block_o, block_n,
                                  fold, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
