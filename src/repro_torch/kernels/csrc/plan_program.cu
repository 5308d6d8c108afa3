// The plan-program megakernel: a bytecode VM that runs a whole
// PlanProgram (every round, every step) in one launch.
//
// Replaces the Pallas TPU kernel plan_program_pallas of
// src/repro/kernels/plan_program_kernel.py (body _kernel, _rotlv).
//
// What bounds it on this card: shared-memory and integer throughput, not
// device memory.  Device-memory traffic is only the state in and out
// (2 x n x 4 bytes a lane) plus the control tables; the work is the
// PERMUTE gathers — for Keccak-f[1600], 24 rounds x 13 selects x 1600
// rows a lane — and the elementwise steps, all on the register file.
//
// What the design does about it:
//   * Lanes (payload columns) are independent, and a PERMUTE may read any
//     row, so a lane is never split: each CTA owns `lanes` whole lanes and
//     keeps their register file — n_regs registers plus one scratch
//     register, each n x lanes uint32 — in dynamic shared memory (above
//     48 KB after cudaFuncSetAttribute).  The host derives `lanes` from
//     n, n_regs and the card's opt-in limit (227 KB on an H100: 8 Keccak
//     lanes, so 1024 lanes make 128 CTAs on 132 SMs).
//   * The step stream and the per-plan vectors are read uniformly by all
//     threads (broadcast loads); __syncthreads() separates steps.
//   * A PERMUTE whose destination is its source gathers into the scratch
//     register and copies back — never an in-place update that other
//     threads are still reading.
//   * Everything computes in uint32: ADD wraps without signed-overflow
//     UB and ROTLV's right shift is logical.  int32 states are bit-cast
//     through the launch.  Invalid sources (< 0 or >= n) contribute 0;
//     the XOR fold accumulates g & 1, the ADD fold g * w with wrap-around.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Must match OPCODES in plan_program_kernel.py (and the IR's OPS order).
enum Op : int {
  kPermute = 0,
  kXor = 1,
  kAnd = 2,
  kAndn = 3,
  kAdd = 4,
  kRotlv = 5,
  kXorConst = 6,
  kEqConst = 7,
};

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    plan_program_kernel(const uint32_t* __restrict__ state,
                        uint32_t* __restrict__ out,
                        const int* __restrict__ steps, int n_steps,
                        const int* __restrict__ plan_tbl,
                        const int* __restrict__ koff,
                        const int* __restrict__ kcnt,
                        const int* __restrict__ folds,
                        const int* __restrict__ w_flat,
                        const int* __restrict__ woff,
                        const int* __restrict__ consts, int n, int d,
                        int n_regs, int rounds, int const_stride, int lanes) {
  extern __shared__ uint32_t regs[];  // (n_regs + 1) x n x lanes
  const int l0 = blockIdx.x * lanes;
  const int live = min(lanes, d - l0);  // lanes of this CTA inside d
  const int per = n * lanes;            // words per register
  uint32_t* scratch = regs + (size_t)n_regs * per;

  for (int e = threadIdx.x; e < per; e += kThreads) {
    const int r = e / lanes;
    const int l = e - r * lanes;
    regs[e] = l < live ? state[(size_t)r * d + l0 + l] : 0u;
    for (int q = 1; q <= n_regs; ++q) regs[(size_t)q * per + e] = 0u;
  }
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    for (int s = 0; s < n_steps; ++s) {
      const int* st = steps + 6 * s;
      const int op = st[0], dst = st[1], a = st[2], b = st[3], p = st[4],
                c = st[5];
      const uint32_t* A = regs + (size_t)a * per;
      const uint32_t* B = regs + (size_t)b * per;
      uint32_t* D = regs + (size_t)dst * per;
      if (op == kPermute) {
        uint32_t* T = dst == a ? scratch : D;
        const int base = koff[p], cnt = kcnt[p], wb = woff[p];
        const bool xor_fold = folds[p] != 0;
        for (int e = threadIdx.x; e < per; e += kThreads) {
          const int r = e / lanes;
          const int l = e - r * lanes;
          uint32_t acc_add = 0u, acc_xor = 0u;
          for (int j = 0; j < cnt; ++j) {
            const int src = plan_tbl[(size_t)(base + j) * n + r];
            if (src >= 0 && src < n) {
              uint32_t g = A[src * lanes + l];
              if (wb >= 0) g *= (uint32_t)w_flat[(size_t)(wb + j) * n + r];
              acc_add += g;
              acc_xor ^= g & 1u;
            }
          }
          T[e] = xor_fold ? acc_xor : acc_add;
        }
        if (dst == a) {
          __syncthreads();
          for (int e = threadIdx.x; e < per; e += kThreads) D[e] = T[e];
        }
      } else if (op == kRotlv || op == kXorConst || op == kEqConst) {
        const int* crow = consts + (size_t)(c + rnd * const_stride) * n;
        for (int e = threadIdx.x; e < per; e += kThreads) {
          const uint32_t v = A[e];
          const uint32_t k = (uint32_t)crow[e / lanes];
          uint32_t res;
          if (op == kRotlv) {
            const uint32_t left = k < 32u ? (v << k) : 0u;
            res = left | (v >> ((32u - k) & 31u));
          } else if (op == kXorConst) {
            res = v ^ k;
          } else {
            res = v == k ? 1u : 0u;
          }
          D[e] = res;
        }
      } else {
        for (int e = threadIdx.x; e < per; e += kThreads) {
          const uint32_t av = A[e], bv = B[e];
          uint32_t res;
          switch (op) {
            case kXor: res = av ^ bv; break;
            case kAnd: res = av & bv; break;
            case kAndn: res = ~av & bv; break;
            default: res = av + bv; break;  // kAdd
          }
          D[e] = res;
        }
      }
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < per; e += kThreads) {
    const int r = e / lanes;
    const int l = e - r * lanes;
    if (l < live) out[(size_t)r * d + l0 + l] = regs[e];
  }
}

}  // namespace

extern "C" {

// The largest dynamic shared memory a block may opt in to.
int pp_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// state/out: (n, d) 32-bit words; steps: (n_steps, 6) int32 rows of
// (opcode, dst, a, b, plan, const); plan_tbl: (K_total, n); koff/kcnt/
// folds/woff: (n_plans,); w_flat: (KW_total, n) or null; consts:
// (n_consts, n).  `lanes` payload columns per CTA.
int pp_megakernel(const void* state, void* out, const int* steps,
                  int n_steps, const int* plan_tbl, const int* koff,
                  const int* kcnt, const int* folds, const int* w_flat,
                  const int* woff, const int* consts, int n, int d,
                  int n_regs, int rounds, int const_stride, int lanes,
                  void* stream) {
  const size_t smem = (size_t)(n_regs + 1) * n * lanes * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      plan_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d + lanes - 1) / lanes;
  plan_program_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state), static_cast<uint32_t*>(out), steps,
      n_steps, plan_tbl, koff, kcnt, folds, w_flat, woff, consts, n, d,
      n_regs, rounds, const_stride, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
