// The plan-program megakernel: a bytecode VM that runs a whole
// PlanProgram (every round, every step) in one launch, in one of two
// layouts of its register file.
//
// Replaces the Pallas TPU kernel plan_program_pallas of
// src/repro/kernels/plan_program_kernel.py (body _kernel, _rotlv).
//
// What bounds it on this card.  Device-memory traffic is the state in
// and out (2 x n x 4 bytes a lane) plus the control tables; the work is
// the PERMUTE gathers — for Keccak-f[1600], 24 rounds x 13 selects x 1600
// rows — and the elementwise steps, all on a register file in shared
// memory (or, for the word layout's largest programs, in global memory),
// with block-wide barriers between dependent steps.  At 1024 lanes the
// bytes take ~4 us; what the kernel takes beyond that is the latency of
// 24 rounds of dependent steps and the shared-memory instructions in
// them.  AES-128-GCM's programs (word layout, 424 to ~8000 steps) are
// set by the select slots the PERMUTE loop walks: every row at its
// plan's widest row (k = 142 for GHASH's absorb plan), one control load
// a slot, 26x the live selects at 1500-byte records.
//
// Both layouts:
//   * The step stream comes from the host already renamed: a PERMUTE
//     whose destination is its source writes a free physical register,
//     which then takes the destination's name (the host's table repeats
//     with the renaming's period, `period` rounds, and names the
//     physical register that holds register 0 at the end).  No copy back
//     and no extra barrier; where the period would be long, the host
//     copies back with an AND step instead.
//   * A thread owns the same rows of every register in every step, so
//     only a PERMUTE crosses threads: the host flags the steps that need a
//     block barrier before them (a PERMUTE reading a register written
//     since the last barrier, a write to a register a PERMUTE read since
//     then) and renames writes away from registers a PERMUTE is reading.
//     Keccak-f[1600] needs 2 barriers a round, not 6.
//   * No divide: lanes per CTA are a power of two, and a thread's row and
//     lane come from shifts.
//
// The packed layout (GF(2) programs, 32 lanes a word).  For a program the
// host has proved bit-sliceable — unweighted XOR-fold or single-select
// PERMUTEs, XOR, AND, ANDN, XOR_CONST with 0/1 constants, register 0
// ending with zero high bits — every value that matters is bit 0, so one
// uint32 word carries one row of 32 lanes.  Keccak's register file (3 + 1
// registers x 1600 rows) is 25.6 KB for 32 lanes, where the word layout
// fits 8 lanes in 227 KB.  Each CTA owns one word column (32 lanes):
//   * in: the state's rows (32 lanes, 128 B each) go to shared memory by
//     cp.async, as many rows at once as the space behind the register
//     file holds (two chunks of 800 rows for Keccak), and a warp's
//     __ballot_sync of bit 0 of a row makes its word; out: each lane
//     writes its bit back as an int32 0/1, 128 B a row;
//   * control: the step table (each step resolved by the host to its
//     registers' offsets and its plan's rows and selects, 32 bytes; at
//     most 120 steps) is a kernel parameter: all threads read the same
//     step, which the constant cache broadcasts — read from shared memory
//     it cost two 16-byte loads a warp a step, a fifth of a step's
//     shared-memory instructions.  The plan rows as uint16 and the
//     constant rows as bits are one blob, staged into shared memory by
//     cp.async under the state loads;
//   * PERMUTE is the XOR of the gathered words, four selects at a time so
//     that their loads are independent.  A register has n + 1 words, the
//     last always 0, and a select with no source reads it: a select is a
//     control load, a gather and an XOR, with no compare or predicate.
//     Keccak's gathers are conflict-free.  XOR_CONST XORs 0 or ~0u a row.
//     A thread takes its two rows of a step together (1600 rows, 1024
//     threads), all loads before the stores.
//   What sets its time is one CTA's stream of shared-memory instructions
//   through 24 rounds (for Keccak ~1900 warp-wide loads and stores a
//   round): the time is the same at 32 lanes as at 1024, and at 416 to
//   1024 threads a CTA.  1024 lanes are only 32 words, so 100 of 132 SMs
//   idle; sharing a word's rows among a cluster of 4 CTAs (a copy of the
//   registers in each, results written to all four through distributed
//   shared memory, cluster barriers) was tried and was slower at 1024
//   lanes.
//
// The word layout (every other program: ADD, ROTLV, EQ_CONST, ADD-fold or
// weighted plans, any register that may carry high bits).  One uint32
// word a lane a row, as the reference: each CTA owns `lanes` whole lanes
// (a PERMUTE may read any row, so a lane is never split), register file
// laid out (register, row, lane), row r's lanes contiguous, in one of two
// places:
//   * shared: dynamic shared memory (above 48 KB after
//     cudaFuncSetAttribute), where one lane's file, n_phys x n x 4 bytes,
//     fits the 232448-byte opt-in (n <= 11622 at 5 physical registers);
//   * global: a scratch tensor the wrapper allocates for the launch, one
//     slab a CTA, for larger programs (AES-128-GCM over a 1500-byte
//     record: n = 12640, 253 KB a lane).  The same VM over the same
//     layout: a warp's neighbouring threads still read neighbouring
//     words, the block barrier still orders the steps (it orders global
//     as well as shared accesses within the block), and the files of the
//     lanes in flight stay in the 50 MB L2 (64 lanes of GCM's 253 KB:
//     16 MB).  Each register access is then an L1/L2 access, not a
//     shared-memory one.  A thread takes up to 4 lanes of one row as one
// 16-byte shared-memory vector, so each select's control (plan row,
// weight) is read from global memory once per 4 lanes, not once a lane.
// A program's steps are a chain of dependent latencies (a control load,
// a plan-row load, a shared-memory gather, a barrier), so the host gives
// a CTA no more lanes than keep the grid as large as the card's SM count
// and one thread a 4-lane group of a row (lanes_per_cta, word_threads):
// ChaCha20 at 16384 lanes runs 256 CTAs of 256 threads, not 16 of 1024.
// Everything computes in uint32: ADD wraps without signed-overflow UB and
// ROTLV's right shift is logical.  int32 states are bit-cast through the
// launch.  Invalid sources (< 0 or >= n) contribute 0; the XOR fold
// accumulates g & 1, the ADD fold g * w with wrap-around.
//
// Plain C interface, loaded with ctypes; each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
constexpr int kMaxPackedSteps = 120;  // PackedSteps: 3840 bytes of params

// ------------------------------------------------------------ word layout

template <int V>
struct alignas(4 * V) Words {
  uint32_t w[V];
};

template <int V, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    pp_word_kernel(const uint32_t* __restrict__ state,
                   uint32_t* __restrict__ out, const int* __restrict__ steps,
                   int n_steps, int period, const int* __restrict__ plan_tbl,
                   const int* __restrict__ koff, const int* __restrict__ kcnt,
                   const int* __restrict__ folds,
                   const int* __restrict__ w_flat,
                   const int* __restrict__ woff,
                   const int* __restrict__ consts, int n, int d, int n_phys,
                   int rounds, int const_stride, int lanes_log2,
                   int out_reg, uint32_t* file) {
  extern __shared__ uint4 smem_w[];
  const int nthr = blockDim.x;
  const int lanes = 1 << lanes_log2;
  const int l0 = blockIdx.x << lanes_log2;
  const int live = min(lanes, d - l0);  // lanes of this CTA inside d
  const int per = n << lanes_log2;      // words per register
  // the register file: this CTA's slab of the global scratch, or shared
  uint32_t* regs =
      kGlobal ? file + (size_t)blockIdx.x * n_phys * per
              : reinterpret_cast<uint32_t*>(smem_w);
  constexpr int kVlog2 = V == 4 ? 2 : (V == 2 ? 1 : 0);
  const int glog2 = lanes_log2 - kVlog2;  // V-word groups a row, log2
  const int n_el = n << glog2;            // V-word groups a register

  for (int e = threadIdx.x; e < per; e += nthr) {
    const int r = e >> lanes_log2;
    const int l = e & (lanes - 1);
    regs[e] = l < live ? state[(size_t)r * d + l0 + l] : 0u;
    for (int q = 1; q < n_phys; ++q) regs[(size_t)q * per + e] = 0u;
  }
  __syncthreads();

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const int* st_round = steps + (size_t)(rnd % period) * n_steps * 7;
    for (int s = 0; s < n_steps; ++s) {
      const int* st = st_round + 7 * s;
      const int op = st[0], dst = st[1], a = st[2], b = st[3], p = st[4],
                c = st[5];
      if (st[6]) __syncthreads();  // the host's barrier flag
      const Words<V>* A =
          reinterpret_cast<const Words<V>*>(regs + (size_t)a * per);
      const Words<V>* B =
          reinterpret_cast<const Words<V>*>(regs + (size_t)b * per);
      Words<V>* D = reinterpret_cast<Words<V>*>(regs + (size_t)dst * per);
      if (op == kPermute) {  // the host guarantees dst != a
        const int base = koff[p], cnt = kcnt[p], wb = woff[p];
        const bool xor_fold = folds[p] != 0;
        for (int el = threadIdx.x; el < n_el; el += nthr) {
          const int r = el >> glog2;
          const int q = el & ((1 << glog2) - 1);
          uint32_t acc_add[V] = {}, acc_xor[V] = {};
#pragma unroll 4
          for (int j = 0; j < cnt; ++j) {
            const int src = __ldg(plan_tbl + (size_t)(base + j) * n + r);
            if ((unsigned)src < (unsigned)n) {
              const Words<V> g = A[((size_t)src << glog2) + q];
              const uint32_t w =
                  wb >= 0 ? (uint32_t)__ldg(w_flat + (size_t)(wb + j) * n + r)
                          : 1u;
#pragma unroll
              for (int i = 0; i < V; ++i) {
                const uint32_t gi = g.w[i] * w;
                acc_add[i] += gi;
                acc_xor[i] ^= gi & 1u;
              }
            }
          }
          Words<V> res;
#pragma unroll
          for (int i = 0; i < V; ++i)
            res.w[i] = xor_fold ? acc_xor[i] : acc_add[i];
          D[el] = res;
        }
      } else if (op == kRotlv || op == kXorConst || op == kEqConst) {
        const int* crow = consts + (size_t)(c + rnd * const_stride) * n;
        for (int el = threadIdx.x; el < n_el; el += nthr) {
          const uint32_t k = (uint32_t)__ldg(crow + (el >> glog2));
          const Words<V> v = A[el];
          Words<V> res;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const uint32_t x = v.w[i];
            if (op == kRotlv) {
              const uint32_t left = k < 32u ? (x << k) : 0u;
              res.w[i] = left | (x >> ((32u - k) & 31u));
            } else if (op == kXorConst) {
              res.w[i] = x ^ k;
            } else {
              res.w[i] = x == k ? 1u : 0u;
            }
          }
          D[el] = res;
        }
      } else {
        for (int el = threadIdx.x; el < n_el; el += nthr) {
          const Words<V> av = A[el], bv = B[el];
          Words<V> res;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            switch (op) {
              case kXor: res.w[i] = av.w[i] ^ bv.w[i]; break;
              case kAnd: res.w[i] = av.w[i] & bv.w[i]; break;
              case kAndn: res.w[i] = ~av.w[i] & bv.w[i]; break;
              default: res.w[i] = av.w[i] + bv.w[i]; break;  // kAdd
            }
          }
          D[el] = res;
        }
      }
    }
  }
  __syncthreads();

  const uint32_t* R = regs + (size_t)out_reg * per;
  for (int e = threadIdx.x; e < per; e += nthr) {
    const int r = e >> lanes_log2;
    const int l = e & (lanes - 1);
    if (l < live) out[(size_t)r * d + l0 + l] = R[e];
  }
}

template <int V, bool kGlobal>
int launch_word_at(const void* state, void* out, const int* steps,
                   int n_steps, int period, const int* plan_tbl,
                   const int* koff, const int* kcnt, const int* folds,
                   const int* w_flat, const int* woff, const int* consts,
                   int n, int d, int n_phys, int rounds, int const_stride,
                   int lanes_log2, int threads, int out_reg, void* file,
                   cudaStream_t s) {
  const size_t smem =
      kGlobal ? 0 : ((size_t)n_phys * n * sizeof(uint32_t)) << lanes_log2;
  cudaError_t err = cudaFuncSetAttribute(
      pp_word_kernel<V, kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d + (1 << lanes_log2) - 1) >> lanes_log2;
  pp_word_kernel<V, kGlobal><<<grid, threads, smem, s>>>(
      static_cast<const uint32_t*>(state), static_cast<uint32_t*>(out), steps,
      n_steps, period, plan_tbl, koff, kcnt, folds, w_flat, woff, consts, n,
      d, n_phys, rounds, const_stride, lanes_log2, out_reg,
      static_cast<uint32_t*>(file));
  return (int)cudaGetLastError();
}

template <int V>
int launch_word(const void* state, void* out, const int* steps, int n_steps,
                int period, const int* plan_tbl, const int* koff,
                const int* kcnt, const int* folds, const int* w_flat,
                const int* woff, const int* consts, int n, int d, int n_phys,
                int rounds, int const_stride, int lanes_log2, int threads,
                int out_reg, void* file, cudaStream_t s) {
  if (file != nullptr)
    return launch_word_at<V, true>(state, out, steps, n_steps, period,
                                   plan_tbl, koff, kcnt, folds, w_flat, woff,
                                   consts, n, d, n_phys, rounds, const_stride,
                                   lanes_log2, threads, out_reg, file, s);
  return launch_word_at<V, false>(state, out, steps, n_steps, period,
                                  plan_tbl, koff, kcnt, folds, w_flat, woff,
                                  consts, n, d, n_phys, rounds, const_stride,
                                  lanes_log2, threads, out_reg, file, s);
}

// ---------------------------------------------------------- packed layout

// The packed layout's renamed step table, passed by value as a kernel
// parameter: every thread reads the same step at the same time, which the
// constant cache broadcasts without a shared-memory instruction.  A step
// is two int4: (op, dst, a, b) with the registers as word offsets, then
// (plan row offset in uint16 words, selects, const row, barrier flag).
struct PackedSteps {
  int4 row[2 * kMaxPackedSteps];
};

__global__ void __launch_bounds__(kThreads)
    pp_packed_kernel(const uint32_t* __restrict__ state,
                     uint32_t* __restrict__ out, const __grid_constant__
                     PackedSteps steps, const int4* __restrict__ blob,
                     int blob_words, int off_cbits, int n_steps, int period,
                     int n, int d, int n_phys, int rounds, int const_stride,
                     int out_reg, int chunk, int vec_state) {
  extern __shared__ int4 smem_p[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // the control blob goes to shared memory by cp.async, under the state
  // loads below
  for (int i = tid; i < blob_words / 4; i += nthr) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem_p + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(blob + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const uint16_t* plan = reinterpret_cast<const uint16_t*>(smem_p);
  const uint32_t* cbits = reinterpret_cast<const uint32_t*>(smem_p) +
                          off_cbits;
  // registers of n + 1 words: row n stays 0, the source of every select
  // that has none
  uint32_t* regs = reinterpret_cast<uint32_t*>(smem_p) + blob_words;
  const int stride = n + 1;
  const int cwords = (n + 31) >> 5;  // words of one constant row
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int col0 = blockIdx.x << 5;  // this CTA's first payload lane

  for (int e = n + tid; e < n_phys * stride; e += nthr) regs[e] = 0u;
  // in: register 0 <- bit 0 of 32 lanes a row.  The rows go to a staging
  // area of shared memory behind the register file by cp.async, `chunk`
  // rows (128 B each) at a time, all of a chunk in flight together; a
  // warp then reads a row there and __ballot_sync of bit 0 makes the word.
  uint32_t* stage = regs + ((n_phys * stride + 3) & ~3);  // 16-B aligned
  for (int c0 = 0; c0 < n; c0 += chunk) {
    const int rows_c = min(chunk, n - c0);
    for (int i = tid; i < rows_c * 8; i += nthr) {  // 8 x 16 B a row
      const int r = c0 + (i >> 3);
      const int l = (i & 7) * 4;  // first lane of this 16 B
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(stage + (i >> 3) * 32 + l));
      // 4 lanes go by one 16-byte cp.async where they lie inside d and
      // the rows are 16-byte aligned, else lane by lane (zeros past d)
      const int c = col0 + l;
      if (vec_state && c + 4 <= d)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(state + (size_t)r * d + c));
      else
        for (int k = 0; k < 4; ++k)
          stage[(i >> 3) * 32 + l + k] =
              c + k < d ? __ldg(state + (size_t)r * d + c + k) : 0u;
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int r = warp; r < rows_c; r += nwarps) {
      const uint32_t word =
          __ballot_sync(0xffffffffu, stage[r * 32 + lane] & 1u);
      if (lane == 0) regs[c0 + r] = word;
    }
    __syncthreads();
  }

  for (int rnd = 0, base = 0; rnd < rounds; ++rnd) {
    for (int s = 0; s < n_steps; ++s) {
      const int4 head = steps.row[base + 2 * s];
      const int4 tail = steps.row[base + 2 * s + 1];
      const int op = head.x;
      const uint32_t* A = regs + head.z;
      const uint32_t* B = regs + head.w;
      uint32_t* D = regs + head.y;
      if (tail.w) __syncthreads();  // the host's barrier flag
      // Each thread takes rows r and r + nthr together, their loads
      // issued before either store (a step may run in place, so the
      // compiler would not hoist the second row's loads on its own).
      if (op == kPermute) {  // the host guarantees dst != a
        const uint16_t* P = plan + tail.x;
        const int cnt = tail.y;
        for (int r = tid; r < n; r += 2 * nthr) {
          const int r1 = r + nthr;
          const uint16_t* p0 = P + r;
          const uint16_t* p1 = P + (r1 < n ? r1 : r);
          uint32_t acc0 = 0u, acc1 = 0u;
          int j = 0;
          for (; j + 4 <= cnt; j += 4, p0 += 4 * n, p1 += 4 * n) {
            acc0 ^= (A[p0[0]] ^ A[p0[n]]) ^ (A[p0[2 * n]] ^ A[p0[3 * n]]);
            acc1 ^= (A[p1[0]] ^ A[p1[n]]) ^ (A[p1[2 * n]] ^ A[p1[3 * n]]);
          }
          switch (cnt - j) {
            case 3:
              acc0 ^= A[p0[2 * n]];
              acc1 ^= A[p1[2 * n]];  // fall through
            case 2:
              acc0 ^= A[p0[n]];
              acc1 ^= A[p1[n]];  // fall through
            case 1:
              acc0 ^= A[p0[0]];
              acc1 ^= A[p1[0]];
            default:
              break;
          }
          D[r] = acc0;
          if (r1 < n) D[r1] = acc1;
        }
      } else {
        const uint32_t* crow =
            cbits + (size_t)(tail.z + rnd * const_stride) * cwords;
        for (int r = tid; r < n; r += 2 * nthr) {
          const int r1 = r + nthr;
          const int q = r1 < n ? r1 : r;
          const uint32_t a0 = A[r], a1 = A[q];
          uint32_t b0, b1;
          if (op == kXorConst) {
            b0 = 0u - ((crow[r >> 5] >> (r & 31)) & 1u);
            b1 = 0u - ((crow[q >> 5] >> (q & 31)) & 1u);
          } else {
            b0 = B[r];
            b1 = B[q];
          }
          uint32_t d0, d1;
          if (op == kAnd) {
            d0 = a0 & b0;
            d1 = a1 & b1;
          } else if (op == kAndn) {
            d0 = ~a0 & b0;
            d1 = ~a1 & b1;
          } else {  // kXor, kXorConst: the host admits no other op here
            d0 = a0 ^ b0;
            d1 = a1 ^ b1;
          }
          D[r] = d0;
          if (r1 < n) D[r1] = d1;
        }
      }
    }
    base = base + 2 * n_steps == 2 * n_steps * period ? 0 : base + 2 * n_steps;
  }
  __syncthreads();

  // out: each lane its bit of the word, as an int32 0/1
  const uint32_t* R = regs + out_reg * stride;
  const int col = col0 + lane;
  for (int r = warp; r < n; r += nwarps) {
    const uint32_t word = R[r];
    if (col < d) out[(size_t)r * d + col] = (word >> lane) & 1u;
  }
}

}  // namespace

extern "C" {

// The largest dynamic shared memory a block may opt in to.
int pp_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Word layout.  state/out: (n, d) 32-bit words; steps: (period x n_steps,
// 7) int32 rows of (opcode, dst, a, b, plan, const, barrier) over n_phys
// physical registers, renamed by the host; plan_tbl: (K_total, n); koff/kcnt/
// folds/woff: (n_plans,); w_flat: (KW_total, n) or null; consts:
// (n_consts, n).  1 << lanes_log2 payload columns per CTA of `threads`
// threads (a multiple of 32, at most 1024); register 0 is physical
// register out_reg at the end.  file: null for the register file in
// shared memory, else global scratch of grid x n_phys x (n << lanes_log2)
// words (grid = ceil(d / lanes)), one slab a CTA.
int pp_megakernel(const void* state, void* out, const int* steps,
                  int n_steps, int period, const int* plan_tbl,
                  const int* koff, const int* kcnt, const int* folds,
                  const int* w_flat, const int* woff, const int* consts,
                  int n, int d, int n_phys, int rounds, int const_stride,
                  int lanes_log2, int threads, int out_reg, void* file,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > kThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (lanes_log2 >= 2)
    return launch_word<4>(state, out, steps, n_steps, period, plan_tbl, koff,
                          kcnt, folds, w_flat, woff, consts, n, d, n_phys,
                          rounds, const_stride, lanes_log2, threads, out_reg,
                          file, s);
  if (lanes_log2 == 1)
    return launch_word<2>(state, out, steps, n_steps, period, plan_tbl, koff,
                          kcnt, folds, w_flat, woff, consts, n, d, n_phys,
                          rounds, const_stride, lanes_log2, threads, out_reg,
                          file, s);
  return launch_word<1>(state, out, steps, n_steps, period, plan_tbl, koff,
                        kcnt, folds, w_flat, woff, consts, n, d, n_phys,
                        rounds, const_stride, lanes_log2, threads, out_reg,
                        file, s);
}

// Packed layout.  state/out: (n, d) 32-bit words (bit 0 read, 0/1
// written); host_steps: n_rows (= period x n_steps <= kMaxPackedSteps)
// renamed steps of 8 ints in host memory (opcode, the dst/a/b registers'
// word offsets (register x (n + 1)), the plan's first uint16 row offset,
// its selects, the const row, the barrier flag), copied into the launch's
// parameters; blob: blob_words int32 (a multiple of 4, 16-byte aligned):
// the plan rows as uint16 (n = no source) at 0, the constant rows as bits
// (ceil(n / 32) words a row) at off_cbits.  One CTA of `threads` threads
// per 32 lanes; the state comes in `chunk` rows at a time, by 16-byte
// copies where vec_state says d is a multiple of 4 and the state is
// 16-byte aligned.
int pp_packed(const void* state, void* out, const int* host_steps,
              int n_rows, const void* blob, int blob_words, int off_cbits,
              int n_steps, int period, int n, int d, int n_phys, int rounds,
              int const_stride, int out_reg, int threads, int chunk,
              int vec_state, void* stream) {
  if (n_rows > kMaxPackedSteps || n_rows != n_steps * period)
    return (int)cudaErrorInvalidValue;
  PackedSteps steps = {};
  memcpy(steps.row, host_steps, sizeof(int4) * 2 * n_rows);
  const size_t smem =
      ((size_t)blob_words + (((size_t)n_phys * (n + 1) + 3) & ~(size_t)3) +
       (size_t)chunk * 32) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      pp_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (d + 31) / 32;
  pp_packed_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state), static_cast<uint32_t*>(out), steps,
      static_cast<const int4*>(blob), blob_words, off_cbits, n_steps, period,
      n, d, n_phys, rounds, const_stride, out_reg, chunk, vec_state);
  return (int)cudaGetLastError();
}

}  // extern "C"
