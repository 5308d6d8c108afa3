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
// them.  AES-128-GCM's programs (word layout, 424 to ~8000 steps) walk
// only the rows a step may change and each row's live selects (the word
// layout below), a few rows and selects a thread a step: a step then
// costs its chain of dependent loads (step words, row pointer, source,
// register file) and its barrier.
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
//   * No divide in a loop: lanes per CTA are a power of two, and a
//     thread's row and lane come from shifts (the word walk takes one
//     modulo a range, for a thread's first row group in it).
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
//     cudaFuncSetAttribute), where the CTA's files, n_phys x n x 4 bytes
//     a lane, fit the 232448-byte opt-in (n <= 11622 at 5 physical
//     registers, one lane);
//   * global: a scratch tensor the wrapper allocates for the launch, one
//     slab a CTA, for larger programs (AES-128-GCM over a 1500-byte
//     record: n = 12640, 253 KB a lane).  The same VM over the same
//     layout: a warp's neighbouring threads still read neighbouring
//     words, the block barrier still orders the steps (it orders global
//     as well as shared accesses within the block), and the files of the
//     lanes in flight stay in the 50 MB L2.  Each register access is then
//     an L1/L2 access, not a shared-memory one.
// A thread takes up to 4 lanes of one row as one 16-byte vector (V
// words), so each select's control is read once per V lanes.  The host
// gives a CTA the fewest lanes that run the whole batch in one wave, one
// CTA an SM (lanes_per_cta), and puts the files in shared memory where
// they fit, else in global memory: a step costs a CTA about the same
// whatever its lanes, so a second wave costs more than global memory does
// (GCM over 1024 records of 64 B: 8 lanes a CTA, files in global memory).
// The walk (core.plan_program.word_tables, on the host, once a program):
//   * each step visits only the rows it may change — the host follows,
//     per physical register, the rows that may be nonzero, so a PERMUTE
//     visits its rows with a select of a possibly nonzero source and the
//     rows of its destination not proven zero, an elementwise step the
//     rows whose result may differ from what the destination holds; a
//     row off the list already holds its value.  The rows come as ranges
//     [lo, hi) in the step's 3 int4 (the first range inline, the rest in
//     the range table), the step stream unrolled over the rounds (each
//     round's rows and constant rows its own);
//   * each row folds only its live selects, from one CSR of every plan's
//     selects (DROP and out-of-range selects left out): through the row
//     pointer, or with none where a range's rows all hold c selects
//     (source base + (row - lo) x c);
//   * a V-word group of a row belongs to thread (row x groups + q) mod
//     threads in every step, as in the packed layout, so only a PERMUTE
//     crosses threads and the host's barrier flags stand; heavy rows
//     (GHASH's Y rows: up to 142 selects beside rows of one) are shared
//     by G lanes of a warp, lane g taking every G-th select and a
//     shuffle reducing, and their steps are fenced by barriers on both
//     sides (another lane than the owner writes the row).
// Everything computes in uint32: ADD wraps without signed-overflow UB and
// ROTLV's right shift is logical.  int32 states are bit-cast through the
// launch.  The XOR fold accumulates g XOR'd (bit 0 kept at the end), the
// ADD fold g * w with wrap-around.
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

// Bits of a step's first word and of a range's flags; must match WS_* and
// WR_RAGGED in core/plan_program.py.
constexpr int kStepBarrier = 1 << 8;
constexpr int kStepXorFold = 1 << 9;
constexpr int kStepWeighted = 1 << 10;
constexpr int kRangeRagged = 1 << 8;

template <int V>
struct alignas(4 * V) Words {
  uint32_t w[V];
};

// One select folded into a row's accumulator: the XOR fold keeps g * w
// (bit 0 read at the end), the ADD fold adds it with wrap-around.
template <int V, bool kXor>
__device__ __forceinline__ void fold_in(uint32_t (&acc)[V], const Words<V>& g,
                                        bool weighted,
                                        const int* __restrict__ wts, int j) {
  const uint32_t w = weighted ? (uint32_t)__ldg(wts + j) : 1u;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const uint32_t gi = g.w[i] * w;
    acc[i] = kXor ? acc[i] ^ gi : acc[i] + gi;
  }
}

template <int V, bool kXor>
__device__ __forceinline__ Words<V> folded(const uint32_t (&acc)[V]) {
  Words<V> res;
#pragma unroll
  for (int i = 0; i < V; ++i) res.w[i] = kXor ? acc[i] & 1u : acc[i];
  return res;
}

// A light row's select range [j, j1): through the row pointer (ragged) or
// from the range's uniform count c.
__device__ __forceinline__ void row_selects(int4 rg, bool ragged, int c,
                                            const int* __restrict__ rp,
                                            int r, int& j, int& j1) {
  if (ragged) {
    j = __ldg(rp + rg.w + r);
    j1 = __ldg(rp + rg.w + r + 1);
  } else {
    j = rg.w + (r - rg.x) * c;
    j1 = j + c;
  }
}

// One range of a PERMUTE: rows [lo, hi) of D from their live selects in A.
// Light rows (G = 1) go one V-word group to the group's owner thread, as
// in every other step (one-word groups, where a row group is a row, two
// of a thread at a time, their loads in flight together); a heavy row's
// group is shared by G lanes of a warp, lane g taking selects g, g + G,
// ..., a shuffle reducing.
template <int V, bool kXor>
__device__ __forceinline__ void permute_range(
    const Words<V>* __restrict__ A, Words<V>* __restrict__ D, int4 rg,
    bool weighted, const int* __restrict__ rp, const int* __restrict__ cols,
    const int* __restrict__ wts, int glog2) {
  const int nthr = blockDim.x;
  const int gl = rg.z & 31;
  const bool ragged = (rg.z & kRangeRagged) != 0;
  const int lo_el = rg.x << glog2, hi_el = rg.y << glog2;
  const int qmask = (1 << glog2) - 1;
  const int first = lo_el + (((int)threadIdx.x - lo_el) & (nthr - 1));
  if (gl == 0 && V == 1) {
    const int c = rg.z >> 16;  // a uniform range's selects a row
    for (int el = first; el < hi_el; el += 2 * nthr) {
      const bool two = el + nthr < hi_el;
      int j, j1, k = 0, k1 = 0;
      row_selects(rg, ragged, c, rp, el, j, j1);
      if (two) row_selects(rg, ragged, c, rp, el + nthr, k, k1);
      uint32_t acc[V] = {}, acc2[V] = {};
      for (; j < j1 && k < k1; ++j, ++k) {
        const Words<V> g1 = A[__ldg(cols + j)], g2 = A[__ldg(cols + k)];
        fold_in<V, kXor>(acc, g1, weighted, wts, j);
        fold_in<V, kXor>(acc2, g2, weighted, wts, k);
      }
      for (; j < j1; ++j)
        fold_in<V, kXor>(acc, A[__ldg(cols + j)], weighted, wts, j);
      for (; k < k1; ++k)
        fold_in<V, kXor>(acc2, A[__ldg(cols + k)], weighted, wts, k);
      D[el] = folded<V, kXor>(acc);
      if (two) D[el + nthr] = folded<V, kXor>(acc2);
    }
    return;
  }
  if (gl == 0) {
    const int c = rg.z >> 16;
    for (int el = first; el < hi_el; el += nthr) {
      const Words<V>* Aq = A + (el & qmask);
      int j, j1;
      row_selects(rg, ragged, c, rp, el >> glog2, j, j1);
      uint32_t acc[V] = {};
      // not unrolled: ChaCha20's rows hold one select or none
#pragma unroll 1
      for (; j < j1; ++j)
        fold_in<V, kXor>(acc, Aq[__ldg(cols + j) << glog2], weighted, wts, j);
      D[el] = folded<V, kXor>(acc);
    }
    return;
  }
  // heavy: items (row group, lane g); item i runs on a thread of lane
  // i mod 32 (nthr and the range's lane offset are multiples of 32), so a
  // row's G lanes are one aligned segment of a warp, in or out together
  const int G = 1 << gl;
  const int lane = threadIdx.x & 31;
  const unsigned seg =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int items = (hi_el - lo_el) << gl;
  for (int i = ((int)threadIdx.x - (rg.z >> 16)) & (nthr - 1); i < items;
       i += nthr) {
    const int el = lo_el + (i >> gl), g = i & (G - 1);
    const int r = el >> glog2;
    const Words<V>* Aq = A + (el & qmask);
    const int j1 = __ldg(rp + rg.w + r + 1);
    uint32_t acc[V] = {};
    for (int j = __ldg(rp + rg.w + r) + g; j < j1; j += G)
      fold_in<V, kXor>(acc, Aq[__ldg(cols + j) << glog2], weighted, wts, j);
    for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i2 = 0; i2 < V; ++i2) {
        const uint32_t other = __shfl_xor_sync(seg, acc[i2], o);
        acc[i2] = kXor ? acc[i2] ^ other : acc[i2] + other;
      }
    }
    if (g == 0) D[el] = folded<V, kXor>(acc);
  }
}

// One range of an elementwise step: rows [lo, hi), each V-word group on
// its owner thread; one instantiation an opcode (a switch inside the loop
// slowed ChaCha20's short steps).
template <int V, int kOp>
__device__ __forceinline__ void elementwise_range(
    const Words<V>* A, const Words<V>* B, Words<V>* D, int4 rg,
    const int* __restrict__ crow, int glog2) {
  const int nthr = blockDim.x;
  const int lo_el = rg.x << glog2, hi_el = rg.y << glog2;
  constexpr bool konst = kOp == kRotlv || kOp == kXorConst || kOp == kEqConst;
  for (int el = lo_el + (((int)threadIdx.x - lo_el) & (nthr - 1));
       el < hi_el; el += nthr) {
    const Words<V> av = A[el];
    Words<V> bv;
    uint32_t k = 0u;
    if (konst)
      k = (uint32_t)__ldg(crow + (el >> glog2));
    else
      bv = B[el];
    Words<V> res;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t x = av.w[i];
      if (kOp == kXor) res.w[i] = x ^ bv.w[i];
      else if (kOp == kAnd) res.w[i] = x & bv.w[i];
      else if (kOp == kAndn) res.w[i] = ~x & bv.w[i];
      else if (kOp == kAdd) res.w[i] = x + bv.w[i];
      else if (kOp == kRotlv)
        res.w[i] = (k < 32u ? (x << k) : 0u) | (x >> ((32u - k) & 31u));
      else if (kOp == kXorConst) res.w[i] = x ^ k;
      else res.w[i] = x == k ? 1u : 0u;  // kEqConst
    }
    D[el] = res;
  }
}

// One range of a step, dispatched on its opcode.
template <int V>
__device__ __forceinline__ void run_range(int op, int flags, const Words<V>* A,
                                          const Words<V>* B, Words<V>* D,
                                          int4 rg, const int* __restrict__ crow,
                                          const int* __restrict__ rp,
                                          const int* __restrict__ cols,
                                          const int* __restrict__ wts,
                                          int glog2) {
  const bool weighted = (flags & kStepWeighted) != 0;
  switch (op) {
    case kPermute:  // the host guarantees dst != a
      if (flags & kStepXorFold)
        permute_range<V, true>(A, D, rg, weighted, rp, cols, wts, glog2);
      else
        permute_range<V, false>(A, D, rg, weighted, rp, cols, wts, glog2);
      break;
    case kXor: elementwise_range<V, kXor>(A, B, D, rg, crow, glog2); break;
    case kAnd: elementwise_range<V, kAnd>(A, B, D, rg, crow, glog2); break;
    case kAndn: elementwise_range<V, kAndn>(A, B, D, rg, crow, glog2); break;
    case kAdd: elementwise_range<V, kAdd>(A, B, D, rg, crow, glog2); break;
    case kRotlv: elementwise_range<V, kRotlv>(A, B, D, rg, crow, glog2); break;
    case kXorConst:
      elementwise_range<V, kXorConst>(A, B, D, rg, crow, glog2);
      break;
    default: elementwise_range<V, kEqConst>(A, B, D, rg, crow, glog2); break;
  }
}

// A step's ranges after its first, from the range table.
template <int V>
__device__ __forceinline__ void run_ranges(int op, int flags,
                                           const Words<V>* A,
                                           const Words<V>* B, Words<V>* D,
                                           const int4* __restrict__ rgs,
                                           int cnt,
                                           const int* __restrict__ crow,
                                           const int* __restrict__ rp,
                                           const int* __restrict__ cols,
                                           const int* __restrict__ wts,
                                           int glog2) {
  for (int k = 0; k < cnt; ++k)
    run_range<V>(op, flags, A, B, D, __ldg(rgs + k), crow, rp, cols, wts,
                 glog2);
}

// (launch bounds of one CTA of 1024 threads an SM: ptxas may use 64
// registers a thread; with the thread count alone it kept two
// instantiations to 32 registers and spilled in the step loop)
template <int V, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
    pp_word_kernel(const uint32_t* __restrict__ state,
                   uint32_t* __restrict__ out, const int4* __restrict__ steps,
                   int n_steps, int t_rounds, int t_cycle,
                   const int4* __restrict__ ranges,
                   const int* __restrict__ rp, const int* __restrict__ cols,
                   const int* __restrict__ wts,
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

  for (int e = threadIdx.x; e < per; e += nthr) {
    const int r = e >> lanes_log2;
    const int l = e & (lanes - 1);
    regs[e] = l < live ? state[(size_t)r * d + l0 + l] : 0u;
    for (int q = 1; q < n_phys; ++q) regs[(size_t)q * per + e] = 0u;
  }
  __syncthreads();

  // the step stream, 3 int4 a step: table rounds 0 .. t_rounds - 1, then
  // the last t_cycle of them again and again; the next step's words are
  // loaded while this one runs
  const int total = rounds * n_steps;
  const int table = t_rounds * n_steps;
  const int restart = (t_rounds - t_cycle) * n_steps;
  int4 h0 = make_int4(0, 0, 0, 0), h1 = h0, h2 = h0;
  if (total > 0) {
    h0 = __ldg(steps);
    h1 = __ldg(steps + 1);
    h2 = __ldg(steps + 2);
  }
  for (int t = 0, ti = 0, rnd = 0, si = 0; t < total; ++t) {
    const int4 s0 = h0, s1 = h1, s2 = h2;
    if (t + 1 < total) {
      ti = ti + 1 == table ? restart : ti + 1;
      h0 = __ldg(steps + 3 * ti);
      h1 = __ldg(steps + 3 * ti + 1);
      h2 = __ldg(steps + 3 * ti + 2);
    }
    const int op = s0.x & 0xFF;
    if (s0.x & kStepBarrier) __syncthreads();  // the host's barrier flag
    const Words<V>* A =
        reinterpret_cast<const Words<V>*>(regs + (size_t)s0.z * per);
    const Words<V>* B =
        reinterpret_cast<const Words<V>*>(regs + (size_t)s0.w * per);
    Words<V>* D = reinterpret_cast<Words<V>*>(regs + (size_t)s0.y * per);
    const int* crow = consts + (size_t)(s1.x + rnd * const_stride) * n;
    // the first range is the step's third word, the others in the table
    run_range<V>(op, s0.x, A, B, D, s2, crow, rp, cols, wts, glog2);
    if (s1.z > 0)
      run_ranges<V>(op, s0.x, A, B, D, ranges + s1.y, s1.z, crow, rp, cols,
                    wts, glog2);
    if (++si == n_steps) si = 0, ++rnd;
  }
  __syncthreads();

  const uint32_t* R = regs + (size_t)out_reg * per;
  for (int e = threadIdx.x; e < per; e += nthr) {
    const int r = e >> lanes_log2;
    const int l = e & (lanes - 1);
    if (l < live) out[(size_t)r * d + l0 + l] = R[e];
  }
}

struct WordArgs {
  const void* state;
  void* out;
  const int* steps;
  int n_steps, t_rounds, t_cycle;
  const int* ranges;
  const int *rp, *cols, *wts, *consts;
  int n, d, n_phys, rounds, const_stride, lanes_log2, threads, out_reg;
  void* file;
};

template <int V, bool kGlobal>
int launch_word_at(const WordArgs& a, cudaStream_t s) {
  const size_t smem =
      kGlobal ? 0 : ((size_t)a.n_phys * a.n * sizeof(uint32_t)) << a.lanes_log2;
  cudaError_t err = cudaFuncSetAttribute(
      pp_word_kernel<V, kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.d + (1 << a.lanes_log2) - 1) >> a.lanes_log2;
  pp_word_kernel<V, kGlobal><<<grid, a.threads, smem, s>>>(
      static_cast<const uint32_t*>(a.state), static_cast<uint32_t*>(a.out),
      reinterpret_cast<const int4*>(a.steps), a.n_steps, a.t_rounds,
      a.t_cycle, reinterpret_cast<const int4*>(a.ranges), a.rp, a.cols, a.wts, a.consts,
      a.n, a.d, a.n_phys, a.rounds, a.const_stride, a.lanes_log2, a.out_reg,
      static_cast<uint32_t*>(a.file));
  return (int)cudaGetLastError();
}

template <int V>
int launch_word(const WordArgs& a, cudaStream_t s) {
  return a.file != nullptr ? launch_word_at<V, true>(a, s)
                           : launch_word_at<V, false>(a, s);
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

// Word layout.  state/out: (n, d) 32-bit words; steps: (t_rounds x
// n_steps, 12) int32, 3 int4 a step over n_phys physical registers
// (core.plan_program.word_tables: (opcode | flags, dst, a, b), (const
// row, offset and count of further ranges, 0), the first range); ranges:
// (R, 4) int32 (lo, hi, flags, base); rp / cols / wts: the plans' CSR
// (row pointers as absolute source offsets, live sources, weights or null
// when no plan is weighted); consts: (n_consts, n).  Round r runs table
// round r while r < t_rounds, then the last t_cycle table rounds in
// turn, with const row + r x const_stride.  1 << lanes_log2 payload
// columns per CTA of `threads` threads (a power of two from 32 to 1024:
// a row group's owner is its index mod threads); register 0 is physical
// register out_reg
// at the end.  file: null for the register file in shared memory, else
// global scratch of grid x n_phys x (n << lanes_log2) words (grid =
// ceil(d / lanes)), one slab a CTA.
int pp_megakernel(const void* state, void* out, const int* steps,
                  int n_steps, int t_rounds, int t_cycle, const int* ranges,
                  const int* rp, const int* cols, const int* wts,
                  const int* consts, int n, int d, int n_phys, int rounds,
                  int const_stride, int lanes_log2, int threads, int out_reg,
                  void* file, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads < 32 || threads > kThreads || (threads & (threads - 1)) ||
      t_cycle < 1 || t_cycle > t_rounds)
    return (int)cudaErrorInvalidValue;
  const WordArgs a = {state,  out,        steps,   n_steps, t_rounds,
                      t_cycle, ranges,    rp,      cols,    wts,
                      consts, n,          d,       n_phys,  rounds,
                      const_stride, lanes_log2, threads, out_reg, file};
  if (lanes_log2 >= 2) return launch_word<4>(a, s);
  if (lanes_log2 == 1) return launch_word<2>(a, s);
  return launch_word<1>(a, s);
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
