// The unified permutation crossbar, out = P @ x, on Hopper CUDA cores.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/crossbar_permute.py:
//   * crossbar_permute_pallas (dense grid, body _kernel / _onehot_tile), and
//   * crossbar_permute_sparse_pallas (tile-skipping grid over the
//     CompiledPlan schedule, body _sparse_kernel).
//
// What bounds it on this card: device-memory bytes.  A permutation does
// at most K multiply-adds per output element (K = selects per control
// row: 1 or 2 for routing plans, 11 for Keccak's theta-rho-pi), far
// below the ~20 operations per byte where float32 CUDA-core arithmetic
// would become the limit.  The cost is reading x and the int32 control
// and writing out, so the design is about moving rows at the HBM rate:
//
//   * One row-gather body serves both kernels and both modes.  Each
//     output row belongs to a group of G lanes sized to its bytes (a warp
//     looping over 16-byte vectors for wide rows, several rows to a warp
//     for narrow ones).  The group reads the row's selects once (lane j
//     of the group loads select j, then shuffles broadcast it), adds
//     kUnroll vectors per lane per select in float32 in select order
//     (several 16-byte loads in flight per lane), then folds, merges and
//     writes with vector stores.  Vectors are 16 bytes wherever the row
//     pitch and the base addresses allow it, else the widest of 8, 4 and
//     2 bytes that they allow, so ragged widths (D = 7 f32, D = 4100
//     bf16) work at the width their alignment permits.
//   * Scatter runs as a gather once its control is inverted: device
//     passes build, for each output row, the CSR list of control entries
//     e = i * K + j landing on it, each segment in (i, j) order, so
//     colliding REAL scatters add in the same order on every run.  The
//     order comes from a stable least-significant-digit radix sort of the
//     entries by output row, 8 bits a pass: each pass counts digits per
//     tile of entries (the last tile to finish scans the counts), then
//     moves each entry to its digit's offset plus its stable rank inside
//     the tile (warp peers by __match_any_sync).  The work is linear in
//     the entries whatever the in-degree.  An output-injective scatter
//     (the MoE dispatch) has segments of at most one entry and becomes a
//     row copy.  The in-degree is the coverage merge uses.  Small control
//     (at most kSmallEntries entries, the decode shapes) is inverted
//     inside the gather kernel itself, per CTA and in shared memory: one
//     launch.  The number of launches of a call depends on its mode and
//     shapes only, never on control or payload values.
//   * The dense kernel's grid covers every output row; the tile-skipping
//     kernel's grid covers the rows of the schedule's output tiles only
//     (run_o).  Every select of a compiled plan lies in an active pair by
//     construction, so neither walks the pair list.  Rows of output tiles
//     not in the schedule are not written; apply_plan pins them.
//   * Products are rounded multiply then rounded add (__fmul_rn /
//     __fadd_rn, never a fused FMA), in select order, so weighted sums
//     reproduce the plain PyTorch version (kernels/ref.py) bit for bit.
//     bf16 payloads multiply by bf16-rounded weights (the TPU kernel's
//     compute dtype is x's dtype); the product of two bf16 values is
//     exact in float32, and the sum accumulates in float32.  P is never
//     stored and no tensor core is used: TF32 would keep 10 mantissa bits
//     and corrupt payloads.
//
// Plain C interface, loaded with ctypes.  Every entry point launches on
// the given stream, allocates nothing (the wrapper passes the scratch),
// never synchronises, reports how many device launches it made, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinCtas = 3;         // row-gather CTAs resident an SM
constexpr int kUnroll = 4;          // vectors in flight per lane per select
constexpr int kSmallEntries = 256;  // scatter control inverted per CTA
constexpr int kDigits = 256;        // radix of the inversion's sort
constexpr int kSortThreads = 1024;  // threads of an inversion CTA
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxTileRounds = 8;   // kSortThreads-entry rounds a tile
constexpr int kMaxPasses = 4;       // 8-bit digits of an int32 row
constexpr int kScanPer = 4;         // counts a scan thread takes per tile
static_assert(kSmallEntries <= kThreads && kThreads <= kDigits,
              "the one-launch form ranks one entry a thread by local row");

// ------------------------------------------------------------ vectors ---

template <int VB>
struct Raw;  // the VB-byte word a vector moves as
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Two floats as two bf16 in one word (lo in the low half): one cvt.
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// VB bytes of T as N floats: bf16 is the upper half of a float32.
template <typename T, int VB>
struct Vec {
  static constexpr int N = VB / (int)sizeof(T);
  static constexpr int W = VB >= 4 ? VB / 4 : 1;
  union Bits {
    typename Raw<VB>::type raw;
    unsigned w[W];
  };

  // The raw bytes first, unpacked when they are used: a vector in flight
  // holds VB / 4 registers, not N.
  __device__ __forceinline__ static Bits fetch(const T* p) {
    Bits b;
    b.raw = __ldg(reinterpret_cast<const typename Raw<VB>::type*>(p));
    return b;
  }

  __device__ __forceinline__ static void unpack(const Bits& b, float* v) {
    if constexpr (VB == 2) {
      v[0] = __uint_as_float((unsigned)b.raw << 16);
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if constexpr (sizeof(T) == 4) {
          v[i] = __uint_as_float(b.w[i]);
        } else {
          v[2 * i] = __uint_as_float(b.w[i] << 16);
          v[2 * i + 1] = __uint_as_float(b.w[i] & 0xffff0000u);
        }
      }
    }
  }

  __device__ __forceinline__ static void load(const T* p, float* v) {
    unpack(fetch(p), v);
  }

  __device__ __forceinline__ static void store(T* p, const float* v) {
    if constexpr (VB == 2) {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(v[0]);
    } else {
      Bits b;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if constexpr (sizeof(T) == 4)
          b.w[i] = __float_as_uint(v[i]);
        else
          b.w[i] = bf16x2_bits(v[2 * i], v[2 * i + 1]);
      }
      *reinterpret_cast<typename Raw<VB>::type*>(p) = b.raw;
    }
  }
};

// The weight as the payload's compute dtype sees it.
template <typename T>
__device__ __forceinline__ float weight_f(float w) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(bf16_bits(w) << 16);
  else
    return w;
}

__device__ __forceinline__ float madd(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// GF(2) accumulate: the float32 sum of 0/1 products is exact below 2^24
// and its parity is the XOR accumulation.
__device__ __forceinline__ float fold2(float r) {
  return r - 2.0f * floorf(r * 0.5f);
}

// --------------------------------------------------------- row gather ---

// Where a row's selects come from.  Gather: K per output row straight
// from idx.  Scatter: the row's CSR segment [ptr[o], ptr[o + 1]) of
// control entries e = i * K + j (global scratch, or a CTA's shared
// memory in the one-launch form, where ptr is indexed by the CTA-local
// row).
struct Control {
  const int* idx;
  const float* w;
  const int* ptr;
  const int* ent;
  int k;
  int n_in;
};

template <typename T, bool kScatter>
__device__ __forceinline__ void load_select(const Control& c, int base,
                                            int j, int nsel, int& s,
                                            float& w) {
  s = -1;
  w = 0.0f;
  if (j >= nsel) return;
  int e;
  if (kScatter) {
    e = c.ent[base + j];
    s = e / c.k;
  } else {
    e = base + j;
    s = __ldg(c.idx + e);
    if (s < 0 || s >= c.n_in) s = -1;
  }
  w = c.w ? weight_f<T>(__ldg(c.w + e)) : 1.0f;
}

// Output row o, columns [v_lo, v_hi) in vectors of VB bytes, by the G
// lanes of one group (gl = lane in group, gmask = the group's lanes).
// `lrow` is the row's index into c.ptr in scatter mode.
template <typename T, int VB, bool kScatter>
__device__ __forceinline__ void gather_row(const Control& c, int o, int lrow,
                                           int gl, int G, unsigned gmask,
                                           int v_lo, int v_hi,
                                           const T* __restrict__ x,
                                           const T* __restrict__ merge,
                                           T* __restrict__ out, int d,
                                           int fold) {
  using V = Vec<T, VB>;
  constexpr int N = V::N;
  int base, nsel;
  if (kScatter) {
    base = c.ptr[lrow];
    nsel = c.ptr[lrow + 1] - base;
  } else {
    base = o * c.k;
    nsel = c.k;
  }
  // The row's first G selects stay in registers for every chunk; only
  // rows with more than G selects load the rest again per chunk.
  int s_first;
  float w_first;
  load_select<T, kScatter>(c, base, gl, nsel, s_first, w_first);
  T* orow = out + (size_t)o * d;
  for (int v0 = v_lo + gl; v0 - gl < v_hi; v0 += G * kUnroll) {
    float acc[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[u][n] = 0.0f;
    int cov = 0;
    for (int b = 0; b < nsel; b += G) {
      int my_s = s_first;
      float my_w = w_first;
      if (b > 0) load_select<T, kScatter>(c, base, b + gl, nsel, my_s, my_w);
      const int nb = min(G, nsel - b);
      for (int j = 0; j < nb; ++j) {
        const int s = __shfl_sync(gmask, my_s, j, G);
        const float wj = __shfl_sync(gmask, my_w, j, G);
        if (s < 0) continue;
        ++cov;
        const T* src = x + (size_t)s * d;
        typename V::Bits raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int vi = v0 + u * G;
          if (vi < v_hi) raw[u] = V::fetch(src + (size_t)vi * N);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (v0 + u * G < v_hi) {
            float v[N];
            V::unpack(raw[u], v);
#pragma unroll
            for (int n = 0; n < N; ++n) acc[u][n] = madd(acc[u][n], wj, v[n]);
          }
        }
      }
    }
    const bool keep_merge = merge != nullptr && cov == 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int vi = v0 + u * G;
      if (vi >= v_hi) continue;
      float r[N];
      if (keep_merge) {
        V::load(merge + (size_t)o * d + (size_t)vi * N, r);
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) r[n] = fold ? fold2(acc[u][n]) : acc[u][n];
      }
      V::store(orow + (size_t)vi * N, r);
    }
  }
}

// The launch geometry both kernels share: G lanes a row, 32 / G rows a
// warp, kThreads / G rows a CTA along blockIdx.x; blockIdx.y splits the
// row's vectors into gridDim.y slabs when there are too few rows to fill
// the card.
struct Geometry {
  int g;         // lanes a row (power of two, <= 32)
  int nvec;      // vectors a row
  int slab;      // vectors a slab (a multiple of g)
  int n_rows;    // rows of the grid (virtual rows for the sparse kernel)
};

struct Lane {
  int row;       // virtual row, or -1 past the grid
  int gl;
  unsigned gmask;
  int v_lo, v_hi;
};

__device__ __forceinline__ Lane lane_of(const Geometry& geo) {
  const int lane = threadIdx.x & 31;
  const int grp = lane / geo.g;
  Lane l;
  l.gl = lane % geo.g;
  l.gmask = geo.g == 32 ? 0xffffffffu
                        : (((1u << geo.g) - 1u) << (grp * geo.g));
  l.row = (blockIdx.x * kThreads + threadIdx.x) / geo.g;
  if (l.row >= geo.n_rows) l.row = -1;
  l.v_lo = blockIdx.y * geo.slab;
  l.v_hi = min(geo.nvec, l.v_lo + geo.slab);
  return l;
}

// Output row of a virtual row: the identity for the dense kernel; the
// rows of the schedule's output tiles, in order, for the sparse one.
__device__ __forceinline__ int output_row(int r, const int* run_o,
                                          int block_o) {
  if (run_o == nullptr) return r;
  return __ldg(run_o + r / block_o) * block_o + r % block_o;
}

// Stable ranks of one round of blockDim.x items (blockDim.x a multiple of
// 32; every thread calls) by a digit d in [0, kDigits), kDigits meaning
// no item.  run[kDigits]: each digit's count in earlier rounds, advanced
// by this round's; wc[warps * kDigits]: zero on entry and on exit.
// Returns how many items with the same digit come before this one:
// earlier rounds, earlier warps, then lower lanes.
__device__ int stable_rank(int d, int* run, int* wc) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int in_warp = __popc(peers & ((1u << lane) - 1u));
  if (d < kDigits && in_warp == 0) wc[w * kDigits + d] = __popc(peers);
  __syncthreads();
  for (int q = threadIdx.x; q < kDigits; q += blockDim.x) {
    int sum = run[q];
    for (int v = 0; v < warps; ++v) {
      const int c = wc[v * kDigits + q];
      wc[v * kDigits + q] = sum;
      sum += c;
    }
    run[q] = sum;
  }
  __syncthreads();
  const int rank = d < kDigits ? wc[w * kDigits + d] + in_warp : 0;
  __syncthreads();
  for (int i = threadIdx.x; i < warps * kDigits; i += blockDim.x) wc[i] = 0;
  __syncthreads();
  return rank;
}

// One-launch scatter form: the CTA inverts the (at most kSmallEntries)
// control entries that land on its own rows into a CSR in shared memory.
// Thread e takes entry e; its local row is its digit, so stable_rank
// gives its place in the row's segment ((i, j) order) and each row's
// count, which a warp scans into ptr.
struct SmallCsr {
  int ptr[kThreads + 1];
  int ent[kSmallEntries];
  int run[kDigits];
  int wc[kThreads / 32 * kDigits];
};

__device__ void invert_small(SmallCsr& sm, const int* __restrict__ idx,
                             int n_ent, int n_out, int row0, int rows,
                             const int* run_o, int block_o) {
  for (int i = threadIdx.x; i < kThreads / 32 * kDigits; i += kThreads)
    sm.wc[i] = 0;
  for (int i = threadIdx.x; i < kDigits; i += kThreads) sm.run[i] = 0;
  const int e = threadIdx.x;
  int lr = kDigits;
  if (e < n_ent) {
    const int o = __ldg(idx + e);
    if (o >= 0 && o < n_out) {
      int r = -1;
      if (run_o == nullptr) {
        r = o - row0;
      } else {
        // the virtual rows of this CTA span few o-runs: find o's tile
        const int r_last = row0 + rows - 1;
        for (int run = row0 / block_o; run <= r_last / block_o; ++run) {
          if (__ldg(run_o + run) == o / block_o) {
            r = run * block_o + o % block_o - row0;
            break;
          }
        }
      }
      if (r >= 0 && r < rows) lr = r;
    }
  }
  __syncthreads();
  const int rank = stable_rank(lr, sm.run, sm.wc);
  if (threadIdx.x < 32) {   // exclusive scan of `rows` <= kThreads counts
    int carry = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + threadIdx.x;
      const int v = r < rows ? sm.run[r] : 0;
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if ((int)threadIdx.x >= off) incl += t;
      }
      if (r < rows) sm.ptr[r] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (threadIdx.x == 0) sm.ptr[rows] = carry;
  }
  __syncthreads();
  if (lr < kDigits) sm.ent[sm.ptr[lr] + rank] = e;
  __syncthreads();
}

// Mode kGather: selects from idx.  kScatterCsr: the global CSR.
// kScatterSmall: the CTA inverts its own control first.
enum Form { kGather = 0, kScatterCsr = 1, kScatterSmall = 2 };

template <typename T, int VB, int kForm>
__device__ __forceinline__ void crossbar_body(
    const Geometry& geo, const int* __restrict__ run_o, int block_o,
    Control c, int n_ent, const T* __restrict__ x,
    const T* __restrict__ merge, T* __restrict__ out, int n_out, int d,
    int fold) {
  const Lane l = lane_of(geo);
  int o = l.row < 0 ? -1 : output_row(l.row, run_o, block_o);
  if (o >= n_out) o = -1;
  int lrow = o;
  if constexpr (kForm == kScatterSmall) {
    __shared__ SmallCsr sm;
    const int rows_per_cta = kThreads / geo.g;
    const int row0 = blockIdx.x * rows_per_cta;
    invert_small(sm, c.idx, n_ent, n_out, row0,
                 min(rows_per_cta, geo.n_rows - row0), run_o, block_o);
    c.ptr = sm.ptr;
    c.ent = sm.ent;
    lrow = l.row - row0;
  }
  if (o < 0) return;
  gather_row<T, VB, kForm != kGather>(c, o, lrow, l.gl, geo.g, l.gmask,
                                      l.v_lo, l.v_hi, x, merge, out, d,
                                      fold);
}

template <typename T, int VB, int kForm>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    crossbar_dense_kernel(Geometry geo, Control c, int n_ent,
                          const T* __restrict__ x,
                          const T* __restrict__ merge, T* __restrict__ out,
                          int n_out, int d, int fold) {
  crossbar_body<T, VB, kForm>(geo, nullptr, 1, c, n_ent, x, merge, out,
                              n_out, d, fold);
}

template <typename T, int VB, int kForm>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    crossbar_sparse_kernel(Geometry geo, const int* __restrict__ run_o,
                           int block_o, Control c, int n_ent,
                           const T* __restrict__ x, T* __restrict__ out,
                           int n_out, int d, int fold) {
  crossbar_body<T, VB, kForm>(geo, run_o, block_o, c, n_ent, x, nullptr,
                              out, n_out, d, fold);
}

// ------------------------------------------------- scatter inversion ---
// The large form: a stable LSD radix sort of the control entries by key
// (output row; n_out for a DROP, so DROPs sort last), then the CSR is
// ptr (the exclusive scan of each row's count) and ent (the sorted
// entries).  A pass is inv_hist (digit counts per tile of entries, the
// last CTA scans them) then inv_move (each entry to its digit's offset
// plus its stable rank in its tile).  Pass 0 reads keys from the control
// and also counts each row's entries into cnt, which its last CTA scans
// into ptr.

// Exclusive scan of n ints by one CTA of kSortThreads threads (in may
// equal out), in tiles of kScanPer * kSortThreads staged in shared memory
// with coalesced loads: each thread scans kScanPer neighbours, the CTA
// its threads' sums, and the running total carries from tile to tile.
// The total goes to *total when it is given.  Reads through L2, as other
// CTAs wrote the input.
__device__ void scan_exclusive(const int* in, int* out, int n, int* total) {
  __shared__ int tile[kScanPer * kSortThreads];
  __shared__ int warp_sum[kSortWarps];
  __shared__ int tile_total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += kScanPer * kSortThreads) {
    const int m = min(kScanPer * kSortThreads, n - t0);
    for (int i = threadIdx.x; i < m; i += kSortThreads)
      tile[i] = __ldcg(in + t0 + i);
    __syncthreads();
    const int lo = threadIdx.x * kScanPer;
    int v[kScanPer], sum = 0;
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) {
      v[q] = lo + q < m ? tile[lo + q] : 0;
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_sum[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      const int w = warp_sum[lane];
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, wi, off);
        if (lane >= off) wi += t;
      }
      warp_sum[lane] = wi - w;
      if (lane == 31) tile_total = wi;
    }
    __syncthreads();
    int run = carry + warp_sum[wid] + incl - sum;
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) {
      if (lo + q < m) out[t0 + lo + q] = run;
      run += v[q];
    }
    carry += tile_total;
    __syncthreads();
  }
  if (total != nullptr && threadIdx.x == 0) *total = carry;
}

// One pass of the sort over tiles of `tile` entries (a multiple of
// kSortThreads).  key_in == nullptr: pass 0, keys from idx, values e.
struct SortPass {
  const int* idx;
  const int* key_in;
  const int* val_in;
  int* key_out;      // null on the last pass
  int* val_out;
  int n_ent, n_out, shift, tile, n_tiles;
  int* hist;         // [kDigits][n_tiles]
  int* done;         // this pass's finished-CTA count, zeroed per call
  int* cnt;          // pass 0: [n_out] row counts, zeroed per call
  int* ptr;          // pass 0: [n_out + 1] their exclusive scan
};

__device__ __forceinline__ void sort_item(const SortPass& p, int e, int& key,
                                          int& val) {
  if (p.key_in == nullptr) {
    const int o = __ldg(p.idx + e);
    key = (o >= 0 && o < p.n_out) ? o : p.n_out;
    val = e;
  } else {
    key = p.key_in[e];
    val = p.val_in[e];
  }
}

__global__ void __launch_bounds__(kSortThreads) inv_hist(SortPass p) {
  __shared__ int h[kDigits];
  __shared__ int last;
  for (int i = threadIdx.x; i < kDigits; i += kSortThreads) h[i] = 0;
  __syncthreads();
  const int e0 = blockIdx.x * p.tile;
  const int e1 = min(e0 + p.tile, p.n_ent);
  for (int e = e0 + threadIdx.x; e < e1; e += kSortThreads) {
    int key, val;
    sort_item(p, e, key, val);
    atomicAdd(&h[(key >> p.shift) & (kDigits - 1)], 1);
    if (p.cnt != nullptr && key < p.n_out) atomicAdd(p.cnt + key, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits; i += kSortThreads)
    p.hist[i * p.n_tiles + blockIdx.x] = h[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  scan_exclusive(p.hist, p.hist, kDigits * p.n_tiles, nullptr);
  if (p.cnt != nullptr) scan_exclusive(p.cnt, p.ptr, p.n_out, p.ptr + p.n_out);
}

__global__ void __launch_bounds__(kSortThreads) inv_move(SortPass p) {
  __shared__ int run[kDigits], base[kDigits];
  __shared__ int wc[kSortWarps * kDigits];
  for (int i = threadIdx.x; i < kDigits; i += kSortThreads) {
    run[i] = 0;
    base[i] = p.hist[i * p.n_tiles + blockIdx.x];
  }
  for (int i = threadIdx.x; i < kSortWarps * kDigits; i += kSortThreads)
    wc[i] = 0;
  __syncthreads();
  const int e0 = blockIdx.x * p.tile;
  for (int r0 = 0; r0 < p.tile; r0 += kSortThreads) {
    const int e = e0 + r0 + threadIdx.x;
    int key = 0, val = 0, d = kDigits;
    if (e < p.n_ent) {
      sort_item(p, e, key, val);
      d = (key >> p.shift) & (kDigits - 1);
    }
    const int rank = stable_rank(d, run, wc);
    if (d < kDigits) {
      const int pos = base[d] + rank;
      if (p.key_out != nullptr) p.key_out[pos] = key;
      p.val_out[pos] = val;
    }
  }
}

// ------------------------------------------------------------ launch ---

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int lanes_for(int nvec) {
  int g = 1;
  while (g < nvec && g < 32) g <<= 1;
  return g;
}

// The widest vector (16, 8, 4 or 2 bytes) that the row pitch and every
// base address allow.
int vector_bytes(int d, int esize, uintptr_t align_of_bases) {
  const long long pitch = (long long)d * esize;
  for (int vb = 16; vb > esize; vb >>= 1)
    if (pitch % vb == 0 && align_of_bases % vb == 0) return vb;
  return esize;
}

Geometry make_geometry(int n_rows, int nvec, int sms) {
  Geometry geo;
  geo.g = lanes_for(nvec);
  geo.nvec = nvec;
  geo.n_rows = n_rows;
  const int rows_per_cta = kThreads / geo.g;
  const long long ctas = ((long long)n_rows + rows_per_cta - 1) / rows_per_cta;
  // Few rows: split each row into slabs of at least one vector a lane
  // until ~2 CTAs an SM are busy.
  const int per_lane = (nvec + geo.g - 1) / geo.g;
  long long slabs = ctas > 0 ? (2LL * sms + ctas - 1) / ctas : 1;
  if (slabs > per_lane) slabs = per_lane;
  if (slabs < 1) slabs = 1;
  geo.slab = (int)((per_lane + slabs - 1) / slabs) * geo.g;
  return geo;
}

struct Launch {
  Geometry geo;
  dim3 grid;
};

Launch plan_launch(int n_rows, int d, int vb, int esize) {
  Launch L;
  L.geo = make_geometry(n_rows, d * esize / vb, sm_count());
  const int rows_per_cta = kThreads / L.geo.g;
  L.grid = dim3((unsigned)((n_rows + rows_per_cta - 1) / rows_per_cta),
                (unsigned)((L.geo.nvec + L.geo.slab - 1) / L.geo.slab));
  return L;
}

// The large inversion's shape and scratch layout (ints):
// cnt[n_out] | done[kMaxPasses] | ptr[n_out + 1] | hist[kDigits * n_tiles]
// | ka, va[n_ent] (2+ passes) | kb, vb[n_ent] (3+ passes) | ent[n_ent].
// cnt and done are contiguous: one memset zeroes them.
struct Inversion {
  int passes, tile, n_tiles;
  int *cnt, *done, *ptr, *hist, *ka, *va, *kb, *vb, *ent;
  long long ints;
};

Inversion inversion_layout(int* base, long long n_ent, long long n_out) {
  Inversion v;
  int bits = 0;
  while (bits < 31 && (n_out >> bits) != 0) ++bits;   // keys 0..n_out
  v.passes = (bits + 7) / 8;
  if (v.passes < 1) v.passes = 1;
  long long rounds = n_ent / (2LL * sm_count() * kSortThreads);
  if (rounds < 1) rounds = 1;
  if (rounds > kMaxTileRounds) rounds = kMaxTileRounds;
  v.tile = (int)rounds * kSortThreads;
  v.n_tiles = (int)((n_ent + v.tile - 1) / v.tile);
  long long off = 0;
  auto take = [&](long long n) {
    int* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  v.cnt = take(n_out);
  v.done = take(kMaxPasses);
  v.ptr = take(n_out + 1);
  v.hist = take((long long)kDigits * v.n_tiles);
  v.ka = v.passes >= 2 ? take(n_ent) : nullptr;
  v.va = v.passes >= 2 ? take(n_ent) : nullptr;
  v.kb = v.passes >= 3 ? take(n_ent) : nullptr;
  v.vb = v.passes >= 3 ? take(n_ent) : nullptr;
  v.ent = take(n_ent);
  v.ints = off;
  return v;
}

// The large inversion: 1 + 2 * passes launches; fills c.ptr / c.ent.
void invert_large(const int* idx, int n_ent, int n_out, int* scratch,
                  Control& c, cudaStream_t s, int& n_launch) {
  const Inversion v = inversion_layout(scratch, n_ent, n_out);
  cudaMemsetAsync(v.cnt, 0, sizeof(int) * ((size_t)n_out + kMaxPasses), s);
  ++n_launch;
  const int* key_in = nullptr;
  const int* val_in = nullptr;
  for (int q = 0; q < v.passes; ++q) {
    const bool last = q == v.passes - 1;
    int* key_out = last ? nullptr : (q % 2 == 0 ? v.ka : v.kb);
    int* val_out = last ? v.ent : (q % 2 == 0 ? v.va : v.vb);
    const SortPass p{idx, key_in, val_in, key_out, val_out, n_ent, n_out,
                     8 * q, v.tile, v.n_tiles, v.hist, v.done + q,
                     q == 0 ? v.cnt : nullptr, v.ptr};
    inv_hist<<<v.n_tiles, kSortThreads, 0, s>>>(p);
    inv_move<<<v.n_tiles, kSortThreads, 0, s>>>(p);
    n_launch += 2;
    key_in = key_out;
    val_in = val_out;
  }
  c.ptr = v.ptr;
  c.ent = v.ent;
}

// One call's operands past the inversion.
struct Call {
  const int* run_o;  // null: the dense kernel
  int block_o;
  Control c;
  int n_ent;
  const void* x;
  const void* merge;
  void* out;
  int n_out, d, fold;
};

template <typename T, int VB, int kForm>
void launch_rows(const Launch& L, const Call& a, cudaStream_t s) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  if (a.run_o == nullptr)
    crossbar_dense_kernel<T, VB, kForm><<<L.grid, kThreads, 0, s>>>(
        L.geo, a.c, a.n_ent, x, static_cast<const T*>(a.merge), out,
        a.n_out, a.d, a.fold);
  else
    crossbar_sparse_kernel<T, VB, kForm><<<L.grid, kThreads, 0, s>>>(
        L.geo, a.run_o, a.block_o, a.c, a.n_ent, x, out, a.n_out, a.d,
        a.fold);
}

template <typename T, int VB>
void launch_form(const Launch& L, int form, const Call& a, cudaStream_t s) {
  if (form == kGather)
    launch_rows<T, VB, kGather>(L, a, s);
  else if (form == kScatterCsr)
    launch_rows<T, VB, kScatterCsr>(L, a, s);
  else
    launch_rows<T, VB, kScatterSmall>(L, a, s);
}

template <typename T>
void launch_typed(const Launch& L, int vb, int form, const Call& a,
                  cudaStream_t s) {
  switch (vb) {
    case 16: launch_form<T, 16>(L, form, a, s); break;
    case 8: launch_form<T, 8>(L, form, a, s); break;
    case 4: launch_form<T, 4>(L, form, a, s); break;
    default: launch_form<T, (int)sizeof(T)>(L, form, a, s); break;
  }
}

// Shared by both entry points: n_rows virtual rows (n_out for the dense
// kernel, n_runs * block_o for the tile-skipping one).
int run_crossbar(const int* run_o, int n_rows, int block_o, const int* idx,
                 const void* x, const float* w, const void* merge, void* out,
                 int* scratch, int k, int n_in, int n_out, int d, int scatter,
                 int bf16, int fold, cudaStream_t s, int* n_launch) {
  *n_launch = 0;
  const int esize = bf16 ? 2 : 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(merge);
  const int vb = vector_bytes(d, esize, bases);
  Call a{run_o, block_o, Control{idx, w, nullptr, nullptr, k, n_in},
         scatter ? n_in * k : 0, x, merge, out, n_out, d, fold};
  int form = kGather;
  if (scatter) {
    form = a.n_ent <= kSmallEntries ? kScatterSmall : kScatterCsr;
    if (form == kScatterCsr)
      invert_large(idx, a.n_ent, n_out, scratch, a.c, s, *n_launch);
  }
  const Launch L = plan_launch(n_rows, d, vb, esize);
  if (bf16)
    launch_typed<__nv_bfloat16>(L, vb, form, a, s);
  else
    launch_typed<float>(L, vb, form, a, s);
  *n_launch += 1;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch ints a call needs: the large scatter inversion's CSR.
long long xb_scratch_ints(int scatter, int n_in, int k, int n_out) {
  const long long n_ent = (long long)n_in * k;
  if (!scatter || n_ent <= kSmallEntries) return 0;
  return inversion_layout(nullptr, n_ent, n_out).ints;
}

// idx: (n_ctrl_pad, k) int32, control rows DROP-padded; x: (n_in, d)
// float32 or bf16; w: like idx (float32) or null; merge: (n_out, d) in
// x's dtype or null; out: (n_out, d) in x's dtype; scratch:
// xb_scratch_ints ints or null.  *n_launch: device launches made.
int xb_dense(const int* idx, const void* x, const float* w, const void* merge,
             void* out, void* scratch, int k, int n_in, int n_out, int d,
             int scatter, int bf16, int fold, void* stream, int* n_launch) {
  return run_crossbar(nullptr, n_out, 1, idx, x, w, merge, out,
                      static_cast<int*>(scratch), k, n_in, n_out, d, scatter,
                      bf16, fold, static_cast<cudaStream_t>(stream),
                      n_launch);
}

// run_o: (n_runs,) output tile of each o-run of the o-major schedule;
// only those tiles' rows of out are written.
int xb_sparse(const int* run_o, int n_runs, const int* idx, const void* x,
              const float* w, void* out, void* scratch, int k, int n_in,
              int n_out, int d, int scatter, int bf16, int fold, int block_o,
              void* stream, int* n_launch) {
  return run_crossbar(run_o, n_runs * block_o, block_o, idx, x, w, nullptr,
                      out, static_cast<int*>(scratch), k, n_in, n_out, d,
                      scatter, bf16, fold, static_cast<cudaStream_t>(stream),
                      n_launch);
}

}  // extern "C"
