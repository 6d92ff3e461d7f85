// K4, the ablation ladder of the multi-event graph Smith-Waterman fill, on
// the warp-per-lane layout of K1 (sw_warp.cuh), for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's timing harness
// tools/kbench2.py: make_kernel (:35; variants v0, nof, notrack, nobranch,
// hoist, unroll2, hoist_u2), make_kernel_opt (:268; opt1, opt1_iprof,
// opt1_nof) and make_kernel_opt2 (:407; opt2, opt2_nof), launched by
// build_fill (:194) as VARIANTS (:538) picks. Every variant runs on K2's
// tables (read codes already expanded into their orientation) and computes
// what its TPU variant computes: the exact ones (v0, hoist, unroll2,
// hoist_u2, opt1, opt1_iprof, opt2) give the multi-event fill output for
// output; nof, opt1_nof, opt2_nof, notrack and nobranch are wrong on
// purpose, to attribute time. The plain PyTorch version is
// kbench_fill_reference in tools/kbench2.py.
//
// The base layout is K1's: one warp per lane (one read orientation), four
// lanes per CTA; thread t holds rows t R ... t R + R - 1 (R from
// SW_WARP_ROW_COUNTS, so M <= 832) with H and E in registers; F as the
// shuffle prefix max with carry decay d R gapE; DPX maxima; saved states
// [N][R][32] per lane in scratch (warp_grid in ops/multi_sw.py sizes it);
// the end cell as (score, column, row) on a strict >, reduced by
// reduce_end. Each knob puts back, on this layout, one part of the TPU's
// v0 that K1 left out, so the time between two rungs prices one part of
// K1's column step. Each TPU knob, with the variants that turn it, its TPU
// meaning, and its meaning here:
//
// - scan=False (nof, opt1_nof, opt2_nof). TPU: no F, so H = H'. Here: no
//   thread pass, no 5-step shuffle scan and no F in the second pass.
// - track=False (notrack). TPU: best_ref stays 0. Here: no per-thread end
//   cell and no reduce_end; score 0, end column -1, end row 0, and multi
//   from the node maxima equal to 0 over all N slots (count_top).
// - branches=False (nobranch). TPU: no seeding, no saves. Here: H and E run
//   on across node starts in column order, neither seeded nor zeroed; the
//   node maxima stay 0.
// - hoist (hoist, hoist_u2). TPU: masks and constants computed before the
//   loop. Here: the per-cell row compares (r < n_stripe, r < n_real) and
//   the t == 0 gates leave the column loop: per-row additive masks (0, or
//   kNeg past the bound) make each masked max one __viaddmax_s32, and
//   thread 0's gates become an AND and an addition; built at lane start.
//   Exact: kNeg plus a score stays below every score.
// - unroll=2 (unroll2, hoist_u2). TPU: two columns per fori step. Here: two
//   columns per loop trip, both column words loaded and decoded before the
//   first one's arithmetic; the wrapper refuses an odd column count.
// - the profile table (every variant but opt1_iprof). TPU: prof_ref
//   [5, M, TB] in VMEM, read per column. Here: [5][R][32] bytes per lane
//   in shared memory, built at lane start, entry (c, r) of thread t at byte
//   (c R + r) 32 + t (no bank conflict), read every cell in place of K1's
//   bit mask select.
// - the per-row arrays (the seven make_kernel variants). TPU: best_ref and
//   node_run_ref as (M, TB) tiles. Here: a per-row best (one word: the
//   score, then the inverted first column, so its max keeps the first
//   column on a strict >) and a per-row node run in shared memory at word
//   r 32 + t, one load and one store per cell each; rows, then the warp,
//   are reduced at a node's last column and at the lane's end, in the
//   (score, column, row) order.
// - E unclamped (opt2, opt2_nof). TPU: e = max(e, h - gOE) - gapE. Here:
//   __viaddmax_s32 without relu. Exact: H' = max(diag + prof, E, 0)
//   absorbs a negative E, and seed starts from 0.
//
// So opt1_iprof is K2's body (scalars, the bit mask profile, E clamped),
// opt1 adds the profile table, opt2 drops the clamp, v0 adds the per-row
// arrays, and the make_kernel variants each change one thing of v0.
//
// What bounds it on this card. The exact function is the multi-event fill,
// so its bound is K1's: 8 int32 operations per needed cell with DPX
// (OPS_PER_CELL in chip_smoke.py) over the SMs' INT32 lanes; the tables
// are a few MB, so not the memory. The layout works a column's rows with
// 32 threads at once from registers, as K1 does; the knobs add shared
// memory traffic (the table: one byte load per cell; the per-row arrays:
// two loads and two stores per cell) or per-cell compares, or take work
// away, and the time between rungs says what each costs.
#pragma once

#include "sw_warp.cuh"

namespace kbench {

using namespace sw_warp;

template <bool Scan, bool Track, bool Branches, bool Hoist, int Unroll,
          bool ProfTable, bool RowArrays, bool ClampE>
struct Variant {
  static constexpr bool kScan = Scan;            // F
  static constexpr bool kTrack = Track;          // end cell
  static constexpr bool kBranches = Branches;    // seeding and saves
  static constexpr bool kHoist = Hoist;          // masks built at lane start
  static constexpr int kUnroll = Unroll;         // columns per loop trip
  static constexpr bool kProfTable = ProfTable;  // [5][R][32] bytes
  static constexpr bool kRowArrays = RowArrays;  // per-row best and node run
  static constexpr bool kClampE = ClampE;        // E clamped at 0
};

// The variant of each id, in the order of VARIANTS in tools/kbench2.py.
template <int Id>
struct VariantOf;
#define KBENCH_VARIANT(ID, ...) \
  template <>                   \
  struct VariantOf<ID> {        \
    using type = Variant<__VA_ARGS__>; \
  };
KBENCH_VARIANT(0, true, true, true, false, 1, true, true, true)     // v0
KBENCH_VARIANT(1, false, true, true, false, 1, true, true, true)    // nof
KBENCH_VARIANT(2, true, false, true, false, 1, true, true, true)    // notrack
KBENCH_VARIANT(3, true, true, false, false, 1, true, true, true)    // nobranch
KBENCH_VARIANT(4, true, true, true, true, 1, true, true, true)      // hoist
KBENCH_VARIANT(5, true, true, true, false, 2, true, true, true)     // unroll2
KBENCH_VARIANT(6, true, true, true, true, 2, true, true, true)      // hoist_u2
KBENCH_VARIANT(7, true, true, true, false, 1, true, false, true)    // opt1
KBENCH_VARIANT(8, true, true, true, false, 1, false, false, true)   // opt1_iprof
KBENCH_VARIANT(9, false, true, true, false, 1, true, false, true)   // opt1_nof
KBENCH_VARIANT(10, true, true, true, false, 1, true, false, false)  // opt2
KBENCH_VARIANT(11, false, true, true, false, 1, true, false, false) // opt2_nof
#undef KBENCH_VARIANT
#define KBENCH_IDS(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11)

struct Params {
  const int32_t* packed_cols;     // [L] ref(2:0) node(14:3) start(15) last(16)
  const int32_t* pred_tables;     // [E][N][P], value N = zero state
  const int32_t* tile_col_start;  // [T]
  const int32_t* tile_col_len;    // [T]
  const int32_t* tile_event;      // [T]
  const int8_t* codes_t;          // [M][B] codes 0-3 ACGT, 4 N, 5 pad
  const int32_t* lens;            // [B]
  const int32_t* vlens;           // [B]
  int32_t* scratch;               // [grid][warps][lane_words]
  int32_t* out;                   // [4][B]
  int B, TB, N, P, M, col_bits;   // col_bits: the per-row word's column
  Scoring s;
};

// Shared memory of one warp: the per-row best and node run ([R][32] words
// each), then the profile table ([5][R][32] bytes).
template <class V, int R>
__host__ __device__ constexpr int warp_smem_bytes() {
  return (V::kRowArrays ? 2 * R * kGroup * 4 : 0) +
         (V::kProfTable ? 5 * R * kGroup : 0);
}

// The profile table of a thread's rows: entry (c, r) at (c R + r) 32 bytes
// past `prof` (which points at the thread's byte t), the score of row r
// against reference class c (class 4, N or pad, scores 0).
template <int R>
__device__ __forceinline__ void store_profile(int8_t* prof,
                                              const CodeBits& b,
                                              const Scoring& s) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = ((b.eq[c] >> r) & 1u)      ? s.match
                    : ((b.valid >> r) & 1u) ? -s.mismatch
                                            : 0;
      prof[(c * R + r) * kGroup] = static_cast<int8_t>(v);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) prof[(4 * R + r) * kGroup] = 0;
}

// The hoisted masks of a thread: 0 on its rows below the striped (real)
// length and kNeg past it, so a masked max is one __viaddmax_s32; thread
// 0's diagonal and F carry gates as an AND and an additive term.
template <int R>
struct Masks {
  int stripe[R], real[R];
  int up_keep, a_kill;
};

template <int R>
__device__ __forceinline__ Masks<R> hoisted_masks(int t, int n_stripe,
                                                  int n_real) {
  Masks<R> m;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m.stripe[r] = r < n_stripe ? 0 : kNeg;
    m.real[r] = r < n_real ? 0 : kNeg;
  }
  m.up_keep = t == 0 ? 0 : -1;
  m.a_kill = t == 0 ? kNeg : 0;
  return m;
}

// One column word, decoded.
struct Column {
  int nid;
  bool start, last;
  ColBits bits;        // inline profile
  const int8_t* prof;  // profile table: this column's class
};

template <class V, int R>
__device__ __forceinline__ Column decode(int pc, const CodeBits& codes,
                                         const int8_t* prof_table) {
  Column col{};
  const int ref = pc & 7;
  col.nid = (pc >> 3) & 0xFFF;
  col.start = (pc >> 15) & 1;
  col.last = (pc >> 16) & 1;
  if constexpr (V::kProfTable) {
    col.prof = prof_table + min(ref, 4) * R * kGroup;
  } else {
    col.bits = column_bits(codes, ref);
  }
  return col;
}

template <class V>
__device__ __forceinline__ int profile(const Column& col, int r,
                                       const Scoring& s) {
  if constexpr (V::kProfTable) {
    return col.prof[r * kGroup];
  } else {
    return ((col.bits.eq >> r) & 1u)    ? s.match
           : ((col.bits.mis >> r) & 1u) ? -s.mismatch
                                        : 0;
  }
}

template <int Id, int R>
__global__ void kbench_sw_kernel(const Params p) {
  using V = typename VariantOf<Id>::type;
  extern __shared__ int32_t kbench_smem[];
  const int t = threadIdx.x % kGroup;
  const int warps = blockDim.x / kGroup;
  const int w = threadIdx.x / kGroup;
  const int N = p.N, P = p.P, M = p.M;
  const Scoring s = p.s;
  constexpr int slot = R * kGroup;
  int32_t* saved_h =
      p.scratch + (static_cast<size_t>(blockIdx.x) * warps + w) *
                      lane_words(N, R);
  int32_t* saved_e = saved_h + static_cast<size_t>(N) * slot;
  int32_t* node_max = saved_e + static_cast<size_t>(N) * slot;
  // this thread's entries of its warp's shared memory: row r at r * 32
  char* mine = reinterpret_cast<char*>(kbench_smem) +
               w * warp_smem_bytes<V, R>();
  int32_t* row_best = reinterpret_cast<int32_t*>(mine) + t;
  int32_t* row_run = row_best + slot;
  int8_t* prof_table = reinterpret_cast<int8_t*>(mine) + t +
                       (V::kRowArrays ? 2 * slot * 4 : 0);
  const int lmask = (1 << p.col_bits) - 1;

  for (int lane = blockIdx.x * warps + w; lane < p.B;
       lane += gridDim.x * warps) {
    const int tile = lane / p.TB;
    const int c0 = p.tile_col_start[tile];
    const int clen = p.tile_col_len[tile];
    const int len = p.lens[lane];
    const int n_stripe = rows_below<R>(min(p.vlens[lane], M), t);
    const int n_real = rows_below<R>(min(len, M), t);
    const CodeBits codes = load_codes<R>(t, M, [&](int j) {
      return static_cast<int>(p.codes_t[static_cast<size_t>(j) * p.B +
                                        lane]);
    });
    zero_node_max(node_max, N, t);
    if constexpr (V::kProfTable) store_profile<R>(prof_table, codes, s);
    if constexpr (V::kRowArrays) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        row_best[r * kGroup] = 0;
        row_run[r * kGroup] = 0;
      }
    }
    const Masks<R> mk = hoisted_masks<R>(t, n_stripe, n_real);

    int h[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = 0;
      e[r] = 0;
    }
    int best = 0, best_col = 0, best_row = 0;
    int node_run = 0;
    const int32_t* pred_ev =
        p.pred_tables + static_cast<size_t>(p.tile_event[tile]) * N * P;

    auto step = [&](int c, const Column& col) {
      if (V::kBranches && col.start) {
        seed<R>(h, e, pred_ev + col.nid * P, P, N, saved_h, saved_e, t);
        node_run = 0;
      }
      int up = __shfl_up_sync(kFull, h[R - 1], 1);
      up = V::kHoist ? up & mk.up_keep : (t == 0 ? 0 : up);
      // H' in place, last row first
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const int diag = r > 0 ? h[r - 1] : up;
        h[r] = __viaddmax_s32_relu(diag, profile<V>(col, r, s), e[r]);
      }
      // A entering this thread's first row (sw_warp.cuh's column_step)
      int a = kNeg;
      if constexpr (V::kScan) {
        int run = h[0];
#pragma unroll
        for (int r = 1; r < R; ++r) {
          run = __viaddmax_s32(run, -s.gap_extend, h[r]);
        }
        const int decay = R * s.gap_extend;
#pragma unroll
        for (int d = 1; d < kGroup; d <<= 1) {
          const int o = __shfl_up_sync(kFull, run, d);
          run = __viaddmax_s32(o, -d * decay, run);
        }
        a = __shfl_up_sync(kFull, run, 1);
        a = V::kHoist ? a + mk.a_kill : (t == 0 ? kNeg : a);
      }
      const int word_col = lmask - c;
      int col_max = 0, node_end = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int hp = h[r];
        int hn = hp;
        if constexpr (V::kScan) {
          hn = __viaddmax_s32_relu(a, -s.gap_open, hp);  // max(hp, F)
          a = __viaddmax_s32(a, -s.gap_extend, hp);
        }
        h[r] = hn;
        e[r] = V::kClampE
                   ? __viaddmax_s32_relu(e[r], -s.gap_extend, hn - s.gap_open)
                   : __viaddmax_s32(e[r], -s.gap_extend, hn - s.gap_open);
        if constexpr (V::kRowArrays) {
          if constexpr (V::kTrack) {
            const int word = (hn << p.col_bits) + word_col;
            int32_t& b = row_best[r * kGroup];
            b = V::kHoist ? __viaddmax_s32(word, mk.stripe[r], b)
                          : max(b, r < n_stripe ? word : 0);
          }
          int32_t& q = row_run[r * kGroup];
          const int run = (V::kBranches && col.start) ? hn : max(q, hn);
          q = run;
          if (V::kBranches && col.last) {
            node_end = V::kHoist ? __viaddmax_s32(run, mk.real[r], node_end)
                                 : (r < n_real ? max(node_end, run)
                                               : node_end);
          }
        } else {
          if constexpr (V::kTrack) {
            col_max = V::kHoist ? __viaddmax_s32(hn, mk.stripe[r], col_max)
                                : (r < n_stripe ? max(col_max, hn)
                                                : col_max);
          }
          node_run = V::kHoist ? __viaddmax_s32(hn, mk.real[r], node_run)
                               : (r < n_real ? max(node_run, hn)
                                             : node_run);
        }
      }
      if constexpr (V::kTrack && !V::kRowArrays) {
        if (col_max > best) {
          best = col_max;
          best_col = c;
          best_row = t * R + first_row<R>(h, col_max, n_stripe);
        }
      }
      if (V::kBranches && col.last) {
        save<R>(h, e, col.nid, V::kRowArrays ? node_end : node_run, saved_h,
                saved_e, node_max, t);
      }
    };

    for (int c = 0; c < clen; c += V::kUnroll) {
      Column col[V::kUnroll];
#pragma unroll
      for (int u = 0; u < V::kUnroll; ++u) {
        col[u] = decode<V, R>(__ldg(p.packed_cols + c0 + c + u), codes,
                              prof_table);
      }
#pragma unroll
      for (int u = 0; u < V::kUnroll; ++u) step(c + u, col[u]);
    }

    if constexpr (V::kTrack && V::kRowArrays) {
      // this thread's rows in order, on a strict >: the highest word (the
      // highest score, then the first column), then the lowest row
      int word = 0, row = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = row_best[r * kGroup];
        if (b > word) {
          word = b;
          row = r;
        }
      }
      best = word >> p.col_bits;
      best_col = lmask - (word & lmask);
      best_row = t * R + row;
    }
    if constexpr (V::kTrack) reduce_end(best, best_col, best_row);
    __syncwarp();
    const int n_top = count_top(node_max, N, best, t);
    if (t == 0) {
      const bool zero = best == 0;
      p.out[lane] = best;
      p.out[p.B + lane] = zero ? -1 : c0 + best_col;
      p.out[2 * p.B + lane] = zero ? 0 : min(best_row, len - 1);
      p.out[3 * p.B + lane] = n_top > 1;
    }
    __syncwarp();
  }
}

template <int Id, int R>
int launch_rows(const Params& p, int warps, int grid, cudaStream_t stream) {
  using V = typename VariantOf<Id>::type;
  const int smem = warps * warp_smem_bytes<V, R>();
  auto kernel = kbench_sw_kernel<Id, R>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, warps * kGroup, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch variant Id at R = rows_for(M) rows per thread.
template <int Id>
int launch(const Params& p, int warps, int grid, cudaStream_t stream) {
  switch (rows_for(p.M)) {
#define KBENCH_CASE(R) \
  case R:              \
    return launch_rows<Id, R>(p, warps, grid, stream);
    SW_WARP_ROW_COUNTS(KBENCH_CASE)
#undef KBENCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of `warps` lanes of variant Id resident on one SM at M read rows.
template <int Id>
int blocks_per_sm(int M, int warps, int* out) {
  using V = typename VariantOf<Id>::type;
  switch (M > 0 ? rows_for(M) : 0) {
#define KBENCH_CASE(R)                                                  \
  case R:                                                               \
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor( \
        out, kbench_sw_kernel<Id, R>, warps * kGroup,                   \
        warps * warp_smem_bytes<V, R>()));
    SW_WARP_ROW_COUNTS(KBENCH_CASE)
#undef KBENCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace kbench

// Each variant's 15 instantiations are compiled in a source of their own
// (kbench_<variant>.cu), so nvcc builds the variants in parallel; the
// entry points in kbench_sw.cu only declare them.
#define KBENCH_INSTANTIATE(ID)                                           \
  namespace kbench {                                                     \
  template int launch<ID>(const Params&, int, int, cudaStream_t);        \
  template int blocks_per_sm<ID>(int, int, int*);                        \
  }
#define KBENCH_DECLARE(ID)                                               \
  extern template int launch<ID>(const Params&, int, int, cudaStream_t); \
  extern template int blocks_per_sm<ID>(int, int, int*);
