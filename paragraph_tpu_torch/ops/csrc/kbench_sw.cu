// Ablation ladder of the multi-event graph Smith-Waterman fill for Hopper
// (sm_90a): twelve variants of one column loop, for the kernel benchmark
// paragraph_tpu_torch/tools/kbench2.py.
//
// Replaces the TPU kernels of the JAX package's timing harness
// tools/kbench2.py, launched by build_fill and chosen by its VARIANTS:
// make_kernel (v0, nof, notrack, nobranch, hoist, unroll2, hoist_u2),
// make_kernel_opt (opt1, opt1_iprof, opt1_nof) and make_kernel_opt2 (opt2,
// opt2_nof). Each variant computes what its TPU variant computes, on the
// multi-event fill's tables with read codes already expanded into their
// orientation (K2's tables, paired_sw.cu's multi_sw_launch):
//   - exact (v0, hoist, unroll2, hoist_u2, opt1, opt1_iprof, opt2): the
//     multi-event fill, output for output;
//   - nof, opt1_nof, opt2_nof: no F recurrence (H = H');
//   - notrack: no end-cell tracking (score 0, end column -1, end row 0,
//     multi when more than one node maximum is 0);
//   - nobranch: no seeding at node starts and no saving at node ends (H
//     and E run on across node boundaries in column order; every node
//     maximum stays 0).
// The plain PyTorch version is kbench_fill_reference in tools/kbench2.py.
//
// The layout is K2's: one thread per lane (one read orientation), 32 lanes
// per CTA in one tile, H and E in shared memory [M][lanes], rows at or past
// the striped length skipped, saved boundary states [N+1][M][lanes] and
// node maxima [N][lanes] in per-CTA device scratch, the grid capped by the
// wrapper's scratch budget, the packed column word. The structural knobs
// form a ladder from the TPU's v0 to the port's K1/K2 body, so that the
// time between two rungs is the cost of one part of K1's column loop:
//   - v0 (make_kernel): a per-lane profile table in shared memory, 5 x M
//     int8 (score of each read row against each reference class, built at
//     load as prof_ref is), a per-row running best and a per-row node run
//     ([M] int32 per lane each, as the TPU's best_ref / node_run_ref
//     (M, TB) tiles: a shared-memory load and store per cell each), and E
//     clamped at 0. About 105 KB of shared memory per CTA at M = 160, so
//     two CTAs (64 lanes) fit an SM: the lost occupancy is part of what
//     the ablation measures.
//   - hoist: v0 with the row loop split at the read length and at the
//     striped length and jmask - j kept as a counter, so no per-cell mask
//     (row 0 for F, j < len for the node maximum) remains.
//   - unroll2: v0 with the column loop unrolled by 2 (the wrapper refuses
//     an odd column count, which the TPU harness would cut short).
//   - opt1 (make_kernel_opt): the best and the node maximum as per-lane
//     scalars (the TPU's (1, TB) reductions), with the profile table and
//     E clamped. The TPU keeps H and E in register carries; one thread per
//     lane at M = 160 would need 320 registers for them, so here they stay
//     in shared memory.
//   - opt1_iprof: opt1 with the profile computed inline from the read code
//     and the reference class, as K1 does: the codes take M bytes per lane
//     instead of 5 M.
//   - opt2 (make_kernel_opt2): scalars, profile table, E not clamped; this
//     is K1's recurrence with a profile table.
// opt1_iprof differs from K2 only by the clamp of E.
//
// What bounds it on this card. The exact function is the multi-event
// fill, so its bound is K1's. These bodies issue ~15 int32 operations per
// DP cell (the profile, three max for H', the F recurrence, the E update,
// the packed end-cell word and its max; paired_sw.cu); with Hopper's DPX
// instructions (__viaddmax_s32_relu, __vimax3_s32) the recurrence needs 8
// per cell of the read's real rows, and that count sets the bound. The
// tables are a few MB, so the card's int32 issue rate (132 SMs x 64 lanes
// x clock) bounds it, not its memory. The variants add shared-memory
// traffic (the table, the per-row
// arrays) or take operations away; their times against v0 and opt2 say
// what each part costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool Scan, bool Track, bool Branches, bool Hoist, int Unroll,
          bool ProfTable, bool RowArrays, bool ClampE>
struct Variant {
  static constexpr bool kScan = Scan;            // F recurrence
  static constexpr bool kTrack = Track;          // end-cell tracking
  static constexpr bool kBranches = Branches;    // node seeding and saves
  static constexpr bool kHoist = Hoist;          // row loop split, no masks
  static constexpr int kUnroll = Unroll;         // column loop unroll
  static constexpr bool kProfTable = ProfTable;  // 5 x M int8 per lane
  static constexpr bool kRowArrays = RowArrays;  // per-row best and node run
  static constexpr bool kClampE = ClampE;        // E clamped at 0
};

// In the order of VARIANTS in tools/kbench2.py (the variant id).
using V0 = Variant<true, true, true, false, 1, true, true, true>;
using Nof = Variant<false, true, true, false, 1, true, true, true>;
using Notrack = Variant<true, false, true, false, 1, true, true, true>;
using Nobranch = Variant<true, true, false, false, 1, true, true, true>;
using HoistV = Variant<true, true, true, true, 1, true, true, true>;
using Unroll2 = Variant<true, true, true, false, 2, true, true, true>;
using HoistU2 = Variant<true, true, true, true, 2, true, true, true>;
using Opt1 = Variant<true, true, true, false, 1, true, false, true>;
using Opt1Iprof = Variant<true, true, true, false, 1, false, false, true>;
using Opt1Nof = Variant<false, true, true, false, 1, true, false, true>;
using Opt2 = Variant<true, true, true, false, 1, true, false, false>;
using Opt2Nof = Variant<false, true, true, false, 1, true, false, false>;

struct Params {
  const int32_t* packed_cols;     // [L] ref(2:0) node(14:3) start(15) last(16)
  const int32_t* pred_tables;     // [E][N][P], slot N = zero state
  const int32_t* tile_col_start;  // [T]
  const int32_t* tile_col_len;    // [T]
  const int32_t* tile_event;      // [T]
  const int8_t* codes_t;          // [M][B] codes 0-3 ACGT, 4 N, 5 pad
  const int32_t* lens;            // [B]
  const int32_t* vlens;           // [B]
  int32_t* scratch;               // [grid][2 (N+1) M + N][lanes]
  int32_t* out;                   // [4][B]
  int B, TB, N, P, M;
  int gap_open, gap_extend, match, mismatch, col_bits, j_bits;
};

template <class V>
size_t smem_bytes(int M, int lanes) {
  const size_t words = V::kRowArrays ? 4 : 2;  // H, E (+ best, node run)
  const size_t bytes = V::kProfTable ? 5 : 1;  // profile table, or codes
  return static_cast<size_t>(M) * lanes * (words * sizeof(int32_t) + bytes);
}

template <class V>
__global__ void kbench_sw_kernel(const Params p) {
  extern __shared__ int32_t smem[];
  const int lpb = blockDim.x;
  const int tid = threadIdx.x;
  const int M = p.M, N = p.N, P = p.P;
  const size_t state = static_cast<size_t>(M) * lpb;
  int32_t* sh_h = smem;          // [M][lpb]
  int32_t* sh_e = smem + state;  // [M][lpb]
  int32_t* sh_best = sh_e + state;                            // [M][lpb]
  int32_t* sh_run = sh_best + state;                          // [M][lpb]
  int8_t* sh_bytes = reinterpret_cast<int8_t*>(
      V::kRowArrays ? sh_run + state : sh_best);
  // profile table [5][M][lpb], or the codes [M][lpb]
  int8_t* sh_prof = sh_bytes;
  int8_t* sh_code = sh_bytes;

  int32_t* saved_h = p.scratch + blockIdx.x * (2 * (N + 1) * state +
                                               static_cast<size_t>(N) * lpb);
  int32_t* saved_e = saved_h + (N + 1) * state;
  int32_t* node_max = saved_e + (N + 1) * state;

  const int s1 = p.col_bits + p.j_bits;
  const int lmask = (1 << p.col_bits) - 1;
  const int jmask = (1 << p.j_bits) - 1;
  const int gap_oe = p.gap_open - p.gap_extend;
  const int n_groups = p.B / lpb;

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int lane = grp * lpb + tid;
    const int tile = lane / p.TB;
    const int ev = p.tile_event[tile];
    const int c0 = p.tile_col_start[tile];
    const int clen = p.tile_col_len[tile];
    const int len = p.lens[lane];
    const int rows = min(p.vlens[lane], M);
    const int n_real = min(len, rows);

    // load: the profile table or the codes; zero H/E, the per-row arrays
    // and this CTA's scratch
    for (int j = 0; j < rows; ++j) {
      const int idx = j * lpb + tid;
      const int x = p.codes_t[static_cast<size_t>(j) * p.B + lane];
      if (V::kProfTable) {
        for (int c = 0; c < 5; ++c) {
          sh_prof[(c * M + j) * lpb + tid] = static_cast<int8_t>(
              (c < 4 && x < 4) ? (x == c ? p.match : -p.mismatch) : 0);
        }
      } else {
        sh_code[idx] = static_cast<int8_t>(x);
      }
      sh_h[idx] = 0;
      sh_e[idx] = 0;
      if (V::kRowArrays) {
        sh_best[idx] = 0;
        sh_run[idx] = 0;
      }
    }
    if (V::kBranches) {
      for (int s = 0; s <= N; ++s) {
        for (int j = 0; j < rows; ++j) {
          saved_h[s * state + j * lpb + tid] = 0;
          saved_e[s * state + j * lpb + tid] = 0;
        }
      }
    }
    for (int n = 0; n < N; ++n) node_max[n * lpb + tid] = 0;

    int best = 0;     // packed end-cell word (scalar variants)
    int nodecol = 0;  // running node maximum (scalar variants)
    const int32_t* pred_ev = p.pred_tables + static_cast<size_t>(ev) * N * P;

    // per-column values, set by column() for cell()
    int ref_c = 0, col_term = 0;
    bool start = false, last = false;
    const int32_t* preds = pred_ev;
    int32_t* sv_h = saved_h;
    int32_t* sv_e = saved_e;
    int diag = 0, hp_prev = 0, f = 0, nm = 0;

    // one DP cell: row j of the current column; `first` is row 0 (F is
    // 0 there), `real` a row below the read length (node maxima)
    auto cell = [&](int j, int jterm, bool first, bool real) {
      const int idx = j * lpb + tid;
      int h_old, e;
      if (V::kBranches && start) {
        // seed: elementwise max of the predecessors' saved states
        h_old = saved_h[preds[0] * state + idx];
        e = saved_e[preds[0] * state + idx];
        for (int q = 1; q < P; ++q) {
          h_old = max(h_old, saved_h[preds[q] * state + idx]);
          e = max(e, saved_e[preds[q] * state + idx]);
        }
      } else {
        h_old = sh_h[idx];
        e = sh_e[idx];
      }
      int prof;
      if (V::kProfTable) {
        prof = sh_prof[(ref_c * M + j) * lpb + tid];
      } else {
        const int code = sh_code[idx];
        prof = (ref_c < 4 && code < 4)
                   ? (code == ref_c ? p.match : -p.mismatch)
                   : 0;
      }
      const int hp = max(max(diag + prof, 0), e);
      int h = hp;
      if (V::kScan) {
        if (!first) f = max(max(f - p.gap_extend, hp_prev - p.gap_open), 0);
        h = max(hp, f);
      }
      const int e_next =
          V::kClampE ? max(max(e - p.gap_extend, h - p.gap_open), 0)
                     : max(e, h - gap_oe) - p.gap_extend;
      sh_h[idx] = h;
      sh_e[idx] = e_next;
      if (V::kBranches && last) {
        sv_h[idx] = h;
        sv_e[idx] = e_next;
      }
      if (V::kTrack) {
        const int packed = (h << s1) + col_term + jterm;
        if (V::kRowArrays) {
          sh_best[idx] = max(sh_best[idx], packed);
        } else {
          best = max(best, packed);
        }
      }
      if (V::kRowArrays) {
        const int run = (V::kBranches && start) ? h : max(sh_run[idx], h);
        sh_run[idx] = run;
        if (V::kBranches && last && real) nm = max(nm, run);
      } else if (real) {
        nodecol = max(nodecol, h);
      }
      diag = h_old;
      hp_prev = hp;
    };

    auto column = [&](int t) {
      const int pc = p.packed_cols[c0 + t];
      ref_c = pc & 7;
      const int nid = (pc >> 3) & 0xFFF;
      start = (pc >> 15) & 1;
      last = (pc >> 16) & 1;
      preds = pred_ev + nid * P;
      sv_h = saved_h + nid * state;
      sv_e = saved_e + nid * state;
      if (!V::kRowArrays && V::kBranches && start) nodecol = 0;
      col_term = (lmask - t) << p.j_bits;
      diag = 0;
      hp_prev = 0;
      f = 0;
      nm = 0;
      if (V::kHoist) {
        int jt = jmask;
        if (rows > 0) cell(0, jt--, true, n_real > 0);
        int j = 1;
        for (; j < n_real; ++j) cell(j, jt--, false, true);
        for (; j < rows; ++j) cell(j, jt--, false, false);
      } else {
        for (int j = 0; j < rows; ++j) cell(j, jmask - j, j == 0, j < len);
      }
      if (V::kBranches && last) {
        node_max[nid * lpb + tid] = V::kRowArrays ? nm : nodecol;
      }
    };

    for (int t = 0; t < clen; t += V::kUnroll) {
      column(t);
      if constexpr (V::kUnroll == 2) column(t + 1);
    }

    if (V::kRowArrays && V::kTrack) {
      for (int j = 0; j < rows; ++j) best = max(best, sh_best[j * lpb + tid]);
    }
    const int score = best >> s1;
    int n_top = 0;
    for (int n = 0; n < N; ++n) n_top += node_max[n * lpb + tid] == score;
    const bool zero = score == 0;
    const int end_col = c0 + (lmask - ((best >> p.j_bits) & lmask));
    const int first_j = jmask - (best & jmask);
    p.out[lane] = score;
    p.out[p.B + lane] = zero ? -1 : end_col;
    p.out[2 * p.B + lane] = zero ? 0 : min(first_j, len - 1);
    p.out[3 * p.B + lane] = n_top > 1;
  }
}

template <class V>
int launch(const Params& p, int lanes_per_block, int grid,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<V>(p.M, lanes_per_block);
  auto kernel = kbench_sw_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, lanes_per_block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kbench_sw_launch(
    int variant, const void* packed_cols, const void* pred_tables,
    const void* tile_col_start, const void* tile_col_len,
    const void* tile_event, const void* codes_t, const void* lens,
    const void* vlens, void* scratch, void* out, int B, int TB, int N, int P,
    int M, int lanes_per_block, int grid, int gap_open, int gap_extend,
    int match, int mismatch, int col_bits, int j_bits, void* stream) {
  if (lanes_per_block <= 0 || TB % lanes_per_block != 0 ||
      B % lanes_per_block != 0 || grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.packed_cols = static_cast<const int32_t*>(packed_cols);
  p.pred_tables = static_cast<const int32_t*>(pred_tables);
  p.tile_col_start = static_cast<const int32_t*>(tile_col_start);
  p.tile_col_len = static_cast<const int32_t*>(tile_col_len);
  p.tile_event = static_cast<const int32_t*>(tile_event);
  p.codes_t = static_cast<const int8_t*>(codes_t);
  p.lens = static_cast<const int32_t*>(lens);
  p.vlens = static_cast<const int32_t*>(vlens);
  p.scratch = static_cast<int32_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  p.B = B;
  p.TB = TB;
  p.N = N;
  p.P = P;
  p.M = M;
  p.gap_open = gap_open;
  p.gap_extend = gap_extend;
  p.match = match;
  p.mismatch = mismatch;
  p.col_bits = col_bits;
  p.j_bits = j_bits;
  const int lpb = lanes_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<V0>(p, lpb, grid, s);
    case 1: return launch<Nof>(p, lpb, grid, s);
    case 2: return launch<Notrack>(p, lpb, grid, s);
    case 3: return launch<Nobranch>(p, lpb, grid, s);
    case 4: return launch<HoistV>(p, lpb, grid, s);
    case 5: return launch<Unroll2>(p, lpb, grid, s);
    case 6: return launch<HoistU2>(p, lpb, grid, s);
    case 7: return launch<Opt1>(p, lpb, grid, s);
    case 8: return launch<Opt1Iprof>(p, lpb, grid, s);
    case 9: return launch<Opt1Nof>(p, lpb, grid, s);
    case 10: return launch<Opt2>(p, lpb, grid, s);
    case 11: return launch<Opt2Nof>(p, lpb, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
