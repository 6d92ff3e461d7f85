// Paired multi-event graph Smith-Waterman fill for Hopper (sm_90a).
//
// Replaces the TPU kernel paragraph_tpu/ops/multi_sw.py::_make_kernel as
// launched by paired_pallas_fill, and computes exactly what it computes:
// affine-gap local SW (match 1, mismatch 4, open 6, extend 1; N and pad
// score 0) of every lane (one read orientation) over its tile's event
// column range, with node-start seeding from the predecessors' saved
// boundary states, gssw's end-cell tie-break and the multi-node flag.
// The plain PyTorch version is paired_fill_reference in ops/multi_sw.py.
//
// The same body, with the load-time orientation expansion switched off
// (kExpand = false), replaces the TPU launcher multi_pallas_fill, which
// runs _make_kernel on read codes already expanded on the host: each lane
// then reads its own codes, length and striped length. That entry point
// is multi_sw_launch; its plain version is multi_fill_reference.
//
// What bounds it on this card. The main path's dispatches hold tens of
// thousands of lanes, enough to fill every SM many times over, so the fill
// is bound by INT32 issue: about 15 integer operations per cell (profile
// select, H' with one DPX max, two for F, E, the end-cell and node maxima
// with their row masks), plus per column and thread the F scan's five
// shuffles and maxima, the diagonal's shuffle and the column's decode,
// which each thread spreads over its R rows.
//
// What this design does about it (sw_warp.cuh). One warp owns one lane and
// each thread R = ceil(M / 32) of its rows, in registers: there is no
// per-cell shared-memory traffic, the rows of a column are worked by 32
// threads at once, with F as a shuffle prefix max (the TPU kernel's
// log-step prefix max over its vector's sublanes, here over a warp's
// threads), and the SM holds as many lanes as its registers allow (the
// thread-per-lane design held 128, limited by shared memory). E is clamped
// at 0: hp = max(diag + prof, E, 0) absorbs any negative E, so the outputs
// are the TPU kernel's, and the zero state adds nothing to a seed. The
// packed end-cell word is not needed: each thread keeps (score, column,
// row) scalars and the warp reduces them in gssw's order; the wrapper
// still refuses the shapes whose word would overflow, as the plain fill
// does. A lane's read codes are expanded into orientation at load (gather
// by col_idx, row flip below the read length, complement of ACGT) straight
// into each thread's code masks. A CTA of lanes_per_block warps lies in
// one tile, so the column word and predecessor ids are broadcast loads.
// Each warp strides over lanes; the grid is capped so the per-lane scratch
// stays within the wrapper's budget.
//
// Reads longer than 832 rows (M > kBandRows) take paired_sw_band_kernel:
// the same column step over bands of 832 rows (sw_warp.cuh, band_lane),
// with two boundary words per column and band carried in per-lane scratch
// over at most band_cols columns (the wrapper's bound on a tile's column
// count). Launches with M <= 832 keep paired_sw_kernel.

#include "sw_warp.cuh"

namespace {

using namespace sw_warp;

struct Params {
  const int32_t* packed_cols;     // [L] ref(2:0) node(14:3) start(15) last(16)
  const int32_t* pred_tables;     // [E][N][P], value N = zero state
  const int32_t* tile_col_start;  // [T]
  const int32_t* tile_col_len;    // [T]
  const int32_t* tile_event;      // [T]
  const int8_t* base_codes_t;     // [M][Bb] forward codes 0-3 ACGT, 4 N, 5 pad
  const int32_t* base_lens;       // [Bb]
  const int32_t* base_vlens;      // [Bb]
  const void* col_idx;            // [B] int16 or int32
  const int8_t* flip;             // [B]
  const int8_t* comp;             // [B]
  int32_t* scratch;               // [grid][warps][lane_words]
  int32_t* out;                   // [4][B]
  int B, TB, N, P, M, Bb, col_idx_bytes;
  int band_cols;                  // band path: columns per tile at most
  Scoring s;
};

template <int R, bool kExpand>
__global__ void paired_sw_kernel(const Params p) {
  const int t = threadIdx.x % kGroup;
  const int warps = blockDim.x / kGroup;
  const int w = threadIdx.x / kGroup;
  const int N = p.N, P = p.P, M = p.M;
  constexpr int slot = R * kGroup;
  int32_t* saved_h =
      p.scratch + (static_cast<size_t>(blockIdx.x) * warps + w) *
                      lane_words(N, R);
  int32_t* saved_e = saved_h + static_cast<size_t>(N) * slot;
  int32_t* node_max = saved_e + static_cast<size_t>(N) * slot;

  for (int lane = blockIdx.x * warps + w; lane < p.B;
       lane += gridDim.x * warps) {
    const int tile = lane / p.TB;
    const int c0 = p.tile_col_start[tile];
    const int clen = p.tile_col_len[tile];
    int bcol = lane;
    if (kExpand) {
      bcol = p.col_idx_bytes == 2
                 ? static_cast<const int16_t*>(p.col_idx)[lane]
                 : static_cast<const int32_t*>(p.col_idx)[lane];
    }
    const int len = p.base_lens[bcol];
    const int n_stripe = rows_below<R>(min(p.base_vlens[bcol], M), t);
    const int n_real = rows_below<R>(min(len, M), t);
    const bool fl = kExpand && p.flip[lane] != 0;
    const bool cp = kExpand && p.comp[lane] != 0;
    const CodeBits codes = load_codes<R>(t, M, [&](int j) {
      const int src = (fl && j < len) ? len - 1 - j : j;
      const int x = p.base_codes_t[static_cast<size_t>(src) * p.Bb + bcol];
      return (cp && x < 4) ? 3 - x : x;
    });
    zero_node_max(node_max, N, t);

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
    for (int c = 0; c < clen; ++c) {
      const int pc = __ldg(p.packed_cols + c0 + c);
      const int nid = (pc >> 3) & 0xFFF;
      if ((pc >> 15) & 1) {
        seed<R>(h, e, pred_ev + nid * P, P, N, saved_h, saved_e, t);
        node_run = 0;
      }
      int col_max = 0;
      column_step<R>(h, e, column_bits(codes, pc & 7), p.s, t, n_stripe,
                     n_real, col_max, node_run);
      if (col_max > best) {
        best = col_max;
        best_col = c;
        best_row = t * R + first_row<R>(h, col_max, n_stripe);
      }
      if ((pc >> 16) & 1) {
        save<R>(h, e, nid, node_run, saved_h, saved_e, node_max, t);
      }
    }

    reduce_end(best, best_col, best_row);
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

// Reads longer than kBandRows: paired_sw_kernel's lane, with band_lane
// over the tile's columns in place of the column loop.
template <bool kExpand>
__global__ void paired_sw_band_kernel(const Params p) {
  const int t = threadIdx.x % kGroup;
  const int warps = blockDim.x / kGroup;
  const int w = threadIdx.x / kGroup;
  const int N = p.N, P = p.P;
  int32_t* scratch =
      p.scratch + (static_cast<size_t>(blockIdx.x) * warps + w) *
                      band_lane_words(N, p.band_cols);
  const int32_t* node_max = scratch + 2 * static_cast<size_t>(N) * kBandRows;

  for (int lane = blockIdx.x * warps + w; lane < p.B;
       lane += gridDim.x * warps) {
    const int tile = lane / p.TB;
    const int c0 = p.tile_col_start[tile];
    int bcol = lane;
    if (kExpand) {
      bcol = p.col_idx_bytes == 2
                 ? static_cast<const int16_t*>(p.col_idx)[lane]
                 : static_cast<const int32_t*>(p.col_idx)[lane];
    }
    const int len = p.base_lens[bcol];
    const bool fl = kExpand && p.flip[lane] != 0;
    const bool cp = kExpand && p.comp[lane] != 0;
    const int32_t* pred_ev =
        p.pred_tables + static_cast<size_t>(p.tile_event[tile]) * N * P;
    int best, best_col, best_row;
    band_lane(
        t, p.M, len, p.base_vlens[bcol], p.tile_col_len[tile], N, P,
        p.band_cols, p.s, scratch,
        [&](int c) {
          const int pc = __ldg(p.packed_cols + c0 + c);
          return Col{pc & 7, (pc >> 3) & 0xFFF, ((pc >> 15) & 1) != 0,
                     ((pc >> 16) & 1) != 0};
        },
        [&](int nid) { return pred_ev + nid * P; },
        [&](int j) {
          const int src = (fl && j < len) ? len - 1 - j : j;
          const int x = p.base_codes_t[static_cast<size_t>(src) * p.Bb + bcol];
          return (cp && x < 4) ? 3 - x : x;
        },
        best, best_col, best_row);
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

template <int R, bool kExpand>
int launch(const Params& p, int lanes_per_block, int grid,
           cudaStream_t stream) {
  paired_sw_kernel<R, kExpand>
      <<<grid, lanes_per_block * kGroup, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kExpand>
int launch_rows(const Params& p, int lanes_per_block, int grid,
                cudaStream_t stream) {
  if (p.M > kBandRows) {
    if (p.band_cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
    paired_sw_band_kernel<kExpand>
        <<<grid, lanes_per_block * kGroup, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  switch (rows_for(p.M)) {
#define PAIRED_SW_CASE(R) \
  case R:                 \
    return launch<R, kExpand>(p, lanes_per_block, grid, stream);
    SW_WARP_ROW_COUNTS(PAIRED_SW_CASE)
#undef PAIRED_SW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

void set_common(Params& p, const void* packed_cols, const void* pred_tables,
                const void* tile_col_start, const void* tile_col_len,
                const void* tile_event, const void* codes_t, const void* lens,
                const void* vlens, void* scratch, void* out, int B, int TB,
                int N, int P, int M, int Bb, int band_cols, int gap_open,
                int gap_extend, int match, int mismatch) {
  p.packed_cols = static_cast<const int32_t*>(packed_cols);
  p.pred_tables = static_cast<const int32_t*>(pred_tables);
  p.tile_col_start = static_cast<const int32_t*>(tile_col_start);
  p.tile_col_len = static_cast<const int32_t*>(tile_col_len);
  p.tile_event = static_cast<const int32_t*>(tile_event);
  p.base_codes_t = static_cast<const int8_t*>(codes_t);
  p.base_lens = static_cast<const int32_t*>(lens);
  p.base_vlens = static_cast<const int32_t*>(vlens);
  p.col_idx = nullptr;
  p.flip = nullptr;
  p.comp = nullptr;
  p.scratch = static_cast<int32_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  p.B = B;
  p.TB = TB;
  p.N = N;
  p.P = P;
  p.M = M;
  p.Bb = Bb;
  p.col_idx_bytes = 4;
  p.band_cols = band_cols;
  p.s = {gap_open, gap_extend, match, mismatch};
}

bool bad_shape(int B, int TB, int N, int P, int M, int lanes_per_block,
               int grid, int gap_open, int gap_extend) {
  return lanes_per_block <= 0 || lanes_per_block > 32 || TB <= 0 ||
         TB % lanes_per_block != 0 || B % TB != 0 || grid <= 0 || N <= 0 ||
         P <= 0 || M <= 0 || gap_extend < 0 || gap_open < gap_extend;
}

}  // namespace

extern "C" int paired_sw_launch(
    const void* packed_cols, const void* pred_tables,
    const void* tile_col_start, const void* tile_col_len,
    const void* tile_event, const void* base_codes_t, const void* base_lens,
    const void* base_vlens, const void* col_idx, int col_idx_bytes,
    const void* flip, const void* comp, void* scratch, void* out, int B,
    int TB, int N, int P, int M, int Bb, int band_cols, int lanes_per_block,
    int grid, int gap_open, int gap_extend, int match, int mismatch,
    void* stream) {
  if (bad_shape(B, TB, N, P, M, lanes_per_block, grid, gap_open,
                gap_extend) ||
      (col_idx_bytes != 2 && col_idx_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  set_common(p, packed_cols, pred_tables, tile_col_start, tile_col_len,
             tile_event, base_codes_t, base_lens, base_vlens, scratch, out, B,
             TB, N, P, M, Bb, band_cols, gap_open, gap_extend, match,
             mismatch);
  p.col_idx = col_idx;
  p.col_idx_bytes = col_idx_bytes;
  p.flip = static_cast<const int8_t*>(flip);
  p.comp = static_cast<const int8_t*>(comp);
  return launch_rows<true>(p, lanes_per_block, grid,
                           static_cast<cudaStream_t>(stream));
}

// K2: the same fill on read codes already expanded on the host
// (read_codes_t [M][B], lens / vlens [B]); no col_idx, flip or complement.
extern "C" int multi_sw_launch(
    const void* packed_cols, const void* pred_tables,
    const void* tile_col_start, const void* tile_col_len,
    const void* tile_event, const void* read_codes_t, const void* lens,
    const void* vlens, void* scratch, void* out, int B, int TB, int N, int P,
    int M, int band_cols, int lanes_per_block, int grid, int gap_open,
    int gap_extend, int match, int mismatch, void* stream) {
  if (bad_shape(B, TB, N, P, M, lanes_per_block, grid, gap_open,
                gap_extend)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  set_common(p, packed_cols, pred_tables, tile_col_start, tile_col_len,
             tile_event, read_codes_t, lens, vlens, scratch, out, B, TB, N, P,
             M, B, band_cols, gap_open, gap_extend, match, mismatch);
  return launch_rows<false>(p, lanes_per_block, grid,
                            static_cast<cudaStream_t>(stream));
}

// CTAs of lanes_per_block warps resident on one SM at M read rows, for the
// paired kernel (expand != 0) or the multi kernel; past kBandRows, for its
// band kernel.
extern "C" int paired_sw_blocks_per_sm(int M, int lanes_per_block,
                                       int expand, int* out) {
  if (M > kBandRows) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out,
        expand ? paired_sw_band_kernel<true> : paired_sw_band_kernel<false>,
        lanes_per_block * kGroup, 0));
  }
  switch (M > 0 ? rows_for(M) : 0) {
#define PAIRED_SW_CASE(R)                                            \
  case R:                                                            \
    return static_cast<int>(                                         \
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(               \
            out,                                                     \
            expand ? paired_sw_kernel<R, true>                       \
                   : paired_sw_kernel<R, false>,                     \
            lanes_per_block * kGroup, 0));
    SW_WARP_ROW_COUNTS(PAIRED_SW_CASE)
#undef PAIRED_SW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paired_sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
