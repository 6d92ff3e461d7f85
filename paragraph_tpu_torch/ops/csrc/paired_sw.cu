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
// What bounds it on this card. Each DP cell costs ~15 integer ALU
// operations (profile select, three max for H', the F recurrence, the E
// update, the packed end-cell word and its max) and five shared-memory
// accesses (load H, E and the read code; store H and E). Rows are a
// sequential recurrence per lane, so there is no arithmetic to share
// between threads; the kernel is bound by integer issue and by
// shared-memory bandwidth, and, because each lane keeps an [M] column of
// H and E (M = 160 for 150 bp reads, 1.25 KB per lane), by how many lanes
// fit in shared memory: about 180 per SM, which leaves most warp slots of
// an SM empty.
//
// What this simple design does about it. One thread owns one lane and
// walks the event's columns; for each column it runs the rows j < vlen
// (rows at or past the striped length never influence rows above them,
// and their end-cell candidates can never win) in the sequential form of
// the TPU kernel's closed-form prefix max:
//     hp  = max(diag + prof, 0, E_j)
//     F_j = max(0, F_{j-1} - gapE, hp_{j-1} - gapO)        (F_0 = 0)
//     H_j = max(hp, F_j)
//     E_j = max(E_j, H_j - (gapO - gapE)) - gapE           (no 0 clamp)
// which is exact because gapO >= gapE. The H/E column lives in shared
// memory laid out [M][lanes] so neighbouring threads touch neighbouring
// words; the read's codes are expanded into orientation at load (gather
// by col_idx, row flip below the read length, complement of ACGT) and
// kept beside them as int8. A CTA of 32 lanes shares one tile, so the
// column word and predecessor ids are broadcast loads. Saved boundary
// states [N+1][M][lanes] and node maxima [N][lanes] are per-CTA scratch
// in device memory that the wrapper allocates; the grid is capped so the
// scratch stays within the wrapper's budget, and each CTA strides over
// lane groups.
//
// Left for later: the DPX instructions (__viaddmax_s32 for diag + prof,
// __vimax3_s32 for the three-way maxima), int16 state (two rows per
// 32-bit word, doubling the lanes that fit in shared memory), and a
// warp per read with the F recurrence as a shuffle prefix max, which
// spreads one lane's rows over 32 threads and fills the SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const int32_t* packed_cols;     // [L] ref(2:0) node(14:3) start(15) last(16)
  const int32_t* pred_tables;     // [E][N][P], slot N = zero state
  const int32_t* tile_col_start;  // [T]
  const int32_t* tile_col_len;    // [T]
  const int32_t* tile_event;      // [T]
  const int8_t* base_codes_t;     // [M][Bb] forward codes 0-3 ACGT, 4 N, 5 pad
  const int32_t* base_lens;       // [Bb]
  const int32_t* base_vlens;      // [Bb]
  const int8_t* flip;             // [B]
  const int8_t* comp;             // [B]
  int32_t* scratch;               // [grid][2 (N+1) M + N][lanes]
  int32_t* out;                   // [4][B]
  int B, TB, N, P, M, Bb;
  int gap_open, gap_extend, match, mismatch, col_bits, j_bits;
};

template <typename IdxT>
__global__ void paired_sw_kernel(const Params p,
                                 const IdxT* __restrict__ col_idx) {
  extern __shared__ int32_t smem[];
  const int lpb = blockDim.x;
  const int tid = threadIdx.x;
  const int M = p.M, N = p.N, P = p.P;
  int32_t* sh_h = smem;                     // [M][lpb]
  int32_t* sh_e = smem + M * lpb;           // [M][lpb]
  int8_t* sh_code = reinterpret_cast<int8_t*>(smem + 2 * M * lpb);

  const size_t state = static_cast<size_t>(M) * lpb;
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
    const int bcol = static_cast<int>(col_idx[lane]);
    const int len = p.base_lens[bcol];
    const int rows = min(p.base_vlens[bcol], M);
    const bool fl = p.flip[lane] != 0;
    const bool cp = p.comp[lane] != 0;

    // orientation expansion at load; zero H/E and this CTA's scratch
    for (int j = 0; j < rows; ++j) {
      const int src = (fl && j < len) ? len - 1 - j : j;
      int x = p.base_codes_t[static_cast<size_t>(src) * p.Bb + bcol];
      if (cp && x < 4) x = 3 - x;
      sh_code[j * lpb + tid] = static_cast<int8_t>(x);
      sh_h[j * lpb + tid] = 0;
      sh_e[j * lpb + tid] = 0;
    }
    for (int s = 0; s <= N; ++s) {
      for (int j = 0; j < rows; ++j) {
        saved_h[s * state + j * lpb + tid] = 0;
        saved_e[s * state + j * lpb + tid] = 0;
      }
    }
    for (int n = 0; n < N; ++n) node_max[n * lpb + tid] = 0;

    int best = 0;
    int nodecol = 0;
    const int32_t* pred_ev = p.pred_tables + static_cast<size_t>(ev) * N * P;
    for (int t = 0; t < clen; ++t) {
      const int pc = p.packed_cols[c0 + t];
      const int ref_c = pc & 7;
      const int nid = (pc >> 3) & 0xFFF;
      const bool start = (pc >> 15) & 1;
      const bool last = (pc >> 16) & 1;
      const int32_t* preds = pred_ev + nid * P;
      int32_t* sv_h = saved_h + nid * state;
      int32_t* sv_e = saved_e + nid * state;
      if (start) nodecol = 0;
      const int col_term = (lmask - t) << p.j_bits;
      int diag = 0;     // H of row j-1 in the previous column
      int hp_prev = 0;  // H' of row j-1 in this column
      int f = 0;
      for (int j = 0; j < rows; ++j) {
        const int idx = j * lpb + tid;
        int h_old, e;
        if (start) {
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
        const int code = sh_code[idx];
        const int prof = (ref_c < 4 && code < 4)
                             ? (code == ref_c ? p.match : -p.mismatch)
                             : 0;
        const int hp = max(max(diag + prof, 0), e);
        if (j > 0) f = max(max(f - p.gap_extend, hp_prev - p.gap_open), 0);
        const int h = max(hp, f);
        const int e_next = max(e, h - gap_oe) - p.gap_extend;
        sh_h[idx] = h;
        sh_e[idx] = e_next;
        if (last) {
          sv_h[idx] = h;
          sv_e[idx] = e_next;
        }
        best = max(best, (h << s1) + col_term + (jmask - j));
        if (j < len) nodecol = max(nodecol, h);
        diag = h_old;
        hp_prev = hp;
      }
      if (last) node_max[nid * lpb + tid] = nodecol;
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

template <typename IdxT>
int launch(const Params& p, const void* col_idx, int lanes_per_block,
           int grid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.M) * lanes_per_block *
                      (2 * sizeof(int32_t) + sizeof(int8_t));
  auto kernel = paired_sw_kernel<IdxT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, lanes_per_block, smem, stream>>>(
      p, static_cast<const IdxT*>(col_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paired_sw_launch(
    const void* packed_cols, const void* pred_tables,
    const void* tile_col_start, const void* tile_col_len,
    const void* tile_event, const void* base_codes_t, const void* base_lens,
    const void* base_vlens, const void* col_idx, int col_idx_bytes,
    const void* flip, const void* comp, void* scratch, void* out, int B,
    int TB, int N, int P, int M, int Bb, int lanes_per_block, int grid,
    int gap_open, int gap_extend, int match, int mismatch, int col_bits,
    int j_bits, void* stream) {
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
  p.base_codes_t = static_cast<const int8_t*>(base_codes_t);
  p.base_lens = static_cast<const int32_t*>(base_lens);
  p.base_vlens = static_cast<const int32_t*>(base_vlens);
  p.flip = static_cast<const int8_t*>(flip);
  p.comp = static_cast<const int8_t*>(comp);
  p.scratch = static_cast<int32_t*>(scratch);
  p.out = static_cast<int32_t*>(out);
  p.B = B;
  p.TB = TB;
  p.N = N;
  p.P = P;
  p.M = M;
  p.Bb = Bb;
  p.gap_open = gap_open;
  p.gap_extend = gap_extend;
  p.match = match;
  p.mismatch = mismatch;
  p.col_bits = col_bits;
  p.j_bits = j_bits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (col_idx_bytes == 2) {
    return launch<int16_t>(p, col_idx, lanes_per_block, grid, s);
  }
  if (col_idx_bytes == 4) {
    return launch<int32_t>(p, col_idx, lanes_per_block, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paired_sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
