// Read tables of one paired dispatch, built on the card from the bytes the
// host staged (ops/multi_sw.py: stage_pair_tables, pair_tables_kernel; the
// plain version is pair_tables_reference).
//
// Replaces no TPU kernel. The JAX package builds these tables on the host
// (paragraph_tpu/ops/multi_sw.py::build_pair_tables) and ships them as nine
// arrays; the port did the same until that build and its nine copies held
// the card idle for half of each dispatch. Now the host ships each read's
// bytes once, with per-tile and per-read numbers, and this kernel writes,
// on the launch's stream ahead of K1 (paired_sw.cu), exactly what
// build_pair_tables + dispatch_tables gave:
//   base_codes_t [M][Bb] int8: _NT classes, lower case folded in (0-3 ACGT,
//     4 any other byte), pad class 5 from each read's length on;
//   base_vlens [Bb]: lengths rounded up to 16 (gssw's striped padding);
//   col_idx [B] (int16 or int32), flip [B], comp [B] int8: lane r of a
//     block of n reads from read b0 reads b0 + r (r < n), b0 + r - n
//     complemented (n <= r < 2n), b0 past 2n (pad); the forward graph's
//     block (even event) flips its second n lanes, the reversed graph's
//     (odd event) its first n.
//
// What bounds it: bytes, and at a dispatch's size (about 0.6 MB in and out)
// the launch itself. The code matrix is a transpose (read-major bytes in,
// row-major codes out): a CTA stages a 64-read x 64-row tile in shared
// memory, so the loads (a read's consecutive bytes) and the stores
// (consecutive reads of one row) are both coalesced. The lane tables take
// one thread per lane. Both run in one launch: the grid's first
// code_blocks CTAs transpose, the rest fill the lanes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // reads and rows of a transpose tile
constexpr int kPitch = kTile + 1;  // padded row of the shared tile
constexpr int kThreads = 256;

struct TableParams {
  const int32_t* tile_event;  // [T]
  const int32_t* tile_lane0;  // [T] first lane of the tile's block
  const int32_t* tile_n;      // [T] reads of the block's pair
  const int32_t* tile_base;   // [T] first read of the block's pair
  const int32_t* read_start;  // [Bb] byte offset in blob
  const int32_t* lens;        // [Bb]
  const uint8_t* blob;
  int8_t* codes_t;   // [M][Bb]
  int32_t* vlens;    // [Bb]
  void* col_idx;     // [B] int16 or int32
  int8_t* flip;      // [B]
  int8_t* comp;      // [B]
  int B, TB, Bb, M, col_idx_bytes;
  int read_tiles, code_blocks;
};

__device__ __forceinline__ int8_t base_code(uint8_t c) {
  switch (c | 0x20) {  // only 'X' and 'x' map to 'x'
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    default: return 4;
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_tables_kernel(const TableParams p) {
  __shared__ int8_t tile[kTile * kPitch];
  const int t = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < p.code_blocks) {
    const int b0 = (blockIdx.x % p.read_tiles) * kTile;
    const int j0 = (blockIdx.x / p.read_tiles) * kTile;
    // load: 64 threads walk one read's bytes
    const int jj = t % kTile;
    for (int rr = t / kTile; rr < kTile; rr += kThreads / kTile) {
      const int b = b0 + rr;
      const int j = j0 + jj;
      int8_t code = 5;
      if (b < p.Bb && j < p.lens[b]) {
        code = base_code(p.blob[p.read_start[b] + j]);
      }
      tile[jj * kPitch + rr] = code;
    }
    __syncthreads();
    // store: 64 threads write one row over consecutive reads
    const int rr = t % kTile;
    const int b = b0 + rr;
    for (int jr = t / kTile; jr < kTile; jr += kThreads / kTile) {
      const int j = j0 + jr;
      if (b < p.Bb && j < p.M) {
        p.codes_t[static_cast<size_t>(j) * p.Bb + b] = tile[jr * kPitch + rr];
      }
    }
    return;
  }
  const int lane = (blockIdx.x - p.code_blocks) * kThreads + t;
  if (lane < p.Bb) p.vlens[lane] = (p.lens[lane] + 15) / 16 * 16;
  if (lane >= p.B) return;
  const int tl = lane / p.TB;
  const int n = p.tile_n[tl];
  const int r = lane - p.tile_lane0[tl];
  const bool fwd = r < n;
  const bool back = !fwd && r < 2 * n;
  const int col = p.tile_base[tl] + (fwd ? r : back ? r - n : 0);
  const bool rev_graph = (p.tile_event[tl] & 1) != 0;
  if (p.col_idx_bytes == 2) {
    static_cast<int16_t*>(p.col_idx)[lane] = static_cast<int16_t>(col);
  } else {
    static_cast<int32_t*>(p.col_idx)[lane] = col;
  }
  p.flip[lane] = rev_graph ? fwd : back;
  p.comp[lane] = back;
}

}  // namespace

extern "C" int pair_tables_launch(
    const void* tile_event, const void* tile_lane0, const void* tile_n,
    const void* tile_base, const void* read_start, const void* lens,
    const void* blob, void* codes_t, void* vlens, void* col_idx,
    int col_idx_bytes, void* flip, void* comp, int T, int TB, int Bb, int M,
    void* stream) {
  const long long B = static_cast<long long>(T) * TB;
  if (T <= 0 || TB <= 0 || Bb <= 0 || M <= 0 || B > INT32_MAX ||
      (col_idx_bytes != 2 && col_idx_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TableParams p;
  p.tile_event = static_cast<const int32_t*>(tile_event);
  p.tile_lane0 = static_cast<const int32_t*>(tile_lane0);
  p.tile_n = static_cast<const int32_t*>(tile_n);
  p.tile_base = static_cast<const int32_t*>(tile_base);
  p.read_start = static_cast<const int32_t*>(read_start);
  p.lens = static_cast<const int32_t*>(lens);
  p.blob = static_cast<const uint8_t*>(blob);
  p.codes_t = static_cast<int8_t*>(codes_t);
  p.vlens = static_cast<int32_t*>(vlens);
  p.col_idx = col_idx;
  p.flip = static_cast<int8_t*>(flip);
  p.comp = static_cast<int8_t*>(comp);
  p.B = static_cast<int>(B);
  p.TB = TB;
  p.Bb = Bb;
  p.M = M;
  p.col_idx_bytes = col_idx_bytes;
  p.read_tiles = (Bb + kTile - 1) / kTile;
  p.code_blocks = p.read_tiles * ((M + kTile - 1) / kTile);
  const int lanes = p.B > Bb ? p.B : Bb;
  const int grid = p.code_blocks + (lanes + kThreads - 1) / kThreads;
  pair_tables_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
