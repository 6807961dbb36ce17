// Bitonic tile sort and two-tile merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bitonic.py:
//   rt_sort_rows    <- sort_tile   (bitonic_sort_kernel):  full ascending
//                      bitonic sort of every row of a (rows, n) batch;
//   rt_merge_pairs  <- merge_tiles (bitonic_merge_kernel): merge two sorted
//                      tiles into the (lo, hi) halves of their union by the
//                      merge network on a ++ reverse(b);
//   rt_sort_pairs_rows <- sort_pairs_tile_tagged
//                      (bitonic_sort_pairs_tagged_kernel, tagged = 1) and
//                      sort_pairs_tile (bitonic_sort_pairs_kernel,
//                      tagged = 0): (key, payload) sort of every row, on
//                      (tag, key) when tagged.
//
// What bounds it on an H100: a sort must read the keys once and write
// them once; for a (72, 2^19) int32 batch (SortEngine.sort's tiles at
// 15.7M keys) that is 302 MB, 0.09 ms at 3.35 TB/s, while the comparisons
// a sort needs (about n log2 n, 7.1e8) take 0.011 ms at 67 Tops/s, so
// bytes bound it.  The network does more than a sort needs: 190 distances
// at 2^19, each a pass over the keys, which stay near that bound only
// while the passes stay on chip.  The TPU kernel kept a whole 2 MiB tile
// in VMEM; one block's shared memory holds far less.  So the tile sort
// (K2) runs the distances in tiers (key_tiers.cuh), each as close to the
// registers as the distance allows:
//   registers      a thread holds 16 keys: distances 1 .. 8 run with no
//                  memory traffic and no barrier;
//   warp           distances 16 .. 256 by __shfl_xor_sync between lanes;
//   shared memory  distances 512 .. 4096 in a block's 32 KiB chunk (8,192
//                  int32 keys), four distances a round trip and a barrier;
//   device memory  longer distances in windows of four: a thread loads 16
//                  keys at the window's stride, coalesced, and stores them
//                  back.
// One launch sorts every chunk; each later stage is its device windows,
// then one launch for its distances below the chunk: 15 launches at
// (72, 2^19) int32, 18 at (36, 2^20).
//
// The merge (K3) has the same bound: SortEngine.sort at 15.7M keys hands it
// one even half-pass over 36 rows of two 2^19-key tiles, 36 x 2^20 int32
// keys read once and written once, 302 MB, 0.09 ms at 3.35 TB/s, against
// 2n comparisons a merge (3.8e7, 0.6 us).  Its network is one stage, 20
// distances at that shape, so it runs them in K2's tiers: the first three
// distances in one device-memory pass that reads the second tile reversed
// and writes every cell it read (key_device_flip, below), a device window
// of four distances, then one chunk launch for the 13 distances below the
// chunk (registers, shuffles, shared memory): 3 launches.  A segment that
// fits one chunk is merged by that one launch alone.
//
// The pair sort (K5, K7) moves three streams: keys, a one-byte tag (K5
// only) and the payload as raw bits.  Its bound at argsort_keys' full
// width, (1, 2^19) int32 keys with an int32 payload: keys and payloads in
// and out plus the tags in are 4.7 MB, 1.4 us at 3.35 TB/s, against 1.0e7
// comparisons (n log2 n), 0.15 us, so bytes bound it.  The network's 190
// distances are what cost, so it runs them in tiers (pair_tiers.cuh),
// each as close to the registers as the distance allows:
//   registers      a thread holds 8 pairs: distances 1, 2, 4 run with no
//                  memory traffic and no barrier;
//   warp           distances 8 .. 128 by __shfl_xor_sync between lanes;
//   shared memory  distances 256 .. 1024 in a block's 2,048-pair chunk
//                  (18 KiB tagged), three distances a round trip and a
//                  barrier, the pairs held at that stride (transposed);
//   device memory  longer distances in windows of three: a thread loads 8
//                  pairs at the window's stride, coalesced, and stores them
//                  back.
// One launch sorts every chunk (stages 0 .. 10); each later stage s is
// its device windows, then one launch for its distances below the chunk.
// At (1, 2^19) that is 256 blocks of 256 threads and 24 launches (1 + 15
// windows + 8).  Chunks of 4,096 pairs take 20 launches but were no
// faster through the wrapper at that shape, slower for 8-byte pairs, and
// at 512 threads a block left 8-byte pairs too few registers (PERF.md).
// A cluster tier (up to 8 blocks exchanging chunks through distributed
// shared memory) would cut the launches to 10, but measured slower on the
// card, so the sort has none.
#include "key_tiers.cuh"
#include "pair_tiers.cuh"

namespace {

// ------------------------------------------------------ the tile merge (K3)
// A segment of 2^log_seg keys holds two sorted tiles [a | b] of M keys
// each; the merge is stage s = log_seg-1 of the network on a ++ reverse(b),
// every pair ascending, written back in place.  Its first distance pairs
// position i with 2M-1-i of the segment as the network reads it.  With
// Q = 2^(log_seg-3), thread l (l < Q/2) of key_device_flip holds the cells
// l + rQ and l' + rQ, l' = Q-1-l, r < 8, of its segment: a set closed
// under i -> 4Q-1-i within each half (the reversal) and i -> M+i (the
// first distance), so the thread writes exactly the cells it read.  The
// network's position l + rQ, r >= 4, holds the key stored at cell
// l' + (11-r)Q (and l' + rQ the one at l + (11-r)Q); the thread runs the
// distances 4Q, 2Q and Q (those not below the chunk) on the keys in the
// network's order, in registers, and writes them back straight: from
// then on a position of the network is the cell of the same index.
template <typename T>
__global__ void key_device_flip(T* keys, rt::Segs g, long long n_segs, int jlo) {
  const int log_q = g.log_seg - 3;
  const long long q = 1LL << log_q;
  const long long per_seg = q >> 1;
  const long long total = n_segs * per_seg;
  const int s = g.log_seg - 1;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long l = p & (per_seg - 1);
    const long long l2 = q - 1 - l;
    T* x = keys + rt::seg_offset(g, p >> (log_q - 1));
    T a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      a[r] = x[l + ((long long)r << log_q)];
      b[r] = x[l2 + ((long long)r << log_q)];
    }
    T xa[8] = {a[0], a[1], a[2], a[3], b[7], b[6], b[5], b[4]};
    T xb[8] = {b[0], b[1], b[2], b[3], a[7], a[6], a[5], a[4]};
    rt::key_reg_stages<3>(xa, (unsigned)l, log_q, s, s, jlo);
    rt::key_reg_stages<3>(xb, (unsigned)l2, log_q, s, s, jlo);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      x[l + ((long long)r << log_q)] = xa[r];
      x[l2 + ((long long)r << log_q)] = xb[r];
    }
  }
}

// The merge of K3 over every segment of g.  A segment that fits one chunk
// is merged by one chunk launch that reads it flipped.  A longer one takes
// key_device_flip for its first (up to three) distances, device windows of
// LOG_E distances down to the chunk, then one chunk launch.
template <typename T>
int merge_pairs(void* base, long long rows, long long row_stride, int per_row, int log_seg,
                cudaStream_t st) {
  constexpr int LOG_E = rt::key_log_e<T>();
  if (log_seg < LOG_E + 1 || log_seg > 31) return (int)cudaErrorInvalidValue;
  const rt::Segs g{row_stride, per_row, log_seg};
  const long long n_segs = rows * per_row;
  T* x = static_cast<T*>(base);
  const int s = log_seg - 1;
  const int log_c = log_seg < rt::key_log_chunk<T>() ? log_seg : rt::key_log_chunk<T>();
  const unsigned blocks = (unsigned)(n_segs << (log_seg - log_c));
  const int threads = 1 << (log_c - LOG_E);
  const size_t smem = sizeof(T) << log_c;
  // rows and segments start at multiples of 128 keys, so base decides
  const bool vec = rt::aligned16(base);
  if (log_seg == log_c) {
    const cudaError_t err = rt::allow_smem(rt::key_chunk_stages<T, rt::kLoadFlip>, smem);
    if (err != cudaSuccess) return (int)err;
    rt::key_chunk_stages<T, rt::kLoadFlip><<<blocks, threads, smem, st>>>(x, x, g, log_c, s, s, vec, nullptr);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = rt::allow_smem(rt::key_chunk_stages<T, rt::kLoadPlain>, smem);
  if (err != cudaSuccess) return (int)err;
  const int jflip = s - 2 > log_c ? s - 2 : log_c;
  key_device_flip<T><<<rt::grid_for(n_segs << (log_seg - 4), 256), 256, 0, st>>>(x, g, n_segs, jflip);
  for (int jhi = jflip - 1; jhi >= log_c;) {
    const int jlo = jhi - (LOG_E - 1) > log_c ? jhi - (LOG_E - 1) : log_c;
    const int jb = jlo < log_seg - LOG_E ? jlo : log_seg - LOG_E;
    rt::key_device_window<T><<<rt::grid_for(n_segs << (log_seg - LOG_E), 256), 256, 0, st>>>(x, g, n_segs, s,
                                                                                           jhi, jlo, jb);
    jhi = jlo - 1;
  }
  rt::key_chunk_stages<T, rt::kLoadPlain><<<blocks, threads, smem, st>>>(x, x, g, log_c, s, s, vec, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sort every row of the contiguous (rows, 2^log_n) batch `in` into `out`.
int rt_sort_rows(int dtype, const void* in, void* out, long long rows, int log_n, void* stream) {
  RT_DISPATCH(dtype, T, return rt::sort_rows<T>(in, out, rows, log_n, nullptr, static_cast<cudaStream_t>(stream)));
  return (int)cudaErrorInvalidValue;
}

// In place: each segment of 2^log_seg elements holds two sorted tiles;
// leave it sorted.  Segment k of row r starts at base + r*row_stride +
// k*2^log_seg, for k < per_row.
int rt_merge_pairs(int dtype, void* base, long long rows, long long row_stride, int per_row,
                   int log_seg, void* stream) {
  RT_DISPATCH(dtype, T,
              return merge_pairs<T>(base, rows, row_stride, per_row, log_seg,
                                    static_cast<cudaStream_t>(stream)));
  return (int)cudaErrorInvalidValue;
}

// Sort every row of the contiguous (rows, 2^log_n) pairs (keys, vals)
// into (out_keys, out_vals): on (tag, key) with tags one byte a pair when
// `tagged`, on the key alone otherwise (tags and out_tags unused).  The
// payload is moved as raw bits of val_width bytes (1, 2, 4 or 8).
// out_tags is (rows, 2^log_n) bytes of scratch for a tagged sort.
int rt_sort_pairs_rows(int key_code, int val_width, int tagged, const void* keys, const void* tags,
                       const void* vals, void* out_keys, void* out_tags, void* out_vals,
                       long long rows, int log_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(key_code, K, return rt::dispatch_width(val_width, [&](auto v) {
    using V = decltype(v);
    return tagged ? rt::sort_pairs_rows<K, V, true>(keys, tags, vals, out_keys, out_tags, out_vals,
                                                    rows, log_n, st)
                  : rt::sort_pairs_rows<K, V, false>(keys, tags, vals, out_keys, out_tags, out_vals,
                                                     rows, log_n, st);
  }));
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
