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
// them once; for a (36, 2^20) int32 batch that is 302 MB, 0.09 ms at
// 3.35 TB/s, while the comparisons a sort needs (about n log2 n, 7.5e8)
// take 0.011 ms at 67 Tops/s, so bytes bound it.  The network does more
// than a sort needs: log2(n)(log2(n)+1)/2 passes over the keys, 3.96e9
// compare-exchanges, which stay near that bound only while the passes stay
// on chip.  The TPU kernel kept a whole 2 MiB
// tile in VMEM; one block's shared memory holds far less.  So a block
// sorts a 32 KiB chunk in shared memory, running every stage whose
// distance is below the chunk; each longer distance costs one pass
// through device memory (global_stage), followed by one shared-memory pass
// that finishes that stage's short distances.  For n = 2^20 int32 that is
// 28 device-memory passes and 8 shared-memory passes.
//
// The pair sort (K5, K7) has the same schedule over three streams: keys,
// a one-byte tag (K5 only) and the payload as raw bits.  Its bound at
// argsort_keys' full width, (1, 2^19) int32 keys with an int32 payload:
// keys and payloads in and out plus the tags in are 4.7 MB, 1.4 us at
// 3.35 TB/s, against 1.0e7 comparisons (n log2 n), 0.15 us, so bytes bound
// it.  A chunk holds 8,192 such pairs (72 KiB with the tags, above the
// default 48 KiB), so 2^19 pairs take 21 device-memory passes and 7
// shared-memory passes, and one row gives only 64 chunks for 132 SMs.
#include "common.cuh"

namespace {

// 32 KiB of keys per shared-memory chunk.
template <typename T>
constexpr int log_chunk_max() {
  return sizeof(T) == 1 ? 15 : sizeof(T) == 2 ? 14 : sizeof(T) == 4 ? 13 : 12;
}

// The first merge stage (distance M = half a segment) on a segment that
// holds two sorted tiles [a | b] in place.  In the bitonic buffer
// a ++ reverse(b), position i pairs a[i] with b[M-1-i]; one thread takes
// the pairs at i and M-1-i together, so the four cells it reads are the
// four it writes and the pass can run in place.
template <typename T>
__global__ void merge_first(T* base, rt::Segs g, long long n_segs) {
  const long long m = 1LL << (g.log_seg - 1);
  const long long quarter = m >> 1;
  const long long total = n_segs * quarter;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long seg = p >> (g.log_seg - 2);
    const long long i = p & (quarter - 1);
    const long long i2 = m - 1 - i;
    T* x = base + rt::seg_offset(g, seg);
    T a0 = x[i], b0 = x[2 * m - 1 - i];
    T a1 = x[i2], b1 = x[m + i];
    rt::cmp_xchg<T, false>(a0, b0, true);
    rt::cmp_xchg<T, false>(a1, b1, true);
    x[i] = a0;
    x[m + i] = b0;
    x[i2] = a1;
    x[m + i2] = b1;
  }
}

template <typename T>
int sort_rows(const void* in, void* out, long long rows, int log_n, cudaStream_t st) {
  const int log_c = log_n < log_chunk_max<T>() ? log_n : log_chunk_max<T>();
  const rt::Segs g{1LL << log_n, 1, log_n};
  const long long chunks = rows << (log_n - log_c);
  const int threads = rt::threads_for(log_c);
  const size_t smem = sizeof(T) << log_c;
  T* o = static_cast<T*>(out);
  rt::smem_stages<T, false, false><<<(unsigned)chunks, threads, smem, st>>>(
      static_cast<const T*>(in), o, g, nullptr, log_c, 0, log_c - 1, 31);
  for (int s = log_c; s < log_n; ++s) {
    for (int j = s; j >= log_c; --j) {
      rt::global_stage<T><<<rt::grid_for(rows << (log_n - 1), 256), 256, 0, st>>>(o, g, rows, s, j);
    }
    rt::smem_stages<T, false, false><<<(unsigned)chunks, threads, smem, st>>>(
        o, o, g, nullptr, log_c, s, s, log_c - 1);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int merge_pairs(void* base, long long rows, long long row_stride, int per_row, int log_seg,
                cudaStream_t st) {
  const rt::Segs g{row_stride, per_row, log_seg};
  const long long n_segs = rows * per_row;
  T* x = static_cast<T*>(base);
  merge_first<T><<<rt::grid_for(n_segs << (log_seg - 2), 256), 256, 0, st>>>(x, g, n_segs);
  const int s = log_seg - 1;
  const int log_c = log_seg < log_chunk_max<T>() ? log_seg : log_chunk_max<T>();
  for (int j = s - 1; j >= log_c; --j) {
    rt::global_stage<T><<<rt::grid_for(n_segs << (log_seg - 1), 256), 256, 0, st>>>(x, g, n_segs, s, j);
  }
  rt::smem_stages<T, false, false><<<(unsigned)(n_segs << (log_seg - log_c)), rt::threads_for(log_c),
                                     sizeof(T) << log_c, st>>>(x, x, g, nullptr, log_c, s, s, s - 1);
  return (int)cudaGetLastError();
}

// Pair chunks: the largest power of two whose keys, payloads and tags
// fit 112 KiB, half the 227 KB a block may opt into, so two blocks of
// 1,024 threads share an SM.  8,192 int32/int32 tagged pairs are 72 KiB.
template <typename K, typename V, bool TAGGED>
constexpr int log_pair_chunk() {
  int l = 15;
  while (l > 7 && (rt::pair_bytes<K, V, TAGGED>() << l) > 112 * 1024) --l;
  return l;
}

// The pair sort of K5/K7 in the same schedule as sort_rows: one launch
// sorts every chunk in shared memory; each longer distance is one pass
// through device memory, then one shared-memory pass finishes the stage.
// A tagged sort that needs device-memory passes keeps its tags in
// out_tags between passes.
template <typename K, typename V, bool TAGGED>
int sort_pairs_rows(const void* keys, const void* tags, const void* vals, void* out_keys,
                    void* out_tags, void* out_vals, long long rows, int log_n, cudaStream_t st) {
  const int log_c = log_n < log_pair_chunk<K, V, TAGGED>() ? log_n : log_pair_chunk<K, V, TAGGED>();
  const bool passes = log_n > log_c;
  if (TAGGED && (tags == nullptr || (passes && out_tags == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const rt::Segs g{1LL << log_n, 1, log_n};
  const long long chunks = rows << (log_n - log_c);
  const int threads = rt::threads_for(log_c);
  const size_t smem = (size_t)rt::pair_bytes<K, V, TAGGED>() << log_c;
  auto kernel = rt::smem_stages_pairs<K, V, TAGGED, false>;
  const cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  K* ok = static_cast<K*>(out_keys);
  V* ov = static_cast<V*>(out_vals);
  uint8_t* ot = TAGGED && passes ? static_cast<uint8_t*>(out_tags) : nullptr;
  kernel<<<(unsigned)chunks, threads, smem, st>>>(
      static_cast<const K*>(keys), static_cast<const uint8_t*>(tags), static_cast<const V*>(vals),
      ok, ot, ov, g, nullptr, log_c, 0, log_c - 1, 31);
  for (int s = log_c; s < log_n; ++s) {
    for (int j = s; j >= log_c; --j) {
      rt::global_stage_pairs<K, V, TAGGED>
          <<<rt::grid_for(rows << (log_n - 1), 256), 256, 0, st>>>(ok, ot, ov, g, rows, s, j);
    }
    kernel<<<(unsigned)chunks, threads, smem, st>>>(ok, ot, ov, ok, ot, ov, g, nullptr, log_c, s, s,
                                                    log_c - 1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sort every row of the contiguous (rows, 2^log_n) batch `in` into `out`.
int rt_sort_rows(int dtype, const void* in, void* out, long long rows, int log_n, void* stream) {
  RT_DISPATCH(dtype, T, return sort_rows<T>(in, out, rows, log_n, static_cast<cudaStream_t>(stream)));
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
    return tagged ? sort_pairs_rows<K, V, true>(keys, tags, vals, out_keys, out_tags, out_vals,
                                                rows, log_n, st)
                  : sort_pairs_rows<K, V, false>(keys, tags, vals, out_keys, out_tags, out_vals,
                                                 rows, log_n, st);
  }));
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
