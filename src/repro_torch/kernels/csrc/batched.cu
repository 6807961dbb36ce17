// Fused segmented row sort for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/batched.py,
// batched_row_sort (batched_row_sort_kernel): for every row b of a
// (rows, L) batch, refill positions >= seg_lens[b] with the dtype max,
// whatever they held, then sort the row ascending.  TWO_OP selects
// Paeth's NICE 2-op compare-exchange (integer keys only).
//
// What bounds it on an H100: a (64, 8192) int32 batch is 2 MiB each way,
// 1.3 us at 3.35 TB/s; the comparisons a sort of its rows needs (about
// 8192 * 13 a row, 6.8e6) take 0.1 us at 67 Tops/s, so bytes bound it (the
// network's own 91 stages of 4096 compare-exchanges a row, 4.8e7, would
// take 0.7 us).  Rows this short fit one
// block's shared memory whole (8192 keys of 8 bytes are 64 KiB, allowed
// above the default 48 KiB with cudaFuncSetAttribute), so one block owns
// one row: it reads its own length (Hopper has no scalar prefetch),
// refills the pad cells while loading, runs every stage in shared memory
// and writes the row once.  Device memory is touched once each way; the
// block's stages and barriers are the cost, and 64 rows occupy only 64 of
// the 132 SMs.
//
// rt_batched_row_sort_pairs replaces batched_row_sort_pairs
// (batched_row_sort_pairs_kernel): the same one-block-per-row sort of
// (key, payload) pairs on (tag, key), with tag = pos >= seg_lens[b]
// computed on load, so pad slots sort after every real one even where a
// real key equals the dtype max; the tail leaves as dtype-max keys with
// zero payloads.  A (64, 8192) int32/int32 batch moves 4 MiB each way at
// most (the pad cells are not read), 2.5 us, well above its 0.1 us of
// comparisons.  A row's keys, payloads and tags must fit the 227 KB
// opt-in (16,384 int32/int32 pairs are 144 KiB); the wrapper sends longer
// rows to rt_sort_pairs_rows in bitonic.cu.
#include "common.cuh"

namespace {

template <typename T, bool TWO_OP>
int row_sort(const void* in, void* out, const int* seg_lens, long long rows, int log_n,
             cudaStream_t st) {
  const rt::Segs g{1LL << log_n, 1, log_n};
  const size_t smem = sizeof(T) << log_n;
  auto kernel = rt::smem_stages<T, TWO_OP>;
  const cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)rows, rt::threads_for(log_n), smem, st>>>(static_cast<const T*>(in), static_cast<T*>(out), g,
                                                                seg_lens);
  return (int)cudaGetLastError();
}

// K6: the pair twin of row_sort.  The tag is computed on load from the
// row length, so no tag stream is read or written.
template <typename K, typename V>
int row_sort_pairs(const void* keys, const void* vals, void* out_keys, void* out_vals,
                   const int* seg_lens, long long rows, int log_n, cudaStream_t st) {
  const rt::Segs g{1LL << log_n, 1, log_n};
  const size_t smem = (size_t)rt::pair_bytes<K, V, true>() << log_n;
  auto kernel = rt::smem_stages_pairs<K, V, true, true>;
  const cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)rows, rt::threads_for(log_n), smem, st>>>(
      static_cast<const K*>(keys), nullptr, static_cast<const V*>(vals), static_cast<K*>(out_keys),
      nullptr, static_cast<V*>(out_vals), g, seg_lens, log_n, 0, log_n - 1, 31);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sort each row of the contiguous (rows, 2^log_n) batch `in` to its
// seg_lens[row] valid prefix plus a dtype-max tail, into `out`.
int rt_batched_row_sort(int dtype, int two_op, const void* in, void* out, const int* seg_lens,
                        long long rows, int log_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (two_op) {
    RT_DISPATCH(dtype, T, return row_sort<T, true>(in, out, seg_lens, rows, log_n, st));
  }
  RT_DISPATCH(dtype, T, return row_sort<T, false>(in, out, seg_lens, rows, log_n, st));
  return (int)cudaErrorInvalidValue;
}

// Sort each row of the contiguous (rows, 2^log_n) pairs (keys, vals) to
// its seg_lens[row] valid prefix on (tag, key), tag = pos >= seg_lens[row];
// the tail comes out as dtype-max keys with zero payloads.  The payload is
// moved as raw bits of val_width bytes (1, 2, 4 or 8).
int rt_batched_row_sort_pairs(int key_code, int val_width, const void* keys, const void* vals,
                              void* out_keys, void* out_vals, const int* seg_lens, long long rows,
                              int log_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(key_code, K, return rt::dispatch_width(val_width, [&](auto v) {
    using V = decltype(v);
    return row_sort_pairs<K, V>(keys, vals, out_keys, out_vals, seg_lens, rows, log_n, st);
  }));
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
