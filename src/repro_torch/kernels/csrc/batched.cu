// Fused segmented row sort for Hopper (sm_90a).
//
// rt_batched_row_sort replaces the Pallas TPU kernel of
// src/repro/kernels/batched.py, batched_row_sort (batched_row_sort_kernel):
// for every row b of a (rows, L) batch, refill positions >= seg_lens[b]
// with the dtype max, whatever they held, then sort the row ascending.
// TWO_OP selects Paeth's NICE 2-op compare-exchange (integer keys only).
//
// What bounds it on an H100: a (64, 8192) int32 batch is at most 2 MiB each
// way, 1.3 us at 3.35 TB/s; the comparisons a sort of its rows needs (about
// 8192 * 13 a row, 6.8e6) take 0.1 us at 67 Tops/s, so bytes bound it.
// What costs is the network's 91 distances a row, so the row sort runs in
// the tile sort's tiers (key_tiers.cuh: 16 keys a thread in registers,
// warp shuffles, a 32 KiB shared-memory chunk, device-memory windows), with
// the refill made as the first chunk launch loads the row
// (kLoadFill): a home run wholly in the padding is not read.  An int32 or
// float32 row of up to 8,192 keys is one chunk, so the sort is one launch
// of one block a row; a longer row (int64 at 8,192 keys, or any row past
// 32 KiB) follows the tile sort's schedule after that first launch.
//
// rt_batched_row_sort_pairs replaces batched_row_sort_pairs
// (batched_row_sort_pairs_kernel): the sort of (key, payload) pairs on
// (tag, key), with tag = pos >= seg_lens[b] made on load, so pad slots
// sort after every real one even where a real key equals the dtype max;
// the tail leaves as dtype-max keys with zero payloads.  A (64, 8192)
// int32/int32 batch moves 4 MiB each way at most (the pad cells are not
// read), 2.5 us, well above its 0.1 us of comparisons.  It runs the pair
// sort's tiers (pair_tiers.cuh) with the whole row in shared memory:
// pair_chunk_rows, one launch, a cluster of two blocks a row, each block
// holding half the row (8,192 int32/int32 pairs and their tags are 72
// KiB).  Every distance but the row's longest stays inside one block;
// that one (stage log_n-1's first) runs between the two blocks through
// distributed shared memory, between cluster barriers.  One block a row
// kept 64 rows on 64 of the 132 SMs, held by its instructions; two use 128.
// A thread holds one home run of 8 pairs at a time in registers and takes
// its block's runs in turn, so 8-byte pairs keep the registers they have
// in the pair sort.  Rows whose keys, payloads and tags pass the 227 KB
// opt-in go to rt_sort_pairs_rows (the wrapper).
#include <cooperative_groups.h>

#include "key_tiers.cuh"
#include "pair_tiers.cuh"

namespace {

template <typename T, bool TWO_OP>
int row_sort(const void* in, void* out, const int* seg_lens, long long rows, int log_n, cudaStream_t st) {
  return rt::sort_rows<T, true, TWO_OP>(in, out, rows, log_n, seg_lens, st);
}

// K6's blocks: a cluster of 2^kLogRowPairBlocks blocks sorts a row, each
// block holding a span of it, with 2^kLogRowPairThreads threads taking
// home runs of kE pairs in turn.  Two blocks a row beat one and four at
// (64, 8192), and one launch beat the pair sort's five (PERF.md).
constexpr int kLogRowPairBlocks = 1;
constexpr int kLogRowPairThreads = 8;

// The kE pairs at row positions pos .. pos+kE-1 (keys at kp, payloads at
// vp), with the row's padding made on load (K6): tag pos+r >= len, the
// plain version's signed compare; a pad pair takes the dtype-max key and
// a zero payload.  A run wholly at or past len is not read; one that
// straddles it is read and then selected pair by pair.
template <typename K, typename V>
__device__ __forceinline__ void load_filled(const K* kp, const V* vp, long long pos, long long len,
                                            rt::Held<K, V, true>& x, bool vec) {
  using namespace rt;
  if (pos >= len) {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      x.k[r] = max_sentinel<K>();
      x.v[r] = 0;
      x.t[r] = 1;
    }
    return;
  }
  load_run(kp, x.k, vec);
  load_run(vp, x.v, vec);
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const bool pad = pos + r >= len;
    x.t[r] = pad;
    if (pad) {
      x.k[r] = max_sentinel<K>();
      x.v[r] = 0;
    }
  }
}

// Distance 2^j of stage s between the spans of a cluster's blocks: the
// row's pairs (i, i + 2^j), bit j of i clear, split evenly over the
// blocks, each pair read from and written to the shared memory of the
// blocks that hold it (distributed shared memory).
template <typename K, typename V>
__device__ __forceinline__ void cross_distance(const cooperative_groups::cluster_group& cluster,
                                               unsigned char* smem_raw, int log_span, int log_n, int s, int j) {
  using namespace rt;
  const unsigned rank = cluster.block_rank();
  const unsigned per_block = 1u << (log_n - 1 - kLogRowPairBlocks);
  const unsigned span_mask = (1u << log_span) - 1;
  for (unsigned p = rank * per_block + threadIdx.x; p < (rank + 1) * per_block; p += blockDim.x) {
    const unsigned i = ((p >> j) << (j + 1)) | (p & ((1u << j) - 1));
    const unsigned k = i + (1u << j);
    const Chunk<K, V> a = chunk_at<K, V>(cluster.map_shared_rank(smem_raw, i >> log_span), 1 << log_span);
    const Chunk<K, V> b = chunk_at<K, V>(cluster.map_shared_rank(smem_raw, k >> log_span), 1 << log_span);
    const unsigned oa = slot(i & span_mask), ob = slot(k & span_mask);
    const K ka = a.k[oa], kb = b.k[ob];
    const unsigned ta = a.t[oa], tb = b.t[ob];
    if (held_swap<K, true>(ka, kb, ta, tb, ((i >> (s + 1)) & 1) == 0)) {
      const V va = a.v[oa];
      a.k[oa] = kb;
      a.t[oa] = (uint8_t)tb;
      a.v[oa] = b.v[ob];
      b.k[ob] = ka;
      b.t[ob] = (uint8_t)ta;
      b.v[ob] = va;
    }
  }
}

// Every stage of the sort of one row of 2^log_n pairs a cluster, the row
// whole in its blocks' shared memory (keys, payloads, tags), each block a
// span of 2^log_span pairs.  Stages whose distances stay inside a warp's
// 32 runs (0 .. log_w-1) run run by run in registers and shuffles,
// straight from the filled load; each later stage s takes its distances
// past the span between the blocks (cross_distance, a cluster barrier
// each), its distances from there down to the warp's span in
// shared-memory windows of kLogE distances a barrier (each thread taking
// window bases in turn), then the shorter ones run by run.  The last
// stage stores to `kout` / `vout`.  The direction bit comes from a pair's
// row index in every layout, as in the pair sort, so the bytes are the
// plain network's.
template <typename K, typename V>
__global__ void __cluster_dims__(1 << kLogRowPairBlocks, 1, 1) __launch_bounds__(1 << kLogRowPairThreads)
    pair_chunk_rows(const K* kin, const V* vin, K* kout, V* vout, const int* seg_lens, int log_n, bool vec) {
  using namespace rt;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int log_span = log_n - kLogRowPairBlocks;
  const int c = 1 << log_span;
  const Chunk<K, V> sm = chunk_at<K, V>(smem_raw, c);
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = t & 31;
  const unsigned mask = nt >= 32 ? 0xffffffffu : (1u << nt) - 1;
  const long long row = (long long)blockIdx.x >> kLogRowPairBlocks;
  const unsigned span_base = rank << log_span;  // the row index of the block's first pair
  const long long off = (row << log_n) + span_base;
  const long long len = seg_lens[row];
  const int runs = c / (kE * nt);
  const int log_w = log_span < kLogE + 5 ? log_span : kLogE + 5;

  for (int q = 0; q < runs; ++q) {
    const unsigned h = kE * (q * nt + t);  // a warp's lanes hold consecutive runs
    const unsigned g0 = span_base + h;
    Held<K, V, true> x;
    load_filled(kin + off + h, vin + off + h, g0, len, x, vec);
    for (int s = 0; s < log_w; ++s) {
      int j = s;
      for (; j >= kLogE; --j) warp_stage(x, g0, s, j, mask, lane);
      reg_stages(x, g0, 0, s, j, 0);
    }
    if (log_w == log_n) {
      store_run(kout + off + h, x.k, vec);
      store_run(vout + off + h, x.v, vec);
    } else {
      const unsigned home = slot(h);
      store_run(sm.k + home, x.k, true);
      store_run(sm.v + home, x.v, true);
      store_tags(sm.t + home, x.t, true);
    }
  }
  for (int s = log_w; s < log_n; ++s) {
    int j = s;
    if (j >= log_span) {
      cluster.sync();  // every span is in its block's shared memory
      for (; j >= log_span; --j) {
        cross_distance<K, V>(cluster, smem_raw, log_span, log_n, s, j);
        cluster.sync();
      }
    } else {
      __syncthreads();
    }
    while (j >= log_w) {
      const int jlo = j - (kLogE - 1) > log_w ? j - (kLogE - 1) : log_w;
      const int jb = jlo < log_span - kLogE ? jlo : log_span - kLogE;
      for (int u = t; u < (c >> kLogE); u += nt) smem_window<K, V, true>(sm, u, jb, j, jlo, span_base, s);
      j = jlo - 1;
      __syncthreads();
    }
    for (int q = 0; q < runs; ++q) {
      const unsigned h = kE * (q * nt + t);
      const unsigned g0 = span_base + h;
      const unsigned home = slot(h);
      Held<K, V, true> x;
      load_run(sm.k + home, x.k, true);
      load_run(sm.v + home, x.v, true);
      load_tags(sm.t + home, x.t, true);
      for (int jj = log_w - 1; jj >= kLogE; --jj) warp_stage(x, g0, s, jj, mask, lane);
      reg_stages(x, g0, 0, s, kLogE - 1, 0);
      if (s == log_n - 1) {
        store_run(kout + off + h, x.k, vec);
        store_run(vout + off + h, x.v, vec);
      } else {
        store_run(sm.k + home, x.k, true);
        store_run(sm.v + home, x.v, true);
        store_tags(sm.t + home, x.t, true);
      }
    }
  }
}

template <typename K, typename V>
int row_sort_pairs(const void* keys, const void* vals, void* out_keys, void* out_vals, const int* seg_lens,
                   long long rows, int log_n, cudaStream_t st) {
  if (log_n < 7 || log_n > 31) return (int)cudaErrorInvalidValue;
  const int log_span = log_n - kLogRowPairBlocks;
  const int log_t = kLogRowPairThreads < log_span - rt::kLogE ? kLogRowPairThreads : log_span - rt::kLogE;
  const size_t smem = (size_t)rt::pair_bytes<K, V, true>() << log_span;
  const cudaError_t err = rt::allow_smem(pair_chunk_rows<K, V>, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec =
      rt::aligned16(keys) && rt::aligned16(vals) && rt::aligned16(out_keys) && rt::aligned16(out_vals);
  pair_chunk_rows<K, V><<<(unsigned)(rows << kLogRowPairBlocks), 1 << log_t, smem, st>>>(
      static_cast<const K*>(keys), static_cast<const V*>(vals), static_cast<K*>(out_keys),
      static_cast<V*>(out_vals), seg_lens, log_n, vec);
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
