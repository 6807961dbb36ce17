// Bucket histogram and stable in-bucket ranks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/partition_kernel.py,
// bucket_count_rank (bucket_count_rank_kernel):
//   counts[b] = #{i : ids[i] == b}
//   ranks[i]  = #{j < i : ids[j] == ids[i]}   (stable scatter offsets)
// An id outside [0, B) is not counted and gets rank 0; it writes nothing
// outside the output buffers.
//
// What bounds it on an H100: 2^24 ids read once and 2^24 ranks written
// once are 134 MB, 40 us at 3.35 TB/s; two operations an id are far below
// that.  The TPU kernel walks its tiles in order and carries the running
// counts from one tile to the next.  CUDA blocks run in no order, so this
// is a chained scan over tiles with decoupled look-back, one launch that
// reads each id once:
//   tiles in order  a block takes its tile index from an atomic counter,
//                   so every tile it waits on is already running and the
//                   look-back cannot deadlock;
//   ids in regs     a block loads its tile once and holds each id packed
//                   under its rank until the tile's prefix is known;
//   rank            B <= 64 (sort's and top_k's 33-37 buckets): a thread
//                   holds 16 consecutive ids and counts them in its own
//                   column of 16-bit counters in shared memory, and one
//                   scan of each bucket's row across the threads gives
//                   every thread its start; larger B: each warp ranks its
//                   32 ids a step by __match_any_sync on top of its running
//                   count of the bucket, 16-bit, in shared memory, and a
//                   scan over the warps gives each warp its start;
//   look-back       the tile publishes each bucket's count with a flag,
//                   reads its predecessors' words a window at a time until
//                   it meets an inclusive prefix, publishes its own, and
//                   writes its ranks; the last tile writes counts.
// What the card chose (tools/sort_variant_times.py bcr, PERF.md): match
// costs more than the rest of a step, so small B counts per thread and no
// lane talks to another; 16 ids a thread, windows of 4; B > 256 takes 16
// warps and 64 ids a thread, so 16 times fewer tiles look back over 2,368
// words each.  The status words, one a (tile, bucket), and the tile
// counter are zeroed by one cudaMemsetAsync before the launch.  A word
// holds its flag in the top two bits and a count below, so n stays under
// 2^30.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBcrWarps = 8;          // warps a block, B <= 256
constexpr int kBcrWarpsLarge = 16;    // warps a block, B > 256
constexpr int kBcrThreadBuckets = 64; // B up to which each thread counts its own ids
constexpr int kBcrItems = 16;         // ids a thread holds, B <= 256
constexpr int kBcrItemsLarge = 64;    // ids a thread holds, B > 256
constexpr int kBcrWindow = 4;         // predecessors a look-back step reads, B <= 256
constexpr int kBcrWindowLarge = 2;    // the same, B > 256
constexpr int kMaxBuckets = 4096;

constexpr unsigned kAggregate = 1u << 30;  // the tile's own count
constexpr unsigned kPrefix = 2u << 30;     // the count of the tile and every tile before it
constexpr unsigned kCount = kAggregate - 1;
constexpr int kIdBits = 12;                // an id below kMaxBuckets, packed under its rank
constexpr int kIdMask = (1 << kIdBits) - 1;

__device__ __forceinline__ unsigned load_status(const unsigned* p) { return *(const volatile unsigned*)p; }
__device__ __forceinline__ void store_status(unsigned* p, unsigned v) { *(volatile unsigned*)p = v; }

// The tile index, in the order blocks start.
__device__ __forceinline__ int take_tile(unsigned* next_tile) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)atomicAdd(next_tile, 1u);
  __syncthreads();
  return tile;
}

// The look-back of tile `tile` (> 0): excl[k] becomes the count of bucket
// threadIdx.x + k * THREADS in every tile before it.  Each step reads
// WINDOW predecessors of each of the thread's unfinished buckets at once;
// a bucket is finished at the first inclusive prefix it meets, and the
// others advance past the words that every one of them found published.
template <int THREADS, int PER, int WINDOW>
__device__ __forceinline__ void look_back(const unsigned* status, int nb, int tile, unsigned (&excl)[PER]) {
  unsigned done = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    excl[k] = 0;
    if (threadIdx.x + k * THREADS >= nb) done |= 1u << k;
  }
  const unsigned all = PER == 32 ? ~0u : (1u << PER) - 1;
  for (int p = tile - 1; done != all;) {
    unsigned v[PER][WINDOW];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
#pragma unroll
      for (int w = 0; w < WINDOW; ++w) {
        const bool want = !((done >> k) & 1) && p - w >= 0;
        v[k][w] = want ? load_status(status + (long long)(p - w) * nb + threadIdx.x + k * THREADS) : 0u;
      }
    }
    // q: words every unfinished bucket found published ahead of its prefix
    int q = WINDOW;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if ((done >> k) & 1) continue;
      int e = WINDOW, f = WINDOW;
#pragma unroll
      for (int w = WINDOW - 1; w >= 0; --w) {
        const unsigned flag = v[k][w] & ~kCount;
        if (flag == 0u) e = w;
        if (flag == kPrefix) f = w;
      }
      if (f >= e && e < q) q = e;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if ((done >> k) & 1) continue;
      int e = WINDOW, f = WINDOW;
#pragma unroll
      for (int w = WINDOW - 1; w >= 0; --w) {
        const unsigned flag = v[k][w] & ~kCount;
        if (flag == 0u) e = w;
        if (flag == kPrefix) f = w;
      }
      const int last = f < e ? f : q - 1;
#pragma unroll
      for (int w = 0; w < WINDOW; ++w) {
        if (w <= last) excl[k] += v[k][w] & kCount;
      }
      if (f < e) done |= 1u << k;
    }
    p -= q;
    if (q == 0) __nanosleep(32);
  }
}

// Chain the tile into the scan: publish its count of every bucket
// (tile_counts[b]), look back, publish the inclusive prefixes, and write
// counts if it is the last tile.  Leaves in tile_counts[b] the count of
// bucket b in every tile before this one.
template <int THREADS, int PER, int WINDOW>
__device__ __forceinline__ void chain_tile(int* tile_counts, int nb, int tile, int n_tiles, unsigned* status,
                                           int* counts) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = threadIdx.x + k * THREADS;
    if (b < nb) store_status(status + (long long)tile * nb + b, (tile == 0 ? kPrefix : kAggregate) | tile_counts[b]);
  }
  unsigned excl[PER];
  if (tile > 0) {
    look_back<THREADS, PER, WINDOW>(status, nb, tile, excl);
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) excl[k] = 0;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = threadIdx.x + k * THREADS;
    if (b >= nb) continue;
    const unsigned incl = excl[k] + tile_counts[b];
    if (tile > 0) store_status(status + (long long)tile * nb + b, kPrefix | incl);
    if (tile == n_tiles - 1) counts[b] = (int)incl;
    tile_counts[b] = (int)excl[k];
  }
}

// B <= kBcrThreadBuckets.  Thread t holds ITEMS consecutive ids of the
// tile and counts them in its own column of 16-bit counters (two buckets a
// word, rows of THREADS words: no bank conflicts, no cross-lane step); a
// scan of each row across the threads, one warp a row, then gives every
// thread its start in each bucket and the tile its counts.
template <int WARPS, int ITEMS, int WINDOW>
__global__ void __launch_bounds__(WARPS * 32)
    bcr_thread_counts(const int* ids, long long n, int nb, int* counts, int* ranks, unsigned* status,
                      unsigned* next_tile, int n_tiles, bool vec) {
  constexpr int THREADS = WARPS * 32;
  extern __shared__ unsigned col[];  // [bucket / 2][thread], then the tile's counts
  int* tile_counts = reinterpret_cast<int*>(col + (nb + 1) / 2 * THREADS);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int rows = (nb + 1) / 2;
  for (int k = t; k < rows * THREADS; k += THREADS) col[k] = 0;
  const int tile = take_tile(next_tile);
  const long long start = ((long long)tile * THREADS + t) * ITEMS;
  int held[ITEMS];
  if (vec && start + ITEMS <= n) {
#pragma unroll
    for (int k = 0; k < ITEMS; k += 4) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(ids + start + k));
      held[k] = q.x;
      held[k + 1] = q.y;
      held[k + 2] = q.z;
      held[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) held[k] = start + k < n ? __ldcs(ids + start + k) : -1;
  }
  // each id packed under its rank among this thread's ids before it
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int id = held[k];
    if ((unsigned)id < (unsigned)nb) {
      unsigned* c = col + (id >> 1) * THREADS + t;
      const int sh = (id & 1) * 16;
      const unsigned word = *c;
      *c = word + (1u << sh);
      held[k] = (int)(((word >> sh) & 0xffffu) << kIdBits) | id;
    } else {
      held[k] = -1;
    }
  }
  __syncthreads();
  for (int row = t >> 5; row < rows; row += WARPS) {
    unsigned carry = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      unsigned* c = col + row * THREADS + 32 * i + lane;
      const unsigned v = *c;
      unsigned x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      *c = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) {
      tile_counts[2 * row] = (int)(carry & 0xffffu);
      if (2 * row + 1 < nb) tile_counts[2 * row + 1] = (int)(carry >> 16);
    }
  }
  __syncthreads();
  chain_tile<THREADS, 1, WINDOW>(tile_counts, nb, tile, n_tiles, status, counts);
  __syncthreads();
  int out[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int h = held[k];
    const int id = h & kIdMask;
    out[k] = h < 0 ? 0 : tile_counts[id] + (int)((col[(id >> 1) * THREADS + t] >> ((id & 1) * 16)) & 0xffffu) +
                             (h >> kIdBits);
  }
  if (vec && start + ITEMS <= n) {
#pragma unroll
    for (int k = 0; k < ITEMS; k += 4) {
      __stcs(reinterpret_cast<int4*>(ranks + start + k), make_int4(out[k], out[k + 1], out[k + 2], out[k + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (start + k < n) __stcs(ranks + start + k, out[k]);
    }
  }
}

// Larger B.  Each warp owns a stretch of 32 * ITEMS ids of the tile, held
// 32 at a time across its lanes; each id is ranked among equal ids of its
// 32 by __match_any_sync, on top of the warp's running count of its
// bucket in shared memory (WARPS x B counters); a scan over the warps
// gives each warp its start in each bucket.  A thread owns the buckets
// threadIdx.x + k * THREADS, k < PER.
template <int WARPS, int ITEMS, int PER, int WINDOW>
__global__ void __launch_bounds__(WARPS * 32) bcr_match(const int* ids, long long n, int nb, int* counts, int* ranks,
                                                        unsigned* status, unsigned* next_tile, int n_tiles) {
  constexpr int THREADS = WARPS * 32;
  constexpr int kStretch = 32 * ITEMS;  // ids a warp
  static_assert(WARPS * kStretch <= 65535, "a warp's start in its bucket is held in 16 bits");
  extern __shared__ int tile_counts[];  // nb, then WARPS x nb 16-bit warp counters
  unsigned short* warp_counts = reinterpret_cast<unsigned short*>(tile_counts + nb);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < WARPS * nb; k += THREADS) warp_counts[k] = 0;
  const int tile = take_tile(next_tile);
  const long long start = (long long)tile * (WARPS * kStretch) + (long long)w * kStretch + lane;
  int held[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = start + 32 * k;
    held[k] = i < n ? __ldcs(ids + i) : -1;
  }
  // each id packed under its rank among equal ids of the warp's stretch
  unsigned short* mine = warp_counts + w * nb;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int id = held[k];
    const bool ok = (unsigned)id < (unsigned)nb;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? id : -1);
    const int r = ok ? mine[id] + __popc(peers & below) : 0;
    __syncwarp();
    if (ok && (peers & below) == 0u) mine[id] += __popc(peers);
    __syncwarp();
    held[k] = ok ? (r << kIdBits) | id : -1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = threadIdx.x + k * THREADS;
    if (b >= nb) continue;
    int acc = 0;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) {
      const int c = warp_counts[v * nb + b];
      warp_counts[v * nb + b] = (unsigned short)acc;
      acc += c;
    }
    tile_counts[b] = acc;
  }
  chain_tile<THREADS, PER, WINDOW>(tile_counts, nb, tile, n_tiles, status, counts);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = start + 32 * k;
    const int h = held[k];
    const int id = h & kIdMask;
    if (i < n) __stcs(ranks + i, h < 0 ? 0 : tile_counts[id] + mine[id] + (h >> kIdBits));
  }
}

// Zero the status words and the tile counter, then launch `kernel` over
// the tiles of `tile` ids.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int tile, size_t smem, const int* ids, long long n, int nb, int* counts, int* ranks,
           unsigned* status, cudaStream_t st, Args... args) {
  const int n_tiles = (int)((n + tile - 1) / tile);
  const size_t words = (size_t)nb * n_tiles + 1;
  cudaError_t err = cudaMemsetAsync(status, 0, words * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_tiles, threads, smem, st>>>(ids, n, nb, counts, ranks, status, status + words - 1, n_tiles, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Ids a tile at num_buckets; the scratch holds a status word a (tile, bucket).
int rt_bcr_tile(int num_buckets) {
  return num_buckets <= kBcrWarps * 32 ? kBcrWarps * 32 * kBcrItems : kBcrWarpsLarge * 32 * kBcrItemsLarge;
}

// counts (num_buckets), ranks (n).  scratch holds at least
// num_buckets * ceil(n / rt_bcr_tile(num_buckets)) + 1 ints: the tiles'
// status words and the tile counter, zeroed here.  0 < n < 2^30,
// 1 <= num_buckets <= 4096.
int rt_bucket_count_rank(const int* ids, long long n, int num_buckets, int* counts, int* ranks,
                         int* scratch, void* stream) {
  if (n <= 0 || n > (long long)kCount || num_buckets < 1 || num_buckets > kMaxBuckets) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* status = reinterpret_cast<unsigned*>(scratch);
  constexpr int threads = kBcrWarps * 32, threads_large = kBcrWarpsLarge * 32;
  const int tile = rt_bcr_tile(num_buckets);
  if (num_buckets <= kBcrThreadBuckets) {
    const bool vec = (reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(ranks)) % 16 == 0;
    const size_t smem = sizeof(unsigned) * ((size_t)(num_buckets + 1) / 2 * threads + num_buckets);
    return launch(bcr_thread_counts<kBcrWarps, kBcrItems, kBcrWindow>, threads, tile, smem, ids, n, num_buckets,
                  counts, ranks, status, st, vec);
  }
  if (num_buckets <= threads) {
    const size_t smem = (sizeof(int) + 2 * kBcrWarps) * (size_t)num_buckets;
    return launch(bcr_match<kBcrWarps, kBcrItems, 1, kBcrWindow>, threads, tile, smem, ids, n, num_buckets, counts,
                  ranks, status, st);
  }
  constexpr int per = (kMaxBuckets + threads_large - 1) / threads_large;
  const size_t smem = (sizeof(int) + 2 * kBcrWarpsLarge) * (size_t)num_buckets;
  return launch(bcr_match<kBcrWarpsLarge, kBcrItemsLarge, per, kBcrWindowLarge>, threads_large, tile, smem, ids, n,
                num_buckets, counts, ranks, status, st);
}

const char* rt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
