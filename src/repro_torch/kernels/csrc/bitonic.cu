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
// (K2) runs the distances in tiers, each as close to the registers as the
// distance allows:
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
// distances are what cost, so it runs them in tiers, each as close to the
// registers as the distance allows:
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
#include <cstring>

#include "common.cuh"

namespace {

// ------------------------------------------------------ the pair sort (K5, K7)
// A thread holds kE pairs in registers.  Which row positions they are
// depends on the tier running (see the header): in the home layout a
// thread holds kE consecutive pairs; in a window over distances 2^jb ..
// 2^(jb+kLogE-1) it holds the kE pairs base + (r << jb), r < kE, where
// base has those bits clear, so every pair of those distances lies inside
// one thread.  The direction bit always comes from the pair's index in its
// row, whatever the layout; so the schedule applies every stage (s, j) to
// every pair (i, i + 2^j) in stage order and the bytes, tie order
// included, are the plain network's.
constexpr int kLogE = 3;  // a thread holds 8 pairs (desc_mask counts on 8)
constexpr int kE = 1 << kLogE;
constexpr int kLogPairChunk = 11;  // a block holds 2,048 pairs
constexpr int kPairThreads = 1 << (kLogPairChunk - kLogE);

// Tags are held widened to 32 bits, so no byte is packed or extracted.
template <typename K, typename V, bool TAGGED>
struct Held {
  K k[kE];
  V v[kE];
  unsigned t[kE];
};

// rt::pair_swap in fewer instructions: where the tags differ the tags
// decide, else the keys do, exactly as the reference's (tag, key) rule.
// (K6 keeps rt::pair_swap until its own redesign, so its code stays as
// measured.)
template <typename K, bool TAGGED>
__device__ __forceinline__ bool held_swap(K ka, K kb, unsigned ta, unsigned tb, bool asc) {
  const bool by_key = asc ? ka > kb : ka < kb;
  if constexpr (TAGGED) return ta != tb ? (ta > tb) == asc : by_key;
  return by_key;
}

// Compare-exchange of held pairs a < b (both compile-time after unrolling).
template <typename K, typename V, bool TAGGED>
__device__ __forceinline__ void held_cx(Held<K, V, TAGGED>& x, int a, int b, bool asc) {
  if (held_swap<K, TAGGED>(x.k[a], x.k[b], x.t[a], x.t[b], asc)) {
    const K k = x.k[a];
    x.k[a] = x.k[b];
    x.k[b] = k;
    const V v = x.v[a];
    x.v[a] = x.v[b];
    x.v[b] = v;
    if constexpr (TAGGED) {
      const unsigned t = x.t[a];
      x.t[a] = x.t[b];
      x.t[b] = t;
    }
  }
}

// Bit r set: held pair r sorts its stage-s pairs descending.  Held pair r
// sits at row index g0 | (r << sh), g0 with bits sh .. sh+2 clear, so
// bit s+1 comes from r when it falls inside those bits, else from g0.
__device__ __forceinline__ unsigned desc_mask(unsigned g0, int sh, int s) {
  const int rb = s + 1 - sh;
  if (rb < 0 || rb >= kLogE) return ((g0 >> (s + 1)) & 1) * 0xFFu;
  return rb == 0 ? 0xAAu : rb == 1 ? 0xCCu : 0xF0u;  // the held pairs r with bit rb set
}

// One distance in registers: held pair r meets r + 2^BIT.
template <int BIT, typename K, typename V, bool TAGGED>
__device__ __forceinline__ void reg_stage(Held<K, V, TAGGED>& x, unsigned desc) {
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    if (r & (1 << BIT)) continue;
    held_cx(x, r, r | (1 << BIT), ((desc >> r) & 1) == 0);
  }
}

template <int BIT, typename K, typename V, bool TAGGED>
__device__ __forceinline__ void reg_stages_from(Held<K, V, TAGGED>& x, unsigned desc, int jb, int jhi,
                                                int jlo) {
  if constexpr (BIT >= 0) {
    if (jlo <= jb + BIT && jb + BIT <= jhi) reg_stage<BIT>(x, desc);
    reg_stages_from<BIT - 1>(x, desc, jb, jhi, jlo);
  }
}

// Distances 2^jhi down to 2^jlo of stage s on pairs held with register
// bits jb .. jb+kLogE-1 (jb <= jlo <= jhi < jb + kLogE), held pair 0 at
// row index g0.
template <typename K, typename V, bool TAGGED>
__device__ __forceinline__ void reg_stages(Held<K, V, TAGGED>& x, unsigned g0, int jb, int s, int jhi,
                                           int jlo) {
  reg_stages_from<kLogE - 1>(x, desc_mask(g0, jb, s), jb, jhi, jlo);
}

template <typename T>
__device__ __forceinline__ T shfl_xor(unsigned mask, T v, int m) {
  if constexpr (sizeof(T) == 8) {
    unsigned long long u;
    memcpy(&u, &v, 8);
    u = __shfl_xor_sync(mask, u, m);
    memcpy(&v, &u, 8);
  } else {
    unsigned u = 0;
    memcpy(&u, &v, sizeof(T));
    u = __shfl_xor_sync(mask, u, m);
    memcpy(&v, &u, sizeof(T));
  }
  return v;
}

// Distance 2^j, 3 <= j <= 7, in the home layout: held pair r of lane l
// meets held pair r of lane l ^ 2^(j-3).  Both lanes compute the same swap
// from the same (lower, upper) pair; the direction bit s+1 > j is the same
// for all eight pairs of both lanes.
template <typename K, typename V, bool TAGGED>
__device__ __forceinline__ void warp_stage(Held<K, V, TAGGED>& x, unsigned g0, int s, int j,
                                           unsigned mask, int lane) {
  const int m = 1 << (j - kLogE);
  const bool upper = (lane & m) != 0;
  const bool asc = ((g0 >> (s + 1)) & 1) == 0;
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const K pk = shfl_xor(mask, x.k[r], m);
    const V pv = shfl_xor(mask, x.v[r], m);
    unsigned pt = 0;
    if constexpr (TAGGED) pt = shfl_xor(mask, x.t[r], m);
    const bool sw = upper ? held_swap<K, TAGGED>(pk, x.k[r], pt, x.t[r], asc)
                          : held_swap<K, TAGGED>(x.k[r], pk, x.t[r], pt, asc);
    if (sw) {
      x.k[r] = pk;
      x.v[r] = pv;
      if constexpr (TAGGED) x.t[r] = pt;
    }
  }
}

// The word type that moves a run of B bytes: 16-byte words, or one
// 8-byte word for the run of 8 one-byte elements.
template <int B>
using RunWord = std::conditional_t<(B >= 16), uint4, uint2>;

// kE consecutive elements at p, as whole words when `vec` (p aligned to
// the word), one by one otherwise.
template <typename T>
__device__ __forceinline__ void load_run(const T* p, T (&v)[kE], bool vec) {
  constexpr int B = kE * (int)sizeof(T);
  using W = RunWord<B>;
  if (vec) {
    W w[B / sizeof(W)];
#pragma unroll
    for (int i = 0; i < (int)(B / sizeof(W)); ++i) w[i] = reinterpret_cast<const W*>(p)[i];
    memcpy(v, w, B);
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) v[r] = p[r];
  }
}

template <typename T>
__device__ __forceinline__ void store_run(T* p, const T (&v)[kE], bool vec) {
  constexpr int B = kE * (int)sizeof(T);
  using W = RunWord<B>;
  if (vec) {
    W w[B / sizeof(W)];
    memcpy(w, v, B);
#pragma unroll
    for (int i = 0; i < (int)(B / sizeof(W)); ++i) reinterpret_cast<W*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) p[r] = v[r];
  }
}

// Where pair i of a chunk sits in shared memory: the bits of its slot
// from kLogE up to 4 are flipped by the bits from 2 kLogE up.  A warp's
// window with register bits kLogE and up then spreads its lanes over every
// bank, while runs of kE (the home layout) stay contiguous and a window
// with register bits from 5 up keeps its lanes on distinct banks.
__device__ __forceinline__ unsigned slot(unsigned i) {
  return i ^ (((i >> (2 * kLogE)) & ((1u << (5 - kLogE)) - 1)) << kLogE);
}

// Thread u's held pair 0 in a window with register bits jb .. jb+LOG_E-1
// (the tile sort holds 2^LOG_E keys, the pair sort kE pairs): u with
// those bits opened up (cleared) in its binary form.
template <int LOG_E = kLogE, typename U>
__device__ __forceinline__ U spread(U u, int jb) {
  return ((u >> jb) << (jb + LOG_E)) | (u & ((U(1) << jb) - 1));
}

// A run of kE tags, widened on load and narrowed on store.
__device__ __forceinline__ void load_tags(const uint8_t* p, unsigned (&t)[kE], bool vec) {
  uint8_t b[kE];
  load_run(p, b, vec);
#pragma unroll
  for (int r = 0; r < kE; ++r) t[r] = b[r];
}

__device__ __forceinline__ void store_tags(uint8_t* p, const unsigned (&t)[kE], bool vec) {
  uint8_t b[kE];
#pragma unroll
  for (int r = 0; r < kE; ++r) b[r] = (uint8_t)t[r];
  store_run(p, b, vec);
}

// The three streams of a chunk in shared memory.
template <typename K, typename V>
struct Chunk {
  K* k;
  V* v;
  uint8_t* t;
};

// Distances 2^jhi .. 2^jlo of stage s in a block's chunk, register bits
// jb .. jb+kLogE-1; thread t holds the pairs spread(t, jb) + (r << jb).
template <typename K, typename V, bool TAGGED>
__device__ __forceinline__ void smem_window(Chunk<K, V> c, unsigned t, int jb, int jhi, int jlo,
                                            unsigned chunk_base, int s) {
  const unsigned base = spread(t, jb);
  Held<K, V, TAGGED> x;
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const unsigned o = slot(base + ((unsigned)r << jb));
    x.k[r] = c.k[o];
    x.v[r] = c.v[o];
    x.t[r] = 0;
    if constexpr (TAGGED) x.t[r] = c.t[o];
  }
  reg_stages(x, chunk_base + base, jb, s, jhi, jlo);
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const unsigned o = slot(base + ((unsigned)r << jb));
    c.k[o] = x.k[r];
    c.v[o] = x.v[r];
    if constexpr (TAGGED) c.t[o] = (uint8_t)x.t[r];
  }
}

// Stages s_lo .. s_hi of every chunk of 2^log_c pairs, one chunk a block,
// every distance below the chunk.  Reads (kin, tin, vin) and writes
// (kout, tout, vout), which may alias; tags are written only when tout is
// not null.
template <typename K, typename V, bool TAGGED>
__global__ void __launch_bounds__(kPairThreads) pair_chunk_stages(
    const K* kin, const uint8_t* tin, const V* vin, K* kout, uint8_t* tout, V* vout, int log_n,
    int log_c, int s_lo, int s_hi, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = 1 << log_c;
  const Chunk<K, V> sm{reinterpret_cast<K*>(smem_raw),
                       reinterpret_cast<V*>(smem_raw + (size_t)c * sizeof(K)),
                       smem_raw + (size_t)c * (sizeof(K) + sizeof(V))};
  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1;
  const int shift = log_n - log_c;
  const long long row = (long long)blockIdx.x >> shift;
  const unsigned chunk_base = (blockIdx.x & ((1u << shift) - 1)) << log_c;
  // the shared-memory windows stop at 2^log_w; shuffles take the rest down to 8
  const int log_w = log_c < kLogE + 5 ? log_c : kLogE + 5;
  const unsigned g0 = chunk_base + kE * t;  // home: pairs g0 .. g0 + 7 of the row
  const long long off = (row << log_n) + g0;
  const unsigned home = slot(kE * t);

  Held<K, V, TAGGED> x;
  load_run(kin + off, x.k, vec);
  load_run(vin + off, x.v, vec);
#pragma unroll
  for (int r = 0; r < kE; ++r) x.t[r] = 0;
  if constexpr (TAGGED) load_tags(tin + off, x.t, vec);

  for (int s = s_lo; s <= s_hi; ++s) {
    int j = s < log_c - 1 ? s : log_c - 1;
    if (j >= log_w) {
      store_run(sm.k + home, x.k, true);
      store_run(sm.v + home, x.v, true);
      if constexpr (TAGGED) store_tags(sm.t + home, x.t, true);
      __syncthreads();
      while (j >= log_w) {
        const int jlo = j - (kLogE - 1) > log_w ? j - (kLogE - 1) : log_w;
        const int jb = jlo < log_c - kLogE ? jlo : log_c - kLogE;
        smem_window<K, V, TAGGED>(sm, t, jb, j, jlo, chunk_base, s);
        j = jlo - 1;
        __syncthreads();
      }
      load_run(sm.k + home, x.k, true);
      load_run(sm.v + home, x.v, true);
      if constexpr (TAGGED) load_tags(sm.t + home, x.t, true);
    }
    for (; j >= kLogE; --j) warp_stage(x, g0, s, j, mask, lane);
    reg_stages(x, g0, 0, s, j, 0);
  }

  store_run(kout + off, x.k, vec);
  store_run(vout + off, x.v, vec);
  if constexpr (TAGGED) {
    if (tout != nullptr) store_tags(tout + off, x.t, vec);
  }
}

// Distances 2^jhi .. 2^jlo of stage s over every row, in place in device
// memory: each thread loads the kE pairs at stride 2^jb (register bits
// jb .. jb+kLogE-1), runs the distances in registers and stores them back.
// Neighbouring threads take neighbouring bases, so every access is
// coalesced.
template <typename K, typename V, bool TAGGED>
__global__ void pair_device_window(K* keys, uint8_t* tags, V* vals, long long rows, int log_n, int s,
                                   int jhi, int jlo, int jb) {
  const long long per_row = 1LL << (log_n - kLogE);
  const long long total = rows * per_row;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long u = p & (per_row - 1);
    const long long base = spread(u, jb);
    const long long at = ((p >> (log_n - kLogE)) << log_n) + base;
    Held<K, V, TAGGED> x;
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const long long i = at + ((long long)r << jb);
      x.k[r] = keys[i];
      x.v[r] = vals[i];
      x.t[r] = 0;
      if constexpr (TAGGED) x.t[r] = tags[i];
    }
    reg_stages(x, (unsigned)base, jb, s, jhi, jlo);
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const long long i = at + ((long long)r << jb);
      keys[i] = x.k[r];
      vals[i] = x.v[r];
      if constexpr (TAGGED) tags[i] = (uint8_t)x.t[r];
    }
  }
}

inline bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The pair sort of K5/K7.  One launch sorts every chunk (stages 0 ..
// log_c-1); each longer stage s runs its distances past the chunk in
// device-memory windows of kLogE distances, then one chunk launch
// finishes its shorter distances.  A tagged sort that needs device
// windows keeps its tags in out_tags between launches.
template <typename K, typename V, bool TAGGED>
int sort_pairs_rows(const void* keys, const void* tags, const void* vals, void* out_keys,
                    void* out_tags, void* out_vals, long long rows, int log_n, cudaStream_t st) {
  const int log_c = log_n < kLogPairChunk ? log_n : kLogPairChunk;
  const bool passes = log_n > log_c;
  if (log_n < 7 || log_n > 31 || (TAGGED && (tags == nullptr || (passes && out_tags == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)(rows << (log_n - log_c));
  const int threads = 1 << (log_c - kLogE);
  const size_t smem = (size_t)rt::pair_bytes<K, V, TAGGED>() << log_c;
  const cudaError_t err = rt::allow_smem(pair_chunk_stages<K, V, TAGGED>, smem);
  if (err != cudaSuccess) return (int)err;
  K* ok = static_cast<K*>(out_keys);
  V* ov = static_cast<V*>(out_vals);
  uint8_t* ot = TAGGED && passes ? static_cast<uint8_t*>(out_tags) : nullptr;
  const bool vec = aligned16(keys) && aligned16(tags) && aligned16(vals) && aligned16(out_keys) &&
                   aligned16(ot) && aligned16(out_vals);
  pair_chunk_stages<K, V, TAGGED><<<blocks, threads, smem, st>>>(
      static_cast<const K*>(keys), static_cast<const uint8_t*>(tags), static_cast<const V*>(vals), ok,
      ot, ov, log_n, log_c, 0, log_c - 1, vec);
  for (int s = log_c; s < log_n; ++s) {
    for (int jhi = s; jhi >= log_c;) {
      const int jlo = jhi - (kLogE - 1) > log_c ? jhi - (kLogE - 1) : log_c;
      const int jb = jlo < log_n - kLogE ? jlo : log_n - kLogE;
      pair_device_window<K, V, TAGGED><<<rt::grid_for(rows << (log_n - kLogE), 256), 256, 0, st>>>(
          ok, ot, ov, rows, log_n, s, jhi, jlo, jb);
      jhi = jlo - 1;
    }
    pair_chunk_stages<K, V, TAGGED><<<blocks, threads, smem, st>>>(ok, ot, ov, ok, ot, ov, log_n, log_c,
                                                                   s, s, vec);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the tile sort (K2)
// The pair sort's tiers for keys alone.  With no payload and no tag a
// thread holds 16 keys (four register distances) and a block's chunk
// holds 32 KiB of keys: 8,192 int32 keys, 512 threads.  In the home layout
// a thread holds 2^LOG_E consecutive keys (LOG_E = key_log_e<T>()); a
// window over distances 2^jb .. 2^(jb+LOG_E-1) holds the keys
// base + (r << jb), base with those bits clear.  As for the pairs, the
// direction bit always comes from the key's index in its row and every
// stage (s, j) meets every pair (i, i + 2^j) in stage order, each pair
// left as rt::cmp_xchg leaves it, so the bytes (where -0.0 and +0.0 land
// included) are the plain network's.  16 keys beat 8 and 32, and 32 KiB
// chunks tied 64 KiB, timed through the wrapper (PERF.md).
constexpr int kLogKeyE = 4;            // a thread holds 16 keys
constexpr int kLogKeyChunkBytes = 15;  // a block holds 32 KiB of keys

template <typename T>
__host__ __device__ constexpr int log_size() {
  return sizeof(T) == 1 ? 0 : sizeof(T) == 2 ? 1 : sizeof(T) == 4 ? 2 : 3;
}

// log2 of the keys a thread holds: kLogKeyE, raised where that would be
// under one 16-byte word.
template <typename T>
__host__ __device__ constexpr int key_log_e() {
  return kLogKeyE > 4 - log_size<T>() ? kLogKeyE : 4 - log_size<T>();
}

// log2 of the keys a block holds: kLogKeyChunkBytes of them, at most 1,024
// threads.
template <typename T>
__host__ __device__ constexpr int key_log_chunk() {
  constexpr int by_bytes = kLogKeyChunkBytes - log_size<T>();
  return by_bytes < key_log_e<T>() + 10 ? by_bytes : key_log_e<T>() + 10;
}

template <typename T>
__host__ __device__ constexpr int key_threads_max() {
  return 1 << (key_log_chunk<T>() - key_log_e<T>());
}

// One compare-exchange of held keys, the pair left as rt::cmp_xchg<T,
// false> leaves it.  Integer keys take min and max: where two keys tie
// they are the same bits, so which one lands where cannot show.  Float
// keys keep cmp_xchg's select on b < a, which decides where -0.0 and +0.0
// land.
template <typename T>
__device__ __forceinline__ void key_cx(T& a, T& b, bool asc) {
  if constexpr (std::is_integral<T>::value) {
    const T mn = a < b ? a : b;
    const T mx = a < b ? b : a;
    a = asc ? mn : mx;
    b = asc ? mx : mn;
  } else {
    rt::cmp_xchg<T, false>(a, b, asc);
  }
}

// Distances 2^jhi down to 2^jlo of stage s on keys held with register bits
// jb .. jb+LOG_E-1 (jb <= jlo <= jhi < jb + LOG_E): held key r meets
// r + 2^(j-jb).  The direction is bit s+1 of the row index: bit RB of r
// when RB = s+1-jb falls in the register bits (RB >= 0, known at compile
// time), else `asc` for every held key.
template <int BIT, int LOG_E, int RB, typename T>
__device__ __forceinline__ void key_reg_stages_from(T (&k)[1 << LOG_E], bool asc, int jb, int jhi, int jlo) {
  if constexpr (BIT >= 0) {
    if (jlo <= jb + BIT && jb + BIT <= jhi) {
#pragma unroll
      for (int r = 0; r < (1 << LOG_E); ++r) {
        if (r & (1 << BIT)) continue;
        key_cx(k[r], k[r | (1 << BIT)], RB < 0 ? asc : ((r >> RB) & 1) == 0);
      }
    }
    key_reg_stages_from<BIT - 1, LOG_E, RB>(k, asc, jb, jhi, jlo);
  }
}

template <int LOG_E, int RB, typename T>
__device__ __forceinline__ void key_reg_stages_rb(T (&k)[1 << LOG_E], int rb, int jb, int jhi, int jlo) {
  if constexpr (RB < LOG_E) {
    if (rb == RB) {
      key_reg_stages_from<LOG_E - 1, LOG_E, RB>(k, true, jb, jhi, jlo);
    } else {
      key_reg_stages_rb<LOG_E, RB + 1>(k, rb, jb, jhi, jlo);
    }
  }
}

// The same with held key 0 at row index g0 (bits jb .. jb+LOG_E-1 clear).
template <int LOG_E, typename T>
__device__ __forceinline__ void key_reg_stages(T (&k)[1 << LOG_E], unsigned g0, int jb, int s, int jhi,
                                               int jlo) {
  const int rb = s + 1 - jb;
  if (rb < 0 || rb >= LOG_E) {
    key_reg_stages_from<LOG_E - 1, LOG_E, -1>(k, ((g0 >> (s + 1)) & 1) == 0, jb, jhi, jlo);
  } else {
    key_reg_stages_rb<LOG_E, 0>(k, rb, jb, jhi, jlo);
  }
}

// Distance 2^j, LOG_E <= j < LOG_E + 5, in the home layout: held key r of
// lane l meets held key r of lane l ^ 2^(j-LOG_E), and each lane keeps
// what key_cx leaves on its side: the lower lane a, the upper lane b.
template <int LOG_E, typename T>
__device__ __forceinline__ void key_warp_stage(T (&k)[1 << LOG_E], unsigned g0, int s, int j, unsigned mask,
                                               int lane) {
  const int m = 1 << (j - LOG_E);
  const bool upper = (lane & m) != 0;
  const bool asc = ((g0 >> (s + 1)) & 1) == 0;
  const bool keep_min = asc != upper;
#pragma unroll
  for (int r = 0; r < (1 << LOG_E); ++r) {
    const T p = shfl_xor(mask, k[r], m);
    if constexpr (std::is_integral<T>::value) {
      k[r] = keep_min ? (p < k[r] ? p : k[r]) : (p < k[r] ? k[r] : p);
    } else {
      // cmp_xchg's select on b < a with (a, b) = (lower's, upper's) key
      const bool b_lt_a = upper ? k[r] < p : p < k[r];
      k[r] = (b_lt_a == (keep_min != upper)) ? p : k[r];
    }
  }
}

// Where key i of a chunk sits in shared memory.  A home run is 2^lw whole
// 16-byte words (2^lv keys each); the low bits of a word's index are
// flipped by the bits of its thread that the 8 word-wide bank groups do
// not see, so eight neighbouring threads' home words (one pass over the 32
// banks) fall on distinct banks.  Words stay whole, and a window's lanes,
// which touch 32 consecutive keys, stay on distinct banks.
template <typename T, int LOG_E>
__device__ __forceinline__ unsigned key_slot(unsigned i) {
  constexpr int lv = 4 - log_size<T>();
  constexpr int lw = LOG_E - lv;
  constexpr int flip_bits = lw < 3 ? lw : 3;
  constexpr int from = lw > 3 ? lw : 3;
  return i ^ (((i >> (lv + from)) & ((1u << flip_bits) - 1)) << lv);
}

// The home run of a thread: N consecutive keys, N * sizeof(T) a multiple
// of 16 bytes, as 16-byte words when `vec` (p aligned), one by one
// otherwise.  Each word is unpacked on its own, so the keys stay in
// registers.
template <typename T, int N>
__device__ __forceinline__ void key_load_run(const T* p, T (&k)[N], bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vec) {
#pragma unroll
    for (int i = 0; i < N / V; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      memcpy(&k[i * V], &w, 16);
    }
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) k[r] = p[r];
  }
}

template <typename T, int N>
__device__ __forceinline__ void key_store_run(T* p, const T (&k)[N], bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  if (vec) {
#pragma unroll
    for (int i = 0; i < N / V; ++i) {
      uint4 w;
      memcpy(&w, &k[i * V], 16);
      reinterpret_cast<uint4*>(p)[i] = w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) p[r] = k[r];
  }
}

// A home run in the chunk, word by word at their swizzled slots.
template <typename T, int LOG_E>
__device__ __forceinline__ void key_load_home(const T* sm, unsigned home, T (&k)[1 << LOG_E]) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < (1 << LOG_E) / V; ++i) {
    const uint4 w = *reinterpret_cast<const uint4*>(sm + key_slot<T, LOG_E>(home + i * V));
    memcpy(&k[i * V], &w, 16);
  }
}

template <typename T, int LOG_E>
__device__ __forceinline__ void key_store_home(T* sm, unsigned home, const T (&k)[1 << LOG_E]) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < (1 << LOG_E) / V; ++i) {
    uint4 w;
    memcpy(&w, &k[i * V], 16);
    *reinterpret_cast<uint4*>(sm + key_slot<T, LOG_E>(home + i * V)) = w;
  }
}

// Distances 2^jhi .. 2^jlo of stage s in a block's chunk, register bits
// jb .. jb+LOG_E-1; thread t holds the keys spread(t, jb) + (r << jb).
template <typename T, int LOG_E>
__device__ __forceinline__ void key_smem_window(T* sm, unsigned t, int jb, int jhi, int jlo,
                                                unsigned chunk_base, int s) {
  const unsigned base = spread<LOG_E>(t, jb);
  T k[1 << LOG_E];
#pragma unroll
  for (int r = 0; r < (1 << LOG_E); ++r) k[r] = sm[key_slot<T, LOG_E>(base + ((unsigned)r << jb))];
  key_reg_stages<LOG_E>(k, chunk_base + base, jb, s, jhi, jlo);
#pragma unroll
  for (int r = 0; r < (1 << LOG_E); ++r) sm[key_slot<T, LOG_E>(base + ((unsigned)r << jb))] = k[r];
}

// Stages s_lo .. s_hi of every chunk of 2^log_c keys, one chunk a block,
// every distance below the chunk: shared-memory windows of LOG_E distances
// a barrier, then warp shuffles, then registers.  Reads `in`, writes `out`
// (they may alias).  Chunks tile the segments of g (K2: the rows; K3: the
// merge pairs).  With FLIP the chunk is a whole K3 segment [a | b], read
// as the merge network's a ++ reverse(b): a home run in the upper half
// comes from the mirrored run, reversed in registers.
template <typename T, bool FLIP>
__global__ void __launch_bounds__(key_threads_max<T>())
    key_chunk_stages(const T* in, T* out, rt::Segs g, int log_c, int s_lo, int s_hi, bool vec) {
  constexpr int LOG_E = key_log_e<T>();
  constexpr int E = 1 << LOG_E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1;
  const int shift = g.log_seg - log_c;
  const long long seg = rt::seg_offset(g, (long long)blockIdx.x >> shift);
  const unsigned chunk_base = (blockIdx.x & ((1u << shift) - 1)) << log_c;
  // the shared-memory windows stop at 2^log_w; shuffles take the rest down to 2^LOG_E
  const int log_w = log_c < LOG_E + 5 ? log_c : LOG_E + 5;
  const unsigned home = E * t;
  const unsigned g0 = chunk_base + home;  // home: keys g0 .. g0 + E - 1 of the segment
  const long long off = seg + g0;

  T k[E];
  if constexpr (FLIP) {
    const unsigned half = 1u << (log_c - 1);
    if (g0 >= half) {
      key_load_run(in + seg + (3 * half - E - g0), k, vec);
#pragma unroll
      for (int r = 0; r < E / 2; ++r) {
        const T v = k[r];
        k[r] = k[E - 1 - r];
        k[E - 1 - r] = v;
      }
    } else {
      key_load_run(in + off, k, vec);
    }
    __syncthreads();  // in place: every run is read before any is written
  } else {
    key_load_run(in + off, k, vec);
  }
  for (int s = s_lo; s <= s_hi; ++s) {
    int j = s < log_c - 1 ? s : log_c - 1;
    if (j >= log_w) {
      key_store_home<T, LOG_E>(sm, home, k);
      __syncthreads();
      while (j >= log_w) {
        const int jlo = j - (LOG_E - 1) > log_w ? j - (LOG_E - 1) : log_w;
        const int jb = jlo < log_c - LOG_E ? jlo : log_c - LOG_E;
        key_smem_window<T, LOG_E>(sm, t, jb, j, jlo, chunk_base, s);
        j = jlo - 1;
        __syncthreads();
      }
      key_load_home<T, LOG_E>(sm, home, k);
    }
    for (; j >= LOG_E; --j) key_warp_stage<LOG_E>(k, g0, s, j, mask, lane);
    key_reg_stages<LOG_E>(k, g0, 0, s, j, 0);
  }
  key_store_run(out + off, k, vec);
}

// Distances 2^jhi .. 2^jlo of stage s over every segment of g, in place in
// device memory: each thread loads 2^LOG_E keys at stride 2^jb (register
// bits jb .. jb+LOG_E-1), runs the distances in registers and stores them
// back.  Neighbouring threads take neighbouring bases, so every access is
// coalesced.
template <typename T>
__global__ void key_device_window(T* keys, rt::Segs g, long long n_segs, int s, int jhi, int jlo, int jb) {
  constexpr int LOG_E = key_log_e<T>();
  const long long per_seg = 1LL << (g.log_seg - LOG_E);
  const long long total = n_segs * per_seg;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long base = spread<LOG_E>(p & (per_seg - 1), jb);
    T* x = keys + rt::seg_offset(g, p >> (g.log_seg - LOG_E)) + base;
    T k[1 << LOG_E];
#pragma unroll
    for (int r = 0; r < (1 << LOG_E); ++r) k[r] = x[(long long)r << jb];
    key_reg_stages<LOG_E>(k, (unsigned)base, jb, s, jhi, jlo);
#pragma unroll
    for (int r = 0; r < (1 << LOG_E); ++r) x[(long long)r << jb] = k[r];
  }
}

// The tile sort of K2.  One launch sorts every chunk (stages 0 ..
// log_c-1); each longer stage s runs its distances past the chunk in
// device-memory windows of LOG_E distances, then one chunk launch
// finishes its shorter distances.
template <typename T>
int sort_rows(const void* in, void* out, long long rows, int log_n, cudaStream_t st) {
  constexpr int LOG_E = key_log_e<T>();
  if (log_n < LOG_E || log_n > 31) return (int)cudaErrorInvalidValue;
  const rt::Segs g{1LL << log_n, 1, log_n};
  const int log_c = log_n < key_log_chunk<T>() ? log_n : key_log_chunk<T>();
  const unsigned blocks = (unsigned)(rows << (log_n - log_c));
  const int threads = 1 << (log_c - LOG_E);
  const size_t smem = sizeof(T) << log_c;
  const cudaError_t err = rt::allow_smem(key_chunk_stages<T, false>, smem);
  if (err != cudaSuccess) return (int)err;
  T* o = static_cast<T*>(out);
  const bool vec = aligned16(in) && aligned16(out);
  key_chunk_stages<T, false><<<blocks, threads, smem, st>>>(static_cast<const T*>(in), o, g, log_c, 0,
                                                            log_c - 1, vec);
  for (int s = log_c; s < log_n; ++s) {
    for (int jhi = s; jhi >= log_c;) {
      const int jlo = jhi - (LOG_E - 1) > log_c ? jhi - (LOG_E - 1) : log_c;
      const int jb = jlo < log_n - LOG_E ? jlo : log_n - LOG_E;
      key_device_window<T><<<rt::grid_for(rows << (log_n - LOG_E), 256), 256, 0, st>>>(o, g, rows, s, jhi,
                                                                                     jlo, jb);
      jhi = jlo - 1;
    }
    key_chunk_stages<T, false><<<blocks, threads, smem, st>>>(o, o, g, log_c, s, s, vec);
  }
  return (int)cudaGetLastError();
}

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
    key_reg_stages<3>(xa, (unsigned)l, log_q, s, s, jlo);
    key_reg_stages<3>(xb, (unsigned)l2, log_q, s, s, jlo);
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
  constexpr int LOG_E = key_log_e<T>();
  if (log_seg < LOG_E + 1 || log_seg > 31) return (int)cudaErrorInvalidValue;
  const rt::Segs g{row_stride, per_row, log_seg};
  const long long n_segs = rows * per_row;
  T* x = static_cast<T*>(base);
  const int s = log_seg - 1;
  const int log_c = log_seg < key_log_chunk<T>() ? log_seg : key_log_chunk<T>();
  const unsigned blocks = (unsigned)(n_segs << (log_seg - log_c));
  const int threads = 1 << (log_c - LOG_E);
  const size_t smem = sizeof(T) << log_c;
  // rows and segments start at multiples of 128 keys, so base decides
  const bool vec = aligned16(base);
  if (log_seg == log_c) {
    const cudaError_t err = rt::allow_smem(key_chunk_stages<T, true>, smem);
    if (err != cudaSuccess) return (int)err;
    key_chunk_stages<T, true><<<blocks, threads, smem, st>>>(x, x, g, log_c, s, s, vec);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = rt::allow_smem(key_chunk_stages<T, false>, smem);
  if (err != cudaSuccess) return (int)err;
  const int jflip = s - 2 > log_c ? s - 2 : log_c;
  key_device_flip<T><<<rt::grid_for(n_segs << (log_seg - 4), 256), 256, 0, st>>>(x, g, n_segs, jflip);
  for (int jhi = jflip - 1; jhi >= log_c;) {
    const int jlo = jhi - (LOG_E - 1) > log_c ? jhi - (LOG_E - 1) : log_c;
    const int jb = jlo < log_seg - LOG_E ? jlo : log_seg - LOG_E;
    key_device_window<T><<<rt::grid_for(n_segs << (log_seg - LOG_E), 256), 256, 0, st>>>(x, g, n_segs, s, jhi,
                                                                                       jlo, jb);
    jhi = jlo - 1;
  }
  key_chunk_stages<T, false><<<blocks, threads, smem, st>>>(x, x, g, log_c, s, s, vec);
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
