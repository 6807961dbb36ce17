// The pair sort's tiers: K5 and K7 (bitonic.cu, sort_pairs_rows) and the
// row pair sort K6 (batched.cu).
//
// (key, payload) sorts move three struct-of-arrays streams: the key K, a
// one-byte validity tag (0 = real, 1 = pad; K5 and K6 only), and the
// payload moved as raw bits V (uint8_t ... uint64_t), so any payload dtype
// travels unchanged.  The compare is the reference's
// (_compare_exchange_tagged in src/repro/kernels/bitonic.py): a > b when
// (ta > tb) or (ta == tb and ka > kb), a < b likewise, swap = asc ? a > b :
// a < b, so ties never swap.  (tag, key) is never packed into one wider
// integer: for float keys a packed bit pattern would order -0.0 before
// +0.0 and swap where the reference does not.  Untagged (K7) is the same
// rule with every tag 0.  Because a swap is a fixed function of the two
// pairs, any schedule that applies every stage (s, j) to every pair
// (i, i + 2^j) in stage order, with the direction from bit s+1 of i's
// index in its row, gives the same bytes, tie order included.
//
//   registers      a thread holds 8 pairs: distances 1, 2, 4 run with no
//                  memory traffic and no barrier;
//   warp           distances 8 .. 128 by __shfl_xor_sync between lanes;
//   shared memory  distances 256 .. up to the chunk, three distances a
//                  round trip and a barrier, the pairs held at that stride
//                  (transposed);
//   device memory  longer distances in windows of three: a thread loads 8
//                  pairs at the window's stride, coalesced, and stores them
//                  back.
#pragma once

#include "common.cuh"

namespace rt {

// Shared-memory bytes of one pair: key, payload, and the tag if any.
template <typename K, typename V, bool TAGGED>
constexpr int pair_bytes() {
  return (int)(sizeof(K) + sizeof(V)) + (TAGGED ? 1 : 0);
}

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

// The reference's (tag, key) rule: where the tags differ the tags decide,
// else the keys do; swap = asc ? a > b : a < b, so ties never swap.
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

// The chunk of c pairs at `raw`: keys, then payloads, then tags.
template <typename K, typename V>
__device__ __forceinline__ Chunk<K, V> chunk_at(unsigned char* raw, int c) {
  return Chunk<K, V>{reinterpret_cast<K*>(raw), reinterpret_cast<V*>(raw + (size_t)c * sizeof(K)),
                     raw + (size_t)c * (sizeof(K) + sizeof(V))};
}

// Distances 2^jhi .. 2^jlo of stage s in a block's chunk, register bits
// jb .. jb+kLogE-1; thread t holds the pairs spread(t, jb) + (r << jb).
template <typename K, typename V, bool TAGGED>
__device__ __forceinline__ void smem_window(Chunk<K, V> c, unsigned t, int jb, int jhi, int jlo,
                                            unsigned chunk_base, int s) {
  const unsigned base = spread<kLogE>(t, jb);
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
  const Chunk<K, V> sm = chunk_at<K, V>(smem_raw, c);
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
    const long long base = spread<kLogE>(u, jb);
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
  const size_t smem = (size_t)pair_bytes<K, V, TAGGED>() << log_c;
  const cudaError_t err = allow_smem(pair_chunk_stages<K, V, TAGGED>, smem);
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
      pair_device_window<K, V, TAGGED><<<grid_for(rows << (log_n - kLogE), 256), 256, 0, st>>>(
          ok, ot, ov, rows, log_n, s, jhi, jlo, jb);
      jhi = jlo - 1;
    }
    pair_chunk_stages<K, V, TAGGED><<<blocks, threads, smem, st>>>(ok, ot, ov, ok, ot, ov, log_n, log_c,
                                                                   s, s, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace rt
