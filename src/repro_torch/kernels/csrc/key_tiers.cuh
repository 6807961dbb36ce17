// The key sort's tiers: the tile sort K2 and the merge K3 (bitonic.cu), and
// the row sort K4 (batched.cu).
//
// With no payload and no tag a thread holds 16 keys (four register
// distances) and a block's chunk holds 32 KiB of keys: 8,192 int32 keys,
// 512 threads.  In the home layout a thread holds 2^LOG_E consecutive keys
// (LOG_E = key_log_e<T>()); a window over distances 2^jb ..
// 2^(jb+LOG_E-1) holds the keys base + (r << jb), base with those bits
// clear.  The direction bit always comes from the key's index in its
// segment and every stage (s, j) meets every pair (i, i + 2^j) in stage
// order, each pair left as the plain network leaves it, so the bytes
// (where -0.0 and +0.0 land included) are the plain network's.  16 keys
// beat 8 and 32, and 32 KiB chunks tied 64 KiB for K2, timed through the
// wrapper; for K4's int64 rows of 8,192 keys three launches with 32 KiB
// chunks beat one with 64 KiB (PERF.md).
//
//   registers      distances 1 .. 2^(LOG_E-1), no memory traffic, no barrier;
//   warp           the next five distances by __shfl_xor_sync between lanes;
//   shared memory  distances up to the chunk, LOG_E distances a round trip
//                  and a barrier;
//   device memory  longer distances in windows of LOG_E: a thread loads
//                  2^LOG_E keys at the window's stride, coalesced, and
//                  stores them back.
//
// TWO_OP selects the reference's NICE 2-op exchange (nice_max) for integer
// keys in the register and warp stages; both methods leave the same bytes.
#pragma once

#include "common.cuh"

namespace rt {

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

// One compare-exchange of held keys, the pair left as the plain network
// leaves it.  Integer keys take min and max (max as a + b - min with
// TWO_OP): where two keys tie they are the same bits, so which one lands
// where cannot show.  Float keys keep cmp_xchg's select on b < a, which
// decides where -0.0 and +0.0 land.
template <bool TWO_OP, typename T>
__device__ __forceinline__ void key_cx(T& a, T& b, bool asc) {
  if constexpr (std::is_integral<T>::value) {
    const T mn = a < b ? a : b;
    const T mx = TWO_OP ? nice_max(a, b, mn) : (a < b ? b : a);
    a = asc ? mn : mx;
    b = asc ? mx : mn;
  } else {
    cmp_xchg(a, b, asc);
  }
}

// Distances 2^jhi down to 2^jlo of stage s on keys held with register bits
// jb .. jb+LOG_E-1 (jb <= jlo <= jhi < jb + LOG_E): held key r meets
// r + 2^(j-jb).  The direction is bit s+1 of the segment index: bit RB of r
// when RB = s+1-jb falls in the register bits (RB >= 0, known at compile
// time), else `asc` for every held key.
template <int BIT, int LOG_E, int RB, bool TWO_OP, typename T>
__device__ __forceinline__ void key_reg_stages_from(T (&k)[1 << LOG_E], bool asc, int jb, int jhi, int jlo) {
  if constexpr (BIT >= 0) {
    if (jlo <= jb + BIT && jb + BIT <= jhi) {
#pragma unroll
      for (int r = 0; r < (1 << LOG_E); ++r) {
        if (r & (1 << BIT)) continue;
        key_cx<TWO_OP>(k[r], k[r | (1 << BIT)], RB < 0 ? asc : ((r >> RB) & 1) == 0);
      }
    }
    key_reg_stages_from<BIT - 1, LOG_E, RB, TWO_OP>(k, asc, jb, jhi, jlo);
  }
}

template <int LOG_E, int RB, bool TWO_OP, typename T>
__device__ __forceinline__ void key_reg_stages_rb(T (&k)[1 << LOG_E], int rb, int jb, int jhi, int jlo) {
  if constexpr (RB < LOG_E) {
    if (rb == RB) {
      key_reg_stages_from<LOG_E - 1, LOG_E, RB, TWO_OP>(k, true, jb, jhi, jlo);
    } else {
      key_reg_stages_rb<LOG_E, RB + 1, TWO_OP>(k, rb, jb, jhi, jlo);
    }
  }
}

// The same with held key 0 at segment index g0 (bits jb .. jb+LOG_E-1 clear).
template <int LOG_E, bool TWO_OP = false, typename T>
__device__ __forceinline__ void key_reg_stages(T (&k)[1 << LOG_E], unsigned g0, int jb, int s, int jhi,
                                               int jlo) {
  const int rb = s + 1 - jb;
  if (rb < 0 || rb >= LOG_E) {
    key_reg_stages_from<LOG_E - 1, LOG_E, -1, TWO_OP>(k, ((g0 >> (s + 1)) & 1) == 0, jb, jhi, jlo);
  } else {
    key_reg_stages_rb<LOG_E, 0, TWO_OP>(k, rb, jb, jhi, jlo);
  }
}

// Distance 2^j, LOG_E <= j < LOG_E + 5, in the home layout: held key r of
// lane l meets held key r of lane l ^ 2^(j-LOG_E), and each lane keeps
// what key_cx leaves on its side: the lower lane a, the upper lane b.
template <int LOG_E, bool TWO_OP, typename T>
__device__ __forceinline__ void key_warp_stage(T (&k)[1 << LOG_E], unsigned g0, int s, int j, unsigned mask,
                                               int lane) {
  const int m = 1 << (j - LOG_E);
  const bool upper = (lane & m) != 0;
  const bool asc = ((g0 >> (s + 1)) & 1) == 0;
  const bool keep_min = asc != upper;
#pragma unroll
  for (int r = 0; r < (1 << LOG_E); ++r) {
    const T p = shfl_xor(mask, k[r], m);
    if constexpr (std::is_integral<T>::value && TWO_OP) {
      const T mn = p < k[r] ? p : k[r];
      k[r] = keep_min ? mn : nice_max(p, k[r], mn);
    } else if constexpr (std::is_integral<T>::value) {
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
template <typename T, int LOG_E, bool TWO_OP>
__device__ __forceinline__ void key_smem_window(T* sm, unsigned t, int jb, int jhi, int jlo,
                                                unsigned chunk_base, int s) {
  const unsigned base = spread<LOG_E>(t, jb);
  T k[1 << LOG_E];
#pragma unroll
  for (int r = 0; r < (1 << LOG_E); ++r) k[r] = sm[key_slot<T, LOG_E>(base + ((unsigned)r << jb))];
  key_reg_stages<LOG_E, TWO_OP>(k, chunk_base + base, jb, s, jhi, jlo);
#pragma unroll
  for (int r = 0; r < (1 << LOG_E); ++r) sm[key_slot<T, LOG_E>(base + ((unsigned)r << jb))] = k[r];
}

// How a chunk launch reads its keys.
enum KeyLoad : int {
  kLoadPlain,  // as they are
  kLoadFlip,   // K3: the chunk is a whole segment [a | b], read as a ++ reverse(b)
  kLoadFill,   // K4: positions at or past seg_lens[segment] read as the dtype max
};

// Stages s_lo .. s_hi of every chunk of 2^log_c keys, one chunk a block,
// every distance below the chunk: shared-memory windows of LOG_E distances
// a barrier, then warp shuffles, then registers.  Reads `in`, writes `out`
// (they may alias).  Chunks tile the segments of g (K2, K4: the rows; K3:
// the merge pairs).  With kLoadFlip a home run in the upper half comes from
// the mirrored run, reversed in registers.  With kLoadFill (segments are
// rows) a home run wholly at or past the row's length is not read, one
// that straddles it is read and then selected key by key; the compare is
// the plain version's signed pos < seg_lens[row].
template <typename T, int LOAD, bool TWO_OP = false>
__global__ void __launch_bounds__(key_threads_max<T>())
    key_chunk_stages(const T* in, T* out, Segs g, int log_c, int s_lo, int s_hi, bool vec, const int* seg_lens) {
  constexpr int LOG_E = key_log_e<T>();
  constexpr int E = 1 << LOG_E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1;
  const int shift = g.log_seg - log_c;
  const long long seg = seg_offset(g, (long long)blockIdx.x >> shift);
  const unsigned chunk_base = (blockIdx.x & ((1u << shift) - 1)) << log_c;
  // the shared-memory windows stop at 2^log_w; shuffles take the rest down to 2^LOG_E
  const int log_w = log_c < LOG_E + 5 ? log_c : LOG_E + 5;
  const unsigned home = E * t;
  const unsigned g0 = chunk_base + home;  // home: keys g0 .. g0 + E - 1 of the segment
  const long long off = seg + g0;

  T k[E];
  if constexpr (LOAD == kLoadFlip) {
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
  } else if constexpr (LOAD == kLoadFill) {
    const long long len = seg_lens[(long long)blockIdx.x >> shift];
    if ((long long)g0 >= len) {
#pragma unroll
      for (int r = 0; r < E; ++r) k[r] = max_sentinel<T>();
    } else {
      key_load_run(in + off, k, vec);
      if ((long long)g0 + E > len) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((long long)g0 + r >= len) k[r] = max_sentinel<T>();
        }
      }
    }
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
        key_smem_window<T, LOG_E, TWO_OP>(sm, t, jb, j, jlo, chunk_base, s);
        j = jlo - 1;
        __syncthreads();
      }
      key_load_home<T, LOG_E>(sm, home, k);
    }
    for (; j >= LOG_E; --j) key_warp_stage<LOG_E, TWO_OP>(k, g0, s, j, mask, lane);
    key_reg_stages<LOG_E, TWO_OP>(k, g0, 0, s, j, 0);
  }
  key_store_run(out + off, k, vec);
}

// Distances 2^jhi .. 2^jlo of stage s over every segment of g, in place in
// device memory: each thread loads 2^LOG_E keys at stride 2^jb (register
// bits jb .. jb+LOG_E-1), runs the distances in registers and stores them
// back.  Neighbouring threads take neighbouring bases, so every access is
// coalesced.
template <typename T, bool TWO_OP = false>
__global__ void key_device_window(T* keys, Segs g, long long n_segs, int s, int jhi, int jlo, int jb) {
  constexpr int LOG_E = key_log_e<T>();
  const long long per_seg = 1LL << (g.log_seg - LOG_E);
  const long long total = n_segs * per_seg;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long base = spread<LOG_E>(p & (per_seg - 1), jb);
    T* x = keys + seg_offset(g, p >> (g.log_seg - LOG_E)) + base;
    T k[1 << LOG_E];
#pragma unroll
    for (int r = 0; r < (1 << LOG_E); ++r) k[r] = x[(long long)r << jb];
    key_reg_stages<LOG_E, TWO_OP>(k, (unsigned)base, jb, s, jhi, jlo);
#pragma unroll
    for (int r = 0; r < (1 << LOG_E); ++r) x[(long long)r << jb] = k[r];
  }
}

// Sort every row of the contiguous (rows, 2^log_n) batch `in` into `out`
// (K2; K4 with FILL, seg_lens one length a row).  One launch sorts every
// chunk (stages 0 .. log_c-1), reading with the fill when FILL; each
// longer stage s runs its distances past the chunk in device-memory
// windows of LOG_E distances, then one chunk launch finishes its shorter
// distances, in place in `out`.
template <typename T, bool FILL = false, bool TWO_OP = false>
int sort_rows(const void* in, void* out, long long rows, int log_n, const int* seg_lens, cudaStream_t st) {
  constexpr int LOG_E = key_log_e<T>();
  if (log_n < LOG_E || log_n > 31) return (int)cudaErrorInvalidValue;
  const Segs g{1LL << log_n, 1, log_n};
  const int log_c = log_n < key_log_chunk<T>() ? log_n : key_log_chunk<T>();
  const unsigned blocks = (unsigned)(rows << (log_n - log_c));
  const int threads = 1 << (log_c - LOG_E);
  const size_t smem = sizeof(T) << log_c;
  auto first = key_chunk_stages<T, FILL ? kLoadFill : kLoadPlain, TWO_OP>;
  auto later = key_chunk_stages<T, kLoadPlain, TWO_OP>;
  cudaError_t err = allow_smem(first, smem);
  if (err == cudaSuccess && FILL && log_n > log_c) err = allow_smem(later, smem);
  if (err != cudaSuccess) return (int)err;
  T* o = static_cast<T*>(out);
  const bool vec = aligned16(in) && aligned16(out);
  first<<<blocks, threads, smem, st>>>(static_cast<const T*>(in), o, g, log_c, 0, log_c - 1, vec, seg_lens);
  for (int s = log_c; s < log_n; ++s) {
    for (int jhi = s; jhi >= log_c;) {
      const int jlo = jhi - (LOG_E - 1) > log_c ? jhi - (LOG_E - 1) : log_c;
      const int jb = jlo < log_n - LOG_E ? jlo : log_n - LOG_E;
      key_device_window<T, TWO_OP><<<grid_for(rows << (log_n - LOG_E), 256), 256, 0, st>>>(o, g, rows, s, jhi,
                                                                                          jlo, jb);
      jhi = jlo - 1;
    }
    later<<<blocks, threads, smem, st>>>(o, o, g, log_c, s, s, vec, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace rt
