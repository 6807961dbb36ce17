// Shared pieces of the bitonic kernels (bitonic.cu, batched.cu): the key
// stages and their (key, tag, payload) pair twins.
//
// A bitonic stage (s, j) pairs element i with i + 2^j (bit j of i clear)
// and orders the pair ascending when bit s+1 of i is clear, descending
// otherwise.  That is the reference's reshape form
// ((q >> (s - j)) & 1) == 0 with q = i >> (j + 1)
// (src/repro/kernels/bitonic.py, _compare_exchange).  Indices count from
// the start of a *segment*: a row to sort, or a pair of tiles to merge.
//
// Segments are addressed as `per_row` consecutive blocks of 2^log_seg
// elements in each of several rows `row_stride` elements apart, so one
// launch covers a whole (rows, n) batch, or every merge pair of one
// odd-even half-pass over a (rows, tiles, tile) buffer.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace rt {

enum DType : int { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kF32 = 4 };

template <typename T>
__device__ __forceinline__ T max_sentinel();
template <>
__device__ __forceinline__ int8_t max_sentinel<int8_t>() { return INT8_MAX; }
template <>
__device__ __forceinline__ int16_t max_sentinel<int16_t>() { return INT16_MAX; }
template <>
__device__ __forceinline__ int32_t max_sentinel<int32_t>() { return INT32_MAX; }
template <>
__device__ __forceinline__ int64_t max_sentinel<int64_t>() { return INT64_MAX; }
template <>
__device__ __forceinline__ float max_sentinel<float>() { return __int_as_float(0x7f800000); }

// One compare-exchange.  min/max are written as selects on `b < a` so the
// pair always comes out as a permutation of its inputs; the plain torch
// versions use the same selects, so kernel and plain agree bit for bit
// (for floats too, where -0.0 and +0.0 compare equal).
//
// TWO_OP is Paeth's NICE stage, max = a + b - min.  The sum is taken in
// the unsigned type of the same width: it wraps there by definition,
// whereas signed overflow is undefined and int8/int16 would promote to
// int.  Float keys always take the 4-op stage (rounding breaks the
// identity).
template <typename T, bool TWO_OP>
__device__ __forceinline__ void cmp_xchg(T& a, T& b, bool asc) {
  const bool b_lt_a = b < a;
  const T mn = b_lt_a ? b : a;
  T mx;
  if constexpr (TWO_OP && std::is_integral<T>::value) {
    using U = typename std::make_unsigned<T>::type;
    mx = static_cast<T>(static_cast<U>(static_cast<U>(a) + static_cast<U>(b) - static_cast<U>(mn)));
  } else {
    mx = b_lt_a ? a : b;
  }
  a = asc ? mn : mx;
  b = asc ? mx : mn;
}

struct Segs {
  long long row_stride;  // elements between consecutive rows
  int per_row;           // segments in each row
  int log_seg;           // segment length is 2^log_seg
};

__device__ __forceinline__ long long seg_offset(const Segs& g, long long seg) {
  if (g.per_row == 1) return seg * g.row_stride;
  return (seg / g.per_row) * g.row_stride + ((seg % g.per_row) << g.log_seg);
}

// Every stage of the sort of each segment of g, one segment a block in
// shared memory (the row sort K4: one row a segment).  Positions at or
// past seg_lens[segment] are refilled with the dtype max on load.
template <typename T, bool TWO_OP>
__global__ void smem_stages(const T* in, T* out, Segs g, const int* seg_lens) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int c = 1 << g.log_seg;
  const long long off = seg_offset(g, blockIdx.x);
  const int len = seg_lens[blockIdx.x];
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    T v = in[off + t];
    if (t >= len) v = max_sentinel<T>();
    sm[t] = v;
  }
  __syncthreads();
  for (int s = 0; s < g.log_seg; ++s) {
    for (int j = s; j >= 0; --j) {
      for (int q = threadIdx.x; q < c / 2; q += blockDim.x) {
        const int i = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
        const int k = i + (1 << j);
        T a = sm[i];
        T b = sm[k];
        cmp_xchg<T, TWO_OP>(a, b, ((i >> (s + 1)) & 1) == 0);
        sm[i] = a;
        sm[k] = b;
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < c; t += blockDim.x) out[off + t] = sm[t];
}

// ------------------------------------------------------------ pair stages
// (key, payload) sorts: K5 (tagged), K6 (tagged, tag computed on load)
// and K7 (untagged).  Three struct-of-arrays streams: the key K, a
// one-byte validity tag (0 = real, 1 = pad), and the payload moved as raw
// bits V (uint8_t … uint64_t), so any payload dtype travels unchanged.
// K6 runs smem_stages_pairs below, one block a row.  K5 and K7 run the
// tiered schedule of bitonic.cu: registers, warp shuffles, a block's
// shared memory, then device-memory windows of three distances; at
// (1, 2^19) int32/int32 that is 24 launches (PERF.md has their time on
// the card), the bound 0.0027 ms by bytes.
// They share pair_bytes with K6, and keep pair_swap's rule in fewer
// instructions.
//
// The compare is the reference's (_compare_exchange_tagged in
// src/repro/kernels/bitonic.py): a > b when (ta > tb) or (ta == tb and
// ka > kb), a < b likewise, swap = asc ? a > b : a < b, so ties never
// swap.  (tag, key) is never packed into one wider integer: for float keys
// a packed bit pattern would order -0.0 before +0.0 and swap where the
// reference does not.  Untagged (K7) is the same rule with every tag 0.
// Because a swap is a fixed function of the two pairs, any schedule that
// applies every stage (s, j) to every pair (i, i + 2^j) in stage order,
// with the direction from bit s+1 of i's index in its row, gives the
// same bytes, tie order included.
template <typename K, bool TAGGED>
__device__ __forceinline__ bool pair_swap(K ka, K kb, uint8_t ta, uint8_t tb, bool asc) {
  bool gt, lt;
  if constexpr (TAGGED) {
    gt = (ta > tb) || (ta == tb && ka > kb);
    lt = (ta < tb) || (ta == tb && ka < kb);
  } else {
    gt = ka > kb;
    lt = ka < kb;
  }
  return asc ? gt : lt;
}

// Shared-memory bytes of one pair: key, payload, and the tag if any.
template <typename K, typename V, bool TAGGED>
constexpr int pair_bytes() {
  return (int)(sizeof(K) + sizeof(V)) + (TAGGED ? 1 : 0);
}

// The pair twin of smem_stages (K6 instantiates it with FILL): stages
// s_lo..s_hi for every distance below the chunk, in shared memory (keys,
// then payloads, then tags).
// Without FILL the tags come from `tin`, and go back to `tout` when it is
// not null (a multi-pass sort keeps them between passes).  With FILL (K6,
// one chunk per segment) the tag is computed on load as
// pos >= seg_lens[segment]; a pad position is not read but takes the
// dtype-max key and a zero payload, and no tag is read or written.
template <typename K, typename V, bool TAGGED, bool FILL>
__global__ void smem_stages_pairs(const K* kin, const uint8_t* tin, const V* vin, K* kout,
                                  uint8_t* tout, V* vout, Segs g, const int* seg_lens, int log_c,
                                  int s_lo, int s_hi, int j_first) {
  static_assert(TAGGED || !FILL, "FILL computes the tag");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = 1 << log_c;
  K* sk = reinterpret_cast<K*>(smem_raw);
  V* sv = reinterpret_cast<V*>(smem_raw + (size_t)c * sizeof(K));
  uint8_t* st = smem_raw + (size_t)c * (sizeof(K) + sizeof(V));
  const int shift = g.log_seg - log_c;
  const long long seg = (long long)blockIdx.x >> shift;
  const long long base_idx = (long long)(blockIdx.x & ((1u << shift) - 1)) << log_c;
  const long long off = seg_offset(g, seg) + base_idx;
  const long long len = FILL ? (long long)seg_lens[seg] : 0;
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    bool pad = false;
    if constexpr (FILL) pad = base_idx + t >= len;
    K k = max_sentinel<K>();
    V v = 0;
    if (!pad) {  // a pad cell is never read
      k = kin[off + t];
      v = vin[off + t];
    }
    if constexpr (FILL) {
      st[t] = pad ? 1 : 0;
    } else if constexpr (TAGGED) {
      st[t] = tin[off + t];
    }
    sk[t] = k;
    sv[t] = v;
  }
  __syncthreads();
  for (int s = s_lo; s <= s_hi; ++s) {
    int j0 = s < log_c - 1 ? s : log_c - 1;
    if (s == s_lo && j_first < j0) j0 = j_first;
    for (int j = j0; j >= 0; --j) {
      for (int q = threadIdx.x; q < c / 2; q += blockDim.x) {
        const int i = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
        const int k = i + (1 << j);
        const K ka = sk[i];
        const K kb = sk[k];
        uint8_t ta = 0, tb = 0;
        if constexpr (TAGGED) {
          ta = st[i];
          tb = st[k];
        }
        if (pair_swap<K, TAGGED>(ka, kb, ta, tb, (((base_idx + i) >> (s + 1)) & 1) == 0)) {
          sk[i] = kb;
          sk[k] = ka;
          if constexpr (TAGGED) {
            st[i] = tb;
            st[k] = ta;
          }
          const V va = sv[i];
          sv[i] = sv[k];
          sv[k] = va;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    kout[off + t] = sk[t];
    vout[off + t] = sv[t];
    if constexpr (TAGGED && !FILL) {
      if (tout != nullptr) tout[off + t] = st[t];
    }
  }
}

inline int threads_for(int log_c) {
  const int pairs = 1 << (log_c - 1);
  return pairs < 1024 ? (pairs < 32 ? 32 : pairs) : 1024;
}

inline unsigned grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 32;  // enough blocks to fill every SM; the loop strides the rest
  return (unsigned)(blocks < cap ? (blocks < 1 ? 1 : blocks) : cap);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Calls f(V{}) with V the unsigned payload type of `width` bytes.
template <typename F>
int dispatch_width(int width, F&& f) {
  switch (width) {
    case 1:
      return f(uint8_t{});
    case 2:
      return f(uint16_t{});
    case 4:
      return f(uint32_t{});
    case 8:
      return f(uint64_t{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt

#define RT_DISPATCH(code, T, ...)                \
  switch (code) {                                \
    case rt::kI8: {                              \
      using T = int8_t;                          \
      __VA_ARGS__;                               \
      break;                                     \
    }                                            \
    case rt::kI16: {                             \
      using T = int16_t;                         \
      __VA_ARGS__;                               \
      break;                                     \
    }                                            \
    case rt::kI32: {                             \
      using T = int32_t;                         \
      __VA_ARGS__;                               \
      break;                                     \
    }                                            \
    case rt::kI64: {                             \
      using T = int64_t;                         \
      __VA_ARGS__;                               \
      break;                                     \
    }                                            \
    case rt::kF32: {                             \
      using T = float;                           \
      __VA_ARGS__;                               \
      break;                                     \
    }                                            \
    default:                                     \
      return (int)cudaErrorInvalidValue;         \
  }
