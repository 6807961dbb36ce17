// Shared pieces of the bitonic kernels (bitonic.cu, batched.cu): key
// types, the compare-exchange, segment addressing and launch helpers.  The
// tiers built on them are in key_tiers.cuh (K2, K3, K4) and pair_tiers.cuh
// (K5, K6, K7).
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
#include <cstring>
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

// Paeth's NICE stage, max = a + b - min, for integer keys.  The sum is
// taken in the unsigned type of the same width: it wraps there by
// definition, whereas signed overflow is undefined and int8/int16 would
// promote to int.  Float keys never take it (rounding breaks the
// identity).
template <typename T>
__device__ __forceinline__ T nice_max(T a, T b, T mn) {
  using U = typename std::make_unsigned<T>::type;
  return static_cast<T>(static_cast<U>(static_cast<U>(a) + static_cast<U>(b) - static_cast<U>(mn)));
}

// One compare-exchange of float keys.  min/max are written as selects on
// `b < a` so the pair always comes out as a permutation of its inputs; the
// plain torch versions use the same selects, so kernel and plain agree bit
// for bit (-0.0 and +0.0 compare equal, and land where the selects put
// them).
template <typename T>
__device__ __forceinline__ void cmp_xchg(T& a, T& b, bool asc) {
  const bool b_lt_a = b < a;
  const T mn = b_lt_a ? b : a;
  const T mx = b_lt_a ? a : b;
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

// Thread u's held element 0 in a window with register bits jb ..
// jb+LOG_E-1 (a thread holds 2^LOG_E keys or pairs): u with those bits
// opened up (cleared) in its binary form.
template <int LOG_E, typename U>
__device__ __forceinline__ U spread(U u, int jb) {
  return ((u >> jb) << (jb + LOG_E)) | (u & ((U(1) << jb) - 1));
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

inline bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
