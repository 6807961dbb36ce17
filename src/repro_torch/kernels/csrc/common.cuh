// Shared pieces of the bitonic kernels (bitonic.cu, batched.cu).
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
  return (seg / g.per_row) * g.row_stride + ((seg % g.per_row) << g.log_seg);
}

// One stage (s, j) over every segment, in device memory: for the
// distances that do not fit one block's shared-memory chunk.
template <typename T>
__global__ void global_stage(T* base, Segs g, long long n_segs, int s, int j) {
  const long long half = 1LL << (g.log_seg - 1);
  const long long total = n_segs * half;
  const long long d = 1LL << j;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const long long seg = p >> (g.log_seg - 1);
    const long long q = p & (half - 1);
    const long long i = ((q >> j) << (j + 1)) | (q & (d - 1));
    T* x = base + seg_offset(g, seg);
    T a = x[i];
    T b = x[i + d];
    cmp_xchg<T, false>(a, b, ((i >> (s + 1)) & 1) == 0);
    x[i] = a;
    x[i + d] = b;
  }
}

// Stages s_lo..s_hi for every distance below the chunk, in shared memory.
// Each block loads one chunk of 2^log_c elements of one segment, runs
// the stages, and stores it back (in and out may alias).  The first stage
// starts at distance 2^j_first when that is lower.  With FILL, positions
// at or past seg_lens[segment] are refilled with the dtype max first (one
// chunk per segment then).
template <typename T, bool TWO_OP, bool FILL>
__global__ void smem_stages(const T* in, T* out, Segs g, const int* seg_lens, int log_c,
                            int s_lo, int s_hi, int j_first) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int c = 1 << log_c;
  const int shift = g.log_seg - log_c;
  const long long seg = (long long)blockIdx.x >> shift;
  const long long base_idx = (long long)(blockIdx.x & ((1u << shift) - 1)) << log_c;
  const long long off = seg_offset(g, seg) + base_idx;
  const long long len = FILL ? (long long)seg_lens[seg] : 0;
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    T v = in[off + t];
    if (FILL && base_idx + t >= len) v = max_sentinel<T>();
    sm[t] = v;
  }
  __syncthreads();
  for (int s = s_lo; s <= s_hi; ++s) {
    int j0 = s < log_c - 1 ? s : log_c - 1;
    if (s == s_lo && j_first < j0) j0 = j_first;
    for (int j = j0; j >= 0; --j) {
      for (int q = threadIdx.x; q < c / 2; q += blockDim.x) {
        const int i = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1));
        const int k = i + (1 << j);
        T a = sm[i];
        T b = sm[k];
        cmp_xchg<T, TWO_OP>(a, b, (((base_idx + i) >> (s + 1)) & 1) == 0);
        sm[i] = a;
        sm[k] = b;
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < c; t += blockDim.x) out[off + t] = sm[t];
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
