// Dual-lane FNV-1a over a padded uint8 token matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel dampr_tpu/ops/pallas_fnv.py::fnv_pallas (its
// kernel is built in _build) and the column fori_loop of
// dampr_tpu/ops/lower.py::_token_fold_jit: for each row i,
//
//   h1 = OFF1, h2 = OFF2
//   for c < min(lens[i], L):  h1 = (h1 ^ b) * P1;  h2 = (h2 ^ b) * P2
//
// with uint32 wraparound.  Constants are dampr_tpu/ops/hashing.py:28-31.
//
// Bound on the card: bytes.  The kernel reads the N*L matrix and N lengths
// once and writes 8*N bytes of lanes; its 4 integer ops per live byte are
// far below the ALU rate.  At the main path's N = 2^18, L = 16 that is
// ~7 MB, about 2 us at 3.35 TB/s, so in practice a single launch is
// launch-overhead-bound.
//
// Design: one thread per row, both lanes in registers as native uint32.
// The row is read straight from the uint8 matrix with 16- or 8-byte vector
// loads (VEC is chosen by the wrapper from L and the base alignment); for
// L = 16 a warp's loads cover 512 contiguous bytes, so they coalesce fully.
// The scan stops at the row's length (bytes past it never mix), exactly
// the reference's masked update.  The TPU version's transpose-and-widen to
// int32 (a TPU layout workaround) is not carried over.
//
// Lanes are written as int32 bit patterns (view as uint32 for the hash).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t OFF1 = 2166136261u;
constexpr uint32_t OFF2 = 0x9747B28Cu;
constexpr uint32_t P1 = 16777619u;
constexpr uint32_t P2 = 0x85EBCA6Bu;

template <int VEC>
struct Vec;
template <>
struct Vec<16> { typedef uint4 T; };
template <>
struct Vec<8> { typedef uint2 T; };
template <>
struct Vec<1> { typedef uint8_t T; };

template <int VEC>
__global__ void fnv_kernel(const uint8_t* __restrict__ mat,
                           const int32_t* __restrict__ lens,
                           uint32_t* __restrict__ h1_out,
                           uint32_t* __restrict__ h2_out,
                           long long n, int L) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int len = lens[row];
  len = len < 0 ? 0 : (len > L ? L : len);
  const uint8_t* p = mat + row * (long long)L;
  uint32_t a = OFF1, b = OFF2;
  for (int c0 = 0; c0 < len; c0 += VEC) {
    typename Vec<VEC>::T chunk =
        *reinterpret_cast<const typename Vec<VEC>::T*>(p + c0);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&chunk);
    int m = len - c0 < VEC ? len - c0 : VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < m) {
        uint32_t x = bytes[k];
        a = (a ^ x) * P1;
        b = (b ^ x) * P2;
      }
    }
  }
  h1_out[row] = a;
  h2_out[row] = b;
}

}  // namespace

extern "C" int dampr_fnv(const void* mat, const void* lens, void* h1,
                         void* h2, long long n, int L, int vec,
                         void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mat;
  const int32_t* l = (const int32_t*)lens;
  uint32_t* o1 = (uint32_t*)h1;
  uint32_t* o2 = (uint32_t*)h2;
  if (vec == 16) {
    fnv_kernel<16><<<blocks, threads, 0, s>>>(m, l, o1, o2, n, L);
  } else if (vec == 8) {
    fnv_kernel<8><<<blocks, threads, 0, s>>>(m, l, o1, o2, n, L);
  } else {
    fnv_kernel<1><<<blocks, threads, 0, s>>>(m, l, o1, o2, n, L);
  }
  return (int)cudaGetLastError();
}
