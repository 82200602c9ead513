// Dual-lane FNV-1a over a padded uint8 token matrix, fused with the sort
// keys of the lowered token fold, for Hopper (sm_90a).
//
// Replaces the TPU kernel dampr_tpu/ops/pallas_fnv.py::fnv_pallas (its
// kernel is built in _build) and the column fori_loop of
// dampr_tpu/ops/lower.py::_token_fold_jit: for each row i,
//
//   h1 = OFF1, h2 = OFF2
//   for c < min(max(lens[i], 0), L):  h1 = (h1 ^ b) * P1;  h2 = (h2 ^ b) * P2
//
// with uint32 wraparound.  Constants are dampr_tpu/ops/hashing.py:28-31.
//
// One source, three outputs (MODE, a template flag):
//   LANES     h1, h2 as uint32 bit patterns (the string-key hash path);
//   KEYS      the two int64 sort keys of the token fold (csrc/sort_keys.cuh)
//             with inv = lens[i] <= 0;
//   KEYS_DEDUP the same with the line in the low key, for per-line dedup;
// so the fold's two stable sorts read the keys straight from this launch.
//
// Bound on the card: bytes.  LANES reads N*L + 4N and writes 8N; the keys
// read N*L + 4N (+ 4N lines) and write 16N.  At the main path's N = 2^18,
// L = 8, KEYS_DEDUP moves 32 bytes a row, 8.4 MB: 2.5 us at 3.35 TB/s.
// The 4 integer operations per live byte are far below the ALU rate.
//
// Design.
// - Tile path (L in {8, 16, 32}): a block owns 1024 consecutive rows, a
//   contiguous run of 1024*L bytes.  Its threads copy that run into shared
//   memory with coalesced 16-byte loads (4-byte loads when the base is
//   not 16-byte aligned), whatever L is, then each thread hashes 4 rows
//   out of shared memory.  Rows sit at a padded stride of L/4 + 1 words,
//   an odd number, so the 32 rows a warp reads at once fall in 32
//   different banks.  Consecutive threads own consecutive rows, so every
//   output store is coalesced.  At N = 2^18 that is 256 blocks, all
//   resident at once on the 132 SMs.
// - Direct path (any other L: wide or odd rows): one thread per row reads
//   the row with 16-, 8- or 1-byte loads, the widest the base and L allow.
// - The scan over a row stops at its length (bytes past it never mix),
//   exactly the reference's masked update.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_keys.cuh"

namespace {

constexpr uint32_t OFF1 = 2166136261u;
constexpr uint32_t OFF2 = 0x9747B28Cu;
constexpr uint32_t P1 = 16777619u;
constexpr uint32_t P2 = 0x85EBCA6Bu;

enum Mode { LANES = 0, KEYS = 1, KEYS_DEDUP = 2 };

constexpr int TILE_THREADS = 256;
constexpr int TILE_RPT = 4;  // rows per thread
constexpr int TILE_ROWS = TILE_THREADS * TILE_RPT;

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t x) {
  a = (a ^ x) * P1;
  b = (b ^ x) * P2;
}

// Write one row's outputs.  out0/out1 are h1/h2 (uint32) or low/high
// (int64) depending on MODE.
template <int MODE>
__device__ __forceinline__ void emit(long long row, uint32_t a, uint32_t b,
                                     int raw_len,
                                     const int32_t* __restrict__ lines,
                                     void* __restrict__ out0,
                                     void* __restrict__ out1) {
  if (MODE == LANES) {
    static_cast<uint32_t*>(out0)[row] = a;
    static_cast<uint32_t*>(out1)[row] = b;
  } else {
    static_cast<unsigned long long*>(out0)[row] = sort_keys::low(
        b, MODE == KEYS_DEDUP ? lines[row] : 0, MODE == KEYS_DEDUP);
    static_cast<unsigned long long*>(out1)[row] =
        sort_keys::high(a, raw_len <= 0 ? 1u : 0u);
  }
}

__device__ __forceinline__ int clamp_len(int len, int L) {
  return len < 0 ? 0 : (len > L ? L : len);
}

// Direct path: one thread per row, VEC-byte loads from the row itself.
template <int VEC>
struct Vec;
template <>
struct Vec<16> { typedef uint4 T; };
template <>
struct Vec<8> { typedef uint2 T; };
template <>
struct Vec<1> { typedef uint8_t T; };

template <int VEC, int MODE>
__global__ void __launch_bounds__(256)
    fnv_rows(const uint8_t* __restrict__ mat, const int32_t* __restrict__ lens,
             const int32_t* __restrict__ lines, void* __restrict__ out0,
             void* __restrict__ out1, long long n, int L) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int raw = lens[row];
  const int len = clamp_len(raw, L);
  const uint8_t* p = mat + row * (long long)L;
  uint32_t a = OFF1, b = OFF2;
  for (int c0 = 0; c0 < len; c0 += VEC) {
    typename Vec<VEC>::T chunk =
        *reinterpret_cast<const typename Vec<VEC>::T*>(p + c0);
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&chunk);
    const int m = len - c0 < VEC ? len - c0 : VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (k < m) mix(a, b, bytes[k]);
    }
  }
  emit<MODE>(row, a, b, raw, lines, out0, out1);
}

// Tile path: stage TILE_ROWS rows of L = 4 * WORDS bytes in shared memory,
// then hash from there.
template <int WORDS, bool VEC16, int MODE>
__global__ void __launch_bounds__(TILE_THREADS)
    fnv_tile(const uint8_t* __restrict__ mat, const int32_t* __restrict__ lens,
             const int32_t* __restrict__ lines, void* __restrict__ out0,
             void* __restrict__ out1, long long n) {
  constexpr int L = 4 * WORDS;
  constexpr int STRIDE = WORDS + 1;  // odd: conflict-free row reads
  __shared__ uint32_t tile[TILE_ROWS * STRIDE];

  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  const long long left = n - row0;
  const int rows = left < TILE_ROWS ? (int)left : TILE_ROWS;
  const int words = rows * WORDS;
  const uint8_t* src = mat + row0 * L;
  const int tid = threadIdx.x;

  int done = 0;
  if (VEC16) {
    const int quads = words >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int q = tid; q < quads; q += TILE_THREADS) {
      const uint4 v = s4[q];
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int w = 4 * q + k;
        tile[(w / WORDS) * STRIDE + (w % WORDS)] = w4[k];
      }
    }
    done = quads << 2;
  }
  const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
  for (int w = done + tid; w < words; w += TILE_THREADS) {
    tile[(w / WORDS) * STRIDE + (w % WORDS)] = s1[w];
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < TILE_RPT; ++k) {
    const int r = tid + k * TILE_THREADS;
    if (r >= rows) break;
    const long long row = row0 + r;
    const int raw = lens[row];
    const int len = clamp_len(raw, L);
    const uint32_t* rp = tile + r * STRIDE;
    uint32_t a = OFF1, b = OFF2;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      if (4 * w >= len) break;
      const uint32_t x = rp[w];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * w + j < len) mix(a, b, (x >> (8 * j)) & 0xFFu);
      }
    }
    emit<MODE>(row, a, b, raw, lines, out0, out1);
  }
}

template <int MODE>
cudaError_t launch(const uint8_t* m, const int32_t* l, const int32_t* li,
                   void* o0, void* o1, long long n, int L, cudaStream_t s) {
  const uintptr_t base = (uintptr_t)m;
  const bool tile_ok = (L == 8 || L == 16 || L == 32) && base % 4 == 0;
  if (tile_ok) {
    const unsigned blocks = (unsigned)((n + TILE_ROWS - 1) / TILE_ROWS);
    const bool v16 = base % 16 == 0;
    if (L == 8) {
      if (v16) fnv_tile<2, true, MODE><<<blocks, TILE_THREADS, 0, s>>>(m, l, li, o0, o1, n);
      else fnv_tile<2, false, MODE><<<blocks, TILE_THREADS, 0, s>>>(m, l, li, o0, o1, n);
    } else if (L == 16) {
      if (v16) fnv_tile<4, true, MODE><<<blocks, TILE_THREADS, 0, s>>>(m, l, li, o0, o1, n);
      else fnv_tile<4, false, MODE><<<blocks, TILE_THREADS, 0, s>>>(m, l, li, o0, o1, n);
    } else {
      if (v16) fnv_tile<8, true, MODE><<<blocks, TILE_THREADS, 0, s>>>(m, l, li, o0, o1, n);
      else fnv_tile<8, false, MODE><<<blocks, TILE_THREADS, 0, s>>>(m, l, li, o0, o1, n);
    }
    return cudaGetLastError();
  }
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (L % 16 == 0 && base % 16 == 0) {
    fnv_rows<16, MODE><<<blocks, threads, 0, s>>>(m, l, li, o0, o1, n, L);
  } else if (L % 8 == 0 && base % 8 == 0) {
    fnv_rows<8, MODE><<<blocks, threads, 0, s>>>(m, l, li, o0, o1, n, L);
  } else {
    fnv_rows<1, MODE><<<blocks, threads, 0, s>>>(m, l, li, o0, o1, n, L);
  }
  return cudaGetLastError();
}

}  // namespace

// mode: 0 LANES (out0 = h1, out1 = h2, uint32 [n]); 1 KEYS and 2
// KEYS_DEDUP (out0 = low, out1 = high, int64 [n]; lines read only by 2).
extern "C" int dampr_fnv(const void* mat, const void* lens, const void* lines,
                         void* out0, void* out1, long long n, int L, int mode,
                         void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mat;
  const int32_t* l = (const int32_t*)lens;
  const int32_t* li = (const int32_t*)lines;
  if (mode == KEYS_DEDUP) return (int)launch<KEYS_DEDUP>(m, l, li, out0, out1, n, L, s);
  if (mode == KEYS) return (int)launch<KEYS>(m, l, li, out0, out1, n, L, s);
  return (int)launch<LANES>(m, l, li, out0, out1, n, L, s);
}
