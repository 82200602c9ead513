// The first design of csrc/handoff.cu (one thread a row, a binary search
// in device memory, one atomicAdd a counted hit, the WINDOW halo probed
// again by each block's first k threads), kept as the yardstick of the
// redesign, with three switches that take one of its costs away.  It is
// not a kernel of the port: chip_smoke.py builds it to time the ablations
// that located the old design's cost (time_handoff_ablations).
//
// flags bit 1: no atomicAdd into acc (a block-counted write no one reads
//              keeps the probe and the dedup live);
//       bit 2: the position comes from pos[] (lower_bound computed
//              beforehand) instead of the binary search;
//       bit 4: the WINDOW halo rows are not probed again (their keys read
//              as misses).
// Only flags 0 gives the plain version's acc; 4 may differ from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t OFF1 = 2166136261u;
constexpr uint32_t P1 = 16777619u;
constexpr int THREADS = 256;
constexpr int MAX_K = 16;

enum Mode { COUNT = 0, WINDOW = 1, KEYS = 2, STARTS = 3 };

struct Args {
  const uint8_t* mat;
  const int32_t* lens;
  const int32_t* lines;
  const uint32_t* tab_h1;
  const int32_t* tab_slot;
  const uint8_t* tab_mat;
  const int32_t* tab_lens;
  unsigned long long* acc;
  uint8_t* miss;
  int* n_miss;
  long long* keys;
  long long n;
  int L;
  int cap;
  int Lcap;
  int W;
  int k;
  bool words;
  int flags;
  const int32_t* pos;
};

// The slot row `row` hits, or cap; *miss is set for a valid row that
// misses.
__device__ __forceinline__ int probe(const Args& g, long long row,
                                     bool* miss) {
  const int raw = g.lens[row];
  *miss = false;
  if (raw <= 0) return g.cap;
  const int len = raw > g.L ? g.L : raw;
  const uint8_t* p = g.mat + row * (long long)g.L;
  uint32_t h = OFF1;
  if (g.words) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
    for (int w = 0; 4 * w < len; ++w) {
      const uint32_t x = pw[w];
      const int m = len - 4 * w < 4 ? len - 4 * w : 4;
      for (int j = 0; j < m; ++j) h = (h ^ ((x >> (8 * j)) & 0xFFu)) * P1;
    }
  } else {
    for (int c = 0; c < len; ++c) h = (h ^ p[c]) * P1;
  }
  int lo = 0, hi = g.cap;
  if (g.flags & 2) lo = hi = g.pos[row];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(g.tab_h1 + mid) < h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int pos = lo < g.cap ? lo : g.cap - 1;
  bool same = __ldg(g.tab_h1 + pos) == h;
  int cand = 0;
  if (same) {
    cand = __ldg(g.tab_slot + pos);
    same = __ldg(g.tab_lens + cand) == raw;
  }
  if (same) {
    const uint8_t* q = g.tab_mat + (long long)cand * g.Lcap;
    if (g.words) {
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
      for (int w = 0; w < g.W / 4; ++w) {
        if (pw[w] != __ldg(qw + w)) {
          same = false;
          break;
        }
      }
    } else {
      for (int c = 0; c < g.W; ++c) {
        if (p[c] != __ldg(q + c)) {
          same = false;
          break;
        }
      }
    }
  }
  *miss = !same;
  return same ? cand : g.cap;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) probe_rows(Args g) {
  __shared__ int skey[MAX_K + THREADS];
  __shared__ int sline[MAX_K + THREADS];
  const long long row0 = (long long)blockIdx.x * THREADS;
  const long long row = row0 + threadIdx.x;
  bool m = false;
  int slot = g.cap;
  if (row < g.n) {
    slot = probe(g, row, &m);
    g.miss[row] = m ? 1 : 0;
  }
  bool add = false;
  if (MODE == COUNT) {
    add = slot < g.cap;
  } else if (MODE == KEYS) {
    if (row < g.n) {
      g.keys[row] = (long long)(((unsigned long long)(unsigned)slot << 32) |
                                (unsigned)g.lines[row]);
    }
  } else {  // WINDOW
    const int k = g.k;
    if ((int)threadIdx.x < k) {
      skey[MAX_K - k + threadIdx.x] = g.cap;
      sline[MAX_K - k + threadIdx.x] = 0;
    }
    skey[MAX_K + threadIdx.x] = slot;
    sline[MAX_K + threadIdx.x] = row < g.n ? g.lines[row] : 0;
    if ((int)threadIdx.x < k && !(g.flags & 4)) {
      const long long hrow = row0 - k + threadIdx.x;
      int hs = g.cap, hl = 0;
      if (hrow >= 0) {
        bool hm;
        hs = probe(g, hrow, &hm);
        hl = g.lines[hrow];
      }
      skey[MAX_K - k + threadIdx.x] = hs;
      sline[MAX_K - k + threadIdx.x] = hl;
    }
    __syncthreads();
    if (slot < g.cap) {
      const int line = sline[MAX_K + threadIdx.x];
      bool dup = false;
      for (int d = 1; d <= k && row - d >= 0; ++d) {
        const int j = MAX_K + (int)threadIdx.x - d;
        if (skey[j] == slot && sline[j] == line) {
          dup = true;
          break;
        }
      }
      add = !dup;
    }
  }
  if (!(g.flags & 1)) {
    if (add) atomicAdd(g.acc + slot, 1ULL);
  } else {
    const int adds = __syncthreads_count(add);
    if (threadIdx.x == 0 && adds == -1) g.acc[g.cap] = 0;
  }
  const int count = __syncthreads_count(m);
  if (threadIdx.x == 0 && count) atomicAdd(g.n_miss, count);
}

__global__ void __launch_bounds__(THREADS)
    run_starts(const long long* __restrict__ keys,
               unsigned long long* __restrict__ acc, long long n, int cap) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long key = keys[i];
  const int slot = (int)(key >> 32);
  if (slot < cap && (i == 0 || keys[i - 1] != key)) {
    atomicAdd(acc + slot, 1ULL);
  }
}

bool aligned4(const void* p) { return (uintptr_t)p % 4 == 0; }

}  // namespace

// mode 0 COUNT, 1 WINDOW (k preceding rows, 1 <= k <= 16), 2 KEYS (writes
// keys [n]), 3 STARTS (keys sorted [n] in, adds into acc; every other
// pointer may be null).  Modes 0-2 write miss [n] (bytes 0/1) and n_miss
// (int32, zeroed here on the stream first).  Tables: tab_h1 uint32 [cap]
// sorted, tab_slot and tab_lens int32 [cap], tab_mat uint8 [cap, Lcap],
// acc int64 [cap + 1]; cap >= 1.
extern "C" int dampr_handoff_ablate(const void* mat, const void* lens,
                             const void* lines, const void* tab_h1,
                             const void* tab_slot, const void* tab_mat,
                             const void* tab_lens, void* acc, void* miss,
                             void* n_miss, void* keys, long long n, int L,
                             int cap, int Lcap, int mode, int k,
                             int flags, const void* pos, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cap < 1 || n < 0 || (mode == WINDOW && (k < 1 || k > MAX_K))) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (mode == STARTS) {
    if (n > 0) {
      run_starts<<<blocks, THREADS, 0, s>>>(
          (const long long*)keys, (unsigned long long*)acc, n, cap);
    }
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(n_miss, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  Args g;
  g.mat = (const uint8_t*)mat;
  g.lens = (const int32_t*)lens;
  g.lines = (const int32_t*)lines;
  g.tab_h1 = (const uint32_t*)tab_h1;
  g.tab_slot = (const int32_t*)tab_slot;
  g.tab_mat = (const uint8_t*)tab_mat;
  g.tab_lens = (const int32_t*)tab_lens;
  g.acc = (unsigned long long*)acc;
  g.miss = (uint8_t*)miss;
  g.n_miss = (int*)n_miss;
  g.keys = (long long*)keys;
  g.n = n;
  g.L = L;
  g.cap = cap;
  g.Lcap = Lcap;
  g.W = L < Lcap ? L : Lcap;
  g.k = k;
  g.flags = flags;
  g.pos = (const int32_t*)pos;
  g.words = L % 4 == 0 && Lcap % 4 == 0 && aligned4(mat) && aligned4(tab_mat);
  if (mode == WINDOW) {
    probe_rows<WINDOW><<<blocks, THREADS, 0, s>>>(g);
  } else if (mode == KEYS) {
    probe_rows<KEYS><<<blocks, THREADS, 0, s>>>(g);
  } else {
    probe_rows<COUNT><<<blocks, THREADS, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}
