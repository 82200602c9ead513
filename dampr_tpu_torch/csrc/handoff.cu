// The handoff's table program for Hopper (sm_90a): probe a padded token
// batch against a job's sorted vocabulary table and count the hits into
// the job's device accumulator in place.
//
// Replaces the XLA program dampr_tpu/ops/handoff.py::_table_program
// (handoff.py:118-200).  For each row i of mat (uint8 [n, L]) with
// lens[i] > 0:
//
//   h    = single-lane FNV-1a over the row's first min(lens[i], L) bytes
//   pos  = min(lower_bound(tab_h1, h), cap - 1)   (unsigned order: the
//          leftmost slot of a run of equal h1, so when two slots share a
//          32-bit h1 the second one's tokens miss to the host)
//   cand = tab_slot[pos]
//   hit  = tab_h1[pos] == h && tab_lens[cand] == lens[i]
//          && row == tab_mat[cand] over W = min(L, Lcap) columns
//   miss[i] = !hit;  n_miss = the count of misses
//
// and the hits add into acc (int64 [cap + 1]) one of three ways (MODE):
//   COUNT   +1 per hit;
//   WINDOW  +1 per hit that is the first of its (slot, line) among the k
//           preceding rows (k <= 16: every line of the batch spans at most
//           k tokens, which the host checked);
//   KEYS    the sort variant's first half: write (slot << 32 | line) per
//           row (slot = cap for a miss or a pad row); the wrapper sorts
//           the keys with torch.sort, then
//   STARTS  adds +1 at the start of every run of equal keys whose slot is
//           below cap.
// Integer atomicAdd is exact in any order, so every mode equals the plain
// torch version (ops/handoff.py::table_probe_reference) bit for bit.
//
// Bound on the card: bytes.  A batch reads n*L + 4n (+ 4n lines) once and
// the table's lanes (4 cap each for tab_h1, tab_slot, tab_lens, Lcap*cap
// for tab_mat) at most once, and writes n miss bytes and the hits' acc
// words.  At the main path's n = 2^18, L = 8 against a 32k-slot table that
// is about 4.9 MB: 1.5 us at 3.35 TB/s.  The binary search's log2(cap)
// dependent loads per row are the latency cost; the 32k-slot h1 lane
// (128 KB) stays in L2.
//
// Design: one thread per row, 256 rows a block.  The row is hashed with
// 4-byte loads where L, Lcap and the bases allow, compared against the
// candidate row word by word, and the block's miss count goes out with one
// atomicAdd (__syncthreads_count).  WINDOW stages the block's slot keys
// and lines in shared memory with a halo of the k rows before the block
// (those k rows are probed again by the block, 6% more work at k = 16), so
// the shifted compares read shared memory only.

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
  if (MODE == COUNT) {
    if (slot < g.cap) atomicAdd(g.acc + slot, 1ULL);
  } else if (MODE == KEYS) {
    if (row < g.n) {
      g.keys[row] = (long long)(((unsigned long long)(unsigned)slot << 32) |
                                (unsigned)g.lines[row]);
    }
  } else {  // WINDOW
    const int k = g.k;
    skey[MAX_K + threadIdx.x] = slot;
    sline[MAX_K + threadIdx.x] = row < g.n ? g.lines[row] : 0;
    if ((int)threadIdx.x < k) {
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
      if (!dup) atomicAdd(g.acc + slot, 1ULL);
    }
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
extern "C" int dampr_handoff(const void* mat, const void* lens,
                             const void* lines, const void* tab_h1,
                             const void* tab_slot, const void* tab_mat,
                             const void* tab_lens, void* acc, void* miss,
                             void* n_miss, void* keys, long long n, int L,
                             int cap, int Lcap, int mode, int k,
                             void* stream) {
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
