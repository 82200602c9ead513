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
// Integer adds are exact in any order, so every mode equals the plain
// torch version (ops/handoff.py::table_probe_reference) bit for bit.
//
// Bound on the card: bytes.  A batch reads n*L + 4n (+ 4n lines) once and
// the table's lanes (4 cap each for tab_h1, tab_slot, tab_lens, Lcap*cap
// for tab_mat) at most once, and writes n miss bytes and the hits' acc
// words.  At the main path's n = 2^18, L = 8 against a 32k-slot table that
// is about 5.4 MB: 1.6 us at 3.35 TB/s.
//
// What held the first design back (one thread a row, a binary
// search in device memory, one atomicAdd a counted hit, the WINDOW halo
// probed again by each block's first k threads), measured on an H100 at
// the corpus batch by chip_smoke.py's time_handoff_ablations over
// tools/handoff_ablate.cu: the atomics.  WINDOW took 0.0461 ms (0.0642
// with slots in first-seen order); without the atomics 0.0199, without
// the search 0.0399, without the halo probe 0.0431.  Every hit of a Zipf
// head word added into one address; first-seen order puts the head's
// slots into the same few cache lines, which is why it was slower.
//
// Design.  A block of THREADS threads walks a contiguous span of tiles of
// TILE rows (a grid of at most the blocks the card holds at once; at the
// main path's batch one tile a block), ROWS rows a thread, row
// j * THREADS + t to thread t, so each phase's loads of a thread's rows
// are in flight together and a warp's loads stay coalesced.
//   - The count: hits never go straight to a global atomic.  Each hit
//     adds one into a block-private open-addressing table (AGG entries of
//     slot and count in shared memory); the block adds each distinct slot
//     into acc once, at the end of its span.  An insert that finds no
//     free entry within AGG_PROBES goes to acc directly.  A slot's home
//     entry is the slot modulo AGG, so a warp of the flush adds into
//     neighbouring acc words, which the card merges into one request a
//     cache line: every block adds the Zipf head, and with the entries in
//     hashed order those adds queued on the head's few lines.  Grouping a
//     warp's equal slots first (__match_any_sync, one add a group) was
//     slower than the shared-memory atomics it saves.  STARTS (keys
//     sorted by slot) counts its run starts the same way.
//   - The search: the block stages every S-th lane of tab_h1 (S = 2^seg,
//     at most MAX_SAMPLES samples, 16 KB) in shared memory once, finds the
//     first sample >= h there, and finishes the lower bound among the S
//     lanes before that sample: at S = 4 or 8 (the main path's 32k-slot
//     table) one or two 16-byte loads of one sector, counted; otherwise a
//     binary search in device memory.  Counting the lanes below h keeps
//     the leftmost lane of an equal-h1 run, also across a sample boundary.
//   - The WINDOW halo: the k rows before a span's first tile are probed
//     in the same pass as the tile's own rows (a WINDOW tile owns
//     TILE - MAX_K rows, so with its halo it is at most TILE rows, ROWS a
//     thread), and every later tile of the span finds the last k keys of
//     the tile before it still in shared memory.  A row's k earlier
//     (slot, line) pairs are compared as 64-bit words, all loads at once.
//   - The miss count: one warp sum a warp, one atomicAdd a block.
// Shared memory above 48 KB (WINDOW: 64 KB) is set with
// cudaFuncSetAttribute, and the grid comes from the occupancy the card
// reports, both asked once per device, kernel and shared-memory size;
// every CUDA call's error is returned to the wrapper.
//
// On an H100 (80GB HBM3, 700 W) at the corpus batch (chip_smoke.py's
// kernels line): WINDOW 0.0167 ms in either slot order, COUNT 0.0147,
// against 0.0461 for the first design and a byte bound of 0.0016.  The
// first design with none of its three costs took 0.0117: what is left is
// the probe itself, its dependent gathers into the table's lanes (the
// segment, tab_slot, tab_lens, tab_mat: a cache line a lane).

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr uint32_t OFF1 = 2166136261u;
constexpr uint32_t P1 = 16777619u;
constexpr int THREADS = 1024;
constexpr int ROWS = 2;
constexpr int TILE = THREADS * ROWS;
constexpr int MAX_K = 16;
constexpr int MAX_SAMPLES = 4096;
constexpr int AGG = 4096;
constexpr int AGG_PROBES = 8;
constexpr int EMPTY = -1;

static_assert(MAX_SAMPLES % THREADS == 0, "a thread stages whole rows");

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
  long long tiles;
  int L;
  int cap;
  int Lcap;
  int W;
  int k;
  bool words;
  bool vec;        // S is 4 or 8 and tab_h1 16-byte aligned: one or two
                   // 16-byte loads read a sample's segment
  int seg;         // S = 1 << seg lanes a sample
  int samples;     // ceil(cap / S) <= MAX_SAMPLES
  int samples_p2;  // the staged index's length: a power of two >= samples
};

// Rows a tile of `mode` owns: a WINDOW tile leaves room for its halo, so
// the tile and its halo are TILE rows, ROWS a thread.
__host__ __device__ constexpr int own_rows(int mode) {
  return mode == WINDOW ? TILE - MAX_K : TILE;
}

// Shared memory a block of `mode` takes: the aggregation table (not KEYS),
// the WINDOW (slot, line) pairs of one tile with its halo, the sampled
// index (not STARTS).
size_t smem_bytes(int mode, int samples_p2) {
  size_t b = 0;
  if (mode != KEYS) b += 8 * (size_t)AGG;
  if (mode == WINDOW) b += 8 * (size_t)TILE;
  if (mode != STARTS) b += 4 * (size_t)samples_p2;
  return b;
}

__device__ __forceinline__ uint32_t hash8(uint2 w, int raw) {
  const int len = raw > 8 ? 8 : raw;
  uint32_t h = OFF1;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t x = c < 4 ? w.x : w.y;
    if (c < len) h = (h ^ ((x >> (8 * (c & 3))) & 0xFFu)) * P1;
  }
  return h;
}

__device__ __forceinline__ uint32_t hash_row(const Args& g, long long row,
                                             int raw) {
  if (raw <= 0) return 0;
  const int len = raw > g.L ? g.L : raw;
  const uint8_t* p = g.mat + row * (long long)g.L;
  uint32_t h = OFF1;
  if (g.words) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
    for (int w = 0; 4 * w < len; ++w) {
      const uint32_t x = __ldg(pw + w);
      const int m = len - 4 * w < 4 ? len - 4 * w : 4;
      for (int j = 0; j < m; ++j) h = (h ^ ((x >> (8 * j)) & 0xFFu)) * P1;
    }
  } else {
    for (int c = 0; c < len; ++c) h = (h ^ __ldg(p + c)) * P1;
  }
  return h;
}

// The row's first W bytes against slot cand's.
__device__ __forceinline__ bool row_equal(const Args& g, long long row,
                                         int cand) {
  const uint8_t* p = g.mat + row * (long long)g.L;
  const uint8_t* q = g.tab_mat + (long long)cand * g.Lcap;
  if (g.words) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q);
    for (int w = 0; w < g.W / 4; ++w) {
      if (__ldg(pw + w) != __ldg(qw + w)) return false;
    }
  } else {
    for (int c = 0; c < g.W; ++c) {
      if (__ldg(p + c) != __ldg(q + c)) return false;
    }
  }
  return true;
}

// Add one to slot `key` in the block's table, or, past AGG_PROBES taken
// entries, in acc directly.  A slot's home entry is the slot itself
// modulo AGG, so the table lies mostly in slot order and the flush's warps
// add into runs of neighbouring acc words.
__device__ __forceinline__ void agg_add(int* t_key, unsigned* t_cnt,
                                        unsigned long long* acc, int key) {
  unsigned i = (unsigned)key & (AGG - 1);
  for (int p = 0; p < AGG_PROBES; ++p, i = (i + 1) & (AGG - 1)) {
    const int old = atomicCAS(t_key + i, EMPTY, key);
    if (old == EMPTY || old == key) {
      atomicAdd(t_cnt + i, 1u);
      return;
    }
  }
  atomicAdd(acc + key, 1ULL);
}

// The block's table into acc, one atomicAdd a distinct slot.
__device__ __forceinline__ void agg_flush(const int* t_key,
                                          const unsigned* t_cnt,
                                          unsigned long long* acc) {
  for (int i = threadIdx.x; i < AGG; i += THREADS) {
    const int key = t_key[i];
    if (key != EMPTY) atomicAdd(acc + key, (unsigned long long)t_cnt[i]);
  }
}

__device__ __forceinline__ void agg_clear(int* t_key, unsigned* t_cnt) {
  for (int i = threadIdx.x; i < AGG; i += THREADS) {
    t_key[i] = EMPTY;
    t_cnt[i] = 0;
  }
}

// This block's span of tiles [*t0, *t1).
__device__ __forceinline__ void span(long long tiles, long long* t0,
                                     long long* t1) {
  *t0 = tiles * blockIdx.x / gridDim.x;
  *t1 = tiles * (blockIdx.x + 1) / gridDim.x;
}

// L8: L == 8 and the candidate's first 8 bytes one aligned word pair, so a
// row is hashed and compared from registers.
template <int MODE, bool L8>
__global__ void __launch_bounds__(THREADS) probe_rows(Args g) {
  constexpr int OWN = own_rows(MODE);
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NT = MODE == KEYS ? 0 : AGG;
  int* t_key = reinterpret_cast<int*>(smem);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + NT);
  unsigned long long* w_pair =
      reinterpret_cast<unsigned long long*>(t_cnt + NT);
  uint32_t* s_samp = reinterpret_cast<uint32_t*>(
      w_pair + (MODE == WINDOW ? TILE : 0));
  __shared__ int s_miss;

  const int tid = threadIdx.x;
  uint32_t samp[MAX_SAMPLES / THREADS];  // all of a thread's loads at once
#pragma unroll
  for (int r = 0; r < MAX_SAMPLES / THREADS; ++r) {
    const int i = tid + r * THREADS;
    samp[r] = i < g.samples ? __ldg(g.tab_h1 + ((long long)i << g.seg))
                            : 0xFFFFFFFFu;
  }
#pragma unroll
  for (int r = 0; r < MAX_SAMPLES / THREADS; ++r) {
    const int i = tid + r * THREADS;
    if (i < g.samples_p2) s_samp[i] = samp[r];
  }
  if (MODE != KEYS) agg_clear(t_key, t_cnt);
  if (tid == 0) s_miss = 0;
  // no barrier yet: the first tile's row loads go out behind the staging's

  const int k = MODE == WINDOW ? g.k : 0;
  const int S = 1 << g.seg;
  long long t0, t1;
  span(g.tiles, &t0, &t1);
  int my_miss = 0;
  for (long long tile = t0; tile < t1; ++tile) {
    const long long row0 = tile * OWN;
    const int cnt = (int)(g.n - row0 < OWN ? g.n - row0 : OWN);
    const int e_lo = tile == t0 ? 0 : k;  // a carried halo is not probed
    long long row[ROWS];
    bool act[ROWS];
    int raw[ROWS];
    int line[ROWS];
    uint2 w[ROWS];
    uint32_t h[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int e = tid + j * THREADS;
      row[j] = row0 - k + e;
      act[j] = e >= e_lo && e < k + cnt;
      const bool ok = act[j] && row[j] >= 0;
      raw[j] = ok ? __ldg(g.lens + row[j]) : 0;
      line[j] = (MODE == WINDOW || MODE == KEYS) && ok
                    ? __ldg(g.lines + row[j]) : 0;
      w[j] = make_uint2(0, 0);
      if (L8 && ok) {
        w[j] = __ldg(reinterpret_cast<const uint2*>(g.mat) + row[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      h[j] = L8 ? hash8(w[j], raw[j]) : hash_row(g, row[j], raw[j]);
    }
    if (tile == t0) __syncthreads();  // the index and the table are set
    // the first sample >= h, in shared memory
    int base[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) base[j] = 0;
    for (int half = g.samples_p2 >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (s_samp[base[j] + half - 1] < h[j]) base[j] += half;
      }
    }
    // the lower bound among the lanes before that sample: sample s - 1 is
    // below h, so it lies in ((s - 1) * S, s * S]
    int pos[ROWS];
    bool same[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      int s = base[j] + (s_samp[base[j]] < h[j] ? 1 : 0);
      if (s > g.samples) s = g.samples;
      base[j] = s;
    }
    if (g.vec) {  // the segment in one or two 16-byte loads, counted
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int s = base[j];
        const int b = s == 0 ? 0 : (s - 1) << g.seg;
        const uint4* q = reinterpret_cast<const uint4*>(g.tab_h1 + b);
        uint4 a = make_uint4(0, 0, 0, 0), c = a;
        if (s > 0) {
          a = __ldg(q);
          if (S == 8) c = __ldg(q + 1);
        }
        const uint32_t x = h[j];
        int below = (a.x < x) + (a.y < x) + (a.z < x) + (a.w < x);
        bool eq = a.x == x || a.y == x || a.z == x || a.w == x;
        if (S == 8) {
          below += (c.x < x) + (c.y < x) + (c.z < x) + (c.w < x);
          eq = eq || c.x == x || c.y == x || c.z == x || c.w == x;
        }
        if (s == 0) {
          pos[j] = 0;
          eq = s_samp[0] == x;
        } else {
          pos[j] = b + below;
          // every lane of the segment below h: the answer is sample s
          if (below == S) eq = pos[j] < g.cap && s_samp[s] == x;
        }
        same[j] = raw[j] > 0 && eq;
      }
    } else {  // a binary search of the S - 1 lanes in device memory
      int hi[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int s = base[j];
        const long long end = (long long)s << g.seg;
        pos[j] = s == 0 ? 0 : ((s - 1) << g.seg) + 1;
        hi[j] = end < g.cap ? (int)end : g.cap;
      }
      for (int l = 0; l < g.seg; ++l) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          if (pos[j] < hi[j]) {
            const int mid =
                (int)(((unsigned)pos[j] + (unsigned)hi[j]) >> 1);
            if (__ldg(g.tab_h1 + mid) < h[j]) {
              pos[j] = mid + 1;
            } else {
              hi[j] = mid;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        // pos is the lower bound; cap means every lane is below h
        const int p = pos[j];
        same[j] = raw[j] > 0 && p < g.cap;
        if (same[j]) {
          const uint32_t th = (p & (S - 1)) == 0 ? s_samp[p >> g.seg]
                                                 : __ldg(g.tab_h1 + p);
          same[j] = th == h[j];
        }
      }
    }
    int cand[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      cand[j] = same[j] ? __ldg(g.tab_slot + pos[j]) : 0;
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (same[j]) {
        const int tl = __ldg(g.tab_lens + cand[j]);
        if (L8) {
          const uint2 tw = __ldg(reinterpret_cast<const uint2*>(
              g.tab_mat + (long long)cand[j] * g.Lcap));
          same[j] = tl == raw[j] && tw.x == w[j].x && tw.y == w[j].y;
        } else {
          same[j] = tl == raw[j] && row_equal(g, row[j], cand[j]);
        }
      }
    }
    int slot[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      slot[j] = same[j] ? cand[j] : g.cap;
      if (act[j] && row[j] >= row0) {  // a row of this tile, not the halo
        const bool m = raw[j] > 0 && !same[j];
        g.miss[row[j]] = m ? 1 : 0;
        my_miss += m ? 1 : 0;
        if (MODE == KEYS) {
          g.keys[row[j]] = (long long)(
              ((unsigned long long)(unsigned)slot[j] << 32) |
              (unsigned)line[j]);
        }
      }
    }
    if (MODE == COUNT) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (act[j] && row[j] >= row0 && slot[j] < g.cap) {
          agg_add(t_key, t_cnt, g.acc, slot[j]);
        }
      }
    } else if (MODE == WINDOW) {
      unsigned long long pair[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        pair[j] = (unsigned long long)(unsigned)slot[j] << 32 |
                  (unsigned)line[j];
        if (act[j]) w_pair[tid + j * THREADS] = pair[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int e = tid + j * THREADS;
        if (act[j] && row[j] >= row0 && slot[j] < g.cap) {
          // the k pairs before it, all loads at once; rows before the
          // batch read as misses (slot cap): no match
          bool dup = false;
#pragma unroll
          for (int d = 1; d <= MAX_K; ++d) {
            if (d <= k) dup = dup || w_pair[e - d] == pair[j];
          }
          if (!dup) agg_add(t_key, t_cnt, g.acc, slot[j]);
        }
      }
      __syncthreads();
      if (tile + 1 < t1 && tid < k) {  // carry this tile's last k rows
        w_pair[tid] = w_pair[cnt + tid];
      }
      __syncthreads();
    }
  }
  const int wm = __reduce_add_sync(0xFFFFFFFFu, my_miss);
  if ((tid & 31) == 0 && wm) atomicAdd(&s_miss, wm);
  __syncthreads();
  if (MODE != KEYS) agg_flush(t_key, t_cnt, g.acc);
  if (tid == 0 && s_miss) atomicAdd(g.n_miss, s_miss);
}

__global__ void __launch_bounds__(THREADS) run_starts(Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* t_key = reinterpret_cast<int*>(smem);
  unsigned* t_cnt = reinterpret_cast<unsigned*>(t_key + AGG);
  agg_clear(t_key, t_cnt);
  __syncthreads();
  long long t0, t1;
  span(g.tiles, &t0, &t1);
  for (long long tile = t0; tile < t1; ++tile) {
    long long key[ROWS], prev[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const long long i = tile * TILE + threadIdx.x + j * THREADS;
      key[j] = i < g.n ? g.keys[i] : -1;
      prev[j] = i > 0 && i < g.n ? g.keys[i - 1] : -1;
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int slot = (int)(key[j] >> 32);
      if (key[j] >= 0 && slot < g.cap && prev[j] != key[j]) {
        agg_add(t_key, t_cnt, g.acc, slot);
      }
    }
  }
  __syncthreads();
  agg_flush(t_key, t_cnt, g.acc);
}

bool aligned(const void* p, uintptr_t a) { return (uintptr_t)p % a == 0; }

// The blocks of `kern` the card `dev` holds at once with `smem` bytes of
// shared memory each, asked of the card on a kernel's first launch at
// that size on that device.  That first launch also raises the kernel's
// shared-memory limit to `most_smem`, the most any launch of it asks, so
// concurrent launches of other sizes never lower it under one another.
std::mutex plans_mu;
std::map<std::tuple<int, const void*, size_t>, long long> plans;

cudaError_t resident_blocks(void (*kern)(Args), int dev, size_t smem,
                            size_t most_smem, long long* most) {
  const auto key = std::make_tuple(dev, (const void*)kern, smem);
  {
    std::lock_guard<std::mutex> lock(plans_mu);
    const auto it = plans.find(key);
    if (it != plans.end()) {
      *most = it->second;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most_smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *most = (long long)sms * per_sm;
  std::lock_guard<std::mutex> lock(plans_mu);
  plans[key] = *most;
  return cudaSuccess;
}

// Launch `kern` (a kernel of `mode`) over g.tiles tiles: one tile a block
// where the card holds that many blocks at once, else as many blocks as
// it holds, each walking a span of tiles.
cudaError_t launch(void (*kern)(Args), int mode, const Args& g, size_t smem,
                   cudaStream_t s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long most = 0;
  err = resident_blocks(kern, dev, smem, smem_bytes(mode, MAX_SAMPLES),
                        &most);
  if (err != cudaSuccess) return err;
  const long long grid = g.tiles < most ? g.tiles : most;
  kern<<<(unsigned)grid, THREADS, smem, s>>>(g);
  return cudaGetLastError();
}

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
  if (cap < 1 || n < 0 || mode < COUNT || mode > STARTS ||
      (mode == WINDOW && (k < 1 || k > MAX_K))) {
    return (int)cudaErrorInvalidValue;
  }
  // the sampled index: every S-th lane, the least S = 2^seg that keeps
  // it within MAX_SAMPLES samples
  int seg = 0;
  while ((((long long)cap + (1LL << seg) - 1) >> seg) > MAX_SAMPLES) ++seg;
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
  g.tiles = (n + own_rows(mode) - 1) / own_rows(mode);
  g.L = L;
  g.cap = cap;
  g.Lcap = Lcap;
  g.W = L < Lcap ? L : Lcap;
  g.k = k;
  g.words = L % 4 == 0 && Lcap % 4 == 0 && aligned(mat, 4) &&
            aligned(tab_mat, 4);
  g.seg = seg;
  g.samples = (int)(((long long)cap + (1LL << seg) - 1) >> seg);
  g.samples_p2 = 1;
  while (g.samples_p2 < g.samples) g.samples_p2 <<= 1;
  g.vec = (seg == 2 || seg == 3) && cap % (1 << seg) == 0 &&
          aligned(tab_h1, 16);
  if (mode == STARTS) {
    if (n == 0) return (int)cudaGetLastError();
    return (int)launch(run_starts, mode, g, smem_bytes(mode, 0), s);
  }
  cudaError_t err = cudaMemsetAsync(n_miss, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  const bool l8 = L == 8 && Lcap % 8 == 0 && aligned(mat, 8) &&
                  aligned(tab_mat, 8);
  const size_t smem = smem_bytes(mode, g.samples_p2);
  void (*kern)(Args);
  if (mode == WINDOW) {
    kern = l8 ? probe_rows<WINDOW, true> : probe_rows<WINDOW, false>;
  } else if (mode == KEYS) {
    kern = l8 ? probe_rows<KEYS, true> : probe_rows<KEYS, false>;
  } else {
    kern = l8 ? probe_rows<COUNT, true> : probe_rows<COUNT, false>;
  }
  return (int)launch(kern, mode, g, smem, s);
}
