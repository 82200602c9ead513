// Segmented fold over hash-sorted records, single pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel dampr_tpu/ops/pallas_segfold.py::segfold_sorted
// (kernel built in _build_kernel, launched by _segfold_call) and, in the
// token fold, everything dampr_tpu/ops/lower.py::_token_fold_jit does after
// its sort (lower.py:140-180: the adj_new/cumsum/cummax chain, the
// representatives and the collision check).  For records in sorted order,
// a segment being a maximal run of equal keys:
//
//   tot[j]  = sum of v over the segment that ends at j, 0 where j is no end
//   live[j] = end(j) && inv[j] == 0
//   sp(j)   = the position of the first record of j's segment
//
// Two entries, one kernel (MODE, a template flag):
//   CONTRACT      segfold_sorted's own contract: int32 lanes h1, h2, v, inv
//                 already sorted by (inv, h1, h2); writes tot and live.
//   GATHER[_DEDUP] the token fold's whole stage after its sort: perm (int64,
//                 the sorting permutation), shigh = the sorted high keys,
//                 low = the unsorted low keys (both as csrc/fnv.cu writes
//                 them, in the packing of csrc/sort_keys.cuh, with the line
//                 under dedup) and the token rows (mat uint8 [N, L], lens
//                 int32 [N]).  Each record
//                 gathers low[perm[j]] and derives v itself: 1 for a valid
//                 record, under dedup only for the first of its
//                 (token, line) run.  Besides tot and live it writes the
//                 sorted lanes sh1, sh2, each position's representative
//                 rep[j] = perm[sp(j)] (int32), and the count of valid
//                 records whose row (length and all L bytes) differs from
//                 their representative's: the byte-exact collision check.
//
// Bound on the card: bytes.  CONTRACT reads 16N and writes 5N.  GATHER
// reads 28N + N*L (perm, shigh, low, lens, mat) and writes 17N (sh1, sh2,
// tot, live, rep): 13.9 MB at the main path's N = 2^18, L = 8, 4.2 us at
// 3.35 TB/s.
//
// Design: a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016).
// - The operator on (f, v, p) is (f1, a, p1) + (f2, b, p2) =
//   (f1 | f2, f2 ? b : a + b, f2 ? p2 : p1), f set where a segment starts
//   and p its position; (0, 0, 0) is the identity.  The inclusive scan
//   gives tot (its v at segment ends) and sp (its p) at once.
// - Tiles of 512 records (128 threads x 4), so N = 2^18 makes 512 tiles,
//   about four blocks per SM.  A block takes its tile id from an atomic
//   counter, not blockIdx: Hopper does not start blocks in index order,
//   and a tile must never wait on one that has not started.
// - Each thread loads its 4 consecutive records with 16-byte vector loads
//   (when every pointer is 16-byte aligned; scalar loads otherwise).  The
//   neighbours j-1 and j+1 of a thread's records come from the adjacent
//   threads through shared memory; only the tile's two halo records are
//   read again from global memory.
// - GATHER keeps the tile's perm in shared memory, so a representative
//   inside the tile costs no global read; the one before the tile (the
//   carry's start) is read once per tile.  A record reads its row and its
//   representative's only when they are different rows, and collisions,
//   which are rare, count with one atomic add per thread that saw any.
// - Each tile publishes, in one 64-bit status word per tile, its aggregate
//   and then its inclusive prefix: 2 status bits, f, 30 bits of p, 31 of v.
//   A tile that holds a segment start publishes its prefix at once (the
//   aggregate is the prefix).  Warp 0 looks back over 32 predecessors at a
//   time and stops at the first that is a prefix or holds a segment start;
//   a tile whose first record starts a segment needs no carry and looks
//   back only to publish its prefix, and then not at all.
// - The status words, the tile counter and the collision count live in
//   the caller's per-call output buffer and are zeroed by cudaMemsetAsync
//   on the caller's stream in the same C call, so concurrent streams never
//   share them.
//
// Exactness: the reference's nonneg contract holds here too: values are
// >= 0 and their global sum fits int32, so every partial sum fits the
// status word's 31 bits and the int32 arithmetic is exact.  N <= 2^30 (p's
// 30 bits); the wrapper checks it.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_keys.cuh"

namespace {

// TILE must equal dampr_tpu_torch/ops/segfold.py::_TILE (scratch sizing).
constexpr int THREADS = 128;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;

enum Mode { CONTRACT = 0, GATHER = 1, GATHER_DEDUP = 2 };

typedef unsigned long long u64;

struct Seg {
  int f;
  int v;
  int p;
};

struct SegOp {
  __device__ __forceinline__ Seg operator()(const Seg& a, const Seg& b) const {
    Seg r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : a.v + b.v;
    r.p = b.f ? b.p : a.p;
    return r;
  }
};

constexpr u64 ST_INVALID = 0;
constexpr u64 ST_AGG = 1;
constexpr u64 ST_PREFIX = 2;

__device__ __forceinline__ u64 pack(u64 status, const Seg& s) {
  return (status << 62) | ((u64)(s.f & 1) << 61) |
         ((u64)((unsigned)s.p & 0x3FFFFFFFu) << 31) |
         (u64)((unsigned)s.v & 0x7FFFFFFFu);
}

__device__ __forceinline__ Seg unpack(u64 w) {
  Seg s;
  s.f = (int)((w >> 61) & 1);
  s.p = (int)((w >> 31) & 0x3FFFFFFFu);
  s.v = (int)(w & 0x7FFFFFFFu);
  return s;
}

__device__ __forceinline__ void publish(u64* status, int tile, u64 st,
                                        const Seg& s) {
  *reinterpret_cast<volatile u64*>(status + tile) = pack(st, s);
}

struct Args {
  const void* a;  // CONTRACT: h1     GATHER: perm (int64)
  const void* b;  // CONTRACT: h2     GATHER: shigh (int64)
  const void* c;  // CONTRACT: v      GATHER: low (int64)
  const void* d;  // CONTRACT: inv    GATHER: lens (int32)
  const uint8_t* mat;  // GATHER: the token rows, L bytes each
  long long n;
  int L;
  bool words;  // GATHER: rows compare as 32-bit words (L % 4, base % 4)
  int32_t* tot;
  uint8_t* live;
  int32_t* sh1;  // GATHER only, as are sh2 and rep
  int32_t* sh2;
  int32_t* rep;
  int* counter;
  unsigned long long* collisions;
  u64* status;
};

// The two sort keys of record j (csrc/sort_keys.cuh; CONTRACT packs its
// lanes the same way, with no line); for GATHER also the record's row,
// idx = perm[j].
template <int MODE>
__device__ __forceinline__ void load_one(const Args& g, long long j, u64& hi,
                                         u64& lo, long long& idx) {
  if (MODE == CONTRACT) {
    hi = sort_keys::high(static_cast<const uint32_t*>(g.a)[j],
                         static_cast<const uint32_t*>(g.d)[j]);
    lo = sort_keys::low(static_cast<const uint32_t*>(g.b)[j], 0, false);
    idx = j;
  } else {
    idx = static_cast<const long long*>(g.a)[j];
    hi = static_cast<const u64*>(g.b)[j];
    lo = static_cast<const u64*>(g.c)[idx];
  }
}

template <int MODE>
__device__ __forceinline__ bool starts_after(u64 hi, u64 lo, u64 phi,
                                             u64 plo) {
  constexpr bool dedup = MODE == GATHER_DEDUP;
  return hi != phi || sort_keys::u2(lo, dedup) != sort_keys::u2(plo, dedup);
}

// Rows a and b of the token matrix are equal: same length, same L bytes.
__device__ __forceinline__ bool same_row(const Args& g, long long a,
                                         long long b) {
  if (a == b) return true;
  const int32_t* lens = static_cast<const int32_t*>(g.d);
  if (lens[a] != lens[b]) return false;
  const uint8_t* pa = g.mat + a * g.L;
  const uint8_t* pb = g.mat + b * g.L;
  if (g.words) {
    for (int c = 0; c < g.L; c += 4) {
      if (*reinterpret_cast<const uint32_t*>(pa + c) !=
          *reinterpret_cast<const uint32_t*>(pb + c))
        return false;
    }
  } else {
    for (int c = 0; c < g.L; ++c) {
      if (pa[c] != pb[c]) return false;
    }
  }
  return true;
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS) segscan(Args g) {
  typedef cub::BlockScan<Seg, THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ u64 prev_hi[THREADS + 1];
  __shared__ u64 prev_lo[THREADS + 1];
  __shared__ int first_start[THREADS + 1];
  __shared__ long long perm_sh[MODE == CONTRACT ? 1 : TILE];
  __shared__ int tile_sh;
  __shared__ Seg carry_sh;
  __shared__ long long carry_rep_sh;

  const int t = threadIdx.x;
  const long long n = g.n;
  if (t == 0) tile_sh = atomicAdd(g.counter, 1);
  __syncthreads();
  const int tile = tile_sh;
  const long long j0 = (long long)tile * TILE;
  const long long jt = j0 + (long long)t * ITEMS;
  const bool full = jt + ITEMS <= n;

  u64 hi[ITEMS], lo[ITEMS];
  long long idx[ITEMS];
  int v[ITEMS];
  if (VEC && full) {
    if (MODE == CONTRACT) {
      const int4 a = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(g.a) + jt);
      const int4 b = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(g.b) + jt);
      const int4 c = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(g.c) + jt);
      const int4 d = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(g.d) + jt);
      const int av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      const int cv[4] = {c.x, c.y, c.z, c.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        hi[k] = sort_keys::high((uint32_t)av[k], (uint32_t)dv[k]);
        lo[k] = sort_keys::low((uint32_t)bv[k], 0, false);
        v[k] = cv[k];
        idx[k] = jt + k;
      }
    } else {
      const longlong2* pa = reinterpret_cast<const longlong2*>(
          static_cast<const long long*>(g.a) + jt);
      const longlong2* pb = reinterpret_cast<const longlong2*>(
          static_cast<const long long*>(g.b) + jt);
      const longlong2 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
      idx[0] = a0.x;
      idx[1] = a0.y;
      idx[2] = a1.x;
      idx[3] = a1.y;
      hi[0] = (u64)b0.x;
      hi[1] = (u64)b0.y;
      hi[2] = (u64)b1.x;
      hi[3] = (u64)b1.y;
      const u64* low = static_cast<const u64*>(g.c);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) lo[k] = low[idx[k]];
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long j = jt + k;
      hi[k] = 0;
      lo[k] = 0;
      idx[k] = 0;
      v[k] = 0;
      if (j < n) {
        load_one<MODE>(g, j, hi[k], lo[k], idx[k]);
        if (MODE == CONTRACT) v[k] = static_cast<const int32_t*>(g.c)[j];
      }
    }
  }

  // Neighbours: each thread's last keys, and the record before the tile.
  prev_hi[t + 1] = hi[ITEMS - 1];
  prev_lo[t + 1] = lo[ITEMS - 1];
  if (t == 0 && j0 > 0) {
    long long unused;
    load_one<MODE>(g, j0 - 1, prev_hi[0], prev_lo[0], unused);
  }
  if (MODE != CONTRACT) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) perm_sh[t * ITEMS + k] = idx[k];
  }
  __syncthreads();

  int f[ITEMS];
  {
    u64 phi = prev_hi[t], plo = prev_lo[t];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long j = jt + k;
      const bool in = j < n;
      f[k] = in && (j == 0 || starts_after<MODE>(hi[k], lo[k], phi, plo));
      if (MODE != CONTRACT) {
        const bool valid = sort_keys::valid(hi[k]);
        const bool first = MODE == GATHER_DEDUP
                               ? (j == 0 || hi[k] != phi || lo[k] != plo)
                               : true;
        v[k] = (in && valid && first) ? 1 : 0;
      }
      phi = hi[k];
      plo = lo[k];
    }
  }
  first_start[t] = f[0];
  if (t == THREADS - 1) {
    // does the record after the tile start a segment?
    const long long je = j0 + TILE;
    int s = 1;
    if (je < n) {
      u64 ehi, elo;
      long long unused;
      load_one<MODE>(g, je, ehi, elo, unused);
      s = starts_after<MODE>(ehi, elo, hi[ITEMS - 1], lo[ITEMS - 1]);
    }
    first_start[THREADS] = s;
  }

  Seg items[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    items[k].f = f[k];
    items[k].v = jt + k < n ? v[k] : 0;
    items[k].p = (int)(jt + k);
  }
  Seg agg;
  Scan(scan_tmp).InclusiveScan(items, items, SegOp(), agg);
  __syncthreads();  // first_start[] complete

  // Publish, then look back for the carry into this tile.
  const bool first_is_start = first_start[0] != 0;
  if (t == 0) {
    Seg id;
    id.f = id.v = id.p = 0;
    carry_sh = id;
    carry_rep_sh = 0;
    if (tile == 0 || agg.f) {
      publish(g.status, tile, ST_PREFIX, agg);
    } else {
      publish(g.status, tile, ST_AGG, agg);
    }
  }
  if (tile > 0 && !first_is_start && t < 32) {
    const int lane = t;
    Seg acc;  // aggregate of the tiles already folded, oldest first
    acc.f = acc.v = acc.p = 0;
    long long base = tile - 1;
    while (true) {
      const long long at = base - lane;
      u64 w;
      while (true) {
        w = at >= 0 ? *reinterpret_cast<volatile u64*>(g.status + at)
                    : (ST_PREFIX << 62);
        if (!__any_sync(0xffffffffu, (w >> 62) == ST_INVALID)) break;
        __nanosleep(64);
      }
      const unsigned stop =
          __ballot_sync(0xffffffffu, (w >> 62) == ST_PREFIX || ((w >> 61) & 1));
      const int last = stop ? __ffs(stop) - 1 : 31;
      Seg s = unpack(w);
      if (lane > last) s.f = s.v = s.p = 0;
      // ordered reduction: higher lanes are older tiles, on the left
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        Seg o;
        o.f = __shfl_down_sync(0xffffffffu, s.f, off);
        o.v = __shfl_down_sync(0xffffffffu, s.v, off);
        o.p = __shfl_down_sync(0xffffffffu, s.p, off);
        if (lane + off < 32) s = SegOp()(o, s);
      }
      acc = SegOp()(s, acc);
      if (stop) break;
      base -= 32;
    }
    if (lane == 0) {
      carry_sh = acc;
      if (!agg.f) publish(g.status, tile, ST_PREFIX, SegOp()(acc, agg));
      // acc.f is set (tile 0 starts a segment), so acc.p is the start of
      // the segment that runs into this tile
      if (MODE != CONTRACT)
        carry_rep_sh = static_cast<const long long*>(g.a)[acc.p];
    }
  }
  __syncthreads();
  const Seg carry = carry_sh;

  int tot[ITEMS];
  uint8_t live[ITEMS];
  int rep[ITEMS];
  unsigned collided = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long j = jt + k;
    const bool next_starts =
        k + 1 < ITEMS ? f[k + 1] != 0 : first_start[t + 1] != 0;
    const bool end = j == n - 1 || next_starts;
    const Seg x = SegOp()(carry, items[k]);
    const bool valid = sort_keys::valid(hi[k]);
    tot[k] = end ? x.v : 0;
    live[k] = (end && valid) ? 1 : 0;
    if (MODE != CONTRACT) {
      rep[k] = (int)(x.p >= j0 ? perm_sh[x.p - j0] : carry_rep_sh);
      if (j < n && valid && !same_row(g, idx[k], rep[k])) ++collided;
    }
  }
  if (MODE != CONTRACT && collided)
    atomicAdd(g.collisions, (unsigned long long)collided);

  if (VEC && full) {
    *reinterpret_cast<int4*>(g.tot + jt) =
        make_int4(tot[0], tot[1], tot[2], tot[3]);
    *reinterpret_cast<uchar4*>(g.live + jt) =
        make_uchar4(live[0], live[1], live[2], live[3]);
    if (MODE != CONTRACT) {
      int a[ITEMS], b[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        a[k] = (int)sort_keys::u1(hi[k]);
        b[k] = (int)sort_keys::u2(lo[k], MODE == GATHER_DEDUP);
      }
      *reinterpret_cast<int4*>(g.sh1 + jt) = make_int4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<int4*>(g.sh2 + jt) = make_int4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<int4*>(g.rep + jt) =
          make_int4(rep[0], rep[1], rep[2], rep[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long j = jt + k;
      if (j >= n) break;
      g.tot[j] = tot[k];
      g.live[j] = live[k];
      if (MODE != CONTRACT) {
        g.sh1[j] = (int)sort_keys::u1(hi[k]);
        g.sh2[j] = (int)sort_keys::u2(lo[k], MODE == GATHER_DEDUP);
        g.rep[j] = rep[k];
      }
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <int MODE>
void launch(const Args& g, unsigned tiles, bool vec, cudaStream_t s) {
  if (vec) {
    segscan<MODE, true><<<tiles, THREADS, 0, s>>>(g);
  } else {
    segscan<MODE, false><<<tiles, THREADS, 0, s>>>(g);
  }
}

}  // namespace

// mode 0 CONTRACT (a..d = h1, h2, v, inv; outputs tot, live), 1 GATHER and
// 2 GATHER_DEDUP (a..d = perm, shigh, low, lens, with mat [n, L]; outputs
// tot, live, sh1, sh2, rep and the collision count).  scratch: 16 +
// 8 * ceil(n / 512) bytes, 8-byte aligned, zeroed here on the stream
// before the launch: the tile counter (bytes 0-3), the collision count
// (uint64, bytes 8-15) and the status words.
extern "C" int dampr_segfold(const void* a, const void* b, const void* c,
                             const void* d, const void* mat, void* tot,
                             void* live, void* sh1, void* sh2, void* rep,
                             void* scratch, long long n, int L, int mode,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 16 + 8 * tiles, s);
  if (err != cudaSuccess) return (int)err;
  Args g;
  g.a = a;
  g.b = b;
  g.c = c;
  g.d = d;
  g.mat = (const uint8_t*)mat;
  g.n = n;
  g.L = L;
  g.words = L % 4 == 0 && (uintptr_t)mat % 4 == 0;
  g.tot = (int32_t*)tot;
  g.live = (uint8_t*)live;
  g.sh1 = (int32_t*)sh1;
  g.sh2 = (int32_t*)sh2;
  g.rep = (int32_t*)rep;
  g.counter = (int*)scratch;
  g.collisions = (unsigned long long*)((char*)scratch + 8);
  g.status = (u64*)((char*)scratch + 16);
  // lens (d) is read per record only by CONTRACT; GATHER reads it by row
  const bool vec = aligned16(a) && aligned16(b) && aligned16(c) &&
                   (mode != CONTRACT || aligned16(d)) && aligned16(tot) &&
                   aligned16(live) && aligned16(sh1) && aligned16(sh2) &&
                   aligned16(rep);
  if (mode == GATHER_DEDUP) {
    launch<GATHER_DEDUP>(g, (unsigned)tiles, vec, s);
  } else if (mode == GATHER) {
    launch<GATHER>(g, (unsigned)tiles, vec, s);
  } else {
    launch<CONTRACT>(g, (unsigned)tiles, vec, s);
  }
  return (int)cudaGetLastError();
}
