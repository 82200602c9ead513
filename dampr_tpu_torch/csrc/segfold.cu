// Segmented fold over hash-sorted records, for Hopper (sm_90a).
//
// Replaces the TPU kernel dampr_tpu/ops/pallas_segfold.py::segfold_sorted
// (kernel built in _build_kernel, launched by _segfold_call) and the
// cumsum/cummax chain of dampr_tpu/ops/lower.py::_token_fold_jit.  For
// records sorted by (inv, h1, h2), with a segment being a maximal run of
// equal (inv, h1, h2):
//
//   tot[j]  = sum of v over the segment that ends at j, 0 where j is no end
//   live[j] = end(j) && inv[j] == 0
//
// Bound on the card: bytes.  It reads four int32 lanes (16*N bytes) and
// writes tot (4*N) and live (N): ~5.5 MB at the main path's N = 2^18,
// about 1.6 us at 3.35 TB/s.
//
// Design.  The TPU kernel walks a sequential grid and carries (previous
// keys, running prefix, segment-start prefix) from tile to tile through
// SMEM, reading one tile ahead to find segment ends.  Hopper blocks run in
// parallel and in no order, so nothing carries between them.  Instead:
//
// - end(j) needs only element j+1, which any block reads directly from
//   global memory; no lookahead view.  The last element is always an end.
// - tot is a segmented inclusive sum under the associative operator
//     (f1, a) + (f2, b) = (f1 | f2, f2 ? b : a + b),
//   with f set where a segment starts.  (0, 0) is its identity.
// - It runs as reduce-then-scan, one launch per phase:
//     1. each block scans its tile and writes the tile's aggregate;
//     2. one block scans the aggregates (exclusive), in chunks with a carry;
//     3. each block scans its tile again, seeded with its carry, and writes
//        tot/live at segment ends.
//   cub::BlockScan is the block-wide building block inside each kernel.
// - Any N: the ragged last tile is masked (masked items are the identity),
//   no padding to a tile multiple is needed.
//
// Exactness: the reference's nonneg contract holds here too: values are
// >= 0 and their global sum fits int32, so every partial sum of a segment
// fits int32 and the int32 arithmetic is exact.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// TILE must equal dampr_tpu_torch/ops/segfold.py::_TILE (scratch sizing).
constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int SCAN_THREADS = 1024;

struct FV {
  int f;
  int v;
};

struct SegOp {
  __device__ __forceinline__ FV operator()(const FV& a, const FV& b) const {
    FV r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : a.v + b.v;
    return r;
  }
};

__device__ __forceinline__ bool is_start(const int32_t* __restrict__ h1,
                                         const int32_t* __restrict__ h2,
                                         const int32_t* __restrict__ inv,
                                         long long j) {
  if (j == 0) return true;
  return h1[j] != h1[j - 1] || h2[j] != h2[j - 1] || inv[j] != inv[j - 1];
}

__device__ __forceinline__ void load_tile(const int32_t* __restrict__ h1,
                                          const int32_t* __restrict__ h2,
                                          const int32_t* __restrict__ v,
                                          const int32_t* __restrict__ inv,
                                          long long n, long long first,
                                          FV (&items)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    long long j = first + k;
    if (j < n) {
      items[k].f = is_start(h1, h2, inv, j) ? 1 : 0;
      items[k].v = v[j];
    } else {
      items[k].f = 0;
      items[k].v = 0;
    }
  }
}

typedef cub::BlockScan<FV, THREADS> TileScan;
typedef cub::BlockScan<FV, SCAN_THREADS> AggScan;

__global__ void __launch_bounds__(THREADS)
    tile_aggregates(const int32_t* __restrict__ h1,
                    const int32_t* __restrict__ h2,
                    const int32_t* __restrict__ v,
                    const int32_t* __restrict__ inv, long long n,
                    FV* __restrict__ agg) {
  __shared__ typename TileScan::TempStorage temp;
  long long first = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  FV items[ITEMS];
  load_tile(h1, h2, v, inv, n, first, items);
  FV total;
  TileScan(temp).InclusiveScan(items, items, SegOp(), total);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    scan_aggregates(const FV* __restrict__ agg, FV* __restrict__ prefix,
                    int nblocks) {
  __shared__ typename AggScan::TempStorage temp;
  FV carry;
  carry.f = 0;
  carry.v = 0;
  const FV zero = carry;
  for (int base = 0; base < nblocks; base += SCAN_THREADS) {
    int i = base + threadIdx.x;
    FV x = i < nblocks ? agg[i] : zero;
    FV ex, total;
    AggScan(temp).ExclusiveScan(x, ex, zero, SegOp(), total);
    if (i < nblocks) prefix[i] = SegOp()(carry, ex);
    carry = SegOp()(carry, total);
    __syncthreads();  // temp is reused by the next chunk's scan
  }
}

__global__ void __launch_bounds__(THREADS)
    tile_totals(const int32_t* __restrict__ h1, const int32_t* __restrict__ h2,
                const int32_t* __restrict__ v, const int32_t* __restrict__ inv,
                long long n, const FV* __restrict__ prefix,
                int32_t* __restrict__ tot, uint8_t* __restrict__ live) {
  __shared__ typename TileScan::TempStorage temp;
  long long first = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  FV items[ITEMS];
  load_tile(h1, h2, v, inv, n, first, items);
  TileScan(temp).InclusiveScan(items, items, SegOp());
  const FV carry = prefix[blockIdx.x];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    long long j = first + k;
    if (j < n) {
      bool end = (j == n - 1) || is_start(h1, h2, inv, j + 1);
      FV g = SegOp()(carry, items[k]);
      tot[j] = end ? g.v : 0;
      live[j] = (end && inv[j] == 0) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int dampr_segfold(const void* h1, const void* h2, const void* v,
                             const void* inv, void* tot, void* live,
                             void* scratch, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = (int)((n + TILE - 1) / TILE);
  FV* agg = (FV*)scratch;
  FV* prefix = agg + nblocks;
  const int32_t* a = (const int32_t*)h1;
  const int32_t* b = (const int32_t*)h2;
  const int32_t* c = (const int32_t*)v;
  const int32_t* d = (const int32_t*)inv;
  tile_aggregates<<<nblocks, THREADS, 0, s>>>(a, b, c, d, n, agg);
  scan_aggregates<<<1, SCAN_THREADS, 0, s>>>(agg, prefix, nblocks);
  tile_totals<<<nblocks, THREADS, 0, s>>>(a, b, c, d, n, prefix,
                                          (int32_t*)tot, (uint8_t*)live);
  return (int)cudaGetLastError();
}
