// Probe -> pair owner map of the CSR hash join: a single-pass segment fill.
//
// Replaces galaxysql_tpu/kernels/pallas_join.py `expand_offsets` (body
// `_make_expand_kernel`: a scatter-max of each non-empty row id at its start, then a
// running max over [0, cap)).  For pair slot j in [0, cap) the result is the largest
// non-empty row i with starts[i] <= j, or 0 if there is none.
//
// Precondition: starts is the exclusive prefix sum of counts (starts[0] == 0,
// starts[i+1] == starts[i] + counts[i]); the only caller,
// galaxysql_tpu_torch/kernels/relational.py `hash_join_probe_csr`, builds it so.
// Then the non-empty segments [start, start + count) tile [0, total) in row order,
// total = starts[npr-1] + counts[npr-1], and:
//   - slot j < total belongs to the last row i with starts[i] <= j (a row sharing
//     its start with later rows is empty, so that row is the segment's owner);
//   - slot j >= total takes the last non-empty row (the reference's running max
//     carries it forward), the last i with starts[i] < total, or 0 if total == 0;
//   - slots at or past cap are not written (a segment straddling cap is clipped).
// So every slot is written once: no zero fill, no atomics, no scan over the output.
//
// Bound: memory.  The function must read starts (8 bytes a probe row; counts only
// for the last row) and write 4 bytes a pair slot.  Design ("merge path"): the rows'
// starts and the slot indices 0..cap-1 are merged (row i before slot j iff
// starts[i] <= j) and each block takes EX_TILE consecutive merge items, so a block
// handles at most EX_TILE rows plus slots however skewed the counts are: a hot row
// with millions of pairs spreads over many blocks, a run of empty rows over few.
// Two warps find the block's two split points by a 32-way search over starts; the
// block marks, in shared memory, each tile row that is the last with its start at
// that start's slot, takes a block-wide running max of the marks (carrying in the
// row before the tile), and writes the tile's slots with coalesced stores.

#include <cuda_runtime.h>
#include <stdint.h>

#define EX_THREADS 256
#define EX_TILE 4096  // merge items (rows + slots) per block
#define EX_WARPS (EX_THREADS / 32)
#define EX_CHUNK (EX_TILE / EX_WARPS)  // slots one warp scans
#define EX_BATCH 4

// First index in [lo, hi) where the monotone predicate turns false (hi if never),
// found by the 32 lanes of one warp together: each step probes 32 points and keeps
// the part between the last true and the first false, 1/33 of the range.
template <class Pred>
__device__ __forceinline__ int64_t warp_partition(int64_t lo, int64_t hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int64_t n = hi - lo;
    const int64_t p = lo + n * (lane + 1) / 33;
    const unsigned yes = __ballot_sync(0xffffffffu, pred(p));
    const int c = __popc(yes);  // lanes 0..c-1 saw true
    const int64_t nlo = c > 0 ? lo + n * c / 33 + 1 : lo;
    hi = c < 32 ? lo + n * (c + 1) / 33 : hi;
    lo = nlo;
  }
  return lo;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ int32_t warp_scan_max(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, y);
  }
  return v;
}

__global__ void __launch_bounds__(EX_THREADS)
segment_fill_kernel(const int64_t* __restrict__ counts, const int64_t* __restrict__ starts,
                    int32_t* __restrict__ p_of, int64_t npr, int64_t cap) {
  __shared__ int32_t mark[EX_TILE];
  __shared__ int64_t split[2];
  __shared__ int32_t tail_row;
  __shared__ int32_t carry_in[EX_WARPS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t d0 = (int64_t)blockIdx.x * EX_TILE;
  const int64_t d1 = min64(d0 + EX_TILE, npr + cap);
  const int64_t total = npr > 0 ? starts[npr - 1] + counts[npr - 1] : 0;

  if (warp < 2) {
    // rows among the first d merge items: the first a where row a does not come
    // before slot d-1-a
    const int64_t d = warp == 0 ? d0 : d1;
    const int64_t a = warp_partition(max64(d - cap, 0), min64(d, npr),
                                     [&](int64_t x) { return starts[x] <= d - 1 - x; });
    if (lane == 0) split[warp] = a;
  } else if (warp == 2) {
    // the tail's row: the last i with starts[i] < total (only tiles that reach it)
    int32_t t = 0;
    if (total < min64(d1, cap)) {
      const int64_t lb = warp_partition(0, npr,
                                        [&](int64_t x) { return starts[x] < total; });
      t = lb > 0 ? (int32_t)(lb - 1) : 0;
    }
    if (lane == 0) tail_row = t;
  }
  __syncthreads();

  const int64_t a0 = split[0], a1 = split[1];
  const int64_t b0 = d0 - a0;
  const int nslots = (int)((d1 - a1) - b0);
  for (int k = threadIdx.x; k < nslots; k += EX_THREADS) mark[k] = -1;
  __syncthreads();
  // each tile row that is the last with its start marks that start's slot; a thread
  // takes EX_BATCH rows at a time so that their loads are in flight together
  for (int64_t i0 = a0 + threadIdx.x; i0 < a1; i0 += EX_BATCH * EX_THREADS) {
    int64_t s[EX_BATCH], next[EX_BATCH];
#pragma unroll
    for (int u = 0; u < EX_BATCH; ++u) {
      const int64_t i = i0 + u * EX_THREADS;
      s[u] = i < a1 ? starts[i] : 0;
      next[u] = i + 1 < a1 ? starts[i + 1] : -1;  // -1: no next row in the tile
    }
#pragma unroll
    for (int u = 0; u < EX_BATCH; ++u) {
      const int64_t i = i0 + u * EX_THREADS;
      const int64_t rel = s[u] - b0;
      if (i < a1 && rel >= 0 && rel < nslots && next[u] != s[u]) mark[rel] = (int32_t)i;
    }
  }
  __syncthreads();

  // running max of the marks: each warp scans its EX_CHUNK slots, 32 at a time
  int32_t carry = -1;
  for (int k = warp * EX_CHUNK + lane; k < (warp + 1) * EX_CHUNK && k - lane < nslots;
       k += 32) {
    int32_t v = warp_scan_max(max(k < nslots ? mark[k] : -1, carry));
    if (k < nslots) mark[k] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) carry_in[warp] = carry;
  __syncthreads();
  if (threadIdx.x == 0) {  // carry into each warp's chunk: the rows before it
    int32_t c = (int32_t)(a0 - 1);
    for (int w = 0; w < EX_WARPS; ++w) {
      const int32_t own = carry_in[w];
      carry_in[w] = c;
      c = max(c, own);
    }
  }
  __syncthreads();
  const int32_t tail = tail_row;
  for (int k = threadIdx.x; k < nslots; k += EX_THREADS) {
    const int64_t j = b0 + k;
    p_of[j] = j >= total ? tail : max(max(mark[k], carry_in[k / EX_CHUNK]), 0);
  }
}

extern "C" int gx_expand_offsets(int device, const void* counts, const void* starts,
                                 void* p_of, long long npr, long long cap, void* stream) {
  if (npr < 0 || cap < 0 || npr > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cap == 0) return 0;
  const long long blocks = (npr + cap + EX_TILE - 1) / EX_TILE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_fill_kernel<<<(unsigned)blocks, EX_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)counts, (const int64_t*)starts, (int32_t*)p_of, npr, cap);
  return (int)cudaGetLastError();
}
