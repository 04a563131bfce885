// Probe -> pair owner map of the CSR hash join.
//
// Replaces galaxysql_tpu/kernels/pallas_join.py `expand_offsets` (body
// `_make_expand_kernel`).  For pair slot j in [0, cap): the probe row whose
// [start, start + count) segment covers j.  Two steps, as in the reference:
//   1. scatter-max of each row id at starts[i], for rows with count > 0 and
//      start < cap (the reference's `.at[].max(mode="drop")` with count-0 rows
//      parked at cap);
//   2. an inclusive running max over [0, cap) (the reference's `lax.cummax`).
// starts are unique among non-empty rows, so the result is bit-identical however
// the atomics interleave.
//
// Bound: memory.  Step 1 reads 16 bytes per probe row and does one 4-byte atomic
// per non-empty row; step 2 reads and writes 4 bytes per pair slot.  Design: a zero
// fill, a grid-stride atomicMax scatter, then a hand-written two-level max-scan --
// each block scans one tile of 4096 slots with warp shuffles and writes the tile's
// max; one block scans the tile maxima; a last pass folds each tile's carry in.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 1024
#define SCAN_ITEMS 4
#define SCAN_TILE (SCAN_THREADS * SCAN_ITEMS)

__global__ void scatter_kernel(const int64_t* __restrict__ counts,
                               const int64_t* __restrict__ starts,
                               int32_t* __restrict__ p_of, int64_t npr, int64_t cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < npr; i += stride) {
    if (counts[i] > 0) {
      const int64_t s = starts[i];
      if (s >= 0 && s < cap) atomicMax(&p_of[s], (int32_t)i);
    }
  }
}

// Inclusive max-scan within one warp (values are >= 0, so 0 is the identity).
__device__ __forceinline__ int32_t warp_scan_max(int32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, y);
  }
  return v;
}

// Inclusive max-scan of the thread totals of one 1024-thread block: returns the
// max over all threads before this one (0 for thread 0); *block_total receives the
// max over the whole block.
__device__ __forceinline__ int32_t block_exclusive_max(int32_t total, int32_t* warp_tot,
                                                       int32_t* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t incl = warp_scan_max(total);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_tot[lane] = warp_scan_max(warp_tot[lane]);
  __syncthreads();
  int32_t before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0;
  if (warp > 0) before = max(before, warp_tot[warp - 1]);
  *block_total = warp_tot[31];
  return before;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles_kernel(int32_t* __restrict__ x, int64_t n, int32_t* __restrict__ tile_max) {
  __shared__ int32_t warp_tot[32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
  int32_t v[SCAN_ITEMS];
  int32_t run = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t j = base + k;
    run = max(run, j < n ? x[j] : 0);
    v[k] = run;
  }
  int32_t total;
  const int32_t before = block_exclusive_max(run, warp_tot, &total);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t j = base + k;
    if (j < n) x[j] = max(v[k], before);
  }
  if (threadIdx.x == 0) tile_max[blockIdx.x] = total;
}

// One block: inclusive max-scan of the tile maxima, a chunk of 1024 at a time.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_carry_kernel(int32_t* __restrict__ t, int64_t nt) {
  __shared__ int32_t warp_tot[32];
  int32_t carry = 0;
  for (int64_t base = 0; base < nt; base += SCAN_THREADS) {
    const int64_t j = base + threadIdx.x;
    const int32_t e = j < nt ? t[j] : 0;
    int32_t total;
    const int32_t before = block_exclusive_max(e, warp_tot, &total);
    if (j < nt) t[j] = max(max(e, before), carry);
    carry = max(carry, total);
    __syncthreads();  // warp_tot is reused by the next chunk
  }
}

__global__ void add_carry_kernel(int32_t* __restrict__ x, int64_t n,
                                 const int32_t* __restrict__ tile_scan) {
  if (blockIdx.x == 0) return;
  const int32_t c = tile_scan[blockIdx.x - 1];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  for (int k = threadIdx.x; k < SCAN_TILE; k += blockDim.x) {
    const int64_t j = base + k;
    if (j < n) x[j] = max(x[j], c);
  }
}

// tile_max: scratch of ceil(cap / 4096) int32, allocated by the caller.
extern "C" int gx_expand_offsets(int device, const void* counts, const void* starts,
                                 void* p_of, void* tile_max, long long npr, long long cap,
                                 void* stream) {
  if (npr < 0 || cap < 0 || npr > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cap == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(p_of, 0, (size_t)cap * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (npr > 0) {
    long long blocks = (npr + 255) / 256;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    scatter_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        (const int64_t*)counts, (const int64_t*)starts, (int32_t*)p_of, npr, cap);
  }
  const long long nt = (cap + SCAN_TILE - 1) / SCAN_TILE;
  scan_tiles_kernel<<<(unsigned)nt, SCAN_THREADS, 0, s>>>((int32_t*)p_of, cap,
                                                          (int32_t*)tile_max);
  if (nt > 1) {
    scan_carry_kernel<<<1, SCAN_THREADS, 0, s>>>((int32_t*)tile_max, nt);
    add_carry_kernel<<<(unsigned)nt, 256, 0, s>>>((int32_t*)p_of, cap,
                                                   (const int32_t*)tile_max);
  }
  return (int)cudaGetLastError();
}
