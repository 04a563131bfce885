// Open-addressing group placement for the hash GROUP BY.
//
// Replaces galaxysql_tpu/kernels/pallas_agg.py `hash_place` (body
// `_make_place_kernel`), whose oracle is relational.py `_hash_place`.  Rounds
// r < max_rounds, each gated on an on-device count of unresolved rows:
//   1. snapshot: occ[s] = slot s owned at round start;
//   2. elect: every unresolved row probing slot (s0 + r * step) & (M - 1) that was
//      empty at round start bids its row id with atomicMin -- the reference's
//      scatter-min on row index, so the lowest row id wins;
//   3. adopt: every unresolved row whose identity lanes (data and valid) equal the
//      slot owner's takes the slot as its group id and decrements the counter.
// The snapshot is what keeps a bid from displacing an owner elected in an earlier
// round (a row may probe a slot claimed earlier in THIS round and must still bid
// and lose); pallas_agg.py explains why the round structure must stay.  Every launch
// returns at once when the counter is 0, so the round loop never waits on the host.
//
// Bound: memory.  A round reads the row's s0/step (16 bytes), its resolved byte
// and, for unresolved rows, the owner's and its own identity lanes; it touches the
// slot table (4 bytes per slot, plus the 1-byte snapshot).  Design: three
// grid-stride launches per round on the caller's stream, native uint64 probe
// arithmetic, one thread per row or slot.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LANES 8

struct IdentLanes {
  const void* data[MAX_LANES];
  const uint8_t* valid[MAX_LANES];  // nullptr: lane has no NULLs
  int wide[MAX_LANES];              // 1: int64 lane, 0: int32 lane
  int k;
};

__device__ __forceinline__ int32_t pending(const int32_t* unres) {
  return *(volatile const int32_t*)unres;
}

__device__ __forceinline__ int32_t slot_of(const int64_t* s0, const int64_t* step,
                                           int64_t i, uint64_t r, uint64_t mask) {
  return (int32_t)(((uint64_t)s0[i] + r * (uint64_t)step[i]) & mask);
}

__device__ __forceinline__ bool same_key(const IdentLanes& L, int64_t a, int64_t b) {
  for (int j = 0; j < L.k; ++j) {
    if (L.wide[j]) {
      const int64_t* d = (const int64_t*)L.data[j];
      if (d[a] != d[b]) return false;
    } else {
      const int32_t* d = (const int32_t*)L.data[j];
      if (d[a] != d[b]) return false;
    }
    if (L.valid[j] != nullptr && L.valid[j][a] != L.valid[j][b]) return false;
  }
  return true;
}

__global__ void init_slots_kernel(int32_t* __restrict__ rep, int64_t M, int32_t sentinel) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < M; s += stride)
    rep[s] = sentinel;
}

__global__ void init_rows_kernel(const uint8_t* __restrict__ live,
                                 uint8_t* __restrict__ resolved, int32_t* __restrict__ gid,
                                 int32_t* __restrict__ unres, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const bool l = live[i] != 0;
    resolved[i] = l ? 0 : 1;
    gid[i] = 0;
    const unsigned active = __activemask();
    const unsigned votes = __ballot_sync(active, l);
    if ((threadIdx.x & 31) == __ffs(active) - 1 && votes != 0)
      atomicAdd(unres, __popc(votes));
  }
}

__global__ void snapshot_kernel(const int32_t* __restrict__ rep, uint8_t* __restrict__ occ,
                                int64_t M, int32_t sentinel, const int32_t* unres) {
  if (pending(unres) == 0) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < M; s += stride)
    occ[s] = rep[s] != sentinel;
}

__global__ void elect_kernel(const uint8_t* __restrict__ resolved,
                             const int64_t* __restrict__ s0, const int64_t* __restrict__ step,
                             const uint8_t* __restrict__ occ, int32_t* __restrict__ rep,
                             int64_t n, uint64_t r, uint64_t mask, const int32_t* unres) {
  if (pending(unres) == 0) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (resolved[i]) continue;
    const int32_t s = slot_of(s0, step, i, r, mask);
    if (!occ[s]) atomicMin(&rep[s], (int32_t)i);
  }
}

__global__ void adopt_kernel(IdentLanes L, uint8_t* __restrict__ resolved,
                             int32_t* __restrict__ gid, const int64_t* __restrict__ s0,
                             const int64_t* __restrict__ step, const int32_t* __restrict__ rep,
                             int32_t* unres, int64_t n, uint64_t r, uint64_t mask,
                             int32_t sentinel) {
  if (pending(unres) == 0) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (resolved[i]) continue;
    const int32_t s = slot_of(s0, step, i, r, mask);
    const int32_t owner = rep[s];
    if (owner != sentinel && same_key(L, owner, i)) {
      resolved[i] = 1;
      gid[i] = s;
      atomicSub(unres, 1);
    }
  }
}

static unsigned grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// Outputs rep[M] (int32), resolved[n] (bool bytes), gid[n] (int32); scratch occ[M]
// (bytes) and unres[1] (int32), all allocated by the caller.  s0 and step hold the
// uint64 probe walk as int64 bits.
extern "C" int gx_hash_place(int device, const void* const* data, const void* const* valid,
                             const int* wide, int k, const void* live, const void* s0,
                             const void* step, void* rep, void* resolved, void* gid,
                             void* occ, void* unres, long long n, long long M,
                             int max_rounds, void* stream) {
  if (k < 1 || k > MAX_LANES || M < 1 || M > (1LL << 30) || n < 0 || n > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  IdentLanes L;
  for (int j = 0; j < MAX_LANES; ++j) {
    L.data[j] = j < k ? data[j] : nullptr;
    L.valid[j] = j < k ? (const uint8_t*)valid[j] : nullptr;
    L.wide[j] = j < k ? wide[j] : 0;
  }
  L.k = k;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t sentinel = (int32_t)n;
  const uint64_t mask = (uint64_t)(M - 1);
  const int threads = 256;
  err = cudaMemsetAsync(unres, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  init_slots_kernel<<<grid_for(M, threads), threads, 0, st>>>((int32_t*)rep, M, sentinel);
  if (n > 0) {
    init_rows_kernel<<<grid_for(n, threads), threads, 0, st>>>(
        (const uint8_t*)live, (uint8_t*)resolved, (int32_t*)gid, (int32_t*)unres, n);
    for (int r = 0; r < max_rounds; ++r) {
      snapshot_kernel<<<grid_for(M, threads), threads, 0, st>>>(
          (const int32_t*)rep, (uint8_t*)occ, M, sentinel, (const int32_t*)unres);
      elect_kernel<<<grid_for(n, threads), threads, 0, st>>>(
          (const uint8_t*)resolved, (const int64_t*)s0, (const int64_t*)step,
          (const uint8_t*)occ, (int32_t*)rep, n, (uint64_t)r, mask, (const int32_t*)unres);
      adopt_kernel<<<grid_for(n, threads), threads, 0, st>>>(
          L, (uint8_t*)resolved, (int32_t*)gid, (const int64_t*)s0, (const int64_t*)step,
          (const int32_t*)rep, (int32_t*)unres, n, (uint64_t)r, mask, sentinel);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
