// Slot hashing for the CSR hash join: build rows (with a live mask) and probe rows.
//
// Replaces galaxysql_tpu/kernels/pallas_join.py `build_slots` and `hash_slots`
// (one Pallas body, `_make_slots_kernel`, with masked=True / masked=False).
// Per row: the `hash_columns` mix over up to 8 key lanes -- SplitMix64 per lane,
// NULL lanes replaced by the tag 0xDEADBEEFCAFEBABE, lanes combined as
// mix(h * 31 + lane + GOLDEN) -- then `h & (M - 1)` as an int32 slot.  The build
// variant parks dead rows at slot M, the CSR's drop segment.
//
// Bound: memory.  Each row reads its key lanes (4 or 8 bytes each, plus a valid
// byte per nullable lane and the live byte) and writes 4 bytes; the hash is a few
// dozen integer operations, far below the card's integer rate.  Design: one thread
// per row in a grid-stride loop, native uint64 arithmetic, neighbouring threads on
// neighbouring rows so every lane is read coalesced.  Lanes arrive as int32 or
// int64; an int32 lane is sign-extended before the mix, as the reference's
// `astype(uint64)` does.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LANES 8

struct KeyLanes {
  const void* data[MAX_LANES];
  const uint8_t* valid[MAX_LANES];  // nullptr: lane has no NULLs
  int wide[MAX_LANES];              // 1: int64 lane, 0: int32 lane
  int k;
};

__device__ __forceinline__ uint64_t mix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

__global__ void slots_kernel(KeyLanes keys, const uint8_t* __restrict__ live,
                             int32_t* __restrict__ out, int64_t n, uint64_t mask,
                             int32_t dead_slot) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint64_t h = 0;
    for (int j = 0; j < keys.k; ++j) {
      const uint64_t x = keys.wide[j]
          ? (uint64_t)((const int64_t*)keys.data[j])[i]
          : (uint64_t)(int64_t)((const int32_t*)keys.data[j])[i];
      uint64_t lane = mix64(x);
      if (keys.valid[j] != nullptr && !keys.valid[j][i]) lane = 0xDEADBEEFCAFEBABEULL;
      h = (j == 0) ? lane : mix64(h * 31ULL + lane + 0x9e3779b97f4a7c15ULL);
    }
    int32_t s = (int32_t)(h & mask);
    if (live != nullptr && !live[i]) s = dead_slot;
    out[i] = s;
  }
}

// live == nullptr: probe variant (no dead-row parking).
extern "C" int gx_join_slots(int device, const void* const* data, const void* const* valid,
                             const int* wide, int k, const void* live, void* out,
                             long long n, long long M, void* stream) {
  if (k < 1 || k > MAX_LANES || M < 1 || M > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  KeyLanes keys;
  for (int j = 0; j < MAX_LANES; ++j) {
    keys.data[j] = j < k ? data[j] : nullptr;
    keys.valid[j] = j < k ? (const uint8_t*)valid[j] : nullptr;
    keys.wide[j] = j < k ? wide[j] : 0;
  }
  keys.k = k;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  slots_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      keys, (const uint8_t*)live, (int32_t*)out, (int64_t)n, (uint64_t)(M - 1),
      (int32_t)M);
  return (int)cudaGetLastError();
}
