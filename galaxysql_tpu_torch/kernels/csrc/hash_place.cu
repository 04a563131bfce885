// Open-addressing group placement for the hash GROUP BY: one persistent launch.
//
// Replaces galaxysql_tpu/kernels/pallas_agg.py `hash_place` (body
// `_make_place_kernel`), whose oracle is relational.py `_hash_place`.  Rounds
// r < max_rounds, while some row is unresolved; in round r every unresolved row
// probes slot s = (s0 + r * step) & (M - 1):
//   1. elect: the row bids the key (r << 32 | row) with a 64-bit atomicMin on
//      own[s].  An owner elected in an earlier round has the smaller key and is never
//      displaced; a slot empty at the round's start goes to the lowest bidding row
//      id.  That is the reference's occupancy snapshot followed by a scatter-min on
//      row id, with no snapshot pass;
//   2. adopt: the row compares its identity lanes (data and valid) with the slot
//      owner's; if equal it takes s as its group id, else it goes on the next
//      round's worklist.
// pallas_agg.py explains why the round structure must stay.  At the end
// rep[s] = own[s]'s row, or n where the slot stayed empty.
//
// Preconditions (checked by gx_hash_place and the wrapper): M is a power of two up to
// 2^30, n < 2^31 - 1 so row ids and the sentinel n fit the stamp's low 32 bits, and
// max_rounds < 2^31 for its high 32 bits.
//
// Bound: memory on a large input (each row's s0/step, live byte and identity lanes
// read, rep/resolved/gid written), launch and synchronisation latency on a small
// one.  Design: one cooperative launch per call, at most as many blocks as fit on the
// card at once (fewer for a small input), a grid-wide barrier between the phases and
// rounds; every block reads the next round's worklist length after the round's
// barrier, so all leave the loop together.  Round 0 walks every row; later rounds
// walk only the worklist of rows still unresolved, appended with one atomicAdd per
// warp.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MAX_LANES 8
#define PLACE_THREADS 256
#define PLACE_ROWS 4
#define EMPTY_SLOT 0xffffffffffffffffull

struct IdentLanes {
  const void* data[MAX_LANES];
  const uint8_t* valid[MAX_LANES];  // nullptr: lane has no NULLs
  int wide[MAX_LANES];              // 1: int64 lane, 0: int32 lane
  int k;
};

struct PlaceArgs {
  IdentLanes L;
  const uint8_t* live;
  const int64_t* s0;
  const int64_t* step;  // s0 and step: the uint64 probe walk as int64 bits
  int32_t* rep;
  uint8_t* resolved;
  int32_t* gid;
  unsigned long long* own;  // scratch [M]
  int32_t* list[2];         // scratch worklists [n] each
  int32_t* len;             // scratch [max_rounds + 1]: worklist length of each round
  int64_t n, M;
  int max_rounds;
};

__device__ __forceinline__ int32_t slot_of(const PlaceArgs& a, int64_t i, uint64_t r) {
  return (int32_t)(((uint64_t)a.s0[i] + r * (uint64_t)a.step[i]) & (uint64_t)(a.M - 1));
}

// All lanes are read before any is compared, so the loads are in flight together.
__device__ __forceinline__ bool same_key(const IdentLanes& L, int64_t a, int64_t b) {
  bool eq = true;
#pragma unroll
  for (int j = 0; j < MAX_LANES; ++j) {
    if (j < L.k) {
      if (L.wide[j]) {
        const int64_t* d = (const int64_t*)L.data[j];
        eq &= d[a] == d[b];
      } else {
        const int32_t* d = (const int32_t*)L.data[j];
        eq &= d[a] == d[b];
      }
      if (L.valid[j] != nullptr) eq &= L.valid[j][a] == L.valid[j][b];
    }
  }
  return eq;
}

// Row k of round r's walk: every row in round 0, else the worklist's k-th entry;
// -1 where there is none (past the end, or a dead row in round 0).
__device__ __forceinline__ int64_t row_at(const PlaceArgs& a, const int32_t* work,
                                          int64_t k, int64_t len) {
  if (k >= len) return -1;
  if (work == nullptr) return a.live[k] ? k : -1;
  return __ldcg(work + k);
}

__global__ void __launch_bounds__(PLACE_THREADS) place_kernel(PlaceArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  for (int64_t s = tid; s < a.M; s += stride) a.own[s] = EMPTY_SLOT;
  for (int64_t i = tid; i < a.n; i += stride) {
    a.resolved[i] = a.live[i] ? 0 : 1;
    a.gid[i] = 0;
  }
  for (int64_t r = tid; r <= a.max_rounds; r += stride) a.len[r] = 0;
  grid.sync();

  const int32_t* work = nullptr;
  int64_t len = a.n;
  for (int r = 0; r < a.max_rounds && len > 0; ++r) {
    const uint64_t rr = (uint64_t)r;
    for (int64_t k = tid; k < len; k += stride) {
      const int64_t i = row_at(a, work, k, len);
      if (i < 0) continue;
      unsigned long long* slot = a.own + slot_of(a, i, rr);
      const unsigned long long bid = (rr << 32) | (uint64_t)i;
      if (__ldcg(slot) > bid) atomicMin(slot, bid);
    }
    grid.sync();
    int32_t* next = a.list[r & 1];
    int32_t* next_len = a.len + r + 1;
    // whole warps walk together, so the append's ballot sees all 32 lanes
    for (int64_t base = tid - lane; base < len; base += stride) {
      const int64_t i = row_at(a, work, base + lane, len);
      bool retry = false;
      if (i >= 0) {
        const int32_t s = slot_of(a, i, rr);
        const int64_t owner = (int64_t)(__ldcg(a.own + s) & 0xffffffffull);
        if (same_key(a.L, owner, i)) {
          a.resolved[i] = 1;
          a.gid[i] = s;
        } else {
          retry = true;
        }
      }
      const unsigned votes = __ballot_sync(0xffffffffu, retry);
      if (votes != 0) {
        const int leader = __ffs(votes) - 1;
        int32_t at = 0;
        if (lane == leader) at = atomicAdd(next_len, __popc(votes));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (retry) next[at + __popc(votes & ((1u << lane) - 1))] = (int32_t)i;
      }
    }
    grid.sync();
    work = next;
    len = __ldcg(next_len);
  }

  for (int64_t s = tid; s < a.M; s += stride) {
    const unsigned long long o = __ldcg(a.own + s);
    a.rep[s] = o == EMPTY_SLOT ? (int32_t)a.n : (int32_t)(o & 0xffffffffull);
  }
}

// Blocks of place_kernel that fit on the card at once, per device (queried once).
static long long resident_blocks(int device) {
  static long long cached[64] = {0};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, place_kernel, PLACE_THREADS, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const long long r = (long long)per_sm * sms;
  if (device >= 0 && device < 64) cached[device] = r;
  return r;
}

// Outputs rep[M] (int32), resolved[n] (bool bytes), gid[n] (int32); scratch of
// 8M + 8n + 4(max_rounds + 1) bytes, 8-byte aligned: own[M] (uint64), two worklists of
// n int32 and the worklist lengths, int32[max_rounds + 1].  All allocated by the caller.
extern "C" int gx_hash_place(int device, const void* const* data, const void* const* valid,
                             const int* wide, int k, const void* live, const void* s0,
                             const void* step, void* rep, void* resolved, void* gid,
                             void* scratch, long long n, long long M, int max_rounds,
                             void* stream) {
  if (k < 1 || k > MAX_LANES || M < 1 || M > (1LL << 30) || n < 0 || n > (1LL << 31) - 2 ||
      max_rounds < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PlaceArgs a;
  for (int j = 0; j < MAX_LANES; ++j) {
    a.L.data[j] = j < k ? data[j] : nullptr;
    a.L.valid[j] = j < k ? (const uint8_t*)valid[j] : nullptr;
    a.L.wide[j] = j < k ? wide[j] : 0;
  }
  a.L.k = k;
  a.live = (const uint8_t*)live;
  a.s0 = (const int64_t*)s0;
  a.step = (const int64_t*)step;
  a.rep = (int32_t*)rep;
  a.resolved = (uint8_t*)resolved;
  a.gid = (int32_t*)gid;
  a.own = (unsigned long long*)scratch;
  a.list[0] = (int32_t*)(a.own + M);
  a.list[1] = a.list[0] + n;
  a.len = a.list[1] + n;
  a.n = n;
  a.M = M;
  a.max_rounds = max_rounds;

  const long long resident = resident_blocks(device);
  if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
  // PLACE_ROWS rows or slots a thread: a small input takes few blocks, which keeps
  // the grid barriers short; a large one all the blocks that fit on the card
  const long long work = n > M ? n : M;
  long long blocks = (work + PLACE_THREADS * PLACE_ROWS - 1) / (PLACE_THREADS * PLACE_ROWS);
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)place_kernel, dim3((unsigned)blocks),
                                    dim3(PLACE_THREADS), params, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
