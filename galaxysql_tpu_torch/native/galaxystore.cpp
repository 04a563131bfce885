// Native storage runtime: host-side hot paths of the DN-analog store.
//
// Reference analog: the galaxyengine DN is C++ (SURVEY.md 2.9); the CN-side runtime
// here keeps the accelerator path in XLA and moves the storage shim's per-row host
// loops (hash routing, MVCC visibility, compaction, bloom filters, checksums) into
// native code.  Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// splitmix64-style finalizer -- MUST match kernels/relational.py::_mix64 and
// meta/catalog.py::_mix64_np so host routing and device repartitioning agree.
static inline uint64_t mix64(uint64_t h) {
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return h;
}

// shard id per key: mix64(key) % nparts
void gx_hash_partition(const int64_t* keys, int32_t* out, size_t n, int32_t nparts) {
    const uint64_t m = (uint64_t)nparts;
    for (size_t i = 0; i < n; i++) {
        out[i] = (int32_t)(mix64((uint64_t)keys[i]) % m);
    }
}

// MVCC visibility: begin/end timestamp lanes, negative = uncommitted (-txn_id)
void gx_visible_mask(const int64_t* begin_ts, const int64_t* end_ts, uint8_t* out,
                     size_t n, int64_t snapshot_ts, int64_t txn_id) {
    const int64_t own = -txn_id;
    for (size_t i = 0; i < n; i++) {
        const int64_t b = begin_ts[i], e = end_ts[i];
        bool ins = (b >= 0 && b <= snapshot_ts) || (txn_id != 0 && b == own);
        bool del = (e >= 0 && e <= snapshot_ts) || (txn_id != 0 && e == own);
        out[i] = (uint8_t)(ins && !del);
    }
}

// ---- bloom filter (runtime-filter plane; reference operator/util/bloomfilter) ----
// Standard 2-probe blocked layout: bits array of u64 words, nwords power of two.

void gx_bloom_build(const int64_t* keys, size_t n, uint64_t* words, size_t nwords) {
    const uint64_t mask = (uint64_t)nwords - 1;
    for (size_t i = 0; i < n; i++) {
        uint64_t h = mix64((uint64_t)keys[i]);
        uint64_t w1 = (h >> 6) & mask;
        uint64_t w2 = (h >> 38) & mask;
        words[w1] |= 1ULL << (h & 63);
        words[w2] |= 1ULL << ((h >> 32) & 63);
    }
}

void gx_bloom_query(const int64_t* keys, size_t n, const uint64_t* words,
                    size_t nwords, uint8_t* out) {
    const uint64_t mask = (uint64_t)nwords - 1;
    for (size_t i = 0; i < n; i++) {
        uint64_t h = mix64((uint64_t)keys[i]);
        uint64_t w1 = (h >> 6) & mask;
        uint64_t w2 = (h >> 38) & mask;
        bool hit = (words[w1] >> (h & 63)) & 1ULL;
        hit = hit && ((words[w2] >> ((h >> 32) & 63)) & 1ULL);
        out[i] = (uint8_t)hit;
    }
}

// ---- vectorized equi-join hot loop ----
// Reference analog: ParallelHashJoinExec.java:131-226 / ConcurrentRawHashTable
// (SURVEY.md §3.3).  Chained hash table over 64-bit key hashes: build links
// rows per slot through a next[] array; probe walks the chain comparing the
// FULL 64-bit hash (slot collisions cost chain hops, hash collisions cost
// duplicate candidate pairs that the caller's exact-key verification filters —
// never correctness).  This is the CPU-backend twin of the XLA formulations in
// kernels/relational.py (TPU keeps sort/searchsorted + CSR: scatters serialize
// there, while this loop is exactly what a scalar core does well).

void gx_join_build(const uint64_t* hashes, const uint8_t* live, size_t nb,
                   int32_t* heads, size_t M, int32_t* next) {
    const uint64_t mask = (uint64_t)M - 1;
    for (size_t i = 0; i < nb; i++) {
        next[i] = -1;
        if (!live[i]) continue;
        size_t s = (size_t)(hashes[i] & mask);
        next[i] = heads[s];
        heads[s] = (int32_t)i;
    }
}

// Emits candidate (build,probe) pairs; returns the TOTAL number of matches.
// If the total exceeds cap only the first cap pairs are written and the caller
// retries with a larger buffer (exact size now known).
size_t gx_join_probe(const uint64_t* hashes, const uint8_t* live, size_t npr,
                     const uint64_t* build_hashes,
                     const int32_t* heads, size_t M, const int32_t* next,
                     int32_t* out_b, int32_t* out_p, size_t cap) {
    const uint64_t mask = (uint64_t)M - 1;
    size_t o = 0;
    for (size_t i = 0; i < npr; i++) {
        if (!live[i]) continue;
        const uint64_t h = hashes[i];
        for (int32_t j = heads[(size_t)(h & mask)]; j >= 0; j = next[j]) {
            if (build_hashes[j] == h) {
                if (o < cap) { out_b[o] = j; out_p[o] = (int32_t)i; }
                o++;
            }
        }
    }
    return o;
}

// Single-int64-key specialization: the chain stores row ids and matching
// compares the KEY LANE itself — exact equality, so the caller skips both the
// hash materialization and the verification pass (the dominant join shape:
// FK/PK equi joins on integer/dictionary-code/date/decimal lanes).

void gx_join_build_k1(const int64_t* keys, const uint8_t* live, size_t nb,
                      int32_t* heads, size_t M, int32_t* next) {
    const uint64_t mask = (uint64_t)M - 1;
    for (size_t i = 0; i < nb; i++) {
        next[i] = -1;
        if (!live[i]) continue;
        size_t s = (size_t)(mix64((uint64_t)keys[i]) & mask);
        next[i] = heads[s];
        heads[s] = (int32_t)i;
    }
}

size_t gx_join_probe_k1(const int64_t* keys, const uint8_t* live, size_t npr,
                        const int64_t* build_keys,
                        const int32_t* heads, size_t M, const int32_t* next,
                        int32_t* out_b, int32_t* out_p, size_t cap) {
    // blocked probe: slots for a block are computed (and their head entries
    // prefetched) before any chain walk — the walk's random L2 misses then
    // overlap instead of serializing on the mix64+load dependency chain
    enum { B = 64 };
    const uint64_t mask = (uint64_t)M - 1;
    uint32_t slot[B];
    size_t o = 0;
    for (size_t base = 0; base < npr; base += B) {
        const size_t hi = (base + B < npr) ? base + B : npr;
        for (size_t i = base; i < hi; i++) {
            // slot computed unconditionally (a dead-row SENTINEL would
            // collide with a real slot at M == 2^32); deadness re-checks
            // live[] in the walk loop
            uint32_t s = (uint32_t)(mix64((uint64_t)keys[i]) & mask);
            slot[i - base] = s;
            if (live[i]) __builtin_prefetch(&heads[s], 0, 1);
        }
        for (size_t i = base; i < hi; i++) {
            if (!live[i]) continue;
            const int64_t k = keys[i];
            for (int32_t j = heads[slot[i - base]]; j >= 0; j = next[j]) {
                if (build_keys[j] == k) {
                    if (o < cap) { out_b[o] = j; out_p[o] = (int32_t)i; }
                    o++;
                }
            }
        }
    }
    return o;
}

// Compact-id probe: iterate a precollected live-row id list instead of
// branching on a sparse live mask (random-pattern live branches mispredict;
// np.nonzero collects ids vectorized, this loop then runs dense).
size_t gx_join_probe_k1_idx(const int64_t* keys, const int32_t* ids,
                            size_t n_ids, const int64_t* build_keys,
                            const int32_t* heads, size_t M,
                            const int32_t* next,
                            int32_t* out_b, int32_t* out_p, size_t cap) {
    enum { B = 64 };
    const uint64_t mask = (uint64_t)M - 1;
    uint32_t slot[B];
    size_t o = 0;
    for (size_t base = 0; base < n_ids; base += B) {
        const size_t hi = (base + B < n_ids) ? base + B : n_ids;
        for (size_t t = base; t < hi; t++) {
            uint32_t s = (uint32_t)(mix64((uint64_t)keys[ids[t]]) & mask);
            slot[t - base] = s;
            __builtin_prefetch(&heads[s], 0, 1);
        }
        for (size_t t = base; t < hi; t++) {
            const int32_t i = ids[t];
            const int64_t k = keys[i];
            for (int32_t j = heads[slot[t - base]]; j >= 0; j = next[j]) {
                if (build_keys[j] == k) {
                    if (o < cap) { out_b[o] = j; out_p[o] = i; }
                    o++;
                }
            }
        }
    }
    return o;
}

// Combined key-lane hashing (the np/jnp hash_columns twin): fold `lane` into
// the running combined hash the same way kernels/relational.py::hash_columns
// does.  first=1 initializes; null slots carry the NULL tag so NULL keys chain
// together (verification decides join semantics).
void gx_hash_combine(uint64_t* h, const int64_t* lane, const uint8_t* valid,
                     size_t n, int32_t first) {
    for (size_t i = 0; i < n; i++) {
        uint64_t l = mix64((uint64_t)lane[i]);
        if (valid && !valid[i]) l = 0xdeadbeefcafebabeULL;
        h[i] = first ? l
                     : mix64(h[i] * 31ULL + l + 0x9e3779b97f4a7c15ULL);
    }
}

// ---- page checksum (persistence integrity; crc32c, software table) ----

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t gx_crc32c(const uint8_t* data, size_t n, uint32_t seed) {
    if (!crc_init_done) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (size_t i = 0; i < n; i++)
        c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---- delta + zigzag varint codec for int64 lanes (cold persistence pages) ----

static inline uint64_t zigzag(int64_t v) { return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63); }
static inline int64_t unzigzag(uint64_t v) { return (int64_t)(v >> 1) ^ -(int64_t)(v & 1); }

// dst must have room for 10*n bytes; returns encoded size
size_t gx_encode_i64(const int64_t* src, size_t n, uint8_t* dst) {
    size_t o = 0;
    int64_t prev = 0;
    for (size_t i = 0; i < n; i++) {
        uint64_t v = zigzag(src[i] - prev);
        prev = src[i];
        while (v >= 0x80) { dst[o++] = (uint8_t)(v | 0x80); v >>= 7; }
        dst[o++] = (uint8_t)v;
    }
    return o;
}

size_t gx_decode_i64(const uint8_t* src, size_t nbytes, int64_t* dst, size_t n) {
    size_t o = 0, i = 0;
    int64_t prev = 0;
    while (i < n && o < nbytes) {
        uint64_t v = 0;
        int shift = 0;
        while (o < nbytes) {
            uint8_t b = src[o++];
            v |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
        }
        prev += unzigzag(v);
        dst[i++] = prev;
    }
    return i;
}

}  // extern "C"
