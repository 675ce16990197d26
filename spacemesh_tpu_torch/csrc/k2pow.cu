// k2pow, the proof of work that gates a PoST proof:
//
//   pow_hash(challenge, node_id, nonce) = SHA-256(challenge || node_id
//                                                 || le64(nonce))
//   valid <=> pow_hash < difficulty       (256-bit big-endian compare)
//
// The 72-byte message is two blocks: challenge || node_id, then le64(nonce)
// with the FIPS padding, which is built in registers.
//
//   window: the prover's search, one launch per window of nonces
//           start .. start+count-1 of one search. It folds the smallest
//           winning nonce into found, a u64 cell on the device that every
//           window of the search shares (UINT64_MAX: none yet), with
//           atomicMin; nothing else is written. Replaces the XLA programs
//           of spacemesh_tpu/ops/pow.py::pow_hash_batch_jit and
//           below_target_jit, which have no Pallas kernel, and the host
//           loop of spacemesh_tpu/ops/pow.py::search over them.
//   search: one thread per nonce of base, base+1, .. against a midstate
//           passed by value; out is the (B,) hit mask. Kept for callers
//           that want every hit of a range (the tests, chip_smoke.py's
//           witnesses); no path of the port launches it.
//   verify: the verification farm's batch of witnesses, each with its own
//           challenge, node and difficulty: two compressions and the
//           compare per item; out is the (B,) verdict mask. Replaces
//           spacemesh_tpu/ops/pow.py::pow_verify_batch_jit (XLA, no
//           Pallas kernel).
//
// Bound: about 1300 integer operations per compression against a few
// bytes per launch (window), 1 byte written per nonce (search) or 105
// bytes moved per witness (verify): the instruction rate bounds all three.
//
// The window's design. Each compression is a serial chain, so a thread
// hashes its nonces one after another and what fills the card is the
// number of threads:
//   - a persistent grid: as many blocks as fit on the 132 SMs at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each thread
//     walking its nonces in a grid-stride loop, so a window of 2^24
//     nonces is one launch at full occupancy;
//   - block 1 on the card: thread 0 of each block compresses the 16 words
//     of challenge || node_id once into shared memory; the host does no
//     SHA-256 work;
//   - early exit: once per nonce a thread reads found (a relaxed load)
//     and stops when its next nonce is above it. Nonces below the current
//     winner are always hashed, so found ends at exactly the smallest hit
//     (the JAX package's serial answer); a window launched behind one
//     that hit exits after that one read;
//   - nonce-invariant work hoisted: message words 2-15 are constants the
//     compiler folds, schedule terms built from them included, and the
//     parts of round 0 that do not involve W0 depend only on the midstate,
//     so each thread computes them once, not once per nonce; the compare
//     decides on digest word 0 and reads the rest only on a tie;
//   - the rounds' adds on the FMA pipe (sha256.cuh's IMAD form), chosen
//     per launch against the plain form so the two can be timed in turns.
// The verify kernel is one thread per witness; at the farm's 64
// witnesses launch latency sets its time.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "sha256.cuh"

constexpr unsigned kMaxThreads = 256;
constexpr uint32_t kBitLen = 72 * 8;

struct Words8 {
    uint32_t w[8];
};

// The second block: le64(nonce) || 0x80 || zeros || be64(bit length).
__device__ __forceinline__ void nonce_block(uint32_t lo, uint32_t hi,
                                            uint32_t* m) {
    m[0] = bswap32(lo);
    m[1] = bswap32(hi);
    m[2] = 0x80000000u;
#pragma unroll
    for (int i = 3; i < 15; ++i) m[i] = 0u;
    m[15] = kBitLen;
}

// digest < target as 256-bit big-endian numbers (8 BE words each): the
// first word that differs decides.
__device__ __forceinline__ bool below(const uint32_t* d, const uint32_t* t) {
    bool lt = false, eq = true;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        lt = lt || (eq && d[i] < t[i]);
        eq = eq && d[i] == t[i];
    }
    return lt;
}

__global__ void __launch_bounds__(kMaxThreads)
search_kernel(Words8 prefix, Words8 target, unsigned long long base,
              uint8_t* __restrict__ out, long long count) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    const unsigned long long nonce = base + (unsigned long long)i;
    uint32_t m[16], st[8];
    nonce_block((uint32_t)nonce, (uint32_t)(nonce >> 32), m);
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = prefix.w[k];
    compress(st, m);
    out[i] = below(st, target.w) ? 1 : 0;
}

__global__ void __launch_bounds__(kMaxThreads)
verify_kernel(const uint32_t* __restrict__ block1,
              const uint32_t* __restrict__ nonce_lo,
              const uint32_t* __restrict__ nonce_hi,
              const uint32_t* __restrict__ target, uint8_t* __restrict__ out,
              long long b) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= b) return;
    uint32_t m[16], st[8], t[8];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = block1[(size_t)k * b + i];
    sha256_iv(st);
    compress(st, m);
    nonce_block(nonce_lo[i], nonce_hi[i], m);
    compress(st, m);
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = target[(size_t)k * b + i];
    out[i] = below(st, t) ? 1 : 0;
}

// A relaxed load of the shared cell: the early exit needs a recent value,
// not an ordered one (atomicMin makes every winner visible eventually).
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
}

constexpr unsigned kWindowThreads = 256;

struct Words16 {
    uint32_t w[16];
};

template <bool kImad>
__global__ void __launch_bounds__(kWindowThreads)
window_kernel(Words16 block1, Words8 target, unsigned long long start,
              unsigned long long count, unsigned long long* found) {
    __shared__ uint32_t mid_s[8];
    if (threadIdx.x == 0) {
        uint32_t st[8];
        sha256_iv(st);
        if (load_relaxed(found) >= start)  // else an earlier window won
            compress<kImad>(st, block1.w);
#pragma unroll
        for (int k = 0; k < 8; ++k) mid_s[k] = st[k];
    }
    __syncthreads();
    uint32_t mid[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) mid[k] = mid_s[k];
    // round 0 without W0: t1 = t1_0 + W0, so a' = a_0 + W0, e' = e_0 + W0
    const uint32_t t1_0 =
        mid[7] +
        (SHA256_ROTR(mid[4], 6) ^ SHA256_ROTR(mid[4], 11) ^
         SHA256_ROTR(mid[4], 25)) +
        ((mid[4] & mid[5]) ^ (~mid[4] & mid[6])) + kSha256K[0];
    const uint32_t t2_0 =
        (SHA256_ROTR(mid[0], 2) ^ SHA256_ROTR(mid[0], 13) ^
         SHA256_ROTR(mid[0], 22)) +
        ((mid[0] & mid[1]) ^ (mid[0] & mid[2]) ^ (mid[1] & mid[2]));
    const uint32_t a_0 = t1_0 + t2_0, e_0 = mid[3] + t1_0;
    const unsigned long long stride =
        (unsigned long long)gridDim.x * kWindowThreads;
    for (unsigned long long i =
             (unsigned long long)blockIdx.x * kWindowThreads + threadIdx.x;
         i < count; i += stride) {
        const unsigned long long nonce = start + i;
        if (nonce > load_relaxed(found)) break;  // a smaller winner exists
        uint32_t w[16];
        nonce_block((uint32_t)nonce, (uint32_t)(nonce >> 32), w);
        uint32_t v[8] = {a_0 + w[0], mid[0], mid[1], mid[2],
                         e_0 + w[0], mid[4], mid[5], mid[6]};
        sha256_rounds<kImad, 1>(v, w);
        const uint32_t d0 = mid[0] + v[0];
        bool hit = d0 < target.w[0];
        if (d0 == target.w[0]) {
            uint32_t d[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) d[k] = mid[k] + v[k];
            hit = below(d, target.w);
        }
        if (hit) atomicMin(found, nonce);
    }
}

__global__ void empty_kernel() {}

// Blocks a window of count nonces launches: the persistent grid, as many
// as are resident at once on every SM, or fewer for a short window.
template <bool kImad>
static unsigned window_grid(unsigned long long count) {
    static unsigned full = 0;
    if (full == 0) {
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_kernel<kImad>, kWindowThreads, 0);
        full = (unsigned)(per_sm > 0 ? per_sm : 1) * sm_count();
    }
    const unsigned long long need =
        (count + kWindowThreads - 1) / kWindowThreads;
    return need < full ? (unsigned)need : full;
}

// block1: the 16 BE words of challenge || node_id; target: 8 BE difficulty
// words; nonces start .. start + count - 1 (the caller keeps them below
// 2^64); found: one u64 on the device, lowered to the smallest winner;
// imad: 1 for the IMAD form of the rounds, 0 for the plain one. Returns
// cudaGetLastError().
extern "C" int k2pow_window_launch(const uint32_t* block1,
                                   const uint32_t* target,
                                   unsigned long long start,
                                   unsigned long long count, void* found,
                                   int imad, void* stream) {
    if (count == 0) return 0;
    Words16 m;
    Words8 t;
    for (int k = 0; k < 16; ++k) m.w[k] = block1[k];
    for (int k = 0; k < 8; ++k) t.w[k] = target[k];
    const unsigned grid =
        imad ? window_grid<true>(count) : window_grid<false>(count);
    auto kernel = imad ? window_kernel<true> : window_kernel<false>;
    kernel<<<grid, kWindowThreads, 0, (cudaStream_t)stream>>>(
        m, t, start, count, (unsigned long long*)found);
    return (int)cudaGetLastError();
}

// Blocks a window of count nonces launches (imad: which form), each of
// which compresses block 1 once: for the bound's count.
extern "C" unsigned k2pow_window_blocks(unsigned long long count, int imad) {
    return imad ? window_grid<true>(count) : window_grid<false>(count);
}

// One launch of an empty kernel: the floor of a launch's time, against
// which the one-thread-per-item kernels at small batches are read.
extern "C" int k2pow_empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// prefix: the 8 midstate words after block 1; target: 8 BE difficulty
// words; out: (count,) bytes, 1 where nonce base + i is below the target.
// Returns cudaGetLastError().
extern "C" int k2pow_search_launch(const uint32_t* prefix,
                                   const uint32_t* target,
                                   unsigned long long base, void* out,
                                   long long count, void* stream) {
    if (count <= 0) return 0;
    Words8 p, t;
    for (int k = 0; k < 8; ++k) {
        p.w[k] = prefix[k];
        t.w[k] = target[k];
    }
    const unsigned block = spread_threads(count, kMaxThreads);
    search_kernel<<<blocks_of(count, block), block, 0,
                    (cudaStream_t)stream>>>(p, t, base, (uint8_t*)out,
                                            count);
    return (int)cudaGetLastError();
}

// block1: (16, B) u32 BE words (challenge || node_id); nonce_lo/nonce_hi:
// (B,) u32; target: (8, B) u32 BE difficulty words; out: (B,) bytes, 1
// where the witness is valid. Returns cudaGetLastError().
extern "C" int k2pow_verify_launch(const void* block1, const void* nonce_lo,
                                   const void* nonce_hi, const void* target,
                                   void* out, long long b, void* stream) {
    if (b <= 0) return 0;
    const unsigned block = spread_threads(b, kMaxThreads);
    verify_kernel<<<blocks_of(b, block), block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)block1, (const uint32_t*)nonce_lo,
        (const uint32_t*)nonce_hi, (const uint32_t*)target, (uint8_t*)out,
        b);
    return (int)cudaGetLastError();
}
