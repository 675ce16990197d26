// k2pow, the proof of work that gates a PoST proof, one thread per nonce
// or witness:
//
//   pow_hash(challenge, node_id, nonce) = SHA-256(challenge || node_id
//                                                 || le64(nonce))
//   valid <=> pow_hash < difficulty       (256-bit big-endian compare)
//
// The 72-byte message is two blocks: challenge || node_id, then le64(nonce)
// with the FIPS padding, which is built in registers.
//
//   search: the prover's scan of nonces base, base+1, ..: block 1 is one
//           midstate shared by every nonce (passed by value), so each
//           nonce is one compression and the compare; out is the (B,) hit
//           mask. Replaces the XLA program of
//           spacemesh_tpu/ops/pow.py::pow_hash_batch_jit (and
//           below_target_jit), which has no Pallas kernel.
//   verify: the verification farm's batch of witnesses, each with its own
//           challenge, node and difficulty: two compressions and the
//           compare per item; out is the (B,) verdict mask. Replaces
//           spacemesh_tpu/ops/pow.py::pow_verify_batch_jit (XLA, no
//           Pallas kernel).
//
// Bound: about 1300 integer operations per compression against 1 byte
// written per nonce (search) or 105 bytes moved per witness (verify): the
// instruction rate bounds both. The compress chain is serial within a
// thread, so what fills the card is the number of threads: a search batch
// of 2^16 nonces is 2048 warps; a farm batch of 64 witnesses is two, and
// launch latency sets its time.

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
