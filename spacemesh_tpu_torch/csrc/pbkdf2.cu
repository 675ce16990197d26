// PBKDF2-HMAC-SHA256 envelope of scrypt (N, r=1, p=1, dklen=16) labels:
// the expansion before ROMix and the finish after it.
//
// Replaces the envelope that spacemesh_tpu/ops/scrypt.py::_labels_fused
// compiles into one XLA program around the Pallas ROMix kernel (expand ->
// ROMix -> finish, "PBKDF2/HMAC block state stays on device"); the JAX
// package has no Pallas kernel for it. Both entry points start from the
// raw 32-byte commitment (password), shared by every lane (word stride 1,
// lane stride 0) or one per lane (word stride B, lane stride 1):
//
//   expand: salt = le64(index); for i in 1..4:
//           T_i = HMAC(pw, salt || be32(i)); out = T_1..T_4 as (32, B) LE
//   finish: HMAC(pw, B' || be32(1)) over the 128-byte ROMix output B',
//           the first 4 big-endian digest words -> (4, B)
//   finish + hash (kHash): finish, then the PoST proving hash of each
//           lane's label as its epilogue: one Salsa20/8 over
//           challenge(8 LE words) || nonce || idx_lo || idx_hi || 0 ||
//           label(4 LE words) -> x0 + challenge[0], (B,). The verifier's
//           recompute; replaces the standalone proving-hash launch
//           (proving_scan.cu's hash_kernel, XLA's proving_hash_jit in the
//           JAX package) on that path.
//
// Bound: 8 compressions per lane in expand and 4 in finish, plus the HMAC
// midstates' 2 once per commitment (about 1300 integer operations each),
// against at most 176 bytes of device traffic per lane: the operations
// bound both, about a hundredth of a millisecond at 32768 lanes.
//
// Design. Each compression is a chain of 64 dependent rounds, so what
// holds a lane back is the length of its chain, and what fills the card
// is the number of chains in flight:
//   - expand runs a quad of threads per lane: thread q computes T_{q+1}
//     (an inner and an outer compression), four independent chains where
//     one thread ran them in a row;
//   - a shared commitment's midstates are computed once per block, by two
//     threads into shared memory, not once per lane;
//   - in expand, per-lane midstates are split over a pair of threads, each
//     deriving one, in the block's leading warps, and handed to the quad
//     through shared memory, so no thread of the quad repeats them;
//   - finish's chain (three inner blocks, then the outer) is serial by
//     nature, so it keeps one thread per lane; with per-lane keys that
//     thread derives both midstates, two independent compressions that
//     the compiler interleaves, so they cost about one on the chain;
//   - blocks are sized by spread_threads (launch.cuh): four warps or
//     more, spread evenly over the SMs at the verifier's small batches.
//   - the proving hash runs in finish's thread, after the outer
//     compression: the 4 label words are already in its registers, so
//     the hash costs one Salsa20/8 (about 390 instructions against
//     finish's 4 compressions) and no launch of its own; the words are
//     swapped from finish's big-endian to the hash's little-endian in
//     registers, and written out only when the caller asks for them.
// The integer pipe bounds what is left: about three quarters of a
// compression's instructions are rotates and three-input logic, which an
// H100 SM issues at 64 lanes a clock, half the rate the bound assumes.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "salsa.cuh"
#include "sha256.cuh"

constexpr unsigned kMaxThreads = 256;

// Both midstates of the shared key (word stride ws, lane stride 0),
// computed by threads 0 and 1 of the block into shared memory.
__device__ __forceinline__ void block_midstates(const uint32_t* __restrict__ cw,
                                                long long ws, uint32_t* inner,
                                                uint32_t* outer) {
    __shared__ uint32_t mid[16];
    if (threadIdx.x < 2) {
        uint32_t key[8], st[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) key[i] = cw[i * ws];
        hmac_midstate(key, threadIdx.x ? kHmacOpad : kHmacIpad, st);
#pragma unroll
        for (int k = 0; k < 8; ++k) mid[threadIdx.x * 8 + k] = st[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        inner[k] = mid[k];
        outer[k] = mid[8 + k];
    }
}

// Per-lane keys in expand: both midstates of each of the block's `lanes`
// lanes (from lane0 on), derived by a pair of threads per lane in the
// block's first 2 * lanes threads (thread 2i the inner midstate of lane i,
// 2i + 1 the outer), so each midstate is one compression of one thread and
// the warps past them skip the phase; then every thread reads its lane's
// pair (its quad's, `mine`) from shared memory. Rows are 17 words wide:
// the quads that read them hit distinct banks.
__device__ __forceinline__ void lane_midstates(const uint32_t* __restrict__ cw,
                                               long long ws, long long ls,
                                               long long lane0, int lanes,
                                               long long b, int mine,
                                               uint32_t* inner,
                                               uint32_t* outer) {
    __shared__ uint32_t mid[kMaxThreads / 4][17];
    const int t = threadIdx.x;
    if (t < 2 * lanes) {
        long long l = lane0 + (t >> 1);
        if (l >= b) l = b - 1;
        uint32_t key[8], st[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) key[i] = cw[i * ws + l * ls];
        hmac_midstate(key, (t & 1) ? kHmacOpad : kHmacIpad, st);
#pragma unroll
        for (int k = 0; k < 8; ++k) mid[t >> 1][(t & 1) * 8 + k] = st[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        inner[k] = mid[mine][k];
        outer[k] = mid[mine][8 + k];
    }
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
expand_kernel(const uint32_t* __restrict__ cw, long long ws, long long ls,
              const uint32_t* __restrict__ idx_lo,
              const uint32_t* __restrict__ idx_hi, uint32_t* __restrict__ out,
              long long b) {
    // a quad of threads per lane: thread q computes T_{q+1}
    const int lanes = blockDim.x >> 2;
    const long long lane0 = (long long)blockIdx.x * lanes;
    const long long lane = lane0 + (threadIdx.x >> 2);
    const uint32_t q = threadIdx.x & 3;
    uint32_t inner[8], outer[8];
    if (kShared)
        block_midstates(cw, ws, inner, outer);
    else
        lane_midstates(cw, ws, ls, lane0, lanes, b, threadIdx.x >> 2, inner,
                       outer);
    if (lane >= b) return;  // past the batch: only the barrier above
    // salt le64(index) || be32(q + 1), padded: 12 message bytes after the
    // 64-byte inner key block
    uint32_t m[16] = {bswap32(idx_lo[lane]), bswap32(idx_hi[lane]), q + 1,
                      0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u,
                      0u, (64 + 12) * 8};
    compress(inner, m);
    hmac_outer(outer, inner);
#pragma unroll
    for (int k = 0; k < 8; ++k)
        out[(size_t)(q * 8 + k) * b + lane] = bswap32(inner[k]);
}

// The proving hash's inputs for finish's epilogue: challenge words at
// ch[w * chs + lane * chl] (chl = 0: one shared challenge), the nonce at
// nonce[lane * nls] or nonce_value for every lane when nonce is null, the
// (B,) index halves, and the (B,) output values.
struct HashArgs {
    const uint32_t* ch;
    long long chs, chl;
    const uint32_t* nonce;
    long long nls;
    uint32_t nonce_value;
    const uint32_t* idx_lo;
    const uint32_t* idx_hi;
    uint32_t* values;
};

// kHash = false: finish alone, out the (4, B) label words. kHash = true:
// finish, then the proving hash into hash.values; out is written only
// when it is not null.
template <bool kShared, bool kHash>
__global__ void __launch_bounds__(kMaxThreads)
finish_kernel(const uint32_t* __restrict__ cw, long long ws, long long ls,
              const uint32_t* __restrict__ blk, uint32_t* __restrict__ out,
              long long b, HashArgs hash) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t inner[8], outer[8], m[16];
    if (kShared) {
        block_midstates(cw, ws, inner, outer);
        if (lane >= b) return;  // past the batch: only the barrier above
    } else {
        if (lane >= b) return;
        uint32_t key[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) key[i] = cw[i * ws + lane * ls];
        hmac_midstate(key, kHmacIpad, inner);
        hmac_midstate(key, kHmacOpad, outer);
    }
    // salt = B' (128 bytes, LE words) || be32(1), padded: 132 message
    // bytes after the inner key block
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
            m[i] = bswap32(blk[(size_t)(16 * h + i) * b + lane]);
        compress(inner, m);
    }
    m[0] = 1u;
    m[1] = 0x80000000u;
#pragma unroll
    for (int i = 2; i < 15; ++i) m[i] = 0u;
    m[15] = (64 + 132) * 8;
    compress(inner, m);
    hmac_outer(outer, inner);
    if constexpr (kHash) {
        uint32_t x[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = hash.ch[i * hash.chs + lane * hash.chl];
        x[8] = hash.nonce ? hash.nonce[lane * hash.nls] : hash.nonce_value;
        x[9] = hash.idx_lo[lane];
        x[10] = hash.idx_hi[lane];
        x[11] = 0u;
        // finish's big-endian digest words -> the little-endian label
        // words the hash takes (labels_to_words)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[12 + i] = bswap32(inner[i]);
        const uint32_t c0 = x[0];
        salsa20_8_rounds(x);
        hash.values[lane] = x[0] + c0;
        if (out == nullptr) return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(size_t)k * b + lane] = inner[k];
}

// cw: 8 u32 key words at cw[w * ws + lane * ls] (ls = 0: one shared key);
// idx_lo/idx_hi: (B,) u32; out: (32, B) u32 LE words. Returns
// cudaGetLastError().
extern "C" int pbkdf2_expand_launch(const void* cw, long long ws, long long ls,
                                    const void* idx_lo, const void* idx_hi,
                                    void* out, long long b, void* stream) {
    if (b <= 0) return 0;
    const long long threads = 4 * b;  // a quad per lane
    const unsigned block = spread_threads(threads, kMaxThreads);
    const unsigned grid = blocks_of(threads, block);
    auto kernel = ls == 0 ? expand_kernel<true> : expand_kernel<false>;
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cw, ws, ls, (const uint32_t*)idx_lo,
        (const uint32_t*)idx_hi, (uint32_t*)out, b);
    return (int)cudaGetLastError();
}

// cw as above; blk: (32, B) u32 LE words (the ROMix output); out: (4, B)
// u32 BE label words. Returns cudaGetLastError().
extern "C" int pbkdf2_finish_launch(const void* cw, long long ws, long long ls,
                                    const void* blk, void* out, long long b,
                                    void* stream) {
    if (b <= 0) return 0;
    const unsigned block = spread_threads(b, kMaxThreads);
    const unsigned grid = blocks_of(b, block);
    auto kernel = ls == 0 ? finish_kernel<true, false>
                          : finish_kernel<false, false>;
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cw, ws, ls, (const uint32_t*)blk, (uint32_t*)out, b,
        HashArgs{});
    return (int)cudaGetLastError();
}

// cw, blk as above; out: (4, B) u32 BE label words, or null to skip them;
// ch: 8 u32 challenge words at ch[w * chs + lane * chl]; nonce: u32 at
// nonce[lane * nls], or nonce_value for every lane when nonce is null;
// idx_lo/idx_hi: (B,) u32; values: (B,) u32 proving-hash values. Returns
// cudaGetLastError().
extern "C" int pbkdf2_finish_hash_launch(
    const void* cw, long long ws, long long ls, const void* blk, void* out,
    long long b, const void* ch, long long chs, long long chl,
    const void* nonce, long long nls, uint32_t nonce_value,
    const void* idx_lo, const void* idx_hi, void* values, void* stream) {
    if (b <= 0) return 0;
    const unsigned block = spread_threads(b, kMaxThreads);
    const unsigned grid = blocks_of(b, block);
    auto kernel = ls == 0 ? finish_kernel<true, true>
                          : finish_kernel<false, true>;
    const HashArgs hash{(const uint32_t*)ch, chs, chl,
                        (const uint32_t*)nonce, nls, nonce_value,
                        (const uint32_t*)idx_lo, (const uint32_t*)idx_hi,
                        (uint32_t*)values};
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cw, ws, ls, (const uint32_t*)blk, (uint32_t*)out, b,
        hash);
    return (int)cudaGetLastError();
}
