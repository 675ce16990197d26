// PBKDF2-HMAC-SHA256 envelope of scrypt (N, r=1, p=1, dklen=16) labels,
// one thread per lane: the expansion before ROMix and the finish after it.
//
// Replaces the envelope that spacemesh_tpu/ops/scrypt.py::_labels_fused
// compiles into one XLA program around the Pallas ROMix kernel (expand ->
// ROMix -> finish, "PBKDF2/HMAC block state stays on device"); the JAX
// package has no Pallas kernel for it. Both entry points start from the
// raw 32-byte commitment (password), shared by every lane (word stride 1,
// lane stride 0) or one per lane (word stride B, lane stride 1), and
// derive the HMAC inner and outer midstates in registers:
//
//   expand: salt = le64(index); for i in 1..4:
//           T_i = HMAC(pw, salt || be32(i)); out = T_1..T_4 as (32, B) LE
//   finish: HMAC(pw, B' || be32(1)) over the 128-byte ROMix output B',
//           the first 4 big-endian digest words -> (4, B)
//
// SHA-256 compression is unrolled in registers with funnel-shift rotates;
// constant padding words fold into immediates. Bound: 8 compressions per
// lane in expand and 4 in finish, plus the midstates' 2 once for a shared
// commitment (about 1300 integer operations each), against 136 and 144
// bytes of device traffic per lane, so the operations bound it, about a
// hundredth of a millisecond at 32768 lanes: launch latency sets its time.
// The kernel recomputes the midstates in every lane, two compressions per
// lane more than a shared commitment needs, so that it stays one launch.

#include <cstdint>
#include <cuda_runtime.h>

#define ROTR(v, n) __funnelshift_r((v), (v), (n))

constexpr int kThreads = 128;

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t bswap32(uint32_t v) {
    return __byte_perm(v, 0, 0x0123);
}

// st <- SHA-256 compression of st with the 16 big-endian words of w.
__device__ __forceinline__ void compress(uint32_t* st, const uint32_t* m) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = m[i];
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        if (i >= 16) {  // w[i & 15] holds W[i-16]
            const uint32_t x = w[(i - 15) & 15], y = w[(i - 2) & 15];
            w[i & 15] += (ROTR(x, 7) ^ ROTR(x, 18) ^ (x >> 3)) +
                         w[(i - 7) & 15] +
                         (ROTR(y, 17) ^ ROTR(y, 19) ^ (y >> 10));
        }
        const uint32_t t1 = h + (ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25)) +
                            ((e & f) ^ (~e & g)) + kK[i] + w[i & 15];
        const uint32_t t2 = (ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22)) +
                            ((a & b) ^ (a & c) ^ (b & c));
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__device__ __forceinline__ void sha256_iv(uint32_t* st) {
    st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
    st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
    st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// HMAC-SHA256 inner and outer midstates of a 32-byte key (8 BE words) of
// this lane: the key is read at cw[w * ws + lane * ls].
__device__ __forceinline__ void midstates(const uint32_t* __restrict__ cw,
                                          long long ws, long long ls,
                                          long long lane, uint32_t* inner,
                                          uint32_t* outer) {
    uint32_t key[8], m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) key[i] = cw[i * ws + lane * ls];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = (i < 8 ? key[i] : 0u) ^ 0x36363636u;
    sha256_iv(inner);
    compress(inner, m);
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = (i < 8 ? key[i] : 0u) ^ 0x5c5c5c5cu;
    sha256_iv(outer);
    compress(outer, m);
}

// st (an inner digest) <- the outer HMAC digest over it.
__device__ __forceinline__ void hmac_outer(const uint32_t* outer,
                                           uint32_t* st) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = st[i];
    m[8] = 0x80000000u;
#pragma unroll
    for (int i = 9; i < 15; ++i) m[i] = 0u;
    m[15] = (64 + 32) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = outer[i];
    compress(st, m);
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const uint32_t* __restrict__ cw, long long ws, long long ls,
              const uint32_t* __restrict__ idx_lo,
              const uint32_t* __restrict__ idx_hi, uint32_t* __restrict__ out,
              long long b) {
    const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (lane >= b) return;
    uint32_t inner[8], outer[8];
    midstates(cw, ws, ls, lane, inner, outer);
    const uint32_t s0 = bswap32(idx_lo[lane]), s1 = bswap32(idx_hi[lane]);
#pragma unroll 1
    for (uint32_t i = 1; i <= 4; ++i) {
        // salt le64(index) || be32(i), padded: 12 message bytes after the
        // 64-byte inner key block
        uint32_t m[16] = {s0, s1, i, 0x80000000u, 0u, 0u, 0u, 0u,
                          0u, 0u, 0u, 0u, 0u, 0u, 0u, (64 + 12) * 8};
        uint32_t st[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) st[k] = inner[k];
        compress(st, m);
        hmac_outer(outer, st);
#pragma unroll
        for (int k = 0; k < 8; ++k)
            out[(size_t)((i - 1) * 8 + k) * b + lane] = bswap32(st[k]);
    }
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const uint32_t* __restrict__ cw, long long ws, long long ls,
              const uint32_t* __restrict__ blk, uint32_t* __restrict__ out,
              long long b) {
    const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (lane >= b) return;
    uint32_t inner[8], outer[8], m[16];
    midstates(cw, ws, ls, lane, inner, outer);
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
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(size_t)k * b + lane] = inner[k];
}

static unsigned blocks_for(long long b) {
    return (unsigned)((b + kThreads - 1) / kThreads);
}

// cw: 8 u32 key words at cw[w * ws + lane * ls]; idx_lo/idx_hi: (B,) u32;
// out: (32, B) u32 LE words. Returns cudaGetLastError().
extern "C" int pbkdf2_expand_launch(const void* cw, long long ws, long long ls,
                                    const void* idx_lo, const void* idx_hi,
                                    void* out, long long b, void* stream) {
    if (b <= 0) return 0;
    expand_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
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
    finish_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cw, ws, ls, (const uint32_t*)blk, (uint32_t*)out, b);
    return (int)cudaGetLastError();
}
