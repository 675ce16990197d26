// SHA-256 compression and the HMAC-SHA256 pieces, as device functions
// shared by pbkdf2.cu (the scrypt envelope) and k2pow.cu (the proof of
// work). Words are big-endian packed per FIPS 180-4.
//
// The 64 rounds are unrolled in registers with funnel-shift rotates, so a
// message word that is a compile-time constant (the padding words of the
// HMAC and k2pow blocks) folds into an immediate. The round constants sit
// in constant memory, read at a compile-time index: one operand each.
//
// Two forms of the rounds, chosen at compile time (kImad). The plain form
// adds with IADD3, which issues on the integer pipe beside the rotates
// (SHF) and three-input logic (LOP3) that make up about two thirds of a
// compression: that pipe, 64 lanes a clock per SM, bounds a compression
// when many lanes keep the SMs busy. The IMAD form computes the rounds'
// two-input adds as a * kSha256One + b, a multiply by a one in constant
// memory that the compiler cannot fold, which issues on the FMA pipe, so
// the two pipes share the work; it costs more instructions and a longer
// dependent chain. The k2pow search, a throughput-bound loop over many
// nonces, takes it; PBKDF2 and the k2pow verify keep the plain form.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define SHA256_ROTR(v, n) __funnelshift_r((v), (v), (n))

__constant__ uint32_t kSha256K[64] = {
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

constexpr uint32_t kHmacIpad = 0x36363636u;
constexpr uint32_t kHmacOpad = 0x5c5c5c5cu;

__device__ __forceinline__ uint32_t bswap32(uint32_t v) {
    return __byte_perm(v, 0, 0x0123);
}

// A one the compiler cannot fold: the IMAD form multiplies by it.
__constant__ uint32_t kSha256One = 1u;

// a + b: IADD3 on the integer pipe, or (kImad) IMAD on the FMA pipe.
template <bool kImad>
__device__ __forceinline__ uint32_t sha256_add(uint32_t a, uint32_t b) {
    if constexpr (kImad)
        return a * kSha256One + b;
    else
        return a + b;
}

// Rounds kFirst..63 on the working variables v (a..h), in place, with the
// message schedule in w: w[i & 15] holds W[i] for the rounds before 16
// and W[i-16] after, as in compress. Without the feed-forward add.
template <bool kImad, int kFirst>
__device__ __forceinline__ void sha256_rounds(uint32_t* v, uint32_t* w) {
    uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
    uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
#pragma unroll
    for (int i = kFirst; i < 64; ++i) {
        if (i >= 16) {  // w[i & 15] holds W[i-16]
            const uint32_t x = w[(i - 15) & 15], y = w[(i - 2) & 15];
            w[i & 15] += (SHA256_ROTR(x, 7) ^ SHA256_ROTR(x, 18) ^ (x >> 3)) +
                         w[(i - 7) & 15] +
                         (SHA256_ROTR(y, 17) ^ SHA256_ROTR(y, 19) ^ (y >> 10));
        }
        const uint32_t s1 = SHA256_ROTR(e, 6) ^ SHA256_ROTR(e, 11) ^
                            SHA256_ROTR(e, 25);
        const uint32_t s0 = SHA256_ROTR(a, 2) ^ SHA256_ROTR(a, 13) ^
                            SHA256_ROTR(a, 22);
        const uint32_t t1 =
            sha256_add<kImad>(sha256_add<kImad>(h, s1), (e & f) ^ (~e & g)) +
            (kSha256K[i] + w[i & 15]);
        const uint32_t t2 = sha256_add<kImad>(s0, (a & b) ^ (a & c) ^ (b & c));
        h = g; g = f; f = e; e = sha256_add<kImad>(d, t1);
        d = c; c = b; b = a; a = sha256_add<kImad>(t1, t2);
    }
    v[0] = a; v[1] = b; v[2] = c; v[3] = d;
    v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// st <- SHA-256 compression of st with the 16 big-endian words of m. The
// plain form (the default) is written out on its own, so the kernels that
// take it compile as they did before the IMAD form existed.
template <bool kImad = false>
__device__ __forceinline__ void compress(uint32_t* st, const uint32_t* m) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = m[i];
    if constexpr (kImad) {
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = st[i];
        sha256_rounds<true, 0>(v, w);
#pragma unroll
        for (int i = 0; i < 8; ++i) st[i] += v[i];
        return;
    }
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        if (i >= 16) {  // w[i & 15] holds W[i-16]
            const uint32_t x = w[(i - 15) & 15], y = w[(i - 2) & 15];
            w[i & 15] += (SHA256_ROTR(x, 7) ^ SHA256_ROTR(x, 18) ^ (x >> 3)) +
                         w[(i - 7) & 15] +
                         (SHA256_ROTR(y, 17) ^ SHA256_ROTR(y, 19) ^ (y >> 10));
        }
        const uint32_t t1 = h +
                            (SHA256_ROTR(e, 6) ^ SHA256_ROTR(e, 11) ^
                             SHA256_ROTR(e, 25)) +
                            ((e & f) ^ (~e & g)) + kSha256K[i] + w[i & 15];
        const uint32_t t2 = (SHA256_ROTR(a, 2) ^ SHA256_ROTR(a, 13) ^
                             SHA256_ROTR(a, 22)) +
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

// One HMAC-SHA256 midstate of a 32-byte key (8 BE words): the compression
// of the key block xored with ``pad`` (kHmacIpad: inner, kHmacOpad: outer).
__device__ __forceinline__ void hmac_midstate(const uint32_t* key,
                                              uint32_t pad, uint32_t* st) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = (i < 8 ? key[i] : 0u) ^ pad;
    sha256_iv(st);
    compress(st, m);
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
