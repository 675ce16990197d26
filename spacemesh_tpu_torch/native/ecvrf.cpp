// ECVRF-EDWARDS25519-SHA512-TAI (RFC 9381, suite 0x03) — native twin of
// core/signing.py's pure-Python implementation (reference signing/vrf.go
// wraps curve25519-voi; this is the runtime-hot host op: every ballot
// eligibility, hare message, and beacon proposal validation runs one or
// more VRF verifies).  The Python twin is the TEST ORACLE: identical
// byte-level behavior is asserted by randomized differential tests
// (tests/test_torch_native.py, beside the JAX package's
// tests/test_native_ecvrf.py for its own copy of this file) and by the
// RFC 9381 vectors the Python implementation already passes.
//
// Self-contained: SHA-512 from spec (constant tables generated
// arithmetically from prime cube/square roots and pinned against
// hashlib), 5x51-limb field arithmetic over 2^255-19, extended-
// coordinate point ops mirroring the twin's formulas, and shift-
// subtract scalar reduction mod the group order (division-free,
// obviously-correct; scalar work is negligible next to scalar mults).
//
// Build (native/__init__.py): g++ -O3 -shared -fPIC -o <out>.so ecvrf.cpp
// NOTE: scalar multiplication is VARIABLE-TIME.  Verification inputs
// are public, so that is fine; proving uses the long-term VRF secret —
// acceptable for this framework's threat model (the reference's CPU
// path is the same machine the miner fully controls), documented here
// so nobody mistakes it for a hardened signer.

#include <cstdint>
#include <cstring>
#include <cstddef>

// --------------------------------------------------------------------
// SHA-512 (tables generated + verified against hashlib; see repo notes)
// --------------------------------------------------------------------

static const uint64_t SHA512_K[80] = {
  0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
  0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
  0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
  0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
  0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
  0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
  0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
  0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
  0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
  0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
  0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
  0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
  0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
  0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
  0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
  0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
  0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
  0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
  0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
  0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};
static const uint64_t SHA512_H0[8] = {
  0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
  0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static inline uint64_t ror64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

struct Sha512 {
    uint64_t h[8];
    uint8_t buf[128];
    uint64_t total;
    size_t fill;

    Sha512() { reset(); }
    void reset() {
        memcpy(h, SHA512_H0, sizeof h);
        total = 0;
        fill = 0;
    }
    void block(const uint8_t* p) {
        uint64_t w[80];
        for (int i = 0; i < 16; i++) {
            w[i] = ((uint64_t)p[i * 8] << 56) | ((uint64_t)p[i * 8 + 1] << 48)
                 | ((uint64_t)p[i * 8 + 2] << 40) | ((uint64_t)p[i * 8 + 3] << 32)
                 | ((uint64_t)p[i * 8 + 4] << 24) | ((uint64_t)p[i * 8 + 5] << 16)
                 | ((uint64_t)p[i * 8 + 6] << 8) | (uint64_t)p[i * 8 + 7];
        }
        for (int i = 16; i < 80; i++) {
            uint64_t s0 = ror64(w[i - 15], 1) ^ ror64(w[i - 15], 8) ^ (w[i - 15] >> 7);
            uint64_t s1 = ror64(w[i - 2], 19) ^ ror64(w[i - 2], 61) ^ (w[i - 2] >> 6);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 80; i++) {
            uint64_t S1 = ror64(e, 14) ^ ror64(e, 18) ^ ror64(e, 41);
            uint64_t ch = (e & f) ^ (~e & g);
            uint64_t t1 = hh + S1 + ch + SHA512_K[i] + w[i];
            uint64_t S0 = ror64(a, 28) ^ ror64(a, 34) ^ ror64(a, 39);
            uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
            uint64_t t2 = S0 + mj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }
    void update(const uint8_t* p, size_t n) {
        total += n;
        while (n) {
            size_t take = 128 - fill;
            if (take > n) take = n;
            memcpy(buf + fill, p, take);
            fill += take; p += take; n -= take;
            if (fill == 128) { block(buf); fill = 0; }
        }
    }
    void final(uint8_t out[64]) {
        uint64_t bits = total * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t z = 0;
        while (fill != 112) update(&z, 1);
        uint8_t len[16] = {0};
        for (int i = 0; i < 8; i++) len[15 - i] = (uint8_t)(bits >> (8 * i));
        update(len, 16);
        for (int i = 0; i < 8; i++)
            for (int j = 0; j < 8; j++)
                out[i * 8 + j] = (uint8_t)(h[i] >> (56 - 8 * j));
    }
};

// --------------------------------------------------------------------
// fe25519: GF(2^255-19), five 51-bit limbs
// --------------------------------------------------------------------

typedef struct { uint64_t v[5]; } fe;

static const uint64_t MASK51 = (1ULL << 51) - 1;

static void fe_frombytes(fe* r, const uint8_t s[32]) {
    uint64_t w[4];
    for (int i = 0; i < 4; i++) {
        w[i] = 0;
        for (int j = 0; j < 8; j++)
            w[i] |= (uint64_t)s[i * 8 + j] << (8 * j);
    }
    r->v[0] = w[0] & MASK51;
    r->v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
    r->v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
    r->v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
    r->v[4] = (w[3] >> 12) & MASK51;  // drops bit 255 (the sign bit)
}

static void fe_carry(fe* r) {
    for (int pass = 0; pass < 2; pass++) {
        uint64_t c;
        for (int i = 0; i < 4; i++) {
            c = r->v[i] >> 51; r->v[i] &= MASK51; r->v[i + 1] += c;
        }
        c = r->v[4] >> 51; r->v[4] &= MASK51; r->v[0] += 19 * c;
    }
}

static void fe_tobytes(uint8_t s[32], const fe* a) {
    fe t = *a;
    fe_carry(&t);
    // full canonical reduction: add 19, see if it wraps past 2^255
    uint64_t q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    uint64_t c;
    for (int i = 0; i < 4; i++) {
        c = t.v[0 + i] >> 51; t.v[i] &= MASK51; t.v[i + 1] += c;
    }
    t.v[4] &= MASK51;
    uint64_t w0 = t.v[0] | (t.v[1] << 51);
    uint64_t w1 = (t.v[1] >> 13) | (t.v[2] << 38);
    uint64_t w2 = (t.v[2] >> 26) | (t.v[3] << 25);
    uint64_t w3 = (t.v[3] >> 39) | (t.v[4] << 12);
    uint64_t w[4] = {w0, w1, w2, w3};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            s[i * 8 + j] = (uint8_t)(w[i] >> (8 * j));
}

static void fe_0(fe* r) { memset(r, 0, sizeof *r); }
static void fe_1(fe* r) { fe_0(r); r->v[0] = 1; }

static void fe_add(fe* r, const fe* a, const fe* b) {
    for (int i = 0; i < 5; i++) r->v[i] = a->v[i] + b->v[i];
    fe_carry(r);
}

static void fe_sub(fe* r, const fe* a, const fe* b) {
    // a + 2p - b keeps limbs positive
    static const uint64_t TWOP[5] = {
        2 * ((1ULL << 51) - 19), 2 * MASK51, 2 * MASK51, 2 * MASK51,
        2 * MASK51};
    for (int i = 0; i < 5; i++) r->v[i] = a->v[i] + TWOP[i] - b->v[i];
    fe_carry(r);
}

static void fe_mul(fe* r, const fe* a, const fe* b) {
    typedef unsigned __int128 u128;
    const uint64_t a0 = a->v[0], a1 = a->v[1], a2 = a->v[2],
                   a3 = a->v[3], a4 = a->v[4];
    const uint64_t b0 = b->v[0], b1 = b->v[1], b2 = b->v[2],
                   b3 = b->v[3], b4 = b->v[4];
    const uint64_t b1_19 = 19 * b1, b2_19 = 19 * b2, b3_19 = 19 * b3,
                   b4_19 = 19 * b4;
    u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19
            + (u128)a3 * b2_19 + (u128)a4 * b1_19;
    u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19
            + (u128)a3 * b3_19 + (u128)a4 * b2_19;
    u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0
            + (u128)a3 * b4_19 + (u128)a4 * b3_19;
    u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1
            + (u128)a3 * b0 + (u128)a4 * b4_19;
    u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2
            + (u128)a3 * b1 + (u128)a4 * b0;
    uint64_t r0, r1, r2, r3, r4, c;
    r0 = (uint64_t)t0 & MASK51; t1 += (uint64_t)(t0 >> 51);
    r1 = (uint64_t)t1 & MASK51; t2 += (uint64_t)(t1 >> 51);
    r2 = (uint64_t)t2 & MASK51; t3 += (uint64_t)(t2 >> 51);
    r3 = (uint64_t)t3 & MASK51; t4 += (uint64_t)(t3 >> 51);
    r4 = (uint64_t)t4 & MASK51; c = (uint64_t)(t4 >> 51);
    r0 += 19 * c;
    c = r0 >> 51; r0 &= MASK51; r1 += c;
    c = r1 >> 51; r1 &= MASK51; r2 += c;
    r->v[0] = r0; r->v[1] = r1; r->v[2] = r2; r->v[3] = r3; r->v[4] = r4;
}

static void fe_sq(fe* r, const fe* a) { fe_mul(r, a, a); }

// MSB-first square-and-multiply; exponent little-endian 32 bytes
static void fe_pow(fe* r, const fe* base, const uint8_t exp_le[32]) {
    fe acc;
    fe_1(&acc);
    for (int byte = 31; byte >= 0; byte--) {
        for (int bit = 7; bit >= 0; bit--) {
            fe_sq(&acc, &acc);
            if ((exp_le[byte] >> bit) & 1) fe_mul(&acc, &acc, base);
        }
    }
    *r = acc;
}

static const uint8_t P_MINUS_2[32] = {235,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,127};
static const uint8_t P58[32] = {253,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,15};

static void fe_invert(fe* r, const fe* a) { fe_pow(r, a, P_MINUS_2); }
static void fe_pow58(fe* r, const fe* a) { fe_pow(r, a, P58); }

static int fe_eq(const fe* a, const fe* b) {
    uint8_t sa[32], sb[32];
    fe_tobytes(sa, a);
    fe_tobytes(sb, b);
    return memcmp(sa, sb, 32) == 0;
}

static int fe_iszero(const fe* a) {
    static const uint8_t Z[32] = {0};
    uint8_t s[32];
    fe_tobytes(s, a);
    return memcmp(s, Z, 32) == 0;
}

static void fe_neg(fe* r, const fe* a) {
    fe z;
    fe_0(&z);
    fe_sub(r, &z, a);
}

// --------------------------------------------------------------------
// curve constants
// --------------------------------------------------------------------

static const uint8_t D_BYTES[32] = {163,120,89,19,202,77,235,117,171,216,65,65,77,10,112,0,152,232,121,119,121,64,199,140,115,254,111,43,238,108,3,82};
static const uint8_t SQRTM1_BYTES[32] = {176,160,14,74,39,27,238,196,120,228,47,173,6,24,67,47,167,215,251,61,153,0,77,43,11,223,193,79,128,36,131,43};
static const uint8_t B_BYTES[32] = {88,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102,102};

// --------------------------------------------------------------------
// points: extended projective (X, Y, Z, T), XY = ZT — SAME formulas as
// the Python twin (core/signing.py _pt_add / _pt_mul / _pt_decode)
// --------------------------------------------------------------------

typedef struct { fe X, Y, Z, T; } ge;

static void ge_identity(ge* r) {
    fe_0(&r->X); fe_1(&r->Y); fe_1(&r->Z); fe_0(&r->T);
}

static void ge_add(ge* r, const ge* p, const ge* q) {
    fe d_const, a, b, c, dd, e, f, g, h, t;
    fe_frombytes(&d_const, D_BYTES);
    // a = (y1-x1)(y2-x2)
    fe t1, t2;
    fe_sub(&t1, &p->Y, &p->X);
    fe_sub(&t2, &q->Y, &q->X);
    fe_mul(&a, &t1, &t2);
    // b = (y1+x1)(y2+x2)
    fe_add(&t1, &p->Y, &p->X);
    fe_add(&t2, &q->Y, &q->X);
    fe_mul(&b, &t1, &t2);
    // c = 2*d*t1*t2
    fe_mul(&t, &p->T, &q->T);
    fe_mul(&c, &t, &d_const);
    fe_add(&c, &c, &c);
    // dd = 2*z1*z2
    fe_mul(&dd, &p->Z, &q->Z);
    fe_add(&dd, &dd, &dd);
    fe_sub(&e, &b, &a);
    fe_sub(&f, &dd, &c);
    fe_add(&g, &dd, &c);
    fe_add(&h, &b, &a);
    fe_mul(&r->X, &e, &f);
    fe_mul(&r->Y, &g, &h);
    fe_mul(&r->Z, &f, &g);
    fe_mul(&r->T, &e, &h);
}

// dedicated doubling (EFD dbl-2008-hwcd for a=-1): 4 squarings + 4 muls
// vs the unified add's 9 muls
static void ge_dbl(ge* r, const ge* p) {
    fe A, B, C, D, E, F, G, H, t;
    fe_sq(&A, &p->X);
    fe_sq(&B, &p->Y);
    fe_sq(&C, &p->Z);
    fe_add(&C, &C, &C);        // C = 2 Z^2
    fe_neg(&D, &A);            // D = a*A, a = -1
    fe_add(&t, &p->X, &p->Y);
    fe_sq(&E, &t);
    fe_sub(&E, &E, &A);
    fe_sub(&E, &E, &B);        // E = (X+Y)^2 - A - B
    fe_add(&G, &D, &B);        // G = D + B
    fe_sub(&F, &G, &C);        // F = G - C
    fe_sub(&H, &D, &B);        // H = D - B
    fe_mul(&r->X, &E, &F);
    fe_mul(&r->Y, &G, &H);
    fe_mul(&r->Z, &F, &G);
    fe_mul(&r->T, &E, &H);
}

// scalar as little-endian bytes; LSB-first double-and-add, mirroring
// the twin's _pt_mul (variable-time — see file header)
static void ge_scalarmult(ge* r, const uint8_t* scalar_le, size_t len,
                          const ge* p) {
    ge acc, base = *p;
    ge_identity(&acc);
    for (size_t i = 0; i < len; i++) {
        uint8_t byte = scalar_le[i];
        for (int bit = 0; bit < 8; bit++) {
            if ((byte >> bit) & 1) ge_add(&acc, &acc, &base);
            ge_dbl(&base, &base);
        }
    }
    *r = acc;
}

// Shamir's trick: r = a*P + b*Q in one MSB-first pass — one shared
// doubling chain instead of two (verify's U and V are this shape)
static void ge_double_scalarmult(ge* r, const uint8_t* a_le, size_t alen,
                                 const ge* p, const uint8_t* b_le,
                                 size_t blen, const ge* q) {
    ge pq, acc;
    ge_add(&pq, p, q);
    ge_identity(&acc);
    size_t bits = (alen > blen ? alen : blen) * 8;
    for (size_t i = bits; i-- > 0;) {
        ge_dbl(&acc, &acc);
        int abit = i < alen * 8 && (a_le[i / 8] >> (i % 8)) & 1;
        int bbit = i < blen * 8 && (b_le[i / 8] >> (i % 8)) & 1;
        if (abit && bbit) ge_add(&acc, &acc, &pq);
        else if (abit) ge_add(&acc, &acc, p);
        else if (bbit) ge_add(&acc, &acc, q);
    }
    *r = acc;
}

// shared wire encoding: y bytes with x-parity in bit 255 — challenge
// hashing and proof/pk encoding MUST stay byte-identical
static void ge_encode_affine(uint8_t s[32], const ge* p, const fe* zi) {
    fe x, y;
    fe_mul(&x, &p->X, zi);
    fe_mul(&y, &p->Y, zi);
    fe_tobytes(s, &y);
    uint8_t xb[32];
    fe_tobytes(xb, &x);
    s[31] |= (xb[0] & 1) << 7;
}

static void ge_tobytes(uint8_t s[32], const ge* p) {
    fe zi;
    fe_invert(&zi, &p->Z);
    ge_encode_affine(s, p, &zi);
}

// returns 0 on failure (not on curve / non-canonical), 1 on success
static int ge_frombytes(ge* r, const uint8_t s[32]) {
    // reject y >= p (canonical check, like the twin's `y >= _P`)
    static const uint8_t P_LE[32] = {237,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,255,127};
    uint8_t ycheck[32];
    memcpy(ycheck, s, 32);
    ycheck[31] &= 0x7f;
    for (int i = 31; i >= 0; i--) {
        if (ycheck[i] < P_LE[i]) break;
        if (ycheck[i] > P_LE[i]) return 0;
        if (i == 0) return 0;  // equal to p
    }
    int sign = s[31] >> 7;
    fe y;
    fe_frombytes(&y, s);
    // x^2 = (y^2-1)/(d y^2+1); candidate x = u*v^3 * (u*v^7)^((p-5)/8)
    fe u, v, d_const, one, t, v3, v7, x;
    fe_frombytes(&d_const, D_BYTES);
    fe_1(&one);
    fe_sq(&t, &y);
    fe_sub(&u, &t, &one);          // u = y^2 - 1
    fe_mul(&v, &t, &d_const);
    fe_add(&v, &v, &one);          // v = d y^2 + 1
    fe_sq(&v3, &v);
    fe_mul(&v3, &v3, &v);          // v^3
    fe_sq(&v7, &v3);
    fe_mul(&v7, &v7, &v);          // v^7
    fe_mul(&t, &u, &v7);
    fe_pow58(&t, &t);              // (u v^7)^((p-5)/8)
    fe_mul(&x, &u, &v3);
    fe_mul(&x, &x, &t);
    fe vx2, negu;
    fe_sq(&t, &x);
    fe_mul(&vx2, &v, &t);          // v x^2
    fe_neg(&negu, &u);
    if (fe_eq(&vx2, &u)) {
        // x ok
    } else if (fe_eq(&vx2, &negu)) {
        fe sqrtm1;
        fe_frombytes(&sqrtm1, SQRTM1_BYTES);
        fe_mul(&x, &x, &sqrtm1);
    } else {
        return 0;
    }
    if (fe_iszero(&x) && sign) return 0;
    uint8_t xb[32];
    fe_tobytes(xb, &x);
    if ((xb[0] & 1) != sign) fe_neg(&x, &x);
    r->X = x;
    r->Y = y;
    fe_1(&r->Z);
    fe_mul(&r->T, &x, &y);
    return 1;
}

// --------------------------------------------------------------------
// scalars mod q = 2^252 + 27742...: 32-bit limb bignum, shift-subtract
// reduction (division-free; runs once per prove — not a hot path)
// --------------------------------------------------------------------

static const uint8_t Q_LE[32] = {237,211,245,92,26,99,18,88,214,156,247,162,222,249,222,20,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,16};

typedef struct { uint32_t w[24]; } bn;  // 768 bits headroom

static void bn_zero(bn* r) { memset(r, 0, sizeof *r); }

static void bn_from_le(bn* r, const uint8_t* s, size_t len) {
    bn_zero(r);
    for (size_t i = 0; i < len && i < 96; i++)
        r->w[i / 4] |= (uint32_t)s[i] << (8 * (i % 4));
}

static void bn_to_le32(uint8_t out[32], const bn* a) {
    for (int i = 0; i < 32; i++)
        out[i] = (uint8_t)(a->w[i / 4] >> (8 * (i % 4)));
}

static int bn_cmp(const bn* a, const bn* b) {
    for (int i = 23; i >= 0; i--) {
        if (a->w[i] < b->w[i]) return -1;
        if (a->w[i] > b->w[i]) return 1;
    }
    return 0;
}

static void bn_sub(bn* r, const bn* a, const bn* b) {
    uint64_t borrow = 0;
    for (int i = 0; i < 24; i++) {
        uint64_t t = (uint64_t)a->w[i] - b->w[i] - borrow;
        r->w[i] = (uint32_t)t;
        borrow = (t >> 32) & 1;
    }
}

static void bn_shl1(bn* r) {
    uint32_t carry = 0;
    for (int i = 0; i < 24; i++) {
        uint32_t nc = r->w[i] >> 31;
        r->w[i] = (r->w[i] << 1) | carry;
        carry = nc;
    }
}

static int bn_bit(const bn* a, int i) {
    return (a->w[i / 32] >> (i % 32)) & 1;
}

static void bn_mod_q(bn* r, const bn* a) {
    bn q;
    bn_from_le(&q, Q_LE, 32);
    bn acc;
    bn_zero(&acc);
    for (int i = 767; i >= 0; i--) {
        bn_shl1(&acc);
        if (bn_bit(a, i)) acc.w[0] |= 1;
        if (bn_cmp(&acc, &q) >= 0) {
            bn tmp;
            bn_sub(&tmp, &acc, &q);
            acc = tmp;
        }
    }
    *r = acc;
}

static void bn_mul(bn* r, const bn* a, const bn* b) {
    // schoolbook over the low 8x8 limbs (inputs < 2^256 each)
    uint64_t acc[24] = {0};
    for (int i = 0; i < 8; i++) {
        uint64_t carry = 0;
        for (int j = 0; j < 8; j++) {
            unsigned __int128 t = (unsigned __int128)a->w[i] * b->w[j]
                + acc[i + j] + carry;
            acc[i + j] = (uint64_t)(t & 0xFFFFFFFFULL);
            carry = (uint64_t)(t >> 32);
        }
        acc[i + 8] += carry;
    }
    bn_zero(r);
    uint64_t carry = 0;
    for (int i = 0; i < 24; i++) {
        uint64_t t = acc[i] + carry;
        r->w[i] = (uint32_t)t;
        carry = t >> 32;
    }
}

static void bn_add(bn* r, const bn* a, const bn* b) {
    uint64_t carry = 0;
    for (int i = 0; i < 24; i++) {
        uint64_t t = (uint64_t)a->w[i] + b->w[i] + carry;
        r->w[i] = (uint32_t)t;
        carry = t >> 32;
    }
}

// --------------------------------------------------------------------
// ECVRF protocol (mirrors core/signing.py byte for byte)
// --------------------------------------------------------------------

static const uint8_t SUITE = 0x03;

static void expand_key(const uint8_t seed[32], uint8_t x_clamped[32],
                       uint8_t nonce_key[32]) {
    Sha512 h;
    uint8_t d[64];
    h.update(seed, 32);
    h.final(d);
    memcpy(x_clamped, d, 32);
    x_clamped[0] &= 248;
    x_clamped[31] &= 63;
    x_clamped[31] |= 64;
    memcpy(nonce_key, d + 32, 32);
}

static int hash_to_curve_tai(ge* out, const uint8_t pk[32],
                             const uint8_t* alpha, size_t alen) {
    for (int ctr = 0; ctr < 256; ctr++) {
        Sha512 h;
        uint8_t prefix[2] = {SUITE, 0x01};
        uint8_t tail[2] = {(uint8_t)ctr, 0x00};
        uint8_t d[64];
        h.update(prefix, 2);
        h.update(pk, 32);
        h.update(alpha, alen);
        h.update(tail, 2);
        h.final(d);
        ge pt;
        if (ge_frombytes(&pt, d)) {
            uint8_t eight = 8;
            ge_scalarmult(out, &eight, 1, &pt);  // clear cofactor
            return 1;
        }
    }
    return 0;
}

// encode 5 points with ONE field inversion (Montgomery's trick) — a
// fe_invert is ~380 fe_muls, comparable to a whole scalarmult, and the
// challenge hash needs five encodings
static void ge_tobytes_batch5(uint8_t enc[5][32], const ge* pts[5]) {
    fe prefix[5], inv;
    prefix[0] = pts[0]->Z;
    for (int i = 1; i < 5; i++) fe_mul(&prefix[i], &prefix[i - 1],
                                       &pts[i]->Z);
    fe_invert(&inv, &prefix[4]);
    for (int i = 4; i >= 0; i--) {
        fe zi;
        if (i == 0) {
            zi = inv;
        } else {
            fe_mul(&zi, &inv, &prefix[i - 1]);
            fe_mul(&inv, &inv, &pts[i]->Z);
        }
        ge_encode_affine(enc[i], pts[i], &zi);
    }
}

static void challenge16(uint8_t c16[16], const ge* pts[5]) {
    Sha512 h;
    uint8_t prefix[2] = {SUITE, 0x02};
    uint8_t zero = 0x00;
    uint8_t d[64];
    uint8_t enc[5][32];
    ge_tobytes_batch5(enc, pts);
    h.update(prefix, 2);
    for (int i = 0; i < 5; i++) h.update(enc[i], 32);
    h.update(&zero, 1);
    h.final(d);
    memcpy(c16, d, 16);
}

extern "C" {

int smtpu_vrf_public_key(const uint8_t seed[32], uint8_t pk[32]) {
    uint8_t x[32], nk[32];
    expand_key(seed, x, nk);
    ge B, Y;
    if (!ge_frombytes(&B, B_BYTES)) return -1;
    ge_scalarmult(&Y, x, 32, &B);
    ge_tobytes(pk, &Y);
    return 0;
}

int smtpu_vrf_prove(const uint8_t seed[32], const uint8_t* alpha,
                    size_t alen, uint8_t proof[80]) {
    uint8_t x[32], nk[32];
    expand_key(seed, x, nk);
    ge B, Y;
    if (!ge_frombytes(&B, B_BYTES)) return -1;
    ge_scalarmult(&Y, x, 32, &B);
    uint8_t pk[32];
    ge_tobytes(pk, &Y);

    ge H;
    if (!hash_to_curve_tai(&H, pk, alpha, alen)) return -1;
    uint8_t h_bytes[32];
    ge_tobytes(h_bytes, &H);

    ge Gamma;
    ge_scalarmult(&Gamma, x, 32, &H);

    // k = SHA512(nonce_key || h_bytes) mod q
    Sha512 hk;
    uint8_t kd[64];
    hk.update(nk, 32);
    hk.update(h_bytes, 32);
    hk.final(kd);
    bn kbig, k;
    bn_from_le(&kbig, kd, 64);
    bn_mod_q(&k, &kbig);
    uint8_t k_le[32];
    bn_to_le32(k_le, &k);

    ge kB, kH;
    ge_scalarmult(&kB, k_le, 32, &B);
    ge_scalarmult(&kH, k_le, 32, &H);

    uint8_t c16[16];
    const ge* pts[5] = {&Y, &H, &Gamma, &kB, &kH};
    challenge16(c16, pts);

    // s = (k + c*x) mod q
    bn c, xb, cx, sum, s;
    bn_from_le(&c, c16, 16);
    bn_from_le(&xb, x, 32);
    bn_mul(&cx, &c, &xb);
    bn_add(&sum, &cx, &k);
    bn_mod_q(&s, &sum);

    ge_tobytes(proof, &Gamma);
    memcpy(proof + 32, c16, 16);
    bn_to_le32(proof + 48, &s);
    return 0;
}

int smtpu_vrf_verify(const uint8_t pk[32], const uint8_t* alpha,
                     size_t alen, const uint8_t proof[80]) {
    ge Y, Gamma;
    if (!ge_frombytes(&Y, pk)) return 0;
    if (!ge_frombytes(&Gamma, proof)) return 0;
    const uint8_t* c16 = proof + 32;
    const uint8_t* s_le = proof + 48;
    // s < q
    bn s, q;
    bn_from_le(&s, s_le, 32);
    bn_from_le(&q, Q_LE, 32);
    if (bn_cmp(&s, &q) >= 0) return 0;

    ge H;
    if (!hash_to_curve_tai(&H, pk, alpha, alen)) return 0;

    ge B;
    if (!ge_frombytes(&B, B_BYTES)) return 0;
    ge negY = Y, negGamma = Gamma;
    fe_neg(&negY.X, &Y.X);
    fe_neg(&negY.T, &Y.T);
    fe_neg(&negGamma.X, &Gamma.X);
    fe_neg(&negGamma.T, &Gamma.T);

    ge U, V;
    ge_double_scalarmult(&U, s_le, 32, &B, c16, 16, &negY);
    ge_double_scalarmult(&V, s_le, 32, &H, c16, 16, &negGamma);

    uint8_t c_check[16];
    const ge* pts[5] = {&Y, &H, &Gamma, &U, &V};
    challenge16(c_check, pts);
    return memcmp(c_check, c16, 16) == 0 ? 1 : 0;
}

int smtpu_vrf_output(const uint8_t proof[80], uint8_t out[64]) {
    ge Gamma;
    if (!ge_frombytes(&Gamma, proof)) return -1;
    ge cg;
    uint8_t eight = 8;
    ge_scalarmult(&cg, &eight, 1, &Gamma);
    uint8_t enc[32];
    ge_tobytes(enc, &cg);
    Sha512 h;
    uint8_t prefix[2] = {SUITE, 0x03};
    uint8_t zero = 0x00;
    h.update(prefix, 2);
    h.update(enc, 32);
    h.update(&zero, 1);
    h.final(out);
    return 0;
}

}  // extern "C"
