// The Salsa20/8 rounds as a device function, shared by proving_scan.cu
// (the proving scan and the standalone proving hash) and pbkdf2.cu (the
// proving hash as PBKDF2 finish's epilogue). Rotates are funnel shifts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ROTL(v, n) __funnelshift_l((v), (v), (n))
#define QR(a, b, c, d)     \
    b ^= ROTL(a + d, 7);   \
    c ^= ROTL(b + a, 9);   \
    d ^= ROTL(c + b, 13);  \
    a ^= ROTL(d + c, 18);

// The 8 rounds (4 double rounds) of Salsa20/8 on the state x, in place,
// without the final feed-forward add.
__device__ __forceinline__ void salsa20_8_rounds(uint32_t (&x)[16]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        QR(x[0], x[4], x[8], x[12]);
        QR(x[5], x[9], x[13], x[1]);
        QR(x[10], x[14], x[2], x[6]);
        QR(x[15], x[3], x[7], x[11]);
        QR(x[0], x[1], x[2], x[3]);
        QR(x[5], x[6], x[7], x[4]);
        QR(x[10], x[11], x[8], x[9]);
        QR(x[15], x[12], x[13], x[14]);
    }
}
