// scrypt ROMix (r=1) for the PoST label pipeline, four threads per lane.
//
// Replaces spacemesh_tpu/ops/romix_pallas.py::_romix_kernel.
//
//   fill: for i < N:  V[lane][i] = x;  x = BlockMix(x)
//   mix:  N times:    j = x[16] & (N-1);  x = BlockMix(x ^ V[lane][j])
//
// Bound: about 13.9 M integer instructions per lane at N=8192 (16384
// BlockMix of 832 add/rotate/xor, plus the mix xors) against 256 bytes of
// input and output per lane, so the instruction rate bounds the function.
// The V scratch adds N*256 bytes of device traffic per lane (2 MiB at
// N=8192): a floor above the instruction bound that only a time-memory
// trade-off goes below. V is N*128 bytes per lane, so the card's memory
// caps the lanes in flight (32768 lanes hold 32 GiB at N=8192).
//
// Design. With one thread per lane, those lanes give about 2 warps per
// scheduler, too few to hide a quarter round's dependency chain or the
// dependent random read of each mix step, and every 16-byte V access of a
// warp touches 32 lines 1 MiB apart. So a quad of threads carries one
// lane: thread q holds the 4 words of Salsa column q in each 16-word half,
// in the diagonal order of spacemesh_tpu/ops/scrypt.py::salsa20_8
// (word (4r + 5q) mod 16 in role r = a, b, c, d). The column round is one
// quarter round in each thread; the row round is the same quarter round
// after b, c, d are rotated across the quad by __shfl_sync, and rotated
// back after it (6 shuffles per double round; ptxas issues each as soon as
// its word is final, so its latency overlaps the rest of the round). A lane's V row is one
// 128-byte line in the quad's own word order: thread q stores and loads
// its column of each half as one 16-byte access, so a warp instruction
// moves 64 contiguous bytes of each of 8 lines. Integerify's x[16] is word
// 0 of the second half, in thread 0 of the quad, and reaches the other
// three by a shuffle. Each lane's V stays contiguous (N rows of 128
// bytes), so the random reads of a block stay inside its own lanes' pages. 4 x 32768 threads fill the card at 32 warps per SM within 64
// registers a thread.
//
// Input and output are (32, B) words-major, lane-minor: word w of lane l
// sits at [w * ld + l]. All offsets into V are size_t.

#include <cstdint>
#include <cuda_runtime.h>

#define ROTL(v, n) __funnelshift_l((v), (v), (n))

constexpr int kThreads = 128;  // 32 lanes a block
constexpr unsigned kFull = 0xffffffffu;

// Salsa20/8 of one 16-word half held by a quad: (a, b, c, d) are the
// words of column q; feed-forward included.
__device__ __forceinline__ void salsa20_8_quad(uint32_t& a, uint32_t& b,
                                               uint32_t& c, uint32_t& d,
                                               int q) {
    const uint32_t a0 = a, b0 = b, c0 = c, d0 = d;
    const int prev = (q + 3) & 3, opp = (q + 2) & 3, next = (q + 1) & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        // column round: quarter round of column q
        b ^= ROTL(a + d, 7);
        c ^= ROTL(b + a, 9);
        d ^= ROTL(c + b, 13);
        a ^= ROTL(d + c, 18);
        // row round: roll b by 1, c by 2, d by 3 across the quad
        b = __shfl_sync(kFull, b, prev, 4);
        c = __shfl_sync(kFull, c, opp, 4);
        d = __shfl_sync(kFull, d, next, 4);
        d ^= ROTL(a + b, 7);
        c ^= ROTL(d + a, 9);
        b ^= ROTL(c + d, 13);
        a ^= ROTL(b + c, 18);
        b = __shfl_sync(kFull, b, next, 4);
        c = __shfl_sync(kFull, c, opp, 4);
        d = __shfl_sync(kFull, d, prev, 4);
    }
    a += a0; b += b0; c += c0; d += d0;
}

struct Half {
    uint32_t a, b, c, d;
};

// BlockMix r=1 in place: y0 = salsa(x0 ^ x1), y1 = salsa(x1 ^ y0).
__device__ __forceinline__ void blockmix_quad(Half& x0, Half& x1, int q) {
    x0.a ^= x1.a; x0.b ^= x1.b; x0.c ^= x1.c; x0.d ^= x1.d;
    salsa20_8_quad(x0.a, x0.b, x0.c, x0.d, q);
    x1.a ^= x0.a; x1.b ^= x0.b; x1.c ^= x0.c; x1.d ^= x0.d;
    salsa20_8_quad(x1.a, x1.b, x1.c, x1.d, q);
}

__global__ void __launch_bounds__(kThreads, 8)
romix_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
             uint4* __restrict__ V, long long ld, long long lanes,
             uint32_t n, int mix_phase) {
    const int q = threadIdx.x & 3;
    const long long lane = (long long)blockIdx.x * (kThreads / 4) +
                           (threadIdx.x >> 2);
    // a quad past the batch computes on zeros and touches no memory, so
    // every shuffle keeps the whole warp
    const bool active = lane < lanes;
    // word (4r + 5q) mod 16 of each half, roles r = a, b, c, d
    const int wa = (5 * q) & 15, wb = (4 + 5 * q) & 15;
    const int wc = (8 + 5 * q) & 15, wd = (12 + 5 * q) & 15;
    Half x0 = {0u, 0u, 0u, 0u}, x1 = {0u, 0u, 0u, 0u};
    if (active) {
        x0 = {in[wa * ld + lane], in[wb * ld + lane], in[wc * ld + lane],
              in[wd * ld + lane]};
        x1 = {in[(16 + wa) * ld + lane], in[(16 + wb) * ld + lane],
              in[(16 + wc) * ld + lane], in[(16 + wd) * ld + lane]};
    }
    // row i of this lane is 8 uint4 at row + 8 i, of which this thread
    // owns uint4 q (its column of the first half) and 4 + q
    uint4* row = V + (size_t)(active ? lane : 0) * n * 8 + q;
#pragma unroll 1
    for (uint32_t i = 0; i < n; ++i) {
        if (active) {
            __stcg(row + (size_t)i * 8, make_uint4(x0.a, x0.b, x0.c, x0.d));
            __stcg(row + (size_t)i * 8 + 4,
                   make_uint4(x1.a, x1.b, x1.c, x1.d));
        }
        blockmix_quad(x0, x1, q);
    }
    const uint32_t mask = n - 1;
    const uint32_t steps = mix_phase ? n : 0u;
#pragma unroll 1
    for (uint32_t i = 0; i < steps; ++i) {
        // Integerify: x[16] is word 0 of the second half, held by q = 0
        const uint32_t j = __shfl_sync(kFull, x1.a, 0, 4) & mask;
        if (active) {
            const uint4 v0 = __ldcg(row + (size_t)j * 8);
            const uint4 v1 = __ldcg(row + (size_t)j * 8 + 4);
            x0.a ^= v0.x; x0.b ^= v0.y; x0.c ^= v0.z; x0.d ^= v0.w;
            x1.a ^= v1.x; x1.b ^= v1.y; x1.c ^= v1.z; x1.d ^= v1.w;
        }
        blockmix_quad(x0, x1, q);
    }
    if (active) {
        out[wa * ld + lane] = x0.a;
        out[wb * ld + lane] = x0.b;
        out[wc * ld + lane] = x0.c;
        out[wd * ld + lane] = x0.d;
        out[(16 + wa) * ld + lane] = x1.a;
        out[(16 + wb) * ld + lane] = x1.b;
        out[(16 + wc) * ld + lane] = x1.c;
        out[(16 + wd) * ld + lane] = x1.d;
    }
}

// in/out: the first lane of a (32, ld) words-major block; V: scratch of
// lanes * n * 128 bytes. n must be a power of two. mix_phase 0 stops
// after the fill. Returns cudaGetLastError().
extern "C" int romix_r1_launch(const void* in, void* out, void* V,
                               long long ld, long long lanes, int n,
                               int mix_phase, void* stream) {
    if (lanes <= 0) return 0;
    const long long per_block = kThreads / 4;
    const long long blocks = (lanes + per_block - 1) / per_block;
    romix_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, (uint4*)V, ld, lanes,
        (uint32_t)n, mix_phase);
    return (int)cudaGetLastError();
}
