// PoST proving scan and proving hash, one thread per label lane.
//
// The scan replaces spacemesh_tpu/ops/proving_pallas.py::_kernel. For each
// of n_nonces consecutive nonces, one Salsa20/8 over the 16-word state
//
//   challenge(8 LE words) || nonce0+k || idx_lo || idx_hi || 0 || label(4 LE)
//
// and hit = (x0 + challenge[0]) < thr (unsigned) and lane < valid. The
// label words and the index stay in registers across the nonce loop, so a
// label is read from device memory once per nonce group. Outputs:
//
//   mask (n_nonces, B) int8   per-lane hit flag
//   seg  (n_nonces, B/64) i32 hits per 64-lane segment
//
// A segment spans two warps: each warp's count is __popc(__ballot_sync),
// and the pair is summed through shared memory (double-buffered on the
// nonce parity, so one __syncthreads per nonce suffices).
//
// Bound: about 400 integer instructions per (label, nonce) pair against
// 24 bytes read per label and n_nonces * (1 + 4/64) bytes written, so the
// scan is bound by the warp-instruction rate.
//
// The proving hash (hash_kernel) replaces the XLA program of
// spacemesh_tpu/ops/proving.py::proving_hash_jit, which has no Pallas
// kernel: one Salsa20/8 per (proof, index) lane, with the challenge and
// nonce shared or per lane, returning x0 + challenge[0]. It takes the
// label words little-endian as the scan does, or big-endian (be_labels:
// swapped on load). The verifier no longer launches it: pbkdf2.cu's
// finish runs the same hash as its epilogue on the label words it holds
// in registers. It serves labels that come from the host
// (ops/proving.py:proving_hashes). Bound: about 390 integer instructions
// per lane against at most 64 bytes moved; at a few thousand lanes
// launch latency sets its time. Both kernels run the rounds through
// salsa20_8_rounds (salsa.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "salsa.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegment = 64;

struct Challenge {
    uint32_t w[8];
};

__global__ void __launch_bounds__(kThreads)
scan_kernel(Challenge ch, uint32_t nonce0, uint32_t thr,
            unsigned long long valid, const uint32_t* __restrict__ idx_lo,
            const uint32_t* __restrict__ idx_hi,
            const uint32_t* __restrict__ lw, int8_t* __restrict__ mask,
            int32_t* __restrict__ seg, long long b, int n_nonces) {
    __shared__ int warp_hits[2][kWarps];
    const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool in = lane < b;
    uint32_t lo = 0, hi = 0, l0 = 0, l1 = 0, l2 = 0, l3 = 0;
    if (in) {
        lo = idx_lo[lane];
        hi = idx_hi[lane];
        l0 = lw[lane];
        l1 = lw[(size_t)b + lane];
        l2 = lw[2 * (size_t)b + lane];
        l3 = lw[3 * (size_t)b + lane];
    }
    const bool alive = in && (unsigned long long)lane < valid;
    const int warp = threadIdx.x >> 5;
    const long long nseg = b / kSegment;
    for (int k = 0; k < n_nonces; ++k) {
        uint32_t x[16] = {ch.w[0], ch.w[1], ch.w[2], ch.w[3],
                          ch.w[4], ch.w[5], ch.w[6], ch.w[7],
                          nonce0 + (uint32_t)k, lo, hi, 0u, l0, l1, l2, l3};
        salsa20_8_rounds(x);
        const bool hit = alive && (x[0] + ch.w[0]) < thr;
        if (in) mask[(size_t)k * b + lane] = hit ? 1 : 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        const int slot = k & 1;
        if ((threadIdx.x & 31) == 0) warp_hits[slot][warp] = __popc(ballot);
        __syncthreads();
        if (threadIdx.x < kWarps / 2) {
            const long long s =
                (long long)blockIdx.x * (kWarps / 2) + threadIdx.x;
            if (s < nseg)
                seg[(size_t)k * nseg + s] = warp_hits[slot][2 * threadIdx.x] +
                                            warp_hits[slot][2 * threadIdx.x + 1];
        }
    }
}

// challenge: 8 host u32 words. idx_lo/idx_hi: (B,) u32; lw: (4, B) u32 LE;
// mask: (n_nonces, B) int8; seg: (n_nonces, B/64) int32. B must be a
// multiple of 64. Returns cudaGetLastError().
extern "C" int proving_scan_launch(const uint32_t* challenge, uint32_t nonce0,
                                   uint32_t thr, unsigned long long valid,
                                   const void* idx_lo, const void* idx_hi,
                                   const void* lw, void* mask, void* seg,
                                   long long b, int n_nonces, void* stream) {
    if (b <= 0 || n_nonces <= 0) return 0;
    Challenge ch;
    for (int i = 0; i < 8; ++i) ch.w[i] = challenge[i];
    const long long blocks = (b + kThreads - 1) / kThreads;
    scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ch, nonce0, thr, valid, (const uint32_t*)idx_lo,
        (const uint32_t*)idx_hi, (const uint32_t*)lw, (int8_t*)mask,
        (int32_t*)seg, b, n_nonces);
    return (int)cudaGetLastError();
}

constexpr unsigned kHashMaxThreads = 256;

__global__ void __launch_bounds__(kHashMaxThreads)
hash_kernel(const uint32_t* __restrict__ cw, long long cws, long long cls,
            const uint32_t* __restrict__ nonce, long long nls,
            uint32_t nonce_value, const uint32_t* __restrict__ idx_lo,
            const uint32_t* __restrict__ idx_hi,
            const uint32_t* __restrict__ lw, int be_labels,
            uint32_t* __restrict__ out, long long b) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= b) return;
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = cw[i * cws + lane * cls];
    x[8] = nonce ? nonce[lane * nls] : nonce_value;
    x[9] = idx_lo[lane];
    x[10] = idx_hi[lane];
    x[11] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t v = lw[(size_t)i * b + lane];
        x[12 + i] = be_labels ? __byte_perm(v, 0, 0x0123) : v;
    }
    const uint32_t c0 = x[0];
    salsa20_8_rounds(x);
    out[lane] = x[0] + c0;
}

// cw: 8 u32 challenge words at cw[w * cws + lane * cls] (cls = 0: shared);
// nonce: u32 at nonce[lane * nls], or nonce_value for every lane when
// nonce is null; idx_lo/idx_hi: (B,) u32; lw: (4, B) u32 label words, LE,
// or BE when be_labels; out: (B,) u32. Returns cudaGetLastError().
extern "C" int proving_hash_launch(const void* cw, long long cws,
                                   long long cls, const void* nonce,
                                   long long nls, uint32_t nonce_value,
                                   const void* idx_lo, const void* idx_hi,
                                   const void* lw, int be_labels, void* out,
                                   long long b, void* stream) {
    if (b <= 0) return 0;
    const unsigned block = spread_threads(b, kHashMaxThreads);
    hash_kernel<<<blocks_of(b, block), block, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cw, cws, cls, (const uint32_t*)nonce, nls,
        nonce_value, (const uint32_t*)idx_lo, (const uint32_t*)idx_hi,
        (const uint32_t*)lw, be_labels, (uint32_t*)out, b);
    return (int)cudaGetLastError();
}
