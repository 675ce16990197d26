// Host-side launch geometry shared by the one-thread-per-item kernels
// (pbkdf2.cu, proving_scan.cu's proving hash, k2pow.cu).
//
// Those kernels are chains of dependent integer rounds with nothing to
// share between threads but a few midstates, so the block size only
// decides how the threads are spread: all blocks of a launch are resident
// at once, and the launch lasts as long as its busiest SM. spread_threads
// picks the block size that puts the fewest threads on the busiest SM, so
// that a batch of a few thousand items is not packed into a few wide
// blocks on part of the card, nor split unevenly over it. A block keeps
// at least four warps, one per SM partition: the kernels are thousands of
// unrolled instructions, and warps on one SM share their fetch: blocks of
// one warp, one per SM, measured slower on small batches than blocks of
// four on fewer SMs (PBKDF2 finish at 1037 lanes).

#pragma once

#include <cuda_runtime.h>

// Streaming multiprocessors of the current device, read once.
static int sm_count() {
    static int count = 0;
    if (count == 0) {
        int dev = 0, n = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        count = n > 0 ? n : 132;
    }
    return count;
}

constexpr unsigned kMinBlockThreads = 128;

// Threads per block for `threads` threads in all: the power of two from
// kMinBlockThreads to max_threads whose blocks put the fewest threads on
// the busiest SM (the widest on a tie).
static unsigned spread_threads(long long threads, unsigned max_threads) {
    const long long sms = sm_count();
    unsigned best = max_threads;
    long long best_load = -1;
    for (unsigned t = max_threads; t >= kMinBlockThreads; t >>= 1) {
        const long long blocks = (threads + t - 1) / t;
        const long long load = (blocks + sms - 1) / sms * t;
        if (best_load < 0 || load < best_load) {
            best = t;
            best_load = load;
        }
    }
    return best;
}

static unsigned blocks_of(long long threads, unsigned block) {
    return (unsigned)((threads + block - 1) / block);
}
