// pack_mix: 2-bit packed bases -> splitmix64-mixed canonical k-mer pairs.
//
// Replaces panagram_tpu/ops/pallas_kernels.py pack_mix_pallas
// (_pack_mix_kernel).  One thread per position p < Ppad:
//   * the little-endian 2-bit window W = sum_t base[p+t] << 2t comes from 9
//     bytes of the packed stream (4 bases per byte);
//   * forward k-mer = pair_reverse(W) >> (64 - 2k), reverse complement =
//     ~W & (4^k - 1), canonical = the smaller;
//   * a window holding an N (bit set in the N-mask over [p, p+k)) takes the
//     all-ones SENTINEL before mixing;
//   * the splitmix64 finalizer, in native 64-bit arithmetic (the TPU kernel
//     built it from 16-bit limbs because Mosaic had no u64 multiply);
//   * positions p >= P = L - k + 1 are padding: the all-ones pair.
// Output is POSITIONAL (hi[p], lo[p]); the TPU kernel's phase-major order
// was a layout choice of its vector unit.
//
// Bound: it moves 8 B out and 3/8 B in per position, but on an H100
// 80GB HBM3 at 700 W a 2^22-position chunk takes ~0.07 ms, about 0.5 TB/s:
// the 17 byte-wide loads and the emulated 64-bit multiplies per position
// set the time, not the bytes.  Neighbouring threads read overlapping
// bytes, which the L1 cache serves, and write neighbouring words, so the
// stores coalesce; word-wide loads are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kM1 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kM2 = 0x94D049BB133111EBULL;
constexpr unsigned long long kSentinel = 0xFFFFFFFFFFFFFFFFULL;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
    x ^= x >> 30;
    x *= kM1;
    x ^= x >> 27;
    x *= kM2;
    x ^= x >> 31;
    return x;
}

// reverse the order of the 32 2-bit pairs of x (pairs stay intact)
__device__ __forceinline__ unsigned long long pair_reverse64(unsigned long long x) {
    x = (x << 32) | (x >> 32);
    x = ((x & 0x0000FFFF0000FFFFULL) << 16) | ((x >> 16) & 0x0000FFFF0000FFFFULL);
    x = ((x & 0x00FF00FF00FF00FFULL) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
    return x;
}

// little-endian u64 from bytes [b, b+8) of a stream of n bytes; bytes past
// the end read as `fill`
__device__ __forceinline__ unsigned long long load8(const uint8_t* __restrict__ s,
                                                    long long b, long long n,
                                                    unsigned long long fill) {
    unsigned long long v = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
        const long long i = b + t;
        const unsigned long long byte = i < n ? (unsigned long long)s[i] : fill;
        v |= byte << (8 * t);
    }
    return v;
}

__global__ void pack_mix_kernel(const uint8_t* __restrict__ packed, long long npacked,
                                const uint8_t* __restrict__ nmask, long long nnmask,
                                int k, long long P, long long Ppad,
                                uint32_t* __restrict__ out_hi,
                                uint32_t* __restrict__ out_lo) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= Ppad) return;
    if (p >= P) {
        out_hi[p] = 0xFFFFFFFFu;
        out_lo[p] = 0xFFFFFFFFu;
        return;
    }
    const long long b = p >> 2;
    const int r = (int)(p & 3);
    unsigned long long w = load8(packed, b, npacked, 0);
    if (r) {
        const unsigned long long e = b + 8 < npacked ? (unsigned long long)packed[b + 8] : 0ULL;
        w = (w >> (2 * r)) | (e << (64 - 2 * r));
    }
    const unsigned long long mask2k = (1ULL << (2 * k)) - 1ULL;  // 2k <= 62
    w &= mask2k;
    const unsigned long long fwd = pair_reverse64(w) >> (64 - 2 * k);
    const unsigned long long rc = ~w & mask2k;
    const unsigned long long canon = fwd < rc ? fwd : rc;

    const unsigned long long nm = load8(nmask, p >> 3, nnmask, 0xFFULL);
    const bool bad = ((nm >> (int)(p & 7)) & ((1ULL << k) - 1ULL)) != 0ULL;

    const unsigned long long x = mix64(bad ? kSentinel : canon);
    out_hi[p] = (uint32_t)(x >> 32);
    out_lo[p] = (uint32_t)(x & 0xFFFFFFFFULL);
}

}  // namespace

extern "C" int pg_pack_mix(const void* packed, long long npacked, const void* nmask,
                           long long nnmask, int k, long long P, long long Ppad,
                           void* out_hi, void* out_lo, void* stream) {
    const int threads = 256;
    const long long blocks = (Ppad + threads - 1) / threads;
    pack_mix_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)packed, npacked, (const uint8_t*)nmask, nnmask, k, P, Ppad,
        (uint32_t*)out_hi, (uint32_t*)out_lo);
    return (int)cudaGetLastError();
}
