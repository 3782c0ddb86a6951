// pack_mix: 2-bit packed bases -> splitmix64-mixed canonical k-mer pairs.
//
// Replaces panagram_tpu/ops/pallas_kernels.py pack_mix_pallas
// (_pack_mix_kernel).  For each position p < Ppad:
//   * the little-endian 2-bit window W = sum_t base[p+t] << 2t, masked to
//     2k bits, comes from the packed stream (4 bases per byte);
//   * forward k-mer = pair_reverse(W) >> (64 - 2k), reverse complement =
//     ~W & (4^k - 1), canonical = the smaller;
//   * a window holding an N (bit set in the N-mask over [p, p+k)) takes the
//     all-ones SENTINEL before mixing;
//   * the splitmix64 finalizer, in native 64-bit arithmetic (the TPU kernel
//     built it from 16-bit limbs because Mosaic had no u64 multiply);
//   * positions p >= P = L - k + 1 are padding: the all-ones pair.
// Output is POSITIONAL (hi[p], lo[p]); the TPU kernel's phase-major order
// was a layout choice of its vector unit.  Bytes past the end of `packed`
// read as 0, bytes past the end of `nmask` as 0xFF.
//
// Bound: bytes, 8 B out and 3/8 B in per position.  The arithmetic is of
// the same order (two 64-bit multiplies, a pair reverse and a 64-bit
// minimum per position on 32-bit integer units), so the design keeps the
// instructions per position low and the stores wide:
//   * One thread does the four positions of one packed byte b.  It loads
//     the 72-bit window (bytes b..b+8) once, as three aligned 32-bit words
//     joined by funnel shifts; the four windows are that window shifted by
//     0, 2, 4 and 6 bits.  The N-mask bits of the four positions come from
//     two aligned words the same way.
//   * The pairs are reversed once per thread: __brevll and one swap within
//     each pair give R = pair_reverse(bytes b..b+7), a bit reverse of the
//     ninth byte gives its four pairs, and position r's forward k-mer is
//     ((R << 2r) | (ninth's pairs >> (8 - 2r))) >> (64 - 2k), two funnel
//     shifts.  Only the one group that P cuts tests its positions for
//     padding.
//   * Loads go straight through L1, not through a staged tile: the input
//     is 3/8 B per position, the threads of a warp read 40 neighbouring
//     bytes of it (two sectors per request), and a tile in shared memory
//     would cost the same number of load instructions plus a barrier per
//     tile.  Bounds are checked per thread, not per byte: a thread whose
//     words all lie inside the stream takes them unchecked, the few at the
//     stream's end gather byte by byte.  The words are aligned down from
//     the byte pointers, so a byte-aligned slice (`ib[n4:]`) costs nothing;
//     the word that holds a slice's first byte lies in the same allocation.
//   * Each thread writes hi[4b..4b+3] and lo[4b..4b+3] as one 128-bit store
//     each when both outputs are 16-byte aligned (the entry point
//     dispatches on the pointers); the last, partial group and unaligned
//     outputs are stored word by word, never past Ppad.
//   * k = 31 and k = 21 have instances with k as a constant (their shifts
//     and masks fold); any other k takes the instance that reads it.
//   * The grid is capped (max_blocks, from the wrapper: 16 blocks per SM
//     read as well as 32 and better than 8) and loops.  No shared memory,
//     no shuffles, no scratch: concurrent launches from several streams
//     share nothing.
// On an NVIDIA H100 80GB HBM3 at 700.00 W a 2^22-position chunk at k=31
// takes 0.0192-0.0199 ms with the L2 flushed before the launch and
// 0.0166-0.0172 ms with launches queued back to back
// (tools/kernel_times.py, chip_smoke.py), against a byte bound of 0.0105 ms
// at 3.35 TB/s: 0.53 of the bound.  The kernel it replaced (one thread per
// position, 17 byte-wide bounds-checked loads each, five mask-and-shift
// stages for the reverse) took 0.0517-0.0523 / 0.0491-0.0495 ms in the
// same calls.  What is left is integer work, most of it the two 64-bit
// multiplies, three 64-bit shift-xors and the 64-bit minimum per position
// on 32-bit units: with the L2 holding every buffer the kernel is still
// 1.6 times its byte bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kM1 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kM2 = 0x94D049BB133111EBULL;
constexpr unsigned long long kPairLow = 0x5555555555555555ULL;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
    x ^= x >> 30;
    x *= kM1;
    x ^= x >> 27;
    x *= kM2;
    x ^= x >> 31;
    return x;
}

// reverse the order of the 32 2-bit pairs of x (pairs stay intact): the bit
// reverse also swaps the two bits of each pair, which one swap undoes
__device__ __forceinline__ unsigned long long pair_reverse64(unsigned long long x) {
    const unsigned long long y = __brevll(x);
    return ((y & kPairLow) << 1) | ((y >> 1) & kPairLow);
}

// the same for the 4 pairs of a byte
__device__ __forceinline__ uint32_t pair_reverse8(uint32_t e) {
    const uint32_t y = __brev(e) >> 24;
    return ((y & 0x55u) << 1) | ((y >> 1) & 0x55u);
}

// little-endian value of bytes [b, b+count) of a stream of n bytes, count
// <= 8; bytes past the end read as `fill`
__device__ __forceinline__ unsigned long long gather_bytes(const uint8_t* __restrict__ s,
                                                           long long b, long long n,
                                                           int count, unsigned long long fill) {
    unsigned long long v = 0;
    for (int t = 0; t < count; ++t) {
        const long long i = b + t;
        v |= (i < n ? (unsigned long long)s[i] : fill) << (8 * t);
    }
    return v;
}

template <int KT, bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_mix_kernel(const uint8_t* __restrict__ packed, long long npacked,
                const uint8_t* __restrict__ nmask, long long nnmask, int k_arg,
                long long P, long long Ppad, uint32_t* __restrict__ out_hi,
                uint32_t* __restrict__ out_lo) {
    const int k = KT ? KT : k_arg;                               // 1 <= k <= 31
    const unsigned long long mask2k = (1ULL << (2 * k)) - 1ULL;  // 2k <= 62
    const uint32_t kmask = (1u << k) - 1u;
    const int fshift = 64 - 2 * k;
    // the streams as aligned words: byte j of `packed` is byte j + ap of pw
    const unsigned ap = (unsigned)((uintptr_t)packed & 3u);
    const unsigned an = (unsigned)((uintptr_t)nmask & 3u);
    const uint32_t* __restrict__ pw = (const uint32_t*)(packed - ap);
    const uint32_t* __restrict__ nw = (const uint32_t*)(nmask - an);
    const long long pwords = ((long long)ap + npacked) >> 2;  // words that end inside
    const long long nwords = ((long long)an + nnmask) >> 2;
    const long long groups = (Ppad + 3) >> 2;
    const long long step = (long long)gridDim.x * kThreads;

    for (long long b = (long long)blockIdx.x * kThreads + threadIdx.x; b < groups; b += step) {
        const long long p0 = b << 2;
        uint32_t hi[4], lo[4];
        if (p0 >= P) {
#pragma unroll
            for (int r = 0; r < 4; ++r) hi[r] = lo[r] = 0xFFFFFFFFu;
        } else {
            // D = bytes b..b+7, e = byte b+8
            unsigned long long D;
            uint32_t e;
            const long long g = b + ap;
            const long long wi = g >> 2;
            if (wi + 3 <= pwords) {
                const uint32_t w0 = pw[wi], w1 = pw[wi + 1], w2 = pw[wi + 2];
                const unsigned sh = 8u * (unsigned)(g & 3);
                D = ((unsigned long long)__funnelshift_r(w1, w2, sh) << 32)
                    | __funnelshift_r(w0, w1, sh);
                e = (w2 >> sh) & 0xFFu;
            } else {
                D = gather_bytes(packed, b, npacked, 8, 0ULL);
                e = (uint32_t)gather_bytes(packed, b + 8, npacked, 1, 0ULL);
            }
            // nm: the N-mask bits from position p0 on (at least 3 + k of them)
            unsigned long long nm;
            const long long nb = b >> 1;
            const unsigned o = ((unsigned)b & 1u) << 2;
            const long long gn = nb + an;
            const long long wj = gn >> 2;
            if (wj + 2 <= nwords) {
                nm = (((unsigned long long)nw[wj + 1] << 32) | nw[wj])
                     >> (8u * (unsigned)(gn & 3) + o);   // <= 28: 36 bits or more stay
            } else {
                nm = gather_bytes(nmask, nb, nnmask, 5, 0xFFULL) >> o;
            }

            const unsigned long long R = pair_reverse64(D);
            const uint32_t r_lo = (uint32_t)R, r_hi = (uint32_t)(R >> 32);
            const uint32_t re_top = pair_reverse8(e) << 24;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                // w = W_r before masking; rw = its pair reverse, which is
                // (re_top : R) shifted left by 2r, upper 64 bits
                unsigned long long w = D, rw = R;
                if (r) {
                    w = (D >> (2 * r)) | ((unsigned long long)e << (64 - 2 * r));
                    rw = ((unsigned long long)__funnelshift_l(r_lo, r_hi, 2 * r) << 32)
                         | __funnelshift_l(re_top, r_lo, 2 * r);
                }
                w &= mask2k;
                const unsigned long long fwd = rw >> fshift;
                const unsigned long long rc = w ^ mask2k;
                const unsigned long long canon = fwd < rc ? fwd : rc;
                const bool bad = ((uint32_t)(nm >> r) & kmask) != 0u;
                const unsigned long long x = mix64(bad ? ~0ULL : canon);
                hi[r] = (uint32_t)(x >> 32);
                lo[r] = (uint32_t)x;
            }
            if (p0 + 4 > P) {   // the one group that P cuts
#pragma unroll
                for (int r = 1; r < 4; ++r) {
                    if (p0 + r >= P) hi[r] = lo[r] = 0xFFFFFFFFu;
                }
            }
        }
        if (VEC && p0 + 4 <= Ppad) {
            reinterpret_cast<uint4*>(out_hi)[b] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            reinterpret_cast<uint4*>(out_lo)[b] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (p0 + r < Ppad) {
                    out_hi[p0 + r] = hi[r];
                    out_lo[p0 + r] = lo[r];
                }
            }
        }
    }
}

template <int KT>
void launch(bool vec, unsigned int blocks, cudaStream_t stream, const uint8_t* packed,
            long long npacked, const uint8_t* nmask, long long nnmask, int k, long long P,
            long long Ppad, uint32_t* out_hi, uint32_t* out_lo) {
    if (vec) {
        pack_mix_kernel<KT, true><<<blocks, kThreads, 0, stream>>>(
            packed, npacked, nmask, nnmask, k, P, Ppad, out_hi, out_lo);
    } else {
        pack_mix_kernel<KT, false><<<blocks, kThreads, 0, stream>>>(
            packed, npacked, nmask, nnmask, k, P, Ppad, out_hi, out_lo);
    }
}

}  // namespace

extern "C" int pg_pack_mix(const void* packed, long long npacked, const void* nmask,
                           long long nnmask, int k, long long P, long long Ppad,
                           void* out_hi, void* out_lo, int max_blocks, void* stream) {
    if (Ppad <= 0) return 0;
    if (k < 1 || k > 31 || max_blocks < 1) return (int)cudaErrorInvalidValue;
    const long long groups = (Ppad + 3) >> 2;
    const long long want = (groups + kThreads - 1) / kThreads;
    const unsigned int blocks = (unsigned int)(want < max_blocks ? want : max_blocks);
    const bool vec = ((((uintptr_t)out_hi) | ((uintptr_t)out_lo)) & 15u) == 0;
    const uint8_t* pk = (const uint8_t*)packed;
    const uint8_t* nm = (const uint8_t*)nmask;
    uint32_t* hi = (uint32_t*)out_hi;
    uint32_t* lo = (uint32_t*)out_lo;
    cudaStream_t s = (cudaStream_t)stream;
    if (k == 31) {
        launch<31>(vec, blocks, s, pk, npacked, nm, nnmask, k, P, Ppad, hi, lo);
    } else if (k == 21) {
        launch<21>(vec, blocks, s, pk, npacked, nm, nnmask, k, P, Ppad, hi, lo);
    } else {
        launch<0>(vec, blocks, s, pk, npacked, nm, nnmask, k, P, Ppad, hi, lo);
    }
    return (int)cudaGetLastError();
}
