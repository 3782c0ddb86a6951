// pack_bases: one base code per byte -> the 2-bit packed bases and N-mask
// of ops/codec.pack_bases_np, byte for byte.
//
// Replaces no TPU kernel: panagram_tpu packs on the host
// (panagram_tpu/ops/codec.py pack_bases_np) and uploads the packed bytes.
// Here the anchor stream (ops/anchor.stream_anchor_chunks) uploads the raw
// codes of a chunk and this kernel packs them on the card, so the host's
// share of a chunk is one copy into its pinned staging buffer.
//
// Layout: L bases -> packed[ceil(L/4)], base i in bits 2(i%4)..2(i%4)+1 of
// byte i/4, and nmask[ceil(L/8)], bit i%8 of byte i/8 set when base i is
// not ACGT (code >= 4).  A base that is not ACGT packs as 0.  Bases at
// nvalid <= i < L are not ACGT whatever the codes hold there, and codes at
// or past nvalid are never read: the stream's staging buffer holds an
// earlier chunk's codes there.  Bits of the last bytes past L are 0.
//
// Bound: bytes, 1 in and 3/8 out per base, and a handful of integer
// instructions per 8 bases, so the design is about wide, coalesced memory
// access:
//   * One thread does 8 bases: one 64-bit load (a warp reads 256
//     consecutive bytes), then SWAR on the word: a byte is not ACGT when
//     any of its bits 2-7 is set, found for all 8 bytes at once without
//     carries between bytes; the 8 flags are gathered into the mask byte
//     by one multiply; the bases, with the bad ones cleared, are folded
//     from bytes into 2-bit fields by three shift-or-mask steps.
//   * One 16-bit store of the packed bases (a warp writes 64 consecutive
//     bytes) and one mask byte (32).
//   * The thread that nvalid or L cuts, and every thread when the codes are
//     not 8-byte aligned or the packed output not 2-byte aligned, reads
//     byte by byte and stores byte by byte; nothing past L's bytes is
//     written and nothing at or past nvalid read.
//   * The grid is capped at 16 blocks per SM and loops; no shared memory,
//     nothing shared between launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;
constexpr uint64_t kHigh = 0x8080808080808080ULL;
constexpr uint64_t kNotBase = 0xFCFCFCFCFCFCFCFCULL;
constexpr uint64_t kTwoBits = 0x0303030303030303ULL;
// bit 8j -> bit 56 + j for j = 0..7 (no two products overlap)
constexpr uint64_t kGather = 0x0102040810204080ULL;

// 8 codes, byte j = base j -> 16 bits of packed bases and 8 mask bits.
__device__ __forceinline__ void pack8(uint64_t v, uint32_t& bases, uint32_t& nbits) {
    const uint64_t x = v & kNotBase;
    // 0x80 in each byte of x that is nonzero: (x & 0x7F) + 0x7F <= 0xFE
    // never carries into the next byte
    const uint64_t bad = ((((x & kLow7) + kLow7) | x) & kHigh) >> 7;
    nbits = (uint32_t)((bad * kGather) >> 56);
    uint64_t c = v & ~(bad * 0xFF) & kTwoBits;
    c = (c | (c >> 6)) & 0x000F000F000F000FULL;    // 2 bases a 16-bit lane
    c = (c | (c >> 12)) & 0x000000FF000000FFULL;   // 4 a 32-bit lane
    bases = (uint32_t)((c | (c >> 24)) & 0xFFFF);  // 8
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_bases_kernel(const uint8_t* __restrict__ codes, long long nvalid, long long L,
                  uint8_t* __restrict__ packed, uint8_t* __restrict__ nmask) {
    const long long groups = (L + 7) >> 3;
    const long long n4 = (L + 3) >> 2;
    const long long step = (long long)gridDim.x * kThreads;
    for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups; g += step) {
        const long long i0 = g << 3;
        const bool whole = i0 + 8 <= nvalid;   // then also i0 + 8 <= L
        uint64_t v;
        if (VEC && whole) {
            v = __ldg(reinterpret_cast<const unsigned long long*>(codes) + g);
        } else {
            v = ~0ULL;   // bases at or past nvalid read as 0xFF: not ACGT
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (i0 + j < nvalid)
                    v = (v & ~(0xFFULL << (8 * j))) | ((uint64_t)codes[i0 + j] << (8 * j));
        }
        uint32_t bases, nbits;
        pack8(v, bases, nbits);
        if (i0 + 8 > L) nbits &= (1u << (L - i0)) - 1u;   // no mask bit past L
        const long long b = g << 1;
        if (VEC && b + 2 <= n4) {
            *reinterpret_cast<uint16_t*>(packed + b) = (uint16_t)bases;
        } else {
            packed[b] = (uint8_t)bases;
            if (b + 1 < n4) packed[b + 1] = (uint8_t)(bases >> 8);
        }
        nmask[g] = (uint8_t)nbits;
    }
}

}  // namespace

extern "C" int pg_pack_bases(const void* codes, long long nvalid, long long L, void* packed,
                             void* nmask, void* stream) {
    if (L <= 0) return 0;
    if (nvalid < 0 || nvalid > L) return (int)cudaErrorInvalidValue;
    const long long groups = (L + 7) >> 3;
    const long long want = (groups + kThreads - 1) / kThreads;
    const unsigned int blocks = (unsigned int)(want < kMaxBlocks ? want : kMaxBlocks);
    const bool vec = ((((uintptr_t)codes) & 7u) | (((uintptr_t)packed) & 1u)) == 0;
    const uint8_t* c = (const uint8_t*)codes;
    uint8_t* p = (uint8_t*)packed;
    uint8_t* m = (uint8_t*)nmask;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        pack_bases_kernel<true><<<blocks, kThreads, 0, s>>>(c, nvalid, L, p, m);
    else
        pack_bases_kernel<false><<<blocks, kThreads, 0, s>>>(c, nvalid, L, p, m);
    return (int)cudaGetLastError();
}
