// fused_popcount_colsums: one pass over mask rows -> popcount per row and
// per-genome column totals.
//
// Replaces panagram_tpu/ops/pallas_kernels.py fused_popcount_colsums
// (_fused_kernel), the fused form of mask_popcount + _colsum_list.
//
// The TPU kernel ran its grid in order and carried the column sums from
// one step to the next.  Blocks here run in no order, so each block sums
// its own columns and adds them to the output with one int32 atomicAdd per
// column.  Integer addition is exact and commutative, so the result does
// not depend on the order.
//
// Bound: bytes.  4W bytes are read and 4 written per row, 0.0100 ms for
// [2^22, 1] at 3.35 TB/s, and the arithmetic must stay below that.  A
// popcount per word is cheap; the column totals are not, if every word
// pays for its 32 columns (a vote per bit, as this kernel once did, is
// ~100 instructions a word).  Two steps take the columns out of the
// per-word work:
//
//   * Bit-sliced counters.  A thread keeps, per word column, kPlanes = 5
//     words that together hold a 5-bit counter for each of the 32 bit
//     columns (bit j of plane i is bit i of column j's count).  Adding two
//     mask words is one carry-save step and a ripple through the planes,
//     about ten logic instructions whatever the words hold.  The counters
//     hold 31, so they are flushed after at most 31 words per column.
//   * A 32 x 32 bit transpose per warp at the flush.  Five shuffle-exchange
//     steps turn the warp's 32 copies of a plane into 32 lanes that each
//     hold one column's 32 bits; one __popc, shifted by the plane's weight,
//     is that column's count over the warp.  Lane j so carries column j's
//     total in a register until the block ends.
//
// This was chosen over a transpose of every word (simpler, ~30
// instructions a word) because the flush then costs ~5 instructions a word
// at 28-31 words per flush, which leaves the kernel to the memory system
// at any W.
//
// popcount_colsums_vec<W> (W = 1, 2, 4, rows and popc 16-byte aligned)
// reads 128 bits per thread and trip (4 / W rows) and writes the rows'
// popcounts in one store (128 bits at W=1).  Any other W or alignment
// goes to popcount_colsums_rows: one row per lane, 4-byte loads, and the
// transpose applied to each word, with per-warp totals in shared memory.
// In both, the trip count of a loop that holds a full-mask shuffle depends
// on the block only, so every lane of a warp takes part; rows past P read
// as zero and are not written.  Grids are capped (max_blocks) and the
// blocks loop; indices are 64-bit; nothing is shared between launches
// (colsums is zeroed by the caller on the launching stream).
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py; one launch
// between its own events with the L2 flushed, the ~0.003 ms of an empty
// event pair not subtracted / launches back to back; the wrapper's fill of
// colsums included), 2^22 rows: W=1 0.0174 / 0.0115 ms, 0.57 of the bound;
// W=2 0.0239 / 0.0242 ms, 0.63 of its bound of 0.0150 ms.  The vote-per-bit
// kernel this replaces took 0.064 / 0.059 and 0.112 / 0.110 ms
// (tools/kernel_times.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 5;                       // counter bits per column
constexpr int kCounterMax = (1 << kPlanes) - 1;  // words per column between flushes

// Lane j of the warp returns the word whose bit l is bit j of lane l's x.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
        const uint32_t m = 0xFFFFFFFFu / ((1u << s) + 1u);   // 0x0000FFFF ... 0x55555555
        const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, s);
        x = (lane & s) ? (((y >> s) & m) | (x & ~m)) : ((x & m) | ((y & m) << s));
    }
    return x;
}

// Add the words a and b to the bit-sliced column counters.
__device__ __forceinline__ void add_words(uint32_t (&planes)[kPlanes], uint32_t a, uint32_t b) {
    const uint32_t s = a ^ b;
    uint32_t carry = (a & b) | (planes[0] & s);
    planes[0] ^= s;
#pragma unroll
    for (int i = 1; i < kPlanes; ++i) {
        const uint32_t t = planes[i] & carry;
        planes[i] ^= carry;
        carry = t;
    }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
popcount_colsums_vec(const uint32_t* __restrict__ rows, long long P, int ngenomes,
                     int32_t* __restrict__ popc, int32_t* __restrict__ colsums) {
    constexpr int kRows = 4 / W;                   // rows in one 128-bit load
    constexpr int kVecs = kCounterMax / kRows;     // loads between flushes
    __shared__ int32_t acc[32 * W];
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32 * W) acc[threadIdx.x] = 0;
    __syncthreads();

    uint32_t planes[W][kPlanes];
    int32_t total[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        total[w] = 0;
#pragma unroll
        for (int i = 0; i < kPlanes; ++i) planes[w][i] = 0u;
    }

    const long long nwords = P * W;
    const long long nvec = (nwords + 3) >> 2;   // the last one may be partial
    const long long step = (long long)gridDim.x * kThreads;
    for (long long base = (long long)blockIdx.x * kThreads; base < nvec;
         base += step * kVecs) {
        for (int u = 0; u < kVecs; ++u) {
            if (base + u * step >= nvec) break;   // the whole block leaves together
            const long long i = base + u * step + threadIdx.x;
            uint32_t v[4] = {0u, 0u, 0u, 0u};
            if (4 * i + 4 <= nwords) {
                const uint4 q = __ldg(reinterpret_cast<const uint4*>(rows) + i);
                v[0] = q.x;
                v[1] = q.y;
                v[2] = q.z;
                v[3] = q.w;
            } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (4 * i + c < nwords) v[c] = rows[4 * i + c];
            }

            int32_t pc[kRows];
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
                pc[q] = 0;
#pragma unroll
                for (int w = 0; w < W; ++w) pc[q] += __popc(v[q * W + w]);
            }
            const long long r = i * kRows;
            if (r + kRows <= P) {
                if constexpr (W == 1)
                    *reinterpret_cast<int4*>(popc + r) = make_int4(pc[0], pc[1], pc[2], pc[3]);
                else if constexpr (W == 2)
                    *reinterpret_cast<int2*>(popc + r) = make_int2(pc[0], pc[1]);
                else
                    popc[r] = pc[0];
            } else {
#pragma unroll
                for (int q = 0; q < kRows; ++q)
                    if (r + q < P) popc[r + q] = pc[q];
            }

            // component c of the load belongs to word column c % W
            if constexpr (W == 1) {
                add_words(planes[0], v[0], v[1]);
                add_words(planes[0], v[2], v[3]);
            } else if constexpr (W == 2) {
                add_words(planes[0], v[0], v[2]);
                add_words(planes[1], v[1], v[3]);
            } else {
#pragma unroll
                for (int w = 0; w < 4; ++w) add_words(planes[w], v[w], 0u);
            }
        }
        // flush: at most kVecs * kRows <= kCounterMax words were added per column
#pragma unroll
        for (int w = 0; w < W; ++w) {
#pragma unroll
            for (int i = 0; i < kPlanes; ++i) {
                total[w] += __popc(transpose32(planes[w][i], lane)) << i;
                planes[w][i] = 0u;
            }
        }
    }

#pragma unroll
    for (int w = 0; w < W; ++w) atomicAdd(&acc[32 * w + lane], total[w]);
    __syncthreads();
    if ((int)threadIdx.x < ngenomes) {   // ngenomes <= 32 W <= kThreads
        const int32_t s = acc[threadIdx.x];
        if (s) atomicAdd(&colsums[threadIdx.x], s);
    }
}

__global__ void __launch_bounds__(kThreads)
popcount_colsums_rows(const uint32_t* __restrict__ rows, long long P, int nwords,
                      int ngenomes, int32_t* __restrict__ popc,
                      int32_t* __restrict__ colsums) {
    extern __shared__ int32_t warp_acc[];  // [warps per block][32 * nwords]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = kThreads >> 5;
    const int ncols = 32 * nwords;
    int32_t* mine = warp_acc + warp * ncols;
    for (int c = lane; c < ncols; c += 32) mine[c] = 0;
    __syncwarp();

    const long long step = (long long)gridDim.x * kThreads;
    for (long long base = (long long)blockIdx.x * kThreads; base < P; base += step) {
        const long long r = base + threadIdx.x;
        const bool live = r < P;
        int pc = 0;
        for (int w = 0; w < nwords; ++w) {
            const uint32_t v = live ? rows[r * nwords + w] : 0u;
            pc += __popc(v);
            mine[w * 32 + lane] += __popc(transpose32(v, lane));
        }
        if (live) popc[r] = pc;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < ngenomes; c += kThreads) {
        int s = 0;
        for (int q = 0; q < nwarps; ++q) s += warp_acc[q * ncols + c];
        if (s) atomicAdd(&colsums[c], s);
    }
}

}  // namespace

extern "C" int pg_popcount_colsums(const void* rows, long long P, int nwords, int ngenomes,
                                   void* popc, void* colsums, int max_blocks,
                                   void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const uint32_t* in = (const uint32_t*)rows;
    int32_t* pc = (int32_t*)popc;
    int32_t* cs = (int32_t*)colsums;
    const bool aligned = (((uintptr_t)rows | (uintptr_t)popc) & 15) == 0;
    const bool vec = aligned && (nwords == 1 || nwords == 2 || nwords == 4);
    const long long units = vec ? (P * nwords + 3) / 4 : P;
    long long blocks = (units + kThreads - 1) / kThreads;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    const unsigned int grid = (unsigned int)blocks;
    if (vec && nwords == 1) {
        popcount_colsums_vec<1><<<grid, kThreads, 0, s>>>(in, P, ngenomes, pc, cs);
    } else if (vec && nwords == 2) {
        popcount_colsums_vec<2><<<grid, kThreads, 0, s>>>(in, P, ngenomes, pc, cs);
    } else if (vec) {
        popcount_colsums_vec<4><<<grid, kThreads, 0, s>>>(in, P, ngenomes, pc, cs);
    } else {
        const size_t smem = (size_t)(kThreads / 32) * 32 * nwords * sizeof(int32_t);
        popcount_colsums_rows<<<grid, kThreads, smem, s>>>(in, P, nwords, ngenomes, pc, cs);
    }
    return (int)cudaGetLastError();
}
