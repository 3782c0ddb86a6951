// fused_popcount_colsums: one pass over mask rows -> popcount per row and
// per-genome column totals.
//
// Replaces panagram_tpu/ops/pallas_kernels.py fused_popcount_colsums
// (_fused_kernel), the fused form of mask_popcount + _colsum_list.
//
// The TPU kernel ran its grid in order and carried the column sums from
// one step to the next.  Blocks here run in no order, so each warp counts
// its own columns in shared memory and each block adds its totals to the
// output with one int32 atomicAdd per column.  Integer addition is exact
// and commutative, so the result does not depend on the order.
//
// Column counts use the warp vote: for bit j of word w, __ballot_sync
// gathers that bit from the warp's 32 rows and lane j adds its popcount.
// Every lane of a warp runs the same number of loop trips (the loop bound
// depends on the block only), as the full-mask ballot requires.
//
// Bound: instructions.  Reading 2^22 rows of one word is 16 MB, ~5 us at
// the card's bandwidth, but the kernel takes ~0.09 ms on an H100 80GB HBM3
// at 700 W: the 32 votes per word and 32 rows, each a vote, a compare and
// a shared-memory add, dominate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void popcount_colsums_kernel(const uint32_t* __restrict__ rows, long long P,
                                        int nwords, int ngenomes,
                                        int32_t* __restrict__ popc,
                                        int32_t* __restrict__ colsums) {
    extern __shared__ int32_t acc[];  // [warps per block][32 * nwords]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int ncols = 32 * nwords;
    int32_t* mine = acc + warp * ncols;
    for (int c = lane; c < ncols; c += 32) mine[c] = 0;
    __syncwarp();

    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x; base < P; base += step) {
        const long long r = base + threadIdx.x;
        const bool live = r < P;
        int pc = 0;
        for (int w = 0; w < nwords; ++w) {
            const uint32_t v = live ? rows[r * nwords + w] : 0u;
            pc += __popc(v);
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const unsigned int vote = __ballot_sync(0xFFFFFFFFu, (v >> j) & 1u);
                if (lane == j) mine[w * 32 + j] += __popc(vote);
            }
        }
        if (live) popc[r] = pc;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < ngenomes; c += blockDim.x) {
        int s = 0;
        for (int q = 0; q < nwarps; ++q) s += acc[q * ncols + c];
        if (s) atomicAdd(&colsums[c], s);
    }
}

}  // namespace

extern "C" int pg_popcount_colsums(const void* rows, long long P, int nwords, int ngenomes,
                                   void* popc, void* colsums, int max_blocks,
                                   void* stream) {
    const int threads = 256;
    long long blocks = (P + threads - 1) / threads;
    if (blocks > max_blocks) blocks = max_blocks;
    const size_t smem = (size_t)(threads / 32) * 32 * nwords * sizeof(int32_t);
    popcount_colsums_kernel<<<(unsigned int)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, P, nwords, ngenomes, (int32_t*)popc, (int32_t*)colsums);
    return (int)cudaGetLastError();
}
