// masks_to_bytes: u32 mask words -> little-endian bytes, truncated.
//
// Replaces panagram_tpu/ops/pallas_kernels.py masks_to_bytes_pallas
// (_bytes_kernel), i.e. masks_to_bytes(rows)[:, :nbytes] fused so the
// truncated bytes are the only thing written back.
//
// One thread per output byte (row, b): byte b of a row is bits
// [8(b%4), 8(b%4)+8) of word b/4.  Writes are contiguous across the grid;
// the word loads of neighbouring threads coincide or neighbour, so they
// coalesce.  Bound: store instructions.  4W bytes are read and nbytes
// written per row, but one byte per thread moves ~0.5 TB/s (~0.06 ms per
// 2^22 rows at W=1 on an H100 80GB HBM3 at 700 W); word-wide stores are
// the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void masks_to_bytes_kernel(const uint32_t* __restrict__ rows, long long P,
                                      int nwords, int nbytes, uint8_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= P * nbytes) return;
    const long long r = i / nbytes;
    const int b = (int)(i - r * nbytes);
    const uint32_t v = rows[r * nwords + (b >> 2)];
    out[i] = (uint8_t)((v >> (8 * (b & 3))) & 0xFFu);
}

}  // namespace

extern "C" int pg_masks_to_bytes(const void* rows, long long P, int nwords, int nbytes,
                                 void* out, void* stream) {
    const int threads = 256;
    const long long blocks = (P * nbytes + threads - 1) / threads;
    masks_to_bytes_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, P, nwords, nbytes, (uint8_t*)out);
    return (int)cudaGetLastError();
}
