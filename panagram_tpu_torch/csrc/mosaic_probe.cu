// mosaic_probe: the four u32 operations of the TPU capability probe.
//
// Replaces the inline Pallas kernel `kern` of tools/mosaic_probe.py, which
// checked that Mosaic gives an exact u32 multiply, a roll of a row-major
// [R, 128] u32 array by one element (lane roll + row splice), a 16x32
// multiply and an unsigned compare-select.  Here each is one line of plain
// CUDA: one thread per element i < n writes the row out[i] =
//   [a*b mod 2^32, a[(i+1) mod n], (a>>16)*(b&0xFFFF) mod 2^32,
//    a < b (unsigned) ? a*b : a[(i+1) mod n]].
// The roll is a neighbour read, so there is no tiling and n is any size.
//
// Bound: bytes, 8 B in and 16 B out per element.  The neighbour load hits
// the line its neighbour thread already brought in, and the four words of
// a row go out as one 16-byte store (uint4), so a warp writes 512
// contiguous bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void mosaic_probe_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b, long long n,
                                    uint4* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t x = a[i];
    const uint32_t y = b[i];
    const uint32_t prod = x * y;
    const uint32_t rolled = a[i + 1 < n ? i + 1 : 0];
    const uint32_t hi16 = (x >> 16) * (y & 0xFFFFu);
    out[i] = make_uint4(prod, rolled, hi16, x < y ? prod : rolled);
}

}  // namespace

extern "C" int pg_mosaic_probe(const void* a, const void* b, long long n, void* out,
                               void* stream) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    mosaic_probe_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, n, (uint4*)out);
    return (int)cudaGetLastError();
}
