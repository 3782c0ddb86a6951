// masks_to_bytes: u32 mask words -> little-endian bytes, truncated.
//
// Replaces panagram_tpu/ops/pallas_kernels.py masks_to_bytes_pallas
// (_bytes_kernel), i.e. masks_to_bytes(rows)[:, :nbytes] fused so the
// truncated bytes are the only thing written back.
//
// Bound: bytes.  4W bytes are read and nbytes written per row and nothing
// is computed, so the least time is (4W + nbytes) * P over the card's
// memory rate: 0.0100 ms for [2^22, 1] -> 4 B at 3.35 TB/s.  An H100's
// little-endian words already are the bytes wanted, so the output is a
// byte stream cut out of the input, and the design is about moving it in
// 128-bit pieces without arithmetic per byte:
//
//   * nbytes == 4W (30 genomes at W=1, the usual build): the output is the
//     input.  copy_kernel moves 16 bytes per thread and trip, one 128-bit
//     load and one 128-bit store, in a grid-stride loop.
//   * nbytes < 4W (40 genomes: W=2, 5 B): truncate_kernel stages a tile of
//     rows in shared memory with cp.async (16 bytes a copy), then each
//     thread gathers 16 consecutive output bytes from the tile, stepping
//     over the cut bytes at each row's end, and writes one 128-bit store.
//     One integer division per 16 output bytes finds the first row.  W is
//     a run-time stride here (it is added once per row), so no instance
//     per W is needed.  Tiles are 1024 rows (fewer for wide rows, to stay
//     within 32 KB), so several blocks fit an SM and a chunk has many
//     more tiles than the card has block slots.
//   * anything else goes to general_kernel, which produces the same 16
//     bytes per thread with byte loads and stores: an output pointer that
//     is not 16-byte aligned, or rows too wide for a staged tile.
//
// The rows pointer need only be 4-byte aligned (a slice rows[1:] of a
// tensor is): the instances with IN16 = false or VEC = 4 read words where
// the others read 16 bytes.  Tile sizes are multiples of 16 rows, so every
// tile starts at the alignment of its base pointer.  No byte past
// out[P * nbytes) is written, no byte past rows[P * W) is read, every
// index is 64-bit, and grids are capped with the blocks looping, so
// P * nbytes may pass 2^32.  Nothing is shared between launches.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py; one launch
// between its own events with the L2 flushed, the ~0.003 ms of an empty
// event pair not subtracted / launches back to back), 2^22 rows: W=1 -> 4 B
// 0.0137 / 0.0091 ms, 0.73 of the bound, and torch's clone of the same
// bytes takes 0.0139 / 0.0092 ms; W=2 -> 5 B 0.0300 / 0.0304 ms, 0.54 of its
// bound of 0.0163 ms (the gather's ~130 instructions per 16 bytes show),
// against 0.048 ms for torch's strided copy.  The one-thread-per-byte
// kernel this replaces took 0.053 / 0.044 and 0.068 / 0.069 ms
// (tools/kernel_times.py).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;     // blocks loop over the rest
constexpr int kStageBytes = 32 * 1024;   // shared memory of one staged tile
constexpr int kTileRows = 1024;

// nbytes == 4W: total bytes (a multiple of 4) from in to out; out is
// 16-byte aligned, in is if IN16.
template <bool IN16>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint32_t* __restrict__ in, long long total, uint8_t* __restrict__ out) {
    const long long n16 = total >> 4;
    const long long step = (long long)gridDim.x * kThreads;
    uint4* __restrict__ out4 = reinterpret_cast<uint4*>(out);
#pragma unroll 4
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n16; i += step) {
        uint4 v;
        if constexpr (IN16) {
            v = __ldg(reinterpret_cast<const uint4*>(in) + i);
        } else {
            v.x = __ldg(in + 4 * i);
            v.y = __ldg(in + 4 * i + 1);
            v.z = __ldg(in + 4 * i + 2);
            v.w = __ldg(in + 4 * i + 3);
        }
        out4[i] = v;
    }
    // the words past the last whole 16 bytes
    if (blockIdx.x == 0) {
        const long long w = (n16 << 2) + threadIdx.x;
        if (w < (total >> 2)) reinterpret_cast<uint32_t*>(out)[w] = in[w];
    }
}

// 16 output bytes from `s`, which points at byte b of a row of rowb bytes
// of which the first nbytes are kept; only the first nb are produced.
__device__ __forceinline__ uint4 gather16(const uint8_t* s, int b, int rowb, int nbytes,
                                          int nb) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
        if (t < nb) {
            w[t >> 2] |= (uint32_t)(*s) << (8 * (t & 3));
            ++s;
            if (++b == nbytes) {
                b = 0;
                s += rowb - nbytes;
            }
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint4& v, int nb) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 16; ++t)
        if (t < nb) dst[t] = (uint8_t)(w[t >> 2] >> (8 * (t & 3)));
}

// nbytes < rowb = 4W: tiles of tile_rows rows (a multiple of 16) through
// shared memory.  out is 16-byte aligned; in is VEC-byte aligned.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
truncate_kernel(const uint8_t* __restrict__ in, long long P, int rowb, int nbytes,
                int tile_rows, uint8_t* __restrict__ out) {
    extern __shared__ uint4 stage4[];
    uint8_t* stage = reinterpret_cast<uint8_t*>(stage4);
    const long long ntiles = (P + tile_rows - 1) / tile_rows;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const long long r0 = tile * tile_rows;
        const long long left = P - r0;
        const int rows_here = left < tile_rows ? (int)left : tile_rows;
        const uint8_t* src = in + r0 * rowb;
        const int inb = rows_here * rowb;   // a multiple of 4
        const int nvec = inb / VEC;
        for (int i = threadIdx.x; i < nvec; i += kThreads)
            __pipeline_memcpy_async(stage + i * VEC, src + i * VEC, VEC);
        if constexpr (VEC == 16) {   // the words past the last whole 16 bytes
            const int w = nvec * 4 + threadIdx.x;
            if (w < inb / 4) __pipeline_memcpy_async(stage + 4 * w, src + 4 * w, 4);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();

        uint8_t* dst = out + r0 * nbytes;
        const int outb = rows_here * nbytes;
        const int nchunks = (outb + 15) >> 4;
        for (int c = threadIdx.x; c < nchunks; c += kThreads) {
            const int j0 = c << 4;
            const int row = j0 / nbytes;
            const int b = j0 - row * nbytes;
            const int nb = outb - j0 < 16 ? outb - j0 : 16;
            const uint4 v = gather16(stage + row * rowb + b, b, rowb, nbytes, nb);
            if (nb == 16)
                *reinterpret_cast<uint4*>(dst + j0) = v;
            else
                store_bytes(dst + j0, v, nb);
        }
        __syncthreads();   // the next tile overwrites the stage
    }
}

// Any pointers, any W: 16 output bytes per thread and trip, byte by byte.
__global__ void __launch_bounds__(kThreads)
general_kernel(const uint8_t* __restrict__ in, long long P, int rowb, int nbytes,
               uint8_t* __restrict__ out) {
    const long long total = P * nbytes;
    const long long nchunks = (total + 15) >> 4;
    const long long step = (long long)gridDim.x * kThreads;
    for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < nchunks; c += step) {
        const long long j0 = c << 4;
        const long long row = j0 / nbytes;
        const int b = (int)(j0 - row * nbytes);
        const int nb = total - j0 < 16 ? (int)(total - j0) : 16;
        store_bytes(out + j0, gather16(in + row * rowb + b, b, rowb, nbytes, nb), nb);
    }
}

unsigned int grid_for(long long units) {
    const long long blocks = (units + kThreads - 1) / kThreads;
    return (unsigned int)(blocks < 1 ? 1 : blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" int pg_masks_to_bytes(const void* rows, long long P, int nwords, int nbytes,
                                 void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int rowb = 4 * nwords;
    const bool in16 = ((uintptr_t)rows & 15) == 0;
    const bool out16 = ((uintptr_t)out & 15) == 0;
    const uint8_t* in = (const uint8_t*)rows;
    uint8_t* o = (uint8_t*)out;
    const long long total = P * nbytes;
    if (out16 && nbytes == rowb) {
        const unsigned int grid = grid_for(total >> 4);
        if (in16)
            copy_kernel<true><<<grid, kThreads, 0, s>>>((const uint32_t*)rows, total, o);
        else
            copy_kernel<false><<<grid, kThreads, 0, s>>>((const uint32_t*)rows, total, o);
    } else if (out16 && 16 * rowb <= kStageBytes) {
        int tile_rows = (kStageBytes / rowb) & ~15;
        if (tile_rows > kTileRows) tile_rows = kTileRows;
        const long long ntiles = (P + tile_rows - 1) / tile_rows;
        const unsigned int grid = (unsigned int)(ntiles > kMaxBlocks ? kMaxBlocks : ntiles);
        const size_t smem = (size_t)tile_rows * rowb;
        if (in16)
            truncate_kernel<16><<<grid, kThreads, smem, s>>>(in, P, rowb, nbytes, tile_rows, o);
        else
            truncate_kernel<4><<<grid, kThreads, smem, s>>>(in, P, rowb, nbytes, tile_rows, o);
    } else {
        const unsigned int grid = grid_for((total + 15) >> 4);
        general_kernel<<<grid, kThreads, 0, s>>>(in, P, rowb, nbytes, o);
    }
    return (int)cudaGetLastError();
}
