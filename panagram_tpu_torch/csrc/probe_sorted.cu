// probe_sorted: merge probe of hi-sorted queries against the bucket table.
//
// Replaces panagram_tpu/ops/pallas_kernels.py probe_sorted (_probe_kernel),
// with its contract kept: query i belongs to tile t = i / tile_q; its
// bucket row is blo[t] + clamp(bucket - blo[t], 0, span - 1), where bucket
// is the top nbits of its hi word; the row's `cap` slots [hi, lo, W words]
// are compared with the full (hi, lo) pair, and a hit emits the slot's W
// mask words.  A miss gives 0, and the all-ones pair never matches.  A
// query outside its tile's window reads a wrong row and so misses; its
// caller (ops/lookup.py bucket_query_sorted_pre) fixes those up.  Its
// default window is the whole table (blo = 0, span = 2^nbits, which for
// nbits = 32 needs the 64-bit span), so that every query reads its own row.
//
// One thread per query.  The TPU kernel copied each tile's window of rows
// into VMEM and selected rows with a one-hot matmul, because Mosaic cannot
// gather across vector registers.  Here each thread indexes its row
// directly in device memory: the queries are sorted, so the threads of a
// warp read the same or adjacent rows, which the L1 and L2 caches serve,
// and the whole table is read about once per chunk.
//
// Bound: the memory system's latency on the dependent row reads (a query
// reads up to `cap` hi words, 4 B each, one slot apart) more than bytes;
// output is W u32 per query, row-major [Q, W].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void probe_sorted_kernel(const uint32_t* __restrict__ qhi,
                                    const uint32_t* __restrict__ qlo,
                                    const int32_t* __restrict__ blo,
                                    const uint32_t* __restrict__ table,
                                    long long Q, int nbits, int cap, int nwords,
                                    int stride, long long span, int tile_q,
                                    uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= Q) return;
    const uint32_t hi = qhi[i];
    const uint32_t lo = qlo[i];
    const long long b0 = blo[i / tile_q];
    const long long bucket = (long long)(hi >> (32 - nbits));  // 1 <= nbits <= 32
    long long rel = bucket - b0;
    rel = rel < 0 ? 0 : (rel > span - 1 ? span - 1 : rel);
    const uint32_t* row = table + (b0 + rel) * (long long)stride;
    const int slot_w = 2 + nwords;
    int hit = -1;
    if (!(hi == 0xFFFFFFFFu && lo == 0xFFFFFFFFu)) {
        for (int s = 0; s < cap; ++s) {
            if (row[s * slot_w] == hi && row[s * slot_w + 1] == lo) {
                hit = s;
                break;
            }
        }
    }
    uint32_t* o = out + i * (long long)nwords;
    for (int w = 0; w < nwords; ++w) o[w] = hit >= 0 ? row[hit * slot_w + 2 + w] : 0u;
}

}  // namespace

extern "C" int pg_probe_sorted(const void* qhi, const void* qlo, const void* blo,
                               const void* table, long long Q, int nbits, int cap,
                               int nwords, int stride, long long span, int tile_q,
                               void* out, void* stream) {
    const int threads = 256;
    const long long blocks = (Q + threads - 1) / threads;
    probe_sorted_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)qhi, (const uint32_t*)qlo, (const int32_t*)blo,
        (const uint32_t*)table, Q, nbits, cap, nwords, stride, span, tile_q,
        (uint32_t*)out);
    return (int)cudaGetLastError();
}
