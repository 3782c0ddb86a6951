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
// The TPU kernel copied each tile's window of rows into VMEM and selected
// rows with a one-hot matmul, because Mosaic cannot gather across vector
// registers; here each query reads its row straight from device memory.
//
// Every layout fills a row's slots from slot 0 and leaves the rest as the
// all-ones pair (ops/lookup.py, and panagram_tpu's), and no key is the
// all-ones pair.  So the scan of a row stops at its first empty slot, or at
// `cap`: a slot whose hi alone or lo alone is all ones is a key.
//
// Bound: bytes, of which the table's are the most and depend on the data.
// At the anchor chunk's shapes (2^22 queries, 1.3e7 keys in 2^22 buckets,
// a mean of 3.1 keys a row) the queries touch 1.7e6 rows and need each
// one's key pairs as far as its longest scan goes (to a hit, or to the
// terminator on a miss) and the words of the slots hit: 103 MB a chunk at
// W=1 with the queries and the output, 167 MB at W=4
// (kernels.probe_need_bytes; 0.031 / 0.050 ms at 3.35 TB/s).  The kernel
// this replaces ran one thread per query over all `cap` slots of a miss
// (two scalar loads a slot, each waiting on the previous compare): 0.206
// ms at W=1, 0.371-0.379 at W=2-4, the time of whole 256- or 512-B rows.
// The card fetches 32-byte sectors, so a row costs the sectors its scan
// reaches; at W >= 2 a key pair sits in a 16-24-byte slot beside its mask
// words, so those sectors hold 2-3 times the bytes needed.  The design:
//
//   * The scan stops at the first empty slot (most rows end by slot 4).
//   * At W = 1 and 2 one thread per query loads a 64-byte piece of its
//     row as four independent 16-byte loads issued before any compare,
//     and compares the slots wholly inside it from registers (compile-time
//     offsets); a hit's mask words are in the same registers.  The next
//     piece, if the scan goes on, starts at the first slot not yet checked.
//   * W = 3 and 4 (20- and 24-byte slots, of which a 64-byte piece holds
//     two or three) take the scalar path: the same scan with 4-byte loads,
//     fetching only the sectors it reaches, one dependent load at a time.
//     So do W > 4 and a table whose rows are not 16-byte aligned (a view at
//     an odd word, a stride not a multiple of 4).
//   * Queries arrive sorted on hi, so a warp reads the same or adjacent
//     rows and the L1 / L2 merge the repeats.
//   * A query's W words go out as one 8- or 16-byte store where W = 2 or 4
//     and the output is aligned.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/kernel_times.py; one
// launch between its own events, L2 flushed), cold: 0.087 / 0.106 ms at
// W=1 / W=2 with 64-B pieces, 0.139 / 0.134 at W=3 / W=4 on the scalar
// path, 0.31-0.37 of the bound.  Measured with the same tool on earlier
// versions of this source and not kept: 96- and 128-B pieces (at W=4
// 128-B pieces read 0.142-0.145 ms, the scalar path with 4-byte stores
// 0.146); a group of 4 or 8 lanes per query, one 16-byte load each,
// deciding by ballot (0.27-0.48 ms); runs of 32 queries per warp with the
// next run's first pieces staged in shared memory by cp.async (2.3-4.7
// ms).
//
// Output: W u32 per query, row-major [Q, W].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kOnes = 0xFFFFFFFFu;

__device__ __forceinline__ const uint32_t* query_row(const int32_t* __restrict__ blo,
                                                     const uint32_t* __restrict__ table,
                                                     long long i, uint32_t hi, int nbits,
                                                     int stride, long long span, int tile_q) {
    const long long b0 = blo[i / tile_q];
    const long long bucket = (long long)(hi >> (32 - nbits));  // 1 <= nbits <= 32
    long long rel = bucket - b0;
    rel = rel < 0 ? 0 : (rel > span - 1 ? span - 1 : rel);
    return table + (b0 + rel) * (long long)stride;
}

// The scan from slot `s` to the end of the row, one 4-byte load at a time.
template <int W>
__device__ __forceinline__ void scan_tail(const uint32_t* row, int s, int cap, int nwords,
                                          uint32_t hi, uint32_t lo, uint32_t* m) {
    const int sw = 2 + nwords;
    for (; s < cap; ++s) {
        const uint32_t h = row[s * sw], l = row[s * sw + 1];
        if (h == hi && l == lo) {
            for (int k = 0; k < (W > 0 ? W : nwords); ++k) m[k] = row[s * sw + 2 + k];
            return;
        }
        if (h == kOnes && l == kOnes) return;
    }
}

template <int W>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ out, long long i,
                                            const uint32_t (&m)[W], bool vec_out) {
    uint32_t* o = out + i * W;
    if constexpr (W == 2) {
        if (vec_out) {
            *reinterpret_cast<uint2*>(o) = make_uint2(m[0], m[1]);
            return;
        }
    } else if constexpr (W == 4) {
        if (vec_out) {
            *reinterpret_cast<uint4*>(o) = make_uint4(m[0], m[1], m[2], m[3]);
            return;
        }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) o[k] = m[k];
}

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// A piece of 16 words (four 16-byte loads) at a slot-aligned word of the
// row: the NS slots wholly inside it are compared from registers, and the
// next piece starts STEP words on, a multiple of 4 words (16-byte loads)
// and of the slot width (compile-time offsets) that skips no slot.
template <int W>
struct Piece {
    static constexpr int PW = 16;
    static constexpr int SW = 2 + W;
    static constexpr int NS = PW / SW;
    static constexpr int LCM = SW * 4 / gcd(SW, 4);
    static constexpr int STEP = NS * SW / LCM * LCM;
    static_assert(STEP > 0, "a piece must advance");
};

// Compares the slots of piece w, which starts at slot s0: 1 on a hit (its
// words into m), 2 where the scan ends (an empty slot, or cap), else 0.
template <int W>
__device__ __forceinline__ int check_piece(const uint32_t (&w)[Piece<W>::PW], int s0, int cap,
                                           uint32_t hi, uint32_t lo, uint32_t (&m)[W]) {
    using G = Piece<W>;
    int state = 0;
#pragma unroll
    for (int j = 0; j < G::NS; ++j) {
        if (state == 0) {
            const uint32_t h = w[j * G::SW], l = w[j * G::SW + 1];
            if (s0 + j >= cap) {
                state = 2;
            } else if (h == hi && l == lo) {
                state = 1;
#pragma unroll
                for (int k = 0; k < W; ++k) m[k] = w[j * G::SW + 2 + k];
            } else if (h == kOnes && l == kOnes) {
                state = 2;
            }
        }
    }
    return state;
}

// The scan of a row: pieces while they fit the row, then 4-byte loads to
// cap.
template <int W>
__device__ __forceinline__ void scan_row(const uint32_t* row, int cap, int stride,
                                         uint32_t hi, uint32_t lo, uint32_t (&m)[W]) {
    using G = Piece<W>;
    int next = 0;                        // first slot not yet checked
    for (int base = 0; base + G::PW <= stride && next < cap; base += G::STEP) {
        uint32_t w[G::PW];
        const uint4* p = reinterpret_cast<const uint4*>(row + base);
#pragma unroll
        for (int c = 0; c < G::PW / 4; ++c) {
            const uint4 v = __ldg(p + c);
            w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z; w[4 * c + 3] = v.w;
        }
        if (check_piece<W>(w, base / G::SW, cap, hi, lo, m) != 0) return;
        next = base / G::SW + G::NS;
    }
    scan_tail<W>(row, next, cap, W, hi, lo, m);
}

// One thread per query: its row read in 64-byte pieces (PIECES) or one
// 4-byte word at a time, its W words stored at once.
template <int W, bool PIECES>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
             const int32_t* __restrict__ blo, const uint32_t* __restrict__ table,
             long long Q, int nbits, int cap, int stride, long long span, int tile_q,
             bool vec_out, uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= Q) return;
    const uint32_t hi = qhi[i], lo = qlo[i];
    uint32_t m[W];
#pragma unroll
    for (int k = 0; k < W; ++k) m[k] = 0;
    if (!(hi == kOnes && lo == kOnes)) {
        const uint32_t* row = query_row(blo, table, i, hi, nbits, stride, span, tile_q);
        if constexpr (PIECES)
            scan_row<W>(row, cap, stride, hi, lo, m);
        else
            scan_tail<W>(row, 0, cap, W, hi, lo, m);
    }
    store_words<W>(out, i, m, vec_out);
}

// The scalar path at any W, its words stored one by one.
__global__ void __launch_bounds__(kThreads)
probe_scalar_kernel(const uint32_t* __restrict__ qhi, const uint32_t* __restrict__ qlo,
                    const int32_t* __restrict__ blo, const uint32_t* __restrict__ table,
                    long long Q, int nbits, int cap, int nwords, int stride,
                    long long span, int tile_q, uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= Q) return;
    const uint32_t hi = qhi[i], lo = qlo[i];
    uint32_t* o = out + i * (long long)nwords;
    for (int k = 0; k < nwords; ++k) o[k] = 0u;
    if (hi == kOnes && lo == kOnes) return;
    const uint32_t* row = query_row(blo, table, i, hi, nbits, stride, span, tile_q);
    scan_tail<0>(row, 0, cap, nwords, hi, lo, o);
}

}  // namespace

extern "C" int pg_probe_sorted(const void* qhi, const void* qlo, const void* blo,
                               const void* table, long long Q, int nbits, int cap,
                               int nwords, int stride, long long span, int tile_q,
                               void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool rows16 = ((uintptr_t)table & 15) == 0 && stride % 4 == 0;
    const bool vec_out = ((uintptr_t)out & 15) == 0;   // for the 8- and 16-byte stores
    const unsigned int grid = (unsigned int)((Q + kThreads - 1) / kThreads);
    const uint32_t* qh = (const uint32_t*)qhi;
    const uint32_t* ql = (const uint32_t*)qlo;
    const int32_t* b = (const int32_t*)blo;
    const uint32_t* t = (const uint32_t*)table;
    uint32_t* o = (uint32_t*)out;
    if (nwords == 1 && rows16)
        probe_kernel<1, true><<<grid, kThreads, 0, s>>>(qh, ql, b, t, Q, nbits, cap, stride,
                                                        span, tile_q, vec_out, o);
    else if (nwords == 2 && rows16)
        probe_kernel<2, true><<<grid, kThreads, 0, s>>>(qh, ql, b, t, Q, nbits, cap, stride,
                                                        span, tile_q, vec_out, o);
    else if (nwords == 4)
        probe_kernel<4, false><<<grid, kThreads, 0, s>>>(qh, ql, b, t, Q, nbits, cap, stride,
                                                         span, tile_q, vec_out, o);
    else
        probe_scalar_kernel<<<grid, kThreads, 0, s>>>(qh, ql, b, t, Q, nbits, cap, nwords,
                                                       stride, span, tile_q, o);
    return (int)cudaGetLastError();
}
