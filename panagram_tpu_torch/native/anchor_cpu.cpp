// anchor_cpu.cpp: the multithreaded host anchorer, the CPU baseline that
// the card's anchoring is measured against.
//
// The anchoring loop of the reference's KMC + cpp/anchor.cpp
// (GetCountersForRead -> byte-pack -> __builtin_popcount) on one host:
//
//   * an open-addressed hash table over the pan-kmer dictionary (splitmix64
//     of the canonical key, linear probing, at most half full), which reads
//     fewer cache lines per lookup than KMC's prefix/suffix binary search;
//   * a rolling canonical k-mer (min of forward and reverse complement
//     under 2-bit A<C<G<T), the semantics of ops/codec.pack_kmers;
//   * std::thread workers over contiguous position ranges, each warming its
//     own k-1 base window.
//
// The same C interface as panagram_tpu/native/anchor_cpu.cpp (acpu_build,
// acpu_anchor, acpu_free), bound with ctypes by anchor_cpu.py.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  x ^= x >> 31;
  return x;
}

const uint64_t kEmpty = ~0ull;   // a free slot (SENTINEL is never a key)
const int kMaxWords = 8;         // 256 genomes

struct AnchorDict {
  std::vector<uint64_t> keys;    // slots
  std::vector<uint32_t> masks;   // [slots * W]
  uint64_t slot_mask = 0;
  int W = 1;
};

void anchor_range(const AnchorDict* d, const uint8_t* codes, int64_t L, int k,
                  int nbytes, int64_t p0, int64_t p1, uint8_t* out_bytes,
                  int32_t* out_popc) {
  const int W = d->W;
  const uint64_t kmask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t fwd = 0, rev = 0;
  int64_t last_bad = p0 - 1;     // the latest non-ACGT base
  for (int64_t i = p0; i < p0 + k - 1 && i < L; i++) {
    uint8_t c = codes[i];
    if (c > 3) { last_bad = i; c = 0; }
    fwd = ((fwd << 2) | c) & kmask;
    rev = (rev >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));
  }
  for (int64_t p = p0; p < p1; p++) {
    const int64_t i = p + k - 1;  // the base entering the window
    uint8_t c = codes[i];
    if (c > 3) { last_bad = i; c = 0; }
    fwd = ((fwd << 2) | c) & kmask;
    rev = (rev >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));

    uint32_t row[kMaxWords] = {0};
    if (last_bad < p) {
      const uint64_t canon = fwd < rev ? fwd : rev;
      for (uint64_t h = mix64(canon) & d->slot_mask;;
           h = (h + 1) & d->slot_mask) {
        const uint64_t key = d->keys[h];
        if (key == canon) {
          std::memcpy(row, &d->masks[h * W], W * sizeof(uint32_t));
          break;
        }
        if (key == kEmpty) break;
      }
    }
    int popc = 0;
    for (int w = 0; w < W; w++) popc += __builtin_popcount(row[w]);
    out_popc[p] = popc;
    uint8_t* ob = out_bytes + (uint64_t)p * nbytes;
    for (int b = 0; b < nbytes; b++)
      ob[b] = (uint8_t)(row[b >> 2] >> (8 * (b & 3)));
  }
}

}  // namespace

extern "C" {

// keys u64 [n] (canonical k-mers), masks u32 [n * W], W <= 8 -> a handle.
void* acpu_build(const uint64_t* keys, const uint32_t* masks, int64_t n,
                 int W) {
  auto* d = new AnchorDict();
  uint64_t slots = 16;
  while (slots < (uint64_t)n * 2) slots <<= 1;
  d->keys.assign(slots, kEmpty);
  d->masks.assign(slots * (uint64_t)W, 0);
  d->slot_mask = slots - 1;
  d->W = W;
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = mix64(keys[i]) & d->slot_mask;
    while (d->keys[h] != kEmpty) h = (h + 1) & d->slot_mask;
    d->keys[h] = keys[i];
    std::memcpy(&d->masks[h * W], &masks[i * (uint64_t)W],
                W * sizeof(uint32_t));
  }
  return d;
}

void acpu_free(void* hd) { delete static_cast<AnchorDict*>(hd); }

// codes u8 [L] (0-3 a base, > 3 invalid) -> for each of the P = L - k + 1
// positions its mask row's first nbytes bytes (out_bytes u8 [P * nbytes])
// and popcount (out_popc i32 [P]); a window with an invalid base, or whose
// k-mer is no key, gives a row of 0.
void acpu_anchor(void* hd, const uint8_t* codes, int64_t L, int k, int nbytes,
                 uint8_t* out_bytes, int32_t* out_popc, int threads) {
  const auto* d = static_cast<AnchorDict*>(hd);
  const int64_t P = L - k + 1;
  if (P <= 0) return;
  if (threads < 1) threads = 1;
  if (threads == 1) {
    anchor_range(d, codes, L, k, nbytes, 0, P, out_bytes, out_popc);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t per = (P + threads - 1) / threads;
  for (int t = 0; t < threads; t++) {
    const int64_t p0 = (int64_t)t * per;
    const int64_t p1 = p0 + per < P ? p0 + per : P;
    if (p0 >= p1) break;
    pool.emplace_back(anchor_range, d, codes, L, k, nbytes, p0, p1,
                      out_bytes, out_popc);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
