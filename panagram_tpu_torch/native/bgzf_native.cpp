// BGZF block compression and decompression on zlib, for the host side of
// the index writer (io/bgzf.py).  Every block is an independent raw-deflate
// stream, so the functions are re-entrant: io/bgzf.py calls them from a
// small thread pool through ctypes, which releases the interpreter lock
// for the call.  The deflate settings (level, raw window of 2^15, memLevel
// 8, default strategy) are those of Python's zlib.compressobj(level,
// DEFLATED, -15), so both give the same bytes.
//
// Built at first use with the host compiler into ../_built/ (see
// panagram_tpu_torch/_build.build_host_library).

#include <cstdint>
#include <cstring>
#include <zlib.h>

extern "C" {

// Compress one BGZF block. `dst` must have room for 65536 bytes.
// Returns total block size (header+payload+footer), or -1 on error.
// Falls back to stored (level 0) blocks if output would exceed 64 KiB.
int bgzf_compress_block(const uint8_t* src, int src_len, uint8_t* dst,
                        int level) {
    if (src_len < 0 || src_len > 0xff00) return -1;

    for (int attempt = 0; attempt < 2; attempt++) {
        int lvl = attempt == 0 ? level : 0;
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, lvl, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK)
            return -1;
        zs.next_in = const_cast<Bytef*>(src);
        zs.avail_in = src_len;
        zs.next_out = dst + 18;
        zs.avail_out = 65536 - 18 - 8;
        int ret = deflate(&zs, Z_FINISH);
        uint32_t payload = zs.total_out;
        deflateEnd(&zs);
        if (ret != Z_STREAM_END) continue;  // didn't fit: retry stored

        uint32_t bsize = payload + 26;
        if (bsize > 65536) continue;

        // gzip header with BC extra subfield
        static const uint8_t hdr[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                        0,    0xff, 6,    0,    0x42, 0x43,
                                        2,    0};
        std::memcpy(dst, hdr, 16);
        uint16_t bs16 = (uint16_t)(bsize - 1);
        std::memcpy(dst + 16, &bs16, 2);

        uint32_t crc = crc32(0L, src, src_len);
        std::memcpy(dst + 18 + payload, &crc, 4);
        uint32_t isize = (uint32_t)src_len;
        std::memcpy(dst + 18 + payload + 4, &isize, 4);
        return (int)bsize;
    }
    return -1;
}

// Decompress one BGZF block payload (raw deflate). Returns uncompressed
// size or -1.
int bgzf_decompress_block(const uint8_t* payload, int payload_len,
                          uint8_t* dst, int dst_cap) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return -1;
    zs.next_in = const_cast<Bytef*>(payload);
    zs.avail_in = payload_len;
    zs.next_out = dst;
    zs.avail_out = dst_cap;
    int ret = inflate(&zs, Z_FINISH);
    int out = zs.total_out;
    inflateEnd(&zs);
    if (ret != Z_STREAM_END) return -1;
    return out;
}

// Compress many blocks back to back: src is split into 0xff00-byte blocks.
// dst must have room for nblocks*65536. block_sizes[i] receives each
// block's compressed size. Returns total bytes written, or -1.
long long bgzf_compress_buffer(const uint8_t* src, long long src_len,
                               uint8_t* dst, int* block_sizes, int level) {
    long long off = 0, out = 0;
    int i = 0;
    while (off < src_len) {
        int n = (int)((src_len - off) < 0xff00 ? (src_len - off) : 0xff00);
        int bs = bgzf_compress_block(src + off, n, dst + out, level);
        if (bs < 0) return -1;
        block_sizes[i++] = bs;
        out += bs;
        off += n;
    }
    return out;
}

}  // extern "C"
