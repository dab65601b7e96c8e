/* Native bit-stream codec for Huffman entropy coding.
 *
 * A copy of aip_tpu/runtime/_bitcodec.c. The model loader
 * (aip_tpu_torch/gs/compress.py) decodes multi-million entry RVQ/hash-grid
 * index streams; packing variable-length codes one
 * symbol at a time in Python is the host-side bottleneck, so the two hot
 * loops live here. Built on demand with the system C compiler and loaded
 * via ctypes (no pybind11 dependency); aip_tpu_torch.runtime.bitcodec falls back
 * to the pure-numpy path when no compiler is available.
 */

#include <stdint.h>
#include <stddef.h>

/* Pack codes[i] (lengths[i] bits each, MSB first) into out. Returns total
 * bits written. out must hold at least sum(lengths) bits. */
long long pack_bits(const uint32_t *codes, const uint8_t *lengths,
                    long long n, uint8_t *out) {
    long long bitpos = 0;
    for (long long i = 0; i < n; ++i) {
        uint32_t code = codes[i];
        int len = lengths[i];
        for (int k = len - 1; k >= 0; --k) {
            if ((code >> k) & 1u) {
                out[bitpos >> 3] |= (uint8_t)(1u << (7 - (bitpos & 7)));
            }
            ++bitpos;
        }
    }
    return bitpos;
}

/* Canonical Huffman decode: first_code[l] / first_rank[l] give, per code
 * length l (1..max_len), the first canonical code value and the rank of its
 * symbol; symbols_by_rank maps rank -> symbol. packed_bits bounds reads into
 * the packed buffer so a truncated/corrupt stream fails cleanly. Returns
 * symbols decoded, or -1 on malformed input. */
long long unpack_canonical(const uint8_t *packed, long long packed_bits,
                           long long n_symbols, int max_len,
                           const uint32_t *first_code,
                           const int64_t *first_rank,
                           const int64_t *symbols_by_rank, int64_t *out) {
    long long bitpos = 0;
    for (long long i = 0; i < n_symbols; ++i) {
        uint32_t code = 0;
        int len = 0;
        int found = 0;
        while (len < max_len) {
            if (bitpos >= packed_bits) return -1; /* truncated stream */
            code = (code << 1) |
                   ((packed[bitpos >> 3] >> (7 - (bitpos & 7))) & 1u);
            ++bitpos;
            ++len;
            /* A length is "active" iff first_rank[len+1] > first_rank[len];
             * the code belongs to it iff it falls inside that rank span. */
            if (first_rank[len + 1] > first_rank[len] || len == max_len) {
                uint32_t fc = first_code[len];
                int64_t span = first_rank[len + 1] - first_rank[len];
                if (code >= fc && (int64_t)(code - fc) < span) {
                    out[i] = symbols_by_rank[first_rank[len] + (code - fc)];
                    found = 1;
                    break;
                }
            }
        }
        if (!found) return -1;
    }
    return n_symbols;
}
