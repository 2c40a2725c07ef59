// 2-bit lane packing of read code matrices (native fast path).
//
// Packs [n, L] uint8 value codes (0..4, 4 = N) into [n, WP] uint32 lanes
// (16 symbols per lane, earlier symbols in higher bits, tail zero-padded)
// plus an optional [n, NP] N-position bitmask (bit 31-j%32 of lane j/32).
// The numpy fallback lives in pgrc/core/packed.py (pack_lanes);
// this loop exists because the hot matrices are 10-200 MB and the numpy
// version materialises [n, W, 16] intermediates.
#include <cstdint>

extern "C" {

void pack_lanes_u32(const uint8_t *codes, int64_t n, int64_t L,
                    int64_t WP, uint32_t *out,
                    int64_t NP, uint32_t *nmask) {
    for (int64_t r = 0; r < n; r++) {
        const uint8_t *row = codes + r * L;
        uint32_t *o = out + r * WP;
        for (int64_t w = 0; w < WP; w++) o[w] = 0;
        for (int64_t j = 0; j < L; j++) {
            o[j >> 4] |= (uint32_t)(row[j] & 0x3) << (2 * (15 - (j & 15)));
        }
        if (nmask) {
            uint32_t *m = nmask + r * NP;
            for (int64_t w = 0; w < NP; w++) m[w] = 0;
            for (int64_t j = 0; j < L; j++) {
                if (row[j] > 3) m[j >> 5] |= 1u << (31 - (j & 31));
            }
        }
    }
}

}  // extern "C"
