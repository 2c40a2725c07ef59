// Adaptive byte-wise range coder — native fast path, bit-compatible with
// pgrc/streams/rangecoder.py (Subbotin-style 32-bit carryless coder,
// per-context adaptive frequencies, INC=32, halving at total > 2^16).
//
// Fills the role the vendored rangecoder plays in the reference
// (coders/RangeCoder.cpp + coders/rangecoder/*): the reference links a C
// coder; we compile this translation unit into a shared object loaded via
// ctypes (no pybind11 in the image).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t TOP = 1u << 24;
constexpr uint32_t BOT = 1u << 16;
constexpr uint32_t INC = 32;
constexpr uint32_t MAX_TOTAL = 1u << 16;

struct Model {
    uint32_t freq[256];
    uint32_t total;
    uint16_t nsym;

    void init(uint16_t n) {
        nsym = n;
        for (int i = 0; i < n; i++) freq[i] = 1;
        total = n;
    }
    void cum(int sym, uint32_t &lo, uint32_t &f) const {
        uint32_t c = 0;
        for (int i = 0; i < sym; i++) c += freq[i];
        lo = c;
        f = freq[sym];
    }
    int find(uint32_t scaled, uint32_t &lo, uint32_t &f) const {
        uint32_t c = 0;
        for (int i = 0; i < nsym; i++) {
            if (c + freq[i] > scaled) { lo = c; f = freq[i]; return i; }
            c += freq[i];
        }
        return -1;
    }
    void update(int sym) {
        freq[sym] += INC;
        total += INC;
        if (total > MAX_TOTAL) {
            uint32_t t = 0;
            for (int i = 0; i < nsym; i++) { freq[i] = (freq[i] + 1) >> 1; t += freq[i]; }
            total = t;
        }
    }
};

inline size_t ctx_index(int order, int period, int prev, size_t pos) {
    size_t base = order ? (size_t)prev : 0;
    return base * (size_t)period + (pos % (size_t)period);
}

// number of contexts for the order-k coder: nsym^order, capped so the
// model table stays small (n_ctx <= 2^22 and n_ctx * nsym <= 2^24 freqs);
// past the cap the modular context acts as a hash
inline size_t ctx_count(int nsym, int order) {
    size_t cap = (size_t)1 << 22;
    size_t mem_cap = ((size_t)1 << 24) / (size_t)nsym;
    if (mem_cap < cap) cap = mem_cap;
    if (cap < 1) cap = 1;
    size_t n = 1;
    for (int i = 0; i < order; i++) {
        n *= (size_t)nsym;
        if (n >= cap) return cap;
    }
    return n;
}

}  // namespace

extern "C" {

// Returns number of output bytes written to out (caller provides a buffer of
// at least n + n/16 + 64 bytes — adaptive coding of random data can slightly
// expand; the container's raw-store fallback handles that case).
int64_t rc_encode(const uint8_t *data, int64_t n, int order, int period,
                  int nsym, uint8_t *out, int64_t out_cap) {
    size_t n_ctx = (order ? (size_t)nsym : 1) * (size_t)period;
    std::vector<Model> models(n_ctx);
    for (auto &m : models) m.init((uint16_t)nsym);
    uint64_t low = 0;
    uint64_t rng = 0xFFFFFFFFull;
    int prev = 0;
    int64_t op = 0;
    for (int64_t pos = 0; pos < n; pos++) {
        int sym = data[pos];
        Model &m = models[ctx_index(order, period, prev, (size_t)pos)];
        uint32_t lo, f;
        m.cum(sym, lo, f);
        rng /= m.total;
        low = (low + (uint64_t)lo * rng) & 0xFFFFFFFFull;
        rng *= f;
        while (true) {
            if (((low ^ (low + rng)) & 0xFFFFFFFFull) < TOP) {
            } else if (rng < BOT) {
                rng = BOT - (low & (BOT - 1));
            } else {
                break;
            }
            if (op >= out_cap) return -1;
            out[op++] = (uint8_t)(low >> 24);
            low = (low << 8) & 0xFFFFFFFFull;
            rng <<= 8;
            if (rng > 0xFFFFFFFFull) rng = 0xFFFFFFFFull;
        }
        m.update(sym);
        prev = sym;
    }
    for (int i = 0; i < 4; i++) {
        if (op >= out_cap) return -1;
        out[op++] = (uint8_t)(low >> 24);
        low = (low << 8) & 0xFFFFFFFFull;
    }
    return op;
}

int64_t rc_decode(const uint8_t *data, int64_t data_len, int64_t count,
                  int order, int period, int nsym, uint8_t *out) {
    size_t n_ctx = (order ? (size_t)nsym : 1) * (size_t)period;
    std::vector<Model> models(n_ctx);
    for (auto &m : models) m.init((uint16_t)nsym);
    uint64_t code = 0;
    int64_t ip = 0;
    auto next_byte = [&]() -> uint8_t { return ip < data_len ? data[ip++] : 0; };
    for (int i = 0; i < 4; i++) code = (code << 8) | next_byte();
    uint64_t low = 0;
    uint64_t rng = 0xFFFFFFFFull;
    int prev = 0;
    for (int64_t pos = 0; pos < count; pos++) {
        Model &m = models[ctx_index(order, period, prev, (size_t)pos)];
        rng /= m.total;
        uint32_t scaled = (uint32_t)(((code - low) & 0xFFFFFFFFull) / rng);
        if (scaled >= m.total) scaled = m.total - 1;
        uint32_t lo, f;
        int sym = m.find(scaled, lo, f);
        if (sym < 0) return -1;
        low = (low + (uint64_t)lo * rng) & 0xFFFFFFFFull;
        rng *= f;
        while (true) {
            if (((low ^ (low + rng)) & 0xFFFFFFFFull) < TOP) {
            } else if (rng < BOT) {
                rng = BOT - (low & (BOT - 1));
            } else {
                break;
            }
            code = ((code << 8) | next_byte()) & 0xFFFFFFFFull;
            low = (low << 8) & 0xFFFFFFFFull;
            rng <<= 8;
            if (rng > 0xFFFFFFFFull) rng = 0xFFFFFFFFull;
        }
        m.update(sym);
        out[pos] = (uint8_t)sym;
        prev = sym;
    }
    return count;
}

// Order-k context-model range coder ("PPMd role"): the context is the last
// `order` symbols combined as ctx = (ctx * nsym + sym) mod nsym^order (cap
// 2^22 contexts). Same coder core and model update rule as rc_encode; the
// per-context models make it a fixed-order analog of the reference's PPMd
// streams (coders/PpmdCoder.cpp role, orders 2-13).
int64_t rcx_encode(const uint8_t *data, int64_t n, int nsym, int order,
                   uint8_t *out, int64_t out_cap) {
    size_t n_ctx = ctx_count(nsym, order);
    std::vector<Model> models(n_ctx);
    for (auto &m : models) m.init((uint16_t)nsym);
    uint64_t low = 0;
    uint64_t rng = 0xFFFFFFFFull;
    size_t ctx = 0;
    int64_t op = 0;
    for (int64_t pos = 0; pos < n; pos++) {
        int sym = data[pos];
        Model &m = models[ctx];
        uint32_t lo, f;
        m.cum(sym, lo, f);
        rng /= m.total;
        low = (low + (uint64_t)lo * rng) & 0xFFFFFFFFull;
        rng *= f;
        while (true) {
            if (((low ^ (low + rng)) & 0xFFFFFFFFull) < TOP) {
            } else if (rng < BOT) {
                rng = BOT - (low & (BOT - 1));
            } else {
                break;
            }
            if (op >= out_cap) return -1;
            out[op++] = (uint8_t)(low >> 24);
            low = (low << 8) & 0xFFFFFFFFull;
            rng <<= 8;
            if (rng > 0xFFFFFFFFull) rng = 0xFFFFFFFFull;
        }
        m.update(sym);
        ctx = (ctx * (size_t)nsym + (size_t)sym) % n_ctx;
    }
    for (int i = 0; i < 4; i++) {
        if (op >= out_cap) return -1;
        out[op++] = (uint8_t)(low >> 24);
        low = (low << 8) & 0xFFFFFFFFull;
    }
    return op;
}

int64_t rcx_decode(const uint8_t *data, int64_t data_len, int64_t count,
                   int nsym, int order, uint8_t *out) {
    size_t n_ctx = ctx_count(nsym, order);
    std::vector<Model> models(n_ctx);
    for (auto &m : models) m.init((uint16_t)nsym);
    uint64_t code = 0;
    int64_t ip = 0;
    auto next_byte = [&]() -> uint8_t { return ip < data_len ? data[ip++] : 0; };
    for (int i = 0; i < 4; i++) code = (code << 8) | next_byte();
    uint64_t low = 0;
    uint64_t rng = 0xFFFFFFFFull;
    size_t ctx = 0;
    for (int64_t pos = 0; pos < count; pos++) {
        Model &m = models[ctx];
        rng /= m.total;
        uint32_t scaled = (uint32_t)(((code - low) & 0xFFFFFFFFull) / rng);
        if (scaled >= m.total) scaled = m.total - 1;
        uint32_t lo, f;
        int sym = m.find(scaled, lo, f);
        if (sym < 0) return -1;
        low = (low + (uint64_t)lo * rng) & 0xFFFFFFFFull;
        rng *= f;
        while (true) {
            if (((low ^ (low + rng)) & 0xFFFFFFFFull) < TOP) {
            } else if (rng < BOT) {
                rng = BOT - (low & (BOT - 1));
            } else {
                break;
            }
            code = ((code << 8) | next_byte()) & 0xFFFFFFFFull;
            low = (low << 8) & 0xFFFFFFFFull;
            rng <<= 8;
            if (rng > 0xFFFFFFFFull) rng = 0xFFFFFFFFull;
        }
        m.update(sym);
        out[pos] = (uint8_t)sym;
        ctx = (ctx * (size_t)nsym + (size_t)sym) % n_ctx;
    }
    return count;
}

}  // extern "C"
