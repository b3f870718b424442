// A Zstandard frame decoder (RFC 8878, its content checksum XXH64
// included) and CRC32C (Castagnoli), with a plain C interface for ctypes.  It reads what TensorStore writes
// into an orbax checkpoint: OCDBT manifests and B+tree nodes (zstd
// frames, CRC32C footers) and zarr chunks (zstd frames).
//
// The decoder works on a whole frame in memory: the output buffer is the
// window, so a match may reach back to any byte already produced by the
// same frame.  Every read of the input is bounds-checked; a malformed
// input throws, and the C entry points turn that into an error message.
//
//   nd_zstd_decompress(src, n, &out, &out_len, err, err_cap)  0 on success
//   nd_free(out)
//   nd_crc32c(data, n)                                         CRC32C
//   nd_zstd_mode_counts(out, n, reset)       which format paths have run

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
    explicit Error(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load_le(const uint8_t* p, size_t n) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    if (n == 8) {
        uint64_t v;
        memcpy(&v, p, 8);
        return v;
    }
#endif
    uint64_t v = 0;
    for (size_t i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
    return v;
}

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
    return rotl64(acc + in * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
    return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        while (end - p >= 32) {
            v1 = xxh_round(v1, load_le(p, 8));
            v2 = xxh_round(v2, load_le(p + 8, 8));
            v3 = xxh_round(v3, load_le(p + 16, 8));
            v4 = xxh_round(v4, load_le(p + 24, 8));
            p += 32;
        }
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
    } else {
        h = seed + P5;
    }
    h += n;
    for (; end - p >= 8; p += 8) h = rotl64(h ^ xxh_round(0, load_le(p, 8)), 27) * P1 + P4;
    if (end - p >= 4) {
        h = rotl64(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; p++) h = rotl64(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// --------------------------------------------------------------- CRC32C

struct Crc32cTables {
    uint32_t t[8][256];
    Crc32cTables() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (int s = 1; s < 8; s++)
            for (int i = 0; i < 256; i++) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
    static const Crc32cTables tab;
    const auto& t = tab.t;
    uint32_t c = 0xFFFFFFFFu;
    for (; n >= 8; n -= 8, p += 8) {
        uint64_t v = load_le(p, 8) ^ c;
        c = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
            t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^
            t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
    }
    for (; n; n--, p++) c = (c >> 8) ^ t[0][(c ^ *p) & 0xFF];
    return ~c;
}

// ----------------------------------------------------------- mode counts

// How often each format path ran since the last reset, so a test can show
// that its corpus reached every block type, literals mode and sequences
// mode.  Order as in zstd.py's MODES.
enum Mode {
    BLOCK_RAW, BLOCK_RLE, BLOCK_COMPRESSED, LIT_RAW, LIT_RLE, LIT_HUFFMAN_1, LIT_HUFFMAN_4,
    LIT_TREELESS, WEIGHTS_DIRECT, WEIGHTS_FSE, SEQ_PREDEFINED, SEQ_RLE, SEQ_FSE, SEQ_REPEAT,
    FRAME_CHECKSUM, FRAME_SKIPPABLE, FRAME_WINDOW, FRAME_NO_SIZE, N_MODES
};
std::atomic<uint64_t> mode_counts[N_MODES];
inline void count(Mode m) { mode_counts[m].fetch_add(1, std::memory_order_relaxed); }

// ------------------------------------------------------------ bitstreams

// Forward bitstream (FSE table descriptions): least significant bit first.
struct ForwardBits {
    const uint8_t* p;
    size_t n;
    size_t pos = 0;  // bits consumed
    ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
    uint32_t peek(int bits) const {
        size_t byte = pos >> 3;
        if (byte >= n) fail("FSE table description runs past its block");
        uint64_t v = load_le(p + byte, n - byte < 8 ? n - byte : 8) >> (pos & 7);
        return uint32_t(v & ((1ULL << bits) - 1));
    }
    void skip(int bits) {
        pos += bits;
        if ((pos + 7) / 8 > n) fail("FSE table description runs past its block");
    }
    size_t bytes() const { return (pos + 7) / 8; }
};

// Backward bitstream (Huffman and FSE payloads): written forward, read from
// the last byte down, starting under the highest set bit of the last byte.
// Bits below the start of the buffer read as zeros; `pos` then goes
// negative, which is how a stream reports that it is overrun.
struct BackwardBits {
    const uint8_t* p;
    size_t n;
    int64_t pos;  // bits not yet consumed
    BackwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
        if (n == 0) fail("empty bitstream");
        uint8_t last = p[n - 1];
        if (last == 0) fail("bitstream's last byte is zero (no end mark)");
        pos = int64_t(n - 1) * 8 + highbit(last);
    }
    uint64_t extract(int64_t at, int bits) const {  // bits [at, at+bits), at >= 0
        size_t byte = size_t(at >> 3);
        size_t avail = n - byte < 8 ? n - byte : 8;
        uint64_t v = load_le(p + byte, avail) >> (at & 7);
        return v & ((1ULL << bits) - 1);
    }
    uint64_t peek(int bits) const {
        if (bits == 0) return 0;
        int64_t at = pos - bits;
        if (at >= 0) return extract(at, bits);
        int64_t have = pos > 0 ? pos : 0;
        return have ? extract(0, int(have)) << (bits - have) : 0;
    }
    uint64_t read(int bits) {
        uint64_t v = peek(bits);
        pos -= bits;
        return v;
    }
};

// ------------------------------------------------------------------- FSE

struct FseEntry {
    uint16_t symbol;
    uint8_t bits;
    uint16_t base;  // next state = base + read(bits)
};

struct FseTable {
    int accuracy = 0;
    std::vector<FseEntry> e;
    bool ok = false;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int accuracy) {
    int size = 1 << accuracy;
    t.accuracy = accuracy;
    t.e.assign(size, FseEntry{0, 0, 0});
    std::vector<uint16_t> next(nsym);
    int high = size - 1;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] == -1) {
            t.e[high--].symbol = uint16_t(s);
            next[s] = 1;
        } else {
            next[s] = uint16_t(norm[s]);
        }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; s++) {
        for (int i = 0; i < norm[s]; i++) {
            t.e[pos].symbol = uint16_t(s);
            do pos = (pos + step) & mask; while (pos > high);
        }
    }
    if (pos != 0) fail("FSE table: probabilities do not fill the table");
    for (int u = 0; u < size; u++) {
        uint16_t s = t.e[u].symbol;
        uint32_t x = next[s]++;
        int bits = accuracy - highbit(x);
        t.e[u].bits = uint8_t(bits);
        t.e[u].base = uint16_t((x << bits) - size);
    }
    t.ok = true;
}

// Reads an FSE table description; returns the bytes it took.
size_t fse_read(FseTable& t, const uint8_t* p, size_t n, int max_accuracy, int max_symbol) {
    ForwardBits b(p, n);
    int accuracy = int(b.peek(4)) + 5;
    b.skip(4);
    if (accuracy > max_accuracy)
        fail("FSE accuracy log " + std::to_string(accuracy) + " over " +
             std::to_string(max_accuracy));
    int remaining = (1 << accuracy) + 1, threshold = 1 << accuracy, bits = accuracy + 1;
    std::vector<int16_t> norm;
    while (remaining > 1) {
        if (int(norm.size()) > max_symbol) fail("FSE table: too many symbols");
        int max = (2 * threshold - 1) - remaining, value;
        uint32_t low = b.peek(bits - 1);
        if (int(low) < max) {
            value = int(low);
            b.skip(bits - 1);
        } else {
            value = int(b.peek(bits));
            if (value >= threshold) value -= max;
            b.skip(bits);
        }
        int count = value - 1;
        remaining -= count < 0 ? -count : count;
        norm.push_back(int16_t(count));
        if (count == 0) {  // runs of zero probabilities
            while (true) {
                int rep = int(b.peek(2));
                b.skip(2);
                for (int i = 0; i < rep; i++) norm.push_back(0);
                if (rep != 3) break;
            }
            if (int(norm.size()) > max_symbol + 1) fail("FSE table: too many symbols");
        }
        while (remaining < threshold && threshold > 1) {
            bits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1 || int(norm.size()) > max_symbol + 1)
        fail("FSE table description is corrupted");
    fse_build(t, norm.data(), int(norm.size()), accuracy);
    return b.bytes();
}

void fse_rle(FseTable& t, int symbol) {
    t.accuracy = 0;
    t.e.assign(1, FseEntry{uint16_t(symbol), 0, 0});
    t.ok = true;
}

struct FseState {
    const FseTable* t;
    uint32_t state;
    void init(const FseTable& table, BackwardBits& b) {
        t = &table;
        state = uint32_t(b.read(table.accuracy));
    }
    uint16_t symbol() const { return t->e[state].symbol; }
    void update(BackwardBits& b) {
        const FseEntry& e = t->e[state];
        state = e.base + uint32_t(b.read(e.bits));
    }
};

// ---------------------------------------------------------------- Huffman

constexpr int HUF_MAX_BITS = 11;

struct Huffman {
    int max_bits = 0;
    std::vector<uint8_t> symbol, bits;  // indexed by max_bits peeked bits
    bool ok = false;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t huffman_read(Huffman& h, const uint8_t* p, size_t n) {
    if (n < 1) fail("Huffman tree description missing");
    uint8_t header = p[0];
    std::vector<uint8_t> w;
    size_t used;
    if (header >= 128) {  // direct: 4 bits per weight
        count(WEIGHTS_DIRECT);
        size_t count = header - 127, bytes = (count + 1) / 2;
        if (1 + bytes > n) fail("Huffman weights run past the literals");
        for (size_t i = 0; i < count; i++) {
            uint8_t byte = p[1 + i / 2];
            w.push_back(i % 2 == 0 ? byte >> 4 : byte & 15);
        }
        used = 1 + bytes;
    } else {  // FSE-coded weights, two interleaved states
        count(WEIGHTS_FSE);
        size_t size = header;
        if (1 + size > n || size == 0) fail("Huffman weights run past the literals");
        FseTable t;
        size_t desc = fse_read(t, p + 1, size, 6, 255);
        if (desc >= size) fail("Huffman weights: no bitstream after the FSE table");
        BackwardBits b(p + 1 + desc, size - desc);
        FseState s1, s2;
        s1.init(t, b);
        s2.init(t, b);
        while (true) {
            if (w.size() > 254) fail("Huffman weights: too many symbols");
            w.push_back(uint8_t(s1.symbol()));
            s1.update(b);
            if (b.pos < 0) {
                w.push_back(uint8_t(s2.symbol()));
                break;
            }
            w.push_back(uint8_t(s2.symbol()));
            s2.update(b);
            if (b.pos < 0) {
                w.push_back(uint8_t(s1.symbol()));
                break;
            }
        }
        used = 1 + size;
    }
    if (w.size() > 255) fail("Huffman weights: too many symbols");
    uint32_t total = 0;
    for (uint8_t x : w) {
        if (x > HUF_MAX_BITS) fail("Huffman weight over " + std::to_string(HUF_MAX_BITS));
        if (x) total += 1u << (x - 1);
    }
    if (total == 0) fail("Huffman weights are all zero");
    int max_bits = highbit(total) + 1;
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) fail("Huffman weights do not sum to a power of two");
    w.push_back(uint8_t(highbit(rest) + 1));  // the last symbol's implied weight
    if (max_bits > HUF_MAX_BITS) fail("Huffman code longer than 11 bits");
    h.max_bits = max_bits;
    h.symbol.assign(size_t(1) << max_bits, 0);
    h.bits.assign(size_t(1) << max_bits, 0);
    size_t pos = 0;
    for (int weight = 1; weight <= max_bits; weight++) {
        for (size_t s = 0; s < w.size(); s++) {
            if (w[s] != weight) continue;
            size_t run = size_t(1) << (weight - 1);
            for (size_t i = 0; i < run; i++) {
                h.symbol[pos + i] = uint8_t(s);
                h.bits[pos + i] = uint8_t(max_bits + 1 - weight);
            }
            pos += run;
        }
    }
    if (pos != (size_t(1) << max_bits)) fail("Huffman table is incomplete");
    h.ok = true;
    return used;
}

// Decodes `ns` Huffman streams (1, or the 4 of a jump table) of count[k]
// symbols each.  Away from its ends a stream's next code is read with one
// unaligned 8-byte load, and the streams advance in turns, so the four
// dependency chains overlap; near its ends each takes the bounds-checked
// path.  Every stream must be consumed exactly.
void huffman_streams(const Huffman& h, BackwardBits* b, uint8_t* const* out,
                     const size_t* count, int ns) {
    const int mb = h.max_bits;
    const uint8_t* symbol = h.symbol.data();
    const uint8_t* bits = h.bits.data();
    const uint64_t mask = (uint64_t(1) << mb) - 1;
    size_t idx[4] = {0, 0, 0, 0};
    auto fast = [&](int k) {
        int64_t at = b[k].pos - mb;
        return at >= 0 && size_t(at >> 3) + 8 <= b[k].n;
    };
    auto step_fast = [&](int k) {
        int64_t at = b[k].pos - mb;
        uint64_t v;
        memcpy(&v, b[k].p + (at >> 3), 8);
        uint64_t index = (v >> (at & 7)) & mask;
        out[k][idx[k]++] = symbol[index];
        b[k].pos -= bits[index];
    };
    auto step_safe = [&](int k) {
        uint64_t index = b[k].peek(mb);
        out[k][idx[k]++] = symbol[index];
        b[k].pos -= bits[index];
    };
    for (int k = 0; k < ns; k++)  // the top of each stream
        while (idx[k] < count[k] && !fast(k)) step_safe(k);
    if (ns == 4) {
        // The turns in locals: a byte store may alias any memory, so state
        // kept in the structs would be reloaded after every symbol.
        int64_t pos[4] = {b[0].pos, b[1].pos, b[2].pos, b[3].pos};
        const uint8_t* src[4] = {b[0].p, b[1].p, b[2].p, b[3].p};
        uint8_t* dst[4] = {out[0] + idx[0], out[1] + idx[1], out[2] + idx[2], out[3] + idx[3]};
        size_t n = count[0] - idx[0];
        for (int k = 1; k < 4; k++) n = std::min(n, count[k] - idx[k]);
        // Past the top of each stream (above) a window only moves down, so
        // it stays inside its stream while it starts at or above bit 0.
        size_t i = 0;
        for (; i < n; i++) {
            if (pos[0] < mb || pos[1] < mb || pos[2] < mb || pos[3] < mb) break;
            for (int k = 0; k < 4; k++) {
                int64_t at = pos[k] - mb;
                uint64_t v;
                memcpy(&v, src[k] + (at >> 3), 8);
                uint64_t index = (v >> (at & 7)) & mask;
                dst[k][i] = symbol[index];
                pos[k] -= bits[index];
            }
        }
        for (int k = 0; k < 4; k++) {
            b[k].pos = pos[k];
            idx[k] += i;
        }
    }
    for (int k = 0; k < ns; k++) {
        while (idx[k] < count[k]) {
            if (fast(k)) step_fast(k);
            else step_safe(k);
        }
        if (b[k].pos != 0) fail("Huffman stream not consumed exactly");
    }
}

// -------------------------------------------------------------- sequences

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22,  23,  24,  25,   26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37,  39,  41,  43,   47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1,  1,  1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
    Huffman huffman;
    FseTable ll, of, ml;
    uint64_t rep[3] = {1, 4, 8};
};

// Reads one sequence table's mode and description; returns the bytes it took.
size_t sequence_table(FseTable& t, int mode, const uint8_t* p, size_t n, const int16_t* dflt,
                      int dflt_n, int dflt_acc, int max_acc, int max_symbol, const char* name) {
    count(Mode(SEQ_PREDEFINED + mode));
    switch (mode) {
        case 0:
            fse_build(t, dflt, dflt_n, dflt_acc);
            return 0;
        case 1:
            if (n < 1) fail(std::string(name) + " RLE symbol missing");
            if (p[0] > max_symbol) fail(std::string(name) + " RLE symbol out of range");
            fse_rle(t, p[0]);
            return 1;
        case 2:
            return fse_read(t, p, n, max_acc, max_symbol);
        default:
            if (!t.ok) fail(std::string(name) + " table repeated with no earlier table");
            return 0;
    }
}

void decode_literals(FrameState& fs, const uint8_t*& p, const uint8_t* end,
                     std::vector<uint8_t>& lit) {
    if (p >= end) fail("literals section missing");
    int type = p[0] & 3, format = (p[0] >> 2) & 3;
    size_t avail = size_t(end - p);
    if (type == 0 || type == 1) {  // raw or RLE
        size_t size, header;
        if (format == 0 || format == 2) {
            size = p[0] >> 3;
            header = 1;
        } else if (format == 1) {
            if (avail < 2) fail("literals header truncated");
            size = (p[0] >> 4) + (size_t(p[1]) << 4);
            header = 2;
        } else {
            if (avail < 3) fail("literals header truncated");
            size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
            header = 3;
        }
        if (size > 128 * 1024) fail("literals over 128 KiB");
        p += header;
        lit.resize(size);
        count(type == 0 ? LIT_RAW : LIT_RLE);
        if (type == 0) {
            if (size_t(end - p) < size) fail("raw literals run past the block");
            if (size) memcpy(lit.data(), p, size);
            p += size;
        } else {
            if (p >= end) fail("RLE literal missing");
            memset(lit.data(), *p, size);
            p += 1;
        }
        return;
    }
    // Huffman-coded (2) or treeless (3)
    size_t regen, comp, header;
    int streams = format == 0 ? 1 : 4;
    if (format <= 1) {
        if (avail < 3) fail("literals header truncated");
        uint32_t h = uint32_t(load_le(p, 3));
        regen = (h >> 4) & 0x3FF;
        comp = (h >> 14) & 0x3FF;
        header = 3;
    } else if (format == 2) {
        if (avail < 4) fail("literals header truncated");
        uint32_t h = uint32_t(load_le(p, 4));
        regen = (h >> 4) & 0x3FFF;
        comp = (h >> 18) & 0x3FFF;
        header = 4;
    } else {
        if (avail < 5) fail("literals header truncated");
        uint64_t h = load_le(p, 5);
        regen = (h >> 4) & 0x3FFFF;
        comp = (h >> 22) & 0x3FFFF;
        header = 5;
    }
    if (regen > 128 * 1024) fail("literals over 128 KiB");
    p += header;
    if (size_t(end - p) < comp) fail("compressed literals run past the block");
    const uint8_t* q = p;
    size_t left = comp;
    if (type == 2) {
        size_t used = huffman_read(fs.huffman, q, left);
        q += used;
        left -= used;
    } else if (!fs.huffman.ok) {
        fail("treeless literals with no earlier Huffman table");
    }
    lit.resize(regen);
    count(type == 3 ? LIT_TREELESS : streams == 1 ? LIT_HUFFMAN_1 : LIT_HUFFMAN_4);
    if (streams == 1) {
        BackwardBits b(q, left);
        uint8_t* out = lit.data();
        huffman_streams(fs.huffman, &b, &out, &regen, 1);
    } else {
        if (left < 6) fail("jump table truncated");
        size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
        if (s1 + s2 + s3 > left - 6) fail("jump table sizes exceed the literals");
        size_t s4 = left - 6 - s1 - s2 - s3;
        size_t each = (regen + 3) / 4;
        if (3 * each > regen) fail("four literal streams for too few literals");
        const uint8_t* d = q + 6;
        BackwardBits b[4] = {BackwardBits(d, s1), BackwardBits(d + s1, s2),
                             BackwardBits(d + s1 + s2, s3), BackwardBits(d + s1 + s2 + s3, s4)};
        uint8_t* out[4] = {lit.data(), lit.data() + each, lit.data() + 2 * each,
                           lit.data() + 3 * each};
        size_t count[4] = {each, each, each, regen - 3 * each};
        huffman_streams(fs.huffman, b, out, count, 4);
    }
    p += comp;
}

void decode_block(FrameState& fs, const uint8_t* p, size_t n, std::vector<uint8_t>& out,
                  size_t frame_start) {
    const uint8_t* end = p + n;
    std::vector<uint8_t> lit;
    decode_literals(fs, p, end, lit);
    if (p >= end) fail("sequences section missing");
    size_t nseq;
    uint8_t b0 = *p++;
    if (b0 < 128) {
        nseq = b0;
    } else if (b0 < 255) {
        if (p >= end) fail("sequence count truncated");
        nseq = (size_t(b0 - 128) << 8) + *p++;
    } else {
        if (end - p < 2) fail("sequence count truncated");
        nseq = p[0] + (size_t(p[1]) << 8) + 0x7F00;
        p += 2;
    }
    size_t lit_pos = 0;
    if (nseq > 0) {
        if (p >= end) fail("symbol compression modes missing");
        uint8_t modes = *p++;
        if (modes & 3) fail("reserved bits set in symbol compression modes");
        p += sequence_table(fs.ll, modes >> 6, p, size_t(end - p), LL_DEFAULT, 36, 6, 9, 35,
                            "literal-length");
        p += sequence_table(fs.of, (modes >> 4) & 3, p, size_t(end - p), OF_DEFAULT, 29, 5, 8,
                            31, "offset");
        p += sequence_table(fs.ml, (modes >> 2) & 3, p, size_t(end - p), ML_DEFAULT, 53, 6, 9,
                            52, "match-length");
        if (p >= end) fail("sequences bitstream missing");
        BackwardBits b(p, size_t(end - p));
        FseState ll, of, ml;
        ll.init(fs.ll, b);
        of.init(fs.of, b);
        ml.init(fs.ml, b);
        for (size_t i = 0; i < nseq; i++) {
            uint16_t of_code = of.symbol(), ml_code = ml.symbol(), ll_code = ll.symbol();
            if (of_code > 31 || ml_code > 52 || ll_code > 35) fail("sequence code out of range");
            uint64_t of_value = (uint64_t(1) << of_code) + b.read(of_code);
            uint64_t ml_len = ML_BASE[ml_code] + b.read(ML_BITS[ml_code]);
            uint64_t ll_len = LL_BASE[ll_code] + b.read(LL_BITS[ll_code]);
            uint64_t offset;
            uint64_t* rep = fs.rep;
            if (of_value > 3) {
                offset = of_value - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else {
                int idx = int(of_value - 1) + (ll_len == 0 ? 1 : 0);
                if (idx == 0) {
                    offset = rep[0];
                } else if (idx == 1) {
                    offset = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                } else if (idx == 2) {
                    offset = rep[2];
                    rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                } else {
                    offset = rep[0] - 1;
                    rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                }
            }
            if (i + 1 < nseq) {  // no update after the last sequence
                ll.update(b);
                ml.update(b);
                of.update(b);
            }
            if (b.pos < 0) fail("sequences bitstream overrun");
            if (ll_len > lit.size() - lit_pos) fail("sequence takes more literals than exist");
            out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + ll_len);
            lit_pos += ll_len;
            size_t produced = out.size() - frame_start;
            if (offset == 0 || offset > produced)
                fail("match offset " + std::to_string(offset) + " reaches before the frame");
            size_t at = out.size();
            out.resize(at + ml_len);
            uint8_t* dst = out.data() + at;
            const uint8_t* from = dst - offset;
            if (offset >= ml_len) {
                memcpy(dst, from, ml_len);
            } else {  // overlapping: the match repeats its own output
                for (uint64_t k = 0; k < ml_len; k++) dst[k] = from[k];
            }
        }
        if (b.pos != 0) fail("sequences bitstream not consumed exactly");
    }
    out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

// Decodes one frame starting at p; returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
    if (n < 4) fail("truncated frame magic");
    uint32_t magic = uint32_t(load_le(p, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        if (n < 8) fail("truncated skippable frame");
        uint64_t size = load_le(p + 4, 4);
        if (size > n - 8) fail("skippable frame runs past the input");
        count(FRAME_SKIPPABLE);
        return size_t(8 + size);
    }
    if (magic != 0xFD2FB528u) {
        char buf[64];
        snprintf(buf, sizeof buf, "not a zstd frame (magic 0x%08x)", magic);
        fail(buf);
    }
    size_t i = 4;
    if (i >= n) fail("truncated frame header");
    uint8_t fhd = p[i++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header");
    if (!single) {
        if (i >= n) fail("truncated frame header");
        i++;  // window descriptor: the whole frame is decoded in memory
        count(FRAME_WINDOW);
    }
    const int did_sizes[4] = {0, 1, 2, 4};
    int did_size = did_sizes[did_flag];
    if (n - i < size_t(did_size)) fail("truncated frame header");
    uint64_t dict_id = load_le(p + i, did_size);
    i += did_size;
    if (dict_id != 0)
        fail("frame needs dictionary " + std::to_string(dict_id) + "; dictionaries are not supported");
    const int fcs_sizes[4] = {0, 2, 4, 8};
    int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : fcs_sizes[fcs_flag];
    if (n - i < size_t(fcs_size)) fail("truncated frame header");
    bool has_size = fcs_size > 0;
    if (!has_size) count(FRAME_NO_SIZE);
    uint64_t content_size = load_le(p + i, fcs_size) + (fcs_size == 2 ? 256 : 0);
    i += fcs_size;
    size_t start = out.size();
    if (has_size && content_size < (uint64_t(1) << 32)) out.reserve(start + content_size);
    FrameState fs;
    while (true) {
        if (n - i < 3) fail("truncated block header");
        uint32_t bh = uint32_t(load_le(p + i, 3));
        i += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t size = bh >> 3;
        if (size > 128 * 1024) fail("block over 128 KiB");
        if (type < 3) count(Mode(BLOCK_RAW + type));
        if (type == 0) {
            if (n - i < size) fail("raw block runs past the input");
            out.insert(out.end(), p + i, p + i + size);
            i += size;
        } else if (type == 1) {
            if (i >= n) fail("RLE block byte missing");
            out.insert(out.end(), size, p[i]);
            i += 1;
        } else if (type == 2) {
            if (n - i < size) fail("compressed block runs past the input");
            decode_block(fs, p + i, size, out, start);
            i += size;
        } else {
            fail("reserved block type");
        }
        if (last) break;
    }
    size_t produced = out.size() - start;
    if (has_size && produced != content_size)
        fail("frame content size " + std::to_string(content_size) + " but " +
             std::to_string(produced) + " bytes decoded");
    if (checksum) {
        if (n - i < 4) fail("content checksum missing");
        uint32_t want = uint32_t(load_le(p + i, 4));
        uint32_t got = uint32_t(xxh64(out.data() + start, produced, 0));
        if (want != got) fail("content checksum mismatch");
        count(FRAME_CHECKSUM);
        i += 4;
    }
    return i;
}

void set_error(char* err, size_t cap, const char* what) {
    if (!err || cap == 0) return;
    size_t k = strlen(what);
    if (k >= cap) k = cap - 1;
    memcpy(err, what, k);
    err[k] = 0;
}

}  // namespace

extern "C" {

// Decodes every frame in src[0:n) (concatenated frames, skippable frames
// skipped).  On success stores a malloc'ed buffer (free with nd_free) and
// its length and returns 0; else writes the reason into err and returns 1.
int nd_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len, char* err,
                       size_t err_cap) {
    *out = nullptr;
    *out_len = 0;
    try {
        std::vector<uint8_t> buf;
        size_t i = 0;
        if (n == 0) fail("empty input: no zstd frame");
        while (i < n) i += decode_frame(src + i, n - i, buf);
        uint8_t* mem = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
        if (!mem) fail("out of memory");
        if (!buf.empty()) memcpy(mem, buf.data(), buf.size());
        *out = mem;
        *out_len = buf.size();
        return 0;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return 1;
    }
}

void nd_free(void* p) { free(p); }

uint32_t nd_crc32c(const uint8_t* data, size_t n) { return crc32c(data, n); }

// Copies the mode counts (at most n) into out and returns how many there
// are; reset != 0 zeroes them after the copy.
int nd_zstd_mode_counts(uint64_t* out, int n, int reset) {
    for (int m = 0; m < N_MODES; m++) {
        if (m < n) out[m] = mode_counts[m].load(std::memory_order_relaxed);
        if (reset) mode_counts[m].store(0, std::memory_order_relaxed);
    }
    return N_MODES;
}

}  // extern "C"
