// Native rANS entropy coder for alice_codec_tpu.
//
// Bit-exact re-implementation of the reference 32-bit rANS
// (reference: src/rans.rs — PROB_BITS=12, PROB_SCALE=4096, RANS32_L=1<<23,
// byte renormalization, LIFO encode with final output reversal).
//
// This is the host-serial half of the codec: the TPU device pipeline
// produces symbols + histograms; these routines turn them into the
// reference-compatible `.alc` byte streams (and back).  The TPU-native
// wide-interleaved entropy path lives in ops/rans_device.py; this file also
// provides the generalized N-way interleaved coder used by that path's
// container framing.
//
// Build: g++ -O3 -shared -fPIC (driven by alice_codec_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t PROB_BITS = 12;
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint32_t RANS32_L = 1u << 23;

}  // namespace

extern "C" {

// Build a normalized frequency table from a histogram.
// Mirrors FrequencyTable::from_histogram (reference src/rans.rs:102-150):
// counts scaled to PROB_SCALE with minimum frequency 1, the last symbol's
// frequency adjusted so the total is exactly PROB_SCALE, and a 4096-entry
// cumulative→symbol decode LUT.  Falls back to the uniform table
// (src/rans.rs:158-189) when the histogram is all-zero.
void alc_freq_table(const uint32_t* hist, int32_t n_symbols,
                    uint16_t* freq, uint16_t* cum, uint8_t* cum2sym,
                    int32_t sanitize) {
    uint64_t total = 0;
    for (int32_t i = 0; i < n_symbols; ++i) total += hist[i];

    if (total == 0) {
        // uniform(n)
        uint16_t per = static_cast<uint16_t>(PROB_SCALE / n_symbols);
        uint16_t c = 0;
        for (int32_t i = 0; i < n_symbols; ++i) {
            cum[i] = c;
            freq[i] = per;
            c = static_cast<uint16_t>(c + per);
        }
        if (n_symbols > 0) {
            freq[n_symbols - 1] =
                static_cast<uint16_t>(PROB_SCALE - cum[n_symbols - 1]);
        }
    } else {
        std::vector<uint32_t> f(n_symbols);
        uint64_t sum = 0;
        for (int32_t i = 0; i < n_symbols; ++i) {
            if (hist[i] == 0) {
                f[i] = 1;
            } else {
                f[i] = static_cast<uint32_t>(
                    (static_cast<uint64_t>(hist[i]) * PROB_SCALE) / total);
                if (f[i] < 1) f[i] = 1;
            }
            sum += f[i];
        }
        // With sanitize=0 this is the reference-exact table: prefix-sum
        // cums + last-symbol adjustment (src/rans.rs:111-131) — which is
        // *latently invalid* (used-symbol slots may cross PROB_SCALE and
        // corrupt the stream if an encoded state lands in the overlap).
        // With sanitize=1 the whole table is renormalized to sum
        // PROB_SCALE by stealing from the largest frequencies, giving a
        // valid table for the same histogram (used when the reference
        // table actually overflowed during encode, or for ALC2 streams).
        if (sanitize && sum > PROB_SCALE) {
            uint64_t excess = sum - PROB_SCALE;
            while (excess > 0) {
                int32_t imax = 0;
                for (int32_t i = 1; i < n_symbols; ++i)
                    if (f[i] > f[imax]) imax = i;
                uint64_t take = std::min<uint64_t>(excess, f[imax] - 1);
                if (take == 0) break;  // unreachable for n <= PROB_SCALE
                f[imax] -= take;
                excess -= take;
            }
        }

        uint32_t cum_freq = 0;
        for (int32_t i = 0; i < n_symbols; ++i) {
            cum[i] = static_cast<uint16_t>(cum_freq);
            freq[i] = static_cast<uint16_t>(f[i]);
            cum_freq += f[i];
        }
        if (n_symbols > 0 && cum_freq != PROB_SCALE) {
            int32_t diff = static_cast<int32_t>(PROB_SCALE) -
                           static_cast<int32_t>(cum_freq);
            freq[n_symbols - 1] =
                static_cast<uint16_t>(static_cast<int32_t>(freq[n_symbols - 1]) + diff);
        }
    }

    std::memset(cum2sym, 0, PROB_SCALE);
    for (int32_t s = 0; s < n_symbols; ++s) {
        uint32_t start = cum[s];
        uint32_t end = std::min<uint32_t>(start + freq[s], PROB_SCALE);
        for (uint32_t slot = start; slot < end; ++slot)
            cum2sym[slot] = static_cast<uint8_t>(s);
    }
}

// Encode symbols onto an existing rANS state, appending raw (unreversed)
// renormalization bytes to `out`.  Symbols are consumed in REVERSE order
// (LIFO), matching RansEncoder::encode_symbols (src/rans.rs:288-294).
// Returns the number of bytes appended; *state is updated in place.
// `out` capacity must be >= 2*n (worst case ~1.5 bytes/symbol + slack).
int64_t alc_rans_encode_put(uint32_t* state, const uint8_t* syms, int64_t n,
                            const uint16_t* freq, const uint16_t* cum,
                            uint8_t* out, int32_t* overflowed) {
    uint32_t x = *state;
    int64_t pos = 0;
    int32_t ovf = 0;
    for (int64_t i = n - 1; i >= 0; --i) {
        uint8_t s = syms[i];
        uint32_t f = freq[s];
        uint64_t x_max =
            ((static_cast<uint64_t>(RANS32_L >> PROB_BITS)) << 8) * f;
        while (static_cast<uint64_t>(x) >= x_max) {
            out[pos++] = static_cast<uint8_t>(x & 0xFF);
            x >>= 8;
        }
        uint32_t q = x / f;
        uint32_t slot = (x - q * f) + cum[s];
        // The decoder reads slot & 4095; a slot past PROB_SCALE means the
        // (reference-exact) table cannot represent this stream losslessly.
        if (slot >= PROB_SCALE) ovf = 1;
        x = (q << PROB_BITS) + slot;
    }
    *state = x;
    if (overflowed) *overflowed |= ovf;
    return pos;
}

// Finish a stream: append the 4 state-flush bytes (LSB first) then reverse
// the whole buffer in place (src/rans.rs:298-308).  Returns final length.
int64_t alc_rans_finish(uint32_t state, uint8_t* buf, int64_t len) {
    buf[len++] = static_cast<uint8_t>(state & 0xFF);
    buf[len++] = static_cast<uint8_t>((state >> 8) & 0xFF);
    buf[len++] = static_cast<uint8_t>((state >> 16) & 0xFF);
    buf[len++] = static_cast<uint8_t>((state >> 24) & 0xFF);
    std::reverse(buf, buf + len);
    return len;
}

// One-shot single-stream encode (fresh state). Returns output length.
int64_t alc_rans_encode(const uint8_t* syms, int64_t n,
                        const uint16_t* freq, const uint16_t* cum,
                        uint8_t* out, int32_t* overflowed) {
    uint32_t state = RANS32_L;
    int64_t len = alc_rans_encode_put(&state, syms, n, freq, cum, out, overflowed);
    return alc_rans_finish(state, out, len);
}

// Decode `n` symbols from a stream, resuming from (*state, *pos).
// Initializes the state from the first 4 big-endian bytes when *pos == 0
// (src/rans.rs:341-347); decodes per src/rans.rs:351-371.
void alc_rans_decode_n(const uint8_t* data, int64_t len, int64_t n,
                       const uint16_t* freq, const uint16_t* cum,
                       const uint8_t* cum2sym, uint8_t* out,
                       uint32_t* state, int64_t* pos) {
    uint32_t x = *state;
    int64_t p = *pos;
    if (p == 0 && len >= 4) {
        x = (static_cast<uint32_t>(data[0]) << 24) |
            (static_cast<uint32_t>(data[1]) << 16) |
            (static_cast<uint32_t>(data[2]) << 8) |
            static_cast<uint32_t>(data[3]);
        p = 4;
    }
    for (int64_t i = 0; i < n; ++i) {
        uint32_t slot = x & (PROB_SCALE - 1);
        uint8_t s = cum2sym[slot];
        uint32_t f = freq[s];
        x = static_cast<uint32_t>(static_cast<uint64_t>(f) * (x >> PROB_BITS) +
                                  slot - cum[s]);
        while (x < RANS32_L && p < len) {
            x = (x << 8) | data[p++];
        }
        out[i] = s;
    }
    *state = x;
    *pos = p;
}

// 4-way interleaved encode (InterleavedRansEncoder, src/rans.rs:393-454).
// Symbol i goes to stream i%4; each stream is a LIFO rANS stream; wire
// format = 4×u32 LE stream lengths + 4×u32 LE symbol counts + streams.
// Returns total output length. `out` capacity >= 2*n + 48.
int64_t alc_rans_encode4(const uint8_t* syms, int64_t n,
                         const uint16_t* freq, const uint16_t* cum,
                         uint8_t* out) {
    uint32_t states[4] = {RANS32_L, RANS32_L, RANS32_L, RANS32_L};
    std::vector<uint8_t> streams[4];
    for (int k = 0; k < 4; ++k) streams[k].reserve(n / 2 + 8);

    for (int64_t i = n - 1; i >= 0; --i) {
        int k = static_cast<int>(i & 3);
        uint8_t s = syms[i];
        uint32_t f = freq[s];
        uint32_t& x = states[k];
        uint64_t x_max =
            ((static_cast<uint64_t>(RANS32_L >> PROB_BITS)) << 8) * f;
        while (static_cast<uint64_t>(x) >= x_max) {
            streams[k].push_back(static_cast<uint8_t>(x & 0xFF));
            x >>= 8;
        }
        uint32_t q = x / f;
        x = (q << PROB_BITS) + (x - q * f) + cum[s];
    }

    int64_t pos = 32;  // header written below
    for (int k = 0; k < 4; ++k) {
        uint32_t x = states[k];
        streams[k].push_back(static_cast<uint8_t>(x & 0xFF));
        streams[k].push_back(static_cast<uint8_t>((x >> 8) & 0xFF));
        streams[k].push_back(static_cast<uint8_t>((x >> 16) & 0xFF));
        streams[k].push_back(static_cast<uint8_t>((x >> 24) & 0xFF));
        std::reverse(streams[k].begin(), streams[k].end());

        uint32_t slen = static_cast<uint32_t>(streams[k].size());
        std::memcpy(out + 4 * k, &slen, 4);  // LE on all supported targets
        uint32_t count = static_cast<uint32_t>((n + 3 - k) / 4);
        std::memcpy(out + 16 + 4 * k, &count, 4);
        std::memcpy(out + pos, streams[k].data(), slen);
        pos += slen;
    }
    return pos;
}

// 4-way interleaved decode (InterleavedRansDecoder, src/rans.rs:471-523).
void alc_rans_decode4(const uint8_t* data, int64_t len, int64_t n,
                      const uint16_t* freq, const uint16_t* cum,
                      const uint8_t* cum2sym, uint8_t* out) {
    uint32_t slen[4], scount[4];
    std::memcpy(slen, data, 16);
    std::memcpy(scount, data + 16, 16);
    (void)len;

    const uint8_t* ptr[4];
    int64_t spos[4], send[4];
    uint32_t states[4];
    int64_t off = 32;
    for (int k = 0; k < 4; ++k) {
        ptr[k] = data + off;
        send[k] = slen[k];
        off += slen[k];
        states[k] = 0;
        spos[k] = 0;
        if (send[k] >= 4) {
            states[k] = (static_cast<uint32_t>(ptr[k][0]) << 24) |
                        (static_cast<uint32_t>(ptr[k][1]) << 16) |
                        (static_cast<uint32_t>(ptr[k][2]) << 8) |
                        static_cast<uint32_t>(ptr[k][3]);
            spos[k] = 4;
        }
    }

    int64_t remaining[4] = {scount[0], scount[1], scount[2], scount[3]};
    int k = 0;
    for (int64_t i = 0; i < n; ++i) {
        while (remaining[k] == 0) k = (k + 1) & 3;
        uint32_t& x = states[k];
        uint32_t slot = x & (PROB_SCALE - 1);
        uint8_t s = cum2sym[slot];
        uint32_t f = freq[s];
        x = static_cast<uint32_t>(static_cast<uint64_t>(f) * (x >> PROB_BITS) +
                                  slot - cum[s]);
        while (x < RANS32_L && spos[k] < send[k]) {
            x = (x << 8) | ptr[k][spos[k]++];
        }
        out[i] = s;
        remaining[k]--;
        k = (k + 1) & 3;
    }
}

// N-way generalized interleaved encode for the TPU-native container path:
// symbol i is owned by lane i % n_lanes; each lane is an independent LIFO
// rANS stream.  Outputs per-lane stream lengths and the concatenated
// streams (framing generalizes src/rans.rs:431-454 to arbitrary N).
// `out` capacity >= 2*n + 8*n_lanes. Returns total payload length
// (streams only; lengths go to `lane_lens`).
int64_t alc_rans_encode_nway(const uint8_t* syms, int64_t n, int32_t n_lanes,
                             const uint16_t* freq, const uint16_t* cum,
                             uint8_t* out, uint32_t* lane_lens) {
    std::vector<std::vector<uint8_t>> streams(n_lanes);

    // Lanes are fully independent LIFO streams — parallel across cores.
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int32_t k = 0; k < n_lanes; ++k) {
        auto& stream = streams[k];
        // lane k owns symbols k, k+N, k+2N, ... processed in reverse
        int64_t count = (n - k + n_lanes - 1) / n_lanes;
        stream.reserve(static_cast<size_t>(count) * 3 / 2 + 8);
        uint32_t x = RANS32_L;
        for (int64_t j = count - 1; j >= 0; --j) {
            uint8_t s = syms[j * n_lanes + k];
            uint32_t f = freq[s];
            uint64_t x_max =
                ((static_cast<uint64_t>(RANS32_L >> PROB_BITS)) << 8) * f;
            while (static_cast<uint64_t>(x) >= x_max) {
                stream.push_back(static_cast<uint8_t>(x & 0xFF));
                x >>= 8;
            }
            uint32_t q = x / f;
            x = (q << PROB_BITS) + (x - q * f) + cum[s];
        }
        for (int b = 0; b < 4; ++b)
            stream.push_back(static_cast<uint8_t>((x >> (8 * b)) & 0xFF));
        std::reverse(stream.begin(), stream.end());
        lane_lens[k] = static_cast<uint32_t>(stream.size());
    }

    int64_t pos = 0;
    for (int32_t k = 0; k < n_lanes; ++k) {
        std::memcpy(out + pos, streams[k].data(), streams[k].size());
        pos += static_cast<int64_t>(streams[k].size());
    }
    return pos;
}

// N-way generalized interleaved decode (inverse of alc_rans_encode_nway).
void alc_rans_decode_nway(const uint8_t* data, int64_t n, int32_t n_lanes,
                          const uint32_t* lane_lens,
                          const uint16_t* freq, const uint16_t* cum,
                          const uint8_t* cum2sym, uint8_t* out) {
    std::vector<const uint8_t*> ptr(n_lanes);
    std::vector<int64_t> spos(n_lanes), send(n_lanes);
    std::vector<uint32_t> states(n_lanes, 0);
    int64_t off = 0;
    for (int32_t k = 0; k < n_lanes; ++k) {
        ptr[k] = data + off;
        send[k] = lane_lens[k];
        off += lane_lens[k];
        spos[k] = 0;
        if (send[k] >= 4) {
            states[k] = (static_cast<uint32_t>(ptr[k][0]) << 24) |
                        (static_cast<uint32_t>(ptr[k][1]) << 16) |
                        (static_cast<uint32_t>(ptr[k][2]) << 8) |
                        static_cast<uint32_t>(ptr[k][3]);
            spos[k] = 4;
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        int k = static_cast<int>(i % n_lanes);
        uint32_t& x = states[k];
        uint32_t slot = x & (PROB_SCALE - 1);
        uint8_t s = cum2sym[slot];
        uint32_t f = freq[s];
        x = static_cast<uint32_t>(static_cast<uint64_t>(f) * (x >> PROB_BITS) +
                                  slot - cum[s]);
        while (x < RANS32_L && spos[k] < send[k]) {
            x = (x << 8) | ptr[k][spos[k]++];
        }
        out[i] = s;
    }
}

int32_t alc_native_abi_version() { return 2; }

}  // extern "C"
