// Native audio ingest of the PyTorch port (utils/native_audio.py binds it
// with ctypes).
//
// Replaces the reference's host-side decode/resample stack (pydub/ffmpeg
// decode, scipy polyphase resampling) with a compiled loader exposed over a
// C ABI:
//
//   - RIFF/WAVE parsing: PCM 8/16/24/32-bit and float32, any channel
//     count, mono mixdown;
//   - windowed-sinc resampling (Hann-tapered, 32-tap half-width) for
//     ingest to the model rates (16 kHz aligners, 44.1 kHz pipeline);
//   - batch corpus loading straight into a caller-allocated padded
//     [S, T] float32 or int16 buffer + lengths (no copy on the Python side,
//     ready for the upload to the card);
//   - RMS window scan (the silence detector's inner loop) over a
//     millisecond grid.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared audioio.cpp -o <library>
// (utils/native_audio.py builds it at first use).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Wav {
    std::vector<float> samples;  // mono
    int rate = 0;
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(n));
    size_t got = std::fread(out.data(), 1, static_cast<size_t>(n), f);
    std::fclose(f);
    return got == static_cast<size_t>(n);
}

uint32_t rd32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }
uint16_t rd16(const uint8_t* p) { return static_cast<uint16_t>(p[0] | p[1] << 8); }

bool parse_wav(const std::vector<uint8_t>& raw, Wav& wav) {
    if (raw.size() < 44 || std::memcmp(raw.data(), "RIFF", 4) || std::memcmp(raw.data() + 8, "WAVE", 4))
        return false;
    size_t pos = 12;
    uint16_t tag = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    const uint8_t* data = nullptr;
    size_t data_len = 0;
    while (pos + 8 <= raw.size()) {
        const uint8_t* cid = raw.data() + pos;
        uint32_t size = rd32(raw.data() + pos + 4);
        const uint8_t* body = raw.data() + pos + 8;
        if (pos + 8 + size > raw.size()) size = static_cast<uint32_t>(raw.size() - pos - 8);
        if (!std::memcmp(cid, "fmt ", 4) && size >= 16) {
            tag = rd16(body);
            channels = rd16(body + 2);
            rate = rd32(body + 4);
            bits = rd16(body + 14);
            if (tag == 0xFFFE && size >= 26) tag = rd16(body + 24);
        } else if (!std::memcmp(cid, "data", 4)) {
            data = body;
            data_len = size;
        }
        pos += 8 + size + (size & 1);
    }
    if (!data || !channels || !rate) return false;
    wav.rate = static_cast<int>(rate);

    auto push_frame = [&](double acc) { wav.samples.push_back(static_cast<float>(acc / channels)); };

    if (tag == 3 && bits == 32) {  // float32
        size_t n = data_len / 4;
        const float* f = reinterpret_cast<const float*>(data);
        wav.samples.reserve(n / channels);
        for (size_t i = 0; i + channels <= n; i += channels) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += f[i + c];
            push_frame(acc);
        }
        return true;
    }
    if (tag != 1) return false;  // PCM only otherwise
    if (bits == 16) {
        size_t n = data_len / 2;
        const int16_t* s = reinterpret_cast<const int16_t*>(data);
        wav.samples.reserve(n / channels);
        for (size_t i = 0; i + channels <= n; i += channels) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += s[i + c] / 32768.0;
            push_frame(acc);
        }
    } else if (bits == 8) {
        size_t n = data_len;
        wav.samples.reserve(n / channels);
        for (size_t i = 0; i + channels <= n; i += channels) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += (data[i + c] - 128) / 128.0;
            push_frame(acc);
        }
    } else if (bits == 24) {
        size_t n = data_len / 3;
        wav.samples.reserve(n / channels);
        for (size_t i = 0; i + channels <= n; i += channels) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) {
                const uint8_t* b = data + 3 * (i + c);
                int32_t v = b[0] | b[1] << 8 | b[2] << 16;
                if (v >= (1 << 23)) v -= (1 << 24);
                acc += v / 8388608.0;
            }
            push_frame(acc);
        }
    } else if (bits == 32) {
        size_t n = data_len / 4;
        const int32_t* s = reinterpret_cast<const int32_t*>(data);
        wav.samples.reserve(n / channels);
        for (size_t i = 0; i + channels <= n; i += channels) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += s[i + c] / 2147483648.0;
            push_frame(acc);
        }
    } else {
        return false;
    }
    return true;
}

// Hann-windowed sinc resampler (half-width 32 source taps).
void resample_sinc(const std::vector<float>& in, int in_rate, int out_rate, std::vector<float>& out) {
    if (in_rate == out_rate || in.empty()) {
        out = in;
        return;
    }
    const double ratio = static_cast<double>(out_rate) / in_rate;
    const double cutoff = ratio < 1.0 ? ratio : 1.0;  // anti-alias when downsampling
    const int half = 32;
    const size_t n_out = static_cast<size_t>(in.size() * ratio);
    out.assign(n_out, 0.0f);
    for (size_t j = 0; j < n_out; ++j) {
        const double center = j / ratio;
        const long i0 = static_cast<long>(center) - half + 1;
        const long i1 = static_cast<long>(center) + half;
        double acc = 0, wsum = 0;
        for (long i = i0; i <= i1; ++i) {
            const double u = (center - i) * cutoff;
            const double t = (center - i) / (half + 1.0);
            double w = 0.5 * (1.0 + std::cos(M_PI * t));
            double s = (std::fabs(u) < 1e-9) ? 1.0 : std::sin(M_PI * u) / (M_PI * u);
            const double k = s * w * cutoff;
            const float x = (i >= 0 && i < static_cast<long>(in.size())) ? in[i] : 0.0f;
            acc += k * x;
            wsum += k;
        }
        out[j] = static_cast<float>(acc);
        (void)wsum;
    }
}

}  // namespace

extern "C" {

// Decode one wav to mono float32. Returns sample count written (≤ max_out),
// -1 on failure. rate_out receives the file's sample rate.
long audioio_decode(const char* path, float* out, long max_out, int* rate_out) {
    std::vector<uint8_t> raw;
    Wav wav;
    if (!read_file(path, raw) || !parse_wav(raw, wav)) return -1;
    *rate_out = wav.rate;
    long n = static_cast<long>(wav.samples.size());
    if (n > max_out) n = max_out;
    std::memcpy(out, wav.samples.data(), n * sizeof(float));
    return n;
}

// Decode + resample to target_rate. Returns output sample count or -1.
long audioio_decode_resampled(const char* path, int target_rate, float* out, long max_out) {
    std::vector<uint8_t> raw;
    Wav wav;
    if (!read_file(path, raw) || !parse_wav(raw, wav)) return -1;
    std::vector<float> res;
    resample_sinc(wav.samples, wav.rate, target_rate, res);
    long n = static_cast<long>(res.size());
    if (n > max_out) n = max_out;
    std::memcpy(out, res.data(), n * sizeof(float));
    return n;
}

// Batch loader: decode n_files paths (NUL-separated blob) into the padded
// [n_files, stride] buffer; lengths[i] receives each true sample count
// (-1 on per-file failure). target_rate 0 = keep native rate (first
// file's rate is returned). Returns the common/native rate or -1.
long audioio_load_batch(
    const char* paths_blob, long n_files, int target_rate, float* out, long stride, long* lengths) {
    const char* p = paths_blob;
    int rate = target_rate;
    for (long i = 0; i < n_files; ++i) {
        std::vector<uint8_t> raw;
        Wav wav;
        float* dst = out + i * stride;
        if (!read_file(p, raw) || !parse_wav(raw, wav)) {
            lengths[i] = -1;
        } else {
            std::vector<float> final_samples;
            if (target_rate > 0 && wav.rate != target_rate) {
                resample_sinc(wav.samples, wav.rate, target_rate, final_samples);
            } else {
                final_samples = std::move(wav.samples);
                if (rate <= 0) rate = wav.rate;
            }
            long n = static_cast<long>(final_samples.size());
            if (n > stride) n = stride;
            std::memcpy(dst, final_samples.data(), n * sizeof(float));
            if (n < stride) std::memset(dst + n, 0, (stride - n) * sizeof(float));
            lengths[i] = n;
        }
        p += std::strlen(p) + 1;
    }
    return rate > 0 ? rate : -1;
}

// Lossless int16 batch loader: succeeds ONLY when every file is mono 16-bit
// PCM at target_rate (or at one common rate when target_rate<=0), in which
// case each data chunk is memcpy'd straight into its padded row — no float
// conversion on either side (the device casts back, so results match the
// float path bit-for-bit while host work and transfer both halve). Returns
// the rate, or -2 when the corpus is not losslessly representable (caller
// falls back to audioio_load_batch). Missing/corrupt files get length -1
// and a zero row, mirroring the float loader's per-file contract.
long audioio_load_batch_i16(
    const char* paths_blob, long n_files, int target_rate, int16_t* out, long stride,
    long* lengths) {
    const char* p = paths_blob;
    int rate = target_rate;
    for (long i = 0; i < n_files; ++i, p += std::strlen(p) + 1) {
        std::vector<uint8_t> raw;
        int16_t* dst = out + i * stride;
        if (!read_file(p, raw)) {
            std::memset(dst, 0, stride * sizeof(int16_t));
            lengths[i] = -1;
            continue;
        }
        // header-only probe (same chunk walk as parse_wav, no decode)
        if (raw.size() < 44 || std::memcmp(raw.data(), "RIFF", 4) ||
            std::memcmp(raw.data() + 8, "WAVE", 4)) {
            std::memset(dst, 0, stride * sizeof(int16_t));
            lengths[i] = -1;  // unparseable: per-file failure, like the float path
            continue;
        }
        size_t pos = 12;
        uint16_t tag = 0, channels = 0, bits = 0;
        uint32_t file_rate = 0;
        const uint8_t* data = nullptr;
        size_t data_len = 0;
        while (pos + 8 <= raw.size()) {
            const uint8_t* cid = raw.data() + pos;
            uint32_t size = rd32(raw.data() + pos + 4);
            const uint8_t* body = raw.data() + pos + 8;
            if (pos + 8 + size > raw.size()) size = static_cast<uint32_t>(raw.size() - pos - 8);
            if (!std::memcmp(cid, "fmt ", 4) && size >= 16) {
                tag = rd16(body);
                channels = rd16(body + 2);
                file_rate = rd32(body + 4);
                bits = rd16(body + 14);
                if (tag == 0xFFFE && size >= 26) tag = rd16(body + 24);
            } else if (!std::memcmp(cid, "data", 4)) {
                data = body;
                data_len = size;
            }
            pos += 8 + size + (size & 1);
        }
        if (!data || !file_rate) {
            std::memset(dst, 0, stride * sizeof(int16_t));
            lengths[i] = -1;
            continue;
        }
        if (tag != 1 || bits != 16 || channels != 1) return -2;  // needs float path
        if (rate <= 0) rate = static_cast<int>(file_rate);
        if (static_cast<int>(file_rate) != rate) return -2;  // would resample
        long n = static_cast<long>(data_len / 2);
        if (n > stride) n = stride;
        std::memcpy(dst, data, n * sizeof(int16_t));
        if (n < stride) std::memset(dst + n, 0, (stride - n) * sizeof(int16_t));
        lengths[i] = n;
    }
    return rate > 0 ? rate : -1;
}

// One-pass float32 → PCM16 WAV writer. Quantization matches the Python
// fallback (utils/wavio.write_wav) bit-for-bit: round(x*32768) half-to-even
// (lrintf under the default FE_TONEAREST mode == np.round), then clamp to
// [-32768, 32767]; NaN maps to 0. The Python path makes ~5 full numpy
// passes plus two whole-buffer byte copies — on a 1-vCPU host that is the
// merge step's dominant cost; here it is one streaming pass. channels > 1
// expects interleaved frames (numpy [N, C] row-major), like the fallback.
// Returns 0 on success, -1 on I/O failure.
long audioio_write_wav_f32(const char* path, const float* x, long n, int rate, int channels) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    if (channels < 1) channels = 1;
    const uint32_t data_len = static_cast<uint32_t>(n) * 2u;
    uint8_t hdr[44];
    auto w32 = [](uint8_t* p, uint32_t v) {
        p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
    };
    auto w16 = [](uint8_t* p, uint16_t v) { p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; };
    std::memcpy(hdr, "RIFF", 4);
    w32(hdr + 4, 36 + data_len);
    std::memcpy(hdr + 8, "WAVEfmt ", 8);
    w32(hdr + 16, 16);
    w16(hdr + 20, 1);  // PCM
    w16(hdr + 22, static_cast<uint16_t>(channels));
    w32(hdr + 24, static_cast<uint32_t>(rate));
    w32(hdr + 28, static_cast<uint32_t>(rate) * channels * 2u);
    w16(hdr + 32, static_cast<uint16_t>(channels * 2));
    w16(hdr + 34, 16);
    std::memcpy(hdr + 36, "data", 4);
    w32(hdr + 40, data_len);
    if (std::fwrite(hdr, 1, 44, f) != 44) { std::fclose(f); return -1; }
    std::vector<int16_t> buf(1 << 16);
    for (long o = 0; o < n;) {
        long m = static_cast<long>(buf.size());
        if (o + m > n) m = n - o;
        for (long i = 0; i < m; ++i) {
            const float y = x[o + i] * 32768.0f;
            int16_t v;
            if (!(y == y)) v = 0;                    // NaN
            else if (y >= 32767.0f) v = 32767;       // +clip (covers +inf)
            else if (y <= -32768.0f) v = -32768;     // -clip (covers -inf)
            else v = static_cast<int16_t>(std::lrintf(y));  // half-to-even
            buf[i] = v;
        }
        if (std::fwrite(buf.data(), 2, m, f) != static_cast<size_t>(m)) { std::fclose(f); return -1; }
        o += m;
    }
    if (std::fclose(f) != 0) return -1;
    return 0;
}

// RMS over windows of window_ms starting at every millisecond.
// Writes floor(sqrt(mean(int16_scaled^2))) like pydub/audioop. Returns the
// number of windows.
long audioio_window_rms(
    const float* x, long n, int rate, int window_ms, float* out, long max_out) {
    const double per_ms = rate / 1000.0;
    const long total_ms = static_cast<long>(n * 1000L / rate);
    long n_starts = total_ms - window_ms + 1;
    if (n_starts < 0) n_starts = 0;
    if (n_starts > max_out) n_starts = max_out;
    // prefix sums of squares
    std::vector<double> csq(n + 1, 0.0);
    for (long i = 0; i < n; ++i) csq[i + 1] = csq[i] + static_cast<double>(x[i]) * x[i];
    for (long s = 0; s < n_starts; ++s) {
        long lo = static_cast<long>(s * per_ms);
        long hi = static_cast<long>((s + window_ms) * per_ms);
        if (hi > n) hi = n;
        long cnt = hi - lo;
        double mean_sq = cnt > 0 ? (csq[hi] - csq[lo]) / cnt : 0.0;
        out[s] = std::floor(std::sqrt(mean_sq) * 32768.0);
    }
    return n_starts;
}

}  // extern "C"
