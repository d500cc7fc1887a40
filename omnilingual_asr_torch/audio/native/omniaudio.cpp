// omniaudio: in-process audio decode for the omnilingual ASR engines.
//
// The PyTorch port's own copy of omnilingual_asr_tpu/audio/native/
// omniaudio.cpp; keep the two in step (both must decode every file to the
// same samples).
//
// Replaces the reference's ffmpeg/ffprobe *subprocesses*
// (reference gemini_pipeline.py:222-310) with direct in-process decoding:
//  - WAV (RIFF PCM/float): own parser, zero dependencies;
//  - MP3/FLAC/OGG/M4A/AAC/AIFF: libavformat/libavcodec/libswresample,
//    compiled in when the system headers are present (OMNIAUDIO_WITH_LIBAV).
//
// C ABI (consumed by ctypes in ../native_lib.py):
//   int32_t omniaudio_decode(path, &out, &n, &sr)          // native rate
//   int32_t omniaudio_decode_rate(path, target_sr, ...)     // + resample
//   double  omniaudio_duration(path)                        // header probe
//   void    omniaudio_free(ptr)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if defined(OMNIAUDIO_WITH_LIBAV)
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}
#endif

namespace {

// ---------------------------------------------------------------------------
// Own RIFF/WAVE parser (PCM 8/16/24/32 + float32/64, mono-mixdown)
// ---------------------------------------------------------------------------

struct WavResult {
    std::vector<float> samples;
    int32_t sample_rate = 0;
    bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavResult decode_wav_buffer(const uint8_t* data, size_t n) {
    WavResult r;
    if (n < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
        return r;
    size_t pos = 12;
    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    while (pos + 8 <= n) {
        const uint8_t* ck = data + pos;
        uint32_t size = rd_u32(ck + 4);
        size_t body = pos + 8;
        if (memcmp(ck, "fmt ", 4) == 0 && body + 16 <= n) {
            fmt = rd_u16(data + body);
            channels = rd_u16(data + body + 2);
            rate = rd_u32(data + body + 4);
            bits = rd_u16(data + body + 14);
            if (fmt == 0xFFFE && size >= 40)  // WAVE_FORMAT_EXTENSIBLE
                fmt = rd_u16(data + body + 24);
        } else if (memcmp(ck, "data", 4) == 0) {
            if (!rate || !channels) return r;
            size_t avail = n - body;
            size_t len = size < avail ? size : avail;
            const uint8_t* p = data + body;
            size_t bytes_per = bits / 8;
            size_t frames = len / (bytes_per * channels);
            r.samples.resize(frames);
            for (size_t f = 0; f < frames; ++f) {
                double acc = 0.0;
                for (uint16_t c = 0; c < channels; ++c) {
                    const uint8_t* s = p + (f * channels + c) * bytes_per;
                    double v = 0.0;
                    if (fmt == 1) {  // PCM
                        if (bits == 16) {
                            v = (int16_t)rd_u16(s) / 32768.0;
                        } else if (bits == 8) {
                            v = ((int)s[0] - 128) / 128.0;
                        } else if (bits == 24) {
                            int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
                            if (x >= (1 << 23)) x -= (1 << 24);
                            v = x / 8388608.0;
                        } else if (bits == 32) {
                            v = (int32_t)rd_u32(s) / 2147483648.0;
                        } else return r;
                    } else if (fmt == 3) {  // IEEE float
                        if (bits == 32) {
                            float fv; memcpy(&fv, s, 4); v = fv;
                        } else if (bits == 64) {
                            double dv; memcpy(&dv, s, 8); v = dv;
                        } else return r;
                    } else return r;
                    acc += v;
                }
                r.samples[f] = (float)(acc / channels);
            }
            r.sample_rate = (int32_t)rate;
            r.ok = true;
            return r;
        }
        pos = body + size + (size & 1);
    }
    return r;
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (sz <= 0) { fclose(f); return false; }
    out.resize((size_t)sz);
    size_t got = fread(out.data(), 1, (size_t)sz, f);
    fclose(f);
    return got == (size_t)sz;
}

bool has_ext(const char* path, const char* ext) {
    const char* dot = strrchr(path, '.');
    if (!dot) return false;
    return strcasecmp(dot, ext) == 0;
}

#if defined(OMNIAUDIO_WITH_LIBAV)

// ---------------------------------------------------------------------------
// libav decode: any container/codec -> mono float32 at target rate
// ---------------------------------------------------------------------------

struct AvResult {
    std::vector<float> samples;
    int32_t sample_rate = 0;
    bool ok = false;
};

struct AvLogSilencer {
    AvLogSilencer() { av_log_set_level(AV_LOG_ERROR); }
};
static AvLogSilencer g_av_log_silencer;

AvResult decode_libav(const char* path, int32_t target_sr) {
    AvResult r;
    AVFormatContext* fmt = nullptr;
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return r;
    if (avformat_find_stream_info(fmt, nullptr) < 0) {
        avformat_close_input(&fmt);
        return r;
    }
    const AVCodec* codec = nullptr;
    int sidx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (sidx < 0 || !codec) { avformat_close_input(&fmt); return r; }
    AVCodecContext* ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(ctx, fmt->streams[sidx]->codecpar);
    if (avcodec_open2(ctx, codec, nullptr) < 0) {
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return r;
    }

    int32_t out_rate = target_sr > 0 ? target_sr : ctx->sample_rate;
    SwrContext* swr = nullptr;
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    AVChannelLayout in_layout;
    if (ctx->ch_layout.nb_channels > 0)
        av_channel_layout_copy(&in_layout, &ctx->ch_layout);
    else
        av_channel_layout_default(&in_layout, 1);
    if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, out_rate,
                            &in_layout, ctx->sample_fmt, ctx->sample_rate,
                            0, nullptr) < 0 || swr_init(swr) < 0) {
        if (swr) swr_free(&swr);
        avcodec_free_context(&ctx);
        avformat_close_input(&fmt);
        return r;
    }

    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    std::vector<float> buf;
    std::vector<float> tmp;

    auto drain_frame = [&](AVFrame* fr) {
        int max_out = (int)av_rescale_rnd(
            swr_get_delay(swr, ctx->sample_rate) + (fr ? fr->nb_samples : 0),
            out_rate, ctx->sample_rate, AV_ROUND_UP) + 64;
        tmp.resize((size_t)max_out);
        uint8_t* outp = (uint8_t*)tmp.data();
        int got = swr_convert(swr, &outp, max_out,
                              fr ? (const uint8_t**)fr->extended_data : nullptr,
                              fr ? fr->nb_samples : 0);
        if (got > 0) buf.insert(buf.end(), tmp.begin(), tmp.begin() + got);
    };

    while (av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index == sidx) {
            if (avcodec_send_packet(ctx, pkt) >= 0) {
                while (avcodec_receive_frame(ctx, frame) >= 0) drain_frame(frame);
            }
        }
        av_packet_unref(pkt);
    }
    avcodec_send_packet(ctx, nullptr);  // flush decoder
    while (avcodec_receive_frame(ctx, frame) >= 0) drain_frame(frame);
    drain_frame(nullptr);               // flush resampler

    av_frame_free(&frame);
    av_packet_free(&pkt);
    swr_free(&swr);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);

    if (buf.empty()) return r;
    r.samples = std::move(buf);
    r.sample_rate = out_rate;
    r.ok = true;
    return r;
}

double duration_libav(const char* path) {
    AVFormatContext* fmt = nullptr;
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return 0.0;
    if (avformat_find_stream_info(fmt, nullptr) < 0) {
        avformat_close_input(&fmt);
        return 0.0;
    }
    double dur = 0.0;
    if (fmt->duration > 0)
        dur = (double)fmt->duration / AV_TIME_BASE;
    avformat_close_input(&fmt);
    return dur;
}

#endif  // OMNIAUDIO_WITH_LIBAV

int32_t finish(std::vector<float>&& samples, int32_t rate, float** out,
               int64_t* n, int32_t* sr) {
    float* mem = (float*)malloc(samples.size() * sizeof(float));
    if (!mem) return -2;
    memcpy(mem, samples.data(), samples.size() * sizeof(float));
    *out = mem;
    *n = (int64_t)samples.size();
    *sr = rate;
    return 0;
}

}  // namespace

extern "C" {

int32_t omniaudio_decode_rate(const char* path, int32_t target_sr,
                              float** out, int64_t* n, int32_t* sr) {
    *out = nullptr; *n = 0; *sr = 0;
    // WAV at native rate: own parser is fastest (no libav overhead).
    if (has_ext(path, ".wav") && target_sr <= 0) {
        std::vector<uint8_t> data;
        if (read_file(path, data)) {
            WavResult w = decode_wav_buffer(data.data(), data.size());
            if (w.ok) return finish(std::move(w.samples), w.sample_rate, out, n, sr);
        }
    }
#if defined(OMNIAUDIO_WITH_LIBAV)
    AvResult a = decode_libav(path, target_sr);
    if (a.ok) return finish(std::move(a.samples), a.sample_rate, out, n, sr);
#else
    if (has_ext(path, ".wav")) {
        std::vector<uint8_t> data;
        if (read_file(path, data)) {
            WavResult w = decode_wav_buffer(data.data(), data.size());
            if (w.ok) return finish(std::move(w.samples), w.sample_rate, out, n, sr);
        }
    }
#endif
    return -1;
}

int32_t omniaudio_decode(const char* path, float** out, int64_t* n,
                         int32_t* sr) {
    return omniaudio_decode_rate(path, 0, out, n, sr);
}

void omniaudio_free(float* p) { free(p); }

double omniaudio_duration(const char* path) {
    if (has_ext(path, ".wav")) {
        // Header-only probe.
        FILE* f = fopen(path, "rb");
        if (f) {
            uint8_t hdr[12];
            if (fread(hdr, 1, 12, f) == 12 && memcmp(hdr, "RIFF", 4) == 0 &&
                memcmp(hdr + 8, "WAVE", 4) == 0) {
                uint16_t channels = 0, bits = 0;
                uint32_t rate = 0, data_size = 0;
                uint8_t ck[8];
                while (fread(ck, 1, 8, f) == 8) {
                    uint32_t size = rd_u32(ck + 4);
                    if (memcmp(ck, "fmt ", 4) == 0 && size >= 16) {
                        uint8_t body[16];
                        if (fread(body, 1, 16, f) != 16) break;
                        channels = rd_u16(body + 2);
                        rate = rd_u32(body + 4);
                        bits = rd_u16(body + 14);
                        fseek(f, (long)(size - 16 + (size & 1)), SEEK_CUR);
                    } else if (memcmp(ck, "data", 4) == 0) {
                        data_size = size;
                        break;
                    } else {
                        fseek(f, (long)(size + (size & 1)), SEEK_CUR);
                    }
                }
                fclose(f);
                if (rate && channels && bits)
                    return (double)data_size / (channels * (bits / 8)) / rate;
                return 0.0;
            }
            fclose(f);
        }
    }
#if defined(OMNIAUDIO_WITH_LIBAV)
    return duration_libav(path);
#else
    return 0.0;
#endif
}

}  // extern "C"
