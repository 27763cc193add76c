/* Minimal libavcodec shim for tpudab host-side audio codecs.
 *
 * Framework note: codec math is scalar/branchy and stays on the
 * host CPU (SURVEY.md sec 2.6 'faad2 / mpg123' disposition); this shim is the
 * native-code equivalent of the reference's faad2/mpg123 usage, built against
 * the system FFmpeg (libavcodec 59) and driven from Python via ctypes.
 *
 * API (all exported, C ABI):
 *   dab_decoder_open(codec_name, extradata, extradata_len) -> handle | NULL
 *   dab_decoder_decode(h, data, len, out_s16, max_samples,
 *                      &sample_rate, &channels) -> n_interleaved_samples | <0
 *   dab_decoder_close(h)
 *   dab_encoder_open(codec_name, sample_rate, channels, bit_rate)
 *   dab_encoder_frame_size(h) -> samples per channel per frame
 *   dab_encoder_encode(h, pcm_s16, n_samples_per_chan, out, out_cap) -> bytes
 *   dab_encoder_close(h)
 */

#include <libavcodec/avcodec.h>
#include <libavutil/opt.h>
#include <libavutil/channel_layout.h>
#include <string.h>

typedef struct {
    const AVCodec *codec;
    AVCodecContext *ctx;
    AVPacket *pkt;
    AVFrame *frame;
} dab_codec_t;

static dab_codec_t *alloc_handle(const char *name, int encoder) {
    dab_codec_t *h = calloc(1, sizeof(dab_codec_t));
    if (!h) return NULL;
    h->codec = encoder ? avcodec_find_encoder_by_name(name)
                       : avcodec_find_decoder_by_name(name);
    if (!h->codec) { free(h); return NULL; }
    h->ctx = avcodec_alloc_context3(h->codec);
    h->pkt = av_packet_alloc();
    h->frame = av_frame_alloc();
    if (!h->ctx || !h->pkt || !h->frame) { free(h); return NULL; }
    return h;
}

void dab_decoder_close(dab_codec_t *h);

dab_codec_t *dab_decoder_open(const char *codec_name,
                              const unsigned char *extradata, int extradata_len) {
    dab_codec_t *h = alloc_handle(codec_name, 0);
    if (!h) return NULL;
    if (extradata_len > 0) {
        h->ctx->extradata = av_mallocz(extradata_len + AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(h->ctx->extradata, extradata, extradata_len);
        h->ctx->extradata_size = extradata_len;
    }
    h->ctx->request_sample_fmt = AV_SAMPLE_FMT_S16;
    if (avcodec_open2(h->ctx, h->codec, NULL) < 0) {
        dab_decoder_close(h);
        return NULL;
    }
    return h;
}

static int16_t clip16(float v) {
    if (v > 32767.f) return 32767;
    if (v < -32768.f) return -32768;
    return (int16_t)v;
}

/* Returns total interleaved s16 samples written (frames * channels), or
 * negative AVERROR. Drains all frames produced by this packet. */
int dab_decoder_decode(dab_codec_t *h, const unsigned char *data, int len,
                       int16_t *out, int max_samples,
                       int *sample_rate, int *channels) {
    int ret = 0, written = 0;
    av_packet_unref(h->pkt);
    if (len > 0) {
        uint8_t *buf = av_mallocz(len + AV_INPUT_BUFFER_PADDING_SIZE);
        memcpy(buf, data, len);
        av_packet_from_data(h->pkt, buf, len);
        ret = avcodec_send_packet(h->ctx, h->pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
    } else {
        avcodec_send_packet(h->ctx, NULL); /* flush */
    }
    for (;;) {
        ret = avcodec_receive_frame(h->ctx, h->frame);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
        if (ret < 0) return ret;
        int ch = h->frame->ch_layout.nb_channels;
        int ns = h->frame->nb_samples;
        *sample_rate = h->frame->sample_rate;
        *channels = ch;
        if (written + ns * ch > max_samples) { av_frame_unref(h->frame); break; }
        enum AVSampleFormat fmt = h->frame->format;
        for (int i = 0; i < ns; i++) {
            for (int c = 0; c < ch; c++) {
                int16_t v = 0;
                if (fmt == AV_SAMPLE_FMT_S16) {
                    v = ((int16_t *)h->frame->data[0])[i * ch + c];
                } else if (fmt == AV_SAMPLE_FMT_S16P) {
                    v = ((int16_t *)h->frame->data[c])[i];
                } else if (fmt == AV_SAMPLE_FMT_FLTP) {
                    v = clip16(((float *)h->frame->data[c])[i] * 32768.f);
                } else if (fmt == AV_SAMPLE_FMT_FLT) {
                    v = clip16(((float *)h->frame->data[0])[i * ch + c] * 32768.f);
                }
                out[written++] = v;
            }
        }
        av_frame_unref(h->frame);
    }
    return written;
}

void dab_decoder_close(dab_codec_t *h) {
    if (!h) return;
    if (h->ctx) avcodec_free_context(&h->ctx);
    if (h->pkt) av_packet_free(&h->pkt);
    if (h->frame) av_frame_free(&h->frame);
    free(h);
}

/* ---------------- encoder (synthesizer fixtures) ---------------- */

dab_codec_t *dab_encoder_open(const char *codec_name, int sample_rate,
                              int channels, int bit_rate) {
    dab_codec_t *h = alloc_handle(codec_name, 1);
    if (!h) return NULL;
    h->ctx->sample_rate = sample_rate;
    av_channel_layout_default(&h->ctx->ch_layout, channels);
    h->ctx->bit_rate = bit_rate;
    h->ctx->sample_fmt = AV_SAMPLE_FMT_S16;
    if (h->codec->sample_fmts) {
        int has_s16 = 0;
        for (const enum AVSampleFormat *f = h->codec->sample_fmts;
             *f != AV_SAMPLE_FMT_NONE; f++)
            if (*f == AV_SAMPLE_FMT_S16) has_s16 = 1;
        if (!has_s16) h->ctx->sample_fmt = h->codec->sample_fmts[0];
    }
    if (avcodec_open2(h->ctx, h->codec, NULL) < 0) {
        dab_decoder_close(h);
        return NULL;
    }
    return h;
}

int dab_encoder_frame_size(dab_codec_t *h) { return h->ctx->frame_size; }

/* pcm: interleaved s16, n = samples per channel (must equal frame_size).
 * Returns bytes written to out (possibly several packets), or negative. */
int dab_encoder_encode(dab_codec_t *h, const int16_t *pcm, int n,
                       unsigned char *out, int out_cap) {
    int ret, written = 0;
    AVFrame *f = NULL;
    if (pcm != NULL) {
        f = h->frame;
        f->nb_samples = n;
        f->format = h->ctx->sample_fmt;
        av_channel_layout_copy(&f->ch_layout, &h->ctx->ch_layout);
        f->sample_rate = h->ctx->sample_rate;
        if (av_frame_get_buffer(f, 0) < 0) return -1;
        int ch = h->ctx->ch_layout.nb_channels;
        if (h->ctx->sample_fmt == AV_SAMPLE_FMT_S16) {
            memcpy(f->data[0], pcm, (size_t)n * ch * 2);
        } else if (h->ctx->sample_fmt == AV_SAMPLE_FMT_S16P) {
            for (int c = 0; c < ch; c++)
                for (int i = 0; i < n; i++)
                    ((int16_t *)f->data[c])[i] = pcm[i * ch + c];
        } else if (h->ctx->sample_fmt == AV_SAMPLE_FMT_FLTP) {
            for (int c = 0; c < ch; c++)
                for (int i = 0; i < n; i++)
                    ((float *)f->data[c])[i] = pcm[i * ch + c] / 32768.f;
        } else {
            return -2;
        }
    }
    ret = avcodec_send_frame(h->ctx, f);
    if (f) av_frame_unref(f);
    if (ret < 0) return ret;
    for (;;) {
        ret = avcodec_receive_packet(h->ctx, h->pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) break;
        if (ret < 0) return ret;
        if (written + h->pkt->size <= out_cap) {
            memcpy(out + written, h->pkt->data, h->pkt->size);
            written += h->pkt->size;
        }
        av_packet_unref(h->pkt);
    }
    return written;
}

void dab_encoder_close(dab_codec_t *h) { dab_decoder_close(h); }
