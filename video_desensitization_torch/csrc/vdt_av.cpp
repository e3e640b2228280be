// Native video I/O layer: decode / encode / packet demux over ffmpeg's
// libavformat + libavcodec + libswscale.
//
// The equivalent of the reference's native Cython modules
// (foreign/recordDeal.so + foreign/readPacket.so) and of its
// ffmpeg-subprocess frame extractor (combine_detect.py:279-476):
// in-process demux/decode to RGB24 or planar I420 with multithreaded
// codecs, HEVC (libx265) encode with the reference's repack settings
// (10 Mbps / preset medium), and packet-level demux exposing
// pts/dts/keyframe for record repair+repack.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (video_desensitization_torch/video/av.py), which builds this file with
// g++ at first use.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstring>
#include <string>

static thread_local std::string g_last_error;

static void set_error(const std::string &msg, int err = 0) {
    if (err != 0) {
        char buf[256];
        av_strerror(err, buf, sizeof(buf));
        g_last_error = msg + ": " + buf;
    } else {
        g_last_error = msg;
    }
}

extern "C" const char *vdt_last_error() { return g_last_error.c_str(); }

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct VdtDecoder {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *codec = nullptr;
    SwsContext *sws = nullptr;
    AVFrame *frame = nullptr;
    AVFrame *rgb = nullptr;
    AVPacket *pkt = nullptr;
    int stream_index = -1;
    int width = 0, height = 0;
    bool draining = false;
    bool pending = false;  // pkt holds an unsent packet (send returned EAGAIN)
    bool have_frame = false;  // frame decoded but not yet delivered (capacity retry)
};

extern "C" VdtDecoder *vdt_decoder_open(const char *path) {
    auto *d = new VdtDecoder();
    int err = avformat_open_input(&d->fmt, path, nullptr, nullptr);
    if (err < 0) {
        set_error(std::string("open_input failed for ") + path, err);
        delete d;
        return nullptr;
    }
    if ((err = avformat_find_stream_info(d->fmt, nullptr)) < 0) {
        set_error("find_stream_info failed", err);
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    const AVCodec *dec = nullptr;
    d->stream_index =
        av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (d->stream_index < 0 || !dec) {
        set_error("no video stream found");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->codec = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(d->codec,
                                  d->fmt->streams[d->stream_index]->codecpar);
    d->codec->thread_count = 0;  // auto: frame+slice threading
    d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if ((err = avcodec_open2(d->codec, dec, nullptr)) < 0) {
        set_error("avcodec_open2 failed", err);
        avcodec_free_context(&d->codec);
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->rgb = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

extern "C" int vdt_decoder_info(VdtDecoder *d, int *w, int *h, double *fps,
                                int64_t *nframes) {
    AVStream *st = d->fmt->streams[d->stream_index];
    *w = d->width ? d->width : d->codec->width;
    *h = d->height ? d->height : d->codec->height;
    AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    *fps = r.den ? (double)r.num / r.den : 0.0;
    *nframes = st->nb_frames;  // 0 if unknown (raw elementary streams)
    return 0;
}

// Pull the next decoded frame into d->frame (idempotent while d->have_frame
// is set). Returns 1 on frame, 0 at EOF, -1 on error.
static int decoder_acquire(VdtDecoder *d) {
    int err;
    if (!d->have_frame) {
        while (true) {
            err = avcodec_receive_frame(d->codec, d->frame);
            if (err == 0) break;
            if (err == AVERROR_EOF) return 0;
            if (err != AVERROR(EAGAIN)) {
                set_error("receive_frame failed", err);
                return -1;
            }
            if (d->draining) return 0;
            // Need more input: first retry a packet the codec refused earlier.
            if (d->pending) {
                err = avcodec_send_packet(d->codec, d->pkt);
                if (err == 0) {
                    d->pending = false;
                    av_packet_unref(d->pkt);
                } else if (err != AVERROR(EAGAIN)) {
                    av_packet_unref(d->pkt);
                    d->pending = false;
                    set_error("send_packet failed", err);
                    return -1;
                }
                // On EAGAIN fall through to receive again, pkt still pending.
                continue;
            }
            err = av_read_frame(d->fmt, d->pkt);
            if (err == AVERROR_EOF) {
                d->draining = true;
                avcodec_send_packet(d->codec, nullptr);
                continue;
            }
            if (err < 0) {
                set_error("read_frame failed", err);
                return -1;
            }
            if (d->pkt->stream_index == d->stream_index) {
                err = avcodec_send_packet(d->codec, d->pkt);
                if (err == AVERROR(EAGAIN)) {
                    d->pending = true;  // keep pkt; retry after draining
                    continue;
                }
                if (err < 0) {
                    av_packet_unref(d->pkt);
                    set_error("send_packet failed", err);
                    return -1;
                }
            }
            av_packet_unref(d->pkt);
        }
        d->have_frame = true;
    }
    return 1;
}

// Returns 1 when a frame was written to rgb_out (out_h*out_w*3, row-major),
// 0 at EOF, -3 when the decoded frame exceeds `capacity` bytes (the frame is
// retained; query the new dims via out_w/out_h or vdt_decoder_info, grow the
// buffer and call again), other <0 on error. `capacity` is the writable size
// of rgb_out in bytes — the decoder never writes past it (a stream larger
// than the caller's buffer must fail cleanly, not corrupt memory).
extern "C" int vdt_decoder_next(VdtDecoder *d, uint8_t *rgb_out,
                                int64_t capacity, int *out_w, int *out_h) {
    int rc = decoder_acquire(d);
    if (rc <= 0) return rc;

    int w = d->frame->width, h = d->frame->height;
    d->width = w;
    d->height = h;
    if (out_w) *out_w = w;
    if (out_h) *out_h = h;
    if ((int64_t)3 * w * h > capacity) {
        set_error("decoded frame " + std::to_string(w) + "x" +
                  std::to_string(h) + " exceeds buffer capacity " +
                  std::to_string(capacity) + " bytes");
        return -3;  // frame kept; caller may grow the buffer and retry
    }
    d->sws = sws_getCachedContext(d->sws, w, h, (AVPixelFormat)d->frame->format,
                                  w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                                  nullptr, nullptr);
    uint8_t *dst[4] = {rgb_out, nullptr, nullptr, nullptr};
    int dst_linesize[4] = {3 * w, 0, 0, 0};
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, h, dst,
              dst_linesize);
    av_frame_unref(d->frame);
    d->have_frame = false;
    return 1;
}

// Planar-I420 variant: writes w*h Y bytes then w*h/4 U then w*h/4 V into
// yuv_out ((h*3/2, w) row-major — the layout the fused engine's yuv420 IO
// mode ships to the chip). HEVC camera streams decode as yuv420p, so this
// is a plane copy instead of the RGB24 conversion — and the encoder
// consumes yuv420p too, removing both host sws colorspace passes. Same
// contract as vdt_decoder_next; additionally returns -4 for odd frame
// dimensions (no I420 form; caller falls back to the RGB path).
extern "C" int vdt_decoder_next_i420(VdtDecoder *d, uint8_t *yuv_out,
                                     int64_t capacity, int *out_w,
                                     int *out_h) {
    int rc = decoder_acquire(d);
    if (rc <= 0) return rc;

    int w = d->frame->width, h = d->frame->height;
    d->width = w;
    d->height = h;
    if (out_w) *out_w = w;
    if (out_h) *out_h = h;
    if ((w | h) & 1) {
        set_error("I420 needs even dims, got " + std::to_string(w) + "x" +
                  std::to_string(h));
        return -4;  // frame retained; caller may switch to vdt_decoder_next
    }
    // Only pass through sources that ARE limited-range 8-bit 4:2:0 —
    // anything else (yuvj420p full-range MJPEG, 4:2:2/4:4:4, 10-bit) would
    // go through a lossy sws squeeze here and then a video-range expansion
    // on device, shifting detector inputs relative to the RGB transport.
    // Those sources fall back to the RGB path, whose sws conversion handles
    // range/subsampling correctly.
    if (d->frame->format != AV_PIX_FMT_YUV420P) {
        const char *name = av_get_pix_fmt_name((AVPixelFormat)d->frame->format);
        set_error(std::string("I420 pass-through needs yuv420p source, got ") +
                  (name ? name : "?"));
        return -4;  // frame retained
    }
    if ((int64_t)3 * w * h / 2 > capacity) {
        set_error("decoded frame " + std::to_string(w) + "x" +
                  std::to_string(h) + " exceeds buffer capacity " +
                  std::to_string(capacity) + " bytes");
        return -3;
    }
    d->sws = sws_getCachedContext(d->sws, w, h, (AVPixelFormat)d->frame->format,
                                  w, h, AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                                  nullptr, nullptr, nullptr);
    uint8_t *dst[4] = {yuv_out, yuv_out + (int64_t)w * h,
                       yuv_out + (int64_t)w * h + (int64_t)(w / 2) * (h / 2),
                       nullptr};
    int dst_linesize[4] = {w, w / 2, w / 2, 0};
    sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, h, dst,
              dst_linesize);
    av_frame_unref(d->frame);
    d->have_frame = false;
    return 1;
}

extern "C" void vdt_decoder_close(VdtDecoder *d) {
    if (!d) return;
    if (d->sws) sws_freeContext(d->sws);
    av_frame_free(&d->frame);
    av_frame_free(&d->rgb);
    av_packet_free(&d->pkt);
    avcodec_free_context(&d->codec);
    avformat_close_input(&d->fmt);
    delete d;
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

struct VdtEncoder {
    AVFormatContext *fmt = nullptr;
    AVCodecContext *codec = nullptr;
    AVStream *stream = nullptr;
    SwsContext *sws = nullptr;
    AVFrame *frame = nullptr;
    AVPacket *pkt = nullptr;
    int64_t next_pts = 0;
    int width = 0, height = 0;
};

static int encoder_drain(VdtEncoder *e) {
    int err;
    while ((err = avcodec_receive_packet(e->codec, e->pkt)) == 0) {
        if (e->pkt->duration == 0)
            e->pkt->duration = 1;  // one frame in codec time_base (1/fps)
        av_packet_rescale_ts(e->pkt, e->codec->time_base, e->stream->time_base);
        e->pkt->stream_index = e->stream->index;
        err = av_interleaved_write_frame(e->fmt, e->pkt);
        if (err < 0) {
            set_error("write_frame failed", err);
            return -1;
        }
    }
    if (err == AVERROR(EAGAIN) || err == AVERROR_EOF) return 0;
    set_error("receive_packet failed", err);
    return -1;
}

extern "C" VdtEncoder *vdt_encoder_open(const char *path, int w, int h,
                                        double fps, const char *codec_name,
                                        int64_t bitrate, const char *preset,
                                        const char *x265_params) {
    auto *e = new VdtEncoder();
    e->width = w;
    e->height = h;
    int err = avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path);
    if (err < 0 || !e->fmt) {
        set_error(std::string("cannot deduce output format for ") + path, err);
        delete e;
        return nullptr;
    }
    const AVCodec *enc = avcodec_find_encoder_by_name(codec_name);
    if (!enc) {
        set_error(std::string("encoder not found: ") + codec_name);
        avformat_free_context(e->fmt);
        delete e;
        return nullptr;
    }
    e->stream = avformat_new_stream(e->fmt, enc);
    e->codec = avcodec_alloc_context3(enc);
    e->codec->width = w;
    e->codec->height = h;
    e->codec->thread_count = 0;  // auto (x264/x265 default to 1 otherwise)
    AVRational fr = av_d2q(fps, 100000);
    e->codec->time_base = av_inv_q(fr);
    e->codec->framerate = fr;
    if (strcmp(codec_name, "mjpeg") == 0) {
        // MJPEG is full-range JPEG-YUV.
        e->codec->pix_fmt = AV_PIX_FMT_YUVJ420P;
        e->codec->color_range = AVCOL_RANGE_JPEG;
        e->codec->strict_std_compliance = FF_COMPLIANCE_UNOFFICIAL;
    } else {
        e->codec->pix_fmt = AV_PIX_FMT_YUV420P;
    }
    if (bitrate > 0) e->codec->bit_rate = bitrate;
    if (preset && *preset)
        av_opt_set(e->codec->priv_data, "preset", preset, 0);
    // Raw x265 option string (colon-separated key=value, e.g.
    // "pools=4:frame-threads=2" to pin worker threads, "lossless=1").
    // x265 defaults to pools=all-cores; this knob lets many-core hosts
    // bound or widen the encode parallelism explicitly.
    if (x265_params && *x265_params && strcmp(codec_name, "libx265") == 0)
        av_opt_set(e->codec->priv_data, "x265-params", x265_params, 0);
    if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if ((err = avcodec_open2(e->codec, enc, nullptr)) < 0) {
        set_error("encoder open failed", err);
        avcodec_free_context(&e->codec);
        avformat_free_context(e->fmt);
        delete e;
        return nullptr;
    }
    avcodec_parameters_from_context(e->stream->codecpar, e->codec);
    e->stream->time_base = e->codec->time_base;
    if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
        if ((err = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE)) < 0) {
            set_error(std::string("cannot open output ") + path, err);
            avcodec_free_context(&e->codec);
            avformat_free_context(e->fmt);
            delete e;
            return nullptr;
        }
    }
    // Shift mux timestamps non-negative (B-frame dts delay would otherwise
    // produce an mp4 edit list that trims the final frame on decode).
    e->fmt->avoid_negative_ts = AVFMT_AVOID_NEG_TS_MAKE_ZERO;
    if ((err = avformat_write_header(e->fmt, nullptr)) < 0) {
        set_error("write_header failed", err);
        avcodec_free_context(&e->codec);
        avformat_free_context(e->fmt);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->frame->format = e->codec->pix_fmt;
    e->frame->width = w;
    e->frame->height = h;
    av_frame_get_buffer(e->frame, 0);
    e->pkt = av_packet_alloc();
    return e;
}

extern "C" int vdt_encoder_write(VdtEncoder *e, const uint8_t *rgb) {
    e->sws = sws_getCachedContext(e->sws, e->width, e->height, AV_PIX_FMT_RGB24,
                                  e->width, e->height, e->codec->pix_fmt,
                                  SWS_BILINEAR, nullptr, nullptr, nullptr);
    av_frame_make_writable(e->frame);
    const uint8_t *src[4] = {rgb, nullptr, nullptr, nullptr};
    int src_linesize[4] = {3 * e->width, 0, 0, 0};
    sws_scale(e->sws, src, src_linesize, 0, e->height, e->frame->data,
              e->frame->linesize);
    e->frame->pts = e->next_pts++;
    int err = avcodec_send_frame(e->codec, e->frame);
    if (err < 0) {
        set_error("send_frame failed", err);
        return -1;
    }
    return encoder_drain(e);
}

// Planar-I420 input variant ((h*3/2, w) row-major, the fused engine's
// yuv420 output): a plane copy into the yuv420p encoder frame (sws handles
// the mjpeg yuvj420p full-range expansion case). Requires even dims (true
// for any I420 buffer by construction).
extern "C" int vdt_encoder_write_i420(VdtEncoder *e, const uint8_t *yuv) {
    int w = e->width, h = e->height;
    e->sws = sws_getCachedContext(e->sws, w, h, AV_PIX_FMT_YUV420P, w, h,
                                  e->codec->pix_fmt, SWS_BILINEAR, nullptr,
                                  nullptr, nullptr);
    av_frame_make_writable(e->frame);
    const uint8_t *src[4] = {yuv, yuv + (int64_t)w * h,
                             yuv + (int64_t)w * h + (int64_t)(w / 2) * (h / 2),
                             nullptr};
    int src_linesize[4] = {w, w / 2, w / 2, 0};
    sws_scale(e->sws, src, src_linesize, 0, h, e->frame->data,
              e->frame->linesize);
    e->frame->pts = e->next_pts++;
    int err = avcodec_send_frame(e->codec, e->frame);
    if (err < 0) {
        set_error("send_frame failed", err);
        return -1;
    }
    return encoder_drain(e);
}

extern "C" int vdt_encoder_close(VdtEncoder *e) {
    if (!e) return 0;
    int rc = 0;
    if (e->codec) {
        avcodec_send_frame(e->codec, nullptr);
        if (encoder_drain(e) < 0) rc = -1;
        av_write_trailer(e->fmt);
    }
    if (e->sws) sws_freeContext(e->sws);
    av_frame_free(&e->frame);
    av_packet_free(&e->pkt);
    if (e->fmt && !(e->fmt->oformat->flags & AVFMT_NOFILE) && e->fmt->pb)
        avio_closep(&e->fmt->pb);
    avcodec_free_context(&e->codec);
    avformat_free_context(e->fmt);
    delete e;
    return rc;
}

// ---------------------------------------------------------------------------
// Packet demuxer (readPacket.ReadPacket equivalent)
// ---------------------------------------------------------------------------

struct VdtDemuxer {
    AVFormatContext *fmt = nullptr;
    AVPacket *pkt = nullptr;
    int stream_index = -1;
};

extern "C" VdtDemuxer *vdt_demux_open(const char *path) {
    auto *x = new VdtDemuxer();
    int err = avformat_open_input(&x->fmt, path, nullptr, nullptr);
    if (err < 0) {
        set_error(std::string("demux open failed for ") + path, err);
        delete x;
        return nullptr;
    }
    if ((err = avformat_find_stream_info(x->fmt, nullptr)) < 0) {
        set_error("demux stream_info failed", err);
        avformat_close_input(&x->fmt);
        delete x;
        return nullptr;
    }
    x->stream_index =
        av_find_best_stream(x->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (x->stream_index < 0) {
        set_error("no video stream");
        avformat_close_input(&x->fmt);
        delete x;
        return nullptr;
    }
    x->pkt = av_packet_alloc();
    return x;
}

extern "C" int vdt_demux_time_base(VdtDemuxer *x, int *num, int *den) {
    AVRational tb = x->fmt->streams[x->stream_index]->time_base;
    *num = tb.num;
    *den = tb.den;
    return 0;
}

// Returns 1 with packet fields set, 0 at EOF, <0 on error. The data pointer
// is valid until the next call.
extern "C" int vdt_demux_next(VdtDemuxer *x, uint8_t **data, int *size,
                              int64_t *pts, int64_t *dts, int64_t *duration,
                              int *key) {
    av_packet_unref(x->pkt);
    int err;
    while ((err = av_read_frame(x->fmt, x->pkt)) >= 0) {
        if (x->pkt->stream_index == x->stream_index) {
            *data = x->pkt->data;
            *size = x->pkt->size;
            *pts = x->pkt->pts;
            *dts = x->pkt->dts;
            *duration = x->pkt->duration;
            *key = (x->pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
            return 1;
        }
        av_packet_unref(x->pkt);
    }
    if (err == AVERROR_EOF) return 0;
    set_error("demux read failed", err);
    return -1;
}

extern "C" void vdt_demux_close(VdtDemuxer *x) {
    if (!x) return;
    av_packet_free(&x->pkt);
    avformat_close_input(&x->fmt);
    delete x;
}
