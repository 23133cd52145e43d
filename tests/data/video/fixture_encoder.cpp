// Test-fixture encoder: RGB24 frames -> one video stream in a container,
// through libavcodec (libx264, libx265, mpeg4, ...) and libavformat.
//
// Built with g++ at first use by tests/data/video/make_fixtures.py (through
// geotrax_tpu_torch/io/native.build) and driven with ctypes:
//
//   void* fx_open(const char* path, const char* codec, int w, int h,
//                 int fps_num, int fps_den, const char* pix_fmt, int full_range,
//                 const char** codec_keys, const char** codec_vals, int n_codec,
//                 const char** mux_keys, const char** mux_vals, int n_mux)
//   int   fx_write(void*, const uint8_t* rgb)   // 0 ok, <0 error
//   int   fx_close(void*)                        // flushes, writes the trailer
//
// Frame i gets pts i in a time base of fps_den/fps_num. swscale turns RGB24
// into ``pix_fmt`` (BT.601, limited range unless ``full_range``, which also
// marks the stream as full range). ``codec_*`` are the encoder's options
// (profile, preset, x264-params, ...), ``mux_*`` the muxer's (movflags).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/dict.h>
#include <libavutil/imgutils.h>
#include <libavutil/log.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>

namespace {

struct Enc {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  AVStream* st = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int64_t next_pts = 0;
  bool header = false;
};

void destroy(Enc* e) {
  if (!e) return;
  if (e->sws) sws_freeContext(e->sws);
  if (e->frame) av_frame_free(&e->frame);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->ctx) avcodec_free_context(&e->ctx);
  if (e->fmt) {
    if (e->fmt->pb) avio_closep(&e->fmt->pb);
    avformat_free_context(e->fmt);
  }
  delete e;
}

int drain(Enc* e) {
  while (true) {
    int rc = avcodec_receive_packet(e->ctx, e->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    av_packet_rescale_ts(e->pkt, e->ctx->time_base, e->st->time_base);
    e->pkt->stream_index = e->st->index;
    rc = av_interleaved_write_frame(e->fmt, e->pkt);
    if (rc < 0) return rc;
  }
}

AVDictionary* dict(const char** keys, const char** vals, int n) {
  AVDictionary* d = nullptr;
  for (int i = 0; i < n; ++i) av_dict_set(&d, keys[i], vals[i], 0);
  return d;
}

}  // namespace

extern "C" {

void* fx_open(const char* path, const char* codec_name, int w, int h, int fps_num, int fps_den,
              const char* pix_fmt, int full_range, const char** codec_keys,
              const char** codec_vals, int n_codec, const char** mux_keys,
              const char** mux_vals, int n_mux) {
  av_log_set_level(AV_LOG_ERROR);
  const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
  AVPixelFormat pf = av_get_pix_fmt(pix_fmt);
  if (!codec || pf == AV_PIX_FMT_NONE) return nullptr;
  Enc* e = new Enc();
  if (avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path) < 0) {
    destroy(e);
    return nullptr;
  }
  e->st = avformat_new_stream(e->fmt, nullptr);
  e->ctx = avcodec_alloc_context3(codec);
  e->frame = av_frame_alloc();
  e->pkt = av_packet_alloc();
  if (!e->st || !e->ctx || !e->frame || !e->pkt) {
    destroy(e);
    return nullptr;
  }
  AVRational rate = {fps_num, fps_den};
  e->ctx->width = w;
  e->ctx->height = h;
  e->ctx->pix_fmt = pf;
  e->ctx->time_base = av_inv_q(rate);
  e->ctx->framerate = rate;
  e->ctx->color_range = full_range ? AVCOL_RANGE_JPEG : AVCOL_RANGE_MPEG;
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER) e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary* opts = dict(codec_keys, codec_vals, n_codec);
  int rc = avcodec_open2(e->ctx, codec, &opts);
  av_dict_free(&opts);
  if (rc < 0 || avcodec_parameters_from_context(e->st->codecpar, e->ctx) < 0) {
    destroy(e);
    return nullptr;
  }
  e->st->time_base = e->ctx->time_base;
  e->st->avg_frame_rate = rate;
  if (avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    destroy(e);
    return nullptr;
  }
  AVDictionary* mux = dict(mux_keys, mux_vals, n_mux);
  rc = avformat_write_header(e->fmt, &mux);
  av_dict_free(&mux);
  if (rc < 0) {
    destroy(e);
    return nullptr;
  }
  e->header = true;
  e->frame->format = pf;
  e->frame->width = w;
  e->frame->height = h;
  e->frame->color_range = e->ctx->color_range;
  if (av_frame_get_buffer(e->frame, 0) < 0) {
    destroy(e);
    return nullptr;
  }
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, pf, SWS_BILINEAR, nullptr, nullptr,
                          nullptr);
  if (!e->sws) {
    destroy(e);
    return nullptr;
  }
  const int* coefs = sws_getCoefficients(SWS_CS_ITU601);
  sws_setColorspaceDetails(e->sws, coefs, 1, coefs, full_range ? 1 : 0, 0, 1 << 16, 1 << 16);
  return e;
}

int fx_write(void* handle, const uint8_t* rgb) {
  Enc* e = static_cast<Enc*>(handle);
  if (av_frame_make_writable(e->frame) < 0) return -1;
  const uint8_t* src[4] = {rgb, nullptr, nullptr, nullptr};
  int src_stride[4] = {3 * e->ctx->width, 0, 0, 0};
  sws_scale(e->sws, src, src_stride, 0, e->ctx->height, e->frame->data, e->frame->linesize);
  e->frame->pts = e->next_pts++;
  int rc = avcodec_send_frame(e->ctx, e->frame);
  if (rc < 0) return rc;
  return drain(e);
}

int fx_close(void* handle) {
  Enc* e = static_cast<Enc*>(handle);
  int rc = avcodec_send_frame(e->ctx, nullptr);
  if (rc >= 0) rc = drain(e);
  if (e->header) {
    int trc = av_write_trailer(e->fmt);
    if (rc >= 0) rc = trc;
  }
  destroy(e);
  return rc < 0 ? rc : 0;
}

}  // extern "C"
