// Native video encoder of the PyTorch port (its copy of
// geotrax_tpu/io/native/encode.cpp).
//
// Host-side MPEG-4 (mp4v) encoder on libavformat/libavcodec with swscale
// RGB24 -> YUV420P conversion: the container and codec that cv2.VideoWriter
// writes with the mp4v fourcc on linux, without OpenCV. The Python layer
// drives it via ctypes (geotrax_tpu_torch/io/video.py VideoWriter), which
// falls back to cv2 when this library cannot be built and raises when
// neither exists.
//
// C ABI:
//   void* gtx_enc_open(const char* path, int w, int h, double fps, long bitrate)
//   int   gtx_enc_write(void* h, const uint8_t* rgb)   // 0 ok, <0 error
//   int   gtx_enc_close(void* h)                       // flush + trailer

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>

namespace {

struct Encoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int64_t next_pts = 0;
  bool header_written = false;
};

void destroy(Encoder* e) {
  if (!e) return;
  if (e->sws) sws_freeContext(e->sws);
  if (e->frame) av_frame_free(&e->frame);
  if (e->pkt) av_packet_free(&e->pkt);
  if (e->codec) avcodec_free_context(&e->codec);
  if (e->fmt) {
    if (e->fmt->pb) avio_closep(&e->fmt->pb);
    avformat_free_context(e->fmt);
  }
  delete e;
}

int drain(Encoder* e) {
  while (true) {
    int ret = avcodec_receive_packet(e->codec, e->pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) return ret;
    // the muxer infers durations from dts deltas and leaves the FINAL
    // sample at 0, which demuxers then drop — stamp one frame interval
    if (e->pkt->duration == 0) e->pkt->duration = 1;
    av_packet_rescale_ts(e->pkt, e->codec->time_base, e->stream->time_base);
    e->pkt->stream_index = e->stream->index;
    ret = av_interleaved_write_frame(e->fmt, e->pkt);
    if (ret < 0) return ret;
  }
}

}  // namespace

extern "C" {

void* gtx_enc_open(const char* path, int w, int h, double fps, long bitrate) {
  Encoder* e = new Encoder();
  if (avformat_alloc_output_context2(&e->fmt, nullptr, nullptr, path) < 0 ||
      !e->fmt) {
    destroy(e);
    return nullptr;
  }
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) {
    destroy(e);
    return nullptr;
  }
  e->stream = avformat_new_stream(e->fmt, nullptr);
  e->codec = avcodec_alloc_context3(codec);
  if (!e->stream || !e->codec) {
    destroy(e);
    return nullptr;
  }
  e->codec->width = w;
  e->codec->height = h;
  // rational fps (29.97 = 30000/1001 must round-trip)
  AVRational tb = av_d2q(1.0 / fps, 100000);
  e->codec->time_base = tb;
  e->codec->framerate = AVRational{tb.den, tb.num};
  e->codec->pix_fmt = AV_PIX_FMT_YUV420P;
  e->codec->bit_rate = bitrate > 0 ? bitrate : (int64_t)w * h * 4;
  e->codec->gop_size = 12;
  // Deliberately single-threaded: slice-threaded mpeg4 encoding inserts
  // resync markers, so the written bitstream would vary with the host's
  // core count. Visualization outputs stay byte-reproducible across
  // machines; the decoder (decode.cpp) is where threading pays off.
  if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    e->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(e->codec, codec, nullptr) < 0) {
    destroy(e);
    return nullptr;
  }
  if (avcodec_parameters_from_context(e->stream->codecpar, e->codec) < 0) {
    destroy(e);
    return nullptr;
  }
  e->stream->time_base = e->codec->time_base;
  e->stream->avg_frame_rate = e->codec->framerate;
  e->stream->r_frame_rate = e->codec->framerate;
  if (!(e->fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
      destroy(e);
      return nullptr;
    }
  }
  if (avformat_write_header(e->fmt, nullptr) < 0) {
    destroy(e);
    return nullptr;
  }
  e->header_written = true;
  e->frame = av_frame_alloc();
  e->pkt = av_packet_alloc();
  e->frame->format = AV_PIX_FMT_YUV420P;
  e->frame->width = w;
  e->frame->height = h;
  if (av_frame_get_buffer(e->frame, 0) < 0) {
    destroy(e);
    return nullptr;
  }
  e->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                          SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!e->sws) {
    destroy(e);
    return nullptr;
  }
  return e;
}

int gtx_enc_write(void* h, const uint8_t* rgb) {
  Encoder* e = static_cast<Encoder*>(h);
  if (av_frame_make_writable(e->frame) < 0) return -1;
  const uint8_t* src[1] = {rgb};
  const int src_stride[1] = {3 * e->codec->width};
  sws_scale(e->sws, src, src_stride, 0, e->codec->height, e->frame->data,
            e->frame->linesize);
  e->frame->pts = e->next_pts++;
  int ret = avcodec_send_frame(e->codec, e->frame);
  if (ret < 0) return ret;
  return drain(e);
}

int gtx_enc_close(void* h) {
  Encoder* e = static_cast<Encoder*>(h);
  int ret = 0;
  if (e->codec) {
    avcodec_send_frame(e->codec, nullptr);  // flush
    ret = drain(e);
    if (e->header_written) av_write_trailer(e->fmt);
  }
  destroy(e);
  return ret;
}

}  // extern "C"
