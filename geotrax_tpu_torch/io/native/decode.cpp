// Native video decoder of geotrax_tpu_torch (the port's copy of
// geotrax_tpu/io/native/decode.cpp: the sequential decoder, the keyframe
// scan and the GOP-parallel extension).
//
// Deterministic decoding on libavformat/libavcodec with swscale conversion
// to packed RGB24, driven from Python through ctypes
// (geotrax_tpu_torch/io/native/__init__.py builds this file with g++ at
// first use). gtx_open decodes in stream order, so indices are exact
// regardless of keyframe placement. For GOP-parallel decoding,
// gtx_scan_pts maps display index -> pts from the packets alone, and each
// worker opens its own decoder with gtx_open_at, seeked backward to a
// keyframe, and keeps the frames whose pts fall in its segment.
//
// C ABI:
//   void*  gtx_open(const char* path)
//   void*  gtx_open_at(const char* path, int64_t seek_pts, int threads)
//   int    gtx_width(void*), gtx_height(void*)
//   double gtx_fps(void*)
//   long   gtx_frame_count(void*)   // container estimate; <=0 if unknown
//   int    gtx_read_frame(void*, uint8_t* rgb_out)  // 0 ok, 1 EOF, <0 error
//   int    gtx_read_frame_pts(void*, uint8_t* rgb_out, int64_t* pts_out)
//   int    gtx_read_frame_yuv(void*, uint8_t* y_out, uint8_t* uv_out)  // NV12, no swscale
//   int    gtx_pixel_format(void*, char* name, int len, int* info)  // the stream's format
//   int    gtx_read_frame_planes(void*, int format, uint8_t* out, int* got)  // Y, U, V
//   void   gtx_close(void*)
//   long   gtx_keyframe_indices(const char* path, long* out, long max_out)
//   long   gtx_scan_pts(const char* path, int64_t* pts_out, int* key_out,
//                       long max_out)  // frames, -2 without pts, -1 error

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  bool draining = false;
  uint8_t* rgb = nullptr;  // padded scratch rows (see read_frame_impl)
  int rgb_linesize = 0;
};

void destroy(Decoder* d) {
  if (!d) return;
  if (d->sws) sws_freeContext(d->sws);
  if (d->rgb) av_free(d->rgb);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ``threads`` <= 0 -> libavcodec auto threading (one worker per core).
Decoder* open_impl(const char* path, int threads) {
  Decoder* d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  d->stream_index =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (d->stream_index < 0 || !codec) {
    destroy(d);
    return nullptr;
  }
  AVStream* st = d->fmt->streams[d->stream_index];
  d->codec = avcodec_alloc_context3(codec);
  if (!d->codec ||
      avcodec_parameters_to_context(d->codec, st->codecpar) < 0) {
    destroy(d);
    return nullptr;
  }
  // Host decode is the end-to-end bottleneck on 4K sources (the device
  // pipeline outruns a single-threaded decoder several times over): enable
  // libavcodec auto threading (one worker per core). Frame threading adds
  // pipeline delay but not reordering — output frames and indices are
  // bit-identical, and the drain path already handles the tail.
  d->codec->thread_count = threads > 0 ? threads : 0;
  d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  if (avcodec_open2(d->codec, codec, nullptr) < 0) {
    destroy(d);
    return nullptr;
  }
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  if (!d->pkt || !d->frame) {
    destroy(d);
    return nullptr;
  }
  return d;
}

}  // namespace

extern "C" {

void* gtx_open(const char* path) { return open_impl(path, 0); }

// Open and seek backward to the keyframe at-or-before seek_pts (stream time
// base). The caller (a ParallelVideoReader worker) then discards decoded
// frames whose pts precede its segment: exact wherever the demuxer lands,
// because segment membership is decided by the display pts of
// gtx_scan_pts, never by counting frames after a seek.
void* gtx_open_at(const char* path, int64_t seek_pts, int threads) {
  Decoder* d = open_impl(path, threads);
  if (!d) return nullptr;
  if (av_seek_frame(d->fmt, d->stream_index, seek_pts, AVSEEK_FLAG_BACKWARD) < 0) {
    destroy(d);
    return nullptr;
  }
  avcodec_flush_buffers(d->codec);
  return d;
}

int gtx_width(void* h) { return static_cast<Decoder*>(h)->codec->width; }
int gtx_height(void* h) { return static_cast<Decoder*>(h)->codec->height; }

double gtx_fps(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  AVStream* st = d->fmt->streams[d->stream_index];
  AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  return r.den ? static_cast<double>(r.num) / r.den : 0.0;
}

long gtx_frame_count(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  AVStream* st = d->fmt->streams[d->stream_index];
  if (st->nb_frames > 0) return static_cast<long>(st->nb_frames);
  if (d->fmt->duration > 0) {
    double secs = static_cast<double>(d->fmt->duration) / AV_TIME_BASE;
    double fps = gtx_fps(h);
    if (fps > 0) return static_cast<long>(secs * fps + 0.5);
  }
  return -1;
}

// Receive the next decoded frame into d->frame (feeding packets from the
// demuxer as the decoder asks): 0 ok, 1 EOF, <0 error. pts_out (optional)
// receives the frame's best-effort display timestamp in the stream time
// base: the key of ParallelVideoReader's segments.
static int next_frame(Decoder* d, int64_t* pts_out) {
  while (true) {
    int rc = avcodec_receive_frame(d->codec, d->frame);
    if (rc == 0) {
      if (pts_out) {
        *pts_out = d->frame->best_effort_timestamp != AV_NOPTS_VALUE
                       ? d->frame->best_effort_timestamp
                       : d->frame->pts;
      }
      return 0;
    }
    if (rc == AVERROR_EOF) return 1;
    if (rc != AVERROR(EAGAIN)) return -1;
    if (d->draining) continue;

    // Feed the next packet from the demuxer.
    while (true) {
      rc = av_read_frame(d->fmt, d->pkt);
      if (rc < 0) {
        d->draining = true;
        avcodec_send_packet(d->codec, nullptr);  // flush
        break;
      }
      if (d->pkt->stream_index == d->stream_index) {
        rc = avcodec_send_packet(d->codec, d->pkt);
        av_packet_unref(d->pkt);
        if (rc < 0 && rc != AVERROR(EAGAIN)) return -1;
        break;
      }
      av_packet_unref(d->pkt);
    }
  }
}

// Decode the next frame into rgb_out (height*width*3, packed RGB24).
static int read_frame_impl(Decoder* d, uint8_t* rgb_out, int64_t* pts_out) {
  int rc = next_frame(d, pts_out);
  if (rc != 0) return rc;
  if (!d->sws) {
    d->sws = sws_getContext(
        d->codec->width, d->codec->height,
        static_cast<AVPixelFormat>(d->frame->format), d->codec->width,
        d->codec->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr,
        nullptr);
    if (!d->sws) return -2;
  }
  // swscale stores whole SIMD vectors and can write past the end of a
  // row whose length (3 * width bytes) is not a multiple of their
  // size: into the next row, which is rewritten after, or past the end
  // of the caller's buffer on the last row. Rows of 64-byte multiples
  // go straight into rgb_out; other widths go through a scratch buffer
  // of padded rows and are copied out.
  const int w = d->codec->width, h = d->codec->height, row = 3 * w;
  const bool direct = row % 64 == 0;
  if (!direct && !d->rgb) {
    d->rgb_linesize = (row + 63) / 64 * 64;
    d->rgb = static_cast<uint8_t*>(av_malloc(
        static_cast<size_t>(d->rgb_linesize) * h + 64));
    if (!d->rgb) return -3;
  }
  uint8_t* dst_data[4] = {direct ? rgb_out : d->rgb, nullptr, nullptr, nullptr};
  int dst_linesize[4] = {direct ? row : d->rgb_linesize, 0, 0, 0};
  sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, h, dst_data,
            dst_linesize);
  if (!direct) {
    for (int y = 0; y < h; ++y) {
      std::memcpy(rgb_out + static_cast<size_t>(y) * row,
                  d->rgb + static_cast<size_t>(y) * d->rgb_linesize, row);
    }
  }
  av_frame_unref(d->frame);
  return 0;
}

int gtx_read_frame(void* h, uint8_t* rgb_out) {
  return read_frame_impl(static_cast<Decoder*>(h), rgb_out, nullptr);
}

int gtx_read_frame_pts(void* h, uint8_t* rgb_out, int64_t* pts_out) {
  return read_frame_impl(static_cast<Decoder*>(h), rgb_out, pts_out);
}

// The next frame's planes as the decoder gives them, before swscale, in
// NV12 layout: the Y plane (height rows of width bytes) into y_out, then U
// and V interleaved (height/2 rows of width bytes: U0 V0 U1 V1 ...) into
// uv_out. 0 ok, 1 EOF, -1 decode error, -4 when the frame is not yuv420p
// (8-bit 4:2:0, limited range), -5 when a side is odd.
int gtx_read_frame_yuv(void* h, uint8_t* y_out, uint8_t* uv_out) {
  Decoder* d = static_cast<Decoder*>(h);
  int rc = next_frame(d, nullptr);
  if (rc != 0) return rc;
  const AVFrame* f = d->frame;
  const int w = d->codec->width, hh = d->codec->height;
  if (f->format != AV_PIX_FMT_YUV420P) rc = -4;
  else if (w % 2 || hh % 2) rc = -5;
  if (rc == 0) {
    for (int y = 0; y < hh; ++y) {
      std::memcpy(y_out + static_cast<size_t>(y) * w,
                  f->data[0] + static_cast<size_t>(y) * f->linesize[0], w);
    }
    for (int y = 0; y < hh / 2; ++y) {
      const uint8_t* u = f->data[1] + static_cast<size_t>(y) * f->linesize[1];
      const uint8_t* v = f->data[2] + static_cast<size_t>(y) * f->linesize[2];
      uint8_t* out = uv_out + static_cast<size_t>(y) * w;
      for (int x = 0; x < w / 2; ++x) {
        out[2 * x] = u[x];
        out[2 * x + 1] = v[x];
      }
    }
  }
  av_frame_unref(d->frame);
  return rc;
}

// The stream's pixel format as libavcodec reports it once the stream is
// probed (or, after frames, the last frame's): libav's name into name (at
// most len bytes with its terminator), and into info[0..5] the bits a
// sample, log2 of the chroma subsampling across and down, 1 for a yuvj
// format (full range by its name: swscale reads the range from the name
// alone), the number of planes and the AVPixelFormat value. 0 ok, -1 when
// the format is not known.
int gtx_pixel_format(void* h, char* name, int len, int* info) {
  const AVPixelFormat fmt = static_cast<Decoder*>(h)->codec->pix_fmt;
  const AVPixFmtDescriptor* desc = av_pix_fmt_desc_get(fmt);
  if (fmt == AV_PIX_FMT_NONE || !desc || len <= 0) return -1;
  std::strncpy(name, desc->name, len - 1);
  name[len - 1] = 0;
  info[0] = desc->comp[0].depth;
  info[1] = desc->log2_chroma_w;
  info[2] = desc->log2_chroma_h;
  info[3] = fmt == AV_PIX_FMT_YUVJ420P || fmt == AV_PIX_FMT_YUVJ422P ||
            fmt == AV_PIX_FMT_YUVJ444P || fmt == AV_PIX_FMT_YUVJ440P ||
            fmt == AV_PIX_FMT_YUVJ411P;
  info[4] = av_pix_fmt_count_planes(fmt);
  info[5] = static_cast<int>(fmt);
  return 0;
}

// The next frame's Y, U and V planes as the decoder gives them, before
// swscale, one after the other into out: Y (height rows of width samples),
// then U, then V (each height >> log2_chroma_h rows of width >>
// log2_chroma_w samples, both rounded up), samples of 1 byte (8-bit) or 2
// (9 to 16 bits, libav's words as they lie in memory), rows without
// padding. format is the AVPixelFormat the caller sized out for (the
// stream's first frame's, from which the reference builds its swscale
// context); *got receives the frame's. 0 ok, 1 EOF, -1 decode error, -6
// when the frame's format is not format, -7 when it is not planar YUV of 3
// planes.
int gtx_read_frame_planes(void* h, int format, uint8_t* out, int* got) {
  Decoder* d = static_cast<Decoder*>(h);
  int rc = next_frame(d, nullptr);
  if (rc != 0) return rc;
  const AVFrame* f = d->frame;
  *got = f->format;
  const AVPixFmtDescriptor* desc = av_pix_fmt_desc_get(static_cast<AVPixelFormat>(f->format));
  if (f->format != format) {
    rc = -6;
  } else if (!desc || av_pix_fmt_count_planes(static_cast<AVPixelFormat>(f->format)) != 3 ||
             (desc->flags & (AV_PIX_FMT_FLAG_RGB | AV_PIX_FMT_FLAG_PAL | AV_PIX_FMT_FLAG_BE))) {
    rc = -7;
  } else {
    const int w = d->codec->width, hh = d->codec->height;
    const int bytes = desc->comp[0].depth > 8 ? 2 : 1;
    const int cw = -((-w) >> desc->log2_chroma_w), ch = -((-hh) >> desc->log2_chroma_h);
    uint8_t* dst = out;
    for (int p = 0; p < 3; ++p) {
      const int rows = p ? ch : hh;
      const size_t row = static_cast<size_t>(p ? cw : w) * bytes;
      for (int y = 0; y < rows; ++y) {
        std::memcpy(dst, f->data[p] + static_cast<size_t>(y) * f->linesize[p], row);
        dst += row;
      }
    }
  }
  av_frame_unref(d->frame);
  return rc;
}

void gtx_close(void* h) { destroy(static_cast<Decoder*>(h)); }

// Keyframe scan: walk the packets (no decoding) and record the display
// index of every packet flagged AV_PKT_FLAG_KEY. Packets arrive in decode
// order, which differs from display order when the stream has B-frames, so
// the indices come from sorting the packets' pts, and only when every
// packet has one: mixing dts (decode order) into a list of pts can rank a
// B-frame ahead of the keyframe before it. Without pts on every packet the
// arrival order stands (exact for streams without B-frames, as DJI's). The
// cut tools snap cut starts to these indices. Returns the number of
// keyframes written to out (at most max_out), or -1.
long gtx_keyframe_indices(const char* path, long* out, long max_out) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  int stream_index = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (stream_index < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  AVPacket* pkt = av_packet_alloc();
  std::vector<std::pair<int64_t, int>> stamps;  // (timestamp, is_key)
  bool have_ts = true;
  long arrival = 0;
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream_index) {
      int64_t ts = pkt->pts;
      if (ts == AV_NOPTS_VALUE) have_ts = false;
      stamps.emplace_back(have_ts ? ts : arrival, (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0);
      ++arrival;
    }
    av_packet_unref(pkt);
  }
  if (have_ts) {
    std::stable_sort(stamps.begin(), stamps.end(),
                     [](const std::pair<int64_t, int>& a, const std::pair<int64_t, int>& b) {
                       return a.first < b.first;
                     });
  }
  long n = 0;
  for (long i = 0; i < static_cast<long>(stamps.size()) && n < max_out; ++i) {
    if (stamps[i].second) out[n++] = i;
  }
  av_packet_free(&pkt);
  avformat_close_input(&fmt);
  return n;
}

// Display-order frame map for GOP-parallel decoding: pts_out[i] and
// key_out[i] give the pts and keyframe flag of display frame i. A scan of
// the packets (no decoding), so mapping a 2 h 4K video costs a pass over
// the file, not a decode. Returns the frame count (which may exceed
// max_out: only max_out are written), -2 when a packet lacks a pts (the
// caller decodes sequentially: segments cannot be keyed), -1 when the file
// does not open.
long gtx_scan_pts(const char* path, int64_t* pts_out, int* key_out, long max_out) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  int stream_index = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (stream_index < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  AVPacket* pkt = av_packet_alloc();
  std::vector<std::pair<int64_t, int>> stamps;  // (pts, is_key)
  bool have_ts = true;
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream_index) {
      if (pkt->pts == AV_NOPTS_VALUE) have_ts = false;
      stamps.emplace_back(pkt->pts, (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0);
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  avformat_close_input(&fmt);
  if (!have_ts) return -2;
  std::stable_sort(stamps.begin(), stamps.end(),
                   [](const std::pair<int64_t, int>& a, const std::pair<int64_t, int>& b) {
                     return a.first < b.first;
                   });
  long n = std::min(static_cast<long>(stamps.size()), max_out);
  for (long i = 0; i < n; ++i) {
    pts_out[i] = stamps[i].first;
    key_out[i] = stamps[i].second;
  }
  return static_cast<long>(stamps.size());
}

}  // extern "C"
