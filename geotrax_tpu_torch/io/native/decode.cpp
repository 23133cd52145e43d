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
//   void   gtx_close(void*)
//   long   gtx_keyframe_indices(const char* path, long* out, long max_out)
//   long   gtx_scan_pts(const char* path, int64_t* pts_out, int* key_out,
//                       long max_out)  // frames, -2 without pts, -1 error

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
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

// Decode the next frame into rgb_out (height*width*3, packed RGB24).
// pts_out (optional) receives the frame's best-effort display timestamp in
// the stream time base: the key of ParallelVideoReader's segments.
static int read_frame_impl(Decoder* d, uint8_t* rgb_out, int64_t* pts_out) {
  while (true) {
    int rc = avcodec_receive_frame(d->codec, d->frame);
    if (rc == 0) {
      if (pts_out) {
        *pts_out = d->frame->best_effort_timestamp != AV_NOPTS_VALUE
                       ? d->frame->best_effort_timestamp
                       : d->frame->pts;
      }
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

int gtx_read_frame(void* h, uint8_t* rgb_out) {
  return read_frame_impl(static_cast<Decoder*>(h), rgb_out, nullptr);
}

int gtx_read_frame_pts(void* h, uint8_t* rgb_out, int64_t* pts_out) {
  return read_frame_impl(static_cast<Decoder*>(h), rgb_out, pts_out);
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
