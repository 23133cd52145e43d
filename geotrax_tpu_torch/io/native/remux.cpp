// Stream-copy concatenation, cut and container check on libavformat: the
// port's copy of geotrax_tpu/io/native/remux.cpp, built with g++ at first use
// by geotrax_tpu_torch/io/native/__init__.py and bound there with ctypes.
//
// DJI splits long recordings into parts of about 4 GB with identical stream
// layouts; merging them must not re-encode. gtx_remux_concat copies the
// packets bit for bit into one container, each part's timestamps offset by
// the duration of the parts before it, as ffmpeg's concat demuxer does
// (`ffmpeg -f concat -codec copy`). gtx_validate is `ffprobe -v error`'s
// check: the container opens, has a video stream and every packet reads.
//
// C ABI:
//   int gtx_remux_concat(const char* const* inputs, int n, const char* output)
//       0 ok, <0 error
//   int gtx_validate(const char* path)  // 0 ok
//   int gtx_remux_cut(const char* input, const char* output, int64_t start_pts,
//                     int64_t end_pts)
//       copies every packet whose pts (in the video stream's time base) lies
//       in [start_pts, end_pts], rebased to start near 0. start_pts must be
//       a keyframe's or the head of the clip does not decode: the contract of
//       `ffmpeg -ss .. -c copy`.

extern "C" {
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
#include <libavutil/mathematics.h>
}

#include <cstdint>
#include <vector>

extern "C" int gtx_validate(const char *path) {
    AVFormatContext *in = nullptr;
    if (avformat_open_input(&in, path, nullptr, nullptr) < 0)
        return -1;
    if (avformat_find_stream_info(in, nullptr) < 0) {
        avformat_close_input(&in);
        return -2;
    }
    bool has_video = false;
    for (unsigned s = 0; s < in->nb_streams; ++s)
        if (in->streams[s]->codecpar->codec_type == AVMEDIA_TYPE_VIDEO)
            has_video = true;
    AVPacket *pkt = av_packet_alloc();
    int rc;
    while ((rc = av_read_frame(in, pkt)) >= 0)
        av_packet_unref(pkt);
    av_packet_free(&pkt);
    avformat_close_input(&in);
    if (!has_video)
        return -3;
    return rc == AVERROR_EOF ? 0 : -4;
}

extern "C" int gtx_remux_cut(const char *input, const char *output,
                             int64_t start_pts, int64_t end_pts) {
    AVFormatContext *in = nullptr;
    if (avformat_open_input(&in, input, nullptr, nullptr) < 0)
        return -1;
    if (avformat_find_stream_info(in, nullptr) < 0) {
        avformat_close_input(&in);
        return -2;
    }
    int v = -1;
    for (unsigned s = 0; s < in->nb_streams; ++s)
        if (in->streams[s]->codecpar->codec_type == AVMEDIA_TYPE_VIDEO) {
            v = (int)s;
            break;
        }
    if (v < 0) {
        avformat_close_input(&in);
        return -3;
    }

    AVFormatContext *out = nullptr;
    if (avformat_alloc_output_context2(&out, nullptr, nullptr, output) < 0 ||
        !out) {
        avformat_close_input(&in);
        return -4;
    }
    int err = 0;
    int n_streams = (int)in->nb_streams;
    for (int s = 0; s < n_streams && !err; ++s) {
        AVStream *os = avformat_new_stream(out, nullptr);
        if (!os || avcodec_parameters_copy(os->codecpar,
                                           in->streams[s]->codecpar) < 0) {
            err = -5;
            break;
        }
        os->codecpar->codec_tag = 0;
        os->time_base = in->streams[s]->time_base;
        os->avg_frame_rate = in->streams[s]->avg_frame_rate;
    }
    // stream-copy dts can lead pts at the cut head; let the muxer shift
    // instead of hand-clamping (what ffmpeg -c copy does by default)
    out->avoid_negative_ts = AVFMT_AVOID_NEG_TS_MAKE_ZERO;
    if (!err && !(out->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&out->pb, output, AVIO_FLAG_WRITE) < 0)
        err = -6;
    if (!err && avformat_write_header(out, nullptr) < 0)
        err = -7;

    if (!err) {
        // seek near the window start so cutting the tail of a long video
        // doesn't demux the whole head
        av_seek_frame(in, v, start_pts, AVSEEK_FLAG_BACKWARD);
        AVPacket *pkt = av_packet_alloc();
        std::vector<int64_t> start_s(n_streams), end_s(n_streams);
        for (int s = 0; s < n_streams; ++s) {
            start_s[s] = av_rescale_q(start_pts, in->streams[v]->time_base,
                                      in->streams[s]->time_base);
            end_s[s] = av_rescale_q(end_pts, in->streams[v]->time_base,
                                    in->streams[s]->time_base);
        }
        bool video_done = false;
        while (!video_done && av_read_frame(in, pkt) >= 0) {
            int s = pkt->stream_index;
            int64_t t = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
            if (t == AV_NOPTS_VALUE || t < start_s[s] || t > end_s[s]) {
                // packets past the window end keep arriving for other
                // streams; stop once the video stream passes it
                if (s == v && t != AV_NOPTS_VALUE && t > end_s[s])
                    video_done = true;
                av_packet_unref(pkt);
                continue;
            }
            if (pkt->pts != AV_NOPTS_VALUE)
                pkt->pts -= start_s[s];
            if (pkt->dts != AV_NOPTS_VALUE)
                pkt->dts -= start_s[s];
            pkt->pos = -1;
            av_packet_rescale_ts(pkt, in->streams[s]->time_base,
                                 out->streams[s]->time_base);
            if (av_interleaved_write_frame(out, pkt) < 0) {
                err = -8;
                break;
            }
            av_packet_unref(pkt);
        }
        av_packet_free(&pkt);
        av_write_trailer(out);
    }
    // also where the header failed after the file opened (a NULL pb is a no-op)
    if (!(out->oformat->flags & AVFMT_NOFILE))
        avio_closep(&out->pb);
    avformat_free_context(out);
    avformat_close_input(&in);
    return err;
}

extern "C" int gtx_remux_concat(const char *const *inputs, int n,
                                const char *output) {
    if (n < 1)
        return -1;
    AVFormatContext *out = nullptr;
    if (avformat_alloc_output_context2(&out, nullptr, nullptr, output) < 0 ||
        !out)
        return -2;

    std::vector<int64_t> offset;  // per stream, in the OUTPUT timebase
    int n_streams = 0;
    bool header_written = false;
    int err = 0;

    for (int i = 0; i < n && !err; ++i) {
        AVFormatContext *in = nullptr;
        if (avformat_open_input(&in, inputs[i], nullptr, nullptr) < 0) {
            err = -3;
            break;
        }
        if (avformat_find_stream_info(in, nullptr) < 0) {
            avformat_close_input(&in);
            err = -4;
            break;
        }

        if (!header_written) {
            n_streams = (int)in->nb_streams;
            for (int s = 0; s < n_streams; ++s) {
                AVStream *os = avformat_new_stream(out, nullptr);
                if (!os ||
                    avcodec_parameters_copy(os->codecpar,
                                            in->streams[s]->codecpar) < 0) {
                    err = -5;
                    break;
                }
                os->codecpar->codec_tag = 0;
                os->time_base = in->streams[s]->time_base;
                os->avg_frame_rate = in->streams[s]->avg_frame_rate;
            }
            if (!err && !(out->oformat->flags & AVFMT_NOFILE) &&
                avio_open(&out->pb, output, AVIO_FLAG_WRITE) < 0)
                err = -6;
            if (!err && avformat_write_header(out, nullptr) < 0)
                err = -7;
            if (err) {
                avformat_close_input(&in);
                break;
            }
            offset.assign(n_streams, 0);
            header_written = true;
        }
        // later parts must share the layout; only the common prefix of
        // streams is copied (DJI parts are identical in practice)
        int usable = n_streams < (int)in->nb_streams ? n_streams
                                                     : (int)in->nb_streams;

        std::vector<int64_t> max_end(n_streams, 0);
        AVPacket *pkt = av_packet_alloc();
        while (av_read_frame(in, pkt) >= 0) {
            int s = pkt->stream_index;
            if (s >= usable) {
                av_packet_unref(pkt);
                continue;
            }
            av_packet_rescale_ts(pkt, in->streams[s]->time_base,
                                 out->streams[s]->time_base);
            int64_t base = pkt->dts != AV_NOPTS_VALUE   ? pkt->dts
                           : pkt->pts != AV_NOPTS_VALUE ? pkt->pts
                                                        : 0;
            int64_t end = base + (pkt->duration > 0 ? pkt->duration : 0);
            if (end > max_end[s])
                max_end[s] = end;
            if (pkt->pts != AV_NOPTS_VALUE)
                pkt->pts += offset[s];
            if (pkt->dts != AV_NOPTS_VALUE)
                pkt->dts += offset[s];
            pkt->pos = -1;
            if (av_interleaved_write_frame(out, pkt) < 0) {
                err = -8;
                break;
            }
        }
        av_packet_free(&pkt);

        for (int s = 0; s < usable; ++s) {
            int64_t adv = max_end[s];
            if (in->duration > 0) {
                // container duration covers streams whose last packet
                // carries no duration (e.g. some data/subtitle tracks)
                int64_t d = av_rescale_q(in->duration, AV_TIME_BASE_Q,
                                         out->streams[s]->time_base);
                if (d > adv)
                    adv = d;
            }
            offset[s] += adv;
        }
        avformat_close_input(&in);
    }

    if (header_written)
        av_write_trailer(out);
    if (!(out->oformat->flags & AVFMT_NOFILE))
        avio_closep(&out->pb);
    avformat_free_context(out);
    return err;
}
