"""Host-side audio I/O (the L1 layer): decode, cache, chunk, mix.

The reference decodes any container through PyAV/FFmpeg (utils.py:178-199).
Here: the native WAV codec (stdlib-based, with an optional C++ fast path)
covers the shipped WAV corpora; mp3 and webm/opus decode through the
system codec libraries via ctypes (io/codec.py — libmpg123 and a pure-
Python Matroska demux + libopus), with an ffmpeg-binary subprocess as a
last-resort fallback for anything else. All paths are capability-gated.
"""

from audio_denoising_torch.io.wavio import read_wav, write_wav, pcm_to_float32, float32_to_pcm16
from audio_denoising_torch.io.cache import AudioCache
from audio_denoising_torch.io.stream import (
    buffer_stream, limit_stream, combine_audio, clip_audio_to_same_size,
    stream_audio,
)
from audio_denoising_torch.io.codec import (
    codec_available, mp3_available, opus_available, probe_mp3_rate,
    read_audio_codec, read_mp3, read_webm_opus,
)
from audio_denoising_torch.io.ffmpeg import ffmpeg_available, read_audio_ffmpeg
from audio_denoising_torch.io.avdec import av_available, read_audio_av

__all__ = [
    "read_wav", "write_wav", "pcm_to_float32", "float32_to_pcm16",
    "AudioCache", "buffer_stream", "limit_stream", "combine_audio",
    "clip_audio_to_same_size", "stream_audio",
    "codec_available", "mp3_available", "opus_available", "probe_mp3_rate",
    "read_audio_codec", "read_mp3", "read_webm_opus",
    "ffmpeg_available", "read_audio_ffmpeg",
    "av_available", "read_audio_av",
]
