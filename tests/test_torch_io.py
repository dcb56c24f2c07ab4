"""The port's host audio I/O (``audio_denoising_torch.io``) against the JAX
package's on the same inputs, on the CPU: WAV read and write at every
PCM width with and without the native library, the native conversions
and re-chunker, FLAC, Ogg Vorbis, the WebM/Opus demux and the linked
FFmpeg decoder (each where its system library is present, as
tests/test_codec.py gates them), ``AudioCache``, the stream helpers and
the WebSocket frame codec. Every comparison is bit for bit. Also: the
port's native builds land in its own ``build/`` and never write into
``native/``."""

import os
import shutil
import socket
import subprocess
import sys
import wave

import numpy as np
import pytest

from audio_denoising_tpu import io as jio
from audio_denoising_tpu.io import cache as jcache
from audio_denoising_tpu.io import codec as jcodec
from audio_denoising_tpu.io import flac as jflac
from audio_denoising_tpu.io import native as jnative
from audio_denoising_tpu.io import stream as jstream
from audio_denoising_tpu.io import websocket as jws

from audio_denoising_torch import io as pio
from audio_denoising_torch.io import avdec as pavdec
from audio_denoising_torch.io import cache as pcache
from audio_denoising_torch.io import codec as pcodec
from audio_denoising_torch.io import flac as pflac
from audio_denoising_torch.io import native as pnative
from audio_denoising_torch.io import playback as pplayback
from audio_denoising_torch.io import stream as pstream
from audio_denoising_torch.io import websocket as pws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(a, b):
    """Bit for bit: same dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _pcm_wav(path, ints, width, rate=22050):
    """Write (C, N) integer samples as a PCM WAV of ``width`` bytes with
    the stdlib (8-bit WAV is unsigned, the others little-endian signed)."""
    ch = ints.shape[0]
    inter = ints.T.reshape(-1)
    if width == 1:
        raw = (inter + 128).astype(np.uint8).tobytes()
    elif width == 3:
        le = inter.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        raw = np.ascontiguousarray(le).tobytes()
    else:
        raw = inter.astype({2: "<i2", 4: "<i4"}[width]).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)


@pytest.fixture(params=["native", "numpy"])
def lib_mode(request, monkeypatch):
    """Both packages with their native library, or both without it."""
    if request.param == "numpy":
        monkeypatch.setattr(pnative, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert pnative.native_available() and jnative.native_available()
    return request.param


def test_exports_match_jax():
    assert sorted(pio.__all__) == sorted(jio.__all__)
    for name in pio.__all__:
        assert callable(getattr(pio, name)), name


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav_matches_jax(tmp_path, rng, lib_mode, width):
    top = 1 << (8 * width - 1)
    ints = rng.integers(-top, top, size=(2, 3001), dtype=np.int64)
    ints[:, :4] = [[-top, top - 1, 0, -1], [top - 1, -top, 1, 0]]
    path = tmp_path / f"w{width}.wav"
    _pcm_wav(path, ints, width)
    got, sr = pio.read_wav(str(path))
    want, jsr = jio.read_wav(str(path))
    assert sr == jsr == 22050 and got.shape == (2, 3001)
    _equal(got, want)
    _equal(pio.read_wav(str(path), mono=True)[0],
           jio.read_wav(str(path), mono=True)[0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_write_wav_matches_jax(tmp_path, rng, lib_mode, dtype):
    """Float samples (clipped beyond +-1) to 16-bit PCM, mono and stereo:
    the two packages write the same bytes."""
    for shape in [(4000,), (2, 4000)]:
        x = (0.7 * rng.standard_normal(shape)).astype(dtype)
        a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
        pio.write_wav(str(a), x, 16000)
        jio.write_wav(str(b), x, 16000)
        assert a.read_bytes() == b.read_bytes()
        _equal(pio.read_wav(str(a))[0], jio.read_wav(str(b))[0])


def test_pcm_conversions_match_jax(rng, lib_mode):
    for dtype in (np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dtype)
        ints = rng.integers(info.min, info.max, size=500, dtype=dtype)
        _equal(pio.pcm_to_float32(ints), jio.pcm_to_float32(ints))
    for dtype in (np.float32, np.float64):
        x = rng.standard_normal(500).astype(dtype)
        _equal(pio.pcm_to_float32(x), jio.pcm_to_float32(x))
        _equal(pio.float32_to_pcm16(x), jio.float32_to_pcm16(x))


def test_native_functions_match_jax(rng):
    assert pnative.native_available()
    x = (1.5 * rng.standard_normal((3, 777))).astype(np.float32)
    ints = rng.integers(-32768, 32767, size=777, dtype=np.int16)
    raw24 = rng.integers(0, 256, size=3 * 333, dtype=np.uint8)
    _equal(pnative.pcm16_to_f32(ints), jnative.pcm16_to_f32(ints))
    _equal(pnative.f32_to_pcm16(x), jnative.f32_to_pcm16(x))
    _equal(pnative.pcm24_to_f32(raw24), jnative.pcm24_to_f32(raw24))
    _equal(pnative.deinterleave(x.reshape(-1), 3),
           jnative.deinterleave(x.reshape(-1), 3))
    _equal(pnative.interleave(x), jnative.interleave(x))
    assert pnative.peak(x) == jnative.peak(x)
    _equal(pnative.combine(x, x[::-1].copy()),
           jnative.combine(x, x[::-1].copy()))


def test_native_chunker_matches_jax(rng):
    p, j = pnative.NativeChunker(160), jnative.NativeChunker(160)
    for n in (50, 400, 7, 333, 1):
        piece = rng.standard_normal(n).astype(np.float32)
        assert p.push(piece) == j.push(piece)
        while True:
            a, b = p.pop(), j.pop()
            assert (a is None) == (b is None)
            if a is None:
                break
            _equal(a, b)
        assert p.pending == j.pending


# -- the port's native builds -------------------------------------------------

def _snapshot(directory):
    return sorted((e.name, e.stat().st_size, e.stat().st_mtime_ns)
                  for e in os.scandir(directory))


def test_native_builds_land_in_the_ports_build_dir():
    build = os.path.join(REPO, "audio_denoising_torch", "build")
    assert pnative._LIB_PATH == os.path.join(build, "libadt_native.so")
    assert pavdec._LIB_PATH == os.path.join(build, "libadt_codec.so")
    assert pnative._SRC_PATH == os.path.join(REPO, "native", "adt_native.cpp")
    assert pavdec._SRC_PATH == os.path.join(REPO, "native", "adt_codec.cpp")


def test_native_build_never_writes_into_native(tmp_path):
    """In a copy of the port and of native/'s sources (the JAX package's
    tests may build into the repo's native/ meanwhile), build both
    libraries from scratch and load them: native/ keeps its listing,
    sizes and mtimes, and the libraries are in the port's build/."""
    shutil.copytree(os.path.join(REPO, "audio_denoising_torch"),
                    tmp_path / "audio_denoising_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__",
                                                  "csrc"))
    (tmp_path / "native").mkdir()
    for f in ("adt_native.cpp", "adt_codec.cpp"):
        shutil.copy2(os.path.join(REPO, "native", f), tmp_path / "native")
    before = _snapshot(tmp_path / "native")
    code = ("from audio_denoising_torch.io import native, avdec\n"
            "assert native.native_available()\n"
            "print(avdec.av_available())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _snapshot(tmp_path / "native") == before
    built = sorted(os.listdir(tmp_path / "audio_denoising_torch" / "build"))
    want = ["libadt_native.so"]
    if proc.stdout.strip() == "True":
        want = ["libadt_codec.so", "libadt_native.so"]
    assert built == want


# -- compressed containers ----------------------------------------------------

def _tone(n=5000, sr=16000, ch=1):
    t = np.arange(n) / sr
    return np.stack([0.5 * np.sin(2 * np.pi * (300 + 120 * c) * t)
                     for c in range(ch)]).astype(np.float32)


@pytest.mark.parametrize("kind,mode,ch", [
    ("constant", "independent", 1), ("verbatim", "independent", 1),
    ("fixed2", "independent", 1), ("lpc1", "independent", 1),
    ("lpc1", "left_side", 2), ("lpc1", "right_side", 2),
    ("lpc1", "mid_side", 2), ("fixed2", "independent", 2)])
def test_flac_matches_jax(tmp_path, kind, mode, ch):
    from tests.helpers_flacenc import write_flac
    raw = np.round(_tone(ch=ch) * 30000).astype(np.int64)
    if kind == "constant":
        raw[:] = 123
    p = str(tmp_path / "x.flac")
    write_flac(p, raw[0] if ch == 1 else raw, 16000, kind=kind,
               stereo_mode=mode)
    got, sr = pflac.read_flac(p)
    want, jsr = jflac.read_flac(p)
    assert sr == jsr == 16000
    _equal(got, want)
    _equal(pcodec.read_audio_codec(p)[0], want)
    assert pcache.AudioCache.probe_rate(p) == 16000


def test_ogg_vorbis_matches_jax(tmp_path):
    from tests.helpers_oggenc import vorbis_encoder_available, write_ogg
    if not (pcodec.vorbis_available() and vorbis_encoder_available()):
        pytest.skip("libvorbisfile or libvorbisenc not present")
    p = str(tmp_path / "tone.ogg")
    write_ogg(p, _tone(n=32000)[0], 16000)
    got, sr = pcodec.read_ogg_vorbis(p)
    want, jsr = jcodec.read_ogg_vorbis(p)
    assert sr == jsr == 16000 and got.shape[0] == 1
    _equal(got, want)
    _equal(pcache.AudioCache().load(p)[0], want)
    assert pcache.AudioCache.probe_rate(p) == 16000


def test_webm_opus_demux_matches_jax(tmp_path):
    from tests.test_codec import _mux_webm, _opus_encode
    if not pcodec.opus_available():
        pytest.skip("libopus absent")
    sr = 48000
    sig = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(sr) / sr)
           ).astype(np.float32)
    packets, preskip = _opus_encode(sig, sr)
    data = _mux_webm(packets, preskip, channels=1)
    path = tmp_path / "sine.webm"
    path.write_bytes(data)
    assert pcodec._demux_webm_opus(data) == jcodec._demux_webm_opus(data)
    got, rate = pcodec.read_webm_opus(str(path))
    want, jrate = jcodec.read_webm_opus(str(path))
    assert rate == jrate == sr
    _equal(got, want)
    _equal(pcache.AudioCache().load(str(path))[0], want)


def test_m4a_through_linked_ffmpeg_matches_jax(tmp_path):
    from audio_denoising_tpu.io import avdec as javdec
    if not (pavdec.av_available() and javdec.av_available()):
        pytest.skip("FFmpeg dev libraries not present")
    pcm = _tone(n=44100, sr=44100, ch=2)
    a, b = str(tmp_path / "port.m4a"), str(tmp_path / "jax.m4a")
    pavdec.encode_m4a(a, pcm, 44100)
    javdec.encode_m4a(b, pcm, 44100)
    got, sr = pavdec.read_audio_av(a)
    want, jsr = javdec.read_audio_av(a)
    assert sr == jsr == 44100 and got.shape[0] == 2
    _equal(got, want)
    _equal(pavdec.read_audio_av(b)[0], javdec.read_audio_av(b)[0])
    with pytest.raises(RuntimeError, match="av decode failed"):
        bad = tmp_path / "bad.m4a"
        bad.write_bytes(b"\x00" * 64)
        pavdec.read_audio_av(str(bad))


@pytest.mark.parametrize("name", ["x.mp3", "x.webm", "x.ogg", "x.flac",
                                  "x.m4a", "x.wma", "x.wav", "x.xyz"])
def test_codec_dispatch_matches_jax(name):
    assert pcodec.codec_available(name) == jcodec.codec_available(name)
    assert pcodec.mp3_available() == jcodec.mp3_available()
    assert pio.ffmpeg_available() == jio.ffmpeg_available()


def test_list_decodable_audio_matches_jax(tmp_path):
    from tests.helpers_flacenc import write_flac
    raw = np.round(_tone() * 30000).astype(np.int64)[0]
    write_flac(str(tmp_path / "a.flac"), raw, 16000)
    pio.write_wav(str(tmp_path / "b.wav"), _tone()[0], 16000)
    (tmp_path / "c.txt").write_text("not audio")
    assert (pcodec.list_decodable_audio(str(tmp_path))
            == jcodec.list_decodable_audio(str(tmp_path)))


# -- the cache and the stream helpers ------------------------------------------

def test_cache_load_and_load_at_match_jax(tmp_path, rng):
    x = (0.3 * rng.standard_normal((2, 48000))).astype(np.float32)
    p = str(tmp_path / "x.wav")
    pio.write_wav(p, x, 48000)
    pc, jc = pcache.AudioCache(seed=3), jcache.AudioCache(seed=3)
    for got, want in [(pc.load(p), jc.load(p)),
                      (pc.load_at(p, 16000), jc.load_at(p, 16000)),
                      (pc.load_at(p, 44100), jc.load_at(p, 44100))]:
        assert got[1] == want[1]
        _equal(got[0], want[0])
    assert len(pc) == len(jc)
    for _ in range(3):
        _equal(pc.random_crop(p, 1000)[0], jc.random_crop(p, 1000)[0])
    _equal(pc.random_crop_from([p], 70000, sample_rate=48000)[0],
           jc.random_crop_from([p], 70000, sample_rate=48000)[0])
    assert pc.probe_rate(p) == 48000


def test_stream_helpers_match_jax(tmp_path, rng):
    pieces = [(rng.standard_normal((2, n)).astype(np.float32), 16000)
              for n in (100, 333, 7, 900, 50)]
    for kw in ({}, {"skip_samples": 200}, {"limit_samples": 500}):
        got = list(pstream.buffer_stream(iter(pieces), 256, **kw))
        want = list(jstream.buffer_stream(iter(pieces), 256, **kw))
        assert len(got) == len(want) > 0
        for (a, sa), (b, sb) in zip(got, want):
            assert sa == sb
            _equal(a, b)
    got = list(pstream.limit_stream(iter(pieces), 440))
    want = list(jstream.limit_stream(iter(pieces), 440))
    assert [g[0].shape for g in got] == [w[0].shape for w in want]
    a = (rng.standard_normal((1, 500)) * 0.8).astype(np.float32)
    b = (rng.standard_normal((1, 500)) * 0.8).astype(np.float32)
    _equal(pstream.combine_audio((a, 8000), (b, 8000))[0],
           jstream.combine_audio((a, 8000), (b, 8000))[0])
    (pa, _), (pb, _) = pstream.clip_audio_to_same_size((a, 8000),
                                                       (b[:, :300], 8000))
    assert pa.shape == pb.shape == (1, 300)
    p = str(tmp_path / "s.wav")
    pio.write_wav(p, a[0], 8000)
    got = list(pstream.stream_audio(p, buffer_size=128, chunk=100))
    want = list(jstream.stream_audio(p, buffer_size=128, chunk=100))
    assert len(got) == len(want) == 3
    for (x, _), (y, _) in zip(got, want):
        _equal(x, y)


def test_playback_is_gated_as_in_jax():
    from audio_denoising_tpu.io import playback as jplayback
    assert pplayback.playback_available() == jplayback.playback_available()
    if not pplayback.playback_available():
        with pytest.raises(RuntimeError):
            pplayback.play_audio(np.zeros(10, np.float32), 16000)


# -- the WebSocket frame codec ---------------------------------------------------

def _masked(payload, opcode, mask=b"\x11\x22\x33\x44"):
    n = len(payload)
    head = bytes([0x80 | opcode])
    if n < 126:
        head += bytes([0x80 | n])
    elif n < (1 << 16):
        head += bytes([0x80 | 126]) + n.to_bytes(2, "big")
    else:
        head += bytes([0x80 | 127]) + n.to_bytes(8, "big")
    return head + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload))


@pytest.mark.parametrize("size", [0, 1, 125, 126, 65535, 65536])
def test_websocket_frames_match_jax(rng, size):
    """Server frames: the same bytes from both packages; masked client
    frames decode to the same payload through both."""
    payload = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    for mod in (pws, jws):
        a, b = socket.socketpair()
        try:
            mod.send_frame(a, payload)
            b.settimeout(5)
            got = b""
            want_len = len(payload) + 2 + (0 if size < 126 else
                                           2 if size < 65536 else 8)
            while len(got) < want_len:
                got += b.recv(1 << 20)
            if mod is pws:
                port_bytes = got
            else:
                assert got == port_bytes
            b.sendall(_masked(payload, pws.OP_BINARY))
            a.settimeout(5)
            fin, op, data = mod.recv_frame(a)
            assert fin and op == pws.OP_BINARY and data == payload
        finally:
            a.close()
            b.close()


def test_websocket_message_and_handshake_match_jax():
    """A fragmented message with a ping in between, and the upgrade
    handshake's reply, through both packages."""
    replies = []
    for mod in (pws, jws):
        a, b = socket.socketpair()
        try:
            a.settimeout(5)
            b.settimeout(5)
            b.sendall(b"GET /s HTTP/1.1\r\nUpgrade: websocket\r\n"
                      b"Connection: Upgrade\r\n"
                      b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                      b"Sec-WebSocket-Version: 13\r\n\r\nleft")
            path, leftover = mod.handshake(a)
            assert (path, leftover) == ("/s", b"left")
            replies.append(b.recv(4096))
            first = _masked(b"hel", pws.OP_TEXT)
            b.sendall(bytes([first[0] & 0x7F]) + first[1:])   # FIN off
            b.sendall(_masked(b"png", pws.OP_PING))
            b.sendall(_masked(b"lo", pws.OP_CONT))
            assert mod.recv_message(a) == (pws.OP_TEXT, b"hello")
            assert b.recv(64) == b"\x8a\x03png"                  # the pong
        finally:
            a.close()
            b.close()
    assert replies[0] == replies[1]
    assert b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" in replies[0]
    assert pws.MAX_FRAME_BYTES == jws.MAX_FRAME_BYTES
