"""Audio codec tests: round-trips, cross-container, streaming reads, and the
feature-file layout (AIFC fl32) the reference toolchain depends on."""

import struct

import numpy as np
import pytest

from strugatzki_tpu.io import audiofile as af
from strugatzki_tpu.io.formats import (AIFF, IRCAM, NEXT, WAVE, WAVE64,
                                        SampleFormat)


def _sig(channels=3, frames=1000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, size=(channels, frames)).astype(np.float32)


@pytest.mark.parametrize("file_type,fmt,tol", [
    (AIFF, SampleFormat.FLOAT, 0),
    (AIFF, SampleFormat.INT16, 1 / 32768),
    (AIFF, SampleFormat.INT24, 1 / 8388608),
    (WAVE, SampleFormat.FLOAT, 0),
    (WAVE, SampleFormat.INT16, 1 / 32768),
    (WAVE, SampleFormat.INT24, 1 / 8388608),
    (WAVE, SampleFormat.INT32, 1 / 2147483648),
    (IRCAM, SampleFormat.FLOAT, 0),
    (NEXT, SampleFormat.FLOAT, 0),
    (NEXT, SampleFormat.INT16, 1 / 32768),
])
def test_roundtrip(tmp_path, file_type, fmt, tol):
    data = _sig()
    path = tmp_path / f"t.{file_type.extension}"
    spec = af.AudioFileSpec(file_type, fmt, 3, 48000.0)
    af.write(path, data, spec)
    back, spec2 = af.read(path)
    assert spec2.num_channels == 3
    assert spec2.num_frames == 1000
    assert abs(spec2.sample_rate - 48000.0) < 1e-6
    assert back.shape == data.shape
    np.testing.assert_allclose(back, data, atol=tol or 1e-7)


def test_feature_file_is_aifc_fl32(tmp_path):
    """Feature files must be AIFC with fl32 compression and f80 sample rate
    (reference NonRealtimeProcessor.scala:164)."""
    data = _sig(channels=14, frames=256)
    rate = 44100.0 / 512
    path = tmp_path / "x_feat.aif"
    af.write(path, data, af.feature_spec(14, rate))
    raw = path.read_bytes()
    assert raw[:4] == b"FORM"
    assert raw[8:12] == b"AIFC"
    assert b"FVER" in raw[:64]
    assert b"fl32" in raw[:128]
    back, spec = af.read(path)
    assert spec.num_channels == 14
    assert abs(spec.sample_rate - rate) < 1e-9  # f80 is exact for this value
    np.testing.assert_array_equal(back, data)


def test_fractional_sample_rate_exact(tmp_path):
    """featRate = 44100/512 = 86.1328125 must round-trip exactly through the
    80-bit extended float (it is a dyadic rational)."""
    rate = 44100.0 / 512
    enc = af._encode_f80(rate)
    assert af._decode_f80(enc) == rate


def test_streaming_seek_read(tmp_path):
    data = _sig(channels=2, frames=5000, seed=1)
    path = tmp_path / "s.aif"
    af.write(path, data, af.AudioFileSpec(AIFF, SampleFormat.FLOAT, 2, 44100.0))
    with af.open_read(path) as r:
        r.seek(1234)
        chunk = r.read_frames(100)
        np.testing.assert_array_equal(chunk, data[:, 1234:1334])
        # read past EOF truncates
        r.seek(4990)
        tail = r.read_frames(100)
        assert tail.shape == (2, 10)


def test_identify(tmp_path):
    data = _sig(1, 10)
    p1 = tmp_path / "a.aif"
    af.write(p1, data, af.AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0))
    assert af.identify(p1) == AIFF
    p2 = tmp_path / "b.wav"
    af.write(p2, data, af.AudioFileSpec(WAVE, SampleFormat.FLOAT, 1, 44100.0))
    assert af.identify(p2) == WAVE
    p3 = tmp_path / "junk.bin"
    p3.write_bytes(b"garbagegarbage")
    assert af.identify(p3) is None


def test_norm_file_shape(tmp_path):
    """feat_norms.aif: numFeatures channels x 2 frames, 44.1k
    (reference Strugatzki.scala:417-429)."""
    norms = np.stack([np.linspace(0, 1, 14), np.linspace(1, 2, 14)], axis=1)
    path = tmp_path / "feat_norms.aif"
    af.write(path, norms.astype(np.float32),
             af.AudioFileSpec(AIFF, SampleFormat.FLOAT, 14, 44100.0))
    back, spec = af.read(path)
    assert spec.num_channels == 14 and spec.num_frames == 2
    np.testing.assert_array_equal(back, norms.astype(np.float32))


def test_wav_extensible_and_double(tmp_path):
    # hand-craft a WAVE_FORMAT_EXTENSIBLE float file header
    data = _sig(1, 64, seed=2)
    payload = data.T.astype("<f4").tobytes()
    ext = struct.pack("<HHIIHH", 0xFFFE, 1, 44100, 44100 * 4, 4, 32)
    # cbSize=22, validBits=32, channelMask=0, subformat GUID starting with tag 3
    ext += struct.pack("<HHIH", 22, 32, 0, 3) + b"\x00" * 14
    body = struct.pack("<4sI", b"fmt ", len(ext)) + ext
    body += struct.pack("<4sI", b"data", len(payload)) + payload
    raw = struct.pack("<4sI4s", b"RIFF", 4 + len(body), b"WAVE") + body
    p = tmp_path / "ext.wav"
    p.write_bytes(raw)
    back, spec = af.read(p)
    np.testing.assert_allclose(back, data, atol=1e-7)


def test_corrupt_files_raise_ioerror(tmp_path):
    """Truncated/mutated headers must surface as IOError, never raw
    struct errors or hangs."""
    import io
    data = _sig(2, 200)
    good = tmp_path / "good.aif"
    af.write(good, data, af.AudioFileSpec(AIFF, SampleFormat.FLOAT, 2, 44100.0))
    raw = bytearray(good.read_bytes())

    rng = np.random.default_rng(0)
    for trial in range(40):
        bad = bytearray(raw)
        mode = trial % 3
        if mode == 0:       # truncate inside the header
            bad = bad[: rng.integers(4, 60)]
        elif mode == 1:     # flip random header bytes
            for _ in range(4):
                bad[int(rng.integers(0, min(64, len(bad))))] = int(rng.integers(256))
        else:               # corrupt a chunk size
            bad[4:8] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        p = tmp_path / "bad.aif"
        p.write_bytes(bytes(bad))
        try:
            af.read(p)
        except (IOError, ValueError):
            pass   # acceptable failure modes


def test_wave64_roundtrip(tmp_path):
    """The framework must read back its own Wave64 cross-similarity output
    (the reference's synth.io does)."""
    from strugatzki_tpu.io.formats import WAVE64
    data = _sig(1, 777, seed=3)
    p = tmp_path / "x.w64"
    af.write(p, data, af.AudioFileSpec(WAVE64, SampleFormat.FLOAT, 1, 44100.0))
    back, spec = af.read(p)
    assert spec.file_type.id == "w64"
    assert spec.num_frames == 777
    np.testing.assert_array_equal(back, data)
    # int16 variant too
    af.write(p, data, af.AudioFileSpec(WAVE64, SampleFormat.INT16, 1, 48000.0))
    back, spec = af.read(p)
    assert spec.sample_rate == 48000.0
    np.testing.assert_allclose(back, data, atol=1 / 32768)


def test_wave64_zero_size_chunk_raises(tmp_path):
    """A Wave64 chunk declaring size < 24 (size includes its own 24-byte
    header) must raise, not seek backwards and spin forever (advisor
    finding, round 2)."""
    from strugatzki_tpu.io.formats import WAVE64
    data = _sig(1, 64, seed=5)
    p = tmp_path / "x.w64"
    af.write(p, data, af.AudioFileSpec(WAVE64, SampleFormat.FLOAT, 1, 44100.0))
    raw = bytearray(p.read_bytes())
    # first chunk header starts after the 16-byte riff GUID + 8-byte total
    # + 16-byte wave GUID = offset 40; its size field is at +16
    raw[40 + 16:40 + 24] = (0).to_bytes(8, "little")
    p.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        af.read_spec(p)


def test_ircam_int32_roundtrip(tmp_path):
    data = _sig(2, 300, seed=4)
    p = tmp_path / "x.irc"
    af.write(p, data, af.AudioFileSpec(IRCAM, SampleFormat.INT32, 2, 44100.0))
    back, spec = af.read(p)
    assert spec.sample_format == SampleFormat.INT32
    np.testing.assert_allclose(back, data, atol=1 / 2147483648)


def test_zero_channel_header_raises_ioerror(tmp_path):
    """num_channels = 0 in a WAV header must surface as IOError, not
    ZeroDivisionError."""
    data = _sig(1, 64)
    p = tmp_path / "z.wav"
    af.write(p, data, af.AudioFileSpec(WAVE, SampleFormat.INT16, 1, 44100.0))
    raw = bytearray(p.read_bytes())
    fmt_at = raw.index(b"fmt ") + 8
    raw[fmt_at + 2:fmt_at + 4] = b"\x00\x00"  # channels field
    p.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        af.read(p)


def test_unusual_bit_depth_raises_ioerror(tmp_path):
    """A 12-bit WAV must be a clear IOError, not a KeyError."""
    data = _sig(1, 64)
    p = tmp_path / "b.wav"
    af.write(p, data, af.AudioFileSpec(WAVE, SampleFormat.INT16, 1, 44100.0))
    raw = bytearray(p.read_bytes())
    fmt_at = raw.index(b"fmt ") + 8
    raw[fmt_at + 14:fmt_at + 16] = struct.pack("<H", 12)
    p.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        af.read(p)


def test_read_zero_frame_header(tmp_path):
    """A header claiming 0 frames reads to EOF (AudioFileWriter crash-
    before-close leaves such AIFCs); regression for the 1<<62 overflow."""
    data = _sig(2, 150, seed=5)
    p = tmp_path / "z.aif"
    af.write(p, data, af.AudioFileSpec(AIFF, SampleFormat.FLOAT, 2, 44100.0))
    raw = bytearray(p.read_bytes())
    comm_at = raw.index(b"COMM") + 8
    raw[comm_at + 2:comm_at + 6] = b"\x00\x00\x00\x00"  # numFrames field
    p.write_bytes(bytes(raw))
    back, spec = af.read(p)
    assert back.shape == (2, 150)
    np.testing.assert_array_equal(back, data)


def test_aifc_sowt_little_endian_pcm(tmp_path):
    """CoreAudio's default AIFF-C int16 compression 'sowt' is byte-swapped
    (little-endian) PCM — must decode with swapped bytes."""
    import struct
    data = np.array([[0.125, -0.5, 0.25, 0.0078125]], np.float32)
    p = tmp_path / "sowt.aif"
    af.write(p, data, af.AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0))
    raw = bytearray(p.read_bytes())
    comm = raw.find(b"COMM")
    assert comm > 0
    # rewrite as AIFC with a sowt COMM and byte-swapped samples
    body = raw[comm + 8:comm + 8 + 18] + b"sowt" + b"\x05sowt\x00"
    new_comm = b"COMM" + struct.pack(">I", len(body)) + body
    ssnd = raw.find(b"SSND")
    (ssnd_size,) = struct.unpack(">I", raw[ssnd + 4:ssnd + 8])
    samples = bytes(raw[ssnd + 16:ssnd + 8 + ssnd_size])
    swapped = np.frombuffer(samples, ">i2").astype("<i2").tobytes()
    out = (raw[:8] + b"AIFC" + new_comm
           + b"SSND" + struct.pack(">I", 8 + len(swapped)) + b"\x00" * 8
           + swapped)
    out = bytearray(out)
    out[4:8] = struct.pack(">I", len(out) - 8)
    p2 = tmp_path / "sowt2.aif"
    p2.write_bytes(bytes(out))
    got, spec = af.read(p2)
    assert spec.sample_format == SampleFormat.INT16
    np.testing.assert_allclose(got, data, atol=1 / 32768)


def test_incremental_writer_pads_odd_payload(tmp_path):
    """int24 mono with an odd frame count: the incremental writer must pad
    the data chunk to even alignment like the one-shot write()."""
    data = np.array([[0.1, -0.2, 0.3]], np.float32)   # 9 payload bytes
    for ft in (AIFF, WAVE):
        p = tmp_path / f"odd_{ft.id}.x"
        with af.open_write(p, af.AudioFileSpec(ft, SampleFormat.INT24,
                                               1, 44100.0)) as w:
            w.write_frames(data)
        raw = p.read_bytes()
        assert len(raw) % 2 == 0
        # container size fields must cover the pad byte
        import struct
        if ft is AIFF:
            (form,) = struct.unpack(">I", raw[4:8])
            assert form == len(raw) - 8
        else:
            (riff,) = struct.unpack("<I", raw[4:8])
            assert riff == len(raw) - 8
        got, spec = af.read(p)
        assert spec.num_frames == 3
        np.testing.assert_allclose(got, data, atol=1 / 8388608)


def test_identify_wave64(tmp_path):
    data = np.zeros((1, 64), np.float32)
    p = tmp_path / "x.w64"
    af.write(p, data, af.AudioFileSpec(WAVE64, SampleFormat.INT16,
                                       1, 44100.0))
    assert af.identify(p) is WAVE64
