"""MSC path (BASELINE configs 2-3): time deinterleave + subchannel decode +
DAB+ superframe (Firecode/RS) to AAC access units, bit-exact."""

import numpy as np
import pytest

from tpudab.constants.dab_params import get_dab_params, CIF_BITS
from tpudab.msc.interleave import interleave_np, deinterleave_np
from tpudab.msc.subchannel import SubchannelConfig, SubchannelDecoder, MSCDecoder
from tpudab.constants.puncture import eep_profile
from tpudab.database.entities import Subchannel
from tpudab.synth import (EnsembleSpec, ServiceSpec, SubchannelSpec,
                          EnsembleSynthesizer, ASCTY_DAB_PLUS)
from tpudab.audio.superframe import (SuperFrameHeader, build_superframe,
                                     parse_superframe, DABPlusChannel,
                                     FRAMES_PER_SUPERFRAME, header_size_bytes)
from tpudab.utils.bits import bits_to_soft


def test_interleave_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, (40, 64)).astype(np.float32)
    tx = interleave_np(x)
    rx = deinterleave_np(tx)
    # frames 0..40-16 are exactly recovered
    np.testing.assert_array_equal(rx[:25], x[:25])


def test_subchannel_decoder_streaming():
    """Synthesize one EEP subchannel's CIF slices, decode in streaming chunks."""
    rng = np.random.default_rng(1)
    size_cu, level, option = 24, 3, 0  # 32 kbps EEP 3-A
    profile = eep_profile(size_cu, level, option)
    n_frames = 40
    payloads = rng.integers(0, 256, (n_frames, profile.data_bits // 8)).astype(np.uint8)

    from tpudab.fec.conv import conv_encode
    from tpudab.fec.depuncture import puncture
    from tpudab.fec.prbs import descramble_bits
    from tpudab.utils.bits import unpack_bits
    coded = np.stack([
        puncture(conv_encode(descramble_bits(unpack_bits(p))), profile)
        for p in payloads])
    tx = interleave_np(coded.astype(np.float32))
    soft = bits_to_soft(tx) + rng.normal(0, 0.3, tx.shape).astype(np.float32)

    cfg = SubchannelConfig(subch_id=5, start_cu=0, size_cu=size_cu, profile=profile)
    dec = SubchannelDecoder(cfg)
    got, valids, idxs = [], [], []
    for chunk in np.split(soft, [8, 19, 40 - 7]):  # uneven chunks
        if chunk.shape[0] == 0:
            continue
        by, v, idx = dec.process(chunk)
        got.append(by)
        valids.append(v)
        idxs.append(idx)
    by = np.concatenate(got)
    v = np.concatenate(valids)
    idx = np.concatenate(idxs)
    complete = idx[v]
    assert complete[0] == 0 and complete[-1] == n_frames - 16
    np.testing.assert_array_equal(by[v], payloads[complete])


def test_superframe_roundtrip_with_errors():
    rng = np.random.default_rng(2)
    bitrate = 72
    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=1, aac_channel_mode=0,
                           ps_flag=1, mpeg_surround=0)
    assert hdr.num_aus == 3 and hdr.sampling_rate == 48000
    avail = 110 * bitrate // 8 - header_size_bytes(3) - 3 * 2
    sizes = [avail // 3, avail // 3, avail - 2 * (avail // 3)]
    aus = [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes]
    sf = build_superframe(hdr, aus, bitrate)
    assert sf.shape[0] == 120 * bitrate // 8

    res = parse_superframe(sf, bitrate)
    assert res.firecode_ok and res.rs_ok
    assert res.header == hdr
    assert all(res.au_crc_ok)
    assert [bytes(a) for a in res.access_units] == aus

    # up to t=5 byte errors per RS codeword are corrected
    corrupted = sf.copy()
    for cw in range(bitrate // 8):
        rows = rng.choice(120, 5, replace=False)
        corrupted[rows * (bitrate // 8) + cw] ^= 0xA5
    res2 = parse_superframe(corrupted, bitrate)
    assert res2.rs_ok and res2.firecode_ok
    assert [bytes(a) for a in res2.access_units] == aus
    assert res2.rs_corrected == 5 * bitrate // 8


def test_dabplus_channel_phase_sync():
    """Channel must lock onto superframe phase from an arbitrary start."""
    rng = np.random.default_rng(3)
    bitrate = 48
    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1,
                           ps_flag=0, mpeg_surround=0)
    n_sf = 6
    all_aus = []
    frames = []
    for _ in range(n_sf):
        avail = 110 * bitrate // 8 - header_size_bytes(6) - 6 * 2
        sizes = [avail // 6] * 5 + [avail - 5 * (avail // 6)]
        aus = [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes]
        all_aus.append(aus)
        sf = build_superframe(hdr, aus, bitrate)
        frames.append(sf.reshape(FRAMES_PER_SUPERFRAME, -1))
    stream = np.concatenate(frames)  # (30, frame_bytes)

    ch = DABPlusChannel(bitrate)
    results = ch.process_frames(stream[2:])  # start mid-superframe
    assert len(results) == n_sf - 1
    for res, aus in zip(results, all_aus[1:]):
        assert res.firecode_ok and res.rs_ok and all(res.au_crc_ok)
        assert [bytes(a) for a in res.access_units] == aus
    assert ch.stats["firecode_errors"] == 0
    assert ch.last_header == hdr


def test_msc_full_ensemble_to_access_units():
    """Config-2/3 shape: synthesized ensemble -> frame bits -> MSC decode ->
    superframes -> bit-exact AUs (channel layer, no OFDM)."""
    rng = np.random.default_rng(4)
    bitrate = 48  # EEP 3-A, 36 CU
    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1,
                           ps_flag=0, mpeg_surround=0)
    n_tx_frames = 10
    dab = get_dab_params(1)
    n_logical = n_tx_frames * dab.nb_cifs

    all_aus, superframes = [], []
    for _ in range(n_logical // FRAMES_PER_SUPERFRAME + 1):
        avail = 110 * bitrate // 8 - header_size_bytes(6) - 6 * 2
        sizes = [avail // 6] * 5 + [avail - 5 * (avail // 6)]
        aus = [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes]
        all_aus.append(aus)
        superframes.append(build_superframe(hdr, aus, bitrate))
    payload_stream = np.concatenate(superframes).reshape(-1, bitrate * 3)

    spec = EnsembleSpec(
        ensemble_id=0x1234, label="MSC Test",
        services=[ServiceSpec(0xC000, "Svc", [(0, ASCTY_DAB_PLUS, 3)])],
        subchannels=[SubchannelSpec(3, start_cu=100, size_cu=36,
                                    protection=("eep", 3, 0))])
    synth = EnsembleSynthesizer(spec, seed=9)
    synth.payload_fn[3] = lambda m: payload_stream[m].tobytes()

    frame_bits = np.stack([synth.frame_bits(i) for i in range(n_tx_frames)])
    soft = bits_to_soft(frame_bits) \
        + rng.normal(0, 0.35, frame_bits.shape).astype(np.float32)

    msc_soft = soft[:, dab.nb_fic_bits:]
    sub = Subchannel(subch_id=3, start_cu=100, size_cu=36, eep_level=3, eep_option=0)
    dec = MSCDecoder([SubchannelConfig.from_db(sub)], dab.nb_cifs, CIF_BITS)
    by, valid, idx = dec.process_frames(msc_soft)[3]
    complete = by[valid]
    np.testing.assert_array_equal(complete, payload_stream[idx[valid]])

    ch = DABPlusChannel(bitrate)
    results = ch.process_frames(complete)
    assert len(results) == (n_logical - 15) // FRAMES_PER_SUPERFRAME
    for res, aus in zip(results, all_aus):
        assert res.firecode_ok and res.rs_ok and all(res.au_crc_ok)
        assert [bytes(a) for a in res.access_units] == aus


def test_dabplus_pad_dynamic_label_and_slideshow():
    """PAD DSE inside DAB+ AUs: dynamic label + MOT slideshow decoded by the
    channel (reference parity: GetDynamicLabel / GetSlideshowManager)."""
    from tpudab.pad.xpad import (build_xpad_into_au,
                                 build_dynamic_label_segments,
                                 APP_DYNAMIC_LABEL_START, APP_MOT_START,
                                 APP_MOT_CONT)
    from tpudab.mot.mot import MOTObject, build_mot_object_groups, ContentType

    rng = np.random.default_rng(8)
    bitrate = 88
    hdr = SuperFrameHeader(dac_rate=1, sbr_flag=0, aac_channel_mode=1,
                           ps_flag=0, mpeg_surround=0)
    # PAD payload queue: dynamic label first, then an MOT slide
    label_segs = build_dynamic_label_segments("Test DAB dynamic label")
    from tpudab.mot.imagemeta import TINY_PNG
    img = TINY_PNG + rng.integers(0, 256, 300 - len(TINY_PNG)).astype(np.uint8).tobytes()
    obj = MOTObject(transport_id=5, content_type=ContentType.IMAGE,
                    content_subtype=3, body=img, content_name="s.png")
    mot_chunks = []
    for g in build_mot_object_groups(obj, segment_size=128):
        framed = bytes([(len(g) >> 8) & 0x3F, len(g) & 0xFF]) + g
        # mid-group X-PAD subfields must be exactly filled (only the final
        # subfield may be padded; the data-group length field trims it)
        parts = [framed[i:i + 48] for i in range(0, len(framed), 48)]
        mot_chunks.append(parts)

    pad_events = [[(APP_DYNAMIC_LABEL_START, s)] for s in label_segs]
    for parts in mot_chunks:
        pad_events.extend(
            [(APP_MOT_START if j == 0 else APP_MOT_CONT, p)]
            for j, p in enumerate(parts))

    n_sf = (len(pad_events) + 5) // 6 + 1
    ch = DABPlusChannel(bitrate)
    ev = iter(pad_events + [[(APP_DYNAMIC_LABEL_START, label_segs[0])]] * 100)
    avail = 110 * bitrate // 8 - header_size_bytes(6)
    for _ in range(n_sf):
        aus = [build_xpad_into_au(b"\x55" * 20, next(ev)) for _ in range(6)]
        # the last AU runs to the end of the audio super frame: pad its
        # payload so the AUs exactly fill the available space
        slack = avail - sum(len(a) + 2 for a in aus)
        assert slack >= 0
        aus[-1] = aus[-1] + b"\x00" * slack
        sf = build_superframe(hdr, aus, bitrate)
        ch.process_frames(sf.reshape(FRAMES_PER_SUPERFRAME, -1))
    assert ch.dynamic_label == "Test DAB dynamic label"
    assert len(ch.slideshow.slides) == 1
    assert ch.slideshow.slides[0].data == img


def test_deinterleave_batch_matches_gather_oracle():
    """Static-slice deinterleave == per-bit gather oracle, batched + plain."""
    import jax.numpy as jnp
    from tpudab.msc.interleave import deinterleave_batch, interleave_delays
    rng = np.random.default_rng(7)
    c, s = 12, 64 * 3
    buf = rng.normal(0, 1, (2, c + 15, s)).astype(np.float32)
    d = interleave_delays(s)
    rows = np.arange(c)[:, None] + d[None, :]
    cols = np.broadcast_to(np.arange(s)[None, :], rows.shape)
    want = buf[:, rows, cols]
    got = np.asarray(deinterleave_batch(jnp.asarray(buf), c))
    np.testing.assert_array_equal(got, want)
    got1 = np.asarray(deinterleave_batch(jnp.asarray(buf[0]), c))
    np.testing.assert_array_equal(got1, want[0])
