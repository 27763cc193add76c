"""FIC end-to-end (BASELINE config 1): synthesized ensemble IQ -> acquisition
-> OFDM demod -> FIC Viterbi -> FIB CRC -> FIG parse -> service database."""

import numpy as np
import pytest

from tpudab.synth import (
    EnsembleSpec, ServiceSpec, SubchannelSpec, EnsembleSynthesizer,
    ASCTY_DAB, ASCTY_DAB_PLUS,
)
from tpudab.synth.modulator import Impairments, apply_impairments
from tpudab.ofdm.sync import acquire
from tpudab.ofdm.demod import demod_frames
from tpudab.fic.fib import decode_fic_frame
from tpudab.fic.fig_parser import parse_fib
from tpudab.database.updater import DatabaseUpdater


def make_spec():
    return EnsembleSpec(
        ensemble_id=0xCE15,
        label="Test DAB Mux",
        ecc=0xE1,
        services=[
            ServiceSpec(0xC221, "Radio Alpha", [(0, ASCTY_DAB_PLUS, 1)],
                        programme_type=10, language=0x09),
            ServiceSpec(0xC222, "Radio Beta", [(0, ASCTY_DAB, 2)],
                        programme_type=1, language=0x08),
        ],
        subchannels=[
            SubchannelSpec(1, start_cu=0, size_cu=54, protection=("eep", 3, 0)),   # 72 kbps DAB+
            SubchannelSpec(2, start_cu=54, size_cu=96, protection=("uep", 128, 3)),  # 128 kbps MP2
        ],
    )


@pytest.fixture(scope="module")
def synth_frames():
    synth = EnsembleSynthesizer(make_spec(), seed=7)
    bits = [synth.frame_bits(i) for i in range(2)]
    return synth, bits


def test_fic_bits_direct_decode(synth_frames):
    """Frame bits -> soft -> FIC decode without the OFDM channel."""
    synth, frames = synth_frames
    soft = (1.0 - 2.0 * frames[0][:9216].astype(np.float32))
    fibs, ok = decode_fic_frame(soft)
    assert fibs.shape == (12, 32)
    assert ok.all()


def test_full_chain_to_database(synth_frames):
    synth, frames = synth_frames
    from tpudab.synth.modulator import modulate_frame_bits
    iq = np.concatenate([modulate_frame_bits(b) for b in frames])
    iq = apply_impairments(iq, Impairments(freq_offset_hz=-12_345.0,
                                           delay_samples=400, snr_db=14, seed=3))
    res = acquire(iq)
    assert res["frame_start"] == 400
    aligned = iq[res["frame_start"]:]
    f = aligned[: 196608].reshape(1, -1)
    soft, _ = demod_frames(f, res["net_freq_hz"])
    soft = np.asarray(soft)
    fibs, ok = decode_fic_frame(soft[:, :9216])
    assert ok.all(), "all FIB CRCs must pass at 14 dB SNR"

    upd = DatabaseUpdater()
    for fib in fibs:
        upd.process_events(parse_fib(fib))
    db = upd.db
    assert db.ensemble.label == "Test DAB Mux"
    assert db.ensemble.ensemble_id == 0xCE15
    assert db.ensemble.ecc == 0xE1
    assert db.services[0xC221].label == "Radio Alpha"
    assert db.services[0xC222].label == "Radio Beta"
    assert db.services[0xC221].programme_type == 10
    assert db.subchannels[1].size_cu == 54
    assert db.subchannels[1].protection_label == "EEP 3-A"
    assert db.subchannels[1].bitrate_kbps == 72
    assert db.subchannels[2].is_uep
    assert db.subchannels[2].start_cu == 54
    comps = db.components_of(0xC221)
    assert len(comps) == 1 and comps[0].is_dab_plus
    comps2 = db.components_of(0xC222)
    assert comps2[0].is_dab_plus is False
    assert upd.stats.total >= 7
    assert upd.stats.completed >= 7


def test_fm_drm_linkage_to_database():
    """FIG 0/6 service linkage + FIG 0/21 frequency info -> FM/DRM services
    (reference parity: linked-FM/DRM tables with frequencies,
    render_radio_block.cpp:490-752)."""
    from tpudab.synth.ensemble import FMLinkSpec, DRMLinkSpec
    spec = make_spec()
    spec.fm_links = [FMLinkSpec(service_id=0xC221, rds_pi=0xC479,
                                frequencies_hz=[95_800_000, 102_200_000])]
    spec.drm_links = [DRMLinkSpec(service_id=0xC222, drm_id=0x00A7,
                                  frequencies_hz=[6_095_000])]
    synth = EnsembleSynthesizer(spec, seed=8)
    bits = synth.frame_bits(0)
    soft = (1.0 - 2.0 * bits[:9216].astype(np.float32))
    fibs, ok = decode_fic_frame(soft)
    assert ok.all()
    upd = DatabaseUpdater()
    for fib in fibs:
        upd.process_events(parse_fib(fib))
    db = upd.db
    assert 0xC479 in db.fm_services
    assert db.fm_services[0xC479].frequencies == [95_800_000, 102_200_000]
    assert 0x00A7 in db.drm_services
    assert db.drm_services[0x00A7].frequencies == [6_095_000]
    assert 1 in db.link_services and 2 in db.link_services
    assert db.link_services[1].active
