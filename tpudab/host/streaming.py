"""Live streaming radio: native IQ ring -> acquisition -> tracked frame
batches -> Receiver -> audio pipeline.

Reference parity: the running plugin pipeline (SDR thread -> OFDM ->
ring buffer -> radio thread -> audio threads, SURVEY.md sec 3.2-3.4). Here a
single host loop: blocking ring reads (native SPSC buffer), device demod in
frame batches, per-batch fine-frequency tracking (EMA, the reference's
fine_freq_update_beta analog), periodic timing re-check against the PRS
matched filter, and automatic reacquisition on FIB CRC blackout (the
reference's desync -> FINDING_NULL_POWER_DIP fallback).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np

from tpudab.constants.ofdm_params import get_ofdm_params, SAMPLING_RATE
from tpudab.ofdm.sync import SyncConfig
from tpudab.ofdm.sync_device import (acquire_host, coarse_freq_device,
                                     fine_freq_device, fine_time_sync_device)
from tpudab.host.profiling import StageTimer
from tpudab.ofdm.demod import demod_frames_split
from tpudab.models.receiver import Receiver
from tpudab.models.step_driver import StepDriver
from tpudab.audio.pipeline import AudioPipeline


@dataclasses.dataclass
class StreamingStats:
    state: str = "ACQUIRING"      # reference OFDM state-machine analog
    total_frames: int = 0
    total_frames_desync: int = 0
    reacquisitions: int = 0
    net_freq_hz: float = 0.0
    fine_freq_hz: float = 0.0
    coarse_freq_hz: float = 0.0
    timing_adjustments: int = 0
    coarse_adjustments: int = 0   # continuous coarse-CFO bin corrections
    signal_power: float = 0.0
    snr_db: float = 0.0
    const_re: Optional[np.ndarray] = None   # decimated DQPSK constellation
    const_im: Optional[np.ndarray] = None   # (GetFrameDataVec analog)


# Upper bound on old-channel samples hiding in the TCP socket buffers
# (server send + client recv) during a retune — auto-tuned Linux buffers
# reach several MB of u8 IQ (2 bytes/sample). 2M samples ~ 1 s at 2.048
# MS/s; see StreamingRadio._do_retune.
_TCP_INFLIGHT_SAMPLES = 2_000_000


def _default_device_step() -> bool:
    """The fused device step on any accelerator ("gpu"), the host per-stage
    path on the CPU; another platform is an error (tpudab.ops.viterbi_pallas
    .use_kernel is the one rule)."""
    from tpudab.ops.viterbi_pallas import use_kernel
    from tpudab.utils.runtime import platform
    return use_kernel(platform())


class StreamingRadio:
    """Pull IQ from a sample source callable and decode continuously.

    source(n) -> complex64 array of n samples (or fewer at end of stream).
    Works with tpudab.host.native_lib.RingBuffer.read_complex64 or any file
    wrapper.
    """

    def __init__(self, source: Callable[[int], np.ndarray], mode: int = 1,
                 batch_frames: int = 4, sync_cfg: SyncConfig = SyncConfig(),
                 receiver: Optional[Receiver] = None,
                 audio_pipeline: Optional[AudioPipeline] = None,
                 timing_check_interval: int = 1,
                 fib_error_ema_beta: float = 0.5,
                 desync_threshold: float = 0.35,
                 is_coarse_freq_correction: bool = True,
                 coarse_check_interval: int = 4,
                 drift_resample: bool = True,
                 use_device_step: Optional[bool] = None,
                 tuner=None, channel: Optional[str] = None,
                 retune_drain_s: float = 0.45):
        self.source = source
        self.mode = mode
        self.params = get_ofdm_params(mode)
        self.batch_frames = batch_frames
        self.sync_cfg = sync_cfg
        self.receiver = receiver or Receiver(mode)
        self.audio = audio_pipeline
        self.timing_check_interval = timing_check_interval
        self.fib_error_ema_beta = fib_error_ema_beta
        # live-tunable mirrors of the SyncConfig betas (the reference writes
        # OFDM_Demod::GetConfig() fields while running; KeyController and
        # ConfigManager adjust these, render_radio_block.cpp:213-235 analog)
        self.desync_threshold = desync_threshold
        self.fine_freq_beta = sync_cfg.fine_freq_beta
        self.is_coarse_freq_correction = is_coarse_freq_correction
        self.coarse_check_interval = coarse_check_interval
        self.timers = StageTimer()
        # fractional sample-clock drift compensation (VERDICT r2 item #6):
        # the tracked ppm rate retunes a polyphase resampler on the ring
        # read, so timing stays continuous instead of +/-32-sample jumps
        # (which remain as the coarse fallback / training signal)
        self.drift_resample = drift_resample
        self._drift_ppm = 0.0
        self._resampler = None
        # production decode path (VERDICT r3 item #1): once the FIC has
        # discovered the subchannel layout, the live loop runs the SAME
        # fused jitted ReceiveStep (demod + FIC + all-MSC decode on device,
        # Pallas Viterbi on the GPU) that bench.py measures. None = auto:
        # enabled on the GPU, host per-stage path on CPU (where the step's
        # XLA fallback compiles slowly and tests favor the host path);
        # force with True/False.
        if use_device_step is None:
            use_device_step = _default_device_step()
        self.use_device_step = use_device_step
        self._driver = StepDriver(mode, sync_cfg.window_offset)
        self.stats = StreamingStats()
        self._residual = np.zeros(0, dtype=np.complex64)
        self._decoders: Dict[int, object] = {}
        self._batches = 0
        self._fib_err_ema = 0.0
        self._stop_requested = False
        # live tuning (reference: VFO retune rebuilds the radio,
        # /root/reference/src/dab_module.cpp:139-150 + radio_block.cpp:57-82)
        self.tuner = tuner              # object with set_freq(hz), e.g.
        self.channel = channel          # rtl_tcp.TcpSource; Band III label
        self.retune_drain_s = retune_drain_s
        self._pending_retune: Optional[str] = None

    # ---------------- tuning ----------------

    def retune(self, channel: str) -> None:
        """Request a retune to a Band III channel label ('12C'); handled at
        the top of the next loop iteration (safe from any thread)."""
        self._pending_retune = channel

    def _do_retune(self, channel: str) -> None:
        """Reference reset_radio flow: command the tuner, drain in-flight
        samples of the old channel, reset receiver/DB/decoders/device-step
        state and audio sources, then reacquire."""
        from tpudab.constants.channels import channel_freq_hz
        if self.tuner is not None:
            self.tuner.set_freq(channel_freq_hz(channel))
        self.channel = channel
        # drain: every sample already in flight belongs to the old channel —
        # without a full flush, acquisition happily re-locks onto the old
        # ensemble. The old-channel backlog decomposes as
        #   ring fill (up to the ring's 2 s capacity when decode lags)
        # + TCP socket buffers (server send + client recv, invisible to
        #   ring.fill — measured >0.5 s on a loopback server)
        # + tuner command latency (real dongles keep streaming the old
        #   channel for tens to hundreds of ms after SET_FREQ — PLL settle
        #   + USB buffering; modeled by RtlTcpServer.tune_latency_s).
        # retune_drain_s (default 0.45 s) covers the 300 ms worst-case
        # latency with margin; _TCP_INFLIGHT_SAMPLES bounds the socket
        # term (tests/test_live_source.py::test_stream_retune_with_tuner_latency).
        drain = int(self.retune_drain_s * SAMPLING_RATE)
        ring = getattr(self.tuner, "ring", None)
        if ring is not None:
            drain += ring.fill // 8          # bytes -> complex64 samples
            drain += _TCP_INFLIGHT_SAMPLES
        # a LIVE source's ring can be transiently empty mid-drain (the
        # reader thread refills it as the dongle keeps streaming the old
        # channel) — breaking on the first empty read aborted the drain
        # after only the buffered fill and let the old ensemble relock
        # (caught by test_stream_retune_with_tuner_latency). Only a
        # sustained dry spell (~0.5 s with nothing arriving) means EOF.
        dry = 0
        while drain > 0 and dry < 100:
            c = self.source(min(drain, 1 << 16))
            if c is None or len(c) == 0:
                dry += 1
                time.sleep(0.005)
                continue
            dry = 0
            drain -= len(c)
        self._residual = np.zeros(0, dtype=np.complex64)
        self.receiver.reset()
        self._driver = StepDriver(self.mode, self.sync_cfg.window_offset)
        self._decoders.clear()
        if self.audio is not None:
            self.audio.clear_sources()
        self._fib_err_ema = 0.0
        # reset IN PLACE: the dashboard/controls hold a reference to this
        # stats object (Dashboard(radio.receiver, radio.stats, ...)) —
        # rebinding would freeze their view at the pre-retune values
        self.stats.__init__()

    # ---------------- internals ----------------

    def _read(self, n: int):
        """One source read, through the drift resampler when active."""
        if self._resampler is None:
            return self.source(n)
        c = self.source(max(int(n * self._resampler.ratio) + 32, 64))
        if c is None or len(c) == 0:
            return c
        return self._resampler.process(np.asarray(c, np.complex64))

    def _fill(self, n: int) -> np.ndarray:
        """Read until n samples available (or stream end)."""
        chunks = [self._residual]
        have = self._residual.shape[0]
        while have < n:
            c = self._read(n - have)
            if c is None or len(c) == 0:
                break
            c = np.asarray(c, dtype=np.complex64)
            chunks.append(c)
            have += c.shape[0]
        buf = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        self._residual = np.zeros(0, dtype=np.complex64)
        return buf

    def _acquire(self) -> bool:
        p = self.params
        self.stats.state = "ACQUIRING"
        buf = self._fill(3 * p.nb_frame_length)
        if buf.shape[0] < 2 * p.nb_frame_length:
            return False
        res = acquire_host(buf, self.mode, self.sync_cfg.max_coarse_bins,
                           self.sync_cfg.impulse_peak_threshold_db,
                           self.sync_cfg.impulse_peak_distance_probability)
        self.stats.net_freq_hz = res["net_freq_hz"]
        self.stats.coarse_freq_hz = res["coarse_hz"]
        self.stats.fine_freq_hz = res["fine_hz"]
        self._residual = buf[res["frame_start"]:]
        self.stats.state = "READING_SYMBOLS"
        return True

    def request_stop(self) -> None:
        """Ask the run loop to exit after the current batch (UI quit key)."""
        self._stop_requested = True

    def _timing_recheck(self, frames: np.ndarray) -> int:
        """PRS matched filter around the nominal position of the last frame;
        returns a small sample adjustment (clamped). Runs on device
        (tpudab.ofdm.sync_device, split-real)."""
        p = self.params
        search = 64
        frame = frames[-1]
        seg_start = p.nb_null_period + p.nb_cyclic_prefix - search
        seg_len = 2 * search + p.nb_fft
        seg = frame[seg_start : seg_start + seg_len]
        peak, q = fine_time_sync_device(
            np.ascontiguousarray(seg.real, np.float32)[None],
            np.ascontiguousarray(seg.imag, np.float32)[None],
            np.float32(self.stats.net_freq_hz), self.mode, search,
            self.sync_cfg.impulse_peak_threshold_db,
            self.sync_cfg.impulse_peak_distance_probability)
        off = int(np.asarray(peak)[0]) - search
        # clamp to half the search window: tracks sample-clock drift up to
        # ~|32| samples/batch (~200 ppm at the default 4-frame batch) while
        # rejecting outlier peaks; reacquisition covers anything larger
        return int(np.clip(off, -32, 32)) if float(np.asarray(q)[0]) > 3.0 else 0

    # ---------------- tracking ----------------

    def _track(self, frames: np.ndarray, nf: int, spacing: float) -> None:
        """Per-batch frequency/timing tracking while locked."""
        p, cfg = self.params, self.sync_cfg

        # fine-frequency tracking: estimate the small RESIDUAL after full
        # net correction (avoids +/-half-carrier wrap at the boundary),
        # EMA'd with the reference's fine_freq_update_beta analog. The
        # reference updates every frame; a batch covers nf frames, so the
        # per-frame beta compounds to beta**nf — without this a CFO ramp
        # lags nf-times further and desyncs (VERDICT r2 item #4).
        resid = float(np.asarray(fine_freq_device(
            np.ascontiguousarray(frames[-1].real, np.float32)[None],
            np.ascontiguousarray(frames[-1].imag, np.float32)[None],
            np.float32(self.stats.net_freq_hz), self.mode))[0])
        alpha = 1.0 - self.fine_freq_beta ** nf
        self.stats.fine_freq_hz += alpha * resid

        # continuous coarse correction: every N batches check the PRS body
        # for an integer-carrier residual; fold accumulated fine drift into
        # the coarse offset so a slow oscillator walk past +/- half a
        # carrier is tracked instead of forcing a reacquisition
        # (reference render_radio_block.cpp:215-223).
        if (self.is_coarse_freq_correction
                and self._batches % self.coarse_check_interval == 0):
            prs_lo = p.nb_null_period + p.nb_cyclic_prefix
            seg = frames[-1][prs_lo : prs_lo + p.nb_fft]
            bins, q = coarse_freq_device(
                np.ascontiguousarray(seg.real, np.float32)[None],
                np.ascontiguousarray(seg.imag, np.float32)[None],
                np.float32(self.stats.coarse_freq_hz + self.stats.fine_freq_hz),
                self.mode, cfg.max_coarse_bins)
            bins = int(np.asarray(bins)[0])
            if bins and float(np.asarray(q)[0]) > 3.0:
                self.stats.coarse_freq_hz += bins * spacing
                self.stats.coarse_adjustments += 1
            # bookkeeping: keep |fine| < half a carrier by moving whole
            # carriers into coarse (net unchanged)
            whole = round(self.stats.fine_freq_hz / spacing)
            if whole:
                self.stats.fine_freq_hz -= whole * spacing
                self.stats.coarse_freq_hz += whole * spacing
        self.stats.net_freq_hz = (self.stats.coarse_freq_hz
                                  + self.stats.fine_freq_hz)

        # timing drift check; each jump also trains the fractional
        # resampler's ppm estimate so jumps taper off once the rate matches
        if self._batches % self.timing_check_interval == 0:
            adj = self._timing_recheck(frames)
            if adj:
                self.stats.timing_adjustments += 1
                if adj > 0:
                    self._residual = self._residual[adj:]
                else:
                    pad = frames[-1][adj:]
                    self._residual = np.concatenate([pad, self._residual])
            if self.drift_resample:
                batches = max(self.timing_check_interval, 1)
                span = batches * nf * p.nb_frame_length
                # adj is the RESIDUAL drift after the current correction:
                # integrate with gain 0.5 (a damped servo on the ppm rate)
                self._drift_ppm += 0.5 * (adj / span * 1e6)
                if abs(self._drift_ppm) > 2.0:
                    from tpudab.utils.resample import PolyphaseResampler
                    ratio = 1.0 + self._drift_ppm * 1e-6
                    if self._resampler is None:
                        self._resampler = PolyphaseResampler(ratio)
                    else:
                        self._resampler.set_ratio(ratio)

    def _coarse_triage(self, frames: np.ndarray, spacing: float) -> bool:
        """Desync triage: before giving up and reacquiring, check whether the
        'blackout' is just an integer-carrier frequency slip (e.g. an
        oscillator step, or fine tracking losing a whole carrier — invisible
        to the CP autocorrelation, which only sees CFO mod one carrier).
        Applies the bin fix and returns True when confident; a genuine
        timing break leaves the PRS correlation flat (low quality) and
        returns False so the normal reacquisition path runs."""
        p = self.params
        prs_lo = p.nb_null_period + p.nb_cyclic_prefix
        seg = frames[-1][prs_lo : prs_lo + p.nb_fft]
        bins, q = coarse_freq_device(
            np.ascontiguousarray(seg.real, np.float32)[None],
            np.ascontiguousarray(seg.imag, np.float32)[None],
            np.float32(self.stats.net_freq_hz), self.mode,
            self.sync_cfg.max_coarse_bins)
        bins = int(np.asarray(bins)[0])
        if bins == 0 or float(np.asarray(q)[0]) <= 3.0:
            return False
        self.stats.coarse_freq_hz += bins * spacing
        self.stats.coarse_adjustments += 1
        self.stats.net_freq_hz = (self.stats.coarse_freq_hz
                                  + self.stats.fine_freq_hz)
        return True

    # ---------------- main loop ----------------

    def run(self, max_batches: Optional[int] = None,
            on_outputs: Optional[Callable] = None) -> None:
        p = self.params
        cfg = self.sync_cfg
        if not self._acquire():
            return
        fib_err_prev = 0
        spacing = SAMPLING_RATE / p.nb_fft
        while not self._stop_requested and (
                max_batches is None or self._batches < max_batches):
            if self._pending_retune is not None:
                ch = self._pending_retune
                self._pending_retune = None
                self._do_retune(ch)
                if not self._acquire():
                    break
                fib_err_prev = self.receiver.stats["fib_crc_errors"]
            need = self.batch_frames * p.nb_frame_length
            with self.timers.stage("read"):
                buf = self._fill(need)
            if buf.shape[0] < p.nb_frame_length:
                break
            nf = buf.shape[0] // p.nb_frame_length
            frames = buf[: nf * p.nb_frame_length].reshape(nf, p.nb_frame_length)
            self._residual = buf[nf * p.nb_frame_length:]

            tiled = (nf, p.nb_frame_length // 128, 128)
            re = np.ascontiguousarray(frames.real, dtype=np.float32).reshape(tiled)
            im = np.ascontiguousarray(frames.imag, dtype=np.float32).reshape(tiled)
            if self.use_device_step:
                self._driver.maybe_build(self.receiver,
                                         self.stats.total_frames)
            if self._driver.step is not None:
                # production path: ONE fused device program per batch
                # (demod + FIC Viterbi + all-MSC deinterleave/depuncture/
                # Viterbi to packed bytes; Pallas kernel on the GPU)
                with self.timers.stage("step", items=nf * p.nb_frame_length):
                    outputs, sstat = self._driver.process(
                        self.receiver, re, im, self.stats.net_freq_hz)
                mp = np.asarray(sstat["mean_power"]).reshape(-1)
                self.stats.signal_power = float(mp[-1])
                self.stats.const_re = np.asarray(sstat["const_re"])
                self.stats.const_im = np.asarray(sstat["const_im"])
            else:
                with self.timers.stage("demod", items=nf * p.nb_frame_length):
                    soft, stats = demod_frames_split(
                        re, im,
                        self.stats.net_freq_hz, self.mode, cfg.window_offset)
                    soft = np.asarray(soft)
                self.stats.signal_power = float(np.asarray(stats["mean_power"])[-1])
                self.stats.const_re = np.asarray(stats["const_re"])
                self.stats.const_im = np.asarray(stats["const_im"])
                with self.timers.stage("decode", items=nf):
                    outputs = self.receiver.process_frame_bits(soft)
            from tpudab.host.dashboard import constellation_snr_db
            self.stats.snr_db = constellation_snr_db(self.stats.const_re,
                                                     self.stats.const_im)
            self.stats.total_frames += nf
            self._batches += 1

            with self.timers.stage("track"):
                self._track(frames, nf, spacing)

            # desync detection -> reacquire. GRADED: an EMA of the per-batch
            # FIB CRC error rate crossing desync_threshold triggers resync —
            # a half-broken lock (timing off by a symbol, ~50% FIB errors)
            # resyncs within a couple of batches instead of decoding garbage
            # forever; a full blackout still reacts immediately. (Reference
            # analog: state-machine fallback to FINDING_NULL_POWER_DIP.)
            errs = self.receiver.stats["fib_crc_errors"] - fib_err_prev
            fib_err_prev = self.receiver.stats["fib_crc_errors"]
            batch_rate = errs / max(nf * self.receiver.dab.nb_fibs, 1)
            b = self.fib_error_ema_beta
            self._fib_err_ema = b * self._fib_err_ema + (1 - b) * batch_rate
            if batch_rate >= 1.0 or self._fib_err_ema > self.desync_threshold:
                if (self.is_coarse_freq_correction
                        and self._coarse_triage(frames, spacing)):
                    # integer-carrier slip repaired in place; give the loop a
                    # clean slate instead of a full (audio-gap) reacquisition
                    self._fib_err_ema = 0.0
                else:
                    self.stats.total_frames_desync += nf
                    self.stats.reacquisitions += 1
                    self._fib_err_ema = 0.0
                    if not self._acquire():
                        break
                    fib_err_prev = self.receiver.stats["fib_crc_errors"]

            # audio fan-out
            if self.audio is not None:
                with self.timers.stage("audio"):
                    self._render_audio(outputs)
            if on_outputs is not None:
                on_outputs(outputs)
        # end-of-stream: emit frames still held by a pending UEP calibration
        final = self.receiver.finalize()
        if final:
            if self.audio is not None:
                self._render_audio(final)
            if on_outputs is not None:
                on_outputs(final)
        self.stats.state = "STOPPED"

    def _render_audio(self, outputs) -> None:
        from tpudab.audio.codecs import (AACDecoder, MP2Decoder,
                                         aac_decode_available,
                                         mp2_decode_available)
        for subch_id, out in outputs.items():
            ch = self.receiver.channels.get(subch_id)
            if ch is not None and not getattr(ch, "is_play_audio", True):
                continue  # per-channel play toggle (Basic_Audio_Channel)
            src = self.audio.add_source(subch_id)
            dec = self._decoders.get(subch_id)
            if out.is_dab_plus:
                for sf in out.superframes:
                    if sf.header is None:
                        continue
                    if dec is None and aac_decode_available():
                        dec = self._decoders[subch_id] = AACDecoder(sf.header)
                    if dec is None:
                        continue
                    for au, ok in zip(sf.access_units, sf.au_crc_ok):
                        if not ok:
                            continue
                        try:
                            pcm = dec.decode(bytes(au))
                        except ValueError:
                            continue
                        if pcm.shape[0]:
                            src.write(pcm, dec.sample_rate
                                      or sf.header.sampling_rate)
            else:
                if dec is None and mp2_decode_available():
                    dec = self._decoders[subch_id] = MP2Decoder()
                if dec is None:
                    continue
                for fr in out.mp2_frames:
                    try:
                        pcm = dec.decode(fr)
                    except ValueError:
                        continue
                    if pcm.shape[0]:
                        src.write(pcm, dec.sample_rate or 48000)
