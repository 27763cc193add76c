"""OFDM numerology for DAB transmission modes I-IV (ETSI EN 300 401 Table 38).

Reference parity: vendor/DAB-Radio `ofdm/dab_ofdm_params_ref.h` /
`get_DAB_OFDM_params(mode)` (proven API at /root/reference/src/radio_block.cpp:4,12);
field names follow the reference's `OFDM_Params` surface (`nb_fft`,
`nb_data_carriers`, ... — /root/reference/src/radio_block.cpp:18-20) so a user
of the reference finds the same numerology here, but the implementation is an
independent derivation from the standard.

All sample counts are at the DAB system rate of 2.048 MS/s (T = 1/2.048e6 s).
"""

from __future__ import annotations

import dataclasses

SAMPLING_RATE = 2_048_000  # complex samples per second (elementary period T)


@dataclasses.dataclass(frozen=True)
class OFDMParams:
    """Mode-dependent OFDM constants (EN 300 401 Table 38)."""

    mode: int
    nb_fft: int                 # FFT size (Tu in samples)
    nb_data_carriers: int       # K: active carriers
    nb_cyclic_prefix: int       # guard interval (delta in samples)
    nb_null_period: int         # null symbol length (Tnull in samples)
    nb_symbols: int             # OFDM symbols per frame excluding null (incl. PRS)
    nb_frame_length: int        # total samples per transmission frame

    @property
    def nb_symbol_period(self) -> int:
        """Ts = Tu + guard, samples per non-null symbol."""
        return self.nb_fft + self.nb_cyclic_prefix

    @property
    def nb_data_symbols(self) -> int:
        """Differentially-demodulated symbols per frame (all but the PRS)."""
        return self.nb_symbols - 1

    @property
    def nb_bits_per_symbol(self) -> int:
        """QPSK soft bits produced per data symbol."""
        return 2 * self.nb_data_carriers

    @property
    def nb_frame_bits(self) -> int:
        """Soft bits per transmission frame (FIC + MSC)."""
        return self.nb_data_symbols * self.nb_bits_per_symbol

    def __post_init__(self):
        total = self.nb_null_period + self.nb_symbols * self.nb_symbol_period
        if total != self.nb_frame_length:
            raise ValueError(
                f"mode {self.mode}: inconsistent frame length {total} != {self.nb_frame_length}"
            )


_PARAMS = {
    # mode: (nb_fft, K, guard, null, symbols, frame)
    1: OFDMParams(1, 2048, 1536, 504, 2656, 76, 196_608),  # 96 ms
    2: OFDMParams(2, 512, 384, 126, 664, 76, 49_152),      # 24 ms
    3: OFDMParams(3, 256, 192, 63, 345, 153, 49_152),      # 24 ms
    4: OFDMParams(4, 1024, 768, 252, 1328, 76, 98_304),    # 48 ms
}


def get_ofdm_params(mode: int) -> OFDMParams:
    """Analog of the reference's ``get_DAB_OFDM_params`` table."""
    if mode not in _PARAMS:
        raise ValueError(f"unknown DAB transmission mode {mode!r} (valid: 1..4)")
    return _PARAMS[mode]
