"""Link configuration: the port's own copy of ``mimo_ofdm_tpu/utils/config.py``.

Every dataclass keeps the JAX package's field names and defaults, so a
configuration moves between the two packages as a plain dictionary
(:func:`config_from_dict` on ``dataclasses.asdict`` of the JAX config).
Configs are frozen, hence hashable.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModemConfig:
    """OFDM-QAM modem parameters (``reference/modulation.py:296-319``)."""
    constel_size: int = 64
    n_fft: int = 4096
    n_sub_carr: int = 2048
    cp_len: int = 128
    n_users: int = 1

    @property
    def bits_per_symbol(self) -> int:
        return int(math.log2(self.constel_size))

    @property
    def n_bits_per_ofdm_sym(self) -> int:
        """``log2(M) * n_sub_carr`` (``reference/modulation.py:316``)."""
        return self.bits_per_symbol * self.n_sub_carr

    @property
    def avg_symbol_power(self) -> float:
        from mimo_ofdm_tpu_torch.ops.qam import avg_symbol_power
        return avg_symbol_power(self.constel_size)

    @property
    def avg_sample_power(self) -> float:
        """``avg_symbol_power * n_sc / n_fft`` (``reference/modulation.py:418-424``)."""
        return self.avg_symbol_power * self.n_sub_carr / self.n_fft


@dataclass(frozen=True)
class PaConfig:
    """Nonlinear PA model (``reference/distortion.py``)."""
    model: str = "softlim"  # softlim | rapp | toi | none
    ibo_db: float = 0.0     # for toi this is the TOI value in dB
    rapp_p_hardness: float = 1.1
    # alpha for models without a closed form (TOI)
    alpha_estimate: float = 1.0


@dataclass(frozen=True)
class ArrayConfig:
    """Antenna array geometry (``reference/antenna_array.py:415-520``)."""
    geometry: str = "linear"      # linear | circular | planar
    n_elements: int = 64
    wav_len_spacing: float = 0.5
    n_rows: int = 1               # planar only
    n_cols: int = 1               # planar only
    cord_x: float = 0.0
    cord_y: float = 0.0
    cord_z: float = 15.0


@dataclass(frozen=True)
class ChannelConfig:
    """MISO channel model selection (``reference/channel.py``); every model
    runs on the port."""
    model: str = "los"  # los | two_path | rayleigh | rician | random_paths | tdl_3gpp | gscm
    skip_attenuation: bool = False
    n_paths: int = 10             # random_paths
    max_delay_spread: float = 1000e-9
    tdl_profile: str = "uma_los"
    tdl_subpaths: int = 20
    tdl_asd_deg: float = 5.0
    tdl_k_db: float | None = None
    tdl_k_std_db: float = 0.0
    tdl_ds_log10_std: float = 0.0
    rician_k_db: float = 9.0
    gscm_scenario: str = "uma_los"
    gscm_element_pattern: bool = True


@dataclass(frozen=True)
class RxConfig:
    """Receiver geometry and algorithm
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:64-68``)."""
    cord_x: float = 212.0
    cord_y: float = 212.0
    cord_z: float = 1.5
    loc_var: float = 10.0         # reroll variance [m] (reference/mp_model.py:140-148)
    algorithm: str = "cnc"        # cnc | mcnc | cnc_mu | mcnc_mu | none
    max_cnc_iters: int = 8


@dataclass(frozen=True)
class LinkConfig:
    """Full link configuration."""
    modem: ModemConfig = field(default_factory=ModemConfig)
    pa: PaConfig = field(default_factory=PaConfig)
    array: ArrayConfig = field(default_factory=ArrayConfig)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    rx: RxConfig = field(default_factory=RxConfig)
    center_freq: float = 3.5e9
    carrier_spacing: float = 15e3
    precoding: str = "mrt"        # mrt | phase | zf | none
    csi_epsilon: float = 0.0      # CSI error (reference/mp_model.py:264-284)
    csi_snr_db: float | None = None
    # Run the IFFT->PA->FFT core as the fused chain (here: the CUDA kernel
    # of kernels/fused_pa.py); the JAX package's name is kept.
    use_mxu_fft: bool = True
    # Plane storage of the fused chain's input and output: "float32" or
    # "bfloat16" (the kernel computes in float32 either way).
    mxu_fft_storage: str = "bfloat16"
    # Channel-block storage: "bfloat16" / "float32" planes (the planar
    # path, models/link_planar.py) or "complex64" (the complex64 branch of
    # models/link.py, which also takes every config the planes do not).
    # Sharding (parallel/sharded.py): an antenna-sharded (tp) run takes the
    # complex64 branch, as in the JAX package, but it draws the same
    # channels as a single-device run of the same config and key: every
    # rank draws the round's global FrameDraws and keeps its antennas'
    # rows of them. The JAX package's tp runs draw other fades per shard
    # (mimo_ofdm_tpu/utils/config.py:154-161); the port has no such limit.
    channel_storage: str = "bfloat16"

    _MXU_STORAGE_VALUES = ("float32", "bfloat16")
    _CHANNEL_STORAGE_VALUES = ("complex64", "float32", "bfloat16")

    def __post_init__(self):
        if self.mxu_fft_storage not in self._MXU_STORAGE_VALUES:
            raise ValueError(
                f"mxu_fft_storage={self.mxu_fft_storage!r} not in "
                f"{self._MXU_STORAGE_VALUES}")
        if self.channel_storage not in self._CHANNEL_STORAGE_VALUES:
            raise ValueError(
                f"channel_storage={self.channel_storage!r} not in "
                f"{self._CHANNEL_STORAGE_VALUES}")

    def replace(self, **kw) -> "LinkConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SweepConfig:
    """Monte-Carlo stop criteria + Eb/N0 sweep grid
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:44-58``)."""
    ebn0_min: float = 5.0
    ebn0_max: float = 20.0
    ebn0_step: float = 0.5
    n_err_min: int = 100_000
    bits_sent_max: int = 10_000_000
    batch_frames: int = 32        # frames simulated per round
    incl_clean_run: bool = True
    reroll_channel: bool = True


def canonical_miso_cnc() -> tuple[LinkConfig, SweepConfig]:
    """The headline benchmark config: 64-QAM, 4096-FFT, 2048 SC, CP 128,
    64-antenna ULA, soft limiter IBO 0 dB, MRT
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py:37-58``)."""
    return LinkConfig(), SweepConfig()


def siso_awgn() -> LinkConfig:
    """SISO AWGN sanity config
    (``reference/main_clipping_noise_cancellation/main_awgn_cnc.py:30-45``)."""
    return LinkConfig(array=ArrayConfig(n_elements=1),
                      channel=ChannelConfig(model="awgn"), precoding="none")


_SECTIONS = {"modem": ModemConfig, "pa": PaConfig, "array": ArrayConfig,
             "channel": ChannelConfig, "rx": RxConfig}


def config_from_dict(d: dict) -> LinkConfig:
    """Build a :class:`LinkConfig` from ``dataclasses.asdict`` of a config
    of either package (nested sections as dictionaries). Unknown keys
    raise ``TypeError``, so a field added on one side is noticed."""
    kw = dict(d)
    for name, cls in _SECTIONS.items():
        if name in kw and isinstance(kw[name], dict):
            kw[name] = cls(**kw[name])
    return LinkConfig(**kw)
