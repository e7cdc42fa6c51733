"""Configuration dataclasses of the PyTorch/CUDA port.

A field-for-field copy of ``dsp_tpu/config.py`` (same names, same
defaults), so one config means the same path in both packages.  It is a
copy and not an import because importing anything under ``dsp_tpu``
runs ``dsp_tpu/__init__.py``, which loads jax; ``tests/test_torch_config.py``
holds the two equal.  In the port ``FrontendConfig.impl="pallas"`` selects
the fused MFCC CUDA kernel; ``DtwConfig.impl`` names the DTW routes
(see :class:`DtwConfig`).

Conventions locked here (and mirrored bit-for-bit by ``dsp_tpu.golden``):

* pre-emphasis ``y[n] = x[n] - 0.97 x[n-1]``, ``y[0] = x[0]``
* 25 ms Hamming frames, 10 ms hop, symmetric window
* NFFT=512 power spectrum ``|X|^2 / NFFT``
* 26 triangular HTK-style mel filters over [0, sr/2]
* log (floored) -> orthonormal DCT-II -> 13 coefficients -> lifter L=22
* delta / delta-delta: +/-2-frame regression with edge replication
* DTW: Euclidean local cost, steps {(1,0),(0,1),(1,1)} weight 1,
  distance normalised by (T_a + T_b)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """MFCC front-end parameters (classical defaults)."""

    sample_rate: int = 16000
    preemphasis: float = 0.97
    frame_len: int = 400        # 25 ms @ 16 kHz
    hop_len: int = 160          # 10 ms @ 16 kHz
    n_fft: int = 512
    n_mels: int = 26
    n_mfcc: int = 13
    fmin: float = 0.0
    fmax: Optional[float] = None   # defaults to sample_rate / 2
    lifter: int = 22               # 0 disables liftering
    delta_width: int = 2           # +/- frames for delta regression
    add_deltas: bool = True        # append delta + delta-delta => 39-dim
    use_energy: bool = False       # replace c0 with log frame energy
    cmn: bool = False              # per-utterance cepstral mean normalization
    # CMN flavor (round 5, VERDICT r4 #6).  "utterance": subtract the
    # exact mean over the (VAD-trimmed) utterance — the measured-best
    # clean/tilt config (docs/RESULTS.md) but a whole-utterance
    # statistic, so the ONLINE DPs (streaming connected decode,
    # streaming spotting) cannot use it.  "causal": subtract a
    # bias-corrected exponential running mean
    #   num_t = a*num_{t-1} + (1-a)*c_t,  m_t = num_t / (1 - a^(t+1))
    # (a = cmn_alpha) — prefix-stable (frame t's features never change
    # as more audio arrives), hence streamable; converges to the
    # utterance mean on stationary channels.  Enroll/train with the
    # SAME mode so queries and templates share a feature space.
    cmn_mode: str = "utterance"    # | "causal"
    cmn_alpha: float = 0.995       # causal forgetting (~2 s @ 100 fps)
    feature_type: str = "mfcc"     # "mfcc" | "lpcc"
    lpc_order: int = 12            # LPC prediction order (feature_type="lpcc")
    log_floor: float = 1e-10
    # Berouti-style spectral subtraction on the power spectrum before the
    # mel filterbank: noise PSD = mean over the ss_frac lowest-energy
    # non-silent frames (digital-zero padding is excluded), then
    # P' = max(P - ss_alpha*N, ss_beta*P).  feature_type "mfcc" only.
    denoise: Optional[str] = None  # None | "spectral_subtraction"
    ss_alpha: float = 2.0          # over-subtraction factor
    ss_beta: float = 0.02          # spectral floor (fraction of P)
    ss_frac: float = 0.1           # fraction of frames for the noise estimate
    impl: str = "xla"              # "xla" (plain PyTorch chain) | "pallas"
    # (the fused MFCC kernel, csrc/mfcc_fused.cu)

    @property
    def fmax_hz(self) -> float:
        return self.fmax if self.fmax is not None else self.sample_rate / 2.0

    @property
    def n_feats(self) -> int:
        return self.n_mfcc * (3 if self.add_deltas else 1)

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class VadConfig:
    """Energy/ZCR double-threshold endpoint detector parameters.

    The detector is specified (not copied — no reference checkout exists)
    as the classic Rabiner two-level algorithm:

    * noise statistics come from the first ``n_init`` frames;
    * a frame is *loud* if energy > ``e_high``, *audible* if > ``e_low``
      where the thresholds are ``noise_mean * mult`` (floored by an
      absolute epsilon so digital silence does not divide by zero);
    * speech starts when energy stays above ``e_high`` for
      ``min_speech_frames``; the start is then extended backwards while
      energy > ``e_low`` or ZCR > ``zcr_thresh`` (to capture unvoiced
      consonants); symmetrically for the end;
    * speech ends after ``max_silence_frames`` below ``e_low``.
    """

    n_init: int = 10
    # 4.0/1.5 (was 8.0/2.0 through round 2): the hostile-benchmark VAD
    # sweep (scripts/hostile_vad.py, docs/RESULTS.md round 3) measured
    # the sensitive thresholds at 0.764 vs 0.343 accuracy at 5 dB SNR
    # with NO loss on clean/10 dB or the standard corpus (1.000 both
    # draws); on the standard corpus 0 dB recovers 0.36 -> 0.88
    # (scripts/robustness.py).  The one regression is hostile 0 dB
    # (0.164 vs 0.257), where both settings are below usable anyway.
    e_high_mult: float = 4.0
    e_low_mult: float = 1.5
    # Threshold rule (round 5, VERDICT r4 #5 — the hostile-0dB remedy).
    # "noise_mult": TH/TL = noise_mean * mult (head-frame noise
    # estimate; the classical rule above).  Its 0 dB failure mode is
    # structural: with stationary noise at 0 dB SNR, speech-plus-noise
    # frames carry only ~2x the noise-floor energy, so TH = 4x noise
    # can NEVER fire and the detector falls back to the whole padded
    # recording.  "two_pass": estimate the floor from the WHOLE
    # utterance (mean of the lowest tp_floor_frac fraction of frame
    # energies) and the speech ceiling (energy quantile tp_ceil_q),
    # then interpolate: TH = floor + tp_high*(ceil - floor), TL =
    # floor + tp_low*(ceil - floor) — SNR-adaptive by construction.
    # Guard: when ceil < tp_min_contrast * floor the field has no
    # speech-like contrast (pure noise reads ~1.2x) and the rule falls
    # back to the noise_mult thresholds, which correctly find nothing.
    # Offline only (the causal streaming detector keeps noise_mult).
    threshold_mode: str = "noise_mult"   # | "two_pass"
    tp_floor_frac: float = 0.2
    tp_ceil_q: float = 0.95
    tp_high: float = 0.25
    tp_low: float = 0.10
    tp_min_contrast: float = 2.0
    e_abs_floor: float = 1e-6      # absolute energy floor added to noise mean
    zcr_mult: float = 2.0          # zcr_thresh = noise_zcr_mean * zcr_mult
    min_speech_frames: int = 5
    max_silence_frames: int = 15
    hangover_frames: int = 8       # frames kept after the detected end
    min_utterance_frames: int = 3  # drop detected segments shorter than this


@dataclasses.dataclass(frozen=True)
class DtwConfig:
    """DTW matcher parameters.

    Defaults follow the classical recipe: Euclidean local cost with a 17%
    Sakoe-Chiba band (Sakoe & Chiba 1978 recommend a band both for speed
    and accuracy).  With ``max_warp_scale`` set, the band is further
    limited to a sliding window whose advance rate is capped (an
    Itakura-style slope limit, quantised by ``window_plan.plan_window``);
    pairs warped more than ~max_warp_scale x score as unreachable.  This
    windowed band is the banded semantics of both packages: the plain
    scan, the numpy oracle and every kernel give the same distances.

    ``impl`` picks the route in the port (``pipeline.dtw_pairs``; each
    kernel's wrapper takes CPU tensors to its plain PyTorch version):

    - ``"auto"``: CUDA tensors take ``"fused_banded"`` whenever it computes
      the config, ``"pallas"`` for the pure band without a slope, and the
      scan for the pure band with ``slope="itakura"``; CPU tensors the scan.
    - ``"scan"``: the plain row scan (``ops/dtw.py``).
    - ``"fused_banded"``: the banded DTW kernel (``csrc/dtw_banded.cu``),
      windowed band or unbanded, either slope.
    - ``"pallas"``: the masked cost in PyTorch, then the wavefront DP
      kernel (``csrc/dtw_wavefront.cu``); any band, no slope.
    - ``"fused"``: the unbanded closed-form kernel (``csrc/dtw_fused.cu``);
      no band, no slope.
    """

    band_frac: Optional[float] = 0.17  # Sakoe-Chiba band as fraction of max(T,U); None = full
    max_warp_scale: Optional[float] = 2.0  # warp-slope limit for the banded window schedule (None = pure band)
    # Local slope constraint on the step pattern (Itakura 1975; Rabiner &
    # Juang §4.7): None = unconstrained steps {(1,0),(0,1),(1,1)};
    # "itakura" = query-synchronous steps {(1,0),(1,1),(1,2)} with no two
    # consecutive (1,0) — every path visits each query frame exactly
    # once and the warp slope is confined to [1/2, 2].  Pairs whose
    # length ratio exceeds 2 score as unreachable (BIG).  Supported by
    # impl "scan" and "fused_banded" (golden oracle: golden/dtw.py).
    slope: Optional[str] = None        # None | "itakura"
    squared: bool = False              # use squared Euclidean local cost
    # The finite "infinity" for masked cells is the module constant
    # ops/dtw.py:BIG (1e30) — deliberately NOT a config knob: the DP
    # internals, the DTW kernels, the golden oracle and the kNN
    # dead-candidate threshold (pipeline.vote_topk, 1e20) all assume the
    # same magnitude, so a per-config value would silently break masking.
    impl: str = "auto"                 # "auto" | "scan" | "fused_banded" | "pallas" | "fused" (see above)


@dataclasses.dataclass(frozen=True)
class VqConfig:
    """Vector-quantisation recognizer parameters (per-word codebook)."""

    n_codes: int = 64       # codebook size per word
    n_iter: int = 10        # Lloyd (k-means) iterations
    squared: bool = True    # distortion = mean min squared distance


@dataclasses.dataclass(frozen=True)
class HmmConfig:
    """Left-to-right GMM-HMM parameters (per word model)."""

    n_states: int = 5
    n_mix: int = 3
    var_floor: float = 1e-3
    n_iter: int = 10
    seed: int = 0
    train_mode: str = "viterbi"    # "viterbi" (segmental) | "baum_welch" (soft EM)
    map_tau: float = 0.0           # > 0: MAP-adapt word models from a UBM
    ubm_iters: int = 8             # EM iterations for the universal GMM


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end recognizer pipeline configuration."""

    frontend: FrontendConfig = FrontendConfig()
    vad: VadConfig = VadConfig()
    dtw: DtwConfig = DtwConfig()
    max_samples: int = 32000       # 2 s @ 16 kHz padded signal length
    max_frames: int = 198          # frames for max_samples: 1+(32000-400)//160
    use_vad: bool = True

    def __post_init__(self):
        f = self.frontend
        want = 1 + max(0, (self.max_samples - f.frame_len)) // f.hop_len
        if self.max_frames != want:
            object.__setattr__(self, "max_frames", want)


DEFAULT_PIPELINE = PipelineConfig()
