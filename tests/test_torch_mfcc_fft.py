"""The FFT mode of the fused MFCC kernel, checked on the CPU.

The kernel (``dsp_tpu_torch/csrc/mfcc_fused.cu``, ``mfcc_fft_kernel``) runs
only on the card.  Here a numpy model of its steps, fed the tables the
kernel receives (``fft_twiddles``, ``mel_pack``), is held to the DFT-GEMM
chain of ``ops/frontend.py:matrices_np`` in float64 (rtol 1e-9: two exact
evaluations of one function, random-normal frames so that no band sits
at the rounding floor) and to the TPU kernel in interpret mode in float32
(rtol/atol 1e-3, the repo's front-end tolerance, tests/test_pallas_mfcc.py).
``launch_plan`` and the mel ranges are host code and are checked as they
are.  Where ``n_fft`` is below the frame length the kernel and the plain
version take the spectrum in float64: both are held to the float64 chain
at atol 1e-4 (measured 4.6e-5 at n_fft 16-256 on speech frames: the
float32 mel, log and DCT that follow), and the TPU kernel in interpret
mode, float32 throughout, to them at rtol/atol 1e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.kernels.mfcc_pallas import mfcc_frames_pallas

from dsp_tpu_torch.config import FrontendConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.kernels import mfcc_fused as kmf
from dsp_tpu_torch.ops import frontend as fe

# (n_fft, frame_len): 64 and 256 fold 400 samples; 256 zero-pads 200
FFT_CASES = [(64, 400), (256, 400), (512, 400), (1024, 400), (256, 200)]


def _frames(n, length, seed=0):
    return np.random.default_rng(seed).standard_normal((n, length))


def fft_model(frames, cfg, dtype=np.float64):
    """The FFT mode step by step: window, zero-pad to n_fft, the half-length
    complex FFT (even samples real, odd imaginary; bit-reversed input, a
    radix-2 stage where the stage count is odd, then radix-4 steps, with
    the kernel's stage table of twiddles), the real split and power; or,
    where n_fft is below the frame length, the folded path (window, fold
    and DFT in float64); then ranged mel, floored log, DCT, lifter, energy
    c0.  Returns (cepstra, log-mel)."""
    ctype = np.complex128 if dtype == np.float64 else np.complex64
    window, _, _, _, dct_t, lifter = (m.astype(dtype) for m in fe.matrices_np(cfg))
    if dtype == np.float64:
        tw = kmf.fft_twiddles_np(cfg.n_fft)
    else:
        tw = kmf.fft_twiddles(cfg.n_fft, "cpu").numpy()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(ctype)
    rng, mel_w = kmf.mel_pack_np(cfg)
    mel_w = mel_w.astype(dtype)
    frames = frames.astype(dtype)
    n, length = frames.shape
    n_fft, half = cfg.n_fft, cfg.n_fft // 2

    if kmf.folded(cfg):
        # the folded path: window, fold and one period's DFT in float64 with
        # fold_twiddles' table, then the power in ``dtype``
        wx = frames.astype(np.float64) * fe.matrices_np(cfg)[0]
        buf = np.zeros((n, n_fft))
        for s in range(0, length, n_fft):
            part = wx[:, s:s + n_fft]
            buf[:, :part.shape[1]] += part
        tw64 = kmf.fold_twiddles(n_fft, "cpu").numpy()
        tw64 = tw64[:, 0] + 1j * tw64[:, 1]
        j, k = np.arange(n_fft)[:, None], np.arange(half + 1)[None, :]
        x = buf @ tw64[(j * k) % n_fft]
        power = ((x.real ** 2 + x.imag ** 2) / n_fft).astype(dtype)
    else:
        buf = np.zeros((n, n_fft), dtype)
        wx = frames * window
        for s in range(0, length, n_fft):
            part = wx[:, s:s + n_fft]
            buf[:, :part.shape[1]] += part
        z = (buf[:, 0::2] + 1j * buf[:, 1::2]).astype(ctype)
        bits = half.bit_length() - 1
        rev = np.array([int(format(m, f"0{bits}b")[::-1], 2) if bits else 0
                        for m in range(half)])
        z = z[:, rev]                      # z[m] stored at position rev[m] (an involution)
        # the kernel's stage table: W_{2h}^p at h - 1 + p
        stage = np.zeros(half, ctype)
        for i in range(half - 1):
            h = 1 << ((i + 1).bit_length() - 1)
            stage[i] = tw[(i + 1 - h) * (half // h)]
        h = 1
        if bits % 2:                       # one radix-2 stage (twiddle 1) first
            zz = z.reshape(n, half // 2, 2)
            z = np.stack([zz[..., 0] + zz[..., 1], zz[..., 0] - zz[..., 1]], -1).reshape(n, half)
            h = 2
        while h < half:                    # radix 4: stages h and 2h in registers
            a0, a1, a2, a3 = np.moveaxis(z.reshape(n, half // (4 * h), 4, h), 2, 0)
            p = np.arange(h)
            w1, w2 = stage[h - 1 + p], stage[2 * h - 1 + p]
            a0, a1 = a0 + a1 * w1, a0 - a1 * w1
            a2, a3 = a2 + a3 * w1, a2 - a3 * w1
            t2, t3 = a2 * w2, a3 * (-1j * w2)
            z = np.stack([a0 + t2, a1 + t3, a0 - t2, a1 - t3], axis=2).reshape(n, half)
            h *= 4
        k = np.arange(half + 1)
        zk = z[:, k % half]
        zc = np.conj(z[:, (half - k) % half])
        even, odd = (zk + zc) / 2, (zk - zc) / 2j
        wk = np.concatenate([tw, np.array([-1], ctype)])
        x = even + wk * odd
        power = (x.real ** 2 + x.imag ** 2) / dtype(n_fft)

    mel = np.zeros((n, cfg.n_mels), dtype)
    for m, (lo, cnt, off) in enumerate(rng):
        mel[:, m] = power[:, lo:lo + cnt] @ mel_w[off:off + cnt]
    log_mel = np.log(np.maximum(mel, dtype(cfg.log_floor)))
    ceps = (log_mel @ dct_t) * lifter
    if cfg.use_energy:
        ceps[:, 0] = np.log(np.maximum((frames * frames).sum(-1), dtype(cfg.log_floor)))
    return ceps, log_mel


def gemm_chain(frames, cfg):
    """The TPU kernel's function in float64: the DFT-GEMM chain on the
    float64 constants of ``matrices_np``."""
    window, cos, sin, mel_fb_t, dct_t, lifter = fe.matrices_np(cfg)
    wx = frames * window
    power = ((wx @ cos) ** 2 + (wx @ sin) ** 2) / cfg.n_fft
    log_mel = np.log(np.maximum(power @ mel_fb_t, cfg.log_floor))
    ceps = (log_mel @ dct_t) * lifter
    if cfg.use_energy:
        ceps[:, 0] = np.log(np.maximum((frames * frames).sum(-1), cfg.log_floor))
    return ceps, log_mel


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("n_fft,frame_len", FFT_CASES)
def test_fft_model_equals_dft_gemm_chain_in_float64(n_fft, frame_len, use_energy):
    cfg = FrontendConfig(n_fft=n_fft, frame_len=frame_len, use_energy=use_energy)
    frames = _frames(24, frame_len, seed=n_fft + frame_len)
    got, got_mel = fft_model(frames, cfg)
    want, want_mel = gemm_chain(frames, cfg)
    np.testing.assert_allclose(got_mel, want_mel, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("n_fft,frame_len", FFT_CASES)
def test_fft_model_in_float32_matches_pallas_interpret(n_fft, frame_len):
    kw = dict(n_fft=n_fft, frame_len=frame_len)
    cfg = FrontendConfig(**kw)
    speech = np.stack([synth_word("seven", 4, max_samples=8000)])
    y = speech - cfg.preemphasis * np.pad(speech[:, :-1], ((0, 0), (1, 0)))
    n_sp = 1 + (y.shape[1] - frame_len) // cfg.hop_len
    sp = np.stack([y[0, i * cfg.hop_len:i * cfg.hop_len + frame_len] for i in range(n_sp)])
    frames = np.concatenate([_frames(16, frame_len, seed=n_fft), sp]).astype(np.float32)
    got, _ = fft_model(frames, cfg, np.float32)
    want = np.asarray(mfcc_frames_pallas(jnp.asarray(frames), JFrontendConfig(**kw),
                                         interpret=True))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"n_mels": 40}, {"fmin": 300.0, "fmax": 3400.0},
                                {"n_fft": 1024, "n_mels": 40, "fmin": 64.0},
                                {"n_fft": 64}])
def test_mel_ranges_cover_every_nonzero_and_only_those(kw):
    cfg = FrontendConfig(**kw)
    fb = fe.matrices_np(cfg)[3].T                         # [M, K]
    ranges = kmf.mel_ranges(cfg)
    inside = np.zeros_like(fb, dtype=bool)
    for m, (lo, hi) in enumerate(ranges):
        inside[m, lo:hi + 1] = True
    np.testing.assert_array_equal(inside, fb != 0)
    rng, w = kmf.mel_pack_np(cfg)
    np.testing.assert_array_equal(rng[:, 0], np.where(ranges[:, 1] >= 0, ranges[:, 0], 0))
    np.testing.assert_array_equal(rng[:, 1], ranges[:, 1] - ranges[:, 0] + 1)
    assert w.shape == ((fb != 0).sum(),) and kmf.mel_nnz(cfg) == w.size
    np.testing.assert_array_equal(w, fb[fb != 0])         # filter after filter, bin order


def test_empty_filters_at_n_fft_64_come_out_as_the_log_floor():
    cfg = FrontendConfig(n_fft=64)
    empty = kmf.mel_ranges(cfg)[:, 1] < 0
    assert empty.sum() == 6
    _, log_mel = fft_model(_frames(8, cfg.frame_len), cfg)
    assert (log_mel[:, empty] == np.log(cfg.log_floor)).all()
    assert (log_mel[:, ~empty] > np.log(cfg.log_floor)).all()


def test_all_zero_frames_give_the_log_floor():
    cfg = FrontendConfig(use_energy=True)
    ceps, log_mel = fft_model(np.zeros((3, cfg.frame_len)), cfg)
    assert (log_mel == np.log(cfg.log_floor)).all()
    assert (ceps[:, 0] == np.log(cfg.log_floor)).all()


def test_twiddles_are_the_float64_table_cast_to_float32():
    for n_fft in (4, 64, 512, 4096):
        tw = kmf.fft_twiddles(n_fft, "cpu")
        assert tw.shape == (n_fft // 2, 2) and str(tw.dtype) == "torch.float32"
        np.testing.assert_array_equal(tw.numpy(),
                                      kmf.fft_twiddles_np(n_fft).astype(np.float32))
        assert kmf.fft_twiddles(n_fft, "cpu") is tw           # cached


@pytest.mark.parametrize("n_fft", [4, 8, 64, 128, 256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("extra", [{}, {"n_mels": 40, "n_mfcc": 20}, {"frame_len": 401}])
def test_launch_plan_takes_fft_for_powers_of_two(n_fft, extra):
    cfg = FrontendConfig(n_fft=n_fft, **extra)
    plan = kmf.launch_plan(cfg)
    assert plan.mode == "fft"
    assert 1 <= plan.warps <= kmf.BLOCK_WARPS and plan.frames_per_warp == kmf.FRAMES_PER_WARP
    assert plan.smem_bytes == kmf.fft_smem_bytes(cfg, plan.warps) <= 232_448
    # the most warps that fit
    assert (plan.warps == kmf.BLOCK_WARPS
            or kmf.fft_smem_bytes(cfg, plan.warps + 1) > kmf.SMEM_OPTIN)


@pytest.mark.parametrize("n_fft", [400, 480, 500])
def test_launch_plan_takes_gemm_for_other_n_fft(n_fft):
    cfg = FrontendConfig(n_fft=n_fft)
    plan = kmf.launch_plan(cfg)
    assert plan == kmf.Plan("gemm", 4, 8, kmf.gemm_smem_bytes(cfg))
    assert plan.smem_bytes <= kmf.SMEM_OPTIN


def test_launch_plan_refuses_what_no_block_holds():
    # 8,192 is the largest n_fft whose buffers fit a block (of two warps);
    # past it, and past the GEMM block's 2,001 bins, nothing fits
    assert kmf.launch_plan(FrontendConfig(n_fft=8192)).warps == 2
    with pytest.raises(ValueError):
        kmf.launch_plan(FrontendConfig(n_fft=16384))
    with pytest.raises(ValueError):
        kmf.launch_plan(FrontendConfig(n_fft=4000))


def test_launch_plan_main_path_config():
    plan = kmf.launch_plan(FrontendConfig())
    assert plan.mode == "fft" and plan.warps == 8
    # twiddles and the stage table, window, DCT, lifter, mel weights,
    # ranges; 8 warps' buffers
    assert plan.smem_bytes == 4 * (256 * 4 + 400 + 26 * 13 + 13 + kmf.mel_nnz(FrontendConfig())
                                   + 3 * 26 + 8 * (2 * 264 + 257 + 26))
    assert kmf.launch_plan(dataclasses.replace(FrontendConfig(), use_energy=True)) == plan


@pytest.mark.parametrize("n_fft", [64, 400, 480, 512])
def test_launch_plan_is_the_fft_plan_else_the_gemm_plan(n_fft):
    cfg = FrontendConfig(n_fft=n_fft)
    fft = kmf.fft_plan(cfg)
    assert (fft is None) == (n_fft in (400, 480))
    assert kmf.launch_plan(cfg) == (fft or kmf.gemm_plan(cfg))
    assert kmf.gemm_plan(cfg) == kmf.Plan("gemm", 4, 8, kmf.gemm_smem_bytes(cfg))
    with pytest.raises(ValueError):
        kmf.gemm_plan(FrontendConfig(n_fft=4000))


def _speech_frames(cfg, word, seeds, max_samples):
    x = np.stack([synth_word(word, s, max_samples=max_samples) for s in seeds])
    y = x - cfg.preemphasis * np.pad(x[:, :-1], ((0, 0), (1, 0)))
    n_fr = 1 + (y.shape[1] - cfg.frame_len) // cfg.hop_len
    idx = np.arange(n_fr)[:, None] * cfg.hop_len + np.arange(cfg.frame_len)
    return y[:, idx].reshape(-1, cfg.frame_len).astype(np.float32)


@pytest.mark.parametrize("n_fft", [16, 64, 256])
def test_folded_spectrum_lands_on_the_float64_chain(n_fft):
    """At n_fft below the frame length the quietest mel bands of speech sit
    near 1e-7 of a frame's energy: float32 folds and transforms missed the
    float64 chain by up to 3e-3 there (ROADMAP.md section 3).  On the card
    test's frames (3 utterances of "eight") and this file's ("seven"), the
    plain version and the kernel's model land on it, and JAX's float32
    chain stays within rtol/atol 1e-3 of them."""
    cfg = FrontendConfig(n_fft=n_fft)
    assert kmf.folded(cfg)
    frames = np.concatenate([_speech_frames(cfg, "eight", range(3), 9000),
                             _speech_frames(cfg, "seven", [4], 8000)])
    want, _ = gemm_chain(frames.astype(np.float64), cfg)
    plain = kmf.mfcc_frames_plain(torch.from_numpy(frames), cfg).numpy()
    model, _ = fft_model(frames, cfg, np.float32)
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(model, want, rtol=0, atol=1e-4)
    jax_fp32 = np.asarray(mfcc_frames_pallas(jnp.asarray(frames), JFrontendConfig(n_fft=n_fft),
                                             interpret=True))
    np.testing.assert_allclose(jax_fp32, plain, rtol=1e-3, atol=1e-3)


def test_fold_tables_and_shared_bytes():
    cfg = FrontendConfig(n_fft=64)
    tw = kmf.fold_twiddles(64, "cpu")
    assert tw.shape == (64, 2) and tw.dtype == torch.float64
    np.testing.assert_array_equal(tw[:, 0].numpy(), np.cos(2 * np.pi * np.arange(64) / 64))
    np.testing.assert_array_equal(tw[:32].numpy(), kmf.fft_twiddles_np(64))
    window, cos, sin = fe.fold_matrices(cfg, "cpu")
    assert window.dtype == cos.dtype == torch.float64 and cos.shape == (64, 33)
    # the folded path's float64 buffer a warp, in both modes; none unfolded
    unfolded = dataclasses.replace(cfg, frame_len=64)
    assert kmf.fold_smem_bytes(unfolded, 8) == 0 and not kmf.folded(unfolded)
    plan = kmf.fft_plan(cfg)
    assert plan.smem_bytes == kmf.fft_smem_bytes(cfg, plan.warps)
    assert (kmf.fft_smem_bytes(cfg, plan.warps) - kmf.fft_smem_bytes(unfolded, plan.warps)
            == 4 * (400 - 64) + 8 * 64 * plan.warps)         # the window, the buffers
    assert kmf.gemm_smem_bytes(cfg) == kmf.gemm_smem_bytes(unfolded) + 8 * 64 * kmf.GEMM_WARPS
