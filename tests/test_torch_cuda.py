"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (decided in the fixture, not at import).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: DTW rtol 1e-4 with an identical BIG/finite
pattern (the kernel sums (a-b)^2 directly, the plain version expands
|a|^2+|b|^2-2ab); MFCC rtol/atol 1e-3 (tests/test_pallas_mfcc.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.kernels import mfcc_fused as kmf
from dsp_tpu_torch.ops import frontend as fe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _dtw_inputs(dev, b, k, t, u, f=39, seed=0, min_len=1):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, f), np.float32)).to(dev)
    bk = torch.from_numpy(rng.standard_normal((k, u, f), np.float32)).to(dev)
    ql = rng.integers(min_len, t + 1, b).astype(np.int32)
    bl = rng.integers(min_len, u + 1, k).astype(np.int32)
    ql[0], bl[0] = t, u
    return q, torch.from_numpy(ql).to(dev), bk, torch.from_numpy(bl).to(dev)


def _check_dtw(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert not np.isnan(got).any()
    assert ((got >= 1e20) == (want >= 1e20)).all()
    fin = want < 1e20
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)


@pytest.mark.parametrize("kw,shape", [
    ({}, (5, 7, 40, 46)),
    ({"squared": True}, (5, 7, 40, 46)),
    ({"slope": "itakura"}, (5, 7, 40, 46)),
    ({"band_frac": None}, (4, 3, 33, 70)),
    ({"band_frac": 0.1}, (3, 4, 120, 300)),
    ({"band_frac": 0.1, "slope": "itakura"}, (3, 4, 120, 300)),
    ({"band_frac": 0.1}, (4, 3, 300, 120)),
    ({}, (6, 5, 198, 198)),
])
def test_dtw_kernel_matches_plain(dev, kw, shape):
    b, k, t, u = shape
    args = _dtw_inputs(dev, b, k, t, u)
    cfg = DtwConfig(**kw)
    before = kdtw.LAUNCHES
    got = kdtw.dtw_batch_fused_banded(*args, cfg)
    torch.cuda.synchronize()
    assert kdtw.LAUNCHES == before + 1
    _check_dtw(got, kdtw.dtw_batch_plain(*args, cfg))


@pytest.mark.parametrize("b,k", [(1, 1), (1, 10), (8, 10)])
def test_auto_takes_the_kernel_at_any_batch_size(dev, b, k):
    args = _dtw_inputs(dev, b, k, 60, 60, seed=2)
    before = kdtw.LAUNCHES
    got = tpl.dtw_pairs(*args, DtwConfig())
    torch.cuda.synchronize()
    assert kdtw.LAUNCHES == before + 1
    _check_dtw(got, tpl.dtw_pairs(*args, DtwConfig(impl="scan")))
    before = kdtw.LAUNCHES
    tpl.dtw_pairs(*args, DtwConfig(max_warp_scale=None))     # no kernel: the scan
    assert kdtw.LAUNCHES == before


def test_dtw_kernel_short_lengths_and_empty(dev):
    q, ql, bk, bl = _dtw_inputs(dev, 4, 4, 12, 12, seed=1)
    ql[:] = torch.tensor([1, 2, 1, 12], dtype=torch.int32)
    bl[:] = torch.tensor([1, 1, 5, 12], dtype=torch.int32)
    for cfg in (DtwConfig(), DtwConfig(slope="itakura"), DtwConfig(band_frac=None)):
        _check_dtw(kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg),
                   kdtw.dtw_batch_plain(q, ql, bk, bl, cfg))
    assert kdtw.dtw_batch_fused_banded(q[:0], ql[:0], bk, bl).shape == (0, 4)


def test_dtw_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, ql, bk, bl = _dtw_inputs(dev, 2, 2, 10, 10)
    with pytest.raises(ValueError):
        kdtw.dtw_batch_fused_banded(q, ql.long(), bk, bl)
    with pytest.raises(ValueError):
        kdtw.dtw_batch_fused_banded(q.transpose(1, 2).contiguous().transpose(1, 2),
                                    ql, bk, bl)
    with pytest.raises(ValueError):
        kdtw.dtw_batch_fused_banded(q.double(), ql, bk, bl)


@pytest.mark.parametrize("kw", [{}, {"use_energy": True}, {"n_fft": 256},
                                {"n_fft": 1024, "n_mels": 40, "n_mfcc": 20}])
@pytest.mark.parametrize("n_sigs", [1, 3])
def test_mfcc_kernel_matches_plain(dev, kw, n_sigs):
    cfg = FrontendConfig(**kw)
    x = torch.from_numpy(np.stack([synth_word("one", s, max_samples=9000)
                                   for s in range(n_sigs)])).to(dev)
    frames = fe.frame(fe.preemphasis(x, cfg.preemphasis), cfg.frame_len,
                      cfg.hop_len).reshape(-1, cfg.frame_len).contiguous()
    before = kmf.LAUNCHES
    got = kmf.mfcc_frames_fused(frames, cfg)
    torch.cuda.synchronize()
    assert kmf.LAUNCHES == before + 1
    want = kmf.mfcc_frames_plain(frames, cfg)
    assert got.shape == want.shape == (frames.shape[0], cfg.n_mfcc)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_sigs", [1, 2])
def test_mfcc_fused_signals_match_plain(dev, n_sigs):
    # one signal's frames are an overlapping view: the entry point copies them
    cfg = FrontendConfig()
    x = torch.from_numpy(np.stack([synth_word("two", s, max_samples=9000)
                                   for s in range(n_sigs)])).to(dev)
    before = kmf.LAUNCHES
    got = kmf.mfcc_fused(x, cfg)
    assert kmf.LAUNCHES == before + 1
    torch.testing.assert_close(got, fe.mfcc(x, cfg, fe.make_matrices(cfg, dev)),
                               rtol=1e-3, atol=1e-3)


def test_mfcc_wrapper_rejects_strided_and_empty(dev):
    cfg = FrontendConfig()
    frames = torch.zeros((8, 800), device=dev)[:, ::2]
    with pytest.raises(ValueError):
        kmf.mfcc_frames_fused(frames, cfg)
    assert kmf.mfcc_frames_fused(torch.zeros((0, 400), device=dev), cfg).shape == (0, 13)


def test_pipeline_routes_cuda_tensors_through_both_kernels(dev):
    # queries and templates are different utterances: at a self-pair the
    # kernel's direct sum gives exactly 0 where the plain expansion leaves
    # a rounding residue under the sqrt
    cfg = dataclasses.replace(PipelineConfig(), frontend=FrontendConfig(impl="pallas"))
    words = ("one", "two")
    x, n = tpl.pad_signals([synth_word(w, i) for w in words for i in range(4)],
                           cfg.max_samples, dev)
    bx, bn = tpl.pad_signals([synth_word(w, 10 + i) for w in words for i in range(4)],
                             cfg.max_samples, dev)
    d0, m0 = kdtw.LAUNCHES, kmf.LAUNCHES
    feats = tpl.extract_features(x, n, cfg)
    bank = tpl.extract_features(bx, bn, cfg)
    ids = torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32, device=dev)
    labels, dists = tpl.classify_features(feats, bank, ids, cfg=cfg)
    torch.cuda.synchronize()
    assert kmf.LAUNCHES == m0 + 2 and kdtw.LAUNCHES == d0 + 1
    assert labels.tolist() == ids.tolist()
    plain = tpl.dtw_pairs(feats.feats, feats.length, bank.feats, bank.length,
                          DtwConfig(impl="scan"))
    _check_dtw(dists, plain)
