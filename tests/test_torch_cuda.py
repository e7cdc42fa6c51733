"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (decided in the fixture, not at import).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py: DTW rtol 1e-4 with an identical BIG/finite
pattern (the kernel sums (a-b)^2 directly, the plain version expands
|a|^2+|b|^2-2ab); MFCC rtol/atol 1e-3 (tests/test_pallas_mfcc.py), and the
FFT mode's max error to a float64 evaluation of the chain at most twice the
plain version's.
Spotting: identical BIG/finite pattern; where the start witnesses agree,
norms at rtol 2e-4; where they differ (a near-tie that the kernel's
sequential sums and the scan's tree round apart), the raw costs
norm * (tl + span) agree to 1e-4 relative and such sites stay under 0.1%
(tests/test_tpu_device.py:333).
Unbanded DTW from features (kernel ``dtw_fused``): rtol 1e-4 / atol 1e-5
against its closed-form plain version and the banded kernel's unbanded
mode (tests/test_pallas_dtw.py:103).  Wavefront DTW (kernel ``dtw_wavefront``):
equal bits to its plain version on the same masked cost (one exact min and
one add per cell).  Wavefront microbenchmark kernels (``mb_*``): equal bits
to their plain versions (dp_diet: exact mins and one add a cell; anatomy:
product and sum rounded apart, as the plain version rounds them; trivial,
transpose and skew move values), the fetch's accumulator at rtol 1e-6.
GMM-HMM (the decode's kernel ``viterbi_score`` and the emissions' kernel
``gmm_emissions``; training has none): the decode kernel's scores equal
the plain loop's bit for bit (one fp32 add a sum, exact maxes), NaN and
infinities where the loop has them; the emission kernel's ``log_b``
within 1e-5 of (1 + |log b|) of the plain chain in float64 (its direct
float32 sums round to ~1e-7), NaN and infinities where that has them; one E-step on
the card within 1e-2 of the CPU's (max |a - b| / (1 + |b|);
chip_smoke.py's HMM_STEP_TOL), transition counts, decode paths and labels
equal, scores on the same features and parameters at rtol 1e-5; the
kernel, the loop on what it refuses, the front end's replayed graphs and
the lattice loops never wait for the card.
HMM and cascade spotting (no kernel of their own; the cascade's rerank is
kernel 3): the keyword/filler column update never waits for the card, its
witnesses equal the CPU's and its LLRs agree at chip_smoke.py's
HMM_SPOT_LLR_TOL; the cascade's rescored events equal the CPU's (scores
rtol 2e-4) and the streaming cascade's the offline one's within 3 frames.
Connected words (kernel 1 on the VAD split; level building and the
connected Viterbi have no kernel): segments integer-equal to the CPU's;
level-building costs at rtol 1e-4 with the BIG pattern equal, words and
starts equal except at sites whose costs agree (near-ties, under 1 %);
streaming level building bit-equal to the card's batch DP under any
chunking; decoded labels and streaming events equal to the CPU's.
LPCC, condensing and VQ (no kernel of their own; a classify and the
medoid's all-pairs distances are kernel 1): LPCC features at rtol/atol
1e-3 with VAD lengths equal and no kernel 2 under ``impl="pallas"``;
medoids equal, DBA centers at rtol/atol 1e-4 and bit-equal from run to
run (no atomics in the sums); one Lloyd step's assignments equal and
centroids within 1e-5; labels equal to the CPU's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dsp_tpu_torch import KnnDtwRecognizer, StreamingRecognizer
from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig, FrontendConfig, PipelineConfig, VadConfig
from dsp_tpu_torch.io import synth_connected, synth_spotting_stream, synth_word
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused as kfu
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.kernels import dtw_pallas as kwf
from dsp_tpu_torch.kernels import mb_wavefront as kmb
from dsp_tpu_torch.kernels import mfcc_fused as kmf
from dsp_tpu_torch.kernels import spot_fused as ksp
from dsp_tpu_torch.kernels import viterbi_score as kvit
from dsp_tpu_torch.models import StreamingSpotter
from dsp_tpu_torch.ops import frontend as fe
from dsp_tpu_torch.ops import level_building as tlb
from dsp_tpu_torch.ops import spot as tsp
from dsp_tpu_torch.ops import streaming as tst
from dsp_tpu_torch.ops import vad as tvad

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
    before = _build.LAUNCHES["dtw_banded"]
    got = kdtw.dtw_batch_fused_banded(*args, cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dtw_banded"] == before + 1
    _check_dtw(got, kdtw.dtw_batch_plain(*args, cfg))


@pytest.mark.parametrize("b,k", [(1, 1), (1, 10), (8, 10)])
def test_auto_takes_the_kernel_at_any_batch_size(dev, b, k):
    args = _dtw_inputs(dev, b, k, 60, 60, seed=2)
    before = _build.LAUNCHES["dtw_banded"]
    got = tpl.dtw_pairs(*args, DtwConfig())
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dtw_banded"] == before + 1
    _check_dtw(got, tpl.dtw_pairs(*args, DtwConfig(impl="scan")))
    n = _build.LAUNCHES
    before, k5 = n["dtw_banded"], n["dtw_wavefront"]
    tpl.dtw_pairs(*args, DtwConfig(max_warp_scale=None))     # the wavefront kernel
    assert n["dtw_banded"] == before and n["dtw_wavefront"] == k5 + 1


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


# lengths at the strip edges of kernel 1's walk, and T
STRIP_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 198]


@pytest.mark.parametrize("kw", [{}, {"squared": True}, {"slope": "itakura"},
                                {"band_frac": None},
                                {"band_frac": None, "slope": "itakura"}])
def test_dtw_kernel_at_strip_edge_lengths(dev, kw):
    n = len(STRIP_LENGTHS)
    q, _, bk, _ = _dtw_inputs(dev, n, n, 198, 198, seed=3)
    lens = torch.tensor(STRIP_LENGTHS, dtype=torch.int32, device=dev)
    cfg = DtwConfig(**kw)
    _check_dtw(kdtw.dtw_batch_fused_banded(q, lens, bk, lens, cfg),
               kdtw.dtw_batch_plain(q, lens, bk, lens, cfg))


@pytest.mark.parametrize("kw", [{}, {"squared": True}, {"slope": "itakura"},
                                {"band_frac": None}])
def test_dtw_kernel_self_pair_is_exactly_zero(dev, kw):
    """The kernel sums (a-b)^2 exactly: a sequence against itself is 0 (the
    plain version's |a|^2+|b|^2-2ab expansion leaves a residue)."""
    q, ql, _, _ = _dtw_inputs(dev, 6, 1, 198, 198, seed=4, min_len=20)
    got = kdtw.dtw_batch_fused_banded(q, ql, q, ql, DtwConfig(**kw))
    assert (torch.diagonal(got) == 0).all()


@pytest.mark.parametrize("f", [1, 13, 40, 41, 60, 100])
def test_dtw_kernel_any_feature_width(dev, f):
    """Widths other than the main path's 39: even widths (staged at a row
    stride one wider), and beyond 40 features (the query strip staged row
    by row)."""
    for kw in ({}, {"slope": "itakura"}):
        args = _dtw_inputs(dev, 5, 4, 70, 64, f=f, seed=f)
        _check_dtw(kdtw.dtw_batch_fused_banded(*args, DtwConfig(**kw)),
                   kdtw.dtw_batch_plain(*args, DtwConfig(**kw)))


LONG_TEMPLATE_CONFIGS = [{}, {"slope": "itakura"}, {"band_frac": None},
                         {"band_frac": None, "slope": "itakura"}]


@pytest.mark.parametrize("u", [1335, 1336, 1369, 1370, 4000, 12000])
@pytest.mark.parametrize("kw", LONG_TEMPLATE_CONFIGS)
def test_dtw_kernel_long_templates(dev, kw, u):
    """Templates that fit a one-warp block run staged (at F = 39, T = 198:
    up to 1,369 frames, 1,335 with Itakura); longer ones run in the
    kernel's window mode, the cost tiles reading the template from device
    memory."""
    cfg = DtwConfig(**kw)
    t = 198
    itakura = cfg.slope == "itakura"
    window, _, _ = kdtw.launch_plan(3, t, u, 39, kdtw._window(cfg, t, u)[2], itakura)
    assert window == (u > (1335 if itakura else 1369))
    args = _dtw_inputs(dev, 3, 2, t, u, seed=6, min_len=20)
    _check_dtw(kdtw.dtw_batch_fused_banded(*args, cfg), kdtw.dtw_batch_plain(*args, cfg))


@pytest.mark.parametrize("kw", LONG_TEMPLATE_CONFIGS)
def test_dtw_kernel_longest_template_and_one_more(dev, kw):
    """The stated limit (kdtw.max_template_frames) runs; one frame more is
    refused at the launch, and the refusal does not leak into the next."""
    cfg = DtwConfig(**kw)
    u = kdtw.max_template_frames(20, 39, cfg)
    args = _dtw_inputs(dev, 1, 1, 20, u, seed=6)
    _check_dtw(kdtw.dtw_batch_fused_banded(*args, cfg), kdtw.dtw_batch_plain(*args, cfg))
    with pytest.raises(RuntimeError, match="dtw_banded"):
        kdtw.dtw_batch_fused_banded(*_dtw_inputs(dev, 1, 1, 20, u + 1, seed=6), cfg)
    small = _dtw_inputs(dev, 2, 2, 30, 30)
    _check_dtw(kdtw.dtw_batch_fused_banded(*small, cfg), kdtw.dtw_batch_plain(*small, cfg))


# the benchmark's cells: (queries, templates, T = U, shortest length)
BENCH_CELLS = {"sc2-35w.host256": (256, 2240, 98, 13),
               "digits-100.dev1024": (1024, 100, 198, 20)}


@pytest.mark.parametrize("cell", sorted(BENCH_CELLS))
def test_dtw_kernel_at_the_benchmark_cells_shapes(dev, cell):
    """The cells' launches (lengths spread over the shortest to T), and 1,
    3, 8 and 9 queries of them, where a block has fewer queries than its
    warps' share: each against the plain version, and each bitwise the
    rows of the whole batch (a pair's distance does not depend on the
    block, warp or round that computed it)."""
    b, k, t, lo = BENCH_CELLS[cell]
    q, ql, bk, bl = _dtw_inputs(dev, b, k, t, t, seed=b + k, min_len=lo)
    cfg = DtwConfig()
    got = kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg)
    _check_dtw(got, kdtw.dtw_batch_plain(q, ql, bk, bl, cfg))
    for n in (1, 3, 8, 9):
        part = kdtw.dtw_batch_fused_banded(q[:n].contiguous(), ql[:n].contiguous(), bk, bl, cfg)
        _check_dtw(part, kdtw.dtw_batch_plain(q[:n], ql[:n], bk, bl, cfg))
        assert torch.equal(part, got[:n]), n


def test_dtw_kernel_counts_each_launch_by_its_cost_path(dev):
    """``dtw_banded.tiled`` for a staged launch, ``dtw_banded.window`` for a
    template past the staged limit, one a launch."""
    from dsp_tpu_torch.utils import profiling

    cfg = DtwConfig()

    def counted(*args):
        before = profiling.counts()
        kdtw.dtw_batch_fused_banded(*args, cfg)
        return {n: v - before.get(n, 0) for n, v in profiling.counts().items()
                if n.startswith("dtw_banded.") and v != before.get(n, 0)}

    assert counted(*_dtw_inputs(dev, 4, 3, 98, 98)) == {"dtw_banded.tiled": 1}
    assert counted(*_dtw_inputs(dev, 2, 2, 198, 2000, min_len=20)) == {"dtw_banded.window": 1}
    b = ROWS_PAST_THE_GRID
    assert counted(*_dtw_inputs(dev, b, 2, 8, 8, f=3, seed=12)) == {
        "dtw_banded.tiled": len(_build.row_slices(b))}


def test_auto_takes_templates_past_the_staged_limit(dev):
    args = _dtw_inputs(dev, 4, 3, 198, 2000, seed=11, min_len=20)
    _check_dtw(tpl.dtw_pairs(*args, DtwConfig()),
               tpl.dtw_pairs(*args, DtwConfig(impl="scan")))


ROWS_PAST_THE_GRID = 65_537     # one more than two launches' worth of gridDim.y


@pytest.mark.parametrize("name", ["dtw_banded", "dtw_fused", "spot_subseq"])
def test_kernels_take_batches_past_the_grid_limit(dev, name):
    b = ROWS_PAST_THE_GRID
    before = _build.LAUNCHES[name]
    if name == "spot_subseq":
        args = _spot_inputs(dev, b, 2, 10, 4, f=3, seed=12)
        got = ksp.subseq_dtw_fused(*args)
        want = tsp.subseq_dtw_batch_plain(*args)
        _check_spot(got, want, args[1], args[3])
    else:
        args = _dtw_inputs(dev, b, 2, 8, 8, f=3, seed=12)
        if name == "dtw_banded":
            cfg = DtwConfig()
            got, want = (kdtw.dtw_batch_fused_banded(*args, cfg),
                         kdtw.dtw_batch_plain(*args, cfg))
        else:
            cfg = DtwConfig(band_frac=None)
            got, want = kfu.dtw_batch_fused(*args, cfg), kfu.dtw_batch_fused_plain(*args, cfg)
        _check_dtw(got, want)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + len(_build.row_slices(b)) == before + 2


def test_dtw_kernel_window_narrower_than_the_band(dev):
    """Warps steeper than max_warp_scale: the window falls behind the band
    and cuts it, so some pairs become unreachable; the kernel must cut the
    same cells as the plain version."""
    cfg = DtwConfig(band_frac=0.1, max_warp_scale=1.0)
    q, ql, bk, bl = _dtw_inputs(dev, 5, 6, 64, 400, seed=5)
    got = kdtw.dtw_batch_fused_banded(q, ql, bk, bl, cfg)
    want = kdtw.dtw_batch_plain(q, ql, bk, bl, cfg)
    _check_dtw(got, want)
    assert (want.cpu() >= 1e20).any() and (want.cpu() < 1e20).any()


@pytest.mark.parametrize("kw", [{}, {"use_energy": True}, {"n_fft": 256},
                                {"n_fft": 1024, "n_mels": 40, "n_mfcc": 20}])
@pytest.mark.parametrize("n_sigs", [1, 3])
def test_mfcc_kernel_matches_plain(dev, kw, n_sigs):
    cfg = FrontendConfig(**kw)
    x = torch.from_numpy(np.stack([synth_word("one", s, max_samples=9000)
                                   for s in range(n_sigs)])).to(dev)
    frames = fe.frame(fe.preemphasis(x, cfg.preemphasis), cfg.frame_len,
                      cfg.hop_len).reshape(-1, cfg.frame_len).contiguous()
    before = _build.LAUNCHES["mfcc_fused"]
    got = kmf.mfcc_frames_fused(frames, cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mfcc_fused"] == before + 1
    want = kmf.mfcc_frames_plain(frames, cfg)
    assert got.shape == want.shape == (frames.shape[0], cfg.n_mfcc)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_sigs", [1, 2])
def test_mfcc_fused_signals_match_plain(dev, n_sigs):
    # one signal's frames are an overlapping view: the entry point copies them
    cfg = FrontendConfig()
    x = torch.from_numpy(np.stack([synth_word("two", s, max_samples=9000)
                                   for s in range(n_sigs)])).to(dev)
    before = _build.LAUNCHES["mfcc_fused"]
    got = kmf.mfcc_fused(x, cfg)
    assert _build.LAUNCHES["mfcc_fused"] == before + 1
    torch.testing.assert_close(got, fe.mfcc(x, cfg, fe.make_matrices(cfg, dev)),
                               rtol=1e-3, atol=1e-3)


def test_mfcc_wrapper_rejects_strided_and_empty(dev):
    cfg = FrontendConfig()
    frames = torch.zeros((8, 800), device=dev)[:, ::2]
    with pytest.raises(ValueError):
        kmf.mfcc_frames_fused(frames, cfg)
    assert kmf.mfcc_frames_fused(torch.zeros((0, 400), device=dev), cfg).shape == (0, 13)


def _speech_frames(cfg, n_sigs=3, word="eight"):
    x = torch.from_numpy(np.stack([synth_word(word, s, max_samples=9000)
                                   for s in range(n_sigs)]))
    return fe.frame(fe.preemphasis(x, cfg.preemphasis), cfg.frame_len,
                    cfg.hop_len).reshape(-1, cfg.frame_len).contiguous()


def _mfcc_once(dev, frames, cfg):
    """The kernel on ``frames`` (one launch counted) and the plain version."""
    before = _build.LAUNCHES["mfcc_fused"]
    got = kmf.mfcc_frames_fused(frames, cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mfcc_fused"] == before + 1
    want = kmf.mfcc_frames_plain(frames, cfg)
    assert got.shape == want.shape == (frames.shape[0], cfg.n_mfcc)
    assert torch.isfinite(got).all()
    return got, want


def _chain_f64(frames, cfg):
    """The kernel's function in float64: the plain version on float64 frames
    and the float64 constants of ``matrices_np``."""
    mats = fe.FrontendMatrices(*(torch.from_numpy(m).to(frames.device)
                                 for m in fe.matrices_np(cfg)))
    return fe.mfcc_from_frames(frames.double(), mats, cfg)


@pytest.mark.parametrize("kw,mode", [
    ({}, "fft"), ({"use_energy": True}, "fft"), ({"n_fft": 256}, "fft"),
    ({"n_fft": 1024, "n_mels": 40, "n_mfcc": 20}, "fft"), ({"n_fft": 64}, "fft"),
    ({"n_fft": 4096}, "fft"), ({"n_fft": 480}, "gemm")])
def test_mfcc_kernel_modes_match_plain(dev, kw, mode):
    cfg = FrontendConfig(**kw)
    assert kmf.launch_plan(cfg).mode == mode
    got, want = _mfcc_once(dev, _speech_frames(cfg).to(dev), cfg)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_fft", [512, 1024])
def test_mfcc_gemm_mode_when_asked_at_a_power_of_two(dev, n_fft):
    cfg = FrontendConfig(n_fft=n_fft)
    frames = _speech_frames(cfg).to(dev)
    before = _build.LAUNCHES["mfcc_fused"]
    got = kmf.mfcc_frames_fused(frames, cfg, plan=kmf.gemm_plan(cfg))
    assert _build.LAUNCHES["mfcc_fused"] == before + 1
    torch.testing.assert_close(got, kmf.mfcc_frames_plain(frames, cfg), rtol=1e-3, atol=1e-3)
    assert kmf.launch_plan(cfg) == kmf.fft_plan(cfg)


@pytest.mark.parametrize("n", [1, 31, 33, 37, 1000])
@pytest.mark.parametrize("use_energy", [False, True])
def test_mfcc_fft_mode_any_frame_count(dev, n, use_energy):
    # 32 frames a block (8 warps x 4): a ragged last block, a warp with no
    # frame, a block with one
    cfg = FrontendConfig(use_energy=use_energy)
    frames = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, cfg.frame_len), np.float32)).to(dev)
    got, want = _mfcc_once(dev, frames, cfg)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"use_energy": True}, {"n_fft": 64}, {"n_fft": 480}])
def test_mfcc_kernel_all_zero_frames(dev, kw):
    cfg = FrontendConfig(**kw)
    frames = torch.zeros((40, cfg.frame_len), device=dev)
    got, want = _mfcc_once(dev, frames, cfg)
    # every log-mel energy is exactly log(log_floor): the DCT of that constant
    floor = np.log(cfg.log_floor) * (fe.matrices_np(cfg)[4].sum(0) * fe.matrices_np(cfg)[5])
    if cfg.use_energy:
        floor[0] = np.log(cfg.log_floor)    # c0 = log(max(sum x^2, log_floor))
    torch.testing.assert_close(got.cpu().double(), torch.from_numpy(np.tile(floor, (40, 1))),
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    if cfg.use_energy:
        # c0 = log(max(0, log_floor)): the same float32 log as the plain version's
        assert torch.equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 0].cpu().numpy(), np.log(cfg.log_floor), rtol=1e-6)


@pytest.mark.parametrize("frame_len,offset", [(401, 0), (400, 1), (399, 3), (200, 0)])
def test_mfcc_fft_mode_rows_not_16_byte_aligned(dev, frame_len, offset):
    # 401 / 399 floats a row, or a view that starts one float into its
    # buffer, take the kernel's scalar loads; 200 zero-pads to 512
    cfg = FrontendConfig(frame_len=frame_len)
    src = _speech_frames(cfg)
    buf = torch.zeros(src.numel() + offset, device=dev)
    frames = buf[offset:].view(src.shape)
    frames.copy_(src)
    assert frames.is_contiguous() and (frames.data_ptr() % 16 != 0) == (offset > 0)
    assert kmf.launch_plan(cfg).mode == "fft"
    got, want = _mfcc_once(dev, frames, cfg)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"use_energy": True}, {"n_fft": 256}, {"n_fft": 64}])
def test_mfcc_fft_mode_error_to_float64_within_twice_the_plain(dev, kw):
    cfg = FrontendConfig(**kw)
    frames = _speech_frames(cfg, n_sigs=4, word="three").to(dev)
    got, want = _mfcc_once(dev, frames, cfg)
    exact = _chain_f64(frames, cfg)
    err = (got.double() - exact).abs().max().item()
    plain_err = (want.double() - exact).abs().max().item()
    assert err <= 2 * plain_err, (err, plain_err)


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
    d0, m0 = _build.LAUNCHES["dtw_banded"], _build.LAUNCHES["mfcc_fused"]
    feats = tpl.extract_features(x, n, cfg)
    bank = tpl.extract_features(bx, bn, cfg)
    ids = torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32, device=dev)
    labels, dists = tpl.classify_features(feats, bank, ids, cfg=cfg)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["mfcc_fused"], _build.LAUNCHES["dtw_banded"]) == (m0 + 2,
                                                                         d0 + 1)
    assert labels.tolist() == ids.tolist()
    plain = tpl.dtw_pairs(feats.feats, feats.length, bank.feats, bank.length,
                          DtwConfig(impl="scan"))
    _check_dtw(dists, plain)


def _spot_inputs(dev, b, k, u, t, f=39, seed=0):
    rng = np.random.default_rng(seed)
    streams = torch.from_numpy(rng.standard_normal((b, u, f), np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((k, t, f), np.float32)).to(dev)
    sl = rng.integers(max(1, u // 3), u + 1, b).astype(np.int32)
    tl = rng.integers(max(1, t // 4), t + 1, k).astype(np.int32)
    sl[0], tl[0] = u, t
    return streams, torch.from_numpy(sl).to(dev), bank, torch.from_numpy(tl).to(dev)


def _check_spot(got, want, s_lens, b_lens):
    gn, gs = (x.cpu().numpy() for x in got)
    wn, ws = (x.cpu().numpy() for x in want)
    assert gn.shape == wn.shape and not np.isnan(gn).any()
    assert ((gn >= 1e20) == (wn >= 1e20)).all()
    u = gn.shape[-1]
    j = np.arange(u)[None, None, :]
    valid = np.broadcast_to(j < s_lens.cpu().numpy()[:, None, None], gn.shape)
    agree = valid & (gs == ws)
    np.testing.assert_allclose(np.where(agree, gn, 0.0), np.where(agree, wn, 0.0),
                               rtol=2e-4, atol=1e-5)
    flip = valid & (gs != ws)
    tl = b_lens.cpu().numpy().astype(np.float64)[None, :, None]
    raw_g = gn * (tl + j - gs + 1)
    raw_w = wn * (tl + j - ws + 1)
    np.testing.assert_allclose(raw_g[flip], raw_w[flip], rtol=1e-4)
    assert flip.sum() <= 1e-3 * valid.sum()


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("shape", [(3, 4, 57, 23, 5), (5, 7, 130, 40, 13),
                                   (4, 6, 300, 198, 39), (2, 3, 2500, 60, 39)])
def test_spot_kernel_matches_plain(dev, shape, squared):
    b, k, u, t, f = shape
    args = _spot_inputs(dev, b, k, u, t, f)
    before = _build.LAUNCHES["spot_subseq"]
    got = ksp.subseq_dtw_fused(*args, squared=squared)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spot_subseq"] == before + 1
    _check_spot(got, ksp.subseq_dtw_batch_plain(*args, squared=squared),
                args[1], args[3])


def test_spot_kernel_zero_cost_tie_and_short_lengths(dev):
    stream = torch.ones((1, 12, 3), device=dev)
    tmpl = torch.ones((1, 4, 3), device=dev)
    one = torch.tensor([12], dtype=torch.int32, device=dev)
    four = torch.tensor([4], dtype=torch.int32, device=dev)
    _, start = ksp.subseq_dtw_fused(stream, one, tmpl, four)
    assert start[0, 0].tolist() == [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8]
    args = _spot_inputs(dev, 4, 4, 20, 9, 7, seed=3)
    args[1][:] = torch.tensor([1, 2, 20, 5], dtype=torch.int32)
    args[3][:] = torch.tensor([1, 9, 2, 4], dtype=torch.int32)
    _check_spot(ksp.subseq_dtw_fused(*args), ksp.subseq_dtw_batch_plain(*args),
                args[1], args[3])


def test_spot_auto_takes_the_kernel_at_any_stream_length(dev):
    for u in (5, 200, 6000):
        args = _spot_inputs(dev, 2, 3, u, 40, seed=u)
        before = _build.LAUNCHES["spot_subseq"]
        got = tsp.subseq_dtw_batch(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["spot_subseq"] == before + 1
        _check_spot(got, tsp.subseq_dtw_batch(*args, impl="scan"), args[1], args[3])


def test_spot_wrapper_rejects_what_the_kernel_does_not_take(dev):
    streams, sl, bank, tl = _spot_inputs(dev, 2, 2, 30, 10)
    with pytest.raises(ValueError):
        ksp.subseq_dtw_fused(streams, sl.long(), bank, tl)
    with pytest.raises(ValueError):
        ksp.subseq_dtw_fused(streams.double(), sl, bank, tl)
    with pytest.raises(ValueError):
        ksp.subseq_dtw_fused(streams.transpose(1, 2).contiguous().transpose(1, 2),
                             sl, bank, tl)
    with pytest.raises(ValueError):
        ksp.subseq_dtw_fused(streams, sl, bank[:, :0].contiguous(), tl)
    _check_spot(ksp.subseq_dtw_fused(streams, sl, bank, tl),
                ksp.subseq_dtw_batch_plain(streams, sl, bank, tl), sl, tl)
    norm, start = ksp.subseq_dtw_fused(streams[:0], sl[:0], bank, tl)
    assert norm.shape == start.shape == (0, 2, 30)


def test_keyword_spotter_on_the_card_matches_the_plain_route(dev):
    from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer
    from dsp_tpu_torch.io import synth_spotting_stream

    rec = KnnDtwRecognizer(PipelineConfig(), device=dev)
    for lab in ("zero", "one"):
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    sigs = [synth_spotting_stream(["zero", "one"], ["zero", "one", "three", "four"],
                                  seed=s, n_words=5)[0] for s in (2, 7)]
    before = _build.LAUNCHES["spot_subseq"]
    spotter = KeywordSpotter(rec)
    thr = spotter.calibrate_threshold()
    got = spotter.scores(sigs)
    assert _build.LAUNCHES["spot_subseq"] > before
    plain = KeywordSpotter(rec, impl="scan")
    assert thr == pytest.approx(plain.calibrate_threshold(), rel=1e-4)
    for (gn, gs), (wn, ws) in zip(got, plain.scores(sigs)):
        agree = gs == ws
        np.testing.assert_allclose(gn[agree], wn[agree], rtol=2e-4, atol=1e-5)
        assert (~agree).sum() <= 1e-3 * agree.size


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("shape", [(5, 3, 25, 31, 13), (3, 2, 40, 40, 8),
                                   (2, 4, 9, 126, 5), (6, 5, 198, 198, 39),
                                   (2, 3, 60, 300, 70)])
def test_fused_kernel_matches_plain_and_banded_unbanded(dev, shape, squared):
    b, k, t, u, f = shape
    args = _dtw_inputs(dev, b, k, t, u, f=f, seed=7)
    cfg = DtwConfig(band_frac=None, squared=squared)
    before = _build.LAUNCHES["dtw_fused"]
    got = kfu.dtw_batch_fused(*args, cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dtw_fused"] == before + 1
    for want in (kfu.dtw_batch_fused_plain(*args, cfg),
                 kdtw.dtw_batch_fused_banded(*args, cfg)):
        got_n, want_n = got.cpu().numpy(), want.cpu().numpy()
        assert ((got_n >= 1e20) == (want_n >= 1e20)).all()
        np.testing.assert_allclose(got_n, want_n, rtol=1e-4, atol=1e-5)


def test_fused_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, ql, bk, bl = _dtw_inputs(dev, 2, 2, 10, 10)
    unbanded = DtwConfig(band_frac=None)
    for bad in (DtwConfig(), DtwConfig(band_frac=None, slope="itakura")):
        with pytest.raises(ValueError):
            kfu.dtw_batch_fused(q, ql, bk, bl, bad)
    with pytest.raises(ValueError):
        kfu.dtw_batch_fused(q, ql.long(), bk, bl, unbanded)
    with pytest.raises(ValueError):
        kfu.dtw_batch_fused(q, ql, bk[:, :0].contiguous(), bl, unbanded)
    _check_dtw(kfu.dtw_batch_fused(q, ql, bk, bl, unbanded),
               kfu.dtw_batch_fused_plain(q, ql, bk, bl, unbanded))
    assert kfu.dtw_batch_fused(q[:0], ql[:0], bk, bl, unbanded).shape == (0, 2)


# lengths at the strip (32 rows or columns) and chunk (32 steps) edges of
# kernels 4 and 3
EDGE_LENGTHS = [1, 31, 32, 33, 63, 64, 65]


def _check_fused(args, cfg):
    got = kfu.dtw_batch_fused(*args, cfg)
    want = kfu.dtw_batch_fused_plain(*args, cfg)
    got_n, want_n = got.cpu().numpy(), want.cpu().numpy()
    assert not np.isnan(got_n).any()
    assert ((got_n >= 1e20) == (want_n >= 1e20)).all()
    np.testing.assert_allclose(got_n, want_n, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_fused_kernel_at_strip_edge_lengths(dev, length, squared):
    """The edge length as the query's, then as the template's, each against
    a full and a short other side."""
    q, ql, bk, bl = _dtw_inputs(dev, 4, 4, 65, 70, seed=length)
    ql[:] = torch.tensor([length, length, 65, 40], dtype=torch.int32)
    bl[:] = torch.tensor([70, 47, length, length], dtype=torch.int32)
    _check_fused((q, ql, bk, bl), DtwConfig(band_frac=None, squared=squared))


@pytest.mark.parametrize("t,u", [(198, 1100), (60, 4000), (2000, 150), (40, 1313)])
def test_fused_kernel_long_templates_and_queries(dev, t, u):
    """Templates past the first kernel's 1,024 frames (window mode past
    1,312 at F = 39) and a query of 2,000 frames: each was refused before."""
    window = kfu.launch_plan(3, u, 39)[0]
    assert window == (u > 1312)
    args = _dtw_inputs(dev, 3, 2, t, u, seed=u, min_len=20)
    _check_fused(args, DtwConfig(band_frac=None))


def test_fused_kernel_template_past_kernel1s_limit(dev):
    """60,000 frames, past kernel 1's 54,428: window mode's edge rows are in
    device memory."""
    args = _dtw_inputs(dev, 1, 1, 20, 60_000, seed=3)
    _check_fused(args, DtwConfig(band_frac=None))


def test_fused_kernel_window_mode_in_query_slices(dev, monkeypatch):
    """A window-mode batch whose edge rows exceed the scratch budget runs
    in slices of ``window_rows`` queries, one launch each."""
    monkeypatch.setattr(kfu, "WINDOW_SCRATCH_FLOATS", 2 * 3 * 1400)
    args = _dtw_inputs(dev, 5, 3, 40, 1400, seed=4)
    assert kfu.launch_plan(5, 1400, 39)[0] and kfu.window_rows(3, 1400) == 2
    before = _build.LAUNCHES["dtw_fused"]
    _check_fused(args, DtwConfig(band_frac=None))
    assert _build.LAUNCHES["dtw_fused"] == before + 3


@pytest.mark.parametrize("f", [1, 40, 41, 100, 130])
def test_fused_kernel_any_feature_width(dev, f):
    args = _dtw_inputs(dev, 5, 4, 50, 64, f=f, seed=f)
    _check_fused(args, DtwConfig(band_frac=None))


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_fused_kernel_any_block_warps(dev, warps, monkeypatch):
    monkeypatch.setattr(kfu, "BLOCK_WARPS", warps)
    args = _dtw_inputs(dev, 13, 3, 70, 90, seed=warps)
    assert kfu.launch_plan(13, 90, 39)[1] == warps
    _check_fused(args, DtwConfig(band_frac=None))
    resident, regs = kfu.occupancy(198, 39, warps)
    assert resident >= warps and 0 < regs <= 255


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_spot_kernel_at_strip_edge_lengths(dev, length, squared):
    """The edge length as the stream's, then as the template's."""
    args = _spot_inputs(dev, 4, 4, 70, 65, seed=length)
    args[1][:] = torch.tensor([length, length, 70, 40], dtype=torch.int32)
    args[3][:] = torch.tensor([65, 47, length, length], dtype=torch.int32)
    _check_spot(ksp.subseq_dtw_fused(*args, squared=squared),
                ksp.subseq_dtw_batch_plain(*args, squared=squared), args[1], args[3])


@pytest.mark.parametrize("u,t,f", [(300, 1100, 39), (120, 600, 128), (150, 1300, 39),
                                   (100, 9000, 39)])
def test_spot_kernel_long_templates_and_wide_features(dev, u, t, f):
    """A 1,100-frame template at F = 39 (staged) and 600 frames at F = 128
    (window mode), each refused before; 1,300 and 9,000 at F = 39 in window
    mode."""
    assert ksp.launch_plan(2, 2, u, t, f)[0] == (t == 600 or t > 1280)
    args = _spot_inputs(dev, 2, 2, u, t, f=f, seed=t)
    args[3][1] = t // 2
    _check_spot(ksp.subseq_dtw_fused(*args), ksp.subseq_dtw_batch_plain(*args),
                args[1], args[3])


@pytest.mark.parametrize("f", [1, 40, 41, 100, 130])
def test_spot_kernel_any_feature_width(dev, f):
    args = _spot_inputs(dev, 3, 3, 80, 40, f=f, seed=f)
    _check_spot(ksp.subseq_dtw_fused(*args), ksp.subseq_dtw_batch_plain(*args),
                args[1], args[3])


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_spot_kernel_any_block_warps(dev, warps, monkeypatch):
    monkeypatch.setattr(ksp, "BLOCK_WARPS", warps)
    args = _spot_inputs(dev, 13, 3, 90, 70, seed=warps)
    assert ksp.launch_plan(13, 3, 90, 70, 39)[1] == warps
    _check_spot(ksp.subseq_dtw_fused(*args), ksp.subseq_dtw_batch_plain(*args),
                args[1], args[3])
    resident, regs = ksp.occupancy(198, 39, warps)
    assert resident >= warps and 0 < regs <= 255


@pytest.mark.parametrize("t,f", [(40, 5), (198, 39), (1300, 39), (600, 128)])
@pytest.mark.parametrize("w_pair", [2, 4, 8])
def test_spot_kernel_several_warps_a_stream(dev, w_pair, t, f, monkeypatch):
    """Streams walked by 2, 4 or 8 warps, strip by strip, each reading its
    neighbour's edge column (staged and window mode), at stream lengths
    that leave the last warps one strip short or none."""
    monkeypatch.setattr(ksp, "SM_COUNT", 10**9)
    monkeypatch.setattr(ksp, "BLOCK_WARPS", w_pair)
    args = _spot_inputs(dev, 3, 2, 32 * w_pair * 2 + 5, t, f=f, seed=w_pair)
    args[1][1] = 32 * (w_pair - 1) + 1
    _, warps, got_w, _ = ksp.launch_plan(3, 2, args[0].shape[1], t, f)
    assert got_w == warps == min(w_pair, 4 if f == 128 else 8)   # as many as the block holds
    for squared in (False, True):
        _check_spot(ksp.subseq_dtw_fused(*args, squared=squared),
                    ksp.subseq_dtw_batch_plain(*args, squared=squared), args[1], args[3])


def test_spot_kernel_window_mode_in_stream_slices(dev, monkeypatch):
    monkeypatch.setattr(ksp, "WINDOW_SCRATCH_WORDS", 2 * 3 * 8 * 2 * 1400)
    args = _spot_inputs(dev, 5, 3, 70, 1400, seed=4)
    assert ksp.launch_plan(5, 3, 70, 1400, 39)[0] and ksp.window_rows(3, 1400) == 2
    before = _build.LAUNCHES["spot_subseq"]
    _check_spot(ksp.subseq_dtw_fused(*args), ksp.subseq_dtw_batch_plain(*args),
                args[1], args[3])
    assert _build.LAUNCHES["spot_subseq"] == before + 3


@pytest.mark.parametrize("name", ["dtw_fused", "spot_subseq"])
def test_window_mode_launches_on_the_current_stream(dev, name):
    """Kernels 4 and 3 in window mode, on a non-default current stream that
    first sleeps, then writes the inputs (as the test of every wrapper)."""
    if name == "dtw_fused":
        inputs = _dtw_inputs(dev, 3, 2, 40, 1500, seed=5)
        fn = kfu.dtw_batch_fused
        assert kfu.launch_plan(3, 1500, 39)[0]
    else:
        inputs = _spot_inputs(dev, 3, 2, 90, 1400, seed=5)
        fn = ksp.subseq_dtw_fused
        assert ksp.launch_plan(3, 2, 90, 1400, 39)[0]
    want = fn(*inputs)
    bufs = [torch.zeros_like(x) for x in inputs]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        for buf, x in zip(bufs, inputs):
            buf.copy_(x)
        got = fn(*bufs)
    side.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kw", [{}, {"band_frac": None}, {"max_warp_scale": None},
                                {"band_frac": 0.1}, {"squared": True}])
@pytest.mark.parametrize("shape", [(5, 7, 40, 46), (3, 4, 198, 198), (2, 3, 70, 33)])
def test_wavefront_kernel_matches_plain(dev, kw, shape):
    b, k, t, u = shape
    q, ql, bk, bl = _dtw_inputs(dev, b, k, t, u, seed=8)
    cfg = DtwConfig(**kw)
    from dsp_tpu_torch.ops import dtw as tdtw

    cost = tdtw.masked_cost(q, ql, bk, bl, cfg).reshape(b * k, t, u).contiguous()
    la = ql[:, None].expand(b, k).reshape(-1).contiguous()
    lb = bl[None, :].expand(b, k).reshape(-1).contiguous()
    before = _build.LAUNCHES["dtw_wavefront"]
    got = kwf.dtw_from_cost_pallas(cost, la, lb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dtw_wavefront"] == before + 1
    want = kwf.dtw_from_cost_plain(cost, la, lb)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    _check_dtw(kwf.dtw_batch_pallas(q, ql, bk, bl, cfg),
               tpl.dtw_pairs(q, ql, bk, bl, DtwConfig(impl="scan", **kw)))


def test_wavefront_pairs_and_wrapper_refusals(dev):
    q, ql, bk, bl = _dtw_inputs(dev, 4, 4, 50, 50, seed=9)
    cfg = DtwConfig()
    got = kwf.dtw_pairs_pallas(q, bk, ql, bl, cfg)
    from dsp_tpu_torch.ops import dtw as tdtw

    _check_dtw(got, tdtw.dtw_pairs_scan(q, ql, bk, bl, cfg))
    cost = tdtw.masked_cost_pairs(q, ql, bk, bl, cfg)
    with pytest.raises(ValueError):
        kwf.dtw_from_cost_pallas(cost, ql.long(), bl)
    with pytest.raises(ValueError):
        kwf.dtw_from_cost_pallas(cost.transpose(1, 2), ql, bl)
    with pytest.raises(ValueError, match="slope"):
        kwf.dtw_pairs_pallas(q, bk, ql, bl, DtwConfig(slope="itakura"))
    assert kwf.dtw_from_cost_pallas(cost[:0], ql[:0], bl[:0]).shape == (0,)


# lengths at kernel 5's strip and chunk edges
WAVEFRONT_EDGES = [1, 31, 32, 33, 63, 64, 65]


@pytest.mark.parametrize("source", ["masked", "scattered"])
@pytest.mark.parametrize("t,u", [(65, 65), (40, 130), (130, 40)])
@pytest.mark.parametrize("p", [7, 49])      # not a multiple of the warps a block
def test_wavefront_kernel_bit_equal_at_strip_edges(dev, t, u, p, source):
    """Each length of WAVEFRONT_EDGES as la and as lb.  On a masked cost
    (ops/dtw.py) every distance has the plain version's bits.  On a cost
    with BIG cells scattered anywhere, every finite distance does and the
    BIG pattern is the same; an unreachable pair's BIG-sized value may
    differ, since the kernel takes cells outside the matrix as exactly BIG
    where the plain version's skewed padding sums BIG onto BIG."""
    rng = np.random.default_rng(t * 1000 + u + p)
    edges = np.array(WAVEFRONT_EDGES, np.int64)
    la = np.minimum(np.resize(edges, p), t).astype(np.int32)
    lb = np.minimum(np.resize(np.roll(edges, 3), p), u).astype(np.int32)
    la[:len(edges)] = np.minimum(edges, t)      # each edge length as la ...
    lb[-len(edges):] = np.minimum(edges, u)     # ... and as lb
    la_t, lb_t = (torch.from_numpy(x).to(dev) for x in (la, lb))
    if source == "masked":
        from dsp_tpu_torch.ops import dtw as tdtw

        a = torch.from_numpy(rng.standard_normal((p, t, 5), np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((p, u, 5), np.float32)).to(dev)
        cost = tdtw.masked_cost_pairs(a, la_t, b, lb_t, DtwConfig()).contiguous()
    else:
        c = rng.standard_normal((p, t, u)).astype(np.float32) ** 2
        c[rng.random(c.shape) < 0.1] = kwf.BIG
        cost = torch.from_numpy(c).to(dev)
    want = kwf.dtw_from_cost_plain(cost, la_t, lb_t).cpu().numpy()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = kwf.dtw_from_cost_pallas(cost, la_t, lb_t)
    side.synchronize()
    got = got.cpu().numpy()
    if source == "masked":
        np.testing.assert_array_equal(got, want)
    else:
        assert ((got >= 1e20) == (want >= 1e20)).all()
        fin = want < 1e20
        assert fin.any()
        np.testing.assert_array_equal(got[fin], want[fin])


@pytest.mark.parametrize("warps", [1, 4, 8])
def test_wavefront_kernel_any_block_warps(dev, warps, monkeypatch):
    rng = np.random.default_rng(warps)
    cost = torch.from_numpy(rng.standard_normal((13, 70, 90)).astype(np.float32) ** 2).to(dev)
    la = torch.from_numpy(rng.integers(1, 71, 13).astype(np.int32)).to(dev)
    lb = torch.from_numpy(rng.integers(1, 91, 13).astype(np.int32)).to(dev)
    monkeypatch.setattr(kwf, "BLOCK_WARPS", warps)
    np.testing.assert_array_equal(kwf.dtw_from_cost_pallas(cost, la, lb).cpu().numpy(),
                                  kwf.dtw_from_cost_plain(cost, la, lb).cpu().numpy())
    resident, regs = kwf.occupancy(198, warps)
    assert resident >= warps and 0 < regs <= 255


def test_matchers_on_the_card_match_the_plain_routes(dev):
    from dsp_tpu_torch import KnnDtwRecognizer

    words = ("zero", "one", "two")
    recs = {}
    for name, device, kw in (("card", dev, {}), ("cpu", "cpu", {})):
        rec = KnnDtwRecognizer(PipelineConfig(), device=device, matcher="cascade",
                               shortlist=4, **kw)
        for w in words:
            rec.enroll(w, [synth_word(w, i) for i in range(3)])
        recs[name] = rec
    sigs = [synth_word(w, 40 + i) for i, w in enumerate(words * 2)]
    before = _build.LAUNCHES["dtw_wavefront"]
    got, d = recs["card"].classify_batch(sigs, return_distances=True)
    assert _build.LAUNCHES["dtw_wavefront"] > before   # the rerank went through kernel 5
    want, want_d = recs["cpu"].classify_batch(sigs, return_distances=True)
    assert got == want == list(words * 2)
    np.testing.assert_allclose(d, want_d, rtol=1e-3)


def _mb_dp_inputs(dev, p, d, t, seed=0):
    rng = np.random.default_rng(seed)
    skew = rng.standard_normal((p, d, t)).astype(np.float32)
    skew[rng.random(skew.shape) < 0.1] = kmb.BIG
    ktarget = rng.integers(-1, d + 1, (p, 1)).astype(np.int32)
    la = rng.integers(0, t + 2, (p, 1)).astype(np.int32)
    return (torch.from_numpy(skew).to(dev), torch.from_numpy(ktarget).to(dev),
            torch.from_numpy(la).to(dev))


@pytest.mark.parametrize("p,d,t,warps", [(16, 16, 32, 4), (37, 13, 256, 3),
                                         (5, 40, 64, 1), (9, 7, 128, 16), (3, 9, 512, 2)])
def test_mb_dp_diet_and_fetch_match_plain(dev, p, d, t, warps):
    skew, ktarget, la = _mb_dp_inputs(dev, p, d, t, seed=p)
    before = dict(_build.LAUNCHES)
    got = kmb.dp_diet(skew, ktarget, la, warps=warps)
    fetched = kmb.dma_fetch(skew, ktarget, warps=warps)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mb_dp_diet"] == before["mb_dp_diet"] + 1
    assert _build.LAUNCHES["mb_dma_fetch"] == before["mb_dma_fetch"] + 1
    assert torch.equal(got, kmb.dp_diet_plain(skew, ktarget, la))
    torch.testing.assert_close(fetched, kmb.dma_fetch_plain(skew, ktarget),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_rolls", [0, 1, 2])
@pytest.mark.parametrize("rows,width,warps", [(8, 32, 4), (13, 256, 3), (5, 512, 1),
                                              (6, 64, 2)])
def test_mb_anatomy_matches_plain(dev, rows, width, warps, n_rolls):
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, width)).astype(np.float32)).to(dev)
    cycles = torch.zeros((rows,), dtype=torch.int64, device=dev)
    before = _build.LAUNCHES["mb_anatomy"]
    got = kmb.anatomy(x, n_rolls, 7, warps=warps, cycles=cycles)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mb_anatomy"] == before + 1
    assert torch.equal(got, kmb.anatomy_plain(x, n_rolls, 7))
    assert (cycles > 0).all()
    assert torch.equal(kmb.anatomy(x, n_rolls, 0), x + x)


@pytest.mark.parametrize("shape", [(8, 128), (3, 1000, 7), (1,)])
def test_mb_trivial_matches_plain(dev, shape):
    x = torch.randn(shape, device=dev)
    before = _build.LAUNCHES["mb_trivial"]
    got = kmb.trivial(x)
    assert _build.LAUNCHES["mb_trivial"] == before + 1
    assert torch.equal(got, kmb.trivial_plain(x))


@pytest.mark.parametrize("shape,block_rows", [((4, 8, 16), 8), ((3, 45, 70), 5),
                                              ((2, 256, 512), 32)])
def test_mb_transpose_matches_plain(dev, shape, block_rows):
    x = torch.randn(shape, device=dev)
    before = _build.LAUNCHES["mb_transpose"]
    got = kmb.transpose(x, block_rows=block_rows)
    assert _build.LAUNCHES["mb_transpose"] == before + 1
    assert torch.equal(got, kmb.transpose_plain(x))


@pytest.mark.parametrize("q,t,u,d_pad,block_rows", [(4, 16, 16, 32, 8), (3, 45, 70, 130, 5),
                                                    (2, 256, 256, 512, 16)])
def test_mb_skew_matches_plain_and_skew_cost(dev, q, t, u, d_pad, block_rows):
    x = torch.randn((q, t, u), device=dev)
    before = _build.LAUNCHES["mb_skew"]
    got = kmb.skew(x, d_pad, block_rows=block_rows)
    assert _build.LAUNCHES["mb_skew"] == before + 1
    assert torch.equal(got, kmb.skew_plain(x, d_pad))
    ref = kwf.skew_cost(x)
    assert torch.equal(got[:, : t + u - 1], ref)
    assert (got[:, t + u - 1:] == kmb.BIG).all()


def test_mb_wrappers_refuse_what_the_kernels_do_not_take(dev):
    skew, ktarget, la = _mb_dp_inputs(dev, 4, 8, 32)
    flat = torch.zeros(1 + skew.numel(), device=dev)
    for call in (
            lambda: kmb.dp_diet(skew.transpose(0, 1).contiguous().transpose(0, 1),
                                ktarget, la),                         # not contiguous
            lambda: kmb.dp_diet(skew.double(), ktarget, la),           # dtype
            lambda: kmb.dp_diet(skew, ktarget.long(), la),
            lambda: kmb.dp_diet(torch.zeros((4, 8, 48), device=dev), ktarget, la),  # T
            lambda: kmb.dp_diet(flat[1:].view(skew.shape), ktarget, la),  # misaligned
            lambda: kmb.dp_diet(skew, ktarget, la, warps=0),
            lambda: kmb.dma_fetch(torch.zeros((4, 8, 100), device=dev), ktarget),
            lambda: kmb.dma_fetch(skew, ktarget.cpu()),                # mixed devices
            lambda: kmb.anatomy(torch.zeros((2, 48), device=dev), 1, 3),
            lambda: kmb.anatomy(torch.zeros((2, 32), device=dev), 3, 3),
            lambda: kmb.anatomy(torch.zeros((2, 32), device=dev), 1, 3,
                                cycles=torch.zeros(2, dtype=torch.int32, device=dev)),
            lambda: kmb.trivial(torch.zeros(4, device=dev, dtype=torch.float16)),
            lambda: kmb.transpose(torch.zeros((2, 8, 8), device=dev).transpose(1, 2)),
            lambda: kmb.transpose(torch.zeros((2, 8, 8), device=dev), block_rows=33),
            lambda: kmb.skew(torch.zeros((2, 16, 16), device=dev), 31)):
        with pytest.raises(ValueError):
            call()
    assert torch.equal(kmb.dp_diet(skew, ktarget, la), kmb.dp_diet_plain(skew, ktarget, la))
    assert kmb.dp_diet(skew[:, :0].contiguous(), ktarget, la).eq(0).all()


def _stream_cases(dev):
    """(name, wrapper, inputs) for every kernel wrapper."""
    q, ql, bk, bl = _dtw_inputs(dev, 6, 5, 60, 70, seed=9)
    rng = np.random.default_rng(9)
    cost = torch.from_numpy(np.abs(rng.standard_normal((7, 40, 46)))
                            .astype(np.float32)).to(dev)
    la = torch.from_numpy(rng.integers(1, 41, 7).astype(np.int32)).to(dev)
    lb = torch.from_numpy(rng.integers(1, 47, 7).astype(np.int32)).to(dev)
    frames = torch.randn((50, 400), device=dev)
    skew, ktarget, la_mb = _mb_dp_inputs(dev, 9, 12, 32)
    return [
        ("dtw_banded", kdtw.dtw_batch_fused_banded, (q, ql, bk, bl)),
        ("mfcc_fused", kmf.mfcc_frames_fused, (frames,)),
        ("spot_subseq", ksp.subseq_dtw_fused,
         (bk, bl, q[:, :50].contiguous(), ql.clamp(max=50))),
        ("dtw_fused", kfu.dtw_batch_fused, (q, ql, bk, bl)),
        ("dtw_wavefront", kwf.dtw_from_cost_pallas, (cost, la, lb)),
        ("mb_dp_diet", kmb.dp_diet, (skew, ktarget, la_mb)),
        ("mb_dma_fetch", kmb.dma_fetch, (skew, ktarget)),
        ("mb_anatomy", lambda x: kmb.anatomy(x, 2, 9),
         (torch.randn((6, 64), device=dev),)),
        ("mb_trivial", kmb.trivial, (torch.randn((5, 77), device=dev),)),
        ("mb_transpose", kmb.transpose, (torch.randn((3, 40, 70), device=dev),)),
        ("mb_skew", lambda x: kmb.skew(x, 80), (torch.randn((3, 30, 45), device=dev),)),
    ]


STREAM_KERNELS = ["dtw_banded", "mfcc_fused", "spot_subseq", "dtw_fused", "dtw_wavefront",
                  "mb_dp_diet", "mb_dma_fetch", "mb_anatomy", "mb_trivial", "mb_transpose",
                  "mb_skew"]


@pytest.mark.parametrize("name", STREAM_KERNELS)
def test_every_wrapper_launches_on_the_current_stream(dev, name):
    """On a non-default current stream that first sleeps, then writes the
    inputs: a kernel launched on any other stream would read the zeros that
    were there before, so the result equals the default stream's only if
    the launch went to the current stream."""
    _, fn, inputs = next(c for c in _stream_cases(dev) if c[0] == name)
    want = fn(*inputs)
    bufs = [torch.zeros_like(x) for x in inputs]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = _build.LAUNCHES[name]
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)      # ~50 ms of SM cycles before the copies
        for buf, x in zip(bufs, inputs):
            buf.copy_(x)
        got = fn(*bufs)
    side.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


# ------------------------------------------------------------- streaming
# The online path has no kernel of its own: its front-end, VAD and SPRING
# update are plain PyTorch on the card, held here to the same code on the
# CPU, and the recognizer's classify runs kernel 1.  MFCC at rtol/atol
# 1e-3: cuBLAS and the CPU's BLAS sum the DFT GEMM in other orders, and the
# quietest log-mel bands amplify it (2.9e-4 abs measured on the card, past
# 1e-4; 1e-3 is JAX's own bound for GEMM-shape differences,
# tests/test_streaming.py:48); energies rtol 1e-4; flags and indices equal.

def _stream_signals(n, n_chunks, chunk=1600):
    """n seeded streams of noise with one digit each, [n, n_chunks * chunk]."""
    rng = np.random.default_rng(n)
    sigs = 0.002 * rng.standard_normal((n, n_chunks * chunk))
    for i in range(n):
        w = synth_word(["zero", "one", "two", "three"][i % 4], 10 + i, max_samples=12000)
        w = w[: max(0, sigs.shape[1] - 2000)]
        sigs[i, 2000:2000 + len(w)] += w
    return sigs.astype(np.float32)


def _assert_chunk_outputs_close(got, want):
    for name, g, w in zip(tst.ChunkOutput._fields, got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "mfcc":
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3, msg=name)
        elif name == "energy":
            torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0, msg=name)
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("denoise", [None, "spectral_subtraction"])
def test_process_chunk_batch_on_the_card_matches_the_cpu(dev, denoise):
    fcfg = FrontendConfig(denoise=denoise)
    sigs = _stream_signals(6, 12)
    state = tst.init_state_batch(6, fcfg, 1600, dev)
    ref = tst.init_state_batch(6, fcfg, 1600, "cpu")
    single = tst.init_state(fcfg, 1600, dev)
    for c in range(12):
        part = torch.from_numpy(sigs[:, c * 1600:(c + 1) * 1600].copy())
        state, out = tst.process_chunk_batch(state, part.to(dev), fe.make_matrices(fcfg, dev),
                                             fcfg, VadConfig(), 1600)
        ref, want = tst.process_chunk_batch(ref, part, fe.make_matrices(fcfg, "cpu"),
                                            fcfg, VadConfig(), 1600)
        _assert_chunk_outputs_close(out, want)
        single, one = tst.process_chunk(single, part[0].to(dev), fe.make_matrices(fcfg, dev),
                                        fcfg, VadConfig(), 1600)
        _assert_chunk_outputs_close(tst.ChunkOutput(*(a[None] for a in one)),
                                    tst.ChunkOutput(*(a[:1] for a in want)))
    for name, g, w in zip(tst.StreamState._fields, state, ref):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4, msg=name)


def test_streaming_calls_never_wait_for_the_card(dev):
    fcfg = FrontendConfig()
    mats = fe.make_matrices(fcfg, dev)
    sigs = torch.from_numpy(_stream_signals(4, 1)).to(dev)
    bank = torch.randn((5, 30, 39), device=dev)
    lens = torch.tensor([30, 20, 10, 25, 1], dtype=torch.int32, device=dev)
    buf = torch.randn((16, 39), device=dev)
    states = (tst.init_state(fcfg, 1600, dev), tst.init_state_batch(4, fcfg, 1600, dev),
              tsp.spot_init(5, 30, dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tst.process_chunk(states[0], sigs[0], mats, fcfg, VadConfig(), 1600)
        tst.process_chunk_batch(states[1], sigs, mats, fcfg, VadConfig(), 1600)
        tsp.spot_chunk(states[2], buf, 11, bank, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _small_bank(labels, n, device):
    rec = KnnDtwRecognizer(PipelineConfig(), device=device)
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(n)])
    return rec


def _feed_all(stream, sig, tail=False):
    n_full = len(sig) // 1600 * 1600
    events = []
    for lo in range(0, n_full, 1600):
        events += stream.feed(sig[lo:lo + 1600])
    return events + (stream.flush(sig[n_full:]) if tail else stream.flush())


def test_streaming_recognizer_on_the_card_matches_the_cpu(dev):
    rec = _small_bank(["zero", "one", "two", "three"], 3, dev)
    rec_cpu = KnnDtwRecognizer.from_arrays(np.stack(rec._bank_feats), rec._bank_lens,
                                           rec._bank_label_ids, rec.labels, PipelineConfig(),
                                           device="cpu")
    sig = np.concatenate([synth_connected(["two", "zero", "three"], 5),
                          np.zeros(8000, np.float32)])
    before = _build.LAUNCHES["dtw_banded"]
    got = _feed_all(StreamingRecognizer(rec), sig)
    assert _build.LAUNCHES["dtw_banded"] - before == len(got)
    assert got == _feed_all(StreamingRecognizer(rec_cpu), sig)
    assert [ev[0] for ev in got] == ["two", "zero", "three"]


def test_streaming_spotter_on_the_card_matches_the_cpu(dev):
    rec = _small_bank(["zero", "one"], 3, dev)
    rec_cpu = KnnDtwRecognizer.from_arrays(np.stack(rec._bank_feats), rec._bank_lens,
                                           rec._bank_label_ids, rec.labels, PipelineConfig(),
                                           device="cpu")
    sig, _ = synth_spotting_stream(["zero", "one"], ["zero", "one", "three", "four", "five"],
                                   seed=7, n_words=5)
    got = _feed_all(StreamingSpotter(rec, threshold=30.0), sig, tail=True)
    want = _feed_all(StreamingSpotter(rec_cpu, threshold=30.0), sig, tail=True)
    assert got and [ev[:3] for ev in got] == [ev[:3] for ev in want]
    for g, w in zip(got, want):
        assert g[3] == pytest.approx(w[3], rel=1e-4)


@pytest.mark.parametrize("f", [3, 39])
def test_spring_chunk_invariance_on_the_card(dev, f):
    rng = np.random.default_rng(f)
    stream = torch.from_numpy(rng.standard_normal((48, f)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((4, 20, f)).astype(np.float32)).to(dev)
    lens = torch.tensor([20, 11, 3, 17], dtype=torch.int32, device=dev)
    runs = []
    for chunks in ([48], [16, 16, 16], [5, 11, 32], [1] * 48):
        state, width, off, parts = tsp.spot_init(4, 20, dev), max(chunks), 0, []
        for c in chunks:
            buf = torch.zeros((width, f), device=dev)
            buf[:c] = stream[off:off + c]
            state, norm, start = tsp.spot_chunk(state, buf, c, bank, lens)
            parts.append((norm[:, :c], start[:, :c]))
            off += c
        runs.append(tuple(torch.cat(p, dim=1) for p in zip(*parts)))
    for norm, start in runs[1:]:
        assert torch.equal(norm, runs[0][0]) and torch.equal(start, runs[0][1])
    want_n, want_s = tsp.subseq_dtw_batch_plain(stream[None].cpu(), torch.tensor([48]),
                                                bank.cpu(), lens.cpu())
    torch.testing.assert_close(runs[0][0].cpu(), want_n[0], rtol=2e-5, atol=1e-6)
    assert torch.equal(runs[0][1].cpu(), want_s[0])


def test_gmm_hmm_on_the_card_matches_the_cpu(dev):
    """BASELINE config 3 at a small size: the card's fit against the CPU's
    EM on the same features from the same draws (labels equal; one E-step
    within chip_smoke.py's 1e-2 with equal transition counts), decode and
    scores on the same parameters (paths equal, scores rtol 1e-5)."""
    from dsp_tpu_torch import GmmHmmRecognizer
    from dsp_tpu_torch.config import HmmConfig
    from dsp_tpu_torch.models import gmm_hmm as pg

    hmm = HmmConfig(n_states=4, n_mix=2, n_iter=3)
    train = {w: [synth_word(w, i) for i in range(3)] for w in ("zero", "one", "two")}
    rec = GmmHmmRecognizer(PipelineConfig(), hmm, device=dev)
    rec.fit(train)
    feats_w, lens_w = pg.stack_words([rec.extract(train[w]) for w in rec.labels], dev)
    w, _, _, f = feats_w.shape
    host = pg.fit_words_batched(feats_w.cpu(), lens_w.cpu(), pg.word_jitter(hmm, w, f, "cpu"),
                                hmm)
    p0 = pg.init_params(feats_w, lens_w, hmm, pg.word_jitter(hmm, w, f, dev))
    s_card = pg.em_suff_stats(feats_w, lens_w, p0, hmm)
    s_host = pg.em_suff_stats(feats_w.cpu(), lens_w.cpu(),
                              pg.HmmParams(*(a.cpu() for a in p0)), hmm)
    for name in ("stay_cnt", "trans_cnt"):
        assert torch.equal(getattr(s_card, name).cpu(), getattr(s_host, name))
    for name in ("tot", "sx", "sxx", "loglik"):
        a, b = getattr(s_card, name).cpu().double(), getattr(s_host, name).double()
        assert float(((a - b).abs() / (1 + b.abs())).max()) <= 1e-2, name

    queries = [synth_word(wd, 50 + i) for wd in ("zero", "one", "two") for i in range(2)]
    feats = rec.extract(queries)
    got = pg.score_words(feats.feats, feats.length, rec.params)
    want = pg.score_words(feats.feats.cpu(), feats.length.cpu(),
                          pg.HmmParams(*(a.cpu() for a in rec.params)))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    cpu_rec = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    cpu_rec.labels, cpu_rec.params = rec.labels, host
    assert rec.classify_batch(queries) == cpu_rec.classify_batch(queries)

    logb = torch.logsumexp(pg._mixture_loglik(feats_w, rec.params), dim=-1)
    _, paths = pg.viterbi_decode(rec.params.log_pi[..., None, :],
                                 rec.params.log_a[..., None, :, :], logb, lens_w)
    _, h_paths = pg.viterbi_decode(rec.params.log_pi.cpu()[..., None, :],
                                   rec.params.log_a.cpu()[..., None, :, :], logb.cpu(),
                                   lens_w.cpu())
    assert torch.equal(paths.cpu(), h_paths)


def test_hmm_lattice_loops_never_wait_for_the_card(dev):
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.ops import viterbi as tvit

    rng = np.random.default_rng(0)
    log_b = torch.from_numpy(rng.standard_normal((6, 40, 4)).astype(np.float32)).to(dev)
    log_pi = torch.log_softmax(torch.randn(4, device=dev), -1)
    log_a = torch.log_softmax(torch.randn(4, 4, device=dev), -1)
    lengths = torch.tensor([40, 1, 7, 39, 20, 3], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tvit.viterbi_score(log_pi, log_a, log_b.transpose(0, 1).contiguous(), lengths)
        tvit.forward_score(log_pi, log_a, log_b.transpose(0, 1).contiguous(), lengths)
        tvit.viterbi_decode(log_pi, log_a, log_b, lengths)
        pg._forward_backward(log_pi, log_a, log_b, lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_viterbi_score_runs_the_loop_on_what_the_kernel_refuses_and_never_waits(dev):
    """The card's ``viterbi_score`` on inputs the kernel refuses (33 states,
    past its 32; float64): ``_viterbi_loop``'s bits op by op on the card,
    no host sync and no launch of the kernel."""
    from dsp_tpu_torch.ops import viterbi as tvit

    wide = _lattices(dev, 33, 5, 3, 40, "dense", seed=3)
    pi, a, b, lens = _lattices(dev, 16, 5, 3, 40, "left_to_right", seed=6)
    double = (pi.double(), a.double(), b.double(), lens)
    assert "S <= 32" in kvit.refusal(*wide) and "float32" in kvit.refusal(*double)
    want = [tvit._viterbi_loop(*x) for x in (wide, double)]
    launched = _build.LAUNCHES["viterbi_score"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tvit.viterbi_score(*x) for x in (wide, double)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES["viterbi_score"] == launched
    assert got[1].dtype == torch.float64
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_hmm_front_end_replays_its_graph_bit_for_bit_and_never_waits(dev, monkeypatch):
    """``gmm_hmm.recognize_batch``'s front end on the card through
    ``utils/graphs.py`` (op by op at a shape's first call, a CUDA graph
    captured at its second and replayed after), at the 8 kHz config and
    three batch sizes, against ``pipeline.extract_features`` and
    ``score_words`` op by op on the same clips: equal bits at every call,
    no host sync, the caller's tensors free to change after a call, and
    the least recently used shape dropped past ``GRAPHS_KEPT``."""
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "_graphs", type(graphs._graphs)())
    monkeypatch.setattr(graphs, "_seen", type(graphs._seen)())
    monkeypatch.setattr(graphs, "GRAPHS_KEPT", 2)
    cfg = PipelineConfig(frontend=FrontendConfig(sample_rate=8000, frame_len=200, hop_len=80,
                                                 n_fft=256, n_mels=23, n_mfcc=13),
                         max_samples=16000)
    w, s, m, f = 3, 16, 3, 39
    rng = np.random.default_rng(7)
    log_pi, log_a, i = np.full((w, s), -1e30), np.full((w, s, s), -1e30), np.arange(s)
    log_pi[:, 0] = 0.0
    log_a[:, i, i] = np.log(0.6)
    log_a[:, i[:-1], i[1:]] = np.log(0.4)
    log_a[:, -1, -1] = 0.0
    params = pg.params_from_numpy((log_pi, log_a, rng.standard_normal((w, s, m, f)),
                                   rng.uniform(-1.0, 1.0, (w, s, m, f)),
                                   np.full((w, s, m), -np.log(m))), dev)
    words, seed = ("zero", "oh", "one", "two", "three"), iter(range(100))

    def clips(b):
        return tpl.pad_signals([synth_word(words[k % 5], next(seed), sr=8000, max_samples=16000)
                                for k in range(b)], cfg.max_samples, dev)

    def op_by_op(x, n):
        feats = tpl.extract_features(x, n, cfg)
        scores = pg.score_words(feats.feats, feats.length, params)
        return scores.argmax(-1), scores

    def check(calls):
        want = [op_by_op(*x) for x in calls]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        got = []
        try:
            for x, n in calls:
                got.append(pg.recognize_batch(x, n, params, cfg))
                x.fill_(0.0)
                n.fill_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for (gi, gs), (wi, ws) in zip(got, want):
            assert torch.equal(gi, wi) and torch.equal(gs, ws)

    check([clips(3) for _ in range(3)])
    assert len(graphs._graphs) == 1 and not graphs._seen
    for b in (4, 5):
        check([clips(b) for _ in range(2)])
    assert [k[2][0] for k in graphs._graphs] == [(4, 16000), (5, 16000)]


def _lattices(dev, s, b, w, t, model, seed, lengths=None):
    """``score_words``' arguments on the card: ``log_pi`` [1, W, S],
    ``log_a`` [1, W, S, S] (dense random, or left-to-right with NEG_INF off
    the band), the [T, B, W, S] view of a [B, T, W, S] ``log_b`` and [B, 1]
    int32 lengths (1, T and between, unless given)."""
    rng = np.random.default_rng(seed)
    if model == "dense":
        log_pi = np.log(rng.dirichlet(np.ones(s), size=w))
        log_a = np.log(rng.dirichlet(np.ones(s), size=(w, s)))
    else:
        log_pi, log_a = np.full((w, s), -1e30), np.full((w, s, s), -1e30)
        log_pi[:, 0] = 0.0
        stay, i = rng.uniform(0.3, 0.9, (w, s)), np.arange(s)
        log_a[:, i, i] = np.log(stay)
        log_a[:, i[:-1], i[1:]] = np.log1p(-stay[:, :-1])
        log_a[:, -1, -1] = 0.0
    log_b = rng.standard_normal((b, t, w, s)) * 10.0 - 40.0
    if lengths is None:
        lengths = rng.integers(1, t + 1, b)
        lengths[0], lengths[-1] = 1, t
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)   # noqa: E731
    return (f32(log_pi)[None], f32(log_a)[None], f32(log_b).movedim(1, 0),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)[:, None])


@pytest.mark.parametrize("model", ["dense", "left_to_right"])
@pytest.mark.parametrize("s", [1, 2, 5, 16, 17, 32])
def test_viterbi_kernel_equals_the_loop_bit_for_bit(dev, s, model):
    """Kernel ``viterbi_score`` against ``_viterbi_loop`` on the card, on
    ``score_words``' exact broadcast ([1, W, S], [1, W, S, S], the
    ``movedim`` view, [B, 1] lengths of 1, T and between): equal bits, and
    ``viterbi_score`` takes the kernel (one ``_build.LAUNCHES`` entry)."""
    from dsp_tpu_torch.ops import viterbi as tvit

    args = _lattices(dev, s, 7, 3, 40, model, seed=s)
    want = tvit._viterbi_loop(*args)
    assert kvit.refusal(*args) is None
    assert torch.equal(kvit.viterbi_score_fused(*args), want)
    before = _build.LAUNCHES["viterbi_score"]
    assert torch.equal(tvit.viterbi_score(*args), want)
    assert _build.LAUNCHES["viterbi_score"] == before + 1


def test_viterbi_kernel_takes_long_lattices_many_pairs_and_nan(dev):
    """T = 2,000; more lattices than a grid's rows (3-D ``log_b`` with
    int64 lengths, and with none); NaN and infinities in ``log_b``, each
    where the loop has it: equal bits everywhere."""
    from dsp_tpu_torch.ops import viterbi as tvit

    args = _lattices(dev, 5, 4, 3, 2000, "left_to_right", seed=1)
    assert torch.equal(kvit.viterbi_score_fused(*args), tvit._viterbi_loop(*args))
    n = ROWS_PAST_THE_GRID
    pi, a, b, lens = _lattices(dev, 4, n, 1, 3, "dense", seed=2)
    flat = (pi[0], a[0], b[:, :, 0], lens[:, 0].long())
    got = kvit.viterbi_score_fused(*flat)
    assert got.shape == (n,) and torch.equal(got, tvit._viterbi_loop(*flat))
    full = kvit.viterbi_score_fused(*flat[:3], None)
    assert torch.equal(full, tvit._viterbi_loop(*flat[:3], torch.tensor(3, device=dev)))
    pi, a, b, lens = _lattices(dev, 16, 6, 2, 30, "dense", seed=3, lengths=[30, 30, 30, 20, 9, 30])
    b = b.clone()
    b[4, 0, 0, 3] = float("nan")
    b[7, 1, 1, 0] = float("inf")
    b[2, 2, :, :] = float("-inf")
    b[25, 3, 0, 5] = float("nan")       # past utterance 3's 20 frames: not read
    b[3, 5, 1, :] = float("inf")
    got, want = kvit.viterbi_score_fused(pi, a, b, lens), tvit._viterbi_loop(pi, a, b, lens)
    assert want.isnan().any() and want.isinf().any()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_viterbi_kernel_never_waits_and_counts_each_launch(dev):
    """At the cell's shape per utterance (11 words, 16 states, T = 198):
    no host sync, ``_build.LAUNCHES`` one a call and ``viterbi_steps``
    T - 1 a call; what the kernel does not take, its wrapper refuses."""
    from dsp_tpu_torch.ops import viterbi as tvit
    from dsp_tpu_torch.utils import profiling

    args = _lattices(dev, 16, 8, 11, 198, "left_to_right", seed=4)
    want = tvit._viterbi_loop(*args)
    before, launched = profiling.counts(), _build.LAUNCHES["viterbi_score"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tvit.viterbi_score(*args) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counted = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
               if k.startswith("viterbi") and v != before.get(k, 0)}
    assert counted == {"viterbi_steps": 3 * 197}
    assert _build.LAUNCHES["viterbi_score"] == launched + 3
    assert all(torch.equal(g, want) for g in got)
    wide = _lattices(dev, 33, 2, 2, 10, "dense", seed=5)
    with pytest.raises(ValueError, match="S <= 32"):
        kvit.viterbi_score_fused(*wide)


def _emission_inputs(dev, lead_x, w, s, m, f=39, seed=0):
    """Rows x [*lead_x, F] and parameters [W, S, M, F] on the card, float32:
    features and means N(0, 3^2), log-variances in log 9 +- 1, mixture
    weights a log-softmax (log-likelihoods of -60 to -700 nats)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)   # noqa: E731
    log_mix = rng.standard_normal((w, s, m))
    log_mix -= np.log(np.exp(log_mix).sum(-1, keepdims=True))
    return (f32(rng.standard_normal((*lead_x, f)) * 3.0),
            f32(rng.standard_normal((w, s, m, f)) * 3.0),
            f32(rng.uniform(-1.0, 1.0, (w, s, m, f)) + np.log(9.0)), f32(log_mix))


def _plain_emissions(x, means, log_var, log_mix):
    """The plain chain (``gmm_loglik_flat`` and ``torch.logsumexp``) in the
    inputs' precision and on their device: ``emission_logb``'s route for
    what the kernel refuses."""
    from dsp_tpu_torch.models import gmm_hmm as pg

    f = means.shape[-1]
    ll = pg.gmm_loglik_flat(x, means.reshape(-1, f), log_var.reshape(-1, f))
    return torch.logsumexp(ll.reshape(*x.shape[:-1], *means.shape[:-1]) + log_mix, dim=-1)


# The kernel sums 39 positive terms (x - mu)^2 / var in order in float32 and
# adds two constants: ~1e-7 relative to the log-likelihood.  1e-5 of
# (1 + |log b|) leaves that a hundredfold and still fails any misplaced row,
# state or mixture, which is off by nats.
EMISSION_TOL = 1e-5


@pytest.mark.parametrize("lead_x, w, s, m, f", [
    ((1024, 198), 11, 16, 3, 39),       # the aurora2-hmm.dev1024 request
    ((3, 101), 4, 16, 3, 39),           # 303 rows: no multiple of the 256-row tile
    ((5, 60), 3, 1, 3, 39),             # one state
    ((5, 60), 3, 5, 3, 39),             # five states: stored one by one
    ((5, 60), 3, 16, 1, 39),            # one mixture
    ((5, 60), 3, 6, 8, 39),             # the most mixtures, tiles of 2 states
    ((5, 60), 3, 5, 7, 39),             # 7 mixtures, 5 states
    ((4, 198), 1, 16, 3, 39),           # one word
    ((24,), 10, 5, 3, 39),              # spot_hmm_chunk's [C, F] chunk
    ((2, 300), 2, 40, 3, 39),           # three stages of states in a block
    ((7, 33), 3, 4, 2, 64),             # the most features
    ((7, 33), 3, 4, 2, 13),
])
def test_gmm_emission_kernel_matches_the_float64_plain_chain(dev, lead_x, w, s, m, f):
    """Kernel ``gmm_emissions`` against the plain chain in float64 on the
    same inputs, within ``EMISSION_TOL`` of (1 + |log b|); ``emission_logb``
    takes the kernel (one ``_build.LAUNCHES`` entry) with its bits."""
    from dsp_tpu_torch.kernels import gmm_emissions as kgmm
    from dsp_tpu_torch.models import gmm_hmm as pg

    args = _emission_inputs(dev, lead_x, w, s, m, f, seed=s * 10 + m)
    assert kgmm.refusal(*args) is None
    got = kgmm.gmm_emissions_fused(*args)
    want = _plain_emissions(*(a.double() for a in args))
    assert got.shape == want.shape == (*lead_x, w, s)
    err = float(((got.double() - want).abs() / (1.0 + want.abs())).max())
    assert err <= EMISSION_TOL, err
    before = _build.LAUNCHES["gmm_emissions"]
    assert torch.equal(pg.emission_logb(args[0], pg.HmmParams(None, None, *args[1:])), got)
    assert _build.LAUNCHES["gmm_emissions"] == before + 1


def test_gmm_emission_kernel_keeps_infinities_and_nan_where_the_plain_chain_has_them(dev):
    """A -inf ``log_mix`` entry drops its Gaussian; a state whose every
    ``log_mix`` is -inf gives -inf; a NaN in a row makes that row's every
    state NaN (``torch.logsumexp``'s rules): the same pattern as the
    float64 plain chain, the rest within ``EMISSION_TOL``."""
    from dsp_tpu_torch.kernels import gmm_emissions as kgmm

    x, means, log_var, log_mix = _emission_inputs(dev, (6, 50), 3, 5, 3, seed=9)
    x[2, 17, 4] = float("nan")
    log_mix[1, 2, 0] = float("-inf")
    log_mix[2, 4, :] = float("-inf")
    got = kgmm.gmm_emissions_fused(x, means, log_var, log_mix)
    want = _plain_emissions(*(a.double() for a in (x, means, log_var, log_mix)))
    assert want[2, 17].isnan().all() and want.isnan().sum() == 15
    dropped = want[..., 2, 4]
    assert (dropped[~dropped.isnan()] == float("-inf")).all()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()].double(), want[want.isinf()])
    fin = want.isfinite()
    assert float(((got.double()[fin] - want[fin]).abs() / (1.0 + want[fin].abs())).max()) \
        <= EMISSION_TOL


def test_gmm_emission_kernel_launches_once_a_score_words_and_never_waits(dev):
    """``score_words`` at the cell's widths (11 words x 16 states x 3
    Gaussians, T = 198): one ``gmm_emissions`` and one ``viterbi_score``
    launch a call and no host sync; its scores equal ``viterbi_score`` on
    the kernel's ``log_b``."""
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.ops import viterbi as tvit

    x, means, log_var, log_mix = _emission_inputs(dev, (8, 198), 11, 16, 3, seed=4)
    log_pi, log_a, _, _ = _lattices(dev, 16, 8, 11, 198, "left_to_right", seed=4)
    params = pg.HmmParams(log_pi[0], log_a[0], means, log_var, log_mix)
    lengths = torch.tensor([198, 1, 60, 120, 197, 2, 198, 150], dtype=torch.int32,
                           device=dev)
    logb = pg.emission_logb(x, params)
    want = tvit.viterbi_score(log_pi, log_a, logb.movedim(1, 0), lengths[:, None])
    before = {k: _build.LAUNCHES[k] for k in ("gmm_emissions", "viterbi_score")}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [pg.score_words(x, lengths, params) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: _build.LAUNCHES[k] - n for k, n in before.items()} == \
        {"gmm_emissions": 3, "viterbi_score": 3}
    assert all(torch.equal(g, want) for g in got)


def test_emission_logb_runs_the_plain_chain_on_what_the_kernel_refuses(dev):
    """float64 inputs and 9 mixtures (past the kernel's 8): the plain chain
    op by op on the card, its bits, no ``gmm_emissions`` launch and no
    host sync; the wrapper refuses both."""
    from dsp_tpu_torch.kernels import gmm_emissions as kgmm
    from dsp_tpu_torch.models import gmm_hmm as pg

    double = tuple(a.double() for a in _emission_inputs(dev, (4, 30), 3, 5, 3, seed=5))
    wide = _emission_inputs(dev, (4, 30), 3, 5, 9, seed=6)
    assert "float32" in kgmm.refusal(*double) and "M <= 8" in kgmm.refusal(*wide)
    want = [_plain_emissions(*a) for a in (double, wide)]
    launched = _build.LAUNCHES["gmm_emissions"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [pg.emission_logb(a[0], pg.HmmParams(None, None, *a[1:]))
               for a in (double, wide)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES["gmm_emissions"] == launched
    assert got[0].dtype == torch.float64
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for a, words in ((double, "float32"), (wide, "M <= 8")):
        with pytest.raises(ValueError, match=words):
            kgmm.gmm_emissions_fused(*a)


def test_hmm_recognize_batch_never_waits_and_classify_batch_reads_back_once(dev):
    """Aurora 2's topology (16 states x 3 Gaussians, 8 kHz) on the card:
    ``recognize_batch`` issues no host sync and gives the same bits op by
    op and from its graphs; ``classify_batch`` waits on
    its two copies and its one readback, as ``host_syncs`` counts; labels
    equal and scores at rtol 1e-5 against the CPU on the same models."""
    import warnings

    from dsp_tpu_torch import GmmHmmRecognizer
    from dsp_tpu_torch.config import HmmConfig
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.utils import profiling

    cfg = PipelineConfig(frontend=FrontendConfig(sample_rate=8000, frame_len=200, hop_len=80,
                                                 n_fft=256, n_mels=23, n_mfcc=13),
                         max_samples=16000)
    words = ("zero", "oh", "one")
    train = {w: [synth_word(w, i, sr=8000, max_samples=16000) for i in range(4)] for w in words}
    rec = GmmHmmRecognizer(cfg, HmmConfig(n_states=16, n_mix=3), device=dev)
    rec.fit(train)
    sigs = [synth_word(w, 60 + i, sr=8000, max_samples=16000) for i, w in enumerate(words * 2)]
    x, n = tpl.pad_signals(sigs, cfg.max_samples, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:    # op by op, then captured, then replayed (utils/graphs.py)
        runs = [pg.recognize_batch(x, n, rec.device_params(), cfg) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ids, scores = runs[0]
    assert all(torch.equal(i, ids) and torch.equal(s, scores) for i, s in runs[1:])
    before = profiling.counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            labels, got = rec.classify_batch(sigs, return_scores=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert profiling.counts()["host_syncs"] - before.get("host_syncs", 0) == 3 == len(waits)
    assert np.array_equal(got, scores.cpu().numpy())
    assert labels == [rec.labels[i] for i in ids.cpu().tolist()]
    host = GmmHmmRecognizer(cfg, HmmConfig(n_states=16, n_mix=3), device="cpu")
    host.labels, host.params = rec.labels, pg.HmmParams(*(a.cpu() for a in rec.params))
    want_labels, want = host.classify_batch(sigs, return_scores=True)
    assert labels == want_labels
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _connected_rec(dev):
    """Three digits of Aurora 2's topology (16 states x 3 Gaussians, 8 kHz)
    and a 3-state, 6-Gaussian ``sil`` fitted on the card, a CPU twin on
    the same models, strings of 1-3 digits padded to 3 s, and the digit
    loop with ``sil`` at both ends."""
    from dsp_tpu_torch import GmmHmmRecognizer
    from dsp_tpu_torch.config import HmmConfig
    from dsp_tpu_torch.models import gmm_hmm as pg

    fe8 = FrontendConfig(sample_rate=8000, frame_len=200, hop_len=80, n_fft=256, n_mels=23,
                         n_mfcc=13)
    words = ("zero", "oh", "one")
    rec = GmmHmmRecognizer(PipelineConfig(frontend=fe8, max_samples=16000),
                           HmmConfig(n_states=16, n_mix=3), device=dev)
    rec.fit({w: [synth_word(w, i, sr=8000, max_samples=16000) for i in range(4)]
             for w in words})
    rng = np.random.default_rng(3)
    rec.fit_silence([0.005 * rng.standard_normal(4000).astype(np.float32) for _ in range(8)])
    host = GmmHmmRecognizer(rec.cfg, rec.hmm, device="cpu")
    host.labels = rec.labels
    host.params, host.sil = (pg.HmmParams(*(a.cpu() for a in p)) for p in (rec.params, rec.sil))
    sigs = [synth_connected([words[(i + j) % 3] for j in range(1 + i % 3)], 40 + i, sr=8000,
                            gap_ms=(0.0, 100.0), lead_ms=(100.0, 500.0)) for i in range(6)]
    grammar = {"start": "sil", "end": "sil", "forbidden": [["sil", "sil"]]}
    cfg = PipelineConfig(frontend=fe8, max_samples=24000, use_vad=False)
    return rec, host, sigs, grammar, cfg


def test_connected_level_batch_on_the_card_never_waits_and_matches_the_cpu(dev):
    """``recognize_level_batch`` on the card: op by op, captured, then
    replayed (``utils/graphs.py``) with no host sync and the same bits each
    time; two ``gmm_emissions`` launches a call (one a topology); ids and
    counts equal to the CPU's on the same models and final scores at rtol
    1e-5; the batched backtrace equal to ``backtrack_grammar`` on the
    card's planes read back."""
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.ops import connected_viterbi as cv

    rec, host, sigs, grammar, cfg = _connected_rec(dev)
    masks = rec.resolve_grammar(grammar)
    x, n = tpl.pad_signals(sigs, cfg.max_samples, dev)
    net, levels = rec.network(), 6
    m_dev = tuple(torch.as_tensor(m, device=dev) for m in masks)
    before = _build.LAUNCHES.get("gmm_emissions", 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [pg.recognize_level_batch(x, n, net, cfg, m_dev, levels) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES["gmm_emissions"] - before == 6
    ids, counts, final = runs[0]
    assert all(all(torch.equal(a, b) for a, b in zip(r, runs[0])) for r in runs[1:])
    want = pg.recognize_level_batch(x.cpu(), n.cpu(), host.network(), cfg,
                                    tuple(torch.as_tensor(m) for m in masks), levels)
    assert torch.equal(ids.cpu(), want[0]) and torch.equal(counts.cpu(), want[1])
    live = want[2] > -1e29
    assert torch.equal(final.cpu() > -1e29, live) and bool((counts > 0).all())
    np.testing.assert_allclose(final.cpu()[live].numpy(), want[2][live].numpy(), rtol=1e-5)
    feats = tpl.extract_recording_features(x, n, cfg, 298)
    scores, starts = cv.level_dp(pg.network_logb(feats.feats, net), net.log_pi, net.log_a,
                                 m_dev[0], m_dev[1], levels)
    lens = feats.length.cpu().numpy()
    for b in range(len(sigs)):
        seq, cost = tlb.backtrack_grammar(-scores[b].cpu().numpy(), starts[b].cpu().numpy(),
                                          masks[1], masks[2], int(lens[b]))
        assert seq == ids[b, :counts[b]].tolist()
        assert cost == -final[b, counts[b] - 1].item()


def test_classify_connected_level_reads_back_once_on_the_card(dev):
    """``classify_connected(method="level")`` on the card waits on the
    grammar's one copy, and on its two copies and its one readback a group
    of padded length, as ``host_syncs`` counts, and
    gives the CPU's labels, ``sil`` dropped."""
    import warnings

    from dsp_tpu_torch.utils import profiling

    rec, host, sigs, grammar, _ = _connected_rec(dev)
    before = profiling.counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            labels = rec.classify_connected(sigs, max_segments=6, method="level",
                                            grammar=grammar)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    waits_expected = 1 + 3 * len(tpl.group_by_padded_len(sigs, rec.cfg.max_samples))
    assert profiling.counts()["host_syncs"] - before.get("host_syncs", 0) == waits_expected
    assert len(waits) == waits_expected
    assert labels == host.classify_connected(sigs, max_segments=6, method="level",
                                             grammar=grammar)
    assert all(labels) and not any("sil" in ls for ls in labels)


def _hmm_pair(dev):
    """A small GMM-HMM fitted on the card, and a CPU recognizer on its
    parameters and UBM."""
    from dsp_tpu_torch import GmmHmmRecognizer
    from dsp_tpu_torch.config import HmmConfig
    from dsp_tpu_torch.models import gmm_hmm as pg

    hmm = HmmConfig(n_states=4, n_mix=2, n_iter=3)
    rec = GmmHmmRecognizer(PipelineConfig(), hmm, device=dev)
    rec.fit({w: [synth_word(w, i) for i in range(3)] for w in ("zero", "one", "two")})
    host = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    host.labels = rec.labels
    host.params = pg.params_from_numpy(pg.params_to_numpy(rec.params), "cpu")
    host.ubm = pg.ubm_from_numpy([a.cpu().numpy() for a in rec.ubm], "cpu")
    return rec, host


def test_spot_hmm_chunk_never_waits_for_the_card(dev):
    """The keyword/filler column update on the card: no call waits for the
    card (``n_valid`` an int tensor on the card, then an int); witnesses
    equal to the CPU's on the same rows and parameters, LLRs at
    chip_smoke.py's HMM_SPOT_LLR_TOL."""
    from dsp_tpu_torch.ops import spot_hmm as tsh

    rec, host = _hmm_pair(dev)
    w, s = rec.params.log_pi.shape
    rows = np.random.default_rng(0).normal(0.0, 3.0, (24, 39)).astype(np.float32)
    buf = torch.from_numpy(rows).to(dev)
    state = tsh.spot_hmm_init(w, s, dev)
    n_valid = torch.tensor(20, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, llr, start = tsh.spot_hmm_chunk(state, buf, n_valid, rec.params, rec.ubm)
        state, llr2, start2 = tsh.spot_hmm_chunk(state, buf, 7, rec.params, rec.ubm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = tsh.spot_hmm_init(w, s, "cpu")
    for n, got_l, got_s in ((20, llr, start), (7, llr2, start2)):
        ref, want_l, want_s = tsh.spot_hmm_chunk(ref, torch.from_numpy(rows), n,
                                                 host.params, host.ubm)
        assert torch.equal(got_s.cpu(), want_s)
        torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-3, atol=1e-2)
    assert int(state.n_fed) == 27


def test_cascade_rerank_launches_kernel_3(dev):
    """``CascadeSpotter`` on the card reranks through kernel 3 and gives the
    CPU cascade's rescored events (labels and spans equal, scores rtol
    2e-4, phase cascade's rule)."""
    from dsp_tpu_torch.models import CascadeSpotter, StreamingCascadeSpotter

    rec, host = _hmm_pair(dev)
    bank = _small_bank(["zero", "one"], 3, dev)
    bank_cpu = KnnDtwRecognizer.from_arrays(np.stack(bank._bank_feats), bank._bank_lens,
                                            bank._bank_label_ids, bank.labels, PipelineConfig(),
                                            device="cpu")
    sig, _ = synth_spotting_stream(["zero", "one"], ["zero", "one", "two", "three", "four"],
                                   seed=7, n_words=5)
    before = _build.LAUNCHES["spot_subseq"]
    got, = CascadeSpotter(rec, bank).rescored([sig])
    assert _build.LAUNCHES["spot_subseq"] > before
    want, = CascadeSpotter(host, bank_cpu).rescored([sig])
    assert got and [ev[:3] for ev in got] == [ev[:3] for ev in want]
    for g, w in zip(got, want):
        assert g[3] == pytest.approx(w[3], rel=2e-4)
    before = _build.LAUNCHES["spot_subseq"]
    streamed = _feed_all(StreamingCascadeSpotter(rec, bank), sig, tail=True)
    assert _build.LAUNCHES["spot_subseq"] > before
    offline, = CascadeSpotter(rec, bank).spot([sig])
    assert [ev[0] for ev in streamed] == [ev[0] for ev in offline]
    for g, w in zip(streamed, offline):
        assert abs(g[1] - w[1]) <= 3 and abs(g[2] - w[2]) <= 3


# ------------------------------------------------------------ connected words
def _connected_batch(n=6):
    from dsp_tpu_torch.io import DIGITS

    sigs = [synth_connected([DIGITS[(i + j) % 10] for j in range(1 + i % 5)], 300 + i)
            for i in range(n)]
    x = np.zeros((n, 96_000), np.float32)
    for i, sig in enumerate(sigs):
        x[i, :min(len(sig), 96_000)] = sig[:96_000]
    lens = np.asarray([min(len(sig), 96_000) for sig in sigs], np.int64)
    lens[-1] = 0
    return torch.from_numpy(x), torch.from_numpy(lens)


@pytest.mark.parametrize("mode", ["noise_mult", "two_pass"])
def test_detect_segments_on_the_card_matches_the_cpu(dev, mode):
    x, n = _connected_batch()
    vcfg = VadConfig(threshold_mode=mode)
    for s in (3, 8):
        got = tvad.detect_segments(x.to(dev), FrontendConfig(), vcfg, n.to(dev), s)
        want = tvad.detect_segments(x, FrontendConfig(), vcfg, n, s)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _level_inputs(dev, b, t, k=8, u=20, f=39, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, f)).astype(np.float32))
    bank = torch.from_numpy(rng.standard_normal((k, u, f)).astype(np.float32))
    lens = torch.from_numpy(rng.integers(3, u + 1, k).astype(np.int32))
    return (q, bank, lens), (q.to(dev), bank.to(dev), lens.to(dev))


def _check_planes(got_costs, want_costs, got_ids, want_ids):
    got_costs, want_costs = got_costs.cpu().numpy(), want_costs.numpy()
    live = want_costs < tlb.BIG / 2
    assert np.array_equal(got_costs < tlb.BIG / 2, live)
    np.testing.assert_allclose(got_costs[live], want_costs[live], rtol=1e-4)
    for g, w in zip(got_ids, want_ids):
        assert (g.cpu().numpy() != w.numpy())[live].mean() < 0.01


@pytest.mark.parametrize("squared", [False, True])
def test_level_build_on_the_card_matches_the_cpu(dev, squared):
    cpu, card = _level_inputs(dev, 3, 60)
    got = tlb.level_build(card[0], None, *card[1:], 4, 0.5, squared)
    want = tlb.level_build(cpu[0], None, *cpu[1:], 4, 0.5, squared)
    _check_planes(got[0], want[0], got[1:], want[1:])
    start = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    pairs = torch.from_numpy(np.random.default_rng(1).random((8, 8)) < 0.6)
    got = tlb.level_build_grammar(card[0], None, *card[1:], start.to(dev),
                                  pairs.to(dev), 4, 0.5, squared)
    want = tlb.level_build_grammar(cpu[0], None, *cpu[1:], start, pairs, 4, 0.5, squared)
    _check_planes(got[0], want[0], got[1:], want[1:])


def test_level_build_chunk_on_the_card_equals_the_batch(dev):
    cpu, card = _level_inputs(dev, 1, 45, seed=2)
    want = tlb.level_build(card[0], None, *card[1:], 3, 0.7)
    for chunk in (1, 7, 45):
        state, parts = tlb.level_stream_init(3, 8, 20, dev), []
        for lo in range(0, 45, chunk):
            state, planes = tlb.level_build_chunk(state, card[0][0, lo:lo + chunk],
                                                  *card[1:], 0.7)
            parts.append(planes)
        for i, w in enumerate(want):
            assert torch.equal(torch.cat([p[i] for p in parts], dim=1), w[0])
    cpu_want = tlb.level_build(cpu[0], None, *cpu[1:], 3, 0.7)
    _check_planes(want[0], cpu_want[0], want[1:], cpu_want[1:])


def test_connected_dps_never_wait_for_the_card(dev):
    from dsp_tpu_torch.ops.connected_viterbi import connected_viterbi

    _, card = _level_inputs(dev, 2, 12)
    rec, _ = _hmm_pair(dev)
    x, n = _connected_batch(2)
    x, n = x.to(dev), n.to(dev)
    state = tlb.level_stream_init(2, 8, 20, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tlb.level_build(card[0], None, *card[1:], 2)
        tlb.level_build_chunk(state, card[0][0, :5], *card[1:])
        connected_viterbi(card[0], None, rec.params, 2)
        tpl.extract_segments_features(x, n, PipelineConfig(), 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_connected_decoders_on_the_card_match_the_cpu(dev):
    from dsp_tpu_torch.models.streaming import StreamingConnectedRecognizer

    rec = _small_bank(["zero", "one", "two", "three"], 2, dev)
    rec_cpu = KnnDtwRecognizer.from_arrays(np.stack(rec._bank_feats), rec._bank_lens,
                                           rec._bank_label_ids, rec.labels, PipelineConfig(),
                                           device="cpu")
    clips = [synth_connected(["two", "zero", "three"], 5), synth_connected(["one"], 6),
             synth_connected(["three", "one"], 7, gap_ms=(0.0, 1.0), lead_ms=(50.0, 60.0))]
    before = dict(_build.LAUNCHES)
    got = rec.classify_connected(clips, max_segments=4, return_segments=True)
    assert _build.LAUNCHES["dtw_banded"] - before["dtw_banded"] == 1
    want = rec_cpu.classify_connected(clips, max_segments=4, return_segments=True)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w)
    before = dict(_build.LAUNCHES)
    for grammar in (None, {"no_repeat": True}):
        level = rec.classify_connected(clips, max_segments=4, method="level",
                                       grammar=grammar)
        assert level == rec_cpu.classify_connected(clips, max_segments=4, method="level",
                                                   grammar=grammar)
    assert level[2] == ["three", "one"] and dict(_build.LAUNCHES) == before
    sig = np.concatenate([synth_connected(["three", "one"], 11, gap_ms=(0.0, 1.0),
                                          lead_ms=(120.0, 130.0)),
                          np.zeros(4800, np.float32)])
    events = _feed_all(StreamingConnectedRecognizer(rec, max_levels=4), sig)
    assert events == _feed_all(StreamingConnectedRecognizer(rec_cpu, max_levels=4), sig)
    assert [w for ev in events for w in ev[0]] == ["three", "one"]


def _cpu_twin(rec):
    return KnnDtwRecognizer.from_arrays(np.stack(rec._bank_feats), rec._bank_lens,
                                        rec._bank_label_ids, rec.labels, rec.cfg,
                                        device="cpu")


def test_lpcc_on_the_card_matches_the_cpu(dev):
    cfg = PipelineConfig(frontend=FrontendConfig(feature_type="lpcc"))
    sigs = [synth_word(lab, 40 + i) for i, lab in enumerate(["one", "six", "nine"] * 2)]
    x, n = tpl.pad_signals(sigs, cfg.max_samples, "cpu")
    want = tpl.extract_features(x, n, cfg)
    before = dict(_build.LAUNCHES)
    for impl in ("xla", "pallas"):
        c = dataclasses.replace(cfg, frontend=FrontendConfig(feature_type="lpcc",
                                                             impl=impl))
        got = tpl.extract_features(x.to(dev), n.to(dev), c)
        assert torch.equal(got.length.cpu(), want.length)
        np.testing.assert_allclose(got.feats.cpu().numpy(), want.feats.numpy(),
                                   rtol=1e-3, atol=1e-3)
    assert dict(_build.LAUNCHES) == before          # LPCC takes no kernel 2
    rec = KnnDtwRecognizer(cfg, device=dev)
    for lab in ("one", "six", "nine"):
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    labels = rec.classify_batch(sigs)
    assert _build.LAUNCHES["dtw_banded"] - before["dtw_banded"] == 1
    assert labels == _cpu_twin(rec).classify_batch(sigs)


def test_condense_on_the_card_matches_the_cpu(dev):
    from dsp_tpu_torch.ops import align as talign

    labels = ["zero", "one", "two", "three"]
    for method in ("medoid", "dba"):
        rec = _small_bank(labels, 3, dev)
        host = _cpu_twin(rec)
        before = _build.LAUNCHES["dtw_banded"]
        rec.condense(method)
        # one unbanded kernel-1 launch a label's medoid batch
        assert _build.LAUNCHES["dtw_banded"] - before == len(labels)
        host.condense(method)
        assert rec._bank_lens == host._bank_lens
        np.testing.assert_allclose(np.stack(rec._bank_feats), np.stack(host._bank_feats),
                                   rtol=1e-4, atol=1e-4)
        queries = [synth_word(lab, 30 + i) for i, lab in enumerate(labels * 2)]
        assert rec.classify_batch(queries) == host.classify_batch(queries)
    # the DBA sums are GEMMs: two runs give the same bits
    bank, _ = _small_bank(labels[:1], 4, dev).device_bank()
    cfg = DtwConfig(band_frac=None)
    runs = [talign.dba_average(bank.feats, bank.length, bank.feats[0],
                               int(bank.length[0]), 3, cfg) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_vq_on_the_card_matches_the_cpu(dev):
    from dsp_tpu_torch.config import VqConfig
    from dsp_tpu_torch.models import vq as tvq

    corpus = {lab: [synth_word(lab, i) for i in range(3)] for lab in ("zero", "one", "two")}
    rec = tvq.VqRecognizer(PipelineConfig(), VqConfig(n_codes=16, n_iter=5), device=dev)
    for lab, sigs in corpus.items():
        rec.enroll(lab, sigs)
    frames, mask = rec.pooled_frames()
    init = tvq.kmeans_init(frames, mask, 16)
    got = tvq.lloyd_step(frames, mask, init)
    fc, mc, ic = frames.cpu(), mask.cpu(), init.cpu()
    assert torch.equal(torch.argmin(tvq._sq_dists(frames, init), dim=-1).cpu(),
                       torch.argmin(tvq._sq_dists(fc, ic), dim=-1))
    np.testing.assert_allclose(got.cpu().numpy(), tvq.lloyd_step(fc, mc, ic).numpy(),
                               rtol=0, atol=1e-5)
    rec.fit()
    host = tvq.VqRecognizer(PipelineConfig(), VqConfig(n_codes=16, n_iter=5),
                            device="cpu")
    host.labels, host.codebooks = rec.labels, rec.codebooks
    queries = [synth_word(lab, 30 + i) for i, lab in enumerate(list(corpus) * 3)]
    before = dict(_build.LAUNCHES)
    assert rec.classify_batch(queries) == host.classify_batch(queries)
    assert dict(_build.LAUNCHES) == before          # VQ takes no kernel


def test_condense_and_vq_default_to_the_card(dev):
    from dsp_tpu_torch import VqRecognizer

    rec = KnnDtwRecognizer()
    for lab in ("zero", "one"):
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    before = _build.LAUNCHES["dtw_banded"]
    rec.condense("dba", n_iter=1)
    assert _build.LAUNCHES["dtw_banded"] - before == 2
    assert rec.device_bank()[0].feats.device.type == "cuda"
    vq = VqRecognizer()
    vq.fit({lab: [synth_word(lab, i) for i in range(2)] for lab in ("zero", "one")})
    assert vq.extract([synth_word("one", 9)]).feats.device.type == "cuda"
    assert vq.recognize(synth_word("one", 9)) in ("zero", "one")


def test_cli_evaluate_on_the_card_equals_the_cpu(dev, tmp_path, capsys):
    """``python -m dsp_tpu_torch evaluate`` at its default device (the
    card) prints what ``--device cpu`` prints, through kernel 1."""
    from dsp_tpu_torch import cli

    d = str(tmp_path / "corpus")
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3"])
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"), "--bank", bank])
    outs = []
    for pre in ([], ["--device", "cpu"]):
        capsys.readouterr()
        before = _build.LAUNCHES["dtw_banded"]
        cli.main([*pre, "evaluate", "--corpus", os.path.join(d, "test"), "--bank", bank])
        torch.cuda.synchronize()
        outs.append((capsys.readouterr().out, _build.LAUNCHES["dtw_banded"] - before))
    (card, n_card), (cpu, n_cpu) = outs
    assert card == cpu and "accuracy: 1.0000 (6 utterances)" in card
    assert n_card >= 1 and n_cpu == 0


# the measurement scripts at a cut: (script, arguments, kernels it must launch)
MEASURE_RUNS = [
    ("fe_profile", ["--chunk", "32", "--templates", "20", "--iters", "2", "--passes", "2"],
     ("dtw_banded",)),
    ("mb_long_t", ["--t", "198", "--iters", "2"], ("dtw_banded", "dtw_fused")),
    ("mb_fused_banded", ["--b", "16", "--iters", "2"], ("dtw_banded",)),
    ("mb_spot_fused", ["--b", "8", "--k", "20", "--iters", "2", "--passes", "2", "--scan"],
     ("spot_subseq",)),
]


@pytest.mark.parametrize("name,argv,kernels", MEASURE_RUNS)
def test_measurement_scripts_on_the_card(dev, capsys, name, argv, kernels):
    """Each CUDA-event script runs on the card, launches its kernels and
    holds each kernel row to its plain version (the ``mb_*`` scripts raise
    on a mismatch); ``fe_profile``'s ``full`` labels are ``dtw``'s."""
    import importlib

    mod = importlib.import_module(f"dsp_tpu_torch.scripts.{name}")
    _build.reset_launches()
    out = mod.main(argv)
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[k] for k in kernels), dict(_build.LAUNCHES)
    assert "NVIDIA" in capsys.readouterr().out.splitlines()[0]
    if name == "fe_profile":
        assert torch.equal(out["outputs"]["full"][0], out["outputs"]["dtw"][0])
        assert all(v > 0 for v in out["ms"].values())
    elif name == "mb_long_t":
        row, = out
        assert row["kernel"] > 0 and row["unbanded"] > 0 and row["scan"] > row["kernel"]
        assert row["kernel_max_rel_err"] <= 1e-4 and row["unbanded_max_rel_err"] <= 1e-4
    elif name == "mb_fused_banded":
        assert [r["b"] for r in out] == [1, 2, 4, 8, 16] * 3
        assert [r["warps"] for r in out[:5]] == [1, 2, 3, 5, 14]
        assert all(r["max_rel_err"] <= 1e-4 for r in out)
    else:
        assert out["check"]["flip_share"] < 1e-3 and out["scan"]["ms"] > out["fused"]["ms"] > 0


BENCH_TINY = dict(BENCH_UTTS="8", BENCH_CHUNK="4", BENCH_TEMPLATES="10", BENCH_PASSES="2")


def _bench_keep(monkeypatch, dev, dispatch):
    from dsp_tpu_torch import bench

    for k, v in dict(BENCH_TINY, BENCH_DISPATCH=dispatch).items():
        monkeypatch.setenv(k, v)
    keep = {}
    bench.bench_body(dev, keep)
    torch.cuda.synchronize()
    return keep


def test_bench_single_graph_equals_chunked(dev, monkeypatch):
    """``BENCH_DISPATCH=single``: the CUDA graph's last-chunk labels and
    distances equal the chunked run's bit for bit (the same kernels in the
    same order)."""
    got, want = (_bench_keep(monkeypatch, dev, d) for d in ("single", "chunked"))
    assert torch.equal(got["labels"], want["labels"])
    assert torch.equal(got["dists"], want["dists"])


def test_bench_graph_replays_agree(dev):
    """One capture of two chunks counts kernel 1 twice; two replays give
    the same outputs, and replays count nothing."""
    from dsp_tpu_torch import bench

    cfg = bench.config()
    bank_sigs, bank_ns, ids, chunks, qn = bench.inputs(8, 10, 4, cfg, dev)
    bank = tpl.extract_features(bank_sigs, bank_ns, cfg)

    def run_chain():
        return [tpl.recognize_batch(c, qn, bank, ids, cfg) for c in chunks]

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        want = run_chain()
    torch.cuda.current_stream(dev).wait_stream(stream)
    _build.reset_launches()
    replay = bench.capture(run_chain, stream)
    assert _build.LAUNCHES["dtw_banded"] == len(chunks) == 2
    first = [(lab.clone(), d.clone()) for lab, d in replay()]
    second = replay()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dtw_banded"] == 2
    for (lab1, d1), (lab2, d2), (lab0, d0) in zip(first, second, want):
        assert torch.equal(lab1, lab2) and torch.equal(d1, d2)
        assert torch.equal(lab1, lab0) and torch.equal(d1, d0)


def test_fresh_process_after_warm_builds_nothing(dev, tmp_path):
    """``python -m dsp_tpu_torch warm`` on an empty kernel cache builds the
    library there; a later process classifies through kernel 1 and builds
    nothing.  Both processes point ``_build.BUILD_DIR`` at ``tmp_path``,
    so the library that earlier tests left in ``build/`` cannot stand in
    for the one ``warm`` builds."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    at = ("import sys\nfrom pathlib import Path\n"
          "from dsp_tpu_torch.kernels import _build\n"
          "_build.BUILD_DIR = Path(sys.argv[1])\n")
    w = subprocess.run([sys.executable, "-c", at + "from dsp_tpu_torch import cli\n"
                        "cli.main(sys.argv[2:])\n", str(tmp_path), "warm", "--bank-size",
                        "10", "--batches", "1"], cwd=repo, capture_output=True, text=True,
                       timeout=600)
    assert w.returncode == 0, w.stderr
    lines = w.stdout.strip().splitlines()
    libs = list(tmp_path.glob("libdsp_tpu_torch_*.so"))
    assert len(libs) == 1
    assert lines[0].startswith(f"warm: kernels {libs[0]} (built in ") and str(libs[0]) in lines[-1]
    code = (at + "from dsp_tpu_torch import KnnDtwRecognizer\n"
            "from dsp_tpu_torch.io import synth_word\n"
            "rec = KnnDtwRecognizer()\n"
            "for lab in ('zero', 'one'):\n"
            "    rec.enroll(lab, [synth_word(lab, 0)])\n"
            "print(rec.classify_batch([synth_word('one', 5)]), _build.build_seconds,\n"
            "      _build.LAUNCHES['dtw_banded'], _build.library_path() == Path(sys.argv[2]))\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(libs[0])], cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["['one']", "None", "1", "True"]


def test_classify_batch_spans_share_the_trace_clock_and_count_every_wait(dev, tmp_path):
    """``classify_batch`` on the card: the host waits exactly where
    ``host_syncs`` counts (sync-debug warnings: two copies and two
    readbacks a chunk), ``h2d_bytes`` is each chunk's padded clips and
    lengths, and in a profiler trace each kernel-1 launch starts after its
    chunk's ``dsp.dtw`` span starts and each copy to the card starts
    inside a ``dsp.h2d`` span."""
    import json
    import warnings

    from dsp_tpu_torch.utils import profiling

    rec = _small_bank(["one", "two", "three"], 2, dev)
    sigs = [synth_word(w, 40 + i) for i, w in enumerate(["one", "two", "three"] * 3)]
    chunks = 3                                       # 9 clips in chunks of 4
    want = rec.classify_batch(sigs, chunk=4)
    torch.cuda.synchronize()
    before = profiling.counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = rec.classify_batch(sigs, chunk=4, return_distances=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    waits = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert got[0] == want
    assert counted["host_syncs"] == 4 * chunks == len(waits), waits
    assert counted["h2d_bytes"] == chunks * (4 * rec.cfg.max_samples * 4 + 4 * 4)

    with profiling.trace(str(tmp_path)):
        rec.classify_batch(sigs, chunk=4, return_distances=True)
    (path,) = [p for p in tmp_path.iterdir() if p.suffix == ".json"]
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation" and e["name"] == name)

    kernels = sorted(e["ts"] for e in events
                     if e.get("cat") == "kernel" and "dtw_banded" in e["name"])
    copies = sorted(e["ts"] for e in events
                    if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"])
    dtw, h2d = spans("dsp.dtw"), spans("dsp.h2d")
    assert len(spans("dsp.classify_chunk")) == len(dtw) == len(kernels) == chunks
    assert all(k >= s for k, (s, _) in zip(kernels, dtw))
    assert len(copies) == 2 * chunks
    assert all(any(a <= c <= b for a, b in h2d) for c in copies)
