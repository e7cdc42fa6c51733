"""The plain reference against the port's CPU route at a tiny cut."""

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.data import synth
from benchmark.reference import plain

WORDS = ["yes", "no", "marvin", "seven"]


@pytest.mark.parametrize("max_samples", [16000, 32000])
def test_features_and_distances_match_the_port(max_samples):
    from dsp_tpu_torch import pipeline
    from dsp_tpu_torch.config import DtwConfig, PipelineConfig

    bank, bank_ids, pool, _ = synth.cell_inputs(WORDS, 2, 8, 2**31 + 3, 16000, max_samples)
    cfg = PipelineConfig(dtw=DtwConfig(band_frac=0.17, max_warp_scale=2.0),
                         max_samples=max_samples)
    fe = plain.Frontend(16000, "cpu")
    t_max = cfg.max_frames
    q, b = check.side(fe, pool, t_max), check.side(fe, bank, t_max)
    n = torch.full((8,), max_samples, dtype=torch.int32)
    port_q = pipeline.extract_features(torch.from_numpy(pool), n, cfg)
    assert torch.equal(port_q.length.to(torch.int64), q.lens)
    assert torch.allclose(port_q.feats.double(), q.feats, rtol=1e-4, atol=1e-4)
    port_b = pipeline.extract_features(torch.from_numpy(bank),
                                       torch.full((8,), max_samples, dtype=torch.int32), cfg)
    ids, d = pipeline.classify_features(port_q, port_b, torch.from_numpy(bank_ids), cfg=cfg)
    ref = plain.dtw(q.feats, q.lens, b.feats, b.lens, 0.17, 2.0)
    dead = d >= check.DEAD
    assert torch.equal(dead, ~torch.isfinite(ref))
    assert torch.allclose(d.double()[~dead], ref[~dead], rtol=1e-5)
    got = check.compare(ids.numpy(), d.numpy(), bank_ids, q, b, 0.17, 2.0)
    assert got["dist_gap"] < 1e-5 and got["label_errors"] == 0


def test_dtw_against_a_cell_by_cell_loop():
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((2, 12, 3)))
    bt = torch.as_tensor(rng.standard_normal((3, 12, 3)))
    la, lb = torch.tensor([12, 7]), torch.tensor([12, 5, 9])
    got = plain.dtw(a, la, bt, lb, None, None)
    for i in range(2):
        for k in range(3):
            n, m = int(la[i]), int(lb[k])
            c = torch.cdist(a[i, :n], bt[k, :m]).numpy()
            d = np.full((n, m), np.inf)
            for x in range(n):
                for y in range(m):
                    prev = 0.0 if x == y == 0 else min(
                        d[x - 1, y] if x else np.inf, d[x, y - 1] if y else np.inf,
                        d[x - 1, y - 1] if x and y else np.inf)
                    d[x, y] = c[x, y] + prev
            assert got[i, k].item() == pytest.approx(d[-1, -1] / (n + m), rel=1e-12)


def test_vad_margin_moves_a_frame_near_a_threshold_across_it():
    e = torch.ones(1, 60, dtype=torch.float64)
    th = 4.0 * (1.0 + 1e-6)
    e[0, 20:40] = th * (1 + 2e-6)       # above the threshold by less than the margin
    z = torch.zeros_like(e)
    n = torch.tensor([60])
    at = [tuple(int(v) for v in plain.endpoints(e, z, n, s)) for s in
          (1.0, 1.0 - plain.VAD_MARGIN, 1.0 + plain.VAD_MARGIN)]
    assert at[0] == at[1] != at[2]
    assert at[2] == (0, 60)             # nothing found: the whole clip
