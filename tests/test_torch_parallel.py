"""The port's mesh layer in one process (``dsp_tpu_torch/parallel``): the
factoring rules and errors of ``make_mesh``, the placement helpers, the
type check on ``mesh=``, ``multihost`` in a single process and its raise
on a failed init, and every ``mesh=`` entry point on a one-rank gloo mesh
against the same call without a mesh.

The one-rank world lives in this pytest process (a local store, as a plain
``python`` process gets from ``make_mesh()``) and is destroyed at the
module's end.  On one rank the sharded paths compute the unsharded
shapes, so their results are held bit-equal to the single-device path's.
The multi-rank worlds are in tests/test_torch_mesh_*.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dsp_tpu_torch import GmmHmmRecognizer, KeywordSpotter, KnnDtwRecognizer
from dsp_tpu_torch import PipelineConfig, VqRecognizer
from dsp_tpu_torch import parallel as par
from dsp_tpu_torch.config import HmmConfig, VqConfig
from dsp_tpu_torch.io import synth_connected, synth_word
from dsp_tpu_torch.parallel import mesh as pmesh
from dsp_tpu_torch.parallel import multihost

import torch_mesh_rank as ranks

ROOT = Path(__file__).resolve().parent.parent
LABELS = ["zero", "one", "two"]
QUERIES = [synth_word(LABELS[i % 3], 40 + i) for i in range(5)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the single-device references here are loops of
    small ops, which crawl when parallel test workers (and this file's
    rank processes) oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) gloo mesh in this process, torn down after the module."""
    own = not dist.is_initialized()
    m = par.make_mesh(device="cpu")
    yield m
    if own and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def recs(mesh):
    plain = KnnDtwRecognizer(PipelineConfig(), device="cpu")
    for lab in LABELS:
        plain.enroll(lab, [synth_word(lab, i) for i in range(2)])
    meshed = KnnDtwRecognizer.from_arrays(
        np.stack(plain._bank_feats), plain._bank_lens, plain._bank_label_ids,
        plain.labels, PipelineConfig(), device="cpu", mesh=mesh)
    return plain, meshed


def test_failed_init_raises_instead_of_running_as_one_process():
    """WORLD_SIZE > 1 and no rendezvous: the JAX package warns and goes on
    as one process; the port raises (ROADMAP.md queue 3)."""
    env = dict(os.environ, WORLD_SIZE="2", RANK="1", LOCAL_RANK="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ranks.free_port()),
               PYTHONPATH=str(ROOT))
    code = ("from dsp_tpu_torch.parallel import multihost\n"
            "multihost.initialize(device='cpu', timeout_s=1)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "distributed init failed for rank 1 of 2" in proc.stderr


def test_initialize_single_process_is_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(num_processes=1, process_id=0)
    multihost.initialize(device="cpu")          # no torchrun environment
    assert not dist.is_initialized() or dist.get_world_size() == 1


def test_helpers_without_a_group():
    assert not dist.is_initialized()
    assert multihost.is_primary()
    assert multihost.all_hosts_agree(0.875)
    assert multihost._min_max_across_hosts(0.75) == (0.75, 0.75)
    assert multihost.jnp_mean_across_hosts(2.0) == 2.0


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        par.make_mesh(device="cuda")
    with pytest.raises(ValueError, match="no mesh backend"):
        multihost.backend_for("meta")


def test_make_mesh_factoring_and_errors(mesh):
    assert isinstance(mesh, DeviceMesh)
    assert mesh.mesh_dim_names == (par.DATA_AXIS, par.BANK_AXIS) == ("data", "bank")
    assert pmesh.mesh_shape(mesh) == (1, 1) and pmesh.coordinate(mesh) == (0, 0)
    assert dist.get_backend() == "gloo" and mesh.device_type == "cpu"
    for kw in ({"data": 1}, {"bank": 1}, {"data": 1, "bank": 1}):
        assert pmesh.mesh_shape(par.make_mesh(device="cpu", **kw)) == (1, 1)
    for kw in ({"bank": 1024}, {"data": 1024}, {"data": 0, "bank": 1}):
        with pytest.raises(ValueError, match="invalid for 1 ranks"):
            par.make_mesh(device="cpu", **kw)
    assert multihost.is_primary()
    lo, hi = multihost._min_max_across_hosts(0.75)
    assert lo == hi == 0.75
    assert multihost.all_hosts_agree(0.875)
    assert multihost.jnp_mean_across_hosts(2.0) == 2.0


def test_placement_helpers(mesh):
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert torch.equal(par.shard_queries(mesh, x), torch.from_numpy(x))
    a, b = par.shard_bank(mesh, x, torch.arange(6))
    assert a.shape == (6, 2) and torch.equal(b, torch.arange(6))
    assert torch.equal(par.replicate(mesh, x), torch.from_numpy(x))
    assert torch.equal(pmesh.shard_flat(mesh, x), torch.from_numpy(x))
    padded, n = par.pad_axis_to_multiple(x, 4)
    assert n == 6 and padded.shape == (8, 2) and not padded[6:].any()
    assert par.pad_axis_to_multiple(x, 3)[0] is x
    tp, n = pmesh.pad_rows_to_multiple(torch.from_numpy(x), 4)
    assert n == 6 and torch.equal(tp[:6], torch.from_numpy(x)) and not tp[6:].any()
    t = torch.ones(3)
    assert torch.equal(pmesh.gather(t, mesh, "bank"), t)
    assert torch.equal(pmesh.gather_stack(t, mesh, "data"), t[None])
    assert torch.equal(pmesh.psum(t, mesh, "data"), t)


@pytest.mark.parametrize("bad", [object(), "mesh", 3])
def test_non_mesh_is_a_type_error(bad):
    with pytest.raises(TypeError, match="DeviceMesh"):
        KnnDtwRecognizer(PipelineConfig(), device="cpu", mesh=bad)
    with pytest.raises(TypeError, match="DeviceMesh"):
        par.classify_sharded(bad, None, None, None, None, None)


def test_classify_entry_points_on_one_rank(recs):
    plain, meshed = recs
    want, want_d = plain.classify_batch(QUERIES, return_distances=True)
    got, got_d = meshed.classify_batch(QUERIES, return_distances=True)
    assert got == want == [LABELS[i % 3] for i in range(5)]
    np.testing.assert_array_equal(got_d, want_d)
    assert meshed.classify_nbest(QUERIES) == plain.classify_nbest(QUERIES)
    # chunked like the single-device path: the same labels
    assert meshed.classify_batch(QUERIES, chunk=2) == want
    meshed.calibrate_rejection()
    plain.calibrate_rejection()
    assert meshed.classify_batch(QUERIES, reject=True) == \
        plain.classify_batch(QUERIES, reject=True)
    with pytest.raises(ValueError, match="not supported with a mesh"):
        KnnDtwRecognizer(PipelineConfig(), device="cpu", mesh=meshed.mesh,
                         matcher="ltw").classify_batch(QUERIES)


def test_connected_and_spotting_on_one_rank(recs):
    plain, meshed = recs
    sigs = [synth_connected(["two", "zero"], seed=5), synth_connected(["one"], seed=9)]
    for kw in ({}, {"method": "level"},
               {"method": "level", "grammar": {"no_repeat": True}}):
        assert meshed.classify_connected(sigs, max_segments=3, **kw) == \
            plain.classify_connected(sigs, max_segments=3, **kw)
    a, b = KeywordSpotter(plain).scores(sigs), KeywordSpotter(meshed).scores(sigs)
    for (na, sa), (nb, sb) in zip(a, b):
        np.testing.assert_array_equal(na, nb)
        np.testing.assert_array_equal(sa, sb)
    bad = KnnDtwRecognizer(PipelineConfig(), device="cpu")
    bad.mesh = object()
    with pytest.raises(TypeError, match="DeviceMesh"):
        KeywordSpotter(bad)


def test_hmm_and_vq_on_one_rank(mesh):
    train = {lab: [synth_word(lab, i) for i in range(3)] for lab in LABELS}
    hmm = HmmConfig(n_states=3, n_mix=2, n_iter=2)
    plain = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    plain.fit(train)
    meshed = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu", mesh=mesh)
    meshed.fit(train, mesh=mesh)
    for a, b in zip(plain.params, meshed.params):
        assert torch.equal(a, b)
    want, want_s = plain.classify_batch(QUERIES, return_scores=True)
    got, got_s = meshed.classify_batch(QUERIES, return_scores=True)
    assert got == want
    np.testing.assert_array_equal(got_s, want_s)
    meshed.noise_adapt = True
    with pytest.raises(ValueError, match="noise_adapt with a mesh"):
        meshed.classify_batch(QUERIES)
    vq = VqRecognizer(PipelineConfig(), VqConfig(n_codes=8, n_iter=2), device="cpu")
    vq.fit(train)
    want, want_d = vq.classify_batch(QUERIES, return_distances=True)
    vq.mesh = mesh
    got, got_d = vq.classify_batch(QUERIES, return_distances=True)
    assert got == want
    np.testing.assert_array_equal(got_d, want_d)
