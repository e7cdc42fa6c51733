"""Multi-rank gloo worlds for the port's mesh tests.

``run_world`` (called by ``tests/test_torch_mesh_*.py``) writes a test's
inputs to an ``.npz`` and starts ``world`` copies of this file as
subprocesses with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so that
``dsp_tpu_torch.parallel.multihost.initialize()`` takes its environment
path.  Each rank runs one scenario below on every mesh shape it is given
and writes its outputs to ``out_<rank>.npz``.  A rank that raises prints
its traceback and exits 1; the launcher then kills the other ranks (which
would wait in a collective) and reports that rank's output.  Every wait
has a deadline.

A rank imports torch, numpy and ``dsp_tpu_torch`` only, and asserts that
neither ``jax`` nor ``dsp_tpu`` got imported.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- launcher
def free_port() -> int:
    """A TCP port nothing listens on now (the rendezvous of one world)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pack_signals(prefix: str, signals) -> dict:
    """Ragged 1-D signals -> two arrays an ``.npz`` can hold."""
    n = max(1, max(len(s) for s in signals))
    out = np.zeros((len(signals), n), np.float32)
    for i, s in enumerate(signals):
        out[i, :len(s)] = s
    return {prefix: out,
            prefix + "_len": np.asarray([len(s) for s in signals], np.int64)}


def unpack_signals(inp: dict, prefix: str) -> list:
    return [row[:n] for row, n in zip(inp[prefix], inp[prefix + "_len"])]


def run_world(workdir, world: int, scenario: str, inputs: dict,
              deadline_s: float = 150.0) -> list[dict]:
    """Run ``scenario`` on a ``world``-rank gloo world; returns each rank's
    outputs.  Raises AssertionError with the first failing rank's log, or
    after ``deadline_s`` with every rank killed."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "in.npz", **inputs)
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(ROOT),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        log = open(workdir / f"log_{r}.txt", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(workdir), scenario], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)))
    end = time.monotonic() + deadline_s
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes) if c not in (None, 0)),
                          None)
            if failed is not None or None not in codes or time.monotonic() > end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:              # the rest would wait in a collective
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed is not None:
        text = (workdir / f"log_{failed}.txt").read_text()
        raise AssertionError(f"rank {failed} of {world} failed "
                             f"({scenario}):\n{text[-6000:]}")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{scenario} world of {world} passed its "
                             f"{deadline_s:.0f} s deadline; rank 0 log:\n"
                             + (workdir / "log_0.txt").read_text()[-4000:])
    return [dict(np.load(workdir / f"out_{r}.npz")) for r in range(world)]


@contextlib.contextmanager
def one_rank_mesh():
    """A (1, 1) gloo mesh in this process (``make_mesh``'s one-rank group on
    a local store), destroyed on exit."""
    import torch.distributed as dist

    from dsp_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized(), "a process group is already running"
    try:
        yield make_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------- scenarios
def _np(x):
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _meshes(inp):
    from dsp_tpu_torch.parallel import make_mesh
    for nd, nb in inp["shapes"]:
        yield f"{nd}x{nb}", make_mesh(int(nd), int(nb), device="cpu")


def scenario_functions(inp: dict) -> dict:
    """The sharded functions of ``parallel/sharding.py`` on seeded inputs:
    ``parts`` names the classify paths, the DP paths or both."""
    out = {}
    parts = {str(p) for p in inp["parts"]}
    for tag, mesh in _meshes(inp):
        res = {}
        if "classify" in parts:
            res.update(_classify_paths(inp, mesh))
        if "dp" in parts:
            res.update(_dp_paths(inp, mesh))
        for name, vals in res.items():
            for i, v in enumerate(vals):
                out[f"{tag}:{name}:{i}"] = _np(v)
    return out


def _classify_paths(inp, mesh):
    from dsp_tpu_torch import parallel as par
    from dsp_tpu_torch.config import PipelineConfig

    q, ql, bank, bl, ids = (inp[k] for k in ("q", "ql", "bank", "bl", "ids"))
    n_labels = int(ids.max()) + 1
    nb = mesh.size(1)
    res = {}
    res["k1"] = par.classify_sharded(mesh, q, ql, bank, bl, ids)
    res["k3"] = par.classify_sharded(mesh, q, ql, bank, bl, ids, k=3,
                                     n_labels=n_labels)
    res["full"] = par.classify_sharded(mesh, q, ql, bank, bl, ids,
                                       return_full=True)
    # a bank of 5 padded to the bank axis with invalid templates
    bp, k_orig = par.pad_axis_to_multiple(inp["bank5"], nb)
    blp, _ = par.pad_axis_to_multiple(inp["bl5"], nb)
    idsp, _ = par.pad_axis_to_multiple(inp["ids5"], nb)
    valid = np.arange(bp.shape[0]) < k_orig
    res["pad_k1"] = par.classify_sharded(mesh, q, ql, bp, np.maximum(blp, 1),
                                         idsp, valid)
    res["pad_k3"] = par.classify_sharded(mesh, q, ql, bp, np.maximum(blp, 1),
                                         idsp, valid, k=3, n_labels=n_labels)
    # every template invalid: the all-dead sentinel
    dead = np.zeros(bank.shape[0], bool)
    res["dead_k1"] = par.classify_sharded(mesh, q, ql, bank, bl, ids, dead)
    res["dead_k3"] = par.classify_sharded(mesh, q, ql, bank, bl, ids, dead,
                                          k=3, n_labels=n_labels)
    res["rec"] = par.recognize_sharded(
        mesh, inp["sigs"], inp["ns"], inp["rbank"], inp["rbl"], inp["rids"],
        cfg=PipelineConfig())
    return res


def _dp_paths(inp, mesh):
    from dsp_tpu_torch import parallel as par
    from dsp_tpu_torch.parallel import sharding as shd

    nb = mesh.size(1)
    res = {}
    sbp, k_s = par.pad_axis_to_multiple(inp["sbank"], nb)
    sblp, _ = par.pad_axis_to_multiple(inp["sbl"], nb)
    norm, start = par.spot_sharded(
        mesh, inp["streams"], inp["slens"], sbp, np.maximum(sblp, 1),
        np.arange(sbp.shape[0]) < k_s)
    res["spot"] = (norm[:, :k_s], start[:, :k_s])
    res["level"] = shd.level_build_sharded(
        mesh, inp["lq"], inp["lql"], inp["lbank"], inp["lbl"],
        max_levels=4, word_penalty=0.2)
    lbp, k_l = par.pad_axis_to_multiple(inp["lbank6"], nb)
    lblp, _ = par.pad_axis_to_multiple(inp["lbl6"], nb)
    res["level_pad"] = shd.level_build_sharded(
        mesh, inp["lq6"], inp["lql6"], lbp, np.maximum(lblp, 1),
        np.arange(lbp.shape[0]) < k_l, max_levels=3)
    res["grammar"] = shd.level_build_grammar_sharded(
        mesh, inp["gq"], inp["gql"], inp["gbank"], inp["gbl"],
        inp["gvalid"], inp["gstart"], inp["gpairs"], max_levels=3,
        word_penalty=0.2)
    return res


def scenario_models(inp: dict) -> dict:
    """The recognizers' ``mesh=`` entry points on a bank enrolled by the
    JAX package."""
    from dsp_tpu_torch import pipeline as pl
    from dsp_tpu_torch.config import PipelineConfig, VqConfig
    from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
    from dsp_tpu_torch.models.spotter import KeywordSpotter
    from dsp_tpu_torch.models.vq import VqRecognizer

    cfg = PipelineConfig()
    labels = json.loads(str(inp["labels"]))
    queries = unpack_signals(inp, "queries")
    conn = unpack_signals(inp, "conn")
    spot = unpack_signals(inp, "spot")
    out = {}
    for tag, mesh in _meshes(inp):
        def rec(k):
            return KnnDtwRecognizer.from_arrays(
                inp["bank"], inp["lens"], inp["label_ids"], labels, cfg, k=k,
                device="cpu", mesh=mesh)
        r1, r3 = rec(1), rec(3)
        got, d = r1.classify_batch(queries, return_distances=True)
        out[f"{tag}:k1"], out[f"{tag}:k1_d"] = np.asarray(got), d
        got, d = r3.classify_batch(queries, return_distances=True)
        out[f"{tag}:k3"], out[f"{tag}:k3_d"] = np.asarray(got), d
        out[f"{tag}:nbest"] = np.asarray(json.dumps(r3.classify_nbest(queries)))
        conn_out = {
            "vad": r1.classify_connected(conn, max_segments=4),
            "level": r1.classify_connected(conn, max_segments=4, method="level"),
            "grammar": r1.classify_connected(conn, max_segments=4, method="level",
                                             grammar={"no_repeat": True}),
        }
        out[f"{tag}:conn"] = np.asarray(json.dumps(conn_out))
        bf, bl, ids, valid = r1.sharded_bank()
        masks = r1.resolve_grammar({"start": [labels[0], labels[1]]})
        id_lists, costs = pl.decode_connected_level(
            conn, cfg, pl.Features(bf, bl), ids, max_levels=4, grammar_masks=masks,
            mesh=mesh, device="cpu", bank_valid=valid)
        out[f"{tag}:dcl"] = np.asarray(json.dumps(id_lists))
        out[f"{tag}:dcl_cost"] = costs
        spotter = KeywordSpotter(r1, threshold=float(inp["spot_thr"]))
        for i, (norm, start) in enumerate(spotter.scores(spot)):
            out[f"{tag}:spot_norm{i}"], out[f"{tag}:spot_start{i}"] = norm, start
        out[f"{tag}:events"] = np.asarray(json.dumps(spotter.spot(spot)))
        vq = VqRecognizer(cfg, VqConfig(n_codes=inp["codebooks"].shape[1]),
                          device="cpu", mesh=mesh)
        vq.labels, vq.codebooks = labels, inp["codebooks"]
        got, d = vq.classify_batch(queries, return_distances=True)
        out[f"{tag}:vq"], out[f"{tag}:vq_d"] = np.asarray(got), d
    return out


def scenario_em(inp: dict) -> dict:
    """Sharded EM, the GMM-HMM's mesh decode, ``shard_streams`` and the
    cross-process helpers of ``multihost``."""
    import torch
    import torch.distributed as dist

    from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
    from dsp_tpu_torch.models import gmm_hmm as pg
    from dsp_tpu_torch.ops import frontend as fe
    from dsp_tpu_torch.ops import streaming as tst
    from dsp_tpu_torch.parallel import em_step_sharded, multihost
    from dsp_tpu_torch.parallel.mesh import coordinate

    hmm = HmmConfig(n_states=3, n_mix=2, n_iter=3)
    cfg = PipelineConfig()
    labels = json.loads(str(inp["labels"]))
    train = {lab: unpack_signals(inp, f"train{i}") for i, lab in enumerate(labels)}
    queries = unpack_signals(inp, "queries")
    feats = torch.as_tensor(inp["feats"])
    lens = torch.as_tensor(inp["flens"])
    params0 = pg.params_from_numpy(tuple(inp[f"p0_{f}"] for f in pg.HmmParams._fields),
                                   "cpu")
    chunk_len = int(inp["chunk_len"])
    fcfg = FrontendConfig()
    out = {}
    for tag, mesh in _meshes(inp):
        prm, ll = em_step_sharded(mesh, feats, lens, params0, hmm)
        for f, a in zip(pg.HmmParams._fields, prm):
            out[f"{tag}:em_{f}"] = _np(a)
        out[f"{tag}:em_ll"] = _np(ll)
        prm = pg.fit_word(feats, lens, hmm, seed=3, mesh=mesh)
        for f, a in zip(pg.HmmParams._fields, prm):
            out[f"{tag}:fw_{f}"] = _np(a)
        for batched in (True, False):
            rec = pg.GmmHmmRecognizer(cfg, hmm, device="cpu")
            rec.fit(train, mesh=mesh, batched=batched)
            for f, a in zip(pg.HmmParams._fields, rec.params):
                out[f"{tag}:fit{int(batched)}_{f}"] = _np(a)
            out[f"{tag}:fit{int(batched)}_labels"] = np.asarray(rec.classify_batch(queries))
        dec = pg.GmmHmmRecognizer(cfg, hmm, device="cpu", mesh=mesh)
        dec.labels = json.loads(str(inp["jlabels"]))
        dec.params = pg.params_from_numpy(
            tuple(inp[f"jp_{f}"] for f in pg.HmmParams._fields), "cpu")
        got, scores = dec.classify_batch(queries, return_scores=True)
        out[f"{tag}:dec"], out[f"{tag}:dec_s"] = np.asarray(got), scores
        # streams: this rank's share, chunk by chunk
        state = tst.init_state_batch(inp["chunks"].shape[0], fcfg, chunk_len, "cpu")
        state, chunks = tst.shard_streams(mesh, state, inp["chunks"])
        mats = fe.make_matrices(fcfg, "cpu")
        rows = []
        for c in range(chunks.shape[1]):
            state, o = tst.process_chunk_batch(state, chunks[:, c], mats, fcfg,
                                               chunk_len=chunk_len)
            rows.append(o)
        for f in rows[0]._fields:
            out[f"{tag}:st_{f}"] = np.stack([_np(getattr(o, f)) for o in rows], 1)
        out[f"{tag}:st_coord"] = np.asarray(coordinate(mesh))
    rank = dist.get_rank()
    out["mh_minmax"] = np.asarray(multihost._min_max_across_hosts(rank + 0.25))
    out["mh_agree_same"] = np.asarray(multihost.all_hosts_agree(0.875))
    out["mh_agree_diff"] = np.asarray(multihost.all_hosts_agree(float(rank)))
    out["mh_mean"] = np.asarray(multihost.jnp_mean_across_hosts(float(rank)))
    out["mh_primary"] = np.asarray(multihost.is_primary())
    out["mh_backend"] = np.asarray(dist.get_backend())
    return out


def scenario_sc2(inp: dict) -> dict:
    """``python -m dsp_tpu_torch evaluate-sc2`` on this world: the labels
    its sharded branch gives (read from ``recognize_sharded``), the size of
    the mesh it ran on and its stdout."""
    import contextlib
    import io

    from dsp_tpu_torch import cli, parallel

    real, labels, ranks = parallel.recognize_sharded, [], []

    def spy(mesh, *args, **kw):
        got, d = real(mesh, *args, **kw)
        labels.append(_np(got))
        ranks.append(mesh.size())
        return got, d

    parallel.recognize_sharded = spy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "evaluate-sc2", "--root", str(inp["root"]),
                  *[str(a) for a in inp["argv"]]])
    assert labels and len(set(ranks)) == 1, "the sharded branch did not run"
    return {"labels": np.concatenate(labels), "mesh_ranks": np.asarray(ranks[0]),
            "stdout": np.asarray(buf.getvalue())}


SCENARIOS = {"functions": scenario_functions, "models": scenario_models,
             "em": scenario_em, "sc2": scenario_sc2}


def main() -> None:
    workdir, scenario = Path(sys.argv[1]), sys.argv[2]
    rank = int(os.environ["RANK"])
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from dsp_tpu_torch.parallel import multihost

        multihost.initialize(device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == \
            int(os.environ["WORLD_SIZE"])
        inp = dict(np.load(workdir / "in.npz"))
        out = SCENARIOS[scenario](inp)
        bad = {m.split(".")[0] for m in sys.modules} & {"jax", "dsp_tpu"}
        assert not bad, f"a rank imported {sorted(bad)}"
        np.savez(workdir / f"out_{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


if __name__ == "__main__":
    main()
