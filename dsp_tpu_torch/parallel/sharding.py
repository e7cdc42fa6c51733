"""Mesh-sharded classification, spotting and level building (port of
``dsp_tpu/parallel/sharding.py``).

Communication design (BASELINE config 4, "template bank sharded across a
mesh"):

* queries [B, T, F] split over 'data', the bank [K, U, F] over 'bank';
* each rank computes its [B/data, K/bank] DTW block with the single-device
  ``pipeline.dtw_pairs`` (the banded DTW kernel on the card);
* the cross-rank reduction is a top-k over the bank axis carried as
  (distance, global template index) pairs: an ``all_gather`` of 2k scalars
  a query a bank shard, never the distance matrix (unless ``return_full``);
* a last ``all_gather`` over 'data' assembles the [B] results, so every
  rank returns the global result.

Every function takes the GLOBAL arrays on every rank (the same inputs
everywhere) and returns the global result on every rank, on the mesh's
device.  The collectives are the JAX functions' own, called explicitly on
the mesh's axis groups.  Ties keep JAX's order: ``lax.top_k`` returns the
lowest index first among equal values, so every top-k here is a stable
ascending sort.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from dsp_tpu_torch import pipeline as pl
from dsp_tpu_torch.config import DtwConfig, PipelineConfig
from dsp_tpu_torch.ops import level_building as lb
from dsp_tpu_torch.ops import spot as ops_spot
from dsp_tpu_torch.ops.dtw import BIG
from dsp_tpu_torch.parallel.mesh import (BANK_AXIS, DATA_AXIS, as_mesh,
                                         coordinate, gather, gather_stack,
                                         replicate, shard_bank, shard_queries)


def _valid(bank_valid, k: int):
    if bank_valid is None:
        return torch.ones(k, dtype=torch.bool)
    return bank_valid


def _smallest(x: torch.Tensor, m: int):
    """(values, indices) of the m smallest entries of each row, ascending;
    equal values keep column order (``lax.top_k`` of ``-x``)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[:, :m], idx[:, :m]


def classify_sharded(
    mesh: DeviceMesh,
    queries, q_lens,
    bank, bank_lens,
    bank_label_ids,
    bank_valid=None,
    cfg: DtwConfig = DtwConfig(),
    k: int = 1,
    n_labels: int | None = None,
    return_full: bool = False,
):
    """All-pairs DTW classify over a ('data', 'bank') mesh.

    Args:
      queries/q_lens: [B, T, F] / [B], B divisible by the 'data' size.
      bank/bank_lens: [K, U, F] / [K], K divisible by the 'bank' size.
      bank_label_ids: [K] int.
      bank_valid: [K] bool; False marks padding templates (excluded).
      k: kNN votes; k > 1 gathers each shard's top-k and votes on the
         union, exactly the single-device kNN (requires n_labels).
      return_full: also gather the full distance matrix [B, K].

    Returns (label_ids [B], best_dist [B]), or (label_ids, dists [B, K])
    with return_full, on every rank.
    """
    mesh = as_mesh(mesh)
    if k > 1 and n_labels is None:
        raise ValueError("n_labels required for k > 1")
    q, ql = shard_queries(mesh, queries, q_lens)
    return _classify_local(mesh, q, ql, bank, bank_lens, bank_label_ids,
                           bank_valid, cfg, k, n_labels, return_full)


def _classify_local(mesh, q, ql, bank, bank_lens, bank_label_ids, bank_valid,
                    cfg, k, n_labels, return_full):
    """:func:`classify_sharded` from this rank's query shard on."""
    kk = max(1, k)
    b, bl, bv = shard_bank(mesh, bank, bank_lens,
                           _valid(bank_valid, bank.shape[0]))
    ids = replicate(mesh, bank_label_ids)
    kl = b.shape[0]
    # the single-device routing: the banded DTW kernel on the card
    d = pl.dtw_pairs(q, ql, b, bl, cfg)                          # [Bl, Kl]
    d = torch.where(bv[None, :], d, torch.full_like(d, BIG))
    # each shard's top-k, then a gather of 2k scalars a query a shard
    lmin, larg = _smallest(d, min(kk, kl))                       # [Bl, k]
    gidx = coordinate(mesh)[1] * kl + larg
    mins = gather(lmin, mesh, BANK_AXIS, dim=-1)                 # [Bl, nb*k]
    idxs = gather(gidx, mesh, BANK_AXIS, dim=-1)
    top_d, sel = _smallest(mins, min(kk, mins.shape[-1]))        # global top-k
    top_idx = torch.take_along_dim(idxs, sel, dim=-1)
    top_idx = gather(top_idx, mesh, DATA_AXIS)
    top_d = gather(top_d, mesh, DATA_AXIS)
    if k > 1:
        label_ids = pl.vote_topk(top_d, ids[top_idx], n_labels)
    else:
        # the all-dead sentinel of classify_features' k=1 branch: a row
        # whose best candidate is still >= 1e20 elects no label
        best = ids[top_idx[:, 0]].to(torch.int64)
        label_ids = torch.where(top_d[:, 0] < pl.DEAD, best,
                                torch.full_like(best, -1))
    if return_full:
        full = gather(gather(d, mesh, BANK_AXIS, dim=-1), mesh, DATA_AXIS)
        return label_ids, full
    return label_ids, top_d[:, 0]


def recognize_sharded(
    mesh: DeviceMesh,
    signals, n_samples,
    bank_feats, bank_lens,
    bank_label_ids,
    bank_valid=None,
    cfg: PipelineConfig = PipelineConfig(),
    k: int = 1,
    n_labels: int | None = None,
    return_full: bool = False,
):
    """The whole pipeline over the mesh: padded signals [B, N] -> labels.

    Feature extraction is data-parallel (each rank extracts its query
    shard, the fused MFCC kernel under ``FrontendConfig(impl="pallas")``,
    no collective); classification is the bank-sharded top-k of
    :func:`classify_sharded`.  The JAX function's ``mats`` argument has no
    counterpart: the port's front-end builds its matrices itself."""
    mesh = as_mesh(mesh)
    if k > 1 and n_labels is None:
        raise ValueError("n_labels required for k > 1")
    x, n = shard_queries(mesh, signals, n_samples)
    feats = pl.extract_features(x, n, cfg)
    return _classify_local(mesh, feats.feats, feats.length, bank_feats,
                           bank_lens, bank_label_ids, bank_valid, cfg.dtw, k,
                           n_labels, return_full)


def level_build_sharded(
    mesh: DeviceMesh,
    q_feats, q_lens,
    bank, bank_lens,
    bank_valid=None,
    max_levels: int = 8,
    word_penalty: float = 0.0,
    squared: bool = False,
):
    """Level-building connected decode over a ('data', 'bank') mesh.

    Within a level every template is independent (``ops/level_building.py:
    level_pass``); the only coupling is the per-frame minimum that builds
    the next level's entry costs.  Each rank runs its templates' DP, and a
    level ends in an ``all_gather`` over 'bank' of three [T] vectors a
    recording (cost, global template, start pointer) and an elementwise
    argmin: the lowest bank coordinate wins a tie, which is the lowest
    global template index, as on one device.

    Shapes: q_feats [B, T, F], B divisible by 'data'; bank [K, U, F], K
    divisible by 'bank' (pad with ``bank_valid=False`` rows: they cost BIG
    and are never selected).  Returns (costs, words, starts) [B, L, T] with
    global template indices, on every rank.
    """
    mesh = as_mesh(mesh)
    q, _ = shard_queries(mesh, q_feats, q_lens)
    b, bl, bv = shard_bank(mesh, bank, bank_lens,
                           _valid(bank_valid, bank.shape[0]))
    kl = b.shape[0]
    offset = coordinate(mesh)[1] * kl
    c = lb.local_costs(q, b, bl, squared)                       # [T, Bl, Kl, U]
    c.masked_fill_(~bv[None, None, :, None], BIG)               # pad rows dead
    lens_idx = lb._end_index(bl)
    nq, t = q.shape[:2]
    prev = torch.full((nq, t + 1), BIG, dtype=torch.float32, device=q.device)
    prev[:, 0] = 0.0
    big = torch.full((nq, 1), BIG, dtype=torch.float32, device=q.device)
    levels = []
    for _ in range(max_levels):
        cost_l, v_l, s_l = lb.level_pass(c, prev, lens_idx, word_penalty)
        # the cross-shard reduce: 3 x [T] a recording a bank shard
        costs = gather_stack(cost_l, mesh, BANK_AXIS)            # [nb, Bl, T]
        vs = gather_stack(v_l + offset, mesh, BANK_AXIS)
        ss = gather_stack(s_l, mesh, BANK_AXIS)
        cost_t, which = torch.min(costs, dim=0)                  # first min wins
        v_t = torch.take_along_dim(vs, which[None], dim=0)[0]
        s_t = torch.take_along_dim(ss, which[None], dim=0)[0]
        prev = torch.cat([big, cost_t], dim=1)
        levels.append((cost_t, v_t, s_t))
    return tuple(gather(torch.stack(p, dim=1), mesh, DATA_AXIS)
                 for p in zip(*levels))


def level_build_grammar_sharded(
    mesh: DeviceMesh,
    q_feats, q_lens,
    bank, bank_lens,
    bank_valid,
    start_mask, pair_mask,
    max_levels: int = 8,
    word_penalty: float = 0.0,
    squared: bool = False,
):
    """Grammar-constrained level building over a ('data', 'bank') mesh.

    The grammar couples templates across shards (entering local template
    v needs the best allowed global predecessor), so a level's reduction
    grows to the [T, K] cost and start planes: an ``all_gather`` over
    'bank' of [T, K/bank] a shard.  The transition mask is split by column:
    each rank keeps ``pair_mask[:, local]`` [K, Kl], the rectangular case
    ``ops/level_building.py:level_pass_grammar`` computes.

    Shapes as :func:`level_build_sharded` plus ``start_mask [K]`` and
    ``pair_mask [K, K]`` (pad rows must arrive masked False).  Returns
    ``(costs, starts) [B, L, T, K]`` with global template indices, on
    every rank.
    """
    mesh = as_mesh(mesh)
    q, _ = shard_queries(mesh, q_feats, q_lens)
    b, bl, bv, sm = shard_bank(mesh, bank, bank_lens,
                               _valid(bank_valid, bank.shape[0]), start_mask)
    kl = b.shape[0]
    bc = coordinate(mesh)[1]
    pm = replicate(mesh, pair_mask[:, bc * kl:(bc + 1) * kl]).to(torch.bool)
    k_global = pm.shape[0]
    first = sm.to(torch.bool)[None, :].expand(k_global, kl)
    c = lb.local_costs(q, b, bl, squared)
    c.masked_fill_(~bv[None, None, :, None], BIG)
    lens_idx = lb._end_index(bl)
    nq, t = q.shape[:2]
    prev = torch.full((nq, t + 1, k_global), BIG, dtype=torch.float32,
                      device=q.device)
    prev[:, 0] = 0.0
    big = torch.full((nq, 1, k_global), BIG, dtype=torch.float32,
                     device=q.device)
    levels = []
    for lvl in range(max_levels):
        # prev: the [T+1, K] GLOBAL plane, the same on every bank shard
        cost_l, start_l = lb.level_pass_grammar(
            c, prev, first if lvl == 0 else pm, lens_idx, word_penalty)
        cost_g = gather(cost_l, mesh, BANK_AXIS, dim=-1)         # [Bl, T, K]
        start_g = gather(start_l, mesh, BANK_AXIS, dim=-1)
        prev = torch.cat([big, cost_g], dim=1)
        levels.append((cost_g, start_g))
    return tuple(gather(torch.stack(p, dim=1), mesh, DATA_AXIS)
                 for p in zip(*levels))


def spot_sharded(
    mesh: DeviceMesh,
    streams, stream_lens,
    bank, bank_lens,
    bank_valid=None,
    squared: bool = False,
    impl: str = "auto",
):
    """Subsequence-DTW keyword spotting over a ('data', 'bank') mesh.

    streams [B, U, F] split over 'data', bank [K, T, F] over 'bank': each
    rank scans its template shard over its stream shard
    (``ops/spot.py:subseq_dtw_batch``, the spotting kernel on the card)
    with no collective, then the norm and start planes [B, K, U] are
    gathered over both axes for the host's event extraction.  Padding
    templates (``bank_valid`` False) score BIG everywhere.  ``impl`` is the
    single-device spotting route."""
    mesh = as_mesh(mesh)
    s, sl = shard_queries(mesh, streams, stream_lens)
    b, bl, bv = shard_bank(mesh, bank, bank_lens,
                           _valid(bank_valid, bank.shape[0]))
    norm, start = ops_spot.subseq_dtw_batch(s, sl, b, bl, squared, impl)
    norm = torch.where(bv[None, :, None], norm, torch.full_like(norm, BIG))
    return tuple(gather(gather(p, mesh, BANK_AXIS, dim=1), mesh, DATA_AXIS)
                 for p in (norm, start))
