"""The wavefront microbenchmarks' plain versions against the Pallas kernels
of ``scripts/mb_wavefront.py`` in interpret mode, on the CPU.

The JAX script is loaded from its file; ``dp_diet`` is called as it is, and
the other kernels (``_dma_kernel``, ``_anatomy_kernel``, the ``x * 2``
kernel, ``_tr_kernel``, ``_skew_kernel``) go through ``pl.pallas_call``
with the BlockSpecs of their ``bench_*`` function on a small grid.

Tolerances: equal bits for dp_diet (exact mins and one add a cell), for
anatomy (the multiply by 0.5 is exact), trivial, transpose and skew; rtol
1e-6 for the fetch's accumulator; rtol 1e-5 for E4's fp32 einsum against
XLA's at HIGHEST precision (sums in another order).
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_pallas as kwf
from dsp_tpu_torch.kernels import mb_wavefront as mbk
from dsp_tpu_torch.scripts import mb_wavefront as mbw

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_mb_wavefront",
                                               ROOT / "scripts" / "mb_wavefront.py")
jmb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jmb)

F32 = jnp.float32
VMEM = pltpu.VMEM
T = torch.from_numpy


def _vmem(block, index_map):
    return pl.BlockSpec(block, index_map, memory_space=VMEM)


def _launches():
    return dict(_build.LAUNCHES)


# ---------------------------------------------------------------- E1: DP
def _dp_inputs(case, p=16, d=16, t=8, seed=0):
    rng = np.random.default_rng(seed)
    skew = rng.standard_normal((p, d, t)).astype(np.float32)
    skew[rng.random(skew.shape) < 0.1] = mbk.BIG
    ktarget = rng.integers(-1, d + 1, (p, 1)).astype(np.int32)
    la = rng.integers(0, t + 2, (p, 1)).astype(np.int32)
    if case == "wrap":
        # the last lane is cheap; it is reached at k = t-1, and lanes 0 and 1
        # read it through the wrap from k = t on
        skew = np.ones((p, d, t), np.float32)
        skew[:, :, t - 1] = -5.0
        la[:] = rng.integers(1, 3, (p, 1))
        ktarget[:] = rng.integers(t + 2, d, (p, 1))
    elif case == "la_out_of_range":
        la[:] = np.where(np.arange(p)[:, None] % 2 == 0, 0, t + 1)
    elif case == "ktarget_never":
        ktarget[:] = np.where(np.arange(p)[:, None] % 2 == 0, -1, d)
    return skew, ktarget, la


@pytest.mark.parametrize("case", ["random", "wrap", "la_out_of_range", "ktarget_never"])
def test_dp_diet_matches_jax_interpret(case):
    skew, ktarget, la = _dp_inputs(case)
    before = _launches()
    got = mbk.dp_diet(T(skew), T(ktarget), T(la)).numpy()
    assert _launches() == before
    want = np.asarray(jmb.dp_diet(jnp.asarray(skew), jnp.asarray(ktarget),
                                  jnp.asarray(la), pair_tile=8, diag_block=8,
                                  interpret=True))
    assert got.shape == want.shape == (16, 1)
    np.testing.assert_array_equal(got, want)
    if case in ("la_out_of_range", "ktarget_never"):
        assert (got == 0).all()
    if case == "wrap":                 # lane 0 read lane T-1's -5s through the wrap
        assert (got < 0).all()


# ---------------------------------------------------------- E0: the fetch
def _jax_dma(skew, ktarget, pt):
    p, d, t = skew.shape
    return pl.pallas_call(
        jmb._dma_kernel,
        out_shape=jax.ShapeDtypeStruct((p, 1), F32),
        grid=(p // pt, d // 8),
        in_specs=[_vmem((pt, 1), lambda pi, k: (pi, 0)),
                  _vmem((pt, 8, t), lambda pi, k: (pi, k, 0))],
        out_specs=_vmem((pt, 1), lambda pi, k: (pi, 0)),
        scratch_shapes=[VMEM((pt, 1), F32)],
        interpret=True,
    )(ktarget, skew)


@pytest.mark.parametrize("d", [16, 24])
def test_dma_fetch_matches_jax_interpret(d):
    rng = np.random.default_rng(d)
    skew = rng.standard_normal((16, d, 8)).astype(np.float32)
    ktarget = rng.integers(-50, 50, (16, 1)).astype(np.int32)
    got = mbk.dma_fetch(T(skew), T(ktarget)).numpy()
    want = np.asarray(_jax_dma(jnp.asarray(skew), jnp.asarray(ktarget), pt=8))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------ E1b: anatomy, trivial
def _jax_anatomy(x, n_rolls, steps):
    kern = functools.partial(jmb._anatomy_kernel, n_rolls=n_rolls, steps=steps,
                             width=x.shape[1])
    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, F32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)],
        out_specs=pl.BlockSpec(memory_space=VMEM),
        scratch_shapes=[VMEM(x.shape, F32)], interpret=True)(x)


@pytest.mark.parametrize("steps", [1, 7])
@pytest.mark.parametrize("n_rolls", [0, 1, 2])
def test_anatomy_matches_jax_interpret(n_rolls, steps):
    x = np.random.default_rng(10 * n_rolls + steps).standard_normal((8, 16)).astype(np.float32)
    got = mbk.anatomy(T(x), n_rolls, steps).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_anatomy(jnp.asarray(x), n_rolls, steps)))


def test_trivial_matches_jax_interpret():
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32)
    want = pl.pallas_call(
        lambda i, o: o.__setitem__(slice(None), i[:] * 2.0),
        out_shape=jax.ShapeDtypeStruct(x.shape, F32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)],
        out_specs=pl.BlockSpec(memory_space=VMEM), interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(mbk.trivial(T(x)).numpy(), np.asarray(want))


# ------------------------------------------------------- E2: transpose
def test_transpose_matches_jax_interpret():
    x = np.random.default_rng(4).standard_normal((4, 8, 16)).astype(np.float32)
    qb = 2
    want = pl.pallas_call(
        jmb._tr_kernel, out_shape=jax.ShapeDtypeStruct((4, 16, 8), F32),
        grid=(4 // qb,),
        in_specs=[_vmem((qb, 8, 16), lambda i: (i, 0, 0))],
        out_specs=_vmem((qb, 16, 8), lambda i: (i, 0, 0)), interpret=True)(jnp.asarray(x))
    got = mbk.transpose(T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.swapaxes(x, 1, 2))


# ---------------------------------------------------- E3: skew construct
def _jax_skew(cost, d_pad, qb):
    q, t, u = cost.shape
    kern = functools.partial(jmb._skew_kernel, t_pad=t, u_pad=u, d_pad=d_pad, qb=qb)
    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((q, d_pad, t), F32),
        grid=(q // qb,),
        in_specs=[_vmem((qb, t, u), lambda i: (i, 0, 0))],
        out_specs=_vmem((qb, d_pad, t), lambda i: (i, 0, 0)),
        scratch_shapes=[VMEM((qb, t, d_pad), F32)], interpret=True)(cost)


@pytest.mark.parametrize("t,u,d_pad", [(16, 16, 32), (8, 16, 40)])
def test_skew_matches_jax_interpret_and_skew_cost(t, u, d_pad):
    cost = np.random.default_rng(t + u).standard_normal((4, t, u)).astype(np.float32)
    got = mbk.skew(T(cost), d_pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_skew(jnp.asarray(cost), d_pad, 2)))
    # the port's skew_cost layout [Q, T+U-1, T], padded with BIG rows
    ref = kwf.skew_cost(T(cost)).numpy()
    pad = np.full((4, d_pad - ref.shape[1], t), mbk.BIG, np.float32)
    np.testing.assert_array_equal(got, np.concatenate([ref, pad], axis=1))


def test_skew_refuses_t_plus_u_over_d_pad():
    with pytest.raises(ValueError, match="d_pad"):
        mbk.skew(torch.zeros((2, 16, 16)), 31)
    assert mbk.skew(torch.zeros((2, 16, 16)), 32).shape == (2, 32, 16)


# --------------------------------------------- E4: batched cost, no kernel
def test_cost_matches_jax_einsum():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 8, 5)).astype(np.float32)
    b = rng.standard_normal((2, 8, 5)).astype(np.float32)
    got = mbk.cost(T(q), T(b)).numpy()
    # scripts/mb_wavefront.py:bench_cost's cost_fn, at these shapes
    qq, bb = jnp.asarray(q), jnp.asarray(b)
    cr = jnp.einsum("btf,kuf->bktu", qq, bb, precision=jax.lax.Precision.HIGHEST)
    sa = jnp.sum(qq * qq, -1)[:, None, :, None]
    sb = jnp.sum(bb * bb, -1)[None, :, None, :]
    want = np.asarray(jnp.maximum(sa + sb - 2 * cr, 0.0).reshape(6, 8, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------- the wrappers and the entry point
def test_entry_point_constants_equal_the_jax_script():
    for name in ("BIG", "P", "T", "U", "T_PAD", "U_PAD", "D_PAD"):
        assert getattr(mbw, name) == getattr(jmb, name), name
    assert mbk.BIG == jmb.BIG


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    skew, ktarget, la = _dp_inputs("random", p=4, d=8, t=8)
    x = torch.ones((3, 32))
    before = _launches()
    for got, want in (
            (mbk.dp_diet(T(skew), T(ktarget), T(la)), mbk.dp_diet_plain(T(skew), T(ktarget), T(la))),
            (mbk.dma_fetch(T(skew), T(ktarget)), mbk.dma_fetch_plain(T(skew), T(ktarget))),
            (mbk.anatomy(x, 1, 3), mbk.anatomy_plain(x, 1, 3)),
            (mbk.trivial(x), x * 2),
            (mbk.transpose(T(skew)), T(skew).transpose(1, 2)),
            (mbk.skew(T(skew), 16), mbk.skew_plain(T(skew), 16))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert _launches() == before


@pytest.mark.parametrize("call", [
    lambda: mbk.dp_diet(torch.zeros((4, 8, 8)), torch.zeros((4, 1), dtype=torch.int64),
                        torch.zeros((4, 1), dtype=torch.int32)),
    lambda: mbk.dp_diet(torch.zeros((4, 8, 8)), torch.zeros((4,), dtype=torch.int32),
                        torch.zeros((4, 1), dtype=torch.int32)),
    lambda: mbk.dma_fetch(torch.zeros((4, 8, 8), dtype=torch.float64),
                          torch.zeros((4, 1), dtype=torch.int32)),
    lambda: mbk.anatomy(torch.zeros((2, 32)), 3, 1),
    lambda: mbk.anatomy(torch.zeros((2, 32)), 1, 1, cycles=torch.zeros(2, dtype=torch.int64)),
    lambda: mbk.transpose(torch.zeros((4, 8))),
    lambda: mbk.trivial(torch.zeros(4, dtype=torch.float64)),
])
def test_wrappers_refuse_bad_inputs_on_any_device(call):
    with pytest.raises(ValueError):
        call()


def test_timing_needs_a_card():
    from dsp_tpu_torch.utils import timing

    if torch.cuda.is_available():
        assert timing.time_ms(lambda: torch.ones(4, device="cuda")) > 0
        return
    for call in (lambda: timing.time_ms(lambda: None),
                 lambda: timing.chained_timeit(lambda: None, ()),
                 lambda: timing.chained_timeit_spread(lambda: None, ())):
        with pytest.raises(RuntimeError):
            call()


def test_entry_point_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        mbw.require_card("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        mbw.bench_dp(device="cpu")
    with pytest.raises(ValueError, match="unknown experiment"):
        mbw.run("bogus", device="cpu")
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "dsp_tpu_torch.scripts.mb_wavefront",
                               "dp"], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "CUDA card" in proc.stderr
