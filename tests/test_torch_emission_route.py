"""How the port's ``emission_logb`` (``dsp_tpu_torch/models/gmm_hmm.py``)
picks its route, checked without a card: which inputs the CUDA kernel
takes (``kernels/gmm_emissions.py:refusal``) and the words it gives for the
rest, the shared memory its launch asks for, that the CPU runs the plain
chain (``gmm_loglik_flat`` and ``torch.logsumexp``) whatever the inputs and
launches no kernel, and that the kernel's wrapper refuses tensors off the
card.  The kernel itself is held to the float64 plain chain on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import gmm_emissions as kgmm
from dsp_tpu_torch.kernels.mfcc_fused import SMEM_OPTIN
from dsp_tpu_torch.models import gmm_hmm as pg


def _inputs(lead_x=(3, 7), w=2, s=4, m=3, f=39, dtype=torch.float32, seed=0):
    """Rows x [*lead_x, F] and parameters [W, S, M, F] (``score_words``'
    shapes at the defaults)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*lead_x, f, generator=g, dtype=dtype)
    means = torch.randn(w, s, m, f, generator=g, dtype=dtype)
    log_var = torch.rand(w, s, m, f, generator=g, dtype=dtype) * 2.0 - 1.0
    log_mix = torch.log_softmax(torch.randn(w, s, m, generator=g, dtype=dtype), dim=-1)
    return x, means, log_var, log_mix


def _case(name):
    """(x, means, log_var, log_mix), and the refusal's words or None where
    the kernel takes them."""
    x, mu, lv, lm = args = _inputs()
    return {
        "score_words": (args, None),
        "spot_chunk_2d": (_inputs(lead_x=(24,)), None),
        "one_row_1d": (_inputs(lead_x=()), None),
        "no_rows": (_inputs(lead_x=(0, 5)), None),
        "one_word_no_lead": ((x, mu[0], lv[0], lm[0]), None),
        "two_lead_dims": ((x, mu[None], lv[None], lm[None]), None),
        "one_state": (_inputs(s=1), None),
        "five_states": (_inputs(s=5), None),
        "one_mixture": (_inputs(m=1), None),
        "8_mixtures": (_inputs(m=8), None),
        "9_mixtures": (_inputs(m=9), "1 <= M <= 8"),
        "64_features": (_inputs(f=64), None),
        "65_features": (_inputs(f=65), "1 <= F <= 64"),
        "float64": (_inputs(dtype=torch.float64), "float32"),
        "float64_log_mix": ((x, mu, lv, lm.double()), "log_mix is not a float32"),
        "strided_x": ((x.transpose(0, 1), mu, lv, lm), "x is not contiguous"),
        "strided_means": ((x, mu.transpose(0, 1), lv.transpose(0, 1), lm.transpose(0, 1)),
                          "means is not contiguous"),
        "feature_mismatch": ((x[..., :13], mu, lv, lm), "does not end in the parameters'"),
        "log_mix_mismatch": ((x, mu, lv, lm[..., :2]), "are not [*lead, S, M, F]"),
        "log_var_mismatch": ((x, mu, lv[:1], lm), "are not [*lead, S, M, F]"),
        "means_2d": ((x, mu[0, 0], lv[0, 0], lm[0, 0]), "are not [*lead, S, M, F]"),
        "no_states": ((x, mu[:, :0], lv[:, :0], lm[:, :0]), "holds no state"),
        "params_on_meta": ((x, mu.to("meta"), lv.to("meta"), lm.to("meta")),
                           "not on x's device"),
    }[name]


CASES = ("score_words", "spot_chunk_2d", "one_row_1d", "no_rows", "one_word_no_lead",
         "two_lead_dims", "one_state", "five_states", "one_mixture", "8_mixtures",
         "9_mixtures", "64_features", "65_features", "float64", "float64_log_mix",
         "strided_x", "strided_means", "feature_mismatch", "log_mix_mismatch",
         "log_var_mismatch", "means_2d", "no_states", "params_on_meta")


@pytest.mark.parametrize("name", CASES)
def test_the_kernel_takes_what_the_hmm_paths_pass_and_refuses_the_rest(name, monkeypatch):
    """The card's route is the kernel exactly where ``refusal`` is None
    (float32 and contiguous, [*lead, S, M, F] parameters on ``x``'s device,
    1 <= M <= 8, 1 <= F <= 64, a state at least); on the CPU
    ``emission_logb`` hands every input to the plain chain and asks
    ``refusal`` nothing."""
    args, words = _case(name)
    why = kgmm.refusal(*args)
    assert (why is None) if words is None else (words in why), why

    class Plain(Exception):
        pass

    def entered(x, *_):
        flat.append(x)
        raise Plain

    flat, asked = [], []
    monkeypatch.setattr(pg, "gmm_loglik_flat", entered)
    monkeypatch.setattr(kgmm, "refusal", lambda *a: asked.append(a))
    with pytest.raises(Plain):
        pg.emission_logb(args[0], pg.HmmParams(None, None, *args[1:]))
    assert len(flat) == 1 and flat[0] is args[0] and not asked


@pytest.mark.parametrize("s, m, f, stage, bytes_", [
    (16, 3, 39, 16, 55_264),          # the Aurora 2 word: one stage, four blocks an SM
    (1, 3, 39, 4, 4 * (10_024 + 4 * 3 * 79)),
    (5, 2, 13, 8, 4 * (3_344 + 8 * 2 * 27)),
    (32, 3, 39, 16, 55_264),          # two stages of 16
    (16, 8, 64, 4, 4 * (16_448 + 4 * 8 * 129)),   # the limits: one tile a stage
])
def test_the_launch_stages_states_within_the_blocks_shared_memory(s, m, f, stage, bytes_):
    """``stage_states``: a multiple of 4, as many states as fit
    ``STATE_STAGE_BYTES`` (at least 4), no more than S rounded up to 4;
    ``smem_bytes``: the row tile [F][257] rounded up to a float4 and the
    stage's 2 M F + M floats a state, within the H100's 227 KB at every
    width the kernel takes."""
    got = kgmm.stage_states(s, m, f)
    assert got == stage and got % 4 == 0
    assert kgmm.smem_bytes(m, f, got) == bytes_ <= SMEM_OPTIN
    if got > 4:
        assert got * 4 * m * (2 * f + 1) <= kgmm.STATE_STAGE_BYTES


def test_the_cpu_runs_the_plain_chain_and_launches_nothing():
    """On the CPU ``emission_logb`` is ``gmm_loglik_flat`` and
    ``torch.logsumexp`` over the mixtures, bit for bit, and leaves
    ``_build.LAUNCHES["gmm_emissions"]`` as it was; the kernel's wrapper
    refuses tensors off the card (the CPU's, or another device type's)
    and launches nothing."""
    x, means, log_var, log_mix = _inputs()
    params = pg.HmmParams(None, None, means, log_var, log_mix)
    launched = _build.LAUNCHES["gmm_emissions"]
    got = pg.emission_logb(x, params)
    ll = pg.gmm_loglik_flat(x, means.reshape(-1, 39), log_var.reshape(-1, 39))
    want = torch.logsumexp(ll.reshape(3, 7, 2, 4, 3) + log_mix, dim=-1)
    assert torch.equal(got, want)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match=f"unsupported device {device}"):
            kgmm.gmm_emissions_fused(*(t.to(device) for t in (x, means, log_var, log_mix)))
    assert _build.LAUNCHES["gmm_emissions"] == launched
