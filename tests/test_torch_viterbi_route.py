"""How the port's ``viterbi_score`` (``dsp_tpu_torch/ops/viterbi.py``) picks
its route, checked without a card: which inputs the CUDA kernel takes
(``kernels/viterbi_score.py:refusal``), the views it reads them through
(``pair_views``: the same lattices as the inputs), and that the CPU runs
the plain loop whatever the inputs and launches no kernel, and that the
kernel's wrapper refuses tensors off the card.
The kernel itself is held to the loop bit for bit on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import viterbi_score as kvit
from dsp_tpu_torch.ops import viterbi as tvit
from dsp_tpu_torch.utils import profiling


def _lattice(b=3, t=6, w=2, s=4, dtype=torch.float32, length_dtype=torch.int32, seed=0):
    """score_words' arguments: [1, W, S], [1, W, S, S], the [T, B, W, S]
    view of a [B, T, W, S] tensor and [B, 1] lengths."""
    g = torch.Generator().manual_seed(seed)
    log_b = torch.randn(b, t, w, s, generator=g, dtype=dtype).movedim(1, 0)
    log_pi = torch.randn(1, w, s, generator=g, dtype=dtype)
    log_a = torch.randn(1, w, s, s, generator=g, dtype=dtype)
    length = torch.randint(1, t + 1, (b, 1), generator=g).to(length_dtype)
    return log_pi, log_a, log_b, length


def _case(name):
    """(inputs, the refusal's words or None where the kernel takes them)."""
    pi, a, b, n = _lattice()
    return {
        "score_words": ((pi, a, b, n), None),
        "one_state": (_lattice(s=1), None),
        "32_states": (_lattice(s=32), None),
        "33_states": (_lattice(s=33), "S <= 32"),
        "float64": (_lattice(dtype=torch.float64), "float32"),
        "int64_lengths": (_lattice(length_dtype=torch.int64), None),
        "float_lengths": (_lattice(length_dtype=torch.float32), "int32 or int64"),
        "no_lengths": ((pi, a, b, None), None),
        "3d_log_b": ((pi[0, 0], a[0, 0], b[:, :, 0], n[:, 0]), None),
        "2d_log_b": ((pi[0, 0], a[0, 0], b[:, 0, 0], None), "not 3 or 4"),
        "5d_log_b": ((pi, a, b[..., None, :], None), "not 3 or 4"),
        "no_frames": ((pi, a, b[:0], n), "T >= 1"),
        "wider_log_a": ((pi, a[None].expand(4, -1, -1, -1, -1), b, n), "broadcast to log_b's"),
        "word_mismatch": ((pi, torch.zeros(1, 3, 4, 4), b, n), "broadcast to log_b's"),
        "state_mismatch": ((pi[..., :3], a, b, n), "do not end in S"),
    }[name]


CASES = ("score_words", "one_state", "32_states", "33_states", "float64", "int64_lengths",
         "float_lengths", "no_lengths", "3d_log_b", "2d_log_b", "5d_log_b", "no_frames",
         "wider_log_a", "word_mismatch", "state_mismatch")


@pytest.mark.parametrize("name", CASES)
def test_the_kernel_takes_what_score_words_passes_and_refuses_the_rest(name, monkeypatch):
    """The card's route is the kernel exactly where ``refusal`` is None
    (float32, 1 <= S <= 32, 3-D or 4-D ``log_b`` whose leading dims are the
    broadcast shape, int32 / int64 lengths); on the CPU ``viterbi_score``
    hands every input to the loop and asks ``refusal`` nothing."""
    args, words = _case(name)
    why = kvit.refusal(*args)
    assert (why is None) if words is None else (words in why), why
    looped, asked = [], []
    monkeypatch.setattr(tvit, "_viterbi_loop", lambda *a: looped.append(a[2]) or "loop")
    monkeypatch.setattr(kvit, "refusal", lambda *a: asked.append(a))
    assert tvit.viterbi_score(*args) == "loop"
    assert len(looped) == 1 and looped[0] is args[2] and not asked


@pytest.mark.parametrize("name", ("score_words", "one_state", "32_states", "int64_lengths",
                                  "no_lengths", "3d_log_b"))
def test_pair_views_hold_the_same_lattices_without_a_copy(name):
    """The kernel's [n0, n1] views give the loop's scores, share the
    inputs' storage (no copy) and broadcast by stride 0."""
    args, _ = _case(name)
    pi, a, b, n = kvit.pair_views(*args)
    t = args[2].shape[0]
    want = tvit._viterbi_loop(*args[:3], tvit._length(args[3], t, args[2]))
    got = tvit._viterbi_loop(pi, a, b, tvit._length(n, t, b))
    assert torch.equal(got.reshape(want.shape), want)
    assert b.dim() == 4 and pi.shape == b.shape[1:] and a.shape == (*b.shape[1:], b.shape[-1])
    for view, x in zip((pi, a, b, n), args):
        if x is not None:
            assert view.data_ptr() == x.data_ptr()
    if name == "score_words":
        assert pi.stride(0) == a.stride(0) == n.stride(1) == 0


def test_the_cpu_runs_the_loop_and_counts_no_route(monkeypatch):
    """On the CPU ``viterbi_score`` runs ``_viterbi_loop`` (its bits) once
    a call, counts ``viterbi_steps`` T - 1 a call and leaves
    ``_build.LAUNCHES["viterbi_score"]`` as it was; the kernel's wrapper
    refuses tensors off the card (the CPU's, or another device type's) and
    launches nothing."""
    calls = []
    loop = tvit._viterbi_loop

    def counted(*a):
        calls.append(a[2].shape)
        return loop(*a)

    monkeypatch.setattr(tvit, "_viterbi_loop", counted)
    args, _ = _case("score_words")
    before, launched = profiling.counts(), _build.LAUNCHES["viterbi_score"]
    got = tvit.viterbi_score(*args)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match=f"unsupported device {device}"):
            kvit.viterbi_score_fused(*(x.to(device) for x in args))
    counted_now = {k: v - before.get(k, 0) for k, v in profiling.counts().items()}
    assert len(calls) == 1
    assert torch.equal(got, loop(*args))
    assert counted_now.get("viterbi_steps") == args[2].shape[0] - 1
    assert _build.LAUNCHES["viterbi_score"] == launched
