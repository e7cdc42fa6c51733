"""The frozen generator: equal to the port's, and the same for a seed."""

import numpy as np
import pytest

from benchmark.data import synth


@pytest.mark.parametrize("label,seed,n", [("marvin", 0, 16000), ("seven", 123456, 32000),
                                          ("wow", 2**31 + 77, 16000)])
def test_equals_the_ports_generator(label, seed, n):
    from dsp_tpu_torch.io.synth import synth_word

    assert np.array_equal(synth.synth_word(label, seed, max_samples=n),
                          synth_word(label, seed, max_samples=n))


def test_cell_inputs_are_a_function_of_the_seed():
    words = ["yes", "no", "up"]
    a = synth.cell_inputs(words, 2, 6, 2**31 + 5, 16000, 16000)
    b = synth.cell_inputs(words, 2, 6, 2**31 + 5, 16000, 16000)
    c = synth.cell_inputs(words, 2, 6, 2**31 + 6, 16000, 16000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[2], c[2])


def test_pool_holds_every_word_equally_for_every_seed():
    words = ["yes", "no", "up"]
    for seed in (1, 2**31 + 9):
        bank, bank_ids, pool, pool_ids = synth.cell_inputs(words, 2, 9, seed, 16000, 16000)
        assert bank.shape == (6, 16000) and pool.shape == (9, 16000)
        assert list(bank_ids) == [0, 0, 1, 1, 2, 2]
        assert np.bincount(pool_ids).tolist() == [3, 3, 3]
