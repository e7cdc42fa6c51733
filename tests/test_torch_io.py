"""The port's host I/O (``dsp_tpu_torch.io``) against ``dsp_tpu.io``.

WAV decode, encode and resampling bit-equal; synthetic and hostile
corpora byte-equal on the same seeds; the native batch reader equal to the
JAX package's native reader and to the Python reader; record_fake equal;
the Speech Commands split reader over a tiny split written here.
"""

import importlib
import os
import wave

import numpy as np
import pytest

from dsp_tpu.io import dataset as jds
from dsp_tpu.io import hostile as jhost
from dsp_tpu.io import native as jnative
from dsp_tpu.io import speech_commands as jsc
from dsp_tpu.io import wav as jwav
from dsp_tpu_torch.io import dataset as tds
from dsp_tpu_torch.io import hostile as thost
from dsp_tpu_torch.io import native as tnative
from dsp_tpu_torch.io import speech_commands as tsc
from dsp_tpu_torch.io import wav as twav

# the packages export the function ``record`` under the module's name
jrecord = importlib.import_module("dsp_tpu.io.record")
trecord = importlib.import_module("dsp_tpu_torch.io.record")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _write_pcm(path, sr, channels, width, seed):
    """A raw WAV of seeded samples at any rate, channel count and width."""
    rng = np.random.default_rng(seed)
    n = int(0.25 * sr) * channels
    if width == 1:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    elif width == 2:
        data = rng.integers(-32768, 32768, n).astype("<i2").tobytes()
    else:
        data = rng.integers(-2**31, 2**31, n).astype("<i4").tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data)


@pytest.mark.parametrize("sr", [8000, 16000, 44100])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_read_wav_bit_equal(tmp_path, sr, channels, width):
    p = str(tmp_path / "x.wav")
    _write_pcm(p, sr, channels, width, seed=sr + channels + width)
    for target in (None, 16000):
        (sr_t, x_t), (sr_j, x_j) = twav.read_wav(p, target), jwav.read_wav(p, target)
        assert sr_t == sr_j
        _same(x_t, x_j)


@pytest.mark.parametrize("sr", [8000, 16000, 44100])
def test_write_wav_bytes_equal(tmp_path, sr):
    x = np.random.default_rng(sr).uniform(-1.2, 1.2, sr // 4).astype(np.float32)
    twav.write_wav(str(tmp_path / "t.wav"), sr, x)
    jwav.write_wav(str(tmp_path / "j.wav"), sr, x)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    _same(twav.read_wav(str(tmp_path / "t.wav"))[1], jwav.read_wav(str(tmp_path / "j.wav"))[1])


@pytest.mark.parametrize("sr_in,sr_out", [(8000, 16000), (44100, 16000), (16000, 8000),
                                          (16000, 44100)])
def test_resample_linear_bit_equal(sr_in, sr_out):
    x = np.random.default_rng(sr_in).standard_normal(sr_in // 5).astype(np.float32)
    _same(twav.resample_linear(x, sr_in, sr_out), jwav.resample_linear(x, sr_in, sr_out))


def test_make_corpus_byte_equal():
    for kw in ({}, dict(labels=["one", "papa"], n_per_word=2, seed=3, max_samples=12000,
                        noise=0.01)):
        a, b = tds.make_corpus(**kw), jds.make_corpus(**kw)
        assert list(a) == list(b)
        for lab in a:
            assert len(a[lab]) == len(b[lab])
            for x, y in zip(a[lab], b[lab]):
                _same(x, y)


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    """root/<label>/*.wav at 16 and 8 kHz, plus a non-WAV file and a
    stray file at the root (both readers skip them)."""
    root = tmp_path_factory.mktemp("corpus")
    for i, lab in enumerate(["one", "two", "three"]):
        os.makedirs(root / lab)
        for j in range(2):
            sr = 16000 if j == 0 else 8000
            x = jds.synth_word(lab, 10 * i + j, sr=sr, max_samples=sr)
            jwav.write_wav(str(root / lab / f"{lab}_{j}.wav"), sr, x)
        (root / lab / "notes.txt").write_text("not audio")
    (root / "README").write_text("stray")
    return str(root)


@pytest.mark.parametrize("target_sr", [16000, 8000])
def test_load_corpus_dir_equal(corpus_root, target_sr):
    a = tds.load_corpus_dir(corpus_root, target_sr)
    b = jds.load_corpus_dir(corpus_root, target_sr)
    assert list(a) == list(b) == ["one", "three", "two"]
    for lab in a:
        assert len(a[lab]) == len(b[lab]) == 2
        for x, y in zip(a[lab], b[lab]):
            _same(x, y)


def test_hostile_vocab_and_speakers_equal():
    assert thost.hostile_vocab() == jhost.hostile_vocab()
    assert len(thost.hostile_vocab()) == 35
    assert thost.CONDITIONS == jhost.CONDITIONS
    for s in range(8):
        assert thost.speaker_params(s) == jhost.speaker_params(s)


@pytest.mark.parametrize("condition", ["clean", "snr10", "tilt", "reverb", "tilt+snr10"])
def test_synth_hostile_byte_equal(condition):
    for label, speaker, seed in (("w00", 0, 0), ("w31", 4, 9), ("w62", 2, 1003)):
        _same(thost.synth_hostile(label, speaker, seed, condition),
              jhost.synth_hostile(label, speaker, seed, condition))
    with pytest.raises(ValueError, match="unknown condition"):
        thost.synth_hostile("w00", 0, 0, "bogus")


def test_make_hostile_corpus_byte_equal():
    kw = dict(labels=["w10", "w13", "w44"], speakers=(4, 5), n_per=2, condition="snr5",
              seed=9, max_samples=16000)
    a, b = thost.make_hostile_corpus(**kw), jhost.make_hostile_corpus(**kw)
    assert list(a) == list(b)
    for lab in a:
        assert len(a[lab]) == 4
        for x, y in zip(a[lab], b[lab]):
            _same(x, y)


def test_record_fake_equal_and_record_gated():
    _same(trecord.record_fake(), jrecord.record_fake())
    _same(trecord.record_fake("nine", 4, 1.5, 8000), jrecord.record_fake("nine", 4, 1.5, 8000))
    assert trecord.available() == jrecord.available()
    if not trecord.available():
        with pytest.raises(RuntimeError, match="PyAudio is not installed"):
            trecord.record(0.1)


def test_native_reader_builds_into_build_dir_by_hash():
    assert tnative.available()
    path = tnative.library_path()
    assert path.parent.name == "build" and path.is_file()
    assert path.name.startswith("libwavio_") and path.name != "_libwavio.so"
    assert path != os.path.abspath(jnative._SO)


@pytest.mark.parametrize("target_sr", [16000, 8000])
def test_read_wav_batch_equal(corpus_root, tmp_path, target_sr):
    paths = sorted(os.path.join(corpus_root, lab, f)
                   for lab in ("one", "two", "three")
                   for f in os.listdir(os.path.join(corpus_root, lab)) if f.endswith(".wav"))
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    paths.append(bad)
    out, lens, failures = tnative.read_wav_batch(paths, target_sr, 20000, n_threads=3)
    j_out, j_lens, j_failures = jnative.read_wav_batch(paths, target_sr, 20000, n_threads=3)
    _same(out, j_out)
    _same(lens, j_lens)
    assert failures == j_failures == 1 and lens[-1] == 0
    # the JAX package's own native-against-Python rule (tests/test_native_io.py)
    for i, p in enumerate(paths[:-1]):
        _, want = jwav.read_wav(p, target_sr)
        assert lens[i] == len(want)
        atol = 1e-7 if jwav.read_wav(p)[0] == target_sr else 1e-5
        np.testing.assert_allclose(out[i, : lens[i]], want, atol=atol)
        got, n = tnative.read_wav_native(p, target_sr, 20000)
        assert n == lens[i]
        _same(got, out[i])
    with pytest.raises(IOError, match="native WAV decode failed"):
        tnative.read_wav_native(bad)


def test_load_corpus_dir_native_equal(corpus_root, tmp_path):
    a = tnative.load_corpus_dir_native(corpus_root, 16000, 20000)
    b = jnative.load_corpus_dir_native(corpus_root, 16000, 20000)
    py = tds.load_corpus_dir(corpus_root, 16000)
    assert list(a) == list(b) == list(py)
    for lab in a:
        for x, y, z in zip(a[lab], b[lab], py[lab]):
            _same(x, y)
            assert len(x) == len(z)
            np.testing.assert_allclose(x, z, atol=1e-5)
    broken = tmp_path / "broken"
    os.makedirs(broken / "w")
    (broken / "w" / "x.wav").write_bytes(b"RIFF garbage")
    with pytest.raises(IOError, match="failed to decode"):
        tnative.load_corpus_dir_native(str(broken))


SC2_WORDS = ["go", "no", "yes"]


@pytest.fixture(scope="module")
def sc2_root(tmp_path_factory):
    """Three words x three files in the Speech Commands layout: file 1 of
    each word in the validation list, file 2 in the testing list."""
    root = tmp_path_factory.mktemp("sc2")
    val, test = [], []
    for w in SC2_WORDS:
        os.makedirs(root / w)
        for i in range(3):
            rel = f"{w}/spk{i:02d}_nohash_0.wav"
            jwav.write_wav(str(root / rel), 16000, jds.synth_word(w, i, max_samples=16000))
            (val if i == 1 else test if i == 2 else []).append(rel)
    os.makedirs(root / "_background_noise_")
    (root / "validation_list.txt").write_text("\n".join(val) + "\n")
    (root / "testing_list.txt").write_text("\n".join(test) + "\n")
    return str(root)


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_speech_commands_split_equal(sc2_root, split):
    assert tsc.discover_words(sc2_root) == jsc.discover_words(sc2_root) == SC2_WORDS
    assert tsc.SC2_WORDS == jsc.SC2_WORDS
    pairs = tsc.list_split(sc2_root, split)
    assert pairs == jsc.list_split(sc2_root, split) and len(pairs) == 3
    assert tsc.list_split(sc2_root, split, ["no", "yes"], per_word=1, seed=2) == \
        jsc.list_split(sc2_root, split, ["no", "yes"], per_word=1, seed=2)
    got = tsc.load_split(sc2_root, split, max_samples=12000)
    want = jsc.load_split(sc2_root, split, max_samples=12000)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    assert got[3] == want[3] == SC2_WORDS


def test_speech_commands_missing_word_raises(sc2_root):
    with pytest.raises(FileNotFoundError, match="Speech Commands"):
        tsc.list_split(sc2_root, "test", ["go", "stop"])
