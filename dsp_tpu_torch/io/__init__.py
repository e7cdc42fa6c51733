"""Host-side I/O of the port: WAV decode and encode, synthetic corpora
(utterances, connected recordings, keyword-spotting streams, the hostile
corpus), the ``root/<label>/*.wav`` corpus layout, the native batch reader
and microphone capture."""

from dsp_tpu_torch.io.dataset import load_corpus_dir, make_corpus
from dsp_tpu_torch.io.record import record, record_fake
from dsp_tpu_torch.io.synth import (DIGITS, synth_connected,
                                    synth_spotting_stream, synth_word)
from dsp_tpu_torch.io.wav import read_wav, write_wav

__all__ = ["DIGITS", "synth_word", "synth_connected", "synth_spotting_stream",
           "read_wav", "write_wav", "make_corpus", "load_corpus_dir",
           "record", "record_fake"]
