"""Host-side inputs of the port: synthetic utterances."""

from dsp_tpu_torch.io.synth import DIGITS, synth_word

__all__ = ["DIGITS", "synth_word"]
