"""Host-side inputs of the port: synthetic utterances, connected
recordings and keyword-spotting streams."""

from dsp_tpu_torch.io.synth import (DIGITS, synth_connected,
                                    synth_spotting_stream, synth_word)

__all__ = ["DIGITS", "synth_word", "synth_connected", "synth_spotting_stream"]
