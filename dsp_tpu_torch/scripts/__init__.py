"""Command-line scripts of the port (run with ``python -m``).

``mb_wavefront`` measures kernels 6-10.  The evaluation scripts
(``results_matrix``, ``robustness``, ``hostile_vad``, ``hostile_matrix``,
``oov_eval``, ``spot_eval``, ``connected_eval``, ``grammar_eval``) are the
JAX package's ``scripts/`` of the same names: the same flags, corpora and
table lines, on the device ``--device`` names (default ``cuda``; no probe,
no fallback).
"""

from __future__ import annotations

import subprocess

import torch


def describe_device(device) -> str:
    """What the JAX scripts print as ``jax.devices()[0]``: the torch device
    and, on a card, ``nvidia-smi``'s name and power limit of it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return f"cuda:{index} ({smi})"
