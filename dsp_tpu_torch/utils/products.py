"""Matrix products whose rows round alike however many rows share a call.

On the CPU, MKL picks its kernel, its blocking and its split of the work
over threads by the product's shape (and by the machine's instruction
set): the same row of ``x`` times the same ``w`` can round differently in
a product of 10 rows and in one of 20, and a slice of a batched product
differently from the same slice alone.  The port promises invariances of
that kind: a stream fed in chunks of any size equals the whole, padding
rows change nothing, a word fitted alone equals its row of a batched fit.
So on the CPU :func:`matmul` runs every product as 2-D products of
:data:`ROWS` rows (zero rows pad the last tile), one slice of the leading
axes at a time: a row's result is then that of one fixed shape, whatever
else shares the call.  On the card it is ``torch.matmul``.
"""

from __future__ import annotations

import torch

ROWS = 64        # rows of each 2-D product on the CPU


def _tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[R, K] @ [K, N] as products of ROWS rows."""
    r = x.shape[0]
    if r % ROWS:
        x = torch.cat([x, x.new_zeros(ROWS - r % ROWS, x.shape[1])])
    return torch.cat([torch.mm(t, w) for t in x.split(ROWS)])[:r]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)`` for ``x`` [..., R, K] (or [..., K]) and ``w``
    [K, N] or [*P, K, N] with ``x``'s leading axes ending in P."""
    if x.device.type != "cpu":
        return torch.matmul(x, w)
    if w.dim() == 2:
        out = _tiled(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    lead = x.shape[:-2]
    xs = x.reshape(-1, *x.shape[-2:])
    ws = w.expand(*lead, *w.shape[-2:]).reshape(-1, *w.shape[-2:])
    out = torch.stack([_tiled(a, b) for a, b in zip(xs, ws)])
    return out.reshape(*lead, x.shape[-2], w.shape[-1])
