"""Entry ``hmm_connected_batch``: ``gmm_hmm.recognize_level_batch(x, n, net,
cfg, masks, max_levels)`` on padded strings already on the card, with the
recognizer's network of digit and silence models and the grammar's
masks; unit ids, counts and final scores read back to the host in one
copy.

The trace's guard is ``gmm_emissions``: one launch a topology, two a
request (digits and ``sil``), each of which the trace must hold."""

import numpy as np
import torch

from benchmark.connected import ConnectedCell
from benchmark.knn import entry_idx


class Entry(ConnectedCell):
    def __init__(self, config, mix, seed, device):
        # a program without the batch path fails here, before any set-up
        from dsp_tpu_torch.models.gmm_hmm import recognize_level_batch  # noqa: F401

        super().__init__(config, mix, seed, device)
        self.x = torch.from_numpy(self.pool).to(device)
        self.n = torch.from_numpy(self.pool_lens).to(device)
        self.net = self.rec.network()
        self.masks_dev = tuple(torch.as_tensor(m, device=device) for m in self.masks)

    def request(self, r: int):
        idx = entry_idx(r, self.batch, self.pool.shape[0])
        lo = idx[0]
        return idx, (self.x[lo:lo + self.batch], self.n[lo:lo + self.batch])

    def call(self, req):
        from dsp_tpu_torch.models import gmm_hmm

        ids, counts, final = gmm_hmm.recognize_level_batch(
            *req, self.net, self.cfg, self.masks_dev, self.max_levels, self.word_penalty)
        got = torch.cat([ids.to(final.dtype), counts[:, None].to(final.dtype), final],
                        dim=1).cpu().numpy()
        lv = self.max_levels
        return (got[:, :lv].astype(np.int64), got[:, lv].astype(np.int64),
                np.ascontiguousarray(got[:, lv + 1:]))

    def release(self):
        super().release()
        self.x = self.n = self.net = self.masks_dev = None


def set_up(config, mix, seed, device):
    return Entry(config, mix, seed, device)
