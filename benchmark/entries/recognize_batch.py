"""Entry ``recognize_batch``: ``pipeline.recognize_batch(x, n, bank, ids,
cfg)`` on padded clips already on the card, with the recognizer's
``device_bank()``; labels and distances read back to the host."""

import torch

from benchmark.knn import KnnCell, entry_idx


class Entry(KnnCell):
    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        self.x = torch.from_numpy(self.pool).to(device)
        self.n = torch.full((self.batch,), self.pool.shape[1], dtype=torch.int32, device=device)
        self.bank_feats, self.bank_label_ids = self.rec.device_bank()

    def request(self, r: int):
        idx = entry_idx(r, self.batch, self.pool.shape[0])
        return idx, self.x[idx[0]:idx[0] + self.batch]

    def call(self, x):
        from dsp_tpu_torch import pipeline

        ids, dists = pipeline.recognize_batch(x, self.n, self.bank_feats, self.bank_label_ids,
                                              self.rec.cfg)
        return ids.cpu().numpy(), dists.cpu().numpy()

    def release(self):
        super().release()
        self.x = self.n = self.bank_feats = self.bank_label_ids = None


def set_up(config, mix, seed, device):
    return Entry(config, mix, seed, device)
