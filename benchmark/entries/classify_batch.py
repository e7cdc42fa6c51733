"""Entry ``classify_batch``: ``KnnDtwRecognizer.classify_batch(signals,
return_distances=True)`` on a list of host clips.  The program pads
them, copies them to the card, runs the pipeline and reads labels and
distances back."""

import numpy as np

from benchmark.knn import KnnCell, entry_idx


class Entry(KnnCell):
    def __init__(self, config, mix, seed, device):
        super().__init__(config, mix, seed, device)
        self.ids = {lab: i for i, lab in enumerate(self.rec.labels)}

    def request(self, r: int):
        idx = entry_idx(r, self.batch, self.pool.shape[0])
        return idx, [self.pool[j] for j in idx]

    def call(self, signals):
        labels, dists = self.rec.classify_batch(signals, return_distances=True)
        return np.asarray([self.ids.get(lab, -1) for lab in labels]), dists


def set_up(config, mix, seed, device):
    return Entry(config, mix, seed, device)
