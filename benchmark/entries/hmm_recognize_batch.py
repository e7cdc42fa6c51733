"""Entry ``hmm_recognize_batch``: ``gmm_hmm.recognize_batch(x, n, params,
cfg)`` on padded clips already on the card, with the recognizer's
``device_params()``; word ids and scores read back to the host.

The trace's guard: this path launches no kernel of the program's own
library (the front end, the emissions and the decode are PyTorch ops),
so ``guard_kernel`` names none and the harness's launch-count check
reads 0 = 0; what guards the trace is its count of kernels a request,
which must be alike in every request."""

import torch

from benchmark.hmm import HmmCell
from benchmark.knn import entry_idx


class Entry(HmmCell):
    guard_kernel = "(no library kernel)"

    def __init__(self, config, mix, seed, device):
        # a program without the batch path fails here, before any set-up
        from dsp_tpu_torch.models.gmm_hmm import recognize_batch  # noqa: F401

        super().__init__(config, mix, seed, device)
        self.x = torch.from_numpy(self.pool).to(device)
        self.n = torch.full((self.batch,), self.pool.shape[1], dtype=torch.int32, device=device)
        self.models = self.rec.device_params()

    def request(self, r: int):
        idx = entry_idx(r, self.batch, self.pool.shape[0])
        return idx, self.x[idx[0]:idx[0] + self.batch]

    def call(self, x):
        from dsp_tpu_torch.models import gmm_hmm

        ids, scores = gmm_hmm.recognize_batch(x, self.n, self.models, self.rec.cfg)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def release(self):
        super().release()
        self.x = self.n = self.models = None


def set_up(config, mix, seed, device):
    return Entry(config, mix, seed, device)
