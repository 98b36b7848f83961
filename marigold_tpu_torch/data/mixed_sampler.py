"""Multi-dataset batch sampler.

Copy of `marigold_tpu/data/mixed_sampler.py` for the PyTorch port (framework
free): one seed gives the same index batches in both packages.

Behavioral reference: src/dataset/mixed_sampler.py:39-118 — each batch is
drawn wholly from ONE source dataset, chosen by multinomial probability
(`prob_ls`, or proportional to per-dataset batch counts); indices are shifted to the
concatenated index space; per-dataset batch queues are regenerated (with
reshuffling) when exhausted, so one epoch ends when `len(self)` batches
were served.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence


class ConcatDataset:
    """Minimal torch-free ConcatDataset."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        for i, cum in enumerate(self.cumulative_sizes):
            if idx < cum:
                prev = self.cumulative_sizes[i - 1] if i > 0 else 0
                return self.datasets[i][idx - prev]
        raise IndexError(idx)


class MixedBatchSampler:
    """Sample batches whose members all come from the same source dataset."""

    def __init__(
        self,
        src_dataset_ls: Sequence,
        batch_size: int,
        drop_last: bool = True,
        shuffle: bool = True,
        prob: Optional[Sequence[float]] = None,
        generator: Optional[random.Random] = None,
    ):
        assert drop_last, "only drop_last=True is supported (reference parity)"
        self.src_dataset_ls = list(src_dataset_ls)
        self.n_dataset = len(self.src_dataset_ls)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = generator or random.Random()

        self.dataset_length = [len(d) for d in self.src_dataset_ls]
        self.cum_dataset_length = [
            sum(self.dataset_length[:i]) for i in range(self.n_dataset)
        ]
        # batches per dataset per epoch
        self.n_batches = [n // self.batch_size for n in self.dataset_length]

        if sum(self.n_batches) == 0:
            raise ValueError(
                "MixedBatchSampler: every dataset is smaller than "
                f"batch_size={batch_size} (dataset sizes "
                f"{self.dataset_length}) — no full batch can be drawn"
            )
        if prob is None:
            # proportional to dataset batch counts (reference default)
            total = sum(self.n_batches)
            self.prob = [n / total for n in self.n_batches]
        else:
            s = float(sum(prob))
            self.prob = [p / s for p in prob]

        self._queues: List[List[List[int]]] = [[] for _ in range(self.n_dataset)]

    def _refill(self, d_idx: int):
        indices = list(range(self.dataset_length[d_idx]))
        if self.shuffle:
            self.rng.shuffle(indices)
        offset = self.cum_dataset_length[d_idx]
        bs = self.batch_size
        self._queues[d_idx] = [
            [offset + i for i in indices[s : s + bs]]
            for s in range(0, len(indices) - bs + 1, bs)
        ]

    def __iter__(self):
        for _ in range(len(self)):
            d_idx = self.rng.choices(range(self.n_dataset), weights=self.prob)[0]
            if not self._queues[d_idx]:
                self._refill(d_idx)
            yield self._queues[d_idx].pop(0)

    def __len__(self):
        return sum(self.n_batches)
