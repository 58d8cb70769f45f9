"""Shared host-side batch iterator for all dataset classes (port of
``pdfnet_tpu/data/loader.py``; the same permutation, striping and tails).

Replaces the reference's torch DataLoader (+ DistributedSampler,
main.py:78-89).  Two deliberate deviations, kept from the JAX package so
that both packages see the same batches:

- train split: the tail sub-batch is DROPPED so every step sees one static
  batch shape (the reference's DataLoader pads nothing either, it just
  emits a smaller last batch).
- eval splits: the tail sub-batch is PADDED by repeating the last sample and
  marked with a ``pad_mask`` (1.0 real / 0.0 padding) so batched evaluation
  covers the whole split exactly — MetricAccumulator drops the padded rows
  (base_trainer.py:207-491 evaluates sample-by-sample instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator

import numpy as np


def iter_batches(
    fetch: Callable[[int], Dict[str, np.ndarray]],
    length: int,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    workers: int = 1,
    pad_tail: bool = False,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked sample dicts of exactly ``batch_size`` rows.

    ``process_index``/``process_count`` stripe records across hosts (the
    DistributedSampler role, reference main.py:79): process p sees records
    p, p+P, p+2P, ... of the (shuffled) order.
    """
    if shuffle:
        order = np.random.RandomState(seed).permutation(length)
    else:
        order = np.arange(length)
    if process_count > 1:
        order = order[process_index::process_count]

    pool = None
    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(workers)      # cv2/numpy release the GIL

    stop = len(order) if pad_tail else len(order) - batch_size + 1
    dropped = 0 if pad_tail else len(order) % batch_size
    if dropped:
        # surface the train-split samples-per-epoch deviation vs the
        # reference DataLoader (which emits a smaller last batch instead)
        print(f"loader: dropping {dropped}-sample tail of {len(order)} "
              f"(static train batch {batch_size}; eval splits pad instead)")
    try:
        for i in range(0, stop, batch_size):
            idxs = [int(j) for j in order[i:i + batch_size]]
            n_real = len(idxs)
            idxs = idxs + [idxs[-1]] * (batch_size - n_real)
            if pool is not None:
                samples = list(pool.map(fetch, idxs[:n_real]))
            else:
                samples = [fetch(j) for j in idxs[:n_real]]
            samples += [samples[-1]] * (batch_size - n_real)
            keys = set(samples[0])
            for s in samples[1:]:
                keys &= set(s)
            batch = {k: np.stack([s[k] for s in samples]) for k in keys}
            if pad_tail:
                mask = np.zeros((batch_size,), np.float32)
                mask[:n_real] = 1.0
                batch["pad_mask"] = mask
            yield batch
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
