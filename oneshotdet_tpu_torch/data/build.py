"""Data loader assembly (counterpart of ``oneshotdet_tpu/data/build.py``).

``make_data_loader`` wires the episodic dataset, the sampler and the
collator into a re-iterable loader of batch dicts, in the JAX loader's
batch order: no shuffle at loader level (the episode list is shuffled with
seed 6666), batches grouped by orientation where the cfg has more than one
query bucket or asks for aspect-ratio grouping.

The port has one loader, ``PrefetchingLoader``: the main thread draws each
episode (``COCODataset.plan``) in index order, host threads decode and crop
(``COCODataset.load``), and the main thread collates, which on the card
uploads uint8 pixels and launches the resize kernel.
``DATALOADER.USE_PROCESS_WORKERS`` has no counterpart: the resize and
normalization that the JAX package's worker processes run on the host, and
the float32 slots they move through shared memory, are on the card here.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from .collate import BatchCollator
from .datasets.coco import COCODataset
from .paths_catalog import DatasetCatalog
from .samplers import (
    DistributedSampler,
    grouped_batches,
    grouped_iteration_batches,
    iterate_batches,
    iteration_based_batches,
)
from .transforms import build_fused_transforms


def build_dataset(cfg, dataset_name: str, is_train: bool) -> COCODataset:
    info = DatasetCatalog.get(dataset_name)
    if info["factory"] != "COCODataset":
        raise ValueError(f"unknown dataset factory {info['factory']}")
    return COCODataset(cfg, ann_file=info["args"]["ann_file"], root=info["args"]["root"],
                       is_train=is_train, transforms=build_fused_transforms(cfg, is_train))


PREFETCH_BATCHES = 2     # batches planned and decoding ahead of the one collated


class PrefetchingLoader:
    """Iterates collated batches; ``num_workers`` host threads (at least
    one) decode ``PREFETCH_BATCHES`` batches ahead. ``batch_iter()`` gives a
    pass's lists of dataset indices. Each pass draws its episodes in index
    order in the calling thread, so the batches do not depend on the worker
    count."""

    def __init__(self, dataset, batch_iter, collator, num_workers=4):
        self.dataset = dataset
        self.batch_iter = batch_iter
        self.collator = collator
        self.num_workers = num_workers

    def __iter__(self) -> Iterator[dict]:
        ds = self.dataset
        pool = ThreadPoolExecutor(max(1, self.num_workers))
        pending: collections.deque = collections.deque()
        batches = iter(self.batch_iter())

        def submit() -> bool:
            batch_idx = next(batches, None)
            if batch_idx is None:
                return False
            episodes = [ds.plan(i) for i in batch_idx]
            pending.append([pool.submit(ds.load, ep) for ep in episodes])
            return True

        try:
            while len(pending) < PREFETCH_BATCHES and submit():
                pass
            while pending:
                futures = pending.popleft()
                items = [f.result() for f in futures]
                submit()
                yield self.collator(items)
        finally:
            for futures in pending:
                for f in futures:
                    f.cancel()
            pool.shutdown(wait=True)


def make_data_loader(cfg, is_train: bool = True, is_distributed: bool = False,
                     start_iter: int = 0, num_replicas: int = 1, rank: int = 0, device=None):
    """(loader, dataset) for the cfg's first TRAIN or TEST dataset on one
    card; the loader's pixels land on ``device`` (default "cuda"). A train
    loader gives the batches of iterations ``start_iter`` to
    SOLVER.MAX_ITER - 1, as the JAX loader does. More than one replica
    raises NotImplementedError."""
    replicas = num_replicas if is_distributed else 1
    if replicas > 1:
        raise NotImplementedError(f"{replicas} replicas: distributed sampling is not ported "
                                  "to oneshotdet_tpu_torch (one card)")
    if is_train:
        images_per_batch = cfg.SOLVER.IMS_PER_BATCH
        num_iters = cfg.SOLVER.MAX_ITER
        names = cfg.DATASETS.TRAIN
    else:
        images_per_batch = cfg.TEST.IMS_PER_BATCH
        num_iters = None
        names = cfg.DATASETS.TEST

    dataset = build_dataset(cfg, names[0], is_train)
    collator = BatchCollator(cfg, device=device)
    sampler = DistributedSampler(len(dataset), num_replicas=1, rank=0, shuffle=False)
    grouping = cfg.DATALOADER.ASPECT_RATIO_GROUPING or len(cfg.TPU.QUERY_BUCKETS) > 1
    # a factory, so the loader is re-iterable
    if is_train:
        if grouping:
            batch_iter = lambda: grouped_iteration_batches(  # noqa: E731
                dataset, sampler, images_per_batch, num_iters, start_iter)
        else:
            batch_iter = lambda: iteration_based_batches(  # noqa: E731
                sampler, images_per_batch, num_iters, start_iter)
    else:
        if grouping:
            batch_iter = lambda: grouped_batches(  # noqa: E731
                dataset, sampler, images_per_batch, drop_last=False)
        else:
            batch_iter = lambda: iterate_batches(  # noqa: E731
                sampler, images_per_batch, drop_last=False)
    loader = PrefetchingLoader(dataset, batch_iter, collator,
                               num_workers=cfg.DATALOADER.NUM_WORKERS)
    return loader, dataset
