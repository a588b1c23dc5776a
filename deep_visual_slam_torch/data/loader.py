"""Batching loader and device prefetch (port of ``data/loader.py``).

``DataLoader`` draws each epoch's order from ``(seed, epoch)`` and each
sample's generator from ``(seed, epoch, rank, position)``, as the JAX
package does, so both packages give the same batches bit for bit, under a
process group each rank its column of every global batch; samples are read
on a thread pool and collated into numpy arrays.
``device_prefetch`` keeps ``size`` batches in flight to the card through
pinned host buffers and a copy stream. ``VoDataLoader`` assembles the
config-gated sources (the path datasets, packed shards and the synthetic
mono and stereo streams) into the train, valid, test and stereo loaders.

"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import os
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data import handlers
from deep_visual_slam_torch.data.base import ConcatDataset
from deep_visual_slam_torch.parallel.mesh import world_and_rank


def collate(samples: List[Dict]) -> Dict:
    """Stack a list of sample dicts into one batch dict of arrays."""
    return {key: np.stack([s[key] for s in samples], axis=0) for key in samples[0]}


class DataLoader:
    """Epoch iterator over an indexable dataset with threaded reads.

    Shuffles per epoch with an order drawn from ``(seed, epoch)``, drops the
    last partial batch when ``drop_last``, and hands each sample a generator
    keyed on ``(seed, epoch + 1, rank, position in the epoch)``: the epoch
    counter advances when iteration starts, and the position counts from
    the start of the epoch, a skipped prefix included, so that a resumed
    epoch draws the same gaps and jitter. Under a process group of W ranks
    ``batch_size`` is the global batch: each rank yields its B/W rows of
    every global batch (``order.reshape(-1, W, B // W)[:, rank]``), the
    partial last one dropped, and the position is the rank's own. At most
    twice the local batch (and ``num_workers``) samples are read ahead.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0
        self._skip_batches = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        """The sample order of the current epoch, from ``(seed, epoch)``."""
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self._epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        return order

    def __iter__(self) -> Iterator[Dict]:
        order = self._epoch_order()
        local_bs = self.batch_size
        # Under a process group every rank computes the same global order
        # and loads its contiguous column of each global batch, so that the
        # ranks' batches, concatenated in rank order, are the global batch.
        world, rank = world_and_rank()
        if world > 1:
            if self.batch_size % world:
                raise ValueError(
                    f"global batch_size {self.batch_size} must divide by the "
                    f"world size {world}"
                )
            local_bs = self.batch_size // world
            order = (
                order[: (len(order) // self.batch_size) * self.batch_size]
                .reshape(-1, world, local_bs)[:, rank]
                .reshape(-1)
            )
        self._epoch += 1
        epoch = self._epoch
        start = self._skip_batches * local_bs
        self._skip_batches = 0
        jobs = enumerate(order[start:].tolist(), start)

        def fetch(job):
            pos, idx = job
            # Keyed on the local position and the rank: no two ranks share
            # an augmentation stream.
            sample_rng = np.random.default_rng((self.seed, epoch, rank, pos))
            return self.dataset.__getitem__(int(idx), sample_rng)

        ahead = max(2 * local_bs, self.num_workers)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque(
                pool.submit(fetch, job) for job in itertools.islice(jobs, ahead)
            )
            while pending:
                chunk = []
                while pending and len(chunk) < local_bs:
                    chunk.append(pending.popleft().result())
                    job = next(jobs, None)
                    if job is not None:
                        pending.append(pool.submit(fetch, job))
                if len(chunk) < local_bs and self.drop_last:
                    return
                yield collate(chunk)

    def skip_batches(self, n: int) -> None:
        """Start the next epoch's iteration ``n`` batches in (mid-epoch
        resume: the skipped prefix is what the interrupted run consumed)."""
        self._skip_batches = int(n)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray) and x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(x))


def device_prefetch(
    iterator: Iterable[Dict], device=None, size: int = 2
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of ``iterator`` as tensors on ``device`` (``None`` -> CUDA),
    with ``size`` batches in flight ahead of the consumer; float64 arrays
    become fp32.

    On the card each array is copied into pinned host memory and sent with
    a ``non_blocking`` copy on a side stream; before a batch is handed out
    the consumer's stream waits for its copy, and each tensor is recorded
    on that stream so that its memory is not reused while the consumer may
    still read it. The pinned buffers stay referenced until their batch has
    been handed out (the caching host allocator also keeps each block until
    its copy is done). On the CPU the arrays become tensors in place.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: _as_tensor(v) for k, v in batch.items()}
        return
    copy_stream = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def put(batch: Dict):
        pinned = {k: _as_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: p.to(device, non_blocking=True) for k, p in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready, pinned

    it = iter(iterator)
    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        out, ready, pinned = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for t in out.values():
            t.record_stream(stream)
        yield out


def _walk(ds, fn) -> None:
    """``fn`` on every leaf dataset under ``ds``."""
    if isinstance(ds, ConcatDataset):
        for d in ds.datasets:
            _walk(d, fn)
    else:
        fn(ds)


class VoDataLoader:
    """Config-gated VO data: ``train_loader`` / ``valid_loader`` /
    ``test_loader`` over the concatenated datasets, and
    ``train_stereo_loader`` / ``valid_stereo_loader`` over known-baseline
    pairs (``None`` when no stereo source is enabled).

    The sources, in the JAX package's order (which fixes the sample
    order): ``Dataset.redwood.mono`` (``RedwoodDataHandler``, rooted at
    ``root_dir`` or ``<Directory.data_dir>/redwood``),
    ``Dataset.mars_logger.mono`` (rooted at ``root_dir`` or
    ``<Directory.data_dir>/mars_logger``), ``Dataset.custom_data`` and
    ``Dataset.irs`` (mono and stereo, scenes under
    ``<Directory.data_dir>/{custom_data,irs}/{train,valid}``; a scene that
    does not load is skipped with a warning), ``Dataset.packed`` (shards
    under ``<root>/{train,valid,test}/<scene>``, ``root`` defaulting to
    ``<root_dir or Directory.data_dir>/packed``) and ``Dataset.synthetic``
    (stereo, then mono).

    ``Train.device_augment`` turns the host jitter off (the step jitters on
    the device). ``Train.uint8_h2d`` makes every train source emit uint8,
    all or nothing: if any train source cannot, the whole train set stays
    fp32, since a batch mixing the two would be stacked as unscaled fp32.
    """

    def __init__(self, config: Dict, root_dir: Optional[str] = None):
        t = config["Train"]
        ds_cfg = config["Dataset"]
        self.batch_size = t["batch_size"]
        self.num_workers = t.get("num_workers", 8)
        self.seed = t.get("seed", 42)
        image_size = (t["img_h"], t["img_w"])

        train_sets: List = []
        valid_sets: List = []
        test_sets: List = []
        train_stereo_sets: List = []
        valid_stereo_sets: List = []

        if ds_cfg.get("redwood", {}).get("mono", False):
            from deep_visual_slam_torch.data.redwood import RedwoodDataHandler

            h = RedwoodDataHandler(config, root_dir=root_dir)
            train_sets.append(h.train_dataset)
            valid_sets.append(h.valid_dataset)
            test_sets.append(h.test_dataset)

        if ds_cfg.get("mars_logger", {}).get("mono", False):
            h = handlers.MarsLoggerDataHandler(config, root_dir=root_dir)
            train_sets.append(h.train_dataset)
            valid_sets.append(h.valid_dataset)

        data_dir = config["Directory"]["data_dir"]
        for name, label, mono_cls, stereo_fn in (
            ("custom_data", "custom", handlers.CustomRigDataset, handlers.custom_stereo_dataset),
            ("irs", "irs", handlers.IrsDataset, handlers.irs_stereo_dataset),
        ):
            root = os.path.join(data_dir, name)
            if ds_cfg.get(name, {}).get("mono", False):
                for fold, target, is_train in (("train", train_sets, True),
                                               ("valid", valid_sets, False)):
                    scenes = handlers.load_scenes(
                        os.path.join(root, fold), f"{label} scene",
                        lambda d: mono_cls(d, image_size, is_train, is_train))
                    if scenes:
                        target.append(ConcatDataset(scenes))
            if ds_cfg.get(name, {}).get("stereo", False):
                for fold, target, is_train in (("train", train_stereo_sets, True),
                                               ("valid", valid_stereo_sets, False)):
                    target.extend(handlers.load_scenes(
                        os.path.join(root, fold), f"{label} stereo",
                        lambda d: stereo_fn(d, image_size, is_train)))

        packed_cfg = ds_cfg.get("packed", {})
        if packed_cfg.get("mono", False):
            from deep_visual_slam_torch.data.packed import (
                PackedSnippetDataset,
                list_packed_scenes,
            )

            root = packed_cfg.get("root") or os.path.join(
                root_dir or config["Directory"]["data_dir"], "packed"
            )
            for fold, target, is_train in (
                ("train", train_sets, True),
                ("valid", valid_sets, False),
                ("test", test_sets, False),
            ):
                scenes = [
                    PackedSnippetDataset(scene, image_size, is_train, is_train)
                    for scene in list_packed_scenes(os.path.join(root, fold))
                ]
                if scenes:
                    target.append(ConcatDataset(scenes))

        syn_cfg = ds_cfg.get("synthetic", {})
        length = syn_cfg.get("length", 256)
        if syn_cfg.get("stereo", False):
            from deep_visual_slam_torch.data.synthetic import SyntheticStereoDataset

            train_stereo_sets.append(
                SyntheticStereoDataset(image_size, length=length, seed=self.seed + 3)
            )
            valid_stereo_sets.append(
                SyntheticStereoDataset(
                    image_size, length=max(length // 8, self.batch_size),
                    seed=self.seed + 4, is_train=False,
                )
            )
        if syn_cfg.get("mono", False):
            from deep_visual_slam_torch.data.synthetic import SyntheticVoDataset

            train_sets.append(SyntheticVoDataset(image_size, length=length, seed=self.seed))
            valid_sets.append(
                SyntheticVoDataset(
                    image_size, length=max(length // 8, self.batch_size),
                    seed=self.seed + 1, is_train=False,
                )
            )
            test_sets.append(
                SyntheticVoDataset(
                    image_size, length=max(length // 8, 4), seed=self.seed + 2,
                    is_train=False,
                )
            )

        self.train_dataset = ConcatDataset(train_sets)
        self.valid_dataset = ConcatDataset(valid_sets)
        self.test_dataset = ConcatDataset(test_sets)

        if t.get("device_augment", False):
            def _disable_host_augment(ds):
                if hasattr(ds, "augment"):
                    ds.augment = False

            _walk(self.train_dataset, _disable_host_augment)

        if t.get("uint8_h2d", False):
            if not t.get("device_augment", False):
                print(
                    "Warning: Train.uint8_h2d without Train.device_augment "
                    "disables ColorJitter entirely (host jitter can't run "
                    "on uint8)"
                )
            leaves: list = []
            _walk(self.train_dataset, leaves.append)
            unsupported = sorted(
                {type(d).__name__ for d in leaves if not hasattr(d, "output_uint8")}
            )
            if unsupported:
                print(
                    "Warning: Train.uint8_h2d DISABLED: train sources "
                    f"without uint8 output: {', '.join(unsupported)} "
                    "(mixing uint8 and f32 samples in one batch would "
                    "silently train the uint8 ones unscaled)"
                )
            else:
                def _enable_uint8(ds):
                    ds.output_uint8 = True
                    ds.augment = False

                _walk(self.train_dataset, _enable_uint8)

        use_shuffle = t.get("use_shuffle", True)

        def loader(dataset, batch_size, shuffle, seed):
            return DataLoader(dataset, batch_size, shuffle=shuffle, drop_last=True,
                              num_workers=self.num_workers, seed=seed)

        self.train_loader = loader(self.train_dataset, self.batch_size, use_shuffle, self.seed)
        self.valid_loader = loader(self.valid_dataset, self.batch_size, False, self.seed)
        self.test_loader = loader(
            self.test_dataset, t.get("vis_batch_size", 1), False, self.seed
        )
        self.train_stereo_dataset = ConcatDataset(train_stereo_sets)
        self.valid_stereo_dataset = ConcatDataset(valid_stereo_sets)
        self.train_stereo_loader = (
            loader(self.train_stereo_dataset, self.batch_size, use_shuffle, self.seed + 10)
            if len(self.train_stereo_dataset) else None
        )
        self.valid_stereo_loader = (
            loader(self.valid_stereo_dataset, self.batch_size, False, self.seed + 10)
            if len(self.valid_stereo_dataset) else None
        )
