"""Host input pipeline: threaded prefetch of numpy batches (counterpart of
``tpudet3d/data/loader.py``).

Decoding, cropping, resizing and the host warps run on background threads
(cv2 releases the GIL); a bounded queue overlaps them with the card's
steps.  Batches stay numpy: the trainer's ``put_fn`` moves them to the
card.  Shuffling follows the reference: train shuffled with ``drop_last``,
val shuffled with ``seed + 1``, test in order with ``seed + 2``.

With a ``torch.distributed`` process group each process reads its own
interleaved slice ``rank::world`` of the identically shuffled index
stream, and every process gets the same number of batches (a collective
in each step or validation batch would wait forever otherwise): with
``drop_last`` the stream is cut to a multiple of the processes, else a
process short of an item repeats the stream's first, which its last
batch's ``true_n`` leaves out.  ``build_loader`` sizes each process's
batches as the config's global batch over the processes.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .dataset import Objectron, SyntheticObjectron

__all__ = ['BatchLoader', 'build_loader']


def _process_slice():
    """(number of processes, this process's rank) of the default process
    group, or (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class BatchLoader:
    """Iterable over (imgs_u8 [B,H,W,3], kps_px [B,9,2], cats [B], true_n)
    batches; ``true_n`` counts the samples of a padded last batch that are
    real."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_threads=4, prefetch=2, seed=0, pad_partial=True,
                 host_transform=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.pad_partial = pad_partial
        self.host_transform = host_transform  # fn(epoch, idx, img, kps)
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        n_proc, rank = _process_slice()
        n_pad = 0
        if n_proc > 1:
            if self.drop_last:
                idx = idx[:len(idx) - len(idx) % n_proc][rank::n_proc]
            else:
                mine = idx[rank::n_proc]
                n_pad = -(-len(idx) // n_proc) - len(mine)
                idx = np.concatenate([mine, idx[:n_pad]])
        n_full = len(idx) // self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        rem = len(idx) - n_full * self.batch_size
        if rem and not self.drop_last:
            tail = idx[n_full * self.batch_size:]
            if self.pad_partial:
                # pad to the static batch size by wrapping; true_n lets
                # the metrics mask the padding
                pad = idx[:self.batch_size - rem]
                batches.append(np.concatenate([tail, pad]))
            else:
                batches.append(tail)
        self._true_tail = (rem if rem else self.batch_size) - n_pad
        return batches

    def _assemble(self, indices, epoch):
        items = [self.dataset[int(i)] for i in indices]
        if self.host_transform is not None:
            items = [
                (*self.host_transform(epoch, int(i), it[0], it[1]),
                 *it[2:])
                for i, it in zip(indices, items)]
        imgs = np.stack([it[0] for it in items])
        kps = np.stack([it[1] for it in items])
        cats = np.asarray([it[2] for it in items], np.int32)
        return imgs, kps, cats

    def __iter__(self):
        batches = self._index_batches()
        # one epoch value for both the dataset's crop jitter and the host
        # transforms, captured here so that workers of an abandoned
        # iterator never read the next epoch's
        epoch = self._epoch
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)
        self._epoch += 1
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # a worker's exception must reach the consumer, which would
            # otherwise wait on q.get() for a sentinel that never comes
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    futures = [pool.submit(self._assemble, b, epoch)
                               for b in batches]
                    for i, fut in enumerate(futures):
                        if stop.is_set():
                            for f in futures[i:]:
                                f.cancel()
                            break
                        q.put(fut.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)
            else:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            n_emitted = 0
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                if item is None:
                    break
                n_emitted += 1
                is_last = n_emitted == len(batches)
                true_n = self._true_tail if is_last else self.batch_size
                yield (*item, true_n)
        finally:
            stop.set()
            # unblock a producer waiting on a full queue
            while thread.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()


def _make_dataset(config, mode, seed=0):
    resize = tuple(config.data.resize)
    synthetic = config.data.get('synthetic', False)
    if synthetic == 'scene':
        # coherent full-frame scenes cropped per object
        from .synthetic_scene import SceneCrops, SyntheticScene
        length = int(config.data.get('synthetic_length', 1024))
        if mode != 'train':
            length = max(length // 4, 1)
        seeds = {'train': 0, 'val': 1, 'test': 2}
        scene = SyntheticScene(length=length,
                               seed=int(config.data.get('scene_seed', 23))
                               + 917 * seeds[mode],
                               cache_dir=config.data.get('scene_cache', ''))
        det_boxes = (config.data.get('det_boxes', '')
                     if mode == 'train' else '')
        return SceneCrops(
            scene, resize=resize, mode=mode, det_boxes=det_boxes,
            selflabel_p=float(config.data.get('selflabel_p', 0.5)),
            selflabel_margin=float(config.data.get('selflabel_margin', 10.0)))
    if synthetic:
        length = int(config.data.get('synthetic_length', 1024))
        if mode != 'train':
            length = max(length // 4, 1)
        return SyntheticObjectron(length=length, mode=mode, resize=resize,
                                  category_list=config.data.category_list)
    return Objectron(config.data.root, mode=mode, resize=resize,
                     category_list=config.data.category_list,
                     crop_jitter=bool(config.data.get('crop_jitter', False)),
                     seed=seed)


def build_loader(config, seed=0):
    """train/val/test loaders; the geometric train augmentations run in the
    loader threads (``host_transforms``)."""
    from ..parallel.sharding import local_batch
    from .host_transforms import build_host_pipeline
    host_train = build_host_pipeline(config.train_data_pipeline or [],
                                     seed=seed)
    threads = int(config.data.num_workers or 4)
    val_batch = local_batch(int(config.data.val_batch_size))
    train = BatchLoader(_make_dataset(config, 'train', seed=seed),
                        local_batch(int(config.data.train_batch_size)),
                        shuffle=True, drop_last=True, num_threads=threads,
                        seed=seed, host_transform=host_train)
    val = BatchLoader(_make_dataset(config, 'val', seed=seed), val_batch,
                      shuffle=True, num_threads=threads, seed=seed + 1)
    test = BatchLoader(_make_dataset(config, 'test', seed=seed), val_batch,
                       shuffle=False, num_threads=threads, seed=seed + 2)
    return train, val, test
