"""Train the MNv2-SSD-300 detector (counterpart of
``scripts/train_detector.py``):

    python -m tpudet3d_torch.tools.train_detector \\
        --config configs/detection/mnv2_ssd_300_scene_cascade.py \\
        [--root DIR] [--output_dir DIR] [--loss_balancing on|off] \\
        [--max_epochs N] [--resume PATH|auto] [--device cpu]

It keeps the JAX script's choices, so that a run means the same in both
packages: SGD with weight decay and the warmup-and-step learning rate; of
``train_cfg`` only ``loss_balancing``, ``giou_weight`` and
``cascade_pos_thr`` are read (the other thresholds are ``ssd_loss``'s
defaults, equal to every config's); ``test_cfg`` is not read; the dataset
is the scene detector items (``data.synthetic='scene'``), the synthetic
rectangles or the COCO split; the host Expand + MinIoURandomCrop run
unless ``augment.expand_crop`` is false; validation (mAP@0.5 through K3)
runs every ``save_freq`` epochs and on the last, on a quarter of the
training source at other seeds (at least 8 items) or the COCO ``test``
split when there is one.  Stdout is teed to a timestamped
``det_train.log`` in the output directory.  One card; ``--device``
defaults to it.
"""

import argparse
import os.path as osp
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import (DETECTOR_CLASSES, Logger, mkdir_if_missing,
                    read_py_config, set_random_seed)
from ..core.device import resolve_device
from ..data.det_host_transforms import build_detection_host_pipeline
from ..data.det_transforms import build_detector_augmentations
from ..data.detection_dataset import DetectionDataset, SyntheticDetection
from ..data.loader import BatchLoader
from ..detect import DetectorEvaluator, SSDDetector
from ..detect.train import (DetectorTrainer, create_detector_state,
                            make_detector_train_step, warmup_step_lr)
from ..train.pipeline import HostToDevice
from ..utils.checkpoint import latest_snapshot, resume_from

__all__ = ['main', 'setup', 'validate', 'DetRun', 'DET_BATCH_DTYPES']

# (uint8 images, float32 boxes, int64 labels, bool valid)
DET_BATCH_DTYPES = (None, np.float32, np.int64, bool)


class _DetBatchLoader(BatchLoader):
    """BatchLoader over (img, boxes, labels, valid) detection items;
    ``host_transform`` is fn(epoch, idx, img, boxes, labels, valid)."""

    def _assemble(self, indices, epoch):
        items = [self.dataset[int(i)] for i in indices]
        if self.host_transform is not None:
            items = [self.host_transform(epoch, int(i), *it)
                     for i, it in zip(indices, items)]
        return tuple(np.stack([it[k] for it in items]) for k in range(4))


def _datasets(cfg):
    """(train, validation or None) datasets of ``cfg``."""
    size, max_boxes = int(cfg.input_size), int(cfg.data.max_boxes)
    length = int(cfg.data.synthetic_length or 0)
    val_length = max(length // 4, 8)
    if cfg.data.synthetic == 'scene':
        from ..data.synthetic_scene import SceneDetection, SyntheticScene
        seed = int(cfg.data.get('scene_seed', 23))
        cache = cfg.data.get('scene_cache', '')
        return tuple(
            SceneDetection(SyntheticScene(length=n, seed=s, cache_dir=cache),
                           input_size=size, max_boxes=max_boxes)
            for n, s in ((length, seed), (val_length, seed + 917 * 2)))
    if cfg.data.synthetic:
        hard = bool(cfg.data.get('synthetic_hard'))
        return (SyntheticDetection(length=length, input_size=size,
                                   max_boxes=max_boxes, hard=hard),
                SyntheticDetection(length=val_length, input_size=size,
                                   max_boxes=max_boxes, seed=99, hard=hard))
    kw = dict(input_size=size, min_size=int(cfg.data.min_size),
              max_boxes=max_boxes)
    train = DetectionDataset(cfg.data.root, 'train', **kw)
    try:
        val = DetectionDataset(cfg.data.root, 'test', **kw)
    except FileNotFoundError:
        val = None
    return train, val


@dataclass
class DetRun:
    model: Any
    state: Any
    trainer: DetectorTrainer
    train_loader: Any
    val_loader: Optional[Any]
    test_aug: Callable
    lr_fn: Callable
    device: torch.device
    start_epoch: int = 0


def setup(cfg, device=None, resume=''):
    """Everything a run of ``cfg`` needs, on ``device`` (the card unless
    ``'cpu'``); ``resume`` is a snapshot or ``'auto'`` (the newest in
    ``cfg.output_dir``)."""
    device = resolve_device(device)
    seed = set_random_seed(int(cfg.utils.random_seeds))
    dtype = torch.bfloat16 if cfg.model.get('bf16', False) else torch.float32
    model = SSDDetector(num_classes=int(cfg.model.num_classes),
                        width_mult=float(cfg.model.width_mult), dtype=dtype,
                        cascade=bool(cfg.model.get('cascade', False)))
    state = create_detector_state(
        model, lr=float(cfg.optim.lr), momentum=float(cfg.optim.momentum),
        wd=float(cfg.optim.wd), ema_decay=cfg.optim.get('ema_decay', 0.0),
        device=device, generator=torch.Generator().manual_seed(seed))
    start_epoch = 0
    if resume == 'auto':
        resume = latest_snapshot(cfg.output_dir) or ''
        if not resume:
            print('==> --resume auto: no snapshot found, training from '
                  'scratch')
    if resume:
        state, start_epoch = resume_from(state, resume)
        print(f'==> resuming detector training at epoch {start_epoch}')

    train_ds, val_ds = _datasets(cfg)
    host_aug = build_detection_host_pipeline(
        input_size=int(cfg.input_size),
        enable=bool(cfg.augment.get('expand_crop', True)), seed=seed)
    threads = int(cfg.data.num_workers)
    loader = _DetBatchLoader(train_ds, int(cfg.data.train_batch_size),
                             shuffle=True, drop_last=True,
                             num_threads=threads, host_transform=host_aug)
    val_loader = None if val_ds is None else _DetBatchLoader(
        val_ds, int(cfg.data.val_batch_size), shuffle=False,
        num_threads=threads)
    lr_fn = warmup_step_lr(base_lr=float(cfg.optim.lr),
                           warmup_iters=int(cfg.scheduler.warmup_iters),
                           warmup_ratio=float(cfg.scheduler.warmup_ratio),
                           milestones=tuple(cfg.scheduler.steps),
                           gamma=float(cfg.scheduler.gamma),
                           steps_per_epoch=max(len(loader), 1))
    train_step = make_detector_train_step(
        state.model, state.optimizer,
        use_balance=bool(cfg.train_cfg.loss_balancing),
        ema_decay=state.ema_decay,
        giou_weight=float(cfg.train_cfg.get('giou_weight', 0.0) or 0.0),
        cascade_pos_thr=float(cfg.train_cfg.get('cascade_pos_thr', 0.5)))
    trainer = DetectorTrainer(
        train_step=train_step, state=state, train_loader=loader,
        lr_fn=lr_fn, max_epoch=int(cfg.data.max_epochs),
        log_path=cfg.output_dir,
        put_fn=HostToDevice(device, DET_BATCH_DTYPES),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        augment_fn=build_detector_augmentations(
            flip_p=float(cfg.augment.flip_p), rot_p=float(cfg.augment.rot_p)),
        print_freq=int(cfg.utils.print_freq),
        save_freq=int(cfg.utils.save_freq),
        step_counter=int(state.step))
    return DetRun(model=state.model, state=state, trainer=trainer,
                  train_loader=loader, val_loader=val_loader,
                  test_aug=build_detector_augmentations(train=False),
                  lr_fn=lr_fn, device=device, start_epoch=start_epoch)


def validate(run, epoch, add_batch=None):
    """mAP@0.5 of the trainer's state over the validation loader, the EMA
    when the state keeps one; prints and returns ``results()``.
    ``add_batch(evaluator, imgs, boxes, labels, valid)`` stands in for
    ``evaluator.add_batch``."""
    state = run.trainer.state
    evaluator = DetectorEvaluator(run.model, params=state.ema_params)
    add = add_batch or (lambda ev, *batch: ev.add_batch(*batch))
    for imgs, boxes, labels, valid, _n in run.val_loader:
        imgs_d = torch.from_numpy(imgs).to(run.device, non_blocking=True)
        imgs_d, _ = run.test_aug(imgs_d, None)
        add(evaluator, imgs_d, boxes, labels, valid)
    res = evaluator.results()
    per_cls = ' '.join(f'{DETECTOR_CLASSES[c]}:{res[c]:.3f}'
                       for c in range(len(DETECTOR_CLASSES)))
    print(f'val epoch {epoch}: mAP@0.5 {res["mAP"]:.4f} ({per_cls})',
          flush=True)
    return res


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='SSD detector training')
    parser.add_argument('--config', type=str,
                        default='./configs/detection/mnv2_ssd_300.py')
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('--output_dir', type=str, default='')
    parser.add_argument('--loss_balancing', choices=['on', 'off'], default='',
                        help='override cfg.train_cfg.loss_balancing')
    parser.add_argument('--max_epochs', type=int, default=0)
    parser.add_argument('--resume', type=str, default='',
                        help="snapshot path, or 'auto' to resume from the "
                             'newest snap_* in the output dir')
    parser.add_argument('--device', type=str, default=None,
                        choices=['cpu', 'cuda'],
                        help='device to train on (default: the card)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = read_py_config(args.config)
    if args.root:
        cfg.data.root = args.root
    if args.output_dir:
        cfg.output_dir = args.output_dir
    if args.loss_balancing:
        cfg.train_cfg.loss_balancing = args.loss_balancing == 'on'
    if args.max_epochs:
        cfg.data.max_epochs = args.max_epochs
    device = resolve_device(args.device)
    mkdir_if_missing(cfg.output_dir)
    stdout = sys.stdout
    sys.stdout = Logger(osp.join(cfg.output_dir, 'det_train.log'
                                 + time.strftime('-%Y-%m-%d-%H-%M-%S')))
    try:
        run = setup(cfg, device, args.resume)
        max_epochs = int(cfg.data.max_epochs)
        save_freq = int(cfg.utils.save_freq)
        for epoch in range(run.start_epoch, max_epochs):
            last = epoch == max_epochs - 1
            run.trainer.train(epoch, last)
            if run.val_loader is not None and (epoch % save_freq == 0
                                               or last):
                validate(run, epoch)
    finally:
        sys.stdout.close()
        sys.stdout = stdout


if __name__ == '__main__':
    main()
