"""Validation metrics and the visual test (counterpart of
``tpudet3d/eval/evaluator.py``).

Per batch the eval step (``train/steps.py``) gives per-class sums of ADD,
SADD, accuracy and, with ``compute_iou``, the 3D IoU (the batched EPnP
lift and kernel K5, one launch a batch); the host accumulates 9×5 numbers
a batch.  ``weights`` masks the padded tail of the last batch.  The
averages accumulate in float32 as the JAX package's do, so the table
prints the same.
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import AverageMeter, OBJECTRON_CLASSES, TextTable, mkdir_if_missing
from ..train.state import eval_params
from ..utils.drawing import draw_kp

__all__ = ['Evaluator']


@dataclass
class Evaluator:
    eval_step: Callable     # (params, imgs, kps, cats, weights, compute_iou)
    state_fn: Callable      # () -> the current train state
    val_loader: Any
    test_loader: Any
    test_transform: Optional[Callable]  # batched test pipeline
    put_fn: Callable                    # host batch -> device tensors
    writer: Any = None
    max_epoch: int = 0
    num_classes: int = len(OBJECTRON_CLASSES)
    samples: Any = 'random'
    num_samples: int = 10
    path_to_save_imgs: str = './testing_images'
    debug: bool = False
    debug_steps: int = 30
    test_dataset: Any = None
    seed: int = 1           # the test pipeline's generator

    def __post_init__(self):
        self._generators = {}

    def _generator(self, device):
        if device not in self._generators:
            self._generators[device] = torch.Generator(
                device=device).manual_seed(self.seed)
        return self._generators[device]

    def val(self, epoch=None, compute_iou=True):
        """Full validation epoch; prints the per-class table and returns
        (ADD, SADD, ACC, IOU) averages."""
        meters = {name: AverageMeter() for name in ('ADD', 'SADD', 'ACC', 'IOU')}
        cls_sums = np.zeros((self.num_classes, 4), np.float64)
        cls_counts = np.zeros(self.num_classes, np.float64)

        state = self.state_fn()
        params = eval_params(state)
        for it, (imgs, kps, cats, true_n) in enumerate(self.val_loader):
            imgs_d, kps_d, cats_d = self.put_fn(imgs, kps, cats)
            if self.test_transform is not None:
                imgs_d, kps_d = self.test_transform(
                    imgs_d, kps_d, self._generator(imgs_d.device))
            # mask the padded tail of the (static-shape) last batch
            weights = (torch.arange(imgs.shape[0], device=imgs_d.device)
                       < true_n).float()
            sums, _ = self.eval_step(params, imgs_d, kps_d, cats_d, weights,
                                     compute_iou=bool(compute_iou))
            add_s, sadd_s, iou_s, acc_s, counts = (
                s.cpu().numpy() for s in sums)
            bs = int(true_n)
            meters['ADD'].update(add_s.sum() / bs, bs)
            meters['SADD'].update(sadd_s.sum() / bs, bs)
            meters['ACC'].update(acc_s.sum() / bs, bs)
            meters['IOU'].update(iou_s.sum() / bs, bs)
            cls_sums += np.stack([add_s, sadd_s, acc_s, iou_s], 1)
            cls_counts += counts
            if self.debug and it == self.debug_steps:
                break

        if epoch is not None and self.writer is not None:
            self.writer.add_scalar('Val/ADD', meters['ADD'].avg, global_step=epoch)
            self.writer.add_scalar('Val/SADD', meters['SADD'].avg, global_step=epoch)
            self.writer.add_scalar('Val/ACC', meters['ACC'].avg, global_step=epoch)
            if compute_iou:
                self.writer.add_scalar('Val/IOU', meters['IOU'].avg, global_step=epoch)

        header = ['category name', 'ADD', 'SADD', 'accuracy']
        if compute_iou:
            header.append('IOU')
        table = TextTable(header)
        avg_row = ['Average metrics', meters['ADD'].avg, meters['SADD'].avg,
                   meters['ACC'].avg]
        if compute_iou:
            avg_row.append(meters['IOU'].avg)
        table.add_row(avg_row)
        for cls_ in range(self.num_classes):
            n = max(cls_counts[cls_], 1)
            row = [OBJECTRON_CLASSES[cls_], cls_sums[cls_, 0] / n,
                   cls_sums[cls_, 1] / n, cls_sums[cls_, 2] / n]
            if compute_iou:
                row.append(cls_sums[cls_, 3] / n)
            table.add_row(row)
        ep_mess = f'epoch: {epoch}\n' if epoch is not None else ''
        print(f'\nComputed val metrics:\n{ep_mess}{table}', flush=True)
        return (meters['ADD'].avg, meters['SADD'].avg, meters['ACC'].avg,
                meters['IOU'].avg)

    def visual_test(self):
        """Draw GT and predicted keypoints of N test items re-projected to
        the original frame (needs cv2)."""
        if self.test_dataset is None:
            print('visual_test: no test dataset configured, skipping')
            return
        ds = self.test_dataset
        mkdir_if_missing(self.path_to_save_imgs)
        if self.samples == 'random':
            indexes = np.random.choice(len(ds), min(self.num_samples, len(ds)),
                                       replace=False)
        else:
            indexes = self.samples

        state = self.state_fn()
        dev = state.step.device
        for idx in indexes:
            orig_img, img, kps_px, cat, crop_cords = ds[int(idx)]
            imgs_d = torch.as_tensor(np.asarray(img)[None]).to(dev)
            kps_d = torch.as_tensor(np.asarray(kps_px)[None]).to(dev)
            if self.test_transform is not None:
                imgs_d, kps_d = self.test_transform(imgs_d, kps_d,
                                                    self._generator(dev))
            _, (pred_kp, logits) = self.eval_step(
                eval_params(state), imgs_d, kps_d,
                torch.tensor([cat], dtype=torch.int64, device=dev),
                compute_iou=False)
            pred_kp = pred_kp[0].float().cpu().numpy().copy()
            gt_kp = kps_d[0].float().cpu().numpy().copy()
            draw_kp(orig_img, self.transform_kp(gt_kp, crop_cords),
                    f'{self.path_to_save_imgs}/tested_image_{idx}_true.jpg',
                    RGB=False, normalized=False)
            label = OBJECTRON_CLASSES[int(logits[0].argmax())]
            draw_kp(orig_img, self.transform_kp(pred_kp, crop_cords),
                    f'{self.path_to_save_imgs}/tested_image_{idx}_predicted.jpg',
                    RGB=False, normalized=False, label=label)
        print(f'visual test images saved to {self.path_to_save_imgs}')

    def run_eval_pipe(self, visual_only=False):
        print('.' * 10, 'Run evaluating protocol', '.' * 10)
        if not visual_only:
            self.val(compute_iou=True)
        self.visual_test()

    @staticmethod
    def transform_kp(kp, crop_cords):
        """[0,1] crop coords → original-frame pixels."""
        x0, y0, x1, y1 = crop_cords
        kp[:, 0] = kp[:, 0] * (x1 - x0) + x0
        kp[:, 1] = kp[:, 1] * (y1 - y0) + y0
        return kp
