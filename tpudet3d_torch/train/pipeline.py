"""One-call assembly of a training run (counterpart of
``tpudet3d/train/pipeline.py``): model, loss manager, optimizer and
schedule, the train state, the train step with the device augmentations
fused in, the eval step, the test augmentations, the host-to-card mover
and the loaders.  A reference checkpoint named by the config is loaded
(``utils/torch_import.py``).  The config's ``data_parallel`` (or torchrun's
environment) joins a process group (``parallel/``): each process drives
one device and reads its share of the global batch.
"""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..data.loader import build_loader
from ..data.transforms import build_augmentations
from ..parallel.sharding import maybe_init_distributed
from ..utils.torch_import import (load_torch_checkpoint_into,
                                  resolve_pretrained_path)
from .optim import build_scheduler
from .state import create_train_state
from .steps import make_eval_step, make_train_step

__all__ = ['TrainingPipeline', 'setup_training', 'HostToDevice',
           'resolve_pretrained_path']


class HostToDevice:
    """``put(*arrays)``: a numpy batch → tensors on ``device``, each array
    cast to its entry of ``dtypes`` (None keeps it): by default (uint8
    images, float32 keypoints, int64 categories).  On the card the arrays
    go through pinned host buffers, two sets used in turns, by
    non-blocking copies; before a set is written again the host waits on
    the event recorded after its last copy (long done by then)."""

    def __init__(self, device, dtypes=(None, np.float32, np.int64)):
        self.device = torch.device(device)
        self.dtypes = tuple(dtypes)
        self.slots = [None, None]   # (pinned tensors, event) per set
        self.n = 0

    def __call__(self, *arrays):
        if len(arrays) != len(self.dtypes):
            raise ValueError(f'expected {len(self.dtypes)} arrays, got '
                             f'{len(arrays)}')
        arrays = tuple(np.asarray(a) if d is None else np.asarray(a, d)
                       for a, d in zip(arrays, self.dtypes))
        if self.device.type != 'cuda':
            return tuple(torch.from_numpy(a).to(self.device) for a in arrays)
        k = self.n % 2
        self.n += 1
        slot = self.slots[k]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or any(b.shape != a.shape or
                               b.numpy().dtype != a.dtype
                               for b, a in zip(slot[0], arrays)):
            slot = ([torch.from_numpy(a).pin_memory() for a in arrays],
                    torch.cuda.Event())
            self.slots[k] = slot
        else:
            for b, a in zip(slot[0], arrays):
                np.copyto(b.numpy(), a)
        out = tuple(b.to(self.device, non_blocking=True) for b in slot[0])
        slot[1].record()
        return out


@dataclass
class TrainingPipeline:
    model: Any
    loss_manager: Any
    optimizer: Any
    lr_schedule: Optional[Callable]
    state: Any
    train_step: Callable
    eval_step: Callable
    train_aug: Callable
    test_aug: Callable
    device: torch.device
    put_fn: Callable
    train_loader: Any = None
    val_loader: Any = None
    test_loader: Any = None


def _maybe_import_torch_weights(cfg, state):
    """Load the reference (ImageNet) checkpoint that ``model.pretrained``
    or a ``.pth`` ``model.load_weights`` names into the state's model
    (``utils/torch_import.py``, the JAX package's matcher).  With no local
    file the run trains from random init, as the JAX package's does;
    ``model.resume`` or a port snapshot (``snap_N.pt``) as
    ``load_weights`` are the CLI's to load.  An EMA restarts from the
    loaded weights (the JAX package's keeps its random init)."""
    if cfg.model.get('resume'):
        return state
    lw = str(cfg.model.get('load_weights') or '')
    if lw.endswith('.pth'):
        path = lw
    else:
        if lw:
            return state
        pretrained = cfg.model.get('pretrained', False)
        if not pretrained:
            return state
        path = resolve_pretrained_path(cfg.model.name, pretrained)
        if path is None:
            print(f'WARNING: model.pretrained={pretrained!r} but no local '
                  f'torch checkpoint found (set $TPUDET3D_PRETRAINED_DIR or '
                  f'place pretrained/{cfg.model.name}.pth); '
                  f'training from random init')
            return state
    load_torch_checkpoint_into(state.model, path)
    if state.ema_params is not None:
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                state.ema_params[k].copy_(p)
    return state


def setup_training(cfg, device=None, seed=None, with_loaders=True):
    """The pipeline on ``device`` (the card unless ``'cpu'``; under a
    process group this process's card); ``seed`` (default
    ``cfg.utils.random_seeds``) seeds the model's init and the loaders."""
    device = maybe_init_distributed(cfg, device)
    if seed is None:
        seed = int(cfg.utils.random_seeds or 5)
    state = create_train_state(cfg, device=device,
                               generator=torch.Generator().manual_seed(seed))
    state = _maybe_import_torch_weights(cfg, state)
    train_aug, test_aug = build_augmentations(cfg)
    pipe = TrainingPipeline(
        model=state.model, loss_manager=state.loss_manager,
        optimizer=state.optimizer, lr_schedule=build_scheduler(cfg),
        state=state,
        # the device augmentations run inside the train step
        train_step=make_train_step(state.model, state.loss_manager,
                                   state.optimizer, augment_fn=train_aug,
                                   ema_decay=state.ema_decay),
        eval_step=make_eval_step(state.model, num_classes=9),
        train_aug=train_aug, test_aug=test_aug, device=device,
        put_fn=HostToDevice(device))
    if with_loaders:
        pipe.train_loader, pipe.val_loader, pipe.test_loader = build_loader(
            cfg, seed=seed)
    return pipe
