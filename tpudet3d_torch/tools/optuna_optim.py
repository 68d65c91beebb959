"""Hyperparameter sweep over the wing loss's (w, eps) (counterpart of
``scripts/optuna_optim.py``):

    python -m tpudet3d_torch.tools.optuna_optim \\
        --config configs/default_config.py [-e EPOCHS] [--n_trials N] \\
        [--n_training_iterations F] [--n_validate_iterations F] [--device cpu]

Built on ``utils/hpo.py``: Optuna when it is importable, else the built-in
random search with median pruning.  Each trial trains from the config's
seed for ``--epochs`` on the first ``F`` of the training batches and
scores validation SADD (minimised) on the first ``F`` of the validation
batches.  ``--device`` defaults to the card.
"""

import argparse
import os.path as osp
import sys
import time
from functools import partial

import numpy as np
import torch

from ..core import AverageMeter, Logger, read_py_config, set_random_seed
from ..train.optim import set_learning_rate
from ..train.pipeline import setup_training
from ..utils.hpo import TrialPruned, create_study

__all__ = ['main', 'objective']


def objective(cfg, args, trial):
    """One trial: validation SADD after the last epoch."""
    eps = trial.suggest_float('eps', 0.01, 3)
    w = trial.suggest_float('w', 0.01, 10)
    cfg.loss.w = w
    cfg.loss.eps = eps
    print(f'\nnext trial with [w: {w:.4f}, epsilon: {eps:.4f}]')

    pipe = setup_training(cfg, device=args.device)
    state = pipe.state
    gen = torch.Generator(device=pipe.device).manual_seed(0)

    n_train = max(1, int(args.n_training_iterations * len(pipe.train_loader)))
    n_val = max(1, int(args.n_validate_iterations * len(pipe.val_loader)))

    obj = float('inf')
    for epoch in range(args.epochs):
        if pipe.lr_schedule is not None:
            set_learning_rate(state.optimizer, pipe.lr_schedule(epoch))
        losses = AverageMeter()
        for it, (imgs, kps, cats, _n) in enumerate(pipe.train_loader):
            if it >= n_train:
                break
            # the augmentations run inside the train step
            state, metrics = pipe.train_step(
                state, *pipe.put_fn(imgs, kps, cats), gen)
            losses.update(float(metrics[0]), imgs.shape[0])
        sadd_meter = AverageMeter()
        for it, (imgs, kps, cats, _n) in enumerate(pipe.val_loader):
            if it >= n_val:
                break
            imgs_d, kps_d, cats_d = pipe.put_fn(imgs, kps, cats)
            imgs_d, kps_d = pipe.test_aug(imgs_d, kps_d, gen)
            (_add, sadd_s, _iou, _acc, _c), _ = pipe.eval_step(
                None, imgs_d, kps_d, cats_d, compute_iou=False)
            sadd_meter.update(float(np.asarray(sadd_s.cpu()).sum())
                              / imgs.shape[0], imgs.shape[0])
        obj = sadd_meter.avg
        print(f'trial {trial.number} epoch {epoch}: loss {losses.avg:.4f} '
              f'val SADD {obj:.4f}')
        trial.report(obj, epoch)
        if trial.should_prune():
            raise TrialPruned()
    return obj


def _trials_by_state(study, name):
    try:
        from optuna.trial import TrialState
        return study.get_trials(deepcopy=False,
                                states=[getattr(TrialState, name)])
    except ImportError:
        return study.get_trials(states=[name])


def main(argv=None):
    parser = argparse.ArgumentParser(description='hyperparameter sweep')
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('--disable_store_log', action='store_false')
    parser.add_argument('--config', type=str,
                        default='./configs/default_config.py')
    parser.add_argument('-e', '--epochs', type=int, default=150)
    parser.add_argument('--n_trials', type=int, default=100)
    parser.add_argument('--n_training_iterations', type=float, default=.5)
    parser.add_argument('--n_validate_iterations', type=float, default=.5)
    parser.add_argument('--device', type=str, default=None,
                        choices=['cpu', 'cuda'],
                        help='device to train on (default: the card)')
    args = parser.parse_args(argv)
    cfg = read_py_config(args.config)
    if args.root:
        cfg.data.root = args.root
    stdout = sys.stdout
    if args.disable_store_log:
        sys.stdout = Logger(osp.join(
            cfg.output_dir, 'optuna.log' + time.strftime('-%Y-%m-%d-%H-%M-%S')))
    set_random_seed(int(cfg.utils.random_seeds))

    study = create_study(study_name='regression task', direction='minimize')
    try:
        study.optimize(partial(objective, cfg, args), n_trials=args.n_trials)
    finally:
        pruned = _trials_by_state(study, 'PRUNED')
        complete = _trials_by_state(study, 'COMPLETE')
        print('Study statistics: ')
        print('  Number of finished trials: ', len(study.trials))
        print('  Number of pruned trials: ', len(pruned))
        print('  Number of complete trials: ', len(complete))
        if complete:
            trial = study.best_trial
            print('Best trial:')
            print('  Value: ', trial.value)
            print('  Params: ')
            for key, value in trial.params.items():
                print(f'    {key}: {value}')
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout
    return study


if __name__ == '__main__':
    main()
