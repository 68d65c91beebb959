"""Training and evaluation CLI of the regressor (counterpart of
``scripts/main.py``):

    python -m tpudet3d_torch.tools.main --config configs/scene_regressor.py \\
        [--root DIR] [--output_dir DIR] [--device cpu] [--wo_saving_checkpoint]

The config file, ``--root``/``--output_dir`` overrides, stdout teed to a
timestamped log in ``output_dir`` beside ``dumped_config.py``, resume
(``model.resume``) or tolerant weights (``model.load_weights``),
validation every ``eval_freq`` epochs with the 3D IoU on the last one
only, and the visual test at the end; ``regime.type='evaluation'`` only
validates.  ``--device`` defaults to the card.  As in the reference,
passing ``--wo_saving_checkpoint`` turns saving off.
"""

import argparse
import os.path as osp
import sys
import time
from shutil import copyfile

import torch

from ..core import (Logger, check_isfile, merge_cli_overrides,
                    mkdir_if_missing, read_py_config, set_random_seed)
from ..data.loader import _make_dataset
from ..eval.evaluator import Evaluator
from ..train import param_count
from ..train.pipeline import setup_training
from ..train.trainer import Trainer
from ..utils.checkpoint import load_pretrained_weights, resume_from

__all__ = ['main', 'make_writer']


def make_writer(output_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(output_dir)
    except ImportError:
        print('tensorboard not available; scalar logging disabled')
        return None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='3D-object-detection training')
    parser.add_argument('--root', type=str, default='', help='path to root folder')
    parser.add_argument('--output_dir', type=str, default='',
                        help='directory to store training artifacts')
    parser.add_argument('--config', type=str, default='./configs/default_config.py',
                        help='path to config')
    parser.add_argument('--device', type=str, default=None,
                        choices=['cpu', 'cuda'],
                        help='device to train on (default: the card)')
    # the reference's quirk: passing the flag DISABLES saving
    parser.add_argument('--wo_saving_checkpoint', action='store_false',
                        help='if switched on -- the chkpt will not be saved')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = read_py_config(args.config)
    merge_cli_overrides(cfg, args)

    log_name = 'train.log' if cfg.regime.type == 'training' else 'test.log'
    log_name += time.strftime('-%Y-%m-%d-%H-%M-%S')
    mkdir_if_missing(cfg.output_dir)
    stdout = sys.stdout
    sys.stdout = Logger(osp.join(cfg.output_dir, log_name))
    try:
        copyfile(args.config, osp.join(cfg.output_dir, 'dumped_config.py'))
        run(cfg, args)
    finally:
        sys.stdout.close()
        sys.stdout = stdout


def run(cfg, args):
    seed = set_random_seed(int(cfg.utils.random_seeds))
    pipe = setup_training(cfg, device=args.device, seed=seed)
    print(f'device: {pipe.device}'
          + (f' ({torch.cuda.get_device_name(pipe.device)})'
             if pipe.device.type == 'cuda' else ''))
    print(f'model: {cfg.model.name}; params: {param_count(pipe.model):,}')

    state = pipe.state
    if cfg.model.resume:
        state, start_epoch = resume_from(state, cfg.model.resume)
    else:
        start_epoch = 0
        if cfg.model.load_weights:
            if not check_isfile(cfg.model.load_weights) and \
                    not osp.isdir(cfg.model.load_weights):
                raise RuntimeError("the checkpoint isn't found or can't be loaded!")
            state = load_pretrained_weights(state, cfg.model.load_weights)

    writer = make_writer(cfg.output_dir)
    train_step_counter = ((start_epoch - 1) * len(pipe.train_loader)
                          if start_epoch > 1 else 0)
    trainer = Trainer(train_step=pipe.train_step,
                      state=state,
                      train_loader=pipe.train_loader,
                      lr_schedule=pipe.lr_schedule,
                      writer=writer,
                      max_epoch=int(cfg.data.max_epochs),
                      log_path=cfg.output_dir,
                      put_fn=pipe.put_fn,
                      generator=torch.Generator(
                          device=pipe.device).manual_seed(seed),
                      save_chkpt=args.wo_saving_checkpoint,
                      debug=bool(cfg.utils.debug_mode),
                      debug_steps=int(cfg.utils.debug_steps),
                      save_freq=int(cfg.utils.save_freq),
                      print_freq=int(cfg.utils.print_freq),
                      train_step_counter=train_step_counter)
    evaluator = Evaluator(eval_step=pipe.eval_step,
                          state_fn=lambda: trainer.state,
                          val_loader=pipe.val_loader,
                          test_loader=pipe.test_loader,
                          test_transform=pipe.test_aug,
                          put_fn=pipe.put_fn,
                          writer=writer,
                          max_epoch=int(cfg.data.max_epochs),
                          path_to_save_imgs=cfg.output_dir,
                          debug=bool(cfg.utils.debug_mode),
                          debug_steps=int(cfg.utils.debug_steps),
                          test_dataset=_make_dataset(cfg, 'test'))

    if cfg.regime.type == 'evaluation':
        evaluator.run_eval_pipe(cfg.regime.vis_only)
    else:
        if cfg.regime.type != 'training':
            raise ValueError(f'unknown regime {cfg.regime.type!r}')
        if cfg.model.resume:
            evaluator.val()
        for epoch in range(start_epoch, int(cfg.data.max_epochs)):
            is_last_epoch = epoch == int(cfg.data.max_epochs) - 1
            trainer.train(epoch, is_last_epoch)
            if epoch % int(cfg.utils.eval_freq) == 0 or is_last_epoch:
                # the reference's quirk: the 3D IoU on the last epoch only
                evaluator.val(epoch, is_last_epoch)
        evaluator.visual_test()
    if writer is not None:
        writer.close()


if __name__ == '__main__':
    main()
