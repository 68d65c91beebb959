"""Weighted multi-loss combination with ALWA re-balancing (counterpart of
``tpudet3d/losses/manager.py``).

ALWA is carried device state: running sums and sums of squares of the
weighted losses stand for the reference's list of past values (its std is
unbiased, so std² = (Σx² − (Σx)²/n)/(n−1)), and every C steps ``lam_cls``
moves.  The update is selected with ``torch.where`` over every field, never
by a branch on a device value, so a step reads nothing back to the host.
As in the JAX package, the gradient flows through a ``lam_cls`` updated on
this step.  Under a process group the sums take the global batch's losses
(``parallel.global_mean``), so the state stays equal on every rank.
"""

import dataclasses

import torch

from ..parallel.sharding import global_mean

__all__ = ['AlwaState', 'LossManager']


@dataclasses.dataclass
class AlwaState:
    """0-d tensors: float32 but ``count`` (int32)."""
    lam_cls: torch.Tensor
    lam_reg: torch.Tensor
    sum_cls: torch.Tensor
    sumsq_cls: torch.Tensor
    sum_reg: torch.Tensor
    sumsq_reg: torch.Tensor
    count: torch.Tensor


class LossManager:
    """Combines weighted regression and classification criterions.

    criterions: ``([reg_fn...], [cls_fn...])`` of ``(pred, target) ->
    0-d tensor``; coefficients: ``([reg coeffs], [cls coeffs])``, zipped in
    config order.
    """

    def __init__(self, criterions, coefficients, alwa):
        self.reg_criterions, self.class_criterions = criterions
        self.reg_coeffs, self.class_coeffs = coefficients
        if len(self.reg_coeffs) != len(self.reg_criterions) or \
                len(self.class_coeffs) != len(self.class_criterions):
            raise ValueError('one coefficient per criterion')
        if not self.reg_criterions:
            raise ValueError('no regression criterion')
        self.use_alwa = bool(alwa.use) if alwa else False
        if self.use_alwa and not (
                self.class_criterions
                and self.reg_coeffs[0] == self.class_coeffs[0] == 1.):
            raise ValueError('ALWA needs a classification criterion and '
                             'first coefficients of 1')
        self.lam_cls0 = float(alwa.lam_cls) if self.use_alwa else 1.0
        self.lam_reg0 = float(alwa.lam_reg) if self.use_alwa else 1.0
        self.C = int(alwa.C) if self.use_alwa else 1
        self.compute_std = bool(alwa.compute_std) if self.use_alwa else False

    def init_state(self, device=None):
        f32 = dict(dtype=torch.float32, device=device)
        return AlwaState(lam_cls=torch.tensor(self.lam_cls0, **f32),
                         lam_reg=torch.tensor(self.lam_reg0, **f32),
                         sum_cls=torch.zeros((), **f32),
                         sumsq_cls=torch.zeros((), **f32),
                         sum_reg=torch.zeros((), **f32),
                         sumsq_reg=torch.zeros((), **f32),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def parse_losses(self, pred_kp, gt_kp, pred_cats, gt_cats, iter_,
                     state):
        """Returns ``(total_loss, new_state)``; ``iter_`` is the step, an int
        or a 0-d tensor."""
        reg_loss = sum(k * cr(pred_kp, gt_kp)
                       for k, cr in zip(self.reg_coeffs, self.reg_criterions))
        if self.class_criterions:
            cls_loss = sum(k * cr(pred_cats, gt_cats) for k, cr in
                           zip(self.class_coeffs, self.class_criterions))
        else:
            cls_loss = pred_kp.new_zeros(())
        if not self.use_alwa:
            return reg_loss + cls_loss, state
        reg_loss, cls_loss = global_mean(reg_loss, cls_loss)

        s_cls = state.lam_cls * cls_loss
        s_reg = state.lam_reg * reg_loss
        sum_cls = state.sum_cls + s_cls
        sumsq_cls = state.sumsq_cls + s_cls * s_cls
        sum_reg = state.sum_reg + s_reg
        sumsq_reg = state.sumsq_reg + s_reg * s_reg
        count = state.count + 1

        it = torch.as_tensor(iter_, device=count.device)
        fire = (it % self.C == 0) & (it != 0)
        n = count.float()
        mean_cls = sum_cls / n
        mean_reg = sum_reg / n
        if self.compute_std:  # 'ver_1'
            div = torch.clamp(n - 1, min=1)
            zero = torch.zeros_like(n)
            # the update's inputs where it fires and 1 elsewhere: its value
            # is discarded there, and must send no inf or NaN into the
            # gradient (the sqrt of a zero variance)
            var_cls = torch.where(fire, (sumsq_cls - sum_cls ** 2 / n) / div,
                                  1.0)
            var_reg = torch.where(fire, (sumsq_reg - sum_reg ** 2 / n) / div,
                                  1.0)
            cls = mean_cls + torch.sqrt(torch.maximum(var_cls, zero))
            reg = mean_reg + torch.sqrt(torch.maximum(var_reg, zero))
        else:                 # 'ver_2'
            cls, reg = mean_cls, mean_reg
        cls_div = torch.where(fire, cls, 1.0)
        new_lam = torch.where(cls > reg, 1.0 - (cls - reg) / cls_div,
                              state.lam_cls)

        lam_cls = torch.where(fire, new_lam, state.lam_cls)

        def keep_or_zero(x):
            return torch.where(fire, torch.zeros_like(x), x).detach()

        # the state carries values, not this step's graph
        new_state = AlwaState(
            lam_cls=lam_cls.detach(), lam_reg=state.lam_reg,
            sum_cls=keep_or_zero(sum_cls), sumsq_cls=keep_or_zero(sumsq_cls),
            sum_reg=keep_or_zero(sum_reg), sumsq_reg=keep_or_zero(sumsq_reg),
            count=keep_or_zero(count))
        # the just-updated lam_cls weighs this step's loss, as in the
        # reference
        total = state.lam_reg * reg_loss + lam_cls * cls_loss
        return total, new_state

    __call__ = parse_losses
