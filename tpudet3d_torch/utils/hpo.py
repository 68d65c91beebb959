"""Lightweight hyperparameter optimisation with Optuna's surface (a copy
of ``tpudet3d/utils/hpo.py``).

The reference sweeps with Optuna (TPE sampling, median pruning).  When
``optuna`` is importable it is used; otherwise a small self-contained
study with the same shape runs: ``suggest_float`` (log or linear),
per-epoch ``report`` with the median rule's ``should_prune``, trial
states and the best trial.  With the same seed it proposes and prunes as
the JAX package's study does (Python's ``random``).
"""

import math
import random

__all__ = ['create_study', 'TrialPruned']


class TrialPruned(Exception):
    pass


class _Trial:
    def __init__(self, number, study):
        self.number = number
        self._study = study
        self.params = {}
        self._reports = {}
        self.value = None
        self.state = 'RUNNING'

    def suggest_float(self, name, low, high, log=False):
        if log:
            val = math.exp(random.uniform(math.log(low), math.log(high)))
        else:
            val = random.uniform(low, high)
        self.params[name] = val
        return val

    def suggest_int(self, name, low, high):
        val = random.randint(low, high)
        self.params[name] = val
        return val

    def suggest_categorical(self, name, choices):
        val = random.choice(list(choices))
        self.params[name] = val
        return val

    def report(self, value, step):
        self._reports[step] = value

    def should_prune(self):
        """Median rule: prune when the intermediate value is worse than the
        median of completed trials at the same step (direction-aware)."""
        if not self._reports:
            return False
        step = max(self._reports)
        peers = [t._reports[step] for t in self._study.trials
                 if t.state == 'COMPLETE' and step in t._reports]
        if len(peers) < 2:
            return False
        peers.sort()
        median = peers[len(peers) // 2]
        mine = self._reports[step]
        return (mine > median) if self._study.direction == 'minimize' \
            else (mine < median)


class _Study:
    def __init__(self, study_name='study', direction='minimize', seed=None):
        self.study_name = study_name
        self.direction = direction
        self.trials = []
        if seed is not None:
            random.seed(seed)

    def optimize(self, objective, n_trials=100, timeout=None):
        import time
        start = time.time()
        for i in range(n_trials):
            if timeout and time.time() - start > timeout:
                break
            trial = _Trial(len(self.trials), self)
            self.trials.append(trial)
            try:
                trial.value = objective(trial)
                trial.state = 'COMPLETE'
            except TrialPruned:
                trial.state = 'PRUNED'

    def get_trials(self, deepcopy=False, states=None):
        if states is None:
            return list(self.trials)
        names = {str(s).split('.')[-1] for s in states}
        return [t for t in self.trials if t.state in names]

    @property
    def best_trial(self):
        done = [t for t in self.trials if t.state == 'COMPLETE']
        if not done:
            raise ValueError('no completed trials')
        key = (lambda t: t.value) if self.direction == 'minimize' \
            else (lambda t: -t.value)
        return min(done, key=key)


def create_study(study_name='study', direction='minimize', prefer_optuna=True,
                 seed=None):
    if prefer_optuna:
        try:
            import optuna
            return optuna.create_study(study_name=study_name,
                                       direction=direction)
        except ImportError:
            pass
    return _Study(study_name, direction, seed=seed)
