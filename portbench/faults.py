"""Faults planted under the timed path, for the check that each turns ``correct`` false.

Each is a context manager that breaks the program from outside for as long
as it is open: ``still_step`` (the optimizer counts its step and leaves the
parameters as they are), ``half_batch`` (the PPO loss over the first half
of each minibatch's env slots, the mean taken over them alone),
``altered_spectrogram`` (one value of the audio observation moved by 1 % of
its peak where it is produced) and ``altered_value`` (the critic's values
moved by 0.1 % of their peak where the policy acts). The cell runs on one
card, so it has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, attr, make):
    original = getattr(obj, attr)
    setattr(obj, attr, make(original))
    try:
        yield
    finally:
        setattr(obj, attr, original)


def still_step():
    import torch

    from avlen_tpu_torch.rl import ppo

    def make(step):
        def still(self):
            self.count += 1
            return torch.zeros(())
        return still

    return _patched(ppo._PPOOptimizer, "step", make)


def half_batch():
    from avlen_tpu_torch.rl import ppo

    def make(loss):
        def half(evaluate_actions, obs, actions, old_log_probs, initial_hidden, masks, returns, advantages,
                 old_values, config):
            h = actions.shape[1] // 2

            def cut(x):
                return x[:, :h]

            return loss(evaluate_actions, {k: cut(v) for k, v in obs.items()}, cut(actions), cut(old_log_probs),
                        type(initial_hidden)(*(x[:h] for x in initial_hidden)), cut(masks), cut(returns),
                        cut(advantages), cut(old_values), config)
        return half

    return _patched(ppo, "ppo_loss", make)


def altered_spectrogram():
    from avlen_tpu_torch.ops import spectrogram_cuda

    def make(spec):
        def altered(audio, config):
            out = spec(audio, config)
            out[0, 0, 0, 0] += 0.01 * out.abs().max()
            return out
        altered.launches = getattr(spec, "launches", 0)  # the launch counts on the module's name
        return altered

    return _patched(spectrogram_cuda, "spectrogram", make)


def altered_value():
    from avlen_tpu_torch.models.smt_policy import SMTPolicy

    def make(act):
        def altered(self, *a, **k):
            action, logp, value, x, logits = act(self, *a, **k)
            return action, logp, value + 1e-3 * value.abs().max(), x, logits
        return altered

    return _patched(SMTPolicy, "act", make)


FAULTS = {"still_step": still_step, "half_batch": half_batch, "altered_spectrogram": altered_spectrogram,
          "altered_value": altered_value}
