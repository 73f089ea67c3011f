"""One training step of every assigned architecture, reduced, on the
port against the JAX package: the four held leaf by leaf, and gemma3
(the rest in ``test_torch_train_families_more.py``; split so that each
file stays under a minute).

The train-step half of ``test_archs_smoke.py``'s
``test_arch_forward_and_train_step``: the port's ``loss`` under autograd
and the reference's ``jax.value_and_grad`` on the same weights
(``params_from_jax``, every ``x_gate`` at 0.5) and seeded batch: loss
and global gradient norm within rel 1e-4, and each leaf's gradient
within 1e-4 of its largest |g| for smollm-360m, deepseek-moe-16b,
mamba2-2.7b and whisper-small; the reference's SGD step leaves a finite
loss.
"""
import pytest

from _torch_train import check_grads

ARCHS = ['smollm-360m', 'deepseek-moe-16b', 'mamba2-2.7b', 'whisper-small', 'gemma3-4b']
PER_LEAF = ['smollm-360m', 'deepseek-moe-16b', 'mamba2-2.7b', 'whisper-small']


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_match_reference(arch):
    check_grads(arch, per_leaf=arch in PER_LEAF)
