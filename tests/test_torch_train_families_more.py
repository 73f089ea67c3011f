"""One training step of every assigned architecture, reduced, on the
port against the JAX package: the five held by loss and gradient norm
alone (the rest, with per-leaf gradients, in
``test_torch_train_families.py``; split so that each file stays under a
minute).

The train-step half of ``test_archs_smoke.py``'s
``test_arch_forward_and_train_step``: the port's ``loss`` under autograd
and the reference's ``jax.value_and_grad`` on the same weights
(``params_from_jax``, every ``x_gate`` at 0.5) and seeded batch: loss
and global gradient norm within rel 1e-4; the reference's SGD step
leaves a finite loss.
"""
import pytest

from _torch_train import check_grads

ARCHS = ['jamba-1.5-large-398b', 'stablelm-1.6b', 'mistral-large-123b', 'llama-3.2-vision-11b', 'qwen3-moe-30b-a3b']
PER_LEAF = []


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_match_reference(arch):
    check_grads(arch, per_leaf=arch in PER_LEAF)
