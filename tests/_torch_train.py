"""Shared pieces of the train-step family suites: one training step's
loss, gradient norm and per-leaf gradients of a reduced config on both
packages, the port's model carrying the reference's weights (every
``x_gate`` at 0.5, ``tests/_torch_families.py``)."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from _torch_families import batch, jb, models, tb
from repro_torch.models.convert import params_from_jax

#: loss and global gradient norm within this relative error of the
#: reference's ``jax.value_and_grad``; each leaf's gradient within this
#: much of the leaf's largest |g|
REL = 1e-4


def check_grads(arch, per_leaf):
    """The train-step half of ``test_archs_smoke.py``'s
    ``test_arch_forward_and_train_step`` on both packages."""
    jm, jp, tm = models(arch)
    b = batch(tm.cfg, 0)
    grad_fn = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb(b)),
                                         has_aux=True))
    (jloss, _), jg = grad_fn(jp)
    params = dict(tm.named_parameters())
    with torch.enable_grad():
        loss, _ = tm.loss(tb(b))
        grads = torch.autograd.grad(loss, list(params.values()))
    tg = dict(zip(params, grads))
    assert float(loss) == pytest.approx(float(jloss), rel=REL)
    jnorm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                              for g in jax.tree.leaves(jg))))
    tnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    assert np.isfinite(tnorm) and tnorm > 0
    assert tnorm == pytest.approx(jnorm, rel=REL)
    # the reference's SGD step: the loss after it is finite on both
    with torch.no_grad():
        stepped = {n: p - 1e-3 * tg[n] for n, p in params.items()}
        loss2, _ = torch.func.functional_call(tm, stepped, (tb(b),))
    assert bool(torch.isfinite(loss2.float()).all())
    if per_leaf:
        want = params_from_jax(tm.cfg, jax.tree.map(np.asarray, jg))
        assert set(want) == set(tg)
        for n, g in want.items():
            g = g.float().numpy()
            bound = REL * max(np.abs(g).max(), 1e-30)
            np.testing.assert_allclose(tg[n].float().numpy(), g, rtol=0,
                                       atol=bound, err_msg=n)
