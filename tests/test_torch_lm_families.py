"""The MoE, SSM, hybrid, encoder-decoder and VLM families of the port
against the JAX package's ``LM``: the full forward and the loss.

Reduced configs at ``B, S = 2, 32`` in float32, as ``test_archs_smoke.py``
runs them, with the reference's own ``LM.init(0)`` weights carried by
``convert.params_from_jax`` and every ``x_gate`` at 0.5
(``tests/_torch_families.py``).  Logits, the MoE balance loss and the loss
must match the reference within 2e-4.  The flash route runs the kernel's
plain version here against the reference's Pallas kernel in interpret
mode, for deepseek (causal) and whisper's encoder (non-causal).  Every
registered config's reference tree loads into the port with
``strict=True``, reduced and, on the ``meta`` device, full.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import build_model as jbuild
from repro_torch.models import build_model, convert
from repro_torch.models.convert import params_from_jax

from _torch_families import (B, FAMILIES, S, TOL, _context, _np, batch, jb,
                             pair, tb)


# -------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match(arch):
    jm, jp, tm = pair(arch)
    b = batch(tm.cfg, 0)
    jl, jaux = jm.apply(jp, jb(b))
    tl, taux = tm(tb(b))
    assert tl.shape == (B, S, tm.cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if tm.cfg.moe is not None:
        assert float(taux) > 0
    (jloss, jmet), (tloss, tmet) = jm.loss(jp, jb(b)), tm.loss(tb(b))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), **TOL)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]), **TOL)
    ctx = _context(b)
    if ctx:
        # the cross route carries the context into the logits
        other = dict(b, **{k: v[::-1].copy() for k, v in ctx.items()})
        moved = np.abs(_np(tm(tb(other))[0]) - _np(tl)).max()
        assert moved > 1e-3, f"{arch}: the context moved no logit"


# ----------------------------------------------------------- flash route

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-small"])
def test_flash_route_matches_reference_flash_route(arch, monkeypatch):
    """The reference's ``use_flash=True`` route (its Pallas kernel in
    interpret mode) against the port's (the kernel's plain version): the
    decoder's causal self-attention, and whisper's encoder through the
    kernel non-causal over its 64 frames.  Cross attention never takes
    the kernel.  The plain route agrees with both (no window here)."""
    jm, jp, tm = pair(arch, use_flash=True)
    b = batch(tm.cfg, 5)
    jl, _ = jm.apply(jp, jb(b))
    with torch.no_grad():           # the kernel has no backward
        tl, _ = tm(tb(b))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _, _, plain = pair(arch)
    np.testing.assert_allclose(_np(plain(tb(b))[0]), _np(tl), **TOL)
    if arch == "whisper-small":
        from repro_torch.kernels.flash_attention import ops as fa
        calls = []
        real = fa.mha

        def counted(q, k, v, causal, **kw):
            calls.append(causal)
            return real(q, k, v, causal, **kw)
        monkeypatch.setattr(fa, "mha", counted)
        with torch.no_grad():
            tm(tb(b))
        cfg = tm.cfg
        assert calls == [False] * cfg.encoder_layers + [True] * cfg.num_layers


# ---------------------------------------------------------- weights

def _meta_tensor(a):
    """A ``meta`` tensor of ``a``'s shape and type (no copy)."""
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else \
        torch.from_numpy(np.empty(0, a.dtype)).dtype
    return torch.empty(a.shape, dtype=dt, device="meta")


@pytest.mark.parametrize("arch", JC.list_archs())
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_state_dict_loads_strict(arch, size, monkeypatch):
    """``params_from_jax`` covers every leaf of the reference's
    ``LM.init`` tree: the state dict loads with ``strict=True``.  A full
    config goes through its ``eval_shape`` tree as zero-stride arrays,
    onto a model on the ``meta`` device (no memory)."""
    if size == "reduced":
        jcfg, tcfg = JC.get_config(arch).reduced(), \
            TC.get_config(arch).reduced()
        tree = jax.tree.map(np.asarray, jbuild(jcfg).init(0))
        model = build_model(tcfg, "cpu")
    else:
        jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        shapes = jax.eval_shape(jbuild(jcfg).init, 0)
        tree = jax.tree.map(
            lambda s: np.lib.stride_tricks.as_strided(
                np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)), shapes)
        monkeypatch.setattr(convert, "to_tensor", _meta_tensor)
        model = build_model(tcfg, "meta")
    state = params_from_jax(tcfg, tree)
    assert model.load_state_dict(state, strict=True)
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in state.values()) == n
