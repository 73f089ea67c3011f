"""Model assembly: decoder-only, encoder-decoder and VLM language models.

The JAX package's ``models/model.py`` on PyTorch.  ``LM`` is an
``nn.Module``: the ``prefix`` layers, then the ``n_units`` repeating units
unrolled into one ``ModuleList`` (no scan: PyTorch runs eagerly), and for
encoder-decoder configs the encoder's layers (``enc_layers``, non-causal)
and ``enc_norm``.  The cross-attention context is the encoder's output
over ``batch["frames"]`` or the pre-projected ``batch["vision"]``
embeddings.  Parameters keep the JAX package's names and layouts, so
``models/convert.py`` carries a JAX parameter tree across as it is.

The model lives on ``cuda:0`` unless the caller passes another device
(``"cpu"`` for the plain versions, ``"meta"`` to count parameters without
memory); with no card, the default raises.  The full forward is
:meth:`LM.forward`, the counterpart of the reference's ``LM.apply``
(``nn.Module.apply`` is PyTorch's own method).  With ``cfg.use_flash`` it
takes the flash attention kernel, which has no backward: under autograd
that route raises, as the reference's does.

``forward`` and ``loss`` run with autograd (the parameters are
trainable); ``init``, ``prefill`` and ``decode_step`` run under
``torch.no_grad()``.  With gradients on and no cache, ``cfg.remat``
wraps each repeating unit as the reference's ``jax.checkpoint`` does:
``"full"`` recomputes the whole unit in the backward
(``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of the
unbatched matrix products (``aten.mm``, the counterpart of
``dots_with_no_batch_dims_saveable``) and recomputes the rest.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import FULL_WINDOW, LayerSpec, ModelConfig

from repro_torch.distributed.sharding import (_context_mesh, constrain,
                                              is_distributed, spmd)

from .blocks import Block, layer_apply, layer_cache_init
from .layers import Norm, embed_init, param, softmax_cross_entropy

Cache = Dict

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (``cuda:0``, or a rank's own
    after ``launch.mesh.init_world``), raising when there is no card;
    anything else as given (a CUDA device still needs a card)."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model runs on a CUDA device by default and "
                           "none is available (pass device='cpu' for the "
                           "plain versions)")
    return dev


def _distributed() -> bool:
    mesh = _context_mesh()
    return mesh is not None and is_distributed(mesh)


def _spmd(fn):
    """Run ``fn`` under :func:`~repro_torch.distributed.sharding.spmd`: on
    a distributed mesh the plain tensors it makes (positions, masks,
    rotary angles) are the same on every rank and mix with DTensors as
    replicated ones."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with spmd():
            return fn(*args, **kwargs)
    return run


class LM(nn.Module):
    """Config -> parameters, full forward, loss, caches, prefill and
    decode."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dt = DTYPES[cfg.param_dtype]
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, dev)
        self.final_norm = Norm(cfg.norm, cfg.d_model, dt, dev)
        # the output head is always its own parameter; "tied" configs
        # initialise it from the embedding (the reference's choice)
        self.lm_head = param((cfg.d_model, cfg.vocab_size), dt, dev)
        self.prefix = nn.ModuleList(
            Block(cfg, spec, cfg.prefix_d_ff, dt, dev) for spec in cfg.prefix)
        self.layers = nn.ModuleList(
            Block(cfg, spec, 0, dt, dev)
            for _ in range(cfg.n_units) for spec in cfg.unit)
        #: per block (prefix, then unit layers) attention window, 0 = full
        self.windows = [FULL_WINDOW] * len(cfg.prefix) + list(cfg.windows())
        if cfg.encoder_layers:
            self.enc_layers = nn.ModuleList(
                Block(cfg, LayerSpec(kind="attn"), 0, dt, dev)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = Norm(cfg.norm, cfg.d_model, dt, dev)

    @property
    def device(self) -> torch.device:
        """The device of the model's parameters (this rank's, where they
        are DTensors)."""
        w = self.embed
        return w.to_local().device if hasattr(w, "to_local") else w.device

    def blocks(self) -> List[Block]:
        return list(self.prefix) + list(self.layers)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, seed: int = 0) -> "LM":
        """Fill every parameter from a ``torch.Generator`` on the model's
        device seeded with ``seed`` (the reference's distributions, not its
        numbers).  Returns the model."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embed.copy_(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                    self.embed.dtype, dev))
        self.final_norm.init_()
        head = self.embed if cfg.tie_embeddings else embed_init(
            gen, cfg.vocab_size, cfg.d_model, self.lm_head.dtype, dev)
        self.lm_head.copy_(head.t())
        for block in self.blocks():
            block.init_(gen)
        if cfg.encoder_layers:
            for block in self.enc_layers:
                block.init_(gen)
            self.enc_norm.init_()
        return self

    # -------------------------------------------------------------- decoder
    def _tokens(self, tokens) -> torch.Tensor:
        """An index array (numpy or torch) on the model's device; on a
        distributed mesh a DTensor, batch over the data axes (a plain
        array is the global one, the same on every rank)."""
        if hasattr(tokens, "device_mesh"):
            return constrain(tokens, "dp", *([None] * (tokens.dim() - 1)))
        t = torch.as_tensor(tokens, device=self.device)
        return constrain(t, "dp", *([None] * (t.dim() - 1))) \
            if _distributed() else t

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens, self.embed).to(DTYPES[cfg.compute_dtype])
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return constrain(x, "dp", None, None)

    def _decoder(self, x: torch.Tensor, positions: torch.Tensor,
                 cross_ctx: Optional[torch.Tensor],
                 caches: Optional[List[Dict]]
                 ) -> Tuple[torch.Tensor, Optional[List[Dict]],
                            torch.Tensor]:
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if caches is None and cfg.remat != "none" and \
                torch.is_grad_enabled():
            return self._decoder_remat(x, positions, cross_ctx, aux)
        new_caches = [] if caches is not None else None
        for i, (block, window) in enumerate(zip(self.blocks(),
                                                self.windows)):
            cache = None if caches is None else caches[i]
            x, c, a = layer_apply(cfg, block, x, positions=positions,
                                  window=window, cross_ctx=cross_ctx,
                                  cache=cache)
            aux = aux + a
            if caches is not None:
                new_caches.append(c)
        return x, new_caches, aux

    def _decoder_remat(self, x: torch.Tensor, positions: torch.Tensor,
                       cross_ctx: Optional[torch.Tensor], aux: torch.Tensor
                       ) -> Tuple[torch.Tensor, None, torch.Tensor]:
        """The training decoder with each repeating unit checkpointed (the
        prefix layers are not, as in the reference)."""
        cfg = self.cfg
        n_pre, size = len(cfg.prefix), cfg.unit_size
        blocks, windows = self.blocks(), self.windows
        for i in range(n_pre):
            x, _, a = layer_apply(cfg, blocks[i], x, positions=positions,
                                  window=windows[i], cross_ctx=cross_ctx)
            aux = aux + a

        # the backward recomputes a unit on autograd's thread (a card's
        # device thread): it re-enters the mesh the forward ran under
        mesh = _context_mesh()

        def unit(lo, x, aux, positions, cross_ctx):
            with contextlib.nullcontext() if mesh is None else mesh, spmd():
                for i in range(lo, lo + size):
                    x, _, a = layer_apply(cfg, blocks[i], x,
                                          positions=positions,
                                          window=windows[i],
                                          cross_ctx=cross_ctx)
                    aux = aux + a
            return x, aux

        extra = {} if cfg.remat == "full" else {
            "context_fn": functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)}
        for lo in range(n_pre, len(blocks), size):
            x, aux = ckpt.checkpoint(unit, lo, x, aux, positions, cross_ctx,
                                     use_reentrant=False, **extra)
        return x, None, aux

    def _encoder(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder: non-causal attention layers over the frames at
        positions 0..T-1, then ``enc_norm``."""
        b, t, _ = frames.shape
        x = frames
        for block in self.enc_layers:
            x, _, _ = layer_apply(self.cfg, block, x,
                                  positions=self._positions(b, t),
                                  window=FULL_WINDOW, causal=False)
        return self.enc_norm(x)

    def _cross_context(self, batch: Dict) -> Optional[torch.Tensor]:
        """``batch["frames"]`` through the encoder, or ``batch["vision"]``,
        in the compute type; None for a decoder-only config.  On a
        distributed mesh either is a batch input, ``("dp", None, None)``
        (a plain array is the global one, the same on every rank)."""
        cfg = self.cfg
        if cfg.encoder_layers:
            return self._encoder(self._context(batch["frames"]))
        if cfg.num_vision_tokens:
            return self._context(batch["vision"])
        return None

    def _context(self, x) -> torch.Tensor:
        dt = DTYPES[self.cfg.compute_dtype]
        if not hasattr(x, "device_mesh"):
            x = torch.as_tensor(x, device=self.device)
            if not _distributed():
                return x.to(dt)
        return constrain(x, "dp", None, None).to(dt)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return constrain(x @ self.lm_head.to(x.dtype), "dp", None, "model")

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return self._tokens(torch.arange(s, dtype=torch.int32,
                                         device=self.device).expand(b, s))

    # --------------------------------------------------------------- forward
    @_spmd
    def forward(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward (the reference's ``LM.apply``): ``batch["tokens"]``
        [B, S] (optional ``positions``; ``frames`` or ``vision`` for the
        cross-attention families) -> (logits [B, S, V], aux float32)."""
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        positions = batch.get("positions")
        positions = self._positions(b, s) if positions is None \
            else self._tokens(positions)
        x, _, aux = self._decoder(self._embed(tokens), positions,
                                  self._cross_context(batch), None)
        x = self.final_norm(x)
        return self._head(x), aux

    @_spmd
    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        logits, aux = self.forward(batch)
        labels = self._tokens(batch["labels"])
        mask = batch.get("mask")
        ce, ntok = softmax_cross_entropy(
            logits, labels, None if mask is None else self._tokens(mask))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux, "tokens": ntok}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_len: int, ctx_len: int = 0,
                   dtype=torch.bfloat16, vector_index: bool = False) -> Cache:
        """``{"index", "layers": [...]}``, a layer's cache holding ``kv``
        (``{"k", "v", "index"}``) or ``ssm`` (``{"conv", "state"}``) and,
        on a cross layer, ``cross`` (``{"k", "v"}``, ``ctx_len`` long).
        ``vector_index=True`` gives per-slot positions (an int32 [B] on the
        device; continuous batching); the default scalar index (a 0-dim
        CPU tensor) keeps all slots aligned.  On a distributed mesh the
        layers' caches are DTensors placed by ``shard_cache``.  The
        default type is bfloat16 whatever the model's, as in the
        reference (the SSM state is float32)."""
        cfg = self.cfg
        specs = list(cfg.prefix) + list(cfg.unit) * cfg.n_units
        cache = {
            "index": (torch.zeros((batch_size,), dtype=torch.int32,
                                  device=self.device)
                      if vector_index else torch.zeros((), dtype=torch.int32)),
            "layers": [layer_cache_init(cfg, spec, batch_size, max_len, dtype,
                                        vector_index, self.device, ctx_len)
                       for spec in specs],
        }
        if _distributed():
            from repro_torch.distributed.sharding import place, shard_cache
            layers = {"layers": cache["layers"]}
            cache["layers"] = place(layers, shard_cache(
                layers, _context_mesh(), batch_size, cfg))["layers"]
        return cache

    @torch.no_grad()
    @_spmd
    def prefill(self, batch: Dict, cache: Cache
                ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt [B, S] (and the cross context of ``batch``)
        through the model at positions 0..S-1, writing its keys and values
        into ``cache`` (in place) at the cache's index, the SSM state and
        conv tail in place, and the context's keys and values.  Returns
        (logits of the last position [B, 1, V], cache)."""
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        x, layers, _ = self._decoder(self._embed(tokens),
                                     self._positions(b, s),
                                     self._cross_context(batch),
                                     cache["layers"])
        x = self.final_norm(x)
        return self._head(x[:, -1:]), {"index": cache["index"] + s,
                                       "layers": layers}

    @torch.no_grad()
    @_spmd
    def decode_step(self, tokens, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """One decode step: tokens [B, 1] at the cache's index (per slot
        for a vector index).  Returns (logits [B, 1, V], cache)."""
        tokens = self._tokens(tokens)
        b = tokens.shape[0]
        idx = cache["index"]
        positions = idx.to(torch.int32)[:, None] if idx.dim() == 1 else \
            torch.full((b, 1), int(idx), dtype=torch.int32,
                       device=self.device)
        x, layers, _ = self._decoder(self._embed(tokens), positions, None,
                                     cache["layers"])
        x = self.final_norm(x)
        return self._head(x), {"index": idx + 1, "layers": layers}


def shard_model(model: "LM", mesh) -> "LM":
    """Turn ``model``'s parameters into DTensors placed by
    ``shard_params`` on the distributed ``mesh`` (each rank keeps its
    part; every rank must hold the same values, as ``init(seed)`` or
    ``load_state_dict`` of one state dict gives them).  On a virtual mesh
    the model stays as it is.  Returns the model."""
    from repro_torch.distributed.sharding import place, shard_params
    named = dict(model.named_parameters())
    placed = place(named, shard_params(named, mesh, model.cfg))
    for name, t in placed.items():
        if t is named[name]:
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(t, requires_grad=
                                        named[name].requires_grad))
    return model


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the unbatched matrix products' outputs
    (a projection ``x @ w`` folds to ``aten.mm``), recompute the rest (the
    attention's batched products included, as the reference's policy
    does)."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def build_model(cfg: ModelConfig, device=None) -> LM:
    """The model with uninitialised parameters; ``.init(seed)`` fills
    them, or ``load_state_dict`` (``convert.params_from_jax``)."""
    return LM(cfg, device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
