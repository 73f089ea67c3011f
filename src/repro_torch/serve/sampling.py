"""Token sampling: greedy / temperature / top-k / top-p."""
from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, temperature: float,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """The tempered logits [B, V] with the tokens outside the top-k and the
    top-p nucleus set to ``-inf`` (the reference's masks: a token is cut
    when its logit is below the k-th largest, or below the logit at which
    the sorted cumulative probability first reaches ``top_p``)."""
    logits = logits / temperature
    if top_k:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: [B, V] -> tokens [B].  ``temperature <= 0`` is greedy (the
    first of equal maxima); otherwise one draw per row from the softmax of
    :func:`filter_logits`, from ``generator`` (its stream is not
    ``jax.random``'s)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits.float(), temperature, top_k,
                                        top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
