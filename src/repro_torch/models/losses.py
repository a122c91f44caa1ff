"""Memory-bounded LM losses, in PyTorch.

Port of the JAX reference's ``repro/models/losses.py``.  Materializing
(B, S, V) fp32 logits for the loss is the biggest activation-memory hog
of a training step; ``chunked_ce`` never builds them.  The reference's
``lax.scan`` over sequence chunks is a Python loop here: each chunk's
logits come from the final hidden states in fp32 and reduce to the
chunk's CE contribution at once, so the transient is (B, chunk, V) fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm

CHUNK = 512


def chunked_ce(x: torch.Tensor, table: torch.Tensor, norm_w, tokens,
               norm_eps: float, skip_prefix: int = 0,
               chunk: int = CHUNK, par=None) -> torch.Tensor:
    """Next-token cross entropy without materializing full logits.

    x: (B, S_total, D) final backbone states (pre final-norm).
    table: (V, D) unembedding. tokens: (B, S) targets; S_total may exceed
    S by ``skip_prefix`` prepended non-text positions (VLM patches).
    The sequence is padded to a whole number of chunks and the padded
    positions masked out, as in the reference.  ``par``: the
    tensor-parallel context where ``table`` is this rank's V shard
    (vocab-parallel: the maximum, the sum of exponentials and the gold
    logit each all-reduced over ``model``).
    """
    B, S = tokens.shape
    # positions predicting tokens[:, 1:]: x[skip_prefix : skip_prefix+S-1]
    xs = x[:, skip_prefix:skip_prefix + S - 1, :]
    tgt = tokens[:, 1:].long()
    n = xs.shape[1]
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad))
    valid = torch.arange(n + pad, device=x.device) < n
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, n + pad, c):
        h = rms_norm(xs[:, i:i + c], norm_w, norm_eps)
        t = tgt[:, i:i + c]
        if par is None:
            logits = torch.einsum("bcd,vd->bcv", h, table).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, t[..., None])[..., 0]
        else:
            logz, gold = _vocab_parallel(h, table, t, par)
        nll = torch.where(valid[None, i:i + c], logz - gold, 0.0)
        total = total + torch.sum(nll)
    return total / (B * (S - 1))


def _vocab_parallel(h, table, t, par):
    """(log Z, gold logit) of one chunk against this rank's V shard of
    the table, each whole after an all-reduce over ``model``."""
    logits = torch.einsum("bcd,vd->bcv", par.copy_to_model(h), table).float()
    mx = par.max_over_model(logits.amax(dim=-1))
    sumexp = par.reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(dim=-1))
    lo = par.model.rank * table.shape[0]
    idx = t - lo
    inside = (idx >= 0) & (idx < table.shape[0])
    gold = torch.gather(logits, -1, torch.where(inside, idx, 0)[..., None])
    gold = par.reduce_from_model(torch.where(inside, gold[..., 0], 0.0))
    return torch.log(sumexp) + mx, gold
