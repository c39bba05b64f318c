"""Mixture-of-Experts feed-forward with expert parallelism (ep).

Beyond the reference's capability surface (it has no MoE anywhere —
SURVEY.md §2.3 lists ep as out of scope for parity); this exists so the
framework's parallelism layer covers the ep axis the way production ViT
stacks (V-MoE, LIMoE) use it: the dense MLP of selected blocks is replaced
by ``num_experts`` expert MLPs, tokens are routed top-k, and the expert
dimension shards over the ``model`` mesh axis through the same GSPMD rule
machinery as tp (parallel/sharding.py — ``expert_w*`` rules put the
leading E axis on ``model``; XLA inserts the dispatch/combine collectives).

Dispatch is the GShard/Switch einsum formulation — static shapes, no
gathers, dense matrix products:

  - router logits -> softmax -> top-k experts per token (k static),
    gates renormalized over the chosen k;
  - position-in-expert by cumulative sum over the token axis; tokens past
    ``capacity = ceil(k*S/E * capacity_factor)`` are dropped (their block
    reduces to the residual passthrough);
  - expert inputs gathered as one ``(b,s,e,c) x (b,s,d) -> (e,b,c,d)``
    einsum, the two expert GEMMs run batched over the (sharded) E axis,
    and the combine einsum scatters outputs back weighted by the gates.

A Switch-style load-balance auxiliary loss is sown under
``intermediates/moe_aux_loss`` (pull with ``mutable=['intermediates']``
and add ``aux_weight * sum(...)`` to the training loss).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from vitax._vendor.flax import linen as nn
from vitax.nn.blocks import _activate, _layer_norm


class MoEFeedForward(nn.Module):
    """Pre-norm top-k routed expert MLP. Drop-in for ``FeedForward``
    (returns the delta; the caller adds the residual, so capacity-dropped
    tokens pass through unchanged)."""

    dim: int
    hidden_dim: int
    num_experts: int = 8
    num_selected: int = 2  # k
    capacity_factor: float = 1.25
    dropout: float = 0.0  # expert-hidden dropout (V-MoE applies it inside experts)
    activation: str = "gelu"
    ln_eps: float = 1e-6
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        b, s, d = x.shape
        e, k = self.num_experts, self.num_selected
        assert k <= e
        capacity = min(s, max(1, -(-k * s * self.capacity_factor // e).__int__()))

        w1 = self.param(
            "expert_w1", nn.initializers.lecun_normal(),
            (e, self.dim, self.hidden_dim), jnp.float32,
        )
        b1 = self.param(
            "expert_b1", nn.initializers.zeros, (e, self.hidden_dim), jnp.float32
        )
        w2 = self.param(
            "expert_w2", nn.initializers.lecun_normal(),
            (e, self.hidden_dim, self.dim), jnp.float32,
        )
        b2 = self.param(
            "expert_b2", nn.initializers.zeros, (e, self.dim), jnp.float32
        )
        ln_scale = self.param("ln_scale", nn.initializers.ones, (self.dim,), jnp.float32)
        ln_bias = self.param("ln_bias", nn.initializers.zeros, (self.dim,), jnp.float32)

        xn = _layer_norm(x, ln_scale, ln_bias, self.ln_eps)
        # routing in fp32 regardless of the compute dtype
        router = nn.Dense(e, dtype=jnp.float32, name="router")
        probs = jax.nn.softmax(router(xn.astype(jnp.float32)), axis=-1)  # (b,s,e)

        # top-k choice (k is static and tiny — unrolled)
        remaining = probs
        masks, gates = [], []
        for _ in range(k):
            idx = jnp.argmax(remaining, axis=-1)
            mask = jax.nn.one_hot(idx, e, dtype=jnp.float32)  # (b,s,e)
            gates.append(jnp.sum(remaining * mask, axis=-1))  # (b,s)
            masks.append(mask)
            remaining = remaining * (1.0 - mask)
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]

        # positions within each expert's capacity buffer, k-th choices after
        # (k-1)-th (GShard priority order); overflow drops.
        prior = jnp.zeros((b, 1, e), jnp.float32)
        combine = jnp.zeros((b, s, e, capacity), jnp.float32)
        dispatch = jnp.zeros_like(combine)
        for mask, gate in zip(masks, gates):
            pos = jnp.cumsum(mask, axis=1) - mask + prior  # (b,s,e)
            keep = mask * (pos < capacity)
            slot = jax.nn.one_hot(pos.astype(jnp.int32), capacity, dtype=jnp.float32)
            disp = keep[..., None] * slot  # (b,s,e,c)
            dispatch = dispatch + disp
            combine = combine + gate[..., None, None] * disp
            prior = prior + jnp.sum(mask, axis=1, keepdims=True)

        # Switch load-balance aux: E * sum_e f_e * p_e (f = routed fraction
        # by FIRST choice, p = mean router prob) — 1.0 at perfect balance.
        frac = jnp.mean(masks[0], axis=(0, 1))
        mean_prob = jnp.mean(probs, axis=(0, 1))
        self.sow("intermediates", "moe_aux_loss", e * jnp.sum(frac * mean_prob))

        dtype = self.dtype or x.dtype
        expert_in = jnp.einsum("bsec,bsd->ebcd", dispatch, xn.astype(jnp.float32))
        h = jnp.einsum(
            "ebcd,edf->ebcf", expert_in.astype(dtype), w1.astype(dtype),
            preferred_element_type=jnp.float32,
        ) + b1[:, None, None, :]
        h = _activate(h, self.activation)
        if self.dropout > 0.0:
            h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        out = jnp.einsum(
            "ebcf,efd->ebcd", h.astype(dtype), w2.astype(dtype),
            preferred_element_type=jnp.float32,
        ) + b2[:, None, None, :]
        y = jnp.einsum("ebcd,bsec->bsd", out, combine)
        return y.astype(x.dtype)
