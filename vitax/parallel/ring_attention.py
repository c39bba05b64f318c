"""Ring attention: sequence-parallel softmax attention over the device mesh.

The sequence-parallel form of online-softmax attention (SURVEY.md §2.3's
ring extension point): the sequence is sharded over a mesh axis, each device keeps its Q shard
resident and its K/V shard in motion — at step i every device contracts its
queries against the K/V block that started i hops away, then rotates the
block to its ring neighbor with ``lax.ppermute``. After P steps every query
has seen every key with only P-1 point-to-point transfers of one shard
each (the last block's rotation would be discarded, so it is skipped) — no
all-gather, no materialized global K/V, and the permutes go
neighbor-to-neighbor.

The running (m, l, acc) rescale is the flash-attention online-softmax
algebra; the local contraction is plain XLA einsums over an N/P-token
block.

Zoo sequences (<= 3.2k tokens) never need this — it exists so the framework
scales past one device's memory, and it is exercised on the virtual CPU mesh in
tests (sharded-vs-single parity, collective placement).
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def _local_pass(q, k_blk, v_blk, scale, col0=None, true_n=None):
    """One ring step's local contribution: unnormalized PV plus the
    per-row (max, sumexp) statistics needed for the global rescale.

    ``col0``/``true_n``: when the global sequence is padded (a padded-
    stream caller like ``ring_vit_apply``), global key columns
    ``col0 + j >= true_n`` are masked to -1e30 BEFORE the max — finite, so
    a fully-masked block (the pad tail can span whole shards) contributes
    exp(-1e30 - m) = 0 instead of inf-inf NaNs in the rescale.

    Returns fp32 (m, l, pv): m = rowmax(s), l = rowsum(exp(s - m)),
    pv = exp(s - m) @ v."""
    s = jnp.einsum(
        "bhid,bhjd->bhij", q, k_blk, preferred_element_type=jnp.float32
    ) * scale
    if true_n is not None:
        col_ids = jax.lax.broadcasted_iota(jnp.int32, s.shape, 3) + col0
        s = jnp.where(col_ids < true_n, s, -1e30)
    m = jnp.max(s, axis=-1)  # (b, h, nq)
    p = jnp.exp(s - m[..., None])
    l = jnp.sum(p, axis=-1)
    pv = jnp.einsum(
        "bhij,bhjd->bhid", p.astype(v_blk.dtype), v_blk,
        preferred_element_type=jnp.float32,
    )
    return m, l, pv.astype(jnp.float32)


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    scale: Optional[float] = None,
    true_n: Optional[int] = None,
) -> jax.Array:
    """Sequence-parallel attention: ``[B, H, N, D]`` in/out, with the N axis
    sharded over ``axis_name`` of ``mesh``.

    ``N`` must divide by the axis size. Inputs may be unsharded host
    arrays (the returned jitted computation shards them) or already placed
    with ``P(None, None, axis_name)`` on the sequence dim. ``true_n``
    masks padded global key columns (cols >= true_n) out of every ring
    step's softmax — the padded-stream contract the other attention
    backends share.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p_devices = mesh.shape[axis_name]
    n = q.shape[2]
    assert n % p_devices == 0, f"sequence {n} must divide ring size {p_devices}"
    if true_n is not None and true_n == n:
        true_n = None
    return _ring_fn(mesh, axis_name, float(scale), true_n)(q, k, v)


@functools.lru_cache(maxsize=None)
def _ring_fn(mesh: Mesh, axis_name: str, scale: float, true_n):
    """Build-and-jit once per (mesh, axis, scale, true_n): a fresh jit
    closure per call would defeat the executable cache and recompile the
    whole sharded program every invocation (shapes key the jit cache as
    usual — the local shard width comes from the traced shapes)."""
    p_devices = mesh.shape[axis_name]

    def per_device(q_loc, k_loc, v_loc):
        n_loc = q_loc.shape[2]
        # ring neighbor rotation: shard j -> device j+1 (mod P); after step
        # i this device holds the K/V shard that started i hops behind it,
        # i.e. the block whose global columns begin at
        # ((sid - i) mod P) * n_loc — the offset the pad mask needs.
        perm = [(j, (j + 1) % p_devices) for j in range(p_devices)]
        sid = jax.lax.axis_index(axis_name)

        def col0_at(i):
            if true_n is None:
                return None
            return jnp.mod(sid - i, p_devices) * n_loc

        def body(carry, i):
            m, l, acc, k_blk, v_blk = carry
            m_i, l_i, pv_i = _local_pass(
                q_loc, k_blk, v_blk, scale, col0_at(i), true_n
            )
            m_new = jnp.maximum(m, m_i)
            a_old = jnp.exp(m - m_new)
            a_new = jnp.exp(m_i - m_new)
            l = l * a_old + l_i * a_new
            acc = acc * a_old[..., None] + pv_i * a_new[..., None]
            k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
            v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
            return (m_new, l, acc, k_blk, v_blk), None

        b, h, nq_loc, _ = q_loc.shape
        dv = v_loc.shape[-1]
        carry = (
            # -1e30 (finite), not -inf: a fully-masked pad block otherwise
            # produces inf-inf NaNs in the rescale
            jnp.full((b, h, nq_loc), -1e30, jnp.float32),
            jnp.zeros((b, h, nq_loc), jnp.float32),
            jnp.zeros((b, h, nq_loc, dv), jnp.float32),
            k_loc,
            v_loc,
        )
        # lax.scan (not fori_loop) so the ring is reverse-differentiable —
        # the backward replays the rotation in reverse via the transposed
        # permutation XLA derives from ppermute. The last shard is
        # contracted outside the scan: its rotation result would be
        # discarded, so 2*(P-1) permutes suffice, not 2*P.
        (m, l, acc, k_blk, v_blk), _ = jax.lax.scan(
            body, carry, jnp.arange(p_devices - 1)
        )
        m_i, l_i, pv_i = _local_pass(
            q_loc, k_blk, v_blk, scale, col0_at(p_devices - 1), true_n
        )
        m_new = jnp.maximum(m, m_i)
        a_old = jnp.exp(m - m_new)
        a_new = jnp.exp(m_i - m_new)
        l = l * a_old + l_i * a_new
        acc = acc * a_old[..., None] + pv_i * a_new[..., None]
        return (acc / l[..., None]).astype(v_loc.dtype)

    seq_spec = P(None, None, axis_name, None)
    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(seq_spec, seq_spec, seq_spec),
        out_specs=seq_spec,
        check_vma=False,
    )
    return jax.jit(sharded)


def ring_vit_apply(
    model,
    variables,
    img: jax.Array,
    mesh: Mesh,
    *,
    axis_name: str = "data",
) -> jax.Array:
    """Sequence-parallel ViT forward: the TOKEN axis sharded over
    ``axis_name`` through the whole encoder.

    Everything row-wise — LayerNorm, the qkv/out projections, the MLP —
    is token-local (zero communication: weights replicate, the token dim
    shards); only attention crosses shards, via the ring above (P-1
    neighbor ppermutes per layer, never an all-gather of K/V). The stream
    pads once to a multiple of the ring size with padded key columns
    masked in-ring (``true_n``). Zoo sequences fit one chip; this
    is the composition surface for sequences past single-chip HBM —
    activations per device scale as N/P.

    Plain raw-param ViT only (the flagship substrate, like
    ``pipeline_vit_apply``); logits match the single-device
    ``model.apply`` (tests/test_parallel.py).
    """
    from jax.sharding import NamedSharding

    from vitax.parallel.pipeline import (
        _vit_embed_and_pad,
        _vit_head,
        raw_block_apply,
    )

    if model.qkv_bias:
        raise ValueError(
            "ring_vit_apply shards the raw-param attention layout; "
            "qkv_bias (flax-submodule) ViTs aren't supported here"
        )

    params = variables["params"]
    p_ring = mesh.shape[axis_name]
    x, n, true_n = _vit_embed_and_pad(model, params, img, pad_multiple=p_ring)
    b, n_pad = x.shape[0], x.shape[1]
    # pin the token axis sharded: every row-wise op below stays local
    x = jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P(None, axis_name, None))
    )

    blocks = params["encoder"]["blocks"]
    attn, ff = blocks["attn"], blocks["ff"]
    dtype = model.dtype or x.dtype
    heads, dh, dim = model.heads, model.dim_head, model.dim
    eps = model.norm_eps
    scale = dh**-0.5

    stacked = {
        "ln1_s": attn["norm_scale"], "ln1_b": attn["norm_bias"],
        "wqkv": attn["qkv_kernel"], "wout": attn["out_kernel"],
        "bout": attn["out_bias"],
        "ln2_s": ff["ln_scale"], "ln2_b": ff["ln_bias"],
        "w1": ff["w1"], "b1": ff["b1"], "w2": ff["w2"], "b2": ff["b2"],
    }

    def ring_attn(xn, p):
        # qkv -> the K/V ring -> out GEMM (fp32, pre-bias); the shared
        # raw_block_apply epilogue supplies the residual/LN/MLP with the
        # same rounding points as the single-device encoder block
        qkv = jnp.einsum(
            "bnd,df->bnf", xn, p["wqkv"].astype(dtype),
            preferred_element_type=jnp.float32,
        ).astype(dtype)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        split = lambda t: t.reshape(b, n_pad, heads, dh).transpose(0, 2, 1, 3)
        o = ring_attention(
            split(q), split(k), split(v), mesh,
            axis_name=axis_name, scale=scale, true_n=true_n,
        )
        o = o.transpose(0, 2, 1, 3).reshape(b, n_pad, heads * dh)
        return jnp.einsum(
            "bnf,fd->bnd", o.astype(dtype), p["wout"].astype(dtype),
            preferred_element_type=jnp.float32,
        )

    def layer(xv, p):
        out = raw_block_apply(
            p, xv, attn_fn=ring_attn, reduce_fn=lambda t: t,
            dtype=dtype, eps=eps, activation=model.activation,
        )
        return out, None

    x, _ = jax.lax.scan(layer, x, stacked)
    return _vit_head(model, params, x, n)
