"""Pipeline parallelism (pp) over the scanned encoder stack.

The reference has no parallelism code of any kind (SURVEY.md §2.3); dp/tp/sp
live in ``mesh.py``/``sharding.py``/``ring_attention.py``. This module adds
the fourth axis: a GPipe-style SPMD pipeline that shards the *depth* of a
scanned block stack over a ``pipe`` mesh axis. Every model in the zoo fits
on one chip, so pp is not required for capacity here — it exists for the
regime the framework is designed toward (deeper-than-HBM encoders, e.g.
ViT-g/H-scale stacks), and because the scanned parameter layout
(``nn.scan`` stacks each block's params on a leading depth axis,
nn/blocks.py:329-335) makes depth sharding a pure reshape: stage ``s`` of
``P`` owns layers ``[s·L/P, (s+1)·L/P)`` with no per-layer re-keying.

Schedule (classic GPipe, all stages run the same SPMD program):

  - The batch is split into ``n_micro`` microbatches.
  - At tick ``t`` (of ``n_micro + P - 1``), stage ``s`` runs microbatch
    ``t - s`` when ``0 <= t - s < n_micro``; otherwise it computes on a
    dummy and discards the result (the fill/drain bubble — fraction
    ``(P-1)/(n_micro+P-1)``, so raise ``n_micro`` to amortize it).
  - Activations move stage→stage+1 with one ``lax.ppermute`` per tick
    (point-to-point; the only collective in the steady state).
  - The last stage accumulates finished microbatches; one masked ``psum``
    at the end replicates the result across the pipe axis.

Everything in the schedule is reverse-differentiable (``scan`` over ticks,
``ppermute``, masked ``where``), so ``jax.grad`` through a pipelined
forward yields exactly the unpipelined gradients — asserted in
tests/test_pipeline.py. Composes with data parallelism: on a
``(data, pipe)`` mesh each data shard runs its own pipeline on its batch
slice and only gradient reduction crosses the data axis (in the caller's
optimizer step, as usual).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vitax.parallel.mesh import DATA_AXIS, MODEL_AXIS

PIPE_AXIS = "pipe"


def make_pipeline_mesh(
    n_pipe: int,
    n_data: int = 1,
    *,
    devices=None,
) -> Mesh:
    """A ``(data, pipe)`` mesh. Pipeline neighbours are adjacent on the
    device list."""
    devices = list(devices if devices is not None else jax.devices())
    need = n_pipe * n_data
    if need > len(devices):
        raise ValueError(
            f"pipeline mesh needs {n_data}x{n_pipe} = {need} devices, "
            f"found {len(devices)} ({devices[0].platform})"
        )
    grid = np.asarray(devices[:need]).reshape(n_data, n_pipe)
    return Mesh(grid, (DATA_AXIS, PIPE_AXIS))


def make_pipeline3d_mesh(
    n_pipe: int,
    n_data: int = 1,
    n_model: int = 1,
    *,
    devices=None,
) -> Mesh:
    """A ``(data, pipe, model)`` mesh for 3D parallelism. The model axis is
    innermost (tensor-parallel psums every layer), pipe next (one ppermute per tick), data outermost (gradient reduction
    only)."""
    devices = list(devices if devices is not None else jax.devices())
    need = n_pipe * n_data * n_model
    if need > len(devices):
        raise ValueError(
            f"3d mesh needs {n_data}x{n_pipe}x{n_model} = {need} devices, "
            f"found {len(devices)}"
        )
    grid = np.asarray(devices[:need]).reshape(n_data, n_pipe, n_model)
    return Mesh(grid, (DATA_AXIS, PIPE_AXIS, MODEL_AXIS))


def spmd_pipeline(
    block_fn: Callable[[Any, jax.Array], jax.Array],
    stacked_params: Any,
    x: jax.Array,
    mesh: Mesh,
    *,
    n_micro: Optional[int] = None,
    axis_name: str = PIPE_AXIS,
    param_specs: Any = None,
) -> jax.Array:
    """Apply ``depth`` blocks to ``x`` with the depth axis pipelined.

    ``stacked_params``: pytree whose every leaf has a leading ``depth``
    axis (the ``nn.scan`` layout). ``block_fn(params_i, x) -> x`` applies
    one block. ``x``: ``(batch, ...)`` activations; the batch splits into
    ``n_micro`` microbatches (default: one per stage — the minimum that
    keeps every stage busy in the steady state). ``depth`` must divide by
    the pipe-axis size and ``batch`` by ``n_micro`` (× the data-axis size
    when the mesh has one).

    ``param_specs`` (optional, for tensor parallelism inside a stage): a
    pytree matching ``stacked_params`` whose leaves are tuples of mesh
    axis names (or None) for the dims AFTER the leading depth axis — e.g.
    a column-parallel kernel ``(depth, D, heads, dh)`` takes
    ``(None, MODEL_AXIS, None)``. ``block_fn`` then receives tp-local
    leaves and owns the in-stage collectives (``lax.psum`` over
    ``MODEL_AXIS`` after its row-parallel GEMMs).
    """
    n_stages = mesh.shape[axis_name]
    depth = jax.tree_util.tree_leaves(stacked_params)[0].shape[0]
    if depth % n_stages != 0:
        raise ValueError(f"depth {depth} not divisible by {n_stages} pipeline stages")
    if n_micro is None:
        n_micro = n_stages
    data_ax = (
        DATA_AXIS
        if DATA_AXIS in mesh.axis_names and mesh.shape[DATA_AXIS] > 1
        else None
    )
    n_data = mesh.shape[data_ax] if data_ax else 1
    b = x.shape[0]
    if b % (n_micro * n_data) != 0:
        raise ValueError(
            f"batch {b} must divide by n_micro*data = {n_micro}*{n_data}"
        )
    local_depth = depth // n_stages
    staged = jax.tree.map(
        lambda a: a.reshape((n_stages, local_depth) + a.shape[1:]), stacked_params
    )
    mb = x.reshape((n_micro, b // n_micro) + x.shape[1:])

    def run(staged_local, mb_loc):
        params_local = jax.tree.map(lambda a: jnp.squeeze(a, 0), staged_local)
        sid = jax.lax.axis_index(axis_name)

        def stage(xv):
            y, _ = jax.lax.scan(
                lambda c, p: (block_fn(p, c), None), xv, params_local
            )
            return y

        ticks = n_micro + n_stages - 1
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def tick(carry, t):
            state, outs = carry
            # stage 0 ingests microbatch t; everyone else their ppermuted input
            inp = jax.lax.dynamic_index_in_dim(
                mb_loc, jnp.clip(t, 0, n_micro - 1), 0, keepdims=False
            )
            cur = jnp.where(sid == 0, inp, state)
            y = stage(cur)
            mb_id = t - sid
            active = jnp.logical_and(mb_id >= 0, mb_id < n_micro)
            y = jnp.where(active, y, cur)  # bubble ticks pass through
            # last stage records its finished microbatch
            slot = jnp.clip(mb_id, 0, n_micro - 1)
            record = jnp.logical_and(active, sid == n_stages - 1)
            outs = jnp.where(
                record,
                jax.lax.dynamic_update_index_in_dim(outs, y, slot, 0),
                outs,
            )
            state = jax.lax.ppermute(y, axis_name, perm)
            return (state, outs), None

        (_, outs), _ = jax.lax.scan(
            tick, (jnp.zeros_like(mb_loc[0]), jnp.zeros_like(mb_loc)),
            jnp.arange(ticks),
        )
        # replicate the last stage's results across the pipe axis
        return jax.lax.psum(
            jnp.where(sid == n_stages - 1, outs, jnp.zeros_like(outs)), axis_name
        )

    if param_specs is None:
        in_param_specs = P(axis_name)
    else:
        in_param_specs = jax.tree.map(
            lambda spec: P(axis_name, None, *spec),
            param_specs,
            is_leaf=lambda v: isinstance(v, tuple),
        )
    out = shard_map(
        run,
        mesh=mesh,
        in_specs=(in_param_specs, P(None, data_ax)),
        out_specs=P(None, data_ax),
        check_vma=False,
    )(staged, mb)
    return out.reshape((b,) + x.shape[1:])


def _vit_embed_and_pad(model, params, img, pad_multiple: int = 1):
    """Shared ViT prologue for the parallel applies: patch embed and cls/pos
    (mirrors models/vit.py), then a pad of the token axis to a multiple of
    ``pad_multiple`` (the sp ring needs one equal token shard per device).
    Returns ``(x, n, true_tokens)``; ``true_tokens`` is None when nothing
    was padded."""
    from vitax.core.utils import pair
    from vitax.nn.embed import PatchEmbed

    ph, _ = pair(model.patch_size)
    x = PatchEmbed(
        model.dim, ph, dtype=model.dtype,
        out_dtype=model.residual_dtype or model.dtype,
    ).apply({"params": params["patch_embed"]}, img)
    b = x.shape[0]
    cls = params["cls"]
    pos = params["pos_embedding"]
    x = jnp.concatenate(
        [jnp.broadcast_to(cls.astype(x.dtype), (b, 1, model.dim)), x], axis=1
    )
    x = x + pos.astype(x.dtype)
    n = x.shape[1]
    n_pad = -(-n // pad_multiple) * pad_multiple
    if n_pad == n:
        return x, n, None
    return jnp.pad(x, ((0, 0), (0, n_pad - n), (0, 0))), n, n


def raw_block_apply(p, xv, *, attn_fn, reduce_fn, dtype, eps, activation):
    """One raw-param encoder block — LN → attention → +residual → LN →
    MLP → +residual — with the SAME op order and rounding points as the
    single-device encoder block (fp32 LN/epilogues, the attention residual
    rounds to the stream dtype BEFORE the FF LayerNorm). Shared by the tensor-parallel pipeline block and the
    sequence-parallel ring block so their epilogues cannot drift.

    ``attn_fn(xn, p) -> fp32 pre-bias attention output`` owns the
    attention math (tp: local heads + partial out GEMM; sp: the K/V
    ring). ``reduce_fn`` is the row-parallel reduction applied to the
    attention output AND the second MLP GEMM (``lax.psum`` over the model
    axis for tp; identity otherwise) — biases and residuals are added
    after it, on replicated values."""
    from vitax.nn.blocks import _activate
    from vitax.ops import layer_norm_f32 as _ln_f32

    xf = xv.astype(jnp.float32)
    xn = _ln_f32(
        xf, p["ln1_s"].astype(jnp.float32), p["ln1_b"].astype(jnp.float32), eps
    ).astype(dtype)
    out = reduce_fn(attn_fn(xn, p))
    mid = (out + p["bout"].astype(jnp.float32) + xf).astype(xv.dtype)
    midf = mid.astype(jnp.float32)
    xn2 = _ln_f32(
        midf, p["ln2_s"].astype(jnp.float32), p["ln2_b"].astype(jnp.float32), eps
    ).astype(dtype)
    h1 = jnp.einsum(
        "bnd,df->bnf", xn2, p["w1"].astype(dtype),
        preferred_element_type=jnp.float32,
    )
    h1 = _activate(h1 + p["b1"].astype(jnp.float32), activation).astype(dtype)
    out2 = reduce_fn(jnp.einsum(
        "bnf,fd->bnd", h1, p["w2"].astype(dtype),
        preferred_element_type=jnp.float32,
    ))
    return (out2 + p["b2"].astype(jnp.float32) + midf).astype(xv.dtype)


def _vit_head(model, params, x, n):
    from vitax._vendor.flax import linen as nn

    x = x[:, :n]
    x = x[:, 0] if model.pool == "cls" else jnp.mean(x, axis=1)
    x = nn.LayerNorm(epsilon=model.norm_eps, dtype=jnp.float32).apply(
        {"params": params["head_norm"]}, x
    )
    return nn.Dense(model.num_classes, dtype=jnp.float32).apply(
        {"params": params["head"]}, x
    )


def pipeline_vit_apply(
    model,
    variables: Any,
    img: jax.Array,
    mesh: Mesh,
    *,
    n_micro: Optional[int] = None,
) -> jax.Array:
    """ViT inference forward with the encoder depth pipelined over ``mesh``.

    Mirrors ``ViT.__call__`` (models/vit.py:48-96) op for op — patch embed,
    cls/pos and the head run as ordinary (data-sharded or replicated) ops; only the
    block stack goes through the pipeline schedule. Logits match the
    single-device ``model.apply`` (asserted ≤1e-5 in tests); gradients
    through this function match the unpipelined gradients.
    """
    from vitax.nn.blocks import EncoderBlock

    params = variables["params"]
    x, n, _ = _vit_embed_and_pad(model, params, img)

    block = EncoderBlock(
        dim=model.dim,
        heads=model.heads,
        dim_head=model.dim_head,
        mlp_dim=model.mlp_dim,
        dropout=0.0,
        qkv_bias=model.qkv_bias,
        activation=model.activation,
        norm_eps=model.norm_eps,
        dtype=model.dtype,
    )

    def block_fn(p, xv):
        y, _ = block.apply({"params": p}, xv)
        return y

    x = spmd_pipeline(
        block_fn, params["encoder"]["blocks"], x, mesh, n_micro=n_micro
    )
    return _vit_head(model, params, x, n)


def pipeline_tp_vit_apply(
    model,
    variables: Any,
    img: jax.Array,
    mesh: Mesh,
    *,
    n_micro: Optional[int] = None,
) -> jax.Array:
    """3D-parallel ViT forward: depth pipelined over ``pipe``, every
    block's GEMMs tensor-sharded over ``model`` (Megatron split: qkv/W1
    column-parallel by heads / hidden, out/W2 row-parallel with one
    ``lax.psum`` each), batch over ``data`` — all three axes in ONE
    program on a ``make_pipeline3d_mesh`` mesh.

    The block body is the explicit-collective twin of the encoder block
    (same op order and fp32 epilogues, so logits match the single-device
    ``model.apply``); it runs inside the pipeline's shard_map, so the
    per-layer psums ride the ``model`` axis while the per-tick ppermute
    rides ``pipe``. Requires ``heads`` and ``mlp_dim`` divisible by the model-
    axis size.
    """
    params = variables["params"]
    n_model = mesh.shape[MODEL_AXIS]
    if model.heads % n_model or model.mlp_dim % n_model:
        raise ValueError(
            f"heads {model.heads} and mlp_dim {model.mlp_dim} must divide "
            f"by the model axis ({n_model})"
        )
    if model.qkv_bias:
        raise ValueError(
            "pipeline_tp_vit_apply shards the raw-param attention layout; "
            "qkv_bias (flax-submodule) ViTs aren't supported here"
        )
    x, n, _ = _vit_embed_and_pad(model, params, img)

    blocks = params["encoder"]["blocks"]
    attn, ff = blocks["attn"], blocks["ff"]
    depth = attn["qkv_kernel"].shape[0]
    dim, heads, dh = model.dim, model.heads, model.dim_head
    dtype = model.dtype or x.dtype
    eps = model.norm_eps
    scale = dh**-0.5

    # tp-layout views: expose the head axis (qkv columns are [q|k|v] blocks
    # of heads*dh — reshape so the MODEL axis shards whole heads) and the
    # hidden axis; biases of row-parallel GEMMs stay replicated and are
    # added AFTER the psum.
    tp_params = {
        "ln1_s": attn["norm_scale"], "ln1_b": attn["norm_bias"],
        "wqkv": attn["qkv_kernel"].reshape(depth, dim, 3, heads, dh),
        "wout": attn["out_kernel"].reshape(depth, heads, dh, dim),
        "bout": attn["out_bias"],
        "ln2_s": ff["ln_scale"], "ln2_b": ff["ln_bias"],
        "w1": ff["w1"], "b1": ff["b1"], "w2": ff["w2"], "b2": ff["b2"],
    }
    tp_specs = {
        "ln1_s": (None,), "ln1_b": (None,),
        "wqkv": (None, None, MODEL_AXIS, None),   # column-parallel by head
        "wout": (MODEL_AXIS, None, None),         # row-parallel by head
        "bout": (None,),
        "ln2_s": (None,), "ln2_b": (None,),
        "w1": (None, MODEL_AXIS),                 # column-parallel hidden
        "b1": (MODEL_AXIS,),
        "w2": (MODEL_AXIS, None),                 # row-parallel hidden
        "b2": (None,),
    }

    def tp_attn(xn, p):
        # local heads + PARTIAL out GEMM (fp32, pre-bias); raw_block_apply's
        # reduce_fn (psum over `model`) completes the row-parallel sum
        h_loc = p["wqkv"].shape[2]
        wqkv = p["wqkv"].astype(dtype).reshape(dim, 3 * h_loc * dh)
        qkv = jnp.einsum(
            "bnd,df->bnf", xn, wqkv, preferred_element_type=jnp.float32
        ).astype(dtype)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        split = lambda t: t.reshape(t.shape[0], t.shape[1], h_loc, dh).transpose(0, 2, 1, 3)
        q, k, v = split(q), split(k), split(v)
        s = jnp.einsum(
            "bhid,bhjd->bhij", q, k, preferred_element_type=jnp.float32
        ) * scale
        prob = jax.nn.softmax(s, axis=-1)
        o = jnp.einsum("bhij,bhjd->bhid", prob.astype(v.dtype), v)
        o = o.transpose(0, 2, 1, 3).reshape(xn.shape[0], xn.shape[1], h_loc * dh)
        return jnp.einsum(
            "bnf,fd->bnd", o.astype(dtype),
            p["wout"].astype(dtype).reshape(h_loc * dh, dim),
            preferred_element_type=jnp.float32,
        )

    def tp_block_fn(p, xv):
        # runs inside the pipeline's shard_map: leaves are tp-local
        return raw_block_apply(
            p, xv, attn_fn=tp_attn,
            reduce_fn=lambda t: jax.lax.psum(t, MODEL_AXIS),
            dtype=dtype, eps=eps, activation=model.activation,
        )

    x = spmd_pipeline(
        tp_block_fn, tp_params, x, mesh, n_micro=n_micro, param_specs=tp_specs
    )
    return _vit_head(model, params, x, n)


def make_pipeline3d_train_step(
    model,
    mesh: Mesh,
    optimizer=None,
    *,
    n_micro: Optional[int] = None,
) -> Callable:
    """Jitted ``step(state, images, labels) -> (state, loss)`` training
    through the 3D forward above.

    Params stay replicated at rest (build the state with
    ``create_train_state(model, rng, sample, mesh=None)``);
    ``pipeline_tp_vit_apply`` shards them per-leaf inside its shard_map,
    whose transpose both sums the tp-sharded gradient contributions and
    reduces across the data axis — ``jax.grad`` straight through is the
    full data+tensor+pipeline-parallel backward (gradients match the
    single-device step, tests/test_pipeline.py)."""
    import optax

    from vitax.train import TrainState, cross_entropy_loss, make_optimizer

    optimizer = optimizer or make_optimizer()

    def step(state: TrainState, images: jax.Array, labels: jax.Array):
        def loss_fn(params):
            logits = pipeline_tp_vit_apply(
                model, {"params": params}, images, mesh, n_micro=n_micro
            )
            return cross_entropy_loss(logits, labels)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return (
            TrainState(params, opt_state, state.step + 1, state.model_state),
            loss,
        )

    return jax.jit(step)
