"""BatchNorm folding: an inference-time load transform for the conv-hybrid
families (CvT, LeViT).

At inference BatchNorm with running stats is a per-channel affine map
``z -> a*z + c`` with ``a = scale/sqrt(var+eps)``, ``c = bias - a*mean``.
Composed with the conv that produces ``z`` it is just another conv:
``BN(W*x + b0) = (aW)*x + (a*b0 + c)`` — so the BN op can be deleted from
the graph entirely and its affine folded into the conv kernel/bias. The
reference cannot express this transform at all: it hardcodes training-mode
BN (``use_running_average=False``) forever (reference cvt.py:73,
levit.py:79), recomputing batch statistics at every inference call.

Folded pairs (by module naming):
  - ``DepthWiseConv2d``: ``depthwise`` <- ``bn``     (nn/conv.py)
  - ``ConvMLP`` BN flavor: ``up`` <- ``bn1``, ``down`` <- ``bn2``
  - LeViT attention: ``{p}_conv`` <- ``{p}_bn``      (models/levit.py)

Usage::

    folded_model, folded_vars = fold_batch_norm(model, variables)
    logits = folded_model.apply(folded_vars, img)   # no batch_stats needed

The fold is computed in float64 and cast back, so folded-vs-unfolded logits
agree to ~1e-7 relative at fp32 (tested to 1e-5 in tests/test_model_behaviors.py).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np

# BN node name -> the conv (in the same parent scope) whose output it normalizes.
_STATIC_PAIRS = {"bn": "depthwise", "bn1": "up", "bn2": "down"}


def _conv_name_for(bn_name: str):
    if bn_name in _STATIC_PAIRS:
        return _STATIC_PAIRS[bn_name]
    if bn_name.endswith("_bn"):
        return bn_name[:-3] + "_conv"
    return None


def _is_bn(params_node, stats_node) -> bool:
    return (
        isinstance(params_node, dict)
        and set(params_node) == {"scale", "bias"}
        and isinstance(stats_node, dict)
        and set(stats_node) == {"mean", "var"}
    )


def _fold_into_conv(conv: Dict[str, Any], bn_params, bn_stats, eps: float):
    a64 = np.asarray(bn_params["scale"], np.float64) / np.sqrt(
        np.asarray(bn_stats["var"], np.float64) + eps
    )
    c64 = np.asarray(bn_params["bias"], np.float64) - a64 * np.asarray(
        bn_stats["mean"], np.float64
    )
    kernel = np.asarray(conv["kernel"], np.float64)
    dtype = np.asarray(conv["kernel"]).dtype
    conv["kernel"] = jnp.asarray((kernel * a64).astype(dtype))  # scale out-channels
    b0 = np.asarray(conv["bias"], np.float64) if "bias" in conv else 0.0
    conv["bias"] = jnp.asarray((a64 * b0 + c64).astype(dtype))


def _walk(params: Dict[str, Any], stats: Dict[str, Any], eps: float) -> int:
    """Fold every recognized (conv, bn) pair under this scope; recurse.
    Mutates ``params`` in place and deletes consumed entries from both
    trees. Returns the number of BNs folded."""
    folded = 0
    for name in list(params):
        p_child, s_child = params.get(name), stats.get(name)
        if _is_bn(p_child, s_child):
            conv_name = _conv_name_for(name)
            if conv_name is None or conv_name not in params:
                raise ValueError(
                    f"unrecognized BatchNorm '{name}' (no adjacent conv); "
                    "fold_batch_norm only knows the CvT/LeViT patterns"
                )
            _fold_into_conv(params[conv_name], p_child, s_child, eps)
            del params[name]
            del stats[name]
            folded += 1
        elif isinstance(p_child, dict):
            folded += _walk(p_child, s_child if isinstance(s_child, dict) else {}, eps)
            if isinstance(s_child, dict) and not s_child:
                stats.pop(name, None)
    return folded


def fold_batch_norm(model, variables, *, eps: float = 1e-5) -> Tuple[Any, Dict]:
    """Fold all BatchNorms in ``variables`` into their producing convs.

    Args:
      model: a flax module with a ``fold_bn`` field (CvT, LeViT).
      variables: the ``{'params': ..., 'batch_stats': ...}`` tree.
      eps: the BN epsilon (all zoo BNs use 1e-5 — flax's default and
        LeViT's explicit value).

    Returns:
      ``(folded_model, folded_variables)`` — the model cloned with
      ``fold_bn=True`` and a variables tree with no ``batch_stats``.
    """
    from vitax._vendor import flax

    def to_plain(d):
        if isinstance(d, (dict, flax.core.FrozenDict)):
            return {k: to_plain(v) for k, v in d.items()}
        return d

    params = to_plain(variables["params"])
    stats = to_plain(variables.get("batch_stats", {}))
    n = _walk(params, stats, eps)
    if n == 0:
        raise ValueError("no BatchNorm found to fold")

    def remaining(d):
        return any(remaining(v) if isinstance(v, dict) else True for v in d.values())

    if stats and remaining(stats):
        raise ValueError(f"unfolded batch_stats remain: {list(stats)}")

    folded_vars = {k: v for k, v in variables.items() if k != "batch_stats"}
    folded_vars["params"] = params
    return model.clone(fold_bn=True), folded_vars
