"""Sanitizer / debugging utilities (SURVEY.md §5 'race detection /
sanitizers' row: the JAX-level equivalents — there are no hand-written
threads to TSAN).

- NaN/OOB checking via ``jax.experimental.checkify`` wrapped around any
  jitted callable;
- global NaN debugging toggles.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import jax
from jax.experimental import checkify


def checked(fn: Callable, errors=checkify.float_checks) -> Callable:
    """Wrap ``fn`` so NaN/Inf (and optionally OOB/div) errors surface as
    Python exceptions with location info instead of silent garbage.

    Usage::
        safe_apply = checked(lambda v, x: model.apply(v, x))
        logits = safe_apply(variables, imgs)   # raises on NaN
    """
    cfn = checkify.checkify(fn, errors=errors)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapper


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Enable jax_debug_nans for the enclosed block (eager NaN tracebacks)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
