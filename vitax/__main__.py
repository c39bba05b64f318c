"""``python -m vitax`` — the framework's command-line front door.

The reference's only "CLI" is the per-file ``__main__`` smoke block
(reference vit.py:169-198 and 17 clones: construct with the README
hyperparameters, init on a random image, print the output shape and a
param count). This module is that surface done once, registry-driven,
plus pointers into the real entry points (training/serving/quantization
live in ``examples/`` and stay importable scripts — they need argparse
surfaces of their own).

    python -m vitax list            # families + tiny-config kwargs
    python -m vitax smoke vit       # init + jit forward one family
    python -m vitax smoke all       # the whole zoo
    python -m vitax version
"""

from __future__ import annotations

import argparse
import sys
import time


def _param_count(tree) -> int:
    import jax

    return sum(x.size for x in jax.tree_util.tree_leaves(tree) if hasattr(x, "size"))


def _kwarg_repr(v) -> str:
    """repr for a constructor listing: primitives verbatim; class instances
    (e.g. the injected Transformer in the `efficient` preset) as a
    placeholder naming the type — never silently dropped, so the printed
    constructor is honest about every required argument."""
    if hasattr(v, "__module__") and not isinstance(v, (int, float, str, tuple, list, bool)):
        return f"<{type(v).__name__}(...)>"
    return repr(v)


def cmd_list(args) -> int:
    if getattr(args, "presets", False):
        from vitax.models import REFERENCE_PRESETS

        for name in sorted(REFERENCE_PRESETS):
            ctor, cfg, image_size = REFERENCE_PRESETS[name]
            kwargs = ", ".join(f"{k}={_kwarg_repr(v)}" for k, v in cfg.items())
            print(f"{name:20s} {ctor.__name__}({kwargs})  # img {image_size}")
        print(
            "\nReference-scale constructors (docs/MODELS.md); build one with "
            "vitax.models.create(name, **overrides)."
        )
        return 0
    from vitax.models import MODEL_REGISTRY

    for name in sorted(MODEL_REGISTRY):
        cls, cfg, image_size = MODEL_REGISTRY[name]
        kwargs = ", ".join(f"{k}={_kwarg_repr(v)}" for k, v in cfg.items())
        print(f"{name:20s} {cls.__name__}({kwargs})  # img {image_size}")
    print(
        "\nThese are the smoke-test shapes; reference-scale constructors for "
        "every family: `python -m vitax list --presets` or docs/MODELS.md."
    )
    return 0


def _smoke_one(name: str) -> bool:
    import jax
    import jax.numpy as jnp

    from vitax.models import MODEL_REGISTRY

    cls, cfg, image_size = MODEL_REGISTRY[name]
    model = cls(**cfg)
    img = jax.random.normal(jax.random.PRNGKey(0), (1, image_size, image_size, 3))
    t0 = time.perf_counter()
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(1)}, img)
    logits = jax.jit(lambda v, x: model.apply(v, x))(variables, img)
    logits.block_until_ready()
    dt = time.perf_counter() - t0
    ok = bool(jnp.isfinite(logits).all()) and logits.shape == (1, cfg["num_classes"])
    print(
        f"{name:20s} logits {tuple(logits.shape)}  params {_param_count(variables):>9,d}"
        f"  init+forward {dt:5.1f}s  {'ok' if ok else 'FAIL'}"
    )
    return ok


def cmd_smoke(args) -> int:
    from vitax.models import MODEL_REGISTRY

    names = sorted(MODEL_REGISTRY) if args.family == "all" else [args.family]
    unknown = [n for n in names if n not in MODEL_REGISTRY]
    if unknown:
        print(f"unknown family {unknown[0]!r}; `python -m vitax list`", file=sys.stderr)
        return 2
    ok = True
    for n in names:  # a crashing family reports FAIL and the sweep continues
        try:
            ok &= _smoke_one(n)
        except Exception as e:
            print(f"{n:20s} FAIL ({type(e).__name__}: {e})")
            ok = False
    return 0 if ok else 1


def cmd_version(_args) -> int:
    import jax

    import vitax

    print(f"vitax {getattr(vitax, '__version__', '0.dev')}")
    print(f"jax {jax.__version__}  backend {jax.default_backend()}  "
          f"devices {len(jax.devices())}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vitax",
        description=__doc__.split("\n\n")[0],
        epilog=(
            "training:     python examples/train.py --help\n"
            "serving:      python examples/serve.py --help\n"
            "quantization: python examples/quantize.py --help\n"
            "benchmark:    python bench.py"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="model families and smoke configs")
    p.add_argument("--presets", action="store_true",
                   help="reference-scale constructors instead of smoke shapes")
    p.set_defaults(fn=cmd_list)
    p = sub.add_parser("smoke", help="init + jit forward a family (or 'all')")
    p.add_argument("family")
    p.set_defaults(fn=cmd_smoke)
    sub.add_parser("version", help="package/jax/backend info").set_defaults(
        fn=cmd_version
    )
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
