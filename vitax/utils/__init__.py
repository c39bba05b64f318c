from vitax.utils.importer import (  # noqa: F401
    import_reference_deepvit_params,
    import_reference_lsa_params,
    import_reference_simple_vit_params,
    import_reference_vit_params,
)
from vitax.utils.aot import (  # noqa: F401
    ExportedServing,
    export_forward,
    export_serving,
    load_forward,
)
from vitax.utils.bn_folding import fold_batch_norm  # noqa: F401
from vitax.utils.debug import checked, debug_nans  # noqa: F401
from vitax.utils.health import (  # noqa: F401
    compilation_cache_dir,
    enable_compilation_cache,
    memory_stats,
    probe_devices,
    with_retry,
)
from vitax.utils.interop import (  # noqa: F401
    export_vit_to_hf,
    hf_vit_config,
    import_hf_vit_params,
    vit_from_hf,
)
from vitax.utils.parity import fp64_vit_forward, max_logit_err  # noqa: F401
from vitax.utils.quantize import (  # noqa: F401
    quantize_vit,
    resolve_quant_mode,
    simple_vit_apply_w8a8,
    vit_apply_w8a8,
)
from vitax.utils.pos_embed import (  # noqa: F401
    adapt_vit_resolution,
    interpolate_pos_embedding,
)

# Checkpoint symbols stay lazy: importing vitax.utils for profiling/health
# must not eagerly pull in orbax and its background machinery .
_CHECKPOINT_SYMBOLS = (
    "CheckpointManager",
    "abstract_train_state",
    "restore_checkpoint",
    "save_checkpoint",
)


def __getattr__(name):
    if name in _CHECKPOINT_SYMBOLS:
        from vitax.utils import checkpoint as _ckpt

        return getattr(_ckpt, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
