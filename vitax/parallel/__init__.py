from vitax.parallel.api import data_parallel_apply  # noqa: F401
from vitax.parallel.pipeline import (  # noqa: F401
    PIPE_AXIS,
    make_pipeline3d_mesh,
    make_pipeline3d_train_step,
    make_pipeline_mesh,
    pipeline_tp_vit_apply,
    pipeline_vit_apply,
    spmd_pipeline,
)
from vitax.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_vit_apply,
)
from vitax.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    data_sharding,
    make_mesh,
    replicated,
)
from vitax.parallel.sharding import (  # noqa: F401
    DEFAULT_TP_RULES,
    replicate_params,
    fsdp_param_specs,
    shard_params,
    shard_params_fsdp,
    tp_param_specs,
)
