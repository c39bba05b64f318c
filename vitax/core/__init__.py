from vitax.core.utils import (  # noqa: F401
    cast_tuple,
    cdiv,
    conv_output_size,
    default,
    exists,
    pair,
    round_up,
)
