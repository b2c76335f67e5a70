from medplib_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_MODEL,
    Mesh,
    current_mesh,
    init_distributed,
    local_mesh,
    make_mesh,
    param_spec,
    set_mesh,
    shard_params,
)
