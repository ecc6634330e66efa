"""Data and expert parallelism over ``torch.distributed``: the runtime init
and rank helpers, the (data, expert) layout and parameter sharding, and the
collectives of the expert-parallel MoE forms (``ops/moe.py``)."""
from .distributed import (  # noqa: F401
    dist_backend,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
)
from .sharding import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    Mesh,
    axis_index,
    make_mesh,
    mesh_axis_size,
    shard_params,
)
