"""Multi-device parallelism: device meshes and sharding rules.

The reference is a single-process single-replica server with no distributed
compute (SURVEY.md §2 'Parallelism & distribution'); this package supplies
the scaling story: a (dp, tp) `jax.sharding.Mesh`, NamedSharding-annotated
parameter/cache pytrees, and XLA-inserted collectives (tensor-parallel
attention/MLP) with data parallelism across windows/streams.
"""

from speaksense_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    param_shardings,
    cache_shardings,
    pool_state_shardings,
    shard_params,
    shard_pool_state,
)
from speaksense_tpu.parallel.multihost import (  # noqa: F401
    init_distributed,
    local_serving_mesh,
)
