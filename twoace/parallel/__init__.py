from .mesh import (  # noqa: F401
    BATCH_AXIS,
    ROWS_AXIS,
    batch_sharding,
    make_mesh,
    problem_sharding,
)
from .sharded_admm import solve_lowrank_sharded  # noqa: F401
from .sharded_pair import solve_lowrank_sharded_pair  # noqa: F401
from .distributed import initialize_multihost  # noqa: F401
