from .mesh import make_mesh  # noqa: F401
from .dist_ba import (  # noqa: F401
    distributed_bundle_adjust,
    partition_problem,
    solve_partitioned,
)
