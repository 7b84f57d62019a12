from .structs import *  # noqa: F401,F403
from .funcs import (  # noqa: F401
    score_fit_binpack,
    score_fit_spread,
    compute_free_percentage,
    allocs_fit,
    filter_terminal_allocs,
    remove_allocs,
)
from .network import NetworkIndex, AssignedPort  # noqa: F401
from .node_class import (  # noqa: F401
    compute_node_class,
    constraint_escapes_class,
    escaped_constraints,
)
