from .store import StateStore, StateSnapshot  # noqa: F401
from .node_table import NodeTable, Interner  # noqa: F401
