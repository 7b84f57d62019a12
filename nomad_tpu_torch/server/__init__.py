"""The port's control plane: broker, blocked evals, plan queue and
applier, the sequential and batched workers, and the `Server` that
wires them together."""
from .eval_broker import EvalBroker  # noqa: F401
from .blocked_evals import BlockedEvals  # noqa: F401
from .plan_queue import PlanQueue  # noqa: F401
from .plan_apply import PlanApplier, evaluate_plan  # noqa: F401
from .worker import Worker  # noqa: F401
from .server import Server  # noqa: F401
