from .checkpointing import RoundCheckpointer
from .client import ClientPool, ClientState
from .controller import (Controller, ExperimentResult, RoundStats,
                         TrainingDriver)
from .executor import VectorizedExecutor
from .metrics import (bias, effective_update_ratio, invocation_distribution,
                      time_to_accuracy, trailing_eur,
                      trailing_straggler_ratio, weighted_accuracy,
                      windowed_update_ratio)
from .scheduler import (SCHEDULERS, AdaptiveScheduler, ApodotikoScheduler,
                        FedLesScanScheduler, FullPoolScheduler,
                        RandomScheduler, RotationScheduler, Scheduler,
                        StrategySelectScheduler, make_scheduler)
from .tasks import ClassificationTask, TaskConfig

__all__ = ["ClientPool", "ClientState", "Controller", "ExperimentResult",
           "RoundStats", "TrainingDriver", "VectorizedExecutor",
           "RoundCheckpointer",
           "bias", "effective_update_ratio",
           "invocation_distribution", "weighted_accuracy",
           "windowed_update_ratio", "trailing_eur",
           "trailing_straggler_ratio", "time_to_accuracy",
           "SCHEDULERS", "Scheduler", "RandomScheduler",
           "FullPoolScheduler", "FedLesScanScheduler", "ApodotikoScheduler",
           "AdaptiveScheduler", "RotationScheduler",
           "StrategySelectScheduler", "make_scheduler",
           "ClassificationTask", "TaskConfig"]
