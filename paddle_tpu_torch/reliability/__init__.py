"""Typed failures, fault injection, retry and circuit breaking, durable
checkpoints and the fault-tolerant training supervisor: the port of the
JAX package's reliability layer, cut to what the server and the
training loop use."""
from . import faults
from .ckpt import (AsyncCheckpointer, CheckpointStore, checkpoint_meta,
                   read_checkpoint, recover_interrupted_swaps,
                   verify_checkpoint, write_checkpoint)
from .errors import (CallbackError, CheckpointCorruptError,
                     CircuitOpenError, DeadlineExceeded, InjectedFault,
                     QueueFullError, ReliabilityError, RequestCancelled,
                     ServerClosed, StepFailedError, TrainAnomalyError)
from .faults import FaultInjector
from .retry import CircuitBreaker, RetryPolicy
from .training import (AnomalyPolicy, ResumableLoader, TrainReport,
                       TrainSupervisor)

__all__ = ["ReliabilityError", "DeadlineExceeded", "QueueFullError",
           "RequestCancelled", "ServerClosed", "CallbackError",
           "CircuitOpenError", "InjectedFault", "CheckpointCorruptError",
           "TrainAnomalyError", "StepFailedError", "faults",
           "FaultInjector", "RetryPolicy", "CircuitBreaker",
           "write_checkpoint", "read_checkpoint", "verify_checkpoint",
           "checkpoint_meta", "recover_interrupted_swaps",
           "CheckpointStore", "AsyncCheckpointer", "AnomalyPolicy",
           "TrainReport", "ResumableLoader", "TrainSupervisor"]
