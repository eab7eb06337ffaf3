"""Typed failures, fault injection, retry and circuit breaking, the
serve loop's supervisor and health states, durable checkpoints and the
fault-tolerant training supervisor: the port of the JAX package's
reliability layer, cut to what the server, the fleet (in process and
over the wire) and the training loop use."""
from . import faults
from .ckpt import (AsyncCheckpointer, CheckpointStore, checkpoint_meta,
                   read_checkpoint, recover_interrupted_swaps,
                   verify_checkpoint, write_checkpoint)
from .errors import (CallbackError, CheckpointCorruptError,
                     CircuitOpenError, DeadlineExceeded, FrameError,
                     InjectedFault, MigrationError, PreemptedError,
                     QueueFullError, ReliabilityError, ReplicaLostError,
                     RequestCancelled, SchedulerClosed, ServerClosed,
                     StepFailedError,
                     TrainAnomalyError, TransportError)
from .faults import FaultInjector
from .health import (DEAD, DEGRADED, DRAINING, HEALTH_CODES, HEALTHY,
                     HealthMonitor, is_serving_state)
from .retry import CircuitBreaker, RetryPolicy
from .supervisor import ServeSupervisor
from .training import (AnomalyPolicy, ResumableLoader, TrainReport,
                       TrainSupervisor)

__all__ = ["ReliabilityError", "DeadlineExceeded", "QueueFullError",
           "RequestCancelled", "ServerClosed", "SchedulerClosed",
           "CallbackError",
           "CircuitOpenError", "ReplicaLostError", "PreemptedError",
           "MigrationError", "InjectedFault", "TransportError",
           "FrameError", "CheckpointCorruptError",
           "TrainAnomalyError",
           "StepFailedError", "faults", "FaultInjector", "RetryPolicy",
           "CircuitBreaker", "ServeSupervisor", "HealthMonitor",
           "HEALTHY", "DEGRADED", "DRAINING", "DEAD", "HEALTH_CODES",
           "is_serving_state",
           "write_checkpoint", "read_checkpoint", "verify_checkpoint",
           "checkpoint_meta", "recover_interrupted_swaps",
           "CheckpointStore", "AsyncCheckpointer", "AnomalyPolicy",
           "TrainReport", "ResumableLoader", "TrainSupervisor"]
