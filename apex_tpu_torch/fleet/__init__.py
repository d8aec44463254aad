"""Serving fleet: multi-replica orchestration over the port's engines.

Counterpart of ``apex_tpu/fleet``, host-side code with duck-typed
replicas, so the control logic is copied and the replicas are the
port's :class:`~apex_tpu_torch.serving.Engine`, ``PagedEngine`` and
``Seq2SeqEngine``:

- :class:`Fleet` (fleet.py): N replicas behind one
  submit/step/result API, bounded-queue backpressure
  (:class:`FleetOverloaded`), failover that restarts reclaimed
  requests on survivors with the exactness contract intact, and a
  step pool that never lets a CUDA-graph capture meet another
  replica's work;
- routing policies (router.py): :class:`RoundRobin`,
  :class:`LeastLoaded`, :class:`PrefixAffinity`, plus
  :class:`RetryPolicy` (exponential backoff, seeded jitter);
- health (health.py): EWMA-driven ``healthy`` / ``degraded`` /
  ``dead`` states, a circuit breaker with half-open probing, and
  graceful drain for rolling restarts;
- faults (faults.py): :class:`FaultyReplica`, the seeded
  deterministic fault-injection harness, and :class:`TrainingFaults`;
- SLO/goodput (slo.py): :class:`SloTracker`, per-request
  deadline-attainment, the queue-wait vs service split, and
  ``goodput_tokens_per_s`` — tokens delivered *within* SLO — on
  ``Fleet.stats()``/``record()``;
- recovery (recovery.py): :class:`RecoveryLog`, the episode / action /
  MTTR bookkeeping of ``kind: recovery`` records,
  :class:`PreemptionGuard` and :func:`reshard_flat_state`; the elastic
  trainer (:class:`ElasticTrainer`) is ROADMAP.md queue 1 item 8b and
  raises;
- autoscale (autoscale.py): the loop's serving side —
  :class:`SloController` reads the SLO tracker's per-tick deltas and
  actuates the admission bound (per CLASS under a multi-class QoS
  policy), decode windows where a replica has ``set_window`` (no
  engine of either package has), drain/undrain and the breaker's
  cooldowns with hysteresis and bounded actuation;
- QoS (qos.py): :class:`QosPolicy` (priority classes: weight,
  default deadline, queue share, preemptibility, tenant->class map)
  and :class:`WfqQueue` — the deterministic stride-scheduled pending
  queue, plus the fleet-side decode preemption it enables (evict a low
  class mid-decode, re-queue from the prompt, exactness intact).
"""

from .fleet import Fleet
from .health import (DEAD, DEGRADED, DRAINED, DRAINING, HEALTHY,
                     STATE_CODES, Ewma, HealthConfig, ReplicaHealth)
from .router import (FleetOverloaded, LeastLoaded, PrefixAffinity,
                     RetryPolicy, RoundRobin, make_policy)
from .faults import FaultyReplica, ReplicaFault, TrainingFaults
from .slo import SloTracker, split_from_trace
from .recovery import (RECOVERY_ACTION_KINDS, RECOVERY_CAUSES,
                       RECOVERY_ROLES, ElasticConfig, ElasticTrainer,
                       PreemptionGuard, RecoveryError, RecoveryLog,
                       reshard_flat_state)
from .autoscale import AutoscaleConfig, SloController
from .qos import QosClass, QosPolicy, WfqQueue
from . import qos, slo

__all__ = ["Fleet", "FleetOverloaded", "RetryPolicy", "RoundRobin",
           "QosClass", "QosPolicy", "WfqQueue", "qos",
           "LeastLoaded", "PrefixAffinity", "make_policy",
           "HealthConfig", "ReplicaHealth", "Ewma", "HEALTHY",
           "DEGRADED", "DEAD", "DRAINING", "DRAINED", "STATE_CODES",
           "FaultyReplica", "ReplicaFault", "TrainingFaults",
           "SloTracker", "split_from_trace", "slo",
           "RECOVERY_ROLES", "RECOVERY_ACTION_KINDS",
           "RECOVERY_CAUSES", "RecoveryError", "RecoveryLog",
           "PreemptionGuard", "ElasticConfig", "ElasticTrainer",
           "reshard_flat_state", "AutoscaleConfig", "SloController"]
