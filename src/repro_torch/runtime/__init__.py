"""Distributed-runtime substrate: failure detection, elastic re-meshing,
straggler mitigation.  All components are device-free and CPU-testable;
the launcher wires them to real heartbeats / step timings.

Copied from :mod:`repro.runtime` as it is (host code)."""

from .fault import FailureDetector, HeartbeatRegistry
from .elastic import ElasticPlan, plan_remesh
from .straggler import StragglerDetector

__all__ = ["FailureDetector", "HeartbeatRegistry", "ElasticPlan",
           "plan_remesh", "StragglerDetector"]
