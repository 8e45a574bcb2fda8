"""CIMFlow core on tensors: host IR and compiler passes (copies of
:mod:`repro.core`), the integer vector semantics and the functional
oracle.

Pipeline:  workloads -> graph (condense) -> partition (Alg. 1 / baselines)
           -> mapping cost model; :mod:`.ref` forward-passes the
           condensed graph on the bit-serial CIM kernel.
"""

from . import (arch, energy, graph, machine, mapping, partition, ref,
               vecsem, workloads)
from .arch import ChipConfig, default_chip
from .graph import CondensedGraph, Graph
from .mapping import CostParams
from .partition import STRATEGIES, PartitionResult
from .ref import QuantParams

__all__ = [
    "arch", "energy", "graph", "machine", "mapping", "partition", "ref",
    "vecsem", "workloads", "ChipConfig", "default_chip", "CondensedGraph",
    "Graph", "CostParams", "STRATEGIES", "PartitionResult", "QuantParams",
]
