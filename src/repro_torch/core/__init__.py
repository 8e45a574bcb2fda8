"""CIMFlow core on tensors: host IR, compiler passes, code generation and
the simulators (copies of :mod:`repro.core`), the integer vector
semantics, the functional oracle and the tensor stage decode.

Pipeline:  workloads -> graph (condense) -> partition (Alg. 1 / baselines)
           -> mapping cost model -> oplevel + codegen (ISA streams) ->
           simulator (cycle-accurate / functional ISS; ``engine="torch"``
           decodes stages on the card via :mod:`.torchsim`) or
           :mod:`.trace` (StagePlan replay); :mod:`.ref` forward-passes
           the condensed graph on the bit-serial CIM kernel.
"""

from . import (arch, codegen, energy, graph, isa, machine, mapping,
               oplevel, partition, ref, simulator, torchsim, trace, vecsem,
               vectorsim, workloads)
from .arch import ChipConfig, default_chip
from .codegen import CompiledModel, QuantParams
from .graph import CondensedGraph, Graph
from .mapping import CostParams
from .partition import STRATEGIES, PartitionResult
from .simulator import SimReport, Simulator

__all__ = [
    "arch", "codegen", "energy", "graph", "isa", "machine", "mapping",
    "oplevel", "partition", "ref", "simulator", "torchsim", "trace",
    "vecsem", "vectorsim", "workloads", "ChipConfig", "default_chip",
    "CompiledModel", "CondensedGraph", "Graph", "CostParams",
    "STRATEGIES", "PartitionResult", "QuantParams", "SimReport",
    "Simulator",
]
