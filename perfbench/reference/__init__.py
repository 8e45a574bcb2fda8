"""Plain PyTorch references of the benchmark's models, the frozen
operation and byte counts, and the control's lower precision.

Nothing here imports the port, JAX or the JAX package: the references
take the weights and token ids that the benchmark made and work out
everything else again, in float32 with TF32 off.
"""

import importlib
from types import ModuleType


def module(name: str) -> ModuleType:
    """The reference module a configuration names (``"reference"``)."""
    return importlib.import_module(f"{__name__}.{name}")
