"""Architecture registry: ``--arch <id>`` resolution + cell validity."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .base import (ArchConfig, MlaConfig, MoeConfig, ShapeConfig,
                   SsmConfig, STANDARD_SHAPES, reduced)

from . import (deepseek_coder_33b, deepseek_v3_671b, h2o_danube3_4b,
               jamba15_large_398b, llava_next_mistral_7b, mamba2_780m,
               olmoe_1b_7b, phi3_medium_14b, phi4_mini_3_8b,
               whisper_small)

__all__ = ["ARCHS", "get_arch", "valid_cells", "cell_skip_reason",
           "ArchConfig", "ShapeConfig", "STANDARD_SHAPES", "reduced",
           "MoeConfig", "MlaConfig", "SsmConfig"]

_MODULES = [
    phi3_medium_14b, deepseek_coder_33b, h2o_danube3_4b, phi4_mini_3_8b,
    mamba2_780m, whisper_small, jamba15_large_398b, deepseek_v3_671b,
    olmoe_1b_7b, llava_next_mistral_7b,
]

ARCHS: Dict[str, ArchConfig] = {m.ARCH.name: m.ARCH for m in _MODULES}


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}") \
            from None


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str:
    """Empty string when the (arch x shape) cell runs; else why not."""
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return ("full quadratic attention: long_500k needs sub-quadratic "
                "attention (DESIGN.md §3)")
    return ""


def valid_cells() -> List[Tuple[ArchConfig, ShapeConfig]]:
    out = []
    for cfg in ARCHS.values():
        for shape in STANDARD_SHAPES.values():
            if not cell_skip_reason(cfg, shape):
                out.append((cfg, shape))
    return out
