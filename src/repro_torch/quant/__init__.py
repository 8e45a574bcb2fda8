"""INT8 quantization utilities (paper §IV-A: weights/activations INT8).

Bridges the models to the CIM arithmetic model: symmetric per-tensor or
per-channel weight quantization and fake quantization for QAT.  The
drop-in quantized linear (on the direct INT8 kernel or the bit-serial
CIM kernel) is :func:`repro_torch.kernels.ops.quantized_linear`.
Counterpart of :mod:`repro.quant`.
"""

from .quantize import (QTensor, dequantize, fake_quant, quantize_tensor,
                       quantize_tree)

__all__ = ["QTensor", "quantize_tensor", "quantize_tree", "dequantize",
           "fake_quant"]
