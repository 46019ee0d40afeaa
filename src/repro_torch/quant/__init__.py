"""int8/fp8 post-training quantization of neural fields: the port of the
JAX package's ``repro.quant``. Layering: ``qtypes`` (codecs) <-
``calibrate`` (params -> scales) <- ``api`` (whole-field transform)."""
from repro_torch.quant.api import (dequantize_field, is_quantized_field,
                                   maybe_dequant_mlp, quantize_field)
from repro_torch.quant.qtypes import QuantSpec, dequantize, quantize

__all__ = [
    "QuantSpec", "quantize", "dequantize",
    "quantize_field", "dequantize_field", "is_quantized_field",
    "maybe_dequant_mlp",
]
