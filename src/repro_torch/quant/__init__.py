# Quantization schemes (the codec and the quantized backends are not
# ported yet).
from repro_torch.quant.scheme import (QUANT_DTYPES, QuantSpec,  # noqa: F401
                                      coerce_quant, required_quant_dtype)
