# Quantized vector storage: QuantSpec schemes (int8 | bf16), the codec, and
# the quantized distance backends.  The backends in repro_torch.quant.kernels
# self-register with repro_torch.kernels.registry (imported from the registry
# module, not here, to keep the import graph acyclic) and are selected by
# SearchParams.backend on an index quantized with ann.index.quantize_graph or
# loaded from a file built with IndexSpec(quant=...).
from repro_torch.quant.codec import (cache_codes, code_key,  # noqa: F401
                                     dequantize, fit_scales, max_error_bound,
                                     no_scales, quantize, quantize_query,
                                     query_cache_key, query_levels)
from repro_torch.quant.scheme import (QUANT_DTYPES, QuantSpec,  # noqa: F401
                                      coerce_quant, required_quant_dtype)
