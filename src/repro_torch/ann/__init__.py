# The port's public vector-search API: build | load -> search, add, delete,
# on the CUDA device.
from repro_torch.ann.spec import (ALGORITHMS, BUILDERS, METRICS,  # noqa: F401
                                  IndexSpec, SearchParams)
from repro_torch.ann.index import (AnnIndex, SearchResult,  # noqa: F401
                                   apply_entry_policy, quantize_graph)
