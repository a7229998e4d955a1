# Speed-ANN core as plain torch functions on batch-leading tensors.
from repro_torch.core.config import SearchConfig  # noqa: F401
from repro_torch.core.graph import (PaddedCSR, compute_medoid,  # noqa: F401
                                    make_padded_csr)
from repro_torch.core.build import (exact_knn, knn_graph,  # noqa: F401
                                    normalize_rows)
from repro_torch.core.bfis import (bfis_search_batch, dist_ip,  # noqa: F401
                                   dist_l2, make_ref_dist_fn,
                                   point_dist, resolve_dist_fn, search_topm,
                                   search_topm_batch,
                                   search_topm_batch_visited)
from repro_torch.core.speedann import (search_speedann,  # noqa: F401
                                       search_speedann_batch, variant)
from repro_torch.core.metrics import SearchStats, recall_at_k  # noqa: F401
