# Speed-ANN core as plain torch functions on batch-leading tensors.
from repro_torch.core.config import SearchConfig  # noqa: F401
from repro_torch.core.graph import (PaddedCSR, compute_medoid,  # noqa: F401
                                    frequency_rank, group_by_indegree,
                                    indegree_rank, make_padded_csr, relabel,
                                    remap_sentinels, top_level_hit_fraction)
from repro_torch.core.build import (HNSWIndex, build_hnsw,  # noqa: F401
                                    build_nsg, build_nsg_serial, exact_knn,
                                    insert_points, knn_graph, normalize_rows,
                                    prune_dists, repair_deleted,
                                    robust_prune_batch)
from repro_torch.core.bfis import (bfis_search_batch, dist_ip,  # noqa: F401
                                   dist_l2, greedy_descent,
                                   hnsw_search_batch, make_ref_dist_fn,
                                   point_dist, resolve_dist_fn, search_topm,
                                   search_topm_batch,
                                   search_topm_batch_visited)
from repro_torch.core.speedann import (search_speedann,  # noqa: F401
                                       search_speedann_batch, variant)
from repro_torch.core.metrics import SearchStats, recall_at_k  # noqa: F401
