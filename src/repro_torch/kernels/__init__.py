# Hand-written CUDA gather-distance kernels (csrc/*.cu) and their wrappers:
#   l2dist  — rowgather (warp per candidate) and dma (cp.async tiles)
#   dedup   — dedup_gather (each distinct row of a tile of lanes once)
# ref.py holds the plain versions; registry.py the dist_backend seam.
from repro_torch.kernels.ops import l2dist  # noqa: F401
from repro_torch.kernels.registry import (available_backends,  # noqa: F401
                                          make_dist_fn, pad_ids_to_tile,
                                          register_backend, resolve_backend)
