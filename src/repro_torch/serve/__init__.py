# The port's serving stack (port of repro.serve, single-device): the
# bucketed engine, the async coalescer with its cache and admission
# control, and the replica router.  ServeEngine and the kNN-LM pair wait
# for ROADMAP.md §1 item 6.
from repro_torch.serve.ann_engine import AnnEngine, ServeResult  # noqa: F401
from repro_torch.serve.coalescer import AsyncAnnEngine  # noqa: F401
from repro_torch.serve.coalescer import AsyncServeResult  # noqa: F401
from repro_torch.serve.coalescer import CoalescePolicy  # noqa: F401
from repro_torch.serve.coalescer import DeadlineExceeded  # noqa: F401
from repro_torch.serve.cache import CachePolicy, ResultCache  # noqa: F401
from repro_torch.serve.admission import AdmissionController  # noqa: F401
from repro_torch.serve.admission import AdmissionPolicy  # noqa: F401
from repro_torch.serve.admission import AdmissionRejected  # noqa: F401
from repro_torch.serve.admission import PRIORITIES  # noqa: F401
from repro_torch.serve.router import ReplicaRouter, RouterPolicy  # noqa: F401
from repro_torch.serve.router import RouterResult  # noqa: F401
from repro_torch.obs import Observability, NULL_OBS  # noqa: F401
