# The port's serving stack (port of repro.serve): the LM engine, the
# bucketed ANN engine (on one device, or over ranks with rank 0 the
# controller), the async coalescer with its cache and admission control,
# the replica router, and kNN-LM retrieval.
from repro_torch.serve.engine import ServeEngine  # noqa: F401
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
from repro_torch.serve.knnlm import KNNLMDatastore, knnlm_logits  # noqa: F401
from repro_torch.obs import Observability, NULL_OBS  # noqa: F401
