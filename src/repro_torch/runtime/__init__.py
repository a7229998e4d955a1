"""Runtime support (port of ``repro.runtime``).  ``elastic.py``
(re-sharding a restored state onto another mesh) waits for the port of
``sharding.py``: ROADMAP.md §1 item 6."""
from repro_torch.runtime.failures import (FailureInjector,
                                          SimulatedWorkerFailure)
