"""Runtime support (port of ``repro.runtime``).  ``elastic.py``
(re-sharding a restored state onto another mesh) waits for a mesh over
several cards: ROADMAP.md §1 item 8."""
from repro_torch.runtime.failures import (FailureInjector,
                                          SimulatedWorkerFailure)
