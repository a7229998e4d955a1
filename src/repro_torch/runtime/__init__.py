"""Runtime support (port of ``repro.runtime``): failure injection and
elastic re-sharding onto another mesh."""
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime.failures import (FailureInjector,
                                          SimulatedWorkerFailure)
