from repro_torch.optim.adamw import (adafactor_init, adafactor_update,
                                     adamw_init, adamw_update,
                                     apply_updates, make_optimizer)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.grad import (clip_by_global_norm, global_norm,
                                    int8_compress, int8_decompress)
