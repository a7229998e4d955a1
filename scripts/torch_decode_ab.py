"""Decode-step timing of one ``repro_torch`` tree on the card.

    python3 scripts/torch_decode_ab.py SRC_DIR

qwen2.5-3b at full depth (random weights), 8 random prompts of 512
tokens, a prefill then 32 greedy decode steps, twice; prints one JSON
line: the second pass's p50 ms a step, and one profiled step's kernel
launches and device-busy ms.  ``SRC_DIR`` holds the ``repro_torch``
package to time (``src``, or an older commit's ``src`` unpacked with
``git archive``; a tree whose ``decode_step`` has no ``inplace`` writes
in place already).  To compare two trees, run them in turns on one card,
one after another: old, new, new, old.
"""
import inspect
import json
import sys
import time

import numpy as np


def main(src: str) -> None:
    sys.path.insert(0, src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(1))
    kw = ({"inplace": True} if "inplace" in
          inspect.signature(model.decode_step).parameters else {})
    ms = []
    with torch.inference_mode():
        for _ in range(2):
            logits, state = model.prefill(params, prompts, 512 + 40)
            tok = logits[:, -1].argmax(-1)[:, None]
            for _ in range(32):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, state = model.decode_step(params, state, tok, **kw)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                tok = logits[:, -1].argmax(-1)[:, None]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, state, tok, **kw)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kernels)
    print(json.dumps({"src": src, "decode_p50_ms": float(np.median(ms[32:])),
                      "launches": sum(e.count for e in kernels),
                      "busy_ms": busy / 1e3,
                      "decode_ms_second_pass": [round(x, 2)
                                                for x in ms[32:]]}))


if __name__ == "__main__":
    main(sys.argv[1])
