"""The port's models (``repro.models``): the dense, moe and vlm families
through ``CausalLM`` (``transformer.py``, with ``attention.py``,
``mlp.py``, ``moe.py``, ``moe_a2a.py`` and ``common.py``); the encdec, ssm
and hybrid families are not ported yet (``registry.py``)."""
from repro_torch.models.registry import build_model  # noqa: F401
