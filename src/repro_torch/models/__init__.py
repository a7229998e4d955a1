"""The port's models (``repro.models``): the dense, moe and vlm families
through ``CausalLM`` (``transformer.py``, with ``attention.py``,
``mlp.py``, ``moe.py``, ``moe_a2a.py`` and ``common.py``), the ssm family
through ``MambaLM`` (``mamba_lm.py``) and the hybrid family through
``Zamba2Model`` (``zamba2.py``), both on ``ssm.py``, and the encdec family
through ``WhisperModel`` (``whisper.py``)."""
from repro_torch.models.registry import build_model  # noqa: F401
