"""The cases of ``tests/torch_moe_ref.py`` (its mesh, token shapes, FFN
configs and LM), for the tests that hold the port to its npz.  This
module imports no JAX: importing the reference module in a process would
set its 8-host-device ``XLA_FLAGS`` there."""

MESH = ((2, 4), ("data", "model"))
X_SHAPE = (4, 32, 32)                   # 128 tokens, 16 a position (a2a)
# (case name, experts, capacity factor)
FFN_CASES = [(f"{path}_cf{cf:g}", e, cf)
             for path, e in (("a2a", 8), ("tp", 2)) for cf in (8.0, 1.0)]
# ModelConfig fields of every FFN case besides its MoEConfig
FFN_FIELDS = dict(name="t", num_layers=1, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=16, vocab_size=64, dtype="float32")
TOP_K = 2
LM_ARCH = "qwen3-moe-30b-a3b"
LM_TOKENS = (2, 16)
