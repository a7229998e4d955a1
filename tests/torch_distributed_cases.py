"""The cases of ``tests/torch_distributed_ref.py`` (its sizes, search
configs, meshes and partition), for the tests that hold the port to its
npz.  This module imports no JAX: importing the reference module in a
test process would set its 8-host-device ``XLA_FLAGS`` there."""

N, D, B = 400, 16, 8
WALKER_CFG = dict(k=10, queue_len=24, m_max=4, max_steps=48, local_steps=3,
                  global_rounds=6, hash_bits=10)
# (case name, mesh shape, axis names, visited mode)
WALKER_CASES = [(f"walker_{'x'.join(map(str, shape))}_{mode}", shape,
                 ("data", "model"), mode)
                for shape in ((1, 4), (2, 4))
                for mode in ("bitmap", "hash", "loose")]
WALKER_CASES.append(("walker_2x2x2_bitmap", (2, 2, 2),
                     ("pod", "data", "model"), "bitmap"))
CORPUS_CFG = dict(k=10, queue_len=24, m_max=1, staged=False, max_steps=64)
CORPUS_CASES = [("corpus_1x4", (1, 4)), ("corpus_2x4", (2, 4))]
PARTITION = dict(num_shards=4, degree=8, ef_construction=16, passes=1)
SPEC_ARCH = "llama3.2-3b"
SPEC_MESHES = ((2, 2), (4, 1), (1, 4))
