from repro_torch.data.vectors import make_vector_dataset, VectorDataset  # noqa: F401
from repro_torch.data.tokens import TokenStream, synthetic_batches  # noqa: F401
