from repro_torch.data.dirichlet import dirichlet_partition  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    FederatedData, gather_full_client_batch, gather_round_batches,
)
from repro_torch.data.synthetic import make_synthetic_classification, make_synthetic_lm  # noqa: F401
