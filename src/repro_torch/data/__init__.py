from repro_torch.data.dirichlet import dirichlet_partition  # noqa: F401
from repro_torch.data.pipeline import FederatedData, gather_round_batches  # noqa: F401
from repro_torch.data.synthetic import make_synthetic_classification, make_synthetic_lm  # noqa: F401
