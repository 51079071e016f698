from repro_torch.data.dirichlet import dirichlet_partition  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    FederatedData, gather_full_client_batch, gather_round_batches,
)
from repro_torch.data.population import (  # noqa: F401
    AVAILABILITY_PROCESSES, POPULATION_STORES, FaultyStore, HostPopulationStore,
    StreamingClientData, TransientStoreError, availability_log_weights, make_population_store,
)
from repro_torch.data.synthetic import make_synthetic_classification, make_synthetic_lm  # noqa: F401
