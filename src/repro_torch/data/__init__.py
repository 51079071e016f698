from repro_torch.data.dirichlet import (  # noqa: F401
    dirichlet_partition, heterogeneity_score, label_distribution,
)
from repro_torch.data.pipeline import (  # noqa: F401
    FederatedData, LMFederatedData, federated_lm_corpora, gather_full_client_batch,
    gather_round_batches, lm_batch_iterator,
)
from repro_torch.data.population import (  # noqa: F401
    AVAILABILITY_PROCESSES, POPULATION_STORES, FaultyStore, HostPopulationStore,
    StreamingClientData, TransientStoreError, availability_log_weights, make_population_store,
)
from repro_torch.data.synthetic import (  # noqa: F401
    CHAIN_VOCAB, make_markov_transition, make_synthetic_classification, make_synthetic_images,
    make_synthetic_lm, source_frames,
)
