from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    FedConfig,
    ModelConfig,
    get_config,
    reduced,
)
