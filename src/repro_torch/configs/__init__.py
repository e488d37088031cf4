from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    get_tiny_config,
    list_architectures,
)
