from repro_torch.configs.spikingformer import (  # noqa: F401
    SPIKINGFORMER_PRESETS, get_spikingformer_config,
    list_spikingformer_configs)
