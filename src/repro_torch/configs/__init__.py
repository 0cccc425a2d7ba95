from repro_torch.configs.base import (ACT_GEGLU, ACT_GELU, ACT_RELU2,
                                      ACT_SWIGLU, ATTN_BIDIR, ATTN_FULL,
                                      ATTN_SLIDING, FLConfig, FrontendConfig,
                                      LoRAConfig, ModelConfig, SSMConfig,
                                      get_config, register)

__all__ = ["ACT_GEGLU", "ACT_GELU", "ACT_RELU2", "ACT_SWIGLU", "ATTN_BIDIR",
           "ATTN_FULL", "ATTN_SLIDING", "FLConfig", "FrontendConfig",
           "LoRAConfig", "ModelConfig", "SSMConfig", "get_config",
           "register"]
