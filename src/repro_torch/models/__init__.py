from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (layer_groups, paged_fused_step,
                                            sharded_fused_step)
