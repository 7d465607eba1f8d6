from repro_torch.optim.optimizer import (  # noqa: F401
    adamw, adamw8, cosine_schedule, global_norm, make_optimizer, sgdm,
)
from repro_torch.optim.compression import (  # noqa: F401
    block_dequantize, block_quantize, compressed_psum,
)
