from repro_torch.optim.adamw import AdamW, clip_by_global_norm
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.optim.grad_compression import (
    compressed_pod_mean, quantize_int8, dequantize_int8)
