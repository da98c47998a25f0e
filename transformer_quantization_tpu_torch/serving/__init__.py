from transformer_quantization_tpu_torch.serving.engine import (  # noqa: F401
    Metrics,
    QueueFullError,
    ServeConfig,
    ServingEngine,
    unpack_batch,
)
from transformer_quantization_tpu_torch.serving.graphs import (  # noqa: F401
    BucketGraphs,
)
