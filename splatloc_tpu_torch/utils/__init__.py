from splatloc_tpu_torch.utils.logging import Log
from splatloc_tpu_torch.utils.profiling import trace, MetricsLogger
