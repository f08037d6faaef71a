from splatloc_tpu_torch.utils.logging import Log
from splatloc_tpu_torch.utils.profiling import (Timer, trace, MetricsLogger,
                                                throughput_mpix_s)
