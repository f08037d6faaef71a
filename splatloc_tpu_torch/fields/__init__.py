from splatloc_tpu_torch.fields.hashgrid import (HashGridConfig, init_hashgrid,
                                               encode)
from splatloc_tpu_torch.fields.decoder import (FeatureFieldConfig,
                                               init_decoder, decode,
                                               cosine_loss)
