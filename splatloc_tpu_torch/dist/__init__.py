from splatloc_tpu_torch.dist.multihost import is_primary, primary_only
