from splatloc_tpu_torch.dist.shard import (make_mesh, scene_sharding,
                                           frames_sharding, shard_scene,
                                           make_sharded_mapping_step)
from splatloc_tpu_torch.dist.sharded_raster import rasterize_sharded
from splatloc_tpu_torch.dist.multihost import (initialize, is_primary,
                                               primary_only, global_mesh)
