from splatloc_tpu_torch.match.hungarian import (hungarian_solve,
                                                auction_assignment)
from splatloc_tpu_torch.match.pnp import solve_pnp_ransac
from splatloc_tpu_torch.match.frustum import (frustum_key_points,
                                              backproject_mask,
                                              nearest_neighbor)
