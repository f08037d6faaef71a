from splatloc_tpu_torch.knn.knn import (mean_dist2_3nn, mean_dist2_3nn_approx,
                                        knn_exact, morton_codes)
