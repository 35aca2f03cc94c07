"""Device ops: the port's counterparts of the JAX package's ops.

The names are those the JAX package's ops/__init__.py exports, wherever the
port has them, but for ``kpconv``: here it names the module (its function is
``ops.kpconv.kpconv``), which the port's code and tests address by that path.
Importing this package builds nothing: the CUDA kernels and the host library
are built at their first call.
"""
from .masked import NEG_INF, mask_matrix, masked_instance_norm, masked_mean, masked_var
from .sinkhorn import dual_softmax_conf_matrix, log_sinkhorn, sinkhorn_conf_matrix
from .position_encoding import embed_pos, embed_rotary, volumetric_pe
from .select import (Correspondences, extract_correspondences, mutual_topk_correspondences,
                     mutual_topk_mask, superpoint_proposals, thresholded_mutual_argmax_mask)
from .subsample import grid_subsample, grid_subsample_np, grid_subsample_with_features_np
from .partition import index_select, knn_interpolate
from .neighbors import knn, knn_np, radius_neighbors, radius_neighbors_np
from .kpconv import closest_pool, max_pool
from .kernel_points import load_kernel_points, unit_kernel_points
from .consistency import cross_spatial_consistency, leading_eigenvector, spatial_consistency
from .features import (build_local_reference_frame, deg2rad, estimate_normals, global_ppf,
                       local_ppf, rad2deg, safe_divide, safe_sqrt, vector_angle)
from .render import sample_pdf, volume_render
from .conversion import batch_to_pack, pack_to_batch
from .sampling import farthest_point_sampling, random_choice
