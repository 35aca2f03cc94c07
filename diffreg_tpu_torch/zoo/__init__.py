"""vision3d model zoo: the port's counterpart of the JAX package's zoo.

The same public names as the JAX package's zoo/__init__.py: geotransformer,
cofinet, d3feat, fcgf, predator, pointnet(2), point_transformer, pat, urr,
pri3d, foldingnet, the siamese transformer and the generic KPConv-FPN
backbone. Importing it builds nothing; the modules run on the device of
their tensors (the KPConv-FPN's KPConv and the transformers' plain attention
through the Hopper kernels on CUDA tensors).
"""
from .geotransformer import (GeometricStructureEmbedding, GeometricStructureEmbeddingV2,
                             GeometricTransformer, LGRConfig, PointMatchingConfig,
                             VanillaSiameseTransformer, adaptive_superpoint_matching,
                             deduplicate_correspondences, local_global_registration,
                             point_matching, sinusoidal_embedding,
                             superpoint_matching_global_topk, superpoint_matching_mutual_topk)
from .kpconv_fpn import KPConvFPN, KPConvFPNConfig
from .layers_library import (BasicConvResBlock, EdgeConv, FeaturePropagate, GSAConv, PNConv,
                             SAConv, VNBatchNorm, VNLeakyReLU, VNLinear, VNLinearLeakyReLU,
                             VNMaxPool, VNStdFeature, XConv)
from .matching_models import (AttentionalPropagation, D3FeatLossConfig, PredatorGCN,
                              PredatorLossConfig, PredatorSelfAttention, cofinet_node_matching,
                              cofinet_node_proposals, compute_detection_scores, d3feat_loss,
                              differentiable_render, fcgf_hardest_contrastive_loss,
                              predator_loss, randomized_weighted_procrustes,
                              urr_extract_correspondences)
from .pointnets import (AbsoluteRelativePositionEmbedding, AttentionSubsetSampling, FoldingNet,
                        GlobalAbstractionModule, GroupShuffleAttention, GumbelSubsetSampling,
                        MultiScaleSetAbstractionModule, PointTransformerBlock,
                        PointTransformerLayer, SetAbstractionModule, TNet, TransitionDownBlock,
                        batched_ball_query, batched_fps, batched_knn, group_gather,
                        pointnet_loss, tnet_loss)
from .pri3d import (BasicBlock, Bottleneck, ResNetEncoder, ResUNet, ResUNetDecoder,
                    ResUNetDecoderMultiRes, UpProjection, create_resnet10, create_resnet18,
                    create_resnet34, create_resnet50, create_resnet101)

__all__ = [n for n in dir() if not n.startswith("_")]
