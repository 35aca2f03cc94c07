from .loss_library import (as_rigid_as_possible_loss, chamfer_distance_loss,
                           hardest_contrastive_loss, orthogonal_loss, p2p_fitting_regularizer,
                           sigmoid_focal_loss, sigmoid_focal_loss_with_logits,
                           smooth_cross_entropy_loss, transformation_loss, weighted_bce_loss,
                           weighted_bce_loss_with_logits)

__all__ = [
    "as_rigid_as_possible_loss",
    "chamfer_distance_loss",
    "hardest_contrastive_loss",
    "orthogonal_loss",
    "p2p_fitting_regularizer",
    "sigmoid_focal_loss",
    "sigmoid_focal_loss_with_logits",
    "smooth_cross_entropy_loss",
    "transformation_loss",
    "weighted_bce_loss",
    "weighted_bce_loss_with_logits",
]
