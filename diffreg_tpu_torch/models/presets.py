"""Task presets mirroring the reference config YAMLs (configs/test/3dmatch.yaml,
configs/train/3dmatch.yaml, configs/test/4dmatch.yaml)."""
from __future__ import annotations

import dataclasses

from ..nn.kpfcn import KPFCNConfig
from ..nn.matching import MatchingConfig
from ..nn.transformer import ProcrustesConfig, TransformerConfig
from .diffusion_matching import PipelineConfig

KPFCN_ARCHITECTURE = (
    "simple",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
)


def preset_3dmatch(sample_steps: int = 20, feature_dim: int = 432,
                   first_feats_dim: int = 256, train: bool = False) -> PipelineConfig:
    """3DMatch/3DLoMatch rigid registration. The test config has condition gate
    0 (identity warp); ``train=True`` sets gate 200, as the reference train
    config does, in the pipeline and in the coarse transformer's procrustes
    positioning layer. Masked (real) lengths set the Procrustes budget."""
    matching = MatchingConfig(feature_dim=feature_dim, confidence_threshold=0.2,
                              skh_init_bin_score=1.0, skh_iters=3)
    procrustes = ProcrustesConfig(sample_rate=1.0, max_condition_num=200.0 if train else 0.0,
                                  use_masked_lengths=True)
    transformer = TransformerConfig(
        feature_dim=feature_dim,
        n_head=4,
        layer_types=("self", "cross", "positioning", "self", "cross"),
        positioning_type="procrustes",
        vol_origin=(-3.6, -2.4, 1.14),
        voxel_size=0.08,
        procrustes=procrustes,
        feature_matching=matching,
    )
    kpfcn = KPFCNConfig(
        architecture=KPFCN_ARCHITECTURE,
        first_feats_dim=first_feats_dim,
        in_feats_dim=1,
        first_subsampling_dl=0.025,
        conv_radius=2.5,
        kp_extent=2.0,
        coarse_feature_dim=feature_dim,
        fine_feature_dim=264,
        coarse_level=-2,
    )
    return PipelineConfig(
        kpfcn=kpfcn,
        coarse_transformer=transformer,
        coarse_matching=matching,
        procrustes=procrustes,
        sample_steps=sample_steps,
    )


def preset_4dmatch(sample_steps: int = 20, thr: float = 0.55) -> PipelineConfig:
    """4DMatch/4DLoMatch deformable registration (configs/test/4dmatch.yaml):
    coarse feature dim 528 (4 heads of 132), first_subsampling_dl 0.01, VolPE
    voxel 0.04, condition gate 40 in training and test (the warp is live in
    inference), Gaussian+sigmoid training noise, the stochastic DDIM update
    and the sigmoid prediction head. ``thr`` is the tester's match threshold
    (``engine.tester.TestConfig.match_thr``), kept for the JAX signature."""
    base = preset_3dmatch(sample_steps=sample_steps, feature_dim=528)
    procrustes = dataclasses.replace(base.procrustes, max_condition_num=40.0)
    transformer = dataclasses.replace(base.coarse_transformer, procrustes=procrustes,
                                      voxel_size=0.04)
    kpfcn = dataclasses.replace(base.kpfcn, first_subsampling_dl=0.01)
    return dataclasses.replace(base, kpfcn=kpfcn, coarse_transformer=transformer,
                               procrustes=procrustes, variant="4dmatch")


def preset_tiny(variant: str = "3dmatch", sample_steps: int = 2) -> PipelineConfig:
    """Small config for tests: same topology, tiny dims. ``preset_tiny(n)``
    (an int first) is ``preset_tiny("3dmatch", n)``."""
    if isinstance(variant, int):
        variant, sample_steps = "3dmatch", variant
    base = preset_3dmatch(sample_steps=sample_steps) if variant == "3dmatch" \
        else preset_4dmatch(sample_steps=sample_steps)
    matching = dataclasses.replace(base.coarse_matching, feature_dim=48)
    transformer = dataclasses.replace(base.coarse_transformer, feature_dim=48, n_head=2,
                                      feature_matching=matching)
    kpfcn = dataclasses.replace(base.kpfcn, first_feats_dim=16, coarse_feature_dim=48,
                                fine_feature_dim=16, first_subsampling_dl=0.06)
    return dataclasses.replace(base, kpfcn=kpfcn, coarse_transformer=transformer,
                               coarse_matching=matching)


def with_condition_gate(cfg: PipelineConfig, max_condition_num: float) -> PipelineConfig:
    """``cfg`` with the Procrustes condition gate set in the pipeline and in the
    coarse transformer's positioning layer (40 is the warp-active DDIM variant:
    every DDIM step then runs Sinkhorn, Procrustes and the warp; 200 is the
    training config's)."""
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=max_condition_num)
    return dataclasses.replace(cfg, procrustes=proc, coarse_transformer=dataclasses.replace(
        cfg.coarse_transformer, procrustes=proc))
