"""Config system: reference-schema YAML -> the port's typed configs.

Counterpart of the JAX package's utils/config.py: the reference's YAML layout
(Diff-Reg-3dmatch/configs/test/3dmatch.yaml) with its ``!join`` tag
(main.py:17-21), mapped onto ``PipelineConfig`` (``variant`` from
``dataset``), ``LossConfig`` and ``OptimConfig``. A config that asks for what
the port does not have raises ``NotImplementedError`` naming the ROADMAP item
that brings it, instead of running another model than the one asked for.
"""
from __future__ import annotations

from typing import Any, Dict

import yaml

# what the port runs, per YAML key: (section or None, key) -> allowed values
_PORTED = {
    ("kpfcn_config", "KP_influence"): ("linear",),
    ("kpfcn_config", "aggregation_mode"): ("sum",),
    ("kpfcn_config", "use_batch_norm"): (True,),
    ("kpfcn_config", "fixed_kernel_points"): ("center",),
    ("coarse_matching", "match_type"): ("sinkhorn",),
    ("coarse_matching", "entangled"): (False,),
    ("coarse_transformer", "pe_type"): ("rotary",),
    ("coarse_transformer", "entangled"): (False,),
}


def _join_tag(loader, node):
    return "_".join(str(i) for i in loader.construct_sequence(node))


def load_yaml(path: str) -> Dict[str, Any]:
    """Read a reference-schema YAML (``!join`` registered on a private loader)."""
    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_constructor("!join", _join_tag)
    with open(path) as f:
        return yaml.load(f, Loader=_Loader)


def check_ported(raw: Dict[str, Any]) -> None:
    """Raise NotImplementedError for a setting the port does not have."""
    if raw.get("compute_dtype") not in (None, "float32"):
        raise NotImplementedError(
            f"compute_dtype={raw['compute_dtype']!r}: the bf16 compute path is not ported "
            "(ROADMAP §1: the bf16 compute path)")
    if raw.get("precision") not in (None, "highest"):
        raise NotImplementedError(
            f"precision={raw['precision']!r}: reduced-precision matmuls belong to the bf16 "
            "path, not ported (ROADMAP §1); the port computes in float32")
    if raw.get("exact_topk") is False:
        raise NotImplementedError("exact_topk: False: the port's top-k is exact only")
    kp = raw.get("kpfcn_config", {})
    architecture = raw.get("architecture", ())
    if kp.get("modulated", raw.get("modulated", False)) or any("deform" in b for b in architecture):
        raise NotImplementedError(
            "deformable KPConv blocks (modulated / 'deform' in architecture) are not ported "
            "(ROADMAP §1: the library surface, kpconv_deformable)")
    for (section, key), allowed in _PORTED.items():
        value = raw.get(section, {}).get(key, allowed[0])
        if value not in allowed:
            raise NotImplementedError(f"{section}.{key}={value!r} is not ported "
                                      f"(the port has {allowed[0]!r} only)")


def build_pipeline_config(raw: Dict[str, Any]):
    """Map the reference YAML schema onto the port's PipelineConfig."""
    from ..models.diffusion_matching import PipelineConfig
    from ..models.presets import KPFCN_ARCHITECTURE
    from ..nn.kpfcn import KPFCNConfig
    from ..nn.matching import MatchingConfig
    from ..nn.transformer import ProcrustesConfig, TransformerConfig

    check_ported(raw)
    kp = raw.get("kpfcn_config", {})
    cm = raw.get("coarse_matching", {})
    ct = raw.get("coarse_transformer", {})
    pr = ct.get("procrustes", {})
    matching = MatchingConfig(
        feature_dim=int(cm.get("feature_dim", 432)),
        confidence_threshold=float(cm.get("confidence_threshold", 0.2)),
        skh_init_bin_score=float(cm.get("skh_init_bin_score", 1.0)),
        skh_iters=int(cm.get("skh_iters", 3)),
    )
    # masked (real) lengths set the Procrustes budget: bucket padding must not widen it
    procrustes = ProcrustesConfig(
        sample_rate=float(pr.get("sample_rate", 1.0)),
        max_condition_num=float(pr.get("max_condition_num", 0.0)),
        use_masked_lengths=True,
    )
    transformer = TransformerConfig(
        feature_dim=int(ct.get("feature_dim", 432)),
        n_head=int(ct.get("n_head", 4)),
        layer_types=tuple(ct.get("layer_types",
                                 ["self", "cross", "positioning", "self", "cross"])),
        positioning_type=ct.get("positioning_type", "procrustes"),
        vol_origin=tuple(ct.get("vol_bnds", [[-3.6, -2.4, 1.14]])[0]),
        voxel_size=float(ct.get("voxel_size", 0.08)),
        procrustes=procrustes,
        feature_matching=matching,
    )
    kpfcn = KPFCNConfig(
        architecture=tuple(raw.get("architecture", KPFCN_ARCHITECTURE)),
        num_kernel_points=int(kp.get("num_kernel_points", 15)),
        in_points_dim=int(kp.get("in_points_dim", 3)),
        first_feats_dim=int(kp.get("first_feats_dim", 256)),
        in_feats_dim=int(kp.get("in_feats_dim", 1)),
        first_subsampling_dl=float(kp.get("first_subsampling_dl", 0.025)),
        conv_radius=float(kp.get("conv_radius", 2.5)),
        kp_extent=float(kp.get("KP_extent", 2.0)),
        coarse_feature_dim=int(kp.get("coarse_feature_dim", 432)),
        fine_feature_dim=int(kp.get("fine_feature_dim", 264)),
        coarse_level=int(kp.get("coarse_level", -2)),
    )
    return PipelineConfig(
        kpfcn=kpfcn,
        coarse_transformer=transformer,
        coarse_matching=matching,
        procrustes=procrustes,
        sample_steps=int(raw.get("SAMPLE_STEP", 20)),
        variant=str(raw.get("dataset", "3dmatch")),
    )


def build_loss_config(raw: Dict[str, Any]):
    from ..engine.losses import LossConfig

    tl = raw.get("train_loss", {})
    return LossConfig(
        focal_alpha=float(tl.get("focal_alpha", 0.25)),
        focal_gamma=float(tl.get("focal_gamma", 2.0)),
        pos_weight=float(tl.get("pos_weight", 1.0)),
        neg_weight=float(tl.get("neg_weight", 1.0)),
        motion_weight=float(tl.get("motion_weight", 0.0)),
        match_weight=float(tl.get("match_weight", 1.0)),
        match_type=tl.get("match_type", "sinkhorn"),
        dataset=str(raw.get("dataset", "3dmatch")),
    )


def build_optim_config(raw: Dict[str, Any], steps_per_epoch: int = 1000):
    """The optimizer of the YAML (one process: no world-size learning-rate
    scaling until data parallel is ported, ROADMAP §1)."""
    from ..engine.train import OptimConfig

    return OptimConfig(
        optimizer=str(raw.get("optimizer", "SGD")).lower(),
        lr=float(raw.get("lr", 0.015)),
        momentum=float(raw.get("momentum", 0.93)),
        weight_decay=float(raw.get("weight_decay", 1e-6)),
        scheduler_gamma=float(raw.get("scheduler_gamma", 0.95)),
        steps_per_epoch=steps_per_epoch,
        grad_accum_steps=int(raw.get("iter_size", 1)),
    )
