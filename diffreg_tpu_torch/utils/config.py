"""Config system: reference-schema YAML -> the port's typed configs.

Counterpart of the JAX package's utils/config.py: the reference's YAML layout
(Diff-Reg-3dmatch/configs/test/3dmatch.yaml) with its ``!join`` tag
(main.py:17-21), mapped onto ``PipelineConfig`` (``variant`` from
``dataset``), ``LossConfig`` and ``OptimConfig``, field for field as the JAX
builder maps it, the model variants included (the KPConv modes, deformable
and modulated blocks, batch norm off, sinusoidal PE, entangled and
dual-softmax matching). A value that neither package knows raises
``ValueError``. ``kpfcn_config.fixed_kernel_points`` is read by neither
builder: both build the default "center" dispositions whatever it says (the
port warns), so that a YAML builds the same model in both; set
``KPFCNConfig.fixed_kernel_points`` to have "verticals".
"""
from __future__ import annotations

import warnings
from typing import Any, Dict

import yaml

# the values either package takes, per YAML key: (section, key) -> allowed values
_KNOWN = {
    ("kpfcn_config", "KP_influence"): ("linear", "constant", "gaussian"),
    ("kpfcn_config", "aggregation_mode"): ("sum", "closest"),
    ("kpfcn_config", "fixed_kernel_points"): ("center", "verticals", "none"),
    ("coarse_matching", "match_type"): ("sinkhorn", "dual_softmax"),
    ("coarse_transformer", "pe_type"): ("rotary", "sinusoidal"),
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


def check_known(raw: Dict[str, Any]) -> None:
    """Raise ValueError for a value that neither package knows. ``exact_topk``
    is accepted either way: the port's top-k is exact, as JAX's is off the
    TPU (diffreg_tpu/ops/topk.py)."""
    if raw.get("compute_dtype") not in (None, "float32", "bfloat16"):
        raise ValueError(f"compute_dtype={raw['compute_dtype']!r}: bfloat16, float32 or unset")
    if raw.get("precision") not in (None, "highest", "default"):
        raise ValueError(f"precision={raw['precision']!r}: 'highest' or 'default'")
    for (section, key), allowed in _KNOWN.items():
        value = raw.get(section, {}).get(key, allowed[0])
        if value not in allowed:
            raise ValueError(f"{section}.{key}={value!r}: one of {allowed}")
    fixed = raw.get("kpfcn_config", {}).get("fixed_kernel_points", "center")
    if fixed != "center":
        warnings.warn(f"kpfcn_config.fixed_kernel_points={fixed!r} is not read: the model "
                      "has the 'center' dispositions, as the JAX package's builder gives it")


def build_pipeline_config(raw: Dict[str, Any]):
    """Map the reference YAML schema onto the port's PipelineConfig."""
    from ..models.diffusion_matching import PipelineConfig
    from ..models.presets import KPFCN_ARCHITECTURE
    from ..nn.kpfcn import KPFCNConfig
    from ..nn.matching import MatchingConfig
    from ..nn.transformer import ProcrustesConfig, TransformerConfig

    check_known(raw)
    kp = raw.get("kpfcn_config", {})
    cm = raw.get("coarse_matching", {})
    ct = raw.get("coarse_transformer", {})
    pr = ct.get("procrustes", {})
    matching = MatchingConfig(
        feature_dim=int(cm.get("feature_dim", 432)),
        match_type=cm.get("match_type", "sinkhorn"),
        confidence_threshold=float(cm.get("confidence_threshold", 0.2)),
        dsmax_temperature=float(cm.get("dsmax_temperature", 0.1)),
        skh_init_bin_score=float(cm.get("skh_init_bin_score", 1.0)),
        skh_iters=int(cm.get("skh_iters", 3)),
        entangled=bool(cm.get("entangled", False)),
        precision=str(raw.get("precision") or "highest"),
    )
    # masked (real) lengths set the Procrustes budget: bucket padding must not widen it
    procrustes = ProcrustesConfig(
        sample_rate=float(pr.get("sample_rate", 1.0)),
        max_condition_num=float(pr.get("max_condition_num", 0.0)),
        use_masked_lengths=True,
    )
    compute_dtype = raw.get("compute_dtype")
    transformer = TransformerConfig(
        feature_dim=int(ct.get("feature_dim", 432)),
        n_head=int(ct.get("n_head", 4)),
        layer_types=tuple(ct.get("layer_types",
                                 ["self", "cross", "positioning", "self", "cross"])),
        positioning_type=ct.get("positioning_type", "procrustes"),
        pe_type=ct.get("pe_type", "rotary"),
        vol_origin=tuple(ct.get("vol_bnds", [[-3.6, -2.4, 1.14]])[0]),
        voxel_size=float(ct.get("voxel_size", 0.08)),
        entangled=bool(ct.get("entangled", False)),
        procrustes=procrustes,
        feature_matching=matching,
        compute_dtype=compute_dtype,
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
        kp_influence=kp.get("KP_influence", "linear"),
        aggregation_mode=kp.get("aggregation_mode", "sum"),
        use_batch_norm=bool(kp.get("use_batch_norm", True)),
        coarse_feature_dim=int(kp.get("coarse_feature_dim", 432)),
        fine_feature_dim=int(kp.get("fine_feature_dim", 264)),
        coarse_level=int(kp.get("coarse_level", -2)),
        compute_dtype=compute_dtype,
        # block names containing 'deform' make a block deformable; `modulated`
        # is read from kpfcn_config or the top level, as the JAX builder reads it
        modulated=bool(kp.get("modulated", raw.get("modulated", False))),
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


def build_optim_config(raw: Dict[str, Any], steps_per_epoch: int = 1000, world_size: int = 1):
    """The optimizer of the YAML. ``steps_per_epoch`` counts one process's
    steps; over ``world_size`` processes the learning rate is the YAML's times
    the world, unless ``scale_lr_by_world: false`` (the reference multiplies
    every param group's lr by the world size, vision3d/engine/
    base_trainer.py:205-210)."""
    from ..engine.train import OptimConfig

    lr = float(raw.get("lr", 0.015))
    if world_size > 1 and bool(raw.get("scale_lr_by_world", True)):
        lr *= world_size
    return OptimConfig(
        optimizer=str(raw.get("optimizer", "SGD")).lower(),
        lr=lr,
        momentum=float(raw.get("momentum", 0.93)),
        weight_decay=float(raw.get("weight_decay", 1e-6)),
        scheduler_gamma=float(raw.get("scheduler_gamma", 0.95)),
        steps_per_epoch=steps_per_epoch,
        grad_accum_steps=int(raw.get("iter_size", 1)),
    )
