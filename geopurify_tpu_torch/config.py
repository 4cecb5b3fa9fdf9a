"""Typed configuration system — the port's own copy of geopurify_tpu/config.py.

The dataclass tree, the defaults and ``load_config`` are identical to the JAX
package's (geopurify_tpu/config.py:31-440), so a preset gives the same tree in
both packages (tests/test_torch_port_ops.py). The copy keeps the port free of
any import of the JAX package.

Presets live in ``geopurify_tpu_torch/configs/*.yaml`` (copies of the JAX
package's ``scannet`` and ``tiny``). CLI overrides use dotted keys
(``data.voxel_size=0.04``) with literal-eval coercion.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml


def _tuple_field(*xs):
    return field(default_factory=lambda: tuple(xs))


@dataclass
class DataConfig:
    """Dataset + label-space settings (ref: config/geopurify_scannet.yaml DATA)."""

    dataset: str = "scannet"              # scannet | scannet200 | matterport
    data_root: str = "data/scannet_3d"
    data_root_2d: str = "data/scannet_2d"
    # Open-vocabulary class universe used at eval.
    all_label: Tuple[str, ...] = ()
    # Contiguous ids of base / novel / ignored classes within all_label.
    base_category: Tuple[int, ...] = ()
    novel_category: Tuple[int, ...] = ()
    ignore_category: Tuple[int, ...] = ()
    # Structural classes excluded from the foreground (f-mIoU/f-mAcc) group —
    # the metric the reference reports for ScanNet200
    # (reference README.md:115-117: "excluding wall/floor/ceiling").
    foreground_exclude: Tuple[str, ...] = ("wall", "floor", "ceiling")
    test_ignore_label: Tuple[int, ...] = ()
    # 2D-label remap: NYU40-style raw ids -> contiguous train ids.
    label_2d: Tuple[int, ...] = ()
    ignore_label: int = 255
    test_classes: int = 19
    voxel_size: float = 0.02
    loop: int = 16                        # epoch multiplier over the 20-scene subset
    val_keep: int = 10_000_000
    train_scene_list: str = "scannet_train.txt"
    eval_scene_list: str = "scannet_evaluation.txt"
    # Static-shape padding buckets (TPU: shapes must be compile-time constants).
    max_points: int = 2 ** 20             # per-scene point budget
    max_voxels: int = 2 ** 18             # per-scene voxel budget
    max_views: int = 64                   # views per scene batch (train cap)
    # eval evaluates EVERY usable view (power-of-two bucket growth above
    # max_views); this is the hard ceiling before linspace subsampling + a
    # warning kicks in (reference evaluates all views; see loaders.py)
    max_views_eval: int = 256
    max_view_points: int = 2 ** 16        # visible points per view
    max_masks: int = 201                  # X-Decoder query count upper bound

    def foreground_category(self) -> Tuple[int, ...]:
        """Contiguous ids of the foreground (non-structural) classes.

        Exact-name exclusion of ``foreground_exclude`` from ``all_label``
        (compound names like 'shower wall' stay foreground, matching the
        reference's published f-mIoU convention, README.md:115-117).
        """
        excl = set(self.foreground_exclude)
        return tuple(
            i for i, name in enumerate(self.all_label[: self.test_classes])
            if name not in excl
        )


@dataclass
class FusionConfig:
    """Multi-view 2D->3D projection settings (ref: config/fusion_scannet.yaml)."""

    img_dim: Tuple[int, int] = _tuple_field(648, 484)   # (W, H)
    depth_scale: float = 1000.0
    visibility_threshold: float = 0.05
    cut_boundary: int = 10
    frame_stride: int = 20                # every-20th-frame rule (scannet_loader.py:34)
    resolution_scale: float = 2.0
    min_visible_points: int = 400
    max_visible_points: int = 65000


@dataclass
class StudentConfig:
    """Sparse-conv affinity student (ref: models/affinity_module.py:51-85)."""

    input_dim: int = 518                  # 512 semantic + 6 geometric (rgb+normal)
    hidden_dim: int = 512
    embed_dim: int = 128
    num_res_blocks: int = 4
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # "bfloat16" runs inference conv compute in bf16 (params/BN stay f32);
    # embedding-vs-f32 error bound pinned in tests/test_sparse_conv.py
    compute_dtype: str = "float32"
    # Stage-2 eval: voxel count at/above which the student's 3^3 convs run
    # z-stacked (ops/sparse_conv.ZStackTable; the same convolution)
    zstack_min_voxels: int = 131072


@dataclass
class PoolingConfig:
    """Geometry-guided pooling (ref: models/affinity_module.py:1490-1608)."""

    knn_k: int = 96
    sharpen: float = 20.0
    num_iterations: int = 19              # 1 + 18 sparse-mm smoothing steps
    feature_dim: int = 512                # semantic dims kept after pooling
    spmm_mode: str = "banded"             # banded (MXU) | gather (fixed-degree)
    # banded-operator window width (rows, Hilbert order); the COO residual
    # carries the out-of-window edges exactly
    band: int = 12288
    # COO residual capacity for out-of-band edges; overflow falls back to
    # the exact gather path
    max_residual: int = 262144
    # Residual segment_sum chunk size of the JAX package (0 = one call);
    # the port applies the residual in one call
    res_chunk: int = 262144
    # kNN strategy: 'grid' (ops/knn.knn_self_grid: Hilbert tiles, box
    # pruning, certificate + exact recompute) or 'full' (brute force); the
    # same neighbours
    knn_mode: str = "grid"
    knn_radius: int = 12                  # certificate radius (voxel units)
    knn_candidates: int = 4096            # per-tile candidate budget
    # Space the 19 smoothing rounds run in. The rounds are LINEAR in the
    # features (F <- A @ F) and classification is argmax(scale *
    # normalize(f) @ T^t) — per-row normalization cannot change the argmax,
    # so smoothing the projected class logits S^19(F @ T) = (S^19 F) @ T is
    # ARGMAX-EXACT while cutting the smoothed channel dim from 512 to
    # n_classes (ref applies sparse.mm to 512-d feats then classifies,
    # affinity_module.py:1569-1589 — identical predictions by linearity).
    # 'logit' (default): smooth [M, n_cls] projections; returned per-point
    #   logits are scale * (S^19 F) @ T (unnormalized — same argmax, different
    #   magnitudes), and `scene_features` is the PRE-smoothing fused surface.
    # 'feature': reference-shaped path — smooth 512-d features, normalize,
    #   then project; use when smoothed per-point features must be exported.
    smooth_space: str = "logit"


@dataclass
class ContrastiveConfig:
    """Stage-1 sampling + InfoNCE (ref: models/affinity_module.py:277-279,1065-1136)."""

    num_anchors: int = 4096
    num_negatives: int = 63
    num_macro_negatives: int = 48         # global least-similar
    num_micro_negatives: int = 15         # hardest among spatial kNN
    spatial_knn_k: int = 96
    # anchors' spatial kNN: 'grid' = Hilbert-tiled bbox pruning with the
    # certificate + full-row fallback (ops/knn.knn_anchors_grid — the brute
    # force's neighbours, ties included); 'brute' = full-db knn_search
    spatial_method: str = "grid"
    # grid certificate radius in coord units (meters for ScanNet scenes);
    # ANY value is exact — too small only routes queries into the fallback
    spatial_radius: float = 0.3
    temperature: float = 0.07
    # fused InfoNCE kernel K2 (csrc/infonce.cu on the card), opt-in
    fused_loss: bool = False


@dataclass
class TextConfig:
    """CLIP-style language encoder (ref: xdecoder_focall_lang.yaml MODEL.TEXT)."""

    width: int = 512
    heads: int = 8
    layers: int = 12
    context_length: int = 77
    vocab_size: int = 49408
    dim_proj: int = 512
    prompt_template: str = "a {} in a scene"
    prompt_eng: bool = True               # average over ~80 imagenet-style templates
    tokenizer_vocab: Optional[str] = None  # path to BPE vocab; stub tokenizer if None


@dataclass
class FocalNetConfig:
    """FocalNet-L backbone (ref: xdecoder_focall_lang.yaml MODEL.BACKBONE.FOCAL)."""

    patch_size: int = 4
    embed_dim: int = 192
    depths: Tuple[int, ...] = _tuple_field(2, 2, 18, 2)
    focal_levels: Tuple[int, ...] = _tuple_field(4, 4, 4, 4)
    focal_windows: Tuple[int, ...] = _tuple_field(3, 3, 3, 3)
    mlp_ratio: float = 4.0
    use_conv_embed: bool = True
    scaling_modulator: bool = True
    use_postln: bool = True
    use_postln_in_modulation: bool = False
    use_layerscale: bool = True
    # polynomial-erf GELU (models/layers.gelu_poly) on the bf16 compute
    # path only; f32 always uses the exact erf
    fast_gelu: bool = True
    out_indices: Tuple[int, ...] = _tuple_field(0, 1, 2, 3)
    # "focal" (xdecoder_focall) or "focal_dw" (the SEEM-release FocalNet:
    # vision/backbone/focal_dw.py — dw residual convs, stem pad 3, optional
    # pre-norm downsample embeds)
    variant: str = "focal"
    use_pre_norms: Tuple[bool, ...] = _tuple_field(False, False, False, False)


@dataclass
class XDecoderConfig:
    """2D VLM teacher (ref: xdecoder_focall_lang.yaml MODEL.{ENCODER,DECODER})."""

    backbone: FocalNetConfig = field(default_factory=FocalNetConfig)
    hidden_dim: int = 512
    conv_dim: int = 512
    mask_dim: int = 512
    num_queries: int = 201                # 200 object + 1 latent class token
    # pixel decoder / encoder variant: 'fpn' (focall config's
    # transformer_encoder_fpn) | 'deform' (MSDeformAttnPixelDecoder,
    # transformer_encoder_deform.py:140-377)
    pixel_decoder: str = "fpn"
    # backbone family: 'focalnet' (the released focall teacher) | 'davit' |
    # 'vit' (≙ the reference's alternative D2 backbones,
    # modeling/vision/backbone/{davit,vit}.py)
    backbone_type: str = "focalnet"
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9
    enc_layers: int = 6
    pre_norm: bool = False
    size_divisibility: int = 32
    pixel_mean: Tuple[float, ...] = _tuple_field(123.675, 116.280, 103.530)
    pixel_std: Tuple[float, ...] = _tuple_field(58.395, 57.120, 57.375)
    mask_shape: Tuple[int, int] = _tuple_field(484, 648)   # (H, W)
    # Released teacher checkpoint (xdecoder_focall_last.pt). When set,
    # build_pipeline converts it (utils/convert_xdecoder.py) into the frozen
    # teacher + language-tower params; when unset, teachers stay zero-
    # initialized and real-data runs warn loudly (they would produce garbage).
    ckpt: Optional[str] = None
    scores_keep_thresh: float = 0.0
    mask_threshold: float = 0.5
    fusion_top_k: int = 3                 # cross-view consensus top-K
    # 2D-lift backend: xdecoder (first-class) | lseg | ape — ≙ the reference's
    # feature_2d_extractor dispatch (affinity_module.py:348,736). lseg/ape
    # resolve through models/lift_backends.py's registry.
    lift_backend: str = "xdecoder"
    # Views per teacher forward (tail batches shift back, never wrap)
    view_batch: int = 8
    dtype: str = "bfloat16"


@dataclass
class SonataConfig:
    """PTv3/Sonata-style frozen 3D SSL teacher (ref: affinity_module.py:251-264).

    Hierarchical point transformer: 5 encoder stages with grid pooling between
    them; serialized (space-filling-curve) patch attention.
    """

    in_channels: int = 6                  # color || normal (sonata.transform.default)
    enc_depths: Tuple[int, ...] = _tuple_field(3, 3, 3, 12, 3)
    enc_channels: Tuple[int, ...] = _tuple_field(48, 96, 192, 384, 512)
    enc_num_head: Tuple[int, ...] = _tuple_field(3, 6, 12, 24, 32)
    enc_patch_size: Tuple[int, ...] = _tuple_field(1024, 1024, 1024, 1024, 1024)
    mlp_ratio: float = 4.0
    grid_size: float = 0.02
    stride: Tuple[int, ...] = _tuple_field(2, 2, 2, 2)
    upcast_levels: int = 2                # concat top-2 levels on the way back down
    stem_kernel: int = 5                  # PTv3 embedding SubMConv3d kernel size
    pool_reduce: str = "max"              # grid-pool reduction: max (PTv3 default) | mean
    norm: str = "ln"                      # ln | bn_folded (converted BN ckpts)
    dtype: str = "bfloat16"
    # Released frozen teacher weights (facebook/sonata). Converted by
    # utils/convert_sonata.py when set; see XDecoderConfig.ckpt for semantics.
    ckpt: Optional[str] = None


@dataclass
class TrainConfig:
    """Stage-1 optimization (ref: run/train.py:190-198,318-325; config Model block)."""

    lr_3d: float = 1e-4
    lr_input_mult: float = 0.1            # 3-tier differential LRs
    lr_middle_mult: float = 1.0
    lr_output_mult: float = 5.0
    weight_decay: float = 1e-5
    warmup_epochs: int = 2
    epochs: int = 100
    batch_size: int = 4
    manual_seed: int = 5557
    print_freq: int = 10
    save_freq: int = 1
    eval_freq: int = 2
    save_path: str = "runs/default"
    resume: Optional[str] = None
    grad_clip: Optional[float] = None
    grad_accum_steps: int = 1             # ≙ X-Decoder trainer GRADIENT_ACCUMULATE_STEP
    schedule: str = "cosine"


@dataclass
class ParallelConfig:
    """Device-mesh layout. The reference is DDP-only (SURVEY §2.4); here data
    parallelism rides the `data` mesh axis, tensor parallelism of the 2D teacher
    rides `model`, and long scenes may shard their point dim over `model` too."""

    data_axis: str = "data"
    model_axis: str = "model"
    dp: int = -1                          # -1: all devices
    tp: int = 1
    sync_batchnorm: bool = True           # pmean of BN moments ≙ SyncBN


@dataclass
class GeoPurifyConfig:
    data: DataConfig = field(default_factory=DataConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    student: StudentConfig = field(default_factory=StudentConfig)
    pooling: PoolingConfig = field(default_factory=PoolingConfig)
    contrastive: ContrastiveConfig = field(default_factory=ContrastiveConfig)
    text: TextConfig = field(default_factory=TextConfig)
    xdecoder: XDecoderConfig = field(default_factory=XDecoderConfig)
    sonata: SonataConfig = field(default_factory=SonataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


# ---------------------------------------------------------------------------
# Loading / overriding
# ---------------------------------------------------------------------------

def _coerce(dc_field_type: Any, current: Any, value: Any) -> Any:
    """Coerce a YAML/CLI value into the dataclass field's type.

    Field types are strings under postponed annotations, so dispatch on the
    type name and the current value's runtime type.
    """
    tname = dc_field_type if isinstance(dc_field_type, str) else str(dc_field_type)
    if (tname == "bool" or isinstance(current, bool)) and isinstance(value, str):
        # ``key=false`` on the command line: literal_eval leaves the string,
        # which is truthy (the JAX package keeps it so; the port parses it)
        if value.lower() not in ("true", "false"):
            raise ValueError(f"not a boolean: {value!r}")
        return value.lower() == "true"
    if "Tuple" in tname or "tuple" in tname or isinstance(current, tuple):
        return tuple(value) if isinstance(value, (list, tuple)) else (value,)
    if ("float" in tname or isinstance(current, float)) and isinstance(value, int):
        return float(value)
    return value


def _apply_dict(cfg: Any, d: Dict[str, Any], path: str = "") -> Any:
    """Recursively apply a nested dict onto a dataclass, returning a new one."""
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"{path or '<root>'} is not a config section")
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    updates = {}
    for key, value in d.items():
        if key not in fields:
            raise KeyError(f"Unknown config key: {path + key!r}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = _apply_dict(current, value, path + key + ".")
        else:
            updates[key] = _coerce(fields[key].type, current, value)
    return dataclasses.replace(cfg, **updates)


def _set_dotted(tree: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def parse_overrides(pairs: Sequence[str]) -> Dict[str, Any]:
    """Parse ``key.path=value`` CLI override strings into a nested dict."""
    tree: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"Override must look like key=value, got {pair!r}")
        key, raw = pair.split("=", 1)
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        _set_dotted(tree, key.strip(), value)
    return tree


def _preset_path(name: str) -> Path:
    here = Path(__file__).parent / "configs"
    p = here / f"{name}.yaml"
    if not p.exists():
        avail = sorted(q.stem for q in here.glob("*.yaml"))
        raise FileNotFoundError(f"No preset {name!r}; available: {avail}")
    return p


def load_config(
    preset: Optional[str] = None,
    overrides: Sequence[str] = (),
    yaml_path: Optional[str] = None,
) -> GeoPurifyConfig:
    """Build a config from a named preset and/or YAML file plus CLI overrides."""
    cfg = GeoPurifyConfig()
    if preset is not None:
        with open(_preset_path(preset)) as f:
            cfg = _apply_dict(cfg, yaml.safe_load(f) or {})
    if yaml_path is not None:
        with open(yaml_path) as f:
            cfg = _apply_dict(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = _apply_dict(cfg, parse_overrides(overrides))
    return cfg


def to_dict(cfg: GeoPurifyConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
