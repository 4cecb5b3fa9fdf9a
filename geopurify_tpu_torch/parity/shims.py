"""Stand-in modules so the mounted reference X-Decoder imports on torch-cpu.

Port of geopurify_tpu/parity/shims.py, kept as a copy under the same
module names in ``sys.modules``. Nothing is installed at import: the
oracle builders (parity/oracle.py) call ``install`` / ``install_geopurify``
/ ``install_me_runnable`` when a stage that needs the reference runs.
One difference: the CPU-only ``torch.cuda`` patch is scoped to
``cpu_cuda()`` blocks instead of installed for the process.

The reference imports detectron2/timm/fvcore/kornia/mpi4py, none of which are
installed (and cannot be: no egress). Only a handful of symbols are touched on
the inference paths we oracle against; each is implemented faithfully where its
BEHAVIOR feeds the forward pass (detectron2 Conv2d's conv->norm->activation
order, get_norm("GN") = GroupNorm(32), ImageList.from_tensors bottom-right
zero-padding to size_divisibility — detectron2's public semantics), and as an
inert stub where only importability matters (DeformConv, BitMasks, MPI, ...).

Everything lands in sys.modules via install(); idempotent.
"""

from __future__ import annotations

import contextlib
import sys
import types
from typing import List, Optional


def _mod(name: str) -> types.ModuleType:
    m = sys.modules.get(name)
    if m is None:
        m = types.ModuleType(name)
        # a real ModuleSpec so importlib.util.find_spec (e.g. transformers'
        # capability probing) doesn't choke on the synthetic module
        import importlib.machinery

        m.__spec__ = importlib.machinery.ModuleSpec(name, None)
        sys.modules[name] = m
    return m


def install() -> None:
    if getattr(install, "_done", False):
        return
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    # ------- MultiScaleDeformableAttention (uncompiled CUDA ext) -------
    # ms_deform_attn_func.py raises at import when the extension is absent;
    # a dummy module whose entry points raise keeps the import alive and
    # routes MSDeformAttn.forward's try/except to the pure-torch CPU path
    # (ops/modules/ms_deform_attn.py:116-121).
    msda = _mod("MultiScaleDeformableAttention")

    def _no_cuda_ext(*a, **k):
        raise RuntimeError("MultiScaleDeformableAttention ext not built (shim)")

    msda.ms_deform_attn_forward = _no_cuda_ext
    msda.ms_deform_attn_backward = _no_cuda_ext

    # ---------------- timm ----------------
    timm = _mod("timm")
    timm_models = _mod("timm.models")
    timm_layers = _mod("timm.models.layers")
    timm_loss = _mod("timm.loss")
    timm.models = timm_models
    timm_models.layers = timm_layers

    def to_2tuple(x):
        return tuple(x) if isinstance(x, (tuple, list)) else (x, x)

    def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0):
        return nn.init.trunc_normal_(tensor, mean=mean, std=std, a=a, b=b)

    class DropPath(nn.Module):
        """Per-sample stochastic depth — identity in eval (we only eval)."""

        def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True):
            super().__init__()
            self.drop_prob = drop_prob
            self.scale_by_keep = scale_by_keep

        def forward(self, x):
            if self.drop_prob == 0.0 or not self.training:
                return x
            keep = 1.0 - self.drop_prob
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
            mask = x.new_empty(shape).bernoulli_(keep)
            if self.scale_by_keep:
                mask.div_(keep)
            return x * mask

    class SoftTargetCrossEntropy(nn.Module):
        def forward(self, x, target):
            return torch.sum(-target * F.log_softmax(x, dim=-1), dim=-1).mean()

    timm_layers.DropPath = DropPath
    timm_layers.to_2tuple = to_2tuple
    timm_layers.trunc_normal_ = trunc_normal_
    timm_loss.SoftTargetCrossEntropy = SoftTargetCrossEntropy

    # ---------------- fvcore ----------------
    fvcore = _mod("fvcore")
    fv_nn = _mod("fvcore.nn")
    fv_wi = _mod("fvcore.nn.weight_init")
    fv_common = _mod("fvcore.common")
    fv_cfg = _mod("fvcore.common.config")
    fvcore.nn = fv_nn
    fv_nn.weight_init = fv_wi

    def c2_xavier_fill(module: nn.Module) -> None:
        # fvcore: Caffe2 XavierFill == kaiming_uniform_ with a=1 (fan_in)
        nn.init.kaiming_uniform_(module.weight, a=1)
        if getattr(module, "bias", None) is not None:
            nn.init.constant_(module.bias, 0)

    def c2_msra_fill(module: nn.Module) -> None:
        nn.init.kaiming_normal_(module.weight, mode="fan_out", nonlinearity="relu")
        if getattr(module, "bias", None) is not None:
            nn.init.constant_(module.bias, 0)

    fv_wi.c2_xavier_fill = c2_xavier_fill
    fv_wi.c2_msra_fill = c2_msra_fill

    class _CfgNode(dict):
        def __getattr__(self, k):
            try:
                return self[k]
            except KeyError as e:
                raise AttributeError(k) from e

        def __setattr__(self, k, v):
            self[k] = v

    fv_cfg.CfgNode = _CfgNode

    # ---------------- detectron2 ----------------
    d2 = _mod("detectron2")
    d2_layers = _mod("detectron2.layers")
    d2_modeling = _mod("detectron2.modeling")
    d2_structures = _mod("detectron2.structures")
    d2_utils = _mod("detectron2.utils")
    d2_fileio = _mod("detectron2.utils.file_io")
    d2_memory = _mod("detectron2.utils.memory")
    d2_comm = _mod("detectron2.utils.comm")
    d2_data = _mod("detectron2.data")
    d2.layers = d2_layers
    d2.modeling = d2_modeling
    d2.structures = d2_structures
    d2.utils = d2_utils
    d2_utils.file_io = d2_fileio
    d2_utils.memory = d2_memory
    d2_utils.comm = d2_comm
    d2.data = d2_data

    class ShapeSpec:
        def __init__(self, channels=None, height=None, width=None, stride=None):
            self.channels = channels
            self.height = height
            self.width = width
            self.stride = stride

    class Conv2d(nn.Conv2d):
        """detectron2 Conv2d: conv -> optional norm -> optional activation."""

        def __init__(self, *args, **kwargs):
            norm = kwargs.pop("norm", None)
            activation = kwargs.pop("activation", None)
            super().__init__(*args, **kwargs)
            self.norm = norm
            self.activation = activation

        def forward(self, x):
            x = F.conv2d(
                x, self.weight, self.bias, self.stride, self.padding,
                self.dilation, self.groups,
            )
            if self.norm is not None:
                x = self.norm(x)
            if self.activation is not None:
                x = self.activation(x)
            return x

    class DeformConv(nn.Module):
        def __init__(self, *a, **k):
            super().__init__()

        def forward(self, *a, **k):
            raise NotImplementedError("DeformConv shim is import-only")

    def get_norm(norm, out_channels):
        if norm is None or norm == "":
            return None
        if callable(norm) and not isinstance(norm, str):
            return norm(out_channels)
        return {
            "GN": lambda c: nn.GroupNorm(32, c),
            "BN": lambda c: nn.BatchNorm2d(c),
            "SyncBN": lambda c: nn.BatchNorm2d(c),
            "LN": lambda c: nn.GroupNorm(1, c),
        }[norm](out_channels)

    def cat(tensors: List, dim: int = 0):
        if len(tensors) == 1:
            return tensors[0]
        return torch.cat(tensors, dim)

    def shapes_to_tensor(x, device=None):
        if torch.jit.is_scripting():
            return torch.as_tensor(x, device=device)
        return torch.as_tensor(x, device=device)

    d2_layers.Conv2d = Conv2d
    d2_layers.DeformConv = DeformConv
    d2_layers.ShapeSpec = ShapeSpec
    d2_layers.get_norm = get_norm
    d2_layers.cat = cat
    d2_layers.shapes_to_tensor = shapes_to_tensor

    class _Registry:
        def __init__(self):
            self._map = {}

        def register(self, obj=None):
            if obj is None:
                def deco(cls):
                    self._map[cls.__name__] = cls
                    return cls
                return deco
            self._map[obj.__name__] = obj
            return obj

        def get(self, name):
            return self._map[name]

    class Backbone(nn.Module):
        def output_shape(self):
            return {}

        @property
        def size_divisibility(self) -> int:
            return 0

    d2_modeling.BACKBONE_REGISTRY = _Registry()
    d2_modeling.SEM_SEG_HEADS_REGISTRY = _Registry()
    d2_modeling.Backbone = Backbone
    d2_modeling.ShapeSpec = ShapeSpec

    class ImageList:
        """Faithful subset of detectron2.structures.ImageList: batch of CHW
        tensors padded bottom-right with zeros to a common size rounded up to
        ``size_divisibility`` (the /32 padding forward_seg_all relies on)."""

        def __init__(self, tensor, image_sizes):
            self.tensor = tensor
            self.image_sizes = image_sizes

        def __len__(self):
            return len(self.image_sizes)

        def __getitem__(self, idx):
            h, w = self.image_sizes[idx]
            return self.tensor[idx, ..., :h, :w]

        @property
        def device(self):
            return self.tensor.device

        @staticmethod
        def from_tensors(tensors, size_divisibility: int = 0, pad_value: float = 0.0):
            image_sizes = [(int(t.shape[-2]), int(t.shape[-1])) for t in tensors]
            max_h = max(s[0] for s in image_sizes)
            max_w = max(s[1] for s in image_sizes)
            if size_divisibility > 1:
                d = size_divisibility
                max_h = -(-max_h // d) * d
                max_w = -(-max_w // d) * d
            batched = tensors[0].new_full(
                (len(tensors), tensors[0].shape[0], max_h, max_w), pad_value
            )
            for img, pad in zip(tensors, batched):
                pad[..., : img.shape[-2], : img.shape[-1]].copy_(img)
            return ImageList(batched, image_sizes)

    class Boxes:
        def __init__(self, tensor):
            self.tensor = tensor

    class _Stub:
        def __init__(self, *a, **k):
            pass

    class Instances:
        def __init__(self, image_size, **kwargs):
            self._image_size = image_size
            for k, v in kwargs.items():
                setattr(self, k, v)

    class BoxMode:
        XYXY_ABS = 0
        XYWH_ABS = 1

        @staticmethod
        def convert(box, from_mode, to_mode):
            return box

    for name, obj in [
        ("ImageList", ImageList), ("Boxes", Boxes), ("Instances", Instances),
        ("BitMasks", _Stub), ("BoxMode", BoxMode), ("Keypoints", _Stub),
        ("PolygonMasks", _Stub), ("RotatedBoxes", _Stub), ("ROIMasks", _Stub),
    ]:
        setattr(d2_structures, name, obj)

    class PathManager:
        @staticmethod
        def open(path, mode="r", **kwargs):
            return open(path, mode, **kwargs)

        @staticmethod
        def exists(path):
            import os
            return os.path.exists(path)

    d2_fileio.PathManager = PathManager
    d2_memory.retry_if_cuda_oom = lambda fn: fn
    d2_comm.get_world_size = lambda: 1
    d2_comm.is_main_process = lambda: True

    class _Metadata:
        def __getattr__(self, k):
            raise AttributeError(k)

    class _MetadataCatalog:
        @staticmethod
        def get(name):
            return _Metadata()

    d2_data.MetadataCatalog = _MetadataCatalog()

    # ---------------- kornia ----------------
    kornia = _mod("kornia")
    kornia_contrib = _mod("kornia.contrib")
    kornia.contrib = kornia_contrib

    def distance_transform(image, kernel_size=3, h=0.35):
        """RUNNABLE rebuild of kornia.contrib.distance_transform's published
        conv-approximation (kornia itself is not installable here): each
        zero pixel gets an approximate distance to the nearest non-zero
        pixel via iterative exp(-d/h) convolution of the growing boundary.
        Mirrors data/visual_sampler.distance_transform_conv so the
        SimpleClick parity pin covers the composed click->dilate semantics
        (simpleclick_sampler.py:66)."""
        import math as _math

        b, c, H, W = image.shape
        x = image.reshape(b * c, 1, H, W).float()
        half = kernel_size // 2
        ar = torch.arange(kernel_size, dtype=torch.float32) - half
        ki, kj = torch.meshgrid(ar, ar, indexing="ij")
        kernel = torch.exp(-torch.sqrt(ki ** 2 + kj ** 2) / h)[None, None]
        out = torch.zeros_like(x)
        boundary = x.clone()
        for i in range(_math.ceil(max(H, W) / half)):
            pad = F.pad(boundary, (half, half, half, half), mode="replicate")
            cdt = F.conv2d(pad, kernel)
            cdt = -h * torch.log(cdt)
            cdt = torch.nan_to_num(cdt, posinf=0.0)
            m = cdt > 0
            if not bool(m.any()):
                break
            out = out + (i * half + cdt) * m
            boundary = torch.where(m, torch.ones_like(boundary), boundary)
        return out.reshape(b, c, H, W)

    kornia_contrib.distance_transform = distance_transform

    # ---------------- torchvision ----------------
    # modeling/utils/misc.py only touches torchvision._is_tracing()
    tv = _mod("torchvision")
    tv._is_tracing = lambda: False
    tv_transforms = _mod("torchvision.transforms")
    tv.transforms = tv_transforms
    tv_ops = _mod("torchvision.ops")
    tv.ops = tv_ops
    tv_boxes = _mod("torchvision.ops.boxes")
    tv_ops.boxes = tv_boxes

    def box_area(boxes):
        return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])

    def box_iou(boxes1, boxes2):
        area1 = box_area(boxes1)
        area2 = box_area(boxes2)
        lt = torch.max(boxes1[:, None, :2], boxes2[None, :, :2])
        rb = torch.min(boxes1[:, None, 2:], boxes2[None, :, 2:])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        return inter / (area1[:, None] + area2[None, :] - inter)

    tv_boxes.box_area = box_area
    tv_ops.box_iou = box_iou

    # ---------------- omegaconf ----------------
    # only touched by @configurable's cfg-vs-kwargs dispatch isinstance check
    oc = _mod("omegaconf")
    if not hasattr(oc, "DictConfig"):
        oc.DictConfig = type("DictConfig", (dict,), {})

    # ---------------- mpi4py ----------------
    mpi4py = _mod("mpi4py")

    class _Comm:
        def Get_rank(self):
            return 0

        def Get_size(self):
            return 1

    class _MPI:
        COMM_WORLD = _Comm()

    mpi4py.MPI = _MPI()
    sys.modules["mpi4py.MPI"] = mpi4py.MPI

    install._done = True


def install_geopurify() -> None:
    """Extra shims for importing the reference's OWN modules
    (models/affinity_module.py): MinkowskiEngine/clip/sonata/open3d inert,
    torch_scatter and faiss FAITHFUL (exact scatter_mean / exact L2 search) so
    the sampler/pooling math can run as an oracle."""
    if getattr(install_geopurify, "_done", False):
        return
    install()
    import numpy as np
    import torch

    def _inert(name: str) -> types.ModuleType:
        m = _mod(name)

        class _Raises:
            def __init__(self, *a, **k):
                raise NotImplementedError(f"{name} shim is import-only")

        def _getattr(attr, _r=_Raises):
            if attr.startswith("__"):       # keep importlib/inspect happy
                raise AttributeError(attr)
            return _r

        if "__getattr__" not in m.__dict__:
            m.__getattr__ = _getattr
        return m

    me = _mod("MinkowskiEngine")
    mef = _mod("MinkowskiEngine.MinkowskiFunctional")
    me.MinkowskiFunctional = mef

    class _MEStub:
        def __init__(self, *a, **k):
            raise NotImplementedError("MinkowskiEngine shim is import-only")

    for attr in [
        "MinkowskiConvolution", "MinkowskiBatchNorm", "MinkowskiReLU",
        "MinkowskiSyncBatchNorm", "SparseTensor", "MinkowskiNetwork",
    ]:
        setattr(me, attr, _MEStub)
    mef.relu = lambda x: torch.relu(x)

    _inert("clip")
    _inert("sonata")
    _inert("open3d")
    sys.modules["open3d"].geometry = types.SimpleNamespace()
    sys.modules["open3d"].utility = types.SimpleNamespace()
    sys.modules["open3d"].io = types.SimpleNamespace()

    ts = _mod("torch_scatter")

    def scatter_mean(src, index, dim=0, out=None, dim_size=None):
        if dim_size is None:
            dim_size = int(index.max().item()) + 1 if index.numel() else 0
        shape = list(src.shape)
        shape[dim] = dim_size
        total = torch.zeros(shape, dtype=src.dtype).index_add_(dim, index, src)
        ones = torch.ones(index.shape[0], dtype=src.dtype)
        cnt = torch.zeros(dim_size, dtype=src.dtype).index_add_(0, index, ones)
        cnt = cnt.clamp(min=1)
        view = [1] * len(shape)
        view[dim] = dim_size
        return total / cnt.view(view) if len(shape) == 1 else total / cnt[
            (slice(None),) + (None,) * (len(shape) - 1)
        ]

    ts.scatter_mean = scatter_mean

    faiss = _mod("faiss")

    class IndexFlatL2:
        """Exact brute-force L2 index — numerically faithful faiss stand-in."""

        def __init__(self, d):
            self.d = d
            self._x = np.zeros((0, d), np.float32)

        def add(self, x):
            self._x = np.concatenate([self._x, np.asarray(x, np.float32)])

        @property
        def ntotal(self):
            return self._x.shape[0]

        def search(self, q, k):
            q = np.asarray(q, np.float32)
            d2 = (
                (q ** 2).sum(1, keepdims=True)
                - 2.0 * q @ self._x.T
                + (self._x ** 2).sum(1)[None]
            )
            idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
            return np.take_along_axis(d2, idx, 1).astype(np.float32), idx.astype(np.int64)

    faiss.IndexFlatL2 = IndexFlatL2

    d2_cfg = _mod("detectron2.config")
    sys.modules["detectron2"].config = d2_cfg

    class LazyConfig:
        @staticmethod
        def load(*a, **k):
            raise NotImplementedError("LazyConfig shim is import-only")

    d2_cfg.LazyConfig = LazyConfig
    d2_colormap = _mod("detectron2.utils.colormap")
    sys.modules["detectron2.utils"].colormap = d2_colormap
    d2_colormap.random_color = lambda rgb=False, maximum=255: np.array([0, 0, 0])
    d2_logger = _mod("detectron2.utils.logger")
    sys.modules["detectron2.utils"].logger = d2_logger
    d2_logger.setup_logger = lambda *a, **k: None

    install_geopurify._done = True


def install_me_runnable() -> None:
    """Upgrade the MinkowskiEngine shim from import-only to RUNNABLE for the
    stride-1 3^3/1^3 kernel set the reference student uses
    (reference models/affinity_module.py:33-85) — the end-to-end Stage-2
    oracle (VERDICT r3 item #1) runs the reference ``evaluate_scene`` on
    torch-cpu through this.

    Implemented ME semantics (self-consistent with
    utils/checkpoint.convert_student_checkpoint; real ME is not installable
    here, so the hypercube kernel-offset enumeration order — FIRST axis
    fastest — and the ``out[u] = sum_j in[u + o_j] @ W[j]`` sign convention
    are documented assumptions shared by shim and converter; a real-
    checkpoint mIoU run is the final arbiter):

    - ``SparseTensor(features, coordinates[, device])``: unique batched int
      coordinates keep their input row order (ME's coordinate-map insertion
      order for an initial tensor); ``.F``/``.C``; ``+`` requires the same
      coordinate map (ME raises otherwise) and adds features.
    - ``MinkowskiConvolution(in, out, kernel_size, dimension)``: stride 1 on
      the same coordinate map; ``.kernel`` is [K, in, out] for volume>1 and
      [in, out] for 1^3, bias ABSENT by default (ME's bias=False default —
      the reference never passes bias=True).
    - ``MinkowskiBatchNorm(ch)``: torch BatchNorm1d under ``.bn`` (matching
      the reference checkpoints' ``*.bn.weight`` key layout).
    - ``MinkowskiReLU`` and ``MinkowskiEngine.MinkowskiFunctional.relu`` on
      sparse tensors.
    - ``ME.utils.batched_coordinates([t])``: prepend a batch-index column,
      floor to int.
    """
    if getattr(install_me_runnable, "_done", False):
        return
    install_geopurify()
    import torch
    import torch.nn as nn

    me = sys.modules["MinkowskiEngine"]
    mef = sys.modules["MinkowskiEngine.MinkowskiFunctional"]

    class SparseTensor:
        def __init__(self, features, coordinates, device=None, coordinate_map=None):
            self.F = features
            self.C = coordinates.int() if coordinates.dtype != torch.int32 else coordinates
            # coordinate map identity: shared by all stride-1 outputs
            self._map = coordinate_map if coordinate_map is not None else self

        @property
        def device(self):
            return self.F.device

        def _with_features(self, feats):
            return SparseTensor(feats, self.C, coordinate_map=self._map)

        def __add__(self, other):
            assert isinstance(other, SparseTensor) and other._map is self._map, (
                "ME sparse addition requires an identical coordinate map"
            )
            return self._with_features(self.F + other.F)

        __radd__ = __add__

        def __iadd__(self, other):
            return self.__add__(other)

    def _me_offsets(kernel_size: int, dimension: int):
        """Hypercube offsets, FIRST axis fastest (see docstring)."""
        import itertools

        r = range(-(kernel_size // 2), kernel_size // 2 + 1)
        # first axis fastest == product over reversed axes, then flip tuples
        return [tuple(reversed(o)) for o in itertools.product(*([list(r)] * dimension))]

    class MinkowskiConvolution(nn.Module):
        def __init__(self, in_channels, out_channels, kernel_size=3,
                     stride=1, dilation=1, bias=False, dimension=3):
            super().__init__()
            assert stride == 1 and dilation == 1, "shim: stride-1 only"
            self.offsets = _me_offsets(kernel_size, dimension)
            K = len(self.offsets)
            if K == 1:
                self.kernel = nn.Parameter(torch.randn(in_channels, out_channels) * 0.05)
            else:
                self.kernel = nn.Parameter(torch.randn(K, in_channels, out_channels) * 0.05)
            if bias:
                self.bias = nn.Parameter(torch.zeros(out_channels))
            else:
                self.register_parameter("bias", None)

        def forward(self, x: "SparseTensor") -> "SparseTensor":
            coords = x.C[:, 1:].tolist()
            lut = {tuple(c): i for i, c in enumerate(coords)}
            F_in = x.F
            out = F_in.new_zeros((F_in.shape[0], self.kernel.shape[-1]))
            if self.kernel.ndim == 2:
                out = F_in @ self.kernel
            else:
                for j, off in enumerate(self.offsets):
                    rows_out, rows_in = [], []
                    for i, c in enumerate(coords):
                        nb = lut.get((c[0] + off[0], c[1] + off[1], c[2] + off[2]))
                        if nb is not None:
                            rows_out.append(i)
                            rows_in.append(nb)
                    if rows_out:
                        out.index_add_(
                            0, torch.tensor(rows_out),
                            F_in[torch.tensor(rows_in)] @ self.kernel[j],
                        )
            if self.bias is not None:
                out = out + self.bias
            return x._with_features(out)

    class MinkowskiBatchNorm(nn.Module):
        def __init__(self, num_features, eps=1e-5, momentum=0.1):
            super().__init__()
            self.bn = nn.BatchNorm1d(num_features, eps=eps, momentum=momentum)

        def forward(self, x: "SparseTensor") -> "SparseTensor":
            return x._with_features(self.bn(x.F))

    class MinkowskiReLU(nn.Module):
        def __init__(self, inplace=False):
            super().__init__()

        def forward(self, x: "SparseTensor") -> "SparseTensor":
            return x._with_features(torch.relu(x.F))

    me.SparseTensor = SparseTensor
    me.MinkowskiConvolution = MinkowskiConvolution
    me.MinkowskiBatchNorm = MinkowskiBatchNorm
    me.MinkowskiReLU = MinkowskiReLU

    utils = _mod("MinkowskiEngine.utils")
    me.utils = utils

    def batched_coordinates(coords_list, dtype=None, device=None):
        rows = []
        for b, c in enumerate(coords_list):
            c = torch.as_tensor(c)
            c = torch.floor(c.float()).int() if c.is_floating_point() else c.int()
            col = torch.full((c.shape[0], 1), b, dtype=torch.int32)
            rows.append(torch.cat([col, c], dim=1))
        return torch.cat(rows, dim=0)

    utils.batched_coordinates = batched_coordinates

    def _relu(x):
        return x._with_features(torch.relu(x.F)) if isinstance(x, SparseTensor) else torch.relu(x)

    mef.relu = _relu
    install_me_runnable._done = True


@contextlib.contextmanager
def cpu_cuda():
    """CPU-only ``torch.cuda`` while the reference runs: the
    visual_sampler/simpleclick modules allocate on
    torch.cuda.current_device() and call .cuda() unconditionally
    (simpleclick_sampler.py:37,56-57,122); inside this block both are
    no-ops, so the reference runs unmodified on the CPU. The JAX harness
    patches them for the whole process; here they are put back on exit, so
    that the port's side of a stage runs on the card with torch.cuda
    intact."""
    import torch

    saved = torch.cuda.current_device, torch.Tensor.cuda
    torch.cuda.current_device = lambda: "cpu"
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        yield
    finally:
        torch.cuda.current_device, torch.Tensor.cuda = saved


def geopurify_root() -> str:
    """Where the GeoPurify reference tree is mounted (the JAX harness's
    path)."""
    return "/root/reference"


def reference_root() -> str:
    """The X-Decoder inside the reference tree."""
    return geopurify_root() + "/third_party/X-Decoder"


def add_reference_to_path() -> None:
    root = reference_root()
    if root not in sys.path:
        sys.path.insert(0, root)


def add_xdecoder_inner_to_path() -> None:
    """The datasets/ tree imports repo-absolute modules (`from modeling.utils
    import configurable` — visual_sampler/sampler.py:12), which resolve only
    with the inner X-Decoder/xdecoder directory itself on sys.path."""
    add_reference_to_path()
    inner = reference_root() + "/xdecoder"
    if inner not in sys.path:
        sys.path.insert(0, inner)


def add_geopurify_to_path() -> None:
    add_reference_to_path()
    root = geopurify_root()
    if root not in sys.path:
        sys.path.insert(0, root)
