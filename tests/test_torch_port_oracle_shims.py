"""The port's import shims (``parity/shims.py``) in a subprocess of their
own: they put fake ``detectron2`` / ``timm`` / ``torchvision``-era modules
into ``sys.modules``, which a pytest worker would keep for every later file.
Held against plain torch: detectron2's Conv2d (conv, then norm, then
activation), ``get_norm("GN")`` = ``GroupNorm(32, C)`` and
``ImageList.from_tensors``' bottom-right zero padding; a second
``install()`` changes nothing; importing the harness installs nothing; and
``cpu_cuda()`` puts ``torch.cuda`` back on exit."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    import torch.nn.functional as F

    fakes = ("detectron2", "timm", "fvcore", "MultiScaleDeformableAttention")
    from geopurify_tpu_torch.parity import compare, oracle, shims  # noqa: F401
    out = {"installed_at_import": [m for m in fakes if m in sys.modules]}

    shims.install()
    snapshot = {k: id(v) for k, v in sys.modules.items()}
    from detectron2.layers import Conv2d, get_norm
    from detectron2.structures import ImageList

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 9, 11, generator=g)
    norm = get_norm("GN", 64)
    conv = Conv2d(64, 64, 3, padding=1, bias=True, norm=norm, activation=F.relu)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        got = conv(x)
        ref_norm = torch.nn.GroupNorm(32, 64)
        ref_norm.load_state_dict(norm.state_dict())
        want = F.relu(ref_norm(F.conv2d(x, conv.weight, conv.bias, padding=1)))
    out["conv_norm_act"] = float((got - want).abs().max())
    out["gn"] = [type(norm).__name__, norm.num_groups, norm.num_channels]

    imgs = [torch.randn(3, 37, 53, generator=g), torch.randn(3, 30, 64, generator=g)]
    il = ImageList.from_tensors(imgs, 32)
    want = torch.stack([F.pad(t, (0, 64 - t.shape[2], 0, 64 - t.shape[1])) for t in imgs])
    out["pad_shape"] = list(il.tensor.shape)
    out["pad"] = float((il.tensor - want).abs().max())
    out["image_sizes"] = [list(s) for s in il.image_sizes]

    shims.install()
    out["reinstall_same"] = snapshot == {k: id(v) for k, v in sys.modules.items()}

    saved = torch.cuda.current_device, torch.Tensor.cuda
    with shims.cpu_cuda():
        out["inside"] = [torch.cuda.current_device(), x.cuda() is x]
    out["restored"] = (torch.cuda.current_device, torch.Tensor.cuda) == saved
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def result():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_importing_the_harness_installs_nothing(result):
    assert result["installed_at_import"] == []


def test_conv2d_applies_conv_then_norm_then_activation(result):
    assert result["conv_norm_act"] < 1e-6


def test_get_norm_gn_is_groupnorm_32(result):
    assert result["gn"] == ["GroupNorm", 32, 64]


def test_imagelist_zero_pads_bottom_right(result):
    assert result["pad_shape"] == [2, 3, 64, 64]
    assert result["pad"] == 0.0
    assert result["image_sizes"] == [[37, 53], [30, 64]]


def test_second_install_changes_nothing(result):
    assert result["reinstall_same"]


def test_cpu_cuda_is_scoped(result):
    assert result["inside"] == ["cpu", True]
    assert result["restored"]
