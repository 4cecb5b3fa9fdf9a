"""``python -m geopurify_tpu_torch.run.parity --torch-oracle`` end to end on
the CPU: the ``sonata`` stage, which needs no reference tree, exits 0 with
its rows under 1e-5 and writes the ``--report`` markdown; a stage that runs
the reference code exits non-zero without the tree, naming its path, and
runs nothing."""

import os

import pytest

from geopurify_tpu_torch.parity import compare, shims
from geopurify_tpu_torch.run import parity


def test_sonata_stage_exits_0_and_writes_the_report(tmp_path, capsys):
    report = tmp_path / "report.md"
    with pytest.raises(SystemExit) as e:
        parity.main(["--torch-oracle", "small", "--stages", "sonata", "--device", "cpu",
                     "--report", str(report)])
    assert e.value.code == 0
    table = capsys.readouterr().out
    rows = [line.split() for line in table.splitlines() if line.startswith("sonata/")]
    assert sorted(r[0] for r in rows) == ["sonata/maxpool_stem", "sonata/meanpool_affine"]
    assert all(float(r[2]) < 1e-5 and r[3] == "OK" for r in rows), table
    text = report.read_text()
    assert text.startswith("# Torch-oracle activation parity (small)")
    assert "sonata/maxpool_stem" in text and "on cpu" in text


@pytest.mark.parametrize("stages", [["--stages", "focalnet"], ["--stages", "sonata,stage2"], []])
def test_reference_stages_exit_nonzero_naming_the_tree(stages, capsys, monkeypatch):
    if os.path.isdir(shims.reference_root()):
        pytest.skip("the reference tree is mounted: this pins its absence")
    ran = []
    monkeypatch.setitem(compare.ALL_STAGES, "sonata", lambda *a, **k: ran.append(1) or {})
    with pytest.raises(SystemExit) as e:
        parity.main(["--torch-oracle", "small", *stages, "--device", "cpu"])
    assert e.value.code not in (0, None)
    err = capsys.readouterr().err
    assert shims.reference_root() in err
    assert not ran
