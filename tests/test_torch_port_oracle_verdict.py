"""The verdict of ``run.parity.run_torch_oracle`` against the JAX tool's:
each package's ``run_all`` is monkeypatched to return the same synthetic
rows, and both must print the same table and return the same exit status
(rel < 1e-4 for the plain rows; the composed Stage-2 rows on their
calibrated limits, which ``worst`` leaves out but the status counts; the
histogram rows against the sub-margin row count ``n_tie``)."""

import pytest

from geopurify_tpu.parity import compare as jcompare
from geopurify_tpu.run import parity as jparity
from geopurify_tpu_torch.parity import compare as tcompare
from geopurify_tpu_torch.run import parity as tparity

PLAIN_OK = {"focalnet/res2": (3e-6, 2e-6), "lift/final_features": (1e-7, 5e-7)}
STAGE2_OK = {"stage2/voxel_in": (1e-7, 1e-7), "stage2/knn_sets": (0.0, 0.0),
             "stage2/features": (4e-4, 1.2e-2), "stage2/logits": (3e-4, 9e-3),
             "stage2/pred_agree": (5.0, 0.0), "stage2/hist_I": (3.0, 0.2),
             "stage2/hist_U": (5.0, 0.1), "stage2/hist_T": (0.0, 0.0)}

CASES = {
    "all pass": (PLAIN_OK, 0),
    "stage2 pass": ({**PLAIN_OK, **STAGE2_OK}, 0),
    "plain row fails": ({**PLAIN_OK, "head/pred_masks": (2e-3, 3e-4)}, 1),
    "plain row at the limit": ({"pad/imagelist32": (1e-4, 1e-4)}, 1),
    "special row fails, worst passes": (
        {**PLAIN_OK, **STAGE2_OK, "stage2/features": (1.3e-3, 3.3e-2)}, 1),
    "pred_agree disagrees": ({**STAGE2_OK, "stage2/pred_agree": (5.0, 1e-3)}, 1),
    "knn sets differ": ({**STAGE2_OK, "stage2/knn_sets": (3000.0, 1.0)}, 1),
    "hist at n_tie": ({**STAGE2_OK, "stage2/hist_U": (5.0, 0.9)}, 0),
    "hist above n_tie": ({**STAGE2_OK, "stage2/hist_I": (6.0, 0.01)}, 1),
    "hist without pred_agree": ({**PLAIN_OK, "stage2/hist_T": (1.0, 1e-9)}, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_verdict_equals_the_jax_tools(case, monkeypatch, capsys, tmp_path):
    rows, want = CASES[case]
    monkeypatch.setattr(jcompare, "run_all", lambda size, stages=None: dict(rows))
    monkeypatch.setattr(tcompare, "run_all",
                        lambda size, stages=None, device="cuda": dict(rows))
    j_status = jparity.run_torch_oracle("small", None, str(tmp_path / "j.md"))
    j_table = capsys.readouterr().out
    t_status = tparity.run_torch_oracle("small", None, str(tmp_path / "t.md"), device="cpu")
    t_table = capsys.readouterr().out
    assert (j_status, t_status) == (want, want)
    assert t_table == j_table
    report = (tmp_path / "t.md").read_text()
    assert report.startswith("# Torch-oracle activation parity (small)")
    assert "```\n" + t_table.rstrip("\n") + "\n```" in report
