"""The plain reference, built and run by the benchmark: its modules from the
configuration file's numbers, the weights the run drew (drawn again from
the seed, so that nothing of the program's set-up reaches it), f32 with
TF32 off. ``lowp="fp8"`` runs the control: the X-Decoder's operands in
float8 e4m3 and the student in bf16, a step below what the configuration
states; ``lowp="bf16"`` the X-Decoder's operands at the configuration's
own bf16, the rest in f32 (a witness for how far bf16 alone moves the
answer).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.gen.weights import draw_student, draw_xdecoder, sub_seed

TEACHER_SEED = 0          # the frozen X-Decoder of every Stage-2 run
REFERENCE_VIEW_CHUNK = 8  # views a call of the reference's X-Decoder


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls and convolutions without TF32 inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _student_module(program: dict, compute_dtype: str = "float32"):
    from perfbench.reference.student import AffinityPredictor

    s = program["student"]
    return AffinityPredictor(s["input_dim"], s["hidden_dim"], s["embed_dim"],
                             s["num_res_blocks"], compute_dtype, s["bn_momentum"])


def shapes(program: dict) -> Tuple[List[tuple], List[tuple]]:
    """(name, shape) of the X-Decoder's parameters and of the student's
    parameters and buffers, from modules built on the meta device."""
    from perfbench.reference.xdecoder import XDecoderSegModel

    with torch.device("meta"):
        xd = XDecoderSegModel(program["xdecoder"])
        st = _student_module(program)
    return ([(n, tuple(p.shape)) for n, p in xd.named_parameters()],
            [(n, tuple(t.shape)) for n, t in st.state_dict().items()])


def xdecoder(program: dict, state: Dict[str, torch.Tensor]):
    from perfbench.reference.xdecoder import XDecoderSegModel

    with torch.device("meta"):
        m = XDecoderSegModel(program["xdecoder"])
    m.load_state_dict(state, assign=True)
    return m.eval()


def student(program: dict, state: Dict[str, torch.Tensor], compute_dtype: str = "float32"):
    with torch.device("meta"):
        m = _student_module(program, compute_dtype)
    m.load_state_dict(state, assign=True)
    return m


def draw_weights(cell: dict, seed: int, device) -> tuple:
    """A Stage-2 run's X-Decoder and student state dicts, drawn on
    ``device``: the X-Decoder from ``TEACHER_SEED`` (its
    weights decide how many points each view covers, and so the lift's
    donor search: drawn from the run's seed, they moved a
    ``matterport160-s2-large`` scene by 4-5% from seed to seed), the
    student from the run's seed."""
    xd, st = shapes(cell["program"])
    return (draw_xdecoder(xd, sub_seed(TEACHER_SEED, 1), device),
            draw_student(st, sub_seed(seed, 2), device))


def stage2_reference(cell: dict, seed: int, scene: Dict[str, torch.Tensor],
                     text: torch.Tensor, lowp: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The reference's answer for ``scene`` with the run's weights and
    prompts ``text``; ``lowp="fp8"`` is the control, ``"bf16"`` the witness."""
    from perfbench.reference.layers import lower_precision
    from perfbench.reference.stage2 import evaluate_scene

    prog = cell["program"]
    xsd, ssd = draw_weights(cell, seed, scene["points"].device)
    xdec = xdecoder(prog, xsd)
    stud = student(prog, ssd, "bfloat16" if lowp == "fp8" else "float32").eval()
    with exact_f32(), lower_precision(lowp):
        out = evaluate_scene(xdec, stud, scene, text, cell["config_file"]["logit_scale"], prog,
                             view_chunk=REFERENCE_VIEW_CHUNK)
    out["point_valid"] = scene["point_valid"]
    return out


def stage1_reference(cell: dict, seed: int, scenes, f2d, f_teacher, generator_seed: int,
                     steps: int, lowp: Optional[str] = None) -> tuple:
    """The reference's first ``steps`` steps from the run's weights, inputs
    and anchor generator: (``train_steps``' result, the drawn weights).
    ``lowp`` (any value) runs the control: the student in bf16."""
    from perfbench.reference.stage1 import train_steps

    prog = cell["program"]
    dev = scenes[0]["points"].device
    _, st = shapes(prog)
    drawn = draw_student(st, sub_seed(seed, 2), dev)
    p0 = {k: v.clone() for k, v in drawn.items()}
    stud = student(prog, drawn, "bfloat16" if lowp else "float32").train()
    with exact_f32():
        out = train_steps(stud, scenes, f2d, f_teacher, generator_seed, prog,
                          cell["traffic"]["steps_per_epoch"], steps)
    return out, p0
