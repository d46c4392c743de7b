"""Guard against reduced-precision matmuls in vkrt_tpu_torch — the
counterpart of tests/test_matmul_precision_guard.py.

On an NVIDIA card `torch.matmul`, `mm`, `bmm`, `einsum`, `@` and
`F.linear` on float32 tensors may run on the tensor cores in TF32 (10
mantissa bits) when the `allow_tf32` switches are on: wrongness that only
shows on the card, which every CPU test passes. The JAX package lost
image quality to the same class of default more than once. The port
therefore (1) keeps both switches off (`runtime.exact_f32`, called by
every renderer), and (2) has no matmul at all in torch code: small
contractions go through `utils.layout.mat_rows3` and explicit
elementwise sums.

This test greps every module of the package that imports torch for
matmul sites, so a new one must extend ALLOWED consciously. Modules that
do not import torch are host-side numpy (golden/, app/camera.py,
utils/mathutils.py, scene/): numpy matmuls are exact float32.
"""

import re
from pathlib import Path

import torch

from vkrt_tpu_torch import runtime
import torch_support  # noqa: F401

PKG = Path(__file__).resolve().parent.parent / "vkrt_tpu_torch"

# file (relative to the package) → substrings of lines that may hold a
# matmul; starts empty
ALLOWED: dict = {}

PATTERNS = [
    (re.compile(r"\b(torch|th)\.(matmul|mm|bmm|mv|dot|einsum|tensordot|"
                r"addmm|baddbmm|inner)\s*\("), "torch matmul call"),
    (re.compile(r"\.(matmul|mm|bmm|mv)\s*\("), "tensor matmul method"),
    (re.compile(r"\bF\.(linear|bilinear|conv\dd)\s*\("), "F.linear/conv"),
    (re.compile(r"\bnn\.(Linear|Conv\dd)\s*\("), "nn.Linear/Conv"),
    (re.compile(r"\beinops\b|\beinsum\s*\("), "einsum"),
    # `x @ y` (decorators and comments excluded)
    (re.compile(r"^[^#@]*\S\s@\s"), "@ operator"),
]


def torch_modules():
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text()
        if re.search(r"^\s*(import torch|from torch)\b", text, re.M):
            yield path.relative_to(PKG).as_posix(), text


def test_torch_modules_are_scanned():
    names = [rel for rel, _ in torch_modules()]
    for rel in ("accel/refit.py", "accel/device_sah.py", "accel/clusters.py",
                "accel/lbvh.py", "rt/dense.py", "wavefront/engine.py",
                "raster/edge.py", "utils/layout.py"):
        assert rel in names, rel
    assert "golden/cpu_tracer.py" not in names      # numpy only


def test_no_matmul_in_torch_code():
    offenders = []
    for rel, text in torch_modules():
        in_doc = False
        for i, line in enumerate(text.splitlines()):
            if line.count('"""') % 2:
                in_doc = not in_doc
                continue
            code = line.split("#", 1)[0]
            if in_doc or not code.strip() or '"""' in line:
                continue
            for pat, name in PATTERNS:
                if pat.search(code) and not any(
                        tok in code for tok in ALLOWED.get(rel, [])):
                    offenders.append(f"{rel}:{i + 1}: {name}: "
                                     f"{line.strip()[:90]}")
    assert not offenders, (
        "matmul-class ops in torch code (TF32 on the tensor cores when "
        "allowed — use utils.layout.mat_rows3 or elementwise sums, or "
        "extend ALLOWED consciously):\n" + "\n".join(offenders))


def test_patterns_catch_matmuls():
    """The scan itself: each spelling is caught, mat_rows3-style code and
    decorators are not."""
    def caught(code):
        return any(p.search(code) for p, _ in PATTERNS)

    for code in ("y = torch.matmul(x, a)", "y = x @ a.T", "y = x.mm(a)",
                 "y = torch.einsum('ij,kj->ki', a, x)", "y = F.linear(x, a)",
                 "y = torch.bmm(x, a)", "c = (p.double() @ v.double())[3]"):
        assert caught(code), code
    for code in ("y = x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1]",
                 "@functools.lru_cache(maxsize=1)", "fmm = summary(x)"):
        assert not caught(code), code


def test_exact_f32_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        runtime.exact_f32()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_renderers_set_the_policy():
    """Every renderer goes through SceneOnDevice, which calls
    exact_f32() before it builds anything."""
    import inspect

    from vkrt_tpu_torch.raster.pipeline import Rasterizer
    from vkrt_tpu_torch.wavefront.engine import Renderer, SceneOnDevice
    assert issubclass(Renderer, SceneOnDevice)
    assert issubclass(Rasterizer, SceneOnDevice)
    assert "runtime.exact_f32()" in inspect.getsource(SceneOnDevice.__init__)
