"""The app surface of vkrt_tpu_torch (app/cli.py, app/metrics.py,
app/state.py, runtime.py, golden/harness.py) vs the JAX package's.

resolve_config gives field for field the JAX package's config for each
argv (exact: the same dataclass arithmetic); the parsers take the same
flags and choices, plus --device. The CLI runs on the CPU (--device cpu)
on the small procedural scene passed in memory: a pipelined fly-through's
last frame equals the synchronous render of the same camera bit for bit
(tests/test_cli.py:37), and a checkpointed run resumes at its frame.
FrameScheduler keeps tests/test_runtime.py:15's contract; FrameTimer,
check_finite and the checkpoint format are the JAX package's, and
checkpoints load across the two packages in both directions.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vkrt_tpu import config as JC
from vkrt_tpu.app import cli as jcli
from vkrt_tpu.app import metrics as jmetrics
from vkrt_tpu.app import state as jstate
from vkrt_tpu.app.camera import Camera as JCamera
from vkrt_tpu_torch import config as TC
from vkrt_tpu_torch import runtime
from vkrt_tpu_torch.app import cli as tcli
from vkrt_tpu_torch.app import metrics as tmetrics
from vkrt_tpu_torch.app import state as tstate
from vkrt_tpu_torch.app.camera import Camera
from vkrt_tpu_torch.app.flythrough import camera_path
from vkrt_tpu_torch.golden import harness
from vkrt_tpu_torch.raster.pipeline import Rasterizer
from vkrt_tpu_torch.scene.procedural import procedural_model
from vkrt_tpu_torch.wavefront.engine import Renderer
import torch_support  # noqa: F401

W, H = 64, 48
SMALL = ["--width", str(W), "--height", str(H), "--device", "cpu"]
ARGVS = [["--config", "3"],
         ["--config", "1", "--width", "320", "--height", "240", "--lights",
          "2", "--no-shadows"],
         [],
         ["--raster", "--msaa", "1"],
         ["--config", "5", "--max-depth", "3", "--no-reflections",
          "--mip-lod"],
         ["--config", "4", "--resort", "--no-resort", "--recheck"]]


@pytest.fixture(scope="module")
def small():
    return procedural_model("small", seed=0)


def options(parser) -> dict:
    return {a.option_strings[0]: a.choices for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_parser_flags_match_jax():
    got, want = options(tcli.build_parser()), options(jcli.build_parser())
    assert set(got) - set(want) == {"--device"}
    assert set(want) <= set(got)
    for flag, choices in want.items():
        assert got[flag] == choices, flag


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_resolve_config_matches_jax(argv):
    got = tcli.resolve_config(tcli.build_parser().parse_args(argv))
    want = jcli.resolve_config(jcli.build_parser().parse_args(argv))
    assert isinstance(got, TC.RenderConfig)
    for f in dataclasses.fields(TC.RenderConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_cli_flythrough_pipelined(tmp_path, small, capsys):
    """tests/test_cli.py:37 on the port: the frames-in-flight path's last
    frame equals a synchronous render of the same camera exactly."""
    out, ckpt = tmp_path / "fly.png", tmp_path / "ckpt.json"
    rc = tcli.main(["--config", "1", *SMALL, "--frames", "3", "--output",
                    str(out), "--metrics", "--checkpoint", str(ckpt)],
                   scene=small)
    assert rc == 0
    png = np.asarray(Image.open(out))
    cfg = dataclasses.replace(TC.config1_primary(), width=W, height=H)
    cams = list(camera_path(W, H))
    fb, rays = Renderer(small, cfg, "cpu", quantize=True).render(cams[2])
    np.testing.assert_array_equal(png, fb)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 3 and summary["total_rays"] == 3 * rays
    _, cam, idx, _ = tstate.load_state(str(ckpt))
    assert idx == 3
    np.testing.assert_array_equal(cam.view_matrix, cams[2].view_matrix)


def test_cli_checkpoint_resume(tmp_path, small):
    """A fly-through stopped after 2 frames resumes at frame 2: the
    second run renders frames 2 and 3 only, and its last frame is the
    synchronous render of camera 3."""
    ckpt, out = tmp_path / "ckpt.json", tmp_path / "last.npy"
    base = ["--config", "2", *SMALL, "--checkpoint", str(ckpt)]
    assert tcli.main(base + ["--frames", "2"], scene=small) == 0
    assert tstate.load_state(str(ckpt))[2] == 2
    assert tcli.main(base + ["--frames", "4", "--output", str(out),
                             "--check-finite"], scene=small) == 0
    assert tstate.load_state(str(ckpt))[2] == 4
    cfg = dataclasses.replace(TC.config2_shadows(), width=W, height=H)
    fb, _ = Renderer(small, cfg, "cpu").render(list(camera_path(W, H))[3])
    np.testing.assert_array_equal(np.load(out), fb)


def test_cli_raster_and_profile(tmp_path, small):
    """--raster renders serially with the FPS overlay: outside its text
    box the frame is Rasterizer.render_async's; --profile-dir writes a
    torch.profiler Chrome trace."""
    out, prof = tmp_path / "raster.npy", tmp_path / "prof"
    assert tcli.main(["--raster", "--msaa", "1", *SMALL, "--output",
                      str(out), "--profile-dir", str(prof)],
                     scene=small) == 0
    cfg = dataclasses.replace(TC.reference_config(), width=W, height=H)
    cam = Camera(W, H)
    cam.set_position(TC.CAMERA_START_POSITION)
    cam.set_rotation(TC.CAMERA_START_ROTATION)
    want = Rasterizer(small, cfg, "cpu", msaa=1).render_async(cam).numpy()
    got = np.load(out)
    keep = np.ones((H, W), bool)
    keep[8:22, 8:] = False                      # the "FPS ..." text box
    np.testing.assert_array_equal(got[keep], want[keep])
    trace = json.loads((prof / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "raster_setup" in names


def test_cli_refuses_without_card_and_unported_flags(small, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="cpu"):
        tcli.main(["--config", "1", "--width", str(W), "--height", str(H)],
                  scene=small)
    with pytest.raises(ValueError, match="--device cpu"):
        tcli.main(["--shard", "2", "--width", str(W), "--height", str(H)],
                  scene=small)
    # --resort and --recheck render the default frame (on the CPU here)
    def png(name, *flags):
        out = tmp_path / f"{name}.png"
        assert tcli.main([*flags, "--output", str(out), *SMALL],
                         scene=small) == 0
        return np.asarray(Image.open(out))

    want = png("default")
    for flag in ("--resort", "--recheck"):
        np.testing.assert_array_equal(png(flag[2:], flag), want)
    with pytest.raises(SystemExit):
        tcli.main(SMALL)                         # no --scene, no Model


def test_frame_scheduler_pacing():
    """tests/test_runtime.py:15: 6 frames, 2 in flight, each retires once
    and in order, with its own value."""
    sched = runtime.FrameScheduler(inflight=2)
    retired = []
    for i in range(6):
        r = sched.submit(lambda x: (x * 2.0, [x + 1]), torch.tensor(float(i)))
        assert (r is None) == (i < 2)
        if r is not None:
            retired.append(r)
    retired.extend(sched.drain())
    assert [idx for idx, _ in retired] == list(range(6))
    for idx, (v, (w,)) in retired:
        assert isinstance(v, np.ndarray) and float(v) == 2.0 * idx
        assert float(w) == idx + 1


def test_initialize():
    info = runtime.initialize("cpu")
    assert info["platform"] == "cpu" and info["device_kind"] == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            runtime.initialize("cuda")


def test_frame_timer_and_check_finite_match_jax():
    ms = [31.5, 12.25, 10.0, 14.75]
    rays = [1000, 2000, 2500, 1800]
    timers = [tmetrics.FrameTimer(), jmetrics.FrameTimer()]
    for t, mod in zip(timers, (tmetrics, jmetrics)):
        t.frames = [mod.FrameStats(frame_ms=m, rays=r)
                    for m, r in zip(ms, rays)]
    assert timers[0].summary() == timers[1].summary()
    assert tmetrics.FrameTimer().summary() == {}
    s = tmetrics.FrameStats(frame_ms=12.5, rays=3_000_000)
    j = jmetrics.FrameStats(frame_ms=12.5, rays=3_000_000)
    assert (s.mrays_per_s, s.fps) == (j.mrays_per_s, j.fps)
    fb = np.zeros((4, 5, 3), np.float32)
    tmetrics.check_finite(fb)
    fb[2, 3, 1] = np.nan
    msgs = []
    for mod in (tmetrics, jmetrics):
        with pytest.raises(FloatingPointError) as e:
            mod.check_finite(fb, "frame 7")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "[2, 3, 1]" in msgs[0]


def test_state_roundtrip(tmp_path):
    """tests/test_state.py:10 on the port."""
    cfg = TC.config4_flythrough()
    cam = Camera(cfg.width, cfg.height)
    cam.set_position([1.5, 2.5, -3.0])
    cam.set_rotation([0.1, 0.9, 0.0])
    p = str(tmp_path / "ckpt.json")
    tstate.save_state(p, cfg, cam, frame_index=137, extra={"note": "x"})
    cfg2, cam2, idx, extra = tstate.load_state(p)
    assert cfg2 == cfg and idx == 137 and extra["note"] == "x"
    np.testing.assert_allclose(cam2.position, cam.position)
    np.testing.assert_allclose(cam2.rotation, cam.rotation)
    np.testing.assert_array_equal(cam2.view_matrix, cam.view_matrix)
    assert not os.path.exists(p + ".tmp")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_crosses_packages(tmp_path, writer):
    """A checkpoint of either package loads in the other: the same
    config fields (the JAX package's ray_block dropped or defaulted),
    pose and frame."""
    p = str(tmp_path / "ckpt.json")
    jcfg = dataclasses.replace(JC.config5_stress(), width=320, mip_lod=True)
    tcfg = dataclasses.replace(TC.config5_stress(), width=320, mip_lod=True)
    if writer == "jax":
        cam = JCamera(320, jcfg.height)
        cam.set_position([0.5, 1.0, 2.0])
        jstate.save_state(p, jcfg, cam, 42, extra={"k": 1})
        cfg, cam2, idx, extra = tstate.load_state(p)
        assert cfg == tcfg
    else:
        cam = Camera(320, tcfg.height)
        cam.set_position([0.5, 1.0, 2.0])
        tstate.save_state(p, tcfg, cam, 42, extra={"k": 1})
        cfg, cam2, idx, extra = jstate.load_state(p)
        assert cfg == jcfg
    assert (idx, extra) == (42, {"k": 1})
    np.testing.assert_array_equal(cam2.view_matrix, cam.view_matrix)


def test_load_state_rejects_unknown_fields(tmp_path):
    p = tmp_path / "ckpt.json"
    cfg = TC.config1_primary()
    tstate.save_state(str(p), cfg, Camera(cfg.width, cfg.height), 1)
    state = json.loads(p.read_text())
    state["config"]["no_such_flag"] = True
    p.write_text(json.dumps(state))
    with pytest.raises(TypeError, match="no_such_flag"):
        tstate.load_state(str(p))


@pytest.mark.parametrize("oracle", ["brute", "native"])
def test_harness(tmp_path, small, capsys, oracle):
    diff = tmp_path / "diff.png"
    rc = harness.main(["--config", "4", *SMALL, "--oracle", oracle,
                       "--save-diff", str(diff)], scene=small)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["pass"] and res["rmse"] <= 1e-3
    assert (res["oracle"], res["backend"], res["resolution"]) == (
        oracle, "dense", [W, H])
    assert res["submeshes"] == len(small.submeshes) and diff.exists()
    rc = harness.main(["--config", "4", *SMALL, "--oracle", oracle,
                       "--submeshes", "3", "--threshold", "0"], scene=small)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if res["rmse"] == 0 else 1) and res["submeshes"] == 3
