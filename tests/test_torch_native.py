"""The port's native host library (``evam_tpu_torch/native.py``) against
the reference's (``evam_tpu/native.py`` over ``native/libevam_media.so``)
and against the port's numpy copies.

* ``resize_bgr_to_i420``, ``resize_bgr``, ``bgr_to_i420`` and
  ``luma_grid`` give the same bytes as the reference's library and as
  the numpy copies: 1080p → 512² and → 432×768, odd widths and heights,
  upscales and the no-resize case. Exact equality: one byte of
  difference is a fault.
* Four threads calling at once give the same bytes as one thread.
* The policy is the reference's: ``EVAM_NO_NATIVE`` (any non-empty
  value, "0" included) off, ``EVAM_NATIVE`` on, else on with 4 or more
  cores (``os.cpu_count`` patched to 2 and to 8); ``EVAM_NATIVE_LIB``
  loads a prebuilt library.
* The library builds into ``build/native/`` keyed on the source's
  digest; a compiler that is not found, or a source that does not
  compile, raises — the port never falls back.
* Through the stack: the gated detect path publishes the same objects
  and takes the same gate decisions with the policy on and off.

The reference's library is loaded as it stands in ``native/``, or,
where it is missing, built from ``native/evam_media.cpp`` under a
temporary directory (never in ``native/``).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu import native as ref
from evam_tpu_torch import native
from evam_tpu_torch.media.luma import luma_grid as luma_grid_host
from evam_tpu_torch.ops.color import (
    bgr_to_i420_host,
    resize_bgr_host,
    resize_bgr_to_i420_host,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KEY = "object_detection/person_vehicle_bike"


def _loads(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
    except OSError:
        return False
    return True


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    """The reference's ``native`` module bound to its library: the one
    in ``native/`` where it loads, else a copy built under a temporary
    directory with ``native/Makefile``'s flags."""
    lib = REPO / "native" / "libevam_media.so"
    if not (lib.is_file() and _loads(lib)):
        lib = tmp_path_factory.mktemp("refnative") / "libevam_media.so"
        subprocess.run(["g++", "-O3", "-fPIC", "-fopenmp", "-Wall",
                        "-std=c++17", "-shared", "-o", str(lib),
                        str(REPO / "native" / "evam_media.cpp")],
                       check=True, capture_output=True)
    saved = (ref._LIB_PATHS, ref._tried, ref._lib)
    ref._LIB_PATHS, ref._tried, ref._lib = [lib], False, None
    try:
        assert ref._load() is not None
        yield ref
    finally:
        ref._LIB_PATHS, ref._tried, ref._lib = saved


@pytest.fixture
def native_on(ref_lib, monkeypatch):
    """Both libraries on, whatever the host's cores."""
    monkeypatch.delenv("EVAM_NO_NATIVE", raising=False)
    monkeypatch.setenv("EVAM_NATIVE", "1")
    assert native._use_native() and ref_lib._use_native()
    return ref_lib


def _frame(hw, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


# ------------------------------------------------- byte for byte

#: (source H, W) → (destination H, W); I420 destinations are h%4, w%2
I420_CASES = [((1080, 1920), (512, 512)), ((1080, 1920), (432, 768)),
              ((481, 641), (64, 96)), ((97, 131), (100, 130)),
              ((33, 47), (12, 10)), ((480, 640), (480, 640))]


@pytest.mark.parametrize("src,dst", I420_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                              for s, d in I420_CASES])
def test_resize_bgr_to_i420_is_byte_equal(native_on, src, dst):
    frame = _frame(src, src[0] + dst[1])
    got = native.resize_bgr_to_i420(frame, *dst)
    assert got.shape == (dst[0] * 3 // 2, dst[1]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, native_on.resize_bgr_to_i420(frame,
                                                                    *dst))
    np.testing.assert_array_equal(got, resize_bgr_to_i420_host(frame, *dst))


RESIZE_CASES = [((1080, 1920), (512, 512)), ((1080, 1920), (432, 768)),
                ((97, 131), (33, 47)), ((33, 47), (97, 131)),
                ((1, 1), (3, 5)), ((480, 640), (480, 640))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                              for s, d in RESIZE_CASES])
def test_resize_bgr_is_byte_equal(native_on, src, dst):
    frame = _frame(src, src[1] + dst[0])
    got = native.resize_bgr(frame, *dst)
    assert got.shape == (*dst, 3)
    np.testing.assert_array_equal(got, native_on.resize_bgr(frame, *dst))
    np.testing.assert_array_equal(got, resize_bgr_host(frame, *dst))


@pytest.mark.parametrize("hw", [(1080, 1920), (512, 512), (36, 50), (4, 2)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_bgr_to_i420_is_byte_equal(native_on, hw):
    frame = _frame(hw, hw[1])
    got = native.bgr_to_i420(frame)
    np.testing.assert_array_equal(got, native_on.bgr_to_i420(frame))
    np.testing.assert_array_equal(got, bgr_to_i420_host(frame))


@pytest.mark.parametrize("hw,grid", [((1080, 1920), (16, 16)),
                                     ((97, 131), (16, 16)),
                                     ((1, 1), (16, 16)),
                                     ((33, 47), (5, 7))],
                         ids=["1080p", "97x131", "1x1", "33x47-5x7"])
def test_luma_grid_is_byte_equal(native_on, hw, grid):
    frame = _frame(hw, hw[0] * 3 + grid[1])
    got = native.luma_grid(frame, *grid)
    assert got.shape == grid and got.dtype == np.uint8
    np.testing.assert_array_equal(got, native_on.luma_grid(frame, *grid))
    np.testing.assert_array_equal(got, luma_grid_host(frame, *grid))


def test_a_strided_frame_takes_the_numpy_copy(native_on):
    """A frame that is not C-contiguous never reaches the library (as in
    the reference); the bytes are the same either way."""
    frame = _frame((96, 256), 4)[:, ::2]
    assert not frame.flags.c_contiguous
    np.testing.assert_array_equal(native.resize_bgr_to_i420(frame, 64, 64),
                                  native_on.resize_bgr_to_i420(
                                      np.ascontiguousarray(frame), 64, 64))


@pytest.mark.parametrize("call", [
    lambda f: native.resize_bgr_to_i420(f, 30, 16),  # height % 4
    lambda f: native.resize_bgr_to_i420(f, 32, 15),  # width % 2
    lambda f: native.bgr_to_i420(f[:, :63]),
    lambda f: native.resize_bgr(f.astype(np.float32), 8, 8),
    lambda f: native.resize_bgr(f[..., :2], 8, 8),
    lambda f: native.luma_grid(f, 0, 16),
], ids=["i420-height", "i420-width", "i420-odd-frame", "float-frame",
        "two-channels", "empty-grid"])
def test_what_the_c_code_cannot_check_is_refused(native_on, call):
    """Sizes and layouts the library would read or write out of
    bounds raise before any pointer is passed."""
    with pytest.raises(ValueError):
        call(_frame((64, 64), 8))


def test_four_threads_at_once_give_the_same_bytes(native_on):
    frames = [_frame((1080, 1920), 10 + i) for i in range(4)]
    want = [resize_bgr_to_i420_host(f, 512, 512) for f in frames]
    grids = [luma_grid_host(f) for f in frames]
    bad: list[int] = []
    start = threading.Barrier(4)

    def work(i: int) -> None:
        start.wait()
        for _ in range(5):
            if not (np.array_equal(native.resize_bgr_to_i420(
                    frames[i], 512, 512), want[i])
                    and np.array_equal(native.luma_grid(frames[i]),
                                       grids[i])):
                bad.append(i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


# ------------------------------------------------------------ policy

POLICY_CASES = [({"EVAM_NO_NATIVE": "0"}, 8), ({"EVAM_NO_NATIVE": "1"}, 8),
                ({"EVAM_NATIVE": "1"}, 2), ({}, 2), ({}, 8),
                ({"EVAM_NO_NATIVE": "1", "EVAM_NATIVE": "1"}, 8)]


@pytest.mark.parametrize("env,cores", POLICY_CASES,
                         ids=["no_native=0", "no_native=1", "native-2cores",
                              "2cores", "8cores", "both"])
def test_policy_is_the_references(ref_lib, monkeypatch, env, cores):
    for var in ("EVAM_NO_NATIVE", "EVAM_NATIVE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr("os.cpu_count", lambda: cores)
    # the reference reads EVAM_NO_NATIVE where it loads its library
    monkeypatch.setattr(ref_lib, "_tried", False)
    monkeypatch.setattr(ref_lib, "_lib", None)
    want = ref_lib._use_native()
    assert want == (not env.get("EVAM_NO_NATIVE")
                    and (bool(env.get("EVAM_NATIVE")) or cores >= 4))
    assert native._use_native() is want
    assert native.available() is (not env.get("EVAM_NO_NATIVE"))


def test_policy_off_runs_the_numpy_copies(monkeypatch):
    """With EVAM_NO_NATIVE the library is never loaded: each function
    is its numpy copy."""
    monkeypatch.setenv("EVAM_NO_NATIVE", "1")

    def refuse():
        raise AssertionError("loaded the library with EVAM_NO_NATIVE set")

    monkeypatch.setattr(native, "_load", refuse)
    frame = _frame((97, 131), 5)
    np.testing.assert_array_equal(native.resize_bgr_to_i420(frame, 64, 64),
                                  resize_bgr_to_i420_host(frame, 64, 64))
    np.testing.assert_array_equal(native.resize_bgr(frame, 33, 47),
                                  resize_bgr_host(frame, 33, 47))
    np.testing.assert_array_equal(native.luma_grid(frame),
                                  luma_grid_host(frame))


# ------------------------------------------------------------- build

@pytest.fixture
def private_build(monkeypatch, tmp_path):
    """The module's build directory and loaded library moved aside."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("EVAM_NATIVE_LIB", raising=False)
    monkeypatch.delenv("EVAM_NO_NATIVE", raising=False)
    monkeypatch.setenv("EVAM_NATIVE", "1")
    return tmp_path


def test_builds_once_into_build_native_keyed_on_the_source(private_build,
                                                         monkeypatch):
    first = native.build()
    path = Path(first["path"])
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert path.name.startswith("libevam_media_") and first["seconds"] > 0
    assert native.build() == {"path": str(path), "seconds": 0.0, "log": ""}
    assert not list(native.BUILD_DIR.glob("*.tmp"))
    assert native._use_native() and native._lib is not None
    # another source is another library
    src = private_build / "evam_media.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != path


def test_a_missing_compiler_raises(private_build, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(private_build / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    with pytest.raises(RuntimeError, match="not found"):
        native.resize_bgr_to_i420(_frame((64, 64), 1), 32, 32)
    assert native._lib is None


def test_a_source_that_does_not_compile_raises_with_its_output(
        private_build, monkeypatch):
    src = private_build / "broken.cpp"
    src.write_text("int evam_native_version( { return 2; }\n")
    monkeypatch.setattr(native, "SOURCE", src)
    with pytest.raises(RuntimeError, match="failed") as info:
        native.build()
    assert "error" in str(info.value)
    assert not list(native.BUILD_DIR.glob("*"))


def test_evam_native_lib_loads_a_prebuilt_library(private_build,
                                                  monkeypatch, ref_lib):
    """EVAM_NATIVE_LIB names the library to load (here the reference's
    own build: the same symbols and version) and nothing is built."""
    monkeypatch.setenv("EVAM_NATIVE_LIB", str(ref_lib._LIB_PATHS[0]))
    monkeypatch.setattr(native, "build", lambda: pytest.fail("built"))
    frame = _frame((97, 131), 6)
    np.testing.assert_array_equal(native.resize_bgr_to_i420(frame, 64, 64),
                                  resize_bgr_to_i420_host(frame, 64, 64))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("EVAM_NATIVE_LIB", str(private_build / "absent.so"))
    with pytest.raises(RuntimeError, match="failed to load"):
        native.resize_bgr(frame, 33, 47)


# -------------------------------------------------- through the stack

def test_gated_detect_path_is_the_same_with_the_policy_on_and_off(
        monkeypatch):
    """A gated detect stage over a moving scene, source 96×128 resized
    to the engine's 64×64: the same gate decisions and the same regions
    with the library on and off."""
    from evam_tpu_torch.engine.hub import EngineHub
    from evam_tpu_torch.media.source import SyntheticSource
    from evam_tpu_torch.models.registry import ModelRegistry
    from evam_tpu_torch.stages import gate as tgate
    from evam_tpu_torch.stages.context import FrameContext
    from evam_tpu_torch.stages.infer import DetectStage

    hub = EngineHub(ModelRegistry(device="cpu", allow_random_weights=True,
                                  input_overrides={KEY: (64, 64)},
                                  width_overrides={KEY: 8}),
                    device="cpu", max_batch=4, deadline_ms=1.0,
                    stall_timeout_s=0)
    frames = [ev.frame for ev in SyntheticSource(
        128, 96, count=24, seed=3).frames()]
    frames[12:16] = [frames[11]] * 4  # a static stretch the gate skips

    def run(env: dict[str, str]) -> tuple[list, list]:
        for var in ("EVAM_NO_NATIVE", "EVAM_NATIVE"):
            monkeypatch.delenv(var, raising=False)
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        stage = DetectStage("det", KEY, {"threshold": 0.0,
                                         "inference-interval": "adaptive"},
                            hub)
        decisions, regions = [], []
        for i, frame in enumerate(frames):
            ctx = FrameContext(frame=frame, pts_ns=i, seq=i, stream_id="s0")
            fut = stage.submit(ctx)
            decisions.append(fut is not None)
            stage.complete(ctx, None if fut is None else fut.result(60))
            regions.append([(r.x0, r.y0, r.x1, r.y1, r.confidence, r.label_id)
                            for r in ctx.regions])
        return decisions, regions

    try:
        tgate.registry.reset()
        on = run({"EVAM_NATIVE": "1"})
        off = run({"EVAM_NO_NATIVE": "1"})
    finally:
        hub.stop()
        tgate.registry.reset()
    assert on == off
    assert any(on[0]) and not all(on[0])  # the gate ran and skipped
