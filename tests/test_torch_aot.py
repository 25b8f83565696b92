"""The port's AOT cache (``evam_tpu_torch/aot/``, EVAM_AOT) on the CPU.

The classes of the reference's ``tests/test_aot.py``, held to the
reference where it is pure Python: the content-addressed key and the
entry bytes equal the reference's on the same fields; every rung of the
fallback ladder (absent / version / crc / deserialize / execute) lands
on its counter, in ``summary()`` and in the metric, and recovers; the
size-capped store evicts oldest first; with EVAM_AOT off (the default)
``active()`` is None once and for all and ``summary()`` is the
reference's ``disabled_summary()``.

The ladder runs with a real library payload: a tiny C library built
with ``g++`` (no ``nvcc`` here) and loaded through the same store path
as the hand kernels' libraries (``ops/kernels.py``). A CPU engine
compiles nothing: with the cache on it makes no entry, no hit and no
miss, and gives the bits it gives with the cache off.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu.aot import cache as ref_cache
from evam_tpu_torch import aot
from evam_tpu_torch.aot.cache import (
    MAGIC,
    MISS_REASONS,
    AotCache,
    _EntryError,
    _pack_entry,
    _unpack_entry,
    cache_key,
    disabled_summary,
    env_fingerprint,
)
from evam_tpu_torch.config.settings import reset_settings
from evam_tpu_torch.engine.batcher import BatchEngine, EngineStats
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs import trace
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.ops import kernels

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

_KEY_ARGS = dict(
    program="detect:m|wire=i420|synth=0|ragged=off|ub=0|sched=0",
    bucket=8,
    inputs=[("frames", (8, 64, 64, 3), "uint8")],
    params_sig=[((4, 4), "float32")],
    devices=["NVIDIA H100 80GB HBM3|sm_90"],
    donate=(),
    backend="cuda",
)
_AOT_VARS = ("EVAM_AOT", "EVAM_AOT_DIR", "EVAM_AOT_MAX_BYTES",
             "EVAM_COMPILE_CACHE_DIR")


def _fresh(monkeypatch, tmp_path=None, **env: str) -> None:
    """Reset the memoized cache and settings under a controlled env."""
    for var in _AOT_VARS:
        monkeypatch.delenv(var, raising=False)
    if tmp_path is not None:
        monkeypatch.setenv("EVAM_AOT", "1")
        monkeypatch.setenv("EVAM_AOT_DIR", str(tmp_path))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reset_settings()
    aot.reset_cache()


@pytest.fixture(autouse=True)
def _restore_memos():
    yield
    reset_settings()
    aot.reset_cache()


def test_exports_every_name_of_the_reference():
    from evam_tpu import aot as ref_aot

    names = {n for n in vars(ref_aot) if not n.startswith("_")} - {"cache"}
    assert names == {"AotCache", "MISS_REASONS", "active", "cache_key",
                     "disabled_summary", "reset_cache", "summary"}
    for name in names:
        assert hasattr(aot, name), name
    assert MISS_REASONS == ref_cache.MISS_REASONS
    assert MAGIC == ref_cache.MAGIC
    assert AotCache.SHARED_UNDER == ref_cache.AotCache.SHARED_UNDER


# ------------------------------------------------------------- the key


class TestCacheKey:
    @pytest.mark.parametrize("seed", range(6))
    def test_key_is_the_references(self, seed):
        rng = np.random.default_rng(seed)
        n_in = int(rng.integers(0, 4))
        args = dict(
            program=f"prog-{rng.integers(1 << 30)}|wire=i420",
            bucket=int(rng.integers(0, 256)),
            inputs=[(f"in{i}", tuple(int(d) for d in rng.integers(
                1, 64, size=int(rng.integers(0, 4)))),
                rng.choice(["uint8", "float32", "int32"]))
                for i in range(n_in)],
            params_sig=[(tuple(int(d) for d in rng.integers(1, 9, size=2)),
                         "bfloat16") for _ in range(int(rng.integers(0, 3)))],
            devices=[f"dev{int(d)}" for d in rng.integers(
                0, 8, size=int(rng.integers(1, 3)))],
            donate=tuple(int(d) for d in rng.integers(
                0, 4, size=int(rng.integers(0, 3)))),
            backend=str(rng.choice(["cuda", "cpu", "tpu"])))
        assert cache_key(**args) == ref_cache.cache_key(**args)

    def test_stable_across_process_restarts(self):
        """The content address must not depend on process state (hash
        seeds, dict order, id()s): a restarted server has to find the
        libraries the previous life stored."""
        code = ("from evam_tpu_torch.aot.cache import cache_key\n"
                f"print(cache_key(**{_KEY_ARGS!r}))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, PYTHONHASHSEED="123"),
                             check=True)
        assert out.stdout.strip() == cache_key(**_KEY_ARGS)

    @pytest.mark.parametrize("field,value", [
        ("program", "other-program"),
        ("bucket", 16),
        ("inputs", [("frames", (8, 64, 64, 3), "float32")]),
        ("params_sig", [((8, 4), "float32")]),
        ("devices", ["NVIDIA H200|sm_90"]),
        ("donate", (1,)),
        ("backend", "cpu"),
    ])
    def test_every_field_addresses_a_different_entry(self, field, value):
        changed = dict(_KEY_ARGS, **{field: value})
        assert cache_key(**changed) != cache_key(**_KEY_ARGS)
        assert cache_key(**changed) == ref_cache.cache_key(**changed)

    def test_library_key_names_source_flags_and_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda i: (9, 0))
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i: "NVIDIA H100 80GB HBM3")
        keys = {name: kernels.aot_key(name) for name in kernels.SOURCES}
        assert len(set(keys.values())) == len(kernels.SOURCES)
        assert keys["qgemm"] == ref_cache.cache_key(
            program=kernels._program("qgemm"), bucket=0, inputs=(),
            params_sig=(), devices=("NVIDIA H100 80GB HBM3|sm_90",),
            donate=(), backend="cuda")
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda i: (10, 0))
        assert kernels.aot_key("qgemm") != keys["qgemm"]
        monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
        assert "-G" in kernels._program("qgemm")


# ----------------------------------------------------- the entry format


class TestEntryFormat:
    @pytest.mark.parametrize("header,payload", [
        ({"torch": "2.5.1", "cuda": "12.4", "driver": "550.54.15",
          "device": "NVIDIA H100 80GB HBM3", "capability": "9.0",
          "nvcc": "Cuda compilation tools, release 12.4, V12.4.131"},
         bytes(range(256)) * 5),
        ({"jax": "x"}, b"payload-bytes"),
        ({}, b""),
    ])
    def test_entry_bytes_are_the_references(self, header, payload):
        blob = _pack_entry(header, payload)
        assert blob == ref_cache._pack_entry(header, payload)
        assert _unpack_entry(blob) == (header, payload)
        assert ref_cache._unpack_entry(blob) == (header, payload)

    @pytest.mark.parametrize("mangle", [
        lambda blob: b"NOTMAGIC" + blob[8:],      # wrong magic
        lambda blob: blob[:20],                   # truncated header
        lambda blob: blob[:-3],                   # truncated payload
        lambda blob: blob[:-1] + b"\x00",         # payload bit rot
    ], ids=["magic", "header", "payload", "bitrot"])
    def test_structural_damage_reads_as_crc_in_both(self, mangle):
        blob = mangle(_pack_entry({"jax": "x"}, b"payload-bytes"))
        with pytest.raises(_EntryError) as exc:
            _unpack_entry(blob)
        assert exc.value.reason == "crc"
        with pytest.raises(ref_cache._EntryError) as ref_exc:
            ref_cache._unpack_entry(blob)
        assert ref_exc.value.reason == "crc"

    def test_fingerprint_reads_without_nvcc(self, monkeypatch):
        monkeypatch.setenv("PATH", "/nonexistent")
        fp = env_fingerprint()
        assert set(fp) == {"torch", "cuda", "driver", "device", "capability"}
        assert fp["torch"] == torch.__version__


# ------------------------------------------------- the fallback ladder


_TINY = """
int evam_answer(void) { return 42; }
int evam_self_test(void) { return %d; }
const char* evam_cuda_error_string(int code) { return "no error"; }
"""


def _gxx(src: str, out: Path) -> Path:
    c = out.with_suffix(".c")
    c.write_text(src)
    subprocess.run(["g++", "-x", "c", "-shared", "-fPIC", "-O1", "-o",
                    str(out), str(c)], check=True, timeout=120)
    return out


@pytest.fixture(scope="module")
def tiny_libs(tmp_path_factory):
    """A library whose self-test passes, and one whose self-test fails."""
    root = tmp_path_factory.mktemp("tiny")
    return {"good": _gxx(_TINY % 0, root / "libtiny_good.so"),
            "bad": _gxx(_TINY % 1, root / "libtiny_bad.so")}


def _self_test(lib) -> None:
    if lib.evam_self_test() != 0 or lib.evam_answer() != 42:
        raise RuntimeError("tiny self-test failed")


class _Builds:
    """The ``build_fn`` of the store path: counts each build."""

    def __init__(self, path: Path):
        self.path = path
        self.n = 0

    def __call__(self) -> str:
        self.n += 1
        return str(self.path)


def _misses(reason: str, engine: str = "tiny") -> float:
    return metrics.get_counter("evam_aot_cache_misses",
                               labels={"engine": engine, "reason": reason})


class TestFallbackLadder:
    """Every rung lands on its counter and recovers: the library is
    built, stored and served — the cache can cost disk, never serving."""

    KEY = "ab" * 32

    def _populate(self, root: Path, tiny_libs) -> AotCache:
        cache = AotCache(root, max_bytes=1 << 30)
        build = _Builds(tiny_libs["good"])
        lib, stored = kernels._through_store(cache, "tiny", self.KEY, build,
                                             _self_test)
        assert stored and build.n == 1 and lib.evam_answer() == 42
        return cache

    def _entry(self, root: Path) -> Path:
        return root / f"{self.KEY}.aotx"

    def _check_counts(self, cache: AotCache, before: dict[str, float],
                      reason: str, n: int = 1) -> None:
        s = cache.summary()
        assert s["misses"] == {r: n if r == reason else 0
                               for r in MISS_REASONS}
        for r in MISS_REASONS:
            assert _misses(r) - before[r] == s["misses"][r], r

    def _before(self) -> dict[str, float]:
        return {r: _misses(r) for r in MISS_REASONS}

    def test_store_then_hit_from_a_second_cache(self, tmp_path, tiny_libs):
        hits0 = metrics.get_counter("evam_aot_cache_hits",
                                    labels={"engine": "tiny"})
        before = self._before()
        first = self._populate(tmp_path, tiny_libs)
        self._check_counts(first, before, "absent")
        header, payload = _unpack_entry(self._entry(tmp_path).read_bytes())
        assert payload == tiny_libs["good"].read_bytes()
        assert {k: header[k] for k in env_fingerprint()} == env_fingerprint()
        assert "nvcc" in header
        # a second process's cache on the same directory: a hit, no build
        second = AotCache(tmp_path, max_bytes=1 << 30)
        build = _Builds(tiny_libs["good"])
        lib, stored = kernels._through_store(second, "tiny", self.KEY,
                                             build, _self_test)
        assert stored and build.n == 0 and lib.evam_answer() == 42
        assert second.summary()["hits"] == 1
        assert second.summary()["misses"] == dict.fromkeys(MISS_REASONS, 0)
        assert metrics.get_counter("evam_aot_cache_hits",
                                   labels={"engine": "tiny"}) == hits0 + 1
        # the loaded copy is not left beside the entries
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            f"{self.KEY}.aotx"]

    def test_absent_miss_builds_and_stores(self, tmp_path, tiny_libs):
        cache = AotCache(tmp_path, max_bytes=1 << 30)
        before = self._before()
        assert cache.load(self.KEY, engine="tiny") is None
        self._check_counts(cache, before, "absent")
        assert cache.summary()["entries"] == 0

    def test_crc_damage_is_discarded_then_rebuilt(self, tmp_path, tiny_libs):
        self._populate(tmp_path, tiny_libs)
        blob = self._entry(tmp_path).read_bytes()
        self._entry(tmp_path).write_bytes(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
        cache = AotCache(tmp_path, max_bytes=1 << 30)
        before = self._before()
        assert cache.load(self.KEY, engine="tiny") is None
        self._check_counts(cache, before, "crc")
        assert not self._entry(tmp_path).exists()  # discarded
        build = _Builds(tiny_libs["good"])
        lib, stored = kernels._through_store(cache, "tiny", self.KEY, build,
                                             _self_test)
        assert build.n == 1 and stored and lib.evam_answer() == 42
        assert _unpack_entry(self._entry(tmp_path).read_bytes())[1] == \
            tiny_libs["good"].read_bytes()

    def test_version_skew_is_kept_then_replaced(self, tmp_path, tiny_libs):
        self._populate(tmp_path, tiny_libs)
        header, payload = _unpack_entry(self._entry(tmp_path).read_bytes())
        header["driver"] = "0.0.0-another-driver"
        skewed = _pack_entry(header, payload)
        self._entry(tmp_path).write_bytes(skewed)
        cache = AotCache(tmp_path, max_bytes=1 << 30)
        before = self._before()
        assert cache.load(self.KEY, engine="tiny") is None
        self._check_counts(cache, before, "version")
        assert self._entry(tmp_path).read_bytes() == skewed  # kept
        build = _Builds(tiny_libs["good"])
        lib, stored = kernels._through_store(cache, "tiny", self.KEY, build,
                                             _self_test)
        assert build.n == 1 and stored and lib.evam_answer() == 42
        self._check_counts(cache, before, "version", n=2)
        assert _unpack_entry(self._entry(tmp_path).read_bytes())[0][
            "driver"] == env_fingerprint()["driver"]

    def test_payload_that_will_not_load_is_a_deserialize_miss(
            self, tmp_path, tiny_libs):
        self._populate(tmp_path, tiny_libs)
        cache = AotCache(tmp_path, max_bytes=1 << 30)
        # valid frame, valid CRC, current header — not an ELF
        cache.store(self.KEY, b"not a shared library" * 64)
        before = self._before()
        build = _Builds(tiny_libs["good"])
        seen = []
        cache._discard = seen.append
        lib, stored = kernels._through_store(cache, "tiny", self.KEY, build,
                                             _self_test)
        self._check_counts(cache, before, "deserialize")
        assert seen == [self._entry(tmp_path)]
        assert build.n == 1 and stored and lib.evam_answer() == 42
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            f"{self.KEY}.aotx"]

    def test_library_that_fails_its_self_test_is_an_execute_miss(
            self, tmp_path, tiny_libs):
        self._populate(tmp_path, tiny_libs)
        cache = AotCache(tmp_path, max_bytes=1 << 30)
        cache.store(self.KEY, tiny_libs["bad"].read_bytes())
        before = self._before()
        build = _Builds(tiny_libs["good"])
        seen = []
        real_discard = cache._discard

        def discard(path):
            seen.append(path)
            real_discard(path)

        cache._discard = discard
        lib, stored = kernels._through_store(cache, "tiny", self.KEY, build,
                                             _self_test)
        self._check_counts(cache, before, "execute")
        assert seen == [self._entry(tmp_path)]
        # rebuilt, stored, served: never the failing library
        assert build.n == 1 and stored
        assert lib.evam_self_test() == 0
        assert cache.summary()["hits"] == 0
        assert _unpack_entry(self._entry(tmp_path).read_bytes())[1] == \
            tiny_libs["good"].read_bytes()


# ---------------------------------------------------------- LRU store


class TestEviction:
    def _fake_entry(self, root, name: str, size: int, mtime: float):
        p = root / f"{name}.aotx"
        p.write_bytes(b"z" * size)
        os.utime(p, (mtime, mtime))
        return p

    def test_oldest_evicted_first_newest_survives(self, tmp_path):
        cache = AotCache(tmp_path, max_bytes=250)
        old = self._fake_entry(tmp_path, "a" * 8, 100, 1_000.0)
        mid = self._fake_entry(tmp_path, "b" * 8, 100, 2_000.0)
        new = self._fake_entry(tmp_path, "c" * 8, 100, 3_000.0)
        cache._evict()
        assert not old.exists()
        assert mid.exists() and new.exists()
        assert cache.summary()["evictions"] == 1
        assert metrics.get_gauge("evam_aot_cache_bytes") == 200.0

    def test_single_over_cap_entry_never_thrashes(self, tmp_path):
        cache = AotCache(tmp_path, max_bytes=10)
        only = self._fake_entry(tmp_path, "d" * 8, 100, 1_000.0)
        cache._evict()
        assert only.exists()  # the newest entry always survives
        assert cache.summary()["evictions"] == 0

    def test_store_respects_the_knobs_cap(self, monkeypatch, tmp_path,
                                          tiny_libs):
        # a cap under one library's entry: every store evicts down to
        # the newest entry
        _fresh(monkeypatch, tmp_path, EVAM_AOT_MAX_BYTES="1")
        cache = aot.active()
        assert cache.max_bytes == 1
        payloads = [p.read_bytes() for p in tiny_libs.values()]
        for i, payload in enumerate(payloads):
            assert cache.store(f"{i:064x}", payload)
            os.utime(cache._path(f"{i:064x}"), (1_000.0 + i, 1_000.0 + i))
        s = cache.summary()
        assert s["entries"] == 1 and s["evictions"] == len(payloads) - 1
        assert cache._path(f"{len(payloads) - 1:064x}").exists()


# ----------------------------------------------------------- off path


class TestOffPath:
    def test_off_resolves_to_none_and_memoizes(self, monkeypatch):
        _fresh(monkeypatch)
        assert aot.active() is None
        assert aot.cache._resolved == (None,)
        assert aot.summary() == ref_cache.disabled_summary() \
            == disabled_summary()

    def test_summary_shape_is_the_golden_contract(self, monkeypatch,
                                                  tmp_path):
        _fresh(monkeypatch, tmp_path)
        live = aot.summary()
        assert live["enabled"] is True and live["max_bytes"] == 1 << 30
        assert set(live) == set(ref_cache.disabled_summary())
        assert set(live["misses"]) == set(MISS_REASONS)
        assert aot.active() is aot.active()
        assert aot.active().root == tmp_path

    def test_default_directory_is_under_tmpdir(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        monkeypatch.setattr("tempfile.tempdir", None)
        _fresh(monkeypatch, EVAM_AOT="1")
        assert aot.active().root == tmp_path / "evam_aot"


# ---------------------------------------------------------- engines


def _toy_engine(name: str, **kw) -> BatchEngine:
    kwargs = dict(device="cpu", max_batch=4, deadline_ms=4.0,
                  input_names=("x",), stall_timeout_s=0,
                  aot_key="aot-test|toy")
    kwargs.update(kw)
    return BatchEngine(name, lambda x: x * 2.0 + 1.0, **kwargs)


def _run_values(eng, values) -> list[np.ndarray]:
    futs = [eng.submit(x=np.full((2,), v, np.float32)) for v in values]
    return [f.result(timeout=30) for f in futs]


def _warm_and_run(name: str, **kw) -> tuple[BatchEngine, list[np.ndarray]]:
    eng = _toy_engine(name, **kw)
    eng.set_example(x=np.zeros((2,), np.float32))
    eng.warmup()
    return eng, _run_values(eng, [float(i) for i in range(9)])


class TestEngines:
    def test_cpu_engine_with_the_cache_on_equals_off(self, monkeypatch,
                                                     tmp_path):
        _fresh(monkeypatch)
        off, want = _warm_and_run("aot-cpu-off")
        off.stop()
        _fresh(monkeypatch, tmp_path)
        on, got = _warm_and_run("aot-cpu-on")
        on.stop()
        for a, b in zip(want, got):
            assert a.tobytes() == b.tobytes()
        assert (on.stats.aot_hits, on.stats.aot_load_seconds) == (0, 0.0)
        assert on.stats.warm_forwards == len(on.buckets)
        s = aot.active().summary()
        assert (s["entries"], s["hits"]) == (0, 0)
        assert s["misses"] == dict.fromkeys(MISS_REASONS, 0)

    def test_engine_without_key_never_consults_the_cache(self, monkeypatch,
                                                         tmp_path):
        _fresh(monkeypatch, tmp_path)
        consulted = []
        monkeypatch.setattr(aot, "active", lambda: consulted.append(1))
        eng, _ = _warm_and_run("aot-nokey", aot_key=None)
        eng.stop()
        assert consulted == [] and eng.stats.aot_hits == 0
        assert not any(tmp_path.iterdir())

    def test_warm_attribution_on_a_capturing_engine(self, monkeypatch,
                                                    tmp_path):
        """The card's accounting, with the CUDA halves stubbed: a
        bucket whose warm run (the first one's library loads included)
        built a library is a miss (compile_s), one that built nothing
        with every library in the store a hit (aot.load_s)."""
        _fresh(monkeypatch, tmp_path)
        state = {"builds": 0, "loaded": set()}

        def load(name):
            if name not in state["loaded"]:
                state["loaded"].add(name)
                state["builds"] += 1
                time.sleep(0.01)

        monkeypatch.setattr(kernels, "load", load)
        monkeypatch.setattr(kernels, "builds", lambda: state["builds"])
        monkeypatch.setattr(kernels, "from_store",
                            lambda names: set(names) <= state["loaded"])

        class Graphs:
            timings: dict = {}

            def __init__(self):
                self.n = 0

            def capture(self, b, batch, lock):
                self.n += 1

            def pool_bytes(self):
                return 0

            def __len__(self):
                return self.n

        def warm(name: str, aot_key="aot-test|toy"):
            def step(x):
                return x

            step.libraries = ("qgemm",)
            eng = BatchEngine(name, step, "cpu", max_batch=8,
                              input_names=("x",), stall_timeout_s=0,
                              aot_key=aot_key)
            eng._cuda = eng._capturable = True
            eng._graphs = Graphs()
            eng.set_example(x=np.zeros((2,), np.float32))
            try:
                eng.warmup()
            finally:
                eng._cuda = False
                eng._graphs = None
            row = eng.stats_row()
            eng.stop()
            return eng, row

        cold, row = warm("aot-cold")
        assert state["loaded"] == {"engine_cuda", "qgemm"}
        n = len(cold.buckets)
        assert row["compiled_programs"] == n
        assert row["aot"]["hits"] == n - 1  # the loads were bucket 1's
        assert cold.stats.compile_seconds >= 0.02
        warm_eng, row = warm("aot-warm")
        assert row["aot"]["hits"] == row["compiled_programs"] == n
        assert row["compile_s"] == 0.0 and warm_eng.stats.aot_load_seconds > 0
        _, row = warm("aot-nokey", aot_key=None)
        assert row["aot"] == {"hits": 0, "load_s": 0.0}
        _fresh(monkeypatch)  # cache off: every bucket to compile_s
        off, row = warm("aot-off")
        assert row["aot"]["hits"] == 0 and off.stats.compile_seconds > 0

    def test_absorb_carries_the_aot_counters(self):
        a, b = EngineStats(), EngineStats()
        a.aot_hits, a.aot_load_seconds = 2, 0.5
        b.aot_hits, b.aot_load_seconds = 3, 0.25
        a.absorb(b)
        assert (a.aot_hits, a.aot_load_seconds) == (5, 0.75)

    def test_supervisor_rebuild_carries_the_aot_counters(self):
        release = threading.Event()

        def factory():
            eng = BatchEngine("aot-sup", lambda x: x.float(), "cpu",
                              max_batch=4, deadline_ms=1.0,
                              input_names=("x",), stall_timeout_s=0.5,
                              aot_key="aot-sup|toy")
            with eng._exec_lock:
                eng.stats.aot_hits += 4
                eng.stats.aot_load_seconds += 0.125
            return eng

        sup = SupervisedEngine("aot-sup", factory, max_restarts=3,
                               restart_window_s=60.0, backoff_s=0.05)
        try:
            sup.submit(x=np.zeros((3,), np.float32)).result(timeout=30)
            first = sup._engine
            first.pre_launch = lambda: release.wait(timeout=60)
            with pytest.raises(TimeoutError):
                sup.submit(x=np.zeros((3,), np.float32)).result(timeout=15)
            deadline = time.time() + 20
            while not (sup.state == "running" and sup.restarts == 1):
                assert time.time() < deadline, "no rebuild"
                time.sleep(0.02)
            row = sup.stats_row()
            assert sup._engine is not first
            assert row["aot"] == {"hits": 8, "load_s": 0.25}
            assert sup.stats.aot_hits == 8
        finally:
            release.set()
            sup.stop()

    def test_hub_passes_the_program_fingerprint_to_every_factory(self):
        registry = ModelRegistry(device="cpu", allow_random_weights=True,
                                 input_overrides={
                                     "object_detection/person_vehicle_bike":
                                         (64, 64)},
                                 width_overrides={
                                     "object_detection/person_vehicle_bike":
                                         8})
        key = "object_detection/person_vehicle_bike"
        hub = EngineHub(registry, device="cpu", max_batch=4,
                        ragged="packed", ragged_unit_budget=2)
        fleet = EngineHub(registry, devices=["cpu", "cpu"], fleet="sharded",
                          max_batch=4)
        try:
            eng = hub.engine("detect", key)
            want = (f"detect:{key}|wire=i420|synth=0|ragged=packed|ub=2"
                    "|sched=0")
            assert eng._engine._aot_key == want
            # a rebuild's factory carries the same fingerprint
            assert eng._factory()._aot_key == want
            rows = hub.stats()
            assert rows[f"detect:{key}"]["aot"] == {"hits": 0, "load_s": 0.0}
            fe = fleet.engine("detect", key)
            shards = [e for _, _, e in fe.shard_rows()]
            assert shards and all(
                s._engine._aot_key.startswith(f"detect:{key}|wire=i420|")
                for s in shards)
            assert all(r["aot"] == {"hits": 0, "load_s": 0.0}
                       for r in fleet.stats().values())
        finally:
            hub.stop()
            fleet.stop()


# ---------------------------------------------------------- kernels


def test_library_path_follows_the_compile_cache_dir(monkeypatch, tmp_path):
    _fresh(monkeypatch)
    for name in kernels.SOURCES:
        assert kernels.library_path(name).parent == kernels.BUILD_DIR
    _fresh(monkeypatch, EVAM_COMPILE_CACHE_DIR=str(tmp_path / "cc"))
    for name in kernels.SOURCES:
        path = kernels.library_path(name)
        assert path.parent == tmp_path / "cc"
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"


def test_init_observability_makes_the_compile_cache_dir(monkeypatch,
                                                        tmp_path):
    from evam_tpu_torch.config.settings import Settings

    target = tmp_path / "a" / "cc"
    settings = Settings.from_env(env={"EVAM_COMPILE_CACHE_DIR": str(target)})
    trace.init_observability(settings)
    assert target.is_dir()
    trace.stop_profiler()


def test_steps_name_the_libraries_they_launch(monkeypatch):
    from evam_tpu_torch.engine import steps
    from evam_tpu_torch.ops import qlinear

    key = "object_detection/person_vehicle_bike"
    over = dict(input_overrides={key: (64, 64)}, width_overrides={key: 8})
    int8 = ModelRegistry(device="cpu", allow_random_weights=True,
                         dtype="int8", **over).get(key)
    fp32 = ModelRegistry(device="cpu", allow_random_weights=True,
                         dtype="float32", **over).get(key)
    monkeypatch.setattr(qlinear, "QGEMM_BACKEND", "pallas")
    assert steps.build_detect_step(int8).libraries == ("qgemm",)
    assert steps.build_detect_step(fp32).libraries == ()
    monkeypatch.setattr(qlinear, "QGEMM_BACKEND", "xla")
    assert steps.build_detect_step(int8).libraries == ()


def test_healthz_aot_block_is_the_caches(monkeypatch, tmp_path):
    """/healthz ``aot`` is ``aot.summary()`` with the cache on and off,
    in the golden's shape."""
    from test_golden import canonical  # read-only use: never check_golden

    from evam_tpu_torch.config.settings import Settings
    from evam_tpu_torch.server.app import App
    from evam_tpu_torch.server.registry import PipelineRegistry

    golden = json.loads((REPO / "tests" / "golden"
                         / "route_healthz.json").read_text())
    for on in (False, True):
        _fresh(monkeypatch, tmp_path if on else None)
        registry = ModelRegistry(device="cpu", allow_random_weights=True)
        app = App(PipelineRegistry(
            Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu"),
            hub=EngineHub(registry, device="cpu")))
        try:
            resp = app.handle("GET", "/healthz", b"")
            health = json.loads(resp.body)
            assert resp.status == 200
            assert canonical(health) == golden
            assert health["aot"] == aot.summary()
            assert health["aot"]["enabled"] is on
        finally:
            app.registry.stop_all()


def test_loaded_library_copy_is_unlinked(tmp_path, tiny_libs):
    lib = kernels._dlopen_payload(tmp_path, "tiny", "cd" * 32,
                                  tiny_libs["good"].read_bytes())
    assert isinstance(lib, ctypes.CDLL) and lib.evam_answer() == 42
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(OSError):
        kernels._dlopen_payload(tmp_path, "tiny", "cd" * 32, b"\x7fELF junk")
    assert list(tmp_path.iterdir()) == []
