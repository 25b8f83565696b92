"""The port's fault injector (``evam_tpu_torch/obs/faults.py``) against
the reference's (``evam_tpu/obs/faults.py``), on the CPU.

* For each spec key, the same spec and seed give the same decision
  sequence in both packages: ``apply`` over seeded numpy frames (the
  same drops, injected errors and corrupted rows, byte for byte),
  ``maybe_wedge``, ``maybe_shard_loss``, ``maybe_ckpt_corrupt``,
  ``maybe_double_fault`` and ``maybe_restore_stall`` in a fixed order,
  with the injectors' random states equal after every consult (stalls
  and wedges of 0 s, so nothing sleeps).
* Malformed and unknown entries are ignored in both: the parsed fields
  and ``active`` are equal.
* ``from_env`` / ``current`` / ``reset_cache`` memoize as the
  reference's do: one injector per (spec, seed), its ``wedge_n``
  countdown shared until ``reset_cache``.
"""

from __future__ import annotations

import numpy as np
import pytest

from evam_tpu.obs import faults as ref_faults
from evam_tpu_torch.obs import faults as port_faults

#: a spec that exercises each key (stalls and wedges sleep 0 s or 1 ms)
SPECS = {
    "drop": "drop=0.3",
    "stall": "stall=0.4,stall_ms=0",
    "stall_ms": "stall=1,stall_ms=1",
    "corrupt": "corrupt=0.5",
    "error": "error=0.3",
    "wedge": "wedge=0.5,wedge_s=0",
    "wedge_s": "wedge=1,wedge_s=0.001,wedge_n=2",
    "wedge_n": "wedge=1,wedge_n=3,wedge_s=0",
    "shard_loss": "shard_loss=0.4",
    "shard_loss_n": "shard_loss=1,shard_loss_n=2",
    "ckpt_corrupt": "ckpt_corrupt=0.5",
    "double_fault": "double_fault=0.5",
    "restore_ms": "restore_ms=1",
}


def _decisions(inj, frames: list[np.ndarray]) -> list:
    """Every consult of the injector in a fixed order, with its outcome
    and the random state after it."""
    out = []
    for frame in frames:
        try:
            got = inj.apply(frame)
            outcome = "drop" if got is None else got.tobytes()
        except RuntimeError as exc:
            outcome = f"error: {exc}"
        wedge_left = inj._wedge_left
        inj.maybe_wedge("engine")
        out.append((outcome, wedge_left, inj._wedge_left,
                    inj.maybe_shard_loss("s0"), inj._shard_loss_left,
                    inj.maybe_ckpt_corrupt(), inj.maybe_double_fault()))
        inj.maybe_restore_stall()
        out.append(inj._rng.getstate())
    return out


def test_the_key_tables_equal_the_references():
    assert port_faults.SPEC_KEYS == ref_faults.SPEC_KEYS
    assert port_faults.ENV_KEYS == ref_faults.ENV_KEYS
    assert set(SPECS) == set(ref_faults.SPEC_KEYS)


@pytest.mark.parametrize("key", list(SPECS))
def test_spec_key_decides_as_the_reference(key):
    spec = SPECS[key]
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (12, 8, 3), dtype=np.uint8)
              for _ in range(40)]
    ref = ref_faults.FaultInjector(spec, seed=11)
    got = port_faults.FaultInjector(spec, seed=11)
    assert got.active == ref.active is True
    want = _decisions(ref, [f.copy() for f in frames])
    assert _decisions(got, [f.copy() for f in frames]) == want
    # the spec took effect: something other than pass-through happened
    kinds = {o[0] if isinstance(o[0], str) else "frame"
             for o in want[::2]}
    if key in ("drop", "error"):
        assert key in {k.split(":")[0] for k in kinds}
    if key == "corrupt":
        assert any(o[0] != f.tobytes() for o, f in zip(want[::2], frames))


@pytest.mark.parametrize("spec", [
    "drop=0.5,bogus=1,stall=abc,,=3,error",
    "wedge=1,wedge_n=x,unknown_key=0.2",
    "  corrupt = 0.25 , drop=",
    "",
], ids=["mixed", "bad-count", "spaces", "empty"])
def test_malformed_and_unknown_entries_are_ignored_alike(spec):
    ref = ref_faults.FaultInjector(spec, seed=1)
    got = port_faults.FaultInjector(spec, seed=1)
    fields = [k for k in vars(ref) if k not in ("_rng", "_lock")]
    assert fields == [k for k in vars(got) if k not in ("_rng", "_lock")]
    assert {k: getattr(got, k) for k in fields} == \
        {k: getattr(ref, k) for k in fields}
    assert got.active == ref.active


def test_from_env_memoizes_one_injector_per_spec(monkeypatch):
    monkeypatch.setenv("EVAM_FAULT_INJECT", "wedge=1,wedge_n=1,wedge_s=0")
    monkeypatch.setenv("EVAM_FAULT_SEED", "7")
    for mod in (ref_faults, port_faults):
        mod.reset_cache()
        inj = mod.current()
        assert inj is mod.from_env() is mod.current()
        inj.maybe_wedge("e")
        assert inj._wedge_left == 0
        assert mod.current()._wedge_left == 0  # shared countdown
        mod.reset_cache()
        assert mod.current() is not inj
        assert mod.current()._wedge_left == 1
        monkeypatch.setenv("EVAM_FAULT_INJECT", "")
        mod.reset_cache()
        assert mod.current() is None
        monkeypatch.setenv("EVAM_FAULT_INJECT", "wedge=1,wedge_n=1,wedge_s=0")
        mod.reset_cache()
    monkeypatch.setenv("EVAM_FAULT_SEED", "not-a-number")
    for mod in (ref_faults, port_faults):
        mod.reset_cache()
        assert mod.current() is not None  # an unseeded injector
        mod.reset_cache()


def test_a_wedge_under_steady_load_trips_the_watchdog(monkeypatch):
    """The port's engine consults the injector per batch: armed while
    four threads keep batches overlapping, the wedge strands the head
    of the device queue and the watchdog trips within its budget (plus
    its tick), not after the wedge ends — the stall deadline does not
    ratchet up with every batch dispatched while another is in flight.
    """
    import threading
    import time

    from evam_tpu_torch.engine.batcher import BatchEngine

    def step(x):
        time.sleep(0.005)
        return x.float() * 2

    eng = BatchEngine("faults-steady", step, "cpu", input_names=("x",),
                      max_batch=4, deadline_ms=1.0, stall_timeout_s=0.5)
    stop = threading.Event()

    def feed():
        while not stop.is_set():
            try:
                eng.submit(x=np.zeros((3,), np.float32)).result(timeout=10)
            except Exception:  # noqa: BLE001 — failed once stalled
                time.sleep(0.01)

    threads = [threading.Thread(target=feed) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)  # steady, overlapping batches
        assert eng.stats.batches > 20 and not eng.stalled.is_set()
        monkeypatch.setenv("EVAM_FAULT_INJECT", "wedge=1,wedge_n=1,wedge_s=8")
        monkeypatch.setenv("EVAM_FAULT_SEED", "7")
        port_faults.reset_cache()
        t_arm = time.perf_counter()
        while not eng.stalled.is_set() and time.perf_counter() - t_arm < 8:
            time.sleep(0.01)
        # the budget and a 0.2 s tick, with room for a loaded host; the
        # wedge itself lasts 8 s
        assert eng.stalled.is_set()
        assert time.perf_counter() - t_arm < 4.0
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        eng.abandon()
        port_faults.reset_cache()
