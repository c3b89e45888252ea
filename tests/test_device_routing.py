"""The one device decision (panmap_tpu/utils/device.py) and the routers that
consume it, plus the compile-cache location."""

import os

import numpy as np
import pytest

from panmap_tpu.utils import device as D


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,want", [("gpu", "device"), ("cpu", None),
                                           ("METAL", None)])
def test_device_mode_from_platform(monkeypatch, platform, want):
    import jax

    monkeypatch.delenv(D.ENV, raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)])
    assert D.device_mode() == want


@pytest.mark.parametrize("env,platform,want", [("0", "gpu", None),
                                               ("1", "cpu", "device"),
                                               ("1", "gpu", "device")])
def test_device_switch_overrides_platform(monkeypatch, env, platform, want):
    import jax

    monkeypatch.setenv(D.ENV, env)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)])
    assert D.device_mode() == want


def test_device_switch_rejects_other_values(monkeypatch):
    monkeypatch.setenv(D.ENV, "yes")
    with pytest.raises(ValueError):
        D.device_mode()


def test_forked_batch_worker_turns_the_device_off(monkeypatch):
    """The batch host-stage worker switches every routed stage off before
    it aligns (a forked child must not open its own device client)."""
    from panmap_tpu import pipeline
    from panmap_tpu.pipeline import PipelineConfig

    monkeypatch.setenv(D.ENV, "1")
    seen = {}

    def fake_alignment(cfg, tree, best_id):
        seen["mode"] = D.device_mode()
        return None, None

    monkeypatch.setattr(pipeline, "run_alignment", fake_alignment)
    monkeypatch.setitem(pipeline._BATCH_CTX, "tree", None)
    monkeypatch.setitem(pipeline._BATCH_CTX, "idx", None)
    monkeypatch.setitem(pipeline._BATCH_CTX, "cfg",
                        PipelineConfig(stop="align"))
    assert pipeline._batch_host_stages(("r1", "", "out", "n1")) == "out"
    assert seen["mode"] is None
    assert os.environ[D.ENV] == "0"


def test_routers_consume_the_decision(monkeypatch):
    """BatchAligner, the long-read aligner and --device-pileup auto all ask
    device_mode(); nothing else decides."""
    from panmap_tpu.align import long_device
    from panmap_tpu.align.batch import BatchAligner
    from panmap_tpu.align.longread import MAP_ONT, LongReadAligner
    from panmap_tpu.genotype.caller import resolve_device_pileup

    rng = np.random.default_rng(1)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    calls = []
    real = long_device.long_dp_device_batch

    def spy(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(long_device, "long_dp_device_batch", spy)
    for mode in (None, "device"):
        monkeypatch.setattr(D, "device_mode", lambda m=mode: m)
        assert BatchAligner(ref)._resolve_device_mode() == mode
        assert resolve_device_pileup("auto") is (mode is not None)
        LongReadAligner(ref, MAP_ONT).align_batch([ref[1000:2500]])
        assert bool(calls) is (mode is not None)
    assert resolve_device_pileup("on") and not resolve_device_pileup("off")


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    import panmap_tpu

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert panmap_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    import panmap_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        panmap_tpu.__file__)))
    assert panmap_tpu.compile_cache_dir() == os.path.join(repo, ".cache",
                                                          "jax")
    # a fixed path: the same answer every time (no pid or time in it)
    assert panmap_tpu.compile_cache_dir() == panmap_tpu.compile_cache_dir()


def test_compile_cache_configured_at_import():
    import jax

    import panmap_tpu

    assert jax.config.jax_compilation_cache_dir == \
        panmap_tpu.compile_cache_dir()
